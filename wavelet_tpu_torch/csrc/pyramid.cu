// 3D Haar transforms of a batch of boxes, halves (logical) layout, and the
// fused magnitude histogram, for NVIDIA Hopper (sm_90a).  Plain C
// interface, loaded with ctypes by wavelet_tpu_torch/kernels/build.py;
// wrappers and plain versions in kernels/haar_cuda.py (one scale) and
// kernels/pyramid_cuda.py (pyramids, histogram).
//
// Replaces the TPU kernels of wavelet_tpu/kernels/haar_pallas.py
//   haar_forward:    _fused_forward_call (one scale + per-box max/min),
//                    wt_pyramid_forward at scales = 1;
//   haar_inverse:    _fused_inverse_call, wt_pyramid_inverse at scales = 1;
//   pyramid_forward: _fwd_interleaved_call (in-place pyramid + per-box
//                    max/min);
//   forward_hist:    _fwd_interleaved_nored_call (pyramid without extrema)
//                    followed by core/threshold.abs_exponent_histogram,
//                    which the JAX engine runs as a separate step
//                    (runtime/engine.py:_fwd_hist_only);
//   pyramid_inverse: _inv_interleaved_call (coarsest scale first).
// The TPU pyramid kernels keep coefficients interleaved in place; these
// write the halves layout of core/haar.haar3d_forward_multi, which the host
// packer walks as it is.
//
// Arithmetic contract (wavelet_tpu_torch/core/haar.py, the plain version):
// scale t transforms the corner [X>>t, Y>>t, Z>>t] that holds scale t-1's
// low band with Z, then Y, then X passes, each output fl(fl(a+b)*0.5) /
// fl(fl(a-b)*0.5); the inverse runs X, then Y, then Z, fl(avg+diff) /
// fl(avg-diff).  Every operation is an explicit round-to-nearest
// intrinsic, so no FMA can be contracted, and the build passes -ftz=false:
// subnormals are kept and the result is bitwise that of the reference's
// loops.  Only scale 0 may have odd extents.
//
// Bound on this card: memory traffic.  One scale moves 8 bytes per element
// (one 4-byte read, one 4-byte write) for 7 flops at most, far below the
// H100's ridge point; deeper scales add 8/8, 8/64, ... for their low bands
// (about 9.1 bytes per element in all).  So the design is about keeping
// every thread's loads and stores wide and every warp busy, whatever the
// box size.
//
// Work unit.  The three passes of one 2x2x2 cell of the half-grid read
// only that cell and write 8 outputs (haar_cell.cuh), so one thread runs
// them in registers.  Where the corner's Z extent divides by 4, a thread
// takes two neighbouring cells along Z: its 4 input rows are 16-byte loads
// and its 8 output slots 8-byte stores (a cell's low and high along Z land
// Z/2 apart, the two cells' side by side).  Otherwise a thread takes one
// cell, with an 8-byte load of its Z pair where Z is even.  Cells on an odd
// tail are 1 wide along that axis: the tail still goes through the other
// axes' passes, and the inverse writes zeros there.
//
// Geometry.  One flat index over (box, unit) on grid.x: no grid.y cap and
// no box loop in a block.  A box of U units takes a group of G threads, G
// the power of two >= U, so a block of 256 threads holds 256 / G whole
// boxes (32 boxes of 8x4x2, 8 of 8^3); a box of more than 256 units spans
// B = ceil(U / 256) blocks.  At one scale with B = 1 a block's outputs
// are one contiguous run of c, but a thread's own 8 slots lie 2-8 floats
// apart, so its stores would write each sector in pieces: there the
// outputs are staged in shared memory and leave in 16-byte coalesced
// stores (kStage).  The extrema (kReduce): a group reduces its
// box's max/min by xor shuffles in a warp, then across the group's warps
// in shared memory, and its first thread writes them: straight to maxv /
// minv at scales = 1 when B = 1 (no partials, no second launch), else as
// one partial per (box, block, scale) that reduce_partials_kernel reduces,
// a warp per box.  Every step reduces in a fixed order, so the result does
// not depend on block order (a zero extremum may still come back as -0.0
// where the plain version gives +0.0); NaN propagates as jnp.max /
// torch.amax do.
//
// Scale t of the forward reads a compact array L_t (the input box at
// t = 0, else the low band scale t-1 produced), writes each cell's 7
// detail coefficients straight to their places in the pyramid, and writes
// its low to the compact L_{t+1}; the last scale writes the low into the
// pyramid's corner.  So every coefficient is written exactly once, by one
// launch per scale, and no launch reads what it writes: in place would
// race (a cell's outputs land in other cells' inputs).  The inverse runs
// the scales coarsest first: scale t reads the low band from L_{t+1} (at
// the coarsest scale, from the pyramid's corner) and the details from the
// pyramid, and writes L_t, or the boxes at t = 0.
//
// forward_hist counts the 2048-bin key (bits & 0x7FFFFFFF) >> 20 of every
// coefficient it writes: each block keeps a private 32-bit table in shared
// memory and flushes its nonzero bins with 64-bit integer atomicAdd once,
// after walking its share of the blocks (the grid is capped at
// kHistMaxBlocks).  Integer sums do not depend on the order of the
// atomics, so the histogram is deterministic, and the 64-bit counts cannot
// wrap.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "haar_cell.cuh"

namespace {

constexpr int kLogThreads = 8;
constexpr int kThreads = 1 << kLogThreads;
constexpr int kWarps = kThreads / 32;
// Floats of one block's staged outputs: 256 units of at most 16 elements.
constexpr int kStageFloats = kThreads * 16;
// Blocks of one histogram launch: each flushes its table once, so a
// launch is capped at this many blocks (each walks the rest in turn).
constexpr int kHistMaxBlocks = 4096;

enum Mode { kReduce = 0, kHist = 1 };

// NaN-propagating max / min: once a NaN is seen it stays.
__device__ __forceinline__ float nan_max(float m, float v) {
    return (v > m || isnan(v)) ? v : m;
}

__device__ __forceinline__ float nan_min(float m, float v) {
    return (v < m || isnan(v)) ? v : m;
}

// One scale's launch geometry.  A box is `units` units (one cell each, or
// two along Z with kPair); it takes an aligned group of 2^glog threads of
// a block, or bpb whole blocks (then glog = kLogThreads).
struct Geo {
    int X, Y, Z;       // the pyramid: c's extents
    int cx, cy, cz;    // this scale's corner
    int hy;            // half-grid cells along Y
    int uz;            // units along Z
    int units;         // units of one box
    int glog;
    int bpb;           // blocks per box
    int n_box;
    int blocks;        // blocks that cover the batch
};

int half_up(int n) {
    return (n >> 1) + (n & 1);
}

// The thread's box and unit in block `blk` of the flat (box, unit) index.
struct Unit {
    long long box;
    int u;
    bool lead;     // first thread of its box's group
    bool active;   // box and unit exist
};

__device__ __forceinline__ Unit unit_of(const Geo& g, int blk) {
    const int gmask = (1 << g.glog) - 1;
    Unit w;
    w.box = (long long)(blk / g.bpb) * (kThreads >> g.glog) +
            (threadIdx.x >> g.glog);
    w.u = (blk % g.bpb) * kThreads + (threadIdx.x & gmask);
    w.lead = (threadIdx.x & gmask) == 0;
    w.active = w.box < g.n_box && w.u < g.units;
    return w;
}

// Unit u's first cell; a unit of kPair is the cells k and k + 1 along Z.
template <bool kPair>
__device__ __forceinline__ Cell cell_at(const Geo& g, int u) {
    const int r = u / g.uz;
    Cell q;
    q.k = (u - r * g.uz) * (kPair ? 2 : 1);
    q.i = r / g.hy;
    q.j = r - q.i * g.hy;
    q.wx = (q.i < (g.cx >> 1)) ? 2 : 1;
    q.wy = (q.j < (g.cy >> 1)) ? 2 : 1;
    q.wz = (q.k < (g.cz >> 1)) ? 2 : 1;
    return q;
}

// Max/min over each aligned group of 2^glog threads, valid in the group's
// first thread.  Every thread of the block calls it (glog is uniform).
__device__ __forceinline__ void group_max_min(float& mx, float& mn,
                                              int glog) {
    __shared__ float s_max[kWarps];
    __shared__ float s_min[kWarps];
    for (int off = (1 << (glog < 5 ? glog : 5)) >> 1; off > 0; off >>= 1) {
        mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    }
    if (glog <= 5) return;
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        s_max[warp] = mx;
        s_min[warp] = mn;
    }
    __syncthreads();
    if ((threadIdx.x & ((1 << glog) - 1)) == 0) {
        for (int w = 1; w < 1 << (glog - 5); ++w) {
            mx = nan_max(mx, s_max[warp + w]);
            mn = nan_min(mn, s_min[warp + w]);
        }
    }
    __syncthreads();  // s_max/s_min are reused by the block's next turn
}

// One scale of the forward pyramid.  src: compact [n_box, cx, cy, cz];
// c: the pyramid [n_box, X, Y, Z]; lo: compact [n_box, cx/2, cy/2, cz/2]
// low band for the next scale, or null at the last scale.  kReduce writes
// each (box, block)'s max/min at part[box * part_stride + part_off +
// block of the box] of pmax/pmin (maxv/minv themselves with stride 1);
// kHist counts into hist.  kStage: see s_out.
template <int kMode, bool kPair, bool kStage>
__global__ void __launch_bounds__(kThreads)
pyramid_forward_scale_kernel(const float* __restrict__ src,
                             float* __restrict__ c, float* __restrict__ lo,
                             float* __restrict__ pmax,
                             float* __restrict__ pmin,
                             unsigned long long* __restrict__ hist,
                             const Geo g, int part_stride, int part_off) {
    constexpr int kCells = kPair ? 2 : 1;
    const long long vol = (long long)g.X * g.Y * g.Z;
    const long long svol = (long long)g.cx * g.cy * g.cz;
    const int ly = g.cy >> 1;
    const int lz = g.cz >> 1;
    const long long lvol = (long long)(g.cx >> 1) * ly * lz;
    const bool z2 = (g.cz & 1) == 0 &&
                    (reinterpret_cast<uintptr_t>(src) & 7) == 0;

    __shared__ unsigned int s_hist[kMode == kHist ? kHistBins : 1];
    // kStage: the outputs of the block's whole boxes (Geometry, above)
    __shared__ __align__(16) float s_out[kStage ? kStageFloats : 1];
    if constexpr (kMode == kHist) {
        for (int b = threadIdx.x; b < kHistBins; b += kThreads) s_hist[b] = 0;
        __syncthreads();
    }

    for (long long blk = blockIdx.x; blk < g.blocks; blk += gridDim.x) {
        const Unit w = unit_of(g, (int)blk);
        float mx = -INFINITY;
        float mn = INFINITY;
        if (w.active) {
            const Cell q = cell_at<kPair>(g, w.u);
            const bool full = q.wx == 2 && q.wy == 2 && q.wz == 2;
            const float* sb = src + w.box * svol;
            float* cb = kStage ? s_out + (threadIdx.x >> g.glog) * vol
                               : c + w.box * vol;
            float v[kCells][2][2][2] = {};
#pragma unroll
            for (int a = 0; a < 2; ++a) {
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    if (!(a < q.wx && b < q.wy)) continue;
                    const long long row =
                        ((long long)(2 * q.i + a) * g.cy + (2 * q.j + b)) *
                            g.cz + 2 * q.k;
                    if constexpr (kPair) {
                        const float4 p =
                            *reinterpret_cast<const float4*>(sb + row);
                        v[0][a][b][0] = p.x;
                        v[0][a][b][1] = p.y;
                        v[1][a][b][0] = p.z;
                        v[1][a][b][1] = p.w;
                    } else if (q.wz == 2 && z2) {
                        const float2 p =
                            *reinterpret_cast<const float2*>(sb + row);
                        v[0][a][b][0] = p.x;
                        v[0][a][b][1] = p.y;
                    } else {
                        v[0][a][b][0] = sb[row];
                        v[0][a][b][1] = (q.wz == 2) ? sb[row + 1] : 0.0f;
                    }
                }
            }
#pragma unroll
            for (int n = 0; n < kCells; ++n) cell_forward(v[n], q);
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        if (!(a < q.wx && b < q.wy && s < q.wz)) continue;
                        float* at;
                        if (lo != nullptr && full && (a | b | s) == 0) {
                            at = lo + w.box * lvol +
                                 ((long long)q.i * ly + q.j) * lz + q.k;
                        } else {
                            at = cb +
                                 ((long long)coeff_pos(q.i, a, q.wx, g.cx) *
                                      g.Y +
                                  coeff_pos(q.j, b, q.wy, g.cy)) * g.Z +
                                 coeff_pos(q.k, s, q.wz, g.cz);
                        }
                        if constexpr (kPair) {
                            *reinterpret_cast<float2*>(at) =
                                make_float2(v[0][a][b][s], v[1][a][b][s]);
                        } else {
                            *at = v[0][a][b][s];
                        }
                        if (lo != nullptr && full && (a | b | s) == 0)
                            continue;   // the low band is not a coefficient
#pragma unroll
                        for (int n = 0; n < kCells; ++n) {
                            if constexpr (kMode == kReduce) {
                                mx = nan_max(mx, v[n][a][b][s]);
                                mn = nan_min(mn, v[n][a][b][s]);
                            } else {
                                atomicAdd(&s_hist[hist_bin(v[n][a][b][s])],
                                          1u);
                            }
                        }
                    }
        }
        if constexpr (kStage) {
            __syncthreads();
            const long long box0 = blk * (kThreads >> g.glog);
            const long long n_out =
                (long long)min(kThreads >> g.glog, (int)(g.n_box - box0)) *
                vol;
            float* out = c + box0 * vol;
            if ((vol & 3) == 0) {
                for (int e = threadIdx.x; e < n_out / 4; e += kThreads)
                    reinterpret_cast<float4*>(out)[e] =
                        reinterpret_cast<const float4*>(s_out)[e];
            } else {
                for (int e = threadIdx.x; e < n_out; e += kThreads)
                    out[e] = s_out[e];
            }
            __syncthreads();  // s_out is reused by the block's next turn
        }
        if constexpr (kMode == kReduce) {
            group_max_min(mx, mn, g.glog);
            if (w.lead && w.box < g.n_box) {
                const long long at =
                    w.box * part_stride + part_off + (int)blk % g.bpb;
                pmax[at] = mx;
                pmin[at] = mn;
            }
        }
    }
    if constexpr (kMode == kHist) {
        __syncthreads();
        for (int b = threadIdx.x; b < kHistBins; b += kThreads) {
            const unsigned int n = s_hist[b];
            if (n) atomicAdd(&hist[b], (unsigned long long)n);
        }
    }
}

// Per-box max/min from per-block partials [n_box, n_part], a warp per box.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ pmax,
                       const float* __restrict__ pmin,
                       float* __restrict__ maxv, float* __restrict__ minv,
                       int n_box, int n_part) {
    const long long box = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    float mx = -INFINITY;
    float mn = INFINITY;
    if (box < n_box) {
        for (int p = lane; p < n_part; p += 32) {
            mx = nan_max(mx, pmax[box * n_part + p]);
            mn = nan_min(mn, pmin[box * n_part + p]);
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        mx = nan_max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        mn = nan_min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    }
    if (lane == 0 && box < n_box) {
        maxv[box] = mx;
        minv[box] = mn;
    }
}

// One scale of the inverse.  c: the pyramid [n_box, X, Y, Z]; lo: compact
// [n_box, cx/2, cy/2, cz/2] low band of this scale, or null at the
// coarsest scale (the low band is then the pyramid's corner); dst: compact
// [n_box, cx, cy, cz].
template <bool kPair>
__global__ void __launch_bounds__(kThreads)
pyramid_inverse_scale_kernel(const float* __restrict__ c,
                             const float* __restrict__ lo,
                             float* __restrict__ dst, const Geo g) {
    constexpr int kCells = kPair ? 2 : 1;
    const Unit w = unit_of(g, blockIdx.x);
    if (!w.active) return;  // no block-wide step below
    const Cell q = cell_at<kPair>(g, w.u);
    const bool full = q.wx == 2 && q.wy == 2 && q.wz == 2;
    const long long vol = (long long)g.X * g.Y * g.Z;
    const long long dvol = (long long)g.cx * g.cy * g.cz;
    const int ly = g.cy >> 1;
    const int lz = g.cz >> 1;
    const long long lvol = (long long)(g.cx >> 1) * ly * lz;
    const bool z2 = (g.cz & 1) == 0 &&
                    (reinterpret_cast<uintptr_t>(dst) & 7) == 0;
    const float* cb = c + w.box * vol;
    float* db = dst + w.box * dvol;

    // every output of a cell on an odd tail lies on a tail plane, which
    // the reference's inverse leaves zero
    float v[kCells][2][2][2] = {};
    if (full) {
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    const float* at;
                    if (lo != nullptr && (a | b | s) == 0) {
                        at = lo + w.box * lvol +
                             ((long long)q.i * ly + q.j) * lz + q.k;
                    } else {
                        at = cb + ((long long)coeff_pos(q.i, a, 2, g.cx) *
                                       g.Y +
                                   coeff_pos(q.j, b, 2, g.cy)) * g.Z +
                             coeff_pos(q.k, s, 2, g.cz);
                    }
                    if constexpr (kPair) {
                        const float2 p = *reinterpret_cast<const float2*>(at);
                        v[0][a][b][s] = p.x;
                        v[1][a][b][s] = p.y;
                    } else {
                        v[0][a][b][s] = *at;
                    }
                }
#pragma unroll
        for (int n = 0; n < kCells; ++n) cell_inverse(v[n]);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
            if (!(a < q.wx && b < q.wy)) continue;
            float* row = db + ((long long)(2 * q.i + a) * g.cy +
                               (2 * q.j + b)) * g.cz + 2 * q.k;
            if constexpr (kPair) {
                *reinterpret_cast<float4*>(row) =
                    make_float4(v[0][a][b][0], v[0][a][b][1], v[1][a][b][0],
                                v[1][a][b][1]);
            } else if (q.wz == 2 && z2) {
                *reinterpret_cast<float2*>(row) =
                    make_float2(v[0][a][b][0], v[0][a][b][1]);
            } else {
                row[0] = v[0][a][b][0];
                if (q.wz == 2) row[1] = v[0][a][b][1];
            }
        }
}

// Two cells a unit where the corner's Z divides by 4: the 16-byte rows and
// 8-byte slots stay aligned as long as the buffers are 16-byte aligned.
bool pair_units(int cz) { return cz % 4 == 0; }

// Scale t's geometry; false where a count would not fit the kernels' ints.
bool plan(int n_box, int X, int Y, int Z, int t, Geo& g) {
    g.X = X;
    g.Y = Y;
    g.Z = Z;
    g.cx = X >> t;
    g.cy = Y >> t;
    g.cz = Z >> t;
    g.hy = half_up(g.cy);
    g.uz = pair_units(g.cz) ? g.cz / 4 : half_up(g.cz);
    const long long units = (long long)half_up(g.cx) * g.hy * g.uz;
    if (units > INT_MAX - kThreads) return false;
    g.units = (int)units;
    g.n_box = n_box;
    long long blocks;
    if (units <= kThreads) {
        g.glog = 0;
        while ((1LL << g.glog) < units) ++g.glog;
        g.bpb = 1;
        const int per_block = kThreads >> g.glog;
        blocks = (n_box + per_block - 1) / per_block;
    } else {
        g.glog = kLogThreads;
        g.bpb = (int)((units + kThreads - 1) / kThreads);
        blocks = (long long)n_box * g.bpb;
    }
    if (blocks > INT_MAX) return false;
    g.blocks = (int)blocks;
    return true;
}

long long corner_vol(int X, int Y, int Z, int t) {
    return (long long)(X >> t) * (Y >> t) * (Z >> t);
}

// haar3d_forward_multi's rule: scale 0 takes any extents, every deeper
// scale's corner must be even (and, here, not empty).
bool bad_pyramid(int n_box, int X, int Y, int Z, int scales) {
    if (n_box <= 0 || X <= 0 || Y <= 0 || Z <= 0 || scales < 1 ||
        scales > 31)
        return true;
    for (int t = 1; t < scales; ++t) {
        const int cx = X >> t, cy = Y >> t, cz = Z >> t;
        if (((cx | cy | cz) & 1) || cx == 0 || cy == 0 || cz == 0) return true;
    }
    return false;
}

bool misaligned(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// Scratch floats per box: the low bands L_1 .. L_{scales-1}, in order.
long long scratch_per_box(int X, int Y, int Z, int scales) {
    long long n = 0;
    for (int t = 1; t < scales; ++t) n += corner_vol(X, Y, Z, t);
    return n;
}

// Partials per box: every scale's blocks per box, or 0 where one scale's
// groups write maxv/minv themselves; -1 if a scale cannot be planned.
long long parts_per_box(int X, int Y, int Z, int scales) {
    long long n = 0;
    for (int t = 0; t < scales; ++t) {
        Geo g;
        if (!plan(1, X, Y, Z, t, g)) return -1;
        if (scales == 1 && g.bpb == 1) return 0;
        n += g.bpb;
    }
    return n;
}

template <int kMode, bool kPair, bool kStage>
void launch_scale(const float* src, float* c, float* lo, float* pmax,
                  float* pmin, unsigned long long* hist, const Geo& g,
                  int part_stride, int part_off, cudaStream_t s) {
    const int grid = kMode == kHist && g.blocks > kHistMaxBlocks
                         ? kHistMaxBlocks : g.blocks;
    pyramid_forward_scale_kernel<kMode, kPair, kStage>
        <<<grid, kThreads, 0, s>>>(src, c, lo, pmax, pmin, hist, g,
                                   part_stride, part_off);
}

// Every scale of the forward.  parts = parts_per_box: 0 writes the
// extrema straight into pmax/pmin (then maxv/minv).
template <int kMode>
int launch_forward(const float* x, float* c, float* scratch, float* pmax,
                   float* pmin, unsigned long long* hist, int n_box, int X,
                   int Y, int Z, int scales, long long parts,
                   cudaStream_t s) {
    if (parts < 0 || parts > INT_MAX)
        return (int)cudaErrorInvalidConfiguration;
    if (misaligned(x) || misaligned(c) || (scales > 1 && misaligned(scratch)))
        return (int)cudaErrorInvalidValue;
    const float* src = x;
    long long part_off = 0;
    long long scratch_off = 0;
    for (int t = 0; t < scales; ++t) {
        Geo g;
        if (!plan(n_box, X, Y, Z, t, g))
            return (int)cudaErrorInvalidConfiguration;
        float* lo = nullptr;
        if (t + 1 < scales) {
            lo = scratch + scratch_off;
            scratch_off += (long long)n_box * corner_vol(X, Y, Z, t + 1);
        }
        // one scale of boxes that fit a block: every output in the block's
        // run of c
        const bool stage =
            scales == 1 && g.bpb == 1 &&
            (long long)(kThreads >> g.glog) * X * Y * Z <= kStageFloats;
        const int stride = parts > 0 ? (int)parts : 1;
        const int off = (int)part_off;
        if (pair_units(g.cz) && stage)
            launch_scale<kMode, true, true>(src, c, lo, pmax, pmin, hist, g,
                                            stride, off, s);
        else if (pair_units(g.cz))
            launch_scale<kMode, true, false>(src, c, lo, pmax, pmin, hist, g,
                                             stride, off, s);
        else if (stage)
            launch_scale<kMode, false, true>(src, c, lo, pmax, pmin, hist, g,
                                             stride, off, s);
        else
            launch_scale<kMode, false, false>(src, c, lo, pmax, pmin, hist,
                                              g, stride, off, s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        part_off += g.bpb;
        src = lo;
    }
    return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// Scratch floats per box the caller allocates for any of the three entry
// points (n_box * this many; 0 at scales = 1, where scratch may be null).
long long wt_pyramid_scratch(int X, int Y, int Z, int scales) {
    return scratch_per_box(X, Y, Z, scales);
}

// Per-box partials of wt_pyramid_forward (pmax/pmin hold n_box * this
// many floats each; 0: none are used, and they may be null).
long long wt_pyramid_forward_parts(int X, int Y, int Z, int scales) {
    return parts_per_box(X, Y, Z, scales);
}

// x, c: [n_box, X, Y, Z] f32 (distinct buffers); maxv, minv: [n_box];
// pmax, pmin: [n_box, wt_pyramid_forward_parts]; scratch:
// [n_box * wt_pyramid_scratch].  x, c and scratch must be 16-byte aligned.
// Returns the cudaError_t of the launches (0 = launched).
int wt_pyramid_forward(const float* x, float* c, float* maxv, float* minv,
                       float* pmax, float* pmin, float* scratch, int n_box,
                       int X, int Y, int Z, int scales, void* stream) {
    if (bad_pyramid(n_box, X, Y, Z, scales)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long parts = parts_per_box(X, Y, Z, scales);
    if (parts == 0)
        return launch_forward<kReduce>(x, c, scratch, maxv, minv, nullptr,
                                       n_box, X, Y, Z, scales, parts, s);
    const int err = launch_forward<kReduce>(x, c, scratch, pmax, pmin,
                                            nullptr, n_box, X, Y, Z, scales,
                                            parts, s);
    if (err) return err;
    const long long blocks = ((long long)n_box * 32 + kThreads - 1) / kThreads;
    reduce_partials_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        pmax, pmin, maxv, minv, n_box, (int)parts);
    return (int)cudaGetLastError();
}

// x, c: [n_box, X, Y, Z] f32 (distinct buffers); hist: [2048] u64,
// zeroed here; scratch: [n_box * wt_pyramid_scratch].  x, c and scratch
// must be 16-byte aligned.
int wt_forward_hist(const float* x, float* c, unsigned long long* hist,
                    float* scratch, int n_box, int X, int Y, int Z,
                    int scales, void* stream) {
    if (bad_pyramid(n_box, X, Y, Z, scales)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        cudaMemsetAsync(hist, 0, kHistBins * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    return launch_forward<kHist>(x, c, scratch, nullptr, nullptr, hist, n_box,
                                 X, Y, Z, scales, 0, s);
}

// c, out: [n_box, X, Y, Z] f32 (distinct buffers); scratch:
// [n_box * wt_pyramid_scratch].  c, out and scratch must be 16-byte
// aligned.
int wt_pyramid_inverse(const float* c, float* out, float* scratch, int n_box,
                       int X, int Y, int Z, int scales, void* stream) {
    if (bad_pyramid(n_box, X, Y, Z, scales)) return (int)cudaErrorInvalidValue;
    if (misaligned(c) || misaligned(out) ||
        (scales > 1 && misaligned(scratch)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // L_t for t >= 1 starts after L_1 .. L_{t-1}
    long long off[32] = {0};
    for (int t = 2; t < scales; ++t)
        off[t] = off[t - 1] + (long long)n_box * corner_vol(X, Y, Z, t - 1);
    for (int t = scales - 1; t >= 0; --t) {
        Geo g;
        if (!plan(n_box, X, Y, Z, t, g))
            return (int)cudaErrorInvalidConfiguration;
        const float* lo = (t + 1 < scales) ? scratch + off[t + 1] : nullptr;
        float* dst = (t == 0) ? out : scratch + off[t];
        if (pair_units(g.cz))
            pyramid_inverse_scale_kernel<true><<<g.blocks, kThreads, 0, s>>>(
                c, lo, dst, g);
        else
            pyramid_inverse_scale_kernel<false><<<g.blocks, kThreads, 0, s>>>(
                c, lo, dst, g);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

const char* wt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
