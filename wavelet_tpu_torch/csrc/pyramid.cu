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
// Design.  The three passes of one 2x2x2 cell of the half-grid read only
// that cell and write 8 outputs (haar_cell.cuh): one thread per cell runs
// all three passes in registers.  Cells on an odd tail are 1 wide along that axis (the tail
// still goes through the other axes' passes; the inverse writes zeros
// there).  Neighbouring threads take neighbouring k, so loads (float2
// along Z where Z is even) and stores coalesce.
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
// Bound on this card: memory traffic.  One scale moves 8 bytes per element
// (one 4-byte read, one 4-byte write) for 7 flops at most, far below the
// H100's ridge point; deeper scales add 8/8, 8/64, ... for their low bands
// (about 9.1 bytes per element in all).  pyramid_forward reduces each
// box's max and min: per-block partials of every scale's launch, then one
// small kernel over all of them (no atomics, so the result does not depend
// on block order beyond the sign of a zero extremum).  The reductions
// propagate NaN, as jnp.max / torch.amax do.  forward_hist counts the
// 2048-bin key (bits & 0x7FFFFFFF) >> 20 of every coefficient it writes:
// each block keeps a private 32-bit table in shared memory and flushes its
// nonzero bins with 64-bit integer atomicAdd.  Integer sums do not depend
// on the order of the atomics, so the histogram is deterministic, and the
// 64-bit counts cannot wrap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "haar_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;
// Blocks of one histogram launch: each flushes its table once, so a
// launch is capped near this many blocks (the box loop covers the rest).
constexpr int kHistMaxBlocks = 4096;

enum Mode { kReduce = 0, kHist = 1 };

// NaN-propagating max / min: once a NaN is seen it stays.
__device__ __forceinline__ float nan_max(float m, float v) {
    return (v > m || isnan(v)) ? v : m;
}

__device__ __forceinline__ float nan_min(float m, float v) {
    return (v < m || isnan(v)) ? v : m;
}

// Block-wide max/min; every thread of the block must call it.  The result
// is valid in thread 0.
__device__ __forceinline__ void block_max_min(float& mx, float& mn) {
    __shared__ float s_max[kWarps];
    __shared__ float s_min[kWarps];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
        mn = nan_min(mn, __shfl_down_sync(0xffffffffu, mn, off));
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        s_max[warp] = mx;
        s_min[warp] = mn;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kWarps; ++w) {
            mx = nan_max(mx, s_max[w]);
            mn = nan_min(mn, s_min[w]);
        }
    }
    __syncthreads();  // s_max/s_min are reused by the caller's next box
}

// One scale of the forward pyramid.  src: compact [n_box, cx, cy, cz];
// c: the pyramid [n_box, X, Y, Z]; lo: compact [n_box, cx/2, cy/2, cz/2]
// low band for the next scale, or null at the last scale.  kReduce writes
// this launch's per-block max/min partials at column part_off + blockIdx.x
// of pmax/pmin [n_box, part_stride]; kHist counts into hist.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
pyramid_forward_scale_kernel(const float* __restrict__ src,
                             float* __restrict__ c, float* __restrict__ lo,
                             float* __restrict__ pmax,
                             float* __restrict__ pmin,
                             unsigned long long* __restrict__ hist,
                             int n_box, int X, int Y, int Z, int cx, int cy,
                             int cz, int part_stride, int part_off) {
    const long long vol = (long long)X * Y * Z;
    const long long svol = (long long)cx * cy * cz;
    const int ly = cy >> 1;
    const int lz = cz >> 1;
    const long long lvol = (long long)(cx >> 1) * ly * lz;
    const long long cells = (long long)((cx >> 1) + (cx & 1)) *
                            ((cy >> 1) + (cy & 1)) * ((cz >> 1) + (cz & 1));
    const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool active = cell < cells;
    const Cell q = cell_of(active ? cell : 0, cx, cy, cz);
    const bool full = q.wx == 2 && q.wy == 2 && q.wz == 2;
    const bool z_vec = (cz & 1) == 0 &&
                       (reinterpret_cast<uintptr_t>(src) & 7) == 0;

    __shared__ unsigned int s_hist[kMode == kHist ? kHistBins : 1];
    if constexpr (kMode == kHist) {
        for (int b = threadIdx.x; b < kHistBins; b += kThreads) s_hist[b] = 0;
        __syncthreads();
    }

    for (int box = blockIdx.y; box < n_box; box += gridDim.y) {
        float mx = -INFINITY;
        float mn = INFINITY;
        if (active) {
            const float* sb = src + (long long)box * svol;
            float* cb = c + (long long)box * vol;
            float v[2][2][2] = {};
#pragma unroll
            for (int a = 0; a < 2; ++a) {
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    if (a < q.wx && b < q.wy) {
                        const long long row =
                            ((long long)(2 * q.i + a) * cy + (2 * q.j + b)) *
                                cz + 2 * q.k;
                        if (q.wz == 2 && z_vec) {
                            const float2 p =
                                *reinterpret_cast<const float2*>(sb + row);
                            v[a][b][0] = p.x;
                            v[a][b][1] = p.y;
                        } else {
                            v[a][b][0] = sb[row];
                            v[a][b][1] = (q.wz == 2) ? sb[row + 1] : 0.0f;
                        }
                    }
                }
            }
            cell_forward(v, q);
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        if (!(a < q.wx && b < q.wy && s < q.wz)) continue;
                        const float val = v[a][b][s];
                        if (lo != nullptr && full && (a | b | s) == 0) {
                            lo[(long long)box * lvol +
                               ((long long)q.i * ly + q.j) * lz + q.k] = val;
                            continue;
                        }
                        const long long pos =
                            ((long long)coeff_pos(q.i, a, q.wx, cx) * Y +
                             coeff_pos(q.j, b, q.wy, cy)) * Z +
                            coeff_pos(q.k, s, q.wz, cz);
                        cb[pos] = val;
                        if constexpr (kMode == kReduce) {
                            mx = nan_max(mx, val);
                            mn = nan_min(mn, val);
                        } else {
                            atomicAdd(&s_hist[hist_bin(val)], 1u);
                        }
                    }
        }
        if constexpr (kMode == kReduce) {
            block_max_min(mx, mn);
            if (threadIdx.x == 0) {
                const long long at =
                    (long long)box * part_stride + part_off + blockIdx.x;
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

// Per-box max/min from per-block partials [n_box, n_part].
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ pmax,
                       const float* __restrict__ pmin,
                       float* __restrict__ maxv, float* __restrict__ minv,
                       int n_box, int n_part) {
    for (int box = blockIdx.x; box < n_box; box += gridDim.x) {
        float mx = -INFINITY;
        float mn = INFINITY;
        for (int p = threadIdx.x; p < n_part; p += kThreads) {
            mx = nan_max(mx, pmax[(long long)box * n_part + p]);
            mn = nan_min(mn, pmin[(long long)box * n_part + p]);
        }
        block_max_min(mx, mn);
        if (threadIdx.x == 0) {
            maxv[box] = mx;
            minv[box] = mn;
        }
    }
}

// One scale of the inverse.  c: the pyramid [n_box, X, Y, Z]; lo: compact
// [n_box, cx/2, cy/2, cz/2] low band of this scale, or null at the
// coarsest scale (the low band is then the pyramid's corner); dst: compact
// [n_box, cx, cy, cz].
__global__ void __launch_bounds__(kThreads)
pyramid_inverse_scale_kernel(const float* __restrict__ c,
                             const float* __restrict__ lo,
                             float* __restrict__ dst, int n_box, int X,
                             int Y, int Z, int cx, int cy, int cz) {
    const long long vol = (long long)X * Y * Z;
    const long long dvol = (long long)cx * cy * cz;
    const int ly = cy >> 1;
    const int lz = cz >> 1;
    const long long lvol = (long long)(cx >> 1) * ly * lz;
    const long long cells = (long long)((cx >> 1) + (cx & 1)) *
                            ((cy >> 1) + (cy & 1)) * ((cz >> 1) + (cz & 1));
    const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (cell >= cells) return;  // no block-wide step below
    const Cell q = cell_of(cell, cx, cy, cz);
    const bool full = q.wx == 2 && q.wy == 2 && q.wz == 2;
    const bool z_vec = (cz & 1) == 0 &&
                       (reinterpret_cast<uintptr_t>(dst) & 7) == 0;

    for (int box = blockIdx.y; box < n_box; box += gridDim.y) {
        const float* cb = c + (long long)box * vol;
        float* db = dst + (long long)box * dvol;
        float v[2][2][2];
        if (full) {
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        if (lo != nullptr && (a | b | s) == 0) {
                            v[0][0][0] = lo[(long long)box * lvol +
                                            ((long long)q.i * ly + q.j) * lz +
                                            q.k];
                        } else {
                            v[a][b][s] = cb[((long long)coeff_pos(q.i, a, 2,
                                                                  cx) * Y +
                                             coeff_pos(q.j, b, 2, cy)) * Z +
                                            coeff_pos(q.k, s, 2, cz)];
                        }
                    }
            cell_inverse(v);
        } else {
            // every output of a cell on an odd tail lies on a tail plane,
            // which the reference's inverse leaves zero
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    v[a][b][0] = 0.0f;
                    v[a][b][1] = 0.0f;
                }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
                if (a < q.wx && b < q.wy) {
                    const long long row =
                        ((long long)(2 * q.i + a) * cy + (2 * q.j + b)) * cz +
                        2 * q.k;
                    if (q.wz == 2 && z_vec) {
                        *reinterpret_cast<float2*>(db + row) =
                            make_float2(v[a][b][0], v[a][b][1]);
                    } else {
                        db[row] = v[a][b][0];
                        if (q.wz == 2) db[row + 1] = v[a][b][1];
                    }
                }
            }
    }
}

long long cells_per_box(int X, int Y, int Z) {
    return (long long)((X >> 1) + (X & 1)) * ((Y >> 1) + (Y & 1)) *
           ((Z >> 1) + (Z & 1));
}

int grid_y(int n_box) { return n_box < kMaxGridY ? n_box : kMaxGridY; }

long long blocks_of(int cx, int cy, int cz) {
    return (cells_per_box(cx, cy, cz) + kThreads - 1) / kThreads;
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

// Scratch floats per box: the low bands L_1 .. L_{scales-1}, in order.
long long scratch_per_box(int X, int Y, int Z, int scales) {
    long long n = 0;
    for (int t = 1; t < scales; ++t) n += corner_vol(X, Y, Z, t);
    return n;
}

long long parts_per_box(int X, int Y, int Z, int scales) {
    long long n = 0;
    for (int t = 0; t < scales; ++t) n += blocks_of(X >> t, Y >> t, Z >> t);
    return n;
}

template <int kMode>
int launch_forward(const float* x, float* c, float* scratch, float* pmax,
                   float* pmin, unsigned long long* hist, int n_box, int X,
                   int Y, int Z, int scales, cudaStream_t s) {
    const long long parts = parts_per_box(X, Y, Z, scales);
    if (parts > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const float* src = x;
    long long part_off = 0;
    long long scratch_off = 0;
    for (int t = 0; t < scales; ++t) {
        const int cx = X >> t, cy = Y >> t, cz = Z >> t;
        float* lo = nullptr;
        if (t + 1 < scales) {
            lo = scratch + scratch_off;
            scratch_off += (long long)n_box * corner_vol(X, Y, Z, t + 1);
        }
        const long long blocks = blocks_of(cx, cy, cz);
        if (blocks > 0) {
            int gy = grid_y(n_box);
            if (kMode == kHist) {
                const long long cap = kHistMaxBlocks / blocks;
                if (cap < gy) gy = cap > 1 ? (int)cap : 1;
            }
            dim3 grid((unsigned)blocks, (unsigned)gy);
            pyramid_forward_scale_kernel<kMode><<<grid, kThreads, 0, s>>>(
                src, c, lo, pmax, pmin, hist, n_box, X, Y, Z, cx, cy, cz,
                (int)parts, (int)part_off);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
        part_off += blocks;
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
// many floats each).
long long wt_pyramid_forward_parts(int X, int Y, int Z, int scales) {
    return parts_per_box(X, Y, Z, scales);
}

// x, c: [n_box, X, Y, Z] f32 (distinct buffers); maxv, minv: [n_box];
// pmax, pmin: [n_box, wt_pyramid_forward_parts]; scratch:
// [n_box * wt_pyramid_scratch].  Returns the cudaError_t of the launches
// (0 = launched).
int wt_pyramid_forward(const float* x, float* c, float* maxv, float* minv,
                       float* pmax, float* pmin, float* scratch, int n_box,
                       int X, int Y, int Z, int scales, void* stream) {
    if (bad_pyramid(n_box, X, Y, Z, scales)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int err = launch_forward<kReduce>(x, c, scratch, pmax, pmin,
                                            nullptr, n_box, X, Y, Z, scales, s);
    if (err) return err;
    reduce_partials_kernel<<<grid_y(n_box), kThreads, 0, s>>>(
        pmax, pmin, maxv, minv, n_box,
        (int)parts_per_box(X, Y, Z, scales));
    return (int)cudaGetLastError();
}

// x, c: [n_box, X, Y, Z] f32 (distinct buffers); hist: [2048] u64,
// zeroed here; scratch: [n_box * wt_pyramid_scratch].
int wt_forward_hist(const float* x, float* c, unsigned long long* hist,
                    float* scratch, int n_box, int X, int Y, int Z,
                    int scales, void* stream) {
    if (bad_pyramid(n_box, X, Y, Z, scales)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        cudaMemsetAsync(hist, 0, kHistBins * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    return launch_forward<kHist>(x, c, scratch, nullptr, nullptr, hist, n_box,
                                 X, Y, Z, scales, s);
}

// c, out: [n_box, X, Y, Z] f32 (distinct buffers); scratch:
// [n_box * wt_pyramid_scratch].
int wt_pyramid_inverse(const float* c, float* out, float* scratch, int n_box,
                       int X, int Y, int Z, int scales, void* stream) {
    if (bad_pyramid(n_box, X, Y, Z, scales)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // L_t for t >= 1 starts after L_1 .. L_{t-1}
    long long off[32] = {0};
    for (int t = 2; t < scales; ++t)
        off[t] = off[t - 1] + (long long)n_box * corner_vol(X, Y, Z, t - 1);
    for (int t = scales - 1; t >= 0; --t) {
        const int cx = X >> t, cy = Y >> t, cz = Z >> t;
        const float* lo = (t + 1 < scales) ? scratch + off[t + 1] : nullptr;
        float* dst = (t == 0) ? out : scratch + off[t];
        const long long blocks = blocks_of(cx, cy, cz);
        if (blocks <= 0) continue;
        if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
        dim3 grid((unsigned)blocks, (unsigned)grid_y(n_box));
        pyramid_inverse_scale_kernel<<<grid, kThreads, 0, s>>>(
            c, lo, dst, n_box, X, Y, Z, cx, cy, cz);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

const char* wt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
