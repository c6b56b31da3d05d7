// Lane-packed Haar kernels for NVIDIA Hopper (sm_90a).  Plain C interface,
// loaded with ctypes by wavelet_tpu_torch/kernels/build.py; wrappers and
// plain versions in kernels/packed_cuda.py.
//
// Replaces the TPU kernels of wavelet_tpu/kernels/haar_pallas.py
//   packed_forward:      _fused_forward_packed_call (one scale + per-box
//                        max/min on lane-packed rows);
//   packed_inverse:      _fused_inverse_packed_call;
//   packed_forward_hist: _fused_forward_packed_call followed by
//                        core/threshold.abs_exponent_histogram, the packed
//                        global-threshold pass (runtime/engine.py:1249-1252),
//                        without the extrema it discards.
//
// Layout.  A batch is [M, X, Y, L] f32 with L = P*Z: row m holds P boxes,
// box p's Z-axis at lanes [p*Z, (p+1)*Z).  Box b = m*P + p is the strided
// view with base m*X*Y*L + p*Z, Y stride L and X stride Y*L.  Coefficients
// stay in that layout, each box in the halves (logical) order of
// core/haar.py, and the per-box extrema come out in item order m*P + p.
// Z is even (the packed route's rule), so no box has a Z tail; odd X/Y
// tails pass through the forward and are zeroed by the inverse, as in
// pyramid.cu.
//
// Design.  One thread per 2x2x2 cell, all three passes in registers
// (haar_cell.cuh).  A Z pair of box p at pair index k is pair kk = p*Z/2 + k
// of the packed row, so threads take consecutive kk across the whole P*Z
// row: a warp's float2 loads cover 256 contiguous bytes of the row, not one
// box's short Z segment, and its stores land in runs of Z/2 floats.  Each
// thread then walks several half-grid (i, j) rows of the same kk, so it
// stays on one box.  Per-box extrema: each thread reduces its cells, lanes
// of one box combine by xor shuffles where a box's lanes form aligned
// groups of a warp, then by shared-memory atomics per box of the block, and
// one global atomic per (block, box) finishes.  The atomics run on a total
// order of the float bits (NaN mapped above +inf for the max and below -inf
// for the min, so NaN propagates as jnp.max / torch.amax do); a maximum
// does not depend on the order of the atomics, so the result is
// deterministic (the sign of a zero extremum follows -0 < +0).
// forward_hist counts the 2048-bin key of every coefficient it writes into
// a per-block shared table flushed with 64-bit atomics, as pyramid.cu does.
//
// Bound on this card: memory traffic, 8 bytes per element (one 4-byte read,
// one 4-byte write) for 7 flops at most.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "haar_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsPerThread = 8;
constexpr int kMaxGrid = 65535;
constexpr int kHistMaxBlocks = 4096;

enum Mode { kReduce = 0, kHist = 1 };

// Keys of a total order on the float bits: -0 < +0, NaN above +inf for the
// max (key 0xFFFFFFFF) and below -inf for the min (key 0).
__device__ __forceinline__ unsigned ordered(float v) {
    const unsigned b = __float_as_uint(v);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned max_key(float v) {
    return isnan(v) ? 0xFFFFFFFFu : ordered(v);
}

__device__ __forceinline__ unsigned min_key(float v) {
    return isnan(v) ? 0u : ordered(v);
}

__device__ __forceinline__ float from_key(unsigned k) {
    if (k == 0u || k == 0xFFFFFFFFu) return __uint_as_float(0x7FFFFFFFu);
    return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

struct Geometry {
    int M, X, Y, L, P, Z;
    int zh;          // Z / 2: pairs of one box's Z-row
    int w;           // L / 2: pairs of one packed row
    int hy;          // half-grid extent along Y
    int rows;        // half-grid (i, j) rows of one box
    int rpt;         // rows each thread walks per packed row
    int group;       // lanes of one box that form an aligned warp group
};

// Element (x, y, lane) of packed row m.
__device__ __forceinline__ long long at(const Geometry& g, int m, int x,
                                        int y, int lane) {
    return (((long long)m * g.X + x) * g.Y + y) * g.L + lane;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
packed_forward_kernel(const float* __restrict__ x, float* __restrict__ c,
                      unsigned* __restrict__ kmax,
                      unsigned* __restrict__ kmin,
                      unsigned long long* __restrict__ hist, Geometry g) {
    __shared__ unsigned s_hist[kMode == kHist ? kHistBins : 1];
    __shared__ unsigned s_max[kMode == kReduce ? kThreads : 1];
    __shared__ unsigned s_min[kMode == kReduce ? kThreads : 1];
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int kk0 = blockIdx.x * blockDim.x;
    const int kk = kk0 + threadIdx.x;
    const bool lane_ok = kk < g.w;
    const int p = lane_ok ? kk / g.zh : 0;
    const int k = kk - p * g.zh;
    const int p0 = kk0 / g.zh;                  // first box of the block
    const int kk_last = min(g.w, kk0 + (int)blockDim.x) - 1;
    const int n_box = kk_last / g.zh - p0 + 1;  // boxes the block touches
    const int r0 = blockIdx.y * blockDim.y * g.rpt + threadIdx.y;

    if constexpr (kMode == kHist) {
        for (int b = tid; b < kHistBins; b += blockDim.x * blockDim.y)
            s_hist[b] = 0;
    } else {
        if (tid < n_box) {
            s_max[tid] = 0u;
            s_min[tid] = 0xFFFFFFFFu;
        }
    }
    __syncthreads();

    for (int m = blockIdx.z; m < g.M; m += gridDim.z) {
        unsigned kmx = 0u, kmn = 0xFFFFFFFFu;
        for (int q = 0; q < g.rpt; ++q) {
            const int r = r0 + q * blockDim.y;
            if (!lane_ok || r >= g.rows) continue;
            Cell cell;
            cell.i = r / g.hy;
            cell.j = r - cell.i * g.hy;
            cell.k = k;
            cell.wx = (cell.i < (g.X >> 1)) ? 2 : 1;
            cell.wy = (cell.j < (g.Y >> 1)) ? 2 : 1;
            cell.wz = 2;
            float v[2][2][2] = {};
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    if (a < cell.wx && b < cell.wy) {
                        const float2 pr = *reinterpret_cast<const float2*>(
                            x + at(g, m, 2 * cell.i + a, 2 * cell.j + b,
                                   2 * kk));
                        v[a][b][0] = pr.x;
                        v[a][b][1] = pr.y;
                    }
                }
            cell_forward(v, cell);
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        if (!(a < cell.wx && b < cell.wy)) continue;
                        const float val = v[a][b][s];
                        c[at(g, m, coeff_pos(cell.i, a, cell.wx, g.X),
                             coeff_pos(cell.j, b, cell.wy, g.Y),
                             p * g.Z + (s ? g.zh + k : k))] = val;
                        if constexpr (kMode == kReduce) {
                            kmx = max(kmx, max_key(val));
                            kmn = min(kmn, min_key(val));
                        } else {
                            atomicAdd(&s_hist[hist_bin(val)], 1u);
                        }
                    }
        }
        if constexpr (kMode == kReduce) {
            // every lane takes part in the shuffles: idle lanes hold the
            // identities, and a warp's lanes share threadIdx.y
            for (int off = g.group >> 1; off > 0; off >>= 1) {
                kmx = max(kmx, __shfl_xor_sync(0xffffffffu, kmx, off));
                kmn = min(kmn, __shfl_xor_sync(0xffffffffu, kmn, off));
            }
            if (lane_ok && (threadIdx.x & (g.group - 1)) == 0) {
                atomicMax(&s_max[p - p0], kmx);
                atomicMin(&s_min[p - p0], kmn);
            }
            __syncthreads();
            if (tid < n_box) {
                const long long box = (long long)m * g.P + p0 + tid;
                if (s_max[tid] != 0u) atomicMax(&kmax[box], s_max[tid]);
                if (s_min[tid] != 0xFFFFFFFFu)
                    atomicMin(&kmin[box], s_min[tid]);
                s_max[tid] = 0u;
                s_min[tid] = 0xFFFFFFFFu;
            }
            __syncthreads();
        }
    }
    if constexpr (kMode == kHist) {
        __syncthreads();
        for (int b = tid; b < kHistBins; b += blockDim.x * blockDim.y) {
            const unsigned n = s_hist[b];
            if (n) atomicAdd(&hist[b], (unsigned long long)n);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
packed_inverse_kernel(const float* __restrict__ c, float* __restrict__ out,
                      Geometry g) {
    const int kk = blockIdx.x * blockDim.x + threadIdx.x;
    if (kk >= g.w) return;  // no block-wide step below
    const int p = kk / g.zh;
    const int k = kk - p * g.zh;
    const int r0 = blockIdx.y * blockDim.y * g.rpt + threadIdx.y;
    for (int m = blockIdx.z; m < g.M; m += gridDim.z) {
        for (int q = 0; q < g.rpt; ++q) {
            const int r = r0 + q * blockDim.y;
            if (r >= g.rows) break;
            const int i = r / g.hy;
            const int j = r - i * g.hy;
            const int wx = (i < (g.X >> 1)) ? 2 : 1;
            const int wy = (j < (g.Y >> 1)) ? 2 : 1;
            float v[2][2][2];
            if (wx == 2 && wy == 2) {
#pragma unroll
                for (int a = 0; a < 2; ++a)
#pragma unroll
                    for (int b = 0; b < 2; ++b)
#pragma unroll
                        for (int s = 0; s < 2; ++s)
                            v[a][b][s] = c[at(g, m, coeff_pos(i, a, 2, g.X),
                                              coeff_pos(j, b, 2, g.Y),
                                              p * g.Z + (s ? g.zh + k : k))];
                cell_inverse(v);
            } else {
                // every output of a cell on an odd X/Y tail lies on a tail
                // plane, which the reference's inverse leaves zero
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
                for (int b = 0; b < 2; ++b)
                    if (a < wx && b < wy)
                        *reinterpret_cast<float2*>(
                            out + at(g, m, 2 * i + a, 2 * j + b, 2 * kk)) =
                            make_float2(v[a][b][0], v[a][b][1]);
        }
    }
}

__global__ void __launch_bounds__(kThreads)
decode_extrema_kernel(const unsigned* __restrict__ kmax,
                      const unsigned* __restrict__ kmin,
                      float* __restrict__ maxv, float* __restrict__ minv,
                      long long n) {
    for (long long b = (long long)blockIdx.x * kThreads + threadIdx.x; b < n;
         b += (long long)gridDim.x * kThreads) {
        maxv[b] = from_key(kmax[b]);
        minv[b] = from_key(kmin[b]);
    }
}

// Geometry and launch shape; false when the arguments are not a packed
// batch the kernels take.
bool plan(int M, int X, int Y, int L, int P, Geometry& g, dim3& block,
          dim3& grid) {
    if (M <= 0 || X <= 0 || Y <= 0 || L <= 0 || P <= 0 || L % P) return false;
    g.M = M, g.X = X, g.Y = Y, g.L = L, g.P = P, g.Z = L / P;
    if (g.Z % 2) return false;
    g.zh = g.Z / 2;
    g.w = L / 2;
    g.hy = (Y >> 1) + (Y & 1);
    const long long rows = (long long)((X >> 1) + (X & 1)) * g.hy;
    if (rows > 0x7fffffffLL) return false;
    g.rows = (int)rows;
    // whole warps along the row, so a warp's lanes share threadIdx.y
    const int bx = (min(g.w, kThreads) + 31) / 32 * 32;
    const int by = kThreads / bx;
    g.rpt = (int)min((long long)kMaxRowsPerThread, (rows + by - 1) / by);
    // a box's lanes form aligned groups of a warp when Z/2 divides 32 or
    // 32 divides Z/2; otherwise each lane goes to the shared atomics alone
    g.group = (32 % g.zh == 0) ? g.zh : (g.zh % 32 == 0 ? 32 : 1);
    const long long gx = (g.w + bx - 1) / bx;
    const long long gy = (rows + (long long)by * g.rpt - 1) /
                         ((long long)by * g.rpt);
    if (gx > 0x7fffffffLL || gy > kMaxGrid) return false;
    block = dim3(bx, by);
    grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)min(M, kMaxGrid));
    return true;
}

}  // namespace

extern "C" {

// x, c: [M, X, Y, L] f32 (distinct buffers), L = P*Z with Z even;
// maxv, minv: [M*P] f32 in item order m*P + p; keys: [2*M*P] u32 scratch.
// Returns the cudaError_t of the launches (0 = launched).
int wt_packed_forward(const float* x, float* c, float* maxv, float* minv,
                      unsigned* keys, int M, int X, int Y, int L, int P,
                      void* stream) {
    Geometry g;
    dim3 block, grid;
    if (!plan(M, X, Y, L, P, g, block, grid)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long n = (long long)M * P;
    unsigned* kmax = keys;
    unsigned* kmin = keys + n;
    cudaError_t err = cudaMemsetAsync(kmax, 0x00, n * sizeof(unsigned), s);
    if (err == cudaSuccess)
        err = cudaMemsetAsync(kmin, 0xFF, n * sizeof(unsigned), s);
    if (err != cudaSuccess) return (int)err;
    packed_forward_kernel<kReduce><<<grid, block, 0, s>>>(x, c, kmax, kmin,
                                                          nullptr, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long blocks = min((n + kThreads - 1) / kThreads, 4096LL);
    decode_extrema_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(kmax, kmin,
                                                               maxv, minv, n);
    return (int)cudaGetLastError();
}

// x, c: [M, X, Y, L] f32 (distinct buffers); hist: [2048] u64, zeroed
// here, counts every coefficient of the batch (padding boxes included).
int wt_packed_forward_hist(const float* x, float* c, unsigned long long* hist,
                           int M, int X, int Y, int L, int P, void* stream) {
    Geometry g;
    dim3 block, grid;
    if (!plan(M, X, Y, L, P, g, block, grid)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        cudaMemsetAsync(hist, 0, kHistBins * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return (int)err;
    // each block flushes its table once: cap the blocks, the row loop
    // covers the rest
    const long long per_z = (long long)grid.x * grid.y;
    const long long cap = kHistMaxBlocks / per_z;
    if (cap < grid.z) grid.z = cap > 1 ? (unsigned)cap : 1u;
    packed_forward_kernel<kHist><<<grid, block, 0, s>>>(x, c, nullptr,
                                                        nullptr, hist, g);
    return (int)cudaGetLastError();
}

// c, out: [M, X, Y, L] f32 (distinct buffers).
int wt_packed_inverse(const float* c, float* out, int M, int X, int Y, int L,
                      int P, void* stream) {
    Geometry g;
    dim3 block, grid;
    if (!plan(M, X, Y, L, P, g, block, grid)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    packed_inverse_kernel<<<grid, block, 0, s>>>(c, out, g);
    return (int)cudaGetLastError();
}

}  // extern "C"
