// Single-scale 3D Haar transform of a batch of boxes, halves layout, for
// NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// wavelet_tpu_torch/kernels/build.py; wrappers in kernels/haar_cuda.py.
//
// Replaces the TPU kernels
//   forward: wavelet_tpu/kernels/haar_pallas.py:_fused_forward_call
//            (body _fwd_kernel / _fwd_block), transform + per-box max/min;
//   inverse: wavelet_tpu/kernels/haar_pallas.py:_fused_inverse_call
//            (body _inv_kernel / _inv_block).
//
// Arithmetic contract (wavelet_tpu_torch/core/haar.py, the plain version):
// forward Z, then Y, then X passes, each output fl(fl(a+b)*0.5) /
// fl(fl(a-b)*0.5); inverse X, then Y, then Z, fl(avg+diff) / fl(avg-diff).
// Every operation is an explicit round-to-nearest intrinsic, so no FMA can
// be contracted, and the build passes -ftz=false: subnormals are kept and
// the result is bitwise that of the reference's double-precision loops.
//
// Design.  Along an axis of length n (h = n/2) the transform pairs (2i,
// 2i+1) and writes low to i and high to h+i; an odd tail stays at n-1.  So
// the three passes of one 2x2x2 cell of the half-grid read only that cell
// and write 8 outputs: one thread per cell runs all three passes in
// registers, and the box is read once and written once.  Cells on an odd
// tail are 1 wide along that axis (the tail still goes through the other
// axes' passes; the inverse writes zeros there).  Neighbouring threads take
// neighbouring k, so loads (float2 along Z where Z is even) and stores
// (4 bytes at k and hz+k) coalesce.  The output is a fresh buffer: a
// cell's outputs land in other cells' inputs, so in place would race.
//
// Bound on this card: memory traffic.  The forward and inverse move 8 bytes
// per element (one 4-byte read, one 4-byte write) for 7 flops at most, far
// below the H100's ridge point, so the floor is 8 * N*X*Y*Z bytes at
// 3.35 TB/s.  The forward also reduces each box's max and min: per-block
// partials in registers and shared memory, then a second small kernel over
// the partials (no atomics, so the result does not depend on block order
// beyond the sign of a zero extremum).  The reductions propagate NaN, as
// jnp.max / torch.amax do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float pair_lo(float a, float b) {
    return __fmul_rn(__fadd_rn(a, b), 0.5f);
}

__device__ __forceinline__ float pair_hi(float a, float b) {
    return __fmul_rn(__fsub_rn(a, b), 0.5f);
}

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

struct Cell {
    int i, j, k;      // cell coordinates in the half-grid
    int wx, wy, wz;   // 2 for a pair, 1 for an odd tail
};

__device__ __forceinline__ Cell cell_of(long long cell, int X, int Y, int Z) {
    const int cy = (Y >> 1) + (Y & 1);
    const int cz = (Z >> 1) + (Z & 1);
    Cell c;
    c.k = (int)(cell % cz);
    const long long r = cell / cz;
    c.j = (int)(r % cy);
    c.i = (int)(r / cy);
    c.wx = (c.i < (X >> 1)) ? 2 : 1;
    c.wy = (c.j < (Y >> 1)) ? 2 : 1;
    c.wz = (c.k < (Z >> 1)) ? 2 : 1;
    return c;
}

// Coefficient position of slot s (0 = low/avg, 1 = high/diff) of cell
// index i along an axis of length n; a tail cell's one slot is n-1.
__device__ __forceinline__ int coeff_pos(int i, int s, int w, int n) {
    return (w == 1) ? (n - 1) : (s == 0 ? i : (n >> 1) + i);
}

__global__ void __launch_bounds__(kThreads)
haar_forward_kernel(const float* __restrict__ x, float* __restrict__ c,
                    float* __restrict__ pmax, float* __restrict__ pmin,
                    int n_box, int X, int Y, int Z) {
    const long long vol = (long long)X * Y * Z;
    const long long cells = (long long)((X >> 1) + (X & 1)) *
                            ((Y >> 1) + (Y & 1)) * ((Z >> 1) + (Z & 1));
    const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
    const bool active = cell < cells;
    const Cell q = cell_of(active ? cell : 0, X, Y, Z);
    const bool z_vec = (Z & 1) == 0;

    for (int box = blockIdx.y; box < n_box; box += gridDim.y) {
        float mx = -INFINITY;
        float mn = INFINITY;
        if (active) {
            const float* xb = x + (long long)box * vol;
            float* cb = c + (long long)box * vol;
            float v[2][2][2] = {};
#pragma unroll
            for (int a = 0; a < 2; ++a) {
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    if (a < q.wx && b < q.wy) {
                        const long long row =
                            ((long long)(2 * q.i + a) * Y + (2 * q.j + b)) * Z +
                            2 * q.k;
                        if (q.wz == 2 && z_vec) {
                            const float2 p =
                                *reinterpret_cast<const float2*>(xb + row);
                            v[a][b][0] = p.x;
                            v[a][b][1] = p.y;
                        } else {
                            v[a][b][0] = xb[row];
                            v[a][b][1] = (q.wz == 2) ? xb[row + 1] : 0.0f;
                        }
                    }
                }
            }
            // Z pass
            if (q.wz == 2) {
#pragma unroll
                for (int a = 0; a < 2; ++a)
#pragma unroll
                    for (int b = 0; b < 2; ++b) {
                        const float lo = pair_lo(v[a][b][0], v[a][b][1]);
                        const float hi = pair_hi(v[a][b][0], v[a][b][1]);
                        v[a][b][0] = lo;
                        v[a][b][1] = hi;
                    }
            }
            // Y pass
            if (q.wy == 2) {
#pragma unroll
                for (int a = 0; a < 2; ++a)
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        const float lo = pair_lo(v[a][0][s], v[a][1][s]);
                        const float hi = pair_hi(v[a][0][s], v[a][1][s]);
                        v[a][0][s] = lo;
                        v[a][1][s] = hi;
                    }
            }
            // X pass
            if (q.wx == 2) {
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        const float lo = pair_lo(v[0][b][s], v[1][b][s]);
                        const float hi = pair_hi(v[0][b][s], v[1][b][s]);
                        v[0][b][s] = lo;
                        v[1][b][s] = hi;
                    }
            }
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        if (a < q.wx && b < q.wy && s < q.wz) {
                            const long long pos =
                                ((long long)coeff_pos(q.i, a, q.wx, X) * Y +
                                 coeff_pos(q.j, b, q.wy, Y)) * Z +
                                coeff_pos(q.k, s, q.wz, Z);
                            const float val = v[a][b][s];
                            cb[pos] = val;
                            mx = nan_max(mx, val);
                            mn = nan_min(mn, val);
                        }
                    }
        }
        block_max_min(mx, mn);
        if (threadIdx.x == 0) {
            pmax[(long long)box * gridDim.x + blockIdx.x] = mx;
            pmin[(long long)box * gridDim.x + blockIdx.x] = mn;
        }
    }
}

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

__global__ void __launch_bounds__(kThreads)
haar_inverse_kernel(const float* __restrict__ c, float* __restrict__ out,
                    int n_box, int X, int Y, int Z) {
    const long long vol = (long long)X * Y * Z;
    const long long cells = (long long)((X >> 1) + (X & 1)) *
                            ((Y >> 1) + (Y & 1)) * ((Z >> 1) + (Z & 1));
    const long long cell = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (cell >= cells) return;  // no block-wide step below
    const Cell q = cell_of(cell, X, Y, Z);
    const bool full = q.wx == 2 && q.wy == 2 && q.wz == 2;
    const bool z_vec = (Z & 1) == 0;

    for (int box = blockIdx.y; box < n_box; box += gridDim.y) {
        const float* cbx = c + (long long)box * vol;
        float* ob = out + (long long)box * vol;
        float v[2][2][2];
        if (full) {
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int s = 0; s < 2; ++s)
                        v[a][b][s] = cbx[((long long)coeff_pos(q.i, a, 2, X) * Y +
                                          coeff_pos(q.j, b, 2, Y)) * Z +
                                         coeff_pos(q.k, s, 2, Z)];
            // X pass: (avg, diff) -> (even, odd)
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    const float e = __fadd_rn(v[0][b][s], v[1][b][s]);
                    const float o = __fsub_rn(v[0][b][s], v[1][b][s]);
                    v[0][b][s] = e;
                    v[1][b][s] = o;
                }
            // Y pass
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    const float e = __fadd_rn(v[a][0][s], v[a][1][s]);
                    const float o = __fsub_rn(v[a][0][s], v[a][1][s]);
                    v[a][0][s] = e;
                    v[a][1][s] = o;
                }
            // Z pass
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    const float e = __fadd_rn(v[a][b][0], v[a][b][1]);
                    const float o = __fsub_rn(v[a][b][0], v[a][b][1]);
                    v[a][b][0] = e;
                    v[a][b][1] = o;
                }
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
                        ((long long)(2 * q.i + a) * Y + (2 * q.j + b)) * Z +
                        2 * q.k;
                    if (q.wz == 2 && z_vec) {
                        *reinterpret_cast<float2*>(ob + row) =
                            make_float2(v[a][b][0], v[a][b][1]);
                    } else {
                        ob[row] = v[a][b][0];
                        if (q.wz == 2) ob[row + 1] = v[a][b][1];
                    }
                }
            }
    }
}

bool bad_shape(int n_box, int X, int Y, int Z) {
    return n_box <= 0 || X <= 0 || Y <= 0 || Z <= 0;
}

long long cells_per_box(int X, int Y, int Z) {
    return (long long)((X >> 1) + (X & 1)) * ((Y >> 1) + (Y & 1)) *
           ((Z >> 1) + (Z & 1));
}

}  // namespace

extern "C" {

// Blocks per box of the forward kernel = per-box partials the caller
// allocates (pmax/pmin hold n_box * this many floats each).
long long wt_haar_forward_blocks(int X, int Y, int Z) {
    return (cells_per_box(X, Y, Z) + kThreads - 1) / kThreads;
}

// x, c: [n_box, X, Y, Z] f32 (distinct buffers); maxv, minv: [n_box];
// pmax, pmin: [n_box, wt_haar_forward_blocks(X, Y, Z)] scratch.
// Returns the cudaError_t of the launches (0 = launched).
int wt_haar_forward(const float* x, float* c, float* maxv, float* minv,
                    float* pmax, float* pmin, int n_box, int X, int Y, int Z,
                    void* stream) {
    if (bad_shape(n_box, X, Y, Z)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long n_part = wt_haar_forward_blocks(X, Y, Z);
    if (n_part > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)n_part, (unsigned)(n_box < kMaxGridY ? n_box : kMaxGridY));
    haar_forward_kernel<<<grid, kThreads, 0, s>>>(x, c, pmax, pmin, n_box, X,
                                                  Y, Z);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int rgrid = n_box < kMaxGridY ? n_box : kMaxGridY;
    reduce_partials_kernel<<<rgrid, kThreads, 0, s>>>(pmax, pmin, maxv, minv,
                                                      n_box, (int)n_part);
    return (int)cudaGetLastError();
}

// c, out: [n_box, X, Y, Z] f32 (distinct buffers).
int wt_haar_inverse(const float* c, float* out, int n_box, int X, int Y,
                    int Z, void* stream) {
    if (bad_shape(n_box, X, Y, Z)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long n_blk = wt_haar_forward_blocks(X, Y, Z);
    if (n_blk > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    dim3 grid((unsigned)n_blk, (unsigned)(n_box < kMaxGridY ? n_box : kMaxGridY));
    haar_inverse_kernel<<<grid, kThreads, 0, s>>>(c, out, n_box, X, Y, Z);
    return (int)cudaGetLastError();
}

const char* wt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
