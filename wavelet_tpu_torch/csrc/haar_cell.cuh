// The 2x2x2 cell arithmetic shared by the halves-layout Haar kernels of
// pyramid.cu (one box per batch row) and packed.cu (lane-packed rows).
//
// Along an axis of length n (h = n/2) the transform pairs (2i, 2i+1) and
// writes low to i and high to h+i; an odd tail stays at n-1.  So the three
// passes of one cell of the half-grid read only that cell and write 8
// outputs.  Every operation is an explicit round-to-nearest intrinsic, so no
// FMA can be contracted; with -ftz=false subnormals are kept, and the result
// is bitwise that of core/haar.py (the reference's loops).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kHistBins = 2048;
constexpr int kHistShift = 20;

__device__ __forceinline__ float pair_lo(float a, float b) {
    return __fmul_rn(__fadd_rn(a, b), 0.5f);
}

__device__ __forceinline__ float pair_hi(float a, float b) {
    return __fmul_rn(__fsub_rn(a, b), 0.5f);
}

// 2048-bin magnitude key of core/threshold.abs_exponent_histogram.
__device__ __forceinline__ unsigned hist_bin(float v) {
    return (__float_as_uint(v) & 0x7FFFFFFFu) >> kHistShift;
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

// Forward Z, Y, X passes of one cell in registers (v[x][y][z]).
__device__ __forceinline__ void cell_forward(float (&v)[2][2][2],
                                             const Cell& q) {
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
}

// Inverse X, Y, Z passes of one full (2x2x2) cell: (avg, diff) -> (even,
// odd) along each axis.
__device__ __forceinline__ void cell_inverse(float (&v)[2][2][2]) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const float e = __fadd_rn(v[0][b][s], v[1][b][s]);
            const float o = __fsub_rn(v[0][b][s], v[1][b][s]);
            v[0][b][s] = e;
            v[1][b][s] = o;
        }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const float e = __fadd_rn(v[a][0][s], v[a][1][s]);
            const float o = __fsub_rn(v[a][0][s], v[a][1][s]);
            v[a][0][s] = e;
            v[a][1][s] = o;
        }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
            const float e = __fadd_rn(v[a][b][0], v[a][b][1]);
            const float o = __fsub_rn(v[a][b][0], v[a][b][1]);
            v[a][b][0] = e;
            v[a][b][1] = o;
        }
}

}  // namespace
