// Exact stream compaction of thresholded coefficient rows for NVIDIA Hopper
// (sm_90a): the device half of sparse transfer.  Plain C interface, loaded
// with ctypes by wavelet_tpu_torch/kernels/build.py; wrapper and plain
// version in kernels/compact_cuda.py.
//
// Contract (wavelet_tpu/runtime/engine.py:_compact_step, and the drop-in
// wavelet_tpu/kernels/compact_pallas.py:compact_fast): for flat f32
// [n, m] and t32 f32 [n], row i keeps position p where fabsf(flat[i, p]) >
// t32[i] -- a NaN is never kept, a negative threshold keeps every non-NaN
// value (zeros too), +inf keeps nothing.  counts[i] is the row's kept
// count; slot j < min(counts[i], cap) of idx/vals [n, cap] holds the j-th
// kept position in ascending order and its value.  Slots past that are
// left unwritten (no consumer reads them).  A row with counts > cap gets
// its first cap pairs, as the argsort path gives.
//
// Replaces the TPU kernels of wavelet_tpu/kernels/compact_pallas.py
//   compact_count:   _rank_select_pallas (K8, per-chunk kept counts of the
//                    skewed strided view) and _rank_select_pallas_direct
//                    (K10, the same read from the unpadded flat layout);
//                    here per-tile counts of the flat row read in place;
//   compact_scatter: _assemble_pallas (K9, row-global assembly of the kept
//                    pairs); here each kept element is written straight to
//                    its slot, so there is no per-chunk capacity K, no
//                    overflow flag, no argsort fallback and no keysort.
// The exclusive scan of the tile counts between the two launches is
// torch.cumsum in the wrapper, as the JAX package takes the same scan
// outside Pallas (compact_pallas.py:577-579).
//
// Design.  A row is cut into tiles of kTile = 4096 elements; one block of
// 256 threads takes one (tile, row).  The tile is read in 16 rounds of 256
// consecutive elements, one per thread, so every warp load is 128
// contiguous bytes.  Each warp forms its 32-element keep mask with
// __ballot_sync; __popc of it is the warp's count.  compact_count sums
// those into the tile's count.  compact_scatter keeps the 16 ballots in
// registers, writes each (round, warp) count to shared memory, scans the
// 128 counts in position order with one warp, and writes each kept element
// at offset[i, tile] + scan[round, warp] + __popc(ballot & lanemask_lt),
// only where that slot is < cap.  The ragged last tile masks positions >=
// m before the ballot.  Positions within a row are int32 (m < 2^31); every
// address across rows is int64.
//
// Bound on this card: memory traffic.  The least a compaction must move is
// one read of flat (4 bytes per element) plus 8 bytes per kept pair
// written; the two-pass form reads flat twice (once per launch), so at a
// few percent kept it moves about twice the bound.  A single pass (e.g.
// decoupled look-back across tiles) is later work.  fabsf and the compare
// are exact IEEE operations; the build passes -ftz=false, so subnormals
// compare as they are.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;   // 4096 elements
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ bool kept(const float* __restrict__ row,
                                     long long p, int m, float t) {
    return p < m && fabsf(row[p]) > t;
}

// Per-tile kept counts: cnt [n, n_tiles].
__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const float* __restrict__ flat,
                     const float* __restrict__ t32, int* __restrict__ cnt,
                     int n, int m, int n_tiles) {
    __shared__ int s_warp[kWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
    for (int i = blockIdx.y; i < n; i += gridDim.y) {
        const float* row = flat + (long long)i * m;
        const float t = t32[i];
        int c = 0;
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
            const unsigned b = __ballot_sync(
                0xffffffffu, kept(row, base + r * kThreads, m, t));
            c += __popc(b);
        }
        if (lane == 0) s_warp[warp] = c;
        __syncthreads();
        if (threadIdx.x == 0) {
            int s = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) s += s_warp[w];
            cnt[(long long)i * n_tiles + blockIdx.x] = s;
        }
        __syncthreads();  // s_warp is reused by the next row
    }
}

// Kept pairs at offs[i, tile] + rank within the tile, where < cap.
__global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(const float* __restrict__ flat,
                       const float* __restrict__ t32,
                       const int* __restrict__ offs, int* __restrict__ idx,
                       float* __restrict__ vals, int n, int m, int n_tiles,
                       int cap) {
    constexpr int kSlots = kRounds * kWarps;   // 128 (round, warp) counts
    __shared__ int s_off[kSlots];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;     // lanes below this one
    const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
    for (int i = blockIdx.y; i < n; i += gridDim.y) {
        const int off = offs[(long long)i * n_tiles + blockIdx.x];
        if (off >= cap) continue;  // uniform per block: no slot left
        const float* row = flat + (long long)i * m;
        const float t = t32[i];
        unsigned ballot[kRounds];
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
            ballot[r] = __ballot_sync(
                0xffffffffu, kept(row, base + r * kThreads, m, t));
            if (lane == 0) s_off[r * kWarps + warp] = __popc(ballot[r]);
        }
        __syncthreads();
        // exclusive scan of the 128 counts in position order (round-major,
        // then warp): warp 0, four consecutive counts per lane
        if (warp == 0) {
            int v[4];
            int sum = 0;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                v[k] = s_off[lane * 4 + k];
                sum += v[k];
            }
            int incl = sum;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int o = __shfl_up_sync(0xffffffffu, incl, d);
                if (lane >= d) incl += o;
            }
            int run = incl - sum;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                s_off[lane * 4 + k] = run;
                run += v[k];
            }
        }
        __syncthreads();
        float* vrow = vals + (long long)i * cap;
        int* irow = idx + (long long)i * cap;
#pragma unroll
        for (int r = 0; r < kRounds; ++r) {
            if (ballot[r] & (1u << lane)) {
                const int slot =
                    off + s_off[r * kWarps + warp] + __popc(ballot[r] & lt);
                if (slot < cap) {
                    const long long p = base + r * kThreads;
                    irow[slot] = (int)p;
                    vrow[slot] = row[p];
                }
            }
        }
        __syncthreads();  // s_off is reused by the next row
    }
}

int tiles_of(int m) { return (m + kTile - 1) / kTile; }

int grid_y(int n) { return n < kMaxGridY ? n : kMaxGridY; }

bool bad_shape(int n, int m) { return n <= 0 || m <= 0; }

}  // namespace

extern "C" {

// Tiles per row: cnt and offs hold n * this many int32.
int wt_compact_tiles(int m) { return m > 0 ? tiles_of(m) : 0; }

// flat: [n, m] f32; t32: [n] f32; cnt: [n, wt_compact_tiles(m)] int32.
int wt_compact_count(const float* flat, const float* t32, int* cnt, int n,
                     int m, void* stream) {
    if (bad_shape(n, m)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int T = tiles_of(m);
    compact_count_kernel<<<dim3((unsigned)T, (unsigned)grid_y(n)), kThreads,
                           0, s>>>(flat, t32, cnt, n, m, T);
    return (int)cudaGetLastError();
}

// offs: [n, wt_compact_tiles(m)] int32, the exclusive per-row scan of
// wt_compact_count's cnt; idx: [n, cap] int32; vals: [n, cap] f32.
int wt_compact_scatter(const float* flat, const float* t32, const int* offs,
                       int* idx, float* vals, int n, int m, int cap,
                       void* stream) {
    if (bad_shape(n, m) || cap < 0) return (int)cudaErrorInvalidValue;
    if (cap == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int T = tiles_of(m);
    compact_scatter_kernel<<<dim3((unsigned)T, (unsigned)grid_y(n)),
                             kThreads, 0, s>>>(flat, t32, offs, idx, vals, n,
                                               m, T, cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
