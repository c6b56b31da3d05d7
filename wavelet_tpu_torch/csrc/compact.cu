// Exact stream compaction of thresholded coefficient rows for NVIDIA Hopper
// (sm_90a): the device half of sparse transfer, in one single-pass kernel.
// Plain C interface, loaded with ctypes by wavelet_tpu_torch/kernels/
// build.py; wrapper and plain version in kernels/compact_cuda.py.
//
// Contract (wavelet_tpu/runtime/engine.py:_compact_step, and the drop-in
// wavelet_tpu/kernels/compact_pallas.py:compact_fast): for flat f32
// [n, m] and t32 f32 [n], row i keeps position p where fabsf(flat[i, p]) >
// t32[i] -- a NaN is never kept, a negative threshold keeps every non-NaN
// value (zeros too), +inf and NaN thresholds keep nothing.  counts[i] is
// the row's kept count, exact whatever the cap; slot j < min(counts[i],
// cap) of idx/vals [n, cap] holds the j-th kept position in ascending
// order and its value.  Slots past that are left unwritten (no consumer
// reads them).  A row with counts > cap gets its first cap pairs, as the
// argsort path gives.
//
// Replaces the TPU kernels of wavelet_tpu/kernels/compact_pallas.py:
//   _rank_select_pallas (K8, :196: per-chunk ranks and compacted pairs of
//   the skewed strided view), _rank_select_pallas_direct (K10, :344: the
//   same read from the unpadded flat layout) and _assemble_pallas (K9,
//   :484: row-global assembly of the per-chunk pairs).  Here one kernel
//   reads each coefficient once and writes each kept pair at its final
//   slot: no per-chunk capacity K, no overflow flag, no argsort fallback,
//   no keysort, and no scan between launches.
//
// Bound on this card: memory traffic.  The least a compaction must move is
// one read of flat (4 bytes per element) plus 8 bytes per kept pair
// written (and 4 bytes per row of t32 and counts); a few operations per
// element are far below the card's rate.  So the design reads flat once,
// in 32 KB bulk copies, and keeps the ranks, the tile's kept positions and
// the row offsets in registers, shared memory and a small status array.
//
// Design: a single-pass scan with decoupled look-back within each row
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", 2016).
// 1. A row is cut into tiles of kTile = 8192 elements; one block of 256
//    threads takes one (row, tile).  The block takes its tile id from a
//    global ticket (atomicAdd), in row-major order, not from blockIdx: a
//    tile then waits only on tiles whose blocks already run, so the
//    look-back cannot deadlock in whatever order the card schedules
//    blocks.  The grid is flat and 1-D: no cap on the number of rows.
// 2. Thread 0 brings the tile into shared memory with one bulk copy (the
//    copy engine, cp.async.bulk, completing on an mbarrier) where m % 4 ==
//    0 and flat is 16-byte aligned (every row then starts aligned); else
//    the threads load it themselves.  Lane l of warp w owns the 32
//    consecutive positions from (32w + l) * 32 and reads them as 8 float4s
//    in a lane-dependent order, which puts the 8 lanes of each 128-byte
//    shared-memory phase on distinct banks.  Its keep mask is one 32-bit
//    word; a warp scan of the lanes' counts ranks each lane's run, and the
//    8 warp totals give each warp's offset in the tile.  The ragged last
//    tile masks positions >= m.
// 3. Thread 0 publishes the tile's count at once in the tile's 64-bit
//    status word: flag (1 = aggregate, 2 = inclusive prefix) in the high
//    half and the value in the low half, written with st.release and read
//    with ld.acquire, so flag and value are never read torn.  Tile 0 of a
//    row publishes its inclusive prefix directly.  Warp 0 of any other
//    tile looks back over 32 predecessors of its row at a time, waits
//    until each has published, sums aggregates up to the nearest
//    inclusive prefix, and publishes its own inclusive prefix.
// 4. Meanwhile each lane stages its kept positions (16-bit, tile-relative)
//    in rank order in its warp's stretch of shared memory.  Then each warp
//    writes its contiguous run of slots [off + warp offset, ...) of idx
//    and vals with coalesced stores, the values read back from the tile in
//    shared memory, clipped at cap.  A tile whose offset is already >= cap
//    writes nothing.  The last tile of a row writes counts[i].
// Positions within a row are int32 (m < 2^31); every address across rows
// is int64.  fabsf and the compare are exact IEEE operations; the build
// passes -ftz=false, so subnormals compare as they are.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 32;                 // positions a lane: one mask bit each
constexpr int kTile = kPer * kThreads;   // 8192 elements, 32 KB
constexpr int kSeg = kTile / kWarps;     // a warp's positions
constexpr int kTileBytes = kTile * 4;    // dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr long long kMaxSpins = 1ll << 24;   // seconds of look-back polls

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
    asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
}

__device__ __forceinline__ unsigned smem(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// The bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on the fresh barrier `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar))
                 : "memory");
    // the barrier's init, ordered before the copy engine's use of it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

// Wait for phase 0 of `bar`: the bulk copy has landed.
__device__ __forceinline__ void bulk_wait(unsigned long long* bar) {
    unsigned done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(smem(bar)) : "memory");
    } while (!done);
}

// Exclusive prefix of the row's tiles before `tile`, by warp 0: look back
// over 32 predecessors at a time until one holds an inclusive prefix.
__device__ __forceinline__ int look_back(const unsigned long long* st,
                                         int tile, int lane) {
    int excl = 0;
    for (int pred = tile - 1;; pred -= 32) {
        const int j = pred - lane;
        unsigned long long s = j >= 0 ? load_acquire(st + j) : kInclusive;
        for (long long spin = 0; __any_sync(kFull, (s >> 32) == 0); ++spin) {
            // a predecessor that never publishes (a fault): fail the launch
            // rather than hang the card
            if (spin == kMaxSpins) __trap();
            if ((s >> 32) == 0) s = load_acquire(st + j);
        }
        const unsigned incl = __ballot_sync(kFull, (s >> 32) == 2);
        // lanes up to the nearest inclusive prefix (all 32 if none)
        const int stop = incl ? __ffs(incl) - 1 : 31;
        int v = lane <= stop ? (int)(s & 0xffffffffu) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
        excl += v;
        if (incl) return excl;
    }
}

struct Rows {
    const float* flat;
    const float* t32;
    int* counts;
    int* idx;
    float* vals;
    unsigned long long* status;   // [n, n_tiles], zeroed
    unsigned* ticket;             // zeroed
    int m, n_tiles, cap;
};

// kBulk: the tile comes by one bulk copy (rows 16-byte aligned), else by
// the threads' own loads.
template <bool kBulk>
__global__ void __launch_bounds__(kThreads) compact_kernel(Rows a) {
    extern __shared__ __align__(128) float s_buf[];   // [kTile]
    __shared__ unsigned short s_stage[kTile];   // kept positions, by rank
    __shared__ unsigned long long s_bar;
    __shared__ int s_warp[kWarps];
    __shared__ unsigned s_id;
    __shared__ int s_off;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    // 1. the tile from the ticket, and its bytes into shared memory
    if (tid == 0) {
        const unsigned id = atomicAdd(a.ticket, 1u);
        s_id = id;
        if (kBulk) {
            const int i = (int)(id / (unsigned)a.n_tiles);
            const long long p0 =
                (long long)(id - (unsigned)i * (unsigned)a.n_tiles) * kTile;
            const long long len = min((long long)kTile, a.m - p0);
            bulk_load(s_buf, a.flat + (long long)i * a.m + p0,
                      (unsigned)(4 * len), &s_bar);
        }
    }
    __syncthreads();
    const unsigned id = s_id;
    const int i = (int)(id / (unsigned)a.n_tiles);
    const int tile = (int)(id - (unsigned)i * (unsigned)a.n_tiles);
    const long long p0 = (long long)tile * kTile;
    const int len = (int)min((long long)kTile, a.m - p0);
    if (kBulk) {
        bulk_wait(&s_bar);
    } else {
        const float* row = a.flat + (long long)i * a.m + p0;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int e = j * kThreads + tid;
            if (e < len) s_buf[e] = row[e];
        }
        __syncthreads();
    }

    // 2. the lane's keep mask: bit b for tile position first + b, read as
    // float4 chunk c = j ^ (lane & 7) in turn j
    const float t = a.t32[i];
    const int first = tid * kPer;
    unsigned mask = 0;
#pragma unroll
    for (int j = 0; j < kPer / 4; ++j) {
        const int c = j ^ (lane & 7);
        const int e = first + 4 * c;
        const float4 q = *reinterpret_cast<const float4*>(s_buf + e);
        unsigned m4;
        if (len == kTile) {
            m4 = (fabsf(q.x) > t) | (fabsf(q.y) > t) << 1 |
                 (fabsf(q.z) > t) << 2 | (fabsf(q.w) > t) << 3;
        } else {
            m4 = (e < len && fabsf(q.x) > t) |
                 (e + 1 < len && fabsf(q.y) > t) << 1 |
                 (e + 2 < len && fabsf(q.z) > t) << 2 |
                 (e + 3 < len && fabsf(q.w) > t) << 3;
        }
        mask |= m4 << (4 * c);
    }
    // the lane's rank in its warp, the warp's count, then the tile's
    const int lane_cnt = __popc(mask);
    int incl = lane_cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += o;
    }
    const int warp_cnt = __shfl_sync(kFull, incl, 31);
    if (lane == 0) s_warp[warp] = warp_cnt;
    __syncthreads();
    int warp_off = 0, count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        if (w < warp) warp_off += s_warp[w];
        count += s_warp[w];
    }

    // 3. publish the tile's aggregate (tile 0: its inclusive prefix), then
    // the row offset of this tile
    unsigned long long* st = a.status + (long long)i * a.n_tiles;
    if (tid == 0)
        store_release(st + tile, (tile == 0 ? kInclusive : kAggregate) |
                                     (unsigned long long)count);
    if (warp == 0) {
        int off = 0;
        if (tile > 0) {
            off = look_back(st, tile, lane);
            if (lane == 0)
                store_release(st + tile,
                              kInclusive | (unsigned long long)(off + count));
        }
        if (lane == 0) s_off = off;
    }
    // 4. the lane's kept positions, staged in rank order in the warp's
    // stretch of s_stage (warp 0 after its look-back, the others during it)
    unsigned short* stage = s_stage + warp * kSeg;
    for (int r = incl - lane_cnt; mask; mask &= mask - 1, ++r)
        stage[r] = (unsigned short)(first + __ffs(mask) - 1);
    __syncthreads();
    const int off = s_off;

    // each warp's run of slots from off + warp_off, in coalesced stores
    // clipped at cap
    const int lim = (int)min((long long)warp_cnt,
                             (long long)a.cap - off - warp_off);
    const long long row0 = (long long)i * a.cap + off + warp_off;
    for (int r = lane; r < lim; r += 32) {
        const int e = stage[r];
        a.idx[row0 + r] = (int)(p0 + e);
        a.vals[row0 + r] = s_buf[e];
    }
    // 5. the row's count
    if (tile == a.n_tiles - 1 && tid == 0) a.counts[i] = off + count;
}

int tiles_of(int m) { return (int)(((long long)m + kTile - 1) / kTile); }

// Tiles of the whole call, or -1 when the shape is empty or the grid
// would exceed one launch.
long long grid_of(int n, int m) {
    if (n <= 0 || m <= 0) return -1;
    const long long g = (long long)n * tiles_of(m);
    return g <= INT_MAX ? g : -1;
}

}  // namespace

extern "C" {

// 64-bit words of scratch wt_compact needs for [n, m] (the status word of
// every (row, tile) and the ticket), to be zeroed before each call; -1
// for a shape it refuses.
long long wt_compact_scratch(int n, int m) {
    const long long g = grid_of(n, m);
    return g < 0 ? -1 : g + 1;
}

// flat: [n, m] f32; t32: [n] f32; counts: [n] int32; idx: [n, cap] int32;
// vals: [n, cap] f32; scratch: wt_compact_scratch(n, m) zeroed 64-bit
// words, used by this call alone.
int wt_compact(const float* flat, const float* t32, int* counts, int* idx,
               float* vals, void* scratch, int n, int m, int cap,
               void* stream) {
    const long long g = grid_of(n, m);
    if (g < 0 || cap < 0) return (int)cudaErrorInvalidValue;
    unsigned long long* status = static_cast<unsigned long long*>(scratch);
    const Rows a{flat, t32, counts, idx, vals, status,
                 reinterpret_cast<unsigned*>(status + g), m, tiles_of(m),
                 cap};
    const bool bulk =
        m % 4 == 0 && reinterpret_cast<uintptr_t>(flat) % 16 == 0;
    auto kern = bulk ? compact_kernel<true> : compact_kernel<false>;
    // the tile and the staging together pass the 48 KB a block gets
    // without asking
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileBytes);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)g, kThreads, kTileBytes, static_cast<cudaStream_t>(
                                                  stream)>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
