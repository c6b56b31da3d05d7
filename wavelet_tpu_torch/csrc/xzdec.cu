// xz members decoded on the card for NVIDIA Hopper (sm_90a): one block a
// member decodes the member's LZMA2 data, checks its CRC64 and writes the
// payload's (run, value) pairs straight into the member's zeroed
// coefficient row, the row the inverse kernel (K2) reads next.  Plain C
// interface, loaded with ctypes by wavelet_tpu_torch/kernels/build.py;
// wrapper and plain version in kernels/xzdec_cuda.py.
//
// Why it exists: it replaces no TPU kernel.  The JAX package, and the port
// before it, decode every xz member on the host, and regenerating an
// archive is bound by that decode while the card idles (about 95% of the
// window).  The members are independent xz streams, so the card's SMs can
// each decode one beside the host's cores: the caller gives the card the
// smallest members of a bucket and the host pool the largest.
//
// Bound on this card: a serial chain of range-coder bit decodes, not
// bytes.  LZMA's range decoder turns each bit into a multiply, a compare
// and a probability update whose inputs (range, code, the probability) all
// come from the bit before; a literal byte takes 8 or 9 such bits, a match
// some 15-30 for all its bytes.  Nothing inside a member runs in parallel,
// so one thread of one block walks it, and the card's parallelism is the
// members: one block a member, one member an SM.  The memory traffic (the
// xz bytes in, the payload and the row out) is negligible beside the chain.
//
// Design, against that chain:
// - The probability model lives in shared memory (1856 + 0x300 << (lc +
//   lp) uint16 words: 16 KB at lc = 3, lp = 0; 28 KB at the largest LZMA2
//   allows), as does a 64 KiB window of the newest output, from which
//   matches and matched literals read; older bytes come from the payload
//   in device memory, which this thread wrote itself.
// - Bit trees load the four grandchildren of each node as one 64-bit word
//   two bits before they are needed (every tree starts 8-byte aligned),
//   so no shared-memory load lies on the chain of a tree's bits; the
//   matched literal's tree, whose children are not adjacent, loads both
//   children before each bit resolves.
// - The range is normalised without branches (selects and a predicated
//   load), and the next input byte waits in a register, loaded when the
//   byte before it was taken.
// - The CRC64 (xz's check) is taken byte by byte as the bytes are made, a
//   chain of its own beside the decoder's, from a table in shared memory.
// Then, after a __syncthreads(), the whole block checks the payload
// header against the bucket's box, sums runs + 1 over each thread's
// stretch of pairs, requires every run >= 0 and the last position < X*Y*Z
// (core/rle.rle_decode's vectorised case), takes the block's prefix sum
// and writes each value at its position.  A member that fails any rule
// leaves its row untouched and reports a non-zero status, and the caller
// hands it to the host reader (which decodes it, or raises).
//
// The rules of the LZMA2 data are liblzma's (kernels/xzdec_cuda.py's
// lzma2_decode_plain decodes the same way): the first chunk resets the
// dictionary; an LZMA chunk after a dictionary reset sets properties with
// lc + lp <= 4; each chunk's range coder starts with a zero byte, ends
// with code 0 and spends exactly the chunk's bytes; a match never runs
// past its chunk nor reaches before the first byte; the block gives
// exactly its uncompressed size and spends exactly its compressed size.
// A dictionary reset after the first byte (legal, but never written by
// the buffer encoder whose layout the caller admits) is declined.
// Each block records its start and end (%globaltimer, ns).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kWindow = 1u << 16;   // shared-memory window of output
constexpr uint32_t kTop = 1u << 24;
// bytes a symbol may read past its chunk before the decoder stops (a
// symbol takes at most ~20); the caller pads the staged blob with them
constexpr uint32_t kSlack = 64;

// status codes (kernels/xzdec_cuda.py)
constexpr int kOk = 0;
constexpr int kDataError = 1;
constexpr int kDictReset = 2;
constexpr int kCheckError = 3;
constexpr int kPayloadError = 4;
constexpr int kRunsDeclined = 5;

// the probability model's layout (kernels/xzdec_cuda.py)
constexpr int kIsMatch = 0;
constexpr int kIsRep = 192;
constexpr int kIsRep0 = 204;
constexpr int kIsRep1 = 216;
constexpr int kIsRep2 = 228;
constexpr int kIsRep0Long = 240;
constexpr int kDistSlot = 432;
constexpr int kDistSpecial = 688;
constexpr int kDistAlign = 802;
constexpr int kMatchLen = 822;     // each tree's first word 8-byte aligned
constexpr int kRepLen = 1342;
constexpr int kLiteral = 1856;
constexpr int kProbs = kLiteral + (0x300 << 4);

constexpr size_t kProbBytes = (kProbs * 2 + 15) / 16 * 16;
constexpr size_t kCrcBytes = 256 * 8;
constexpr size_t kSmemBytes = kProbBytes + kCrcBytes + kWindow;

struct Member {
    long long in_off, comp, unc, crc, out_off;
};

__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// The range decoder.  The next input byte waits in a register (`nb`),
// loaded when the byte before it was taken, so the load's latency lies
// between two normalisations and not on the chain.  `at` points at that
// byte; the decoder stops at the first symbol that starts past its
// chunk's end, so a corrupt stream reads at most a symbol's bytes (under
// kSlack) past it, into the staging's padding.
struct Rc {
    uint32_t range, code;
    const uint8_t* at;
    uint32_t nb;
};

__device__ __forceinline__ void rc_seek(Rc& r, const uint8_t* at) {
    r.at = at;
    r.nb = __ldg(at);
}

__device__ __forceinline__ uint32_t rc_take(Rc& r) {
    const uint32_t b = r.nb;
    r.nb = __ldg(++r.at);
    return b;
}

// branch-free normalisation: shift in the next byte when range < 2^24
__device__ __forceinline__ void rc_norm(Rc& r) {
    const bool n = r.range < kTop;
    r.code = n ? (r.code << 8) | r.nb : r.code;
    r.range = n ? r.range << 8 : r.range;
    if (n) r.nb = __ldg(++r.at);        // predicated: no branch
}

// one bit of probability `prob` (already loaded) stored at `p`
__device__ __forceinline__ uint32_t rc_bit_p(Rc& r, uint16_t* p,
                                             uint32_t prob) {
    rc_norm(r);
    const uint32_t bound = (r.range >> 11) * prob;
    const uint32_t bit = r.code >= bound ? 1u : 0u;
    r.range = bit ? r.range - bound : bound;
    r.code = bit ? r.code - bound : r.code;
    *p = static_cast<uint16_t>(bit ? prob - (prob >> 5)
                                   : prob + ((2048u - prob) >> 5));
    return bit;
}

__device__ __forceinline__ uint32_t rc_bit(Rc& r, uint16_t* p) {
    return rc_bit_p(r, p, *p);
}

// four probabilities as one word (`p` 8-byte aligned), and the k-th of them
__device__ __forceinline__ uint64_t lds64(const uint16_t* p) {
    return *reinterpret_cast<const uint64_t*>(p);
}

__device__ __forceinline__ uint32_t quarter(uint64_t w, uint32_t k) {
    const uint32_t half = (k & 2) ? (uint32_t)(w >> 32) : (uint32_t)w;
    return (k & 1) ? half >> 16 : half & 0xFFFFu;
}

// a bit tree of kBits levels at `probs` (8-byte aligned); `head` holds
// probs[0..3], the root and its children.  At each node the four
// grandchildren load as one word, used two bits later: no load lies on
// the chain of bits.  (The stores go to the node's ancestors, never to a
// grandchild loaded ahead.)
template <int kBits>
__device__ __forceinline__ uint32_t rc_tree_h(Rc& r, uint16_t* probs,
                                              uint64_t head) {
    uint32_t sym = 1, b_prev = 1;
    uint32_t p = quarter(head, 1);
    uint64_t g_prev = head;
#pragma unroll
    for (int i = 0; i < kBits; ++i) {
        uint64_t g = 0;
        if (i + 2 < kBits) g = lds64(probs + 4 * sym);
        // this node's children, out of the word loaded a bit ago, before
        // the bit resolves: then one select lies on the chain
        const uint32_t kids = b_prev ? (uint32_t)(g_prev >> 32)
                                     : (uint32_t)g_prev;
        const uint32_t c0 = kids & 0xFFFFu, c1 = kids >> 16;
        const uint32_t b = rc_bit_p(r, probs + sym, p);
        sym = 2 * sym + b;
        p = b ? c1 : c0;
        g_prev = g;
        b_prev = b;
    }
    return sym - (1u << kBits);
}

template <int kBits>
__device__ __forceinline__ uint32_t rc_tree(Rc& r, uint16_t* probs) {
    return rc_tree_h<kBits>(r, probs, lds64(probs));
}

__device__ __forceinline__ uint32_t rc_reverse(Rc& r, uint16_t* probs,
                                               int nbits) {
    uint32_t sym = 1, res = 0;
    for (int i = 0; i < nbits; ++i) {
        const uint32_t b = rc_bit(r, probs + sym);
        sym = 2 * sym + b;
        res |= b << i;
    }
    return res;
}

__device__ __forceinline__ uint32_t rc_direct(Rc& r, int nbits) {
    uint32_t res = 0;
    for (int i = 0; i < nbits; ++i) {
        rc_norm(r);
        r.range >>= 1;
        const uint32_t b = r.code >= r.range ? 1u : 0u;
        r.code = b ? r.code - r.range : r.code;
        res = (res << 1) | b;
    }
    return res;
}

__device__ __forceinline__ uint32_t rc_len(Rc& r, uint16_t* l, uint32_t ps) {
    if (!rc_bit(r, l)) return 2 + rc_tree<3>(r, l + 2 + ps * 8);
    if (!rc_bit(r, l + 1)) return 10 + rc_tree<3>(r, l + 130 + ps * 8);
    return 18 + rc_tree<8>(r, l + 258);
}

// The member's output: the payload in device memory, the newest kWindow
// bytes also in shared memory, and its CRC64 as it goes.
struct Out {
    uint8_t* dst;            // the payload in device memory
    uint8_t* win;            // shared window
    const unsigned long long* crc_tab;
    unsigned long long crc;
    uint32_t pos;
    uint32_t prev;           // the last byte written (0 before the first)

    __device__ __forceinline__ void put(uint32_t b) {
        win[pos & (kWindow - 1)] = static_cast<uint8_t>(b);
        dst[pos] = static_cast<uint8_t>(b);
        crc = crc_tab[(crc ^ b) & 0xFFu] ^ (crc >> 8);
        prev = b;
        ++pos;
    }

    // the byte dist + 1 back (dist < pos)
    __device__ __forceinline__ uint32_t back(uint32_t dist) const {
        const uint32_t src = pos - dist - 1;
        return dist < kWindow ? win[src & (kWindow - 1)] : dst[src];
    }
};

__device__ __forceinline__ void reset_probs(uint16_t* probs, int n) {
    for (int i = 0; i < n; ++i) probs[i] = 1024;
}

// LZMA2 data [in, in + comp) of the blob -> `unc` bytes; -> a status.
// Inlined into the kernel, so that the model and the window are known to
// lie in shared memory.
__device__ __forceinline__ int lzma2_decode(Rc& rc, uint32_t in,
                                            uint32_t comp, uint32_t unc,
                                            Out& o, uint16_t* P) {
    const uint32_t stop = in + comp;
    uint32_t ip = in;
    uint32_t state = 0, rep0 = 0, rep1 = 0, rep2 = 0, rep3 = 0;
    uint32_t lc = 0, lp = 0, pb = 0;
    bool need_dict_reset = true, need_props = true;
    const uint8_t* bytes = rc.at;       // the blob
    for (;;) {
        if (ip >= stop) return kDataError;
        const uint32_t control = __ldg(bytes + ip++);
        if (control == 0x00) break;
        const uint32_t pos0 = o.pos;
        if (control >= 0xE0 || control == 0x01) {
            if (pos0 != 0) return kDictReset;
            need_props = true;
            need_dict_reset = false;
        } else if (need_dict_reset) {
            return kDataError;
        }
        if (control < 0x80) {                // a stored chunk
            if (control > 0x02 || ip + 2 > stop) return kDataError;
            const uint32_t size =
                ((uint32_t)__ldg(bytes + ip) << 8 | __ldg(bytes + ip + 1)) + 1;
            ip += 2;
            if (size > unc - pos0 || size > stop - ip) return kDataError;
            for (uint32_t k = 0; k < size; ++k) o.put(__ldg(bytes + ip + k));
            ip += size;
            continue;
        }
        if (ip + 4 > stop) return kDataError;
        const uint32_t usize = (((control & 0x1Fu) << 16)
                                | ((uint32_t)__ldg(bytes + ip) << 8)
                                | __ldg(bytes + ip + 1)) + 1;
        const uint32_t csize =
            ((uint32_t)__ldg(bytes + ip + 2) << 8 | __ldg(bytes + ip + 3)) + 1;
        ip += 4;
        if (control >= 0xC0) {
            if (ip >= stop) return kDataError;
            const uint32_t props = __ldg(bytes + ip++);
            if (props >= 9 * 5 * 5) return kDataError;
            lc = props % 9;
            lp = props / 9 % 5;
            pb = props / 45;
            if (lc + lp > 4) return kDataError;
            need_props = false;
        } else if (need_props) {
            return kDataError;
        }
        if (control >= 0xA0) {
            reset_probs(P, kLiteral + (0x300 << (lc + lp)));
            state = rep0 = rep1 = rep2 = rep3 = 0;
        }
        if (usize > unc - pos0 || csize > stop - ip || csize < 5 ||
            __ldg(bytes + ip) != 0)
            return kDataError;
        rc_seek(rc, bytes + ip + 1);
        rc.range = 0xFFFFFFFFu;
        rc.code = 0;
        for (int k = 0; k < 4; ++k) rc.code = (rc.code << 8) | rc_take(rc);
        const uint32_t cend = ip + csize;
        const uint8_t* stop_at = bytes + cend;
        const uint32_t end = pos0 + usize;
        const uint32_t pb_mask = (1u << pb) - 1, lp_mask = (1u << lp) - 1;
        // each symbol's is_match probability and its literal tree's root
        // load before the bit before them resolves
        uint32_t p_match = P[kIsMatch + state * 16 + (o.pos & pb_mask)];
        while (o.pos < end) {
            if (rc.at > stop_at) return kDataError;
            const uint32_t ps = o.pos & pb_mask;
            uint16_t* lit = P + kLiteral + 0x300 * (((o.pos & lp_mask) << lc)
                                                    + (o.prev >> (8 - lc)));
            const uint64_t lit_head = lds64(lit);
            if (!rc_bit_p(rc, P + kIsMatch + state * 16 + ps, p_match)) {
                const uint32_t next = state < 4 ? 0
                                    : (state < 10 ? state - 3 : state - 6);
                p_match = P[kIsMatch + next * 16 + ((o.pos + 1) & pb_mask)];
                uint32_t sym;
                if (state < 7) {
                    sym = rc_tree_h<8>(rc, lit, lit_head);
                } else {
                    // a matched literal: the byte at rep0 steers the tree;
                    // both children's probabilities load before each bit
                    uint32_t match = o.back(rep0) << 1;
                    uint32_t offset = 0x100;
                    sym = 1;
                    uint32_t mbit = match & offset;
                    match <<= 1;
                    uint32_t p = lit[offset + mbit + sym];
#pragma unroll
                    for (int i = 0; i < 8; ++i) {
                        const uint32_t i_now = offset + mbit + sym;
                        const uint32_t off1 = offset & mbit;
                        const uint32_t off0 = offset & ~mbit;
                        const uint32_t mb1 = match & off1;
                        const uint32_t mb0 = match & off0;
                        uint32_t c0 = 0, c1 = 0;
                        if (i < 7) {
                            c0 = lit[off0 + mb0 + 2 * sym];
                            c1 = lit[off1 + mb1 + 2 * sym + 1];
                        }
                        const uint32_t b = rc_bit_p(rc, lit + i_now, p);
                        sym = 2 * sym + b;
                        offset = b ? off1 : off0;
                        mbit = b ? mb1 : mb0;
                        match <<= 1;
                        p = b ? c1 : c0;
                    }
                    sym -= 0x100;
                }
                o.put(sym);
                state = next;
                continue;
            }
            uint32_t len;
            if (rc_bit(rc, P + kIsRep + state)) {
                len = 0;
                if (!rc_bit(rc, P + kIsRep0 + state)) {
                    if (!rc_bit(rc, P + kIsRep0Long + state * 16 + ps)) {
                        state = state < 7 ? 9 : 11;
                        len = 1;
                    }
                } else {
                    uint32_t dist;
                    if (!rc_bit(rc, P + kIsRep1 + state)) {
                        dist = rep1;
                    } else {
                        if (!rc_bit(rc, P + kIsRep2 + state)) {
                            dist = rep2;
                        } else {
                            dist = rep3;
                            rep3 = rep2;
                        }
                        rep2 = rep1;
                    }
                    rep1 = rep0;
                    rep0 = dist;
                }
                if (len == 0) {
                    state = state < 7 ? 8 : 11;
                    len = rc_len(rc, P + kRepLen, ps);
                }
            } else {
                rep3 = rep2;
                rep2 = rep1;
                rep1 = rep0;
                len = rc_len(rc, P + kMatchLen, ps);
                state = state < 7 ? 7 : 10;
                const uint32_t ds = len - 2 < 3 ? len - 2 : 3;
                const uint32_t slot = rc_tree<6>(rc, P + kDistSlot + 64 * ds);
                if (slot < 4) {
                    rep0 = slot;
                } else {
                    const int nb = (int)(slot >> 1) - 1;
                    rep0 = (2u | (slot & 1u)) << nb;
                    if (slot < 14) {
                        rep0 += rc_reverse(rc, P + kDistSpecial + rep0 - slot - 1,
                                           nb);
                    } else {
                        rep0 += rc_direct(rc, nb - 4) << 4;
                        rep0 += rc_reverse(rc, P + kDistAlign, 4);
                    }
                }
            }
            if (rep0 >= o.pos || len > end - o.pos) return kDataError;
            p_match = P[kIsMatch + state * 16 + ((o.pos + len) & pb_mask)];
            for (uint32_t k = 0; k < len; ++k) o.put(o.back(rep0));
        }
        rc_norm(rc);                 // left normalised, then spent
        if (rc.code != 0 || rc.at != stop_at) return kDataError;
        ip = cend;
    }
    return (o.pos == unc && ip == stop) ? kOk : kDataError;
}

__global__ void __launch_bounds__(kThreads, 1)
xzdec_kernel(const uint8_t* __restrict__ blob, long long blob_bytes,
             const Member* __restrict__ members, uint8_t* scratch,
             long long scratch_bytes, float* __restrict__ rows,
             int* __restrict__ status, unsigned long long* __restrict__ ticks,
             int X, int Y, int Z) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint16_t* probs = reinterpret_cast<uint16_t*>(smem);
    unsigned long long* crc_tab =
        reinterpret_cast<unsigned long long*>(smem + kProbBytes);
    uint8_t* win = smem + kProbBytes + kCrcBytes;
    __shared__ int s_status;
    __shared__ long long s_pairs;
    __shared__ long long s_scan[kThreads];
    __shared__ int s_bad;

    const int j = blockIdx.x;
    const int t = threadIdx.x;
    unsigned long long t0 = 0;
    if (t == 0) t0 = globaltimer();
    {   // xz's CRC64 table, reflected ECMA-182
        unsigned long long c = (unsigned long long)t;
        for (int k = 0; k < 8; ++k)
            c = (c >> 1) ^ ((c & 1ull) ? 0xC96C5795D7870F42ull : 0ull);
        crc_tab[t] = c;
    }
    __syncthreads();

    const Member mb = members[j];
    const long long m = (long long)X * Y * Z;
    if (t == 0) {
        int st = kOk;
        if (mb.in_off < 0 || mb.comp <= 0 || mb.unc < 0 || mb.out_off < 0 ||
            mb.in_off + mb.comp + kSlack > blob_bytes ||
            mb.out_off + mb.unc > scratch_bytes || mb.unc >= (1ll << 32) ||
            (mb.out_off & 3) != 0) {
            st = kDataError;
        } else {
            Rc rc;
            rc.at = blob;
            rc.range = rc.code = rc.nb = 0;
            Out o;
            o.dst = scratch + mb.out_off;
            o.win = win;
            o.crc_tab = crc_tab;
            o.crc = ~0ull;
            o.pos = 0;
            o.prev = 0;
            st = lzma2_decode(rc, (uint32_t)mb.in_off, (uint32_t)mb.comp,
                              (uint32_t)mb.unc, o, probs);
            if (st == kOk &&
                (o.crc ^ ~0ull) != (unsigned long long)mb.crc)
                st = kCheckError;
        }
        long long n = 0;
        if (st == kOk) {
            // the payload header: int32 x, y, z, total, pairs
            const int* h = reinterpret_cast<const int*>(scratch + mb.out_off);
            if (mb.unc < 20) {
                st = kPayloadError;
            } else {
                n = h[4];
                if (h[0] != X || h[1] != Y || h[2] != Z || h[3] != m ||
                    n < 0 || 20 + 8 * n > mb.unc)
                    st = kPayloadError;
            }
        }
        s_status = st;
        s_pairs = n;
        s_bad = 0;
    }
    __syncthreads();
    int st = s_status;
    if (st == kOk) {
        // each thread's stretch of pairs: sum of runs + 1, any run < 0
        const long long n = s_pairs;
        const int* pairs = reinterpret_cast<const int*>(scratch + mb.out_off + 20);
        const long long per = (n + kThreads - 1) / kThreads;
        const long long lo = per * t < n ? per * t : n;
        const long long hi = lo + per < n ? lo + per : n;
        long long sum = 0;
        bool neg = false;
        for (long long k = lo; k < hi; ++k) {
            const int run = pairs[2 * k];
            neg |= run < 0;
            sum += (long long)run + 1;
        }
        if (neg) s_bad = 1;
        s_scan[t] = sum;
        __syncthreads();
        // inclusive scan of the stretches' sums (Hillis-Steele)
        for (int d = 1; d < kThreads; d <<= 1) {
            const long long v = t >= d ? s_scan[t - d] : 0;
            __syncthreads();
            s_scan[t] += v;
            __syncthreads();
        }
        if (s_bad || (n > 0 && s_scan[kThreads - 1] - 1 >= m)) {
            st = kRunsDeclined;
        } else {
            uint32_t* row = reinterpret_cast<uint32_t*>(rows) + (long long)j * m;
            long long p = s_scan[t] - sum - 1;
            for (long long k = lo; k < hi; ++k) {
                p += (long long)pairs[2 * k] + 1;
                row[p] = static_cast<uint32_t>(pairs[2 * k + 1]);
            }
        }
    }
    __syncthreads();
    if (t == 0) {
        status[j] = st;
        ticks[2 * j] = t0;
        ticks[2 * j + 1] = globaltimer();
    }
}

}  // namespace

extern "C" {

// blob: [blob_bytes] uint8 (under 4 GiB; a member's bytes are followed
// by at least kSlack more); desc: [n] members of five
// int64 (in_off, comp, unc, crc64, out_off; out_off a multiple of 4);
// scratch: [scratch_bytes] uint8; rows: [n, X, Y, Z] f32, zeroed; status:
// [n] int32; ticks: [n, 2] uint64 (ns).
int wt_xzdec(const void* blob, long long blob_bytes, const void* desc,
             void* scratch, long long scratch_bytes, float* rows,
             int* status, void* ticks, int n, int X, int Y, int Z,
             void* stream) {
    if (n <= 0 || X <= 0 || Y <= 0 || Z <= 0 || blob_bytes <= 0 ||
        blob_bytes >= (1ll << 32))
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        xzdec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    xzdec_kernel<<<n, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blob), blob_bytes,
        static_cast<const Member*>(desc), static_cast<uint8_t*>(scratch),
        scratch_bytes, rows, status,
        static_cast<unsigned long long*>(ticks), X, Y, Z);
    return (int)cudaGetLastError();
}

}  // extern "C"
