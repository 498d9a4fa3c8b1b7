// Flash attention forward with segment ids (the encoder's attention, K6).
//
// Replaces the Pallas TPU kernel that minivectordb_tpu/models/encoder.py
// (_attention, the flash branch) calls for long sequences:
// jax.experimental.pallas.ops.tpu.flash_attention.flash_attention with
// SegmentIds(q=seg, kv=seg).  -> flash_attention_f32, flash_attention_bf16
//
// For every (batch b, head h, query row i):
//   s[j]   = seg[b, i] == seg[b, j] ? dot(q[b,h,i], k[b,h,j]) * sm_scale : MASK
//   out[i] = sum_j softmax(s)[j] * v[b,h,j]
// with MASK = -0.7 * float32 max (finite, the TPU kernel's value), the softmax
// and both sums in float32, and the (S, S) matrix never in device memory. The
// segment ids are the attention mask (real tokens 1, pads 0), so a pad query
// attends to the pad keys of its own row; every query sees at least itself.
// The output has q's element type; bf16 is rounded once, from the float32
// accumulator divided by the float32 sum. The entry points flash_attention_lse_*
// also write each row's log-sum-exp, m + log(l) in float32 (natural log), from
// the epilogue that divides by l: the row statistic the backward kernels of
// csrc/flash_attention_bwd.cu recompute the probabilities from. The inference
// entry points pass a null pointer and write nothing more.
//
// What both kernels share. An item is one (batch, head) and a tile of 128
// query rows; the keys are cut into tiles (BF_KT = 128 for bf16, F32Cfg::KT =
// 64 or 32 for f32). At the encoder's shapes an item visits only a few key tiles, so what
// a block does once per item (find the tiles, load Q, wait for the first
// loads, write the output) weighs as much as the products: the first design
// (one block per item, synchronous loads, a block barrier per tile) spent
// most of its time there. So the blocks are persistent (one per SM, walking
// items blockIdx.x, + gridDim.x, ...) and warp-specialised:
//   - one producer warp (one warp of a producer warpgroup) walks
//     the block's items and, per item, the key tiles to visit, and fills a
//     ring of ST stages in shared memory running ahead
//     of the consumers across item boundaries: lane 0 has TMA copy the K and
//     V tiles (and Q, into one of NQ slots, with an item's first tile), the
//     lanes copy the segment ids with cp.async. A stage's "full" mbarrier
//     completes when the TMA bytes and the lanes' copies have landed
//     (expect_tx, cp.async.mbarrier.arrive.noinc); its "empty" one when every
//     consumer warp is done with it; each query slot has an "empty" barrier
//     too. No block-wide barrier is left in the loop, and the tensor maps let
//     one instruction fetch a tile.
//   - consumer warps take the stages in order, keep the running max m, the
//     running sum l and the output accumulator in float32 registers and
//     rescale them tile by tile (online softmax, in the exp2 domain with the
//     scale folded into the logits), and write an item's rows after its last
//     tile (the producer flags first and last tiles).
// Rows past S read as zeros (TMA out-of-bounds fill) and are masked. MASK is
// finite: a row that sees nothing in a tile gets p = exp(0) = 1 for that
// tile, and the first tile with a visible key wipes it with
// alpha = exp(MASK - m) = 0; no exp(-inf - (-inf)) can occur. The work the
// data does not need is skipped: a key tile whose range of segment ids
// [min, max] does not meet the query tile's holds no pair of one segment and
// is never loaded (the producer tests 32 tiles at a time; a row's own tile
// always meets, so every row still sees itself). With the encoder's ids (real
// tokens 1, then pads 0) that drops the real-by-pad corners. A tile below S
// whose keys share one id is flagged UNIFORM: each row then sees all of it or
// none, and the mask costs one comparison per row instead of one per logit.
//
// bf16 (flash_bf16_kernel): operations bound it on paper (4 * B*NH*S^2*HD of
// them against four tensors moved once), and on this card only wgmma reaches
// the tensor cores' rate. Items are 128 query rows, one consumer warpgroup per
// 64 (wgmma's M), so each K/V tile crosses L2 once per 128 queries. S = Q K^T
// is wgmma m64n128k16 with Q and K read from shared memory (K-major); the
// accumulator fragments are scaled, masked and exponentiated in registers,
// packed to bf16 and become wgmma's register A operand of O += P V, whose B
// operand is the V tile read transposed from shared memory (N = HD, any
// multiple of 16 up to 128, so no padded width). Each warpgroup
// software-pipelines its tiles (P V of one tile runs on the tensor cores
// while the next tile's softmax runs on the CUDA cores) and the two
// warpgroups take turns to issue their products (named barriers), so one's
// softmax overlaps the other's products. That keeps o, the newest S and the
// previous P live at once: the producer is a whole warpgroup that hands its
// registers to the consumers (setmaxnreg, BfCfg). Tiles land by one TMA box
// each as slabs of 32-, 64- or 128-byte rows in TMA's swizzle, which wgmma
// reads as it is (box rows of 16 bytes made the loads the limit). What bounds
// it now is the loads and the epilogue: at hd = 128 a timing-only copy that
// multiplies nothing and skips the softmax keeps about 60% of the time
// (PERF.md section 6).
// f32 (flash_f32_kernel): the same skeleton, its products on the tensor cores
// in 3xTF32, since IEEE FMAs on the CUDA cores peak at 67 TFLOP/s. wgmma
// takes float32 only as TF32 (10 stored significand bits), so every operand
// x is cut into hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, round to
// nearest, ties away) and a product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi,
// the small terms first, summed in the float32 accumulator (a_lo b_lo, below
// 2^-22 |a| |b|, is dropped). The
// outputs land 3-5e-6 from a float64 attention at the encoder's shapes, where
// the IEEE plain version lands 1-2e-6 and the tests hold 2e-5. Three TF32
// products at 495 TFLOP/s bound it at 2.4x the CUDA cores' rate. The
// operands shape the rest of the design (F32Cfg): wgmma reads TF32 operands
// from shared memory K-major only, so V (keys x hd) must become V^T, and
// every operand needs its hi and lo. Three warps of the producer warpgroup
// (idle in bf16) write V^T's hi and lo, K's hi in place and its lo, per
// stage, before the consumers take it (a second barrier per stage); the
// consumers split Q once per item, its lo (and up to hd = 64 its hi) into
// registers (wgmma's register A operand); P goes from the S accumulator straight to the register A operand
// in hi and lo, V^T's keys stored in the order the fragments hold them.
// Shared memory decides the depth: four tiles of words a stage. What bounds
// it now is that pipeline, not the tensor cores: with no product and no
// softmax, the loads, the helpers' splitting and the hand-offs alone take
// half of its time at hd = 64 (PERF.md section 6).
//
// Layout: q, k, v share one set of element strides (batch, head, sequence;
// the last axis is contiguous), the output has its own, so (B, NH, S, HD) and
// (B, S, NH, HD) memory both work without a transposed copy. Rows must start
// on 16-byte boundaries. Any S >= 1; HD a multiple of 16 up to 128.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have
constexpr float MASK_VALUE = -2.3819763e38f;  // float32(-0.7 * float32 max)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// Meta::flags: first / last tile of its item; UNIFORM: the tile lies below S
// and all its keys have one segment id
constexpr int FIRST = 1, LAST = 2, UNIFORM = 4;

struct Strides {
    long long b, h, s;  // in elements
};

// what the producer tells the consumers about the tile in a stage
struct Meta {
    int n0;     // first key of the tile
    int flags;  // FIRST, LAST, UNIFORM
};

// Shared memory of one block, in bytes: NQ query slots of QB bytes, ST
// stages of K (KB bytes) and V (VB bytes) for tiles of KT keys, PB bytes of
// scratch (float32's per-stage "ready" barriers), the segment ids of a slot's BM queries and of a
// stage's KT keys, the
// stages' Meta and the mbarriers (full[ST], empty[ST], qempty[NQ]).
template <int QB, int NQ_, int ST_, int KB, int VB, int PB, int BM_, int KT_>
struct Layout {
    static constexpr int NQ = NQ_, ST = ST_, BM = BM_, KT = KT_;
    static constexpr int Q = 0;
    static constexpr int K = Q + NQ * QB;
    static constexpr int V = K + ST * KB;
    static constexpr int P = V + ST * VB;
    static constexpr int SEGQ = P + PB;
    static constexpr int SEGK = SEGQ + NQ * BM * 4;
    static constexpr int META = SEGK + ST * KT * 4;
    static constexpr int FULL = META + ST * 8;
    static constexpr int EMPTY = FULL + ST * 8;
    static constexpr int QEMPTY = EMPTY + ST * 8;
    static constexpr int BYTES = QEMPTY + NQ * 8;
    static_assert(META % 16 == 0, "barriers must be 8-byte aligned");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronous; zeros when !valid (src unread)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
// the mbarrier at bar receives one arrival when this thread's earlier
// cp.async copies have landed (counted in its expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// waits until the phase with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// 2^x on the special-function unit, one instruction; results below 2^-126
// (p of a key far below the row's maximum) flush to 0
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// [lo, hi] of the segment ids of rows first .. first + LEN - 1 below S
// (first < S); every lane of the calling warp gets both. Indices past S
// repeat row S - 1, which changes neither bound, so all loads are issued
// before the first is used.
template <int LEN>
__device__ __forceinline__ void seg_range(const int* __restrict__ segb, int first, int S,
                                          int lane, int& lo, int& hi) {
    int s[LEN / 32];
#pragma unroll
    for (int i = 0; i < LEN / 32; ++i) s[i] = segb[min(first + lane + 32 * i, S - 1)];
    lo = s[0];
    hi = s[0];
#pragma unroll
    for (int i = 1; i < LEN / 32; ++i) {
        lo = min(lo, s[i]);
        hi = max(hi, s[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
}

// Bit i of meet: key tile t0 + i (below ntiles) has segment ids that meet
// [qlo, qhi]; of uniform: it lies below S and holds one id. The warp reads
// four tiles of KT keys at a time, KT / 32 ids a lane each (indices past S
// repeat key S - 1, which lies in the last tile).
template <int KT>
__device__ __forceinline__ void tiles_meeting(const int* __restrict__ segb, int S, int ntiles,
                                              int t0, int qlo, int qhi, int lane,
                                              unsigned& meet, unsigned& uniform) {
    const int n = min(32, ntiles - t0);
    meet = 0;
    uniform = 0;
    for (int i = 0; i < n; i += 4) {
        int lo[4], hi[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int key = min(t0 + i + u, ntiles - 1) * KT + lane;
            lo[u] = INT_MAX;
            hi[u] = INT_MIN;
#pragma unroll
            for (int w = 0; w < KT; w += 32) {
                const int x = segb[min(key + w, S - 1)];
                lo[u] = min(lo[u], x);
                hi[u] = max(hi[u], x);
            }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                lo[u] = min(lo[u], __shfl_xor_sync(0xffffffffu, lo[u], off));
                hi[u] = max(hi[u], __shfl_xor_sync(0xffffffffu, hi[u], off));
            }
            const int t = t0 + i + u;
            if (i + u < n && !(hi[u] < qlo || lo[u] > qhi)) meet |= 1u << (i + u);
            if (i + u < n && lo[u] == hi[u] && (t + 1) * KT <= S) uniform |= 1u << (i + u);
        }
    }
}

// TMA: one box of a 5-d tensor map (see make_map) into shared memory at dst,
// completing on the mbarrier at bar. The box's rows start at row of the
// sequence; rows_inner says whether the sequence is dim 1 (the box lands as
// 16-byte columns of all its rows, one after the other) or dim 2 (row after
// row); hb_swap that batch is dim 3 and head dim 4.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int row, int h,
                                         int b, bool rows_inner, bool hb_swap, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(rows_inner ? row : 0),
           "r"(rows_inner ? 0 : row), "r"(hb_swap ? b : h), "r"(hb_swap ? h : b), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// The producer warp. Walks the block's items and their key tiles in the
// order the consumers take them: per item, finds the tiles to visit, waits
// for a free query slot and copies the queries' segment ids into it; per
// visited tile, waits for the next stage to be empty, writes its Meta, and
// lane 0 has TMA load K and V (load_kv), and Q into the slot with the item's
// first tile (load_q). A stage's full barrier completes when lane 0 has
// arrived with the bytes to expect and all 32 lanes' cp.async copies of the
// keys' segment ids have landed (33 arrivals).
template <class L, int TX = (L::P - L::K) / L::ST, class LoadQ, class LoadKV>
__device__ void produce(const int* __restrict__ seg, int S, int NH, int mtiles, int items,
                        uint32_t sbase, Meta* meta, LoadQ load_q, LoadKV load_kv) {
    const int lane = threadIdx.x & 31;
    const int ntiles = (S + L::KT - 1) / L::KT;
    int p = 0;  // tiles issued
    int j = 0;  // items begun
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
        const int bh = item / mtiles;
        const int m0 = (item - bh * mtiles) * L::BM;
        const int b = bh / NH;
        const int h = bh - b * NH;
        const int* segb = seg + (size_t)b * S;
        int qlo, qhi;
        seg_range<L::BM>(segb, m0, S, lane, qlo, qhi);
        int t0 = 0;
        unsigned mask, umask;
        tiles_meeting<L::KT>(segb, S, ntiles, 0, qlo, qhi, lane, mask, umask);

        const int slot = j % L::NQ;
        mbar_wait(sbase + L::QEMPTY + 8 * slot, ((j / L::NQ) & 1) ^ 1);
        for (int r = lane; r < L::BM; r += 32) {
            const bool ok = m0 + r < S;
            cp_async4(sbase + L::SEGQ + 4 * (slot * L::BM + r), segb + (ok ? m0 + r : 0), ok);
        }

        int flags = FIRST;
        while (true) {
            while (mask == 0 && t0 + 32 < ntiles) {
                t0 += 32;
                tiles_meeting<L::KT>(segb, S, ntiles, t0, qlo, qhi, lane, mask, umask);
            }
            if (mask == 0) break;  // not before the first tile: a row meets its own
            const int bit = __ffs(mask) - 1;
            const int n0 = (t0 + bit) * L::KT;
            if ((umask >> bit) & 1u) flags |= UNIFORM;
            mask &= mask - 1;
            while (mask == 0 && t0 + 32 < ntiles) {  // is this the item's last tile?
                t0 += 32;
                tiles_meeting<L::KT>(segb, S, ntiles, t0, qlo, qhi, lane, mask, umask);
            }
            if (mask == 0) flags |= LAST;

            const int st = p % L::ST;
            mbar_wait(sbase + L::EMPTY + 8 * st, ((p / L::ST) & 1) ^ 1);
            const uint32_t full = sbase + L::FULL + 8 * st;
            if (lane == 0) {
                meta[st] = Meta{n0, flags};
                mbar_expect_tx(full, TX + (flags & FIRST ? (L::K - L::Q) / L::NQ : 0));
                if (flags & FIRST) load_q(slot, b, h, m0, full);
                load_kv(st, b, h, n0, full);
            }
            for (int r = lane; r < L::KT; r += 32) {
                const bool ok = n0 + r < S;
                cp_async4(sbase + L::SEGK + 4 * (st * L::KT + r), segb + (ok ? n0 + r : 0), ok);
            }
            cp_async_arrive(full);
            ++p;
            if (flags & LAST) break;
            flags = 0;
        }
    }
}

// Every thread of the block calls this first: one thread sets up the
// barriers (full: 32 copy arrivals + lane 0's; empty, qempty: one per
// consumer warp).
template <class L>
__device__ __forceinline__ void init_barriers(uint32_t sbase, int consumer_warps) {
    if (threadIdx.x == 0) {
        for (int i = 0; i < L::ST; ++i) {
            mbar_init(sbase + L::FULL + 8 * i, 33);
            mbar_init(sbase + L::EMPTY + 8 * i, consumer_warps);
        }
        for (int i = 0; i < L::NQ; ++i) mbar_init(sbase + L::QEMPTY + 8 * i, consumer_warps);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
}

// A consumer warp is done with stage st (after __syncwarp, lane 0 arrives).
__device__ __forceinline__ void release(uint32_t bar) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

constexpr int CONSUMERS = 256;            // consumer threads: 8 warps

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BF_BM = 128;  // query rows per item: one consumer warpgroup per 64

// A tile of R rows x HD lands by one TMA box as slabs of rows of SPAN bytes
// (BfCfg), slab after slab, in TMA's swizzle of that span, which is also a
// wgmma operand layout: element (r, c) lies in slab c / (SPAN / 2), row r,
// column c % (SPAN / 2), before the swizzle.
constexpr int BF_KT = 128;  // keys per tile

template <int HD, int ST>
using BfLayoutST = Layout<BF_BM * HD * 2, 2, ST, BF_KT * HD * 2, BF_KT * HD * 2, 0, BF_BM, BF_KT>;
// as many stages as fit, at most four
template <int HD>
using BfLayout = BfLayoutST<HD, BfLayoutST<HD, 4>::BYTES <= SMEM_LIMIT ? 4
                                : BfLayoutST<HD, 3>::BYTES <= SMEM_LIMIT ? 3 : 2>;

// Registers. A consumer thread keeps o (HD / 2 floats), the newest tile's S
// (64) and the tile before's P (32 words) live across the pipeline; under the
// 168 registers a thread that a block of 288 threads leaves (it is charged as
// 384, whole warpgroups) that spilled (308 bytes at HD = 128, where ptxas
// also serialized the wgmma pipeline, C7512). So the producer is a whole
// warpgroup (384 threads): its warps give registers back with
// setmaxnreg.dec and the two consumer warpgroups take them with
// setmaxnreg.inc, 128 * 56 + 256 * 224 = 384 * 168 (at 40 the producer's own
// loop spilled); one of its warps loads, the other three leave.
// Tiles: slabs of the widest TMA swizzle whose row (SPAN bytes, SPAN / 2
// columns) divides HD.
template <int HD>
struct BfCfg {
    static constexpr int THREADS = CONSUMERS + 128;
    static constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
    static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 384 * 168,
                  "the register split exceeds what the block holds");
    static constexpr int SPAN = HD % 64 == 0 ? 128 : HD % 32 == 0 ? 64 : 32;
    static_assert(BF_BM * HD * 2 % 1024 == 0 && BF_KT * HD * 2 % 1024 == 0,
                  "tiles off the swizzle's 1024 bytes");
};

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// wgmma matrix descriptor in the swizzle of SPAN = 32, 64 or 128 bytes that
// TMA writes (slabs of rows of SPAN bytes), in 16-byte units: the start
// address; K-major, 8-row groups 8 SPAN bytes apart (stride byte offset),
// the leading byte offset unused, the start 32 bytes a k-step into a row;
// MN-major, 8-row groups along K 8 SPAN bytes apart, slabs along MN lbo
// apart (leading byte offset)
template <int SPAN>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
    constexpr uint64_t mode = SPAN == 128 ? 1 : SPAN == 64 ? 2 : 3;
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(8 * SPAN >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups of this warp are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Turns between the two consumer warpgroups: warpgroup w waits on named
// barrier 1 + w, which the other warpgroup's 128 threads arrive on.
__device__ __forceinline__ void take_turn(int wg) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - wg) : "memory");
}

// (lo, hi) rounded to nearest even, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&t);
}

// d (64 x N, float32) += A (64 x 16, shared) * B (16 x N, shared), both K-major
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
}

// d (64 x N, float32) += A (64 x 16, registers) * B (16 x N, shared, MN-major)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
        "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
        "%58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__global__ void __launch_bounds__(BfCfg<HD>::THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bool hb_swap, const int* __restrict__ seg,
                  uint16_t* __restrict__ out, float* __restrict__ lse, int NH, int S, Strides os,
                  float scale_log2,
                  int mtiles, int items)
{
    using Cfg = BfCfg<HD>;
    using L = BfLayout<HD>;
    constexpr int QB = BF_BM * HD * 2;   // bytes of a query slot
    constexpr int TB = BF_KT * HD * 2;   // bytes of a K or V tile
    constexpr int NT_O = HD / 8;         // 8-column chunks of the output
    constexpr int SPAN = Cfg::SPAN, KPS = SPAN / 32;  // k-steps of 16 columns a slab row
    // descriptors: Q and K K-major, k-step ks of an R-row tile; V MN-major,
    // the tile's keys 16 kk ..
    auto kdesc = [](uint32_t base, int R, int ks) {
        return smem_desc<SPAN>(base + (ks / KPS) * R * SPAN + (ks % KPS) * 32, 16);
    };
    auto vdesc = [](uint32_t base, int kk) {
        return smem_desc<SPAN>(base + kk * 16 * SPAN, BF_KT * SPAN);
    };
    extern __shared__ __align__(1024) unsigned char smem_1k[];  // the swizzles repeat every 1024 bytes
    unsigned char* smem = smem_1k;
    const uint32_t sbase = smem_u32(smem);
    if (sbase % 1024 != 0) __trap();
    Meta* meta = reinterpret_cast<Meta*>(smem + L::META);
    init_barriers<L>(sbase, CONSUMERS / 32);
    const int tid = threadIdx.x;
    const int lane = tid & 31;

    // One branch a role, never joined again: ptxas then knows each side's
    // register count from its setmaxnreg.
    if (tid >= CONSUMERS) {
        setmaxnreg_dec<Cfg::PRODUCER_REGS>();
        if (tid >= CONSUMERS + 32) return;
        auto load_q = [&](int slot, int b, int h, int m0, uint32_t bar) {
            tma_load(sbase + L::Q + slot * QB, &tq, m0, h, b, true, hb_swap, bar);
        };
        auto load_kv = [&](int st, int b, int h, int n0, uint32_t bar) {
            tma_load(sbase + L::K + st * TB, &tk, n0, h, b, true, hb_swap, bar);
            tma_load(sbase + L::V + st * TB, &tv, n0, h, b, true, hb_swap, bar);
        };
        produce<L>(seg, S, NH, mtiles, items, sbase, meta, load_q, load_kv);
        return;
    }
    setmaxnreg_inc<Cfg::CONSUMER_REGS>();

    const int warp = tid >> 5;
    const int wg = warp >> 2;  // consumer warpgroup: query rows 64 wg .. 64 wg + 63
    const int g = lane >> 2;   // fragment row
    const int t4 = lane & 3;
    const int row0 = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows: row0, row0 + 8
    if (wg == 1) pass_turn(1);  // warpgroup 0 issues first
    int p = 0;  // tiles taken
    int j = 0;  // items taken
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
        const int bh = item / mtiles;
        const int m0 = (item - bh * mtiles) * BF_BM;
        const int b = bh / NH;
        const int h = bh - b * NH;
        const int slot = j % L::NQ;
        const uint32_t q_sm = sbase + L::Q + slot * QB + wg * 64 * SPAN;  // this warpgroup's rows
        const int* segq_s = reinterpret_cast<const int*>(smem + L::SEGQ) + slot * BF_BM;

        int segq0 = 0, segq1 = 0;
        float mrow[2] = {-INFINITY, -INFINITY};
        float lrow[2] = {0.f, 0.f};
        float o[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
        float c[BF_KT / 2];       // S of the newest tile
        uint32_t pa[BF_KT / 16][4];  // P of the tile before, bf16: wgmma's A fragments

        // waits for the next stage and reads what the producer says of it
        auto next_tile = [&](int& st, int& n0, int& flags) {
            st = p % L::ST;
            mbar_wait(sbase + L::FULL + 8 * st, (p / L::ST) & 1);
            ++p;
            const Meta tile = meta[st];
            flags = tile.flags;
            n0 = tile.n0;
            if (flags & FIRST) {  // Q and the queries' ids landed with this tile
                segq0 = segq_s[row0];
                segq1 = segq_s[row0 + 8];
            }
        };
        // S = Q K^T of the tile in stage st, issued (not waited for)
        auto issue_qk = [&](int st) {
#pragma unroll
            for (int i = 0; i < BF_KT / 2; ++i) c[i] = 0.f;
            fence_regs(c);
            wgmma_fence();
            const uint32_t k_sm = sbase + L::K + st * TB;
#pragma unroll
            for (int ks = 0; ks < HD / 16; ++ks)
                wgmma_ss<BF_KT>(c, kdesc(q_sm, BF_BM, ks), kdesc(k_sm, BF_KT, ks));
            wgmma_commit();
        };
        // O += P V of the tile in stage st, issued (not waited for)
        auto issue_pv = [&](int st) {
            fence_regs(o);
            wgmma_fence();
            const uint32_t v_sm = sbase + L::V + st * TB;
#pragma unroll
            for (int kk = 0; kk < BF_KT / 16; ++kk)
                wgmma_rs<HD>(o, pa[kk], vdesc(v_sm, kk));
            wgmma_commit();
        };
        // S (in c, its product complete) of the keys n0 .. in stage st:
        // scale into the exp2 domain, mask, online softmax; c[4j + e] is
        // (row g, key 8j + 2 t4 + e), c[4j + 2 + e] row g + 8, and a row
        // lives in the 4 lanes of a quad. Returns the factors O must take.
        auto softmax = [&](int st, int n0, int flags, float (&alpha)[2]) {
            fence_regs(c);
            const int* segk = reinterpret_cast<const int*>(smem + L::SEGK) + st * BF_KT;
            float mx[2];
            if (flags & UNIFORM) {  // every key below S, one id: a row sees all or none
                const int id = segk[0];
                const bool vis[2] = {id == segq0, id == segq1};
#pragma unroll
                for (int i = 0; i < BF_KT / 2; ++i)
                    c[i] = vis[(i >> 1) & 1] ? c[i] * scale_log2 : MASK_VALUE;
            } else {
#pragma unroll
                for (int nt = 0; nt < BF_KT / 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = nt * 8 + 2 * t4 + e;
                        const bool seen = n0 + col < S;
                        const int sk = segk[col];
                        float& c0 = c[4 * nt + e];
                        float& c1 = c[4 * nt + 2 + e];
                        c0 = (seen && sk == segq0) ? c0 * scale_log2 : MASK_VALUE;
                        c1 = (seen && sk == segq1) ? c1 * scale_log2 : MASK_VALUE;
                    }
            }
            // row maxima and sums in four partial chains each (short
            // dependency chains; c[i] belongs to row (i >> 1) & 1)
            float part[2][4];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int u = 0; u < 4; ++u) part[hh][u] = -INFINITY;
#pragma unroll
            for (int i = 0; i < BF_KT / 2; ++i)
                part[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(part[(i >> 1) & 1][(i >> 2) & 3], c[i]);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
                mx[hh] = fmaxf(fmaxf(part[hh][0], part[hh][1]), fmaxf(part[hh][2], part[hh][3]));
            float sum[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
                mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
                const float mnew = fmaxf(mrow[hh], mx[hh]);  // finite: every s is
                alpha[hh] = fast_exp2(mrow[hh] - mnew);      // 0 while m is still -inf
                mrow[hh] = mnew;
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int u = 0; u < 4; ++u) part[hh][u] = 0.f;
#pragma unroll
            for (int i = 0; i < BF_KT / 2; ++i) {
                c[i] = fast_exp2(c[i] - mrow[(i >> 1) & 1]);
                part[(i >> 1) & 1][(i >> 2) & 3] += c[i];
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                sum[hh] = (part[hh][0] + part[hh][1]) + (part[hh][2] + part[hh][3]);
                sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
                sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
                lrow[hh] = lrow[hh] * alpha[hh] + sum[hh];
            }
        };
        // rescale O, then P (the accumulator fragments of two key chunks,
        // packed to bf16, are one register A fragment of 16 keys)
        auto rescale_pack = [&](const float (&alpha)[2]) {
            fence_regs(o);
#pragma unroll
            for (int nt = 0; nt < NT_O; ++nt) {
                o[4 * nt + 0] *= alpha[0];
                o[4 * nt + 1] *= alpha[0];
                o[4 * nt + 2] *= alpha[1];
                o[4 * nt + 3] *= alpha[1];
            }
#pragma unroll
            for (int kk = 0; kk < BF_KT / 16; ++kk) {
                pa[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
                pa[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
                pa[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
                pa[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
            }
        };

        // Software pipeline over the item's tiles: while the softmax of tile
        // i runs on the CUDA cores, the tensor cores do P V of tile i - 1.
        // The two warpgroups take turns to issue their products (named
        // barriers 1 and 2), so that one's softmax runs while the tensor
        // cores work for the other.
        const bool last_item = item + gridDim.x >= items;
        int st, n0, flags;
        float alpha[2];
        next_tile(st, n0, flags);
        take_turn(wg);
        issue_qk(st);
        pass_turn(wg);
        wgmma_wait<0>();
        softmax(st, n0, flags, alpha);
        rescale_pack(alpha);
        while (!(flags & LAST)) {
            const int prev = st;
            next_tile(st, n0, flags);
            take_turn(wg);
            issue_qk(st);
            issue_pv(prev);
            pass_turn(wg);
            wgmma_wait<1>();  // S of tile st; P V of prev may still run
            softmax(st, n0, flags, alpha);
            wgmma_wait<0>();
            release(sbase + L::EMPTY + 8 * prev);
            rescale_pack(alpha);
        }
        take_turn(wg);
        issue_pv(st);
        if (!(last_item && wg == 1)) pass_turn(wg);  // the very last turn is not passed on
        wgmma_wait<0>();
        fence_regs(o);
        release(sbase + L::EMPTY + 8 * st);

        // Epilogue: the rows, normalised and rounded once, are staged in the
        // bytes of the query slot that hold this warpgroup's own rows (64
        // rows of each slab; the other warpgroup may still be reading its
        // own), as 16-byte columns of those 64 rows, then leave as whole
        // 16-byte pieces, a warp writing whole rows.
        const float inv[2] = {1.f / lrow[0], 1.f / lrow[1]};
        if (lse != nullptr && t4 == 0) {  // the rows' log-sum-exp, for the backward
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = m0 + row0 + 8 * hh;
                if (r < S) lse[(size_t)bh * S + r] = mrow[hh] * LN2 + logf(lrow[hh]);
            }
        }
        constexpr int CPS = SPAN / 16;  // 16-byte columns a slab row
        unsigned char* stage = smem + L::Q + slot * QB + wg * 64 * SPAN;
        auto piece = [&](int ch, int r) {  // column ch (8 outputs) of the warpgroup's row r
            return stage + (ch / CPS) * BF_BM * SPAN + (ch % CPS) * 64 * 16 + r * 16;
        };
#pragma unroll
        for (int nt = 0; nt < NT_O; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<uint32_t*>(piece(nt, row0 - wg * 64 + 8 * hh) + t4 * 4) =
                    pack_bf16(o[4 * nt + 2 * hh] * inv[hh], o[4 * nt + 2 * hh + 1] * inv[hh]);
        asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wg) : "memory");  // this warpgroup
        uint16_t* ob = out + (size_t)b * os.b + (size_t)h * os.h;
        for (int idx = tid & 127; idx < 64 * NT_O; idx += 128) {
            const int r = idx / NT_O;  // the warpgroup's row
            const int ch = idx % NT_O;
            if (m0 + wg * 64 + r < S)
                *reinterpret_cast<uint4*>(ob + (size_t)(m0 + wg * 64 + r) * os.s + ch * 8) =
                    *reinterpret_cast<const uint4*>(piece(ch, r));
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before TMA reuses it
        release(sbase + L::QEMPTY + 8 * slot);
    }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int F32_BM = 128;  // query rows per item: one consumer warpgroup per 64

// The float32 kernel's skeleton is the bf16 kernel's (a producer warpgroup
// handing registers to two consumer warpgroups, the products taken in
// turns); what differs is the operands. wgmma reads TF32 operands from shared
// memory K-major only, as hi and lo TF32 words: Q and K land K-major (hd
// contiguous) by TMA, V lands the same way and is transposed. A stage holds
// K (rounded to hi in place), K's lo (whose bytes V lands in first), V^T's hi
// and V^T's lo; three warps of the producer warpgroup, idle in the bf16
// kernel, write them and arrive on the stage's "ready" barrier (in the
// Layout's scratch bytes), which the consumers wait on. The consumers split Q
// once per item: its lo stays in registers (wgmma's register A operand) and,
// up to hd = 64, its hi too, so every product of S reads only K from shared
// memory and the query slot is free again at once; above, Q's hi is rounded
// in place in its slot. Shared memory is the budget: four words of a tile a
// stage. Tiles of KT keys, 64 up to hd = 64 and 32 above; as many stages as
// fit with one query slot (at most four; more stages were the largest gain,
// PERF.md section 6), then a second slot if it fits.
// Slabs: rows of SPAN bytes, the widest TMA swizzle dividing a row's 4 HD
// bytes (twice bf16's span, at most 128); V^T's rows are KT keys, 128-byte slabs.
template <int HD>
struct F32Cfg {
    static constexpr int THREADS = CONSUMERS + 128;
    // above hd = 64, o and Q's lo take 64 registers each: the consumers need
    // 232 (at 224 ptxas spilled 36 bytes at hd = 128) and the helpers do with
    // 40; up to hd = 64 the helpers need 56 (at 40 they spilled 12 bytes)
    static constexpr int PRODUCER_REGS = HD > 64 ? 40 : 56;
    static constexpr int CONSUMER_REGS = HD > 64 ? 232 : 224;
    static_assert(128 * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= 384 * 168,
                  "the register split exceeds what the block holds");
    static constexpr int KT = HD <= 64 ? 64 : 32;          // keys per tile
    static constexpr int SPAN = HD % 32 == 0 ? 128 : 64;   // bytes of a Q / K / V slab row
    static constexpr int QB = F32_BM * HD * 4;             // a query slot
    static constexpr int TB = KT * HD * 4;                 // a tile of K, V or one of their words
    static constexpr int TX = 2 * TB;                      // bytes TMA lands in a stage: K and V
    static constexpr int HELPERS = 96;                     // the producer warpgroup's other warps
    static constexpr bool Q_IN_REGS = HD <= 64;            // Q's hi in registers too
    // per stage: K (hi after the helpers), K lo (V lands there first) | V^T
    // hi, V^T lo; 64 scratch bytes hold the stages' ready barriers
    template <int NQ_, int ST_>
    using L = Layout<QB, NQ_, ST_, 2 * TB, 2 * TB, 64, F32_BM, KT>;
    static constexpr int ST = L<1, 4>::BYTES <= SMEM_LIMIT ? 4 : L<1, 3>::BYTES <= SMEM_LIMIT ? 3 : 2;
    static constexpr int NQ = L<2, ST>::BYTES <= SMEM_LIMIT ? 2 : 1;
    using Lay = L<NQ, ST>;
    static_assert(Lay::BYTES <= SMEM_LIMIT, "f32 shared memory above the block limit");
    static_assert(ST * 8 <= 64, "the ready barriers overflow their scratch bytes");
    static_assert(QB % 1024 == 0 && TB % 1024 == 0 && HD * 128 % 1024 == 0,
                  "tiles off the swizzle's 1024 bytes");
};

// x rounded to the nearest TF32 value, ties away from zero (its 13 low bits 0)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
    uint32_t y;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
    return y;
}
// hi = tf32(x) and lo = tf32(x - hi): x - hi is exact, hi + lo keeps about 21 bits
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
    uint32_t u, w;
    tf32_split(x.x, u, w); hi.x = __uint_as_float(u); lo.x = __uint_as_float(w);
    tf32_split(x.y, u, w); hi.y = __uint_as_float(u); lo.y = __uint_as_float(w);
    tf32_split(x.z, u, w); hi.z = __uint_as_float(u); lo.z = __uint_as_float(w);
    tf32_split(x.w, u, w); hi.w = __uint_as_float(u); lo.w = __uint_as_float(w);
}

// byte offset, within a 1024-byte-aligned region, of offset off in the TMA /
// wgmma swizzle of SPAN-byte rows (16-byte chunks XOR the 128-byte line's index)
template <int SPAN>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
    return off ^ (((off >> 7) & (SPAN / 16 - 1)) << 4);
}

// d (64 x N, float32) += A (64 x 8 TF32) * B (8 x N TF32), B K-major in shared
// memory; A K-major in shared memory (ss) or wgmma's register fragment (rs)
template <int N>
struct Tf32Mma;

#define TF32_MMA(N, R, DLIST, A0, A1, A2, A3, A4, A5, ...)                                      \
    template <>                                                                                 \
    struct Tf32Mma<N> {                                                                         \
        static __device__ __forceinline__ void ss(float (&d)[R], uint64_t da, uint64_t db) {   \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" A2 ", 0;\n"                       \
                         "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" DLIST     \
                         "}, %" A0 ", %" A1 ", p, 1, 1;\n}\n"                                   \
                         : __VA_ARGS__ : "l"(da), "l"(db), "r"(1));                             \
        }                                                                                       \
        static __device__ __forceinline__ void rs(float (&d)[R], const uint32_t (&a)[4],       \
                                                  uint64_t db) {                                \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" A5 ", 0;\n"                       \
                         "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" DLIST     \
                         "}, {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" A4 ", p, 1, 1;\n}\n"      \
                         : __VA_ARGS__                                                          \
                         : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));        \
        }                                                                                       \
    };

#define TF32_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                   "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TF32_L8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define TF32_L16 TF32_L8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define TF32_L24 TF32_L16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define TF32_L32 TF32_L24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define TF32_L40 TF32_L32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define TF32_L48 TF32_L40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define TF32_L56 TF32_L48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define TF32_L64 TF32_L56 ", %56, %57, %58, %59, %60, %61, %62, %63"

TF32_MMA(16, 8, TF32_L8, "8", "9", "10", "11", "12", "13", TF32_D8(0))
TF32_MMA(32, 16, TF32_L16, "16", "17", "18", "19", "20", "21", TF32_D8(0), TF32_D8(8))
TF32_MMA(48, 24, TF32_L24, "24", "25", "26", "27", "28", "29", TF32_D8(0), TF32_D8(8),
         TF32_D8(16))
TF32_MMA(64, 32, TF32_L32, "32", "33", "34", "35", "36", "37", TF32_D8(0), TF32_D8(8),
         TF32_D8(16), TF32_D8(24))
TF32_MMA(80, 40, TF32_L40, "40", "41", "42", "43", "44", "45", TF32_D8(0), TF32_D8(8),
         TF32_D8(16), TF32_D8(24), TF32_D8(32))
TF32_MMA(96, 48, TF32_L48, "48", "49", "50", "51", "52", "53", TF32_D8(0), TF32_D8(8),
         TF32_D8(16), TF32_D8(24), TF32_D8(32), TF32_D8(40))
TF32_MMA(112, 56, TF32_L56, "56", "57", "58", "59", "60", "61", TF32_D8(0), TF32_D8(8),
         TF32_D8(16), TF32_D8(24), TF32_D8(32), TF32_D8(40), TF32_D8(48))
TF32_MMA(128, 64, TF32_L64, "64", "65", "66", "67", "68", "69", TF32_D8(0), TF32_D8(8),
         TF32_D8(16), TF32_D8(24), TF32_D8(32), TF32_D8(40), TF32_D8(48), TF32_D8(56))

#undef TF32_MMA
#undef TF32_D8

// The helpers' work on stage st once its K and V have landed (helper h of
// HELPERS): V (keys x HD, landed in K lo's bytes) becomes V^T (HD rows of KT
// keys, 128-byte slabs) in hi and lo; then K is rounded to hi in place and
// its lo written over V. Within every 8 keys V^T holds keys 0, 2, 4, 6, 1, 3,
// 5, 7: a consumer lane's S accumulator holds keys (2t, 2t + 1) of each 8,
// and wgmma's TF32 register fragment of P takes key columns (t, t + 4), so P
// goes to wgmma as it lies and V^T's key order follows it. A unit of V is 8
// keys x 4 columns: even keys, then odd ones.
template <int HD>
__device__ __forceinline__ void split_stage(unsigned char* stage_k, unsigned char* stage_vt,
                                            int h) {
    using C = F32Cfg<HD>;
    constexpr int TB = C::TB, KT = C::KT, SPAN = C::SPAN, CPS = SPAN / 16;
    const unsigned char* v = stage_k + TB;
    for (int u = h; u < (KT / 8) * (HD / 4); u += C::HELPERS) {
        const int kg = u / (HD / 4);  // keys 8 kg ..
        const int cj = u % (HD / 4);  // columns 4 cj ..
        const uint32_t vcol = (cj / CPS) * (KT * SPAN) + (cj % CPS) * 16;
#pragma unroll
        for (int odd = 0; odd < 2; ++odd) {
            float4 x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                x[e] = *reinterpret_cast<const float4*>(
                    v + swz<SPAN>(vcol + (8 * kg + 2 * e + odd) * SPAN));
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const int c = 4 * cj + cc;
                const uint32_t off = swz<128>((kg / 4) * (HD * 128) + c * 128 +
                                              (2 * (kg % 4) + odd) * 16);
                const float* col = &x[0].x + cc;  // x[e] component cc
                float4 hi, lo;
                split4(make_float4(col[0], col[4], col[8], col[12]), hi, lo);
                *reinterpret_cast<float4*>(stage_vt + off) = hi;
                *reinterpret_cast<float4*>(stage_vt + TB + off) = lo;
            }
        }
    }
    asm volatile("bar.sync 5, %0;\n" :: "n"(C::HELPERS) : "memory");  // V is read: K lo may land on it
    for (int i = h; i < TB / 16; i += 2 * C::HELPERS) {  // two loads in flight a helper
        const int j = i + C::HELPERS < TB / 16 ? i + C::HELPERS : i;
        float4* k = reinterpret_cast<float4*>(stage_k);
        const float4 x0 = k[i], x1 = k[j];
        float4 hi0, lo0, hi1, lo1;
        split4(x0, hi0, lo0);
        split4(x1, hi1, lo1);
        k[i] = hi0;
        reinterpret_cast<float4*>(stage_k + TB)[i] = lo0;
        k[j] = hi1;
        reinterpret_cast<float4*>(stage_k + TB)[j] = lo1;
    }
}

template <int HD>
__global__ void __launch_bounds__(F32Cfg<HD>::THREADS, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bool hb_swap, const int* __restrict__ seg,
                 float* __restrict__ out, float* __restrict__ lse, int NH, int S, Strides os,
                 float scale_log2,
                 int mtiles, int items)
{
    using C = F32Cfg<HD>;
    using L = typename C::Lay;
    constexpr int KT = C::KT, TB = C::TB, QB = C::QB;
    constexpr int NT_O = HD / 8;                      // 8-column chunks of the output
    constexpr int SPAN = C::SPAN, KPS = SPAN / 32;    // k-steps of 8 floats a slab row
    // descriptors: a K-major tile of R rows in SPAN slabs, k-step ks; V^T
    // (HD rows of KT keys in 128-byte slabs), k-step kk
    auto kdesc = [](uint32_t base, int R, int ks) {
        return smem_desc<SPAN>(base + (ks / KPS) * R * SPAN + (ks % KPS) * 32, 16);
    };
    auto vdesc = [](uint32_t base, int kk) {
        return smem_desc<128>(base + (kk / 4) * HD * 128 + (kk % 4) * 32, 16);
    };
    extern __shared__ __align__(1024) unsigned char smem_1k[];  // the swizzles repeat every 1024 bytes
    unsigned char* smem = smem_1k;
    const uint32_t sbase = smem_u32(smem);
    if (sbase % 1024 != 0) __trap();
    Meta* meta = reinterpret_cast<Meta*>(smem + L::META);
    const uint32_t ready = sbase + L::P;  // the stages' ready barriers: one arrival a helper warp
    if (threadIdx.x == 0)
        for (int i = 0; i < L::ST; ++i) mbar_init(ready + 8 * i, C::HELPERS / 32);
    init_barriers<L>(sbase, CONSUMERS / 32);
    const int tid = threadIdx.x;
    const int lane = tid & 31;

    // One branch a role, never joined again: ptxas then knows each side's
    // register count from its setmaxnreg.
    if (tid >= CONSUMERS) {
        setmaxnreg_dec<C::PRODUCER_REGS>();
        if (tid < CONSUMERS + 32) {
            auto load_q = [&](int slot, int b, int h, int m0, uint32_t bar) {
                tma_load(sbase + L::Q + slot * QB, &tq, m0, h, b, true, hb_swap, bar);
            };
            auto load_kv = [&](int st, int b, int h, int n0, uint32_t bar) {
                tma_load(sbase + L::K + st * 2 * TB, &tk, n0, h, b, true, hb_swap, bar);
                tma_load(sbase + L::K + st * 2 * TB + TB, &tv, n0, h, b, true, hb_swap, bar);
            };
            produce<L, C::TX>(seg, S, NH, mtiles, items, sbase, meta, load_q, load_kv);
            return;
        }
        // the helpers take the stages in the consumers' order
        int p = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            int flags;
            do {
                const int st = p % L::ST;
                mbar_wait(sbase + L::FULL + 8 * st, (p / L::ST) & 1);
                flags = meta[st].flags;
                split_stage<HD>(smem + L::K + st * 2 * TB, smem + L::V + st * 2 * TB,
                                tid - CONSUMERS - 32);
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before wgmma reads
                release(ready + 8 * st);
                ++p;
            } while (!(flags & LAST));
        }
        return;
    }
    setmaxnreg_inc<C::CONSUMER_REGS>();

    const int warp = tid >> 5;
    const int wg = warp >> 2;  // consumer warpgroup: query rows 64 wg .. 64 wg + 63
    const int g = lane >> 2;   // fragment row
    const int t4 = lane & 3;
    const int row0 = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows: row0, row0 + 8
    if (wg == 1) pass_turn(1);  // warpgroup 0 issues first
    int p = 0;  // tiles taken
    int j = 0;  // items taken
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
        const int slot = j % L::NQ;
        unsigned char* q_slot = smem + L::Q + slot * QB;
        const uint32_t q_sm = sbase + L::Q + slot * QB + wg * 64 * SPAN;  // this warpgroup's rows
        const int* segq_s = reinterpret_cast<const int*>(smem + L::SEGQ) + slot * F32_BM;

        int segq0 = 0, segq1 = 0;
        float mrow[2] = {-INFINITY, -INFINITY};
        float lrow[2] = {0.f, 0.f};
        float o[HD / 2];
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
        float c[KT / 2];                 // S of the newest tile
        constexpr bool QR = C::Q_IN_REGS;
        uint32_t qlo[HD / 8][4];         // Q's lo words: wgmma's A fragments, k-step by k-step
        uint32_t qhi[HD / 8][4];         // and its hi words, up to hd = 64
        uint32_t phi[KT / 8][4], plo[KT / 8][4];  // P of the tile before, hi and lo

        // Q's lo into qlo and its hi into qhi, or in place above hd = 64:
        // element (row, 8 ks + t4 + 4 (e >> 1)) of row = row0 + 8 (e & 1), as
        // wgmma's TF32 fragment holds it
        auto split_q = [&]() {
#pragma unroll
            for (int ks = 0; ks < HD / 8; ++ks)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int r = row0 + 8 * (e & 1);
                    const int col = 8 * ks + t4 + 4 * (e >> 1);
                    float* x = reinterpret_cast<float*>(
                        q_slot + swz<SPAN>((col / (SPAN / 4)) * (F32_BM * SPAN) + r * SPAN +
                                           (col % (SPAN / 4)) * 4));
                    uint32_t hi;
                    tf32_split(*x, hi, qlo[ks][e]);
                    if constexpr (QR) qhi[ks][e] = hi;
                    else *x = __uint_as_float(hi);
                }
            if constexpr (QR) {
                release(sbase + L::QEMPTY + 8 * slot);  // all of Q is in registers
            } else {
                asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before wgmma reads
                asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wg) : "memory");  // this warpgroup
            }
        };
        // waits for the next stage and reads what the producer says of it
        auto next_tile = [&](int& st, int& n0, int& flags) {
            st = p % L::ST;
            mbar_wait(sbase + L::FULL + 8 * st, (p / L::ST) & 1);
            mbar_wait(ready + 8 * st, (p / L::ST) & 1);
            ++p;
            const Meta tile = meta[st];
            flags = tile.flags;
            n0 = tile.n0;
            if (flags & FIRST) {  // Q and the queries' ids landed with this tile
                segq0 = segq_s[row0];
                segq1 = segq_s[row0 + 8];
                split_q();
            }
        };
        // S = Q K^T of the tile in stage st, issued (not waited for): the
        // small products first, Q_lo K_hi + Q_hi K_lo, then Q_hi K_hi
        auto issue_qk = [&](int st) {
#pragma unroll
            for (int i = 0; i < KT / 2; ++i) c[i] = 0.f;
            fence_regs(c);
            wgmma_fence();
            const uint32_t k_hi = sbase + L::K + st * 2 * TB;
#pragma unroll
            for (int ks = 0; ks < HD / 8; ++ks)
                Tf32Mma<KT>::rs(c, qlo[ks], kdesc(k_hi, KT, ks));
            if constexpr (QR) {
#pragma unroll
                for (int ks = 0; ks < HD / 8; ++ks)
                    Tf32Mma<KT>::rs(c, qhi[ks], kdesc(k_hi + TB, KT, ks));
#pragma unroll
                for (int ks = 0; ks < HD / 8; ++ks)
                    Tf32Mma<KT>::rs(c, qhi[ks], kdesc(k_hi, KT, ks));
            } else {
#pragma unroll
                for (int ks = 0; ks < HD / 8; ++ks)
                    Tf32Mma<KT>::ss(c, kdesc(q_sm, F32_BM, ks), kdesc(k_hi + TB, KT, ks));
#pragma unroll
                for (int ks = 0; ks < HD / 8; ++ks)
                    Tf32Mma<KT>::ss(c, kdesc(q_sm, F32_BM, ks), kdesc(k_hi, KT, ks));
            }
            wgmma_commit();
        };
        // O += P V of the tile in stage st, issued (not waited for): P_lo V_hi
        // + P_hi V_lo, then P_hi V_hi
        auto issue_pv = [&](int st) {
            fence_regs(o);
            wgmma_fence();
            const uint32_t vt_hi = sbase + L::V + st * 2 * TB;
#pragma unroll
            for (int kk = 0; kk < KT / 8; ++kk) Tf32Mma<HD>::rs(o, plo[kk], vdesc(vt_hi, kk));
#pragma unroll
            for (int kk = 0; kk < KT / 8; ++kk) Tf32Mma<HD>::rs(o, phi[kk], vdesc(vt_hi + TB, kk));
#pragma unroll
            for (int kk = 0; kk < KT / 8; ++kk) Tf32Mma<HD>::rs(o, phi[kk], vdesc(vt_hi, kk));
            wgmma_commit();
        };
        // S (in c, its product complete) of the keys n0 .. in stage st:
        // scale into the exp2 domain, mask, online softmax; c[4j + e] is
        // (row g, key 8j + 2 t4 + e), c[4j + 2 + e] row g + 8, and a row
        // lives in the 4 lanes of a quad. Returns the factors O must take.
        auto softmax = [&](int st, int n0, int flags, float (&alpha)[2]) {
            fence_regs(c);
            const int* segk = reinterpret_cast<const int*>(smem + L::SEGK) + st * KT;
            float mx[2];
            if (flags & UNIFORM) {  // every key below S, one id: a row sees all or none
                const int id = segk[0];
                const bool vis[2] = {id == segq0, id == segq1};
#pragma unroll
                for (int i = 0; i < KT / 2; ++i)
                    c[i] = vis[(i >> 1) & 1] ? c[i] * scale_log2 : MASK_VALUE;
            } else {
#pragma unroll
                for (int nt = 0; nt < KT / 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = nt * 8 + 2 * t4 + e;
                        const bool seen = n0 + col < S;
                        const int sk = segk[col];
                        float& c0 = c[4 * nt + e];
                        float& c1 = c[4 * nt + 2 + e];
                        c0 = (seen && sk == segq0) ? c0 * scale_log2 : MASK_VALUE;
                        c1 = (seen && sk == segq1) ? c1 * scale_log2 : MASK_VALUE;
                    }
            }
            // row maxima and sums in four partial chains each (c[i] belongs
            // to row (i >> 1) & 1)
            float part[2][4];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int u = 0; u < 4; ++u) part[hh][u] = -INFINITY;
#pragma unroll
            for (int i = 0; i < KT / 2; ++i)
                part[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(part[(i >> 1) & 1][(i >> 2) & 3], c[i]);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
                mx[hh] = fmaxf(fmaxf(part[hh][0], part[hh][1]), fmaxf(part[hh][2], part[hh][3]));
            float sum[2];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
                mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
                const float mnew = fmaxf(mrow[hh], mx[hh]);  // finite: every s is
                alpha[hh] = fast_exp2(mrow[hh] - mnew);      // 0 while m is still -inf
                mrow[hh] = mnew;
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int u = 0; u < 4; ++u) part[hh][u] = 0.f;
#pragma unroll
            for (int i = 0; i < KT / 2; ++i) {
                c[i] = fast_exp2(c[i] - mrow[(i >> 1) & 1]);
                part[(i >> 1) & 1][(i >> 2) & 3] += c[i];
            }
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                sum[hh] = (part[hh][0] + part[hh][1]) + (part[hh][2] + part[hh][3]);
                sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
                sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
                lrow[hh] = lrow[hh] * alpha[hh] + sum[hh];
            }
        };
        // rescale O, then split P: the register fragment of keys 8 kk .. takes
        // (row g, key 2 t4), (g + 8, 2 t4), (g, 2 t4 + 1), (g + 8, 2 t4 + 1)
        // as its (t4, t4, t4 + 4, t4 + 4) columns, the order V^T is stored in
        auto rescale_split = [&](const float (&alpha)[2]) {
            fence_regs(o);
#pragma unroll
            for (int nt = 0; nt < NT_O; ++nt) {
                o[4 * nt + 0] *= alpha[0];
                o[4 * nt + 1] *= alpha[0];
                o[4 * nt + 2] *= alpha[1];
                o[4 * nt + 3] *= alpha[1];
            }
#pragma unroll
            for (int kk = 0; kk < KT / 8; ++kk) {
                tf32_split(c[4 * kk + 0], phi[kk][0], plo[kk][0]);
                tf32_split(c[4 * kk + 2], phi[kk][1], plo[kk][1]);
                tf32_split(c[4 * kk + 1], phi[kk][2], plo[kk][2]);
                tf32_split(c[4 * kk + 3], phi[kk][3], plo[kk][3]);
            }
        };

        // Software pipeline over the item's tiles, as in the bf16 kernel:
        // while the softmax of tile i runs on the CUDA cores, the tensor cores
        // do P V of tile i - 1, and the two warpgroups take turns to issue.
        int st, n0, flags;
        float alpha[2];
        next_tile(st, n0, flags);
        take_turn(wg);
        issue_qk(st);
        pass_turn(wg);
        wgmma_wait<0>();
        softmax(st, n0, flags, alpha);
        rescale_split(alpha);
        while (!(flags & LAST)) {
            const int prev = st;
            next_tile(st, n0, flags);
            take_turn(wg);
            issue_qk(st);
            issue_pv(prev);
            pass_turn(wg);
            wgmma_wait<1>();  // S of tile st; P V of prev may still run
            softmax(st, n0, flags, alpha);
            wgmma_wait<0>();
            release(sbase + L::EMPTY + 8 * prev);
            rescale_split(alpha);
        }
        take_turn(wg);
        issue_pv(st);
        const bool last_item = item + gridDim.x >= items;
        if (!(last_item && wg == 1)) pass_turn(wg);  // the very last turn is not passed on
        wgmma_wait<0>();
        fence_regs(o);
        release(sbase + L::EMPTY + 8 * st);

        // Epilogue (the item's coordinates found again here, not kept in
        // registers through the loop): a quad writes 32 bytes of each of its
        // two rows per 8-column chunk, so a warp's store fills whole 32-byte
        // sectors
        const int bh = item / mtiles;
        const int m0 = (item - bh * mtiles) * F32_BM;
        const int b = bh / NH;
        const int h = bh - b * NH;
        const float inv[2] = {1.f / lrow[0], 1.f / lrow[1]};
        float* ob = out + (size_t)b * os.b + (size_t)h * os.h;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int r = m0 + row0 + 8 * hh;
            if (r >= S) continue;
            // the row's log-sum-exp of the natural-domain logits, for the backward
            if (lse != nullptr && t4 == 0) lse[(size_t)bh * S + r] = mrow[hh] * LN2 + logf(lrow[hh]);
            float* orow = ob + (size_t)r * os.s + 2 * t4;
#pragma unroll
            for (int nt = 0; nt < NT_O; ++nt)
                *reinterpret_cast<float2*>(orow + 8 * nt) =
                    make_float2(o[4 * nt + 2 * hh] * inv[hh], o[4 * nt + 2 * hh + 1] * inv[hh]);
        }
        if constexpr (!QR) release(sbase + L::QEMPTY + 8 * slot);  // fenced in split_q
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Problem {
    const void *q, *k, *v;
    const int* seg;
    void* out;
    float* lse;  // (B, NH, S) row log-sum-exp, or null
    int B, NH, S;
    Strides in, os;
    float sm_scale;
    cudaStream_t stream;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (so the
// library needs no -lcuda)
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
                cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// Errors of the host setup, beside the cudaError values the launch returns.
constexpr int ERR_NO_ENCODER = 10001;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 10002;      // a tensor map was refused

// A 5-d tensor map over q, k or v, whose boxes are rows rows of the sequence
// from row on, every element of them. Dim 0 is a slab's part of a row (chunk
// elements: 16 bytes, or span bytes in the swizzle of that span); dims 1 and
// 2 are the sequence (stride in.s) and the row's slabs, in that order when
// rows_inner (the box lands slab by slab) or the other way round (row by
// row); dims 3 and 4 are head and batch, the smaller stride first (hb_swap:
// batch first). Rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, bool bf16, const Problem& p, int HD, int rows,
             bool rows_inner, bool& hb_swap, int span = 0) {
    EncodeTiled encode = encoder();
    if (encode == nullptr) return ERR_NO_ENCODER;
    const int esize = bf16 ? 2 : 4;
    const int chunk = (span ? span : 16) / esize;
    hb_swap = p.in.b < p.in.h;
    const long long hs = hb_swap ? p.in.b : p.in.h, bs = hb_swap ? p.in.h : p.in.b;
    const int hn = hb_swap ? p.B : p.NH, bn = hb_swap ? p.NH : p.B;
    const cuuint64_t seq[2] = {static_cast<cuuint64_t>(p.S), static_cast<cuuint64_t>(p.in.s) * esize};
    const cuuint64_t col[2] = {static_cast<cuuint64_t>(HD / chunk),
                               static_cast<cuuint64_t>(chunk) * esize};
    const cuuint64_t* d1 = rows_inner ? seq : col;
    const cuuint64_t* d2 = rows_inner ? col : seq;
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(chunk), d1[0], d2[0],
                                static_cast<cuuint64_t>(hn), static_cast<cuuint64_t>(bn)};
    const cuuint64_t strides[4] = {d1[1], d2[1], static_cast<cuuint64_t>(hs) * esize,
                                   static_cast<cuuint64_t>(bs) * esize};
    const cuuint32_t r = static_cast<cuuint32_t>(rows), c = static_cast<cuuint32_t>(HD / chunk);
    const cuuint32_t box[5] = {static_cast<cuuint32_t>(chunk), rows_inner ? r : c,
                               rows_inner ? c : r, 1, 1};
    const cuuint32_t one[5] = {1, 1, 1, 1, 1};
    const CUresult res = encode(
        map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5,
        const_cast<void*>(ptr), dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
        span == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : span == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
        : span == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// Items (B * NH * ceil(S / bm)) and persistent blocks (as many as the SMs
// hold, at most one per item) for a kernel of threads threads with smem bytes
// of shared memory. The shared-memory attribute and the blocks the card holds
// are set up once per device and kernel (the host calls cost more than a
// launch): resident is the kernel's own table, by device. A kernel whose
// warpgroups trade registers (setmaxnreg) needs regs of them in all: a block
// that starts with fewer would wait forever, so it is refused.
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
int plan(const Problem& p, Kernel* kernel, int smem, int bm, int threads, int regs,
         int (&resident)[MAX_DEVICES], int& mtiles, int& items, int& blocks) {
    if (p.B <= 0 || p.NH <= 0 || p.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
    mtiles = (p.S + bm - 1) / bm;
    const long long n = (long long)p.B * p.NH * mtiles;
    if (n > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    items = static_cast<int>(n);
    int dev;
    if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
    if (dev < 0 || dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[dev] == 0) {
        if (smem > 48 * 1024) {
            if (cudaError_t e = cudaFuncSetAttribute(
                    kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
                return static_cast<int>(e);
        }
        cudaFuncAttributes attr;
        if (cudaError_t e = cudaFuncGetAttributes(&attr, kernel)) return static_cast<int>(e);
        if (attr.numRegs * threads < regs) return static_cast<int>(cudaErrorInvalidConfiguration);
        int sms, per_sm;
        if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
            return static_cast<int>(e);
        if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                          threads, smem))
            return static_cast<int>(e);
        if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        resident[dev] = sms * per_sm;
    }
    blocks = items < resident[dev] ? items : resident[dev];
    return 0;
}

template <int HD>
int launch_f32(const Problem& p) {
    using C = F32Cfg<HD>;
    constexpr int smem = C::Lay::BYTES;
    int mtiles, items, blocks;
    bool hb_swap;
    static int resident[MAX_DEVICES];  // blocks the card holds at once; 0 = not set up
    constexpr int regs = 128 * C::PRODUCER_REGS + CONSUMERS * C::CONSUMER_REGS;
    if (int e = plan(p, flash_f32_kernel<HD>, smem, F32_BM, C::THREADS, regs, resident, mtiles,
                     items, blocks))
        return e;
    CUtensorMap tq, tk, tv;
    if (int e = make_map(&tq, p.q, false, p, HD, F32_BM, true, hb_swap, C::SPAN)) return e;
    if (int e = make_map(&tk, p.k, false, p, HD, C::KT, true, hb_swap, C::SPAN)) return e;
    if (int e = make_map(&tv, p.v, false, p, HD, C::KT, true, hb_swap, C::SPAN)) return e;
    flash_f32_kernel<HD><<<blocks, C::THREADS, smem, p.stream>>>(
        tq, tk, tv, hb_swap, p.seg, static_cast<float*>(p.out), p.lse, p.NH, p.S, p.os,
        p.sm_scale * LOG2E, mtiles, items);
    return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const Problem& p) {
    constexpr int smem = BfLayout<HD>::BYTES;
    static_assert(smem <= SMEM_LIMIT, "bf16 shared memory above the block limit");
    int mtiles, items, blocks;
    bool hb_swap;
    static int resident[MAX_DEVICES];  // blocks the card holds at once; 0 = not set up
    using Cfg = BfCfg<HD>;
    constexpr int regs = 128 * Cfg::PRODUCER_REGS + CONSUMERS * Cfg::CONSUMER_REGS;
    if (int e = plan(p, flash_bf16_kernel<HD>, smem, BF_BM, Cfg::THREADS, regs, resident, mtiles,
                     items, blocks))
        return e;
    CUtensorMap tq, tk, tv;
    if (int e = make_map(&tq, p.q, true, p, HD, BF_BM, true, hb_swap, Cfg::SPAN)) return e;
    if (int e = make_map(&tk, p.k, true, p, HD, BF_KT, true, hb_swap, Cfg::SPAN)) return e;
    if (int e = make_map(&tv, p.v, true, p, HD, BF_KT, true, hb_swap, Cfg::SPAN)) return e;
    flash_bf16_kernel<HD><<<blocks, Cfg::THREADS, smem, p.stream>>>(
        tq, tk, tv, hb_swap, p.seg, static_cast<uint16_t*>(p.out), p.lse, p.NH, p.S, p.os,
        p.sm_scale * LOG2E, mtiles, items);
    return static_cast<int>(cudaGetLastError());
}

template <bool IS_BF16>
int dispatch(const Problem& p, int HD) {
#define FLASH_CASE(N) \
    case N: return IS_BF16 ? launch_bf16<N>(p) : launch_f32<N>(p);
    switch (HD) {
        FLASH_CASE(16) FLASH_CASE(32) FLASH_CASE(48) FLASH_CASE(64)
        FLASH_CASE(80) FLASH_CASE(96) FLASH_CASE(112) FLASH_CASE(128)
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FLASH_CASE
}

}  // namespace

// q, k, v: element (b, h, s, d) at b*in_b + h*in_h + s*in_s + d; out likewise
// with the out_* strides; seg (B, S) int32, contiguous. Strides in elements.
// Returns the cudaError of the launch (0 = launched), or 10001 / 10002 when
// the driver's tensor-map encoder is missing or refuses the layout.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const int* seg, void* out, int B, int NH, int S, int HD,
                                   long long in_b, long long in_h, long long in_s,
                                   long long out_b, long long out_h, long long out_s,
                                   float sm_scale, void* stream)
{
    const Problem p{q, k, v, seg, out, nullptr, B, NH, S, {in_b, in_h, in_s},
                    {out_b, out_h, out_s}, sm_scale, static_cast<cudaStream_t>(stream)};
    return dispatch<false>(p, HD);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const int* seg, void* out, int B, int NH, int S, int HD,
                                    long long in_b, long long in_h, long long in_s,
                                    long long out_b, long long out_h, long long out_s,
                                    float sm_scale, void* stream)
{
    const Problem p{q, k, v, seg, out, nullptr, B, NH, S, {in_b, in_h, in_s},
                    {out_b, out_h, out_s}, sm_scale, static_cast<cudaStream_t>(stream)};
    return dispatch<true>(p, HD);
}

// The same, and lse (B, NH, S) float32, contiguous, receives each row's
// log-sum-exp m + log(l) of the scaled, masked logits (natural log): the row
// statistic flash attention's backward (csrc/flash_attention_bwd.cu) needs.
extern "C" int flash_attention_lse_f32(const void* q, const void* k, const void* v,
                                       const int* seg, void* out, float* lse, int B, int NH,
                                       int S, int HD, long long in_b, long long in_h,
                                       long long in_s, long long out_b, long long out_h,
                                       long long out_s, float sm_scale, void* stream)
{
    const Problem p{q, k, v, seg, out, lse, B, NH, S, {in_b, in_h, in_s},
                    {out_b, out_h, out_s}, sm_scale, static_cast<cudaStream_t>(stream)};
    return dispatch<false>(p, HD);
}

extern "C" int flash_attention_lse_bf16(const void* q, const void* k, const void* v,
                                        const int* seg, void* out, float* lse, int B, int NH,
                                        int S, int HD, long long in_b, long long in_h,
                                        long long in_s, long long out_b, long long out_h,
                                        long long out_s, float sm_scale, void* stream)
{
    const Problem p{q, k, v, seg, out, lse, B, NH, S, {in_b, in_h, in_s},
                    {out_b, out_h, out_s}, sm_scale, static_cast<cudaStream_t>(stream)};
    return dispatch<true>(p, HD);
}
