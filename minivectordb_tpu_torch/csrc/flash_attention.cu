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
// What both kernels share. An item is one (batch, head) and a tile of BM
// query rows; the keys are cut into tiles (BF_KT = 128 for bf16, BN = 64 for
// f32). At the encoder's shapes an item visits only a few key tiles, so what
// a block does once per item (find the tiles, load Q, wait for the first
// loads, write the output) weighs as much as the products: the first design
// (one block per item, synchronous loads, a block barrier per tile) spent
// most of its time there. So the blocks are persistent (one per SM, walking
// items blockIdx.x, + gridDim.x, ...) and warp-specialised:
//   - one producer warp walks the block's items and, per item, the key tiles
//     to visit, and fills a ring of ST stages in shared memory running ahead
//     of the consumers across item boundaries: lane 0 has TMA copy the K and
//     V tiles (and Q, into one of NQ slots, with an item's first tile), the
//     lanes copy the segment ids with cp.async. A stage's "full" mbarrier
//     completes when the TMA bytes and the lanes' copies have landed
//     (expect_tx, cp.async.mbarrier.arrive.noinc); its "empty" one when every
//     consumer warp is done with it; each query slot has an "empty" barrier
//     too. No block-wide barrier is left in the loop, and the tensor maps let
//     one instruction fetch a tile in whole 128-byte rows.
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
// multiple of 16 up to 128, so no padded width). In practice the softmax
// (one ex2 per logit on the special-function unit) and the latency between
// the two products bound it, so each warpgroup software-pipelines its tiles
// (P V of one tile runs on the tensor cores while the next tile's softmax
// runs on the CUDA cores) and the two warpgroups take turns to issue their
// products (named barriers), so one's softmax overlaps the other's products.
// Tiles are stored in wgmma's no-swizzle layout, column-major in 16-byte
// columns (8 rows of a column are one 128-byte core matrix), which takes
// every HD that is a multiple of 8 and is what a TMA box of (16 bytes x rows
// x columns) writes.
// f32 (flash_f32_kernel): IEEE FMAs on the CUDA cores, never TF32; the FMAs
// and the shared-memory reads that feed them bound it. A thread owns an RI x 4
// tile of S (rows ty + 16i, keys tx + 16j; RI = 8, 128 query rows an item, or
// 4 for HD = 128, whose operands would not fit shared memory at 8): 16 FMAs
// per 128-bit read of Q K^T at RI = 8 where the first kernel had 8. Q and K
// are column-major in 16-byte columns, so the rows a warp reads at once are
// adjacent; V is row-major. A row's keys are spread over the 16 lanes of a
// half-warp, so P goes through shared memory for P V, written and read by that
// half-warp alone.
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

constexpr int BN = 64;  // keys per tile of the float32 kernel
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
// scratch (float32's P), the segment ids of a slot's BM queries and of a
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
template <class L, class LoadQ, class LoadKV>
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
                mbar_expect_tx(full, (L::P - L::K) / L::ST + (flags & FIRST ? (L::K - L::Q) / L::NQ : 0));
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
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp

// ---------------------------------------------------------------------------
// float32: IEEE FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int PST = BN + 16;  // shared stride of a P row: rows ty, ty+1 lie 16 banks apart

// Q and K are stored column-major in 16-byte columns (element (r, c) of an
// R-row tile at (c / 4) * R * 4 + r * 4 + c % 4), so the rows a warp reads at
// once are adjacent; V is stored row-major. One TMA box each.
template <int HD>
struct F32Cfg {
    static constexpr int RI = HD == 128 ? 4 : 8;  // S rows per thread
    static constexpr int BM = 16 * RI;            // query rows per item
    static constexpr int QB = BM * HD * 4, KB = BN * HD * 4, VB = BN * HD * 4;
    static constexpr int PB = BM * PST * 4;
    template <int NQ_, int ST_>
    using L = Layout<QB, NQ_, ST_, KB, VB, PB, BM, BN>;
    // two query slots where they fit (Q of the next item loads during this
    // one), then three stages where they fit
    static constexpr int NQ = L<2, 2>::BYTES <= SMEM_LIMIT ? 2 : 1;
    static constexpr int ST = L<NQ, 3>::BYTES <= SMEM_LIMIT ? 3 : 2;
    using Lay = L<NQ, ST>;
    static_assert(Lay::BYTES <= SMEM_LIMIT, "f32 shared memory above the block limit");
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bool hb_swap, const int* __restrict__ seg,
                 float* __restrict__ out, float* __restrict__ lse, int NH, int S, Strides os,
                 float scale_log2,
                 int mtiles, int items)
{
    using C = F32Cfg<HD>;
    using L = typename C::Lay;
    constexpr int RI = C::RI;
    constexpr int BM = C::BM;
    constexpr int CW = HD / 16;         // output columns per thread
    constexpr bool VEC = HD % 64 == 0;  // columns as float4 groups, else one by one
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t sbase = smem_u32(smem);
    Meta* meta = reinterpret_cast<Meta*>(smem + L::META);
    init_barriers<L>(sbase, CONSUMERS / 32);
    const int tid = threadIdx.x;

    if (tid >= CONSUMERS) {
        auto load_q = [&](int slot, int b, int h, int m0, uint32_t bar) {
            tma_load(sbase + L::Q + slot * C::QB, &tq, m0, h, b, true, hb_swap, bar);
        };
        auto load_kv = [&](int st, int b, int h, int n0, uint32_t bar) {
            tma_load(sbase + L::K + st * C::KB, &tk, n0, h, b, true, hb_swap, bar);
            tma_load(sbase + L::V + st * C::VB, &tv, n0, h, b, false, hb_swap, bar);
        };
        produce<L>(seg, S, NH, mtiles, items, sbase, meta, load_q, load_kv);
        return;
    }

    const int tx = tid & 15;  // key column / output column group
    const int ty = tid >> 4;  // query row group; a half-warp shares one ty
    float* Ps = reinterpret_cast<float*>(smem + L::P);
    int p = 0;  // tiles taken
    int j = 0;  // items taken
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
        const int bh = item / mtiles;
        const int m0 = (item - bh * mtiles) * BM;
        const int b = bh / NH;
        const int h = bh - b * NH;
        const int slot = j % L::NQ;
        const float* Qs = reinterpret_cast<const float*>(smem + L::Q + slot * C::QB);
        const int* segq_s = reinterpret_cast<const int*>(smem + L::SEGQ) + slot * BM;

        int segq[RI];
        float m[RI], l[RI], acc[RI][CW];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
            m[i] = -INFINITY;
            l[i] = 0.f;
#pragma unroll
            for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
        }

        int flags;
        do {
            const int st = p % L::ST;
            mbar_wait(sbase + L::FULL + 8 * st, (p / L::ST) & 1);
            const Meta tile = meta[st];
            flags = tile.flags;
            if (flags & FIRST) {  // Q and the queries' ids landed with this tile
#pragma unroll
                for (int i = 0; i < RI; ++i) segq[i] = segq_s[ty + 16 * i];
            }
            const int n0 = tile.n0;
            const float* Ks = reinterpret_cast<const float*>(smem + L::K + st * C::KB);
            const float* Vs = reinterpret_cast<const float*>(smem + L::V + st * C::VB);
            const int* segk = reinterpret_cast<const int*>(smem + L::SEGK) + st * BN;

            // S = Q K^T for rows ty + 16i, keys tx + 16j
            float s[RI][4];
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
            for (int kk = 0; kk < HD; kk += 4) {
                float4 kv[4];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj)
                    kv[jj] = *reinterpret_cast<const float4*>(&Ks[kk * BN + (tx + 16 * jj) * 4]);
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    const float4 qv =
                        *reinterpret_cast<const float4*>(&Qs[kk * BM + (ty + 16 * i) * 4]);
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) {
                        s[i][jj] = fmaf(qv.x, kv[jj].x, s[i][jj]);
                        s[i][jj] = fmaf(qv.y, kv[jj].y, s[i][jj]);
                        s[i][jj] = fmaf(qv.z, kv[jj].z, s[i][jj]);
                        s[i][jj] = fmaf(qv.w, kv[jj].w, s[i][jj]);
                    }
                }
            }

            // scale (into the exp2 domain), mask, online softmax; the 16 lanes
            // of a half-warp hold one row
            if (flags & UNIFORM) {  // every key below S, one id: a row sees all or none
                const int id = segk[0];
#pragma unroll
                for (int i = 0; i < RI; ++i)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj)
                        s[i][jj] = id == segq[i] ? s[i][jj] * scale_log2 : MASK_VALUE;
            } else {
                bool seen[4];
                int sk[4];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    seen[jj] = n0 + tx + 16 * jj < S;
                    sk[jj] = segk[tx + 16 * jj];
                }
#pragma unroll
                for (int i = 0; i < RI; ++i)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj)
                        s[i][jj] = (seen[jj] && sk[jj] == segq[i]) ? s[i][jj] * scale_log2
                                                                   : MASK_VALUE;
            }
#pragma unroll
            for (int i = 0; i < RI; ++i) {
                float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
                for (int off = 8; off > 0; off >>= 1)
                    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
                const float mnew = fmaxf(m[i], mx);         // finite: every s is
                const float alpha = fast_exp2(m[i] - mnew);  // 0 while m is still -inf
                float pj[4];
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    pj[jj] = fast_exp2(s[i][jj] - mnew);
                    Ps[(ty + 16 * i) * PST + tx + 16 * jj] = pj[jj];
                }
                float sum = (pj[0] + pj[1]) + (pj[2] + pj[3]);
#pragma unroll
                for (int off = 8; off > 0; off >>= 1)
                    sum += __shfl_xor_sync(0xffffffffu, sum, off);
                l[i] = l[i] * alpha + sum;
                m[i] = mnew;
#pragma unroll
                for (int c = 0; c < CW; ++c) acc[i][c] *= alpha;
            }
            __syncwarp();  // a row of P is written and read by one half-warp

            // O += P V for rows ty + 16i and this thread's CW columns
#pragma unroll 2
            for (int j0 = 0; j0 < BN; j0 += 4) {
                float4 pv[RI];
#pragma unroll
                for (int i = 0; i < RI; ++i)
                    pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PST + j0]);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    const float* vrow = &Vs[(j0 + jj) * HD];
                    float vv[CW];
                    if constexpr (VEC) {
#pragma unroll
                        for (int c4 = 0; c4 < CW / 4; ++c4) {
                            const float4 t =
                                *reinterpret_cast<const float4*>(&vrow[c4 * 64 + tx * 4]);
                            vv[c4 * 4 + 0] = t.x;
                            vv[c4 * 4 + 1] = t.y;
                            vv[c4 * 4 + 2] = t.z;
                            vv[c4 * 4 + 3] = t.w;
                        }
                    } else {
#pragma unroll
                        for (int c = 0; c < CW; ++c) vv[c] = vrow[tx + 16 * c];
                    }
#pragma unroll
                    for (int i = 0; i < RI; ++i) {
                        const float pj = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y
                                       : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
                        for (int c = 0; c < CW; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
                    }
                }
            }
            release(sbase + L::EMPTY + 8 * st);  // also orders P's reads before the next writes
            ++p;
        } while (!(flags & LAST));

        float* ob = out + (size_t)b * os.b + (size_t)h * os.h;
#pragma unroll
        for (int i = 0; i < RI; ++i) {
            const int r = m0 + ty + 16 * i;
            if (r >= S) continue;
            float* orow = ob + (size_t)r * os.s;
            const float inv = 1.f / l[i];
            // the row's log-sum-exp of the natural-domain logits, for the backward
            if (lse != nullptr && tx == 0) lse[(size_t)bh * S + r] = m[i] * LN2 + logf(l[i]);
            if constexpr (VEC) {
#pragma unroll
                for (int c4 = 0; c4 < CW / 4; ++c4)
                    *reinterpret_cast<float4*>(&orow[c4 * 64 + tx * 4]) = make_float4(
                        acc[i][c4 * 4 + 0] * inv, acc[i][c4 * 4 + 1] * inv,
                        acc[i][c4 * 4 + 2] * inv, acc[i][c4 * 4 + 3] * inv);
            } else {
#pragma unroll
                for (int c = 0; c < CW; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
            }
        }
        release(sbase + L::QEMPTY + 8 * slot);
    }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BF_BM = 128;  // query rows per item: one consumer warpgroup per 64

// A tile of R rows x HD is kept in wgmma's no-swizzle layout, column-major in
// 16-byte columns: element (r, c) lies at element (c / 8) * R * 8 + r * 8 +
// c % 8, one TMA box per column; every 8 rows of a column are one core
// matrix (128 contiguous bytes). Both query slots and four stages fit at
// every HD.
constexpr int BF_KT = 128;  // keys per tile

template <int HD, int ST>
using BfLayoutST = Layout<BF_BM * HD * 2, 2, ST, BF_KT * HD * 2, BF_KT * HD * 2, 0, BF_BM, BF_KT>;
// as many stages as fit, at most four
template <int HD>
using BfLayout = BfLayoutST<HD, BfLayoutST<HD, 4>::BYTES <= SMEM_LIMIT ? 4
                                : BfLayoutST<HD, 3>::BYTES <= SMEM_LIMIT ? 3 : 2>;

// wgmma matrix descriptor, no swizzle: start address, leading byte offset
// (between core matrices along K) and stride byte offset (between core
// matrices along M or N), all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32);
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
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bool hb_swap, const int* __restrict__ seg,
                  uint16_t* __restrict__ out, float* __restrict__ lse, int NH, int S, Strides os,
                  float scale_log2,
                  int mtiles, int items)
{
    using L = BfLayout<HD>;
    constexpr int QB = BF_BM * HD * 2;   // bytes of a query slot
    constexpr int TB = BF_KT * HD * 2;   // bytes of a K or V tile
    constexpr int NT_O = HD / 8;         // 8-column chunks of the output
    // descriptors (leading byte offset: to the next core matrix along K;
    // stride byte offset: along M or N). Q and K are K-major: the next 8
    // columns lie a column (rows x 16 bytes) on, the next 8 rows 128 bytes on.
    // V is MN-major: the next 8 keys lie 128 bytes on, the next 8 columns
    // BF_KT x 16 bytes on.
    constexpr uint32_t Q_LBO = BF_BM * 16, K_LBO = BF_KT * 16, KV_SBO = 128;
    constexpr uint32_t V_LBO = 128, V_SBO = BF_KT * 16;
    extern __shared__ __align__(128) unsigned char smem[];
    const uint32_t sbase = smem_u32(smem);
    Meta* meta = reinterpret_cast<Meta*>(smem + L::META);
    init_barriers<L>(sbase, CONSUMERS / 32);
    const int tid = threadIdx.x;
    const int lane = tid & 31;

    if (tid >= CONSUMERS) {
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
        const uint32_t q_sm = sbase + L::Q + slot * QB + wg * 64 * 16;
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
                wgmma_ss<BF_KT>(c, smem_desc(q_sm + ks * 2 * Q_LBO, Q_LBO, KV_SBO),
                                smem_desc(k_sm + ks * 2 * K_LBO, K_LBO, KV_SBO));
            wgmma_commit();
        };
        // O += P V of the tile in stage st, issued (not waited for)
        auto issue_pv = [&](int st) {
            fence_regs(o);
            wgmma_fence();
            const uint32_t v_sm = sbase + L::V + st * TB;
#pragma unroll
            for (int kk = 0; kk < BF_KT / 16; ++kk)
                wgmma_rs<HD>(o, pa[kk], smem_desc(v_sm + kk * 256, V_LBO, V_SBO));
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

        // Epilogue: the rows, normalised and rounded once, are staged in this
        // warpgroup's own rows of the query slot (no longer read), then leave
        // as whole 16-byte pieces, a warp writing whole rows.
        const float inv[2] = {1.f / lrow[0], 1.f / lrow[1]};
        if (lse != nullptr && t4 == 0) {  // the rows' log-sum-exp, for the backward
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = m0 + row0 + 8 * hh;
                if (r < S) lse[(size_t)bh * S + r] = mrow[hh] * LN2 + logf(lrow[hh]);
            }
        }
        unsigned char* stage = smem + L::Q + slot * QB;
#pragma unroll
        for (int nt = 0; nt < NT_O; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<uint32_t*>(stage + nt * BF_BM * 16 + (row0 + 8 * hh) * 16 +
                                             t4 * 4) =
                    pack_bf16(o[4 * nt + 2 * hh] * inv[hh], o[4 * nt + 2 * hh + 1] * inv[hh]);
        asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wg) : "memory");  // this warpgroup
        uint16_t* ob = out + (size_t)b * os.b + (size_t)h * os.h;
        for (int idx = tid & 127; idx < 64 * NT_O; idx += 128) {
            const int r = wg * 64 + idx / NT_O;  // row of the item
            const int ch = idx % NT_O;
            if (m0 + r < S)
                *reinterpret_cast<uint4*>(ob + (size_t)(m0 + r) * os.s + ch * 8) =
                    *reinterpret_cast<const uint4*>(stage + ch * BF_BM * 16 + r * 16);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // before TMA reuses it
        release(sbase + L::QEMPTY + 8 * slot);
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
// from row on, every element of them. Dim 0 is a 16-byte column of a row
// (chunk elements); dims 1 and 2 are the sequence (stride in.s) and the
// row's columns (stride 16 bytes), in that order when rows_inner (the box
// lands column by column) or the other way round (row by row); dims 3 and 4
// are head and batch, the smaller stride first (hb_swap: batch first).
// Rows past S read as zeros.
int make_map(CUtensorMap* map, const void* ptr, bool bf16, const Problem& p, int HD, int rows,
             bool rows_inner, bool& hb_swap) {
    EncodeTiled encode = encoder();
    if (encode == nullptr) return ERR_NO_ENCODER;
    const int esize = bf16 ? 2 : 4;
    const int chunk = 16 / esize;
    hb_swap = p.in.b < p.in.h;
    const long long hs = hb_swap ? p.in.b : p.in.h, bs = hb_swap ? p.in.h : p.in.b;
    const int hn = hb_swap ? p.B : p.NH, bn = hb_swap ? p.NH : p.B;
    const cuuint64_t seq[2] = {static_cast<cuuint64_t>(p.S), static_cast<cuuint64_t>(p.in.s) * esize};
    const cuuint64_t col[2] = {static_cast<cuuint64_t>(HD / chunk), 16};
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
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

// Items (B * NH * ceil(S / bm)) and persistent blocks (as many as the SMs
// hold, at most one per item) for a kernel with smem bytes of shared memory.
// The shared-memory attribute and the blocks the card holds are set up once
// per device and kernel (the host calls cost more than a launch): resident is
// the kernel's own table, by device.
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
int plan(const Problem& p, Kernel* kernel, int smem, int bm, int (&resident)[MAX_DEVICES],
         int& mtiles, int& items, int& blocks) {
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
        int sms, per_sm;
        if (cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
            return static_cast<int>(e);
        if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                          THREADS, smem))
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
    if (int e = plan(p, flash_f32_kernel<HD>, smem, C::BM, resident, mtiles, items, blocks))
        return e;
    CUtensorMap tq, tk, tv;
    if (int e = make_map(&tq, p.q, false, p, HD, C::BM, true, hb_swap)) return e;
    if (int e = make_map(&tk, p.k, false, p, HD, BN, true, hb_swap)) return e;
    if (int e = make_map(&tv, p.v, false, p, HD, BN, false, hb_swap)) return e;
    flash_f32_kernel<HD><<<blocks, THREADS, smem, p.stream>>>(
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
    if (int e = plan(p, flash_bf16_kernel<HD>, smem, BF_BM, resident, mtiles, items, blocks))
        return e;
    CUtensorMap tq, tk, tv;
    if (int e = make_map(&tq, p.q, true, p, HD, BF_BM, true, hb_swap)) return e;
    if (int e = make_map(&tk, p.k, true, p, HD, BF_KT, true, hb_swap)) return e;
    if (int e = make_map(&tv, p.v, true, p, HD, BF_KT, true, hb_swap)) return e;
    flash_bf16_kernel<HD><<<blocks, THREADS, smem, p.stream>>>(
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
