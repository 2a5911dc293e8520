// Prefill and verify attention (S > 1) over DeepSeek's latent (MLA) cache on
// Hopper's warpgroup MMAs: the pre-pass and the body that latent_attention.cu
// (bf16 rows) and latent_attention_quant.cu (packed latent, bf16 rope key)
// launch for every chunk of more than one token. Decode (S = 1) takes
// latent_decode.cuh.
//
// Function: the JAX kernel _flash_kernel in its MLA form (`latent`, v_from_k,
// d_extra): q (B, S, Hq, 576) bf16 against one kv head whose row is
// [c_kv (512) | rope(k_pe) (64)]; scores scale * q.k over all 576 channels;
// softmax over the visible keys times V, the leading 512 channels of the same
// row; output (B, S, Hq, 512) f32. Key j is visible to a query at position p
// iff j < total_len, j <= p and j lies in the layout (j < T, or within the
// block table); a page out of range holds no visible key; a row that sees no
// key gives 0. Over the quantized cache the body runs in the latent's rotated
// basis: the caller hands q rotated per 32-channel group and rotates the
// output back.
//
// Bound: 2 * (576 + 512) operations per visible (query head, key) pair at the
// bf16 tensor-core rate (DeepSeek-V2-Lite, 16 heads, S = 2048 on 512 cached:
// 1.10e11, 0.111 ms at 989 TFLOP/s). q is bf16 as the MLA module hands it over,
// so the scores take one MMA; P enters as a hi + lo bf16 pair (hi = bf16(p),
// lo = bf16(p - hi), p to about 2^-16), so P.V takes two: 576 + 2 * 512
// operations issued a pair, 1.47x the algorithm. A dequantized latent value (a
// grid value times a bf16 scale, at most 16 significant bits) is an exact
// hi + lo pair; the scores then take q.K hi and q.K lo (the rope key has no lo
// term) and P.V takes P hi.V hi, P lo.V hi and P hi.V lo (lo.lo is left out):
// 2.41x the algorithm.
//
// Design:
//   * A block holds LP_ROWS = 64 score rows, each a (token, head) pair (HB =
//     min(Hq, 64) heads, 64 / HB tokens: 4 tokens x 16 heads for
//     DeepSeek-V2-Lite, 64 heads of one token in two head slices for V2 and
//     V3). Its output is 64 x 512 f32, 256 registers a thread for one
//     warpgroup: two warpgroups share the rows, warpgroup w owning V's
//     columns 256w .. 256w + 255 (128 f32 registers a thread). The score
//     product takes one of two designs (tools/torch_prefill_phases.py
//     --latent times both): LP_WHOLE, both score the whole tile (36 k steps
//     of wgmma m64n32k16 each), so that P stays in registers as the A
//     operand of P.V; LP_KEYS, each scores half the tile's keys (m64n16k16)
//     and the two trade the rows' maxima and their P fragments through
//     shared memory. Measured (PERF.md): bf16 rows score whole tiles, the
//     quantized latent halves (LP_SCORES_BF16, LP_SCORES_QUANT).
//   * q is staged once by 16-byte cp.async into the 128-byte-swizzled K-major
//     layout of wgmma's A operand (9 blocks of 64 channels, 64 rows x 128
//     bytes each, chunk c of row j at c ^ (j & 7)): 73,728 bytes.
//   * A pre-pass (latent_tiles_kernel) first writes the K tiles of LP_TK =
//     32 keys that the chunk can see to a scratch the wrapper allocates, each
//     as a stage will hold it: 32 rows a 64-channel block in the same
//     swizzled layout, the paged layout's pages looked up, keys no row may
//     see (at or past the sequence's length, or in a page out of range) as
//     zeros, so that P (0) never meets a NaN of an unwritten row. bf16: the
//     rows as they are (36,864 bytes a tile, 1,152 a key: 2.9 MB at S = 2048
//     on 512). Quantized: the latent dequantized into hi (576, the rope key
//     beside it) and lo (512) rows (69,632 bytes a tile, 2,176 a key: 5.6 MB
//     at S = 2048 on 512, 71 MB for one sequence of 32K keys). The body then
//     stages a tile by one bulk copy (the tensor memory accelerator)
//     completing on its stage's mbarrier, 4 stages over bf16 (221,184 bytes
//     with q) and 2 quantized (212,992); a stage takes its next tile once
//     both warpgroups' P.V of its tile is done, issued by the later of the
//     two, so neither waits for the other.
//   * Scores: wgmma with q (A) and the K tile (B, K-major), both from shared
//     memory, into f32 registers. P.V: P hi and lo from the score registers
//     as the register A operand of m64n128k16, twice for a warpgroup's 256
//     columns, V read MN-major (transposed B) from the K tile already in
//     shared memory.
//   * The online softmax runs in registers in the accumulator's row layout,
//     in log2 units (ex2.approx); runs of masked, whole and masked tiles, the
//     mask a template argument, so that no branch lies between a wgmma and
//     the reads of its registers; every step is inlined (LP_INLINE: ptxas
//     otherwise outlines a step and serializes the wgmmas, C7520). A tile's
//     scores and the previous tile's P.V are in flight together.
//   * q blocks are issued longest first.
//
// The launches are counted where they are made (exl3_latent_prefill_launches,
// exl3_latent_tiles_launches), so that a caller can check which kernels an
// entry chose.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_prefill.cuh"  // the wgmma helpers and the swizzled layout
#include "latent_decode.cuh"      // LATENT, ROPE, dequant_run

// The latent prefill body's launches and its pre-pass's in this library (one
// definition across the sources that include this header)
inline int latent_prefill_launch_count = 0;
inline int latent_tiles_launch_count = 0;
extern "C" __attribute__((weak)) int exl3_latent_prefill_launches() {
    return latent_prefill_launch_count;
}
extern "C" __attribute__((weak)) int exl3_latent_tiles_launches() {
    return latent_tiles_launch_count;
}

namespace {

constexpr int LP_ROWS = 64;        // score rows a block
constexpr int LP_THREADS = 256;    // two warpgroups on the same rows
constexpr int LP_TK = 32;          // keys a tile
constexpr int LP_D = LATENT + ROPE;  // 576 channels a key row
// how the two warpgroups share the score product (the design above), over
// bf16 rows and over the quantized latent
constexpr int LP_WHOLE = 0, LP_KEYS = 1;
constexpr int LP_SCORES_BF16 = LP_WHOLE, LP_SCORES_QUANT = LP_KEYS;
constexpr int LP_MISC = 80;        // bytes of the block's bookkeeping (misc in the kernel)

// Shared memory of one block, from a 1024-aligned base: q (64 rows x 576
// bf16), then the stages: a K tile (32 rows x 576 bf16) and, over the
// quantized latent, its lo tile (32 rows x 512) beside it; then the
// warpgroups' trade (LP_KEYS: rows' maxima, P fragments and sums, 9,216
// bytes) and the block's key range, counters and mbarriers. bf16: 73,728 +
// 4 x 36,864 = 221,184 bytes; quantized: 73,728 + 2 x 69,632 = 212,992; a
// launch asks for the payload, 1,008 bytes of alignment and 80.
template <bool LO>
struct LatentPrefillLayout {
    static constexpr int Q = LP_ROWS * LP_D * 2;
    static constexpr int HI = LP_TK * LP_D * 2;
    static constexpr int LOT = LO ? LP_TK * LATENT * 2 : 0;
    static constexpr int STAGE = HI + LOT;
    static constexpr int STAGES = LO ? 2 : 4;
    static constexpr int SCORES = LO ? LP_SCORES_QUANT : LP_SCORES_BF16;
    // LP_KEYS: each warpgroup's rows' maxima (64 f32), its P fragments (128
    // threads x 8 words), and its rows' sums for the epilogue (64 f32)
    static constexpr int TRADE =
        SCORES == LP_KEYS ? 2 * (LP_ROWS * 4 + 128 * 8 * 4 + LP_ROWS * 4) : 0;
    static constexpr int OFF_STAGES = Q;
    static constexpr int OFF_TRADE = OFF_STAGES + STAGES * STAGE;
    static constexpr int OFF_MISC = OFF_TRADE + TRADE;
    static constexpr int BYTES = OFF_MISC + LP_MISC + 1024 - 16;
};

#define LP_INLINE __attribute__((always_inline))

#define LP_ACC8(a, i)                                                                       \
    "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]), "+f"(a[i + 4]), "+f"(a[i + 5]), \
        "+f"(a[i + 6]), "+f"(a[i + 7])

// d (64 x 32 f32) (+)= A (64 x 16, shared, K-major) . B (16 x 32, shared,
// K-major); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : LP_ACC8(d, 0), LP_ACC8(d, 8)
        : "l"(a), "l"(b), "r"(accumulate));
}
// d (64 x 16 f32) (+)= A (64 x 16, shared, K-major) . B (16 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a, uint64_t b,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : LP_ACC8(d, 0)
        : "l"(a), "l"(b), "r"(accumulate));
}
template <int N>
__device__ __forceinline__ void wgmma_ss_keys(float (&d)[N], uint64_t a, uint64_t b,
                                              int accumulate) {
    if constexpr (N == 16)
        wgmma_ss_n32(d, a, b, accumulate);
    else
        wgmma_ss_n16(d, a, b, accumulate);
}

// The latent's keys as the pre-pass (latent_tiles_kernel) reads them: bf16
// rows [c_kv | k_pe] (., ., 1, 576), or the packed latent (words, one bf16
// scale per 32 channels) and the bf16 rope key
struct LatentBf16Src {
    static constexpr bool LO = false;
    const __nv_bfloat16* kv;
};
struct LatentQuantSrc {
    static constexpr bool LO = true;
    const uint32_t* words;
    const __nv_bfloat16* scales;
    const __nv_bfloat16* rope;
    int bits;
    float ca, cb;  // compander a and 1 - a; ca = 0 selects the midpoint grid
};
template <class Rows, bool LO>
__global__ void __launch_bounds__(LP_THREADS, 1)
latent_prefill_kernel(const __nv_bfloat16* __restrict__ q, Rows rows,
                      const unsigned char* __restrict__ tiles, int NT,
                      const int* __restrict__ qpos, const int* __restrict__ total_lens,
                      float* __restrict__ out, int S, int Hq, float scale) {
    using L = LatentPrefillLayout<LO>;
    constexpr int NST = L::STAGES;
    constexpr bool SPLIT_KEYS = L::SCORES == LP_KEYS;
    constexpr int KEYS = SPLIT_KEYS ? LP_TK / 2 : LP_TK;  // keys a warpgroup scores
    constexpr int NS = KEYS / 2;       // score registers a thread
    constexpr int NK = LP_TK / 16;     // k steps of P.V
    constexpr int CPR = LP_D / 8;  // 16-byte chunks of a K row
    constexpr float LOG2E = 1.4426950408889634f;
    static_assert(LP_TK * CPR % LP_THREADS == 0 &&
                      LP_ROWS * CPR % LP_THREADS == 0 && PAGE % LP_TK == 0,
                  "tile geometry");
    static_assert(L::BYTES <= PF_BLOCK_SHARED_MAX, "shared memory of one block");
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
    const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    // [0] the last key any row sees; [1] the last key every written row sees
    // (the first is 0 for every row); [2] a tile of the walk is out of range;
    // [4..11] the stages' mbarriers; [12 + t % 4] tile t is in range; [16 +
    // s] the warpgroups' releases of stage s (two a tile: one warpgroup may
    // run ahead of the other by several tiles, so each stage counts its own)
    int* misc = reinterpret_cast<int*>(smem + L::OFF_MISC);
    uint64_t* bars = reinterpret_cast<uint64_t*>(misc + 4);
    static_assert(NST <= 4 && LP_MISC >= 20 * 4, "the block's bookkeeping");

    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const int b = blockIdx.z;
    const int HB = min(Hq, LP_ROWS);    // heads in this block
    const int NH = (Hq + HB - 1) / HB;  // head slices
    const int QT = LP_ROWS / HB;        // tokens in this block
    const int nqb = (S + QT - 1) / QT;
    const int qb = nqb - 1 - (int)blockIdx.x / NH;  // the longest q blocks first
    const int slice = (int)blockIdx.x % NH;
    const int s0 = qb * QT;
    const int total = min(total_lens[b], rows.key_limit());
    // row r -> token s, q head `head`; false for a padding row
    auto row_of = [&](int r, int& s, int& head) {
        const int t = r / HB, h = slice * HB + r % HB;
        s = s0 + t;
        head = h;
        return t < QT && s < S && h < Hq;
    };

    if (tid == 0) {
        misc[0] = -1;
        misc[1] = INT32_MAX;
        misc[2] = 0;
        for (int st = 0; st < NST; ++st) {
            mbar_init(bars + st);
            misc[16 + st] = 0;
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // q rows, swizzled, padding rows as zeros: the first commit group
    for (int e = tid; e < LP_ROWS * CPR; e += LP_THREADS) {
        const int r = e / CPR, c = e % CPR;
        int s, head;
        const bool valid = row_of(r, s, head);
        const __nv_bfloat16* src =
            q + (valid ? (((size_t)b * S + s) * Hq + head) * LP_D + c * 8 : 0);
        cp_async16_zfill(sbase + sw128(r, c, LP_ROWS), src, valid);
    }
    cp_async_commit();
    __syncthreads();  // misc's start values

    // this thread's two rows (g and g + 8 of its warp's 16; both warpgroups
    // hold the same rows): the last key each sees, and the running max and
    // partial sum
    int rhi[2];
    float m[2], l[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
        int s, head;
        const bool valid = row_of(r, s, head);
        const int p = valid ? qpos[(size_t)b * S + s] : -1;
        rhi[i] = p >= 0 ? min(p, total - 1) : -1;
        m[i] = -INFINITY;
        l[i] = 0.0f;
        if (wg == 0 && qd == 0 && valid) {
            atomicMax(&misc[0], rhi[i]);  // rows that see a key bound the walk
            atomicMin(&misc[1], rhi[i]);  // every written row bounds the whole tiles
        }
    }
    __syncthreads();
    const int ntiles = misc[0] >= 0 ? misc[0] / LP_TK + 1 : 0;
    // a tile out of the layout's range (a page id past the pool, a cache row
    // past N) holds no visible key: such a block masks every tile
    for (int t = tid; t < ntiles; t += LP_THREADS) {
        size_t tok0;
        int n;
        if (!rows.template tile<LP_TK>(b, t * LP_TK, tok0, n)) misc[2] = 1;
    }
    __syncthreads();
    // tiles [0, f1) are seen whole by every written row: no mask
    const int f1 = ntiles > 0 && !misc[2] ? max(0, min(ntiles, (misc[1] + 1) / LP_TK)) : 0;

    // by one thread: tile t into stage t % NST, one bulk copy (the tensor
    // memory accelerator) completing on the stage's mbarrier
    auto issue = [&](int t) LP_INLINE {
        if (t < ntiles) {
            size_t tok0;
            int n;
            misc[12 + t % 4] = rows.template tile<LP_TK>(b, t * LP_TK, tok0, n);
            mbar_expect(bars + t % NST, L::STAGE);
            bulk_copy(smem + L::OFF_STAGES + (t % NST) * L::STAGE,
                      tiles + ((size_t)b * NT + t) * L::STAGE, L::STAGE, bars + t % NST);
        }
    };
    if (tid == 0) {
        for (int t = 0; t < NST; ++t) issue(t);
    }

    float o[2][64];  // columns 256 wg + 128 h + 8 j + 2 qd (+1), element 4 j + e
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) o[h][i] = 0.0f;
    const uint64_t dq = sw128_desc(sbase, 16);
    // the step's registers, captured by the lambdas below (an array whose
    // bound depends on the storage, as a lambda's parameter, crashes nvcc's
    // front end, cudafe++): the scores (then P) of a tile, the rows'
    // rescale, and P hi and lo as the A fragments of P.V
    float sc[NS], alpha[2];
    uint32_t ph[NK][4], pl[NK][4];
    auto k_tile = [&](int t) { return sbase + L::OFF_STAGES + (t % NST) * L::STAGE; };

    // scores of tile t over the 576 channels (+ q . K lo over the latent's
    // 512), k steps of 16 channels; LP_KEYS: this warpgroup's half of the keys
    auto scores = [&](int t) LP_INLINE {
        const uint32_t kt = k_tile(t) + (SPLIT_KEYS ? wg * KEYS * 128 : 0);
#pragma unroll
        for (int kk = 0; kk < LP_D / 16; ++kk) {
            const uint64_t qo = (uint64_t)(((kk >> 2) * LP_ROWS * 128 + (kk & 3) * 32) >> 4);
            const uint32_t ko = (kk >> 2) * LP_TK * 128 + (kk & 3) * 32;
            wgmma_ss_keys(sc, dq + qo, sw128_desc(kt + ko, 16), kk > 0 ? 1 : 0);
            if constexpr (LO) {
                if (kk < LATENT / 16)
                    wgmma_ss_keys(sc, dq + qo, sw128_desc(kt + L::HI + ko, 16), 1);
            }
        }
    };
    // O += P hi . V + P lo . V (+ P hi . V lo) over tile t, this warpgroup's
    // 256 columns as two m64n128k16 halves, k steps of 16 keys
    auto pv = [&](int t) LP_INLINE {
        const uint32_t vt = k_tile(t) + wg * 4 * LP_TK * 128;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t vo = h * 2 * LP_TK * 128 + kk * 16 * 128;
                const uint64_t dv = sw128_desc(vt + vo, LP_TK * 128);
                wgmma_rs(o[h], ph[kk], dv);
                wgmma_rs(o[h], pl[kk], dv);
                if constexpr (LO) wgmma_rs(o[h], ph[kk], sw128_desc(vt + L::HI + vo, LP_TK * 128));
            }
        }
    };
    // LP_KEYS: the warpgroups' rows' maxima and P fragments
    float* trade_m = reinterpret_cast<float*>(smem + L::OFF_TRADE);  // [2][64]
    uint32_t* trade_p = reinterpret_cast<uint32_t*>(smem + L::OFF_TRADE + 2 * LP_ROWS * 4);
    // online softmax over the scores of tile t: sc becomes P (f32), alpha the
    // rows' rescale. Element 4j + e is row g + 8 (e >> 1), key 8j + 2qd +
    // (e & 1) of the keys this warpgroup scored; scores in log2 units. MASKED:
    // the tile is cut by a row's visible span or lies out of range
    const float scale_log2 = scale * LOG2E;
    auto softmax = [&](int t, auto masked) LP_INLINE {
        const int key0 = t * LP_TK + (SPLIT_KEYS ? wg * KEYS : 0);
        const bool tile_ok = misc[12 + t % 4];
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float s = sc[4 * j + e] * scale_log2;
                if constexpr (decltype(masked)::value) {
                    const int key = key0 + 8 * j + 2 * qd + (e & 1);
                    s = tile_ok && key <= rhi[e >> 1] ? s : -INFINITY;
                }
                sc[4 * j + e] = s;
                mx[e >> 1] = fmaxf(mx[e >> 1], s);
            }
        }
        float mb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        }
        if constexpr (SPLIT_KEYS) {  // the tile's max over both halves
            const int r = warp * 16 + g;
            if (qd == 0) {
                trade_m[wg * LP_ROWS + r] = mx[0];
                trade_m[wg * LP_ROWS + r + 8] = mx[1];
            }
            named_sync(1, LP_THREADS);
            mx[0] = fmaxf(trade_m[r], trade_m[LP_ROWS + r]);
            mx[1] = fmaxf(trade_m[r + 8], trade_m[LP_ROWS + r + 8]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float m_new = fmaxf(m[i], mx[i]);
            alpha[i] = m[i] == -INFINITY ? 0.0f : ex2(m[i] - m_new);
            mb[i] = m_new == -INFINITY ? 0.0f : m_new;
            m[i] = m_new;
            l[i] *= alpha[i];
        }
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2(sc[4 * j + e] - mb[e >> 1]);
                l[e >> 1] += p;
                sc[4 * j + e] = p;
            }
        }
    };
    // P hi and lo as the A fragments of the P.V product's k steps; LP_KEYS:
    // this warpgroup's k step from its own scores, the other's traded
    auto pack = [&]() LP_INLINE {
        // element 4j + e of the scores holds keys 8j .. 8j + 7: fragment
        // 2 (j & 1) + i of k step j / 2 (LP_KEYS: of this warpgroup's k step)
        uint32_t hb[NS / 2], lb[NS / 2];
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const float p0 = sc[4 * j + 2 * i], p1 = sc[4 * j + 2 * i + 1];
                const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
                const float2 hf = __bfloat1622float2(h);
                hb[2 * j + i] = bf16x2_bits(h);
                lb[2 * j + i] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
            }
        }
        if constexpr (SPLIT_KEYS) {  // k step wg is this warpgroup's, the other is traded
            uint32_t* mine = trade_p + (wg * 128 + tid % 128) * 8;
            const uint32_t* other = trade_p + ((1 - wg) * 128 + tid % 128) * 8;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                mine[i] = hb[i];
                mine[4 + i] = lb[i];
            }
            named_sync(1, LP_THREADS);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const uint32_t oh = other[i], ol = other[4 + i];
                ph[0][i] = wg == 0 ? hb[i] : oh;
                pl[0][i] = wg == 0 ? lb[i] : ol;
                ph[1][i] = wg == 0 ? oh : hb[i];
                pl[1][i] = wg == 0 ? ol : lb[i];
            }
        } else {
#pragma unroll
            for (int i = 0; i < NS / 2; ++i) {
                ph[i / 4][i % 4] = hb[i];
                pl[i / 4][i % 4] = lb[i];
            }
        }
    };
    auto rescale = [&]() LP_INLINE {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[h][4 * j + e] *= alpha[e >> 1];
    };
    // tile t has landed
    auto ready = [&](int t) LP_INLINE { mbar_wait(bars + t % NST, (t / NST) & 1); };
    // this warpgroup's P.V of tile t - 1 is done; the later of the two
    // warpgroups to say so issues tile t - 1 + NST into that tile's stage
    auto release = [&](int t) LP_INLINE {
        named_sync(2 + wg, 128);
        if (tid % 128 == 0 && (atomicAdd(&misc[16 + (t - 1) % NST], 1) & 1)) issue(t - 1 + NST);
    };

    // one tile after the first: the scores of tile t and the P.V of tile t - 1
    // in flight together; no branch writes a wgmma's registers between the
    // wgmma and its wait. bf16 (4 stages): the scores first, the softmax of t
    // running while the P.V does. LO (2 stages): the P.V first, so that its
    // stage goes back to the copies (release) while the scores run
    auto step = [&](int t, auto masked) LP_INLINE {
        ready(t);
        wgmma_fence();
        if constexpr (LO) {
            pv(t - 1);
            wgmma_commit();
            scores(t);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(o[0]);
            fence_regs(o[1]);
            release(t);
            wgmma_wait<0>();
            fence_regs(sc);
            softmax(t, masked);
        } else {
            scores(t);
            wgmma_commit();
            pv(t - 1);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(sc);
            softmax(t, masked);
            wgmma_wait<0>();
            fence_regs(o[0]);
            fence_regs(o[1]);
            release(t);
        }
        rescale();
        pack();
    };
    using Masked = std::true_type;
    using Whole = std::false_type;
    if (ntiles > 0) {
        cp_async_wait<0>();  // q
        fence_proxy_async();
        __syncthreads();
        ready(0);  // the first tile: no P.V before it, none to rescale
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] = 0.0f;
        wgmma_fence();
        scores(0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(0, Masked{});
        pack();
        int t = 1;
        for (; t < f1; ++t) step(t, Whole{});
        for (; t < ntiles; ++t) step(t, Masked{});
        wgmma_fence();  // the last tile's P.V
        pv(ntiles - 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o[0]);
        fence_regs(o[1]);
    }
    cp_async_wait<0>();

    // each row's sum over the quad (LP_KEYS: and over both warpgroups' keys)
    float den[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float sum = l[i];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        den[i] = sum;
    }
    if constexpr (SPLIT_KEYS) {
        float* trade_l = trade_m + 2 * LP_ROWS + 2 * 128 * 8;  // past the P fragments
        const int r = warp * 16 + g;
        __syncthreads();
        if (qd == 0) {
            trade_l[wg * LP_ROWS + r] = den[0];
            trade_l[wg * LP_ROWS + r + 8] = den[1];
        }
        __syncthreads();
        den[0] = trade_l[r] + trade_l[LP_ROWS + r];
        den[1] = trade_l[r + 8] + trade_l[LP_ROWS + r + 8];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = warp * 16 + g + 8 * i;
        int s, head;
        if (!row_of(r, s, head)) continue;
        const float inv = 1.0f / fmaxf(den[i], 1e-30f);
        float* dst = out + (((size_t)b * S + s) * Hq + head) * LATENT + wg * 256 + 2 * qd;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 16; ++j)
                *reinterpret_cast<float2*>(dst + h * 128 + 8 * j) =
                    make_float2(o[h][4 * j + 2 * i] * inv, o[h][4 * j + 2 * i + 1] * inv);
    }
}

#undef LP_ACC8
#undef LP_INLINE

// The pre-pass: the latent's tiles that a launch can see (those below the
// sequence's length), each as the body's stage will hold it: hi (576: the
// latent, then the rope key) and, over the quantized latent, lo (512: the
// latent's lo terms; the rope key has none) bf16 rows, swizzled as sw128; the
// quantized latent's values are dequant_run's, split exactly (hi = bf16(x),
// lo = bf16(x - hi)); keys at or past the sequence's length, or in a page out
// of range, as zeros. A block takes a tile, a thread 8 channels of one key at
// a time.
template <class Rows, class Src, int BITS>
__global__ void __launch_bounds__(LP_THREADS)
latent_tiles_kernel(Src src, Rows rows, const int* __restrict__ total_lens,
                    unsigned char* __restrict__ tiles, int NT) {
    constexpr bool LO = Src::LO;
    using L = LatentPrefillLayout<LO>;
    constexpr int RUNS = LP_D / 8;  // 16-byte runs of a hi row
    const int b = blockIdx.y, key0 = blockIdx.x * LP_TK;
    const int total = min(total_lens[b], rows.key_limit());
    if (key0 >= total) return;  // no row reads this tile
    size_t tok0;
    int n;
    const bool ok = rows.template tile<LP_TK>(b, key0, tok0, n);
    const int nin = ok ? min(Rows::FULL ? LP_TK : n, total - key0) : 0;
    unsigned char* dst = tiles + ((size_t)b * NT + blockIdx.x) * L::STAGE;
    for (int e = threadIdx.x; e < LP_TK * RUNS; e += LP_THREADS) {
        const int j = e / RUNS, c = e % RUNS;
        const size_t tok = tok0 + j;
        uint4 h = make_uint4(0u, 0u, 0u, 0u), lo = h;
        if (j < nin) {
            if constexpr (!LO) {
                h = *reinterpret_cast<const uint4*>(src.kv + tok * LP_D + c * 8);
            } else if (c < LATENT / 8) {
                constexpr int WLD = LATENT * BITS / 32;  // words a key
                float x[8];
                dequant_run<LATENT, BITS>(
                    src.words + tok * WLD,
                    __bfloat162float(src.scales[tok * (LATENT / 32) + (c >> 2)]), c * 8, src.ca,
                    src.cb, x);
                uint32_t hh[4], ll[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    hh[i] = pack_bf16x2(x[2 * i], x[2 * i + 1]);
                    ll[i] = pack_bf16x2(x[2 * i] - __uint_as_float(hh[i] << 16),
                                        x[2 * i + 1] - __uint_as_float(hh[i] & 0xFFFF0000u));
                }
                h = make_uint4(hh[0], hh[1], hh[2], hh[3]);
                lo = make_uint4(ll[0], ll[1], ll[2], ll[3]);
            } else {
                h = *reinterpret_cast<const uint4*>(src.rope + tok * ROPE + (c - LATENT / 8) * 8);
            }
        }
        *reinterpret_cast<uint4*>(dst + sw128(j, c, LP_TK)) = h;
        if (LO && c < LATENT / 8) *reinterpret_cast<uint4*>(dst + L::HI + sw128(j, c, LP_TK)) = lo;
    }
}

// The pre-pass on `st`: the tiles of B sequences of W keys (the layout's keys
// a sequence: block table width * 256, or T) into `scratch`, tile t of
// sequence b at byte (b * NT + t) * STAGE, NT = W / LP_TK rounded up. Returns
// cudaGetLastError() as an int.
template <class Rows, class Src>
int launch_latent_tiles(Rows rows, Src src, void* scratch, int W, const void* total_lens, int B,
                        cudaStream_t st) {
    if (B < 1 || W < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
    const int NT = (W + LP_TK - 1) / LP_TK;
    auto* tiles = static_cast<unsigned char*>(scratch);
    const auto* tl = static_cast<const int*>(total_lens);
    const dim3 grid(NT, B);
#define EXL3_TILES(BITS) latent_tiles_kernel<Rows, Src, BITS><<<grid, LP_THREADS, 0, st>>>( \
        src, rows, tl, tiles, NT)
    if constexpr (Src::LO) {
        switch (src.bits) {  // uniform across the grid
            case 2: EXL3_TILES(2); break;
            case 3: EXL3_TILES(3); break;
            case 4: EXL3_TILES(4); break;
            case 5: EXL3_TILES(5); break;
            case 6: EXL3_TILES(6); break;
            case 7: EXL3_TILES(7); break;
            default: EXL3_TILES(8); break;
        }
    } else {
        EXL3_TILES(16);
    }
#undef EXL3_TILES
    const int err = (int)cudaGetLastError();
    if (err == 0) ++latent_tiles_launch_count;
    return err;
}

// The body on `st` over the pre-pass's tiles in `scratch`; over the quantized
// latent (LO) q is rotated per 32-channel group and the output left in the
// rotated basis. Returns cudaGetLastError() as an int.
template <class Rows, bool LO>
int launch_latent_body(const void* q, Rows rows, const void* scratch, int W, const void* qpos,
                       const void* total_lens, void* out, int B, int S, int Hq, float scale,
                       cudaStream_t st) {
    using L = LatentPrefillLayout<LO>;
    if (Hq < 1 || S < 1 || B < 1 || W < 1 || scratch == nullptr) return (int)cudaErrorInvalidValue;
    auto* kernel = latent_prefill_kernel<Rows, LO>;
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
        attr_set = true;
    }
    const int HB = Hq < LP_ROWS ? Hq : LP_ROWS;
    const int QT = LP_ROWS / HB, NH = (Hq + HB - 1) / HB;
    kernel<<<dim3((S + QT - 1) / QT * NH, 1, B), LP_THREADS, L::BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(q), rows, static_cast<const unsigned char*>(scratch),
        (W + LP_TK - 1) / LP_TK, static_cast<const int*>(qpos),
        static_cast<const int*>(total_lens), static_cast<float*>(out), S, Hq, scale);
    const int err = (int)cudaGetLastError();
    if (err == 0) ++latent_prefill_launch_count;
    return err;
}

// The pre-pass, then the body.
template <class Rows, class Src>
int launch_latent_prefill(const void* q, Rows rows, Src src, void* scratch, int W,
                          const void* qpos, const void* total_lens, void* out, int B, int S,
                          int Hq, float scale, cudaStream_t st) {
    if (Hq < 1 || S < 1) return (int)cudaErrorInvalidValue;
    const int err = launch_latent_tiles(rows, src, scratch, W, total_lens, B, st);
    if (err != 0) return err;
    return launch_latent_body<Rows, Src::LO>(q, rows, scratch, W, qpos, total_lens, out, B, S, Hq,
                                             scale, st);
}

}  // namespace
