// EXL3 trellis-decode GEMM for Hopper: y' = xh . W_inner with W_inner decoded
// from the packed K-bit trellis inside the kernel.
//
// Replaces: exllamav3_tpu/ops/exl3_gemm.py::_exl3_gemm_kernel (with the
//           blocking of exl3_gemm_core). The two 128-point Hadamards and the
//           sign vectors stay outside, as in the JAX package.
// Inputs:   xh (m, k) bf16, any m; words (k/16, K, n/16*8) int32, the layout
//           of prepare_trellis_words carried over unchanged: stream word
//           S[g*K + wi] of tile (kt, nt) at [kt, wi, nt*8 + g]; k, n multiples
//           of 128; K in 1..8; codebook 0 (3INST), 1 (MCG), 2 (MUL1).
// Output:   (m, n) f32 in true row/column order. With splits > 1, `ws`
//           (splits, m, n) f32 takes each split's partial sums and `counters`
//           (one int32 an output tile: n/128 * ceil(m / rows a block), 0
//           before the launch, left 0 after it) finds the last split of a
//           tile to arrive, which adds the partials in split order.
// Bound:    bytes (K/8 a weight) up to some 80 rows, the MMAs beyond. Below
//           that the decode is what the kernel spends its issue slots on:
//           every weight is decoded once a block of rows.
// Design:   the format's tile order is the B fragment of mma.m16n8k16: lane
//           L of a warp owns codes 8L..8L+7 of a 16x16 tile, which are rows
//           (2(L%4), +1, +8, +9) of columns L/4 and L/4+8. So a warp decodes a
//           tile straight into two B fragments in registers, with no shuffle
//           and none of the TPU kernel's permuted row/column orders. Code t of
//           group g is the 16-bit window ending at bit (t+1)K of the group's
//           K-word stream; at wi = 0 it reaches back into the last word of
//           group g-1 of the same tile, group 0 into group 7 (tail-biting).
//           Lane L's 8 codes lie in bits [(8(L%4)+1)K - 16, 8(L%4+1)K) of its
//           group's stream, at most 72 bits in 3 words whose places and
//           offset are fixed for the lane: it reads the 3 words of a tile,
//           aligns them with two funnel shifts by its offset, and each code
//           then comes out by a compile-time shift and mask. The masked
//           pattern ((x*mult+add) & 0x8FFF8FFF) ^ 0x3B603B60 is a half2
//           whose halves add in fp16 (the format's canonical value), and two
//           codes' sums round once to bf16 as a bf16x2 pair, exactly as the
//           plain version does (MUL1: the byte sum of x*mult plus 0x6400 is
//           the fp16 operand of one HFMA2 for two codes).
//
//           A block of 8 warps owns 128 output columns (a warp a 16-column
//           tile) and 16 rows (m <= 16, decode: MB = 1) or 128 (MB = 8); more
//           rows run as further blocks (grid.z) that decode again. k is
//           walked in steps of 128 (8 tile rows). The words of a step are
//           staged into shared memory by cp.async, STAGES deep: the copies of
//           step s + STAGES - 1 are in flight while step s decodes. At decode
//           sizes, past the first STAGES - 1 steps, each warp stages the words
//           its own tile reads and waits for them alone (no block barrier);
//           with 128 rows the block stages a step together, one barrier a
//           step. At decode
//           sizes the block's rows of xh for its
//           whole k range are staged once, at the start (the host keeps that
//           range at XH_ONCE_STEPS steps or fewer); with 128 rows each stage
//           also holds its step's rows of xh (two stages). k is split across
//           blocks (grid.y) so that the card holds enough copies in flight:
//           ops/exl3_gemm.py::split_count sizes the split from the card's SM
//           count and the bytes a block keeps in flight. Each split writes its
//           partial sums to ws; the last block of an output tile to arrive
//           (a release-acquire arrival at an atomic counter, as the split-key decode
//           attention kernel merges its splits) adds the splits in split
//           order and writes the tile, so one launch does the whole product
//           and results do not change from run to run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "async_copy.cuh"

// The kernel's launches in this library, counted where they are made, for a
// caller that checks that a product took one device kernel (read through
// exl3_gemm_launches)
static int gemm_launch_count = 0;

namespace {

constexpr int THREADS = 256;  // 8 warps, one 16-column tile each
constexpr int BN = 128;       // output columns per block
constexpr int KC = 128;       // k per staged step
constexpr int KT = KC / 16;   // tile rows per step
constexpr int LDA = 136;      // bf16 per staged xh row of one step: KC + 8 (conflict-free fragments)
constexpr int LDW = 72;       // words per staged (tile row, wi) row: 64 + 8
constexpr int DECODE_MB = 1;  // 16-row blocks a block holds at decode sizes (m <= 16)
constexpr int PREFILL_MB = 8;  // and above: 128 rows
constexpr int DECODE_BLOCKS = 3;   // blocks an SM the decode-size body's launch bounds promise
constexpr int PREFILL_BLOCKS = 2;  // and the 128-row body's
constexpr int GEMM_STAGES = 4;     // word stages at decode sizes
constexpr int PREFILL_STAGES = 2;  // stages of words and xh above
constexpr int XH_ONCE_STEPS = 16;  // k steps whose xh a decode-size block stages at once
static_assert(LDA == KC + 8 && LDW == 64 + 8, "the padded rows");

__device__ __forceinline__ __half2 as_half2(uint32_t u) {
    __half2 h;
    *reinterpret_cast<uint32_t*>(&h) = u;
    return h;
}

// codes c0, c1 (16 bits each) -> their bf16 values as a bf16x2 pair (c0 low)
template <int CB>
__device__ __forceinline__ uint32_t decode_pair(uint32_t c0, uint32_t c1) {
    __half2 y;
    if constexpr (CB == 2) {
        // 0x6400 + the byte sum of x: the fp16 value 1024 + s
        const uint32_t s0 = __dp4a(c0 * 0x83DCD12Du, 0x01010101u, 0x6400u);
        const uint32_t s1 = __dp4a(c1 * 0x83DCD12Du, 0x01010101u, 0x6400u);
        y = __hfma2(as_half2(__byte_perm(s0, s1, 0x5410)), as_half2(0x1EEE1EEEu),
                    as_half2(0xC931C931u));
    } else {
        const uint32_t x0 = CB == 0 ? c0 * 89226354u + 64248484u : c0 * 0xCBAC1FEDu;
        const uint32_t x1 = CB == 0 ? c1 * 89226354u + 64248484u : c1 * 0xCBAC1FEDu;
        const __half2 m0 = as_half2((x0 & 0x8FFF8FFFu) ^ 0x3B603B60u);
        const __half2 m1 = as_half2((x1 & 0x8FFF8FFFu) ^ 0x3B603B60u);
        // each pattern's low half plus its high half, in fp16: one HADD2 a
        // code on the halves where they lie
        y = __halves2half2(__hadd(__low2half(m0), __high2half(m0)),
                           __hadd(__low2half(m1), __high2half(m1)));
    }
    const float2 f = __half22float2(y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x, f.y);
    return *reinterpret_cast<const uint32_t*>(&b);
}

// One lane's 8 codes of a tile from its 3 words (w0 first in the stream),
// aligned by its offset so that the lane's first bit leads: code j is the
// window of 16 bits ending jK + 16 bits after it. Decoded into the two B
// fragments: b[ci] = codes (4ci, 4ci+1), (4ci+2, 4ci+3) as bf16x2 pairs.
template <int K, int CB>
__device__ __forceinline__ void decode_tile(uint32_t w0, uint32_t w1, uint32_t w2, int off,
                                            uint32_t (&b)[2][2]) {
    const uint32_t t0 = __funnelshift_l(w1, w0, off);
    const uint32_t t1 = __funnelshift_l(w2, w1, off);
    const uint32_t t2 = w2 << off;
    uint32_t c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int e = j * K + 16;  // the window's end, from the lane's first bit
        if (e <= 32)
            c[j] = (t0 >> (32 - e)) & 0xFFFFu;
        else if (e <= 64)
            c[j] = __funnelshift_r(t1, t0, 64 - e) & 0xFFFFu;
        else
            c[j] = __funnelshift_r(t2, t1, 96 - e) & 0xFFFFu;
    }
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
        b[ci][0] = decode_pair<CB>(c[4 * ci], c[4 * ci + 1]);
        b[ci][1] = decode_pair<CB>(c[4 * ci + 2], c[4 * ci + 3]);
    }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared memory of a block: STAGES stages of words, then xh: at decode sizes
// (MB = 1) `xrows` rows (8 or 16) of the block's whole k range of `steps`
// steps, else a stage of MB * 16 rows for each stage of words.
__host__ __device__ constexpr int words_stage(int K) { return KT * K * LDW; }
__host__ __device__ constexpr int xh_ld(int MB, int steps) {
    return MB == DECODE_MB ? steps * KC + 8 : LDA;
}
__host__ __device__ constexpr int smem_bytes(int K, int MB, int STAGES, int xrows, int steps) {
    return STAGES * words_stage(K) * 4 +
           (MB == DECODE_MB ? xrows * xh_ld(MB, steps) * 2 : STAGES * MB * 16 * LDA * 2);
}

// Grid (n / 128, splits, ceil(m / (16 MB))); steps_per_split k steps a split.
template <int K, int CB, int MB, int STAGES>
__global__ void __launch_bounds__(THREADS, MB == DECODE_MB ? DECODE_BLOCKS : PREFILL_BLOCKS)
exl3_gemm_kernel(const __nv_bfloat16* __restrict__ xh, const uint32_t* __restrict__ words,
                 float* __restrict__ out, float* ws, int* counters, int m, int k, int n,
                 int steps_per_split) {
    constexpr int WST = words_stage(K);
    constexpr int BM = MB * 16;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int last;
    uint32_t* Ws = reinterpret_cast<uint32_t*>(smem);
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * WST * 4);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int n0 = blockIdx.x * BN, split = blockIdx.y, m0 = blockIdx.z * BM;
    const int rows = min(BM, m - m0);
    const int nmb = (rows + 15) / 16;
    const bool upper = MB > DECODE_MB || rows > 8;  // rows 8..15 of a row block are live
    const int n_words = n / 2;                       // words per (tile row, wi) row
    const int steps = k / KC;
    const int step0 = split * steps_per_split;
    const int nsteps = min(step0 + steps_per_split, steps) - step0;
    const int lda = xh_ld(MB, nsteps);

    // rows of xh past `rows` that the fragments read are zero (never copied)
    if constexpr (MB == DECODE_MB) {
        for (int e = tid; e < ((upper ? 16 : 8) - rows) * lda; e += THREADS)
            As[rows * lda + e] = __float2bfloat16_rn(0.0f);
        // the block's rows of xh over its k range, once
        const int units = nsteps * (KC / 8);  // 16-byte units a row
        for (int e = tid; e < rows * units; e += THREADS) {
            const int r = e / units, u = e % units;
            cp_async<16>(As + r * lda + u * 8,
                         xh + (size_t)(m0 + r) * k + (size_t)step0 * KC + u * 8);
        }
    } else {
        for (int s = 0; s < STAGES; ++s)
            for (int e = tid; e < (nmb * 16 - rows) * LDA; e += THREADS)
                As[(s * BM + rows) * LDA + e] = __float2bfloat16_rn(0.0f);
    }
    // step i of the block into stage i % STAGES: its words (and, with 128
    // rows, its xh); a group is committed in every call, so the waits stay in
    // step. At decode sizes the steps after the first STAGES - 1 are copied
    // by each warp for itself, the 8 words of each (tile row, wi) row that
    // its own 16-column tile reads, so that it waits for its own copies alone
    // and needs no block barrier; the first, in flight together, are copied
    // by the block in whole rows, as the steps of 128 rows always are.
    auto issue = [&](int i) {
        if (i < nsteps) {
            const int step = step0 + i;
            uint32_t* dst = Ws + (i % STAGES) * WST;
            const uint32_t* src = words + (size_t)step * KT * K * n_words + n0 / 2;
            if (MB == DECODE_MB && i >= STAGES - 1) {
                for (int c = lane; c < KT * K * 2; c += 32) {
                    const int row = c / 2, v = warp * 8 + (c % 2) * 4;  // row = tile row * K + wi
                    cp_async<16>(dst + row * LDW + v, src + (size_t)row * n_words + v);
                }
            } else {
                for (int e = tid; e < KT * K * 16; e += THREADS) {
                    const int row = e / 16, v = e % 16;
                    cp_async<16>(dst + row * LDW + v * 4, src + (size_t)row * n_words + v * 4);
                }
                if constexpr (MB != DECODE_MB) {
                    __nv_bfloat16* a = As + (i % STAGES) * BM * LDA;
                    for (int e = tid; e < rows * (KC / 8); e += THREADS) {
                        const int r = e / (KC / 8), v = e % (KC / 8);
                        cp_async<16>(a + r * LDA + v * 8,
                                     xh + (size_t)(m0 + r) * k + (size_t)step * KC + v * 8);
                    }
                }
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) issue(i);

    // the lane's 3 words in a tile's stage and its offset: its codes' bits
    // start s0 bits into its group's stream (before it: the last word of the
    // previous group); words past the stream's end carry bits no code reads
    const int gh = lane >> 2, gl = lane & 3;
    const int s0 = (8 * gl + 1) * K - 16;
    const int wf = (s0 + 32) / 32 - 1;  // s0 >= -15
    const int off = s0 - 32 * wf;
    int wo[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const int wi = wf + i;
        wo[i] = warp * 8 + (wi < 0 ? (K - 1) * LDW + ((gh + 7) & 7) : min(wi, K - 1) * LDW + gh);
    }

    float acc[MB][2][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int ci = 0; ci < 2; ++ci)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mb][ci][i] = 0.0f;

    for (int i = 0; i < nsteps; ++i) {
        cp_async_wait<STAGES - 2>();  // step i has landed
        // for every thread, and step i - 1's stage is free; at decode sizes
        // past the steps the block copied, a warp waits for its own words
        if (MB != DECODE_MB || i < STAGES - 1)
            __syncthreads();
        else
            __syncwarp();
        issue(i + STAGES - 1);
        const uint32_t* wt = Ws + (i % STAGES) * WST;
        const __nv_bfloat16* at = MB == DECODE_MB ? As + i * KC : As + (i % STAGES) * BM * LDA;
#pragma unroll(MB == DECODE_MB ? KT : 2)
        for (int kt = 0; kt < KT; ++kt) {
            const uint32_t* wk = wt + kt * K * LDW;
            uint32_t bf[2][2];
            decode_tile<K, CB>(wk[wo[0]], wk[wo[1]], wk[wo[2]], off, bf);
#pragma unroll
            for (int mb = 0; mb < MB; ++mb) {
                if (mb < nmb) {
                    const __nv_bfloat16* ap =
                        at + (mb * 16 + (lane >> 2)) * lda + kt * 16 + (lane & 3) * 2;
                    uint32_t a[4];
                    a[0] = *reinterpret_cast<const uint32_t*>(ap);
                    a[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
                    a[1] = upper ? *reinterpret_cast<const uint32_t*>(ap + 8 * lda) : 0u;
                    a[3] = upper ? *reinterpret_cast<const uint32_t*>(ap + 8 * lda + 8) : 0u;
                    mma_bf16(acc[mb][0], a, bf[0]);
                    mma_bf16(acc[mb][1], a, bf[1]);
                }
            }
        }
    }

    // the tile's outputs: this thread's (row, column pair) places
    const int splits = gridDim.y;
    float* dst = splits == 1 ? out : ws + (size_t)split * m * n;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
        if (mb < nmb) {
#pragma unroll
            for (int ci = 0; ci < 2; ++ci) {
                const int col = n0 + warp * 16 + ci * 8 + (lane & 3) * 2;
                const int r0 = mb * 16 + (lane >> 2), r1 = r0 + 8;
                if (r0 < rows)
                    *reinterpret_cast<float2*>(&dst[(size_t)(m0 + r0) * n + col]) =
                        make_float2(acc[mb][ci][0], acc[mb][ci][1]);
                if (r1 < rows)
                    *reinterpret_cast<float2*>(&dst[(size_t)(m0 + r1) * n + col]) =
                        make_float2(acc[mb][ci][2], acc[mb][ci][3]);
            }
        }
    }
    if (splits == 1) return;

    // the last split of this output tile to arrive adds the partials in split
    // order and writes the tile: its threads read the tile's rows as float4
    // runs, a run from every split before any add, so the reads are in flight
    // together
    const int tile = blockIdx.z * gridDim.x + blockIdx.x;
    __syncthreads();
    if (tid == 0) last = arrive(counters + tile) == splits - 1;
    __syncthreads();
    if (!last) return;
    const size_t plane = (size_t)m * n;
    for (int e = tid; e < rows * (BN / 4); e += THREADS) {
        const size_t at = (size_t)(m0 + e / (BN / 4)) * n + n0 + (e % (BN / 4)) * 4;
        const float* src = ws + at;
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        int sp = 0;
        for (; sp + 8 <= splits; sp += 8) {
            float4 p[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                p[u] = __ldcg(reinterpret_cast<const float4*>(src + (size_t)(sp + u) * plane));
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                s.x += p[u].x;
                s.y += p[u].y;
                s.z += p[u].z;
                s.w += p[u].w;
            }
        }
        for (; sp < splits; ++sp) {
            const float4 p = __ldcg(reinterpret_cast<const float4*>(src + (size_t)sp * plane));
            s.x += p.x;
            s.y += p.y;
            s.z += p.z;
            s.w += p.w;
        }
        *reinterpret_cast<float4*>(out + at) = s;
    }
    if (tid == 0) counters[tile] = 0;  // ready for the next launch
}

// The body for these widths: MB = 1 in GEMM_STAGES stages up to 16 rows,
// else 128 rows a block in two stages.
template <int MB>
constexpr int stages_of() {
    return MB == DECODE_MB ? GEMM_STAGES : PREFILL_STAGES;
}
template <int K, int CB, int MB>
void prepare() {  // the largest shared memory a launch of this body asks for
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(exl3_gemm_kernel<K, CB, MB, stages_of<MB>()>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(K, MB, stages_of<MB>(), 16, XH_ONCE_STEPS));
        attr_set = true;
    }
}

// The launch's geometry: grid and shared memory, or false for widths it
// does not take.
struct Plan {
    dim3 grid;
    int per = 0, smem = 0;
};
template <int K, int MB>
bool plan(int m, int k, int n, int splits, Plan& p) {
    const int steps = k / KC;
    if (m < 1 || k % KC || n % BN || splits < 1 || splits > steps) return false;
    p.per = (steps + splits - 1) / splits;
    if ((splits - 1) * p.per >= steps) return false;  // a split without a step
    if (MB == DECODE_MB && (m > 16 || p.per > XH_ONCE_STEPS)) return false;
    p.grid = dim3(n / BN, splits, (m + MB * 16 - 1) / (MB * 16));
    p.smem = smem_bytes(K, MB, stages_of<MB>(), m <= 8 ? 8 : 16, p.per);
    return true;
}

template <int K, int CB, int MB>
int launch(const void* xh, const void* words, void* out, void* ws, void* counters, int m, int k,
           int n, int splits, cudaStream_t st) {
    Plan p;
    if (!plan<K, MB>(m, k, n, splits, p) || (splits > 1 && (ws == nullptr || counters == nullptr)))
        return (int)cudaErrorInvalidValue;
    prepare<K, CB, MB>();
    exl3_gemm_kernel<K, CB, MB, stages_of<MB>()><<<p.grid, THREADS, p.smem, st>>>(
        static_cast<const __nv_bfloat16*>(xh), static_cast<const uint32_t*>(words),
        static_cast<float*>(out), static_cast<float*>(ws), static_cast<int*>(counters), m, k, n,
        p.per);
    const int err = (int)cudaGetLastError();
    if (err == 0) ++gemm_launch_count;
    return err;
}

template <int K, int CB, int MB>
int occupancy(int m, int k, int n, int splits) {
    Plan p;
    if (!plan<K, MB>(m, k, n, splits, p)) return -(int)cudaErrorInvalidValue;
    prepare<K, CB, MB>();
    int blocks = 0;
    const int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, exl3_gemm_kernel<K, CB, MB, stages_of<MB>()>, THREADS, p.smem);
    return err ? -err : blocks;
}

// what(K, CB, MB) for the run-time widths
template <template <int, int, int> class F, class... A>
int dispatch(int K, int cb, int m, A... args) {
#define EXL3_CB(KK)                                                                      \
    case KK:                                                                             \
        switch (cb) {                                                                    \
            case 0: return m <= 16 ? F<KK, 0, DECODE_MB>::run(args...)                   \
                                   : F<KK, 0, PREFILL_MB>::run(args...);                 \
            case 1: return m <= 16 ? F<KK, 1, DECODE_MB>::run(args...)                   \
                                   : F<KK, 1, PREFILL_MB>::run(args...);                 \
            case 2: return m <= 16 ? F<KK, 2, DECODE_MB>::run(args...)                   \
                                   : F<KK, 2, PREFILL_MB>::run(args...);                 \
        }                                                                                \
        break;
    switch (K) {
        EXL3_CB(1) EXL3_CB(2) EXL3_CB(3) EXL3_CB(4) EXL3_CB(5) EXL3_CB(6) EXL3_CB(7) EXL3_CB(8)
    }
#undef EXL3_CB
    return -1;
}
template <int K, int CB, int MB>
struct Launch {
    static int run(const void* xh, const void* words, void* out, void* ws, void* counters, int m,
                   int k, int n, int splits, cudaStream_t st) {
        return launch<K, CB, MB>(xh, words, out, ws, counters, m, k, n, splits, st);
    }
};
template <int K, int CB, int MB>
struct Occupancy {
    static int run(int m, int k, int n, int splits) {
        return occupancy<K, CB, MB>(m, k, n, splits);
    }
};

}  // namespace

// `splits` must leave no split without a step: splits <= k / 128 and
// (splits - 1) * ceil(k / 128 / splits) < k / 128; at m <= 16 a split holds
// at most XH_ONCE_STEPS steps. ws and counters may be null for one split.
extern "C" int exl3_gemm(const void* xh, const void* words, void* out, void* ws, void* counters,
                         int m, int k, int n, int K, int cb, int splits, void* stream) {
    const int err = dispatch<Launch>(K, cb, m, xh, words, out, ws, counters, m, k, n, splits,
                                     static_cast<cudaStream_t>(stream));
    return err < 0 ? (int)cudaErrorInvalidValue : err;
}

// Blocks an SM holds of the kernel exl3_gemm launches for these widths
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or a negative CUDA error.
extern "C" int exl3_gemm_blocks_per_sm(int m, int k, int n, int K, int cb, int splits) {
    return dispatch<Occupancy>(K, cb, m, m, k, n, splits);
}

extern "C" int exl3_gemm_launches() { return gemm_launch_count; }
