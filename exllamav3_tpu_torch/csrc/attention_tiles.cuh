// The flash-attention tile loop shared by the port's ten attention entries:
// paged_attention.cu, paged_attention_quant.cu, linear_attention.cu,
// linear_attention_quant.cu, latent_attention.cu and
// latent_attention_quant.cu (absorbed MLA), ring_attention.cu (decode over a
// sliding-window ring), and attention_stats.cu's three DeepSeek-V4 decode
// entries, which return the unnormalised online-softmax state.
//
// The kernel is templated three times over:
//   * Geo: the block's geometry. HeadGeo<D> (per-head K/V of D channels, 64
//     score rows, 64-key tiles, f32 q entering as hi + lo bf16 pairs) and
//     the latent ones (one latent K row of 576 channels whose leading 512
//     are V, bf16 q): LatentGeo, 32 score rows and 32-key tiles, and
//     LatentDecodeGeo, 16 rows (one token's heads) and 64-key tiles, half
//     the tiles a decode block walks; HeadDecodeGeo<D>, HeadGeo's tiles with
//     16 score rows, for one decode token's group of heads; KvRowDecodeGeo,
//     DeepSeek-V4's one 512-wide row that is K and V alike (bf16 q, no rope
//     tail), 16 rows and 64-key tiles.
//   * Rows: where a key tile's rows lie. PagedRows looks the page up in the
//     block table (256-token pages, so a tile never crosses a page and every
//     tile is full); LinearRows reads slot `key` of row b (or of the row the
//     caller names for sequence b) of an (N, T, Hk, .) cache, and cuts the
//     last tile at T, which may be any length: keys at or past T are never
//     read, their tile rows are zero and masked. RingRows reads slot `key`
//     of ring row slots[b] of an (N, W, Hk, .) ring, cuts the last tile at W,
//     and is the one policy whose keys' positions come from an array
//     (POS_FROM_ARRAY): each tile stages its slots' stored positions into
//     shared memory, the mask tests those, and every slot 0..W-1 is walked.
//     PoolRows pages a pool through the token block table with `epp`
//     entries a page (DeepSeek-V4's compressed pools: 256 / 128 = 2), so a
//     64-key tile spans many pages: it is the one policy that GATHERs, each
//     tile staging the pool row of each of its keys into shared memory
//     (-1 for a page out of range, which the mask then hides).
//   * KV: how a tile is stored. Bf16KV copies bf16 rows; QuantKV unpacks
//     packed 2..8-bit words with one bf16 scale per 32 channels (merged-head
//     and per-head storage address head h of a token alike, at word
//     (token * Hk + h) * D*bits/32) into hi + lo bf16 pairs; LatentKV copies
//     a bf16 latent row; LatentQuantKV unpacks the packed latent into hi + lo
//     pairs and copies the bf16 rope key beside it (its lo term is 0);
//     RowKV<W> is LatentKV at any row width W (DeepSeek-V4: 512).
//   * STATS, a flag: the epilogue writes the output unnormalised beside each
//     row's running max m and sum l (the JAX kernel's return_stats), for a
//     caller that merges several key sources with one softmax. A row that
//     sees no key writes (acc, m, l) = (0, -1e30, 0): JAX's NEG_INF start.
//
// Design: one block per (q block, kv head and head slice, sequence). Its R
// score rows are (token, head-in-group) pairs: a block takes HB = min(G, R)
// heads of a group of G and floor(R / HB) tokens, so any group serves; a
// group wider than R (MLA: all q heads read one latent row, G = 16 for
// DeepSeek-V2-Lite, 128 for V2 and V3) is cut into ceil(G / R) head slices,
// one block each. The heads of a block read each K/V tile once. The block
// finds its own keys (the TPU kernel's scalar prefetch) and walks only the
// key tiles between the first and last key any of its rows can see (the TPU
// kernel's per-q-block page bounds). QK^T and PV run as bf16 WMMA with f32
// accumulation; the online softmax keeps its running max, sum and output rows
// in f32 in shared memory. The TPU kernel multiplies q and P in f32, so each
// f32 operand enters as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi),
// one MMA each: the pair holds x to about 2^-16 relative (a bf16 q, as MLA
// hands it over, needs no lo term). A dequantized K/V value (a grid value
// times a bf16 scale, at most 16 significant bits) is also stored as hi +
// lo, exactly; a product then takes three MMAs (hi.hi, lo.hi, hi.lo). The
// row sum adds P in f32. Decode fills few of the rows, and a sequence's keys
// are walked by one block. The bf16 and quantized entries over the paged and
// the linear cache send decode and verify (S * G <= 32 rows a kv head) to
// attention_decode.cuh instead, which splits the keys across blocks and
// merges them; their prefill chunks and the other entries (latent, ring,
// stats) take this loop.
//
// Warps: the 4 warps split the R rows into R/16 row groups; with R = 32 two
// warps (with R = 16 all four) share a row group and split its key subtiles
// (scores) and its output columns (PV), and the softmax, whose rows then
// span warps, sits between two block barriers. With R = 64 each warp owns 16
// rows throughout.
//
// Visibility: key j is visible to a query at position p iff j < total_len,
// j <= p, j lies in the layout (j < T, or within the block table), and, with
// a window, j > p - window. In a ring, key j is the slot's stored position
// pos[j] instead, visible iff 0 <= pos[j] <= p and, with a window,
// pos[j] > p - window (-1 marks a slot never written; a stale speculative
// write holds a future position and masks itself); there is no total_len.
// Scores are scale*q.k, then the softcap; sinks join the denominator. A row
// that sees no key gives 0.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int PAGE = 256;

// A block's geometry: K width D, V (and output) width DV, R score rows, TK
// keys a tile; Q_SPLIT: q is f32 and enters as hi + lo bf16 (else bf16 as it
// is); V_FROM_K: V is the leading DV channels of the K tile.
template <int D_, int DV_, int R_, int TK_, bool Q_SPLIT_, bool V_FROM_K_>
struct Geo {
    static constexpr int D = D_, DV = DV_, R = R_, TK = TK_;
    static constexpr bool Q_SPLIT = Q_SPLIT_, V_FROM_K = V_FROM_K_;
};
template <int D>
using HeadGeo = Geo<D, D, 64, 64, true, false>;
template <int D>
using HeadDecodeGeo = Geo<D, D, 16, 64, true, false>;
// DeepSeek's latent row: kv_lora_rank 512 + qk_rope_head_dim 64
constexpr int LATENT = 512, ROPE = 64;
using LatentGeo = Geo<LATENT + ROPE, LATENT, 32, 32, false, true>;
using LatentDecodeGeo = Geo<LATENT + ROPE, LATENT, 16, 64, false, true>;
// DeepSeek-V4's shared K = V row (head_dim 512, the rope on its trailing 64)
constexpr int KV_ROW = 512;
using KvRowDecodeGeo = Geo<KV_ROW, KV_ROW, 16, 64, false, true>;

// Shared memory of one block. SPLIT: K and V tiles carry a lo term too.
//   HeadGeo<128>: q hi + lo 2 x 64 x 136 bf16, K and V 64 x 136 bf16 each
//     (hi + lo: twice), scores 64 x 68 f32, P hi + lo 2 x 64 x 72 bf16, output
//     64 x 132 f32: 140,296 bytes bf16, 175,112 quantized.
//   LatentGeo: q 32 x 584 bf16 (37,376), one K tile 32 x 584 bf16 (37,376;
//     quantized: hi + lo, 74,752; V is its leading 512 columns), scores
//     32 x 36 f32 (4,608), P hi + lo 2 x 32 x 40 bf16 (5,120), output
//     32 x 516 f32 (66,048), row state 520: 151,048 bytes bf16, 188,424
//     quantized, of the 232,448 a block may have.
//   LatentDecodeGeo: q 16 x 584 bf16 (18,688), one K tile 64 x 584 bf16
//     (74,752; quantized 149,504), scores 16 x 68 f32 (4,352), P hi + lo
//     2 x 16 x 72 bf16 (4,608), output 16 x 516 f32 (33,024), row state 264:
//     135,688 bytes bf16, 210,440 quantized.
//   HeadDecodeGeo<128> over a ring: q hi + lo 2 x 16 x 136 bf16, K and V
//     64 x 136 bf16 each, scores 16 x 68 f32, P hi + lo 2 x 16 x 72 bf16,
//     output 16 x 132 f32, row state 264, and the tile's 64 slot positions
//     (POS): 61,448 bytes.
//   KvRowDecodeGeo: q 16 x 520 bf16 (16,640), one K tile 64 x 520 bf16
//     (66,560; V is the same tile), scores 16 x 68 f32 (4,352), P hi + lo
//     2 x 16 x 72 bf16 (4,608), output 16 x 516 f32 (33,024), row state 264:
//     125,448 bytes, plus 256 over a ring (POS) or 512 over a pool (GATHER:
//     the tile's 64 pool rows as int64).
template <class G_, bool SPLIT, bool POS = false, bool GATHER = false>
struct Layout {
    static constexpr int D = G_::D, DV = G_::DV, R = G_::R, TK = G_::TK;
    static constexpr int LDQ = D + 8, LDK = D + 8, LDS = TK + 4, LDP = TK + 8, LDO = DV + 4;
    static constexpr int KV_TILE = TK * LDK * 2;
    static constexpr int OFF_Q = 0;
    static constexpr int OFF_QL = OFF_Q + R * LDQ * 2;
    static constexpr int OFF_K = OFF_QL + (G_::Q_SPLIT ? R * LDQ * 2 : 0);
    static constexpr int OFF_KL = OFF_K + KV_TILE;
    static constexpr int OFF_V = OFF_KL + (SPLIT ? KV_TILE : 0);
    static constexpr int OFF_VL = OFF_V + (G_::V_FROM_K ? 0 : KV_TILE);
    static constexpr int OFF_S = OFF_VL + (SPLIT && !G_::V_FROM_K ? KV_TILE : 0);
    static constexpr int OFF_P = OFF_S + R * LDS * 4;
    static constexpr int OFF_PL = OFF_P + R * LDP * 2;
    static constexpr int OFF_O = OFF_PL + R * LDP * 2;
    static constexpr int OFF_ROWS = OFF_O + R * LDO * 4;
    static constexpr int OFF_KPOS = OFF_ROWS + R * 4 * 4 + 2 * 4;
    static constexpr int OFF_TOK = (OFF_KPOS + (POS ? TK * 4 : 0) + 15) / 16 * 16;
    static constexpr int BYTES = GATHER ? OFF_TOK + TK * 8 : OFF_KPOS + (POS ? TK * 4 : 0);
};

// -- where a tile's rows lie -----------------------------------------------------

struct PagedRows {
    static constexpr bool FULL = true;  // every tile holds TK keys
    static constexpr bool POS_FROM_ARRAY = false;  // key j sits at position j
    static constexpr bool GATHER = false;  // a tile's rows are one contiguous run
    const int* bt;  // (B, MP) block tables
    int MP, P;
    __device__ int key_limit() const { return MP * PAGE; }
    // false: the tile's page is out of range and the tile is skipped
    // (uniform across the block). Else the tile's first pool row and its
    // count of keys. TKT divides the page.
    template <int TKT>
    __device__ bool tile(int b, int key0, size_t& tok0, int& n) const {
        const int page = bt[(size_t)b * MP + key0 / PAGE];
        if (page < 0 || page >= P) return false;
        tok0 = (size_t)page * PAGE + key0 % PAGE;
        n = TKT;
        return true;
    }
};

struct LinearRows {
    static constexpr bool FULL = false;  // the last tile is cut at T
    static constexpr bool POS_FROM_ARRAY = false;
    static constexpr bool GATHER = false;
    const int* rows;  // (B,) cache row of each sequence, or null: row b
    int N, T;         // cache rows; keys per row
    __device__ int key_limit() const { return T; }
    // false: the sequence's row is out of range and the tile is skipped
    template <int TKT>
    __device__ bool tile(int b, int key0, size_t& tok0, int& n) const {
        const int row = rows != nullptr ? rows[b] : b;
        if (row < 0 || row >= N) return false;
        tok0 = (size_t)row * T + key0;
        n = min(TKT, T - key0);
        return true;
    }
};

struct RingRows {
    static constexpr bool FULL = false;  // the last tile is cut at W
    static constexpr bool POS_FROM_ARRAY = true;  // positions from `pos`
    static constexpr bool GATHER = false;
    const int* slots;  // (B,) ring row of each sequence
    const int* pos;    // (N, W) position each slot holds, -1 = never written
    int N, W;          // ring rows; slots a row
    __device__ int key_limit() const { return W; }
    // false: the sequence's ring row is out of range and the tile is skipped
    template <int TKT>
    __device__ bool tile(int b, int key0, size_t& tok0, int& n) const {
        const int row = slots[b];
        if (row < 0 || row >= N) return false;
        tok0 = (size_t)row * W + key0;
        n = min(TKT, W - key0);
        return true;
    }
    // the stored positions of the tile's n slots into dst[0, TKT); -1 past n
    template <int TKT>
    __device__ void stage_pos(size_t tok0, int n, int* dst, int tid) const {
        for (int j = tid; j < TKT; j += THREADS) dst[j] = j < n ? __ldg(pos + tok0 + j) : -1;
    }
};

// A pool of `epp` entries a page, paged through the token block table: key
// j of sequence b is entry j % epp of page bt[b, j / epp]. Pages hold fewer
// entries than a tile, so each row is found on its own (GATHER).
struct PoolRows {
    static constexpr bool FULL = false;  // the last tile is cut at MP * epp
    static constexpr bool POS_FROM_ARRAY = false;
    static constexpr bool GATHER = true;
    const int* bt;  // (B, MP) block tables
    int MP, P, epp;
    __device__ int key_limit() const { return MP * epp; }
    template <int TKT>
    __device__ bool tile(int, int key0, size_t& tok0, int& n) const {
        tok0 = 0;
        n = min(TKT, MP * epp - key0);
        return true;
    }
    // the pool row (page * epp + slot) of each of the tile's n keys into
    // dst[0, TKT); -1 past n and for a page out of range
    template <int TKT>
    __device__ void stage_rows(int b, int key0, int n, long long* dst, int tid) const {
        for (int j = tid; j < TKT; j += THREADS) {
            long long row = -1;
            if (j < n) {
                const int key = key0 + j;
                const int page = __ldg(bt + (size_t)b * MP + key / epp);
                if (page >= 0 && page < P) row = (long long)page * epp + key % epp;
            }
            dst[j] = row;
        }
    }
};

// -- how a tile is stored -----------------------------------------------------------

// n <= TKT rows of W bf16 channels, row j at src + ((tok0 + j) * Hk + hk) * W,
// into dst columns [0, W) of rows of LD; rows n.. are zero
template <int W, int LD, int TKT>
__device__ __forceinline__ void copy_rows(const __nv_bfloat16* __restrict__ src, size_t tok0,
                                          int n, int Hk, int hk, __nv_bfloat16* dst, int tid) {
    constexpr int VPR = W / 8;  // 16-byte vectors per row
    for (int e = tid; e < TKT * VPR; e += THREADS) {
        const int j = e / VPR, c = (e % VPR) * 8;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (j < n) x = __ldg(reinterpret_cast<const uint4*>(src + ((tok0 + j) * Hk + hk) * W + c));
        *reinterpret_cast<uint4*>(&dst[j * LD + c]) = x;
    }
}

template <int D>
struct Bf16KV {
    static constexpr bool SPLIT = false;
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    int Hk;
    // rows tok0 .. tok0+n-1 of head hk into the tiles; rows n.. are zero
    template <int LD, int TKT>
    __device__ void load(size_t tok0, int n, int hk, __nv_bfloat16* Ks, __nv_bfloat16*,
                         __nv_bfloat16* Vs, __nv_bfloat16*, int tid) const {
        copy_rows<D, LD, TKT>(k, tok0, n, Hk, hk, Ks, tid);
        copy_rows<D, LD, TKT>(v, tok0, n, Hk, hk, Vs, tid);
    }
};

// Field of channel c (0..D-1) of one head's packed words.
template <int D, int BITS>
__device__ __forceinline__ uint32_t field(const uint32_t* __restrict__ w, int c) {
    if constexpr (BITS == 2 || BITS == 4 || BITS == 8) {
        // one bit stream per group of 32 channels, BITS words long
        const int off = (c & 31) * BITS;
        return (__ldg(w + (c >> 5) * BITS + (off >> 5)) >> (off & 31)) & ((1u << BITS) - 1u);
    } else {
        // bit planes, largest first, each packed in lane order: channel
        // 32*group + w*J + j sits at lane p = j*(G*PB0) + group*PB0 + w, and
        // plane i keeps lane p in word p % (G*PBi) at field p / (G*PBi)
        constexpr int G = D / 32;
        constexpr int PB0 = BITS == 3 ? 2 : 4;
        constexpr int PB1 = (BITS == 3 || BITS == 5) ? 1 : 2;
        constexpr int PB2 = BITS == 7 ? 1 : 0;
        constexpr int J = 32 / PB0;
        const int i = c & 31, group = c >> 5;
        const int p = (i % J) * (G * PB0) + group * PB0 + i / J;
        uint32_t v = (__ldg(w + p % (G * PB0)) >> ((p / (G * PB0)) * PB0)) & ((1u << PB0) - 1u);
        v |= ((__ldg(w + G * PB0 + p % (G * PB1)) >> ((p / (G * PB1)) * PB1))
              & ((1u << PB1) - 1u)) << PB0;
        if constexpr (PB2 > 0)
            v |= ((__ldg(w + G * (PB0 + PB1) + p % (G * PB2)) >> ((p / (G * PB2)) * PB2))
                  & ((1u << PB2) - 1u)) << (PB0 + PB1);
        return v;
    }
}

// Unpack n <= TKT keys of one head, starting at token row `tok0` of the
// storage, into hi and lo bf16 tiles of LD columns; rows n.. are zero. A
// thread takes 8 consecutive channels of one key: it reads the words that
// hold them straight from device memory (neighbouring threads read
// neighbouring words), takes the field of each channel, maps it to the
// midpoint grid ((2q+1)/N - 1) or through the compander t*(a + (1-a)t^2),
// and multiplies by the group's scale. Each field goes to its true channel:
// the JAX kernel's channel permutation served the TPU's repeat-widen unpack
// and is left out, except that odd widths are stored as bit planes in lane
// order, which field() follows. K and V stay in their stored, rotated basis.
template <int D, int LD, int TKT, int BITS>
__device__ __forceinline__ void unpack_tile(const uint32_t* __restrict__ words,
                                            const __nv_bfloat16* __restrict__ scales,
                                            size_t tok0, int n, int Hk, int hk, float ca, float cb,
                                            __nv_bfloat16* hi_s, __nv_bfloat16* lo_s, int tid) {
    constexpr int W = D * BITS / 32, G = D / 32, RUNS = D / 8, N = 1 << BITS;
    for (int e = tid; e < TKT * RUNS; e += THREADS) {
        const int j = e / RUNS, c0 = (e % RUNS) * 8;
        __align__(16) __nv_bfloat16 hi[8], lo[8];
        if (j < n) {
            const size_t th = (tok0 + j) * Hk + hk;
            const uint32_t* w = words + th * W;
            const float sc = __bfloat162float(scales[th * G + (c0 >> 5)]);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int f = (int)field<D, BITS>(w, c0 + i);
                float t = (float)(2 * f + 1 - N) * (1.0f / N);
                if (ca > 0.0f)  // t*(a + (1-a)*t*t), in the plain version's order
                    t = __fmul_rn(t, __fadd_rn(ca, __fmul_rn(__fmul_rn(cb, t), t)));
                const float x = __fmul_rn(t, sc);
                hi[i] = __float2bfloat16_rn(x);
                lo[i] = __float2bfloat16_rn(x - __bfloat162float(hi[i]));
            }
        } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) hi[i] = lo[i] = __float2bfloat16_rn(0.0f);
        }
        *reinterpret_cast<uint4*>(&hi_s[j * LD + c0]) = *reinterpret_cast<const uint4*>(hi);
        *reinterpret_cast<uint4*>(&lo_s[j * LD + c0]) = *reinterpret_cast<const uint4*>(lo);
    }
}

template <int D, int LD, int TKT>
__device__ __forceinline__ void unpack_any(int bits, const uint32_t* __restrict__ words,
                                           const __nv_bfloat16* __restrict__ scales, size_t tok0,
                                           int n, int Hk, int hk, float ca, float cb,
                                           __nv_bfloat16* hi_s, __nv_bfloat16* lo_s, int tid) {
#define EXL3_UNPACK(B) unpack_tile<D, LD, TKT, B>(words, scales, tok0, n, Hk, hk, ca, cb, hi_s, lo_s, tid)
    switch (bits) {  // uniform across the grid
        case 2: EXL3_UNPACK(2); break;
        case 3: EXL3_UNPACK(3); break;
        case 4: EXL3_UNPACK(4); break;
        case 5: EXL3_UNPACK(5); break;
        case 6: EXL3_UNPACK(6); break;
        case 7: EXL3_UNPACK(7); break;
        default: EXL3_UNPACK(8); break;
    }
#undef EXL3_UNPACK
}

template <int D>
struct QuantKV {
    static constexpr bool SPLIT = true;
    const uint32_t* kq;
    const __nv_bfloat16* ks;
    const uint32_t* vq;
    const __nv_bfloat16* vs;
    int Hk, k_bits, v_bits;
    float ca, cb;  // compander a and 1 - a; ca = 0 selects the midpoint grid
    template <int LD, int TKT>
    __device__ void load(size_t tok0, int n, int hk, __nv_bfloat16* Ks, __nv_bfloat16* Kls,
                         __nv_bfloat16* Vs, __nv_bfloat16* Vls, int tid) const {
        unpack_any<D, LD, TKT>(k_bits, kq, ks, tok0, n, Hk, hk, ca, cb, Ks, Kls, tid);
        unpack_any<D, LD, TKT>(v_bits, vq, vs, tok0, n, Hk, hk, ca, cb, Vs, Vls, tid);
    }
};

// bf16 rows of W channels, one per token, that are K and V alike: MLA's
// latent rows [c_kv | k_pe] (W = 576, V the leading 512) and DeepSeek-V4's
// 512-wide rows. V is read from the K tile.
template <int W>
struct RowKV {
    static constexpr bool SPLIT = false;
    const __nv_bfloat16* kv;  // (N, T, 1, W)
    template <int LD, int TKT>
    __device__ void load(size_t tok0, int n, int, __nv_bfloat16* Ks, __nv_bfloat16*,
                         __nv_bfloat16*, __nv_bfloat16*, int tid) const {
        copy_rows<W, LD, TKT>(kv, tok0, n, 1, 0, Ks, tid);
    }
    // row toks[j] of the storage into tile row j; zero where toks[j] < 0
    template <int LD, int TKT>
    __device__ void load_gather(const long long* toks, __nv_bfloat16* Ks, int tid) const {
        constexpr int VPR = W / 8;
        for (int e = tid; e < TKT * VPR; e += THREADS) {
            const int j = e / VPR, c = (e % VPR) * 8;
            const long long t = toks[j];
            uint4 x = make_uint4(0u, 0u, 0u, 0u);
            if (t >= 0) x = __ldg(reinterpret_cast<const uint4*>(kv + (size_t)t * W + c));
            *reinterpret_cast<uint4*>(&Ks[j * LD + c]) = x;
        }
    }
};
using LatentKV = RowKV<LATENT + ROPE>;

// packed latent words (LATENT * bits / 32 a token) with one bf16 scale per 32
// channels, and the bf16 rope key (ROPE a token) stored apart. The latent
// unpacks into hi + lo columns [0, LATENT), the rope key copies into hi
// columns [LATENT, LATENT + ROPE), whose lo columns are 0
struct LatentQuantKV {
    static constexpr bool SPLIT = true;
    const uint32_t* kq;
    const __nv_bfloat16* ks;
    const __nv_bfloat16* kpe;
    int bits;
    float ca, cb;  // compander a and 1 - a; ca = 0 selects the midpoint grid
    template <int LD, int TKT>
    __device__ void load(size_t tok0, int n, int, __nv_bfloat16* Ks, __nv_bfloat16* Kls,
                         __nv_bfloat16*, __nv_bfloat16*, int tid) const {
        unpack_any<LATENT, LD, TKT>(bits, kq, ks, tok0, n, 1, 0, ca, cb, Ks, Kls, tid);
        copy_rows<ROPE, LD, TKT>(kpe, tok0, n, 1, 0, Ks + LATENT, tid);
        for (int e = tid; e < TKT * (ROPE / 8); e += THREADS) {
            const int j = e / (ROPE / 8), c = (e % (ROPE / 8)) * 8;
            *reinterpret_cast<uint4*>(&Kls[j * LD + LATENT + c]) = make_uint4(0u, 0u, 0u, 0u);
        }
    }
};

// -- the kernel ----------------------------------------------------------------------

template <class G_, class Rows, class KV, bool STATS>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const void* __restrict__ q, Rows rows, KV kv, const int* __restrict__ qpos,
                 const int* __restrict__ total_lens, const float* __restrict__ sinks,
                 float* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                 int S, int Hq, int Hk, float scale, int window, float softcap) {
    constexpr int D = G_::D, DV = G_::DV, R = G_::R, TK = G_::TK;
    constexpr bool SPLIT = KV::SPLIT, QS = G_::Q_SPLIT, RING = Rows::POS_FROM_ARRAY;
    constexpr bool GATHER = Rows::GATHER;
    constexpr int NWR = R / 16;          // row groups of 16
    constexpr int WPR = WARPS / NWR;     // warps sharing a row group
    constexpr int TPR = THREADS / R;     // softmax threads a row
    constexpr int KPT = TK / TPR;        // keys a softmax thread
    static_assert(NWR * WPR == WARPS && TPR * R == THREADS && KPT * TPR == TK, "geometry");
    static_assert(D % 16 == 0 && DV % 16 == 0 && TK % 16 == 0 && PAGE % TK == 0, "geometry");
    using L = Layout<G_, SPLIT, RING, GATHER>;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_Q);
    __nv_bfloat16* Qls = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_QL);
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_K);
    __nv_bfloat16* Kls = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_KL);
    __nv_bfloat16* Vs = G_::V_FROM_K ? Ks : reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_V);
    __nv_bfloat16* Vls = G_::V_FROM_K ? Kls : reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_VL);
    float* Ss = reinterpret_cast<float*>(smem + L::OFF_S);
    __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_P);
    __nv_bfloat16* Pls = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_PL);
    float* Os = reinterpret_cast<float*>(smem + L::OFF_O);
    float* row_m = reinterpret_cast<float*>(smem + L::OFF_ROWS);
    float* row_l = row_m + R;
    float* row_alpha = row_l + R;
    int* row_pos = reinterpret_cast<int*>(row_alpha + R);
    int* key_range = row_pos + R;
    int* key_pos = reinterpret_cast<int*>(smem + L::OFF_KPOS);  // RING: the tile's positions
    long long* key_tok = reinterpret_cast<long long*>(smem + L::OFF_TOK);  // GATHER: its rows

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int b = blockIdx.z;
    const int G = Hq / Hk;
    const int HB = min(G, R);            // heads of the group in this block
    const int NH = (G + HB - 1) / HB;    // head slices of a group
    const int hk = blockIdx.y / NH, slice = blockIdx.y % NH;
    const int QT = R / HB;               // tokens in this block
    const int s0 = blockIdx.x * QT;
    const int limit = rows.key_limit();
    int total = limit;  // a ring has no length: its stored positions decide
    if constexpr (!RING) total = min(total_lens[b], limit);
    // row r -> token s, q head `head`; false for a padding row
    auto row_of = [&](int r, int& s, int& head) {
        const int t = r / HB, gh = slice * HB + r % HB;
        s = s0 + t;
        head = hk * G + gh;
        return t < QT && s < S && gh < G;
    };

    for (int r = tid; r < R; r += THREADS) {
        int s, head;
        const bool valid = row_of(r, s, head);
        row_pos[r] = valid ? qpos[(size_t)b * S + s] : -1;
        const bool sink = valid && sinks != nullptr;
        row_m[r] = sink ? sinks[head] : -INFINITY;
        row_l[r] = sink ? 1.0f : 0.0f;
    }
    constexpr int VPR = D / 8;  // 16-byte vectors of bf16 per row
    for (int e = tid; e < R * VPR; e += THREADS) {
        const int r = e / VPR, c = (e % VPR) * 8;
        int s, head;
        const bool valid = row_of(r, s, head);
        const size_t off = (((size_t)b * S + s) * Hq + head) * D + c;
        if constexpr (QS) {  // f32 q rows as hi + lo bf16
            float x[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            if (valid) {
                const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(q) + off);
                const float4 a = src[0], b4 = src[1];
                x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
                x[4] = b4.x; x[5] = b4.y; x[6] = b4.z; x[7] = b4.w;
            }
            __align__(16) __nv_bfloat16 hi[8], lo[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                hi[i] = __float2bfloat16_rn(x[i]);
                lo[i] = __float2bfloat16_rn(x[i] - __bfloat162float(hi[i]));
            }
            *reinterpret_cast<uint4*>(&Qs[r * L::LDQ + c]) = *reinterpret_cast<const uint4*>(hi);
            *reinterpret_cast<uint4*>(&Qls[r * L::LDQ + c]) = *reinterpret_cast<const uint4*>(lo);
        } else {  // bf16 q rows as they are
            uint4 x = make_uint4(0u, 0u, 0u, 0u);
            if (valid) x = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(q) + off);
            *reinterpret_cast<uint4*>(&Qs[r * L::LDQ + c]) = x;
        }
    }
    for (int e = tid; e < R * DV; e += THREADS) Os[(e / DV) * L::LDO + e % DV] = 0.0f;
    __syncthreads();
    if (tid == 0) {  // keys any row of this block can see: [lo, hi]
        int lo = INT32_MAX, hi = -1;
        for (int r = 0; r < R; ++r) {
            const int p = row_pos[r];
            if (p < 0) continue;
            if constexpr (RING) {  // any slot may hold a visible position
                lo = 0;
                hi = limit - 1;
            } else {
                hi = max(hi, min(p, total - 1));
                lo = min(lo, window > 0 ? max(p - window + 1, 0) : 0);
            }
        }
        key_range[0] = lo;
        key_range[1] = min(hi, limit - 1);
    }
    __syncthreads();
    const int lo = key_range[0], hi = key_range[1];
    const int rw = (warp % NWR) * 16;  // this warp's row group
    const int wc = WPR == 1 ? 0 : warp / NWR;  // and its share of the group's work

    for (int key0 = (lo / TK) * TK; key0 <= hi; key0 += TK) {
        size_t tok0;
        int n;
        if (!rows.template tile<TK>(b, key0, tok0, n)) continue;  // uniform across the block
        if constexpr (GATHER) {
            rows.template stage_rows<TK>(b, key0, n, key_tok, tid);
            __syncthreads();
            kv.template load_gather<L::LDK, TK>(key_tok, Ks, tid);
        } else {
            // a constant count for full tiles, so that their loads carry no bound check
            kv.template load<L::LDK, TK>(tok0, Rows::FULL ? TK : n, hk, Ks, Kls, Vs, Vls, tid);
        }
        if constexpr (RING) rows.template stage_pos<TK>(tok0, n, key_pos, tid);
        __syncthreads();

        // scores for this warp's 16 rows x its 16-key subtiles
#pragma unroll
        for (int j = wc; j < TK / 16; j += WPR) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
            wmma::fill_fragment(sc, 0.0f);
#pragma unroll
            for (int kk = 0; kk < D; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
                wmma::load_matrix_sync(fb, &Ks[(j * 16) * L::LDK + kk], L::LDK);
                wmma::load_matrix_sync(fa, &Qs[rw * L::LDQ + kk], L::LDQ);
                wmma::mma_sync(sc, fa, fb, sc);
                if constexpr (QS) {
                    wmma::load_matrix_sync(fa, &Qls[rw * L::LDQ + kk], L::LDQ);
                    wmma::mma_sync(sc, fa, fb, sc);
                }
                if constexpr (SPLIT) {
                    wmma::load_matrix_sync(fb, &Kls[(j * 16) * L::LDK + kk], L::LDK);
                    wmma::load_matrix_sync(fa, &Qs[rw * L::LDQ + kk], L::LDQ);
                    wmma::mma_sync(sc, fa, fb, sc);
                }
            }
            wmma::store_matrix_sync(&Ss[rw * L::LDS + j * 16], sc, L::LDS, wmma::mem_row_major);
        }
        if constexpr (WPR == 1) __syncwarp(); else __syncthreads();

        // online softmax: TPR consecutive threads a row, KPT keys each
        {
            const int r = tid / TPR, part = tid % TPR;
            const int p = row_pos[r];
            float* srow = &Ss[r * L::LDS + part * KPT];
            float mx = -INFINITY;
            for (int jj = 0; jj < KPT; ++jj) {
                float s = srow[jj] * scale;
                if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
                bool ok;
                if constexpr (RING) {
                    const int kp = key_pos[part * KPT + jj];
                    ok = p >= 0 && kp >= 0 && kp <= p && (window <= 0 || kp > p - window);
                } else {
                    const int key = key0 + part * KPT + jj;
                    ok = p >= 0 && key < total && key <= p && (window <= 0 || key > p - window);
                    if constexpr (GATHER) ok = ok && key_tok[part * KPT + jj] >= 0;
                }
                s = ok ? s : -INFINITY;
                srow[jj] = s;
                mx = fmaxf(mx, s);
            }
#pragma unroll
            for (int o = 1; o < TPR; o *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_old = row_m[r];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.0f;
            __nv_bfloat16* prow = &Ps[r * L::LDP + part * KPT];
            __nv_bfloat16* plrow = &Pls[r * L::LDP + part * KPT];
            for (int jj = 0; jj < KPT; ++jj) {
                const float s = srow[jj];
                const float pf = s == -INFINITY ? 0.0f : expf(s - m_new);
                const __nv_bfloat16 pb = __float2bfloat16_rn(pf);
                prow[jj] = pb;
                plrow[jj] = __float2bfloat16_rn(pf - __bfloat162float(pb));
                sum += pf;
            }
#pragma unroll
            for (int o = 1; o < TPR; o *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            const float alpha = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
            __syncwarp();
            if (part == 0) {
                row_m[r] = m_new;
                row_l[r] = row_l[r] * alpha + sum;
                row_alpha[r] = alpha;
            }
        }
        if constexpr (WPR == 1) __syncwarp(); else __syncthreads();

        // O = alpha O + P V for this warp's rows and 16-column blocks
#pragma unroll
        for (int dcol = wc * 16; dcol < DV; dcol += WPR * 16) {
            for (int e = lane; e < 16 * 16; e += 32) {
                const int r = rw + e / 16;
                Os[r * L::LDO + dcol + e % 16] *= row_alpha[r];
            }
            __syncwarp();
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
            wmma::load_matrix_sync(o, &Os[rw * L::LDO + dcol], L::LDO, wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < TK; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
                wmma::load_matrix_sync(fb, &Vs[kk * L::LDK + dcol], L::LDK);
                wmma::load_matrix_sync(fa, &Ps[rw * L::LDP + kk], L::LDP);
                wmma::mma_sync(o, fa, fb, o);
                wmma::load_matrix_sync(fa, &Pls[rw * L::LDP + kk], L::LDP);
                wmma::mma_sync(o, fa, fb, o);
                if constexpr (SPLIT) {
                    wmma::load_matrix_sync(fb, &Vls[kk * L::LDK + dcol], L::LDK);
                    wmma::load_matrix_sync(fa, &Ps[rw * L::LDP + kk], L::LDP);
                    wmma::mma_sync(o, fa, fb, o);
                }
            }
            wmma::store_matrix_sync(&Os[rw * L::LDO + dcol], o, L::LDO, wmma::mem_row_major);
        }
        __syncthreads();  // K/V tiles and row state are overwritten next
    }

    for (int e = tid; e < R * DV; e += THREADS) {
        const int r = e / DV, c = e % DV;
        int s, head;
        if (row_of(r, s, head)) {
            const float o = Os[r * L::LDO + c];
            out[(((size_t)b * S + s) * Hq + head) * DV + c] =
                STATS ? o : o / fmaxf(row_l[r], 1e-30f);
        }
    }
    if constexpr (STATS) {  // a row that saw no key keeps m = -inf: JAX's NEG_INF start
        for (int r = tid; r < R; r += THREADS) {
            int s, head;
            if (row_of(r, s, head)) {
                const size_t i = ((size_t)b * S + s) * Hq + head;
                m_out[i] = row_m[r] == -INFINITY ? -1e30f : row_m[r];
                l_out[i] = row_l[r];
            }
        }
    }
}

// Launch on `st`; returns cudaGetLastError() as an int. STATS: `out` takes the
// unnormalised output and m_out, l_out (B, S, Hq) f32 each row's max and sum.
template <class G_, class Rows, class KV, bool STATS = false>
int launch_attention(const void* q, Rows rows, KV kv, const void* qpos, const void* total_lens,
                     const void* sinks, void* out, int B, int S, int Hq, int Hk, float scale,
                     int window, float softcap, cudaStream_t st, void* m_out = nullptr,
                     void* l_out = nullptr) {
    constexpr int BYTES = Layout<G_, KV::SPLIT, Rows::POS_FROM_ARRAY, Rows::GATHER>::BYTES;
    static_assert(BYTES <= 232448, "shared memory of one block");
    if (STATS && (m_out == nullptr || l_out == nullptr)) return (int)cudaErrorInvalidValue;
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(attention_kernel<G_, Rows, KV, STATS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
        attr_set = true;
    }
    if (Hk <= 0 || Hq % Hk) return (int)cudaErrorInvalidValue;
    const int G = Hq / Hk, HB = G < G_::R ? G : G_::R;
    const int QT = G_::R / HB, NH = (G + HB - 1) / HB;
    dim3 grid((S + QT - 1) / QT, Hk * NH, B);
    attention_kernel<G_, Rows, KV, STATS><<<grid, THREADS, BYTES, st>>>(
        q, rows, kv, static_cast<const int*>(qpos), static_cast<const int*>(total_lens),
        static_cast<const float*>(sinks), static_cast<float*>(out), static_cast<float*>(m_out),
        static_cast<float*>(l_out), S, Hq, Hk, scale, window, softcap);
    return (int)cudaGetLastError();
}

}  // namespace
