// The flash-attention tile loop of ring_attention.cu (decode over a
// sliding-window ring, groups of more than 32 heads); and the key layouts
// (Rows) and storages (KV) that the decode and prefill bodies of
// attention_decode.cuh, attention_prefill.cuh, latent_decode.cuh and
// latent_prefill.cuh share with it.
//
// The kernel is templated three times over:
//   * Geo: the block's geometry. HeadDecodeGeo<D> (per-head K/V of D
//     channels, 16 score rows for one decode token's group of heads, 64-key
//     tiles, f32 q entering as hi + lo bf16 pairs).
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
//     tile spans many pages; only latent_decode.cuh takes it. RingRows and
//     PoolRows are TABLE layouts there: key_row finds each key's storage row,
//     or -1 where the key is hidden.
//   * KV: how a tile is stored. Bf16KV copies bf16 rows. QuantKV (packed
//     2..8-bit words with one bf16 scale per 32 channels; merged-head and
//     per-head storage address head h of a token alike, at word (token * Hk
//     + h) * D*bits/32) is defined here for the decode and prefill bodies,
//     which stage and unpack it themselves.
//
// Design: one block per (q block, kv head and head slice, sequence). Its R
// score rows are (token, head-in-group) pairs: a block takes HB = min(G, R)
// heads of a group of G and floor(R / HB) tokens, so any group serves; a
// group wider than R is cut into ceil(G / R) head slices, one block each. The heads of a block read each K/V tile once. The block
// finds its own keys (the TPU kernel's scalar prefetch) and walks only the
// key tiles between the first and last key any of its rows can see (the TPU
// kernel's per-q-block page bounds). QK^T and PV run as bf16 WMMA with f32
// accumulation; the online softmax keeps its running max, sum and output rows
// in f32 in shared memory. The TPU kernel multiplies q and P in f32, so each
// f32 operand enters as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi),
// one MMA each: the pair holds x to about 2^-16 relative. The row sum adds P
// in f32.
// Decode fills few of the rows, and a sequence's keys are walked by one
// block. The ring entry sends groups of up to 32 heads to attention_decode.cuh,
// which splits the keys across blocks and merges them. The paged and linear
// entries, bf16 and quantized, take attention_decode.cuh and
// attention_prefill.cuh (128 rows a block on warpgroup MMAs), the latent
// entries latent_decode.cuh and latent_prefill.cuh (64 rows a block on
// warpgroup MMAs), the stats entries latent_decode.cuh, and not this loop;
// the ring's wider groups take it.
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

// The tile loop's launches in this library, counted where they are made (read
// through exl3_tile_launches; one definition across the sources that include
// this header).
inline int tile_launch_count = 0;
extern "C" __attribute__((weak)) int exl3_tile_launches() { return tile_launch_count; }

namespace {

using namespace nvcuda;

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int PAGE = 256;

// A block's geometry: K and V width D, R score rows, TK keys a tile; q is f32
// and enters as hi + lo bf16.
template <int D_, int R_, int TK_>
struct Geo {
    static constexpr int D = D_, DV = D_, R = R_, TK = TK_;
};
template <int D>
using HeadDecodeGeo = Geo<D, 16, 64>;
// DeepSeek's latent row (latent_decode.cuh, latent_prefill.cuh): kv_lora_rank
// 512 + qk_rope_head_dim 64
constexpr int LATENT = 512, ROPE = 64;

// Shared memory of one block.
//   HeadDecodeGeo<128> over a ring: q hi + lo 2 x 16 x 136 bf16, K and V
//     64 x 136 bf16 each, scores 16 x 68 f32, P hi + lo 2 x 16 x 72 bf16,
//     output 16 x 132 f32, row state 264, and the tile's 64 slot positions
//     (POS): 61,448 bytes.
template <class G_, bool POS = false>
struct Layout {
    static constexpr int D = G_::D, DV = G_::DV, R = G_::R, TK = G_::TK;
    static constexpr int LDQ = D + 8, LDK = D + 8, LDS = TK + 4, LDP = TK + 8, LDO = DV + 4;
    static constexpr int KV_TILE = TK * LDK * 2;
    static constexpr int OFF_Q = 0;
    static constexpr int OFF_QL = OFF_Q + R * LDQ * 2;
    static constexpr int OFF_K = OFF_QL + R * LDQ * 2;
    static constexpr int OFF_V = OFF_K + KV_TILE;
    static constexpr int OFF_S = OFF_V + KV_TILE;
    static constexpr int OFF_P = OFF_S + R * LDS * 4;
    static constexpr int OFF_PL = OFF_P + R * LDP * 2;
    static constexpr int OFF_O = OFF_PL + R * LDP * 2;
    static constexpr int OFF_ROWS = OFF_O + R * LDO * 4;
    static constexpr int OFF_KPOS = OFF_ROWS + R * 4 * 4 + 2 * 4;
    static constexpr int BYTES = OFF_KPOS + (POS ? TK * 4 : 0);
};

// -- where a tile's rows lie -----------------------------------------------------

struct PagedRows {
    static constexpr bool FULL = true;  // every tile holds TK keys
    static constexpr bool POS_FROM_ARRAY = false;  // key j sits at position j
    static constexpr bool TABLE = false;  // a tile's rows are one contiguous run
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
    static constexpr bool TABLE = false;
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
    static constexpr bool TABLE = true;  // latent_decode.cuh: key_row
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
    // the W stored positions of sequence b's ring row, or null for a row out
    // of range (attention_decode.cuh reads them before it stages any tile)
    __device__ const int* row_positions(int b) const {
        const int row = slots[b];
        return row < 0 || row >= N ? nullptr : pos + (size_t)row * W;
    }
    // slot `key`'s storage row (row * W + key) where the query at position p
    // sees its stored position (0 <= pos <= p, and > p - window with a
    // window), else -1 (and for a ring row out of range)
    __device__ int key_row(int b, int key, int p, int window) const {
        const int row = slots[b];
        if (row < 0 || row >= N) return -1;
        const int kp = __ldg(pos + (size_t)row * W + key);
        return kp >= 0 && kp <= p && (window <= 0 || kp > p - window) ? row * W + key : -1;
    }
};

// A pool of `epp` entries a page, paged through the token block table: key
// j of sequence b is entry j % epp of page bt[b, j / epp]. Pages hold fewer
// entries than a tile, so each row is found on its own (TABLE).
struct PoolRows {
    static constexpr bool POS_FROM_ARRAY = false;
    static constexpr bool TABLE = true;
    const int* bt;  // (B, MP) block tables
    int MP, P, epp;
    __device__ int key_limit() const { return MP * epp; }
    // the pool row (page * epp + slot) of key `key`, or -1 for a page out of
    // range (the caller bounds key by the sequence's length and position)
    __device__ int key_row(int b, int key, int, int) const {
        const int page = __ldg(bt + (size_t)b * MP + key / epp);
        return page >= 0 && page < P ? page * epp + key % epp : -1;
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
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    int Hk;
    // rows tok0 .. tok0+n-1 of head hk into the tiles; rows n.. are zero
    template <int LD, int TKT>
    __device__ void load(size_t tok0, int n, int hk, __nv_bfloat16* Ks, __nv_bfloat16* Vs,
                         int tid) const {
        copy_rows<D, LD, TKT>(k, tok0, n, Hk, hk, Ks, tid);
        copy_rows<D, LD, TKT>(v, tok0, n, Hk, hk, Vs, tid);
    }
};

// K and V of D channels as packed 2..8-bit words with one bf16 scale per 32
// channels, staged and unpacked by attention_decode.cuh and
// attention_prefill.cuh (not by this loop)
template <int D>
struct QuantKV {
    const uint32_t* kq;
    const __nv_bfloat16* ks;
    const uint32_t* vq;
    const __nv_bfloat16* vs;
    int Hk, k_bits, v_bits;
    float ca, cb;  // compander a and 1 - a; ca = 0 selects the midpoint grid
};

// -- the kernel ----------------------------------------------------------------------

template <class G_, class Rows, class KV>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const void* __restrict__ q, Rows rows, KV kv, const int* __restrict__ qpos,
                 const int* __restrict__ total_lens, const float* __restrict__ sinks,
                 float* __restrict__ out, int S, int Hq, int Hk, float scale, int window,
                 float softcap) {
    constexpr int D = G_::D, DV = G_::DV, R = G_::R, TK = G_::TK;
    constexpr bool RING = Rows::POS_FROM_ARRAY;
    constexpr int NWR = R / 16;          // row groups of 16
    constexpr int WPR = WARPS / NWR;     // warps sharing a row group
    constexpr int TPR = THREADS / R;     // softmax threads a row
    constexpr int KPT = TK / TPR;        // keys a softmax thread
    static_assert(NWR * WPR == WARPS && TPR * R == THREADS && KPT * TPR == TK, "geometry");
    static_assert(D % 16 == 0 && DV % 16 == 0 && TK % 16 == 0 && PAGE % TK == 0, "geometry");
    using L = Layout<G_, RING>;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_Q);
    __nv_bfloat16* Qls = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_QL);
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_K);
    __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_V);
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
        // f32 q rows as hi + lo bf16
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
        // a constant count for full tiles, so that their loads carry no bound check
        kv.template load<L::LDK, TK>(tok0, Rows::FULL ? TK : n, hk, Ks, Vs, tid);
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
                wmma::load_matrix_sync(fa, &Qls[rw * L::LDQ + kk], L::LDQ);
                wmma::mma_sync(sc, fa, fb, sc);
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
            }
            wmma::store_matrix_sync(&Os[rw * L::LDO + dcol], o, L::LDO, wmma::mem_row_major);
        }
        __syncthreads();  // K/V tiles and row state are overwritten next
    }

    for (int e = tid; e < R * DV; e += THREADS) {
        const int r = e / DV, c = e % DV;
        int s, head;
        if (row_of(r, s, head)) {
            out[(((size_t)b * S + s) * Hq + head) * DV + c] = Os[r * L::LDO + c] / fmaxf(row_l[r], 1e-30f);
        }
    }
}

// Launch on `st`; returns cudaGetLastError() as an int.
template <class G_, class Rows, class KV>
int launch_attention(const void* q, Rows rows, KV kv, const void* qpos, const void* total_lens,
                     const void* sinks, void* out, int B, int S, int Hq, int Hk, float scale,
                     int window, float softcap, cudaStream_t st) {
    constexpr int BYTES = Layout<G_, Rows::POS_FROM_ARRAY>::BYTES;
    static_assert(BYTES <= 232448, "shared memory of one block");
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(attention_kernel<G_, Rows, KV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
        attr_set = true;
    }
    if (Hk <= 0 || Hq % Hk) return (int)cudaErrorInvalidValue;
    const int G = Hq / Hk, HB = G < G_::R ? G : G_::R;
    const int QT = G_::R / HB, NH = (G + HB - 1) / HB;
    dim3 grid((S + QT - 1) / QT, Hk * NH, B);
    attention_kernel<G_, Rows, KV><<<grid, THREADS, BYTES, st>>>(
        q, rows, kv, static_cast<const int*>(qpos), static_cast<const int*>(total_lens),
        static_cast<const float*>(sinks), static_cast<float*>(out), S, Hq, Hk, scale, window,
        softcap);
    const int err = (int)cudaGetLastError();
    if (err == 0) ++tile_launch_count;
    return err;
}

}  // namespace
