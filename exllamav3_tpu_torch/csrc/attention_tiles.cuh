// The flash-attention tile loop shared by the port's four attention entries:
// paged_attention.cu, paged_attention_quant.cu, linear_attention.cu and
// linear_attention_quant.cu.
//
// The kernel is templated twice over:
//   * Rows: where a 64-key tile's K/V rows lie. PagedRows looks the page up
//     in the block table (256-token pages, so a tile never crosses a page
//     and every tile is full); LinearRows reads slot `key` of row b (or of
//     the row the caller names for sequence b) of an (N, T, Hk, .) cache, and
//     cuts the last tile at T, which need only be a multiple of 8: keys at or
//     past T are never read, their tile rows are zero and masked.
//   * KV: how a tile is stored. Bf16KV copies bf16 rows; QuantKV unpacks
//     packed 2..8-bit words with one bf16 scale per 32 channels (merged-head
//     and per-head storage address head h of a token alike, at word
//     (token * Hk + h) * D*bits/32) into hi + lo bf16 pairs.
//
// Design: one block per (q block, kv head, sequence). Its 64 score rows are
// (token, head-in-group) pairs, so the G query heads that share a kv head read
// each K/V tile once. The block finds its own keys (the TPU kernel's scalar
// prefetch) and walks only the 64-key tiles between the first and last key any
// of its rows can see (the TPU kernel's per-q-block page bounds). QK^T and PV
// run as bf16 WMMA with f32 accumulation; the online softmax keeps its running
// max, sum and output rows in f32 in shared memory. The TPU kernel multiplies
// q and P in f32, so each f32 operand enters as two bf16 terms, hi = bf16(x)
// and lo = bf16(x - hi), one MMA each: the pair holds x to about 2^-16
// relative. A dequantized K/V value (a grid value times a bf16 scale, at most
// 16 significant bits) is also stored as hi + lo, exactly; a product then
// takes three MMAs (hi.hi, lo.hi, hi.lo). The row sum adds P in f32. Decode
// uses 4 of the 64 rows, and a sequence's keys are walked by one block;
// splitting the keys across blocks is later work.
//
// Visibility: key j is visible to a query at position p iff j < total_len,
// j <= p, j lies in the layout (j < T, or within the block table), and, with
// a window, j > p - window. Scores are scale*q.k, then the softcap; sinks join
// the denominator. A row that sees no key gives 0.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int R = 64;         // score rows per block
constexpr int TK = 64;        // keys per tile
constexpr int PAGE = 256;

// Shared memory of one block. SPLIT: K and V tiles carry a lo term too.
template <int D, bool SPLIT>
struct Layout {
    static constexpr int LDQ = D + 8, LDK = D + 8, LDS = TK + 4, LDP = TK + 8, LDO = D + 4;
    static constexpr int KV_TILE = TK * LDK * 2;
    static constexpr int OFF_Q = 0;
    static constexpr int OFF_QL = OFF_Q + R * LDQ * 2;
    static constexpr int OFF_K = OFF_QL + R * LDQ * 2;
    static constexpr int OFF_KL = OFF_K + KV_TILE;
    static constexpr int OFF_V = OFF_KL + (SPLIT ? KV_TILE : 0);
    static constexpr int OFF_VL = OFF_V + KV_TILE;
    static constexpr int OFF_S = OFF_VL + (SPLIT ? KV_TILE : 0);
    static constexpr int OFF_P = OFF_S + R * LDS * 4;
    static constexpr int OFF_PL = OFF_P + R * LDP * 2;
    static constexpr int OFF_O = OFF_PL + R * LDP * 2;
    static constexpr int OFF_ROWS = OFF_O + R * LDO * 4;
    static constexpr int BYTES = OFF_ROWS + R * 4 * 4 + 2 * 4;
};

// -- where a tile's rows lie -----------------------------------------------------

struct PagedRows {
    static constexpr bool FULL = true;  // every tile holds TK keys
    const int* bt;  // (B, MP) block tables
    int MP, P;
    __device__ int key_limit() const { return MP * PAGE; }
    // false: the tile's page is out of range and the tile is skipped
    // (uniform across the block). Else the tile's first pool row and its
    // count of keys.
    __device__ bool tile(int b, int key0, size_t& tok0, int& n) const {
        const int page = bt[(size_t)b * MP + key0 / PAGE];
        if (page < 0 || page >= P) return false;
        tok0 = (size_t)page * PAGE + key0 % PAGE;
        n = TK;
        return true;
    }
};

struct LinearRows {
    static constexpr bool FULL = false;  // the last tile is cut at T
    const int* rows;  // (B,) cache row of each sequence, or null: row b
    int N, T;         // cache rows; keys per row, a multiple of 8
    __device__ int key_limit() const { return T; }
    // false: the sequence's row is out of range and the tile is skipped
    __device__ bool tile(int b, int key0, size_t& tok0, int& n) const {
        const int row = rows != nullptr ? rows[b] : b;
        if (row < 0 || row >= N) return false;
        tok0 = (size_t)row * T + key0;
        n = min(TK, T - key0);
        return true;
    }
};

// -- how a tile is stored -----------------------------------------------------------

template <int D>
struct Bf16KV {
    static constexpr bool SPLIT = false;
    const __nv_bfloat16* k;
    const __nv_bfloat16* v;
    int Hk;
    // rows tok0 .. tok0+n-1 of head hk into the tiles; rows n.. are zero
    template <int LD>
    __device__ void load(size_t tok0, int n, int hk, __nv_bfloat16* Ks, __nv_bfloat16*,
                         __nv_bfloat16* Vs, __nv_bfloat16*, int tid) const {
        constexpr int VPR = D / 8;  // 16-byte vectors per row
        for (int e = tid; e < TK * VPR; e += THREADS) {
            const int j = e / VPR, c = (e % VPR) * 8;
            uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
            if (j < n) {
                const size_t off = ((tok0 + j) * Hk + hk) * D + c;
                kx = __ldg(reinterpret_cast<const uint4*>(k + off));
                vx = __ldg(reinterpret_cast<const uint4*>(v + off));
            }
            *reinterpret_cast<uint4*>(&Ks[j * LD + c]) = kx;
            *reinterpret_cast<uint4*>(&Vs[j * LD + c]) = vx;
        }
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

// Unpack n <= TK keys of one head, starting at token row `tok0` of the
// storage, into hi and lo bf16 tiles of LD columns; rows n.. are zero. A
// thread takes 8 consecutive channels of one key: it reads the words that
// hold them straight from device memory (neighbouring threads read
// neighbouring words), takes the field of each channel, maps it to the
// midpoint grid ((2q+1)/N - 1) or through the compander t*(a + (1-a)t^2),
// and multiplies by the group's scale. Each field goes to its true channel:
// the JAX kernel's channel permutation served the TPU's repeat-widen unpack
// and is left out, except that odd widths are stored as bit planes in lane
// order, which field() follows. K and V stay in their stored, rotated basis.
template <int D, int LD, int BITS>
__device__ __forceinline__ void unpack_tile(const uint32_t* __restrict__ words,
                                            const __nv_bfloat16* __restrict__ scales,
                                            size_t tok0, int n, int Hk, int hk, float ca, float cb,
                                            __nv_bfloat16* hi_s, __nv_bfloat16* lo_s, int tid) {
    constexpr int W = D * BITS / 32, G = D / 32, RUNS = D / 8, N = 1 << BITS;
    for (int e = tid; e < TK * RUNS; e += THREADS) {
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

template <int D, int LD>
__device__ __forceinline__ void unpack_any(int bits, const uint32_t* __restrict__ words,
                                           const __nv_bfloat16* __restrict__ scales, size_t tok0,
                                           int n, int Hk, int hk, float ca, float cb,
                                           __nv_bfloat16* hi_s, __nv_bfloat16* lo_s, int tid) {
    switch (bits) {  // uniform across the grid
        case 2: unpack_tile<D, LD, 2>(words, scales, tok0, n, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 3: unpack_tile<D, LD, 3>(words, scales, tok0, n, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 4: unpack_tile<D, LD, 4>(words, scales, tok0, n, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 5: unpack_tile<D, LD, 5>(words, scales, tok0, n, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 6: unpack_tile<D, LD, 6>(words, scales, tok0, n, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 7: unpack_tile<D, LD, 7>(words, scales, tok0, n, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        default: unpack_tile<D, LD, 8>(words, scales, tok0, n, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
    }
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
    template <int LD>
    __device__ void load(size_t tok0, int n, int hk, __nv_bfloat16* Ks, __nv_bfloat16* Kls,
                         __nv_bfloat16* Vs, __nv_bfloat16* Vls, int tid) const {
        unpack_any<D, LD>(k_bits, kq, ks, tok0, n, Hk, hk, ca, cb, Ks, Kls, tid);
        unpack_any<D, LD>(v_bits, vq, vs, tok0, n, Hk, hk, ca, cb, Vs, Vls, tid);
    }
};

// -- the kernel ----------------------------------------------------------------------

template <int D, class Rows, class KV>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const float* __restrict__ q, Rows rows, KV kv, const int* __restrict__ qpos,
                 const int* __restrict__ total_lens, const float* __restrict__ sinks,
                 float* __restrict__ out, int S, int Hq, int Hk, float scale, int window,
                 float softcap) {
    constexpr bool SPLIT = KV::SPLIT;
    using L = Layout<D, SPLIT>;
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_Q);
    __nv_bfloat16* Qls = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_QL);
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_K);
    __nv_bfloat16* Kls = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_KL);
    __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_V);
    __nv_bfloat16* Vls = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_VL);
    float* Ss = reinterpret_cast<float*>(smem + L::OFF_S);
    __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_P);
    __nv_bfloat16* Pls = reinterpret_cast<__nv_bfloat16*>(smem + L::OFF_PL);
    float* Os = reinterpret_cast<float*>(smem + L::OFF_O);
    float* row_m = reinterpret_cast<float*>(smem + L::OFF_ROWS);
    float* row_l = row_m + R;
    float* row_alpha = row_l + R;
    int* row_pos = reinterpret_cast<int*>(row_alpha + R);
    int* key_range = row_pos + R;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int b = blockIdx.z, hk = blockIdx.y;
    const int G = Hq / Hk, QT = R / G;
    const int s0 = blockIdx.x * QT;
    const int limit = rows.key_limit();
    const int total = min(total_lens[b], limit);
    constexpr int VPR = D / 8;  // 16-byte vectors per row

    for (int r = tid; r < R; r += THREADS) {
        const int s = s0 + r / G, head = hk * G + r % G;
        const bool valid = s < S;
        row_pos[r] = valid ? qpos[(size_t)b * S + s] : -1;
        const bool sink = valid && sinks != nullptr;
        row_m[r] = sink ? sinks[head] : -INFINITY;
        row_l[r] = sink ? 1.0f : 0.0f;
    }
    for (int e = tid; e < R * VPR; e += THREADS) {  // q rows as hi + lo bf16
        const int r = e / VPR, c = (e % VPR) * 8;
        const int s = s0 + r / G, head = hk * G + r % G;
        float x[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (s < S) {
            const float4* src =
                reinterpret_cast<const float4*>(q + (((size_t)b * S + s) * Hq + head) * D + c);
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
    for (int e = tid; e < R * D; e += THREADS) Os[(e / D) * L::LDO + e % D] = 0.0f;
    __syncthreads();
    if (tid == 0) {  // keys any row of this block can see: [lo, hi]
        int lo = INT32_MAX, hi = -1;
        for (int r = 0; r < R; ++r) {
            const int p = row_pos[r];
            if (p < 0) continue;
            hi = max(hi, min(p, total - 1));
            lo = min(lo, window > 0 ? max(p - window + 1, 0) : 0);
        }
        key_range[0] = lo;
        key_range[1] = min(hi, limit - 1);
    }
    __syncthreads();
    const int lo = key_range[0], hi = key_range[1];

    for (int key0 = (lo / TK) * TK; key0 <= hi; key0 += TK) {
        size_t tok0;
        int n;
        if (!rows.tile(b, key0, tok0, n)) continue;  // uniform across the block
        // a constant count for full tiles, so that their loads carry no bound check
        kv.template load<L::LDK>(tok0, Rows::FULL ? TK : n, hk, Ks, Kls, Vs, Vls, tid);
        __syncthreads();

        // scores for this warp's 16 rows x 64 keys
        const int rw = warp * 16;
#pragma unroll
        for (int j = 0; j < TK / 16; ++j) {
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
                if constexpr (SPLIT) {
                    wmma::load_matrix_sync(fb, &Kls[(j * 16) * L::LDK + kk], L::LDK);
                    wmma::load_matrix_sync(fa, &Qs[rw * L::LDQ + kk], L::LDQ);
                    wmma::mma_sync(sc, fa, fb, sc);
                }
            }
            wmma::store_matrix_sync(&Ss[rw * L::LDS + j * 16], sc, L::LDS, wmma::mem_row_major);
        }
        __syncwarp();

        // online softmax: two lanes per row, 32 keys each
        {
            const int r = rw + lane / 2, half = lane % 2;
            const int p = row_pos[r];
            float* srow = &Ss[r * L::LDS + half * 32];
            float mx = -INFINITY;
            for (int jj = 0; jj < 32; ++jj) {
                const int key = key0 + half * 32 + jj;
                float s = srow[jj] * scale;
                if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
                const bool ok = p >= 0 && key < total && key <= p && (window <= 0 || key > p - window);
                s = ok ? s : -INFINITY;
                srow[jj] = s;
                mx = fmaxf(mx, s);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            const float m_old = row_m[r];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.0f;
            __nv_bfloat16* prow = &Ps[r * L::LDP + half * 32];
            __nv_bfloat16* plrow = &Pls[r * L::LDP + half * 32];
            for (int jj = 0; jj < 32; ++jj) {
                const float s = srow[jj];
                const float pf = s == -INFINITY ? 0.0f : expf(s - m_new);
                const __nv_bfloat16 pb = __float2bfloat16_rn(pf);
                prow[jj] = pb;
                plrow[jj] = __float2bfloat16_rn(pf - __bfloat162float(pb));
                sum += pf;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            const float alpha = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
            __syncwarp();
            if (half == 0) {
                row_m[r] = m_new;
                row_l[r] = row_l[r] * alpha + sum;
                row_alpha[r] = alpha;
            }
        }
        __syncwarp();
        for (int e = lane; e < 16 * D; e += 32) {
            const int r = rw + e / D;
            Os[r * L::LDO + e % D] *= row_alpha[r];
        }
        __syncwarp();

        // O += P V for this warp's rows
#pragma unroll
        for (int dcol = 0; dcol < D; dcol += 16) {
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
        __syncthreads();  // K/V tiles are overwritten next
    }

    for (int e = tid; e < R * D; e += THREADS) {
        const int r = e / D, c = e % D;
        const int s = s0 + r / G;
        if (s < S) {
            const int head = hk * G + r % G;
            out[(((size_t)b * S + s) * Hq + head) * D + c] =
                Os[r * L::LDO + c] / fmaxf(row_l[r], 1e-30f);
        }
    }
}

// Launch on `st`; returns cudaGetLastError() as an int.
template <int D, class Rows, class KV>
int launch_attention(const void* q, Rows rows, KV kv, const void* qpos, const void* total_lens,
                     const void* sinks, void* out, int B, int S, int Hq, int Hk, float scale,
                     int window, float softcap, cudaStream_t st) {
    constexpr int BYTES = Layout<D, KV::SPLIT>::BYTES;
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(attention_kernel<D, Rows, KV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
        attr_set = true;
    }
    const int QT = R / (Hq / Hk);
    dim3 grid((S + QT - 1) / QT, Hk, B);
    attention_kernel<D, Rows, KV><<<grid, THREADS, BYTES, st>>>(
        static_cast<const float*>(q), rows, kv, static_cast<const int*>(qpos),
        static_cast<const int*>(total_lens), static_cast<const float*>(sinks),
        static_cast<float*>(out), S, Hq, Hk, scale, window, softcap);
    return (int)cudaGetLastError();
}

}  // namespace
