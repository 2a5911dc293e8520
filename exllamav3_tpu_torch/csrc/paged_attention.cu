// Paged attention for Hopper over a bf16 KV cache with 256-token pages.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel in its paged
//           layout with unquantized K/V (flash_attention with block_tables).
// Inputs:   q (B, S, Hq, D) f32; k, v (P, 256, Hk, D) bf16; block_tables
//           (B, MP) int32; q_positions (B, S) int32; total_lens (B,) int32;
//           sinks (Hq,) f32 or null. D in {64, 128}; 64 % (Hq/Hk) == 0.
// Output:   (B, S, Hq, D) f32. Key j is visible to a query at position p iff
//           j < total_len, j <= p and, with a window, j > p - window. Scores
//           are scale*q.k, then the softcap; sinks join the denominator. A
//           row that sees no key gives 0.
// Bound:    decode reads every visible K/V byte once (bytes over
//           3.35 TB/s); a long prefill chunk is bound by its 4*D operations
//           per visible (query, key) pair at the bf16 tensor-core rate.
// Design:   one block per (q block, kv head, sequence). Its 64 score rows
//           are (token, head-in-group) pairs, so the G query heads that
//           share a kv head read each K/V tile once. The block loads its own
//           block-table entries (the TPU kernel's scalar prefetch) and walks
//           only the 64-key tiles between the first and last key any of its
//           rows can see (the TPU kernel's per-q-block page bounds). QK^T
//           and PV run as bf16 WMMA with f32 accumulation; the online
//           softmax keeps its running max, sum and output rows in f32 in
//           shared memory. The TPU kernel multiplies q and P in f32, so each
//           f32 operand enters as two bf16 terms, hi = bf16(x) and
//           lo = bf16(x - hi), one MMA each: the pair holds x to about 2^-16
//           relative, twice the tensor-core work for f32-level results. The
//           row sum adds P in f32. Decode uses 4 of the 64 rows, and a
//           sequence's pages are walked by one block; splitting the keys
//           across blocks is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 128;  // 4 warps x 16 rows
constexpr int R = 64;         // score rows per block
constexpr int TK = 64;        // keys per tile
constexpr int PAGE = 256;

template <int D>
struct Layout {
    static constexpr int LDQ = D + 8, LDK = D + 8, LDS = TK + 4, LDP = TK + 8, LDO = D + 4;
    static constexpr int OFF_Q = 0;
    static constexpr int OFF_QL = OFF_Q + R * LDQ * 2;
    static constexpr int OFF_K = OFF_QL + R * LDQ * 2;
    static constexpr int OFF_V = OFF_K + TK * LDK * 2;
    static constexpr int OFF_S = OFF_V + TK * LDK * 2;
    static constexpr int OFF_P = OFF_S + R * LDS * 4;
    static constexpr int OFF_PL = OFF_P + R * LDP * 2;
    static constexpr int OFF_O = OFF_PL + R * LDP * 2;
    static constexpr int OFF_ROWS = OFF_O + R * LDO * 4;
    static constexpr int BYTES = OFF_ROWS + R * 4 * 4 + 2 * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                       const __nv_bfloat16* __restrict__ vp, const int* __restrict__ bt,
                       const int* __restrict__ qpos, const int* __restrict__ total_lens,
                       const float* __restrict__ sinks, float* __restrict__ out,
                       int S, int Hq, int Hk, int MP, int P, float scale, int window,
                       float softcap) {
    using L = Layout<D>;
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

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int b = blockIdx.z, hk = blockIdx.y;
    const int G = Hq / Hk, QT = R / G;
    const int s0 = blockIdx.x * QT;
    const int total = total_lens[b];
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
        key_range[1] = min(hi, MP * PAGE - 1);
    }
    __syncthreads();
    const int lo = key_range[0], hi = key_range[1];

    for (int key0 = (lo / TK) * TK; key0 <= hi; key0 += TK) {
        const int page = bt[(size_t)b * MP + key0 / PAGE];
        if (page < 0 || page >= P) continue;  // uniform across the block
        const size_t base = ((size_t)page * PAGE + key0 % PAGE) * Hk + hk;
        for (int e = tid; e < TK * VPR; e += THREADS) {
            const int j = e / VPR, c = (e % VPR) * 8;
            const size_t off = (base + (size_t)j * Hk) * D + c;
            *reinterpret_cast<uint4*>(&Ks[j * L::LDK + c]) = *reinterpret_cast<const uint4*>(kp + off);
            *reinterpret_cast<uint4*>(&Vs[j * L::LDK + c]) = *reinterpret_cast<const uint4*>(vp + off);
        }
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

template <int D>
int launch(const void* q, const void* k, const void* v, const void* bt, const void* qpos,
           const void* total_lens, const void* sinks, void* out, int B, int S, int Hq, int Hk,
           int MP, int P, float scale, int window, float softcap, cudaStream_t st) {
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(paged_attention_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::BYTES);
        attr_set = true;
    }
    const int QT = R / (Hq / Hk);
    dim3 grid((S + QT - 1) / QT, Hk, B);
    paged_attention_kernel<D><<<grid, THREADS, Layout<D>::BYTES, st>>>(
        static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(bt),
        static_cast<const int*>(qpos), static_cast<const int*>(total_lens),
        static_cast<const float*>(sinks), static_cast<float*>(out), S, Hq, Hk, MP, P, scale,
        window, softcap);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int exl3_paged_attention(const void* q, const void* k, const void* v, const void* bt,
                                    const void* qpos, const void* total_lens, const void* sinks,
                                    void* out, int B, int S, int Hq, int Hk, int D, int MP, int P,
                                    float scale, int window, float softcap, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D == 128)
        return launch<128>(q, k, v, bt, qpos, total_lens, sinks, out, B, S, Hq, Hk, MP, P,
                           scale, window, softcap, st);
    if (D == 64)
        return launch<64>(q, k, v, bt, qpos, total_lens, sinks, out, B, S, Hq, Hk, MP, P,
                          scale, window, softcap, st);
    return (int)cudaErrorInvalidValue;
}
