// Paged attention for Hopper over a quantized KV cache with 256-token pages:
// packed 2..8-bit K and V words with one bf16 scale per 32 channels, unpacked
// in the kernel.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel_merged (even
//           widths, merged-head storage) and ::_flash_kernel with k_bits /
//           v_bits > 0 (per-head storage, odd widths as bit planes). The two
//           storages hold the same bytes for an even width, so one kernel
//           serves both: it addresses head h of a token at word
//           (token * Hk + h) * D*bits/32 whatever shape the tensor has.
// Inputs:   q (B, S, Hq, D) f32, already rotated by the per-32-channel
//           Hadamard; k_q, v_q int32 packed words and k_s, v_s bf16 scales,
//           (P, 256, Hk, .) or (P, 256, Hk * .); block_tables (B, MP) int32;
//           q_positions (B, S) int32; total_lens (B,) int32; sinks (Hq,) f32
//           or null. D in {64, 128}; 64 % (Hq/Hk) == 0; k_bits and v_bits
//           independent in 2..8; compand_a > 0 selects the cubic compander.
// Output:   (B, S, Hq, D) f32 in V's rotated basis (the caller rotates it
//           back). Masking, softcap, sinks and empty rows as in
//           paged_attention.cu.
// Bound:    decode reads every visible packed K/V byte and scale once
//           (bytes over 3.35 TB/s): bits/16 of the bf16 cache's bytes plus
//           1/16 for the scales; a long prefill chunk is bound by its 4*D
//           operations per visible (query, key) pair at the bf16 rate. The
//           unpack costs a few integer and float operations per element
//           and runs on the ordinary cores.
// Design:   paged_attention.cu with the K/V tile load replaced by an unpack.
//           A thread takes 8 consecutive channels of one key: it reads the
//           words that hold them straight from device memory (neighbouring
//           threads read neighbouring words), takes the field of each
//           channel, maps it to the midpoint grid ((2q+1)/N - 1) or through
//           the compander t*(a + (1-a)t^2), and multiplies by the group's
//           scale. Each field goes to its true channel: the JAX kernel's
//           channel permutation served the TPU's repeat-widen unpack and is
//           left out, except that odd widths are stored as bit planes in
//           lane order, which the unpack follows (field()). K and V are
//           never un-rotated: q was rotated outside and the output is
//           rotated back outside. A grid value times a bf16 scale has at most
//           16 significant bits, so it is written to shared memory as two
//           bf16 terms, hi + lo, which hold it exactly (the compander's
//           values to 2^-16); with q and P also as hi + lo pairs a product
//           takes three MMAs (hi.hi, lo.hi, hi.lo) and keeps f32-level
//           results, as the TPU kernel's f32 dots do. The whole pool is
//           never dequantized, whatever S is.
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
    static constexpr int OFF_KL = OFF_K + TK * LDK * 2;
    static constexpr int OFF_V = OFF_KL + TK * LDK * 2;
    static constexpr int OFF_VL = OFF_V + TK * LDK * 2;
    static constexpr int OFF_S = OFF_VL + TK * LDK * 2;
    static constexpr int OFF_P = OFF_S + R * LDS * 4;
    static constexpr int OFF_PL = OFF_P + R * LDP * 2;
    static constexpr int OFF_O = OFF_PL + R * LDP * 2;
    static constexpr int OFF_ROWS = OFF_O + R * LDO * 4;
    static constexpr int BYTES = OFF_ROWS + R * 4 * 4 + 2 * 4;
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

// Unpack TK keys of one head, starting at token row `tok0` of the pool, into
// hi and lo bf16 tiles of LD columns.
template <int D, int LD, int BITS>
__device__ __forceinline__ void unpack_tile(const uint32_t* __restrict__ words,
                                            const __nv_bfloat16* __restrict__ scales,
                                            size_t tok0, int Hk, int hk, float ca, float cb,
                                            __nv_bfloat16* hi_s, __nv_bfloat16* lo_s, int tid) {
    constexpr int W = D * BITS / 32, G = D / 32, RUNS = D / 8, N = 1 << BITS;
    for (int e = tid; e < TK * RUNS; e += THREADS) {
        const int j = e / RUNS, c0 = (e % RUNS) * 8;
        const size_t th = (tok0 + j) * Hk + hk;
        const uint32_t* w = words + th * W;
        const float sc = __bfloat162float(scales[th * G + (c0 >> 5)]);
        __align__(16) __nv_bfloat16 hi[8], lo[8];
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
        *reinterpret_cast<uint4*>(&hi_s[j * LD + c0]) = *reinterpret_cast<const uint4*>(hi);
        *reinterpret_cast<uint4*>(&lo_s[j * LD + c0]) = *reinterpret_cast<const uint4*>(lo);
    }
}

template <int D, int LD>
__device__ __forceinline__ void unpack_any(int bits, const uint32_t* __restrict__ words,
                                           const __nv_bfloat16* __restrict__ scales, size_t tok0,
                                           int Hk, int hk, float ca, float cb,
                                           __nv_bfloat16* hi_s, __nv_bfloat16* lo_s, int tid) {
    switch (bits) {  // uniform across the grid
        case 2: unpack_tile<D, LD, 2>(words, scales, tok0, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 3: unpack_tile<D, LD, 3>(words, scales, tok0, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 4: unpack_tile<D, LD, 4>(words, scales, tok0, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 5: unpack_tile<D, LD, 5>(words, scales, tok0, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 6: unpack_tile<D, LD, 6>(words, scales, tok0, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        case 7: unpack_tile<D, LD, 7>(words, scales, tok0, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
        default: unpack_tile<D, LD, 8>(words, scales, tok0, Hk, hk, ca, cb, hi_s, lo_s, tid); break;
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_quant_kernel(const float* __restrict__ q, const uint32_t* __restrict__ kq,
                             const __nv_bfloat16* __restrict__ ksc,
                             const uint32_t* __restrict__ vq,
                             const __nv_bfloat16* __restrict__ vsc, const int* __restrict__ bt,
                             const int* __restrict__ qpos, const int* __restrict__ total_lens,
                             const float* __restrict__ sinks, float* __restrict__ out,
                             int S, int Hq, int Hk, int MP, int P, int k_bits, int v_bits,
                             float ca, float cb, float scale, int window, float softcap) {
    using L = Layout<D>;
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
        const size_t tok0 = (size_t)page * PAGE + key0 % PAGE;
        unpack_any<D, L::LDK>(k_bits, kq, ksc, tok0, Hk, hk, ca, cb, Ks, Kls, tid);
        unpack_any<D, L::LDK>(v_bits, vq, vsc, tok0, Hk, hk, ca, cb, Vs, Vls, tid);
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
                wmma::load_matrix_sync(fb, &Kls[(j * 16) * L::LDK + kk], L::LDK);
                wmma::load_matrix_sync(fa, &Qs[rw * L::LDQ + kk], L::LDQ);
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
                wmma::load_matrix_sync(fb, &Vls[kk * L::LDK + dcol], L::LDK);
                wmma::load_matrix_sync(fa, &Ps[rw * L::LDP + kk], L::LDP);
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
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const void* bt, const void* qpos, const void* total_lens, const void* sinks, void* out,
           int B, int S, int Hq, int Hk, int MP, int P, int k_bits, int v_bits, float ca,
           float cb, float scale, int window, float softcap, cudaStream_t st) {
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(paged_attention_quant_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::BYTES);
        attr_set = true;
    }
    const int QT = R / (Hq / Hk);
    dim3 grid((S + QT - 1) / QT, Hk, B);
    paged_attention_quant_kernel<D><<<grid, THREADS, Layout<D>::BYTES, st>>>(
        static_cast<const float*>(q), static_cast<const uint32_t*>(kq),
        static_cast<const __nv_bfloat16*>(ks), static_cast<const uint32_t*>(vq),
        static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(bt),
        static_cast<const int*>(qpos), static_cast<const int*>(total_lens),
        static_cast<const float*>(sinks), static_cast<float*>(out), S, Hq, Hk, MP, P, k_bits,
        v_bits, ca, cb, scale, window, softcap);
    return (int)cudaGetLastError();
}

}  // namespace

// compand_a = 0 selects the midpoint grid; compand_b is 1 - compand_a.
extern "C" int exl3_paged_attention_quant(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs, const void* bt,
    const void* qpos, const void* total_lens, const void* sinks, void* out, int B, int S, int Hq,
    int Hk, int D, int MP, int P, int k_bits, int v_bits, float compand_a, float compand_b,
    float scale, int window, float softcap, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (k_bits < 2 || k_bits > 8 || v_bits < 2 || v_bits > 8) return (int)cudaErrorInvalidValue;
    if (D == 128)
        return launch<128>(q, kq, ks, vq, vs, bt, qpos, total_lens, sinks, out, B, S, Hq, Hk, MP,
                           P, k_bits, v_bits, compand_a, compand_b, scale, window, softcap, st);
    if (D == 64)
        return launch<64>(q, kq, ks, vq, vs, bt, qpos, total_lens, sinks, out, B, S, Hq, Hk, MP,
                          P, k_bits, v_bits, compand_a, compand_b, scale, window, softcap, st);
    return (int)cudaErrorInvalidValue;
}
