// The trellis-decode GEMM with its stages dropped one at a time.
//
// Replaces: tools/fused_ablate.py::_variant_kernel (run_variant), the probe
//           of exllamav3_tpu/ops/exl3_gemm.py::_exl3_gemm_kernel.
// Function: xh (m, k) bf16 @ W' -> (m, n) f32, W' made from the trellis words
//           (k/16, K, n/16*8) int32 (ops/exl3_gemm.py's layout) in the JAX
//           probe's block order: in a (bk, bn) block, code t = gl*8 + half*4 +
//           rh*2 + rl of lane l of tile row tr meets x column rp * bk/16 + tr
//           (rp = gl*4 + rh*2 + rl) and output column half * bn/2 + l. Weight
//           values by variant (template VAR):
//             FULL     (f32(lo half) + f32(hi half)) * 2^-112 of the 3INST
//                      pattern, rounded to bf16 (the JAX probe's f32 decode)
//             F16PAIR  the halves added in fp16, then bf16 (csrc/exl3_gemm.cu's)
//             NOMUL    bf16((code & 0x8FFF) ^ 0x3B60)
//             EXTRACT  bf16(code)
//             INGEST   no extraction: bf16(word 0 ^ word K-1) of a tile row;
//                      block row R meets tile row (2R + half) % (bk/16), so a
//                      step's 8 tile rows serve the 128 rows R whose
//                      (R mod bk/32) lie in that step, each slot alike.
// Bound:    bytes, K/8 a weight, as exl3_gemm.cu; the probe exists to split
//           that kernel's time over its bound into streaming, extraction and
//           decode.
// Design:   exl3_gemm.cu's layout, so that the variants time its stages: 8
//           warps own 128 output columns of tiles (one 16-column tile each)
//           and up to 128 rows, stage 128 k of xh and of the words in shared
//           memory per step, and decode a tile straight into mma.m16n8k16 B
//           fragments (lane L: codes 8L..8L+7 of its tile). The probe's order
//           enters only in which x column staging puts at each MMA k index
//           (a gather instead of exl3_gemm.cu's 16-byte copies: 8 scalar loads
//           a thread a step) and where the epilogue writes. k splits across
//           blocks as in exl3_gemm.cu; the partial sums add in split order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "packed_matmul.cuh"  // packed::mma_bf16, packed::splitk_reduce_kernel

namespace {

constexpr int THREADS = 256;  // 8 warps, one 16-column tile each
constexpr int BN = 128;       // output columns per block
constexpr int BM = 128;       // rows per block
constexpr int KC = 128;       // k per staged step
constexpr int KT = KC / 16;   // tile rows per step
constexpr int LDA = KC + 8;
constexpr int LDW = 64 + 8;
constexpr int MAX_MB = BM / 16;

enum { INGEST = 0, EXTRACT = 1, NOMUL = 2, F16PAIR = 3, FULL = 4 };

__device__ __forceinline__ uint32_t bf16_bits(float f) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <int VAR>
__device__ __forceinline__ uint32_t decode(uint32_t code) {
    if constexpr (VAR == EXTRACT) {
        return bf16_bits((float)code);
    } else if constexpr (VAR == NOMUL) {
        return bf16_bits((float)((code & 0x8FFFu) ^ 0x3B60u));
    } else {
        const uint32_t x = code * 89226354u + 64248484u;
        const uint32_t m = (x & 0x8FFF8FFFu) ^ 0x3B603B60u;
        const __half lo = __ushort_as_half((unsigned short)(m & 0xFFFFu));
        const __half hi = __ushort_as_half((unsigned short)(m >> 16));
        if constexpr (VAR == F16PAIR)
            return bf16_bits(__half2float(__hadd(lo, hi)));
        else  // exact: both halves are normal fp16 with exponents 12..15
            return bf16_bits(__fmul_rn(__fadd_rn(__half2float(lo), __half2float(hi)), 0x1p-112f));
    }
}

// k index of x that MMA k index `fr` of slot i of step `step` meets
template <int VAR>
__device__ __forceinline__ int x_column(int step, int i, int fr, int bk, int bkt) {
    if constexpr (VAR == INGEST) {
        const int t0 = step * KT;  // the step's first tile row; bkt % 8 == 0
        const int q = i * 4 + (fr >> 2);
        return (t0 / bkt) * bk + q * (bkt / 2) + (t0 % bkt) / 2 + (fr & 3);
    } else {
        const int t = step * KT + i;
        const int rp = ((fr >> 1) & 3) * 4 + (fr >> 3) * 2 + (fr & 1);
        return (t / bkt) * bk + rp * bkt + t % bkt;
    }
}

template <int K, int VAR>
__global__ void __launch_bounds__(THREADS)
probe_trellis_kernel(const __nv_bfloat16* __restrict__ xh, const uint32_t* __restrict__ words,
                     float* __restrict__ out, int m, int k, int n, int steps_per_split,
                     int a_rows, int bk, int bn) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
    uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + (size_t)a_rows * LDA * 2);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int n0 = blockIdx.x * BN, split = blockIdx.y, m0 = blockIdx.z * BM;
    const int rows = min(BM, m - m0);
    const int nmb = (rows + 15) / 16;
    const int gh = lane >> 2, gl = lane & 3;
    const int n_words = n / 2;
    const int bkt = bk / 16, bnt = bn / 16, half_cols = bn / 2;
    const int tile = n0 / 16 + warp;                                 // this warp's tile
    const int col0 = (tile / bnt) * bn + (tile % bnt) * 8 + (lane & 3) * 2;  // + half * bn/2

    float acc[MAX_MB][2][4];
#pragma unroll
    for (int mb = 0; mb < MAX_MB; ++mb)
#pragma unroll
        for (int ci = 0; ci < 2; ++ci)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mb][ci][i] = 0.0f;

    const int steps = k / KC;
    const int step0 = split * steps_per_split;
    const int step1 = min(step0 + steps_per_split, steps);
    for (int step = step0; step < step1; ++step) {
        __syncthreads();  // the previous step's tiles are consumed
        for (int e = tid; e < nmb * 16 * KC; e += THREADS) {
            const int r = e / KC, c = e % KC;
            __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
            if (r < rows) v = xh[(size_t)(m0 + r) * k + x_column<VAR>(step, c / 16, c % 16, bk, bkt)];
            As[r * LDA + c] = v;
        }
        for (int e = tid; e < KT * K * 16; e += THREADS) {
            const int row = e / 16, v = e % 16;  // row = tile row * K + wi
            const uint32_t* src =
                words + ((size_t)step * KT * K + row) * n_words + n0 / 2 + v * 4;
            *reinterpret_cast<uint4*>(&Ws[row * LDW + v * 4]) =
                *reinterpret_cast<const uint4*>(src);
        }
        __syncthreads();

        uint32_t bf[2][2];
        if constexpr (VAR == INGEST) {
            // slot-independent: half ci of MMA k index 2gl + e (and 8 + 2gl + e)
            // takes tile row 2 * ((2gl + e) % 4) + ci of the step
#pragma unroll
            for (int ci = 0; ci < 2; ++ci) {
                uint32_t v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int tr = 2 * ((2 * gl + e) & 3) + ci;
                    const uint32_t s = Ws[(tr * K) * LDW + warp * 8 + gh]
                                       ^ Ws[(tr * K + K - 1) * LDW + warp * 8 + gh];
                    v[e] = bf16_bits((float)(int)s);
                }
                bf[ci][0] = bf[ci][1] = v[0] | (v[1] << 16);
            }
        }
#pragma unroll 1
        for (int kt = 0; kt < KT; ++kt) {
            if constexpr (VAR != INGEST) {
                const uint32_t* wt = Ws + kt * K * LDW + warp * 8;
                const uint32_t prev = wt[(K - 1) * LDW + ((gh + 7) & 7)];
                uint32_t v[8];
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int end = (gl * 8 + j + 1) * K;  // window ends at this bit
                    const int wi = (end - 1) >> 5;
                    const int sh = ((wi + 1) << 5) - end;
                    const uint32_t b = wt[wi * LDW + gh];
                    const uint32_t a = wi > 0 ? wt[(wi - 1) * LDW + gh] : prev;
                    v[j] = decode<VAR>(__funnelshift_r(b, a, sh) & 0xFFFFu);
                }
#pragma unroll
                for (int ci = 0; ci < 2; ++ci) {
                    bf[ci][0] = v[ci * 4 + 0] | (v[ci * 4 + 1] << 16);
                    bf[ci][1] = v[ci * 4 + 2] | (v[ci * 4 + 3] << 16);
                }
            }
#pragma unroll
            for (int mb = 0; mb < MAX_MB; ++mb) {
                if (mb < nmb) {
                    const __nv_bfloat16* ap =
                        &As[(mb * 16 + (lane >> 2)) * LDA + kt * 16 + (lane & 3) * 2];
                    uint32_t a[4];
                    a[0] = *reinterpret_cast<const uint32_t*>(ap);
                    a[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * LDA);
                    a[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
                    a[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * LDA + 8);
                    packed::mma_bf16(acc[mb][0], a, bf[0]);
                    packed::mma_bf16(acc[mb][1], a, bf[1]);
                }
            }
        }
    }

    float* dst = out + (size_t)split * m * n;
#pragma unroll
    for (int mb = 0; mb < MAX_MB; ++mb) {
        if (mb < nmb) {
#pragma unroll
            for (int ci = 0; ci < 2; ++ci) {
                const int col = col0 + ci * half_cols;
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
}

template <int K, int VAR>
int launch(const void* xh, const void* words, void* out, void* scratch, int m, int k, int n,
           int bk, int bn, int splits, cudaStream_t st) {
    const int a_rows = ((min(m, BM) + 15) / 16) * 16;
    const int smem = a_rows * LDA * 2 + KT * K * LDW * 4;
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(probe_trellis_kernel<K, VAR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BM * LDA * 2 + KT * K * LDW * 4);
        attr_set = true;
    }
    const int steps = k / KC;
    const int per = (steps + splits - 1) / splits;
    dim3 grid(n / BN, splits, (m + BM - 1) / BM);
    float* dst = static_cast<float*>(splits > 1 ? scratch : out);
    probe_trellis_kernel<K, VAR><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(xh), static_cast<const uint32_t*>(words), dst, m, k, n,
        per, a_rows, bk, bn);
    int err = (int)cudaGetLastError();
    if (err != 0 || splits == 1) return err;
    const size_t quads = (size_t)m * n / 4;
    packed::splitk_reduce_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
        static_cast<const float4*>(scratch), nullptr, static_cast<float4*>(out), m, n, splits);
    return (int)cudaGetLastError();
}

template <int K>
int launch_var(int var, const void* xh, const void* words, void* out, void* scratch, int m, int k,
               int n, int bk, int bn, int splits, cudaStream_t st) {
    switch (var) {
        case INGEST: return launch<K, INGEST>(xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case EXTRACT: return launch<K, EXTRACT>(xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case NOMUL: return launch<K, NOMUL>(xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case F16PAIR: return launch<K, F16PAIR>(xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case FULL: return launch<K, FULL>(xh, words, out, scratch, m, k, n, bk, bn, splits, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// k, n, bk, bn multiples of 128 with bk | k and bn | n; `splits` leaves no
// split without a 128-wide step (ops/exl3_gemm.py::split_count).
extern "C" int exl3_probe_trellis(const void* xh, const void* words, void* out, void* scratch,
                                  int m, int k, int n, int K, int var, int bk, int bn, int splits,
                                  void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (m < 1 || k % KC || n % BN || bk % KC || bn % BN || k % bk || n % bn || splits < 1)
        return (int)cudaErrorInvalidValue;
    switch (K) {
        case 1: return launch_var<1>(var, xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case 2: return launch_var<2>(var, xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case 3: return launch_var<3>(var, xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case 4: return launch_var<4>(var, xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case 5: return launch_var<5>(var, xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case 6: return launch_var<6>(var, xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case 7: return launch_var<7>(var, xh, words, out, scratch, m, k, n, bk, bn, splits, st);
        case 8: return launch_var<8>(var, xh, words, out, scratch, m, k, n, bk, bn, splits, st);
    }
    return (int)cudaErrorInvalidValue;
}
