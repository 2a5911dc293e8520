// Quantized-KV dequant at decode shape: every key of a head dequantized and
// scored against the head's q rows, the scores summed.
//
// Replaces: tools/dequant_probe.py::_kernel (per-head words, eight unpack
//           variants), ::_kernel_v4 (merged lanes, v4 / v5) and
//           ::_kernel_bf16 (dense bf16 K), the probe of the quantized
//           attention kernels (exllamav3_tpu/ops/flash_attention.py).
// Function: out[r] = sum over keys t of q[r] . k[t] over D = 128 lanes, k[t]
//           the variant's dequant of key t (probes/dequant_probe.py gives
//           each formula). Per head: lane p of head h takes field p / gw of
//           word p % gw (gw = D*BITS/32) and scale (p % gw) / BITS. Merged:
//           lane p of all Hk*D takes word p % (Hk*gw) of the key's merged
//           row, field (p % D) / gw and scale (p / D)*4 + ((p % D) % gw) / BITS.
//           v1, v2 and v5 are one fused multiply-add, fma(2^23 + field,
//           scale, scale * c), as XLA computes the tool's expression.
// Bound:    bytes: the packed words and scales (or bf16 K) once, q once.
// Design:   the quantized tile loop's design (an unpack of 8 lanes a
//           thread from device memory into hi + lo bf16 pairs in shared
//           memory, wmma-sized products), so that the
//           variants split its time: one block of 4 warps per kv head (per
//           128-lane slice, merged) walks all the keys in 64-key tiles; a
//           thread unpacks 8 consecutive lanes of one key, reading each
//           lane's word from device memory, and stores the values as hi + lo
//           bf16 pairs in shared memory; q sits there as hi + lo too, and
//           each warp multiplies 16 keys of the tile with mma.m16n8k16
//           (hi.hi + lo.hi + hi.lo, f32 sums), one MMA of bf16 operands for
//           v2 and v3 (the tool's bf16 score product), two for dense bf16 K.
//           The MMA accumulators keep summing across tiles; the row sums
//           close the block. Merged slices write partial sums that a second
//           kernel adds in slice order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "packed_matmul.cuh"  // packed::mma_bf16

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int D = 128;
constexpr int TK = 64;  // keys a tile
constexpr int LD = D + 8;

enum { V0, V1, V2, V3, AREP, ASTATIC, ANOSCALE, ANODEQ, V4, V5, BF16 };

template <int VAR>
constexpr bool MERGED = VAR == V4 || VAR == V5;
template <int VAR>
constexpr bool BF16_DOT = VAR == V2 || VAR == V3;  // one MMA: bf16 q, bf16 k
template <int VAR>
constexpr bool K_SPLIT = !BF16_DOT<VAR> && VAR != BF16;  // k as hi + lo

__device__ __forceinline__ __nv_bfloat16 bf(float f) { return __float2bfloat16_rn(f); }

// The value of lane p (0..D-1 of this block's slice) of one key
template <int VAR, int BITS>
__device__ __forceinline__ float lane_value(const uint32_t* __restrict__ w,
                                            const __nv_bfloat16* __restrict__ s, int p,
                                            int slice, int row_words) {
    constexpr int GW = D * BITS / 32, N = 1 << BITS;
    constexpr float OFF = (1.0f - N) / 2.0f;
    constexpr uint32_t MASK = N - 1;
    const int widx = MERGED<VAR> ? (slice * D + p) % row_words : p % GW;
    const float se = __bfloat162float(s[(MERGED<VAR> ? slice * (D / 32) : 0) + (p % GW) / BITS]);
    const uint32_t word = __ldg(w + widx);
    if constexpr (VAR == V3) {
        const int hp = p % (2 * GW);
        const uint32_t hw = (__ldg(w + hp / 2) >> (16 * (hp & 1))) & 0xFFFFu;
        const uint32_t f = (hw >> ((p / (2 * GW)) * BITS)) & MASK;
        return __bfloat162float(bf(__fmul_rn((float)f + OFF, se)));
    } else if constexpr (VAR == AREP) {
        return __fmul_rn((float)(int)word, se);
    } else if constexpr (VAR == ANODEQ) {
        return (float)(int)word;
    } else {
        const uint32_t f = (word >> (VAR == ASTATIC ? 4 : (p / GW) * BITS)) & MASK;
        if constexpr (VAR == ANOSCALE) return (float)f;
        if constexpr (VAR == V1 || VAR == V2 || VAR == V5) {
            // c = f32((1 - N) / 2 - 2^23), as numpy rounds it
            const float c = (float)((1.0 - N) / 2.0 - 8388608.0);
            return __fmaf_rn(__int_as_float((int)(f | 0x4B000000u)), se, __fmul_rn(se, c));
        }
        return __fmul_rn(__fadd_rn((float)f, OFF), se);
    }
}

// rows x D f32 (row r at src + r * stride) into hi (and lo) bf16 tiles; rows
// past `rows` are zero
__device__ __forceinline__ void stage_q(const float* __restrict__ src, size_t stride, int rows,
                                        int rows_pad, bool split, __nv_bfloat16* hi,
                                        __nv_bfloat16* lo) {
    for (int e = threadIdx.x; e < rows_pad * D; e += THREADS) {
        const int r = e / D, c = e % D;
        const float x = r < rows ? src[r * stride + c] : 0.0f;
        const __nv_bfloat16 h = bf(x);
        hi[r * LD + c] = h;
        lo[r * LD + c] = bf(split ? x - __bfloat162float(h) : 0.0f);
    }
}

template <int VAR, int BITS, int MT>
__global__ void __launch_bounds__(THREADS)
probe_kv_kernel(const float* __restrict__ q, const void* __restrict__ kv,
                const __nv_bfloat16* __restrict__ ks, float* __restrict__ out, int T, int Hk,
                int G) {
    constexpr int GW = D * BITS / 32;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[WARPS][16 * MT];
    __nv_bfloat16* Qhi = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Qlo = Qhi + 16 * MT * LD;
    __nv_bfloat16* Khi = Qlo + 16 * MT * LD;
    __nv_bfloat16* Klo = Khi + TK * LD;

    const int slice = blockIdx.x;  // kv head, or 128-lane slice of the merged lanes
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rows = MERGED<VAR> ? Hk * G : G;
    if constexpr (MERGED<VAR>)
        stage_q(q + slice * D, (size_t)Hk * D, rows, 16 * MT, !BF16_DOT<VAR>, Qhi, Qlo);
    else
        stage_q(q + (size_t)slice * G * D, D, rows, 16 * MT, !BF16_DOT<VAR>, Qhi, Qlo);

    float acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

    for (int t0 = 0; t0 < T; t0 += TK) {
        __syncthreads();  // q staged; the previous tile consumed
        for (int e = threadIdx.x; e < TK * (D / 8); e += THREADS) {
            const int j = e / (D / 8), c0 = (e % (D / 8)) * 8;
            const size_t key = (size_t)t0 + j;
            __align__(16) __nv_bfloat16 hi[8], lo[8];
            if constexpr (VAR == BF16) {
                *reinterpret_cast<uint4*>(hi) = __ldg(reinterpret_cast<const uint4*>(
                    static_cast<const __nv_bfloat16*>(kv) + (key * Hk + slice) * D + c0));
            } else {
                const uint32_t* w = static_cast<const uint32_t*>(kv)
                                    + (MERGED<VAR> ? key * Hk * GW : (key * Hk + slice) * GW);
                const __nv_bfloat16* s = ks + (MERGED<VAR> ? key * Hk * (D / 32)
                                                             : (key * Hk + slice) * (D / 32));
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float x = lane_value<VAR, BITS>(w, s, c0 + i, slice, Hk * GW);
                    hi[i] = bf(x);
                    if constexpr (K_SPLIT<VAR>) lo[i] = bf(x - __bfloat162float(hi[i]));
                }
            }
            *reinterpret_cast<uint4*>(&Khi[j * LD + c0]) = *reinterpret_cast<const uint4*>(hi);
            if constexpr (K_SPLIT<VAR>)
                *reinterpret_cast<uint4*>(&Klo[j * LD + c0]) = *reinterpret_cast<const uint4*>(lo);
        }
        __syncthreads();

#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                const int off = (warp * 16 + nt * 8 + (lane >> 2)) * LD + kc * 16 + (lane & 3) * 2;
                bh[nt][0] = *reinterpret_cast<const uint32_t*>(&Khi[off]);
                bh[nt][1] = *reinterpret_cast<const uint32_t*>(&Khi[off + 8]);
                if constexpr (K_SPLIT<VAR>) {
                    bl[nt][0] = *reinterpret_cast<const uint32_t*>(&Klo[off]);
                    bl[nt][1] = *reinterpret_cast<const uint32_t*>(&Klo[off + 8]);
                }
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                if (mt * 16 >= rows) break;
                const int off = (mt * 16 + (lane >> 2)) * LD + kc * 16 + (lane & 3) * 2;
                uint32_t ah[4], al[4];
                ah[0] = *reinterpret_cast<const uint32_t*>(&Qhi[off]);
                ah[1] = *reinterpret_cast<const uint32_t*>(&Qhi[off + 8 * LD]);
                ah[2] = *reinterpret_cast<const uint32_t*>(&Qhi[off + 8]);
                ah[3] = *reinterpret_cast<const uint32_t*>(&Qhi[off + 8 * LD + 8]);
                if constexpr (!BF16_DOT<VAR>) {
                    al[0] = *reinterpret_cast<const uint32_t*>(&Qlo[off]);
                    al[1] = *reinterpret_cast<const uint32_t*>(&Qlo[off + 8 * LD]);
                    al[2] = *reinterpret_cast<const uint32_t*>(&Qlo[off + 8]);
                    al[3] = *reinterpret_cast<const uint32_t*>(&Qlo[off + 8 * LD + 8]);
                }
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    packed::mma_bf16(acc[mt][nt], ah, bh[nt]);
                    if constexpr (!BF16_DOT<VAR>) packed::mma_bf16(acc[mt][nt], al, bh[nt]);
                    if constexpr (K_SPLIT<VAR>) packed::mma_bf16(acc[mt][nt], ah, bl[nt]);
                }
            }
        }
    }

    // row sums: a lane holds rows lane/4 and lane/4 + 8 of each row tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        float s0 = acc[mt][0][0] + acc[mt][0][1] + acc[mt][1][0] + acc[mt][1][1];
        float s1 = acc[mt][0][2] + acc[mt][0][3] + acc[mt][1][2] + acc[mt][1][3];
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
            s0 += __shfl_xor_sync(0xFFFFFFFFu, s0, o);
            s1 += __shfl_xor_sync(0xFFFFFFFFu, s1, o);
        }
        if ((lane & 3) == 0) {
            red[warp][mt * 16 + (lane >> 2)] = s0;
            red[warp][mt * 16 + (lane >> 2) + 8] = s1;
        }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += THREADS) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[w][r];
        out[(size_t)slice * rows + r] = s;
    }
}

// out[r] = sum over slices of ws[slice][r], in slice order
__global__ void probe_kv_reduce(const float* __restrict__ ws, float* __restrict__ out, int slices,
                                int rows) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    float s = 0.0f;
    for (int i = 0; i < slices; ++i) s += ws[(size_t)i * rows + r];
    out[r] = s;
}

template <int VAR, int BITS, int MT>
int launch(const void* q, const void* kv, const void* ks, void* out, void* ws, int T, int Hk,
           int G, cudaStream_t st) {
    constexpr int SMEM = (2 * 16 * MT + 2 * TK) * LD * 2;
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(probe_kv_kernel<VAR, BITS, MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        attr_set = true;
    }
    float* dst = static_cast<float*>(MERGED<VAR> ? ws : out);
    probe_kv_kernel<VAR, BITS, MT><<<Hk, THREADS, SMEM, st>>>(
        static_cast<const float*>(q), kv, static_cast<const __nv_bfloat16*>(ks), dst, T, Hk, G);
    int err = (int)cudaGetLastError();
    if (err != 0 || !MERGED<VAR>) return err;
    probe_kv_reduce<<<(Hk * G + 63) / 64, 64, 0, st>>>(static_cast<const float*>(ws),
                                                        static_cast<float*>(out), Hk, Hk * G);
    return (int)cudaGetLastError();
}

template <int BITS>
int launch_var(int var, const void* q, const void* kv, const void* ks, void* out, void* ws, int T,
               int Hk, int G, cudaStream_t st) {
#define EXL3_PROBE_KV(V) launch<V, BITS, 1>(q, kv, ks, out, ws, T, Hk, G, st)
    switch (var) {
        case V0: return EXL3_PROBE_KV(V0);
        case V1: return EXL3_PROBE_KV(V1);
        case V2: return EXL3_PROBE_KV(V2);
        case V3: return EXL3_PROBE_KV(V3);
        case AREP: return EXL3_PROBE_KV(AREP);
        case ASTATIC: return EXL3_PROBE_KV(ASTATIC);
        case ANOSCALE: return EXL3_PROBE_KV(ANOSCALE);
        case ANODEQ: return EXL3_PROBE_KV(ANODEQ);
        case V4: return launch<V4, BITS, 4>(q, kv, ks, out, ws, T, Hk, G, st);
        case V5: return launch<V5, BITS, 4>(q, kv, ks, out, ws, T, Hk, G, st);
    }
#undef EXL3_PROBE_KV
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// T keys (a multiple of 64), Hk heads, G q rows a head (G <= 16; merged
// Hk * G <= 64), bits in {2, 4, 8}; `var` indexes probes/dequant_probe.py's
// VARIANTS. ks is unused for the bf16 variant; ws (Hk, Hk * G) f32 serves the
// merged ones.
extern "C" int exl3_probe_kv_dequant(const void* q, const void* kv, const void* ks, void* out,
                                     void* ws, int T, int Hk, int G, int bits, int var,
                                     void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool is_merged = var == V4 || var == V5;
    if (T % TK || Hk < 1 || G < 1 || (is_merged ? Hk * G > 64 : G > 16))
        return (int)cudaErrorInvalidValue;
    if (var == BF16) return launch<BF16, 4, 1>(q, kv, ks, out, ws, T, Hk, G, st);
    switch (bits) {
        case 2: return launch_var<2>(var, q, kv, ks, out, ws, T, Hk, G, st);
        case 4: return launch_var<4>(var, q, kv, ks, out, ws, T, Hk, G, st);
        case 8: return launch_var<8>(var, q, kv, ks, out, ws, T, Hk, G, st);
    }
    return (int)cudaErrorInvalidValue;
}
