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
// Output:   (m, n) f32 in true row/column order. `scratch` (splits, m, n) f32
//           holds the split-k partial sums when splits > 1.
// Bound:    bytes (K/8 a weight) up to some 80 rows, the MMAs beyond. The
//           decode is no bound but it is what the kernel spends its time
//           on: a weight needs a funnel shift, a multiply-add, two logic
//           operations, an fp16 add and two conversions, and the compiled
//           K=4 3INST tile loop holds 143 instructions per 8 weights
//           besides MMAs, loads and branches (counted by chip_smoke.py
//           in its build for sm_90a), half of them window arithmetic that
//           is not folded per K because the lane's position is a run-time
//           value.
// Design:   the format's tile order is the B fragment of mma.m16n8k16: lane
//           L of a warp owns codes 8L..8L+7 of a 16x16 tile, which are rows
//           (2(L%4), +1, +8, +9) of columns L/4 and L/4+8. So a warp decodes a
//           tile straight into two B fragments in registers, with no shuffle
//           and none of the TPU kernel's permuted row/column orders. The
//           masked pattern ((x*mult+add) & 0x8FFF8FFF) ^ 0x3B603B60 is a
//           half2: its halves add in fp16 (the format's canonical value) and
//           round once to bf16, exactly as the plain version does. Code t of
//           group g is the 16-bit window ending at bit (t+1)K of the group's
//           K-word stream; at wi = 0 it reaches back into the last word of
//           group g-1 of the same tile, group 0 into group 7 (tail-biting).
//           A block of 8 warps owns 128 output columns and up to 128 rows; it
//           stages 128 k of xh and of the words in shared memory per step
//           and keeps up to 8 x 2 accumulator fragments per warp. Blocks
//           split k so that about two blocks per SM exist at decode sizes;
//           the partial sums go to scratch and a second kernel adds them in
//           a fixed order, so results do not change from run to run. More
//           than 128 rows run as further blocks (grid.z) that decode again.
//           Single-buffered staging, no TMA, no wgmma: later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one 16-column tile each
constexpr int BN = 128;       // output columns per block
constexpr int BM = 128;       // rows per block
constexpr int KC = 128;       // k per staged step
constexpr int KT = KC / 16;   // tile rows per step
constexpr int LDA = KC + 8;   // bf16 per staged xh row (conflict-free fragments)
constexpr int LDW = 64 + 8;   // words per staged (tile row, wi) row
constexpr int MAX_MB = BM / 16;

template <int CB>
__device__ __forceinline__ uint32_t decode_bf16(uint32_t code) {
    __half y;
    if constexpr (CB == 2) {
        const uint32_t x = code * 0x83DCD12Du;
        const uint32_t s = __dp4a(x, 0x01010101u, 0u);  // sum of the 4 bytes
        const __half h = __ushort_as_half((unsigned short)(0x6400u + s));
        y = __hfma(h, __ushort_as_half((unsigned short)0x1EEE),
                   __ushort_as_half((unsigned short)0xC931));
    } else {
        const uint32_t x = CB == 0 ? code * 89226354u + 64248484u : code * 0xCBAC1FEDu;
        const uint32_t m = (x & 0x8FFF8FFFu) ^ 0x3B603B60u;
        y = __hadd(__ushort_as_half((unsigned short)(m & 0xFFFFu)),
                   __ushort_as_half((unsigned short)(m >> 16)));
    }
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(__half2float(y)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int K, int CB>
__global__ void __launch_bounds__(THREADS)
exl3_gemm_kernel(const __nv_bfloat16* __restrict__ xh, const uint32_t* __restrict__ words,
                 float* __restrict__ out, int m, int k, int n, int steps_per_split,
                 int a_rows) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
    uint32_t* Ws = reinterpret_cast<uint32_t*>(smem + (size_t)a_rows * LDA * 2);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int n0 = blockIdx.x * BN, split = blockIdx.y, m0 = blockIdx.z * BM;
    const int rows = min(BM, m - m0);
    const int nmb = (rows + 15) / 16;
    const int gh = lane >> 2, gl = lane & 3;  // group of 32 codes, quarter of it
    const int n_words = n / 2;                 // words per (tile row, wi) row

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
        for (int e = tid; e < nmb * 16 * (KC / 8); e += THREADS) {
            const int r = e / (KC / 8), v = e % (KC / 8);
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (r < rows)
                val = *reinterpret_cast<const uint4*>(
                    xh + (size_t)(m0 + r) * k + (size_t)step * KC + v * 8);
            *reinterpret_cast<uint4*>(&As[r * LDA + v * 8]) = val;
        }
        for (int e = tid; e < KT * K * 16; e += THREADS) {
            const int row = e / 16, v = e % 16;  // row = tile row * K + wi
            const uint32_t* src =
                words + ((size_t)step * KT * K + row) * n_words + n0 / 2 + v * 4;
            *reinterpret_cast<uint4*>(&Ws[row * LDW + v * 4]) =
                *reinterpret_cast<const uint4*>(src);
        }
        __syncthreads();

#pragma unroll 1
        for (int kt = 0; kt < KT; ++kt) {
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
                v[j] = decode_bf16<CB>(__funnelshift_r(b, a, sh) & 0xFFFFu);
            }
            uint32_t bf[2][2];
#pragma unroll
            for (int ci = 0; ci < 2; ++ci) {
                bf[ci][0] = v[ci * 4 + 0] | (v[ci * 4 + 1] << 16);
                bf[ci][1] = v[ci * 4 + 2] | (v[ci * 4 + 3] << 16);
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
                    mma_bf16(acc[mb][0], a, bf[0]);
                    mma_bf16(acc[mb][1], a, bf[1]);
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
}

// out[i] = sum over splits of part[s][i], in split order
__global__ void exl3_gemm_reduce(const float4* __restrict__ part, float4* __restrict__ out,
                                 int splits, size_t quads) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= quads) return;
    float4 s = part[i];
    for (int j = 1; j < splits; ++j) {
        const float4 p = part[(size_t)j * quads + i];
        s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    out[i] = s;
}

template <int K, int CB>
int launch(const void* xh, const void* words, void* out, void* scratch, int m, int k, int n,
           int splits, cudaStream_t st) {
    const int a_rows = ((min(m, BM) + 15) / 16) * 16;
    const int smem = a_rows * LDA * 2 + KT * K * LDW * 4;
    static bool attr_set = false;
    if (!attr_set) {
        cudaFuncSetAttribute(exl3_gemm_kernel<K, CB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BM * LDA * 2 + KT * K * LDW * 4);
        attr_set = true;
    }
    const int steps = k / KC;
    const int per = (steps + splits - 1) / splits;
    dim3 grid(n / BN, splits, (m + BM - 1) / BM);
    float* dst = static_cast<float*>(splits > 1 ? scratch : out);
    exl3_gemm_kernel<K, CB><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(xh), static_cast<const uint32_t*>(words), dst, m, k,
        n, per, a_rows);
    int err = (int)cudaGetLastError();
    if (err != 0 || splits == 1) return err;
    const size_t quads = (size_t)m * n / 4;
    exl3_gemm_reduce<<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(
        static_cast<const float4*>(scratch), static_cast<float4*>(out), splits, quads);
    return (int)cudaGetLastError();
}

template <int K>
int launch_cb(int cb, const void* xh, const void* words, void* out, void* scratch, int m, int k,
              int n, int splits, cudaStream_t st) {
    switch (cb) {
        case 0: return launch<K, 0>(xh, words, out, scratch, m, k, n, splits, st);
        case 1: return launch<K, 1>(xh, words, out, scratch, m, k, n, splits, st);
        case 2: return launch<K, 2>(xh, words, out, scratch, m, k, n, splits, st);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// `splits` must leave no split without a step: splits <= k / 128 and
// (splits - 1) * ceil(k / 128 / splits) < k / 128.
extern "C" int exl3_gemm(const void* xh, const void* words, void* out, void* scratch, int m,
                         int k, int n, int K, int cb, int splits, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (m < 1 || k % KC || n % BN || splits < 1) return (int)cudaErrorInvalidValue;
    switch (K) {
        case 1: return launch_cb<1>(cb, xh, words, out, scratch, m, k, n, splits, st);
        case 2: return launch_cb<2>(cb, xh, words, out, scratch, m, k, n, splits, st);
        case 3: return launch_cb<3>(cb, xh, words, out, scratch, m, k, n, splits, st);
        case 4: return launch_cb<4>(cb, xh, words, out, scratch, m, k, n, splits, st);
        case 5: return launch_cb<5>(cb, xh, words, out, scratch, m, k, n, splits, st);
        case 6: return launch_cb<6>(cb, xh, words, out, scratch, m, k, n, splits, st);
        case 7: return launch_cb<7>(cb, xh, words, out, scratch, m, k, n, splits, st);
        case 8: return launch_cb<8>(cb, xh, words, out, scratch, m, k, n, splits, st);
    }
    return (int)cudaErrorInvalidValue;
}
