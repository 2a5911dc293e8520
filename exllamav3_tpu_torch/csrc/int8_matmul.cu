// int8 dequant matmul for Hopper: y = (x @ W_q) * scale[col], f32 out.
//
// Replaces: exllamav3_tpu/ops/q_matmul.py::_int8_matmul_kernel
//           (int8_matmul_pallas), which the JAX package reaches through
//           int8_matmul.
// Inputs:   x (m, k) bf16 row-major, W_q (k, n) int8 row-major,
//           scale (n,) f32; k % 64 == 0, n % 64 == 0 (checked by the
//           Python wrapper): the last column tile and the last k tile are
//           cut at n and k (DeepSeek-V2-Lite's kv_a projection has n = 576,
//           its dense down projection k = 10944).
// Bound:    at decode (m <= 16) the weight bytes: 1 byte per weight over
//           3.35 TB/s; at prefill (m up to 2048) the bf16 tensor-core rate,
//           2*m*k*n operations over 989 TFLOP/s.
// Design:   W_q crosses device memory once as int8 and becomes bf16 only
//           in shared memory, so the bytes read are the int8 bytes. Tiles
//           are multiplied with warp-level bf16 MMA (WMMA -> mma.sync),
//           accumulating in f32. The next k tile is fetched into registers
//           while the current one is multiplied. Decode rows (m <= 16) use
//           16 x 128 x 128 tiles and split k across blocks so that a few
//           column tiles still fill the card; the partial sums go to a
//           workspace and a second kernel adds them in a fixed order
//           (deterministic) and applies the scale. Prefill uses
//           128 x 128 x 32 tiles. No TMA, wgmma or persistent scheduling yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;  // 8 warps

__device__ __forceinline__ uint32_t pack_bf16x2(int8_t a, int8_t b) {
    union { __nv_bfloat162 h; uint32_t u; } cvt;
    cvt.h = __floats2bfloat162_rn((float)a, (float)b);
    return cvt.u;
}

// 16 int8 -> 16 bf16 (32 bytes) at dst
__device__ __forceinline__ void store_i8x16_as_bf16(__nv_bfloat16* dst, uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int8_t b0 = (int8_t)(w[i] & 0xFF), b1 = (int8_t)((w[i] >> 8) & 0xFF);
        const int8_t b2 = (int8_t)((w[i] >> 16) & 0xFF), b3 = (int8_t)(w[i] >> 24);
        o[2 * i] = pack_bf16x2(b0, b1);
        o[2 * i + 1] = pack_bf16x2(b2, b3);
    }
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

template <int BM, int BN, int BK, int WARPS_M, int WARPS_N>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int m, int k, int n, int k_per_split, int splits) {
    constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
    constexpr int FM = WM / 16, FN = WN / 16;
    constexpr int LDA = BK + 8, LDB = BN + 8;            // bf16 elements
    constexpr int A_VEC = BM * BK / 8 / THREADS;         // 8 bf16 per 16-byte vector
    constexpr int B_VEC = BK * BN / 16 / THREADS;        // 16 int8 per 16-byte vector
    static_assert(A_VEC >= 1 && B_VEC >= 1 && WARPS_M * WARPS_N == THREADS / 32, "tiling");

    __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
    __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
    __shared__ __align__(128) float Cs[THREADS / 32][16 * 16];

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    const int split = blockIdx.z;
    const int kbeg = split * k_per_split;
    const int kend = min(kbeg + k_per_split, k);
    const int ntiles = (kend - kbeg + BK - 1) / BK;  // the last may be cut at kend

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    uint4 a_reg[A_VEC], b_reg[B_VEC];
    auto load_tile = [&](int kt) {
        const int k0 = kbeg + kt * BK;
#pragma unroll
        for (int i = 0; i < A_VEC; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
            const int grow = row0 + r;
            a_reg[i] = grow < m && k0 + c < kend
                ? *reinterpret_cast<const uint4*>(x + (size_t)grow * k + k0 + c)
                : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int i = 0; i < B_VEC; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / (BN / 16), c = (idx % (BN / 16)) * 16;
            // n and k are multiples of 64: a vector lies wholly inside or outside
            b_reg[i] = k0 + r < kend && col0 + c < n
                ? *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * n + col0 + c)
                : make_uint4(0, 0, 0, 0);
        }
    };
    auto store_tile = [&]() {
#pragma unroll
        for (int i = 0; i < A_VEC; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / (BK / 8), c = (idx % (BK / 8)) * 8;
            *reinterpret_cast<uint4*>(&As[r * LDA + c]) = a_reg[i];
        }
#pragma unroll
        for (int i = 0; i < B_VEC; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / (BN / 16), c = (idx % (BN / 16)) * 16;
            store_i8x16_as_bf16(&Bs[r * LDB + c], b_reg[i]);
        }
    };

    load_tile(0);
    for (int kt = 0; kt < ntiles; ++kt) {
        store_tile();
        __syncthreads();
        if (kt + 1 < ntiles) load_tile(kt + 1);  // in flight during the MMAs
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[FM];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[FN];
#pragma unroll
            for (int i = 0; i < FM; ++i)
                wmma::load_matrix_sync(fa[i], &As[(wm * WM + i * 16) * LDA + kk], LDA);
#pragma unroll
            for (int j = 0; j < FN; ++j)
                wmma::load_matrix_sync(fb[j], &Bs[kk * LDB + wn * WN + j * 16], LDB);
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }

    // epilogue: with one split the scaled result goes straight to y, else
    // the raw partial sum goes to workspace slice `split`
    float* dst = out + (size_t)split * m * n;
    const bool apply_scale = splits == 1;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
            wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int grow = row0 + wm * WM + i * 16 + e / 16;
                const int gcol = col0 + wn * WN + j * 16 + e % 16;
                if (grow < m && gcol < n) {
                    const float v = Cs[warp][e];
                    dst[(size_t)grow * n + gcol] = apply_scale ? v * scale[gcol] : v;
                }
            }
            __syncwarp();
        }
}

// y = scale * sum over splits of ws[split], summed in split order
__global__ void splitk_reduce_kernel(const float4* __restrict__ ws, const float* __restrict__ scale,
                                     float4* __restrict__ y, int m, int n, int splits) {
    const size_t total4 = (size_t)m * n / 4;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total4) return;
    float4 s = ws[idx];
    for (int sp = 1; sp < splits; ++sp) {
        const float4 v = ws[sp * total4 + idx];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    const int col = (int)((idx * 4) % n);
    s.x *= scale[col]; s.y *= scale[col + 1]; s.z *= scale[col + 2]; s.w *= scale[col + 3];
    y[idx] = s;
}

}  // namespace

extern "C" int exl3_int8_matmul(const void* x, const void* w, const void* scale, void* y, void* ws,
                                int m, int k, int n, int splits, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int k_per_split = k / splits;
    float* dst = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(y);
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* wp = static_cast<const int8_t*>(w);
    const auto* sp = static_cast<const float*>(scale);
    if (m <= 16) {
        dim3 grid((n + 127) / 128, (m + 15) / 16, splits);
        int8_matmul_kernel<16, 128, 128, 1, 8><<<grid, THREADS, 0, st>>>(
            xp, wp, sp, dst, m, k, n, k_per_split, splits);
    } else {
        dim3 grid((n + 127) / 128, (m + 127) / 128, splits);
        int8_matmul_kernel<128, 128, 32, 2, 4><<<grid, THREADS, 0, st>>>(
            xp, wp, sp, dst, m, k, n, k_per_split, splits);
    }
    if (splits > 1) {
        const size_t total4 = (size_t)m * n / 4;
        const int blocks = (int)((total4 + 255) / 256);
        splitk_reduce_kernel<<<blocks, 256, 0, st>>>(
            static_cast<const float4*>(ws), sp, static_cast<float4*>(y), m, n, splits);
    }
    return (int)cudaGetLastError();
}
