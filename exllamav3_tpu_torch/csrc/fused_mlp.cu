// Fused decode MLP for Hopper:
//   acc = sum over intermediate tiles t of bf16(silu(x@Wg_t*sg_t) * (x@Wu_t*su_t)) @ Wd_t
// (m <= 16 rows, f32 out; the caller applies the down scale and bias).
//
// Replaces: exllamav3_tpu/ops/fused_mlp.py::_fused_mlp_kernel
//           (fused_mlp_int8_pallas, dispatched by fused_mlp_int8).
// Inputs:   x (m, h) bf16; gu (h, 2i) int8 [gate | up]; gu_scale (2i,) f32;
//           d (i, h) int8; h % 256 == 0, i % 128 == 0 (checked in Python).
// Bound:    the weight bytes (3*h*i int8) over 3.35 TB/s; the operations
//           (6*m*h*i) are far below the tensor-core rate at m <= 16.
// Design:   the TPU grid walked intermediate tiles in order with one
//           resident accumulator. Blocks on the card run in parallel and in
//           no order, so each block owns one 64-wide intermediate tile:
//           it forms the tile's gate and up products (WMMA bf16, f32
//           accumulate), the bf16 activation, and that tile's whole
//           contribution to the (m, h) output, which it writes to its own
//           slice of a partials buffer. A second kernel adds the slices in
//           tile order, so the result is bitwise stable from run to run.
//           Weights cross device memory once as int8; the intermediate
//           activation never leaves shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int TI = 64;        // intermediate columns per block
constexpr int KC = 64;        // h rows per gate/up chunk
constexpr int NC = 256;       // h columns per down chunk
constexpr int MR = 16;        // rows (m padded to 16)
constexpr int LDX = KC + 8, LDG = 2 * TI + 8, LDD = NC + 8, LDA = TI + 8, LDC = 2 * TI + 4;

constexpr int SZ_X = MR * LDX * 2;
constexpr int SZ_G = KC * LDG * 2;
constexpr int SZ_D = TI * LDD * 2;
constexpr int SZ_UNION = (SZ_X + SZ_G) > SZ_D ? (SZ_X + SZ_G) : SZ_D;
constexpr int SZ_ACT = MR * LDA * 2;
constexpr int SZ_C = (MR * LDC * 4) > (8 * 256 * 4) ? (MR * LDC * 4) : (8 * 256 * 4);

__device__ __forceinline__ uint32_t pack_bf16x2(int8_t a, int8_t b) {
    union { __nv_bfloat162 h; uint32_t u; } cvt;
    cvt.h = __floats2bfloat162_rn((float)a, (float)b);
    return cvt.u;
}

__device__ __forceinline__ void store_i8x16_as_bf16(__nv_bfloat16* dst, uint4 v) {
    const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        o[2 * i] = pack_bf16x2((int8_t)(wd[i] & 0xFF), (int8_t)((wd[i] >> 8) & 0xFF));
        o[2 * i + 1] = pack_bf16x2((int8_t)((wd[i] >> 16) & 0xFF), (int8_t)(wd[i] >> 24));
    }
    reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

__global__ void __launch_bounds__(THREADS)
fused_mlp_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ gu,
                 const float* __restrict__ gu_scale, const int8_t* __restrict__ d,
                 float* __restrict__ partial, int m, int h, int inter) {
    __shared__ __align__(128) unsigned char smem[SZ_UNION + SZ_ACT + SZ_C];
    __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);            // phase A
    __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(smem + SZ_X);     // phase A
    __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(smem);            // phase B
    __nv_bfloat16* Act = reinterpret_cast<__nv_bfloat16*>(smem + SZ_UNION);
    float* Cs = reinterpret_cast<float*>(smem + SZ_UNION + SZ_ACT);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int tile = blockIdx.x, i0 = tile * TI;
    const size_t ld_gu = 2 * (size_t)inter;

    // -- phase A: [g | u] (16 x 128) = x @ [Wg_t | Wu_t]; warp w owns columns 16w..16w+15
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kc = 0; kc < h; kc += KC) {
        if (tid < MR * KC / 8) {  // x chunk: 16 rows x 64 bf16, one vector per thread
            const int r = tid / (KC / 8), c = (tid % (KC / 8)) * 8;
            *reinterpret_cast<uint4*>(&Xs[r * LDX + c]) = r < m
                ? *reinterpret_cast<const uint4*>(x + (size_t)r * h + kc + c)
                : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int i = 0; i < KC * 8 / THREADS; ++i) {  // 64 rows x (4 gate + 4 up vectors)
            const int idx = tid + i * THREADS;
            const int r = idx / 8, v = idx % 8;
            const int src_col = (v < 4 ? i0 : inter + i0) + (v % 4) * 16;
            const uint4 q = *reinterpret_cast<const uint4*>(gu + (size_t)(kc + r) * ld_gu + src_col);
            store_i8x16_as_bf16(&Gs[r * LDG + v * 16], q);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
            wmma::load_matrix_sync(fa, &Xs[kk], LDX);
            wmma::load_matrix_sync(fb, &Gs[kk * LDG + warp * 16], LDG);
            wmma::mma_sync(acc, fa, fb, acc);
        }
        __syncthreads();
    }
    wmma::store_matrix_sync(&Cs[warp * 16], acc, LDC, wmma::mem_row_major);
    __syncthreads();

    // activation, rounded to bf16 as the JAX kernel does: a = silu(g) * u
    for (int e = tid; e < MR * TI; e += THREADS) {
        const int r = e / TI, c = e % TI;
        const float g = Cs[r * LDC + c] * gu_scale[i0 + c];
        const float u = Cs[r * LDC + TI + c] * gu_scale[inter + i0 + c];
        Act[r * LDA + c] = __float2bfloat16_rn(g * (1.0f / (1.0f + expf(-g))) * u);
    }
    __syncthreads();

    // -- phase B: partial[tile] (m x h) = Act (16 x 64) @ Wd_t (64 x h), NC columns at a time
    float* stage = Cs + warp * 256;
    float* out = partial + (size_t)tile * m * h;
    for (int nc = 0; nc < h; nc += NC) {
#pragma unroll
        for (int i = 0; i < TI * NC / 16 / THREADS; ++i) {
            const int idx = tid + i * THREADS;
            const int r = idx / (NC / 16), c = (idx % (NC / 16)) * 16;
            const uint4 q = *reinterpret_cast<const uint4*>(d + (size_t)(i0 + r) * h + nc + c);
            store_i8x16_as_bf16(&Ds[r * LDD + c], q);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < NC / 16 / 8; ++j) {  // 2 output fragments per warp
            const int col = warp * (NC / 8) + j * 16;
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
            wmma::fill_fragment(o, 0.0f);
#pragma unroll
            for (int kk = 0; kk < TI; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
                wmma::load_matrix_sync(fa, &Act[kk], LDA);
                wmma::load_matrix_sync(fb, &Ds[kk * LDD + col], LDD);
                wmma::mma_sync(o, fa, fb, o);
            }
            wmma::store_matrix_sync(stage, o, 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int r = e / 16;
                if (r < m) out[(size_t)r * h + nc + col + e % 16] = stage[e];
            }
            __syncwarp();
        }
        __syncthreads();
    }
}

// out = sum over tiles of partial[tile], in tile order
__global__ void tile_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int count, int tiles) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= count) return;
    float s = 0.0f;
    for (int t = 0; t < tiles; ++t) s += partial[(size_t)t * count + idx];
    out[idx] = s;
}

}  // namespace

extern "C" int exl3_fused_mlp(const void* x, const void* gu, const void* gu_scale, const void* d,
                              void* partial, void* out, int m, int h, int inter, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tiles = inter / TI;
    fused_mlp_kernel<<<tiles, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(gu),
        static_cast<const float*>(gu_scale), static_cast<const int8_t*>(d),
        static_cast<float*>(partial), m, h, inter);
    const int count = m * h;
    tile_reduce_kernel<<<(count + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), count, tiles);
    return (int)cudaGetLastError();
}
