// Selected-expert MoE MLP for Hopper (decode shapes, T <= 16 rows):
//   out[t] = sum_j topv[t,j] * (bf16(silu(x_t @ wg[e]) * (x_t @ wu[e])) @ wd[e]),  e = topi[t,j]
// (f32 out; f32 sums, the activation rounded to bf16 before the down product).
//
// Replaces: exllamav3_tpu/ops/moe_gemm.py::_moe_kernel (selected_expert_mlp).
// Inputs:   x (T, h) bf16; topi (T, k) int32; topv (T, k) f32; wg, wu (E, h, i) bf16;
//           wd (E, i, h) bf16; h % 128 == 0, i % 64 == 0 (checked in Python).
// Bound:    the bytes of the distinct routed experts (3*h*i bf16 each) plus x and out
//           over 3.35 TB/s; the operations (6*T*k*h*i) are far below the card's rates
//           at T <= 16.
// Design:   the TPU grid walked (token, intermediate block, slot) in order, with the
//           expert id in scalar prefetch picking each step's weight tiles and one
//           resident (T, h) accumulator. Blocks on the card run in parallel and in no
//           order, so each block owns one (routed slot, 64-wide intermediate tile):
//           it loads its token's row of x, reads the tile's gate and up columns once
//           (a 128-byte run of each of the h rows), forms the 64 gate and up sums in
//           f32 on the CUDA cores (one row of x: a tensor-core tile would be 15/16
//           padding), rounds the activation to bf16 in shared memory, and reads the
//           tile's 64 down rows once to form its contribution to the (h,) output,
//           which it writes to its own slice of a partials buffer. A second kernel
//           adds the slices, each scaled by its slot's routing weight, in a fixed
//           order, so the result is bitwise stable from run to run (no float atomics).
//           Every weight byte of a routed slot crosses device memory once in 16-byte
//           loads; slots that share an expert read it again (grouping the slots by
//           expert is the first improvement, not made here). An expert id outside
//           [0, E) contributes nothing.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TI = 64;               // intermediate columns per block
constexpr int VEC = 8;               // bf16 values in one 16-byte load
constexpr int COLS = TI / VEC;       // threads that span one row of a gate/up tile
constexpr int RG = THREADS / COLS;   // row groups of the gate/up sums
constexpr int RED_X = 32, RED_Y = 8; // reduce block: 32 columns x 8 partial sums

__device__ __forceinline__ void bf16x8_to_f32(const uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);           // the lower address holds element 2i
        f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
}

__global__ void __launch_bounds__(THREADS)
moe_tile_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ topi,
                const __nv_bfloat16* __restrict__ wg, const __nv_bfloat16* __restrict__ wu,
                const __nv_bfloat16* __restrict__ wd, float* __restrict__ partial,
                int k, int h, int inter, int E) {
    extern __shared__ __align__(16) float smem[];
    float* xs = smem;                  // (h,) the token's row of x
    float* red = xs + h;               // (2, RG, TI) gate and up sums by row group
    float* act = red + 2 * RG * TI;    // (TI,) bf16-rounded activation

    const int slot = blockIdx.x, tile = blockIdx.y, tid = threadIdx.x;
    const int t = slot / k;
    const int e = topi[slot];
    float* out = partial + ((size_t)slot * gridDim.y + tile) * h;
    if (e < 0 || e >= E) {
        for (int n = tid; n < h; n += THREADS) out[n] = 0.0f;
        return;
    }
    const int i0 = tile * TI;

    for (int c = tid * VEC; c < h; c += THREADS * VEC) {
        float f[VEC];
        bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(x + (size_t)t * h + c)), f);
#pragma unroll
        for (int q = 0; q < VEC; ++q) xs[c + q] = f[q];
    }
    __syncthreads();

    // -- gate and up: thread (rg, cg) sums rows rg, rg + RG, ... of columns cg..cg+7
    const int cg = (tid % COLS) * VEC, rg = tid / COLS;
    const size_t ebase = (size_t)e * h * inter + i0 + cg;
    const __nv_bfloat16* G = wg + ebase;
    const __nv_bfloat16* U = wu + ebase;
    float ag[VEC] = {}, au[VEC] = {};
#pragma unroll 4
    for (int r = rg; r < h; r += RG) {
        float fg[VEC], fu[VEC];
        bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(G + (size_t)r * inter)), fg);
        bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(U + (size_t)r * inter)), fu);
        const float xr = xs[r];
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            ag[q] = fmaf(xr, fg[q], ag[q]);
            au[q] = fmaf(xr, fu[q], au[q]);
        }
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
        red[rg * TI + cg + q] = ag[q];
        red[(RG + rg) * TI + cg + q] = au[q];
    }
    __syncthreads();

    // activation, rounded to bf16 as the JAX kernel does: a = silu(g) * u
    if (tid < TI) {
        float g = 0.0f, u = 0.0f;
        for (int r = 0; r < RG; ++r) {
            g += red[r * TI + tid];
            u += red[(RG + r) * TI + tid];
        }
        act[tid] = __bfloat162float(__float2bfloat16_rn(g * (1.0f / (1.0f + expf(-g))) * u));
    }
    __syncthreads();

    // -- down: out[n] = sum over the tile's 64 rows c of act[c] * wd[e, i0 + c, n]
    const __nv_bfloat16* D = wd + ((size_t)e * inter + i0) * h;
    for (int n0 = tid * VEC; n0 < h; n0 += THREADS * VEC) {
        float acc[VEC] = {};
#pragma unroll 8
        for (int c = 0; c < TI; ++c) {
            float f[VEC];
            bf16x8_to_f32(__ldg(reinterpret_cast<const uint4*>(D + (size_t)c * h + n0)), f);
            const float a = act[c];
#pragma unroll
            for (int q = 0; q < VEC; ++q) acc[q] = fmaf(a, f[q], acc[q]);
        }
        reinterpret_cast<float4*>(out + n0)[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        reinterpret_cast<float4*>(out + n0)[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
}

// out[t, n] = sum over (slot j, tile) of topv[t, j] * partial[t*k + j, tile, n]; thread
// (tx, ty) of a block sums every RED_Y-th (j, tile) pair of column n, then the RED_Y sums
// add in order
__global__ void __launch_bounds__(RED_X * RED_Y)
moe_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ topv,
                  float* __restrict__ out, int k, int h, int tiles) {
    __shared__ float sums[RED_Y][RED_X];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int t = blockIdx.y, n = blockIdx.x * RED_X + tx;
    float s = 0.0f;
    for (int q = ty; q < k * tiles; q += RED_Y) {
        const int j = q / tiles, tile = q % tiles;
        s += topv[t * k + j] * partial[((size_t)(t * k + j) * tiles + tile) * h + n];
    }
    sums[ty][tx] = s;
    __syncthreads();
    if (ty == 0) {
        float r = 0.0f;
#pragma unroll
        for (int y = 0; y < RED_Y; ++y) r += sums[y][tx];
        out[(size_t)t * h + n] = r;
    }
}

}  // namespace

extern "C" int exl3_moe_mlp(const void* x, const void* topi, const void* topv, const void* wg,
                            const void* wu, const void* wd, void* partial, void* out, int T,
                            int k, int h, int inter, int E, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int tiles = inter / TI;
    const size_t smem = (size_t)(h + 2 * RG * TI + TI) * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            moe_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    moe_tile_kernel<<<dim3(T * k, tiles), THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(topi),
        static_cast<const __nv_bfloat16*>(wg), static_cast<const __nv_bfloat16*>(wu),
        static_cast<const __nv_bfloat16*>(wd), static_cast<float*>(partial), k, h, inter, E);
    moe_reduce_kernel<<<dim3(h / RED_X, T), dim3(RED_X, RED_Y), 0, st>>>(
        static_cast<const float*>(partial), static_cast<const float*>(topv),
        static_cast<float*>(out), k, h, tiles);
    return (int)cudaGetLastError();
}
