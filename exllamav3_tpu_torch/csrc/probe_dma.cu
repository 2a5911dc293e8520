// The streaming floor: read an int8 weight once, sum a few of its rows.
//
// Replaces: tools/dma_floor.py::kern (dma_only), the measurement probe that
//           gives the device-memory rate a kernel actually reaches.
// Function: b (kh, n) int8 -> out (16, n) f32, out[r][c] = sum over the
//           bkh-row blocks kk of b[kk * bkh + r][c]. Every byte of b is read.
// Bound:    bytes: kh * n over the memory rate (the 16 x n output is small).
// Design:   the TPU kernel's DMA brings each (bkh, bn) block into VMEM and
//           reads 16 rows of it. Here the first four blocks of each 512
//           columns (grid.y < 4) own the output, 128 columns each: they read
//           the first 16 rows of every bkh block, a lane 16 bytes of one row
//           of every second block with 8 loads in flight, and sum them in
//           registers and, across the two halves, in shared memory, so the
//           sums need no atomics, no zeroed output and no second pass, and
//           are the same in every run. The other blocks each stream a 64-row
//           chunk of the remaining rows over 512 columns (a warp 512
//           contiguous bytes of a row, a lane 16, 8 rows' loads in flight
//           before it waits on any); each warp XORs all it read into one word and
//           stores it to `sink` (4 bytes a warp), so that every byte is read
//           and waited for: a load whose value no instruction reads can be
//           dropped, or left in flight when the warp exits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 512;  // columns a block covers: 32 lanes x 16 bytes
constexpr int ROWS = 64;   // rows a streaming block reads: 8 warps x 8
constexpr int OWNERS = 4;  // blocks that own a column range's output, 128 columns each

__device__ __forceinline__ uint4 load_volatile(const int8_t* p) {
    uint4 v;
    asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
}

__device__ __forceinline__ void add_bytes(float (&acc)[16], const uint4 v) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
}

__global__ void __launch_bounds__(THREADS)
probe_dma_kernel(const int8_t* __restrict__ b, float* __restrict__ out, uint32_t* __restrict__ sink,
                 int kh, int n, int bkh) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (blockIdx.y < OWNERS) {
        // output rows 0..15 of 128 columns: a lane takes 16 bytes of row r of
        // every second block kk, the two halves of the block meet in shared memory
        __shared__ float4 part[16][32];
        const int r = (warp & 3) * 4 + (lane >> 3), phase = warp >> 2;
        const int col = blockIdx.x * COLS + blockIdx.y * (COLS / OWNERS) + (lane & 7) * 16;
        const int nkb = kh / bkh;
        float acc[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
        for (int kk0 = phase; kk0 < nkb; kk0 += 16) {
            uint4 v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
                v[u] = kk0 + 2 * u < nkb
                    ? load_volatile(b + (size_t)((kk0 + 2 * u) * bkh + r) * n + col)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int u = 0; u < 8; ++u) add_bytes(acc, v[u]);
        }
        const int slot = (lane & 7) * 4;
        if (phase == 1)
#pragma unroll
            for (int q = 0; q < 4; ++q)
                part[r][slot + q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                                                acc[4 * q + 3]);
        __syncthreads();
        if (phase == 0) {
            float4* o = reinterpret_cast<float4*>(out + (size_t)r * n + col);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float4 p = part[r][slot + q];
                o[q] = make_float4(acc[4 * q] + p.x, acc[4 * q + 1] + p.y, acc[4 * q + 2] + p.z,
                                   acc[4 * q + 3] + p.w);
            }
        }
        return;
    }
    const int col = blockIdx.x * COLS + lane * 16;
    const int row0 = (blockIdx.y - OWNERS) * ROWS;
    const bool owned = row0 % bkh == 0;  // its first 16 rows are the owners'
    uint4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
        v[i] = owned && i < 2 ? make_uint4(0u, 0u, 0u, 0u)
                              : load_volatile(b + (size_t)(row0 + warp + 8 * i) * n + col);
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) x ^= v[i].x ^ v[i].y ^ v[i].z ^ v[i].w;
    x = __reduce_xor_sync(0xFFFFFFFFu, x);
    if (lane == 0) sink[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 8 + warp] = x;
}

}  // namespace

// kh % bkh == 0, bkh % 64 == 0, n % 512 == 0; sink holds 8 words a block:
// (n / 512) * (4 + kh / 64) * 8
extern "C" int exl3_probe_dma(const void* b, void* out, void* sink, int kh, int n, int bkh,
                              void* stream) {
    if (bkh < ROWS || bkh % ROWS || kh % bkh || n % COLS) return (int)cudaErrorInvalidValue;
    dim3 grid(n / COLS, OWNERS + kh / ROWS);
    probe_dma_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(b), static_cast<float*>(out), static_cast<uint32_t*>(sink), kh,
        n, bkh);
    return (int)cudaGetLastError();
}
