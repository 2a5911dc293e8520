// Grouped-int4 matmul for Hopper: y (m, n) f32 = x (m, k) @ W, where byte r
// of column c of `packed` (k/2, n) holds weight row r in its low nibble and
// row r + k/2 in its high nibble, both biased by +8, and `scales` (k/32, n)
// bf16 holds one scale per 32 rows and column.
//
// Replaces: exllamav3_tpu/ops/q_matmul.py::_int4_matmul_kernel
//           (int4_matmul_pallas) -> exl3_int4_matmul, weights as
//           bf16((nibble - 8) * scale) into bf16 MMAs;
//           exllamav3_tpu/ops/q_matmul.py::_int4_a8_kernel
//           (int4_matmul_pallas_a8, int4_matmul_a8) -> exl3_int4_matmul_a8,
//           int8 rows of x times signed nibbles in int8 MMAs, one per scale
//           group.
// Bound:    at decode 0.5625 bytes a weight over 3.35 TB/s; at prefill the
//           tensor-core rate, 989 TFLOP/s bf16 or 1,979 TOP/s int8.
// Design:   csrc/packed_matmul.cuh, the kernel both packed tiers share. None
//           of the TPU kernels' scale expansion by a 0/1 matmul, int32-lane
//           nibble masks, +8 bookkeeping through a row sum of x, pre-chunked
//           activations or row padding carries over: a lane scales in
//           registers, four bytes are centred by one __vsub4, and any m >= 1
//           runs with the ragged rows masked.
#include "packed_matmul.cuh"

extern "C" int exl3_int4_matmul(const void* x, const void* packed, const void* scales, void* y,
                                void* ws, int m, int k, int n, int splits, void* stream) {
    if (k % 64) return (int)cudaErrorInvalidValue;
    return packed::launch<0, false>(x, packed, scales, y, ws, nullptr, nullptr, 1, m, k, n, k / 2,
                                    splits, static_cast<cudaStream_t>(stream));
}

extern "C" int exl3_int4_matmul_a8(const void* x, const void* packed, const void* scales, void* y,
                                   void* ws, void* xq, void* xs, int x_is_bf16, int m, int k,
                                   int n, int splits, void* stream) {
    if (k % 64) return (int)cudaErrorInvalidValue;
    return packed::launch<0, true>(x, packed, scales, y, ws, xq, xs, x_is_bf16, m, k, n, k / 2,
                                   splits, static_cast<cudaStream_t>(stream));
}
