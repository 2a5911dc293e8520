// Packed int-B matmul for Hopper (B = 3, 4, 5, 6): y (m, n) f32 = x (m, k) @ W,
// where `packed` (kp, n) int32 holds W = 32 / B codes a word, plane-major
// (weight row r is code r / kp of word r % kp, biased by 2^(B-1)), k padded
// with zero rows to W * kp, and `scales` (W * kp / 32, n) bf16 holds one scale
// per 32 rows and column. Serves the int3 / int5 / int6 load-time tiers and
// the conversion-time `.sq` tensors (B = 4 too).
//
// Replaces: exllamav3_tpu/ops/q_matmul.py::_intb_matmul_kernel
//           (intb_matmul_pallas) -> exl3_intb_matmul, weights as
//           bf16(code * scale) into bf16 MMAs;
//           exllamav3_tpu/ops/q_matmul.py::_intb_a8_kernel
//           (intb_matmul_pallas_a8) -> exl3_intb_matmul_a8, int8 rows of x
//           times signed codes in int8 MMAs, one per scale group.
// Bound:    at decode (4 / W + 1 / 16) bytes a weight over 3.35 TB/s; at
//           prefill the tensor-core rate, 989 TFLOP/s bf16 or 1,979 TOP/s int8.
// Design:   csrc/packed_matmul.cuh. A word is loaded once and feeds all its W
//           planes; x keeps its own k, and the pad rows at the tail of the
//           last plane are skipped instead of multiplied by padded zeros. The
//           TPU kernels' padding of kp to 128, of rows to 32 and the 0/1
//           scale-expansion matmul do not carry over.
#include "packed_matmul.cuh"

namespace {

template <bool A8>
int launch_bits(int bits, const void* x, const void* packed, const void* scales, void* y, void* ws,
                void* xq, void* xs, int x_is_bf16, int m, int k, int n, int kp, int splits,
                cudaStream_t st) {
    if (bits < 3 || bits > 6) return (int)cudaErrorInvalidValue;
    const int W = 32 / bits;
    if (kp % 32 || (long long)W * kp < k || (long long)W * (kp - 32) >= k)
        return (int)cudaErrorInvalidValue;
    switch (bits) {
        case 3: return packed::launch<3, A8>(x, packed, scales, y, ws, xq, xs, x_is_bf16, m, k, n, kp, splits, st);
        case 4: return packed::launch<4, A8>(x, packed, scales, y, ws, xq, xs, x_is_bf16, m, k, n, kp, splits, st);
        case 5: return packed::launch<5, A8>(x, packed, scales, y, ws, xq, xs, x_is_bf16, m, k, n, kp, splits, st);
        default: return packed::launch<6, A8>(x, packed, scales, y, ws, xq, xs, x_is_bf16, m, k, n, kp, splits, st);
    }
}

}  // namespace

extern "C" int exl3_intb_matmul(const void* x, const void* packed, const void* scales, void* y,
                                void* ws, int m, int k, int n, int kp, int bits, int splits,
                                void* stream) {
    return launch_bits<false>(bits, x, packed, scales, y, ws, nullptr, nullptr, 1, m, k, n, kp,
                              splits, static_cast<cudaStream_t>(stream));
}

extern "C" int exl3_intb_matmul_a8(const void* x, const void* packed, const void* scales, void* y,
                                   void* ws, void* xq, void* xs, int x_is_bf16, int m, int k,
                                   int n, int kp, int bits, int splits, void* stream) {
    return launch_bits<true>(bits, x, packed, scales, y, ws, xq, xs, x_is_bf16, m, k, n, kp,
                             splits, static_cast<cudaStream_t>(stream));
}
