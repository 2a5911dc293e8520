// Attention for Hopper over a linear quantized KV cache: one row of T slots
// per sequence, packed 2..8-bit K and V words with one bf16 scale per 32
// channels, unpacked in the kernel.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel_merged (even
//           widths, merged-head storage, its pallas_call at :881) and
//           ::_flash_kernel with k_bits / v_bits > 0 (per-head storage, odd
//           widths as bit planes), both with block_tables=None.
// Inputs:   q (B, S, Hq, D) f32; k_q, v_q int32 packed words and k_s, v_s
//           bf16 scales, (N, T, Hk, .) or (N, T, Hk * .), any T; rows (B,)
//           int32 or null, as in linear_attention.cu; q_positions (B, S)
//           int32; total_lens (B,) int32; sinks (Hq,) f32 or null.
//           D in {64, 128}; any GQA group; k_bits and v_bits independent
//           in 2..8; compand_a > 0 selects the cubic compander.
// Output:   (B, S, Hq, D) f32, with the visibility rule of
//           linear_attention.cu.
// Dispatch: as paged_attention_quant.cu: S * G <= DECODE_ROWS launches the
//           split-key decode kernel (q unrotated, the output in the caller's
//           basis, ws and counters as there), a longer chunk the prefill body
//           of attention_prefill.cuh (q rotated, the output in V's rotated
//           basis).
// Bound:    as paged_attention_quant.cu: decode reads every visible packed
//           K/V byte and scale once (bytes over 3.35 TB/s); a long prefill
//           chunk is bound by its 4*D operations per visible (query, key)
//           pair at the bf16 rate.
// Design:   decode: attention_decode.cuh with LinearRows (a split covers
//           split_keys slots of the row; the last tile is cut at T). Prefill:
//           attention_prefill.cuh with LinearRows and QuantKV (as
//           paged_attention_quant.cu; a tile's keys past T are not copied and
//           unpack as zeros, masked). The JAX package dequantizes a whole
//           merged pool for tall chunks (S > 32); this entry takes any S.
#include "attention_decode.cuh"
#include "attention_prefill.cuh"

// compand_a = 0 selects the midpoint grid; compand_b is 1 - compand_a.
// rows: (B,) int32 cache row of each sequence, or null for row b.
extern "C" int exl3_linear_attention_quant(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
    const void* rows_, const void* qpos, const void* total_lens, const void* sinks, void* out,
    void* ws, void* counters, int B, int S, int Hq, int Hk, int D, int N, int T, int k_bits,
    int v_bits, float compand_a, float compand_b, float scale, int window, float softcap,
    int split_keys, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (k_bits < 2 || k_bits > 8 || v_bits < 2 || v_bits > 8 || T <= 0 || Hk <= 0 || Hq % Hk)
        return (int)cudaErrorInvalidValue;
    const LinearRows rows{static_cast<const int*>(rows_), N, T};
    const auto* kw = static_cast<const uint32_t*>(kq);
    const auto* vw = static_cast<const uint32_t*>(vq);
    const auto* kscale = static_cast<const __nv_bfloat16*>(ks);
    const auto* vscale = static_cast<const __nv_bfloat16*>(vs);
    const bool decode = S * (Hq / Hk) <= DECODE_ROWS;
    if (D == 128) {
        const QuantKV<128> kv{kw, kscale, vw, vscale, Hk, k_bits, v_bits, compand_a, compand_b};
        if (decode)
            return launch_decode<128>(q, rows, kv, qpos, total_lens, sinks, out, ws,
                                      counters, B, S, Hq, Hk, scale, window, softcap,
                                      split_keys, T, st);
        return launch_prefill<128>(q, rows, kv, qpos, total_lens, sinks, out, B, S, Hq, Hk,
                                   scale, window, softcap, st);
    }
    if (D == 64) {
        const QuantKV<64> kv{kw, kscale, vw, vscale, Hk, k_bits, v_bits, compand_a, compand_b};
        if (decode)
            return launch_decode<64>(q, rows, kv, qpos, total_lens, sinks, out, ws,
                                     counters, B, S, Hq, Hk, scale, window, softcap,
                                     split_keys, T, st);
        return launch_prefill<64>(q, rows, kv, qpos, total_lens, sinks, out, B, S, Hq, Hk,
                                  scale, window, softcap, st);
    }
    return (int)cudaErrorInvalidValue;
}
