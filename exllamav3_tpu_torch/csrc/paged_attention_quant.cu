// Paged attention for Hopper over a quantized KV cache with 256-token pages:
// packed 2..8-bit K and V words with one bf16 scale per 32 channels, unpacked
// in the kernel.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel_merged (even
//           widths, merged-head storage) and ::_flash_kernel with k_bits /
//           v_bits > 0 (per-head storage, odd widths as bit planes). The two
//           storages hold the same bytes for an even width, so one entry
//           serves both: it addresses head h of a token at word
//           (token * Hk + h) * D*bits/32 whatever shape the tensor has.
// Inputs:   q (B, S, Hq, D) f32; k_q, v_q int32 packed words and k_s, v_s
//           bf16 scales, (P, 256, Hk, .) or (P, 256, Hk * .); block_tables
//           (B, MP) int32; q_positions (B, S) int32; total_lens (B,) int32;
//           sinks (Hq,) f32 or null. D in {64, 128}; any GQA group; k_bits
//           and v_bits independent in 2..8; compand_a > 0 selects the cubic
//           compander.
// Output:   (B, S, Hq, D) f32. Masking, softcap, sinks and empty rows as in
//           paged_attention.cu.
// Dispatch: S * G <= DECODE_ROWS (decode, verify) launches the split-key
//           decode kernel of attention_decode.cuh: q unrotated, the output in
//           the caller's basis, ws a workspace of B * Hk * splits * S * G *
//           (D + 2) f32 and counters B * Hk int32 that are 0 (the kernel
//           leaves them 0), split_keys from the host's sizing. A longer chunk
//           launches the tile loop of attention_tiles.cuh: q already rotated
//           by the per-32-channel Hadamard, the output in V's rotated basis
//           (the caller rotates it back), ws and counters unused.
// Bound:    decode reads every visible packed K/V byte and scale once
//           (bytes over 3.35 TB/s): bits/16 of the bf16 cache's bytes plus
//           1/16 for the scales; a long prefill chunk is bound by its 4*D
//           operations per visible (query, key) pair at the bf16 rate.
// Design:   decode: attention_decode.cuh (keys split across blocks by whole
//           pages or parts of one, packed words staged with cp.async,
//           double-buffered, f32 FMAs, the splits merged by the last block
//           of each (sequence, kv head)). Prefill: attention_tiles.cuh, with
//           the tile's rows found through the block table (PagedRows) and
//           unpacked into hi + lo bf16 pairs (QuantKV). K and V are never
//           un-rotated and the whole pool is never dequantized, whatever S is.
#include "attention_decode.cuh"

// compand_a = 0 selects the midpoint grid; compand_b is 1 - compand_a.
extern "C" int exl3_paged_attention_quant(
    const void* q, const void* kq, const void* ks, const void* vq, const void* vs, const void* bt,
    const void* qpos, const void* total_lens, const void* sinks, void* out, void* ws,
    void* counters, int B, int S, int Hq, int Hk, int D, int MP, int P, int k_bits, int v_bits,
    float compand_a, float compand_b, float scale, int window, float softcap, int split_keys,
    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (k_bits < 2 || k_bits > 8 || v_bits < 2 || v_bits > 8 || Hk <= 0 || Hq % Hk)
        return (int)cudaErrorInvalidValue;
    const PagedRows rows{static_cast<const int*>(bt), MP, P};
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
                                      split_keys, MP * PAGE, st);
        return launch_attention<HeadGeo<128>>(q, rows, kv, qpos, total_lens, sinks, out, B, S, Hq,
                                              Hk, scale, window, softcap, st);
    }
    if (D == 64) {
        const QuantKV<64> kv{kw, kscale, vw, vscale, Hk, k_bits, v_bits, compand_a, compand_b};
        if (decode)
            return launch_decode<64>(q, rows, kv, qpos, total_lens, sinks, out, ws,
                                     counters, B, S, Hq, Hk, scale, window, softcap,
                                     split_keys, MP * PAGE, st);
        return launch_attention<HeadGeo<64>>(q, rows, kv, qpos, total_lens, sinks, out, B, S, Hq,
                                             Hk, scale, window, softcap, st);
    }
    return (int)cudaErrorInvalidValue;
}
