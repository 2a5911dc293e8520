// Absorbed latent (MLA) attention for Hopper over a quantized latent cache,
// paged or linear: the latent's 512 channels as packed 2..8-bit words with one
// bf16 scale per 32 channels, the 64-channel rope key in bf16 beside them.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel in its MLA
//           form with k_bits > 0 (`latent`, v_from_k, d_extra = the rope
//           key's width), its pallas_call at :999, paged and linear.
// Inputs:   q (B, S, Hq, 576) bf16: at S = 1 as the module hands it over; at
//           S > 1 the latent part already rotated by the per-32-channel
//           Hadamard (and rounded to bf16, as the JAX package rounds its
//           rotated q), the rope part as it is; kv_q int32
//           (., ., 1, 16 * bits) words, kv_s bf16 (., ., 1, 16) scales, k_pe
//           bf16 (., ., 1, 64), paged (P, 256, ...) or linear (N, T, ...);
//           block_tables, rows, q_positions and total_lens as in
//           latent_attention.cu; bits in 2..8 (odd widths as bit planes);
//           compand_a > 0 selects the cubic compander.
// Output:   (B, S, Hq, 512) f32, at S > 1 in the latent's rotated basis (the
//           caller rotates it back), with the visibility rule of
//           latent_attention.cu.
// Bound:    decode reads each visible token's packed latent, scales and rope
//           key once (64 * bits + 32 + 128 bytes; bytes over 3.35 TB/s); a
//           long prefill chunk is bound by its 2*(576 + 512) operations per
//           visible (query head, key) pair at the bf16 tensor-core rate.
// Design:   decode (S = 1) takes the split-key kernel of latent_decode.cuh
//           over LatentQuantRows: each split stages its tiles' packed words,
//           scales and rope keys by bulk copies and unpacks a tile in shared
//           memory into hi + lo bf16 columns (exact), the rope key beside them
//           with a lo term of 0; the scores take two MMAs (q against hi and
//           lo), P times V three; q is rotated as it is loaded and the output
//           in the merge. Longer chunks take the body of latent_prefill.cuh:
//           its pre-pass dequantizes the keys the launch can see into hi + lo
//           bf16 rows, laid out as swizzled 32-key tiles in a scratch the
//           caller hands over; the body stages them by bulk copies, two MMAs
//           a score, three a P.V term. The JAX kernel
//           folds its channel permutation and group rotation into q and the
//           output; here each field goes to its true channel and only the
//           rotation stays outside.
#include "latent_prefill.cuh"

// compand_a = 0 selects the midpoint grid; compand_b is 1 - compand_a.
// paged: bt (B, MP), MP, P pages; linear: bt null, rows (B,) or null, N, T.
// Decode (S = 1) needs ws, counters and split_keys (latent_decode.cuh); a
// longer chunk takes ws as the scratch of its tiles (the pre-pass's: B *
// ceil(W / 32) * 32 * 1088 bf16, W the layout's keys a sequence: MP * 256, or
// T) and no counters.
extern "C" int exl3_latent_attention_quant(
    const void* q, const void* kq, const void* ks, const void* kpe, const void* bt,
    const void* rows_, const void* qpos, const void* total_lens, void* out, void* ws,
    void* counters, int B, int S, int Hq, int MP, int P, int N, int T, int bits, float compand_a,
    float compand_b, float scale, int split_keys, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bits < 2 || bits > 8) return (int)cudaErrorInvalidValue;
    if (bt == nullptr && T <= 0) return (int)cudaErrorInvalidValue;
    const PagedRows paged{static_cast<const int*>(bt), MP, P};
    const LinearRows linear{static_cast<const int*>(rows_), N, T};
    const auto* words = static_cast<const uint32_t*>(kq);
    const auto* scales = static_cast<const __nv_bfloat16*>(ks);
    const auto* rope = static_cast<const __nv_bfloat16*>(kpe);
    if (S == 1) {
        const LatentQuantRows lkv{words, scales, rope, bits, compand_a, compand_b};
        return bt != nullptr ? launch_latent_decode(q, paged, lkv, qpos, total_lens, out, ws,
                                                    counters, B, Hq, scale, split_keys, MP * PAGE, st)
                             : launch_latent_decode(q, linear, lkv, qpos, total_lens, out, ws,
                                                    counters, B, Hq, scale, split_keys, T, st);
    }
    const LatentQuantSrc src{words, scales, rope, bits, compand_a, compand_b};
    return bt != nullptr
               ? launch_latent_prefill(q, paged, src, ws, MP * PAGE, qpos, total_lens, out, B, S,
                                       Hq, scale, st)
               : launch_latent_prefill(q, linear, src, ws, T, qpos, total_lens, out, B, S, Hq,
                                       scale, st);
}
