// Absorbed latent (MLA) attention for Hopper over a quantized latent cache,
// paged or linear: the latent's 512 channels as packed 2..8-bit words with one
// bf16 scale per 32 channels, the 64-channel rope key in bf16 beside them.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel in its MLA
//           form with k_bits > 0 (`latent`, v_from_k, d_extra = the rope
//           key's width), its pallas_call at :999, paged and linear.
// Inputs:   q (B, S, Hq, 576) bf16: the latent part already rotated by the
//           per-32-channel Hadamard (and rounded to bf16, as the JAX package
//           rounds its rotated q), the rope part as it is; kv_q int32
//           (., ., 1, 16 * bits) words, kv_s bf16 (., ., 1, 16) scales, k_pe
//           bf16 (., ., 1, 64), paged (P, 256, ...) or linear (N, T, ...);
//           block_tables, rows, q_positions and total_lens as in
//           latent_attention.cu; bits in 2..8 (odd widths as bit planes);
//           compand_a > 0 selects the cubic compander.
// Output:   (B, S, Hq, 512) f32 in the latent's rotated basis (the caller
//           rotates it back), with the visibility rule of latent_attention.cu.
// Bound:    decode reads each visible token's packed latent, scales and rope
//           key once (64 * bits + 32 + 128 bytes; bytes over 3.35 TB/s).
// Design:   attention_tiles.cuh with LatentQuantKV and the geometries of
//           latent_attention.cu (LatentDecodeGeo at S = 1, 210,440 bytes a
//           block; LatentGeo otherwise, 188,424): the latent unpacks into hi +
//           lo bf16 columns (exact), the rope key copies in beside it with a
//           lo term of 0, and the scores take two MMAs (q against hi and lo),
//           P times V three. The
//           JAX kernel folds its channel permutation and group rotation into
//           q and the output; here each field goes to its true channel and
//           only the rotation stays outside.
#include "attention_tiles.cuh"

// compand_a = 0 selects the midpoint grid; compand_b is 1 - compand_a.
// paged: bt (B, MP), MP, P pages; linear: bt null, rows (B,) or null, N, T
extern "C" int exl3_latent_attention_quant(
    const void* q, const void* kq, const void* ks, const void* kpe, const void* bt,
    const void* rows_, const void* qpos, const void* total_lens, void* out, int B, int S, int Hq,
    int MP, int P, int N, int T, int bits, float compand_a, float compand_b, float scale,
    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bits < 2 || bits > 8) return (int)cudaErrorInvalidValue;
    const LatentQuantKV lkv{static_cast<const uint32_t*>(kq), static_cast<const __nv_bfloat16*>(ks),
                            static_cast<const __nv_bfloat16*>(kpe), bits, compand_a, compand_b};
    if (bt == nullptr && T <= 0) return (int)cudaErrorInvalidValue;
    const PagedRows paged{static_cast<const int*>(bt), MP, P};
    const LinearRows linear{static_cast<const int*>(rows_), N, T};
    // decode: one token's heads a block, 64-key tiles; else 32 rows, 32-key tiles
#define EXL3_LAUNCH(GEO, ROWS) launch_attention<GEO>(q, ROWS, lkv, qpos, total_lens, nullptr, out, \
                                                     B, S, Hq, 1, scale, 0, 0.0f, st)
    if (S == 1)
        return bt != nullptr ? EXL3_LAUNCH(LatentDecodeGeo, paged)
                             : EXL3_LAUNCH(LatentDecodeGeo, linear);
    return bt != nullptr ? EXL3_LAUNCH(LatentGeo, paged) : EXL3_LAUNCH(LatentGeo, linear);
#undef EXL3_LAUNCH
}
