// Absorbed latent (MLA) attention for Hopper over a bf16 latent cache, paged
// (256-token pages) or linear (one row of T slots per sequence).
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel in its MLA
//           form (flash_attention with `latent`: Hk = 1, v_from_k), its
//           pallas_call at :999, paged and linear.
// Inputs:   q (B, S, Hq, 576) bf16, [q_nope @ W_UK | rope(q_pe)] as the MLA
//           module hands it over; kv (P, 256, 1, 576) paged or (N, T, 1, 576)
//           linear bf16, each row [c_kv (512) | rope(k_pe) (64)];
//           block_tables (B, MP) int32 (paged) or rows (B,) int32 or null
//           (linear, as in linear_attention.cu); q_positions (B, S) int32;
//           total_lens (B,) int32. Any Hq.
// Output:   (B, S, Hq, 512) f32: softmax(scale * q.k) over the visible keys
//           times V, V being the leading 512 channels of each K row. Key j
//           is visible to a query at position p iff j < total_len, j <= p
//           and j lies in the layout; a row that sees no key gives 0.
// Bound:    decode reads each visible latent row once, 1152 bytes a token
//           for all heads (bytes over 3.35 TB/s); a long prefill chunk is
//           bound by its 2*(576 + 512) operations per visible (query head,
//           key) pair at the bf16 tensor-core rate.
// Design:   attention_tiles.cuh with LatentKV, V read from the K tile
//           already in shared memory. Decode (S = 1) takes LatentDecodeGeo:
//           a block holds 16 heads of one token (Hq / 16 head slices a
//           sequence) and walks 64-key tiles (135,688 bytes a block); longer
//           chunks take LatentGeo: 32 (token, head) rows and 32-key tiles
//           (151,048 bytes). q is bf16, so the scores take one MMA; P enters
//           as hi + lo bf16 as in the other entries.
#include "attention_tiles.cuh"

// paged: bt (B, MP), MP, P pages; linear: bt null, rows (B,) or null, N, T
extern "C" int exl3_latent_attention(const void* q, const void* kv, const void* bt,
                                     const void* rows_, const void* qpos, const void* total_lens,
                                     void* out, int B, int S, int Hq, int MP, int P, int N, int T,
                                     float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const LatentKV lkv{static_cast<const __nv_bfloat16*>(kv)};
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
