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
// Design:   decode (S = 1) takes the split-key kernel of latent_decode.cuh
//           (a block holds one token's 16 heads over a split of the keys,
//           tiles staged by cp.async, scores and P.V on the tensor cores, the
//           splits merged in the launch). Longer chunks (verify, prefill) take
//           the body of latent_prefill.cuh: a pre-pass lays the keys the
//           launch can see out as swizzled 32-key tiles in a scratch the
//           caller hands over; then 64 (token, head) rows a block on
//           warpgroup MMAs, two warpgroups each owning 256 of V's columns,
//           the tiles staged by bulk copies four deep, V read from the K tile
//           already in shared memory; q is bf16, so the scores take one MMA;
//           P enters as hi + lo bf16 as in the other entries.
#include "latent_prefill.cuh"

// paged: bt (B, MP), MP, P pages; linear: bt null, rows (B,) or null, N, T.
// Decode (S = 1) needs ws, counters and split_keys (latent_decode.cuh); a
// longer chunk takes ws as the scratch of its tiles (the pre-pass's: B *
// ceil(W / 32) * 32 * 576 bf16, W the layout's keys a sequence: MP * 256, or
// T) and no counters.
extern "C" int exl3_latent_attention(const void* q, const void* kv, const void* bt,
                                     const void* rows_, const void* qpos, const void* total_lens,
                                     void* out, void* ws, void* counters, int B, int S, int Hq,
                                     int MP, int P, int N, int T, float scale, int split_keys,
                                     void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bt == nullptr && T <= 0) return (int)cudaErrorInvalidValue;
    const PagedRows paged{static_cast<const int*>(bt), MP, P};
    const LinearRows linear{static_cast<const int*>(rows_), N, T};
    if (S == 1) {
        const LatentBf16Rows<LAT_D> lkv{static_cast<const __nv_bfloat16*>(kv)};
        return bt != nullptr ? launch_latent_decode(q, paged, lkv, qpos, total_lens, out, ws,
                                                    counters, B, Hq, scale, split_keys, MP * PAGE, st)
                             : launch_latent_decode(q, linear, lkv, qpos, total_lens, out, ws,
                                                    counters, B, Hq, scale, split_keys, T, st);
    }
    const LatentBf16Src src{static_cast<const __nv_bfloat16*>(kv)};
    return bt != nullptr
               ? launch_latent_prefill(q, paged, src, ws, MP * PAGE, qpos, total_lens, out, B, S,
                                       Hq, scale, st)
               : launch_latent_prefill(q, linear, src, ws, T, qpos, total_lens, out, B, S, Hq,
                                       scale, st);
}
