// Decode attention for Hopper over a sliding-window ring: each sequence's
// sliding-window layer keeps its last W positions in a ring row of W slots
// (slot = position % W), bf16 K/V beside the position each slot holds.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::flash_ring_attention
//           (_flash_kernel with layout="ring", its pallas_call at :1135).
// Inputs:   q (B, 1, Hq, D) f32; k, v (N, W, Hk, D) bf16; pos (N, W) int32,
//           -1 where a slot was never written; slots (B,) int32, the ring
//           row of each sequence (a row out of range sees no key);
//           q_positions (B, 1) int32; sinks (Hq,) f32 or null. D in {64, 128};
//           any GQA group; any W up to 2^21 slots (64 splits of at most
//           DEC_RING_TILES 64-slot tiles).
// Output:   (B, 1, Hq, D) f32. Slot j is visible to the query at position p
//           iff 0 <= pos[j] <= p and, with a window, pos[j] > p - window: a
//           stale speculative write holds a future position and masks
//           itself. Scores are scale*q.k, then the softcap; sinks join the
//           denominator. A row that sees no slot gives 0.
// Dispatch: G <= DECODE_ROWS launches the split-key decode kernel of
//           attention_decode.cuh over RingRows, with ws a workspace of
//           B * Hk * splits * G * (D + 2) f32, counters B * Hk int32 that are
//           0 (the kernel leaves them 0) and split_keys from the host's sizing
//           (ops/flash_attention.py::decode_split_keys over W, at most
//           DEC_RING_TILES tiles a split). A wider group launches the tile
//           loop of attention_tiles.cuh; ws, counters and split_keys are then
//           unused.
// Bound:    the visible slots' K and V bytes once (2 * Hk * D * 2 a slot) and
//           every slot's position, over 3.35 TB/s; the operations (4 * D a
//           visible slot and head) are far below the tensor-core rate.
// Design:   decode: attention_decode.cuh. The W slots of a ring row are cut
//           into splits (Gemma-3-27B at batch 8: 9 splits of 128 slots, 1152
//           blocks); a block reads its split's positions first and stages
//           only the tiles that hold a slot its rows may see, each with its
//           slots' positions beside the K/V rows (cp.async), masks by
//           position, and the last split to finish merges every split of the
//           row. So a ring still filling reads its written slots alone, and a
//           full one spreads over the card instead of one block a (sequence,
//           kv head). The tile loop (wider groups) walks 64-slot tiles of
//           the whole row with the positions staged into shared memory, over
//           the 16-row HeadDecodeGeo. The JAX kernel holds the whole ring in
//           VMEM (and declines rings above 6 MB: Gemma-3-27B's 8.6 MB ring
//           decodes through its dense path); here the ring streams through
//           shared memory a tile at a time, so any W fits.
#include "attention_decode.cuh"

extern "C" int exl3_ring_attention(const void* q, const void* k, const void* v, const void* pos,
                                   const void* slots, const void* qpos, const void* sinks,
                                   void* out, void* ws, void* counters, int B, int Hq, int Hk,
                                   int D, int N, int W, float scale, int window, float softcap,
                                   int split_keys, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W <= 0 || Hk <= 0 || Hq % Hk) return (int)cudaErrorInvalidValue;
    const RingRows rows{static_cast<const int*>(slots), static_cast<const int*>(pos), N, W};
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    const bool decode = Hq / Hk <= DECODE_ROWS;
    if (D == 128) {
        const Bf16KV<128> kv{kb, vb, Hk};
        if (decode)
            return launch_decode_bf16(q, rows, kv, qpos, nullptr, sinks, out, ws, counters, B, 1,
                                      Hq, Hk, scale, window, softcap, split_keys, W, st);
        return launch_attention<HeadDecodeGeo<128>>(q, rows, kv, qpos, nullptr, sinks, out, B, 1,
                                                    Hq, Hk, scale, window, softcap, st);
    }
    if (D == 64) {
        const Bf16KV<64> kv{kb, vb, Hk};
        if (decode)
            return launch_decode_bf16(q, rows, kv, qpos, nullptr, sinks, out, ws, counters, B, 1,
                                      Hq, Hk, scale, window, softcap, split_keys, W, st);
        return launch_attention<HeadDecodeGeo<64>>(q, rows, kv, qpos, nullptr, sinks, out, B, 1,
                                                   Hq, Hk, scale, window, softcap, st);
    }
    return (int)cudaErrorInvalidValue;
}
