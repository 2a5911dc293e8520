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
//           any GQA group; any W.
// Output:   (B, 1, Hq, D) f32. Slot j is visible to the query at position p
//           iff 0 <= pos[j] <= p and, with a window, pos[j] > p - window: a
//           stale speculative write holds a future position and masks
//           itself. Scores are scale*q.k, then the softcap; sinks join the
//           denominator. A row that sees no slot gives 0.
// Bound:    every ring slot's K and V bytes once (2 * W * Hk * D * 2 a
//           sequence) and its position, over 3.35 TB/s; the operations
//           (4 * D a visible slot and head) are far below the tensor-core
//           rate.
// Design:   attention_tiles.cuh with RingRows: a tile is 64 consecutive slots
//           of the sequence's ring row (the last cut at W), and with its K/V
//           the block stages the slots' stored positions into shared memory,
//           which the mask tests in place of the key index. The JAX kernel
//           holds the whole ring in VMEM (and declines rings above 6 MB:
//           Gemma-3-27B's 8.6 MB ring decodes through its dense path); here
//           the ring streams through shared memory a tile at a time, so any
//           W fits. HeadDecodeGeo: 16 score rows, one decode token's group of
//           G heads (Gemma-3-27B: G = 2, 128 blocks at batch 8).
#include "attention_tiles.cuh"

extern "C" int exl3_ring_attention(const void* q, const void* k, const void* v, const void* pos,
                                   const void* slots, const void* qpos, const void* sinks,
                                   void* out, int B, int Hq, int Hk, int D, int N, int W,
                                   float scale, int window, float softcap, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (W <= 0) return (int)cudaErrorInvalidValue;
    const RingRows rows{static_cast<const int*>(slots), static_cast<const int*>(pos), N, W};
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    if (D == 128)
        return launch_attention<HeadDecodeGeo<128>>(q, rows, Bf16KV<128>{kb, vb, Hk}, qpos,
                                                    nullptr, sinks, out, B, 1, Hq, Hk, scale,
                                                    window, softcap, st);
    if (D == 64)
        return launch_attention<HeadDecodeGeo<64>>(q, rows, Bf16KV<64>{kb, vb, Hk}, qpos,
                                                   nullptr, sinks, out, B, 1, Hq, Hk, scale,
                                                   window, softcap, st);
    return (int)cudaErrorInvalidValue;
}
