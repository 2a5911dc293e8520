// DeepSeek-V4's decode attention for Hopper: three key sources, each
// attended on its own, returning the unnormalised online-softmax state that
// the caller merges with the per-head sink logit in one softmax.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel with
//           return_stats=True (its pallas_call at :999, and the ring form's
//           at :1135), as modules/dsv4_attn.py::_decode_kernel calls it:
//           flash_ring_attention over the sliding ring, flash_attention with
//           `latent` over the HCA pool paged through the token block table,
//           and over the CSA indexer's selected entries gathered into a
//           linear layout.
// Inputs:   q (B, 1, Hq, 512) bf16 (any Hq; all heads share the one kv row);
//           ring: kv (N, W, 512) bf16, pos (N, W) int32 (-1 never written),
//           slots (B,) int32, window; pool: pool (P, epp, 512) bf16,
//           block_tables (B, MP) int32, the pool holding `epp` entries a page
//           (HCA: 256 / 128 = 2); rows: kv (B, T, 512) bf16, row b the
//           sequence's own. q_positions (B, 1) int32; total_lens (B,) int32
//           (pool and rows).
// Output:   acc (B, 1, Hq, 512) f32 = sum of exp(s - m) * v over the visible
//           keys, m (B, 1, Hq) f32 their largest score s = scale * q.k, l
//           (B, 1, Hq) f32 the sum of exp(s - m). K and V are the same row.
//           Visibility: the ring's by stored position (ring_attention.cu);
//           pool and rows: key j iff j < total_len and j <= q_position. A
//           row that sees no key gives (0, -1e30, 0).
// Bound:    each visible key's 1024-byte row once for all heads, plus acc,
//           m and l out, over 3.35 TB/s; the operations (4 * 512 a visible
//           (head, key) pair) are far below the bf16 tensor-core rate.
// Design:   attention_tiles.cuh with STATS, KvRowDecodeGeo (16 heads a
//           block: 128 heads are 8 head slices, 64 blocks at batch 8; one
//           64-key K tile that is also V, 125,448 bytes of shared memory)
//           and RowKV<512>; RingRows for the ring, PoolRows for the pool
//           (each key's page found on its own, 32 pages a 64-key tile),
//           LinearRows for the gathered entries. The JAX kernel runs with a
//           finite NEG_INF mask, so on a row that sees no key in a tile it
//           walks it counts exp(0) for each masked key; its merge drops such
//           a row by its m, as the port's does.
#include "attention_tiles.cuh"

extern "C" int exl3_ring_attention_stats(const void* q, const void* kv, const void* pos,
                                         const void* slots, const void* qpos, void* out, void* m,
                                         void* l, int B, int Hq, int N, int W, float scale,
                                         int window, void* stream) {
    if (W <= 0) return (int)cudaErrorInvalidValue;
    const RingRows rows{static_cast<const int*>(slots), static_cast<const int*>(pos), N, W};
    return launch_attention<KvRowDecodeGeo, RingRows, RowKV<KV_ROW>, true>(
        q, rows, RowKV<KV_ROW>{static_cast<const __nv_bfloat16*>(kv)}, qpos, nullptr, nullptr,
        out, B, 1, Hq, 1, scale, window, 0.0f, static_cast<cudaStream_t>(stream), m, l);
}

extern "C" int exl3_pool_attention_stats(const void* q, const void* pool, const void* bt,
                                         const void* qpos, const void* total_lens, void* out,
                                         void* m, void* l, int B, int Hq, int MP, int P, int epp,
                                         float scale, void* stream) {
    if (epp <= 0 || MP <= 0) return (int)cudaErrorInvalidValue;
    const PoolRows rows{static_cast<const int*>(bt), MP, P, epp};
    return launch_attention<KvRowDecodeGeo, PoolRows, RowKV<KV_ROW>, true>(
        q, rows, RowKV<KV_ROW>{static_cast<const __nv_bfloat16*>(pool)}, qpos, total_lens,
        nullptr, out, B, 1, Hq, 1, scale, 0, 0.0f, static_cast<cudaStream_t>(stream), m, l);
}

extern "C" int exl3_rows_attention_stats(const void* q, const void* kv, const void* qpos,
                                         const void* total_lens, void* out, void* m, void* l,
                                         int B, int Hq, int T, float scale, void* stream) {
    if (T <= 0) return (int)cudaErrorInvalidValue;
    const LinearRows rows{nullptr, B, T};
    return launch_attention<KvRowDecodeGeo, LinearRows, RowKV<KV_ROW>, true>(
        q, rows, RowKV<KV_ROW>{static_cast<const __nv_bfloat16*>(kv)}, qpos, total_lens, nullptr,
        out, B, 1, Hq, 1, scale, 0, 0.0f, static_cast<cudaStream_t>(stream), m, l);
}
