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
//           (pool and rows). ws: B * ceil(Hq / 16) * splits * (16 * 512 + 32)
//           f32, splits = ceil(width / split_keys), width W, MP * epp or T;
//           counters B * ceil(Hq / 16) int32 that are 0 (the kernel leaves
//           them 0); split_keys from ops/flash_attention.py::latent_split_keys
//           over the width.
// Output:   acc (B, 1, Hq, 512) f32 = sum of exp(s - m) * v over the visible
//           keys, m (B, 1, Hq) f32 their largest score s = scale * q.k, l
//           (B, 1, Hq) f32 the sum of exp(s - m). K and V are the same row.
//           Visibility: the ring's by stored position (ring_attention.cu);
//           pool and rows: key j iff j < total_len and j <= q_position (and,
//           in the pool, its page in range). A row that sees no key gives
//           (0, -1e30, 0).
// Bound:    each visible key's 1024-byte row once for all heads, plus acc,
//           m and l out, over 3.35 TB/s; the operations (4 * 512 a visible
//           (head, key) pair) are far below the bf16 tensor-core rate.
// Design:   the split-key kernel of latent_decode.cuh at D = 512 with the
//           STATS epilogue: a block holds 16 heads of one token over a split
//           of the keys (128 heads are 8 head slices), its tiles bulk-copied
//           into shared memory two deep, scores and P.V on the tensor cores,
//           the splits merged in the launch by the last to arrive (a single
//           split writes its own state). The ring (RingRows) and the pool
//           (PoolRows) find each key of a split first, its stored position
//           or its page, and walk only the tiles from the first visible key
//           to the last, copying the visible rows alone; the CSA rows are
//           consecutive (LinearRows). The JAX kernel runs with a finite
//           NEG_INF mask, so on a row that sees no key in a tile it walks it
//           counts exp(0) for each masked key; its merge drops such a row by
//           its m, as the port's does.
#include "latent_decode.cuh"

namespace {

using StatsRows = LatentBf16Rows<KV_ROW>;

}  // namespace

extern "C" int exl3_ring_attention_stats(const void* q, const void* kv, const void* pos,
                                         const void* slots, const void* qpos, void* out, void* m,
                                         void* l, void* ws, void* counters, int B, int Hq, int N,
                                         int W, float scale, int window, int split_keys,
                                         void* stream) {
    if (W <= 0 || N <= 0 || (long long)N * W > INT32_MAX) return (int)cudaErrorInvalidValue;
    const RingRows rows{static_cast<const int*>(slots), static_cast<const int*>(pos), N, W};
    return launch_latent_decode<RingRows, StatsRows, true>(
        q, rows, StatsRows{static_cast<const __nv_bfloat16*>(kv)}, qpos, nullptr, out, ws,
        counters, B, Hq, scale, split_keys, W, static_cast<cudaStream_t>(stream), window, m, l);
}

extern "C" int exl3_pool_attention_stats(const void* q, const void* pool, const void* bt,
                                         const void* qpos, const void* total_lens, void* out,
                                         void* m, void* l, void* ws, void* counters, int B, int Hq,
                                         int MP, int P, int epp, float scale, int split_keys,
                                         void* stream) {
    if (epp <= 0 || MP <= 0 || (long long)P * epp > INT32_MAX) return (int)cudaErrorInvalidValue;
    const PoolRows rows{static_cast<const int*>(bt), MP, P, epp};
    return launch_latent_decode<PoolRows, StatsRows, true>(
        q, rows, StatsRows{static_cast<const __nv_bfloat16*>(pool)}, qpos, total_lens, out, ws,
        counters, B, Hq, scale, split_keys, MP * epp, static_cast<cudaStream_t>(stream), 0, m, l);
}

extern "C" int exl3_rows_attention_stats(const void* q, const void* kv, const void* qpos,
                                         const void* total_lens, void* out, void* m, void* l,
                                         void* ws, void* counters, int B, int Hq, int T,
                                         float scale, int split_keys, void* stream) {
    if (T <= 0) return (int)cudaErrorInvalidValue;
    const LinearRows rows{nullptr, B, T};
    return launch_latent_decode<LinearRows, StatsRows, true>(
        q, rows, StatsRows{static_cast<const __nv_bfloat16*>(kv)}, qpos, total_lens, out, ws,
        counters, B, Hq, scale, split_keys, T, static_cast<cudaStream_t>(stream), 0, m, l);
}
