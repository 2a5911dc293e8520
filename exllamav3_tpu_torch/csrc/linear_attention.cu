// Attention for Hopper over a linear bf16 KV cache: one row of T slots per
// sequence, slot == token position.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel in its linear
//           layout with unquantized K/V (flash_attention with
//           block_tables=None, its pallas_call at :999).
// Inputs:   q (B, S, Hq, D) f32; k, v (N, T, Hk, D) bf16, any T;
//           rows (B,) int32, the cache row of each sequence, or null for
//           rows 0..B-1 (a row out of range sees no key); q_positions (B, S)
//           int32; total_lens (B,) int32; sinks (Hq,) f32 or null. D in
//           {64, 128}; any GQA group.
// Output:   (B, S, Hq, D) f32, with the visibility rule of paged_attention.cu
//           (key j visible iff j < min(total_len, T), j <= p and, with a
//           window, j > p - window).
// Dispatch: as paged_attention.cu: S * G <= DECODE_ROWS launches the
//           split-key decode kernel (ws, counters and split_keys as there), a
//           longer chunk the prefill body of attention_prefill.cuh.
// Bound:    as paged_attention.cu: decode reads every visible K/V byte once
//           (bytes over 3.35 TB/s); a long prefill chunk is bound by its 4*D
//           operations per visible (query, key) pair at the bf16 rate.
// Design:   decode: attention_decode.cuh with LinearRows and Bf16KV (a split
//           covers split_keys slots of the row; the last tile is cut at T).
//           Prefill: attention_prefill.cuh, with the tile's rows at row*T +
//           key (LinearRows). The TPU kernel tiles T by the largest of
//           256..8 that divides it (and the JAX package takes a dense path
//           for other T); here the tile stays 64 keys wide and the last one
//           is cut at T, whatever T is: its copies stop at T (never the next
//           sequence's row, never past the allocation), its other rows are
//           zero-filled and masked.
#include "attention_decode.cuh"
#include "attention_prefill.cuh"

// rows: (B,) int32 cache row of each sequence, or null for row b.
extern "C" int exl3_linear_attention(const void* q, const void* k, const void* v, const void* rows_,
                                     const void* qpos, const void* total_lens, const void* sinks,
                                     void* out, void* ws, void* counters, int B, int S, int Hq,
                                     int Hk, int D, int N, int T, float scale, int window,
                                     float softcap, int split_keys, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T <= 0 || Hk <= 0 || Hq % Hk) return (int)cudaErrorInvalidValue;
    const LinearRows rows{static_cast<const int*>(rows_), N, T};
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    const bool decode = S * (Hq / Hk) <= DECODE_ROWS;
    if (D == 128) {
        const Bf16KV<128> kv{kb, vb, Hk};
        if (decode)
            return launch_decode_bf16(q, rows, kv, qpos, total_lens, sinks, out, ws, counters,
                                      B, S, Hq, Hk, scale, window, softcap, split_keys, T,
                                      st);
        return launch_prefill<128>(q, rows, kv, qpos, total_lens, sinks, out, B, S, Hq, Hk,
                                   scale, window, softcap, st);
    }
    if (D == 64) {
        const Bf16KV<64> kv{kb, vb, Hk};
        if (decode)
            return launch_decode_bf16(q, rows, kv, qpos, total_lens, sinks, out, ws, counters,
                                      B, S, Hq, Hk, scale, window, softcap, split_keys, T,
                                      st);
        return launch_prefill<64>(q, rows, kv, qpos, total_lens, sinks, out, B, S, Hq, Hk,
                                  scale, window, softcap, st);
    }
    return (int)cudaErrorInvalidValue;
}
