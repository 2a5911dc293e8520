// Paged attention for Hopper over a bf16 KV cache with 256-token pages.
//
// Replaces: exllamav3_tpu/ops/flash_attention.py::_flash_kernel in its paged
//           layout with unquantized K/V (flash_attention with block_tables).
// Inputs:   q (B, S, Hq, D) f32; k, v (P, 256, Hk, D) bf16; block_tables
//           (B, MP) int32; q_positions (B, S) int32; total_lens (B,) int32;
//           sinks (Hq,) f32 or null. D in {64, 128}; any GQA group.
// Output:   (B, S, Hq, D) f32. Key j is visible to a query at position p iff
//           j < total_len, j <= p and, with a window, j > p - window. Scores
//           are scale*q.k, then the softcap; sinks join the denominator. A
//           row that sees no key gives 0.
// Dispatch: S * G <= DECODE_ROWS (decode, verify) launches the split-key
//           decode kernel of attention_decode.cuh over Bf16KV, with ws a
//           workspace of B * Hk * splits * S * G * (D + 2) f32, counters
//           B * Hk int32 that are 0 (the kernel leaves them 0) and
//           split_keys from the host's sizing. A longer chunk launches the
//           tile loop of attention_tiles.cuh; ws, counters and split_keys
//           are then unused.
// Bound:    decode reads every visible K/V byte once (bytes over
//           3.35 TB/s); a long prefill chunk is bound by its 4*D operations
//           per visible (query, key) pair at the bf16 tensor-core rate.
// Design:   decode: attention_decode.cuh (keys split across blocks by whole
//           pages or parts of one, bf16 rows staged with 16-byte cp.async
//           into padded rows, double-buffered, 32- or 64-key tiles
//           (launch_decode_bf16), K converted exactly to f32 for f32 FMAs
//           against f32 q, V read as bf16x2 from the stage, the splits merged
//           by the last block of each (sequence, kv head)). Prefill: attention_tiles.cuh,
//           with the tile's rows found through the block table (PagedRows:
//           the block loads its own table entries, the TPU kernel's scalar
//           prefetch) and copied as bf16 (Bf16KV).
#include "attention_decode.cuh"

extern "C" int exl3_paged_attention(const void* q, const void* k, const void* v, const void* bt,
                                    const void* qpos, const void* total_lens, const void* sinks,
                                    void* out, void* ws, void* counters, int B, int S, int Hq,
                                    int Hk, int D, int MP, int P, float scale, int window,
                                    float softcap, int split_keys, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (Hk <= 0 || Hq % Hk) return (int)cudaErrorInvalidValue;
    const PagedRows rows{static_cast<const int*>(bt), MP, P};
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    const bool decode = S * (Hq / Hk) <= DECODE_ROWS;
    if (D == 128) {
        const Bf16KV<128> kv{kb, vb, Hk};
        if (decode)
            return launch_decode_bf16(q, rows, kv, qpos, total_lens, sinks, out, ws, counters,
                                      B, S, Hq, Hk, scale, window, softcap, split_keys, MP * PAGE,
                                      st);
        return launch_attention<HeadGeo<128>>(q, rows, kv, qpos, total_lens, sinks, out, B, S, Hq,
                                              Hk, scale, window, softcap, st);
    }
    if (D == 64) {
        const Bf16KV<64> kv{kb, vb, Hk};
        if (decode)
            return launch_decode_bf16(q, rows, kv, qpos, total_lens, sinks, out, ws, counters,
                                      B, S, Hq, Hk, scale, window, softcap, split_keys, MP * PAGE,
                                      st);
        return launch_attention<HeadGeo<64>>(q, rows, kv, qpos, total_lens, sinks, out, B, S, Hq,
                                             Hk, scale, window, softcap, st);
    }
    return (int)cudaErrorInvalidValue;
}
