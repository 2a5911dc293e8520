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
// Bound:    decode reads every visible K/V byte once (bytes over
//           3.35 TB/s); a long prefill chunk is bound by its 4*D operations
//           per visible (query, key) pair at the bf16 tensor-core rate.
// Design:   attention_tiles.cuh, with the tile's rows found through the block
//           table (PagedRows: the block loads its own table entries, the TPU
//           kernel's scalar prefetch) and copied as bf16 (Bf16KV).
#include "attention_tiles.cuh"

extern "C" int exl3_paged_attention(const void* q, const void* k, const void* v, const void* bt,
                                    const void* qpos, const void* total_lens, const void* sinks,
                                    void* out, int B, int S, int Hq, int Hk, int D, int MP, int P,
                                    float scale, int window, float softcap, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const PagedRows rows{static_cast<const int*>(bt), MP, P};
    const auto* kb = static_cast<const __nv_bfloat16*>(k);
    const auto* vb = static_cast<const __nv_bfloat16*>(v);
    if (D == 128)
        return launch_attention<HeadGeo<128>>(q, rows, Bf16KV<128>{kb, vb, Hk}, qpos,
                                              total_lens, sinks, out, B, S, Hq, Hk, scale,
                                              window, softcap, st);
    if (D == 64)
        return launch_attention<HeadGeo<64>>(q, rows, Bf16KV<64>{kb, vb, Hk}, qpos,
                                             total_lens, sinks, out, B, S, Hq, Hk, scale,
                                             window, softcap, st);
    return (int)cudaErrorInvalidValue;
}
