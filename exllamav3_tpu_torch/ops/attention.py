"""Attention math, plain torch: dense masked attention and the paged variant
(counterpart of exllamav3_tpu/ops/attention.py). The paged kernel in
ops/flash_attention.py replaces `attend_paged` on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attend_dense(q, k, v, q_positions, k_positions, k_valid=None, scale: float = 1.0,
                 sliding_window: int = 0, logit_softcap: float = 0.0, sinks=None):
    """Masked attention in f32. q (B,S,Hq,D); k (B,T,Hk,D); v (B,T,Hk,Dv).

    Key j is visible to query i iff k_pos[j] <= q_pos[i], within the sliding
    window when set, and k_valid[j]. Sinks (Hq,) join the softmax
    denominator. Returns (B,S,Hq,Dv) f32.
    """
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, S, Hk, G, D).to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) * scale
    if logit_softcap:
        scores = torch.tanh(scores / logit_softcap) * logit_softcap
    qp = q_positions[:, None, None, :, None]
    kp = k_positions[:, None, None, None, :]
    mask = kp <= qp
    if sliding_window:
        mask &= kp > qp - sliding_window
    if k_valid is not None:
        mask &= k_valid[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    if sinks is not None:
        sink = sinks.reshape(1, Hk, G, 1, 1).to(torch.float32)
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), sink)
        p = torch.exp(scores - m)
        p = p / (p.sum(dim=-1, keepdim=True) + torch.exp(sink - m))
    else:
        p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(B, S, Hq, v.shape[-1])


def attend_paged(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                 scale: float = 1.0, sliding_window: int = 0,
                 logit_softcap: float = 0.0, sinks=None, quant_state: dict | None = None,
                 k_bits: int = 0, v_bits: int = 0, compand_a: float = 0.0,
                 quant_dtype=torch.bfloat16):
    """Gather each sequence's pages, then dense attention. k_pages
    (P, PAGE_SIZE, Hk, D); block_tables (B, MP); keys at or past the row's
    total length are masked. With `quant_state` ({k_q, k_s, v_q, v_s}) the
    gathered pages are dequantized to `quant_dtype` first and k_pages /
    v_pages are ignored."""
    B, MP = block_tables.shape
    bt = block_tables.long()
    if quant_state is not None:
        from .kv_quant import dequantize_kv_stored, state_heads

        merged = quant_state["k_q"].dim() == 3
        hk = state_heads(quant_state, q.shape[-1])
        k = dequantize_kv_stored(quant_state["k_q"][bt], quant_state["k_s"][bt], k_bits, hk,
                                 merged, quant_dtype, compand_a)
        v = dequantize_kv_stored(quant_state["v_q"][bt], quant_state["v_s"][bt], v_bits, hk,
                                 merged, quant_dtype, compand_a)
    else:
        k = k_pages[bt]  # (B, MP, PAGE_SIZE, Hk, D)
        v = v_pages[bt]
    T = MP * k.shape[2]
    k = k.reshape(B, T, *k.shape[3:])
    v = v.reshape(B, T, *v.shape[3:])
    k_pos = torch.arange(T, dtype=torch.int32, device=q.device)[None].expand(B, T)
    k_valid = k_pos < total_lens[:, None]
    return attend_dense(q, k, v, q_positions, k_pos, k_valid=k_valid, scale=scale,
                        sliding_window=sliding_window, logit_softcap=logit_softcap,
                        sinks=sinks)
