"""Attention: QKV projections, RoPE, paged KV cache update, masked attention
(counterpart of exllamav3_tpu/modules/attn.py).

Covers GQA with RoPE, optional per-head q/k RMSNorms (Qwen3, Gemma-3: after
the projections, before RoPE), a softmax scale (default 1/sqrt(head_dim);
Gemma: query_pre_attn_scalar ** -0.5), a sliding window and a logit softcap,
cacheless (`attend_dense`, plain torch as in the JAX package) and over the
paged or the linear cache, bf16 or quantized, through the attention kernels
(ops/flash_attention.py). With CacheSpec(swa_ring=True) a sliding-window
layer keeps a ring of W slots a sequence slot (`new_cache_layer`): a chunk
writes its last W valid positions at slot position % W, prefill and verify
chunks (S > 1) attend densely in plain torch over the ring's entries older
than the chunk and the chunk itself, as the JAX package does outside any
kernel, and decode (S = 1) goes through the ring kernel. Sequence
parallelism, MRoPE, output gates and the module-level sinks (the kernels
take them) are not ported yet. Both cached paths hand q to the kernel in
f32, as the JAX package's Pallas path does, and so does the ring's dense
prefill path (JAX's rounds q to bf16 there); the cacheless path rounds it to
bf16, as the JAX package's does. The JAX package takes its dense linear
branch when T % 8 != 0 (its kernel's tiling), and its dense ring path for
decode where the ring exceeds its kernel's VMEM budget; the port's kernels
take any T and any W.
"""
from __future__ import annotations

import math

import torch

from .linear import Linear
from .module import ForwardCtx, Module
from .multilinear import fused_forward, is_fused, try_fuse
from ..model.cache import linear_cache_update, page_index, paged_cache_update
from ..ops.attention import attend_dense
from ..ops.flash_attention import linear_attention_any as linear_attention
from ..ops.flash_attention import paged_attention_any as paged_attention
from ..ops.flash_attention import ring_attention
from ..util.rope import Rope, RopeSettings, RopeStyle


def total_lens(positions: torch.Tensor, cache_seqlens: torch.Tensor, S: int):
    """Per-row cache length after this chunk's update: cache_seqlens plus the
    count of contiguous valid rows (padded rows park at positions other than
    seqlen + arange and drop out)."""
    expect = cache_seqlens[:, None] + torch.arange(S, dtype=torch.int32,
                                                   device=positions.device)
    valid = positions == expect
    return (cache_seqlens + valid.sum(dim=1)).to(torch.int32)


class Attention(Module):
    is_kv_cache_user = True

    def __init__(self, config, key: str, layer_idx: int, hidden_size: int,
                 head_dim: int, num_q_heads: int, num_kv_heads: int,
                 rope_settings: RopeSettings | None, out_dtype=None,
                 q_norm: Module | None = None, k_norm: Module | None = None,
                 sm_scale: float | None = None, sliding_window: int = 0,
                 logit_softcap: float = 0.0):
        super().__init__(config, key)
        self.layer_idx = layer_idx
        self.head_dim = head_dim
        self.num_q_heads = num_q_heads
        self.num_kv_heads = num_kv_heads
        self.sm_scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)
        self.sliding_window = max(0, sliding_window)  # 0 (or -1 in a config): full attention
        self.logit_softcap = logit_softcap
        self.out_dtype = out_dtype
        self.rope = Rope(rope_settings) if rope_settings else None
        self.q_proj = Linear(config, f"{key}.q_proj", hidden_size, num_q_heads * head_dim)
        self.k_proj = Linear(config, f"{key}.k_proj", hidden_size, num_kv_heads * head_dim)
        self.v_proj = Linear(config, f"{key}.v_proj", hidden_size, num_kv_heads * head_dim)
        self.o_proj = Linear(config, f"{key}.o_proj", num_q_heads * head_dim, hidden_size)
        self.q_norm = q_norm
        self.k_norm = k_norm
        self.modules = [m for m in (self.q_proj, self.k_proj, self.v_proj, self.o_proj,
                                    q_norm, k_norm) if m is not None]

    def ring_slots(self) -> int:
        """W of this layer's ring: the window, the query's own slot and 16
        slots of headroom, so that a rejected speculative write never evicts
        a live window entry, rounded up to a multiple of 8 (the JAX kernel's
        time blocks)."""
        w = self.sliding_window + 1 + 16
        return w + (-w) % 8

    def new_cache_layer(self, spec, device) -> dict:
        from ..model.cache import cache_base_shape, cache_dtype

        if spec.swa_ring and self.sliding_window:
            shape = (spec.state_slots(), self.ring_slots(), self.num_kv_heads, self.head_dim)
            dt = cache_dtype(spec)
            return {"k": torch.zeros(shape, dtype=dt, device=device),
                    "v": torch.zeros(shape, dtype=dt, device=device),
                    "pos": torch.full(shape[:2], -1, dtype=torch.int32, device=device)}
        shape = cache_base_shape(spec, self.num_kv_heads, self.head_dim)
        if spec.k_bits:
            from ..ops.kv_quant import quant_cache_shapes

            return quant_cache_shapes(shape, spec.k_bits, spec.v_bits, device=device)
        dt = cache_dtype(spec)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def load(self, params: dict, device: torch.device) -> None:
        super().load(params, device)
        if self.config.infer_params.fuse_projections:
            try_fuse(params, self.key, "qkv", [self.q_proj, self.k_proj, self.v_proj])

    def forward(self, x, params: dict, ctx: ForwardCtx):
        B, S, _ = x.shape
        dt = x.dtype
        hd, nq, nkv = self.head_dim, self.num_q_heads, self.num_kv_heads
        if is_fused(params, self.key, "qkv"):
            qkv = fused_forward(params, self.key, "qkv", x)
            q = qkv[..., : nq * hd].reshape(B, S, nq, hd)
            k = qkv[..., nq * hd: (nq + nkv) * hd].reshape(B, S, nkv, hd)
            v = qkv[..., (nq + nkv) * hd:].reshape(B, S, nkv, hd)
        else:
            q = self.q_proj.forward(x, params, ctx).reshape(B, S, nq, hd)
            k = self.k_proj.forward(x, params, ctx).reshape(B, S, nkv, hd)
            v = self.v_proj.forward(x, params, ctx).reshape(B, S, nkv, hd)

        if self.q_norm is not None:
            q = self.q_norm.forward(q, params, ctx)
        if self.k_norm is not None:
            k = self.k_norm.forward(k, params, ctx)

        if self.rope is not None and self.rope.style != RopeStyle.NONE:
            sin, cos = self.rope.sin_cos(ctx.positions)
            q = self.rope.apply(q, sin, cos)
            k = self.rope.apply(k, sin, cos)

        win = dict(scale=self.sm_scale, sliding_window=self.sliding_window,
                   logit_softcap=self.logit_softcap)
        if ctx.cache is None:
            o = attend_dense(q.to(dt), k.to(dt), v.to(dt), q_positions=ctx.positions,
                             k_positions=ctx.positions, **win)
        elif "pos" in ctx.cache[self.key]:
            o = self._ring_forward(q, k, v, ctx.cache[self.key], ctx, dt, win)
        else:
            layer = ctx.cache[self.key]
            if ctx.total_lens is None:
                ctx.total_lens = total_lens(ctx.positions, ctx.cache_seqlens, S)
            quant = dict(k_bits=ctx.k_bits, v_bits=ctx.v_bits, compand_a=ctx.compand_a)
            if ctx.attn_mode == "paged":
                if ctx.page_index is None:
                    ctx.page_index = page_index(ctx.positions, ctx.block_tables)
                paged_cache_update(layer, k, v, ctx.positions, ctx.block_tables, **quant,
                                   index=ctx.page_index)
                o = paged_attention(q.float(), layer, ctx.block_tables, ctx.positions,
                                    ctx.total_lens, **quant, **win)
            else:  # linear
                linear_cache_update(layer, k, v, ctx.positions, **quant, rows=ctx.cache_rows)
                o = linear_attention(q.float(), layer, ctx.positions, ctx.total_lens, **quant,
                                     rows=ctx.cache_rows, **win)

        o = o.reshape(B, S, nq * hd).to(dt)
        y = self.o_proj.forward(o, params, ctx)
        return y if self.out_dtype is None else y.to(self.out_dtype)

    def _ring_forward(self, q, k, v, layer: dict, ctx: ForwardCtx, dt, win: dict):
        """Attention of a sliding-window layer over its ring
        {"k", "v" (N, W, Hk, D), "pos" (N, W)}, sequence b in row
        ctx.state_slots[b] (row b when None). Writes the chunk's last W valid
        positions in place, at slot position % W, and returns (B, S, Hq, D)
        f32. A decode row (S = 1) is its sequence's next position, as the
        generator gives it, and is always written."""
        B, S = ctx.positions.shape
        W = layer["k"].shape[1]
        dev = ctx.positions.device
        slots = (ctx.state_slots if ctx.state_slots is not None
                 else torch.arange(B, dtype=torch.int32, device=dev))
        rows = slots.long()
        if S == 1:
            slot = (ctx.positions[:, 0] % W).long()
            layer["k"][rows, slot] = k[:, 0].to(layer["k"].dtype)
            layer["v"][rows, slot] = v[:, 0].to(layer["v"].dtype)
            layer["pos"][rows, slot] = ctx.positions[:, 0]
            return ring_attention(q.float(), layer["k"], layer["v"], layer["pos"], slots,
                                  ctx.positions, **win)
        seqlens = (ctx.cache_seqlens if ctx.cache_seqlens is not None
                   else torch.zeros(B, dtype=torch.int32, device=dev))
        valid = ctx.positions == seqlens[:, None] + torch.arange(S, dtype=torch.int32,
                                                                 device=dev)
        # the prior entries, read before this chunk overwrites any of them
        k_prev, v_prev, pos_prev = layer["k"][rows], layer["v"][rows], layer["pos"][rows]
        # slots alias every W positions: of a chunk longer than W only its
        # last W valid positions are written, each to a slot of its own
        last = seqlens + valid.sum(dim=1) - 1
        bi, si = (valid & (ctx.positions > last[:, None] - W)).nonzero(as_tuple=True)
        slot = (ctx.positions[bi, si] % W).long()
        layer["k"][rows[bi], slot] = k[bi, si].to(layer["k"].dtype)
        layer["v"][rows[bi], slot] = v[bi, si].to(layer["v"].dtype)
        layer["pos"][rows[bi], slot] = ctx.positions[bi, si]
        # prior entries strictly older than the chunk: a stale speculative
        # slot would otherwise stand beside the chunk's own key. q stays f32,
        # as the kernels take it, so that a sliding layer computes one
        # function over the ring and over the pages (the JAX package's dense
        # ring path rounds q to bf16)
        prev_valid = (pos_prev >= 0) & (pos_prev < seqlens[:, None])
        return attend_dense(q.float(), torch.cat([k_prev.to(dt), k.to(dt)], dim=1),
                            torch.cat([v_prev.to(dt), v.to(dt)], dim=1), ctx.positions,
                            torch.cat([pos_prev, ctx.positions], dim=1),
                            k_valid=torch.cat([prev_valid, valid], dim=1), **win)
