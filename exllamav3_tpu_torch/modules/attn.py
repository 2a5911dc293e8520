"""Attention: QKV projections, RoPE, paged KV cache update, masked attention
(counterpart of exllamav3_tpu/modules/attn.py).

Covers GQA with RoPE at the default 1/sqrt(head_dim) scale and optional
per-head q/k RMSNorms (Qwen3: after the projections, before RoPE), cacheless
(`attend_dense`, plain torch as in the JAX package) and over the paged or the
linear cache, bf16 or quantized, through the attention kernels
(ops/flash_attention.py). The SWA ring, sequence parallelism, MRoPE, output
gates and the module-level sliding window, softcap and sinks (the kernels
take them) are not ported yet. Both cached paths hand q to the kernel in f32,
as the JAX package's Pallas path does; the cacheless path rounds it to bf16,
as the JAX package's does. The JAX package takes its dense linear branch
when T % 8 != 0 (its kernel's tiling); the port's kernels take any T.
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
                 q_norm: Module | None = None, k_norm: Module | None = None):
        super().__init__(config, key)
        self.layer_idx = layer_idx
        self.head_dim = head_dim
        self.num_q_heads = num_q_heads
        self.num_kv_heads = num_kv_heads
        self.sm_scale = 1.0 / math.sqrt(head_dim)
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

    def new_cache_layer(self, spec, device) -> dict:
        from ..model.cache import cache_base_shape, cache_dtype

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

        if ctx.cache is None:
            o = attend_dense(q.to(dt), k.to(dt), v.to(dt), q_positions=ctx.positions,
                             k_positions=ctx.positions, scale=self.sm_scale)
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
                                    ctx.total_lens, **quant, scale=self.sm_scale)
            else:  # linear
                linear_cache_update(layer, k, v, ctx.positions, **quant, rows=ctx.cache_rows)
                o = linear_attention(q.float(), layer, ctx.positions, ctx.total_lens, **quant,
                                     rows=ctx.cache_rows, scale=self.sm_scale)

        o = o.reshape(B, S, nq * hd).to(dt)
        y = self.o_proj.forward(o, params, ctx)
        return y if self.out_dtype is None else y.to(self.out_dtype)
