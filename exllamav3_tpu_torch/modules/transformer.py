"""Transformer block: residual wiring around attention and MLP, residuals
accumulated in f32 (counterpart of exllamav3_tpu/modules/transformer.py).
Gemma's sandwich norms (`attn_post_norm`, `mlp_post_norm`) normalize each
branch's output before its residual add. With DeepSeek-V4's hyper-connections
(`attn_hc`, `mlp_hc`) the residual is a stack of f32 streams (B, S, H, D):
each site collapses the streams into the sublayer's bf16 input and mixes its
output back in (modules/hyperconnections.py)."""
from __future__ import annotations

import torch

from .module import ForwardCtx, Module


class TransformerBlock(Module):
    def __init__(self, config, key: str, layer_idx: int, attn_norm: Module,
                 attn: Module, mlp_norm: Module, mlp: Module,
                 attn_post_norm: Module | None = None, mlp_post_norm: Module | None = None,
                 attn_hc: Module | None = None, mlp_hc: Module | None = None):
        super().__init__(config, key)
        self.layer_idx = layer_idx
        self.attn_norm = attn_norm
        self.attn = attn
        self.attn_post_norm = attn_post_norm
        self.mlp_norm = mlp_norm
        self.mlp = mlp
        self.mlp_post_norm = mlp_post_norm
        self.attn_hc = attn_hc
        self.mlp_hc = mlp_hc
        self.modules = [m for m in (attn_norm, attn, attn_post_norm, mlp_norm, mlp,
                                    mlp_post_norm, attn_hc, mlp_hc) if m is not None]

    def forward(self, x, params: dict, ctx: ForwardCtx):
        if self.attn_hc is not None:
            for norm, sub, hc in ((self.attn_norm, self.attn, self.attn_hc),
                                  (self.mlp_norm, self.mlp, self.mlp_hc)):
                post, comb, y = hc.mix(x, params)
                h = sub.forward(norm.forward(y.to(torch.bfloat16), params, ctx), params, ctx)
                x = hc.apply(x, h, post, comb)
            return x
        res = x.to(torch.float32)
        h = self.attn.forward(self.attn_norm.forward(x, params, ctx), params, ctx)
        if self.attn_post_norm is not None:
            h = self.attn_post_norm.forward(h, params, ctx)
        res = res + h.to(torch.float32)
        x = res.to(x.dtype)
        h = self.mlp.forward(self.mlp_norm.forward(x, params, ctx), params, ctx)
        if self.mlp_post_norm is not None:
            h = self.mlp_post_norm.forward(h, params, ctx)
        res = res + h.to(torch.float32)
        return res.to(x.dtype)
