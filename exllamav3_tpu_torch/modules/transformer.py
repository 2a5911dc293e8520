"""Transformer block: residual wiring around attention and MLP, residuals
accumulated in f32 (counterpart of exllamav3_tpu/modules/transformer.py)."""
from __future__ import annotations

import torch

from .module import ForwardCtx, Module


class TransformerBlock(Module):
    def __init__(self, config, key: str, layer_idx: int, attn_norm: Module,
                 attn: Module, mlp_norm: Module, mlp: Module):
        super().__init__(config, key)
        self.layer_idx = layer_idx
        self.attn_norm = attn_norm
        self.attn = attn
        self.mlp_norm = mlp_norm
        self.mlp = mlp
        self.modules = [attn_norm, attn, mlp_norm, mlp]

    def forward(self, x, params: dict, ctx: ForwardCtx):
        res = x.to(torch.float32)
        h = self.attn.forward(self.attn_norm.forward(x, params, ctx), params, ctx)
        res = res + h.to(torch.float32)
        x = res.to(x.dtype)
        h = self.mlp.forward(self.mlp_norm.forward(x, params, ctx), params, ctx)
        res = res + h.to(torch.float32)
        return res.to(x.dtype)
