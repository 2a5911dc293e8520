"""Gated MLP (counterpart of exllamav3_tpu/modules/mlp.py): silu, gelu (erf),
gelu_pytorch_tanh and relu2, and DeepSeek-V4's clamped swiglu
(`act_clamp`).

Decode batches (T <= 16 rows) with fused int8 gate_up and int8 down go
through the fused MLP kernel (ops/fused_mlp.py); everything else runs the
gate_up product, the activation and the down product separately: in the
`fused` linear mode nothing fuses (a trellis `words` group is no int8
weight), so gate, up and down run as three trellis linears. The clamp is the
JAX package's in each: the three-dot path takes act_mul_clamped,
min(act(g), L) * clip(u, -L, L); the fused kernel clips the gate to [-L, L]
before the activation, as the JAX kernel does. The silu_oai activation,
xielu and the non-gated MLP wait.
"""
from __future__ import annotations

import torch

from .linear import Linear
from .module import ForwardCtx, Module
from .multilinear import fused_forward, is_fused, try_fuse
from ..ops.fused_mlp import ACTIVATIONS, apply_activation, fused_mlp_eligible, fused_mlp_int8


class GatedMLP(Module):
    def __init__(self, config, key: str, hidden_size: int, intermediate_size: int,
                 activation: str = "silu", out_dtype=None, key_up: str = "up_proj",
                 key_gate: str = "gate_proj", key_down: str = "down_proj",
                 act_clamp: float = 0.0):
        super().__init__(config, key)
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation {activation!r} is not ported yet")
        self.activation = activation
        self.act_clamp = act_clamp
        self.out_dtype = out_dtype
        self.up = Linear(config, f"{key}.{key_up}", hidden_size, intermediate_size)
        self.gate = Linear(config, f"{key}.{key_gate}", hidden_size, intermediate_size)
        self.down = Linear(config, f"{key}.{key_down}", intermediate_size, hidden_size)
        self.modules = [self.up, self.gate, self.down]

    def load(self, params: dict, device: torch.device) -> None:
        super().load(params, device)
        if self.config.infer_params.fuse_projections:
            try_fuse(params, self.key, "gate_up", [self.gate, self.up])

    def forward(self, x, params: dict, ctx: ForwardCtx):
        T = x.numel() // x.shape[-1]
        if fused_mlp_eligible(self, params, T):
            p = params[self.key]
            pd = params[self.down.key]
            y = fused_mlp_int8(x, p["gate_up_q"], p["gate_up_scale"], pd["weight_q"],
                               pd["scale"], d_bias=pd.get("bias"), activation=self.activation,
                               act_clamp=self.act_clamp)
        else:
            if is_fused(params, self.key, "gate_up"):
                gu = fused_forward(params, self.key, "gate_up", x)
                inter = gu.shape[-1] // 2
                g, u = gu[..., :inter], gu[..., inter:]
            else:
                g = self.gate.forward(x, params, ctx).to(torch.float32)
                u = self.up.forward(x, params, ctx).to(torch.float32)
            if self.act_clamp:
                L = self.act_clamp
                h = torch.clamp(apply_activation(self.activation, g), max=L) * torch.clamp(u, -L, L)
            else:
                h = apply_activation(self.activation, g) * u
            h = h.to(x.dtype)
            y = self.down.forward(h, params, ctx)
        return y if self.out_dtype is None else y.to(self.out_dtype)
