"""Gated MLP with silu (counterpart of exllamav3_tpu/modules/mlp.py).

Decode batches (T <= 16 rows) with fused int8 gate_up and int8 down go
through the fused MLP kernel (ops/fused_mlp.py); everything else runs the
gate_up product, the activation and the down product separately: in the
`fused` linear mode nothing fuses (a trellis `words` group is no int8
weight), so gate, up and down run as three trellis linears. The other
activations, clamps and the non-gated MLP wait.
"""
from __future__ import annotations

import torch

from .linear import Linear
from .module import ForwardCtx, Module
from .multilinear import fused_forward, is_fused, try_fuse
from ..ops.fused_mlp import fused_mlp_eligible, fused_mlp_int8


class GatedMLP(Module):
    def __init__(self, config, key: str, hidden_size: int, intermediate_size: int,
                 activation: str = "silu", out_dtype=None):
        super().__init__(config, key)
        if activation != "silu":
            raise ValueError(f"activation {activation!r} is not ported yet")
        self.activation = activation
        self.out_dtype = out_dtype
        self.up = Linear(config, f"{key}.up_proj", hidden_size, intermediate_size)
        self.gate = Linear(config, f"{key}.gate_proj", hidden_size, intermediate_size)
        self.down = Linear(config, f"{key}.down_proj", intermediate_size, hidden_size)
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
                               pd["scale"], d_bias=pd.get("bias"))
        else:
            if is_fused(params, self.key, "gate_up"):
                gu = fused_forward(params, self.key, "gate_up", x)
                inter = gu.shape[-1] // 2
                g, u = gu[..., :inter], gu[..., inter:]
            else:
                g = self.gate.forward(x, params, ctx).to(torch.float32)
                u = self.up.forward(x, params, ctx).to(torch.float32)
            h = (torch.nn.functional.silu(g) * u).to(x.dtype)
            y = self.down.forward(h, params, ctx)
        return y if self.out_dtype is None else y.to(self.out_dtype)
