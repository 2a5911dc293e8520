"""RMSNorm (counterpart of exllamav3_tpu/modules/norms.py; the gated and
layer norms, `span_heads` and the Gemma options wait).

`dim` names the normalized width where it is not the hidden size: Qwen3's
per-head q and k norms take `dim=head_dim` and normalize the last axis of a
(B, S, heads, head_dim) tensor."""
from __future__ import annotations

import torch

from .module import ForwardCtx, Module


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * weight.to(torch.float32)
    return y.to(x.dtype)


class RMSNorm(Module):
    def __init__(self, config, key: str, rms_norm_eps: float = 1e-6, out_dtype=None,
                 dim: int | None = None):
        super().__init__(config, key)
        self.eps = rms_norm_eps
        self.out_dtype = out_dtype
        self.dim = dim

    def load(self, params: dict, device: torch.device) -> None:
        w = self.config.stc.get_tensor(self.key + ".weight")
        if self.dim is not None and tuple(w.shape) != (self.dim,):
            raise ValueError(f"{self.key}.weight: shape {tuple(w.shape)}, expected ({self.dim},)")
        params[self.key] = {"weight": w.to(torch.float32).to(device)}

    def forward(self, x, params: dict, ctx: ForwardCtx):
        y = rms_norm(x, params[self.key]["weight"], self.eps)
        return y if self.out_dtype is None else y.to(self.out_dtype)
