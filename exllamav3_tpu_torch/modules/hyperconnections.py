"""mHC hyper-connections of DeepSeek-V4 (counterpart of
exllamav3_tpu/modules/hyperconnections.py), plain torch in f32.

The residual is hc_mult parallel f32 streams (B, S, H, D): ExpandStreams
broadcasts the embedding into them, each sublayer site of a block mixes them
through a HyperConnection (sigmoid pre and post weights and a combine matrix
made doubly stochastic by Sinkhorn iterations), and HyperHead collapses them
before the final norm.
"""
from __future__ import annotations

import torch

from .module import ForwardCtx, Module


def _rms_flat(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)


def _load_f32(module, params: dict, device) -> None:
    stc = module.config.stc
    params[module.key] = {t: stc.get_tensor(f"{module.key}_{t}").to(torch.float32).to(device)
                          for t in ("fn", "base", "scale")}


class ExpandStreams(Module):
    """The embedding broadcast into hc_mult parallel residual streams, f32."""

    def __init__(self, config, key: str, hc_mult: int):
        super().__init__(config, key)
        self.hc_mult = hc_mult

    def forward(self, x, params: dict, ctx: ForwardCtx):
        xf = x.to(torch.float32)
        return xf[..., None, :].expand(*xf.shape[:-1], self.hc_mult, xf.shape[-1])


class HyperConnection(Module):
    """The mixer of one sublayer site: raw f32 tensors {key}_fn
    ((2 + H) * H, H * D), {key}_base ((2 + H) * H,) and {key}_scale (3,).
    TransformerBlock calls mix() and apply() around its sites."""

    def __init__(self, config, key: str, hc_mult: int, hidden_size: int, sinkhorn_iters: int,
                 hc_eps: float, rms_norm_eps: float):
        super().__init__(config, key)
        self.hc_mult = hc_mult
        self.hidden_size = hidden_size
        self.sinkhorn_iters = sinkhorn_iters
        self.hc_eps = hc_eps
        self.rms_eps = rms_norm_eps

    def load(self, params: dict, device: torch.device) -> None:
        _load_f32(self, params, device)

    def mix(self, streams, params: dict):
        """streams (B, S, H, D) f32 -> (post (B, S, H), comb (B, S, H, H),
        collapsed (B, S, D))."""
        p = params[self.key]
        hc, eps = self.hc_mult, self.hc_eps
        flat = _rms_flat(streams.reshape(*streams.shape[:-2], -1), self.rms_eps)
        mix = flat @ p["fn"].t()
        pre_w, post_w, comb_w = mix[..., :hc], mix[..., hc: 2 * hc], mix[..., 2 * hc:]
        base, scale = p["base"], p["scale"]
        pre = torch.sigmoid(pre_w * scale[0] + base[:hc]) + eps
        post = 2.0 * torch.sigmoid(post_w * scale[1] + base[hc: 2 * hc])
        comb = comb_w.reshape(*comb_w.shape[:-1], hc, hc) * scale[2] + base[2 * hc:].reshape(hc, hc)
        comb = torch.softmax(comb, dim=-1) + eps
        comb = comb / (comb.sum(dim=-2, keepdim=True) + eps)
        for _ in range(self.sinkhorn_iters - 1):
            comb = comb / (comb.sum(dim=-1, keepdim=True) + eps)
            comb = comb / (comb.sum(dim=-2, keepdim=True) + eps)
        collapsed = (pre[..., None] * streams).sum(dim=-2)
        return post, comb, collapsed

    def apply(self, streams, y, post, comb):
        """The site's residual update: streams <- post (x) y + comb^T streams."""
        return post[..., None] * y.to(torch.float32)[..., None, :] + torch.einsum(
            "...ij,...id->...jd", comb, streams)

    def forward(self, x, params: dict, ctx: ForwardCtx):
        raise RuntimeError("HyperConnection is not a standalone module; use mix()")


class HyperHead(Module):
    """The streams' last collapse before the model norm: {key}_fn (H, H * D),
    {key}_base (H,), {key}_scale (H,). Returns bf16."""

    def __init__(self, config, key: str, hc_mult: int, rms_norm_eps: float, hc_eps: float):
        super().__init__(config, key)
        self.hc_mult = hc_mult
        self.rms_eps = rms_norm_eps
        self.hc_eps = hc_eps

    def load(self, params: dict, device: torch.device) -> None:
        _load_f32(self, params, device)

    def forward(self, x, params: dict, ctx: ForwardCtx):
        p = params[self.key]
        flat = _rms_flat(x.reshape(*x.shape[:-2], -1), self.rms_eps)
        pre = torch.sigmoid((flat @ p["fn"].t()) * p["scale"] + p["base"]) + self.hc_eps
        return (pre[..., None] * x).sum(dim=-2).to(torch.bfloat16)
