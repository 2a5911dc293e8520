"""Rotary position embeddings, NEOX style with the `default` and `llama3`
scalings (counterpart of exllamav3_tpu/util/rope.py; GPTJ, linear, yarn,
longrope and MRoPE wait)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import torch


class RopeStyle(IntEnum):
    NONE = 0
    GPTJ = 1
    NEOX = 2


@dataclass
class RopeSettings:
    head_dim: int = 128
    rope_theta: float = 10000.0
    rope_scaling: dict | None = None
    rotary_dim: int | None = None
    partial_rotary_factor: float = 1.0
    max_position_embeddings: int | None = None
    original_max_position_embeddings: int | None = None
    rope_style: RopeStyle = RopeStyle.NEOX

    def rotary_width(self) -> int:
        if self.rotary_dim is not None:
            return self.rotary_dim
        return int(self.head_dim * self.partial_rotary_factor)


def compute_rope_params(settings: RopeSettings) -> tuple[np.ndarray, float]:
    """(inv_freq (rotary_width/2,) f64, attention_factor)."""
    dim = settings.rotary_width()
    base = settings.rope_theta
    sc = settings.rope_scaling
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    rt = "default" if sc is None else sc.get("rope_type", sc.get("type", "default"))
    if rt == "llama3":
        factor = float(sc["factor"])
        lo_factor = float(sc.get("low_freq_factor", 1.0))
        hi_factor = float(sc.get("high_freq_factor", 4.0))
        old_len = float(sc.get("original_max_position_embeddings", 8192))
        low_wl = old_len / lo_factor
        high_wl = old_len / hi_factor
        wavelen = 2 * math.pi / inv_freq
        inv_llama = np.where(wavelen > low_wl, inv_freq / factor, inv_freq)
        smooth = (old_len / wavelen - lo_factor) / (hi_factor - lo_factor)
        smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
        is_mid = (wavelen < low_wl) & (wavelen > high_wl)
        inv_freq = np.where(is_mid, smoothed, inv_llama)
    elif rt != "default":
        raise ValueError(f"rope_type {rt} is not ported yet")
    return inv_freq.astype(np.float64), 1.0


class Rope:
    """Precomputed RoPE application for a fixed head_dim/settings."""

    def __init__(self, settings: RopeSettings):
        if settings.rope_style not in (RopeStyle.NONE, RopeStyle.NEOX):
            raise ValueError(f"rope style {settings.rope_style!r} is not ported yet")
        self.settings = settings
        self.style = settings.rope_style
        self.inv_freq, self.attn_factor = compute_rope_params(settings)
        self.rot = settings.rotary_width()
        self._inv = {}

    def sin_cos(self, positions: torch.Tensor):
        """positions (...,) int -> sin, cos (..., rot/2) f32."""
        dev = positions.device
        if dev not in self._inv:
            self._inv[dev] = torch.from_numpy(self.inv_freq.astype(np.float32)).to(dev)
        ang = positions.to(torch.float32)[..., None] * self._inv[dev]
        return torch.sin(ang) * self.attn_factor, torch.cos(ang) * self.attn_factor

    def apply(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
        """x (..., seq, heads, head_dim); sin/cos (..., seq, rot/2)."""
        if self.style == RopeStyle.NONE:
            return x
        rot = self.rot
        xf = x.to(torch.float32)
        x_rot, x_pass = xf[..., :rot], xf[..., rot:]
        s = sin[..., :, None, :]
        c = cos[..., :, None, :]
        x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
        if x_pass.shape[-1]:
            out = torch.cat([out, x_pass], dim=-1)
        return out.to(x.dtype)
