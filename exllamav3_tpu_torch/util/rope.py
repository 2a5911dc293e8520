"""Rotary position embeddings, NEOX and GPTJ (interleaved pairs) styles with
the `default`, `linear`, `llama3` and `yarn` scalings (counterpart of
exllamav3_tpu/util/rope.py; dynamic, longrope, MRoPE and the NANOCHAT style
wait). DeepSeek's yarn takes the ratio of its two mscales as
the attention factor (`RopeSettings.yarn_mscale_ratio`); the architecture
folds the other into the softmax scale. DeepSeek-V4 rotates the trailing
dims of its rows GPTJ-style (`gptj_rope_trailing`, from
exllamav3_tpu/modules/dsv4_attn.py), over a plain or yarn table
(`dsv4_inv_freq`)."""
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
    # DeepSeek-style yarn: the attention factor is the ratio of the mscale
    # computed with `mscale` over the one with `mscale_all_dim` (the latter is
    # folded into sm_scale by the architecture's config instead)
    yarn_mscale_ratio: bool = False

    def rotary_width(self) -> int:
        if self.rotary_dim is not None:
            return self.rotary_dim
        return int(self.head_dim * self.partial_rotary_factor)


def _yarn_inv_freq(dim: int, base: float, sc: dict) -> np.ndarray:
    """Yarn's blend of interpolated and extrapolated frequencies over the
    correction range set by beta_fast / beta_slow."""
    pos_freqs = base ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    extrap = 1.0 / pos_freqs
    factor = float(sc["factor"])
    orig_max_pos = int(sc["original_max_position_embeddings"])
    beta_fast = float(sc.get("beta_fast", 32))
    beta_slow = float(sc.get("beta_slow", 1))

    def corr_dim(num_rot):
        return (dim * math.log(orig_max_pos / (num_rot * 2 * math.pi))) / (2 * math.log(base))

    low, high = corr_dim(beta_fast), corr_dim(beta_slow)
    if sc.get("truncate", True):
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, dim - 1)
    if low == high:
        high += 0.001
    ramp = (np.arange(dim // 2, dtype=np.float64) - low) / (high - low)
    extrap_factor = 1.0 - np.clip(ramp, 0, 1)
    interp = 1.0 / (factor * pos_freqs)
    return interp * (1 - extrap_factor) + extrap * extrap_factor


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1.0 else 0.1 * mscale * math.log(scale) + 1.0


def compute_rope_params(settings: RopeSettings) -> tuple[np.ndarray, float]:
    """(inv_freq (rotary_width/2,) f64, attention_factor)."""
    dim = settings.rotary_width()
    base = settings.rope_theta
    sc = settings.rope_scaling
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    attn_factor = 1.0
    rt = "default" if sc is None else sc.get("rope_type", sc.get("type", "default"))
    if rt == "yarn":
        inv_freq = _yarn_inv_freq(dim, base, sc)
        factor = float(sc["factor"])
        mscale = float(sc.get("mscale", 1.0))
        msad = float(sc.get("mscale_all_dim", 0.0))
        if settings.yarn_mscale_ratio:
            attn_factor = yarn_mscale(factor, mscale) / (yarn_mscale(factor, msad) if msad else 1.0)
        elif sc.get("attention_factor") is not None:
            attn_factor = float(sc["attention_factor"])
        else:
            attn_factor = yarn_mscale(factor, mscale)
    elif rt == "linear":  # Gemma-3's global layers: positions divided by the factor
        inv_freq = 1.0 / (float(sc["factor"])
                          * base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    elif rt == "llama3":
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
    return inv_freq.astype(np.float64), float(attn_factor)


class Rope:
    """Precomputed RoPE application for a fixed head_dim/settings."""

    def __init__(self, settings: RopeSettings):
        if settings.rope_style not in (RopeStyle.NONE, RopeStyle.NEOX, RopeStyle.GPTJ):
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
        if self.style == RopeStyle.NEOX:
            x1, x2 = x_rot[..., : rot // 2], x_rot[..., rot // 2:]
            out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
        else:  # GPTJ: interleaved pairs
            x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
            out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x_rot.shape)
        if x_pass.shape[-1]:
            out = torch.cat([out, x_pass], dim=-1)
        return out.to(x.dtype)


def dsv4_inv_freq(dim: int, base: float, rope_scaling: dict | None = None) -> np.ndarray:
    """DeepSeek-V4's (dim/2,) f64 table: yarn's when rope_scaling is present
    (its attention factor is always 1), the plain one otherwise."""
    if rope_scaling is None:
        return 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return _yarn_inv_freq(dim, base, rope_scaling)


def gptj_rope_trailing(x: torch.Tensor, inv_freq: torch.Tensor, positions: torch.Tensor,
                       neg: bool = False) -> torch.Tensor:
    """Rotate the trailing 2 * len(inv_freq) dims of x (..., S, H, D) GPTJ-style
    (interleaved pairs) at `positions` (..., S), in f32; neg=True rotates
    back. inv_freq is an f32 tensor; the result has x's dtype."""
    rd = 2 * inv_freq.shape[0]
    xf = x.to(torch.float32)
    keep, rot = xf[..., : x.shape[-1] - rd], xf[..., x.shape[-1] - rd:]
    ang = positions.to(torch.float32)[..., None] * inv_freq
    s = torch.sin(ang)[..., None, :]
    c = torch.cos(ang)[..., None, :]
    if neg:
        s = -s
    x1, x2 = rot[..., 0::2], rot[..., 1::2]
    out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(rot.shape)
    return torch.cat([keep, out], dim=-1).to(x.dtype)
