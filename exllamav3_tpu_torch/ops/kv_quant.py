"""Quantized KV cache: 2-8 bit pack / unpack with one bf16 scale per group
of 32 channels (counterpart of exllamav3_tpu/ops/kv_quant.py).

Each group of 32 channels is rotated by a normalized 32-point Hadamard,
scaled to [-1, 1] by its absmax, and quantized on the midpoint grid
(centroids (2q+1)/2^bits - 1) or, with compand_a > 0, through the cubic
compander f(t) = a*t + (1-a)*t^3 (Cardano's formula on the way in).

The stored bytes are the JAX package's, so a cache state carries across:
  * even widths (2, 4, 8) pack as one little-endian bit stream per group,
    32/bits values per int32 word, groups in order; "merged" storage
    (P, T, Hk*D*bits/32) and per-head storage (P, T, Hk, D*bits/32) are the
    same bytes under two shapes;
  * odd widths (3, 5, 6, 7) split into power-of-two bit planes, largest
    first and holding the value's low bits, each plane packed on its own in
    the lane order `lane_perm` (the JAX kernel's unpack order), per head.

torch has no unsigned 32-bit shifts, so fields are assembled in int64 and
wrapped to int32 at the end.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..quant.hadamard import hadamard_scaled

GROUP = 32
COMPAND_A = 0.65  # cubic coefficient when companding is enabled
ODD_PLANES = {3: (2, 1), 5: (4, 1), 6: (4, 2), 7: (4, 2, 1)}


def plane_max(bits: int) -> int:
    """Layout-defining plane width: bits itself when word-aligned."""
    return ODD_PLANES[bits][0] if bits in ODD_PLANES else bits


@functools.lru_cache(maxsize=None)
def lane_perm(D: int, bits: int) -> tuple:
    """(perm, inv): lane p of the plane layout holds channel perm[p], with
    p = j*gw + group*pb + w -> channel 32*group + w*(32//pb) + j for the
    largest plane pb."""
    pb = plane_max(bits)
    J = 32 // pb
    g = D // 32
    perm = np.empty((D,), np.int32)
    p = 0
    for j in range(J):
        for group in range(g):
            for w in range(pb):
                perm[p] = 32 * group + w * J + j
                p += 1
    inv = np.empty_like(perm)
    inv[perm] = np.arange(D, dtype=np.int32)
    return perm, inv


@functools.lru_cache(maxsize=None)
def _lane_index(D: int, bits: int, inverse: bool, device: str) -> torch.Tensor:
    """lane_perm as an index tensor, one copy per device."""
    return torch.from_numpy(lane_perm(D, bits)[int(inverse)].astype(np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def _field_shifts(J: int, width: int, device: str) -> torch.Tensor:
    """(J,) int64 bit offsets 0, width, 2*width, ..., one copy per device."""
    return (torch.arange(J, dtype=torch.int64) * width).to(device)


def rotate_groups(x: torch.Tensor) -> torch.Tensor:
    """(..., D) f32 -> per-32-group H32 rotation (symmetric: its own inverse)."""
    g = x.shape[-1] // GROUP
    h = hadamard_scaled(GROUP, x.device)
    return (x.reshape(*x.shape[:-1], g, GROUP) @ h).reshape(x.shape)


def compand_encode(t: torch.Tensor, bits: int, a: float) -> torch.Tensor:
    """t in [-1, 1] -> grid index (int64) by Cardano's solve of b*u^3 + a*u = t."""
    N = 1 << bits
    b = 1.0 - a
    inv_b = 1.0 / b
    p3 = a * inv_b / 3.0
    p3_cub = p3 * p3 * p3
    q_half = t * inv_b * 0.5
    s = torch.sqrt(q_half * q_half + p3_cub)

    def cbrt(v):
        return torch.sign(v) * torch.pow(torch.abs(v), 1.0 / 3.0)

    u = cbrt(q_half + s) + cbrt(q_half - s)
    return torch.clamp(torch.floor(u * (N // 2) + (N // 2)), 0, N - 1).to(torch.int64)


def compand_decode(idx: torch.Tensor, bits: int, a: float) -> torch.Tensor:
    """Grid index -> value in [-1, 1]: u = (2q+1)/N - 1; u*(a + (1-a)*u^2)."""
    N = 1 << bits
    u = (2.0 * idx + 1.0) / N - 1.0
    return u * (a + (1.0 - a) * u * u)


def _wrap_i32(w: torch.Tensor) -> torch.Tensor:
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def grid_argument(x: torch.Tensor, bits: int):
    """(t*(N/2) + N/2 before the floor, scale): what quantize_kv rounds down.
    Exposed so a test can tell elements that sit on a grid edge."""
    D = x.shape[-1]
    g = D // GROUP
    N = 1 << bits
    xg = rotate_groups(x.to(torch.float32)).reshape(*x.shape[:-1], g, GROUP)
    amax = xg.abs().amax(dim=-1, keepdim=True)
    scale = (amax + 1e-12).to(torch.bfloat16)
    t = xg / scale.to(torch.float32)
    return t, t * (N // 2) + (N // 2), scale


def quantize_kv(x: torch.Tensor, bits: int, compand_a: float = 0.0):
    """x (..., D) -> (packed (..., D*bits/32) int32, scale (..., D/32) bf16)."""
    D = x.shape[-1]
    if D % GROUP or not 2 <= bits <= 8:
        raise ValueError(f"quantize_kv: width {D} is no multiple of {GROUP}, or bits {bits} "
                         "outside 2..8")
    g = D // GROUP
    N = 1 << bits
    t, arg, scale = grid_argument(x, bits)
    if compand_a > 0.0:
        qb = compand_encode(t, bits, compand_a)
    else:
        qb = torch.clamp(torch.floor(arg), 0, N - 1).to(torch.int64)
    lead = x.shape[:-1]
    if bits in ODD_PLANES:
        packed = _pack_planes(qb.reshape(*lead, D), bits, D)
    else:
        # value i of a group sits in word i // J at bit (i % J) * bits
        J = 32 // bits
        sh = _field_shifts(J, bits, str(x.device))
        words = (qb.reshape(*lead, g, bits, J) << sh).sum(dim=-1)
        packed = _wrap_i32(words).reshape(*lead, D * bits // 32)
    return packed, scale.reshape(*lead, g)


def _pack_planes(qflat: torch.Tensor, bits: int, D: int) -> torch.Tensor:
    """qflat (..., D) int64 in true channel order -> (..., D*bits/32) int32,
    planes concatenated largest first, each in lane order."""
    g = D // GROUP
    qlane = qflat[..., _lane_index(D, bits, False, str(qflat.device))]
    words = []
    shift = 0
    for pb in ODD_PLANES[bits]:
        J = 32 // pb
        gw = g * pb
        pv = (qlane >> shift) & ((1 << pb) - 1)
        sh = _field_shifts(J, pb, str(qflat.device))[:, None]
        words.append((pv.reshape(*pv.shape[:-1], J, gw) << sh).sum(dim=-2))
        shift += pb
    return _wrap_i32(torch.cat(words, dim=-1))


def _unpack_planes(words: torch.Tensor, bits: int, D: int) -> torch.Tensor:
    """Inverse of _pack_planes -> (..., D) int64 in true channel order."""
    g = D // GROUP
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    qlane = torch.zeros(*words.shape[:-1], D, dtype=torch.int64, device=words.device)
    off = 0
    shift = 0
    for pb in ODD_PLANES[bits]:
        J = 32 // pb
        gw = g * pb
        w = w64[..., off:off + gw]
        sh = _field_shifts(J, pb, str(words.device))[:, None]
        fields = (w[..., None, :] >> sh) & ((1 << pb) - 1)        # (..., J, gw)
        qlane = qlane | (fields.reshape(*words.shape[:-1], D) << shift)
        off += gw
        shift += pb
    return qlane[..., _lane_index(D, bits, True, str(words.device))]


def dequantize_rotated(words: torch.Tensor, scale: torch.Tensor, bits: int,
                       compand_a: float = 0.0) -> torch.Tensor:
    """(..., D) f32 values in the rotated basis, true channel order: what the
    attention kernel unpacks."""
    D = words.shape[-1] * 32 // bits
    g = D // GROUP
    N = 1 << bits
    lead = words.shape[:-1]
    if bits in ODD_PLANES:
        q = _unpack_planes(words, bits, D).reshape(*lead, g, GROUP)
    else:
        J = 32 // bits
        w = (words.to(torch.int64) & 0xFFFFFFFF).reshape(*lead, g, bits)
        sh = _field_shifts(J, bits, str(words.device))
        q = ((w[..., None] >> sh) & ((1 << bits) - 1)).reshape(*lead, g, GROUP)
    q = q.to(torch.float32)
    if compand_a > 0.0:
        t = compand_decode(q, bits, compand_a)
    else:
        t = (2.0 * q + 1.0) / N - 1.0
    return (t * scale[..., None].to(torch.float32)).reshape(*lead, D)


def dequantize_kv(words: torch.Tensor, scale: torch.Tensor, bits: int,
                  dtype=torch.bfloat16, compand_a: float = 0.0) -> torch.Tensor:
    """Inverse of quantize_kv -> (..., D), unrotated, true channel order."""
    return rotate_groups(dequantize_rotated(words, scale, bits, compand_a)).to(dtype)


def merged_layout(k_bits: int, v_bits: int) -> bool:
    """Even widths for both K and V store merged: all heads' words share the
    last dim, (P, T, Hk*gw) instead of (P, T, Hk, gw). The bytes are the
    same; the JAX package chose the shape for its lane tiling and the port
    keeps it so that states carry across."""
    return k_bits in (2, 4, 8) and v_bits in (2, 4, 8)


def quant_cache_shapes(shape: tuple, k_bits: int, v_bits: int, device=None) -> dict:
    """Zero-initialized quantized layer state for cache shape (N, T, Hk, D)."""
    n, t, hk, d = shape
    if merged_layout(k_bits, v_bits):
        dims = {"k_q": (n, t, hk * d * k_bits // 32), "k_s": (n, t, hk * d // GROUP),
                "v_q": (n, t, hk * d * v_bits // 32), "v_s": (n, t, hk * d // GROUP)}
    else:
        dims = {"k_q": (n, t, hk, d * k_bits // 32), "k_s": (n, t, hk, d // GROUP),
                "v_q": (n, t, hk, d * v_bits // 32), "v_s": (n, t, hk, d // GROUP)}
    return {name: torch.zeros(s, dtype=torch.int32 if name.endswith("_q") else torch.bfloat16,
                              device=device)
            for name, s in dims.items()}


def quantize_kv_stored(x: torch.Tensor, bits: int, merged: bool, compand_a: float = 0.0):
    """quantize_kv in the stored layout: x (B, S, Hk, D) -> merged
    (B, S, Hk*D*bits/32) or per-head (B, S, Hk, D*bits/32)."""
    if merged:
        B, S, Hk, D = x.shape
        return quantize_kv(x.reshape(B, S, Hk * D), bits, compand_a)
    return quantize_kv(x, bits, compand_a)


def quantize_kv_pair(k, v, k_bits: int, v_bits: int, merged: bool, compand_a: float = 0.0):
    """(k words, k scales, v words, v scales) of (B, S, Hk, D) keys and
    values in the stored layout; one pass over both when the widths agree."""
    if k_bits == v_bits:
        q, s = quantize_kv_stored(torch.cat([k, v], dim=0), k_bits, merged, compand_a)
        B = k.shape[0]
        return q[:B], s[:B], q[B:], s[B:]
    return (*quantize_kv_stored(k, k_bits, merged, compand_a),
            *quantize_kv_stored(v, v_bits, merged, compand_a))


def quant_cache_update(layer_state: dict, k_new, v_new, positions, k_bits: int, v_bits: int,
                       compand_a: float = 0.0, rows=None) -> dict:
    """Write quantized (B, S, Hk, D) keys/values at [row, position] of a linear
    cache, in place: row b, or rows[b] when given. The stored words and scales
    are the JAX package's quant_cache_update's. Returns the layer state."""
    merged = layer_state["k_q"].dim() == 3
    kq, ks, vq, vs = quantize_kv_pair(k_new, v_new, k_bits, v_bits, merged, compand_a)
    r = (torch.arange(k_new.shape[0], device=positions.device) if rows is None
         else rows.long())[:, None]
    pos = positions.long()
    for name, val in (("k_q", kq), ("k_s", ks), ("v_q", vq), ("v_s", vs)):
        layer_state[name][r, pos] = val
    return layer_state


def dequantize_kv_stored(words, scale, bits: int, hk: int, merged: bool,
                         dtype=torch.bfloat16, compand_a: float = 0.0):
    """Dequantize from the stored layout -> (..., Hk, D)."""
    flat = dequantize_kv(words, scale, bits, dtype, compand_a)
    if merged:
        return flat.reshape(*flat.shape[:-1], hk, flat.shape[-1] // hk)
    return flat


def quant_cache_fetch(layer_state: dict, k_bits: int, v_bits: int, dtype=torch.bfloat16,
                      compand_a: float = 0.0, hk: int = 0):
    """Dequantize the whole layer -> (k, v) (..., Hk, D). `hk` is required
    for merged (3-D) storage."""
    merged = layer_state["k_q"].dim() == 3
    if merged and hk <= 0:
        raise ValueError("quant_cache_fetch on merged storage needs hk")
    k = dequantize_kv_stored(layer_state["k_q"], layer_state["k_s"], k_bits, hk, merged,
                             dtype, compand_a)
    v = dequantize_kv_stored(layer_state["v_q"], layer_state["v_s"], v_bits, hk, merged,
                             dtype, compand_a)
    return k, v


def state_heads(layer_state: dict, head_dim: int) -> int:
    """KV heads of a quantized layer state, from either storage shape."""
    if layer_state["k_q"].dim() == 3:
        return layer_state["k_s"].shape[-1] // (head_dim // GROUP)
    return layer_state["k_q"].shape[-2]
