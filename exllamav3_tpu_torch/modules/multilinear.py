"""Projection fusion: run same-input Linears as one matmul
(counterpart of exllamav3_tpu/modules/multilinear.py).

At load the materialized weights of sibling projections (q/k/v, gate/up)
concatenate along the output dim under the parent module's key:
`<name>_w` (bf16 kind) or `<name>_q` + `<name>_scale` (int8 kind). Packed
trellis groups (`trellis` or `words`) do not fuse, as in the JAX package:
their projections stay separate linears. The int4, int-B and `.sq` kinds are
not ported yet.
"""
from __future__ import annotations

import torch

from .linear import bf16_matmul_f32
from ..ops.q_matmul import int8_matmul


def try_fuse(params: dict, parent_key: str, name: str, linears: list) -> bool:
    """Fuse `linears` into params[parent_key][name_*] and drop their entries.
    Returns False, leaving everything untouched, when the representations
    differ or carry biases."""
    kinds = set()
    for lin in linears:
        p = params.get(lin.key)
        if p is None or "bias" in p:
            return False
        if set(p) == {"weight"}:
            kinds.add("weight")
        elif set(p) == {"weight_q", "scale"}:
            kinds.add("int8")
        else:
            return False
    if len(kinds) != 1:
        return False
    parent = params.setdefault(parent_key, {})
    ps = [params[lin.key] for lin in linears]
    if kinds.pop() == "weight":
        parent[name + "_w"] = torch.cat([p["weight"] for p in ps], dim=1)
    else:
        parent[name + "_q"] = torch.cat([p["weight_q"] for p in ps], dim=1)
        parent[name + "_scale"] = torch.cat([p["scale"] for p in ps], dim=0)
    for lin in linears:
        params.pop(lin.key, None)
    return True


def is_fused(params: dict, parent_key: str, name: str) -> bool:
    p = params.get(parent_key, {})
    return name + "_w" in p or name + "_q" in p


def fused_forward(params: dict, parent_key: str, name: str, x,
                  out_dtype=torch.float32):
    """One matmul over the fused weights; returns the full (..., sum_n)."""
    p = params[parent_key]
    if name + "_w" in p:
        y = bf16_matmul_f32(x, p[name + "_w"])
    else:
        y = int8_matmul(x, p[name + "_q"], p[name + "_scale"])
    return y.to(out_dtype)
