"""Projection fusion: run same-input Linears as one matmul
(counterpart of exllamav3_tpu/modules/multilinear.py).

At load the materialized weights of sibling projections (q/k/v, gate/up)
concatenate along the output dim under the parent module's key, by kind:
`<name>_w` (bf16), `<name>_q` + `<name>_scale` (int8), `<name>_q4` + `<name>_s4`
(int4), `<name>_qb` + `<name>_sb` (int-B) and `<name>_sq` + `<name>_sqs` (`.sq`
serving tensors, which share one activation-side Hadamard). The packed kinds'
pair and group structure lives on k, so they concatenate like any other;
int-B and `.sq` fuse only where every sibling has the same number of packed
rows. Packed trellis groups (`trellis` or `words`) do not fuse, as in the JAX
package: their projections stay separate linears.
"""
from __future__ import annotations

import torch

from .linear import bf16_matmul_f32
from ..ops.q_matmul import int4_matmul, int8_matmul, intb_matmul
from ..quant.hadamard import had_right

# kind: (a child's tensor names, their suffixes under the parent's key)
_KINDS = {
    "weight": (("weight",), ("_w",)),
    "int8": (("weight_q", "scale"), ("_q", "_scale")),
    "int4": (("weight_q4", "scale4"), ("_q4", "_s4")),
    "intb": (("weight_qb", "scale_qb"), ("_qb", "_sb")),
    "sq": (("weight_sq", "scale_sq"), ("_sq", "_sqs")),
}


def _kind(p: dict | None) -> str | None:
    for kind, (names, _) in _KINDS.items():
        if p is not None and set(p) == set(names):
            return kind
    return None


def try_fuse(params: dict, parent_key: str, name: str, linears: list) -> bool:
    """Fuse `linears` into params[parent_key][name_*] and drop their entries.
    Returns False, leaving everything untouched, when the representations
    differ, carry biases, or (int-B, `.sq`) differ in their packed rows."""
    ps = [params.get(lin.key) for lin in linears]
    kinds = {_kind(p) for p in ps}
    if len(kinds) != 1 or None in kinds:
        return False
    kind = kinds.pop()
    names, suffixes = _KINDS[kind]
    if kind in ("intb", "sq") and len({p[names[0]].shape[0] for p in ps}) != 1:
        return False  # mixed k paddings cannot share one packed array
    parent = params.setdefault(parent_key, {})
    for tensor_name, suffix in zip(names, suffixes):
        # output features are the last dim (the int8 scale is (out,))
        parent[name + suffix] = torch.cat([p[tensor_name] for p in ps], dim=-1)
    for lin in linears:
        params.pop(lin.key, None)
    return True


def unfuse(params: dict, parent_key: str, name: str, linears: list, out_features: list) -> None:
    """Inverse of try_fuse: split the concatenated tensors back into the
    children's entries."""
    parent = params.get(parent_key, {})
    offs = [0]
    for n in out_features:
        offs.append(offs[-1] + n)
    for names, suffixes in _KINDS.values():
        if name + suffixes[0] not in parent:
            continue
        fused = [parent.pop(name + suffix) for suffix in suffixes]
        for lin, a, b in zip(linears, offs, offs[1:]):
            params[lin.key] = {tensor_name: t[..., a:b].contiguous()
                                for tensor_name, t in zip(names, fused)}
        return


def is_fused(params: dict, parent_key: str, name: str) -> bool:
    p = params.get(parent_key, {})
    return any(name + suffixes[0] in p for _, suffixes in _KINDS.values())


def fused_forward(params: dict, parent_key: str, name: str, x,
                  out_dtype=torch.float32):
    """One matmul over the fused weights; returns the full (..., sum_n)."""
    p = params[parent_key]
    if name + "_w" in p:
        y = bf16_matmul_f32(x, p[name + "_w"])
    elif name + "_q4" in p:
        y = int4_matmul(x, p[name + "_q4"], p[name + "_s4"])
    elif name + "_qb" in p:
        y = intb_matmul(x, p[name + "_qb"], p[name + "_sb"])
    elif name + "_sq" in p:
        y = intb_matmul(had_right(x), p[name + "_sq"], p[name + "_sqs"])
    else:
        y = int8_matmul(x, p[name + "_q"], p[name + "_scale"])
    return y.to(out_dtype)
