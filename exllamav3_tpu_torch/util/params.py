"""Carry a parameter dict across packages or devices.

`params_from_jax` installs the JAX package's `Model.params` pytree, given as
numpy arrays (e.g. `jax.tree.map(np.asarray, jmodel.params)`), into a port
model on its device. The two packages use the same keys and layouts, so both
then run on identical weights: int8 codes, `fused` trellis words, the packed
int4 bytes and int-B words (`weight_q4`, `weight_qb`, `weight_sq` and their
fused `*_q4`, `*_qb`, `*_sq` entries) bit for bit, their scales as bf16.
Gemma's parameters carry as they are: its norms' weights w (applied as
1 + w), q/k norms, and the tied head's bf16 "weight" under "lm_head".
DeepSeek-V4's carry as they are too (the attention's "sinks", each
compressor's "ape", the mHC "fn", "base" and "scale"), except the hash
routing table, which the JAX package keeps on its module and not among its
parameters: each hash-routed layer reads its "tid2eid" from the checkpoint
the port model was made from.
`cache_state_from_jax` does the same for a cache state, bf16 ({"k", "v"}),
quantized ({"k_q", "v_q"} int32 words, {"k_s", "v_s"} bf16 scales) or an SWA
ring ({"k", "v"} bf16 and {"pos"} int32 slot positions). This module needs
no JAX: it only reads numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch


def _np_to_torch(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def params_from_jax(model, params_np: dict) -> dict:
    """{module key: {name: numpy array}} -> the model's torch params."""
    from ..ops.q_matmul import intb_bits_from_shapes

    model.params = {
        key: {name: _np_to_torch(arr).to(model.device) for name, arr in group.items()}
        for key, group in params_np.items()
    }
    # a Linear that holds int-B codes knows their width, as after its own load
    for mod in model.root.walk():
        group = model.params.get(mod.key, {})
        for name, scale_name in (("weight_qb", "scale_qb"), ("weight_sq", "scale_sq")):
            if name in group:
                mod.qbits = intb_bits_from_shapes(group[name].shape[0],
                                                  group[scale_name].shape[0])
        if hasattr(mod, "load_tid2eid") and mod.key in model.params:
            mod.load_tid2eid(model.params, model.device)
    return model.params


def cache_state_from_jax(cache, state_np: dict) -> dict:
    """{layer key: {name: numpy array}} -> the port cache's state, on its
    device. Shapes and dtypes must be the cache's own."""
    for key, group in state_np.items():
        for name, arr in group.items():
            t = _np_to_torch(arr)
            have = cache.state[key][name]
            if t.shape != have.shape or t.dtype != have.dtype:
                raise ValueError(f"cache state {key}.{name}: {tuple(t.shape)} {t.dtype} does not "
                                 f"fit {tuple(have.shape)} {have.dtype}")
            cache.state[key][name] = t.to(cache.device)
    return cache.state


def params_to(params: dict, device) -> dict:
    """A copy of a port parameter dict on another device."""
    return {key: {name: t.to(device) for name, t in group.items()}
            for key, group in params.items()}
