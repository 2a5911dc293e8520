"""Carry a parameter dict across packages or devices.

`params_from_jax` installs the JAX package's `Model.params` pytree, given as
numpy arrays (e.g. `jax.tree.map(np.asarray, jmodel.params)`), into a port
model on its device. The two packages use the same keys and layouts, so both
then run on identical weights, int8 codes and `fused` trellis words (int32)
included. `cache_state_from_jax` does the same for a cache state, bf16
({"k", "v"}) or quantized ({"k_q", "v_q"} int32 words, {"k_s", "v_s"} bf16
scales). This module needs no JAX: it only reads numpy arrays.
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
    model.params = {
        key: {name: _np_to_torch(arr).to(model.device) for name, arr in group.items()}
        for key, group in params_np.items()
    }
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
