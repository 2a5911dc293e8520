"""Paged bf16 KV cache (counterpart of exllamav3_tpu/model/cache.py).

Layout per attention layer: k, v (num_pages, PAGE_SIZE, kv_heads, head_dim)
with per-sequence block tables. The JAX package threads the cache through
its jitted step as a functional pytree; here the tensors are updated in
place, which keeps one copy of the cache in device memory. The linear layout
and the quantized layouts are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import PAGE_SIZE


@dataclass
class CacheSpec:
    layout: str = "paged"
    num_pages: int = 0
    kv_dtype: str = "bfloat16"


def cache_base_shape(spec: CacheSpec, heads: int, dim: int) -> tuple:
    if spec.layout != "paged":
        raise NotImplementedError(f"cache layout {spec.layout!r} is not ported yet")
    return (spec.num_pages, PAGE_SIZE, heads, dim)


def cache_dtype(spec: CacheSpec):
    return torch.bfloat16 if spec.kv_dtype == "bfloat16" else torch.float32


class Cache:
    """Owner of the cache tensors of every attention layer, on the model's
    device unless `device` says otherwise."""

    def __init__(self, model, spec: CacheSpec, device=None):
        self.spec = spec
        self.device = torch.device(device) if device is not None else model.device
        self.users = [m for m in model.root.walk() if getattr(m, "is_kv_cache_user", False)]
        self.layer_keys = [m.key for m in self.users]
        self.state = self.new_state()

    def new_state(self) -> dict:
        return {m.key: m.new_cache_layer(self.spec, self.device) for m in self.users}


def paged_cache_update(layer_state: dict, k_new, v_new, positions, block_tables) -> dict:
    """Write (B, S, Hk, D) keys/values at token positions through the block
    tables, in place. Returns the layer state."""
    page_slot = (positions // PAGE_SIZE).long()
    in_page = (positions % PAGE_SIZE).long()
    pages = torch.gather(block_tables.long(), 1, page_slot)
    layer_state["k"][pages, in_page] = k_new.to(layer_state["k"].dtype)
    layer_state["v"][pages, in_page] = v_new.to(layer_state["v"].dtype)
    return layer_state
