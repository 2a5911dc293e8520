"""Paged KV cache, bf16 or quantized (counterpart of exllamav3_tpu/model/cache.py).

Layout per attention layer: k, v (num_pages, PAGE_SIZE, kv_heads, head_dim)
with per-sequence block tables; with k_bits / v_bits set, packed int32 words
k_q, v_q and bf16 group scales k_s, v_s instead (ops/kv_quant.py). The JAX
package threads the cache through its jitted step as a functional pytree;
here the tensors are updated in place, which keeps one copy of the cache in
device memory. The linear layout is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import PAGE_SIZE
from ..util.device import resolve_device


@dataclass
class CacheSpec:
    layout: str = "paged"
    num_pages: int = 0
    kv_dtype: str = "bfloat16"
    k_bits: int = 0  # 0 = unquantized; 2..8 = quantized cache
    v_bits: int = 0
    compand_a: float = 0.0  # cubic compander of the quantized cache (0 = off)


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
        self.device = resolve_device(device) if device is not None else model.device
        self.users = [m for m in model.root.walk() if getattr(m, "is_kv_cache_user", False)]
        self.layer_keys = [m.key for m in self.users]
        self.state = self.new_state()

    def new_state(self) -> dict:
        return {m.key: m.new_cache_layer(self.spec, self.device) for m in self.users}


def page_index(positions, block_tables) -> tuple:
    """((B, S) page, (B, S) slot in the page) of each token position, through
    the block tables. The same for every layer of a step."""
    page_slot = (positions // PAGE_SIZE).long()
    in_page = (positions % PAGE_SIZE).long()
    return torch.gather(block_tables.long(), 1, page_slot), in_page


def paged_cache_update(layer_state: dict, k_new, v_new, positions, block_tables,
                       k_bits: int = 0, v_bits: int = 0, compand_a: float = 0.0,
                       index: tuple | None = None) -> dict:
    """Write (B, S, Hk, D) keys/values at token positions through the block
    tables, in place, quantized first when k_bits is set. `index` is
    page_index(positions, block_tables) where the caller has it already.
    Returns the layer state."""
    pages, in_page = index if index is not None else page_index(positions, block_tables)
    if k_bits:
        from ..ops.kv_quant import quantize_kv_stored

        merged = layer_state["k_q"].dim() == 3
        if k_bits == v_bits:  # one pass over both
            q, s = quantize_kv_stored(torch.cat([k_new, v_new], dim=0), k_bits, merged, compand_a)
            B = k_new.shape[0]
            kq, vq, ks, vs = q[:B], q[B:], s[:B], s[B:]
        else:
            kq, ks = quantize_kv_stored(k_new, k_bits, merged, compand_a)
            vq, vs = quantize_kv_stored(v_new, v_bits, merged, compand_a)
        layer_state["k_q"][pages, in_page] = kq
        layer_state["k_s"][pages, in_page] = ks
        layer_state["v_q"][pages, in_page] = vq
        layer_state["v_s"][pages, in_page] = vs
        return layer_state
    layer_state["k"][pages, in_page] = k_new.to(layer_state["k"].dtype)
    layer_state["v"][pages, in_page] = v_new.to(layer_state["v"].dtype)
    return layer_state
