"""KV cache, paged or linear, bf16 or quantized (counterpart of
exllamav3_tpu/model/cache.py).

Two layouts per attention layer:
  * paged: k, v (num_pages, PAGE_SIZE, kv_heads, head_dim) with
    per-sequence block tables; the continuous-batching generator's cache.
  * linear: k, v (batch_size, max_len, kv_heads, head_dim), slot == token
    position; a step writes and reads row b of the cache for its sequence b,
    or the rows it names (a draft model's cache, one row per job slot).
With k_bits / v_bits set, packed int32 words k_q, v_q and bf16 group scales
k_s, v_s replace k and v in either layout (ops/kv_quant.py). An MLA layer
(modules/mla_attn.py) holds one latent row a token instead, {"kv"} of
(N, T, 1, kv_lora_rank + rope) bf16, or with k_bits {"kv_q", "kv_s"} (the
latent packed, per-head storage with one head) and {"k_pe"} (the rope key,
bf16); each cache user makes its own layer state. With `swa_ring`, a
sliding-window attention layer holds a ring instead, {"k", "v": (N, W, Hk, D),
"pos": (N, W) int32, -1 where never written}, one row of W slots per
sequence slot (modules/attn.py); N is `recurrent_slots`, or the JAX
package's default (batch_size for the linear layout, 33 for the paged one).
The JAX package threads the cache through its jitted step as a functional
pytree; here the tensors are updated in place, which keeps one copy of the
cache in device memory. The layout defaults to "paged" (JAX: "linear"),
which every caller of the port's first slices relies on.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..constants import PAGE_SIZE
from ..util.device import resolve_device


@dataclass
class CacheSpec:
    layout: str = "paged"  # "paged" | "linear"
    batch_size: int = 1    # linear layout: rows
    max_len: int = 4096    # linear layout: slots per row
    num_pages: int = 0     # paged layout
    kv_dtype: str = "bfloat16"
    k_bits: int = 0  # 0 = unquantized; 2..8 = quantized cache
    v_bits: int = 0
    compand_a: float = 0.0  # cubic compander of the quantized cache (0 = off)
    # sequence slots of per-sequence state (the SWA rings); 0 = derive
    recurrent_slots: int = 0
    # sliding-window layers as rings of window + 17 slots (rounded up to 8)
    # a sequence slot instead of full-length caches; turns prefix reuse off
    swa_ring: bool = False

    def state_slots(self) -> int:
        """Rows of per-sequence state: recurrent_slots, else batch_size for
        the linear layout and 33 (a generator's 32 jobs and a scrap row) for
        the paged one."""
        if self.recurrent_slots:
            return self.recurrent_slots
        return self.batch_size if self.layout == "linear" else 33


def cache_base_shape(spec: CacheSpec, heads: int, dim: int) -> tuple:
    """(N, T, heads, dim) for the spec's layout."""
    if spec.layout == "linear":
        return (spec.batch_size, spec.max_len, heads, dim)
    if spec.layout == "paged":
        return (spec.num_pages, PAGE_SIZE, heads, dim)
    raise ValueError(f"unknown cache layout {spec.layout!r}")


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

    def reset(self):
        self.state = self.new_state()


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
        from ..ops.kv_quant import quantize_kv_pair

        merged = layer_state["k_q"].dim() == 3
        kq, ks, vq, vs = quantize_kv_pair(k_new, v_new, k_bits, v_bits, merged, compand_a)
        layer_state["k_q"][pages, in_page] = kq
        layer_state["k_s"][pages, in_page] = ks
        layer_state["v_q"][pages, in_page] = vq
        layer_state["v_s"][pages, in_page] = vs
        return layer_state
    layer_state["k"][pages, in_page] = k_new.to(layer_state["k"].dtype)
    layer_state["v"][pages, in_page] = v_new.to(layer_state["v"].dtype)
    return layer_state


def linear_cache_update(layer_state: dict, k_new, v_new, positions, k_bits: int = 0,
                        v_bits: int = 0, compand_a: float = 0.0, rows=None) -> dict:
    """Write (B, S, Hk, D) keys/values at [row, position] of a linear cache, in
    place, quantized first when k_bits is set: row b, or rows[b] when given
    (a (B,) index), so that a step touches only its own sequences' rows.
    Returns the layer state."""
    if k_bits:
        from ..ops.kv_quant import quant_cache_update

        return quant_cache_update(layer_state, k_new, v_new, positions, k_bits, v_bits,
                                  compand_a, rows=rows)
    r = (torch.arange(k_new.shape[0], device=positions.device) if rows is None
         else rows.long())[:, None]
    pos = positions.long()
    layer_state["k"][r, pos] = k_new.to(layer_state["k"].dtype)
    layer_state["v"][r, pos] = v_new.to(layer_state["v"].dtype)
    return layer_state
