"""Module tree: static descriptions over a parameter dict
(counterpart of exllamav3_tpu/modules/module.py).

A module holds no tensors. `load(params, device)` fills params[self.key]
(a dict of tensors on `device`) from the checkpoint, and
`forward(x, params, ctx)` is a plain function of tensors. Runtime choices
(fused projections, linear representation) are read from the parameter
dict itself, so a dict carried across from the JAX package, or copied to
another device, runs without reloading.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class ForwardCtx:
    """Per-call context threaded through module forwards."""

    positions: torch.Tensor | None = None      # (B, S) int32 token positions
    attn_mode: str = "dense"                   # "dense" (cacheless) | "paged" | "linear"
    cache: Any = None                          # {layer key: {"k", "v"} | {"k_q", "k_s", "v_q", "v_s"} | ...}
    block_tables: torch.Tensor | None = None   # (B, max_pages) int32
    cache_seqlens: torch.Tensor | None = None  # (B,) int32 tokens already cached
    cache_rows: torch.Tensor | None = None     # linear layout: (B,) int32 cache row of each sequence
    state_slots: torch.Tensor | None = None    # (B,) int32 ring row of each sequence (None: row b)
    input_ids: torch.Tensor | None = None      # (B, S) token ids (DeepSeek-V4's hash routing)
    k_bits: int = 0                            # quantized cache widths (0 = bf16 cache)
    v_bits: int = 0
    compand_a: float = 0.0                     # cubic compander of the quantized cache (0 = off)
    # what every attention layer of a step would compute anew: filled by the
    # first one. (pages, slots) of the positions (paged), and (B,) total lengths
    page_index: tuple | None = None
    total_lens: torch.Tensor | None = None


class Module:
    # the most rows a decode step may have for this module to read nothing
    # of the device on the host in it, so that the step can be captured as a
    # CUDA graph (None: any; 0: none)
    graph_decode_rows: int | None = None

    def __init__(self, config, key: str):
        self.config = config
        self.key = key
        self.modules: list[Module] = []

    def load(self, params: dict, device: torch.device) -> None:
        for m in self.modules:
            m.load(params, device)

    def forward(self, x, params: dict, ctx: ForwardCtx):
        for m in self.modules:
            x = m.forward(x, params, ctx)
        return x

    def walk(self):
        yield self
        for m in self.modules:
            yield from m.walk()

    def __repr__(self):
        return f"<{self.__class__.__name__} {self.key}>"
