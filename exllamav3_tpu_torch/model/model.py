"""Model: module list, loading and the step functions
(counterpart of exllamav3_tpu/model/model.py).

`forward` is the step over a cache of either layout (the JAX package's
step_fn: "paged" through block tables, "dense" over a linear cache) and
`forward_simple` the cacheless full forward. PyTorch runs eagerly, so there
is no per-shape compile cache; the generator captures its decode step
(generator/decode_graph.py) at up to `graph_decode_rows` rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ..modules.module import ForwardCtx, Module
from ..util.device import resolve_device


class _Root(Module):
    def __init__(self, config, modules):
        super().__init__(config, key="")
        self.modules = modules


# serving bytes per EXL3 weight for each runtime mode, group and channel
# scales included (the JAX package's table)
_MODE_BYTES_PER_WEIGHT = {"int8": 1.0, "int6": 0.8125, "int4": 0.5625}
_EXL3_SIDE_SUFFIXES = (".suh", ".svh", ".su", ".sv", ".mcg", ".mul1")


def estimate_linear_mode_bytes(config, mode: str) -> int:
    """Weight bytes if every EXL3 linear loads in `mode`, from the safetensors
    headers alone; "fused" keeps the packed trellis as it is; dense tensors
    count as bf16 whatever the mode."""
    total = 0
    for key in config.stc.keys():
        s = config.stc.get_shape(key)
        if key.endswith(".trellis"):
            if mode == "fused":
                total += s[0] * s[1] * s[2] * 2
            else:
                total += int(s[0] * s[1] * 256 * _MODE_BYTES_PER_WEIGHT[mode])
        elif not key.endswith(_EXL3_SIDE_SUFFIXES):
            total += int(np.prod(s, dtype=np.int64)) * 2
    return total


def device_hbm_bytes(device: torch.device) -> int | None:
    """Total memory of a CUDA device, None for the CPU."""
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def select_linear_mode(config, hbm_bytes: int | None, reserve_frac: float = 0.20) -> str:
    """linear_mode="auto", the JAX package's footprint ladder: int8 whenever
    the weights fit with `reserve_frac` of device memory left for the cache
    and activations, else int6, int4, and at last "fused", the capacity mode
    (unknown capacity assumes int8 fits). "reconstruct" and the other packed
    widths (int3, int5) stay explicit modes only."""
    if hbm_bytes is None:
        return "int8"
    budget = hbm_bytes * (1.0 - reserve_frac)
    for mode in ("int8", "int6", "int4"):
        if estimate_linear_mode_bytes(config, mode) <= budget:
            return mode
    return "fused"


def _as_tensor(a, device, dtype=torch.int32) -> torch.Tensor | None:
    """`a` as a tensor on `device`: a tensor already there in `dtype` is
    returned as it is, with no copy (a captured decode step hands its static
    tensors through); numpy input is copied over."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


class Model:
    def __init__(self, config, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.modules: list[Module] = []
        self.params: dict | None = None
        self.caps: dict = {}  # capabilities an architecture declares (JAX: dflash_draft, mtp_draft)

    @property
    def graph_decode_rows(self) -> int | None:
        """The most rows of a decode step that the generator may capture as a
        CUDA graph: the least that any module allows (Module.graph_decode_rows;
        None: any, 0: none)."""
        return min((m.graph_decode_rows for top in self.modules for m in top.walk()
                    if m.graph_decode_rows is not None), default=None)

    @property
    def root(self) -> Module:
        return _Root(self.config, self.modules)

    @staticmethod
    def from_config(config, component: str = "text", device="cuda") -> "Model":
        return config.model_classes[component](config, device=device)

    # -- loading -------------------------------------------------------------

    def load(self, progress_cb=None) -> dict:
        ip = self.config.infer_params
        if ip.linear_mode == "auto":
            ip.linear_mode = select_linear_mode(self.config, device_hbm_bytes(self.device))
        params: dict = {}
        n = len(self.modules)
        with torch.no_grad():
            for i, m in enumerate(self.modules):
                m.load(params, self.device)
                if progress_cb:
                    progress_cb(i + 1, n)
        self.params = params
        return params

    # -- forward --------------------------------------------------------------

    def forward_modules(self, x, params: dict, ctx: ForwardCtx):
        for m in self.modules:
            x = m.forward(x, params, ctx)
        return x

    @torch.no_grad()
    def forward(self, ids, cache, positions, cache_seqlens, block_tables=None,
                cache_rows=None, state_slots=None) -> torch.Tensor:
        """One step over `cache` (a Cache): ids (B, S) at absolute `positions`
        (B, S), with `cache_seqlens` (B,) tokens already cached. The layout
        follows the cache's spec: a paged cache needs `block_tables`
        (B, max_pages); a linear one takes none, and writes and reads row b
        for sequence b, or row cache_rows[b] when given. A cache with SWA
        rings keeps sequence b's ring in row state_slots[b] (row b when not
        given). Writes this chunk's keys/values into the cache and returns
        the logits (B, S, vocab) f32."""
        dev = self.device
        linear = cache.spec.layout == "linear"
        if linear and block_tables is not None:
            raise ValueError("a linear cache takes no block tables")
        if not linear and (block_tables is None or cache_rows is not None):
            raise ValueError("a paged cache needs block tables and takes no cache rows")
        ctx = ForwardCtx(
            positions=_as_tensor(positions, dev),
            attn_mode="linear" if linear else "paged",
            cache=cache.state,
            k_bits=cache.spec.k_bits,
            v_bits=cache.spec.v_bits,
            compand_a=cache.spec.compand_a,
            block_tables=_as_tensor(block_tables, dev),
            cache_seqlens=_as_tensor(cache_seqlens, dev),
            cache_rows=_as_tensor(cache_rows, dev),
            state_slots=_as_tensor(state_slots, dev),
        )
        ids = _as_tensor(ids, dev, torch.long)
        ctx.input_ids = ids
        return self.forward_modules(ids, self.params, ctx)

    @torch.no_grad()
    def forward_simple(self, ids) -> torch.Tensor:
        """Cacheless full forward: ids (B, S) -> logits (B, S, vocab) f32."""
        ids = _as_tensor(ids, self.device, torch.long)
        B, S = ids.shape
        positions = torch.arange(S, dtype=torch.int32, device=self.device)[None].expand(B, S)
        return self.forward_modules(ids, self.params, ForwardCtx(positions=positions, input_ids=ids))
