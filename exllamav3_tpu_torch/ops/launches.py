"""The launch counts of the hand-written kernels, by name.

Every wrapper that launches a kernel adds one to its `launches` where it
launches, and nowhere else. A replayed CUDA graph runs no Python, so it
counts nothing: generator/decode_graph.py records what each wrapper counted
while a graph was captured (`counts_since`) and adds that on each replay
(`add_counts`). The kernel library's own C-side counts (such as
`exl3_decode_launches`) miss replays; read them only around eager calls.
"""
from __future__ import annotations

import functools


@functools.lru_cache(maxsize=None)
def wrappers() -> dict:
    """The kernels' wrappers (or the launch counters of one body of an
    entry) by name; each has a `launches` count."""
    from ..probes import a8_ablate, a8_diag_proto, dequant_probe, dma_floor, fused_ablate, int4_sweep
    from . import q_matmul as qm
    from .exl3_gemm import exl3_gemm_kernel
    from .flash_attention import (latent_attention_kernel, latent_attention_prefill,
                                  latent_attention_quant_kernel, latent_attention_quant_prefill,
                                  linear_attention_kernel, linear_attention_prefill,
                                  linear_attention_quant_kernel, linear_attention_quant_prefill,
                                  paged_attention_kernel, paged_attention_prefill,
                                  paged_attention_quant_kernel, paged_attention_quant_prefill,
                                  pool_attention_stats_kernel, ring_attention_kernel,
                                  ring_attention_stats_kernel, rows_attention_stats_kernel)
    from .fused_mlp import fused_mlp_int8_kernel
    from .moe_gemm import selected_expert_mlp_kernel

    return {"int8_matmul": qm.int8_matmul_kernel, "fused_mlp": fused_mlp_int8_kernel,
            "paged_attention": paged_attention_kernel, "exl3_gemm": exl3_gemm_kernel,
            "paged_attention_quant": paged_attention_quant_kernel,
            **{name: getattr(qm, name + "_kernel")
               for name in ("int4_matmul", "int4_matmul_a8", "intb_matmul", "intb_matmul_a8")},
            "moe_gemm": selected_expert_mlp_kernel,
            "linear_attention": linear_attention_kernel,
            # of the four entries' launches, those of the prefill body
            "paged_attention_prefill": paged_attention_prefill,
            "linear_attention_prefill": linear_attention_prefill,
            "paged_attention_quant_prefill": paged_attention_quant_prefill,
            "linear_attention_quant_prefill": linear_attention_quant_prefill,
            "linear_attention_quant": linear_attention_quant_kernel,
            "latent_attention": latent_attention_kernel,
            "latent_attention_quant": latent_attention_quant_kernel,
            # of the two latent entries' launches, those of the prefill body
            "latent_attention_prefill": latent_attention_prefill,
            "latent_attention_quant_prefill": latent_attention_quant_prefill,
            "ring_attention": ring_attention_kernel,
            "ring_attention_stats": ring_attention_stats_kernel,
            "pool_attention_stats": pool_attention_stats_kernel,
            "rows_attention_stats": rows_attention_stats_kernel,
            # rows 15-20, the probes: on no served path
            "fused_ablate": fused_ablate.fused_ablate_kernel,
            "dequant_probe": dequant_probe.dequant_probe_kernel,
            "int4_sweep": int4_sweep.int4_sweep_kernel, "a8_ablate": a8_ablate.a8_ablate_kernel,
            "a8_diag_proto": a8_diag_proto.a8_diag_kernel, "dma_floor": dma_floor.dma_floor_kernel}


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def set_counts(counts: dict) -> None:
    for name, fn in wrappers().items():
        fn.launches = counts.get(name, 0)


def counts_since(before: dict) -> dict:
    """The launches each wrapper counted since `before` (read_counts()),
    those that counted any."""
    now = read_counts()
    return {name: n - before[name] for name, n in now.items() if n != before[name]}


def add_counts(counts: dict) -> None:
    w = wrappers()
    for name, n in counts.items():
        w[name].launches += n
