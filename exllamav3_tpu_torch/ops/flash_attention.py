"""Paged attention over the bf16 KV cache
(counterpart of exllamav3_tpu/ops/flash_attention.py::flash_attention with
block_tables, k_bits = v_bits = 0).

One kernel (csrc/paged_attention.cu) serves decode, prefill chunks and
padded rows: causal by absolute position against total_lens, GQA, optional
sliding window, logit softcap and per-head sinks. A row that sees no valid
key gives 0. On a CPU tensor the wrapper runs the plain version, built on
ops/attention.py::attend_paged. The linear layout, quantized KV, MLA,
merged-head and ring variants are not ported yet.
"""
from __future__ import annotations

import torch

from ..constants import PAGE_SIZE
from .attention import attend_paged
from .build import check_aligned, check_launch, library

Q_ROWS = 64  # query rows (tokens x group heads) per block in the kernel


def has_valid_key(q_positions, total_lens, sliding_window: int = 0) -> torch.Tensor:
    """(B, S) bool: the row sees at least one key."""
    hi = torch.minimum(q_positions, total_lens[:, None] - 1)
    lo = (torch.clamp(q_positions - sliding_window + 1, min=0) if sliding_window
          else torch.zeros_like(q_positions))
    return hi >= lo


def paged_attention_plain(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                          scale: float = 1.0, sliding_window: int = 0,
                          logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32: attend_paged, with rows that see no key set to 0."""
    o = attend_paged(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                     scale=scale, sliding_window=sliding_window,
                     logit_softcap=logit_softcap, sinks=sinks)
    valid = has_valid_key(q_positions, total_lens, sliding_window)
    return o * valid[:, :, None, None].to(o.dtype)


def paged_attention_kernel(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                           scale: float = 1.0, sliding_window: int = 0,
                           logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """Launch csrc/paged_attention.cu. q (B, S, Hq, D) f32; k/v pages
    (P, 256, Hk, D) bf16; block_tables (B, MP), q_positions (B, S) and
    total_lens (B,) int32; sinks (Hq,) f32 or None; D in {64, 128} and
    64 % (Hq / Hk) == 0."""
    B, S, Hq, D = q.shape
    P, PS, Hk, Dk = k_pages.shape
    ints = (block_tables, q_positions, total_lens)
    tensors = (q, k_pages, v_pages) + ints + ((sinks,) if sinks is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_kernel: all tensors must be on one CUDA device")
    if (q.dtype != torch.float32 or k_pages.dtype != torch.bfloat16
            or v_pages.dtype != torch.bfloat16 or any(t.dtype != torch.int32 for t in ints)
            or (sinks is not None and sinks.dtype != torch.float32)):
        raise TypeError("paged_attention_kernel: expected f32 q, bf16 k/v, int32 tables "
                        "and positions, f32 sinks")
    if (PS != PAGE_SIZE or Dk != D or v_pages.shape != k_pages.shape or D not in (64, 128)
            or Hq % Hk or Q_ROWS % (Hq // Hk) or block_tables.shape[0] != B
            or q_positions.shape != (B, S) or total_lens.shape != (B,)
            or (sinks is not None and sinks.shape != (Hq,))):
        raise ValueError(f"paged_attention_kernel: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k_pages.shape)}, tables {tuple(block_tables.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_kernel: tensors must be contiguous")
    check_aligned("paged_attention_kernel", q, k_pages, v_pages)
    out = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    err = library().exl3_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        q_positions.data_ptr(), total_lens.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(),
        B, S, Hq, Hk, D, block_tables.shape[1], P, float(scale), int(sliding_window),
        float(logit_softcap), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_paged_attention", err)
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0


def paged_attention(q, k_pages, v_pages, block_tables, q_positions, total_lens,
                    scale: float = 1.0, sliding_window: int = 0,
                    logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32. CUDA tensors go through the kernel, CPU tensors
    through the plain version."""
    fn = paged_attention_plain if q.device.type == "cpu" else paged_attention_kernel
    return fn(q, k_pages, v_pages, block_tables, q_positions, total_lens, scale=scale,
              sliding_window=sliding_window, logit_softcap=logit_softcap, sinks=sinks)
