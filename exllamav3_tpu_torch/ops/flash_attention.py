"""Paged attention over the bf16 and the quantized KV cache
(counterpart of exllamav3_tpu/ops/flash_attention.py::flash_attention with
block_tables).

csrc/paged_attention.cu serves the bf16 cache and
csrc/paged_attention_quant.cu the quantized one (packed 2..8-bit words with
bf16 group scales, merged-head or per-head storage, unpacked in the kernel).
Each serves decode, prefill chunks and padded rows: causal by absolute
position against total_lens, GQA, optional sliding window, logit softcap and
per-head sinks. A row that sees no valid key gives 0. On a CPU tensor a
wrapper runs its plain version, built on ops/attention.py::attend_paged.
`paged_attention_any` picks by the layer state's keys. The JAX package
dequantizes a whole merged pool for tall chunks (a TPU tile-occupancy
matter); the port's kernel takes any S. The linear layout, MLA and ring
variants are not ported yet.
"""
from __future__ import annotations

import torch

from ..constants import PAGE_SIZE
from .attention import attend_paged
from .build import check_aligned, check_launch, library
from .kv_quant import rotate_groups, state_heads

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


# -- quantized cache ------------------------------------------------------------

def paged_attention_quant_plain(q, layer_state: dict, block_tables, q_positions, total_lens,
                                k_bits: int, v_bits: int, compand_a: float = 0.0,
                                scale: float = 1.0, sliding_window: int = 0,
                                logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """(B, S, Hq, D) f32: the gathered pages dequantized to f32 (as the
    kernel holds them), then the plain paged attention."""
    o = attend_paged(q, None, None, block_tables, q_positions, total_lens, scale=scale,
                     sliding_window=sliding_window, logit_softcap=logit_softcap, sinks=sinks,
                     quant_state=layer_state, k_bits=k_bits, v_bits=v_bits,
                     compand_a=compand_a, quant_dtype=torch.float32)
    valid = has_valid_key(q_positions, total_lens, sliding_window)
    return o * valid[:, :, None, None].to(o.dtype)


def paged_attention_quant_kernel(q, layer_state: dict, block_tables, q_positions, total_lens,
                                 k_bits: int, v_bits: int, compand_a: float = 0.0,
                                 scale: float = 1.0, sliding_window: int = 0,
                                 logit_softcap: float = 0.0, sinks=None) -> torch.Tensor:
    """Launch csrc/paged_attention_quant.cu. q (B, S, Hq, D) f32;
    layer_state {k_q, v_q int32 words, k_s, v_s bf16 scales}, merged
    (P, 256, Hk*w) or per-head (P, 256, Hk, w); block_tables (B, MP),
    q_positions (B, S) and total_lens (B,) int32; sinks (Hq,) f32 or None;
    k_bits, v_bits in 2..8; D in {64, 128} and 64 % (Hq / Hk) == 0. q is
    rotated per 32-channel group before the launch and the output rotated
    back after it; K and V stay in their stored, rotated basis."""
    B, S, Hq, D = q.shape
    kq, ks, vq, vs = (layer_state[n] for n in ("k_q", "k_s", "v_q", "v_s"))
    ints = (block_tables, q_positions, total_lens)
    tensors = (q, kq, ks, vq, vs) + ints + ((sinks,) if sinks is not None else ())
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged_attention_quant_kernel: all tensors must be on one CUDA device")
    if (q.dtype != torch.float32 or kq.dtype != torch.int32 or vq.dtype != torch.int32
            or ks.dtype != torch.bfloat16 or vs.dtype != torch.bfloat16
            or any(t.dtype != torch.int32 for t in ints)
            or (sinks is not None and sinks.dtype != torch.float32)):
        raise TypeError("paged_attention_quant_kernel: expected f32 q, int32 words, bf16 "
                        "scales, int32 tables and positions, f32 sinks")
    if D not in (64, 128) or not (2 <= k_bits <= 8 and 2 <= v_bits <= 8):
        raise ValueError(f"paged_attention_quant_kernel: unsupported D {D} or bits "
                         f"({k_bits}, {v_bits})")
    Hk = state_heads(layer_state, D)
    P, PS = kq.shape[:2]
    g = D // 32
    want = {"k_q": Hk * D * k_bits // 32, "k_s": Hk * g, "v_q": Hk * D * v_bits // 32,
            "v_s": Hk * g}
    if (PS != PAGE_SIZE or Hk < 1 or Hq % Hk or Q_ROWS % (Hq // Hk)
            or any(layer_state[n].shape[:2] != (P, PS) or layer_state[n][0, 0].numel() != w
                   for n, w in want.items())
            or block_tables.shape[0] != B or q_positions.shape != (B, S)
            or total_lens.shape != (B,) or (sinks is not None and sinks.shape != (Hq,))):
        raise ValueError(f"paged_attention_quant_kernel: unsupported shapes q {tuple(q.shape)}, "
                         f"k_q {tuple(kq.shape)}, v_q {tuple(vq.shape)}, "
                         f"tables {tuple(block_tables.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_quant_kernel: tensors must be contiguous")
    qr = rotate_groups(q)
    check_aligned("paged_attention_quant_kernel", qr, kq, vq)
    out = torch.empty((B, S, Hq, D), dtype=torch.float32, device=q.device)
    err = library().exl3_paged_attention_quant(
        qr.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        block_tables.data_ptr(), q_positions.data_ptr(), total_lens.data_ptr(),
        sinks.data_ptr() if sinks is not None else None, out.data_ptr(),
        B, S, Hq, Hk, D, block_tables.shape[1], P, int(k_bits), int(v_bits),
        float(compand_a), float(1.0 - compand_a), float(scale), int(sliding_window),
        float(logit_softcap), torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_paged_attention_quant", err)
    paged_attention_quant_kernel.launches += 1
    return rotate_groups(out)


paged_attention_quant_kernel.launches = 0


def paged_attention_any(q, layer_state: dict, block_tables, q_positions, total_lens,
                        k_bits: int = 0, v_bits: int = 0, compand_a: float = 0.0, **kw):
    """(B, S, Hq, D) f32. Dispatch by the layer state's keys: {"k", "v"} is
    the bf16 cache, {"k_q", "k_s", "v_q", "v_s"} the quantized one; CUDA
    tensors go through the kernel, CPU tensors through the plain version."""
    if "k_q" in layer_state:
        fn = (paged_attention_quant_plain if q.device.type == "cpu"
              else paged_attention_quant_kernel)
        return fn(q, layer_state, block_tables, q_positions, total_lens, k_bits, v_bits,
                  compand_a, **kw)
    return paged_attention(q, layer_state["k"], layer_state["v"], block_tables, q_positions,
                           total_lens, **kw)
