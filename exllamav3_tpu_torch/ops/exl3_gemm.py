"""EXL3 linear served straight from the packed trellis
(counterpart of exllamav3_tpu/ops/exl3_gemm.py).

y = ((x * suh) @ Hk) @ W_inner @ Hn * svh, with W_inner decoded from the
K-bit trellis words inside the kernel (csrc/exl3_gemm.cu), so a weight costs
K/8 bytes of device memory and of traffic. The Hadamards and sign vectors
stay outside the kernel, as plain torch. `words` keeps the JAX package's
layout (tk, K, tn*8) int32, so a parameter dict carries across unchanged;
the JAX kernel's permuted row and column orders and its 2^112 output scale
are artefacts of the TPU and have no counterpart here.

The kernel takes any number of rows: a block covers 16 of them (m <= 16,
decode) or BLOCK_ROWS, and further rows run as further blocks that decode
the weights again. So `exl3_matmul` sends every CUDA tensor through the
kernel, where the JAX dispatch leaves its kernel above its FUSED_MAX_ROWS
for reconstruct + matmul. The kernel splits k across blocks (split_count,
from the card's SM count and the bytes a block keeps in flight) and adds the
splits' partial sums in split order in the same launch: one device kernel a
call. exl3_gemm_split_plain is that arithmetic in plain torch. On the CPU
the plain version serves every row count: the reconstruct reference, bf16
operands and f32 sums, which both sides of the JAX dispatch compute.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..quant.codebook import CB_3INST
from ..quant.hadamard import had_right
from ..quant.reconstruct import exl3_matmul_ref, reconstruct_inner
from ..util.device import H100_SMS, arrival_counters, device_sms
from .build import check_aligned, check_launch, header_constants, library

# the kernel's limits and layout, read from its source: a block covers
# DECODE_ROWS rows (m <= DECODE_ROWS) in GEMM_STAGES stages of words, with its
# xh for at most XH_ONCE_STEPS k steps of KC staged at once, or BLOCK_ROWS
# rows in PREFILL_STAGES stages of words and xh; staged rows of LDW words and
# LDA bf16; the two bodies' launch bounds promise DECODE_BLOCKS and
# PREFILL_BLOCKS blocks an SM
(_STAGES, _PREFILL_STAGES, XH_ONCE_STEPS, _DECODE_MB, _PREFILL_MB, _KC, _LDW, _LDA,
 _DECODE_BLOCKS, _PREFILL_BLOCKS) = header_constants(
    "exl3_gemm.cu", "GEMM_STAGES", "PREFILL_STAGES", "XH_ONCE_STEPS", "DECODE_MB", "PREFILL_MB",
    "KC", "LDW", "LDA", "DECODE_BLOCKS", "PREFILL_BLOCKS")
DECODE_ROWS, BLOCK_ROWS = 16 * _DECODE_MB, 16 * _PREFILL_MB
# what an SM has of shared memory for blocks (the H100's 228 KB, 1 KB of it
# reserved a block), as the decode attention kernel sizes its blocks
_SM_SHARED, _BLOCK_RESERVED = header_constants("attention_decode.cuh", "SM_SHARED",
                                               "BLOCK_RESERVED")
# bytes an SM must keep in flight to stream at the card's rate (Little's law:
# 3.35 TB/s x ~1 us of latency over 132 SMs)
IN_FLIGHT_PER_SM = 26 << 10


def trellis_to_words(trellis: torch.Tensor) -> torch.Tensor:
    """(tk, tn, 16K) int16 file halfwords -> kernel layout (tk, K, tn*8) int32,
    on the tensor's device: stream word S[g*K + wi] of tile (kt, nt) lands at
    [kt, wi, nt*8 + g]."""
    u = trellis.to(torch.int64) & 0xFFFF
    w = (u[..., 1::2] << 16) | u[..., 0::2]          # (tk, tn, 8K) in 0..2^32-1
    w = ((w ^ 0x80000000) - 0x80000000).to(torch.int32)
    tk, tn, nw = w.shape
    K = nw // 8                                      # (kt, nt, g, wi) -> (kt, wi, nt, g)
    return w.reshape(tk, tn, 8, K).permute(0, 3, 1, 2).reshape(tk, K, tn * 8).contiguous()


def prepare_trellis_words(trellis: np.ndarray) -> np.ndarray:
    """trellis_to_words on a numpy array (the JAX package's load-time name)."""
    return trellis_to_words(torch.from_numpy(np.ascontiguousarray(trellis))).numpy()


def words_to_trellis(words: torch.Tensor) -> torch.Tensor:
    """Inverse of prepare_trellis_words: (tk, K, tn*8) int32 -> (tk, tn, 16K)
    int16 file halfwords."""
    tk, K, ln = words.shape
    tn = ln // 8
    w = words.to(torch.int64) & 0xFFFFFFFF
    w = w.reshape(tk, K, tn, 8).permute(0, 2, 3, 1).reshape(tk, tn, 8 * K)
    halves = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(tk, tn, 16 * K)
    return ((halves ^ 0x8000) - 0x8000).to(torch.int16)


def exl3_gemm_plain(xh: torch.Tensor, words: torch.Tensor, K: int, cb: int) -> torch.Tensor:
    """The kernel's function in plain torch: xh (m, k) bf16 times W_inner
    decoded to bf16, f32 sums. (m, n) f32."""
    w = reconstruct_inner(words_to_trellis(words), K, cb, dtype=torch.bfloat16)
    return xh.float() @ w.float()


def exl3_gemm_split_plain(xh: torch.Tensor, words: torch.Tensor, K: int, cb: int,
                          splits: int) -> torch.Tensor:
    """The kernel's split arithmetic in plain torch: k cut into `splits`
    runs of whole 128-wide steps as the kernel cuts it, each run's f32
    partial product, and the partials added in split order (from 0). (m, n)
    f32."""
    w = reconstruct_inner(words_to_trellis(words), K, cb, dtype=torch.bfloat16).float()
    x = xh.float()
    steps = xh.shape[1] // _KC
    per = -(-steps // splits)
    out = torch.zeros((xh.shape[0], w.shape[1]), dtype=torch.float32, device=xh.device)
    for s in range(splits):
        k0, k1 = s * per * _KC, min((s + 1) * per, steps) * _KC
        out = out + x[:, k0:k1] @ w[k0:k1]
    return out


def _blocks_per_sm(m: int, K: int, per: int) -> int:
    """Blocks an SM holds of a launch whose splits hold `per` k steps: the
    body's launch bounds, or fewer where its shared memory does not fit
    (the source's smem_bytes). chip_smoke.py holds it to the card's
    reading (exl3_gemm_blocks_per_sm)."""
    decode = m <= DECODE_ROWS
    words = _KC // 16 * K * _LDW * 4  # a stage of words: KC / 16 tile rows of K rows of LDW
    if decode:  # 8 or 16 rows of xh for the split's k range
        smem = _STAGES * words + (8 if m <= 8 else 16) * (per * _KC + 8) * 2
    else:
        smem = _PREFILL_STAGES * (words + BLOCK_ROWS * _LDA * 2)
    held = _DECODE_BLOCKS if decode else _PREFILL_BLOCKS
    return min(held, _SM_SHARED // (smem + _BLOCK_RESERVED))


@functools.lru_cache(maxsize=None)  # a served step asks for a few widths hundreds of times
def split_count(m: int, k: int, n: int, K: int, sms: int = H100_SMS) -> int:
    """k splits of the kernel's grid on a card of `sms` SMs. A block's time
    is its k steps, and the card's is that of its busiest SM: the blocks it
    holds times their steps, ceil(tiles * splits / sms) * ceil(steps /
    splits). Among the splits that leave no split without a step, keep a
    decode-size block's xh within XH_ONCE_STEPS steps and the grid resident
    at once (or one split), those that give the busiest SM the fewest steps
    are taken, and of them the fewest splits whose SMs keep IN_FLIGHT_PER_SM
    bytes in flight (each block its next STAGES - 1 steps of words, and of
    xh above DECODE_ROWS rows), else the one that keeps the most."""
    steps = k // _KC
    decode = m <= DECODE_ROWS
    tiles = (n // 128) * -(-m // (DECODE_ROWS if decode else BLOCK_ROWS))
    step_bytes = _KC * 16 * K + (0 if decode else min(m, BLOCK_ROWS) * _KC * 2)  # 128 columns
    ahead = _STAGES - 1 if decode else _PREFILL_STAGES - 1
    cands = []
    for s in range(1, steps + 1):
        per = -(-steps // s)
        if (s - 1) * per >= steps or (decode and per > XH_ONCE_STEPS):
            continue
        held = _blocks_per_sm(m, K, per)
        on_sm = -(-tiles * s // sms)  # blocks the busiest SM is given
        if s > 1 and on_sm > held:
            continue
        cands.append((on_sm * per, s, min(on_sm, held) * min(per, ahead) * step_bytes))
    if not cands:  # only splits past the resident grid keep the xh a block stages
        return -(-steps // XH_ONCE_STEPS)
    least = min(c[0] for c in cands)
    ties = [c for c in cands if c[0] == least]
    enough = [c for c in ties if c[2] >= IN_FLIGHT_PER_SM]
    return min(enough)[1] if enough else max(ties, key=lambda c: (c[2], -c[1]))[1]


def launch_plan(m: int, k: int, n: int, K: int, device) -> tuple:
    """(splits, blocks, workspace or None, counters) of a launch on `device`:
    the splits for its SM count, a (splits, m, n) f32 workspace of partial
    sums where there is more than one split, and the shared arrival counters
    (one an output tile, left 0 by every launch)."""
    splits = split_count(m, k, n, K, device_sms(device))
    mblocks = -(-m // (DECODE_ROWS if m <= DECODE_ROWS else BLOCK_ROWS))
    tiles = (n // 128) * mblocks
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=device) if splits > 1
          else None)
    return splits, tiles * splits, ws, arrival_counters(device, tiles)


def exl3_gemm_kernel(xh: torch.Tensor, words: torch.Tensor, K: int, cb: int) -> torch.Tensor:
    """Launch csrc/exl3_gemm.cu: xh (m, k) bf16, words (k/16, K, n/16*8)
    int32 -> (m, n) f32. k and n are multiples of 128, K in 1..8. One device
    kernel a call: k splits as launch_plan sizes them for this card, merged
    in the launch."""
    if not (xh.is_cuda and words.is_cuda and xh.device == words.device):
        raise ValueError("exl3_gemm_kernel: xh and words must be on one CUDA device")
    if xh.dtype != torch.bfloat16 or words.dtype != torch.int32:
        raise TypeError("exl3_gemm_kernel: expected bf16 xh and int32 words")
    if xh.dim() != 2 or words.dim() != 3:
        raise ValueError("exl3_gemm_kernel: expected xh (m, k) and words (k/16, K, n/2)")
    m, k = xh.shape
    tk, kw, ln = words.shape
    n = ln * 2
    if (m < 1 or kw != K or not 1 <= K <= 8 or cb not in (0, 1, 2) or tk * 16 != k
            or k % 128 or n % 128):
        raise ValueError(f"exl3_gemm_kernel: unsupported shapes xh {tuple(xh.shape)}, "
                         f"words {tuple(words.shape)}, K={K}, cb={cb}")
    if not (xh.is_contiguous() and words.is_contiguous()):
        raise ValueError("exl3_gemm_kernel: tensors must be contiguous")
    check_aligned("exl3_gemm_kernel", xh, words)
    splits, _, ws, counters = launch_plan(m, k, n, K, xh.device)
    out = torch.empty((m, n), dtype=torch.float32, device=xh.device)
    err = library().exl3_gemm(
        xh.data_ptr(), words.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, counters.data_ptr(), m, k, n, K, cb, splits,
        torch.cuda.current_stream(xh.device).cuda_stream)
    check_launch("exl3_gemm", err)
    exl3_gemm_kernel.launches += 1
    return out


exl3_gemm_kernel.launches = 0


def exl3_matmul_plain(x, words, suh, svh, K: int, cb: int = CB_3INST, bias=None,
                      out_dtype=None) -> torch.Tensor:
    """The full linear in plain torch: the reconstruct reference on the
    file layout of `words`."""
    return exl3_matmul_ref(x, words_to_trellis(words), suh, svh, K, cb, bias=bias,
                           out_dtype=out_dtype)


def exl3_matmul_fused(x, words, suh, svh, K: int, cb: int = CB_3INST, bias=None,
                      out_dtype=None) -> torch.Tensor:
    """The full linear through the kernel. x (..., k) on the card."""
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    n = words.shape[2] * 2
    x2 = x.reshape(-1, k)
    xh = had_right(x2.float(), scale_pre=suh).to(torch.bfloat16)
    y = had_right(exl3_gemm_kernel(xh, words, K, cb), scale_post=svh)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.reshape(*x.shape[:-1], n).to(out_dtype)


def exl3_matmul(x, words, suh, svh, K: int, cb: int = CB_3INST, bias=None,
                out_dtype=None) -> torch.Tensor:
    """Dispatch. CUDA tensors go through the kernel at any row count; CPU
    tensors through the plain version (decode-sized and prefill-sized inputs
    share its arithmetic: bf16 operands, f32 sums)."""
    fn = exl3_matmul_plain if x.device.type == "cpu" else exl3_matmul_fused
    return fn(x, words, suh, svh, K, cb, bias=bias, out_dtype=out_dtype)
