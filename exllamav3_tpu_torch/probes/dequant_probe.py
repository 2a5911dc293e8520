"""Quantized-KV dequant at decode shape (counterpart of
tools/dequant_probe.py::_kernel, _kernel_v4 and _kernel_bf16).

Over ctx = pages * 256 keys of Hk heads of D = 128 channels, each head's
q rows (G of them) are scored against every key and the scores summed:
out[h, g] = sum over keys t of q[h, g] . k[t, h]. The keys are
  * per head (`_kernel`): packed words kq (pages, 256, Hk, D*bits/32) int32
    with bf16 scales ks (pages, 256, Hk, D/32), in the TPU layout's lane
    order: lane p takes field p // gw of word p % gw (gw = D*bits/32) and the
    scale of group (p % gw) // bits. Variants:
      v0        (field - (N-1)/2) * scale                     f32 product
      v1        fma(2^23 + field, scale, scale * c), c = f32((1-N)/2 - 2^23),
                one rounding, as XLA contracts the tool's
                multiply-add                                  f32 product
      v2        v1 rounded to bf16                            bf16 product
      v3        16-bit lanes: field p // (2gw) of halfword p % (2gw),
                bf16((field - (N-1)/2) * scale)               bf16 product
      a_rep     the word as a number times the scale          f32 product
      a_static  field 1 of every lane: (((word >> 4) & (N-1)) - (N-1)/2) * scale
      a_noscale the field as a number
      a_nodeq   the word as a number
    -> (1, Hk, G, 1);
  * merged (`_kernel_v4`): words (pages, 256, Hk*gw), scales (pages, 256,
    Hk*g), q (Hk*G, Hk*D) over all Hk*D lanes: lane p takes word p % (Hk*gw),
    field (p % D) // gw and scale (p // D)*g + ((p % D) % gw) // bits; v4 is
    v0's dequant, v5 v1's -> (Hk*G, 1);
  * bf16 (`_kernel_bf16`): dense bf16 K (pages, 256, Hk, D) -> (1, Hk, G, 1).
v1, v2 and v5 do not compute v0's function: c rounds -(2^23 + (N-1)/2) to an
even integer, half a unit off, and scale * c rounds again, so a key lands
up to 1.5 scale steps from v0's (half a step low on average). The kernel (csrc/probe_kv_dequant.cu) follows
csrc/attention_tiles.cuh's quantized tile loop: one block per head (per D
lanes, merged), 64-key tiles unpacked into bf16 hi + lo tiles in shared
memory, q as hi + lo, MMAs with f32 sums.

    python -m exllamav3_tpu_torch.probes.dequant_probe [--ctx 16384] [--bits 4] [--hk 8]

times every variant on the card (the tool's own list: bf16, v0, v4, v5).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.build import check_aligned, check_launch, library
from ..util.timing import rotating, time_ms
from . import card, cuda_args, report

PAGE = 256
PER_HEAD = ("v0", "v1", "v2", "v3", "a_rep", "a_static", "a_noscale", "a_nodeq")
MERGED = ("v4", "v5")
VARIANTS = PER_HEAD + MERGED + ("bf16",)
BF16_DOT = ("v2", "v3")


def magic_offset(bits: int) -> float:
    """c of v1: (1 - N) / 2 - 2^23 rounded to f32."""
    return float(np.float32((1 - (1 << bits)) / 2 - 8388608.0))


def _lanes(lanes: int, D: int, bits: int, words_per_row: int, merged: bool, device):
    """(word index, shift, scale index) of every lane."""
    p = torch.arange(lanes, device=device)
    gw, g = D * bits // 32, D // 32
    c = p % D
    sidx = (c % gw) // bits + ((p // D) * g if merged else 0)
    return p % words_per_row, (c // gw) * bits, sidx


def dequant(words: torch.Tensor, scales: torch.Tensor, variant: str, bits: int, D: int,
            Hk: int = 1) -> torch.Tensor:
    """words (T, W) int32 and scales (T, S) bf16 of one head (or all heads,
    merged) -> the variant's keys (T, lanes): f32, bf16 for v2 and v3."""
    N = 1 << bits
    off = np.float32((1 - N) / 2)
    merged = variant in MERGED
    lanes = Hk * D if merged else D
    widx, sh, sidx = _lanes(lanes, D, bits, words.shape[-1], merged, words.device)
    u = words.to(torch.int64) & 0xFFFFFFFF
    wide = u[:, widx]
    se = scales.to(torch.float32)[:, sidx]
    if variant == "v3":
        half = (u[:, (torch.arange(D, device=u.device) % (2 * words.shape[-1])) // 2]
                >> (16 * (torch.arange(D, device=u.device) % 2))) & 0xFFFF
        f = (half >> ((torch.arange(D, device=u.device) // (2 * words.shape[-1])) * bits)) & (N - 1)
        return (f.to(torch.bfloat16) + torch.tensor(float(off), dtype=torch.bfloat16)) \
            * se.to(torch.bfloat16)
    if variant in ("a_rep", "a_nodeq"):
        k = ((wide ^ 0x80000000) - 0x80000000).to(torch.int32).to(torch.float32)
        return k * se if variant == "a_rep" else k
    f = (wide >> (4 if variant == "a_static" else sh)) & (N - 1)
    if variant == "a_noscale":
        return f.to(torch.float32)
    if variant in ("v1", "v2", "v5"):
        xf = (f | 0x4B000000).to(torch.int32).view(torch.float32)
        cse = se * torch.tensor(magic_offset(bits), dtype=torch.float32)
        # one fused multiply-add, one rounding: the f64 sum is exact
        k = (xf.to(torch.float64) * se.to(torch.float64) + cse.to(torch.float64)).to(torch.float32)
        return k.to(torch.bfloat16) if variant == "v2" else k
    if variant not in ("v0", "v4", "a_static"):
        raise ValueError(variant)
    return (f.to(torch.float32) + torch.tensor(off)) * se


def dequant_probe_plain(q: torch.Tensor, kq: torch.Tensor, ks, variant: str,
                        bits: int = 4) -> torch.Tensor:
    """Per head: q (1, Hk, G, D) f32, kq (pages, 256, Hk, gw) int32 (bf16
    (pages, 256, Hk, D) for bf16), ks (pages, 256, Hk, g) bf16 (None for
    bf16) -> (1, Hk, G, 1). Merged: q (Hk*G, Hk*D), kq (pages, 256, Hk*gw),
    ks (pages, 256, Hk*g) -> (Hk*G, 1)."""
    if variant in MERGED:
        HkG, lanes = q.shape
        T = kq.shape[0] * kq.shape[1]
        D = 128
        k = dequant(kq.reshape(T, -1), ks.reshape(T, -1), variant, bits, D, lanes // D)
        return (q.to(torch.float32) @ k.T).sum(dim=1, keepdim=True)
    _, Hk, G, D = q.shape
    qf = q[0].to(torch.bfloat16 if variant in BF16_DOT else torch.float32)
    out = []
    for h in range(Hk):
        if variant == "bf16":
            k = kq[:, :, h].reshape(-1, D).to(torch.float32)
        else:
            T = kq.shape[0] * kq.shape[1]
            k = dequant(kq[:, :, h].reshape(T, -1), ks[:, :, h].reshape(T, -1), variant, bits, D)
        out.append((qf[h].to(torch.float32) @ k.to(qf.dtype).to(torch.float32).T).sum(dim=1))
    return torch.stack(out)[None, :, :, None]


def dequant_probe_kernel(q: torch.Tensor, kq: torch.Tensor, ks, variant: str,
                         bits: int = 4) -> torch.Tensor:
    """Launch csrc/probe_kv_dequant.cu: the shapes of dequant_probe_plain,
    D = 128, G <= 16 (merged: Hk*G <= 64), bits in (2, 4, 8)."""
    tensors = (q, kq) if variant == "bf16" else (q, kq, ks)
    cuda_args("dequant_probe_kernel", *tensors)
    merged = variant in MERGED
    if variant not in VARIANTS or bits not in (2, 4, 8) or q.dtype != torch.float32:
        raise ValueError(f"dequant_probe_kernel: variant {variant}, bits {bits}, q {q.dtype}")
    if merged:
        rows, lanes = q.shape
        Hk = lanes // 128
        G = rows // Hk
        want = (kq.shape[0], PAGE, Hk * 4 * bits)
    else:
        _, Hk, G, D = q.shape
        rows = G
        want = (kq.shape[0], PAGE, Hk, 128 if variant == "bf16" else 4 * bits)
    kdt = torch.bfloat16 if variant == "bf16" else torch.int32
    if (tuple(kq.shape) != want or kq.dtype != kdt or not 1 <= rows <= (64 if merged else 16)
            or (not merged and D != 128)
            or (variant != "bf16" and (ks.dtype != torch.bfloat16
                                       or tuple(ks.shape) != want[:-1] + (want[-1] // bits,)))):
        raise ValueError(f"dequant_probe_kernel: {variant}: q {tuple(q.shape)}, kq "
                         f"{tuple(kq.shape)} {kq.dtype}")
    check_aligned("dequant_probe_kernel", *tensors)
    lib = library()
    T = kq.shape[0] * PAGE
    out = torch.empty((rows * Hk if not merged else rows,), dtype=torch.float32, device=q.device)
    ws = torch.empty((Hk, rows), dtype=torch.float32, device=q.device) if merged else out
    err = lib.exl3_probe_kv_dequant(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr() if ks is not None else None, out.data_ptr(),
        ws.data_ptr(), T, Hk, G, bits, VARIANTS.index(variant),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("exl3_probe_kv_dequant", err)
    dequant_probe_kernel.launches += 1
    return out.reshape(rows, 1) if merged else out.reshape(1, Hk, G, 1)


dequant_probe_kernel.launches = 0


def dequant_probe(q, kq, ks, variant: str, bits: int = 4) -> torch.Tensor:
    fn = dequant_probe_plain if q.device.type == "cpu" else dequant_probe_kernel
    return fn(q, kq, ks, variant, bits)


def make_inputs(variant: str, ctx: int, bits: int, Hk: int, seed: int, device, G: int = 4,
                D: int = 128):
    """The tool's inputs for one variant: q, kq, ks (None for bf16)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pages, g = ctx // PAGE, D // 32
    if variant == "bf16":
        q = torch.randn((1, Hk, G, D), generator=gen, device=device)
        k = torch.randn((pages, PAGE, Hk, D), generator=gen, device=device).to(torch.bfloat16)
        return q, k, None
    lead = (pages, PAGE, Hk * g * bits) if variant in MERGED else (pages, PAGE, Hk, g * bits)
    kq = torch.randint(-2**31, 2**31, lead, generator=gen, device=device,
                       dtype=torch.int64).to(torch.int32)
    ks = (torch.rand(lead[:-1] + (lead[-1] // bits,), generator=gen, device=device)
          + 0.5).to(torch.bfloat16)
    q = (torch.randn((Hk * G, Hk * D), generator=gen, device=device) if variant in MERGED
         else torch.randn((1, Hk, G, D), generator=gen, device=device))
    return q, kq, ks


def input_bytes(variant: str, ctx: int, bits: int, Hk: int, G: int = 4, D: int = 128) -> int:
    """Bytes read and written once: q, the keys (words and scales, or bf16), out."""
    if variant == "bf16":
        return Hk * G * D * 4 + ctx * Hk * D * 2 + Hk * G * 4
    qb = (Hk * G) * (Hk * D) * 4 if variant in MERGED else Hk * G * D * 4
    return qb + ctx * Hk * (D * bits // 8 + D // 32 * 2) + Hk * G * 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ctx", type=int, default=16384)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--hk", type=int, default=8)
    ap.add_argument("--calls", type=int, default=20, help="timed launches a variant")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = card(args.device)
    library()
    for variant in VARIANTS:
        nb = input_bytes(variant, args.ctx, args.bits, args.hk)
        nxt = rotating(lambda i: make_inputs(variant, args.ctx, args.bits, args.hk, i, dev), nb)
        inputs = nxt()
        got = dequant_probe_kernel(*inputs, variant, args.bits)
        ref = dequant_probe_plain(*inputs, variant, args.bits)
        rel = float((got - ref).abs().max() / ref.abs().max())
        us = 1e3 * time_ms(lambda: dequant_probe_kernel(*nxt(), variant, args.bits), args.calls)
        report(f"{variant:>9} ctx={args.ctx} bits={args.bits} Hk={args.hk} rel err {rel:.1e}",
               us, nb)


if __name__ == "__main__":
    main()
