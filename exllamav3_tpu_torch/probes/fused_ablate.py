"""The trellis GEMM with its stages dropped one at a time (counterpart of
tools/fused_ablate.py::_variant_kernel).

xh (m, k) bf16 times weights made from the trellis words (k/16, K, n/16*8)
int32 of ops/exl3_gemm.py, f32 sums -> (m, n). Variants:
  full     the codes extracted and decoded as the JAX probe decodes them
           (exl3_gemm.py::_decode_codes_f32, 3INST): the two fp16 halves
           repositioned into f32 and added in f32, without decode_scale's
           2^112, then rounded to bf16
  f16pair  the codes decoded by the production kernel's route: the two
           fp16 halves added in fp16, then rounded to bf16
  nomul    extraction, mask and xor, no multiply-add: the 16-bit pattern as
           a number
  extract  extraction only: the 16-bit code as a number
  ingest   no extraction: every word is streamed, and the weights are
           bf16(word 0 ^ word K-1) of the tile rows, repeated
The JAX probe lays a (bk, bn) block's decoded values out in a permuted row
and column order (row rp * bk/16 + tile row, column half * bn/2 + lane), and
ingest repeats its rows another way; the function is x @ W' with W' so
permuted, block by block, and the plain version and the kernel
(csrc/probe_trellis.cu) compute it at any (bk, bn) that are multiples of 128.

    python -m exllamav3_tpu_torch.probes.fused_ablate [--k 4096] [--n 4096] [--K 4] [--m 16]

times every variant on the card, with csrc/exl3_gemm.cu itself and
torch.matmul on the decoded bf16 weight beside them.
"""
from __future__ import annotations

import argparse

import torch

from ..ops.build import check_aligned, check_launch, library
from ..ops.exl3_gemm import exl3_gemm_kernel
from ..util.timing import rotating, time_ms
from . import card, cuda_args, report

VARIANTS = ("ingest", "extract", "nomul", "f16pair", "full")
MASK32 = 0xFFFFFFFF


def codes(words: torch.Tensor, K: int) -> torch.Tensor:
    """(tk, K, L) int32 words -> (tk, 32, L) int64 codes: code t of a lane's
    group is the 16-bit window ending at bit (t+1)K of its K-word stream,
    reaching back into group g-1 of the same tile (group 0 into group 7)."""
    w = words.to(torch.int64) & MASK32
    tk, _, ln = w.shape
    last = w[:, K - 1].reshape(tk, ln // 8, 8)
    prev = torch.roll(last, 1, dims=2).reshape(tk, ln)
    out = []
    for t in range(32):
        end = (t + 1) * K
        wi = (end - 1) // 32
        sh = 32 * (wi + 1) - end
        b = w[:, wi]
        if sh == 0:
            out.append(b & 0xFFFF)
        else:
            a = w[:, wi - 1] if wi > 0 else prev
            out.append(((a << (32 - sh)) | (b >> sh)) & 0xFFFF)
    return torch.stack(out, dim=1)


def _f32_bits(v: torch.Tensor) -> torch.Tensor:
    """Unsigned 32-bit patterns in int64 -> float32 of those bits."""
    return ((v ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.float32)


def _f16_bits(v: torch.Tensor) -> torch.Tensor:
    """Unsigned 16-bit patterns in int64 -> float16 of those bits."""
    return ((v ^ 0x8000) - 0x8000).to(torch.int16).view(torch.float16)


def decode(code: torch.Tensor, variant: str) -> torch.Tensor:
    """int64 codes -> the variant's bf16 weight values."""
    if variant == "extract":
        return code.to(torch.float32).to(torch.bfloat16)
    if variant == "nomul":
        return ((code & 0x8FFF) ^ 0x3B60).to(torch.float32).to(torch.bfloat16)
    x = (code * 89226354 + 64248484) & MASK32
    m = (x & 0x8FFF8FFF) ^ 0x3B603B60
    if variant == "f16pair":
        return (_f16_bits(m & 0xFFFF) + _f16_bits(m >> 16)).to(torch.float32).to(torch.bfloat16)
    if variant != "full":
        raise ValueError(variant)
    lo = ((m << 13) & 0x0FFFE000) | ((m & 0x8000) << 16)
    hi = ((m >> 3) & 0x0FFFE000) | (m & 0x80000000)
    return (_f32_bits(lo) + _f32_bits(hi)).to(torch.bfloat16)


def probe_weight(words: torch.Tensor, K: int, variant: str, bn: int = 256,
                 bk: int = 256) -> torch.Tensor:
    """W' (k, n) bf16: the weight the variant's blocks multiply, in the
    positions of the x columns and output columns it meets."""
    tk, _, ln = words.shape
    bkt, L = bk // 16, bn // 2
    nkb, nnb = tk // bkt, ln // L
    if variant == "ingest":
        s = ((words[:, 0].to(torch.int64) ^ words[:, K - 1].to(torch.int64)) & MASK32)
        s = ((s ^ 0x80000000) - 0x80000000).to(torch.int32).to(torch.float32).to(torch.bfloat16)
        s = s.reshape(nkb, bkt, nnb, L)
        r = torch.arange(16 * bkt, device=words.device)
        w = torch.stack([s[:, (2 * r) % bkt], s[:, (2 * r + 1) % bkt]], dim=3)
        return w.reshape(nkb * 16 * bkt, nnb * 2 * L)
    v = decode(codes(words, K), variant)                       # (tk, 32, ln)
    # t = gl*8 + half*4 + rh*2 + rl sits at row (gl*4 + rh*2 + rl)*bkt + tile
    # row, column half*L + lane of its block
    v = v.reshape(nkb, bkt, 4, 2, 2, 2, nnb, L)               # kk tr gl half rh rl j l
    v = v.permute(0, 2, 4, 5, 1, 6, 3, 7)                     # kk gl rh rl tr j half l
    return v.reshape(nkb * 16 * bkt, nnb * 2 * L)


def fused_ablate_plain(xh: torch.Tensor, words: torch.Tensor, K: int, variant: str,
                       bm: int = 16, bn: int = 256, bk: int = 256) -> torch.Tensor:
    return xh.to(torch.float32) @ probe_weight(words, K, variant, bn, bk).to(torch.float32)


def _split_count(m: int, k: int, n: int) -> int:
    """k splits of the probe's grid: the sizing of the trellis GEMM whose
    staging the probe mirrors (csrc/exl3_gemm.cu's first, single-stage design): about
    264 blocks (two an SM of an H100) at decode sizes, no split without a
    128-wide k step."""
    steps = k // 128
    blocks = (n // 128) * -(-m // 128)
    want = min(steps, max(1, -(-264 // blocks)))
    per = -(-steps // want)
    return -(-steps // per)


def fused_ablate_kernel(xh: torch.Tensor, words: torch.Tensor, K: int, variant: str,
                        bm: int = 16, bn: int = 256, bk: int = 256) -> torch.Tensor:
    """Launch csrc/probe_trellis.cu: xh (m, k) bf16, words (k/16, K, n/2)
    int32; bk and bn multiples of 128 dividing k and n; K in 1..8."""
    cuda_args("fused_ablate_kernel", xh, words)
    m, k = xh.shape
    tk, kw, ln = words.shape
    n = 2 * ln
    if (variant not in VARIANTS or xh.dtype != torch.bfloat16 or words.dtype != torch.int32
            or kw != K or not 1 <= K <= 8 or tk * 16 != k or m < 1 or bk % 128 or bn % 128
            or k % bk or n % bn):
        raise ValueError(f"fused_ablate_kernel: {variant}, xh {tuple(xh.shape)}, words "
                         f"{tuple(words.shape)}, K {K}, bk {bk}, bn {bn}")
    check_aligned("fused_ablate_kernel", xh, words)
    lib = library()
    splits = _split_count(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=xh.device)
    scratch = (torch.empty((splits, m, n), dtype=torch.float32, device=xh.device)
               if splits > 1 else out)
    err = lib.exl3_probe_trellis(
        xh.data_ptr(), words.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, k, n, K,
        VARIANTS.index(variant), bk, bn, splits, torch.cuda.current_stream(xh.device).cuda_stream)
    check_launch("exl3_probe_trellis", err)
    fused_ablate_kernel.launches += 1
    return out


fused_ablate_kernel.launches = 0


def fused_ablate(xh, words, K: int, variant: str, bm: int = 16, bn: int = 256,
                 bk: int = 256) -> torch.Tensor:
    fn = fused_ablate_plain if xh.device.type == "cpu" else fused_ablate_kernel
    return fn(xh, words, K, variant, bm, bn, bk)


def make_inputs(m: int, k: int, n: int, K: int, seed: int, device):
    """xh (m, k) bf16 normal and random trellis words (k/16, K, n/2) int32."""
    g = torch.Generator(device=device).manual_seed(seed)
    words = torch.randint(-2**31, 2**31, (k // 16, K, n // 2), generator=g, device=device,
                          dtype=torch.int64).to(torch.int32)
    xh = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    return xh, words


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--k", type=int, default=4096)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--K", type=int, default=4)
    ap.add_argument("--bm", type=int, default=16)
    ap.add_argument("--bn", type=int, default=256)
    ap.add_argument("--bk", type=int, default=256)
    ap.add_argument("--calls", type=int, default=200, help="timed launches a variant")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = card(args.device)
    library()
    m, k, n, K = args.m, args.k, args.n, args.K
    nbytes = m * k * 2 + k * n * K // 8 + m * n * 4
    nxt = rotating(lambda i: make_inputs(m, k, n, K, i, dev), nbytes)
    print(f"shape m={m} k={k} n={n} K={K}; trellis {k * n * K / 8e6:.1f} MB", flush=True)
    for variant in VARIANTS:
        xh, words = nxt()
        got = fused_ablate_kernel(xh, words, K, variant, args.bm, args.bn, args.bk)
        ref = fused_ablate_plain(xh, words, K, variant, args.bm, args.bn, args.bk)
        rel = float((got - ref).abs().max() / ref.abs().max())
        us = 1e3 * time_ms(lambda: fused_ablate_kernel(*nxt(), K, variant, args.bm, args.bn,
                                                       args.bk), args.calls)
        report(f"{variant:9s} rel err {rel:.1e}", us, nbytes)
    us = 1e3 * time_ms(lambda: exl3_gemm_kernel(*nxt(), K, 0), args.calls)
    report("exl3_gemm (production, 3INST)", us, nbytes)
    xh, words = nxt()
    wd = probe_weight(words, K, "full", args.bn, args.bk)
    nxt_lib = rotating(lambda i: (xh, wd.clone()), m * k * 2 + k * n * 2)
    us = 1e3 * time_ms(lambda: torch.matmul(*nxt_lib()), args.calls)
    report("torch.matmul on the decoded bf16 weight", us, nbytes)


if __name__ == "__main__":
    main()
