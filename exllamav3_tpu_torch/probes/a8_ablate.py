"""The int4-a8 kernel body stage by stage (counterpart of
tools/a8_ablate.py::make).

Inputs as the tool makes them: xl (kh/512, 16, 512) int8, 16 rows of int8
activations for each 512-row block of the packed weight; packed (kh, n)
int8, the int4 tier's bytes; scales3 (kh/32, 1, n) bf16. Each stage returns
(1, n) f32, summed over the bkh-row blocks (bkh = 512, the width of xl):
  dotpar, dot   the int8 product xl[kk] @ block kk, summed over its 16 rows;
                dotpar is the same function with the blocks as parallel
                splits (one per block), dot with csrc/packed_matmul.cuh's
                split of k
  dotbf         the same product in bf16 with f32 sums
  convonly      the bytes converted to bf16; the block's first row is summed
  dot2          the int8 product with the raw bytes plus the product with the
                high nibbles ((byte ^ 0x80) >> 4)
  extract       the high nibbles extracted; the block's first row is summed
  fix           the int8 product, row r of block kk times scale row
                kk * 16 + r, summed over the rows

    python -m exllamav3_tpu_torch.probes.a8_ablate

times every stage on the card (k = n = 4096, kh = 2048).
"""
from __future__ import annotations

import argparse

import torch

from ..ops.build import check_aligned, check_launch, library
from ..ops.q_matmul import _packed_splits, int4_pack
from ..util.timing import rotating, time_ms
from . import card, cuda_args, report

STAGES = ("dotpar", "dot", "dotbf", "convonly", "dot2", "extract", "fix")
EXACT = ("dotpar", "dot", "dot2", "extract", "convonly")  # integer sums below 2^24


def high_nibbles(b: torch.Tensor) -> torch.Tensor:
    """((byte ^ 0x80) >> 4) of each byte, as int32 in [0, 15]."""
    return ((b.to(torch.int32) & 255) ^ 128) >> 4


def a8_ablate_plain(xl: torch.Tensor, packed: torch.Tensor, scales3: torch.Tensor, stage: str,
                    bn: int = 512, bkh: int = 512) -> torch.Tensor:
    kh, n = packed.shape
    nkb = kh // bkh
    blocks = packed.reshape(nkb, bkh, n)
    if stage in ("convonly", "extract"):
        first = blocks[:, 0]
        v = first.to(torch.float32) if stage == "convonly" else high_nibbles(first).to(torch.float32)
        return v.sum(dim=0, keepdim=True)
    if stage not in STAGES:
        raise ValueError(stage)
    w = blocks.to(torch.float64)
    if stage == "dot2":
        w = w + high_nibbles(blocks).to(torch.float64)
    d = (xl.to(torch.float64) @ w).to(torch.float32)   # exact integers
    if stage == "fix":
        d = d * scales3[:, 0].to(torch.float32).reshape(nkb, bkh // 32, n)
    return d.sum(dim=1).sum(dim=0, keepdim=True)


def a8_ablate_kernel(xl: torch.Tensor, packed: torch.Tensor, scales3: torch.Tensor, stage: str,
                     bn: int = 512, bkh: int = 512) -> torch.Tensor:
    """Launch csrc/probe_int4.cu's stage kernel: xl (kh/512, 16, 512) int8,
    packed (kh, n) int8 with n % 256 == 0, scales3 (kh/32, 1, n) bf16."""
    cuda_args("a8_ablate_kernel", xl, packed, scales3)
    kh, n = packed.shape
    if (stage not in STAGES or xl.dtype != torch.int8 or packed.dtype != torch.int8
            or scales3.dtype != torch.bfloat16 or bkh != 512 or kh % bkh or n % 256
            or tuple(xl.shape) != (kh // bkh, 16, bkh) or tuple(scales3.shape) != (kh // 32, 1, n)):
        raise ValueError(f"a8_ablate_kernel: stage {stage}, xl {tuple(xl.shape)}, packed "
                         f"{tuple(packed.shape)}, scales3 {tuple(scales3.shape)}, bkh {bkh}")
    check_aligned("a8_ablate_kernel", xl, packed, scales3)
    lib = library()
    steps = kh // 32
    splits = kh // bkh if stage == "dotpar" else _packed_splits(16, n, steps, True, packed.device)
    out = torch.empty((1, n), dtype=torch.float32, device=packed.device)
    ws = torch.empty((splits, 1, n), dtype=torch.float32, device=packed.device) if splits > 1 else out
    sink = torch.empty((n // 64 * splits,), dtype=torch.int32, device=packed.device)
    err = lib.exl3_probe_a8_ablate(
        xl.data_ptr(), packed.data_ptr(), scales3.data_ptr(), out.data_ptr(), ws.data_ptr(),
        sink.data_ptr(), kh, n, bkh, STAGES.index(stage), splits,
        torch.cuda.current_stream(packed.device).cuda_stream)
    check_launch("exl3_probe_a8_ablate", err)
    a8_ablate_kernel.launches += 1
    return out


a8_ablate_kernel.launches = 0


def a8_ablate(xl, packed, scales3, stage: str, bn: int = 512, bkh: int = 512) -> torch.Tensor:
    fn = a8_ablate_plain if packed.device.type == "cpu" else a8_ablate_kernel
    return fn(xl, packed, scales3, stage, bn, bkh)


def make_inputs(k: int, n: int, seed: int, device):
    """The tool's inputs: a packed 0.02-normal weight, its first kh/32 scale
    rows, and int8 activations in [-127, 127]."""
    g = torch.Generator(device=device).manual_seed(seed)
    kh = k // 2
    w = torch.randn((k, n), generator=g, device=device) * 0.02
    packed, scales = int4_pack(w)
    xl = torch.randint(-127, 128, (kh // 512, 16, 512), generator=g, device=device,
                       dtype=torch.int16).to(torch.int8)
    return xl, packed, scales[: kh // 32, None, :].contiguous()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200, help="timed launches a stage")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = card(args.device)
    library()
    k = n = 4096
    kh = k // 2
    nbytes = kh * n + kh // 32 * n * 2 + kh * 16 + n * 4
    nxt = rotating(lambda i: make_inputs(k, n, i, dev), nbytes)
    for stage in STAGES:
        xl, packed, s3 = nxt()
        got, ref = a8_ablate_kernel(xl, packed, s3, stage), a8_ablate_plain(xl, packed, s3, stage)
        rel = float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
        us = 1e3 * time_ms(lambda: a8_ablate_kernel(*nxt(), stage), args.calls)
        report(f"{stage:9s} rel err {rel:.1e}", us, nbytes)


if __name__ == "__main__":
    main()
