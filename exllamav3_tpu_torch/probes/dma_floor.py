"""The streaming floor: how fast the card reads an int8 weight from device
memory (counterpart of tools/dma_floor.py::kern).

The function: b (kh, n) int8 -> (16, n) f32, per column the sum over the
bkh-row blocks of each block's first 16 rows. Every byte of b is read; only
those rows reach the output. bn is the TPU tool's column block, which the
function does not depend on.

    python -m exllamav3_tpu_torch.probes.dma_floor [--kh 2048]

prints the time of each of the tool's three (bn, bkh) geometries and the rate
reached as a share of 3.35 TB/s.
"""
from __future__ import annotations

import argparse

import torch

from ..ops.build import check_aligned, check_launch, library
from ..util.timing import HBM_BYTES_PER_S, rotating, time_ms
from . import card, cuda_args, report

GEOMETRIES = ((512, 512), (1024, 512), (2048, 1024))  # (bn, bkh)
BLOCK_COLS = 512   # columns a block of csrc/probe_dma.cu covers
CHUNK_ROWS = 64    # rows a streaming block reads


def dma_floor_plain(b: torch.Tensor, bn: int = 512, bkh: int = 512) -> torch.Tensor:
    kh, n = b.shape
    return b.reshape(kh // bkh, bkh, n)[:, :16].to(torch.float32).sum(dim=0)


def dma_floor_kernel(b: torch.Tensor, bn: int = 512, bkh: int = 512) -> torch.Tensor:
    """Launch csrc/probe_dma.cu: b (kh, n) int8 with kh % bkh == 0,
    bkh % 64 == 0 and n % 512 == 0."""
    cuda_args("dma_floor_kernel", b)
    kh, n = b.shape
    if b.dtype != torch.int8 or kh % bkh or bkh % CHUNK_ROWS or n % BLOCK_COLS:
        raise ValueError(f"dma_floor_kernel: b {tuple(b.shape)} {b.dtype}, bkh {bkh}")
    check_aligned("dma_floor_kernel", b)
    lib = library()
    out = torch.empty((16, n), dtype=torch.float32, device=b.device)
    sink = torch.empty((n // BLOCK_COLS * (4 + kh // CHUNK_ROWS) * 8,), dtype=torch.int32,
                       device=b.device)
    err = lib.exl3_probe_dma(b.data_ptr(), out.data_ptr(), sink.data_ptr(), kh, n, bkh,
                             torch.cuda.current_stream(b.device).cuda_stream)
    check_launch("exl3_probe_dma", err)
    dma_floor_kernel.launches += 1
    return out


dma_floor_kernel.launches = 0


def dma_floor(b: torch.Tensor, bn: int = 512, bkh: int = 512) -> torch.Tensor:
    fn = dma_floor_plain if b.device.type == "cpu" else dma_floor_kernel
    return fn(b, bn, bkh)


def make_input(kh: int, n: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-128, 128, (kh, n), generator=g, device=device,
                         dtype=torch.int16).to(torch.int8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kh", type=int, default=2048, help="rows of the weight (the tool's 2048)")
    ap.add_argument("--calls", type=int, default=200, help="timed launches a geometry")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = card(args.device)
    library()
    kh, n = args.kh, 4096
    nbytes = kh * n + 16 * n * 4
    nxt = rotating(lambda i: make_input(kh, n, i, dev), nbytes)
    for bn, bkh in GEOMETRIES:
        b = nxt()
        if not torch.equal(dma_floor_kernel(b, bn, bkh), dma_floor_plain(b, bn, bkh)):
            raise AssertionError(f"dma_floor bn={bn} bkh={bkh}: kernel differs from plain")
        us = 1e3 * time_ms(lambda: dma_floor_kernel(nxt(), bn, bkh), args.calls)
        report(f"bn={bn} bkh={bkh} kh={kh} n={n}", us, nbytes)
        print(f"  reached {nbytes / us * 1e-3:.1f} GB/s = "
              f"{100.0 * nbytes / (us * 1e-6) / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s", flush=True)


if __name__ == "__main__":
    main()
