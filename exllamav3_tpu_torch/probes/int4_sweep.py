"""int4 kernel bodies, one unpack strategy each (counterpart of
tools/int4_sweep.py::make_kernel).

x (m, k) bf16, packed (k/2, n) int8 (weight row r in the low nibble of byte
row r, row r + k/2 in the high nibble, both biased by +8), scales (k/32, n)
bf16 -> (m, n) f32 = x @ W with W a bf16 product of a code and its scale:
  i32             codes widened to int32, centred: bf16((c - 8) * s)
  bitcast         the four nibbles of a 32-bit word masked at once, then
                  centred: the same function as i32
  bitcast_mxufix  uncentred bf16(c * s), the -8 folded into a correction
                  -8 * (group sums of x) @ s on the tensor cores
  xor_center      bf16((c ^ 8) * s): a timing probe, not the weight
The TPU tool sweeps four (bm, bn, bkh) block geometries, which change only
the order of the f32 sums; the kernel (csrc/probe_int4.cu) keeps
csrc/packed_matmul.cuh's tiling and split of k whatever the geometry.

    python -m exllamav3_tpu_torch.probes.int4_sweep

times every variant on the card at m = 16, k = n = 4096, with torch.matmul on
the decoded bf16 weight beside them.
"""
from __future__ import annotations

import argparse

import torch

from ..ops.build import check_aligned, check_launch, library
from ..ops.q_matmul import _packed_splits, int4_matmul_plain, int4_pack, int4_unpack
from ..util.timing import rotating, time_ms
from . import card, cuda_args, report

VARIANTS = ("i32", "bitcast", "bitcast_mxufix", "xor_center")
GEOMETRIES = ((256, 512, 512), (256, 1024, 512), (256, 2048, 512), (256, 1024, 1024))
GROUP = 32


def int4_sweep_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, variant: str,
                     bm: int = 256, bn: int = 512, bkh: int = 512) -> torch.Tensor:
    kh, n = packed.shape
    m = x.shape[0]
    b = packed.to(torch.int32) & 255
    s = scales.reshape(2, kh // GROUP, n)
    xb = x.to(torch.bfloat16).to(torch.float32)
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for plane, c in enumerate((b & 15, b >> 4)):
        if variant in ("i32", "bitcast"):
            c = c - 8
        elif variant == "xor_center":
            c = c ^ 8
        elif variant != "bitcast_mxufix":
            raise ValueError(variant)
        w = c.to(torch.bfloat16) * s[plane].repeat_interleave(GROUP, dim=0)
        y = y + xb[:, plane * kh:(plane + 1) * kh] @ w.to(torch.float32)
    if variant == "bitcast_mxufix":
        corr = sum(xb[:, plane * kh:(plane + 1) * kh].reshape(m, kh // GROUP, GROUP).sum(-1)
                   @ s[plane].to(torch.float32) for plane in (0, 1))
        y = y + -8.0 * corr
    return y


def int4_sweep_kernel(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, variant: str,
                      bm: int = 256, bn: int = 512, bkh: int = 512) -> torch.Tensor:
    """Launch csrc/probe_int4.cu's sweep kernel: x (m, k) bf16 with
    m <= 16, packed (k/2, n) int8, scales (k/32, n) bf16; k % 64 == 0,
    n % 256 == 0."""
    cuda_args("int4_sweep_kernel", x, packed, scales)
    m, k = x.shape
    kh, n = packed.shape
    if (variant not in VARIANTS or x.dtype != torch.bfloat16 or packed.dtype != torch.int8
            or scales.dtype != torch.bfloat16 or not 1 <= m <= 16 or k != 2 * kh or k % 64
            or n % 256 or tuple(scales.shape) != (k // GROUP, n)):
        raise ValueError(f"int4_sweep_kernel: {variant}, x {tuple(x.shape)} {x.dtype}, packed "
                         f"{tuple(packed.shape)}, scales {tuple(scales.shape)}")
    check_aligned("int4_sweep_kernel", x, packed, scales)
    lib = library()
    splits = _packed_splits(m, n, kh // 32, True, x.device)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else y
    err = lib.exl3_probe_int4_sweep(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(), ws.data_ptr(), m, k, n,
        VARIANTS.index(variant), splits, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("exl3_probe_int4_sweep", err)
    int4_sweep_kernel.launches += 1
    return y


int4_sweep_kernel.launches = 0


def int4_sweep(x, packed, scales, variant: str, bm: int = 256, bn: int = 512,
               bkh: int = 512) -> torch.Tensor:
    fn = int4_sweep_plain if x.device.type == "cpu" else int4_sweep_kernel
    return fn(x, packed, scales, variant, bm, bn, bkh)


def make_inputs(m: int, k: int, n: int, seed: int, device):
    """x (m, k) bf16 and a packed 0.02-normal (k, n) weight, as the tool makes them."""
    g = torch.Generator(device=device).manual_seed(seed)
    packed, scales = int4_pack(torch.randn((k, n), generator=g, device=device) * 0.02)
    x = torch.randn((m, k), generator=g, device=device).to(torch.bfloat16)
    return x, packed, scales


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200, help="timed launches a variant")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = card(args.device)
    library()
    m, k, n = 16, 4096, 4096
    nbytes = m * k * 2 + k // 2 * n + k // GROUP * n * 2 + m * n * 4
    nxt = rotating(lambda i: make_inputs(m, k, n, i, dev), nbytes)
    x, packed, scales = nxt()
    ref = int4_matmul_plain(x, packed, scales)
    for variant in VARIANTS:
        got = int4_sweep_kernel(x, packed, scales, variant)
        rel = float((got - ref).abs().max() / ref.abs().max())
        us = 1e3 * time_ms(lambda: int4_sweep_kernel(*nxt(), variant), args.calls)
        report(f"m={m} {variant:15s} rel err to the int4 product {rel:.1e}", us, nbytes)
    wd = int4_unpack(packed, scales).to(torch.bfloat16)
    nxt_lib = rotating(lambda i: (x, wd.clone()), m * k * 2 + k * n * 2)
    us = 1e3 * time_ms(lambda: torch.matmul(*nxt_lib()), args.calls)
    report(f"m={m} torch.matmul on the decoded bf16 weight", us, nbytes)


if __name__ == "__main__":
    main()
