"""W4A8 decode over block-diagonally expanded activations (counterpart of
tools/a8_diag_proto.py::_diag_kernel).

Per k-block of bkh packed rows, row (g, mi) of the expanded activations
holds row mi of int8 x masked to group g's 32 columns, so one int8 product
of the k-block keeps each group's partial sums apart by row: d (ng * m, n)
in exact int32. The group scales and the -8 code bias then apply once per
output element, (d - 8 * rowsum(x)) * scale, summed over the groups. With
raw_dot the packed bytes enter the product as they are (their top bit
flipped, as the tool's stand-in for a pack change), and the low-nibble
product follows as raw - 16 * high + 128 * rowsum: the same integers.

    python -m exllamav3_tpu_torch.probes.a8_diag_proto [m] [calls]
    python -m exllamav3_tpu_torch.probes.a8_diag_proto sweep

time both forms at bn = bkh = 512 (or the sweep's four (bn, bkh)) on the card,
k = n = 4096. The kernel (csrc/probe_int4.cu) keeps
csrc/packed_matmul.cuh's lane layout and split of k; bn changes nothing there.
"""
from __future__ import annotations

import sys

import torch

from ..ops.build import check_aligned, check_launch, library
from ..ops.q_matmul import _packed_splits, int4_matmul_plain, int4_pack
from ..util.timing import rotating, time_ms
from . import card, cuda_args, report

SWEEP = ((512, 2048), (1024, 2048), (2048, 2048), (256, 2048))  # (bn, bkh)


def expand(xp: torch.Tensor, bkh: int, group: int = 32) -> torch.Tensor:
    """(m, kh) int8 -> (kh / bkh, ng * m, bkh): row (g, mi) of block kk holds
    x[mi, kk*bkh + g*group : +group] at columns g*group.., zeros elsewhere."""
    m, kh = xp.shape
    nkb, ng = kh // bkh, bkh // group
    xr = xp.reshape(m, nkb, ng, group).permute(2, 1, 0, 3)        # (ng, nkb, m, group)
    out = torch.zeros((nkb, ng, m, ng, group), dtype=xp.dtype, device=xp.device)
    idx = torch.arange(ng, device=xp.device)
    out[:, idx, :, idx, :] = xr
    return out.reshape(nkb, ng * m, bkh)


def a8_diag_plain(x_lo: torch.Tensor, x_hi: torch.Tensor, packed: torch.Tensor,
                  scales: torch.Tensor, m: int, raw_dot: bool = False) -> torch.Tensor:
    """The kernel's function on its inputs: expanded x_lo / x_hi, packed
    (top bit flipped where raw_dot), scales (k/32, n) -> (m, n) f32."""
    nkb, gm, bkh = x_lo.shape
    kh, n = packed.shape
    ng = gm // m
    blocks = packed.reshape(nkb, bkh, n)
    u = blocks.to(torch.int64) & 255
    xl, xh = x_lo.to(torch.float64), x_hi.to(torch.float64)
    xsum_lo, xsum_hi = xl.sum(-1, keepdim=True), xh.sum(-1, keepdim=True)
    if raw_dot:
        wh = (((u ^ 128) >> 4)).to(torch.float64)
        d_lo = xl @ blocks.to(torch.float64) - 16 * (xl @ wh) + 128 * xsum_lo
        d_hi = xh @ wh
    else:
        d_lo = xl @ (u & 15).to(torch.float64)
        d_hi = xh @ (u >> 4).to(torch.float64)
    s = scales.to(torch.float32).reshape(2, nkb, ng, 1, n)
    fl = (d_lo - 8 * xsum_lo).to(torch.float32).reshape(nkb, ng, m, n)
    fh = (d_hi - 8 * xsum_hi).to(torch.float32).reshape(nkb, ng, m, n)
    return ((fl * s[0]).sum(1) + (fh * s[1]).sum(1)).sum(0)


def a8_diag_kernel(x_lo: torch.Tensor, x_hi: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor, m: int, raw_dot: bool = False) -> torch.Tensor:
    """Launch csrc/probe_int4.cu's diag kernel: x_lo, x_hi (nkb, ng*m, bkh)
    int8 with ng * m in {16, 32, 64} and m in {1, 2, 4}; packed (nkb*bkh, n)
    int8 with n % 256 == 0; scales (2*nkb*ng, n) bf16."""
    cuda_args("a8_diag_kernel", x_lo, x_hi, packed, scales)
    nkb, gm, bkh = x_lo.shape
    kh, n = packed.shape
    ng = bkh // 32
    if (x_lo.dtype != torch.int8 or x_hi.shape != x_lo.shape or packed.dtype != torch.int8
            or scales.dtype != torch.bfloat16 or m not in (1, 2, 4) or gm != ng * m
            or gm not in (16, 32, 64) or kh != nkb * bkh or n % 256
            or tuple(scales.shape) != (2 * kh // 32, n)):
        raise ValueError(f"a8_diag_kernel: x {tuple(x_lo.shape)}, packed {tuple(packed.shape)}, "
                         f"scales {tuple(scales.shape)}, m {m}")
    check_aligned("a8_diag_kernel", x_lo, x_hi, packed, scales)
    lib = library()
    splits = _packed_splits(m, n, kh // 32, True, packed.device)
    y = torch.empty((m, n), dtype=torch.float32, device=packed.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=packed.device) if splits > 1 else y
    err = lib.exl3_probe_a8_diag(
        x_lo.data_ptr(), x_hi.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(),
        ws.data_ptr(), m, kh, n, bkh, int(raw_dot), splits,
        torch.cuda.current_stream(packed.device).cuda_stream)
    check_launch("exl3_probe_a8_diag", err)
    a8_diag_kernel.launches += 1
    return y


a8_diag_kernel.launches = 0


def diag_inputs(x_q: torch.Tensor, packed: torch.Tensor, block_kh: int, raw_dot: bool,
                group: int = 32):
    """What the tool hands its kernel: the two expanded planes and the packed
    bytes, their top bit flipped for raw_dot."""
    kh = packed.shape[0]
    block_kh = min(block_kh, kh)
    if raw_dot:
        packed = packed ^ torch.tensor(-128, dtype=torch.int8, device=packed.device)
    return expand(x_q[:, :kh], block_kh, group), expand(x_q[:, kh:], block_kh, group), packed


def int4_a8_diag(x_q: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, group: int = 32,
                 block_n: int = 512, block_kh: int = 512, raw_dot: bool = False) -> torch.Tensor:
    """x_q (m, k) int8, packed (k/2, n) int8, scales (k/group, n) bf16 ->
    (m, n) f32 (the x row scales left out), as the tool's int4_a8_diag."""
    x_lo, x_hi, packed = diag_inputs(x_q, packed, block_kh, raw_dot, group)
    fn = a8_diag_plain if packed.device.type == "cpu" else a8_diag_kernel
    return fn(x_lo, x_hi, packed, scales, x_q.shape[0], raw_dot)


def make_inputs(m: int, k: int, n: int, seed: int, device):
    g = torch.Generator(device=device).manual_seed(seed)
    packed, scales = int4_pack(torch.randn((k, n), generator=g, device=device) * 0.02)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device,
                       dtype=torch.int16).to(torch.int8)
    return xq, packed, scales


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    sweep = bool(argv) and argv[0] == "sweep"
    m = 1 if sweep or not argv else int(argv[0])
    calls = int(argv[1]) if len(argv) > 1 and not sweep else 500
    dev = card("cuda")
    library()
    k = n = 4096
    nbytes = k // 2 * n + k // 32 * n * 2 + m * k + m * n * 4
    xq, packed, scales = make_inputs(m, k, n, 0, dev)
    ref = int4_matmul_plain(xq.to(torch.float32), packed, scales)

    def kernel_args(i, bkh, rd):
        xq, packed, scales = make_inputs(m, k, n, i, dev)
        return (*diag_inputs(xq, packed, bkh, rd), scales)

    for bn, bkh in (SWEEP if sweep else ((512, 512),)):
        for rd in (False, True):
            got = int4_a8_diag(xq, packed, scales, block_n=bn, block_kh=bkh, raw_dot=rd)
            rel = float((got - ref).abs().max() / ref.abs().max())
            nxt = rotating(lambda i: kernel_args(i, bkh, rd), nbytes)
            us = 1e3 * time_ms(lambda: a8_diag_kernel(*nxt(), m, rd), calls)
            report(f"m={m} bn={bn} bkh={bkh} raw={rd} rel err {rel:.1e}", us, nbytes)


if __name__ == "__main__":
    main()
