"""Measurement probes for the H100: counterparts of the JAX package's probe
tools under tools/ (fused_ablate.py, dequant_probe.py, int4_sweep.py,
a8_ablate.py, a8_diag_proto.py, dma_floor.py), one module each with the
tool's name.

Each probe splits one of the port's production kernels into stages: every
variant computes its JAX kernel's function, and its hand-written kernel
(csrc/probe_*.cu) lays its work out as the production kernel does, so that
the variants' times split that kernel's time on the card. A module holds
  * a plain PyTorch function per variant (`<name>_plain`), which the CPU
    tests hold against the JAX tool's kernel;
  * a kernel wrapper (`<name>_kernel`) that launches the CUDA entry for CUDA
    tensors, raises for anything else and counts its launches;
  * a dispatcher (`<name>`): the kernel for CUDA tensors, the plain version
    for CPU tensors;
  * `main()`: `python -m exllamav3_tpu_torch.probes.<name>` times each
    variant on the card (CUDA events over inputs that rotate through more
    than the L2 cache) and prints µs, the bytes bound at 3.35 TB/s and the
    share of the bound, after the card's name and power limit.
"""
from __future__ import annotations

import subprocess

import torch

from ..util.device import resolve_device
from ..util.timing import bytes_bound_us


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card in use."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def card(device: str = "cuda") -> torch.device:
    """The device a probe's main() measures on: a CUDA device, never the CPU.
    Prints the card's name and power limit."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("a probe measures on the card: pass a CUDA device")
    print(card_line(), flush=True)
    return dev


def report(label: str, us: float, nbytes: float) -> str:
    """One result line: the time, the bytes bound and the share of it."""
    bound = bytes_bound_us(nbytes)
    line = f"{label}: {us:9.2f} us  bound {bound:8.2f} us  ({100.0 * bound / us:5.1f}% of bound)"
    print(line, flush=True)
    return line


def cuda_args(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's check: every tensor contiguous, on one CUDA device."""
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
