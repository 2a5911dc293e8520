"""Device resolution for the port's entry points: "cuda" by default, the CPU
only when asked for. There is no silent fallback. Also what the kernels'
launch sizing reads of a card (its SM count), the arrival counters that
the kernels which merge their splits in the launch share, and the scratch
buffer of the kernels whose workspace lives only within their launches.
A captured CUDA graph keeps the addresses of those two buffers, so it holds
them (`workspace_buffers`) for as long as it lives: a later call that grows
a buffer replaces it in the table here and leaves the held one alive."""
from __future__ import annotations

import functools

import torch

H100_SMS = 132  # the SMs that sizing without a card assumes (the plain split versions)


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(device: torch.device) -> int:
    """The SM count of a CUDA device, read once a device."""
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


_COUNTERS: dict = {}


def arrival_counters(device, n: int) -> torch.Tensor:
    """int32 arrival counters for a kernel whose last block to arrive merges
    the others' work (the split-key decode attention, the trellis GEMM, the
    int-B matmul at decode sizes, one counter a warp's 32 columns):
    zero at first and left zero by every launch, so one tensor a device
    serves every call (it grows when a call needs more). Launches that share
    it run one after another on one stream, as the model's steps do."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


_SCRATCH: dict = {}


def scratch(device, nbytes: int) -> torch.Tensor:
    """A per-device uint8 buffer of at least `nbytes` for workspace that a
    call's own launches write and read and nothing reads after them (the
    int8 matmul's split-k partial sums, the fused MLP's intermediate
    activation and partial sums), so that such a call allocates nothing but
    its output. It grows when a call needs more; calls that share it run one
    after another on one stream, as the model's steps do."""
    buf = _SCRATCH.get(device)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8, device=device)
        _SCRATCH[device] = buf
    return buf


def workspace_buffers() -> list:
    """The arrival counters and the scratch buffers that calls use now, on
    every device. A captured graph that launched kernels over them keeps
    this list: when a later call grows either, the table here takes a new
    buffer and the graph's old one stays alive, so a replay never writes
    into memory that was handed to another tensor."""
    return list(_COUNTERS.values()) + list(_SCRATCH.values())
