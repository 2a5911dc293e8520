"""Device timing shared by chip_smoke.py and the probes (probes/): a kernel's
mean time over many launches by CUDA events, over input sets that rotate
through more than the L2 cache holds."""
from __future__ import annotations

import math

import torch

L2_BYTES = 50 << 20          # H100 L2 cache
SPIN_CYCLES = 35_000_000     # ~20 ms at the H100's clock
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet


def time_ms(fn, calls: int) -> float:
    """Mean device time of fn() over `calls` launches (CUDA events). The
    launches queue up behind a ~20 ms spin on the device, so that a short
    kernel reads its time on the card and not the host's launch rate."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def rotating(make, nbytes: int):
    """Enough independent copies of an input set that cycling through them
    exceeds the L2 cache, so each timed call reads device memory as the
    main path does."""
    n = max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))
    sets = [make(i) for i in range(n)]
    state = {"i": 0}

    def nxt():
        s = sets[state["i"] % n]
        state["i"] += 1
        return s
    return nxt


def bytes_bound_us(nbytes: float) -> float:
    """The least time the card could take to move `nbytes`, in µs."""
    return nbytes / HBM_BYTES_PER_S * 1e6
