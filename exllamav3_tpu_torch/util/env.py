"""Environment-variable readers (counterpart of exllamav3_tpu/util/env.py).

The port reads the JAX package's variable names where a switch carries over:
  EXL3TPU_INT4_A8     int4 linears: 1 (default) the int8-activation kernel,
                      0 the bf16-dequant kernel
  EXL3TPU_INTB_A8     int-B linears (int3/int5/int6 and `.sq` tensors): the same
  EXL3TPU_INTB_MIN_K  smallest in_features that loads as int-B (default 512);
                      smaller layers load as int8
  EXL3TPU_SQ          1 (default) prefer a checkpoint's `.sq` serving tensors at
                      the asked width over the load-time requant, 0 ignores them
  EXL3_TPU_MOE        MoE decode body (`moe_backend`)
"""
from __future__ import annotations

import os


def env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v is None else int(v)


def env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("", "0", "false", "no", "off")


def moe_backend() -> str:
    """The MoE decode body, from EXL3_TPU_MOE: "selected" (the selected-expert
    kernel for CUDA tensors, its plain version for CPU tensors) or "dense"
    (every expert, plain PyTorch). "auto", the default, is "selected" on both
    devices, so that card and CPU compute one function; the JAX package takes
    "dense" on its CPU. "interpret" names a Pallas mode the port has not."""
    mode = env_str("EXL3_TPU_MOE", "auto")
    if mode == "interpret":
        raise ValueError("EXL3_TPU_MOE=interpret has no meaning in the port: "
                         "use selected, dense or auto")
    return "dense" if mode == "dense" else "selected"
