"""Environment-variable readers (counterpart of exllamav3_tpu/util/env.py).

The port reads the JAX package's variable names where a switch carries over:
  EXL3TPU_INT4_A8     int4 linears: 1 (default) the int8-activation kernel,
                      0 the bf16-dequant kernel
  EXL3TPU_INTB_A8     int-B linears (int3/int5/int6 and `.sq` tensors): the same
  EXL3TPU_INTB_MIN_K  smallest in_features that loads as int-B (default 512);
                      smaller layers load as int8
  EXL3TPU_SQ          1 (default) prefer a checkpoint's `.sq` serving tensors at
                      the asked width over the load-time requant, 0 ignores them
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
