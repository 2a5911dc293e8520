"""EXL3 procedural codebooks in torch (counterpart of exllamav3_tpu/quant/codebook.py).

A 16-bit trellis code maps to an fp16 weight through one of three codebooks:

  * cb=0 ("3INST"): x = code * 89226354 + 64248484 (mod 2^32);
        y = fp16(lo16(m)) + fp16(hi16(m)) where m = (x & 0x8FFF8FFF) ^ 0x3B603B60
  * cb=1 ("MCG"):   the same bit trick with x = code * 0xCBAC1FED
  * cb=2 ("MUL1"):  x = code * 0x83DCD12D; s = sum of the 4 bytes of x;
        y = fp16(fp16(0x6400 + s) * 0.0067672729... - 10.3828125)

torch has little unsigned arithmetic, so the multiply-mod-2^32 runs in int64
and is masked with 0xFFFFFFFF. fp16 halves are read by viewing an int16
tensor as float16. The sums are computed in a wider float and rounded once
to fp16, which is exact (see the JAX module's note).
"""
from __future__ import annotations

import torch

CB_3INST = 0
CB_MCG = 1
CB_MUL1 = 2

MULT_3INST = 89226354
ADD_3INST = 64248484
MULT_MCG = 0xCBAC1FED
MULT_MUL1 = 0x83DCD12D
MASK_AND = 0x8FFF8FFF
MASK_XOR = 0x3B603B60
U32 = 0xFFFFFFFF

# fp16 bit patterns of the MUL1 affine map
MUL1_SCALE_BITS = 0x1EEE
MUL1_BIAS_BITS = 0xC931


def bits_to_f16(bits: torch.Tensor) -> torch.Tensor:
    """Integer tensor holding 16-bit patterns (0..65535) -> float16 values."""
    b = bits.to(torch.int64) & 0xFFFF
    return ((b ^ 0x8000) - 0x8000).to(torch.int16).view(torch.float16)


def _f16_const(bits: int) -> float:
    return float(bits_to_f16(torch.tensor([bits]))[0])


def decode(codes: torch.Tensor, cb: int = CB_3INST, dtype=torch.float32) -> torch.Tensor:
    """Decode trellis codes (any integer dtype, values 0..65535) to the
    canonical fp16 value, returned as `dtype`."""
    x = codes.to(torch.int64) & 0xFFFF
    if cb == CB_3INST:
        x = (x * MULT_3INST + ADD_3INST) & U32
    elif cb == CB_MCG:
        x = (x * MULT_MCG) & U32
    elif cb == CB_MUL1:
        x = (x * MULT_MUL1) & U32
        s = ((x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF)
             + ((x >> 24) & 0xFF) + 0x6400)
        h = bits_to_f16(s).to(torch.float64)
        y = h * _f16_const(MUL1_SCALE_BITS) + _f16_const(MUL1_BIAS_BITS)
        return y.to(torch.float16).to(dtype)
    else:
        raise ValueError(f"unknown codebook {cb}")
    m = (x & MASK_AND) ^ MASK_XOR
    lo = bits_to_f16(m & 0xFFFF).to(torch.float32)
    hi = bits_to_f16(m >> 16).to(torch.float32)
    return (lo + hi).to(torch.float16).to(dtype)
