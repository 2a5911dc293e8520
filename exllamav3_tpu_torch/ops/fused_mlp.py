"""Fused gate_up -> act -> down decode MLP
(counterpart of exllamav3_tpu/ops/fused_mlp.py).

acc = sum over intermediate tiles of bf16(act(x@Wg*sg) * (x@Wu*su)) @ Wd;
the caller applies the down scale and bias. act is silu, gelu (erf),
gelu_pytorch_tanh or relu2, taken in f32 before the bf16 round; with
`act_clamp` L > 0 (DeepSeek-V4's swiglu_limit) the scaled gate is clipped to
[-L, L] first, as the JAX kernel's _act does (the three-dot MLP clamps
otherwise: modules/mlp.py::act_mul_clamped). On a CUDA tensor the wrapper
launches csrc/fused_mlp.cu; on a CPU tensor it runs the plain version.
"""
from __future__ import annotations

import torch

from .build import check_aligned, check_launch, library

MAX_ROWS = 16
TILE_I = 64  # intermediate columns per block in the kernel
# activation name -> the kernel's template code (csrc/fused_mlp.cu, enum Act)
ACTIVATIONS = {"silu": 0, "gelu": 1, "gelu_pytorch_tanh": 2, "relu2": 3}


def apply_activation(name: str, g: torch.Tensor) -> torch.Tensor:
    """act(g) in g's dtype, as the JAX package's ACT2FN computes it."""
    if name == "silu":
        return g * torch.sigmoid(g)
    if name == "gelu":  # written as jax.nn.gelu writes it
        return 0.5 * g * torch.special.erfc(-g * 0.7071067811865476)
    if name == "gelu_pytorch_tanh":
        return g * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * (g + 0.044715 * (g * g * g)))))
    if name == "relu2":
        return torch.square(torch.relu(g))
    raise ValueError(f"activation {name!r} is not ported yet")


def fused_mlp_int8_plain(x: torch.Tensor, gu_q: torch.Tensor, gu_scale: torch.Tensor,
                         d_q: torch.Tensor, activation: str = "silu",
                         act_clamp: float = 0.0) -> torch.Tensor:
    """x (m, h); gu_q (h, 2i) int8 [gate | up]; gu_scale (2i,) f32; d_q (i, h)
    int8 -> (m, h) f32 before the down scale."""
    inter = d_q.shape[0]
    gu = (x.to(torch.bfloat16).float() @ gu_q.float()) * gu_scale[None, :]
    g, u = gu[:, :inter], gu[:, inter:]
    if act_clamp:
        g = torch.clamp(g, -act_clamp, act_clamp)
    a = (apply_activation(activation, g) * u).to(torch.bfloat16)
    return a.float() @ d_q.float()


def fused_mlp_int8_kernel(x: torch.Tensor, gu_q: torch.Tensor, gu_scale: torch.Tensor,
                          d_q: torch.Tensor, activation: str = "silu",
                          act_clamp: float = 0.0) -> torch.Tensor:
    """Launch csrc/fused_mlp.cu: x (m <= 16, h) bf16, gu_q (h, 2i) int8,
    gu_scale (2i,) f32, d_q (i, h) int8; h % 256 == 0, i % 128 == 0;
    activation one of ACTIVATIONS; act_clamp >= 0 (0: none)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"fused_mlp_int8_kernel: activation {activation!r} is not ported yet")
    m, h = x.shape
    inter = d_q.shape[0]
    tensors = (x, gu_q, gu_scale, d_q)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_mlp_int8_kernel: all tensors must be on one CUDA device")
    if (x.dtype, gu_q.dtype, gu_scale.dtype, d_q.dtype) != (
            torch.bfloat16, torch.int8, torch.float32, torch.int8):
        raise TypeError("fused_mlp_int8_kernel: expected bf16, int8, f32, int8")
    if (not 0 < m <= MAX_ROWS or gu_q.shape != (h, 2 * inter) or gu_scale.shape != (2 * inter,)
            or d_q.shape != (inter, h) or h % 256 or inter % 128):
        raise ValueError(f"fused_mlp_int8_kernel: shapes x {tuple(x.shape)}, "
                         f"gu {tuple(gu_q.shape)}, d {tuple(d_q.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp_int8_kernel: tensors must be contiguous")
    check_aligned("fused_mlp_int8_kernel", *tensors)
    partial = torch.empty((inter // TILE_I, m, h), dtype=torch.float32, device=x.device)
    out = torch.empty((m, h), dtype=torch.float32, device=x.device)
    err = library().exl3_fused_mlp(
        x.data_ptr(), gu_q.data_ptr(), gu_scale.data_ptr(), d_q.data_ptr(),
        partial.data_ptr(), out.data_ptr(), m, h, inter, ACTIVATIONS[activation],
        float(act_clamp), torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("exl3_fused_mlp", err)
    fused_mlp_int8_kernel.launches += 1
    return out


fused_mlp_int8_kernel.launches = 0


def fused_mlp_int8(x, gu_q, gu_scale, d_q, d_scale, d_bias=None, activation: str = "silu",
                   act_clamp: float = 0.0):
    """x (..., h) -> (..., h) f32, down scale and bias applied."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        y = fused_mlp_int8_plain(x2, gu_q, gu_scale, d_q, activation, act_clamp)
    else:
        y = fused_mlp_int8_kernel(x2.to(torch.bfloat16).contiguous(), gu_q, gu_scale, d_q,
                                  activation, act_clamp)
    y = y * d_scale[None, :]
    if d_bias is not None:
        y = y + d_bias
    return y.reshape(shape)


def fused_mlp_eligible(mlp, params: dict, T: int) -> bool:
    """The decode fast path: fused int8 gate_up, int8 down, one of the
    kernel's activations and at most 16 rows."""
    if T > MAX_ROWS or mlp.activation not in ACTIVATIONS:
        return False
    p = params.get(mlp.key, {})
    pd = params.get(mlp.down.key, {})
    if "gate_up_q" not in p or "weight_q" not in pd:
        return False
    h, inter = mlp.down.out_features, mlp.down.in_features
    return h % 256 == 0 and inter % 128 == 0
