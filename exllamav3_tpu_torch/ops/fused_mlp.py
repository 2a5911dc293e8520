"""Fused gate_up -> act -> down decode MLP
(counterpart of exllamav3_tpu/ops/fused_mlp.py).

acc = bf16(act(x@Wg*sg) * (x@Wu*su)) @ Wd, then times the down scale and plus
the down bias (on the card inside the kernel's second phase). act is silu, gelu (erf),
gelu_pytorch_tanh or relu2, taken in f32 before the bf16 round; with
`act_clamp` L > 0 (DeepSeek-V4's swiglu_limit) the scaled gate is clipped to
[-L, L] first, as the JAX kernel's _act does (the three-dot MLP clamps
otherwise: modules/mlp.py::act_mul_clamped). On a CUDA tensor the wrapper
launches csrc/fused_mlp.cu, two phases of the staged int8 body
(csrc/int8_staged.cuh); on a CPU tensor it runs the plain version.
fused_mlp_int8_split_plain is the kernel's arithmetic.
"""
from __future__ import annotations

import torch

from ..util.device import arrival_counters, device_sms, scratch
from .build import check_aligned, check_launch, library
from .q_matmul import INT8_DECODE_ROWS, int8_matmul_split_plain, int8_split_count

MAX_ROWS = INT8_DECODE_ROWS
# activation name -> the kernel's activation code (csrc/int8_staged.cuh, enum Activation)
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


def fused_mlp_int8_split_plain(x: torch.Tensor, gu_q: torch.Tensor, gu_scale: torch.Tensor,
                               d_q: torch.Tensor, activation: str, act_clamp: float,
                               splits1: int, splits2: int) -> torch.Tensor:
    """The kernel's arithmetic in plain torch (m <= 16): the gate and up sums
    of the first phase in `splits1` runs of k steps added in split order
    (int8_matmul_split_plain), times their scales, the activation in f32 and
    the bf16 round; then the down product in `splits2` runs. (m, h) f32
    before the down scale."""
    inter = d_q.shape[0]
    gu = int8_matmul_split_plain(x, gu_q, gu_scale, splits1)
    g, u = gu[:, :inter], gu[:, inter:]
    if act_clamp:
        g = torch.clamp(g, -act_clamp, act_clamp)
    a = (apply_activation(activation, g) * u).to(torch.bfloat16)
    return int8_matmul_split_plain(a, d_q, None, splits2)


def fused_mlp_splits(m: int, h: int, inter: int, sms: int) -> tuple[int, int]:
    """The k splits of the kernel's two phases: the staged body over the 2i
    [gate | up] columns with k = h, then over the h down columns with k = i."""
    return int8_split_count(m, h, 2 * inter, sms), int8_split_count(m, inter, h, sms)


def fused_mlp_int8_kernel(x: torch.Tensor, gu_q: torch.Tensor, gu_scale: torch.Tensor,
                          d_q: torch.Tensor, activation: str = "silu", act_clamp: float = 0.0,
                          d_scale: torch.Tensor | None = None,
                          d_bias: torch.Tensor | None = None) -> torch.Tensor:
    """Launch csrc/fused_mlp.cu: x (m <= 16, h) bf16, gu_q (h, 2i) int8,
    gu_scale (2i,) f32, d_q (i, h) int8; h % 256 == 0, i % 128 == 0;
    activation one of ACTIVATIONS; act_clamp >= 0 (0: none); d_scale and
    d_bias (h,) f32 or None. -> (m, h) f32: the down product, times d_scale
    and plus d_bias where given. Two device kernels a call, their splits
    sized by int8_split_count (fused_mlp_splits) and added in the launch;
    the intermediate activation and the partial sums live in the device's
    scratch buffer."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"fused_mlp_int8_kernel: activation {activation!r} is not ported yet")
    m, h = x.shape
    inter = d_q.shape[0]
    tensors = (x, gu_q, gu_scale, d_q) + tuple(t for t in (d_scale, d_bias) if t is not None)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_mlp_int8_kernel: all tensors must be on one CUDA device")
    if (x.dtype, gu_q.dtype, gu_scale.dtype, d_q.dtype) != (
            torch.bfloat16, torch.int8, torch.float32, torch.int8) or any(
            t.dtype != torch.float32 for t in (d_scale, d_bias) if t is not None):
        raise TypeError("fused_mlp_int8_kernel: expected bf16, int8, f32, int8 (and f32 down "
                        "scale and bias)")
    if (not 0 < m <= MAX_ROWS or gu_q.shape != (h, 2 * inter) or gu_scale.shape != (2 * inter,)
            or d_q.shape != (inter, h) or h % 256 or inter % 128
            or any(t.shape != (h,) for t in (d_scale, d_bias) if t is not None)):
        raise ValueError(f"fused_mlp_int8_kernel: shapes x {tuple(x.shape)}, "
                         f"gu {tuple(gu_q.shape)}, d {tuple(d_q.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp_int8_kernel: tensors must be contiguous")
    check_aligned("fused_mlp_int8_kernel", *tensors)
    dev = x.device
    splits1, splits2 = fused_mlp_splits(m, h, inter, device_sms(dev))
    out = torch.empty((m, h), dtype=torch.float32, device=dev)
    # the scratch buffer holds a (m, i) bf16, then the partial sums of either phase
    a_bytes = -(-m * inter * 2 // 256) * 256
    ws_bytes = 4 * m * max(splits1 * 2 * inter if splits1 > 1 else 0, splits2 * h if splits2 > 1 else 0)
    a = scratch(dev, a_bytes + ws_bytes).data_ptr()
    counters = arrival_counters(dev, max(2 * inter, h) // 32)  # one a warp's columns
    err = library().exl3_fused_mlp(
        x.data_ptr(), gu_q.data_ptr(), gu_scale.data_ptr(), d_q.data_ptr(),
        None if d_scale is None else d_scale.data_ptr(), None if d_bias is None else d_bias.data_ptr(),
        a, out.data_ptr(), a + a_bytes if ws_bytes else None, counters.data_ptr(), m, h, inter,
        ACTIVATIONS[activation], float(act_clamp), splits1, splits2,
        torch.cuda.current_stream(dev).cuda_stream)
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
        y = fused_mlp_int8_plain(x2, gu_q, gu_scale, d_q, activation, act_clamp) * d_scale[None, :]
        if d_bias is not None:
            y = y + d_bias
    else:
        y = fused_mlp_int8_kernel(x2.to(torch.bfloat16).contiguous(), gu_q, gu_scale, d_q,
                                  activation, act_clamp, d_scale, d_bias)
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
