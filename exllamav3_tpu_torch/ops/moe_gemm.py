"""Selected-expert MoE MLP for decode shapes
(counterpart of exllamav3_tpu/ops/moe_gemm.py).

out[t] = sum over j of topv[t, j] * (bf16(silu(x_t @ wg[e]) * (x_t @ wu[e])) @ wd[e]),
e = topi[t, j]: only the k routed experts' weights are read, not all E. The
products accumulate in f32; the activation is computed in f32 and rounded to
bf16 before the down product; with `act_clamp` L > 0 (DeepSeek-V4's
swiglu_limit) it is min(silu(g), L) * clip(u, -L, L), the JAX package's
act_mul_clamped. On a CUDA tensor the wrapper launches csrc/moe_gemm.cu; on a
CPU tensor it runs the plain version. Gated silu experts without biases are
ported; biases, non-gated experts and silu_oai wait.
"""
from __future__ import annotations

import torch

from .build import check_aligned, check_launch, library

MAX_ROWS = 16
TILE_I = 64  # intermediate columns per block in the kernel


def _pick_bi(h: int, i: int) -> int:
    """The JAX kernel's intermediate tile (three (h, bi) bf16 tiles, double
    buffered, within 8 MiB); 0 where none fits. The dispatch condition reads
    it, so that both packages take the same body for the same step."""
    budget = 8 * 1024 * 1024
    bi = budget // (3 * 2 * 2 * h)
    bi = max(128, (bi // 128) * 128)
    bi = min(bi, (i // 128) * 128)
    if bi < 128:
        return 0
    while i % bi:
        bi -= 128
        if bi < 128:
            return 0
    return bi


def silu_mul(g: torch.Tensor, u: torch.Tensor, act_clamp: float = 0.0) -> torch.Tensor:
    """silu(g) * u, or with act_clamp L > 0 min(silu(g), L) * clip(u, -L, L)
    (the JAX package's act_mul_clamped)."""
    a = torch.nn.functional.silu(g)
    if act_clamp:
        return torch.clamp(a, max=act_clamp) * torch.clamp(u, -act_clamp, act_clamp)
    return a * u


def selected_expert_mlp_plain(x: torch.Tensor, topi: torch.Tensor, topv: torch.Tensor,
                              wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                              act_clamp: float = 0.0) -> torch.Tensor:
    """x (T, h); topi (T, k) int; topv (T, k); wg, wu (E, h, i) bf16; wd
    (E, i, h) bf16 -> (T, h) f32. One gathered expert per (token, slot)."""
    T, h = x.shape
    k = topi.shape[1]
    e = topi.reshape(-1).long()
    xs = x.to(torch.bfloat16).float().repeat_interleave(k, dim=0)[:, None, :]   # (T*k, 1, h)
    g = torch.bmm(xs, wg[e].float())
    u = torch.bmm(xs, wu[e].float())
    a = silu_mul(g, u, act_clamp).to(torch.bfloat16).float()
    y = torch.bmm(a, wd[e].float())[:, 0, :].reshape(T, k, h)
    return (y * topv.float()[:, :, None]).sum(dim=1)


def selected_expert_mlp_kernel(x: torch.Tensor, topi: torch.Tensor, topv: torch.Tensor,
                               wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                               act_clamp: float = 0.0) -> torch.Tensor:
    """Launch csrc/moe_gemm.cu: x (T <= 16, h) bf16, topi (T, k) int32, topv
    (T, k) f32, wg/wu (E, h, i) bf16, wd (E, i, h) bf16; h % 128 == 0,
    i % 64 == 0; act_clamp >= 0 (0: none). Returns (T, h) f32."""
    T, h = x.shape
    k = topi.shape[1]
    E, _, inter = wg.shape
    tensors = (x, topi, topv, wg, wu, wd)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("selected_expert_mlp_kernel: all tensors must be on one CUDA device")
    if (x.dtype, topi.dtype, topv.dtype, wg.dtype, wu.dtype, wd.dtype) != (
            torch.bfloat16, torch.int32, torch.float32, torch.bfloat16, torch.bfloat16,
            torch.bfloat16):
        raise TypeError("selected_expert_mlp_kernel: expected bf16 x, int32 topi, f32 topv, "
                        "bf16 weights")
    if (not 0 < T <= MAX_ROWS or topi.shape != (T, k) or topv.shape != (T, k) or k < 1
            or wu.shape != (E, h, inter) or wd.shape != (E, inter, h)
            or h % 128 or inter % TILE_I):
        raise ValueError(f"selected_expert_mlp_kernel: shapes x {tuple(x.shape)}, topi "
                         f"{tuple(topi.shape)}, wg {tuple(wg.shape)}, wu {tuple(wu.shape)}, "
                         f"wd {tuple(wd.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("selected_expert_mlp_kernel: tensors must be contiguous")
    check_aligned("selected_expert_mlp_kernel", x, wg, wu, wd)
    partial = torch.empty((T * k, inter // TILE_I, h), dtype=torch.float32, device=x.device)
    out = torch.empty((T, h), dtype=torch.float32, device=x.device)
    err = library().exl3_moe_mlp(
        x.data_ptr(), topi.data_ptr(), topv.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), partial.data_ptr(), out.data_ptr(), T, k, h, inter, E, float(act_clamp),
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("exl3_moe_mlp", err)
    selected_expert_mlp_kernel.launches += 1
    return out


selected_expert_mlp_kernel.launches = 0


def selected_expert_mlp(x, topi, topv, wu, wd, wg=None, bg=None, bu=None, bd=None,
                        activation: str = "silu", act_limit: float = 7.0,
                        act_clamp: float = 0.0) -> torch.Tensor:
    """The JAX package's signature: x (T, h); topi/topv (T, k); wu/wg (E, h, i);
    wd (E, i, h) -> (T, h) f32. The kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if wg is None or activation != "silu":
        raise NotImplementedError("selected-expert MLP: only gated silu experts are ported")
    if bg is not None or bu is not None or bd is not None:
        raise NotImplementedError("selected-expert MLP: expert biases are not ported yet")
    if x.device.type == "cpu":
        return selected_expert_mlp_plain(x, topi, topv, wg, wu, wd, act_clamp)
    return selected_expert_mlp_kernel(x.to(torch.bfloat16).contiguous(),
                                      topi.to(torch.int32).contiguous(),
                                      topv.to(torch.float32).contiguous(), wg, wu, wd,
                                      act_clamp)
