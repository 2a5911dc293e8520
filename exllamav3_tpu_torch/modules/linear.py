"""Linear layer: EXL3-quantized or dense checkpoints behind one interface
(counterpart of exllamav3_tpu/modules/linear.py).

Runtime representations of an EXL3 tensor ("linear_mode"):
  * "reconstruct": keep the packed trellis, decode the weight on every call;
  * "bf16": decode once at load into a bf16 weight (original basis);
  * "int8": decode once at load and requantize per output channel to int8;
    the matmul runs through the hand-written int8 kernel (ops/q_matmul.py);
  * "fused": keep the packed trellis as stream words and decode it inside the
    matmul kernel on every call (ops/exl3_gemm.py): the capacity mode, K/8
    bytes a weight.
The int4, int-B and `.sq` modes are not ported yet and raise at load.

Parameter layouts (the JAX package's own keys): {"trellis","suh","svh"},
{"words","suh","svh"} (int32 (k/16, K, n/2)), {"weight"} (bf16, (in, out)),
{"weight_q" (in, out) int8, "scale" (out,) f32}, each with an optional f32
"bias".
"""
from __future__ import annotations

import torch

from .module import ForwardCtx, Module
from ..ops.exl3_gemm import exl3_matmul, trellis_to_words, words_to_trellis
from ..ops.q_matmul import int8_matmul
from ..quant.reconstruct import codebook_id, exl3_matmul_ref, reconstruct_full

_EXL3_GROUP = [["suh", "su"], ["svh", "sv"], "trellis"]


def bf16_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w on bf16 operands with an f32 result. On the CPU the product runs
    in f32 (products of bf16 values are exact in f32, so this is the JAX
    package's f32-accumulating bf16 dot); on CUDA, cuBLAS multiplies the bf16
    operands with f32 accumulation and rounds each output to bf16 once."""
    x = x.to(torch.bfloat16)
    if x.is_cuda:
        return torch.matmul(x, w).float()
    return x.float() @ w.float()


def int8_requant(w: torch.Tensor):
    """f32 (k, n) -> (int8 (k, n), f32 (n,) per-column scale), the JAX
    package's load-time requant: absmax/127 scales, round half to even."""
    scale = w.abs().amax(dim=0) / 127.0 + 1e-12
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


class Linear(Module):
    def __init__(self, config, key: str, in_features: int, out_features: int,
                 alt_key: str | None = None, out_dtype=None):
        super().__init__(config, key)
        self.in_features = in_features
        self.out_features = out_features
        self.alt_key = alt_key
        self.out_dtype = out_dtype
        self.cb = 0
        stc = config.stc
        for k in self._keys():
            if stc is not None and stc.has_tensor_group(k, _EXL3_GROUP):
                self.cb = codebook_id(stc.has_tensor(k + ".mcg"), stc.has_tensor(k + ".mul1"))
                break

    def _keys(self):
        return [self.key] + ([self.alt_key] if self.alt_key else [])

    # -- loading -----------------------------------------------------------

    def load(self, params: dict, device: torch.device) -> None:
        stc = self.config.stc
        for k in self._keys():
            if stc.has_tensor_group(k, _EXL3_GROUP):
                self._load_exl3(params, k, device)
                return
        for k in self._keys():
            if stc.has_tensor(k + ".weight"):
                self._load_dense(params, k, device)
                return
        raise ValueError(f"no tensors found for linear {self.key}")

    def _load_exl3(self, params: dict, key: str, device: torch.device) -> None:
        stc = self.config.stc
        trellis = stc.get_tensor(key + ".trellis").to(device)
        suh = stc.get_tensor(key + ".suh", optional=True)
        svh = stc.get_tensor(key + ".svh", optional=True)
        if suh is None:
            suh = _unpack_signs(stc.get_tensor(key + ".su"))
        if svh is None:
            svh = _unpack_signs(stc.get_tensor(key + ".sv"))
        suh = suh.to(device=device, dtype=torch.float32)
        svh = svh.to(device=device, dtype=torch.float32)
        bias = stc.get_tensor(key + ".bias", optional=True)
        K = trellis.shape[-1] // 16

        mode = self.config.infer_params.linear_mode
        if mode == "auto":
            # Model.load resolves "auto" once per model (select_linear_mode);
            # a standalone Linear takes the ladder's top tier
            mode = "int8"
        if mode == "reconstruct":
            p = {"trellis": trellis, "suh": suh, "svh": svh}
        elif mode == "fused":
            p = {"words": trellis_to_words(trellis), "suh": suh, "svh": svh}
        elif mode == "bf16":
            p = {"weight": reconstruct_full(trellis, suh, svh, K, self.cb, dtype=torch.bfloat16)}
        elif mode == "int8":
            w = reconstruct_full(trellis, suh, svh, K, self.cb, dtype=torch.float32)
            q, scale = int8_requant(w)
            del w
            p = {"weight_q": q, "scale": scale}
        else:
            raise ValueError(f"linear_mode {mode!r} is not ported yet")
        if bias is not None:
            p["bias"] = bias.to(device=device, dtype=torch.float32)
        params[self.key] = p

    def _load_dense(self, params: dict, key: str, device: torch.device) -> None:
        stc = self.config.stc
        if stc.get_dtype_str(key + ".weight") not in ("BF16", "F16", "F32"):
            raise ValueError(f"{key}.weight: dtype {stc.get_dtype_str(key + '.weight')} "
                             "is not ported yet")
        w = stc.get_tensor(key + ".weight").to(torch.float32)
        # HF stores (out, in); the port, like the JAX package, uses (in, out)
        p = {"weight": w.t().contiguous().to(device=device, dtype=torch.bfloat16)}
        bias = stc.get_tensor(key + ".bias", optional=True)
        if bias is not None:
            p["bias"] = bias.to(device=device, dtype=torch.float32)
        params[self.key] = p

    # -- forward -------------------------------------------------------------

    def forward(self, x, params: dict, ctx: ForwardCtx):
        p = params[self.key]
        bias = p.get("bias")
        out_dtype = self.out_dtype or x.dtype
        if "words" in p:
            y = exl3_matmul(x, p["words"], p["suh"], p["svh"], p["words"].shape[1], self.cb,
                            bias=bias, out_dtype=torch.float32)
        elif "trellis" in p:
            y = exl3_matmul_ref(x, p["trellis"], p["suh"], p["svh"],
                                p["trellis"].shape[-1] // 16, self.cb,
                                bias=bias, out_dtype=torch.float32)
        elif "weight_q" in p:
            y = int8_matmul(x, p["weight_q"], p["scale"], bias=bias)
        else:
            y = bf16_matmul_f32(x, p["weight"])
            if bias is not None:
                y = y + bias
        return y.to(out_dtype)

    def get_weight_f32(self, params: dict) -> torch.Tensor:
        """Dense (in, out) f32 weight in the original basis."""
        p = params[self.key]
        if "words" in p or "trellis" in p:
            trellis = words_to_trellis(p["words"]) if "words" in p else p["trellis"]
            return reconstruct_full(trellis, p["suh"], p["svh"], trellis.shape[-1] // 16,
                                    self.cb, dtype=torch.float32)
        if "weight_q" in p:
            return p["weight_q"].to(torch.float32) * p["scale"][None, :]
        return p["weight"].to(torch.float32)


def _unpack_signs(packed_i16: torch.Tensor) -> torch.Tensor:
    """Packed sign bitfield (int16) -> +-1.0 f32."""
    bits = packed_i16.to(torch.int64) & 0xFFFF
    masks = 1 << torch.arange(16, dtype=torch.int64)
    expanded = (bits[..., None] & masks) > 0
    return (1.0 - expanded.to(torch.float32) * 2.0).reshape(-1)
