"""Linear layer: EXL3-quantized or dense checkpoints behind one interface
(counterpart of exllamav3_tpu/modules/linear.py).

Runtime representations of an EXL3 tensor ("linear_mode"):
  * "reconstruct": keep the packed trellis, decode the weight on every call;
  * "bf16": decode once at load into a bf16 weight (original basis);
  * "int8": decode once at load and requantize per output channel to int8;
    the matmul runs through the hand-written int8 kernel (ops/q_matmul.py);
  * "int4": decode once at load and requantize to grouped int4, two codes a
    byte and one bf16 scale per 32 rows (0.5625 bytes a weight); layers whose
    in_features are no multiple of 64 load as int8;
  * "int3" / "int5" / "int6": the same with B-bit codes packed into int32
    words (ops/q_matmul.py); layers with in_features below EXL3TPU_INTB_MIN_K
    (default 512) load as int8. Where the checkpoint carries conversion-time
    serving tensors (`.sq` / `.sq_scale`, int-B codes of the weight rotated by
    one 128-block Hadamard) at the asked width, modes int3 to int6 take those
    instead of requantizing (EXL3TPU_SQ=0 ignores them);
  * "fused": keep the packed trellis as stream words and decode it inside the
    matmul kernel on every call (ops/exl3_gemm.py): the capacity mode, K/8
    bytes a weight.
The requants run on the load device and free the f32 weight before the next
linear loads.

Parameter layouts (the JAX package's own keys): {"trellis","suh","svh"},
{"words","suh","svh"} (int32 (k/16, K, n/2)), {"weight"} (bf16, (in, out)),
{"weight_q" (in, out) int8, "scale" (out,) f32}, {"weight_q4" (in/2, out)
int8, "scale4" (in/32, out) bf16}, {"weight_qb" (kp, out) int32, "scale_qb"
bf16}, {"weight_sq", "scale_sq"} (as weight_qb, rotated basis), each with an
optional f32 "bias".

`softcap` caps the f32 output as tanh(y / c) * c (Gemma-2's final logits);
`post_scale` waits.
"""
from __future__ import annotations

import torch

from .module import ForwardCtx, Module
from ..ops.exl3_gemm import exl3_matmul, trellis_to_words, words_to_trellis
from ..ops.q_matmul import (INT4_GROUP, int4_matmul, int4_pack, int4_unpack, int8_matmul,
                            intb_bits_from_shapes, intb_matmul, intb_pack, intb_unpack)
from ..quant.hadamard import had_left, had_right
from ..quant.reconstruct import codebook_id, exl3_matmul_ref, reconstruct_full
from ..util.env import env_bool, env_int

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
                 alt_key: str | None = None, out_dtype=None, softcap: float = 0.0):
        super().__init__(config, key)
        self.in_features = in_features
        self.out_features = out_features
        self.alt_key = alt_key
        self.out_dtype = out_dtype
        self.softcap = softcap
        self.cb = 0
        self.qbits = None  # width of the int-B codes, once loaded in such a mode
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
        elif mode in ("int8", "int4", "int3", "int5", "int6"):
            p = self._load_sq(key, mode, device) if mode != "int8" else None
            if p is None:
                p = self._requant(reconstruct_full(trellis, suh, svh, K, self.cb,
                                                   dtype=torch.float32), mode)
        else:
            raise ValueError(f"unknown linear_mode {mode!r}")
        if bias is not None:
            p["bias"] = bias.to(device=device, dtype=torch.float32)
        params[self.key] = p

    def _load_sq(self, key: str, mode: str, device: torch.device) -> dict | None:
        """The checkpoint's serving tensors, when present at the width `mode`
        asks for and not switched off."""
        stc = self.config.stc
        if not (env_bool("EXL3TPU_SQ", True) and stc.has_tensor(key + ".sq")):
            return None
        sq = stc.get_tensor(key + ".sq")
        sqs = stc.get_tensor(key + ".sq_scale")
        bits = intb_bits_from_shapes(sq.shape[0], sqs.shape[0])
        if bits != int(mode[3:]):
            return None
        self.qbits = bits
        return {"weight_sq": sq.to(device).contiguous(),
                "scale_sq": sqs.to(device=device, dtype=torch.bfloat16).contiguous()}

    def _requant(self, w: torch.Tensor, mode: str) -> dict:
        """Decoded f32 weight -> the packed tensors of `mode`, with the JAX
        package's rules for the layers a packed layout does not take."""
        k = w.shape[0]
        if mode == "int4" and k % (2 * INT4_GROUP) == 0:
            packed, scale = int4_pack(w)
            return {"weight_q4": packed, "scale4": scale}
        if mode in ("int3", "int5", "int6") and k >= env_int("EXL3TPU_INTB_MIN_K", 512):
            self.qbits = int(mode[3:])
            packed, scale = intb_pack(w, self.qbits)
            return {"weight_qb": packed, "scale_qb": scale}
        q, scale = int8_requant(w)
        return {"weight_q": q, "scale": scale}

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
        elif "weight_q4" in p:
            y = int4_matmul(x, p["weight_q4"], p["scale4"], bias=bias)
        elif "weight_qb" in p:
            y = intb_matmul(x, p["weight_qb"], p["scale_qb"], bits=self.qbits, bias=bias)
        elif "weight_sq" in p:
            # the codes hold the weight rotated by one 128-block Hadamard:
            # rotate x the same way, no transform on the output
            y = intb_matmul(had_right(x), p["weight_sq"], p["scale_sq"], bits=self.qbits,
                            bias=bias)
        elif "weight_q" in p:
            y = int8_matmul(x, p["weight_q"], p["scale"], bias=bias)
        else:
            y = bf16_matmul_f32(x, p["weight"])
            if bias is not None:
                y = y + bias
        if self.softcap:
            y = torch.tanh(y / self.softcap) * self.softcap
        return y.to(out_dtype)

    def get_weight_f32(self, params: dict) -> torch.Tensor:
        """Dense (in, out) f32 weight in the original basis."""
        p = params[self.key]
        if "words" in p or "trellis" in p:
            trellis = words_to_trellis(p["words"]) if "words" in p else p["trellis"]
            return reconstruct_full(trellis, p["suh"], p["svh"], trellis.shape[-1] // 16,
                                    self.cb, dtype=torch.float32)
        if "weight_q4" in p:
            return int4_unpack(p["weight_q4"], p["scale4"])
        for name, scale_name in (("weight_qb", "scale_qb"), ("weight_sq", "scale_sq")):
            if name in p:
                bits = self.qbits or intb_bits_from_shapes(p[name].shape[0],
                                                           p[scale_name].shape[0])
                w = intb_unpack(p[name], p[scale_name], bits, self.in_features)
                # H128 is symmetric and orthonormal: rotating again undoes it
                return had_left(w) if name == "weight_sq" else w
        if "weight_q" in p:
            return p["weight_q"].to(torch.float32) * p["scale"][None, :]
        return p["weight"].to(torch.float32)


def _unpack_signs(packed_i16: torch.Tensor) -> torch.Tensor:
    """Packed sign bitfield (int16) -> +-1.0 f32."""
    bits = packed_i16.to(torch.int64) & 0xFFFF
    masks = 1 << torch.arange(16, dtype=torch.int64)
    expanded = (bits[..., None] & masks) > 0
    return (1.0 - expanded.to(torch.float32) * 2.0).reshape(-1)
