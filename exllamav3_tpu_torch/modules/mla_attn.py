"""Multi-head latent attention, DeepSeek-V2 / V3 (counterpart of
exllamav3_tpu/modules/mla_attn.py), in the absorbed form throughout: per-head
K and V are never built.

    c_kv  = kv_a_norm(W_DKV x)              the latent, kv_lora_rank wide
    k_pe  = rope(W_KR x)                    one rope key per token, all heads
    q     = W_UQ q_a_norm(W_DQ x)  (or W_Q x)
    q_eff = [q_nope @ W_UK | rope(q_pe)]    per head, kv_lora_rank + rope wide
    score = q_eff . [c_kv | k_pe]
    o     = (softmax(score) @ c_kv) @ W_UV  -> W_O

The cache holds [c_kv | k_pe] only, one kv head: bf16 rows of
kv_lora_rank + qk_rope_head_dim ({"kv"}), or the latent quantized with the
quantized cache's k_bits (packed words and bf16 group scales, per-head
storage with one head) beside the rope key in bf16 ({"kv_q", "kv_s",
"k_pe"}). Cached steps attend through ops/flash_attention.py's latent
dispatch (the latent kernels on the card, their plain versions on the CPU),
paged or linear; the cacheless forward runs the plain dense attention, as the
JAX package does. q_eff enters the attention as bf16, as JAX hands it over.
W_UK and W_UV are read from the dense bf16 `kv_b_proj` and stay bf16. The
absorbed products multiply bf16 operands with f32 sums (on the CPU in f32; on
CUDA through cuBLAS, whose bf16 result is what the next step rounds to
anyway). Sequence parallelism is not ported.
"""
from __future__ import annotations

import torch

from .attn import total_lens
from .linear import Linear
from .module import ForwardCtx, Module
from .norms import RMSNorm
from ..model.cache import page_index
from ..ops.attention import attend_dense
from ..ops.flash_attention import latent_attention_any as latent_attention
from ..util.rope import Rope, RopeSettings, RopeStyle


def head_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (B, S, H, n), w (H, n, m) bf16 -> (B, S, H, m) f32: one product a
    head, the JAX package's einsum with bf16 operands and an f32 result."""
    B, S, H, n = a.shape
    a = a.to(torch.bfloat16).permute(2, 0, 1, 3).reshape(H, B * S, n)
    y = torch.bmm(a, w).float() if a.is_cuda else torch.bmm(a.float(), w.float())
    return y.reshape(H, B, S, -1).permute(1, 2, 0, 3)


class MLAttention(Module):
    is_kv_cache_user = True

    def __init__(self, config, key: str, layer_idx: int, hidden_size: int, num_q_heads: int,
                 kv_lora_rank: int, qk_nope_head_dim: int, qk_rope_head_dim: int,
                 v_head_dim: int, rope_settings: RopeSettings | None,
                 q_lora_rank: int | None = None, sm_scale: float | None = None,
                 rms_norm_eps: float = 1e-6, out_dtype=None):
        super().__init__(config, key)
        self.layer_idx = layer_idx
        self.num_q_heads = num_q_heads
        self.kv_lora_rank = kv_lora_rank
        self.qk_nope_head_dim = qk_nope_head_dim
        self.qk_rope_head_dim = qk_rope_head_dim
        self.qk_head_dim = qk_nope_head_dim + qk_rope_head_dim
        self.v_head_dim = v_head_dim
        self.q_lora_rank = q_lora_rank
        self.out_dtype = out_dtype
        # the softmax scale follows the unabsorbed head width; yarn's
        # mscale_all_dim arrives through sm_scale from the architecture
        self.sm_scale = sm_scale if sm_scale is not None else self.qk_head_dim ** -0.5
        self.rope = Rope(rope_settings) if rope_settings else None
        nq = num_q_heads * self.qk_head_dim
        if q_lora_rank is None:
            self.q_a_proj = self.q_a_layernorm = None
            self.q_proj = Linear(config, f"{key}.q_proj", hidden_size, nq)
        else:
            self.q_a_proj = Linear(config, f"{key}.q_a_proj", hidden_size, q_lora_rank)
            self.q_a_layernorm = RMSNorm(config, f"{key}.q_a_layernorm", rms_norm_eps,
                                         dim=q_lora_rank)
            self.q_proj = Linear(config, f"{key}.q_b_proj", q_lora_rank, nq)
        self.kv_a_proj_with_mqa = Linear(config, f"{key}.kv_a_proj_with_mqa", hidden_size,
                                         kv_lora_rank + qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(config, f"{key}.kv_a_layernorm", rms_norm_eps,
                                      dim=kv_lora_rank)
        self.o_proj = Linear(config, f"{key}.o_proj", num_q_heads * v_head_dim, hidden_size)
        self.modules = [m for m in (self.q_a_proj, self.q_a_layernorm, self.q_proj,
                                    self.kv_a_proj_with_mqa, self.kv_a_layernorm, self.o_proj)
                        if m is not None]

    # -- cache layout ----------------------------------------------------------

    def new_cache_layer(self, spec, device) -> dict:
        from ..model.cache import cache_base_shape, cache_dtype
        from ..ops.kv_quant import GROUP

        c, dr = self.kv_lora_rank, self.qk_rope_head_dim
        if spec.k_bits:
            n, t = cache_base_shape(spec, 1, c)[:2]
            return {"kv_q": torch.zeros((n, t, 1, c * spec.k_bits // 32), dtype=torch.int32,
                                        device=device),
                    "kv_s": torch.zeros((n, t, 1, c // GROUP), dtype=torch.bfloat16,
                                        device=device),
                    "k_pe": torch.zeros((n, t, 1, dr), dtype=torch.bfloat16, device=device)}
        return {"kv": torch.zeros(cache_base_shape(spec, 1, c + dr), dtype=cache_dtype(spec),
                                  device=device)}

    # -- loading -----------------------------------------------------------------

    def load(self, params: dict, device: torch.device) -> None:
        super().load(params, device)
        key = f"{self.key}.kv_b_proj.weight"
        H, dn, dv, c = self.num_q_heads, self.qk_nope_head_dim, self.v_head_dim, self.kv_lora_rank
        w = self.config.stc.get_tensor(key).to(torch.float32)
        if tuple(w.shape) != (H * (dn + dv), c):
            raise ValueError(f"{key}: shape {tuple(w.shape)}, expected {(H * (dn + dv), c)}")
        w = w.reshape(H, dn + dv, c)
        params[self.key] = {
            # (c, H, dn): folds the K up-projection into the query
            "w_uk": w[:, :dn].permute(2, 0, 1).contiguous().to(device=device, dtype=torch.bfloat16),
            # (c, H, dv): folds the V up-projection into the output
            "w_uv": w[:, dn:].permute(2, 0, 1).contiguous().to(device=device, dtype=torch.bfloat16),
        }

    # -- forward -----------------------------------------------------------------

    def _rope(self, x, sin, cos):
        return x if sin is None else self.rope.apply(x, sin, cos)

    def _project_q_eff(self, x, params: dict, ctx: ForwardCtx, sin, cos):
        """-> q_eff (B, S, H, c + dr) bf16: [q_nope @ W_UK | rope(q_pe)]."""
        B, S, _ = x.shape
        if self.q_a_proj is not None:
            qa = self.q_a_layernorm.forward(self.q_a_proj.forward(x, params, ctx), params, ctx)
            q = self.q_proj.forward(qa, params, ctx)
        else:
            q = self.q_proj.forward(x, params, ctx)
        q = q.reshape(B, S, self.num_q_heads, self.qk_head_dim)
        q_pe = self._rope(q[..., self.qk_nope_head_dim:], sin, cos)
        q_lat = head_product(q[..., :self.qk_nope_head_dim],
                             params[self.key]["w_uk"].permute(1, 2, 0))
        return torch.cat([q_lat, q_pe.float()], dim=-1).to(torch.bfloat16)

    def _project_kv_token(self, x, params: dict, ctx: ForwardCtx, sin, cos):
        """-> (B, S, c + dr) f32 cache rows [c_kv | rope(k_pe)]."""
        c = self.kv_lora_rank
        kv = self.kv_a_proj_with_mqa.forward(x, params, ctx)
        c_kv = self.kv_a_layernorm.forward(kv[..., :c], params, ctx)
        k_pe = self._rope(kv[..., c:][:, :, None, :], sin, cos)
        return torch.cat([c_kv.float(), k_pe[:, :, 0].float()], dim=-1)

    def forward(self, x, params: dict, ctx: ForwardCtx):
        B, S, _ = x.shape
        c = self.kv_lora_rank
        sin = cos = None
        if self.rope is not None and self.rope.style != RopeStyle.NONE:
            sin, cos = self.rope.sin_cos(ctx.positions)
        q_eff = self._project_q_eff(x, params, ctx, sin, cos)
        kv_tok = self._project_kv_token(x, params, ctx, sin, cos)
        if ctx.cache is None:
            k_eff = kv_tok[:, :, None, :].to(torch.bfloat16)
            o_lat = attend_dense(q_eff, k_eff, k_eff[..., :c], q_positions=ctx.positions,
                                 k_positions=ctx.positions, scale=self.sm_scale)
        else:
            layer = ctx.cache[self.key]
            if ctx.total_lens is None:
                ctx.total_lens = total_lens(ctx.positions, ctx.cache_seqlens, S)
            paged = ctx.attn_mode == "paged"
            if paged and ctx.page_index is None:
                ctx.page_index = page_index(ctx.positions, ctx.block_tables)
            self._cache_update(layer, kv_tok, ctx)
            o_lat = latent_attention(q_eff, layer, ctx.positions, ctx.total_lens, c,
                                     k_bits=ctx.k_bits, compand_a=ctx.compand_a,
                                     block_tables=ctx.block_tables if paged else None,
                                     rows=None if paged else ctx.cache_rows, scale=self.sm_scale)
        o = head_product(o_lat.to(torch.bfloat16), params[self.key]["w_uv"].permute(1, 0, 2))
        o = o.reshape(B, S, self.num_q_heads * self.v_head_dim).to(x.dtype)
        y = self.o_proj.forward(o, params, ctx)
        return y if self.out_dtype is None else y.to(self.out_dtype)

    def _cache_update(self, layer: dict, kv_tok, ctx: ForwardCtx) -> None:
        """Write the (B, S, c + dr) rows into the layer state in place, through
        the block tables (paged) or at [row, position] (linear: row b, or
        cache_rows[b])."""
        c = self.kv_lora_rank
        if ctx.attn_mode == "paged":
            rows, cols = ctx.page_index
        else:
            rows = (torch.arange(kv_tok.shape[0], device=kv_tok.device) if ctx.cache_rows is None
                    else ctx.cache_rows.long())[:, None]
            cols = ctx.positions.long()
        new = kv_tok[:, :, None, :]
        if ctx.k_bits:
            from ..ops.kv_quant import quantize_kv

            lat_q, lat_s = quantize_kv(new[..., :c], ctx.k_bits, ctx.compand_a)
            layer["kv_q"][rows, cols] = lat_q
            layer["kv_s"][rows, cols] = lat_s
            layer["k_pe"][rows, cols] = new[..., c:].to(layer["k_pe"].dtype)
        else:
            layer["kv"][rows, cols] = new.to(layer["kv"].dtype)
