"""Gemma 2 / Gemma 3 text models (counterpart of
exllamav3_tpu/architectures/gemma.py; Gemma3ForConditionalGeneration and its
SigLIP tower wait).

Gemma's RMSNorms scale by (1 + weight); the embedding scales by
sqrt(hidden_size); each block wraps attention and MLP in sandwich norms
(post-attention and post-feedforward norms before the residual adds); the
softmax scale is query_pre_attn_scalar ** -0.5. Gemma-2 alternates sliding-
window layers (even layers slide) and softcaps the attention scores and the
final logits. Gemma-3 adds q/k norms, slides in all but every
`sliding_window_pattern`-th layer, and gives its two layer kinds two ropes:
sliding layers plain rope at rope_local_base_freq, global layers the
config's rope (linear x8 at 27B). The head is tied to the embedding through
`alt_key`, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from ..model.config import Config, no_default
from ..model.model import Model
from ..modules import Attention, Embedding, GatedMLP, Linear, RMSNorm, TransformerBlock
from ..util.rope import RopeSettings, RopeStyle


class Gemma2Config(Config):
    arch_string = "Gemma2ForCausalLM"

    def __init__(self, directory: str, derived_model: dict | None = None, **kwargs):
        super().__init__(directory, derived_model or {"text": Gemma2Model}, **kwargs)
        self.head_dim = self.read_cfg(int, "head_dim", 256)
        self.num_q_heads = self.read_cfg(int, "num_attention_heads", no_default)
        self.num_kv_heads = self.read_cfg(int, "num_key_value_heads", self.num_q_heads)
        self.intermediate_size = self.read_cfg(int, "intermediate_size", no_default)
        self.rms_norm_eps = self.read_cfg(float, "rms_norm_eps", 1e-6)
        self.num_hidden_layers = self.read_cfg(int, "num_hidden_layers", no_default)
        self.tie_word_embeddings = self.read_cfg(bool, "tie_word_embeddings", True)
        self.hidden_act = self.read_cfg(str, "hidden_act", "gelu_pytorch_tanh")
        self.attn_logit_softcapping = self.read_cfg(float, "attn_logit_softcapping", 50.0)
        self.final_logit_softcapping = self.read_cfg(float, "final_logit_softcapping", 30.0)
        self.sliding_window = self.read_cfg(int, "sliding_window", 4096)
        self.query_pre_attn_scalar = self.read_cfg(float, "query_pre_attn_scalar",
                                                   self.head_dim)
        self.rope_settings = self.read_rope_settings_default(RopeStyle.NEOX,
                                                             head_dim=self.head_dim)

    def layer_is_sliding(self, idx: int) -> bool:
        return idx % 2 == 0


class Gemma2Model(Model):
    use_qk_norm = False

    def __init__(self, config, key_prefix: str = "model", head_key: str = "lm_head",
                 **kwargs):
        super().__init__(config, **kwargs)
        h, eps = config.hidden_size, config.rms_norm_eps

        def norm(key, **kw):
            return RMSNorm(config, key, eps, constant_bias=1.0, **kw)

        self.modules += [Embedding(config, f"{key_prefix}.embed_tokens", config.vocab_size, h,
                                   scale=math.sqrt(h))]
        for idx in range(config.num_hidden_layers):
            lk = f"{key_prefix}.layers.{idx}"
            sliding = config.layer_is_sliding(idx)
            q_norm = k_norm = None
            if self.use_qk_norm:
                q_norm = norm(f"{lk}.self_attn.q_norm", dim=config.head_dim)
                k_norm = norm(f"{lk}.self_attn.k_norm", dim=config.head_dim)
            self.modules += [
                TransformerBlock(
                    config, lk, idx,
                    attn_norm=norm(f"{lk}.input_layernorm"),
                    attn=Attention(
                        config, f"{lk}.self_attn", idx,
                        hidden_size=h,
                        head_dim=config.head_dim,
                        num_q_heads=config.num_q_heads,
                        num_kv_heads=config.num_kv_heads,
                        rope_settings=self.layer_rope_settings(config, sliding),
                        out_dtype=torch.float32,
                        q_norm=q_norm,
                        k_norm=k_norm,
                        sm_scale=config.query_pre_attn_scalar ** -0.5,
                        sliding_window=config.sliding_window if sliding else 0,
                        logit_softcap=config.attn_logit_softcapping,
                    ),
                    attn_post_norm=norm(f"{lk}.post_attention_layernorm"),
                    mlp_norm=norm(f"{lk}.pre_feedforward_layernorm"),
                    mlp=GatedMLP(config, f"{lk}.mlp", hidden_size=h,
                                 intermediate_size=config.intermediate_size,
                                 activation=config.hidden_act, out_dtype=torch.float32),
                    mlp_post_norm=norm(f"{lk}.post_feedforward_layernorm"),
                )
            ]
        self.modules += [
            norm(f"{key_prefix}.norm", out_dtype=torch.bfloat16),
            Linear(config, head_key, h, config.vocab_size,
                   alt_key=f"{key_prefix}.embed_tokens" if config.tie_word_embeddings else None,
                   softcap=config.final_logit_softcapping, out_dtype=torch.float32),
        ]

    @staticmethod
    def layer_rope_settings(config, sliding: bool) -> RopeSettings:
        return config.rope_settings


class Gemma3Config(Gemma2Config):
    arch_string = "Gemma3ForCausalLM"

    def __init__(self, directory: str, **kwargs):
        super().__init__(directory, derived_model={"text": Gemma3Model}, **kwargs)
        self.attn_logit_softcapping = 0.0
        self.final_logit_softcapping = 0.0
        self.sliding_window_pattern = self.read_cfg(int, "sliding_window_pattern", 6)
        self.rope_local_base_freq = self.read_cfg(float, "rope_local_base_freq", 10000.0)

    def layer_is_sliding(self, idx: int) -> bool:
        return (idx + 1) % self.sliding_window_pattern != 0


class Gemma3Model(Gemma2Model):
    use_qk_norm = True

    @staticmethod
    def layer_rope_settings(config, sliding: bool) -> RopeSettings:
        if sliding:
            return RopeSettings(head_dim=config.head_dim, rope_theta=config.rope_local_base_freq,
                                rope_style=RopeStyle.NEOX,
                                max_position_embeddings=config.max_position_embeddings)
        return config.rope_settings
