"""Llama-family architecture (counterpart of exllamav3_tpu/architectures/llama.py).
Covers LlamaForCausalLM and the Mistral, Qwen2 and Qwen3 subclasses; Qwen3
adds per-head q/k RMSNorms. `LlamaModel.make_mlp` builds each block's MLP,
so that the MoE models (architectures/moe.py, and DeepSeek-V1 in
architectures/deepseek.py) swap in their block-sparse MLP."""
from __future__ import annotations

import torch

from ..model.config import Config, no_default
from ..model.model import Model
from ..modules import Attention, Embedding, GatedMLP, Linear, RMSNorm, TransformerBlock
from ..util.rope import RopeStyle


class LlamaConfig(Config):
    arch_string = "LlamaForCausalLM"

    def __init__(self, directory: str, derived_model: dict | None = None, **kwargs):
        super().__init__(directory, derived_model or {"text": LlamaModel}, **kwargs)
        self.head_dim = self.read_cfg(int, "head_dim", None)
        self.num_q_heads = self.read_cfg(int, "num_attention_heads", no_default)
        self.num_kv_heads = self.read_cfg(int, "num_key_value_heads", self.num_q_heads)
        if not self.head_dim:
            self.head_dim = self.hidden_size // self.num_q_heads
        self.intermediate_size = self.read_cfg(int, "intermediate_size", no_default)
        self.rms_norm_eps = self.read_cfg(float, "rms_norm_eps", no_default)
        self.num_hidden_layers = self.read_cfg(int, "num_hidden_layers", no_default)
        self.tie_word_embeddings = self.read_cfg(bool, "tie_word_embeddings", False)
        self.hidden_act = self.read_cfg(str, "hidden_act", "silu")
        self.rope_settings = self.read_rope_settings_default(RopeStyle.NEOX)


class LlamaModel(Model):
    use_qk_norm = False

    def __init__(self, config: LlamaConfig, key_prefix: str = "model",
                 head_key: str = "lm_head", **kwargs):
        super().__init__(config, **kwargs)
        self.modules += [Embedding(config, f"{key_prefix}.embed_tokens",
                                   config.vocab_size, config.hidden_size)]
        for idx in range(config.num_hidden_layers):
            lk = f"{key_prefix}.layers.{idx}"
            q_norm = k_norm = None
            if self.use_qk_norm:
                q_norm = RMSNorm(config, f"{lk}.self_attn.q_norm", config.rms_norm_eps,
                                 dim=config.head_dim)
                k_norm = RMSNorm(config, f"{lk}.self_attn.k_norm", config.rms_norm_eps,
                                 dim=config.head_dim)
            self.modules += [
                TransformerBlock(
                    config, lk, idx,
                    attn_norm=RMSNorm(config, f"{lk}.input_layernorm", config.rms_norm_eps),
                    attn=Attention(
                        config, f"{lk}.self_attn", idx,
                        hidden_size=config.hidden_size,
                        head_dim=config.head_dim,
                        num_q_heads=config.num_q_heads,
                        num_kv_heads=config.num_kv_heads,
                        rope_settings=config.rope_settings,
                        out_dtype=torch.float32,
                        q_norm=q_norm,
                        k_norm=k_norm,
                    ),
                    mlp_norm=RMSNorm(config, f"{lk}.post_attention_layernorm",
                                     config.rms_norm_eps),
                    mlp=self.make_mlp(config, lk, idx),
                )
            ]
        head_alt_key = None
        if config.tie_word_embeddings and not config.stc.has_tensor("lm_head.weight"):
            head_alt_key = f"{key_prefix}.embed_tokens"
        self.modules += [
            RMSNorm(config, f"{key_prefix}.norm", config.rms_norm_eps,
                    out_dtype=torch.bfloat16),
            Linear(config, head_key, config.hidden_size, config.vocab_size,
                   alt_key=head_alt_key, out_dtype=torch.float32),
        ]

    def make_mlp(self, config, lk: str, idx: int):
        return GatedMLP(config, f"{lk}.mlp", hidden_size=config.hidden_size,
                        intermediate_size=config.intermediate_size,
                        activation=config.hidden_act, out_dtype=torch.float32)


class MistralConfig(LlamaConfig):
    arch_string = "MistralForCausalLM"

    def __init__(self, directory: str, **kwargs):
        super().__init__(directory, derived_model={"text": LlamaModel}, **kwargs)
        self.assert_cfg(str, "hidden_act", "silu", optional=True)


class Qwen2Config(LlamaConfig):
    """Qwen2: Llama with q/k/v biases (loaded when present)."""

    arch_string = "Qwen2ForCausalLM"

    def __init__(self, directory: str, **kwargs):
        super().__init__(directory, derived_model={"text": LlamaModel}, **kwargs)


class Qwen3Config(LlamaConfig):
    arch_string = "Qwen3ForCausalLM"

    def __init__(self, directory: str, **kwargs):
        super().__init__(directory, derived_model={"text": Qwen3Model}, **kwargs)


class Qwen3Model(LlamaModel):
    use_qk_norm = True
