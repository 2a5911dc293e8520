"""DeepSeek family (counterpart of exllamav3_tpu/architectures/deepseek.py):
V1 (DeepSeek-MoE: Llama attention, softmax top-k MoE with shared experts),
V2 / V2-Lite and V3 / R1 (multi-head latent attention, modules/mla_attn.py,
over the latent cache).

The V2 and V3 classes are one model: MLA blocks, the first
`first_k_dense_replace` with a dense gated MLP and the rest block-sparse with
shared experts. Routing is "ds3" for sigmoid scoring (V3) and "group_greedy"
for softmax (V2). The rope is GPTJ (interleaved) style on the rope slice
only; with yarn scaling, the mscale of `mscale_all_dim` folds into the
softmax scale and the rope's attention factor is the ratio of the two
mscales. V3.2's sparse attention (DSA) is not ported yet.
"""
from __future__ import annotations

import torch

from ..model.config import Config, no_default
from ..model.model import Model
from ..modules import Embedding, GatedMLP, Linear, RMSNorm, TransformerBlock
from ..modules.block_sparse_mlp import BlockSparseMLP
from ..modules.mla_attn import MLAttention
from ..util.rope import RopeStyle, yarn_mscale
from .llama import LlamaConfig, LlamaModel


class DeepseekV3Config(Config):
    arch_string = "DeepseekV3ForCausalLM"

    def __init__(self, directory: str, derived_model: dict | None = None, **kwargs):
        super().__init__(directory, derived_model or {"text": DeepseekV3Model}, **kwargs)
        self.num_q_heads = self.read_cfg(int, "num_attention_heads", no_default)
        self.q_lora_rank = self.read_cfg(int, "q_lora_rank", None)
        self.kv_lora_rank = self.read_cfg(int, "kv_lora_rank", no_default)
        self.qk_nope_head_dim = self.read_cfg(int, "qk_nope_head_dim", no_default)
        self.qk_rope_head_dim = self.read_cfg(int, "qk_rope_head_dim", no_default)
        self.v_head_dim = self.read_cfg(int, "v_head_dim", no_default)
        self.qk_head_dim = self.qk_nope_head_dim + self.qk_rope_head_dim

        self.intermediate_size = self.read_cfg(int, "intermediate_size", no_default)
        self.moe_intermediate_size = self.read_cfg(int, "moe_intermediate_size", no_default)
        self.num_shared_experts = self.read_cfg(int, "n_shared_experts", 1)
        self.num_experts = self.read_cfg(int, "n_routed_experts", no_default)
        self.num_experts_per_tok = self.read_cfg(int, "num_experts_per_tok", 8)
        self.first_k_dense_replace = self.read_cfg(int, "first_k_dense_replace", 3)
        self.routed_scaling_factor = self.read_cfg(float, "routed_scaling_factor", 1.0)
        self.n_group = self.read_cfg(int, "n_group", 1)
        self.topk_group = self.read_cfg(int, "topk_group", 1)
        self.norm_topk_prob = self.read_cfg(bool, "norm_topk_prob", True)
        self.scoring_func = self.read_cfg(str, "scoring_func", "sigmoid")

        self.rms_norm_eps = self.read_cfg(float, "rms_norm_eps", no_default)
        self.num_hidden_layers = self.read_cfg(int, "num_hidden_layers", no_default)
        self.tie_word_embeddings = self.read_cfg(bool, "tie_word_embeddings", False)
        self.hidden_act = self.read_cfg(str, "hidden_act", "silu")

        # the rope covers the rope slice only; yarn's mscale_all_dim folds
        # into the softmax scale
        self.rope_settings = self.read_rope_settings_default(RopeStyle.GPTJ,
                                                             head_dim=self.qk_rope_head_dim)
        self.rope_settings.yarn_mscale_ratio = True
        self.sm_scale = self.qk_head_dim ** -0.5
        rs = self.rope_settings.rope_scaling
        if rs is not None and rs.get("mscale_all_dim", 0):
            ms = yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
            self.sm_scale *= ms * ms

    def routing_mode(self) -> str:
        return "ds3" if self.scoring_func == "sigmoid" else "group_greedy"


class DeepseekV2Config(DeepseekV3Config):
    arch_string = "DeepseekV2ForCausalLM"

    def __init__(self, directory: str, **kwargs):
        super().__init__(directory, derived_model={"text": DeepseekV2Model}, **kwargs)


class DeepseekV3Model(Model):
    def __init__(self, config: DeepseekV3Config, **kwargs):
        super().__init__(config, **kwargs)
        self.modules += [Embedding(config, "model.embed_tokens", config.vocab_size,
                                   config.hidden_size)]
        for idx in range(config.num_hidden_layers):
            lk = f"model.layers.{idx}"
            attn = MLAttention(
                config, f"{lk}.self_attn", idx,
                hidden_size=config.hidden_size,
                num_q_heads=config.num_q_heads,
                kv_lora_rank=config.kv_lora_rank,
                qk_nope_head_dim=config.qk_nope_head_dim,
                qk_rope_head_dim=config.qk_rope_head_dim,
                v_head_dim=config.v_head_dim,
                q_lora_rank=config.q_lora_rank,
                rope_settings=config.rope_settings,
                sm_scale=config.sm_scale,
                rms_norm_eps=config.rms_norm_eps,
                out_dtype=torch.float32,
            )
            if idx < config.first_k_dense_replace:
                mlp = GatedMLP(config, f"{lk}.mlp", hidden_size=config.hidden_size,
                               intermediate_size=config.intermediate_size,
                               activation=config.hidden_act, out_dtype=torch.float32)
            else:
                mlp = _moe(config, lk, config.routing_mode(), n_group=config.n_group,
                           topk_group=config.topk_group,
                           routed_scaling_factor=config.routed_scaling_factor)
            self.modules += [
                TransformerBlock(
                    config, lk, idx,
                    attn_norm=RMSNorm(config, f"{lk}.input_layernorm", config.rms_norm_eps),
                    attn=attn,
                    mlp_norm=RMSNorm(config, f"{lk}.post_attention_layernorm",
                                     config.rms_norm_eps),
                    mlp=mlp,
                )
            ]
        head_alt_key = None
        if config.tie_word_embeddings and not config.stc.has_tensor("lm_head.weight"):
            head_alt_key = "model.embed_tokens"
        self.modules += [
            RMSNorm(config, "model.norm", config.rms_norm_eps, out_dtype=torch.bfloat16),
            Linear(config, "lm_head", config.hidden_size, config.vocab_size,
                   alt_key=head_alt_key, out_dtype=torch.float32),
        ]


class DeepseekV2Model(DeepseekV3Model):
    pass


def _moe(config, lk: str, routing: str, **kw) -> BlockSparseMLP:
    """A block-sparse MLP with DeepSeek's shared experts (one gated MLP of
    n_shared_experts times the expert width), where the config has them."""
    shared = None
    if config.num_shared_experts:
        shared = GatedMLP(config, f"{lk}.mlp.shared_experts", hidden_size=config.hidden_size,
                          intermediate_size=config.moe_intermediate_size
                          * config.num_shared_experts,
                          activation=config.hidden_act)
    return BlockSparseMLP(
        config, f"{lk}.mlp",
        hidden_size=config.hidden_size,
        intermediate_size=config.moe_intermediate_size,
        num_experts=config.num_experts,
        num_experts_per_tok=config.num_experts_per_tok,
        key_routing_gate="gate",
        activation=config.hidden_act,
        routing=routing,
        norm_topk_prob=config.norm_topk_prob,
        shared_experts=shared,
        out_dtype=torch.float32,
        **kw,
    )


class DeepseekV1Config(LlamaConfig):
    """DeepSeek-MoE 16B: Llama attention, softmax top-k MoE with shared
    experts after `first_k_dense_replace` dense layers."""

    arch_string = "DeepseekForCausalLM"

    def __init__(self, directory: str, **kwargs):
        super().__init__(directory, derived_model={"text": DeepseekV1Model}, **kwargs)
        self.moe_intermediate_size = self.read_cfg(int, "moe_intermediate_size",
                                                   self.intermediate_size)
        self.num_shared_experts = self.read_cfg(int, "n_shared_experts", 0)
        self.num_experts = self.read_cfg(int, "n_routed_experts", 0)
        self.num_experts_per_tok = self.read_cfg(int, "num_experts_per_tok", 6)
        self.first_k_dense_replace = self.read_cfg(int, "first_k_dense_replace", 1)
        self.norm_topk_prob = self.read_cfg(bool, "norm_topk_prob", False)


class DeepseekV1Model(LlamaModel):
    def make_mlp(self, config, lk: str, idx: int):
        if not config.num_experts or idx < config.first_k_dense_replace:
            return super().make_mlp(config, lk, idx)
        return _moe(config, lk, "std_norm")
