"""MoE architectures: Mixtral and Qwen3-MoE
(counterpart of exllamav3_tpu/architectures/moe.py).

Llama blocks whose MLP is the block-sparse MLP (modules/block_sparse_mlp.py),
"std" routing (softmax, top k, renormalized when `norm_topk_prob`), every
layer MoE and no shared expert; Qwen3-MoE adds Qwen3's per-head q/k norms.
Dots1, ERNIE-4.5(-MoE) and MiniMax-M2 wait: they need shared experts or
norms that span the heads.
"""
from __future__ import annotations

import torch

from ..model.config import no_default
from ..modules.block_sparse_mlp import BlockSparseMLP
from .llama import LlamaConfig, LlamaModel


class MixtralConfig(LlamaConfig):
    arch_string = "MixtralForCausalLM"

    def __init__(self, directory: str, derived_model: dict | None = None, **kwargs):
        super().__init__(directory, derived_model or {"text": MixtralModel}, **kwargs)
        self.num_experts = self.read_cfg(int, ["num_local_experts", "num_experts"], no_default)
        self.num_experts_per_tok = self.read_cfg(int, "num_experts_per_tok", 2)
        self.norm_topk_prob = self.read_cfg(bool, "norm_topk_prob", True)
        self.moe_intermediate_size = self.read_cfg(
            int, ["moe_intermediate_size", "intermediate_size"], self.intermediate_size)


class MixtralModel(LlamaModel):
    mlp_key = "block_sparse_moe"
    router_key = "gate"
    expert_key = "experts.{expert_idx}"
    mlp_keys = ("w1", "w3", "w2")  # gate, up, down in Mixtral's naming

    def make_mlp(self, config, lk: str):
        kg, ku, kd = self.mlp_keys
        return BlockSparseMLP(
            config, f"{lk}.{self.mlp_key}",
            hidden_size=config.hidden_size,
            intermediate_size=config.moe_intermediate_size,
            num_experts=config.num_experts,
            num_experts_per_tok=config.num_experts_per_tok,
            key_gate=kg, key_up=ku, key_down=kd,
            key_routing_gate=self.router_key,
            key_expert=self.expert_key,
            norm_topk_prob=config.norm_topk_prob,
            out_dtype=torch.float32,
        )


class Qwen3MoeConfig(MixtralConfig):
    arch_string = "Qwen3MoeForCausalLM"

    def __init__(self, directory: str, **kwargs):
        super().__init__(directory, derived_model={"text": Qwen3MoeModel}, **kwargs)


class Qwen3MoeModel(MixtralModel):
    use_qk_norm = True
    mlp_key = "mlp"
    mlp_keys = ("gate_proj", "up_proj", "down_proj")
