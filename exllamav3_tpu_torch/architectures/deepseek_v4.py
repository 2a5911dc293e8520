"""DeepSeek-V4 (counterpart of exllamav3_tpu/architectures/deepseek_v4.py):
hybrid sparse attention, sliding / CSA / HCA by `compress_ratios`
(modules/dsv4_attn.py), mHC hyper-connection residual streams
(modules/hyperconnections.py), hash-routed MoE in the first
`num_hash_layers` and sqrt-softplus routing after, with one shared expert and
the clamped swiglu (`swiglu_limit`) in every expert, in DeepSeek's own tensor
names (layers.N.attn.wq_a, layers.N.hc_attn_fn, embed, head, norm).

The widths the JAX package reads with a default are its own defaults,
taken from the reference's config class. The DSpark MTP drafter
(`mtp.*`, DeepseekV4MTPModel in the JAX package) is not ported: a checkpoint
that carries it is refused.
"""
from __future__ import annotations

import torch

from ..model.config import Config, no_default
from ..model.model import Model
from ..modules import Embedding, GatedMLP, Linear, RMSNorm, TransformerBlock
from ..modules.block_sparse_mlp import BlockSparseMLP
from ..modules.dsv4_attn import DSV4Attention
from ..modules.hyperconnections import ExpandStreams, HyperConnection, HyperHead

_RATIO_TO_TYPE = {0: "sliding", 4: "csa", 128: "hca"}


class DeepseekV4Config(Config):
    arch_string = "DeepseekV4ForCausalLM"

    def __init__(self, directory: str, derived_model: dict | None = None, **kwargs):
        super().__init__(directory, derived_model or {"text": DeepseekV4Model}, **kwargs)
        if any(k.startswith("mtp.") for k in self.stc.keys()):
            raise NotImplementedError(
                f"{directory}: the checkpoint carries DeepSeek-V4's DSpark MTP drafter "
                "(mtp.*), which the port does not read yet")
        self.num_q_heads = self.read_cfg(int, "num_attention_heads", no_default)
        self.num_kv_heads = self.read_cfg(int, "num_key_value_heads", 1)
        if self.num_kv_heads != 1:
            raise ValueError("DeepseekV4: expected shared-KV MQA (num_key_value_heads == 1)")
        self.head_dim = self.read_cfg(int, "head_dim", 512)
        self.qk_rope_head_dim = self.read_cfg(int, "qk_rope_head_dim", 64)
        self.q_lora_rank = self.read_cfg(int, "q_lora_rank", no_default)
        self.o_groups = self.read_cfg(int, "o_groups", 8)
        self.o_lora_rank = self.read_cfg(int, "o_lora_rank", 1024)
        self.sliding_window = self.read_cfg(int, "sliding_window", 128)
        self.index_n_heads = self.read_cfg(int, "index_n_heads", 64)
        self.index_head_dim = self.read_cfg(int, "index_head_dim", 128)
        self.index_topk = self.read_cfg(int, "index_topk", 512)

        self.num_hidden_layers = self.read_cfg(int, "num_hidden_layers", no_default)
        ratios = self.read_cfg(list, "compress_ratios", None)
        if ratios is not None:
            self.layer_types = [_RATIO_TO_TYPE[r] for r in ratios[: self.num_hidden_layers]]
        else:
            inter = ["csa" if i % 2 else "hca" for i in range(max(self.num_hidden_layers - 2, 0))]
            self.layer_types = ["hca"] * min(self.num_hidden_layers, 2) + inter
        self.compress_rate_csa = self.read_cfg(int, "compress_rate_csa", 4)
        self.compress_rate_hca = self.read_cfg(int, "compress_rate_hca", 128)

        self.hc_mult = self.read_cfg(int, "hc_mult", 4)
        self.hc_sinkhorn_iters = self.read_cfg(int, "hc_sinkhorn_iters", 20)
        self.hc_eps = self.read_cfg(float, "hc_eps", 1e-6)

        self.assert_cfg(str, "scoring_func", "sqrtsoftplus", optional=True)
        self.assert_cfg(str, "topk_method", "noaux_tc", optional=True)
        self.moe_intermediate_size = self.read_cfg(int, "moe_intermediate_size", no_default)
        self.num_experts = self.read_cfg(int, "n_routed_experts", no_default)
        self.num_experts_per_tok = self.read_cfg(int, "num_experts_per_tok", no_default)
        self.num_shared_experts = self.read_cfg(int, "n_shared_experts", 1)
        self.num_hash_layers = self.read_cfg(int, "num_hash_layers", 3)
        self.routed_scaling_factor = self.read_cfg(float, "routed_scaling_factor", 1.0)
        self.swiglu_limit = self.read_cfg(float, "swiglu_limit", 10.0)

        self.rms_norm_eps = self.read_cfg(float, "rms_norm_eps", 1e-6)
        self.rope_theta = self.read_cfg(float, "rope_theta", 10000.0)
        self.compress_rope_theta = self.read_cfg(float, "compress_rope_theta", 160000.0)
        self.rope_scaling = self.read_cfg(dict, "rope_scaling", None)
        self.tie_word_embeddings = self.read_cfg(bool, "tie_word_embeddings", False)


class DeepseekV4Model(Model):
    def __init__(self, config: DeepseekV4Config, **kwargs):
        super().__init__(config, **kwargs)
        c = config
        self.modules += [Embedding(c, "embed", c.vocab_size, c.hidden_size),
                         ExpandStreams(c, "hc_expand", c.hc_mult)]
        for idx in range(c.num_hidden_layers):
            lt = c.layer_types[idx]
            key = f"layers.{idx}"
            attn = DSV4Attention(
                c, f"{key}.attn", idx, lt, hidden_size=c.hidden_size, num_q_heads=c.num_q_heads,
                head_dim=c.head_dim, rope_head_dim=c.qk_rope_head_dim, q_lora_rank=c.q_lora_rank,
                o_groups=c.o_groups, o_lora_rank=c.o_lora_rank, sliding_window=c.sliding_window,
                compress_rate={"sliding": None, "csa": c.compress_rate_csa,
                               "hca": c.compress_rate_hca}[lt],
                index_n_heads=c.index_n_heads, index_head_dim=c.index_head_dim,
                index_topk=c.index_topk, rope_theta=c.rope_theta,
                compress_rope_theta=c.compress_rope_theta, rope_scaling=c.rope_scaling,
                rms_norm_eps=c.rms_norm_eps)
            shared = GatedMLP(c, f"{key}.ffn.shared_experts", hidden_size=c.hidden_size,
                              intermediate_size=c.moe_intermediate_size * c.num_shared_experts,
                              key_up="w3", key_gate="w1", key_down="w2",
                              act_clamp=c.swiglu_limit)
            mlp = BlockSparseMLP(
                c, f"{key}.ffn", hidden_size=c.hidden_size,
                intermediate_size=c.moe_intermediate_size, num_experts=c.num_experts,
                num_experts_per_tok=c.num_experts_per_tok, key_up="w3", key_gate="w1",
                key_down="w2", key_routing_gate="gate", key_e_score_bias="gate.bias",
                key_tid2eid="gate.tid2eid" if idx < c.num_hash_layers else None,
                act_clamp=c.swiglu_limit, routing="sqrtsp",
                routed_scaling_factor=c.routed_scaling_factor, shared_experts=shared)
            hc = [HyperConnection(c, f"{key}.hc_{tag}", c.hc_mult, c.hidden_size,
                                  c.hc_sinkhorn_iters, c.hc_eps, c.rms_norm_eps)
                  for tag in ("attn", "ffn")]
            self.modules.append(TransformerBlock(
                c, key, idx, attn_norm=RMSNorm(c, f"{key}.attn_norm", c.rms_norm_eps), attn=attn,
                mlp_norm=RMSNorm(c, f"{key}.ffn_norm", c.rms_norm_eps), mlp=mlp,
                attn_hc=hc[0], mlp_hc=hc[1]))
        head_alt_key = "embed" if (c.tie_word_embeddings
                                   and not c.stc.has_tensor("head.weight")) else None
        self.modules += [
            HyperHead(c, "hc_head", c.hc_mult, c.rms_norm_eps, c.hc_eps),
            RMSNorm(c, "norm", c.rms_norm_eps, out_dtype=torch.bfloat16),
            Linear(c, "head", c.hidden_size, c.vocab_size, alt_key=head_alt_key,
                   out_dtype=torch.float32),
        ]
