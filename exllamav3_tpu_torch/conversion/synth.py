"""Synthetic EXL3 checkpoints for tests and the chip smoke run
(counterpart of exllamav3_tpu/conversion/synth.py: the Llama writer, and EXL3
writers for the MoE, DeepSeek and Gemma architectures, which the JAX package
writes only as dense bf16).

Any random bit stream is a valid tail-biting trellis, so a format-correct
EXL3 checkpoint of any size can be fabricated from a seed. Given the same
seed and configuration the Llama writer writes the same bytes as the JAX
package's writer.
"""
from __future__ import annotations

import functools
import json
import math
import os
import shutil

import numpy as np

from ..loader.safetensors import f32_to_bf16_u16, save_file


# codebook name -> (marker tensor suffix, the codebook's multiplier)
CODEBOOK_MARKERS = {"3inst": None, "mcg": ("mcg", 0xCBAC1FED), "mul1": ("mul1", 0x83DCD12D)}


def _atomic_checkpoint(write_fn):
    """Write into a temporary sibling directory, then move the files into
    place with config.json last: "config.json exists" marks a complete
    checkpoint."""

    @functools.wraps(write_fn)
    def wrapped(directory: str, *args, **kwargs):
        tmp = f"{directory}.partial{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            write_fn(tmp, *args, **kwargs)
            os.makedirs(directory, exist_ok=True)
            names = [n for n in os.listdir(tmp) if n != "config.json"]
            for n in names + ["config.json"]:
                os.replace(os.path.join(tmp, n), os.path.join(directory, n))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        return directory

    return wrapped


def tiny_llama_cfg(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                   num_q_heads=4, num_kv_heads=2, head_dim=None, rope_scaling=None,
                   tie_word_embeddings=False, arch="LlamaForCausalLM", extra=None):
    cfg = {
        "architectures": [arch],
        "model_type": "llama",
        "bos_token_id": 1,
        "eos_token_id": 2,
        "hidden_act": "silu",
        "hidden_size": hidden_size,
        "intermediate_size": intermediate_size,
        "max_position_embeddings": 8192,
        "num_attention_heads": num_q_heads,
        "num_hidden_layers": num_layers,
        "num_key_value_heads": num_kv_heads,
        "rms_norm_eps": 1e-5,
        "rope_theta": 10000.0,
        "tie_word_embeddings": tie_word_embeddings,
        "torch_dtype": "bfloat16",
        "vocab_size": vocab_size,
    }
    if head_dim:
        cfg["head_dim"] = head_dim
    if rope_scaling:
        cfg["rope_scaling"] = rope_scaling
    if extra:
        cfg.update(extra)
    return cfg


def synth_exl3_linear(rng, in_features, out_features, K=4, out_std=0.02):
    """One EXL3 tensor group with ~N(0, out_std^2) effective weights."""
    tk, tn = in_features // 16, out_features // 16
    trellis = rng.integers(-32768, 32768, size=(tk, tn, 16 * K)).astype(np.int16)
    su = np.sign(rng.standard_normal(in_features)).astype(np.float16)
    sv = (np.sign(rng.standard_normal(out_features)) * out_std).astype(np.float16)
    return {"trellis": trellis, "suh": su, "svh": sv}


@_atomic_checkpoint
def write_tiny_llama_exl3(directory: str, cfg: dict | None = None, K: int = 4,
                          seed: int = 0, quant_lm_head: bool = True,
                          codebook: str = "3inst"):
    """Write a synthetic EXL3-quantized Llama-style checkpoint. `codebook`
    ("3inst", "mcg" or "mul1") adds the marker tensor (`<key>.mcg` /
    `<key>.mul1`, the codebook's multiplier as a scalar int32, as the JAX
    package's quantizer writes it) that tells a loader
    which codebook decodes the linear; the other tensors do not change."""
    if codebook not in CODEBOOK_MARKERS:
        raise ValueError(f"unknown codebook {codebook!r}")
    os.makedirs(directory, exist_ok=True)
    cfg = cfg or tiny_llama_cfg()
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)

    rng = np.random.default_rng(seed)
    h = cfg["hidden_size"]
    inter = cfg["intermediate_size"]
    nq = cfg["num_attention_heads"]
    nkv = cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or h // nq
    vocab = cfg["vocab_size"]

    tensors: dict[str, np.ndarray] = {}
    bf16_keys = set()

    def add_bf16(key, arr):
        tensors[key] = f32_to_bf16_u16(arr.astype(np.float32))
        bf16_keys.add(key)

    def add_exl3(key, k_in, n_out, out_std):
        for sk, t in synth_exl3_linear(rng, k_in, n_out, K, out_std).items():
            tensors[f"{key}.{sk}"] = t
        if CODEBOOK_MARKERS[codebook] is not None:
            suffix, mult = CODEBOOK_MARKERS[codebook]
            tensors[f"{key}.{suffix}"] = np.array(mult, dtype=np.uint32).view(np.int32)

    add_bf16("model.embed_tokens.weight",
             rng.standard_normal((vocab, h)).astype(np.float32) * 0.02)
    for i in range(cfg["num_hidden_layers"]):
        lk = f"model.layers.{i}"
        add_bf16(f"{lk}.input_layernorm.weight", np.ones(h, np.float32))
        add_bf16(f"{lk}.post_attention_layernorm.weight", np.ones(h, np.float32))
        s = 1.0 / math.sqrt(h)
        add_exl3(f"{lk}.self_attn.q_proj", h, nq * hd, s)
        add_exl3(f"{lk}.self_attn.k_proj", h, nkv * hd, s)
        add_exl3(f"{lk}.self_attn.v_proj", h, nkv * hd, s)
        add_exl3(f"{lk}.self_attn.o_proj", nq * hd, h, s * 0.5)
        add_exl3(f"{lk}.mlp.gate_proj", h, inter, s)
        add_exl3(f"{lk}.mlp.up_proj", h, inter, s)
        add_exl3(f"{lk}.mlp.down_proj", inter, h, s * 0.5)
    add_bf16("model.norm.weight", np.ones(h, np.float32))
    if not cfg.get("tie_word_embeddings"):
        if quant_lm_head:
            add_exl3("lm_head", h, vocab, 1.0 / math.sqrt(h))
        else:
            add_bf16("lm_head.weight", rng.standard_normal((vocab, h)).astype(np.float32) * 0.02)

    save_file(tensors, os.path.join(directory, "model.safetensors"), bf16_keys=bf16_keys)
    return directory


def tiny_moe_cfg(arch="Qwen3MoeForCausalLM", vocab_size=512, hidden_size=256,
                 moe_intermediate_size=128, num_layers=2, num_q_heads=4, num_kv_heads=2,
                 head_dim=64, num_experts=8, num_experts_per_tok=2, intermediate_size=None,
                 rms_norm_eps=1e-6, rope_theta=1e6):
    """A Qwen3-MoE (or, with arch="MixtralForCausalLM", Mixtral) config.json:
    every layer MoE, no shared expert, norm_topk_prob."""
    cfg = tiny_llama_cfg(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=intermediate_size or moe_intermediate_size,
                         num_layers=num_layers, num_q_heads=num_q_heads,
                         num_kv_heads=num_kv_heads, head_dim=head_dim, arch=arch)
    cfg.update(rms_norm_eps=rms_norm_eps, rope_theta=rope_theta, num_experts_per_tok=num_experts_per_tok,
               norm_topk_prob=True)
    if arch == "MixtralForCausalLM":
        cfg.update(model_type="mixtral", num_local_experts=num_experts,
                   intermediate_size=moe_intermediate_size)
    else:
        cfg.update(model_type="qwen3_moe", num_experts=num_experts,
                   moe_intermediate_size=moe_intermediate_size, decoder_sparse_step=1,
                   mlp_only_layers=[])
    return cfg


@_atomic_checkpoint
def write_tiny_moe_exl3(directory: str, cfg: dict | None = None, K: int = 4, seed: int = 0):
    """Write a synthetic EXL3 Qwen3-MoE or Mixtral checkpoint: EXL3
    attention, experts and lm_head; a bf16 router `.weight` (E, h) whose
    logits have unit spread; for Qwen3-MoE q/k norm weights drawn from
    [0.8, 1.2]. One shard a layer (`model-layer<NNN>.safetensors`), the
    embedding and the head in shards of their own, so that a writer or a
    reader holds one layer at a time."""
    os.makedirs(directory, exist_ok=True)
    cfg = cfg or tiny_moe_cfg()
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    mixtral = cfg["architectures"][0] == "MixtralForCausalLM"
    mlp_key, names = (("block_sparse_moe", ("w1", "w3", "w2")) if mixtral
                      else ("mlp", ("gate_proj", "up_proj", "down_proj")))
    E = cfg.get("num_local_experts") or cfg["num_experts"]
    inter = cfg.get("moe_intermediate_size") or cfg["intermediate_size"]
    rng = np.random.default_rng(seed)
    h = cfg["hidden_size"]
    nq = cfg["num_attention_heads"]
    nkv = cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or h // nq
    vocab = cfg["vocab_size"]
    s = 1.0 / math.sqrt(h)

    tensors: dict[str, np.ndarray] = {}
    bf16_keys = set()

    def add_bf16(key, arr):
        tensors[key] = f32_to_bf16_u16(arr.astype(np.float32))
        bf16_keys.add(key)

    def add_exl3(key, k_in, n_out, out_std):
        for sk, t in synth_exl3_linear(rng, k_in, n_out, K, out_std).items():
            tensors[f"{key}.{sk}"] = t

    def add_experts(prefix, name, k_in, n_out, out_std):
        """E EXL3 linears at once: any bit stream is a trellis, so the codes
        are raw generator words"""
        tk, tn = k_in // 16, n_out // 16
        words = rng.bit_generator.random_raw(E * tk * tn * 16 * K // 4)
        trellis = words.view(np.int16).reshape(E, tk, tn, 16 * K)
        su = np.sign(rng.standard_normal((E, k_in))).astype(np.float16)
        sv = (np.sign(rng.standard_normal((E, n_out))) * out_std).astype(np.float16)
        for e in range(E):
            key = f"{prefix}.experts.{e}.{name}"
            tensors[key + ".trellis"] = trellis[e]
            tensors[key + ".suh"] = su[e]
            tensors[key + ".svh"] = sv[e]

    def flush(name):
        save_file(tensors, os.path.join(directory, name), bf16_keys=bf16_keys)
        tensors.clear()
        bf16_keys.clear()

    add_bf16("model.embed_tokens.weight",
             rng.standard_normal((vocab, h)).astype(np.float32) * 0.02)
    flush("model-embed.safetensors")
    for i in range(cfg["num_hidden_layers"]):
        lk = f"model.layers.{i}"
        add_bf16(f"{lk}.input_layernorm.weight", np.ones(h, np.float32))
        add_bf16(f"{lk}.post_attention_layernorm.weight", np.ones(h, np.float32))
        add_exl3(f"{lk}.self_attn.q_proj", h, nq * hd, s)
        add_exl3(f"{lk}.self_attn.k_proj", h, nkv * hd, s)
        add_exl3(f"{lk}.self_attn.v_proj", h, nkv * hd, s)
        add_exl3(f"{lk}.self_attn.o_proj", nq * hd, h, s * 0.5)
        if not mixtral:
            add_bf16(f"{lk}.self_attn.q_norm.weight", rng.uniform(0.8, 1.2, hd))
            add_bf16(f"{lk}.self_attn.k_norm.weight", rng.uniform(0.8, 1.2, hd))
        prefix = f"{lk}.{mlp_key}"
        add_bf16(f"{prefix}.gate.weight", rng.standard_normal((E, h)) * s)
        add_experts(prefix, names[0], h, inter, s)
        add_experts(prefix, names[1], h, inter, s)
        add_experts(prefix, names[2], inter, h, s * 0.5)
        flush(f"model-layer{i:03d}.safetensors")
    add_bf16("model.norm.weight", np.ones(h, np.float32))
    add_exl3("lm_head", h, vocab, s)
    flush("model-head.safetensors")
    return directory


def deepseek_v2_lite_cfg(**overrides) -> dict:
    """deepseek-ai/DeepSeek-V2-Lite's config.json numbers (MLA without a q
    LoRA, kv_lora_rank 512, 64 routed experts of width 1408 with 6 a token and
    2 shared, one dense layer of width 10944, yarn rope x40), with
    `overrides` on top (a tiny test model, or fewer layers)."""
    cfg = {
        "architectures": ["DeepseekV2ForCausalLM"],
        "model_type": "deepseek_v2",
        "bos_token_id": 100000,
        "eos_token_id": 100001,
        "hidden_act": "silu",
        "hidden_size": 2048,
        "intermediate_size": 10944,
        "kv_lora_rank": 512,
        "max_position_embeddings": 163840,
        "moe_intermediate_size": 1408,
        "moe_layer_freq": 1,
        "first_k_dense_replace": 1,
        "n_group": 1,
        "n_routed_experts": 64,
        "n_shared_experts": 2,
        "norm_topk_prob": False,
        "num_attention_heads": 16,
        "num_experts_per_tok": 6,
        "num_hidden_layers": 27,
        "num_key_value_heads": 16,
        "q_lora_rank": None,
        "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64,
        "rms_norm_eps": 1e-6,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                         "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                         "type": "yarn"},
        "rope_theta": 10000,
        "routed_scaling_factor": 1.0,
        "scoring_func": "softmax",
        "tie_word_embeddings": False,
        "topk_group": 1,
        "topk_method": "greedy",
        "torch_dtype": "bfloat16",
        "v_head_dim": 128,
        "vocab_size": 102400,
    }
    cfg.update(overrides)
    return cfg


@_atomic_checkpoint
def write_tiny_deepseek_exl3(directory: str, cfg: dict | None = None, K: int = 4, seed: int = 0):
    """Write a synthetic EXL3 DeepSeek-V2 / V3 checkpoint: EXL3 attention
    projections (q_proj, or q_a_proj and q_b_proj with a q LoRA;
    kv_a_proj_with_mqa; o_proj), dense MLPs, shared and routed experts and
    lm_head; bf16 `kv_b_proj.weight` (H * (dn + dv), c), which the MLA module
    reads as it is, norms drawn from [0.8, 1.2], and a bf16 router (E, h)
    whose logits have unit spread (V3's sigmoid scoring adds an expert-choice
    bias). EXL3 rotates both sides of a weight by 128-point Hadamards, so a
    linear whose input or output width is no multiple of 128 is written as a
    bf16 `.weight` instead (DeepSeek-V2-Lite's kv_a_proj_with_mqa, 2048 x 576,
    and its dense MLP of width 10944). One shard a layer, the embedding and
    the head in shards of their own."""
    os.makedirs(directory, exist_ok=True)
    cfg = cfg or deepseek_v2_lite_cfg(num_hidden_layers=2, vocab_size=512, hidden_size=256,
                                      intermediate_size=320, moe_intermediate_size=128,
                                      num_attention_heads=4, num_key_value_heads=4,
                                      kv_lora_rank=128, qk_nope_head_dim=32,
                                      qk_rope_head_dim=64, v_head_dim=32, n_routed_experts=8,
                                      num_experts_per_tok=2)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    rng = np.random.default_rng(seed)
    h, vocab, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    c, dn, dr, dv = (cfg["kv_lora_rank"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                     cfg["v_head_dim"])
    qlr = cfg.get("q_lora_rank")
    E, inter = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    shared = cfg.get("n_shared_experts") or 0
    s = 1.0 / math.sqrt(h)

    tensors: dict[str, np.ndarray] = {}
    bf16_keys = set()

    def add_bf16(key, arr):
        tensors[key] = f32_to_bf16_u16(arr.astype(np.float32))
        bf16_keys.add(key)

    def add_exl3(key, k_in, n_out, out_std):
        if k_in % 128 or n_out % 128:
            add_bf16(f"{key}.weight", rng.standard_normal((n_out, k_in)) * out_std)
            return
        for sk, t in synth_exl3_linear(rng, k_in, n_out, K, out_std).items():
            tensors[f"{key}.{sk}"] = t

    def add_mlp(prefix, width):
        add_exl3(f"{prefix}.gate_proj", h, width, s)
        add_exl3(f"{prefix}.up_proj", h, width, s)
        add_exl3(f"{prefix}.down_proj", width, h, s * 0.5)

    def add_experts(prefix, name, k_in, n_out, out_std):
        """E EXL3 linears at once: any bit stream is a trellis, so the codes
        are raw generator words"""
        tk, tn = k_in // 16, n_out // 16
        words = rng.bit_generator.random_raw(E * tk * tn * 16 * K // 4)
        trellis = words.view(np.int16).reshape(E, tk, tn, 16 * K)
        su = np.sign(rng.standard_normal((E, k_in))).astype(np.float16)
        sv = (np.sign(rng.standard_normal((E, n_out))) * out_std).astype(np.float16)
        for e in range(E):
            key = f"{prefix}.experts.{e}.{name}"
            tensors[key + ".trellis"] = trellis[e]
            tensors[key + ".suh"] = su[e]
            tensors[key + ".svh"] = sv[e]

    def flush(name):
        save_file(tensors, os.path.join(directory, name), bf16_keys=bf16_keys)
        tensors.clear()
        bf16_keys.clear()

    add_bf16("model.embed_tokens.weight",
             rng.standard_normal((vocab, h)).astype(np.float32) * 0.02)
    flush("model-embed.safetensors")
    for i in range(cfg["num_hidden_layers"]):
        lk = f"model.layers.{i}"
        add_bf16(f"{lk}.input_layernorm.weight", np.ones(h, np.float32))
        add_bf16(f"{lk}.post_attention_layernorm.weight", np.ones(h, np.float32))
        ak = f"{lk}.self_attn"
        if qlr:
            add_exl3(f"{ak}.q_a_proj", h, qlr, s)
            add_bf16(f"{ak}.q_a_layernorm.weight", rng.uniform(0.8, 1.2, qlr))
            add_exl3(f"{ak}.q_b_proj", qlr, H * (dn + dr), 1.0 / math.sqrt(qlr))
        else:
            add_exl3(f"{ak}.q_proj", h, H * (dn + dr), s)
        add_exl3(f"{ak}.kv_a_proj_with_mqa", h, c + dr, s)
        add_bf16(f"{ak}.kv_a_layernorm.weight", rng.uniform(0.8, 1.2, c))
        add_bf16(f"{ak}.kv_b_proj.weight", rng.standard_normal((H * (dn + dv), c)) / math.sqrt(c))
        add_exl3(f"{ak}.o_proj", H * dv, h, s * 0.5)
        if i < cfg.get("first_k_dense_replace", 0):
            add_mlp(f"{lk}.mlp", cfg["intermediate_size"])
        else:
            prefix = f"{lk}.mlp"
            add_bf16(f"{prefix}.gate.weight", rng.standard_normal((E, h)) * s)
            if cfg.get("scoring_func", "sigmoid") == "sigmoid":
                add_bf16(f"{prefix}.gate.e_score_correction_bias", rng.standard_normal(E) * 0.05)
            add_experts(prefix, "gate_proj", h, inter, s)
            add_experts(prefix, "up_proj", h, inter, s)
            add_experts(prefix, "down_proj", inter, h, s * 0.5)
            if shared:
                add_mlp(f"{prefix}.shared_experts", inter * shared)
        flush(f"model-layer{i:03d}.safetensors")
    add_bf16("model.norm.weight", np.ones(h, np.float32))
    add_exl3("lm_head", h, vocab, s)
    flush("model-head.safetensors")
    return directory


def gemma3_27b_cfg(**overrides) -> dict:
    """google/gemma-3-27b-it's text_config numbers (62 layers, 5 sliding to 1
    global, window 1024, 32 q / 16 kv heads of 128, linear x8 rope on the
    global layers, tied embeddings, vocabulary 262208), with `overrides` on
    top (a tiny test model, fewer layers, or Gemma-2's architecture and
    softcaps)."""
    cfg = {
        "architectures": ["Gemma3ForCausalLM"],
        "model_type": "gemma3_text",
        "bos_token_id": 2,
        "eos_token_id": 1,
        "head_dim": 128,
        "hidden_activation": "gelu_pytorch_tanh",
        "hidden_size": 5376,
        "intermediate_size": 21504,
        "max_position_embeddings": 131072,
        "num_attention_heads": 32,
        "num_hidden_layers": 62,
        "num_key_value_heads": 16,
        "query_pre_attn_scalar": 168,
        "rms_norm_eps": 1e-6,
        "rope_local_base_freq": 10000.0,
        "rope_scaling": {"factor": 8.0, "rope_type": "linear"},
        "rope_theta": 1000000.0,
        "sliding_window": 1024,
        "sliding_window_pattern": 6,
        "tie_word_embeddings": True,
        "torch_dtype": "bfloat16",
        "vocab_size": 262208,
    }
    cfg.update(overrides)
    return cfg


@_atomic_checkpoint
def write_tiny_gemma_exl3(directory: str, cfg: dict | None = None, K: int = 4, seed: int = 0):
    """Write a synthetic EXL3 Gemma-2 or Gemma-3 checkpoint: EXL3 q/k/v/o and
    gate/up/down projections (any random bit stream is a trellis, so the codes
    are raw generator words), norm weights w ~ N(0, 0.1^2) that Gemma's norms
    apply as 1 + w (the q/k norms with Gemma-3 only), and the bf16 embedding,
    which the tied head reads. The default is a 4-layer Gemma-3 at h = 256
    with a sliding window of 16 on layers 0 and 2 (`sliding_window_pattern`
    2) and linear x8 rope on the global layers. One shard a layer, the
    embedding in a shard of its own."""
    os.makedirs(directory, exist_ok=True)
    cfg = cfg or gemma3_27b_cfg(hidden_size=256, intermediate_size=512, num_hidden_layers=4,
                                num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                                query_pre_attn_scalar=64, sliding_window=16,
                                sliding_window_pattern=2, vocab_size=512)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    gemma3 = cfg["architectures"][0] == "Gemma3ForCausalLM"
    rng = np.random.default_rng(seed)
    h, inter, vocab = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    nq, nkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    s = 1.0 / math.sqrt(h)

    tensors: dict[str, np.ndarray] = {}
    bf16_keys = set()

    def add_bf16(key, arr):
        tensors[key] = f32_to_bf16_u16(arr.astype(np.float32))
        bf16_keys.add(key)

    def add_exl3(key, k_in, n_out, out_std):
        words = rng.bit_generator.random_raw(k_in * n_out * K // 64)
        tensors[key + ".trellis"] = words.view(np.int16).reshape(k_in // 16, n_out // 16, 16 * K)
        tensors[key + ".suh"] = np.sign(rng.standard_normal(k_in)).astype(np.float16)
        tensors[key + ".svh"] = (np.sign(rng.standard_normal(n_out)) * out_std).astype(np.float16)

    def add_norm(key, dim):
        add_bf16(key + ".weight", rng.standard_normal(dim) * 0.1)

    def flush(name):
        save_file(tensors, os.path.join(directory, name), bf16_keys=bf16_keys)
        tensors.clear()
        bf16_keys.clear()

    # the embedding in f32 blocks of rows, straight into bf16 (262208 x 5376
    # at 27B: one f64 draw would hold 11 GB)
    emb = np.empty((vocab, h), np.uint16)
    for r in range(0, vocab, 8192):
        n = min(8192, vocab - r)
        emb[r: r + n] = f32_to_bf16_u16(rng.standard_normal((n, h), dtype=np.float32)
                                        * np.float32(0.02))
    tensors["model.embed_tokens.weight"] = emb
    bf16_keys.add("model.embed_tokens.weight")
    flush("model-embed.safetensors")
    for i in range(cfg["num_hidden_layers"]):
        lk = f"model.layers.{i}"
        for name in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            add_norm(f"{lk}.{name}", h)
        ak = f"{lk}.self_attn"
        add_exl3(f"{ak}.q_proj", h, nq * hd, s)
        add_exl3(f"{ak}.k_proj", h, nkv * hd, s)
        add_exl3(f"{ak}.v_proj", h, nkv * hd, s)
        add_exl3(f"{ak}.o_proj", nq * hd, h, s * 0.5)
        if gemma3:
            add_norm(f"{ak}.q_norm", hd)
            add_norm(f"{ak}.k_norm", hd)
        add_exl3(f"{lk}.mlp.gate_proj", h, inter, s)
        add_exl3(f"{lk}.mlp.up_proj", h, inter, s)
        add_exl3(f"{lk}.mlp.down_proj", inter, h, s * 0.5)
        flush(f"model-layer{i:03d}.safetensors")
    add_norm("model.norm", h)
    flush("model-norm.safetensors")
    return directory


def deepseek_v4_cfg(**overrides) -> dict:
    """A DeepSeek-V4 config.json at full width, with `overrides` on top (a
    tiny test model, fewer layers). The repository holds no published
    DeepSeek-V4 config.json, so the numbers come from two sources: the widths
    DeepseekV4Config reads with a default (the JAX package's, from the
    reference's config class: head_dim 512 with a 64-wide rope, one kv head,
    8 output groups of rank 1024, window 128, an indexer of 64 heads of 128
    with top 512, compress rates 4 and 128, 4 mHC streams with 20 Sinkhorn
    iterations, 1 shared expert, swiglu_limit 10, rope theta 1e4 and
    compress theta 1.6e5), and for the rest deepseek-ai/DeepSeek-V3's
    config.json (hidden 7168, 128 q heads, q_lora_rank 1536, 256 routed
    experts of 2048 with 8 a token and a routed scale of 2.5, vocab 129280,
    61 layers, rms eps 1e-6). The first two layers are HCA and the rest
    alternate HCA and CSA (the JAX package's default pattern), the first 3
    hash-routed."""
    cfg = {
        "architectures": ["DeepseekV4ForCausalLM"],
        "model_type": "deepseek_v4",
        "bos_token_id": 0,
        "eos_token_id": 1,
        "hidden_size": 7168,
        "max_position_embeddings": 163840,
        "num_attention_heads": 128,
        "num_key_value_heads": 1,
        "num_hidden_layers": 61,
        "head_dim": 512,
        "qk_rope_head_dim": 64,
        "q_lora_rank": 1536,
        "o_groups": 8,
        "o_lora_rank": 1024,
        "sliding_window": 128,
        "index_n_heads": 64,
        "index_head_dim": 128,
        "index_topk": 512,
        "compress_rate_csa": 4,
        "compress_rate_hca": 128,
        "hc_mult": 4,
        "hc_sinkhorn_iters": 20,
        "moe_intermediate_size": 2048,
        "n_routed_experts": 256,
        "num_experts_per_tok": 8,
        "n_shared_experts": 1,
        "num_hash_layers": 3,
        "routed_scaling_factor": 2.5,
        "scoring_func": "sqrtsoftplus",
        "topk_method": "noaux_tc",
        "swiglu_limit": 10.0,
        "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0,
        "compress_rope_theta": 160000.0,
        "tie_word_embeddings": False,
        "torch_dtype": "bfloat16",
        "vocab_size": 129280,
    }
    cfg.update(overrides)
    if "compress_ratios" not in cfg:
        n = cfg["num_hidden_layers"]
        cfg["compress_ratios"] = [128] * min(n, 2) + [4 if i % 2 else 128 for i in range(n - 2)]
    return cfg


@_atomic_checkpoint
def write_tiny_deepseek_v4_exl3(directory: str, cfg: dict | None = None, K: int = 4,
                                seed: int = 0):
    """Write a synthetic DeepSeek-V4 checkpoint in the JAX package's tensor
    names and draw order (conversion/synth.py::write_synth_dense_for_arch
    there): EXL3 linears where both widths are multiples of 128 (EXL3's
    Hadamards; the codes raw generator words), bf16 `.weight` otherwise
    (`indexer.weights_proj`, 7168 x 64), a bf16 router with its selection
    bias (`gate.bias`), the hash table `gate.tid2eid` (vocab, k) int32 of the
    first num_hash_layers layers, sinks, each compressor's `ape` and the mHC
    tensors (`hc_*_fn`, `_base`, `_scale`). A model whose linears all have a
    width off the multiples of 128 (the JAX package's tiny test model) gets
    the same tensors, byte for byte, as the JAX writer writes for it. The
    default is that tiny model. One shard a layer, the embedding and the head
    in shards of their own."""
    os.makedirs(directory, exist_ok=True)
    cfg = cfg or deepseek_v4_cfg(
        vocab_size=256, hidden_size=64, num_attention_heads=4, num_hidden_layers=3,
        rms_norm_eps=1e-5, head_dim=32, qk_rope_head_dim=8, q_lora_rank=32, o_groups=2,
        o_lora_rank=16, sliding_window=8, index_n_heads=4, index_head_dim=16, index_topk=4,
        compress_ratios=[0, 4, 128], compress_rate_hca=8, hc_sinkhorn_iters=5,
        moe_intermediate_size=32, n_routed_experts=4, num_experts_per_tok=2,
        num_hash_layers=1, routed_scaling_factor=1.5, max_position_embeddings=4096)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    rng = np.random.default_rng(seed)
    h, vocab, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    D, qlr = cfg["head_dim"], cfg["q_lora_rank"]
    G, olr = cfg["o_groups"], cfg["o_lora_rank"]
    Hi, Di = cfg["index_n_heads"], cfg["index_head_dim"]
    E, k, inter = cfg["n_routed_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
    hc = cfg["hc_mult"]
    rates = {0: None, 4: cfg["compress_rate_csa"], 128: cfg["compress_rate_hca"]}  # by ratio code

    tensors: dict[str, np.ndarray] = {}
    bf16_keys = set()

    def add(key, arr):
        tensors[key] = f32_to_bf16_u16(arr.astype(np.float32))
        bf16_keys.add(key)

    def linear(key, k_in, n_out):
        scale = 1.0 / math.sqrt(k_in)
        if k_in % 128 or n_out % 128:
            add(key + ".weight", rng.standard_normal((n_out, k_in)) * scale)
            return
        words = rng.bit_generator.random_raw(k_in * n_out * K // 64)
        tensors[key + ".trellis"] = words.view(np.int16).reshape(k_in // 16, n_out // 16, 16 * K)
        tensors[key + ".suh"] = np.sign(rng.standard_normal(k_in)).astype(np.float16)
        tensors[key + ".svh"] = (np.sign(rng.standard_normal(n_out)) * scale).astype(np.float16)

    def flush(name):
        save_file(tensors, os.path.join(directory, name), bf16_keys=bf16_keys)
        tensors.clear()
        bf16_keys.clear()

    # the embedding in f32 blocks of rows where it is large (one f64 draw of
    # 129280 x 7168 would hold 7.4 GB); one draw, as the JAX writer's, else
    if vocab * h <= 1 << 24:
        add("embed.weight", rng.standard_normal((vocab, h)) * 0.02)
    else:
        emb = np.empty((vocab, h), np.uint16)
        for r in range(0, vocab, 8192):
            n = min(8192, vocab - r)
            emb[r: r + n] = f32_to_bf16_u16(rng.standard_normal((n, h), dtype=np.float32)
                                            * np.float32(0.02))
        tensors["embed.weight"] = emb
        bf16_keys.add("embed.weight")
    flush("model-embed.safetensors")
    for i in range(cfg["num_hidden_layers"]):
        lk, ak = f"layers.{i}", f"layers.{i}.attn"
        code = cfg["compress_ratios"][i]
        m, csa = rates[code], code == 4
        pw = 2 * D if csa else D
        add(f"{lk}.attn_norm.weight", np.ones(h))
        add(f"{ak}.attn_sink", rng.standard_normal(H) * 0.5)
        if m:
            add(f"{ak}.compressor.ape", rng.standard_normal((m, pw)) * 0.3)
        if csa:
            add(f"{ak}.indexer.compressor.ape", rng.standard_normal((m, 2 * Di)) * 0.3)
        linear(f"{ak}.wq_a", h, qlr)
        add(f"{ak}.q_norm.weight", np.ones(qlr))
        linear(f"{ak}.wq_b", qlr, H * D)
        linear(f"{ak}.wkv", h, D)
        add(f"{ak}.kv_norm.weight", np.ones(D))
        for g in range(G):
            linear(f"{ak}.wo_a.slice.{g}", H * D // G, olr)
        linear(f"{ak}.wo_b", G * olr, h)
        if csa:
            linear(f"{ak}.indexer.wq_b", qlr, Hi * Di)
            linear(f"{ak}.indexer.weights_proj", h, Hi)
        if m:
            linear(f"{ak}.compressor.wkv", h, pw)
            linear(f"{ak}.compressor.wgate", h, pw)
            add(f"{ak}.compressor.norm.weight", np.ones(D))
        if csa:
            linear(f"{ak}.indexer.compressor.wkv", h, 2 * Di)
            linear(f"{ak}.indexer.compressor.wgate", h, 2 * Di)
            add(f"{ak}.indexer.compressor.norm.weight", np.ones(Di))
        fk = f"{lk}.ffn"
        add(f"{lk}.ffn_norm.weight", np.ones(h))
        for e in range(E):
            linear(f"{fk}.experts.{e}.w1", h, inter)
            linear(f"{fk}.experts.{e}.w3", h, inter)
            linear(f"{fk}.experts.{e}.w2", inter, h)
        add(f"{fk}.gate.bias", rng.standard_normal(E) * 0.05)
        if i < cfg.get("num_hash_layers", 3):
            tensors[f"{fk}.gate.tid2eid"] = rng.integers(0, E, size=(vocab, k)).astype(np.int32)
        add(f"{fk}.gate.weight", rng.standard_normal((E, h)) * (1.0 / math.sqrt(h)))
        si = inter * cfg.get("n_shared_experts", 1)
        linear(f"{fk}.shared_experts.w3", h, si)
        linear(f"{fk}.shared_experts.w1", h, si)
        linear(f"{fk}.shared_experts.w2", si, h)
        for tag in ("attn", "ffn"):
            add(f"{lk}.hc_{tag}_fn", rng.standard_normal(((2 + hc) * hc, hc * h)) * 0.02)
            add(f"{lk}.hc_{tag}_base", rng.standard_normal((2 + hc) * hc) * 0.1)
            add(f"{lk}.hc_{tag}_scale", rng.uniform(0.5, 1.5, 3))
        flush(f"model-layer{i:03d}.safetensors")
    add("hc_head_fn", rng.standard_normal((hc, hc * h)) * 0.02)
    add("hc_head_base", rng.standard_normal(hc) * 0.1)
    add("hc_head_scale", rng.uniform(0.5, 1.5, hc))
    add("norm.weight", np.ones(h))
    linear("head", h, vocab)
    flush("model-head.safetensors")
    return directory
