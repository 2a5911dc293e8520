"""Synthetic EXL3 checkpoints for tests and the chip smoke run
(counterpart of exllamav3_tpu/conversion/synth.py: the Llama writer, and an
EXL3 writer for the MoE architectures, which the JAX package writes only as
dense bf16).

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
