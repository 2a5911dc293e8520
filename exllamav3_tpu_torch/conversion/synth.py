"""Synthetic EXL3 checkpoints for tests and the chip smoke run
(counterpart of exllamav3_tpu/conversion/synth.py, Llama writer only).

Any random bit stream is a valid tail-biting trellis, so a format-correct
EXL3 checkpoint of any size can be fabricated from a seed. Given the same
seed and configuration this writes the same bytes as the JAX package's
writer.
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
