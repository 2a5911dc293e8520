"""The DeepSeek serving path as a whole against the JAX package on the CPU:
tiny dense-bf16 checkpoints from the JAX package's writer shaped like
DeepSeek-V2-Lite (MLA without a q LoRA, softmax "group_greedy" routing, one
dense layer, two shared experts, yarn rope), like DeepSeek-V3 (a q LoRA,
sigmoid "ds3" routing over two expert groups with a correction bias, a
routed scaling factor) and like DeepSeek-V1 (Llama attention, "std_norm"
routing, shared experts), and the port's EXL3 writer, each package loading
it itself.

EXL3_TPU_MOE is set for each package where it runs ("interpret" for the JAX
package, "selected" for the port), as in tests/test_torch_moe_path.py, whose
docstring explains the tolerances: a router logit whose last bf16 bit
differs picks another expert for one token, so logits are held at 90% of
the positions to 1e-2 of their range, with top-1 agreement of 90%."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.conversion.synth import write_synth_dense_for_arch
from exllamav3_tpu.generator.generator import Generator as JGenerator
from exllamav3_tpu.generator.job import Job as JJob
from exllamav3_tpu.generator.sampler import GreedySampler as JGreedy
from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import InferParams as JInferParams
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu_torch.architectures.deepseek import (DeepseekV1Model, DeepseekV2Model,
                                                        DeepseekV3Model)
from exllamav3_tpu_torch.conversion.synth import deepseek_v2_lite_cfg, write_tiny_deepseek_exl3
from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.modules.block_sparse_mlp import BlockSparseMLP
from exllamav3_tpu_torch.modules.mla_attn import MLAttention
from exllamav3_tpu_torch.util.params import params_from_jax

IDS = np.random.default_rng(0).integers(0, 500, size=(2, 24)).astype(np.int32)
BASE = dict(bos_token_id=1, eos_token_id=2, vocab_size=512, hidden_size=128,
            intermediate_size=256, max_position_embeddings=4096, num_attention_heads=4,
            num_hidden_layers=2, rms_norm_eps=1e-5, rope_theta=10000.0, torch_dtype="bfloat16",
            hidden_act="silu", n_routed_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=64, first_k_dense_replace=1)
MLA = dict(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=32)
CFGS = {
    # DeepSeek-V2-Lite's structure at tests/test_mla.py's widths
    "v2lite": dict(BASE, **MLA, architectures=["DeepseekV2ForCausalLM"], n_shared_experts=2,
                   scoring_func="softmax", n_group=1, topk_group=1, norm_topk_prob=False,
                   rope_scaling=deepseek_v2_lite_cfg()["rope_scaling"]),
    "v3": dict(BASE, **MLA, architectures=["DeepseekV3ForCausalLM"], q_lora_rank=48,
               n_shared_experts=1, scoring_func="sigmoid", n_group=2, topk_group=1,
               norm_topk_prob=True, routed_scaling_factor=1.5),
    "v1": dict(BASE, architectures=["DeepseekForCausalLM"], num_key_value_heads=4,
               n_shared_experts=2, norm_topk_prob=False),
}


def _jax_env():
    os.environ["EXL3_TPU_MOE"] = "interpret"


def _port_env():
    os.environ["EXL3_TPU_MOE"] = "selected"


@pytest.fixture(autouse=True)
def moe_env(monkeypatch):
    monkeypatch.setenv("EXL3_TPU_MOE", "selected")  # restored after each test


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """{name: (JAX model, port model on JAX's parameters)}, bf16 weights."""
    out = {}
    for name, cfg in CFGS.items():
        d = str(tmp_path_factory.mktemp("torch_deepseek") / name)
        write_synth_dense_for_arch(d, cfg, seed=7)
        jm = JModel.from_config(JConfig.from_directory(d))
        jm.load()
        pm = Model.from_config(Config.from_directory(
            d, infer_params=InferParams(linear_mode="bf16")), device="cpu")
        params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
        out[name] = (jm, pm)
    return out


def _close_up_to_flips(got, ref, tag=""):
    err = np.abs(got - ref).max(-1).reshape(-1) / (ref.max() - ref.min())
    top1 = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert np.isfinite(got).all()
    assert (err <= 1e-2).mean() >= 0.9, (tag, np.sort(err)[-5:])
    assert top1 >= 0.9, (tag, top1)


def test_architectures_build_as_jax_does(pairs):
    """The three classes, their blocks and their carried parameters: MLA with
    W_UK / W_UV, a dense first layer, shared experts, the routing modes."""
    kinds = {"v2lite": (DeepseekV2Model, "group_greedy"), "v3": (DeepseekV3Model, "ds3"),
             "v1": (DeepseekV1Model, "std_norm")}
    for name, (cls, routing) in kinds.items():
        jm, pm = pairs[name]
        assert type(pm) is cls
        jp = jax.tree.map(np.asarray, jm.params)
        assert set(pm.params) == set(jp), name
        moes = [m for m in pm.root.walk() if isinstance(m, BlockSparseMLP)]
        assert len(moes) == 1 and moes[0].routing == routing
        assert moes[0].shared_experts is not None
        mlas = [m for m in pm.root.walk() if isinstance(m, MLAttention)]
        assert len(mlas) == (0 if name == "v1" else 2)
        for m in mlas:
            for n in ("w_uk", "w_uv"):
                assert np.array_equal(pm.params[m.key][n].float().numpy(),
                                      jp[m.key][n].astype(np.float32))
    v2 = pairs["v2lite"][1].config
    # sm_scale folds yarn's mscale_all_dim in twice: 64^-0.5 * (0.1 * 0.707 * ln 40 + 1)^2
    assert abs(v2.sm_scale - 64 ** -0.5 * (0.1 * 0.707 * np.log(40) + 1) ** 2) < 1e-9


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("S", [24, 4], ids=["grouped", "selected"])
def test_forward_simple_matches_jax(pairs, name, S):
    """(2, 24) runs the grouped experts, (2, 4) the selected ones."""
    jm, pm = pairs[name]
    _jax_env()
    ref = np.asarray(jm.forward_simple(IDS[:, :S]))
    _port_env()
    _close_up_to_flips(pm.forward_simple(IDS[:, :S]).numpy(), ref, (name, S))


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("k_bits", [0, 4])
def test_paged_step_matches_jax(pairs, name, k_bits, monkeypatch):
    """A paged prefill chunk and two decode steps against JAX's jitted paged
    step over a bf16 cache (JAX's dense attention) and a 4-bit cache (the
    latent's codes and scales, or per-head K/V for V1; JAX's kernel in
    interpret mode, whose function the port's plain version computes: JAX's
    dense path rounds the dequantized latent to bf16)."""
    monkeypatch.setenv("EXL3_TPU_ATTN", "interpret" if k_bits else "dense")
    jm, pm = pairs[name]
    step = jax.jit(jm.step_fn("paged", k_bits=k_bits, v_bits=k_bits))
    jcache = JCache(jm, JCacheSpec(layout="paged", num_pages=4, k_bits=k_bits, v_bits=k_bits))
    cache = Cache(pm, CacheSpec(num_pages=4, k_bits=k_bits, v_bits=k_bits))
    bt = np.array([[1, 2, 0]], np.int32)
    ids = np.random.default_rng(1).integers(0, 512, size=(1, 42)).astype(np.int32)
    S = 40
    chunks = [(ids[:, :S], np.arange(S, dtype=np.int32)[None], np.array([0], np.int32))]
    chunks += [(ids[:, p:p + 1], np.array([[p]], np.int32), np.array([p], np.int32))
               for p in (S, S + 1)]
    for x, pos, seqlens in chunks:
        _jax_env()
        ref, jcache.state = step(jm.params, x, jcache.state, pos, seqlens, bt)
        _port_env()
        got = pm.forward(x, cache, pos, seqlens, bt).numpy()
        _close_up_to_flips(got, np.asarray(ref), (name, k_bits, pos[0, 0]))


def test_greedy_generator_matches_jax(pairs):
    """Six concurrent greedy jobs sharing a 256-token prefix through both
    generators on the V2-Lite-shaped model: the same prefix reuse and the
    same tokens up to near-ties. Where a job parts ways, the port's token is
    JAX's first or second choice over the same context, within 5e-2 of the
    logit range of the best."""
    jm, pm = pairs["v2lite"]
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 512, 256)
    prompts = [np.concatenate([prefix, rng.integers(0, 512, n)]) for n in (5, 23, 40, 61, 9, 30)]
    waves = [prompts[:4], prompts[4:]]

    def run(gen, job_cls, sampler):
        out, idx = {}, 0
        for wave in waves:
            jobs = [job_cls(np.asarray(p), max_new_tokens=6, sampler=sampler, identifier=idx + i)
                    for i, p in enumerate(wave)]
            idx += len(wave)
            gen.enqueue(jobs)
            while gen.num_remaining_jobs():
                for r in gen.iterate():
                    if r["stage"] == "finished":
                        out[r["identifier"]] = (list(r["new_tokens"]), r["cached_tokens"])
        return out

    _jax_env()
    ref = run(JGenerator(jm, JCache(jm, JCacheSpec(layout="paged", num_pages=24)),
                         max_chunk_size=64), JJob, JGreedy())
    _port_env()
    got = run(Generator(pm, Cache(pm, CacheSpec(num_pages=24)), max_chunk_size=64), Job,
              GreedySampler())
    assert [got[i][1] for i in range(6)] == [ref[i][1] for i in range(6)]
    assert all(got[i][1] == 256 for i in (4, 5))  # prefix page reused
    same = [got[i][0] == ref[i][0] for i in range(6)]
    assert sum(same) >= 4
    _jax_env()
    for i in range(6):
        if same[i]:
            continue
        at = [a == b for a, b in zip(got[i][0], ref[i][0])].index(False)
        context = np.concatenate([prompts[i], got[i][0][:at]]).astype(np.int32)
        logits = np.asarray(jm.forward_simple(context[None]))[0, -1]
        order = np.argsort(-logits)
        assert got[i][0][at] in order[:2]
        assert logits[order[0]] - logits[got[i][0][at]] <= 5e-2 * (logits.max() - logits.min())


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_writer_loads_in_both(tmp_path, mode):
    """write_tiny_deepseek_exl3 (V2-Lite's structure: EXL3 projections,
    experts and head; a bf16 kv_a projection and dense MLP, whose widths EXL3
    cannot hold; bf16 kv_b and router) loads in both packages, each on its
    own, and their logits agree up to expert flips."""
    d = write_tiny_deepseek_exl3(str(tmp_path / "ds"), seed=3)
    _jax_env()
    jm = JModel.from_config(JConfig.from_directory(d, infer_params=JInferParams(linear_mode=mode)))
    jm.load()
    ref = np.asarray(jm.forward_simple(IDS))
    _port_env()
    pm = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode=mode)),
                           device="cpu")
    pm.load()
    p = pm.params
    assert "weight" in p["model.layers.0.self_attn.kv_a_proj_with_mqa"]  # 576-wide at full size
    want = "weight_q" if mode == "int8" else "weight"
    assert want in p["model.layers.1.self_attn.q_proj"] and want in p["lm_head"]
    assert want in p["model.layers.1.mlp.shared_experts.down_proj"]
    assert p["model.layers.1.mlp"]["w_gate_proj"].shape == (8, 256, 128)
    _close_up_to_flips(pm.forward_simple(IDS).numpy(), ref, mode)
