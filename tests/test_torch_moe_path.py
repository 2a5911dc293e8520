"""The MoE serving path as a whole against the JAX package on the CPU: a tiny
synthetic Qwen3-MoE EXL3 checkpoint from the port's writer (2 layers, h=256,
8 experts of width 128, top 2, 4 q / 2 kv heads of 64, per-head q/k norms,
vocab 512), a tiny dense Mixtral from the JAX package's writer (h=128), and a
tiny dense Qwen3 with q/k norms.

EXL3_TPU_MOE is set for each package where it runs: "interpret" for the JAX
package (its selected-expert Pallas kernel in interpret mode, as on the TPU)
and "selected" for the port (the kernel's plain version on the CPU), so that
both take the same body for each step.

Whole-model logits: one bf16 residual value that rounds the other way in the
two packages (f32 sums in another order) can move a router logit by its last
bf16 bit and so pick another expert for one token at one layer. That token's
logits then move by up to ~0.3 of their range, and later tokens of its
sequence, which attend to it, by ~1e-3. So the logit checks hold 90% of the
positions to 1e-2 of the range and top-1 agreement to 90%, and the MoE block
alone is held to 1e-4 on identical inputs."""
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
from exllamav3_tpu.modules.block_sparse_mlp import BlockSparseMLP as JMoE
from exllamav3_tpu.modules.module import ForwardCtx as JCtx
from exllamav3_tpu_torch.conversion.synth import (tiny_llama_cfg, tiny_moe_cfg,
                                                  write_tiny_llama_exl3, write_tiny_moe_exl3)
from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
from exllamav3_tpu_torch.loader.safetensors import f32_to_bf16_u16, save_file
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.modules.block_sparse_mlp import BlockSparseMLP
from exllamav3_tpu_torch.modules.module import ForwardCtx
from exllamav3_tpu_torch.util.params import params_from_jax

IDS = np.random.default_rng(0).integers(0, 256, size=(2, 24)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def bf16_q():
    """JAX's dense paged path, which it takes on the CPU, rounds q to bf16
    while the port's takes q in f32: feed the port the same rounded q."""
    import exllamav3_tpu_torch.modules.attn as pattn

    orig = pattn.paged_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pattn, "paged_attention",
                   lambda q, *a, **kw: orig(q.to(torch.bfloat16).float(), *a, **kw))
        yield


def _jax_env():
    os.environ["EXL3_TPU_MOE"] = "interpret"


def _port_env():
    os.environ["EXL3_TPU_MOE"] = "selected"


@pytest.fixture(autouse=True)
def moe_env(monkeypatch):
    monkeypatch.setenv("EXL3_TPU_MOE", "selected")  # restored after each test


@pytest.fixture(scope="module")
def qwen_ckpt(tmp_path_factory):
    """The port's Qwen3-MoE writer, plus an expert-choice bias on layer 0's
    router (which "std" routing does not read, and both packages load)."""
    d = write_tiny_moe_exl3(str(tmp_path_factory.mktemp("torch_moe") / "qwen3moe"), seed=3)
    bias = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    save_file({"model.layers.0.mlp.gate.e_score_correction_bias": bias},
              os.path.join(d, "extra.safetensors"))
    return d


@pytest.fixture(scope="module")
def mixtral_ckpt(tmp_path_factory):
    cfg = dict(architectures=["MixtralForCausalLM"], bos_token_id=1, eos_token_id=2,
               vocab_size=256, hidden_size=128, intermediate_size=128,
               max_position_embeddings=2048, num_attention_heads=4, num_key_value_heads=2,
               num_hidden_layers=2, rms_norm_eps=1e-5, rope_theta=10000.0,
               torch_dtype="bfloat16", head_dim=32, hidden_act="silu", num_local_experts=8,
               num_experts_per_tok=2)
    d = str(tmp_path_factory.mktemp("torch_moe") / "mixtral")
    write_synth_dense_for_arch(d, cfg, seed=5)
    return d


def _jax_model(d, mode):
    m = JModel.from_config(JConfig.from_directory(d, infer_params=JInferParams(linear_mode=mode)))
    m.load()
    return m


def _port_model(d, mode, **ip):
    return Model.from_config(Config.from_directory(
        d, infer_params=InferParams(linear_mode=mode, **ip)), device="cpu")


@pytest.fixture(scope="module")
def pairs(qwen_ckpt, mixtral_ckpt):
    """{name: (JAX model, port model on JAX's parameters)}."""
    out = {}
    for name, d, mode in (("qwen3moe", qwen_ckpt, "int8"), ("mixtral", mixtral_ckpt, "bf16")):
        jm = _jax_model(d, mode)
        pm = _port_model(d, mode)
        params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
        out[name] = (jm, pm)
    return out


def _close_up_to_flips(got, ref, tag=""):
    err = np.abs(got - ref).max(-1).reshape(-1) / (ref.max() - ref.min())
    top1 = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert np.isfinite(got).all()
    assert (err <= 1e-2).mean() >= 0.9, (tag, np.sort(err)[-5:])
    assert top1 >= 0.9, (tag, top1)


def _moe(model, cls):
    return next(m for m in model.root.walk() if isinstance(m, cls))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_stacks_match_jax(qwen_ckpt, mode):
    """Each package loads the checkpoint itself: the port's expert stacks, read
    back from int8 requants or bf16 reconstructions, equal JAX's bit for bit."""
    jm = _jax_model(qwen_ckpt, mode)
    pm = _port_model(qwen_ckpt, mode)
    pm.load()
    n = 0
    for layer in (0, 1):
        key = f"model.layers.{layer}.mlp"
        for name, arr in jax.tree.map(np.asarray, jm.params[key]).items():
            got = pm.params[key][name]
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == arr.shape
            assert np.array_equal(got.float().numpy(), arr.astype(np.float32)), (key, name)
            n += arr.size
    assert n == 2 * 3 * 8 * 256 * 128


def test_params_from_jax_carries_moe(qwen_ckpt, pairs):
    """Stacked experts (bf16, unchanged), the router with its expert-choice
    bias and the q/k norm weights come across; the carried model computes what
    the port's own load computes."""
    jm, pm = pairs["qwen3moe"]
    jp = jax.tree.map(np.asarray, jm.params)
    assert set(pm.params) == set(jp)
    for key in ("model.layers.0.mlp", "model.layers.0.mlp.gate", "model.layers.1.self_attn.q_norm",
                "model.layers.1.self_attn.k_norm"):
        for name, arr in jp[key].items():
            t = pm.params[key][name]
            assert tuple(t.shape) == arr.shape, (key, name)
            assert np.array_equal(t.float().numpy(), arr.astype(np.float32)), (key, name)
    assert "e_bias" in pm.params["model.layers.0.mlp.gate"]
    assert pm.params["model.layers.0.mlp"]["w_gate_proj"].dtype == torch.bfloat16
    qn = pm.params["model.layers.1.self_attn.q_norm"]["weight"]
    assert qn.shape == (64,) and not torch.all(qn == 1)
    own = _port_model(qwen_ckpt, "int8")
    own.load()
    for key in ("model.layers.0.mlp", "model.layers.1.mlp"):
        assert all(torch.equal(own.params[key][k], t) for k, t in pm.params[key].items())
    # the attention's int8 codes may differ at rounding ties (test_torch_model.py)
    ref = own.forward_simple(IDS[:, :6]).numpy()
    np.testing.assert_allclose(pm.forward_simple(IDS[:, :6]).numpy(), ref, rtol=0,
                               atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["qwen3moe", "mixtral"])
def test_bodies_match_each_other_and_jax(pairs, name):
    """The MoE block alone on identical inputs: grouped (T = 48), selected
    (T = 8) and dense-all agree in the port, and each matches the JAX
    package's body for the same T, at 5e-4 of the output's largest value: the
    f32 sums run in other orders, which now and then flip the bf16 rounding of
    an activation, and one flip moves an output by 2^-8 of that activation's
    share of it."""
    jm, pm = pairs[name]
    pmoe, jmoe = _moe(pm, BlockSparseMLP), _moe(jm, JMoE)
    h = pmoe.hidden_size
    rng = np.random.default_rng(4)
    for T, body in ((48, "_grouped_experts"), (8, "_selected_experts")):
        x = rng.standard_normal((1, T, h)).astype(np.float32)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        _jax_env()
        ref = np.asarray(jmoe.forward(jnp.asarray(x, jnp.bfloat16), jm.params,
                                      JCtx(positions=jnp.zeros((1, T), jnp.int32))))
        _port_env()
        got = pmoe.forward(xt, pm.params, ForwardCtx()).numpy()
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() <= 5e-4 * scale, (T, body)
        xt2 = xt.reshape(T, h)
        w = pmoe.route(pmoe.router.forward(xt2, pm.params, ForwardCtx()).float())
        p = pm.params[pmoe.key]
        own = getattr(pmoe, body)(xt2, w, p).numpy()
        dense = pmoe._dense_all_experts(xt2, w, p).numpy()
        np.testing.assert_array_equal(own, got.reshape(T, h))
        assert np.abs(own - dense).max() <= 5e-4 * scale, (T, body)


@pytest.mark.parametrize("name", ["qwen3moe", "mixtral"])
@pytest.mark.parametrize("S", [24, 4], ids=["grouped", "selected"])
def test_forward_simple_matches_jax(pairs, name, S):
    """(2, 24) runs the grouped body, (2, 4) the selected one (T = 8)."""
    jm, pm = pairs[name]
    ids = IDS[:, :S] % pm.config.vocab_size
    _jax_env()
    ref = np.asarray(jm.forward_simple(ids))
    _port_env()
    got = pm.forward_simple(ids).numpy()
    _close_up_to_flips(got, ref, (name, S))


@pytest.mark.parametrize("name", ["qwen3moe", "mixtral"])
def test_paged_step_matches_jax(pairs, name, monkeypatch):
    """A paged prefill chunk (grouped) and two decode steps (selected)
    against JAX's jitted paged step with its dense attention."""
    monkeypatch.setenv("EXL3_TPU_ATTN", "dense")
    jm, pm = pairs[name]
    V = pm.config.vocab_size
    step = jax.jit(jm.step_fn("paged"))
    jcache = JCache(jm, JCacheSpec(layout="paged", num_pages=4))
    cache = Cache(pm, CacheSpec(num_pages=4))
    bt = np.array([[1, 2, 0]], np.int32)
    ids = np.random.default_rng(1).integers(0, V, size=(1, 42)).astype(np.int32)
    S = 40
    chunks = [(ids[:, :S], np.arange(S, dtype=np.int32)[None], np.array([0], np.int32))]
    chunks += [(ids[:, p:p + 1], np.array([[p]], np.int32), np.array([p], np.int32))
               for p in (S, S + 1)]
    for x, pos, seqlens in chunks:
        _jax_env()
        ref, jcache.state = step(jm.params, x, jcache.state, pos, seqlens, bt)
        _port_env()
        got = pm.forward(x, cache, pos, seqlens, bt).numpy()
        _close_up_to_flips(got, np.asarray(ref), (name, pos[0, 0]))


def test_moe_decode_dense_and_offload(pairs, monkeypatch):
    """EXL3_TPU_MOE=dense takes the dense-all body for a decode step, and the
    selected body comes back with "selected"; host offload is refused, as are
    the unported MoE options."""
    _, pm = pairs["qwen3moe"]
    moe = _moe(pm, BlockSparseMLP)
    calls = []
    monkeypatch.setattr(BlockSparseMLP, "_dense_all_experts",
                        lambda self, *a: calls.append(1) or torch.zeros(a[0].shape))
    assert moe._use_selected_kernel(8)
    pm.forward_simple(IDS[:1, :4])
    assert not calls
    monkeypatch.setenv("EXL3_TPU_MOE", "dense")
    assert not moe._use_selected_kernel(8)
    pm.forward_simple(IDS[:1, :4])
    assert len(calls) == 2  # one a layer
    monkeypatch.setenv("EXL3_TPU_MOE", "selected")
    pm.forward_simple(IDS[:1, :4])
    assert len(calls) == 2
    with pytest.raises(TypeError, match="moe_offload"):
        InferParams(moe_offload=True)
    with pytest.raises(NotImplementedError, match="key_shared_gate"):
        BlockSparseMLP(pm.config, "x", 256, 128, 8, 2, key_shared_gate="shared_expert_gate")


def test_dense_qwen3_qk_norms_match_jax(tmp_path):
    """Dense Qwen3: Llama blocks with per-head q/k RMSNorms after the
    projections and before RoPE. Weights near 1 (a shard of their own), each
    package loading the checkpoint itself."""
    cfg = tiny_llama_cfg(arch="Qwen3ForCausalLM", head_dim=64,
                         extra=dict(model_type="qwen3", rms_norm_eps=1e-6))
    d = write_tiny_llama_exl3(str(tmp_path / "qwen3"), cfg, seed=7)
    rng = np.random.default_rng(2)
    norms = {f"model.layers.{i}.self_attn.{n}.weight": f32_to_bf16_u16(rng.uniform(0.8, 1.2, 64))
             for i in range(2) for n in ("q_norm", "k_norm")}
    save_file(norms, os.path.join(d, "qk_norms.safetensors"), bf16_keys=set(norms))
    ref = np.asarray(_jax_model(d, "int8").forward_simple(IDS))
    pm = _port_model(d, "int8")
    pm.load()
    assert "model.layers.0.self_attn.q_norm" in pm.params
    got = pm.forward_simple(IDS).numpy()
    # f32 sums in another order can flip a bf16 rounding of an activation
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.95


def test_greedy_generator_matches_jax(pairs):
    """Six concurrent greedy jobs sharing a prefix through both generators on
    the Qwen3-MoE model: the same prefix reuse and the same tokens, up to
    near-ties. Where a job parts ways, the port's token is held to JAX's own
    logits over the same context: JAX's first or second choice, within 5e-2
    of the logit range of the best (an expert flip moves a token's logits
    more than a bf16 rounding does)."""
    jm, pm = pairs["qwen3moe"]
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
