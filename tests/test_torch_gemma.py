"""Gemma-2 and Gemma-3 in the port against the JAX package, on the CPU, on
checkpoints from the port's EXL3 writer (`write_tiny_gemma_exl3`, 4 layers,
h = 256): a Gemma-3 with `sliding_window_pattern` 2 (layers 0 and 2 slide,
window 16; layers 1 and 3 global with linear x8 rope), and a Gemma-2 of the
same widths with its softcaps. Logits cacheless and over the paged cache with
and without the SWA ring, the fused MLP's GELU variants, the parameter
carrier for Gemma's keys, and the pieces Gemma adds (linear rope, 1 + w
norms, the embedding scale).

The JAX side runs its decode MLP through the fused kernel and its attention
through its kernels, both in interpret mode, as on the TPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import InferParams as JInferParams
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu.modules.norms import rms_norm as jrms_norm
from exllamav3_tpu.ops.fused_mlp import fused_mlp_int8_pallas
from exllamav3_tpu.util.rope import RopeSettings as JRopeSettings
from exllamav3_tpu.util.rope import compute_rope_params as jrope_params
from exllamav3_tpu_torch.conversion.synth import gemma3_27b_cfg, write_tiny_gemma_exl3
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.modules.norms import rms_norm
from exllamav3_tpu_torch.ops.fused_mlp import ACTIVATIONS, fused_mlp_int8_plain
from exllamav3_tpu_torch.util.params import params_from_jax
from exllamav3_tpu_torch.util.rope import RopeSettings, compute_rope_params

TINY = dict(hidden_size=256, intermediate_size=512, num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, head_dim=64, query_pre_attn_scalar=64, sliding_window=16,
            vocab_size=512)
ARCHS = {
    "gemma3": gemma3_27b_cfg(sliding_window_pattern=2, **TINY),
    "gemma2": gemma3_27b_cfg(architectures=["Gemma2ForCausalLM"], model_type="gemma2",
                             attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                             rope_scaling=None, rope_theta=10000.0, **TINY),
}


@pytest.fixture(scope="module", autouse=True)
def jax_kernels():
    # JAX's dense ring path (a prefill chunk over the ring) rounds q to bf16;
    # the port's keeps q in f32, as its kernels take it: the port is fed the
    # same rounded q there (its cacheless path rounds q already)
    import exllamav3_tpu_torch.modules.attn as pattn

    dense = pattn.attend_dense
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pattn, "attend_dense",
                   lambda q, *a, **kw: dense(q.to(torch.bfloat16), *a, **kw))
        mp.setenv("EXL3_TPU_MLP", "interpret")
        mp.setenv("EXL3_TPU_ATTN", "interpret")
        yield


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_gemma")
    return {name: write_tiny_gemma_exl3(str(root / name), cfg, seed=7 + i)
            for i, (name, cfg) in enumerate(sorted(ARCHS.items()))}


def _jax_model(d, mode):
    m = JModel.from_config(JConfig.from_directory(d, infer_params=JInferParams(linear_mode=mode)))
    m.load()
    return m


def _port_model(d, mode):
    m = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode=mode)),
                          device="cpu")
    m.load()
    return m


@pytest.fixture(scope="module")
def int8_pairs(ckpts):
    pairs = {}
    for name, d in ckpts.items():
        jm = _jax_model(d, "int8")
        pm = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode="int8")),
                               device="cpu")
        params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
        pairs[name] = (jm, pm)
    return pairs


IDS = np.random.default_rng(0).integers(0, 512, size=(2, 40)).astype(np.int32)


def _close(got, ref, agree=0.95):
    """Logits within 1e-2 of their largest magnitude (test_torch_model.py's
    bound: f32 sums in another order flip bf16 roundings of activations),
    greedy tokens alike at `agree` of the positions."""
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= agree


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_write_tiny_gemma_read_by_both_packages(ckpts, arch):
    """Each package loads the port writer's checkpoint itself (bf16 decode of
    every trellis): equal logits, cacheless."""
    ref = np.asarray(_jax_model(ckpts[arch], "bf16").forward_simple(IDS))
    got = _port_model(ckpts[arch], "bf16").forward_simple(IDS).numpy()
    _close(got, ref)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_simple_int8_carried(int8_pairs, arch):
    """int8 weights carried across from JAX; cacheless forward of a 40-token
    chunk (longer than the window) and of an 8-token one, which takes the
    fused decode MLP (gelu_pytorch_tanh)."""
    jm, pm = int8_pairs[arch]
    for ids in (IDS, IDS[:1, :8]):
        _close(pm.forward_simple(ids).numpy(), np.asarray(jm.forward_simple(ids)))


@pytest.mark.parametrize("ring", [False, True], ids=["full-cache", "ring"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_paged_steps_match_jax(int8_pairs, arch, ring):
    """A 30-token prefill chunk and six decode steps over the paged cache,
    the sliding layers in full-length pages (the paged kernel with its
    window) or in the ring (state slot 1 of 3), against JAX's paged step."""
    jm, pm = int8_pairs[arch]
    step = jax.jit(jm.step_fn("paged"))
    spec = dict(num_pages=4, swa_ring=ring, recurrent_slots=3)
    jcache = JCache(jm, JCacheSpec(layout="paged", **spec))
    cache = Cache(pm, CacheSpec(**spec))
    assert ("pos" in cache.state["model.layers.0.self_attn"]) == ring
    assert "pos" not in cache.state["model.layers.1.self_attn"]
    bt = np.array([[1, 2, 0]], np.int32)
    slots = np.array([1], np.int32) if ring else None
    ids = IDS[:1, :36]
    chunks = [(ids[:, :30], np.arange(30, dtype=np.int32)[None], np.array([0], np.int32))]
    chunks += [(ids[:, p: p + 1], np.array([[p]], np.int32), np.array([p], np.int32))
               for p in range(30, 36)]
    got_all, ref_all = [], []
    for x, pos, seqlens in chunks:
        ref, jcache.state = step(jm.params, x, jcache.state, pos, seqlens, bt,
                                 None if slots is None else jnp.asarray(slots))
        got = pm.forward(x, cache, pos, seqlens, bt, state_slots=slots).numpy()
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
        got_all.append(got[0])
        ref_all.append(ref[0])
    got_all, ref_all = np.concatenate(got_all), np.concatenate(ref_all)
    assert (got_all.argmax(-1) == ref_all.argmax(-1)).mean() >= 0.9


def test_gemma2_final_softcap(int8_pairs):
    """Gemma-2's head caps its logits at 30; Gemma-3's does not cap."""
    g2 = int8_pairs["gemma2"][1].forward_simple(IDS[:1, :8])
    assert float(g2.abs().max()) <= 30.0
    assert int8_pairs["gemma2"][1].modules[-1].softcap == 30.0
    assert int8_pairs["gemma3"][1].modules[-1].softcap == 0.0


@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_fused_mlp_plain_matches_jax_kernel(activation):
    """The fused MLP's plain version against JAX's kernel in interpret mode,
    each activation (m = 5, h = 256, i = 512)."""
    rng = np.random.default_rng(sorted(ACTIVATIONS).index(activation))
    m, h, inter = 5, 256, 512
    x = rng.standard_normal((m, h)).astype(np.float32)
    gu = rng.integers(-127, 128, (h, 2 * inter)).astype(np.int8)
    gs = (rng.random(2 * inter).astype(np.float32) + 0.5) / (40.0 * np.sqrt(h))
    d = rng.integers(-127, 128, (inter, h)).astype(np.int8)
    xp = np.pad(x, ((0, 16 - m), (0, 0)))
    ref = np.asarray(fused_mlp_int8_pallas(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(gu),
                                           jnp.asarray(gs), jnp.asarray(d),
                                           activation=activation, interpret=True))[:m]
    got = fused_mlp_int8_plain(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(gu),
                               torch.from_numpy(gs), torch.from_numpy(d), activation).numpy()
    # f32 sums in another order can flip the bf16 rounding of an activation
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.abs(ref).max())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_carrier_for_gemma_keys(ckpts, int8_pairs, arch):
    """Every JAX parameter (1 + w norms' w, the q/k norms, the fused int8
    projections, the tied bf16 head) lands in the port under its key with
    its shape and values; the port's own int8 load has the same keys, and its
    head is the embedding in the bf16 dense path, as JAX's (vocabulary 512
    here; 262208 at 27B is no multiple of 128, and the dense path takes it)."""
    jm, pm = int8_pairs[arch]
    jparams = jax.tree.map(np.asarray, jm.params)
    own = _port_model(ckpts[arch], "int8").params
    assert set(own) == set(jparams) == set(pm.params)
    for key, group in jparams.items():
        assert set(own[key]) == set(group) == set(pm.params[key]), key
        for name, arr in group.items():
            t = pm.params[key][name]
            assert tuple(t.shape) == arr.shape, (key, name)
            np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
    assert set(own["lm_head"]) == {"weight"}
    assert torch.equal(own["lm_head"]["weight"].t(), own["model.embed_tokens"]["weight"])
    has_qk = "model.layers.0.self_attn.q_norm" in own
    assert has_qk == (arch == "gemma3")


def test_gemma_config_layers_and_ropes(ckpts):
    """Gemma-3's layer kinds and ropes follow sliding_window_pattern; the
    27B config gives 52 sliding and 10 global layers."""
    cfg = Config.from_directory(ckpts["gemma3"])
    m = Model.from_config(cfg, device="cpu")
    attn = [b.attn for b in m.modules[1:-2]]
    assert [a.sliding_window for a in attn] == [16, 0, 16, 0]
    assert [a.rope.settings.rope_scaling for a in attn] == [None, {"factor": 8.0,
                                                                  "rope_type": "linear"}] * 2
    assert [a.rope.settings.rope_theta for a in attn] == [10000.0, 1e6] * 2
    assert all(a.sm_scale == 64 ** -0.5 and a.logit_softcap == 0.0 for a in attn)
    big = gemma3_27b_cfg()
    sliding = [(i + 1) % big["sliding_window_pattern"] != 0 for i in range(62)]
    assert sum(sliding) == 52 and big["vocab_size"] % 64 == 0 and big["vocab_size"] % 128


@pytest.mark.parametrize("scaling", [None, {"rope_type": "linear", "factor": 8.0},
                                     {"type": "linear", "factor": 2.5}],
                         ids=["default", "linear8", "linear2.5-type-key"])
def test_rope_params_match_jax(scaling):
    kw = dict(head_dim=128, rope_theta=1e6, rope_scaling=scaling)
    inv, att = compute_rope_params(RopeSettings(**kw))
    jinv, jatt = jrope_params(JRopeSettings(**kw))
    np.testing.assert_array_equal(inv, jinv)
    assert att == jatt


@pytest.mark.parametrize("bias", [0.0, 1.0])
def test_rms_norm_constant_bias_matches_jax(bias):
    rng = np.random.default_rng(int(bias))
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    ref = np.asarray(jrms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 1e-6, bias)
                     .astype(jnp.float32))
    got = rms_norm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w), 1e-6,
                   bias).float().numpy()
    np.testing.assert_array_equal(got, ref)


def test_embedding_scale_matches_jax(int8_pairs):
    """sqrt(h) applied in f32, then rounded to bf16, as JAX does."""
    from exllamav3_tpu.modules.module import ForwardCtx as JCtx
    from exllamav3_tpu_torch.modules.module import ForwardCtx

    jm, pm = int8_pairs["gemma3"]
    ids = IDS[:1, :16]
    ref = np.asarray(jm.modules[0].forward(jnp.asarray(ids), jm.params, JCtx())
                     .astype(jnp.float32))
    got = pm.modules[0].forward(torch.from_numpy(ids).long(), pm.params, ForwardCtx())
    assert got.dtype == torch.bfloat16 and pm.modules[0].scale == 16.0
    np.testing.assert_array_equal(got.float().numpy(), ref)
