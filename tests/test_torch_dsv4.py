"""DeepSeek-V4 in the port against the JAX package, on the CPU, at the JAX
package's own tiny model (tests/test_dsv4.py: h 64, 3 layers: sliding, CSA,
HCA, 4 experts top 2 with one shared, one hash-routed layer): the checkpoint
writer byte for byte, the cacheless forward, cached decode against it over a
linear and a paged cache, chunk-boundary invariance, the decode step's
kernel route (the row 6b plain versions) against the dense route and against
JAX's kernel route, the generator against JAX's and a reused state slot
(the pieces: tests/test_torch_dsv4_parts.py).

Tolerances are relative to the largest |logit| of the reference: 2e-3 where
both packages compute the same function op by op (measured ~1e-7), 2e-2 where
a cache rounds rows to bf16 in another order than the cacheless pass (the
JAX package's chunk-invariance test holds 3e-2, kept here)."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

torch.set_num_threads(2)

from exllamav3_tpu.conversion.synth import write_synth_dense_for_arch
from exllamav3_tpu.generator import Generator as JGenerator
from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu_torch.conversion.synth import deepseek_v4_cfg, write_tiny_deepseek_v4_exl3
from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model

# tests/test_dsv4.py's fixture
CFG = dict(
    architectures=["DeepseekV4ForCausalLM"], bos_token_id=1, eos_token_id=2,
    vocab_size=256, hidden_size=64, max_position_embeddings=4096,
    num_attention_heads=4, num_key_value_heads=1, num_hidden_layers=3,
    rms_norm_eps=1e-5, rope_theta=10000.0, torch_dtype="bfloat16",
    head_dim=32, qk_rope_head_dim=8, q_lora_rank=32, o_groups=2,
    o_lora_rank=16, sliding_window=8, index_n_heads=4, index_head_dim=16,
    index_topk=4, compress_ratios=[0, 4, 128], compress_rate_csa=4,
    compress_rate_hca=8, hc_mult=4, hc_sinkhorn_iters=5,
    moe_intermediate_size=32, n_routed_experts=4, num_experts_per_tok=2,
    n_shared_experts=1, num_hash_layers=1, routed_scaling_factor=1.5,
    swiglu_limit=10.0,
)
SEED = 5
TOL_SAME = 2e-3
TOL_CACHE = 2e-2


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dsv4")
    jdir, pdir = str(root / "jax"), str(root / "port")
    write_synth_dense_for_arch(jdir, CFG, seed=SEED)
    write_tiny_deepseek_v4_exl3(pdir, dict(CFG), seed=SEED)
    return jdir, pdir


@pytest.fixture(scope="module")
def models(ckpt):
    jdir, pdir = ckpt
    jm = JModel.from_config(JConfig.from_directory(jdir))
    jm.load()
    pm = Model.from_config(Config.from_directory(pdir, infer_params=InferParams(linear_mode="bf16")),
                           device="cpu")
    pm.load()
    return jm, pm


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _tensors(d):
    out = {}
    for f in sorted(glob.glob(os.path.join(d, "*.safetensors"))):
        out.update(load_file(f))
    return out


def test_writer_matches_jax_bytes(ckpt):
    """Every linear of the tiny model has a width off the multiples of 128,
    so the port's writer writes bf16 weights in the JAX writer's draw order:
    the same tensors, byte for byte (the port shards by layer)."""
    theirs, ours = (_tensors(d) for d in ckpt)
    assert set(ours) == set(theirs) and len(ours) == 123
    for k, a in theirs.items():
        assert ours[k].dtype == a.dtype and np.array_equal(ours[k], a), k
    assert ours["layers.0.ffn.gate.tid2eid"].dtype == np.int32
    # the full-width config: EXL3 where both widths are multiples of 128
    full = deepseek_v4_cfg(num_hidden_layers=2, compress_ratios=[128, 4])
    assert full["hidden_size"] == 7168 and full["head_dim"] == 512
    assert deepseek_v4_cfg()["compress_ratios"][:4] == [128, 128, 128, 4]


def test_cacheless_forward_matches_jax(models):
    jm, pm = models
    ids = np.random.default_rng(0).integers(0, 250, size=(2, 14)).astype(np.int32)
    ref = np.asarray(jm.forward_simple(ids))
    _close(pm.forward_simple(ids).numpy(), ref, TOL_SAME)


def _decode(pm, ids, splits, layout="paged", env=None):
    """ids through a fresh cache in chunks cut at `splits`; the logits."""
    B, S = ids.shape
    if layout == "paged":
        cache = Cache(pm, CacheSpec(num_pages=1 + B, recurrent_slots=B + 1))
        bt = np.stack([np.array([1 + b, 0], np.int32) for b in range(B)])
    else:
        cache = Cache(pm, CacheSpec(layout="linear", batch_size=B, max_len=64))
        bt = None
    outs, start = [], 0
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        for stop in list(splits) + [S]:
            if stop <= start:
                continue
            pos = np.broadcast_to(np.arange(start, stop, dtype=np.int32), (B, stop - start))
            outs.append(pm.forward(ids[:, start:stop], cache, pos.copy(),
                                   np.full(B, start, np.int32), bt).numpy())
            start = stop
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("layout", ["linear", "paged"])
def test_cached_decode_matches_cacheless(models, layout):
    """Token-by-token decode (over a paged cache: the row 6b route at S = 1)
    against the cacheless forward."""
    _, pm = models
    ids = np.random.default_rng(0).integers(0, 250, size=(2, 14)).astype(np.int32)
    full = pm.forward_simple(ids).numpy()
    inc = _decode(pm, ids, range(1, 14), layout)
    _close(inc, full, TOL_CACHE)
    assert (inc.argmax(-1) == full.argmax(-1)).all()


def test_chunk_boundary_invariance(models):
    """The compressor's row buffer and overlap carry across chunks: any
    chunking gives the same logits (windows straddle the boundaries)."""
    _, pm = models
    ids = np.random.default_rng(1).integers(0, 250, size=(1, 17)).astype(np.int32)
    a = _decode(pm, ids, [9])
    b = _decode(pm, ids, [4, 7, 13])
    c = _decode(pm, ids, [])
    np.testing.assert_allclose(a, b, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(a, c, rtol=3e-2, atol=3e-2)
    assert (a.argmax(-1) == c.argmax(-1)).mean() >= 0.9


def test_kernel_route_matches_dense_route_and_jax(models):
    """Decode steps over a paged cache: the port's row 6b route (ring, CSA
    selection and HCA pool through the stats plain versions, merged with the
    sinks) against its dense route (EXL3_TPU_ATTN=dense) and against JAX's
    kernel route (EXL3_TPU_ATTN=interpret, Pallas in interpret mode)."""
    jm, pm = models
    ids = np.random.default_rng(2).integers(0, 250, size=(1, 20)).astype(np.int32)
    splits = [12] + list(range(13, 20))
    kern = _decode(pm, ids, splits)
    dense = _decode(pm, ids, splits, env={"EXL3_TPU_ATTN": "dense"})
    _close(kern, dense, TOL_SAME)

    os.environ["EXL3_TPU_ATTN"] = "interpret"
    try:
        jcache = JCache(jm, JCacheSpec(layout="paged", num_pages=2, recurrent_slots=2))
        step = jm.jitted_step("paged", donate_cache=False)
        bt = jnp.asarray(np.array([[1, 0]], np.int32))
        outs, start = [], 0
        for stop in splits + [20]:
            pos = np.arange(start, stop, dtype=np.int32)[None]
            lt, jcache.state = step(jm.params, jnp.asarray(ids[:, start:stop]), jcache.state,
                                    jnp.asarray(pos), jnp.full(1, start, np.int32), bt)
            outs.append(np.asarray(lt))
            start = stop
    finally:
        os.environ.pop("EXL3_TPU_ATTN", None)
        jm._step_cache.clear()
    _close(kern, np.concatenate(outs, axis=1), TOL_CACHE)


PROMPTS = [[5, 9, 13, 2, 7], [100, 200, 31, 17, 4, 90, 6, 11, 250, 34, 77, 12, 5]]


def _port_gen(pm, slots=9, **kw):
    return Generator(pm, Cache(pm, CacheSpec(num_pages=16, recurrent_slots=slots)),
                     max_batch_size=slots - 1, **kw)


def test_generator_matches_jax(models):
    """Two concurrent jobs, 12 greedy tokens each, in per-slot state: the
    port's tokens are JAX's generator's; where they part, the port's logits
    there hold a top-2 gap under 2e-2 of their range (a near-tie)."""
    jm, pm = models
    gen = _port_gen(pm)
    assert gen.has_recurrent and gen.pagetable.disable_reuse
    assert gen.recurrent_keys == [f"layers.{i}.attn" for i in range(3)] and not gen.ring_keys
    got = gen.generate([np.asarray(p, np.int64) for p in PROMPTS], max_new_tokens=12)
    jgen = JGenerator(jm, JCache(jm, JCacheSpec(layout="paged", num_pages=16, recurrent_slots=9)),
                      max_batch_size=8)
    ref = jgen.generate([np.asarray(p, np.int32) for p in PROMPTS], max_new_tokens=12,
                        decode_text=False)
    for p, a, b in zip(PROMPTS, got, ref):
        b = [int(t) for t in b]
        assert len(a) == 12
        if a != b:
            i = next(j for j in range(12) if a[j] != b[j])
            logits = pm.forward_simple(np.asarray([p + b[:i]], np.int32))[0, -1].numpy()
            gap = abs(logits[a[i]] - logits[b[i]])
            assert gap < 2e-2 * np.ptp(logits), (a, b)


def test_reused_slot_gives_fresh_tokens(models):
    """A second job in the slot a first one left: admission clears every
    per-slot array (ring, positions, compressor and indexer buffers), leaves
    the page-indexed pools alone, and the job gets a fresh generator's
    tokens."""
    _, pm = models
    long = np.random.default_rng(3).integers(3, 250, 40)
    short = np.asarray(PROMPTS[1], np.int64)
    fresh = _port_gen(pm, slots=2).generate(short.copy(), max_new_tokens=10)
    gen = _port_gen(pm, slots=2)
    gen.generate(long.copy(), max_new_tokens=12)
    state = gen.cache.state
    assert all((state[k]["pos"][0] >= 0).any() for k in gen.recurrent_keys)
    assert (state["layers.1.attn"]["icb_kv"][0] != 0).any()
    pools = {k: {n: t.clone() for n, t in state[k].items() if n.startswith("pg_")}
             for k in gen.recurrent_keys}
    gen.enqueue(Job(short.copy(), max_new_tokens=10, sampler=GreedySampler()))
    gen._admit_jobs([])
    for k in gen.recurrent_keys:
        for n, t in state[k].items():
            if n.startswith("pg_"):
                assert torch.equal(t, pools[k][n]), (k, n)
            else:
                assert (t[0] == (-1 if n == "pos" else 0)).all(), (k, n)
    out = None
    while gen.num_remaining_jobs():
        for r in gen.iterate():
            if r["stage"] == "finished":
                out = r["new_tokens"]
    assert out == fresh


def test_speculative_decoding_over_recurrent_layers_raises(models):
    _, pm = models
    with pytest.raises(NotImplementedError, match="recurrent"):
        _port_gen(pm, use_ngram_draft=True)
