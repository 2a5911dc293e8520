"""The capacity path as a whole, against the JAX package on the CPU: the tiny
synthetic Llama (2 layers, h=256, i=512, 4 q / 2 kv heads, vocab 512) with
`fused` trellis linears over a quantized paged cache, (4, 4) in merged storage
and (5, 3) in per-head storage. Both packages run on the same parameters
(the trellis words carry across) and the same cache state."""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.generator.generator import Generator as JGenerator
from exllamav3_tpu.generator.job import Job as JJob
from exllamav3_tpu.generator.sampler import GreedySampler as JGreedy
from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import InferParams as JInferParams
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu.model.model import select_linear_mode as jselect
from exllamav3_tpu_torch.conversion.synth import write_tiny_llama_exl3
from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.model.model import estimate_linear_mode_bytes, select_linear_mode
from exllamav3_tpu_torch.util.params import cache_state_from_jax, params_from_jax

SPECS = {"4-4": dict(k_bits=4, v_bits=4), "5-3": dict(k_bits=5, v_bits=3, compand_a=0.65)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_tiny_llama_exl3(str(tmp_path_factory.mktemp("torch_capacity") / "m"), seed=21)


@pytest.fixture(scope="module")
def models(ckpt):
    jm = JModel.from_config(JConfig.from_directory(ckpt,
                                                   infer_params=JInferParams(linear_mode="fused")))
    jm.load()
    pm = Model.from_config(Config.from_directory(ckpt, infer_params=InferParams(linear_mode="fused")),
                           device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    assert pm.params["lm_head"]["words"].dtype == torch.int32
    return jm, pm


@pytest.mark.parametrize("attn", ["dense", "interpret"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_paged_step_matches_jax(models, monkeypatch, spec, attn):
    """A prefill chunk, then a decode step that starts from the JAX package's
    own cache state, against the JAX paged step with its dense quantized
    attention (`attend_paged(quant_state=)`) and with its Pallas kernel. The
    160-row chunk takes the JAX package's reconstruct + matmul product (its
    dispatch above 128 rows), the arithmetic of the port's plain version; the
    decode step takes its Pallas GEMM."""
    monkeypatch.setenv("EXL3_TPU_ATTN", attn)
    kw = SPECS[spec]
    if attn == "dense":
        # JAX's dense path rounds q to bf16 and dequantizes K/V to bf16; its
        # kernel path, like the port's, keeps f32: give the port the dense
        # path's arithmetic to compare like with like
        import exllamav3_tpu_torch.modules.attn as pattn
        from exllamav3_tpu_torch.ops.attention import attend_paged

        def dense(q, layer, bt, pos, tl, k_bits=0, v_bits=0, compand_a=0.0, **rest):
            return attend_paged(q.to(torch.bfloat16).float(), None, None, bt, pos, tl,
                                quant_state=layer, k_bits=k_bits, v_bits=v_bits,
                                compand_a=compand_a, **rest)
        monkeypatch.setattr(pattn, "paged_attention", dense)
    else:
        # The JAX kernel path takes q in the activations' bf16, rotates it in
        # f32 and rounds the rotated q back to bf16 (not where it dequantizes
        # a merged pool for a tall chunk); the port keeps the rotated q in
        # f32. Give the port the same rounded q
        import exllamav3_tpu_torch.modules.attn as pattn
        from exllamav3_tpu_torch.ops.kv_quant import rotate_groups

        orig = pattn.paged_attention

        def rounded_q(q, layer, *a, **rest):
            if layer["k_q"].dim() == 4 or q.shape[1] <= 32:
                q = rotate_groups(rotate_groups(q).to(torch.bfloat16).float())
            return orig(q, layer, *a, **rest)
        monkeypatch.setattr(pattn, "paged_attention", rounded_q)
    jm, pm = models
    step = jax.jit(jm.step_fn("paged", k_bits=kw["k_bits"], v_bits=kw["v_bits"],
                              compand_a=kw.get("compand_a", 0.0)))
    jcache = JCache(jm, JCacheSpec(layout="paged", num_pages=4, **kw))
    cache = Cache(pm, CacheSpec(num_pages=4, **kw), device="cpu")
    merged = kw["k_bits"] == 4
    assert (cache.state[cache.layer_keys[0]]["k_q"].dim() == 3) == merged
    bt = np.array([[1, 2, 0]], np.int32)
    ids = np.random.default_rng(1).integers(0, 512, size=(1, 161)).astype(np.int32)
    S = 160
    chunks = [(ids[:, :S], np.arange(S, dtype=np.int32)[None], np.array([0], np.int32)),
              (ids[:, S:], np.array([[S]], np.int32), np.array([S], np.int32))]
    for i, (x, pos, seqlens) in enumerate(chunks):
        if i == 1:  # decode from the JAX package's stored words and scales
            cache_state_from_jax(cache, jax.tree.map(np.asarray, jcache.state))
        ref, jcache.state = step(jm.params, x, jcache.state, pos, seqlens, bt)
        got = pm.forward(x, cache, pos, seqlens, bt).numpy()
        ref = np.asarray(ref)
        # prefill: the same arithmetic, f32 sums in another order, which can
        # flip a bf16 rounding or, rarely, a K/V code. Decode: the JAX GEMM
        # kernel rounds a decoded weight straight to bf16 where the port (and
        # the JAX reference product) round to fp16 first, a few 1e-3 per
        # linear (test_torch_exl3_gemm.py), ~2% of the logit range after two
        # layers, as for the cacheless forward of the two packages. One
        # flipped code moves a value by 1/8 of its group's range at 4 bits and
        # 1/4 at 3, so single rows may sit further out: up to 10% of the range
        scale = np.abs(ref).max()
        err = np.abs(got - ref) / scale
        assert err.max() <= 1e-1
        if i == 0:  # rows that attend to no flipped code agree closely
            assert np.median(err) < 3e-3 and (err > 3e-2).mean() < 5e-3
            assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.95
        else:       # one position: a near-tie may swap the top two
            assert err.max() <= 4e-2
            pick = got[0, 0].argmax()
            assert (ref[0, 0] > ref[0, 0, pick]).sum() < 3
    # after the decode step, the token just written quantized to nearly the same codes
    for key in cache.layer_keys:
        for name in ("k_s", "v_s"):
            a = cache.state[key][name][1, :S + 1].float().numpy()
            b = np.asarray(jcache.state[key][name][1, :S + 1].astype(np.float32))
            np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("spec", list(SPECS))
def test_greedy_generator_matches_jax(ckpt, models, spec, monkeypatch):
    """Concurrent greedy jobs with a shared prefix, chunked prefill and
    prefix-page reuse over the quantized cache: the same reuse and the same
    tokens. Token identity needs the same arithmetic on both sides, so the
    JAX side takes its reconstruct + matmul product at every row count (its
    Pallas GEMM, which rounds decoded weights differently, is compared in
    test_torch_exl3_gemm.py) and, on the CPU, its dense quantized attention,
    whose bf16 q and K/V the port is given too."""
    import exllamav3_tpu.ops.exl3_gemm as jgemm
    import exllamav3_tpu_torch.modules.attn as pattn
    from exllamav3_tpu_torch.ops.attention import attend_paged

    def dense(q, layer, bt, pos, tl, k_bits=0, v_bits=0, compand_a=0.0, **rest):
        return attend_paged(q.to(torch.bfloat16).float(), None, None, bt, pos, tl,
                            quant_state=layer, k_bits=k_bits, v_bits=v_bits,
                            compand_a=compand_a, **rest)
    monkeypatch.setattr(pattn, "paged_attention", dense)
    monkeypatch.setattr(jgemm, "FUSED_MAX_ROWS", 0)
    monkeypatch.setenv("EXL3_TPU_ATTN", "dense")
    pm = models[1]
    jm = JModel.from_config(JConfig.from_directory(ckpt,
                                                   infer_params=JInferParams(linear_mode="fused")))
    jm.load()  # its own step cache: traced with the patched dispatch
    kw = SPECS[spec]
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 512, 256)
    prompts = [np.concatenate([prefix, rng.integers(0, 512, n)]) for n in (5, 23, 40, 9)]
    waves = [prompts[:3], prompts[3:]]

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

    jgen = JGenerator(jm, JCache(jm, JCacheSpec(layout="paged", num_pages=16, **kw)),
                      max_chunk_size=64)
    pgen = Generator(pm, Cache(pm, CacheSpec(num_pages=16, **kw), device="cpu"),
                     max_chunk_size=64)
    ref = run(jgen, JJob, JGreedy())
    got = run(pgen, Job, GreedySampler())
    assert [got[i][1] for i in range(4)] == [ref[i][1] for i in range(4)]
    assert got[3][1] == 256  # the prefix page, four quantized arrays, reused
    assert [got[i][0] for i in range(4)] == [ref[i][0] for i in range(4)]


def test_select_linear_mode_matches_jax(ckpt):
    """The footprint ladder: the same mode as the JAX package at every
    capacity, from the same safetensors header."""
    cfg, jcfg = Config.from_directory(ckpt), JConfig.from_directory(ckpt)
    from exllamav3_tpu.model.model import estimate_linear_mode_bytes as jestimate

    sizes = {m: estimate_linear_mode_bytes(cfg, m) for m in ("int8", "int6", "int4", "fused")}
    assert sizes == {m: jestimate(jcfg, m) for m in sizes}
    assert sizes["int8"] > sizes["int6"] > sizes["int4"] > sizes["fused"]
    seen = set()
    sweep = sorted({int(b / 0.8 * f) for b in sizes.values() for f in (0.5, 0.999, 1.0, 1.001, 2.0)})
    for hbm in sweep + [1, 10 ** 12]:
        mode = select_linear_mode(cfg, hbm)
        assert mode == jselect(jcfg, hbm), hbm
        seen.add(mode)
    assert seen == {"int8", "int6", "int4", "fused"}
    assert select_linear_mode(cfg, None) == "int8"


def test_auto_resolves_to_fused_and_serves(ckpt, monkeypatch):
    """linear_mode="auto" on a device too small for int4 loads `fused`
    rather than raise."""
    import exllamav3_tpu_torch.model.model as pmodel

    cfg = Config.from_directory(ckpt, infer_params=InferParams(linear_mode="auto"))
    small = estimate_linear_mode_bytes(cfg, "int4")
    monkeypatch.setattr(pmodel, "device_hbm_bytes", lambda device: small)
    m = Model.from_config(cfg, device="cpu")
    m.load()
    assert cfg.infer_params.linear_mode == "fused"
    assert "words" in m.params["model.layers.0.mlp.down_proj"]
    assert m.forward_simple([[1, 2, 3]]).shape == (1, 3, 512)


@pytest.mark.parametrize("mode", ["int6", "int4"])
def test_unported_rungs_raise_at_load(ckpt, mode):
    """int6 and int4 are rungs of the ladder whose linears are not ported:
    loading raises; it does not quietly take another rung."""
    cfg = Config.from_directory(ckpt, infer_params=InferParams(linear_mode=mode))
    with pytest.raises(ValueError, match="not ported yet"):
        Model.from_config(cfg, device="cpu").load()
