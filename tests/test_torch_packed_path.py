"""The packed-integer serving tiers as a whole, against the JAX package on the
CPU: the tiny synthetic Llama (2 layers, h=256, i=512, 4 q / 2 kv heads, vocab
512) loaded as int4, int5 and int6 and from conversion-time `.sq` tensors.
Both packages run on the same packed parameters (JAX's, carried across) and
read the same variables: EXL3TPU_INTB_MIN_K=256 so that every linear of the
tiny model packs, and EXL3TPU_INT4_A8 / EXL3TPU_INTB_A8 set explicitly, since
the two packages' CPU defaults differ. With "1" JAX runs its a8 Pallas kernels
in interpret mode; with "0" it runs its bf16 reference product.

The activations are bf16, and one residual value that rounds to the
neighbouring bf16 moves this model's logits by several 1e-3 of their range (in
every linear mode, int8 included; the a8 row quantizer amplifies it). So the
logit comparisons run the JAX side op by op: under `jax.jit` XLA keeps some
bf16 intermediates in f32, which moves roundings on the JAX side itself. Op by
op the two packages round at the same places and the comparison holds the
arithmetic to 2e-3."""
import shutil

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
from exllamav3_tpu.quant.quantize import quantize_serving_intb_np
from exllamav3_tpu_torch.conversion.synth import write_tiny_llama_exl3
from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
from exllamav3_tpu_torch.loader.safetensors import save_file
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.modules.linear import Linear
from exllamav3_tpu_torch.modules.multilinear import is_fused, try_fuse, unfuse
from exllamav3_tpu_torch.util.params import params_from_jax

CASES = [("int4", "1"), ("int4", "0"), ("int5", "1"), ("int6", "1"), ("int6", "0")]
IDS = np.random.default_rng(0).integers(0, 512, size=(2, 24)).astype(np.int32)


def _setenv(mp, a8):
    mp.setenv("EXL3TPU_INTB_MIN_K", "256")
    mp.setenv("EXL3TPU_INT4_A8", a8)
    mp.setenv("EXL3TPU_INTB_A8", a8)


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


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_tiny_llama_exl3(str(tmp_path_factory.mktemp("torch_packed") / "m"), seed=5)


def _pair(ckpt, mode, **ip):
    """A JAX model loaded in `mode` and a port model on its parameters."""
    jm = JModel.from_config(JConfig.from_directory(
        ckpt, infer_params=JInferParams(linear_mode=mode, **ip)))
    jm.load()
    pm = Model.from_config(Config.from_directory(
        ckpt, infer_params=InferParams(linear_mode=mode, **ip)), device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


def _linears(model):
    return [m for m in model.root.walk() if isinstance(m, Linear)]


@pytest.mark.parametrize("mode,a8", CASES)
def test_forward_and_paged_step_match_jax(ckpt, mode, a8):
    """forward_simple, then a paged prefill chunk and a decode step, on JAX's
    packed tensors. a8: the same codes and the same int8 rows of x on both
    sides, exact integer dots, a few f32 operations: held to 2e-3 of the logit
    range. bf16 route ("0"): the two frameworks add the f32 products in
    another order, which flips bf16 roundings of activations even op by op:
    held to 1e-2 (the product alone is held to 1e-4 in test_torch_q_packed.py)."""
    tol = 2e-3 if a8 == "1" else 1e-2
    with pytest.MonkeyPatch.context() as mp:
        _setenv(mp, a8)
        jm, pm = _pair(ckpt, mode)
        names = {name for group in pm.params.values() for name in group}
        want = {"int4": {"qkv_q4", "gate_up_q4", "weight_q4"}}.get(
            mode, {"qkv_qb", "gate_up_qb", "weight_qb"})
        assert want <= names and not {"weight_q", "qkv_q"} & names
        if mode != "int4":
            assert {lin.qbits for lin in _linears(pm) if lin.key in pm.params} == {int(mode[3:])}

        def close(got, ref):
            np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())
            assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.95

        S = 40  # one row count for the cacheless forward and the prefill chunk
        ids = np.random.default_rng(1).integers(0, 512, size=(1, S + 1)).astype(np.int32)
        close(pm.forward_simple(ids[:, :S]).numpy(),
              np.asarray(jm.forward_simple(ids[:, :S], jit=False)))

        step = jm.step_fn("paged")
        jcache = JCache(jm, JCacheSpec(layout="paged", num_pages=4))
        cache = Cache(pm, CacheSpec(num_pages=4))
        bt = np.array([[1, 2, 0]], np.int32)
        chunks = [(ids[:, :S], np.arange(S, dtype=np.int32)[None], np.array([0], np.int32)),
                  (ids[:, S:], np.array([[S]], np.int32), np.array([S], np.int32))]
        for x, pos, seqlens in chunks:
            ref, jcache.state = step(jm.params, x, jcache.state, pos, seqlens, bt)
            close(pm.forward(x, cache, pos, seqlens, bt).numpy(), np.asarray(ref))


@pytest.mark.parametrize("mode", ["int3", "int4", "int5", "int6"])
def test_own_load_packs_what_jax_packs(ckpt, mode, monkeypatch):
    """Each package loads the checkpoint itself: the same layers pack, with
    the same shapes, and nearly all codes agree (the decoded f32 weight and
    the Lloyd sums may differ in a last bit between the frameworks)."""
    _setenv(monkeypatch, "1")
    jm = JModel.from_config(JConfig.from_directory(ckpt,
                                                   infer_params=JInferParams(linear_mode=mode)))
    jparams = jax.tree.map(np.asarray, jm.load())
    pm = Model.from_config(Config.from_directory(ckpt, infer_params=InferParams(linear_mode=mode)),
                           device="cpu")
    pm.load()
    total = differ = 0
    assert set(pm.params) == set(jparams)
    for key, group in jparams.items():
        assert set(pm.params[key]) == set(group), key
        for name, arr in group.items():
            t = pm.params[key][name]
            assert tuple(t.shape) == arr.shape, (key, name)
            if arr.dtype in (np.int8, np.int32):
                total += arr.size
                differ += int((t.numpy() != arr).sum())
    assert total > 0 and differ <= 2e-3 * total
    print(f"{mode}: {differ} of {total} packed entries differ from JAX's load")
    logits = pm.forward_simple(IDS[:1, :6])
    assert logits.shape == (1, 6, 512) and torch.isfinite(logits).all()


def test_min_k_and_int4_tiling_fall_back_to_int8(ckpt, monkeypatch):
    """With the default EXL3TPU_INTB_MIN_K only down_proj (k = 512) packs as
    int-B and the rest load as int8, as in the JAX package."""
    monkeypatch.delenv("EXL3TPU_INTB_MIN_K", raising=False)
    pm = Model.from_config(Config.from_directory(ckpt, infer_params=InferParams(linear_mode="int6")),
                           device="cpu")
    pm.load()
    assert "weight_qb" in pm.params["model.layers.0.mlp.down_proj"]
    assert "qkv_q" in pm.params["model.layers.0.self_attn"]
    assert "weight_q" in pm.params["lm_head"]
    jm = JModel.from_config(JConfig.from_directory(ckpt,
                                                   infer_params=JInferParams(linear_mode="int6")))
    jparams = jm.load()
    assert {k: set(v) for k, v in jparams.items()} == {k: set(v) for k, v in pm.params.items()}


@pytest.mark.parametrize("mode,kind", [("int4", "q4"), ("int6", "qb"), ("sq", "sq")])
def test_fuse_unfuse_round_trip(ckpt, sq_ckpt, mode, kind, monkeypatch):
    """try_fuse concatenates the packed kinds along the output dim, unfuse
    splits them back, and the fused and unfused models compute the same."""
    _setenv(monkeypatch, "1")
    d, mode = (sq_ckpt, "int4") if mode == "sq" else (ckpt, mode)
    fused = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode=mode)),
                              device="cpu")
    fused.load()
    split = Model.from_config(Config.from_directory(
        d, infer_params=InferParams(linear_mode=mode, fuse_projections=False)), device="cpu")
    split.load()
    attn = fused.modules[1].attn
    key = attn.key
    assert is_fused(fused.params, key, "qkv") and not is_fused(split.params, key, "qkv")
    assert f"qkv_{kind}" in fused.params[key]
    a = fused.forward_simple(IDS).numpy()
    b = split.forward_simple(IDS).numpy()
    # the same sums per column, but a separate Linear rounds its output to the
    # activations' bf16 where the fused product stays f32
    np.testing.assert_allclose(a, b, rtol=0, atol=5e-2 * np.abs(b).max())

    lins = [attn.q_proj, attn.k_proj, attn.v_proj]
    unfuse(fused.params, key, "qkv", lins, [lin.out_features for lin in lins])
    assert not is_fused(fused.params, key, "qkv")
    for lin in lins:
        assert set(fused.params[lin.key]) == set(split.params[lin.key])
        for name, t in fused.params[lin.key].items():
            assert torch.equal(t, split.params[lin.key][name]) and t.is_contiguous()
        np.testing.assert_array_equal(lin.get_weight_f32(fused.params).numpy(),
                                      lin.get_weight_f32(split.params).numpy())
    assert try_fuse(fused.params, key, "qkv", lins) and is_fused(fused.params, key, "qkv")
    # mixed kinds do not fuse and leave everything as it was
    mlp = split.modules[1].mlp
    split.params[mlp.up.key] = {"weight": torch.zeros((256, 512), dtype=torch.bfloat16)}
    assert not try_fuse(split.params, mlp.key, "gate_up", [mlp.gate, mlp.up])
    assert mlp.gate.key in split.params and not is_fused(split.params, mlp.key, "gate_up")


@pytest.fixture(scope="module")
def sq_ckpt(ckpt, tmp_path_factory):
    """The checkpoint with conversion-time serving tensors added: 4-bit codes
    of every linear's rotated weight from the JAX package's converter, in a
    second safetensors file."""
    d = str(tmp_path_factory.mktemp("torch_packed_sq") / "m")
    shutil.copytree(ckpt, d)
    ref = Model.from_config(Config.from_directory(ckpt, infer_params=InferParams(
        linear_mode="reconstruct", fuse_projections=False)), device="cpu")
    ref.load()
    extra = {}
    for lin in _linears(ref):
        packed, scales = quantize_serving_intb_np(lin.get_weight_f32(ref.params).numpy(), None, 4)
        extra[lin.key + ".sq"] = packed
        extra[lin.key + ".sq_scale"] = scales
    save_file(extra, d + "/serving.safetensors")
    return d


def test_sq_tensors_load_and_match_jax(sq_ckpt, monkeypatch):
    """`.sq` / `.sq_scale` at the asked width win over the load-time requant in
    both packages, agree, and stay close to the unquantized weights;
    EXL3TPU_SQ=0 ignores them; another width ignores them too."""
    _setenv(monkeypatch, "1")
    jm, pm_carried = _pair(sq_ckpt, "int4")
    pm = Model.from_config(Config.from_directory(sq_ckpt, infer_params=InferParams(linear_mode="int4")),
                           device="cpu")
    pm.load()
    jparams = jax.tree.map(np.asarray, jm.params)
    assert "qkv_sq" in pm.params["model.layers.0.self_attn"]
    assert "weight_sq" in pm.params["lm_head"] and "weight_sq" in jparams["lm_head"]
    for key, group in jparams.items():
        assert set(pm.params[key]) == set(group)
        for name, arr in group.items():  # read from the file: bit for bit
            t = pm.params[key][name]
            np.testing.assert_array_equal((t.float() if t.dtype == torch.bfloat16 else t).numpy(),
                                          arr.astype(np.float32) if t.dtype == torch.bfloat16 else arr)
    assert {lin.qbits for lin in _linears(pm) if lin.key in pm.params} == {4}
    assert {lin.qbits for lin in _linears(pm_carried) if lin.key in pm_carried.params} == {4}
    # the dequantized weights, rotated back, agree; the serving codes are a
    # 4-bit rendering of the checkpoint's weights
    full = Model.from_config(Config.from_directory(sq_ckpt, infer_params=InferParams(
        linear_mode="reconstruct")), device="cpu")
    full.load()
    jlm = [m for m in jm.root.walk() if m.key == "lm_head"][0]
    lm = [lin for lin in _linears(pm) if lin.key == "lm_head"][0]
    w_sq = lm.get_weight_f32(pm.params)
    np.testing.assert_allclose(w_sq.numpy(), jlm.get_weight_f32(jm.params), rtol=0, atol=1e-6)
    w = lm.get_weight_f32(full.params)
    assert float((w - w_sq).norm() / w.norm()) < 0.15
    # the Hadamard on x sums in another order in the two frameworks, its bf16
    # result flips, and the row quantizer amplifies a flip: 3e-2 of the range
    ref = np.asarray(jm.forward_simple(IDS, jit=False))
    got = pm.forward_simple(IDS).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2 * np.abs(ref).max())
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.9

    monkeypatch.setenv("EXL3TPU_SQ", "0")
    off = Model.from_config(Config.from_directory(sq_ckpt, infer_params=InferParams(linear_mode="int4")),
                            device="cpu")
    off.load()
    assert "weight_q4" in off.params["lm_head"] and "qkv_q4" in off.params["model.layers.0.self_attn"]
    monkeypatch.delenv("EXL3TPU_SQ")
    other = Model.from_config(Config.from_directory(sq_ckpt, infer_params=InferParams(linear_mode="int6")),
                              device="cpu")
    other.load()
    assert "weight_qb" in other.params["lm_head"]


def test_greedy_generator_matches_jax(ckpt, monkeypatch):
    """Six concurrent greedy jobs with a shared prefix in int4 (a8) through
    both generators: the same prefix reuse and the same tokens, up to
    near-ties. The JAX generator runs under `jax.jit`, where XLA moves bf16
    roundings, and the row quantizer amplifies a moved rounding, so a job may
    part ways at a token whose two best logits nearly tie. Where a job does,
    the port's token is held to JAX's own logits over the same context: it is
    JAX's first or second choice, within 2e-2 of the logit range of the best."""
    _setenv(monkeypatch, "1")
    jm, pm = _pair(ckpt, "int4")
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

    jgen = JGenerator(jm, JCache(jm, JCacheSpec(layout="paged", num_pages=24)), max_chunk_size=64)
    pgen = Generator(pm, Cache(pm, CacheSpec(num_pages=24)), max_chunk_size=64)
    ref = run(jgen, JJob, JGreedy())
    got = run(pgen, Job, GreedySampler())
    assert [got[i][1] for i in range(6)] == [ref[i][1] for i in range(6)]
    assert all(got[i][1] == 256 for i in (4, 5))  # prefix page reused
    same = [got[i][0] == ref[i][0] for i in range(6)]
    assert sum(same) >= 4 and all(got[i][0][0] == ref[i][0][0] for i in range(6))
    for i in range(6):
        if same[i]:
            continue
        at = [a == b for a, b in zip(got[i][0], ref[i][0])].index(False)
        context = np.concatenate([prompts[i], got[i][0][:at]]).astype(np.int32)
        logits = np.asarray(jm.forward_simple(context[None]))[0, -1]
        order = np.argsort(-logits)
        assert got[i][0][at] in order[:2]
        assert logits[order[0]] - logits[got[i][0][at]] <= 2e-2 * (logits.max() - logits.min())
