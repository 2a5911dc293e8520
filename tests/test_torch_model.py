"""The port's model against the JAX package on the tiny synthetic Llama
(2 layers, h=256, i=512, 4 q / 2 kv heads, vocab 512), on the CPU.

The JAX side runs its decode MLP through the fused kernel in interpret mode
(EXL3_TPU_MLP=interpret), as it does on the TPU; the port's decode MLP is
the fused kernel's plain version. Both then round the same intermediates.
"""
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.model import Cache as JCache
from exllamav3_tpu.model import CacheSpec as JCacheSpec
from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import InferParams as JInferParams
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu_torch.conversion.synth import write_tiny_llama_exl3
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.model.model import estimate_linear_mode_bytes, select_linear_mode
from exllamav3_tpu_torch.util.params import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def jax_fused_mlp():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EXL3_TPU_MLP", "interpret")
        yield


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_tiny_llama_exl3(str(tmp_path_factory.mktemp("torch_model") / "m"), seed=5)


def _jax_model(ckpt, mode):
    m = JModel.from_config(JConfig.from_directory(ckpt, infer_params=JInferParams(linear_mode=mode)))
    m.load()
    return m


def _port_model(ckpt, mode):
    m = Model.from_config(Config.from_directory(ckpt, infer_params=InferParams(linear_mode=mode)),
                          device="cpu")
    m.load()
    return m


def _params_np(jmodel):
    return jax.tree.map(np.asarray, jmodel.params)


@pytest.fixture(scope="module")
def int8_pair(ckpt):
    jm = _jax_model(ckpt, "int8")
    pm = Model.from_config(Config.from_directory(ckpt, infer_params=InferParams(linear_mode="int8")),
                           device="cpu")
    params_from_jax(pm, _params_np(jm))
    return jm, pm


IDS = np.random.default_rng(0).integers(0, 512, size=(2, 24)).astype(np.int32)


@pytest.mark.parametrize("mode", ["reconstruct", "bf16"])
def test_forward_simple_own_load(ckpt, mode):
    """Each package loads the checkpoint itself."""
    ref = np.asarray(_jax_model(ckpt, mode).forward_simple(IDS))
    got = _port_model(ckpt, mode).forward_simple(IDS).numpy()
    # f32 sums in another order can flip a bf16 rounding of an activation;
    # 2 layers keep the logits within 1% of their range
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.95


@pytest.mark.parametrize("rows", [(2, 24), (1, 8)], ids=["prefill", "decode-mlp"])
def test_forward_simple_int8_carried(int8_pair, rows):
    """int8 weights carried across; (1, 8) takes the fused decode MLP."""
    jm, pm = int8_pair
    ids = IDS[: rows[0], : rows[1]]
    ref = np.asarray(jm.forward_simple(ids))
    got = pm.forward_simple(ids).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.abs(ref).max())
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.95


def test_auto_mode_raises_below_int8(ckpt):
    """"auto" resolves to int8 when the weights fit. Below that it walks the
    JAX package's ladder (int6, int4, then fused) and never takes the
    per-call reconstruct path; a rung whose linears are not ported raises at
    load."""
    cfg = Config.from_directory(ckpt)
    need = estimate_linear_mode_bytes(cfg, "int8")
    assert select_linear_mode(cfg, None) == "int8"
    assert select_linear_mode(cfg, 2 * need) == "int8"
    assert select_linear_mode(cfg, need) in ("int6", "int4")
    assert select_linear_mode(cfg, need // 100) == "fused"
    cfg.infer_params.linear_mode = select_linear_mode(cfg, need)
    with pytest.raises(ValueError, match="not ported"):
        Model.from_config(cfg, device="cpu").load()


def test_int8_requant_matches_jax(ckpt, int8_pair):
    """The port's own load-time requant against JAX's: scales equal to f32
    rounding, codes equal except at rounding ties, which differ by 1."""
    jparams = _params_np(int8_pair[0])
    own = _port_model(ckpt, "int8").params
    n_codes = 0
    for key, group in jparams.items():
        for name, arr in group.items():
            t = own[key][name].float().numpy() if arr.dtype != np.int8 else own[key][name].numpy()
            if arr.dtype == np.int8:
                diff = np.abs(t.astype(np.int32) - arr.astype(np.int32))
                assert diff.max() <= 1, (key, name)
                assert (diff > 0).mean() < 1e-3, (key, name)
                n_codes += arr.size
            elif name.endswith("scale"):
                np.testing.assert_allclose(t, arr, rtol=1e-5)
    assert n_codes > 0


@pytest.mark.parametrize("attn", ["dense", "interpret"])
def test_paged_step_matches_jax(int8_pair, monkeypatch, attn):
    """One paged prefill chunk and one decode step against the JAX paged step
    with its dense reference attention and with the Pallas kernel."""
    monkeypatch.setenv("EXL3_TPU_ATTN", attn)
    if attn == "dense":
        # JAX's dense paged path rounds q to bf16 while its kernel path (and
        # the port) takes q in f32: feed the port the same rounded q
        import exllamav3_tpu_torch.modules.attn as pattn

        orig = pattn.paged_attention
        monkeypatch.setattr(pattn, "paged_attention",
                            lambda q, *a, **kw: orig(q.to(torch.bfloat16).float(), *a, **kw))
    jm, pm = int8_pair
    step = jax.jit(jm.step_fn("paged"))
    jcache = JCache(jm, JCacheSpec(layout="paged", num_pages=4))
    cache = Cache(pm, CacheSpec(num_pages=4))
    bt = np.array([[1, 2, 0]], np.int32)
    ids = np.random.default_rng(1).integers(0, 512, size=(1, 41)).astype(np.int32)
    S = 40
    chunks = [(ids[:, :S], np.arange(S, dtype=np.int32)[None], np.array([0], np.int32)),
              (ids[:, S:], np.array([[S]], np.int32), np.array([S], np.int32))]
    for x, pos, seqlens in chunks:
        ref, jcache.state = step(jm.params, x, jcache.state, pos, seqlens, bt)
        got = pm.forward(x, cache, pos, seqlens, bt).numpy()
        ref = np.asarray(ref)
        # f32 sums in another order can flip a bf16 rounding of an activation
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.abs(ref).max())
        assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.95
