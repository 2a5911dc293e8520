"""The port's linear KV cache against the JAX package, on the CPU: the cache
updates store JAX's values (bf16, and quantized words and scales bit for
bit), the linear attention's plain versions agree with the JAX kernel in its
linear layout (interpret mode), and a model step over a linear cache agrees
with JAX's "dense" step. The CUDA kernels are held against the plain versions
on the card by chip_smoke.py."""
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
from exllamav3_tpu.model.cache import linear_cache_update as jlinear_update
from exllamav3_tpu.ops import kv_quant as jq
from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu_torch.conversion.synth import write_tiny_llama_exl3
from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
from exllamav3_tpu_torch.model.cache import cache_base_shape, linear_cache_update
from exllamav3_tpu_torch.ops import kv_quant as pq
from exllamav3_tpu_torch.ops.flash_attention import (linear_attention_any,
                                                      linear_attention_plain,
                                                      linear_attention_quant_plain)
from exllamav3_tpu_torch.util.params import _np_to_torch, params_from_jax


def _bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _on_bin_centres(rng, shape: tuple, bits: int) -> np.ndarray:
    """f32 values whose 32-channel rotation lands inside the quantizer's bins,
    at least 1/(N-1) of a step from every edge: random codes, the first of
    each group the largest (so the group's absmax, and with it the bf16
    scale, is 0.75 exactly)."""
    N = 1 << bits
    q = rng.integers(0, N, shape)
    q[..., ::32] = N - 1
    rotated = (0.75 * (2 * q + 1 - N) / (N - 1)).astype(np.float32)
    return pq.rotate_groups(torch.from_numpy(rotated)).numpy()


def _off_grid_edges(x: np.ndarray, bits: int, merged: bool) -> bool:
    """No element's rotated value sits within 1e-4 of a code edge, where an
    f32 rotation summed in another order could take the neighbouring code."""
    B, S, Hk, D = x.shape
    xs = torch.from_numpy(x.reshape(B, S, Hk * D) if merged else x)
    _, arg, _ = pq.grid_argument(xs, bits)
    N = 1 << bits
    lo = torch.clamp(torch.floor(arg - 1e-4), 0, N - 1)
    return bool((lo == torch.clamp(torch.floor(arg + 1e-4), 0, N - 1)).all())


@pytest.mark.parametrize("bits", [(0, 0), (4, 4), (5, 3)],
                         ids=["bf16", "4-4-merged", "5-3-per_head"])
def test_linear_cache_update_stores_jax_values(bits):
    """Two writes into a (3, 40) linear cache, a prefill chunk into rows 0..1
    and a decode token into the row a step names: 0 differences from JAX's
    update in every stored word and scale (bf16 values for the bf16 cache)."""
    k_bits, v_bits = bits
    rng = np.random.default_rng(31 + k_bits)
    Hk, D = 2, 64
    spec = dict(layout="linear", batch_size=3, max_len=40, k_bits=k_bits, v_bits=v_bits)
    shape = cache_base_shape(CacheSpec(**spec), Hk, D)
    if k_bits:
        jstate = jq.quant_cache_shapes(shape, k_bits, v_bits)
        pstate = pq.quant_cache_shapes(shape, k_bits, v_bits)
    else:
        jstate = {n: jnp.zeros(shape, jnp.bfloat16) for n in ("k", "v")}
        pstate = {n: torch.zeros(shape, dtype=torch.bfloat16) for n in ("k", "v")}
    merged = pq.merged_layout(k_bits, v_bits) if k_bits else False
    writes = [(2, np.arange(8, 20, dtype=np.int32)[None].repeat(2, 0), None),
              (1, np.array([[20]], np.int32), 2)]
    for B_rows, pos, row in writes:
        shp = (B_rows, pos.shape[1], Hk, D)
        if k_bits:
            k, v = _on_bin_centres(rng, shp, k_bits), _on_bin_centres(rng, shp, v_bits)
            assert _off_grid_edges(k, k_bits, merged) and _off_grid_edges(v, v_bits, merged)
        else:
            k, v = (_bf16(rng.standard_normal(shp) * 0.6) for _ in range(2))
        if row is None:
            jstate = jlinear_update(jstate, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                    k_bits, v_bits)
        else:  # JAX writes row b for batch row b: give it a batch that reaches `row`
            jk = np.zeros((row + 1,) + k.shape[1:], np.float32)
            jv = np.zeros_like(jk)
            jk[row], jv[row] = k[0], v[0]
            jpos = np.full((row + 1, pos.shape[1]), 39, np.int32)  # the other rows: slot 39
            jpos[row] = pos[0]
            jstate = jlinear_update(jstate, jnp.asarray(jk), jnp.asarray(jv), jnp.asarray(jpos),
                                    k_bits, v_bits)
        linear_cache_update(pstate, torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(pos), k_bits, v_bits,
                            rows=None if row is None else torch.tensor([row], dtype=torch.int32))
    bits_of = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t  # noqa: E731
    live = torch.ones(shape[:2], dtype=torch.bool)
    live[:, 39] = False  # the slot JAX's padding rows wrote to
    for name, arr in jstate.items():
        got, ref = pstate[name], _np_to_torch(np.asarray(arr))
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert torch.equal(bits_of(got)[live], bits_of(ref)[live]), name
    assert (pstate["k" if not k_bits else "k_s"][2, 20] != 0).any()


ATTN_CASES = [(S, T, D) for S in (1, 8) for T in (40, 256) for D in (64, 128)]


def _linear_case(rng, S, T, D, B=2, Hq=4, Hk=2):
    q = _bf16(rng.standard_normal((B, S, Hq, D)))
    k = _bf16(rng.standard_normal((B, T, Hk, D)) * 0.5)
    v = _bf16(rng.standard_normal((B, T, Hk, D)) * 0.5)
    total = np.array([T - 3, T // 2], np.int32)
    qpos = (total[:, None] - S + np.arange(S)[None]).astype(np.int32)
    return q, k, v, qpos, total


@pytest.mark.parametrize("S,T,D", ATTN_CASES, ids=[f"S{s}-T{t}-D{d}" for s, t, d in ATTN_CASES])
def test_linear_attention_plain_matches_jax_kernel(S, T, D):
    """bf16 cache, decode and an 8-row chunk; T = 40 is no multiple of the
    port kernel's 64-key tile (JAX tiles it by 8)."""
    rng = np.random.default_rng(S * 1000 + T + D)
    q, k, v, qpos, total = _linear_case(rng, S, T, D)
    ref = np.asarray(jflash(jnp.asarray(q), {"k": jnp.asarray(k, jnp.bfloat16),
                                             "v": jnp.asarray(v, jnp.bfloat16)},
                            jnp.asarray(qpos), jnp.asarray(total), block_tables=None,
                            scale=D ** -0.5, interpret=True))
    args = (torch.from_numpy(q), torch.from_numpy(k).to(torch.bfloat16),
            torch.from_numpy(v).to(torch.bfloat16), torch.from_numpy(qpos),
            torch.from_numpy(total))
    got = linear_attention_plain(*args, scale=D ** -0.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.ptp(ref))
    layer = {"k": args[1], "v": args[2]}
    assert torch.equal(linear_attention_any(args[0], layer, *args[3:], scale=D ** -0.5),
                       torch.from_numpy(got))


@pytest.mark.parametrize("k_bits,v_bits,S", [(4, 4, 1), (4, 4, 8), (5, 3, 1), (5, 3, 8)])
def test_linear_attention_quant_plain_matches_jax_kernel(k_bits, v_bits, S):
    """Merged (4, 4) and per-head (5, 3) storage. JAX rounds the rotated q
    back to q's dtype, bf16 on the model's path; the port keeps it in f32, so
    it is given the same rounded q."""
    rng = np.random.default_rng(7 * k_bits + S)
    T, D, Hk = 40, 64, 2
    q, k, v, qpos, total = _linear_case(rng, S, T, D, Hk=Hk)
    merged = pq.merged_layout(k_bits, v_bits)
    state = {}
    for name, x, bits in (("k", k, k_bits), ("v", v, v_bits)):
        state[name + "_q"], state[name + "_s"] = jq.quantize_kv_stored(jnp.asarray(x), bits,
                                                                       merged)
    ref = np.asarray(jflash(jnp.asarray(q, jnp.bfloat16), state, jnp.asarray(qpos),
                            jnp.asarray(total), block_tables=None, scale=D ** -0.5,
                            k_bits=k_bits, v_bits=v_bits, interpret=True))
    tstate = {n: _np_to_torch(np.asarray(a)) for n, a in state.items()}
    qr = pq.rotate_groups(pq.rotate_groups(torch.from_numpy(q)).to(torch.bfloat16).float())
    args = (qr, tstate, torch.from_numpy(qpos), torch.from_numpy(total), k_bits, v_bits)
    got = linear_attention_quant_plain(*args, scale=D ** -0.5).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-3 * np.ptp(ref))
    assert torch.equal(linear_attention_any(*args, scale=D ** -0.5), torch.from_numpy(got))


def test_linear_attention_rows_window_and_empty_rows():
    """A step that names its cache rows reads exactly those rows, one that
    names none reads rows 0..B-1 of a taller cache; window,
    softcap and sinks apply as in the paged layout; a row that sees no key
    (total length 0) gives 0."""
    rng = np.random.default_rng(9)
    q, k, v, qpos, total = _linear_case(rng, 3, 48, 64)
    k4 = np.concatenate([k, k[::-1] * 0.5])  # 4 cache rows
    v4 = np.concatenate([v, v[::-1] * 0.5])
    rows = torch.tensor([3, 0], dtype=torch.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    sinks = t(rng.standard_normal(4).astype(np.float32))
    kw = dict(scale=0.125, sliding_window=16, logit_softcap=20.0, sinks=sinks)
    got = linear_attention_plain(t(q), t(k4), t(v4), t(qpos), t(total), rows=rows, **kw)
    want = linear_attention_plain(t(q), t(k4[[3, 0]]), t(v4[[3, 0]]), t(qpos), t(total), **kw)
    assert torch.equal(got, want)
    first_rows = linear_attention_plain(t(q), t(k4), t(v4), t(qpos), t(total), **kw)
    assert torch.equal(first_rows, linear_attention_plain(t(q), t(k), t(v), t(qpos), t(total),
                                                          **kw))
    empty = linear_attention_plain(t(q), t(k), t(v), t(qpos), t(np.array([total[0], 0], np.int32)),
                                   scale=0.125)
    assert torch.count_nonzero(empty[1]) == 0 and torch.count_nonzero(empty[0]) > 0


@pytest.fixture(scope="module")
def int8_pair(tmp_path_factory):
    d = write_tiny_llama_exl3(str(tmp_path_factory.mktemp("torch_linear") / "m"), seed=7)
    jm = JModel.from_config(JConfig.from_directory(d,
                                                   infer_params=JInferParams(linear_mode="int8")))
    jm.load()
    pm = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode="int8")),
                           device="cpu")
    params_from_jax(pm, jax.tree.map(np.asarray, jm.params))
    return jm, pm


def test_linear_step_matches_jax(int8_pair, monkeypatch):
    """A 40-token prefill of two rows, then 3 decode steps, over a (2, 64)
    linear bf16 cache: the port's Model.forward against JAX's jitted "dense"
    step through its kernel's linear layout (interpret mode), with the decode
    MLP through the fused kernel on both sides."""
    monkeypatch.setenv("EXL3_TPU_ATTN", "interpret")
    monkeypatch.setenv("EXL3_TPU_MLP", "interpret")
    jm, pm = int8_pair
    step = jm.jitted_step("dense", donate_cache=False)
    jcache = JCache(jm, JCacheSpec(layout="linear", batch_size=2, max_len=64))
    cache = Cache(pm, CacheSpec(layout="linear", batch_size=2, max_len=64))
    assert cache.layer_keys == jcache.layer_keys
    ids = np.random.default_rng(2).integers(0, 512, size=(2, 43)).astype(np.int32)
    S = 40
    chunks = [(ids[:, :S], np.tile(np.arange(S, dtype=np.int32), (2, 1)),
               np.zeros(2, np.int32))]
    chunks += [(ids[:, p: p + 1], np.full((2, 1), p, np.int32), np.full(2, p, np.int32))
               for p in range(S, S + 3)]
    for x, pos, seqlens in chunks:
        ref, jcache.state = step(jm.params, jnp.asarray(x), jcache.state, jnp.asarray(pos),
                                 jnp.asarray(seqlens), None)
        got = pm.forward(x, cache, pos, seqlens).numpy()
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.ptp(ref))
        assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.95
    k0 = cache.state[cache.layer_keys[0]]["k"]
    assert torch.count_nonzero(k0[:, S + 3:]) == 0 and torch.count_nonzero(k0[:, : S + 3]) > 0
    with pytest.raises(ValueError, match="no block tables"):
        pm.forward(ids[:, :1], cache, np.zeros((2, 1), np.int32), np.zeros(2, np.int32),
                   np.zeros((2, 2), np.int32))
    cache.reset()
    assert all(torch.count_nonzero(t) == 0 for layer in cache.state.values()
               for t in layer.values())
