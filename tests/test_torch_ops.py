"""Plain PyTorch versions of the port's three kernels against the JAX
functions they replace, on the same numpy inputs (CPU). The CUDA kernels
themselves are held against these plain versions by chip_smoke.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(2)

from exllamav3_tpu.ops.attention import attend_paged as jax_attend_paged
from exllamav3_tpu.ops.flash_attention import flash_attention
from exllamav3_tpu.ops.fused_mlp import fused_mlp_int8 as jax_fused_mlp
from exllamav3_tpu.ops.q_matmul import int8_matmul as jax_int8_matmul
from exllamav3_tpu.ops.q_matmul import int8_matmul_pallas
from exllamav3_tpu_torch.constants import PAGE_SIZE
from exllamav3_tpu_torch.ops.flash_attention import (paged_attention, paged_attention_kernel,
                                                      paged_attention_plain)
from exllamav3_tpu_torch.ops.fused_mlp import fused_mlp_int8, fused_mlp_int8_kernel
from exllamav3_tpu_torch.ops.q_matmul import int8_matmul, int8_matmul_kernel, int8_matmul_plain


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round f32 values to bf16-representable f32, so both packages see the
    same bf16 inputs."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m", [1, 7, 40])
def test_int8_matmul_plain(m):
    rng = np.random.default_rng(m)
    k, n = 256, 384
    x = _bf16(rng.standard_normal((m, k)))
    w = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    scale = ((rng.random(n) + 0.5) * 0.01).astype(np.float32)
    got = int8_matmul_plain(_t(x).to(torch.bfloat16), _t(w), _t(scale)).numpy()
    # XLA dot of the same exact bf16 products, f32 sums in another order
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                     use_pallas=False))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the Pallas kernel in interpret mode (tolerance of tests/test_q_matmul.py)
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(int8_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                            block_m=min(m, 16) if m % 8 == 0 else m,
                                            block_n=128, block_k=128))
    np.testing.assert_allclose(got, pal, rtol=1e-2, atol=1e-3)


def test_int8_matmul_dispatch_bias_and_batch_dims():
    rng = np.random.default_rng(9)
    x = _bf16(rng.standard_normal((2, 3, 128)))
    w = rng.integers(-127, 128, size=(128, 256)).astype(np.int8)
    scale = (rng.random(256) * 0.01).astype(np.float32)
    bias = rng.standard_normal(256).astype(np.float32)
    got = int8_matmul(_t(x).to(torch.bfloat16), _t(w), _t(scale), bias=_t(bias)).numpy()
    ref = np.asarray(jax_int8_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                     bias=jnp.asarray(bias), use_pallas=False))
    assert got.shape == (2, 3, 256)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [1, 5, 16])
def test_fused_mlp_plain(m):
    rng = np.random.default_rng(10 + m)
    h, inter = 256, 512
    x = _bf16(rng.standard_normal((m, h)))
    gu = rng.integers(-127, 128, size=(h, 2 * inter)).astype(np.int8)
    gs = np.full(2 * inter, 1.0 / (73.0 * np.sqrt(h)), np.float32) * (1 + rng.random(2 * inter)).astype(np.float32)
    d = rng.integers(-127, 128, size=(inter, h)).astype(np.int8)
    ds = (rng.random(h) * 0.01).astype(np.float32)
    got = fused_mlp_int8(_t(x).to(torch.bfloat16), _t(gu), _t(gs), _t(d), _t(ds)).numpy()
    ref = np.asarray(jax_fused_mlp(jnp.asarray(x), jnp.asarray(gu), jnp.asarray(gs),
                                   jnp.asarray(d), jnp.asarray(ds), interpret=True))
    # the activation is rounded to bf16 on both sides; a different f32 sum
    # order can flip one rounding, which moves an output by ~1e-3 relative
    tol = 2e-3 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _attn_case(rng, S, starts, total, B=2, Hq=4, Hk=2, D=64, P=7, MP=3):
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = _bf16(rng.standard_normal((P, PAGE_SIZE, Hk, D)) * 0.5)
    v = _bf16(rng.standard_normal((P, PAGE_SIZE, Hk, D)) * 0.5)
    bt = np.array([[1, 2, 0], [3, 5, 6]], np.int32)[:B, :MP]
    qpos = (np.asarray(starts)[:, None] + np.arange(S)[None]).astype(np.int32)
    return q, k, v, bt, qpos, np.asarray(total, np.int32)


CASES = [
    # name, S, starts, total lens, kwargs
    ("decode ragged", 1, [299, 40], [300, 41], {}),
    ("decode window", 1, [299, 600], [300, 601], {"sliding_window": 100}),
    ("decode softcap", 1, [299, 40], [300, 41], {"logit_softcap": 30.0}),
    ("decode sinks", 1, [299, 40], [300, 41], {"sinks": True}),
    ("prefill chunk", 40, [200, 0], [240, 40], {}),
    ("prefill all features", 24, [250, 500], [274, 524],
     {"sliding_window": 64, "logit_softcap": 20.0, "sinks": True}),
]


@pytest.mark.parametrize("name,S,starts,total,kw", CASES, ids=[c[0] for c in CASES])
def test_paged_attention_plain(name, S, starts, total, kw):
    rng = np.random.default_rng(len(name))
    q, k, v, bt, qpos, tl = _attn_case(rng, S, starts, total)
    Hq, D = q.shape[2], q.shape[3]
    sinks = (rng.standard_normal(Hq) * 0.5).astype(np.float32) if kw.get("sinks") else None
    args = dict(scale=D ** -0.5, sliding_window=kw.get("sliding_window", 0),
                logit_softcap=kw.get("logit_softcap", 0.0))
    got = paged_attention(_t(q), _t(k).to(torch.bfloat16),
                          _t(v).to(torch.bfloat16), _t(bt), _t(qpos), _t(tl),
                          sinks=None if sinks is None else _t(sinks), **args).numpy()
    jargs = dict(args, sinks=None if sinks is None else jnp.asarray(sinks))
    ref_dense = np.asarray(jax_attend_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(bt), jnp.asarray(qpos), jnp.asarray(tl),
                                            **jargs))
    np.testing.assert_allclose(got, ref_dense, rtol=1e-5, atol=1e-5)
    ref_flash = np.asarray(flash_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(qpos),
        jnp.asarray(tl), block_tables=jnp.asarray(bt), interpret=True, **jargs))
    # the tolerance tests/test_flash_attention.py holds the Pallas kernel to
    np.testing.assert_allclose(got, ref_flash, rtol=2e-3, atol=2e-3)


def test_paged_attention_padded_rows():
    """Padded rows (parked past the sequence end) and a padded batch row
    (total length 0) leave valid rows untouched; the row that sees no key
    gives 0."""
    rng = np.random.default_rng(21)
    S = 12
    q, k, v, bt, qpos, tl = _attn_case(rng, S, [100, 0], [108, 0])
    park = bt.shape[1] * PAGE_SIZE
    qpos[0, 8:] = park
    qpos[1, :] = park
    args = dict(scale=0.125)
    got = paged_attention_plain(_t(q), _t(k), _t(v), _t(bt), _t(qpos), _t(tl), **args).numpy()
    ref = np.asarray(flash_attention(
        jnp.asarray(q), {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.asarray(qpos),
        jnp.asarray(tl), block_tables=jnp.asarray(bt), interpret=True, **args))
    np.testing.assert_allclose(got[0, :8], ref[0, :8], rtol=2e-3, atol=2e-3)
    assert np.all(got[1] == 0)
    assert np.isfinite(got).all()


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never falls back: given CPU tensors it raises."""
    x = torch.zeros((2, 128), dtype=torch.bfloat16)
    w = torch.zeros((128, 128), dtype=torch.int8)
    s = torch.zeros(128)
    with pytest.raises(ValueError):
        int8_matmul_kernel(x, w, s)
    with pytest.raises(ValueError):
        fused_mlp_int8_kernel(torch.zeros((1, 256), dtype=torch.bfloat16),
                              torch.zeros((256, 256), dtype=torch.int8), torch.zeros(256),
                              torch.zeros((128, 256), dtype=torch.int8))
    q = torch.zeros((1, 1, 2, 64))
    kv = torch.zeros((2, PAGE_SIZE, 1, 64), dtype=torch.bfloat16)
    i32 = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        paged_attention_kernel(q, kv, kv, i32, i32, torch.ones(1, dtype=torch.int32))
