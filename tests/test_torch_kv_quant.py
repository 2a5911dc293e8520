"""The port's KV-cache quantizer against the JAX package, on the CPU: the
stored words and scales are the same bits, so a cache state carries across;
and the quantized paged attention's plain version against the JAX kernel in
interpret mode. The CUDA kernel is held against that plain version on the
card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops import kv_quant as jq
from exllamav3_tpu.ops.flash_attention import flash_attention as jflash
from exllamav3_tpu_torch.constants import PAGE_SIZE
from exllamav3_tpu_torch.ops import kv_quant as pq
from exllamav3_tpu_torch.ops.attention import attend_paged
from exllamav3_tpu_torch.ops.flash_attention import (paged_attention_any,
                                                      paged_attention_quant_kernel,
                                                      paged_attention_quant_plain)

CASES = [(bits, merged) for bits in range(2, 9)
         for merged in ((True, False) if bits in (2, 4, 8) else (False,))]
IDS = [f"{b}bit-{'merged' if m else 'per_head'}" for b, m in CASES]


def _bf16_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _away_from_grid_edges(x: torch.Tensor, bits: int, merged: bool, a: float) -> torch.Tensor:
    """(B, S, Hk*D) bool: elements that do not sit within 1e-4 of a grid edge
    (1e-5 in t with the compander, whose edges lie elsewhere), where an f32
    rotation sum taken in another order could flip the code."""
    B, S, Hk, D = x.shape
    xs = x.reshape(B, S, Hk * D) if merged else x
    t, arg, _ = pq.grid_argument(xs, bits)
    if a > 0.0:
        ok = pq.compand_encode(t - 1e-5, bits, a) == pq.compand_encode(t + 1e-5, bits, a)
    else:  # an edge below 1 or above N - 1 clips to the same code on both sides
        N = 1 << bits
        ok = (torch.clamp(torch.floor(arg - 1e-4), 0, N - 1)
              == torch.clamp(torch.floor(arg + 1e-4), 0, N - 1))
    return ok.reshape(B, S, Hk * D)


def _codes(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Stored words -> (B, S, Hk*D) grid indices, through the port's unpack."""
    ones = torch.ones(*words.shape[:-1], words.shape[-1] * 32 // bits // 32)
    t = pq.dequantize_rotated(words, ones, bits)           # (2q + 1)/N - 1
    q = torch.round((t + 1.0) * (1 << bits) / 2 - 0.5).to(torch.int64)
    return q.reshape(q.shape[0], q.shape[1], -1)


@pytest.mark.parametrize("compand_a", [0.0, 0.65], ids=["midpoint", "compand"])
@pytest.mark.parametrize("bits,merged", CASES, ids=IDS)
def test_stored_words_and_scales_bit_identical(bits, merged, compand_a):
    rng = np.random.default_rng(10 * bits + merged)
    x = (rng.standard_normal((2, 9, 2, 64)) * 0.7).astype(np.float32)
    jw, js = jq.quantize_kv_stored(jnp.asarray(x), bits, merged, compand_a)
    pw, ps = pq.quantize_kv_stored(torch.from_numpy(x), bits, merged, compand_a)
    assert pw.dtype == torch.int32 and ps.dtype == torch.bfloat16
    assert tuple(pw.shape) == tuple(jw.shape) and tuple(ps.shape) == tuple(js.shape)
    assert np.array_equal(_bf16_bits(ps), _bf16_bits(js))
    keep = _away_from_grid_edges(torch.from_numpy(x), bits, merged, compand_a)
    # elements on a grid edge are left out: under 1% of the 2304, and the
    # words are bit-identical whenever none of a tensor's elements is one
    assert (~keep).sum() <= 20, f"{int((~keep).sum())} of {keep.numel()} elements excluded"
    same = _codes(pw, bits) == _codes(torch.from_numpy(np.array(jw)), bits)
    assert bool(same[keep].all())
    if bool(same.all()):
        assert np.array_equal(pw.numpy(), np.asarray(jw))
    # dequantized from the JAX package's words: equal to 1 bf16 ulp (the
    # inverse rotation sums in another order)
    jd = np.asarray(jq.dequantize_kv_stored(jw, js, bits, 2, merged, jnp.float32, compand_a))
    pd = pq.dequantize_kv_stored(torch.from_numpy(np.array(jw)), ps, bits, 2, merged,
                                 torch.float32, compand_a).numpy()
    assert pd.shape == jd.shape == (2, 9, 2, 64)
    assert np.abs(pd - jd).max() <= 2.0 ** -8 * np.abs(jd).max()
    jb = jq.dequantize_kv_stored(jw, js, bits, 2, merged, compand_a=compand_a)
    pb = pq.dequantize_kv_stored(torch.from_numpy(np.array(jw)), ps, bits, 2, merged,
                                 compand_a=compand_a)
    jb = np.asarray(jb.astype(jnp.float32))
    # 1 bf16 ulp is at most 2^-7 of the value; a value that cancels to near 0
    # in the rotation carries the f32 sums' absolute error instead
    assert np.all(np.abs(pb.float().numpy() - jb) <= 2.0 ** -7 * np.abs(jb)
                  + 1e-6 * np.abs(jb).max())


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_lane_perm_equal(D, bits):
    for a, b in zip(pq.lane_perm(D, bits), jq.lane_perm(D, bits)):
        assert np.array_equal(a, b)
    assert pq.plane_max(bits) == jq.plane_max(bits)


@pytest.mark.parametrize("bits", [3, 4, 6])
def test_compander_inverts_on_the_grid(bits):
    N = 1 << bits
    idx = torch.arange(N, dtype=torch.float32)
    vals = pq.compand_decode(idx, bits, 0.65)
    assert torch.equal(pq.compand_encode(vals, bits, 0.65), torch.arange(N))
    np.testing.assert_allclose(vals.numpy(),
                               np.asarray(jq.compand_decode(jnp.arange(N, dtype=jnp.float32),
                                                            bits, 0.65)), rtol=1e-6)


@pytest.mark.parametrize("k_bits,v_bits", [(4, 4), (8, 2), (5, 3), (4, 7)])
def test_cache_shapes_and_fetch(k_bits, v_bits):
    shape = (3, PAGE_SIZE, 2, 64)
    ref = jq.quant_cache_shapes(shape, k_bits, v_bits)
    got = pq.quant_cache_shapes(shape, k_bits, v_bits)
    assert pq.merged_layout(k_bits, v_bits) == jq.merged_layout(k_bits, v_bits)
    for name in ("k_q", "k_s", "v_q", "v_s"):
        assert tuple(got[name].shape) == tuple(ref[name].shape)
        assert str(got[name].dtype).split(".")[-1] == str(ref[name].dtype)
    k, v = pq.quant_cache_fetch(got, k_bits, v_bits, hk=2)
    assert k.shape == v.shape == shape and pq.state_heads(got, 64) == 2


def _quant_state(rng, k_bits, v_bits, a, P=4, Hk=2, D=64):
    merged = jq.merged_layout(k_bits, v_bits)
    state = {}
    for name, bits in (("k", k_bits), ("v", v_bits)):
        x = (rng.standard_normal((P, PAGE_SIZE, Hk, D)) * 0.3).astype(np.float32)
        w, s = jq.quantize_kv_stored(jnp.asarray(x), bits, merged, a)
        state[name + "_q"], state[name + "_s"] = w, s
    tstate = {n: (torch.from_numpy(np.array(t)) if n.endswith("_q") else
                  torch.from_numpy(np.asarray(t).view(np.int16).copy()).view(torch.bfloat16))
              for n, t in state.items()}
    return state, tstate


@pytest.mark.parametrize("k_bits,v_bits,a", [(4, 4, 0.0), (8, 8, 0.65), (2, 2, 0.0), (8, 4, 0.0),
                                             (5, 3, 0.0), (6, 6, 0.65), (3, 7, 0.0), (7, 4, 0.0)])
def test_quant_attention_plain_matches_jax_kernel(k_bits, v_bits, a):
    """Decode-sized rows over both storages: the plain version (pages
    dequantized to f32, then plain attention) against the JAX kernel, which
    unpacks in the kernel (interpret mode)."""
    rng = np.random.default_rng(3)
    B, S, Hq, D = 2, 2, 8, 64
    state, tstate = _quant_state(rng, k_bits, v_bits, a)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    bt = np.array([[1, 2], [3, 0]], np.int32)
    qpos = np.array([[299, 300], [119, 120]], np.int32)
    total = qpos[:, -1] + 1
    ref = np.asarray(jflash(jnp.asarray(q), state, jnp.asarray(qpos), jnp.asarray(total),
                            block_tables=jnp.asarray(bt), scale=D ** -0.5, k_bits=k_bits,
                            v_bits=v_bits, compand_a=a, interpret=True))
    args = (torch.from_numpy(q), tstate, torch.from_numpy(bt), torch.from_numpy(qpos),
            torch.from_numpy(total), k_bits, v_bits, a)
    got = paged_attention_quant_plain(*args, scale=D ** -0.5).numpy()
    # f32 on both sides; the rotations and sums are taken in another order
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert torch.equal(paged_attention_any(*args, scale=D ** -0.5), torch.from_numpy(got))


def test_quant_attention_features_and_empty_rows():
    """Window, softcap and sinks over merged storage, a tall chunk (the JAX
    package dequantizes the pool there) and a padded row that sees no key."""
    rng = np.random.default_rng(4)
    B, Hq, D = 1, 8, 64
    state, tstate = _quant_state(rng, 4, 4, 0.0)
    S = 40
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    bt = np.array([[2, 1, 0]], np.int32)
    qpos = np.concatenate([260 + np.arange(S - 3), np.full(3, 4096)]).astype(np.int32)[None]
    total = np.array([260 + S - 3], np.int32)
    sinks = rng.standard_normal(Hq).astype(np.float32)
    kw = dict(scale=D ** -0.5, sliding_window=100, logit_softcap=20.0)
    ref = np.asarray(jflash(jnp.asarray(q), state, jnp.asarray(qpos), jnp.asarray(total),
                            block_tables=jnp.asarray(bt), sinks=jnp.asarray(sinks), k_bits=4,
                            v_bits=4, interpret=True, **kw))
    got = paged_attention_quant_plain(torch.from_numpy(q), tstate, torch.from_numpy(bt),
                                      torch.from_numpy(qpos), torch.from_numpy(total), 4, 4,
                                      sinks=torch.from_numpy(sinks), **kw).numpy()
    np.testing.assert_allclose(got[:, :S - 3], ref[:, :S - 3], rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    assert np.all(got[:, S - 3:] == 0.0)


def test_attend_paged_quant_state_matches_jax_dense():
    """The dense path with quant_state= dequantizes the gathered pages to
    bf16, as the JAX package's does."""
    from exllamav3_tpu.ops.attention import attend_paged as jattend

    rng = np.random.default_rng(5)
    B, S, Hq, D = 2, 3, 4, 64
    state, tstate = _quant_state(rng, 5, 3, 0.65)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    bt = np.array([[1, 2], [3, 0]], np.int32)
    qpos = np.array([[298, 299, 300], [10, 11, 12]], np.int32)
    total = qpos[:, -1] + 1
    ref = np.asarray(jattend(jnp.asarray(q), None, None, jnp.asarray(bt), jnp.asarray(qpos),
                             jnp.asarray(total), scale=D ** -0.5, quant_state=state, k_bits=5,
                             v_bits=3, compand_a=0.65))
    got = attend_paged(torch.from_numpy(q), None, None, torch.from_numpy(bt),
                       torch.from_numpy(qpos), torch.from_numpy(total), scale=D ** -0.5,
                       quant_state=tstate, k_bits=5, v_bits=3, compand_a=0.65).numpy()
    # the same bf16 K/V up to 1 ulp at a rounding tie, f32 attention
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * np.abs(ref).max())


def test_quant_kernel_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(6)
    _, tstate = _quant_state(rng, 4, 4, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_quant_kernel(torch.zeros((1, 1, 8, 64)), tstate,
                                     torch.zeros((1, 2), dtype=torch.int32),
                                     torch.zeros((1, 1), dtype=torch.int32),
                                     torch.ones((1,), dtype=torch.int32), 4, 4)
    assert paged_attention_quant_kernel.launches == 0
