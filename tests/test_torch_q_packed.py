"""The port's packed-integer linears (ops/q_matmul.py) against the JAX package
on the CPU: the int4 and int-B packers, and the plain version of each of the
four kernels against its Pallas kernel in interpret mode on the JAX package's
own packed tensors, so that both sides multiply the same weights."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops import q_matmul as J
from exllamav3_tpu_torch.loader.safetensors import SafetensorsCollection, save_file
from exllamav3_tpu_torch.ops import q_matmul as P
from exllamav3_tpu_torch.util.params import _np_to_torch as to_torch

N = 128


def _weight(k, seed):
    return (np.random.default_rng(seed).standard_normal((k, N)) * 0.02).astype(np.float32)


def _jax_pack(w, bits):
    """JAX's packed tensors as numpy: bits None is the int4 byte-pair tier."""
    packed, scales = (J.int4_pack_jnp(jnp.asarray(w)) if bits is None
                      else J.intb_pack_jnp(jnp.asarray(w), bits))
    return np.asarray(packed), np.asarray(scales)


@functools.lru_cache(maxsize=None)
def _packed(k, bits):
    """One JAX-packed weight per (k, width), shared by the product tests."""
    return _jax_pack(_weight(k, 11), bits)


def test_int4_pack_roundtrip():
    w = _weight(256, 0)
    packed, scales = P.int4_pack(torch.from_numpy(w))
    assert packed.shape == (128, N) and packed.dtype == torch.int8
    assert scales.shape == (8, N) and scales.dtype == torch.bfloat16
    back = P.int4_unpack(packed, scales).numpy()
    # the error is bounded by the grid step (the JAX package's own bound: the
    # refined scale may clip a group's largest value)
    assert np.abs(back - w).max() / np.abs(w).max() < 1.5 / 7
    assert np.abs(back - w).mean() < 0.3 * scales.float().mean()
    with pytest.raises(ValueError):
        P.int4_pack(torch.zeros((96, N)))


@pytest.mark.parametrize("k", [448, 512, 640])
@pytest.mark.parametrize("bits", [3, 4, 5, 6])
def test_intb_pack_roundtrip(bits, k):
    """k = 448 and 640 pad to the next multiple of 32 * W rows."""
    w = _weight(k, bits * 100 + k)
    packed, scales = P.intb_pack(torch.from_numpy(w), bits)
    W, kp, k_pad = P.intb_geometry(k, bits)
    assert (W, kp, k_pad) == J.intb_geometry(k, bits)
    assert packed.shape == (kp, N) and packed.dtype == torch.int32
    assert scales.shape == (k_pad // 32, N) and scales.dtype == torch.bfloat16
    back = P.intb_unpack(packed, scales, bits, k).numpy()
    assert back.shape == (k, N)
    assert np.abs(back - w).max() / np.abs(w).max() < 1.5 / (2 ** (bits - 1) - 1)
    # the pad rows hold code 0: all of them dequantize to 0
    full = P._intb_codes(packed, bits).numpy()
    assert (full[k:] == 0).all()


@pytest.mark.parametrize("bits", [None, 3, 4, 5, 6], ids=["int4", "B3", "B4", "B5", "B6"])
def test_packer_matches_jax(bits):
    """The port's packer against JAX's on one seeded weight. The Lloyd loop
    sums 32 products in f32 and the two frameworks may add in another order,
    so a scale may differ in its last bit and a code at a rounding edge: the
    differing entries are counted, and the dequantized weights are held to
    one step of each other."""
    k = 640
    w = _weight(k, 7)
    jp, js = _jax_pack(w, bits)
    if bits is None:
        pp, ps = P.int4_pack(torch.from_numpy(w))
        a = P.int4_unpack(pp, ps).numpy()
        b = P.int4_unpack(to_torch(jp), to_torch(js)).numpy()
    else:
        pp, ps = P.intb_pack(torch.from_numpy(w), bits)
        a = P.intb_unpack(pp, ps, bits, k).numpy()
        b = P.intb_unpack(to_torch(jp), to_torch(js), bits, k).numpy()
    words_differ = int((pp.numpy() != jp).sum())
    scales_differ = int((ps.float().numpy() != js.astype(np.float32)).sum())
    print(f"bits={bits}: {words_differ} of {jp.size} packed entries and {scales_differ} of "
          f"{js.size} scales differ from JAX's")
    assert words_differ <= 1e-3 * jp.size and scales_differ <= 1e-3 * js.size
    step = js.astype(np.float32).repeat(32, axis=0)[:k]
    assert (np.abs(a - b) <= step * 1.01).all()


def test_unpack_and_bits_match_jax():
    for bits in (3, 4, 5, 6):
        for k in (256, 448, 640, 4096):
            W, kp, _ = P.intb_geometry(k, bits)
            assert P.intb_bits_from_shapes(kp, W * kp // 32) == bits
            assert J.intb_bits_from_shapes(kp, W * kp // 32) == bits
        jp, js = _packed(448, bits)
        np.testing.assert_array_equal(
            P.intb_unpack(to_torch(jp), to_torch(js), bits, 448).numpy(),
            np.asarray(J.intb_unpack_jnp(jnp.asarray(jp), jnp.asarray(js), bits, 448)))
    jp, js = _packed(256, None)
    np.testing.assert_array_equal(P.int4_unpack(to_torch(jp), to_torch(js)).numpy(),
                                  np.asarray(J.int4_unpack_jnp(jnp.asarray(jp), jnp.asarray(js))))
    with pytest.raises(ValueError):
        P.intb_bits_from_shapes(96, 7)


@pytest.mark.parametrize("bits", [3, 4, 5, 6])
def test_pack_from_q_np_matches_jax(bits):
    rng = np.random.default_rng(bits)
    k = 448
    q = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(k, N))
    scales = rng.random((k // 32, N)).astype(np.float32) + 0.5
    jp, js = J.intb_pack_from_q_np(q, scales, bits)
    pp, ps = P.intb_pack_from_q_np(q, scales, bits)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(ps, js)
    assert pp.dtype == np.int32


def _x(m, k, seed=3):
    return np.random.default_rng(seed).standard_normal((m, k)).astype(np.float32)


def _close(got, ref, tol):
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("m", [1, 8, 300])
def test_int4_plain_matches_jax_kernel(m):
    """Row 11: bf16 x times bf16((nibble - 8) * scale); the same operands on
    both sides, f32 sums in another order."""
    k = 256
    jp, js = _packed(k, None)
    x = _x(m, k)
    xb = jnp.pad(jnp.asarray(x, dtype=jnp.bfloat16), ((0, -m % 16), (0, 0)))
    ref = np.asarray(J.int4_matmul_pallas(xb, jnp.asarray(jp), jnp.asarray(js),
                                          interpret=True))[:m]
    got = P.int4_matmul_plain(torch.from_numpy(x), to_torch(jp), to_torch(js)).numpy()
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("m", [1, 8, 300])
def test_int4_a8_plain_matches_jax_kernel(m):
    """Row 12: int8 rows of x, an exact integer dot per group; against JAX's
    a8 kernel at 1e-4 and against its bf16 reference within JAX's own bound."""
    k = 256
    jp, js = _packed(k, None)
    x = _x(m, k)
    ref = np.asarray(J.int4_matmul_a8(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js),
                                      interpret=True))
    got = P.int4_matmul_a8_plain(torch.from_numpy(x), to_torch(jp), to_torch(js)).numpy()
    _close(got, ref, 1e-4)
    bf = np.asarray(J.int4_matmul_ref(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js)))
    assert np.abs(got - bf).max() / np.abs(bf).max() < 0.03


@pytest.mark.parametrize("a8", [False, True], ids=["bf16", "a8"])
@pytest.mark.parametrize("bits,m", [(6, 1), (6, 8), (6, 300), (3, 8), (4, 8), (5, 8)])
def test_intb_plain_matches_jax_kernel(monkeypatch, bits, m, a8):
    """Rows 13 and 14 through JAX's dispatcher, which runs its Pallas kernels
    in interpret mode on the CPU; k = 448 pads its last plane."""
    monkeypatch.setenv("EXL3TPU_INTB_PALLAS", "1")
    monkeypatch.setenv("EXL3TPU_INTB_A8", "1" if a8 else "0")
    k = 448
    jp, js = _packed(k, bits)
    x = _x(m, k)
    ref = np.asarray(J.intb_matmul(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js), bits))
    plain = P.intb_matmul_a8_plain if a8 else P.intb_matmul_plain
    got = plain(torch.from_numpy(x), to_torch(jp), to_torch(js), bits).numpy()
    _close(got, ref, 1e-4)
    if a8:
        bf = np.asarray(J.intb_matmul_ref(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js), bits))
        assert np.abs(got - bf).max() / np.abs(bf).max() < 0.03


@pytest.mark.parametrize("a8", ["0", "1"])
def test_dispatchers_infer_bits_and_reshape(monkeypatch, a8):
    """(2, 3, k) inputs, bits read from the shapes, bias added; the variables
    choose the same route in both packages."""
    monkeypatch.setenv("EXL3TPU_INTB_A8", a8)
    monkeypatch.setenv("EXL3TPU_INT4_A8", a8)
    monkeypatch.setenv("EXL3TPU_INTB_PALLAS", "1")
    k = 448
    x = _x(6, k).reshape(2, 3, k)
    bias = np.random.default_rng(9).standard_normal(N).astype(np.float32)
    jp, js = _packed(k, 5)
    ref = np.asarray(J.intb_matmul(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js),
                                   bias=jnp.asarray(bias)))
    got = P.intb_matmul(torch.from_numpy(x), to_torch(jp), to_torch(js),
                        bias=torch.from_numpy(bias)).numpy()
    assert got.shape == (2, 3, N)
    _close(got, ref, 1e-4)
    k = 256
    x = _x(6, k).reshape(2, 3, k)
    jp, js = _packed(k, None)
    if a8 == "1":
        ref = np.asarray(J.int4_matmul(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js),
                                       bias=jnp.asarray(bias)))
    else:
        ref = np.asarray(J.int4_matmul_ref(jnp.asarray(x).reshape(6, k), jnp.asarray(jp),
                                           jnp.asarray(js), bias=jnp.asarray(bias))).reshape(2, 3, N)
    got = P.int4_matmul(torch.from_numpy(x), to_torch(jp), to_torch(js),
                        bias=torch.from_numpy(bias)).numpy()
    assert got.shape == (2, 3, N)
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("name", ["int4_matmul", "int4_matmul_a8", "intb_matmul", "intb_matmul_a8"])
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A wrapper launches its kernel or raises; it never takes the plain
    version by itself, and a refused call counts no launch."""
    bits = None if name.startswith("int4") else 6
    jp, js = _packed(256 if bits is None else 448, bits)
    x = torch.zeros((2, 256 if bits is None else 448), dtype=torch.bfloat16)
    kernel = getattr(P, name + "_kernel")
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        kernel(x, to_torch(jp), to_torch(js), *(() if bits is None else (bits,)))
    assert kernel.launches == before


def test_packed_split_counts_leave_no_split_empty(monkeypatch):
    """The k splits of the kernels' grid, from the shapes alone."""
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    for m in (1, 16, 17, 2048):
        for n in (64, 4096, 32768):
            for steps in (1, 3, 26, 64, 224, 299):
                for nibble in (True, False):
                    s = P._packed_splits(m, n, steps, nibble, None)
                    per = -(-steps // s)
                    assert 1 <= s <= steps and (s - 1) * per < steps
                    assert steps < 2 * P.MIN_STEPS or per >= P.MIN_STEPS // 2


def test_safetensors_int32_words_round_trip(tmp_path):
    """`.sq` words are I32: written and read back bit for bit, beside bf16."""
    jp, js = _packed(448, 4)
    path = str(tmp_path / "m.safetensors")
    save_file({"a.sq": jp, "a.sq_scale": js.astype(np.float32).astype(np.float16)}, path)
    stc = SafetensorsCollection(str(tmp_path))
    assert stc.get_dtype_str("a.sq") == "I32" and stc.get_dtype_str("a.sq_scale") == "F16"
    np.testing.assert_array_equal(stc.get_tensor("a.sq").numpy(), jp)
    assert P.intb_bits_from_shapes(*[stc.get_shape(k)[0] for k in ("a.sq", "a.sq_scale")]) == 4
