"""EXL3 format core of the PyTorch port against the JAX package and the
reference fixture (tests/fixtures/reference_format.npz, the split
test_reference_format_parity.py uses): codebooks, unpacked codes, tile
permutation, signs and W_inner bit-exact; the Hadamard chain to a float
tolerance; the synthetic checkpoint writer byte-identical."""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.conversion.synth import tiny_llama_cfg as jax_tiny_cfg
from exllamav3_tpu.conversion.synth import write_tiny_llama_exl3 as jax_write
from exllamav3_tpu.quant.codebook import decode_np
from exllamav3_tpu.quant.reconstruct import reconstruct_full_np, reconstruct_inner_np
from exllamav3_tpu.quant.trellis import tile_perm as jax_tile_perm
from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3
from exllamav3_tpu_torch.loader.safetensors import SafetensorsCollection
from exllamav3_tpu_torch.modules.linear import _unpack_signs
from exllamav3_tpu_torch.quant import (CB_3INST, CB_MCG, CB_MUL1, decode, reconstruct_full,
                                       reconstruct_inner, tile_perm, unpack_trellis)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "reference_format.npz")
CBS = {"3inst": CB_3INST, "mcg": CB_MCG, "mul1": CB_MUL1}


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


@pytest.mark.parametrize("cb", ["3inst", "mcg", "mul1"])
def test_codebook_bit_exact(fx, cb):
    codes = np.arange(65536, dtype=np.uint32)
    got = decode(torch.from_numpy(codes.astype(np.int64)), CBS[cb], dtype=torch.float16)
    got_u16 = got.numpy().view(np.uint16)
    assert np.array_equal(got_u16, fx[f"codebook_{cb}"].view(np.uint16))
    assert np.array_equal(got_u16, decode_np(codes, CBS[cb]).astype(np.float16).view(np.uint16))


@pytest.mark.parametrize("K", range(1, 9))
def test_unpack_bit_exact(fx, K):
    got = unpack_trellis(torch.from_numpy(fx[f"packed_K{K}"]), K).numpy()
    assert np.array_equal(got.astype(np.uint16), fx[f"codes_K{K}"])


def test_tile_perm_and_signs(fx):
    assert np.array_equal(tile_perm().numpy(), fx["tile_perm"])
    assert np.array_equal(tile_perm().numpy(), jax_tile_perm())
    signs = _unpack_signs(torch.from_numpy(fx["signs_packed"])).numpy()
    assert np.array_equal(signs, fx["signs_f16"].astype(np.float32))


@pytest.mark.parametrize("cb", ["3inst", "mcg", "mul1"])
def test_reconstruct(fx, cb):
    trellis = fx[f"rc_trellis_{cb}"]
    suh = fx[f"rc_suh_{cb}"].astype(np.float32)
    svh = fx[f"rc_svh_{cb}"].astype(np.float32)
    tr = torch.from_numpy(trellis)
    # W_inner: decode + permutation, bit-exact
    wi = reconstruct_inner(tr, 4, CBS[cb]).numpy()
    assert np.array_equal(wi, fx[f"rc_w_inner_{cb}"])
    assert np.array_equal(wi, reconstruct_inner_np(trellis, 4, CBS[cb]).astype(np.float32))
    # full chain in f32 against the JAX numpy golden (f32) and the fixture
    # (f64 accumulation): the tolerance the JAX test uses for its f32 path
    w = reconstruct_full(tr, torch.from_numpy(suh), torch.from_numpy(svh), 4, CBS[cb]).numpy()
    np.testing.assert_allclose(w, reconstruct_full_np(trellis, suh, svh, 4, CBS[cb]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(w, fx[f"rc_w_{cb}"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quant_lm_head", [True, False])
def test_synth_writer_byte_identical(tmp_path, quant_lm_head):
    cfg = tiny_llama_cfg(num_layers=1, vocab_size=256)
    assert cfg == jax_tiny_cfg(num_layers=1, vocab_size=256)
    a = write_tiny_llama_exl3(str(tmp_path / "port"), cfg, K=3, seed=7,
                              quant_lm_head=quant_lm_head)
    b = jax_write(str(tmp_path / "jax"), cfg, K=3, seed=7, quant_lm_head=quant_lm_head)
    for name in ("config.json", "model.safetensors"):
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def test_loader_reads_dtypes(tmp_path):
    from exllamav3_tpu.loader.safetensors import save_file as jax_save

    rng = np.random.default_rng(0)
    bf = (rng.standard_normal(6).astype(np.float32))
    tensors = {"f32": rng.standard_normal((3, 4)).astype(np.float32),
               "f16": rng.standard_normal(5).astype(np.float16),
               "i16": rng.integers(-30000, 30000, (2, 3)).astype(np.int16),
               "u8": rng.integers(0, 255, 7).astype(np.uint8),
               "bf16": (bf.view(np.uint32) >> 16).astype(np.uint16)}
    jax_save(tensors, str(tmp_path / "m.safetensors"), bf16_keys={"bf16"})
    stc = SafetensorsCollection(str(tmp_path))
    for k in ("f32", "f16", "i16", "u8"):
        assert np.array_equal(stc.get_tensor(k).numpy(), tensors[k]), k
    got = stc.get_tensor("bf16")
    assert got.dtype == torch.bfloat16
    expect = (tensors["bf16"].astype(np.uint32) << 16).view(np.float32)
    assert np.array_equal(got.float().numpy(), expect)


def test_reconstruct_inner_in_bands(monkeypatch):
    """The decode runs a band of tile rows at a time to bound its int64
    temporaries; any band height gives the whole-tensor decode bit for bit."""
    import exllamav3_tpu_torch.quant.reconstruct as rec

    t = torch.from_numpy(np.random.default_rng(4).integers(-32768, 32768, (40, 6, 48))
                         .astype(np.int16))
    whole = rec.reconstruct_inner(t, 3, 1)
    monkeypatch.setattr(rec, "_DECODE_CODES", 3 * 6 * 256)  # bands of 3 rows, the last one short
    assert torch.equal(rec.reconstruct_inner(t, 3, 1), whole)
