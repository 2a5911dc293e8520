"""The port's trellis-word layout, `fused` linear and plain trellis-decode
product against the JAX package (its Pallas kernel in interpret mode), on the
CPU. The CUDA kernel itself is held against `exl3_gemm_plain` on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.model import Config as JConfig
from exllamav3_tpu.model import InferParams as JInferParams
from exllamav3_tpu.model import Model as JModel
from exllamav3_tpu.ops import exl3_gemm as jgemm
from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3
from exllamav3_tpu_torch.model import Config, InferParams, Model
from exllamav3_tpu_torch.modules.multilinear import is_fused
from exllamav3_tpu_torch.ops import exl3_gemm as pgemm
from exllamav3_tpu_torch.ops.fused_mlp import fused_mlp_eligible
from exllamav3_tpu_torch.util.params import params_from_jax


def _case(rng, k, n, K):
    trellis = rng.integers(-32768, 32768, size=(k // 16, n // 16, 16 * K)).astype(np.int16)
    suh = np.sign(rng.standard_normal(k)).astype(np.float32)
    svh = (np.sign(rng.standard_normal(n)) * 0.05).astype(np.float32)
    return trellis, suh, svh


@pytest.mark.parametrize("K", range(1, 9))
def test_trellis_words_bit_equal(K):
    rng = np.random.default_rng(K)
    trellis = rng.integers(-32768, 32768, size=(3, 5, 16 * K)).astype(np.int16)
    ref = jgemm.prepare_trellis_words(trellis)
    assert np.array_equal(pgemm.prepare_trellis_words(trellis), ref)
    assert np.array_equal(pgemm.trellis_to_words(torch.from_numpy(trellis)).numpy(), ref)
    back = pgemm.words_to_trellis(torch.from_numpy(ref)).numpy()
    assert np.array_equal(back, np.asarray(jgemm.words_to_trellis(jnp.asarray(ref))))
    assert np.array_equal(back, trellis)


@pytest.mark.parametrize("cb", [0, 1, 2], ids=["3inst", "mcg", "mul1"])
@pytest.mark.parametrize("K", range(1, 9))
def test_plain_matches_jax_fused_kernel(K, cb):
    rng = np.random.default_rng(100 + 8 * cb + K)
    k = n = 256
    trellis, suh, svh = _case(rng, k, n, K)
    words = jgemm.prepare_trellis_words(trellis)
    for m in (1, 5, 128):
        x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
        ref = np.asarray(jgemm.exl3_matmul_fused(
            jnp.asarray(x), jnp.asarray(words), jnp.asarray(suh), jnp.asarray(svh), K, cb,
            out_dtype=jnp.float32))
        got = pgemm.exl3_matmul(torch.from_numpy(x), torch.from_numpy(words),
                                torch.from_numpy(suh), torch.from_numpy(svh), K, cb,
                                out_dtype=torch.float32).numpy()
        # both multiply bf16 operands into f32 sums. The port rounds a decoded
        # weight to fp16 (the format's value) and then to bf16, the JAX kernel
        # straight to bf16, and the rotated activation can round to the other
        # bf16 neighbour: a few 1e-3 of the output range (the JAX package's
        # own test of this kernel allows 2e-2)
        assert np.abs(got - ref).max() <= 5e-3 * np.abs(ref).max(), (K, cb, m)


def test_dispatch_many_rows_matches_jax():
    """300 rows: the JAX dispatch leaves its kernel for reconstruct + matmul."""
    rng = np.random.default_rng(1)
    trellis, suh, svh = _case(rng, 128, 128, 4)
    words = jgemm.prepare_trellis_words(trellis)
    x = (rng.standard_normal((300, 128)) * 0.3).astype(np.float32)
    ref = np.asarray(jgemm.exl3_matmul(jnp.asarray(x), jnp.asarray(words), jnp.asarray(suh),
                                       jnp.asarray(svh), 4, 0, out_dtype=jnp.float32))
    got = pgemm.exl3_matmul(torch.from_numpy(x), torch.from_numpy(words), torch.from_numpy(suh),
                            torch.from_numpy(svh), 4, 0, out_dtype=torch.float32).numpy()
    # the same arithmetic on both sides; f32 sums in another order
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


def test_gemm_plain_is_the_inner_product():
    """exl3_gemm_plain (what the CUDA kernel is held to) is the inner product
    of exl3_matmul_plain: Hadamards and signs around it give the linear."""
    from exllamav3_tpu_torch.quant.hadamard import had_right

    rng = np.random.default_rng(2)
    trellis, suh, svh = _case(rng, 256, 128, 3)
    words = torch.from_numpy(pgemm.prepare_trellis_words(trellis))
    x = torch.from_numpy((rng.standard_normal((7, 256)) * 0.3).astype(np.float32))
    suh, svh = torch.from_numpy(suh), torch.from_numpy(svh)
    xh = had_right(x, scale_pre=suh).to(torch.bfloat16)
    y = had_right(pgemm.exl3_gemm_plain(xh, words, 3, 1), scale_post=svh)
    ref = pgemm.exl3_matmul_plain(x, words, suh, svh, 3, 1, out_dtype=torch.float32)
    assert torch.equal(y, ref)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper launches or raises: it never takes the plain version."""
    words = torch.zeros((8, 4, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pgemm.exl3_gemm_kernel(torch.zeros((1, 128), dtype=torch.bfloat16), words, 4, 0)
    assert pgemm.exl3_gemm_kernel.launches == 0


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 4096, 1024), (128, 14336, 4096),
                                   (2048, 4096, 14336), (1, 128, 128), (5, 384, 32768)])
def test_split_count_leaves_no_empty_split(m, k, n):
    splits = pgemm.split_count(m, k, n)
    steps = k // 128
    per = -(-steps // splits)
    assert 1 <= splits <= steps and (splits - 1) * per < steps


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_exl3")
    return {cb: write_tiny_llama_exl3(str(root / cb), tiny_llama_cfg(num_layers=1), seed=7,
                                      codebook=cb) for cb in ("3inst", "mcg", "mul1")}


def _port(d, mode):
    m = Model.from_config(Config.from_directory(d, infer_params=InferParams(linear_mode=mode)),
                          device="cpu")
    m.load()
    return m


@pytest.mark.parametrize("cb", ["3inst", "mcg", "mul1"])
def test_fused_linear_matches_jax_linear(ckpts, cb):
    """Each package loads the checkpoint in `fused` mode: the words are the
    same bits, the marker tensors select the same codebook, and a Linear
    gives the same product."""
    jm = JModel.from_config(JConfig.from_directory(ckpts[cb],
                                                   infer_params=JInferParams(linear_mode="fused")))
    jm.load()
    pm = _port(ckpts[cb], "fused")
    jparams = jax.tree.map(np.asarray, jm.params)
    n_words = 0
    for key, group in jparams.items():
        if "words" in group:
            assert np.array_equal(pm.params[key]["words"].numpy(), group["words"]), key
            n_words += 1
    assert n_words == 8  # q, k, v, o, gate, up, down, lm_head: none fused away
    jlin = {m.key: m for m in jm.root.walk()}["model.layers.0.self_attn.q_proj"]
    plin = {m.key: m for m in pm.root.walk()}["model.layers.0.self_attn.q_proj"]
    assert plin.cb == jlin.cb == {"3inst": 0, "mcg": 1, "mul1": 2}[cb]
    x = (np.random.default_rng(3).standard_normal((2, 5, 256)) * 0.5).astype(np.float32)
    from exllamav3_tpu.modules.module import ForwardCtx as JCtx
    from exllamav3_tpu_torch.modules.module import ForwardCtx

    ref = np.asarray(jlin.forward(jnp.asarray(x), jm.params, JCtx()))
    got = plin.forward(torch.from_numpy(x), pm.params, ForwardCtx()).numpy()
    assert np.abs(got - ref).max() <= 5e-3 * np.abs(ref).max()  # as above
    # carried across instead of loaded: the same result, bit for bit
    cm = Model.from_config(Config.from_directory(ckpts[cb],
                                                 infer_params=InferParams(linear_mode="fused")),
                           device="cpu")
    params_from_jax(cm, jparams)
    assert torch.equal(plin.forward(torch.from_numpy(x), cm.params, ForwardCtx()),
                       torch.from_numpy(got))


def test_fused_mode_keeps_projections_apart(ckpts):
    """A `words` group does not fuse: q/k/v and gate/up stay separate linears
    and the int8 decode MLP kernel is not eligible."""
    pm = _port(ckpts["3inst"], "fused")
    assert pm.config.infer_params.fuse_projections
    assert not is_fused(pm.params, "model.layers.0.self_attn", "qkv")
    assert not is_fused(pm.params, "model.layers.0.mlp", "gate_up")
    mlp = {m.key: m for m in pm.root.walk()}["model.layers.0.mlp"]
    assert not fused_mlp_eligible(mlp, pm.params, 1)
    for name in ("q_proj", "k_proj", "v_proj"):
        assert set(pm.params[f"model.layers.0.self_attn.{name}"]) == {"words", "suh", "svh"}


@pytest.mark.parametrize("cb", ["3inst", "mul1"])
def test_get_weight_f32_fused_equals_reconstruct(ckpts, cb):
    fused, recon = _port(ckpts[cb], "fused"), _port(ckpts[cb], "reconstruct")
    for lin in (m for m in fused.root.walk() if m.key.endswith("_proj")):
        other = {m.key: m for m in recon.root.walk()}[lin.key]
        assert torch.equal(lin.get_weight_f32(fused.params), other.get_weight_f32(recon.params))


def test_synth_codebook_markers(ckpts):
    """The marker is one scalar int32 holding the codebook's multiplier, as
    the JAX package's quantizer writes it; the other tensors do not change."""
    stcs = {cb: JConfig.from_directory(d).stc for cb, d in ckpts.items()}
    key = "model.layers.0.mlp.down_proj"
    assert not stcs["3inst"].has_tensor(key + ".mcg") and not stcs["3inst"].has_tensor(key + ".mul1")
    for cb, mult in (("mcg", 0xCBAC1FED), ("mul1", 0x83DCD12D)):
        t = stcs[cb].get_tensor(f"{key}.{cb}")
        assert t.size == 1 and t.dtype == np.int32
        assert int(t.view(np.uint32).reshape(())) == mult
        assert np.array_equal(stcs[cb].get_tensor(key + ".trellis"),
                              stcs["3inst"].get_tensor(key + ".trellis"))
    with pytest.raises(ValueError, match="unknown codebook"):
        write_tiny_llama_exl3("unused", codebook="e8p")
