"""The port's trellis-word layout, `fused` linear and plain trellis-decode
product against the JAX package (its Pallas kernel in interpret mode), on the
CPU; the kernel's split arithmetic (exl3_gemm_split_plain) against the JAX
kernel's core and the JAX reconstruct product, and its split sizing. The
CUDA kernel itself is held against `exl3_gemm_plain` on the card by
chip_smoke.py."""
import re
from pathlib import Path

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
from exllamav3_tpu.quant.reconstruct import reconstruct_inner_jnp
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
    for K in (1, 2, 4, 8):
        for sms in (114, 132):
            splits = pgemm.split_count(m, k, n, K, sms)
            steps = k // 128
            per = -(-steps // splits)
            assert 1 <= splits <= steps and (splits - 1) * per < steps
            if m <= pgemm.DECODE_ROWS:  # a decode-size split stages its xh at once
                assert per <= pgemm.XH_ONCE_STEPS


@pytest.mark.parametrize("m,k,n,K,want", [
    (8, 4096, 4096, 4, 8),      # q/o: 32 column tiles x 8 splits of 4 steps, 256 blocks
    (1, 4096, 4096, 4, 8),
    (8, 4096, 1024, 4, 16),     # k/v: 8 column tiles, 2 steps a split
    (8, 4096, 14336, 4, 2),     # gate/up: 112 tiles x 2 splits of 16 steps
    (8, 14336, 4096, 4, 8),     # down: 112 steps in 8 splits of 14
    (8, 4096, 32768, 4, 2),     # lm_head: 16 steps a split, the most xh a block stages
    (8, 4096, 4096, 1, 8),
    (8, 4096, 4096, 8, 4),      # 16 KB of words a step: one block an SM keeps enough in flight
    (40, 4096, 4096, 4, 8),     # speculative verify at batch 8: one 128-row block
    (128, 4096, 4096, 4, 4),    # 128 rows: a block's step is 8 times the products
    (128, 4096, 1024, 4, 16),
    (128, 4096, 14336, 4, 1),
    (2048, 4096, 4096, 4, 1),   # prefill: 512 blocks without a split
])
def test_split_count_at_llama_8b_shapes(m, k, n, K, want):
    """The sizing at the capacity path's shapes on a card of 132 SMs: the
    fewest k steps on the busiest SM, and of those the fewest splits that
    keep IN_FLIGHT_PER_SM bytes in flight."""
    assert pgemm.split_count(m, k, n, K, 132) == want


def test_gemm_constants_match_the_kernel():
    """The wrapper's limits are read from the kernel's source, where each is
    defined once; the one device kernel a call is counted there."""
    src = (Path(pgemm.__file__).resolve().parent.parent / "csrc" / "exl3_gemm.cu").read_text()
    for name, value in (("GEMM_STAGES", pgemm._STAGES),
                        ("PREFILL_STAGES", pgemm._PREFILL_STAGES),
                        ("XH_ONCE_STEPS", pgemm.XH_ONCE_STEPS),
                        ("DECODE_MB", pgemm.DECODE_ROWS // 16),
                        ("PREFILL_MB", pgemm.BLOCK_ROWS // 16),
                        ("KC", pgemm._KC), ("LDW", pgemm._LDW), ("LDA", pgemm._LDA),
                        ("DECODE_BLOCKS", pgemm._DECODE_BLOCKS),
                        ("PREFILL_BLOCKS", pgemm._PREFILL_BLOCKS)):
        assert re.findall(rf"^constexpr int {name} = (\d+);", src, re.M) == [str(value)]
    # the sizing's blocks an SM are the launch bounds these constants name
    assert re.findall(r"__launch_bounds__\(([^)]*)\)", src) == [
        "THREADS, MB == DECODE_MB ? DECODE_BLOCKS : PREFILL_BLOCKS"]
    assert "exl3_gemm_reduce" not in src and src.count("<<<") == 1


@pytest.mark.parametrize("m,k,n,want", [(1, 4096, 4096, 3), (8, 4096, 32768, 3),
                                        (128, 4096, 4096, 2), (2048, 4096, 14336, 2)])
def test_blocks_per_sm_as_the_card_reads_them(m, k, n, want):
    """The sizing's blocks an SM (K = 4) at shapes where the H100 reported
    them (exl3_gemm_blocks_per_sm, cudaOccupancyMaxActiveBlocksPerMultiprocessor):
    three decode-size blocks whatever the split, two 128-row ones."""
    splits = pgemm.split_count(m, k, n, 4, 132)
    per = -(-(k // 128) // splits)
    assert pgemm._blocks_per_sm(m, 4, per) == want


def _jax_core(words: np.ndarray, x: np.ndarray, K: int, cb: int) -> np.ndarray:
    """JAX's kernel core in interpret mode on rows x (m, k) bf16, in true
    row and column order and scale: exl3_matmul_fused's orders (its permuted
    Hadamards' kernel row and column order within a 16-wide tile, its k
    lanes of 128-wide blocks, its output columns of one 256-wide n block)
    undone around it, and decode_scale."""
    m, k = x.shape
    n = words.shape[2] * 2
    bk, bn = 128, 256
    xk = x[:, (np.arange(k) // 16) * 16 + jgemm._perm_within16_k()[np.arange(k) % 16]]
    xp = xk.reshape(m, k // bk, bk // 16, 16).transpose(0, 1, 3, 2).reshape(m, k)
    y = np.asarray(jgemm.exl3_gemm_core(jnp.asarray(xp, jnp.bfloat16), jnp.asarray(words), K, cb,
                                        block_m=128, block_n=bn, block_k=bk, interpret=True))
    y = y.reshape(m, n // bn, 2, bn // 16, 8).transpose(0, 1, 3, 4, 2).reshape(m, n)
    out = np.empty_like(y)
    out[:, (np.arange(n) // 16) * 16 + jgemm._perm_within16_n()[np.arange(n) % 16]] = y
    return out * np.float32(jgemm.decode_scale(cb))


@pytest.mark.parametrize("cb", [0, 1, 2], ids=["3inst", "mcg", "mul1"])
@pytest.mark.parametrize("K", range(1, 9))
def test_split_plain_matches_jax_core_and_plain(K, cb):
    """exl3_gemm_split_plain (per-split f32 partial sums over whole 128-wide
    k steps, added in split order) at one and two splits, against JAX's
    reconstruct product (bf16 operands, f32 sums) and against JAX's kernel
    core in interpret mode, each at 1e-4 of the largest output. The JAX core
    rounds a decoded weight once from f32 to bf16, the format (and the port)
    adds its two fp16 halves in fp16 first: the core's own weights, read by
    running it on the identity, differ from the port's by at most one bf16
    step on a few per cent of the weights, and the comparison adds xh times
    that difference to the core's product (MUL1: the core's f32
    multiply-add against the format's fp16 one, up to a tenth of them)."""
    rng = np.random.default_rng(300 + 8 * cb + K)
    m, k, n = 8, 256, 256
    trellis = rng.integers(-32768, 32768, size=(k // 16, n // 16, 16 * K)).astype(np.int16)
    words = jgemm.prepare_trellis_words(trellis)
    x = (rng.standard_normal((m, k)) * 0.5).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    # one core call: the identity's rows give its weights, the last 128 (x
    # padded) its product
    rows = np.concatenate([np.eye(k, dtype=np.float32), xb, np.zeros((120, k), np.float32)])
    y = _jax_core(words, rows, K, cb)
    w_core, core = y[:k], y[k:k + m]
    w_ref = np.asarray(reconstruct_inner_jnp(jnp.asarray(trellis), K, cb, dtype=jnp.bfloat16)
                       .astype(jnp.float32))
    plain = np.asarray(jnp.dot(jnp.asarray(xb, jnp.bfloat16), jnp.asarray(w_ref, jnp.bfloat16),
                               preferred_element_type=jnp.float32))
    w_port = pgemm.reconstruct_inner(torch.from_numpy(trellis), K, cb,
                                     dtype=torch.bfloat16).float().numpy()
    assert np.array_equal(w_port, w_ref)
    assert np.mean(w_port != w_core) < 0.1
    assert np.all(np.abs(w_port - w_core) <= 2.0 ** -7 * np.abs(w_port))
    ref_core = core + xb @ (w_port - w_core)
    xh = torch.from_numpy(x).to(torch.bfloat16)
    for splits in (1, 2):
        got = pgemm.exl3_gemm_split_plain(xh, torch.from_numpy(words), K, cb, splits).numpy()
        tol = 1e-4 * np.abs(plain).max()
        np.testing.assert_allclose(got, plain, rtol=0, atol=tol)
        np.testing.assert_allclose(got, ref_core, rtol=0, atol=tol)


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
