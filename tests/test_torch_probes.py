"""The port's measurement probes (exllamav3_tpu_torch/probes/) against the
JAX package's probe tools (tools/*.py) on the CPU: every variant's plain
version against the tool's Pallas kernel in interpret mode, on the same
numpy inputs, at small shapes.

The tools are loaded from their files. dma_floor.py and a8_ablate.py run
their timing loops at import, so only their import and def statements are
executed. pallas_call is patched to interpret=True for these tests alone;
the patch can also hand a kernel the test's numpy inputs in place of the
ones a tool draws itself (dequant_probe.py's build).

Tolerances, relative to the largest magnitude of the JAX output: exact where
the output is a sum of integers below 2^24 (dma_floor; a8_ablate's dotpar,
dot, dot2, extract, convonly), else 1e-5 (the same operations, f32 sums in
another order).
"""
import ast
import importlib.util
import os

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops.exl3_gemm import prepare_trellis_words
from exllamav3_tpu.ops.q_matmul import int4_pack_jnp
from exllamav3_tpu_torch.probes import a8_ablate as PA
from exllamav3_tpu_torch.probes import a8_diag_proto as PD
from exllamav3_tpu_torch.probes import dequant_probe as PQ
from exllamav3_tpu_torch.probes import dma_floor as PF
from exllamav3_tpu_torch.probes import fused_ablate as PT
from exllamav3_tpu_torch.probes import int4_sweep as PS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
TOL = 1e-5
ORIGINAL_PALLAS_CALL = pl.pallas_call


def _tool(name: str, defs_only: bool = False):
    """tools/<name>.py as a module; defs_only executes only its import and
    def statements."""
    path = os.path.join(TOOLS, name + ".py")
    if not defs_only:
        spec = importlib.util.spec_from_file_location("jax_tool_" + name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tree.body = [n for n in tree.body
                 if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns = {"__name__": "jax_tool_" + name, "__file__": path}
    exec(compile(tree, path, "exec"), ns)
    return type("Tool", (), ns)


class Interpret:
    """pallas_call with interpret=True; argument i of a kernel call is
    replaced by `replace[i]` where given."""

    def __init__(self):
        self.replace = {}

    def __call__(self, kernel, *a, **kw):
        fn = ORIGINAL_PALLAS_CALL(kernel, *a, **dict(kw, interpret=True))

        def call(*args):
            return fn(*[jnp.asarray(self.replace[i]) if i in self.replace else x
                        for i, x in enumerate(args)])
        return call


@pytest.fixture
def interpret(monkeypatch):
    it = Interpret()
    monkeypatch.setattr(pl, "pallas_call", it)
    return it


def to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_close(got: torch.Tensor, ref, tol: float = TOL, what: str = ""):
    ref = np.asarray(ref, np.float32)
    got = got.to(torch.float32).numpy().reshape(ref.shape)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0, what
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= tol, f"{what}: rel err {err:.3e} > {tol}"


def _int4_weight(k: int, n: int, seed: int):
    """The tools' int4 weight: a 0.02-normal (k, n) packed by the JAX packer."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.02
    packed, scales = int4_pack_jnp(jnp.asarray(w))
    return np.asarray(packed), np.asarray(scales)


# -- row 20: dma_floor -------------------------------------------------------------

@pytest.mark.parametrize("bn,bkh", PF.GEOMETRIES)
def test_dma_floor(interpret, bn, bkh):
    tool = _tool("dma_floor", defs_only=True)
    b = np.random.default_rng(0).integers(-128, 128, (2048, 2048)).astype(np.int8)
    ref = tool.dma_only(jnp.asarray(b), bn=bn, bkh=bkh)
    got = PF.dma_floor(to_torch(b), bn, bkh)
    assert got.shape == (16, 2048)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- row 15: fused_ablate ----------------------------------------------------------

FUSED_CASES = [(v, 256, 512, 4, 256, 128) for v in PT.VARIANTS]
FUSED_CASES += [(v, 512, 256, 3, 128, 256) for v in ("ingest", "full")]  # odd K, bk = 256


@pytest.mark.parametrize("variant,k,n,K,bn,bk", FUSED_CASES)
def test_fused_ablate(interpret, variant, k, n, K, bn, bk):
    tool = _tool("fused_ablate")
    rng = np.random.default_rng(K)
    trellis = rng.integers(-32768, 32768, size=(k // 16, n // 16, 16 * K)).astype(np.int16)
    words = prepare_trellis_words(trellis)
    x = rng.standard_normal((16, k)).astype(np.float32)
    xh = jnp.asarray(x).astype(jnp.bfloat16)
    ref = tool.run_variant(xh, jnp.asarray(words), K, variant, 16, bn, bk)
    got = PT.fused_ablate(to_torch(xh), torch.from_numpy(words), K, variant, 16, bn, bk)
    assert_close(got, ref, what=f"fused_ablate {variant} K={K}")


def test_fused_ablate_weights_are_the_format_values_permuted():
    """f16pair's weights are the format's decoded values (fp16 sums, as
    ops/exl3_gemm.py decodes them) in the block's permuted order; full's are
    the same values summed in f32 and carrying the factor 2^-112 of the JAX
    probe's decode, which never applies decode_scale."""
    from exllamav3_tpu_torch.ops.exl3_gemm import exl3_gemm_plain

    rng = np.random.default_rng(1)
    k = n = 128
    words = torch.from_numpy(prepare_trellis_words(
        rng.integers(-32768, 32768, size=(k // 16, n // 16, 64)).astype(np.int16)))
    true_w = exl3_gemm_plain(torch.eye(k, dtype=torch.bfloat16), words, 4, 0).flatten()
    f16 = PT.probe_weight(words, 4, "f16pair", bn=128, bk=128).to(torch.float32).flatten()
    assert torch.equal(f16.sort().values, true_w.sort().values)
    assert not torch.equal(f16, true_w)
    full = PT.probe_weight(words, 4, "full", bn=128, bk=128).to(torch.float32).flatten()
    err = (full.sort().values * 2.0 ** 112 - true_w.sort().values).abs().max()
    assert float(err) <= 2.0 ** -7 * float(true_w.abs().max())


# -- row 16: dequant_probe -----------------------------------------------------------

def _dequant_inputs(variant: str, ctx: int, bits: int, Hk: int, G: int = 4, D: int = 128):
    rng = np.random.default_rng(16)
    pages, g = ctx // 256, D // 32
    if variant == "bf16":
        q = rng.standard_normal((1, Hk, G, D)).astype(np.float32)
        k = rng.standard_normal((pages, 256, Hk, D)).astype(np.float32).astype(jnp.bfloat16)
        return {0: q, 1: k}
    lead = (pages, 256, Hk * g * bits) if variant in PQ.MERGED else (pages, 256, Hk, g * bits)
    kq = rng.integers(-2**31, 2**31, lead, dtype=np.int64).astype(np.int32)
    ks = (rng.random(lead[:-1] + (lead[-1] // bits,)) + 0.5).astype(np.float32) \
        .astype(jnp.bfloat16)
    q = rng.standard_normal((Hk * G, Hk * D) if variant in PQ.MERGED else (1, Hk, G, D)) \
        .astype(np.float32)
    return {0: q, 1: kq, 2: ks}


def _dequant_jax(interpret, variant: str, ctx: int = 512, bits: int = 4, Hk: int = 2):
    tool = _tool("dequant_probe")
    interpret.replace = _dequant_inputs(variant, ctx, bits, Hk)
    ref = np.asarray(tool.build(variant, ctx, bits, Hk=Hk, reps=1)())
    args = [to_torch(interpret.replace[i]) for i in sorted(interpret.replace)]
    return ref, args + [None] * (3 - len(args))


@pytest.mark.parametrize("variant", PQ.VARIANTS)
def test_dequant_probe(interpret, variant):
    ref, (q, kq, ks) = _dequant_jax(interpret, variant)
    got = PQ.dequant_probe(q, kq, ks, variant, 4)
    assert got.shape == ref.shape
    assert_close(got, ref, what=f"dequant_probe {variant}")


def test_dequant_probe_magic_exponent_is_not_v0(interpret):
    """A fact about the JAX tool, kept as one: v1's magic-exponent dequant,
    fma(2^23 + field, scale, scale * c) with c = f32(-(2^23 + 7.5)), does not
    compute v0's (field - 7.5) * scale. c rounds to -8388616, half a unit
    off, and scale * c rounds again, so every key lands below v0's, by 0.03
    to 0.92 of a scale step here and by half a step on average; summed over
    512 keys, the scores differ by more than their range. (XLA contracts the
    tool's multiply-add into one rounding; the port's v1 does the same.)"""
    ref0, (q, kq, ks) = _dequant_jax(interpret, "v0")
    ref1, _ = _dequant_jax(interpret, "v1")
    assert np.abs(ref1 - ref0).max() > np.abs(ref0).max()
    T = kq.shape[0] * kq.shape[1]
    w, sc = kq[:, :, 0].reshape(T, -1), ks[:, :, 0].reshape(T, -1)
    step = (PQ.dequant(w, sc, "v1", 4, 128) - PQ.dequant(w, sc, "v0", 4, 128)) \
        / sc.to(torch.float32)[:, PQ._lanes(128, 128, 4, 16, False, "cpu")[2]]
    assert -1.0 < float(step.min()) and float(step.max()) < 0.0
    assert abs(float(step.mean()) + 0.5) < 0.05


# -- row 17: int4_sweep ----------------------------------------------------------------

@pytest.mark.parametrize("variant", PS.VARIANTS)
@pytest.mark.parametrize("geometry", PS.GEOMETRIES)
def test_int4_sweep(interpret, variant, geometry):
    tool = _tool("int4_sweep")
    packed, scales = _int4_weight(2048, 512, 17)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((16, 2048)), jnp.bfloat16)
    bm, bn, bkh = geometry
    ref = tool.int4_mm(x, jnp.asarray(packed), jnp.asarray(scales), variant=variant,
                       block_m=bm, block_n=bn, block_kh=bkh)
    got = PS.int4_sweep(to_torch(x), to_torch(packed), to_torch(scales), variant, bm, bn, bkh)
    assert_close(got, ref, what=f"int4_sweep {variant} {geometry}")


# -- row 18: a8_ablate -------------------------------------------------------------------

@pytest.mark.parametrize("stage", PA.STAGES)
def test_a8_ablate(interpret, stage):
    tool = _tool("a8_ablate", defs_only=True)
    packed, scales = _int4_weight(2048, 512, 18)
    kh = 1024
    xl = np.random.default_rng(6).integers(-127, 128, (kh // 512, 16, 512)).astype(np.int8)
    scales3 = scales[: kh // 32, None, :]
    ref = np.asarray(tool.call(jnp.asarray(xl), jnp.asarray(packed), jnp.asarray(scales3), stage))
    got = PA.a8_ablate(to_torch(xl), to_torch(packed), to_torch(scales3), stage)
    assert got.shape == ref.shape == (1, 512)
    if stage in PA.EXACT:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        assert_close(got, ref, what=f"a8_ablate {stage}")


# -- row 19: a8_diag_proto ------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("raw_dot", [False, True])
@pytest.mark.parametrize("bn,bkh", [(512, 512), PD.SWEEP[0]])
def test_a8_diag(interpret, m, raw_dot, bn, bkh):
    tool = _tool("a8_diag_proto")
    packed, scales = _int4_weight(2048, 512, 19)
    xq = np.random.default_rng(7).integers(-127, 128, (m, 2048)).astype(np.int8)
    ref = tool.int4_a8_diag(jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(scales),
                            block_n=bn, block_kh=bkh, raw_dot=raw_dot)
    got = PD.int4_a8_diag(to_torch(xq), to_torch(packed), to_torch(scales), block_n=bn,
                          block_kh=bkh, raw_dot=raw_dot)
    assert_close(got, ref, what=f"a8_diag m={m} raw={raw_dot} bkh={bkh}")


# -- the wrappers ------------------------------------------------------------------------------

def _kernel_calls():
    """Each probe's kernel wrapper with small CPU arguments."""
    b = torch.zeros((512, 512), dtype=torch.int8)
    xh = torch.zeros((16, 128), dtype=torch.bfloat16)
    words = torch.zeros((8, 4, 64), dtype=torch.int32)
    q = torch.zeros((1, 2, 4, 128))
    kq = torch.zeros((1, 256, 2, 16), dtype=torch.int32)
    ks = torch.zeros((1, 256, 2, 4), dtype=torch.bfloat16)
    x = torch.zeros((16, 128), dtype=torch.bfloat16)
    s = torch.zeros((4, 512), dtype=torch.bfloat16)
    xl = torch.zeros((1, 16, 512), dtype=torch.int8)
    xd = torch.zeros((1, 16, 512), dtype=torch.int8)
    sd = torch.zeros((32, 512), dtype=torch.bfloat16)
    return {
        "dma_floor": (PF, lambda: PF.dma_floor_kernel(b)),
        "fused_ablate": (PT, lambda: PT.fused_ablate_kernel(xh, words, 4, "full", 16, 128, 128)),
        "dequant_probe": (PQ, lambda: PQ.dequant_probe_kernel(q, kq, ks, "v0", 4)),
        "int4_sweep": (PS, lambda: PS.int4_sweep_kernel(x, b[:64], s, "i32")),
        "a8_ablate": (PA, lambda: PA.a8_ablate_kernel(
            xl, b, torch.zeros((16, 1, 512), dtype=torch.bfloat16), "dot")),
        "a8_diag_proto": (PD, lambda: PD.a8_diag_kernel(xd, xd, b, sd, 1)),
    }


@pytest.mark.parametrize("name", ["dma_floor", "fused_ablate", "dequant_probe", "int4_sweep",
                                  "a8_ablate", "a8_diag_proto"])
def test_kernel_wrappers_refuse_cpu_and_never_fall_back(monkeypatch, name):
    """A kernel wrapper refuses CPU tensors rather than run its plain
    version; given tensors it takes as CUDA ones, it needs the built library
    and raises where that cannot be built (no nvcc here): no fallback."""
    mod, call = _kernel_calls()[name]
    with pytest.raises(ValueError, match="one CUDA device"):
        call()
    monkeypatch.setattr(mod, "cuda_args", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: None)
    import exllamav3_tpu_torch.ops.build as build

    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(build, "_LIB", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        call()
