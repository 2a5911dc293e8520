"""The staged int8 body's arithmetic (csrc/int8_staged.cuh, m <= 16: the int8
matmul, kernel row 1, and both phases of the fused MLP, row 2) against the
JAX package on the CPU: int8_matmul_split_plain, the kernel's split runs of k
steps (128 rows; the last may be short) with f32 partial sums added in split
order and the column scale last, against JAX's int8_matmul_pallas, and
fused_mlp_int8_split_plain, the first phase's split sums, activation and bf16
round feeding the second phase's split sums, against JAX's
fused_mlp_int8_pallas, both Pallas kernels in interpret mode, at every split
count the sizing can pick; then the sizing at the shapes chip_smoke.py uses,
and csrc/int8_layout.cuh compiled by the host's C++ compiler against the
sizing's reckoning of shared memory. The CUDA kernels are held against the
plain versions on the card by chip_smoke.py."""
import functools
import re
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(2)

from exllamav3_tpu.ops.fused_mlp import fused_mlp_int8_pallas
from exllamav3_tpu.ops.q_matmul import int8_matmul_pallas
from exllamav3_tpu_torch.ops import fused_mlp as F
from exllamav3_tpu_torch.ops import q_matmul as P
from exllamav3_tpu_torch.ops.build import header_constants

N = 128
CSRC = Path(P.__file__).resolve().parent.parent / "csrc"
# (k, n) of the int8 linears chip_smoke.py runs: Llama-3.1-8B, Qwen3-30B-A3B,
# DeepSeek-V2-Lite's 576 and 10944, Gemma-3-27B's qkv and o_proj
LINEARS = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32768),
           (2048, 5120), (4096, 2048), (2048, 151936), (2048, 576), (10944, 2048),
           (5376, 8192), (4096, 5376)]
# (h, i) of the fused MLPs chip_smoke.py runs: Llama-3.1-8B, DeepSeek-V2-Lite's
# shared experts, Gemma-3-27B, DeepSeek-V4's shared expert
MLPS = [(4096, 14336), (2048, 2816), (5376, 21504), (7168, 2048)]


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16, so that both packages see the same x."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _splits(k: int) -> range:
    """Every split count the sizing may pick for k rows, at any width or SM
    count: 1 to the k steps, at most INT8_MAX_SPLITS."""
    return range(1, min(-(-k // P.INT8_STEP_ROWS), P.INT8_MAX_SPLITS) + 1)


@functools.lru_cache(maxsize=None)
def _jax_matmul(k: int):
    """(x (16, k), w, scale, JAX's product) through int8_matmul_pallas in
    interpret mode. Each output row depends on its own x row alone, so its
    first m rows are the product of x's first m."""
    rng = np.random.default_rng(k)
    x = _bf16(rng.standard_normal((16, k)))
    w = rng.integers(-127, 128, size=(k, N)).astype(np.int8)
    scale = ((rng.random(N) + 0.5) * 0.01).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(int8_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                                            block_m=16, block_n=N, block_k=64))
    return x, w, scale, ref


@pytest.mark.parametrize("m", [1, 8, 13, 16])
@pytest.mark.parametrize("k", [448, 1024])
def test_int8_split_plain_matches_jax_kernel(k, m):
    """Every split count against JAX's kernel in interpret mode; k = 448 is no
    multiple of a step (three steps of 128 rows and one of 64), m = 13 fills
    part of the second 8-row tile. 1e-5 of the largest output: the same exact
    bf16 products, f32 sums in another order."""
    x, w, scale, ref = _jax_matmul(k)
    x, ref = x[:m], ref[:m]
    assert len(_splits(k)) == (4 if k == 448 else 8)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for splits in _splits(k):
        got = P.int8_matmul_split_plain(xt, torch.from_numpy(w), torch.from_numpy(scale),
                                        splits).numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), splits
    # the plain version the dispatcher runs on the CPU computes the same product
    plain = P.int8_matmul_plain(xt, torch.from_numpy(w), torch.from_numpy(scale)).numpy()
    assert np.abs(plain - ref).max() <= 1e-5 * np.abs(ref).max()


@functools.lru_cache(maxsize=None)
def _jax_mlp(activation: str, clamp: float):
    """(x (16, h), gu, gs, d, JAX's (16, h) f32 before the down scale) through
    fused_mlp_int8_pallas in interpret mode, h = 512 (4 steps of the first
    phase), i = 384 (3 steps of the second)."""
    h, inter = 512, 384
    rng = np.random.default_rng(len(activation) + int(clamp))
    x = _bf16(rng.standard_normal((16, h)))
    gu = rng.integers(-127, 128, size=(h, 2 * inter)).astype(np.int8)
    gs = (np.full(2 * inter, 1.0 / (73.0 * np.sqrt(h)))
          * (1 + rng.random(2 * inter))).astype(np.float32)
    d = rng.integers(-127, 128, size=(inter, h)).astype(np.int8)
    ref = np.asarray(fused_mlp_int8_pallas(jnp.asarray(x), jnp.asarray(gu), jnp.asarray(gs),
                                           jnp.asarray(d), activation=activation,
                                           act_clamp=clamp, interpret=True))
    return x, gu, gs, d, ref


@pytest.mark.parametrize("m", [1, 8, 13, 16])
@pytest.mark.parametrize("activation,clamp", [("silu", 0.0), ("gelu", 0.0),
                                              ("gelu_pytorch_tanh", 0.0), ("relu2", 0.0),
                                              ("silu", 0.5)])
def test_fused_mlp_split_plain_matches_jax_kernel(activation, clamp, m):
    """Every pair of split counts of the two phases against JAX's kernel in
    interpret mode, for the four activations and a clamp that clips part of
    the gate values. 2e-3 of the largest output (chip_smoke.py's TOL_MLP):
    the activation is rounded to bf16 on both sides, and a different f32 sum
    order can flip one rounding."""
    x, gu, gs, d, ref = _jax_mlp(activation, clamp)
    x, ref = x[:m], ref[:m]
    h, inter = d.shape[1], d.shape[0]
    args = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(gu), torch.from_numpy(gs),
            torch.from_numpy(d))
    if clamp:  # the clamp clips some gate values, not all
        gate = (x @ gu[:, :inter].astype(np.float32)) * gs[:inter]
        assert 0.05 < (np.abs(gate) > clamp).mean() < 0.95
    for s1 in _splits(h):
        for s2 in _splits(inter):
            got = F.fused_mlp_int8_split_plain(*args, activation, clamp, s1, s2).numpy()
            assert np.isfinite(got).all()
            assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max(), (s1, s2)
    plain = F.fused_mlp_int8_plain(*args, activation, clamp).numpy()
    assert np.abs(plain - ref).max() <= 2e-3 * np.abs(ref).max()


def _check_split_count(m: int, k: int, n: int, sms: int) -> int:
    """int8_split_count's splits: no split without a step, runs that differ
    by at most one step, at most INT8_MAX_SPLITS, and the split's x within a
    block's shared memory."""
    steps = -(-k // P.INT8_STEP_ROWS)
    splits = P.int8_split_count(m, k, n, sms)
    runs = [s1 - s0 for s0, s1 in P._intb_split_steps(steps, splits)]
    assert 1 <= splits <= min(steps, P.INT8_MAX_SPLITS) and sum(runs) == steps
    assert min(runs) >= 1 and max(runs) - min(runs) <= 1
    assert P._int8_smem(m, max(runs)) <= P.INT8_MAX_SMEM
    return splits


@pytest.mark.parametrize("k,n", LINEARS)
def test_int8_split_count_balanced_and_fits(k, n):
    """At the int8 linears' shapes, 1 to 16 rows and two SM counts."""
    for m in (1, 8, 13, 16):
        for sms in (114, 132):
            _check_split_count(m, k, n, sms)


@pytest.mark.parametrize("h,inter", MLPS)
def test_fused_mlp_split_counts_balanced_and_fit(h, inter):
    """Both phases of the fused MLP at its served shapes: the first over the
    2i [gate | up] columns with k = h, the second over h columns with k = i."""
    for m in (1, 8, 13, 16):
        for sms in (114, 132):
            s1, s2 = F.fused_mlp_splits(m, h, inter, sms)
            assert s1 == _check_split_count(m, h, 2 * inter, sms)
            assert s2 == _check_split_count(m, inter, h, sms)


@pytest.mark.parametrize("m,k,n,want", [
    (8, 4096, 6144, 8),      # qkv: 48 tiles x 8 splits of 4 steps, 3 blocks an SM
    (1, 4096, 4096, 8),      # o_proj: 32 tiles x 8 splits
    (8, 14336, 4096, 8),     # down: 112 steps in runs of 14
    (8, 4096, 32768, 1),     # lm_head: 256 tiles, every step in one block
    (8, 2048, 576, 16),      # DeepSeek-V2-Lite kv_a: 5 tiles, at most 16 splits
    (8, 7168, 4096, 8),      # DeepSeek-V4's first phase: 32 tiles over the card
])
def test_int8_split_count_at_shapes(m, k, n, want):
    """The sizing on 132 SMs: the fewest steps on the busiest SM among
    resident grids, then the most blocks an SM runs at once, then the fewest
    splits, at most INT8_MAX_SPLITS."""
    assert P.int8_split_count(m, k, n, 132) == want


def test_int8_constants_match_the_kernel():
    """The wrapper's limits and layout sizes are read from the body's layout
    header, where each is defined once and nowhere else in csrc/, as
    header_constants reads them; the body includes that header, both
    kernels' sources include the body, and its launch bounds name the blocks
    an SM the sizing reckons with."""
    layout = (CSRC / "int8_layout.cuh").read_text()
    body = (CSRC / "int8_staged.cuh").read_text()
    values = (P._INT8_WARPS, P.INT8_STEP_ROWS, P._INT8_STAGES, P._INT8_BLOCKS,
              P.INT8_DECODE_ROWS, P.INT8_MAX_SMEM, P.INT8_MAX_SPLITS, P._INT8_BYTE_STAGE,
              P._INT8_X_PAD)
    assert len(values) == len(P._INT8_LAYOUT)
    for name, value in zip(P._INT8_LAYOUT, values):
        assert re.findall(rf"^constexpr int {name} = (\d+);", layout, re.M) == [str(value)]
        assert header_constants("int8_layout.cuh", name) == (value,)
        for src in ("int8_staged.cuh", "int8_matmul.cu", "fused_mlp.cu"):
            assert not re.search(rf"constexpr int {name}\b", (CSRC / src).read_text())
    assert '#include "int8_layout.cuh"' in body
    for src in ("int8_matmul.cu", "fused_mlp.cu"):
        assert '#include "int8_staged.cuh"' in (CSRC / src).read_text()
    assert re.findall(r"__launch_bounds__\(([^)]*)\)", body) == ["THREADS, INT8_BLOCKS"]
    assert P._INT8_BN == 128 and P.INT8_DECODE_ROWS == P.SMALL_M == F.MAX_ROWS
    assert P._INT8_BYTE_STAGE == P.INT8_STEP_ROWS * 32


def _layout_smem(tmp_path, cases):
    """int8_decode_smem(m, k, splits) of csrc/int8_layout.cuh for each case,
    compiled by the host's C++ compiler."""
    cpp = tmp_path / "smem.cpp"
    cpp.write_text('#include <cstdio>\n#include "int8_layout.cuh"\nint main() {\n'
                   '    int m, k, splits;\n'
                   '    while (std::scanf("%d %d %d", &m, &k, &splits) == 3)\n'
                   '        std::printf("%d\\n", int8_decode_smem(m, k, splits));\n'
                   '}\n')
    exe = tmp_path / "smem"
    subprocess.run(["c++", "-std=c++17", "-Wall", "-Werror", f"-I{CSRC}", str(cpp), "-o", str(exe)],
                   check=True)
    text = "".join(f"{m} {k} {s}\n" for m, k, s in cases)
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True, check=True)
    return [int(v) for v in out.stdout.split()]


def test_int8_smem_matches_the_layout_header(tmp_path):
    """_int8_smem and the sizing's fit test (at most INT8_MAX_SMEM, at most
    INT8_MAX_SPLITS) against the layout header's own reckoning, compiled: 8-
    and 16-row blocks, every split length from one step to past the longest
    that fits, then every split count, none and one too many included, at the
    served k."""
    cases, want = [], []
    for m in (1, 8, 9, 16):
        for per in range(1, 121):
            cases.append((m, P.INT8_STEP_ROWS * per, 1))
            smem = P._int8_smem(m, per)
            want.append(smem if smem <= P.INT8_MAX_SMEM else 0)
        for k in (448, 2048, 2816, 4096, 5376, 7168, 10944, 14336, 21504):
            steps = -(-k // P.INT8_STEP_ROWS)
            for splits in range(min(steps, P.INT8_MAX_SPLITS) + 2):
                cases.append((m, k, splits))
                ok = 1 <= splits <= min(steps, P.INT8_MAX_SPLITS)
                smem = P._int8_smem(m, -(-steps // splits)) if ok else 0
                want.append(smem if smem <= P.INT8_MAX_SMEM else 0)
    assert 0 in want and max(want) > 0  # both sides of the limit are reached
    assert _layout_smem(tmp_path, cases) == want


def test_int8_kernels_count_every_launch():
    """csrc/int8_matmul.cu counts the staged product, the tiled product and
    its reduce beside their launches, csrc/fused_mlp.cu each of its two
    phases; the staged body launches through cudaLaunchKernelEx in one
    launcher, which neither source bypasses."""
    mm = (CSRC / "int8_matmul.cu").read_text()
    mlp = (CSRC / "fused_mlp.cu").read_text()
    body = (CSRC / "int8_staged.cuh").read_text()
    assert sorted(a.split("<")[0] for a in re.findall(r"([\w:]+(?:<[^<>]*>)?)<<<", mm)) == [
        "int8_matmul_kernel", "splitk_reduce_kernel"]
    assert sorted(re.findall(r"\+\+int8_launch_count\[(\d)\]", mm)) == ["0", "1", "2"]
    assert mm.count("int8s::launch<") == 1
    assert "<<<" not in mlp and mlp.count("int8s::launch<") == 2
    assert sorted(re.findall(r"\+\+mlp_launch_count\[(\d)\]", mlp)) == ["0", "1"]
    assert "<<<" not in body and body.count("cudaLaunchKernelEx(") == 2
    assert "tile_reduce_kernel" not in mlp and "TILE_I" not in F.__dict__
