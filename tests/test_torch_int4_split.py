"""The staged int4 kernel's arithmetic (csrc/int4_matmul.cu at m <= 16, kernel
rows 11 and 12) against the JAX package on the CPU: the kernel's split runs
of k steps (128 packed rows, both nibble planes) with f32 partial sums added
in split order, on the a8 route (int4_matmul_a8_split_plain, the row scale
last) against JAX's int4_matmul_a8 (_int4_a8_kernel in interpret mode) and
on the bf16 route (int4_matmul_split_plain) against JAX's int4_matmul_pallas
(_int4_matmul_kernel in interpret mode), at every split count the sizing can
pick; and the sizing itself, both routes, at the Llama-3.1-8B and 70B
shapes. The CUDA kernel is held against the plain versions on the card by
chip_smoke.py."""
import functools
import re
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from exllamav3_tpu.ops import q_matmul as J
from exllamav3_tpu_torch.ops import q_matmul as P
from exllamav3_tpu_torch.ops.build import header_constants
from exllamav3_tpu_torch.util.params import _np_to_torch as to_torch

N = 128
CSRC = Path(P.__file__).resolve().parent.parent / "csrc"
SHAPES_8B = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32768)]
SHAPES_70B = [(8192, 10240), (8192, 8192), (8192, 57344), (28672, 8192)]


@functools.lru_cache(maxsize=None)
def _jax_case(k: int):
    """(x (13, k), packed, scales, JAX's product) through JAX's
    int4_matmul_a8, the W4A8 Pallas kernel in interpret mode. Each output
    row depends on its own x row alone (the row quantizer too), so its first
    m rows are the product of x's first m."""
    w = (np.random.default_rng(13).standard_normal((k, N)) * 0.02).astype(np.float32)
    packed, scales = J.int4_pack_jnp(jnp.asarray(w))
    jp, js = np.asarray(packed), np.asarray(scales)
    x = np.random.default_rng(6).standard_normal((13, k)).astype(np.float32)
    ref = np.asarray(J.int4_matmul_a8(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js),
                                      interpret=True))
    return x, jp, js, ref


@functools.lru_cache(maxsize=None)
def _jax_bf16_case(k: int):
    """(x (13, k) bf16 values as f32, packed, scales, JAX's product) through
    JAX's int4_matmul_pallas, the bf16 Pallas kernel in interpret mode, on the
    same weights as _jax_case (x padded to 16 rows, its bf16 tile)."""
    _, jp, js, _ = _jax_case(k)
    x = np.random.default_rng(7).standard_normal((13, k)).astype(np.float32)
    xb = jnp.pad(jnp.asarray(x, dtype=jnp.bfloat16), ((0, 3), (0, 0)))
    ref = np.asarray(J.int4_matmul_pallas(xb, jnp.asarray(jp), jnp.asarray(js),
                                          interpret=True))[:13]
    return np.array(xb[:13].astype(jnp.float32)), jp, js, ref


@pytest.mark.parametrize("m", [1, 8, 13])
@pytest.mark.parametrize("k", [448, 4096])
def test_bf16_split_plain_matches_jax_kernel(k, m):
    """The bf16 route: every split count from 1 to the k steps against JAX's
    bf16 kernel in interpret mode (_jax_bf16_case), 1e-4 of the largest
    output (the same bf16 products, f32 sums in another order); the plain
    version the dispatcher runs on the CPU alike."""
    x, jp, js, ref = _jax_bf16_case(k)
    x, ref = x[:m], ref[:m]
    steps = -(-k // 2 // P.INT4_STEP_ROWS)
    for splits in range(1, steps + 1):
        got = P.int4_matmul_split_plain(torch.from_numpy(x), to_torch(jp), to_torch(js),
                                        splits).numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), splits
    plain = P.int4_matmul_plain(torch.from_numpy(x), to_torch(jp), to_torch(js)).numpy()
    assert np.abs(plain - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("m", [1, 8, 13])
@pytest.mark.parametrize("k", [448, 4096])
def test_split_plain_matches_jax_kernel(k, m):
    """Every split count from 1 to the k steps (those the sizing may pick at
    any width or SM count) against JAX's kernel in interpret mode
    (_jax_case); k = 448 is no multiple of a step (224 packed rows: one step
    of 4 scale groups and one of 3), m = 13 fills part of the second 8-row
    tile. 1e-4 of the largest output: the same int8 operands, f32 sums in
    another order."""
    x, jp, js, ref = _jax_case(k)
    x, ref = x[:m], ref[:m]
    steps = -(-k // 2 // P.INT4_STEP_ROWS)
    assert steps == (2 if k == 448 else 16)
    for splits in range(1, steps + 1):
        got = P.int4_matmul_a8_split_plain(torch.from_numpy(x), to_torch(jp), to_torch(js),
                                           splits).numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), splits
    # the plain version the dispatcher runs on the CPU computes the same product
    plain = P.int4_matmul_a8_plain(torch.from_numpy(x), to_torch(jp), to_torch(js)).numpy()
    assert np.abs(plain - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("a8", [True, False], ids=["a8", "bf16"])
@pytest.mark.parametrize("k,n", SHAPES_8B + SHAPES_70B)
def test_split_count_balanced_and_fits(k, n, a8):
    """At the 8B and 70B shapes, 1 to 16 rows, two SM counts and both
    routes: no split without a step, runs that differ by at most one step,
    at most INT4_MAX_SPLITS splits, and the split's x within a block's
    shared memory."""
    steps = -(-k // 2 // P.INT4_STEP_ROWS)
    for m in (1, 8, 13, 16):
        for sms in (114, 132):
            splits = P.int4_split_count(m, k, n, sms, a8)
            runs = [s1 - s0 for s0, s1 in P._intb_split_steps(steps, splits)]
            assert 1 <= splits <= min(steps, P.INT4_MAX_SPLITS) and sum(runs) == steps
            assert min(runs) >= 1 and max(runs) - min(runs) <= 1
            assert P._int4_smem(m, max(runs), a8) <= P.INT4_MAX_SMEM


@pytest.mark.parametrize("m,k,n,want", [
    (8, 4096, 6144, 8),     # qkv: 48 tiles x 8 splits of 2 steps, 3 blocks an SM
    (1, 4096, 4096, 8),     # o_proj: 32 tiles x 8 splits
    (8, 14336, 4096, 8),    # down: 56 steps in runs of 7
    (8, 4096, 28672, 1),    # gate_up: 224 tiles, every step in one block
    (16, 4096, 32768, 1),
    (13, 28672, 8192, 14),  # 70B down at 16-row tiles: x of a long split does not fit
])
def test_split_count_at_llama_shapes(m, k, n, want):
    """The sizing on 132 SMs: the fewest steps on the busiest SM among
    resident grids, then the most blocks an SM runs at once, then the fewest
    splits, at most INT4_MAX_SPLITS."""
    assert P.int4_split_count(m, k, n, 132) == want


def test_int4_constants_match_the_kernel():
    """The wrapper's limits and layout sizes are read from the kernel's
    layout header, where each is defined once and nowhere else in csrc/, as
    header_constants reads them; the kernel includes that header, and its
    launch bounds name the blocks an SM the sizing reckons with."""
    layout = (CSRC / "int4_layout.cuh").read_text()
    src = (CSRC / "int4_matmul.cu").read_text()
    values = (P._INT4_WARPS, P.INT4_STEP_ROWS, P._INT4_STAGES, P._INT4_BLOCKS, P.INT4_DECODE_ROWS,
              P.INT4_MAX_SMEM, P._INT4_BYTE_STAGE, P._INT4_SCALE_STAGE, P._INT4_X_ALIGN,
              P._INT4_X_PAD, P._INT4_X_PAD_BF16, P._INT4_X_SUMS)
    assert len(values) == len(P._INT4_LAYOUT)
    for name, value in zip(P._INT4_LAYOUT, values):
        assert re.findall(rf"^constexpr int {name} = (\d+);", layout, re.M) == [str(value)]
        assert header_constants("int4_layout.cuh", name) == (value,)
        assert not re.search(rf"constexpr int {name}\b", src)
    assert '#include "int4_layout.cuh"' in src
    assert re.findall(r"__launch_bounds__\(([^)]*)\)", src) == ["THREADS, INT4_BLOCKS"]
    assert P._INT4_BN == 128 and P.INT4_DECODE_ROWS == P.SMALL_M
    assert P._INT4_BYTE_STAGE == P.INT4_STEP_ROWS * 32


def _layout_smem(tmp_path, cases):
    """int4_decode_smem(m, kh, splits, a8) of csrc/int4_layout.cuh for each
    case, compiled by the host's C++ compiler."""
    cpp = tmp_path / "smem.cpp"
    cpp.write_text('#include <cstdio>\n#include "int4_layout.cuh"\nint main() {\n'
                   '    int m, kh, splits, a8;\n'
                   '    while (std::scanf("%d %d %d %d", &m, &kh, &splits, &a8) == 4)\n'
                   '        std::printf("%d\\n", int4_decode_smem(m, kh, splits, a8 != 0));\n'
                   '}\n')
    exe = tmp_path / "smem"
    subprocess.run(["c++", "-std=c++17", "-Wall", "-Werror", f"-I{CSRC}", str(cpp), "-o", str(exe)],
                   check=True)
    text = "".join(f"{m} {kh} {s} {int(a8)}\n" for m, kh, s, a8 in cases)
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True, check=True)
    return [int(v) for v in out.stdout.split()]


def test_int4_smem_matches_the_layout_header(tmp_path):
    """_int4_smem and the sizing's fit test (at most INT4_MAX_SMEM) against
    the layout header's own reckoning, compiled, on both routes: 8- and
    16-row blocks, every split length from one step to past the longest
    that fits, then every split count, none and one too many included, at
    the 8B and 70B k."""
    cases, want = [], []
    for a8 in (True, False):
        for m in (1, 8, 9, 16):
            for per in range(1, 121):
                cases.append((m, P.INT4_STEP_ROWS * per, 1, a8))
                smem = P._int4_smem(m, per, a8)
                want.append(smem if smem <= P.INT4_MAX_SMEM else 0)
            for k in (448, 4096, 8192, 14336, 28672):
                kh = k // 2
                steps = -(-kh // P.INT4_STEP_ROWS)
                for splits in range(steps + 2):
                    cases.append((m, kh, splits, a8))
                    smem = P._int4_smem(m, -(-steps // splits), a8) if 1 <= splits <= steps else 0
                    want.append(smem if smem <= P.INT4_MAX_SMEM else 0)
    assert 0 in want and max(want) > 0  # both sides of the limit are reached
    assert _layout_smem(tmp_path, cases) == want


def test_int4_counts_every_kernel_where_it_launches():
    """csrc/int4_matmul.cu counts each of its kernels beside its launch: the
    staged body of both routes (one launch site, templated on the route, one
    count) and the a8 route's row quantizer (two element types, one count)
    here, packed_matmul.cuh's product, quantizer and reduce in that header's
    launcher, which the int4 entries hand their count array. Both entries
    take the staged body up to 16 rows, the bf16 one with no quantizer. No
    int4 launch goes uncounted."""
    src = (CSRC / "int4_matmul.cu").read_text()
    launches = re.findall(r"([\w:]+(?:<[^<>]*>)?)<<<|cudaLaunchKernelEx\(\s*&cfg, (\w+)", src)
    assert sorted(a.split("<")[0] or b for a, b in launches) == [
        "int4_decode_kernel", "packed::quantize_rows_dependents",
        "packed::quantize_rows_dependents"]
    assert re.search(r"cudaLaunchKernelEx\(\s*&cfg, int4_decode_kernel<A8, NR>", src)
    assert sorted(re.findall(r"\+\+int4_launch_count\[(\d)\]", src)) == ["1", "3"]
    # the quantizer's count sits in the a8 route's branch alone
    body = src[src.index("int launch_decode("):]
    assert body.index("if constexpr (A8)") < body.index("++int4_launch_count[1]") \
        < body.index("cudaLaunchConfig_t cfg")
    for entry, route in (("exl3_int4_matmul(", "launch_staged<false>"),
                         ("exl3_int4_matmul_a8(", "launch_staged<true>")):
        text = src[src.index('extern "C" int ' + entry):]
        assert route in text[:text.index("\n}\n")]
    assert src.count("packed::launch<") == 2 and src.count("int4_launch_count);") == 2
    header = (CSRC / "packed_matmul.cuh").read_text()
    body = header[header.index("int launch("):]
    # the quantizer (two element types), the product (two tilings), the reduce
    assert body.count("<<<") == 5
    assert sorted(re.findall(r"\+\+counts\[(\d)\]", body)) == ["0", "1", "2"]
