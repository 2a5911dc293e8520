"""The staged int-B kernel's arithmetic (csrc/intb_matmul.cu at m <= 16, kernel
rows 13 and 14) against the JAX package on the CPU: intb_matmul_split_plain,
the kernel's split runs of k steps with f32 partial sums added in split
order (the a8 row scale last), against JAX's Pallas kernels in interpret mode
at every split count the sizing can pick; and the sizing itself at the
Llama-3.1-8B and 70B shapes. The CUDA kernel is held against the plain
versions on the card by chip_smoke.py."""
import functools
import os
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


def _packed(k: int, bits: int):
    w = (np.random.default_rng(11).standard_normal((k, N)) * 0.02).astype(np.float32)
    packed, scales = J.intb_pack_jnp(jnp.asarray(w), bits)
    return np.asarray(packed), np.asarray(scales)


@functools.lru_cache(maxsize=None)
def _jax_case(bits: int, k: int, a8: bool):
    """(x (13, k), packed, scales, JAX's product) through JAX's dispatcher,
    which runs intb_matmul_pallas or intb_matmul_pallas_a8 in interpret mode
    on the CPU. Each output row depends on its own x row alone (the a8 row
    quantizer too), so its first m rows are the product of x's first m."""
    jp, js = _packed(k, bits)
    x = np.random.default_rng(5).standard_normal((13, k)).astype(np.float32)
    saved = {v: os.environ.get(v) for v in ("EXL3TPU_INTB_PALLAS", "EXL3TPU_INTB_A8")}
    os.environ.update(EXL3TPU_INTB_PALLAS="1", EXL3TPU_INTB_A8="1" if a8 else "0")
    try:
        ref = np.asarray(J.intb_matmul(jnp.asarray(x), jnp.asarray(jp), jnp.asarray(js), bits))
    finally:
        for v, old in saved.items():
            if old is None:
                os.environ.pop(v, None)
            else:
                os.environ[v] = old
    return x, jp, js, ref


@pytest.mark.parametrize("a8", [False, True], ids=["bf16", "a8"])
@pytest.mark.parametrize("m", [1, 8, 13])
@pytest.mark.parametrize("k", [448, 4096])
@pytest.mark.parametrize("bits", [3, 4, 5, 6])
def test_split_plain_matches_jax_kernel(bits, k, m, a8):
    """Every split count from 1 to the k steps (those the sizing may pick
    at any width or SM count) against JAX's Pallas kernels in interpret mode
    (_jax_case); k = 448 pads its last plane, m = 13 fills part of the second
    8-row tile. 1e-4 of the largest output: the same bf16 or int8 operands,
    f32 sums in another order."""
    x, jp, js, ref = _jax_case(bits, k, a8)
    x, ref = x[:m], ref[:m]
    steps = jp.shape[0] // 32
    for splits in range(1, steps + 1):
        got = P.intb_matmul_split_plain(torch.from_numpy(x), to_torch(jp), to_torch(js), bits,
                                        splits, a8).numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), splits


@pytest.mark.parametrize("k,n", SHAPES_8B + SHAPES_70B)
def test_split_count_balanced_and_fits(k, n):
    """At the 8B and 70B shapes, every width, both routes, 1 to 16 rows and
    two SM counts: no split without a step, runs that differ by at most one
    step, and the split's x within a block's shared memory."""
    for bits in (3, 4, 5, 6):
        steps = P.intb_geometry(k, bits)[1] // 32
        for a8 in (False, True):
            for m in (1, 8, 13, 16):
                for sms in (114, 132):
                    splits = P.intb_split_count(m, k, n, bits, a8, sms)
                    runs = [s1 - s0 for s0, s1 in P._intb_split_steps(steps, splits)]
                    assert 1 <= splits <= steps and sum(runs) == steps
                    assert min(runs) >= 1 and max(runs) - min(runs) <= 1
                    assert P._intb_smem(m, bits, a8, max(runs)) <= P.INTB_MAX_SMEM


@pytest.mark.parametrize("m,k,n,bits,a8,want", [
    (8, 4096, 6144, 6, True, 7),    # qkv: 48 tiles x 7 splits of 3-4 steps, 3 blocks an SM
    (8, 4096, 6144, 6, False, 7),
    (8, 4096, 6144, 3, True, 7),    # 13 steps in runs of 1-2
    (1, 4096, 4096, 6, True, 4),    # o_proj: 32 tiles x 4 splits of 6-7 steps, one block an SM
    (8, 14336, 4096, 6, True, 4),   # down: 90 steps in runs of 22-23
    (8, 4096, 28672, 6, True, 1),   # gate_up: 224 tiles, every step in one block
    (16, 4096, 32768, 6, False, 1),
])
def test_split_count_at_llama_8b_shapes(m, k, n, bits, a8, want):
    """The sizing on 132 SMs: the fewest steps on the busiest SM among
    resident grids, then the most blocks an SM runs at once, then the
    fewest splits."""
    assert P.intb_split_count(m, k, n, bits, a8, 132) == want


def test_intb_constants_match_the_kernel():
    """The wrapper's limits and layout sizes are read from the kernel's
    layout header, where each is defined once and nowhere else in csrc/, as
    header_constants reads them; the kernel includes that header, and its
    launch bounds name the blocks an SM the sizing reckons with."""
    layout = (CSRC / "intb_layout.cuh").read_text()
    src = (CSRC / "intb_matmul.cu").read_text()
    values = (P._INTB_WARPS, P._INTB_STAGES, P._INTB_BLOCKS, P.INTB_DECODE_ROWS, P.INTB_MAX_SMEM,
              P._INTB_WORD_STAGE, P._INTB_SCALE_ROW, P._INTB_X_ALIGN, P._INTB_X_PAD_A8,
              P._INTB_X_PAD_BF16, P._INTB_X_SUMS)
    assert len(values) == len(P._INTB_LAYOUT)
    for name, value in zip(P._INTB_LAYOUT, values):
        assert re.findall(rf"^constexpr int {name} = (\d+);", layout, re.M) == [str(value)]
        assert header_constants("intb_layout.cuh", name) == (value,)
        assert not re.search(rf"constexpr int {name}\b", src)
    assert '#include "intb_layout.cuh"' in src
    assert re.findall(r"__launch_bounds__\(([^)]*)\)", src) == ["THREADS, INTB_BLOCKS"]
    # the row quantizer the staged bodies share lives in packed_matmul.cuh
    header = (CSRC / "packed_matmul.cuh").read_text()
    assert "__launch_bounds__(QUANT_THREADS)\nquantize_rows_dependents(" in header
    assert P._INTB_BN == 128 and P.INTB_DECODE_ROWS == P.SMALL_M


def _layout_smem(tmp_path, cases):
    """intb_decode_smem(bits, a8, m, kp, splits) of csrc/intb_layout.cuh for
    each case, compiled by the host's C++ compiler."""
    cpp = tmp_path / "smem.cpp"
    cpp.write_text('#include <cstdio>\n#include "intb_layout.cuh"\nint main() {\n'
                   '    int bits, a8, m, kp, splits;\n'
                   '    while (std::scanf("%d %d %d %d %d", &bits, &a8, &m, &kp, &splits) == 5)\n'
                   '        std::printf("%d\\n", intb_decode_smem(bits, a8 != 0, m, kp, splits));\n'
                   '}\n')
    exe = tmp_path / "smem"
    subprocess.run(["c++", "-std=c++17", "-Wall", "-Werror", f"-I{CSRC}", str(cpp), "-o", str(exe)],
                   check=True)
    text = "".join(f"{b} {int(a8)} {m} {kp} {s}\n" for b, a8, m, kp, s in cases)
    out = subprocess.run([str(exe)], input=text, capture_output=True, text=True, check=True)
    return [int(v) for v in out.stdout.split()]


def test_intb_smem_matches_the_layout_header(tmp_path):
    """_intb_smem and the sizing's fit test (at most INTB_MAX_SMEM) against
    the layout header's own reckoning, compiled: every width, both routes,
    8- and 16-row blocks, and every split length from one step to past the
    longest that fits (past the longest k run of the 70B shapes too); then
    every split count, none and one too many included, at the 8B and 70B
    k."""
    cases, want = [], []
    for bits in (3, 4, 5, 6):
        for a8 in (False, True):
            for m in (1, 8, 9, 16):
                for per in range(1, 401):
                    cases.append((bits, a8, m, 32 * per, 1))
                    smem = P._intb_smem(m, bits, a8, per)
                    want.append(smem if smem <= P.INTB_MAX_SMEM else 0)
                for k in (4096, 8192, 14336, 28672):
                    steps = P.intb_geometry(k, bits)[1] // 32
                    for splits in range(steps + 2):
                        cases.append((bits, a8, m, 32 * steps, splits))
                        smem = (P._intb_smem(m, bits, a8, -(-steps // splits))
                                if 1 <= splits <= steps else 0)
                        want.append(smem if smem <= P.INTB_MAX_SMEM else 0)
    assert 0 in want and max(want) > 0  # both sides of the limit are reached
    assert _layout_smem(tmp_path, cases) == want


def test_intb_counts_every_kernel_where_it_launches():
    """csrc/intb_matmul.cu launches each of its kernels itself, with the
    library's count beside the launch: the row quantizer (two element types,
    one count), the staged product, the tiled product above
    INTB_DECODE_ROWS rows, and its split-k reduce. No launch goes through
    packed_matmul.cuh's launcher or its 256-thread quantizer; the row
    quantizer is packed_matmul.cuh's quantize_rows_dependents, which the
    int4 a8 route's staged body shares."""
    src = (CSRC / "intb_matmul.cu").read_text()
    assert "packed::launch" not in src and "quantize_rows_kernel" not in src
    launches = re.findall(r"([\w:]+(?:<[^<>]*>)?)<<<|cudaLaunchKernelEx\(\s*&cfg, (\w+)", src)
    names = sorted(a.split("<")[0] or b for a, b in launches)
    assert names == ["intb_decode_kernel", "packed::packed_matmul_kernel",
                     "packed::quantize_rows_dependents", "packed::quantize_rows_dependents",
                     "packed::splitk_reduce_kernel"]
    assert sorted(re.findall(r"\+\+intb_launch_count\[(\d)\]", src)) == ["0", "0", "1", "2"]
