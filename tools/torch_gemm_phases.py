"""Where a block's time goes in the trellis-decode GEMM
(exllamav3_tpu_torch/csrc/exl3_gemm.cu, kernel row 9), on one card.

    python3 tools/torch_gemm_phases.py                       # this tree's kernel
    python3 tools/torch_gemm_phases.py --tree build/parent   # another checkout's kernel

Copies the tree's exl3_gemm.cu into build/gemm_phases/<tree name>/, puts
clock64() timers around the phases of a block's life, builds it with nvcc as
ops/build.py builds the kernels (and the unpatched copy beside it), and runs
both at the Llama-3.1-8B shapes of the capacity path (K = 4, 3INST): q/o
(4096 x 4096), k/v (4096 x 1024), gate/up (4096 x 14336), down (14336 x 4096)
and lm_head (4096 x 32768) at m = 8, q/o also at m = 1. Thread 0 of each
block (its warp's view) sums its cycles by phase over the block's k steps:

- `stage`: the single-stage kernel's staging (global to registers to shared
  memory between two barriers), or the pipelined kernel's wait for a staged
  step (`cp.async.wait_group`, then a block barrier, or past the steps the
  block copied at decode sizes a `__syncwarp`, each warp having copied its
  own words) and its issue of a later step's `cp.async` copies;
- `decode`: the lane's words read from shared memory and its 8 codes a tile
  decoded into B fragments;
- `mma`: the A fragments and the tensor-core products;
- the block's life from its start to its k loop (the prologue), the loop,
  and the epilogue: the partial sums' write, and in the pipelined kernel
  the last-arriving block's reduction of the splits (the single-stage
  kernel's reduction is a second kernel, timed alone by CUDA events).

A timer reads the clock where the program reaches it, so latency that a
phase leaves outstanding lands in the next; compare phases, and take kernel
times from the unpatched build. The script prints the mean cycles a step by
phase, the block's life, the splits and blocks of the launch, the
instrumented and unpatched kernel's times over inputs rotated past L2
(util/timing.py) and the card's SM clock, and first the decode loop's
instructions a weight as chip_smoke.py's `sass_loop` counts them (the
single-stage kernel's tile loop and the pipelined kernel's 128-row body by
the same rule, each holding 8 row blocks' A-fragment arithmetic; the
decode-size body beside them); every output is held against
exl3_gemm_plain at chip_smoke.py's TOL_EXL3 (1e-4 of the largest output),
and the script fails if one misses. Needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-4  # chip_smoke.py's TOL_EXL3
SLOTS = 8   # stage, decode, mma, steps, prologue, loop, epilogue, last-arriving
SHAPES = [(8, 4096, 4096, "q/o"), (1, 4096, 4096, "q/o"), (8, 4096, 1024, "k/v"),
          (8, 4096, 14336, "gate/up"), (8, 14336, 4096, "down"), (8, 4096, 32768, "lm_head")]
TIMERS = f"__device__ unsigned long long g_phase[65536 * {SLOTS}];\n"
READ = r'''
extern "C" int phases_read(void* dst, int blocks) {
    return (int)cudaMemcpyFromSymbol(dst, g_phase, (size_t)blocks * %d * 8);
}
extern "C" int phases_clear() {
    void* p;
    cudaGetSymbolAddress(&p, g_phase);
    return (int)cudaMemset(p, 0, sizeof(g_phase));
}
''' % SLOTS


def record(last: str) -> str:
    """Thread 0 writes its block's slots; `last`: 1 for the block that reduced."""
    return ("    if (threadIdx.x == 0) {\n"
            "        const size_t bi = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
            " + blockIdx.x;\n"
            "        const unsigned long long rec[%d] = {ph[0], ph[1], ph[2], (unsigned long long)"
            "n_timed, (unsigned long long)(t_loop - t_entry), (unsigned long long)(t_out - t_loop),"
            " (unsigned long long)(clock64() - t_out), %sull};\n"
            "        for (int s = 0; s < %d; ++s) g_phase[bi * %d + s] = rec[s];\n    }\n") % (
                SLOTS, last, SLOTS, SLOTS)


ENTRY = ("    const long long t_entry = clock64();\n"
         "    unsigned long long ph[3] = {0, 0, 0};\n    int n_timed = 0;\n"
         "    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
         "    const int n0 = blockIdx.x * BN")

# the single-stage kernel: synchronous staging, a second reduce kernel (its
# launch is timed alone through phases_reduce)
PATCHES_SINGLE = [
    ("namespace {\n\nconstexpr int THREADS = 256;",
     "namespace {\n" + TIMERS + "\nconstexpr int THREADS = 256;"),
    ("    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "    const int n0 = blockIdx.x * BN", ENTRY),
    ("    const int step1 = min(step0 + steps_per_split, steps);\n",
     "    const int step1 = min(step0 + steps_per_split, steps);\n"
     "    const long long t_loop = clock64();\n"),
    ("    for (int step = step0; step < step1; ++step) {\n"
     "        __syncthreads();  // the previous step's tiles are consumed",
     "    for (int step = step0; step < step1; ++step) {\n"
     "        const long long t_top = clock64();\n        ++n_timed;\n"
     "        __syncthreads();  // the previous step's tiles are consumed"),
    ("        __syncthreads();\n\n#pragma unroll 1\n        for (int kt = 0; kt < KT; ++kt) {",
     "        __syncthreads();\n        ph[0] += clock64() - t_top;\n\n#pragma unroll 1\n"
     "        for (int kt = 0; kt < KT; ++kt) {\n            const long long t_kt = clock64();"),
    ("            uint32_t bf[2][2];",
     "            const long long t_dec = clock64();\n            ph[1] += t_dec - t_kt;\n"
     "            uint32_t bf[2][2];"),
    ("                    mma_bf16(acc[mb][1], a, bf[1]);\n                }\n            }\n"
     "        }\n    }\n",
     "                    mma_bf16(acc[mb][1], a, bf[1]);\n                }\n            }\n"
     "            ph[2] += clock64() - t_dec;\n        }\n    }\n"
     "    const long long t_out = clock64();\n"),
    ("    }\n}\n\n// out[i] = sum over splits",
     "    }\n" + record("0") + "}\n\n// out[i] = sum over splits"),
]
# the pipelined kernel: stage = the wait for a step's copies, the block
# barrier and the issue of a later step's; the last-arriving block's
# reduction in the epilogue
PATCHES = [
    PATCHES_SINGLE[0],
    ("    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "    const int n0 = blockIdx.x * BN", ENTRY),
    ("    for (int i = 0; i < nsteps; ++i) {\n",
     "    const long long t_loop = clock64();\n"
     "    for (int i = 0; i < nsteps; ++i) {\n"
     "        const long long t_top = clock64();\n        ++n_timed;\n"),
    ("        issue(i + STAGES - 1);\n        const uint32_t* wt",
     "        issue(i + STAGES - 1);\n        ph[0] += clock64() - t_top;\n"
     "        const uint32_t* wt"),
    ("            decode_tile<K, CB>(wk[wo[0]], wk[wo[1]], wk[wo[2]], off, bf);\n",
     "            const long long t_kt = clock64();\n"
     "            decode_tile<K, CB>(wk[wo[0]], wk[wo[1]], wk[wo[2]], off, bf);\n"
     "            const long long t_dec = clock64();\n            ph[1] += t_dec - t_kt;\n"),
    ("                    mma_bf16(acc[mb][1], a, bf[1]);\n                }\n            }\n"
     "        }\n    }\n",
     "                    mma_bf16(acc[mb][1], a, bf[1]);\n                }\n            }\n"
     "            ph[2] += clock64() - t_dec;\n        }\n    }\n"
     "    const long long t_out = clock64();\n"),
    ("    if (splits == 1) return;\n",
     "    if (splits == 1) {\n" + record("0") + "        return;\n    }\n"),
    ("    if (!last) return;\n", "    if (!last) {\n" + record("0") + "        return;\n    }\n"),
    ("    if (tid == 0) counters[tile] = 0;  // ready for the next launch\n}",
     "    if (tid == 0) counters[tile] = 0;  // ready for the next launch\n" + record("1") + "}"),
]

REDUCE_SINGLE = r'''
extern "C" int phases_reduce(const void* part, void* out, int splits, long long quads,
                             void* stream) {
    exl3_gemm_reduce<<<(unsigned)((quads + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
        (const float4*)part, (float4*)out, splits, (size_t)quads);
    return (int)cudaGetLastError();
}
'''


def _version(src: str) -> str:
    return "single-stage" if "exl3_gemm_reduce" in src else "pipelined"


def build(tree: Path) -> tuple[str, ctypes.CDLL, ctypes.CDLL]:
    """(kernel version, the instrumented copy, the unpatched one)."""
    from exllamav3_tpu_torch.ops.build import NVCC_FLAGS, nvcc_path

    src = (tree / "exllamav3_tpu_torch" / "csrc" / "exl3_gemm.cu").read_text()
    version = _version(src)
    patched = src
    for anchor, text in (PATCHES_SINGLE if version == "single-stage" else PATCHES):
        if patched.count(anchor) != 1:
            raise SystemExit(f"the kernel changed: anchor not found once:\n{anchor}")
        patched = patched.replace(anchor, text)
    out = ROOT / "build" / "gemm_phases" / tree.resolve().name
    out.mkdir(parents=True, exist_ok=True)
    (out / "phases.cu").write_text(patched + READ + (REDUCE_SINGLE if version == "single-stage" else ""))
    (out / "plain.cu").write_text(src)
    # the tree's headers (async_copy.cuh) are included from its csrc/
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")] + [
        f"-I{tree / 'exllamav3_tpu_torch' / 'csrc'}"]
    jobs = [[nvcc_path(), *flags, "-shared", str(out / "phases.cu"), "-o", str(out / "phases.so")],
            [nvcc_path(), *flags, "-Xptxas", "-v", "-shared", str(out / "plain.cu"), "-o",
             str(out / "plain.so")]]
    with ThreadPoolExecutor(2) as ex:
        runs = list(ex.map(lambda c: subprocess.run(c, capture_output=True, text=True), jobs))
    for r in runs:
        if r.returncode:
            raise SystemExit(r.stdout + r.stderr)
    name = None  # the K = 4, 3INST kernels' registers, shared memory and spills
    for line in (runs[1].stdout + runs[1].stderr).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "exl3_gemm_kernelILi4ELi0E" in line else None
        elif name and ("Used" in line or "spill" in line):
            print(f"ptxas: {name}: {line.strip()}", flush=True)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dlls = ctypes.CDLL(str(out / "phases.so")), ctypes.CDLL(str(out / "plain.so"))
    for dll in dlls:
        dll.exl3_gemm.argtypes = ([P] * 4 + [I] * 6 + [P] if version == "single-stage"
                                  else [P] * 5 + [I] * 6 + [P])
    dlls[0].phases_read.argtypes = [P, I]
    if version == "single-stage":
        dlls[0].phases_reduce.argtypes = [P, P, I, L, P]
    return version, dlls[0], dlls[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT), help="checkout whose kernel to time")
    ap.add_argument("--splits", default="",
                    help="split counts to time the unpatched kernel at, at m = 8 and 128 over "
                         "q/o and k/v and at m = 40 over q/o, besides its own sizing (the "
                         "pipelined kernel)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))  # that tree's wrapper: its split sizing and plain version
    import numpy as np

    from exllamav3_tpu_torch.ops import exl3_gemm as eg
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    version, dll, plain = build(tree)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"{smi}; kernel: {version} ({tree})", flush=True)
    # the decode loop's instructions a weight (chip_smoke.py's count): the
    # single-stage kernel's tile loop holds 8 row blocks' A-fragment
    # arithmetic, as the pipelined kernel's 128-row body does
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)  # this tree's, whichever tree is timed
    spec.loader.exec_module(smoke)
    sass_loop = smoke.sass_loop
    so = str(ROOT / "build" / "gemm_phases" / tree.name / "plain.so")
    if version == "single-stage":
        sass_loop(so, "exl3_gemm_kernelILi4ELi0EE", row_blocks=8)
    else:
        sass_loop(so, f"exl3_gemm_kernelILi4ELi0ELi1ELi{eg._STAGES}EE")
        sass_loop(so, f"exl3_gemm_kernelILi4ELi0ELi8ELi{eg._PREFILL_STAGES}EE", row_blocks=8)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    K, cb = 4, 0
    for m, k, n, what in SHAPES:
        def make(i, m=m, k=k, n=n):
            xh = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            w = torch.randint(-2**31, 2**31, (k // 16, K, n // 2), generator=g, device=dev,
                              dtype=torch.int64).to(torch.int32)
            return xh, w
        xh, w = make(0)
        ref = eg.exl3_gemm_plain(xh, w, K, cb)
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        if version == "single-stage":
            splits = eg.split_count(m, k, n)
            grid = (n // 128) * splits * -(-m // 128)
            scratch = torch.empty((splits, m, n), dtype=torch.float32, device=dev)

            def call(lib, xh, w):
                err = lib.exl3_gemm(xh.data_ptr(), w.data_ptr(), out.data_ptr(),
                                    scratch.data_ptr() if splits > 1 else None, m, k, n, K, cb,
                                    splits, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
        else:
            splits, grid, ws, counters = eg.launch_plan(m, k, n, K, dev)

            def call(lib, xh, w):
                err = lib.exl3_gemm(xh.data_ptr(), w.data_ptr(), out.data_ptr(),
                                    None if ws is None else ws.data_ptr(), counters.data_ptr(),
                                    m, k, n, K, cb, splits,
                                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
        said = f"m={m} {what} ({k}x{n}) K={K}: {splits} splits, {grid} blocks"
        dll.phases_clear()
        call(dll, xh, w)
        torch.cuda.synchronize()
        rel = float((out - ref).abs().max() / ref.abs().max())
        buf = np.zeros(grid * SLOTS, np.uint64)
        if dll.phases_read(buf.ctypes.data, grid):
            raise RuntimeError("reading the timers failed")
        buf = buf.reshape(grid, SLOTS).astype(np.float64)
        steps = buf[:, 3].sum()
        per_step = ", ".join(f"{nm} {buf[:, i].sum() / steps:.0f}"
                             for i, nm in enumerate(("stage", "decode", "mma")))
        last = buf[:, 7] > 0
        epi = (f"epilogue {buf[~last, 6].mean():.0f} (partial write)" + (
               f", last-arriving block's reduction {buf[last, 6].mean():.0f}" if last.any()
               else "")) if splits > 1 or version == "single-stage" else f"epilogue {buf[:, 6].mean():.0f}"
        nxt = rotating(make, m * k * 2 + k * n * K // 8)
        inst = time_ms(lambda: call(dll, *nxt()), 20)
        call(plain, xh, w)
        torch.cuda.synchronize()
        rel = max(rel, float((out - ref).abs().max() / ref.abs().max()))
        ms = time_ms(lambda: call(plain, *nxt()), 20)
        red = ""
        if version == "single-stage" and splits > 1:
            quads = m * n // 4
            red_ms = time_ms(lambda: dll.phases_reduce(scratch.data_ptr(), out.data_ptr(), splits,
                                                       quads, torch.cuda.current_stream()
                                                       .cuda_stream), 20)
            red = f"; the reduce kernel alone {red_ms:.4f} ms"
        print(f"{said}, {steps / grid:.1f} steps a block; cycles a step: {per_step}; a block: "
              f"prologue {buf[:, 4].mean():.0f}, k loop mean {buf[:, 5].mean():.0f} longest "
              f"{buf[:, 5].max():.0f}, {epi}; instrumented {inst:.4f} ms, unpatched {ms:.4f} ms "
              f"over rotated inputs{red}; rel err {rel:.2e}", flush=True)
        if not rel <= TOL:
            raise SystemExit(f"{said}: rel err {rel:.2e} > {TOL}")
        del xh, w, ref, nxt
        torch.cuda.empty_cache()
    sweep = [(8, 4096, 4096, "q/o"), (8, 4096, 1024, "k/v"), (40, 4096, 4096, "q/o"),
             (128, 4096, 4096, "q/o"), (128, 4096, 1024, "k/v")]
    for m, k, n, what in sweep if args.splits and version != "single-stage" else []:
        nxt = rotating(lambda i: make(i, m, k, n), m * k * 2 + k * n * K // 8)
        xh, w = nxt()
        ref = eg.exl3_gemm_plain(xh, w, K, cb)
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        _, _, _, counters = eg.launch_plan(m, k, n, K, dev)
        for splits in (int(x) for x in args.splits.split(",")):
            per = -(-(k // 128) // splits)
            if (splits > k // 128 or (splits - 1) * per >= k // 128
                    or (m <= eg.DECODE_ROWS and per > eg.XH_ONCE_STEPS)):
                continue  # a split without a step, or more xh than a block stages
            ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)

            def call(xh, w):
                err = plain.exl3_gemm(xh.data_ptr(), w.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                      counters.data_ptr(), m, k, n, K, cb, splits,
                                      torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            call(xh, w)
            torch.cuda.synchronize()
            rel = float((out - ref).abs().max() / ref.abs().max())
            ms = time_ms(lambda: call(*nxt()), 20)
            print(f"m={m} {what} ({k}x{n}) at {splits} splits: {ms:.4f} ms over rotated inputs; "
                  f"rel err {rel:.2e}", flush=True)
            if not rel <= TOL:
                raise SystemExit(f"{splits} splits: rel err {rel:.2e} > {TOL}")


if __name__ == "__main__":
    main()
