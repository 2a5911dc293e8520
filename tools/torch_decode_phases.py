"""Where a tile's time goes in the decode kernel
(exllamav3_tpu_torch/csrc/attention_decode.cuh), on one card, over the
quantized or the bf16 cache (`--storage`).

    python3 tools/torch_decode_phases.py                 # (4, 4) and (5, 3), default splits
    python3 tools/torch_decode_phases.py --splits 64,128,256,512,1024,2048
    python3 tools/torch_decode_phases.py --storage bf16 --splits 64,128,256,512  # bf16 geometries

Writes a copy of the header into build/decode_phases/ with clock64() timers
around the phases of the tile loop (the wait for the staged tile, the issue
of the next tile's copies, the score pass with the quantized V unpack, the
softmax and P.V), builds it with nvcc as ops/build.py builds the kernels,
and runs it at the Llama-3.1-8B linear decode shape (batch 8, 32 q / 8 kv
heads of 128, contexts 300-2056, T = 2056). Thread 0 of each block sums its
tiles' cycles by phase and times the block's life (start to the tile loop,
to its arrival at the merge counter, and the merge); the script prints the
mean cycles a tile by phase, the tile loop's mean and longest cycles, the
life of blocks that see keys and of those that see none, the merge's cycles
and the instrumented kernel's time (CUDA events over 20 launches, inputs not
rotated). The timers cost
time of their own: compare phases, not the kernel time, with
chip_smoke.py's. At each split size the script also times the
uninstrumented kernel over inputs rotated past L2 (util/timing.py): over
the quantized cache the library's (exl3_linear_attention_quant called with
that split), the sweep that chose decode_split_keys's sizing. Over the bf16
cache it times four tile geometries, 32- and 64-key tiles in two and three
stages, from a build of the unpatched header, at each split given to
--splits (or the one decode_split_keys gives) and at four shapes: the 8B
linear decode above (also instrumented), the 8B paged decode (batch 8,
contexts 300-2048), the Llama-3.2-1B draft's linear decode (batch 8, heads
of 64, T = 2056) and the 8B linear decode at batch 1 (context 2048); the
sweep that chose the header's launch_decode_bf16. It also prints each bf16
kernel's registers and spills. Every output is held against the plain
version at chip_smoke.py's tolerance (3e-4 quantized, 2e-4 bf16, of the
largest output), and the script fails if one misses. Needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "exllamav3_tpu_torch" / "csrc"
OUT = ROOT / "build" / "decode_phases"
PHASES = ("wait", "issue", "scores (+ V unpack)", "softmax", "P.V")
# per block: the five phases, tiles, the tile loop's cycles, then cycles from
# the block's start to the loop, to its arrival at the counter, and to the
# end of the merge (the merging block only)
SLOTS = 10
TOL = {"quant": 3e-4, "bf16": 2e-4}  # chip_smoke.py's TOL_ATTN_Q and TOL_ATTN
# the bf16 storage's tile geometries (keys a tile, stages), variants 0..3
GEOMETRIES = ((64, 2), (32, 3), (32, 2), (64, 3))

# (anchor in the header, text put in its place); each anchor must occur once
PATCHES = [
    ("namespace {\n\nconstexpr int DECODE_ROWS",
     f"namespace {{\n__device__ unsigned long long g_phase[65536 * {SLOTS}];\n"
     "constexpr int DECODE_ROWS"),
    ("    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "    const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;",
     "    const long long t_entry = clock64();\n"
     "    const size_t bi = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x;\n"
     "    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n"
     "    const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;"),
    ("        for (int i = 0; i < ntiles; ++i) {\n            issue(i + STAGES - 1);",
     "        unsigned long long ph[5] = {0, 0, 0, 0, 0};\n"
     "        const long long t_block = clock64();\n"
     "        for (int i = 0; i < ntiles; ++i) {\n"
     "            const long long t_top = clock64();\n"
     "            issue(i + STAGES - 1);"),
    ("            cp_async_wait<STAGES - 1>();\n            __syncthreads();\n"
     "            const int key0",
     "            const long long t_issued = clock64();\n"
     "            cp_async_wait<STAGES - 1>();\n            __syncthreads();\n"
     "            const long long t_ready = clock64();\n"
     "            ph[0] += t_ready - t_issued;\n            ph[1] += t_issued - t_top;\n"
     "            const int key0"),
    ("                for (int r = 0; r < RT; ++r) Sp[(part * RT + r) * LDP + key] = sacc[r];\n"
     "                __syncthreads();",
     "                for (int r = 0; r < RT; ++r) Sp[(part * RT + r) * LDP + key] = sacc[r];\n"
     "                __syncthreads();\n"
     "                const long long t_scored = clock64();\n"
     "                ph[2] += t_scored - t_ready;"),
    ("                        row_alpha[r] = alpha;\n                    }\n                }\n"
     "                __syncthreads();",
     "                        row_alpha[r] = alpha;\n                    }\n                }\n"
     "                __syncthreads();\n"
     "                const long long t_soft = clock64();\n"
     "                ph[3] += t_soft - t_scored;"),
    ("                }\n            }\n"
     "            __syncthreads();  // the stage, the V tile and the scores are rewritten next\n"
     "        }",
     "                }\n                ph[4] += clock64() - t_soft;\n            }\n"
     "            __syncthreads();  // the stage, the V tile and the scores are rewritten next\n"
     "        }\n"
     "        if (tid == 0) {\n"
     f"            for (int k = 0; k < 5; ++k) g_phase[bi * {SLOTS} + k] = ph[k];\n"
     f"            g_phase[bi * {SLOTS} + 5] = ntiles;\n"
     f"            g_phase[bi * {SLOTS} + 6] = clock64() - t_block;\n"
     f"            g_phase[bi * {SLOTS} + 7] = t_block - t_entry;\n"
     "        }"),
    ("    if (!*flag) return;",
     f"    if (tid == 0) g_phase[bi * {SLOTS} + 8] = clock64() - t_entry;\n"
     "    if (!*flag) return;"),
    ("    if (tid == 0) counters[b * Hk + hk] = 0;  // ready for the next launch",
     f"    if (tid == 0) g_phase[bi * {SLOTS} + 9] = clock64() - t_entry;\n"
     "    if (tid == 0) counters[b * Hk + hk] = 0;  // ready for the next launch"),
]

# the entries both builds hold: the kernel over the linear quantized cache
# (D = 128) and over the bf16 cache, linear or paged, in either geometry
ENTRY = r'''
#include "attention_decode.cuh"
extern "C" int phases_linear(const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* qpos, const void* tl, void* out, void* ws, void* counters,
    int B, int Hq, int Hk, int N, int T, int kb, int vb, float scale, int split_keys,
    void* stream) {
    const LinearRows rows{nullptr, N, T};
    const QuantKV<128> kv{(const uint32_t*)kq, (const __nv_bfloat16*)ks, (const uint32_t*)vq,
                          (const __nv_bfloat16*)vs, Hk, kb, vb, 0.f, 1.f};
    return launch_decode<128>(q, rows, kv, qpos, tl, nullptr, out, ws, counters, B, 1, Hq, Hk,
                              scale, 0, 0.f, split_keys, T, (cudaStream_t)stream);
}
template <int D, class Rows>
int bf16_variant(int variant, const void* q, Rows rows, const void* k, const void* v,
                 const void* qpos, const void* tl, void* out, void* ws, void* counters, int B,
                 int Hq, int Hk, float scale, int split_keys, int key_limit, void* stream) {
    const Bf16KV<D> kv{(const __nv_bfloat16*)k, (const __nv_bfloat16*)v, Hk};
    cudaStream_t st = (cudaStream_t)stream;
    switch (variant) {
        case 1: return launch_decode<D, 32, 3>(q, rows, kv, qpos, tl, nullptr, out, ws, counters,
                                               B, 1, Hq, Hk, scale, 0, 0.f, split_keys, key_limit,
                                               st);
        case 2: return launch_decode<D, 32, 2>(q, rows, kv, qpos, tl, nullptr, out, ws, counters,
                                               B, 1, Hq, Hk, scale, 0, 0.f, split_keys, key_limit,
                                               st);
        case 3: return launch_decode<D, 64, 3>(q, rows, kv, qpos, tl, nullptr, out, ws, counters,
                                               B, 1, Hq, Hk, scale, 0, 0.f, split_keys, key_limit,
                                               st);
        default: return launch_decode<D, 64, 2>(q, rows, kv, qpos, tl, nullptr, out, ws,
                                                counters, B, 1, Hq, Hk, scale, 0, 0.f, split_keys,
                                                key_limit, st);
    }
}
// bt null: the linear layout (N rows of T slots); else paged (MP pages a table, P pages)
extern "C" int bf16_decode(int variant, const void* q, const void* k, const void* v,
    const void* bt, const void* qpos, const void* tl, void* out, void* ws, void* counters,
    int B, int Hq, int Hk, int D, int N, int T, int MP, int P, float scale, int split_keys,
    void* stream) {
    if (bt != nullptr) {
        const PagedRows rows{(const int*)bt, MP, P};
        return D == 64 ? bf16_variant<64>(variant, q, rows, k, v, qpos, tl, out, ws, counters, B,
                                          Hq, Hk, scale, split_keys, MP * PAGE, stream)
                       : bf16_variant<128>(variant, q, rows, k, v, qpos, tl, out, ws, counters, B,
                                           Hq, Hk, scale, split_keys, MP * PAGE, stream);
    }
    const LinearRows rows{nullptr, N, T};
    return D == 64 ? bf16_variant<64>(variant, q, rows, k, v, qpos, tl, out, ws, counters, B, Hq,
                                      Hk, scale, split_keys, T, stream)
                   : bf16_variant<128>(variant, q, rows, k, v, qpos, tl, out, ws, counters, B, Hq,
                                       Hk, scale, split_keys, T, stream);
}
'''

TIMERS = r'''
extern "C" int phases_read(void* dst, int blocks, int slots) {
    return (int)cudaMemcpyFromSymbol(dst, g_phase, (size_t)blocks * slots * 8);
}
extern "C" int phases_clear() {
    void* p;
    cudaGetSymbolAddress(&p, g_phase);
    return (int)cudaMemset(p, 0, sizeof(g_phase));
}
'''


def print_registers(ptxas: str) -> None:
    """Each bf16 decode kernel's registers and spills, from ptxas -v."""
    name = None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and "Used" in line and "registers" in line:
            if "Bf16KV" in name:
                what = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout
                sig = re.search(r"decode_kernel<(\d+), (\d+), (\d+), (\d+), [^,]*::(\w+)",
                                what or "")
                said = (f"D={sig[1]} RT={sig[2]} TK={sig[3]} STAGES={sig[4]} {sig[5]}" if sig
                        else name)
                print(f"ptxas: decode_kernel {said}: {line.split(':', 1)[1].strip()}",
                      flush=True)
            name = None
        elif name and "spill" in line and "Bf16KV" in name:
            print(f"ptxas:   {line.strip()}", flush=True)


def build() -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """(the instrumented copy of the kernel, the unpatched one), built in
    parallel into build/decode_phases/."""
    from exllamav3_tpu_torch.ops.build import NVCC_FLAGS, nvcc_path

    src = (CSRC / "attention_decode.cuh").read_text()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"the header changed: anchor not found once:\n{anchor}")
        src = src.replace(anchor, text)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "attention_decode.cuh").write_text(src)
    (OUT / "attention_tiles.cuh").write_text((CSRC / "attention_tiles.cuh").read_text())
    (OUT / "phases.cu").write_text(ENTRY + TIMERS)
    (OUT / "plain").mkdir(exist_ok=True)  # apart from the patched copy, which "" would find
    (OUT / "plain" / "plain.cu").write_text(ENTRY)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    jobs = [[nvcc_path(), *flags, "-shared", str(OUT / "phases.cu"), "-o", str(OUT / "phases.so")],
            [nvcc_path(), *flags, "-Xptxas", "-v", f"-I{CSRC}", "-shared",
             str(OUT / "plain" / "plain.cu"), "-o", str(OUT / "plain.so")]]
    with ThreadPoolExecutor(2) as ex:
        runs = list(ex.map(lambda c: subprocess.run(c, capture_output=True, text=True), jobs))
    for r in runs:
        if r.returncode:
            raise SystemExit(r.stdout + r.stderr)
    print_registers(runs[1].stdout + runs[1].stderr)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dlls = ctypes.CDLL(str(OUT / "phases.so")), ctypes.CDLL(str(OUT / "plain.so"))
    for dll in dlls:
        dll.phases_linear.argtypes = [P] * 10 + [I] * 7 + [F, I, P]
        dll.bf16_decode.argtypes = [I] + [P] * 9 + [I] * 8 + [F, I, P]
    dlls[0].phases_read.argtypes = [P, I, I]
    return dlls


def read_phases(dll, blocks: int) -> np.ndarray:
    """(blocks, SLOTS) f64: each block's cycles by phase, tiles and cycles."""
    buf = np.zeros(blocks * SLOTS, np.uint64)
    if dll.phases_read(buf.ctypes.data, blocks, SLOTS):
        raise RuntimeError("reading the timers failed")
    return buf.reshape(blocks, SLOTS).astype(np.float64)


def phase_line(buf: np.ndarray) -> str:
    tiles = buf[:, 5].sum()
    live = buf[:, 5] > 0
    busy = buf[live, 6]
    per_tile = ", ".join(f"{nm} {buf[:, k].sum() / tiles:.0f}"
                         for k, nm in zip((0, 1, 2, 3, 4), PHASES))
    merged = buf[buf[:, 9] > 0]
    return (f"{int(tiles)} tiles in {len(busy)} blocks that see keys; cycles a tile: {per_tile}; "
            f"a block's tile loop: mean {busy.mean():.0f}, longest {busy.max():.0f}; a block "
            f"that sees keys, start to loop {buf[live, 7].mean():.0f}, to its arrival "
            f"{buf[live, 8].mean():.0f}; one that sees none, to its arrival "
            f"{buf[~live, 8].mean() if (~live).any() else 0:.0f}; the merge after the arrival "
            f"{(merged[:, 9] - merged[:, 8]).mean():.0f} ({len(merged)} merges)")


def bf16_main(dll, plain_dll, splits: list) -> None:
    """The bf16 storage: at each shape, each split given (or the one
    decode_split_keys gives) and each geometry, the kernel's time; at the
    first shape also its cycles a tile by phase."""
    from exllamav3_tpu_torch.constants import PAGE_SIZE
    from exllamav3_tpu_torch.ops.flash_attention import (decode_split_keys, device_sms,
                                                          linear_attention_plain,
                                                          paged_attention_plain)
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    rng = np.random.default_rng(3)
    ctx8 = np.linspace(300, 2048, 8).astype(np.int32)
    ctx8t = np.linspace(300, 2056, 8).astype(np.int32)
    # (name, B, Hq, Hk, D, contexts, paged, linear slots T); the first is the phases' shape
    shapes = [("8B linear decode B=8 ctx 300-2056 T=2056", 8, 32, 8, 128, ctx8t, False, 2056),
              ("8B paged decode B=8 ctx 300-2048", 8, 32, 8, 128, ctx8, True, 0),
              ("1B draft linear decode B=8 D=64 ctx 300-2056 T=2056", 8, 32, 8, 64, ctx8t, False,
               2056),
              ("8B linear decode B=1 ctx 2048 T=2056", 1, 32, 8, 128, np.array([2048], np.int32),
               False, 2056)]
    for si, (name, B, Hq, Hk, D, ctx, paged, T) in enumerate(shapes):
        qp = torch.as_tensor(ctx[:, None] - 1, device=dev)
        tl = torch.as_tensor(ctx, device=dev)
        q = torch.randn((B, 1, Hq, D), generator=g, device=dev)
        if paged:
            MP = int(math.ceil(ctx.max() / PAGE_SIZE)) + 1
            P = B * MP + 1
            perm = rng.permutation(np.arange(1, P))[: B * MP].reshape(B, MP).astype(np.int32)
            perm[:, -1] = 0
            bt = torch.as_tensor(perm, device=dev)
            lead, width = (P, PAGE_SIZE), MP * PAGE_SIZE
        else:
            MP = P = 0
            bt = None
            lead, width = (B, T), T

        def make(i):
            return {n: torch.randn((*lead, Hk, D), generator=g, device=dev).to(torch.bfloat16)
                    for n in ("k", "v")}
        kv = make(0)
        ref = (paged_attention_plain(q, kv["k"], kv["v"], bt, qp, tl, scale=D ** -0.5) if paged
               else linear_attention_plain(q, kv["k"], kv["v"], qp, tl, scale=D ** -0.5))
        nxt = rotating(lambda i: kv if i == 0 else make(i), 2 * kv["k"].numel() * 2)
        counters = torch.zeros(B * Hk, dtype=torch.int32, device=dev)
        out = torch.empty((B, 1, Hq, D), device=dev)
        for split in (splits or [decode_split_keys(width, B, Hk, device_sms(dev))]):
            ws = torch.empty(B * Hk * -(-width // split) * (Hq // Hk) * (D + 2), device=dev)
            for variant, (tk, stages) in enumerate(GEOMETRIES):
                def call(lib, st):
                    err = lib.bf16_decode(
                        variant, q.data_ptr(), st["k"].data_ptr(), st["v"].data_ptr(),
                        None if bt is None else bt.data_ptr(), qp.data_ptr(), tl.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, Hq, Hk, D, B,
                        T, MP, P, D ** -0.5, split, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: {err}")
                said = f"{name}, {tk} keys a tile in {stages} stages, split {split}"
                if si == 0:
                    dll.phases_clear()
                    call(dll, kv)
                    torch.cuda.synchronize()
                    rel = float((out - ref).abs().max() / ref.abs().max())
                    buf = read_phases(dll, -(-width // split) * Hk * B)
                    print(f"{said}: instrumented, rel err {rel:.2e}; {phase_line(buf)}",
                          flush=True)
                    if not rel <= TOL["bf16"]:
                        raise SystemExit(f"{said}: rel err {rel:.2e} > {TOL['bf16']}")
                call(plain_dll, kv)
                torch.cuda.synchronize()
                rel = float((out - ref).abs().max() / ref.abs().max())
                ms = time_ms(lambda: call(plain_dll, nxt()), 50)
                warm = time_ms(lambda: call(plain_dll, kv), 50)
                print(f"{said}: {ms:.4f} ms over rotated inputs (L2-warm {warm:.4f}), rel err "
                      f"{rel:.2e}", flush=True)
                if not rel <= TOL["bf16"]:
                    raise SystemExit(f"{said}: rel err {rel:.2e} > {TOL['bf16']}")
        del kv, nxt
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", default="", help="split sizes (keys); default: decode_split_keys")
    ap.add_argument("--storage", choices=("quant", "bf16"), default="quant")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    from exllamav3_tpu_torch.ops.build import library
    from exllamav3_tpu_torch.ops.flash_attention import (decode_split_keys, device_sms,
                                                          linear_attention_quant_plain)
    from exllamav3_tpu_torch.ops.kv_quant import merged_layout, quantize_kv_stored
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    dll, plain_dll = build()
    dev = torch.device("cuda")
    B, Hq, Hk, D, T = 8, 32, 8, 128, 2056
    ctx = np.linspace(300, 2056, 8).astype(np.int32)
    qp = torch.as_tensor(ctx[:, None] - 1, device=dev)
    tl = torch.as_tensor(ctx, device=dev)
    counters = torch.zeros(B * Hk, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev)
    given = [int(s) for s in args.splits.split(",")] if args.splits else []
    splits = given or [decode_split_keys(T, B, Hk, device_sms(dev))]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if args.storage == "bf16":
        return bf16_main(dll, plain_dll, given)
    lib = library()
    for kb, vb in ((4, 4), (5, 3)):
        state = {}
        for nm, bits in (("k", kb), ("v", vb)):
            x = torch.randn((B, T, Hk, D), generator=g, device=dev)
            state[nm + "_q"], state[nm + "_s"] = quantize_kv_stored(x, bits, merged_layout(kb, vb))
        ref = linear_attention_quant_plain(q, state, qp, tl, kb, vb, scale=D ** -0.5)
        nbytes = sum(t.numel() * t.element_size() for t in state.values())
        nxt = rotating(lambda i: state if i == 0 else {n: t.clone() for n, t in state.items()},
                       nbytes)
        for split in splits:
            ns = -(-T // split)
            ws = torch.empty(B * Hk * ns * (Hq // Hk) * (D + 2), device=dev)
            out = torch.empty_like(q)
            lib_out = torch.empty_like(q)

            def lib_call(st):
                err = lib.exl3_linear_attention_quant(
                    q.data_ptr(), st["k_q"].data_ptr(), st["k_s"].data_ptr(),
                    st["v_q"].data_ptr(), st["v_s"].data_ptr(), None, qp.data_ptr(),
                    tl.data_ptr(), None, lib_out.data_ptr(), ws.data_ptr(), counters.data_ptr(),
                    B, 1, Hq, Hk, D, B, T, kb, vb, 0.0, 1.0, D ** -0.5, 0, 0.0, split,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            def call():
                err = dll.phases_linear(
                    q.data_ptr(), state["k_q"].data_ptr(), state["k_s"].data_ptr(),
                    state["v_q"].data_ptr(), state["v_s"].data_ptr(), qp.data_ptr(),
                    tl.data_ptr(), out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, Hq, Hk,
                    B, T, kb, vb, D ** -0.5, split, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            dll.phases_clear()
            call()
            torch.cuda.synchronize()
            rel = float((out - ref).abs().max() / ref.abs().max())
            blocks = ns * Hk * B
            buf = read_phases(dll, blocks)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                call()
            e1.record()
            torch.cuda.synchronize()
            lib_call(state)
            torch.cuda.synchronize()
            lib_rel = float((lib_out - ref).abs().max() / ref.abs().max())
            lib_ms = time_ms(lambda: lib_call(nxt()), 50)
            print(f"bits ({kb}, {vb}) split {split}: {phase_line(buf)}; instrumented kernel "
                  f"{e0.elapsed_time(e1) / 20:.4f} ms, rel err {rel:.2e}; library kernel "
                  f"{lib_ms:.4f} ms over rotated inputs, rel err {lib_rel:.2e}", flush=True)
            if not max(rel, lib_rel) <= TOL["quant"]:
                raise SystemExit(f"split {split}: rel err {max(rel, lib_rel):.2e} > {TOL['quant']}")


if __name__ == "__main__":
    main()
