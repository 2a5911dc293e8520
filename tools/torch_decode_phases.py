"""Where a tile's time goes in the quantized decode kernel
(exllamav3_tpu_torch/csrc/attention_decode.cuh), on one card.

    python3 tools/torch_decode_phases.py                 # (4, 4) and (5, 3), default splits
    python3 tools/torch_decode_phases.py --splits 64,128,256,512,1024,2048

Writes a copy of the header into build/decode_phases/ with clock64() timers
around the phases of the tile loop (the wait for the staged tile, the issue
of the next tile's copies, the score pass with the V unpack, the softmax and
P.V), builds it with nvcc as ops/build.py builds the kernels, and runs it at
the Llama-3.1-8B linear decode shape (batch 8, 32 q / 8 kv heads of 128,
contexts 300-2056, T = 2056). Thread 0 of each block sums its tiles' cycles
by phase; the script prints the mean cycles a tile by phase, the blocks'
mean and longest time in cycles, and the instrumented kernel's time (CUDA
events over 20 launches, inputs not rotated). The timers cost time of their
own: compare phases, not the kernel time, with chip_smoke.py's. At each
split size the script also times the uninstrumented kernel as the library
builds it (exl3_linear_attention_quant called with that split, over inputs
rotated past L2, util/timing.py), the sweep that chose decode_split_keys's
sizing; both kernels' outputs are held against the plain version at
chip_smoke.py's 3e-4 of the largest output, and the script fails if either
misses. Needs CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "exllamav3_tpu_torch" / "csrc"
OUT = ROOT / "build" / "decode_phases"
PHASES = ("wait", "issue", "scores + V unpack", "softmax", "P.V")
SLOTS = 8  # per block: the five phases, tiles, block cycles, spare
TOL = 3e-4  # chip_smoke.py's TOL_ATTN_Q

# (anchor in the header, text put in its place); each anchor must occur once
PATCHES = [
    ("namespace {\n\nconstexpr int DECODE_ROWS",
     "namespace {\n__device__ unsigned long long g_phase[65536 * 8];\n"
     "constexpr int DECODE_ROWS"),
    ("        for (int i = 0; i < ntiles; ++i) {\n            if (i + 1 < ntiles) issue(i + 1);",
     "        unsigned long long ph[5] = {0, 0, 0, 0, 0};\n"
     "        const long long t_block = clock64();\n"
     "        for (int i = 0; i < ntiles; ++i) {\n"
     "            const long long t_top = clock64();\n"
     "            if (i + 1 < ntiles) issue(i + 1);"),
    ("            cp_async_wait_one();\n            __syncthreads();\n            const int key0",
     "            const long long t_issued = clock64();\n"
     "            cp_async_wait_one();\n            __syncthreads();\n"
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
     "            const size_t bi = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x"
     " + blockIdx.x;\n"
     "            for (int k = 0; k < 5; ++k) g_phase[bi * 8 + k] = ph[k];\n"
     "            g_phase[bi * 8 + 5] = ntiles;\n"
     "            g_phase[bi * 8 + 6] = clock64() - t_block;\n"
     "        }"),
]

ENTRY = r'''
#include "attention_decode.cuh"
extern "C" int phases_linear(const void* q, const void* kq, const void* ks, const void* vq,
    const void* vs, const void* qpos, const void* tl, void* out, void* ws, void* counters,
    int B, int Hq, int Hk, int N, int T, int kb, int vb, float scale, int split_keys,
    void* stream) {
    const LinearRows rows{nullptr, N, T};
    const QuantKV<128> kv{(const uint32_t*)kq, (const __nv_bfloat16*)ks, (const uint32_t*)vq,
                          (const __nv_bfloat16*)vs, Hk, kb, vb, 0.f, 1.f};
    return launch_decode_quant<128>(q, rows, kv, qpos, tl, nullptr, out, ws, counters, B, 1, Hq,
                                    Hk, scale, 0, 0.f, split_keys, T, (cudaStream_t)stream);
}
extern "C" int phases_read(void* dst, int blocks) {
    return (int)cudaMemcpyFromSymbol(dst, g_phase, (size_t)blocks * 8 * 8);
}
extern "C" int phases_clear() {
    void* p;
    cudaGetSymbolAddress(&p, g_phase);
    return (int)cudaMemset(p, 0, sizeof(g_phase));
}
'''


def build() -> ctypes.CDLL:
    """The instrumented copy of the kernel, built into build/decode_phases/."""
    from exllamav3_tpu_torch.ops.build import NVCC_FLAGS, nvcc_path

    src = (CSRC / "attention_decode.cuh").read_text()
    for anchor, text in PATCHES:
        if src.count(anchor) != 1:
            raise SystemExit(f"the header changed: anchor not found once:\n{anchor}")
        src = src.replace(anchor, text)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "attention_decode.cuh").write_text(src)
    (OUT / "attention_tiles.cuh").write_text((CSRC / "attention_tiles.cuh").read_text())
    (OUT / "phases.cu").write_text(ENTRY)
    lib = OUT / "phases.so"
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([nvcc_path(), *flags, "-shared", str(OUT / "phases.cu"), "-o", str(lib)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.phases_linear.argtypes = [P] * 10 + [I] * 7 + [F, I, P]
    dll.phases_read.argtypes = [P, I]
    return dll


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--splits", default="", help="split sizes (keys); default: decode_split_keys")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA")
    from exllamav3_tpu_torch.ops.build import library
    from exllamav3_tpu_torch.ops.flash_attention import (decode_split_keys, device_sms,
                                                          linear_attention_quant_plain)
    from exllamav3_tpu_torch.ops.kv_quant import merged_layout, quantize_kv_stored
    from exllamav3_tpu_torch.util.timing import rotating, time_ms

    dll = build()
    dev = torch.device("cuda")
    B, Hq, Hk, D, T = 8, 32, 8, 128, 2056
    ctx = np.linspace(300, 2056, 8).astype(np.int32)
    qp = torch.as_tensor(ctx[:, None] - 1, device=dev)
    tl = torch.as_tensor(ctx, device=dev)
    counters = torch.zeros(B * Hk, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev)
    splits = ([int(s) for s in args.splits.split(",")] if args.splits
              else [decode_split_keys(T, B, Hk, device_sms(dev))])
    lib = library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
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
            buf = np.zeros(blocks * SLOTS, np.uint64)
            if dll.phases_read(buf.ctypes.data, blocks):
                raise RuntimeError("reading the timers failed")
            buf = buf.reshape(blocks, SLOTS).astype(np.float64)
            tiles = buf[:, 5].sum()
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
            busy = buf[buf[:, 5] > 0, 6]
            per_tile = ", ".join(f"{nm} {buf[:, k].sum() / tiles:.0f}"
                                 for k, nm in zip((0, 1, 2, 3, 4), PHASES))
            print(f"bits ({kb}, {vb}) split {split}: {int(tiles)} tiles in {len(busy)} blocks that "
                  f"see keys; cycles a tile: {per_tile}; a block: mean {busy.mean():.0f}, longest "
                  f"{busy.max():.0f}; instrumented kernel {e0.elapsed_time(e1) / 20:.4f} ms, "
                  f"rel err {rel:.2e}; library kernel {lib_ms:.4f} ms over rotated inputs, "
                  f"rel err {lib_rel:.2e}", flush=True)
            if not max(rel, lib_rel) <= TOL:
                raise SystemExit(f"split {split}: rel err {max(rel, lib_rel):.2e} > {TOL}")


if __name__ == "__main__":
    main()
