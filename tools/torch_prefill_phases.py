"""Where a step's time goes in the prefill body over the quantized cache
(exllamav3_tpu_torch/csrc/attention_prefill.cuh, kernel rows 5p and 7p), on
one card.

    python3 tools/torch_prefill_phases.py                # paged (4, 4), (5, 3), (8, 8)
    python3 tools/torch_prefill_phases.py --bits 4,4 --steps 8

Writes a copy of the header into build/prefill_phases/ with clock64() timers
at the seams of a step, on the first thread of each warpgroup of the longest
q block (blockIdx.x 0): for the producer (the two warpgroups that stage and
unpack) the wait for its copies and its own barrier, the look-up and the
issue of the next tile's copies, the wait for the empty operand set, the
unpack of K and V into the set and its arrival; for the two consumer
warpgroups of the MMAs the wait for the full set, the issue of the score
wgmmas, the issue of the P.V wgmmas (each issue returns when the tensor
cores take the instruction, so an issue phase holds the MMAs' own time), the
wait for the scores, the softmax, the wait for P.V and the rescale and
pack. It builds that copy with
nvcc as ops/build.py builds the kernels, once with the timers and once
without, runs both at chip_smoke.py's main prefill shape (S = 2048 on 512
cached, 32 q / 8 kv heads of 128, a paged cache in a permuted block table)
at each width given, holds each output against the plain version
(paged_attention_quant_plain, rotated as the wrapper rotates) within
chip_smoke.py's TOL_ATTN_Q (3e-4 of the largest output), and prints the
kernel's time without timers (CUDA events, util/timing.py, inputs L2-warm),
its registers and spills, and the mean cycles a step by phase over the
block's middle steps. The timers cost time of their own: compare phases,
not the instrumented time, with chip_smoke.py's. Needs CUDA.
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

from exllamav3_tpu_torch.constants import PAGE_SIZE  # noqa: E402
from exllamav3_tpu_torch.ops import build  # noqa: E402
from exllamav3_tpu_torch.ops import flash_attention as F  # noqa: E402
from exllamav3_tpu_torch.ops.kv_quant import (merged_layout, quantize_kv_stored,  # noqa: E402
                                               rotate_groups)
from exllamav3_tpu_torch.util.timing import time_ms  # noqa: E402

TOL_ATTN_Q = 3e-4
OUT = ROOT / "build" / "prefill_phases"
STEPS = 128  # steps a block the trace holds

TRACE = f"""
#ifdef PF_TRACE
__device__ long long pf_trace[4][{STEPS}][8];
#define PF_T(step, pt)                                                                   \\
    do {{                                                                                \\
        if (blockIdx.x == 0 && blockIdx.z == 0 && threadIdx.x % 128 == 0 && (step) < {STEPS}) \\
            pf_trace[threadIdx.x / 128][(step)][(pt)] = clock64();                       \\
    }} while (0)
#else
#define PF_T(step, pt)
#endif
"""

# (anchor in the header, the same text with the timers); each anchor is
# found exactly once
PATCHES = [
    ("// threads of a block: the two warpgroups of the MMAs, and for QuantKV the producer",
     TRACE + "// threads of a block: the two warpgroups of the MMAs, and for QuantKV the producer"),
    ("""                    cp_async_wait<0>();
                    named_sync(PF_BAR_PRODUCER, PF_PRODUCER);  // step u - 1's reads are done
                    look_up(u + 1);  // now tiles u + 1, u, u - 1
                    stage(u + 1);
                    if (u >= 2) named_sync(PF_BAR_EMPTY + (u & 1), NT);
                    if (u < ntiles) unpack(u, keys[1], false);
                    if (u >= 1) unpack(u - 1, keys[2], true);
                    fence_proxy_async();
                    named_arrive(PF_BAR_FULL + (u & 1), NT);""",
     """                    PF_T(u, 0);
                    cp_async_wait<0>();
                    named_sync(PF_BAR_PRODUCER, PF_PRODUCER);
                    PF_T(u, 1);
                    look_up(u + 1);
                    stage(u + 1);
                    PF_T(u, 2);
                    if (u >= 2) named_sync(PF_BAR_EMPTY + (u & 1), NT);
                    PF_T(u, 3);
                    if (u < ntiles) unpack(u, keys[1], false);
                    if (u >= 1) unpack(u - 1, keys[2], true);
                    PF_T(u, 4);
                    fence_proxy_async();
                    named_arrive(PF_BAR_FULL + (u & 1), NT);
                    PF_T(u, 5);"""),
    ("""        ready(t);
        wgmma_fence();
        scores(sc, t);
        wgmma_commit();
        pv(ph, pl, t - 1);
        wgmma_commit();
        issue(t + PF_AHEAD);  // Bf16KV: the copies go out while the products run
        wgmma_wait<1>();
        fence_regs(sc);
        softmax(sc, t, alpha, masked);
        wgmma_wait<0>();
        fence_regs(o);
        done(t);
        rescale(alpha);
        pack(sc, ph, pl);""",
     """        PF_T(t, 0);
        ready(t);
        PF_T(t, 1);
        wgmma_fence();
        scores(sc, t);
        wgmma_commit();
        PF_T(t, 2);
        pv(ph, pl, t - 1);
        wgmma_commit();
        PF_T(t, 3);
        issue(t + PF_AHEAD);
        wgmma_wait<1>();
        PF_T(t, 4);
        fence_regs(sc);
        softmax(sc, t, alpha, masked);
        PF_T(t, 5);
        wgmma_wait<0>();
        PF_T(t, 6);
        fence_regs(o);
        done(t);
        rescale(alpha);
        pack(sc, ph, pl);
        PF_T(t, 7);"""),
]

ENTRY = """#include "attention_prefill.cuh"
extern "C" int phases_prefill(const void* q, const void* kq, const void* ks, const void* vq,
                              const void* vs, const void* bt, const void* qpos,
                              const void* total, void* out, int B, int S, int Hq, int Hk, int MP,
                              int P, int kb, int vb, float scale, void* stream) {
    const PagedRows rows{static_cast<const int*>(bt), MP, P};
    const QuantKV<128> kv{static_cast<const uint32_t*>(kq), static_cast<const __nv_bfloat16*>(ks),
                          static_cast<const uint32_t*>(vq), static_cast<const __nv_bfloat16*>(vs),
                          Hk, kb, vb, 0.0f, 1.0f};
    return launch_prefill<128>(q, rows, kv, qpos, total, nullptr, out, B, S, Hq, Hk, scale, 0,
                               0.0f, static_cast<cudaStream_t>(stream));
}
#ifdef PF_TRACE
extern "C" int phases_trace(void* dst) {
    return (int)cudaMemcpyFromSymbol(dst, pf_trace, sizeof(pf_trace));
}
#endif
"""

PRODUCER = ("wait + barrier", "stage next", "wait empty", "unpack K, V", "arrive full")
CONSUMER = ("wait full", "score wgmma issue", "P.V wgmma issue", "wait scores", "softmax",
            "wait P.V", "rescale, pack")


def build_libs() -> dict:
    """The patched header's two builds: {"plain": lib, "trace": lib}, and
    ptxas's register and spill lines of each."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "attention_prefill.cuh").read_text()
    for anchor, patched in PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"attention_prefill.cuh: anchor found {src.count(anchor)} times: "
                               f"{anchor[:60]!r}")
        src = src.replace(anchor, patched)
    (OUT / "attention_prefill.cuh").write_text(src)
    (OUT / "phases.cu").write_text(ENTRY)
    procs = {}
    for name, flags in (("plain", []), ("trace", ["-DPF_TRACE"])):
        so = OUT / f"libphases_{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-shared", "-I", str(OUT), "-I",
               str(build.CSRC_DIR), str(OUT / "phases.cu"), "-o", str(so)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({name}) failed:\n{out}")
        lines = [line.strip() for line in out.splitlines() if "registers" in line or "spill" in line]
        print(f"{name} build: " + " | ".join(lines), flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", default="4,4;5,3;8,8", help="k,v widths; several split by ';'")
    ap.add_argument("--steps", type=int, default=0,
                    help="middle steps averaged (default: all but the first and last two)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_prefill_phases: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = build_libs()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    S, pre, Hq, Hk, D = 2048, 512, 32, 8, 128
    mp = (pre + S) // PAGE_SIZE + 1
    bt = torch.as_tensor(rng.permutation(np.arange(mp))[None].astype(np.int32), device=dev)
    qp = torch.arange(pre, pre + S, dtype=torch.int32, device=dev)[None]
    tl = torch.tensor([pre + S], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((1, S, Hq, D), generator=g, device=dev)
    qr = rotate_groups(q)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    for spec in args.bits.split(";"):
        kb, vb = (int(x) for x in spec.split(","))
        st = {}
        for nm, b in (("k", kb), ("v", vb)):
            x = torch.randn((mp, PAGE_SIZE, Hk, D), generator=g, device=dev)
            st[nm + "_q"], st[nm + "_s"] = quantize_kv_stored(x, b, merged_layout(kb, vb))
        ref = F.paged_attention_quant_plain(q, st, bt, qp, tl, kb, vb, scale=D ** -0.5)
        res = {}
        for name, lib in libs.items():
            out = torch.empty_like(q)

            def run(lib=lib, out=out):
                err = lib.phases_prefill(
                    ptr(qr), ptr(st["k_q"]), ptr(st["k_s"]), ptr(st["v_q"]), ptr(st["v_s"]),
                    ptr(bt), ptr(qp), ptr(tl), ptr(out), 1, S, Hq, Hk, mp, mp, kb, vb,
                    ctypes.c_float(D ** -0.5),
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"launch failed with {err}")
            run()
            torch.cuda.synchronize()
            rel = float((rotate_groups(out) - ref).abs().max() / ref.abs().max())
            if not rel <= TOL_ATTN_Q:
                raise AssertionError(f"({kb}, {vb}) {name}: rel err {rel} > {TOL_ATTN_Q}")
            res[name] = (time_ms(run, 20), rel)
        trace = np.zeros((4, STEPS, 8), np.int64)
        run_trace = libs["trace"]
        if run_trace.phases_trace(ctypes.c_void_p(trace.ctypes.data)) != 0:
            raise RuntimeError("trace read failed")
        # the block's steps: the consumers' first tile is step 0 of the loop's
        # timers only from step 1 on; the producer's from 0
        ntiles = int((trace[0, :, 0] > 0).sum()) + 1
        lo = 2
        hi = ntiles - 2 if not args.steps else min(ntiles - 2, lo + args.steps)
        print(f"({kb}, {vb}) {'merged' if merged_layout(kb, vb) else 'per-head'}: kernel "
              f"{res['plain'][0]:.4f} ms (rel {res['plain'][1]:.2e}), with timers "
              f"{res['trace'][0]:.4f} ms; block 0 walks {ntiles} tiles, steps {lo}..{hi - 1}:",
              flush=True)
        prod = np.diff(trace[2, lo:hi, :6], axis=1).mean(axis=0)
        cons = np.diff(trace[0, lo:hi, :8], axis=1).mean(axis=0)
        step = np.diff(trace[0, lo:hi + 1, 0]).mean()
        print(f"  cycles a step {step:.0f}", flush=True)
        print("  producer: " + ", ".join(f"{n} {c:.0f}" for n, c in zip(PRODUCER, prod)),
              flush=True)
        print("  consumer: " + ", ".join(f"{n} {c:.0f}" for n, c in zip(CONSUMER, cons)),
              flush=True)


if __name__ == "__main__":
    main()
