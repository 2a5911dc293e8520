"""Where a step's time goes in the prefill bodies on warpgroup MMAs, on one
card: the body over the paged and the linear cache over its quantized storage
(exllamav3_tpu_torch/csrc/attention_prefill.cuh, kernel rows 5p and 7p), or
with --latent the latent (MLA) body (csrc/latent_prefill.cuh, row 6a-p).

    python3 tools/torch_prefill_phases.py                # paged (4, 4), (5, 3), (8, 8)
    python3 tools/torch_prefill_phases.py --bits 4,4 --steps 8
    python3 tools/torch_prefill_phases.py --latent       # bf16 and (4), both score designs

Writes a copy of the header into build/prefill_phases/ with clock64() timers
at the seams of a step, on the first thread of each warpgroup of the longest
q block (blockIdx.x 0), and builds it with nvcc as ops/build.py builds the
kernels, once with the timers and once without.

Default: for the producer (the two warpgroups that stage and unpack) the
wait for its copies and its own barrier, the look-up and the issue of the
next tile's copies, the wait for the empty operand set, the unpack of K and
V into the set and its arrival; for the two consumer warpgroups of the MMAs
the wait for the full set, the issue of the score wgmmas, the issue of the
P.V wgmmas (each issue returns when the tensor cores take the instruction,
so an issue phase holds the MMAs' own time), the wait for the scores, the
softmax, the wait for P.V and the rescale and pack. It runs at
chip_smoke.py's main prefill shape (S = 2048 on 512 cached, 32 q / 8 kv heads
of 128, a paged cache in a permuted block table) at each width given, holds
each output against the plain version (paged_attention_quant_plain, rotated
as the wrapper rotates) within chip_smoke.py's TOL_ATTN_Q (3e-4 of the
largest output).

--latent: the latent body's two designs of the score product (LP_WHOLE,
both warpgroups score the whole tile; LP_KEYS, each scores half its keys
and they trade the rows' maxima and their P fragments through shared
memory), over the bf16 latent and the (4)-bit one, at chip_smoke.py's main
latent prefill shape (DeepSeek-V2-Lite: S = 2048 on 512 cached, 16 heads, a
paged cache in a permuted block table),
each held to its plain version (latent_attention_prefill_plain,
latent_attention_quant_prefill_plain) within TOL_ATTN (2e-4) or TOL_ATTN_Q.
The pre-pass (latent_tiles_kernel) is timed on its own. Phases of a step of
the body, for each of the two warpgroups: the wait for the tile (its
stage's mbarrier); bf16, the issue of the score wgmmas, then of the P.V
wgmmas, the wait for the scores, the softmax (with its trade), the wait for
P.V, the release of the previous tile's stage (the warpgroup's barrier, and
the next tile's bulk copy from the later warpgroup); quantized, the issue of
the P.V wgmmas, then of the score wgmmas, the wait for P.V, the release, the
wait for the scores, the softmax; then the rescale and pack (with its
trade).

Either way it prints the kernel's time without timers (CUDA events,
util/timing.py, inputs L2-warm), its registers and spills, and the mean
cycles a step by phase over the block's middle steps. The timers cost time
of their own: compare phases, not the instrumented time, with
chip_smoke.py's. Needs CUDA.
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
from exllamav3_tpu_torch.ops.kv_quant import (merged_layout, quantize_kv,  # noqa: E402
                                               quantize_kv_stored, rotate_groups)
from exllamav3_tpu_torch.util.timing import time_ms  # noqa: E402

TOL_ATTN, TOL_ATTN_Q = 2e-4, 3e-4
OUT = ROOT / "build" / "prefill_phases"
STEPS = 128  # steps a block the trace holds

TRACE = f"""
#ifdef PF_TRACE
__device__ long long pf_trace[4][{STEPS}][10];
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

LATENT_PATCHES = [
    ("// The latent prefill body's launches and its pre-pass's in this library (one",
     TRACE + "// The latent prefill body's launches and its pre-pass's in this library (one"),
    ("""        ready(t);
        wgmma_fence();
        if constexpr (LO) {
            pv(t - 1);
            wgmma_commit();
            scores(t);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(o[0]);
            fence_regs(o[1]);
            release(t);
            wgmma_wait<0>();
            fence_regs(sc);
            softmax(t, masked);
        } else {
            scores(t);
            wgmma_commit();
            pv(t - 1);
            wgmma_commit();
            wgmma_wait<1>();
            fence_regs(sc);
            softmax(t, masked);
            wgmma_wait<0>();
            fence_regs(o[0]);
            fence_regs(o[1]);
            release(t);
        }
        rescale();
        pack();""",
     """        PF_T(t, 0);
        ready(t);
        PF_T(t, 1);
        wgmma_fence();
        if constexpr (LO) {
            pv(t - 1);
            wgmma_commit();
            PF_T(t, 2);
            scores(t);
            wgmma_commit();
            PF_T(t, 3);
            wgmma_wait<1>();
            fence_regs(o[0]);
            fence_regs(o[1]);
            PF_T(t, 4);
            release(t);
            PF_T(t, 5);
            wgmma_wait<0>();
            PF_T(t, 6);
            fence_regs(sc);
            softmax(t, masked);
            PF_T(t, 7);
        } else {
            scores(t);
            wgmma_commit();
            PF_T(t, 2);
            pv(t - 1);
            wgmma_commit();
            PF_T(t, 3);
            wgmma_wait<1>();
            PF_T(t, 4);
            fence_regs(sc);
            softmax(t, masked);
            PF_T(t, 5);
            wgmma_wait<0>();
            fence_regs(o[0]);
            fence_regs(o[1]);
            PF_T(t, 6);
            release(t);
            PF_T(t, 7);
        }
        rescale();
        pack();
        PF_T(t, 8);"""),
]
SCORES = "constexpr int LP_SCORES_BF16 = LP_WHOLE, LP_SCORES_QUANT = LP_KEYS;"
DESIGNS = {design: [(SCORES, f"constexpr int LP_SCORES_BF16 = {d}, LP_SCORES_QUANT = {d};")]
           for design, d in (("whole", "LP_WHOLE"), ("keys", "LP_KEYS"))}

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

LATENT_ENTRY = """#include "latent_prefill.cuh"
// the pre-pass over the bf16 latent (kv) or the (bits)-bit one (kq, ks, kpe)
extern "C" int phases_tiles(const void* kv, const void* kq, const void* ks, const void* kpe,
                            int bits, void* tiles, int W, const void* bt, const void* total,
                            int B, int MP, int P, void* stream) {
    const PagedRows rows{static_cast<const int*>(bt), MP, P};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (kv != nullptr)
        return launch_latent_tiles(rows, LatentBf16Src{static_cast<const __nv_bfloat16*>(kv)},
                                   tiles, W, total, B, st);
    return launch_latent_tiles(
        rows,
        LatentQuantSrc{static_cast<const uint32_t*>(kq), static_cast<const __nv_bfloat16*>(ks),
                       static_cast<const __nv_bfloat16*>(kpe), bits, 0.0f, 1.0f},
        tiles, W, total, B, st);
}
// the body over the pre-pass's tiles (quant: hi + lo)
extern "C" int phases_body(const void* q, int quant, const void* tiles, int W, const void* bt,
                           const void* qpos, const void* total, void* out, int B, int S, int Hq,
                           int MP, int P, float scale, void* stream) {
    const PagedRows rows{static_cast<const int*>(bt), MP, P};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return quant ? launch_latent_body<PagedRows, true>(q, rows, tiles, W, qpos, total, out, B, S,
                                                       Hq, scale, st)
                 : launch_latent_body<PagedRows, false>(q, rows, tiles, W, qpos, total, out, B, S,
                                                        Hq, scale, st);
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
# the phases of a step by storage (each issue phase holds the MMAs' own time)
LATENT_PHASES = {
    "bf16": ("wait tile", "score wgmma issue", "P.V wgmma issue", "wait scores", "softmax",
             "wait P.V", "release", "rescale, pack"),
    "(4)": ("wait tile", "P.V wgmma issue", "score wgmma issue", "wait P.V", "release",
            "wait scores", "softmax", "rescale, pack")}


def build_libs(header: str, patches: list, entry: str, variants: dict) -> dict:
    """The patched header's builds, each variant ({name: extra patches})
    with and without the timers: {(variant, "plain" | "trace"): lib}; prints
    ptxas's register and spill lines of each."""
    OUT.mkdir(parents=True, exist_ok=True)
    base = (build.CSRC_DIR / header).read_text()
    for anchor, patched in patches:
        if base.count(anchor) != 1:
            raise RuntimeError(f"{header}: anchor found {base.count(anchor)} times: "
                               f"{anchor[:60]!r}")
        base = base.replace(anchor, patched)
    procs = {}
    for var, extra in variants.items():
        src = base
        for anchor, patched in extra:
            if src.count(anchor) != 1:
                raise RuntimeError(f"{header}: anchor found {src.count(anchor)} times: "
                                   f"{anchor[:60]!r}")
            src = src.replace(anchor, patched)
        d = OUT / var
        d.mkdir(parents=True, exist_ok=True)
        (d / header).write_text(src)
        (d / "phases.cu").write_text(entry)
        for name, flags in (("plain", []), ("trace", ["-DPF_TRACE"])):
            so = d / f"libphases_{name}.so"
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-shared", "-I", str(d), "-I",
                   str(build.CSRC_DIR), str(d / "phases.cu"), "-o", str(so)]
            procs[(var, name)] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc ({key}) failed:\n{out}")
        lines = [line.strip() for line in out.splitlines()
                 if ("registers" in line or "spill" in line) and "dequant" not in line]
        print(f"{key[0]} {key[1]} build: " + " | ".join(lines[-6:]), flush=True)
        libs[key] = ctypes.CDLL(str(so))
    return libs


def phases(trace: np.ndarray, wg: int, npts: int, steps: int) -> tuple:
    """(tiles the block walked, first and last step averaged, mean cycles a
    step, mean cycles by phase) of warpgroup wg's timers."""
    ntiles = int((trace[wg, :, 0] > 0).sum()) + 1  # the loop's steps start at tile 1
    lo = 2
    hi = ntiles - 2 if not steps else min(ntiles - 2, lo + steps)
    return (ntiles, lo, hi, np.diff(trace[wg, lo:hi + 1, 0]).mean(),
            np.diff(trace[wg, lo:hi, :npts], axis=1).mean(axis=0))


def main_quant(args, smi):
    libs = build_libs("attention_prefill.cuh", PATCHES, ENTRY, {"body": []})
    libs = {name: libs[("body", name)] for name in ("plain", "trace")}
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
        trace = np.zeros((4, STEPS, 10), np.int64)
        if libs["trace"].phases_trace(ctypes.c_void_p(trace.ctypes.data)) != 0:
            raise RuntimeError("trace read failed")
        ntiles, lo, hi, step, cons = phases(trace, 0, 8, args.steps)
        prod = np.diff(trace[2, lo:hi, :6], axis=1).mean(axis=0)
        print(f"({kb}, {vb}) {'merged' if merged_layout(kb, vb) else 'per-head'}: kernel "
              f"{res['plain'][0]:.4f} ms (rel {res['plain'][1]:.2e}), with timers "
              f"{res['trace'][0]:.4f} ms; block 0 walks {ntiles} tiles, steps {lo}..{hi - 1}:",
              flush=True)
        print(f"  cycles a step {step:.0f}", flush=True)
        print("  producer: " + ", ".join(f"{n} {c:.0f}" for n, c in zip(PRODUCER, prod)),
              flush=True)
        print("  consumer: " + ", ".join(f"{n} {c:.0f}" for n, c in zip(CONSUMER, cons)),
              flush=True)


def main_latent(args, smi):
    libs = build_libs("latent_prefill.cuh", LATENT_PATCHES, LATENT_ENTRY, DESIGNS)
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    S, pre, Hq = 2048, 512, 16
    scale = 192 ** -0.5
    mp = (pre + S) // PAGE_SIZE + 1
    W = mp * PAGE_SIZE
    bt = torch.as_tensor(rng.permutation(np.arange(mp))[None].astype(np.int32), device=dev)
    qp = torch.arange(pre, pre + S, dtype=torch.int32, device=dev)[None]
    tl = torch.tensor([pre + S], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    q = (torch.randn((1, S, Hq, 576), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    raw = torch.randn((mp, PAGE_SIZE, 1, 576), generator=g, device=dev)
    kv = raw.to(torch.bfloat16)
    kq, ks = quantize_kv(raw[..., :512], 4, 0.0)
    st = {"kv_q": kq, "kv_s": ks, "k_pe": raw[..., 512:].to(torch.bfloat16).contiguous()}
    qr = F.rotate_latent_q(q, 512)
    tiles = torch.empty(W * (2 * 512 + 64), dtype=torch.bfloat16, device=dev)  # W: whole tiles
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    args_ = dict(block_tables=bt, scale=scale)
    cases = {"bf16": (q, kv, None, TOL_ATTN,
                      F.latent_attention_prefill_plain(q, kv, qp, tl, 512, **args_)),
             "(4)": (qr, None, 4, TOL_ATTN_Q,
                     F.latent_attention_quant_prefill_plain(q, st, qp, tl, 4, 0.0, **args_))}

    def lay_out(lib, kvt, bits):  # the pre-pass
        err = lib.phases_tiles(ptr(kvt), ptr(kq), ptr(ks), ptr(st["k_pe"]), bits or 0, ptr(tiles),
                               W, ptr(bt), ptr(tl), 1, mp, mp, stream())
        if err:
            raise RuntimeError(f"pre-pass launch failed with {err}")

    for storage, (qq, kvt, bits, tol, ref) in cases.items():
        lib0 = libs[("keys", "plain")]
        lay_out(lib0, kvt, bits)
        print(f"{storage} pre-pass ({W} keys of the layout, {pre + S} seen): "
              f"{time_ms(lambda: lay_out(lib0, kvt, bits), 20):.4f} ms", flush=True)
        for var in DESIGNS:
            res = {}
            for name in ("plain", "trace"):
                lib = libs[(var, name)]
                out = torch.empty((1, S, Hq, 512), dtype=torch.float32, device=dev)

                def run(lib=lib, out=out, qq=qq, bits=bits):
                    err = lib.phases_body(ptr(qq), int(bool(bits)), ptr(tiles), W, ptr(bt),
                                          ptr(qp), ptr(tl), ptr(out), 1, S, Hq, mp, mp,
                                          ctypes.c_float(scale), stream())
                    if err:
                        raise RuntimeError(f"launch failed with {err}")
                lay_out(lib, kvt, bits)
                run()
                torch.cuda.synchronize()
                got = out if bits is None else rotate_groups(out)
                rel = float((got - ref).abs().max() / ref.abs().max())
                if not rel <= tol:
                    raise AssertionError(f"{storage} {var} {name}: rel err {rel} > {tol}")
                res[name] = (time_ms(run, 20), rel)
            trace = np.zeros((4, STEPS, 10), np.int64)
            if libs[(var, "trace")].phases_trace(ctypes.c_void_p(trace.ctypes.data)) != 0:
                raise RuntimeError("trace read failed")
            print(f"{storage} {var}: body {res['plain'][0]:.4f} ms (rel {res['plain'][1]:.2e}), "
                  f"with timers {res['trace'][0]:.4f} ms", flush=True)
            for wg in (0, 1):
                ntiles, lo_, hi_, step, ph = phases(trace, wg, 9, args.steps)
                print(f"  warpgroup {wg}: block 0 walks {ntiles} tiles, steps {lo_}..{hi_ - 1}, "
                      f"cycles a step {step:.0f}: " + ", ".join(
                          f"{n} {c:.0f}" for n, c in zip(LATENT_PHASES[storage], ph)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bits", default="4,4;5,3;8,8", help="k,v widths; several split by ';'")
    ap.add_argument("--latent", action="store_true",
                    help="the latent body (csrc/latent_prefill.cuh) instead")
    ap.add_argument("--steps", type=int, default=0,
                    help="middle steps averaged (default: all but the first and last two)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_prefill_phases: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    (main_latent if args.latent else main_quant)(args, smi)


if __name__ == "__main__":
    main()
