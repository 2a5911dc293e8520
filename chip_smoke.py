"""Smoke run of the PyTorch/CUDA port (exllamav3_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases build,exl3_gemm,paged_attention_quant
    python3 chip_smoke.py --phases build,serve_capacity
    python3 chip_smoke.py --phases build,int4_matmul_a8,intb_matmul_a8,serve_packed
    python3 chip_smoke.py --phases build,moe_gemm,serve_moe

Phases:
  build     build the CUDA kernels from exllamav3_tpu_torch/csrc/ (timed)
  kernels   each kernel against its plain PyTorch version at the shapes of
            the Llama-3.1-8B main paths: errors, kernel / plain / library
            times and the bound (bytes over 3.35 TB/s, or tensor-core
            operations over their peak rate, whichever is larger). In place
            of `kernels`, one check's name runs that check alone:
            int8_matmul, fused_mlp, paged_attention, exl3_gemm (all K and
            codebooks; also an estimate of the decode's dispatch time from the
            compiled kernel's instructions, kept apart from the bound) and
            paged_attention_quant (merged and per-head storage, with and
            without the compander), int4_matmul, int4_matmul_a8, intb_matmul
            and intb_matmul_a8 (the packed-integer linears: also m = 128 and
            the Llama-3.1-70B shapes at m = 8; int-B at B = 3, 4, 5, 6),
            moe_gemm (the selected-expert MLP at the Qwen3-30B-A3B,
            Qwen3-235B-A22B and Mixtral-8x7B expert shapes). int8_matmul also
            runs the Qwen3-30B-A3B attention and head shapes, paged_attention
            also GQA group 8 (32 q / 4 kv heads)
  parity    a 2-layer checkpoint at full 8B width: forward_simple and paged
            prefill + decode steps on the GPU (kernels) against the CPU
            (plain versions) over the same ids and weights, for the int8 path
            for the capacity path (`fused` linears, (4, 4) cache) and for the
            packed tiers int4 and int6 (a8 kernels); then a 2-layer Qwen3-MoE
            checkpoint at full Qwen3-30B-A3B width (int8), the GPU given the
            CPU's routing, with the share of (token, layer) expert sets the
            GPU's own router picks alike
  serve     a 32-layer synthetic checkpoint at Llama-3.1-8B geometry loaded
            with linear_mode="auto" (int8 on an 80 GB card) over a bf16 cache
            and served by the continuous-batching generator: 8 greedy
            requests, 512-1536 token prompts sharing a 512-token prefix, 128
            new tokens each
  serve_capacity
            the same checkpoint and requests with linear_mode="fused" (every
            linear decodes its trellis in the GEMM kernel) over a quantized
            cache, k_bits = v_bits = 4, then one request on 4 layers with a
            (5, 3) cache, whose odd widths use the per-head storage. The
            served token is held against a forward of the same weights and
            cache widths through the plain PyTorch versions only
  serve_packed
            the same checkpoint and requests with linear_mode="int4" (grouped
            4-bit codes, the int8-activation kernel) over the bf16 cache; then
            one request on 4 layers each for int6 (a8), int4 with
            EXL3TPU_INT4_A8=0 and int6 with EXL3TPU_INTB_A8=0, so that each of
            the four packed kernels serves a run of its own; then the ladder:
            linear_mode="auto" on a device just large enough for int8, int6,
            int4 and none of them loads and runs on every rung
  serve_moe a 48-layer synthetic Qwen3-MoE checkpoint at Qwen3-30B-A3B geometry
            (128 experts, top 8, vocab 151936) loaded with linear_mode="auto"
            (int8 on an 80 GB card; the experts serve as bf16 stacks) over a
            bf16 cache, the same traffic: prefill chunks through the grouped
            experts, decode steps through the selected-expert kernel

Each serve phase sets every kernel's launch count to 0 before its run and
reads it after: the kernels of its path must all have launched and the
others not at all.

The second-to-last line is the kernel table as JSON and the last line is
{"ok": true, "device": {...}}. Any failed phase raises and exits non-zero
without that line. Needs CUDA; writes its checkpoints under build/chip_smoke/
(the 48-layer MoE one is ~15 GB, one shard a layer).
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core rate
INT8_OP_PER_S = 1979e12     # dense int8 tensor-core rate
L2_BYTES = 50 << 20
SPIN_CYCLES = 35_000_000    # ~20 ms at the H100's clock
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

LLAMA8B = dict(vocab_size=32768, hidden_size=4096, intermediate_size=14336,
               num_q_heads=32, num_kv_heads=8, head_dim=128)
# Qwen/Qwen3-30B-A3B config.json (every layer MoE, no shared expert)
QWEN3_30B = dict(vocab_size=151936, hidden_size=2048, intermediate_size=6144,
                 moe_intermediate_size=768, num_q_heads=32, num_kv_heads=4, head_dim=128,
                 num_experts=128, num_experts_per_tok=8, rms_norm_eps=1e-6, rope_theta=1e6)

# tolerances, each relative to the largest magnitude of the plain result
TOL_INT8 = 1e-4   # both sides: exact bf16 products, f32 sums in another order
TOL_MLP = 2e-3    # f32 order can flip a bf16 rounding of the activation
TOL_ATTN = 2e-4   # q and P enter the MMAs as hi + lo bf16 pairs (~2^-16 relative)
TOL_EXL3 = 1e-4   # both sides: the same bf16 weights and activations, f32 sums in another order
TOL_PACKED = 1e-4  # both sides: the same bf16 or int8 operands, f32 sums in another order
TOL_ATTN_Q = 3e-4  # as TOL_ATTN; K/V are exact hi + lo pairs, the rotation sums in another order
# the selected-expert MLP, relative to the range of the plain result: the same
# bf16 products, f32 sums in another order, which now and then flip the bf16
# rounding of one activation (one flip moves an output by 2^-8 of that
# activation's term: up to 1.13e-4 of the largest magnitude at Qwen3-235B-A22B
# shapes on an H100 80GB HBM3 at 700 W)
TOL_MOE = 1e-4
# logits over a quantized cache, kernels against plain versions, relative to
# the logits' range: the two sides store different codes where a key or value
# sits on a grid edge (a step of a 4-bit grid is 1/8 of its group's range)
# and its last bf16 bit differs
TOL_QUANT_PATH = 6e-2
# logits of the a8 packed tiers, GPU against CPU: the row quantizer turns an
# activation whose last bf16 bit differs between the two devices into another
# int8 code (a step of 1/127 of the row's largest value). On the card alone,
# kernels against plain versions, upstream is identical and 2e-2 holds
TOL_A8_PATH = 6e-2
# logits of the MoE path, GPU against CPU, relative to the logits' largest
# magnitude, with the GPU given the CPU's routing at every layer (a router
# logit whose last bf16 bit differs between the devices would otherwise pick
# another expert for a token). The same sources of difference as the dense
# int8 path, held to the same limit
TOL_MOE_PATH = 2e-2
MIN_EXPERT_AGREEMENT = 0.9   # share of (token, layer) expert sets alike on both devices

# An SM dispatches one warp instruction a clock from each of its four schedulers
LANES_PER_SM_CLOCK = 4 * 32

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "int8_matmul": ("exllamav3_tpu_torch/csrc/int8_matmul.cu", "exllamav3_tpu/ops/q_matmul.py:44"),
    "fused_mlp": ("exllamav3_tpu_torch/csrc/fused_mlp.cu", "exllamav3_tpu/ops/fused_mlp.py:47"),
    "paged_attention": ("exllamav3_tpu_torch/csrc/paged_attention.cu",
                        "exllamav3_tpu/ops/flash_attention.py:253"),
    "exl3_gemm": ("exllamav3_tpu_torch/csrc/exl3_gemm.cu", "exllamav3_tpu/ops/exl3_gemm.py:153"),
    "paged_attention_quant_merged": ("exllamav3_tpu_torch/csrc/paged_attention_quant.cu",
                                     "exllamav3_tpu/ops/flash_attention.py:419"),
    "paged_attention_quant_per_head": ("exllamav3_tpu_torch/csrc/paged_attention_quant.cu",
                                       "exllamav3_tpu/ops/flash_attention.py:253"),
    "int4_matmul": ("exllamav3_tpu_torch/csrc/int4_matmul.cu", "exllamav3_tpu/ops/q_matmul.py:217"),
    "int4_matmul_a8": ("exllamav3_tpu_torch/csrc/int4_matmul.cu",
                       "exllamav3_tpu/ops/q_matmul.py:315"),
    "intb_matmul": ("exllamav3_tpu_torch/csrc/intb_matmul.cu", "exllamav3_tpu/ops/q_matmul.py:571"),
    "intb_matmul_a8": ("exllamav3_tpu_torch/csrc/intb_matmul.cu",
                       "exllamav3_tpu/ops/q_matmul.py:687"),
    "moe_gemm": ("exllamav3_tpu_torch/csrc/moe_gemm.cu", "exllamav3_tpu/ops/moe_gemm.py:48"),
}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """The larger of bytes over the memory rate and tensor-core operations
    over their peak rate (bf16 unless the MMAs are int8)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(fn, calls: int) -> float:
    """Mean device time of fn() over `calls` launches (CUDA events). The
    launches queue up behind a ~20 ms spin on the device, so that a short
    kernel reads its time on the card and not the host's launch rate."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    t0.record()
    for _ in range(calls):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def rotating(make, nbytes: int):
    """Enough independent copies of an input set that cycling through them
    exceeds the L2 cache, so each timed call reads device memory as the
    main path does."""
    n = max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1)))
    sets = [make(i) for i in range(n)]
    state = {"i": 0}

    def nxt():
        s = sets[state["i"] % n]
        state["i"] += 1
        return s
    return nxt


class KernelTable:
    """Rows hold only what this run measured: a kernel's errors and times
    once the kernels phase checked it, its launches once the serve phase
    counted them (null otherwise)."""

    def __init__(self):
        self.rows = {}

    def row(self, name):
        source, replaces = KERNELS[name]
        return self.rows.setdefault(name, {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None})

    def add(self, name, err, ms, plain_ms, bnd, library_ms, shape, main, **extra):
        row = self.row(name)
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
        if main and ms is not None:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                       library_ms=library_ms, shape=shape, **extra)

    def set_launches(self, counts):
        """A kernel that several serve phases run keeps the count of the
        first, the path it was ported for (the log prints every phase's)."""
        for name, n in counts.items():
            row = self.row(name)
            if row["launches"] is None:
                row["launches"] = n


# -- phase: kernels -------------------------------------------------------------

def check_int8(table, dev):
    from exllamav3_tpu_torch.ops.q_matmul import int8_matmul_kernel, int8_matmul_plain

    shapes = [(4096, 6144, "qkv"), (4096, 4096, "o_proj"), (4096, 28672, "gate_up"),
              (14336, 4096, "down"), (4096, 32768, "lm_head")]
    # Qwen3-30B-A3B's int8 linears: qkv, o_proj and the 151936-row head
    q3 = [(2048, 5120, "Qwen3-30B-A3B qkv"), (4096, 2048, "Qwen3-30B-A3B o_proj"),
          (2048, 151936, "Qwen3-30B-A3B lm_head")]
    g = torch.Generator(device=dev).manual_seed(1)
    for m in (1, 8, 2048):
        for k, n, what in shapes + (q3 if m < 2048 else q3[:2]):
            def make(i, k=k, n=n, m=m):
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                w = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
                s = (torch.rand(n, generator=g, device=dev) + 0.5) * 0.01
                return x, w, s
            nb = m * k * 2 + k * n + n * 4 + m * n * 4
            nxt = rotating(make, nb)
            x, w, s = nxt()
            ref = int8_matmul_plain(x, w, s)
            got = int8_matmul_kernel(x, w, s)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            calls = 5 if m == 2048 else 20
            ms = time_ms(lambda: int8_matmul_kernel(*nxt()), calls)
            plain = time_ms(lambda: int8_matmul_plain(*nxt()), 3)
            # yardstick: cuBLAS bf16 GEMM on a dequantized copy (2 bytes/weight)
            nxt_lib = rotating(lambda i: (x, w.to(torch.bfloat16)), m * k * 2 + k * n * 2 + m * n * 2)
            lib = time_ms(lambda: torch.matmul(*nxt_lib()), calls)
            bnd = bound_ms(nb, 2.0 * m * k * n)
            log(f"int8_matmul m={m} {what} ({k}x{n}): max_abs_err={err:.3e} rel={rel:.2e} "
                f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms(torch.matmul bf16)={lib:.4f} "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            if not rel <= TOL_INT8:
                raise AssertionError(f"int8_matmul m={m} {what}: rel err {rel} > {TOL_INT8}")
            table.add("int8_matmul", err, ms, plain, bnd, lib, f"m={m} k={k} n={n}",
                      main=(m == 8 and what == "qkv"))
            del x, w, s, ref, got, nxt, nxt_lib
    torch.cuda.empty_cache()


def check_fused_mlp(table, dev):
    from exllamav3_tpu_torch.ops.fused_mlp import fused_mlp_int8_kernel, fused_mlp_int8_plain

    h, inter = 4096, 14336
    g = torch.Generator(device=dev).manual_seed(2)
    for m in (1, 8, 16):
        def make(i, m=m):
            x = torch.randn((m, h), generator=g, device=dev).to(torch.bfloat16)
            gu = torch.randint(-127, 128, (h, 2 * inter), generator=g, device=dev, dtype=torch.int8)
            gs = torch.full((2 * inter,), 1.0 / (73.0 * math.sqrt(h)), device=dev)
            d = torch.randint(-127, 128, (inter, h), generator=g, device=dev, dtype=torch.int8)
            return x, gu, gs, d
        nb = m * h * 2 + 3 * h * inter + 2 * inter * 4 + m * h * 4
        nxt = rotating(make, nb)
        args = nxt()
        ref = fused_mlp_int8_plain(*args)
        got = fused_mlp_int8_kernel(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ms = time_ms(lambda: fused_mlp_int8_kernel(*nxt()), 20)
        plain = time_ms(lambda: fused_mlp_int8_plain(*nxt()), 3)
        bnd = bound_ms(nb, 6.0 * m * h * inter)
        log(f"fused_mlp m={m} h={h} i={inter}: max_abs_err={err:.3e} rel={rel:.2e} "
            f"kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms=null "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        if not rel <= TOL_MLP:
            raise AssertionError(f"fused_mlp m={m}: rel err {rel} > {TOL_MLP}")
        table.add("fused_mlp", err, ms, plain, bnd, None, f"m={m} h={h} i={inter}",
                  main=(m == 8))
        del args, ref, got, nxt
    torch.cuda.empty_cache()


def _attn_work(qpos, total, Hq, Hk, D, window):
    """Bytes and operations this data needs: visible (query, key) pairs and
    the distinct keys each sequence's rows can see."""
    B, S = qpos.shape
    pairs, keys = 0, 0
    for b in range(B):
        hi = np.minimum(qpos[b], total[b] - 1)
        lo = np.maximum(qpos[b] - window + 1, 0) if window else np.zeros_like(hi)
        cnt = np.maximum(hi - lo + 1, 0)
        pairs += int(cnt.sum())
        keys += int(hi.max() - lo.min() + 1) if cnt.max() > 0 else 0
    nbytes = B * S * Hq * D * (4 + 4) + keys * Hk * D * 2 * 2
    return nbytes, 4.0 * pairs * Hq * D


def check_attention(table, dev):
    from exllamav3_tpu_torch.constants import PAGE_SIZE
    from exllamav3_tpu_torch.ops.flash_attention import (paged_attention_kernel,
                                                          paged_attention_plain)

    Hq, D = 32, 128
    rng = np.random.default_rng(3)
    cases = []
    ctx = np.linspace(300, 2048, 8).astype(np.int32)
    cases.append(("decode B=8 ctx 300-2048", ctx[:, None] - 1, ctx, {}, True))
    # Qwen3-30B-A3B: 32 q / 4 kv heads, a GQA group of 8
    cases.append(("decode B=8 ctx 300-2048, group 8", ctx[:, None] - 1, ctx, {"kv_heads": 4},
                  False))
    cases.append(("prefill S=2048 on 512 cached, group 8",
                  (512 + np.arange(2048, dtype=np.int32))[None], np.array([2560], np.int32),
                  {"kv_heads": 4}, False))
    cases.append(("prefill S=2048 on 512 cached", (512 + np.arange(2048, dtype=np.int32))[None],
                  np.array([2560], np.int32), {}, False))
    cases.append(("decode + sliding window 512", ctx[:, None] - 1, ctx,
                  {"sliding_window": 512}, False))
    cases.append(("decode + softcap 30", ctx[:, None] - 1, ctx, {"logit_softcap": 30.0}, False))
    cases.append(("decode + sinks", ctx[:, None] - 1, ctx, {"sinks": True}, False))
    cases.append(("prefill S=256 + window 128 + softcap + sinks, padded tail",
                  np.concatenate([700 + np.arange(200), np.full(56, 4096)]).astype(np.int32)[None],
                  np.array([900], np.int32),
                  {"sliding_window": 128, "logit_softcap": 20.0, "sinks": True}, False))
    for name, qpos, total, kw, main in cases:
        B, S = qpos.shape
        Hk = kw.pop("kv_heads", 8)
        mp = int(math.ceil(total.max() / PAGE_SIZE)) + 1
        P = B * mp + 1
        perm = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
        perm[:, -1] = 0  # the scratch column
        g = torch.Generator(device=dev).manual_seed(4)
        q = torch.randn((B, S, Hq, D), generator=g, device=dev)
        k = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
        bt = torch.as_tensor(perm, device=dev)
        qp = torch.as_tensor(qpos, device=dev)
        tl = torch.as_tensor(total, device=dev)
        args = dict(scale=D ** -0.5, sliding_window=kw.get("sliding_window", 0),
                    logit_softcap=kw.get("logit_softcap", 0.0),
                    sinks=(torch.randn(Hq, generator=g, device=dev) if kw.get("sinks") else None))
        ref = paged_attention_plain(q, k, v, bt, qp, tl, **args)
        got = paged_attention_kernel(q, k, v, bt, qp, tl, **args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention {name}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        ms = time_ms(lambda: paged_attention_kernel(q, k, v, bt, qp, tl, **args), 10)
        plain = time_ms(lambda: paged_attention_plain(q, k, v, bt, qp, tl, **args), 2)
        lib = None
        if not kw:
            # SDPA over the pre-gathered contiguous K/V with the same mask
            T = mp * PAGE_SIZE
            kc = k[bt.long()].reshape(B, T, Hk, D).transpose(1, 2).contiguous()
            vc = v[bt.long()].reshape(B, T, Hk, D).transpose(1, 2).contiguous()
            kpos = torch.arange(T, device=dev)
            mask = (kpos[None, None, :] <= qp[:, :, None]) & (kpos[None, None, :] < tl[:, None, None])
            qt = q.to(torch.bfloat16).transpose(1, 2)
            lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=mask[:, None], scale=D ** -0.5, enable_gqa=True), 10)
        nb, fl = _attn_work(qpos, total, Hq, Hk, D, args["sliding_window"])
        bnd = bound_ms(nb, fl)
        log(f"paged_attention {name}: max_abs_err={err:.3e} rel={rel:.2e} kernel_ms={ms:.4f} "
            f"plain_ms={plain:.4f} library_ms(sdpa)={lib if lib is None else f'{lib:.4f}'} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
        if not rel <= TOL_ATTN:
            raise AssertionError(f"paged_attention {name}: rel err {rel} > {TOL_ATTN}")
        table.add("paged_attention", err, ms, plain, bnd, lib,
                  f"{name}: B={B} S={S} Hq={Hq} Hk={Hk} D={D}", main=main)
        del q, k, v, ref, got
    torch.cuda.empty_cache()


SASS_LINE = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)[^;]*;")
SASS_MEMORY = {"LDS", "LDSM", "LDG", "LD", "LDC", "STS", "STG", "ST"}
SASS_CONTROL = {"BRA", "BRX", "JMP", "CALL", "RET", "EXIT", "BSSY", "BSYNC", "BAR", "WARPSYNC",
                "NOP", "DEPBAR"}


def decode_dispatch_estimate(K: int = 4, cb: int = 0):
    """(thread instructions per decoded weight, thread instructions the card
    dispatches a second), read from this build and this card, or None where the
    toolkit has no cuobjdump or the loop is not found.

    Disassembles the built library, takes exl3_gemm_kernel<K, cb>, and in it
    the shortest backward-branch span that holds a tensor-core instruction:
    the loop over the 16-row tiles of a staged step, in which each lane
    decodes 8 weights. Counted are the span's instructions other than
    tensor-core, memory and control ones (a static count: all eight row
    blocks' address arithmetic is in it, of which a decode step runs one).
    The rate is SMs x 4 schedulers x 32 lanes x the card's highest SM clock."""
    import exllamav3_tpu_torch.ops.build as kbuild

    tool = os.path.join(os.path.dirname(kbuild.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        log("exl3_gemm decode estimate: no cuobjdump beside nvcc; not measured")
        return None
    sass = subprocess.run([tool, "-sass", str(kbuild.build())], capture_output=True, text=True,
                          check=True).stdout
    want = f"exl3_gemm_kernelILi{K}ELi{cb}EE"
    instrs, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = want in line
        elif inside:
            mt = SASS_LINE.match(line)
            if mt:
                instrs.append((int(mt.group(1), 16), mt.group(2), line.strip()))
    spans = []
    for addr, op, text in instrs:
        target = re.search(r"\b0x([0-9a-f]+)\s*;", text)
        if op == "BRA" and target and int(target.group(1), 16) <= addr:
            body = [i for i in instrs if int(target.group(1), 16) <= i[0] <= addr]
            if any(i[1] == "HMMA" for i in body):
                spans.append(body)
    if not spans:
        log(f"exl3_gemm decode estimate: no loop with HMMA found in {want}; not measured")
        return None
    body = min(spans, key=len)
    with open(os.path.join(WORK, f"exl3_gemm_K{K}_cb{cb}_loop.sass"), "w") as f:
        f.write("\n".join(i[2] for i in body) + "\n")
    hist: dict = {}
    for _, op, _ in body:
        hist[op] = hist.get(op, 0) + 1
    alu = sum(n for op, n in hist.items()
              if op != "HMMA" and op not in SASS_MEMORY and op not in SASS_CONTROL)
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True, text=True,
                               check=True).stdout.split()[0])
    rate = torch.cuda.get_device_properties(0).multi_processor_count * LANES_PER_SM_CLOCK * mhz * 1e6
    log(f"exl3_gemm decode estimate: K={K} cb={cb} tile loop holds {len(body)} instructions for "
        f"8 weights a lane, {alu} of them neither tensor-core, memory nor control "
        f"({alu / 8:.3f} a weight); dispatch rate {rate:.4e} thread instructions/s "
        f"(max SM clock {mhz:.0f} MHz); " + json.dumps(dict(sorted(hist.items()))))
    return alu / 8, rate


def check_exl3_gemm(table, dev):
    from exllamav3_tpu_torch.ops.exl3_gemm import exl3_gemm_kernel, exl3_gemm_plain

    est = decode_dispatch_estimate()

    shapes = [(4096, 4096, "q/o_proj"), (4096, 1024, "k/v_proj"), (4096, 14336, "gate/up"),
              (14336, 4096, "down"), (4096, 32768, "lm_head")]
    cases = [(8, 4096, 4096, K, cb, f"K={K} cb={cb}") for K in range(1, 9) for cb in range(3)
             if (K, cb) != (4, 0)]
    cases += [(m, k, n, 4, 0, what) for m in (1, 8, 128) for k, n, what in shapes]
    cases += [(2048, 4096, 4096, 4, 0, "q/o_proj prefill"),
              (2048, 4096, 14336, 4, 0, "gate/up prefill")]
    g = torch.Generator(device=dev).manual_seed(7)
    for m, k, n, K, cb, what in cases:
        def make(i, m=m, k=k, n=n, K=K):
            xh = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            w = torch.randint(-2**31, 2**31, (k // 16, K, n // 2), generator=g, device=dev,
                              dtype=torch.int64).to(torch.int32)
            return xh, w
        nb = m * k * 2 + k * n * K // 8 + m * n * 4
        timed = K == 4 and cb == 0
        nxt = rotating(make, nb) if timed else (lambda made=make(0): made)
        xh, w = nxt()
        ref = exl3_gemm_plain(xh, w, K, cb)
        got = exl3_gemm_kernel(xh, w, K, cb)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"exl3_gemm m={m} {what}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not rel <= TOL_EXL3:
            raise AssertionError(f"exl3_gemm m={m} {what} ({k}x{n}): rel err {rel} > {TOL_EXL3}")
        if not timed:
            log(f"exl3_gemm m={m} {what} ({k}x{n}): max_abs_err={err:.3e} rel={rel:.2e}")
            table.add("exl3_gemm", err, None, None, None, None, "", main=False)
            continue
        calls = 5 if m == 2048 else 20
        ms = time_ms(lambda: exl3_gemm_kernel(*nxt(), K, cb), calls)
        plain = time_ms(lambda: exl3_gemm_plain(*nxt(), K, cb), 2)
        # yardstick: cuBLAS bf16 GEMM on the decoded weight (2 bytes a weight)
        from exllamav3_tpu_torch.ops.exl3_gemm import words_to_trellis
        from exllamav3_tpu_torch.quant.reconstruct import reconstruct_inner
        wd = reconstruct_inner(words_to_trellis(w), K, cb, dtype=torch.bfloat16)
        nxt_lib = rotating(lambda i: (xh, wd.clone()), m * k * 2 + k * n * 2 + m * n * 2)
        lib = time_ms(lambda: torch.matmul(*nxt_lib()), calls)
        bnd = bound_ms(nb, 2.0 * m * k * n)
        # not a bound: the time to dispatch the decode's instructions, once per
        # weight and 128-row block, were nothing else in the way
        t_dec = (None if est is None
                 else k * n * math.ceil(m / 128) * est[0] / est[1] * 1e3)
        log(f"exl3_gemm m={m} {what} ({k}x{n}) K={K}: max_abs_err={err:.3e} rel={rel:.2e} "
            f"kernel_ms={ms:.4f} plain_ms(reconstruct + matmul)={plain:.4f} "
            f"library_ms(torch.matmul bf16 on the decoded weight)={lib:.4f} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]}) decode_est_ms="
            + ("not measured" if t_dec is None else f"{t_dec:.4f}"))
        table.add("exl3_gemm", err, ms, plain, bnd, lib, f"m={m} k={k} n={n} K={K}",
                  main=(m == 8 and what == "q/o_proj"), decode_est_ms=t_dec)
        del xh, w, ref, got, nxt, nxt_lib, wd
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()


PACKED = ("int4_matmul", "int4_matmul_a8", "intb_matmul", "intb_matmul_a8")
SHAPES_8B = [(4096, 6144, "qkv"), (4096, 4096, "o_proj"), (4096, 28672, "gate_up"),
             (14336, 4096, "down"), (4096, 32768, "lm_head")]
SHAPES_70B = [(8192, 10240, "70B qkv"), (8192, 8192, "70B o_proj"), (8192, 57344, "70B gate_up"),
              (28672, 8192, "70B down")]


def check_packed(table, dev, name: str):
    """One of the four packed-integer kernels against its plain version on the
    card: the 8B shapes at m = 1, 8, 128, 2048 and the 70B shapes at m = 8;
    int-B at B = 3, 4, 5, 6. Timed: the int4 kernels everywhere, the int-B
    kernels at B = 6 (the ladder's rung); the other widths are held to the
    tolerance only. x is bf16, as the model's activations are."""
    import exllamav3_tpu_torch.ops.q_matmul as qm

    a8 = name.endswith("_a8")
    kernel, plain = getattr(qm, name + "_kernel"), getattr(qm, name + "_plain")
    g = torch.Generator(device=dev).manual_seed(11)
    cases = [(m, *shape) for m in (1, 8, 128, 2048) for shape in SHAPES_8B]
    cases += [(8, *shape) for shape in SHAPES_70B]
    for bits in ((None,) if name.startswith("int4") else (6, 3, 4, 5)):
        extra = () if bits is None else (bits,)
        for m, k, n, what in cases:
            if bits is None:
                prows, srows, dt, lo, hi = k // 2, k // 32, torch.int8, -128, 128
            else:
                W, prows, k_pad = qm.intb_geometry(k, bits)
                srows, dt, lo, hi = k_pad // 32, torch.int32, -2**31, 2**31

            def make(i, m=m, k=k, n=n, prows=prows, srows=srows, dt=dt, lo=lo, hi=hi):
                x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
                w = torch.randint(lo, hi, (prows, n), generator=g, device=dev,
                                  dtype=torch.int64).to(dt)
                s = ((torch.rand((srows, n), generator=g, device=dev) + 0.5) * 0.01).to(torch.bfloat16)
                return x, w, s
            nb = m * k * 2 + prows * n * (1 if bits is None else 4) + srows * n * 2 + m * n * 4
            timed = bits in (None, 6)
            nxt = rotating(make, nb) if timed else (lambda made=make(0): made)
            x, w, s = nxt()
            ref = plain(x, w, s, *extra)
            got = kernel(x, w, s, *extra)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} m={m} {what}: non-finite output")
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            tag = f"{name}{'' if bits is None else f' B={bits}'} m={m} {what} ({k}x{n})"
            if not rel <= TOL_PACKED:
                raise AssertionError(f"{tag}: rel err {rel} > {TOL_PACKED}")
            if not timed:
                log(f"{tag}: max_abs_err={err:.3e} rel={rel:.2e}")
                table.add(name, err, None, None, None, None, "", main=False)
                del x, w, s, ref, got, nxt
                continue
            calls = 5 if m == 2048 else 20
            ms = time_ms(lambda: kernel(*nxt(), *extra), calls)
            plain_t = time_ms(lambda: plain(*nxt(), *extra), 2)
            # yardstick: cuBLAS bf16 GEMM on the dequantized weight (2 bytes a weight)
            wd = (qm.int4_unpack(w, s) if bits is None
                  else qm.intb_unpack(w, s, bits, k)).to(torch.bfloat16)
            nxt_lib = rotating(lambda i: (x, wd.clone()), m * k * 2 + k * n * 2 + m * n * 2)
            lib = time_ms(lambda: torch.matmul(*nxt_lib()), calls)
            bnd = bound_ms(nb, 2.0 * m * k * n, INT8_OP_PER_S if a8 else BF16_FLOP_PER_S)
            log(f"{tag}: max_abs_err={err:.3e} rel={rel:.2e} kernel_ms={ms:.4f} "
                f"plain_ms={plain_t:.4f} library_ms(torch.matmul bf16 on the decoded weight)="
                f"{lib:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})")
            table.add(name, err, ms, plain_t, bnd, lib,
                      f"m={m} k={k} n={n}" + ("" if bits is None else f" B={bits}"),
                      main=(m == 8 and what == "qkv"))
            del x, w, s, ref, got, nxt, nxt_lib, wd
            torch.cuda.empty_cache()
    torch.cuda.empty_cache()


# (name, h, i, E, k, token counts) from the published configs
MOE_SHAPES = [("Qwen3-30B-A3B", 2048, 768, 128, 8, (1, 8, 15)),
              ("Qwen3-235B-A22B", 4096, 1536, 128, 8, (8,)),
              ("Mixtral-8x7B", 4096, 14336, 8, 2, (1, 8))]


def _moe_routing(rng, T, E, k, dev):
    """Seeded routing that puts several tokens on the same experts: each
    token draws k distinct experts with weights skewed toward a few, as a
    trained router's load is; routing weights positive, summing to 1."""
    p = rng.pareto(1.0, E) + 0.05
    p /= p.sum()
    topi = np.stack([rng.choice(E, k, replace=False, p=p) for _ in range(T)]).astype(np.int32)
    topv = rng.random((T, k)).astype(np.float32) + 0.1
    topv /= topv.sum(-1, keepdims=True)
    return torch.as_tensor(topi, device=dev), torch.as_tensor(topv, device=dev)


def moe_library(x, groups, topv, wg, wu, wd):
    """The same routed function from PyTorch products, as the grouped path
    computes it: for each distinct routed expert, its tokens times its three
    bf16 weights (cuBLAS), the activation rounded to bf16, the weighted rows
    added into the output. `groups` is [(expert, token rows, slot rows)],
    made on the host beforehand."""
    out = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    flat_v = topv.reshape(-1)
    for e, rows, slots in groups:
        xe = x[rows]
        a = (torch.nn.functional.silu(torch.matmul(xe, wg[e]).float())
             * torch.matmul(xe, wu[e]).float()).to(torch.bfloat16)
        out.index_add_(0, rows, torch.matmul(a, wd[e]).float() * flat_v[slots, None])
    return out


def check_moe_gemm(table, dev):
    from exllamav3_tpu_torch.ops.moe_gemm import (selected_expert_mlp_kernel,
                                                  selected_expert_mlp_plain)

    rng = np.random.default_rng(13)
    g = torch.Generator(device=dev).manual_seed(13)
    for name, h, inter, E, k, Ts in MOE_SHAPES:
        wg = (torch.randn((E, h, inter), generator=g, device=dev) / math.sqrt(h)).to(torch.bfloat16)
        wu = (torch.randn((E, h, inter), generator=g, device=dev) / math.sqrt(h)).to(torch.bfloat16)
        wd = (torch.randn((E, inter, h), generator=g, device=dev) / math.sqrt(inter)).to(torch.bfloat16)
        for T in Ts:
            # several routings in turn, so that timed calls read other experts
            # than the call before, as consecutive layers do
            sets = []
            for _ in range(8):
                x = torch.randn((T, h), generator=g, device=dev).to(torch.bfloat16)
                topi, topv = _moe_routing(rng, T, E, k, dev)
                ti = topi.cpu().numpy()
                groups = [(int(e), torch.as_tensor(np.nonzero(ti == e)[0], device=dev),
                           torch.as_tensor(np.flatnonzero(ti == e), device=dev))
                          for e in np.unique(ti)]
                sets.append((x, topi, topv, groups, len(groups)))
            x, topi, topv, groups, distinct = sets[0]
            ref = selected_expert_mlp_plain(x, topi, topv, wg, wu, wd)
            got = selected_expert_mlp_kernel(x, topi, topv, wg, wu, wd)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"moe_gemm {name} T={T}: non-finite output")
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            rel_range = err / float(ref.max() - ref.min())
            lib_err = float((moe_library(x, groups, topv, wg, wu, wd) - ref).abs().max())
            state = {"i": 0}

            def nxt():
                state["i"] += 1
                return sets[state["i"] % len(sets)]
            ms = time_ms(lambda: selected_expert_mlp_kernel(*nxt()[:3], wg, wu, wd), 20)
            plain = time_ms(lambda: selected_expert_mlp_plain(*nxt()[:3], wg, wu, wd), 2)

            def lib_call():
                xs, _, tv, grp, _ = nxt()
                return moe_library(xs, grp, tv, wg, wu, wd)
            lib = time_ms(lib_call, 5)
            # the distinct experts each routing reads, averaged over the timed sets
            n_dist = float(np.mean([s[4] for s in sets]))
            nb = n_dist * 3 * h * inter * 2 + T * h * 2 + T * k * 8 + T * h * 4
            bnd = bound_ms(nb, 6.0 * T * k * h * inter)
            log(f"moe_gemm {name} T={T} (h={h} i={inter} E={E} k={k}, {distinct} distinct experts "
                f"in the checked routing, {n_dist:.2f} on average): max_abs_err={err:.3e} "
                f"rel={rel:.2e}, {rel_range:.2e} of the range (library vs plain {lib_err:.3e}) "
                f"kernel_ms={ms:.4f} "
                f"plain_ms={plain:.4f} library_ms(torch.matmul per distinct expert)={lib:.4f} "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
            if not rel_range <= TOL_MOE:
                raise AssertionError(f"moe_gemm {name} T={T}: err {rel_range} of the range "
                                     f"> {TOL_MOE}")
            table.add("moe_gemm", err, ms, plain, bnd, lib,
                      f"{name} T={T} h={h} i={inter} E={E} k={k}, {n_dist:.2f} distinct experts",
                      main=(name == "Qwen3-30B-A3B" and T == 8))
            del sets, x, topi, topv, groups, ref, got
        del wg, wu, wd
        torch.cuda.empty_cache()


def _quant_attn_work(qpos, total, Hq, Hk, D, window, k_bits, v_bits):
    """As _attn_work, with each visible key costing its packed words and its
    two rows of bf16 scales."""
    B, S = qpos.shape
    nb, flops = _attn_work(qpos, total, Hq, Hk, D, window)
    keys = (nb - B * S * Hq * D * 8) // (Hk * D * 4)
    per_key = Hk * (D * (k_bits + v_bits) // 8 + 2 * (D // 32) * 2)
    return B * S * Hq * D * 8 + keys * per_key, flops


def check_attention_quant(table, dev):
    from exllamav3_tpu_torch.constants import PAGE_SIZE
    from exllamav3_tpu_torch.ops.flash_attention import (paged_attention_quant_kernel,
                                                          paged_attention_quant_plain)
    from exllamav3_tpu_torch.ops.kv_quant import (dequantize_kv_stored, merged_layout,
                                                   quantize_kv_stored)

    Hq, Hk, D = 32, 8, 128
    rng = np.random.default_rng(8)
    ctx = np.linspace(300, 2048, 8).astype(np.int32)
    decode = (ctx[:, None] - 1, ctx)
    prefill = ((512 + np.arange(2048, dtype=np.int32))[None], np.array([2560], np.int32))
    cases = []
    for bits in [(4, 4), (8, 8), (2, 2), (5, 3), (6, 6), (3, 7)]:
        for a in (0.0, 0.65):
            cases.append((f"decode B=8 ctx 300-2048 bits={bits} compand_a={a}", *decode, bits, a,
                          {}, a == 0.0 and bits in ((4, 4), (5, 3))))
    for bits in [(4, 4), (5, 3)]:
        cases.append((f"prefill S=2048 on 512 cached bits={bits}", *prefill, bits, 0.0, {}, False))
    cases.append(("decode + sliding window 512 bits=(4, 4)", *decode, (4, 4), 0.0,
                  {"sliding_window": 512}, False))
    cases.append(("decode + softcap 30 bits=(4, 4)", *decode, (4, 4), 0.0,
                  {"logit_softcap": 30.0}, False))
    cases.append(("decode + sinks bits=(5, 3)", *decode, (5, 3), 0.65, {"sinks": True}, False))
    for name, qpos, total, (kb, vb), a, kw, main in cases:
        B, S = qpos.shape
        mp = int(math.ceil(total.max() / PAGE_SIZE)) + 1
        P = B * mp + 1
        perm = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
        perm[:, -1] = 0  # the scratch column
        g = torch.Generator(device=dev).manual_seed(9)
        q = torch.randn((B, S, Hq, D), generator=g, device=dev)
        merged = merged_layout(kb, vb)
        state = {}
        for nm, bits in (("k", kb), ("v", vb)):
            x = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev)
            state[nm + "_q"], state[nm + "_s"] = quantize_kv_stored(x, bits, merged, a)
            del x
        bt = torch.as_tensor(perm, device=dev)
        qp = torch.as_tensor(qpos, device=dev)
        tl = torch.as_tensor(total, device=dev)
        args = dict(scale=D ** -0.5, sliding_window=kw.get("sliding_window", 0),
                    logit_softcap=kw.get("logit_softcap", 0.0),
                    sinks=(torch.randn(Hq, generator=g, device=dev) if kw.get("sinks") else None))
        ref = paged_attention_quant_plain(q, state, bt, qp, tl, kb, vb, a, **args)
        got = paged_attention_quant_kernel(q, state, bt, qp, tl, kb, vb, a, **args)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"paged_attention_quant {name}: non-finite output")
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        storage = "merged" if merged else "per_head"
        row = f"paged_attention_quant_{storage}"
        if not rel <= TOL_ATTN_Q:
            raise AssertionError(f"paged_attention_quant {name}: rel err {rel} > {TOL_ATTN_Q}")
        timed = main or name.startswith("prefill")
        if not timed:
            log(f"paged_attention_quant {name} ({storage} storage): max_abs_err={err:.3e} "
                f"rel={rel:.2e}")
            table.add(row, err, None, None, None, None, "", main=False)
            continue
        ms = time_ms(lambda: paged_attention_quant_kernel(q, state, bt, qp, tl, kb, vb, a,
                                                          **args), 10)
        plain = time_ms(lambda: paged_attention_quant_plain(q, state, bt, qp, tl, kb, vb, a,
                                                            **args), 2)
        # yardstick: SDPA over pre-gathered, pre-dequantized contiguous bf16 K/V
        T = mp * PAGE_SIZE
        kc, vc = (dequantize_kv_stored(state[nm + "_q"][bt.long()], state[nm + "_s"][bt.long()],
                                       bits, Hk, merged, torch.bfloat16, a)
                  .reshape(B, T, Hk, D).transpose(1, 2).contiguous()
                  for nm, bits in (("k", kb), ("v", vb)))
        kpos = torch.arange(T, device=dev)
        mask = (kpos[None, None, :] <= qp[:, :, None]) & (kpos[None, None, :] < tl[:, None, None])
        qt = q.to(torch.bfloat16).transpose(1, 2)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=mask[:, None], scale=D ** -0.5, enable_gqa=True), 10)
        bnd = bound_ms(*_quant_attn_work(qpos, total, Hq, Hk, D, args["sliding_window"], kb, vb))
        log(f"paged_attention_quant {name} ({storage} storage): max_abs_err={err:.3e} "
            f"rel={rel:.2e} kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms(sdpa on "
            f"dequantized bf16)={lib:.4f} bound_ms={bnd[0]:.4f} ({bnd[1]})")
        table.add(row, err, ms, plain, bnd, lib,
                  f"{name}: B={B} S={S} Hq={Hq} Hk={Hk} D={D}", main=main)
        del q, state, ref, got, kc, vc
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()


# -- phase: parity ----------------------------------------------------------------

def _compare(tag, a, b, rel_tol=2e-2):
    a, b = a.float().cpu(), b.float().cpu()
    err = float((a - b).abs().max())
    rel = err / float(b.abs().max())
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    pick = a.argmax(-1)
    agree = pick == b.argmax(-1)
    top1 = float(agree.float().mean())
    # rank of the GPU's choice among the CPU's logits (0 = the CPU's top-1)
    rank = (b > b.gather(-1, pick[:, None])).sum(-1)
    top2 = torch.topk(b, 2).values
    gaps = (top2[:, 0] - top2[:, 1])[~agree]
    finite = bool(torch.isfinite(a).all())
    log(f"parity {tag}: logits max_abs_err={err:.4e} rel={rel:.3e} top1_agree={top1:.4f} "
        f"over {len(agree)} positions, worst rank {int(rank.max())}"
        + (f", CPU top-2 gap where they differ {gaps.max():.4e}" if len(gaps) else ""))
    # bf16 roundings of the activations flip between the two sides, so a
    # near-tie can swap the top two: one position is held to the top 5, and
    # top-1 agreement is asked of 32 or more positions
    if not (finite and rel <= rel_tol and int(rank.max()) < 5 and (len(agree) < 32 or top1 >= 0.9)):
        raise AssertionError(f"parity {tag}: rel {rel}, top-1 agreement {top1}, "
                             f"worst rank {int(rank.max())}, finite {finite}")


def phase_parity():
    """GPU (kernels) against CPU (plain versions) on the 2-layer full-width
    checkpoint: the int8 path over a bf16 cache, then `fused` linears over
    the bf16 cache and over a (4, 4) quantized cache, the capacity path (fewer
    calls: its CPU side decodes every trellis anew in each forward), then the
    packed tiers int4 and int6 through their a8 kernels."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
    from exllamav3_tpu_torch.util.params import params_to

    d = _checkpoint(2)
    ids = np.random.default_rng(5).integers(0, LLAMA8B["vocab_size"], size=(1, 400))
    # the logits are held to 2% of their range over the bf16 cache
    for mode, spec_kw, simple, steps, rel_tol in (
            ("auto", {}, True, 4, 2e-2), ("fused", {}, False, 0, 2e-2),
            ("fused", dict(k_bits=4, v_bits=4), False, 1, TOL_QUANT_PATH),
            ("int4", {}, True, 2, TOL_A8_PATH), ("int6", {}, True, 2, TOL_A8_PATH)):
        cfg = Config.from_directory(d, infer_params=InferParams(linear_mode=mode))
        gpu = Model.from_config(cfg, device="cuda")
        gpu.load()
        cpu = Model.from_config(cfg, device="cpu")
        cpu.params = params_to(gpu.params, "cpu")
        tag = f"{cfg.infer_params.linear_mode} cache={spec_kw or 'bf16'}"
        log(f"parity: linear_mode={cfg.infer_params.linear_mode}, cache {spec_kw or 'bf16'}")
        if simple:
            got = gpu.forward_simple(ids[:, :96])
            _compare(f"{tag} forward_simple S=96", got, cpu.forward_simple(ids[:, :96]), rel_tol)
            if mode in ("int4", "int6"):
                before = _read_counts()
                with plain_packed_linears():
                    ref = gpu.forward_simple(ids[:, :96])
                if _read_counts() != before:
                    raise AssertionError(f"parity {tag}: the plain reference launched a kernel")
                _compare(f"{tag} forward_simple S=96, kernels against plain versions on the card",
                         got, ref)
        caches = [Cache(m, CacheSpec(num_pages=4, **spec_kw)) for m in (gpu, cpu)]
        bt = np.array([[1, 2, 0]], np.int32)
        S = 300
        outs = [m.forward(ids[:, :S], c, np.arange(S, dtype=np.int32)[None],
                          np.array([0], np.int32), bt) for m, c in zip((gpu, cpu), caches)]
        _compare(f"{tag} paged prefill S={S}", outs[0], outs[1], rel_tol)
        for step in range(steps):
            p = S + step
            outs = [m.forward(ids[:, p: p + 1], c, np.array([[p]], np.int32),
                              np.array([p], np.int32), bt) for m, c in zip((gpu, cpu), caches)]
            _compare(f"{tag} paged decode pos={p}", outs[0], outs[1], rel_tol)
        del gpu, cpu, caches
        gc.collect()
        torch.cuda.empty_cache()
    parity_moe()


@contextlib.contextmanager
def record_routing(forced: list | None = None):
    """Inside, every BlockSparseMLP.route call appends its (T, E) routing
    weights, on the host, to the yielded list. With `forced`, a list of such
    weights from an earlier run, each call then returns the next of them, on
    its own device, in place of its own."""
    from exllamav3_tpu_torch.modules.block_sparse_mlp import BlockSparseMLP

    weights, orig = [], BlockSparseMLP.route
    given = iter(forced or [])

    def route(self, logits, e_bias=None):
        w = orig(self, logits, e_bias)
        weights.append(w.cpu())
        return w if forced is None else next(given).to(w.device)
    BlockSparseMLP.route = route
    try:
        yield weights
    finally:
        BlockSparseMLP.route = orig


def parity_moe():
    """The MoE path on a 2-layer Qwen3-MoE checkpoint at Qwen3-30B-A3B width
    (int8 attention and head, bf16 expert stacks): forward_simple (grouped
    experts), a paged prefill (grouped) and decode steps (the selected-expert
    kernel on the GPU, its plain version on the CPU). The router's bf16
    logits can differ in a last bit between the devices and so pick another
    expert for a token, and the logits of such a token differ by far more
    than the compute does: so the CPU runs first, the GPU then takes the
    CPU's routing weights at every layer, and every position is held to the
    limit. The share of (token, layer) expert sets that the GPU's own router
    picks alike is printed, and held for 32 pairs or more."""
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
    from exllamav3_tpu_torch.util.params import params_to

    d = _moe_checkpoint(2)
    cfg = Config.from_directory(d, infer_params=InferParams(linear_mode="auto"))
    gpu = Model.from_config(cfg, device="cuda")
    gpu.load()
    cpu = Model.from_config(cfg, device="cpu")
    cpu.params = params_to(gpu.params, "cpu")
    V = QWEN3_30B["vocab_size"]
    ids = np.random.default_rng(14).integers(0, V, size=(1, 400))
    tag = f"Qwen3-MoE {cfg.infer_params.linear_mode}"
    log(f"parity: {tag}, 2 layers at Qwen3-30B-A3B width, bf16 cache, the GPU on the CPU's routing")

    def both(what, fn):
        """fn on the CPU, then on the GPU with the CPU's routing; the GPU's own
        expert sets compared with the CPU's, the logits held at every position"""
        with record_routing() as ref_w:
            ref = fn(cpu)
        with record_routing(forced=ref_w) as own_w:
            got = fn(gpu)
        alike = torch.stack([((a > 0) == (b > 0)).all(dim=-1) for a, b in zip(own_w, ref_w)])
        agree = float(alike.float().mean())
        n = alike.numel()
        log(f"parity {tag} {what}: the GPU's own expert sets agree with the CPU's for "
            f"{agree:.4f} of {n} (token, layer) pairs")
        if n >= 32 and agree < MIN_EXPERT_AGREEMENT:
            raise AssertionError(f"parity {tag} {what}: expert sets agree for only {agree:.4f}")
        _compare(f"{tag} {what}", got, ref, TOL_MOE_PATH)

    both("forward_simple S=96", lambda m: m.forward_simple(ids[:, :96]))
    caches = {m: Cache(m, CacheSpec(num_pages=4)) for m in (gpu, cpu)}
    bt = np.array([[1, 2, 0]], np.int32)
    S = 300
    both(f"paged prefill S={S}", lambda m: m.forward(ids[:, :S], caches[m],
                                                     np.arange(S, dtype=np.int32)[None],
                                                     np.array([0], np.int32), bt))
    before = _read_counts()["moe_gemm"]
    for p in range(S, S + 4):
        both(f"paged decode pos={p}", lambda m: m.forward(ids[:, p: p + 1], caches[m],
                                                          np.array([[p]], np.int32),
                                                          np.array([p], np.int32), bt))
    if _read_counts()["moe_gemm"] - before != 4 * 2:
        raise AssertionError(f"parity {tag}: the decode steps did not run the selected-expert "
                             "kernel once a layer")
    del gpu, cpu, caches
    gc.collect()
    torch.cuda.empty_cache()


# -- phase: serve ------------------------------------------------------------------

def profile_decode(gen, steps: int) -> list:
    """Trace `steps` decode iterations with torch.profiler and print the
    device's busy share of the window, kernels per step and the kernels that
    take the most device time. Returns the iterations' result events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    results = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            results += gen.iterate()
        torch.cuda.synchronize()
    events = prof.events()
    dev = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CUDA)
    if not dev:
        log("profile: the trace holds no device events; device busy share not measured")
        return results
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    by_name: dict = {}
    for s0, e0, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0)
        if cur_e is None or s0 > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = t1 - t0
    log(f"profile: {steps} decode steps (batch {len(gen.active)}), window {window / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms ({busy / window:.4f} of the window, idle "
        f"{1 - busy / window:.4f}), {len(dev) / steps:.1f} device ops per step")
    total = sum(by_name.values())
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:   {t / total:.4f} of device time  {t / steps / 1e3:.4f} ms/step  {name[:90]}")
    return results


def _wrappers() -> dict:
    """The kernels' wrappers by name; each counts its launches."""
    from exllamav3_tpu_torch.ops.exl3_gemm import exl3_gemm_kernel
    from exllamav3_tpu_torch.ops.flash_attention import (paged_attention_kernel,
                                                          paged_attention_quant_kernel)
    from exllamav3_tpu_torch.ops.fused_mlp import fused_mlp_int8_kernel
    from exllamav3_tpu_torch.ops.moe_gemm import selected_expert_mlp_kernel
    import exllamav3_tpu_torch.ops.q_matmul as qm

    return {"int8_matmul": qm.int8_matmul_kernel, "fused_mlp": fused_mlp_int8_kernel,
            "paged_attention": paged_attention_kernel, "exl3_gemm": exl3_gemm_kernel,
            "paged_attention_quant": paged_attention_quant_kernel,
            **{name: getattr(qm, name + "_kernel") for name in PACKED},
            "moe_gemm": selected_expert_mlp_kernel}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


@contextlib.contextmanager
def plain_ops():
    """Inside, the capacity path's two dispatches run their plain PyTorch
    versions on the card's tensors, so a forward computes the same function
    through no hand-written kernel."""
    import exllamav3_tpu_torch.modules.attn as attn_mod
    import exllamav3_tpu_torch.modules.linear as linear_mod
    from exllamav3_tpu_torch.ops.exl3_gemm import exl3_matmul_plain
    from exllamav3_tpu_torch.ops.flash_attention import paged_attention_quant_plain

    def attn_plain(q, layer_state, bt, qp, tl, k_bits=0, v_bits=0, compand_a=0.0, **kw):
        return paged_attention_quant_plain(q, layer_state, bt, qp, tl, k_bits, v_bits,
                                           compand_a, **kw)

    saved = linear_mod.exl3_matmul, attn_mod.paged_attention
    linear_mod.exl3_matmul, attn_mod.paged_attention = exl3_matmul_plain, attn_plain
    try:
        yield
    finally:
        linear_mod.exl3_matmul, attn_mod.paged_attention = saved


@contextlib.contextmanager
def plain_packed_linears():
    """Inside, the packed linears' dispatchers run their plain PyTorch
    versions on the card's tensors (the a8 or the bf16 product, as the
    variables say), so a forward goes through none of the four kernels."""
    import exllamav3_tpu_torch.modules.linear as linear_mod
    import exllamav3_tpu_torch.modules.multilinear as multi_mod
    import exllamav3_tpu_torch.ops.q_matmul as qm
    from exllamav3_tpu_torch.util.env import env_bool

    def int4_plain(x, packed, scales, bias=None):
        fn = qm.int4_matmul_a8_plain if env_bool("EXL3TPU_INT4_A8", True) else qm.int4_matmul_plain
        return qm._over_rows(x, packed.shape[1], bias, lambda x2: fn(x2, packed, scales))

    def intb_plain(x, packed, scales, bits=None, bias=None):
        bits = bits or qm.intb_bits_from_shapes(packed.shape[0], scales.shape[0])
        fn = qm.intb_matmul_a8_plain if env_bool("EXL3TPU_INTB_A8", True) else qm.intb_matmul_plain
        return qm._over_rows(x, packed.shape[1], bias, lambda x2: fn(x2, packed, scales, bits))

    saved = [(mod, mod.int4_matmul, mod.intb_matmul) for mod in (linear_mod, multi_mod)]
    for mod in (linear_mod, multi_mod):
        mod.int4_matmul, mod.intb_matmul = int4_plain, intb_plain
    try:
        yield
    finally:
        for mod, f4, fb in saved:
            mod.int4_matmul, mod.intb_matmul = f4, fb


def _shift(a, b) -> tuple[float, float]:
    """max |a - b| over the range of b: at the last position, over all."""
    rng = float(b.max() - b.min())
    return float((a[-1] - b[-1]).abs().max()) / rng, float((a - b).abs().max()) / rng


def _checkpoint(layers: int) -> str:
    from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3

    d = os.path.join(WORK, f"llama8b_{layers}layers")
    t0 = time.time()
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_llama_exl3(d, tiny_llama_cfg(num_layers=layers, **LLAMA8B), K=4,
                              seed=1 if layers == 2 else 0)
    log(f"checkpoint: {layers} layers at 8B width ready in {time.time() - t0:.1f} s ({d})")
    return d


def _serve_prompts(V: int = LLAMA8B["vocab_size"]):
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, V, 512)
    # the longest request arrives first, so its prefill registers the shared pages
    lengths = np.linspace(1536, 512, 8).astype(int)
    return [np.concatenate([prefix, rng.integers(0, V, n - 512)]) for n in lengths]


def _serve(tag: str, ckpt: str, linear_mode: str, spec_kw: dict, expect_mode: str,
           prompts: list, trace: bool = True) -> dict:
    """Load the checkpoint `ckpt` in `linear_mode`, serve `prompts` (128
    greedy tokens each; the first arrives alone, the rest once it decodes)
    over a paged cache made with `spec_kw`, and check the outcome. Returns
    the kernels' launch counts over the measured run."""
    from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
    from exllamav3_tpu_torch.model.model import estimate_linear_mode_bytes

    cfg = Config.from_directory(ckpt, infer_params=InferParams(linear_mode=linear_mode))
    V = cfg.vocab_size
    model = Model.from_config(cfg, device="cuda")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model.load()
    torch.cuda.synchronize()
    log(f"{tag}: {cfg.num_hidden_layers} layers, linear_mode resolved to "
        f"{cfg.infer_params.linear_mode}, load {time.time() - t0:.1f} s, weights' device memory "
        f"{(torch.cuda.memory_allocated() - base) / 2**30:.2f} GiB, peak during load "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if expect_mode in ("int8", "int6", "int4", "fused"):
        log(f"{tag}: the ladder's estimate for {expect_mode}: "
            f"{estimate_linear_mode_bytes(cfg, expect_mode) / 2**30:.2f} GiB")
    if cfg.infer_params.linear_mode != expect_mode:
        raise AssertionError(f"{tag}: linear mode did not resolve to {expect_mode}")

    base = torch.cuda.memory_allocated()
    cache = Cache(model, CacheSpec(num_pages=72, **spec_kw))
    log(f"{tag}: cache {spec_kw or 'bf16'}: "
        f"{(torch.cuda.memory_allocated() - base) / (72 * 256):.0f} bytes per token")
    gen = Generator(model, cache, max_batch_size=8, max_chunk_size=2048, seed=0)
    jobs = [Job(p, max_new_tokens=128, sampler=GreedySampler()) for p in prompts]

    _reset_counts()
    finished = {}
    decode_tokens, decode_s = 0, 0.0
    torch.cuda.synchronize()
    t_start = time.time()
    gen.enqueue(jobs[0])  # the first request arrives alone; the rest find its prefix cached
    while gen.num_remaining_jobs():
        if (len(jobs) > 1 and jobs[0].status == "running" and jobs[1].status == "queued"
                and jobs[1] not in gen.pending):
            gen.enqueue(jobs[1:])
        ti = time.time()
        prefilling = any(j.status == "prefill" for j in gen.active) or bool(gen.pending)
        res = gen.iterate()
        n_tok = sum(1 for r in res if r["stage"] == "streaming")
        if not prefilling:
            decode_tokens += n_tok
            decode_s += time.time() - ti
        for r in res:
            if r["stage"] == "finished":
                finished[r["identifier"]] = r
    torch.cuda.synchronize()
    wall = time.time() - t_start
    counts = _read_counts()

    total_new = 0
    for j in jobs:
        r = finished.get(j.identifier)
        if r is None or len(r["new_tokens"]) != 128 or r["eos_reason"] != "max_new_tokens":
            raise AssertionError(f"{tag}: request {j.identifier} did not finish with 128 tokens")
        if not all(0 <= t < V for t in r["new_tokens"]):
            raise AssertionError(f"{tag}: token id out of range")
        total_new += len(r["new_tokens"])
        log(f"{tag}: request prompt={r['prompt_tokens']} cached_tokens={r['cached_tokens']} "
            f"ttft_s={r['ttft_s']:.4f} prefill_s={r['prefill_s']:.4f} "
            f"generate_tok_s={r['generate_tok_s']:.2f}")
    reused = sum(finished[j.identifier]["cached_tokens"] for j in jobs)
    # cross-path check: the first generated token of request 0 lies in the
    # top 5 of a reference forward at the end of its prompt. Over the bf16
    # cache that is the cacheless forward (dense attention, no cache). A
    # quantized cache computes another function, so there the reference is
    # the whole prompt as one chunk through a fresh cache of the same widths
    # with every linear and the attention in their plain PyTorch versions:
    # no generator, no prefix reuse, and no kernel of the served path. The
    # distance of that reference from the cacheless forward (what the cache's
    # widths do to the logits) and the kernels' distance from it are printed
    first = finished[jobs[0].identifier]["new_tokens"][0]
    if spec_kw:
        n = len(prompts[0])
        pages = -(-n // 256)
        one_chunk = (np.arange(n, dtype=np.int32)[None], np.array([0], np.int32),
                     np.array([list(range(1, pages + 1)) + [0]], np.int32))
        spec = CacheSpec(num_pages=pages + 1, **spec_kw)
        kern = model.forward(prompts[0][None], Cache(model, spec), *one_chunk)[0]
        before = _read_counts()
        with plain_ops():
            ref_all = model.forward(prompts[0][None], Cache(model, spec), *one_chunk)[0]
            simple = model.forward_simple(prompts[0][None])[0]
        if _read_counts() != before:
            raise AssertionError(f"{tag}: the plain reference launched a kernel")
        rank_simple = int((simple[-1] > simple[-1, first]).sum())
        q_last, q_all = _shift(ref_all, simple)
        k_last, k_all = _shift(kern, ref_all)
        agree = float((kern.argmax(-1) == ref_all.argmax(-1)).float().mean())
        log(f"{tag}: plain reference over the {spec_kw} cache against the plain cacheless "
            f"forward, {n} positions: logits differ by {q_last:.4f} of their range at the last "
            f"position and {q_all:.4f} at the worst; request 0's first token has rank "
            f"{rank_simple} in the cacheless forward (not required)")
        log(f"{tag}: kernels against the plain reference, same cache widths: {k_last:.4f} of "
            f"the range at the last position, {k_all:.4f} at the worst, top-1 agreement "
            f"{agree:.4f}")
        ref = ref_all[-1]
        if not (torch.isfinite(kern).all() and k_last <= TOL_QUANT_PATH):
            raise AssertionError(f"{tag}: the kernels' logits at the last position are "
                                 f"{k_last} of the range from the plain reference")
        del kern, ref_all, simple
    else:
        ref = model.forward_simple(prompts[0][None])[0, -1]
    top5 = set(torch.topk(ref, 5).indices.tolist())
    log(f"{tag}: {len(finished)} requests finished, {total_new} tokens in {wall:.3f} s "
        f"({total_new / wall:.2f} tok/s overall), decode-only iterations "
        f"{decode_tokens} tokens in {decode_s:.3f} s "
        f"({decode_tokens / max(decode_s, 1e-9):.2f} tok/s), prefix tokens reused {reused}, "
        f"first token of request 0 in the reference's top-5: {first in top5}")
    log(f"{tag}: kernel launches {json.dumps(counts)}")

    # launches of one batch-1 decode step (a 512-token context, fresh cache)
    c1 = Cache(model, CacheSpec(num_pages=4, **spec_kw))
    model.forward(prompts[-1][None, :511], c1, np.arange(511, dtype=np.int32)[None],
                  np.array([0], np.int32), np.array([[1, 2, 0]], np.int32))
    _reset_counts()
    model.forward(prompts[-1][None, 511:512], c1, np.array([[511]], np.int32),
                  np.array([511], np.int32), np.array([[1, 2, 0]], np.int32))
    log(f"{tag}: launches per batch-1 decode step " + json.dumps(_read_counts()))
    del c1
    if trace:
        # a traced window of decode steps over the same prompts (prefixes
        # now cached), after and apart from the measured run
        gen.enqueue([Job(p, max_new_tokens=16, sampler=GreedySampler()) for p in prompts])
        while gen.pending or any(j.status == "prefill" for j in gen.active):
            gen.iterate()
        profile_decode(gen, 4)
        while gen.num_remaining_jobs():
            gen.iterate()
    if first not in top5:
        raise AssertionError(f"{tag}: generator's first token disagrees with the reference forward")
    if len(jobs) > 1 and reused <= 0:
        raise AssertionError(f"{tag}: no prefix pages were reused")
    del model, cache, gen
    gc.collect()  # a model's modules refer to each other: free its tensors now
    torch.cuda.empty_cache()
    return counts


def _require_launches(tag: str, counts: dict, used: tuple, unused: tuple):
    if min(counts[n] for n in used) <= 0:
        raise AssertionError(f"{tag}: a kernel of this path never launched: {counts}")
    if any(counts[n] for n in unused):
        raise AssertionError(f"{tag}: a kernel of another path launched: {counts}")


def phase_serve() -> dict:
    """The int8 path: linear_mode="auto" on an 80 GB card, bf16 cache."""
    counts = _serve("serve", _checkpoint(32), "auto", {}, "int8", _serve_prompts())
    used = ("int8_matmul", "fused_mlp", "paged_attention")
    _require_launches("serve", counts, used,
                      ("exl3_gemm", "paged_attention_quant", "moe_gemm", *PACKED))
    return {n: counts[n] for n in used}


def phase_serve_capacity() -> dict:
    """The capacity path: trellis linears and a quantized cache. 32 layers
    with a (4, 4) cache (merged storage), then one request on 4 layers with a
    (5, 3) cache so that the per-head storage runs on a served path too. The
    cache's widths fix its storage, so each run's count of the quantized
    attention kernel belongs to that storage's row of the table."""
    from exllamav3_tpu_torch.ops.kv_quant import merged_layout

    used = ("exl3_gemm", "paged_attention_quant")
    unused = ("int8_matmul", "fused_mlp", "paged_attention", "moe_gemm", *PACKED)
    counts = _serve("serve_capacity", _checkpoint(32), "fused", dict(k_bits=4, v_bits=4), "fused",
                    _serve_prompts())
    _require_launches("serve_capacity", counts, used, unused)
    odd = _serve("serve_capacity (5, 3)", _checkpoint(4), "fused", dict(k_bits=5, v_bits=3),
                 "fused", _serve_prompts()[:1], trace=False)
    _require_launches("serve_capacity (5, 3)", odd, used, unused)
    if not merged_layout(4, 4) or merged_layout(5, 3):
        raise AssertionError("serve_capacity: the two runs did not use the two storages")
    return {"exl3_gemm": counts["exl3_gemm"],
            "paged_attention_quant_merged": counts["paged_attention_quant"],
            "paged_attention_quant_per_head": odd["paged_attention_quant"]}


@contextlib.contextmanager
def environ(**values):
    """Set environment variables inside, restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_serve_packed() -> dict:
    """The packed-integer tiers. 32 layers in int4 through the a8 kernel over
    the bf16 cache; one request on 4 layers for each of the other three packed
    kernels; then linear_mode="auto" on every rung of the ladder."""
    import exllamav3_tpu_torch.model.model as pmodel
    from exllamav3_tpu_torch.model import Config, InferParams, Model

    others = ("int8_matmul", "fused_mlp", "exl3_gemm", "paged_attention_quant", "moe_gemm")
    launches = {}
    runs = [("serve_packed int4", 32, "int4", "int4_matmul_a8", {}, _serve_prompts(), True),
            ("serve_packed int6", 4, "int6", "intb_matmul_a8", {}, _serve_prompts()[:1], False),
            ("serve_packed int4 EXL3TPU_INT4_A8=0", 4, "int4", "int4_matmul",
             {"EXL3TPU_INT4_A8": "0"}, _serve_prompts()[:1], False),
            ("serve_packed int6 EXL3TPU_INTB_A8=0", 4, "int6", "intb_matmul",
             {"EXL3TPU_INTB_A8": "0"}, _serve_prompts()[:1], False)]
    for tag, layers, mode, kernel, env, prompts, trace in runs:
        with environ(**env):
            counts = _serve(tag, _checkpoint(layers), mode, {}, mode, prompts, trace=trace)
        _require_launches(tag, counts, (kernel, "paged_attention"),
                          others + tuple(n for n in PACKED if n != kernel))
        launches[kernel] = counts[kernel]

    # the ladder: a device just large enough for each rung, and one too small
    # for int4, which takes `fused`
    d = _checkpoint(2)
    cfg = Config.from_directory(d)
    need = {m: pmodel.estimate_linear_mode_bytes(cfg, m) for m in ("int8", "int6", "int4", "fused")}
    real_hbm = pmodel.device_hbm_bytes
    ids = np.random.default_rng(12).integers(0, LLAMA8B["vocab_size"], size=(1, 8))
    for rung in ("int8", "int6", "int4", "fused"):
        hbm = math.ceil(need[rung] / 0.8) + 1 if rung != "fused" else int(need["int4"] / 0.8) - 1
        picked = pmodel.select_linear_mode(cfg, hbm)
        auto = Config.from_directory(d, infer_params=InferParams(linear_mode="auto"))
        model = Model.from_config(auto, device="cuda")
        base = torch.cuda.memory_allocated()
        pmodel.device_hbm_bytes = lambda device, hbm=hbm: hbm
        try:
            model.load()
        finally:
            pmodel.device_hbm_bytes = real_hbm
        logits = model.forward_simple(ids)
        torch.cuda.synchronize()
        log(f"serve_packed ladder: device memory {hbm} bytes -> select_linear_mode {picked}, "
            f"auto loaded as {auto.infer_params.linear_mode}; estimate "
            f"{need[rung] / 2**30:.3f} GiB, measured "
            f"{(torch.cuda.memory_allocated() - base) / 2**30:.3f} GiB on 2 layers")
        if not (picked == rung and auto.infer_params.linear_mode == rung
                and torch.isfinite(logits).all()):
            raise AssertionError(f"serve_packed ladder: rung {rung} resolved to {picked} / "
                                 f"{auto.infer_params.linear_mode}")
        del model, logits
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def _moe_checkpoint(layers: int) -> str:
    """A synthetic Qwen3-MoE EXL3 checkpoint at Qwen3-30B-A3B width, K=4,
    one shard a layer, written once per machine."""
    from exllamav3_tpu_torch.conversion.synth import tiny_moe_cfg, write_tiny_moe_exl3

    d = os.path.join(WORK, f"qwen3_30b_a3b_{layers}layers")
    t0 = time.time()
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_moe_exl3(d, tiny_moe_cfg(num_layers=layers, **QWEN3_30B), K=4,
                            seed=3 if layers == 2 else 2)
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"checkpoint: {layers} layers at Qwen3-30B-A3B width ready in {time.time() - t0:.1f} s, "
        f"{size / 2**30:.2f} GiB on disk ({d})")
    return d


def phase_serve_moe() -> dict:
    """The MoE path: Qwen3-MoE at Qwen3-30B-A3B width, linear_mode="auto"
    (int8 attention and head, bf16 expert stacks), bf16 cache."""
    used = ("int8_matmul", "paged_attention", "moe_gemm")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve_moe: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated before the load")
    counts = _serve("serve_moe", _moe_checkpoint(48), "auto", {}, "int8",
                    _serve_prompts(QWEN3_30B["vocab_size"]))
    _require_launches("serve_moe", counts, used,
                      ("fused_mlp", "exl3_gemm", "paged_attention_quant", *PACKED))
    return {n: counts[n] for n in used}


CHECKS = {"int8_matmul": check_int8, "fused_mlp": check_fused_mlp,
          "paged_attention": check_attention, "exl3_gemm": check_exl3_gemm,
          "paged_attention_quant": check_attention_quant,
          **{name: (lambda table, dev, name=name: check_packed(table, dev, name))
             for name in PACKED},
          "moe_gemm": check_moe_gemm}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="build,kernels,parity,serve,serve_capacity,serve_packed,serve_moe",
                    help="`kernels` runs every kernel check; a check's name runs that one")
    args = ap.parse_args()
    phases = args.phases.split(",")
    known = {"build", "kernels", "parity", "serve", "serve_capacity", "serve_packed", "serve_moe",
             *CHECKS}
    if set(phases) - known:
        ap.error(f"unknown phases {sorted(set(phases) - known)}")

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        sys.exit(1)
    import exllamav3_tpu_torch.ops.build as kbuild  # fails outside a checkout of the repo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    os.makedirs(WORK, exist_ok=True)
    t_all = time.time()

    t0 = time.time()
    kbuild.library()
    log(f"build: {kbuild.BUILD_LOG.get('seconds', 0.0):.1f} s (cached={kbuild.BUILD_LOG.get('cached')})")
    for name in kbuild.SOURCES:
        for line in (kbuild.BUILD_LOG.get(name) or "").splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  {name}: {line.strip()}")
    log(f"phase build: {time.time() - t0:.1f} s")

    table = KernelTable()
    checks = [name for name in CHECKS if "kernels" in phases or name in phases]
    if checks:
        t0 = time.time()
        for name in checks:
            CHECKS[name](table, dev)
        log(f"phase kernels ({', '.join(checks)}): {time.time() - t0:.1f} s")
    if "parity" in phases:
        t0 = time.time()
        phase_parity()
        log(f"phase parity: {time.time() - t0:.1f} s")
    if "serve" in phases:
        t0 = time.time()
        table.set_launches(phase_serve())
        log(f"phase serve: {time.time() - t0:.1f} s")
    if "serve_capacity" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_capacity())
        log(f"phase serve_capacity: {time.time() - t0:.1f} s")
    if "serve_packed" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_packed())
        log(f"phase serve_packed: {time.time() - t0:.1f} s")
    if "serve_moe" in phases:
        t0 = time.time()
        table.set_launches(phase_serve_moe())
        log(f"phase serve_moe: {time.time() - t0:.1f} s")
    log(f"total: {time.time() - t_all:.1f} s")
    log(smi)  # once more, so that the end of a cut log still names the card
    print(json.dumps({"kernels": list(table.rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
