"""Smoke run of the PyTorch/CUDA port (exllamav3_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases build,kernels

Phases:
  build     build the CUDA kernels from exllamav3_tpu_torch/csrc/ (timed)
  kernels   each kernel against its plain PyTorch version at the shapes of
            the Llama-3.1-8B main path: errors, kernel / plain / library
            times and the bound (bytes over 3.35 TB/s or operations over
            989 TFLOP/s, whichever is larger)
  parity    a 2-layer checkpoint at full 8B width: forward_simple and paged
            prefill + decode steps on the GPU (kernels) against the CPU
            (plain versions) over the same ids and weights
  serve     a 32-layer synthetic checkpoint at Llama-3.1-8B geometry loaded
            with linear_mode="auto" and served by the continuous-batching
            generator: 8 greedy requests, 512-1536 token prompts sharing a
            512-token prefix, 128 new tokens each; the kernels' launch counts
            over this run must all be above 0

The second-to-last line is the kernel table as JSON and the last line is
{"ok": true, "device": {...}}. Any failed phase raises and exits non-zero
without that line. Needs CUDA; writes its checkpoints under build/chip_smoke/.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12    # dense bf16 tensor-core rate
L2_BYTES = 50 << 20
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

LLAMA8B = dict(vocab_size=32768, hidden_size=4096, intermediate_size=14336,
               num_q_heads=32, num_kv_heads=8, head_dim=128)

# tolerances, each relative to the largest magnitude of the plain result
TOL_INT8 = 1e-4   # both sides: exact bf16 products, f32 sums in another order
TOL_MLP = 2e-3    # f32 order can flip a bf16 rounding of the activation
TOL_ATTN = 2e-4   # q and P enter the MMAs as hi + lo bf16 pairs (~2^-16 relative)

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "int8_matmul": ("exllamav3_tpu_torch/csrc/int8_matmul.cu", "exllamav3_tpu/ops/q_matmul.py:44"),
    "fused_mlp": ("exllamav3_tpu_torch/csrc/fused_mlp.cu", "exllamav3_tpu/ops/fused_mlp.py:47"),
    "paged_attention": ("exllamav3_tpu_torch/csrc/paged_attention.cu",
                        "exllamav3_tpu/ops/flash_attention.py:253"),
}


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def time_ms(fn, calls: int) -> float:
    """Mean device time of fn() over `calls` launches (CUDA events)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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

    def add(self, name, err, ms, plain_ms, bnd, library_ms, shape, main):
        row = self.row(name)
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
        if main:
            row.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                       library_ms=library_ms, shape=shape)

    def set_launches(self, counts):
        for name, n in counts.items():
            self.row(name)["launches"] = n


# -- phase: kernels -------------------------------------------------------------

def check_int8(table, dev):
    from exllamav3_tpu_torch.ops.q_matmul import int8_matmul_kernel, int8_matmul_plain

    shapes = [(4096, 6144, "qkv"), (4096, 4096, "o_proj"), (4096, 28672, "gate_up"),
              (14336, 4096, "down"), (4096, 32768, "lm_head")]
    g = torch.Generator(device=dev).manual_seed(1)
    for m in (1, 8, 2048):
        for k, n, what in shapes:
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

    Hq, Hk, D = 32, 8, 128
    rng = np.random.default_rng(3)
    cases = []
    ctx = np.linspace(300, 2048, 8).astype(np.int32)
    cases.append(("decode B=8 ctx 300-2048", ctx[:, None] - 1, ctx, {}, True))
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


# -- phase: parity ----------------------------------------------------------------

def _compare(tag, a, b):
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
    if not (finite and rel <= 2e-2 and int(rank.max()) < 5 and (len(agree) < 32 or top1 >= 0.9)):
        raise AssertionError(f"parity {tag}: rel {rel}, top-1 agreement {top1}, "
                             f"worst rank {int(rank.max())}, finite {finite}")


def phase_parity():
    from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
    from exllamav3_tpu_torch.util.params import params_to

    d = os.path.join(WORK, "llama8b_2layers")
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_llama_exl3(d, tiny_llama_cfg(num_layers=2, **LLAMA8B), K=4, seed=1)
    cfg = Config.from_directory(d, infer_params=InferParams(linear_mode="auto"))
    gpu = Model.from_config(cfg, device="cuda")
    gpu.load()
    cpu = Model.from_config(cfg, device="cpu")
    cpu.params = params_to(gpu.params, "cpu")
    log(f"parity: linear_mode={cfg.infer_params.linear_mode}")

    ids = np.random.default_rng(5).integers(0, LLAMA8B["vocab_size"], size=(1, 400))
    _compare("forward_simple S=96", gpu.forward_simple(ids[:, :96]), cpu.forward_simple(ids[:, :96]))
    caches = [Cache(m, CacheSpec(num_pages=4)) for m in (gpu, cpu)]
    bt = np.array([[1, 2, 0]], np.int32)
    S = 300
    outs = [m.forward(ids[:, :S], c, np.arange(S, dtype=np.int32)[None], np.array([0], np.int32), bt)
            for m, c in zip((gpu, cpu), caches)]
    _compare(f"paged prefill S={S}", outs[0], outs[1])
    for step in range(4):
        p = S + step
        outs = [m.forward(ids[:, p: p + 1], c, np.array([[p]], np.int32), np.array([p], np.int32), bt)
                for m, c in zip((gpu, cpu), caches)]
        _compare(f"paged decode pos={p}", outs[0], outs[1])
    del gpu, cpu, caches
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


def phase_serve():
    from exllamav3_tpu_torch.conversion.synth import tiny_llama_cfg, write_tiny_llama_exl3
    from exllamav3_tpu_torch.generator import Generator, GreedySampler, Job
    from exllamav3_tpu_torch.model import Cache, CacheSpec, Config, InferParams, Model
    from exllamav3_tpu_torch.ops.flash_attention import paged_attention_kernel
    from exllamav3_tpu_torch.ops.fused_mlp import fused_mlp_int8_kernel
    from exllamav3_tpu_torch.ops.q_matmul import int8_matmul_kernel

    d = os.path.join(WORK, "llama8b_32layers")
    t0 = time.time()
    if not os.path.exists(os.path.join(d, "config.json")):
        write_tiny_llama_exl3(d, tiny_llama_cfg(num_layers=32, **LLAMA8B), K=4, seed=0)
    log(f"serve: checkpoint ready in {time.time() - t0:.1f} s ({d})")
    cfg = Config.from_directory(d, infer_params=InferParams(linear_mode="auto"))
    model = Model.from_config(cfg, device="cuda")
    t0 = time.time()
    model.load()
    torch.cuda.synchronize()
    log(f"serve: linear_mode resolved to {cfg.infer_params.linear_mode}, load {time.time() - t0:.1f} s, "
        f"device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if cfg.infer_params.linear_mode != "int8":
        raise AssertionError("serve: auto mode did not resolve to int8")

    cache = Cache(model, CacheSpec(num_pages=72))
    gen = Generator(model, cache, max_batch_size=8, max_chunk_size=2048, seed=0)
    rng = np.random.default_rng(6)
    V = LLAMA8B["vocab_size"]
    prefix = rng.integers(0, V, 512)
    # the longest request arrives first, so its prefill registers the shared pages
    lengths = np.linspace(1536, 512, 8).astype(int)
    prompts = [np.concatenate([prefix, rng.integers(0, V, n - 512)]) for n in lengths]
    jobs = [Job(p, max_new_tokens=128, sampler=GreedySampler()) for p in prompts]

    for fn in (int8_matmul_kernel, fused_mlp_int8_kernel, paged_attention_kernel):
        fn.launches = 0
    finished = {}
    decode_tokens, decode_s = 0, 0.0
    torch.cuda.synchronize()
    t_start = time.time()
    gen.enqueue(jobs[0])  # the first request arrives alone; the rest find its prefix cached
    while gen.num_remaining_jobs():
        if jobs[0].status == "running" and jobs[1].status == "queued" and jobs[1] not in gen.pending:
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
    counts = {"int8_matmul": int8_matmul_kernel.launches,
              "fused_mlp": fused_mlp_int8_kernel.launches,
              "paged_attention": paged_attention_kernel.launches}

    total_new = 0
    for j in jobs:
        r = finished.get(j.identifier)
        if r is None or len(r["new_tokens"]) != 128 or r["eos_reason"] != "max_new_tokens":
            raise AssertionError(f"serve: request {j.identifier} did not finish with 128 tokens")
        if not all(0 <= t < V for t in r["new_tokens"]):
            raise AssertionError("serve: token id out of range")
        total_new += len(r["new_tokens"])
        log(f"serve: request prompt={r['prompt_tokens']} cached_tokens={r['cached_tokens']} "
            f"ttft_s={r['ttft_s']:.4f} prefill_s={r['prefill_s']:.4f} "
            f"generate_tok_s={r['generate_tok_s']:.2f}")
    reused = sum(finished[j.identifier]["cached_tokens"] for j in jobs)
    # cross-path check: the first generated token of request 0 lies in the
    # top 5 of the cacheless forward (dense attention, no cache) at the end of its prompt
    ref = model.forward_simple(prompts[0][None])[0, -1]
    top5 = set(torch.topk(ref, 5).indices.tolist())
    first = finished[jobs[0].identifier]["new_tokens"][0]
    log(f"serve: {len(finished)} requests finished, {total_new} tokens in {wall:.3f} s "
        f"({total_new / wall:.2f} tok/s overall), decode-only iterations "
        f"{decode_tokens} tokens in {decode_s:.3f} s "
        f"({decode_tokens / max(decode_s, 1e-9):.2f} tok/s), prefix tokens reused {reused}, "
        f"first token of request 0 in forward_simple top-5: {first in top5}")
    log(f"serve: kernel launches {json.dumps(counts)}")

    # launches of one batch-1 decode step (a 512-token context, fresh cache)
    c1 = Cache(model, CacheSpec(num_pages=4))
    model.forward(prompts[-1][None, :511], c1, np.arange(511, dtype=np.int32)[None],
                  np.array([0], np.int32), np.array([[1, 2, 0]], np.int32))
    kernels = (int8_matmul_kernel, fused_mlp_int8_kernel, paged_attention_kernel)
    for fn in kernels:
        fn.launches = 0
    model.forward(prompts[-1][None, 511:512], c1, np.array([[511]], np.int32),
                  np.array([511], np.int32), np.array([[1, 2, 0]], np.int32))
    log("serve: launches per batch-1 decode step "
        + json.dumps({fn.__name__: fn.launches for fn in kernels}))
    del c1
    # a traced window of batch-8 decode steps over the same prompts
    # (prefixes now cached), after and apart from the measured run
    gen.enqueue([Job(p, max_new_tokens=16, sampler=GreedySampler()) for p in prompts])
    while gen.pending or any(j.status == "prefill" for j in gen.active):
        gen.iterate()
    profile_decode(gen, 4)
    while gen.num_remaining_jobs():
        gen.iterate()
    if first not in top5:
        raise AssertionError("serve: generator's first token disagrees with forward_simple")
    if reused <= 0:
        raise AssertionError("serve: no prefix pages were reused")
    if min(counts.values()) <= 0:
        raise AssertionError(f"serve: a kernel of the main path never launched: {counts}")
    del model, cache, gen
    torch.cuda.empty_cache()
    return counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,kernels,parity,serve")
    args = ap.parse_args()
    phases = args.phases.split(",")

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        sys.exit(1)
    import exllamav3_tpu_torch.ops.build as kbuild  # fails outside a checkout of the repo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    dev = torch.device("cuda")
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
    if "kernels" in phases:
        t0 = time.time()
        check_int8(table, dev)
        check_fused_mlp(table, dev)
        check_attention(table, dev)
        log(f"phase kernels: {time.time() - t0:.1f} s")
    if "parity" in phases:
        t0 = time.time()
        phase_parity()
        log(f"phase parity: {time.time() - t0:.1f} s")
    if "serve" in phases:
        t0 = time.time()
        table.set_launches(phase_serve())
        log(f"phase serve: {time.time() - t0:.1f} s")
    log(f"total: {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": list(table.rows.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
