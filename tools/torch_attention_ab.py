"""Compare two source trees of the PyTorch port, in turns, on one card, by one
of twenty-three runs (`--run`):

- `paged_bf16` (the default): the bf16 paged attention kernel (row 3) at
  decode, batch 8, q positions 299-2047 (contexts 300 to 2048), 32 q / 8 kv
  heads of 128, the shape `chip_smoke.py` reports for the kernel;
- `paged_quant`: the quantized paged attention kernel (rows 5 and 7) at the
  same shape over a (4, 4) cache in merged storage, the call the capacity
  path makes 32 times a decode step;
- `serve_capacity`: `chip_smoke.py --phases build,serve_capacity` in the
  tree (`fused` linears over a (4, 4) paged cache): decode-only tok/s, the
  traced window's ms a step (`step_ms`, the host's clock under the
  profiler), device busy ms a traced step, the window's idle share and
  device operations a step, as that phase prints them, and busy ms and
  device operations a token (`busy_ms_token`, `ops_token`: a traced
  iteration yields a burst of up to 8 tokens a job where the tree's
  generator bursts, 1 where it does not);
- `serve`: `chip_smoke.py --phases build,serve`, the int8 main path over the
  bf16 paged cache (row 3 32 times a decode step), read as `serve_capacity`;
- `ring`: the ring decode kernel (row 8) at Gemma-3-27B decode, batch 8, q
  positions 300-2048, window 1024 in rings of W = 1048 slots (9 rows, a
  permuted slot table, stale speculative slots), 32 q / 16 kv heads of 128,
  the shape `chip_smoke.py` reports for the kernel; the rings rotate past L2;
- `exl3_gemm`: the trellis GEMM (row 9) at m = 8, q/o (4096 x 4096), K = 4,
  3INST, over inputs rotated past L2;
- `serve_gemma`: `chip_smoke.py --phases build,serve_gemma` (the Gemma-3-27B
  serve over SWA rings, at the tree's GEMMA_SERVE_LAYERS), read as
  `serve_capacity`;
- `intb`: the int-B matmuls, row 13 (bf16) and row 14 (a8), at qkv (4096 x
  6144), B = 6, m = 8, 128 and 2048, over inputs rotated past L2, one after
  the other in each run;
- `serve_packed_int6`: `chip_smoke.py --phases build,serve_packed_int6`
  (the int6 tier on 4 layers of the 8B-width checkpoint, all 8 requests,
  traced), read as `serve_capacity`;
- `int4`: the int4 matmuls, row 11 (bf16) and row 12 (a8), at qkv (4096 x
  6144), m = 8, 128 and 2048, over inputs rotated past L2, one after the
  other in each run;
- `latent`: the latent (MLA) attention, row 6a, at decode (DeepSeek-V2-Lite:
  batch 8, 16 heads, contexts 300-2048 over a paged cache with a shuffled
  block table, chip_smoke.py's main latent shape), over a bf16 and a (4)-bit
  latent cache, each rotated past L2, through the wrappers a model calls;
- `serve_mla`: `chip_smoke.py --phases build,serve_mla` (the 27-layer
  DeepSeek-V2-Lite serve over a bf16 latent cache, then one (4)-bit
  request), read as `serve_capacity`;
- `serve_packed`: `chip_smoke.py --phases build,serve_packed` (the 32-layer
  int4 a8 serve, then the other packed tiers on 4 layers and the ladder),
  its traced int4 run read as `serve_capacity` (with EXL3TPU_INT4_A8=0 in the
  environment and --smoke naming this tree's script, the 32-layer serve runs
  the int4 bf16 kernel, row 11);
- `serve_dsv4`: `chip_smoke.py --phases build,serve_dsv4` (the 2-layer
  full-width DeepSeek-V4 serve, row 6b's three kernels a step), read as
  `serve_capacity`;
- `int8`: the int8 matmul, row 1, at the Llama-3.1-8B qkv (4096 x 6144),
  o_proj (4096 x 4096), down (14336 x 4096) and lm_head (4096 x 32768), m = 1,
  8, 16 and 2048, over inputs rotated past L2, one after the other in each
  run;
- `fused_mlp`: the fused MLP, row 2, at Llama-3.1-8B (silu, h 4096, i 14336),
  Gemma-3-27B (gelu_pytorch_tanh, 5376, 21504) and DeepSeek-V4's shared expert
  (silu clamped at 10, 7168, 2048), m = 1, 8 and 16, over inputs rotated past
  L2, one after the other in each run;
- `paged_prefill`: the bf16 paged attention (row 3) on chunks of more than 32
  rows a kv head, one after the other in each run: prefill S = 2048 on 512
  cached, 32 q heads of 128 at groups 4 and 8 (chip_smoke.py's prefill
  shapes), and the verify chunk of 40 rows (S = 5, batch 8, contexts
  300-2048, group 8), L2-warm as chip_smoke.py times them;
- `linear_prefill`: the bf16 linear attention (row 4) at prefill S = 2048 on
  512 cached (T = 2560), groups 4 and 8;
- `linear_decode`: `chip_smoke.py --phases build,linear_decode` in the tree:
  the int8 32-layer model's 2048-token prefill over a linear cache, tok/s
  (best of 3), and its decode-only tok/s at batch 8;
- `quant_prefill`: the quantized attention (rows 5 and 7) on chunks of more
  than 32 rows a kv head, one after the other in each run: prefill S = 2048
  on 512 cached, 32 q heads of 128 at groups 4 and 8, over a paged (4, 4)
  merged and a (5, 3) per-head cache and over a linear (4, 4) cache (group
  4), and the verify chunk of 40 rows (S = 5, batch 8, contexts 300-2048,
  group 8) over a paged (4, 4) cache, each through its wrapper (q and the
  output rotated around the kernel), L2-warm as chip_smoke.py times them;
- `latent_prefill`: the latent (MLA) attention, row 6a-p, on chunks of more
  than one token at DeepSeek-V2-Lite's 16 heads, one after the other in each
  run: prefill S = 2048 on 512 cached over a bf16 and a (4)-bit latent
  cache, paged (a permuted block table) and linear (T = 2560), and the
  verify chunk (S = 5, batch 8, contexts 300-2048, paged) over both, each
  through its wrapper, L2-warm as chip_smoke.py times them;
- `int4_bf16`: the int4 matmul's bf16 route, row 11, at the Llama-3.1-8B
  qkv (4096 x 6144), o_proj (4096 x 4096), gate_up (4096 x 28672), down
  (14336 x 4096) and lm_head (4096 x 32768), m = 1, 8 and 16, over inputs
  rotated past L2, one after the other in each run;
- `stats`: DeepSeek-V4's stats decode attention, row 6b, at chip_smoke.py's
  shapes (batch 8, 128 heads of 512, q positions 300-2048): the sliding ring
  (W = 144, window 128, stale slots), the HCA pool (2 entries a page through
  a shuffled block table) and the CSA rows (512 gathered, 75-512 visible),
  and the rows at 16 heads, each through its wrapper over inputs rotated
  past L2.

    python3 tools/torch_attention_ab.py --trees build/parent,.   # parent, change
    python3 tools/torch_attention_ab.py --run serve_capacity --trees A,B --rounds 3
    python3 tools/torch_attention_ab.py --run serve --trees build/parent,. --rounds 1
    python3 tools/torch_attention_ab.py --run ring --trees build/parent,.
    python3 tools/torch_attention_ab.py --run exl3_gemm --trees build/parent,.
    python3 tools/torch_attention_ab.py --run intb --trees build/parent,.
    python3 tools/torch_attention_ab.py --run serve_packed_int6 --trees build/parent,. --smoke chip_smoke.py
    python3 tools/torch_attention_ab.py --run int4 --trees build/parent,.
    python3 tools/torch_attention_ab.py --run latent --trees build/parent,.
    python3 tools/torch_attention_ab.py --run serve_mla --trees build/parent,. --smoke chip_smoke.py --rounds 1
    python3 tools/torch_attention_ab.py --run int8 --trees build/parent,.
    python3 tools/torch_attention_ab.py --run fused_mlp --trees build/parent,.
    python3 tools/torch_attention_ab.py --run paged_prefill --trees build/parent,.
    python3 tools/torch_attention_ab.py --run linear_prefill --trees build/parent,.
    python3 tools/torch_attention_ab.py --run linear_decode --trees build/parent,. --rounds 1
    python3 tools/torch_attention_ab.py --run quant_prefill --trees build/parent,.
    python3 tools/torch_attention_ab.py --run latent_prefill --trees build/parent,.
    python3 tools/torch_attention_ab.py --run int4_bf16 --trees build/parent,.
    python3 tools/torch_attention_ab.py --run stats --trees build/parent,.

Each tree runs in a process of its own (its own checkout of
exllamav3_tpu_torch, its own kernel build and checkpoint under <tree>/build/),
in the order A, B, B, A for every round. A kernel run queues 200 launches
behind a device spin, five times, over one input set (the trees are compared
with each other, not with a bound), and gives the median device ms a call
(CUDA events) and host µs a call (the host clock over the same 200
enqueues; `intb`, `int4`, `latent`, `int8`, `fused_mlp`, `paged_prefill`,
`linear_prefill`, `quant_prefill`, `latent_prefill`, `int4_bf16` and `stats`
give both for each route or shape); `ring`, `exl3_gemm`, `intb`, `int4`,
`latent`, `int8`, `fused_mlp`, `int4_bf16` and `stats` cycle through input
sets that together exceed twice the L2 cache. A serve run also reports the first
request's TTFT and prefill seconds. Each run's numbers are printed as they come; a run that fails is
printed with its exit code and left out of the medians. The last line is
one JSON object with each tree's medians and B / A. A serve run drives each
tree's own chip_smoke.py, or with `--smoke PATH` that one script in both trees
(each its own package and kernels, one checkpoint under the script's build/;
for a tree whose script lacks the phase, and so that both run the same code
around the serve). Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

KERNEL_RUN = r"""
import json, math, statistics, sys, time, numpy as np, torch
from exllamav3_tpu_torch.constants import PAGE_SIZE
from exllamav3_tpu_torch.ops import flash_attention as fa
from exllamav3_tpu_torch.ops.build import library

library()
dev = torch.device("cuda")
B, Hq, Hk, D = 8, 32, 8, 128
total = np.linspace(300, 2048, 8).astype(np.int32)
mp = int(math.ceil(total.max() / PAGE_SIZE)) + 1
P = B * mp + 1
rng = np.random.default_rng(3)
perm = rng.permutation(np.arange(1, P))[: B * mp].reshape(B, mp).astype(np.int32)
perm[:, -1] = 0
g = torch.Generator(device=dev).manual_seed(4)
q = torch.randn((B, 1, Hq, D), generator=g, device=dev)
bt = torch.as_tensor(perm, device=dev)
qp = torch.as_tensor(total[:, None] - 1, device=dev)
tl = torch.as_tensor(total, device=dev)
from exllamav3_tpu_torch.util.timing import rotating
if sys.argv[1] == "paged_bf16":
    k = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
    fn = lambda: fa.paged_attention_kernel(q, k, v, bt, qp, tl, scale=D ** -0.5)
elif sys.argv[1] == "ring":
    Hq, Hk, N, window = 32, 16, 9, 1024
    W = window + 17 + (-(window + 17)) % 8
    qpos = np.linspace(300, 2048, 8).astype(np.int32)
    slots = np.array([3, 7, 0, 5, 8, 1, 6, 2], np.int32)
    pos = np.full((N, W), -1, np.int32)
    for b, row in enumerate(slots):
        p = int(qpos[b])
        for t in range(max(0, p - W + 1), p + 1 + int(rng.integers(0, 4))):
            pos[row, t % W] = t
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev)
    pos, sl = torch.as_tensor(pos, device=dev), torch.as_tensor(slots, device=dev)
    qp = torch.as_tensor(qpos[:, None], device=dev)
    nxt = rotating(lambda i: [torch.randn((N, W, Hk, D), generator=g, device=dev)
                              .to(torch.bfloat16) for _ in range(2)], 2 * N * W * Hk * D * 2)
    fn = lambda: fa.ring_attention_kernel(q, *nxt(), pos, sl, qp, scale=168 ** -0.5,
                                          sliding_window=window)
elif sys.argv[1] == "exl3_gemm":
    from exllamav3_tpu_torch.ops.exl3_gemm import exl3_gemm_kernel
    m, k, n, K = 8, 4096, 4096, 4
    nxt = rotating(lambda i: (torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16),
                              torch.randint(-2**31, 2**31, (k // 16, K, n // 2), generator=g,
                                            device=dev, dtype=torch.int64).to(torch.int32)),
                   m * k * 2 + k * n * K // 8)
    fn = lambda: exl3_gemm_kernel(*nxt(), K, 0)
elif sys.argv[1] == "intb":
    from exllamav3_tpu_torch.ops import q_matmul as qm
    k, n, bits = 4096, 6144, 6
    W, kp, k_pad = qm.intb_geometry(k, bits)
    fns = {}
    for m in (8, 128, 2048):
        nxt = rotating(lambda i, m=m: (torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16),
                                       torch.randint(-2**31, 2**31, (kp, n), generator=g, device=dev,
                                                     dtype=torch.int64).to(torch.int32),
                                       ((torch.rand((k_pad // 32, n), generator=g, device=dev) + 0.5)
                                        * 0.01).to(torch.bfloat16)),
                       m * k * 2 + kp * n * 4 + k_pad // 32 * n * 2)
        fns[f"bf16_m{m}"] = lambda nxt=nxt: qm.intb_matmul_kernel(*nxt(), bits)
        fns[f"a8_m{m}"] = lambda nxt=nxt: qm.intb_matmul_a8_kernel(*nxt(), bits)
elif sys.argv[1] == "int4":
    from exllamav3_tpu_torch.ops import q_matmul as qm
    k, n = 4096, 6144
    fns = {}
    for m in (8, 128, 2048):
        nxt = rotating(lambda i, m=m: (torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16),
                                       torch.randint(-128, 128, (k // 2, n), generator=g, device=dev,
                                                     dtype=torch.int64).to(torch.int8),
                                       ((torch.rand((k // 32, n), generator=g, device=dev) + 0.5)
                                        * 0.01).to(torch.bfloat16)),
                       m * k * 2 + k // 2 * n + k // 32 * n * 2)
        fns[f"bf16_m{m}"] = lambda nxt=nxt: qm.int4_matmul_kernel(*nxt())
        fns[f"a8_m{m}"] = lambda nxt=nxt: qm.int4_matmul_a8_kernel(*nxt())
elif sys.argv[1] == "latent":
    from exllamav3_tpu_torch.ops.kv_quant import quantize_kv
    Hq = 16
    q = (torch.randn((B, 1, Hq, 576), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    bf16 = rotating(lambda i: torch.randn((P, PAGE_SIZE, 1, 576), generator=g, device=dev)
                    .to(torch.bfloat16), P * PAGE_SIZE * 576 * 2)

    def quant(i):
        raw = torch.randn((P, PAGE_SIZE, 1, 576), generator=g, device=dev)
        kq, ks = quantize_kv(raw[..., :512], 4, 0.0)
        return {"kv_q": kq, "kv_s": ks, "k_pe": raw[..., 512:].to(torch.bfloat16).contiguous()}
    q4 = rotating(quant, P * PAGE_SIZE * (256 + 32 + 128))
    fns = {"bf16": lambda: fa.latent_attention_kernel(q, bf16(), qp, tl, block_tables=bt,
                                                      scale=192 ** -0.5),
           "q4": lambda: fa.latent_attention_quant_kernel(q, q4(), qp, tl, 4, 0.0, block_tables=bt,
                                                          scale=192 ** -0.5)}
elif sys.argv[1] == "int8":
    from exllamav3_tpu_torch.ops import q_matmul as qm
    fns = {}
    for m in (1, 8, 16, 2048):
        for k, n, what in ((4096, 6144, "qkv"), (4096, 4096, "o_proj"), (14336, 4096, "down"),
                           (4096, 32768, "lm_head")):
            nxt = rotating(lambda i, m=m, k=k, n=n: (
                torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16),
                torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8),
                (torch.rand(n, generator=g, device=dev) + 0.5) * 0.01), m * k * 2 + k * n + n * 4)
            fns[f"{what}_m{m}"] = lambda nxt=nxt: qm.int8_matmul_kernel(*nxt())
elif sys.argv[1] == "fused_mlp":
    from exllamav3_tpu_torch.ops.fused_mlp import fused_mlp_int8_kernel
    fns = {}
    for m in (1, 8, 16):
        for name, h, inter, act, clamp in (("8B", 4096, 14336, "silu", 0.0),
                                           ("gemma", 5376, 21504, "gelu_pytorch_tanh", 0.0),
                                           ("dsv4", 7168, 2048, "silu", 10.0)):
            nxt = rotating(lambda i, m=m, h=h, inter=inter: (
                torch.randn((m, h), generator=g, device=dev).to(torch.bfloat16),
                torch.randint(-127, 128, (h, 2 * inter), generator=g, device=dev, dtype=torch.int8),
                torch.full((2 * inter,), 1.0 / (73.0 * math.sqrt(h)), device=dev),
                torch.randint(-127, 128, (inter, h), generator=g, device=dev, dtype=torch.int8)),
                m * h * 2 + 3 * h * inter + 2 * inter * 4)
            fns[f"{name}_m{m}"] = lambda nxt=nxt, act=act, clamp=clamp: fused_mlp_int8_kernel(
                *nxt(), act, clamp)
elif sys.argv[1] in ("paged_prefill", "linear_prefill"):
    fns = {}
    S, pre = 2048, 512
    qpos = torch.arange(pre, pre + S, dtype=torch.int32, device=dev)[None]
    tot = torch.tensor([pre + S], dtype=torch.int32, device=dev)
    for hk in (8, 4):
        qq = torch.randn((1, S, Hq, D), generator=g, device=dev)
        if sys.argv[1] == "paged_prefill":
            pages = (pre + S) // PAGE_SIZE + 1
            tbl = torch.as_tensor(rng.permutation(np.arange(pages))[None].astype(np.int32),
                                  device=dev)
            kk, vv = (torch.randn((pages, PAGE_SIZE, hk, D), generator=g, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
            fns[f"prefill_g{Hq // hk}"] = (
                lambda qq=qq, kk=kk, vv=vv, tbl=tbl: fa.paged_attention_kernel(
                    qq, kk, vv, tbl, qpos, tot, scale=D ** -0.5))
        else:
            kk, vv = (torch.randn((1, pre + S, hk, D), generator=g, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
            fns[f"prefill_g{Hq // hk}"] = (
                lambda qq=qq, kk=kk, vv=vv: fa.linear_attention_kernel(
                    qq, kk, vv, qpos, tot, scale=D ** -0.5))
    if sys.argv[1] == "paged_prefill":  # verify S = 5 at group 8: 40 rows a kv head
        Sv, hk = 5, 4
        qv = torch.randn((B, Sv, Hq, D), generator=g, device=dev)
        kv4, vv4 = (torch.randn((P, PAGE_SIZE, hk, D), generator=g, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
        qpv = torch.as_tensor(total[:, None] - Sv + np.arange(Sv, dtype=np.int32), device=dev)
        fns["verify_s5_g8"] = lambda: fa.paged_attention_kernel(qv, kv4, vv4, bt, qpv, tl,
                                                                scale=D ** -0.5)
elif sys.argv[1] == "quant_prefill":
    from exllamav3_tpu_torch.ops.kv_quant import merged_layout, quantize_kv_stored

    def quant_state(lead, hk, bits):
        st = {}
        for nm, b in zip("kv", bits):
            x = torch.randn((*lead, hk, D), generator=g, device=dev)
            st[nm + "_q"], st[nm + "_s"] = quantize_kv_stored(x, b, merged_layout(*bits))
        return st
    fns = {}
    S, pre = 2048, 512
    qpos = torch.arange(pre, pre + S, dtype=torch.int32, device=dev)[None]
    tot = torch.tensor([pre + S], dtype=torch.int32, device=dev)
    pages = (pre + S) // PAGE_SIZE + 1
    tbl = torch.as_tensor(rng.permutation(np.arange(pages))[None].astype(np.int32), device=dev)
    for bits in ((4, 4), (5, 3)):
        for hk in (8, 4):
            qq = torch.randn((1, S, Hq, D), generator=g, device=dev)
            st = quant_state((pages, PAGE_SIZE), hk, bits)
            fns[f"paged_{bits[0]}{bits[1]}_g{Hq // hk}"] = (
                lambda qq=qq, st=st, bits=bits: fa.paged_attention_quant_kernel(
                    qq, st, tbl, qpos, tot, *bits, scale=D ** -0.5))
    qq = torch.randn((1, S, Hq, D), generator=g, device=dev)
    st = quant_state((1, pre + S), 8, (4, 4))
    fns["linear_44_g4"] = lambda: fa.linear_attention_quant_kernel(qq, st, qpos, tot, 4, 4,
                                                                   scale=D ** -0.5)
    Sv, hk = 5, 4  # verify S = 5 at group 8: 40 rows a kv head
    qv = torch.randn((B, Sv, Hq, D), generator=g, device=dev)
    sv = quant_state((P, PAGE_SIZE), hk, (4, 4))
    qpv = torch.as_tensor(total[:, None] - Sv + np.arange(Sv, dtype=np.int32), device=dev)
    fns["verify_s5_g8"] = lambda: fa.paged_attention_quant_kernel(qv, sv, bt, qpv, tl, 4, 4,
                                                                  scale=D ** -0.5)
elif sys.argv[1] == "latent_prefill":
    from exllamav3_tpu_torch.ops.kv_quant import quantize_kv
    Hq, S, pre, scale = 16, 2048, 512, 192 ** -0.5

    def latent(lead):  # a bf16 and a (4)-bit latent cache of the same rows
        raw = torch.randn((*lead, 1, 576), generator=g, device=dev)
        kq, ks = quantize_kv(raw[..., :512], 4, 0.0)
        return raw.to(torch.bfloat16), {"kv_q": kq, "kv_s": ks,
                                        "k_pe": raw[..., 512:].to(torch.bfloat16).contiguous()}
    fns = {}
    qpos = torch.arange(pre, pre + S, dtype=torch.int32, device=dev)[None]
    tot = torch.tensor([pre + S], dtype=torch.int32, device=dev)
    qq = (torch.randn((1, S, Hq, 576), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    pages = (pre + S) // PAGE_SIZE + 1
    tbl = torch.as_tensor(rng.permutation(np.arange(pages))[None].astype(np.int32), device=dev)
    for layout, lead, where in (("paged", (pages, PAGE_SIZE), dict(block_tables=tbl)),
                                ("linear", (1, pre + S), {})):
        kb, k4 = latent(lead)
        fns[f"{layout}_bf16"] = (lambda kb=kb, where=where: fa.latent_attention_kernel(
            qq, kb, qpos, tot, scale=scale, **where))
        fns[f"{layout}_q4"] = (lambda k4=k4, where=where: fa.latent_attention_quant_kernel(
            qq, k4, qpos, tot, 4, 0.0, scale=scale, **where))
    Sv = 5  # verify: batch 8, contexts 300-2048
    qv = (torch.randn((B, Sv, Hq, 576), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    qpv = torch.as_tensor(total[:, None] - Sv + np.arange(Sv, dtype=np.int32), device=dev)
    vb, v4 = latent((P, PAGE_SIZE))
    fns["verify_s5_bf16"] = lambda: fa.latent_attention_kernel(qv, vb, qpv, tl, block_tables=bt,
                                                               scale=scale)
    fns["verify_s5_q4"] = lambda: fa.latent_attention_quant_kernel(qv, v4, qpv, tl, 4, 0.0,
                                                                   block_tables=bt, scale=scale)
elif sys.argv[1] == "int4_bf16":
    from exllamav3_tpu_torch.ops import q_matmul as qm
    fns = {}
    for m in (1, 8, 16):
        for k, n, what in ((4096, 6144, "qkv"), (4096, 4096, "o_proj"), (4096, 28672, "gate_up"),
                           (14336, 4096, "down"), (4096, 32768, "lm_head")):
            nxt = rotating(lambda i, m=m, k=k, n=n: (
                torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16),
                torch.randint(-128, 128, (k // 2, n), generator=g, device=dev,
                              dtype=torch.int64).to(torch.int8),
                ((torch.rand((k // 32, n), generator=g, device=dev) + 0.5) * 0.01).to(torch.bfloat16)),
                m * k * 2 + k // 2 * n + k // 32 * n * 2)
            fns[f"{what}_m{m}"] = lambda nxt=nxt: qm.int4_matmul_kernel(*nxt())
elif sys.argv[1] == "stats":
    Hq, Dr, W, window, hca, csa, K = 128, 512, 144, 128, 128, 4, 512
    scale = Dr ** -0.5
    qpos = np.linspace(300, 2048, 8).astype(np.int32)
    qp = torch.as_tensor(qpos[:, None], device=dev)
    q = (torch.randn((B, 1, Hq, Dr), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    N, slots = 9, np.array([3, 7, 0, 5, 8, 1, 6, 2], np.int32)
    pos = np.full((N, W), -1, np.int32)
    for b, row in enumerate(slots):
        p = int(qpos[b])
        for t in range(max(0, p - W + 1), p + 1 + int(rng.integers(0, 4))):
            pos[row, t % W] = t
    pos, sl = torch.as_tensor(pos, device=dev), torch.as_tensor(slots, device=dev)
    ring = rotating(lambda i: torch.randn((N, W, Dr), generator=g, device=dev).to(torch.bfloat16),
                    N * W * Dr * 2)
    mpp = int(math.ceil((qpos.max() + 1) / PAGE_SIZE)) + 1
    Pp = B * mpp + 1
    btp = torch.as_tensor(rng.permutation(np.arange(1, Pp))[: B * mpp].reshape(B, mpp)
                          .astype(np.int32), device=dev)
    pool = rotating(lambda i: torch.randn((Pp, PAGE_SIZE // hca, Dr), generator=g, device=dev)
                    .to(torch.bfloat16), Pp * (PAGE_SIZE // hca) * Dr * 2)
    n_pool = (qpos + 1) // hca
    pq = torch.as_tensor((n_pool - 1)[:, None].astype(np.int32), device=dev)
    pt = torch.as_tensor(n_pool.astype(np.int32), device=dev)
    vcount = np.minimum((qpos + 1) // csa, K).astype(np.int32)
    rq = torch.as_tensor((vcount - 1)[:, None], device=dev)
    rt = torch.as_tensor(vcount, device=dev)
    sel = rotating(lambda i: torch.randn((B, K, Dr), generator=g, device=dev).to(torch.bfloat16),
                   B * K * Dr * 2)
    q16 = q[:, :, :16].contiguous()
    fns = {"ring": lambda: fa.ring_attention_stats_kernel(q, ring(), pos, sl, qp, scale, window),
           "pool": lambda: fa.pool_attention_stats_kernel(q, pool(), btp, pq, pt, scale),
           "rows": lambda: fa.rows_attention_stats_kernel(q, sel(), rq, rt, scale),
           "rows_h16": lambda: fa.rows_attention_stats_kernel(q16, sel(), rq, rt, scale)}
else:
    from exllamav3_tpu_torch.ops.kv_quant import quantize_kv_stored
    state = {}
    for nm in ("k", "v"):
        x = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev)
        state[nm + "_q"], state[nm + "_s"] = quantize_kv_stored(x, 4, True)
    fn = lambda: fa.paged_attention_quant_kernel(q, state, bt, qp, tl, 4, 4, scale=D ** -0.5)


def timed(fn):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    ms, host_us = [], []
    for _ in range(5):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(35_000_000)
        t0.record()
        h0 = time.perf_counter()
        for _ in range(200):
            fn()
        h1 = time.perf_counter()
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1) / 200)
        host_us.append((h1 - h0) / 200 * 1e6)
    return statistics.median(ms), statistics.median(host_us)


if sys.argv[1] in ("intb", "int4", "latent", "int8", "fused_mlp", "paged_prefill",
                   "linear_prefill", "quant_prefill", "latent_prefill", "int4_bf16", "stats"):
    res = {}
    for route, f in fns.items():
        res[f"ms_{route}"], res[f"host_us_{route}"] = timed(f)
else:
    res = dict(zip(("ms", "host_us"), timed(fn)))
print(json.dumps(res))
"""

SERVE = (r"^{}: 8 requests finished.*decode-only iterations \d+ tokens in [\d.]+ s "
         r"\(([\d.]+) tok/s\)")  # formatted with the phase's tag
PROFILE = re.compile(r"^profile: (\d+) decode steps \(batch 8\), window ([\d.]+) ms, device busy "
                     r"([\d.]+) ms \([\d.]+ of the window, idle ([\d.]+)\), ([\d.]+) device ops "
                     r"per step(?:, (\d+) tokens:)?", re.M)  # a tree without bursts: 8 tokens a step
FIRST = (r"^{}: request prompt=\d+ cached_tokens=\d+ ttft_s=([\d.]+) "
         r"prefill_s=([\d.]+)")  # the first request's line, formatted with the phase's tag
LINEAR_PREFILL = re.compile(r"^linear_decode int8: prefill \d+ tokens in [\d.]+ ms \(best of 3\): "
                            r"([\d.]+) tok/s", re.M)
LINEAR_DECODE = re.compile(r"^linear_decode int8: decode batch 8 after .*?: ([\d.]+) tok/s", re.M)
RUNS = ("paged_bf16", "paged_quant", "serve_capacity", "serve", "ring", "exl3_gemm",
        "serve_gemma", "intb", "serve_packed_int6", "int4", "latent", "serve_mla", "serve_packed",
        "int8", "fused_mlp", "paged_prefill", "linear_prefill", "linear_decode", "quant_prefill",
        "latent_prefill", "int4_bf16", "stats", "serve_dsv4")


# a serve run's log tag, where it is not the run's name
TAGS = {"serve_packed_int6": "serve_packed int6", "serve_packed": "serve_packed int4"}
# runs the script named first with the arguments after it, as `python script`
# would, but with the tree's checkout first on the path
RUN_SCRIPT = ("import runpy, sys; sys.argv = sys.argv[1:]; "
              "runpy.run_path(sys.argv[0], run_name='__main__')")


def run(tree: str, what: str, smoke: str | None = None) -> tuple[dict | None, str]:
    """(the run's numbers, or None if it failed; what to print about it)."""
    tree = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=tree)
    serve = what.startswith("serve") or what == "linear_decode"
    tag = TAGS.get(what, what)
    if serve and smoke:
        cmd = [sys.executable, "-c", RUN_SCRIPT, smoke, "--phases", f"build,{what}"]
    elif serve:
        cmd = [sys.executable, "chip_smoke.py", "--phases", f"build,{what}"]
    else:
        cmd = [sys.executable, "-c", KERNEL_RUN, what]
    out = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True)
    if out.returncode != 0:
        tail = (out.stdout + out.stderr).strip().splitlines()[-1:]
        return None, f"failed (rc {out.returncode}): {' '.join(tail)}"
    if not serve:
        res = json.loads(out.stdout.strip().splitlines()[-1])
    elif what == "linear_decode":
        res = {"prefill_tok_s": float(LINEAR_PREFILL.search(out.stdout).group(1)),
               "decode_b8_tok_s": float(LINEAR_DECODE.search(out.stdout).group(1))}
    else:
        steps, window, busy, idle, ops, tokens = PROFILE.search(out.stdout).groups()
        tokens = int(tokens) if tokens else 8 * int(steps)
        ttft, prefill = re.search(FIRST.format(tag), out.stdout, re.M).groups()
        res = {"tok_s": float(re.search(SERVE.format(tag), out.stdout, re.M).group(1)),
               "step_ms": float(window) / int(steps), "busy_ms": float(busy) / int(steps),
               "idle": float(idle), "ops": float(ops),
               "busy_ms_token": float(busy) / tokens,
               "ops_token": float(ops) * int(steps) / tokens,
               "first_ttft_s": float(ttft), "first_prefill_s": float(prefill)}
    return res, " ".join(f"{k}={v:.4f}" for k, v in res.items())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", required=True, help="A,B: two checkouts of the repository")
    ap.add_argument("--run", choices=RUNS, default="paged_bf16")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--smoke", default=None,
                    help="the chip_smoke.py that drives a serve run in both trees (default: each "
                         "tree's own)")
    args = ap.parse_args()
    smoke = os.path.abspath(args.smoke) if args.smoke else None
    a, b = args.trees.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {a: [], b: []}
    for r in range(args.rounds):
        for tree in (a, b, b, a):
            res, said = run(tree, args.run, smoke)
            runs[tree].append(res)
            print(f"round {r} {tree}: {args.run} {said}", flush=True)
    medians = {tree: {k: statistics.median(x[k] for x in rs if x) for k in next(x for x in rs if x)}
               for tree, rs in runs.items() if any(rs)}
    ratio = ({k: medians[b][k] / medians[a][k] for k in medians[a]}
             if a in medians and b in medians else None)
    print(json.dumps({"run": args.run, "A": a, "B": b, "medians": medians, "B_over_A": ratio,
                      "runs": runs, "card": smi}))


if __name__ == "__main__":
    main()
