"""Compare two source trees of the PyTorch port, in turns, on one card, by one
of four runs (`--run`):

- `paged_bf16` (the default): the bf16 paged attention kernel (row 3) at
  decode, batch 8, q positions 299-2047 (contexts 300 to 2048), 32 q / 8 kv
  heads of 128, the shape `chip_smoke.py` reports for the kernel;
- `paged_quant`: the quantized paged attention kernel (rows 5 and 7) at the
  same shape over a (4, 4) cache in merged storage, the call the capacity
  path makes 32 times a decode step;
- `serve_capacity`: `chip_smoke.py --phases build,serve_capacity` in the
  tree (`fused` linears over a (4, 4) paged cache): decode-only tok/s, device
  busy ms a traced step, the traced window's idle share and device
  operations a step, as that phase prints them;
- `serve`: `chip_smoke.py --phases build,serve`, the int8 main path over the
  bf16 paged cache (row 3 32 times a decode step), read as `serve_capacity`.

    python3 tools/torch_attention_ab.py --trees build/parent,.   # parent, change
    python3 tools/torch_attention_ab.py --run serve_capacity --trees A,B --rounds 3
    python3 tools/torch_attention_ab.py --run serve --trees build/parent,. --rounds 1

Each tree runs in a process of its own (its own checkout of
exllamav3_tpu_torch, its own kernel build and checkpoint under <tree>/build/),
in the order A, B, B, A for every round. A kernel run queues 200 launches
behind a device spin, five times, over one input set (the trees are compared
with each other, not with a bound), and gives the median device ms a call
(CUDA events) and host µs a call (the host clock over the same 200
enqueues). Each run's numbers are printed as they come; a run that fails is
printed with its exit code and left out of the medians. The last line is
one JSON object with each tree's medians and B / A. Needs CUDA.
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
if sys.argv[1] == "paged_bf16":
    k = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
    fn = lambda: fa.paged_attention_kernel(q, k, v, bt, qp, tl, scale=D ** -0.5)
else:
    from exllamav3_tpu_torch.ops.kv_quant import quantize_kv_stored
    state = {}
    for nm in ("k", "v"):
        x = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev)
        state[nm + "_q"], state[nm + "_s"] = quantize_kv_stored(x, 4, True)
    fn = lambda: fa.paged_attention_quant_kernel(q, state, bt, qp, tl, 4, 4, scale=D ** -0.5)
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
print(json.dumps({"ms": statistics.median(ms), "host_us": statistics.median(host_us)}))
"""

SERVE = (r"^{}: 8 requests finished.*decode-only iterations \d+ tokens in [\d.]+ s "
         r"\(([\d.]+) tok/s\)")  # formatted with the phase's tag
PROFILE = re.compile(r"^profile: (\d+) decode steps \(batch 8\), window [\d.]+ ms, device busy "
                     r"([\d.]+) ms \([\d.]+ of the window, idle ([\d.]+)\), ([\d.]+) device ops "
                     r"per step", re.M)
RUNS = ("paged_bf16", "paged_quant", "serve_capacity", "serve")


def run(tree: str, what: str) -> tuple[dict | None, str]:
    """(the run's numbers, or None if it failed; what to print about it)."""
    tree = os.path.abspath(tree)
    env = dict(os.environ, PYTHONPATH=tree)
    serve = what.startswith("serve")
    cmd = ([sys.executable, "chip_smoke.py", "--phases", f"build,{what}"] if serve
           else [sys.executable, "-c", KERNEL_RUN, what])
    out = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True)
    if out.returncode != 0:
        tail = (out.stdout + out.stderr).strip().splitlines()[-1:]
        return None, f"failed (rc {out.returncode}): {' '.join(tail)}"
    if not serve:
        res = json.loads(out.stdout.strip().splitlines()[-1])
    else:
        steps, busy, idle, ops = PROFILE.search(out.stdout).groups()
        res = {"tok_s": float(re.search(SERVE.format(what), out.stdout, re.M).group(1)),
               "busy_ms": float(busy) / int(steps), "idle": float(idle), "ops": float(ops)}
    return res, " ".join(f"{k}={v:.4f}" for k, v in res.items())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", required=True, help="A,B: two checkouts of the repository")
    ap.add_argument("--run", choices=RUNS, default="paged_bf16")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    a, b = args.trees.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {a: [], b: []}
    for r in range(args.rounds):
        for tree in (a, b, b, a):
            res, said = run(tree, args.run)
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
