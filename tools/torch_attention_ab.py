"""Time the PyTorch port's bf16 paged attention kernel in two source trees, in
turns, on one card: decode at batch 8, q positions 299-2047 (contexts 300 to
2048), 32 q / 8 kv heads of 128, the shape `chip_smoke.py` reports for the
kernel.

    python3 tools/torch_attention_ab.py --trees build/parent,.   # parent, change
    python3 tools/torch_attention_ab.py --trees A,B --rounds 3

Each tree runs in a process of its own (its own checkout of
exllamav3_tpu_torch, its own kernel build under <tree>/build/), in the order
A, B, B, A for every round. Each run prints the mean kernel time of 200
launches queued behind a device spin (CUDA events), five times; the script
prints every run's median, each tree's median over its runs, and B / A. Needs
CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUN = r"""
import json, math, numpy as np, torch
from exllamav3_tpu_torch.constants import PAGE_SIZE
from exllamav3_tpu_torch.ops.build import library
from exllamav3_tpu_torch.ops.flash_attention import paged_attention_kernel

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
k = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
v = torch.randn((P, PAGE_SIZE, Hk, D), generator=g, device=dev).to(torch.bfloat16)
bt = torch.as_tensor(perm, device=dev)
qp = torch.as_tensor(total[:, None] - 1, device=dev)
tl = torch.as_tensor(total, device=dev)
fn = lambda: paged_attention_kernel(q, k, v, bt, qp, tl, scale=D ** -0.5)
for _ in range(5):
    fn()
torch.cuda.synchronize()
times = []
for _ in range(5):
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(35_000_000)
    t0.record()
    for _ in range(200):
        fn()
    t1.record()
    torch.cuda.synchronize()
    times.append(t0.elapsed_time(t1) / 200)
print(json.dumps(times))
"""


def run(tree: str) -> list:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    out = subprocess.run([sys.executable, "-c", RUN], cwd=os.path.abspath(tree), env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", required=True, help="A,B: two checkouts of the repository")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    a, b = args.trees.split(",")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    medians = {a: [], b: []}
    for r in range(args.rounds):
        for tree in (a, b, b, a):
            times = run(tree)
            medians[tree].append(statistics.median(times))
            print(f"round {r} {tree}: paged_attention decode B=8 ms "
                  f"{' '.join(f'{t:.4f}' for t in times)} (median {medians[tree][-1]:.4f})",
                  flush=True)
    ma, mb = statistics.median(medians[a]), statistics.median(medians[b])
    print(json.dumps({"A": a, "B": b, "A_ms": ma, "B_ms": mb, "B_over_A": mb / ma,
                      "A_runs": medians[a], "B_runs": medians[b], "card": smi}))


if __name__ == "__main__":
    main()
