"""Count the device operations of a serve phase's traced window by kernel
name: the census behind the `device ops per step` that `chip_smoke.py`'s
profile line prints, so that two trees' counts can be told apart by name.

    python tools/torch_op_census.py --phase serve_dsv4 [--tree DIR] [--smoke FILE]

--tree is the checkout whose `exllamav3_tpu_torch` runs (default: this
one); --smoke is the `chip_smoke.py` that drives the phase (default: this
checkout's), so two trees can be driven by one script, as
`tools/torch_attention_ab.py --smoke` does. Prints the card's name and
power limit, then one line a kernel name, `OPS <count a step> <name>`,
sorted by name, and the total; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="serve_dsv4", help="a serve phase of chip_smoke.py")
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--smoke", default=os.path.join(HERE, "chip_smoke.py"))
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    sys.path.insert(0, os.path.abspath(args.tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.abspath(args.smoke))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    traced = smoke.profile_decode

    def census(step, steps: int, what: str) -> None:
        """The phase's traced window, counted by name, then its own profile
        over the next steps."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        names = collections.Counter(e.name for e in prof.events()
                                    if e.device_type == DeviceType.CUDA)
        for name, n in sorted(names.items()):
            print(f"OPS {n / steps:.2f} {name[:160]}", flush=True)
        print(f"OPS total {sum(names.values()) / steps:.2f} a step over {steps} {what}", flush=True)
        traced(step, steps, what)

    smoke.profile_decode = census
    sys.argv = [args.smoke, "--phases", f"build,{args.phase}"]
    smoke.main()


if __name__ == "__main__":
    main()
