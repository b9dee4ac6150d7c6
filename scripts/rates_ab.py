#!/usr/bin/env python3
"""Substep rates of two checkouts of the port on one CUDA card, in turns.

    python3 scripts/rates_ab.py DIR_A DIR_B

Each of DIR_A, DIR_B is a checkout of the repository (its own
chip_smoke.py, softmac_tpu_torch and kernel build). The runs go A, B, B,
A, A, B, B, A, each in a fresh process that builds (or loads) that tree's
kernels and times, on the 1e5-particle scenes of chip_smoke.py: the
flagship pour's rollout (5 timed rollouts of 20 env steps after a
warm-up) and its rollout_and_grad under remat "step" (3 timed calls of 20
steps), and pour_vel's rollout (5 of 20). Every rate is host-clock
substeps/s after a synchronize; a run reports the median of its repeats,
and the last line each tree's median over its runs. The host moves these
rates by tens of percent from one run to the next, hence the turns.
Prints one JSON line a run and the card's name and power limit. Needs a
card.
"""
import json
import statistics
import subprocess
import sys
from pathlib import Path

STEPS = 20
CHILD = r"""
import json, statistics, sys
sys.path.insert(0, ".")
import numpy as np
import chip_smoke as cs
from softmac_tpu_torch import SoftMacEnv
from softmac_tpu_torch.ops import build
build.library()
res = {}
pour = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                  init_particles=cs.tiled_pour_particles(cs.N_MAIN))
acts = np.zeros((STEPS, pour.action_dim))
n_sub = STEPS * pour.substeps
cs.timed_rollout(pour, acts)
res["pour"] = statistics.median(
    n_sub / cs.timed_rollout(pour, acts)[1] for _ in range(5))
cs.timed_grad(pour, acts, "step")
res["pour_grad_step"] = statistics.median(
    n_sub / cs.timed_grad(pour, acts, "step")[1] for _ in range(3))
vel = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                 init_particles=cs.tiled_pour_particles(cs.N_MAIN))
acts = cs.actions(STEPS)
n_sub = STEPS * vel.substeps
cs.timed_rollout(vel, acts)
res["pour_vel"] = statistics.median(
    n_sub / cs.timed_rollout(vel, acts)[1] for _ in range(5))
print(json.dumps(res))
""".replace("STEPS", str(STEPS))


def main():
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    dirs = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"A": [], "B": []}
    for tag in "ABBAABBA":
        out = subprocess.run([sys.executable, "-c", CHILD], cwd=dirs[tag],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        rates = json.loads(out.stdout.strip().splitlines()[-1])
        runs[tag].append(rates)
        print(json.dumps({"tree": tag, "dir": str(dirs[tag]),
                          "substeps_per_s": rates}), flush=True)
    print(smi, flush=True)
    print(json.dumps({tag: {k: statistics.median(r[k] for r in rs)
                            for k in rs[0]} for tag, rs in runs.items()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
