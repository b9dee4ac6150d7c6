#!/usr/bin/env python3
"""chip_smoke.py's taco phases alone, on one CUDA card.

    python3 scripts/taco_checks.py [PHASE ...]

Builds the kernel library and runs, each printed on a line of its own
with the seconds it took: taco (TACO_STEPS env steps of the scripted fold
at the taco's 10 000 particles and 217 cloth vertices in the cloth control
mode, exact launches, spills and off-slab particles, each env step's
contact pairs and vertex forces), taco_kernels (rows 1-8 on the taco's
state in contact), taco_grad (TACO_GRAD_STEPS env steps of
rollout_and_grad from that state), profile_taco, taco_parity (the card
against the CPU in float64 from that state) and demo_taco (one epoch of
each optimiser). PHASE names pick some of them (every phase but demo_taco
runs the taco rollout first). The card's name and power limit on the
first and last lines. Needs a card and nvcc; exits non-zero without them
or when a check fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("taco", "taco_kernels", "taco_grad", "profile_taco",
          "taco_parity", "demo_taco")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("taco_checks: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch.ops import build
    want = set(argv or PHASES)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _, _, secs = build.build()
    build.library()
    print("build", json.dumps({"seconds": secs}), flush=True)
    t = time.perf_counter()

    def emit(tag, obj):
        nonlocal t
        now = time.perf_counter()
        print(f"{tag} ({now - t:.1f} s): {json.dumps(obj)}", flush=True)
        t = now
    env = cs.taco_env()
    if want - {"demo_taco"}:
        res, _, carry = cs.run_taco(env)
        emit("taco", res)
        if "taco_kernels" in want:
            emit("taco_kernels", cs.check_taco_kernels(env, carry))
        if "taco_grad" in want:
            emit("taco_grad", cs.run_taco_grad(env, carry)[0])
        if "profile_taco" in want:
            emit("profile_taco", cs.profile_cloth(
                "taco", env, carry, cs.taco_hold(env, cs.TACO_PROFILE_STEPS),
                cs.taco_hold(env, cs.TACO_PROFILE_STEPS + 1)))
        if "taco_parity" in want:
            emit("taco_parity", cs.run_taco_parity(env, carry))
        del carry
    if "demo_taco" in want:
        emit("demo_taco", cs.run_demo_taco(env.substeps))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
