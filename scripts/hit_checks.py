#!/usr/bin/env python3
"""chip_smoke.py's hit phases alone, on one CUDA card.

    python3 scripts/hit_checks.py [PHASE ...]

Builds the kernel library and runs, each printed on a line of its own
with the seconds it took: hit (HIT_STEPS env steps of the demo's push at
its 5000 particles and 144 cloth vertices, exact launches, spills and
off-slab particles, each env step's contact pairs and vertex forces),
hit_kernels (rows 1-8 on the hit's state in contact), hit_grad
(HIT_GRAD_STEPS env steps of rollout_and_grad from that state),
profile_hit, hit_parity (the card
against the CPU in float64 from that state) and demo_hit. PHASE names
pick some of them (every phase but demo_hit runs the hit rollout first).
The card's name and power limit on the first and last lines. Needs a card
and nvcc; exits non-zero without them or when a check fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("hit", "hit_kernels", "hit_grad", "profile_hit", "hit_parity",
          "demo_hit")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("hit_checks: CUDA is not available", file=sys.stderr)
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
    if want - {"demo_hit"}:
        env = cs.hit_env()
        res, _, carry = cs.run_hit(env)
        emit("hit", res)
        if "hit_kernels" in want:
            emit("hit_kernels", cs.check_hit_kernels(env, carry))
        if "hit_grad" in want:
            emit("hit_grad", cs.run_hit_grad(env, carry)[0])
        if "profile_hit" in want:
            acts = cs.hit_actions(cs.HIT_PROFILE_STEPS)
            emit("profile_hit", {
                "forward": cs.run_profile(env, acts, carry0=carry),
                "fwd_bwd": cs.run_profile(
                    env, acts, grad=True, carry0=carry,
                    loss_stride=cs.HIT_PROFILE_STEPS * env.substeps)})
        if "hit_parity" in want:
            emit("hit_parity", cs.run_hit_parity(env, carry))
        del env, carry
    if "demo_hit" in want:
        emit("demo_hit", cs.run_demo_hit())
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
