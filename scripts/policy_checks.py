#!/usr/bin/env python3
"""chip_smoke.py's closed-loop policy phases alone, on one CUDA card.

    python3 scripts/policy_checks.py [PHASE ...]

Builds the kernel library and runs, each printed on a line of its own
with the seconds it took: policy_grad (the closed loop's loss and gradient
on pour_vel at 1e5 particles, VEL_STEPS env steps, exact launches, a
bit-identical repeat, fwd+bwd substeps/s and a short profile),
policy_deploy (the same weights through the facade on the demo's
5000-particle scene, against the closed-loop forward; the state round
trip; backward()) and demo_policy (DEMO_EPOCHS epochs of DEMO_STEPS env
steps of the trainer). PHASE names pick some of them (policy_deploy runs
policy_grad first, for its weights). The card's name and power limit on
the first and last lines. Needs a card and nvcc; exits non-zero without
them or when a check fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("policy_grad", "policy_deploy", "demo_policy")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("policy_checks: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch import SoftMacEnv
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
    if want - {"demo_policy"}:
        env = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                         init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        res, _, policy = cs.run_policy_grad(env)
        emit("policy_grad", res)
        del env
        if "policy_deploy" in want:
            emit("policy_deploy", cs.run_policy_deploy(policy))
    if "demo_policy" in want:
        emit("demo_policy", cs.run_demo_policy())
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
