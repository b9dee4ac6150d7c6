#!/usr/bin/env python3
"""chip_smoke.py's grip phases alone, on one CUDA card.

    python3 scripts/grip_checks.py [PHASE ...]

Builds the kernel library and runs, each printed on a line of its own
with the seconds it took: grip (the 100-step rollout at 10 000 particles,
exact launches, spills and off-slab particles, the fingers' wrenches),
grip_kernels (rows 1-8 and 11-12 on the grip's state in contact, the
mixed pair at the five remaining-window factors), grip_grad, profile_grip,
grip_parity, demo_grip and demo_pour_vel; and lives (the pour's and the
door's mixed pair at life 1 and 1/3, as chip_smoke.py holds them). PHASE
names pick some of them (grip_kernels, grip_grad and profile_grip run the
grip first). The card's name and power limit on the first and last lines.
Needs a card and nvcc; exits non-zero without them or when a check
fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("grip", "grip_kernels", "grip_grad", "profile_grip", "grip_parity",
          "demo_grip", "demo_pour_vel", "lives")


def main(argv):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("grip_checks: CUDA is not available", file=sys.stderr)
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
    if want & {"grip", "grip_kernels", "grip_grad", "profile_grip"}:
        genv = cs.grip_env()
        res, _, carry = cs.run_grip(genv)
        prof = res.pop("profile")
        emit("grip", res)
        if "grip_kernels" in want:
            emit("grip_kernels", cs.check_grip_kernels(genv, carry))
        if "grip_grad" in want:
            emit("grip_grad", cs.run_grip_grad(genv)[0])
        if "profile_grip" in want:
            emit("profile_grip", {
                "forward": prof, "fwd_bwd": cs.run_profile(
                    genv, cs.grip_actions(cs.GRIP_GRAD_PROFILE_STEPS),
                    grad=True, loss_stride=cs.GRIP_GRAD_PROFILE_STEPS
                    * genv.substeps),
                "rigid_step_launches_per_env_step":
                    cs.rigid_step_launches(genv)})
        del genv, carry
    if "grip_parity" in want:
        emit("grip_parity", cs.run_grip_parity())
    if "demo_grip" in want:
        emit("demo_grip", cs.run_demo_grip())
    if "demo_pour_vel" in want:
        emit("demo_pour_vel", cs.run_demo_pour_vel())
    if "lives" in want:
        penv = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                          init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        pinp = cs.pour_kernel_inputs(penv, penv.rollout(
            np.zeros((cs.STATE_STEPS, penv.action_dim)))["carry"])
        emit("pour_lives", cs.check_mixed_lives(
            "pour collide_mixed", pinp, (1.0, cs.LIFE_BELOW_ONE),
            cs.BODY_TOL, every_body=False))
        del penv, pinp
        _, _, dinp = cs.door_states()
        emit("door_lives", cs.check_mixed_lives(
            "door collide_mixed", dinp["band"], (1.0, cs.LIFE_BELOW_ONE),
            cs.BODY_TOL, every_body=False))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
