#!/usr/bin/env python3
"""chip_smoke.py's phases of the rest of the rigid family alone, on one
CUDA card.

    python3 scripts/rigid_checks.py [PHASE ...]

Builds the kernel library and runs, each printed on a line of its own
with the seconds it took: pour_body_contact (the flagship pour at 1e5
with RIGID.body_contact: launches as the plain pour's, a gradient under
"step" and "none" with bit-identical repeats, what body contact adds a
substep, one demo_pour --body-contact epoch), body_contact_drop (the
glass-on-bowl drop of demos.demo_body_contact, with and without the stick
branch), chain_blob (a double pendulum swinging into a 1e4-particle
elastic blob), rigid_family (welds, the palm on a slider, the flybot:
card float32 against CPU float64) and transport (TransportLoss on a
reduced pour_vel). PHASE names pick some of them. The card's name and
power limit on the first and last lines. Needs a card and nvcc; exits
non-zero without them or when a check fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("pour_body_contact", "body_contact_drop", "chain_blob",
          "rigid_family", "transport")


def main(argv):
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("rigid_checks: CUDA is not available", file=sys.stderr)
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
    if "pour_body_contact" in want:
        pour_env = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                              init_particles=cs.tiled_pour_particles(
                                  cs.N_MAIN))
        pour_env.rollout(np.zeros((2, pour_env.action_dim)))   # warm-up
        emit("pour_body_contact", cs.run_pour_body_contact(pour_env)[0])
        del pour_env
    if "body_contact_drop" in want:
        emit("body_contact_drop", cs.run_body_contact_drop())
    if "chain_blob" in want:
        emit("chain_blob", cs.run_chain_blob()[0])
    if "rigid_family" in want:
        emit("rigid_family", cs.run_rigid_family())
    if "transport" in want:
        emit("transport", cs.run_transport())
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
