#!/usr/bin/env python3
"""chip_smoke.py's rendering and mesh-preprocessing phases alone, on one
CUDA card.

    python3 scripts/render_checks.py [PHASE ...]

Builds the kernel library and runs, each printed on a line of its own with
the seconds it took: render (frames of the flagship pour at 1e5 particles,
of the hit after its counted rollout and of the door after STATE_STEPS env
steps, each drawn on the card and held against the CPU's float64 frame of
the same snapshot; ms a frame), demo_render (one epoch of demo_pour without
and with --render-interval 1; its GIF's frames), bake (the SDF bake on the
card against the shipped tables; ms a bake) and native (the C++
preprocessing library built with g++ and held to the Python bodies). PHASE
names pick some of them. The card's name and power limit on the first and
last lines. Needs a card and nvcc; exits non-zero without them or when a
check fails.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("render", "demo_render", "bake", "native")


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("render_checks: CUDA is not available", file=sys.stderr)
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
    if "render" in want:
        pour_env = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                              init_particles=cs.tiled_pour_particles(
                                  cs.N_MAIN))
        henv = cs.hit_env()
        hit_carry = henv.rollout(cs.hit_actions(cs.HIT_STEPS))["carry"]
        denv = cs.door_env()
        door10 = denv.rollout(cs.door_actions(cs.STATE_STEPS))["carry"]
        emit("render", cs.run_render(pour_env, henv, hit_carry, denv,
                                     door10))
        del pour_env, henv, hit_carry, denv, door10
    if "demo_render" in want:
        emit("demo_render", cs.run_demo_render())
    if "bake" in want:
        emit("bake", cs.run_bake())
    if "native" in want:
        emit("native", cs.run_native())
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
