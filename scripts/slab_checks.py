#!/usr/bin/env python3
"""chip_smoke.py's checks of the y-slab kernels alone, on one CUDA card.

    python3 scripts/slab_checks.py

Builds the kernel library and prints, one line each: the slab plan of
each y-slab kernel (P2G, splat, the G2P and gather backwards) on the
main paths' windows; the three backward kernels' entries of the kernels
phase (p2g_bwd, g2p_bwd on pour_vel's state, gather_bwd on the pour's);
chip_smoke.check_slab_kernels (each kernel against its float64 plain
version or vjp, sorted, permuted and on the full grid, the backwards
timed beside their first designs); the pour's gradient path
(chip_smoke.run_pour_grad, which keeps the inputs of three real calls of
gather_bwd and g2p_bwd) and chip_smoke.check_real_backward on them; and
the profile of 10 env steps of the pour's rollout_and_grad. The device
ms of every timed call last. The card's name and power limit on the
first and last lines. Needs a card and nvcc; exits non-zero without
them. About a minute and a half of card time where chip_smoke.py takes
six.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("slab_checks: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.ops import build, transfer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    for w in (cs.WINDOW, cs.POUR_WINDOW, (64, 64, 64)):
        print("plan", json.dumps({
            "window": w, **{k: transfer.slab_plan(*v, cs.N_MAIN,
                                                  transfer.SLAB_TILE, w)
                            for k, v in cs.SLAB_SHAPES.items()}}),
              flush=True)
    env = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                     init_particles=cs.tiled_pour_particles(cs.N_MAIN))
    inp = cs.kernel_inputs(env, env.rollout(cs.actions(cs.STATE_STEPS))
                           ["carry"])
    penv = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                      init_particles=cs.tiled_pour_particles(cs.N_MAIN))
    pinp = cs.pour_kernel_inputs(penv, penv.rollout(
        np.zeros((cs.STATE_STEPS, penv.action_dim)))["carry"])
    entries = (cs.check_backward_kernels(inp)[:2]
               + cs.check_pour_backward_kernels(pinp)[:1])
    for e in entries:
        print("entry", json.dumps({k: e[k] for k in (
            "name", "max_rel_err", "ms", "bound_ms")}), flush=True)
    print("slab", json.dumps(cs.check_slab_kernels(inp, pinp)), flush=True)
    out, _, keep = cs.run_pour_grad(penv)
    print("pour_grad", json.dumps({r: out[r]["fwd_bwd_substeps_per_s"]
                                   for r in ("step", "none")}), flush=True)
    kernels = [{"name": n} for n in cs.REAL_BWD]
    cs.check_real_backward(keep, kernels)
    print("real", json.dumps(kernels), flush=True)
    print("profile_pour_grad", json.dumps(cs.run_profile(
        penv, np.zeros((10, penv.action_dim)), grad=True)), flush=True)
    print("device_ms", json.dumps(cs.DEVICE_MS), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
