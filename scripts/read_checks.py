#!/usr/bin/env python3
"""chip_smoke.py's checks of the read-side tile kernels alone, on one CUDA
card.

    python3 scripts/read_checks.py

Builds the kernel library and prints, one line each: the registers and
spills of the read-side tile kernels (ops/csrc/slab_read.cuh: g2p.cu,
gather.cu, p2g_bwd.cu, splat_bwd.cu) from the build's ptxas log;
chip_smoke.check_read_kernels (each kernel against its float64 plain
version or vjp on the pour_vel and pour states, sorted and permuted, the
full 64^3 grid and spread particles, 10 calls bit-identical, the
particles that read device memory, call and device ms); and the off-slab
counts of the pour's and pour_vel's forward rollouts and
rollout_and_grads (20 env steps, remat "none", chip_smoke.OffSlab). The
card's name and power limit on the first and last lines. Needs a card
and nvcc; exits non-zero without them.
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
        print("read_checks: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.ops import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _, log, secs = build.build()
    build.library()
    ptxas = cs.ptxas_by_source(log)
    print("build", json.dumps({"seconds": secs, "read_tile_kernels": {
        k: ptxas.get(k) for k in cs.READ_SOURCES}}), flush=True)
    env = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                     init_particles=cs.tiled_pour_particles(cs.N_MAIN))
    inp = cs.kernel_inputs(env, env.rollout(
        cs.actions(cs.STATE_STEPS))["carry"])
    penv = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                      init_particles=cs.tiled_pour_particles(cs.N_MAIN))
    pinp = cs.pour_kernel_inputs(penv, penv.rollout(
        np.zeros((cs.STATE_STEPS, penv.action_dim)))["carry"])
    print("read", json.dumps(cs.check_read_kernels(inp, pinp)), flush=True)
    for name, e, acts in (("pour", penv, np.zeros((20, penv.action_dim))),
                          ("pour_vel", env, cs.actions(20))):
        with cs.OffSlab() as off:
            e.rollout(acts)
        print(f"{name} rollout off_slab", json.dumps(off.counts()),
              flush=True)
        with cs.OffSlab() as off:
            e.rollout_and_grad(acts, loss_start_frame=0, loss_stride=20,
                               remat="none")
        print(f"{name} rollout_and_grad off_slab", json.dumps(off.counts()),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
