#!/usr/bin/env python3
"""Where the time of the y-slab P2G kernel goes, on one CUDA card.

    python3 scripts/slab_phases.py

Builds copies of ``softmac_tpu_torch/ops/csrc`` whose scatter kernel
returns after each of its phases (tile bounds, staging, the sort, the base
cells' ranges; the full kernel), and times each copy with CUDA events
(50 calls after a warm-up) on the 1e5-particle states that chip_smoke.py
checks the kernels on: pour_vel after 10 env steps (window (40, 32, 16))
and the flagship pour after 10 env steps (32, 32, 16), at tiles of 256,
512 and 1024 particles. Every copy also runs the second launch (the
reduce), so a phase's time is the difference to the one before it. Then
the first design's kernel (one thread a particle, float64 atomics in
device memory) on the pour_vel state in three particle orders: the
rollout's y-sorted one, a random one and one sorted by full cell. Prints
one JSON object; the card's name and power limit on the lines around it.
Needs a card and nvcc; exits non-zero without them.
"""
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# each phase's end in slab.cuh's slab_scatter, and what to return after it
STOPS = {
    "bounds": ("  slab_bounds<Values>(a, tile, &sh);\n  __syncthreads();\n", True),
    "stage": ("  slab_stage<Values>(a, tile, t, &sh);\n", True),
    "sort": ("  __syncthreads();\n  slab_offsets(a, t);\n", False),
    "offsets": ("  slab_offsets(a, t);\n  __syncthreads();\n", True),
}
TILES = (256, 512, 1024)


def stopped_at(src, phase):
    """slab.cuh with a return after ``phase`` (None: the full kernel)."""
    if phase is None:
        return src
    anchor, after = STOPS[phase]
    if anchor not in src:
        raise RuntimeError(f"slab.cuh changed: no end of phase {phase}")
    return src.replace(anchor, anchor + "return;\n" if after
                       else "return;\n" + anchor, 1)


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("slab_phases: CUDA is not available", file=sys.stderr)
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
    env = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                     init_particles=cs.tiled_pour_particles(cs.N_MAIN))
    inp = cs.kernel_inputs(env, env.rollout(cs.actions(cs.STATE_STEPS))
                           ["carry"])
    penv = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                      init_particles=cs.tiled_pour_particles(cs.N_MAIN))
    pinp = cs.pour_kernel_inputs(penv, penv.rollout(
        np.zeros((cs.STATE_STEPS, penv.action_dim)))["carry"])
    states = {name: (i["state"].x, i["chan"], i["corner"], i["sizes"],
                     i["cfg"].inv_dx)
              for name, i in (("pour_vel", inp), ("pour", pinp))}
    src = (build.CSRC / "slab.cuh").read_text()
    res = {"card": smi, "phases_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        jobs = {}
        for phase in list(STOPS) + [None]:
            d = tmp / str(phase)
            d.mkdir()
            # p2g.cu beside the patched header: a quoted include looks in
            # the including file's directory first
            for name in ("p2g.cu", "bspline.cuh"):
                (d / name).write_text((build.CSRC / name).read_text())
            (d / "slab.cuh").write_text(stopped_at(src, phase))
            so = d / "lib.so"
            jobs[phase] = (so, subprocess.Popen(
                [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-o",
                 str(so), str(d / "p2g.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for phase, (so, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({phase}):\n{log}")
            fn = ctypes.CDLL(str(so)).softmac_p2g
            fn.argtypes = build.SIGNATURES["softmac_p2g"]
            for name, (x, chan, corner, sizes, inv_dx) in states.items():
                for tile in TILES:
                    res["phases_ms"][f"{phase or 'full'} {name} {tile}"] = \
                        time_call(fn, x, chan, corner, sizes, inv_dx, tile,
                                  transfer, cs)
    x, chan, corner, sizes, inv_dx = states["pour_vel"]
    base = torch.floor(x * inv_dx - 0.5).to(torch.int64)
    orders = {"y_sorted": torch.arange(x.shape[1], device=x.device),
              "random": torch.randperm(
                  x.shape[1], device=x.device,
                  generator=torch.Generator(x.device).manual_seed(0)),
              "cell_sorted": torch.argsort((base[1] * 4096 + base[2]) * 4096
                                           + base[0], stable=True)}
    res["atomic_ms_by_order"] = {}
    for name, perm in orders.items():
        xs, cs_ = x[:, perm].contiguous(), chan[:, perm].contiguous()
        res["atomic_ms_by_order"][name] = cs.cuda_time_ms(
            lambda: transfer.p2g_atomic(xs, cs_, corner, sizes, inv_dx), 50)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


def time_call(fn, x, chan, corner, sizes, inv_dx, tile, transfer, cs):
    """ms of one call of a built copy's softmac_p2g (buffers as the
    wrapper allocates them, outside the timed calls)."""
    import torch
    n = x.shape[1]
    wx, wy, wz = sizes
    cells = wx * wy * wz
    tiles, _, _, _, tile_doubles = transfer.slab_plan(4, 13, n, tile,
                                                      tuple(sizes))
    kw = dict(device=x.device)
    spill = torch.zeros(4 * cells + 1, dtype=torch.float64, **kw)
    partial = torch.empty(tiles * tile_doubles, dtype=torch.float64, **kw)
    meta = torch.zeros(2 * tiles, dtype=torch.int32, **kw)
    out = torch.empty(4 * cells, **kw)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return cs.cuda_time_ms(lambda: fn(
        x.data_ptr(), chan.data_ptr(), corner.data_ptr(), spill.data_ptr(),
        partial.data_ptr(), meta.data_ptr(), out.data_ptr(), n, tile, wx, wy,
        wz, float(inv_dx), stream), 50)


if __name__ == "__main__":
    sys.exit(main())
