#!/usr/bin/env python3
"""Where the time of a y-slab kernel goes, on one CUDA card.

    python3 scripts/slab_phases.py [p2g|g2p_bwd]

Builds copies of ``softmac_tpu_torch/ops/csrc`` whose scatter kernel
returns after each of its phases (tile bounds, staging, the sort, the base
cells' ranges; the full kernel), and times each copy with CUDA events
(50 calls after a warm-up) on the 1e5-particle states that chip_smoke.py
checks the kernels on: pour_vel after 10 env steps (window (40, 32, 16))
and the flagship pour after 10 env steps (32, 32, 16), at tiles of 256,
512 and 1024 particles. The kernel is P2G (the default, on the states'
channels) or G2P's backward (on their grids with seeded normal
cotangents; its stage phase also gathers dx). Every copy also runs the
second launch (the reduce), so a phase's time is the difference to the
one before it. Prints one JSON object; the card's name and power limit
on the lines around it. Needs a card and nvcc; exits non-zero without
them.
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
# each kernel's source and (channels, input rows)
KERNELS = {"p2g": ("p2g.cu", (4, 13)), "g2p_bwd": ("g2p_bwd.cu", (3, 12))}


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
    kernel = sys.argv[1] if len(sys.argv) > 1 else "p2g"
    if kernel not in KERNELS:
        print(__doc__, file=sys.stderr)
        return 2
    source = KERNELS[kernel][0]
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
    gen = torch.Generator(device=inp["state"].x.device).manual_seed(1)
    states = {}
    for name, i, grids in (("pour_vel", inp, inp["grids"]),
                           ("pour", pinp, pinp["gvm"])):
        x = i["state"].x
        src = i["chan"] if kernel == "p2g" else torch.randn(
            (12, x.shape[1]), generator=gen, device=x.device)
        states[name] = (x, src, i["corner"], i["sizes"], i["cfg"].inv_dx,
                        () if kernel == "p2g" else grids)
    src = (build.CSRC / "slab.cuh").read_text()
    res = {"card": smi, "kernel": kernel, "phases_ms": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        jobs = {}
        for phase in list(STOPS) + [None]:
            d = tmp / str(phase)
            d.mkdir()
            # the source beside the patched header: a quoted include looks
            # in the including file's directory first
            for name in (source, "bspline.cuh"):
                (d / name).write_text((build.CSRC / name).read_text())
            (d / "slab.cuh").write_text(stopped_at(src, phase))
            so = d / "lib.so"
            jobs[phase] = (so, subprocess.Popen(
                [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-o",
                 str(so), str(d / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for phase, (so, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({phase}):\n{log}")
            fn = getattr(ctypes.CDLL(str(so)), "softmac_" + kernel)
            fn.argtypes = build.SIGNATURES["softmac_" + kernel]
            for name, state in states.items():
                for tile in TILES:
                    res["phases_ms"][f"{phase or 'full'} {name} {tile}"] = \
                        time_call(fn, KERNELS[kernel][1], *state, tile,
                                  transfer, cs)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


def time_call(fn, shape, x, src, corner, sizes, inv_dx, grids, tile,
              transfer, cs):
    """ms of one call of a built copy's entry point (buffers as
    ``transfer._slab`` allocates them, outside the timed calls)."""
    import torch
    n = x.shape[1]
    channels, inputs = shape
    cells = sizes[0] * sizes[1] * sizes[2]
    tiles, _, _, _, tile_doubles = transfer.slab_plan(channels, inputs, n,
                                                      tile, tuple(sizes))
    kw = dict(device=x.device)
    spill = torch.zeros(channels * cells + 1, dtype=torch.float64, **kw)
    partial = torch.empty(tiles * tile_doubles, dtype=torch.float64, **kw)
    meta = torch.zeros(2 * tiles, dtype=torch.int32, **kw)
    out = torch.empty(channels * cells, **kw)
    dx = (torch.empty((3, n), **kw),) if grids else ()
    ptrs = [t.data_ptr() for t in (x, src, corner, *grids, *dx, spill,
                                   partial, meta, out)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return cs.cuda_time_ms(lambda: fn(*ptrs, n, tile, *sizes, float(inv_dx),
                                      stream), 50)


if __name__ == "__main__":
    sys.exit(main())
