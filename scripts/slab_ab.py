#!/usr/bin/env python3
"""The y-slab P2G and splat of two checkouts on one CUDA card, in turns.

    python3 scripts/slab_ab.py PARENT_DIR

Builds ``p2g.cu`` and ``splat.cu`` of PARENT_DIR (a checkout of the
repository, with its own ``slab.cuh``) into a library of their own, and
loads this checkout's kernel library. Both kernels keep their C entry
points (``softmac_p2g``, ``softmac_splat``) across the two trees, so the
same buffers go to both. On the 1e5-particle states that chip_smoke.py
checks the kernels on (pour_vel after 10 env steps, window (40, 32, 16);
the flagship pour after 10 env steps, (32, 32, 16); the splat on
pour_vel with seeded normal values, on the pour with its real ones) it
calls each kernel in turns (parent, this, this, parent): call
ms with CUDA events (50 calls after a warm-up) and device ms with
torch.profiler, and how far the two trees' windows differ (both sum in
float64 and round once; the order of the sums may differ). Then the
pour's and pour_vel's forward rollouts (20 env steps after a warm-up,
host clock after a synchronize) with ``transfer``'s P2G and splat calls
routed to each tree's library in turns (parent, this, this, parent,
twice), everything else this checkout's: the two trees' kernels on the
main path, in one process. Prints one JSON object; the card's name and
power limit on the lines around it. Needs a card and nvcc; exits
non-zero without them.
"""
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    import numpy as np
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("slab_ab: CUDA is not available", file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve() / "softmac_tpu_torch/ops/csrc"
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.ops import build, transfer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {"this": build.library()}
    with tempfile.TemporaryDirectory() as tmp:
        objs = []
        for name in ("p2g.cu", "splat.cu"):
            obj = Path(tmp) / (name + ".o")
            subprocess.run([build._nvcc(), *build.COMPILE_FLAGS, "-I",
                            str(parent), "-c", str(parent / name), "-o",
                            str(obj)], check=True, capture_output=True)
            objs.append(str(obj))
        so = Path(tmp) / "parent.so"
        subprocess.run([build._nvcc(), "-shared", "-o", str(so), *objs],
                       check=True, capture_output=True)
        libs["parent"] = ctypes.CDLL(str(so))
        for lib in libs.values():
            for fn in ("softmac_p2g", "softmac_splat"):
                getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        env = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                         init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        inp = cs.kernel_inputs(env, env.rollout(
            cs.actions(cs.STATE_STEPS))["carry"])
        penv = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                          init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        pinp = cs.pour_kernel_inputs(penv, penv.rollout(
            np.zeros((cs.STATE_STEPS, penv.action_dim)))["carry"])
        gen = torch.Generator(device=inp["state"].x.device).manual_seed(11)
        vals_v = torch.randn((3, cs.N_MAIN), generator=gen,
                             device=inp["state"].x.device)
        res = {"card": smi}
        for state, i, vals in (("pour_vel", inp, vals_v),
                               ("pour", pinp, pinp["vals"])):
            x = i["state"].x
            for name, src, shape in (("p2g", i["chan"], (4, 13)),
                                     ("splat", vals, (3, 3))):
                calls = {tree: call(lib, name, shape, x, src, i["corner"],
                                    i["sizes"], i["cfg"].inv_dx, transfer)
                         for tree, lib in libs.items()}
                outs = {tree: c().clone() for tree, c in calls.items()}
                torch.cuda.synchronize()
                turns = [cs.cuda_time_ms(calls[t], 50)
                         for t in ("parent", "this", "this", "parent")]
                res[f"{name} {state}"] = {
                    "parent_ms": turns[0::3], "this_ms": turns[1:3],
                    "parent_device_ms": cs.device_ms(
                        f"{name} {state} parent", calls["parent"]),
                    "this_device_ms": cs.device_ms(
                        f"{name} {state} this", calls["this"]),
                    "max_abs_diff": (outs["this"] - outs["parent"]).abs()
                    .max().item(),
                    "max_abs": outs["parent"].abs().max().item(),
                    "bit_identical": bool(torch.equal(outs["this"],
                                                      outs["parent"]))}
                print(json.dumps({f"{name} {state}":
                                  res[f"{name} {state}"]}), flush=True)
        res["rollouts"] = rollout_turns(cs, build, libs, {
            "pour": (penv, np.zeros((20, penv.action_dim))),
            "pour_vel": (env, cs.actions(20))})
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


class _Routed:
    """This checkout's library with softmac_p2g / softmac_splat taken from
    another."""

    def __init__(self, base, other):
        self.base, self.other = base, other

    def __getattr__(self, name):
        lib = self.other if name in ("softmac_p2g", "softmac_splat") \
            else self.base
        return getattr(lib, name)


def rollout_turns(cs, build, libs, scenes):
    """Substeps/s of each scene's rollout with P2G and splat from each
    tree's library, in turns (parent, this, this, parent, twice)."""
    library = build.library
    routed = {"this": libs["this"],
              "parent": _Routed(libs["this"], libs["parent"])}
    out = {}
    try:
        for name, (env, acts) in scenes.items():
            runs = {"parent": [], "this": []}
            n_sub = len(acts) * env.substeps
            for tree in ("parent", "this", "this", "parent") * 2:
                build.library = lambda lib=routed[tree]: lib
                cs.timed_rollout(env, acts)
                runs[tree].append(n_sub / cs.timed_rollout(env, acts)[1])
            out[name] = runs
            print(json.dumps({f"rollout {name}": runs}), flush=True)
    finally:
        build.library = library
    return out


def call(lib, name, shape, x, src, corner, sizes, inv_dx, transfer):
    """One call of a tree's softmac_p2g or softmac_splat, its buffers (as
    ``transfer._slab`` allocates them) made once; returns a function that
    launches it and returns its window (the same buffer each call)."""
    import torch
    n = x.shape[1]
    channels, inputs = shape
    cells = sizes[0] * sizes[1] * sizes[2]
    tiles, _, _, _, tile_doubles = transfer.slab_plan(
        channels, inputs, n, transfer.SLAB_TILE, tuple(sizes))
    kw = dict(device=x.device)
    spill = torch.zeros(channels * cells + 1, dtype=torch.float64, **kw)
    partial = torch.empty(tiles * tile_doubles, dtype=torch.float64, **kw)
    meta = torch.zeros(2 * tiles, dtype=torch.int32, **kw)
    out = torch.empty(channels * cells, **kw)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = getattr(lib, "softmac_" + name)

    def run():
        spill.zero_()
        rc = fn(x.data_ptr(), src.data_ptr(), corner.data_ptr(),
                spill.data_ptr(), partial.data_ptr(), meta.data_ptr(),
                out.data_ptr(), n, transfer.SLAB_TILE, *sizes,
                float(inv_dx), stream)
        if rc != 0:
            raise RuntimeError(f"{name}: cudaError {rc}")
        return out
    return run


if __name__ == "__main__":
    sys.exit(main())
