#!/usr/bin/env python3
"""The door's row-thread kernels (the dense-weight P2G and G2P, and the
P2G, G2P, splat and gather backwards) of two checkouts on one CUDA card,
in turns.

    python3 scripts/fused_bwd_ab.py PARENT_DIR

Builds ``fused_p2g.cu``, ``fused_g2p.cu``, ``fused_p2g_bwd.cu``,
``fused_g2p_bwd.cu``, ``fused_splat_bwd.cu`` and ``fused_gather_bwd.cu`` of
PARENT_DIR (a checkout of the repository, with its own headers) into a
library of their own, and loads PARENT_DIR's ``ops/fused.py`` beside this
checkout's, its kernel library that one and its argument lists its own
``ops/build.py``'s (the entry points keep their names; their scratch
arguments may differ). On the inputs chip_smoke.py checks the kernels on
(the door's state after 10 env steps, 5400 particles, window (32, 16,
32), and that state tiled to 1e5 particles, with seeded normal
cotangents) it calls each tree's ``p2g``, ``g2p``, ``p2g_bwd``,
``g2p_bwd``, ``splat_bwd`` and ``gather_bwd`` wrapper in turns (parent,
this, this, parent): call ms with CUDA events (50 calls after a warm-up)
and device ms with torch.profiler (every launch of a call), and the two
trees' largest difference (a wrapper's outputs together). Then the
door's rollout_and_grad (40 env steps of the demo's actions, its loss
frames, remat "step", host clock after a synchronize) with the six
kernels of each tree in turns (parent, this, this, parent, twice),
everything else this checkout's; and the device launches a substep of
the door's fwd+bwd as chip_smoke.py's profile_door_grad profiles it (5
env steps, remat "none") with each tree's kernels in turns (parent,
this, this, parent), by kernel name with torch.profiler: each run's
total, and each name whose count is not the same in every run. Prints
one JSON object; the card's name and power limit on the lines around
it. Needs a card and nvcc; exits non-zero without them.
"""
import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("fused_p2g", "fused_g2p", "fused_p2g_bwd", "fused_g2p_bwd",
           "fused_splat_bwd", "fused_gather_bwd")
# the door's inputs of each wrapper
ARGS = {"fused_p2g": lambda inp, cts: (*inp["ws6"], inp["chan"]),
        "fused_g2p": lambda inp, cts: (*inp["ws6"], *inp["gv"]),
        "fused_p2g_bwd": lambda inp, cts: (*inp["ws6"], inp["chan"],
                                           cts["dgm"], cts["dgmom"]),
        "fused_g2p_bwd": lambda inp, cts: (*inp["ws6"], *inp["gv"],
                                           cts["g12"]),
        "fused_splat_bwd": lambda inp, cts: (*inp["ws6"][0::2], inp["vals"],
                                             cts["dout"]),
        "fused_gather_bwd": lambda inp, cts: (*inp["ws6"][0::2], *inp["gvm"],
                                              cts["dv"])}
GRAD_STEPS = 40
PROFILE_STEPS = 5
# the wrappers of the six kernels in ops/fused.py
WRAPPERS = ("_p2g", "_g2p", "p2g_bwd", "g2p_bwd", "splat_bwd", "gather_bwd")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_fused(parent, so, build):
    """PARENT_DIR's ops/fused.py, its kernels from the library ``so`` (the
    entry points' argument lists from PARENT_DIR's ops/build.py)."""
    ops = parent / "softmac_tpu_torch/ops"
    sigs = _load(ops / "build.py", "parent_build").SIGNATURES
    lib = ctypes.CDLL(str(so))
    for k in KERNELS:
        getattr(lib, "softmac_" + k).argtypes = sigs["softmac_" + k]
    mod = _load(ops / "fused.py", "parent_fused")
    mod.build = types.SimpleNamespace(on_cpu=build.on_cpu, check=build.check,
                                      library=lambda: lib)
    return mod


def main():
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("fused_bwd_ab: CUDA is not available", file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    csrc = parent / "softmac_tpu_torch/ops/csrc"
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch.ops import build, fused
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    with tempfile.TemporaryDirectory() as tmp:
        objs = [Path(tmp) / (k + ".o") for k in KERNELS]
        jobs = [subprocess.Popen([build._nvcc(), *build.COMPILE_FLAGS, "-I",
                                  str(csrc), "-c", str(csrc / (k + ".cu")),
                                  "-o", str(o)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for k, o in zip(KERNELS, objs)]
        for k, job in zip(KERNELS, jobs):
            log = job.communicate()[0]
            if job.returncode:
                raise RuntimeError(f"nvcc failed on the parent's {k}:\n{log}")
        so = Path(tmp) / "parent.so"
        subprocess.run([build._nvcc(), "-shared", "-o", str(so),
                        *map(str, objs)], check=True, capture_output=True)
        mods = {"parent": parent_fused(parent, so, build), "this": fused}
        env, _, states = cs.door_states()
        res = {"card": smi}
        for state, inp in states.items():
            cts = cs.fused_cotangents(inp)
            for k in KERNELS:
                args = ARGS[k](inp, cts)
                calls = {tree: (lambda f=getattr(m, k[6:]): f(*args))
                         for tree, m in mods.items()}
                outs = {tree: torch.cat([t.reshape(-1) for t in c()])
                        for tree, c in calls.items()}
                torch.cuda.synchronize()
                turns = [cs.cuda_time_ms(calls[t], 50)
                         for t in ("parent", "this", "this", "parent")]
                r = {"parent_ms": turns[0::3], "this_ms": turns[1:3],
                     "parent_device_ms": cs.device_ms(f"{k} {state} parent",
                                                      calls["parent"]),
                     "this_device_ms": cs.device_ms(f"{k} {state} this",
                                                    calls["this"]),
                     "max_abs_diff": (outs["this"] - outs["parent"]).abs()
                     .max().item(),
                     "max_abs": outs["parent"].abs().max().item(),
                     "bit_identical": bool(torch.equal(outs["this"],
                                                       outs["parent"]))}
                res[f"{k} {state}"] = r
                print(json.dumps({f"{k} {state}": r}), flush=True)
        trees = {t: {k: getattr(m, k) for k in WRAPPERS}
                 for t, m in mods.items()}
        res["door_grad"] = grad_turns(cs, fused, trees, env)
        res["door_launches"] = launch_turns(cs, fused, trees, env)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


def grad_turns(cs, fused, trees, env):
    """Substeps/s of the door's rollout_and_grad with the six kernels of
    each tree, in turns (parent, this, this, parent, twice)."""
    acts = cs.door_actions(GRAD_STEPS)
    kw = dict(loss_start_frame=cs.door_loss_start(env, GRAD_STEPS),
              grad_clip=1.0)
    n_sub = GRAD_STEPS * env.substeps
    runs = {"parent": [], "this": []}
    try:
        for tree in ("parent", "this", "this", "parent") * 2:
            for k, f in trees[tree].items():
                setattr(fused, k, f)
            cs.timed_grad(env, acts, "step", **kw)
            runs[tree].append(n_sub / cs.timed_grad(env, acts, "step",
                                                    **kw)[1])
            print(json.dumps({"door_grad": tree, "rate": runs[tree][-1]}),
                  flush=True)
    finally:
        for k, f in trees["this"].items():
            setattr(fused, k, f)
    return runs


def launch_turns(cs, fused, trees, env):
    """Device launches a substep of the door's fwd+bwd (rollout_and_grad
    over PROFILE_STEPS env steps, remat "none", as chip_smoke.py's
    profile_door_grad) with the six kernels of each tree, in turns
    (parent, this, this, parent), counted by kernel name with
    torch.profiler: each run's total, and the names whose count differs
    between runs, with their count in each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = cs.door_actions(PROFILE_STEPS)
    n_sub = PROFILE_STEPS * env.substeps
    order = ("parent", "this", "this", "parent")
    runs = []
    try:
        for tree in order:
            for k, f in trees[tree].items():
                setattr(fused, k, f)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                env.rollout_and_grad(acts, loss_start_frame=0,
                                     loss_stride=PROFILE_STEPS, remat="none")
                torch.cuda.synchronize()
            count = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    count[e.name] = count.get(e.name, 0) + 1
            runs.append(count)
    finally:
        for k, f in trees["this"].items():
            setattr(fused, k, f)
    names = sorted(set().union(*runs))
    return {"runs": order,
            "launches_per_substep": [sum(c.values()) / n_sub for c in runs],
            "differ": {name[:120]: [c.get(name, 0) / n_sub for c in runs]
                       for name in names
                       if len({c.get(name, 0) for c in runs}) > 1}}


if __name__ == "__main__":
    sys.exit(main())
