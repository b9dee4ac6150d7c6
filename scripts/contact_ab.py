#!/usr/bin/env python3
"""The penalty particle contact (pour_vel's ``collide_particle`` and its
backward) of two checkouts on one CUDA card, in turns.

    python3 scripts/contact_ab.py PARENT_DIR

Builds ``contact.cu``, ``contact_bwd.cu``, ``contact_mixed.cu`` and
``contact_mixed_bwd.cu`` of PARENT_DIR (a checkout of the repository, with
its own headers) into a library of their own, and
loads PARENT_DIR's ``ops/contact.py`` and ``engine/contact.py`` beside this
checkout's, the kernels from that library with the argument lists of
PARENT_DIR's ``ops/build.py``. On the inputs chip_smoke.py checks the
kernels on (pour_vel's 1e5-particle state after 10 env steps, window (40,
32, 16), glass and bowl, the main path's particles and particles spread
over each body's SDF box, seeded normal cotangents) it calls, in turns
(parent, this, this, parent):
- the forward a body as the rollout calls it,
  ``engine.contact.collide_particle`` (the impulse and the wrench: in a
  checkout before the tiled pair, the kernel and the eager wrench tail);
- the backward a body as pour_vel's gradient calls it, for the impulse's
  cotangent alone (velocity control: the wrench reaches no loss): the
  wrapper ``ops.contact.collide_particle_bwd`` of each tree;
with call ms from CUDA events (50 calls after a warm-up), device ms and
launches a call from torch.profiler, and the two trees' largest
difference of each output. Then pour_vel's device launches and device ms
a substep, forward (20 env steps) and fwd+bwd (10, remat "none"), as
chip_smoke.py's profile and profile_grad take them, with either tree's
``engine.contact.collide_particle`` in turns (parent, this, this,
parent), counted by kernel name: each run's total, and each name whose
count is not the same in every run. Last, the tiled mixed pair of both
trees (which shares the tile skeleton of ``contact_mixed.cuh``) in turns
on the flagship pour's 1e5-particle state after 10 env steps, glass and
bowl, with seeded normal cotangents of p_v_out and the wrench: whether
its outputs are bit-identical, call and device ms. Prints one JSON
object; the card's
name and power limit on the lines around it. Needs a card and nvcc; exits
non-zero without them.
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
SOURCES = ("contact.cu", "contact_bwd.cu", "contact_mixed.cu",
           "contact_mixed_bwd.cu")
ENTRIES = ("softmac_collide_particle", "softmac_collide_particle_bwd",
           "softmac_collide_mixed", "softmac_collide_mixed_bwd")
ORDER = ("parent", "this", "this", "parent")
PROFILE_STEPS = {"forward": 20, "fwd_bwd": 10}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_modules(parent, so, build):
    """PARENT_DIR's ops/contact.py (its kernels from the library ``so``)
    and engine/contact.py on it."""
    ops = parent / "softmac_tpu_torch/ops"
    sigs = _load(ops / "build.py", "parent_build").SIGNATURES
    lib = ctypes.CDLL(str(so))
    for k in ENTRIES:
        getattr(lib, k).argtypes = sigs[k]
        getattr(lib, k).restype = ctypes.c_int
    mod = _load(ops / "contact.py", "parent_contact")
    mod.build = types.SimpleNamespace(on_cpu=build.on_cpu, check=build.check,
                                      library=lambda: lib)
    eng = _load(parent / "softmac_tpu_torch/engine/contact.py",
                "parent_engine_contact")
    eng.contact_ops = mod
    return mod, eng


def _flat(out):
    import torch
    return torch.cat([t.reshape(-1).double() for t in out])


def turns(cs, calls, key):
    """Each tree's call in turns: call ms, device ms and launches a call,
    and the outputs' largest difference."""
    import torch
    outs = {t: _flat(c()) for t, c in calls.items()}
    torch.cuda.synchronize()
    ms = {t: [] for t in calls}
    for t in ORDER:
        ms[t].append(cs.cuda_time_ms(calls[t], 50))
    r = {"ms": ms, "max_abs_diff": (outs["this"] - outs["parent"]).abs()
         .max().item(), "max_abs": outs["parent"].abs().max().item()}
    for t in calls:
        r[f"{t}_device_ms"] = cs.device_ms(f"{key} {t}", calls[t])
        r[f"{t}_launches"] = cs.DEVICE_MS[f"{key} {t}"][1]
    return r


def profile_turns(cs, env, trees):
    """pour_vel's device launches and ms a substep, forward and fwd+bwd,
    with each tree's engine collide_particle in turns."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from softmac_tpu_torch.engine import mpm
    out = {}
    try:
        for kind, steps in PROFILE_STEPS.items():
            acts = cs.actions(steps, seed=3)
            n_sub = steps * env.substeps
            runs = []
            for tree in ORDER:
                mpm.contact_mod.collide_particle = trees[tree]
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    if kind == "forward":
                        env.rollout(acts)
                    else:
                        env.rollout_and_grad(acts, loss_start_frame=0,
                                             loss_stride=steps, remat="none")
                    torch.cuda.synchronize()
                count, us = {}, 0.0
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA:
                        count[e.name] = count.get(e.name, 0) + 1
                        us += e.time_range.elapsed_us()
                runs.append((count, us))
            names = sorted(set().union(*(c for c, _ in runs)))
            out[kind] = {
                "runs": ORDER,
                "launches_per_substep": [sum(c.values()) / n_sub
                                         for c, _ in runs],
                "device_ms_per_substep": [us / 1e3 / n_sub for _, us in runs],
                "differ": {name[:120]: [c.get(name, 0) / n_sub
                                        for c, _ in runs]
                           for name in names
                           if len({c.get(name, 0) for c, _ in runs}) > 1}}
            print(json.dumps({kind: out[kind]}), flush=True)
    finally:
        mpm.contact_mod.collide_particle = trees["this"]
    return out


def mixed_turns(cs, pops, contact):
    """The tiled mixed pair of both trees in turns on the flagship pour's
    state (``chip_smoke.pour_kernel_inputs``), glass and bowl."""
    import numpy as np
    import torch
    from softmac_tpu_torch import SoftMacEnv
    env = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                     init_particles=cs.tiled_pour_particles(cs.N_MAIN))
    inp = cs.pour_kernel_inputs(env, env.rollout(
        np.zeros((cs.STATE_STEPS, env.action_dim)))["carry"])
    cfg, x = inp["cfg"], inp["state"].x
    rng = torch.Generator(device=x.device).manual_seed(2)
    out = {}
    for b, (prim, body, v) in enumerate(inp["contacts"]):
        cargs = (prim, *body, x, v, cfg.dt, cfg.p_mass,
                 cfg.contact_push_velocity_cap)
        gout = torch.randn((3, x.shape[1]), generator=rng, device=x.device)
        gwr = torch.randn((6,), generator=rng, device=x.device)
        for d, calls in (
                ("forward", {"parent": lambda: pops._collide_mixed(*cargs),
                             "this": lambda: contact._collide_mixed(*cargs)}),
                ("backward", {
                    "parent": lambda: pops.collide_mixed_bwd(*cargs, gout,
                                                             gwr),
                    "this": lambda: contact.collide_mixed_bwd(*cargs, gout,
                                                              gwr)})):
            key = f"mixed {d} body {b}"
            r = turns(cs, calls, key)
            r["bit_identical"] = r["max_abs_diff"] == 0.0
            out[key] = r
            print(json.dumps({key: r}), flush=True)
    return out


def main():
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("contact_ab: CUDA is not available", file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    csrc = parent / "softmac_tpu_torch/ops/csrc"
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.engine import contact as econtact
    from softmac_tpu_torch.ops import build, contact
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    res = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        so = Path(tmp) / "parent.so"
        done = subprocess.run(
            [build._nvcc(), *build.COMPILE_FLAGS, "-I", str(csrc), "-shared",
             "-o", str(so)] + [str(csrc / s) for s in SOURCES],
            capture_output=True, text=True)
        if done.returncode:
            raise RuntimeError(f"nvcc failed on the parent's sources:\n"
                               f"{done.stdout}{done.stderr}")
        pops, peng = parent_modules(parent, so, build)
        env = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                         init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        inp = cs.kernel_inputs(env, env.rollout(
            cs.actions(cs.STATE_STEPS))["carry"])
        cfg, st = inp["cfg"], inp["state"]
        x, v, n = st.x, st.v, st.x.shape[1]
        gen = torch.Generator(device=x.device).manual_seed(0)
        rng = torch.Generator(device=x.device).manual_seed(1)
        for b, (prim, bp, bq, bv, bw, fr) in enumerate(inp["contacts"]):
            x_box = cs.box_particles(prim, bp, bq, n, gen)
            for xs, label in ((x, "main"), (x_box, "box")):
                cargs = (prim, bp, bq, bv, bw, fr, xs, v, cfg.dt, cfg.p_mass)
                dimp = torch.randn((3, n), generator=rng, device=x.device)
                key = f"body {b} {label}"
                res[f"forward {key}"] = turns(cs, {
                    "parent": lambda: peng.collide_particle(*cargs),
                    "this": lambda: econtact.collide_particle(*cargs)},
                    f"forward {key}")
                res[f"backward {key}"] = turns(cs, {
                    "parent": lambda: pops.collide_particle_bwd(*cargs, dimp),
                    "this": lambda: contact.collide_particle_bwd(
                        *cargs, dimp, None)}, f"backward {key}")
                print(json.dumps({k: res[k] for k in (f"forward {key}",
                                                      f"backward {key}")}),
                      flush=True)
        res["pour_vel"] = profile_turns(
            cs, env, {"parent": peng.collide_particle,
                      "this": econtact.collide_particle})
        del env, inp, x_box
        res.update(mixed_turns(cs, pops, contact))
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
