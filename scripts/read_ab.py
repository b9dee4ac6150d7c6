#!/usr/bin/env python3
"""G2P and the gather of two checkouts on one CUDA card, in turns.

    python3 scripts/read_ab.py PARENT_DIR
    python3 scripts/read_ab.py --variants

Builds ``g2p.cu`` and ``gather.cu`` of PARENT_DIR (a checkout of the
repository, with its own headers) into a library of their own, and loads
this checkout's kernel library. The C entry points keep their names
(``softmac_g2p``, ``softmac_gather``) across the trees; this checkout's
take one more pointer, each tile's off-slab count (ops/csrc/slab_read.cuh),
so each tree gets its own argument list over the same buffers. On the
1e5-particle states that chip_smoke.py checks the kernels on (pour_vel
after 10 env steps, window (40, 32, 16); the flagship pour after 10 env
steps, (32, 32, 16); each also in a random permutation of its particles)
it calls each kernel in turns (parent, this, this, parent): call ms with
CUDA events (50 calls after a warm-up), device ms with torch.profiler (10
calls), how far the two trees' outputs differ, and this tree's off-slab
count. Then the pour's and pour_vel's forward rollouts (20 env steps after
a warm-up, host clock after a synchronize) and the pour's device ms and
launches a forward substep (chip_smoke.run_profile over 10 env steps)
with ``transfer``'s G2P and gather routed to each tree's library in turns
(parent, this, this, parent), everything else this checkout's.

With ``--variants`` (no parent) it builds copies of this tree's two
sources with slab_read.cuh's tile and slab budget patched, and probes
patched in (VARIANTS), and gives each copy's
registers and spills and, on the two sorted states, its largest error
against the float64 plain version (each output row against its largest
|value|), whether its outputs are this tree's bits, its off-slab count,
and its call and device ms.

Prints one JSON object; the card's name and power limit on the lines
around it. Needs a card and nvcc; exits non-zero without them.
"""
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("g2p.cu", "gather.cu")
ORDER = ("parent", "this", "this", "parent")
ROWS = {"g2p": 12, "gather": 3}
# (particles a block, slab budget in KB, probes or None, several joined by
# "+"); a budget of 0 stages nothing (every particle from device memory).
# The probes: "even" stages box rows at their own width
# (read_stride: not made odd); "bounds" returns after the tile's bounds,
# "stage" before the sums (the bounds and the staging alone), "bcast"
# reads every slab cell from the slab's first 8 (no bank conflicts: what
# the sums cost without them; wrong outputs)
VARIANTS = ((256, 48, None), (256, 48, "bounds"), (256, 48, "stage"),
            (256, 48, "bcast"), (256, 48, "even"), (128, 48, None),
            (512, 48, None), (256, 24, None), (256, 96, None), (256, 0, None))
# what each probe patches in slab_read.cuh: (anchor, replacement) pairs
PROBES = {
    "even": (("{ return nx | 1; }", "{ return nx; }"),),
    "bounds": (("  phase([&](ReadThread& me) { read_bounds(a, tile, me, sh); });\n",
                "  phase([&](ReadThread& me) { read_bounds(a, tile, me, sh); });\n"
                "  return;\n"),),
    "stage": (("  phase([&](ReadThread& me) { read_sums<Kind>(",
               "  return;\n  phase([&](ReadThread& me) { read_sums<Kind>("),),
    "bcast": (("return cells[((cy - y0) * nz + cz - z0) * stride + cx - x0];",
               "return cells[(((cy - y0) * nz + cz - z0) * stride + cx - x0)"
               " & 7];"),),
}


def build_copy(csrc, tmp, patch=None):
    """g2p.cu and gather.cu of ``csrc`` (one nvcc each, at once) into one
    library; ``patch`` rewrites slab_read.cuh first. Returns (library,
    ptxas log by source)."""
    from softmac_tpu_torch.ops import build
    tmp.mkdir(parents=True)
    for f in Path(csrc).glob("*.cuh"):
        text = f.read_text()
        (tmp / f.name).write_text(patch(text) if patch and
                                  f.name == "slab_read.cuh" else text)
    jobs = []
    for name in SOURCES:
        (tmp / name).write_text((Path(csrc) / name).read_text())
        obj = tmp / (name + ".o")
        jobs.append((name, obj, subprocess.Popen(
            [build._nvcc(), *build.COMPILE_FLAGS, "-c", str(tmp / name),
             "-o", str(obj)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs = {}
    for name, obj, proc in jobs:
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {tmp / name}:\n{logs[name]}")
    so = tmp / "lib.so"
    subprocess.run([build._nvcc(), "-shared", "-o", str(so),
                    *(str(o) for _, o, _ in jobs)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(so)), logs


def patched(tile, kb, probe):
    def patch(src):
        for name, value in (("kReadTile", str(tile)),
                            ("kReadSmem", f"{kb} * 1024")):
            src, k = re.subn(rf"constexpr int {name} = [^;]+;",
                             f"constexpr int {name} = {value};", src)
            assert k == 1, name
        for name in probe.split("+") if probe else ():
            for anchor, text in PROBES[name]:
                assert anchor in src, name
                src = src.replace(anchor, text)
        return src
    return patch


def ptxas(logs, cs):
    """Registers and spill stores of each kernel of a copy."""
    text = "".join(f"== {name}\n{log}" for name, log in logs.items())
    return {src: [(f["registers"], f["spill_stores"]) for f in fns]
            for src, fns in cs.ptxas_by_source(text).items()}


class Call:
    """One tree's softmac_g2p or softmac_gather over buffers made once;
    calling it launches the kernel and returns its output (the same buffer
    each call)."""

    def __init__(self, fn, name, args, off_slab):
        import torch
        x, g0, g1, g2, corner, sizes, inv_dx = args
        n = x.shape[1]
        self.out = torch.empty((ROWS[name], n), device=x.device)
        # every tile's count, whatever the tile (a patched copy's)
        self.off = torch.zeros(n, dtype=torch.int32, device=x.device)
        ptrs = [t.data_ptr() for t in (x, g0, g1, g2, corner, self.out)]
        if off_slab:
            ptrs.append(self.off.data_ptr())
        stream = torch.cuda.current_stream(x.device).cuda_stream
        dims = [int(w) for w in sizes]
        self.launch = lambda: fn(*ptrs, n, *dims, float(inv_dx), stream)
        self.name = name

    def __call__(self):
        rc = self.launch()
        if rc != 0:
            raise RuntimeError(f"{self.name}: cudaError {rc}")
        return self.out


def bind(lib, off_slab):
    """A tree's two entry points with its own argument lists."""
    from softmac_tpu_torch.ops import build
    out = {}
    for name in ROWS:
        fn = getattr(lib, "softmac_" + name)
        sig = build.SIGNATURES["softmac_" + name]
        fn.argtypes = sig if off_slab else sig[:6] + sig[7:]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def row_rel(got, want):
    diff = (got.double() - want).abs()
    return (diff / want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)) \
        .max().item()


def main():
    import numpy as np
    import torch
    args = sys.argv[1:]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("read_ab: CUDA is not available", file=sys.stderr)
        return 2
    parent = Path(args[0]).resolve() / "softmac_tpu_torch/ops/csrc"
    only_variants = args[0] == "--variants"
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.ops import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    res = {"card": smi}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        this = bind(build.library(), True)
        if not only_variants:
            plib, plogs = build_copy(parent, tmp / "parent")
            trees = {"this": this, "parent": bind(plib, False)}
            res["parent_ptxas"] = ptxas(plogs, cs)
        env = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                         init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        inp = cs.kernel_inputs(env, env.rollout(
            cs.actions(cs.STATE_STEPS))["carry"])
        penv = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                          init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        pinp = cs.pour_kernel_inputs(penv, penv.rollout(
            np.zeros((cs.STATE_STEPS, penv.action_dim)))["carry"])
        gen = torch.Generator(device=inp["state"].x.device).manual_seed(12)
        states = {}
        for state, i, grids in (("pour_vel", inp, inp["grids"]),
                                ("pour", pinp, pinp["gvm"])):
            x = i["state"].x
            perm = torch.randperm(x.shape[1], generator=gen, device=x.device)
            rest = (*grids, i["corner"], i["sizes"], i["cfg"].inv_dx)
            states[state] = (x, *rest)
            states[state + " permuted"] = (x[:, perm].contiguous(), *rest)
        if only_variants:
            res["variants"] = variants(cs, tmp, states, this)
            states = {}
        for state, a in states.items():
            for name in ROWS:
                calls = {t: Call(fns[name], name, a, t == "this")
                         for t, fns in trees.items()}
                outs = {t: c().clone() for t, c in calls.items()}
                torch.cuda.synchronize()
                turns = [cs.cuda_time_ms(calls[t], 50) for t in ORDER]
                dev = {t: [] for t in trees}
                for t in ORDER:
                    dev[t].append(cs.device_ms(f"{name} {state} {t}",
                                               calls[t]))
                key = f"{name} {state}"
                res[key] = {
                    "parent_ms": turns[0::3], "this_ms": turns[1:3],
                    "parent_device_ms": dev["parent"],
                    "this_device_ms": dev["this"],
                    "max_abs_diff": (outs["this"] - outs["parent"]).abs()
                    .max().item(),
                    "max_abs": outs["parent"].abs().max().item(),
                    "bit_identical": bool(torch.equal(outs["this"],
                                                      outs["parent"])),
                    "this_off_slab": int(calls["this"].off.sum())}
                print(json.dumps({key: res[key]}), flush=True)
        if not only_variants:
            res["rollouts"] = rollout_turns(cs, build, trees, {
                "pour": (penv, np.zeros((20, penv.action_dim))),
                "pour_vel": (env, cs.actions(20))})
            res["pour_profile"] = profile_turns(cs, build, trees, penv)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


def variants(cs, tmp, states, this):
    """Each VARIANTS copy on the two sorted states: registers and spills,
    error against the float64 plain version, this tree's bits, call and
    device ms."""
    import torch
    from softmac_tpu_torch.ops import transfer
    out = {}
    built = {}
    for v in VARIANTS:
        built[v] = build_copy(ROOT / "softmac_tpu_torch/ops/csrc",
                              tmp / "v{}_{}_{}".format(*v).replace("+", "_"),
                              patched(*v))
    for v, (lib, logs) in built.items():
        fns = bind(lib, True)
        key = "tile {} budget {} KB".format(*v[:2]) + (
            f" (probe {v[2]})" if v[2] else "")
        res = {"ptxas": ptxas(logs, cs)}
        for state in ("pour_vel", "pour"):
            a = states[state]
            for name in ROWS:
                call = Call(fns[name], name, a, True)
                ref = Call(this[name], name, a, True)
                got, want = call().clone(), ref().clone()
                plain = getattr(transfer, name + "_plain")(
                    *(t.double() if torch.is_tensor(t)
                      and t.is_floating_point() else t for t in a))
                torch.cuda.synchronize()
                res[f"{name} {state}"] = {
                    "max_rel_err": row_rel(got, plain),
                    "this_bits": bool(torch.equal(got, want)),
                    "off_slab": int(call.off.sum()),
                    "ms": cs.cuda_time_ms(call, 50),
                    "device_ms": cs.device_ms(f"{key} {name} {state}", call)}
        out[key] = res
        print(json.dumps({key: res}), flush=True)
    return out


class _Routed:
    """This checkout's library with softmac_g2p / softmac_gather taken from
    a tree's (the parent's without the off-slab pointer, which its kernels
    do not take)."""

    def __init__(self, base, fns, off_slab):
        self.base, self.fns, self.off_slab = base, fns, off_slab

    def __getattr__(self, name):
        short = name[len("softmac_"):]
        if short not in ROWS:
            return getattr(self.base, name)
        fn = self.fns[short]
        if self.off_slab:
            return fn
        return lambda *a: fn(*a[:6], *a[7:])


def routed_libraries(build, trees):
    base = build.library()
    return {t: _Routed(base, fns, t == "this") for t, fns in trees.items()}


def rollout_turns(cs, build, trees, scenes):
    """Substeps/s of each scene's rollout with G2P and the gather from each
    tree's library, in turns (parent, this, this, parent)."""
    library = build.library
    routed = routed_libraries(build, trees)
    out = {}
    try:
        for name, (env, acts) in scenes.items():
            runs = {"parent": [], "this": []}
            n_sub = len(acts) * env.substeps
            for tree in ORDER:
                build.library = lambda lib=routed[tree]: lib
                cs.timed_rollout(env, acts)
                runs[tree].append(n_sub / cs.timed_rollout(env, acts)[1])
            out[name] = runs
            print(json.dumps({f"rollout {name}": runs}), flush=True)
    finally:
        build.library = library
    return out


def profile_turns(cs, build, trees, env):
    """The pour's device ms, busy share and launches a forward substep
    (chip_smoke.run_profile, 10 env steps) with each tree's G2P and
    gather, in turns (parent, this, this, parent)."""
    import numpy as np
    library = build.library
    routed = routed_libraries(build, trees)
    out = {"parent": [], "this": []}
    try:
        for tree in ORDER:
            build.library = lambda lib=routed[tree]: lib
            prof = cs.run_profile(env, np.zeros((10, env.action_dim)))
            out[tree].append({k: prof[k] for k in (
                "device_busy_ms_per_substep", "device_busy_share",
                "kernel_launches_per_substep", "wall_ms_per_substep")})
            out[tree][-1]["read_kernels"] = {
                k: v for k, v in prof["port_kernels"].items()
                if re.search(r"\b(g2p|gather)_kernel\(", k)}
    finally:
        build.library = library
    print(json.dumps({"pour profile": out}), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
