#!/usr/bin/env python3
"""The read-side tile kernels of two checkouts on one CUDA card, in turns.

    python3 scripts/read_ab.py PARENT_DIR
    python3 scripts/read_ab.py --variants [PROBES ...]

Builds ``g2p.cu``, ``gather.cu``, ``p2g_bwd.cu`` and ``splat_bwd.cu`` of
PARENT_DIR (a checkout of the repository, with its own headers) into a
library of their own, and loads this checkout's kernel library. The C
entry points keep their names (``softmac_g2p``, ``softmac_gather``,
``softmac_p2g_bwd``, ``softmac_splat_bwd``) across the trees; in this
checkout each takes each tile's off-slab count (ops/csrc/slab_read.cuh)
as its last pointer, and a parent's entry point that does not (read from
its source) gets the same buffers without it. On the 1e5-particle states
that chip_smoke.py checks the kernels on (pour_vel after 10 env steps,
window (40, 32, 16); the flagship pour after 10 env steps, (32, 32, 16);
each also in a random permutation of its particles; G2P and the gather on
their grids, the P2G backward on the state's channels with seeded normal
window cotangents, the splat backward on the pour's real values, -2 dv,
and on seeded normal values on pour_vel, with a seeded normal window
cotangent) it calls each kernel in turns (parent, this, this, parent):
call ms with CUDA events (50 calls after a warm-up), device ms with
torch.profiler (10 calls), how far the two trees' outputs differ, and
this tree's off-slab count. Then the pour's forward rollout and its and
pour_vel's rollout_and_grad (20 env steps after a warm-up, remat "none",
host clock after a synchronize) and the pour's fwd+bwd device ms and
launches a substep (chip_smoke.run_profile over 10 env steps, the four
kernels' device ms a launch) with ``transfer``'s four kernels routed to
each tree's library in turns (parent, this, this, parent), everything
else this checkout's. Before those, the call ms of the wrappers
``transfer.p2g_bwd`` and ``transfer.splat_bwd`` of each tree (the
parent's ``ops/transfer.py`` over its own entry points) on the two sorted
states, in turns.

With ``--variants`` (no parent) it builds copies of this tree's four
sources with slab_read.cuh's tile and slab budget patched, and probes
patched in (VARIANTS; with PROBES, only the copies at the kernels' tile
and budget whose probes are those named, "none" for no probe), and gives
each copy's registers, spills and stack frame and, on
the two sorted states, its largest error against the float64 plain
version or vjp (each output row against its largest |value|), whether
its outputs are this tree's bits, its off-slab count, and its call and
device ms.

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
KERNELS = ("g2p", "gather", "p2g_bwd", "splat_bwd")
SOURCES = tuple(k + ".cu" for k in KERNELS)
ORDER = ("parent", "this", "this", "parent")
WRAPPER_CALLS = 200
# each kernel's outputs, by rows (a column a particle)
OUT_ROWS = {"g2p": (12,), "gather": (3,), "p2g_bwd": (3, 13),
            "splat_bwd": (3, 3)}
# (particles a block, slab budget in KB, probes or None, several joined by
# "+"); a budget of 0 stages nothing (every particle from device memory).
# The probes: "even" stages box rows at their own width
# (read_stride: not made odd); "bounds" returns after the tile's bounds,
# "stage" before the sums (the bounds and the staging alone), "bcast"
# reads every slab cell from the slab's first 8 (no bank conflicts: what
# the sums cost without them; wrong outputs); "blocks2", "blocks3" and
# "blocks4" set kReadBlocks (the blocks an SM of every read-side
# kernel's launch bounds) to 2, 3 or 4; "noremake" lets the P2G backward's sweep keep each axis's weights
# and derivatives live (stencil_adjoint without kRemake: it spills at
# three blocks an SM); the splat backward's warp vote becomes "branch" a
# particle's own
# test (a warp with one particle in the band takes the gather and then
# the sweep), "noband" the sweep for every particle (what the band
# saves), "nosweep" the gather alone for every particle (what the band's
# sweep costs; wrong dx)
VARIANTS = ((256, 48, None), (256, 48, "bounds"), (256, 48, "stage"),
            (256, 48, "bcast"), (256, 48, "even"), (256, 48, "blocks2"),
            (256, 48, "blocks3"), (256, 48, "blocks4"), (256, 48, "noremake"),
            (256, 48, "noremake+blocks2"), (256, 48, "branch"),
            (256, 48, "noband"), (256, 48, "nosweep"), (128, 48, None),
            (512, 48, None), (256, 24, None), (256, 96, None),
            (256, 0, None))
# the splat backward's vote, which "branch", "noband" and "nosweep" replace
VOTE = ("if (!__any_sync(__activemask(),\n"
        "                    val[0] != 0.f || val[1] != 0.f || val[2] != 0.f)) {")
# what each probe patches: (file, anchor, replacement)
PROBES = {
    "even": (("slab_read.cuh", "{ return nx | 1; }", "{ return nx; }"),),
    "bounds": (("slab_read.cuh",
                "  phase([&](Thread& me) { read_bounds(a, tile, me, sh); });\n",
                "  phase([&](Thread& me) { read_bounds(a, tile, me, sh); });\n"
                "  return;\n"),),
    "stage": (("slab_read.cuh",
               "  phase([&](Thread& me) { read_sums<Kind>(",
               "  return;\n  phase([&](Thread& me) { read_sums<Kind>("),),
    "bcast": (("slab_read.cuh",
               "return cells[((cy - y0) * nz + cz - z0) * stride + cx - x0];",
               "return cells[(((cy - y0) * nz + cz - z0) * stride + cx - x0)"
               " & 7];"),),
    **{f"blocks{b}": (("slab_read.cuh", "kReadBlocks = 3;",
                       f"kReadBlocks = {b};"),)
       for b in (2, 3, 4)},
    "noremake": (("p2g_bwd.cu", "stencil_adjoint<true>(",
                  "stencil_adjoint<false>("),),
    "branch": (("splat_bwd.cu", VOTE,
                "if (val[0] == 0.f && val[1] == 0.f && val[2] == 0.f) {"),),
    "noband": (("splat_bwd.cu", VOTE, "if (false) {"),),
    "nosweep": (("splat_bwd.cu", VOTE, "if (true) {"),),
}


def build_copy(csrc, tmp, patch=None):
    """The four sources of ``csrc`` (one nvcc each, at once) into one
    library; ``patch(file name, text)`` rewrites each source and header
    first. Returns (library, ptxas log by source)."""
    from softmac_tpu_torch.ops import build
    tmp.mkdir(parents=True)
    for f in [*Path(csrc).glob("*.cuh"), *(Path(csrc) / s for s in SOURCES)]:
        text = f.read_text()
        (tmp / f.name).write_text(patch(f.name, text) if patch else text)
    jobs = []
    for name in SOURCES:
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
    def patch(fname, src):
        if fname == "slab_read.cuh":
            for name, value in (("kReadTile", str(tile)),
                                ("kReadSmem", f"{kb} * 1024")):
                src, k = re.subn(rf"constexpr int {name} = [^;]+;",
                                 f"constexpr int {name} = {value};", src)
                assert k == 1, name
        for name in probe.split("+") if probe else ():
            for target, anchor, text in PROBES[name]:
                if target == fname:
                    assert anchor in src, name
                    src = src.replace(anchor, text)
        return src
    return patch


def ptxas(logs, cs):
    """Registers, spill stores and stack frame bytes of each kernel of a
    copy."""
    text = "".join(f"== {name}\n{log}" for name, log in logs.items())
    return {src: [(f["registers"], f["spill_stores"], f["stack_bytes"])
                  for f in fns]
            for src, fns in cs.ptxas_by_source(text).items()}


def takes_off_slab(csrc, name):
    """Whether the entry point softmac_<name> of the sources ``csrc`` takes
    an off-slab pointer."""
    src = (Path(csrc) / f"{name}.cu").read_text()
    head = src.split(f'extern "C" int softmac_{name}(', 1)[1].split(")", 1)[0]
    return "off_slab" in head


class Call:
    """One tree's entry point of kernel ``name`` over buffers made once;
    calling it launches the kernel and returns its outputs (the same
    buffers each call). ``ins`` the pointers before the outputs, in the
    entry point's order."""

    def __init__(self, fn, name, ins, sizes, inv_dx, off_slab):
        import torch
        x = ins[0]
        n = x.shape[1]
        self.outs = tuple(torch.empty((r, n), device=x.device)
                          for r in OUT_ROWS[name])
        # every tile's count, whatever the tile (a patched copy's)
        self.off = torch.zeros(n, dtype=torch.int32, device=x.device)
        ptrs = [t.data_ptr() for t in (*ins, *self.outs)]
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
        return self.outs


def _leading_pointers(sig):
    return next(i for i, t in enumerate(sig) if t is not ctypes.c_void_p)


def bind(lib, off_slab):
    """A tree's four entry points with its own argument lists: this
    tree's, less the off-slab pointer (the last leading one) where
    ``off_slab[name]`` is false."""
    from softmac_tpu_torch.ops import build
    out = {}
    for name in KERNELS:
        fn = getattr(lib, "softmac_" + name)
        sig = build.SIGNATURES["softmac_" + name]
        k = _leading_pointers(sig) - 1
        fn.argtypes = sig if off_slab[name] else sig[:k] + sig[k + 1:]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def row_rel(got, want):
    diff = (got.double() - want).abs()
    return (diff / want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)) \
        .max().item()


def kernel_args(i, grids, vals, gen):
    """Each kernel's (pointers before its outputs, window, inv_dx) on a
    state: G2P and the gather its grids, the P2G backward its channels and
    seeded normal cotangents, the splat backward ``vals`` and a seeded
    normal cotangent."""
    import torch
    x, corner, sizes = i["state"].x, i["corner"], i["sizes"]
    wx, wy, wz = sizes

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=x.device)
    rest = (sizes, i["cfg"].inv_dx)
    return {"g2p": ((x, *grids, corner),) + rest,
            "gather": ((x, *grids, corner),) + rest,
            "p2g_bwd": ((x, i["chan"], corner, normal(wy * wz, wx),
                         normal(wy * wz, 3 * wx)),) + rest,
            "splat_bwd": ((x, vals, corner, normal(wy * wz, 3 * wx)),)
            + rest}


def permuted(args, perm):
    """The same arguments with the particles (x and the backwards' particle
    rows: the first two pointers of a backward) in another order."""
    out = {}
    for name, (ins, sizes, inv_dx) in args.items():
        cols = (0,) if name in ("g2p", "gather") else (0, 1)
        out[name] = (tuple(t[:, perm].contiguous() if j in cols else t
                           for j, t in enumerate(ins)), sizes, inv_dx)
    return out


def plain(name, ins, sizes, inv_dx):
    """The float64 plain version or vjp of ``name`` on ``ins``."""
    import torch
    from softmac_tpu_torch.ops import transfer
    d = [t.double() if t.is_floating_point() else t for t in ins]
    if name in ("g2p", "gather"):
        return (getattr(transfer, name + "_plain")(*d, sizes, inv_dx),)
    x, rows, corner, *cot = d
    fn = getattr(transfer, name.replace("_bwd", "_vjp_plain"))
    return tuple(fn(x, rows, corner, sizes, inv_dx, *cot))


def main():
    import numpy as np
    import torch
    args = sys.argv[1:]
    if len(args) != 1 and args[:1] != ["--variants"]:
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
        this = bind(build.library(), dict.fromkeys(KERNELS, True))
        if not only_variants:
            plib, plogs = build_copy(parent, tmp / "parent")
            p_off = {k: takes_off_slab(parent, k) for k in KERNELS}
            trees = {"this": this, "parent": bind(plib, p_off)}
            offs = {"this": dict.fromkeys(KERNELS, True), "parent": p_off}
            res["parent_ptxas"] = ptxas(plogs, cs)
            res["parent_takes_off_slab"] = p_off
        env = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                         init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        inp = cs.kernel_inputs(env, env.rollout(
            cs.actions(cs.STATE_STEPS))["carry"])
        penv = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                          init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        pinp = cs.pour_kernel_inputs(penv, penv.rollout(
            np.zeros((cs.STATE_STEPS, penv.action_dim)))["carry"])
        gen = torch.Generator(device=inp["state"].x.device).manual_seed(12)
        res["pour_nonzero_vals"] = int((pinp["vals"] != 0).any(dim=0).sum())
        states = {}
        for state, i, grids, vals in (
                ("pour_vel", inp, inp["grids"],
                 torch.randn(inp["state"].x.shape, generator=gen,
                             device=inp["state"].x.device)),
                ("pour", pinp, pinp["gvm"], pinp["vals"])):
            x = i["state"].x
            perm = torch.randperm(x.shape[1], generator=gen, device=x.device)
            states[state] = kernel_args(i, grids, vals, gen)
            states[state + " permuted"] = permuted(states[state], perm)
        if only_variants:
            res["variants"] = variants(cs, tmp, states, this, args[1:])
            states = {}
        for state, by_name in states.items():
            for name, (ins, sizes, inv_dx) in by_name.items():
                calls = {t: Call(fns[name], name, ins, sizes, inv_dx,
                                 offs[t][name])
                         for t, fns in trees.items()}
                outs = {t: [o.clone() for o in c()]
                        for t, c in calls.items()}
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
                    "max_abs_diff": max(
                        (a - b).abs().max().item() if a.numel() else 0.0
                        for a, b in zip(outs["this"], outs["parent"])),
                    "max_abs": max(b.abs().max().item() if b.numel() else 0.0
                                   for b in outs["parent"]),
                    "bit_identical": all(
                        torch.equal(a, b)
                        for a, b in zip(outs["this"], outs["parent"])),
                    "this_off_slab": int(calls["this"].off.sum())}
                print(json.dumps({key: res[key]}), flush=True)
        if not only_variants:
            res["wrappers"] = wrapper_turns(
                cs, Path(args[0]).resolve(), trees,
                {s: states[s] for s in ("pour_vel", "pour")})
            res["rollouts"] = rollout_turns(cs, build, trees, offs, {
                "pour": (penv, np.zeros((20, penv.action_dim)), False),
                "pour_grad": (penv, np.zeros((20, penv.action_dim)), True),
                "pour_vel_grad": (env, cs.actions(20), True)})
            res["pour_grad_profile"] = profile_turns(cs, build, trees, offs,
                                                     penv)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


def variants(cs, tmp, states, this, probes=()):
    """Each VARIANTS copy (or those at tile 256 and 48 KB whose probe is in
    ``probes``, "none" for no probe) on the two sorted states: registers,
    spills and stack frame, error against the float64 plain version or
    vjp, this tree's bits, call and device ms."""
    import torch
    out = {}
    built = {}
    for v in VARIANTS:
        if probes and not (v[:2] == (256, 48) and (v[2] or "none") in probes):
            continue
        built[v] = build_copy(ROOT / "softmac_tpu_torch/ops/csrc",
                              tmp / "v{}_{}_{}".format(*v).replace("+", "_"),
                              patched(*v))
    for v, (lib, logs) in built.items():
        fns = bind(lib, dict.fromkeys(KERNELS, True))
        key = "tile {} budget {} KB".format(*v[:2]) + (
            f" (probe {v[2]})" if v[2] else "")
        res = {"ptxas": ptxas(logs, cs)}
        for state in ("pour_vel", "pour"):
            for name, (ins, sizes, inv_dx) in states[state].items():
                call = Call(fns[name], name, ins, sizes, inv_dx, True)
                ref = Call(this[name], name, ins, sizes, inv_dx, True)
                got = [o.clone() for o in call()]
                want = [o.clone() for o in ref()]
                exact = plain(name, ins, sizes, inv_dx)
                torch.cuda.synchronize()
                res[f"{name} {state}"] = {
                    "max_rel_err": max(row_rel(g, e)
                                       for g, e in zip(got, exact)),
                    "this_bits": all(torch.equal(g, w)
                                     for g, w in zip(got, want)),
                    "off_slab": int(call.off.sum()),
                    "ms": cs.cuda_time_ms(call, 50),
                    "device_ms": cs.device_ms(f"{key} {name} {state}", call)}
        out[key] = res
        print(json.dumps({key: res}), flush=True)
    return out


def wrapper_turns(cs, parent_root, trees, states):
    """Call ms of the wrappers ``transfer.p2g_bwd`` and
    ``transfer.splat_bwd``, this tree's against the parent's (its
    ops/transfer.py loaded as a module of its own over the parent's entry
    points), in turns (parent, this, this, parent): CUDA events over
    WRAPPER_CALLS calls, host work included. Beside them, the same
    events around the allocation of one call's off-slab counts alone."""
    import importlib.util
    import types
    import torch
    from softmac_tpu_torch.ops import build, transfer
    spec = importlib.util.spec_from_file_location(
        "parent_transfer", parent_root / "softmac_tpu_torch/ops/transfer.py")
    ptransfer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ptransfer)
    plib = types.SimpleNamespace(**{"softmac_" + k: fn
                                    for k, fn in trees["parent"].items()})
    ptransfer.build = types.SimpleNamespace(
        library=lambda: plib, check=build.check, on_cpu=build.on_cpu)
    mods = {"parent": ptransfer, "this": transfer}
    out = {}
    for state, by_name in states.items():
        for name in ("p2g_bwd", "splat_bwd"):
            ins, sizes, inv_dx = by_name[name]

            def call(t, fn_name=name, ins=ins, sizes=sizes, inv_dx=inv_dx):
                return getattr(mods[t], fn_name)(*ins[:3], sizes, inv_dx,
                                                 *ins[3:])
            same = all(torch.equal(a, b) for a, b in zip(call("parent"),
                                                         call("this")))
            turns = [cs.cuda_time_ms(lambda t=t: call(t), WRAPPER_CALLS)
                     for t in ORDER]
            x = ins[0]
            alloc = cs.cuda_time_ms(lambda: torch.empty(
                -(-x.shape[1] // transfer.READ_TILE), dtype=torch.int32,
                device=x.device), WRAPPER_CALLS)
            key = f"{name} {state}"
            out[key] = {"parent_call_ms": turns[0::3],
                        "this_call_ms": turns[1:3],
                        "off_slab_alloc_ms": alloc, "same_outputs": same}
            print(json.dumps({f"wrapper {key}": out[key]}), flush=True)
    return out


class _Routed:
    """This checkout's library with the four read-side entry points taken
    from a tree's (without the off-slab pointer where that tree's kernel
    does not take it)."""

    def __init__(self, base, fns, off_slab):
        self.base, self.fns, self.off_slab = base, fns, off_slab

    def __getattr__(self, name):
        short = name[len("softmac_"):]
        if short not in KERNELS:
            return getattr(self.base, name)
        from softmac_tpu_torch.ops import build
        fn = self.fns[short]
        if self.off_slab[short]:
            return fn
        k = _leading_pointers(build.SIGNATURES[name]) - 1
        return lambda *a: fn(*a[:k], *a[k + 1:])


def routed_libraries(build, trees, offs):
    base = build.library()
    return {t: _Routed(base, fns, offs[t]) for t, fns in trees.items()}


def rollout_turns(cs, build, trees, offs, scenes):
    """Substeps/s of each scene's rollout (or rollout_and_grad, remat
    "none") with the four kernels from each tree's library, in turns
    (parent, this, this, parent)."""
    library = build.library
    routed = routed_libraries(build, trees, offs)
    out = {}
    try:
        for name, (env, acts, grad) in scenes.items():
            runs = {"parent": [], "this": []}
            n_sub = len(acts) * env.substeps

            def run():
                if grad:
                    return cs.timed_grad(env, acts, "none")[1]
                return cs.timed_rollout(env, acts)[1]
            for tree in ORDER:
                build.library = lambda lib=routed[tree]: lib
                run()
                runs[tree].append(n_sub / run())
            out[name] = runs
            print(json.dumps({f"rollout {name}": runs}), flush=True)
    finally:
        build.library = library
    return out


def profile_turns(cs, build, trees, offs, env):
    """The pour's device ms, busy share and launches a fwd+bwd substep
    (chip_smoke.run_profile, rollout_and_grad of 10 env steps) with each
    tree's four kernels, in turns (parent, this, this, parent)."""
    import numpy as np
    library = build.library
    routed = routed_libraries(build, trees, offs)
    out = {"parent": [], "this": []}
    try:
        for tree in ORDER:
            build.library = lambda lib=routed[tree]: lib
            prof = cs.run_profile(env, np.zeros((10, env.action_dim)),
                                  grad=True)
            out[tree].append({k: prof[k] for k in (
                "device_busy_ms_per_substep", "device_busy_share",
                "kernel_launches_per_substep", "wall_ms_per_substep")})
            out[tree][-1]["read_kernels"] = {
                k: v for k, v in prof["port_kernels"].items()
                if re.search(r"\b(g2p|gather|p2g_bwd|splat_bwd)_kernel\(",
                             k)}
    finally:
        build.library = library
    print(json.dumps({"pour grad profile": out}), flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
