#!/usr/bin/env python3
"""Where the time of the penalty particle contact goes (pour_vel's
``collide_particle`` and its backward), on one CUDA card.

    python3 scripts/contact_phases.py [SRC_DIR]

Builds copies of ``contact.cu`` and ``contact_bwd.cu`` with the headers of
the ``csrc`` directory of SRC_DIR, a checkout of the repository (default:
this one), whose kernels return after each of their phases, and times
each copy's C entry points with CUDA events (50 calls after a warm-up)
and torch.profiler (device ms) on the inputs chip_smoke.py checks the
kernels on: pour_vel's 1e5-particle state after 10 env steps, window
(40, 32, 16), glass and bowl, with the main path's particles and with
particles spread over each body's SDF box (``chip_smoke.box_particles``,
many in contact), seeded normal cotangents. The phases are those of the
design each source holds (``STOPS``), each a copy's time the difference
to the one before it:
- the first design (one thread a particle; checkouts before the tiled
  pair): the forward's load and locate (x, v, the cell and its stencil
  row), then the full kernel; the backward's load and locate (and the
  impulse cotangent), the forward again (in double), the reverse sweep,
  then the full kernel with its block reduction;
- the tiled design (``contact_mixed.cuh``'s skeleton with the penalty
  ops): the classification and the out-of-band writes, the compaction,
  the full math, the block's sums, then the full kernel with the last
  block; and the full kernels at other tiles (256 to 2048 particles a
  block) and at one or two blocks an SM, each copy's registers and spills
  from ptxas.
Then, with this checkout's Python (``engine.contact.collide_particle``
and its autograd), a body's forward and its backward for cotangents of
the impulse and the wrench, profiled by kernel name: launches a call and
device ms of each name. Prints one JSON object; the card's name and power
limit on the lines around it. Needs a card and nvcc; exits non-zero
without them.
"""
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("contact.cu", "contact_bwd.cu")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# the first design's kernels (one thread a particle) stopped after a phase:
# every thread past n returns first, so that no block waits at a barrier
_FIRST_START = ("  const int p = blockIdx.x * blockDim.x + t;\n",
                "  const int p = blockIdx.x * blockDim.x + t;\n"
                "  if (p >= n) return;\n")
_FIRST_LOAD = (
    "    const softmac::Body<{T}> b_ = b;\n"
    "    const softmac::V3<{T}> nvc = {{-b_.nv.x, -b_.nv.y, -b_.nv.z}};\n"
    "    const softmac::Cell<{T}> cell = softmac::locate(\n"
    "        softmac::qrot(b_.nw, nvc, xp - b_.bp), table, g);\n"
    "    float s = float(vp.x + vp.y + vp.z){extra};\n"
    "    for (int c = 0; c < 8; ++c) {{\n"
    "      const float4 e = __ldg(cell.row + c);\n"
    "      s += e.x + e.y + e.z + e.w;\n"
    "    }}\n"
    "    {out}[p] = s;\n    return;\n")
STOPS = {
    "first": {
        "contact.cu": {
            "load": (("  const softmac::Contact<float> k =\n",
                      _FIRST_LOAD.format(T="float", extra="", out="imp")
                      + "  const softmac::Contact<float> k =\n"),),
        },
        "contact_bwd.cu": {
            "load": (_FIRST_START,
                     ("    const softmac::Contact<double> k = ",
                      _FIRST_LOAD.format(
                          T="double", out="dx",
                          extra=" + gimp[p] + gimp[n + p] + gimp[2 * n + p]")
                      + "    const softmac::Contact<double> k = ")),
            "forward": (_FIRST_START,
                        ("    V3 gx, gv;\n",
                         "    dx[p] = float(k.imp.x + k.imp.y + k.imp.z + "
                         "gi.x + gi.y + gi.z);\n    return;\n"
                         "    V3 gx, gv;\n")),
            "sweep": (_FIRST_START,
                      ("    dv[2 * n + p] = static_cast<float>(gv.z);\n",
                       "    dv[2 * n + p] = static_cast<float>(gv.z);\n"
                       "    double s = 0.0;\n"
                       "    for (int i = 0; i < 14; ++i) s += gb[i];\n"
                       "    dx[p] += float(s);\n    return;\n")),
        },
    },
    # the tiled design: returns in contact_mixed.cuh's skeleton (shared
    # with the mixed pair), after (True) or before (False) each anchor
    "tiled": {
        "classify": ("      if (!band[j]) Op::out_of_band(a, p0 + q, keep[j]);"
                     "\n    }\n  }\n", True),
        "compact": ("  for (int c = warp; c < chunks; c += kMixedWarps) "
                    "mixed_place(&sh, c, lane);\n  __syncthreads();\n",
                    True),
        "full_math": ("  mixed_warp_trees<K>(acc, &sh);\n"
                      "  __syncthreads();\n  mixed_block_sum<K>", False),
        "block_sum": ("  mixed_block_sum<K>(a, &sh, blockIdx.x, gridDim.x);\n",
                      True),
    },
}
# the tiled design's other shapes: particles a thread (forward and
# backward alike) and blocks an SM
TILED_PER = r"constexpr int (kMixedPer|kMixedBwdPer) = \d+;"
TILED_BOUNDS = r"__launch_bounds__\(softmac::kMixedThreads(, \d)?\)"
PERS = (1, 2, 4, 8)


def design(csrc):
    """"tiled" where contact.cu runs contact_mixed.cuh's skeleton, else
    "first"."""
    src = (csrc / "contact.cu").read_text()
    return "tiled" if '#include "contact_mixed.cuh"' in src else "first"


def copy_sources(d, csrc, edit=None):
    """contact.cu, contact_bwd.cu and every header of ``csrc`` into ``d``,
    ``edit(name, text)`` applied to each."""
    for f in [csrc / s for s in SOURCES] + sorted(csrc.glob("*.cuh")):
        text = f.read_text()
        (d / f.name).write_text(edit(f.name, text) if edit else text)


def _replace(text, old, new, what):
    if old not in text:
        raise RuntimeError(f"{what}: the source changed (no {old[:50]!r})")
    return text.replace(old, new, 1)


def variants(csrc, kind):
    """{name: edit} of every copy to build for the design ``kind``."""
    out = {"full": None}
    if kind == "first":
        for src, stops in STOPS["first"].items():
            for phase, reps in stops.items():
                def edit(name, text, src=src, reps=reps, key=phase):
                    if name != src:
                        return text
                    for old, new in reps:
                        text = _replace(text, old, new, f"{src} {key}")
                    return text
                out[f"{src.split('.')[0]} {phase}"] = edit
        return out
    for phase, (anchor, after) in STOPS["tiled"].items():
        def edit(name, text, anchor=anchor, after=after, key=phase):
            if name != "contact_mixed.cuh":
                return text
            return _replace(text, anchor, anchor + "  return;\n" if after
                            else "  return;\n" + anchor, key)
        out[phase] = edit
    for per in PERS:
        def edit(name, text, per=per):
            if name != "contact_mixed.cuh":
                return text
            if len(re.findall(TILED_PER, text)) != 2:
                raise RuntimeError("contact_mixed.cuh changed: no tiles")
            return re.sub(TILED_PER, rf"constexpr int \1 = {per};", text)
        out[f"tile {per * 256}"] = edit
    for blocks in (1, 2):
        def edit(name, text, blocks=blocks):
            if name not in SOURCES:
                return text
            if not re.search(TILED_BOUNDS, text):
                raise RuntimeError(f"{name} changed: no launch bounds")
            return re.sub(TILED_BOUNDS, "__launch_bounds__(softmac::"
                          f"kMixedThreads, {blocks})", text)
        out[f"blocks {blocks}"] = edit
    return out


def ptxas(log):
    """[(function, registers, spill stores)] of an ``nvcc -Xptxas -v``
    log."""
    out, fn, spill = [], None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif "Used" in ln and "registers" in ln:
            out.append((fn, int(re.search(r"Used (\d+) registers",
                                          ln).group(1)), spill))
    return out


def signatures(kind):
    """The argument types of the two entry points of a design."""
    if kind == "first":
        return {"softmac_collide_particle": [_P] * 6 + [_I] * 4 + [_F] * 9
                + [_P],
                "softmac_collide_particle_bwd": [_P] * 8 + [_I] * 4
                + [_F] * 9 + [_P]}
    return {"softmac_collide_particle": [_P] * 12 + [_I] * 4 + [_F] * 9
            + [_P],
            "softmac_collide_particle_bwd": [_P] * 15 + [_I] * 4 + [_F] * 9
            + [_P]}


def calls(lib, kind, cargs, gimp, gwrench):
    """(forward, backward) calls of a built copy's entry points on
    ``cargs`` (ops.contact.collide_particle's arguments), their buffers
    made once and sized for the smallest tile."""
    import torch
    from softmac_tpu_torch.ops import contact
    prim, bp, bq, bv, bw, fr, x, v, dt, p_mass = cargs
    n, dev = x.shape[1], x.device
    f32 = lambda *s: torch.empty(s, device=dev)  # noqa: E731
    imp, dx, dv = f32(3, n), f32(3, n), f32(3, n)
    blocks = -(-n // 256)
    geo = (*prim.res, *prim.geom, float(dt), float(p_mass))
    stream = torch.cuda.current_stream(dev).cuda_stream
    table = prim.neighborhood.data_ptr()
    if kind == "first":
        body = torch.cat([bp, bq, bv, bw, fr.reshape(1)]).contiguous()
        mask = torch.empty((n,), dtype=torch.bool, device=dev)
        part = f32(14, blocks)
        fwd_args = (x.data_ptr(), v.data_ptr(), table, body.data_ptr(),
                    imp.data_ptr(), mask.data_ptr(), n, *geo, stream)
        bwd_args = (x.data_ptr(), v.data_ptr(), table, body.data_ptr(),
                    gimp.data_ptr(), dx.data_ptr(), dv.data_ptr(),
                    part.data_ptr(), n, *geo, stream)
        keep = (body, mask, part)
    else:
        ptrs = (x.data_ptr(), v.data_ptr(), table) + tuple(
            t.data_ptr() for t in (bp, bq, bv, bw, fr))
        wrench, db = f32(6), f32(14)
        part = torch.empty((14, blocks), dtype=torch.float64, device=dev)
        done, _ = contact._done(x)
        fwd_args = (*ptrs, imp.data_ptr(), wrench.data_ptr(),
                    part.data_ptr(), done, n, *geo, stream)
        bwd_args = (*ptrs, gimp.data_ptr(), gwrench.data_ptr(),
                    dx.data_ptr(), dv.data_ptr(), db.data_ptr(),
                    part.data_ptr(), done, n, *geo, stream)
        keep = (wrench, db, part)

    def fwd():
        rc = lib.softmac_collide_particle(*fwd_args)
        if rc:
            raise RuntimeError(f"forward copy: cudaError {rc}")

    def bwd():
        rc = lib.softmac_collide_particle_bwd(*bwd_args)
        if rc:
            raise RuntimeError(f"backward copy: cudaError {rc}")
    fwd.keep = bwd.keep = (keep, imp, dx, dv)
    return fwd, bwd


def by_name(fn, iters=10):
    """{kernel name: [launches a call, device ms a call]} of ``fn`` from
    torch.profiler over ``iters`` calls after a warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c, t = out.get(e.name[:80], (0.0, 0.0))
            out[e.name[:80]] = (c + 1 / iters,
                                t + e.time_range.elapsed_us() / 1e3 / iters)
    return out


def engine_calls(cargs, gimp, gwrench):
    """This checkout's ``engine.contact.collide_particle`` on ``cargs``:
    (its forward, the backward of its two outputs under autograd for the
    cotangents gimp and gwrench)."""
    import torch
    from softmac_tpu_torch.engine import contact as econtact
    prim, rest = cargs[0], cargs[8:]
    ins = [t.detach().clone().requires_grad_() for t in cargs[1:8]]

    def fwd():
        with torch.no_grad():
            return econtact.collide_particle(prim, *cargs[1:8], *rest)
    with torch.enable_grad():
        imp, wr = econtact.collide_particle(prim, *ins, *rest)

    def bwd():
        return torch.autograd.grad((imp, wr), ins, (gimp, gwrench),
                                   retain_graph=True)
    return fwd, bwd


def main():
    import torch
    if not torch.cuda.is_available():
        print("contact_phases: CUDA is not available", file=sys.stderr)
        return 2
    csrc = (Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT) \
        / "softmac_tpu_torch/ops/csrc"
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.ops import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    kind = design(csrc)
    res = {"card": smi, "design": kind, "sources": str(csrc), "ms": {},
           "device_ms": {}, "ptxas": {}, "contacts": {}, "engine": {}}
    env = SoftMacEnv(cs.pour_vel_cfg(cs.WINDOW),
                     init_particles=cs.tiled_pour_particles(cs.N_MAIN))
    inp = cs.kernel_inputs(env, env.rollout(
        cs.actions(cs.STATE_STEPS))["carry"])
    cfg, st = inp["cfg"], inp["state"]
    x, v, n = st.x, st.v, st.x.shape[1]
    gen = torch.Generator(device=x.device).manual_seed(0)
    states = {}
    for b, (prim, bp, bq, bv, bw, fr) in enumerate(inp["contacts"]):
        x_box = cs.box_particles(prim, bp, bq, n, gen)
        for xs, label in ((x, "main"), (x_box, "box")):
            cargs = (prim, bp, bq, bv, bw, fr, xs, v, cfg.dt, cfg.p_mass)
            from softmac_tpu_torch.ops import contact
            mask = contact.collide_particle_plain(
                cs._prim64(prim), *map(cs._f64, cargs[1:8]), cfg.dt,
                cfg.p_mass)[1]
            states[f"body {b} {label}"] = cargs
            res["contacts"][f"body {b} {label}"] = int(mask.sum())
    rng = torch.Generator(device=x.device).manual_seed(1)
    cts = {k: (torch.randn((3, n), generator=rng, device=x.device),
               torch.randn((6,), generator=rng, device=x.device))
           for k in states}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, edit in variants(csrc, kind).items():
            d = Path(tmp) / name.replace(" ", "_")
            d.mkdir()
            copy_sources(d, csrc, edit)
            so = d / "lib.so"
            jobs[name] = (so, subprocess.Popen(
                [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-o",
                 str(so)] + [str(d / s) for s in SOURCES],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({name}):\n{log}")
            res["ptxas"][name] = ptxas(log)
            lib = ctypes.CDLL(str(so))
            for fn, types in signatures(kind).items():
                getattr(lib, fn).argtypes = types
                getattr(lib, fn).restype = ctypes.c_int
            # a first-design stop is one kernel's: time that one only
            which = ("fwd", "bwd") if " " not in name or kind == "tiled" \
                else (("fwd",) if name.startswith("contact ") else ("bwd",))
            for label, cargs in states.items():
                pair = dict(zip(("fwd", "bwd"),
                                calls(lib, kind, cargs, *cts[label])))
                for d in which:
                    key = f"{d} {name} {label}"
                    res["ms"][key] = cs.cuda_time_ms(pair[d], 50)
                    res["device_ms"][key] = cs.device_ms(key, pair[d])
                    print(json.dumps({key: res["device_ms"][key]}),
                          flush=True)
    for label, cargs in states.items():
        fwd, bwd = engine_calls(cargs, *cts[label])
        res["engine"][label] = {"fwd": by_name(fwd), "bwd": by_name(bwd)}
        print(label, json.dumps(res["engine"][label]), flush=True)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
