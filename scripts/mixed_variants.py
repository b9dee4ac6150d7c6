#!/usr/bin/env python3
"""The tiled mixed-contact kernels' tile and occupancy, on one CUDA card.

    python3 scripts/mixed_variants.py

Builds the kernel library and copies of contact_mixed.cu and
contact_mixed_bwd.cu over a patched contact_mixed.cuh: copies whose
tiled kernels take 512, 1024 or 2048 particles a block (kMixedPer and
kMixedBwdPer, forward and backward alike; each kernel keeps its launch
bounds); copies at 512 and 1024 whose kernels both carry
__launch_bounds__(256) (one block an SM) or (256, 2) (two blocks), with
what ptxas reports for them (registers, spill stores); and copies at the
library's tiles whose kernels return after each phase (the
classification, the compaction, the full math, the block's sums; a
phase's device time is the difference to the one before it, the full
kernel's the last). On the states chip_smoke.py checks the mixed
contact on (the 1e5-particle flagship pour after 10 env steps, glass and
bowl, and 1e5 particles of the glass's SDF box all in the contact band) it
holds the library's tiled forward and backward against the float64 plain
version and its vjp, counts the band's particles (all and in the fullest
tile), and times every build with CUDA events (call time, 50 calls after
a warm-up) and torch.profiler (device time).
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
TILES = (512, 1024, 2048)
BOUNDS = r"__launch_bounds__\(softmac::kMixedThreads(, 2)?\)"
PER = r"constexpr int (kMixedPer|kMixedBwdPer) = \d+;"
# each phase's end in contact_mixed.cuh's mixed_tiled, and whether the
# copy returns after it (else before it)
STOPS = {
    "classify": ("      if (!band[j]) Op::out_of_band(a, p0 + q, keep[j]);"
                 "\n    }\n  }\n", True),
    "compact": ("  for (int c = warp; c < chunks; c += kMixedWarps) "
                "mixed_place(&sh, c, lane);\n  __syncthreads();\n", True),
    "full_math": ("  mixed_warp_trees<K>(acc, &sh);\n  __syncthreads();\n"
                  "  mixed_block_sum<K>", False),
    "block_sum": ("  mixed_block_sum<K>(a, &sh, blockIdx.x, gridDim.x);\n",
                  True),
}


def stopped_at(src, phase):
    """contact_mixed.cuh with a return after (or before) ``phase``."""
    anchor, after = STOPS[phase]
    if anchor not in src:
        raise RuntimeError(f"contact_mixed.cuh changed: no end of {phase}")
    return src.replace(anchor, anchor + "  return;\n" if after
                       else "  return;\n" + anchor, 1)


def with_tile(header, tile):
    """contact_mixed.cuh with both kernels' tiles set to ``tile``."""
    if len(re.findall(PER, header)) != 2:
        raise RuntimeError("contact_mixed.cuh changed: no tiles")
    return re.sub(PER, rf"constexpr int \1 = {tile // 256};", header)


def build_copy(build, tmp, name, header, bounds=None):
    """A copy of contact_mixed.cu and contact_mixed_bwd.cu over ``header``
    (contact_mixed.cuh's text, patched), the tiled kernels' launch bounds
    replaced by ``bounds`` where given; returns (library path, nvcc
    process)."""
    d = tmp / name.replace(" ", "_")
    d.mkdir()
    for f in ("contact.cuh", "bspline.cuh"):
        (d / f).write_text((build.CSRC / f).read_text())
    (d / "contact_mixed.cuh").write_text(header)
    for f in ("contact_mixed.cu", "contact_mixed_bwd.cu"):
        src = (build.CSRC / f).read_text()
        if not re.search(BOUNDS, src):
            raise RuntimeError(f"{f} changed: no tiled kernel's bounds")
        (d / f).write_text(src if bounds is None
                           else re.sub(BOUNDS, bounds, src))
    so = d / "lib.so"
    return so, subprocess.Popen(
        [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-o", str(so),
         str(d / "contact_mixed.cu"), str(d / "contact_mixed_bwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def load_copy(build, so):
    lib = ctypes.CDLL(str(so))
    for fn in ("softmac_collide_mixed", "softmac_collide_mixed_bwd"):
        getattr(lib, fn).argtypes = build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mixed_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.ops import build, contact
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _, log, secs = build.build()
    build.library()
    ptxas = cs.ptxas_by_source(log)
    res = {"card": smi, "build_seconds": secs,
           "ptxas": {k: v for k, v in ptxas.items()
                     if k.startswith("contact_mixed")}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        header = (build.CSRC / "contact_mixed.cuh").read_text()
        jobs = {f"tile {t}": build_copy(build, tmp, f"tile {t}",
                                        with_tile(header, t))
                for t in TILES}
        for k, b in (("one_block", ""), ("two_blocks", ", 2")):
            for t in TILES[:2]:
                jobs[f"{k} {t}"] = build_copy(
                    build, tmp, f"{k} {t}", with_tile(header, t),
                    f"__launch_bounds__(softmac::kMixedThreads{b})")
        for phase in STOPS:
            jobs[phase] = build_copy(build, tmp, phase,
                                     stopped_at(header, phase))
        copies = {}
        for name, (so, proc) in jobs.items():
            out = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({name}):\n{out}")
            if name.startswith(("one_block", "two_blocks")):
                res["ptxas_" + name.replace(" ", "_")] = cs.ptxas_by_source(
                    f"== {name}\n" + out)
            copies[name] = load_copy(build, so)
        libs = {k: copies.pop(k) for k in STOPS}

        env = SoftMacEnv(cs.pour_cfg(cs.POUR_WINDOW),
                         init_particles=cs.tiled_pour_particles(cs.N_MAIN))
        inp = cs.pour_kernel_inputs(env, env.rollout(
            np.zeros((cs.STATE_STEPS, env.action_dim)))["carry"])
        cfg, x = inp["cfg"], inp["state"].x
        gen = torch.Generator(device=x.device).manual_seed(5)
        states = [(f"pour body {b}", prim, body, x, v)
                  for b, (prim, body, v) in enumerate(inp["contacts"])]
        prim, body, v = inp["contacts"][0]
        states.append(("glass all in band", prim, body,
                       cs.band_particles(prim, body, x.shape[1], gen), v))
        res["states"] = {}
        for label, prim, body, xs, vs in states:
            cargs = (prim, *body, xs, vs, cfg.dt, cfg.p_mass,
                     cfg.contact_push_velocity_cap)
            gout = torch.randn((3, xs.shape[1]), generator=gen,
                               device=x.device)
            gwrench = torch.randn((6,), generator=gen, device=x.device)
            res["states"][label] = case(cs, contact, copies, cargs, gout,
                                        gwrench)
            if label.startswith("pour"):
                res["states"][label]["phases"] = {
                    phase: {"fwd_device_ms": cs.device_ms(
                                f"{label} fwd {phase}", fwd),
                            "bwd_device_ms": cs.device_ms(
                                f"{label} bwd {phase}", bwd)}
                    for phase, (fwd, bwd) in (
                        (p, copy_calls(contact, lib, cargs, gout, gwrench))
                        for p, lib in libs.items())}
            print(label, json.dumps(res["states"][label]), flush=True)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


def case(cs, contact, copies, cargs, gout, gwrench):
    """Errors, band counts and times of one state."""
    import torch
    from softmac_tpu_torch.ops import build
    prim, xs = cargs[0], cargs[8]
    prim64, body64 = cs._prim64(prim), tuple(map(cs._f64, cargs[1:8]))
    rest = tuple(map(cs._f64, cargs[8:10])) + cargs[10:]
    pv, wr = contact.collide_mixed(*cargs)
    want = contact.collide_mixed_wrench_plain(prim64, *body64, *rest)
    grads = contact.collide_mixed_bwd(*cargs, gout, gwrench)
    gwant = contact.collide_mixed_wrench_vjp_plain(
        prim64, *body64, *rest, gout.double(), gwrench.double())
    band = {tile: cs.band_counts(prim64, body64, xs, tile) for tile in TILES}
    out = {"band": band[TILES[0]][0],
           "worst_tile_band": {t: b[1] for t, b in band.items()},
           "p_v_out_rel_err": cs._errors((pv,), (want[0],),
                                         ("p_v_out",))["p_v_out"][1],
           "wrench_rel_err": cs._wrench_rel(wr, want[1]),
           "grad_rel_err": {k: e[1] for k, e in cs._errors(
               grads, gwant, ("bp", "bq", "bv", "bw", "friction",
                              "softness", "life", "dx", "dv")).items()}}
    timed = {"library": copy_calls(contact, build.library(), cargs, gout,
                                   gwrench)}
    for name, lib in copies.items():
        tile = int(name.split()[-1])
        timed[name] = copy_calls(contact, lib, cargs, gout, gwrench, tile,
                                 tile)
    for key, (fwd, bwd) in timed.items():
        got = fwd()
        out[key] = {"equal_to_default": bool(
            torch.equal(got[0], pv) and torch.equal(got[1], wr))}
        out[key].update({
            "fwd_ms": cs.cuda_time_ms(fwd, 50),
            "fwd_device_ms": cs.device_ms("fwd " + key, fwd),
            "bwd_ms": cs.cuda_time_ms(bwd, 50),
            "bwd_device_ms": cs.device_ms("bwd " + key, bwd)})
    return out


def copy_calls(contact, lib2, cargs, gout, gwrench, tile=None,
               bwd_tile=None):
    """Forward and backward calls of a build (the library or a copy) whose
    kernels take ``tile`` and ``bwd_tile`` particles a block (the
    library's where not given; outputs allocated outside the timed
    calls)."""
    import torch
    prim, body, x = cargs[0], cargs[1:8], cargs[8]
    call = contact._tiled_call("collide_mixed", prim, body, x, cargs[9])
    ptrs, n, _ = call
    tile = tile or contact.MIXED_TILE
    bwd_tile = bwd_tile or contact.MIXED_BWD_TILE
    blocks = -(-n // min(tile, bwd_tile))
    kw = dict(device=x.device)
    pv, wr = torch.empty((3, n), **kw), torch.empty((6,), **kw)
    dx, dv, db = (torch.empty((3, n), **kw), torch.empty((3, n), **kw),
                  torch.empty((16,), **kw))
    part = torch.empty((16, blocks), dtype=torch.float64, **kw)
    dt, p_mass, cap = cargs[10:]
    tail = (*prim.res, *prim.geom, float(dt), float(p_mass),
            contact._cap(cap))

    def fwd():
        done, stream = contact._done(x)
        rc = lib2.softmac_collide_mixed(*ptrs, pv.data_ptr(), wr.data_ptr(),
                                        part.data_ptr(), done, n, *tail,
                                        stream)
        if rc:
            raise RuntimeError(f"copy's forward: cudaError {rc}")
        return pv, wr

    def bwd():
        done, stream = contact._done(x)
        rc = lib2.softmac_collide_mixed_bwd(
            *ptrs, gout.data_ptr(), gwrench.data_ptr(), dx.data_ptr(),
            dv.data_ptr(), db.data_ptr(), part.data_ptr(), done, n, *tail,
            stream)
        if rc:
            raise RuntimeError(f"copy's backward: cudaError {rc}")
        return dx, dv, db
    return fwd, bwd


if __name__ == "__main__":
    sys.exit(main())
