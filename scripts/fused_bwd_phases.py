#!/usr/bin/env python3
"""Where the time of the dense-weight P2G and G2P backwards goes, on one
CUDA card.

    python3 scripts/fused_bwd_phases.py [SRC_DIR]

Builds copies of ``fused_p2g_bwd.cu`` and ``fused_g2p_bwd.cu`` (with the
headers of their ``csrc`` directory) of SRC_DIR, a checkout of the
repository (default: this one), whose kernel returns after each of its
phases, and times each copy's C entry point with CUDA events (50 calls
after a warm-up) and torch.profiler (device ms) on the inputs chip_smoke.py
checks the kernels on: the door's state after 10 env steps (5400
particles, window (32, 16, 32)) and that state tiled to 1e5 particles,
with seeded normal cotangents (``chip_smoke.fused_cotangents``). The
phases are those of the design the sources hold (``STOPS``): for the
first design (one thread a particle) the box scan, ``weight_adjoint`` and
the channel walk or grid scatter, a phase's time the difference to the
one before it; for the row-thread design of ``fused_rows.cuh`` the first
launch and the box, then the staged pair products, then the weight rows
alone or the extra tasks alone (the channel sums or the grid scatter),
the kernel without its first launch, each tile on one block (no split of
its tasks), and the full block at other warps a block and launch bounds
(each copy's registers and spills from ptxas).
The G2P backward's zero fill of its float64 window (``Tensor.zero_``) and
its launches without the kernel (the entry point called with n = 0: the
round, after the first launch in the row-thread design) are timed apart.
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
KERNELS = ("fused_p2g_bwd", "fused_g2p_bwd")
# design -> variant -> ((text, its replacement), ...): a phase's variant
# returns after it (one that leaves no output behind writes one value, so
# that the compiler keeps its work); the row-thread design also runs its
# rows alone, its extra tasks alone, no first launch, and its full block
# at other warps a block and launch bounds ("w<warps>b<blocks an SM>")
_ROWS_BOX = "  rows_box(a, sh);\n  __syncthreads();\n"
_ROWS_PAIRS = "    rows_pairs(a, sh);\n    __syncthreads();\n"
_ROWS_KEEP = ("  if (rows_particle() < a.n && threadIdx.x < kRowLanes) "
              "a.out[rows_particle()] = static_cast<float>(%s);\n  return;\n")
_ROWS_TASKS = ("  const int tasks = extra + kRowLanes + a.size[1] + "
               "a.size[2];\n")


def _shape(warps, blocks):
    return (("constexpr int kRowWarps = 8;",
             f"constexpr int kRowWarps = {warps};"),
            ("constexpr int kRowBlocks = 3;",
             f"constexpr int kRowBlocks = {blocks};"))


STOPS = {
    "first": {
        "box": (("particle_box(Wx, WxD, Wy, WDy, Wz, WDz, n, p, wx, wy, wz);\n",
                 "particle_box(Wx, WxD, Wy, WDy, Wz, WDz, n, p, wx, wy, wz);\n"
                 "  out[p] = static_cast<float>(b.x0 + b.x1 + b.y0 + b.y1 + "
                 "b.z0 + b.z1);\n  return;\n"),),
        "adjoint": (("b, cell, dW, dWxD, dWy, dWDy, dWz, dWDz);\n",
                     "b, cell, dW, dWxD, dWy, dWDy, dWz, dWDz);\n"
                     "  return;\n"),),
    },
    "rows": {
        "box": ((_ROWS_BOX,
                 _ROWS_BOX + _ROWS_KEEP % "sh->lo[0][rows_lane()]"),),
        "pairs": ((_ROWS_PAIRS, _ROWS_PAIRS + "  " + _ROWS_KEEP
                   % "sh->pair[0][0][0][rows_lane()]"),),
        "rows_only": (("  const int extra = Kind::extra_tasks(a, narrow);\n",
                       "  const int extra = 0;\n"),),
        "extra_only": ((_ROWS_TASKS, "  const int tasks = extra;\n"),),
        "noprep": (("softmac::rows_prep<", "if (false) softmac::rows_prep<"),),
        "parts1": (("  return parts < 1 ? 1 : parts > kRowParts ? kRowParts "
                    ": parts;", "  return 1;"),),
        "w16b1": _shape(16, 1),
        "w16b2": _shape(16, 2),
        "w8b4": _shape(8, 4),
    },
}


def design(csrc):
    """The design whose every text to replace the sources of ``csrc``
    hold."""
    text = "".join(p.read_text() for p in sorted(csrc.glob("*.cu*")))
    for name, stops in STOPS.items():
        if all(a in text for v in stops.values() for a, _ in v):
            return name
    raise RuntimeError(f"no known design in {csrc}")


def stopped_at(d, csrc, source, stop):
    """Copy ``source`` and every header of ``csrc`` into ``d``, with the
    replacements of ``stop`` (None: the full kernel) made in the files that
    hold their texts; False where ``source`` and the headers lack one (the
    variant is another kernel's)."""
    for f in [csrc / source] + sorted(csrc.glob("*.cuh")):
        (d / f.name).write_text(f.read_text())
    for text, replacement in stop or ():
        for f in [d / source] + sorted(d.glob("*.cuh")):
            src = f.read_text()
            if text in src:
                f.write_text(src.replace(text, replacement, 1))
                break
        else:
            return False
    return True


def ptxas(log):
    """[(registers, spill stores)] of the kernels in an ``nvcc -Xptxas -v``
    log (the round to float32 left out)."""
    out, spill, skip = [], 0, False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            skip = "round_to_float" in ln
        elif "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
        elif "Used" in ln and "registers" in ln and not skip:
            out.append((int(re.search(r"Used (\d+) registers", ln).group(1)),
                        spill))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("fused_bwd_phases: CUDA is not available", file=sys.stderr)
        return 2
    csrc = (Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT) \
        / "softmac_tpu_torch/ops/csrc"
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch.ops import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    states = cs.door_states()[2]
    which = design(csrc)
    stops = dict(STOPS[which], full=None)
    res = {"card": smi, "design": which, "sources": str(csrc),
           "phases": list(stops), "ms": {}, "device_ms": {}, "ptxas": {}}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for kernel in KERNELS:
            for phase, stop in stops.items():
                d = Path(tmp) / f"{kernel}_{phase}"
                d.mkdir()
                if not stopped_at(d, csrc, kernel + ".cu", stop):
                    continue
                so = d / "lib.so"
                jobs[kernel, phase] = (so, subprocess.Popen(
                    [build._nvcc(), *build.COMPILE_FLAGS, "-shared", "-o",
                     str(so), str(d / (kernel + ".cu"))],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
        for (kernel, phase), (so, proc) in jobs.items():
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({kernel} {phase}):\n{log}")
            res["ptxas"][f"{kernel} {phase}"] = ptxas(log)
            fn = getattr(ctypes.CDLL(str(so)), "softmac_" + kernel)
            # the row-thread design's entry points take a scratch buffer
            scratch = "float* scratch" in (csrc / (kernel + ".cu")).read_text()
            fn.argtypes = ([ctypes.c_void_p] * (10 if kernel == "fused_p2g_bwd"
                                                else 13)
                           + [ctypes.c_void_p] * scratch
                           + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            for state, inp in states.items():
                run = entry_call(fn, kernel, inp, cs.fused_cotangents(inp),
                                 scratch)
                key = f"{kernel} {phase} {state}"
                res["ms"][key] = cs.cuda_time_ms(run, 50)
                res["device_ms"][key] = cs.device_ms(key, run)
                if kernel == "fused_g2p_bwd" and phase == "full":
                    for part, f in (("zero", run.acc.zero_),
                                    ("round", entry_call(fn, kernel, inp,
                                                         None, scratch))):
                        key = f"{kernel} {part} {state}"
                        res["ms"][key] = cs.cuda_time_ms(f, 50)
                        res["device_ms"][key] = cs.device_ms(key, f)
                print(json.dumps({key: res["device_ms"][key]}), flush=True)
    print(json.dumps(res), flush=True)
    print(smi, flush=True)
    return 0


def entry_call(fn, kernel, inp, cts, scratch):
    """A function that calls a built copy's entry point on ``inp`` with the
    cotangents ``cts`` (None: n = 0, the G2P backward's launches without
    its kernel), its buffers made once, as ``ops/fused.py`` makes them
    (``scratch``: the entry point takes the grids' two other layouts'
    buffer); the G2P backward's float64 window is ``.acc`` of the function
    (not zeroed by the first design's call)."""
    import torch
    n, (wx, wy, wz) = inp["n"], inp["sizes"]
    ws6 = inp["ws6"]
    dev = ws6[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [w.data_ptr() for w in ws6]
    rows = 2 * (wx + wy + wz)
    cells = wx * wy * wz
    p2g = kernel == "fused_p2g_bwd"
    buf = torch.empty((8 if p2g else 6) * cells, device=dev)
    extra = [buf.data_ptr()] if scratch else []
    if p2g:
        out = torch.empty((rows + 13, n), device=dev)
        args = ptrs + [inp["chan"].data_ptr(), cts["dgm"].data_ptr(),
                       cts["dgmom"].data_ptr(), out.data_ptr(), *extra, n,
                       wx, wy, wz, stream]

        def run():
            build_check(fn(*args), kernel)
        run.keep = (cts, out, buf)  # the pointers' tensors live with run
        return run
    out = torch.empty((rows, n), device=dev)
    acc = torch.zeros(3 * cells, dtype=torch.float64, device=dev)
    gout = torch.empty(3 * cells, device=dev)
    g = cts["g12"].data_ptr() if cts else 0
    args = ptrs + [t.data_ptr() for t in inp["gv"]] + [
        g, out.data_ptr(), acc.data_ptr(), gout.data_ptr(), *extra,
        n if cts else 0, wx, wy, wz, stream]

    def run():
        build_check(fn(*args), kernel)
    run.acc, run.keep = acc, (cts, out, gout, buf)
    return run


def build_check(rc, kernel):
    if rc != 0:
        raise RuntimeError(f"{kernel}: cudaError {rc}")


if __name__ == "__main__":
    sys.exit(main())
