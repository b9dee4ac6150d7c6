#!/usr/bin/env python3
"""Where the time of the door's row-thread kernels goes: the dense-weight
P2G, G2P, splat and gather, and their backwards, on one CUDA card.

    python3 scripts/fused_bwd_phases.py [SRC_DIR [KERNEL ...]]

Builds copies of ``fused_p2g.cu``, ``fused_g2p.cu``, ``fused_splat.cu``,
``fused_gather.cu``, ``fused_p2g_bwd.cu``, ``fused_g2p_bwd.cu``,
``fused_splat_bwd.cu`` and ``fused_gather_bwd.cu`` (or the KERNELs named,
file stems) with the headers of the ``csrc`` directory of SRC_DIR, a
checkout of the repository (default: this one), whose kernel returns
after each of its phases, and times each copy's C entry point with CUDA
events (50 calls after a warm-up) and torch.profiler (device ms) on the
inputs chip_smoke.py checks the kernels on (``door_states``: the door's
state after 10 env steps, 5400 particles, window (32, 16, 32), that state
tiled to 1e5 particles, and the door after 150 env steps, whose contact
band is not empty), with seeded normal cotangents
(``chip_smoke.fused_cotangents``). The phases (``STOPS``) are those of the
row-thread design of ``fused_rows.cuh``, each a copy's time the
difference to the one before it: the first launch and the block's
vote, then the box, then the staged pair products and the tile's window,
then the weight rows alone or the extra tasks alone (the channel or
value sums, G2P's and the gather's output sums, or the scatter); and
variants of the full kernel:
the scatter by device-memory atomics alone (no tile window), no first
launch, each tile on one block (no split of its tasks), G2P with one task
an output row (12 a particle) instead of one a component (3), the box
scan one row a load instead of ``kBoxBatch``, and the full block at other
warps a block and launch bounds (each copy's registers and spills from
ptxas). The float64 window's zero fill of the kernels that sum into one
(``Tensor.zero_``; the splat keeps its window zero between calls and
needs none) and their launches without the kernel (the entry point
called with n = 0: the round, after the first launch where there is one)
are timed apart. Prints one JSON object; the card's name and power limit
on the lines around it. Needs a card and nvcc; exits non-zero without
them.
"""
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("fused_p2g", "fused_g2p", "fused_splat", "fused_gather",
           "fused_p2g_bwd", "fused_g2p_bwd", "fused_splat_bwd",
           "fused_gather_bwd")
# the kernels that sum into a float64 window (zero, then rounded)
WINDOWED = ("fused_p2g", "fused_splat", "fused_g2p_bwd", "fused_gather_bwd")
# A phase's variant returns after it (one that leaves no output behind
# writes one value, so that the compiler keeps its work); the
# replacements whose text the kernel's source or headers hold are made,
# and a variant none of whose texts they hold is not the kernel's.
# Besides the row-thread phases: the rows alone, the extra tasks alone,
# no first launch, one block a tile, G2P at 12 tasks a particle, the box
# scan one row a load, and the full block at other warps a block and
# launch bounds ("w<warps>b<blocks an SM>")
_ROWS_VOTE = "  if (!__syncthreads_or(rows_live<Kind>(a))) return;\n"
_ROWS_BOX = "  rows_box<Kind>(a, sh);\n  __syncthreads();\n"
_ROWS_PAIRS = ("    rows_pairs<Kind::kDeriv, row_planes<Kind>()>(a, sh);\n"
               "    rows_window<window_channels<Kind>()>(sh);\n"
               "    __syncthreads();\n")
_ROWS_KEEP = ("  if (rows_particle() < a.n && threadIdx.x < kRowLanes) {\n"
              "    if (a.out) a.out[rows_particle()] = static_cast<float>(%s);"
              "\n    else a.acc[rows_particle() %% a.size[0]] = %s;\n  }\n"
              "  return;\n")
_ROWS_TASKS = ("  const int tasks = extra + (Kind::kRows ? a.size[1] + a.size[2] "
               ": 0);\n")
_ROWS_X = "rows_warp(); q < kRowLanes;"


def _shape(warps, blocks):
    return (("constexpr int kRowWarps = 8;",
             f"constexpr int kRowWarps = {warps};"),
            ("constexpr int kRowBlocks = 3;",
             f"constexpr int kRowBlocks = {blocks};"))


def _keep(value):
    return _ROWS_KEEP % (value, value)


# G2P at one task an output row (12 a particle, a tile's tasks on up to 2
# blocks) instead of one a component (3)
_G2P_TASKS12 = (
    ("extra_tasks(const RowsArgs&, bool) { return 3; }",
     "extra_tasks(const RowsArgs&, bool) { return 12; }"),
    ("bool narrow, int d, int lane, int p) {\n",
     "bool narrow, int task, int lane, int p) {\n"
     "    const int d = task / 4;\n"),
    ("      a.out[rows[k] * n + p] = static_cast<float>(s[k]);",
     "      if (k == task % 4) a.out[rows[k] * n + p] = "
     "static_cast<float>(s[k]);"),
    ("fused_g2p_kernel<<<softmac::rows_blocks(n), softmac::kRowThreads, 0,",
     "fused_g2p_kernel<<<dim3(softmac::rows_blocks(n), "
     "softmac::rows_parts(n) < 2 ? softmac::rows_parts(n) : 2), "
     "softmac::kRowThreads, 0,"))

# variant -> ((text, its replacement), ...)
STOPS = {
    "vote": ((_ROWS_VOTE, _ROWS_VOTE + _keep("0.0")),),
    "box": ((_ROWS_BOX, _ROWS_BOX + _keep("sh->lo[0][rows_lane()]")),),
    "pairs": ((_ROWS_PAIRS, _ROWS_PAIRS + "  "
               + _keep("sh->pair[0][0][0][rows_lane()]")),),
    "rows_only": (("  const int extra = Kind::extra_tasks(a, narrow);\n",
                   "  const int extra = 0;\n"),),
    "extra_only": ((_ROWS_TASKS, "  const int tasks = extra;\n"),
                   (_ROWS_X, "rows_warp(); q < 0;")),
    "noprep": (("softmac::rows_prep<", "if (false) softmac::rows_prep<"),),
    "nowindow": (("  return kChan * cells <= kWinDoubles ? cells : 0;",
                  "  return 0;"),),
    "parts1": (("  return parts < 1 ? 1 : parts > kRowParts ? kRowParts "
                ": parts;", "  return 1;"),),
    "tasks12": _G2P_TASKS12,
    "box1": (("constexpr int kBoxBatch = 4;",
              "constexpr int kBoxBatch = 1;"),),
    "w16b1": _shape(16, 1),
    "w16b2": _shape(16, 2),
    "w8b4": _shape(8, 4),
}
# variants that are no phase of a kernel (P2G, G2P, the splat and the
# gather have no weight rows; G2P, the gather and the P2G and splat
# backwards no scatter, the splat no tile window; G2P, the splat and the
# gather have one block a tile); and the variants of one kernel alone
ONLY_OF = {"tasks12": "fused_g2p"}
NOT_OF = {"fused_p2g": ("rows_only", "extra_only"),
          "fused_g2p": ("rows_only", "extra_only", "nowindow", "parts1"),
          "fused_splat": ("rows_only", "extra_only", "nowindow", "parts1"),
          "fused_gather": ("rows_only", "extra_only", "nowindow", "parts1"),
          "fused_p2g_bwd": ("nowindow",),
          "fused_splat_bwd": ("nowindow",)}


def stopped_at(d, csrc, source, stop):
    """Copy ``source`` and every header of ``csrc`` into ``d``, with the
    replacements of ``stop`` (None: the full kernel) made in the first
    file that holds each text; False where none of its texts is there (the
    variant is another kernel's)."""
    for f in [csrc / source] + sorted(csrc.glob("*.cuh")):
        (d / f.name).write_text(f.read_text())
    made = not stop
    for text, replacement in stop or ():
        for f in [d / source] + sorted(d.glob("*.cuh")):
            src = f.read_text()
            if text in src:
                f.write_text(src.replace(text, replacement, 1))
                made = True
                break
    return made


def ptxas(log):
    """[(registers, spill stores)] of the kernels in an ``nvcc -Xptxas -v``
    log (the rounds to float32 left out)."""
    out, spill, skip = [], 0, False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            skip = "round_to_float" in ln or "round_and_clear" in ln
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
    kernels = tuple(sys.argv[2:]) or KERNELS
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from softmac_tpu_torch.ops import build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    states = cs.door_states()[2]
    res = {"card": smi, "sources": str(csrc), "ms": {}, "device_ms": {},
           "ptxas": {}}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for kernel in kernels:
            stops = dict(STOPS, full=None)
            for phase, stop in stops.items():
                d = Path(tmp) / f"{kernel}_{phase}"
                d.mkdir()
                mine = phase not in NOT_OF.get(kernel, ()) \
                    and ONLY_OF.get(phase, kernel) == kernel
                if not mine or not stopped_at(d, csrc, kernel + ".cu", stop):
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
            # the row-thread backwards' entry points take a scratch buffer
            scratch = "float* scratch" in (csrc / (kernel + ".cu")).read_text()
            for state, inp in states.items():
                run = entry_call(fn, kernel, inp, cs.fused_cotangents(inp),
                                 scratch)
                key = f"{kernel} {phase} {state}"
                res["ms"][key] = cs.cuda_time_ms(run, 50)
                res["device_ms"][key] = cs.device_ms(key, run)
                if kernel in WINDOWED and phase == "full":
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
    cotangents ``cts`` (None: n = 0, the launches without the kernel), its
    buffers made once, as ``ops/fused.py`` makes them (``scratch``: the
    entry point takes the grids' two other layouts' buffer); the float64
    window, where the kernel has one, is ``.acc`` of the function (zeroed
    by the first launch of the row-thread backwards and left zero by the
    splat's round, by no launch of P2G: its wrapper zeroes it)."""
    import torch
    n, (wx, wy, wz) = inp["n"], inp["sizes"]
    ws6 = inp["ws6"]
    dev = ws6[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    cells = wx * wy * wz
    rows = 2 * (wx + wy + wz)
    f32 = lambda *shape: torch.empty(shape, device=dev)  # noqa: E731
    acc = torch.zeros(4 * cells, dtype=torch.float64, device=dev)
    buf = f32((8 if kernel == "fused_p2g_bwd" else 6) * cells)
    if kernel == "fused_p2g":
        ins, outs = [*ws6, inp["chan"]], [acc, f32(4 * cells)]
    elif kernel == "fused_g2p":
        ins, outs = [*ws6, *inp["gv"]], [f32(12, n)]
    elif kernel == "fused_splat":
        ins, outs = [*ws6[0::2], inp["vals"]], [acc, f32(3 * cells)]
    elif kernel == "fused_gather":
        ins, outs = [*ws6[0::2], *inp["gvm"]], [f32(3, n)]
    elif kernel == "fused_p2g_bwd":
        ins = [*ws6, inp["chan"], cts["dgm"], cts["dgmom"]]
        outs = [f32(rows + 13, n)] + [buf] * scratch
    elif kernel == "fused_g2p_bwd":
        ins = [*ws6, *inp["gv"], cts["g12"] if cts else acc]
        outs = [f32(rows, n), acc, f32(3 * cells)] + [buf] * scratch
    elif kernel == "fused_splat_bwd":
        ins = [*ws6[0::2], inp["vals"], cts["dout"]]
        outs = [f32(rows // 2 + 3, n)] + [buf] * scratch
    else:
        ins = [*ws6[0::2], *inp["gvm"], cts["dv"] if cts else acc]
        outs = [f32(rows // 2, n), acc, f32(3 * cells)] + [buf] * scratch
    args = [t.data_ptr() for t in ins + outs] + [n if cts else 0, wx, wy,
                                                   wz, stream]
    fn.argtypes = ([ctypes.c_void_p] * (len(ins) + len(outs))
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])

    def run():
        build_check(fn(*args), kernel)
    run.acc, run.keep = acc, (cts, ins, outs)  # the pointers' tensors live
    return run


def build_check(rc, kernel):
    if rc != 0:
        raise RuntimeError(f"{kernel}: cudaError {rc}")


if __name__ == "__main__":
    sys.exit(main())
