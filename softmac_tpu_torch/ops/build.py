"""Builds the port's CUDA kernels with nvcc and loads them through ctypes.

The sources in ``ops/csrc/*.cu`` compile, one nvcc per source and all at
once, into objects that link into one shared library with a plain C
interface. The library is built at first use into ``build/softmac_tpu_torch/``
at the repository root, named by a hash of the sources and flags, so a
changed source rebuilds and an unchanged one loads the earlier build.
Building needs nvcc (``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or
``PATH``); nothing here runs when the package is imported. ``on_cpu`` is
the device rule every kernel wrapper dispatches by, ``check`` its launch
check.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "softmac_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                        "-Xptxas", "-v"]

_P, _I, _F, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_double)
# C signature of every kernel entry point (argument types, in order)
SIGNATURES = {
    "softmac_p2g": [_P] * 7 + [_I] * 5 + [_F, _P],
    "softmac_slab_plan": [_I] * 7 + [_P],
    "softmac_g2p": [_P] * 7 + [_I] * 4 + [_F, _P],
    "softmac_collide_particle": [_P] * 12 + [_I] * 4 + [_F] * 7 + [_D] * 2
    + [_P],
    "softmac_p2g_bwd": [_P] * 8 + [_I] * 4 + [_F, _P],
    "softmac_g2p_bwd": [_P] * 11 + [_I] * 5 + [_F, _P],
    "softmac_collide_particle_bwd": [_P] * 15 + [_I] * 4 + [_F] * 7
    + [_D] * 2 + [_P],
    "softmac_gather": [_P] * 7 + [_I] * 4 + [_F, _P],
    "softmac_splat": [_P] * 7 + [_I] * 5 + [_F, _P],
    "softmac_collide_mixed": [_P] * 14 + [_I] * 4 + [_F] * 7 + [_D] * 3
    + [_P],
    "softmac_collide_mixed1": [_P] * 5 + [_I] * 4 + [_F] * 7 + [_D, _P],
    "softmac_collide_mixed2": [_P] * 8 + [_I] * 4 + [_F] * 7 + [_D] * 3
    + [_P],
    "softmac_gather_bwd": [_P] * 11 + [_I] * 5 + [_F, _P],
    "softmac_splat_bwd": [_P] * 7 + [_I] * 4 + [_F, _P],
    "softmac_collide_mixed_bwd": [_P] * 17 + [_I] * 4 + [_F] * 7 + [_D] * 3
    + [_P],
    "softmac_collide_mixed1_bwd": [_P] * 8 + [_I] * 4 + [_F] * 7 + [_D, _P],
    "softmac_collide_mixed2_bwd": [_P] * 10 + [_I] * 4 + [_F] * 7
    + [_D] * 3 + [_P],
    "softmac_fused_p2g": [_P] * 9 + [_I] * 4 + [_P],
    "softmac_fused_g2p": [_P] * 10 + [_I] * 4 + [_P],
    "softmac_fused_splat": [_P] * 6 + [_I] * 4 + [_P],
    "softmac_fused_gather": [_P] * 7 + [_I] * 4 + [_P],
    "softmac_fused_p2g_bwd": [_P] * 11 + [_I] * 4 + [_P],
    "softmac_fused_g2p_bwd": [_P] * 14 + [_I] * 4 + [_P],
    "softmac_fused_splat_bwd": [_P] * 7 + [_I] * 4 + [_P],
    "softmac_fused_gather_bwd": [_P] * 11 + [_I] * 4 + [_P],
    "softmac_kr3": [_P] * 7 + [_I] * 3 + [_P],
}


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"),
             "/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for f in srcs + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libsoftmac_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str, float]:
    """Compile and link the kernels if no build of these sources exists.
    Returns (library path, compiler log, seconds spent building)."""
    so = library_path()
    if so.exists():
        return so, "", 0.0
    t0 = time.time()
    nvcc = _nvcc()
    srcs, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            log = open(Path(tmp) / (src.stem + ".log"), "w+")
            proc = subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=log, stderr=subprocess.STDOUT)
            jobs.append((src, obj, log, proc))
        logs, failed = [], []
        for src, obj, log, proc in jobs:
            rc = proc.wait()
            log.seek(0)
            logs.append(f"== {src.name}\n{log.read()}")
            log.close()
            if rc != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so)]
            + [str(obj) for _, obj, _, _ in jobs],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, so)
    return so, "\n".join(logs), time.time() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first where needed)."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def on_cpu(x, name: str) -> bool:
    """The dispatch rule of every kernel wrapper: True for a CPU tensor (run
    the plain version), False for a CUDA tensor (launch the kernel); any
    other device raises."""
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise TypeError(f"{name}: no implementation for device {x.device}")
    return kind == "cpu"


def check(rc: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
