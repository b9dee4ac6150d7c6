#!/usr/bin/env python3
"""Drive the PyTorch port (softmac_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed on a line of its own; any failed phase raises and the
script exits non-zero:

  device   the card as nvidia-smi reports it (name, power limit)
  build    nvcc builds the CUDA kernels from softmac_tpu_torch/ops/csrc
  kernels  each kernel against its plain PyTorch version at the main path's
           shapes (1e5-particle pour_vel scene, window (40, 32, 16), the
           state after 10 env steps): max error, time over 20+ calls (CUDA
           events), the plain version's time, the least time the card needs
           for the same work, launches on the main path. The contact kernel
           is also held against its plain version on particles spread over
           each body's SDF box, so that both bodies have many contacts
  slice    the main path: SoftMacEnv.rollout of that scene for 100 env steps
           on the card, launches counted; then 7 more timed rollouts of the
           same actions: substeps/s (median and spread), loss, overflow,
           and how far the repeats' end states differ from the first
  profile  torch.profiler over 20 env steps of the same rollout: device
           busy share of the wall time, kernel launches per substep, the
           kernels that take the most device time
  parity   the demo's own 5000-particle scene for 20 steps, card (float32,
           kernels) against the CPU (float64, plain versions)

The last line is {"ok": true, "device": {...}}. Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WINDOW = (40, 32, 16)
N_MAIN = 100_000
SLICE_STEPS = 100
SLICE_REPEATS = 7
STATE_STEPS = 10
MIN_BOX_CONTACTS = 5000
TIME_ITERS = 25
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_FLOPS = 67e12                 # H100 SXM float32 outside tensor cores
# float operations a particle costs in each kernel, counted from the source
# (weights per axis ~19, per (y, z) pair 3, per cell P2G 30 incl. atomics /
# G2P 28, contact: 3 quaternion rotations, trilinear 8 x 10, ~60 of math)
FLOPS_PER_PARTICLE = {"p2g": 57 + 27 + 27 * 30, "g2p": 57 + 27 + 27 * 28,
                      "collide_particle": 240}


def emit(tag, obj):
    print(f"{tag}: {json.dumps(obj)}" if tag else json.dumps(obj), flush=True)


def tiled_pour_vel_particles(n):
    """The pour_vel init state tiled to n particles with 1e-4 jitter (the
    1e5-particle scene of bench.py's build_pour_vel_env)."""
    import numpy as np
    base = np.load(ROOT / "envs/pour/pour_mpm_init_state_corotated.npy")
    reps = int(np.ceil(n / base.shape[0]))
    rng = np.random.RandomState(0)
    tiled = np.tile(base[:, :3], (reps, 1))[:n]
    tiled += rng.randn(n, 3) * 1e-4
    tiled += np.array([0.0, 0.04, 0.0])
    return tiled


def pour_vel_cfg(window=None):
    from softmac_tpu_torch import load
    cfg = load(str(ROOT / "softmac_tpu_torch/config/demo_pour_vel_config.py"))
    if window is not None:
        cfg.defrost()
        cfg.TPU.active_window = tuple(window)
        cfg.freeze()
    return cfg


def actions(n_steps, seed=1):
    import numpy as np
    return np.random.RandomState(seed).randn(n_steps, 12) * 0.02


def cuda_time_ms(fn, iters=TIME_ITERS):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(name, n, bytes_moved):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = n * FLOPS_PER_PARTICLE[name] / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(env, carry):
    """The inputs the main path hands each kernel in the first substep from
    ``carry``, built with the port's own substep stages (y-sorted, as the
    rollout keeps them)."""
    from softmac_tpu_torch.engine import mpm
    from softmac_tpu_torch.ops import m33, transfer
    cfg = env.mpm_cfg
    state, bodies, _ = carry
    q, _ = mpm.sort_perm(cfg, state.x)
    state = mpm.permute_state(state, q)
    params = mpm.permute_params(env.mpm_params, q)
    stress, _ = mpm.stress_and_F(cfg, params, state)
    impulse, _ = mpm.contact_impulse(cfg, params, env.prims, state, bodies)
    sizes, corner, overflow = mpm.window_geometry(cfg, state.x)
    chan = mpm._p2g_channels(cfg, tuple(state.v), m33.from_mat_array(state.C),
                             stress, impulse)
    gm, gmom = transfer.p2g_plain(state.x, chan, corner, sizes, cfg.inv_dx)
    grids = mpm.grid_velocity(cfg, params, gm, gmom, sizes, corner)
    contacts = [(prim, bodies.pos[i], bodies.quat[i], bodies.v[i],
                 bodies.w[i], params.friction[i])
                for i, prim in enumerate(env.prims)]
    if bool(overflow):
        raise AssertionError("window overflow in the kernel-check state")
    return dict(cfg=cfg, state=state, chan=chan, corner=corner, sizes=sizes,
                grids=grids, contacts=contacts)


def check_kernels(inp):
    """Each kernel against its plain version; returns the JSON entries
    (launches filled in by the caller)."""
    import torch
    from softmac_tpu_torch.ops import contact, m33, transfer
    cfg, st = inp["cfg"], inp["state"]
    x, v, n = st.x, st.v, st.x.shape[1]
    corner, sizes = inp["corner"], inp["sizes"]
    wx, wy, wz = sizes
    cells = wx * wy * wz
    entries = []

    def entry(name, src, replaces, abs_err, rel_err, ms, plain_ms,
              bytes_moved):
        b_ms, b_by = bound(name, n, bytes_moved)
        replaces, tpu_function = replaces.split(" ", 1)
        entries.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "tpu_function": tpu_function,
            "launches": None,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "tolerance": 1e-5, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_moved,
            "library_ms": None})
        if not rel_err <= 1e-5:
            raise AssertionError(f"{name}: relative error {rel_err} > 1e-5")

    # --- p2g: held against the plain version on the same inputs in
    # float64, so that the yardstick's own float32 rounding does not count --
    args = (x, inp["chan"], corner, sizes, cfg.inv_dx)
    gm_k, gmom_k = transfer.p2g(*args)
    gm_p, gmom_p = transfer.p2g_plain(x.double(), inp["chan"].double(),
                                      corner, sizes, cfg.inv_dx)
    err = max((gm_k - gm_p).abs().max().item(),
              (gmom_k - gmom_p).abs().max().item())
    scale = max(gm_p.abs().max().item(), gmom_p.abs().max().item())
    entry("p2g", "softmac_tpu_torch/ops/csrc/p2g.cu",
          "softmac_tpu/ops/pallas_chunked.py:627 (_p2g_c_pallas, "
          "pallas_call :646, kernel _p2g_c_kernel :200)",
          err, err / scale, cuda_time_ms(lambda: transfer.p2g(*args)),
          cuda_time_ms(lambda: transfer.p2g_plain(*args)),
          (16 * n + 4 * cells) * 4)

    # --- g2p: relative to each output row's largest value ------------------
    args = (x, *inp["grids"], corner, sizes, cfg.inv_dx)
    out_k, out_p = transfer.g2p(*args), transfer.g2p_plain(*args)
    row_scale = out_p.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    rel = ((out_k - out_p).abs() / row_scale).max().item()
    entry("g2p", "softmac_tpu_torch/ops/csrc/g2p.cu",
          "softmac_tpu/ops/pallas_chunked.py:688 (_g2p_c_pallas, "
          "pallas_call :704, kernel _g2p_c_kernel :245)",
          (out_k - out_p).abs().max().item(), rel, cuda_time_ms(lambda: transfer.g2p(*args)),
          cuda_time_ms(lambda: transfer.g2p_plain(*args)),
          (3 * n + 3 * cells + 12 * n) * 4)
    entries[-1]["rel_err_is"] = "max |kernel - plain| / max |plain| per row"

    # --- collide_particle, once per body, on the main path's particles and
    # on particles spread over the body's SDF box (many contacts) ------------
    def contact_err(cargs, label):
        imp_k, mask_k = contact.collide_particle(*cargs)
        imp_p, mask_p = contact.collide_particle_plain(*cargs)
        prim, bp, bq, xs = cargs[0], cargs[1], cargs[2], cargs[6]
        dist, _ = contact.sample_sdf_normal_world(prim, tuple(bp), tuple(bq),
                                                  tuple(xs))
        edge = (dist - contact.CONTACT_THRESHOLD).abs() < 1e-6
        if bool(((mask_k != mask_p) & ~edge).any()):
            raise AssertionError(f"collide_particle ({label}): contact masks "
                                 "differ away from the threshold")
        diff = ((imp_k - imp_p).abs() * (mask_k == mask_p)).max().item()
        n_contacts = int(mask_p.sum())
        print(f"collide_particle {label}: contacts {n_contacts}, max abs err "
              f"{diff}", flush=True)
        return diff, diff / max(imp_p.abs().max().item(), 1e-30), n_contacts

    gen = torch.Generator(device=x.device).manual_seed(0)
    errs, rels, ms, plain_ms, nbytes = [], [], 0.0, 0.0, 0
    for b, (prim, bp, bq, bv, bw, fr) in enumerate(inp["contacts"]):
        cargs = (prim, bp, bq, bv, bw, fr, x, v, cfg.dt, cfg.p_mass)
        x_box = box_particles(prim, bp, bq, n, gen)
        for args, label in ((cargs, f"body {b} main path"),
                            (cargs[:6] + (x_box,) + cargs[7:],
                             f"body {b} SDF box")):
            diff, rel, n_contacts = contact_err(args, label)
            errs.append(diff)
            rels.append(rel)
        if n_contacts < MIN_BOX_CONTACTS:
            raise AssertionError(f"collide_particle: only {n_contacts} "
                                 f"contacts in body {b}'s SDF box")
        ms += cuda_time_ms(lambda: contact.collide_particle(*cargs))
        plain_ms += cuda_time_ms(lambda: contact.collide_particle_plain(*cargs))
        qinv = m33.qnorm(m33.qconj(tuple(bq)))
        p_loc = m33.qrot(qinv, m33.vsub(tuple(x), tuple(bp)))
        rows = torch.unique(contact.cell_index(prim, p_loc)[0]).numel()
        nbytes += 6 * n * 4 + rows * 128 + 14 * 4 + n * (3 * 4 + 1)
        print(f"collide_particle body {b}: distinct table rows {rows}",
              flush=True)
    entry("collide_particle", "softmac_tpu_torch/ops/csrc/contact.cu",
          "softmac_tpu/ops/pallas_contact.py:393 (_make_particle_kernel via "
          "_particle_factory :704, pallas_call in _run_kernel :472, call "
          "site :723)", max(errs), max(rels), ms, plain_ms, nbytes)
    entries[-1]["rel_err_is"] = ("max |kernel - plain| / max |plain| where "
                                 "the masks agree, over the main path's and "
                                 "the SDF-box particles; times and bytes "
                                 "(main path's particles) summed over glass "
                                 "+ bowl")
    entries[-1]["per_substep"] = len(inp["contacts"])
    return entries


def box_particles(prim, bp, bq, n, gen):
    """n world-frame points spread uniformly over the body's SDF box (the
    table's [lower, upper) in the body frame, posed by bp, bq)."""
    import torch
    from softmac_tpu_torch.ops import m33
    u = torch.rand((3, n), generator=gen, dtype=bp.dtype, device=bp.device)
    p_loc = prim.lower[:, None] + (prim.upper - prim.lower)[:, None] * u
    x = m33.vadd(m33.qrot(tuple(bq), tuple(p_loc)), tuple(bp))
    return torch.stack(x).contiguous()


def timed_rollout(env, acts):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = env.rollout(acts)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_slice(env):
    """The main path: one rollout with the launches counted from zero, then
    SLICE_REPEATS timed rollouts of the same actions."""
    import torch
    from softmac_tpu_torch.ops import contact, transfer
    acts = actions(SLICE_STEPS)
    wrappers = {"p2g": transfer.p2g, "g2p": transfer.g2p,
                "collide_particle": contact.collide_particle}
    for w in wrappers.values():
        w.launches = 0
    out, secs = timed_rollout(env, acts)
    launches = {k: w.launches for k, w in wrappers.items()}
    loss = out["loss"].item()
    terms = {k: float(v) for k, v in out["terms"].items()}
    state = out["carry"][0]
    n_sub = SLICE_STEPS * env.substeps
    rates, repeat_diff = [], 0.0
    for _ in range(SLICE_REPEATS):
        rep, rep_secs = timed_rollout(env, acts)
        rates.append(n_sub / rep_secs)
        repeat_diff = max(repeat_diff,
                          (rep["carry"][0].x - state.x).abs().max().item())
    res = {"n_particles": env.n_particles, "window": list(WINDOW),
           "env_steps": SLICE_STEPS, "substeps": n_sub,
           "substeps_per_s": statistics.median(rates),
           "substeps_per_s_min": min(rates), "substeps_per_s_max": max(rates),
           "substeps_per_s_runs": rates,
           "counted_run_substeps_per_s": n_sub / secs,
           "repeat_x_max_abs_diff": repeat_diff,
           "loss": loss, "terms": terms,
           "launches": launches,
           "x_finite": bool(torch.isfinite(state.x).all()),
           "x_shape": list(state.x.shape)}
    expect = {"p2g": n_sub, "g2p": n_sub,
              "collide_particle": n_sub * env.n_primitives}
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    if terms["window_overflow"] or not math.isfinite(loss) \
            or not res["x_finite"] or res["x_shape"] != [3, env.n_particles]:
        raise AssertionError(f"slice output wrong: {res}")
    return res, launches


def run_profile(env, steps=20):
    """Device busy share and the top kernels over a short rollout."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = actions(steps, seed=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        env.rollout(acts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        raise AssertionError("the profiler saw no device kernels")
    by_name = {}
    for e in kern:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(t for t, _ in by_name.values())
    n_sub = steps * env.substeps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"env_steps": steps, "wall_ms_per_substep": wall * 1e3 / n_sub,
            "device_busy_ms_per_substep": busy_us / 1e3 / n_sub,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches_per_substep": len(kern) / n_sub,
            "top_kernels": [{"name": k[:90], "ms_per_substep": t / 1e3 / n_sub,
                             "calls_per_substep": c / n_sub}
                            for k, (t, c) in top]}


def run_parity():
    """Card (float32, kernels) against the CPU (float64, plain versions)
    on the demo's own scene."""
    import torch
    from softmac_tpu_torch import SoftMacEnv
    steps = 20
    outs = {}
    for dev in ("cuda", "cpu"):
        env = SoftMacEnv(pour_vel_cfg(), device=dev)
        outs[dev] = env.rollout(actions(steps, seed=2))
    xg = outs["cuda"]["carry"][0].x.double().cpu()
    xc = outs["cpu"]["carry"][0].x
    lg, lc = outs["cuda"]["loss"].item(), outs["cpu"]["loss"].item()
    res = {"n_particles": env.n_particles, "env_steps": steps,
           "x_max_abs_err": (xg - xc).abs().max().item(),
           "loss_gpu": lg, "loss_cpu": lc,
           "loss_rel_err": abs(lg - lc) / abs(lc), "tolerance": 1e-4}
    if not (res["x_max_abs_err"] <= 1e-4 and res["loss_rel_err"] <= 1e-4):
        raise AssertionError(f"GPU/CPU parity failed: {res}")
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "softmac_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", {"nvidia_smi": smi, "torch": kind,
                    "torch_version": torch.__version__,
                    "cuda": torch.version.cuda})

    so, log, secs = build.build()
    build.library()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    emit("build", {"seconds": secs, "library": so.name, "ptxas": regs})

    env = SoftMacEnv(pour_vel_cfg(WINDOW),
                     init_particles=tiled_pour_vel_particles(N_MAIN))
    state10 = env.rollout(actions(STATE_STEPS))["carry"]   # also warms up
    kernels = check_kernels(kernel_inputs(env, state10))
    slice_res, launches = run_slice(env)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    emit(None, {"kernels": kernels})
    emit("slice", slice_res)
    emit("profile", run_profile(env))
    emit("parity", run_parity())
    emit(None, {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                      "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
