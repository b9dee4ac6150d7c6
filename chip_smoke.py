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
           for the same work, launches on the main paths. The contact kernel
           is also held against its plain version on particles spread over
           each body's SDF box, so that both bodies have many contacts. The
           three backward kernels (p2g_bwd, g2p_bwd, collide_particle_bwd)
           are held against the plain vjps in float64 on the same inputs
           with seeded normal cotangents
  slice    the forward main path: SoftMacEnv.rollout of that scene for 100
           env steps on the card, launches counted; then 7 more timed
           rollouts of the same actions: substeps/s (median and spread),
           loss, overflow, and how far the repeats' end states differ
  grad     the gradient main path: SoftMacEnv.rollout_and_grad of the same
           scene and actions (loss_start_frame 0, loss_stride 20), under
           remat "step" and "none": one counted call and 5 timed ones each,
           fwd+bwd substeps/s, peak device memory, the launches of all six
           kernels, finite nonzero gradients, and how far step and none and
           the repeats differ
  profile  torch.profiler over 20 env steps of the rollout and 10 of
           rollout_and_grad (remat "none"): device busy share of the wall
           time, kernel launches per substep, the kernels that take the most
           device time
  parity   the demo's own 5000-particle scene, card (float32, kernels)
           against the CPU (float64, plain versions): 20 steps of rollout
           and of rollout_and_grad

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
                      "collide_particle": 240,
                      # backward: weights and their derivatives ~80, per
                      # (y, z) pair 9; per cell p2g_bwd 13 channel sums +
                      # 4 weight cotangents + 3 position terms ~82, g2p_bwd
                      # the splat ~25 + 4 weight cotangents + 3 position
                      # terms ~55; contact: the forward again + the reverse
                      # sweep (3 rotation adjoints, trilinear 8 x 12) ~310,
                      # in double in the kernel, counted at the float32
                      # rate (the least time for the same work)
                      "p2g_bwd": 80 + 81 + 27 * 82,
                      "g2p_bwd": 80 + 81 + 27 * 80,
                      "collide_particle_bwd": 240 + 310}
GRAD_REPEATS = 5
GRAD_TOL = 1e-6           # step vs none, repeats vs the counted call
ROW_TOL = 1e-5            # backward rows and grids
BODY_TOL = 1e-4           # the 14 body floats, sums over 1e5 particles
FORWARD = ("p2g", "g2p", "collide_particle")


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


def kernel_entry(n, name, src, replaces, abs_err, rel_err, ms, plain_ms,
                 bytes_moved, tolerance=1e-5):
    """One kernel's JSON entry (launches filled in by the caller); raises
    when the kernel disagrees with its plain version."""
    b_ms, b_by = bound(name, n, bytes_moved)
    replaces, tpu_function = replaces.split(" ", 1)
    if not rel_err <= tolerance:
        raise AssertionError(f"{name}: relative error {rel_err} > "
                             f"{tolerance}")
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "tpu_function": tpu_function,
            "launches": None,
            "max_abs_err": abs_err, "max_rel_err": rel_err,
            "tolerance": tolerance, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": bytes_moved,
            "library_ms": None}


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

    def entry(*args):
        entries.append(kernel_entry(n, *args))

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


def _f64(t):
    """Floating tensors promoted to float64; anything else as it is."""
    import torch
    return t.double() if torch.is_tensor(t) and t.is_floating_point() else t


def _errors(got, want, names):
    """Per output: (max |kernel - plain|, that / max |plain|)."""
    out = {}
    for name, g, w in zip(names, got, want):
        err = (g.double() - w).abs().max().item()
        out[name] = (err, err / max(w.abs().max().item(), 1e-30))
    return out


def check_backward_kernels(inp):
    """The three backward kernels against the plain vjps run in float64 on
    the same inputs (float32 values promoted), with seeded normal
    cotangents. Rows and grids within ROW_TOL of the largest |value| of
    each output, the contact's 14 body floats (sums over 1e5 particles)
    within BODY_TOL of the largest |value| in their group."""
    import torch
    from softmac_tpu_torch.ops import transfer
    cfg, x = inp["cfg"], inp["state"].x
    n = x.shape[1]
    corner, sizes = inp["corner"], inp["sizes"]
    wx, wy, wz = sizes
    cells = wx * wy * wz
    gen = torch.Generator(device=x.device).manual_seed(1)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=x.dtype,
                           device=x.device)

    entries = []
    # --- p2g_bwd -----------------------------------------------------------
    args = (x, inp["chan"], corner, sizes, cfg.inv_dx,
            normal(wy * wz, wx), normal(wy * wz, 3 * wx))
    errs = _errors(transfer.p2g_bwd(*args),
                   transfer.p2g_vjp_plain(*map(_f64, args)), ("dx", "dchan"))
    entries.append(kernel_entry(
        n, "p2g_bwd", "softmac_tpu_torch/ops/csrc/p2g_bwd.cu",
        "softmac_tpu/ops/pallas_chunked.py:661 (_p2g_c_bwd_pallas, "
        "pallas_call :679, kernel _p2g_c_bwd_kernel :338)",
        max(e[0] for e in errs.values()), max(e[1] for e in errs.values()),
        cuda_time_ms(lambda: transfer.p2g_bwd(*args)),
        cuda_time_ms(lambda: transfer.p2g_vjp_plain(*args)),
        (32 * n + 4 * cells) * 4, ROW_TOL))
    entries[-1]["rel_err_by_output"] = {k: e[1] for k, e in errs.items()}

    # --- g2p_bwd -----------------------------------------------------------
    args = (x, *inp["grids"], corner, sizes, cfg.inv_dx, normal(12, n))
    errs = _errors(transfer.g2p_bwd(*args),
                   transfer.g2p_vjp_plain(*map(_f64, args)),
                   ("dx", "dgv0", "dgv1", "dgv2"))
    entries.append(kernel_entry(
        n, "g2p_bwd", "softmac_tpu_torch/ops/csrc/g2p_bwd.cu",
        "softmac_tpu/ops/pallas_chunked.py:713 (_g2p_c_bwd_pallas, "
        "pallas_call :729, kernel _g2p_c_bwd_kernel :428)",
        max(e[0] for e in errs.values()), max(e[1] for e in errs.values()),
        cuda_time_ms(lambda: transfer.g2p_bwd(*args)),
        cuda_time_ms(lambda: transfer.g2p_vjp_plain(*args)),
        (18 * n + 6 * cells) * 4, ROW_TOL))
    entries[-1]["rel_err_by_output"] = {k: e[1] for k, e in errs.items()}

    entries.append(check_contact_backward(inp, normal))
    return entries


def check_contact_backward(inp, normal):
    """collide_particle_bwd against collide_particle_vjp_plain in float64,
    per body, on the main path's particles and on particles spread over
    the body's SDF box (>= MIN_BOX_CONTACTS contacts there)."""
    import torch
    from softmac_tpu_torch.ops import contact, m33
    cfg, st = inp["cfg"], inp["state"]
    x, v, n = st.x, st.v, st.x.shape[1]
    gen = torch.Generator(device=x.device).manual_seed(0)
    groups = {"dx": None, "dv": None, "body_pos": (0, 3),
              "body_quat": (3, 7), "body_v": (7, 10), "body_w": (10, 13),
              "friction": (13, 14)}
    worst = {k: (0.0, 0.0) for k in groups}
    ms = plain_ms = 0.0
    nbytes = 0
    for b, (prim, bp, bq, bv, bw, fr) in enumerate(inp["contacts"]):
        prim64 = prim.replace(neighborhood=prim.neighborhood.double(),
                              lower=prim.lower.double(),
                              upper=prim.upper.double(),
                              inv_dx=prim.inv_dx.double())
        x_box = box_particles(prim, bp, bq, n, gen)
        for xs, label in ((x, "main path"), (x_box, "SDF box")):
            cargs = (prim, bp, bq, bv, bw, fr, xs, v, cfg.dt, cfg.p_mass)
            cargs64 = (prim64,) + tuple(map(_f64, cargs[1:8])) + cargs[8:]
            dimp = normal(3, n)
            got = contact.collide_particle_bwd(*cargs, dimp)
            want = contact.collide_particle_vjp_plain(*cargs64, dimp.double())
            got = (torch.cat([g.reshape(-1) for g in got[:5]]),) + got[5:]
            want = (torch.cat([w.reshape(-1) for w in want[:5]]),) + want[5:]
            for name, sl in groups.items():
                if sl is None:
                    g, w = got[1 + (name == "dv")], want[1 + (name == "dv")]
                else:
                    g, w = got[0][sl[0]:sl[1]], want[0][sl[0]:sl[1]]
                (err, rel), = _errors((g,), (w,), (name,)).values()
                worst[name] = max(worst[name], (rel, err))
            contacts = int(contact.collide_particle_plain(*cargs)[1].sum())
            print(f"collide_particle_bwd body {b} {label}: contacts "
                  f"{contacts}, worst rel err so far " + json.dumps(
                      {k: w[0] for k, w in worst.items()}), flush=True)
            if label == "SDF box" and contacts < MIN_BOX_CONTACTS:
                raise AssertionError(f"collide_particle_bwd: only {contacts} "
                                     f"contacts in body {b}'s SDF box")
        cargs = (prim, bp, bq, bv, bw, fr, x, v, cfg.dt, cfg.p_mass)
        dimp = normal(3, n)
        ms += cuda_time_ms(lambda: contact.collide_particle_bwd(*cargs, dimp))
        plain_ms += cuda_time_ms(
            lambda: contact.collide_particle_vjp_plain(*cargs, dimp))
        qinv = m33.qnorm(m33.qconj(tuple(bq)))
        p_loc = m33.qrot(qinv, m33.vsub(tuple(x), tuple(bp)))
        rows = torch.unique(contact.cell_index(prim, p_loc)[0]).numel()
        nbytes += 15 * n * 4 + rows * 128 + 14 * 4 + 14 * (-(-n // 256)) * 4
    for name, (rel, _) in worst.items():
        tol = ROW_TOL if groups[name] is None else BODY_TOL
        if not rel <= tol:
            raise AssertionError(f"collide_particle_bwd: {name} relative "
                                 f"error {rel} > {tol}")
    e = kernel_entry(
        n, "collide_particle_bwd", "softmac_tpu_torch/ops/csrc/contact_bwd.cu",
        "softmac_tpu/ops/pallas_contact.py:401 (_make_particle_bwd_kernel, "
        "launched from _particle_factory's _bwd :749)",
        max(w[1] for w in worst.values()),
        max(worst["dx"][0], worst["dv"][0]), ms, plain_ms, nbytes, ROW_TOL)
    e["rel_err_by_output"] = {k: w[0] for k, w in worst.items()}
    e["tolerance_by_output"] = {k: ROW_TOL if sl is None else BODY_TOL
                                for k, sl in groups.items()}
    e["rel_err_is"] = ("max |kernel - plain| / max |plain| of the dx and dv "
                       "rows over both bodies and both particle sets; the "
                       "body groups in rel_err_by_output; times and bytes "
                       "(main path's particles) summed over glass + bowl")
    e["per_substep"] = len(inp["contacts"])
    return e


def timed_rollout(env, acts):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = env.rollout(acts)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def wrappers():
    from softmac_tpu_torch.ops import contact, transfer
    return {"p2g": transfer.p2g, "g2p": transfer.g2p,
            "collide_particle": contact.collide_particle,
            "p2g_bwd": transfer.p2g_bwd, "g2p_bwd": transfer.g2p_bwd,
            "collide_particle_bwd": contact.collide_particle_bwd}


def reset_launches():
    for w in wrappers().values():
        w.launches = 0


def read_launches():
    return {k: w.launches for k, w in wrappers().items()}


def run_slice(env):
    """The main path: one rollout with the launches counted from zero, then
    SLICE_REPEATS timed rollouts of the same actions."""
    import torch
    acts = actions(SLICE_STEPS)
    reset_launches()
    out, secs = timed_rollout(env, acts)
    launches = read_launches()
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
              "collide_particle": n_sub * env.n_primitives,
              "p2g_bwd": 0, "g2p_bwd": 0, "collide_particle_bwd": 0}
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    if out["loss"].requires_grad or state.x.requires_grad:
        raise AssertionError("rollout kept an autograd graph")
    if terms["window_overflow"] or not math.isfinite(loss) \
            or not res["x_finite"] or res["x_shape"] != [3, env.n_particles]:
        raise AssertionError(f"slice output wrong: {res}")
    return res, launches


def timed_grad(env, acts, remat):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = env.rollout_and_grad(acts, loss_start_frame=0, loss_stride=20,
                               remat=remat)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_grad(env):
    """The gradient main path: rollout_and_grad of the slice phase's
    actions under remat "step" and "none", each one counted call (launches
    from zero, peak memory) and GRAD_REPEATS timed ones."""
    import torch
    acts = actions(SLICE_STEPS)
    n_sub = SLICE_STEPS * env.substeps
    # the first env step's state does not depend on the actions (the first
    # action sets the bodies' velocities at its end), so autograd records
    # nothing there: no replay under remat "step", no backward launches
    graded = (SLICE_STEPS - 1) * env.substeps
    per_step = {"p2g": 1, "g2p": 1, "collide_particle": env.n_primitives}
    res, launches, grads = {}, {}, {}
    for remat in ("step", "none"):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out, secs = timed_grad(env, acts, remat)
        launches[remat] = read_launches()
        peak = torch.cuda.max_memory_allocated()
        g = out["action_grad"]
        loss = out["loss"].item()
        replays = graded if remat == "step" else 0   # checkpoint replays
        expect = {}
        for k, c in per_step.items():
            expect[k] = c * (n_sub + replays)
            expect[k + "_bwd"] = c * graded
        if launches[remat] != expect:
            raise AssertionError(f"grad ({remat}): launch counts "
                                 f"{launches[remat]}, expected {expect}")
        if not math.isfinite(loss) or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"grad ({remat}): non-finite loss {loss} "
                                 "or action gradient")
        if bool(out["terms"]["window_overflow"]):
            raise AssertionError(f"grad ({remat}): window overflow")
        glass = g[:, [2, 3, 4]]   # the glass's wz, vx, vy
        if not bool((glass != 0).any()):
            raise AssertionError(f"grad ({remat}): the glass's (wz, vx, vy) "
                                 "columns of action_grad are all zero")
        gmax = g.abs().max().item()
        rates, rep_diff = [], 0.0
        for _ in range(GRAD_REPEATS):
            rep, rep_secs = timed_grad(env, acts, remat)
            rates.append(n_sub / rep_secs)
            rep_diff = max(rep_diff,
                           (rep["action_grad"] - g).abs().max().item())
        grads[remat] = g
        res[remat] = {
            "fwd_bwd_substeps_per_s": statistics.median(rates),
            "substeps_per_s_min": min(rates),
            "substeps_per_s_max": max(rates),
            "substeps_per_s_runs": rates,
            "counted_run_substeps_per_s": n_sub / secs,
            "max_memory_allocated_bytes": peak,
            "loss": loss, "action_grad_max_abs": gmax,
            "glass_grad_max_abs": glass.abs().max().item(),
            "repeat_grad_max_abs_diff": rep_diff,
            "repeat_grad_rel_diff": rep_diff / gmax,
            "launches": launches[remat]}
        if not rep_diff <= GRAD_TOL * gmax:
            raise AssertionError(f"grad ({remat}): repeats differ by "
                                 f"{rep_diff} > {GRAD_TOL} x {gmax}")
    diff = (grads["step"] - grads["none"]).abs().max().item()
    gmax = grads["none"].abs().max().item()
    out = {"n_particles": env.n_particles, "window": list(WINDOW),
           "env_steps": SLICE_STEPS, "substeps": n_sub,
           "loss_start_frame": 0, "loss_stride": 20,
           "step_vs_none_grad_max_abs_diff": diff,
           "step_vs_none_grad_rel_diff": diff / gmax,
           "tolerance": GRAD_TOL, **res}
    if not diff <= GRAD_TOL * gmax:
        raise AssertionError(f"grad: step and none differ by {diff} > "
                             f"{GRAD_TOL} x {gmax}")
    return out, launches


def run_profile(env, steps=20, grad=False):
    """Device busy share and the top kernels over a short rollout (or
    rollout_and_grad with remat "none")."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = actions(steps, seed=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if grad:
            env.rollout_and_grad(acts, loss_start_frame=0, loss_stride=steps,
                                 remat="none")
        else:
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
    return {"env_steps": steps, "grad": grad,
            "wall_ms_per_substep": wall * 1e3 / n_sub,
            "device_busy_ms_per_substep": busy_us / 1e3 / n_sub,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches_per_substep": len(kern) / n_sub,
            "top_kernels": [{"name": k[:90], "ms_per_substep": t / 1e3 / n_sub,
                             "calls_per_substep": c / n_sub}
                            for k, (t, c) in top]}


def run_parity():
    """Card (float32, kernels) against the CPU (float64, plain versions)
    on the demo's own scene."""
    from softmac_tpu_torch import SoftMacEnv
    steps = 20
    outs, grads = {}, {}
    for dev in ("cuda", "cpu"):
        env = SoftMacEnv(pour_vel_cfg(), device=dev)
        outs[dev] = env.rollout(actions(steps, seed=2))
        grads[dev] = env.rollout_and_grad(actions(steps, seed=2))
    xg = outs["cuda"]["carry"][0].x.double().cpu()
    xc = outs["cpu"]["carry"][0].x
    lg, lc = outs["cuda"]["loss"].item(), outs["cpu"]["loss"].item()
    res = {"n_particles": env.n_particles, "env_steps": steps,
           "x_max_abs_err": (xg - xc).abs().max().item(),
           "loss_gpu": lg, "loss_cpu": lc,
           "loss_rel_err": abs(lg - lc) / abs(lc), "tolerance": 1e-4}
    if not (res["x_max_abs_err"] <= 1e-4 and res["loss_rel_err"] <= 1e-4):
        raise AssertionError(f"GPU/CPU parity failed: {res}")
    gg = grads["cuda"]["action_grad"].double().cpu()
    gc = grads["cpu"]["action_grad"]
    lg, lc = grads["cuda"]["loss"].item(), grads["cpu"]["loss"].item()
    res["grad"] = {"loss_gpu": lg, "loss_cpu": lc,
                   "loss_rel_err": abs(lg - lc) / abs(lc),
                   "loss_tolerance": 1e-4,
                   "action_grad_rel_l2_err": ((gg - gc).norm().item()
                                              / gc.norm().item()),
                   "action_grad_tolerance": 1e-3,
                   "action_grad_cpu_max_abs": gc.abs().max().item()}
    if not (res["grad"]["loss_rel_err"] <= 1e-4
            and res["grad"]["action_grad_rel_l2_err"] <= 1e-3):
        raise AssertionError(f"GPU/CPU gradient parity failed: {res}")
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
    inp = kernel_inputs(env, state10)
    kernels = check_kernels(inp) + check_backward_kernels(inp)
    slice_res, launches = run_slice(env)
    grad_res, grad_launches = run_grad(env)
    for k in kernels:
        # the forward kernels' main path is the rollout, the backward
        # kernels' the gradient path with the default remat ("step")
        path = launches if k["name"] in FORWARD else grad_launches["step"]
        k["launches"] = path[k["name"]]
        k["launches_by_path"] = {
            "slice": launches[k["name"]],
            "grad_step": grad_launches["step"][k["name"]],
            "grad_none": grad_launches["none"][k["name"]]}
    emit(None, {"kernels": kernels})
    emit("slice", slice_res)
    emit("grad", grad_res)
    emit("profile", run_profile(env))
    emit("profile_grad", run_profile(env, steps=10, grad=True))
    emit("parity", run_parity())
    emit(None, {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                      "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
