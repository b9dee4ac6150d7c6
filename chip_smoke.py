#!/usr/bin/env python3
"""Drive the PyTorch port (softmac_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printed on a line of its own; any failed phase raises and the
script exits non-zero:

  device   the card as nvidia-smi reports it (name, power limit)
  build    nvcc builds the CUDA kernels from softmac_tpu_torch/ops/csrc;
           each kernel's registers, spills and static shared memory from
           the ptxas log (also in its entry of the kernels line); the
           row-thread kernels of fused_rows.cuh (the door's P2G and G2P
           and the P2G, G2P, splat and gather backwards) apart
           ("row_kernels"), which fail the phase if they spill; so do the
           penalty contact pair and the read-side tile kernels (G2P, the
           gather and the P2G and splat backwards,
           ops/csrc/slab_read.cuh), whose registers and spills are
           printed
  kernels  each kernel against its plain PyTorch version at the main path's
           shapes: max error, time over 20+ calls (CUDA events: the call,
           the wrapper's host time included), its device-only time
           (torch.profiler over 10 calls: the device kernels a call
           launched), the plain version's time, the least time the card
           needs for the same work, launches on the main paths. P2G, G2P
           and the particle contact (the tiled kernel, which returns the
           impulse and the wrench) on the 1e5-particle pour_vel scene,
           window (40, 32, 16), the state after 10 env steps; the three
           backward kernels (p2g_bwd, g2p_bwd, collide_particle_bwd, which
           takes the cotangents of the impulse and the wrench) against the
           plain vjps in float64 on the same inputs with seeded normal
           cotangents; gather, splat and the mixed contact (the
           tiled kernel, which returns p_v_out and the wrench, and the
           split pair with the wrench's PyTorch reduction) against their
           plain versions in float64 on the flagship pour scene's state
           after 10 env steps (1e5 particles, window (32, 32, 16)), their
           inputs built by the kernels so that they repeat; the backward
           kernels of those (gather_bwd, splat_bwd, the tiled
           collide_mixed_bwd, which takes the wrench's cotangent, and the
           split pair collide_mixed2_bwd -> collide_mixed1_bwd after the
           tail's autograd) against their plain vjps in float64 on the same
           inputs. Both contact families (each a tiled pair: 10 calls
           bit-identical, the build phase failing if ptxas reports a spill
           for the penalty pair) are also held on particles spread
           over each body's SDF box, so that both bodies have many contacts
           (and, for the mixed contact, particles that approach, lie in the
           soft band, penetrate and forecast across a cell face), and the
           mixed contact on 1e5 particles of the glass's box all in the
           contact band: the band's particles and the fullest tile's
           counted, 10 calls bit-identical, call and device time on each
           set of particles. G2P, the gather and the P2G and splat
           backwards (the read-side tiles of ops/csrc/slab_read.cuh: a
           tile's box of window cells staged in shared memory; the splat
           backward's entry also counts the band, its nonzero values) are
           held to their float64 plain versions or vjps within 1e-5 of
           each output row's largest |value| on the pour_vel and pour
           states, on a random permutation of each, over the full 64^3
           grid and on as many particles spread uniformly over the pour's
           window: the particles that read device memory instead of the
           slab counted (none in the two main-path states' sorted order;
           some order of each must: the spread state's permutation), 10
           calls bit-identical, call and device ms. The y-slab kernels
           (ops/csrc/slab.cuh: P2G,
           the splat and the G2P and gather backwards) are also held on
           the pour_vel and pour states, on a random permutation of each,
           and over the full 64^3 grid: within 1e-5 of the float64 plain
           version or vjp, the particles that spilled off their tile's
           slab counted (none in the sorted order; some permuted order of
           each must spill), 10 calls bit-identical; on the two windowed
           states the backwards' call and device time
  slice    the pour_vel main path: SoftMacEnv.rollout of that scene for 50
           env steps on the card, launches counted, G2P's particles off
           its tiles' slabs summed over the run; then 3 more timed
           rollouts of the same actions: substeps/s (median and spread),
           loss, overflow, and how far the repeats' end states differ
  grad     pour_vel's gradient path: SoftMacEnv.rollout_and_grad of the
           same scene and actions (loss_start_frame 0, loss_stride 20),
           under remat "step" and "none": one counted call and a timed one
           each, fwd+bwd substeps/s, peak device memory, the launches of its
           six kernels, finite nonzero gradients, and how far step and none
           and the repeats differ; the read-side kernels' particles off
           their tiles' slabs summed over the counted calls
  pour     the flagship main path: SoftMacEnv.rollout of the demo_pour
           scene (mixed contact, two floating force-controlled bodies) at
           1e5 particles, window (32, 32, 16), 100 env steps of zero
           actions, launches counted, G2P's and the gather's particles off
           their tiles' slabs summed over the run; 3 more timed rollouts;
           then the same
           scene under SOFTMAC_TPU_CONTACT_SPLIT (the split contact
           kernels, counted)
  pour_grad  the flagship's gradient main path: rollout_and_grad of the
           same scene and actions (loss_start_frame 0, loss_stride 20)
           under remat "step" and "none": one counted call and a timed one
           each, fwd+bwd substeps/s, peak memory, the launches of every
           forward and backward kernel, a finite nonzero gradient, step
           against none and the repeats within GRAD_TOL, the read-side
           kernels' particles off the slab summed over the counted calls
           (G2P, the gather and the P2G and splat backwards); then 20 steps
           under SOFTMAC_TPU_CONTACT_SPLIT (the split backward pair,
           counted) against the merged gradient. The counted "step" call
           keeps the inputs of three real calls of gather_bwd and g2p_bwd
           and counts each call's nonzero cotangent columns; on the kept
           inputs both kernels are held to the float64 plain vjps (10
           calls bit-identical) and timed (the "real" field of their
           kernel entries)
  profile  torch.profiler over 20 env steps of each rollout and 10 of each
           rollout_and_grad (remat "none"): device busy share of the wall
           time, kernel launches per substep, the kernels that take the
           most device time, and each of the port's own kernels' device
           time a launch and launches a substep; on pour_vel's rollout
           and gradient the penalty contact's kernels held to one launch
           a body a substep (by kernel name)
  parity   each demo's own 5000-particle scene, card (float32, kernels)
           against the CPU (float64, plain versions): 20 steps of rollout
           and of rollout_and_grad
  demo     the ported trainer softmac_tpu_torch.demos.demo_pour on the
           card, 2 epochs of 60 env steps on its own scene: finite losses,
           losses.npy and the checkpoints written, the actions moved, every
           kernel launched, the epoch times
  door     the door's main path (demo_door_config.py: 5400 particles in
           three corotated-elastic boxes, window (32, 16, 32), one particle
           controller, the revolute door): the dense-weight transfer
           kernels (fused_p2g, fused_g2p, fused_splat, fused_gather) and
           their backward kernels (fused_*_bwd) are first held against
           their float64 plain versions and plain vjps (seeded normal
           cotangents) on the door's state after 10 env steps, on fully
           dense random weights (window (16, 8, 16)) and on that state
           tiled to 1e5 particles, 10 calls of each bit-identical on every
           input, and timed on the door's state and at 1e5, beside their
           plain versions and one torch.einsum over the dense weights, or
           one torch.autograd.grad through it (the library calls); the
           four forwards also held and timed on the door's state after 150
           env steps, whose contact band is not empty (the splat's band
           printed), their device launches a call held (P2G 3, G2P 1, the
           splat 2, the gather 1); then
           SoftMacEnv.rollout of the demo's initial actions for 300 env
           steps with launches counted, its end state against a
           zero-action rollout of the same 300 steps (the controller
           acts), 5 timed rollouts of 50 steps, and a 300-step horizon
           (cut from the demo's 3000) with the demo's loss frames
  door_grad  the door's gradient main path: rollout_and_grad of 50 env
           steps of the demo's initial actions with its loss frames and
           grad_clip 1.0, under remat "step" and "none": one counted call
           and one timed repeat each, exact launch counts of every forward
           and backward kernel (door_grad_expect), a finite nonzero
           gradient, step against none and the repeat within GRAD_TOL
  profile_door, profile_door_grad  torch.profiler over 20 env steps of the
           door's rollout (busy share, launches per substep, the SVD's share
           of them, top kernels) and 5 of its rollout_and_grad; then
           (door_index_origin) 2 env steps of rollout_and_grad profiled
           with Python stacks: the autograd node, forward op and call site
           of each launch of indexing_backward_kernel
  door_parity  the door, card (float32, kernels) against the CPU (float64,
           plain versions), 20 env steps of rollout and of rollout_and_grad
  demo_door  the ported door trainer softmac_tpu_torch.demos.demo_door on
           the card, 2 epochs of 50 env steps with 2 jittered replicas on
           its own scene: finite non-increasing losses, losses.npy and the
           checkpoints written, the actions moved, every fused forward and
           backward kernel launched
  dense    the full-grid pour (demo_pour_config.py with TPU.active_window
           cleared: the 64^3 grid, the dense route) at 1e5 particles: the
           Khatri-Rao pair build kr3 is first held against its float32
           plain version (bit for bit) and its float64 plain version (1e-7
           relative) on the pour's state after 10 env steps over the full
           grid and over the (40, 32, 16) window, and on seeded normal
           weights (8, 16, N = 300), timed beside its plain version and
           three torch.mul into preallocated outputs; then SoftMacEnv.
           rollout of 20 zero-action env steps with launches counted (one
           kr3 a substep, the mixed contact, no ops/transfer.py or
           ops/fused.py kernel), peak memory, 3 timed repeats;
           rollout_and_grad of 10 steps (loss frames 5 and 10) under remat
           "step" only (the pair matrices take ~4.9 GB a substep), exact
           counts, a repeat; and the same rollout and gradient through the
           x-based route (mpm.transfer_route swapped within the phase) held
           to the dense route's (x 1e-4, action gradient 1e-3 relative L2)
  profile_dense  torch.profiler over 5 env steps of the full-grid rollout
  dense_parity  the full-grid pour at the demo's own 5000 particles, card
           (float32) against the CPU (float64), 5 env steps of rollout
           and of rollout_and_grad (remat "none")
  grid     the same scene under grid contact (SIMULATOR.collision_type 0):
           20 env steps on the card (one kr3 a substep, no contact kernel),
           the glass's wrench in the first env step nonzero, the glass
           moved; then card against CPU over 5 steps, forward and gradient
  grip     the grip (demo_grip_config.py: 10 000 particles of a
           corotated-plastic block, two prismatic fingers below a fixed
           palm whose contact is off, forecast mixed contact, five
           substeps an env step, window (32, 24, 32)), the fingers
           started 2.8 mm from the block and moving in: SoftMacEnv.rollout
           of 100 env steps (500 substeps) of the demo's 0.3 N, launches
           counted (exact: one P2G, G2P, gather and splat and two mixed
           contacts a substep), the y-slab kernels' spilled particles and
           the read-side kernels' off-slab particles summed over the run,
           each env step's wrench kept (the palm's zero, each finger's
           nonzero once in contact, the fingers moved inward), no
           overflow; a timed rollout of 20 env steps (wall ms a substep)
           and a profile of 4 (device ms a substep, busy share)
  grip_kernels  rows 1-8 and 11-12 of PERF.md's table on the grip's state
           after that rollout (in contact): P2G, G2P, the gather, the
           splat and their backwards against their float64 plain versions
           or vjps (seeded normal cotangents; the splat's backward on the
           real values) within 1e-5 of each output row's largest |value|,
           device ms beside the bound for this state; the mixed pair at
           each remaining-window factor life = 1, 1/2, 1/3, 1/4, 1/5 of
           the five substeps, on the state's particles and on particles
           spread over each finger's SDF box with seeded velocities (their
           forecast points penetrate, where life acts): p_v_out, the
           wrench and the cotangents of dx, dv and the 16 body floats
           (life's among them, nonzero in the box) within 1e-5 of the
           float64 plain version and vjp. The pour's and the door's mixed
           pair are held the same way at life 1 and 1/3 (their gates
           unchanged: body floats 1e-4), in the kernels line
  grip_grad  rollout_and_grad of 12 env steps of the demo's forces with
           its loss frames (every 20 substeps from three quarters of the
           horizon), under remat "step" and "none": one counted call and
           one timed repeat each, exact launch counts of every forward and
           backward kernel (grip_grad_expect), a finite gradient nonzero
           in the fingers' columns, step against none and the repeats
           within GRAD_TOL; spills and off-slab particles summed
  profile_grip  torch.profiler over 4 env steps of the grip's rollout
           (from the grip phase) and 4 of its rollout_and_grad (remat
           "none"), and the rigid step's launches
  grip_parity  the grip at its 10 000 particles, the fingers in contact,
           4 env steps, card (float32) against the CPU (float64): x, q and
           qd within 1e-4, the loss within 1e-4 relative, the action
           gradient within 1e-3 relative L2
  demo_grip, demo_pour_vel  the ported trainers
           softmac_tpu_torch.demos.demo_grip and demo_pour_vel on the
           card, 2 epochs of 12 env steps each on their own scenes: finite
           losses, losses.npy and the checkpoints written, every kernel of
           their forward and backward launched
  render   the renderer (engine/renderer.py, PyTorch tensor code in
           float64 on the card; no kernel of the port) on three snapshots:
           the flagship pour at 1e5 particles after 20 zero-action env
           steps (the glass at alpha 0.8, the bowl, the target; 512^2 at
           ssaa 2), the hit after its counted rollout (1024^2, the towel
           Gouraud-shaded, the target) and the door after STATE_STEPS env
           steps; each frame against the CPU's float64 frame of the same
           snapshot (at least 99.5 % of the pixels equal, the rest within
           2 of 255), not the bare floor; the card's ms a frame (median of
           5, synchronized) and the CPU's
  demo_render  one epoch of demo_pour (10 env steps) without, with and
           again without --render-interval 1: its GIF's frames, size and
           loop read by walking the GIF's blocks, loss_curve.png read back;
           the seconds rendering adds
  bake     the SDF bake on the card (float32): the door, the palm and the
           finger baked whole through preprocess_sdf on an empty cache
           (then timed, 3 bakes) and one y-slab of the glass's and the
           bowl's grids, against the shipped tables: sdf within 2e-6, no
           sign flip beyond it, at most 5 % of the cells with another
           face's normal, each a nearest-face tie in float64
  native   the port's C++ preprocessing library (native/preprocess.cpp)
           built with g++ on the card's host, its OBJ parse and its face
           adjacency equal to the Python bodies
  hit, hit_kernels, hit_grad, profile_hit, hit_parity, demo_hit  the hit
           (demo_hit_config.py: 5000 particles, two cylinders on the
           controller pushed at -8 on z into a 144-vertex towel, ten
           substeps an env step, window (32, 24, 32)): 60 env steps of the
           push (contact from env step 16) with exact launches (one P2G,
           G2P, gather and splat a substep; the cloth path is plain
           PyTorch), spills, off-slab particles and each env step's pairs
           and vertex forces; rows 1-8 on its state in contact within 1e-5
           of float64; 5 env steps of rollout_and_grad from that state
           (remat "step", exact launches, repeats within GRAD_TOL); a
           profile of one env step forward and one fwd+bwd; 3 env steps
           card against CPU float64 (x of the particles whose pair agrees,
           the towel's x and the loss within 1e-4); the trainer, 2 epochs
           of 6 env steps
  taco, taco_kernels, taco_grad, profile_taco, taco_parity, demo_taco  the
           taco (demo_taco_config.py: a 10 000-particle plastic disk on a
           217-vertex tortilla whose 17 attachment vertices the actions
           move, the cloth control mode, sticky contact with gradient
           scales 0.3, mpm_scale 5, window (48, 24, 48)): the first 30 env
           steps of the demo's 200-step scripted fold, contact in every
           env step from the first, exact launches, spills, off-slab
           particles; rows 1-8 on its state within 1e-5 of float64; 3 env
           steps of rollout_and_grad from that state with the demo's
           grad_clip (exact launches from taco_grad_expect, repeats within
           GRAD_TOL, nonzero on the handles' x and y); a profile of one env
           step forward and two fwd+bwd (the handles reach the particles an
           env step late); 3 env steps card against CPU float64 at 10 000
           particles (gates as the hit's); the trainer for one epoch of 4
           env steps with each optimiser (Adam over 2 jittered replicas, the
           line search), launch counts exact
  policy_grad  the closed-loop policy (engine/policy.py) on the slice's
           1e5-particle pour_vel: the demo's MLP (64, 64) from seed 0 maps
           200 subsampled particles' x and v and the bodies' state to the
           velocity command at each of 50 env steps, each env step
           checkpointed; the loss and its gradient with respect to the
           MLP's parameters: launches exact (as the pour_vel gradient's
           under remat "step", rehearsed on the CPU), finite, nonzero, no
           overflow, a repeat bit-identical, fwd+bwd substeps/s, peak
           memory, and a profile of 5 env steps. Its launches are the
           kernels line's "policy_grad" path
  policy_deploy  the same weights on the demo's 5000-particle scene: 50
           env steps closed loop through the facade (reset,
           get_observation, step; launches exact) against the closed-loop
           forward's exit x within 1e-5 of its largest |x|; a get_state /
           step / set_state round trip exact; backward() finite
  demo_policy  the ported trainer softmac_tpu_torch.demos.demo_policy, 3
           epochs of 60 env steps on its own scene: finite losses,
           losses.npy and policy_<epoch>.pt written, the parameters moved,
           rows 1-4, 9 and 10 launched
  pour_body_contact  the flagship pour at 1e5 particles, window (32, 32,
           16), with RIGID.body_contact on (the glass's and the bowl's
           256 surface samples in each other's SDF table): 100 zero-action
           env steps with the plain pour's launches exactly, its x and q
           against the plain pour's; rollout_and_grad of 20 env steps
           under "step" and "none" (exact launches, finite, repeats
           bit-identical); the launches and device ms a substep that body
           contact adds (profiles of both scenes and of one rigid step of
           each); one epoch of demo_pour --body-contact
  body_contact_drop  demos.demo_body_contact (the glass dropped on the
           floating bowl, 2000 particles parked, contact off and on, 300
           env steps through the facade, the overlap of each recorded
           state in one batched call; the script's four checks), with the
           stick branch and with --no-stick: launches exact (rows 1, 3, 5,
           7 and 11)
  chain_blob  a double pendulum whose links are the gripper's finger mesh
           (an articulated tree, engine/chain.py) swinging into a
           1e4-particle elastic blob: 250 env steps (launches exact, the
           blob pushed sideways, the arm slowed against the free
           pendulum), rollout_and_grad of 20 env steps from the carry in
           contact under "step" and "none" (exact launches, repeats
           bit-identical), a profile and one tree step's launches and
           device ms
  rigid_family  welds (a rod with a welded tip; the gripper's palm on a
           slider with its fingers welded on), trees (the palm on a slider
           with its fingers sliding below it; a floating base carrying an
           arm) stepped on the card in float32 against the same models on
           the CPU in float64; the floating tree's linear momentum stays
           zero under internal actuation alone
  transport  TransportLoss on a reduced pour_vel (256 particles, 2 env
           steps): finite terms, a finite nonzero action gradient, rows
           1-4, 9 and 10 launched exactly

The last line is {"ok": true, "device": {...}}. Without CUDA, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WINDOW = (40, 32, 16)
POUR_WINDOW = (32, 32, 16)        # bench.py's build_headline_env
N_MAIN = 100_000
SPLIT_STEPS = 20
SLICE_STEPS = 100
VEL_STEPS = 50                    # pour_vel's paths, cut to keep the time
SLICE_REPEATS = 3          # cut from 7 to keep the time
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
                      # the three grid channels' terms (4 products and 3
                      # adds each, summed per slab cell) ~25 + dx's 4
                      # weight cotangents + 3 position terms ~55; contact:
                      # the forward again + the reverse
                      # sweep (3 rotation adjoints, trilinear 8 x 12) ~310,
                      # in double in the kernel, counted at the float32
                      # rate (the least time for the same work)
                      "p2g_bwd": 80 + 81 + 27 * 82,
                      "g2p_bwd": 80 + 81 + 27 * 80,
                      "collide_particle_bwd": 240 + 310,
                      # gather and splat: the weights ~57, per (y, z) pair
                      # 1, per cell the weight and 3 multiply-adds (7)
                      "gather": 57 + 9 + 27 * 7, "splat": 57 + 9 + 27 * 7,
                      # mixed contact: 4 quaternion rotations ~30 each, two
                      # trilinear samples 8 x 10 + normalisation ~90 each,
                      # the friction cone, soft band, forecast and push-out
                      # ~130; in double in the kernel, counted at the
                      # float32 rate (the least time for the same work); the
                      # split pair does the same work
                      "collide_mixed": 430, "collide_mixed_split": 430,
                      # gather / splat backward: weights and their
                      # derivatives ~80, per (y, z) pair 9, per cell the
                      # 3 grid cotangent terms (gather_bwd, summed per slab
                      # cell) or the gather of 3 values (splat_bwd) (6),
                      # the weight cotangent (6) and 3 position terms (12);
                      # a gather_bwd particle whose cotangent is zero needs
                      # none of it (check_real_backward counts those apart)
                      "gather_bwd": 80 + 81 + 27 * 24,
                      "splat_bwd": 80 + 81 + 27 * 24,
                      # mixed backward: the forward again ~430 and its
                      # reverse sweep (5 rotation adjoints ~40 each, two
                      # trilinear adjoints 8 x 14 + normalisations, the
                      # cone, soft band and push-out) ~470, in double,
                      # counted at the float32 rate; the split pair the same
                      "collide_mixed_bwd": 900, "collide_mixed_split_bwd": 900}
# the tiled mixed-contact kernels: every particle's classification (the
# body-frame rotation ~30, the cell ~20, the trilinear SDF lane 8 x 4),
# the band's particles the whole contact above
MIXED_CLASSIFY_FLOPS = 30 + 20 + 32
MIXED_REPEATS = 10         # tiled mixed-contact calls agreeing bit for bit
DEVICE_MS = {}             # device_ms: device-only ms a call, by kernel row
EVENT_TIMED = set()        # device_ms calls timed by CUDA events instead
# the names of the port's kernels in a profile (ops/csrc/*.cu)
PORT_KERNEL = (r"(p2g|g2p|gather|splat|collide|kr3|slab_|rows_"
               r"|round_to_float|round_and_clear)\w*(<[^>]*>)?\(")
# the launches that round a float64 window (left out of a source's ptxas)
ROUND_KERNELS = ("round_to_float", "round_and_clear")
GRAD_REPEATS = 1           # cut from 5 to keep the time
GRAD_TOL = 1e-6           # step vs none, repeats vs the counted call
ROW_TOL = 1e-5            # backward rows and grids
BODY_TOL = 1e-4           # the 14 body floats, sums over 1e5 particles
FORWARD = ("p2g", "g2p", "collide_particle")
POUR = ("gather", "splat", "collide_mixed")
POUR_BWD = ("gather_bwd", "splat_bwd", "collide_mixed_bwd")
DEMO_STEPS = 60
DEMO_EPOCHS = 2            # cut from 3 to keep the time
DOOR_STEPS = 300           # the counted door rollout
DOOR_TIMED_STEPS = 50      # each timed door rollout (cut to keep the time)
DOOR_REPEATS = 5
DOOR_HORIZON = 300         # cut from demos/demo_door.py's 3000 steps
DOOR_GRAD_STEPS = 50       # the door's rollout_and_grad (cut from 3000)
DOOR_GRAD_REPEATS = 1
DEMO_DOOR_STEPS = 50       # the door trainer (cut from 3000)
DEMO_DOOR_EPOCHS = 2
DEMO_DOOR_REPLICAS = 2
DENSE_WINDOW = (16, 8, 16)
N_DENSE = 4000
KR_WINDOW = (40, 32, 16)   # the window pallas_kr.py's docstring measured
KR_RANDOM = (8, 16, 300)   # wy, wz, N of tests/test_pallas_kr.py
FULL_STEPS = 20            # the full-grid pour's counted and timed rollouts
FULL_REPEATS = 3
FULL_GRAD_STEPS = 10       # its rollout_and_grad, remat "step" only
FULL_LOSS_STRIDE = 5       # loss frames 5 and 10 within those 10 steps
FULL_PROFILE_STEPS = 5
FULL_PARITY_STEPS = 5      # cut from 10 to keep the time
GRID_STEPS = 20
KR3_TOL = 1e-7
SLAB_REPEATS = 10          # y-slab calls that must agree bit for bit
# the backwards whose inputs pour_grad keeps from real calls: the calls
# CAPTURE_CALLS (from 1) of its first counted rollout_and_grad (remat
# "step": the backward walks from the last env step back, so these come
# late, mid-way and early in the rollout)
REAL_BWD = ("gather_bwd", "g2p_bwd")
CAPTURE_CALLS = (10, 50, 90)
FUSED = ("fused_p2g", "fused_g2p", "fused_splat", "fused_gather")
FUSED_BWD = tuple(k + "_bwd" for k in FUSED)
# the row-thread kernels (ops/csrc/fused_rows.cuh): also held at 1e5
# particles, FUSED_REPEATS calls bit-identical, no ptxas spills
ROW_KERNELS = ("fused_p2g", "fused_g2p", "fused_splat", "fused_gather",
               "fused_p2g_bwd", "fused_g2p_bwd", "fused_splat_bwd",
               "fused_gather_bwd")
# the device launches of one call of the dense-weight transfers: P2G's
# zero fill, kernel and round; the splat's kernel and round (its kept
# window needs no fill); G2P's and the gather's kernel
FUSED_CALL_LAUNCHES = {"fused_p2g": 3, "fused_g2p": 1, "fused_splat": 2,
                       "fused_gather": 1}
# the door's env steps before its band state, whose contact band holds
# particles (none yet after STATE_STEPS): the transfers are held and timed
# there too
BAND_STEPS = 150
FUSED_REPEATS = 10
# the tiled penalty contact pair: the build phase fails if ptxas reports a
# spill for them
PENALTY_SOURCES = ("contact.cu", "contact_bwd.cu")
# its device kernels, by name in a profile: each launches once a body a
# substep on pour_vel's paths (the backward on each substep of its
# gradient but the first env step's)
PENALTY_KERNELS = ("collide_particle_kernel", "collide_particle_bwd_kernel")
# float operations per visited window cell (the kernels work in double,
# counted at the float32 rate, the least time for the same work): the
# three weight products and the cell's terms
FLOPS_PER_CELL = {"fused_p2g": 6 + 1 + 3 * 7, "fused_g2p": 6 + 3 * 8,
                  "fused_splat": 2 + 3 * 2, "fused_gather": 2 + 3 * 2}
# the backward kernels: (float ops per cell of a weight-row sum, per cell of
# the particle's box). A row sum forms the cell's coefficients (P2G: 22, G2P:
# 20, splat and gather: 5) and adds them with its weights (14, 3); a box
# cell adds the channel or grid terms (P2G 32, G2P 27, splat and gather 8)
# the grip (demo_grip_config.py): the fingers started 2.8 mm from the
# block (the contact band is 5 mm) and moving in at 0.1 m/s under the
# demo's 0.3 N (its contact comes only after ~300 env steps from rest)
GRIP_NEAR = (0.017, -0.017, 0.1, -0.1)
GRIP_FORCE = 0.3
GRIP_STEPS = 100           # the counted rollout: 500 substeps
GRIP_TIMED_STEPS = 20      # the timed repeat (the host's clock)
GRIP_PROFILE_STEPS = 4
GRIP_GRAD_STEPS = 12       # cut from 40 to keep the time
GRIP_GRAD_REPEATS = 1
GRIP_GRAD_PROFILE_STEPS = 4   # 15 of its 20 substeps run backward
GRIP_PARITY_STEPS = 4
DEMO_GRIP_STEPS = 12       # both new trainers (cut from 400 and 2000)
# the forecast contact's remaining-window factor 1 / (substeps - k) over
# the grip's five substeps
GRIP_LIVES = (1.0, 1 / 2, 1 / 3, 1 / 4, 1 / 5)
GRIP_BODY_TOL = 1e-5       # the mixed pair's body floats on the grip
# the pour's and the door's mixed pair, also held at a life below 1
LIFE_BELOW_ONE = 1 / 3
HIT_FORCE = -8.0           # the demo's initial push on z
HIT_STEPS = 60             # the counted rollout (cut from the demo's 100)
HIT_GRAD_STEPS = 5         # from the rollout's carry, in contact
HIT_PROFILE_STEPS = 1
HIT_PARITY_STEPS = 3
HIT_PARITY_TOL = 1e-4      # x (particles whose pair agrees), cloth x, loss
HIT_MOVED = 1e-3           # the towel's least displacement in contact
DEMO_HIT_STEPS = 6         # the hit trainer (cut from 100)
DEMO_HIT_EPOCHS = 2
CLOTH_GRAD_REPEATS = 1     # the cloth scenes' timed gradient repeats
TACO_FOLD_STEPS = 200      # the demo's horizon, over which the fold runs
TACO_STEPS = 30            # the counted rollout: the fold's first 30 steps
TACO_MOVED = 1e-3          # the tortilla's least displacement
TACO_GRAD_STEPS = 3        # from the rollout's carry
TACO_GRAD_CLIP = 10.0      # the demo's
TACO_PROFILE_STEPS = 1     # forward; fwd+bwd one more (the actions reach
                           # the particles an env step late)
TACO_PARITY_STEPS = 3
TACO_PARITY_TOL = 1e-4     # x (particles whose pair agrees), cloth x, loss
DEMO_TACO_STEPS = 4        # each taco optimiser, one epoch (cut from 200)
DEMO_TACO_REPLICAS = 2
TRANSFERS = ("p2g", "g2p", "gather", "splat")
POLICY_HIDDEN = (64, 64)   # demos/demo_policy.py's MLP
POLICY_OBSERVED = 200      # its config's ENV.n_observed_particles
POLICY_PROFILE_STEPS = 5
DEPLOY_TOL = 1e-5          # the facade's closed loop against the forward
FLOPS_PER_BWD_CELL = {"fused_p2g_bwd": (22 + 14, 32),
                      "fused_g2p_bwd": (20 + 14, 27),
                      "fused_splat_bwd": (5 + 3, 8),
                      "fused_gather_bwd": (5 + 3, 8)}


T0 = time.perf_counter()


def emit(tag, obj):
    """One phase's JSON line, with the seconds since the script started
    (at_s) for a tagged phase."""
    if tag:
        obj = {**obj, "at_s": time.perf_counter() - T0}
    print(f"{tag}: {json.dumps(obj)}" if tag else json.dumps(obj), flush=True)


def tiled_pour_particles(n):
    """The pour init state tiled to n particles with 1e-4 jitter (the
    1e5-particle scenes of bench.py's build_headline_env and
    build_pour_vel_env, _tile_to_1e5)."""
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


def pour_cfg(window=None):
    """The flagship demo_pour config (mixed contact, floating bodies)."""
    from softmac_tpu_torch import load
    cfg = load(str(ROOT / "softmac_tpu_torch/config/demo_pour_config.py"))
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


def device_ms(name, fn, iters=10):
    """Device-only time of one call of ``fn`` in ms: the summed time of the
    device kernels it launched, from torch.profiler over ``iters`` calls
    after a warm-up. Added to DEVICE_MS[name] (a row that covers glass and
    bowl sums its two calls, as its event-timed ``ms`` does), beside the
    kernels a call launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a profile now and then holds no device event, or loses one (9 of a
    # call's 10 launches seen): the iters calls launch alike, so a count
    # that is not a multiple of iters is such a loss; profile again. Late
    # in a long run every profile of a call may come back empty: then the
    # call is timed with CUDA events (its launch gaps included) and listed
    # in EVENT_TIMED
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.events()
                if e.device_type == DeviceType.CUDA]
        if kern and len(kern) % iters == 0:
            break
    ms0, launches = DEVICE_MS.get(name, (0.0, 0.0))
    if not kern:
        ms = cuda_time_ms(fn, iters)
        EVENT_TIMED.add(name)
        print(f"{name}: the profiler saw no device kernel; CUDA events: "
              f"{ms} ms a call", flush=True)
        DEVICE_MS[name] = (ms0 + ms, launches)
        return ms
    ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / iters
    DEVICE_MS[name] = (ms0 + ms, launches + len(kern) / iters)
    return ms


def bound(name, n, bytes_moved, flops=None):
    """The least time for the work: bytes over the memory rate or float
    operations (``flops``, else the per-particle count) over the float32
    rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    if flops is None:
        flops = n * FLOPS_PER_PARTICLE[name]
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def is_round(function):
    """Whether a kernel of a ptxas log rounds a float64 window."""
    return any(r in function for r in ROUND_KERNELS)


def ptxas_by_source(log):
    """{source file: [{"function", "registers", "spill_stores",
    "stack_bytes", "smem_bytes"}]} of every kernel, from the ``nvcc -Xptxas
    -v`` log of ``build.build()`` (static shared memory; the y-slab
    kernels' dynamic slab is in their ``slab`` checks)."""
    import re
    out, src, fn, spill, stack = {}, None, None, 0, 0
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
            out[src] = []
        elif "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = int(re.search(r"(\d+) bytes spill stores", ln).group(1))
            stack = re.search(r"(\d+) bytes stack frame", ln)
            stack = int(stack.group(1)) if stack else 0
        elif "Used" in ln and "registers" in ln and src and fn:
            regs = int(re.search(r"Used (\d+) registers", ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            out[src].append({"function": fn, "registers": regs,
                             "spill_stores": spill, "stack_bytes": stack,
                             "smem_bytes": int(smem.group(1)) if smem else 0})
    return out


def kernel_entry(n, name, src, replaces, abs_err, rel_err, ms, plain_ms,
                 bytes_moved, tolerance=1e-5, flops=None):
    """One kernel's JSON entry (launches filled in by the caller); raises
    when the kernel disagrees with its plain version."""
    b_ms, b_by = bound(name, n, bytes_moved, flops)
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
    from softmac_tpu_torch.ops import transfer
    cfg, x = inp["cfg"], inp["state"].x
    n = x.shape[1]
    corner, sizes = inp["corner"], inp["sizes"]
    wx, wy, wz = sizes
    cells = wx * wy * wz
    entries = []

    def entry(*args):
        entries.append(kernel_entry(n, *args))

    # --- p2g: held against the plain version on the same inputs in
    # float64, so that the yardstick's own float32 rounding does not count --
    args = (x, inp["chan"], corner, sizes, cfg.inv_dx)
    device_ms("p2g", lambda: transfer.p2g(*args))
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

    # --- g2p: each output row against its largest |value|, the plain
    # version in float64 on the same inputs ---------------------------------
    args = (x, *inp["grids"], corner, sizes, cfg.inv_dx)
    device_ms("g2p", lambda: transfer.g2p(*args))
    err, rel = _row_rel(transfer.g2p(*args),
                        transfer.g2p_plain(*map(_f64, args)))
    entry("g2p", "softmac_tpu_torch/ops/csrc/g2p.cu",
          "softmac_tpu/ops/pallas_chunked.py:688 (_g2p_c_pallas, "
          "pallas_call :704, kernel _g2p_c_kernel :245)",
          err, rel, cuda_time_ms(lambda: transfer.g2p(*args)),
          cuda_time_ms(lambda: transfer.g2p_plain(*args)),
          (3 * n + 3 * cells + 12 * n) * 4)
    entries[-1]["rel_err_is"] = "max |kernel - plain| / max |plain| per row"

    # --- collide_particle (the tiled kernel: the impulse and the wrench in
    # one launch), once per body, on the main path's particles and on
    # particles spread over the body's SDF box (many contacts) -------------
    entries.append(check_particle_contact(inp))
    return entries


def check_particle_contact(inp):
    """The tiled penalty contact (impulse and wrench, one launch) per body,
    on the main path's particles and on particles spread over the body's
    SDF box, against collide_particle_wrench_plain in float64: the impulse
    within ROW_TOL of its largest |value| away from the threshold, the
    wrench within ROW_TOL of its force's and its torque's; the masks agree
    away from the threshold; MIXED_REPEATS calls bit-identical, also on two
    streams at once (main path). Call and device time on each set."""
    import torch
    from softmac_tpu_torch.ops import contact, m33
    cfg, st = inp["cfg"], inp["state"]
    x, v, n = st.x, st.v, st.x.shape[1]
    gen = torch.Generator(device=x.device).manual_seed(0)
    worst = {"impulse": (0.0, 0.0), "wrench": 0.0}
    ms = plain_ms = 0.0
    nbytes = flops = 0
    by_set, bands = [], {}
    for b, (prim, bp, bq, bv, bw, fr) in enumerate(inp["contacts"]):
        prim64 = _prim64(prim)
        x_box = box_particles(prim, bp, bq, n, gen)
        for xs, label in ((x, "main path"), (x_box, "SDF box")):
            cargs = (prim, bp, bq, bv, bw, fr, xs, v, cfg.dt, cfg.p_mass)
            cargs64 = (prim64,) + tuple(map(_f64, cargs[1:8])) + cargs[8:]
            outs = [contact.collide_particle(*cargs)
                    for _ in range(MIXED_REPEATS)]
            imp, wr = outs[0]
            if not all(torch.equal(o[0], imp) and torch.equal(o[1], wr)
                       for o in outs[1:]):
                raise AssertionError(f"collide_particle ({label}, body "
                                     f"{b}): repeated calls differ")
            if label == "main path" and not same_on_two_streams(
                    lambda: contact.collide_particle(*cargs), (imp, wr)):
                raise AssertionError(f"collide_particle (body {b}): calls "
                                     "on two streams differ")
            imp_p, wr_p = contact.collide_particle_wrench_plain(*cargs64)
            dist, _ = contact.sample_sdf_normal_world(
                prim64, tuple(_f64(bp)), tuple(_f64(bq)), tuple(_f64(xs)))
            mask_p = dist < contact.CONTACT_THRESHOLD
            keep = (dist - contact.CONTACT_THRESHOLD).abs() >= 1e-6
            if bool((((imp != 0).any(dim=0) != (imp_p != 0).any(dim=0))
                     & keep).any()):
                raise AssertionError(f"collide_particle ({label}): contact "
                                     "masks differ away from the threshold")
            err = ((imp.double() - imp_p).abs() * keep).max().item()
            rel = err / max(imp_p.abs().max().item(), 1e-30)
            worst["impulse"] = max(worst["impulse"], (rel, err))
            wrel = _wrench_rel(wr, wr_p) if bool(wr_p.any()) else \
                wr.abs().max().item()
            worst["wrench"] = max(worst["wrench"], wrel)
            band, worst_tile = band_counts(prim64, (_f64(bp), _f64(bq)), xs,
                                           contact.MIXED_TILE)
            counts = {"contacts": int(mask_p.sum()), "band": band,
                      "worst_tile_band": worst_tile,
                      "tile": contact.MIXED_TILE}
            bands[f"body {b} {label}"] = counts
            print(f"collide_particle body {b} {label}: {json.dumps(counts)}"
                  f", impulse rel err {rel}, wrench rel err {wrel}",
                  flush=True)
            if label == "SDF box" and counts["contacts"] < MIN_BOX_CONTACTS:
                raise AssertionError(f"collide_particle: only "
                                     f"{counts['contacts']} contacts in "
                                     f"body {b}'s SDF box")
            main = label == "main path"
            t = cuda_time_ms(lambda: contact.collide_particle(*cargs))
            dev = device_ms("collide_particle" if main
                            else f"collide_particle {b} {label}",
                            lambda: contact.collide_particle(*cargs))
            by_set.append({"body": b, "particles": label, "ms": t,
                           "device_ms": dev, "band": band})
            if not main:
                continue
            ms += t
            plain_ms += cuda_time_ms(
                lambda: contact.collide_particle_wrench_plain(*cargs))
            qinv = m33.qnorm(m33.qconj(tuple(bq)))
            p_loc = m33.qrot(qinv, m33.vsub(tuple(xs), tuple(bp)))
            rows = torch.unique(contact.cell_index(prim, p_loc)[0]).numel()
            # in: x, the rows, 14 body floats and v of the band only (the
            # impulse is zero out of it); out: imp, the wrench
            nbytes += (6 * n + 3 * band) * 4 + rows * 128 + 14 * 4 + 6 * 4
            flops += n * MIXED_CLASSIFY_FLOPS + band * FLOPS_PER_PARTICLE[
                "collide_particle"]
            print(f"collide_particle body {b}: distinct table rows {rows}",
                  flush=True)
    for key, rel in (("impulse", worst["impulse"][0]),
                     ("wrench", worst["wrench"])):
        if not rel <= ROW_TOL:
            raise AssertionError(f"collide_particle: {key} relative error "
                                 f"{rel} > {ROW_TOL}")
    e = kernel_entry(
        n, "collide_particle", "softmac_tpu_torch/ops/csrc/contact.cu",
        "softmac_tpu/ops/pallas_contact.py:393 (_make_particle_kernel via "
        "_particle_factory :704, pallas_call in _run_kernel :472, call site "
        ":723; the wrench tail _tail_particle :693)",
        worst["impulse"][1], worst["impulse"][0], ms, plain_ms, nbytes,
        ROW_TOL, flops=flops)
    e["rel_err_by_output"] = {"impulse": worst["impulse"][0],
                              "wrench": worst["wrench"]}
    e["rel_err_is"] = ("max |kernel - plain| / max |plain| of the impulse "
                       "(away from the threshold) over both bodies and both "
                       "particle sets, the plain version in float64; the "
                       "wrench's in rel_err_by_output (force and torque each "
                       "against its largest |value|); times and bytes (main "
                       "path's particles) summed over glass + bowl")
    e["plain_is"] = "collide_particle_wrench_plain in float32"
    e["repeats_bit_identical"] = MIXED_REPEATS
    e["two_streams_bit_identical"] = MIXED_REPEATS
    e["band"] = bands
    e["by_particle_set"] = by_set
    e["per_substep"] = len(inp["contacts"])
    return e


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
    device_ms("p2g_bwd", lambda: transfer.p2g_bwd(*args))
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
    device_ms("g2p_bwd", lambda: transfer.g2p_bwd(*args))
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
    """collide_particle_bwd (the tiled kernel, the wrench's reverse folded
    in) against collide_particle_wrench_vjp_plain in float64, per body, on
    the main path's particles and on particles spread over the body's SDF
    box (>= MIN_BOX_CONTACTS contacts there), with seeded normal
    cotangents of the impulse and the wrench (and, on the main path, of
    the impulse alone, as velocity control gives it: no wrench cotangent):
    dx, dv within ROW_TOL, the 14 body floats within BODY_TOL of their
    group's largest |value|; MIXED_REPEATS calls bit-identical."""
    import torch
    from softmac_tpu_torch.ops import contact, m33
    cfg, st = inp["cfg"], inp["state"]
    x, v, n = st.x, st.v, st.x.shape[1]
    gen = torch.Generator(device=x.device).manual_seed(0)
    groups = {"dx": 5, "dv": 6, "body_pos": 0, "body_quat": 1, "body_v": 2,
              "body_w": 3, "friction": 4}
    worst = {k: (0.0, 0.0) for k in groups}
    ms = plain_ms = 0.0
    nbytes = flops = 0
    by_set = []
    for b, (prim, bp, bq, bv, bw, fr) in enumerate(inp["contacts"]):
        prim64 = _prim64(prim)
        x_box = box_particles(prim, bp, bq, n, gen)
        for xs, label in ((x, "main path"), (x_box, "SDF box")):
            cargs = (prim, bp, bq, bv, bw, fr, xs, v, cfg.dt, cfg.p_mass)
            cargs64 = (prim64,) + tuple(map(_f64, cargs[1:8])) + cargs[8:]
            dimp, dwr = normal(3, n), normal(6)
            cases = [(dimp, dwr)] + ([(dimp, None)]
                                     if label == "main path" else [])
            for gi, gw in cases:
                outs = [contact.collide_particle_bwd(*cargs, gi, gw)
                        for _ in range(MIXED_REPEATS)]
                got = outs[0]
                if not all(all(torch.equal(a, c) for a, c in zip(o, got))
                           for o in outs[1:]):
                    raise AssertionError(f"collide_particle_bwd ({label}, "
                                         f"body {b}): repeated calls differ")
                want = contact.collide_particle_wrench_vjp_plain(
                    *cargs64, gi.double(), None if gw is None
                    else gw.double())
                for name, i in groups.items():
                    (err, rel), = _errors((got[i],), (want[i],),
                                          (name,)).values()
                    worst[name] = max(worst[name], (rel, err))
            contacts = int(contact.collide_particle_plain(*cargs)[1].sum())
            band, _ = band_counts(prim64, (_f64(bp), _f64(bq)), xs,
                                  contact.MIXED_BWD_TILE)
            print(f"collide_particle_bwd body {b} {label}: contacts "
                  f"{contacts}, band {band}, worst rel err so far "
                  + json.dumps({k: w[0] for k, w in worst.items()}),
                  flush=True)
            if label == "SDF box" and contacts < MIN_BOX_CONTACTS:
                raise AssertionError(f"collide_particle_bwd: only {contacts} "
                                     f"contacts in body {b}'s SDF box")
            main = label == "main path"
            t = cuda_time_ms(
                lambda: contact.collide_particle_bwd(*cargs, dimp, dwr))
            dev = device_ms(
                "collide_particle_bwd" if main
                else f"collide_particle_bwd {b} {label}",
                lambda: contact.collide_particle_bwd(*cargs, dimp, dwr))
            by_set.append({"body": b, "particles": label, "ms": t,
                           "device_ms": dev, "band": band})
            if not main:
                continue
            ms += t
            plain_ms += cuda_time_ms(
                lambda: contact.collide_particle_wrench_vjp_plain(
                    *cargs, dimp, dwr))
            qinv = m33.qnorm(m33.qconj(tuple(bq)))
            p_loc = m33.qrot(qinv, m33.vsub(tuple(x), tuple(bp)))
            rows = torch.unique(contact.cell_index(prim, p_loc)[0]).numel()
            # in: x, the rows, 14 body floats, the wrench cotangent, and v
            # and the impulse cotangent of the band only (dx = dv = 0 out of
            # it); out: dx, dv, the 14 body cotangents
            nbytes += ((9 * n + 6 * band) * 4 + rows * 128 + 14 * 4 + 6 * 4
                       + 14 * 4)
            flops += n * MIXED_CLASSIFY_FLOPS + band * FLOPS_PER_PARTICLE[
                "collide_particle_bwd"]
    for name, (rel, _) in worst.items():
        tol = ROW_TOL if name in ("dx", "dv") else BODY_TOL
        if not rel <= tol:
            raise AssertionError(f"collide_particle_bwd: {name} relative "
                                 f"error {rel} > {tol}")
    e = kernel_entry(
        n, "collide_particle_bwd", "softmac_tpu_torch/ops/csrc/contact_bwd.cu",
        "softmac_tpu/ops/pallas_contact.py:401 (_make_particle_bwd_kernel, "
        "launched from _particle_factory's _bwd :749, with the vjp of the "
        "wrench tail _tail_particle :693)",
        max(worst["dx"][1], worst["dv"][1]),
        max(worst["dx"][0], worst["dv"][0]), ms, plain_ms, nbytes, ROW_TOL,
        flops=flops)
    e["rel_err_by_output"] = {k: w[0] for k, w in worst.items()}
    e["tolerance_by_output"] = {k: ROW_TOL if k in ("dx", "dv") else BODY_TOL
                                for k in groups}
    e["rel_err_is"] = ("max |kernel - plain| / max |plain| of the dx and dv "
                       "rows over both bodies and both particle sets (and "
                       "the impulse's cotangent alone on the main path); "
                       "the body groups in rel_err_by_output; times and "
                       "bytes (main path's particles, both cotangents) "
                       "summed over glass + bowl")
    e["plain_is"] = "collide_particle_wrench_vjp_plain in float32"
    e["repeats_bit_identical"] = MIXED_REPEATS
    e["by_particle_set"] = by_set
    e["per_substep"] = len(inp["contacts"])
    return e


def pour_kernel_inputs(env, carry):
    """The inputs the flagship pour's first substep from ``carry`` hands
    gather, the mixed contact (glass, then bowl) and splat, built with the
    port's own substep stages and the kernels (y-sorted), so that they are
    the same on every run (the plain P2G's float32 index_add_ sums in
    another order each run on the card)."""
    import torch
    from softmac_tpu_torch.engine import mpm
    from softmac_tpu_torch.ops import contact, m33, transfer
    cfg = env.mpm_cfg
    state, bodies, _ = carry
    q, _ = mpm.sort_perm(cfg, state.x)
    state = mpm.permute_state(state, q)
    params = mpm.permute_params(env.mpm_params, q)
    stress, _ = mpm.stress_and_F(cfg, params, state)
    impulse, _ = mpm.contact_impulse(cfg, params, env.prims, state, bodies)
    sizes, corner, overflow = mpm.window_geometry(cfg, state.x)
    if bool(overflow):
        raise AssertionError("window overflow in the pour kernel-check state")
    chan = mpm._p2g_channels(cfg, tuple(state.v), m33.from_mat_array(state.C),
                             stress, impulse)
    gm, gmom = transfer.p2g(state.x, chan, corner, sizes, cfg.inv_dx)
    wx = sizes[0]
    g_v, _, _ = mpm.grid_normalize(
        cfg, (gm, gmom[:, :wx], gmom[:, wx:2 * wx], gmom[:, 2 * wx:]),
        params.gravity)
    gvm = tuple(g.contiguous() for g in mpm.boundary_condition(
        cfg, mpm.grid_coords(cfg, sizes, corner), g_v))
    v_tmp = transfer.gather(state.x, *gvm, corner, sizes, cfg.inv_dx)
    life = torch.full((), 1.0 / cfg.substeps, dtype=state.x.dtype,
                      device=state.x.device)      # substep k = 0
    contacts, v_in = [], v_tmp
    for i, prim in enumerate(env.prims):
        body = (bodies.pos[i], bodies.quat[i], bodies.v[i], bodies.w[i],
                params.friction[i], params.softness[i], life)
        contacts.append((prim, body, v_in))
        v_in = contact.collide_mixed(
            prim, *body, state.x, v_in, cfg.dt, cfg.p_mass,
            cfg.contact_push_velocity_cap)[0]
    return dict(cfg=cfg, state=state, corner=corner, sizes=sizes, gvm=gvm,
                contacts=contacts, chan=chan,
                vals=(-2.0 * (v_tmp - v_in)).contiguous())


def _prim64(prim):
    return prim.replace(neighborhood=prim.neighborhood.double(),
                        lower=prim.lower.double(), upper=prim.upper.double(),
                        inv_dx=prim.inv_dx.double())


def _row_rel(got, want):
    """max |kernel - plain| and that over the largest |plain| of its row."""
    diff = (got.double() - want).abs()
    scale = want.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    return diff.max().item(), (diff / scale).max().item()


def check_pour_kernels(inp):
    """Gather, splat and the mixed contact (merged and split) against their
    plain versions run in float64 on the same inputs; returns the JSON
    entries (launches filled in by the caller)."""
    import torch
    from softmac_tpu_torch.ops import transfer
    cfg, x = inp["cfg"], inp["state"].x
    n = x.shape[1]
    corner, sizes = inp["corner"], inp["sizes"]
    wx, wy, wz = sizes
    cells = wx * wy * wz
    entries = []

    # --- gather: each velocity component against its largest |value| ------
    args = (x, *inp["gvm"], corner, sizes, cfg.inv_dx)
    device_ms("gather", lambda: transfer.gather(*args))
    err, rel = _row_rel(transfer.gather(*args),
                        transfer.gather_plain(*map(_f64, args)))
    entries.append(kernel_entry(
        n, "gather", "softmac_tpu_torch/ops/csrc/gather.cu",
        "softmac_tpu/ops/pallas_chunked.py:742 (_gather_c_pallas, "
        "pallas_call :758, kernel _gather_c_kernel)", err, rel,
        cuda_time_ms(lambda: transfer.gather(*args)),
        cuda_time_ms(lambda: transfer.gather_plain(*args)),
        (6 * n + 3 * cells) * 4))
    entries[-1]["rel_err_is"] = "max |kernel - plain| / max |plain| per row"

    # --- splat: each component's window against its largest |value| -------
    args = (x, inp["vals"], corner, sizes, cfg.inv_dx)

    def by_component(out):
        return out.reshape(wy * wz, 3, wx).transpose(0, 1).reshape(3, -1)
    device_ms("splat", lambda: transfer.splat(*args))
    err, rel = _row_rel(by_component(transfer.splat(*args)),
                        by_component(transfer.splat_plain(*map(_f64, args))))
    entries.append(kernel_entry(
        n, "splat", "softmac_tpu_torch/ops/csrc/splat.cu",
        "softmac_tpu/ops/pallas_chunked.py:797 (_splat_c_pallas, "
        "pallas_call :812, kernel _splat_c_kernel)", err, rel,
        cuda_time_ms(lambda: transfer.splat(*args)),
        cuda_time_ms(lambda: transfer.splat_plain(*args)),
        (6 * n + 3 * cells) * 4))
    entries[-1]["rel_err_is"] = ("max |kernel - plain| / max |plain| per "
                                 "velocity component's window")
    entries[-1]["nonzero_vals"] = int((inp["vals"] != 0).any(dim=0).sum())
    entries += check_mixed_kernels(inp)
    return entries


# (channels, input rows) of each y-slab kernel (ops/csrc/slab.cuh)
SLAB_SHAPES = {"p2g": (4, 13), "splat": (3, 3), "g2p_bwd": (3, 12),
               "gather_bwd": (3, 3)}
BWD_OUTPUTS = ("dx", "dgv0", "dgv1", "dgv2")


def slab_fns(name):
    """(kernel, the wrapper that holds its .spilled, float64 reference) of
    the y-slab kernel ``name``."""
    from softmac_tpu_torch.ops import transfer
    if name in ("p2g", "splat"):
        return (getattr(transfer, "_" + name), getattr(transfer, name),
                getattr(transfer, name + "_plain"))
    fn = getattr(transfer, name)
    return fn, fn, getattr(transfer, name.replace("_bwd", "_vjp_plain"))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _slab_flat(name, out):
    """A P2G result (gm, gmom) or a splat window as one flat tensor."""
    import torch
    if name == "p2g":
        return torch.cat([out[0].reshape(-1), out[1].reshape(-1)])
    return out.reshape(-1)


def _slab_rel(name, got, want, wx):
    """(max |kernel - plain|, that over the scale the kernel's entry uses:
    the largest |plain| of gm and gmom together for P2G, of each
    component's window for the splat, of each output (dx and each grid
    cotangent) for the backwards)."""
    if name in ("g2p_bwd", "gather_bwd"):
        errs = _errors(got, want, BWD_OUTPUTS)
        return (max(e[0] for e in errs.values()),
                max(e[1] for e in errs.values()))
    got, want = _slab_flat(name, got), _slab_flat(name, want)
    diff = (got.double() - want).abs()
    if name == "p2g":
        return (diff.max().item(),
                diff.max().item() / max(want.abs().max().item(), 1e-30))

    def by_component(t):
        return t.reshape(-1, 3, wx).transpose(0, 1).reshape(3, -1)
    scale = by_component(want).abs().amax(dim=1, keepdim=True)
    return (diff.max().item(),
            (by_component(diff) / scale.clamp(min=1e-30)).max().item())


def _particle_cols(name, args):
    """The positions of ``args`` that hold one column a particle: x and
    the values (P2G, splat: (x, src, corner, window, inv_dx)) or x and the
    cotangent (the backwards: (x, gv0, gv1, gv2, corner, window, inv_dx,
    cot))."""
    return (0, 1) if name in ("p2g", "splat") else (0, 7)


def slab_times(name, args, label):
    """The y-slab kernel ``name`` (a backward) on ``args``: call ms (CUDA
    events) and device ms (torch.profiler)."""
    kernel = slab_fns(name)[0]
    return {"slab_ms": cuda_time_ms(lambda: kernel(*args)),
            "slab_device_ms": device_ms(f"{name} slab {label}",
                                        lambda: kernel(*args))}


def check_slab(name, args, gen, time_it):
    """The y-slab kernel ``name`` (a key of SLAB_SHAPES) on ``args`` (a
    y-sorted state and its window) and on a random permutation of its
    particles: within 1e-5 of the float64 plain version or vjp (as the
    kernel's entry measures it), the spilled-particle count of each order
    (0 sorted), SLAB_REPEATS calls bit-identical, and the plan (tiles, slab
    rows, dynamic shared bytes); for a backward the particles whose
    cotangent is nonzero, and with ``time_it`` its times (slab_times)."""
    import torch
    from softmac_tpu_torch.ops import transfer
    kernel, wrapper, plain = slab_fns(name)
    x, sizes = args[0], args[-2] if name in ("p2g", "splat") else args[5]
    bwd = name.endswith("_bwd")
    want = plain(*map(_f64, args))
    plan = transfer.slab_plan(*SLAB_SHAPES[name], x.shape[1],
                              transfer.SLAB_TILE, tuple(sizes))
    res = {"plan": dict(zip(("tiles", "tile", "rows", "smem_bytes",
                             "tile_doubles"), plan)),
           "window": list(sizes)}
    cols = _particle_cols(name, args)
    if bwd:
        res["active"] = int((args[cols[1]] != 0).any(dim=0).sum())
    perm = torch.randperm(x.shape[1], generator=gen, device=x.device)
    permuted = tuple(a[:, perm].contiguous() if i in cols else a
                     for i, a in enumerate(args))
    # the backwards' dx follows the particles; the windows do not
    want_perm = (want[0][:, perm],) + tuple(want[1:]) if bwd else want
    for order, a, w in (("sorted", args, want),
                        ("permuted", permuted, want_perm)):
        outs = [kernel(*a) for _ in range(SLAB_REPEATS)]
        torch.cuda.synchronize()
        err, rel = _slab_rel(name, outs[0], w, sizes[0])
        res[order] = {"max_abs_err": err, "max_rel_err": rel,
                      "spilled": int(wrapper.spilled),
                      "repeats_bit_identical": all(
                          all(torch.equal(p, q) for p, q in
                              zip(_as_tuple(o), _as_tuple(outs[0])))
                          for o in outs[1:])}
    if time_it:
        res.update(slab_times(name, args, f"seeded {sizes}"))
    if not (res["sorted"]["spilled"] == 0
            and all(res[o]["max_rel_err"] <= ROW_TOL
                    and res[o]["repeats_bit_identical"]
                    for o in ("sorted", "permuted"))):
        raise AssertionError(f"{name} y-slab check: {res}")
    return res


def check_slab_kernels(inp, pour_inp):
    """check_slab of P2G, the splat and the G2P and gather backwards on the
    pour_vel and the pour states (the main paths' y-sorted particles,
    windows and grids; the splat on pour_vel with seeded normal values,
    every particle active; the backwards with seeded normal cotangents,
    timed there) and on the pour's particles over the full 64^3 grid (no
    window: the widest rows; seeded normal grids for the backwards). The permuted orders must spill somewhere for
    each kernel (the spill path ran). Returns {kernel: {state: result}}."""
    import torch
    x_v, x_p = inp["state"].x, pour_inp["state"].x
    gen = torch.Generator(device=x_v.device).manual_seed(11)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=x_v.device)
    vals_v = normal(3, x_v.shape[1])
    ng = pour_inp["cfg"].n_grid
    zero = torch.zeros(3, dtype=torch.int32, device=x_p.device)
    full_grids = tuple(normal(ng * ng, ng) for _ in range(3))
    cases = (("pour_vel", inp, x_v, inp["chan"], vals_v, inp["corner"],
              inp["sizes"], inp["grids"], True),
             ("pour", pour_inp, x_p, pour_inp["chan"], pour_inp["vals"],
              pour_inp["corner"], pour_inp["sizes"], pour_inp["gvm"], True),
             ("full_grid", pour_inp, x_p, pour_inp["chan"], pour_inp["vals"],
              zero, (ng, ng, ng), full_grids, False))
    res = {name: {} for name in SLAB_SHAPES}
    for state, src, x, chan, vals, corner, sizes, grids, time_it in cases:
        inv_dx = src["cfg"].inv_dx
        n = x.shape[1]
        args = {"p2g": (x, chan, corner, sizes, inv_dx),
                "splat": (x, vals, corner, sizes, inv_dx),
                "g2p_bwd": (x, *grids, corner, sizes, inv_dx, normal(12, n)),
                "gather_bwd": (x, *grids, corner, sizes, inv_dx,
                               normal(3, n))}
        for name, a in args.items():
            res[name][state] = check_slab(
                name, a, gen, time_it and name.endswith("_bwd"))
    for name, by_state in res.items():
        spilled = {k: (v["sorted"]["spilled"], v["permuted"]["spilled"])
                   for k, v in by_state.items()}
        print(f"{name} y-slab: spilled (sorted, permuted) {spilled}",
              flush=True)
        if not any(p > 0 for _, p in spilled.values()):
            raise AssertionError(f"{name}: no permuted order spilled")
    return res


# the read-side tile kernels (ops/csrc/slab_read.cuh): the build phase
# fails if ptxas reports a spill for them
READ_KERNELS = ("g2p", "gather", "p2g_bwd", "splat_bwd")
READ_SOURCES = tuple(k + ".cu" for k in READ_KERNELS)


def read_fns(name):
    """(kernel, the wrapper that holds its .off_slab, float64 reference,
    the positions of its arguments that hold one column a particle) of
    the read-side kernel ``name``: G2P and the gather take (x, gv0, gv1,
    gv2, corner, window, inv_dx), the P2G backward (x, chan, corner,
    window, inv_dx, dgm, dgmom), the splat backward (x, vals, corner,
    window, inv_dx, dout). Every output holds one column a particle."""
    from softmac_tpu_torch.ops import transfer
    if name in ("g2p", "gather"):
        return (getattr(transfer, "_" + name), getattr(transfer, name),
                getattr(transfer, name + "_plain"), (0,))
    fn = getattr(transfer, name)
    return fn, fn, getattr(transfer, name.replace("_bwd", "_vjp_plain")), \
        (0, 1)


def off_slab_count(wrapper):
    """The particles of a read-side call that read device memory (the sum
    of its tiles' counts, read after a synchronize)."""
    return int(wrapper.off_slab.sum())


def check_read(name, args, gen):
    """The read-side tile kernel ``name`` (a key of READ_KERNELS) on
    ``args`` (a y-sorted state, its window and grids or cotangents) and on
    a random permutation of its particles: each output row within ROW_TOL
    of its largest |value| in the float64 plain version or vjp, the
    particles that read device memory (off the slab), SLAB_REPEATS calls
    bit-identical, call and device ms of each order."""
    import torch
    from softmac_tpu_torch.ops import transfer
    kernel, wrapper, plain, cols = read_fns(name)
    x = args[0]
    sizes = args[5] if name in ("g2p", "gather") else args[3]
    want = _as_tuple(plain(*map(_f64, args)))
    perm = torch.randperm(x.shape[1], generator=gen, device=x.device)
    permuted = tuple(a[:, perm].contiguous() if i in cols else a
                     for i, a in enumerate(args))
    res = {"window": list(sizes), "tile": transfer.READ_TILE}
    for order, a, w in (("sorted", args, want),
                        ("permuted", permuted,
                         tuple(t[:, perm] for t in want))):
        outs = [_as_tuple(kernel(*a)) for _ in range(SLAB_REPEATS)]
        torch.cuda.synchronize()
        errs = [_row_rel(o, t) for o, t in zip(outs[0], w)]
        res[order] = {"max_abs_err": max(e[0] for e in errs),
                      "max_rel_err": max(e[1] for e in errs),
                      "off_slab": off_slab_count(wrapper),
                      "repeats_bit_identical": all(
                          all(torch.equal(p, q) for p, q in zip(o, outs[0]))
                          for o in outs[1:]),
                      "ms": cuda_time_ms(lambda: kernel(*a)),
                      "device_ms": device_ms(
                          f"{name} read {order} {tuple(sizes)}",
                          lambda: kernel(*a))}
    if not all(res[o]["max_rel_err"] <= ROW_TOL
               and res[o]["repeats_bit_identical"]
               for o in ("sorted", "permuted")):
        raise AssertionError(f"{name} read-side tiles: {res}")
    return res


def spread_particles(inp, gen):
    """As many particles as ``inp``'s state, uniform over its window (a
    cell's margin inside), in the y-sorted order: a tile's box then spans
    the window's whole x-z plane, of which the slab holds a few rows."""
    import torch
    x, corner, sizes = inp["state"].x, inp["corner"], inp["sizes"]
    inv_dx = inp["cfg"].inv_dx
    w = torch.tensor(sizes, dtype=x.dtype, device=x.device)[:, None]
    u = torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype)
    xs = (corner.to(x.dtype)[:, None] + 1.0 + u * (w - 2.0)) / inv_dx
    key = torch.floor(xs[1] * inv_dx - 0.5)
    return xs[:, torch.argsort(key, stable=True)].contiguous()


def check_read_kernels(inp, pour_inp):
    """check_read of G2P, the gather and the P2G and splat backwards on the
    pour_vel and the pour states (the main paths' y-sorted particles,
    windows and grids; the P2G backward with each state's channels, the
    splat backward with the pour's real values, -2 dv, zero outside the
    contact band, and seeded normal values on pour_vel, which runs no
    splat; seeded normal cotangents), on the pour's particles over the
    full 64^3 grid (no window: seeded normal grids and cotangents) and on
    as many particles spread uniformly over the pour's window
    (spread_particles: a tile's box is the window's whole x-z plane, so in
    the permuted order the slab holds a few of the rows a tile spans;
    seeded normal values). No particle of the two main-path states goes off
    the slab in their sorted order; some order of each kernel must (the
    device-memory path ran). Returns {kernel: {state: result}}."""
    import torch
    x_p = pour_inp["state"].x
    gen = torch.Generator(device=x_p.device).manual_seed(12)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=x_p.device)
    ng = pour_inp["cfg"].n_grid
    full = (tuple(normal(ng * ng, ng) for _ in range(3)),
            torch.zeros(3, dtype=torch.int32, device=x_p.device),
            (ng, ng, ng))
    pour_window = (pour_inp["gvm"], pour_inp["corner"], pour_inp["sizes"])
    x_s = spread_particles(pour_inp, gen)
    res = {name: {} for name in READ_KERNELS}
    for state, src, x, (grids, corner, sizes), vals in (
            ("pour_vel", inp, inp["state"].x,
             (inp["grids"], inp["corner"], inp["sizes"]),
             normal(*inp["state"].x.shape)),
            ("pour", pour_inp, x_p, pour_window, pour_inp["vals"]),
            ("full_grid", pour_inp, x_p, full, pour_inp["vals"]),
            ("spread", pour_inp, x_s, pour_window, normal(*x_s.shape))):
        wx, wy, wz = sizes
        inv_dx = src["cfg"].inv_dx
        args = {"g2p": (x, *grids, corner, sizes, inv_dx),
                "p2g_bwd": (x, src["chan"], corner, sizes, inv_dx,
                            normal(wy * wz, wx), normal(wy * wz, 3 * wx)),
                "splat_bwd": (x, vals, corner, sizes, inv_dx,
                              normal(wy * wz, 3 * wx))}
        args["gather"] = args["g2p"]
        for name in READ_KERNELS:
            res[name][state] = check_read(name, args[name], gen)
    for name, by_state in res.items():
        off = {k: (v["sorted"]["off_slab"], v["permuted"]["off_slab"])
               for k, v in by_state.items()}
        print(f"{name} read-side tiles: off the slab (sorted, permuted) "
              f"{off}", flush=True)
        if not any(p > 0 for o in off.values() for p in o):
            raise AssertionError(f"{name}: no order went off the slab")
        if off["pour_vel"][0] or off["pour"][0]:
            raise AssertionError(f"{name}: the main-path states' sorted "
                                 "order went off the slab")
    return res


class OffSlab:
    """Within it, every read-side kernel call's off-slab counts (a copy of
    the tensor each leaves in ``off_slab``, which its next call
    overwrites: G2P and the gather forward, the P2G and splat backwards)
    are kept; ``counts()`` sums them after a synchronize: the main path's
    particles that read device memory. One OffSlab may be entered more
    than once; it keeps every call."""

    def __init__(self):
        self.kept = {name: [] for name in READ_KERNELS}

    def __enter__(self):
        from softmac_tpu_torch.ops import transfer
        self.transfer = transfer
        self.read = transfer._read

        def kept(name, *args):
            off = self.read(name, *args)
            self.kept[name].append(off.clone())
            return off
        transfer._read = kept
        return self

    def __exit__(self, *exc):
        self.transfer._read = self.read

    def counts(self):
        import torch
        torch.cuda.synchronize()
        out = {}
        for name, kept in self.kept.items():
            if not kept:
                continue
            per_call = torch.stack([t.sum() for t in kept]).tolist()
            out[name] = {"calls": len(kept), "off_slab": int(sum(per_call)),
                         "calls_off_slab": sum(c > 0 for c in per_call),
                         "max_a_call": int(max(per_call))}
        return out


def check_real_backward(keep, kernels):
    """g2p_bwd and gather_bwd on the inputs kept from real calls of the
    pour's gradient path (run_pour_grad's KeepCalls): the particles whose
    cotangent is nonzero in every call of the counted run, and in each
    kept call those particles and the SLAB_TILE tiles that hold any; the
    kernel within ROW_TOL of the float64 plain vjp, its spills,
    SLAB_REPEATS calls bit-identical, its times (slab_times) and the bound
    of what these inputs need (the particles at zero read their cotangent
    and write dx only). Added to each kernel's entry under "real"."""
    import torch
    from softmac_tpu_torch.ops import transfer
    by_name = {k["name"]: k for k in kernels}
    for name, k in keep.items():
        kernel, _, plain = slab_fns(name)
        active = [int(a) for a in torch.stack(k.active).tolist()]
        res = {"calls": len(active), "active_by_call": active,
               "calls_with_active": sum(a > 0 for a in active),
               "active_max": max(active),
               "active_mean": statistics.mean(active), "kept": {}}
        for call, args in sorted(k.kept.items()):
            x, cot = args[0], args[-1]
            n = x.shape[1]
            wx, wy, wz = args[5]
            cells = wx * wy * wz
            nz = (cot != 0).any(dim=0)
            tiles = torch.cat([nz, nz.new_zeros(-n % transfer.SLAB_TILE)]) \
                .reshape(-1, transfer.SLAB_TILE).any(dim=1)
            outs = [kernel(*args) for _ in range(SLAB_REPEATS)]
            torch.cuda.synchronize()
            err, rel = _slab_rel(name, outs[0], plain(*map(_f64, args)), wx)
            n_act = int(nz.sum())
            rows = cot.shape[0]
            # every particle's cotangent read and dx written; x and the
            # stencil's work only for the particles whose cotangent is
            # nonzero; the grids read and their cotangents written once
            b_ms, b_by = bound(name, n_act,
                               4 * (rows * n + 3 * n_act + 3 * n + 6 * cells))
            r = {"active": n_act, "tiles_with_active": int(tiles.sum()),
                 "tiles": tiles.numel(), "max_abs_err": err,
                 "max_rel_err": rel, "spilled": int(kernel.spilled),
                 "repeats_bit_identical": all(
                     all(torch.equal(p, q) for p, q in zip(o, outs[0]))
                     for o in outs[1:]),
                 "bound_ms": b_ms, "bound_by": b_by,
                 **slab_times(name, args, f"real {call}")}
            res["kept"][call] = r
            print(f"{name} real call {call}: {json.dumps(r)}", flush=True)
            if not (rel <= ROW_TOL and r["repeats_bit_identical"]):
                raise AssertionError(f"{name} on real inputs: {r}")
        by_name[name]["real"] = res


def band_particles(prim, body, n, gen):
    """n world points over the body's SDF box with dist(x) <= 5e-3 (every
    one in the mixed contact's band), drawn from box_particles."""
    import torch
    from softmac_tpu_torch.ops import contact
    prim64, body64 = _prim64(prim), tuple(map(_f64, body))
    picked, have = [], 0
    for _ in range(64):
        xs = box_particles(prim, body[0], body[1], n, gen)
        dist, _ = contact.sample_sdf_normal_world(
            prim64, tuple(body64[0]), tuple(body64[1]), tuple(_f64(xs)))
        keep = xs[:, dist <= contact.CONTACT_THRESHOLD]
        picked.append(keep)
        have += keep.shape[1]
        if have >= n:
            break
    if have < n:
        raise AssertionError(f"band_particles: {have} of {n} in the band")
    return torch.cat(picked, dim=1)[:, :n].contiguous()


def band_counts(prim64, body64, xs, tile):
    """The particles the tiled kernels classify into the band (the sdf of
    x's cell within the threshold plus the margin, near the SDF box; the
    float64 plain sample stands in for the kernels' own), over all and in
    the fullest tile of ``tile`` particles."""
    import torch
    from softmac_tpu_torch.ops import contact
    dist, _ = contact.sample_sdf_normal_world(
        prim64, tuple(body64[0]), tuple(body64[1]), tuple(_f64(xs)))
    band = dist <= contact.CONTACT_THRESHOLD + 1e-6
    pad = -band.numel() % tile
    per_tile = torch.cat([band, band.new_zeros(pad)]).reshape(-1, tile)
    return int(band.sum()), int(per_tile.sum(dim=1).max())


def tail_grads(x, body_pos, force, mask, gwrench):
    """The eager wrench tail's autograd (ops.contact._mixed_tail): the
    cotangents of the force rows, x and body_pos for the wrench's."""
    import torch
    from softmac_tpu_torch.ops import contact
    with torch.enable_grad():
        f, xl, bp = (t.detach().requires_grad_() for t in (force, x,
                                                            body_pos))
        _, wr = contact._mixed_tail((None, f, mask), xl, bp)
        return torch.autograd.grad(wr, (f, xl, bp), gwrench)


def split_backward(cargs, gout, gwrench):
    """The split path's backward: the eager tail's autograd, then the
    split pair (collide_mixed2_bwd -> collide_mixed1_bwd)."""
    from softmac_tpu_torch.ops import contact
    prim, body, (x, v, dt, p_mass, cap) = cargs[0], cargs[1:8], cargs[8:]
    st1 = contact.collide_mixed1(prim, *body, x, v, dt)
    _, force, mask = contact.collide_mixed2(prim, *body, x, v, st1, dt,
                                            p_mass, cap)
    gforce, gx, gbp = tail_grads(x, body[0], force, mask, gwrench)
    g = contact.collide_mixed_split_bwd(prim, *body, x, v, st1, dt, p_mass,
                                        cap, gout, gforce.contiguous())
    return (g[0] + gbp,) + g[1:7] + (g[7] + gx, g[8])


def _wrench_rel(got, want):
    """max |kernel - plain| of the wrench over the largest |plain| of its
    force and of its torque, the worse of the two."""
    diff = (got.double() - want).abs()
    return max((diff[a:b].max() / want[a:b].abs().max().clamp(min=1e-30))
               .item() for a, b in ((0, 3), (3, 6)))


def same_on_two_streams(fn, want):
    """fn() on two side streams at once, MIXED_REPEATS calls on each in
    turns with no wait between them: whether every result equals ``want``
    bit for bit (the tiled mixed-contact kernels count their finished
    blocks on a counter of the stream's own)."""
    import torch
    cur = torch.cuda.current_stream()
    streams = [torch.cuda.Stream() for _ in range(2)]
    for s in streams:
        s.wait_stream(cur)
    outs = []
    for _ in range(MIXED_REPEATS):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(fn())
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for o in outs for a, b in zip(o, want))


def check_mixed_kernels(inp):
    """The tiled mixed contact (p_v_out and the wrench, one launch) and the
    split pair with the wrench's PyTorch reduction, per body, on the main
    path's particles, on particles spread over the body's SDF box with
    seeded velocities and (the glass) on particles all in the contact
    band; against collide_mixed_wrench_plain in float64: p_v_out within
    ROW_TOL of its largest |value| away from the threshold, the wrench
    within BODY_TOL of its force's and its torque's; MIXED_REPEATS calls
    bit-identical, also on two streams at once (forward and backward, the
    main path's particles); split against tiled within 1e-6. Call and
    device time on each particle set."""
    import torch
    from softmac_tpu_torch.ops import contact, m33
    cfg, x = inp["cfg"], inp["state"].x
    n = x.shape[1]
    dt, p_mass = cfg.dt, cfg.p_mass
    cap = cfg.contact_push_velocity_cap
    gen = torch.Generator(device=x.device).manual_seed(2)
    worst = {k: 0.0 for k in ("tiled_rows", "tiled_wrench", "split_rows",
                              "split_wrench", "split_vs_tiled")}
    abs_err = {"tiled": 0.0, "split": 0.0}
    ms = {"merged": 0.0, "split": 0.0}
    by_set = []
    plain_ms = 0.0
    nbytes = {"merged": 0, "split": 0}
    flops = 0
    bands = {}
    for b, (prim, body, v_in) in enumerate(inp["contacts"]):
        prim64 = _prim64(prim)
        body64 = tuple(map(_f64, body))
        x_box = box_particles(prim, body[0], body[1], n, gen)
        v_box = (1.5 * torch.randn((3, n), generator=gen, dtype=x.dtype,
                                   device=x.device)).contiguous()
        sets = [(x, v_in, "main path"), (x_box, v_box, "SDF box")]
        if b == 0:
            sets.append((band_particles(prim, body, n, gen), v_box,
                         "all in band"))
        for xs, vs, label in sets:
            cargs = (prim, *body, xs, vs, dt, p_mass, cap)
            outs = [contact.collide_mixed(*cargs)
                    for _ in range(MIXED_REPEATS)]
            pv, wr = outs[0]
            if not all(torch.equal(o[0], pv) and torch.equal(o[1], wr)
                       for o in outs[1:]):
                raise AssertionError(f"collide_mixed ({label}, body {b}): "
                                     "repeated calls differ")
            if label == "main path":
                gen_g = torch.Generator(device=x.device).manual_seed(3)
                gout = torch.randn((3, n), generator=gen_g, device=x.device)
                gwr = torch.randn((6,), generator=gen_g, device=x.device)
                grads = contact.collide_mixed_bwd(*cargs, gout, gwr)
                if not (same_on_two_streams(
                        lambda: contact.collide_mixed(*cargs), (pv, wr))
                        and same_on_two_streams(
                            lambda: contact.collide_mixed_bwd(*cargs, gout,
                                                              gwr), grads)):
                    raise AssertionError(f"collide_mixed (body {b}): calls "
                                         "on two streams differ")
            st1 = contact.collide_mixed1(prim, *body, xs, vs, dt)
            spv, swr = contact._mixed_tail(contact.collide_mixed2(
                prim, *body, xs, vs, st1, dt, p_mass, cap), xs, body[0])
            want = contact.collide_mixed_wrench_plain(
                prim64, *body64, _f64(xs), _f64(vs), dt, p_mass, cap)
            st1_p = contact.collide_mixed1_plain(prim64, *body64, _f64(xs),
                                                 _f64(vs), dt)
            dist = st1_p[6]
            keep = (dist - contact.CONTACT_THRESHOLD).abs() >= 1e-6
            for key, got, ref in (("tiled", (pv, wr), want),
                                  ("split", (spv, swr), want),
                                  ("split_vs_tiled", (spv, swr), (pv, wr))):
                scale = ref[0].abs().max().item()
                err = ((got[0].double() - ref[0].double()).abs()
                       * keep).max().item()
                rows = err / max(scale, 1e-30)
                if key in abs_err:
                    abs_err[key] = max(abs_err[key], err)
                wrel = _wrench_rel(got[1], ref[1].double())
                if key == "split_vs_tiled":
                    worst[key] = max(worst[key], rows, wrel)
                else:
                    worst[key + "_rows"] = max(worst[key + "_rows"], rows)
                    worst[key + "_wrench"] = max(worst[key + "_wrench"], wrel)
            mask = dist <= contact.CONTACT_THRESHOLD
            sdf2, _ = contact.sample_sdf_normal_world(
                prim64, tuple(body64[0]), tuple(body64[1]), tuple(st1_p[3:6]))
            band, worst_tile = band_counts(prim64, body64, xs,
                                           contact.MIXED_TILE)
            counts = {"contacts": int(mask.sum()),
                      "approaching": int((mask & (st1_p[0:3] != _f64(vs))
                                          .any(dim=0)).sum()),
                      "soft": int((mask & (dist > 0)).sum()),
                      "penetrating": int((mask & (sdf2 < 0)).sum()),
                      "band": band, "worst_tile_band": worst_tile,
                      "tile": contact.MIXED_TILE}
            bands[f"body {b} {label}"] = counts
            print(f"collide_mixed body {b} {label}: {json.dumps(counts)}, "
                  "worst rel err so far " + json.dumps(worst), flush=True)
            if label == "SDF box" and (
                    counts["contacts"] < MIN_BOX_CONTACTS
                    or min(counts["approaching"], counts["soft"],
                           counts["penetrating"]) == 0):
                raise AssertionError(f"collide_mixed: body {b}'s SDF box "
                                     f"misses a case: {counts}")
            if label == "all in band" and counts["contacts"] != n:
                raise AssertionError(f"collide_mixed: {counts}")
            main = label == "main path"
            t = cuda_time_ms(lambda: contact.collide_mixed(*cargs))
            dev = device_ms("collide_mixed" if main
                            else f"collide_mixed {b} {label}",
                            lambda: contact.collide_mixed(*cargs))
            by_set.append({"body": b, "particles": label, "tiled_ms": t,
                           "tiled_device_ms": dev, "band": band})
            if label != "main path":
                continue
            ms["merged"] += t
            ms["split"] += cuda_time_ms(lambda: contact.collide_mixed2(
                prim, *body, xs, vs,
                contact.collide_mixed1(prim, *body, xs, vs, dt), dt, p_mass,
                cap))
            device_ms("collide_mixed_split", lambda: contact.collide_mixed2(
                prim, *body, xs, vs,
                contact.collide_mixed1(prim, *body, xs, vs, dt), dt, p_mass,
                cap))
            plain_ms += cuda_time_ms(
                lambda: contact.collide_mixed_wrench_plain(*cargs))
            qinv = m33.qnorm(m33.qconj(tuple(body[1])))
            p_loc = m33.qrot(qinv, m33.vsub(tuple(xs), tuple(body[0])))
            rows = torch.unique(contact.cell_index(prim, p_loc)[0]).numel()
            # in: x, v, the rows, 16 body floats; out: p_v_out, the wrench
            nbytes["merged"] += 9 * n * 4 + rows * 128 + 16 * 4 + 6 * 4
            flops += n * MIXED_CLASSIFY_FLOPS + band * FLOPS_PER_PARTICLE[
                "collide_mixed"]
            # the split writes 7 doubles a particle and reads them back, its
            # second stage reads x, v, the rows and the body again and
            # writes the force and mask
            nbytes["split"] += (18 * n * 4 + 2 * rows * 128 + 2 * 16 * 4
                                + 2 * 7 * n * 8 + n)
            print(f"collide_mixed body {b}: distinct table rows {rows}",
                  flush=True)
    for key, tol in (("tiled_rows", ROW_TOL), ("tiled_wrench", BODY_TOL),
                     ("split_rows", ROW_TOL), ("split_wrench", BODY_TOL),
                     ("split_vs_tiled", 1e-6)):
        if not worst[key] <= tol:
            raise AssertionError(f"collide_mixed: {key} relative error "
                                 f"{worst[key]} > {tol}")
    note = ("max |kernel - plain| / max |plain| of p_v_out (away from the "
            "threshold) over both bodies and all particle sets, the plain "
            "version in float64; the wrench's in rel_err_by_output (force "
            "and torque each against its largest |value|); times and bytes "
            "(main path's particles) summed over glass + bowl")
    entries = []
    for name, key, replaces in (
            ("collide_mixed", "tiled",
             "softmac_tpu/ops/pallas_contact.py:269 (_make_mixed12_kernel via "
             "_fused12_factory :612, pallas_call in _run_kernel :472, call "
             "site :635; the wrench tail _tail12 :601)"),
            ("collide_mixed_split", "split",
             "softmac_tpu/ops/pallas_contact.py:339 (_make_mixed1_kernel and "
             "_make_mixed2_kernel :346 via _fused_factory :511, call sites "
             ":530, :534)")):
        merged = key == "tiled"
        e = kernel_entry(n, name,
                         "softmac_tpu_torch/ops/csrc/contact_mixed.cu",
                         replaces, abs_err[key], worst[key + "_rows"],
                         ms["merged" if merged else "split"], plain_ms,
                         nbytes["merged" if merged else "split"], ROW_TOL,
                         flops=flops if merged else None)
        e["rel_err_by_output"] = {"p_v_out": worst[key + "_rows"],
                                  "wrench": worst[key + "_wrench"]}
        e["tolerance_by_output"] = {"p_v_out": ROW_TOL, "wrench": BODY_TOL}
        e["rel_err_is"] = note
        e["per_substep"] = len(inp["contacts"])
        entries.append(e)
    entries[0]["repeats_bit_identical"] = MIXED_REPEATS
    entries[0]["two_streams_bit_identical"] = MIXED_REPEATS
    entries[0]["band"] = bands
    entries[0]["by_particle_set"] = by_set
    entries[0]["plain_is"] = "collide_mixed_wrench_plain in float32"
    entries[-1]["split_vs_merged_rel_err"] = worst["split_vs_tiled"]
    entries[-1]["split_vs_merged_tolerance"] = 1e-6
    entries[-1]["launches_are"] = ("collide_mixed1 launches on the split "
                                   "path (collide_mixed2 the same)")
    return entries


def check_pour_backward_kernels(inp):
    """gather_bwd, splat_bwd and the mixed-contact backward (merged and
    split) against their plain vjps run in float64 on the same inputs
    (float32 values promoted), with seeded normal cotangents: rows and
    grids within ROW_TOL of the largest |value| of each output, the 16
    body floats within BODY_TOL; the split within 1e-6 of the merged."""
    import torch
    from softmac_tpu_torch.ops import transfer
    cfg, x = inp["cfg"], inp["state"].x
    n = x.shape[1]
    corner, sizes = inp["corner"], inp["sizes"]
    wx, wy, wz = sizes
    cells = wx * wy * wz
    gen = torch.Generator(device=x.device).manual_seed(3)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=x.dtype,
                           device=x.device)

    entries = []
    # --- gather_bwd --------------------------------------------------------
    args = (x, *inp["gvm"], corner, sizes, cfg.inv_dx, normal(3, n))
    device_ms("gather_bwd", lambda: transfer.gather_bwd(*args))
    errs = _errors(transfer.gather_bwd(*args),
                   transfer.gather_vjp_plain(*map(_f64, args)),
                   ("dx", "dgv0", "dgv1", "dgv2"))
    entries.append(kernel_entry(
        n, "gather_bwd", "softmac_tpu_torch/ops/csrc/gather_bwd.cu",
        "softmac_tpu/ops/pallas_chunked.py:767 (_gather_c_bwd_pallas, "
        "pallas_call :784, kernel _gather_c_bwd_kernel :512)",
        max(e[0] for e in errs.values()), max(e[1] for e in errs.values()),
        cuda_time_ms(lambda: transfer.gather_bwd(*args)),
        cuda_time_ms(lambda: transfer.gather_vjp_plain(*args)),
        (9 * n + 6 * cells) * 4, ROW_TOL))
    entries[-1]["rel_err_by_output"] = {k: e[1] for k, e in errs.items()}

    # --- splat_bwd: the real values, a band of nonzero ones -----------------
    args = (x, inp["vals"], corner, sizes, cfg.inv_dx,
            normal(wy * wz, 3 * wx))
    band = int((inp["vals"] != 0).any(dim=0).sum())
    device_ms("splat_bwd", lambda: transfer.splat_bwd(*args))
    errs = _errors(transfer.splat_bwd(*args),
                   transfer.splat_vjp_plain(*map(_f64, args)),
                   ("dx", "dvals"))
    entries.append(kernel_entry(
        n, "splat_bwd", "softmac_tpu_torch/ops/csrc/splat_bwd.cu",
        "softmac_tpu/ops/pallas_chunked.py:821 (_splat_c_bwd_pallas, "
        "pallas_call :836, kernel _splat_c_bwd_kernel :564)",
        max(e[0] for e in errs.values()), max(e[1] for e in errs.values()),
        cuda_time_ms(lambda: transfer.splat_bwd(*args)),
        cuda_time_ms(lambda: transfer.splat_vjp_plain(*args)),
        (12 * n + 3 * cells) * 4, ROW_TOL,
        # the band's particles take the reverse sweep, the others the
        # gather's sums alone
        flops=band * FLOPS_PER_PARTICLE["splat_bwd"]
        + (n - band) * FLOPS_PER_PARTICLE["gather"]))
    entries[-1]["rel_err_by_output"] = {k: e[1] for k, e in errs.items()}
    entries[-1]["nonzero_vals"] = band
    return entries + check_mixed_backward(inp, normal)


def _cell_crossers(prim, body, xs, x_new):
    """Particles whose forecast point lies in another table cell than x."""
    from softmac_tpu_torch.ops import contact, m33
    qinv = m33.qnorm(m33.qconj(tuple(body[1])))

    def cell(p):
        return contact.cell_index(prim, m33.qrot(qinv, m33.vsub(
            tuple(p), tuple(body[0]))))[0]
    return cell(xs) != cell(x_new)


def check_mixed_backward(inp, normal):
    """The tiled mixed-contact backward (cotangents of p_v_out and of the
    wrench in, one launch) and the split path's (the eager tail's autograd,
    collide_mixed2_bwd -> collide_mixed1_bwd) against
    collide_mixed_wrench_vjp_plain in float64, per body, on the main
    path's particles, on particles spread over the body's SDF box with
    seeded velocities (contacts, approaching, soft, penetrating and
    face-crossing particles counted there) and (the glass) on particles
    all in the band: dx, dv within ROW_TOL, the 16 body floats within
    BODY_TOL of their group's largest |value|; MIXED_REPEATS calls
    bit-identical; the split within 1e-6 of the tiled. Call and device
    time on each particle set."""
    import torch
    from softmac_tpu_torch.ops import contact, m33
    cfg, x = inp["cfg"], inp["state"].x
    n = x.shape[1]
    dt, p_mass = cfg.dt, cfg.p_mass
    cap = cfg.contact_push_velocity_cap
    gen = torch.Generator(device=x.device).manual_seed(4)
    groups = {"dx": 7, "dv": 8, "body_pos": 0, "body_quat": 1, "body_v": 2,
              "body_w": 3, "friction": 4, "softness": 5, "life": 6}
    worst = {k: (0.0, 0.0) for k in groups}
    split_worst = 0.0
    ms = {"merged": 0.0, "split": 0.0}
    by_set = []
    plain_ms = 0.0
    nbytes = {"merged": 0, "split": 0}
    flops = 0
    blocks = -(-n // 256)
    for b, (prim, body, v_in) in enumerate(inp["contacts"]):
        prim64 = _prim64(prim)
        body64 = tuple(map(_f64, body))
        x_box = box_particles(prim, body[0], body[1], n, gen)
        v_box = (1.5 * torch.randn((3, n), generator=gen, dtype=x.dtype,
                                   device=x.device)).contiguous()
        sets = [(x, v_in, "main path"), (x_box, v_box, "SDF box")]
        if b == 0:
            sets.append((band_particles(prim, body, n, gen), v_box,
                         "all in band"))
        for xs, vs, label in sets:
            gout, gwrench = normal(3, n), normal(6)
            cargs = (prim, *body, xs, vs, dt, p_mass, cap)
            outs = [contact.collide_mixed_bwd(*cargs, gout, gwrench)
                    for _ in range(MIXED_REPEATS)]
            merged = outs[0]
            if not all(all(torch.equal(a, c) for a, c in zip(o, merged))
                       for o in outs[1:]):
                raise AssertionError(f"collide_mixed_bwd ({label}, body "
                                     f"{b}): repeated calls differ")
            split = split_backward(cargs, gout, gwrench)
            want = contact.collide_mixed_wrench_vjp_plain(
                prim64, *body64, _f64(xs), _f64(vs), dt, p_mass, cap,
                gout.double(), gwrench.double())
            for name, i in groups.items():
                (err, rel), = _errors((merged[i],), (want[i],),
                                      (name,)).values()
                worst[name] = max(worst[name], (rel, err))
                (_, rel_s), = _errors((split[i],), (merged[i].double(),),
                                      (name,)).values()
                split_worst = max(split_worst, rel_s)
            st1_p = contact.collide_mixed1_plain(prim64, *body64, _f64(xs),
                                                 _f64(vs), dt)
            mask = st1_p[6] <= contact.CONTACT_THRESHOLD
            sdf2, _ = contact.sample_sdf_normal_world(
                prim64, tuple(body64[0]), tuple(body64[1]), tuple(st1_p[3:6]))
            band, worst_tile = band_counts(prim64, body64, xs,
                                           contact.MIXED_BWD_TILE)
            counts = {"contacts": int(mask.sum()),
                      "approaching": int((mask & (st1_p[0:3] != _f64(vs))
                                          .any(dim=0)).sum()),
                      "soft": int((mask & (st1_p[6] > 0)).sum()),
                      "penetrating": int((mask & (sdf2 < 0)).sum()),
                      "face_crossing": int((mask & _cell_crossers(
                          prim64, body64, _f64(xs), st1_p[3:6])).sum()),
                      "band": band, "worst_tile_band": worst_tile,
                      "tile": contact.MIXED_BWD_TILE}
            print(f"collide_mixed_bwd body {b} {label}: {json.dumps(counts)}"
                  ", worst rel err so far " + json.dumps(
                      {k: w[0] for k, w in worst.items()})
                  + f", split vs tiled {split_worst}", flush=True)
            if label == "SDF box" and (
                    counts["contacts"] < MIN_BOX_CONTACTS
                    or min(counts[k] for k in ("approaching", "soft",
                                               "penetrating",
                                               "face_crossing")) == 0):
                raise AssertionError(f"collide_mixed_bwd: body {b}'s SDF box "
                                     f"misses a case: {counts}")
            main = label == "main path"
            t = cuda_time_ms(lambda: contact.collide_mixed_bwd(
                *cargs, gout, gwrench))
            dev = device_ms("collide_mixed_bwd" if main
                            else f"collide_mixed_bwd {b} {label}",
                            lambda: contact.collide_mixed_bwd(
                                *cargs, gout, gwrench))
            by_set.append({"body": b, "particles": label, "tiled_ms": t,
                           "tiled_device_ms": dev, "band": band})
            if label != "main path":
                continue
            ms["merged"] += t
            st1 = contact.collide_mixed1(prim, *body, xs, vs, dt)
            _, force, fmask = contact.collide_mixed2(prim, *body, xs, vs, st1,
                                                     dt, p_mass, cap)
            gforce = tail_grads(xs, body[0], force, fmask, gwrench)[0] \
                .contiguous()
            ms["split"] += cuda_time_ms(
                lambda: contact.collide_mixed_split_bwd(
                    prim, *body, xs, vs, st1, dt, p_mass, cap, gout, gforce))
            device_ms("collide_mixed_split_bwd",
                      lambda: contact.collide_mixed_split_bwd(
                          prim, *body, xs, vs, st1, dt, p_mass, cap, gout,
                          gforce))
            plain_ms += cuda_time_ms(
                lambda: contact.collide_mixed_wrench_vjp_plain(
                    *cargs, gout, gwrench))
            qinv = m33.qnorm(m33.qconj(tuple(body[1])))
            p_loc = m33.qrot(qinv, m33.vsub(tuple(xs), tuple(body[0])))
            rows = torch.unique(contact.cell_index(prim, p_loc)[0]).numel()
            # in: x, v, gout, the rows, the 16 body floats and the wrench's
            # cotangent; out: dx, dv and the 16 body cotangents
            nbytes["merged"] += (15 * n * 4 + rows * 128 + 16 * 4 + 6 * 4
                                 + 16 * 4)
            flops += n * MIXED_CLASSIFY_FLOPS + band * FLOPS_PER_PARTICLE[
                "collide_mixed_bwd"]
            # the split also reads stage 1's block and the force's
            # cotangent, writes its cotangent and reads it back (7 doubles
            # a particle each), hands dv over in float, and its second
            # launch reads x, v, the rows and the body again
            nbytes["split"] += (24 * n * 4 + 3 * 7 * n * 8 + 2 * rows * 128
                                + 2 * 16 * 4 + 2 * 16 * blocks * 8)
    for name, (rel, _) in worst.items():
        tol = ROW_TOL if name in ("dx", "dv") else BODY_TOL
        if not rel <= tol:
            raise AssertionError(f"collide_mixed_bwd: {name} relative error "
                                 f"{rel} > {tol}")
    if not split_worst <= 1e-6:
        raise AssertionError("collide_mixed split backward: differs from the "
                             f"tiled by {split_worst} > 1e-6")
    note = ("max |kernel - plain| / max |plain| of the dx and dv rows over "
            "both bodies and all particle sets, the plain vjp in float64; "
            "the body groups in rel_err_by_output; times and bytes (main "
            "path's particles) summed over glass + bowl")
    entries = []
    for name, key, replaces in (
            ("collide_mixed_bwd", "merged",
             "softmac_tpu/ops/pallas_contact.py:277 (_make_mixed12_bwd_kernel "
             "via _fused12_factory's _bwd, launched :672, with jax.vjp of "
             "_tail12 :667)"),
            ("collide_mixed_split_bwd", "split",
             "softmac_tpu/ops/pallas_contact.py:359 (_make_mixed1_bwd_kernel "
             "and _make_mixed2_bwd_kernel :375 via _fused_factory's _bwd "
             ":576-583)")):
        e = kernel_entry(n, name,
                         "softmac_tpu_torch/ops/csrc/contact_mixed_bwd.cu",
                         replaces, max(worst["dx"][1], worst["dv"][1]),
                         max(worst["dx"][0], worst["dv"][0]), ms[key],
                         plain_ms, nbytes[key], ROW_TOL,
                         flops=flops if key == "merged" else None)
        e["rel_err_by_output"] = {k: w[0] for k, w in worst.items()}
        e["tolerance_by_output"] = {k: ROW_TOL if k in ("dx", "dv")
                                    else BODY_TOL for k in groups}
        e["rel_err_is"] = note
        e["per_substep"] = len(inp["contacts"])
        entries.append(e)
    entries[0]["repeats_bit_identical"] = MIXED_REPEATS
    entries[0]["by_particle_set"] = by_set
    entries[0]["plain_is"] = "collide_mixed_wrench_vjp_plain in float32"
    entries[-1]["split_vs_merged_rel_err"] = split_worst
    entries[-1]["split_vs_merged_tolerance"] = 1e-6
    entries[-1]["split_is"] = ("the split pair; the eager tail's autograd "
                               "outside the timed call")
    entries[-1]["launches_are"] = ("collide_mixed1_bwd launches on the split "
                                   "gradient path (collide_mixed2_bwd the "
                                   "same)")
    return entries


def timed_rollout(env, acts):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = env.rollout(acts)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def wrappers():
    from softmac_tpu_torch.ops import contact, fused, kr, transfer
    return {"p2g": transfer.p2g, "g2p": transfer.g2p,
            "collide_particle": contact.collide_particle,
            "p2g_bwd": transfer.p2g_bwd, "g2p_bwd": transfer.g2p_bwd,
            "collide_particle_bwd": contact.collide_particle_bwd,
            "gather": transfer.gather, "splat": transfer.splat,
            "collide_mixed": contact.collide_mixed,
            "collide_mixed1": contact.collide_mixed1,
            "collide_mixed2": contact.collide_mixed2,
            "gather_bwd": transfer.gather_bwd,
            "splat_bwd": transfer.splat_bwd,
            "collide_mixed_bwd": contact.collide_mixed_bwd,
            "collide_mixed1_bwd": contact.collide_mixed1_bwd,
            "collide_mixed2_bwd": contact.collide_mixed2_bwd,
            "fused_p2g": fused.p2g, "fused_g2p": fused.g2p,
            "fused_splat": fused.splat, "fused_gather": fused.gather,
            "fused_p2g_bwd": fused.p2g_bwd, "fused_g2p_bwd": fused.g2p_bwd,
            "fused_splat_bwd": fused.splat_bwd,
            "fused_gather_bwd": fused.gather_bwd, "kr3": kr.kr3}


def reset_launches():
    for w in wrappers().values():
        w.launches = 0


def read_launches():
    return {k: w.launches for k, w in wrappers().items()}


def run_slice(env):
    """The main path: one rollout with the launches counted from zero, then
    SLICE_REPEATS timed rollouts of the same actions."""
    import torch
    acts = actions(VEL_STEPS)
    reset_launches()
    with OffSlab() as off:
        out, secs = timed_rollout(env, acts)
    launches = read_launches()
    off_slab = off.counts()
    print(f"slice: G2P particles off the slab {off_slab}", flush=True)
    loss = out["loss"].item()
    terms = {k: float(v) for k, v in out["terms"].items()}
    state = out["carry"][0]
    n_sub = VEL_STEPS * env.substeps
    rates, repeat_diff = [], 0.0
    for _ in range(SLICE_REPEATS):
        rep, rep_secs = timed_rollout(env, acts)
        rates.append(n_sub / rep_secs)
        repeat_diff = max(repeat_diff,
                          (rep["carry"][0].x - state.x).abs().max().item())
    res = {"n_particles": env.n_particles, "window": list(WINDOW),
           "env_steps": VEL_STEPS, "substeps": n_sub,
           "substeps_per_s": statistics.median(rates),
           "substeps_per_s_min": min(rates), "substeps_per_s_max": max(rates),
           "substeps_per_s_runs": rates,
           "counted_run_substeps_per_s": n_sub / secs,
           "loss": loss, "terms": terms,
           "launches": launches, "off_slab": off_slab,
           "x_finite": bool(torch.isfinite(state.x).all()),
           "x_shape": list(state.x.shape)}
    expect = dict.fromkeys(wrappers(), 0)
    expect.update({"p2g": n_sub, "g2p": n_sub,
                   "collide_particle": n_sub * env.n_primitives})
    if launches != expect:
        raise AssertionError(f"launch counts {launches}, expected {expect}")
    if out["loss"].requires_grad or state.x.requires_grad:
        raise AssertionError("rollout kept an autograd graph")
    if terms["window_overflow"] or not math.isfinite(loss) \
            or not res["x_finite"] or res["x_shape"] != [3, env.n_particles]:
        raise AssertionError(f"slice output wrong: {res}")
    return res, launches


def timed_grad(env, acts, remat, loss_start_frame=0, grad_clip=None,
               loss_stride=20, carry0=None):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = env.rollout_and_grad(acts, loss_start_frame=loss_start_frame,
                               loss_stride=loss_stride, grad_clip=grad_clip,
                               remat=remat, carry0=carry0)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_gradient(tag, env, acts, expect, glass, window, repeats=GRAD_REPEATS,
                 loss_start_frame=0, grad_clip=None, loss_stride=20,
                 remats=("step", "none"), counted=None, carry0=None):
    """A gradient main path: rollout_and_grad of ``acts`` (from ``carry0``,
    by default the scene's initial state) under each remat of ``remats``,
    each one counted call (launches from zero, peak memory; within
    ``counted``, a context such as an OffSlab, where given) and ``repeats``
    timed ones, and "step" against "none" where both run.
    ``expect(remat)`` gives the launch counts, ``glass`` the action columns
    whose gradient may not be all zero."""
    kw = dict(loss_start_frame=loss_start_frame, grad_clip=grad_clip,
              loss_stride=loss_stride, carry0=carry0)
    import torch
    n_sub = len(acts) * env.substeps
    res, launches, grads = {}, {}, {}
    for remat in remats:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with counted if counted is not None else contextlib.nullcontext():
            out, secs = timed_grad(env, acts, remat, **kw)
        launches[remat] = read_launches()
        peak = torch.cuda.max_memory_allocated()
        g = out["action_grad"]
        loss = out["loss"].item()
        if launches[remat] != expect(remat):
            raise AssertionError(f"{tag} ({remat}): launch counts "
                                 f"{launches[remat]}, expected "
                                 f"{expect(remat)}")
        if not math.isfinite(loss) or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{tag} ({remat}): non-finite loss {loss} "
                                 "or action gradient")
        if bool(out["terms"]["window_overflow"]):
            raise AssertionError(f"{tag} ({remat}): window overflow")
        if not bool((g[:, glass] != 0).any()):
            raise AssertionError(f"{tag} ({remat}): the action columns "
                                 f"{glass} of action_grad are all zero")
        gmax = g.abs().max().item()
        rates, rep_diff = [], 0.0
        for _ in range(repeats):
            rep, rep_secs = timed_grad(env, acts, remat, **kw)
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
            "glass_grad_max_abs": g[:, glass].abs().max().item(),
            "repeat_grad_max_abs_diff": rep_diff,
            "repeat_grad_rel_diff": rep_diff / gmax,
            "launches": launches[remat]}
        if not rep_diff <= GRAD_TOL * gmax:
            raise AssertionError(f"{tag} ({remat}): repeats differ by "
                                 f"{rep_diff} > {GRAD_TOL} x {gmax}")
    out = {"n_particles": env.n_particles,
           "window": list(window) if window else None,
           "env_steps": len(acts), "substeps": n_sub,
           "loss_start_frame": loss_start_frame, "loss_stride": loss_stride,
           "grad_clip": grad_clip, "tolerance": GRAD_TOL, **res}
    if "none" in grads and "step" in grads:
        diff = (grads["step"] - grads["none"]).abs().max().item()
        gmax = grads["none"].abs().max().item()
        out["step_vs_none_grad_max_abs_diff"] = diff
        out["step_vs_none_grad_rel_diff"] = diff / gmax
        if not diff <= GRAD_TOL * gmax:
            raise AssertionError(f"{tag}: step and none differ by {diff} > "
                                 f"{GRAD_TOL} x {gmax}")
    return out, launches


def vel_grad_expect(env, steps, remat):
    """pour_vel's launches in a gradient of ``steps`` env steps, one env
    step checkpointed at a time under remat "step". The first env step's
    state does not depend on the actions (the first action sets the
    bodies' velocities at its end), so autograd records nothing there: no
    replay under remat "step", no backward launches. The closed-loop
    policy's gradient launches the same (rehearsed on the CPU)."""
    n_sub = steps * env.substeps
    graded = (steps - 1) * env.substeps
    replays = graded if remat == "step" else 0   # checkpoint replays
    counts = dict.fromkeys(wrappers(), 0)
    for k, c in {"p2g": 1, "g2p": 1,
                 "collide_particle": env.n_primitives}.items():
        counts[k] = c * (n_sub + replays)
        counts[k + "_bwd"] = c * graded
    return counts


def run_grad(env):
    """pour_vel's gradient path on the slice phase's actions."""
    # the glass's wz, vx, vy
    off = OffSlab()
    out, launches = run_gradient(
        "grad", env, actions(VEL_STEPS),
        lambda remat: vel_grad_expect(env, VEL_STEPS, remat), [2, 3, 4],
        WINDOW, counted=off)
    out["off_slab"] = off.counts()
    print(f"grad: read-side particles off the slab (counted calls) "
          f"{out['off_slab']}", flush=True)
    return out, launches


def run_pour(env):
    """The flagship main path: one rollout of zero actions with the launches
    counted from zero, then SLICE_REPEATS timed rollouts of the same."""
    import numpy as np
    import torch
    from softmac_tpu_torch.ops import transfer
    acts = np.zeros((SLICE_STEPS, env.action_dim))
    q0 = env._initial_carry()[2].q
    reset_launches()
    with OffSlab() as off:
        out, secs = timed_rollout(env, acts)
    launches = read_launches()
    off_slab = off.counts()
    print(f"pour: G2P and gather particles off the slab {off_slab}",
          flush=True)
    n_sub = SLICE_STEPS * env.substeps
    expect = mixed_path_expect(env, n_sub)
    if launches != expect:
        raise AssertionError(f"pour launch counts {launches}, expected "
                             f"{expect}")
    state, _, rigid = out["carry"]
    loss = out["loss"].item()
    glass_moved = (rigid.q[0:6] - q0[0:6]).abs().max().item()
    rates, repeat_diff = [], 0.0
    for _ in range(SLICE_REPEATS):
        rep, rep_secs = timed_rollout(env, acts)
        rates.append(n_sub / rep_secs)
        repeat_diff = max(repeat_diff,
                          (rep["carry"][0].x - state.x).abs().max().item(),
                          (rep["carry"][2].q - rigid.q).abs().max().item())
    res = {"scene": "demo_pour", "n_particles": env.n_particles,
           "window": list(POUR_WINDOW), "env_steps": SLICE_STEPS,
           "substeps": n_sub, "actions": "zero",
           "substeps_per_s": statistics.median(rates),
           "substeps_per_s_min": min(rates), "substeps_per_s_max": max(rates),
           "substeps_per_s_runs": rates,
           "counted_run_substeps_per_s": n_sub / secs,
           "repeat_max_abs_diff": repeat_diff,
           "loss": loss,
           "terms": {k: float(v) for k, v in out["terms"].items()},
           "rigid_q": rigid.q.tolist(), "rigid_qd": rigid.qd.tolist(),
           "glass_q_moved": glass_moved, "launches": launches,
           "off_slab": off_slab,
           "x_finite": bool(torch.isfinite(state.x).all()),
           "x_shape": list(state.x.shape),
           # particles off their tile's y-slab in the last substep (the
           # sort is up to 20 env steps old there)
           "spilled_last_substep": {
               "p2g": int(transfer.p2g.spilled),
               "splat": int(transfer.splat.spilled)}}
    if out["loss"].requires_grad or state.x.requires_grad:
        raise AssertionError("pour rollout kept an autograd graph")
    if (res["terms"]["window_overflow"] or not math.isfinite(loss)
            or not res["x_finite"] or res["x_shape"] != [3, env.n_particles]
            or not glass_moved > 0):
        raise AssertionError(f"pour output wrong: {res}")
    return res, launches


def run_pour_split(env):
    """The flagship scene under SOFTMAC_TPU_CONTACT_SPLIT: SPLIT_STEPS env
    steps with the launches counted from zero (the split pair, no merged
    kernel), against the merged kernel's rollout of the same steps."""
    import os
    import numpy as np
    acts = np.zeros((SPLIT_STEPS, env.action_dim))
    merged = env.rollout(acts)["carry"]
    os.environ["SOFTMAC_TPU_CONTACT_SPLIT"] = "1"
    try:
        reset_launches()
        split = env.rollout(acts)["carry"]
        launches = read_launches()
    finally:
        del os.environ["SOFTMAC_TPU_CONTACT_SPLIT"]
    n_sub = SPLIT_STEPS * env.substeps
    expect = dict.fromkeys(wrappers(), 0)
    expect.update({"p2g": n_sub, "g2p": n_sub, "gather": n_sub,
                   "splat": n_sub,
                   "collide_mixed1": n_sub * env.n_primitives,
                   "collide_mixed2": n_sub * env.n_primitives})
    if launches != expect:
        raise AssertionError(f"split launch counts {launches}, expected "
                             f"{expect}")
    res = {"env_steps": SPLIT_STEPS, "launches": launches,
           "x_max_abs_diff_vs_merged":
               (split[0].x - merged[0].x).abs().max().item(),
           "q_max_abs_diff_vs_merged":
               (split[2].q - merged[2].q).abs().max().item(),
           "tolerance": 1e-6}
    if not (res["x_max_abs_diff_vs_merged"] <= 1e-6
            and res["q_max_abs_diff_vs_merged"] <= 1e-6):
        raise AssertionError(f"split and merged rollouts differ: {res}")
    return res, launches


def pour_grad_expect(env, steps, remat, split=False):
    """Launches of every kernel in rollout_and_grad of the pour scene over
    ``steps`` env steps of one substep each. The first env step records
    nothing for autograd (the bodies take their first action at its end):
    its kernels run once, with no backward. In the second only the bodies
    carry a gradient: gather and P2G still see no input that requires one,
    so their Functions (and backwards) start with the third step. Under
    remat "step" every env step is replayed once in the backward: the
    first too, because its rigid step, which saves tensors for the
    backward, takes the first action."""
    b = env.n_primitives
    replays = steps if remat == "step" else 0
    expect = dict.fromkeys(wrappers(), 0)
    for k in ("p2g", "g2p", "gather", "splat"):
        expect[k] = steps + replays
    contact = ("collide_mixed1", "collide_mixed2") if split \
        else ("collide_mixed",)
    for k in contact:
        expect[k] = b * (steps + replays)
    expect.update({"p2g_bwd": steps - 2, "gather_bwd": steps - 2,
                   "g2p_bwd": steps - 1, "splat_bwd": steps - 1})
    for k in (("collide_mixed1_bwd", "collide_mixed2_bwd") if split
              else ("collide_mixed_bwd",)):
        expect[k] = b * (steps - 1)
    return expect


class KeepCall:
    """Stands in for a backward wrapper of ops/transfer.py: passes every
    call on, keeps a copy of the inputs of the calls numbered in ``keep``
    (from 1), and counts, on the card, the particles whose cotangent (the
    last argument) is nonzero in each of the first ``first`` calls. Its
    ``launches`` is the wrapped function's, so the launch counts read
    through it stay exact."""

    def __init__(self, fn, keep, first):
        self.fn, self.keep, self.first = fn, keep, first
        self.calls, self.kept, self.active = 0, {}, []

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __call__(self, *args):
        import torch
        self.calls += 1
        if self.calls in self.keep:
            self.kept[self.calls] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)
        if self.calls <= self.first:
            self.active.append((args[-1] != 0).any(dim=0).sum())
        return self.fn(*args)


def run_pour_grad(env):
    """The flagship's gradient main path: rollout_and_grad of SLICE_STEPS
    env steps of zero actions (loss_start_frame 0, loss_stride 20). The
    inputs of the CAPTURE_CALLS of gather_bwd and of g2p_bwd in
    the first counted call (remat "step") are kept, with the count of
    nonzero cotangent columns of each of its calls: the KeepCall of each
    kernel is returned, by name. The read-side kernels' off-slab counts
    are summed over the counted calls (OffSlab)."""
    import numpy as np
    from softmac_tpu_torch.ops import transfer
    first = pour_grad_expect(env, SLICE_STEPS, "step")
    keep = {name: KeepCall(getattr(transfer, name), CAPTURE_CALLS,
                           first[name]) for name in REAL_BWD}
    for name, k in keep.items():
        setattr(transfer, name, k)
    off = OffSlab()
    try:
        out, launches = run_gradient(
            "pour_grad", env, np.zeros((SLICE_STEPS, env.action_dim)),
            lambda remat: pour_grad_expect(env, SLICE_STEPS, remat),
            list(range(6)), POUR_WINDOW,      # the glass's torque and force
            counted=off)
    finally:
        for name, k in keep.items():
            setattr(transfer, name, k.fn)
    out["off_slab"] = off.counts()
    print(f"pour_grad: read-side particles off the slab (counted calls) "
          f"{out['off_slab']}", flush=True)
    return {"scene": "demo_pour", "actions": "zero", **out}, launches, keep


def run_pour_split_grad(env):
    """rollout_and_grad of SPLIT_STEPS env steps of the pour scene under
    SOFTMAC_TPU_CONTACT_SPLIT (remat "none"), launches counted from zero
    (the split backward pair, no merged backward), against the merged
    kernels' gradient of the same steps."""
    import os
    import numpy as np
    acts = np.zeros((SPLIT_STEPS, env.action_dim))
    merged, _ = timed_grad(env, acts, "none")
    os.environ["SOFTMAC_TPU_CONTACT_SPLIT"] = "1"
    try:
        reset_launches()
        split, secs = timed_grad(env, acts, "none")
        launches = read_launches()
    finally:
        del os.environ["SOFTMAC_TPU_CONTACT_SPLIT"]
    expect = pour_grad_expect(env, SPLIT_STEPS, "none", split=True)
    if launches != expect:
        raise AssertionError(f"pour_split_grad: launch counts {launches}, "
                             f"expected {expect}")
    gm, gs = merged["action_grad"], split["action_grad"]
    gmax = gm.abs().max().item()
    res = {"env_steps": SPLIT_STEPS, "remat": "none", "launches": launches,
           "seconds": secs, "loss_merged": merged["loss"].item(),
           "loss_split": split["loss"].item(),
           "grad_max_abs_diff_vs_merged": (gs - gm).abs().max().item(),
           "grad_max_abs": gmax, "tolerance": GRAD_TOL}
    if not (gmax > 0 and res["grad_max_abs_diff_vs_merged"]
            <= GRAD_TOL * gmax):
        raise AssertionError(f"split and merged gradients differ: {res}")
    return res, launches


def run_profile(env, acts, grad=False, loss_stride=None, carry0=None):
    """Device busy share and the top kernels over a short rollout of
    ``acts`` (or rollout_and_grad with remat "none", loss frames every
    ``loss_stride`` substeps from 0, by default every len(acts)), from
    ``carry0`` (by default the scene's initial state)."""
    steps = len(acts)

    def call():
        if grad:
            env.rollout_and_grad(acts, loss_start_frame=0,
                                 loss_stride=loss_stride or steps,
                                 remat="none", carry0=carry0)
        else:
            env.rollout(acts, carry0=carry0)
    return {"env_steps": steps, "grad": grad,
            **profile_call(call, steps * env.substeps)}


def profile_call(fn, n_sub):
    """torch.profiler over one call of ``fn``, which runs ``n_sub``
    substeps: device busy share of the wall time, kernel launches and
    device ms a substep, the kernels that take the most device time, and
    each of the port's own kernels' device time a launch and launches a
    substep."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    # the y-slab kernels: scatter and reduce launches (their names carry
    # the template argument)
    scatter = {k: sum(t for name, (t, _) in by_name.items() if tag in name)
               / 1e3 / n_sub
               for k, tag in (("p2g", "P2GValues"), ("splat", "SplatValues"),
                              ("g2p_bwd", "G2PBwdValues"),
                              ("gather_bwd", "GatherBwdValues"))}
    import re
    # the port's own kernels: device ms a launch and launches a substep
    ours = {k[:90]: {"device_ms_per_launch": t / 1e3 / c,
                     "launches_per_substep": c / n_sub}
            for k, (t, c) in by_name.items()
            if re.search(PORT_KERNEL, k)}
    return {"port_kernels": ours,
            "slab_kernels_ms_per_substep": scatter,
            "wall_ms_per_substep": wall * 1e3 / n_sub,
            "device_busy_ms_per_substep": busy_us / 1e3 / n_sub,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernel_launches_per_substep": len(kern) / n_sub,
            "top_kernels": [{"name": k[:90], "ms_per_substep": t / 1e3 / n_sub,
                             "calls_per_substep": c / n_sub}
                            for k, (t, c) in top]}


def penalty_launches(prof, env, steps):
    """The penalty contact's device kernels a substep in a pour_vel
    profile (run_profile over ``steps`` env steps, remat "none" for a
    gradient), by name, held to exactly one launch a body a substep
    forward and, for a gradient, one backward a body a substep of every
    env step but the first (which autograd does not record)."""
    got = {k: sum(v["launches_per_substep"]
                  for name, v in prof["port_kernels"].items()
                  if k + "(" in name) for k in PENALTY_KERNELS}
    want = {PENALTY_KERNELS[0]: env.n_primitives,
            PENALTY_KERNELS[1]: (env.n_primitives * (steps - 1) / steps
                                 if prof["grad"] else 0)}
    if any(abs(got[k] - want[k]) > 1e-9 for k in PENALTY_KERNELS):
        raise AssertionError(f"penalty contact launches a substep {got}, "
                             f"expected {want}")
    return got


def kernel_origin(env, acts, pattern):
    """Where the device kernels whose name holds ``pattern`` come from:
    rollout_and_grad over ``acts`` (remat "none") under torch.profiler
    with Python stacks and input shapes; for each op that launched one
    (and its input shapes), the autograd node it ran under (autograd's
    evaluate_function; none for a forward op), the forward op of that
    node's sequence number with its input shapes and the port's frames
    above it (from the op's recorded stack and the Python calls around
    it), with the launches a substep and device ms a launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = len(acts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, record_shapes=True) as prof:
        env.rollout_and_grad(acts, loss_start_frame=0, loss_stride=steps,
                             remat="none")
        torch.cuda.synchronize()
    cpu = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CPU),
                 key=lambda e: e.time_range.start)
    # a node's forward op: the last outermost op of its thread that took
    # its sequence number (the ops before it that record no node take the
    # same number)
    fwd = {}
    for e in cpu:
        key = (e.thread, e.sequence_nr)
        par = e.cpu_parent
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::") and (
                par is None or (par.thread, par.sequence_nr) != key):
            fwd[key] = e

    def up(e, stop):
        while e is not None and not stop(e):
            e = e.cpu_parent
        return e

    def port(name):
        return ("softmac_tpu_torch/" in name or "chip_smoke.py" in name) \
            and "(" in name

    def frames(e):
        out = [f for f in e.stack if port(f)]
        while e is not None:
            if port(e.name):
                out.append(e.name)
            e = e.cpu_parent
        return out[:6]

    def shapes(e):
        return str(e.input_shapes) if e is not None else None
    sites = {}
    for e in cpu:
        hits = [k for k in e.kernels if pattern in k.name]
        if not hits:
            continue
        node = up(e, lambda x: x.name.startswith(
            "autograd::engine::evaluate_function"))
        f = (fwd.get((node.fwd_thread, node.sequence_nr))
             if node is not None else None)
        key = (e.name, shapes(e), node.name if node else None,
               f.name if f else None, shapes(f), tuple(frames(f if f else e)))
        n, us = sites.get(key, (0, 0.0))
        sites[key] = (n + len(hits), us + sum(k.duration for k in hits))
    if not sites:
        raise AssertionError(f"no device kernel named *{pattern}* launched")
    n_sub = steps * env.substeps
    return {"pattern": pattern, "env_steps": steps, "substeps": n_sub,
            "sites": [{"launched_by": k[0], "input_shapes": k[1],
                       "backward_node": k[2], "forward_op": k[3],
                       "forward_input_shapes": k[4],
                       "forward_frames": list(k[5]),
                       "launches_per_substep": n / n_sub,
                       "device_ms_per_launch": us / 1e3 / n}
                      for k, (n, us) in sorted(sites.items(),
                                               key=lambda kv: -kv[1][1])]}


def rigid_step_launches(env):
    """Device kernels one RigidModel step and its body_states launch (once
    per env step of the rigid scenes), counted with torch.profiler."""
    return rigid_step_profile(env)["launches"]


def run_parity():
    """Card (float32, kernels) against the CPU (float64, plain versions)
    on each demo's own scene: pour_vel (rollout and rollout_and_grad) and
    the flagship pour (rollout)."""
    return {"pour_vel": run_pour_vel_parity(), "pour": run_pour_parity()}


def run_pour_vel_parity():
    """pour_vel's 5000-particle demo scene, 20 steps of rollout and of
    rollout_and_grad on the card and on the CPU."""
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


def run_pour_parity():
    """The flagship pour's 5000-particle demo scene (its SHAPES, window
    (48, 32, 16)), 20 steps of seeded actions: x, the rigid q and qd within
    1e-4 absolute, the loss within 1e-4 relative."""
    import numpy as np
    from softmac_tpu_torch import SoftMacEnv
    steps = 20
    acts = np.random.RandomState(2).randn(steps, 12) * 0.05
    reset_launches()
    outs = {"cuda": SoftMacEnv(pour_cfg(), device="cuda").rollout(acts)}
    launches = read_launches()      # the card's run went through the kernels
    outs["cpu"] = SoftMacEnv(pour_cfg(), device="cpu").rollout(acts)
    (mg, _, rg), (mc, _, rc) = outs["cuda"]["carry"], outs["cpu"]["carry"]
    lg, lc = outs["cuda"]["loss"].item(), outs["cpu"]["loss"].item()
    res = {"n_particles": mc.x.shape[1], "env_steps": steps,
           "x_max_abs_err": (mg.x.double().cpu() - mc.x).abs().max().item(),
           "q_max_abs_err": (rg.q.double().cpu() - rc.q).abs().max().item(),
           "qd_max_abs_err": (rg.qd.double().cpu() - rc.qd).abs().max().item(),
           "glass_qd_cpu_max_abs": rc.qd[0:6].abs().max().item(),
           "loss_gpu": lg, "loss_cpu": lc,
           "loss_rel_err": abs(lg - lc) / abs(lc), "tolerance": 1e-4,
           "window_overflow": bool(outs["cuda"]["terms"]["window_overflow"]),
           "gpu_launches": launches}
    if not all(launches[k] > 0 for k in POUR):
        raise AssertionError(f"pour parity: the card's run missed a kernel "
                             f"{launches}")
    if not (res["x_max_abs_err"] <= 1e-4 and res["q_max_abs_err"] <= 1e-4
            and res["qd_max_abs_err"] <= 1e-4 and res["loss_rel_err"] <= 1e-4
            and not res["window_overflow"]):
        raise AssertionError(f"pour GPU/CPU parity failed: {res}")
    # rollout_and_grad of the same steps (loss frames 0 and 20)
    reset_launches()
    grads = {"cuda": SoftMacEnv(pour_cfg(), device="cuda").rollout_and_grad(
        acts)}
    launches = read_launches()
    grads["cpu"] = SoftMacEnv(pour_cfg(), device="cpu").rollout_and_grad(acts)
    gg = grads["cuda"]["action_grad"].double().cpu()
    gc = grads["cpu"]["action_grad"]
    lg, lc = grads["cuda"]["loss"].item(), grads["cpu"]["loss"].item()
    res["grad"] = {"loss_gpu": lg, "loss_cpu": lc,
                   "loss_rel_err": abs(lg - lc) / abs(lc),
                   "loss_tolerance": 1e-4,
                   "action_grad_rel_l2_err": ((gg - gc).norm().item()
                                              / gc.norm().item()),
                   "action_grad_tolerance": 1e-3,
                   "action_grad_cpu_max_abs": gc.abs().max().item(),
                   "gpu_launches": launches}
    if not all(launches[k] > 0 for k in POUR + POUR_BWD):
        raise AssertionError("pour gradient parity: the card's run missed a "
                             f"kernel {launches}")
    if not (res["grad"]["loss_rel_err"] <= 1e-4
            and res["grad"]["action_grad_rel_l2_err"] <= 1e-3):
        raise AssertionError(f"pour GPU/CPU gradient parity failed: {res}")
    return res


def run_demo():
    """The ported pour trainer on the card (run_demo_trainer, DEMO_STEPS
    env steps an epoch): also the actions moved and every kernel of the
    pour's forward and backward launched."""
    from softmac_tpu_torch.demos import demo_pour
    res = run_demo_trainer(demo_pour, "pour", DEMO_STEPS,
                           POUR + POUR_BWD + ("p2g", "g2p", "p2g_bwd",
                                              "g2p_bwd"))
    if not res["actions_max_abs_change"] > 0:
        raise AssertionError(f"demo_pour on the card failed: {res}")
    return res


def door_cfg():
    from softmac_tpu_torch import load
    return load(str(ROOT / "softmac_tpu_torch/config/demo_door_config.py"))


def door_env(device=None, init_particles=None):
    """The door scene with every particle on controller 0
    (demos/demo_door.py:49)."""
    import numpy as np
    from softmac_tpu_torch import SoftMacEnv
    env = SoftMacEnv(door_cfg(), device=device, init_particles=init_particles)
    env.set_control_idx(np.zeros(env.n_particles, np.int32))
    return env


def door_actions(n_steps):
    """The demo's initial actions: 0.1 on z (demos/demo_door.py:38-42)."""
    import numpy as np
    acts = np.zeros((n_steps, 3))
    acts[:, 2] = 0.1
    return acts


def tiled_carry(carry, n, seed=0):
    """An MPM carry tiled to n particles with 1e-4 jitter on x."""
    import numpy as np
    import torch
    from softmac_tpu_torch.engine.types import MPMState
    mpm, bodies, rigid = carry
    idx = torch.arange(n, device=mpm.x.device) % mpm.x.shape[1]
    jitter = torch.as_tensor(np.random.RandomState(seed).randn(3, n) * 1e-4,
                             dtype=mpm.x.dtype, device=mpm.x.device)
    return (MPMState(x=(mpm.x[:, idx] + jitter).contiguous(),
                     v=mpm.v[:, idx].contiguous(),
                     C=mpm.C[:, :, idx].contiguous(),
                     F=mpm.F[:, :, idx].contiguous()), bodies, rigid)


def door_kernel_inputs(env, carry, action):
    """The inputs the door's first substep from ``carry`` hands the four
    dense-weight transfers (y-sorted, as the rollout keeps them), built
    with the port's own substep stages and the kernels, so that they are
    the same on every run."""
    import torch
    from softmac_tpu_torch.engine import mpm
    from softmac_tpu_torch.ops import contact, fused
    from softmac_tpu_torch.ops import m33
    cfg = env.mpm_cfg
    state, bodies, _ = carry
    q, _ = mpm.sort_perm(cfg, state.x)
    state = mpm.permute_state(state, q)
    params = mpm.permute_params(env.mpm_params, q)
    stress, _ = mpm.stress_and_F(cfg, params, state)
    impulse, _ = mpm.contact_impulse(cfg, params, env.prims, state, bodies)
    act = torch.as_tensor(action, dtype=state.x.dtype,
                          device=state.x.device).reshape(-1, 3)
    impulse = mpm.control_impulse(cfg, params, impulse, act)
    tr = mpm.Transfers(cfg, state.x)
    if tr.route != "fused" or bool(tr.overflow):
        raise AssertionError(f"door kernel-check state: route {tr.route}, "
                             f"overflow {bool(tr.overflow)}")
    chan = mpm._p2g_channels(cfg, tuple(state.v), m33.from_mat_array(state.C),
                             stress, impulse)
    gm, gmom = fused.p2g(*tr.ws6, chan)
    gvm, mask = mpm._bounded_velocity(cfg, params, gm, gmom, tr.sizes,
                                      tr.corner)
    gvm = tuple(g.contiguous() for g in gvm)
    v_tmp = fused.gather(*tr.W, *gvm)
    life = torch.full((), 1.0 / cfg.substeps, dtype=state.x.dtype,
                      device=state.x.device)      # substep k = 0
    v_tgt, contacts = v_tmp, []
    for i, prim in enumerate(env.prims):
        body = (bodies.pos[i], bodies.quat[i], bodies.v[i], bodies.w[i],
                params.friction[i], params.softness[i], life)
        contacts.append((prim, body, v_tgt))
        v_tgt = contact.collide_mixed(
            prim, *body, state.x, v_tgt, cfg.dt, cfg.p_mass,
            cfg.contact_push_velocity_cap)[0]
    vals = (-2.0 * (v_tmp - v_tgt)).contiguous()
    corr = fused.splat(*tr.W, vals)
    wx = tr.sizes[0]
    gv = tuple(g.contiguous() for g in mpm.cfl_clamp(cfg, tuple(
        torch.where(mask, gvm[d] + corr[:, d * wx:(d + 1) * wx], 0.0)
        for d in range(3))))
    return dict(n=state.x.shape[1], sizes=tr.sizes, ws6=tr.ws6, chan=chan,
                gvm=gvm, vals=vals, gv=gv, cfg=cfg, state=state,
                contacts=contacts)


def door_states():
    """The door env on the card, its carry after STATE_STEPS env steps of
    the demo's actions, and the dense-weight kernels' inputs of its first
    substep from that carry: {"door": 5400 particles, "1e5": the carry
    tiled to N_MAIN particles, "band": the 5400 after BAND_STEPS env steps,
    when the boxes touch the door and the splat's values are nonzero in
    the contact band}."""
    env = door_env()
    carry = env.rollout(door_actions(STATE_STEPS))["carry"]
    band = env.rollout(door_actions(BAND_STEPS - STATE_STEPS),
                       carry0=carry)["carry"]
    big = tiled_carry(carry, N_MAIN)
    return env, carry, {
        "door": door_kernel_inputs(env, carry, door_actions(1)[0]),
        "1e5": door_kernel_inputs(
            door_env(init_particles=big[0].x.T.cpu().numpy()), big,
            door_actions(1)[0]),
        "band": door_kernel_inputs(env, band, door_actions(1)[0])}


def dense_kernel_inputs(device):
    """Fully dense seeded normal weights at DENSE_WINDOW with N_DENSE
    particles, and seeded channels, grids and values: the general function
    the kernels compute, beyond B-spline weights."""
    import torch
    wx, wy, wz = DENSE_WINDOW
    gen = torch.Generator(device=device).manual_seed(5)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)
    ws6 = tuple(normal(w, N_DENSE) for w in (wx, wx, wy, wy, wz, wz))
    gv = tuple(normal(wy * wz, wx) for _ in range(3))
    return dict(n=N_DENSE, sizes=DENSE_WINDOW, ws6=ws6,
                chan=normal(13, N_DENSE), gvm=gv, vals=normal(3, N_DENSE),
                gv=gv)


def fused_einsums(inp, dtype=None):
    """One torch.einsum per function over the dense weights (TF32 off):
    the library yardstick of each kernel, used nowhere in the port. The
    stacked operands are built here, outside the timed call; ``dtype``
    casts them (float64 to check the formulas)."""
    import torch
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))  # noqa: E731
    Wx, WxD, Wy, WDy, Wz, WDz = map(cast, inp["ws6"])
    wx, wy, wz = inp["sizes"]
    chan = cast(inp["chan"])
    # the four weight combinations of P2G and G2P: (Wy Wz Wx), (Wy Wz WxD),
    # (WDy Wz Wx), (Wy WDz Wx)
    Y4 = torch.stack([Wy, Wy, WDy, Wy])
    Z4 = torch.stack([Wz, Wz, Wz, WDz])
    X4 = torch.stack([Wx, WxD, Wx, Wx])
    zero = torch.zeros_like(chan[0])
    ch = torch.stack([chan[0:4]] + [torch.stack([zero, chan[4 + j],
                                                 chan[7 + j], chan[10 + j]])
                                    for j in range(3)])      # (k, c, N)
    G = lambda grids: cast(torch.stack(grids)).reshape(3, wy, wz, wx)  # noqa: E731
    gv, gvm, vals = G(inp["gv"]), G(inp["gvm"]), cast(inp["vals"])
    return {
        "fused_p2g": lambda: torch.einsum("kyp,kzp,kcp,kxp->yzcx", Y4, Z4,
                                          ch, X4),
        "fused_g2p": lambda: torch.einsum("kyp,kzp,dyzx,kxp->kdp", Y4, Z4,
                                          gv, X4),
        "fused_splat": lambda: torch.einsum("yp,zp,dp,xp->yzdx", Wy, Wz,
                                            vals, Wx),
        "fused_gather": lambda: torch.einsum("yp,zp,dyzx,xp->dp", Wy, Wz,
                                             gvm, Wx)}


def _einsum_rows(name, out, sizes):
    """An einsum's result in the rows form of ``_fused_rows``; G2P's
    (k, d, N) becomes the kernel's (12, N): v, then C[d][j] in row
    3 + 3d + j."""
    import torch
    wx, wy, wz = sizes
    if name == "fused_p2g":
        return out.reshape(wy * wz, 4, wx).transpose(0, 1).reshape(4, -1)
    if name == "fused_g2p":
        return torch.cat([out[0], out[1:].transpose(0, 1).reshape(9, -1)])
    if name == "fused_splat":
        return out.reshape(wy * wz, 3, wx).transpose(0, 1).reshape(3, -1)
    return out


def _fused_rows(name, out, sizes):
    """Each function's output as rows compared one by one: P2G's mass and
    three momentum windows, G2P's 12 particle rows, the splat's three
    component windows, the gather's three rows."""
    import torch
    wx, wy, wz = sizes
    if name == "fused_p2g":
        gm, gmom = out
        return torch.cat([gm.reshape(1, -1), gmom.reshape(
            wy * wz, 3, wx).transpose(0, 1).reshape(3, -1)])
    if name == "fused_splat":
        return out.reshape(wy * wz, 3, wx).transpose(0, 1).reshape(3, -1)
    return out


def fused_calls(inp):
    """name -> (kernel call, plain call on the same float32 inputs, float64
    plain call)."""
    from softmac_tpu_torch.ops import fused
    ws6, chan, gv, gvm, vals = (inp[k] for k in ("ws6", "chan", "gv", "gvm",
                                                "vals"))
    W = ws6[0::2]
    w64 = [w.double() for w in ws6]
    d = lambda ts: [t.double() for t in ts]  # noqa: E731
    return {
        "fused_p2g": (lambda: fused.p2g(*ws6, chan),
                      lambda: fused.p2g_plain(*ws6, chan),
                      lambda: fused.p2g_plain(*w64, chan.double())),
        "fused_g2p": (lambda: fused.g2p(*ws6, *gv),
                      lambda: fused.g2p_plain(*ws6, *gv),
                      lambda: fused.g2p_plain(*w64, *d(gv))),
        "fused_splat": (lambda: fused.splat(*W, vals),
                        lambda: fused.splat_plain(*W, vals),
                        lambda: fused.splat_plain(*w64[0::2], vals.double())),
        "fused_gather": (lambda: fused.gather(*W, *gvm),
                         lambda: fused.gather_plain(*W, *gvm),
                         lambda: fused.gather_plain(*w64[0::2], *d(gvm)))}


def _rows_rel(got, want):
    """max |got - want| and the largest of that over each row's max |want|."""
    diff = (got.double() - want.double()).abs()
    scale = want.double().abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    return diff.max().item(), (diff / scale).max().item()


def fused_work(name, inp):
    """(bytes, visited cells, dense cells, band) of one call: each input
    read once and each output written once; the cells inside each
    particle's nonzero row ranges (what the kernel visits), and wx*wy*wz a
    particle (the dense contraction). The splat's work is its band's, the
    particles with a nonzero value (``band``; all n for the others): their
    weights and cells; every particle's 3 values are read."""
    import torch
    n, (wx, wy, wz) = inp["n"], inp["sizes"]
    cells = wx * wy * wz
    ws6 = inp["ws6"]
    deriv = name in ("fused_p2g", "fused_g2p")
    live = (inp["vals"] != 0).any(dim=0) if name == "fused_splat" else \
        torch.ones(n, dtype=torch.bool, device=ws6[0].device)
    band = int(live.sum().item())
    lengths = []
    for a, b in zip(ws6[0::2], ws6[1::2]):
        nz = ((a != 0) | (b != 0) if deriv else a != 0) & live
        rows = torch.arange(a.shape[0], device=a.device)[:, None]
        lo = torch.where(nz, rows, a.shape[0]).amin(dim=0)
        hi = torch.where(nz, rows, -1).amax(dim=0)
        lengths.append((hi - lo + 1).clamp(min=0).double())
    visited = int((lengths[0] * lengths[1] * lengths[2]).sum().item())
    w_rows = (2 if deriv else 1) * (wx + wy + wz)
    per_particle = {"fused_p2g": 13, "fused_g2p": 12, "fused_splat": 3,
                    "fused_gather": 3}[name]
    nbytes = (w_rows * band + per_particle * n) * 4 \
        + (4 if name == "fused_p2g" else 3) * cells * 4
    return nbytes, visited, n * cells, band


def check_fused_kernels(door_inp, big_inp, dense_inp, band_inp):
    """The four dense-weight transfer kernels against their float64 plain
    versions on the door's state, on dense random weights and on that
    state tiled to 1e5 particles (1e-5 of each output row's largest
    |value|), FUSED_REPEATS calls of each on every input bit for bit the
    same; timed with CUDA events on the door's state and at 1e5, beside the
    plain version and one torch.einsum over the dense weights; bounds from
    each run's inputs. Each is also held and timed on the door's band
    state (band_inp), and its device launches a call on each timed input
    are FUSED_CALL_LAUNCHES."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    srcs = {
        "fused_p2g": ("fused_p2g.cu", ":627 (_p2g_pallas, pallas_call :641, "
                      "kernel _p2g_kernel :256)"),
        "fused_g2p": ("fused_g2p.cu", ":660 (_g2p_pallas, pallas_call :672, "
                      "kernel _g2p_kernel :295)"),
        "fused_splat": ("fused_splat.cu", ":689 (_splat_pallas, pallas_call "
                        ":700, kernel _splat_kernel :505)"),
        "fused_gather": ("fused_gather.cu", ":714 (_gather_pallas, "
                         "pallas_call :725, kernel _gather_kernel :520)")}
    inputs = {"door": door_inp, "dense": dense_inp, "big": big_inp,
              "band": band_inp}
    calls = {k: fused_calls(inp) for k, inp in inputs.items()}
    libs = {k: fused_einsums(inputs[k]) for k in ("door", "big")}
    entries = []
    for name, (src, where) in srcs.items():
        errs, repeats = {}, {}
        for case in inputs:
            kern, _, ref = calls[case][name]
            sizes = inputs[case]["sizes"]
            errs[case] = _rows_rel(_fused_rows(name, kern(), sizes),
                                   _fused_rows(name, ref(), sizes))
            repeats[case] = bit_identical(kern)
        if not all(repeats.values()):
            raise AssertionError(f"{name}: {FUSED_REPEATS} calls differ: "
                                 f"{repeats}")
        # the einsum's formula, run in float64, against the plain version
        lib_err = _rows_rel(
            _einsum_rows(name, fused_einsums(door_inp, torch.float64)[name](),
                         door_inp["sizes"]),
            _fused_rows(name, calls["door"][name][2](), door_inp["sizes"]))[1]
        if not lib_err <= 1e-8:
            raise AssertionError(f"{name}: the einsum yardstick differs by "
                                 f"{lib_err}")
        times = {}
        for case in ("door", "big"):
            kern, plain, _ = calls[case][name]
            times[case] = (cuda_time_ms(kern), cuda_time_ms(plain),
                           cuda_time_ms(libs[case][name], iters=5),
                           device_ms(name + ("@1e5" if case == "big" else ""),
                                     kern))
        nbytes, visited, dense, band = fused_work(name, door_inp)
        e = kernel_entry(door_inp["n"], name,
                         "softmac_tpu_torch/ops/csrc/" + src,
                         "softmac_tpu/ops/pallas_fused.py" + where,
                         max(v[0] for v in errs.values()),
                         max(v[1] for v in errs.values()), times["door"][0],
                         times["door"][1], nbytes,
                         flops=visited * FLOPS_PER_CELL[name])
        e["library_ms"] = times["door"][2]
        e["library_is"] = ("one torch.einsum over the dense weights, TF32 "
                           "off (operands stacked outside the timed call)")
        e["library_float64_rel_err"] = lib_err
        e["rel_err_is"] = ("max |kernel - plain| / max |plain| per output "
                           "row (window components for P2G and the splat), "
                           "the plain version in float64, over the door's "
                           "state, the dense random weights, the 1e5 "
                           "tiling and the band state")
        e["rel_err_by_input"] = {k: v[1] for k, v in errs.items()}
        e["repeats_bit_identical"] = repeats
        e["dense_input"] = {"window": list(DENSE_WINDOW), "n": N_DENSE}
        e["n_particles"] = door_inp["n"]
        e["band"] = band
        e["visited_cells"] = visited
        e["dense_flops"] = dense * FLOPS_PER_CELL[name]
        nb, vis, _, big_band = fused_work(name, big_inp)
        b_ms, b_by = bound(name, big_inp["n"], nb,
                           vis * FLOPS_PER_CELL[name])
        e["at_1e5"] = {"n_particles": big_inp["n"], "ms": times["big"][0],
                       "device_ms": times["big"][3],
                       "plain_ms": times["big"][1],
                       "library_ms": times["big"][2], "bound_ms": b_ms,
                       "bound_by": b_by, "bytes": nb, "visited_cells": vis,
                       "band": big_band}
        kern, plain, _ = calls["band"][name]
        nb, vis, _, band_n = fused_work(name, band_inp)
        b_ms, b_by = bound(name, band_inp["n"], nb, vis * FLOPS_PER_CELL[name])
        e["at_band"] = {"env_steps": BAND_STEPS, "band": band_n,
                        "ms": cuda_time_ms(kern),
                        "device_ms": device_ms(name + "@band", kern),
                        "plain_ms": cuda_time_ms(plain), "bound_ms": b_ms,
                        "bound_by": b_by, "bytes": nb, "visited_cells": vis}
        launches = {k: DEVICE_MS[name + k][1] for k in ("", "@1e5", "@band")}
        # a profile can also lose every event of one of a call's kernels
        # (a final run of PR 23: the splat's two launches read as one on
        # the door's state, where earlier runs read two): profile such an
        # input again, up to three times, before holding the count
        timed = {"": calls["door"][name][0], "@1e5": calls["big"][name][0],
                 "@band": kern}
        for _ in range(3):
            short = [k for k, v in launches.items()
                     if v != FUSED_CALL_LAUNCHES[name]]
            for k in short:
                del DEVICE_MS[name + k]
                device_ms(name + k, timed[k])
                launches[k] = DEVICE_MS[name + k][1]
        e["device_launches_by_input"] = launches
        if set(launches.values()) != {FUSED_CALL_LAUNCHES[name]}:
            raise AssertionError(f"{name}: device launches a call "
                                 f"{launches}, expected "
                                 f"{FUSED_CALL_LAUNCHES[name]}")
        if name == "fused_splat":
            print(f"{name}: band {band} of {door_inp['n']} (door state), "
                  f"{band_n} (band state), {big_band} of {big_inp['n']} "
                  f"(1e5)", flush=True)
        entries.append(e)
    return entries


def fused_cotangents(inp, seed=9):
    """Seeded normal cotangents of the four transfers' outputs at ``inp``'s
    shapes: dgm, dgmom (P2G), g12 (G2P's rows), dout (the splat's window),
    dv (the gather)."""
    import torch
    n, (wx, wy, wz) = inp["n"], inp["sizes"]
    dev = inp["chan"].device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return dict(dgm=normal(wy * wz, wx), dgmom=normal(wy * wz, 3 * wx),
                g12=normal(12, n), dout=normal(wy * wz, 3 * wx),
                dv=normal(3, n))


def fused_bwd_calls(inp, cts):
    """name -> (backward kernel call, plain vjp on the same float32 inputs,
    float64 plain vjp)."""
    from softmac_tpu_torch.ops import fused
    ws6, chan, gv, gvm, vals = (inp[k] for k in ("ws6", "chan", "gv", "gvm",
                                                "vals"))
    W = ws6[0::2]
    args = {"fused_p2g_bwd": (fused.p2g_bwd, fused.p2g_vjp_plain,
                              (*ws6, chan, cts["dgm"], cts["dgmom"])),
            "fused_g2p_bwd": (fused.g2p_bwd, fused.g2p_vjp_plain,
                              (*ws6, *gv, cts["g12"])),
            "fused_splat_bwd": (fused.splat_bwd, fused.splat_vjp_plain,
                                (*W, vals, cts["dout"])),
            "fused_gather_bwd": (fused.gather_bwd, fused.gather_vjp_plain,
                                 (*W, *gvm, cts["dv"]))}
    return {k: (lambda f=f, a=a: f(*a), lambda v=v, a=a: v(*a),
                lambda v=v, a=a: v(*(t.double() for t in a)))
            for k, (f, v, a) in args.items()}


def fused_einsum_vjps(inp, cts, dtype=None):
    """name -> one call of torch.autograd.grad through the einsum yardstick
    of ``fused_einsums`` (its forward run once here, outside the timed
    call): the cotangents of the same inputs as the backward kernel's, the
    library yardstick of each backward ("einsum vjp"), used nowhere in the
    port. ``dtype`` casts the inputs (float64 to check the formulas)."""
    import torch
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))  # noqa: E731

    def leaf(t):
        return cast(t).detach().requires_grad_()
    lin = dict(inp, ws6=tuple(leaf(w) for w in inp["ws6"]),
               chan=leaf(inp["chan"]), vals=leaf(inp["vals"]),
               gv=tuple(leaf(g) for g in inp["gv"]),
               gvm=tuple(leaf(g) for g in inp["gvm"]))
    with torch.enable_grad():
        outs = {k: f() for k, f in fused_einsums(lin).items()}
    wx, wy, wz = inp["sizes"]
    c = {k: cast(v) for k, v in cts.items()}
    cot = {"fused_p2g": torch.cat([c["dgm"].reshape(wy, wz, 1, wx),
                                   c["dgmom"].reshape(wy, wz, 3, wx)], dim=2),
           "fused_g2p": torch.stack([c["g12"][0:3]] + [c["g12"][3 + j:12:3]
                                                       for j in range(3)]),
           "fused_splat": c["dout"].reshape(wy, wz, 3, wx),
           "fused_gather": c["dv"]}
    ws6 = lin["ws6"]
    leaves = {"fused_p2g": (*ws6, lin["chan"]),
              "fused_g2p": (*ws6, *lin["gv"]),
              "fused_splat": (*ws6[0::2], lin["vals"]),
              "fused_gather": (*ws6[0::2], *lin["gvm"])}
    return {k + "_bwd": (lambda k=k: torch.autograd.grad(
        outs[k], leaves[k], cot[k], retain_graph=True)) for k in outs}


def _bwd_rel(got, want):
    """(max |got - want|, the largest of it over each row's max |want|)
    over every output of a backward: the weight, channel and value
    cotangents row by row, each grid cotangent as one row."""
    worst = (0.0, 0.0)
    for g, w in zip(got, want):
        if w.shape[1] != want[0].shape[1]:      # a grid cotangent
            g, w = g.reshape(1, -1), w.reshape(1, -1)
        a, r = _rows_rel(g, w)
        worst = (max(worst[0], a), max(worst[1], r))
    return worst


def fused_bwd_work(name, inp):
    """(bytes, weight-row cells, box cells) of one backward call: each
    input read once and each output written once; the cells the function
    needs for these inputs: every row of each weight cotangent sums over
    the particle's box on the other two axes, and the channel or grid
    terms over the box."""
    import torch
    n, (wx, wy, wz) = inp["n"], inp["sizes"]
    cells = wx * wy * wz
    ws6 = inp["ws6"]
    deriv = name in ("fused_p2g_bwd", "fused_g2p_bwd")
    lx, ly, lz = [], [], []
    for lens, a, b in zip((lx, ly, lz), ws6[0::2], ws6[1::2]):
        nz = (a != 0) | (b != 0) if deriv else a != 0
        rows = torch.arange(a.shape[0], device=a.device)[:, None]
        lo = torch.where(nz, rows, a.shape[0]).amin(dim=0)
        hi = torch.where(nz, rows, -1).amax(dim=0)
        lens.append((hi - lo + 1).clamp(min=0).double())
    lx, ly, lz = lx[0], ly[0], lz[0]
    row_cells = int((wx * ly * lz + wy * lz * lx + wz * ly * lx).sum().item())
    box_cells = int((lx * ly * lz).sum().item())
    w_rows = (2 if deriv else 1) * (wx + wy + wz)
    per_particle, grid_cells = {
        "fused_p2g_bwd": (13 + 13, 4 * cells),     # chan, dchan; dgm, dgmom
        "fused_g2p_bwd": (12, 6 * cells),          # g; gv and dgv
        "fused_splat_bwd": (3 + 3, 3 * cells),     # vals, dvals; dout
        "fused_gather_bwd": (3, 6 * cells)}[name]  # dv; gv and dgv
    nbytes = (2 * w_rows + per_particle) * n * 4 + grid_cells * 4
    return nbytes, row_cells, box_cells


def bit_identical(fn, repeats=FUSED_REPEATS):
    """Whether ``repeats`` calls of ``fn`` (a tuple of tensors each) agree
    bit for bit."""
    import torch
    outs = [fn() for _ in range(repeats)]
    torch.cuda.synchronize()
    return all(all(torch.equal(p, q) for p, q in zip(o, outs[0]))
               for o in outs[1:])


def check_fused_backward_kernels(door_inp, big_inp, dense_inp):
    """The four backward kernels of the dense-weight transfers (row 18)
    against their float64 plain vjps on the door's state and on dense
    random weights with seeded normal cotangents (ROW_TOL of each output
    row's largest |value|), timed with CUDA events on the door's state and
    on it tiled to 1e5 particles, beside the float32 plain vjp and one
    torch.autograd.grad through the einsum yardstick; bounds from each
    run's inputs. The row-thread kernels (ROW_KERNELS) are also held on the
    1e5 particles, and FUSED_REPEATS calls of each on every input must
    agree bit for bit."""
    import torch
    srcs = {
        "fused_p2g_bwd": ("fused_p2g_bwd.cu", ":740 (_p2g_bwd_pallas, "
                          "pallas_call :758, kernel _p2g_bwd_kernel :330)"),
        "fused_g2p_bwd": ("fused_g2p_bwd.cu", ":774 (_g2p_bwd_pallas, "
                          "pallas_call :794, kernel _g2p_bwd_kernel :423)"),
        "fused_splat_bwd": ("fused_splat_bwd.cu", ":811 (_splat_bwd_pallas, "
                            "pallas_call :828, kernel _splat_bwd_kernel "
                            ":534)"),
        "fused_gather_bwd": ("fused_gather_bwd.cu", ":840 "
                             "(_gather_bwd_pallas, pallas_call :858, kernel "
                             "_gather_bwd_kernel :570)")}
    cts = {k: fused_cotangents(inp) for k, inp in
           (("door", door_inp), ("big", big_inp), ("dense", dense_inp))}
    calls = {k: fused_bwd_calls(inp, cts[k]) for k, inp in
             (("door", door_inp), ("big", big_inp), ("dense", dense_inp))}
    libs = {k: fused_einsum_vjps(inp, cts[k]) for k, inp in
            (("door", door_inp), ("big", big_inp))}
    lib64 = fused_einsum_vjps(door_inp, cts["door"], torch.float64)
    entries = []
    for name, (src, where) in srcs.items():
        errs, repeats = {}, {}
        for case, inp in (("door", door_inp), ("dense", dense_inp),
                          ("big", big_inp)):
            if case == "big" and name not in ROW_KERNELS:
                continue
            kern, _, ref = calls[case][name]
            errs[case] = _bwd_rel(kern(), ref())
            if name in ROW_KERNELS:
                repeats[case] = bit_identical(kern)
        if not all(repeats.values()):
            raise AssertionError(f"{name}: {FUSED_REPEATS} calls differ: "
                                 f"{repeats}")
        lib_err = _bwd_rel(lib64[name](), calls["door"][name][2]())[1]
        if not lib_err <= 1e-8:
            raise AssertionError(f"{name}: the einsum vjp yardstick differs "
                                 f"by {lib_err}")
        times = {}
        for case in ("door", "big"):
            kern, plain, _ = calls[case][name]
            times[case] = (cuda_time_ms(kern), cuda_time_ms(plain, iters=5),
                           cuda_time_ms(libs[case][name], iters=5),
                           device_ms(name + ("@1e5" if case == "big" else ""),
                                     kern))
        f_row, f_box = FLOPS_PER_BWD_CELL[name]
        nbytes, row_cells, box_cells = fused_bwd_work(name, door_inp)
        e = kernel_entry(door_inp["n"], name,
                         "softmac_tpu_torch/ops/csrc/" + src,
                         "softmac_tpu/ops/pallas_fused.py" + where,
                         max(v[0] for v in errs.values()),
                         max(v[1] for v in errs.values()), times["door"][0],
                         times["door"][1], nbytes,
                         tolerance=ROW_TOL,
                         flops=row_cells * f_row + box_cells * f_box)
        e["library_ms"] = times["door"][2]
        e["library_is"] = ("einsum vjp: one torch.autograd.grad through the "
                           "einsum of the forward over the dense weights "
                           "(its forward outside the timed call), TF32 off")
        e["library_float64_rel_err"] = lib_err
        e["rel_err_is"] = ("max |kernel - plain vjp| / max |plain vjp| per "
                           "output row (each grid cotangent one row), the "
                           "plain vjp in float64, seeded normal "
                           "cotangents, over the door's state and the dense "
                           "random weights")
        e["rel_err_by_input"] = {k: v[1] for k, v in errs.items()}
        if name in ROW_KERNELS:
            e["repeats_bit_identical"] = repeats
        e["dense_input"] = {"window": list(DENSE_WINDOW), "n": N_DENSE}
        e["n_particles"] = door_inp["n"]
        e["row_cells"], e["box_cells"] = row_cells, box_cells
        nb, rc, bc = fused_bwd_work(name, big_inp)
        b_ms, b_by = bound(name, big_inp["n"], nb, rc * f_row + bc * f_box)
        e["at_1e5"] = {"n_particles": big_inp["n"], "ms": times["big"][0],
                       "device_ms": times["big"][3],
                       "plain_ms": times["big"][1],
                       "library_ms": times["big"][2], "bound_ms": b_ms,
                       "bound_by": b_by, "bytes": nb, "row_cells": rc,
                       "box_cells": bc}
        entries.append(e)
    return entries


def door_grad_expect(env, steps, remat):
    """Launches of every kernel in the door's rollout_and_grad over
    ``steps`` env steps whose last loss frame ends the rollout. Every step
    records autograd (its P2G channels carry the controller's action, and
    the rest of the substep follows from them), so each forward kernel runs
    once a substep and once more under remat "step" (the backward replays
    every step), and each backward kernel once a substep; no ops/transfer.py
    kernel."""
    n_sub = steps * env.substeps
    b = env.n_primitives
    fwd = n_sub * (2 if remat == "step" else 1)
    expect = dict.fromkeys(wrappers(), 0)
    expect.update(dict.fromkeys(FUSED, fwd))
    expect.update(dict.fromkeys(FUSED_BWD, n_sub))
    expect["collide_mixed"] = b * fwd
    expect["collide_mixed_bwd"] = b * n_sub
    return expect


def door_loss_start(env, steps):
    """The demo's first loss frame (demos/demo_door.py:53)."""
    return (2 * steps * env.substeps // 3) // 20 * 20


def run_door_grad(env):
    """The door's gradient main path: rollout_and_grad of DOOR_GRAD_STEPS
    env steps of the demo's initial actions with its loss frames and
    grad_clip 1.0, under remat "step" and "none" (exact launch counts, a
    repeat of each, step against none)."""
    steps = DOOR_GRAD_STEPS
    out, launches = run_gradient(
        "door_grad", env, door_actions(steps),
        lambda remat: door_grad_expect(env, steps, remat), [0, 1, 2],
        env.mpm_cfg.active_window, repeats=DOOR_GRAD_REPEATS,
        loss_start_frame=door_loss_start(env, steps), grad_clip=1.0)
    return {"scene": "demo_door", "actions": "z = 0.1", **out}, launches


def run_demo_door():
    """The door trainer on the card: softmac_tpu_torch.demos.demo_door for
    DEMO_DOOR_EPOCHS epochs of DEMO_DOOR_STEPS env steps with
    DEMO_DOOR_REPLICAS jittered replicas on the demo's own scene, logs in a
    temporary directory. Losses finite and non-increasing, losses.npy and a
    checkpoint an epoch written, the actions moved, every fused forward and
    backward kernel and the mixed contact and its backward launched."""
    import tempfile
    import numpy as np
    from softmac_tpu_torch.demos import demo_door
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        t0 = time.perf_counter()
        out = demo_door.main(["--steps", str(DEMO_DOOR_STEPS), "--epochs",
                              str(DEMO_DOOR_EPOCHS), "--replicas",
                              str(DEMO_DOOR_REPLICAS), "--log-root", tmp,
                              "--render-interval", "0"])
        secs = time.perf_counter() - t0
        launches = read_launches()
        log = Path(tmp) / "door"
        ckpts = sorted(p.name for p in (log / "ckpt").glob("actions_*.npy"))
        saved = np.load(log / "losses.npy").tolist()
        a_last = np.load(log / f"ckpt/actions_{DEMO_DOOR_EPOCHS - 1}.npy")
    losses = out["losses"]
    res = {"epochs": DEMO_DOOR_EPOCHS, "env_steps": DEMO_DOOR_STEPS,
           "replicas": DEMO_DOOR_REPLICAS, "losses": losses,
           "epoch_seconds": out["epoch_seconds"],
           "seconds_with_setup": secs, "checkpoints": ckpts,
           "actions_max_abs_change": float(np.abs(
               a_last - door_actions(DEMO_DOOR_STEPS)).max()),
           "launches": launches}
    if not (all(math.isfinite(v) for v in losses) and saved == losses
            and all(b <= a for a, b in zip(losses, losses[1:]))
            and len(ckpts) == DEMO_DOOR_EPOCHS
            and res["actions_max_abs_change"] > 0
            and all(launches[k] > 0 for k in FUSED + FUSED_BWD
                    + ("collide_mixed", "collide_mixed_bwd"))):
        raise AssertionError(f"demo_door on the card failed: {res}")
    return res


def run_door(env):
    """The door's main path: one rollout of DOOR_STEPS env steps of the
    demo's initial actions with the launches counted from zero (each
    dense-weight transfer and the mixed contact once a substep, no
    ops/transfer.py kernel), its end state against a zero-action rollout
    of the same length, DOOR_REPEATS timed rollouts of DOOR_TIMED_STEPS,
    and the demo's horizon (DOOR_HORIZON) once with its loss frames."""
    import numpy as np
    import torch
    acts = door_actions(DOOR_STEPS)
    reset_launches()
    out, secs = timed_rollout(env, acts)
    launches = read_launches()
    n_sub = DOOR_STEPS * env.substeps
    expect = dict.fromkeys(wrappers(), 0)
    expect.update(dict.fromkeys(FUSED, n_sub))
    expect["collide_mixed"] = n_sub * env.n_primitives
    if launches != expect:
        raise AssertionError(f"door launch counts {launches}, expected "
                             f"{expect}")
    zero = env.rollout(np.zeros((DOOR_STEPS, env.action_dim)))
    rates = []
    timed = door_actions(DOOR_TIMED_STEPS)
    for _ in range(DOOR_REPEATS):
        _, rep_secs = timed_rollout(env, timed)
        rates.append(DOOR_TIMED_STEPS * env.substeps / rep_secs)
    start = (2 * DOOR_HORIZON * env.substeps // 3) // 20 * 20
    t0 = time.perf_counter()
    full = env.rollout(door_actions(DOOR_HORIZON), loss_start_frame=start,
                       loss_stride=20)
    torch.cuda.synchronize()
    full_secs = time.perf_counter() - t0
    (m, _, r), (mc, _, rc) = full["carry"], out["carry"]
    mz, _, rz = zero["carry"]
    res = {"scene": "demo_door", "n_particles": env.n_particles,
           "window": list(env.mpm_cfg.active_window), "actions": "z = 0.1",
           "counted": {"env_steps": DOOR_STEPS, "substeps": n_sub,
                       "substeps_per_s": n_sub / secs,
                       "loss": out["loss"].item(), "launches": launches,
                       "window_overflow": bool(
                           out["terms"]["window_overflow"]),
                       "hinge_angle": rc.q.tolist(),
                       "zero_action_loss": zero["loss"].item(),
                       "zero_action_hinge_angle": rz.q.tolist(),
                       "x_max_abs_diff_vs_zero_action":
                           (mc.x - mz.x).abs().max().item()},
           "timed": {"env_steps": DOOR_TIMED_STEPS, "runs": rates,
                     "substeps_per_s": statistics.median(rates),
                     "substeps_per_s_min": min(rates),
                     "substeps_per_s_max": max(rates)},
           "horizon": {"env_steps": DOOR_HORIZON, "loss_start_frame": start,
                       "loss_stride": 20, "seconds": full_secs,
                       "substeps_per_s": DOOR_HORIZON * env.substeps
                       / full_secs,
                       "loss": full["loss"].item(),
                       "terms": {k: float(v)
                                 for k, v in full["terms"].items()},
                       "hinge_angle": r.q.tolist(),
                       "hinge_rate": r.qd.tolist(),
                       "x_finite": bool(torch.isfinite(m.x).all())}}
    h, c = res["horizon"], res["counted"]
    if (h["terms"]["window_overflow"] or c["window_overflow"]
            or bool(zero["terms"]["window_overflow"])
            or not math.isfinite(h["loss"]) or not h["x_finite"]
            or not all(math.isfinite(v) for v in h["hinge_angle"])
            or not c["x_max_abs_diff_vs_zero_action"] > 0):
        raise AssertionError(f"door output wrong: {res}")
    return res, launches


def run_door_parity():
    """The door's own 5400-particle scene, 20 env steps of the demo's
    initial actions: card (float32, kernels) against the CPU (float64,
    plain versions); x, the hinge's q and qd within 1e-4 absolute, the loss
    within 1e-4 relative. Then rollout_and_grad of 20 env steps with the
    demo's loss frames and grad_clip 1.0, pushing at ten times the demo's
    initial actions (z = 1.0, so that the contact engages within the 20
    steps: the demo's own 0.1 moves the door 9e-5 rad by then): the loss
    within 1e-4, the action gradient within 1e-3 relative L2."""
    steps = 20
    acts = door_actions(steps)
    envs = {"cuda": door_env(), "cpu": door_env("cpu")}
    reset_launches()
    outs = {"cuda": envs["cuda"].rollout(acts)}
    launches = read_launches()
    outs["cpu"] = envs["cpu"].rollout(acts)
    (mg, _, rg), (mc, _, rc) = outs["cuda"]["carry"], outs["cpu"]["carry"]
    lg, lc = outs["cuda"]["loss"].item(), outs["cpu"]["loss"].item()
    res = {"n_particles": mc.x.shape[1], "env_steps": steps,
           "x_max_abs_err": (mg.x.double().cpu() - mc.x).abs().max().item(),
           "q_max_abs_err": (rg.q.double().cpu() - rc.q).abs().max().item(),
           "qd_max_abs_err": (rg.qd.double().cpu() - rc.qd).abs().max().item(),
           "hinge_angle_cpu": rc.q.tolist(), "loss_gpu": lg, "loss_cpu": lc,
           "loss_rel_err": abs(lg - lc) / abs(lc), "tolerance": 1e-4,
           "gpu_launches": {k: launches[k] for k in FUSED}}
    if not all(launches[k] > 0 for k in FUSED):
        raise AssertionError(f"door parity: the card's run missed a kernel "
                             f"{launches}")
    if not (res["x_max_abs_err"] <= 1e-4 and res["q_max_abs_err"] <= 1e-4
            and res["qd_max_abs_err"] <= 1e-4
            and res["loss_rel_err"] <= 1e-4):
        raise AssertionError(f"door GPU/CPU parity failed: {res}")
    acts = 10.0 * door_actions(steps)
    kw = dict(loss_start_frame=door_loss_start(envs["cpu"], steps),
              loss_stride=20, grad_clip=1.0)
    reset_launches()
    grads = {"cuda": envs["cuda"].rollout_and_grad(acts, **kw)}
    launches = read_launches()
    grads["cpu"] = envs["cpu"].rollout_and_grad(acts, **kw)
    gg = grads["cuda"]["action_grad"].double().cpu()
    gc = grads["cpu"]["action_grad"]
    lg, lc = grads["cuda"]["loss"].item(), grads["cpu"]["loss"].item()
    res["grad"] = {"actions": "z = 1.0", **kw, "loss_gpu": lg, "loss_cpu": lc,
                   "loss_rel_err": abs(lg - lc) / abs(lc),
                   "loss_tolerance": 1e-4,
                   "action_grad_rel_l2_err": ((gg - gc).norm().item()
                                              / gc.norm().item()),
                   "action_grad_tolerance": 1e-3,
                   "action_grad_cpu_max_abs": gc.abs().max().item(),
                   "gpu_launches": {k: launches[k] for k in FUSED_BWD}}
    if not all(launches[k] > 0 for k in FUSED + FUSED_BWD):
        raise AssertionError("door gradient parity: the card's run missed a "
                             f"kernel {launches}")
    if not (gc.abs().max().item() > 0
            and res["grad"]["loss_rel_err"] <= 1e-4
            and res["grad"]["action_grad_rel_l2_err"] <= 1e-3):
        raise AssertionError(f"door GPU/CPU gradient parity failed: {res}")
    return res


def full_grid_cfg(collision_type=None):
    """The flagship pour's config with TPU.active_window cleared: the full
    64^3 grid, the dense route (and, with ``collision_type``, another
    contact model)."""
    cfg = pour_cfg()
    cfg.defrost()
    cfg.TPU.active_window = None
    if collision_type is not None:
        cfg.SIMULATOR.collision_type = collision_type
    cfg.freeze()
    return cfg


def kr3_inputs(cfg, x, window):
    """The pair build's inputs (Wy, Wz, WDy, WDz) from the particles x over
    ``window`` (None: the full grid), as the dense route's Transfers builds
    them."""
    import dataclasses
    from softmac_tpu_torch.engine import mpm
    cfg = dataclasses.replace(cfg, active_window=window)
    sizes, corner, overflow = mpm.window_geometry(cfg, x)
    if bool(overflow):
        raise AssertionError(f"kr3 inputs: window {window} overflows")
    W, WD = mpm.axis_weights(cfg, x, sizes, corner)
    return W[1], W[2], WD[1], WD[2]


def kr3_case(ins):
    """The kernel against the float32 plain version (bit for bit) and the
    float64 plain version (max |err| / max |plain| of each output), its
    time, the plain version's, three torch.mul into preallocated outputs
    (the library calls), and the bound: every input float read once, every
    output float written once, one multiply an output float."""
    import torch
    from softmac_tpu_torch.ops import kr
    got = kr.kr3(*ins)
    exact = all(torch.equal(g, p) for g, p in zip(got, kr.kr3_plain(*ins)))
    abs_err, rel_err = 0.0, 0.0
    for g, ref in zip(got, kr.kr3_plain(*(t.double() for t in ins))):
        d = (g.double() - ref).abs().max().item()
        abs_err = max(abs_err, d)
        rel_err = max(rel_err, d / max(ref.abs().max().item(), 1e-300))
    del got, g, ref
    wy, n = ins[0].shape
    wz = ins[1].shape[0]
    Wy, Wz, WDy, WDz = ins
    outs = [torch.empty((wy, wz, n), device=Wy.device) for _ in range(3)]
    pairs = ((Wy, Wz), (WDy, Wz), (Wy, WDz))

    def library():
        for o, (a, b) in zip(outs, pairs):
            torch.mul(a[:, None, :], b[None, :, :], out=o)
    nbytes = (2 * (wy + wz) + 3 * wy * wz) * n * 4
    b_ms, b_by = bound("kr3", n, nbytes, flops=3 * wy * wz * n)
    res = {"n": n, "wy": wy, "wz": wz, "equal_to_float32_plain": exact,
           "max_abs_err": abs_err, "max_rel_err": rel_err,
           "ms": cuda_time_ms(lambda: kr.kr3(*ins)),
           "device_ms": device_ms(f"kr3@{wy}x{wz}x{n}",
                                  lambda: kr.kr3(*ins)),
           "plain_ms": cuda_time_ms(lambda: kr.kr3_plain(*ins)),
           "library_ms": cuda_time_ms(library), "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes}
    del outs
    print(f"kr3 ({wy} x {wz}, N {n}): {res}", flush=True)
    if not (exact and rel_err <= KR3_TOL):
        raise AssertionError(f"kr3 disagrees with its plain version: {res}")
    return res


def check_kr3_kernel(pour_env, carry):
    """Row 19: the Khatri-Rao pair build against its plain versions on the
    1e5-particle pour's state after 10 env steps over the full grid (the
    dense phase's shapes) and over the (40, 32, 16) window, and on seeded
    normal weights (8, 16, N = 300)."""
    import torch
    x = carry[0].x
    cases = {"full_grid": kr3_case(kr3_inputs(pour_env.mpm_cfg, x, None)),
             "window": kr3_case(kr3_inputs(pour_env.mpm_cfg, x, KR_WINDOW))}
    wy, wz, n = KR_RANDOM
    gen = torch.Generator(device=x.device).manual_seed(7)
    cases["random"] = kr3_case(tuple(
        torch.randn((r, n), generator=gen, device=x.device)
        for r in (wy, wz, wy, wz)))
    full = cases["full_grid"]
    e = kernel_entry(full["n"], "kr3", "softmac_tpu_torch/ops/csrc/kr3.cu",
                     "softmac_tpu/ops/pallas_kr.py:56 (_kr3_fwd_pallas, "
                     "pallas_call :73, kernel _kernel :40)",
                     max(c["max_abs_err"] for c in cases.values()),
                     max(c["max_rel_err"] for c in cases.values()),
                     full["ms"], full["plain_ms"], full["bytes"],
                     tolerance=KR3_TOL, flops=3 * full["wy"] * full["wz"]
                     * full["n"])
    e["library_ms"] = full["library_ms"]
    e["device_ms"] = full["device_ms"]
    e["library_is"] = ("three torch.mul (one a pair matrix) into "
                       "preallocated outputs")
    e["rel_err_is"] = ("max |kernel - plain| / max |plain| of each output, "
                       "the plain version in float64, over the three inputs;"
                       " the kernel also equals the float32 plain version "
                       "bit for bit")
    e["by_input"] = {k: {kk: v for kk, v in c.items()
                         if kk not in ("n", "wy", "wz")} | {
                             "shape": [c["wy"], c["wz"], c["n"]]}
                     for k, c in cases.items()}
    return [e]


def dense_grad_expect(env, steps, remat):
    """Launches of rollout_and_grad of the full-grid pour: the pour's
    accounting (``pour_grad_expect``) with the pair build once a substep
    where the pour runs P2G, and no ops/transfer.py kernel, forward or
    backward (the dense route's products are torch.matmul, its pair
    build's backward plain PyTorch)."""
    expect = pour_grad_expect(env, steps, remat)
    expect["kr3"] = expect["p2g"]
    for k in ("p2g", "g2p", "gather", "splat"):
        expect[k] = expect[k + "_bwd"] = 0
    return expect


def run_full_grid(env):
    """The full-grid pour (no window: the dense route) at 1e5 particles:
    one rollout of FULL_STEPS zero-action env steps with the launches
    counted from zero (one kr3 a substep, the mixed contact, nothing of
    ops/transfer.py or ops/fused.py) and peak memory, FULL_REPEATS timed
    repeats; rollout_and_grad of FULL_GRAD_STEPS steps under remat "step"
    (the pair matrices, ~4.9 GB a substep, rule "none" out at 1e5) with
    exact counts and a repeat; then the same rollout and gradient through
    the x-based route (transfer_route swapped within this phase) against
    the dense route's."""
    import numpy as np
    import torch
    from softmac_tpu_torch.engine import mpm
    if mpm.transfer_route(env.mpm_cfg) != "dense":
        raise AssertionError("the full-grid pour does not take the dense "
                             "route")
    acts = np.zeros((FULL_STEPS, env.action_dim))
    n_sub = FULL_STEPS * env.substeps
    q0 = env._initial_carry()[2].q
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out, secs = timed_rollout(env, acts)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    expect = dict.fromkeys(wrappers(), 0)
    expect.update({"kr3": n_sub, "collide_mixed": n_sub * env.n_primitives})
    if launches != expect:
        raise AssertionError(f"full-grid launch counts {launches}, expected "
                             f"{expect}")
    state, _, rigid = out["carry"]
    loss = out["loss"].item()
    rates = []
    for _ in range(FULL_REPEATS):
        rates.append(n_sub / timed_rollout(env, acts)[1])
    res = {"scene": "demo_pour, no window", "n_particles": env.n_particles,
           "grid": [env.mpm_cfg.n_grid] * 3, "env_steps": FULL_STEPS,
           "substeps": n_sub, "actions": "zero",
           "substeps_per_s": statistics.median(rates),
           "substeps_per_s_min": min(rates), "substeps_per_s_max": max(rates),
           "substeps_per_s_runs": rates,
           "counted_run_substeps_per_s": n_sub / secs,
           "max_memory_allocated_bytes": peak, "loss": loss,
           "glass_q_moved": (rigid.q[0:6] - q0[0:6]).abs().max().item(),
           "launches": launches,
           "x_finite": bool(torch.isfinite(state.x).all())}
    if not (math.isfinite(loss) and res["x_finite"]
            and res["glass_q_moved"] > 0
            and not bool(out["terms"]["window_overflow"])):
        raise AssertionError(f"full-grid output wrong: {res}")

    gacts = np.zeros((FULL_GRAD_STEPS, env.action_dim))
    grad, grad_launches = run_gradient(
        "full_grid_grad", env, gacts,
        lambda remat: dense_grad_expect(env, FULL_GRAD_STEPS, remat),
        list(range(6)), None, repeats=1, loss_stride=FULL_LOSS_STRIDE,
        remats=("step",))
    res["grad"] = grad
    dense_g = timed_grad(env, gacts, "step", loss_stride=FULL_LOSS_STRIDE)[0]

    route = mpm.transfer_route
    mpm.transfer_route = lambda cfg: "transfer"
    try:
        reset_launches()
        x_out, x_secs = timed_rollout(env, acts)
        x_grad = timed_grad(env, gacts, "step",
                            loss_stride=FULL_LOSS_STRIDE)[0]
        x_launches = read_launches()
    finally:
        mpm.transfer_route = route
    gd, gx = dense_g["action_grad"], x_grad["action_grad"]
    res["vs_x_based_route"] = {
        "x_max_abs_diff": (x_out["carry"][0].x - state.x).abs().max().item(),
        "q_max_abs_diff": (x_out["carry"][2].q - rigid.q).abs().max().item(),
        "x_tolerance": 1e-4,
        "action_grad_rel_l2_diff": ((gd - gx).norm() / gx.norm()).item(),
        "grad_tolerance": 1e-3, "x_based_launches": x_launches,
        "x_based_substeps_per_s": n_sub / x_secs}
    cmp = res["vs_x_based_route"]
    if not (x_launches["kr3"] == 0 and x_launches["p2g"] > 0
            and cmp["x_max_abs_diff"] <= 1e-4
            and cmp["action_grad_rel_l2_diff"] <= 1e-3):
        raise AssertionError(f"dense and x-based routes differ: {cmp}")
    return res, launches, grad_launches["step"]


def gpu_cpu_parity(cfg_fn, steps, acts, loss_stride, kernels, bwd=(),
                   setup=None):
    """A scene of ``cfg_fn()`` with the demo's own particles on the card
    (float32, kernels) and on the CPU (float64, plain versions), loss
    frames every ``loss_stride`` from 0: rollout (x, the bodies' q and qd
    within 1e-4, the loss within 1e-4 relative)
    and rollout_and_grad under remat "none" (loss within 1e-4, the action
    gradient within 1e-3 relative L2); ``kernels`` must each launch on both
    of the card's runs, ``bwd`` on its gradient run. ``setup(env)``, where
    given, is called on both envs before they run."""
    from softmac_tpu_torch import SoftMacEnv
    envs = {dev: SoftMacEnv(cfg_fn(), device=dev) for dev in ("cuda", "cpu")}
    for env in envs.values():
        if setup is not None:
            setup(env)
    frames = dict(loss_start_frame=0, loss_stride=loss_stride)
    reset_launches()
    outs = {"cuda": envs["cuda"].rollout(acts, **frames)}
    launches = read_launches()
    outs["cpu"] = envs["cpu"].rollout(acts, **frames)
    (mg, _, rg), (mc, _, rc) = outs["cuda"]["carry"], outs["cpu"]["carry"]
    lg, lc = outs["cuda"]["loss"].item(), outs["cpu"]["loss"].item()
    res = {"n_particles": mc.x.shape[1], "env_steps": steps,
           "x_max_abs_err": (mg.x.double().cpu() - mc.x).abs().max().item(),
           "q_max_abs_err": (rg.q.double().cpu() - rc.q).abs().max().item(),
           "qd_max_abs_err": (rg.qd.double().cpu() - rc.qd).abs().max().item(),
           "glass_qd_cpu_max_abs": rc.qd[0:6].abs().max().item(),
           "loss_gpu": lg, "loss_cpu": lc,
           "loss_rel_err": abs(lg - lc) / abs(lc), "tolerance": 1e-4,
           "gpu_launches": launches}
    kw = dict(frames, remat="none")
    reset_launches()
    grads = {"cuda": envs["cuda"].rollout_and_grad(acts, **kw)}
    glaunches = read_launches()
    grads["cpu"] = envs["cpu"].rollout_and_grad(acts, **kw)
    gg = grads["cuda"]["action_grad"].double().cpu()
    gc = grads["cpu"]["action_grad"]
    lg, lc = grads["cuda"]["loss"].item(), grads["cpu"]["loss"].item()
    res["grad"] = {**kw, "loss_gpu": lg, "loss_cpu": lc,
                   "loss_rel_err": abs(lg - lc) / abs(lc),
                   "loss_tolerance": 1e-4,
                   "action_grad_rel_l2_err": ((gg - gc).norm().item()
                                              / gc.norm().item()),
                   "action_grad_tolerance": 1e-3,
                   "action_grad_cpu_max_abs": gc.abs().max().item(),
                   "gpu_launches": glaunches}
    if not (all(launches[k] > 0 for k in kernels)
            and all(glaunches[k] > 0 for k in kernels + bwd)):
        raise AssertionError(f"parity: the card's runs missed a kernel "
                             f"{launches} {glaunches}")
    if not (res["x_max_abs_err"] <= 1e-4 and res["q_max_abs_err"] <= 1e-4
            and res["qd_max_abs_err"] <= 1e-4 and res["loss_rel_err"] <= 1e-4
            and gc.abs().max().item() > 0
            and res["grad"]["loss_rel_err"] <= 1e-4
            and res["grad"]["action_grad_rel_l2_err"] <= 1e-3):
        raise AssertionError(f"GPU/CPU parity failed: {res}")
    return res


def run_full_grid_parity():
    """The flagship pour's own 5000 particles on the full grid (the dense
    route), FULL_PARITY_STEPS env steps of seeded actions, card against
    CPU."""
    import numpy as np
    acts = np.random.RandomState(2).randn(FULL_PARITY_STEPS, 12) * 0.05
    return gpu_cpu_parity(full_grid_cfg, FULL_PARITY_STEPS, acts,
                          FULL_LOSS_STRIDE, ("kr3", "collide_mixed"),
                          ("collide_mixed_bwd",))


def run_grid_contact():
    """The same 5000-particle scene under grid contact
    (SIMULATOR.collision_type 0, the full grid): GRID_STEPS env steps of
    zero actions on the card, counted (one kr3 a substep, no contact
    kernel: grid contact is plain PyTorch), the glass's wrench in the first
    env step nonzero (it holds the liquid from the start), the glass moved;
    then card against CPU over FULL_PARITY_STEPS steps of seeded
    actions."""
    import numpy as np
    import torch
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.engine.types import CONTACT_GRID
    env = SoftMacEnv(full_grid_cfg(CONTACT_GRID))
    mpm0, bodies0, rigid0 = env._initial_carry()
    with torch.no_grad():
        ext_f = env._substeps(mpm0, bodies0, env.mpm_params)[2]
    acts = np.zeros((GRID_STEPS, env.action_dim))
    n_sub = GRID_STEPS * env.substeps
    reset_launches()
    out, secs = timed_rollout(env, acts)
    launches = read_launches()
    expect = dict.fromkeys(wrappers(), 0)
    expect["kr3"] = n_sub
    rigid = out["carry"][2]
    res = {"scene": "demo_pour, collision_type 0, no window",
           "n_particles": env.n_particles, "env_steps": GRID_STEPS,
           "substeps_per_s": n_sub / secs, "launches": launches,
           "glass_wrench_first_step": ext_f[0].tolist(),
           "bowl_wrench_first_step": ext_f[1].tolist(),
           "glass_q_moved": (rigid.q[0:6] - rigid0.q[0:6]).abs().max().item(),
           "loss": out["loss"].item()}
    if launches != expect:
        raise AssertionError(f"grid contact launch counts {launches}, "
                             f"expected {expect}")
    if not (bool((ext_f[0] != 0).any()) and res["glass_q_moved"] > 0
            and math.isfinite(res["loss"])
            and bool(torch.isfinite(out["carry"][0].x).all())):
        raise AssertionError(f"grid contact output wrong: {res}")
    acts = np.random.RandomState(2).randn(FULL_PARITY_STEPS, 12) * 0.05
    res["parity"] = gpu_cpu_parity(lambda: full_grid_cfg(CONTACT_GRID),
                                   FULL_PARITY_STEPS, acts, FULL_LOSS_STRIDE,
                                   ("kr3",))
    return res


def svd_launches(env, carry):
    """Device kernels one svd3_soa of the door's F launches (once per
    substep), counted with torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from softmac_tpu_torch.engine.svd3 import svd3_soa
    from softmac_tpu_torch.ops import m33
    F = m33.from_mat_array(carry[0].F)
    svd3_soa(F)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svd3_soa(F)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


# ---------------------------------------------------------------------------
# the grip: a corotated-plastic block, two prismatic fingers below a fixed
# palm, forecast mixed contact, five substeps an env step, window (32, 24, 32)
# ---------------------------------------------------------------------------
def grip_cfg(init_state=None):
    from softmac_tpu_torch import load
    cfg = load(str(ROOT / "softmac_tpu_torch/config/demo_grip_config.py"))
    if init_state is not None:
        cfg.defrost()
        cfg.RIGID.init_state = tuple(init_state)
        cfg.freeze()
    return cfg


def grip_env(device=None, init_state=GRIP_NEAR):
    """The grip scene at its 10 000 particles, the fingers started at
    ``init_state``, the palm's contact off (demos/demo_grip.py)."""
    from softmac_tpu_torch import SoftMacEnv
    env = SoftMacEnv(grip_cfg(init_state), device=device)
    env.set_primitives_contact([False, True, True])
    return env


def grip_actions(n_steps, force=GRIP_FORCE):
    """The demo's initial actions: ``force`` N inward on each finger."""
    import numpy as np
    return np.tile([force, -force], (n_steps, 1))


class Spills:
    """Within it, every y-slab kernel call's count of particles that fell
    off their tile's slab rows (the one-element tensor ``transfer._slab``
    returns: P2G, the splat, the G2P and gather backwards) is kept;
    ``counts()`` sums them after a synchronize. One Spills may be entered
    more than once; it keeps every call."""

    def __init__(self):
        self.kept = {}

    def __enter__(self):
        from softmac_tpu_torch.ops import transfer
        self.transfer, self.slab = transfer, transfer._slab

        def kept(name, *args, **kw):
            out = self.slab(name, *args, **kw)
            self.kept.setdefault(name, []).append(out[2])
            return out
        transfer._slab = kept
        return self

    def __exit__(self, *exc):
        self.transfer._slab = self.slab

    def counts(self):
        import torch
        torch.cuda.synchronize()
        return {name: {"calls": len(k),
                       "spilled": int(torch.cat(k).sum().item())}
                for name, k in self.kept.items()}


def run_grip(env):
    """The grip's main path: SoftMacEnv.rollout of GRIP_STEPS env steps of
    the demo's initial forces, launches counted from zero, the slab
    kernels' spills and the read-side kernels' off-slab particles summed,
    each env step's wrench kept; a timed rollout of its first
    GRIP_TIMED_STEPS env steps (wall ms a substep) and a profile of
    GRIP_PROFILE_STEPS (device ms a substep, busy share). The
    fingers move inward, the palm's wrench is zero, each finger's is
    nonzero once in contact, no overflow."""
    import torch
    acts = grip_actions(GRIP_STEPS)
    q0 = env._initial_carry()[2].q.clone()
    wrenches = []
    rigid_step = env._rigid_step

    def keep(bodies, rigid, action, ext_f):
        wrenches.append(ext_f)
        return rigid_step(bodies, rigid, action, ext_f)
    env._rigid_step = keep
    try:
        reset_launches()
        with OffSlab() as off, Spills() as spills:
            out, secs = timed_rollout(env, acts)
        launches = read_launches()
    finally:
        del env._rigid_step
    n_sub = GRIP_STEPS * env.substeps
    expect = dict.fromkeys(wrappers(), 0)
    expect.update({"p2g": n_sub, "g2p": n_sub, "gather": n_sub,
                   "splat": n_sub, "collide_mixed": 2 * n_sub})
    if launches != expect:
        raise AssertionError(f"grip launch counts {launches}, expected "
                             f"{expect}")
    wr = torch.stack(wrenches).double().cpu()          # (steps, 3, 6)
    touching = [torch.nonzero(wr[:, b].abs().amax(dim=1) > 0).flatten()
                for b in (1, 2)]
    state, _, rigid = out["carry"]
    loss = out["loss"].item()
    _, secs_timed = timed_rollout(env, acts[:GRIP_TIMED_STEPS])
    prof = run_profile(env, acts[:GRIP_PROFILE_STEPS])
    res = {"profile": prof, "scene": "demo_grip",
           "n_particles": env.n_particles,
           "window": list(env.mpm_cfg.active_window),
           "substeps_per_env_step": env.substeps, "env_steps": GRIP_STEPS,
           "substeps": n_sub, "init_state": list(GRIP_NEAR),
           "finger_force": GRIP_FORCE,
           "wall_ms_per_substep": secs_timed * 1e3 / (
               GRIP_TIMED_STEPS * env.substeps),
           "timed_env_steps": GRIP_TIMED_STEPS,
           "counted_run_wall_ms_per_substep": secs * 1e3 / n_sub,
           "device_busy_ms_per_substep": prof["device_busy_ms_per_substep"],
           "device_busy_share": prof["device_busy_share"],
           "kernel_launches_per_substep": prof["kernel_launches_per_substep"],
           "profile_env_steps": GRIP_PROFILE_STEPS,
           "launches": launches,
           "launches_per_substep": {k: v / n_sub for k, v in launches.items()
                                    if v},
           "spilled": spills.counts(), "off_slab": off.counts(),
           "loss": loss,
           "terms": {k: float(v) for k, v in out["terms"].items()},
           "q0": q0.tolist(), "rigid_q": rigid.q.tolist(),
           "rigid_qd": rigid.qd.tolist(),
           "palm_wrench_max_abs": wr[:, 0].abs().max().item(),
           "finger_force_max_abs": [wr[:, b, :3].abs().max().item()
                                    for b in (1, 2)],
           "first_contact_env_step": [int(t[0]) if len(t) else None
                                      for t in touching],
           "contact_env_steps": [len(t) for t in touching],
           "last_wrench": wr[-1].tolist(),
           "x_finite": bool(torch.isfinite(state.x).all())}
    print(f"grip: spilled {res['spilled']}, off the slab {res['off_slab']}",
          flush=True)
    spilled = sum(v["spilled"] for v in res["spilled"].values())
    res["spilled_total"] = spilled
    res["off_slab_total"] = sum(v["off_slab"]
                                for v in res["off_slab"].values())
    if (res["terms"]["window_overflow"] or not math.isfinite(loss)
            or not res["x_finite"]
            or not (rigid.q[0] > q0[0] and rigid.q[1] < q0[1])
            or res["palm_wrench_max_abs"] != 0.0
            or not all(len(t) for t in touching)
            or not bool((wr[-1, 1:, :3].abs().amax(dim=1) > 0).all())):
        raise AssertionError(f"grip output wrong: {res}")
    return res, launches, out["carry"]


def grip_grad_expect(env, steps, remat):
    """Launches of every kernel in the grip's rollout_and_grad over
    ``steps`` env steps of five substeps, two fingers in contact. The first
    env step records nothing for autograd (the fingers take the first
    action at its end). In the second, the fingers carry a gradient from
    its first substep on, the particles from its second: that substep's
    P2G and gather see no input that requires one. Under remat "step"
    every env step is replayed once in the backward, the first too (its
    rigid step takes the first action)."""
    sub = env.substeps
    n_sub = steps * sub
    replays = n_sub if remat == "step" else 0
    graded = (steps - 1) * sub
    expect = dict.fromkeys(wrappers(), 0)
    for k in ("p2g", "g2p", "gather", "splat"):
        expect[k] = n_sub + replays
    expect["collide_mixed"] = 2 * (n_sub + replays)
    expect.update({"p2g_bwd": graded - 1, "gather_bwd": graded - 1,
                   "g2p_bwd": graded, "splat_bwd": graded,
                   "collide_mixed_bwd": 2 * graded})
    return expect


def grip_loss_start(env, steps):
    """The demo's first loss frame: three quarters of the horizon's
    substeps, rounded down to the stride of 20."""
    return (3 * steps * env.substeps // 4) // 20 * 20


def run_grip_grad(env):
    """The grip's gradient path: rollout_and_grad of GRIP_GRAD_STEPS env
    steps of the demo's forces with its loss frames, under remat "step"
    and "none": one counted call and GRIP_GRAD_REPEATS timed ones each,
    exact launch counts (grip_grad_expect), finite, the fingers' columns
    nonzero, step against none and the repeats within GRAD_TOL; the slab
    kernels' spills and the read-side off-slab particles summed over the
    counted calls."""
    spills, off = Spills(), OffSlab()

    class Both:
        def __enter__(self):
            off.__enter__()
            spills.__enter__()

        def __exit__(self, *exc):
            spills.__exit__(*exc)
            off.__exit__(*exc)
    start = grip_loss_start(env, GRIP_GRAD_STEPS)
    out, launches = run_gradient(
        "grip_grad", env, grip_actions(GRIP_GRAD_STEPS),
        lambda remat: grip_grad_expect(env, GRIP_GRAD_STEPS, remat), [0, 1],
        env.mpm_cfg.active_window, repeats=GRIP_GRAD_REPEATS,
        loss_start_frame=start, counted=Both())
    out["spilled"] = spills.counts()
    out["off_slab"] = off.counts()
    print(f"grip_grad: spilled {out['spilled']}, off the slab "
          f"{out['off_slab']}", flush=True)
    return {"scene": "demo_grip", "init_state": list(GRIP_NEAR), **out}, \
        launches


def grip_kernel_inputs(env, carry):
    """The inputs the grip's first substep from ``carry`` hands each kernel
    of its path, built with the port's own substep stages and the kernels
    (y-sorted, as the rollout keeps them): P2G's channels, the bounded grid
    velocity the gather reads, the fingers' contact inputs (life 1/5, the
    first substep's), the splat's values and the grid velocity G2P
    reads."""
    import torch
    from softmac_tpu_torch.engine import mpm
    from softmac_tpu_torch.ops import contact, m33, transfer
    cfg = env.mpm_cfg
    state, bodies, _ = carry
    q, _ = mpm.sort_perm(cfg, state.x)
    state = mpm.permute_state(state, q)
    params = mpm.permute_params(env.mpm_params, q)
    stress, _ = mpm.stress_and_F(cfg, params, state)
    sizes, corner, overflow = mpm.window_geometry(cfg, state.x)
    if bool(overflow) or mpm.transfer_route(cfg) != "transfer":
        raise AssertionError("grip kernel-check state: overflow or route")
    zero = torch.zeros_like(state.x[0])
    chan = mpm._p2g_channels(cfg, tuple(state.v), m33.from_mat_array(state.C),
                             stress, (zero, zero, zero))
    gm, gmom = transfer.p2g(state.x, chan, corner, sizes, cfg.inv_dx)
    gvm, mask = mpm._bounded_velocity(cfg, params, gm, gmom, sizes, corner)
    gvm = tuple(g.contiguous() for g in gvm)
    v_tmp = transfer.gather(state.x, *gvm, corner, sizes, cfg.inv_dx)
    life = torch.full((), 1.0 / cfg.substeps, dtype=state.x.dtype,
                      device=state.x.device)
    contacts, v_in = [], v_tmp
    for i, prim in enumerate(env.prims):
        if not cfg.primitives_contact[i]:
            continue
        body = (bodies.pos[i], bodies.quat[i], bodies.v[i], bodies.w[i],
                params.friction[i], params.softness[i], life)
        contacts.append((prim, body, v_in))
        v_in = contact.collide_mixed(
            prim, *body, state.x, v_in, cfg.dt, cfg.p_mass,
            cfg.contact_push_velocity_cap)[0]
    vals = (-2.0 * (v_tmp - v_in)).contiguous()
    corr = transfer.splat(state.x, vals, corner, sizes, cfg.inv_dx)
    wx = sizes[0]
    gv = tuple(torch.where(mask, gvm[d] + corr[:, d * wx:(d + 1) * wx],
                           0.0).contiguous() for d in range(3))
    return dict(cfg=cfg, state=state, corner=corner, sizes=sizes, chan=chan,
                gvm=gvm, gv=gv, contacts=contacts, vals=vals)


def check_mixed_lives(tag, inp, lives, body_tol, every_body=True, seed=5):
    """The tiled mixed pair at each remaining-window factor of ``lives``,
    per body of ``inp``'s contacts, on its main-path particles and on as
    many spread over the body's SDF box with seeded velocities (their
    forecast points penetrate: life scales the push-out there alone):
    p_v_out within ROW_TOL of its largest |value| (away from the
    threshold) and the wrench within ``body_tol`` of its force's and
    torque's, against collide_mixed_wrench_plain in float64; the backward
    (seeded normal cotangents of p_v_out and the wrench) against
    collide_mixed_wrench_vjp_plain in float64: dx, dv within ROW_TOL, the
    16 body floats (life's cotangent among them) within ``body_tol`` of
    their group's largest |value|. On the main path each body's band
    (``every_body``; else one body's) must hold particles and its wrench
    must not be zero; in each SDF box some forecast points penetrate and
    life's cotangent is not zero. Returns the worst relative errors by
    life, and the counts."""
    import torch
    from softmac_tpu_torch.ops import contact
    cfg, x = inp["cfg"], inp["state"].x
    n = x.shape[1]
    dt, p_mass = cfg.dt, cfg.p_mass
    cap = cfg.contact_push_velocity_cap
    gen = torch.Generator(device=x.device).manual_seed(seed)
    groups = {"dx": 7, "dv": 8, "body_pos": 0, "body_quat": 1, "body_v": 2,
              "body_w": 3, "friction": 4, "softness": 5, "life": 6}
    sets = []
    for b, (prim, body, v_in) in enumerate(inp["contacts"]):
        x_box = box_particles(prim, body[0], body[1], n, gen)
        v_box = (1.5 * torch.randn((3, n), generator=gen, dtype=x.dtype,
                                   device=x.device)).contiguous()
        sets += [(b, prim, body, x, v_in, "main path"),
                 (b, prim, body, x_box, v_box, "SDF box")]
    by_life, counts = {}, {}
    for life in lives:
        worst = dict.fromkeys(("p_v_out", "wrench", *groups), 0.0)
        touching = {}
        for b, prim, body, xs, vs, label in sets:
            body = body[:6] + (torch.full((), life, dtype=x.dtype,
                                          device=x.device),)
            prim64, body64 = _prim64(prim), tuple(map(_f64, body))
            cargs = (prim, *body, xs, vs, dt, p_mass, cap)
            cargs64 = (prim64, *body64, _f64(xs), _f64(vs), dt, p_mass, cap)
            pv, wr = contact.collide_mixed(*cargs)
            want = contact.collide_mixed_wrench_plain(*cargs64)
            st1 = contact.collide_mixed1_plain(*cargs64[:10], dt)
            keep = (st1[6] - contact.CONTACT_THRESHOLD).abs() >= 1e-6
            err = ((pv.double() - want[0]).abs() * keep).max().item()
            worst["p_v_out"] = max(worst["p_v_out"], err / max(
                want[0].abs().max().item(), 1e-30))
            worst["wrench"] = max(worst["wrench"], _wrench_rel(wr, want[1]))
            wrench = want[1].abs().max().item()
            gout = torch.randn((3, n), generator=gen, dtype=x.dtype,
                               device=x.device)
            gwr = torch.randn((6,), generator=gen, dtype=x.dtype,
                              device=x.device)
            got = contact.collide_mixed_bwd(*cargs, gout, gwr)
            want = contact.collide_mixed_wrench_vjp_plain(
                *cargs64, gout.double(), gwr.double())
            for name, i in groups.items():
                (_, rel), = _errors((got[i],), (want[i],), (name,)).values()
                worst[name] = max(worst[name], rel)
            mask = st1[6] <= contact.CONTACT_THRESHOLD
            sdf2, _ = contact.sample_sdf_normal_world(
                prim64, tuple(body64[0]), tuple(body64[1]), tuple(st1[3:6]))
            band, _ = band_counts(prim64, body64, xs, contact.MIXED_TILE)
            c = {"band": band, "penetrating": int((mask & (sdf2 < 0)).sum()),
                 "wrench_max_abs": wrench,
                 "life_cotangent": abs(want[6].item())}
            counts[f"life {life:.4g} body {b} {label}"] = c
            if label == "main path":
                touching[b] = band > 0 and wrench > 0
            elif not (c["penetrating"] > 0 and c["life_cotangent"] > 0):
                raise AssertionError(f"{tag}: body {b}'s SDF box at life "
                                     f"{life}: {c}")
        if not (all if every_body else any)(touching.values()):
            raise AssertionError(f"{tag}: no contact (band and wrench) at "
                                 f"life {life}: {counts}")
        by_life[f"{life:.6g}"] = worst
        print(f"{tag} life {life:.4g}: {json.dumps(worst)}", flush=True)
    tol = {k: ROW_TOL if k in ("p_v_out", "dx", "dv") else body_tol
           for k in by_life[f"{lives[0]:.6g}"]}
    for life, worst in by_life.items():
        for k, rel in worst.items():
            if not rel <= tol[k]:
                raise AssertionError(f"{tag}: {k} relative error {rel} > "
                                     f"{tol[k]} at life {life}")
    return {"lives": list(lives), "rel_err_by_life": by_life,
            "tolerance_by_output": tol, "counts": counts}


def check_transfer_rows(tag, inp):
    """Rows 1-8 on a main path's state (``inp`` of grip_kernel_inputs or
    hit_kernel_inputs): each kernel against its plain version (a backward:
    its plain vjp, seeded normal cotangents; the splat's backward on the
    real values) in float64 on the same inputs within ROW_TOL of each
    output row's largest |value|, device ms beside the bound for this
    state. Returns ({name: reading}, the splat's nonzero values, the
    seeded normal draw)."""
    import torch
    from softmac_tpu_torch.ops import transfer
    cfg, x = inp["cfg"], inp["state"].x
    n = x.shape[1]
    corner, sizes = inp["corner"], inp["sizes"]
    wx, wy, wz = sizes
    cells = wx * wy * wz
    gen = torch.Generator(device=x.device).manual_seed(7)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=x.dtype,
                           device=x.device)
    band = int((inp["vals"] != 0).any(dim=0).sum())
    w = (x, corner, sizes, cfg.inv_dx)
    rows = {
        # name: (kernel, plain, args, bytes, flops)
        "p2g": (transfer.p2g, transfer.p2g_plain,
                (x, inp["chan"]) + w[1:], (16 * n + 4 * cells) * 4, None),
        "g2p": (transfer.g2p, transfer.g2p_plain,
                (x, *inp["gv"]) + w[1:], (15 * n + 3 * cells) * 4, None),
        "gather": (transfer.gather, transfer.gather_plain,
                   (x, *inp["gvm"]) + w[1:], (6 * n + 3 * cells) * 4, None),
        "splat": (transfer.splat, transfer.splat_plain,
                  (x, inp["vals"]) + w[1:], (6 * n + 3 * cells) * 4, None),
        "p2g_bwd": (transfer.p2g_bwd, transfer.p2g_vjp_plain,
                    (x, inp["chan"]) + w[1:] + (normal(wy * wz, wx),
                                                normal(wy * wz, 3 * wx)),
                    (32 * n + 4 * cells) * 4, None),
        "g2p_bwd": (transfer.g2p_bwd, transfer.g2p_vjp_plain,
                    (x, *inp["gv"]) + w[1:] + (normal(12, n),),
                    (18 * n + 6 * cells) * 4, None),
        "gather_bwd": (transfer.gather_bwd, transfer.gather_vjp_plain,
                       (x, *inp["gvm"]) + w[1:] + (normal(3, n),),
                       (9 * n + 6 * cells) * 4, None),
        "splat_bwd": (transfer.splat_bwd, transfer.splat_vjp_plain,
                      (x, inp["vals"]) + w[1:] + (normal(wy * wz, 3 * wx),),
                      (12 * n + 3 * cells) * 4,
                      band * FLOPS_PER_PARTICLE["splat_bwd"]
                      + (n - band) * FLOPS_PER_PARTICLE["gather"])}
    res = {}
    for name, (fn, plain, args, nbytes, flops) in rows.items():
        got = _as_tuple(fn(*args))
        want = _as_tuple(plain(*map(_f64, args)))
        if name in ("g2p", "gather"):
            rel = _row_rel(got[0], want[0])[1]      # each particle row
        elif name == "splat":
            rel = _row_rel(*(o.reshape(wy * wz, 3, wx).transpose(0, 1)
                             .reshape(3, -1) for o in (got[0], want[0])))[1]
        else:                                       # each output
            rel = max(e[1] for e in _errors(got, want, range(len(got)))
                      .values())
        dev = device_ms(f"{tag} {name}", lambda: fn(*args))
        b_ms, b_by = bound(name, n, nbytes, flops)
        res[name] = {"max_rel_err": rel, "tolerance": ROW_TOL,
                     "device_ms": dev, "device_ms_by": (
                         "cuda events" if f"{tag} {name}" in EVENT_TIMED
                         else "profiler"),
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        print(f"{tag}_kernels {name}: rel err {rel}, device ms {dev}, bound "
              f"ms {b_ms}", flush=True)
        if not rel <= ROW_TOL:
            raise AssertionError(f"{tag} {name}: relative error {rel} > "
                                 f"{ROW_TOL}")
    return res, band, normal


def check_grip_kernels(env, carry):
    """Rows 1-8 and 11-12 of the port's table on the grip's state in
    contact (``carry``): rows 1-8 by check_transfer_rows; the mixed pair's
    device ms beside its bound, and the pair at each of GRIP_LIVES
    (check_mixed_lives, body floats within GRIP_BODY_TOL)."""
    import torch
    from softmac_tpu_torch.ops import contact, m33
    inp = grip_kernel_inputs(env, carry)
    cfg, x = inp["cfg"], inp["state"].x
    n = x.shape[1]
    res, band, normal = check_transfer_rows("grip", inp)
    # the mixed pair: device ms (both fingers, as a substep runs them) and
    # its bound at the first substep's life
    dt, p_mass = cfg.dt, cfg.p_mass
    cap = cfg.contact_push_velocity_cap
    cts = [(normal(3, n), normal(6)) for _ in inp["contacts"]]
    nbytes = {"collide_mixed": 0, "collide_mixed_bwd": 0}
    flops = {"collide_mixed": 0, "collide_mixed_bwd": 0}
    for prim, body, v_in in inp["contacts"]:
        qinv = m33.qnorm(m33.qconj(tuple(body[1])))
        p_loc = m33.qrot(qinv, m33.vsub(tuple(x), tuple(body[0])))
        tab = torch.unique(contact.cell_index(prim, p_loc)[0]).numel()
        b, _ = band_counts(_prim64(prim), tuple(map(_f64, body)), x,
                           contact.MIXED_TILE)
        nbytes["collide_mixed"] += 9 * n * 4 + tab * 128 + 16 * 4 + 6 * 4
        nbytes["collide_mixed_bwd"] += (15 * n * 4 + tab * 128 + 16 * 4
                                        + 6 * 4 + 16 * 4)
        for k in flops:
            flops[k] += n * MIXED_CLASSIFY_FLOPS + b * FLOPS_PER_PARTICLE[k]

    def mixed():
        for prim, body, v_in in inp["contacts"]:
            contact.collide_mixed(prim, *body, x, v_in, dt, p_mass, cap)

    def mixed_bwd():
        for (prim, body, v_in), (go, gw) in zip(inp["contacts"], cts):
            contact.collide_mixed_bwd(prim, *body, x, v_in, dt, p_mass, cap,
                                      go, gw)
    lives = check_mixed_lives("grip_kernels collide_mixed", inp, GRIP_LIVES,
                              GRIP_BODY_TOL)
    for name, fn in (("collide_mixed", mixed),
                     ("collide_mixed_bwd", mixed_bwd)):
        dev = device_ms("grip " + name, fn)
        b_ms, b_by = bound(name, n, nbytes[name], flops[name])
        res[name] = {"device_ms": dev, "bound_ms": b_ms, "bound_by": b_by,
                     "bytes": nbytes[name], "per_call": "both fingers",
                     **lives}
        print(f"grip_kernels {name}: device ms {dev}, bound ms {b_ms}",
              flush=True)
    return {"n_particles": n, "window": list(inp["sizes"]),
            "splat_nonzero_vals": band, "kernels": res}


def run_grip_parity():
    """The grip at its 10 000 particles, the fingers started in contact,
    GRIP_PARITY_STEPS env steps of the demo's forces, card (float32,
    kernels) against the CPU (float64, plain versions): x, q and qd within
    1e-4, the loss within 1e-4 relative, the action gradient within 1e-3
    relative L2 (gpu_cpu_parity); the loss frames every 10 substeps."""
    res = gpu_cpu_parity(
        lambda: grip_cfg(GRIP_NEAR), GRIP_PARITY_STEPS,
        grip_actions(GRIP_PARITY_STEPS), 10, POUR + ("p2g", "g2p"),
        POUR_BWD + ("p2g_bwd", "g2p_bwd"),
        setup=lambda env: env.set_primitives_contact([False, True, True]))
    return {"scene": "demo_grip", "init_state": list(GRIP_NEAR), **res}


def checkpoint_values(path):
    """A trainer checkpoint's numbers, flat: the actions of an .npy, every
    tensor of a state_dict's .pt in order."""
    import numpy as np
    import torch
    if path.suffix == ".npy":
        return np.load(path)
    return np.concatenate([t.detach().cpu().numpy().ravel()
                           for t in torch.load(path).values()])


def run_demo_trainer(module, name, steps, kernels, epochs=DEMO_EPOCHS,
                     extra=(), ckpt="actions"):
    """A ported trainer on the card, ``epochs`` epochs of ``steps`` env
    steps on its own scene (``extra``: more arguments), logs in a temporary
    directory: every epoch's loss finite, losses.npy and a checkpoint per
    epoch written, each of ``kernels`` launched; how far the last
    checkpoint moved from the first (``ckpt``: the checkpoints' stem,
    "actions" for actions_<epoch>.npy, "policy" for the policy trainer's
    policy_<epoch>.pt; that trainer has no --log-root, as the JAX
    package's demo_policy has none, and runs in the temporary directory)."""
    import tempfile
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--steps", str(steps), "--epochs", str(epochs),
                "--render-interval", "0", *extra]
        here = contextlib.nullcontext()
        if ckpt == "policy":
            here = contextlib.chdir(tmp)
        else:
            argv += ["--log-root", tmp]
        reset_launches()
        t0 = time.perf_counter()
        with here:
            out = module.main(argv)
        secs = time.perf_counter() - t0
        launches = read_launches()
        log = Path(tmp) / ("logs" if ckpt == "policy" else "") / name
        files = sorted((log / "ckpt").glob(f"{ckpt}_*"))
        ckpts = [p.name for p in files]
        saved = np.load(log / "losses.npy").tolist()
        first = checkpoint_values(log / "ckpt" / f"{ckpt}_0{files[0].suffix}")
        last = checkpoint_values(
            log / "ckpt" / f"{ckpt}_{epochs - 1}{files[0].suffix}")
    res = {"epochs": epochs, "env_steps": steps,
           "losses": out["losses"], "epoch_seconds": out["epoch_seconds"],
           "seconds_with_setup": secs, "checkpoints": ckpts,
           f"{ckpt}_max_abs_change": float(np.abs(last - first).max()),
           "launches": launches}
    if "moved" in out:
        res["moved"] = out["moved"]
    if not (all(math.isfinite(v) for v in out["losses"])
            and saved == out["losses"] and len(ckpts) == epochs
            and all(launches[k] > 0 for k in kernels)):
        raise AssertionError(f"{name} trainer on the card failed: {res}")
    return res


def run_demo_grip():
    from softmac_tpu_torch.demos import demo_grip
    return run_demo_trainer(demo_grip, "grip", DEMO_GRIP_STEPS,
                            POUR + POUR_BWD + ("p2g", "g2p", "p2g_bwd",
                                               "g2p_bwd"))


def run_demo_pour_vel():
    from softmac_tpu_torch.demos import demo_pour_vel
    return run_demo_trainer(demo_pour_vel, "pour_vel", DEMO_GRIP_STEPS,
                            FORWARD + tuple(k + "_bwd" for k in FORWARD))


# ---------------------------------------------------------------------------
# the closed-loop policy on pour_vel: at every env step the MLP maps the
# observation (200 subsampled particles' x and v, the two bodies' state) to
# the 12-dim velocity command; the particles sorted by y-cell and re-keyed
# every env step; each env step checkpointed; rows 1-4, 9 and 10
# ---------------------------------------------------------------------------
def closed_loop_grad(loss_fn, params):
    """One closed-loop loss and its gradient with respect to ``params``,
    timed on the host's clock after a synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, aux = loss_fn()
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    return loss.detach(), aux, grads, time.perf_counter() - t0


def run_policy_grad(env):
    """The closed loop's gradient on the slice's 1e5-particle pour_vel:
    the demo's MLP from seed 0, VEL_STEPS env steps, launches counted
    (exact: vel_grad_expect's "step"), a finite loss, finite gradients of
    nonzero sum |g|, no overflow, a repeat bit-identical, fwd+bwd
    substeps/s and peak memory; then a profile of POLICY_PROFILE_STEPS env
    steps (launches and device ms a substep, busy share). Returns (result,
    launches, the policy)."""
    import torch
    from softmac_tpu_torch.demos import demo_policy
    from softmac_tpu_torch.engine.policy import make_closed_loop_rollout
    policy = demo_policy.make_policy(env, POLICY_HIDDEN, 1.0,
                                     POLICY_OBSERVED)
    params = list(policy.parameters())
    loss_fn, _ = make_closed_loop_rollout(env, policy, VEL_STEPS,
                                          POLICY_OBSERVED)
    n_sub = VEL_STEPS * env.substeps
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    loss, aux, grads, secs = closed_loop_grad(loss_fn, params)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    rep_loss, _, again, rep_secs = closed_loop_grad(loss_fn, params)
    short_fn, _ = make_closed_loop_rollout(env, policy, POLICY_PROFILE_STEPS,
                                           POLICY_OBSERVED)
    profile = profile_call(
        lambda: torch.autograd.grad(short_fn()[0], params),
        POLICY_PROFILE_STEPS * env.substeps)
    expect = vel_grad_expect(env, VEL_STEPS, "step")
    res = {"n_particles": env.n_particles, "window": list(WINDOW),
           "env_steps": VEL_STEPS, "substeps": n_sub,
           "hidden": list(POLICY_HIDDEN), "n_observed": POLICY_OBSERVED,
           "parameters": sum(p.numel() for p in params),
           "loss": loss.item(),
           "window_overflow": bool(aux["window_overflow"]),
           "grad_abs_sum": sum(g.abs().sum().item() for g in grads),
           "grads_finite": all(bool(torch.isfinite(g).all())
                               for g in grads),
           "repeat_bit_identical": bool(torch.equal(rep_loss, loss)) and all(
               torch.equal(a, b) for a, b in zip(grads, again)),
           "fwd_bwd_substeps_per_s": n_sub / rep_secs,
           "counted_run_substeps_per_s": n_sub / secs,
           "max_memory_allocated_bytes": peak,
           "launches": launches, "profile_env_steps": POLICY_PROFILE_STEPS,
           "profile": profile}
    if launches != expect:
        raise AssertionError(f"policy_grad: launch counts {launches}, "
                             f"expected {expect}")
    if not (math.isfinite(res["loss"]) and res["grads_finite"]
            and res["grad_abs_sum"] > 0) or res["window_overflow"] \
            or not res["repeat_bit_identical"]:
        raise AssertionError(f"policy_grad failed: {res}")
    return res, launches, policy


def run_policy_deploy(policy):
    """The same weights on the demo's own 5000-particle scene: VEL_STEPS env
    steps closed loop through the facade (reset, get_observation, step;
    launches exact) against the closed-loop forward's exit x within
    DEPLOY_TOL of its largest |x|; a get_state / step / set_state round
    trip exact; backward() of the recorded actions finite."""
    import numpy as np
    import torch
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.engine.policy import make_closed_loop_rollout
    env = SoftMacEnv(pour_vel_cfg())
    loss_fn, _ = make_closed_loop_rollout(env, policy, VEL_STEPS,
                                          POLICY_OBSERVED)
    with torch.no_grad():
        _, aux = loss_fn()
    x_loop = aux["carry"][0].x.T.cpu().numpy()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env.reset()
    for _ in range(VEL_STEPS):
        obs = torch.as_tensor(env.get_observation(), device=env.device)
        with torch.no_grad():
            env.step(policy(obs))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    x_facade = env.get_x()
    diff = float(np.abs(x_facade - x_loop).max())
    scale = float(np.abs(x_loop).max())
    state = env.get_state()
    env.step()
    moved = float(np.abs(env.get_state() - state).max())
    env.set_state(state)
    round_trip = bool(np.array_equal(env.get_state(), state))
    g = env.backward()
    expect = dict.fromkeys(wrappers(), 0)
    n_sub = VEL_STEPS * env.substeps
    expect.update({"p2g": n_sub, "g2p": n_sub,
                   "collide_particle": n_sub * env.n_primitives})
    res = {"n_particles": env.n_particles, "env_steps": VEL_STEPS,
           "facade_vs_closed_loop_x_max_abs_diff": diff,
           "facade_vs_closed_loop_x_rel_diff": diff / scale,
           "tolerance": DEPLOY_TOL,
           "facade_ms_per_env_step": secs * 1e3 / VEL_STEPS,
           "launches": launches, "state_moved_by_step": moved,
           "set_state_round_trip_exact": round_trip,
           "backward_shape": list(g.shape),
           "backward_finite": bool(np.isfinite(g).all()),
           "backward_max_abs": float(np.abs(g).max())}
    if launches != expect:
        raise AssertionError(f"policy_deploy: launch counts {launches}, "
                             f"expected {expect}")
    if not (diff <= DEPLOY_TOL * scale and round_trip and moved > 0
            and res["backward_finite"]
            and res["backward_shape"] == [VEL_STEPS + 1, env.action_dim]):
        raise AssertionError(f"policy_deploy failed: {res}")
    return res


def run_demo_policy():
    """The ported policy trainer softmac_tpu_torch.demos.demo_policy on the
    card (run_demo_trainer, DEMO_STEPS env steps an epoch): also the
    policy's parameters moved."""
    from softmac_tpu_torch.demos import demo_policy
    res = run_demo_trainer(demo_policy, "policy", DEMO_STEPS,
                           FORWARD + tuple(k + "_bwd" for k in FORWARD),
                           ckpt="policy")
    if not res["policy_max_abs_change"] > 0:
        raise AssertionError(f"demo_policy on the card failed: {res}")
    return res


# ---------------------------------------------------------------------------
# the cloth scenes, rows 1-8 around the cloth path in plain PyTorch (the
# projective-dynamics cloth, the dense pair search, the penetration tracing
# and the cloth contact, as the JAX package's are plain XLA), ten substeps an
# env step. The hit: two MPM-controlled corotated-elastic cylinders and a box
# against a towel (144 vertices, 242 faces) hanging from two vertices,
# forecast mixed contact, window (32, 24, 32). The taco: a 10 000-particle
# plastic disk on a tortilla (217 vertices, 384 faces) whose 17 attachment
# vertices the actions move (the cloth control mode), sticky contact with
# both gradient scales 0.3, mpm_scale 5 (n_grid 64, inv_dx 12.8), window
# (48, 24, 48)
# ---------------------------------------------------------------------------
def hit_env(device=None):
    """The hit at its 5000 particles, the two cylinders on the controller
    (demos/demo_hit.py)."""
    import numpy as np
    from softmac_tpu_torch import SoftMacEnv, load
    cfg = load(str(ROOT / "softmac_tpu_torch/config/demo_hit_config.py"))
    env = SoftMacEnv(cfg, device=device)
    idx = np.full(env.n_particles, -1, np.int32)
    idx[:sum(int(s["n_particles"]) for s in cfg.SHAPES[:2])] = 0
    env.set_control_idx(idx)
    return env


def hit_actions(n_steps):
    """The demo's initial actions: HIT_FORCE on z."""
    import numpy as np
    return np.tile([0.0, 0.0, HIT_FORCE], (n_steps, 1))


def taco_env(device=None):
    """The taco at its 10 000 particles in the cloth control mode
    (demos/demo_taco.py)."""
    from softmac_tpu_torch import SoftMacEnv, load
    cfg = load(str(ROOT / "softmac_tpu_torch/config/demo_taco_config.py"))
    env = SoftMacEnv(cfg, device=device)
    env.set_control_mode("cloth")
    return env


def taco_actions(env, n_steps):
    """The first n_steps env steps of the scripted fold that made the
    target (demo_taco.get_init_actions choice 1 over the demo's
    TACO_FOLD_STEPS): the first two handles swing up and in at the demo's
    pace. Compressed into 30 env steps the fold flings the disk (vertex
    forces of 1e5 by env step 12, then non-finite particles)."""
    from softmac_tpu_torch.demos.demo_taco import get_init_actions
    return get_init_actions(TACO_FOLD_STEPS, env, choice=1)[:n_steps]


def taco_hold(env, n_steps):
    """The rollout's last targets held for n_steps env steps: the actions
    of the phases that start from the rollout's exit."""
    import numpy as np
    return np.repeat(taco_actions(env, TACO_STEPS)[-1:], n_steps, axis=0)


class ClothContacts:
    """Within it, each env step's contact pairs and penetrating particles
    after the cloth moved (what ``trace_penetration_after_cloth`` returns)
    and the largest |vertex force| the cloth step of ``env`` took are kept;
    ``counts()`` reads them after a synchronize."""

    def __init__(self, env):
        self.env, self.pairs, self.forces = env, [], []

    def __enter__(self):
        import torch
        from softmac_tpu_torch.engine import cloth_contact as cc
        self.cc, self.trace = cc, cc.trace_penetration_after_cloth
        step = self.env.cloth_model.step

        def traced(*args, **kw):
            out = self.trace(*args, **kw)
            self.pairs.append(torch.stack([(out.contact_id >= 0).sum(),
                                           (out.penetration != 0).sum()]))
            return out

        def stepped(state, attach, ext_f):
            self.forces.append(ext_f.abs().amax())
            return step(state, attach, ext_f)
        cc.trace_penetration_after_cloth = traced
        self.env.cloth_model.step = stepped
        return self

    def __exit__(self, *exc):
        self.cc.trace_penetration_after_cloth = self.trace
        del self.env.cloth_model.step

    def counts(self):
        import torch
        torch.cuda.synchronize()
        pairs = torch.stack(self.pairs).tolist() if self.pairs else []
        return {"pairs": [p[0] for p in pairs],
                "penetrating": [p[1] for p in pairs],
                "vertex_force_max_abs": torch.stack(self.forces).double()
                .tolist() if self.forces else []}


class Counted:
    """OffSlab, Spills and ClothContacts(env) entered together."""

    def __init__(self, env):
        self.off, self.spills = OffSlab(), Spills()
        self.touch = ClothContacts(env)

    def __enter__(self):
        for c in (self.off, self.spills, self.touch):
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in (self.touch, self.spills, self.off):
            c.__exit__(*exc)


def run_cloth(tag, env, acts, moved, first_contact=None, **extra):
    """A cloth scene's main path: SoftMacEnv.rollout of ``acts``, launches
    counted from zero (rows 1-8 each once a substep; the cloth path
    launches none of the port's kernels), the slab kernels' spills and the
    read-side off-slab particles summed, each env step's pairs,
    penetrating particles and largest vertex force kept. No overflow,
    finite, contact pairs (in every env step from ``first_contact`` on,
    where given), a nonzero vertex force and a cloth that moved more than
    ``moved``."""
    import torch
    reset_launches()
    with Counted(env) as c:
        out, secs = timed_rollout(env, acts)
    launches = read_launches()
    n_sub = len(acts) * env.substeps
    expect = dict.fromkeys(wrappers(), 0)
    expect.update(dict.fromkeys(TRANSFERS, n_sub))
    if launches != expect:
        raise AssertionError(f"{tag} launch counts {launches}, expected "
                             f"{expect}")
    state, cloth, pen = out["carry"]
    rest = env.cloth_model.init_state().x
    contacts = c.touch.counts()
    forces = contacts["vertex_force_max_abs"]
    loss = out["loss"].item()
    res = {"scene": f"demo_{tag}", "n_particles": env.n_particles,
           "cloth_vertices": env.cloth_model.n_vertices,
           "cloth_faces": int(env.cloth_params.faces.shape[0]),
           "window": list(env.mpm_cfg.active_window),
           "substeps_per_env_step": env.substeps, "env_steps": len(acts),
           "substeps": n_sub, **extra,
           "wall_ms_per_substep": secs * 1e3 / n_sub,
           "launches": launches, "spilled": c.spills.counts(),
           "off_slab": c.off.counts(), "loss": loss,
           "terms": {k: float(v) for k, v in out["terms"].items()},
           "pairs_by_env_step": contacts["pairs"],
           "penetrating_by_env_step": contacts["penetrating"],
           "vertex_force_max_abs_by_env_step": forces,
           "first_contact_env_step": next(
               (t for t, f in enumerate(forces) if f > 0), None),
           "cloth_moved_max_abs": (cloth.x - rest).abs().max().item(),
           "x_finite": bool(torch.isfinite(state.x).all()),
           "cloth_finite": bool(torch.isfinite(cloth.x).all()
                                and torch.isfinite(cloth.v).all())}
    res["spilled_total"] = sum(v["spilled"] for v in res["spilled"].values())
    res["off_slab_total"] = sum(v["off_slab"]
                                for v in res["off_slab"].values())
    print(f"{tag}: spilled {res['spilled']}, off the slab {res['off_slab']}, "
          f"pairs {contacts['pairs'][:3]} .. {contacts['pairs'][-3:]}, "
          f"penetrating {contacts['penetrating'][-3:]}, vertex force "
          f"{forces[:3]} .. {max(forces)}, cloth moved "
          f"{res['cloth_moved_max_abs']}", flush=True)
    touching = (min(contacts["pairs"][first_contact:]) > 0
                and min(forces[first_contact:]) > 0
                if first_contact is not None else
                max(contacts["pairs"]) > 0 and max(forces) > 0)
    if (res["terms"]["window_overflow"] or not math.isfinite(loss)
            or not (res["x_finite"] and res["cloth_finite"])
            or not touching or not res["cloth_moved_max_abs"] > moved):
        raise AssertionError(f"{tag} output wrong: {res}")
    return res, launches, out["carry"]


def run_hit(env):
    """The hit's main path: the demo's HIT_STEPS env steps at its initial
    push (contact from env step 16), by run_cloth."""
    return run_cloth("hit", env, hit_actions(HIT_STEPS), HIT_MOVED,
                     push_z=HIT_FORCE)


def run_taco(env):
    """The taco's main path: the first TACO_STEPS env steps of the scripted
    fold, by run_cloth, contact in every env step from the first (the disk
    spans y 2.005-2.205 over a tortilla at 2.0; pairs within 0.05)."""
    return run_cloth("taco", env, taco_actions(env, TACO_STEPS), TACO_MOVED,
                     first_contact=0,
                     actions=f"the first {TACO_STEPS} env steps of the "
                     f"{TACO_FOLD_STEPS}-step scripted fold")


def hit_grad_expect(env, steps, remat):
    """Launches of rows 1-8 in the hit's rollout_and_grad over ``steps``
    env steps from a carry, the loss on the towel at the last frame only
    (the demo's). Every substep's P2G and gather feed that substep's
    vertex forces, so they run backward; the last substep's G2P output and
    the splat under it reach no loss (the towel took its forces before
    it), so theirs do not. Under remat "step" every env step is replayed
    once."""
    n_sub = steps * env.substeps
    replays = n_sub if remat == "step" else 0
    expect = dict.fromkeys(wrappers(), 0)
    expect.update(dict.fromkeys(TRANSFERS, n_sub + replays))
    expect.update({"p2g_bwd": n_sub, "gather_bwd": n_sub,
                   "g2p_bwd": n_sub - 1, "splat_bwd": n_sub - 1})
    return expect


def taco_grad_expect(env, steps, remat, calls=1, clipped_steps=False):
    """Launches of rows 1-8 in ``calls`` of the taco's rollout_and_grad
    over ``steps`` env steps (>= 2) from a carry, the loss on the particles
    at frames of the last env steps. The actions reach the particles only
    through the cloth, which moves after an env step's substeps: the first
    env step's substeps record no graph, and in the second one's first
    substep only the contact's target velocity depends on them, so its P2G
    and gather do not run backward while its splat and G2P do; unless
    ``clipped_steps`` (a loss block an env step and a ``grad_clip``: the
    carry passes ``ClipCotangent`` between env steps, and every tensor of
    it then carries the graph). Under remat "step" every env step is
    replayed once (the first for its cloth step)."""
    n_sub = steps * env.substeps
    graph = n_sub - env.substeps
    first = graph if clipped_steps else graph - 1
    replays = n_sub if remat == "step" else 0
    expect = dict.fromkeys(wrappers(), 0)
    expect.update(dict.fromkeys(TRANSFERS, calls * (n_sub + replays)))
    expect.update({"p2g_bwd": calls * first, "gather_bwd": calls * first,
                   "g2p_bwd": calls * graph, "splat_bwd": calls * graph})
    return expect


def run_cloth_grad(tag, env, carry, acts, expect, glass, grad_clip=None):
    """A cloth scene's gradient path: rollout_and_grad of ``acts`` from
    ``carry`` (the rollout's, in contact), the loss at the last frame only,
    remat "step": one counted call and the repeats, exact launch counts
    (``expect(remat)``), finite, nonzero on the action columns ``glass``,
    the repeats within GRAD_TOL (bit-identical in practice); contact in
    every env step of the counted call."""
    counted = Counted(env)
    frames = len(acts) * env.substeps
    out, launches = run_gradient(
        f"{tag}_grad", env, acts, expect, glass, env.mpm_cfg.active_window,
        repeats=CLOTH_GRAD_REPEATS, loss_start_frame=frames,
        loss_stride=frames, grad_clip=grad_clip, remats=("step",),
        counted=counted, carry0=carry)
    out.update(counted.touch.counts())
    out["spilled"] = counted.spills.counts()
    out["off_slab"] = counted.off.counts()
    print(f"{tag}_grad: pairs {out['pairs']}, spilled {out['spilled']}, off "
          f"the slab {out['off_slab']}", flush=True)
    if not (min(out["pairs"]) > 0 and min(out["vertex_force_max_abs"]) > 0):
        raise AssertionError(f"{tag}_grad: an env step without contact: "
                             f"{out}")
    return {"scene": f"demo_{tag}", "from": f"the {tag} rollout's exit carry",
            **out}, launches


def run_hit_grad(env, carry):
    """HIT_GRAD_STEPS env steps of the demo's push from the rollout's
    carry, the demo's loss (the last frame), by run_cloth_grad."""
    return run_cloth_grad(
        "hit", env, carry, hit_actions(HIT_GRAD_STEPS),
        lambda remat: hit_grad_expect(env, HIT_GRAD_STEPS, remat), [0, 1, 2])


def run_taco_grad(env, carry):
    """TACO_GRAD_STEPS env steps of the fold's last targets held, from
    the rollout's carry, the demo's grad_clip, by run_cloth_grad: nonzero
    on the first two handles' x and y (columns 0, 1, 3, 4, what the
    demo optimises)."""
    return run_cloth_grad(
        "taco", env, carry, taco_hold(env, TACO_GRAD_STEPS),
        lambda remat: taco_grad_expect(env, TACO_GRAD_STEPS, remat),
        [0, 1, 3, 4], grad_clip=TACO_GRAD_CLIP)


def cloth_kernel_inputs(env, carry, mpm_action=None):
    """The inputs the first substep from ``carry`` hands rows 1-8
    (y-sorted, as the rollout keeps them), built with the port's own
    substep stages and the kernels: P2G's channels (the controllers'
    ``mpm_action`` in), the bounded grid velocity the gather reads, the
    cloth contact's target velocity (plain PyTorch, the first substep's
    life), the splat's values and the grid velocity G2P reads."""
    import torch
    from softmac_tpu_torch.engine import cloth_contact as cc
    from softmac_tpu_torch.engine import mpm
    from softmac_tpu_torch.ops import m33, transfer
    cfg = env.mpm_cfg
    state, cloth, pen = carry
    q, _ = mpm.sort_perm(cfg, state.x)
    state, pen = mpm.permute_state(state, q), cc.permute_pen(pen, q)
    params = mpm.permute_params(env.mpm_params, q)
    stress, _ = mpm.stress_and_F(cfg, params, state)
    sizes, corner, overflow = mpm.window_geometry(cfg, state.x)
    if bool(overflow) or mpm.transfer_route(cfg) != "transfer":
        raise AssertionError("cloth kernel-check state: overflow or route")
    zero = torch.zeros_like(state.x[0])
    impulse = mpm.control_impulse(cfg, params, (zero, zero, zero),
                                  mpm_action)
    chan = mpm._p2g_channels(cfg, tuple(state.v), m33.from_mat_array(state.C),
                             stress, impulse)
    gm, gmom = transfer.p2g(state.x, chan, corner, sizes, cfg.inv_dx)
    gvm, mask = mpm._bounded_velocity(cfg, params, gm, gmom, sizes, corner)
    gvm = tuple(g.contiguous() for g in gvm)
    v_tmp = transfer.gather(state.x, *gvm, corner, sizes, cfg.inv_dx)
    v_tgt, ext = cc.collide_cloth(
        env.cloth_params, cloth.x, cloth.v, tuple(state.x), tuple(v_tmp),
        cfg.p_mass, cfg.dt, mpm._life(cfg, 0), pen,
        env.cloth_model.n_vertices)
    vals = (-2.0 * (v_tmp - torch.stack(v_tgt))).contiguous()
    corr = transfer.splat(state.x, vals, corner, sizes, cfg.inv_dx)
    wx = sizes[0]
    gv = tuple(torch.where(mask, gvm[d] + corr[:, d * wx:(d + 1) * wx],
                           0.0).contiguous() for d in range(3))
    return dict(cfg=cfg, state=state, corner=corner, sizes=sizes, chan=chan,
                gvm=gvm, gv=gv, vals=vals,
                pairs=int((pen.contact_id >= 0).sum()),
                vertex_force_max_abs=ext.abs().max().item())


def check_cloth_kernels(tag, env, carry, mpm_action=None):
    """Rows 1-8 on a cloth scene's state in contact (``carry``), by
    check_transfer_rows: the state must hold contact pairs and particles
    whose velocity the cloth changed (the splat's nonzero values)."""
    inp = cloth_kernel_inputs(env, carry, mpm_action)
    res, band, _ = check_transfer_rows(tag, inp)
    if not (inp["pairs"] > 0 and band > 0
            and inp["vertex_force_max_abs"] > 0):
        raise AssertionError(f"{tag} kernel-check state not in contact: "
                             f"pairs {inp['pairs']}, nonzero values {band}")
    return {"n_particles": inp["state"].x.shape[1],
            "window": list(inp["sizes"]), "contact_pairs": inp["pairs"],
            "splat_nonzero_vals": band,
            "vertex_force_max_abs": inp["vertex_force_max_abs"],
            "kernels": res}


def check_hit_kernels(env, carry):
    import torch
    push = torch.tensor(hit_actions(1), dtype=carry[0].x.dtype,
                        device=carry[0].x.device)
    return check_cloth_kernels("hit", env, carry, push)


def check_taco_kernels(env, carry):
    return check_cloth_kernels("taco", env, carry)


def run_cloth_parity(tag, env, carry, cpu, acts, tol):
    """``acts`` from ``carry`` (the rollout's, in contact) on the card
    (float32, kernels) and on the CPU env ``cpu`` (float64, plain versions,
    the same carry widened), the loss at the last frame: how many
    particles' contact id or penetration bit differ at the end; x of the
    particles that agree, the cloth's x and the loss within ``tol`` (the
    loss relative)."""
    from softmac_tpu_torch.engine.env import map_carry
    wide = map_carry(lambda t: (t.double() if t.is_floating_point() else t)
                     .cpu(), carry)
    frames = len(acts) * env.substeps
    kw = dict(loss_start_frame=frames, loss_stride=frames)
    reset_launches()
    got = env.rollout(acts, carry0=carry, **kw)
    launches = read_launches()
    want = cpu.rollout(acts, carry0=wide, **kw)
    (mg, cg, pg), (mc, cc_, pc) = got["carry"], want["carry"]
    agree = ((pg.contact_id.cpu() == pc.contact_id)
             & (pg.penetration.cpu() == pc.penetration))
    lg, lc = got["loss"].item(), want["loss"].item()
    res = {"scene": f"demo_{tag}", "from": f"the {tag} rollout's exit carry",
           "n_particles": env.n_particles, "env_steps": len(acts),
           "pairs_gpu": int((pg.contact_id >= 0).sum()),
           "pairs_cpu": int((pc.contact_id >= 0).sum()),
           "penetrating_cpu": int((pc.penetration != 0).sum()),
           "pair_or_bit_differs": int((~agree).sum()),
           "x_max_abs_err_where_agree": (mg.x.double().cpu() - mc.x)[
               :, agree].abs().max().item(),
           "cloth_x_max_abs_err": (cg.x.double().cpu() - cc_.x).abs().max()
           .item(),
           "loss_gpu": lg, "loss_cpu": lc,
           "loss_rel_err": abs(lg - lc) / abs(lc),
           "tolerance": tol, "gpu_launches": launches}
    print(f"{tag}_parity: {res['pair_or_bit_differs']} particles' pair or "
          f"bit differ; x {res['x_max_abs_err_where_agree']}, cloth x "
          f"{res['cloth_x_max_abs_err']}, loss {res['loss_rel_err']}",
          flush=True)
    if not (all(launches[k] > 0 for k in TRANSFERS) and res["pairs_cpu"] > 0
            and res["x_max_abs_err_where_agree"] <= tol
            and res["cloth_x_max_abs_err"] <= tol
            and res["loss_rel_err"] <= tol):
        raise AssertionError(f"{tag} GPU/CPU parity failed: {res}")
    return res


def run_hit_parity(env, carry):
    return run_cloth_parity("hit", env, carry, hit_env("cpu"),
                            hit_actions(HIT_PARITY_STEPS), HIT_PARITY_TOL)


def run_taco_parity(env, carry):
    return run_cloth_parity("taco", env, carry, taco_env("cpu"),
                            taco_hold(env, TACO_PARITY_STEPS),
                            TACO_PARITY_TOL)


def profile_cloth(tag, env, carry, acts, grad_acts):
    """torch.profiler over ``acts`` forward and ``grad_acts`` forward and
    backward (remat "none", the loss at the last frame) from ``carry``."""
    return {"from": f"the {tag} rollout's exit carry",
            "forward": run_profile(env, acts, carry0=carry),
            "fwd_bwd": run_profile(env, grad_acts, grad=True, carry0=carry,
                                   loss_stride=len(grad_acts) * env.substeps)}


def run_demo_hit():
    from softmac_tpu_torch.demos import demo_hit
    return run_demo_trainer(demo_hit, "hit", DEMO_HIT_STEPS,
                            TRANSFERS + tuple(k + "_bwd" for k in TRANSFERS),
                            epochs=DEMO_HIT_EPOCHS)


def run_demo_taco(substeps):
    """The taco trainer (``substeps`` an env step) for one epoch of
    DEMO_TACO_STEPS env steps with each optimiser: Adam over
    DEMO_TACO_REPLICAS jittered replicas (that many rollout_and_grads), and
    the line search (one rollout_and_grad, four candidate rollouts, and one
    more rollout_and_grad where a candidate won), launch counts exact
    (taco_grad_expect: the demo's loss frames lie a block an env step
    apart, and it clips the carry's cotangent)."""
    import types
    from softmac_tpu_torch.demos import demo_taco
    env = types.SimpleNamespace(substeps=substeps)
    steps, out = DEMO_TACO_STEPS, {}
    for method, extra in (("adam", ["--replicas", str(DEMO_TACO_REPLICAS)]),
                          ("line_search", ["--line-search"])):
        res = run_demo_trainer(demo_taco, "taco", steps, TRANSFERS + tuple(
            k + "_bwd" for k in TRANSFERS), epochs=1, extra=extra)
        grads = (DEMO_TACO_REPLICAS if method == "adam"
                 else 1 + sum(res["moved"]))
        expect = taco_grad_expect(env, steps, "step", calls=grads,
                                  clipped_steps=True)
        if method == "line_search":
            for k in TRANSFERS:
                expect[k] += len(demo_taco.LRS) * steps * env.substeps
        if res["launches"] != expect:
            raise AssertionError(f"demo_taco ({method}) launch counts "
                                 f"{res['launches']}, expected {expect}")
        out[method] = res
    return out


# ---------------------------------------------------------------------------
# the rest of the rigid family: body-body contact (the flagship pour with
# RIGID.body_contact at full width, the glass-on-bowl drop), an articulated
# tree (a double pendulum swinging into an elastic blob), welds and a
# floating-base tree on the rigid side alone, and TransportLoss; rows 1-12
# on the MPM paths, the rigid side plain PyTorch
# ---------------------------------------------------------------------------
BC_STEPS = 100             # pour_body_contact's counted rollout
BC_GRAD_STEPS = 20         # its rollout_and_grad, remat "step" and "none"
BC_PROFILE_STEPS = 10
DROP_STEPS = 300           # scripts/demo_body_contact.py's
CHAIN_N = 10_000           # the grip's and the taco's particle count
CHAIN_STEPS = 250          # tests/test_chain.py's coupled run
CHAIN_GRAD_FROM = 100      # the gradient starts from this step's carry
CHAIN_GRAD_STEPS = 20
CHAIN_PROFILE_STEPS = 5
CHAIN_PUSHED = 1e-3        # the blob's least horizontal displacement (m)
FAMILY_STEPS = 100         # rigid_family: card float32 against CPU float64
FLYBOT_STEPS = 40          # the flybot's (~0.4 s a 7-dof tree step on the
                           # card's host, PR 23)
FAMILY_TOL = 2e-3          # of each q's and qd's largest |value|: the
                           # palm's tree (11 g carrying two 1 kg fingers on
                           # its axis, cond(M) ~400) reads 4e-4 in float32
MOMENTUM_TOL = 1e-4        # |P| over m * the arm's largest speed
FINGER = ROOT / "assets/gripper/finger.obj"   # a mesh with a baked table


def body_contact_cfg(window=None):
    """The flagship pour with the glass-bowl penalty contact on."""
    cfg = pour_cfg(window)
    cfg.defrost()
    cfg.RIGID.body_contact = True
    return cfg.freeze()


def rigid_step_profile(env):
    """One RigidModel step and its body_states (once per env step) from the
    initial state with the env's SDF tables: its device kernels and their
    device ms, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rm = env.rigid_model
    rigid = rm.init_state()
    kw = dict(dtype=env.dtype, device=env.device)
    act = torch.zeros((rm.action_dim,), **kw)
    ext_f = torch.zeros((rm.n_primitives, 6), **kw)

    def step():
        rm.body_states(rm.step(rigid, act, ext_f, prims=env.prims))
    step()                                   # warm-up
    torch.cuda.synchronize()
    for _ in range(3):      # a profile now and then holds no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kern:
            return {"launches": len(kern),
                    "device_ms": sum(e.time_range.elapsed_us()
                                     for e in kern) / 1e3,
                    "wall_ms": wall * 1e3}
    raise AssertionError("rigid step: the profiler saw no device kernel")


def mixed_path_expect(env, n_sub):
    """The forward launches of ``n_sub`` substeps of a mixed-contact scene
    (the pour's kinds): one P2G, G2P, gather and splat a substep, one
    mixed contact a body a substep."""
    expect = dict.fromkeys(wrappers(), 0)
    expect.update({"p2g": n_sub, "g2p": n_sub, "gather": n_sub,
                   "splat": n_sub, "collide_mixed": n_sub * env.n_primitives})
    return expect


def bit_identical_grad(tag, out):
    """A gradient phase's repeats (run_gradient, one repeat a remat) held
    to bit identity."""
    for remat in ("step", "none"):
        if remat in out and out[remat]["repeat_grad_max_abs_diff"] != 0.0:
            raise AssertionError(f"{tag} ({remat}): the repeat is not bit-"
                                 f"identical: {out[remat]}")


def run_pour_body_contact(pour_env):
    """P1: the flagship pour at 1e5 particles (window (32, 32, 16)) with
    RIGID.body_contact on: BC_STEPS env steps of zero actions with the
    launches counted (the plain pour's exactly: body contact adds PyTorch
    ops only), finite, no overflow, the glass moved, against the plain
    pour's rollout of the same steps; rollout_and_grad of BC_GRAD_STEPS
    under "step" and "none" (exact launches, finite, repeats bit-identical);
    the launches and device ms a substep body contact adds (profiles of
    both scenes, and of one rigid step of each); one epoch of demo_pour
    --body-contact."""
    import numpy as np
    import torch
    from softmac_tpu_torch import SoftMacEnv
    from softmac_tpu_torch.demos import demo_pour
    env = SoftMacEnv(body_contact_cfg(POUR_WINDOW),
                     init_particles=tiled_pour_particles(N_MAIN))
    if not env.rigid_model.body_contact:
        raise AssertionError("pour_body_contact: body contact is off")
    acts = np.zeros((BC_STEPS, env.action_dim))
    q0 = env._initial_carry()[2].q
    env.rollout(acts[:2])                               # warm-up
    reset_launches()
    out, secs = timed_rollout(env, acts)
    launches = read_launches()
    n_sub = BC_STEPS * env.substeps
    expect = mixed_path_expect(env, n_sub)
    if launches != expect:
        raise AssertionError(f"pour_body_contact: launch counts {launches}, "
                             f"expected {expect}")
    plain, plain_secs = timed_rollout(pour_env, acts)
    state, bodies, rigid = out["carry"]
    wrench = env.rigid_model.body_contact_wrenches(bodies, env.prims)
    res = {"n_particles": env.n_particles, "window": list(POUR_WINDOW),
           "env_steps": BC_STEPS, "substeps": n_sub,
           "substeps_per_s": n_sub / secs,
           "plain_pour_substeps_per_s": n_sub / plain_secs,
           "loss": out["loss"].item(), "launches": launches,
           "window_overflow": bool(out["terms"]["window_overflow"]),
           "x_finite": bool(torch.isfinite(state.x).all()),
           "glass_q_moved": (rigid.q[:6] - q0[:6]).abs().max().item(),
           "exit_contact_wrench_max_abs": wrench.abs().max().item(),
           "x_max_abs_diff_vs_plain_pour":
               (state.x - plain["carry"][0].x).abs().max().item(),
           "q_max_abs_diff_vs_plain_pour":
               (rigid.q - plain["carry"][2].q).abs().max().item()}
    if (res["window_overflow"] or not res["x_finite"]
            or not math.isfinite(res["loss"]) or not res["glass_q_moved"] > 0):
        raise AssertionError(f"pour_body_contact output wrong: {res}")
    grad, grad_launches = run_gradient(
        "pour_body_contact_grad", env, acts[:BC_GRAD_STEPS],
        lambda remat: pour_grad_expect(env, BC_GRAD_STEPS, remat),
        list(range(6)), POUR_WINDOW, repeats=1)
    bit_identical_grad("pour_body_contact_grad", grad)
    res["grad"] = grad
    prof = run_profile(env, acts[:BC_PROFILE_STEPS])
    plain_prof = run_profile(pour_env, acts[:BC_PROFILE_STEPS])
    res["profile"] = prof
    res["added_launches_per_substep"] = (
        prof["kernel_launches_per_substep"]
        - plain_prof["kernel_launches_per_substep"])
    res["added_device_ms_per_substep"] = (
        prof["device_busy_ms_per_substep"]
        - plain_prof["device_busy_ms_per_substep"])
    res["rigid_step"] = rigid_step_profile(env)
    res["plain_rigid_step"] = rigid_step_profile(pour_env)
    res["demo"] = run_demo_trainer(
        demo_pour, "pour", DEMO_STEPS,
        POUR + POUR_BWD + ("p2g", "g2p", "p2g_bwd", "g2p_bwd"), epochs=1,
        extra=("--body-contact",))
    return res, launches, grad_launches


def run_body_contact_drop():
    """P2: demos.demo_body_contact at the script's DROP_STEPS, contact off
    and on (its four checks), with the stick branch and with --no-stick:
    each run's launches exact (rows 1, 3, 5, 7 and 11, once a substep, the
    contact once a body), its rate."""
    import tempfile
    from softmac_tpu_torch.demos import demo_body_contact
    res = {}
    for stick in (True, False):
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--steps", str(DROP_STEPS), "--log-root", tmp]
            if not stick:
                argv.append("--no-stick")
            reset_launches()
            t0 = time.perf_counter()
            out = demo_body_contact.main(argv)
            secs = time.perf_counter() - t0
            launches = read_launches()
            saved = (Path(tmp) / "body_contact/trajectory.npy").is_file()
        # two runs (off, on) of DROP_STEPS one-substep env steps, 2 bodies
        expect = dict.fromkeys(wrappers(), 0)
        expect.update({k: 2 * DROP_STEPS for k in TRANSFERS},
                      collide_mixed=2 * 2 * DROP_STEPS)
        if launches != expect or not saved:
            raise AssertionError(f"body_contact_drop: launch counts "
                                 f"{launches}, expected {expect}; "
                                 f"trajectory saved {saved}")
        res["stick" if stick else "no_stick"] = {
            **out, "launches": launches, "seconds_with_setup": secs,
            "env_steps_per_s": 2 * DROP_STEPS / secs}
    return res


def chain_urdf(directory):
    """A double pendulum (tests/test_chain.py's, 0.2 kg links) whose two
    links are the gripper's finger (a 0.1 x 0.2 x 0.1 box about its
    origin, its table baked in the repo): the first hinged at its centre
    (0.5, 0.75, 0.5), the second at its lower end, each link's centre of
    mass 0.1 below its hinge; written to ``directory`` with the mesh's
    absolute path."""
    L, m = 0.2, 0.2
    izz = m * L * L / 12

    def joint(name, parent, child, xyz):
        return (f'<joint name="{name}" type="revolute"><parent link='
                f'"{parent}"/><child link="{child}"/><origin xyz="{xyz}" '
                'rpy="0 0 0"/><axis xyz="0 0 1"/></joint>')

    def link(name):
        return (f'<link name="{name}"><inertial><origin rpy="0 0 0" '
                f'xyz="0 {-L / 2} 0"/><mass value="{m}"/><inertia '
                f'ixx="{izz}" ixy="0" ixz="0" iyy="1e-5" iyz="0" '
                f'izz="{izz}"/></inertial><collision><geometry><mesh '
                f'filename="{FINGER}"/></geometry></collision></link>')

    path = Path(directory) / "chain_blob.urdf"
    path.write_text('<?xml version="1.0"?><robot name="chain_blob">'
                    '<link name="world"/>'
                    + joint("j1", "world", "arm1", "0.5 0.75 0.5")
                    + link("arm1") + joint("j2", "arm1", "arm2", f"0 {-L} 0")
                    + link("arm2") + "</robot>")
    return path


def chain_cfg(urdf, n_particles):
    """tests/test_chain.py's coupled scene around the finger pendulum: an
    elastic (corotated, E 50) blob in the lower link's swing, mixed
    contact, the arm started at 1.2 rad, window (24, 24, 16); a
    TransportLoss (the upper link pulled to a target, each half of the
    blob's distance) for the gradient."""
    from softmac_tpu_torch import CN, get_cfg_defaults
    cfg = get_cfg_defaults()
    cfg.control_mode = "rigid"
    cfg.env_dt = 1e-3
    cfg.SIMULATOR.dt = 1e-3
    cfg.SIMULATOR.E = 50.0
    cfg.SIMULATOR.ptype = 1
    cfg.SIMULATOR.material_model = 0
    cfg.SIMULATOR.ground_friction = 0.0
    cfg.SIMULATOR.collision_type = 2
    cfg.SHAPES = [{"shape": "box", "width": (0.08, 0.10, 0.08),
                   "init_pos": [0.62, 0.50, 0.5],
                   "n_particles": n_particles, "color": 0, "init_rot": None}]
    prim = CN()
    prim.friction = 0.1
    prim.urdf_path = str(urdf)
    prim.enable_external_force = True
    cfg.PRIMITIVES = [prim]
    cfg.RIGID.gravity = (0.0, -9.8, 0.0)
    cfg.RIGID.enable_floor = False
    cfg.RIGID.init_state = (1.2, 0.0, 0.0, 0.0)
    cfg.TPU.active_window = (24, 24, 16)
    cfg.ENV.loss_type = "TransportLoss"
    cfg.ENV.loss.weight = (1.0, 1.0, 1.0)
    return cfg


def chain_grad_expect(env, steps, remat):
    """pour_grad_expect's counts less, under remat "step", the first env
    step's replay: the tree's step keeps its own saved tensors outside the
    checkpoint (engine/chain.py), so the first env step, whose MPM half
    records nothing for autograd, leaves nothing to recompute."""
    expect = pour_grad_expect(env, steps, remat)
    if remat == "step":
        for k in TRANSFERS:
            expect[k] -= 1
        expect["collide_mixed"] -= env.n_primitives
    return expect


def run_chain_blob():
    """P3: the finger pendulum swinging into a CHAIN_N-particle elastic
    blob: CHAIN_STEPS env steps of zero actions (CHAIN_GRAD_FROM, then the
    rest from that carry) with the launches counted (rows 1, 3, 5, 7 and
    11: the transfer route, the two links' mixed contact); the blob pushed
    sideways and the arm slowed against the free pendulum (the JAX test's
    two checks); rollout_and_grad of CHAIN_GRAD_STEPS from the carry at
    CHAIN_GRAD_FROM under "step" and "none" (exact launches, finite,
    repeats bit-identical); a profile, and one tree step's launches and
    device ms."""
    import tempfile
    import numpy as np
    import torch
    from softmac_tpu_torch import SoftMacEnv
    with tempfile.TemporaryDirectory() as tmp:
        env = SoftMacEnv(chain_cfg(chain_urdf(tmp), CHAIN_N))
    rm = env.rigid_model
    if [b.jtype for b in rm.bodies] != ["chain", "chain"]:
        raise AssertionError(f"chain_blob: kinds {[b.jtype for b in rm.bodies]}")
    acts = np.zeros((CHAIN_STEPS, env.action_dim))
    x0 = env._initial_carry()[0].x
    env.rollout(acts[:2])                               # warm-up
    reset_launches()
    head, secs0 = timed_rollout(env, acts[:CHAIN_GRAD_FROM])
    t0 = time.perf_counter()
    out = env.rollout(acts[CHAIN_GRAD_FROM:], carry0=head["carry"])
    torch.cuda.synchronize()
    secs1 = time.perf_counter() - t0
    launches = read_launches()
    n_sub = CHAIN_STEPS * env.substeps
    expect = mixed_path_expect(env, n_sub)
    if launches != expect:
        raise AssertionError(f"chain_blob: launch counts {launches}, "
                             f"expected {expect}")
    mpm, _, rigid = out["carry"]
    free = rm.init_state()
    zero = torch.zeros((rm.n_primitives, 6), dtype=env.dtype,
                       device=env.device)
    for a in torch.as_tensor(acts, dtype=env.dtype, device=env.device):
        free = rm.step(free, a, zero)
    shift = (mpm.x - x0).mean(dim=1)
    res = {"n_particles": env.n_particles, "env_steps": CHAIN_STEPS,
           "substeps": n_sub, "substeps_per_s": n_sub / (secs0 + secs1),
           "launches": launches,
           "window_overflow": bool(out["terms"]["window_overflow"])
           or bool(head["terms"]["window_overflow"]),
           "x_finite": bool(torch.isfinite(mpm.x).all()),
           "q": rigid.q.tolist(), "qd": rigid.qd.tolist(),
           "free_q": free.q.tolist(), "free_qd": free.qd.tolist(),
           "blob_centroid_shift": shift.tolist(),
           "blob_max_displacement": (mpm.x - x0).norm(dim=0).max().item()}
    slowed = (abs(res["qd"][0]) < abs(res["free_qd"][0]) - 1e-3
              or abs(res["q"][0] - res["free_q"][0]) > 1e-3)
    if (res["window_overflow"] or not res["x_finite"]
            or not all(math.isfinite(v) for v in res["q"] + res["qd"])
            or not abs(res["blob_centroid_shift"][0]) > CHAIN_PUSHED
            or not slowed):
        raise AssertionError(f"chain_blob output wrong: {res}")
    grad, grad_launches = run_gradient(
        "chain_blob_grad", env, acts[:CHAIN_GRAD_STEPS],
        lambda remat: chain_grad_expect(env, CHAIN_GRAD_STEPS, remat),
        [0, 1], None, repeats=1, loss_stride=CHAIN_GRAD_STEPS,
        carry0=head["carry"])
    bit_identical_grad("chain_blob_grad", grad)
    res["grad"] = grad
    res["profile"] = run_profile(env, acts[:CHAIN_PROFILE_STEPS],
                                 carry0=head["carry"])
    res["tree_step"] = rigid_step_profile(env)
    return res, launches, grad_launches


def family_models(tmp, device, dtype):
    """rigid_family's models on ``device``: the welded pendulum (a rod
    with a tip welded on, tests/test_rigid.py's), the palm on a slider
    (the gripper's palm prismatic, its fingers a tree below it, and made
    fixed, welds onto it) and the flybot (a floating base carrying an arm,
    tests/test_chain.py's; no gravity)."""
    from softmac_tpu_torch import CN
    from softmac_tpu_torch.engine.meshio import load_urdf
    from softmac_tpu_torch.engine.rigid import RigidModel
    tmp = Path(tmp)
    box = (tmp / "box.obj")
    h = 0.01
    box.write_text("".join(f"v {x} {y} {z}\n" for x in (-h, h)
                           for y in (-h, h) for z in (-h, h))
                   + "f 1 2 4 3\nf 5 7 8 6\nf 1 5 6 2\nf 3 4 8 7\n"
                   "f 1 3 7 5\nf 2 6 8 4\n")

    def link(name, mass, com, inertia):
        return (f'<link name="{name}"><inertial><origin rpy="0 0 0" '
                f'xyz="{com}"/><mass value="{mass}"/><inertia ixx="{inertia}"'
                f' ixy="0" ixz="0" iyy="{inertia}" iyz="0" izz="{inertia}"/>'
                '</inertial><collision><geometry><mesh filename="box.obj"/>'
                '</geometry></collision></link>')

    def joint(name, jtype, parent, child, xyz, rpy="0 0 0"):
        return (f'<joint name="{name}" type="{jtype}"><parent link='
                f'"{parent}"/><child link="{child}"/><origin xyz="{xyz}" '
                f'rpy="{rpy}"/><axis xyz="0 0 1"/></joint>')

    def robot(name, body):
        path = tmp / f"{name}.urdf"
        path.write_text(f'<?xml version="1.0"?><robot name="{name}">'
                        f'<link name="world"/>{body}</robot>')
        return load_urdf(str(path))

    def cfg(gravity):
        c = CN()
        c.gravity = gravity
        c.init_state = ()
        c.enable_floor = False
        c.joint_damping = 0.001
        return c

    welded = robot("welded", joint("j1", "revolute", "world", "rod",
                                   "0.5 0.6 0.5")
                   + link("rod", 0.3, "0 -0.1 0", "1e-5")
                   + joint("wj", "fixed", "rod", "tip", "0.01 -0.2 0",
                           "0.3 0 0")
                   + link("tip", 0.15, "0 -0.01 0", "1e-5"))
    grip = (ROOT / "assets/gripper/gripper.urdf").read_text().replace(
        'filename="', f'filename="{ROOT / "assets/gripper"}/').replace(
        '"palm_to_world" type="fixed"', '"palm_to_world" type="prismatic"')
    sliders = []
    for kind in ("prismatic", "fixed"):
        path = tmp / f"palm_{kind}.urdf"
        path.write_text(grip.replace('_to_palm" type="prismatic"',
                                     f'_to_palm" type="{kind}"'))
        sliders.append(load_urdf(str(path)))
    flybot = robot("flybot", joint("root", "floating", "world", "body",
                                   "0.5 0.5 0.5")
                   + link("body", 0.5, "0 0 0", "1e-3")
                   + joint("shoulder", "revolute", "body", "arm", "0.05 0 0")
                   + link("arm", 0.2, "0 -0.2 0", "1e-4"))
    g = (0.0, -9.8, 0.0)
    return {name: RigidModel([urdf], cfg(grav), 1e-3, dtype, device)
            for name, urdf, grav in (
                ("welded_pendulum", welded, g),
                ("palm_slider_tree", sliders[0], g),
                ("palm_slider_welds", sliders[1], g),
                ("flybot", flybot, (0.0, 0.0, 0.0)))}


def linear_momentum(rm, state):
    """The total linear momentum of a model's bodies (the welds' mass is
    in their carriers): sum of m times the world COM velocity."""
    import torch
    from softmac_tpu_torch.engine import quat as Q
    bs = rm.body_states(state)
    p = torch.zeros(3, dtype=state.q.dtype, device=state.q.device)
    for i, b in enumerate(rm.bodies):
        if b.jtype != "weld":
            p = p + b.mass * Q.qrot(bs.quat[i], bs.v[i])
    return p


def run_rigid_family():
    """The welded pendulum, the palm on a slider (tree and welds) and the
    flybot, FAMILY_STEPS (the flybot FLYBOT_STEPS) steps with seeded
    actions and wrenches on the card
    in float32 against the same models on the CPU in float64: q and qd
    within FAMILY_TOL of their largest |value|, body_states finite; the
    flybot with no gravity and no wrench, driven by its arm alone: its
    linear momentum stays zero."""
    import tempfile
    import numpy as np
    import torch
    from softmac_tpu_torch.engine.rigid import RigidState
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        gpu = family_models(tmp, "cuda", torch.float32)
        cpu = family_models(tmp, "cpu", torch.float64)
    for name, gm in gpu.items():
        cm = cpu[name]
        n, d = gm.n_primitives, gm.action_dim
        steps = FLYBOT_STEPS if name == "flybot" else FAMILY_STEPS
        rng = np.random.RandomState(len(name))
        acts = rng.randn(steps, d) * 0.01
        exts = rng.randn(steps, n, 6) * 0.02
        if name == "flybot":
            acts[:, :6] = 0.0
            exts[:] = 0.0
        q0 = rng.randn(d) * 0.05
        if name == "flybot":
            q0[3:6] = 0.5
        states = []
        for m in (gm, cm):
            kw = dict(dtype=m.dtype, device=m.device)
            s = RigidState(q=torch.as_tensor(q0, **kw),
                           qd=torch.zeros(d, **kw))
            t0 = time.perf_counter()
            for a, e in zip(acts, exts):
                s = m.step(s, torch.as_tensor(a, **kw),
                           torch.as_tensor(e, **kw))
            torch.cuda.synchronize()
            states.append((s, time.perf_counter() - t0))
        (sg, tg), (sc, tc) = states
        bs = gm.body_states(sg)
        err = {k: ((getattr(sg, k).double().cpu() - getattr(sc, k))
                   .abs().max() / getattr(sc, k).abs().max()).item()
               for k in ("q", "qd")}
        res[name] = {"kinds": [b.jtype for b in gm.bodies], "dofs": d,
                     "steps": steps, "q_rel_err": err["q"],
                     "qd_rel_err": err["qd"], "tolerance": FAMILY_TOL,
                     "card_ms_per_step": tg * 1e3 / steps,
                     "cpu_ms_per_step": tc * 1e3 / steps}
        if name == "flybot":
            p = linear_momentum(gm, sg).norm().item()
            scale = sum(b.mass for b in gm.bodies) * sc.qd.abs().max().item()
            res[name]["linear_momentum"] = p
            res[name]["momentum_rel"] = p / scale
            if not p / scale <= MOMENTUM_TOL:
                raise AssertionError(f"rigid_family: the flybot's momentum "
                                     f"{res[name]}")
        if not (max(err.values()) <= FAMILY_TOL and all(
                bool(torch.isfinite(getattr(bs, f)).all())
                for f in ("pos", "quat", "v", "w"))):
            raise AssertionError(f"rigid_family {name}: {res[name]}")
    return res


def run_transport():
    """P4: TransportLoss on tests/test_losses.py's reduced pour_vel (256
    particles, 2 env steps): finite terms, a finite nonzero action
    gradient, rows 1-4, 9 and 10 launched exactly (remat "step")."""
    import numpy as np
    import torch
    from softmac_tpu_torch import SoftMacEnv
    cfg = pour_vel_cfg()
    cfg.defrost()
    cfg.SHAPES = [{"shape": "box", "width": (0.15, 0.05, 0.15),
                   "init_pos": [0.7, 0.32, 0.5], "n_particles": 256,
                   "color": 0, "init_rot": None}]
    cfg.ENV.loss_type = "TransportLoss"
    cfg.ENV.loss.weight = (1.0, 1.0, 1.0)
    env = SoftMacEnv(cfg.freeze())
    acts = np.zeros((2, env.action_dim))
    acts[:, 1] = 0.5
    reset_launches()
    out = env.rollout_and_grad(acts, loss_start_frame=0, loss_stride=2,
                               remat="step")
    launches = read_launches()
    expect = vel_grad_expect(env, 2, "step")
    g = out["action_grad"]
    res = {"loss": type(env.loss).__name__, "n_particles": env.n_particles,
           "env_steps": 2, "substeps": 2 * env.substeps,
           "terms": {k: float(v) for k, v in out["terms"].items()},
           "grad_abs_sum": g.abs().sum().item(),
           "grad_finite": bool(torch.isfinite(g).all()),
           "launches": launches}
    if launches != expect:
        raise AssertionError(f"transport: launch counts {launches}, "
                             f"expected {expect}")
    if not (res["grad_finite"] and res["grad_abs_sum"] > 0 and all(
            math.isfinite(res["terms"][k])
            for k in ("pose_loss", "vel_loss", "contact_loss"))):
        raise AssertionError(f"transport failed: {res}")
    return res


# ---------------------------------------------------------------------------
# rendering and mesh preprocessing: the renderer on the card (frames of the
# pour, the hit and the door held against the CPU's float64 frame of the
# same snapshot), a trainer's GIF, the SDF bake on the card against the
# shipped tables, the C++ preprocessing library. The renderer and the bake
# are PyTorch tensor code on the card (the JAX package's renderer is NumPy
# and its bake plain XLA); they launch none of the port's kernels
# ---------------------------------------------------------------------------
RENDER_POUR_STEPS = 20     # the pour's frame: after 20 zero-action steps
RENDER_REPEATS = 5         # timed card frames (the median is reported)
RENDER_EQUAL = 0.995       # share of pixels equal to the CPU's float64 frame
RENDER_NEAR = 2            # the other pixels within 2 of 255
DEMO_RENDER_STEPS = 10     # the rendering trainer's epoch: 10 frames
BAKE_MESHES = ("door/door", "gripper/palm", "gripper/finger")
BAKE_SLABS = ("glass/glass", "bowl/bowl")
BAKE_TOL = 2e-6            # sdf against the shipped float32 tables
BAKE_TIE_SHARE = 0.05      # cells whose nearest face is a tie (the glass's
                           # slab: 1.8 % on the CPU)
BAKE_REPEATS = 3
BAKE_CHECK_DEVICE = "cuda"  # where the ties' float64 distances are taken


def frame_of(env, carry):
    """(x (N, 3), bodies, cloth) of a rollout's exit carry (the particles
    in their original order) on the card."""
    mpm, second, _ = carry
    if env.has_cloth:
        return mpm.x.T, None, (second.x, env.cloth_model.faces)
    return mpm.x.T, second, None


def check_frame(tag, env, carry, target=None):
    """One frame of ``carry`` drawn on the card (float64, the env's device)
    and on the CPU (float64): at least RENDER_EQUAL of the pixels equal,
    the rest within RENDER_NEAR; the card's ms a frame, a median of
    RENDER_REPEATS frames each ended by a synchronize (host clock)."""
    import numpy as np
    import torch
    from softmac_tpu_torch.engine.renderer import PointRenderer
    x, bodies, cloth = frame_of(env, carry)
    card = PointRenderer(env.render_cfg, env)
    host = PointRenderer(env.render_cfg, env, device="cpu")
    if target is not None:
        card.set_target(target)
        host.set_target(target)

    def draw(r):
        return r.render(x, env.particle_colors, bodies, cloth=cloth)
    launches0 = read_launches()
    img = draw(card)
    ms = []
    for _ in range(RENDER_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = draw(card)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    ref = draw(host)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    diff = np.abs(img.astype(np.int64) - ref).max(axis=-1)
    floor = PointRenderer(env.render_cfg, env, device="cpu").render(
        None, None, None)
    res = {"scene": tag, "image": list(img.shape), "ssaa": card.ssaa,
           "n_particles": int(x.shape[0]),
           "meshes": len(env.prim_meshes) + (cloth is not None),
           "target": target is not None,
           "card_ms_per_frame": statistics.median(ms), "card_ms": ms,
           "cpu_float64_ms": cpu_ms,
           "pixels_equal_share": float((diff == 0).mean()),
           "pixels_differing": int((diff > 0).sum()),
           "max_abs_diff": int(diff.max()),
           "pixels_off_the_floor_share": float(
               (img != floor).any(axis=-1).mean()),
           "port_kernel_launches": sum(read_launches().values())
           - sum(launches0.values())}
    if not (res["pixels_equal_share"] >= RENDER_EQUAL
            and res["max_abs_diff"] <= RENDER_NEAR
            and res["pixels_off_the_floor_share"] > 0.005):
        raise AssertionError(f"render ({tag}) failed: {res}")
    return res


def run_render(pour_env, henv, hit_carry, denv, door10):
    """The renderer on the card: the flagship pour at 1e5 particles after
    RENDER_POUR_STEPS zero-action env steps (the glass at alpha 0.8 and the
    bowl, the target overlaid; 512^2, ssaa 2), the hit after its counted
    rollout (1024^2, the towel Gouraud-shaded, the target), the door after
    STATE_STEPS env steps (512^2, ssaa 2)."""
    import numpy as np
    pour = pour_env.rollout(np.zeros((RENDER_POUR_STEPS,
                                      pour_env.action_dim)))["carry"]
    return {"frames": [
        check_frame("pour", pour_env, pour, np.load(
            ROOT / "envs/pour/pour_mpm_target_position_corotated.npy")),
        check_frame("hit", henv, hit_carry,
                    np.load(ROOT / "envs/mpm2towel/towel_target_45.npy")),
        check_frame("door", denv, door10)]}


def run_demo_render():
    """One epoch of demo_pour of DEMO_RENDER_STEPS env steps on its own
    scene without, with and again without --render-interval 1: with it, the
    epoch's actions replayed through the facade and drawn on the card to
    epoch0.gif (DEMO_RENDER_STEPS frames, read by walking the GIF's blocks)
    and loss_curve.png; each run's seconds (host clock, setup included);
    what rendering added against the faster run without."""
    import tempfile
    from softmac_tpu_torch import images
    from softmac_tpu_torch.demos import demo_pour
    res = {"trainer": "demo_pour", "env_steps": DEMO_RENDER_STEPS}
    for run_name, interval in (("plain_first", "0"), ("render", "1"),
                               ("plain", "0")):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            out = demo_pour.main(["--steps", str(DEMO_RENDER_STEPS),
                                  "--epochs", "1", "--render-interval",
                                  interval, "--log-root", tmp])
            secs = time.perf_counter() - t0
            log = Path(tmp) / "pour"
            gif = log / "epoch0.gif"
            run = {"seconds_with_setup": secs,
                   "epoch_seconds": out["epoch_seconds"],
                   "gif": images.gif_info(gif) if gif.exists() else None,
                   "gif_bytes": gif.stat().st_size if gif.exists() else 0,
                   "loss_curve_png": list(images.read_png(
                       log / "loss_curve.png").shape)}
        res[run_name] = run
    res["render_seconds"] = res["render"]["seconds_with_setup"] - min(
        res[k]["seconds_with_setup"] for k in ("plain_first", "plain"))
    gif = res["render"]["gif"]
    if not (res["plain"]["gif"] is None and gif is not None
            and gif["frames"] == DEMO_RENDER_STEPS and gif["loop"] == 0
            and gif["size"] == (512, 512)):
        raise AssertionError(f"demo_render failed: {res}")
    return res


def _bake_check(name, g, sel, got_sdf, got_normal, ref_sdf, ref_normal):
    """The bake at the grid points ``g["points"][sel]`` against the shipped
    table; every cell whose normal differs checked to be a nearest-face
    tie: the shipped normal's face within 1e-6 of the nearest distance in
    float64 (on the card)."""
    import numpy as np
    import torch
    from softmac_tpu_torch.engine import sdf
    err = np.abs(got_sdf - ref_sdf)
    far = np.abs(ref_sdf) > BAKE_TOL
    ties = np.abs(got_normal - ref_normal).max(axis=-1) > 1e-6
    tie_gap = 0.0
    if ties.any():
        kw = dict(dtype=torch.float64, device=BAKE_CHECK_DEVICE)
        pts = torch.as_tensor(g["points"][sel][ties], **kw)
        tri = [torch.as_tensor(g["verts"][g["faces"][:, k]], **kw)
               for k in range(3)]
        dist = torch.sqrt(sdf.point_triangle_dist2(pts, *tri)).cpu().numpy()
        fn = g["face_normals"].astype(np.float32)
        picked = np.abs(fn[None] - ref_normal[ties][:, None]).max(
            axis=-1) < 1e-6
        tie_gap = float(np.max(np.where(picked, dist, np.inf).min(axis=1)
                               - dist.min(axis=1)))
    res = {"cells": int(ref_sdf.size), "sdf_max_abs_err": float(err.max()),
           "sign_flips_beyond_tol": int(
               (np.sign(got_sdf) != np.sign(ref_sdf))[far].sum()),
           "normal_tie_cells": int(ties.sum()),
           "normal_tie_share": float(ties.mean()),
           "normal_tie_max_distance_gap": tie_gap}
    if not (res["sdf_max_abs_err"] <= BAKE_TOL
            and res["sign_flips_beyond_tol"] == 0
            and res["normal_tie_share"] <= BAKE_TIE_SHARE
            and tie_gap <= 1e-6):
        raise AssertionError(f"bake ({name}) failed: {res}")
    return res


def run_bake():
    """The SDF bake on the card (float32): the door, the palm and the
    finger baked whole (preprocess_sdf on an empty cache directory, then
    BAKE_REPEATS timed bake_mesh_sdf calls, host clock, their result on the
    host) and one y-slab of grid points each of the glass and the bowl,
    all against the shipped tables (the JAX bake's output): sdf within
    BAKE_TOL, no sign flip beyond it, at most BAKE_TIE_SHARE of the cells
    with another nearest face's normal, each of them a tie (_bake_check)."""
    import tempfile
    import numpy as np
    import torch
    from softmac_tpu_torch.engine import sdf
    from softmac_tpu_torch.engine.meshio import load_obj
    out = {}
    for mesh in BAKE_MESHES + BAKE_SLABS:
        v, f = load_obj(ROOT / f"assets/{mesh}.obj")
        key = sdf.sdf_cache_key(v, f)
        ref = np.load(ROOT / "assets" / mesh.split("/")[0]
                      / f"sdf_{key}.npz")
        length = float(np.max(v.max(0) - v.min(0)))
        dx = min(0.01, length / 80)
        margin = max(dx * 3, 0.01)
        if mesh in BAKE_MESHES:
            with tempfile.TemporaryDirectory() as tmp:
                got = sdf.preprocess_sdf(v, f, tmp)
                written = sorted(np.load(Path(tmp) / f"sdf_{key}.npz").files)
            ms = []
            for _ in range(BAKE_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sdf.bake_mesh_sdf(v, f, margin, dx)
                ms.append((time.perf_counter() - t0) * 1e3)
            if not (np.array_equal(got["res"], ref["res"])
                    and written == sorted(ref.files)):
                raise AssertionError(f"bake ({mesh}): res {got['res']} "
                                     f"against {ref['res']}, fields "
                                     f"{written}")
            res = _bake_check(mesh, sdf.bake_grid(v, f, margin, dx),
                              slice(None), got["sdf"].reshape(-1),
                              got["normal"].reshape(-1, 3),
                              ref["sdf"].reshape(-1),
                              ref["normal"].reshape(-1, 3))
            res.update(ms_per_bake=statistics.median(ms), ms=ms)
        else:
            g = sdf.bake_grid(v, f, margin, dx)
            j = int(g["res"][1]) // 2
            sel = (np.arange(len(g["points"])) // int(g["res"][2])
                   % int(g["res"][1])) == j
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, n = sdf.bake_points(g["points"][sel], g["verts"],
                                   g["faces"], g["face_normals"])
            secs = time.perf_counter() - t0
            res = _bake_check(mesh, g, sel, s, n,
                              ref["sdf"][:, j].reshape(-1),
                              ref["normal"][:, j].reshape(-1, 3))
            res.update(y_slab=j, ms_per_slab=secs * 1e3)
        res.update(faces=int(len(f)), res=[int(r) for r in ref["res"]])
        out[mesh] = res
    return out


def run_native():
    """The C++ preprocessing library: g++ builds it on this host (the phase
    fails where it cannot; the meshes the scenes loaded before may have
    built it already, so the phase also times a fresh g++ of the source
    into a temporary directory), its OBJ parse equals the Python body byte
    for byte on every mesh under assets/ and envs/assets/, its face
    adjacency equals the Python body on the tortilla and the towel."""
    import shutil
    import tempfile
    import numpy as np
    from softmac_tpu_torch import native
    from softmac_tpu_torch.engine import cloth_contact, meshio
    prebuilt = native.library_path().exists()
    so = native.build()
    native.library()
    gxx = shutil.which("g++")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([gxx, *native.FLAGS, str(native.SRC), "-o",
                        str(Path(tmp) / "fresh.so")], check=True)
        build_s = time.perf_counter() - t0
    objs = sorted((ROOT / "assets").glob("*/*.obj")) + sorted(
        (ROOT / "envs/assets").glob("*/*.obj"))
    parse_equal = {}
    for path in objs:
        v, f = native.parse_obj(path)
        pv, pf = meshio.load_obj_plain(path)
        parse_equal[str(path.relative_to(ROOT))] = (
            v.tobytes() == pv.tobytes() and f.tobytes() == pf.tobytes())
    adjacency = {}
    for name in ("tortilla", "towel"):
        faces = meshio.load_obj(ROOT / f"envs/assets/{name}/{name}.obj")[1]
        t0 = time.perf_counter()
        got = native.process_faces(faces, 200)
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = cloth_contact.process_faces_plain(faces, 200)
        adjacency[name] = {
            "faces": int(len(faces)), "native_ms": native_ms,
            "python_ms": (time.perf_counter() - t0) * 1e3,
            "equal": all(np.array_equal(a, b) for a, b in zip(got, want))}
    res = {"library": so.name, "built_before_the_phase": prebuilt,
           "fresh_build_seconds": build_s,
           "objs_parsed": len(parse_equal),
           "parse_equal": all(parse_equal.values()),
           "adjacency": adjacency}
    if not (res["parse_equal"]
            and all(a["equal"] for a in adjacency.values())):
        raise AssertionError(f"native failed: {res} {parse_equal}")
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
    import numpy as np
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
    ptxas = ptxas_by_source(log)
    rows_ptxas = {k + ".cu": [f for f in ptxas.get(k + ".cu", [])
                              if not is_round(f["function"])]
                  for k in ROW_KERNELS}
    contact_ptxas = {k: [f for f in ptxas.get(k, [])
                         if not is_round(f["function"])]
                     for k in PENALTY_SOURCES}
    read_ptxas = {k: ptxas.get(k, []) for k in READ_SOURCES}
    emit("build", {"seconds": secs, "library": so.name,
                   "row_kernels": rows_ptxas,
                   "penalty_contact_kernels": contact_ptxas,
                   "read_tile_kernels": read_ptxas, "ptxas": ptxas})
    for k, fns in {**contact_ptxas, **read_ptxas}.items():
        print(f"{k} ptxas: " + ", ".join(
            f"registers {f['registers']}, spill stores {f['spill_stores']}"
            for f in fns), flush=True)
    if log and not all(fns and all(f["spill_stores"] == 0 for f in fns)
                       for fns in rows_ptxas.values()):
        raise AssertionError(f"row-thread kernels: ptxas {rows_ptxas}")
    if log and not all(fns and all(f["spill_stores"] == 0 for f in fns)
                       for fns in contact_ptxas.values()):
        raise AssertionError(f"penalty contact kernels: ptxas "
                             f"{contact_ptxas}")
    if log and not all(fns and all(f["spill_stores"] == 0 for f in fns)
                       for fns in read_ptxas.values()):
        raise AssertionError(f"read-side tile kernels: ptxas {read_ptxas}")

    env = SoftMacEnv(pour_vel_cfg(WINDOW),
                     init_particles=tiled_pour_particles(N_MAIN))
    state10 = env.rollout(actions(STATE_STEPS))["carry"]   # also warms up
    inp = kernel_inputs(env, state10)
    kernels = check_kernels(inp) + check_backward_kernels(inp)
    pour_env = SoftMacEnv(pour_cfg(POUR_WINDOW),
                          init_particles=tiled_pour_particles(N_MAIN))
    zeros10 = np.zeros((STATE_STEPS, pour_env.action_dim))
    pour10 = pour_env.rollout(zeros10)["carry"]
    pour_inp = pour_kernel_inputs(pour_env, pour10)
    kernels += check_pour_kernels(pour_inp)
    kernels += check_pour_backward_kernels(pour_inp)
    # the mixed pair at a remaining-window factor below 1 (the pour's
    # substep has life 1), its gates unchanged
    pour_lives = check_mixed_lives("pour collide_mixed", pour_inp,
                                   (1.0, LIFE_BELOW_ONE), BODY_TOL,
                                   every_body=False)
    slab = check_slab_kernels(inp, pour_inp)
    read = check_read_kernels(inp, pour_inp)
    for k in kernels:
        if k["name"] in slab:
            k["slab"] = slab[k["name"]]
        if k["name"] in read:
            k["read_tiles"] = read[k["name"]]
    denv, door10, door_inp = door_states()
    big_inp = door_inp.pop("1e5")
    band_inp = door_inp.pop("band")
    door_inp = door_inp["door"]
    door_lives = check_mixed_lives("door collide_mixed", band_inp,
                                   (1.0, LIFE_BELOW_ONE), BODY_TOL,
                                   every_body=False)
    dense_inp = dense_kernel_inputs(denv.device)
    kernels += check_fused_kernels(door_inp, big_inp, dense_inp, band_inp)
    kernels += check_fused_backward_kernels(door_inp, big_inp, dense_inp)
    del big_inp, band_inp
    kernels += check_kr3_kernel(pour_env, pour10)
    full_env = SoftMacEnv(full_grid_cfg(),
                          init_particles=tiled_pour_particles(N_MAIN))

    paths = {}
    slice_res, paths["slice"] = run_slice(env)
    grad_res, grad_launches = run_grad(env)
    paths["grad_step"], paths["grad_none"] = (grad_launches["step"],
                                              grad_launches["none"])
    policy_res, paths["policy_grad"], policy = run_policy_grad(env)
    pour_res, paths["pour"] = run_pour(pour_env)
    split_res, paths["pour_split"] = run_pour_split(pour_env)
    pour_grad_res, pour_grad_launches, real_bwd = run_pour_grad(pour_env)
    check_real_backward(real_bwd, kernels)
    del real_bwd
    paths["pour_grad_step"], paths["pour_grad_none"] = (
        pour_grad_launches["step"], pour_grad_launches["none"])
    split_grad_res, paths["pour_split_grad"] = run_pour_split_grad(pour_env)
    door_res, paths["door"] = run_door(denv)
    door_grad_res, door_grad_launches = run_door_grad(denv)
    paths["door_grad_step"], paths["door_grad_none"] = (
        door_grad_launches["step"], door_grad_launches["none"])
    full_res, paths["dense"], paths["dense_grad_step"] = run_full_grid(
        full_env)
    genv = grip_env()
    grip_res, paths["grip"], grip_carry = run_grip(genv)
    grip_grad_res, grip_grad_launches = run_grip_grad(genv)
    paths["grip_grad_step"], paths["grip_grad_none"] = (
        grip_grad_launches["step"], grip_grad_launches["none"])
    grip_kernels = check_grip_kernels(genv, grip_carry)
    del grip_carry
    henv = hit_env()
    hit_res, paths["hit"], hit_carry = run_hit(henv)
    hit_kernels = check_hit_kernels(henv, hit_carry)
    hit_grad_res, hit_grad_launches = run_hit_grad(henv, hit_carry)
    paths["hit_grad_step"] = hit_grad_launches["step"]
    tenv = taco_env()
    taco_res, paths["taco"], taco_carry = run_taco(tenv)
    taco_kernels = check_taco_kernels(tenv, taco_carry)
    taco_grad_res, taco_grad_launches = run_taco_grad(tenv, taco_carry)
    paths["taco_grad_step"] = taco_grad_launches["step"]
    for k in kernels:
        # each kernel's main path: the forward kernels of pour_vel on its
        # rollout, their backwards on its gradient path with the default
        # remat ("step"), the pour's forward kernels on the flagship pour's
        # rollout and their backwards on its gradient path ("step"), the
        # split pair and its backward pair on that scene under the switch,
        # the dense-weight transfers on the door's rollout and their
        # backwards on its gradient path ("step"), the pair build on the
        # full-grid pour's rollout
        name = k["name"]
        counter = {"collide_mixed_split": "collide_mixed1",
                   "collide_mixed_split_bwd": "collide_mixed1_bwd"}.get(
                       name, name)
        path = ("slice" if name in FORWARD else "door" if name in FUSED
                else "dense" if name == "kr3"
                else "door_grad_step" if name in FUSED_BWD
                else "pour" if name in POUR
                else "pour_split" if counter == "collide_mixed1"
                else "pour_split_grad" if counter == "collide_mixed1_bwd"
                else "pour_grad_step" if name in POUR_BWD
                else "grad_step")
        k["launches"] = paths[path][counter]
        k["main_path"] = path
        k["ptxas"] = [f for f in ptxas.get(Path(k["source"]).name, [])
                      if not is_round(f["function"])]
        k["launches_by_path"] = {p: c[counter] for p, c in paths.items()}
        if name in DEVICE_MS:
            k["device_ms"], k["device_launches_per_call"] = DEVICE_MS[name]
        if name in grip_kernels["kernels"]:
            # on the grip's state in contact: error, device ms and bound
            k["grip_state"] = grip_kernels["kernels"][name]
        if name in hit_kernels["kernels"]:
            k["hit_state"] = hit_kernels["kernels"][name]
        if name in taco_kernels["kernels"]:
            k["taco_state"] = taco_kernels["kernels"][name]
        if name == "collide_mixed":
            k["lives"] = {"pour": pour_lives, "door_band_state": door_lives}
        if not k["launches"] > 0:
            raise AssertionError(f"{name} was not launched on its main path "
                                 f"({path})")
    for k in kernels:
        print(f"{k['name']}: call ms {k['ms']}, device ms "
              f"{k.get('device_ms')}, bound ms {k['bound_ms']}, launches "
              f"{k['launches']}", flush=True)
    emit(None, {"kernels": kernels})
    emit("slice", slice_res)
    emit("grad", grad_res)
    emit("pour", pour_res)
    emit("pour_split", split_res)
    emit("pour_grad", pour_grad_res)
    emit("pour_split_grad", split_grad_res)
    profile = run_profile(env, actions(20, seed=3))
    profile["penalty_contact_launches"] = penalty_launches(profile, env, 20)
    emit("profile", profile)
    profile_pour = run_profile(pour_env, np.zeros((20, pour_env.action_dim)))
    profile_pour["rigid_step_launches_per_env_step"] = rigid_step_launches(
        pour_env)
    emit("profile_pour", profile_pour)
    profile_grad = run_profile(env, actions(10, seed=3), grad=True)
    profile_grad["penalty_contact_launches"] = penalty_launches(
        profile_grad, env, 10)
    emit("profile_grad", profile_grad)
    emit("profile_pour_grad", run_profile(
        pour_env, np.zeros((10, pour_env.action_dim)), grad=True))
    emit("parity", run_parity())
    emit("demo", run_demo())
    emit("door", door_res)
    emit("door_grad", door_grad_res)
    profile_door = run_profile(denv, door_actions(20))
    profile_door["svd_launches_per_substep"] = svd_launches(denv, door10)
    profile_door["svd_share_of_launches"] = (
        profile_door["svd_launches_per_substep"]
        / profile_door["kernel_launches_per_substep"])
    profile_door["rigid_step_launches_per_env_step"] = rigid_step_launches(
        denv)
    emit("profile_door", profile_door)
    emit("profile_door_grad", run_profile(denv, door_actions(5), grad=True))
    emit("door_index_origin", kernel_origin(denv, door_actions(2),
                                            "indexing_backward_kernel"))
    emit("door_parity", run_door_parity())
    emit("demo_door", run_demo_door())
    emit("dense", full_res)
    emit("profile_dense", run_profile(
        full_env, np.zeros((FULL_PROFILE_STEPS, full_env.action_dim))))
    del full_env
    emit("dense_parity", run_full_grid_parity())
    emit("grid", run_grid_contact())
    profile_grip = {"forward": grip_res.pop("profile"),
                    "fwd_bwd": run_profile(
                        genv, grip_actions(GRIP_GRAD_PROFILE_STEPS),
                        grad=True,
                        loss_stride=GRIP_GRAD_PROFILE_STEPS * genv.substeps)}
    profile_grip["rigid_step_launches_per_env_step"] = rigid_step_launches(
        genv)
    emit("grip", grip_res)
    emit("grip_kernels", grip_kernels)
    emit("grip_grad", grip_grad_res)
    emit("profile_grip", profile_grip)
    del genv
    emit("grip_parity", run_grip_parity())
    emit("demo_grip", run_demo_grip())
    emit("demo_pour_vel", run_demo_pour_vel())
    emit("render", run_render(pour_env, henv, hit_carry, denv, door10))
    emit("demo_render", run_demo_render())
    emit("bake", run_bake())
    emit("native", run_native())
    emit("hit", hit_res)
    emit("hit_kernels", hit_kernels)
    emit("hit_grad", hit_grad_res)
    emit("profile_hit", profile_cloth(
        "hit", henv, hit_carry, hit_actions(HIT_PROFILE_STEPS),
        hit_actions(HIT_PROFILE_STEPS)))
    emit("hit_parity", run_hit_parity(henv, hit_carry))
    del henv, hit_carry
    emit("demo_hit", run_demo_hit())
    emit("taco", taco_res)
    emit("taco_kernels", taco_kernels)
    emit("taco_grad", taco_grad_res)
    emit("profile_taco", profile_cloth(
        "taco", tenv, taco_carry, taco_hold(tenv, TACO_PROFILE_STEPS),
        taco_hold(tenv, TACO_PROFILE_STEPS + 1)))
    emit("taco_parity", run_taco_parity(tenv, taco_carry))
    substeps = tenv.substeps
    del tenv, taco_carry
    emit("demo_taco", run_demo_taco(substeps))
    emit("policy_grad", policy_res)
    emit("policy_deploy", run_policy_deploy(policy))
    del policy
    emit("demo_policy", run_demo_policy())
    bc_res, _, _ = run_pour_body_contact(pour_env)
    emit("pour_body_contact", bc_res)
    del pour_env
    emit("body_contact_drop", run_body_contact_drop())
    chain_res, _, _ = run_chain_blob()
    emit("chain_blob", chain_res)
    emit("rigid_family", run_rigid_family())
    emit("transport", run_transport())
    print(smi, flush=True)      # the card again, next to the result
    emit(None, {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                      "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
