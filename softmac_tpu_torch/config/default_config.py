"""Default configuration schema.

Schema parity with the reference (``softmac/config/default_config.py:4-95``):
the same section names and keys, so the reference's demo configs work
unchanged. Extensions live under ``_C.TPU``; the section keeps the JAX
package's name so both packages load a config file to the same dict. The
PyTorch port reads ``TPU.active_window`` and ``TPU.compute_dtype`` ("auto":
float32 on CUDA, float64 on the CPU) and ignores the Pallas knobs.
"""
import math

from softmac_tpu_torch.config.node import CN

_C = CN()
cfg = _C

_C.control_mode = "rigid"                 # "mpm" | "rigid" | "cloth"
_C.rigid_velocity_control = False
_C.env_dt = 2e-3
_C.mpm_scale = 1.0                        # domain scale (soft_cloth variant)

# ---------------------------------------------------------------------------- #
# Simulator
# ---------------------------------------------------------------------------- #
_C.SIMULATOR = CN()
_C.SIMULATOR.dim = 3
_C.SIMULATOR.quality = 1
_C.SIMULATOR.yield_stress = 50.0
_C.SIMULATOR.dtype = "float64"            # "float64" on CPU; f32 compute on TPU
_C.SIMULATOR.max_steps = 1024
_C.SIMULATOR.n_particles = 9000
_C.SIMULATOR.E = 5e3
_C.SIMULATOR.nu = 0.2
_C.SIMULATOR.ground_friction = 1.5
_C.SIMULATOR.gravity = (0.0, 0.0, 0.0)
_C.SIMULATOR.ptype = 0                    # 0 plastic, 1 elastic, 2 liquid
_C.SIMULATOR.material_model = 1           # 0 corotated, 1 neo-hookean
_C.SIMULATOR.dt = 1e-4
_C.SIMULATOR.n_controllers = 0
_C.SIMULATOR.collision_type = 2           # 0 grid, 1 particle, 2 mixed

# ---------------------------------------------------------------------------- #
# Primitives (rigid bodies described by URDFs)
# ---------------------------------------------------------------------------- #
_C.PRIMITIVES = list()

# ---------------------------------------------------------------------------- #
# Particle shapes
# ---------------------------------------------------------------------------- #
_C.SHAPES = list()

# ---------------------------------------------------------------------------- #
# Rigid body simulator
# ---------------------------------------------------------------------------- #
_C.RIGID = RIGID = CN()
RIGID.gravity = (0.0, 0.0, 0.0)
RIGID.init_state = ()
RIGID.enable_floor = True
RIGID.ext_grad_scale = 1.0               # damping for mpm->rigid gradients
RIGID.floor_height = -0.08               # penalty-contact floor plane (y)
RIGID.floor_stiffness = 1e4
RIGID.floor_damping = 10.0
# rigid-rigid (body-body) penalty contact — differentiable stand-in for the
# Jade/DART world's skeleton-vs-skeleton LCP contact (reference
# rigid_simulator.py:17-45). Off by default: no reference scene exercises
# body-body contact (pour's glass and bowl never touch).
RIGID.body_contact = False
RIGID.body_contact_stiffness = 1e4
RIGID.body_contact_damping = 10.0
RIGID.body_contact_friction = 0.5
RIGID.body_contact_points = 256       # surface samples per body
# static-friction (stick) factor: 0 = legacy viscous friction (creeps);
# 0 < stick <= 1 cancels the pair's relative tangential momentum within one
# step, Coulomb-clamped — contacts inside the friction cone hold still like
# the reference's LCP solve (engine/rigid.py __init__ for the formula)
RIGID.body_contact_stick = 0.0

# ---------------------------------------------------------------------------- #
# Cloth simulator (soft_cloth variant)
# ---------------------------------------------------------------------------- #
_C.CLOTH = CLOTH = CN()
CLOTH.sceneConfig = list()
CLOTH.transform = list()

# ---------------------------------------------------------------------------- #
# Renderer
# ---------------------------------------------------------------------------- #
_C.RENDERER = RENDERER = CN()
RENDERER.mode = "rgb_array"
RENDERER.light_rot = (-math.pi / 4, 0)
RENDERER.camera_pos = (0.5, 0.8, 2.8)
RENDERER.camera_rot = (-0.2, 0)
RENDERER.image_res = (512, 512)
RENDERER.ssaa = 2        # supersampling factor (1 disables)
RENDERER.shadows = True  # projected floor shadows

# ---------------------------------------------------------------------------- #
# Env / loss
# ---------------------------------------------------------------------------- #
_C.ENV = ENV = CN()
ENV.loss_type = ""

loss = ENV.loss = CN()
loss.soft_contact = False
loss.weight = (10.0, 10.0, 1.0)
loss.target_path = ""

ENV.n_observed_particles = 200

_C.VARIANTS = list()

# ---------------------------------------------------------------------------- #
# TPU-specific knobs (extensions; absent from the reference)
# ---------------------------------------------------------------------------- #
_C.TPU = TPU = CN()
TPU.compute_dtype = "auto"                # "auto": f32 on TPU, f64 on CPU x64
TPU.remat = True                          # jax.checkpoint on substeps/env steps
TPU.loss_block = 20                       # env steps per trajectory sample block
TPU.use_pallas = "auto"                   # "auto" | True | False: pallas hot ops
TPU.tile_c = "auto"                       # chunked-kernel particle tile:
                                          # "auto" = per-scene (mpm.auto_chunk_tile);
                                          # int overrides; env SOFTMAC_TPU_TILE_C wins


def get_cfg_defaults():
    return _C.clone()
