"""Hit scene (MPM-controlled chopstick cylinders hit a hanging towel) —
values mirror the reference's ``soft_cloth/config/demo_hit_config.py``."""
import math

from softmac_tpu_torch.config.node import CN

_C = CN()
cfg = _C
_C.control_mode = "mpm"
_C.env_dt = 2e-3

_C.SIMULATOR = CN()
_C.SIMULATOR.dim = 3
_C.SIMULATOR.quality = 1
_C.SIMULATOR.yield_stress = 50.0
_C.SIMULATOR.dtype = "float64"
_C.SIMULATOR.max_steps = 2048
_C.SIMULATOR.n_particles = 0
_C.SIMULATOR.E = 500.0
_C.SIMULATOR.nu = 0.2
_C.SIMULATOR.ground_friction = 1.5
_C.SIMULATOR.gravity = (0.0, 0.0, 0.0)
_C.SIMULATOR.dt = 2e-4
_C.SIMULATOR.n_controllers = 1
_C.SIMULATOR.ptype = 1           # elastic
_C.SIMULATOR.material_model = 0  # corotated
_C.SIMULATOR.collision_type = 2  # mixed

_C.PRIMITIVES = PRIMITIVE = CN()
PRIMITIVE.friction = 10.0
PRIMITIVE.softness = 666.0
PRIMITIVE.cloth_force_scale = 1.0
PRIMITIVE.mpm_force_scale = 1.0
PRIMITIVE.sticky = False

_C.SHAPES = [
    {
        "shape": "cylinder",
        "radius": 0.02,
        "height": 0.04,
        "init_pos": [0.46, 0.35, 0.47],
        "n_particles": 2000,
        "color": ((101 << 16) + (105 << 8) + 119),
        "init_rot": [math.cos(math.pi / 4), math.sin(math.pi / 4), 0, 0],
    },
    {
        "shape": "cylinder",
        "radius": 0.02,
        "height": 0.04,
        "init_pos": [0.54, 0.35, 0.47],
        "n_particles": 2000,
        "color": ((101 << 16) + (105 << 8) + 119),
        "init_rot": [math.cos(math.pi / 4), math.sin(math.pi / 4), 0, 0],
    },
    {
        "shape": "box",
        "width": (0.12, 0.04, 0.04),
        "init_pos": [0.5, 0.35, 0.51],
        "n_particles": 1000,
        "color": ((121 << 16) + (36 << 8) + 13),
        "init_rot": None,
    },
]

_C.CLOTH = CLOTH = CN()
CLOTH.sceneConfig = [{
    "fabric:k_stiff_stretching": "1000",
    "fabric:k_stiff_bending": "0.03",
    "fabric:name": "envs/assets/towel/towel.obj",
    "fabric:keepOriginalScalePoint": "true",
    "fabric:density": "0.2",
    "timeStep": "2e-3",
    "stepNum": "200",
    "forwardConvergenceThresh": "1e-8",
    "backwardConvergenceThresh": "5e-4",
    "attachmentPoints": "CUSTOM_ARRAY",
    "customAttachmentVertexIdx": "0,11",
}]
CLOTH.transform = [{
    "translation": [0, 0.0, -0.1],
    "rotation": {"direction": [0, 0, 1], "angle": 0},
}]
CLOTH.velocity_damping = 0.05

_C.RENDERER = RENDERER = CN()
RENDERER.mode = "rgb_array"
RENDERER.image_res = (1024, 1024)  # soft_cloth renderer default
RENDERER.ssaa = 1   # already 1024^2; skip 2048^2 rasters
RENDERER.light_rot = (-1 * math.pi / 4, 0)
RENDERER.camera_pos = (2.2, 0.8, 1.1)
RENDERER.camera_rot = (-0.2, math.pi * 3 / 8)

_C.ENV = ENV = CN()
ENV.loss_type = "HitLoss"
loss = ENV.loss = CN()
loss.weight = (1.0,)
loss.target_path = "envs/mpm2towel/towel_target_45.npy"
ENV.n_observed_particles = 200


# TPU: active grid window (exact; rollouts report window_overflow if exceeded)
_C.TPU = TPU = CN()
TPU.active_window = (32, 24, 32)

_C.VARIANTS = list()


def get_cfg_defaults():
    return _C.clone()
