"""Taco scene (plasticine wrapped by an attachment-controlled tortilla cloth)
— values mirror the reference's ``soft_cloth/config/demo_taco_config.py``."""
import math

from softmac_tpu_torch.config.node import CN

_C = CN()
cfg = _C
_C.control_mode = "mpm"
_C.env_dt = 2e-3
_C.mpm_scale = 5.0

_C.SIMULATOR = CN()
_C.SIMULATOR.dim = 3
_C.SIMULATOR.quality = 1
_C.SIMULATOR.yield_stress = 60.0
_C.SIMULATOR.dtype = "float64"
_C.SIMULATOR.max_steps = 2048
_C.SIMULATOR.n_particles = 0
_C.SIMULATOR.E = 5000.0
_C.SIMULATOR.nu = 0.2
_C.SIMULATOR.ground_friction = 1.5
_C.SIMULATOR.gravity = (0.0, -5.0, 0.0)
_C.SIMULATOR.dt = 2e-4
_C.SIMULATOR.n_controllers = 0
_C.SIMULATOR.ptype = 0           # plastic
_C.SIMULATOR.material_model = 0  # corotated
_C.SIMULATOR.collision_type = 2  # mixed

_C.PRIMITIVES = PRIMITIVE = CN()
PRIMITIVE.friction = 1.0
PRIMITIVE.softness = 666.0
PRIMITIVE.cloth_force_scale = 1.0
PRIMITIVE.mpm_force_scale = 1.0
PRIMITIVE.sticky = True
# adjoint damping on the sticky-contact gradient edges: the two-way
# cloth<->MPM loop amplifies the backward ~2.6x per env step (forward is
# stable); 0.3 on both edges puts the loop gain at ~0.23 while keeping the
# first-order action->cloth->particle signal. See ClothContactParams.
PRIMITIVE.contact_geom_grad_scale = 0.3
PRIMITIVE.contact_cv_grad_scale = 0.3

_C.SHAPES = [
    {
        "shape": "cylinder",
        "radius": 1.25,
        "height": 0.2,
        "init_pos": [2.5, 2.105, 2.5],
        "n_particles": 10000,
        "color": ((121 << 16) + (36 << 8) + 13),
        "init_rot": None,
    },
]

_C.CLOTH = CLOTH = CN()
CLOTH.sceneConfig = [{
    "fabric:k_stiff_stretching": "5000",
    "fabric:k_stiff_bending": "1.5",
    "fabric:name": "envs/assets/tortilla/tortilla.obj",
    "fabric:keepOriginalScalePoint": "true",
    "fabric:density": "1.0",
    "timeStep": "2e-3",
    "stepNum": "200",
    "forwardConvergenceThresh": "1e-8",
    "backwardConvergenceThresh": "5e-4",
    "attachmentPoints": "CUSTOM_ARRAY",
    "gravity": "0.0",
    "customAttachmentVertexIdx": "181,205,169,193,0,1,4,7,13,19,28,37,49,76,109,148,193",
}]
CLOTH.transform = [{
    "scale": 1.5,
    "translation": [2.5, 2.0, 2.5],
}]

_C.RENDERER = RENDERER = CN()
RENDERER.mode = "rgb_array"
RENDERER.image_res = (1024, 1024)  # soft_cloth renderer default
RENDERER.ssaa = 1   # already 1024^2; skip 2048^2 rasters
RENDERER.light_rot = (-1 * math.pi / 4, 0)
RENDERER.camera_pos = (4.5, 4.2, 10.8)
RENDERER.camera_rot = (-0.2, 0.24)

_C.ENV = ENV = CN()
ENV.loss_type = "TacoLoss"
loss = ENV.loss = CN()
loss.weight = (1.0,)
loss.target_path = "envs/taco/taco_mpm_target.npy"


# TPU: active grid window (exact; rollouts report window_overflow if exceeded)
_C.TPU = TPU = CN()
TPU.active_window = (48, 24, 48)

_C.VARIANTS = list()


def get_cfg_defaults():
    return _C.clone()
