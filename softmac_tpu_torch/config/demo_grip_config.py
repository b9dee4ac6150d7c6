"""Grip scene (plasticine block squeezed by a 2-finger gripper) — values
mirror the reference's ``softmac/config/demo_grip_config.py``."""
import math

from softmac_tpu_torch.config.node import CN

_C = CN()
cfg = _C
_C.control_mode = "rigid"
_C.env_dt = 1e-3
gravity = (0.0, -9.8, 0.0)

_C.SIMULATOR = CN()
_C.SIMULATOR.dim = 3
_C.SIMULATOR.quality = 1
_C.SIMULATOR.yield_stress = 30.0
_C.SIMULATOR.dtype = "float64"
_C.SIMULATOR.max_steps = 2048
_C.SIMULATOR.E = 3e3
_C.SIMULATOR.nu = 0.2
_C.SIMULATOR.ground_friction = 20.0
_C.SIMULATOR.gravity = (0.0, -9.8, 0.0)
_C.SIMULATOR.dt = 2e-4
_C.SIMULATOR.n_controllers = 0
_C.SIMULATOR.ptype = 0           # plastic
_C.SIMULATOR.material_model = 0  # corotated
_C.SIMULATOR.collision_type = 2  # mixed / forecast

_C.SHAPES = [
    {
        "shape": "predefined",
        "offset": (0.0, 0.00, 0.0),
        "path": "envs/grip/grip_mpm_init_state.npy",
        "color": ((121 << 16) + (36 << 8) + 13),
    }
]

_C.RIGID = RIGID = CN()
RIGID.gravity = gravity
RIGID.init_state = (
    0.0, 0.0,    # finger positions
    0.0, 0.0,    # finger velocities
)

Gripper = CN()
Gripper.friction = 0.001
Gripper.urdf_path = "assets/gripper/gripper.urdf"
Gripper.enable_external_force = True

_C.PRIMITIVES = [Gripper]

_C.RENDERER = RENDERER = CN()
RENDERER.mode = "rgb_array"
RENDERER.light_rot = (-1 * math.pi / 6, 0)
RENDERER.camera_pos = (1.0, 0.8, 2.5)
RENDERER.camera_rot = (-0.25, 0.24)

_C.ENV = ENV = CN()
ENV.loss_type = "GripLoss"
loss = ENV.loss = CN()
loss.weight = (1.0, 0.0, 0.0)  # chamfer, pose, velocity
loss.target_path = "envs/grip/grip_mpm_target_position.npy"


# TPU: active grid window (exact; rollouts report window_overflow if exceeded)
_C.TPU = TPU = CN()
TPU.active_window = (32, 24, 32)

_C.VARIANTS = list()


def get_cfg_defaults():
    return _C.clone()
