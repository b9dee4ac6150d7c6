"""Door scene (elastic boxes push a revolute door; MPM particle control) —
values mirror the reference's ``softmac/config/demo_door_config.py``."""
import math

from softmac_tpu_torch.config.node import CN

_C = CN()
cfg = _C
_C.control_mode = "mpm"
_C.env_dt = 1e-3
gravity = (0.0, -9.8, 0.0)

_C.SIMULATOR = CN()
_C.SIMULATOR.dim = 3
_C.SIMULATOR.quality = 1
_C.SIMULATOR.yield_stress = 50.0
_C.SIMULATOR.dtype = "float64"
_C.SIMULATOR.max_steps = 3072
_C.SIMULATOR.E = 50.0
_C.SIMULATOR.nu = 0.2
_C.SIMULATOR.ground_friction = 0.0
_C.SIMULATOR.gravity = (0.0, 0.0, 0.0)
_C.SIMULATOR.ptype = 1           # elastic
_C.SIMULATOR.material_model = 0  # corotated
_C.SIMULATOR.n_controllers = 1
_C.SIMULATOR.dt = 1e-3
_C.SIMULATOR.collision_type = 2  # mixed / forecast
# the door is thin and fast once slamming: the uncapped penetration push
# (sdf/dt)*life tunnels particles through it and amplifies to ejection
# (~1e8 positions within 150 steps of the first slam). 1 m/s is far above
# any physical speed in this scene.
_C.SIMULATOR.contact_push_velocity_cap = 1.0
# bound transport to 0.5 grid cells per substep (7.8 m/s here — far above
# any healthy speed in this scene; elastic spikes during the slam dissipate
# instead of amplifying to ejection)
_C.SIMULATOR.cfl_velocity_clamp = 0.5

_C.SHAPES = [
    {
        "shape": "box",
        "width": (0.04, 0.05, 0.03),
        "init_pos": [0.685, 0.15, 0.345],
        "n_particles": 1200,
        "color": ((121 << 16) + (36 << 8) + 13),
        "init_rot": None,
    },
    {
        "shape": "box",
        "width": (0.03, 0.05, 0.07),
        "init_pos": [0.65, 0.15, 0.365],
        "n_particles": 2100,
        "color": ((121 << 16) + (36 << 8) + 13),
        "init_rot": None,
    },
    {
        "shape": "box",
        "width": (0.03, 0.05, 0.14),
        "init_pos": [0.72, 0.15, 0.4],
        "n_particles": 2100,
        "color": ((121 << 16) + (36 << 8) + 13),
        "init_rot": None,
    },
]

_C.RIGID = RIGID = CN()
RIGID.gravity = gravity
RIGID.init_state = (
    0.0,    # hinge angle
    0.0,    # hinge velocity
)
RIGID.ext_grad_scale = 1.0 / 40.0   # mpm->rigid gradient damping (demo_door.py:116)
# hinge damping: the 0.011 kg door (I_axis 7.8e-6) otherwise spins to its
# URDF velocity limit under any sustained contact torque and slams
# bang-bang. 5e-4 (decay time ~16 steps) also keeps the door's late-window
# angle a function of LATE pushes, which keeps the pose-loss gradients
# short-horizon instead of chaotic 3000-step chains.
RIGID.joint_damping = 5e-4

Door = CN()
Door.friction = 0.001
Door.urdf_path = "assets/door/door.urdf"
Door.enable_external_force = True

_C.PRIMITIVES = [Door]

_C.RENDERER = RENDERER = CN()
RENDERER.mode = "rgb_array"
RENDERER.light_rot = (-1 * math.pi / 6, 0)
RENDERER.camera_pos = (0.5, 1.5, 1.6)
RENDERER.camera_rot = (-0.9, 0.0)

_C.ENV = ENV = CN()
ENV.loss_type = "DoorLoss"
loss = ENV.loss = CN()
loss.weight = (1.0, 0.0, 0.0)  # pose, velocity, contact
loss.target_path = ""
ENV.n_observed_particles = 200


# TPU: active grid window (exact; rollouts report window_overflow if exceeded)
_C.TPU = TPU = CN()
TPU.active_window = (32, 16, 32)

_C.VARIANTS = list()


def get_cfg_defaults():
    return _C.clone()
