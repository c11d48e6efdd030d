"""Test configuration: run JAX on a virtual 8-device CPU mesh with float64.

Multi-device sharding paths are validated on this virtual mesh
(__graft_entry__.dryrun_multichip dry-runs them too); numeric golden tests
want float64.  Tests marked `gpu` need a card: the `gpu_device` fixture
skips them here, and `python -m pytest -m gpu tests/` runs them on one.
"""
import os

_xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _xla_flags:
    os.environ["XLA_FLAGS"] = (_xla_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_ASSETS = os.environ.get("BIPEDAL_REFERENCE_ASSETS", os.environ.get("BIPEDAL_ASSETS", ""))
H1_URDF = os.path.join(
    REFERENCE_ASSETS,
    "bipedal_robot_example/unitree_h1/h1_description/urdf/h1_with_sole.urdf",
)

H1_LEG_JOINTS = [
    "left_hip_yaw_joint",
    "left_hip_roll_joint",
    "left_hip_pitch_joint",
    "left_knee_joint",
    "left_ankle_joint",
    "right_hip_yaw_joint",
    "right_hip_roll_joint",
    "right_hip_pitch_joint",
    "right_knee_joint",
    "right_ankle_joint",
]
H1_CONTACTS = ["left_sole_1_link", "left_sole_2_link", "right_sole_1_link", "right_sole_2_link"]


def _require_h1():
    if not os.path.exists(H1_URDF):
        pytest.skip("H1 reference assets not available (set BIPEDAL_REFERENCE_ASSETS)")


@pytest.fixture(scope="session")
def h1_model():
    """Reduced H1 model (10 leg joints, upper body welded at zero)."""
    _require_h1()
    from bipedal_nmpc.model import from_description, load_urdf

    desc = load_urdf(H1_URDF, H1_LEG_JOINTS)
    return from_description(desc)


@pytest.fixture(scope="session")
def h1_info(h1_model):
    from bipedal_nmpc.model import make_info

    return make_info(h1_model, H1_CONTACTS)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip.  Decided here, at run time, never while the
    module is imported (xdist workers must all collect the same tests)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run with -m gpu on a card)")
    return devs[0]


from bipedal_nmpc.model.centroidal import make_info  # noqa: E402
from bipedal_nmpc.model.robot_model import from_description  # noqa: E402
from bipedal_nmpc.model.urdf import (  # noqa: E402
    JOINT_PRISMATIC,
    JOINT_REVOLUTE,
    RobotDescription,
)


def _rot(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def tiny_biped():
    """Hand-built 4-joint biped: left leg = skew hip revolute + revolute
    knee; right leg = revolute hip + PRISMATIC shank (both joint-type
    branches of the model code), non-identity joint/frame offsets and
    off-diagonal inertias.  Toe/heel contact frames sit on the shank bodies
    with non-identity frame rotations.  Small enough that XLA on the CPU
    compiles its OCP in seconds.  Returns (model, info)."""
    nj = 4
    axes = np.array(
        [
            [0.1, 0.99, 0.0],  # left hip: slightly skewed pitch axis
            [0.0, 1.0, 0.05],  # left knee
            [0.0, 1.0, 0.0],  # right hip
            [0.05, 0.0, 1.0],  # right prismatic shank (extension)
        ]
    )
    axes = axes / np.linalg.norm(axes, axis=1, keepdims=True)
    off_R = np.stack(
        [
            _rot([0, 0, 1], 0.1),
            _rot([1, 0, 0], -0.15),
            _rot([0, 1, 0], 0.07),
            _rot([1, 1, 0], 0.12),
        ]
    )
    off_p = np.array(
        [
            [0.01, 0.11, -0.12],
            [0.02, 0.01, -0.31],
            [0.01, -0.11, -0.12],
            [-0.015, 0.005, -0.29],
        ]
    )
    mass = np.array([9.0, 1.6, 0.9, 1.5, 0.7])
    com = np.array(
        [
            [0.01, 0.0, 0.15],
            [0.0, 0.02, -0.14],
            [0.01, -0.005, -0.17],
            [0.0, -0.02, -0.15],
            [-0.01, 0.005, -0.16],
        ]
    )
    inertia = []
    for b in range(5):
        d = 0.02 + 0.01 * b
        I = np.diag([d, d * 1.2, d * 0.8])
        I[0, 1] = I[1, 0] = 0.002
        I[1, 2] = I[2, 1] = -0.001
        inertia.append(I)
    frame_R = np.stack(
        [
            _rot([0, 1, 0], 0.05),
            _rot([0, 1, 0], -0.05),
            _rot([1, 0, 0], 0.04),
            np.eye(3),
        ]
    )
    frame_p = np.array(
        [
            [0.09, 0.0, -0.33],
            [-0.06, 0.01, -0.33],
            [0.09, -0.01, -0.31],
            [-0.06, 0.0, -0.31],
        ]
    )
    desc = RobotDescription(
        name="tiny_biped",
        joint_names=["l_hip", "l_knee", "r_hip", "r_shank"],
        joint_parent_body=np.array([0, 1, 0, 3]),
        joint_type=np.array(
            [JOINT_REVOLUTE, JOINT_REVOLUTE, JOINT_REVOLUTE, JOINT_PRISMATIC]
        ),
        joint_offset_R=off_R,
        joint_offset_p=off_p,
        joint_axis=axes,
        joint_limit_lower=-2 * np.ones(nj),
        joint_limit_upper=2 * np.ones(nj),
        joint_limit_effort=100 * np.ones(nj),
        joint_limit_velocity=20 * np.ones(nj),
        body_mass=mass,
        body_com=com,
        body_inertia=np.stack(inertia),
        frame_names=["lt", "lh", "rt", "rh"],
        frame_body=np.array([2, 2, 4, 4]),
        frame_R=frame_R,
        frame_p=frame_p,
    )
    model = from_description(desc)
    info = make_info(model, ["lt", "lh", "rt", "rh"])
    return model, info
