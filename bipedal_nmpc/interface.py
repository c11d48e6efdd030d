"""Robot interface factory — the BipedalRobotInterface equivalent.

Assembles everything a solver/controller needs from a URDF + config files
(reference: ocs2_bipedal_robot/src/BipedalRobotInterface.cpp:67-204
setupOptimalConrolProblem): reduced JAX model, centroidal info, cost weights
(with the task-space R mapping), OCP settings, and a ReferenceManager
initialized from reference.info/gait.info.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .config.loader import TaskConfig, build_input_cost_weight, load_task_config
from .gait.mode_schedule import GaitSchedule, ModeSchedule
from .gait.swing import SwingConfig
from .model.centroidal import CentroidalModelInfo, make_info
from .model.robot_model import RobotModel, from_description
from .model.urdf import load_urdf
from .ocp.problem import OcpSettings
from .reference.manager import ReferenceManager
from .reference.target import CommandConfig, TargetTrajectories
from .robots import ASSETS_ENV, RobotAssets, get_assets


@dataclasses.dataclass
class RobotInterface:
    """Bundle of model + problem data (getOptimalControlProblem analogue)."""

    model: RobotModel
    info: CentroidalModelInfo
    settings: OcpSettings
    Q: jnp.ndarray
    R: jnp.ndarray
    task: TaskConfig
    command_config: CommandConfig

    @property
    def initial_state(self) -> np.ndarray:
        return self.task.initial_state

    def make_reference_manager(self) -> ReferenceManager:
        """Fresh host-side reference manager seeded from reference.info."""
        init_sched = self.task.initial_mode_schedule
        gait = GaitSchedule(
            ModeSchedule(list(init_sched.event_times), list(init_sched.mode_sequence)),
            self.task.default_gait,
            self.task.phase_transition_stance_time,
        )
        x0 = self.task.initial_state
        target = TargetTrajectories(
            times=np.array([0.0]),
            states=x0[None, :].copy(),
            inputs=np.zeros((1, self.info.input_dim)),
        )
        # Size the static phase table for the densest gait in this robot's
        # library: freeze() tiles over [t0-T, tf+T] (3 horizons), so a gait
        # with short phases (e.g. G1's standing trot) needs more slots than
        # the H1-tuned default of 24.  Static per robot, so the jitted solve
        # never recompiles on a gait switch.
        min_phase = self.task.mpc.time_horizon  # upper bound
        for tpl in self.task.gait_library.values():
            if len(tpl.mode_sequence) > 1 and tpl.duration > 0:
                min_phase = min(min_phase, tpl.duration / len(tpl.mode_sequence))
        needed = int(np.ceil(3.0 * self.task.mpc.time_horizon / max(min_phase, 1e-3))) + 8
        # body-frame contact xy offsets at the nominal pose (for the terrain
        # feed's foot-placement prediction; yaw-rotated at query time)
        from .model.kinematics import forward_kinematics, frame_position

        kin = forward_kinematics(self.model, np.asarray(x0)[6:])
        offsets = np.stack(
            [
                np.asarray(frame_position(self.model, kin, fid))[:2] - x0[6:8]
                for fid in self.info.contact_frame_ids
            ]
        )
        return ReferenceManager(
            gait_schedule=gait,
            swing_config=self.task.swing,
            target=target,
            horizon=self.task.mpc.time_horizon,
            num_intervals=self.settings.num_intervals,
            max_phases=max(24, needed),
            foot_xy_offsets=offsets,
        )


def ocp_settings_from_task(task) -> OcpSettings:
    """task.info sqp/ipm blocks -> OcpSettings.  When the task selects the
    hard cone (useAnalyticalGradientsConstraints, the reference's IPM
    configuration) the `ipm` block binds onto the barrier continuation:
    targetBarrierParameter -> cone_mu_final, barrierLinearDecreaseFactor ->
    cone_mu_decay, ipmIteration floors the iteration count (see
    config/loader.py::IpmConfig for the mapping rationale)."""
    import dataclasses as _dc

    settings = OcpSettings(
        dt=task.sqp.dt,
        horizon=task.mpc.time_horizon,
        sqp_iterations=task.sqp.sqp_iterations,
        friction_coefficient=task.friction_coefficient,
        cone=task.cone_mode,
        barrier_mu=task.sqp.inequality_constraint_mu,
        barrier_delta=task.sqp.inequality_constraint_delta,
        position_error_gain=task.position_error_gain,
        integrator=task.sqp.integrator,
    )
    if task.cone_mode == "hard":
        settings = _dc.replace(
            settings,
            sqp_iterations=max(task.ipm.iterations, settings.sqp_iterations),
            cone_mu_decay=task.ipm.decrease_factor,
            cone_mu_final=task.ipm.target_barrier,
        )
    # the same ipm block drives the primal-dual path when the user selects
    # cone="ipm" (dataclasses.replace on settings): central-path schedule +
    # fraction-to-boundary margin straight from task.info:86-156
    settings = _dc.replace(
        settings,
        ipm_mu_init=max(task.ipm.initial_barrier, task.ipm.target_barrier),
        ipm_mu_target=task.ipm.target_barrier,
        ipm_mu_decay=task.ipm.decrease_factor,
        ipm_fraction_to_boundary=task.ipm.fraction_to_boundary,
    )
    return settings


def make_interface(
    urdf_path: str,
    task_file: str,
    reference_file: str,
    gait_file: str | None = None,
    overrides_file: str | None = None,
    extra_gait_file: str | None = None,
) -> RobotInterface:
    task = load_task_config(
        task_file, reference_file, gait_file, overrides_file, extra_gait_file
    )
    # Upper-body joints are welded at the *held* pose (defaultUpperJointState,
    # what UpperJointController actually commands) rather than at zero.  The
    # reference's reduced pinocchio model welds at zero
    # (createPinocchioInterface with jointNames), which misplaces the torso
    # CoM by the held-arm offset — significant for OpenLoong's +-1.6 rad arm
    # pose, mild for H1's bent elbows.
    locked = {}
    if task.upper_joint_names and task.default_upper_joint_state is not None:
        locked = dict(
            zip(task.upper_joint_names, (float(v) for v in task.default_upper_joint_state))
        )
    desc = load_urdf(
        urdf_path,
        task.joint_names,
        locked_joint_positions=locked or None,
        extra_frames=task.extra_frames or None,
    )
    model = from_description(desc)
    # nominal joints for SRBD = initial-state joints, like the reference's
    # createCentroidalModelInfo(..., initialState) (BipedalRobotInterface.cpp:120-123)
    info = make_info(
        model,
        task.contact_names,
        model_type=task.centroidal_model_type,
        q_j_nominal=tuple(task.initial_state[12:]) if task.centroidal_model_type == 1 else (),
    )
    R = build_input_cost_weight(model, info, task.R_task, task.initial_state)
    settings = ocp_settings_from_task(task)
    command_config = CommandConfig(
        com_height=task.com_height,
        default_joint_state=task.default_joint_state,
        target_displacement_velocity=task.target_displacement_velocity,
        target_rotation_velocity=task.target_rotation_velocity,
    )
    return RobotInterface(
        model=model,
        info=info,
        settings=settings,
        Q=jnp.asarray(task.Q),
        R=jnp.asarray(R),
        task=task,
        command_config=command_config,
    )


def make_interface_for(robot: str | RobotAssets) -> RobotInterface:
    assets = get_assets(robot) if isinstance(robot, str) else robot
    if assets.task_info is None:
        raise ValueError(
            f"robot '{assets.name}' ships description only (no task config); "
            "pass explicit files to make_interface()"
        )
    missing = assets.missing_files()
    if missing:
        raise FileNotFoundError(
            f"robot '{assets.name}' needs files that are not on disk: "
            + ", ".join(missing)
            + f". Only g1 ships in this repository; set ${ASSETS_ENV} to a "
            "reference-layout asset tree (bipedal_robot_example/...) for the others."
        )
    return make_interface(
        assets.urdf,
        assets.task_info,
        assets.reference_info,
        assets.gait_info,
        overrides_file=assets.overrides_info,
        extra_gait_file=assets.extra_gait_info,
    )
