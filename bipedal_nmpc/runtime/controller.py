"""The full control cascade — BipedalController equivalent.

Per control tick (reference: BipedalController::update, cpp:186-276):
estimate -> observation -> (async) MPC replan -> policy interpolation ->
WBC torque QP -> hybrid joint command (posDes, velDes, kp, kd, tau_ff).

Host-side object orchestrating jitted device stages; on the device the MPC and the
WBC are separate compiled programs and the 50 Hz / 400 Hz split of the
reference's two threads becomes asynchronous device dispatch (the solve is
enqueued non-blocking; the control path consumes the last completed policy).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..interface import RobotInterface
from ..utils.precision import default_matmul_precision
from ..utils.timing import RepeatedTimer
from ..wbc.tasks import WbcTaskConfig
from ..wbc.weighted_wbc import wbc_update
from .mpc_runner import MpcRunner
from .mrt import evaluate_policy
from .safety import check_orientation


class JointCommand(NamedTuple):
    """HybridJointHandle::setCommand payload (HybridJointInterface.h:66-72)."""

    pos_des: np.ndarray
    vel_des: np.ndarray
    kp: np.ndarray
    kd: np.ndarray
    tau_ff: np.ndarray


@dataclasses.dataclass
class ControllerConfig:
    mpc_frequency: float = 50.0
    use_feedback_policy: bool = True
    joint_kp: float = 80.0  # BipedalControllerParams.cfg leg_motor_*_kp default
    joint_kd: float = 5.0
    # Asynchronous MPC worker (the reference's defining runtime split:
    # BipedalController.cpp:319-352 MPC thread at 50 Hz feeding the 400 Hz
    # control thread through a lock-free policy buffer).  When True the MPC
    # solve runs on a background thread publishing through the native
    # seqlock slot and update() never blocks on a solve; when False the
    # replan happens synchronously inside the tick (dummy-loop style).
    mpc_async: bool = False
    # State-estimator selection: "cheater" consumes ground-truth rbdState
    # (FromTopicStateEstimate semantics); "kalman" runs the contact LKF on
    # IMU + joint sensors via update_from_sensors (the estimator the
    # reference declares but never implemented — LinearKalmanFilter.h:27-67).
    estimator: str = "cheater"
    # Optional in-process WBC weight override (dynamic_reconfigure analogue,
    # BipedalController.cpp:407-478).  Persistent tuning belongs in the
    # robot's overrides.info overlay (configs/<robot>/overrides.info, applied
    # and logged by the config loader) — H1's stability-critical
    # weight.baseAccel 10.0 lives there, not here.
    weight_base_accel: float | None = None
    # Torque-path backend: "host" closes the WBC QP in numpy + the native
    # ADMM kernel on the CPU (the reference's architecture — qpOASES on the
    # host inside the 2.5 ms tick, WeightedWbc.cpp:53-81; zero device
    # dispatches on the tick path); "device" keeps the jitted WBC (useful
    # when the controller itself runs device-side or for A/B tests).
    wbc_backend: str = "host"
    # First-order low-pass on the MEASURED joint velocities (Hz; 0 = off).
    # Contact impacts ring single-tick velocity spikes through light links
    # (measured 188-281 rad/s on Hunter's gram-scale feet at lift-off),
    # which poison both the PD damping term (kd * 280 -> torque-clip
    # chatter that pumps the robot off the ground) and the MPC's momentum
    # observation.  Hardware drivers filter encoder velocities the same
    # way; 0 keeps the raw signal (the default for the heavier robots,
    # whose loops are validated unfiltered).
    joint_vel_lpf_hz: float = 0.0


def wbc_config_from_task(task) -> WbcTaskConfig:
    return WbcTaskConfig(
        torque_limit_per_leg=tuple(task.wbc.torque_limits),
        friction_coefficient=task.wbc.friction_coefficient,
        swing_kp=task.wbc.swing_kp,
        swing_kd=task.wbc.swing_kd,
        base_kp=tuple(task.wbc.base_kp),
        base_kd=tuple(task.wbc.base_kd),
        no_contact_motion_tolerance=task.wbc.no_contact_motion_tolerance,
        weight_swing_leg=task.wbc.weight_swing_leg,
        weight_base_accel=task.wbc.weight_base_accel,
        weight_contact_force=task.wbc.weight_contact_force,
    )


class BipedalController:
    def __init__(
        self,
        iface: RobotInterface,
        cfg: ControllerConfig | None = None,
        reference_manager=None,
    ):
        self.iface = iface
        self.cfg = cfg or ControllerConfig()
        # an externally built manager carries deployment state the default
        # lacks (e.g. a terrain_fn sampled from the world — sim/terrain.py)
        self.mpc = MpcRunner(iface, reference_manager=reference_manager)
        self.wbc_cfg = wbc_config_from_task(iface.task)
        if self.cfg.weight_base_accel is not None:
            self.wbc_cfg = dataclasses.replace(
                self.wbc_cfg, weight_base_accel=self.cfg.weight_base_accel
            )
        self.last_yaw = 0.0
        self.last_mpc_time = -np.inf
        # per-joint PD gains, live-tunable via set_joint_gains
        self.joint_kp = np.full(iface.info.nj, self.cfg.joint_kp)
        self.joint_kd = np.full(iface.info.nj, self.cfg.joint_kd)
        self.last_wbc_decision = None
        self.safe = True
        self.wbc_timer = RepeatedTimer("wbc")
        # full tick including the WBC QP (the deployment budget, task.info:178);
        # tick_ex_timer keeps the QP-excluded view for diagnosis
        self.tick_timer = RepeatedTimer("tick")
        self.tick_ex_timer = RepeatedTimer("tick_ex_wbc")
        self.staleness: list[float] = []  # t_tick - t_obs of consumed policy
        self.last_observation: tuple[float, np.ndarray] | None = None  # (t, x_obs)
        self.last_frozen = None
        self.async_mpc = None
        if self.cfg.mpc_async:
            from .async_mpc import AsyncMpcRunner

            self.async_mpc = AsyncMpcRunner(self.mpc, self.cfg.mpc_frequency)
        self.estimator = None
        if self.cfg.estimator == "kalman":
            from ..estim.estimator import KalmanStateEstimator

            self.estimator = KalmanStateEstimator(iface.model, iface.info)
        elif self.cfg.estimator != "cheater":
            raise ValueError(f"unknown estimator {self.cfg.estimator!r}")

        model, info = iface.model, iface.info
        wbc_cfg = self.wbc_cfg

        self.host_wbc = None
        self._wbc = None
        if self.cfg.wbc_backend == "host":
            from ..wbc.host_wbc import HostWbc

            self.host_wbc = HostWbc(model, info, wbc_cfg)
        elif self.cfg.wbc_backend == "device":

            @jax.jit
            def _wbc(x_des, u_des, rbd, flags):
                with default_matmul_precision(getattr(iface.task, "matmul_precision", None)):
                    return wbc_update(model, info, wbc_cfg, x_des, u_des, rbd, flags)

            self._wbc = _wbc
        else:
            raise ValueError(f"unknown wbc_backend {self.cfg.wbc_backend!r}")
        # observation runs host-side: the tick path must never dispatch to
        # the accelerator (model/host_model.py docstring).  The C++ kernel
        # (native/host_model.cc) computes it when available; numpy otherwise.
        from ..model.host_model import make_host_model

        self._hm = make_host_model(model, info)
        self._nm = None
        if self.host_wbc is not None and self.host_wbc.native_model is not None:
            self._nm = self.host_wbc.native_model
        else:
            from ..model.native_model import make_native_model

            self._nm = make_native_model(self._hm)

    # ------------------------------------------------------------------
    def starting(self, t: float, rbd_measured) -> None:
        """Reset + blocking initial solve (BipedalController::starting); in
        async mode the initial solve also primes the worker, which then
        replans in the background (cpp:147-157 initial-policy sync loop)."""
        self.last_yaw = float(rbd_measured[0])
        if self.host_wbc is not None:
            self.host_wbc.reset()
        x_obs = self._observation(rbd_measured)
        if self.async_mpc is not None:
            self.async_mpc.prime(t, np.asarray(x_obs))
            self.async_mpc.start()
        else:
            self.mpc.reset()
            self.mpc.advance(t, x_obs)
        self.last_mpc_time = t
        self.safe = True

    def stop(self) -> None:
        """Join the MPC worker (controller unload)."""
        if self.async_mpc is not None:
            self.async_mpc.stop()

    def _planned_flags(self, t: float) -> np.ndarray:
        """Planned contact flags at t from the latest policy's gait table;
        all-stance before the first policy (the reference hardcodes STANCE,
        BipedalController.cpp:372-377 — we do better once a plan exists)."""
        if self.async_mpc is not None:
            snap = self.async_mpc.poll_policy()
            if snap is not None:
                from .async_mpc import contact_flags_at_np

                return contact_flags_at_np(snap, t)
        elif self.mpc.last_frozen is not None:
            return np.asarray(self.mpc.last_frozen.gait.contact_flags_at(jnp.asarray(t)))
        return np.ones(4)

    def starting_from_sensors(
        self, t: float, imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel,
        base_pos_guess,
    ) -> None:
        """Kalman-estimator bring-up: seed the LKF at the known initial pose
        (the initial-pose controller hands over from a known configuration),
        then run the normal blocking initial solve."""
        assert self.estimator is not None, "configure estimator='kalman'"
        self.estimator.reset(imu_quat_wxyz, joint_pos, base_pos_guess)
        rbd = self.estimator.update(
            imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel, np.ones(4)
        )
        self.starting(t, jnp.asarray(rbd))

    def update_from_sensors(
        self, t: float, imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel,
        contact_flags_meas=None,
    ) -> JointCommand:
        """One control tick from raw sensors: LKF estimate -> cascade.
        contact_flags_meas (a contact-sensor readout, when the platform has
        one) overrides the planned gait flags fed to the filter."""
        assert self.estimator is not None, "configure estimator='kalman'"
        flags = (
            np.asarray(contact_flags_meas, dtype=float)
            if contact_flags_meas is not None
            else self._planned_flags(t)
        )
        rbd = self.estimator.update(
            imu_quat_wxyz, gyro_local, accel_local, joint_pos, joint_vel, flags
        )
        return self.update(t, jnp.asarray(rbd), contact_flags_meas=flags)

    # -- runtime reconfigure (dynamic_reconfigure analogue,
    #    BipedalController.cpp:407-478: WBC weights + per-motor PD gains
    #    tunable on a RUNNING controller) --------------------------------
    WBC_WEIGHT_FIELDS = {
        "baseAccel": "weight_base_accel",
        "swingLeg": "weight_swing_leg",
        "contactForce": "weight_contact_force",
    }

    def set_wbc_weight(self, name: str, value: float) -> None:
        """Change one WBC task weight live (task.info weight.* names)."""
        field = self.WBC_WEIGHT_FIELDS.get(name)
        if field is None:
            raise ValueError(
                f"unknown WBC weight {name!r} (try {sorted(self.WBC_WEIGHT_FIELDS)})"
            )
        self.wbc_cfg = dataclasses.replace(self.wbc_cfg, **{field: float(value)})
        if self.host_wbc is not None:
            # constant rows rebuilt; ADMM warm-start state survives
            self.host_wbc.replace_config(self.wbc_cfg)
        else:
            model, info, wbc_cfg = self.iface.model, self.iface.info, self.wbc_cfg
            _mm = getattr(self.iface.task, "matmul_precision", None)

            @jax.jit
            def _wbc(x_des, u_des, rbd, flags):
                with default_matmul_precision(_mm):
                    return wbc_update(model, info, wbc_cfg, x_des, u_des, rbd, flags)

            self._wbc = _wbc

    def set_joint_gains(self, pattern: str, kp: float, kd: float) -> int:
        """Set PD gains on every joint whose name contains ``pattern``
        (empty pattern = all).  Matching by substring gives the reference's
        left/right mirroring for free ('hip_pitch' hits both legs).
        Returns the number of joints changed."""
        names = list(self.iface.task.joint_names)
        hits = 0
        for j, nm in enumerate(names):
            if pattern in nm:
                self.joint_kp[j] = float(kp)
                self.joint_kd[j] = float(kd)
                hits += 1
        return hits

    def set_gait(self, template, start_time: float) -> None:
        """Gait command entry point, safe in both modes (GaitReceiver)."""
        if self.async_mpc is not None:
            self.async_mpc.set_gait(template, start_time)
        else:
            self.mpc.rm.set_gait(template, start_time)

    def set_target(self, target) -> None:
        """Target-trajectory command (TargetTrajectoriesPublisher sink)."""
        if self.async_mpc is not None:
            self.async_mpc.set_target(target)
        else:
            self.mpc.rm.set_target(target)

    def report(self) -> dict:
        """Runtime timing/staleness summary (the shutdown printout of
        BipedalController.cpp:44-50, plus the policy-staleness metric)."""
        out = {
            "tick": self.tick_timer.stats(),
            "tick_ex_wbc": self.tick_ex_timer.stats(),
            "wbc": self.wbc_timer.stats(),
        }
        if self.staleness:
            arr = np.asarray(self.staleness)
            out["policy_staleness_s"] = {
                "p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "max": float(arr.max()),
            }
        if self.async_mpc is not None:
            out["mpc"] = self.async_mpc.solve_timer.stats()
            out["mpc_solves"] = self.async_mpc.solve_count
        else:
            out["mpc"] = self.mpc.timer.stats()
        return out

    def _observation(self, rbd_measured):
        from ..model.host_model import centroidal_state_from_rbd_np

        if self._nm is not None:
            x = self._nm.observation(np.asarray(rbd_measured))
        else:
            x = centroidal_state_from_rbd_np(self._hm, np.asarray(rbd_measured))
        # yaw continuity (BipedalController.cpp:400-403): shift by 2*pi
        # multiples to land nearest the previous yaw (numpy unwrap_near)
        yaw = x[9]
        yaw = self.last_yaw + (np.mod(yaw - self.last_yaw + np.pi, 2 * np.pi) - np.pi)
        self.last_yaw = float(yaw)
        x[9] = yaw
        return x

    def update(self, t: float, rbd_measured, contact_flags_meas=None) -> JointCommand:
        """One 400-500 Hz control tick.  In async mode this never blocks on
        an MPC solve: it publishes the observation, consumes the newest
        policy snapshot, and evaluates it host-side (BipedalHWLoop consumer
        semantics)."""
        import time as _time

        tick_t0 = _time.perf_counter()
        rbd = np.asarray(rbd_measured)
        if self.cfg.joint_vel_lpf_hz > 0.0:
            nj = self.iface.info.nj
            dqj = rbd[12 + nj : 12 + 2 * nj]
            prev = getattr(self, "_dqj_filt", None)
            t_prev = getattr(self, "_lpf_t", None)
            if prev is None or t_prev is None or t <= t_prev:
                filt = dqj.copy()
            else:
                a = 1.0 - np.exp(
                    -2.0 * np.pi * self.cfg.joint_vel_lpf_hz * (t - t_prev)
                )
                filt = prev + a * (dqj - prev)
            self._dqj_filt, self._lpf_t = filt, t
            rbd = rbd.copy()
            rbd[12 + nj : 12 + 2 * nj] = filt
        x_obs = self._observation(rbd)
        self.last_observation = (t, x_obs)

        if not check_orientation(rbd):
            self.safe = False
        if not self.safe:
            nj = self.iface.info.nj
            zero = np.zeros(nj)
            return JointCommand(zero, zero, zero, self.joint_kd.copy(), zero)

        if self.async_mpc is not None:
            from .async_mpc import contact_flags_at_np, evaluate_policy_np

            # worker died on an exception -> controller stop (the reference
            # shuts the controller down on an MPC-thread exception)
            if self.async_mpc.failed:
                self.safe = False
                nj = self.iface.info.nj
                zero = np.zeros(nj)
                return JointCommand(zero, zero, zero, self.joint_kd.copy(), zero)
            x_np = np.asarray(x_obs)
            self.async_mpc.set_observation(t, x_np)
            snap = self.async_mpc.poll_policy()
            self.staleness.append(t - snap.t_obs)
            pol = evaluate_policy_np(
                snap, t, x_np, use_feedback=self.cfg.use_feedback_policy
            )
            x_star, u_fb = pol.x_star, pol.u_fb
            flags = contact_flags_at_np(snap, t)
        else:
            # synchronous replan at mpcDesiredFrequency (dummy-loop style)
            if t - self.last_mpc_time >= 1.0 / self.cfg.mpc_frequency - 1e-9:
                self.mpc.advance(t, x_obs)
                self.last_mpc_time = t
            sol = self.mpc.last_solution
            pol = evaluate_policy(sol, t, x_obs, use_feedback=self.cfg.use_feedback_policy)
            x_star, u_fb = pol.x_star, pol.u_fb
            # planned contact flags at t from the frozen gait of this solve
            flags = self.mpc.last_frozen.gait.contact_flags_at(jnp.asarray(t))

        t_pre_wbc = _time.perf_counter()
        with self.wbc_timer:
            if self.host_wbc is not None:
                # host torque path: numpy kinematics + native ADMM, zero
                # device dispatches (the reference's qpOASES-on-CPU split)
                decision_host = self.host_wbc.update(
                    np.asarray(x_star), np.asarray(u_fb), rbd, np.asarray(flags, dtype=float)
                ).decision
            else:
                res = self._wbc(x_star, u_fb, rbd, flags)
                decision_host = np.asarray(res.decision)  # device sync + host copy
        t_post_wbc = _time.perf_counter()
        # qpOASES-failure fallback: reuse last solution (WeightedWbc.cpp:77-81).
        # Only genuine failures (non-finite) reject; finite-iteration ADMM
        # residuals are normal and must not freeze the torque on a stale value.
        if np.all(np.isfinite(decision_host)) or self.last_wbc_decision is None:
            decision = decision_host
            self.last_wbc_decision = decision
        else:
            decision = self.last_wbc_decision

        nj = self.iface.info.nj
        tau = decision[-nj:]
        pos_des = np.asarray(x_star)[12 : 12 + nj]
        vel_des = np.asarray(u_fb)[12:]
        cmd = JointCommand(
            pos_des=pos_des,
            vel_des=vel_des,
            kp=self.joint_kp.copy(),
            kd=self.joint_kd.copy(),
            tau_ff=tau,
        )
        t_end = _time.perf_counter()
        self.tick_timer.samples.append(t_end - tick_t0)
        self.tick_ex_timer.samples.append((t_pre_wbc - tick_t0) + (t_end - t_post_wbc))
        return cmd
