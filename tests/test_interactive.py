"""Interactive sim control surface (sim/interactive.py, VERDICT r3 missing
#5): the vendored `simulate` GUI's pause/slow-motion/perturbation/noise
controls as a viewer-independent state machine, unit-tested without a GUI
(the passive viewer adds mouse perturbation natively)."""
import numpy as np

from bipedal_nmpc.sim.interactive import NoiseConfig, SimInteraction


def test_pause_and_speed_keys():
    s = SimInteraction()
    assert not s.paused and s.speed == 1.0
    s.key_callback(32)  # SPACE
    assert s.paused
    s.key_callback(32)
    assert not s.paused
    s.key_callback(ord("-"))
    s.key_callback(ord("-"))
    assert s.speed == 0.25 and s.sleep_factor() == 4.0
    for _ in range(10):
        s.key_callback(ord("-"))
    assert s.speed >= 1.0 / 16.0  # floored
    for _ in range(10):
        s.key_callback(ord("="))
    assert s.speed == 1.0  # capped at real time


def test_push_alternates_and_expires():
    s = SimInteraction(push_force=100.0, push_duration=0.1)
    assert s.push_wrench(0.0) is None
    s.key_callback(ord("p"))
    w = s.push_wrench(0.0)
    assert w is not None and abs(w[1]) == 100.0
    sign1 = np.sign(w[1])
    # still active within the window, gone after
    assert s.push_wrench(0.05) is not None
    assert s.push_wrench(0.2) is None
    s.key_callback(ord("p"))
    w2 = s.push_wrench(0.3)
    assert np.sign(w2[1]) == -sign1  # alternates direction


def test_noise_toggle_and_application():
    s = SimInteraction(noise=NoiseConfig(gyro=0.1, accel=0.5, joint_pos=0.01, joint_vel=0.1))
    imu = {"imu_quat": np.array([1.0, 0, 0, 0]), "imu_gyro": np.zeros(3), "imu_acc": np.zeros(3)}
    qj, dqj = np.zeros(5), np.zeros(5)
    i2, q2, d2 = s.corrupt_sensors(imu, qj, dqj)
    assert np.all(i2["imu_gyro"] == 0) and np.all(q2 == 0)  # off by default
    s.key_callback(ord("n"))
    i3, q3, d3 = s.corrupt_sensors(imu, qj, dqj)
    assert np.any(i3["imu_gyro"] != 0) and np.any(q3 != 0) and np.any(d3 != 0)
    assert np.all(i3["imu_quat"] == imu["imu_quat"])  # quat left clean
    assert np.all(imu["imu_gyro"] == 0)  # input dict not mutated
    s.key_callback(ord("n"))
    i4, _, _ = s.corrupt_sensors(imu, qj, dqj)
    assert np.all(i4["imu_gyro"] == 0)
