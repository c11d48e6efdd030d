"""bipedal_nmpc — an accelerator-native NMPC + WBC control framework for bipedal robots.

A from-scratch JAX/XLA/Pallas re-design of the capability set of
zitongbai/bipedal_control (OCS2 SQP NMPC + weighted whole-body QP + gait logic
+ swing planning + state estimation + sim backends), built for the device:

- all compute-path math (rigid-body kinematics/dynamics, centroidal model,
  OCP linearization, Riccati, WBC QP) is pure, jittable JAX with static shapes;
- mode-dependent constraint *activation* of the reference becomes constraint
  *masking* so thousands of scenarios batch over `vmap` and device meshes;
- the horizon Riccati sweep is a scan (sequential and associative-scan
  variants) instead of the reference's sequential HPIPM recursion.

Reference layer map: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"
