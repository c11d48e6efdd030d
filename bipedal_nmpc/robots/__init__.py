"""Robot registry: locate description/config assets for the supported robots.

The framework is robot-agnostic (like the reference's C++ layers).  One robot
runs from this repository alone: the Unitree G1, from the stand-in
description and the task/reference/gait configs under configs/g1/.  The
other robots the reference ships (Unitree H1, OpenLoong, Hunter;
bipedal_robot_example/, SURVEY.md §2 items 31-33) read their URDF and task
files from a user's reference-layout asset tree, found only where
$BIPEDAL_ASSETS names it.
"""
from __future__ import annotations

import dataclasses
import os

ASSETS_ENV = "BIPEDAL_ASSETS"


@dataclasses.dataclass(frozen=True)
class RobotAssets:
    name: str
    urdf: str
    task_info: str | None
    reference_info: str | None
    gait_info: str | None
    mjcf: str | None = None
    # optional .info overlay applied on top of task.info (declarative
    # dynamic-reconfigure: runtime-tuned knobs live in a file, logged on load)
    overrides_info: str | None = None
    # optional authored gait supplements merged over the reference gait.info
    extra_gait_info: str | None = None

    def missing_files(self) -> list[str]:
        """Required description/config files that are not on disk."""
        required = (self.urdf, self.task_info, self.reference_info, self.gait_info)
        return [p for p in required if p is not None and not os.path.exists(p)]


def _local_config(rel: str) -> str:
    return os.path.normpath(os.path.join(os.path.dirname(__file__), "../../configs", rel))


def _example(rel: str) -> str:
    """Path inside the user's asset tree; a path under an unset
    $BIPEDAL_ASSETS never exists, so make_interface_for reports it."""
    root = os.environ.get(ASSETS_ENV) or f"${ASSETS_ENV}"
    return os.path.join(root, "bipedal_robot_example", rel)


def _registry() -> dict[str, RobotAssets]:
    return {
        "h1": RobotAssets(
            name="h1",
            urdf=_example("unitree_h1/h1_description/urdf/h1_with_sole.urdf"),
            task_info=_example("unitree_h1/h1_ocs2_config/config/task/task.info"),
            reference_info=_example("unitree_h1/h1_ocs2_config/config/command/reference.info"),
            gait_info=_example("unitree_h1/h1_ocs2_config/config/command/gait.info"),
            mjcf=_example("unitree_h1/h1_description/mjcf/scene.xml"),
            overrides_info=_local_config("h1/overrides.info"),
        ),
        "hunter": RobotAssets(
            name="hunter",
            urdf=_example("hunter/legged_hunter_description/urdf/hunter.urdf"),
            task_info=_example("hunter/legged_hunter_config/config/task/task.info"),
            reference_info=_example("hunter/legged_hunter_config/config/command/reference.info"),
            gait_info=_example("hunter/legged_hunter_config/config/command/gait.info"),
            overrides_info=_local_config("hunter/overrides.info"),
            extra_gait_info=_local_config("hunter/extra_gaits.info"),
        ),
        "openloong": RobotAssets(
            name="openloong",
            urdf=_example("openloong_description/urdf/AzureLoong_with_sole.urdf"),
            task_info=_example("openloong_description/config/task/task.info"),
            reference_info=_example("openloong_description/config/command/reference.info"),
            gait_info=_example("openloong_description/config/command/gait.info"),
            mjcf=_example("openloong_description/mjcf/scene.xml"),
            overrides_info=_local_config("openloong/overrides.info"),
            extra_gait_info=_local_config("openloong/extra_gaits.info"),
        ),
        "g1": RobotAssets(
            name="g1",
            # in-repo stand-in (see the file's header for what is assumed)
            urdf=_local_config("g1/g1_standin.urdf"),
            task_info=_local_config("g1/g1_task.info"),
            reference_info=_local_config("g1/g1_reference.info"),
            gait_info=_local_config("g1/g1_gaits.info"),
            # the MuJoCo scene is the vendor's, from the user's asset tree
            mjcf=_example("unitree_g1/g1_description/scene.xml"),
            overrides_info=_local_config("g1/overrides.info"),
        ),
    }


def get_assets(name: str) -> RobotAssets:
    """Assets for a registered robot, resolved against $BIPEDAL_ASSETS now."""
    return _registry()[name]
