"""JAX robot model pytree.

Lifts :class:`bipedal_nmpc.model.urdf.RobotDescription` into a pytree of
``jnp`` arrays plus static (hashable) topology metadata, so model-parametrized
functions jit cleanly and batch under vmap.

Generalized coordinates (matching the reference's centroidal-model convention,
see utils/rotations.py):

    q = [p_base(3, world), theta(3, euler-zyx: z,y,x), q_joints(nj)]
    v = dq/dt  (Euler *rates*, not angular velocity)

nq == nv == 6 + nj.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .urdf import JOINT_PRISMATIC, JOINT_REVOLUTE, RobotDescription


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class RobotModel:
    # --- static topology (aux data, hashable) ---
    name: str
    joint_names: tuple[str, ...]
    frame_names: tuple[str, ...]
    joint_parent_body: tuple[int, ...]  # (nj,)
    joint_type: tuple[int, ...]  # (nj,)
    frame_body: tuple[int, ...]  # (nf,)
    ancestor_joints: Any  # frozen (nb, nj) bool numpy array wrapped in bytes key

    # --- array leaves ---
    joint_offset_R: jnp.ndarray  # (nj,3,3)
    joint_offset_p: jnp.ndarray  # (nj,3)
    joint_axis: jnp.ndarray  # (nj,3)
    joint_limit_lower: jnp.ndarray
    joint_limit_upper: jnp.ndarray
    joint_limit_effort: jnp.ndarray
    joint_limit_velocity: jnp.ndarray
    body_mass: jnp.ndarray  # (nb,)
    body_com: jnp.ndarray  # (nb,3)
    body_inertia: jnp.ndarray  # (nb,3,3)
    frame_R: jnp.ndarray  # (nf,3,3)
    frame_p: jnp.ndarray  # (nf,3)

    # ------------------------------------------------------------------
    @property
    def nj(self) -> int:
        return len(self.joint_names)

    @property
    def nb(self) -> int:
        return self.nj + 1

    @property
    def nq(self) -> int:
        return 6 + self.nj

    @property
    def nv(self) -> int:
        return 6 + self.nj

    @property
    def total_mass(self):
        return jnp.sum(self.body_mass)

    def frame_index(self, name: str) -> int:
        return self.frame_names.index(name)

    def ancestor_mask(self) -> np.ndarray:
        """(nb, nj) static bool: joint j moves body b."""
        return np.frombuffer(self.ancestor_joints, dtype=np.bool_).reshape(self.nb, self.nj)

    # ------------------------------------------------------------------
    _LEAF_FIELDS = (
        "joint_offset_R",
        "joint_offset_p",
        "joint_axis",
        "joint_limit_lower",
        "joint_limit_upper",
        "joint_limit_effort",
        "joint_limit_velocity",
        "body_mass",
        "body_com",
        "body_inertia",
        "frame_R",
        "frame_p",
    )
    _STATIC_FIELDS = (
        "name",
        "joint_names",
        "frame_names",
        "joint_parent_body",
        "joint_type",
        "frame_body",
        "ancestor_joints",
    )

    def tree_flatten(self):
        leaves = tuple(getattr(self, f) for f in self._LEAF_FIELDS)
        aux = tuple(getattr(self, f) for f in self._STATIC_FIELDS)
        return leaves, aux

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        kwargs = dict(zip(cls._STATIC_FIELDS, aux))
        kwargs.update(dict(zip(cls._LEAF_FIELDS, leaves)))
        return cls(**kwargs)


def from_description(desc: RobotDescription, dtype=jnp.float64) -> RobotModel:
    nb, nj = desc.num_bodies, desc.num_joints
    # static ancestor mask: joint j (body j+1) moves body b iff body j+1 is on
    # the chain from root to b.
    anc = np.zeros((nb, nj), dtype=np.bool_)
    for b in range(1, nb):
        cur = b
        while cur != 0:
            anc[b, cur - 1] = True
            cur = int(desc.joint_parent_body[cur - 1])
    arr = lambda x: jnp.asarray(x, dtype=dtype)
    return RobotModel(
        name=desc.name,
        joint_names=tuple(desc.joint_names),
        frame_names=tuple(desc.frame_names),
        joint_parent_body=tuple(int(i) for i in desc.joint_parent_body),
        joint_type=tuple(int(t) for t in desc.joint_type),
        frame_body=tuple(int(b) for b in desc.frame_body),
        ancestor_joints=anc.tobytes(),
        joint_offset_R=arr(desc.joint_offset_R),
        joint_offset_p=arr(desc.joint_offset_p),
        joint_axis=arr(desc.joint_axis),
        joint_limit_lower=arr(desc.joint_limit_lower),
        joint_limit_upper=arr(desc.joint_limit_upper),
        joint_limit_effort=arr(desc.joint_limit_effort),
        joint_limit_velocity=arr(desc.joint_limit_velocity),
        body_mass=arr(desc.body_mass),
        body_com=arr(desc.body_com),
        body_inertia=arr(desc.body_inertia),
        frame_R=arr(desc.frame_R),
        frame_p=arr(desc.frame_p),
    )


JOINT_TYPES = {"revolute": JOINT_REVOLUTE, "prismatic": JOINT_PRISMATIC}
