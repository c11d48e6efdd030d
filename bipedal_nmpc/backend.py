"""Which Riccati sweep a device runs, decided in one place.

Every other layer of the solve (linearization, merit line search) is plain
JAX that XLA compiles for any device.  The Riccati sweep has two kinds of
backend:

- plain XLA, which runs everywhere: "sequential" (the exact stage-KKT scan,
  solver/riccati.py), "parallel" (associative scan, float64 only) and
  "parallel_sqrt" (square-root associative scan) from
  solver/parallel_riccati.py;
- "triton", a Pallas kernel compiled through Triton (ops/riccati_triton.py),
  which only a GPU can compile.

`OcpSettings.riccati = "auto"` (the default) resolves to the fastest backend
the device can compile: the kernel on a GPU, the XLA scan elsewhere.  Asking
for a kernel on a device that cannot compile it raises; nothing falls back
and nothing runs the Pallas interpreter.  The tests reach the interpreter
only through the kernel's explicit `interpret=True` argument.
"""
from __future__ import annotations

import dataclasses

import jax

from .ocp.problem import OcpSettings

XLA_RICCATI = ("sequential", "parallel", "parallel_sqrt")
# kernel backend -> platforms that compile it
KERNEL_RICCATI = {"triton": ("gpu",)}
# what "auto" becomes on each platform (anything unlisted: "sequential")
_AUTO = {"gpu": "triton"}


def select_backends(settings: OcpSettings, device=None) -> OcpSettings:
    """The settings with `riccati` resolved for `device` (default: the first
    JAX device).  Raises ValueError for an unknown backend or for a kernel
    the device cannot compile."""
    platform = (device if device is not None else jax.devices()[0]).platform
    riccati = settings.riccati
    if riccati == "auto":
        riccati = _AUTO.get(platform, "sequential")
    if riccati in KERNEL_RICCATI:
        if platform not in KERNEL_RICCATI[riccati]:
            raise ValueError(
                f"riccati={riccati!r} is a kernel for {KERNEL_RICCATI[riccati]} and "
                f"cannot be compiled for a {platform!r} device; use one of {XLA_RICCATI}"
            )
    elif riccati not in XLA_RICCATI:
        raise ValueError(
            f"unknown riccati backend {riccati!r}; expected 'auto', one of "
            f"{XLA_RICCATI} or a kernel in {tuple(KERNEL_RICCATI)}"
        )
    return dataclasses.replace(settings, riccati=riccati)
