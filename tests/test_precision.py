"""Matmul-precision policy (utils/precision.py).

A float32 dot at default precision may run in reduced precision on an
accelerator (TF32 on a GPU); the framework's production entry points trace
under full-f32 precision instead, because the stage-KKT and contact algebra
is ill-conditioned.  These tests
pin the policy machinery platform-independently by inspecting jaxprs.
"""
import jax
import jax.numpy as jnp

from bipedal_nmpc.utils import precision


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params.get("precision"))
    return out


def test_default_is_float32(monkeypatch):
    monkeypatch.delenv("BIPEDAL_MATMUL_PRECISION", raising=False)
    assert precision.matmul_precision() == "float32"
    monkeypatch.setenv("BIPEDAL_MATMUL_PRECISION", "bfloat16_3x")
    assert precision.matmul_precision() == "bfloat16_3x"


def test_context_sets_highest_precision_on_dots(monkeypatch):
    monkeypatch.delenv("BIPEDAL_MATMUL_PRECISION", raising=False)
    a = jnp.zeros((4, 4), jnp.float32)

    def plain(a):
        return a @ a

    def wrapped(a):
        with precision.default_matmul_precision():
            return a @ a

    # default-precision dots carry precision=None (XLA decides; TF32 on a GPU)
    assert _dot_precisions(plain, a) == [None]
    (p,) = _dot_precisions(wrapped, a)
    assert p == (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def test_mpc_replan_traces_under_policy(monkeypatch):
    """The fused replan's dots must carry the policy precision, not None."""
    monkeypatch.delenv("BIPEDAL_MATMUL_PRECISION", raising=False)
    from bipedal_nmpc.interface import make_interface_for
    from bipedal_nmpc.runtime.mpc_runner import MpcRunner

    iface = make_interface_for("g1")
    runner = MpcRunner(iface)
    frozen = runner.rm.freeze(0.0)
    x0 = jnp.asarray(iface.initial_state)
    # tracing only — no solve executed
    jaxpr = jax.make_jaxpr(
        lambda g, s, tt, tn, x: runner._replan_cold(g, s, tt, tn, x)
    )(frozen.gait, frozen.swing, frozen.target, jnp.asarray(frozen.t_nodes), x0)
    # the replan lowers to one pjit call whose subjaxpr holds the dots
    def walk(jx, found):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params.get("precision"))
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):
                    walk(v.jaxpr, found)
        return found

    precisions = walk(jaxpr.jaxpr, [])
    assert precisions, "replan trace contains no dot_general?"
    hi = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    frac_hi = sum(1 for p in precisions if p == hi) / len(precisions)
    assert frac_hi == 1.0, f"replan dots not all HIGHEST: {precisions}"
