"""The per-scenario ``keypoints.compute_derivatives(step, cfg, x, u)``
against the JAX package's, on one trajectory of a scalar step.

The pendulum and the cart-pole in float64, every keypoint method without
``max_keypoints`` and with an ample one (and a ``jac_chunk``), to 1e-10:
both packages differentiate the same closed-form step (``jax.jacfwd`` and
``torch.func.jacfwd``), so only the masks, gathers, budgets and the
interpolation are under test.  A setInterval or adaptiveJerk mask with
more keypoints than ``max_keypoints`` raises in the port (JAX reads zero
Jacobians at the dropped keypoints).  One JAX program per case computes
both budgets (its compile is most of the time)."""

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")

from test_torch_model import JAX_QUICK_COMPILE  # noqa: E402

from drake_ddp_tpu.solver import keypoints as jkp  # noqa: E402
from drake_ddp_tpu_torch.solver import keypoints as tkp  # noqa: E402

CONFIGS = {   # each without and with an ample budget
    "setInterval": [("setInterval", 4),
                    ("setInterval", 4, 0, 0.0, 0.0, 9, 3)],
    "adaptiveJerk": [("adaptiveJerk", 2, 6, 0.01),
                     ("adaptiveJerk", 2, 6, 0.01, 0.0, 28, 5)],
    "iterativeError": [("iterativeError", 2, 0, 0.0, 1e-6),
                       ("iterativeError", 2, 0, 0.0, 1e-6, 7, 4)],
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensor ops under intra-op threads on a shared CPU can each
    wait for the pool (as in tests/test_torch_keypoints.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trajectory(system, N, seed):
    """A float64 trajectory of an analytic (port) system under a smooth
    seeded random tape, with small seeded velocity noise so that the jerk
    test has work."""
    rng = np.random.default_rng(seed)
    u = np.cumsum(rng.normal(scale=0.3, size=(N - 1, system.m)), axis=0)
    x = system.rollout(torch.zeros(system.n, dtype=torch.float64),
                       torch.as_tensor(u)).numpy()
    return x + rng.normal(scale=1e-3, size=x.shape), u


@pytest.mark.parametrize("system", ["pendulum", "cart_pole"])
@pytest.mark.parametrize("method", list(CONFIGS))
def test_compute_derivatives_matches_jax(system, method):
    """(fx, fu, percent) equal JAX's to 1e-10 without and with an ample
    ``max_keypoints``; for setInterval and adaptiveJerk a budget one
    below the mask's count raises."""
    from drake_ddp_tpu.dynamics import analytic as jan
    from drake_ddp_tpu_torch.dynamics import analytic as tan

    jsys = getattr(jan, f"{system}_system")(dt=0.01)
    tsys = getattr(tan, f"{system}_system")(dt=0.01)
    x, u = _trajectory(tsys, 20, seed=len(method))
    cfgs = [(jkp.DerivsInterpolation(*c), tkp.DerivsInterpolation(*c))
            for c in CONFIGS[method]]
    wants = jax.jit(lambda a, b: [jkp.compute_derivatives(
        jsys.bound_step(), cj, a, b) for cj, _ in cfgs],
        compiler_options=JAX_QUICK_COMPILE)(x, u)
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    for (_, ct), want in zip(cfgs, wants):
        got = tkp.compute_derivatives(tsys.bound_step(), ct, xt, ut)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape and g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-10)
    pct = float(got[2])
    if method != "setInterval":
        assert 0.0 < pct < 100.0, pct
    if method == "iterativeError":
        return
    count = round(pct * (len(x) - 1) / 100.0)
    small = cfgs[0][1]._replace(max_keypoints=count - 1)
    with pytest.raises(ValueError, match=f"{count} keypoints, over the "
                       f"budget max_keypoints={count - 1}"):
        tkp.compute_derivatives(tsys.bound_step(), small, xt, ut)
