"""The port's dynamic keypoint methods (adaptiveJerk, iterativeError)
against the JAX package's ``solver/keypoints.py`` on the same
numpy-seeded inputs.

Masks are held equal, not close: each is computed from one input handed
to both packages (the same trajectory, or the same fx stack), so a
threshold test cannot flip on rounding.  Derivatives are held at 1e-10 in
float64: the Jacobian each package's keypoint code calls is one shared
function of the lanes (a lookup into one dense stack, computed once by
the JAX package's compiled cheetah lane Jacobian, or by the port's cold
one), so the test pins the masks, the gathers, the budgets and the
interpolation, not the dynamics (tests/test_torch_lanejac.py pins those).
"""

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_model import (JAX_QUICK_COMPILE,  # noqa: E402
                              jax_cheetah_lane_jac)

from drake_ddp_tpu.solver import keypoints as jkp  # noqa: E402
from drake_ddp_tpu_torch.solver import keypoints as tkp  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The example solves are thousands of tiny tensor ops, which under
    intra-op threads on a shared CPU can each wait for the pool (as in
    tests/test_torch_classic.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(*fields, **kw):
    return (jkp.DerivsInterpolation(*fields, **kw),
            tkp.DerivsInterpolation(*fields, **kw))


def test_config_fields_in_the_jax_order():
    assert tkp.DerivsInterpolation._fields == jkp.DerivsInterpolation._fields
    assert tuple(tkp.BASELINE) == tuple(jkp.BASELINE)
    cj, ct = _both("adaptiveJerk", 2, 20, 0.3, 10.0, 7, 5)
    assert tuple(cj) == tuple(ct)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("minN,maxN,thr",
                         [(2, 20, 0.3), (5, 100, 0.0007), (1, 10, 0.1)])
def test_adaptive_jerk_mask_matches_jax(seed, minN, maxN, thr):
    rng = np.random.default_rng(seed)
    N, n = 60, 4
    x = np.cumsum(rng.normal(scale=0.2, size=(N, n)), axis=0)
    cj, ct = _both("adaptiveJerk", minN, maxN, thr, 0.0)
    want = np.asarray(jkp.adaptive_jerk_mask(cj, jnp.asarray(x), N, n))
    got = tkp.adaptive_jerk_mask(ct, torch.as_tensor(x), N, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # the batched host scan gives each row its own mask
    rows = tkp.adaptive_jerk_masks(ct, torch.as_tensor(np.stack([x, x[::-1]])))
    np.testing.assert_array_equal(rows[0], want)
    np.testing.assert_array_equal(rows[1], np.asarray(jkp.adaptive_jerk_mask(
        cj, jnp.asarray(x[::-1].copy()), N, n)))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("minN,thr", [(2, 1e-4), (5, 1e-2), (2, 1e9),
                                      (2, 0.0)])
def test_iterative_error_mask_matches_jax(seed, minN, thr):
    rng = np.random.default_rng(seed)
    N, n = 34, 3
    base = rng.normal(size=(n, n))
    t = np.linspace(0, 1, N - 1)[:, None, None]
    fx = base + 0.5 * np.sin(3 * t) * rng.normal(size=(n, n))
    fx[N // 2:] += 0.3
    cj, ct = _both("iterativeError", minN, 0, 0.0, thr)
    want = np.asarray(jax.jit(jkp.iterative_error_mask, static_argnums=(0, 2))(
        cj, fx, N))
    got = tkp.iterative_error_mask(ct, torch.as_tensor(fx), N)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N", [20, 57])
def test_interpolate_stack_matches_jax(N):
    """Data-dependent masks, including one without a keypoint at 0 (the
    forced-last-only adaptiveJerk mask), where both read the last step."""
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(N - 1, 3, 3))
    # eager: a compiled JAX program may contract (1 - w) a + w b into
    # fused multiply-adds, one rounding fewer than either package's ops
    interp = lambda m, v: jkp.interpolate_stack(jnp.asarray(m),
                                                jnp.asarray(v))
    for kps in ([0, 5, 11, N - 2], [0, N - 2], [N - 2], [3, 7]):
        mask = np.zeros(N - 1, bool)
        mask[kps] = True
        want = np.asarray(interp(mask, vals))
        got = tkp.interpolate_stack(torch.as_tensor(mask),
                                    torch.as_tensor(vals))
        np.testing.assert_array_equal(got.numpy(), want)
    # batched: a (B, T) mask over a (B, T, ...) stack, row by row
    masks = rng.random((3, N - 1)) < 0.3
    masks[:, 0] = masks[:, -1] = True
    stack = rng.normal(size=(3, N - 1, 2, 4))
    got = tkp.interpolate_stack(torch.as_tensor(masks), torch.as_tensor(stack))
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(
            interp(masks[b], stack[b])))


@pytest.mark.parametrize("N,minN", [(50, 2), (12, 2), (34, 5), (9, 7),
                                    (200, 1)])
def test_dyadic_tree_and_level_caps_match_jax(N, minN):
    assert tkp._dyadic_depth(N, minN) == jkp._dyadic_depth(N, minN)
    tj, tt = jkp._dyadic_tree(N, minN), tkp._dyadic_tree(N, minN)
    assert len(tj) == len(tt)
    for lj, lt in zip(tj, tt):
        for a, b in zip(lj, lt):
            np.testing.assert_array_equal(a, b)
    for budget in (3, 5, 8, 20, N):
        assert tkp._level_caps(tt, budget) == jkp._level_caps(tj, budget)


@pytest.mark.parametrize("minN,maxN,thr",
                         [(2, 20, 0.3), (5, 100, 0.0007), (1, 10, 0.1)])
def test_adaptive_jerk_auto_budget(minN, maxN, thr):
    """The count bound equals JAX's and holds; with max_keypoints unset the
    derivatives equal the dense stack interpolated on the mask."""
    rng = np.random.default_rng(0)
    N = 40
    x = rng.normal(scale=0.3, size=(1, N, 4))
    u = rng.normal(scale=0.3, size=(1, N - 1, 1))
    cj, ct = _both("adaptiveJerk", minN, maxN, thr, 0.0)
    assert tkp._adaptive_jerk_budget(ct, N) == jkp._adaptive_jerk_budget(cj, N)
    mask = tkp.adaptive_jerk_mask(ct, torch.as_tensor(x[0]), N, 4)
    assert int(mask.sum()) <= tkp._adaptive_jerk_budget(ct, N)
    jac = _analytic_lane_jac(torch)
    fx, fu, pct = tkp.compute_derivatives_batched(
        jac, ct, torch.as_tensor(x), torch.as_tensor(u))
    fx_d, fu_d = jac(torch.as_tensor(x[0, :-1].T), torch.as_tensor(u[0].T))
    for got, dense in ((fx, fx_d), (fu, fu_d)):
        want = tkp.interpolate_stack(mask, dense.permute(2, 0, 1))
        np.testing.assert_allclose(got[0].numpy(), want.numpy(), rtol=0,
                                   atol=1e-14)
    assert float(pct[0]) == pytest.approx(100.0 * int(mask.sum()) / (N - 1))


def _analytic_lane_jac(lib):
    """A smooth lane-major 'Jacobian' written once per framework."""
    sin, cos = (jnp.sin, jnp.cos) if lib is jnp else (torch.sin, torch.cos)

    def jac_T(x, u, x_next=None):
        xn = x if x_next is None else x_next
        return (sin(x)[:, None] * xn[None] + 0.1 * x[None],
                cos(u)[None] * xn[:, None] + u.sum(0))

    return jac_T


def test_over_budget_adaptive_jerk_raises():
    """The port refuses a budget below a scenario's keypoint count (the
    JAX package reads zero Jacobians at the dropped keypoints)."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(np.cumsum(rng.normal(size=(2, 30, 4)), axis=1))
    u = torch.as_tensor(rng.normal(size=(2, 29, 1)))
    cfg = tkp.DerivsInterpolation("adaptiveJerk", 1, 10, 0.0,
                                  max_keypoints=4)
    count = int(tkp.adaptive_jerk_masks(cfg, x).sum(1).max())
    assert count > 4
    with pytest.raises(ValueError, match=f"{count} keypoints, over the "
                       "budget max_keypoints=4"):
        tkp.compute_derivatives_batched(_analytic_lane_jac(torch), cfg, x, u)


class _StackJac:
    """A lane Jacobian shared by both packages: each lane's (fx, fu) looked
    up in one dense (B, T) stack by its exact x; a root-seeded call's
    x_next must be the trajectory's own next state.  The JAX package's
    side reaches it through a host callback, so that its keypoint code
    runs compiled."""

    def __init__(self, x, fx, fu):
        self.x, self.fx, self.fu = x, fx, fu
        self.where = {x[b, t].tobytes(): (b, t) for b in range(x.shape[0])
                      for t in range(x.shape[1] - 1)}
        self.lanes = []

    def __call__(self, lib, xL, uL, xnL=None):
        xL = np.asarray(xL)
        bt = [self.where[xL[:, i].tobytes()] for i in range(xL.shape[1])]
        b, t = (np.array(v) for v in zip(*bt))
        if xnL is not None:
            np.testing.assert_array_equal(np.asarray(xnL), self.x[b, t + 1].T)
        self.lanes.append(len(b))
        out = (np.moveaxis(self.fx[b, t], 0, -1),
               np.moveaxis(self.fu[b, t], 0, -1))
        return out if lib is np else tuple(torch.as_tensor(o) for o in out)

    def fn(self, lib, root):
        host = lambda *a: self(np if lib is jnp else lib, *a)
        if lib is jnp:
            n, m = self.fx.shape[-1], self.fu.shape[-1]
            call = host
            host = lambda x, *a: jax.pure_callback(
                call, (jax.ShapeDtypeStruct((n, n, x.shape[-1]), x.dtype),
                       jax.ShapeDtypeStruct((n, m, x.shape[-1]), x.dtype)),
                x, *a)
        if root:
            return lambda x, u, xn: host(x, u, xn)
        return lambda x, u: host(x, u)


@pytest.fixture(scope="module")
def cheetah_stacks():
    """B 3 seeded cheetah trajectories at N 12 (the port's plain float64
    rollout) and their dense Jacobian stacks: root-seeded from the JAX
    package's compiled lane Jacobian, cold from the port's."""
    from drake_ddp_tpu_torch.examples import mini_cheetah as tmc

    cfg = tmc.Config(contact_iters=8)
    system, _ = tmc.build_system(cfg, device="cpu")
    x0, _ = tmc.initial_and_target(cfg)
    N, B, n, m = 12, 3, 37, 12
    rng = np.random.default_rng(9)
    u = (np.tile(tmc.U_STAND, (B, N - 1, 1))
         + 0.3 * rng.standard_normal((B, N - 1, m)))
    xs = [np.tile(x0, (B, 1))]
    xs[0][:, 19:] += 0.05 * rng.standard_normal((B, 18))
    for t in range(N - 1):
        xs.append(system.lane_step_fn(torch.as_tensor(xs[-1].T),
                                      torch.as_tensor(u[:, t].T)).numpy().T)
    x = np.stack(xs, axis=1)                             # (B, N, n)
    lanes = lambda a: a.reshape(-1, a.shape[-1]).T       # (d, B * T)
    xl, ul, xnl = lanes(x[:, :-1]), lanes(u), lanes(x[:, 1:])
    stack = lambda f, d: np.moveaxis(np.asarray(f), -1, 0).reshape(
        B, N - 1, n, d)
    fxr, fur = jax_cheetah_lane_jac()(xl, ul, xnl)
    fxc, fuc = system.lane_jac_fn(torch.as_tensor(xl), torch.as_tensor(ul))
    return dict(x=x, u=u, root=(stack(fxr, n), stack(fur, m)),
                cold=(stack(fxc, n), stack(fuc, m)))


CHEETAH_CONFIGS = {
    "set_interval": ("setInterval", 3),
    "adaptive_jerk": ("adaptiveJerk", 2, 6, 0.1),
    "adaptive_jerk_budget": ("adaptiveJerk", 2, 6, 0.1, 0.0, 8),
    "iterative_error": ("iterativeError", 2, 0, 0.0, 1e-3),
    "iterative_error_budget": ("iterativeError", 2, 0, 0.0, 1e-3, 6),
}


@pytest.mark.parametrize("route", ["root", "cold"])
@pytest.mark.parametrize("method", list(CHEETAH_CONFIGS))
def test_cheetah_derivatives_match_jax(cheetah_stacks, method, route):
    """compute_derivatives_batched at B 3 on the cheetah (N 12), float64,
    every method, root-seeded and cold: fx, fu and the percentages at
    1e-10 against the JAX package's."""
    s = cheetah_stacks
    root = route == "root"
    cj, ct = _both(*CHEETAH_CONFIGS[method])
    shared = _StackJac(s["x"], *s[route])
    want = jax.jit(lambda x, u: jkp.compute_derivatives_batched(
        shared.fn(jnp, root), cj, x, u, root=root),
        compiler_options=JAX_QUICK_COMPILE)(s["x"], s["u"])
    shared.lanes.clear()
    got = tkp.compute_derivatives_batched(
        shared.fn(torch, root), ct, torch.as_tensor(s["x"]),
        torch.as_tensor(s["u"]), root=root)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)
    # the port evaluates exactly the keypoints: lanes == keypoint count
    T = s["x"].shape[1] - 1
    assert sum(shared.lanes) == int(round(float(got[2].sum()) * T / 100))
    if method == "iterative_error_budget":
        # the caps bind: fewer keypoints than the uncapped bisection
        free = tkp.compute_derivatives_batched(
            shared.fn(torch, root),
            ct._replace(max_keypoints=None), torch.as_tensor(s["x"]),
            torch.as_tensor(s["u"]), root=root)[2]
        assert (got[2] <= free).all() and (got[2] < free).any()


def test_jac_chunk_splits_the_lane_call(cheetah_stacks):
    s = cheetah_stacks
    shared = _StackJac(s["x"], *s["cold"])
    cfg = tkp.DerivsInterpolation("iterativeError", 2, 0, 0.0, 1e-3)
    x, u = torch.as_tensor(s["x"]), torch.as_tensor(s["u"])
    whole = tkp.compute_derivatives_batched(shared.fn(torch, False), cfg, x, u)
    per_level = list(shared.lanes)
    shared.lanes.clear()
    split = tkp.compute_derivatives_batched(
        shared.fn(torch, False), cfg._replace(jac_chunk=4), x, u)
    assert max(shared.lanes) <= 4 and sum(shared.lanes) == sum(per_level)
    for a, b in zip(whole, split):
        assert torch.equal(a, b)


CART_POLE_CONFIGS = {
    "adaptive_jerk": ("adaptiveJerk", 5, 10, 1e-4),
    "adaptive_jerk_budget": ("adaptiveJerk", 2, 6, 0.05, 0.0, 20),
    "iterative_error": ("iterativeError", 5, 0, 0.0, 5e-5),
    "iterative_error_budget": ("iterativeError", 2, 0, 0.0, 1e-6, 7),
}


@pytest.mark.parametrize("method", list(CART_POLE_CONFIGS))
def test_cart_pole_single_scenario_matches_jax(method):
    """B = 1 on the analytic cart-pole in float64: the port's batched path
    against JAX's per-scenario ``compute_derivatives`` (jacfwd of the
    step) and its batched one, at 1e-10."""
    from drake_ddp_tpu.dynamics.analytic import cart_pole_system as jcp
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system as tcp

    N = 40
    rng = np.random.default_rng(0)
    x = rng.normal(scale=0.3, size=(N, 4))
    x[:, 2:] = np.cumsum(rng.normal(scale=0.02, size=(N, 2)), axis=0)
    u = rng.normal(scale=0.3, size=(N - 1, 1))
    cj, ct = _both(*CART_POLE_CONFIGS[method])
    step = jcp(dt=0.01).bound_step()
    per_scenario = jax.jit(lambda a, b: jkp.compute_derivatives(
        step, cj, a, b), compiler_options=JAX_QUICK_COMPILE)(x, u)

    def jac_T(xL, uL):
        fx, fu = jax.vmap(jax.jacfwd(step, argnums=(0, 1)))(xL.T, uL.T)
        return jnp.moveaxis(fx, 0, -1), jnp.moveaxis(fu, 0, -1)

    batched = jax.jit(lambda a, b: jkp.compute_derivatives_batched(
        jac_T, cj, a, b), compiler_options=JAX_QUICK_COMPILE)(x[None],
                                                              u[None])
    got = tkp.compute_derivatives_batched(
        tcp(dt=0.01).lane_jac_fn, ct, torch.as_tensor(x[None]),
        torch.as_tensor(u[None]))
    for g, a, b in zip(got, per_scenario, batched):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(a), rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(g[0].numpy(), np.asarray(b)[0],
                                   rtol=1e-10, atol=1e-10)
    assert 0.0 < float(got[2][0]) < 100.0


@pytest.mark.parametrize("method", ["adaptiveJerk", "iterativeError"])
def test_cart_pole_example_chain_matches_jax(method):
    """The cart-pole example's solve with derivative interpolation (T 0.5,
    the JAX example's thresholds) in float64 against the JAX package's
    solve of the same Config: equal iterations and per-round derivative
    percentages, costs at 1e-6."""
    from drake_ddp_tpu.examples import cart_pole as jex
    from drake_ddp_tpu.solver.ilqr import solve_ilqr as jsolve
    from drake_ddp_tpu_torch.examples import cart_pole as tex

    kw = dict(T=0.5, use_derivative_interpolation=True,
              keypoint_method=method, verbose=False)
    jilqr = jex.build_solver(jex.Config(**kw))
    ref = jax.jit(lambda p: jsolve(jilqr.system, jilqr.config, p),
                  compiler_options=JAX_QUICK_COMPILE)(
        jilqr._problem(jnp.float64))
    tilqr = tex.build_solver(tex.Config(**kw), device="cpu")
    assert tuple(tilqr.config.derivs) == tuple(jilqr.config.derivs)
    tilqr.dtype = torch.float64
    tilqr.Solve()
    got = tilqr._solution
    k = int(ref.iterations)
    assert int(got.iterations) == k and not bool(got.diverged)
    pct = np.asarray(ref.stats.percent_derivs)[:k]
    np.testing.assert_allclose(got.stats.percent_derivs[:k], pct, rtol=1e-12)
    assert 0.0 < pct.max() < 100.0
    np.testing.assert_allclose(got.stats.cost[:k],
                               np.asarray(ref.stats.cost)[:k], rtol=1e-6)
