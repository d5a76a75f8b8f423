"""The megajac kernel wrapper (drake_ddp_tpu_torch/ops/megajac.py), the
cold-Newton lane Jacobian and the solver's derivative-kernel choice, in
the port alone (no JAX): the JAX comparisons are in
tests/test_torch_lanejac.py.

On the CPU the wrapper runs the plain lane Jacobian, so the CPU tests pin
that path, the cold Jacobian against the root-seeded one at the step's
own root, and the solver's switch between them.  The ``cuda`` tests hold
the kernels to the plain version on the card with chip_smoke.py's
per-lane pin (``jac_check``): max |kernel - plain f64| <= 3 max |plain
f32 - plain f64| + 1e-5 max |J f64| on every lane."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_model import small_families


def _families(device="cpu", contact_iters=2):
    """The small sh/sb/bh model as a DiscreteSystem, with seeded states
    (float64, exactly representable in float32) and inputs."""
    import drake_ddp_tpu_torch.contact.geometry as geom
    import drake_ddp_tpu_torch.multibody.model as model_mod
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system

    model, contact = small_families(model_mod, geom, device=device)
    system = make_multibody_system(
        model, contact, 2e-3, contact_iters=contact_iters,
        force_params=ContactForceParams(smooth_width=1e-3))
    return system, model


def _family_states(model, L, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    x = np.zeros((L, model.nq + model.nv))
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.15 * rng.standard_normal((L, 4))
    x[:, :4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    x[:, 6] = 0.04 + rng.uniform(-0.01, 0.01, L)     # box face at the ground
    x[:, 7] = rng.uniform(-np.pi, np.pi, L)          # hip angle
    x[:, 8] = rng.uniform(0.0, 0.2, L)               # slider through the box
    x[:, 9:] = 0.5 * rng.standard_normal((L, model.nv))
    u = rng.standard_normal((model.nu, L))
    f32 = lambda a: torch.as_tensor(a, device=device).float().double()
    return f32(x.T).contiguous(), f32(u)


def _cheetah_states(mc, L, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    x0, _ = mc.initial_and_target(mc.Config())
    x = np.tile(np.asarray(x0, np.float64), (L, 1))
    x[:, 19:] += 0.2 * rng.standard_normal((L, 18))
    x[:, 4:7] += 0.01 * rng.standard_normal((L, 3))
    u = np.tile(np.asarray(mc.U_STAND, np.float64), (L, 1))
    u += 0.5 * rng.standard_normal(u.shape)
    t = lambda a: torch.as_tensor(a.T, device=device).contiguous()
    return t(x), t(u)


def test_cold_lane_jac_is_the_root_seeded_one_at_the_steps_root():
    """Both linearize at the root of the step's own Newton: the cold one
    runs it, the root-seeded one reads it from the step's next state."""
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc

    system, _ = mc.build_system(mc.Config(contact_iters=8), device="cpu")
    x, u = _cheetah_states(mc, 3, 0)
    cold = torch.cat(system.lane_jac_fn(x, u), dim=1)
    root = torch.cat(system.lane_jac_root_fn(
        x, u, system.lane_step_fn(x, u)), dim=1)
    assert cold.shape == (37, 49, 3)
    rel = ((cold - root).abs().max() / root.abs().max()).item()
    assert rel <= 1e-10, rel


@pytest.mark.parametrize("root", [True, False], ids=["root", "cold"])
def test_megajac_on_cpu_tensors_is_the_plain_lane_jac(root):
    from drake_ddp_tpu_torch.multibody.lanejac import make_lane_jac
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import megajac

    system, model = _families()
    kd = kernel_data_for_system(system)
    x, u = _family_states(model, 5, 1)
    xn = system.lane_step_fn(x, u) if root else None
    plain = make_lane_jac(*system.params, system.dt, contact_iters=2,
                          force_params=system.lane_step_fn.force_params,
                          root_seed=root)
    want = plain(x, u, xn) if root else plain(x, u)
    before = megajac.launches
    got = megajac(kd, x, u, xn)
    assert megajac.launches == before          # the plain path launches nothing
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _tiny_problem(model, B, N):
    from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem

    n, m = model.nq + model.nv, model.nu
    x0, _ = _family_states(model, B, 2)
    x0 = x0.T.contiguous()
    x_nom = x0.clone()
    x_nom[:, 7] += 0.3                               # swing the hip
    eye = lambda k, s: s * torch.eye(k, dtype=torch.float64).repeat(B, 1, 1)
    return ILQRProblem(x0=x0, x_nom=x_nom, Q=eye(n, 1e-2), R=eye(m, 1e-3),
                       Qf=eye(n, 1.0),
                       u_init=torch.zeros((B, N - 1, m), dtype=torch.float64))


def test_solver_takes_the_cold_jacobian_without_a_root_seeded_one():
    from drake_ddp_tpu_torch.solver import keypoints as kp
    from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig

    system, model = _families()
    N = 5
    prob = _tiny_problem(model, 2, N)
    cfg = ILQRConfig(num_steps=N, max_iters=3, ls_parallel=2, beta=0.5,
                     eps_min=1e-3,
                     derivs=kp.DerivsInterpolation("setInterval", minN=2))
    calls = []
    cold_fn = system.lane_jac_fn
    cold_sys = dataclasses.replace(
        system, lane_jac_root_fn=None,
        lane_jac_fn=lambda x, u: calls.append(x.shape[-1]) or cold_fn(x, u))
    root_sol = solve_ilqr_batched(system, cfg, prob)
    cold_sol = solve_ilqr_batched(cold_sys, cfg, prob, deriv_kernel="lane")
    lanes = 2 * int(kp.set_interval_mask(N, 2).sum())   # B x keypoints
    assert calls and all(L == lanes for L in calls)
    kernel_sol = solve_ilqr_batched(cold_sys, cfg, prob)   # megajac, on CPU
    for sol in (cold_sol, kernel_sol):
        assert torch.equal(sol.iterations, root_sol.iterations)
        assert int(sol.iterations.min()) >= 1
        np.testing.assert_allclose(sol.cost.numpy(), root_sol.cost.numpy(),
                                   rtol=1e-8)


def test_solver_rejects_an_unknown_deriv_kernel_or_a_system_without_one():
    from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig

    system, model = _families()
    prob = _tiny_problem(model, 1, 3)
    cfg = ILQRConfig(num_steps=3, max_iters=1)
    with pytest.raises(ValueError, match="deriv_kernel must be one of"):
        solve_ilqr_batched(system, cfg, prob, deriv_kernel="xla")
    bare = dataclasses.replace(system, lane_jac_fn=None,
                               lane_jac_root_fn=None)
    with pytest.raises(ValueError, match="no lane Jacobian"):
        solve_ilqr_batched(bare, cfg, prob)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _chip_smoke():
    """chip_smoke.py at the repo root, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_and_check(kd, x64, u64, root):
    from drake_ddp_tpu_torch.ops.megajac import megajac

    args = (x64.float(), u64.float()) + (
        (kd.step(x64, u64).float(),) if root else ())
    before = megajac.launches
    got = megajac(kd, *args)
    torch.cuda.synchronize()
    assert megajac.launches == before + 1
    ok, report = _chip_smoke().jac_check(kd, x64, u64, got, root)
    assert ok, report


@pytest.mark.cuda
@pytest.mark.parametrize("root", [True, False], ids=["root", "cold"])
def test_megajac_matches_plain_lane_jac(card, root):
    """The cheetah at 300 lanes: 3 blocks of 128 tangent threads per
    direction, the last one ragged."""
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system

    system, _ = mc.build_system(mc.Config(contact_iters=8), device=card)
    x64, u64 = _cheetah_states(mc, 300, 3, card)
    _run_and_check(kernel_data_for_system(system), x64, u64, root)


@pytest.mark.cuda
@pytest.mark.parametrize("root", [True, False], ids=["root", "cold"])
def test_megajac_matches_plain_lane_jac_contact_families(card, root):
    """Revolute, prismatic and fixed joints and the sh, sb (inside and
    outside) and bh families.  The inputs are float32 numbers, so the
    float64 reference sees the kernel's own inputs."""
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system

    system, model = _families(card, contact_iters=6)
    x64, u64 = _family_states(model, 64, 4, card)
    _run_and_check(kernel_data_for_system(system), x64, u64, root)


@pytest.mark.cuda
@pytest.mark.parametrize("root", [True, False], ids=["root", "cold"])
def test_megajac_matches_plain_lane_jac_manipulation_families(card, root):
    """The ss, sw and bs families (the small manipulation model), held as
    chip_smoke.py holds the manipulation models: at contact_iters 6 the
    plain float32 cold root is another one on many of these violent
    states, so jac_check leaves those lanes out (up to half) and holds
    them to the plain float64 Jacobian alone, within FLIP_LANE_REL of the
    lane's scale."""
    import drake_ddp_tpu_torch.contact.geometry as geom
    import drake_ddp_tpu_torch.multibody.model as model_mod
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.models.small import (manipulation_states,
                                                  small_manipulation)

    model, contact = small_manipulation(model_mod, geom, device=card)
    system = make_multibody_system(
        model, contact, 2e-3, contact_iters=6,
        force_params=ContactForceParams(smooth_width=1e-3))
    kd = kernel_data_for_system(system)
    x, u = manipulation_states(model, 64, 4)
    f32 = lambda a: torch.as_tensor(a, device=card).float().double()
    x64, u64 = f32(x).contiguous(), f32(u).contiguous()
    args = (x64.float(), u64.float()) + (
        (kd.step(x64, u64).float(),) if root else ())
    got = megajac(kd, *args)
    torch.cuda.synchronize()
    cs = _chip_smoke()
    ok, report = cs.jac_check(kd, x64, u64, got, root, max_flips=32)
    assert ok, report
    assert report["err_kernel_vs_f64_rel_flip_lanes_max"] <= \
        cs.FLIP_LANE_REL, report


@pytest.mark.cuda
def test_megajac_rejects_what_it_does_not_take(card):
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import megajac

    system, _ = mc.build_system(mc.Config(contact_iters=8), device=card)
    kd = kernel_data_for_system(system)
    x, u = (a.float() for a in _cheetah_states(mc, 4, 5, card))
    with pytest.raises(TypeError, match="float32"):
        megajac(kd, x.double(), u)
    with pytest.raises(ValueError, match="shape"):
        megajac(kd, x[:36].contiguous(), u)
    with pytest.raises(ValueError, match="shape"):
        megajac(kd, x, u, x[:, :, None])
    with pytest.raises(ValueError, match="is on cpu"):
        megajac(kd, x, u.cpu())
    with pytest.raises(ValueError, match="lanes"):
        megajac(kd, x, u[:, :3].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("root", [True, False], ids=["root", "cold"])
@pytest.mark.parametrize("L", [1, 3, 133, 1100])
def test_megajac_team_edges(card, L, root):
    """The team primal with fewer lanes than SMs (one lane a block), a
    ragged L whose last block is partly empty (133 lanes, 2 a block), and
    more lanes than 4 a block on every SM (blocks capped at the kernel's
    launch bounds of 4 lanes)."""
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    from drake_ddp_tpu_torch.ops.megajac import launch_config

    system, _ = mc.build_system(mc.Config(contact_iters=8), device=card)
    kd = kernel_data_for_system(system)
    cfg = launch_config(kd, L)
    assert cfg["blocks"] * cfg["lanes_per_block"] >= L
    assert cfg["lanes_per_block"] <= 4
    x64, u64 = _cheetah_states(mc, L, 6, card)
    _run_and_check(kd, x64, u64, root)


@pytest.mark.cuda
@pytest.mark.parametrize("root", [True, False], ids=["root", "cold"])
def test_megajac_without_contact(card, root):
    """A model without contact: G is the mass matrix."""
    import drake_ddp_tpu_torch.contact.geometry as geom
    import drake_ddp_tpu_torch.multibody.model as model_mod
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system

    model, _ = small_families(model_mod, geom, device=card)
    system = make_multibody_system(model, None, 2e-3, contact_iters=2)
    x64, u64 = _family_states(model, 64, 7, card)
    _run_and_check(kernel_data_for_system(system), x64, u64, root)


@pytest.mark.cuda
def test_megajac_raises_when_a_lane_does_not_fit_shared_memory(card):
    """A primal working set larger than a block's shared memory raises
    before any launch or allocation: there is no global-memory
    fallback."""
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    from drake_ddp_tpu_torch.ops._table import StepKernelData
    from drake_ddp_tpu_torch.ops.megajac import megajac

    system, _ = mc.build_system(mc.Config(contact_iters=8), device=card)
    model, contact = system.params
    kd = StepKernelData(model, contact, system.dt, contact_iters=8)
    kd._struct.nc = 2000       # 2000 contacts: Jc alone would be 864 KB
    x, u = (a.float() for a in _cheetah_states(mc, 8, 5, card))
    before = megajac.launches
    with pytest.raises(ValueError, match="shared memory"):
        megajac(kd, x, u, x)
    with pytest.raises(ValueError, match="shared memory"):
        megajac(kd, x, u)
    assert megajac.launches == before
