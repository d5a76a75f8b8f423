"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip on a machine without an NVIDIA GPU (a
CUDA kernel has no CPU mode); run them there with

    python -m pytest -m cuda tests/test_torch_*.py

Tolerance, as chip_smoke.py: the kernel's float32 error against the
plain float64 step is at most 3x the plain float32 step's + 1e-5 (the
kernel runs the same arithmetic in another order, with fused
multiply-adds); the rollout is held step by step from its own states
(chip_smoke.py's rollout_step_check)."""

import importlib.util
from pathlib import Path

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _cheetah_kernel_data(device, contact_iters=8):
    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system

    system, _ = mc.build_system(mc.Config(contact_iters=contact_iters),
                                device=device)
    return mc, kernel_data_for_system(system)


def _states(mc, L, device):
    gen = torch.Generator(device=device).manual_seed(0)
    x0, _ = mc.initial_and_target(mc.Config())
    x = torch.as_tensor(x0, dtype=torch.float64, device=device)
    x = x[:, None].repeat(1, L)
    x[19:] += 0.2 * torch.randn((18, L), generator=gen, device=device,
                                dtype=torch.float64)
    u = torch.as_tensor(mc.U_STAND, dtype=torch.float64, device=device)
    u = u[:, None] + 0.5 * torch.randn((12, L), generator=gen,
                                       device=device, dtype=torch.float64)
    return x, u


@pytest.mark.cuda
def test_megastep_matches_plain_step(card):
    from drake_ddp_tpu_torch.ops.megastep import megastep

    mc, kd = _cheetah_kernel_data(card)
    x64, u64 = _states(mc, 265, card)       # ragged: 3 lanes a block, 2 masked
    truth = kd.step(x64, u64)
    plain = kd.step(x64.float(), u64.float())
    before = megastep.launches
    got = megastep(kd, x64.float(), u64.float())
    torch.cuda.synchronize()
    assert megastep.launches == before + 1
    e_plain = (plain.double() - truth).abs().max().item()
    e_kern = (got.double() - truth).abs().max().item()
    assert e_kern <= 3.0 * e_plain + 1e-5, (e_kern, e_plain)


@pytest.mark.cuda
def test_megastep_past_four_lanes_a_block(card):
    """1100 lanes, more than 4 a block on every SM: the launch caps a block
    at the kernel's launch bounds of 4 lanes and adds blocks."""
    from drake_ddp_tpu_torch.ops.megastep import launch_config, megastep

    mc, kd = _cheetah_kernel_data(card)
    L = 1100
    cfg = launch_config(kd, L)
    assert cfg["lanes_per_block"] == 4 and cfg["blocks"] == 275
    x64, u64 = _states(mc, L, card)
    truth = kd.step(x64, u64)
    plain = kd.step(x64.float(), u64.float())
    got = megastep(kd, x64.float(), u64.float())
    torch.cuda.synchronize()
    e_plain = (plain.double() - truth).abs().max().item()
    e_kern = (got.double() - truth).abs().max().item()
    assert e_kern <= 3.0 * e_plain + 1e-5, (e_kern, e_plain)


@pytest.mark.cuda
def test_megastep_matches_plain_step_contact_families(card):
    """Revolute, prismatic and fixed joints and the sh, sb and bh contact
    families through the CUDA step (the cheetah has no prismatic joint
    and no sphere inside a box)."""
    import numpy as np

    import drake_ddp_tpu_torch.contact.geometry as geom
    import drake_ddp_tpu_torch.multibody.model as model_mod
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams
    from drake_ddp_tpu_torch.ops._table import StepKernelData
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from test_torch_model import small_families

    model, contact = small_families(model_mod, geom, device=card)
    kd = StepKernelData(model, contact, 2e-3, contact_iters=6,
                        force_params=ContactForceParams(smooth_width=1e-3))
    rng = np.random.default_rng(4)
    L = 64
    x = np.zeros((L, model.nq + model.nv))
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.15 * rng.standard_normal(
        (L, 4))
    x[:, :4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    x[:, 6] = 0.04 + rng.uniform(-0.01, 0.01, L)
    x[:, 7] = rng.uniform(-np.pi, np.pi, L)
    x[:, 8] = rng.uniform(0.0, 0.2, L)
    x[:, 9:] = 0.5 * rng.standard_normal((L, model.nv))
    x64 = torch.as_tensor(x.T, device=card)
    u64 = torch.as_tensor(rng.standard_normal((model.nu, L)), device=card)
    truth = kd.step(x64, u64)
    plain = kd.step(x64.float(), u64.float())
    got = megastep(kd, x64.float().contiguous(), u64.float().contiguous())
    torch.cuda.synchronize()
    e_plain = (plain.double() - truth).abs().max().item()
    e_kern = (got.double() - truth).abs().max().item()
    assert e_kern <= 3.0 * e_plain + 1e-5, (e_kern, e_plain)


@pytest.mark.cuda
@pytest.mark.parametrize("families", [("ss",), ("ss", "sw"), ("ss", "bs")],
                         ids=["ss", "sw", "bs"])
def test_megastep_matches_plain_step_manipulation_families(card, families):
    """Each contact family of the manipulation robots through the CUDA
    step, on the small manipulation model: sphere-sphere (a free ball at
    the torso box and a bumper sphere), with a fixed world sphere (sw),
    with the torso box's face quadrature against body spheres (bs)."""
    import drake_ddp_tpu_torch.contact.geometry as geom
    import drake_ddp_tpu_torch.multibody.model as model_mod
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams
    from drake_ddp_tpu_torch.ops._table import StepKernelData
    from drake_ddp_tpu_torch.ops.megastep import megastep
    from drake_ddp_tpu_torch.models.small import (manipulation_states,
                                                  small_manipulation)

    model, contact = small_manipulation(model_mod, geom, families,
                                        device=card)
    assert {"ss": contact.pair_ss_a, "sw": contact.pair_sw_s,
            "bs": contact.pair_bs_b}[families[-1]]
    kd = StepKernelData(model, contact, 2e-3, contact_iters=6,
                        force_params=ContactForceParams(smooth_width=1e-3))
    x, u = manipulation_states(model, 64, 4)
    x64, u64 = torch.as_tensor(x, device=card), torch.as_tensor(u, device=card)
    truth = kd.step(x64, u64)
    plain = kd.step(x64.float(), u64.float())
    got = megastep(kd, x64.float().contiguous(), u64.float().contiguous())
    torch.cuda.synchronize()
    e_plain = (plain.double() - truth).abs().max().item()
    e_kern = (got.double() - truth).abs().max().item()
    assert e_kern <= 3.0 * e_plain + 1e-5, (e_kern, e_plain)


def _chip_smoke():
    """chip_smoke.py at the repo root, loaded by its path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_megaroll_matches_plain_rollout(card):
    """Every lane and step of the kernel's rollout against the plain
    policy and step from the kernel's own states (chip_smoke.py's
    rollout_step_check, which says why not free-running)."""
    from drake_ddp_tpu_torch.ops.megaroll import megaroll

    mc, kd = _cheetah_kernel_data(card)
    L, T, n, m = 96, 8, 37, 12
    gen = torch.Generator(device=card).manual_seed(1)
    x0, _ = _states(mc, L, card)
    rnd = lambda *s: torch.randn(s, generator=gen, device=card,
                                 dtype=torch.float64)
    U = torch.as_tensor(mc.U_STAND, dtype=torch.float64, device=card)
    tapes = (x0, torch.rand(L, generator=gen, device=card,
                            dtype=torch.float64),
             U[None, :, None] + 0.03 * rnd(T, m, L), 0.03 * rnd(T, m, L),
             0.005 * rnd(T, m, n, L), x0[None] + 0.01 * rnd(T, n, L))
    xs_k, us_k = megaroll(kd, *[a.float().contiguous() for a in tapes])
    torch.cuda.synchronize()
    ok, report = _chip_smoke().rollout_step_check(kd, tapes, xs_k, us_k)
    assert ok, report


def _rollout_tapes(mc, L, T, device):
    gen = torch.Generator(device=device).manual_seed(1)
    n, m = 37, 12
    x0, _ = _states(mc, L, device)
    rnd = lambda *s: torch.randn(s, generator=gen, device=device,
                                 dtype=torch.float64)
    U = torch.as_tensor(mc.U_STAND, dtype=torch.float64, device=device)
    return (x0, torch.rand(L, generator=gen, device=device,
                           dtype=torch.float64),
            U[None, :, None] + 0.03 * rnd(T, m, L), 0.03 * rnd(T, m, L),
            0.005 * rnd(T, m, n, L), x0[None] + 0.01 * rnd(T, n, L))


@pytest.mark.cuda
@pytest.mark.parametrize("L, T", [(133, 3), (133, 1), (3, 2), (1, 2),
                                  (1100, 2)])
def test_megaroll_team_edges(card, L, T):
    """The team kernel at a ragged L that leaves its last block partly
    empty (133 lanes, 2 a block), at one step, with fewer lanes than SMs
    (one lane a block), and with more lanes than 4 a block on every SM
    (blocks capped at the kernel's launch bounds of 4 lanes), held as
    test_megaroll_matches_plain_rollout."""
    from drake_ddp_tpu_torch.ops.megaroll import launch_config, megaroll

    mc, kd = _cheetah_kernel_data(card)
    cfg = launch_config(kd, L)
    assert cfg["blocks"] * cfg["lanes_per_block"] >= L
    assert cfg["lanes_per_block"] <= 4
    tapes = _rollout_tapes(mc, L, T, card)
    before = megaroll.launches
    xs_k, us_k = megaroll(kd, *[a.float().contiguous() for a in tapes])
    torch.cuda.synchronize()
    assert megaroll.launches == before + 1
    assert xs_k.shape == (T, 37, L) and us_k.shape == (T, 12, L)
    ok, report = _chip_smoke().rollout_step_check(kd, tapes, xs_k, us_k)
    assert ok, report


@pytest.mark.cuda
def test_team_kernels_raise_when_a_lane_does_not_fit_shared_memory(card):
    """A working set larger than a block's shared memory raises before
    any launch: there is no global-memory fallback."""
    from drake_ddp_tpu_torch.ops._table import StepKernelData
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.ops.megastep import megastep

    mc, kd0 = _cheetah_kernel_data(card)
    kd = StepKernelData(kd0.model, kd0.contact, kd0.dt, contact_iters=8)
    kd._struct.nc = 2000       # 2000 contacts: Jc alone would be 432 KB
    x, u = _states(mc, 8, card)
    tapes = [a.float().contiguous() for a in _rollout_tapes(mc, 8, 2, card)]
    steps, rolls = megastep.launches, megaroll.launches
    with pytest.raises(ValueError, match="shared memory"):
        megastep(kd, x.float(), u.float())
    with pytest.raises(ValueError, match="shared memory"):
        megaroll(kd, *tapes)
    assert (megastep.launches, megaroll.launches) == (steps, rolls)


def test_tree_levels_put_parents_first():
    """The bodies by depth that the device step runs level by level: each
    body once, every parent at a smaller depth than its children."""
    from drake_ddp_tpu_torch.ops._table import tree_levels

    parent = (-1, 0, 1, 2, 0, 4, 5, -1, 7, 3)
    starts, bodies = tree_levels(parent)
    assert starts == [0, 2, 5, 7, 9, 10]
    assert sorted(bodies) == list(range(len(parent)))
    depth = {b: d for d in range(len(starts) - 1)
             for b in bodies[starts[d]:starts[d + 1]]}
    assert all(p < 0 or depth[p] == depth[b] - 1
               for b, p in enumerate(parent))


@pytest.mark.cuda
def test_kernel_wrappers_reject_what_they_do_not_take(card):
    from drake_ddp_tpu_torch.ops.megastep import megastep

    mc, kd = _cheetah_kernel_data(card)
    x, u = _states(mc, 4, card)
    with pytest.raises(TypeError, match="float32"):
        megastep(kd, x, u)                              # float64
    with pytest.raises(ValueError, match="shape"):
        megastep(kd, x[:36].float(), u.float())
    with pytest.raises(ValueError, match="contiguous"):
        megastep(kd, x.float().T.contiguous().T, u.float())


@pytest.mark.cuda
def test_scenario_cheetah_solve_runs_on_the_kernels(card):
    """The per-scenario cheetah solve on the card (N 10, contact_iters 2):
    one megaroll launch per linesearch chunk and one megajac launch per
    fresh-derivative round, so neither plain route runs."""
    import dataclasses

    import numpy as np

    from drake_ddp_tpu_torch.examples import mini_cheetah as mc
    from drake_ddp_tpu_torch.ops.megajac import megajac
    from drake_ddp_tpu_torch.ops.megaroll import megaroll
    from drake_ddp_tpu_torch.utils.timing import PhaseTimer

    cfg = dataclasses.replace(mc.Config(), T=10 * 4e-3, contact_iters=2,
                              num_resolves=0, verbose=False)
    timer = PhaseTimer()
    roll0, jac0 = megaroll.launches, megajac.launches
    states, _, _, cost = mc.run(cfg, device=card, timer=timer)
    assert megaroll.launches - roll0 == timer.counts["rollout"] > 0
    assert megajac.launches - jac0 == timer.counts["jac"] > 0
    assert np.isfinite(states).all() and np.isfinite(cost)


@pytest.mark.cuda
def test_pendulum_on_the_card_takes_the_cpu_iterations(card):
    from drake_ddp_tpu_torch.examples import pendulum

    sols = {}
    for dev in ("cpu", card):
        ilqr = pendulum.build_solver(pendulum.Config(verbose=False),
                                     device=dev)
        _, _, _, cost = ilqr.Solve()
        sols[str(dev)] = (int(ilqr._solution.iterations), cost)
    (it_cpu, c_cpu), (it_card, c_card) = sols.values()
    assert it_card == it_cpu
    assert abs(c_card - c_cpu) <= 1e-3 * abs(c_cpu)
