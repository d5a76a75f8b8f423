"""The reference, built from the benchmark's own files, agrees with the
port's plain route at a tiny size on the CPU: the lane step and the step
Jacobians of both configurations, the Riccati gains, the cost and the
keypoint interpolation."""

import importlib
import json
from pathlib import Path

import pytest
import torch

from portbench.reference import robot
from portbench.reference.solver import (interpolate, riccati_gains,
                                        set_interval_steps, tf32,
                                        tf32_matmul, trajectory_cost)

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("mini_cheetah_flagship", "panda_fr3_side")
L = 6


def load(name):
    return json.loads((ROOT / "portbench" / "configs"
                       / f"{name}.json").read_text())


def port_system(cfg):
    ex = importlib.import_module(
        f"drake_ddp_tpu_torch.examples.{cfg['program']['example']}")
    system, _ = ex.build_system(ex.Config(**cfg["program"]["config"]),
                                device="cpu")
    return system


def lanes(cfg, gen):
    n, m = cfg["n"], cfg["m"]
    x = torch.tensor(cfg["x0"], dtype=torch.float64)[:, None].repeat(1, L)
    nq = cfg["sizes"]["nq"]
    x[nq:] += 0.2 * torch.randn((n - nq, L), generator=gen,
                                dtype=torch.float64)
    u = torch.tensor(cfg["u_init"], dtype=torch.float64)[:, None] \
        + 0.5 * torch.randn((m, L), generator=gen, dtype=torch.float64)
    return x, u


@pytest.mark.parametrize("name", CONFIGS)
def test_step_and_jacobians_agree(name):
    torch.set_num_threads(1)
    cfg = load(name)
    system = port_system(cfg)
    _, _, step, jac, jac_root = robot.build(cfg["model"], "cpu")
    x, u = lanes(cfg, torch.Generator().manual_seed(0))
    xn = step(x, u)
    assert torch.equal(xn, system.lane_step_fn(x, u))
    assert torch.equal(step(x.float(), u.float()),
                       system.lane_step_fn(x.float(), u.float()))
    for got, want in ((jac(x, u), system.lane_jac_fn(x, u)),
                      (jac_root(x, u, xn), system.lane_jac_root_fn(x, u, xn))):
        for a, b in zip(got, want):
            assert torch.allclose(a, b, rtol=1e-10, atol=1e-12)


def test_riccati_cost_and_interpolation_agree():
    from drake_ddp_tpu_torch.solver import keypoints as kp
    from drake_ddp_tpu_torch.solver.ilqr import (ILQRConfig, ILQRProblem,
                                                 _backward_pass, _cost_steps)
    g = torch.Generator().manual_seed(1)
    B, N, n, m = 3, 10, 5, 2
    r = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    x, u = r(B, N, n), r(B, N - 1, m)
    fx = torch.eye(n, dtype=torch.float64) + 0.1 * r(B, N - 1, n, n)
    fu = 0.1 * r(B, N - 1, n, m)
    spd = lambda k: (lambda a: a @ a.transpose(-1, -2)
                     + torch.eye(k, dtype=torch.float64))(r(B, k, k))
    prob = ILQRProblem(x0=x[:, 0], x_nom=r(B, n), Q=spd(n), R=spd(m),
                       Qf=spd(n), u_init=u)
    reg = torch.full((B,), 1e-3, dtype=torch.float64)
    _, K, _ = _backward_pass(ILQRConfig(num_steps=N), prob, x, u, fx, fu, reg)
    K_ref = riccati_gains(x, u, fx, fu, prob.x_nom, prob.Q, prob.R, prob.Qf,
                          reg)
    assert torch.allclose(K, K_ref, rtol=1e-9, atol=1e-12)
    cost = _cost_steps(prob, x, u).sum(-1)
    assert torch.allclose(cost, trajectory_cost(
        x, u, prob.x_nom, prob.Q, prob.R, prob.Qf), rtol=1e-12)
    for minN in (1, 3, 8):
        keys = set_interval_steps(N, minN)
        assert keys == list(
            kp.set_interval_mask(N, minN).nonzero()[0])
        vals = r(B, len(keys), 2, 2)
        mask = torch.as_tensor(kp.set_interval_mask(N, minN))[None].expand(
            B, N - 1)
        full = torch.zeros(B, N - 1, 2, 2, dtype=torch.float64)
        full[:, keys] = vals
        assert torch.allclose(interpolate(N, keys, vals),
                              kp.interpolate_stack(mask, full))


def test_the_controls_tf32_products_round_to_ten_bits():
    g = torch.Generator().manual_seed(2)
    a = torch.randn(64, 27, 27, generator=g)
    b = torch.randn(64, 27, 7, generator=g)
    rel = ((tf32(a) - a) / a).abs().max()
    assert 2 ** -13 < rel <= 2 ** -11
    assert torch.equal(tf32(tf32(a)), tf32(a))
    gap = (tf32_matmul(a, b).double() - a.double() @ b.double()).abs().max()
    assert gap > 100 * (a @ b - a.double() @ b.double()).abs().max()
