"""A lane's per-step costs and Riccati gains do not depend on how its
batch is split: the same bits in a batch of B as in either half of it.
``parallel/`` shards a batch, and a float32 chain amplifies any rounding
that follows the batch size into another answer for the scenario.  On
the card a batched matrix-vector product picks its kernel by the batch
count, so the CUDA case (marked ``cuda``, at the flagship's widths) is
the one that holds the solver's products to this; the CPU case runs the
same check at a small size.  A lane alone (B = 1) is not held: the
batched matrix products take another kernel there."""

import pytest
import torch

from drake_ddp_tpu_torch.solver.ilqr import (ILQRConfig, ILQRProblem,
                                             _backward_pass, _cost_steps)

# (B, N, n, m): the flagship's batch and widths on the card, small here
SIZES = {"cpu": (16, 12, 4, 1), "cuda": (256, 50, 37, 12)}


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_a_lanes_costs_and_gains_do_not_depend_on_its_batch(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    B, N, n, m = SIZES[device]
    g = torch.Generator(device=device).manual_seed(3)
    rand = lambda *s: torch.randn(s, generator=g, device=device)
    spd = lambda k: (lambda A: A @ A.transpose(-1, -2) / k + torch.eye(
        k, device=device))(rand(B, k, k))
    prob = ILQRProblem(x0=rand(B, n), x_nom=rand(B, n), Q=spd(n), R=spd(m),
                       Qf=spd(n), u_init=rand(B, N - 1, m))
    x, u = rand(B, N, n), rand(B, N - 1, m)
    fx = torch.eye(n, device=device) + 0.05 * rand(B, N - 1, n, n)
    fu = 0.05 * rand(B, N - 1, n, m)
    reg = torch.full((B,), 1e-6, device=device)
    cfg = ILQRConfig(num_steps=N)
    full = (_cost_steps(prob, x, u),) + _backward_pass(cfg, prob, x, u, fx,
                                                       fu, reg)
    for part in (slice(0, B // 2), slice(B // 2, B)):
        p = ILQRProblem(*(None if a is None else a[part] for a in prob))
        got = (_cost_steps(p, x[part], u[part]),) + _backward_pass(
            cfg, p, x[part], u[part], fx[part], fu[part], reg[part])
        for name, a, b in zip(("costs", "kappa", "K", "dV"), full, got):
            assert torch.equal(a[part], b), (name, part)
