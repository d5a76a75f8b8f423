"""Traffic driver ``multistart``: multi-start batches of one problem,
back to back, each one batched solve of its starts on the per-scenario
kernels (the call ``solver/multistart.solve_starts`` makes) and the best
kept by the same rule (the lowest cost among the starts that neither
diverged nor ended non-finite).  A batch runs until its slowest start
ends.  Batch b's starts are drawn as ``multistart_ilqr`` draws them (the
problem's own tape, then N(0, guess_scale^2) noise on it), from a fixed
set of draws (the traffic's ``pool_seed``) in the order the run's seed
draws: the starts are solved independently, so every seed does the same
work in another order, and runs of different seeds differ by the machine
alone.

The traffic file sets the starts a batch, the draws' scale, how many
starts of each batch the correctness check samples besides the best, and
the rounds of the traced stretch; the configuration file sets the model,
the problem and the solver.
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch

from portbench import check
from portbench.yardstick import keypoint_count


def batch_seed(seed: int, b: int) -> int:
    """The seed of batch ``b``'s draws (warm-up: b = -1, trace: -2)."""
    return (seed * 1_000_003 + b + 2) % (2 ** 63)


def pick_best(sols) -> torch.Tensor:
    """The index of the best start: the lowest final cost among the
    starts that neither diverged nor ended non-finite."""
    score = torch.where(sols.diverged | ~torch.isfinite(sols.cost),
                        torch.full_like(sols.cost, float("inf")), sols.cost)
    return torch.argmin(score)


def usable(sols) -> torch.Tensor:
    """(K,) starts whose state, tape, gains and cost are all finite."""
    fin = lambda a: torch.isfinite(a).flatten(1).all(1)
    return (fin(sols.x) & fin(sols.u) & fin(sols.K)
            & torch.isfinite(sols.cost))


class Driver:
    """Batches of one seed.  ``step(timer)`` runs one batch; of every
    batch the correctness check keeps the best start and a sample of the
    others drawn from the seed, with every start's cost and flags."""

    kind = "solve"

    def __init__(self, program, cfg: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.p, self.cfg, self.traffic = program, cfg, traffic
        self.dev, self.seed = device, seed
        self.system = program.build_system(cfg, device)
        self.K = int(traffic["starts"])
        self.N, self.n, self.m = cfg["N"], cfg["n"], cfg["m"]
        self.B = self.K
        self.scfg = program.ilqr_config(cfg)
        f32 = dict(dtype=torch.float32, device=device)
        dt = cfg["cost_scale_running"]
        self.prob = program.ILQRProblem(
            x0=torch.tensor(cfg["x0"], **f32),
            x_nom=torch.tensor(cfg["x_nom"], **f32),
            Q=dt * torch.diag(torch.tensor(cfg["Q_diag"], **f32)),
            R=dt * torch.diag(torch.tensor(cfg["R_diag"], **f32)),
            Qf=torch.diag(torch.tensor(cfg["Qf_diag"], **f32)),
            u_init=torch.tensor(cfg["u_init"], **f32)[None].repeat(
                self.N - 1, 1))
        self.records: List[Dict] = []
        self.batches = 0
        self.check_starts = min(int(traffic["check_starts"]), self.K)
        zero = lambda: torch.zeros((), dtype=torch.int64, device=device)
        self.failed, self.diverged = zero(), zero()

    def run_batch(self, b: int, timer=None, max_iters=None):
        K, u = self.K, self.prob.u_init
        pool = torch.Generator(device=self.dev).manual_seed(
            batch_seed(self.traffic["pool_seed"], b))
        noise = self.traffic["guess_scale"] * torch.randn(
            (K,) + tuple(u.shape), generator=pool, dtype=u.dtype,
            device=self.dev)
        if self.traffic["include_given"]:
            noise[0] = 0.0
        order = torch.randperm(K, device=self.dev, generator=torch.Generator(
            device=self.dev).manual_seed(batch_seed(self.seed, b)))
        scfg = (self.scfg if max_iters is None
                else self.scfg._replace(max_iters=max_iters))
        return self.p.solve_starts(self.system, scfg, self.prob,
                                   u[None] + noise[order], timer=timer)

    def sample(self, b: int) -> List[int]:
        """The starts of batch ``b`` the check reads besides the best."""
        return sorted(random.Random(batch_seed(self.seed, b)).sample(
            range(self.K), self.check_starts))

    def warm_up(self):
        """A batch of other draws, cut to a few rounds: every shape of the
        cell's batches."""
        self.run_batch(-1, max_iters=int(self.traffic["warmup_max_iters"]))

    def trace_step(self):
        """The traced stretch: the first rounds of a batch of other
        draws (every round of a batch does the same work)."""
        self.run_batch(-2, max_iters=int(self.traffic["trace_rounds"]))

    def shapes(self) -> Dict:
        s = self.cfg["solver"]
        return {"B": self.K, "N": self.N, "n": self.n, "m": self.m,
                "rollout_lanes": s["ls_parallel"] * self.K,
                "jac_lanes": keypoint_count(self.N, s["keypoints"]["minN"])
                * self.K, "root": s["root_seed"]}

    def readings(self, ref, control=False) -> Dict:
        return check.multistart_readings(ref, self.records, self.prob,
                                         control)

    def step(self, timer=None):
        """One batch of starts."""
        b = self.batches
        sols = self.run_batch(b, timer)
        best = pick_best(sols)
        ok = usable(sols)
        self.failed += (~sols.diverged & ~ok).sum()
        self.diverged += sols.diverged.sum()
        idx = torch.cat([torch.tensor(self.sample(b), device=self.dev),
                         best[None]])
        take = lambda a: a.index_select(0, idx)
        self.records.append({
            "index": b, "best_index": best, "costs": sols.cost,
            "diverged": sols.diverged,
            "x": take(sols.x), "u": take(sols.u), "K": take(sols.K),
            "cost": take(sols.cost), "checked_usable": take(ok)})
        self.batches += 1

    def summary(self) -> Dict:
        return {"batches": self.batches, "attempted": self.batches * self.K,
                "failed": int(self.failed), "diverged": int(self.diverged)}

    def release(self):
        pass
