"""Traffic driver ``mpc_chain``: one continuous receding-horizon chain
of a scenario batch through the program's ``mpc_solve_batched``, one
resolve a call, handed on from call to call as the chain's own resolves
hand on (the shifted control tape, gains and state reference of the last
solution, the target advanced, the dead latch and the failure counts
carried), so that each resolve is timed alone.

The traffic file sets the batch, how many resolves the correctness check
samples, and the short chain that warms up; the configuration file sets
the model, the problem and the solver.
"""

from __future__ import annotations

import random
from typing import Dict, List

import torch

from portbench import check
from portbench.yardstick import chain_health, keypoint_count


def shift_tape(a: torch.Tensor, rs: int) -> torch.Tensor:
    """(B, T, ...) tape: drop the first ``rs`` entries of the time axis
    and repeat the last one ``rs`` times."""
    return torch.cat([a[:, rs:], a[:, -1:].expand(-1, rs, *a.shape[2:])],
                     dim=1)


class Driver:
    """The chain of one seed.  ``step(timer)`` runs one resolve and its
    handoff; ``records`` keeps, for the correctness check, the inputs and
    outputs of a sample of the resolves drawn from the seed (and always
    the last one)."""

    kind = "mpc"

    def __init__(self, program, cfg: Dict, traffic: Dict, seed: int,
                 device: torch.device):
        self.p, self.cfg, self.traffic = program, cfg, traffic
        self.dev = device
        self.system = program.build_system(cfg, device)
        self.B = int(traffic["batch"])
        self.N, self.n, self.m = cfg["N"], cfg["n"], cfg["m"]
        mp = cfg["mpc"]
        self.rs = mp["replan_steps"]
        self.scfg = program.ilqr_config(cfg)
        self.mpcc = program.MPCConfig(
            num_resolves=0, replan_steps=self.rs,
            policy_warm_start=mp["policy_warm_start"],
            freeze_diverged=mp["freeze_diverged"],
            freeze_after=mp["freeze_after"],
            resolve_cost_ceiling=mp["resolve_cost_ceiling"])
        f32 = dict(dtype=torch.float32, device=device)
        self.shift = torch.zeros(self.n, **f32)
        self.shift[mp["shift_index"]] = (mp["target_vel"] * cfg["model"]["dt"]
                                         * self.rs)
        self.rescue = torch.tensor(cfg["u_init"], **f32)[None].repeat(
            self.N - 1, 1)
        self.seed = seed
        self.keep = int(traffic["check_resolves"])
        self.reset(seed)

    def reset(self, seed: int):
        """Start the chain of ``seed`` afresh, with nothing counted."""
        self.prob, self.consec = self.problem(seed)
        self.rng = random.Random(seed)
        self.records: List[Dict] = []
        self.resolves = 0
        self.lane_resolves = 0
        zero = lambda: torch.zeros((), dtype=torch.int64, device=self.dev)
        self.healthy, self.failed = zero(), zero()
        self.div_series: List[torch.Tensor] = []
        self.dead_series: List[torch.Tensor] = []
        self.last = None

    def warm_up(self):
        """A short chain of another seed (every shape of the cell's
        resolves), then the seed's own chain from its start."""
        self.reset(self.seed ^ 0x5EED)
        for _ in range(int(self.traffic["warmup_resolves"])):
            self.step()
        self.reset(self.seed)

    def trace_step(self):
        """The traced stretch: the chain's next resolve."""
        self.step()

    def shapes(self) -> Dict:
        s = self.cfg["solver"]
        return {"B": self.B, "N": self.N, "n": self.n, "m": self.m,
                "rollout_lanes": s["ls_parallel"] * self.B,
                "jac_lanes": keypoint_count(self.N, s["keypoints"]["minN"])
                * self.B, "root": s["root_seed"]}

    def readings(self, ref, control=False) -> Dict:
        return check.mpc_readings(ref, self.checked_records(),
                                  self.cfg["mpc"], control)

    def problem(self, seed: int):
        """The chain's first problem: the configuration's x0 with velocity
        jitter, the standing tape, zero gains.  The jitter of the B lanes
        is one fixed set (the traffic's ``pool_seed``) in the order the
        seed draws: lanes are solved independently, so every seed does the
        same work on other lanes, and runs of different seeds differ by
        the machine alone."""
        cfg, B, N, n, m = self.cfg, self.B, self.N, self.n, self.m
        f32 = dict(dtype=torch.float32, device=self.dev)
        jit = cfg["x0_jitter"]
        k = jit["from_index"]
        pool = torch.Generator(device=self.dev).manual_seed(
            self.traffic["pool_seed"])
        jitter = jit["scale"] * torch.randn((B, n - k), generator=pool, **f32)
        order = torch.randperm(B, device=self.dev, generator=torch.Generator(
            device=self.dev).manual_seed(seed))
        x0 = torch.tensor(cfg["x0"], **f32)[None].repeat(B, 1)
        x0[:, k:] += jitter[order]
        tile = lambda a: a[None].expand(B, *a.shape).contiguous()
        dt = cfg["cost_scale_running"]
        prob = self.p.ILQRProblem(
            x0=x0, x_nom=tile(torch.tensor(cfg["x_nom"], **f32)),
            Q=tile(dt * torch.diag(torch.tensor(cfg["Q_diag"], **f32))),
            R=tile(dt * torch.diag(torch.tensor(cfg["R_diag"], **f32))),
            Qf=tile(torch.diag(torch.tensor(cfg["Qf_diag"], **f32))),
            u_init=tile(torch.tensor(cfg["u_init"], **f32)[None].repeat(
                N - 1, 1)),
            K_init=torch.zeros((B, N - 1, m, n), **f32),
            x_ref_init=x0[:, None].repeat(1, N, 1),
            frozen=torch.zeros(B, dtype=torch.bool, device=self.dev))
        return prob, torch.zeros(B, dtype=torch.int32, device=self.dev)

    def step(self, timer=None):
        """One resolve of the chain, then its handoff."""
        prob, consec = self.prob, self.consec
        res = self.p.mpc_solve_batched(
            self.system, self.scfg, prob, self.mpcc, self.shift,
            rollout_kernel=self.cfg["solver"]["rollout_kernel"],
            deriv_kernel=self.cfg["solver"]["deriv_kernel"],
            consec0=consec, rescue_u=self.rescue, timer=timer)
        rs = self.rs
        self.prob = prob._replace(
            x0=res.final_x[:, rs], u_init=shift_tape(res.final_u, rs),
            x_nom=prob.x_nom + self.shift[None],
            K_init=shift_tape(res.final_K, rs),
            x_ref_init=shift_tape(res.final_x, rs), frozen=res.dead)
        self.consec = res.consec
        div = res.diverged[:, 0]
        self.healthy += (~div).sum()
        usable = (torch.isfinite(res.final_x).flatten(1).all(1)
                  & torch.isfinite(res.final_u).flatten(1).all(1)
                  & torch.isfinite(res.final_K).flatten(1).all(1)
                  & torch.isfinite(res.costs[:, 0]))
        self.failed += (~div & ~usable).sum()
        self.div_series.append(div.float().mean())
        self.dead_series.append(res.dead.float().mean())
        rec = {"index": self.resolves, "prob": prob, "consec0": consec,
               "res": res}
        i = self.resolves
        if i < self.keep:
            self.records.append(rec)
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep:
                self.records[j] = rec
        self.last = rec
        self.resolves += 1
        self.lane_resolves += self.B

    def checked_records(self) -> List[Dict]:
        """The sampled resolves and the last one, in chain order."""
        recs = {r["index"]: r for r in self.records}
        if self.last is not None:
            recs[self.last["index"]] = self.last
        return [recs[k] for k in sorted(recs)]

    def summary(self) -> Dict:
        div = [float(v) for v in self.div_series]
        dead = [float(v) for v in self.dead_series]
        return {"resolves": self.resolves, "attempted": self.lane_resolves,
                "healthy": int(self.healthy), "failed": int(self.failed),
                "chain_health": chain_health(div, dead) if div else None,
                "diverged_per_resolve": div, "dead_per_resolve": dead}

    def release(self):
        """Drop the chain's state but the records the check reads."""
        self.prob = self.consec = None
