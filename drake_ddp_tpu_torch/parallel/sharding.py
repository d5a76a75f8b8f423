"""Scenario batching over a mesh of devices: each device solves its own
contiguous shard of the batch.

Port of ``drake_ddp_tpu/parallel/sharding.py``.  The JAX package runs
the whole solve inside ``shard_map`` and reduces three statistics with
``psum``.  Here a mesh is a sequence of torch devices (a device may
appear more than once, so the sharding runs on the CPU as
``["cpu", "cpu"]``).  Every problem leaf is split on its leading axis
into one contiguous shard per mesh entry, and each shard runs
:func:`~drake_ddp_tpu_torch.solver.batched.solve_ilqr_batched` or
:func:`~drake_ddp_tpu_torch.mpc.driver.mpc_solve_batched` on its device.

The solver loop is driven from the host: it synchronises with the card
at every linesearch chunk and iteration (hundreds of times per MPC
chunk).  Shards driven one after another from one Python thread would
run one card at a time, so the shards on distinct cards get a host
thread each (torch releases the interpreter lock inside its kernels and
copies); see :func:`_threaded` for the shards that run in order.

The only traffic between devices is three scalars per call: the sums of
the final costs, diverged flags and iterations.  Under a
:class:`~drake_ddp_tpu_torch.parallel.multihost.HostDeviceMesh` of
several processes they are also all-reduced over the processes
(:mod:`~drake_ddp_tpu_torch.parallel.multihost`).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import torch

from drake_ddp_tpu_torch._device import resolve_device, same_device
from drake_ddp_tpu_torch.dynamics.base import DiscreteSystem
from drake_ddp_tpu_torch.mpc.driver import MPCConfig, mpc_solve_batched
from drake_ddp_tpu_torch.multibody.plant import is_multibody
from drake_ddp_tpu_torch.solver.batched import solve_ilqr_batched
from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig, ILQRProblem

Mesh = Sequence[Union[str, torch.device]]
# a system, or a function that builds it on a given device
SystemOrBuilder = Union[DiscreteSystem,
                        Callable[[torch.device], DiscreteSystem]]


def scenario_mesh(n_devices: Optional[int] = None,
                  device_type: str = "cuda") -> List[torch.device]:
    """A 1-D mesh: the first ``n_devices`` cards (default: every visible
    card); ``device_type="cpu"`` gives ``n_devices`` (default 1) entries
    of the CPU."""
    if device_type == "cpu":
        return [torch.device("cpu")] * (n_devices or 1)
    resolve_device(device_type)          # raises without a card
    devs = [torch.device(device_type, i)
            for i in range(torch.cuda.device_count())]
    return devs if n_devices is None else devs[:n_devices]


def _devices(mesh) -> List[torch.device]:
    """The devices of this process: a 1-D mesh, or the process's own row
    of a HostDeviceMesh."""
    local = getattr(mesh, "local", mesh)
    return [resolve_device(d) for d in local]


def shard_problems(mesh: Mesh, probs: ILQRProblem) -> List[ILQRProblem]:
    """One contiguous shard of ``probs`` (leading axis = scenario) per
    mesh entry, each on its device.  Numpy leaves are taken as tensors;
    None leaves stay None."""
    devs = _devices(mesh)
    cut = lambda a: (None if a is None else
                     torch.as_tensor(a).tensor_split(len(devs)))
    parts = [cut(a) for a in probs]
    return [ILQRProblem(*(None if p is None else p[i].to(d)
                          for p in parts))
            for i, d in enumerate(devs)]


class BatchStats(NamedTuple):
    """The batch's summary, reduced over every shard (and process)."""

    mean_cost: torch.Tensor         # scalar, the cost's dtype
    num_diverged: torch.Tensor      # int64 scalar
    total_iterations: torch.Tensor  # int64 scalar


def _batch(probs: ILQRProblem, n_shards: int) -> int:
    batch = probs.x0.shape[0]
    if batch % n_shards:
        raise ValueError(f"batch {batch} must divide mesh size {n_shards}")
    return batch


def _systems(system: SystemOrBuilder, devs: List[torch.device]):
    """The system of each shard: built once per device by a builder, or
    the given system, which a multibody system must live on every shard's
    device to be (its kernel tables are on its device)."""
    if not isinstance(system, DiscreteSystem):
        built = {}
        for d in devs:
            if d not in built:
                built[d] = system(d)
        return [built[d] for d in devs]
    if is_multibody(system):
        home = system.params[0].device
        for d in devs:
            if not same_device(d, home):
                raise ValueError(
                    f"the multibody system lives on {home}, a shard on "
                    f"{d}; pass build_system(device) to build it on each "
                    "shard's device")
    return [system] * len(devs)


def _on_device(fn, dev: torch.device):
    """``fn()`` with ``dev`` as the current card (its default stream)."""
    if dev.type != "cuda":
        return fn()
    with torch.cuda.device(dev):
        return fn()


def _threaded(devs: List[torch.device], routes: dict) -> bool:
    """Whether the shards get a host thread each: when they are on more
    than one card and differentiate with the megajac kernel.  The plain
    lane Jacobians run ``torch.func`` transforms, whose forward-AD levels
    all threads of a process share, so those shards run in order, as do
    shards that share one device."""
    return (len(set(devs)) > 1 and all(d.type == "cuda" for d in devs)
            and routes.get("deriv_kernel", "megajac") == "megajac")


def _run_shards(fns, devs, threaded: bool):
    """Run ``fns[i]()`` on ``devs[i]``, each in a host thread of its own
    if ``threaded``; every result is read (an exception in a shard raises
    here)."""
    if not threaded:
        return [_on_device(f, d) for f, d in zip(fns, devs)]
    with ThreadPoolExecutor(max_workers=len(fns)) as pool:
        futs = [pool.submit(_on_device, f, d) for f, d in zip(fns, devs)]
        return [f.result() for f in futs]


def _gather(records, dev: torch.device):
    """Concatenate per-shard records (NamedTuples of tensors with a
    leading batch axis, nested NamedTuples or None) on ``dev``; one
    shard's record is returned as it is."""
    if len(records) == 1:
        return records[0]
    first = records[0]
    fields = []
    for i, f in enumerate(first):
        parts = [r[i] for r in records]
        if f is None:
            fields.append(None)
        elif isinstance(f, tuple):
            fields.append(_gather(parts, dev))
        else:
            fields.append(torch.cat([p.to(dev) for p in parts]))
    return type(first)(*fields)


def _stats(mesh, sums, batch: int, dtype) -> BatchStats:
    """BatchStats from the per-shard (cost, diverged, iterations) sums;
    all-reduced over the processes of a HostDeviceMesh."""
    from drake_ddp_tpu_torch.parallel import multihost

    dev = sums[0][0].device
    cost, div, its = (sum(s[k].to(dev) for s in sums) for k in range(3))
    if multihost.spans_processes(mesh):
        cost, div, its, batch = multihost.all_reduce_sums(
            cost, div, its, batch)
    return BatchStats(mean_cost=(cost / batch).to(dtype),
                      num_diverged=div.to(torch.int64),
                      total_iterations=its.to(torch.int64))


def _shard_sums(cost, diverged, iterations):
    return (torch.sum(cost), torch.sum(diverged.to(torch.int32)),
            torch.sum(iterations))


def batched_solve(system: SystemOrBuilder, cfg: ILQRConfig,
                  probs: ILQRProblem, mesh: Optional[Mesh] = None,
                  **routes):
    """Solve a scenario batch, sharded over the mesh.

    Args:
        system: the system, or ``build_system(device)`` (a multibody
            system must be built on each shard's device).
        cfg: the solver configuration.
        probs: ILQRProblem with a leading batch axis on every leaf; the
            batch must divide the mesh size.
        mesh: scenario mesh (default :func:`scenario_mesh`: every card),
            or a HostDeviceMesh, whose process row solves ``probs`` as
            this process's local scenarios.
        routes: ``rollout_kernel``, ``deriv_kernel`` and ``root_seed`` of
            :func:`~drake_ddp_tpu_torch.solver.batched.solve_ilqr_batched`
            (default: its own; a system without kernel data, such as an
            analytic one, runs its lane step and lane Jacobian).
    Returns:
        (solutions, stats): the ILQRSolution of the whole batch (one
        shard's is returned as it is; several are concatenated on the
        first mesh device), and BatchStats.
    """
    devs = _devices(mesh if mesh is not None else scenario_mesh())
    batch = _batch(probs, len(devs))
    systems = _systems(system, devs)
    shards = shard_problems(devs, probs)
    kw = _routes(systems[0], routes)

    def solve(s, p):
        sol = solve_ilqr_batched(s, cfg, p, **kw)
        return sol, _shard_sums(sol.cost, sol.diverged, sol.iterations)

    out = _run_shards([lambda s=s, p=p: solve(s, p)
                       for s, p in zip(systems, shards)], devs,
                      _threaded(devs, kw))
    sols = _gather([o[0] for o in out], devs[0])
    return sols, _stats(mesh, [o[1] for o in out], batch, sols.cost.dtype)


def batched_mpc(system: SystemOrBuilder, cfg: ILQRConfig,
                probs: ILQRProblem, mpc: MPCConfig,
                x_nom_shift: Optional[torch.Tensor] = None,
                mesh: Optional[Mesh] = None,
                consec0: Optional[torch.Tensor] = None,
                rescue_u: Optional[torch.Tensor] = None, **routes):
    """Receding-horizon MPC over a sharded scenario batch: every shard
    runs the initial solve and ``mpc.num_resolves`` warm-started resolves
    (:func:`~drake_ddp_tpu_torch.mpc.driver.mpc_solve_batched`) on its
    device.

    ``system``, ``mesh`` and ``routes`` as in :func:`batched_solve`.
    ``x_nom_shift`` ((n,)) goes to every shard; ``consec0`` ((B,)) and a
    per-lane ``rescue_u`` ((B, N-1, m)) are split like the problems, a
    shared one ((N-1, m)) goes to every shard.  Returns (MPCResult of the whole batch, BatchStats of the last
    solve's costs and of every solve's diverged flags and iterations).
    """
    devs = _devices(mesh if mesh is not None else scenario_mesh())
    batch = _batch(probs, len(devs))
    systems = _systems(system, devs)
    shards = shard_problems(devs, probs)
    split = lambda a: [p.to(d) for p, d in zip(a.tensor_split(len(devs)),
                                               devs)]
    consecs = [None] * len(devs) if consec0 is None else split(consec0)
    rescues = ([None] * len(devs) if rescue_u is None
               else split(rescue_u) if rescue_u.dim() == 3
               else [rescue_u.to(d) for d in devs])
    kw = _routes(systems[0], routes)

    def solve(i):
        d = devs[i]
        res = mpc_solve_batched(
            systems[i], cfg, shards[i], mpc,
            None if x_nom_shift is None else x_nom_shift.to(d),
            consec0=consecs[i], rescue_u=rescues[i], **kw)
        return res, _shard_sums(res.costs[:, -1], res.diverged,
                                res.iterations)

    out = _run_shards([lambda i=i: solve(i) for i in range(len(devs))],
                      devs, _threaded(devs, kw))
    res = _gather([o[0] for o in out], devs[0])
    return res, _stats(mesh, [o[1] for o in out], batch, res.costs.dtype)


def _routes(system: DiscreteSystem, routes: dict) -> dict:
    """The solver's kernel keywords: the caller's, else the batched
    solver's defaults for a multibody system, the system's own lane step
    and lane Jacobian for one without kernel data."""
    if routes or is_multibody(system):
        return routes
    return dict(rollout_kernel="plain", deriv_kernel="lane")
