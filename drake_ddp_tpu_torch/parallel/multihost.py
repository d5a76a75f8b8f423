"""Scenario batching over several processes: a 2-D (process, device) mesh.

Port of ``drake_ddp_tpu/parallel/multihost.py``.  Every process calls
:func:`initialize` (``torch.distributed.init_process_group`` over a
``tcp://`` rendezvous), builds :func:`host_device_mesh` and passes its
own scenarios through :func:`process_local_problem`;
:func:`~drake_ddp_tpu_torch.parallel.sharding.batched_solve` and
``batched_mpc`` take that mesh unchanged.  Scenario data parallelism
needs no collective inside the solve: each process solves its local
scenarios on its own cards, and only the three summary sums are
all-reduced over the processes, once per call, after the solve's own
final synchronisation.

The backend is explicit and nothing switches it on its own:

- ``"nccl"`` (the default) all-reduces tensors on the process's card.
  NCCL refuses two ranks on one card, so :func:`initialize` raises, naming
  ``backend="gloo"``, when two ranks name the same card;
- ``"gloo"`` all-reduces host tensors: on the CPU, and for several
  processes that share one card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem

BACKENDS = ("nccl", "gloo")
_DEVICE_KEY = "drake_ddp_tpu_torch/card/"


def _card_id(device: torch.device) -> str:
    return str(torch.cuda.get_device_properties(device).uuid)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str = "nccl",
               device: Optional[torch.device] = None) -> None:
    """Join the process group (idempotent: a second call with the same
    backend returns).

    ``coordinator_address``: ``"host:port"`` of process 0, which serves
    the rendezvous store there.  ``backend``: ``"nccl"`` (the process's
    card, ``device``, default the current one) or ``"gloo"``.  NCCL on a
    build or machine without it, or with a card that another rank also
    names, raises, as does a backend other than the joined group's."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}"
                             f", not {backend!r}")
        return
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError(
                "NCCL is unavailable here (no card, or a torch build "
                "without it); pass backend='gloo' for host collectives")
        device = torch.device("cuda" if device is None else device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    host, _, port = coordinator_address.rpartition(":")
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0)
    if backend == "nccl":
        store.set(f"{_DEVICE_KEY}{process_id}", _card_id(device))
        keys = [f"{_DEVICE_KEY}{r}" for r in range(num_processes)]
        store.wait(keys)
        cards = [store.get(k).decode() for k in keys]
        # every rank has read the cards before any leaves (process 0's
        # exit would close the store under the others)
        store.set(f"{_DEVICE_KEY}read/{process_id}", "1")
        store.wait([f"{_DEVICE_KEY}read/{r}" for r in range(num_processes)])
        shared = [r for r, c in enumerate(cards)
                  if c == cards[process_id] and r != process_id]
        if shared:
            raise ValueError(
                f"ranks {process_id} and {shared[0]} name the same card "
                f"({device}), which NCCL refuses; pass backend='gloo' for "
                "processes that share a card")
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id)


@dataclasses.dataclass(frozen=True)
class HostDeviceMesh:
    """A ``(process, device)`` grid: row r holds rank r's cards (every
    process sees its own; the rows are alike).  ``shape`` is (world size,
    local devices); ``local`` is this process's row."""

    grid: Tuple[Tuple[torch.device, ...], ...]
    rank: int

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.grid), len(self.grid[0])

    @property
    def local(self) -> Tuple[torch.device, ...]:
        return self.grid[self.rank]


def host_device_mesh(devices: Optional[Sequence] = None) -> HostDeviceMesh:
    """The (process, device) mesh over this process's ``devices``;
    ``(1, n)`` in a single-process run, so code written against it runs
    unchanged on one host.

    By default a single process takes every local card, and a process of
    a group of several takes the card it is bound to
    (``torch.cuda.current_device()``, which ``initialize`` sets under
    NCCL): with the usual launch of one process per card, ranks that each
    took every card would solve on each other's cards."""
    from drake_ddp_tpu_torch.parallel.sharding import scenario_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is None:
        devices = (scenario_mesh() if world == 1
                   else [torch.device("cuda", torch.cuda.current_device())])
    local = tuple(torch.device(d) for d in devices)
    return HostDeviceMesh(grid=(local,) * world, rank=rank)


def process_local_problem(mesh: HostDeviceMesh,
                          probs_local) -> ILQRProblem:
    """This process's ``(local_batch, ...)`` scenarios (numpy arrays or
    tensors) as an ILQRProblem of tensors on its first card.  Every
    process passes the same local batch; the global batch is
    ``local_batch * world size``, and no process gathers it."""
    dev = mesh.local[0]
    return ILQRProblem(*(None if a is None else torch.as_tensor(a, device=dev)
                         for a in probs_local))


def spans_processes(mesh) -> bool:
    """Whether ``mesh`` is a HostDeviceMesh of more than one process."""
    return isinstance(mesh, HostDeviceMesh) and mesh.shape[0] > 1


def all_reduce_sums(cost, diverged, iterations, local_batch: int):
    """The three sums all-reduced over the process group, as float64:
    on the card under NCCL, as host tensors under gloo.  Returns them and
    the global batch (every process holds ``local_batch``)."""
    dev = (cost.device if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    sums = torch.stack([cost.double(), diverged.double(),
                        iterations.double()]).to(dev)
    dist.all_reduce(sums)
    return (sums[0], sums[1], sums[2],
            local_batch * dist.get_world_size())
