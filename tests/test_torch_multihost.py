"""The port's parallel/multihost.py: a real two-process run over the gloo
backend (each process solves its own 8 cart-pole MPC scenarios and the
summary sums are all-reduced across the two), held to
``drake_ddp_tpu.parallel.batched_mpc`` of the same 16 scenarios on the
conftest's 8 CPU devices (costs rtol 1e-4, iterations and diverged
exactly) and to the port's one-process run of them; and NCCL asked for
where there is none.

Run as a script, this file is one worker process:

    python tests/test_torch_multihost.py <rank> <world size> <port>

prints ``RESULT <mean_cost> <num_diverged> <total_iterations>`` and a
``LANES`` line of its scenarios' final costs and iterations (JSON)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

N, LOCAL_BATCH, WORLD = 10, 8, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _local_problems(rank):
    """Rank ``rank``'s scenarios (tests/multihost_worker.py's draws)."""
    rng = np.random.default_rng(100 + rank)
    x0 = np.zeros((LOCAL_BATCH, 4), np.float32)
    x0[:, 1] = np.pi + 0.2 * rng.standard_normal(LOCAL_BATCH)
    tile = lambda a: np.tile(np.asarray(a, np.float32), (LOCAL_BATCH, 1, 1))
    return dict(x0=x0,
                x_nom=np.tile(np.array([0, np.pi, 0, 0], np.float32),
                              (LOCAL_BATCH, 1)),
                Q=tile(0.01 * np.eye(4)), R=tile(0.001 * np.eye(1)),
                Qf=tile(10 * np.eye(4)),
                u_init=np.zeros((LOCAL_BATCH, N - 1, 1), np.float32))


def _mpc(probs, mesh):
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu_torch.mpc.driver import MPCConfig
    from drake_ddp_tpu_torch.parallel import batched_mpc
    from drake_ddp_tpu_torch.solver.ilqr import ILQRConfig

    return batched_mpc(cart_pole_system(dt=1e-2),
                       ILQRConfig(num_steps=N, max_iters=3, beta=0.5),
                       probs, MPCConfig(num_resolves=2, replan_steps=2),
                       mesh=mesh)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_mpc(probs):
    """``drake_ddp_tpu.parallel.batched_mpc`` of the same problems and
    configuration (the JAX reference)."""
    import jax.numpy as jnp

    from drake_ddp_tpu.dynamics.analytic import cart_pole_system
    from drake_ddp_tpu.mpc.driver import MPCConfig
    from drake_ddp_tpu.parallel import batched_mpc
    from drake_ddp_tpu.solver.ilqr import ILQRConfig, ILQRProblem

    return batched_mpc(cart_pole_system(dt=1e-2),
                       ILQRConfig(num_steps=N, max_iters=3, beta=0.5),
                       ILQRProblem(**{k: jnp.asarray(v)
                                      for k, v in probs.items()}),
                       MPCConfig(num_resolves=2, replan_steps=2))


def test_two_process_mpc_matches_one_process():
    import pytest
    import torch

    pytest.importorskip("jax")
    from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem

    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         port], stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        text=True) for r in range(WORLD)]
    try:
        # the references of the 16 scenarios, while the workers run
        both = {k: np.concatenate([_local_problems(r)[k]
                                   for r in range(WORLD)])
                for k in _local_problems(0)}
        jres, jstats = _jax_mpc(both)
        res, stats = _mpc(ILQRProblem(**{k: torch.as_tensor(v)
                                         for k, v in both.items()}),
                          ["cpu"])
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    line = lambda out, tag: next(l for l in out.splitlines()
                                 if l.startswith(tag))
    results = [line(o, "RESULT") for o in outs]
    assert results[0] == results[1], results        # the same global sums
    mean_cost, num_div, total_it = results[0].split()[1:]
    lanes = [json.loads(line(o, "LANES")[len("LANES "):]) for o in outs]
    costs = np.concatenate([np.asarray(l["costs"]) for l in lanes])
    iters = np.concatenate([np.asarray(l["iterations"]) for l in lanes])

    # against the JAX package's batched_mpc of the same 16 scenarios
    assert int(num_div) == int(jstats.num_diverged)
    assert int(total_it) == int(jstats.total_iterations)
    assert float(mean_cost) == pytest.approx(float(jstats.mean_cost),
                                             rel=1e-4)
    np.testing.assert_allclose(costs, np.asarray(jres.costs)[:, -1],
                               rtol=1e-4)
    np.testing.assert_array_equal(iters, np.asarray(jres.iterations))

    # against the port's one-process run of them
    assert int(num_div) == int(stats.num_diverged)
    assert int(total_it) == int(stats.total_iterations)
    assert float(mean_cost) == pytest.approx(float(stats.mean_cost),
                                             rel=1e-6)
    np.testing.assert_allclose(costs, res.costs[:, -1].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(iters, res.iterations.numpy())

    # host_device_mesh's default in a group of two: the bound card only
    for r, o in enumerate(outs):
        assert json.loads(line(o, "DEFAULT_MESH")[len("DEFAULT_MESH "):]) \
            == {"shape": [WORLD, 1], "local": [f"cuda:{r}"]}


def test_nccl_where_there_is_none_raises():
    """Asked for NCCL on this CPU build, initialize raises and joins no
    process group: nothing falls back to gloo on its own."""
    import pytest
    import torch.distributed as dist

    from drake_ddp_tpu_torch.parallel import multihost

    with pytest.raises(RuntimeError, match="backend='gloo'"):
        multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="nccl")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="backend must be one of"):
        multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="mpi")


def test_initialize_is_idempotent_per_backend():
    """A second initialize with the group's backend returns; with another
    one it raises instead of switching."""
    import pytest
    import torch
    import torch.distributed as dist

    from drake_ddp_tpu_torch.parallel import multihost

    addr = f"127.0.0.1:{_free_port()}"
    multihost.initialize(addr, 1, 0, backend="gloo")
    try:
        multihost.initialize(addr, 1, 0, backend="gloo")
        assert dist.get_backend() == "gloo"
        with pytest.raises(ValueError, match="runs gloo"):
            multihost.initialize(addr, 1, 0, backend="nccl")
        sums = multihost.all_reduce_sums(
            torch.tensor(1.5), torch.tensor(1), torch.tensor(7), 4)
        assert [float(v) for v in sums[:3]] == [1.5, 1.0, 7.0]
        assert sums[3] == 4 and sums[0].device.type == "cpu"
    finally:
        dist.destroy_process_group()


def _worker(rank, world, port):
    import torch

    from drake_ddp_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = multihost.host_device_mesh(["cpu"])
    assert mesh.shape == (world, 1) and mesh.rank == rank, mesh
    # the default mesh of a group of several: the card this process is
    # bound to (a card stood in for by current_device; no CUDA here)
    torch.cuda.current_device = lambda: rank
    default = multihost.host_device_mesh()
    print("DEFAULT_MESH " + json.dumps({
        "shape": list(default.shape),
        "local": [str(d) for d in default.local]}), flush=True)
    from drake_ddp_tpu_torch.solver.ilqr import ILQRProblem
    probs = multihost.process_local_problem(
        mesh, ILQRProblem(**_local_problems(rank)))
    res, stats = _mpc(probs, mesh)
    print(f"RESULT {float(stats.mean_cost)!r} {int(stats.num_diverged)} "
          f"{int(stats.total_iterations)}", flush=True)
    print("LANES " + json.dumps({
        "costs": res.costs[:, -1].tolist(),
        "iterations": res.iterations.tolist()}), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
