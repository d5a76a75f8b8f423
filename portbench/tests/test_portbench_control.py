"""On the card, at each cell's own size: the check passes what the program
produced and fails the control (the reference in the program's place one
precision below float32: the step and the cost in bfloat16, the Riccati
sweep's products in TF32), on three seeds.

    python -m pytest -m cuda portbench/tests/test_portbench_control.py
"""

import importlib

import pytest
import torch

CELLS = {"cheetah_mpc_b256": 2, "panda_side_k128": 1}   # resolves, batches
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's precision is the "
                    "card's (TF32 exists only there)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_control_fails_and_the_program_passes(workload, card):
    from portbench import check
    from portbench.program import Program
    from portbench.run import load_cell
    _, _, cfg, traffic, limits = load_cell(workload)
    program = Program()
    program.build_kernels(cfg["kernels"])
    mod = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    ref = check.Reference(cfg, card)
    for seed in SEEDS:
        drv = mod.Driver(program, cfg, traffic, seed, card)
        for _ in range(CELLS[workload]):
            drv.step()
        ok = check.judge(drv.readings(ref), limits["numbers"])
        ctl = check.judge(drv.readings(ref, control=True), limits["numbers"])
        assert check.passed(ok), (seed, ok)
        assert not check.passed(ctl), (seed, ctl)
