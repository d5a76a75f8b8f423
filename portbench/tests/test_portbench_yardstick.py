"""The frozen operation counts, computed from the sizes in the
configuration files, equal ``chip_smoke.py``'s counts, which read the
port's own tables, at the flagship's and the Panda's shapes; and the
sizes in the files are the port's."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import yardstick as ys

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("mini_cheetah_flagship", "panda_fr3_side")


def port_kernel_data(cfg):
    import importlib

    from drake_ddp_tpu_torch.ops._table import kernel_data_for_system
    ex = importlib.import_module(
        f"drake_ddp_tpu_torch.examples.{cfg['program']['example']}")
    system, _ = ex.build_system(ex.Config(**cfg["program"]["config"]),
                                device="cpu")
    return kernel_data_for_system(system)


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_equal_chip_smoke(name):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{name}.json").read_text())
    kd = port_kernel_data(cfg)
    sizes = cfg["sizes"]
    assert ys.step_parts(sizes) == chip_smoke.op_counts(kd)
    assert ys.step_ops(sizes) == chip_smoke.step_ops(kd)
    for root in (True, False):
        assert ys.jac_ops(sizes, root) == chip_smoke.jac_ops(kd, root)


@pytest.mark.parametrize("name", CONFIGS)
def test_sizes_are_the_ports(name):
    from drake_ddp_tpu_torch.multibody.model import ancestor_dof_mask
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{name}.json").read_text())
    kd = port_kernel_data(cfg)
    T, model = kd._struct, kd.model
    sz = cfg["sizes"]
    anc = ancestor_dof_mask(model) > 0
    assert (sz["nb"], sz["nq"], sz["nv"], sz["nu"]) == (
        model.nb, model.nq, model.nv, model.nu)
    assert sz["ancestors"] == [int(a) for a in anc.sum(axis=1)]
    assert (sz["ns"], sz["nbox"], sz["contact_iters"]) == (
        T.ns, T.nbox, T.contact_iters)
    assert len(sz["contacts"]) == T.nc == cfg["contacts"]
    none = np.zeros(model.nv, bool)
    for ci, (kind, ca, cb, shared) in enumerate(sz["contacts"]):
        a, b = T.c_body_a[ci], T.c_body_b[ci]
        ma, mb = (anc[a] if a >= 0 else none), (anc[b] if b >= 0 else none)
        assert (kind, ca, cb, shared) == (
            T.c_kind[ci], ma.sum(), mb.sum(), (ma & mb).sum())


def test_riccati_and_keypoint_counts():
    assert ys.keypoint_count(50, 8) == 7
    assert ys.keypoint_count(50, 1) == 49
    assert ys.riccati_step_ops(37, 12) > 2 * 2 * 37 ** 3


def test_chain_health():
    flat = ys.chain_health([0.01] * 40, [0.01] * 40)
    assert flat["healthy"]
    rising = ys.chain_health([0.0] * 20 + [0.1 * i for i in range(20)],
                             [0.0] * 40)
    assert not rising["healthy"]
