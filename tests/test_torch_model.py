"""The PyTorch port's model and contact tables against the JAX package's,
and the port's import hygiene.

The port builds the mini cheetah itself (URDF records ->
ModelBuilder / GeometrySet -> tables); ``from_numpy`` carries the JAX
build's tables across.  Both must agree exactly: integers equal, float32
constants equal to the last bit.  Helpers here are shared by the other
``test_torch_*`` files, which import this module by its own name (pytest
puts the test directory on sys.path; a ``tests`` package installed
elsewhere may shadow this directory's)."""

import ast
import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

# XLA options for the JAX reference programs these files compile: the
# cheetah's unrolled contact programs spend most of their CPU compile in
# LLVM's optimizer, and level 0 halves that at a small run time cost.
JAX_QUICK_COMPILE = {"xla_backend_optimization_level": 0}
JAC_CHUNK = 4


@functools.lru_cache(maxsize=None)
def jax_cheetah_lane_jac():
    """The JAX package's root-seeded lane Jacobian of the cheetah as a host
    function of numpy (x, u, x_next), each (n, L), -> (fx, fu), jitted
    once per process and run on JAC_CHUNK-lane chunks.  The lane Jacobian
    test and the JAX MPC reference both call it, so a process that runs
    both compiles it once (about 40 s on one core).  The root-seeded
    Jacobian does not depend on contact_iters."""
    import jax
    from drake_ddp_tpu.examples import mini_cheetah as jmc
    from drake_ddp_tpu.multibody.lanejac import make_lane_jac

    jsys, _ = jmc.build_system(jmc.Config(contact_iters=8))
    model, contact = jsys.params
    jac = jax.jit(make_lane_jac(model, contact, jsys.dt, contact_iters=8,
                                force_params=jsys.lane_step_fn.force_params,
                                root_seed=True, refine_iters=0),
                  compiler_options=JAX_QUICK_COMPILE)

    def host_jac(x, u, x_next):
        L = x.shape[-1]
        pad = -L % JAC_CHUNK
        ext = lambda a: np.concatenate(
            [np.asarray(a), np.repeat(np.asarray(a)[:, -1:], pad, 1)], 1)
        x, u, x_next = ext(x), ext(u), ext(x_next)
        parts = [jac(x[:, k:k + JAC_CHUNK], u[:, k:k + JAC_CHUNK],
                     x_next[:, k:k + JAC_CHUNK])
                 for k in range(0, L + pad, JAC_CHUNK)]
        return tuple(np.concatenate([np.asarray(p[i]) for p in parts],
                                    axis=-1)[..., :L] for i in (0, 1))

    return host_jac


def jax_tables(system):
    """The JAX system's (MultibodyModel, ContactModel) fields as dicts of
    numpy arrays, ints and tuples."""
    model, contact = system.params
    conv = lambda v: v if isinstance(v, (int, tuple)) or v is None \
        else np.asarray(v)
    md = {f.name: conv(getattr(model, f.name))
          for f in dataclasses.fields(model)}
    cd = None if contact is None else {k: conv(v) for k, v in
                                       contact._asdict().items()}
    return md, cd


def port_system_from_jax(jsystem, contact_iters, force_params=None):
    """The port's DiscreteSystem on the JAX system's exact constants."""
    from drake_ddp_tpu_torch.contact.forces import ContactForceParams
    from drake_ddp_tpu_torch.multibody.model import from_numpy
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system
    model, contact = from_numpy(*jax_tables(jsystem), device="cpu")
    fp = jsystem.lane_step_fn.force_params
    return make_multibody_system(
        model, contact, jsystem.dt, contact_iters=contact_iters,
        force_params=ContactForceParams(*fp) if force_params is None
        else force_params)


def assert_same_tables(a_model, a_contact, b_model, b_contact):
    for f in dataclasses.fields(a_model):
        va, vb = getattr(a_model, f.name), getattr(b_model, f.name)
        if isinstance(va, torch.Tensor):
            assert va.dtype == vb.dtype == torch.float32, f.name
            assert torch.equal(va, vb), f.name
        else:
            assert va == vb, f.name
    assert (a_contact is None) == (b_contact is None)
    if a_contact is None:
        return
    for k in a_contact._fields:
        va, vb = getattr(a_contact, k), getattr(b_contact, k)
        if isinstance(va, torch.Tensor):
            assert va.shape == vb.shape and torch.equal(va, vb), k
        else:
            assert va == vb, k


def small_families(model_mod, geom_mod, **finalize):
    """A free torso carrying a box, a revolute leg with a fixed foot
    sphere, and a prismatic slider sphere that passes through the box,
    over a ground halfspace: sh, sb and bh contact pairs."""
    mb = model_mod.ModelBuilder()
    I = lambda a, b, c: np.diag([a, b, c])
    torso = mb.add_body("torso", -1, model_mod.FREE, mass=2.0,
                        inertia=I(0.01, 0.02, 0.025))
    hip = mb.add_body("hip", torso, model_mod.REVOLUTE,
                      X_PJ_pos=(0.1, 0.0, -0.04), axis=(0.0, 1.0, 0.0),
                      mass=0.3, com=(0.0, 0.0, -0.07),
                      inertia=I(1e-3, 1e-3, 2e-4), damping=0.1,
                      armature=0.01, actuated=True)
    foot = mb.add_body("foot", hip, model_mod.FIXED,
                       X_PJ_pos=(0.0, 0.0, -0.15), mass=0.05,
                       inertia=I(1e-5, 1e-5, 1e-5))
    slider = mb.add_body("slider", torso, model_mod.PRISMATIC,
                         X_PJ_pos=(-0.1, 0.0, -0.04), axis=(0.0, 0.0, 1.0),
                         mass=0.2, inertia=I(2e-4, 2e-4, 1e-4),
                         damping=0.05, actuated=True)
    gs = geom_mod.GeometrySet()
    G = geom_mod.CollisionGeometry
    soft = geom_mod.ContactProps(modulus=2e6, dissipation=0.5,
                                 mu_static=0.8, mu_dynamic=0.6)
    gs.add(G(torso, geom_mod.BOX, np.zeros(3), np.eye(3),
             np.array([0.15, 0.08, 0.04]), soft))
    gs.add(G(foot, geom_mod.SPHERE, np.zeros(3), np.eye(3),
             np.array([0.02]), soft))
    gs.add(G(slider, geom_mod.SPHERE, np.array([0.0, 0.0, -0.1]),
             np.eye(3), np.array([0.03]), soft))
    gs.add(G(-1, geom_mod.HALFSPACE, np.zeros(3), np.eye(3), np.zeros(1),
             geom_mod.ContactProps(modulus=5e6)))
    gs.exclude_body_pair(foot, slider)      # this slice's families only
    return (mb.finalize(**finalize),
            geom_mod.build_contact_model(gs, **finalize))


def test_cheetah_tables_match_jax_build():
    from drake_ddp_tpu.examples import mini_cheetah as jmc
    from drake_ddp_tpu_torch.examples import mini_cheetah as tmc
    from drake_ddp_tpu_torch.multibody.model import from_numpy

    jsys, _ = jmc.build_system(jmc.Config(contact_iters=8))
    tsys, _ = tmc.build_system(tmc.Config(contact_iters=8), device="cpu")
    carried = from_numpy(*jax_tables(jsys), device="cpu")
    assert_same_tables(*carried, *tsys.params)
    model, contact = tsys.params
    assert (model.nq, model.nv, model.nu, model.nb) == (19, 18, 12, 17)
    assert contact.num_contacts == 16
    assert (len(contact.pair_sh_s), len(contact.pair_sb_s),
            len(contact.pair_bh_b)) == (4, 4, 1)


def test_cheetah_task_constants_match_jax():
    from drake_ddp_tpu.examples import mini_cheetah as jmc
    from drake_ddp_tpu_torch.examples import mini_cheetah as tmc

    for a, b in zip(jmc.costs(jmc.Config()), tmc.costs(tmc.Config())):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jmc.initial_and_target(jmc.Config()),
                    tmc.initial_and_target(tmc.Config())):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jmc.U_STAND, tmc.U_STAND)
    np.testing.assert_array_equal(jmc.Q0, tmc.Q0)


def test_stiction_schedule_matches_jax():
    from drake_ddp_tpu.contact.forces import stiction_schedule as jsched
    from drake_ddp_tpu_torch.contact.forces import stiction_schedule as tsched

    for vs, iters in ((1e-3, 8), (1e-3, 2), (2e-2, 4), (0.1, 3)):
        assert tsched(vs, iters) == jsched(vs, iters)


def test_entry_points_default_to_the_card():
    """The default device is CUDA; without a card that raises instead of
    running on the CPU."""
    from drake_ddp_tpu_torch.examples import mini_cheetah as tmc

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmc.build_system(tmc.Config())


def test_mesh_collision_names_the_later_slice():
    from drake_ddp_tpu_torch.contact.geometry import ContactProps, GeometrySet
    from drake_ddp_tpu_torch.io.urdf import UrdfCollision, _add_collision

    mesh = UrdfCollision("mesh", np.zeros(3), np.eye(3), np.ones(3),
                         "link.obj", ContactProps())
    with pytest.raises(NotImplementedError, match="manipulation slice"):
        _add_collision(GeometrySet(), 0, mesh)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["package", "chip_smoke"])
def test_port_imports_no_jax(where):
    files = (sorted((REPO / "drake_ddp_tpu_torch").rglob("*.py"))
             if where == "package" else [REPO / "chip_smoke.py"])
    assert files
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "drake_ddp_tpu"), (
                f"{path.relative_to(REPO)} imports {mod}")
