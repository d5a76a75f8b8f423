"""The port's model files against the JAX package's: URDF text
(``io/urdf.py``), SDF (``io/sdf.py`` on the port's copy of
``models/cart_pole.sdf``), OBJ sphere covers (``io/mesh.py`` and the
native ``meshproc`` build), on the same inputs; and the SDF cart-pole,
built with no contact model, stepping as the analytic cart-pole does."""

import dataclasses
import os

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")

from drake_ddp_tpu.io import mesh as jmesh  # noqa: E402
from drake_ddp_tpu.io import sdf as jsdf  # noqa: E402
from drake_ddp_tpu.io import urdf as jurdf  # noqa: E402
from drake_ddp_tpu_torch.io import mesh as tmesh  # noqa: E402
from drake_ddp_tpu_torch.io import sdf as tsdf  # noqa: E402
from drake_ddp_tpu_torch.io import urdf as turdf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_io.py's inline cases
PENDULUM_URDF = """
<robot name="pend">
  <link name="base"/>
  <link name="arm">
    <inertial>
      <mass value="2.0"/>
      <origin xyz="0 0 -0.5" rpy="0 0 0"/>
      <inertia ixx="0.1" iyy="0.1" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <geometry><sphere radius="0.05"/></geometry>
      <origin xyz="0 0 -1.0"/>
      <drake:proximity_properties>
        <drake:compliant_hydroelastic/>
        <drake:hydroelastic_modulus value="1e5"/>
        <drake:hunt_crossley_dissipation value="1.5"/>
      </drake:proximity_properties>
    </collision>
  </link>
  <joint name="shoulder" type="revolute">
    <parent link="base"/>
    <child link="arm"/>
    <origin xyz="0 0 1.0" rpy="0 0 0"/>
    <axis xyz="0 1 0"/>
    <dynamics damping="0.1"/>
  </joint>
  <transmission name="t1">
    <joint name="shoulder"/>
    <actuator name="a1">
      <drake:gear_ratio value="10.0"/>
      <drake:rotor_inertia value="0.001"/>
    </actuator>
  </transmission>
</robot>
"""

ROTATED_INERTIA_URDF = """
<robot name="r"><link name="a">
  <inertial>
    <mass value="1.0"/>
    <origin xyz="0 0 0" rpy="0 0 1.5707963267948966"/>
    <inertia ixx="1.0" iyy="2.0" izz="3.0" ixy="0" ixz="0" iyz="0"/>
  </inertial>
</link></robot>
"""

CAPSULE_URDF = """
<robot name="cap">
  <link name="base">
    <inertial><mass value="1.0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><geometry><capsule radius="0.02" length="0.2"/></geometry></collision>
    <collision><geometry><drake:capsule radius="0.03" length="0.1"/></geometry></collision>
  </link>
</robot>
"""

# a two-link arm with a box, a cylinder, a mesh link (the OBJ written by
# the test), a prismatic and a fixed joint, a rigid and a compliant
# collision and a collision filter group, in a declared drake namespace
ARM_URDF = """<?xml version="1.0"?>
<robot name="arm" xmlns:drake="http://drake.mit.edu">
  <link name="base">
    <inertial><mass value="3.0"/><origin xyz="0 0 0.05" rpy="0.1 0 0"/>
      <inertia ixx="0.02" iyy="0.03" izz="0.04" ixy="0.001" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 0.05"/><geometry><box size="0.2 0.2 0.1"/></geometry>
      <drake:proximity_properties><drake:rigid_hydroelastic/>
        <drake:mu_static value="0.7"/><drake:mu_dynamic value="0.4"/>
      </drake:proximity_properties></collision>
  </link>
  <link name="upper">
    <inertial><mass value="1.2"/><origin xyz="0.15 0 0"/>
      <inertia ixx="0.001" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0.15 0 0" rpy="0 1.5707963 0"/>
      <geometry><cylinder radius="0.03" length="0.3"/></geometry></collision>
  </link>
  <link name="fore">
    <inertial><mass value="0.8"/><origin xyz="0.1 0 0"/>
      <inertia ixx="0.001" iyy="0.005" izz="0.005" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0.02 0 0" rpy="0 0 0.3"/>
      <geometry><mesh filename="fore.obj" scale="1.5 1.5 1.5"/></geometry>
      <drake:proximity_properties><drake:compliant_hydroelastic/>
        <drake:hydroelastic_modulus value="2e6"/>
        <drake:mesh_resolution_hint value="0.02"/>
      </drake:proximity_properties></collision>
  </link>
  <link name="tool"/>
  <joint name="shoulder" type="revolute">
    <parent link="base"/><child link="upper"/>
    <origin xyz="0 0 0.1" rpy="0 0 0.2"/><axis xyz="0 1 1"/>
    <dynamics damping="0.05"/>
  </joint>
  <joint name="slide" type="prismatic">
    <parent link="upper"/><child link="fore"/>
    <origin xyz="0.3 0 0"/><axis xyz="1 0 0"/>
  </joint>
  <joint name="flange" type="fixed">
    <parent link="fore"/><child link="tool"/><origin xyz="0.2 0 0"/>
  </joint>
  <transmission name="t1"><joint name="shoulder"/><actuator name="a1"/></transmission>
  <transmission name="t2"><joint name="slide"/>
    <actuator name="a2"><drake:gear_ratio value="4.0"/>
      <drake:rotor_inertia value="0.002"/></actuator></transmission>
  <drake:collision_filter_group name="g1">
    <drake:member link="base"/><drake:member link="upper"/>
    <drake:ignored_collision_filter_group name="g2"/>
  </drake:collision_filter_group>
  <drake:collision_filter_group name="g2">
    <drake:member link="fore"/>
  </drake:collision_filter_group>
</robot>
"""


def write_obj(path, seed=0, n=300):
    """An elongated vertex cloud as an OBJ file (with a face line)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)) * np.array([0.12, 0.02, 0.025])
    v[:, 0] += 0.05
    with open(path, "w") as f:
        f.write("# test mesh\n")
        f.writelines(f"v {a:.17g} {b:.17g} {c:.17g}\n" for a, b, c in v)
        f.write("f 1 2 3\n")
    return v


def _plain(v):
    """A record's value as plain Python/numpy for comparison."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def assert_same(a, b, path="robot"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("case", ["pendulum", "rotated_inertia", "capsule",
                                  "arm_with_mesh"])
def test_parse_urdf_text_matches_jax(case, tmp_path):
    text = {"pendulum": PENDULUM_URDF, "rotated_inertia": ROTATED_INERTIA_URDF,
            "capsule": CAPSULE_URDF, "arm_with_mesh": ARM_URDF}[case]
    want = jurdf.parse_urdf(text, base_dir=str(tmp_path))
    got = turdf.parse_urdf(text, base_dir=str(tmp_path))
    assert_same(_plain(got), _plain(want))
    if case == "pendulum":
        j = got.joints[0]
        assert j.actuated and j.damping == 0.1
        assert j.armature == pytest.approx(100 * 0.001)
        (c,) = got.links["arm"].collisions
        assert c.kind == "sphere" and c.props.modulus == 1e5
    if case == "arm_with_mesh":
        assert [j.actuated for j in got.joints] == [True, True, False]
        assert ("base", "fore") in got.filtered_link_pairs


def test_parse_urdf_file_path(tmp_path):
    path = tmp_path / "arm.urdf"
    path.write_text(ARM_URDF)
    got = turdf.parse_urdf(str(path))
    assert got.dir == str(tmp_path) and got.root == "base"
    assert_same(_plain(got), _plain(jurdf.parse_urdf(str(path))))


@pytest.mark.parametrize("refine", [1.0, 2.0])
def test_add_urdf_mesh_collision_matches_jax(refine, tmp_path):
    """URDF text with a mesh collision: the sphere cover (native at refine
    1, Python at 2) placed on the mesh's body as the JAX package places
    it; bodies and collision filters equal."""
    from drake_ddp_tpu.contact.geometry import GeometrySet as JGS
    from drake_ddp_tpu.multibody.model import ModelBuilder as JMB
    from drake_ddp_tpu_torch.contact.geometry import GeometrySet as TGS
    from drake_ddp_tpu_torch.multibody.model import ModelBuilder as TMB

    write_obj(tmp_path / "fore.obj")
    path = tmp_path / "arm.urdf"
    path.write_text(ARM_URDF)
    out = {}
    for name, mb, gs, add in (("jax", JMB(), JGS(), jurdf.add_urdf),
                              ("port", TMB(), TGS(), turdf.add_urdf)):
        idx = add(mb, gs, str(path), floating=False, mesh_max_spheres=3,
                  mesh_refine=refine)
        out[name] = (idx, gs)
    (ij, gj), (it, gt) = out["jax"], out["port"]
    assert ij == it
    assert len(gt.geoms) == len(gj.geoms) > 3
    # the native cover's axis comes from power iteration, so its spheres
    # may come in the other order: compare the mesh's spheres as sets
    key = lambda g: (g.body, g.kind, tuple(np.round(g.pos, 9)),
                     tuple(np.round(g.size, 9)), g.name)
    assert sorted(map(key, gt.geoms)) == sorted(map(key, gj.geoms))
    for g in gt.geoms:
        h = next(h for h in gj.geoms if key(h) == key(g))
        assert _plain(g.props) == _plain(h.props)
        np.testing.assert_allclose(g.rot, h.rot, atol=1e-12)
    assert sorted(gt._filtered_bodies) == sorted(gj._filtered_bodies)


def test_obj_cover_matches_jax_python(tmp_path):
    """io/mesh.py on the same OBJ: vertices and the Python cover equal to
    the JAX package's, every vertex covered."""
    path = str(tmp_path / "m.obj")
    write_obj(path, seed=3)
    vt, vj = tmesh.load_obj_vertices(path), jmesh.load_obj_vertices(path)
    np.testing.assert_array_equal(vt, vj)
    for max_spheres, refine in ((4, 1.0), (6, 2.0), (1, 1.0)):
        got = tmesh.approximate_spheres(vt, max_spheres, refine=refine)
        want = jmesh.approximate_spheres(vj, max_spheres, refine=refine)
        assert len(got) == len(want)
        for (cg, rg), (cw, rw) in zip(got, want):
            np.testing.assert_array_equal(cg, cw)
            assert rg == rw
        d = np.stack([np.linalg.norm(vt - c, axis=1) - r for c, r in got])
        assert (d.min(axis=0) < 1e-9).all()
    cover = tmesh.cover_mesh(path, 1.0, 4, refine=2.0)
    assert cover.route == "python"


def test_obj_cover_native_matches_jax(tmp_path):
    """The native cover, built from the port's copy of meshproc.cpp into
    build/drake_ddp_tpu_torch/: equal to the JAX package's native cover,
    and to the Python cover as a set of spheres (JAX tests/test_native.py
    :21); ``cover_mesh`` says which ran."""
    from drake_ddp_tpu import native as jnative
    from drake_ddp_tpu_torch import native as tnative

    if tnative.load_meshproc() is None:
        pytest.skip("no g++ to build the native cover")
    assert tnative.library_path().parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "drake_ddp_tpu_torch")
    path = str(tmp_path / "m.obj")
    verts = write_obj(path, seed=5)
    got = tnative.sphere_cover(path, 1.5, 4)
    want = jnative.sphere_cover(path, 1.5, 4)
    if want is not None:
        assert len(got) == len(want)
        for (cg, rg), (cw, rw) in zip(got, want):
            np.testing.assert_array_equal(cg, cw)
            assert rg == rw
    python = tmesh.approximate_spheres(verts * 1.5, 4)
    key = lambda s: sorted((tuple(np.round(c, 6)), round(r, 6)) for c, r in s)
    assert len(got) == len(python)
    for (cp, rp), (cn, rn) in zip(key(python), key(got)):
        assert rp == pytest.approx(rn, rel=1e-3)
        assert np.allclose(cp, cn, atol=1e-3)
    cover = tmesh.cover_mesh(path, 1.5, 4)
    assert cover.route == "native" and len(cover.spheres) == len(got)
    assert tnative.sphere_cover(str(tmp_path / "missing.obj")) is None


def _sdf_cart_pole(dt=1e-2):
    from drake_ddp_tpu_torch.contact.geometry import GeometrySet
    from drake_ddp_tpu_torch.models import CART_POLE_SDF
    from drake_ddp_tpu_torch.multibody.model import ModelBuilder
    from drake_ddp_tpu_torch.multibody.plant import make_multibody_system

    mb = ModelBuilder()
    tsdf.add_sdf(mb, GeometrySet(), CART_POLE_SDF)
    model = mb.finalize(device="cpu")
    return model, make_multibody_system(model, None, dt)


def test_parse_sdf_matches_jax():
    """The port's copy of cart_pole.sdf parses to the JAX package's record
    of its own file (tests/test_sdf.py's structure checks)."""
    from drake_ddp_tpu_torch.models import CART_POLE_SDF

    got = tsdf.parse_sdf(CART_POLE_SDF)
    want = jsdf.parse_sdf(os.path.join(REPO, "drake_ddp_tpu", "models",
                                       "cart_pole.sdf"))
    got.dir = want.dir
    assert_same(_plain(got), _plain(want))
    assert got.root is None
    assert [j.type for j in got.joints] == ["prismatic", "revolute"]
    slider, pin = got.joints
    assert slider.parent == "world" and slider.child == "Cart"
    assert slider.actuated and not pin.actuated      # Drake's effort rule
    np.testing.assert_allclose(pin.axis, [0, -1, 0])
    np.testing.assert_allclose(got.links["Pole"].com, [0, 0, -0.5])
    assert got.links["Pole"].collisions[0].kind == "sphere"


def test_sdf_frames_match_jax():
    """Model-frame link poses, a child-frame joint pose and
    use_parent_model_frame re-expressed as in the JAX package."""
    text = """<sdf version="1.6"><model name="m">
      <link name="a"><pose>0 0 1 0 0 0.3</pose>
        <inertial><mass>2</mass><pose>0.1 0 0 0 0 0</pose>
          <inertia><ixx>0.1</ixx><iyy>0.2</iyy><izz>0.3</izz></inertia>
        </inertial>
        <collision name="c"><pose>0 0.1 0 0.2 0 0</pose>
          <geometry><box><size>0.1 0.2 0.3</size></box></geometry></collision>
      </link>
      <link name="b"><pose>0.5 0 1 0 0.4 0</pose>
        <inertial><mass>1</mass></inertial>
        <collision name="s"><geometry><sphere><radius>0.05</radius></sphere>
        </geometry></collision>
      </link>
      <joint name="j0" type="revolute"><parent>world</parent><child>a</child>
        <axis><xyz>0 0 1</xyz></axis></joint>
      <joint name="j1" type="revolute"><parent>a</parent><child>b</child>
        <pose>0 0 0.1 0 0 0</pose>
        <axis><xyz>1 0 0</xyz><use_parent_model_frame>1</use_parent_model_frame>
          <dynamics><damping>0.3</damping></dynamics>
          <limit><effort>0</effort></limit></axis></joint>
    </model></sdf>"""
    assert_same(_plain(tsdf.parse_sdf(text)), _plain(jsdf.parse_sdf(text)))


def test_sdf_model_layout():
    from drake_ddp_tpu_torch.multibody.model import PRISMATIC, REVOLUTE

    model, system = _sdf_cart_pole()
    assert (model.nq, model.nv, model.nu) == (2, 2, 1)
    assert tuple(model.joint_type) == (PRISMATIC, REVOLUTE)
    assert system.params[1] is None and (system.n, system.m) == (4, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sdf_cart_pole_matches_analytic(seed):
    """The multibody plant built from the SDF with no contact model steps
    as the analytic cart-pole, 20 steps, at tests/test_sdf.py's 1e-4 /
    1e-5 (float32, the lane step on the CPU)."""
    from drake_ddp_tpu_torch.dynamics.analytic import cart_pole_system

    _, sys_sdf = _sdf_cart_pole()
    sys_ref = cart_pole_system(dt=1e-2)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(scale=0.7, size=(4, 1)), dtype=torch.float32)
    u = torch.as_tensor(rng.normal(scale=2.0, size=(1, 1)), dtype=torch.float32)
    for _ in range(20):
        x_sdf = sys_sdf.lane_step_fn(x, u)
        x_ref = sys_ref.lane_step_fn(x, u)
        np.testing.assert_allclose(x_sdf.numpy(), x_ref.numpy(), rtol=1e-4,
                                   atol=1e-5)
        x = x_ref
    # its cold lane Jacobian (the plain version of the cold megajac) on
    # float64 states equals the analytic system's to the rounding of the
    # model's float32 constants
    x64 = torch.as_tensor(rng.normal(scale=0.7, size=(4, 5)))
    u64 = torch.as_tensor(rng.normal(scale=2.0, size=(1, 5)))
    for a, b in zip(sys_sdf.lane_jac_fn(x64, u64),
                    sys_ref.lane_jac_fn(x64, u64)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)
