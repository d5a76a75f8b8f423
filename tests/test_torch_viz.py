"""The port's viz/ (playback frames, HTML player, MPC stream) against
``drake_ddp_tpu.viz``, on the same states and the same model constants.

Tolerances: sphere centers and contact points within 1e-5 (float32
kinematics on both sides), contact forces within 1e-3 relative on the
active contacts (the explicit force law is stiff in the penetration);
the players' DATA JSON holds the same fields, each number within its
rounding unit on top of those tolerances."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

# the JAX reference; the card machine has no JAX and skips this file
jax = pytest.importorskip("jax")

from test_torch_model import jax_tables  # noqa: E402


@functools.lru_cache(maxsize=None)
def _cheetah():
    """The JAX and port cheetah (model, contact) on the same constants,
    and 6 seeded (T, n) states: the standing pose lowered 0 to 2.5 cm
    (the feet pressed into the ground), joint and velocity noise."""
    from drake_ddp_tpu.examples import mini_cheetah as jmc
    from drake_ddp_tpu_torch.multibody.model import from_numpy

    jsys, _ = jmc.build_system(jmc.Config())
    port = from_numpy(*jax_tables(jsys), device="cpu")
    rng = np.random.default_rng(7)
    T = 6
    x = np.zeros((T, 37), np.float32)
    x[:, :19] = jmc.Q0
    x[:, 6] -= np.linspace(0.0, 0.025, T)
    x[:, 7:19] += 0.05 * rng.standard_normal((T, 12))
    x[:, 19:] = 0.3 * rng.standard_normal((T, 18))
    return jsys.params, port, x


@functools.lru_cache(maxsize=None)
def _kinova():
    """The JAX and port Kinova (model, contact) on the same constants,
    and the port's 20-step passive roll (n, 20) of the side scenario."""
    from drake_ddp_tpu.examples import kinova_gen3 as jkg
    from drake_ddp_tpu_torch.examples import kinova_gen3 as tkg
    from drake_ddp_tpu_torch.multibody.model import from_numpy

    jsys, _ = jkg.build_system(jkg.Config())
    port = from_numpy(*jax_tables(jsys), device="cpu")
    states = tkg.simulate(tkg.Config(), sim_time=0.2, device="cpu")
    assert states.shape == (27, 20)
    return jsys.params, port, states


SCENES = {"cheetah": _cheetah, "kinova": _kinova}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scene_frames_match_jax(scene):
    from drake_ddp_tpu.viz import scene_frames as jframes
    from drake_ddp_tpu_torch.viz import scene_frames

    (jm, jc), (tm, tc), states = SCENES[scene]()
    ref = jframes(jm, jc, states)
    got = scene_frames(tm, tc, states, device="cpu")
    assert got["centers"].shape == ref["centers"].shape
    np.testing.assert_allclose(got["centers"], ref["centers"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["radii"], np.asarray(ref["radii"]))
    assert got["names"] == ref["names"]
    # the reference's (n, T) layout gives the same frames
    again = scene_frames(tm, tc, np.asarray(states).T, device="cpu")
    np.testing.assert_array_equal(again["centers"], got["centers"])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_contact_force_frames_match_jax(scene):
    from drake_ddp_tpu.viz import contact_force_frames as jforces
    from drake_ddp_tpu_torch.viz import contact_force_frames

    (jm, jc), (tm, tc), states = SCENES[scene]()
    ref = jforces(jm, jc, states, dt=1e-2)
    got = contact_force_frames(tm, tc, states, dt=1e-2, device="cpu")
    assert got["points"].shape == ref["points"].shape
    np.testing.assert_allclose(got["points"], ref["points"], rtol=0,
                               atol=1e-5)
    mag = np.linalg.norm(ref["forces"], axis=2)
    active = mag > 1e-3 * mag.max()
    assert mag.max() > 1.0 and active.sum() >= 2, mag.max()
    np.testing.assert_allclose(got["forces"][active],
                               ref["forces"][active], rtol=1e-3,
                               atol=1e-3 * mag.max())


def _data(path):
    """The JSON between ``const DATA =`` and its ``;`` in a player."""
    html = Path(path).read_text()
    start = html.index("const DATA = ") + len("const DATA = ")
    return json.loads(html[start:html.index(";\n", start)])


def _assert_same_data(got, ref, units):
    """Same fields; every number within its field's rounding unit plus
    the frames' tolerance (``units``: field -> (atol, rtol))."""
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        a, b = np.asarray(got[k], float), np.asarray(v, float)
        assert a.shape == b.shape, k
        atol, rtol = units.get(k, (0.0, 0.0))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)


def test_export_html_data_matches_jax(tmp_path):
    from drake_ddp_tpu.viz import export_html as jexport
    from drake_ddp_tpu_torch.viz import export_html

    (jm, jc), (tm, tc), states = _cheetah()
    kw = dict(dt=4e-3, playback_rate=0.2, show_forces=True)
    ref = jexport(str(tmp_path / "jax.html"), jm, jc, states, **kw)
    got = export_html(str(tmp_path / "port.html"), tm, tc, states,
                      device="cpu", **kw)
    html = Path(got).read_text()
    assert "<canvas" in html and "toggle contact forces" in html
    fmax = np.abs(np.asarray(_data(ref)["forces"])).max()
    _assert_same_data(_data(got), _data(ref), {
        "centers": (2e-5, 0.0), "fpoints": (2e-5, 0.0),
        "forces": (2e-3 + 1e-3 * fmax, 1e-3), "radii": (0.0, 1e-7)})


def _resolves(n, N, count, seed):
    """``count`` seeded (n, N) cheetah trajectories near the standing
    pose."""
    from drake_ddp_tpu_torch.examples.mini_cheetah import Q0

    rng = np.random.default_rng(seed)
    x0 = np.zeros((n, 1), np.float32)
    x0[:19, 0] = Q0
    return [x0 + 0.02 * rng.standard_normal((n, N)).astype(np.float32)
            for _ in range(count)]


def test_mpc_stream_matches_jax(tmp_path):
    """The stitched trajectory and the ghost-overlay player's data, from
    numpy resolves (JAX) and from tensors (the port)."""
    from drake_ddp_tpu.viz import MPCStream as JStream
    from drake_ddp_tpu_torch.viz import MPCStream

    (jm, jc), (tm, tc), _ = _cheetah()
    n, N, rs = 37, 9, 2
    ref, got = JStream(replan_steps=rs), MPCStream(replan_steps=rs,
                                                   device="cpu")
    for x in _resolves(n, N, 3, 1):
        ref.record(x)
        got.record(torch.as_tensor(x))
    np.testing.assert_array_equal(got.executed(n), ref.executed(n))
    assert got.executed(n).shape == (2 * rs + N, n)
    pj = ref.export_html(str(tmp_path / "jax.html"), jm, jc, dt=4e-3)
    pt = got.export_html(str(tmp_path / "port.html"), tm, tc, dt=4e-3)
    html = Path(pt).read_text()
    assert "ghosts" in html and "resolve" in html
    _assert_same_data(_data(pt), _data(pj), {
        "centers": (2e-5, 0.0), "ghosts": (2e-5, 0.0),
        "radii": (0.0, 1e-7)})


def test_mpc_stream_live_rewrite(tmp_path):
    """Live mode: every record() rewrites an auto-reloading player in
    place (through a rename), with one more ghost each time."""
    from drake_ddp_tpu_torch.viz import MPCStream

    (_, _), (tm, tc), _ = _cheetah()
    path = tmp_path / "live.html"
    stream = MPCStream(replan_steps=2, live_path=str(path), model=tm,
                       contact=tc, dt=4e-3, device="cpu")
    xs = _resolves(37, 6, 2, 2)
    stream.record(xs[0])
    html = Path(path).read_text()
    assert 'http-equiv="refresh"' in html
    assert len(_data(path)["ghosts"]) == 1
    stream.record(torch.as_tensor(xs[1]))
    assert len(_data(path)["ghosts"]) == 2
    assert not (tmp_path / "live.html.tmp").exists()
    with pytest.raises(ValueError, match="live_path needs model and dt"):
        MPCStream(replan_steps=2, live_path=str(path))


def test_animate_matplotlib_writes_a_file(tmp_path):
    from drake_ddp_tpu_torch.viz import animate_matplotlib

    (_, _), (tm, tc), states = _cheetah()
    out = tmp_path / "cheetah.gif"
    animate_matplotlib(tm, tc, states[:3], dt=0.1, save_path=str(out),
                       device="cpu")
    assert out.exists() and out.stat().st_size > 1000


def test_kinova_playback_and_simulate_write_players(tmp_path):
    """The examples' hooks: a saved solution replays into the player at
    the reference's rate, and the Panda's passive roll writes one."""
    from drake_ddp_tpu_torch.examples import kinova_gen3, panda_fr3
    from drake_ddp_tpu_torch.io.solution import save_solution

    _, _, states = _kinova()
    N = states.shape[1]
    save = str(tmp_path / "sol.npz")
    save_solution(save, 1e-2, states, np.zeros((7, N - 1)),
                  np.zeros((7, 27, N - 1)))
    t, x_bar = kinova_gen3.playback(save, html_out=str(tmp_path / "k.html"),
                                    device="cpu")
    np.testing.assert_array_equal(x_bar, states[:, :-1])
    data = _data(tmp_path / "k.html")
    assert data["rate"] == 0.125 and len(data["centers"]) == N - 1
    rolled = panda_fr3.simulate(panda_fr3.Config(contact_iters=2),
                                sim_time=0.03, device="cpu",
                                html_out=str(tmp_path / "p.html"))
    assert len(_data(tmp_path / "p.html")["centers"]) == rolled.shape[1] == 3
