"""Trajectory playback: states -> sphere scenes -> HTML / matplotlib.

Port of ``drake_ddp_tpu/viz/playback.py``.  The scene is the contact
model's collision spheres, animated from a saved state trajectory,
host-side and off the solve's path.  The frames are computed as lanes of
the port's lane-major kinematics and contact functions
(:mod:`~drake_ddp_tpu_torch.multibody.lanestep`): all T frames in one
batched evaluation, on ``device`` (the card by default), returned as
numpy.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from drake_ddp_tpu_torch._device import resolve_device
from drake_ddp_tpu_torch.contact.forces import ContactForceParams
from drake_ddp_tpu_torch.contact.geometry import ContactModel
from drake_ddp_tpu_torch.multibody.lanestep import (
    LaneConsts,
    _contact_forces_T,
    _contact_primal_T,
    _fk_T,
    sphere_centers_T,
)
from drake_ddp_tpu_torch.multibody.model import MultibodyModel


def _time_major(model: MultibodyModel, states) -> np.ndarray:
    """(n, T) in the reference's layout, or (T, n) -> (T, n)."""
    states = np.asarray(states)
    return states.T if states.shape[0] == model.nq + model.nv else states


def _on(model: MultibodyModel, contact: Optional[ContactModel], dev):
    """The model and contact tables on ``dev``."""
    mv = lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a
    model = dataclasses.replace(model, **{
        f.name: mv(getattr(model, f.name))
        for f in dataclasses.fields(model)})
    return model, (None if contact is None
                   else type(contact)(*map(mv, contact)))


def _lanes(a: torch.Tensor) -> np.ndarray:
    """(..., T) lane-major -> (T, ...) numpy."""
    return a.permute(a.dim() - 1, *range(a.dim() - 1)).cpu().numpy()


def scene_frames(model: MultibodyModel, contact: Optional[ContactModel],
                 states, device="cuda") -> dict:
    """Per-frame sphere centers of a state trajectory.

    Args:
        model: multibody model.
        contact: contact model (its spheres are the render geometry); if
            None, body origins are rendered as small markers.
        states: (n, T) trajectory in the reference's layout, or (T, n).
        device: where the frames are computed.
    Returns:
        dict with 'centers' (T, S, 3), 'radii' (S,), 'names' (S,).
    """
    dev = resolve_device(device)
    states = _time_major(model, states)
    model, contact = _on(model, contact, dev)
    C = LaneConsts(model, None, torch.float32)
    q = torch.as_tensor(states[:, :model.nq].T, dtype=torch.float32,
                        device=dev)
    R, p = _fk_T(model, C, q)[:2]                        # frames as lanes
    if contact is not None and len(contact.sph_body):
        centers = sphere_centers_T(
            R, p, torch.as_tensor(contact.sph_body, device=dev),
            contact.sph_offset.float())
        radii = contact.sph_radius.cpu().numpy()
        names = [model.body_names[b] for b in contact.sph_body]
    else:
        centers = p
        radii = np.full(model.nb, 0.02)
        names = list(model.body_names)
    return {"centers": _lanes(centers), "radii": radii, "names": names}


def contact_force_frames(model: MultibodyModel, contact: ContactModel,
                         states, dt: float, force_params=None,
                         device="cuda") -> dict:
    """Per-frame contact points and world-frame force vectors.

    The explicit force law at each saved state (q, v), the playback
    analog of the plant's contact_iters = 0 evaluation, for the HTML
    player's force arrows.  ``dt`` is kept for the JAX signature (the
    explicit law does not use it).

    Returns dict with 'points' (T, NC, 3) and 'forces' (T, NC, 3) —
    forces on body A; inactive candidates have ~zero force.
    """
    force_params = force_params or ContactForceParams()
    dev = resolve_device(device)
    states = _time_major(model, states)
    model, contact = _on(model, contact, dev)
    C = LaneConsts(model, contact, torch.float32)
    x = torch.as_tensor(states.T, dtype=torch.float32, device=dev)
    q, v = x[:model.nq], x[model.nq:]
    (phi, normal, point, _, _, K, d, mu, K1,
     Jc) = _contact_primal_T(model, C, contact, _fk_T(model, C, q))
    v_rel = torch.sum(Jc * v[None, None], dim=2)         # (NC, 3, T)
    f = _contact_forces_T(phi, normal, v_rel, K, d, mu, force_params,
                          K1=K1)
    return {"points": _lanes(point), "forces": _lanes(f)}


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>drake_ddp_tpu playback</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:13px sans-serif; }}
 #hud {{ position:fixed; top:8px; left:10px; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="hud">t = <span id="t">0</span> s &nbsp; (drag: rotate, wheel: zoom,
 space: pause, f: toggle contact forces)</div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let yaw = 0.7, pitch = 0.35, zoom = {zoom}, paused = false, fi = 0,
    showForces = true;
function resize() {{ canvas.width = innerWidth; canvas.height = innerHeight; }}
addEventListener('resize', resize); resize();
let drag = null;
canvas.onmousedown = e => drag = [e.clientX, e.clientY];
onmouseup = () => drag = null;
onmousemove = e => {{ if (drag) {{
  yaw += (e.clientX - drag[0]) * 0.01; pitch += (e.clientY - drag[1]) * 0.01;
  pitch = Math.max(-1.5, Math.min(1.5, pitch)); drag = [e.clientX, e.clientY];
}} }};
canvas.onwheel = e => {{ zoom *= Math.exp(-e.deltaY * 0.001); e.preventDefault(); }};
onkeydown = e => {{ if (e.key === ' ') paused = !paused;
                    if (e.key === 'f') showForces = !showForces; }};
function project(p) {{
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x = cy * p[0] + sy * p[1];
  const y = -sy * p[0] + cy * p[1];
  const z = p[2];
  const yv = cp * y + sp * z, zv = -sp * y + cp * z;
  return [canvas.width / 2 + zoom * x, canvas.height * 0.55 - zoom * zv, yv];
}}
function draw() {{
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  // ground grid
  ctx.strokeStyle = '#333';
  for (let i = -5; i <= 5; i++) {{
    let a = project([i * 0.2, -1, 0]), b = project([i * 0.2, 1, 0]);
    ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); ctx.stroke();
    a = project([-1, i * 0.2, 0]); b = project([1, i * 0.2, 0]);
    ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); ctx.stroke();
  }}
  const frame = DATA.centers[fi];
  const order = frame.map((p, i) => [project(p), i]).sort((a, b) => a[0][2] - b[0][2]);
  for (const [pr, i] of order) {{
    const r = Math.max(2, DATA.radii[i] * zoom);
    ctx.beginPath(); ctx.arc(pr[0], pr[1], r, 0, 6.283);
    ctx.fillStyle = `hsl(${{(i * 47) % 360}}, 60%, 55%)`; ctx.fill();
  }}
  // contact-force arrows (red, length ~ force * fscale), if embedded
  if (DATA.fpoints && showForces) {{
    const pts = DATA.fpoints[fi], fs = DATA.forces[fi];
    ctx.strokeStyle = '#e33'; ctx.fillStyle = '#e33'; ctx.lineWidth = 2;
    for (let i = 0; i < pts.length; i++) {{
      const mag = Math.hypot(fs[i][0], fs[i][1], fs[i][2]);
      if (mag < DATA.fmin) continue;
      const tip = [pts[i][0] + fs[i][0] * DATA.fscale,
                   pts[i][1] + fs[i][1] * DATA.fscale,
                   pts[i][2] + fs[i][2] * DATA.fscale];
      const a = project(pts[i]), b = project(tip);
      ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
      ctx.stroke();
      ctx.beginPath(); ctx.arc(b[0], b[1], 3, 0, 6.283); ctx.fill();
    }}
    ctx.lineWidth = 1;
  }}
  document.getElementById('t').textContent = (fi * DATA.dt).toFixed(3);
  if (!paused) fi = (fi + 1) % DATA.centers.length;
}}
setInterval(draw, 1000 * DATA.dt / DATA.rate);
</script></body></html>
"""



def export_html(path: str, model: MultibodyModel,
                contact: Optional[ContactModel], states,
                dt: float, playback_rate: float = 1.0,
                zoom: float = 400.0, show_forces: bool = False,
                force_params=None, force_scale: float = 0.01,
                force_min: float = 0.5, device="cuda") -> str:
    """Write a self-contained HTML player for a trajectory.

    ``playback_rate`` mirrors the reference's slowed playback
    (cart_pole_with_wall.py:24 playback_rate=0.2 etc.).
    ``show_forces`` embeds contact-force arrows (the reference's
    ConnectContactResultsToDrakeVisualizer display): red arrows of length
    ``force_scale`` m/N at every contact above ``force_min`` N, toggled
    with the 'f' key.  ``device``: where the frames are computed.
    """
    sc = scene_frames(model, contact, states, device=device)
    data = {
        "centers": np.round(sc["centers"], 5).tolist(),
        "radii": np.asarray(sc["radii"]).tolist(),
        "dt": dt,
        "rate": playback_rate,
    }
    if show_forces and contact is not None:
        ff = contact_force_frames(model, contact, states, dt,
                                  force_params=force_params, device=device)
        data["fpoints"] = np.round(ff["points"], 5).tolist()
        data["forces"] = np.round(ff["forces"], 3).tolist()
        data["fscale"] = force_scale
        data["fmin"] = force_min
    html = _HTML_TEMPLATE.format(data=json.dumps(data), zoom=zoom)
    with open(path, "w") as f:
        f.write(html)
    return path


def animate_matplotlib(model: MultibodyModel,
                       contact: Optional[ContactModel], states,
                       dt: float, save_path: Optional[str] = None,
                       device="cuda"):
    """Matplotlib 3D animation (quick look / gif export).  Returns the
    animation object (keep a reference while showing).  matplotlib is
    imported here, not with the module."""
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    sc = scene_frames(model, contact, states, device=device)
    centers, radii = sc["centers"], np.asarray(sc["radii"])

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    span = max(1e-3, float(np.abs(centers).max()))
    scat = ax.scatter(*centers[0].T, s=(radii * 500) ** 1.5 + 5)
    ax.set_xlim(-span, span); ax.set_ylim(-span, span); ax.set_zlim(0, span)

    def update(i):
        scat._offsets3d = tuple(centers[i].T)
        return (scat,)

    anim = animation.FuncAnimation(
        fig, update, frames=len(centers), interval=1000 * dt, blit=False)
    if save_path:
        anim.save(save_path, writer="pillow", fps=max(1, int(1 / dt / 4)))
        plt.close(fig)
    return anim
