"""Per-resolve MPC trajectory streaming.

Port of ``drake_ddp_tpu/viz/stream.py``.  The reference publishes every
MPC resolve to a live visualizer.  Here each resolve's predicted horizon
is copied to the host once, only when a stream is passed, and the run is
exported as one self-contained HTML player that animates the executed
trajectory with the current resolve's predicted horizon as a fading
ghost.

During-solve viewing: construct the stream with ``live_path`` (plus
model, contact and dt) and every ``live_every``-th :meth:`record`
rewrites the player file, atomically, with a 2-second auto-reload tag;
open it in a browser while the MPC chain runs.  The rewrite happens on
the host between solves.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from drake_ddp_tpu_torch.contact.geometry import ContactModel
from drake_ddp_tpu_torch.multibody.model import MultibodyModel
from drake_ddp_tpu_torch.viz.playback import scene_frames


class MPCStream:
    """Records each MPC resolve's predicted trajectory for playback.

    Usage (see examples/mini_cheetah.py run(..., stream=...)):
        stream = MPCStream(replan_steps=rs)
        stream.record(x)          # after every solve: x (n, N) or (N, n)
        stream.export_html(path, model, contact, dt)

    ``device``: where the player's frames are computed."""

    def __init__(self, replan_steps: int, live_path: Optional[str] = None,
                 model: Optional[MultibodyModel] = None,
                 contact: Optional[ContactModel] = None,
                 dt: Optional[float] = None, live_every: int = 1,
                 device="cuda"):
        self.replan_steps = int(replan_steps)
        self.resolves: List[np.ndarray] = []
        self.live_path = live_path
        self._live = (model, contact, dt)
        self.live_every = max(1, int(live_every))
        self.device = device
        if live_path is not None and (model is None or dt is None):
            raise ValueError("live_path needs model and dt")

    def record(self, x) -> None:
        """Append one resolve's predicted state trajectory (numpy, or a
        tensor on any device, copied to the host once).  In live mode
        also rewrite the player file."""
        x = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x))
        self.resolves.append(x)
        if (self.live_path is not None
                and len(self.resolves) % self.live_every == 0):
            model, contact, dt = self._live
            self.export_html(self.live_path, model, contact, dt,
                             _live_reload=True)

    def executed(self, n: int) -> np.ndarray:
        """Stitched closed-loop trajectory (T, n): the first replan_steps
        of every resolve, plus the final resolve's full horizon (the
        reference's stitched states array)."""
        rs = self.replan_steps
        segs = []
        for x in self.resolves[:-1]:
            xs = x if x.shape[0] != n else x.T      # to (N, n)
            segs.append(xs[:rs])
        last = self.resolves[-1]
        segs.append(last if last.shape[0] != n else last.T)
        return np.concatenate(segs, axis=0)

    def export_html(self, path: str, model: MultibodyModel,
                    contact: Optional[ContactModel], dt: float,
                    playback_rate: float = 1.0, zoom: float = 400.0,
                    ghost_stride: int = 4,
                    _live_reload: bool = False) -> str:
        """Write one HTML player: executed trajectory + per-resolve
        prediction ghosts (every ``ghost_stride``-th horizon step)."""
        n = model.nq + model.nv
        rs = self.replan_steps
        executed = self.executed(n)
        sc = scene_frames(model, contact, executed, device=self.device)
        ghosts = []
        for x in self.resolves:
            xs = x if x.shape[0] != n else x.T
            g = scene_frames(model, contact, xs[::ghost_stride],
                             device=self.device)
            ghosts.append(np.round(g["centers"], 5).tolist())
        data = {
            "centers": np.round(sc["centers"], 5).tolist(),
            "radii": np.asarray(sc["radii"]).tolist(),
            "dt": dt,
            "rate": playback_rate,
            "rs": rs,
            "ghosts": ghosts,
        }
        html = _STREAM_TEMPLATE.format(data=json.dumps(data), zoom=zoom)
        if _live_reload:
            # the browser re-reads the file every 2 s; the atomic rename
            # means a reload never sees a half-written player
            html = html.replace(
                "<meta charset=\"utf-8\">",
                "<meta charset=\"utf-8\">"
                "<meta http-equiv=\"refresh\" content=\"2\">", 1)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(html)
            os.replace(tmp, path)
            return path
        with open(path, "w") as f:
            f.write(html)
        return path


_STREAM_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>drake_ddp_tpu MPC stream</title>
<style>
 body {{ margin:0; background:#111; color:#ddd; font:13px sans-serif; }}
 #hud {{ position:fixed; top:8px; left:10px; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="hud">t = <span id="t">0</span> s &nbsp; resolve
 <span id="r">0</span> &nbsp; (drag: rotate, wheel: zoom, space: pause,
 g: toggle prediction ghost)</div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let yaw = 0.7, pitch = 0.35, zoom = {zoom}, paused = false, fi = 0,
    showGhost = true;
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
                    if (e.key === 'g') showGhost = !showGhost; }};
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
  ctx.strokeStyle = '#333';
  for (let i = -5; i <= 5; i++) {{
    let a = project([i * 0.2, -1, 0]), b = project([i * 0.2, 1, 0]);
    ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); ctx.stroke();
    a = project([-1, i * 0.2, 0]); b = project([1, i * 0.2, 0]);
    ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); ctx.stroke();
  }}
  const ri = Math.min(Math.floor(fi / DATA.rs), DATA.ghosts.length - 1);
  if (showGhost) {{
    const ghost = DATA.ghosts[ri];
    for (let k = 0; k < ghost.length; k++) {{
      const fade = 0.35 * (1 - k / ghost.length) + 0.05;
      for (let i = 0; i < ghost[k].length; i++) {{
        const pr = project(ghost[k][i]);
        const r = Math.max(1, DATA.radii[i] * zoom * 0.7);
        ctx.beginPath(); ctx.arc(pr[0], pr[1], r, 0, 6.283);
        ctx.fillStyle = `hsla(${{(i * 47) % 360}}, 60%, 70%, ${{fade}})`;
        ctx.fill();
      }}
    }}
  }}
  const frame = DATA.centers[fi];
  const order = frame.map((p, i) => [project(p), i]).sort((a, b) => a[0][2] - b[0][2]);
  for (const [pr, i] of order) {{
    const r = Math.max(2, DATA.radii[i] * zoom);
    ctx.beginPath(); ctx.arc(pr[0], pr[1], r, 0, 6.283);
    ctx.fillStyle = `hsl(${{(i * 47) % 360}}, 60%, 55%)`; ctx.fill();
  }}
  document.getElementById('t').textContent = (fi * DATA.dt).toFixed(3);
  document.getElementById('r').textContent = ri;
  if (!paused) fi = (fi + 1) % DATA.centers.length;
}}
setInterval(draw, 1000 * DATA.dt / DATA.rate);
</script></body></html>
"""
