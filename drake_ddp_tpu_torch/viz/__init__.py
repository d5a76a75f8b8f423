"""Host-side visualization and trajectory export.

Port of ``drake_ddp_tpu/viz``, off the solve's path:

- :func:`scene_frames`: forward-kinematics playback of a state
  trajectory into per-frame collision-sphere positions;
- :func:`contact_force_frames`: contact points and forces per frame;
- :func:`export_html`: a self-contained interactive HTML player (no
  external assets);
- :func:`animate_matplotlib`: a matplotlib animation for quick looks;
- :class:`MPCStream`: per-resolve MPC trajectory recorder and
  ghost-overlay player, with a live mode that rewrites the player file
  during the solve.
"""

from drake_ddp_tpu_torch.viz.playback import (
    animate_matplotlib,
    contact_force_frames,
    export_html,
    scene_frames,
)
from drake_ddp_tpu_torch.viz.stream import MPCStream

__all__ = ["MPCStream", "animate_matplotlib", "contact_force_frames",
           "export_html", "scene_frames"]
