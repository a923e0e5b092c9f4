"""Visualization — the port of momentum_tpu/gui (reference: momentum/gui/
and pymomentum's rerun and viser viewers).

Three tiers:
  * `rerun_vis`, the rerun.io logging surface (logCharacter, logMarkers,
    logModelParams, log_animation; gui/rerun/logger.h:96-163): real
    archetypes when the SDK is importable, else an in-process recording of
    the same stream;
  * `viser_vis`, the viser live-scene surface (show, update, animate)
    against an injected scene, a FallbackScene recorder without a server;
  * offline: motions rendered through the rasterizer on the card and
    exported as animated GIFs or image sequences.
"""

from momentum_tpu_torch.gui import rerun_vis, viser_vis  # noqa: F401
from momentum_tpu_torch.gui.gif import save_gif  # noqa: F401
from momentum_tpu_torch.gui.viewer import (  # noqa: F401
    auto_camera, create_camera_for_body, create_camera_for_hand, draw_markers,
    draw_skeleton, render_motion, save_motion_gif)
