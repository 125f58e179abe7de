"""Render lifecycle state: `RenderControl`, a copy of the class in
`libyafaray_tpu/utils/logger.py`. The logger itself comes with the port's
periphery slice."""
from __future__ import annotations


class RenderControl:
    """Render lifecycle state (include/render/render_control.h:30-65):
    started / in-progress / finished / canceled / resumed + progress.
    Cooperative cancel: the render loop polls `canceled` between passes
    (the wavefront pass itself is atomic, like the reference's per-tile
    granularity)."""

    def __init__(self):
        self.started = False
        self.finished = False
        self.canceled = False
        self.resumed = False
        self.progress = 0.0
        self.render_info = ""
        self.aa_noise_info = ""

    def set_started(self):
        self.started = True
        self.finished = False
        self.canceled = False

    def set_finished(self):
        self.finished = True

    def set_canceled(self):
        self.canceled = True

    def set_resumed(self):
        self.resumed = True

    def set_progress(self, fraction: float):
        self.progress = float(fraction)
