"""libyafaray_tpu_torch: the PyTorch / CUDA port of libyafaray_tpu.

A second package beside the JAX one, held against it module by module. It
imports torch and numpy only. The forward path of the Cornell box renders
under the `pathtracing` and `directlighting` integrators; every intersection
query on a CUDA device runs the hand-written kernel of
`csrc/mt_intersect.cu` (see `accel/mt_intersect.py`).
"""
from .integrators.mc import IntegratorConfig, make_integrator
from .render import render, render_pass_fn
from .scene import SceneBuilder
from .scene_types import SceneData

__all__ = ["SceneBuilder", "SceneData", "IntegratorConfig", "make_integrator",
           "render", "render_pass_fn"]
