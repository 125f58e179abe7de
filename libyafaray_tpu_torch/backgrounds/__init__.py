"""Backgrounds: `make_background` and `eval_background`, constant only.

Counterpart of `libyafaray_tpu/backgrounds/__init__.py`. A constant
background with `ibl` also lights the scene: `SceneBuilder` then adds a
background light (`lights.LIGHT_BACKGROUND`) sampled uniformly over the
sphere."""
from __future__ import annotations

import torch

from .. import params as P
from ..scene_types import Background

Tensor = torch.Tensor


def eval_background(scene, d: Tensor) -> Tensor:
    """Background::operator()(dir) for the whole wavefront."""
    bg: Background = scene.background
    if bg.kind != "constant":
        raise NotImplementedError(f"background kind {bg.kind!r} is not "
                                  "ported to libyafaray_tpu_torch yet")
    return (bg.color * bg.power).expand(d.shape[:-1] + (3,))


def make_background(pm: P.ParamMap) -> Background:
    kind = pm.get_string("type", "constant")
    if kind != "constant":
        raise NotImplementedError(f"background type {kind!r} is not ported "
                                  "to libyafaray_tpu_torch yet")
    return Background(
        kind="constant",
        color=torch.from_numpy(pm.get_color("color", (1, 1, 1))[:3].copy()),
        power=torch.tensor(pm.get_float("power", 1.0), dtype=torch.float32))
