"""Textures: the image texel pool and its per-lane evaluation.

Counterpart of `libyafaray_tpu/textures/__init__.py` for image textures:
the type enum, `build_texture_pool` (textures/build.py) and
`sample_texture` (textures/eval.py, which samples through
textures/image.py). Procedural textures and texture backgrounds (the
environment map's sampling and importance tables) are not ported yet: a
procedural texture raises NotImplementedError at compile, and the
environment functions below raise when called.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..scene_types import SceneData, TexturePool

Tensor = torch.Tensor

# texture type enum (the reference's factory strings)
TEX_IMAGE = 0
TEX_BLEND = 1
TEX_CLOUDS = 2
TEX_MARBLE = 3
TEX_WOOD = 4
TEX_VORONOI = 5
TEX_MUSGRAVE = 6
TEX_DISTORTED_NOISE = 7
TEX_RGB_CUBE = 8

MAX_MIPS = 12
RAMP_MAX = 8


def build_texture_pool(builder) -> Optional[TexturePool]:
    """Freeze the builder's staged textures into a TexturePool on the CPU
    (None when the scene has no textures)."""
    if not builder.texture_order:
        return None
    from .build import build_pool
    return build_pool(builder)


def sample_texture(scene: SceneData, tex_id: Tensor, p: Tensor, uv: Tensor,
                   duv_dx: Optional[Tensor] = None,
                   duv_dy: Optional[Tensor] = None) -> Tensor:
    """rgba f32[N, 4] of texture tex_id (per lane) at the texture-space
    point p and uv; the uv-space screen derivatives, when given, drive the
    mipmap and EWA filters."""
    from .eval import eval_textures
    return eval_textures(scene, tex_id, p, uv, duv_dx=duv_dx, duv_dy=duv_dy)


def _texture_backgrounds():
    return NotImplementedError("texture backgrounds (environment maps) are "
                               "not ported to libyafaray_tpu_torch yet")


def sample_env(scene: SceneData, d: Tensor, bg) -> Tensor:
    raise _texture_backgrounds()


def env_alias_sample(scene: SceneData, u1: Tensor, u2: Tensor):
    raise _texture_backgrounds()


def env_pdf_dir(scene: SceneData, d: Tensor) -> Tensor:
    raise _texture_backgrounds()
