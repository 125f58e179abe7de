"""Textures: the image texel pool, the procedural types and their per-lane
evaluation.

Counterpart of `libyafaray_tpu/textures/__init__.py`: the type enum,
`build_texture_pool` (textures/build.py), `sample_texture`
(textures/eval.py, which evaluates the procedural types through
textures/procedural.py and textures/noise.py, and samples images through
textures/image.py) and the environment map of texture backgrounds: its
lookup `sample_env` and the importance sampling of its background light
(`env_alias_sample`, `env_pdf_dir`, over the alias tables of
`build.build_env_tables`).
"""
from __future__ import annotations

import math

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
                   duv_dy: Optional[Tensor] = None,
                   static_tex: Optional[int] = None) -> Tensor:
    """rgba f32[N, 4] of texture tex_id (per lane) at the texture-space
    point p and uv; the uv-space screen derivatives, when given, drive the
    mipmap and EWA filters. `static_tex` names the texture when every lane
    reads the same one: only its own code runs."""
    from .eval import eval_textures
    return eval_textures(scene, tex_id, p, uv, duv_dx=duv_dx, duv_dy=duv_dy,
                         static_tex=static_tex)


def _dir_to_equirect_uv(d: Tensor, rotation: Tensor) -> Tensor:
    u = (torch.atan2(d[..., 1], d[..., 0]) + rotation) / (2 * math.pi) + 0.5
    v = 1.0 - torch.acos(torch.clamp(d[..., 2], -1.0, 1.0)) / math.pi
    return torch.stack([torch.remainder(u, 1.0), v], dim=-1)


def _dir_to_angular_uv(d: Tensor, rotation: Tensor) -> Tensor:
    """The angular (light-probe) mapping of texture backgrounds."""
    r = torch.acos(torch.clamp(-d[..., 2], -1.0, 1.0)) / math.pi
    den = torch.sqrt(torch.clamp_min(d[..., 0] ** 2 + d[..., 1] ** 2, 1e-12))
    u = 0.5 + 0.5 * r * d[..., 0] / den
    v = 0.5 + 0.5 * r * d[..., 1] / den
    return torch.stack([u, v], dim=-1)


def sample_env(scene: SceneData, d: Tensor, bg) -> Tensor:
    """The environment map of a texture background in directions d
    (background_texture.cc)."""
    if bg.mapping == "angular":
        uv = _dir_to_angular_uv(d, bg.rotation)
    else:
        uv = _dir_to_equirect_uv(d, bg.rotation)
    tex_id = torch.full(d.shape[:-1], bg.tex_id, dtype=torch.int32,
                        device=d.device)
    return sample_texture(scene, tex_id, d, uv,
                          static_tex=bg.tex_id)[..., :3]


def env_alias_sample(scene: SceneData, u1: Tensor, u2: Tensor):
    """An importance sample of the environment map by its alias table:
    (direction, solid-angle pdf). The alias method takes the place of the
    reference's per-row CDF search (light_background.cc:51-69)."""
    bg = scene.background
    h, w = bg.env_shape
    n_texel = h * w
    idx = torch.clamp((u1 * n_texel).to(torch.int32), 0, n_texel - 1)
    frac = u1 * n_texel - idx.to(torch.float32)
    idx = idx.long()
    texel = torch.where(frac > bg.env_alias_prob[idx],
                        bg.env_alias_idx[idx].long(), idx)
    ty = texel // w
    tx = texel % w
    # jitter inside the texel: u2 drives both axes through its low bits
    ju = torch.remainder(u2 * 7919.0, 1.0)
    jv = torch.remainder(u2 * 104729.0, 1.0)
    uu = (tx.to(torch.float32) + ju) / w
    vv = (ty.to(torch.float32) + jv) / h
    phi = (uu - 0.5) * 2.0 * math.pi - bg.rotation
    theta = (1.0 - vv) * math.pi
    st = torch.sin(theta)
    d = torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                     torch.cos(theta)], dim=-1)
    return d, torch.clamp_min(bg.env_pdf[texel], 1e-12)


def env_pdf_dir(scene: SceneData, d: Tensor) -> Tensor:
    """The pdf with which env_alias_sample gives direction d (for MIS)."""
    bg = scene.background
    h, w = bg.env_shape
    uv = _dir_to_equirect_uv(d, bg.rotation)
    tx = torch.clamp((uv[..., 0] * w).to(torch.int32), 0, w - 1)
    ty = torch.clamp(((1.0 - uv[..., 1]) * h).to(torch.int32), 0, h - 1)
    return bg.env_pdf[(ty * w + tx).long()]
