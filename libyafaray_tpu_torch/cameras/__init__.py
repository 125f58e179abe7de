"""Cameras: `make_camera` and batched `shoot_rays`, perspective only.

Counterpart of `libyafaray_tpu/cameras/__init__.py`. Pixel coordinates
(px, py) are continuous in [0, resx) x [0, resy) with y down (row 0 at top).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .. import params as P
from ..math import vec
from ..scene_types import Camera

Tensor = torch.Tensor


def _build_frame(pos, look, up):
    pos = np.asarray(pos, np.float32)
    look = np.asarray(look, np.float32)
    up = np.asarray(up, np.float32)
    forward = look - pos
    fn = forward / max(np.linalg.norm(forward), 1e-20)
    upv = up - pos
    right = np.cross(fn, upv)
    if np.linalg.norm(right) < 1e-12:  # up parallel to view dir
        right = np.array([1.0, 0.0, 0.0], np.float32)
    right = right / max(np.linalg.norm(right), 1e-20)
    upn = np.cross(right, fn)
    upn = upn / max(np.linalg.norm(upn), 1e-20)
    return pos, right.astype(np.float32), upn.astype(np.float32), fn.astype(np.float32)


def make_camera(pm: P.ParamMap) -> Camera:
    """Camera from reference-style params (type/from/to/up/resx/resy/fov)."""
    kind = pm.get_string("type", "perspective")
    if kind != "perspective":
        raise NotImplementedError(
            f"camera type {kind!r} is not ported to libyafaray_tpu_torch yet")
    if pm.get_float("aperture", 0.0) > 0.0:
        raise NotImplementedError(
            "depth of field (camera aperture > 0) is not ported to "
            "libyafaray_tpu_torch yet")
    resx = pm.get_int("resx", 256)
    resy = pm.get_int("resy", 256)
    pos, right, up, fwd = _build_frame(
        pm.get_vector("from", (0, 0, 0)),
        pm.get_vector("to", (0, 1, 0)),
        pm.get_vector("up", (0, 0, 1)) if "up" in pm else
        np.asarray(pm.get_vector("from", (0, 0, 0)), np.float32)
        + np.array([0, 0, 1], np.float32),
    )
    aspect = resy / resx * pm.get_float("aspect_ratio_factor", 1.0)
    # focal = 0.5 / tan(fov/2) in screen units where x spans [-0.5, 0.5)
    fov = pm.get_float("fov", 45.0) * math.pi / 180.0
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    return Camera(kind=kind, origin=f32(pos), cam_x=f32(right), cam_y=f32(up),
                  cam_z=f32(fwd), focal=f32(0.5 / math.tan(fov * 0.5)),
                  aspect=f32(aspect), resx=resx, resy=resy)


def shoot_rays(cam: Camera, px: Tensor, py: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Batched Camera::shootRay. Returns (origin[N,3], dir[N,3], valid[N])."""
    sx = px / float(cam.resx) - 0.5
    sy = (py / float(cam.resy) - 0.5) * cam.aspect
    d = (cam.cam_z * cam.focal + cam.cam_x * sx[..., None]
         - cam.cam_y * sy[..., None])
    d = vec.normalize(d)
    o = cam.origin.expand_as(d)
    return o, d, torch.ones(px.shape, dtype=torch.bool, device=px.device)
