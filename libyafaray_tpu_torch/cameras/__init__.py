"""Cameras: `make_camera` and batched `shoot_rays` for every camera kind,
with the thin lens (depth of field) of the perspective and architect kinds,
and the projections `project`, `project_lens` and `raster_jacobian`.

Counterpart of `libyafaray_tpu/cameras/__init__.py`. Pixel coordinates
(px, py) are continuous in [0, resx) x [0, resy) with y down (row 0 at top).
The camera kind is static, so each kind's math runs alone.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .. import params as P
from .. import sampler
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
    """Camera from reference-style params (type/from/to/up/resx/resy/fov or
    scale or angle/aperture/dof_distance/bokeh_type/...)."""
    kind = pm.get_string("type", "perspective")
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
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
    common = dict(
        origin=f32(pos), cam_x=f32(right), cam_y=f32(up), cam_z=f32(fwd),
        aspect=f32(aspect), near_clip=f32(pm.get_float("nearClip", -1.0)),
        far_clip=f32(pm.get_float("farClip", -1.0)), resx=resx, resy=resy,
        focal=f32(1.0), aperture=f32(0.0), dof_distance=f32(0.0),
        angle=f32(0.0), ortho_scale=f32(1.0), bokeh_rotation=f32(0.0),
        max_radius=f32(1.0))
    if kind in ("perspective", "architect"):
        # focal = 0.5 / tan(fov/2) in screen units where x spans [-0.5, 0.5)
        fov = pm.get_float("fov", 45.0) * math.pi / 180.0
        aperture = pm.get_float("aperture", 0.0)
        common.update(focal=f32(0.5 / math.tan(fov * 0.5)),
                      aperture=f32(aperture),
                      dof_distance=f32(pm.get_float("dof_distance", 0.0)))
        return Camera(kind=kind, bokeh_kind=pm.get_string("bokeh_type", "disk"),
                      dof=aperture > 0.0, **common)
    if kind == "orthographic":
        common.update(ortho_scale=f32(pm.get_float("scale", 1.0)))
        return Camera(kind=kind, **common)
    if kind == "angular":
        ang = pm.get_float("angle", 90.0)
        # clip radius in image-half-width units (max_angle / angle)
        common.update(angle=f32(ang * math.pi / 180.0),
                      max_radius=f32(pm.get_float("max_angle", ang)
                                     / max(ang, 1e-9)))
        return Camera(kind=kind,
                      angular_projection=pm.get_string("projection",
                                                       "equidistant"),
                      circular=pm.get_bool("circular", True),
                      mirrored=pm.get_bool("mirrored", False), **common)
    if kind == "equirectangular":
        return Camera(kind=kind, **common)
    raise KeyError(f"camera: unknown type {kind!r}")


_BOKEH_SIDES = {"triangle": 3, "square": 4, "pentagon": 5, "hexagon": 6}


def _sample_bokeh(kind: str, u1: Tensor, u2: Tensor, rotation: Tensor):
    """A point of the aperture for the bokeh shape `kind`: the disk (disk1,
    disk2), the ring, or a regular polygon (triangle .. hexagon) rotated by
    `rotation`, uniform over its area."""
    if kind == "ring":
        ang = 2.0 * math.pi * u1
        return torch.cos(ang), torch.sin(ang)
    sides = _BOKEH_SIDES.get(kind, 0)
    if sides == 0:   # disk, disk1, disk2 and unknown kinds
        return vec.sample_disk_concentric(u1, u2)
    # one wedge of the polygon, then a uniform point of it
    wedge = torch.floor(u1 * sides)
    fu = u1 * sides - wedge
    a0 = (wedge / sides) * 2.0 * math.pi + rotation
    a1 = ((wedge + 1.0) / sides) * 2.0 * math.pi + rotation
    b0, b1 = vec.sample_triangle_uniform(fu, u2)
    # the wedge's third corner is the centre, which adds nothing
    w0 = 1.0 - b0 - b1
    return (torch.cos(a0) * w0 + torch.cos(a1) * b1,
            torch.sin(a0) * w0 + torch.sin(a1) * b1)


def lens_samples(cam: Camera, pixel_id: Tensor, sample_idx):
    """The lens samples (lens_u, lens_v) of a thin-lens camera, keyed on
    (pixel_id, sample_idx) as in the JAX package; (None, None) for the
    other cameras, which take none."""
    if not cam.dof:
        return None, None
    return (sampler.rand1(pixel_id, sample_idx, 0, 777),
            sampler.rand1(pixel_id, sample_idx, 0, 778))


def shoot_rays(cam: Camera, px: Tensor, py: Tensor,
               lens_u: Tensor | None = None, lens_v: Tensor | None = None
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Batched Camera::shootRay. Returns (origin[N,3], dir[N,3], valid[N]).
    The lens samples lens_u, lens_v in [0, 1) place the ray on the aperture
    of a thin-lens camera (`cam.dof`); other cameras ignore them."""
    sx = px / float(cam.resx) - 0.5
    sy = (py / float(cam.resy) - 0.5) * cam.aspect
    ones = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    kind = cam.kind

    if kind in ("perspective", "architect"):
        # the architect keeps the world's up axis as the image's vertical
        # (two-point perspective: vertical lines stay parallel)
        v_axis = (torch.tensor([0.0, 0.0, 1.0], device=px.device)
                  if kind == "architect" else cam.cam_y)
        d = (cam.cam_z * cam.focal + cam.cam_x * sx[..., None]
             - v_axis * sy[..., None])
        d = vec.normalize(d)
        o = cam.origin.expand_as(d)
        if cam.dof:
            # jitter the origin on the aperture and refocus at dof_distance
            lu, lv = _sample_bokeh(cam.bokeh_kind, lens_u, lens_v,
                                   cam.bokeh_rotation)
            focus_t = cam.dof_distance / torch.clamp_min(
                vec.dot(d, cam.cam_z), 1e-6)
            focus_p = o + d * focus_t[..., None]
            o = o + (cam.cam_x * lu[..., None]
                     + cam.cam_y * lv[..., None]) * cam.aperture
            d = vec.normalize(focus_p - o)
        return o, d, ones

    if kind == "orthographic":
        o = (cam.origin + cam.cam_x * (sx * cam.ortho_scale)[..., None]
             - cam.cam_y * (sy * cam.ortho_scale)[..., None])
        return o, cam.cam_z.expand_as(o), ones

    if kind == "angular":
        # the reference's angular view is mirrored in x against its other
        # cameras (u = 1 - 2 px / resx); the radius maps to the polar angle
        # through the projection, the azimuth is atan2(v, u)
        r = torch.sqrt(sx * sx + sy * sy) * 2.0
        phi = torch.atan2(-sy, sx if cam.mirrored else -sx)
        proj = cam.angular_projection
        if proj == "orthographic":
            theta = torch.asin(torch.clamp(r * torch.sin(cam.angle), -1.0, 1.0))
        elif proj == "stereographic":
            theta = 2.0 * torch.atan(r * torch.tan(cam.angle * 0.5))
        elif proj == "equisolid_angle":
            theta = 2.0 * torch.asin(torch.clamp(
                r * torch.sin(cam.angle * 0.5), -1.0, 1.0))
        elif proj == "rectilinear":
            theta = torch.atan(r * torch.tan(cam.angle))
        else:  # equidistant
            theta = r * cam.angle
        st = torch.sin(theta)
        d = (cam.cam_z * torch.cos(theta)[..., None]
             + cam.cam_x * (st * torch.cos(phi))[..., None]
             + cam.cam_y * (st * torch.sin(phi))[..., None])
        valid = (r <= cam.max_radius) if cam.circular else ones
        return cam.origin.expand_as(d), vec.normalize(d), valid

    if kind == "equirectangular":
        # phi = pi u, theta = pi/2 v with u, v in [-1, 1); row 0 is the up
        # pole (the reference feeds its cameras row-flipped py)
        phi = 2.0 * math.pi * sx
        theta = -math.pi * (sy / torch.clamp_min(cam.aspect, 1e-6))
        ct = torch.cos(theta)
        d = (cam.cam_z * (ct * torch.cos(phi))[..., None]
             + cam.cam_x * (ct * torch.sin(phi))[..., None]
             + cam.cam_y * torch.sin(theta)[..., None])
        return cam.origin.expand_as(d), vec.normalize(d), ones

    raise KeyError(f"camera kind {kind!r}")


def raster_jacobian(cam: Camera, d: Tensor) -> Tensor:
    """|d(raster px, py) / d omega| of a unit direction d leaving a
    perspective camera: resx resy focal^2 / (aspect cos^3 theta)."""
    if cam.kind != "perspective":
        raise NotImplementedError(
            f"raster_jacobian for camera kind {cam.kind!r}")
    cosc = torch.clamp_min(vec.dot(d, cam.cam_z), 1e-6)
    return (float(cam.resx * cam.resy) * cam.focal * cam.focal
            / (torch.clamp_min(cam.aspect, 1e-6) * cosc * cosc * cosc))


def project_lens(cam: Camera, p: Tensor, lens_u: Tensor, lens_v: Tensor):
    """Raster position of world point p seen through the sampled lens point
    L = origin + aperture * bokeh(lens_u, lens_v): the pinhole projection of
    the point where the ray L -> p crosses the focal plane. Without an
    aperture (or focus distance) it is `project`. Returns (px, py, visible,
    L)."""
    bu, bv = _sample_bokeh(cam.bokeh_kind, lens_u, lens_v, cam.bokeh_rotation)
    lens = (cam.cam_x * bu[..., None] + cam.cam_y * bv[..., None]) \
        * cam.aperture
    lpt = cam.origin + lens
    rel = p - lpt
    z = vec.dot(rel, cam.cam_z)
    use_dof = (cam.aperture > 0.0) & (cam.dof_distance > 0.0)
    # the focal-plane point (depth dof_distance along cam_z)
    f_rel = lens + rel * (cam.dof_distance / torch.clamp_min(z, 1e-9))[..., None]
    dist = torch.clamp_min(cam.dof_distance, 1e-9)
    x = vec.dot(f_rel, cam.cam_x) / dist * cam.focal
    y = -vec.dot(f_rel, cam.cam_y) / dist * cam.focal
    pxl = (x + 0.5) * cam.resx
    pyl = (y / cam.aspect + 0.5) * cam.resy
    px0, py0, vis0 = project(cam, p)
    visl = ((z > 0) & (pxl >= 0) & (pxl < cam.resx) & (pyl >= 0)
            & (pyl < cam.resy))
    return (torch.where(use_dof, pxl, px0), torch.where(use_dof, pyl, py0),
            torch.where(use_dof, visl, vis0),
            torch.where(use_dof, lpt, cam.origin.expand_as(lpt)))


def project(cam: Camera, p: Tensor):
    """World point -> (px, py, visible): Camera::screenproject of the
    perspective, architect and orthographic cameras."""
    rel = p - cam.origin
    z = vec.dot(rel, cam.cam_z)

    def raster(x, y, front):
        px = (x + 0.5) * cam.resx
        py = (y / cam.aspect + 0.5) * cam.resy
        return px, py, (front & (px >= 0) & (px < cam.resx) & (py >= 0)
                        & (py < cam.resy))

    if cam.kind == "perspective":
        x = vec.dot(rel, cam.cam_x) / torch.clamp_min(z, 1e-9) * cam.focal
        y = -vec.dot(rel, cam.cam_y) / torch.clamp_min(z, 1e-9) * cam.focal
        return raster(x, y, z > 0)
    if cam.kind == "architect":
        # invert dir = s (cam_z focal + cam_x X - ez Y): the image's vertical
        # axis is world z, in general not orthogonal to cam_x, cam_z
        ez = torch.tensor([0.0, 0.0, 1.0], device=p.device)
        m = torch.stack([cam.cam_x, -ez, cam.cam_z * cam.focal], dim=-1)
        coef = rel @ torch.linalg.inv(m).T
        c = coef[..., 2]
        c_safe = torch.where(torch.abs(c) > 1e-9, c, 1e-9)
        return raster(coef[..., 0] / c_safe, coef[..., 1] / c_safe, c > 0)
    if cam.kind == "orthographic":
        x = vec.dot(rel, cam.cam_x) / cam.ortho_scale
        y = -vec.dot(rel, cam.cam_y) / cam.ortho_scale
        return raster(x, y, z > 0)
    raise NotImplementedError(f"project for camera kind {cam.kind!r}")
