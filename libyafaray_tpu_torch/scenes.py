"""Built-in scenes, made with the port's own SceneBuilder: the Cornell box
and the terrain of BASELINE config 3 (copies of `tests/scenes.py`)."""
from __future__ import annotations

import numpy as np

from .scene import SceneBuilder


def cornell_builder(white_emit: float = 12.0) -> SceneBuilder:
    """Cornell box in [0,1]^3 (camera looks +y, z up): floor, ceiling and
    back wall white, left wall red, right wall green, two rotated boxes and
    a ceiling area light. 34 triangles, plus the light's 2-triangle quad."""
    b = SceneBuilder()
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.73, 0.73, 0.73)})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.65, 0.05, 0.05)})
    b.create_material("green", {"type": "shinydiffusemat",
                                "color": (0.12, 0.45, 0.15)})

    b.create_object("walls")

    def quad(mat, p0, p1, p2, p3):
        b.set_current_material(mat)
        i0 = b.add_vertex(*p0)
        i1 = b.add_vertex(*p1)
        i2 = b.add_vertex(*p2)
        i3 = b.add_vertex(*p3)
        b.add_quad(i0, i1, i2, i3)

    quad("white", (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))          # floor
    quad("white", (0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1))          # ceiling
    quad("white", (0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1))          # back
    quad("red", (0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))            # left
    quad("green", (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))          # right

    b.create_object("box1")   # short box
    b.set_current_material("white")
    _box(b, (0.55, 0.45, 0.0), (0.30, 0.30, 0.30), rot=-0.30)
    b.create_object("box2")   # tall box
    b.set_current_material("white")
    _box(b, (0.15, 0.6, 0.0), (0.30, 0.30, 0.60), rot=0.35)

    b.create_light("lamp", {
        "type": "arealight",
        # emitting normal is cross(e1, e2): this ordering points it down
        "corner": (0.35, 0.35, 0.999), "point1": (0.35, 0.65, 0.999),
        "point2": (0.65, 0.35, 0.999),
        "color": (1.0, 0.9, 0.8), "power": white_emit, "samples": 1})
    b.create_camera("cam", {"type": "perspective",
                            "from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                            "up": (0.5, -1.35, 1.5),
                            "resx": 64, "resy": 64, "fov": 39.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    return b


def _box(b: SceneBuilder, origin, size, rot=0.0) -> None:
    ox, oy, oz = origin
    sx, sy, sz = size
    c, s = np.cos(rot), np.sin(rot)
    cx, cy = ox + sx / 2, oy + sy / 2

    def v(x, y, z):
        rx = cx + (x - cx) * c - (y - cy) * s
        ry = cy + (x - cx) * s + (y - cy) * c
        return b.add_vertex(rx, ry, z)

    p = [v(ox, oy, oz), v(ox + sx, oy, oz), v(ox + sx, oy + sy, oz),
         v(ox, oy + sy, oz), v(ox, oy, oz + sz), v(ox + sx, oy, oz + sz),
         v(ox + sx, oy + sy, oz + sz), v(ox, oy + sy, oz + sz)]
    b.add_quad(p[0], p[1], p[5], p[4])
    b.add_quad(p[1], p[2], p[6], p[5])
    b.add_quad(p[2], p[3], p[7], p[6])
    b.add_quad(p[3], p[0], p[4], p[7])
    b.add_quad(p[4], p[5], p[6], p[7])  # top
    b.add_quad(p[3], p[2], p[1], p[0])  # bottom


# the terrain's camera (BASELINE config 3)
TERRAIN_CAMERA = {"type": "perspective", "from": (2.0, -2.5, 2.2),
                  "to": (2.0, 2.0, 0.0), "up": (2.0, -2.5, 3.2),
                  "resx": 720, "resy": 720, "fov": 55.0}


def bigmesh_grid(res: int):
    """The displaced terrain grid of `bigmesh_builder` as numpy arrays:
    (vertices f32[res*res, 3], faces i32[2*(res-1)^2, 3], xx, yy)."""
    xs = np.linspace(0.0, 4.0, res, dtype=np.float32)
    ys = np.linspace(0.0, 4.0, res, dtype=np.float32)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    zz = (0.35 * np.sin(xx * 2.3) * np.cos(yy * 1.7)
          + 0.12 * np.sin(xx * 9.1 + 1.0) * np.sin(yy * 8.3)
          + 0.04 * np.sin(xx * 31.0) * np.cos(yy * 29.0)).astype(np.float32)
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    i = np.arange(res * res).reshape(res, res)
    a = i[:-1, :-1].ravel(); b2 = i[1:, :-1].ravel()
    c = i[1:, 1:].ravel(); d2 = i[:-1, 1:].ravel()
    faces = np.concatenate([np.stack([a, b2, c], -1),
                            np.stack([a, c, d2], -1)]).astype(np.int32)
    return verts, faces, xx, yy


def bigmesh_builder(res: int = 320, textured: bool = True) -> SceneBuilder:
    """BASELINE config 3: a displaced terrain grid of 2*(res-1)^2 triangles
    (res=320: 203,522) under a sun and a constant background with ibl, seen
    by a 720x720 camera. `textured=True` (the image-textured material)
    raises NotImplementedError until textures are ported; `textured=False`
    is the same scene with a plain diffuse material."""
    if textured:
        raise NotImplementedError(
            "textures are not ported to libyafaray_tpu_torch yet; use "
            "bigmesh_builder(textured=False)")
    b = SceneBuilder()
    b.create_material("ground", {"type": "shinydiffusemat",
                                 "color": (0.6, 0.55, 0.5)})
    b.create_object("terrain")
    b.set_current_material("ground")
    verts, faces, _, _ = bigmesh_grid(res)
    b.add_mesh_arrays(verts, faces)
    b.create_light("sun", {"type": "sunlight", "direction": (0.3, 0.3, 0.8),
                           "color": (1.0, 1.0, 0.95), "power": 1.0})
    b.create_camera("cam", dict(TERRAIN_CAMERA))
    b.create_background({"type": "constant", "color": (0.3, 0.4, 0.6),
                         "ibl": True, "ibl_samples": 2})
    return b
