"""Built-in scenes, made with the port's own SceneBuilder: the Cornell box,
its glossy variants (BASELINE config 2, and the scene of the glossy-exponent
gradient), the terrain of BASELINE config 3, the glass caustic scene of
config 4 and the scattering volume of config 5 (copies of `tests/scenes.py`
and `tests/test_gradients.py`), the forest (the terrain under 2,000
instanced rocks, some of them moving) and the instanced cubes of the
libYafaRay golden `tests/golden/instances_ref_160.hdr` (the scene of
`tools/refparity/instances_ref.c`)."""
from __future__ import annotations

import numpy as np

from .scene import SceneBuilder


def cornell_builder(white_emit: float = 12.0, extras=()) -> SceneBuilder:
    """Cornell box in [0,1]^3 (camera looks +y, z up): floor, ceiling and
    back wall white, left wall red, right wall green, two rotated boxes and
    a ceiling area light. 34 triangles, plus the light's 2-triangle quad.
    `extras` are further (name, params) materials, created after the
    three of the walls."""
    b = SceneBuilder()
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.73, 0.73, 0.73)})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.65, 0.05, 0.05)})
    b.create_material("green", {"type": "shinydiffusemat",
                                "color": (0.12, 0.45, 0.15)})
    for name, pm in extras:
        b.create_material(name, pm)

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


def glossy_cornell_builder() -> SceneBuilder:
    """BASELINE config 2: the Cornell box with a glossy material (exponent
    120, glossy_reflect 0.8) beside the diffuse walls. As in the JAX
    package's scene, no face uses it: it compiles the glossy lobe into
    every BSDF evaluation of the render."""
    return cornell_builder(extras=[
        ("gloss", {"type": "glossy", "color": (0.7, 0.6, 0.3),
                   "glossy_reflect": 0.8, "exponent": 120.0})])


def glossy_slab_builder() -> SceneBuilder:
    """The Cornell box with a glossy slab (Blinn exponent 25,
    glossy_reflect 0.6, diffuse_reflect 0.3) in the middle of the floor:
    the scene of the JAX package's glossy-exponent gradient test."""
    b = cornell_builder(extras=[
        ("gl", {"type": "glossy", "exponent": 25.0, "glossy_reflect": 0.6,
                "diffuse_reflect": 0.3, "color": (0.7, 0.7, 0.7)})])
    b.create_object("slab")
    b.set_current_material("gl")
    _box(b, (0.35, 0.35, 0.2), (0.3, 0.2, 0.35))
    return b


def volume_emissive_builder() -> SceneBuilder:
    """BASELINE config 5: the Cornell box (lamp power 6) filled with a
    homogeneous scattering medium (a UniformVolume over [0,1]^3, sigma_s
    0.25, sigma_a 0.05, isotropic), and a glowing triangle: a light_mat
    face that a mesh light samples (37 triangles in all)."""
    b = cornell_builder(white_emit=6.0)
    b.create_material("emit", {"type": "light_mat", "color": (1.0, 0.7, 0.4),
                               "power": 4.0})
    b.create_object("glow")
    b.set_current_material("emit")
    i0 = b.add_vertex(0.4, 0.5, 0.35)
    i1 = b.add_vertex(0.6, 0.5, 0.35)
    i2 = b.add_vertex(0.5, 0.5, 0.55)
    b.add_triangle(i0, i1, i2)
    b.create_light("glowl", {"type": "meshlight", "object_name": "glow",
                             "color": (1.0, 0.7, 0.4), "power": 4.0,
                             "samples": 1})
    b.create_volume_region("fog", {"type": "UniformVolume", "sigma_s": 0.25,
                                   "sigma_a": 0.05, "g": 0.0,
                                   "minX": 0.0, "maxX": 1.0, "minY": 0.0,
                                   "maxY": 1.0, "minZ": 0.0, "maxZ": 1.0})
    return b


def floor_texture() -> np.ndarray:
    """The caustic scene's 32x32 RGB floor image: eight grey levels in
    diagonal stripes, mapped to three colour ramps."""
    tex = (np.indices((32, 32)).sum(0) % 8 / 7.0).astype(np.float32)
    return np.stack([0.2 + 0.6 * tex, 0.5 * tex + 0.2, 0.9 - 0.5 * tex], -1)


def caustic_grad_builder(resx: int = 512, resy: int = 512) -> SceneBuilder:
    """BASELINE config 4: the Cornell box with a glass box (IOR 1.5, filter
    colour 0.97) standing on an image-textured floor plane just above the
    floor: refraction and caustic paths, whose gradients bench.py takes
    with respect to the IOR and the floor texture's texels. 50 triangles
    with the lamp's quad."""
    b = cornell_builder(extras=[
        ("glass", {"type": "glass", "IOR": 1.5,
                   "filter_color": (0.97, 0.97, 0.97)})])
    b.create_texture("floor_tex", {"type": "image"}, image=floor_texture())
    b.create_material(
        "floor_mat",
        {"type": "shinydiffusemat", "color": (1, 1, 1),
         "diffuse_shader": "diff"},
        node_list=[{"name": "diff", "type": "texture_mapper",
                    "texture": "floor_tex", "texco": "uv"}])
    b.create_object("floor_plane")
    b.set_current_material("floor_mat")
    z = 0.002
    verts = np.asarray([[0, 0, z], [1, 0, z], [1, 1, z], [0, 1, z]],
                       np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    b.add_mesh_arrays(verts, faces, uvs=verts[:, :2].copy(), face_uvs=faces)
    b.create_object("glassbox")
    b.set_current_material("glass")
    _box(b, (0.35, 0.35, 0.15), (0.3, 0.25, 0.35))
    b.cameras["cam"]["resx"] = resx
    b.cameras["cam"]["resy"] = resy
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


def terrain_height(x, y):
    """Height of the terrain surface of `bigmesh_grid` at (x, y)."""
    return (0.35 * np.sin(x * 2.3) * np.cos(y * 1.7)
            + 0.12 * np.sin(x * 9.1 + 1.0) * np.sin(y * 8.3)
            + 0.04 * np.sin(x * 31.0) * np.cos(y * 29.0))


def bigmesh_grid(res: int):
    """The displaced terrain grid of `bigmesh_builder` as numpy arrays:
    (vertices f32[res*res, 3], faces i32[2*(res-1)^2, 3], xx, yy)."""
    xs = np.linspace(0.0, 4.0, res, dtype=np.float32)
    ys = np.linspace(0.0, 4.0, res, dtype=np.float32)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    zz = terrain_height(xx, yy).astype(np.float32)
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
    by a 720x720 camera. `textured=True` maps a 64x64 image texture on
    uv (x/4, y/4) through a texture_mapper node that overrides the diffuse
    colour; `textured=False` is the same scene with the plain diffuse
    material and no uvs."""
    b = SceneBuilder()
    if textured:
        # 64x64 diagonal bands of 16 levels
        tex = (np.indices((64, 64)).sum(0) % 16 / 15.0).astype(np.float32)
        b.create_texture("checker", {"type": "image"}, image=np.stack(
            [tex, 0.8 * tex + 0.1, 1.0 - tex], -1))
        b.create_material(
            "ground",
            {"type": "shinydiffusemat", "color": (0.6, 0.55, 0.5),
             "diffuse_shader": "diff"},
            node_list=[{"name": "diff", "type": "texture_mapper",
                        "texture": "checker", "texco": "uv"}])
    else:
        b.create_material("ground", {"type": "shinydiffusemat",
                                     "color": (0.6, 0.55, 0.5)})
    b.create_object("terrain")
    b.set_current_material("ground")
    verts, faces, xx, yy = bigmesh_grid(res)
    if textured:
        uvs = np.stack([xx / 4.0, yy / 4.0], axis=-1).reshape(-1, 2)
        b.add_mesh_arrays(verts, faces, uvs=uvs.astype(np.float32),
                          face_uvs=faces)
    else:
        b.add_mesh_arrays(verts, faces)
    b.create_light("sun", {"type": "sunlight", "direction": (0.3, 0.3, 0.8),
                           "color": (1.0, 1.0, 0.95), "power": 1.0})
    b.create_camera("cam", dict(TERRAIN_CAMERA))
    b.create_background({"type": "constant", "color": (0.3, 0.4, 0.6),
                         "ibl": True, "ibl_samples": 2})
    return b


def _rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0],
                     [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


def _rock(b: SceneBuilder) -> None:
    """The base rock: a radius-0.3 sphere fan of 8 x 6 quads, 96 triangles
    (the base blob of `tests/test_instancing.py`)."""
    nu, nv = 8, 6
    idx = np.zeros((nu + 1, nv + 1), np.int32)
    for iu in range(nu + 1):
        for iv in range(nv + 1):
            th = np.pi * iv / nv
            ph = 2 * np.pi * iu / nu
            idx[iu, iv] = b.add_vertex(0.3 * np.sin(th) * np.cos(ph),
                                       0.3 * np.sin(th) * np.sin(ph),
                                       0.3 * np.cos(th))
    for iu in range(nu):
        for iv in range(nv):
            a_, b_, c_, d_ = (idx[iu, iv], idx[iu + 1, iv],
                              idx[iu + 1, iv + 1], idx[iu, iv + 1])
            b.add_triangle(a_, b_, c_)
            b.add_triangle(a_, c_, d_)


def forest_builder(n_inst: int = 2000, n_moving: int = 16,
                   grid: int = 320) -> SceneBuilder:
    """The terrain of `bigmesh_builder(grid, textured=False)` under
    n_inst + n_moving instances of one is_base_object rock (96 triangles):
    rigid transforms with a z rotation, a uniform scale in [0.05, 0.15] and
    x, y uniform in [0.2, 3.8], set on the terrain surface, drawn from
    numpy.random.default_rng(5). The last n_moving instances carry a second
    matrix, 0.1 further along x at shutter close: they are baked into
    copies (as in the JAX compile), so the scene moves and every block gets
    a keyframe table, while the others stay true instances (grid=320: about
    397k virtual triangles over 205k physical ones)."""
    b = bigmesh_builder(grid, textured=False)
    b.create_material("rock", {"type": "shinydiffusemat",
                               "color": (0.45, 0.42, 0.4)})
    b.create_object("rock", {"is_base_object": True})
    b.set_current_material("rock")
    _rock(b)
    rng = np.random.default_rng(5)
    for k in range(n_inst + n_moving):
        x, y = rng.uniform(0.2, 3.8, 2)
        s = rng.uniform(0.05, 0.15)
        m = _rot_z(rng.uniform(0.0, 2.0 * np.pi))
        m[:3, :3] *= s
        m[0, 3], m[1, 3], m[2, 3] = x, y, terrain_height(x, y)
        if k < n_inst:
            b.add_instance("rock", m)
        else:
            m1 = m.copy()
            m1[0, 3] += 0.1
            b.add_instance("rock", [m, m1])
    return b


def instances_builder() -> SceneBuilder:
    """Five instances of an is_base_object cube, with distinct translation,
    scale and z rotation, over a floor under a point light (the scene of
    `tools/refparity/instances_ref.c`, rendered by libYafaRay into
    `tests/golden/instances_ref_160.hdr`; `tests/test_refparity.py`
    `_instances_builder`). Its 74 faces compile to copies and the
    brute-force path unless `instancing: "true"` and the block accelerator
    are asked for."""
    b = SceneBuilder()
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.7, 0.7, 0.7)})
    b.create_material("blue", {"type": "shinydiffusemat",
                               "color": (0.3, 0.4, 0.7)})
    b.create_object("floor")
    b.set_current_material("white")
    ids = [b.add_vertex(*p) for p in [(-4, -4, 0), (4, -4, 0),
                                      (4, 4, 0), (-4, 4, 0)]]
    b.add_quad(*ids)
    b.create_object("cube", {"is_base_object": True})
    b.set_current_material("blue")
    p = [b.add_vertex(0.5 if i & 1 else -0.5, 0.5 if i & 2 else -0.5,
                      0.5 if i & 4 else -0.5) for i in range(8)]
    for q in [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4),
              (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]:
        b.add_quad(*[p[i] for i in q])
    xs = [-2.0, -0.9, 0.3, 1.6, 0.1]
    ys = [-0.6, 0.9, -0.2, 0.6, 2.0]
    ss = [0.8, 1.2, 0.6, 1.0, 0.9]
    for k in range(5):
        s = ss[k]
        a = 0.5 * k
        c = np.cos(a) * s
        sn = np.sin(a) * s
        m = np.array([[c, -sn, 0, xs[k]], [sn, c, 0, ys[k]],
                      [0, 0, s, 0.5 * s], [0, 0, 0, 1]], np.float32)
        b.add_instance("cube", m)
    b.create_light("lamp", {"type": "pointlight", "from": (1.0, -1.5, 4.0),
                            "color": (1, 1, 1), "power": 20.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    b.create_camera("cam", {"type": "perspective", "from": (0.0, -5.5, 3.5),
                            "to": (0.0, 0.0, 0.4), "up": (0.0, -5.5, 4.5),
                            "resx": 160, "resy": 160, "fov": 50.0})
    return b
