"""Built-in scenes, made with the port's own SceneBuilder: the Cornell box,
its glossy variants (BASELINE config 2, and the scene of the glossy-exponent
gradient), the terrain of BASELINE config 3, the glass caustic scene of
config 4 and the scattering volume of config 5 (copies of `tests/scenes.py`
and `tests/test_gradients.py`), the forest (the terrain under 2,000
instanced rocks, some of them moving) and the scenes of the libYafaRay goldens
in `tests/golden/` (`tools/refparity/*.c`; `tests/test_refparity.py`): the
instanced cubes, the Cornell box under the four other camera types, the
empty sky under sunsky and darksky, and the glossy sphere on a textured
floor; the larger scenes built on them: the terrain under an analytic
sky, and the glossy scene lit by an environment map, with a curve; and the
Cornell box with every material and light type (`materials_cornell_builder`)
and a room lit through a background portal (`portal_room_builder`); the
Cornell box with every procedural texture type (`procedural_cornell_builder`)
and config 5's room with each other volume region type
(`volume_regions_builder`). These four take the builder to fill, so that
the JAX package's SceneBuilder can stage the same scene. `capi_test00`
stages the scene of the C client `native/tests/test00_client.c` as the C
API library hands it to the builder."""
from __future__ import annotations

import numpy as np

from .scene import SceneBuilder


def cornell_builder(white_emit: float = 12.0, extras=(),
                    builder=None, light_kind: str = "area") -> SceneBuilder:
    """Cornell box in [0,1]^3 (camera looks +y, z up): floor, ceiling and
    back wall white, left wall red, right wall green, two rotated boxes and
    a ceiling area light (34 triangles, plus the light's 2-triangle quad),
    or with light_kind "point" a point light of a twelfth of the power
    under the ceiling. `extras` are further (name, params) materials,
    created after the three of the walls; `builder` is the SceneBuilder to
    fill (the port's by default)."""
    b = SceneBuilder() if builder is None else builder
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

    if light_kind == "area":
        b.create_light("lamp", {
            "type": "arealight",
            # emitting normal is cross(e1, e2): this ordering points it down
            "corner": (0.35, 0.35, 0.999), "point1": (0.35, 0.65, 0.999),
            "point2": (0.65, 0.35, 0.999),
            "color": (1.0, 0.9, 0.8), "power": white_emit, "samples": 1})
    else:
        b.create_light("lamp", {"type": "pointlight", "from": (0.5, 0.5, 0.9),
                                "color": (1.0, 0.9, 0.8),
                                "power": white_emit / 12.0})
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


def volume_emissive_builder(builder=None) -> SceneBuilder:
    """BASELINE config 5: the Cornell box (lamp power 6) filled with a
    homogeneous scattering medium (a UniformVolume over [0,1]^3, sigma_s
    0.25, sigma_a 0.05, isotropic), and a glowing triangle: a light_mat
    face that a mesh light samples (37 triangles in all). `builder` is the
    SceneBuilder to fill (the port's by default)."""
    b = cornell_builder(white_emit=6.0, builder=builder)
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


# the cameras of the libYafaRay camera goldens
# tests/golden/cornell_{ortho,equi,angular,archi}_128.hdr
# (tools/refparity/cornell_ref.c; tests/test_refparity.py)
GOLDEN_CAMERAS = {
    "orthographic": {"from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                     "up": (0.5, -1.35, 1.5), "scale": 1.4},
    "equirectangular": {"from": (0.5, 0.5, 0.5), "to": (0.5, 1.5, 0.5),
                        "up": (0.5, 0.5, 1.5)},
    "angular": {"from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                "up": (0.5, -1.35, 1.5), "angle": 90.0, "max_angle": 90.0},
    # tilted up: the vertical-line-preserving projection differs from
    # the perspective one here
    "architect": {"from": (0.5, -1.35, 0.2), "to": (0.5, 0.5, 0.8),
                  "up": (0.5, -1.6, 1.1), "fov": 39.0},
}
GOLDEN_CAMERA_FILES = {"orthographic": "cornell_ortho_128.hdr",
                       "equirectangular": "cornell_equi_128.hdr",
                       "angular": "cornell_angular_128.hdr",
                       "architect": "cornell_archi_128.hdr"}


def camera_golden_builder(kind: str, res: int = 128) -> SceneBuilder:
    """The Cornell box of the camera goldens: the lamp invisible to camera
    rays with one light sample (the reference's area lights are never
    scene primitives), seen by a res x res camera of type `kind`
    (GOLDEN_CAMERAS)."""
    b = cornell_builder()
    b.lights["lamp"]["visibility"] = "invisible"
    b.lights["lamp"]["samples"] = 1
    b.create_camera("cam", dict(GOLDEN_CAMERAS[kind], type=kind, resx=res,
                                resy=res))
    return b


def sky_builder(kind: str, res: int = 128) -> SceneBuilder:
    """The empty sky of the sky goldens tests/golden/sky_{sunsky,darksky}_
    128.hdr (tools/refparity/sky_ref.c): a sunsky or darksky background
    (sun toward (0.4, 0.3, 0.6), turbidity 3) seen through an
    equirectangular camera, with one far-away triangle below the horizon
    (a scene needs geometry)."""
    b = SceneBuilder()
    b.create_material("m", {"type": "shinydiffusemat",
                            "color": (0.5, 0.5, 0.5)})
    b.create_object("dummy")
    b.set_current_material("m")
    a0 = b.add_vertex(500, 500, -500)
    a1 = b.add_vertex(501, 500, -500)
    a2 = b.add_vertex(500, 501, -500)
    b.add_triangle(a0, a1, a2)
    bgp = {"type": kind, "from": (0.4, 0.3, 0.6), "turbidity": 3.0,
           "power": 1.0, "add_sun": False, "background_light": False}
    if kind == "darksky":
        bgp.update({"altitude": 0.0, "night": False, "exposure": 1.0})
    b.create_background(bgp)
    b.create_camera("cam", {"type": "equirectangular", "resx": res,
                            "resy": res, "from": (0, 0, 0), "to": (0, 1, 0),
                            "up": (0, 0, 1)})
    return b


def sky_terrain_builder(kind: str, res: int = 320) -> SceneBuilder:
    """The textured terrain of `bigmesh_builder(res)` under an analytic
    sky in place of its sun and constant background: a "sunsky" (turbidity
    3) whose add_sun makes the sun light, or a "darksky" at altitude 0 with
    add_sun; either lights the scene with ibl (2 samples, as the constant
    background did), with the sun toward (0.3, 0.3, 0.8)."""
    b = bigmesh_builder(res)
    del b.lights["sun"]
    b.light_order.remove("sun")
    bgp = {"type": kind, "from": (0.3, 0.3, 0.8), "turbidity": 3.0,
           "add_sun": True, "sun_power": 1.0, "ibl": True, "ibl_samples": 2}
    if kind == "darksky":
        bgp.update({"altitude": 0.0, "exposure": 1.0})
    b.create_background(bgp)
    return b


def glossy_golden_builder(res: int = 128) -> SceneBuilder:
    """The scene of tests/golden/glossy_ref_128.hdr
    (tools/refparity/glossy_ref.c): a uv-textured floor (a 64x64 image
    through a texture_mapper node), a white back wall, an analytic glossy
    sphere (radius 0.25, exponent 25, as_diffuse off) and an overhead area
    light invisible to camera rays, seen by a res x res camera."""
    b = SceneBuilder()
    i = np.arange(64)[None, :]
    j = np.arange(64)[:, None]
    img = np.zeros((64, 64, 3), np.float32)
    img[..., 0] = 0.25 + 0.25 * (1 + np.sin(0.35 * i))
    img[..., 1] = 0.25 + 0.25 * (1 + np.sin(0.35 * j))
    img[..., 2] = 0.5
    b.create_texture("TexFloor", {"type": "image"}, image=img)
    b.create_material("floor", {"type": "shinydiffusemat", "color": (1, 1, 1),
                                "diffuse_shader": "map0"},
                      node_list=[{"type": "texture_mapper", "name": "map0",
                                  "texture": "TexFloor", "texco": "uv"}])
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.73, 0.73, 0.73)})
    b.create_material("gloss", {"type": "glossy", "color": (0.8, 0.8, 0.8),
                                "diffuse_color": (0.3, 0.25, 0.2),
                                "glossy_reflect": 0.7, "diffuse_reflect": 1.0,
                                "exponent": 25.0, "as_diffuse": False})
    b.create_object("floorobj")
    b.set_current_material("floor")
    a = [b.add_vertex(*p) for p in ((0, 0, 0), (1, 0, 0), (1, 1, 0),
                                    (0, 1, 0))]
    u = [b.add_uv(*q) for q in ((0, 0), (1, 0), (1, 1), (0, 1))]
    b.add_triangle(a[0], a[1], a[2], (u[0], u[1], u[2]))
    b.add_triangle(a[0], a[2], a[3], (u[0], u[2], u[3]))
    b.create_object("back")
    b.set_current_material("white")
    c = [b.add_vertex(*p) for p in ((0, 1, 0), (1, 1, 0), (1, 1, 1),
                                    (0, 1, 1))]
    b.add_quad(*c)
    b.create_object("ball", {"type": "sphere", "center": (0.5, 0.5, 0.3),
                             "radius": 0.25})
    b.set_current_material("gloss")
    b.create_light("lamp", {"type": "arealight", "corner": (0.3, 0.3, 1.2),
                            "point1": (0.3, 0.7, 1.2),
                            "point2": (0.7, 0.3, 1.2),
                            "color": (1.0, 0.95, 0.9), "power": 6.0,
                            "samples": 4, "visibility": "invisible"})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    b.create_camera("cam", {"type": "perspective", "from": (0.5, -0.9, 0.55),
                            "to": (0.5, 0.5, 0.3), "up": (0.5, -0.9, 1.55),
                            "resx": res, "resy": res, "fov": 50.0})
    return b


def env_map(width: int = 1024, height: int = 512,
            sun_deg: float = 3.0) -> np.ndarray:
    """An equirectangular HDR sky, f32[height, width, 3]: a smooth gradient
    from a blue zenith to a pale horizon and a dim ground, and a small sun
    disc (sun_deg across) 1,000 times brighter than the sky, 45 degrees up,
    so that importance sampling matters."""
    v = (np.arange(height, dtype=np.float32) + 0.5) / height   # 0: zenith
    u = (np.arange(width, dtype=np.float32) + 0.5) / width
    theta = v * np.pi
    up = np.cos(theta)[:, None, None]
    sky = np.where(up > 0,
                   np.array([0.35, 0.5, 0.9], np.float32) * up
                   + np.array([0.9, 0.9, 0.85], np.float32) * (1 - up),
                   np.array([0.25, 0.22, 0.2], np.float32))
    img = np.broadcast_to(sky, (height, width, 3)).copy()
    # the sun: phi and theta of the disc centre (u = 0.6, 45 degrees up)
    phi = (u - 0.5) * 2.0 * np.pi
    d = np.stack([np.sin(theta)[:, None] * np.cos(phi)[None, :],
                  np.sin(theta)[:, None] * np.sin(phi)[None, :],
                  np.broadcast_to(np.cos(theta)[:, None], (height, width))],
                 -1)
    sun_phi, sun_theta = (0.6 - 0.5) * 2.0 * np.pi, np.pi / 4
    sun = np.array([np.sin(sun_theta) * np.cos(sun_phi),
                    np.sin(sun_theta) * np.sin(sun_phi), np.cos(sun_theta)])
    disc = (d @ sun) > np.cos(np.radians(0.5 * sun_deg))
    img[disc] = 1000.0 * np.array([0.9, 0.9, 0.85], np.float32)
    return img.astype(np.float32)


def env_glossy_builder(res: int = 128, width: int = 1024,
                       height: int = 512) -> SceneBuilder:
    """The glossy golden scene lit by an environment map instead of its
    area light: a texture background (`env_map(width, height)`, sphere
    mapping) with ibl, 16 samples; and one curve object: a strand of 24
    control points winding up from the floor beside the sphere, extruded
    into a ribbon 0.02 wide at its root and 0.005 at its tip."""
    b = glossy_golden_builder(res)
    del b.lights["lamp"]
    b.light_order.remove("lamp")
    b.create_texture("env", {"type": "image"}, image=env_map(width, height))
    b.create_background({"type": "textureback", "texture": "env",
                         "ibl": True, "ibl_samples": 16, "power": 1.0})
    b.create_material("hair", {"type": "shinydiffusemat",
                               "color": (0.6, 0.35, 0.15)})
    b.create_object("strand", {"type": "curve", "strand_start": 0.02,
                               "strand_end": 0.005})
    b.set_current_material("hair")
    for j in range(24):
        t = j / 23.0
        b.add_vertex(0.18 + 0.04 * np.cos(9.0 * t),
                     0.35 + 0.04 * np.sin(9.0 * t), 0.5 * t)
    return b


# An IESNA LM-63 profile (Type C, bilateral: horizontal planes 0, 90 and
# 180 degrees): a downlight whose beam narrows from the 0-degree plane to
# the 180-degree plane
IES_PROFILE = """IESNA:LM-63-1995
[TEST] downlight with a bilateral beam
TILT=NONE
1 1000.0 1.0 5 3 1 2 0.3 0.3 0.3
1.0 1.0 0.0
0.0 30.0 60.0 90.0 180.0
0.0 90.0 180.0
1000.0 900.0 500.0 100.0 0.0
1000.0 700.0 250.0 50.0 0.0
1000.0 400.0 80.0 10.0 0.0
"""

# the integrator of the materials Cornell box: 4 bounces, transparent
# shadows at the default depth (shadowDepth 4)
MATERIALS_INTEGRATOR = {"type": "pathtracing", "bounces": 4,
                        "transpShad": True}


def materials_cornell_builder(resx: int = 1920, resy: int = 1080,
                              builder=None):
    """The Cornell box with every material and light type: the left wall
    Oren-Nayar (sigma 0.3), the back wall a mask_mat of white and green
    over a texture, the tall box coated glossy, the short box a blend_mat
    of a mirror and a shiny-diffuse by the same texture, a rough-glass box,
    a glass slab with dispersion_power 0.5 and Beer absorption, a glass
    cube with an sss interior, a shiny-diffuse quad with transparency 0.5
    under the lamp (it casts a transparent shadow with
    MATERIALS_INTEGRATOR) and a null quad; lit by the area lamp, a
    spotlight, an IES light (IES_PROFILE), a sphere light and a
    directional light through the open front. The glass boxes float clear
    of the floor (a face coplanar with another ties, and the tie breaks by
    the last bit of the refracted direction). The texture (floor_texture)
    reaches the blend and mask factors through texture_mapper nodes on
    global coordinates. `builder` is the SceneBuilder to fill (the port's
    by default)."""
    b = SceneBuilder() if builder is None else builder
    b.create_texture("pattern", {"type": "image"}, image=floor_texture())
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.73, 0.73, 0.73)})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.65, 0.05, 0.05),
                              "diffuse_brdf": "oren_nayar", "sigma": 0.3})
    b.create_material("green", {"type": "shinydiffusemat",
                                "color": (0.12, 0.45, 0.15)})
    b.create_material("mirror", {"type": "mirror",
                                 "color": (0.9, 0.9, 0.95)})
    b.create_material("blue", {"type": "shinydiffusemat",
                               "color": (0.2, 0.35, 0.8),
                               "specular_reflect": 0.2})
    pattern = {"type": "texture_mapper", "texture": "pattern",
               "texco": "global"}
    b.create_material("blend", {"type": "blend_mat", "material1": "mirror",
                                "material2": "blue", "blend_value": 0.5,
                                "blend_shader": "bf"},
                      node_list=[dict(pattern, name="bf")])
    b.create_material("mask", {"type": "mask_mat", "material1": "white",
                               "material2": "green", "threshold": 0.53,
                               "mask_shader": "mf"},
                      node_list=[dict(pattern, name="mf")])
    b.create_material("coated", {"type": "coated_glossy",
                                 "color": (0.9, 0.8, 0.6),
                                 "diffuse_color": (0.6, 0.3, 0.2),
                                 "IOR": 1.5, "exponent": 80.0,
                                 "glossy_reflect": 0.6})
    b.create_material("rough", {"type": "rough_glass", "IOR": 1.5,
                                "alpha": 0.2,
                                "filter_color": (0.9, 1.0, 0.9)})
    b.create_material("prism", {"type": "glass", "IOR": 1.5,
                                "dispersion_power": 0.5,
                                "absorption": (0.6, 0.8, 0.9),
                                "absorption_dist": 0.3})
    b.create_material("jade", {"type": "glass", "IOR": 1.3,
                               "volume_handler": "sss",
                               "absorption_dist": 0.2,
                               "scatter_col": (0.6, 0.9, 0.7)})
    b.create_material("veil", {"type": "shinydiffusemat",
                               "color": (0.9, 0.5, 0.2),
                               "transparency": 0.5})
    b.create_material("nothing", {"type": "null"})

    def quad(p0, p1, p2, p3):
        i = [b.add_vertex(*q) for q in (p0, p1, p2, p3)]
        b.add_quad(*i)

    b.create_object("walls")
    b.set_current_material("white")
    quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))          # floor
    quad((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1))          # ceiling
    b.set_current_material("mask")
    quad((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1))          # back
    b.set_current_material("red")
    quad((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))          # left
    b.set_current_material("green")
    quad((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))          # right
    for name, mat, origin, size, rot in (
            ("short", "blend", (0.55, 0.45, 0.0), (0.30, 0.30, 0.30), -0.30),
            ("tall", "coated", (0.15, 0.6, 0.0), (0.30, 0.30, 0.60), 0.35),
            ("rough", "rough", (0.62, 0.12, 0.01), (0.16, 0.16, 0.16), 0.5),
            ("prism", "prism", (0.1, 0.15, 0.01), (0.3, 0.08, 0.2), 0.2),
            ("jade", "jade", (0.66, 0.52, 0.3), (0.14, 0.14, 0.14), 0.7)):
        b.create_object(name)
        b.set_current_material(mat)
        _box(b, origin, size, rot=rot)
    b.create_object("veil")
    b.set_current_material("veil")
    quad((0.3, 0.2, 0.75), (0.6, 0.2, 0.75), (0.6, 0.5, 0.75),
         (0.3, 0.5, 0.75))
    b.create_object("nothing")
    b.set_current_material("nothing")
    quad((0.4, 0.05, 0.35), (0.6, 0.05, 0.35), (0.6, 0.05, 0.55),
         (0.4, 0.05, 0.55))

    b.create_light("lamp", {
        "type": "arealight", "corner": (0.35, 0.35, 0.999),
        "point1": (0.35, 0.65, 0.999), "point2": (0.65, 0.35, 0.999),
        "color": (1.0, 0.9, 0.8), "power": 8.0, "samples": 1})
    b.create_light("spot", {"type": "spotlight", "from": (0.85, 0.15, 0.95),
                            "to": (0.6, 0.55, 0.0), "color": (1.0, 0.8, 0.5),
                            "power": 1.5, "cone_angle": 25.0, "blend": 0.3,
                            "falloff": 2.0})
    b.create_light("ies", {"type": "ieslight", "from": (0.25, 0.75, 0.95),
                           "to": (0.25, 0.75, 0.0), "color": (0.7, 0.8, 1.0),
                           "power": 0.8, "ies_data": IES_PROFILE})
    b.create_light("bulb", {"type": "spherelight", "from": (0.8, 0.8, 0.8),
                            "radius": 0.05, "color": (1.0, 1.0, 0.9),
                            "power": 4.0, "samples": 1})
    b.create_light("sun", {"type": "directional",
                           "direction": (0.3, -1.0, 0.5),
                           "color": (1.0, 0.95, 0.85), "power": 0.6})
    b.create_camera("cam", {"type": "perspective",
                            "from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                            "up": (0.5, -1.35, 1.5),
                            "resx": resx, "resy": resy, "fov": 39.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    return b


def portal_room_builder(resx: int = 1920, resy: int = 1080, builder=None):
    """A closed room with one window in its +y wall, lit only through it:
    a bgPortalLight over the window lets in a constant background (the room
    of the JAX package's tests/test_lights.py, at resx x resy). `builder`
    is the SceneBuilder to fill (the port's by default)."""
    b = SceneBuilder() if builder is None else builder
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.7, 0.7, 0.7)})
    b.create_object("walls")
    b.set_current_material("white")

    def quad(p0, p1, p2, p3):
        i = [b.add_vertex(*q) for q in (p0, p1, p2, p3)]
        b.add_quad(*i)

    quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))           # floor
    quad((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1))           # ceiling
    quad((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))           # left
    quad((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))           # right
    # the +y wall around a window over x, z in [0.3, 0.7]
    quad((0, 1, 0), (1, 1, 0), (1, 1, 0.3), (0, 1, 0.3))
    quad((0, 1, 0.7), (1, 1, 0.7), (1, 1, 1), (0, 1, 1))
    quad((0, 1, 0.3), (0.3, 1, 0.3), (0.3, 1, 0.7), (0, 1, 0.7))
    quad((0.7, 1, 0.3), (1, 1, 0.3), (1, 1, 0.7), (0.7, 1, 0.7))
    # the portal: its normal points into the room (its emitting side)
    b.create_object("portal")
    b.set_current_material("white")
    quad((0.3, 1.0, 0.3), (0.7, 1.0, 0.3), (0.7, 1.0, 0.7), (0.3, 1.0, 0.7))
    b.create_light("portal", {"type": "bgPortalLight",
                              "object_name": "portal", "power": 1.0,
                              "samples": 4})
    b.create_background({"type": "constant", "color": (2.0, 1.6, 1.2)})
    b.create_camera("cam", {"type": "perspective",
                            "from": (0.5, 0.08, 0.5), "to": (0.5, 1.0, 0.45),
                            "up": (0.5, 0.08, 1.5),
                            "resx": resx, "resy": resy, "fov": 70.0})
    return b


# ------------------------------------------------------------------
# procedural textures, orco coordinates and the other volume regions

def _cube(b, origin, size, orco: bool = False) -> None:
    """An axis-aligned box (12 triangles) into the current object; with
    `orco` its vertices stream orco coordinates: the box's own corners in
    [-1, 1]^3."""
    ox, oy, oz = origin
    sx, sy, sz = size
    idx = []
    for k in range(8):
        c = (k & 1, (k >> 1) & 1, (k >> 2) & 1)
        p = (ox + c[0] * sx, oy + c[1] * sy, oz + c[2] * sz)
        if orco:
            idx.append(b.add_vertex_with_orco(*p, *(2.0 * x - 1.0
                                                    for x in c)))
        else:
            idx.append(b.add_vertex(*p))
    for q in ((0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3),
              (0, 4, 6, 2), (1, 3, 7, 5)):
        b.add_quad(*(idx[i] for i in q))


def procedural_cornell_builder(resx: int = 1920, resy: int = 1080,
                               builder=None):
    """The Cornell box with every procedural texture type on its surfaces,
    each through a texture_mapper node on the diffuse colour: the ceiling
    a blend (ease) mixed with a ridged musgrave, the back wall a radial
    blend through an HSV colour ramp, the left wall hard clouds, the right
    wall green with bump through soft clouds, the floor marble, the short
    box wood rings, the tall box wood bands with noise, a cube that streams
    orco coordinates under voronoi on texco "orco", a slab that streams
    none under an fBm musgrave on texco "orco" (its untransformed
    vertices), a pillar of distorted noise and a panel of rgb cube. The
    noise bases are newperlin, stdperlin and cellnoise, so the noise
    loops select among several per lane. `builder` is the SceneBuilder to
    fill (the port's by default)."""
    b = SceneBuilder() if builder is None else builder
    tex = {
        "ceil_blend": {"type": "blend", "stype": "ease",
                       "color1": (0.55, 0.55, 0.6), "color2": (0.9, 0.85,
                                                               0.8)},
        "back_blend": {"type": "blend", "stype": "radial",
                       "use_color_ramp": True, "ramp_color_mode": "hsv",
                       "ramp_items": [
                           {"position": 0.0, "color": (0.85, 0.8, 0.7, 1)},
                           {"position": 0.5, "color": (0.3, 0.45, 0.8, 1)},
                           {"position": 1.0, "color": (0.85, 0.8, 0.7, 1)}]},
        "left_clouds": {"type": "clouds", "size": 4.0, "depth": 2,
                        "hard": True, "noise_type": "newperlin",
                        "color1": (0.45, 0.03, 0.03),
                        "color2": (0.85, 0.2, 0.1)},
        "bump_clouds": {"type": "clouds", "size": 8.0, "depth": 1,
                        "noise_type": "stdperlin"},
        "floor_marble": {"type": "marble", "size": 3.0, "depth": 2,
                         "turbulence": 4.0, "sharpness": 1.5,
                         "noise_type": "stdperlin", "shape": "sin",
                         "color1": (0.35, 0.35, 0.4),
                         "color2": (0.85, 0.85, 0.8)},
        "wood_rings": {"type": "wood", "wood_type": "rings", "shape": "saw",
                       "size": 1.0, "depth": 1, "noise_type": "newperlin",
                       "color1": (0.4, 0.25, 0.1), "color2": (0.8, 0.55, 0.3)},
        "wood_band": {"type": "wood", "wood_type": "bandnoise",
                      "shape": "tri", "size": 6.0, "depth": 2,
                      "turbulence": 0.5, "noise_type": "cellnoise",
                      "color1": (0.5, 0.35, 0.2), "color2": (0.9, 0.7, 0.45)},
        "voronoi": {"type": "voronoi", "size": 1.5, "weight1": 1.0,
                    "weight2": -0.5, "intensity": 1.2,
                    "color1": (0.1, 0.3, 0.5), "color2": (0.8, 0.9, 1.0)},
        "musgrave_fbm": {"type": "musgrave", "musgrave_type": "fBm",
                         "size": 4.0, "H": 0.8, "octaves": 2.5,
                         "noise_type": "stdperlin",
                         "color1": (0.2, 0.4, 0.15),
                         "color2": (0.7, 0.85, 0.4)},
        "musgrave_ridged": {"type": "musgrave", "musgrave_type": "ridgedmf",
                            "size": 3.0, "H": 1.0, "octaves": 3.0,
                            "offset": 1.0, "gain": 2.0, "intensity": 0.8,
                            "noise_type": "newperlin"},
        "distorted": {"type": "distorted_noise", "size": 5.0,
                      "distort": 1.5, "noise_type1": "cellnoise",
                      "noise_type2": "newperlin",
                      "color1": (0.6, 0.2, 0.5), "color2": (0.95, 0.8, 0.4)},
        "rgb_cube": {"type": "rgb_cube"},
    }
    for name, pm in tex.items():
        b.create_texture(name, pm)

    def mapper(name, texture, texco="global", **kw):
        return dict({"name": name, "type": "texture_mapper",
                     "texture": texture, "texco": texco}, **kw)

    def textured(mat, texture, texco="global", **pm):
        b.create_material(mat, dict({"type": "shinydiffusemat",
                                     "diffuse_shader": "m"}, **pm),
                          node_list=[mapper("m", texture, texco)])

    # the ceiling first: material 0, which the lamp's quad also takes
    b.create_material("ceiling", {"type": "shinydiffusemat",
                                  "diffuse_shader": "mix"},
                      node_list=[mapper("a", "ceil_blend"),
                                 mapper("b", "musgrave_ridged"),
                                 {"name": "mix", "type": "mix",
                                  "input1": "a", "input2": "b",
                                  "value": 0.35}])
    textured("back", "back_blend")
    textured("left", "left_clouds")
    b.create_material("right", {"type": "shinydiffusemat",
                                "color": (0.12, 0.45, 0.15),
                                "bump_shader": "bump"},
                      node_list=[mapper("bump", "bump_clouds",
                                        bump_strength=0.02)])
    textured("floor", "floor_marble")
    textured("rings", "wood_rings")
    textured("bands", "wood_band")
    textured("cells", "voronoi", texco="orco")
    textured("moss", "musgrave_fbm", texco="orco")
    textured("warp", "distorted")
    textured("cube", "rgb_cube", specular_reflect=0.1)

    def quad(mat, p0, p1, p2, p3):
        b.set_current_material(mat)
        b.add_quad(*[b.add_vertex(*q) for q in (p0, p1, p2, p3)])

    b.create_object("walls")
    quad("floor", (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
    quad("ceiling", (0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1))
    quad("back", (0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1))
    quad("left", (0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))
    quad("right", (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))
    for name, mat, origin, size, rot in (
            ("short", "rings", (0.55, 0.45, 0.0), (0.30, 0.30, 0.30), -0.30),
            ("tall", "bands", (0.15, 0.6, 0.0), (0.30, 0.30, 0.60), 0.35)):
        b.create_object(name)
        b.set_current_material(mat)
        _box(b, origin, size, rot=rot)
    b.create_object("orco_cube")        # streams orco coordinates
    b.set_current_material("cells")
    _cube(b, (0.66, 0.1, 0.0), (0.18, 0.18, 0.18), orco=True)
    b.create_object("slab")             # texco orco, streams none
    b.set_current_material("moss")
    _cube(b, (0.08, 0.12, 0.0), (0.3, 0.14, 0.1))
    b.create_object("pillar")
    b.set_current_material("warp")
    _cube(b, (0.44, 0.2, 0.0), (0.1, 0.1, 0.4))
    b.create_object("panel")
    b.set_current_material("cube")
    quad("cube", (0.3, 0.985, 0.55), (0.7, 0.985, 0.55), (0.7, 0.985, 0.9),
         (0.3, 0.985, 0.9))

    b.create_light("lamp", {
        "type": "arealight", "corner": (0.35, 0.35, 0.999),
        "point1": (0.35, 0.65, 0.999), "point2": (0.65, 0.35, 0.999),
        "color": (1.0, 0.9, 0.8), "power": 12.0, "samples": 1})
    b.create_camera("cam", {"type": "perspective",
                            "from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                            "up": (0.5, -1.35, 1.5),
                            "resx": resx, "resy": resy, "fov": 39.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    return b


# volume_regions_builder's kinds and each one's region type
VOLUME_KINDS = {"exp": "ExpDensityVolume", "noise": "NoiseVolume",
                "grid": "GridVolume", "sky": "SkyVolume"}


def density_grid(res: int = 64, seed: int = 7) -> np.ndarray:
    """A smooth res^3 density grid [D, H, W] from a seed: twelve gaussian
    blobs of random centre, radius and weight, between 0 and about 2."""
    rng = np.random.default_rng(seed)
    c = (np.arange(res, dtype=np.float32) + 0.5) / res
    zz, yy, xx = np.meshgrid(c, c, c, indexing="ij")
    g = np.zeros((res, res, res), np.float32)
    for _ in range(12):
        cx, cy, cz = rng.uniform(0.15, 0.85, 3)
        r = rng.uniform(0.08, 0.22)
        w = rng.uniform(0.5, 1.5)
        g += w * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2 + (zz - cz) ** 2)
                        / (2 * r * r))
    return g.astype(np.float32)


def volume_regions_builder(kind: str, res: int = 512, builder=None,
                           emit: float = 0.0):
    """BASELINE config 5's room (the Cornell box with its glowing triangle
    and mesh light) at res x res with one region of `kind` over [0, 1]^3 in
    place of its uniform fog: "exp" a height fog (ExpDensityVolume, a 1.2,
    b 3), "noise" clouds through a NoiseVolume (a clouds texture, sharpness
    1, cover 0.8, density 2), "grid" a 64^3 GridVolume of blobs
    (`density_grid`), "sky" a SkyVolume; the region emits `emit` (its
    l_e) per unit density. `builder` is the SceneBuilder to fill (the
    port's by default)."""
    b = cornell_builder(white_emit=6.0, builder=builder)
    b.create_material("emit", {"type": "light_mat", "color": (1.0, 0.7, 0.4),
                               "power": 4.0})
    b.create_object("glow")
    b.set_current_material("emit")
    b.add_triangle(b.add_vertex(0.4, 0.5, 0.35), b.add_vertex(0.6, 0.5, 0.35),
                   b.add_vertex(0.5, 0.5, 0.55))
    b.create_light("glowl", {"type": "meshlight", "object_name": "glow",
                             "color": (1.0, 0.7, 0.4), "power": 4.0,
                             "samples": 1})
    pm = {"type": VOLUME_KINDS[kind], "sigma_s": 0.3, "sigma_a": 0.05,
          "g": 0.2, "l_e": emit, "minX": 0.0, "maxX": 1.0, "minY": 0.0,
          "maxY": 1.0, "minZ": 0.0, "maxZ": 1.0}
    if kind == "exp":
        pm.update(a=1.2, b=3.0)
    elif kind == "noise":
        b.create_texture("fog_clouds", {"type": "clouds", "size": 3.0,
                                        "depth": 2})
        pm.update(texture="fog_clouds", sharpness=1.0, cover=0.8,
                  density=2.0)
    elif kind == "grid":
        pm.update(grid_data=density_grid())
    else:
        pm.update(sigma_s=0.15, sigma_a=0.02)
    b.create_volume_region("fog", pm)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
    return b


def capi_test00(device=None):
    """The scene and render params of the C client test00_client.c, staged
    as the C API library replays them into a SceneBuilder (typed params as
    the client sets them, each object's geometry in one add_mesh_arrays
    call with its per-face materials). Returns (builder, render_params);
    `device` is staged as the "device" render param when given."""
    b = SceneBuilder()
    for name, col in (("white", (0.73, 0.73, 0.73, 1.0)),
                      ("red", (0.65, 0.05, 0.05, 1.0)),
                      ("green", (0.12, 0.45, 0.15, 1.0))):
        b.create_material(name, {"type": "shinydiffusemat", "color": col})
    b.create_light("lamp", {
        "type": "arealight", "corner": (0.35, 0.35, 0.999),
        "point1": (0.35, 0.65, 0.999), "point2": (0.65, 0.35, 0.999),
        "color": (1.0, 0.9, 0.8, 1.0), "power": 12.0})
    b.create_camera("cam", {
        "type": "perspective", "from": (0.5, -1.35, 0.5),
        "to": (0.5, 0.5, 0.5), "up": (0.5, -1.35, 1.5), "resx": 32,
        "resy": 32, "fov": 39.0})
    b.create_background({"type": "constant", "color": (0.0, 0.0, 0.0, 1.0)})
    quads = ((0, ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))),   # floor
             (0, ((0, 0, 1), (0, 1, 1), (1, 1, 1), (1, 0, 1))),   # ceiling
             (0, ((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1))),   # back
             (1, ((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1))),   # left
             (2, ((1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))))   # right
    verts = np.asarray([p for _, q in quads for p in q], np.float32)
    faces = np.asarray([(4 * i + a, 4 * i + b_, 4 * i + c)
                        for i in range(len(quads))
                        for a, b_, c in ((0, 1, 2), (0, 2, 3))], np.int32)
    b.create_object("walls", {})
    b.add_mesh_arrays(verts, faces, None, np.full(faces.shape, -1, np.int32),
                      None, np.repeat([m for m, _ in quads], 2).astype(
                          np.int32), None)
    params = {"integrator_type": "pathtracing", "integrator_bounces": 3,
              "AA_minsamples": 4}
    if device is not None:
        params["device"] = device
    b.set_render_params(params)
    return b, params
