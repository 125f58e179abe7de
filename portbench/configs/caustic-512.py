"""Configuration `caustic-512`: the Cornell box with a glass box over an
image-textured floor, differentiated with respect to the glass's IOR and
the floor texture's texels at 512x512.

The scene is BASELINE config 4 ("Dielectric/mirror materials with caustic
paths; gradient w.r.t. IOR and albedo textures") as the JAX package's
bench stages it (its `caustic_grad_builder`): the Cornell box of
`cornell-1080p` (floor, ceiling and back wall white, the left wall red,
the right wall green, two rotated boxes, all `shinydiffusemat`, and a
ceiling area light), a box of libYafaRay's `glass` (IOR 1.5, filter colour
0.97) hanging over the short box, and a floor plane 2 mm above the floor
whose diffuse colour is a 32x32 image texture through a `texture_mapper`
node on its uv coordinates: 50 triangles with the lamp's quad. `pathtracing`
with 5 bounces, one sample at each pixel's centre a step. 50 faces take
the brute-force accelerator, so kernel a (`csrc/mt_intersect.cu`) answers
every query.

The staging is frozen here, not imported from the program's `scenes`, so
that no later change to the program moves the yardstick. `stage` fills any
builder with the program's staging API: the program's `SceneBuilder` for
the timed path, the reference's own recorder (`reference/scene.py`) for
the reference.
"""

CONFIG = {
    "source": ("BASELINE.json configs[3]; bench.py:184-248; "
               "tests/scenes.py:167-196"),
    "width": 512,
    "height": 512,
    "spp": 1,
    "camera": "cam",
    "integrator": {"type": "pathtracing", "bounces": 5},
    "render_params": {},
    "reduced": [],
    "assumed": {
        "target": "the mix's target image, uniform in [0, 0.5] from the "
                  "seed (bench.py's loss is mean(rgb); a train step needs "
                  "a target)",
        "ior_start": "the glass's starting IOR, uniform in [1.4, 1.6] from "
                     "the seed, around the staged 1.5",
        "lr": "0.05, the cornell-1080p.train cell's SGD rate",
    },
}


def floor_texture():
    """The 32x32 RGB floor image: eight grey levels in diagonal stripes,
    mapped to three colour ramps."""
    import numpy as np
    tex = (np.indices((32, 32)).sum(0) % 8 / 7.0).astype(np.float32)
    return np.stack([0.2 + 0.6 * tex, 0.5 * tex + 0.2, 0.9 - 0.5 * tex], -1)


def _box(b, origin, size, rot=0.0):
    import numpy as np
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


def stage(b, width=CONFIG["width"], height=CONFIG["height"]):
    """Stage the scene on builder `b`, its camera at width x height."""
    import numpy as np
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.73, 0.73, 0.73)})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.65, 0.05, 0.05)})
    b.create_material("green", {"type": "shinydiffusemat",
                                "color": (0.12, 0.45, 0.15)})
    b.create_material("glass", {"type": "glass", "IOR": 1.5,
                                "filter_color": (0.97, 0.97, 0.97)})
    b.create_object("walls")

    def quad(mat, p0, p1, p2, p3):
        b.set_current_material(mat)
        i = [b.add_vertex(*p) for p in (p0, p1, p2, p3)]
        b.add_quad(*i)

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
        "color": (1.0, 0.9, 0.8), "power": 12.0, "samples": 1})
    b.create_camera("cam", {"type": "perspective",
                            "from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
                            "up": (0.5, -1.35, 1.5),
                            "resx": width, "resy": height, "fov": 39.0})
    b.create_background({"type": "constant", "color": (0, 0, 0)})
    # the textured floor plane and the glass box
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
    return b
