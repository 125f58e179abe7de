"""Configuration `cornell-1080p`: the Cornell box, the project's headline
scene, path traced at 1920x1080.

The scene is the project's headline (BASELINE.json's metric: rays a
second of forward + backward at 1080p, 16 samples a pixel) as the JAX
package's bench staged it (its `cornell_builder`): floor, ceiling and
back wall white, the left wall red, the right wall green, two rotated
boxes (34 triangles, all
`shinydiffusemat`) and a ceiling area light (its 2-triangle quad), seen by
a 39-degree perspective camera over a black background. `pathtracing`
with 4 bounces (NEE with MIS at every bounce, Russian roulette from the
third), 16 samples a pixel an image. 36 faces take the brute-force
accelerator, so kernel a (`csrc/mt_intersect.cu`) answers every query.

The staging is frozen here, not imported from the program's `scenes`, so
that no later change to the program moves the yardstick. `stage` fills any
builder with the program's staging API: the program's `SceneBuilder` for
the timed path, the reference's own recorder (`reference/scene.py`) for
the reference.
"""

CONFIG = {
    "source": ("BASELINE.json metric (rays/sec fwd+bwd at 1080p 16spp); "
               "bench.py:71-166 and tests/scenes.py:8-65 (cornell_builder: 4 "
               "bounces, shinydiffuse box, area light)"),
    "width": 1920,
    "height": 1080,
    "spp": 16,
    "camera": "cam",
    "integrator": {"type": "pathtracing", "bounces": 4},
    "render_params": {},
    "reduced": [],
    "assumed": {
        "spp": "16 samples a pixel an image, as the JAX bench's headline",
        "resolution": "1920x1080, the headline's; at 16:9 the lamp lies "
                      "above the field of view",
    },
}


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
    b.create_material("white", {"type": "shinydiffusemat",
                                "color": (0.73, 0.73, 0.73)})
    b.create_material("red", {"type": "shinydiffusemat",
                              "color": (0.65, 0.05, 0.05)})
    b.create_material("green", {"type": "shinydiffusemat",
                                "color": (0.12, 0.45, 0.15)})
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
    return b
