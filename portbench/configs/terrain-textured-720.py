"""Configuration `terrain-textured-720`: the 203,522-triangle textured
terrain of BASELINE.json configs[2], path traced at 720x720.

A displaced 320x320 grid over [0, 4]^2 (203,522 triangles), its diffuse
colour a 64x64 image texture (16 diagonal bands) through a
`texture_mapper` node on uv (x/4, y/4), under a sun and a constant sky
background with image-based lighting (2 samples), seen by a 55-degree
camera at 720x720. `pathtracing` with 2 bounces, 6 samples a pixel an
image: as the JAX bench ran config 3 (its `bigmesh_builder(320)`). The
accelerator is the mix's choice (`scene_accelerator` in its render
params): the block accelerator by default, the LBVH that config 3 names by
"bvh".

The staging is frozen here, not imported from the program's `scenes`.
"""

CONFIG = {
    "source": ("BASELINE.json configs[2] (~200k tris, LBVH, textured, env "
               "background); bench.py:396-404 (bigmesh_builder res 320, 2 "
               "bounces, 6 spp)"),
    "width": 720,
    "height": 720,
    "spp": 6,
    "camera": "cam",
    "integrator": {"type": "pathtracing", "bounces": 2},
    "render_params": {},
    "grid": 320,
    "reduced": [],
    "assumed": {
        "background": "a constant sky of (0.3, 0.4, 0.6) with ibl stands "
                      "for config 3's env map, as in the JAX bench",
        "texture": "64x64 bands of 16 levels, as in the JAX bench",
    },
}


def terrain_height(x, y):
    """Height of the terrain surface at (x, y)."""
    import numpy as np
    return (0.35 * np.sin(x * 2.3) * np.cos(y * 1.7)
            + 0.12 * np.sin(x * 9.1 + 1.0) * np.sin(y * 8.3)
            + 0.04 * np.sin(x * 31.0) * np.cos(y * 29.0))


def stage(b, width=CONFIG["width"], height=CONFIG["height"],
          grid=CONFIG["grid"]):
    """Stage the scene on builder `b`: the camera at width x height, the
    terrain a grid of grid x grid vertices (2 (grid-1)^2 triangles)."""
    import numpy as np
    tex = (np.indices((64, 64)).sum(0) % 16 / 15.0).astype(np.float32)
    b.create_texture("checker", {"type": "image"}, image=np.stack(
        [tex, 0.8 * tex + 0.1, 1.0 - tex], -1))
    b.create_material(
        "ground",
        {"type": "shinydiffusemat", "color": (0.6, 0.55, 0.5),
         "diffuse_shader": "diff"},
        node_list=[{"name": "diff", "type": "texture_mapper",
                    "texture": "checker", "texco": "uv"}])
    b.create_object("terrain")
    b.set_current_material("ground")
    xs = np.linspace(0.0, 4.0, grid, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs, indexing="ij")
    zz = terrain_height(xx, yy).astype(np.float32)
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    i = np.arange(grid * grid).reshape(grid, grid)
    a = i[:-1, :-1].ravel()
    b2 = i[1:, :-1].ravel()
    c = i[1:, 1:].ravel()
    d2 = i[:-1, 1:].ravel()
    faces = np.concatenate([np.stack([a, b2, c], -1),
                            np.stack([a, c, d2], -1)]).astype(np.int32)
    uvs = np.stack([xx / 4.0, yy / 4.0], axis=-1).reshape(-1, 2)
    b.add_mesh_arrays(verts, faces, uvs=uvs.astype(np.float32),
                      face_uvs=faces)
    b.create_light("sun", {"type": "sunlight", "direction": (0.3, 0.3, 0.8),
                           "color": (1.0, 1.0, 0.95), "power": 1.0})
    b.create_camera("cam", {"type": "perspective", "from": (2.0, -2.5, 2.2),
                            "to": (2.0, 2.0, 0.0), "up": (2.0, -2.5, 3.2),
                            "resx": width, "resy": height, "fov": 55.0})
    b.create_background({"type": "constant", "color": (0.3, 0.4, 0.6),
                         "ibl": True, "ibl_samples": 2})
    return b
