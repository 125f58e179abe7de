"""The scene as the reference sees it: a configuration's `stage` run on a
recorder of its own, then laid out as plain tensors.

The recorder takes the staging calls a configuration makes (materials,
objects, vertices, quads and mesh arrays, lights, the camera, the
background, image textures) and keeps them as they are said. `build`
turns them into what the path tracer reads:

  - triangles: a quad (a, b, c, d) is the triangles (a, b, c) and
    (a, c, d); each triangle has its corners, its material, its texture
    coordinates (when the object gives them) and two flags, seen by the
    camera and bounce rays, and casting shadows;
  - an area light is the parallelogram corner + s e1 + t e2 (s, t in
    [0, 1]) that emits `color * power` from the side of e1 x e2; it is
    also two triangles, (c, c+e1, c+e1+e2) and (c, c+e1+e2, c+e2), that
    rays can hit and that cast no shadow;
  - a sun: radiance `color * power / omega` over a cone of half-angle
    `angle` (0.27 degrees unless given; omega the cone's solid angle)
    around `direction`;
  - a constant background: `color * power` in every direction; with
    `ibl` it is also a light, sampled uniformly over the sphere;
  - materials: the shiny-diffuse material with no mirror, transparency,
    translucency or emission is a Lambert surface of albedo
    `diffuse_reflect * color` (f = diffuse_reflect / pi * color); a `texture_mapper` node on "uv" as its
    `diffuse_shader` replaces the colour by an image texture read at the
    hit's uv (bilinear, repeated, rows top down);
  - the perspective camera at `from`, looking at `to`, with `up`, `fov`
    over the image's width.

It reads nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

Tensor = torch.Tensor


class Stage:
    """Records a configuration's staging calls."""

    def __init__(self):
        self.materials = {}          # name -> (params, node list)
        self.material_order = []
        self.objects = []            # [{"vertices", "faces", "uvs"}]
        self.current_material = None
        self.lights = []             # [(name, params)]
        self.camera = {}
        self.background = {}
        self.textures = {}           # name -> (params, image)
        self.render_params = {}

    def create_material(self, name, params, node_list=None):
        if name not in self.materials:
            self.material_order.append(name)
        self.materials[name] = (dict(params), list(node_list or []))
        return self.material_order.index(name)

    def create_texture(self, name, params, image=None):
        self.textures[name] = (dict(params), image)

    def create_object(self, name, params=None):
        self.objects.append({"name": name, "vertices": [], "faces": [],
                             "uvs": None})

    def set_current_material(self, name):
        self.current_material = name

    def add_vertex(self, x, y, z):
        obj = self.objects[-1]
        obj["vertices"].append((x, y, z))
        return len(obj["vertices"]) - 1

    def add_triangle(self, a, b, c):
        self.objects[-1]["faces"].append(
            ((a, b, c), None, self.current_material))

    def add_quad(self, a, b, c, d):
        self.add_triangle(a, b, c)
        self.add_triangle(a, c, d)

    def add_mesh_arrays(self, vertices, faces, uvs=None, face_uvs=None):
        obj = self.objects[-1]
        base = len(obj["vertices"])
        obj["vertices"].extend(map(tuple, np.asarray(vertices).reshape(-1, 3)))
        faces = np.asarray(faces).reshape(-1, 3)
        if uvs is not None:
            obj["uvs"] = np.asarray(uvs, np.float32).reshape(-1, 2)
            face_uvs = np.asarray(face_uvs).reshape(-1, 3)
        for i, f in enumerate(faces):
            obj["faces"].append((tuple(int(k) + base for k in f),
                                 None if uvs is None else
                                 tuple(int(k) for k in face_uvs[i]),
                                 self.current_material))

    def create_light(self, name, params):
        self.lights.append((name, dict(params)))

    def create_camera(self, name, params):
        self.camera = dict(params)

    def create_background(self, params):
        self.background = dict(params)

    def set_render_params(self, params):
        self.render_params.update(params)


@dataclasses.dataclass
class Scene:
    """The staged scene as tensors (one device)."""
    tri: Tensor          # f32[F, 3, 3] corners
    tri_mat: Tensor      # i64[F] material row (-1 on an area light's)
    tri_light: Tensor    # i64[F] area light row, or -1
    tri_uv: Tensor       # f32[F, 3, 2] texture coordinates (0 without)
    tri_shadow: Tensor   # bool[F] casts shadows
    colour: Tensor       # f32[M, 3] each material's diffuse colour
    reflect: Tensor      # f32[M] and its diffuse_reflect
    textured: Tensor     # bool[M] its colour comes from `texture`
    texture: Optional[Tensor]   # f32[H, W, 3] the image texture
    lights: list         # [dict] in the order they are sampled
    background: Tensor   # f32[3] radiance of the background
    bg_light: bool       # the background lights the scene
    cam_origin: Tensor   # f32[3]
    cam_x: Tensor        # f32[3] right
    cam_y: Tensor        # f32[3] up
    cam_z: Tensor        # f32[3] forward
    focal: float         # the image-plane distance, width 1
    aspect: float        # height / width
    width: int
    height: int
    shadow_bias: float
    min_dist: float


def _f32(x):
    return np.asarray(x, np.float32)


def _frame(pos, look, up):
    """The camera's right, up and forward axes (float32, as staged)."""
    pos, look, up = _f32(pos), _f32(look), _f32(up)
    fwd = look - pos
    fwd = fwd / max(np.linalg.norm(fwd), 1e-20)
    right = np.cross(fwd, up - pos)
    right = right / max(np.linalg.norm(right), 1e-20)
    upn = np.cross(right, fwd)
    upn = upn / max(np.linalg.norm(upn), 1e-20)
    return _f32(right), _f32(upn), _f32(fwd)


def build(stage: Stage, device) -> Scene:
    """The recorded scene as tensors on `device`."""
    mats = stage.material_order
    colour, reflect, textured, texture = [], [], [], None
    for name in mats:
        pm, nodes = stage.materials[name]
        if pm.get("type") != "shinydiffusemat":
            raise NotImplementedError(f"material type {pm.get('type')!r}")
        for key in ("specular_reflect", "transparency", "translucency",
                    "emit"):
            if float(pm.get(key, 0.0)) != 0.0:
                raise NotImplementedError(f"shinydiffusemat {key}")
        colour.append(_f32(pm.get("color", (0.8, 0.8, 0.8)))[:3])
        reflect.append(float(pm.get("diffuse_reflect", 1.0)))
        if not reflect[-1] > 0.0:
            raise NotImplementedError("shinydiffusemat diffuse_reflect 0")
        shader = pm.get("diffuse_shader")
        node = next((n for n in nodes if n.get("name") == shader), None)
        textured.append(node is not None)
        if node is not None:
            if node.get("type") != "texture_mapper" or node.get(
                    "texco", "uv") != "uv":
                raise NotImplementedError(f"diffuse shader {node}")
            tp, img = stage.textures[node["texture"]]
            if tp.get("type") != "image" or tp.get("interpolate", "bilinear") \
                    != "bilinear":
                raise NotImplementedError(f"texture {tp}")
            texture = _f32(img)[..., :3]

    tris, tmat, tlight, tuv, tshadow = [], [], [], [], []
    for obj in stage.objects:
        v = _f32(obj["vertices"])
        for corners, uvi, mat in obj["faces"]:
            tris.append(v[list(corners)])
            tmat.append(mats.index(mat))
            tlight.append(-1)
            tuv.append(np.zeros((3, 2)) if uvi is None
                       else obj["uvs"][list(uvi)])
            tshadow.append(True)

    lights = []
    for _, pm in stage.lights:
        ty = pm["type"]
        col = _f32(pm.get("color", (1, 1, 1)))[:3]
        power = float(pm.get("power", 1.0))
        if ty == "arealight":
            c = _f32(pm["corner"])
            e1 = _f32(pm["point1"]) - c
            e2 = _f32(pm["point2"]) - c
            nrm = np.cross(e1, e2)
            area = float(np.linalg.norm(nrm))
            row = len(lights)
            lights.append(dict(kind="area", corner=c, e1=e1, e2=e2,
                               normal=_f32(nrm / max(area, 1e-12)),
                               area=area, radiance=_f32(col * power)))
            for q in ((c, c + e1, c + e1 + e2), (c, c + e1 + e2, c + e2)):
                tris.append(_f32(q))
                tmat.append(-1)
                tlight.append(row)
                tuv.append(np.zeros((3, 2)))
                tshadow.append(False)
        elif ty == "sunlight":
            d = _f32(pm.get("direction", (0, 0, 1)))
            d = d / max(np.linalg.norm(d), 1e-12)
            cos_max = math.cos(float(pm.get("angle", 0.27)) * math.pi / 180)
            omega = 2 * math.pi * (1 - cos_max)
            lights.append(dict(kind="sun", toward=_f32(d),
                               cos_max=np.float32(cos_max),
                               radiance=_f32(col * power / omega)))
        else:
            raise NotImplementedError(f"light type {ty!r}")
    bg = stage.background
    if bg.get("type", "constant") != "constant":
        raise NotImplementedError(f"background {bg}")
    background = _f32(bg.get("color", (1, 1, 1)))[:3] * np.float32(
        bg.get("power", 1.0))
    bg_light = bool(bg.get("ibl", False))
    if bg_light:
        lights.append(dict(kind="background"))

    cam = stage.camera
    if cam.get("type", "perspective") != "perspective" or float(
            cam.get("aperture", 0.0)) > 0.0:
        raise NotImplementedError(f"camera {cam}")
    right, up, fwd = _frame(cam["from"], cam["to"], cam["up"])
    width, height = int(cam["resx"]), int(cam["resy"])
    fov = float(cam.get("fov", 45.0)) * math.pi / 180.0
    t = lambda x, dt=torch.float32: torch.as_tensor(
        np.asarray(x), dtype=dt, device=device)
    for li in lights:
        for k, v in li.items():
            if isinstance(v, (np.ndarray, np.generic)):
                li[k] = t(v)
    rp = stage.render_params
    return Scene(
        tri=t(np.stack(tris)), tri_mat=t(tmat, torch.int64),
        tri_light=t(tlight, torch.int64), tri_uv=t(np.stack(tuv)),
tri_shadow=t(tshadow, torch.bool),
        colour=t(np.stack(colour)), reflect=t(reflect), textured=t(textured, torch.bool),
        texture=None if texture is None else t(texture),
        lights=lights, background=t(background), bg_light=bg_light,
        cam_origin=t(_f32(cam["from"])), cam_x=t(right), cam_y=t(up),
        cam_z=t(fwd), focal=float(np.float32(0.5 / math.tan(fov * 0.5))),
        aspect=float(np.float32(height / width)), width=width, height=height,
        shadow_bias=float(np.float32(rp.get("shadow_bias", 5e-4))),
        min_dist=float(np.float32(rp.get("ray_min_dist", 5e-5))))
