"""Host-side scene builder: named-entity registries and geometry streaming,
compiled to the torch tables of `scene_types.py`.

Counterpart of `libyafaray_tpu/scene.py` `SceneBuilder`: every material
type (shiny-diffuse, glossy and coated glossy with the Lambert or the
Oren-Nayar BRDF, glass with dispersion and the Beer or sss interior, rough
glass, mirror, null, `light_mat`, blend and mask), image and procedural
textures and the shader nodes that bind them to material channels (on any
texture coordinates, orco included), triangle meshes with motion-blur
keyframes and orco coordinates, instances (baked into copies, or true
instances over the block accelerator), analytic spheres, curves (strands
extruded into ribbons of triangles), every light type (point, IES, spot,
sun, directional, area lights baked into the geometry as two emissive
triangles, sphere, mesh, background portal and the background light),
every volume region type (uniform, exponential, noise, grid and sky),
every camera type (with depth of field) and the constant, gradient,
sunsky, darksky and texture backgrounds (with `ibl`, lighting the scene,
and `add_sun`), over the brute-force or the block accelerator. `compile()`
builds the same tables as the JAX compile, on the CUDA card unless the
caller names another device; `compile_view` compiles one render view
(its camera, its subset of the lights, its fixed wavelength). What the
port does not carry yet raises `NotImplementedError` naming the feature:
instances of spheres and curves, the `bvh` accelerator and the
brute-force path above 16,384 faces.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import params as P
from .accel.blocks import build_blocks
from .accel.mt_intersect import MAX_TRIS, pack_tris
from .backgrounds import make_background, sun_from_background
from .cameras import make_camera
from .lights import (FLAG_CAST_SHADOWS, FLAG_DOUBLE_SIDED, FLAG_ENABLED,
                     FLAG_PHOTON_ONLY)
from .lights.ies import ies_grid, parse_ies
from .materials.bsdf import (FLAG_ANISOTROPIC, FLAG_AS_DIFFUSE,
                             FLAG_FAKE_SHADOWS, FLAG_FRESNEL)
from .scene_types import (
    LIGHT_AREA, LIGHT_BACKGROUND, LIGHT_BGPORTAL, LIGHT_DIRECTIONAL,
    LIGHT_IES, LIGHT_MESH, LIGHT_POINT, LIGHT_SPHERE, LIGHT_SPOT, LIGHT_SUN,
    MAT_BLEND, MAT_COATED_GLOSSY, MAT_GLASS, MAT_GLOSSY, MAT_LIGHT, MAT_MASK,
    MAT_MIRROR, MAT_NULL, MAT_ROUGH_GLASS, MAT_SHINY_DIFFUSE, NODE_COLUMNS,
    VIS_INVISIBLE, VIS_NO_SHADOWS, VIS_NORMAL, VIS_SHADOW_ONLY, Background,
    Camera, Geometry, LightTable, MaterialTable, SceneData,
)

# material and light types (the JAX package's); unknown names raise
# KeyError as there
_MAT_TYPE_BY_NAME = {
    "shinydiffusemat": MAT_SHINY_DIFFUSE, "glossy": MAT_GLOSSY,
    "coated_glossy": MAT_COATED_GLOSSY, "glass": MAT_GLASS,
    "rough_glass": MAT_ROUGH_GLASS, "mirror": MAT_MIRROR, "null": MAT_NULL,
    "light_mat": MAT_LIGHT, "blend_mat": MAT_BLEND, "mask_mat": MAT_MASK}
_LIGHT_TYPES = ("pointlight", "ieslight", "spotlight", "sunlight",
                "directional", "arealight", "spherelight", "meshlight",
                "objectlight", "bgPortalLight", "bglight")
# names that select the block accelerator (the reference's kd-tree names
# map to it, as in the JAX package)
_VOL_TYPES = ("UniformVolume", "ExpDensityVolume", "NoiseVolume",
              "GridVolume", "SkyVolume")
_ACCEL_BLOCKS = ("blocks", "yafaray-kdtree-original",
                 "yafaray-kdtree-multi-thread")
BLOCKS_MIN_FACES = 2048  # the JAX compile defaults to blocks from here on

_VIS_BY_NAME = {
    "normal": VIS_NORMAL,
    "invisible": VIS_INVISIBLE,
    "shadow_only": VIS_SHADOW_ONLY,
    "no_shadows": VIS_NO_SHADOWS,
}


def _unsupported(feature: str):
    return NotImplementedError(
        f"{feature} is not ported to libyafaray_tpu_torch yet")


@dataclass
class _MeshObject:
    """Staged mesh while streaming."""
    name: str
    obj_id: int
    vertices: List = field(default_factory=list)
    vertices_t1: List = field(default_factory=list)  # motion keyframe 1
    vertices_t2: List = field(default_factory=list)  # keyframe 2 (b-spline)
    normals: List = field(default_factory=list)
    uvs: List = field(default_factory=list)
    orcos: List = field(default_factory=list)     # streamed orco coordinates
    faces: List = field(default_factory=list)     # (a,b,c, uva,uvb,uvc, mat)
    visibility: int = VIS_NORMAL
    smooth: bool = False
    # is_base_object: exists only to be instanced, its own copy never renders
    is_base: bool = False
    # an analytic sphere (object type "sphere")
    is_sphere: bool = False
    sphere_center: Optional[np.ndarray] = None
    sphere_radius: float = 1.0
    # the material of a sphere or curve (no per-face material stream)
    sphere_mat: int = 0
    # a curve (object type "curve"): its vertices are strand control points
    # that compile extrudes into a ribbon of width strand_start -> strand_end
    is_curve: bool = False
    strand_start: float = 0.01
    strand_end: float = 0.0025


class SceneBuilder:
    """Stateful scene session (Interface + Scene analogue)."""

    def __init__(self):
        self.materials: Dict[str, P.ParamMap] = {}
        self.material_order: List[str] = []
        self.lights: Dict[str, P.ParamMap] = {}
        self.light_order: List[str] = []
        self.textures: Dict[str, P.ParamMap] = {}
        self.texture_order: List[str] = []
        self.texture_images: Dict[str, np.ndarray] = {}
        self._shader_stacks: Dict[str, List[P.ParamMap]] = {}
        self.cameras: Dict[str, P.ParamMap] = {}
        self.background_params: Optional[P.ParamMap] = None
        self.objects: Dict[str, _MeshObject] = {}
        self.object_order: List[str] = []
        self.instances: List = []      # (base object name, [4x4 matrices])
        self.volumes: Dict[str, P.ParamMap] = {}
        self.render_params = P.ParamMap()
        self.current_object: Optional[_MeshObject] = None
        self.current_material: int = 0
        self.render_views: Dict[str, P.ParamMap] = {}

    # --- entity creation ---

    def create_material(self, name: str, pm: dict,
                        node_list: Optional[List[dict]] = None) -> int:
        pm = P.ParamMap(pm)
        ty = pm.get_string("type")
        if ty not in _MAT_TYPE_BY_NAME:
            raise KeyError(f"material: unknown type {ty!r}")
        if name not in self.materials:
            self.material_order.append(name)
        self.materials[name] = pm
        if node_list:
            self._shader_stacks[name] = [P.ParamMap(n) for n in node_list]
        return self.material_order.index(name)

    def create_light(self, name: str, pm: dict) -> None:
        pm = P.ParamMap(pm)
        ty = pm.get_string("type")
        if ty not in _LIGHT_TYPES:
            raise KeyError(f"light: unknown type {ty!r}")
        if name not in self.lights:
            self.light_order.append(name)
        self.lights[name] = pm

    def create_camera(self, name: str, pm: dict) -> None:
        self.cameras[name] = P.ParamMap(pm)

    def create_background(self, pm: dict) -> None:
        self.background_params = P.ParamMap(pm)

    def create_texture(self, name: str, pm: dict, image=None) -> None:
        """A texture: a procedural type's parameters, or an image texture's
        with its pixels (f32[H, W, 1|3|4]) or a filename in pm."""
        if name not in self.textures:
            self.texture_order.append(name)
        self.textures[name] = P.ParamMap(pm)
        if image is not None:
            self.texture_images[name] = np.asarray(image, np.float32)

    def create_volume_region(self, name: str, pm: dict) -> None:
        pm = P.ParamMap(pm)
        ty = pm.get_string("type", "UniformVolume")
        if ty not in _VOL_TYPES:
            raise KeyError(f"volume region: unknown type {ty!r}")
        self.volumes[name] = pm

    def create_render_view(self, name: str, pm: dict) -> None:
        """A render view (include/render/render_view.h:45-58): a camera
        (`camera_name`), a subset of the lights (`light_names`, separated
        by ';') and a fixed wavelength (`wavelength`, 0: none)."""
        self.render_views[name] = P.ParamMap(pm)

    def set_render_params(self, pm: dict) -> None:
        self.render_params.update(pm)

    # --- geometry streaming ---

    def create_object(self, name: str, pm: Optional[dict] = None) -> None:
        pm = P.ParamMap(pm or {})
        ty = pm.get_string("type", "mesh")
        obj = _MeshObject(name=name, obj_id=len(self.object_order))
        obj.visibility = _VIS_BY_NAME[pm.get_string("visibility", "normal")]
        obj.is_base = pm.get_bool("is_base_object", False)
        if ty == "sphere":
            obj.is_sphere = True
            obj.sphere_center = pm.get_vector("center", (0, 0, 0))
            obj.sphere_radius = pm.get_float("radius", 1.0)
        elif ty == "curve":
            obj.is_curve = True
            obj.strand_start = pm.get_float("strand_start", 0.01)
            obj.strand_end = pm.get_float("strand_end", 0.0025)
        self.objects[name] = obj
        self.object_order.append(name)
        self.current_object = obj

    def set_current_material(self, name: str) -> None:
        if name not in self.material_order:
            raise KeyError(f"unknown material {name!r}")
        self.current_material = self.material_order.index(name)
        # spheres and curves take the active material as a whole
        obj = self.current_object
        if obj is not None and (obj.is_sphere or obj.is_curve):
            obj.sphere_mat = self.current_material

    def add_vertex(self, x, y, z) -> int:
        self.current_object.vertices.append((x, y, z))
        return len(self.current_object.vertices) - 1

    def add_normal(self, x, y, z) -> None:
        self.current_object.normals.append((x, y, z))

    def add_uv(self, u, v) -> int:
        self.current_object.uvs.append((u, v))
        return len(self.current_object.uvs) - 1

    def add_triangle(self, a, b, c, uv=None) -> None:
        uva, uvb, uvc = uv if uv is not None else (-1, -1, -1)
        self.current_object.faces.append(
            (a, b, c, uva, uvb, uvc, self.current_material))

    def add_quad(self, a, b, c, d, uv=None) -> None:
        if uv is not None:
            ua, ub, uc, ud = uv
            self.add_triangle(a, b, c, (ua, ub, uc))
            self.add_triangle(a, c, d, (ua, uc, ud))
        else:
            self.add_triangle(a, b, c)
            self.add_triangle(a, c, d)

    def add_mesh_arrays(self, vertices, faces, uvs=None, face_uvs=None,
                        normals=None, face_mats=None, orcos=None) -> None:
        """Attach whole vertex / face arrays (and orco coordinates, one per
        vertex) to the current object."""
        obj = self.current_object
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        faces = np.asarray(faces, np.int32).reshape(-1, 3)
        obj.vertices.extend(map(tuple, vertices))
        if orcos is not None:
            obj.orcos.extend(map(tuple, np.asarray(orcos, np.float32)
                                 .reshape(-1, 3)))
        if normals is not None:
            obj.normals.extend(map(tuple, np.asarray(normals, np.float32)
                                   .reshape(-1, 3)))
        if uvs is not None:
            obj.uvs.extend(map(tuple, np.asarray(uvs, np.float32)
                               .reshape(-1, 2)))
        fuv = (np.asarray(face_uvs, np.int32).reshape(-1, 3)
               if face_uvs is not None
               else np.full((len(faces), 3), -1, np.int32))
        fmat = (np.asarray(face_mats, np.int32).reshape(-1)
                if face_mats is not None
                else np.full((len(faces),), self.current_material, np.int32))
        for f, u, m in zip(faces, fuv, fmat):
            obj.faces.append((int(f[0]), int(f[1]), int(f[2]),
                              int(u[0]), int(u[1]), int(u[2]), int(m)))

    def smooth_mesh(self, name: str = "", angle: float = 181.0) -> None:
        obj = self.objects[name] if name else self.current_object
        obj.smooth = True

    def add_vertex_with_orco(self, x, y, z, ox, oy, oz) -> int:
        """A vertex and its object-space original coordinates (the
        reference's addVertexWithOrco; texco "orco" maps through them)."""
        self.current_object.orcos.append((ox, oy, oz))
        return self.add_vertex(x, y, z)

    def add_vertex_time_step(self, x, y, z) -> None:
        """Motion-blur position of a vertex at a later time step. The first
        full keyframe fills time step 1 (linear motion); a second one fills
        step 2 (the quadratic b-spline over three control points)."""
        obj = self.current_object
        if len(obj.vertices_t1) < len(obj.vertices):
            obj.vertices_t1.append((x, y, z))
        else:
            obj.vertices_t2.append((x, y, z))

    def add_mesh_time_step(self, vertices_kf) -> None:
        """A whole motion-blur keyframe of the current object (time step 1,
        then 2)."""
        arr = np.asarray(vertices_kf, np.float32).reshape(-1, 3)
        obj = self.current_object
        if len(obj.vertices_t1) < len(obj.vertices):
            obj.vertices_t1.extend(map(tuple, arr))
        else:
            obj.vertices_t2.extend(map(tuple, arr))

    def add_instance(self, base_name: str, matrix) -> None:
        """An instance of a mesh object: one row-major 4x4 world<-object
        matrix (translation in column 3), or a list of them, one per
        shutter time step (a moving instance)."""
        if base_name not in self.objects:
            raise KeyError(f"unknown object {base_name!r}")
        base = self.objects[base_name]
        if base.is_sphere or base.is_curve:
            raise _unsupported("instancing of spheres and curves")
        m = np.asarray(matrix, np.float32)
        self.instances.append((base_name, list(m.reshape(-1, 4, 4))))

    # ------------------------------------------------------------------
    def compile_view(self, view_name: str, *, device="cuda") -> SceneData:
        """Compile the scene for one render view: its camera and, when the
        view lists `light_names`, only those lights enabled (the JAX
        compile_view)."""
        pm = self.render_views[view_name]
        cam = pm.get_string("camera_name", "")
        lights = pm.get_string("light_names", "")
        scene = self.compile(cam or None, device=device)
        if lights:
            wanted = {s.strip() for s in lights.split(";") if s.strip()}
            mask = np.asarray([n in wanted for n in self.light_order], bool)
            flags = scene.lights.flags.cpu().numpy()
            flags = np.where(mask, flags | FLAG_ENABLED,
                             flags & ~FLAG_ENABLED)
            scene = dataclasses.replace(scene, lights=dataclasses.replace(
                scene.lights, flags=torch.from_numpy(flags).to(
                    scene.lights.flags.device)))
        wl = pm.get_float("wavelength", 0.0)
        if wl:
            scene = dataclasses.replace(scene, fixed_wavelength=torch.tensor(
                wl, dtype=torch.float32, device=scene.shadow_bias.device))
        return scene

    def compile(self, camera_name: Optional[str] = None, *,
                device="cuda") -> SceneData:
        """Freeze the staged scene into SceneData on `device` (the CUDA card
        unless the caller names another device, such as "cpu"); the block
        accelerator is built there."""
        materials = self._build_materials()
        textures, nodes, materials = self._build_textures_and_nodes(materials)
        g, obj_face_ranges = self._build_geometry()
        lights, g = self._build_lights(g, obj_face_ranges)
        geom = _geometry_tables(g).to(device)
        background = (make_background(self.background_params,
                                      tex_id=self._bg_tex_id())
                      if self.background_params is not None
                      else Background(kind="none"))
        if background.kind == "texture" and background.tex_id < 0:
            # the JAX compile accepts it and fails when the background is
            # first looked up
            raise ValueError("a texture background needs the name of a "
                             "staged texture in its 'texture' param")
        if background.kind == "texture":
            # the environment map's importance tables, for its background
            # light (the JAX compile builds them for any texture background)
            from .textures.build import build_env_tables
            background = build_env_tables(
                background, self.texture_images,
                self.texture_order[background.tex_id])
        if camera_name is None and self.cameras:
            camera_name = next(iter(self.cameras))
        # without a camera the JAX compile takes a default Camera, whose
        # missing focal length then fails the pixel footprint below
        # (float(None): a TypeError in both packages)
        camera = (make_camera(self.cameras[camera_name]) if camera_name
                  else Camera(kind="perspective"))
        # accelerator choice (scene_accelerator, as the JAX compile): blocks
        # from BLOCKS_MIN_FACES faces on or by name, else brute force
        default = "blocks" if geom.num_faces >= BLOCKS_MIN_FACES else "brute"
        accel = self.render_params.get_string("scene_accelerator", default)
        blocks = None
        if geom.num_faces > 0:
            if accel == "bvh":
                raise _unsupported("the 'bvh' accelerator")
            if accel in _ACCEL_BLOCKS:
                blocks = build_blocks(geom)
            elif geom.tri_table is None and geom.inst_mat is None:
                raise _unsupported(f"brute-force intersection above "
                                   f"{MAX_TRIS} faces")
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        # one pixel's angular footprint, for the primary hits' texture
        # filtering (as the JAX compile)
        focal = max(float(camera.focal), 1e-6)
        return SceneData(
            geom=geom, materials=materials, lights=lights,
            background=background, camera=camera,
            accel_kind="brute" if blocks is None else "blocks", blocks=blocks,
            shadow_bias=f32(self.render_params.get_float("shadow_bias", 5e-4)),
            ray_min_dist=f32(self.render_params.get_float("ray_min_dist",
                                                          5e-5)),
            has_cam_invisible=bool((g["face_vis"] & 4).any()),
            textures=textures, nodes=nodes, volumes=self._build_volumes(),
            pixel_spread=f32(1.0 / (max(camera.resx, 1) * focal))).to(device)

    def _bg_tex_id(self) -> int:
        """The background's texture (its `texture` param), or -1."""
        tname = self.background_params.get_string("texture", "")
        if tname and tname in self.texture_order:
            return self.texture_order.index(tname)
        return -1

    def _build_textures_and_nodes(self, mat_table):
        """The texture pool and the node program (each None when the scene
        has none), and the material table with its node bindings."""
        from .materials.nodes import build_node_program
        from .textures import build_texture_pool
        textures = build_texture_pool(self)
        nodes, mat_table = build_node_program(self, mat_table)
        return textures, nodes, mat_table

    def _build_volumes(self):
        """The volume regions' table, or None without any."""
        if not self.volumes:
            return None
        from .volumes import build_volume_table
        return build_volume_table(self)

    # ------------------------------------------------------------------
    def _build_materials(self) -> MaterialTable:
        """The material table: the JAX compile's `_build_materials`, with
        each type's reference params (material_*.cc)."""
        n = max(len(self.material_order), 1)
        z = lambda: np.zeros((n,), np.float32)
        z3 = lambda: np.zeros((n, 3), np.float32)
        zi = lambda: np.zeros((n,), np.int32)
        cols = dict(
            mat_type=zi(), diffuse_color=z3(), glossy_color=z3(),
            mirror_color=z3(), filter_color=z3(), absorption=z3(),
            emit_color=z3(), specular_refl=z(), transparency=z(),
            translucency=z(), diffuse_reflect=z(), glossy_reflect=z(),
            exponent=z(), exp_u=z(), exp_v=z(), ior=z() + 1.5,
            dispersion=z(), sss_dist=z(), mat_flags=zi(), sigma=z(),
            alpha=z(), sss_scatter_col=z3(), blend_a=zi(), blend_b=zi(),
            blend_value=z())
        if not self.material_order:
            # default diffuse gray
            cols["diffuse_color"][0] = (0.8, 0.8, 0.8)
            cols["diffuse_reflect"][0] = 1.0
        has_blend = has_mask = False
        for i, name in enumerate(self.material_order):
            pm = self.materials[name]
            ty = _MAT_TYPE_BY_NAME[pm.get_string("type")]
            cols["mat_type"][i] = ty
            flags = 0
            oren = pm.get_string("diffuse_brdf", "lambert") == "oren_nayar"
            if ty == MAT_SHINY_DIFFUSE:
                # material_shiny_diffuse.cc params
                cols["diffuse_color"][i] = pm.get_color("color",
                                                        (0.8, 0.8, 0.8))[:3]
                cols["mirror_color"][i] = pm.get_color("mirror_color",
                                                       (1, 1, 1))[:3]
                cols["specular_refl"][i] = pm.get_float("specular_reflect",
                                                        0.0)
                cols["transparency"][i] = pm.get_float("transparency", 0.0)
                cols["translucency"][i] = pm.get_float("translucency", 0.0)
                cols["diffuse_reflect"][i] = pm.get_float("diffuse_reflect",
                                                          1.0)
                cols["emit_color"][i] = (pm.get_float("emit", 0.0)
                                         * pm.get_color("color",
                                                        (0.8, 0.8, 0.8))[:3])
                cols["sigma"][i] = pm.get_float("sigma", 0.0) if oren else 0.0
                cols["ior"][i] = pm.get_float("IOR", 1.33)
                if pm.get_bool("fresnel_effect", False):
                    flags |= FLAG_FRESNEL
                cols["filter_color"][i] = (
                    pm.get_color("transmit_filter", (1, 1, 1))[:3]
                    * pm.get_float("transmit_filter_strength", 1.0)
                    if "transmit_filter" in pm else (1, 1, 1))
            elif ty in (MAT_GLOSSY, MAT_COATED_GLOSSY):
                # material_glossy.cc / material_coated_glossy.cc params
                cols["diffuse_color"][i] = pm.get_color("diffuse_color",
                                                        (0.5,) * 3)[:3]
                cols["glossy_color"][i] = pm.get_color("color", (1, 1, 1))[:3]
                cols["mirror_color"][i] = pm.get_color("mirror_color",
                                                       (1, 1, 1))[:3]
                cols["diffuse_reflect"][i] = pm.get_float("diffuse_reflect",
                                                          1.0)
                cols["glossy_reflect"][i] = pm.get_float("glossy_reflect", 1.0)
                cols["exponent"][i] = pm.get_float("exponent", 50.0)
                cols["ior"][i] = pm.get_float("IOR", 1.5)
                cols["sigma"][i] = pm.get_float("sigma", 0.0) if oren else 0.0
                if pm.get_bool("anisotropic", False):
                    flags |= FLAG_ANISOTROPIC
                    cols["exp_u"][i] = pm.get_float("exp_u", 50.0)
                    cols["exp_v"][i] = pm.get_float("exp_v", 50.0)
                if pm.get_bool("as_diffuse", True):
                    flags |= FLAG_AS_DIFFUSE
            elif ty in (MAT_GLASS, MAT_ROUGH_GLASS):
                # material_glass.cc / material_rough_glass.cc params
                cols["ior"][i] = pm.get_float("IOR", 1.5)
                cols["filter_color"][i] = pm.get_color("filter_color",
                                                       (1, 1, 1))[:3]
                cols["mirror_color"][i] = pm.get_color("mirror_color",
                                                       (1, 1, 1))[:3]
                # the interior Beer handler (material_glass.cc): the
                # 'absorption' colour over 'absorption_dist' becomes
                # sigma_a = -log(absorption) / dist per channel
                if "absorption" in pm:
                    absorp = np.clip(pm.get_color("absorption",
                                                  (1, 1, 1))[:3], 1e-38, 1.0)
                    dist = pm.get_float("absorption_dist", 1.0)
                    sigma_a = -np.log(absorp)
                    if dist != 0.0:
                        sigma_a /= dist
                    cols["absorption"][i] = sigma_a
                # the interior 'sss' handler (volumehandler_sss.cc):
                # exponential free paths of mean absorption_dist, an
                # isotropic scatter tinted by scatter_col
                if pm.get_string("volume_handler", "beer") == "sss":
                    cols["sss_scatter_col"][i] = pm.get_color(
                        "scatter_col", (0.8, 0.8, 0.8))[:3]
                    cols["sss_dist"][i] = max(
                        pm.get_float("absorption_dist", 1.0), 1e-6)
                cols["dispersion"][i] = pm.get_float("dispersion_power", 0.0)
                cols["alpha"][i] = max(pm.get_float("alpha", 0.25), 1e-4)
                if pm.get_bool("fake_shadows", False):
                    flags |= FLAG_FAKE_SHADOWS
            elif ty == MAT_MIRROR:
                cols["mirror_color"][i] = pm.get_color("color", (1, 1, 1))[:3]
                cols["specular_refl"][i] = pm.get_float("reflect", 1.0)
            elif ty == MAT_LIGHT:
                # material_light.cc: emits color * power, scatters nothing
                cols["emit_color"][i] = (pm.get_color("color", (1, 1, 1))[:3]
                                         * pm.get_float("power", 1.0))
            elif ty in (MAT_BLEND, MAT_MASK):
                # material_blend.cc / material_mask.cc: two sub-materials
                # by name, a blend factor or a mask threshold
                has_blend = has_blend or ty == MAT_BLEND
                has_mask = has_mask or ty == MAT_MASK
                cols["blend_a"][i] = self._mat_id(pm.get_string("material1"))
                cols["blend_b"][i] = self._mat_id(pm.get_string("material2"))
                cols["blend_value"][i] = pm.get_float(
                    "blend_value", pm.get_float("threshold", 0.5))
            cols["mat_flags"][i] = flags
        cols.update({c: np.full((n,), -1, np.int32) for c in NODE_COLUMNS})
        return MaterialTable(
            present_types=tuple(sorted({int(t) for t in cols["mat_type"]})),
            has_fresnel=bool(np.any(cols["mat_flags"] & FLAG_FRESNEL)),
            has_aniso=bool(np.any(cols["mat_flags"] & FLAG_ANISOTROPIC)),
            has_oren=bool(np.any(cols["sigma"] > 0.0)),
            has_blend=has_blend, has_mask=has_mask,
            has_dispersion=bool(np.any(cols["dispersion"] > 0.0)),
            has_beer=bool(np.any(cols["absorption"] > 0.0)),
            has_sss=bool(np.any(cols["sss_dist"] > 0.0)),
            **{k: torch.from_numpy(v) for k, v in cols.items()})

    def _mat_id(self, name: str) -> int:
        if name not in self.material_order:
            raise KeyError(f"unknown material {name!r}")
        return self.material_order.index(name)

    # ------------------------------------------------------------------
    def _build_geometry(self):
        """Concatenate all meshes, and the instances baked into copies, into
        flat numpy arrays; true instances go to the `__inst__` entry (the
        JAX compile's `_build_geometry`, for meshes). Returns the arrays and
        each mesh object's (first face, face count)."""
        all_v, all_v1, all_v2, all_n, all_f, all_fuv = [], [], [], [], [], []
        all_orco = []
        all_uv = [np.zeros((1, 2), np.float32)]
        all_fmat, all_fobj, all_fsmooth, all_fvis = [], [], [], []
        sph = dict(center=[], radius=[], mat=[], obj=[], vis=[])
        obj_face_ranges = {}
        v_off, uv_off, f_count = 0, 1, 0   # uv 0 is the unused-uv slot

        def emit_mesh(obj: _MeshObject, matrix):
            nonlocal v_off, uv_off, f_count
            if obj.is_sphere:
                sph["center"].append(obj.sphere_center.astype(np.float32))
                sph["radius"].append(obj.sphere_radius)
                sph["mat"].append(obj.faces[-1][6] if obj.faces
                                  else obj.sphere_mat)
                sph["obj"].append(obj.obj_id)
                sph["vis"].append(0 if obj.is_base
                                  else _vis_bits(obj.visibility))
                return
            if obj.is_curve and obj.vertices:
                obj = _extrude_curve(obj)
            if not obj.faces:
                return
            v = np.asarray(obj.vertices, np.float32).reshape(-1, 3)
            v1_arr = (np.asarray(obj.vertices_t1, np.float32).reshape(-1, 3)
                      if obj.vertices_t1
                      and len(obj.vertices_t1) == len(obj.vertices) else v)
            v2_arr = (np.asarray(obj.vertices_t2, np.float32).reshape(-1, 3)
                      if obj.vertices_t2
                      and len(obj.vertices_t2) == len(obj.vertices)
                      else v1_arr)
            # orco: the streamed coordinates, else the untransformed
            # object-space vertices (a baked instance keeps its object's)
            orco = (np.asarray(obj.orcos, np.float32).reshape(-1, 3)
                    if obj.orcos and len(obj.orcos) == len(obj.vertices)
                    else v.copy())
            if matrix is not None:
                # one matrix per shutter time step: [0] at shutter open,
                # the later ones move the motion keyframes
                m0 = matrix[0]
                m1 = matrix[min(1, len(matrix) - 1)]
                m2 = matrix[min(2, len(matrix) - 1)]
                v = v @ m0[:3, :3].T + m0[:3, 3]
                v1_arr = v1_arr @ m1[:3, :3].T + m1[:3, 3]
                v2_arr = v2_arr @ m2[:3, :3].T + m2[:3, 3]
                matrix = m0   # normals use the shutter-open matrix
            f = np.asarray([fc[:3] for fc in obj.faces], np.int32)
            fuv = np.asarray([fc[3:6] for fc in obj.faces], np.int32)
            fmat = np.asarray([fc[6] for fc in obj.faces], np.int32)
            uv = (np.asarray(obj.uvs, np.float32).reshape(-1, 2)
                  if obj.uvs else np.zeros((0, 2), np.float32))
            if obj.normals and len(obj.normals) == len(obj.vertices):
                n_arr = np.asarray(obj.normals, np.float32).reshape(-1, 3)
                if matrix is not None:
                    n_arr = n_arr @ np.linalg.inv(matrix[:3, :3])
                    n_arr /= np.maximum(
                        np.linalg.norm(n_arr, axis=-1, keepdims=True), 1e-20)
                smooth_flag = True
            elif obj.smooth:
                n_arr = _smooth_normals(v, f)
                smooth_flag = True
            else:
                n_arr = np.zeros_like(v)
                smooth_flag = False
            all_v.append(v)
            all_v1.append(v1_arr)
            all_v2.append(v2_arr)
            all_orco.append(orco)
            all_n.append(n_arr)
            if uv.size:
                all_uv.append(uv)
            all_f.append(f + v_off)
            all_fuv.append(np.where(fuv >= 0, fuv + uv_off, 0))
            all_fmat.append(fmat)
            all_fobj.append(np.full((len(f),), obj.obj_id, np.int32))
            all_fsmooth.append(np.full((len(f),), smooth_flag, bool))
            # a base object (is_base_object) exists only to be instanced:
            # its own copy is invisible, its instances carry its bits
            vis_bits = (0 if matrix is None and obj.is_base
                        else _vis_bits(obj.visibility))
            all_fvis.append(np.full((len(f),), vis_bits, np.int32))
            if matrix is None:
                obj_face_ranges[obj.name] = (f_count, len(f))
            v_off += len(v)
            uv_off += len(uv)
            f_count += len(f)

        for name in self.object_order:
            emit_mesh(self.objects[name], None)

        # true instances (virtual faces, O(base) memory) in scenes the block
        # accelerator carries; baked copies for moving instances, small
        # scenes (mode "auto") and when "baked" is asked for
        mode = self.render_params.get_string("instancing", "auto")
        accel = self.render_params.get_string("scene_accelerator", "")
        inst_faces = sum(len(self.objects[b_].faces)
                         for b_, _ in self.instances)
        small = f_count + inst_faces < BLOCKS_MIN_FACES
        blocks_ok = accel in ("",) + _ACCEL_BLOCKS
        true_inst, moving = [], False
        for base, mats in self.instances:
            motion = len(mats) > 1
            if (mode == "baked" or motion or not blocks_ok
                    or (mode == "auto" and small)):
                emit_mesh(self.objects[base], mats)
                moving = moving or motion
            else:
                true_inst.append((base, mats[0]))

        has_motion = moving or any(self.objects[n].vertices_t1
                                   for n in self.object_order)
        has_motion2 = has_motion and any(self.objects[n].vertices_t2
                                         for n in self.object_order)
        # the orco table exists once any object streamed orcos, as in the
        # JAX compile; without it surfaces use the hit point
        has_orco = any(self.objects[n].orcos for n in self.object_order)
        cat = lambda xs, empty: np.concatenate(xs) if xs else empty
        g = dict(
            vertices=cat(all_v, np.zeros((1, 3), np.float32)),
            orcos=cat(all_orco, None) if has_orco else None,
            vertices_t1=cat(all_v1, None) if has_motion else None,
            vertices_t2=cat(all_v2, None) if has_motion2 else None,
            normals=cat(all_n, np.zeros((1, 3), np.float32)),
            uvs=np.concatenate(all_uv),
            faces=cat(all_f, np.zeros((0, 3), np.int32)),
            face_uvs=cat(all_fuv, np.zeros((0, 3), np.int32)),
            face_mat=cat(all_fmat, np.zeros((0,), np.int32)),
            face_obj=cat(all_fobj, np.zeros((0,), np.int32)),
            face_smooth=cat(all_fsmooth, np.zeros((0,), bool)),
            face_vis=cat(all_fvis, np.zeros((0,), np.int32)),
            face_light=np.full((f_count,), -1, np.int32),
            sph_center=(np.stack(sph["center"]) if sph["center"]
                        else np.zeros((0, 3), np.float32)),
            sph_radius=np.asarray(sph["radius"], np.float32),
            sph_mat=np.asarray(sph["mat"], np.int32),
            sph_obj=np.asarray(sph["obj"], np.int32),
            sph_vis=np.asarray(sph["vis"], np.int32),
            sph_light=np.full((len(sph["radius"]),), -1, np.int32))
        if true_inst:
            mats4 = np.stack([m for _, m in true_inst])
            counts = np.asarray([obj_face_ranges[b_][1]
                                 for b_, _ in true_inst], np.int32)
            g["__inst__"] = dict(
                inst_mat=mats4[:, :3, :].astype(np.float32),
                inst_inv=np.stack([np.linalg.inv(m) for m in mats4]
                                  )[:, :3, :].astype(np.float32),
                inst_nrm=np.stack([np.linalg.inv(m[:3, :3]).T for m in mats4]
                                  ).astype(np.float32),
                inst_face_base=np.asarray([obj_face_ranges[b_][0]
                                           for b_, _ in true_inst], np.int32),
                # virtual ids start after the faces emitted so far; area
                # light quads appended later share that range, as in the
                # JAX compile (ROADMAP section 3)
                inst_face_off=np.concatenate(
                    [[f_count], f_count + np.cumsum(counts)]).astype(np.int32),
                inst_obj=np.asarray([self.objects[b_].obj_id
                                     for b_, _ in true_inst], np.int32),
                inst_vis=np.asarray([_vis_bits(self.objects[b_].visibility)
                                     for b_, _ in true_inst], np.int32))
        return g, obj_face_ranges

    # ------------------------------------------------------------------
    def _build_lights(self, g: dict, obj_face_ranges: dict):
        """Parse the lights into the LightTable (plus the background light
        when the background has `ibl`) and bake each area light's quad into
        the geometry, so BSDF-sampled rays can hit it (MIS). A mesh light
        marks its object's faces with its id and keeps their area CDF."""
        specs = [self.lights[name] for name in self.light_order]
        bg = self.background_params
        if bg is not None and bg.get_bool("ibl", False):
            specs.append(P.ParamMap({
                "type": "bglight", "samples": bg.get_int("ibl_samples", 16),
                "cast_shadows": bg.get_bool("cast_shadows", True)}))
        sun = sun_from_background(bg) if bg is not None else None
        if sun is not None:
            specs.append(sun)
        n = max(len(specs), 1)
        z = lambda: np.zeros((n,), np.float32)
        z3 = lambda: np.zeros((n, 3), np.float32)
        zi = lambda v=0: np.full((n,), v, np.int32)
        cols = dict(light_type=zi(), position=z3(), direction=z3(),
                    color=z3(), edge1=z3(), edge2=z3(), area=z(), flags=zi(),
                    samples=zi(1), cos_start=z(), obj_id=zi(-1),
                    tri_start=zi(), tri_count=zi(), radius=z(), cos_end=z(),
                    falloff=z(), ies_id=zi(-1))
        quads, tri_cdfs, ies_profiles = [], [], []
        bg_light_idx = -1
        for i, pm in enumerate(specs):
            ty = pm.get_string("type")
            flags = FLAG_ENABLED if pm.get_bool("light_enabled", True) else 0
            if pm.get_bool("cast_shadows", True):
                flags |= FLAG_CAST_SHADOWS
            if pm.get_bool("photon_only", False):
                flags |= FLAG_PHOTON_ONLY
            col = pm.get_color("color", (1, 1, 1))[:3]
            power = pm.get_float("power", 1.0)
            cols["flags"][i] = flags
            if ty == "pointlight":
                cols["light_type"][i] = LIGHT_POINT
                cols["position"][i] = pm.get_vector("from")
                cols["color"][i] = col * power
                continue
            if ty in ("ieslight", "spotlight"):
                # light_ies.cc / light_spot.cc: a point aimed from -> to
                fr = pm.get_vector("from")
                d = pm.get_vector("to", (0, 0, 0)) - fr
                cols["position"][i] = fr
                cols["direction"][i] = d / max(np.linalg.norm(d), 1e-12)
                cols["color"][i] = col * power
                if ty == "spotlight":
                    # a smooth edge between the inner and the outer cone
                    cols["light_type"][i] = LIGHT_SPOT
                    cone = pm.get_float("cone_angle", 45.0) * math.pi / 180.0
                    blend = pm.get_float("blend", 0.15)
                    cols["cos_end"][i] = math.cos(cone)
                    cols["cos_start"][i] = math.cos(cone * (1.0 - blend))
                    cols["falloff"][i] = pm.get_float("falloff", 1.0)
                    continue
                # the profile: a file's path or text ('file'), or its text
                # or a vertical candela array ('ies_data')
                cols["light_type"][i] = LIGHT_IES
                src = pm.get_string("file", "") or pm.get("ies_data")
                if src is not None and not (isinstance(src, str)
                                            and src == ""):
                    cols["ies_id"][i] = len(ies_profiles)
                    ies_profiles.append(
                        np.asarray(src, np.float32)
                        if not isinstance(src, str) else parse_ies(src))
                continue
            if ty == "sunlight":
                cols["light_type"][i] = LIGHT_SUN
                d = pm.get_vector("direction", (0, 0, 1))
                d = d / max(np.linalg.norm(d), 1e-12)
                cols["direction"][i] = -d  # stored: direction light travels
                cos_a = math.cos(pm.get_float("angle", 0.27) * math.pi / 180.0)
                cols["cos_start"][i] = cos_a
                # radiance so that irradiance matches power (light_sun.cc)
                omega = 2 * math.pi * (1 - cos_a)
                cols["color"][i] = col * power / max(omega, 1e-9)
                cols["samples"][i] = pm.get_int("samples", 4)
                continue
            if ty == "directional":
                # light_directional.cc: parallel light along -direction
                cols["light_type"][i] = LIGHT_DIRECTIONAL
                d = pm.get_vector("direction", (0, 0, 1))
                d = d / max(np.linalg.norm(d), 1e-12)
                cols["direction"][i] = -d
                cols["color"][i] = col * power
                continue
            if ty == "spherelight":
                # light_sphere.cc: the reference's contribution is
                # color * power * omega / pi (its cone pdf lacks the 2 pi),
                # which with the true solid-angle pdf is a radiance of
                # color * power / pi
                cols["light_type"][i] = LIGHT_SPHERE
                r = pm.get_float("radius", 1.0)
                cols["position"][i] = pm.get_vector("from")
                cols["radius"][i] = r
                cols["area"][i] = 4.0 * math.pi * r * r
                cols["color"][i] = col * power / math.pi
                cols["samples"][i] = pm.get_int("samples", 4)
                continue
            if ty == "bglight":
                cols["light_type"][i] = LIGHT_BACKGROUND
                bg_light_idx = i
                cols["samples"][i] = pm.get_int("samples", 16)
                continue
            if ty in ("meshlight", "objectlight", "bgPortalLight"):
                # light_object_light.cc: the object's faces emit color *
                # power from both sides; light_background_portal.cc: they
                # let the background in, times power, from their front.
                # Both sample by an area-CDF face pick (uniform density 1 /
                # total area)
                portal = ty == "bgPortalLight"
                cols["light_type"][i] = LIGHT_BGPORTAL if portal else LIGHT_MESH
                oname = pm.get_string("object_name")
                if portal and oname not in obj_face_ranges:
                    raise ValueError(f"bgPortalLight {oname!r}: a portal "
                                     "needs a staged mesh object by its "
                                     "'object_name'")
                if oname in obj_face_ranges:
                    start, cnt = obj_face_ranges[oname]
                    cols["tri_start"][i] = start
                    cols["tri_count"][i] = cnt
                    cols["obj_id"][i] = self.objects[oname].obj_id
                    v = g["vertices"]
                    f = g["faces"][start:start + cnt]
                    areas = 0.5 * np.linalg.norm(np.cross(
                        v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]),
                        axis=-1)
                    total = float(areas.sum())
                    cols["area"][i] = total
                    tri_cdfs.append((start, cnt,
                                     np.cumsum(areas) / max(total, 1e-30)))
                    g["face_light"][start:start + cnt] = i
                # a portal's color column holds its power multiplier
                cols["color"][i] = power if portal else col * power
                if pm.get_bool("double_sided", False):
                    cols["flags"][i] |= FLAG_DOUBLE_SIDED
                cols["samples"][i] = pm.get_int("samples", 4)
                continue
            cols["light_type"][i] = LIGHT_AREA
            corner = pm.get_vector("corner")
            p1 = pm.get_vector("point1")
            p2 = pm.get_vector("point2")
            e1 = p1 - corner
            e2 = p2 - corner
            nrm = np.cross(e1, e2)
            area = float(np.linalg.norm(nrm))
            cols["position"][i] = corner
            cols["edge1"][i] = e1
            cols["edge2"][i] = e2
            cols["direction"][i] = nrm / max(area, 1e-12)
            cols["area"][i] = area
            # emitted radiance; with the solid-angle pdf of sample_light the
            # net contribution is color*power*area*cos/d^2 as in the reference
            cols["color"][i] = col * power
            cols["samples"][i] = pm.get_int("samples", 4)
            cam_vis = pm.get_string("visibility", "normal") != "invisible"
            quads.append((i, corner, p1, p2, cam_vis))
        if not specs:
            cols["flags"][0] = 0  # disabled placeholder
        if quads:
            g = _append_light_quads(g, quads)
        tri_cdf = None
        if tri_cdfs:
            tri_cdf = np.zeros((len(g["faces"]),), np.float32)
            for start, cnt, cum in tri_cdfs:
                tri_cdf[start:start + cnt] = cum
            tri_cdf = torch.from_numpy(tri_cdf)
        nl = len(specs)
        ies_pool = torch.from_numpy(
            np.stack([ies_grid(p) for p in ies_profiles]) if ies_profiles
            else np.zeros((1, 1, 64), np.float32))
        lights = LightTable(
            tri_cdf=tri_cdf, ies_pool=ies_pool, num_lights=nl,
            bg_light_idx=bg_light_idx,
            present_types=tuple(sorted({int(t) for t in
                                        cols["light_type"][:nl]})),
            samples_static=tuple(max(1, int(s)) for s in cols["samples"][:nl]),
            **{k: torch.from_numpy(v) for k, v in cols.items()})
        return lights, g


def _append_light_quads(g: dict, quads) -> dict:
    """Two emissive triangles per area light. They cast no shadows (vis bit
    value 2 never set); value 4 hides them from camera rays only."""
    v_off = len(g["vertices"])
    new_v, new_f, new_light, new_vis = [], [], [], []
    for li, corner, p1, p2, cam_vis in quads:
        c = np.asarray(corner, np.float32)
        e1 = np.asarray(p1, np.float32) - c
        e2 = np.asarray(p2, np.float32) - c
        base = v_off + len(new_v)
        new_v += [c, c + e1, c + e1 + e2, c + e2]
        new_f += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
        new_light += [li, li]
        new_vis += [1 if cam_vis else 5] * 2
    nv = np.asarray(new_v, np.float32)
    nf = np.asarray(new_f, np.int32)
    cnt = len(nf)
    g["vertices"] = np.concatenate([g["vertices"], nv])
    for key in ("vertices_t1", "vertices_t2"):
        if g[key] is not None:
            g[key] = np.concatenate([g[key], nv])
    g["normals"] = np.concatenate([g["normals"], np.zeros_like(nv)])
    g["faces"] = np.concatenate([g["faces"], nf]) if len(g["faces"]) else nf
    g["face_uvs"] = np.concatenate([g["face_uvs"], np.zeros((cnt, 3), np.int32)])
    g["face_mat"] = np.concatenate([g["face_mat"], np.zeros((cnt,), np.int32)])
    g["face_obj"] = np.concatenate([g["face_obj"], np.full((cnt,), -1, np.int32)])
    g["face_smooth"] = np.concatenate([g["face_smooth"], np.zeros((cnt,), bool)])
    g["face_vis"] = np.concatenate([g["face_vis"], np.asarray(new_vis, np.int32)])
    g["face_light"] = np.concatenate([g["face_light"],
                                      np.asarray(new_light, np.int32)])
    return g


def _geometry_tables(g: dict) -> Geometry:
    inst = g.pop("__inst__", None)
    f0 = int(len(g["faces"]))
    f = int(inst["inst_face_off"][-1]) if inst else f0
    tensors = {k: torch.from_numpy(v)
               for k, v in {**g, **(inst or {})}.items() if v is not None}
    geom = Geometry(num_faces=f, num_base_faces=f0,
                    num_spheres=int(len(g["sph_radius"])),
                    has_motion=g["vertices_t1"] is not None, **tensors)
    if 0 < f <= MAX_TRIS and inst is None:
        # the brute-force path's tables, packed once here instead of per
        # intersect call (as the JAX compile, also for block scenes)
        fc = geom.faces.long()

        def table(v):
            return pack_tris(v[fc[:, 0]], v[fc[:, 1]], v[fc[:, 2]],
                             geom.face_vis)

        geom.tri_table = table(geom.vertices)
        if geom.has_motion:
            geom.tri_table_t1 = table(geom.vertices_t1)
            if geom.vertices_t2 is not None:
                geom.tri_table_t2 = table(geom.vertices_t2)
    return geom


def _extrude_curve(obj: _MeshObject) -> _MeshObject:
    """A copy of the curve with its strand control points extruded into a
    two-sided ribbon of triangles (the reference's CurveObject): the side
    vector is perpendicular to the strand and a stable reference axis, the
    width lerps strand_start -> strand_end (the JAX compile's
    `_extrude_curve`, which extrudes the staged object in place)."""
    pts = np.asarray(obj.vertices, np.float32).reshape(-1, 3)
    mat = obj.faces[-1][6] if obj.faces else obj.sphere_mat
    obj = dataclasses.replace(obj, vertices=[], faces=[])
    n = len(pts)
    if n < 2:
        return obj
    for k in range(n):
        t = k / max(n - 1, 1)
        w = 0.5 * (obj.strand_start * (1 - t) + obj.strand_end * t)
        d = pts[min(k + 1, n - 1)] - pts[max(k - 1, 0)]
        d = d / max(np.linalg.norm(d), 1e-12)
        ref = (np.array([0, 0, 1], np.float32) if abs(d[2]) < 0.9
               else np.array([1, 0, 0], np.float32))
        side = np.cross(d, ref)
        side = side / max(np.linalg.norm(side), 1e-12)
        obj.vertices.append(tuple(pts[k] - side * w))
        obj.vertices.append(tuple(pts[k] + side * w))
    for k in range(n - 1):
        i0, i1, i2, i3 = 2 * k, 2 * k + 1, 2 * k + 2, 2 * k + 3
        obj.faces.append((i0, i1, i3, -1, -1, -1, mat))
        obj.faces.append((i0, i3, i2, -1, -1, -1, mat))
    return obj


def _vis_bits(vis: int) -> int:
    """Visibility enum -> (camera_visible | casts_shadow) bitmask."""
    return {VIS_NORMAL: 3, VIS_INVISIBLE: 0, VIS_SHADOW_ONLY: 2,
            VIS_NO_SHADOWS: 1}[vis]


def _smooth_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (MeshObject::smoothNormals analogue)."""
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    fn = np.cross(e1, e2)
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(norm, 1e-20)).astype(np.float32)
