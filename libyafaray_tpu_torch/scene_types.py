"""Scene tables as torch dataclasses: the counterpart of
`libyafaray_tpu/scene_types.py`, with the fields the forward path reads.

Tensor fields live on one device; `.to(device)` returns a copy of the table
with every tensor moved. Fields that the JAX package keeps static for tracing
(counts, kinds, presence hints) are plain Python values here, and the port
specializes on them in Python the same way.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

Tensor = torch.Tensor

# --- material type enum (same values as the JAX package) ---
MAT_SHINY_DIFFUSE = 0   # "shinydiffusemat"

# --- light type enum (the values the port compiles) ---
LIGHT_AREA = 3          # "arealight"
LIGHT_SUN = 4           # "sunlight"
LIGHT_BACKGROUND = 6    # "bglight" (the background's ibl)

# --- object visibility ---
VIS_NORMAL = 0
VIS_INVISIBLE = 1
VIS_SHADOW_ONLY = 2
VIS_NO_SHADOWS = 3


class _Table:
    """`.to(device)` for a dataclass of tensors (and nested tables)."""

    def to(self, device):
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (Tensor, _Table)):
                v = v.to(device)
            moved[f.name] = v
        return dataclasses.replace(self, **moved)


@dataclass
class Geometry(_Table):
    """Flat triangle soup with per-face attribute arrays."""
    vertices: Tensor        # f32[V, 3]
    normals: Tensor         # f32[V, 3] per-vertex smooth normals
    uvs: Tensor             # f32[U, 2] uv pool
    faces: Tensor           # i32[F, 3] vertex indices
    face_uvs: Tensor        # i32[F, 3] uv indices
    face_mat: Tensor        # i32[F] material id
    face_obj: Tensor        # i32[F] object id (-1 for area-light quads)
    face_smooth: Tensor     # bool[F] use smooth normals
    face_light: Tensor      # i32[F] area light id or -1
    # bit0 hit by camera/bounce rays, bit1 casts shadows,
    # bit2 (value 4) invisible to camera rays only
    face_vis: Tensor        # i32[F]
    # packed f32[C, 16] table for the closest-hit kernel
    # (accel/mt_intersect.py pack_tris), built once at scene compile
    tri_table: Optional[Tensor] = None
    num_faces: int = 0
    num_spheres: int = 0


@dataclass
class MaterialTable(_Table):
    """SoA material parameters, one row per named material."""
    mat_type: Tensor         # i32[M]
    diffuse_color: Tensor    # f32[M, 3]
    mirror_color: Tensor     # f32[M, 3]
    emit_color: Tensor       # f32[M, 3]
    specular_refl: Tensor    # f32[M]
    transparency: Tensor     # f32[M]
    translucency: Tensor     # f32[M]
    diffuse_reflect: Tensor  # f32[M]
    ior: Tensor              # f32[M]
    mat_flags: Tensor        # i32[M] bit0 fresnel_effect
    # any row with fresnel_effect set
    has_fresnel: bool = True


@dataclass
class LightTable(_Table):
    """SoA light table."""
    light_type: Tensor      # i32[L]
    position: Tensor        # f32[L, 3] area light corner
    direction: Tensor       # f32[L, 3] area light normal; sun: the
                            #   direction its light travels
    color: Tensor           # f32[L, 3] radiance (area: color * power;
                            #   sun: color * power / cone solid angle)
    edge1: Tensor           # f32[L, 3]
    edge2: Tensor           # f32[L, 3]
    area: Tensor            # f32[L]
    flags: Tensor           # i32[L] bit0 cast_shadows, bit1 enabled,
                            #        bit2 photon_only, bit3 double_sided
    samples: Tensor         # i32[L]
    cos_start: Tensor       # f32[L] sun: cosine of the cone half-angle
    num_lights: int = 0
    # index of the background light (the background's ibl), or -1
    bg_light_idx: int = -1
    present_types: tuple = ()
    # per-light sample counts, honoured by the direct-lighting integrator
    samples_static: tuple = ()


@dataclass
class Background(_Table):
    """Constant background (colour times power)."""
    kind: str = "constant"
    color: Optional[Tensor] = None   # f32[3]
    power: Optional[Tensor] = None   # f32[]


@dataclass
class Camera(_Table):
    """Perspective camera frame."""
    kind: str = "perspective"
    origin: Optional[Tensor] = None  # f32[3]
    cam_x: Optional[Tensor] = None   # f32[3] right
    cam_y: Optional[Tensor] = None   # f32[3] up
    cam_z: Optional[Tensor] = None   # f32[3] forward (unit)
    focal: Optional[Tensor] = None   # f32[] focal distance in screen units
    aspect: Optional[Tensor] = None  # f32[] resy / resx
    resx: int = 256
    resy: int = 256


@dataclass
class BlockAccel(_Table):
    """Morton-block tables of the block accelerator (`accel/blocks.py`),
    static scenes without instancing. tab[j] is block j's component-major
    (16, B) slab: rows 0-8 the vertices v0|v1|v2 by component, 9 the
    camera-visibility bit, 10 the shadow-visibility bit (0/1 floats), 11
    the prim id (-2 on padding lanes, whose vertices are 0)."""
    tab: Tensor            # f32[C, 16, B]
    bmin: Tensor           # f32[C, 3] block AABB
    bmax: Tensor           # f32[C, 3]
    block_size: int = 128  # B
    num_blocks: int = 0    # C


@dataclass
class SceneData(_Table):
    """Everything the integrator needs."""
    geom: Geometry
    materials: MaterialTable
    lights: LightTable
    background: Background
    camera: Camera
    shadow_bias: Tensor      # f32[]
    ray_min_dist: Tensor     # f32[]
    accel_kind: str = "brute"       # "brute" | "blocks"
    blocks: Optional[BlockAccel] = None
    # any primitive flagged invisible-to-camera (face_vis bit value 4)
    has_cam_invisible: bool = False
