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
from typing import Any, Optional

import torch

Tensor = torch.Tensor

# --- material type enum (same values as the JAX package) ---
MAT_SHINY_DIFFUSE = 0   # "shinydiffusemat"
MAT_GLOSSY = 1          # "glossy"
MAT_COATED_GLOSSY = 2   # "coated_glossy"
MAT_GLASS = 3           # "glass"
MAT_ROUGH_GLASS = 4     # "rough_glass"
MAT_MIRROR = 5          # "mirror"
MAT_NULL = 6            # "null"
MAT_LIGHT = 7           # "light_mat"
MAT_BLEND = 8           # "blend_mat"
MAT_MASK = 9            # "mask_mat"

# --- light type enum (same values as the JAX package) ---
LIGHT_POINT = 0         # "pointlight"
LIGHT_SPHERE = 1        # "spherelight"
LIGHT_SPOT = 2          # "spotlight"
LIGHT_AREA = 3          # "arealight"
LIGHT_SUN = 4           # "sunlight"
LIGHT_DIRECTIONAL = 5   # "directional"
LIGHT_BACKGROUND = 6    # "bglight" (the background's ibl)
LIGHT_MESH = 7          # "meshlight" / "objectlight"
LIGHT_IES = 8           # "ieslight"
LIGHT_BGPORTAL = 9      # "bgPortalLight"

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
    """Flat triangle soup with per-face attribute arrays.

    With true instancing the per-face arrays cover only the
    F0 = num_base_faces physical faces; instances add virtual face ids in
    [F0, num_faces) that `resolve_prim` maps to (base face, instance)."""
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
    # analytic spheres (object type "sphere"); their prim ids follow the
    # faces: num_faces + s
    sph_center: Optional[Tensor] = None     # f32[S, 3]
    sph_radius: Optional[Tensor] = None     # f32[S]
    sph_mat: Optional[Tensor] = None        # i32[S]
    sph_obj: Optional[Tensor] = None        # i32[S]
    sph_light: Optional[Tensor] = None      # i32[S] light id or -1
    sph_vis: Optional[Tensor] = None        # i32[S] visibility bits
    # packed f32[C, 16] table for the closest-hit kernel
    # (accel/mt_intersect.py pack_tris), built once at scene compile
    tri_table: Optional[Tensor] = None
    # motion blur: vertex keyframes; rays carry a time in [0, 1]. One extra
    # keyframe interpolates linearly, two follow the quadratic b-spline
    # p(t) = (1-t)^2 p0 + 2t(1-t) p1 + t^2 p2. None when static.
    vertices_t1: Optional[Tensor] = None    # f32[V, 3]
    vertices_t2: Optional[Tensor] = None    # f32[V, 3]
    tri_table_t1: Optional[Tensor] = None   # f32[C, 16] keyframe tables
    tri_table_t2: Optional[Tensor] = None
    # object-space "original coordinates" per vertex (the reference's
    # addVertexWithOrco / SurfacePoint::orco): an object that streamed
    # orcos has them here, the others their untransformed vertices. None
    # when no object streamed any: the surface then uses the hit point.
    orcos: Optional[Tensor] = None          # f32[V_orco, 3]
    # true instancing (None when every instance is baked)
    inst_mat: Optional[Tensor] = None        # f32[K, 3, 4] world<-object
    inst_inv: Optional[Tensor] = None        # f32[K, 3, 4] object<-world
    inst_nrm: Optional[Tensor] = None        # f32[K, 3, 3] inverse transpose
    inst_face_base: Optional[Tensor] = None  # i32[K] base face range start
    inst_face_off: Optional[Tensor] = None   # i32[K+1] virtual offsets
    inst_obj: Optional[Tensor] = None        # i32[K] instance object id
    inst_vis: Optional[Tensor] = None        # i32[K] instance visibility bits
    num_faces: int = 0
    num_spheres: int = 0
    has_motion: bool = False
    # physical per-face array length (num_faces unless true instancing)
    num_base_faces: int = 0


def resolve_prim(geom: Geometry, prim: Tensor):
    """Virtual face id -> (base face id, instance id | -1); the instance is
    None when the scene has no true instances."""
    if geom.inst_mat is None:
        return prim, None
    is_inst = prim >= geom.num_base_faces
    off = geom.inst_face_off.to(prim.dtype)
    k = torch.searchsorted(off[1:], prim, right=True)
    k = torch.clamp(k, 0, geom.inst_face_base.shape[0] - 1)
    base = torch.where(
        is_inst, geom.inst_face_base[k] + prim - off[k], prim)
    inst = torch.where(is_inst, k.to(torch.int32), -1)
    return base.to(prim.dtype), inst


def inst_transform_point(geom: Geometry, inst: Tensor, p: Tensor) -> Tensor:
    """Apply the instance matrix (world <- object) where inst >= 0."""
    m = geom.inst_mat[torch.clamp_min(inst, 0).long()]      # [N, 3, 4]
    q = (m[:, :, 0] * p[:, 0:1] + m[:, :, 1] * p[:, 1:2]
         + m[:, :, 2] * p[:, 2:3] + m[:, :, 3])
    return torch.where((inst >= 0)[..., None], q, p)


def inst_transform_normal(geom: Geometry, inst: Tensor, n: Tensor) -> Tensor:
    """Rotate normals by the instance's inverse transpose, renormalised."""
    m = geom.inst_nrm[torch.clamp_min(inst, 0).long()]      # [N, 3, 3]
    q = m[:, :, 0] * n[:, 0:1] + m[:, :, 1] * n[:, 1:2] + m[:, :, 2] * n[:, 2:3]
    q = q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                            1e-20)
    return torch.where((inst >= 0)[..., None], q, n)


@dataclass
class MaterialTable(_Table):
    """SoA material parameters, one row per named material. Every float
    column is differentiable: put a leaf in with `dataclasses.replace` after
    the scene has been moved to its device."""
    mat_type: Tensor         # i32[M]
    diffuse_color: Tensor    # f32[M, 3]
    glossy_color: Tensor     # f32[M, 3]
    mirror_color: Tensor     # f32[M, 3]
    filter_color: Tensor     # f32[M, 3] glass transmission filter
    absorption: Tensor       # f32[M, 3] glass Beer absorption sigma_a
    emit_color: Tensor       # f32[M, 3]
    specular_refl: Tensor    # f32[M]
    transparency: Tensor     # f32[M]
    translucency: Tensor     # f32[M]
    diffuse_reflect: Tensor  # f32[M]
    glossy_reflect: Tensor   # f32[M]
    exponent: Tensor         # f32[M] Blinn exponent
    exp_u: Tensor            # f32[M] anisotropic exponent u
    exp_v: Tensor            # f32[M] anisotropic exponent v
    ior: Tensor              # f32[M]
    dispersion: Tensor       # f32[M] glass dispersion power
    sss_dist: Tensor         # f32[M] glass interior scattering mean free
                             #        path (0: none)
    mat_flags: Tensor        # i32[M] bit0 fresnel_effect, bit1 anisotropic,
                             #        bit2 as_diffuse, bit3 fake_shadows
    sigma: Tensor            # f32[M] Oren-Nayar sigma (0: Lambert)
    alpha: Tensor            # f32[M] GGX roughness (rough glass)
    sss_scatter_col: Tensor  # f32[M, 3] glass sss interior scatter tint
    blend_a: Tensor          # i32[M] blend / mask sub-material 1
    blend_b: Tensor          # i32[M] blend / mask sub-material 2
    blend_value: Tensor      # f32[M] blend factor / mask threshold
    # the mat_type values present (empty: unknown, every family); lobe math
    # of absent families is not evaluated
    present_types: tuple = ()
    # any row with fresnel_effect set
    has_fresnel: bool = True
    # any row with the anisotropic flag
    has_aniso: bool = True
    # any row with an Oren-Nayar sigma > 0
    has_oren: bool = False
    # any blend / mask material: their indirections run only then
    has_blend: bool = False
    has_mask: bool = False
    # any row with dispersion_power > 0: sample_bsdf shifts the IOR by the
    # path's wavelength only then
    has_dispersion: bool = False
    # any glass row with Beer absorption / an sss interior: the bounce
    # loop tracks the medium each path is in only then
    has_beer: bool = False
    has_sss: bool = False
    # shader-node bindings per channel (`materials/node_build.py`): the slot
    # of the node whose output overrides the channel, -1 for none
    node_diffuse: Optional[Tensor] = None          # i32[M]
    node_glossy: Optional[Tensor] = None           # i32[M]
    node_mirror: Optional[Tensor] = None           # i32[M]
    node_bump: Optional[Tensor] = None             # i32[M]
    node_transparency: Optional[Tensor] = None     # i32[M]
    node_translucency: Optional[Tensor] = None     # i32[M]
    node_mirror_strength: Optional[Tensor] = None  # i32[M]
    node_sigma_oren: Optional[Tensor] = None       # i32[M]
    node_diffuse_reflect: Optional[Tensor] = None  # i32[M]
    node_glossy_reflect: Optional[Tensor] = None   # i32[M]
    node_blend: Optional[Tensor] = None            # i32[M]
    node_exponent: Optional[Tensor] = None         # i32[M]
    node_ior: Optional[Tensor] = None              # i32[M]
    node_filter_color: Optional[Tensor] = None     # i32[M]


# the node binding columns of MaterialTable
NODE_COLUMNS = ("node_diffuse", "node_glossy", "node_mirror", "node_bump",
                "node_transparency", "node_translucency",
                "node_mirror_strength", "node_sigma_oren",
                "node_diffuse_reflect", "node_glossy_reflect", "node_blend",
                "node_exponent", "node_ior", "node_filter_color")


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
    cos_start: Tensor       # f32[L] sun: cosine of the cone half-angle;
                            #   spot: cosine of the inner cone
    obj_id: Tensor          # i32[L] mesh light / portal: its object (-1)
    tri_start: Tensor       # i32[L] mesh light / portal: first face
    tri_count: Tensor       # i32[L] mesh light / portal: face count
    radius: Tensor          # f32[L] sphere light radius
    cos_end: Tensor         # f32[L] spot: cosine of the outer cone
    falloff: Tensor         # f32[L] spot: falloff exponent
    ies_id: Tensor          # i32[L] IES light: its profile in ies_pool (-1)
    # IES candela grids (periodic horizontal x clamped vertical),
    # f32[P, IES_RES_H, IES_RES]; f32[1, 1, 64] zeros without IES profiles
    ies_pool: Optional[Tensor] = None
    # mesh lights and portals: each face's normalised cumulative area
    # within its light's face range (the area-CDF pick), f32[F], 0
    # elsewhere; None without such lights
    tri_cdf: Optional[Tensor] = None
    num_lights: int = 0
    # index of the background light (the background's ibl), or -1
    bg_light_idx: int = -1
    present_types: tuple = ()
    # per-light sample counts, honoured by the direct-lighting integrator
    samples_static: tuple = ()


@dataclass
class Background(_Table):
    """The scene's one background; `kind` is "constant", "gradient",
    "sunsky", "darksky", "texture" or "none", and only its own fields are
    set (`backgrounds/__init__.py`)."""
    kind: str = "constant"
    color: Optional[Tensor] = None   # f32[3]
    power: Optional[Tensor] = None   # f32[]
    # gradient
    horizon_color: Optional[Tensor] = None          # f32[3]
    zenith_color: Optional[Tensor] = None           # f32[3]
    ground_horizon_color: Optional[Tensor] = None   # f32[3]
    ground_zenith_color: Optional[Tensor] = None    # f32[3]
    # texture (environment map): its texture, rotation about z (radians)
    # and mapping ("sphere" or "angular")
    tex_id: int = -1
    rotation: Optional[Tensor] = None               # f32[]
    mapping: str = "sphere"
    # sunsky / darksky coefficients (a SunSky or DarkSky table)
    sunsky: Optional[_Table] = None
    # the environment map's importance tables (alias method), built for
    # its background light; env_shape is (H, W), (0, 0) without tables
    env_alias_prob: Optional[Tensor] = None         # f32[H*W]
    env_alias_idx: Optional[Tensor] = None          # i32[H*W]
    env_pdf: Optional[Tensor] = None                # f32[H*W] solid angle
    env_shape: tuple = (0, 0)


@dataclass
class Camera(_Table):
    """Camera frame; `kind` is "perspective", "architect", "orthographic",
    "angular" or "equirectangular". A thin lens (aperture > 0: depth of
    field) samples its aperture through the bokeh shape `bokeh_kind`."""
    kind: str = "perspective"
    origin: Optional[Tensor] = None  # f32[3]
    cam_x: Optional[Tensor] = None   # f32[3] right
    cam_y: Optional[Tensor] = None   # f32[3] up
    cam_z: Optional[Tensor] = None   # f32[3] forward (unit)
    focal: Optional[Tensor] = None   # f32[] focal distance in screen units
    aspect: Optional[Tensor] = None  # f32[] resy / resx
    aperture: Optional[Tensor] = None       # f32[] lens radius
    dof_distance: Optional[Tensor] = None   # f32[] focus distance
    angle: Optional[Tensor] = None          # f32[] angular camera (radians)
    # angular camera: clip radius in image half-widths (max_angle / angle)
    max_radius: Optional[Tensor] = None     # f32[]
    ortho_scale: Optional[Tensor] = None    # f32[]
    near_clip: Optional[Tensor] = None      # f32[]
    far_clip: Optional[Tensor] = None       # f32[]
    bokeh_rotation: Optional[Tensor] = None  # f32[]
    bokeh_kind: str = "disk"
    angular_projection: str = "equidistant"
    circular: bool = True
    mirrored: bool = False
    # aperture > 0 when the camera was made: the thin-lens arm runs
    dof: bool = False
    resx: int = 256
    resy: int = 256


@dataclass
class BlockAccel(_Table):
    """Morton-block tables of the block accelerator (`accel/blocks.py`).
    tab[j] is physical block j's component-major (16, B) slab: rows 0-8 the
    vertices v0|v1|v2 by component, 9 the camera-visibility bit, 10 the
    shadow-visibility bit (0/1 floats), 11 the prim id (-2 on padding
    lanes, whose vertices are 0). Motion blur adds the keyframe slabs
    tab_t1 (and tab_t2) with the same rows 9-11; block AABBs are unions
    over all control points. With true instancing the C virtual blocks
    (bmin/bmax in world space) index physical rows through blk_base, rays
    are transformed object<-world by inv_rows[blk_minv] (row 0 the
    identity) and prim ids rebased by id_delta."""
    tab: Tensor            # f32[C_phys, 16, B]
    bmin: Tensor           # f32[C, 3] block AABB
    bmax: Tensor           # f32[C, 3]
    tab_t1: Optional[Tensor] = None     # f32[C_phys, 16, B]
    tab_t2: Optional[Tensor] = None     # f32[C_phys, 16, B]
    blk_base: Optional[Tensor] = None   # i32[C] physical row of block j
    blk_minv: Optional[Tensor] = None   # i32[C] row of inv_rows
    id_delta: Optional[Tensor] = None   # i32[C] virtual - physical prim id
    inv_rows: Optional[Tensor] = None   # f32[K+1, 12] object<-world 3x4
    block_size: int = 128  # B
    num_blocks: int = 0    # C


@dataclass
class TexturePool(_Table):
    """Every image texture flattened into one texel pool with its mip chain,
    and the per-texture parameter tables. Mip level l of texture t starts at
    row mip_offsets[t, l] (level 0 at img_offset[t]), row-major; row 0 is an
    unused zero texel. The pool's dtype is the JAX package's
    `image_optimization` level: f32 ("none"), f16 ("optimized") or uint8
    ("compressed", dequantised by texel_scale per texture). The texel pool is
    differentiable when f32: put a leaf in with `dataclasses.replace` after
    the scene has reached its device."""
    texel_pool: Tensor      # f32|f16|u8[R, 4] rgba, linear
    texel_scale: Tensor     # f32[T] dequantisation scale (1 unless u8)
    img_offset: Tensor      # i32[T] first row of mip 0
    img_width: Tensor       # i32[T]
    img_height: Tensor      # i32[T]
    mip_offsets: Tensor     # i32[T, MAX_MIPS] first row of each mip, or -1
    num_mips: Tensor        # i32[T]
    tex_type: Tensor        # i32[T] TEX_* (textures/__init__.py)
    params_f: Tensor        # f32[T, 16] repeat, crop, mirror, lod bias, ...
    params_c: Tensor        # f32[T, 2, 4] color1 / color2
    ramp_pos: Tensor        # f32[T, RAMP_MAX] colour-ramp positions
    ramp_col: Tensor        # f32[T, RAMP_MAX, 4]
    ramp_count: Tensor      # i32[T] 0: no ramp
    ramp_mode: Tensor       # i32[T] 0 rgb, 1 hsv, 2 hsl interpolation
    interp: Tensor          # i32[T] 0 none, 1 bilinear, 2 bicubic,
                            #        3 trilinear, 4 EWA
    extend: Tensor          # i32[T] 0 repeat, 1 extend, 2 clip, 3 checker
    # [mult r, g, b, intensity, contrast, saturation, hue, clamp]
    adj: Tensor             # f32[T, 8]
    num_textures: int = 0
    # the texture types, noise bases and interpolation modes present, and
    # the octaves the procedural loops run: the evaluator runs only their
    # code, as the JAX package traces only theirs
    used_types: tuple = ()
    used_noise: tuple = ()
    max_octaves: int = 2
    used_interps: tuple = (0, 1, 2, 3, 4)
    # per texture (type, noise bases, octaves, has a ramp): the static sets
    # with which a lookup of one known texture runs its own code alone
    # (`build.texture_statics`)
    statics: tuple = ()


@dataclass
class NodeProgram(_Table):
    """Every material's shader nodes in one topologically sorted table
    (`materials/node_build.py`); `meta` and `imeta` are its static copies
    that the evaluator's Python loop specialises on."""
    node_type: Tensor       # i32[N] NODE_*
    tex_id: Tensor          # i32[N] texture of a texture_mapper, or -1
    in_a: Tensor            # i32[N] input slots (-1: a constant)
    in_b: Tensor            # i32[N]
    in_fac: Tensor          # i32[N]
    const_a: Tensor         # f32[N, 4]
    const_b: Tensor         # f32[N, 4]
    const_fac: Tensor       # f32[N]
    params_f: Tensor        # f32[N, 24] mapper matrix, scale, offset, bump
    params_i: Tensor        # i32[N, 8] coords, projection, blend mode, flags
    num_nodes: int = 0
    # meta[i] = (node_type, in_a, in_b, in_fac, tex_id)
    meta: tuple = ()
    # imeta[i] = tuple(params_i[i])
    imeta: tuple = ()
    # does any material bind a bump node
    has_bump: bool = False
    # the material table's node_* columns that some material binds
    bound: tuple = ()
    # the slots the bump nodes read (`node_build.closure`): the bump's
    # extra program runs evaluate only these
    bump_nodes: tuple = ()


@dataclass
class VolumeTable(_Table):
    """Volume regions, each a density in an axis-aligned box
    (`volumes/__init__.py`): uniform, exponential in height, a noise
    texture, a voxel grid or the sky's (uniform) density."""
    vol_type: Tensor     # i32[R] VOL_* (volumes/__init__.py)
    bmin: Tensor         # f32[R, 3]
    bmax: Tensor         # f32[R, 3]
    sigma_a: Tensor      # f32[R, 3]
    sigma_s: Tensor      # f32[R, 3]
    emission: Tensor     # f32[R, 3]
    g: Tensor            # f32[R] phase asymmetry
    params_f: Tensor     # f32[R, 8] exp: a, b; noise: sharpness, cover,
                         #           density
    noise_tex: Tensor    # i32[R] a noise region's texture, or -1
    grid_id: Tensor      # i32[R] a grid region's grid, or -1
    grids: Tensor        # f32[G, D, H, W] zero-padded grid pool
                         #           ((1, 1, 1, 1) zeros without grids)
    num_volumes: int = 0
    # static copies of vol_type and noise_tex: density runs only the
    # branches of the types present, as the JAX package's where() keeps
    kinds: tuple = ()
    noise_texs: tuple = ()


@dataclass
class VolAtten(_Table):
    """The single-scatter attenuation grid ("optimize"): exp(-tau) from
    each cell centre of a G^3 grid over the regions' box toward each
    light (`integrators/volume.build_attenuation_grid`)."""
    atten: Tensor        # f32[L, G, G, G, 3]
    bmin: Tensor         # f32[3]
    bmax: Tensor         # f32[3]


@dataclass
class PhotonData(_Table):
    """The preprocessed photon maps (PhotonIntegrator::preprocess's
    output): the diffuse map (indirect deposits that are not caustic) and
    the caustic map, `photon.PhotonMap`s, and the final gather's radiance
    cache (the "FG Radiance Photon Map": a PhotonMap whose dir is the
    surface normal and whose power is the outgoing radiance), or None."""
    diffuse: Any
    caustic: Any
    radiance: Any = None
    n_emitted: int = 0


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
    textures: Optional[TexturePool] = None
    nodes: Optional[NodeProgram] = None
    # angle of one pixel (the primary hits' texture footprint), f32[]
    pixel_spread: Optional[Tensor] = None
    volumes: Optional[VolumeTable] = None
    # the attenuation grid of the single-scatter integrator's "optimize"
    # mode, built by `render` before its passes
    vol_atten: Optional[VolAtten] = None
    # the photon maps of the photon-mapping integrator, built (or loaded)
    # by `render` before its passes
    photons: Optional[PhotonData] = None
    # a render view's fixed wavelength (RenderView::getWaveLength), f32[];
    # every dispersive path takes it instead of its own sample
    fixed_wavelength: Optional[Tensor] = None
