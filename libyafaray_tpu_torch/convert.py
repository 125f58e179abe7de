"""Carry a scene compiled by the JAX package across to the port.

`scene_from_numpy(tree)` takes a `libyafaray_tpu` SceneData whose array
leaves have been converted to numpy (for example with
`jax.tree_util.tree_map(np.asarray, scene)`) and returns the port's
SceneData with the same tables (the motion keyframes, the orco
coordinates, the true-instancing tables, the analytic spheres, the block
accelerator's, the texture pool with its procedural types and the
shader-node program, the mesh lights' area CDF, every volume region type
with its grid pool and the attenuation grid when one is set, every camera
kind and every background kind with the environment
map's importance tables included, a render view's fixed wavelength, every
material type with its Oren-Nayar,
GGX, blend, mask, dispersion and glass-interior columns, and every light
type with the IES profiles), on the CPU. It reads attributes only and
imports nothing of JAX. Scenes that use features the port does not carry
yet raise NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from .scene_types import (NODE_COLUMNS, Background, BlockAccel, Camera,
                          Geometry, LightTable, MaterialTable, NodeProgram,
                          SceneData, TexturePool, VolAtten)
from .textures.build import texture_statics
from .volumes import volume_table


_MAT_COLUMNS = ("mat_type", "diffuse_color", "glossy_color", "mirror_color",
                "filter_color", "absorption", "emit_color", "specular_refl",
                "transparency", "translucency", "diffuse_reflect",
                "glossy_reflect", "exponent", "exp_u", "exp_v", "ior",
                "dispersion", "sss_dist", "mat_flags", "sigma", "alpha",
                "sss_scatter_col", "blend_a", "blend_b", "blend_value")
_LIGHT_COLUMNS = ("light_type", "position", "direction", "color", "edge1",
                  "edge2", "area", "flags", "samples", "cos_start", "obj_id",
                  "tri_start", "tri_count", "radius", "cos_end", "falloff",
                  "ies_id", "ies_pool")
_CAM_COLUMNS = ("origin", "cam_x", "cam_y", "cam_z", "focal", "aspect",
                "aperture", "dof_distance", "angle", "max_radius",
                "ortho_scale", "near_clip", "far_clip", "bokeh_rotation")
_BG_COLUMNS = ("color", "power", "horizon_color", "zenith_color",
               "ground_horizon_color", "ground_zenith_color", "rotation",
               "env_alias_prob", "env_alias_idx", "env_pdf")
_SKY_COLUMNS = ("sun_dir", "theta_s", "zenith_Y", "zenith_x", "zenith_y",
                "perez_Y", "perez_x", "perez_y", "power")
_VOL_COLUMNS = ("vol_type", "bmin", "bmax", "sigma_a", "sigma_s",
                "emission", "g", "params_f", "noise_tex", "grid_id")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _opt(tree, names) -> dict:
    """The named optional array leaves of `tree` as tensors (None stays)."""
    return {k: None if getattr(tree, k) is None else _t(getattr(tree, k))
            for k in names}


def _require(ok: bool, feature: str) -> None:
    if not ok:
        raise NotImplementedError(
            f"{feature} is not ported to libyafaray_tpu_torch yet")


def scene_from_numpy(tree) -> SceneData:
    g, m, lt = tree.geom, tree.materials, tree.lights
    _require(tree.accel_kind in ("brute", "blocks"),
             f"the {tree.accel_kind!r} accelerator")
    if tree.accel_kind == "brute":
        _require(g.num_faces == 0 or g.tri_table is not None,
                 "brute-force intersection without a packed table")
    cam = tree.camera

    geom = Geometry(
        vertices=_t(g.vertices), normals=_t(g.normals), uvs=_t(g.uvs),
        faces=_t(g.faces), face_uvs=_t(g.face_uvs), face_mat=_t(g.face_mat),
        face_obj=_t(g.face_obj), face_smooth=_t(g.face_smooth),
        face_light=_t(g.face_light), face_vis=_t(g.face_vis),
        num_faces=int(g.num_faces), num_spheres=int(g.num_spheres),
        has_motion=bool(g.has_motion), num_base_faces=int(g.num_base_faces),
        **_opt(g, ("sph_center", "sph_radius", "sph_mat", "sph_obj",
                   "sph_light", "sph_vis", "tri_table", "tri_table_t1",
                   "tri_table_t2", "vertices_t1",
                   "vertices_t2", "orcos", "inst_mat", "inst_inv", "inst_nrm",
                   "inst_face_base", "inst_face_off", "inst_obj",
                   "inst_vis")))
    mats = MaterialTable(
        **{f: _t(getattr(m, f)) for f in _MAT_COLUMNS + NODE_COLUMNS},
        present_types=tuple(m.present_types),
        has_fresnel=bool(m.has_fresnel), has_aniso=bool(m.has_aniso),
        has_oren=bool(m.has_oren), has_blend=bool(m.has_blend),
        has_mask=bool(m.has_mask),
        has_dispersion=bool((np.asarray(m.dispersion) > 0).any()),
        has_beer=bool(m.has_beer),
        has_sss=bool(m.has_sss))
    lights = LightTable(
        **{f: _t(getattr(lt, f)) for f in _LIGHT_COLUMNS},
        **_opt(lt, ("tri_cdf",)),
        num_lights=int(lt.num_lights), bg_light_idx=int(lt.bg_light_idx),
        present_types=tuple(lt.present_types),
        samples_static=tuple(lt.samples_static))
    camera = Camera(
        kind=cam.kind, bokeh_kind=cam.bokeh_kind,
        angular_projection=cam.angular_projection,
        circular=bool(cam.circular), mirrored=bool(cam.mirrored),
        dof=float(cam.aperture) > 0.0, resx=int(cam.resx),
        resy=int(cam.resy), **_opt(cam, _CAM_COLUMNS))
    blocks = None
    if tree.accel_kind == "blocks":
        bl = tree.blocks
        blocks = BlockAccel(tab=_t(bl.tab), bmin=_t(bl.bmin),
                            bmax=_t(bl.bmax), block_size=int(bl.block_size),
                            num_blocks=int(bl.num_blocks),
                            **_opt(bl, ("tab_t1", "tab_t2", "blk_base",
                                        "blk_minv", "id_delta", "inv_rows")))
    return SceneData(
        geom=geom, materials=mats, lights=lights,
        background=_background(tree.background), camera=camera,
        shadow_bias=_t(tree.shadow_bias),
        ray_min_dist=_t(tree.ray_min_dist), accel_kind=tree.accel_kind,
        blocks=blocks,
        has_cam_invisible=bool(tree.has_cam_invisible),
        textures=_textures(tree.textures), nodes=_nodes(tree.nodes, mats),
        pixel_spread=(None if tree.pixel_spread is None
                      else _t(tree.pixel_spread)),
        volumes=(None if tree.volumes is None else volume_table(
            {k: np.asarray(getattr(tree.volumes, k)) for k in _VOL_COLUMNS},
            np.asarray(tree.volumes.grids),
            int(tree.volumes.num_volumes))),
        vol_atten=(None if tree.vol_atten is None else VolAtten(
            *(_t(x) for x in tree.vol_atten))),
        fixed_wavelength=(None if tree.fixed_wavelength is None
                          else _t(tree.fixed_wavelength)))


def _background(bg) -> Background:
    from .backgrounds import DarkSky, SunSky
    sky = None
    if bg.kind == "sunsky":
        sky = SunSky(**_opt(bg.sunsky, _SKY_COLUMNS))
    elif bg.kind == "darksky":
        sky = DarkSky(night=bool(bg.sunsky.night),
                      color_space=bg.sunsky.color_space,
                      **_opt(bg.sunsky, _SKY_COLUMNS + ("alt", "exposure")))
    return Background(kind=bg.kind, tex_id=int(bg.tex_id),
                      mapping=bg.mapping, sunsky=sky,
                      env_shape=tuple(int(x) for x in bg.env_shape),
                      **_opt(bg, _BG_COLUMNS))


_POOL_COLUMNS = ("texel_pool", "texel_scale", "img_offset", "img_width",
                 "img_height", "mip_offsets", "num_mips", "tex_type",
                 "params_f", "params_c", "ramp_pos", "ramp_col", "ramp_count",
                 "ramp_mode", "interp", "extend", "adj")
_NODE_TABLES = ("node_type", "tex_id", "in_a", "in_b", "in_fac", "const_a",
                "const_b", "const_fac", "params_f", "params_i")


def _textures(pool):
    if pool is None:
        return None
    return TexturePool(**{k: _t(getattr(pool, k)) for k in _POOL_COLUMNS},
                       num_textures=int(pool.num_textures),
                       used_types=tuple(pool.used_types),
                       used_noise=tuple(pool.used_noise),
                       max_octaves=int(pool.max_octaves),
                       statics=texture_statics(
                           pool.tex_type, pool.params_f, pool.ramp_count,
                           int(pool.max_octaves)),
                       used_interps=tuple(pool.used_interps))


def _nodes(prog, mats: MaterialTable):
    if prog is None:
        return None
    bound = tuple(sorted(c for c in NODE_COLUMNS
                         if bool((getattr(mats, c) >= 0).any())))
    from .materials.node_build import closure
    return NodeProgram(**{k: _t(getattr(prog, k)) for k in _NODE_TABLES},
                       num_nodes=int(prog.num_nodes), meta=tuple(prog.meta),
                       imeta=tuple(prog.imeta), has_bump=bool(prog.has_bump),
                       bound=bound, bump_nodes=closure(
                           prog.meta, set(np.asarray(mats.node_bump)
                                          .tolist())))
