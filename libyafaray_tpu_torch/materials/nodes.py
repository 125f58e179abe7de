"""Shader nodes: the program's compile and its use by the materials.

Counterpart of `libyafaray_tpu/materials/nodes.py`. The builder
topologically sorts every material's node list into one NodeProgram
(`materials/node_build.py`); `materials/node_eval.py` runs it for the whole
wavefront. Here are the entry points the materials use: the override of
the material channels bound to nodes (NodeMaterial::getShaderColor's
analogue), the per-lane slot picks and the bump-mapped normal.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..scene_types import SceneData

Tensor = torch.Tensor

# MP field -> the material table's node binding column (the blend and
# mask factor's column, node_blend, is read by bsdf.blend_factor)
_COLOR_CHANNELS = {"diffuse_color": "node_diffuse",
                   "glossy_color": "node_glossy",
                   "mirror_color": "node_mirror",
                   "filter_color": "node_filter_color"}
_SCALAR_CHANNELS = {"specular_refl": "node_mirror_strength",
                    "sigma": "node_sigma_oren",
                    "transparency": "node_transparency",
                    "translucency": "node_translucency",
                    "diffuse_reflect": "node_diffuse_reflect",
                    "glossy_reflect": "node_glossy_reflect",
                    "exponent": "node_exponent",
                    "ior": "node_ior"}


def build_node_program(builder, mat_table):
    """The staged node stacks compiled into a NodeProgram, and the material
    table with its node_* columns set: (program or None, table)."""
    if not getattr(builder, "_shader_stacks", None):
        return None, mat_table
    from .node_build import compile_nodes
    return compile_nodes(builder, mat_table)


def eval_program(scene: SceneData, sp) -> Tuple[Tensor, Tensor]:
    """Every node's outputs for all lanes: (colours f32[N, Nn, 4], values
    f32[N, Nn]). The outputs depend on the scene's node and texture tables
    and the shading points only, so they are kept on `sp` and each
    SurfacePoint runs the program once, however many channels, blend and
    mask factors read it (the JAX package evaluates it at each read, and
    XLA merges the equal computations)."""
    from .node_eval import run_program
    kept = getattr(sp, "_node_outputs", None)
    if (kept is not None and kept[0] is scene.nodes
            and kept[1] is scene.textures):
        return kept[2]
    out = run_program(scene, sp)
    sp._node_outputs = (scene.nodes, scene.textures, out)
    return out


def _pick_col(tab: Tensor, idx: Tensor) -> Tensor:
    """tab[n, idx[n]] per lane from [N, S] or [N, S, C]."""
    ii = idx.long()[:, None]
    if tab.dim() == 3:
        return torch.gather(tab, 1, ii[..., None].expand(-1, 1,
                                                         tab.shape[2]))[:, 0]
    return torch.gather(tab, 1, ii)[:, 0]


def eval_color_slot(scene: SceneData, sp, node_id: Tensor) -> Tensor:
    cols, _ = eval_program(scene, sp)
    return _pick_col(cols, torch.clamp_min(node_id, 0))


def eval_scalar_slot(scene: SceneData, sp, node_id: Tensor) -> Tensor:
    _, floats = eval_program(scene, sp)
    return _pick_col(floats, torch.clamp_min(node_id, 0))


def apply_overrides(scene: SceneData, sp, mat_id: Tensor, mp):
    """mp with each channel whose material binds a node (binding >= 0)
    replaced by that node's output. The program runs only when some
    material binds one of these channels (`NodeProgram.bound`), as XLA
    drops it from the JAX package's trace when nothing reads it."""
    mats = scene.materials
    prog = scene.nodes
    channels = [(f, c, True) for f, c in _COLOR_CHANNELS.items()]
    channels += [(f, c, False) for f, c in _SCALAR_CHANNELS.items()]
    channels = [ch for ch in channels if ch[1] in prog.bound]
    if not channels:
        return mp
    cols, floats = eval_program(scene, sp)
    idx = mat_id.long()
    for field, column, is_color in channels:
        cur = getattr(mp, field)
        if cur is None:
            # sigma of a scene without an Oren-Nayar row: not evaluated,
            # as in the JAX package
            continue
        nid = getattr(mats, column)[idx]
        if is_color:
            val = _pick_col(cols, torch.clamp_min(nid, 0))[..., :3]
            val = torch.where((nid >= 0)[..., None], val, cur)
        else:
            val = torch.where(nid >= 0, _pick_col(floats,
                                                  torch.clamp_min(nid, 0)),
                              cur)
        setattr(mp, field, val)
    return mp


def bump_normal(scene: SceneData, sp):
    """The shading normal perturbed by the bump nodes' derivatives; sp as
    it is when the scene has no nodes."""
    if scene.nodes is None or scene.nodes.num_nodes == 0:
        return sp
    from .node_eval import eval_bump
    return eval_bump(scene, sp)
