"""Shader-node program evaluator: a Python loop over the static node table.

Counterpart of `libyafaray_tpu/materials/node_eval.py` (the reference's
NodeMaterial::evalNodes and the per-node eval of src/shader/
shader_node_basic.cc and shader_node_layer.cc). The node count and the
dataflow are static (`NodeProgram.meta` / `imeta`), so the loop issues a
fixed sequence of wavefront-wide ops per node, as the JAX package traces
one; nothing is interpreted per hit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..math import vec
from ..scene_types import SceneData
from ..textures.eval import mean_rgb
from .node_build import NODE_LAYER, NODE_MIX, NODE_TEXMAP, NODE_VALUE

Tensor = torch.Tensor


def _affine(pt: Tensor, m: Tensor) -> Tensor:
    """pt @ m[:3, :3].T + m[:3, 3] for a 4x4 m, each component summed left
    to right (the JAX package's XLA dot may contract it into FMAs: the
    tests hold the two to a tolerance; for the identity both are exact)."""
    x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
    return torch.stack([x * m[r, 0] + y * m[r, 1] + z * m[r, 2] + m[r, 3]
                        for r in range(3)], -1)


def _tex_coords(scene: SceneData, sp, i: int, p: Tensor = None) -> Tensor:
    """The texture-mapper input point (TextureMapperNode's coordinates and
    projection, shader_node_basic.cc doMapping); `p` replaces sp.p for the
    bump offsets (orco coordinates ignore it, as in the JAX package)."""
    prog = scene.nodes
    imeta = prog.imeta[i]
    coords, proj = imeta[0], imeta[1]
    pf = prog.params_f[i]
    pos = sp.p if p is None else p
    if coords == 0:      # uv: [0, 1]^2 -> [-1, 1]^2 texture space
        pt = torch.stack([2.0 * sp.uv[..., 0] - 1.0,
                          2.0 * sp.uv[..., 1] - 1.0,
                          torch.zeros_like(sp.uv[..., 0])], -1)
    elif coords == 2:    # orco
        pt = sp.p if sp.orco is None else sp.orco
    elif coords in (4, 5):   # normal; reflect (approximated by n, as JAX)
        pt = sp.n
    else:                # global / window / transformed
        pt = pos
    pt = _affine(pt, pf[:16].reshape(4, 4))
    # the axis remap proj_x/y/z in {0 none, 1 x, 2 y, 3 z}
    pt = torch.stack([torch.zeros_like(pt[..., 0]) if imeta[k] == 0
                      else pt[..., imeta[k] - 1] for k in (2, 3, 4)], -1)
    pt = pt * pf[16:19] + pf[19:22]
    if proj == 1:    # cube: projected along the dominant normal axis
        dom = torch.argmax(torch.abs(sp.ng), dim=-1)
        px = torch.where(dom == 0, pt[..., 1], pt[..., 0])
        py = torch.where(dom == 2, pt[..., 1], pt[..., 2])
        pt = torch.stack([px, py, torch.zeros_like(px)], -1)
    elif proj == 2:  # tube
        u = torch.atan2(pt[..., 1], pt[..., 0]) / (2 * math.pi) + 0.5
        pt = torch.stack([2 * u - 1, pt[..., 2], torch.zeros_like(u)], -1)
    elif proj == 3:  # sphere
        r = torch.clamp_min(torch.sqrt(torch.clamp_min(vec.dot(pt, pt), 0.0)),
                            1e-9)
        u = torch.atan2(pt[..., 1], pt[..., 0]) / (2 * math.pi) + 0.5
        v = 1.0 - torch.arccos(torch.clamp(pt[..., 2] / r, -1, 1)) / math.pi
        pt = torch.stack([2 * u - 1, 2 * v - 1, torch.zeros_like(u)], -1)
    return pt


def _blend(mode: int, tex: Tensor, out: Tensor, fact: Tensor) -> Tensor:
    """textureRgbBlend / textureValueBlend (shader_node_layer.cc:195-300)."""
    f1 = 1.0 - fact
    if mode == 1:    # add
        return out + fact * tex
    if mode == 2:    # mult
        return (f1 + fact * tex) * out
    if mode == 3:    # sub
        return out - fact * tex
    if mode == 4:    # screen
        return 1.0 - (f1 + fact * (1.0 - tex)) * (1.0 - out)
    if mode == 5:    # divide
        return f1 * out + fact * out / torch.clamp_min(tex, 1e-6)
    if mode == 6:    # difference
        return f1 * out + fact * torch.abs(tex - out)
    if mode == 7:    # darken
        return torch.minimum(tex * fact + out * f1, out)
    if mode == 8:    # lighten
        return torch.maximum(tex * fact, out)
    if mode == 9:    # overlay
        lo = out * (f1 + 2.0 * fact * tex)
        hi = 1.0 - (f1 + 2.0 * fact * (1.0 - tex)) * (1.0 - out)
        return torch.where(out < 0.5, lo, hi)
    return f1 * out + fact * tex  # mix


def _eval_node(scene: SceneData, sp, i: int, cols, vals, p=None) -> None:
    """Node i's outputs, appended to the slot lists."""
    from ..textures import sample_texture
    prog = scene.nodes
    ty, in_a, in_b, in_fac, tex_id = prog.meta[i]
    n = sp.p.shape[0]
    dev = sp.p.device
    if ty == NODE_TEXMAP:
        pt = _tex_coords(scene, sp, i, p)
        uv = torch.stack([0.5 * (pt[..., 0] + 1.0),
                          0.5 * (pt[..., 1] + 1.0)], -1)
        tid = torch.full((n,), tex_id, dtype=torch.int32, device=dev)
        duv_dx = duv_dy = None
        if sp.duv_dx is not None and p is None:
            # the footprint through the whole mapping chain: _tex_coords at
            # the uv-offset surface point (exact for the linear uv
            # mappings, first order for the projections)
            orco = sp.p if sp.orco is None else sp.orco
            pt_x = _tex_coords(scene, dataclasses.replace(
                sp, uv=sp.uv + sp.duv_dx, p=sp.p + sp.dp_dx,
                orco=orco + sp.dp_dx), i)
            pt_y = _tex_coords(scene, dataclasses.replace(
                sp, uv=sp.uv + sp.duv_dy, p=sp.p + sp.dp_dy,
                orco=orco + sp.dp_dy), i)
            duv_dx = 0.5 * (pt_x[..., :2] - pt[..., :2])
            duv_dy = 0.5 * (pt_y[..., :2] - pt[..., :2])
        rgba = sample_texture(scene, tid, pt, uv, duv_dx, duv_dy,
                              static_tex=tex_id)
        cols.append(rgba)
        vals.append(mean_rgb(rgba))
    elif ty == NODE_VALUE:
        cols.append(prog.const_a[i].expand(n, 4))
        vals.append(prog.const_fac[i].expand(n))
    elif ty == NODE_MIX:
        ca = cols[in_a] if in_a >= 0 else prog.const_a[i].expand(n, 4)
        cb = cols[in_b] if in_b >= 0 else prog.const_b[i].expand(n, 4)
        va = vals[in_a] if in_a >= 0 else mean_rgb(prog.const_a[i]).expand(n)
        vb = vals[in_b] if in_b >= 0 else mean_rgb(prog.const_b[i]).expand(n)
        f = vals[in_fac] if in_fac >= 0 else prog.const_fac[i].expand(n)
        mode = prog.imeta[i][0]
        cols.append(_blend(mode, cb, ca, f[..., None]))
        vals.append(_blend(mode, vb, va, f))
    elif ty == NODE_LAYER:
        # LayerNode::eval (shader_node_layer.cc:30-110)
        tex = cols[in_a]
        tin = vals[in_a]
        mode, flags, do_color = prog.imeta[i][:3]
        if in_b >= 0:
            rcol = cols[in_b]
            rval = vals[in_b]
            stencil_tin = cols[in_b][..., 3]
        else:
            rcol = prog.const_b[i].expand(n, 4)
            rval = prog.params_f[i, 3].expand(n)
            stencil_tin = torch.ones((n,), dtype=torch.float32, device=dev)
        texcol = tex[..., :3]
        if flags & 4:  # noRGB: the intensity instead of the colour
            texcol = tin[..., None].expand(texcol.shape)
        if flags & 2:  # negative
            texcol = 1.0 - texcol
            tin = 1.0 - tin
        if flags & 1:  # stencil
            stencil_tin = stencil_tin * tin
        colfac = prog.params_f[i, 0]
        valfac = prog.params_f[i, 1]
        if do_color:
            out_rgb = _blend(mode, texcol, rcol[..., :3],
                             (stencil_tin * colfac)[..., None])
        else:
            out_rgb = rcol[..., :3]
        out_val = _blend(mode, tin, rval, stencil_tin * valfac)
        cols.append(torch.cat([out_rgb, stencil_tin[..., None]], -1))
        vals.append(out_val)
    else:
        cols.append(torch.zeros((n, 4), dtype=torch.float32, device=dev))
        vals.append(torch.zeros((n,), dtype=torch.float32, device=dev))


def run_program(scene: SceneData, sp, p=None,
                only=None) -> Tuple[Tensor, Tensor]:
    """Every node's outputs: (colours f32[N, Nn, 4], values f32[N, Nn]).
    With `only` (a set of slots that holds its members' inputs) the other
    slots are zeros: a node's outputs depend on its inputs alone."""
    cols, vals = [], []
    n, dev = sp.p.shape[0], sp.p.device
    for i in range(scene.nodes.num_nodes):
        if only is None or i in only:
            _eval_node(scene, sp, i, cols, vals, p)
        else:
            cols.append(torch.zeros((n, 4), dtype=torch.float32, device=dev))
            vals.append(torch.zeros((n,), dtype=torch.float32, device=dev))
    return torch.stack(cols, dim=1), torch.stack(vals, dim=1)


def eval_bump(scene: SceneData, sp):
    """Bump mapping: the bump node's value differenced along the surface
    tangents tilts the shading normal (TextureMapperNode::evalDerivative's
    analogue, shader_node_basic.cc). The three program runs evaluate the
    bump nodes and their inputs only (`NodeProgram.bump_nodes`); the JAX
    package runs every node and reads the same slots."""
    if not scene.nodes.has_bump:
        return sp
    from .nodes import _pick_col
    nb = scene.materials.node_bump[sp.mat_id.long()]
    has = nb >= 0
    eps = 1e-4
    # only the bump nodes and their inputs: the other slots are not read
    only = set(scene.nodes.bump_nodes)
    _, v0 = run_program(scene, sp, only=only)
    _, vu = run_program(scene, sp, p=sp.p + eps * sp.nu, only=only)
    _, vv = run_program(scene, sp, p=sp.p + eps * sp.nv, only=only)
    idx = torch.clamp_min(nb, 0)
    du = (_pick_col(vu, idx) - _pick_col(v0, idx)) / eps
    dv = (_pick_col(vv, idx) - _pick_col(v0, idx)) / eps
    bs = scene.nodes.params_f[idx.long(), 22]
    n_new = vec.normalize(sp.n - bs[..., None] * (du[..., None] * sp.nu
                                                  + dv[..., None] * sp.nv))
    n_out = torch.where(has[..., None], n_new, sp.n)
    nu = vec.normalize(sp.dp_du - n_out * vec.dot(sp.dp_du, n_out,
                                                  keepdim=True))
    nv = vec.cross(n_out, nu)
    return dataclasses.replace(
        sp, n=n_out, nu=torch.where(has[..., None], nu, sp.nu),
        nv=torch.where(has[..., None], nv, sp.nv))
