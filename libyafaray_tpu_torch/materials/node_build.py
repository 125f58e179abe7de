"""Shader-node DAG compiler: the staged node ParamMaps into a NodeProgram.

Counterpart of `libyafaray_tpu/materials/node_build.py` (the reference's
NodeMaterial::loadNodes + solveNodesOrder, src/material/material_node.cc:
55-102, and the texture_mapper / value / mix / layer factories of
src/shader/shader_node.cc:36-39). The node stacks of all materials are
merged into one table in topological order, and the material table's
node_* columns name the slot whose output overrides each channel. The
schema of a node is the JAX package's (see its module docstring), every
texture coordinate system included.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ..scene_types import NodeProgram

NODE_TEXMAP = 0
NODE_VALUE = 1
NODE_MIX = 2
NODE_LAYER = 3

COORD_BY_NAME = {"uv": 0, "global": 1, "orco": 2, "window": 3, "normal": 4,
                 "reflect": 5, "transformed": 6, "stick": 0, "stress": 1,
                 "tangent": 0}
PROJ_BY_NAME = {"plain": 0, "cube": 1, "tube": 2, "sphere": 3}
BLEND_BY_NAME = {"mix": 0, "add": 1, "mult": 2, "multiply": 2, "sub": 3,
                 "subtract": 3, "screen": 4, "divide": 5, "div": 5,
                 "difference": 6, "diff": 6, "darken": 7, "dark": 7,
                 "lighten": 8, "light": 8, "overlay": 9}

# material *_shader param -> MaterialTable node_* column
_CHANNEL_COLUMNS = {
    "diffuse_shader": "node_diffuse",
    "glossy_shader": "node_glossy",
    "mirror_color_shader": "node_mirror",
    "bump_shader": "node_bump",
    "transparency_shader": "node_transparency",
    "translucency_shader": "node_translucency",
    "mirror_shader": "node_mirror_strength",
    "sigma_oren_shader": "node_sigma_oren",
    "diffuse_refl_shader": "node_diffuse_reflect",
    "glossy_reflect_shader": "node_glossy_reflect",
    "exponent_shader": "node_exponent",
    "IOR_shader": "node_ior",
    "filter_color_shader": "node_filter_color",
    "roughness_shader": "node_exponent",
    "mask_shader": "node_blend",
    "blend_shader": "node_blend",
}


def closure(meta, roots) -> tuple:
    """The sorted node slots that the nodes `roots` read, themselves
    included (their inputs, transitively): all a program run must evaluate
    for those nodes' outputs."""
    need, todo = set(), [int(r) for r in roots]
    while todo:
        i = todo.pop()
        if i < 0 or i in need:
            continue
        need.add(i)
        todo.extend(meta[i][1:4])
    return tuple(sorted(need))


def compile_nodes(builder, mat_table):
    """(NodeProgram or None, the material table with its node_* columns
    set) from the builder's per-material node stacks."""
    rows: List[dict] = []
    # global name -> slot (names are prefixed per material to avoid clashes,
    # matching the reference where nodes are per-material)
    mat_cols: Dict[str, np.ndarray] = {
        col: getattr(mat_table, col).numpy().copy()
        for col in set(_CHANNEL_COLUMNS.values())
    }

    for mat_name, stack in builder._shader_stacks.items():
        mat_id = builder.material_order.index(mat_name)
        slot_by_name: Dict[str, int] = {}

        def resolve(pm, key):
            nm = pm.get_string(key, "")
            return slot_by_name.get(nm, -1)

        # order within a stack: reference solveNodesOrder — topological; we
        # require nodes listed after their inputs (re-sort if needed)
        pending = list(stack)
        placed = set()
        ordered = []
        for _ in range(len(pending) + 1):
            rest = []
            for pm in pending:
                deps = [pm.get_string(k, "") for k in
                        ("input", "input1", "input2", "factor", "upper_layer")]
                deps = [d for d in deps if d]
                if all(d in placed for d in deps):
                    ordered.append(pm)
                    placed.add(pm.get_string("name"))
                else:
                    rest.append(pm)
            pending = rest
            if not pending:
                break
        if pending:
            raise ValueError(f"shader nodes of {mat_name!r} have a cycle or "
                             f"missing inputs: "
                             f"{[p.get_string('name') for p in pending]}")

        for pm in ordered:
            ty = pm.get_string("type")
            name = pm.get_string("name")
            row = dict(node_type=0, tex_id=-1, in_a=-1, in_b=-1, in_fac=-1,
                       const_a=np.zeros(4, np.float32),
                       const_b=np.ones(4, np.float32),
                       const_fac=0.5,
                       params_f=np.zeros(24, np.float32),
                       params_i=np.zeros(8, np.int32))
            if ty == "texture_mapper":
                row["node_type"] = NODE_TEXMAP
                texname = pm.get_string("texture")
                if texname not in builder.texture_order:
                    raise KeyError(f"texture_mapper: unknown texture "
                                   f"{texname!r}")
                row["tex_id"] = builder.texture_order.index(texname)
                row["params_i"][0] = COORD_BY_NAME.get(
                    pm.get_string("texco", "global"), 1)
                row["params_i"][1] = PROJ_BY_NAME.get(
                    pm.get_string("mapping", "plain"), 0)
                row["params_i"][2] = min(3, max(0, pm.get_int("proj_x", 1)))
                row["params_i"][3] = min(3, max(0, pm.get_int("proj_y", 2)))
                row["params_i"][4] = min(3, max(0, pm.get_int("proj_z", 3)))
                row["params_i"][5] = 1 if pm.get_bool("do_scalar", True) else 0
                row["params_f"][:16] = pm.get_matrix("transform").reshape(-1)
                row["params_f"][16:19] = pm.get_vector("scale", (1, 1, 1))
                # reference doubles the offset (shader_node_basic.cc:365)
                row["params_f"][19:22] = 2.0 * pm.get_vector("offset", (0, 0, 0))
                row["params_f"][22] = pm.get_float("bump_strength", 1.0)
            elif ty == "value":
                row["node_type"] = NODE_VALUE
                c = pm.get_color("color", (1, 1, 1))
                row["const_a"] = np.asarray(
                    [c[0], c[1], c[2], pm.get_float("alpha", 1.0)], np.float32)
                row["const_fac"] = pm.get_float("scalar", 1.0)
            elif ty == "mix":
                row["node_type"] = NODE_MIX
                row["in_a"] = resolve(pm, "input1")
                row["in_b"] = resolve(pm, "input2")
                row["in_fac"] = resolve(pm, "factor")
                row["const_a"] = pm.get_color("color1", (0, 0, 0))
                row["const_b"] = pm.get_color("color2", (1, 1, 1))
                row["const_fac"] = pm.get_float("value", 0.5)
                row["params_i"][0] = BLEND_BY_NAME.get(
                    pm.get_string("blend_mode", "mix"), 0)
            elif ty == "layer":
                row["node_type"] = NODE_LAYER
                row["in_a"] = resolve(pm, "input")
                row["in_b"] = resolve(pm, "upper_layer")
                row["const_b"] = pm.get_color("upper_color", (0, 0, 0, 0))
                row["const_a"] = pm.get_color("def_col", (1, 1, 1))
                row["params_f"][0] = pm.get_float("colfac", 1.0)
                row["params_f"][1] = pm.get_float("valfac", 1.0)
                row["params_f"][2] = pm.get_float("def_val", 1.0)
                row["params_f"][3] = pm.get_float("upper_value", 0.0)
                row["params_i"][0] = BLEND_BY_NAME.get(
                    pm.get_string("blend_mode", "mix"), 0)
                flags = 0
                if pm.get_bool("stencil", False):
                    flags |= 1
                if pm.get_bool("negative", False):
                    flags |= 2
                if pm.get_bool("noRGB", False):
                    flags |= 4
                row["params_i"][1] = flags
                row["params_i"][2] = 1 if pm.get_bool("do_color", True) else 0
                row["params_i"][3] = 1 if pm.get_bool("do_scalar", False) else 0
            else:
                raise KeyError(f"shader_node: unknown type {ty!r}")
            slot_by_name[name] = len(rows)
            rows.append(row)

        # channel bindings from the material ParamMap
        mpm = builder.materials[mat_name]
        for key, col in _CHANNEL_COLUMNS.items():
            nm = mpm.get_string(key, "")
            if nm:
                if nm not in slot_by_name:
                    raise KeyError(f"material {mat_name!r}: {key}={nm!r} "
                                   f"names no node in its stack")
                mat_cols[col][mat_id] = slot_by_name[nm]

    if not rows:
        return None, mat_table

    def col(key, dtype=np.int32):
        return torch.from_numpy(np.asarray([r[key] for r in rows], dtype))

    def stack(key, dtype=np.float32):
        return torch.from_numpy(np.stack([np.asarray(r[key], dtype)
                                          for r in rows]))

    meta = tuple((int(r["node_type"]), int(r["in_a"]), int(r["in_b"]),
                  int(r["in_fac"]), int(r["tex_id"])) for r in rows)
    prog = NodeProgram(
        node_type=col("node_type"), tex_id=col("tex_id"),
        in_a=col("in_a"), in_b=col("in_b"), in_fac=col("in_fac"),
        const_a=stack("const_a"), const_b=stack("const_b"),
        const_fac=col("const_fac", np.float32),
        params_f=stack("params_f"), params_i=stack("params_i", np.int32),
        num_nodes=len(rows), meta=meta,
        imeta=tuple(tuple(int(x) for x in r["params_i"]) for r in rows),
        has_bump=bool((mat_cols["node_bump"] >= 0).any()),
        bound=tuple(sorted(c for c, v in mat_cols.items() if (v >= 0).any())),
        bump_nodes=closure(meta, set(mat_cols["node_bump"].tolist())),
    )
    mat_table = dataclasses.replace(
        mat_table, **{c: torch.from_numpy(v) for c, v in mat_cols.items()})
    return prog, mat_table
