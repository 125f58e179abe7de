"""Scene export recorders: XML / C / Python serialization of the build log.

Counterpart of `libyafaray_tpu/io/export.py`, with the same output
character for character; the one difference is `export_python`'s header,
whose script imports this package. The reference's Interface recorder
subclasses (src/interface/export/export_xml.cc, export_c.cc,
export_python.cc:30-56) replay every builder call as a serialized scene
description; here the SceneBuilder already *is* the build log (named
ParamMap registries + streamed geometry), so the recorders are plain
serializers over it.

The XML dialect follows the reference's yafaray-xml element naming
(export_xml.cc writeParamMap: <parameter name=... type-tagged value>).
Neither package writes render views, RAM texture images, orco
coordinates, normals or motion keyframes, and an instance's list of
matrices fails `export_xml` and `export_python` in both.
"""
from __future__ import annotations

from typing import IO, Any

import numpy as np


def _xml_param(key: str, val: Any) -> str:
    if isinstance(val, bool):
        return f'\t\t<{key} bval="{str(val).lower()}"/>\n'
    if isinstance(val, int):
        return f'\t\t<{key} ival="{val}"/>\n'
    if isinstance(val, float):
        return f'\t\t<{key} fval="{val}"/>\n'
    if isinstance(val, str):
        return f'\t\t<{key} sval="{val}"/>\n'
    arr = np.asarray(val)
    if arr.ndim == 2 and arr.shape == (4, 4):
        cells = " ".join(f'm{i}{j}="{arr[i, j]}"' for i in range(4)
                         for j in range(4))
        return f"\t\t<{key} {cells}/>\n"
    if arr.size == 2:
        return f'\t\t<{key} u="{arr[0]}" v="{arr[1]}"/>\n'
    if arr.size == 3:
        return (f'\t\t<{key} x="{arr[0]}" y="{arr[1]}" z="{arr[2]}"/>\n')
    if arr.size == 4:
        return (f'\t\t<{key} r="{arr[0]}" g="{arr[1]}" b="{arr[2]}" '
                f'a="{arr[3]}"/>\n')
    return f'\t\t<{key} sval="{val}"/>\n'


def _write_entity(f: IO, tag: str, name: str, pm) -> None:
    f.write(f'\t<{tag} name="{name}">\n')
    for k, v in pm.items():
        f.write(_xml_param(k, v))
    f.write(f"\t</{tag}>\n")


def export_xml(builder, path: str) -> None:
    """Serialize the staged scene as a yafaray-xml-style document
    (ExportXml analogue)."""
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n<scene type="triangle">\n')
        for name in builder.texture_order:
            _write_entity(f, "texture", name, builder.textures[name])
        for name in builder.material_order:
            pm = builder.materials[name]
            f.write(f'\t<material name="{name}">\n')
            for k, v in pm.items():
                f.write(_xml_param(k, v))
            for node in builder._shader_stacks.get(name, []):
                f.write("\t\t<list_element>\n")
                for k, v in node.items():
                    f.write("\t" + _xml_param(k, v))
                f.write("\t\t</list_element>\n")
            f.write("\t</material>\n")
        for name in builder.light_order:
            _write_entity(f, "light", name, builder.lights[name])
        for name, obj in builder.objects.items():
            f.write(f'\t<object name="{name}">\n')
            if obj.is_sphere:
                f.write('\t\t<type sval="sphere"/>\n')
                f.write(_xml_param("center", obj.sphere_center))
                f.write(_xml_param("radius", float(obj.sphere_radius)))
            else:
                f.write(f'\t\t<mesh vertices="{len(obj.vertices)}" '
                        f'faces="{len(obj.faces)}">\n')
                for v in obj.vertices:
                    f.write(f'\t\t\t<p x="{v[0]}" y="{v[1]}" z="{v[2]}"/>\n')
                for u in obj.uvs:
                    f.write(f'\t\t\t<uv u="{u[0]}" v="{u[1]}"/>\n')
                for fc in obj.faces:
                    if fc[3] >= 0:
                        f.write(f'\t\t\t<f a="{fc[0]}" b="{fc[1]}" '
                                f'c="{fc[2]}" uv_a="{fc[3]}" uv_b="{fc[4]}" '
                                f'uv_c="{fc[5]}" mat="{fc[6]}"/>\n')
                    else:
                        f.write(f'\t\t\t<f a="{fc[0]}" b="{fc[1]}" '
                                f'c="{fc[2]}" mat="{fc[6]}"/>\n')
                f.write("\t\t</mesh>\n")
            f.write("\t</object>\n")
        for base, mtx in builder.instances:
            cells = " ".join(f'm{i}{j}="{mtx[i, j]}"' for i in range(4)
                             for j in range(4))
            f.write(f'\t<instance base_object_name="{base}" {cells}/>\n')
        for name, pm in builder.cameras.items():
            _write_entity(f, "camera", name, pm)
        if builder.background_params is not None:
            _write_entity(f, "background", "world",
                          builder.background_params)
        for name, pm in builder.volumes.items():
            _write_entity(f, "volumeregion", name, pm)
        if builder.render_params:
            _write_entity(f, "render", "render", builder.render_params)
        f.write("</scene>\n")


def _py_value(v: Any) -> str:
    arr = np.asarray(v)
    if arr.ndim and arr.size > 1:
        return repr(tuple(float(x) for x in arr.reshape(-1)))
    return repr(v)


def export_python(builder, path: str) -> None:
    """Emit a runnable python script that rebuilds the scene through the
    SceneBuilder API (ExportPython analogue, export_python.cc:36-46)."""
    with open(path, "w") as f:
        f.write("# generated by libyafaray_tpu_torch export_python\n"
                "from libyafaray_tpu_torch import SceneBuilder\n\n"
                "b = SceneBuilder()\n")
        for name in builder.texture_order:
            f.write(f"b.create_texture({name!r}, "
                    f"{dict(builder.textures[name])!r})\n")
        for name in builder.material_order:
            nodes = builder._shader_stacks.get(name)
            nl = f", node_list={[dict(n) for n in nodes]!r}" if nodes else ""
            f.write(f"b.create_material({name!r}, "
                    f"{dict(builder.materials[name])!r}{nl})\n")
        for name in builder.light_order:
            f.write(f"b.create_light({name!r}, "
                    f"{dict(builder.lights[name])!r})\n")
        for name, obj in builder.objects.items():
            if obj.is_sphere:
                f.write(f"b.create_object({name!r}, {{'type': 'sphere', "
                        f"'center': {tuple(map(float, obj.sphere_center))}, "
                        f"'radius': {float(obj.sphere_radius)}}})\n")
                continue
            f.write(f"b.create_object({name!r})\n")
            for v in obj.vertices:
                f.write(f"b.add_vertex({float(v[0])!r}, {float(v[1])!r}, "
                        f"{float(v[2])!r})\n")
            for u in obj.uvs:
                f.write(f"b.add_uv({float(u[0])!r}, {float(u[1])!r})\n")
            cur_mat = None
            for fc in obj.faces:
                if fc[6] != cur_mat:
                    cur_mat = fc[6]
                    mname = builder.material_order[cur_mat]
                    f.write(f"b.set_current_material({mname!r})\n")
                uv = (f", uv=({fc[3]}, {fc[4]}, {fc[5]})"
                      if fc[3] >= 0 else "")
                f.write(f"b.add_triangle({fc[0]}, {fc[1]}, {fc[2]}{uv})\n")
        for base, mtx in builder.instances:
            f.write(f"b.add_instance({base!r}, "
                    f"{[list(map(float, r)) for r in mtx]!r})\n")
        for name, pm in builder.cameras.items():
            f.write(f"b.create_camera({name!r}, {dict(pm)!r})\n")
        if builder.background_params is not None:
            f.write(f"b.create_background("
                    f"{dict(builder.background_params)!r})\n")
        for name, pm in builder.volumes.items():
            f.write(f"b.create_volume_region({name!r}, {dict(pm)!r})\n")
        if builder.render_params:
            f.write(f"b.set_render_params({dict(builder.render_params)!r})\n")
        f.write("scene = b.compile()\n")


def export_c(builder, path: str) -> None:
    """Emit a C client program against the (planned) C API, mirroring
    ExportC (export_c.cc): the same yafaray_* call sequence as the
    reference's generated clients."""
    def c_pm(pm):
        out = []
        for k, v in pm.items():
            if isinstance(v, bool):
                out.append(f'yafaray_paramsSetBool(yi, "{k}", '
                           f'{"YAFARAY_BOOL_TRUE" if v else "YAFARAY_BOOL_FALSE"});')
            elif isinstance(v, int):
                out.append(f'yafaray_paramsSetInt(yi, "{k}", {v});')
            elif isinstance(v, float):
                out.append(f'yafaray_paramsSetFloat(yi, "{k}", {v});')
            elif isinstance(v, str):
                out.append(f'yafaray_paramsSetString(yi, "{k}", "{v}");')
            else:
                arr = np.asarray(v).reshape(-1)
                if arr.size == 3:
                    out.append(f'yafaray_paramsSetVector(yi, "{k}", '
                               f'{arr[0]}, {arr[1]}, {arr[2]});')
                elif arr.size == 4:
                    out.append(f'yafaray_paramsSetColor(yi, "{k}", '
                               f'{arr[0]}, {arr[1]}, {arr[2]}, {arr[3]});')
        return out

    with open(path, "w") as f:
        f.write('#include <yafaray_tpu_c_api.h>\n\n'
                'int main(void)\n{\n'
                '\tyafaray_Interface_t *yi = yafaray_createInterface('
                'YAFARAY_INTERFACE_FOR_RENDERING, NULL, NULL, NULL, '
                'YAFARAY_DISPLAY_CONSOLE_NORMAL);\n')
        for name in builder.texture_order:
            f.write("\tyafaray_paramsClearAll(yi);\n")
            for line in c_pm(builder.textures[name]):
                f.write(f"\t{line}\n")
            f.write(f'\tyafaray_createTexture(yi, "{name}");\n')
        for name in builder.material_order:
            f.write("\tyafaray_paramsClearAll(yi);\n")
            for line in c_pm(builder.materials[name]):
                f.write(f"\t{line}\n")
            for node in builder._shader_stacks.get(name, []):
                f.write("\tyafaray_paramsPushList(yi);\n")
                for line in c_pm(node):
                    f.write(f"\t{line}\n")
            if builder._shader_stacks.get(name):
                f.write("\tyafaray_paramsEndList(yi);\n")
            f.write(f'\tyafaray_createMaterial(yi, "{name}");\n')
        for name in builder.light_order:
            f.write("\tyafaray_paramsClearAll(yi);\n")
            for line in c_pm(builder.lights[name]):
                f.write(f"\t{line}\n")
            f.write(f'\tyafaray_createLight(yi, "{name}");\n')
        for name, obj in builder.objects.items():
            f.write("\tyafaray_paramsClearAll(yi);\n")
            f.write(f'\tyafaray_createObject(yi, "{name}");\n')
            for v in obj.vertices:
                f.write(f"\tyafaray_addVertex(yi, {v[0]}, {v[1]}, {v[2]});\n")
            for fc in obj.faces:
                f.write(f"\tyafaray_addTriangle(yi, {fc[0]}, {fc[1]}, "
                        f"{fc[2]});\n")
        for name, pm in builder.cameras.items():
            f.write("\tyafaray_paramsClearAll(yi);\n")
            for line in c_pm(pm):
                f.write(f"\t{line}\n")
            f.write(f'\tyafaray_createCamera(yi, "{name}");\n')
        if builder.background_params is not None:
            f.write("\tyafaray_paramsClearAll(yi);\n")
            for line in c_pm(builder.background_params):
                f.write(f"\t{line}\n")
            f.write('\tyafaray_defineBackground(yi);\n')
        f.write("\tyafaray_render(yi, NULL, NULL, "
                "YAFARAY_DISPLAY_CONSOLE_NORMAL);\n"
                "\tyafaray_destroyInterface(yi);\n"
                "\treturn 0;\n}\n")
