"""XML scene importer — the yafaray-xml client analogue.

Counterpart of `libyafaray_tpu/io/import_xml.py`: a document either
package's `export_xml` writes loads into this package's SceneBuilder with
the same staged state.

The reference ships XML parsing as a separate client (yafaray-xml) that
replays a scene document through the C API; our exporter
(io/export.py export_xml, the ExportXml analogue —
src/interface/export/export_xml.cc) writes the same dialect. This module
closes the loop: `load_xml(path)` parses a scene document and replays it
into a SceneBuilder, so exported scenes round-trip and reference-style
XML scenes can be loaded directly.

Element model (matching export_xml.cc:207 writeParamMap):
  <texture|material|light|camera|background|volumeregion|render name="...">
      <param ival|fval|sval|bval=.../>            scalar params
      <param x= y= z= [w=]/>                      vectors
      <param r= g= b= [a=]/>                      colors
      <param m00=..m33=/>                         4x4 matrices
      <list_element>...</list_element>            shader-node stacks
  <object name="..."> <mesh vertices= faces=> <p/> <uv/> <f/> </mesh>
  <instance base_object_name="..." m00=..m33=/>
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Any, Dict, List

import numpy as np


def _parse_param(el: ET.Element) -> Any:
    a = el.attrib
    if "ival" in a:
        return int(a["ival"])
    if "fval" in a:
        return float(a["fval"])
    if "bval" in a:
        return a["bval"].strip().lower() in ("true", "1", "yes")
    if "sval" in a:
        return a["sval"]
    if "m00" in a:
        return np.asarray([[float(a[f"m{i}{j}"]) for j in range(4)]
                           for i in range(4)], np.float32)
    if "r" in a and "g" in a and "b" in a:
        vals = [float(a["r"]), float(a["g"]), float(a["b"])]
        if "a" in a:
            vals.append(float(a["a"]))
        return np.asarray(vals, np.float32)
    if "x" in a and "y" in a and "z" in a:
        return np.asarray([float(a["x"]), float(a["y"]), float(a["z"])],
                          np.float32)
    if "u" in a and "v" in a:
        return np.asarray([float(a["u"]), float(a["v"])], np.float32)
    if "sval" in a:
        return a["sval"]
    raise ValueError(f"unparseable xml param <{el.tag} {a}>")


def _parse_params(el: ET.Element) -> Dict[str, Any]:
    pm: Dict[str, Any] = {}
    for child in el:
        if child.tag in ("list_element", "mesh"):
            continue
        pm[child.tag] = _parse_param(child)
    return pm


def load_xml(path: str, builder=None):
    """Parse a scene XML document into a SceneBuilder (new one unless an
    existing builder is passed). Returns the builder; call
    `builder.compile(camera_name)` to get the device scene."""
    if builder is None:
        from ..scene import SceneBuilder
        builder = SceneBuilder()
    root = ET.parse(path).getroot()
    for el in root:
        tag = el.tag
        name = el.attrib.get("name", "")
        if tag == "texture":
            builder.create_texture(name, _parse_params(el))
        elif tag == "material":
            nodes: List[Dict[str, Any]] = []
            for le in el.findall("list_element"):
                nodes.append(_parse_params(le))
            builder.create_material(name, _parse_params(el),
                                    node_list=nodes or None)
        elif tag == "light":
            builder.create_light(name, _parse_params(el))
        elif tag == "camera":
            builder.create_camera(name, _parse_params(el))
        elif tag == "background":
            builder.create_background(_parse_params(el))
        elif tag == "volumeregion":
            builder.create_volume_region(name, _parse_params(el))
        elif tag == "render":
            builder.set_render_params(_parse_params(el))
        elif tag == "instance":
            a = el.attrib
            mtx = np.asarray([[float(a[f"m{i}{j}"]) for j in range(4)]
                              for i in range(4)], np.float32)
            builder.add_instance(a["base_object_name"], mtx)
        elif tag == "object":
            pm = _parse_params(el)
            mesh = el.find("mesh")
            if mesh is None:
                # sphere/curve-style object: scalar params at top level
                builder.create_object(name, pm)
                continue
            builder.create_object(name, pm)
            verts, uvs, faces, fuvs, fmats = [], [], [], [], []
            for child in mesh:
                a = child.attrib
                if child.tag == "p":
                    verts.append((float(a["x"]), float(a["y"]),
                                  float(a["z"])))
                elif child.tag == "uv":
                    uvs.append((float(a["u"]), float(a["v"])))
                elif child.tag == "f":
                    faces.append((int(a["a"]), int(a["b"]), int(a["c"])))
                    fuvs.append((int(a.get("uv_a", -1)),
                                 int(a.get("uv_b", -1)),
                                 int(a.get("uv_c", -1))))
                    fmats.append(int(a.get("mat", 0)))
            builder.add_mesh_arrays(
                np.asarray(verts, np.float32).reshape(-1, 3),
                np.asarray(faces, np.int32).reshape(-1, 3),
                uvs=(np.asarray(uvs, np.float32).reshape(-1, 2)
                     if uvs else None),
                face_uvs=(np.asarray(fuvs, np.int32).reshape(-1, 3)
                          if uvs else None),
                face_mats=np.asarray(fmats, np.int32))
    return builder
