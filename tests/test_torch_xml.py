"""The port's scene export (`io/export.py`) and XML import
(`io/import_xml.py`) against the JAX package's.

Each scene is staged the same way in both packages' SceneBuilders (the
port's builder functions fill either): the Cornell box with render
params and a render view, the box with a procedural texture bound through
a shader node, a mesh with UVs and a sphere, and the box with an instance.
Held: `export_xml` and `export_c` byte for byte, `export_python` line for
line but its header (which imports the port), the same exception where the
JAX exporter fails (an instance's list of matrices in `export_xml` and
`export_python`); `load_xml` of a JAX-written document leaves the builder
state JAX's `load_xml` leaves (registries equal, arrays equal); a round
trip through the port's XML compiles to the same tables and renders bit
for bit, on the CPU.
"""
import functools

import numpy as np
import pytest
import torch

from libyafaray_tpu import SceneBuilder as JSceneBuilder
from libyafaray_tpu.io import export as JE
from libyafaray_tpu.io import import_xml as JX
from libyafaray_tpu_torch import film as F
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.io import export as E
from libyafaray_tpu_torch.io import import_xml as X
from libyafaray_tpu_torch.scene import SceneBuilder
from libyafaray_tpu_torch.scenes import bigmesh_builder, cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401


def _cornell(b):
    b = cornell_builder(builder=b)
    b.set_render_params({"scene_accelerator": "brute", "shadow_bias": 5e-4,
                         "AA_minsamples": 2, "integrator_type":
                         "pathtracing", "clamp_rgb": True})
    b.create_render_view("main", {"camera_name": "cam",
                                  "light_names": "lamp"})
    return b


def _textured(b):
    b = cornell_builder(builder=b)
    b.create_texture("clouds", {"type": "clouds", "size": 0.25,
                                "noise_type": "newperlin", "depth": 2})
    b.create_material("cloudy", {"type": "shinydiffusemat",
                                 "color": (0.8, 0.7, 0.6),
                                 "diffuse_shader": "diff"},
                      node_list=[{"element": "shader_node", "name": "diff",
                                  "type": "texture_mapper",
                                  "texture": "clouds", "texco": "uv",
                                  "scale": (2.0, 2.0, 1.0)}])
    b.create_object("slab")
    b.set_current_material("cloudy")
    verts = np.array([[0.2, 0.2, 0.3], [0.6, 0.2, 0.3], [0.6, 0.5, 0.35],
                      [0.2, 0.5, 0.35]], np.float32)
    b.add_mesh_arrays(verts, [[0, 1, 2], [0, 2, 3]], uvs=verts[:, :2] * 2,
                      face_uvs=[[0, 1, 2], [0, 2, 3]])
    b.create_object("ball", {"type": "sphere", "center": (0.7, 0.3, 0.15),
                             "radius": 0.1})
    b.set_current_material("white")
    b.create_volume_region("fog", {"type": "UniformVolume",
                                   "sigma_a": 0.1, "sigma_s": 0.2,
                                   "minX": 0.0, "minY": 0.0, "minZ": 0.0,
                                   "maxX": 1.0, "maxY": 1.0, "maxZ": 0.3})
    return b


def _instance(b):
    b = cornell_builder(builder=b)
    b.set_render_params({"scene_accelerator": "blocks"})
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = (0.1, 0.0, 0.2)
    b.add_instance("box1", m)
    return b


SCENES = {"cornell": _cornell, "textured": _textured, "instance": _instance}
EXPORTERS = {"xml": "export_xml", "c": "export_c", "python": "export_python"}


def _export(module, fn, b, path):
    """(text, None) of an export, or (None, exception) where it raises."""
    try:
        getattr(module, fn)(b, str(path))
    except Exception as e:  # noqa: BLE001 - held against the JAX package's
        return None, e
    return path.read_text(), None


@pytest.mark.parametrize("fmt", list(EXPORTERS))
@pytest.mark.parametrize("scene", list(SCENES))
def test_export_matches_jax(tmp_path, scene, fmt):
    want, jerr = _export(JE, EXPORTERS[fmt], SCENES[scene](JSceneBuilder()),
                         tmp_path / "jax.out")
    got, err = _export(E, EXPORTERS[fmt], SCENES[scene](SceneBuilder()),
                       tmp_path / "port.out")
    if jerr is not None:
        # the JAX exporters fail on an instance's list of matrices
        assert scene == "instance" and fmt in ("xml", "python")
        assert type(err) is type(jerr) and str(err) == str(jerr)
        return
    assert err is None
    if fmt == "python":
        g, w = got.splitlines(), want.splitlines()
        assert g[:2] == ["# generated by libyafaray_tpu_torch export_python",
                         "from libyafaray_tpu_torch import SceneBuilder"]
        assert w[:2] == ["# generated by libyafaray_tpu export_python",
                         "from libyafaray_tpu import SceneBuilder"]
        assert g[2:] == w[2:]
    else:
        assert got == want
    assert len(got) > 1000


def test_exported_python_runs_under_the_port(tmp_path, monkeypatch):
    """The port's export_python script rebuilds the scene through the
    port's SceneBuilder: the same registries, geometry and tables."""
    b = _textured(SceneBuilder())
    E.export_python(b, str(tmp_path / "scene.py"))
    monkeypatch.setattr(SceneBuilder, "compile", functools.partialmethod(
        SceneBuilder.compile, device="cpu"))
    ns = {}
    exec(compile((tmp_path / "scene.py").read_text(), "scene.py", "exec"),
         ns)
    rb = ns["b"]
    assert rb.material_order == b.material_order
    assert rb.texture_order == b.texture_order
    assert {k: dict(v) for k, v in rb.lights.items()} == \
        {k: dict(v) for k, v in b.lights.items()}
    want = b.compile("cam", device="cpu")
    got = ns["scene"]
    for f in ("vertices", "faces", "face_mat", "uvs", "face_uvs", "sph_center",
              "sph_radius"):
        assert torch.equal(getattr(got.geom, f), getattr(want.geom, f)), f
    assert torch.equal(got.materials.diffuse_color,
                       want.materials.diffuse_color)
    assert torch.equal(got.textures.params_f, want.textures.params_f)


def _state(b):
    """A builder's staged state as plain values: registries, orders,
    geometry, instances, render params and views."""
    def pm(d):
        return {k: (np.asarray(v).tolist() if isinstance(v, (np.ndarray,
                                                               tuple))
                    else v) for k, v in d.items()}
    objs = {}
    for name, o in b.objects.items():
        objs[name] = (np.asarray(o.vertices, np.float32).tolist(),
                      np.asarray(o.uvs, np.float32).tolist(),
                      [tuple(map(int, f)) for f in o.faces], o.is_sphere,
                      None if o.sphere_center is None
                      else np.asarray(o.sphere_center).tolist(),
                      float(o.sphere_radius), o.visibility, o.is_base)
    return dict(
        materials={k: pm(v) for k, v in b.materials.items()},
        material_order=list(b.material_order),
        lights={k: pm(v) for k, v in b.lights.items()},
        light_order=list(b.light_order),
        textures={k: pm(v) for k, v in b.textures.items()},
        texture_order=list(b.texture_order),
        stacks={k: [pm(n) for n in v] for k, v in b._shader_stacks.items()},
        cameras={k: pm(v) for k, v in b.cameras.items()},
        background=None if b.background_params is None
        else pm(b.background_params),
        volumes={k: pm(v) for k, v in b.volumes.items()},
        render_params=pm(b.render_params),
        views={k: pm(v) for k, v in b.render_views.items()},
        objects=objs, object_order=list(b.object_order),
        instances=[(n, [np.asarray(m).tolist() for m in ms])
                   for n, ms in b.instances])


@pytest.mark.parametrize("scene", ["cornell", "textured"])
def test_load_xml_matches_jax(tmp_path, scene):
    """A document the JAX package wrote loads into the port's builder with
    the state JAX's load_xml leaves; one instance is added by hand (the
    JAX exporter cannot write it) to hold the importer's instance arm."""
    path = tmp_path / "scene.xml"
    JE.export_xml(SCENES[scene](JSceneBuilder()), str(path))
    text = path.read_text().replace(
        "</scene>", '\t<instance base_object_name="box1" ' + " ".join(
            f'm{i}{j}="{float(i == j) + (0.25 if j == 3 and i < 3 else 0)}"'
            for i in range(4) for j in range(4)) + "/>\n</scene>")
    path.write_text(text)
    want = JX.load_xml(str(path))
    got = X.load_xml(str(path))
    assert isinstance(got, SceneBuilder)
    assert _state(got) == _state(want)
    assert got.instances and got.objects


@pytest.mark.parametrize("scene", ["cornell", "textured"])
def test_xml_round_trip_renders_bit_for_bit(tmp_path, scene):
    """export_xml, then load_xml: the compiled tables and a 16x16, 2 spp
    render on the CPU equal the original builder's bit for bit."""
    b = SCENES[scene](SceneBuilder())
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = 16
    E.export_xml(b, str(tmp_path / "scene.xml"))
    rb = X.load_xml(str(tmp_path / "scene.xml"))
    want = b.compile("cam", device="cpu")
    got = rb.compile("cam", device="cpu")
    for f in ("vertices", "faces", "face_mat", "uvs", "face_uvs", "tri_table"):
        assert torch.equal(getattr(got.geom, f), getattr(want.geom, f)), f
    cfg = make_integrator({"type": "pathtracing", "bounces": 3})
    img = F.resolve(render(got, cfg, spp=2, device="cpu"))
    ref = F.resolve(render(want, cfg, spp=2, device="cpu"))
    assert torch.equal(img, ref) and float(img[..., :3].mean()) > 0


def test_terrain_round_trip_tables(tmp_path):
    """The untextured terrain cut to 2,048 faces (the block accelerator)
    through the port's XML: the block tables equal the original's."""
    b = bigmesh_builder(33, textured=False)
    E.export_xml(b, str(tmp_path / "terrain.xml"))
    rb = X.load_xml(str(tmp_path / "terrain.xml"))
    want = b.compile("cam", device="cpu")
    got = rb.compile("cam", device="cpu")
    assert got.accel_kind == want.accel_kind == "blocks"
    for f in ("tab", "bmin", "bmax"):
        assert torch.equal(getattr(got.blocks, f), getattr(want.blocks, f)), f
    assert torch.equal(got.lights.color, want.lights.color)
    assert got.background.kind == want.background.kind
