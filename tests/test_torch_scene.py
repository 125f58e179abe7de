"""The port's SceneBuilder against the JAX compile: the same tables, and
NotImplementedError for what neither package carries (true instances on
the brute-force path)."""
import inspect

import jax
import numpy as np
import pytest
import torch

import libyafaray_tpu_torch as P
from libyafaray_tpu_torch.convert import scene_from_numpy
from libyafaray_tpu_torch.scenes import bigmesh_builder as port_bigmesh
from libyafaray_tpu_torch.scenes import cornell_builder as port_cornell
from scenes import bigmesh_builder, cornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401

GEOM = ("vertices", "normals", "uvs", "faces", "face_uvs", "face_mat",
        "face_obj", "face_smooth", "face_light", "face_vis", "tri_table")
MATS = ("mat_type", "diffuse_color", "glossy_color", "mirror_color",
        "emit_color", "specular_refl", "transparency", "translucency",
        "diffuse_reflect", "glossy_reflect", "exponent", "exp_u", "exp_v",
        "ior", "mat_flags")
LIGHTS = ("light_type", "position", "direction", "color", "edge1", "edge2",
          "area", "flags", "samples", "cos_start")
CAMERA = ("origin", "cam_x", "cam_y", "cam_z", "focal", "aspect")


def _variant(b, name):
    """Apply one variant to a Cornell builder (JAX or port: same API)."""
    if name == "lamp_invisible":
        b.lights["lamp"]["visibility"] = "invisible"
    elif name == "materials":
        b.create_material("shiny", {
            "type": "shinydiffusemat", "color": (0.2, 0.4, 0.6),
            "specular_reflect": 0.3, "transparency": 0.2,
            "translucency": 0.25, "diffuse_reflect": 0.9, "emit": 0.5,
            "fresnel_effect": True, "IOR": 1.6,
            "mirror_color": (0.9, 0.8, 0.7),
            "transmit_filter": (0.5, 0.6, 0.7),
            "transmit_filter_strength": 0.5})
        b.create_object("extra", {"visibility": "no_shadows"})
        b.set_current_material("shiny")
        verts = np.array([[0.1, 0.1, 0.2], [0.4, 0.1, 0.2], [0.4, 0.3, 0.5],
                          [0.1, 0.3, 0.5]], np.float32)
        normals = verts / np.linalg.norm(verts, axis=1, keepdims=True)
        b.add_mesh_arrays(verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                          uvs=verts[:, :2], face_uvs=[[0, 1, 2], [0, 2, 3]],
                          normals=normals)
        b.create_object("smooth", {"visibility": "shadow_only"})
        i = [b.add_vertex(*v) for v in ((0.6, 0.6, 0.1), (0.8, 0.6, 0.1),
                                        (0.7, 0.8, 0.3))]
        b.add_triangle(*i)
        b.smooth_mesh()
    elif name == "glossy":
        b.create_material("gloss", {
            "type": "glossy", "color": (0.7, 0.6, 0.3),
            "diffuse_color": (0.2, 0.3, 0.4), "glossy_reflect": 0.8,
            "diffuse_reflect": 0.6, "exponent": 120.0, "IOR": 1.7,
            "mirror_color": (0.9, 0.8, 0.7)})
        b.create_material("aniso", {
            "type": "glossy", "anisotropic": True, "exp_u": 20.0,
            "exp_v": 300.0, "as_diffuse": False})
        b.create_object("gbox")
        for mat, z in (("gloss", 0.2), ("aniso", 0.4)):
            b.set_current_material(mat)
            i = [b.add_vertex(*v) for v in ((0.2, 0.2, z), (0.4, 0.2, z),
                                            (0.3, 0.4, z))]
            b.add_triangle(*i)
    elif name == "lights":
        b.create_light("lamp2", {
            "type": "arealight", "corner": (0.1, 0.1, 0.9),
            "point1": (0.1, 0.3, 0.9), "point2": (0.3, 0.1, 0.9),
            "color": (0.5, 0.5, 1.0), "power": 3.0, "samples": 4,
            "cast_shadows": False, "light_enabled": False})
        b.set_render_params({"shadow_bias": 1e-3, "ray_min_dist": 1e-4})
        b.create_background({"type": "constant", "color": (0.1, 0.2, 0.3),
                             "power": 2.0})
        b.cameras["cam"].update({"resx": 40, "resy": 30, "fov": 50.0,
                                 "aspect_ratio_factor": 1.2})
    elif name == "no_background":
        b.background_params = None
    return b


def _assert_same(got, want, fields, what):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if g is None or w is None:      # a column the table's kind lacks
            assert g is None and w is None, (what, f)
            continue
        assert g.dtype == w.dtype, (what, f, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{what}.{f}")


@pytest.mark.parametrize("variant", ["cornell", "lamp_invisible", "materials",
                                     "lights", "glossy", "no_background"])
def test_compile_matches_jax_tables(variant):
    js = _variant(cornell_builder(), variant).compile("cam")
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    got = _variant(port_cornell(), variant).compile("cam", device="cpu")
    _assert_same(got.geom, want.geom, GEOM, "geom")
    _assert_same(got.materials, want.materials, MATS, "materials")
    _assert_same(got.lights, want.lights, LIGHTS, "lights")
    _assert_same(got.camera, want.camera, CAMERA, "camera")
    _assert_same(got.background, want.background, ("color", "power"),
                 "background")
    _assert_same(got, want, ("shadow_bias", "ray_min_dist"), "scene")
    for part, fields in (("geom", ("num_faces", "num_spheres")),
                         ("materials", ("has_fresnel", "has_aniso",
                                        "present_types")),
                         ("lights", ("num_lights", "present_types",
                                     "samples_static")),
                         ("camera", ("kind", "resx", "resy")),
                         ("background", ("kind",))):
        for f in fields:
            assert (getattr(getattr(got, part), f)
                    == getattr(getattr(want, part), f)), (part, f)
    assert got.accel_kind == want.accel_kind == "brute"
    assert got.has_cam_invisible == want.has_cam_invisible
    if variant == "cornell":
        # 34 wall and box triangles plus the lamp's 2-triangle quad
        assert got.geom.num_faces == 36
        assert tuple(got.geom.tri_table.shape) == (64, 16)


def test_terrain_compile_matches_jax_tables():
    """BASELINE config 3 untextured at 2048 faces: the block accelerator's
    tables, the sun and the background light equal the JAX compile's."""
    js = bigmesh_builder(33, textured=False).compile("cam")
    want = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    got = port_bigmesh(33, textured=False).compile("cam", device="cpu")
    _assert_same(got.geom, want.geom, GEOM, "geom")
    _assert_same(got.materials, want.materials, MATS, "materials")
    _assert_same(got.lights, want.lights, LIGHTS, "lights")
    _assert_same(got.camera, want.camera, CAMERA, "camera")
    _assert_same(got.background, want.background, ("color", "power"),
                 "background")
    _assert_same(got.blocks, want.blocks, ("tab", "bmin", "bmax"), "blocks")
    assert got.accel_kind == want.accel_kind == "blocks"
    for f in ("num_lights", "bg_light_idx", "present_types",
              "samples_static"):
        assert getattr(got.lights, f) == getattr(want.lights, f), f
    assert (got.blocks.block_size, got.blocks.num_blocks) == (
        want.blocks.block_size, want.blocks.num_blocks) == (128, 16)
    assert got.geom.num_faces == 2048 and got.lights.bg_light_idx == 1
    assert tuple(got.geom.tri_table.shape) == (2048, 16)


def test_scene_to_moves_every_tensor():
    scene = port_cornell().compile("cam", device="cpu").to("meta")

    def walk(obj):
        for v in vars(obj).values():
            if isinstance(v, torch.Tensor):
                assert v.device.type == "meta"
            elif hasattr(v, "__dataclass_fields__"):
                walk(v)

    walk(scene)
    assert scene.geom.tri_table.device.type == "meta"
    blocks = port_bigmesh(33, textured=False).compile(
        "cam", device="cpu").to("meta").blocks
    assert all(x.device.type == "meta"
               for x in (blocks.tab, blocks.bmin, blocks.bmax))


def test_compile_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """compile() with no device asks for "cuda" (the `.to` target is
    recorded and answered on the CPU, so this runs without a card)."""
    asked = []
    real_to = P.scene_types._Table.to

    def to(self, device):
        asked.append(device)
        return real_to(self, "cpu")

    monkeypatch.setattr(P.scene_types._Table, "to", to)
    scene = port_cornell().compile("cam")
    # the nested tables are moved by the recorded call itself, to "cpu"
    assert {a for a in asked if a != "cpu"} == {"cuda"}
    assert scene.geom.vertices.device.type == "cpu"
    assert inspect.signature(P.SceneBuilder.compile).parameters[
        "device"].default == "cuda"


def _bvh(b):
    b.set_render_params({"scene_accelerator": "bvh"})
    scene = b.compile("cam", device="cpu")
    assert scene.accel_kind == "bvh" and scene.bvh.num_nodes == 2 * 36 - 1


def _big_mesh(b):
    # a mesh above the JAX kernel's 16384 faces, forced onto brute force
    b.set_render_params({"scene_accelerator": "brute"})
    b.create_object("grid")
    n = 92
    xs = np.linspace(0, 1, n, dtype=np.float32)
    xx, yy = np.meshgrid(xs, xs)
    verts = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3)
    i = np.arange(n * n).reshape(n, n)
    a, b2, c, d = (i[:-1, :-1].ravel(), i[1:, :-1].ravel(),
                   i[1:, 1:].ravel(), i[:-1, 1:].ravel())
    faces = np.concatenate([np.stack([a, b2, c], -1), np.stack([a, c, d], -1)])
    b.add_mesh_arrays(verts, faces)     # 16562 faces
    scene = b.compile("cam", device="cpu")
    assert scene.accel_kind == "brute" and scene.geom.num_faces == 16598
    assert tuple(scene.geom.tri_table.shape) == (16640, 16)


def _true_instances_on_the_brute_path(b):
    # 36 + 12 faces compile to the brute-force path, which does not expand
    # true instances (nor does the JAX package's)
    b.set_render_params({"instancing": "true"})
    b.add_instance("box1", np.eye(4))
    scene = b.compile("cam", device="cpu")
    assert scene.accel_kind == "brute" and scene.geom.inst_mat is not None
    P.ops.intersect.closest_hit(scene, torch.zeros((1, 3)),
                                torch.tensor([[0.0, 1.0, 0.0]]), 1e-4, 1e30)


def _sphere_instance(b):
    # an instance of a sphere is baked, as in the JAX compile
    b.create_object("ball", {"type": "sphere", "radius": 0.1})
    b.add_instance("ball", np.eye(4))
    scene = b.compile("cam", device="cpu")
    assert scene.geom.num_spheres == 2


# each case and the feature its NotImplementedError must name; None for the
# features that raised until the accelerator slice ported them (the LBVH,
# brute force above 16,384 faces, instances of spheres), which now compile
_UNPORTED = [
    (_bvh, None),
    (_big_mesh, None),
    (_sphere_instance, None),
    (_true_instances_on_the_brute_path, "does not expand true instances"),
]


@pytest.mark.parametrize("case,reason", [
    pytest.param(case, reason, id=case.__name__[1:])
    for case, reason in _UNPORTED])
def test_features_outside_the_port_raise(case, reason):
    """Each case still outside the port raises NotImplementedError naming
    its own feature, not another one on the way; each ported case compiles
    to its accelerator."""
    if reason is None:
        case(port_cornell())
        return
    with pytest.raises(NotImplementedError, match=reason):
        case(port_cornell())


@pytest.mark.parametrize("pm", [
    {"type": "directlighting", "do_AO": True, "AO_samples": 4},
    {"type": "debug"}, {"type": "DebugIntegrator"},
    {"type": "photonmapping"}, {"type": "SPPM"}, {"type": "bidirectional"}],
    ids=["ao", "debug", "DebugIntegrator", "photonmapping", "SPPM",
         "bidirectional"])
def test_ported_integrator_options_construct(pm):
    """Ambient occlusion and the debug integrator, which raised before the
    render loop's slice, and the photon-mapping, SPPM and bidirectional
    integrators, which raised before the integrators' slice, now parse
    into the config."""
    cfg = P.make_integrator(pm)
    assert cfg.kind == pm["type"]
    assert cfg.use_ao == pm.get("do_AO", False)
    assert cfg.ao_samples == pm.get("AO_samples", 8)


def test_unknown_types_raise_key_error():
    b = port_cornell()
    with pytest.raises(KeyError):
        b.create_material("x", {"type": "no_such_material"})
    with pytest.raises(KeyError):
        b.create_light("x", {"type": "no_such_light"})
    with pytest.raises(KeyError):
        P.make_integrator({"type": "no_such_integrator"})


def test_converting_an_unported_jax_scene_raises():
    # the JAX package's LBVH, which raised until the accelerator slice,
    # converts: the port's own compile gives the same tree
    b = cornell_builder()
    b.set_render_params({"scene_accelerator": "bvh"})
    js = b.compile("cam")
    assert js.accel_kind == "bvh"
    got = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js))
    pb = port_cornell()
    pb.set_render_params({"scene_accelerator": "bvh"})
    want = pb.compile("cam", device="cpu")
    assert got.accel_kind == want.accel_kind == "bvh"
    _assert_same(got.bvh, want.bvh, ("node_min", "node_max", "node_left",
                                     "node_right", "node_is_leaf",
                                     "prim_order"), "bvh")
