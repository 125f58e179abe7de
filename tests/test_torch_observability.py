"""Observability and the small modules of the port against the JAX package:
`render(..., stats=)` and `utils.profiling` (RenderStats, trace,
device_op_summary), `utils.logger` (Logger, Timer, ProgressBar),
`utils.sysinfo`, `io.postprocess.draw_text` / `draw_badge`, the rest of
`color` and `math.mat4`.

The JAX render with stats runs once for the module. The logger's, the
timer's and the progress bar's outputs are compared with the clock fixed
(`time.time` patched for both packages), so files, console lines and
callbacks must be equal exactly. The badge is compared exactly, with Pillow
(its default font) and with the 5x7 bitmap font alone. Colour functions and
transforms within 1e-6.
"""
import io as _io
import itertools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libyafaray_tpu import color as JC
from libyafaray_tpu import make_integrator as jmake_integrator
from libyafaray_tpu.io import postprocess as JP
from libyafaray_tpu.math import mat4 as JM
from libyafaray_tpu.render import render as jrender
from libyafaray_tpu.utils import logger as JL
from libyafaray_tpu.utils import sysinfo as JSI
from libyafaray_tpu.utils.profiling import RenderStats as JRenderStats
from libyafaray_tpu_torch import AAParams, color as C
from libyafaray_tpu_torch import make_integrator, render
from libyafaray_tpu_torch.io import postprocess as P
from libyafaray_tpu_torch.math import mat4 as M
from libyafaray_tpu_torch.scenes import cornell_builder
from libyafaray_tpu_torch.utils import logger as L
from libyafaray_tpu_torch.utils import profiling as PF
from libyafaray_tpu_torch.utils import sysinfo as SI
from scenes import cornell_builder as jcornell_builder
from test_torch_foundations import one_torch_thread  # noqa: F401

RES, SPP = 16, 3        # tests/test_subsystems.py::test_render_stats_profiling
DL = {"type": "directlighting"}


def _scene(res=RES):
    b = cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
    return b.compile("cam", device="cpu")


# --------------------------------------------------------- render stats

@pytest.fixture(scope="module")
def stats():
    """(the JAX package's stats, the port's) of the same render."""
    b = jcornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = RES
    want = JRenderStats()
    jrender(b.compile("cam"), jmake_integrator(DL), spp=SPP, stats=want)
    got = PF.RenderStats()
    render(_scene(), make_integrator(DL), spp=SPP, stats=got, device="cpu")
    return want, got


def test_render_stats_count_as_jax(stats):
    want, got = stats
    assert len(got.pass_times) == len(want.pass_times) == SPP
    assert got.pass_rays == want.pass_rays == [RES * RES] * SPP
    assert got.total_rays == want.total_rays
    assert got.rays_per_sec > 0
    assert got.get_time("rendert") >= 0.5 * got.total_time
    assert set(got.events) == set(want.events) == {"rendert"}


def test_render_stats_summary_lines(stats):
    want, got = stats
    s, w = got.summary().splitlines(), want.summary().splitlines()
    assert [x.split(":")[0] for x in s] == [x.split(":")[0] for x in w]
    assert s[0] == w[0] == f"passes: {SPP}"
    assert s[2] == w[2] == f"camera rays: {SPP * RES * RES}"


def test_render_stats_count_the_adaptive_passes():
    """An adaptive pass counts the rays of the pixels it resamples."""
    aa = AAParams(aa_samples=2, aa_passes=3, aa_inc_samples=1,
                  threshold=0.05)
    st = PF.RenderStats()
    sc = _scene(8)
    film = render(sc, make_integrator(DL), aa=aa, stats=st, device="cpu")
    assert st.pass_rays[:2] == [64, 64]
    assert len(st.pass_rays) == 4 and 0 < min(st.pass_rays[2:]) <= 64
    assert float(film.weights.sum()) == sum(st.pass_rays)


# ------------------------------------------------------------ profiler

@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace"))
    sc = _scene(8)
    with PF.trace(d, device="cpu") as tr:
        render(sc, make_integrator(DL), spp=1, device="cpu")
    return d, tr.path


def test_trace_writes_a_chrome_trace(traced):
    d, path = traced
    assert path.startswith(d) and path.endswith(".pt.trace.json")


def test_device_op_summary_of_a_cpu_pass(traced):
    d, _ = traced
    top = PF.device_op_summary(d, top=10, exclude_host=False)
    assert 0 < len(top) <= 10
    totals = [t for _, t, _ in top]
    assert totals == sorted(totals, reverse=True)
    assert all(isinstance(n, str) and n and c > 0 and t >= 0
               for n, t, c in top)
    # a trace of the host alone has no device events
    assert PF.device_op_summary(d) == []


# -------------------------------------------------------------- logger

def _fixed_clock(monkeypatch, start=1_700_000_000.0, step=0.25):
    clock = itertools.count()
    monkeypatch.setattr(time, "time", lambda: start + step * next(clock))


def _log_session(mod, tmp, tag, monkeypatch):
    _fixed_clock(monkeypatch)
    calls = []
    log = mod.Logger(console_level=mod.LOG_PARAMS,
                     memory_level=mod.LOG_VERBOSE, colors=(tag == "c"))
    log.set_callback(lambda lv, ts, text: calls.append((lv, ts, text)))
    log.error("bad ", 1)
    log.warning("careful")
    log.params("spp=", 16)
    log.info("rendering <b>")
    log.verbose("detail")
    log.debug("hidden")
    txt, html = tmp / f"{tag}.txt", tmp / f"{tag}.html"
    log.save_txt_log(str(txt))
    log.save_html_log(str(html))
    entries = list(log.entries)
    log.clear()
    return entries, calls, txt.read_text(), html.read_text(), log.entries


@pytest.mark.parametrize("colors", [True, False])
def test_logger_matches_jax(tmp_path, monkeypatch, capsys, colors):
    tag = "c" if colors else "n"
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
    want = _log_session(JL, tmp_path / "jax", tag, monkeypatch)
    jax_err = capsys.readouterr().err
    got = _log_session(L, tmp_path / "port", tag, monkeypatch)
    assert capsys.readouterr().err == jax_err
    assert got == want
    assert [lv for _, lv, _ in got[0]] == [1, 2, 3, 4, 5]
    assert L.default_logger.console_level == JL.default_logger.console_level
    assert (L.LOG_MUTE, L.LOG_DEBUG) == (JL.LOG_MUTE, JL.LOG_DEBUG) == (0, 6)


def test_timer_matches_jax(monkeypatch):
    def session(mod):
        _fixed_clock(monkeypatch, start=10.0, step=0.5)
        t = mod.Timer()
        t.start("rendert")
        t.start("prepass")
        t.stop("prepass")
        t.stop("missing")
        out = [t.get_time("rendert"), t.get_time("prepass")]
        t.stop("rendert")
        out.append(t.get_time("rendert"))
        t.reset("prepass")
        return out + [t.get_time("prepass")]
    assert session(L) == session(JL) == [1.5, 0.5, 2.0, 0.0]


def test_progress_bar_matches_jax():
    def session(mod):
        out, calls = _io.StringIO(), []
        bar = mod.ProgressBar(width=20, out=out,
                              callback=lambda *a: calls.append(a))
        bar.init(7, tag="pass")
        for _ in range(9):
            bar.update(1)
        return out.getvalue(), calls
    assert session(L) == session(JL)


# ------------------------------------------------------------- sysinfo

def test_sysinfo_params_as_jax():
    got, want = SI.get_params(), JSI.get_params()
    assert list(got) == list(want)
    for k in ("version", "version_major", "version_minor", "version_patch",
              "git_commit", "architecture", "operating_system", "ram_gb"):
        assert got[k] == want[k], k
    assert "torch" in got["compiler"] and "jax" not in got["compiler"]
    assert got["num_devices"] == str(torch.cuda.device_count())
    assert SI.get_devices() == [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                                for i in range(torch.cuda.device_count())]
    line = SI.sysinfo_string()
    assert line.startswith(f"libyafaray_tpu_torch {got['version']} | ")
    assert line.endswith(got["compiler"])


# ---------------------------------------------------------- the badge

@pytest.fixture(params=["pillow", "bitmap"])
def font(request, monkeypatch):
    if request.param == "bitmap":
        for mod in (JP, P):
            monkeypatch.setattr(mod, "_draw_text_pil", lambda *a: False)
    return request.param


def test_draw_badge_matches_jax(font):
    rng = np.random.default_rng(5)
    img = rng.random((48, 160, 4)).astype(np.float32)
    lines = ["yafaray_tpu_torch 0.1.0", "passes: 3 | 1.25 s", "rays/sec: 9"]
    for kw in ({}, {"position": "top", "scale": 2},
               {"bg_color": (0.2, 0.1, 0.0), "text_color": (1, 0.5, 0)}):
        want = JP.draw_badge(img, lines, **kw)
        got = P.draw_badge(img, lines, **kw)
        np.testing.assert_array_equal(got, want)
        assert not np.array_equal(got, img)


def test_draw_text_matches_jax():
    text = "AZ09 :./-% pxm"
    for scale in (1, 3):
        img = np.zeros((24, 40, 3), np.float32)
        want = JP.draw_text(img.copy(), text, 2, 3, (0.9, 0.2, 0.1), scale)
        got = P.draw_text(img.copy(), text, 2, 3, (0.9, 0.2, 0.1), scale)
        np.testing.assert_array_equal(got, want)
        assert got.max() > 0     # clipped at the right edge, not dropped
    for ch in "09AZs ?":
        np.testing.assert_array_equal(P._glyph(ch), JP._glyph(ch))


# -------------------------------------------------------------- colour

def _rgb(n=4096, c=3, lo=-0.1, hi=2.0):
    rng = np.random.default_rng(11)
    x = rng.uniform(lo, hi, (n, c)).astype(np.float32)
    x[:4, :3] = [[0, 0, 0], [1, 1, 1], [0.0031308, 0.04045, 0.5],
                 [1e-4, 1e-7, 4.0]][:4]
    return x


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_color_functions_match_jax():
    x = _rgb()
    for name in ("luminance", "energy", "max_component", "linear_to_xyz",
                 "xyz_to_linear"):
        _close(getattr(C, name)(torch.from_numpy(x)).numpy(),
               np.asarray(getattr(JC, name)(jnp.asarray(x))))


def test_color_spaces_match_jax():
    x = _rgb()
    for cs, g in ((C.SRGB, 1.0), (C.XYZ_D65, 1.0), (C.LINEAR_RGB, 2.2),
                  (C.RAW_MANUAL_GAMMA, 1.0), (C.RAW_MANUAL_GAMMA, 2.2)):
        for name in ("to_output_space", "from_input_space"):
            _close(getattr(C, name)(torch.from_numpy(x), cs, g).numpy(),
                   np.asarray(getattr(JC, name)(jnp.asarray(x), cs, g)))


def test_color_pairs_match_jax():
    a, b = _rgb(c=4), _rgb(c=4, lo=0.0, hi=1.0)[::-1].copy()
    _close(C.color_difference(torch.from_numpy(a),
                              torch.from_numpy(b)).numpy(),
           np.asarray(JC.color_difference(jnp.asarray(a), jnp.asarray(b))))
    _close(C.premultiply_alpha(torch.from_numpy(a)).numpy(),
           np.asarray(JC.premultiply_alpha(jnp.asarray(a))))
    assert C.COLOR_SPACE_NAMES == JC.COLOR_SPACE_NAMES


# -------------------------------------------------------------- mat4

def _affine():
    """A well-conditioned affine matrix of each package, built the same
    way: scale, rotations and a translation."""
    ops = (("scale", ([1.5, 0.5, 2.0],)), ("rotate_x", (0.3,)),
           ("rotate_y", (-1.2,)), ("rotate_z", (2.5,)),
           ("translate", ([0.1, -2.0, 3.0],)))
    jm, tm = np.eye(4, dtype=np.float32), torch.eye(4)
    for name, args in ops:
        jm = np.asarray(getattr(JM, name)(*args)) @ jm
        tm = getattr(M, name)(*args, device="cpu") @ tm
    return jm, tm


def test_mat4_constructors_match_jax():
    for name, args in (("translate", ([1.0, -2.5, 3.25],)),
                       ("scale", (2.0,)), ("scale", ([1.0, 2.0, 3.0],)),
                       ("rotate_x", (0.7,)), ("rotate_y", (-2.1,)),
                       ("rotate_z", (1e-3,))):
        got = getattr(M, name)(*args, device="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _close(got.numpy(), np.asarray(getattr(JM, name)(*args)))
    assert M.rotate_z(0.5, device="cpu", dtype=torch.float64).dtype == \
        torch.float64


def test_mat4_transforms_match_jax():
    jm, tm = _affine()
    _close(tm.numpy(), jm)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((256, 3)).astype(np.float32)
    jinv = np.asarray(JM.inverse(jnp.asarray(jm)))
    inv = M.inverse(tm)
    np.testing.assert_allclose(inv.numpy(), jinv, rtol=1e-5, atol=1e-6)
    for name, jmat, tmat in (("transform_point", jm, tm),
                             ("transform_vector", jm, tm),
                             ("transform_normal", jinv, inv)):
        want = np.asarray(getattr(JM, name)(jnp.asarray(jmat),
                                            jnp.asarray(p)))
        got = getattr(M, name)(tmat, torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(M.IDENTITY, JM.IDENTITY)
