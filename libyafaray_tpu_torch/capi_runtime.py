"""Render helper called by the port's C API library
(`native/yafaray_tpu_c_api.cc` of this package).

Counterpart of `libyafaray_tpu/capi_runtime.py`. Entry point
`render_for_capi(builder, render_params, outputs, layers, pass_cb)`,
mirroring the reference's Interface::setupRender + render sequence
(interface.cc:325-334 -> Scene::render scene.cc:203-263): parses the staged
render ParamMap, compiles the scene per render view, renders every view,
resolves the requested AOV layers and writes every named output
(ImageFilm::flush -> ImageOutput, imagefilm.cc:570-670).

Returns (views, combined, resx, resy) where views is an ordered dict
{view_name: {layer_name: float32 ndarray [H,W,4]}} on the host — the C++
layer walks it to fire the notifyView/notifyLayer/putPixel/flushArea/flush
callbacks — and combined is the first view's combined layer.

`pass_cb(done, total, tag) -> bool` is invoked once per sample pass; a False
return cancels the render (yafaray_cancelRendering analogue of
RenderControl::setCanceled checked in the pass loop).

The device: the render param "device" (this package's own key; the JAX
package has no such key) names the torch device the scene is compiled and
rendered on, "cuda" when absent. It is the only way a C client names the
device: `yafaray_paramsSetString(yi, "device", "cpu")` before
`yafaray_setupRender`. The JAX module's persistent XLA compile cache has no
counterpart here: eager torch compiles nothing per process.
"""
from __future__ import annotations

import numpy as np

from . import film as F
from . import params as P
from .integrators.mc import make_integrator
from .render import AAParams, render
from .utils.logger import RenderControl

DEFAULT_DEVICE = "cuda"


def _aa_params(pm: P.ParamMap) -> AAParams:
    return AAParams(
        aa_samples=pm.get_int("AA_minsamples", 4),
        aa_passes=pm.get_int("AA_passes", 1),
        aa_inc_samples=pm.get_int("AA_inc_samples", 1),
        threshold=pm.get_float("AA_threshold", 0.05),
        dark_detection_type=pm.get_string("AA_dark_detection_type", "none"),
        dark_threshold_factor=pm.get_float("AA_dark_threshold_factor", 0.0),
        detect_color_noise=pm.get_bool("AA_detect_color_noise", False),
        variance_edge_size=pm.get_int("AA_variance_edge_size", 10),
        variance_pixels=pm.get_int("AA_variance_pixels", 0),
    )


def _pad4(img) -> np.ndarray:
    """Pad a resolved layer to RGBA float32 [H,W,4] on the host for the C
    ABI."""
    if not isinstance(img, np.ndarray):
        img = img.detach().cpu().numpy()
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[-1]
    if c == 4:
        return np.ascontiguousarray(img)
    out = np.ones(img.shape[:2] + (4,), np.float32)
    if c == 1:
        out[..., 0] = out[..., 1] = out[..., 2] = img[..., 0]
    else:
        out[..., :c] = img
    return out


def render_for_capi(builder, render_params: dict, outputs=None, layers=None,
                    pass_cb=None):
    pm = P.ParamMap(render_params or {})
    builder.set_render_params(dict(pm))
    device = pm.get_string("device", DEFAULT_DEVICE)

    integ_pm = {k[len("integrator_"):]: v for k, v in pm.items()
                if k.startswith("integrator_")}
    integ_pm.setdefault("type", pm.get_string("integrator_type",
                                              "pathtracing"))
    if "raydepth" in pm:
        integ_pm.setdefault("raydepth", pm.get_int("raydepth", 4))
    cfg = make_integrator(integ_pm)

    # requested AOV layers (yafaray_defineLayer staging)
    layer_names = ["combined"]
    for lp in (layers or []):
        lpm = P.ParamMap(lp)
        name = lpm.get_string("type", "")
        if name and name in F.LAYER_CHANNELS and name not in layer_names:
            layer_names.append(name)

    control = RenderControl()

    def progress(done, total):
        if pass_cb is not None and not pass_cb(int(done), int(total), "pass"):
            control.set_canceled()

    # view list: declared render views, else one implicit view per the
    # staged camera (Scene::render's per-view loop, scene.cc:227-259)
    view_names = list(getattr(builder, "render_views", {}).keys())
    views_out = {}
    resx = resy = 0
    first_combined = None
    for view in (view_names or [""]):
        if view:
            scene = builder.compile_view(view, device=device)
        else:
            scene = builder.compile(pm.get_string("camera_name", "") or None,
                                    device=device)
        width = pm.get_int("width", scene.camera.resx)
        height = pm.get_int("height", scene.camera.resy)
        film = render(
            scene, cfg, width, height, aa=_aa_params(pm),
            layer_names=tuple(layer_names),
            flt_kind=pm.get_string("filter_type", "box"),
            flt_width=pm.get_float("AA_pixelwidth", 1.0),
            computer_node=pm.get_int("adv_computer_node", 0),
            film_path=pm.get_string("film_path", "") or None,
            film_load_save_mode=pm.get_string("film_load_save_mode", "none"),
            progress_cb=progress, render_control=control, device=device)
        resolved = {}
        for name in layer_names:
            resolved[name] = _pad4(F.resolve(film, name))
        views_out[view or "view0"] = resolved
        if first_combined is None:
            first_combined = resolved["combined"]
            resx, resy = int(width), int(height)
        # named outputs (ImageOutput flush): each with its own path,
        # color space and gamma (image_output.cc)
        from .io import save_image
        for name, opm in (outputs or []):
            opm = P.ParamMap(opm)
            path = opm.get_string("image_path", "")
            if not path:
                continue
            if len(views_out) > 1 or (view and view_names[0] != view):
                stem, dot, ext = path.rpartition(".")
                path = f"{stem}_{view}{dot}{ext}" if dot else f"{path}_{view}"
            lay = opm.get_string("layer", "combined")
            img_out = resolved.get(lay, resolved["combined"])
            if opm.get_bool("denoise_enabled", False):
                # ImageOutput denoise (image_output.cc:90-93 DenoiseParams)
                from .io.postprocess import denoise
                img_out = denoise(img_out,
                                  hlum=opm.get_float("denoise_h_lum", 3.0),
                                  hcol=opm.get_float("denoise_h_col", 3.0),
                                  mix=opm.get_float("denoise_mix", 0.8))
            save_image(path, img_out,
                       color_space=opm.get_string("color_space", "sRGB"),
                       gamma=opm.get_float("gamma", 1.0))
        if control.canceled:
            break
    return views_out, first_combined, resx, resy
