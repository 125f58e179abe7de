/* Full-surface C client, mirroring the reference's tests/test00/test00.c
 * (RAM image -> texture -> node material, all render callbacks + logger
 * callback, outputs, extra layers, tables) plus tests/test04/test04.c
 * "changes on the fly": mutate a material between two renders and check the
 * image actually changed. Exits non-zero on any failure.
 *
 *     test05_client [DEVICE [OUTDIR]]
 *
 * DEVICE, when given and not empty, is staged as the render param "device"
 * (for example "cpu"); without it the port renders on the CUDA card. The
 * named output goes to OUTDIR/capi_test05_out.png (OUTDIR defaults to
 * "."). */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "yafaray_tpu_c_api.h"

#define RES 24

static int notify_view_calls = 0;
static int notify_layer_calls = 0;
static long put_pixel_calls = 0;
static int flush_area_calls = 0;
static int flush_calls = 0;
static int highlight_area_calls = 0;
static int progress_calls = 0;
static int logger_calls = 0;
static float cb_pixels[RES * RES * 4];
static const char *device = "";
static char out_path[4096];

static void on_notify_view(const char *view, void *data) {
  (void)view; (void)data;
  ++notify_view_calls;
}
static void on_notify_layer(const char *internal, const char *exported,
                            int w, int h, int c, void *data) {
  (void)internal; (void)exported; (void)data;
  if (w != RES || h != RES || c < 1) {
    fprintf(stderr, "notifyLayer bad dims %dx%dx%d\n", w, h, c);
    exit(10);
  }
  ++notify_layer_calls;
}
static void on_put_pixel(const char *view, const char *layer, int x, int y,
                         float r, float g, float b, float a, void *data) {
  (void)view; (void)data;
  if (strcmp(layer, "combined") == 0 && x >= 0 && x < RES && y >= 0 &&
      y < RES) {
    float *p = cb_pixels + (y * RES + x) * 4;
    p[0] = r; p[1] = g; p[2] = b; p[3] = a;
  }
  ++put_pixel_calls;
}
static void on_flush_area(const char *view, int id, int x0, int y0, int x1,
                          int y1, void *data) {
  (void)view; (void)id; (void)x0; (void)y0; (void)x1; (void)y1; (void)data;
  ++flush_area_calls;
}
static void on_flush(const char *view, void *data) {
  (void)view; (void)data;
  ++flush_calls;
}
static void on_highlight_area(const char *view, int id, int x0, int y0,
                              int x1, int y1, void *data) {
  (void)view; (void)id; (void)x0; (void)y0; (void)x1; (void)y1; (void)data;
  ++highlight_area_calls;
}
static void on_progress(int done, int total, const char *tag, void *data) {
  (void)done; (void)total; (void)tag; (void)data;
  ++progress_calls;
}
static void on_log(yafaray_LogLevel_t lv, double t, const char *msg,
                   void *data) {
  (void)lv; (void)t; (void)msg; (void)data;
  ++logger_calls;
}

static void quad(yafaray_Interface_t *yi, const char *mat,
                 const double p[4][3]) {
  int i0, i1, i2, i3;
  yafaray_setCurrentMaterial(yi, mat);
  i0 = yafaray_addVertexWithOrco(yi, p[0][0], p[0][1], p[0][2], -1, -1, -1);
  i1 = yafaray_addVertexWithOrco(yi, p[1][0], p[1][1], p[1][2], 1, -1, -1);
  i2 = yafaray_addVertexWithOrco(yi, p[2][0], p[2][1], p[2][2], 1, 1, -1);
  i3 = yafaray_addVertexWithOrco(yi, p[3][0], p[3][1], p[3][2], -1, 1, -1);
  yafaray_addTriangle(yi, i0, i1, i2);
  yafaray_addTriangle(yi, i0, i2, i3);
}

static void build_scene(yafaray_Interface_t *yi, double back_wall_red) {
  int x, y;
  yafaray_Image_t *img;

  /* RAM image -> image texture (test00.c RAM-image flow) */
  yafaray_paramsClearAll(yi);
  yafaray_paramsSetInt(yi, "width", 8);
  yafaray_paramsSetInt(yi, "height", 8);
  yafaray_paramsSetString(yi, "type", "ColorAlpha");
  img = yafaray_createImage(yi, "checker_img");
  if (!img) { fprintf(stderr, "createImage failed\n"); exit(20); }
  for (y = 0; y < 8; ++y)
    for (x = 0; x < 8; ++x) {
      float v = ((x + y) & 1) ? 1.0f : 0.25f;
      yafaray_setImageColor(img, x, y, v, v, v, 1.0f);
    }
  {
    float r, g, b, a;
    if (yafaray_getImageColor(img, 1, 0, &r, &g, &b, &a) != YAFARAY_BOOL_TRUE
        || r < 0.9f) {
      fprintf(stderr, "getImageColor wrong\n");
      exit(21);
    }
  }

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "image");
  yafaray_paramsSetString(yi, "image_name", "checker_img");
  yafaray_paramsSetString(yi, "interpolate", "bilinear");
  yafaray_createTexture(yi, "checker_tex");

  /* node material: texture-driven diffuse (test00.c node material) */
  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "shinydiffusemat");
  yafaray_paramsSetColor(yi, "color", 0.73, 0.73, 0.73, 1.0);
  yafaray_paramsSetString(yi, "diffuse_shader", "diff_layer");
  yafaray_paramsPushList(yi);
  yafaray_paramsSetString(yi, "element", "shader_node");
  yafaray_paramsSetString(yi, "name", "diff_layer");
  yafaray_paramsSetString(yi, "type", "texture_mapper");
  yafaray_paramsSetString(yi, "texture", "checker_tex");
  yafaray_paramsSetString(yi, "texco", "uv");
  yafaray_paramsEndList(yi);
  yafaray_createMaterial(yi, "white");

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "shinydiffusemat");
  yafaray_paramsSetColor(yi, "color", back_wall_red, 0.05, 0.05, 1.0);
  yafaray_createMaterial(yi, "backmat");

  if (yafaray_startGeometry(yi) != YAFARAY_BOOL_TRUE) {
    fprintf(stderr, "startGeometry failed\n");
    exit(22);
  }
  yafaray_paramsClearAll(yi);
  yafaray_createObject(yi, "walls");
  {
    const double floor_q[4][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0}};
    const double ceil_q[4][3] = {{0, 0, 1}, {0, 1, 1}, {1, 1, 1}, {1, 0, 1}};
    const double back_q[4][3] = {{0, 1, 0}, {1, 1, 0}, {1, 1, 1}, {0, 1, 1}};
    quad(yi, "white", floor_q);
    quad(yi, "white", ceil_q);
    quad(yi, "backmat", back_q);
  }
  yafaray_endObject(yi);
  if (yafaray_endGeometry(yi) != YAFARAY_BOOL_TRUE) {
    fprintf(stderr, "endGeometry failed\n");
    exit(23);
  }

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "pointlight");
  yafaray_paramsSetVector(yi, "from", 0.5, 0.3, 0.8);
  yafaray_paramsSetColor(yi, "color", 1.0, 1.0, 1.0, 1.0);
  yafaray_paramsSetFloat(yi, "power", 2.5);
  yafaray_createLight(yi, "lamp");

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "perspective");
  yafaray_paramsSetVector(yi, "from", 0.5, -1.35, 0.5);
  yafaray_paramsSetVector(yi, "to", 0.5, 0.5, 0.5);
  yafaray_paramsSetVector(yi, "up", 0.5, -1.35, 1.5);
  yafaray_paramsSetInt(yi, "resx", RES);
  yafaray_paramsSetInt(yi, "resy", RES);
  yafaray_paramsSetFloat(yi, "fov", 39.0);
  yafaray_createCamera(yi, "cam");

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "constant");
  yafaray_paramsSetColor(yi, "color", 0.0, 0.0, 0.0, 1.0);
  yafaray_defineBackground(yi);

  /* integrator via createIntegrator (not setupRender params) */
  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "directlighting");
  yafaray_createIntegrator(yi, "integ");

  /* extra AOV layer + a named PNG output */
  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "z-depth-norm");
  yafaray_defineLayer(yi);

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "image_path", out_path);
  yafaray_paramsSetString(yi, "color_space", "sRGB");
  yafaray_createOutput(yi, "png_out");

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetInt(yi, "AA_minsamples", 2);
  if (device[0]) yafaray_paramsSetString(yi, "device", device);
  yafaray_setupRender(yi);
}

int main(int argc, char **argv) {
  float pix1[RES * RES * 4], pix2[RES * RES * 4];
  yafaray_Interface_t *yi;
  int wh, w, h, x, y;
  double mean, diff;

  if (argc > 1) device = argv[1];
  snprintf(out_path, sizeof(out_path), "%s/capi_test05_out.png",
           argc > 2 ? argv[2] : ".");

  if (yafaray_getVersionMajor() < 0 || yafaray_getVersionMinor() < 0 ||
      yafaray_getVersionPatch() < 0) {
    fprintf(stderr, "bad version numbers\n");
    return 1;
  }
  if (yafaray_logLevelFromString("debug") != YAFARAY_LOG_LEVEL_DEBUG) {
    fprintf(stderr, "logLevelFromString wrong\n");
    return 1;
  }

  yi = yafaray_createInterface(YAFARAY_INTERFACE_FOR_RENDERING, NULL, on_log,
                               NULL, 4);
  yafaray_setConsoleVerbosityLevel(yi, YAFARAY_LOG_LEVEL_MUTE);
  yafaray_enablePrintDateTime(yi, YAFARAY_BOOL_FALSE);
  yafaray_setConsoleLogColorsEnabled(yi, YAFARAY_BOOL_FALSE);
  yafaray_printInfo(yi, "test05 client starting");
  yafaray_printWarning(yi, "this is a warning");
  if (logger_calls < 2) {
    fprintf(stderr, "logger callback not firing\n");
    return 2;
  }
  if (yafaray_getNextFreeId(yi) == yafaray_getNextFreeId(yi)) {
    fprintf(stderr, "getNextFreeId not advancing\n");
    return 2;
  }

  yafaray_setRenderNotifyViewCallback(yi, on_notify_view, NULL);
  yafaray_setRenderNotifyLayerCallback(yi, on_notify_layer, NULL);
  yafaray_setRenderPutPixelCallback(yi, on_put_pixel, NULL);
  yafaray_setRenderFlushAreaCallback(yi, on_flush_area, NULL);
  yafaray_setRenderFlushCallback(yi, on_flush, NULL);
  yafaray_setRenderHighlightAreaCallback(yi, on_highlight_area, NULL);

  build_scene(yi, 0.65);

  if (yafaray_getSceneFilmWidth(yi) != RES ||
      yafaray_getSceneFilmHeight(yi) != RES) {
    fprintf(stderr, "film dims wrong: %dx%d\n", yafaray_getSceneFilmWidth(yi),
            yafaray_getSceneFilmHeight(yi));
    return 3;
  }

  if (!yafaray_render(yi, on_progress, NULL, 0)) {
    fprintf(stderr, "render 1 failed\n");
    return 4;
  }
  wh = yafaray_getImage(yi, pix1, RES * RES * 4);
  w = wh >> 16;
  h = wh & 0xFFFF;
  if (w != RES || h != RES) {
    fprintf(stderr, "bad image dims %dx%d\n", w, h);
    return 5;
  }
  mean = 0.0;
  for (y = 0; y < h; ++y)
    for (x = 0; x < w; ++x) {
      const float *p = pix1 + (y * w + x) * 4;
      mean += (p[0] + p[1] + p[2]) / 3.0;
    }
  mean /= w * h;
  if (mean < 0.005) { fprintf(stderr, "black image\n"); return 6; }

  /* callback-assembled pixels must match getImage (test00.c writes its
   * PPM from the putPixel callback buffer) */
  diff = 0.0;
  for (x = 0; x < RES * RES * 4; ++x)
    diff += (cb_pixels[x] - pix1[x]) * (cb_pixels[x] - pix1[x]);
  if (diff > 1e-6) {
    fprintf(stderr, "callback pixels != getImage (%g)\n", diff);
    return 7;
  }
  if (!notify_view_calls || notify_layer_calls < 2 || !put_pixel_calls ||
      !flush_area_calls || !flush_calls || !highlight_area_calls ||
      !progress_calls) {
    fprintf(stderr,
            "callback counts: view=%d layer=%d put=%ld area=%d flush=%d "
            "highlight=%d progress=%d\n",
            notify_view_calls, notify_layer_calls, put_pixel_calls,
            flush_area_calls, flush_calls, highlight_area_calls,
            progress_calls);
    return 8;
  }

  {
    char *layers = yafaray_getLayersTable(yi);
    char *views = yafaray_getViewsTable(yi);
    if (!layers || !strstr(layers, "z-depth-norm")) {
      fprintf(stderr, "layers table missing z-depth-norm: %s\n",
              layers ? layers : "(null)");
      return 9;
    }
    yafaray_deallocateCharPointer(layers);
    yafaray_deallocateCharPointer(views);
  }

  {
    FILE *f = fopen(out_path, "rb");
    if (!f) { fprintf(stderr, "named output not written\n"); return 11; }
    fclose(f);
  }

  /* --- test04-style mutation: redefine a material, re-render --- */
  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "shinydiffusemat");
  yafaray_paramsSetColor(yi, "color", 0.05, 0.05, 0.9, 1.0);
  yafaray_createMaterial(yi, "backmat");
  if (!yafaray_render(yi, NULL, NULL, 0)) {
    fprintf(stderr, "render 2 failed\n");
    return 12;
  }
  yafaray_getImage(yi, pix2, RES * RES * 4);
  diff = 0.0;
  for (x = 0; x < RES * RES * 4; ++x)
    diff += (pix2[x] - pix1[x]) * (pix2[x] - pix1[x]);
  if (diff < 1e-4) {
    fprintf(stderr, "scene mutation had no effect (diff=%g)\n", diff);
    return 13;
  }

  /* removeOutput / clearOutputs bookkeeping */
  if (yafaray_removeOutput(yi, "png_out") != YAFARAY_BOOL_TRUE ||
      yafaray_removeOutput(yi, "png_out") != YAFARAY_BOOL_FALSE) {
    fprintf(stderr, "removeOutput bookkeeping wrong\n");
    return 14;
  }
  yafaray_clearOutputs(yi);

  yafaray_destroyInterface(yi);
  printf("test05 C client OK\n");
  return 0;
}
