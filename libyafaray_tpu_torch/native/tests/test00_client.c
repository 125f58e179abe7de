/* test00-style C client: drives the native C API end to end, mirroring the
 * reference's tests/test00/test00.c:100-288 — materials, a cornell-ish box
 * streamed vertex by vertex, an area light, perspective camera, render, and
 * pixel readback through the callback-free getImage path. Exits non-zero on
 * any failure so it doubles as a CI check.
 *
 *     test00_client [DEVICE [OUTDIR]]
 *
 * DEVICE, when given and not empty, is staged as the render param "device"
 * (for example "cpu"); without it the port renders on the CUDA card. The
 * PNG goes to OUTDIR/capi_test00.png (OUTDIR defaults to "."). */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "yafaray_tpu_c_api.h"

static void quad(yafaray_Interface_t *yi, const char *mat, const double p[4][3]) {
  int i0, i1, i2, i3;
  yafaray_setCurrentMaterial(yi, mat);
  i0 = yafaray_addVertex(yi, p[0][0], p[0][1], p[0][2]);
  i1 = yafaray_addVertex(yi, p[1][0], p[1][1], p[1][2]);
  i2 = yafaray_addVertex(yi, p[2][0], p[2][1], p[2][2]);
  i3 = yafaray_addVertex(yi, p[3][0], p[3][1], p[3][2]);
  yafaray_addTriangle(yi, i0, i1, i2);
  yafaray_addTriangle(yi, i0, i2, i3);
}

int main(int argc, char **argv) {
  const char *device = argc > 1 ? argv[1] : "";
  const char *outdir = argc > 2 ? argv[2] : ".";
  char out_path[4096];
  yafaray_Interface_t *yi = yafaray_createInterface(
      YAFARAY_INTERFACE_FOR_RENDERING, NULL, NULL, NULL, 4);

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "shinydiffusemat");
  yafaray_paramsSetColor(yi, "color", 0.73, 0.73, 0.73, 1.0);
  yafaray_createMaterial(yi, "white");

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "shinydiffusemat");
  yafaray_paramsSetColor(yi, "color", 0.65, 0.05, 0.05, 1.0);
  yafaray_createMaterial(yi, "red");

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "shinydiffusemat");
  yafaray_paramsSetColor(yi, "color", 0.12, 0.45, 0.15, 1.0);
  yafaray_createMaterial(yi, "green");

  yafaray_paramsClearAll(yi);
  yafaray_createObject(yi, "walls");
  {
    const double floor_q[4][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0}};
    const double ceil_q[4][3] = {{0, 0, 1}, {0, 1, 1}, {1, 1, 1}, {1, 0, 1}};
    const double back_q[4][3] = {{0, 1, 0}, {1, 1, 0}, {1, 1, 1}, {0, 1, 1}};
    const double left_q[4][3] = {{0, 0, 0}, {0, 1, 0}, {0, 1, 1}, {0, 0, 1}};
    const double right_q[4][3] = {{1, 0, 0}, {1, 0, 1}, {1, 1, 1}, {1, 1, 0}};
    quad(yi, "white", floor_q);
    quad(yi, "white", ceil_q);
    quad(yi, "white", back_q);
    quad(yi, "red", left_q);
    quad(yi, "green", right_q);
  }

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "arealight");
  yafaray_paramsSetVector(yi, "corner", 0.35, 0.35, 0.999);
  yafaray_paramsSetVector(yi, "point1", 0.35, 0.65, 0.999);
  yafaray_paramsSetVector(yi, "point2", 0.65, 0.35, 0.999);
  yafaray_paramsSetColor(yi, "color", 1.0, 0.9, 0.8, 1.0);
  yafaray_paramsSetFloat(yi, "power", 12.0);
  yafaray_createLight(yi, "lamp");

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "perspective");
  yafaray_paramsSetVector(yi, "from", 0.5, -1.35, 0.5);
  yafaray_paramsSetVector(yi, "to", 0.5, 0.5, 0.5);
  yafaray_paramsSetVector(yi, "up", 0.5, -1.35, 1.5);
  yafaray_paramsSetInt(yi, "resx", 32);
  yafaray_paramsSetInt(yi, "resy", 32);
  yafaray_paramsSetFloat(yi, "fov", 39.0);
  yafaray_createCamera(yi, "cam");

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "type", "constant");
  yafaray_paramsSetColor(yi, "color", 0.0, 0.0, 0.0, 1.0);
  yafaray_defineBackground(yi);

  yafaray_paramsClearAll(yi);
  yafaray_paramsSetString(yi, "integrator_type", "pathtracing");
  yafaray_paramsSetInt(yi, "integrator_bounces", 3);
  yafaray_paramsSetInt(yi, "AA_minsamples", 4);
  if (device[0]) yafaray_paramsSetString(yi, "device", device);
  yafaray_setupRender(yi);

  if (!yafaray_render(yi, NULL, NULL, 0)) {
    fprintf(stderr, "render failed\n");
    return 1;
  }

  {
    float *pix = malloc(sizeof(float) * 32 * 32 * 4);
    int wh = yafaray_getImage(yi, pix, 32 * 32 * 4);
    int w = wh >> 16, h = wh & 0xFFFF;
    double mean = 0.0, left_r = 0.0, left_g = 0.0;
    int x, y;
    if (w != 32 || h != 32) {
      fprintf(stderr, "bad image dims %dx%d\n", w, h);
      return 2;
    }
    for (y = 0; y < h; ++y)
      for (x = 0; x < w; ++x) {
        const float *p = pix + (y * w + x) * 4;
        mean += (p[0] + p[1] + p[2]) / 3.0;
        if (x < 6) { left_r += p[0]; left_g += p[1]; }
      }
    mean /= w * h;
    printf("mean=%f left_r=%f left_g=%f\n", mean, left_r, left_g);
    if (mean < 0.01) { fprintf(stderr, "black image\n"); return 3; }
    if (left_r <= left_g) { fprintf(stderr, "left wall not red\n"); return 4; }
    free(pix);
  }

  snprintf(out_path, sizeof(out_path), "%s/capi_test00.png", outdir);
  if (!yafaray_saveImage(yi, out_path)) {
    fprintf(stderr, "saveImage failed\n");
    return 5;
  }
  yafaray_destroyInterface(yi);
  printf("test00 C client OK\n");
  return 0;
}
