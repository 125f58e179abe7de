/* Native C API implementation over the PyTorch / CUDA port.
 *
 * A copy of the JAX package's native/yafaray_tpu_c_api.cc with the same ABI
 * and version numbers; it embeds CPython and drives libyafaray_tpu_torch
 * (SceneBuilder, io.export, capi_runtime, io.save_image) where the original
 * drives libyafaray_tpu, and its version string names the port. The render
 * runs on the CUDA card unless the client stages the render param
 * "device" (for example "cpu") before yafaray_setupRender.
 *
 * Mirrors the reference's L0/L1 layers (src/public_api/yafaray_c_api.cc +
 * src/interface/interface.cc): an opaque session object staging typed
 * parameters and geometry in C++ containers, then driving the compute
 * core through an embedded CPython interpreter. Geometry is staged in
 * std::vector (no Python overhead per vertex) and handed to the scene
 * builder in ONE bulk call as numpy arrays built from the raw buffers.
 *
 * Scene mutation between renders works like the reference's change-flag
 * driven rebuild (scene.cc:218,1032-1060): every yafaray_render replays the
 * staged state into a fresh SceneBuilder, and createX calls upsert by name,
 * so a client can re-create a material / move an instance / swap a texture
 * and re-render (the reference's tests/test04 "changes on the fly" flow).
 *
 * Export interface types reuse the Python-side recorders (io/export.py),
 * matching the reference's ExportXml/ExportC/ExportPython dispatch
 * (yafaray_c_api.cc:32).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <array>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <map>
#include <memory>
#include <string>
#include <variant>
#include <vector>

#include "include/yafaray_tpu_c_api.h"

#define YTPU_VERSION_MAJOR 0
#define YTPU_VERSION_MINOR 2
#define YTPU_VERSION_PATCH 0

namespace {

using Matrix16 = std::array<double, 16>;
using ParamValue =
    std::variant<bool, int, double, std::string, std::array<double, 3>,
                 std::array<double, 4>, Matrix16, std::vector<Matrix16>>;
using ParamMap = std::vector<std::pair<std::string, ParamValue>>;

PyObject *matrixToPy(const Matrix16 &m) {
  PyObject *t = PyTuple_New(16);
  for (int k = 0; k < 16; ++k)
    PyTuple_SET_ITEM(t, k, PyFloat_FromDouble(m[k]));
  return t;
}

PyObject *paramValueToPy(const ParamValue &v) {
  if (auto *b = std::get_if<bool>(&v)) return PyBool_FromLong(*b);
  if (auto *i = std::get_if<int>(&v)) return PyLong_FromLong(*i);
  if (auto *d = std::get_if<double>(&v)) return PyFloat_FromDouble(*d);
  if (auto *s = std::get_if<std::string>(&v))
    return PyUnicode_FromString(s->c_str());
  if (auto *v3 = std::get_if<std::array<double, 3>>(&v)) {
    PyObject *t = PyTuple_New(3);
    for (int k = 0; k < 3; ++k)
      PyTuple_SET_ITEM(t, k, PyFloat_FromDouble((*v3)[k]));
    return t;
  }
  if (auto *v4 = std::get_if<std::array<double, 4>>(&v)) {
    PyObject *t = PyTuple_New(4);
    for (int k = 0; k < 4; ++k)
      PyTuple_SET_ITEM(t, k, PyFloat_FromDouble((*v4)[k]));
    return t;
  }
  if (auto *m = std::get_if<Matrix16>(&v)) return matrixToPy(*m);
  if (auto *ms = std::get_if<std::vector<Matrix16>>(&v)) {
    PyObject *l = PyList_New(ms->size());
    for (size_t k = 0; k < ms->size(); ++k)
      PyList_SET_ITEM(l, k, matrixToPy((*ms)[k]));
    return l;
  }
  Py_RETURN_NONE;
}

PyObject *paramMapToDict(const ParamMap &pm) {
  PyObject *d = PyDict_New();
  for (const auto &kv : pm) {
    PyObject *v = paramValueToPy(kv.second);
    PyDict_SetItemString(d, kv.first.c_str(), v);
    Py_DECREF(v);
  }
  return d;
}

const char *findString(const ParamMap &pm, const char *key,
                       const char *fallback) {
  for (const auto &kv : pm)
    if (kv.first == key)
      if (auto *s = std::get_if<std::string>(&kv.second)) return s->c_str();
  return fallback;
}

int findInt(const ParamMap &pm, const char *key, int fallback) {
  for (const auto &kv : pm)
    if (kv.first == key) {
      if (auto *i = std::get_if<int>(&kv.second)) return *i;
      if (auto *d = std::get_if<double>(&kv.second))
        return static_cast<int>(*d);
    }
  return fallback;
}

template <typename V>
void upsert(std::vector<std::pair<std::string, V>> &vec,
            const std::string &name, V value) {
  for (auto &e : vec)
    if (e.first == name) {
      e.second = std::move(value);
      return;
    }
  vec.emplace_back(name, std::move(value));
}

struct StagedObject {
  std::string name;
  ParamMap params;
  std::vector<float> vertices;     // xyz triples
  std::vector<float> vertices_t1;  // motion keyframe xyz triples
  std::vector<float> orcos;        // orco xyz triples
  std::vector<float> normals;
  std::vector<float> uvs;          // uv pairs
  std::vector<int> faces;          // abc triples
  std::vector<int> face_uvs;       // uv index triples (-1 if none)
  std::vector<int> face_mats;
};

struct StagedInstance {
  std::string base;
  std::vector<Matrix16> time_steps;  // [0] = obj_to_world at shutter open
};

/* Reference Logger analogue (src/common/logger.cc): leveled console print
 * with optional datetime + ANSI colors, plus the client logger callback. */
struct NativeLogger {
  yafaray_LogLevel_t console_level = YAFARAY_LOG_LEVEL_INFO;
  yafaray_LogLevel_t log_level = YAFARAY_LOG_LEVEL_VERBOSE;
  bool print_datetime = true;
  bool colors = true;
  yafaray_LoggerCallback_t cb = nullptr;
  void *cb_data = nullptr;

  static const char *levelName(yafaray_LogLevel_t lv) {
    switch (lv) {
      case YAFARAY_LOG_LEVEL_ERROR: return "ERROR";
      case YAFARAY_LOG_LEVEL_WARNING: return "WARNING";
      case YAFARAY_LOG_LEVEL_PARAMS: return "PARAMS";
      case YAFARAY_LOG_LEVEL_INFO: return "INFO";
      case YAFARAY_LOG_LEVEL_VERBOSE: return "VERBOSE";
      case YAFARAY_LOG_LEVEL_DEBUG: return "DEBUG";
      default: return "MUTE";
    }
  }
  static const char *levelColor(yafaray_LogLevel_t lv) {
    switch (lv) {
      case YAFARAY_LOG_LEVEL_ERROR: return "\033[31m";
      case YAFARAY_LOG_LEVEL_WARNING: return "\033[33m";
      case YAFARAY_LOG_LEVEL_PARAMS: return "\033[36m";
      case YAFARAY_LOG_LEVEL_VERBOSE: return "\033[90m";
      case YAFARAY_LOG_LEVEL_DEBUG: return "\033[35m";
      default: return "";
    }
  }

  void log(yafaray_LogLevel_t lv, const char *msg) const {
    if (lv <= console_level && console_level != YAFARAY_LOG_LEVEL_MUTE) {
      char stamp[32] = "";
      if (print_datetime) {
        std::time_t t = std::time(nullptr);
        std::tm tm_buf{};
        localtime_r(&t, &tm_buf);
        std::strftime(stamp, sizeof(stamp), "%Y-%m-%d %H:%M:%S ", &tm_buf);
      }
      if (colors)
        std::fprintf(stderr, "%s[%s]\033[0m %s%s\n", levelColor(lv),
                     levelName(lv), stamp, msg);
      else
        std::fprintf(stderr, "[%s] %s%s\n", levelName(lv), stamp, msg);
    }
    if (cb && lv <= log_level)
      cb(lv, static_cast<double>(std::time(nullptr)), msg, cb_data);
  }
};

void ensurePython() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
  }
}

}  // namespace

/* RAM image (reference yafaray_Image_t: createImage + set/getImageColor,
 * yafaray_c_api.h image functions). Owned by the interface that created it. */
struct yafaray_Image {
  std::string name;
  int width = 0, height = 0;
  std::vector<float> rgba;  // [h*w*4]
};

struct yafaray_Interface {
  yafaray_InterfaceType_t type = YAFARAY_INTERFACE_FOR_RENDERING;
  std::string export_path;
  ParamMap params;
  std::vector<ParamMap> param_list;  // paramsPushList shader-node stacks
  bool in_list = false;
  std::string current_material;
  std::string input_color_space = "LinearRGB";
  double input_gamma = 1.0;
  unsigned int next_free_id = 1;
  bool in_geometry = false;

  // staged entities, replayed into the Python SceneBuilder at setup
  std::vector<std::pair<std::string, ParamMap>> textures, materials, lights,
      cameras, volumes, views, outputs;
  std::map<std::string, std::vector<ParamMap>> material_nodes;
  ParamMap background;
  bool has_background = false;
  ParamMap render_params;
  ParamMap integrator_params;
  bool has_integrator = false;
  std::vector<ParamMap> layers;  // defineLayer staging
  std::vector<StagedObject> objects;
  std::vector<StagedInstance> instances;
  std::map<std::string, std::unique_ptr<yafaray_Image>> images;

  PyObject *builder = nullptr;  // SceneBuilder instance (after setup)
  PyObject *image = nullptr;    // numpy [H,W,4] float32 of the last render
  int resx = 0, resy = 0;
  volatile bool canceled = false;
  NativeLogger logger;

  // render callbacks (reference yafaray_setRender*Callback)
  yafaray_RenderNotifyViewCallback_t cb_notify_view = nullptr;
  void *cb_notify_view_data = nullptr;
  yafaray_RenderNotifyLayerCallback_t cb_notify_layer = nullptr;
  void *cb_notify_layer_data = nullptr;
  yafaray_RenderPutPixelCallback_t cb_put_pixel = nullptr;
  void *cb_put_pixel_data = nullptr;
  yafaray_RenderFlushAreaCallback_t cb_flush_area = nullptr;
  void *cb_flush_area_data = nullptr;
  yafaray_RenderFlushCallback_t cb_flush = nullptr;
  void *cb_flush_data = nullptr;
  yafaray_RenderHighlightAreaCallback_t cb_highlight_area = nullptr;
  void *cb_highlight_area_data = nullptr;
  yafaray_RenderHighlightPixelCallback_t cb_highlight_pixel = nullptr;
  void *cb_highlight_pixel_data = nullptr;
  yafaray_ProgressCallback_t progress_cb = nullptr;
  void *progress_data = nullptr;
  std::string current_view;  // view name for pass-progress callbacks

  StagedObject *cur_obj() {
    return objects.empty() ? nullptr : &objects.back();
  }
  StagedObject *findObject(const std::string &name) {
    for (auto &o : objects)
      if (o.name == name) return &o;
    return nullptr;
  }
  int matIndex(const std::string &name) {
    for (size_t i = 0; i < materials.size(); ++i)
      if (materials[i].first == name) return static_cast<int>(i);
    return 0;
  }
  void resetScene() {
    params.clear();
    param_list.clear();
    in_list = false;
    current_material.clear();
    textures.clear();
    materials.clear();
    lights.clear();
    cameras.clear();
    volumes.clear();
    views.clear();
    outputs.clear();
    material_nodes.clear();
    background.clear();
    has_background = false;
    render_params.clear();
    integrator_params.clear();
    has_integrator = false;
    layers.clear();
    objects.clear();
    instances.clear();
    images.clear();
    canceled = false;
  }
};

namespace {

/* Per-pass trampoline handed to capi_runtime.render_for_capi: forwards
 * progress to the client, fires highlightArea at pass granularity (the
 * wavefront's analogue of tile-highlight), and returns False after
 * yafaray_cancelRendering (RenderControl cancel poll). */
PyObject *passCbTrampoline(PyObject *self, PyObject *args) {
  auto *yi = static_cast<yafaray_Interface_t *>(
      PyCapsule_GetPointer(self, "yafaray_tpu.interface"));
  int done = 0, total = 0;
  const char *tag = "";
  if (!PyArg_ParseTuple(args, "ii|s", &done, &total, &tag)) return nullptr;
  if (yi) {
    if (yi->progress_cb) yi->progress_cb(done, total, tag, yi->progress_data);
    if (yi->cb_highlight_area)
      yi->cb_highlight_area(yi->current_view.c_str(), done, 0, 0, yi->resx,
                            yi->resy, yi->cb_highlight_area_data);
    return PyBool_FromLong(yi->canceled ? 0 : 1);
  }
  Py_RETURN_TRUE;
}

PyMethodDef pass_cb_def = {"capi_pass_cb", passCbTrampoline, METH_VARARGS,
                           nullptr};

}  // namespace

extern "C" {

yafaray_Interface_t *yafaray_createInterface(yafaray_InterfaceType_t type,
                                             const char *export_path,
                                             yafaray_LoggerCallback_t logger,
                                             void *logger_data,
                                             int console_verbosity) {
  auto *yi = new yafaray_Interface();
  yi->type = type;
  if (export_path) yi->export_path = export_path;
  yi->logger.cb = logger;
  yi->logger.cb_data = logger_data;
  if (console_verbosity > 0)
    yi->logger.console_level =
        static_cast<yafaray_LogLevel_t>(console_verbosity);
  return yi;
}

void yafaray_destroyInterface(yafaray_Interface_t *yi) {
  if (yi->builder || yi->image) {
    ensurePython();
    PyGILState_STATE g = PyGILState_Ensure();
    Py_XDECREF(yi->builder);
    Py_XDECREF(yi->image);
    PyGILState_Release(g);
  }
  delete yi;
}

void yafaray_setLoggingCallback(yafaray_Interface_t *yi,
                                yafaray_LoggerCallback_t logger, void *data) {
  yi->logger.cb = logger;
  yi->logger.cb_data = data;
}

void yafaray_clearAll(yafaray_Interface_t *yi) { yi->resetScene(); }

void yafaray_paramsClearAll(yafaray_Interface_t *yi) {
  yi->params.clear();
  yi->param_list.clear();
  yi->in_list = false;
}

static ParamMap &target(yafaray_Interface_t *yi) {
  return yi->in_list ? yi->param_list.back() : yi->params;
}

void yafaray_paramsSetBool(yafaray_Interface_t *yi, const char *n,
                           yafaray_Bool_t v) {
  target(yi).emplace_back(n, v == YAFARAY_BOOL_TRUE);
}
void yafaray_paramsSetInt(yafaray_Interface_t *yi, const char *n, int v) {
  target(yi).emplace_back(n, v);
}
void yafaray_paramsSetFloat(yafaray_Interface_t *yi, const char *n,
                            double v) {
  target(yi).emplace_back(n, v);
}
void yafaray_paramsSetString(yafaray_Interface_t *yi, const char *n,
                             const char *v) {
  target(yi).emplace_back(n, std::string(v));
}
void yafaray_paramsSetVector(yafaray_Interface_t *yi, const char *n, double x,
                             double y, double z) {
  target(yi).emplace_back(n, std::array<double, 3>{x, y, z});
}
void yafaray_paramsSetColor(yafaray_Interface_t *yi, const char *n, double r,
                            double g, double b, double a) {
  /* input color space conversion -> linear (reference
   * Interface::setInputColorSpace applied at paramsSetColor time) */
  if (yi->input_color_space == "sRGB") {
    auto lin = [](double c) {
      return c <= 0.04045 ? c / 12.92 : std::pow((c + 0.055) / 1.055, 2.4);
    };
    r = lin(r);
    g = lin(g);
    b = lin(b);
  } else if (yi->input_color_space == "Raw_Manual_Gamma" &&
             yi->input_gamma != 1.0) {
    r = std::pow(r, yi->input_gamma);
    g = std::pow(g, yi->input_gamma);
    b = std::pow(b, yi->input_gamma);
  }
  target(yi).emplace_back(n, std::array<double, 4>{r, g, b, a});
}
void yafaray_paramsSetMatrix(yafaray_Interface_t *yi, const char *n,
                             const double m[4][4]) {
  Matrix16 flat;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) flat[i * 4 + j] = m[i][j];
  target(yi).emplace_back(n, flat);
}
void yafaray_paramsSetMatrixArray(yafaray_Interface_t *yi, const char *n,
                                  const double m[4][4]) {
  Matrix16 flat;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) flat[i * 4 + j] = m[i][j];
  ParamMap &pm = target(yi);
  for (auto &kv : pm)
    if (kv.first == n)
      if (auto *ms = std::get_if<std::vector<Matrix16>>(&kv.second)) {
        ms->push_back(flat);
        return;
      }
  pm.emplace_back(n, std::vector<Matrix16>{flat});
}
void yafaray_paramsPushList(yafaray_Interface_t *yi) {
  yi->param_list.emplace_back();
  yi->in_list = true;
}
void yafaray_paramsEndList(yafaray_Interface_t *yi) { yi->in_list = false; }

void yafaray_setInputColorSpace(yafaray_Interface_t *yi,
                                const char *color_space, float gamma) {
  yi->input_color_space = color_space ? color_space : "LinearRGB";
  yi->input_gamma = gamma;
}

int yafaray_createScene(yafaray_Interface_t *yi) {
  /* a fresh scene: drop all staged entities (reference Scene re-creation) */
  yi->resetScene();
  return 1;
}

int yafaray_createMaterial(yafaray_Interface_t *yi, const char *name) {
  upsert(yi->materials, name, yi->params);
  if (!yi->param_list.empty())
    yi->material_nodes[name] = yi->param_list;
  else
    yi->material_nodes.erase(name);
  yafaray_paramsClearAll(yi);
  return 1;
}
int yafaray_createTexture(yafaray_Interface_t *yi, const char *name) {
  upsert(yi->textures, name, yi->params);
  yafaray_paramsClearAll(yi);
  return 1;
}
int yafaray_createLight(yafaray_Interface_t *yi, const char *name) {
  upsert(yi->lights, name, yi->params);
  yafaray_paramsClearAll(yi);
  return 1;
}
int yafaray_createCamera(yafaray_Interface_t *yi, const char *name) {
  upsert(yi->cameras, name, yi->params);
  yafaray_paramsClearAll(yi);
  return 1;
}
int yafaray_defineBackground(yafaray_Interface_t *yi) {
  yi->background = yi->params;
  yi->has_background = true;
  yafaray_paramsClearAll(yi);
  return 1;
}
int yafaray_createBackground(yafaray_Interface_t *yi, const char * /*name*/) {
  return yafaray_defineBackground(yi);
}
int yafaray_createVolumeRegion(yafaray_Interface_t *yi, const char *name) {
  upsert(yi->volumes, name, yi->params);
  yafaray_paramsClearAll(yi);
  return 1;
}
int yafaray_createRenderView(yafaray_Interface_t *yi, const char *name) {
  upsert(yi->views, name, yi->params);
  yafaray_paramsClearAll(yi);
  return 1;
}
int yafaray_createIntegrator(yafaray_Interface_t *yi, const char * /*name*/) {
  yi->integrator_params = yi->params;
  yi->has_integrator = true;
  yafaray_paramsClearAll(yi);
  return 1;
}
int yafaray_createOutput(yafaray_Interface_t *yi, const char *name) {
  upsert(yi->outputs, name, yi->params);
  yafaray_paramsClearAll(yi);
  return 1;
}
yafaray_Bool_t yafaray_removeOutput(yafaray_Interface_t *yi,
                                    const char *name) {
  for (size_t i = 0; i < yi->outputs.size(); ++i)
    if (yi->outputs[i].first == name) {
      yi->outputs.erase(yi->outputs.begin() + i);
      return YAFARAY_BOOL_TRUE;
    }
  return YAFARAY_BOOL_FALSE;
}
void yafaray_clearOutputs(yafaray_Interface_t *yi) { yi->outputs.clear(); }

void yafaray_defineLayer(yafaray_Interface_t *yi) {
  yi->layers.push_back(yi->params);
  yafaray_paramsClearAll(yi);
}

/* --- RAM images --- */
yafaray_Image_t *yafaray_createImage(yafaray_Interface_t *yi,
                                     const char *name) {
  int w = findInt(yi->params, "width", 0);
  int h = findInt(yi->params, "height", 0);
  if (w <= 0 || h <= 0) {
    yafaray_paramsClearAll(yi);
    return nullptr;
  }
  auto img = std::make_unique<yafaray_Image>();
  img->name = name;
  img->width = w;
  img->height = h;
  img->rgba.assign(static_cast<size_t>(w) * h * 4, 0.0f);
  yafaray_Image_t *raw = img.get();
  yi->images[name] = std::move(img);
  yafaray_paramsClearAll(yi);
  return raw;
}
yafaray_Bool_t yafaray_setImageColor(yafaray_Image_t *img, int x, int y,
                                     float r, float g, float b, float a) {
  if (!img || x < 0 || y < 0 || x >= img->width || y >= img->height)
    return YAFARAY_BOOL_FALSE;
  float *px = &img->rgba[(static_cast<size_t>(y) * img->width + x) * 4];
  px[0] = r;
  px[1] = g;
  px[2] = b;
  px[3] = a;
  return YAFARAY_BOOL_TRUE;
}
yafaray_Bool_t yafaray_getImageColor(const yafaray_Image_t *img, int x, int y,
                                     float *r, float *g, float *b, float *a) {
  if (!img || x < 0 || y < 0 || x >= img->width || y >= img->height)
    return YAFARAY_BOOL_FALSE;
  const float *px =
      &img->rgba[(static_cast<size_t>(y) * img->width + x) * 4];
  *r = px[0];
  *g = px[1];
  *b = px[2];
  *a = px[3];
  return YAFARAY_BOOL_TRUE;
}

/* --- geometry --- */
yafaray_Bool_t yafaray_startGeometry(yafaray_Interface_t *yi) {
  if (yi->in_geometry) return YAFARAY_BOOL_FALSE;
  yi->in_geometry = true;
  return YAFARAY_BOOL_TRUE;
}
yafaray_Bool_t yafaray_endGeometry(yafaray_Interface_t *yi) {
  if (!yi->in_geometry) return YAFARAY_BOOL_FALSE;
  yi->in_geometry = false;
  return YAFARAY_BOOL_TRUE;
}
yafaray_Bool_t yafaray_endObject(yafaray_Interface_t *yi) {
  return yi->cur_obj() ? YAFARAY_BOOL_TRUE : YAFARAY_BOOL_FALSE;
}
unsigned int yafaray_getNextFreeId(yafaray_Interface_t *yi) {
  return yi->next_free_id++;
}

int yafaray_createObject(yafaray_Interface_t *yi, const char *name) {
  /* mutation between renders: re-creating an object replaces it */
  for (size_t i = 0; i < yi->objects.size(); ++i)
    if (yi->objects[i].name == name) {
      yi->objects.erase(yi->objects.begin() + i);
      break;
    }
  StagedObject obj;
  obj.name = name;
  obj.params = yi->params;
  yi->objects.push_back(std::move(obj));
  yafaray_paramsClearAll(yi);
  return static_cast<int>(yi->objects.size() - 1);
}

int yafaray_addVertex(yafaray_Interface_t *yi, double x, double y, double z) {
  auto *o = yi->cur_obj();
  if (!o) return -1;
  o->vertices.push_back(static_cast<float>(x));
  o->vertices.push_back(static_cast<float>(y));
  o->vertices.push_back(static_cast<float>(z));
  return static_cast<int>(o->vertices.size() / 3 - 1);
}
int yafaray_addVertexWithOrco(yafaray_Interface_t *yi, double x, double y,
                              double z, double ox, double oy, double oz) {
  auto *o = yi->cur_obj();
  if (!o) return -1;
  o->orcos.push_back(static_cast<float>(ox));
  o->orcos.push_back(static_cast<float>(oy));
  o->orcos.push_back(static_cast<float>(oz));
  return yafaray_addVertex(yi, x, y, z);
}
int yafaray_addVertexTimeStep(yafaray_Interface_t *yi, double x, double y,
                              double z) {
  auto *o = yi->cur_obj();
  if (!o) return -1;
  o->vertices_t1.push_back(static_cast<float>(x));
  o->vertices_t1.push_back(static_cast<float>(y));
  o->vertices_t1.push_back(static_cast<float>(z));
  return static_cast<int>(o->vertices_t1.size() / 3 - 1);
}
void yafaray_addNormal(yafaray_Interface_t *yi, double x, double y,
                       double z) {
  auto *o = yi->cur_obj();
  if (!o) return;
  o->normals.push_back(static_cast<float>(x));
  o->normals.push_back(static_cast<float>(y));
  o->normals.push_back(static_cast<float>(z));
}
int yafaray_addUv(yafaray_Interface_t *yi, double u, double v) {
  auto *o = yi->cur_obj();
  if (!o) return -1;
  o->uvs.push_back(static_cast<float>(u));
  o->uvs.push_back(static_cast<float>(v));
  return static_cast<int>(o->uvs.size() / 2 - 1);
}
int yafaray_addTriangle(yafaray_Interface_t *yi, int a, int b, int c) {
  return yafaray_addTriangleWithUv(yi, a, b, c, -1, -1, -1);
}
int yafaray_addTriangleWithUv(yafaray_Interface_t *yi, int a, int b, int c,
                              int uv_a, int uv_b, int uv_c) {
  auto *o = yi->cur_obj();
  if (!o) return -1;
  o->faces.insert(o->faces.end(), {a, b, c});
  o->face_uvs.insert(o->face_uvs.end(), {uv_a, uv_b, uv_c});
  o->face_mats.push_back(yi->matIndex(yi->current_material));
  return static_cast<int>(o->faces.size() / 3 - 1);
}
void yafaray_setCurrentMaterial(yafaray_Interface_t *yi, const char *name) {
  yi->current_material = name;
}
void yafaray_smoothMesh(yafaray_Interface_t *yi, const char *name,
                        double angle) {
  for (auto &o : yi->objects)
    if (o.name == name || std::strlen(name) == 0)
      o.params.emplace_back("__smooth__", angle);
}
int yafaray_addInstance(yafaray_Interface_t *yi, const char *base,
                        const double m[4][4]) {
  Matrix16 flat;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) flat[i * 4 + j] = m[i][j];
  StagedInstance inst;
  inst.base = base;
  inst.time_steps.push_back(flat);
  yi->instances.push_back(std::move(inst));
  return static_cast<int>(yi->instances.size() - 1);
}
int yafaray_addInstanceArray(yafaray_Interface_t *yi, const char *base,
                             const double m[4][4]) {
  /* appends a motion time-step matrix to the last instance of `base`
   * (reference yafaray_addInstanceArray); creates the instance if new */
  for (auto it = yi->instances.rbegin(); it != yi->instances.rend(); ++it)
    if (it->base == base) {
      Matrix16 flat;
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) flat[i * 4 + j] = m[i][j];
      it->time_steps.push_back(flat);
      return 1;
    }
  return yafaray_addInstance(yi, base, m) >= 0 ? 1 : 0;
}

/* Build the Python SceneBuilder from the staged state. */
static bool buildScene(yafaray_Interface_t *yi) {
  ensurePython();
  PyGILState_STATE g = PyGILState_Ensure();
  bool ok = false;
  PyObject *mod = nullptr, *np = nullptr;
  do {
    mod = PyImport_ImportModule("libyafaray_tpu_torch");
    if (!mod) break;
    np = PyImport_ImportModule("numpy");
    if (!np) break;
    PyObject *cls = PyObject_GetAttrString(mod, "SceneBuilder");
    if (!cls) break;
    Py_XDECREF(yi->builder);
    yi->builder = PyObject_CallObject(cls, nullptr);
    Py_DECREF(cls);
    if (!yi->builder) break;

    auto call = [&](const char *method, PyObject *args) -> PyObject * {
      PyObject *m = PyObject_GetAttrString(yi->builder, method);
      if (!m) return nullptr;
      PyObject *r = PyObject_CallObject(m, args);
      Py_DECREF(m);
      Py_XDECREF(args);
      return r;
    };
    auto entity = [&](const char *method, const std::string &name,
                      const ParamMap &pm) -> bool {
      PyObject *d = paramMapToDict(pm);
      PyObject *args = Py_BuildValue("(sO)", name.c_str(), d);
      Py_DECREF(d);
      PyObject *r = call(method, args);
      if (!r) return false;
      Py_DECREF(r);
      return true;
    };
    /* numpy float32 array from a raw C++ buffer (borrowed; numpy copies
     * internally only when the builder reshapes, so keep yi alive) */
    PyObject *frombuffer = PyObject_GetAttrString(np, "frombuffer");
    auto arr_f32 = [&](const std::vector<float> &v) -> PyObject * {
      PyObject *mv = PyMemoryView_FromMemory(
          reinterpret_cast<char *>(const_cast<float *>(v.data())),
          v.size() * sizeof(float), PyBUF_READ);
      PyObject *a = PyObject_CallFunction(frombuffer, "Os", mv, "float32");
      Py_DECREF(mv);
      return a;
    };
    auto arr_i32 = [&](const std::vector<int> &v) -> PyObject * {
      PyObject *mv = PyMemoryView_FromMemory(
          reinterpret_cast<char *>(const_cast<int *>(v.data())),
          v.size() * sizeof(int), PyBUF_READ);
      PyObject *a = PyObject_CallFunction(frombuffer, "Os", mv, "int32");
      Py_DECREF(mv);
      return a;
    };

    bool fail = false;
    for (auto &t : yi->textures) {
      /* textures referencing a RAM image get its pixel buffer attached
       * (reference: texture type "image" + param "image_name") */
      const char *img_name = findString(t.second, "image_name", nullptr);
      PyObject *pixels = nullptr;
      if (img_name) {
        auto it = yi->images.find(img_name);
        if (it != yi->images.end()) {
          yafaray_Image *img = it->second.get();
          PyObject *flat = arr_f32(img->rgba);
          if (flat) {
            pixels = PyObject_CallMethod(flat, "reshape", "(iii)",
                                         img->height, img->width, 4);
            Py_DECREF(flat);
          }
        }
      }
      PyObject *d = paramMapToDict(t.second);
      PyObject *args =
          Py_BuildValue("(sOO)", t.first.c_str(), d,
                        pixels ? pixels : Py_None);
      Py_DECREF(d);
      Py_XDECREF(pixels);
      PyObject *r = call("create_texture", args);
      if (!r)
        fail = true;
      else
        Py_DECREF(r);
    }
    for (auto &m : yi->materials) {
      PyObject *d = paramMapToDict(m.second);
      PyObject *nodes = nullptr;
      auto it = yi->material_nodes.find(m.first);
      if (it != yi->material_nodes.end()) {
        nodes = PyList_New(it->second.size());
        for (size_t k = 0; k < it->second.size(); ++k)
          PyList_SET_ITEM(nodes, k, paramMapToDict(it->second[k]));
      } else {
        nodes = Py_None;
        Py_INCREF(Py_None);
      }
      PyObject *args = Py_BuildValue("(sOO)", m.first.c_str(), d, nodes);
      Py_DECREF(d);
      Py_DECREF(nodes);
      PyObject *r = call("create_material", args);
      if (!r) fail = true; else Py_DECREF(r);
    }
    for (auto &l : yi->lights) fail |= !entity("create_light", l.first,
                                               l.second);
    for (auto &c : yi->cameras) fail |= !entity("create_camera", c.first,
                                                c.second);
    if (yi->has_background) {
      PyObject *d = paramMapToDict(yi->background);
      PyObject *r = call("create_background", Py_BuildValue("(O)", d));
      Py_DECREF(d);
      if (!r) fail = true; else Py_DECREF(r);
    }
    for (auto &v : yi->volumes)
      fail |= !entity("create_volume_region", v.first, v.second);
    for (auto &v : yi->views)
      fail |= !entity("create_render_view", v.first, v.second);

    for (auto &o : yi->objects) {
      double smooth_angle = -1.0;
      ParamMap cleaned;
      for (auto &kv : o.params) {
        if (kv.first == "__smooth__")
          smooth_angle = std::get<double>(kv.second);
        else
          cleaned.push_back(kv);
      }
      if (!entity("create_object", o.name, cleaned)) { fail = true; break; }
      if (o.faces.empty()) continue;
      /* zero-copy views over the C++ buffers -> one bulk call */
      PyObject *verts = arr_f32(o.vertices);
      PyObject *faces = arr_i32(o.faces);
      PyObject *fuvs = arr_i32(o.face_uvs);
      PyObject *fmats = arr_i32(o.face_mats);
      PyObject *uvs = Py_None, *norms = Py_None, *orcos = Py_None;
      Py_INCREF(Py_None);
      Py_INCREF(Py_None);
      Py_INCREF(Py_None);
      if (!o.uvs.empty()) {
        Py_DECREF(uvs);
        uvs = arr_f32(o.uvs);
      }
      if (!o.normals.empty()) {
        Py_DECREF(norms);
        norms = arr_f32(o.normals);
      }
      if (!o.orcos.empty()) {
        Py_DECREF(orcos);
        orcos = arr_f32(o.orcos);
      }
      PyObject *args = Py_BuildValue("(OOOOOOO)", verts, faces, uvs, fuvs,
                                     norms, fmats, orcos);
      PyObject *r = call("add_mesh_arrays", args);
      for (PyObject *p : {verts, faces, fuvs, fmats, uvs, norms, orcos})
        Py_XDECREF(p);
      if (!r) { fail = true; break; }
      Py_DECREF(r);
      if (!o.vertices_t1.empty() &&
          o.vertices_t1.size() == o.vertices.size()) {
        PyObject *v1 = arr_f32(o.vertices_t1);
        PyObject *r1 = call("add_mesh_time_step", Py_BuildValue("(O)", v1));
        Py_XDECREF(v1);
        if (!r1) { fail = true; break; }
        Py_DECREF(r1);
      }
      if (smooth_angle >= 0.0) {
        PyObject *r2 = call("smooth_mesh",
                            Py_BuildValue("(sd)", o.name.c_str(),
                                          smooth_angle));
        if (!r2) { fail = true; break; }
        Py_DECREF(r2);
      }
    }
    for (auto &inst : yi->instances) {
      /* pass ALL staged time-step matrices: the builder bakes motion
       * instances into motion keyframes and keeps static instances as
       * TRUE instances (SceneBuilder.add_instance) */
      PyObject *mats = PyList_New((Py_ssize_t)inst.time_steps.size());
      for (size_t k = 0; k < inst.time_steps.size(); ++k)
        PyList_SET_ITEM(mats, (Py_ssize_t)k, matrixToPy(inst.time_steps[k]));
      PyObject *r = call("add_instance",
                         Py_BuildValue("(sO)", inst.base.c_str(), mats));
      Py_DECREF(mats);
      if (!r) { fail = true; break; }
      Py_DECREF(r);
    }
    if (!yi->render_params.empty()) {
      PyObject *d = paramMapToDict(yi->render_params);
      PyObject *r = call("set_render_params", Py_BuildValue("(O)", d));
      Py_DECREF(d);
      if (!r) fail = true; else Py_DECREF(r);
    }
    Py_DECREF(frombuffer);
    ok = !fail;
  } while (false);
  if (PyErr_Occurred()) PyErr_Print();
  Py_XDECREF(mod);
  Py_XDECREF(np);
  PyGILState_Release(g);
  return ok;
}

int yafaray_setupRender(yafaray_Interface_t *yi) {
  /* stage render params; actual compile happens in yafaray_render */
  yi->render_params = yi->params;
  yafaray_paramsClearAll(yi);
  return 1;
}

int yafaray_getSceneFilmWidth(const yafaray_Interface_t *yi) {
  int w = findInt(yi->render_params, "width", 0);
  if (w > 0) return w;
  for (const auto &c : yi->cameras) {
    w = findInt(c.second, "resx", 0);
    if (w > 0) return w;
  }
  return 0;
}
int yafaray_getSceneFilmHeight(const yafaray_Interface_t *yi) {
  int h = findInt(yi->render_params, "height", 0);
  if (h > 0) return h;
  for (const auto &c : yi->cameras) {
    h = findInt(c.second, "resy", 0);
    if (h > 0) return h;
  }
  return 0;
}

/* Fire the render callbacks over one resolved view dict
 * {layer_name: ndarray[H,W,4]} — the ImageFilm::flush callback sequence
 * (imagefilm.cc:570-670). Requires the GIL. */
static void fireFlushCallbacks(yafaray_Interface_t *yi, const char *view,
                               PyObject *layers_dict) {
  if (yi->cb_notify_view)
    yi->cb_notify_view(view, yi->cb_notify_view_data);
  PyObject *items = PyDict_Items(layers_dict);
  if (!items) return;
  Py_ssize_t n = PyList_Size(items);
  int w = 0, h = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *pair = PyList_GetItem(items, i);
    const char *lname = PyUnicode_AsUTF8(PyTuple_GetItem(pair, 0));
    PyObject *arr = PyTuple_GetItem(pair, 1);
    Py_buffer buf;
    if (PyObject_GetBuffer(arr, &buf, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0) {
      PyErr_Clear();
      continue;
    }
    if (buf.ndim == 3 && buf.itemsize == 4) {
      h = static_cast<int>(buf.shape[0]);
      w = static_cast<int>(buf.shape[1]);
      const int c = static_cast<int>(buf.shape[2]);
      const float *px = static_cast<const float *>(buf.buf);
      if (yi->cb_notify_layer)
        yi->cb_notify_layer(lname, lname, w, h, c, yi->cb_notify_layer_data);
      if (yi->cb_put_pixel) {
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            const float *p = px + (static_cast<size_t>(y) * w + x) * c;
            yi->cb_put_pixel(view, lname, x, y, p[0], p[1], p[2],
                             c > 3 ? p[3] : 1.0f, yi->cb_put_pixel_data);
          }
      }
    }
    PyBuffer_Release(&buf);
  }
  Py_DECREF(items);
  if (yi->cb_flush_area)
    yi->cb_flush_area(view, 0, 0, 0, w, h, yi->cb_flush_area_data);
  if (yi->cb_flush) yi->cb_flush(view, yi->cb_flush_data);
}

int yafaray_render(yafaray_Interface_t *yi,
                   yafaray_ProgressCallback_t progress, void *progress_data,
                   int /*display_console*/) {
  yi->canceled = false;
  if (yi->type != YAFARAY_INTERFACE_FOR_RENDERING) {
    /* export interfaces delegate to the Python recorders */
    if (!buildScene(yi)) return 0;
    PyGILState_STATE g = PyGILState_Ensure();
    const char *fn = yi->type == YAFARAY_INTERFACE_EXPORT_XML
                         ? "export_xml"
                         : yi->type == YAFARAY_INTERFACE_EXPORT_C
                               ? "export_c"
                               : "export_python";
    PyObject *mod = PyImport_ImportModule("libyafaray_tpu_torch.io.export");
    int ok = 0;
    if (mod) {
      PyObject *r = PyObject_CallMethod(mod, fn, "Os", yi->builder,
                                        yi->export_path.c_str());
      if (r) { ok = 1; Py_DECREF(r); }
      Py_DECREF(mod);
    }
    if (PyErr_Occurred()) PyErr_Print();
    PyGILState_Release(g);
    return ok;
  }
  if (!buildScene(yi)) return 0;
  yi->progress_cb = progress;
  yi->progress_data = progress_data;
  yi->resx = yafaray_getSceneFilmWidth(yi);
  yi->resy = yafaray_getSceneFilmHeight(yi);
  PyGILState_STATE g = PyGILState_Ensure();
  int ok = 0;
  do {
    PyObject *helper =
        PyImport_ImportModule("libyafaray_tpu_torch.capi_runtime");
    if (!helper) break;
    PyObject *rp = paramMapToDict(yi->render_params);
    if (yi->has_integrator) {
      /* createIntegrator staging reaches the runtime as integrator_* keys */
      for (const auto &kv : yi->integrator_params) {
        PyObject *v = paramValueToPy(kv.second);
        PyDict_SetItemString(rp, ("integrator_" + kv.first).c_str(), v);
        Py_DECREF(v);
      }
    }
    PyObject *outs = PyList_New(yi->outputs.size());
    for (size_t k = 0; k < yi->outputs.size(); ++k) {
      PyObject *d = paramMapToDict(yi->outputs[k].second);
      PyList_SET_ITEM(outs, k,
                      Py_BuildValue("(sN)", yi->outputs[k].first.c_str(), d));
    }
    PyObject *lays = PyList_New(yi->layers.size());
    for (size_t k = 0; k < yi->layers.size(); ++k)
      PyList_SET_ITEM(lays, k, paramMapToDict(yi->layers[k]));
    PyObject *capsule =
        PyCapsule_New(yi, "yafaray_tpu.interface", nullptr);
    PyObject *pass_cb = PyCFunction_New(&pass_cb_def, capsule);
    Py_DECREF(capsule);
    PyObject *r = PyObject_CallMethod(helper, "render_for_capi", "OOOOO",
                                      yi->builder, rp, outs, lays, pass_cb);
    Py_DECREF(rp);
    Py_DECREF(outs);
    Py_DECREF(lays);
    Py_DECREF(pass_cb);
    Py_DECREF(helper);
    if (!r) break;
    /* r = (views_dict, combined_ndarray, resx, resy) */
    PyObject *views = PyTuple_GetItem(r, 0);
    PyObject *img = PyTuple_GetItem(r, 1);
    yi->resx = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 2)));
    yi->resy = static_cast<int>(PyLong_AsLong(PyTuple_GetItem(r, 3)));
    Py_INCREF(img);
    Py_XDECREF(yi->image);
    yi->image = img;
    /* flush callback sequence per view */
    PyObject *vitems = PyDict_Items(views);
    if (vitems) {
      for (Py_ssize_t i = 0; i < PyList_Size(vitems); ++i) {
        PyObject *pair = PyList_GetItem(vitems, i);
        fireFlushCallbacks(yi, PyUnicode_AsUTF8(PyTuple_GetItem(pair, 0)),
                           PyTuple_GetItem(pair, 1));
      }
      Py_DECREF(vitems);
    }
    Py_DECREF(r);
    ok = 1;
    if (progress) progress(1, 1, "done", progress_data);
  } while (false);
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(g);
  yi->progress_cb = nullptr;
  return ok;
}

void yafaray_cancelRendering(yafaray_Interface_t *yi) { yi->canceled = true; }

/* --- render callback registration --- */
void yafaray_setRenderNotifyViewCallback(
    yafaray_Interface_t *yi, yafaray_RenderNotifyViewCallback_t cb,
    void *data) {
  yi->cb_notify_view = cb;
  yi->cb_notify_view_data = data;
}
void yafaray_setRenderNotifyLayerCallback(
    yafaray_Interface_t *yi, yafaray_RenderNotifyLayerCallback_t cb,
    void *data) {
  yi->cb_notify_layer = cb;
  yi->cb_notify_layer_data = data;
}
void yafaray_setRenderPutPixelCallback(yafaray_Interface_t *yi,
                                       yafaray_RenderPutPixelCallback_t cb,
                                       void *data) {
  yi->cb_put_pixel = cb;
  yi->cb_put_pixel_data = data;
}
void yafaray_setRenderFlushAreaCallback(yafaray_Interface_t *yi,
                                        yafaray_RenderFlushAreaCallback_t cb,
                                        void *data) {
  yi->cb_flush_area = cb;
  yi->cb_flush_area_data = data;
}
void yafaray_setRenderFlushCallback(yafaray_Interface_t *yi,
                                    yafaray_RenderFlushCallback_t cb,
                                    void *data) {
  yi->cb_flush = cb;
  yi->cb_flush_data = data;
}
void yafaray_setRenderHighlightAreaCallback(
    yafaray_Interface_t *yi, yafaray_RenderHighlightAreaCallback_t cb,
    void *data) {
  yi->cb_highlight_area = cb;
  yi->cb_highlight_area_data = data;
}
void yafaray_setRenderHighlightPixelCallback(
    yafaray_Interface_t *yi, yafaray_RenderHighlightPixelCallback_t cb,
    void *data) {
  yi->cb_highlight_pixel = cb;
  yi->cb_highlight_pixel_data = data;
}

int yafaray_saveImage(yafaray_Interface_t *yi, const char *path) {
  if (!yi->image) return 0;
  PyGILState_STATE g = PyGILState_Ensure();
  int ok = 0;
  PyObject *mod = PyImport_ImportModule("libyafaray_tpu_torch.io");
  if (mod) {
    PyObject *r = PyObject_CallMethod(mod, "save_image", "sO", path,
                                      yi->image);
    if (r) { ok = 1; Py_DECREF(r); }
    Py_DECREF(mod);
  }
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(g);
  return ok;
}

int yafaray_getImage(yafaray_Interface_t *yi, float *out, size_t capacity) {
  if (!yi->image) return 0;
  PyGILState_STATE g = PyGILState_Ensure();
  int result = 0;
  PyObject *bytes = PyObject_CallMethod(yi->image, "tobytes", nullptr);
  if (bytes) {
    char *buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(bytes, &buf, &len) == 0 &&
        static_cast<size_t>(len) <= capacity * sizeof(float)) {
      std::memcpy(out, buf, len);
      result = (yi->resx << 16) | yi->resy;
    }
    Py_DECREF(bytes);
  }
  if (PyErr_Occurred()) PyErr_Print();
  PyGILState_Release(g);
  return result;
}

/* --- logging --- */
void yafaray_setConsoleVerbosityLevel(yafaray_Interface_t *yi,
                                      yafaray_LogLevel_t level) {
  yi->logger.console_level = level;
}
void yafaray_setLogVerbosityLevel(yafaray_Interface_t *yi,
                                  yafaray_LogLevel_t level) {
  yi->logger.log_level = level;
}
yafaray_LogLevel_t yafaray_logLevelFromString(const char *level) {
  std::string s = level ? level : "";
  if (s == "mute") return YAFARAY_LOG_LEVEL_MUTE;
  if (s == "error") return YAFARAY_LOG_LEVEL_ERROR;
  if (s == "warning") return YAFARAY_LOG_LEVEL_WARNING;
  if (s == "params") return YAFARAY_LOG_LEVEL_PARAMS;
  if (s == "verbose") return YAFARAY_LOG_LEVEL_VERBOSE;
  if (s == "debug") return YAFARAY_LOG_LEVEL_DEBUG;
  return YAFARAY_LOG_LEVEL_INFO;
}
void yafaray_enablePrintDateTime(yafaray_Interface_t *yi,
                                 yafaray_Bool_t value) {
  yi->logger.print_datetime = value == YAFARAY_BOOL_TRUE;
}
void yafaray_setConsoleLogColorsEnabled(yafaray_Interface_t *yi,
                                        yafaray_Bool_t enabled) {
  yi->logger.colors = enabled == YAFARAY_BOOL_TRUE;
}
void yafaray_printDebug(yafaray_Interface_t *yi, const char *msg) {
  yi->logger.log(YAFARAY_LOG_LEVEL_DEBUG, msg);
}
void yafaray_printVerbose(yafaray_Interface_t *yi, const char *msg) {
  yi->logger.log(YAFARAY_LOG_LEVEL_VERBOSE, msg);
}
void yafaray_printInfo(yafaray_Interface_t *yi, const char *msg) {
  yi->logger.log(YAFARAY_LOG_LEVEL_INFO, msg);
}
void yafaray_printParams(yafaray_Interface_t *yi, const char *msg) {
  yi->logger.log(YAFARAY_LOG_LEVEL_PARAMS, msg);
}
void yafaray_printWarning(yafaray_Interface_t *yi, const char *msg) {
  yi->logger.log(YAFARAY_LOG_LEVEL_WARNING, msg);
}
void yafaray_printError(yafaray_Interface_t *yi, const char *msg) {
  yi->logger.log(YAFARAY_LOG_LEVEL_ERROR, msg);
}

/* --- version & tables --- */
int yafaray_getVersionMajor(void) { return YTPU_VERSION_MAJOR; }
int yafaray_getVersionMinor(void) { return YTPU_VERSION_MINOR; }
int yafaray_getVersionPatch(void) { return YTPU_VERSION_PATCH; }
const char *yafaray_getVersionString(void) {
  return "libyafaray_tpu_torch 0.2.0";
}

static char *dupString(const std::string &s) {
  char *out = static_cast<char *>(std::malloc(s.size() + 1));
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

char *yafaray_getLayersTable(const yafaray_Interface_t *yi) {
  std::string s = "layer | exported image | type\n";
  s += "combined | - | ColorAlpha\n";
  for (const auto &pm : yi->layers) {
    s += findString(pm, "type", "?");
    s += " | ";
    s += findString(pm, "exported_image_name", "-");
    s += " | ";
    s += findString(pm, "exported_image_type", "ColorAlpha");
    s += "\n";
  }
  return dupString(s);
}

char *yafaray_getViewsTable(const yafaray_Interface_t *yi) {
  std::string s = "view | camera | wavelength\n";
  for (const auto &v : yi->views) {
    s += v.first;
    s += " | ";
    s += findString(v.second, "camera_name", "-");
    s += " | ";
    char buf[32];
    std::snprintf(buf, sizeof(buf), "%g",
                  [&] {
                    for (const auto &kv : v.second)
                      if (kv.first == "wavelength")
                        if (auto *d = std::get_if<double>(&kv.second))
                          return *d;
                    return 0.0;
                  }());
    s += buf;
    s += "\n";
  }
  return dupString(s);
}

void yafaray_deallocateCharPointer(char *ptr) { std::free(ptr); }

}  // extern "C"
