/* yafaray_tpu C public API, as the PyTorch / CUDA port builds it.
 *
 * The same extern "C" surface as the JAX package's
 * native/include/yafaray_tpu_c_api.h, mirroring the reference's
 * include/public_api/yafaray_c_api.h:31-130 (opaque interface handle, typed
 * parameter staging, geometry streaming, entity factories, RAM images,
 * outputs, layers, render + the full callback set). The implementation
 * (yafaray_tpu_c_api.cc) stages parameters and geometry in native C++
 * buffers and drives libyafaray_tpu_torch through an embedded interpreter;
 * geometry crosses the boundary zero-copy as numpy views over the C++
 * vectors.
 */
#ifndef YAFARAY_TPU_C_API_H
#define YAFARAY_TPU_C_API_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct yafaray_Interface yafaray_Interface_t;
typedef struct yafaray_Image yafaray_Image_t;

typedef enum {
  YAFARAY_INTERFACE_FOR_RENDERING = 0,
  YAFARAY_INTERFACE_EXPORT_XML = 1,
  YAFARAY_INTERFACE_EXPORT_C = 2,
  YAFARAY_INTERFACE_EXPORT_PYTHON = 3,
} yafaray_InterfaceType_t;

typedef enum {
  YAFARAY_BOOL_FALSE = 0,
  YAFARAY_BOOL_TRUE = 1,
} yafaray_Bool_t;

typedef enum {
  YAFARAY_LOG_LEVEL_MUTE = 0,
  YAFARAY_LOG_LEVEL_ERROR = 1,
  YAFARAY_LOG_LEVEL_WARNING = 2,
  YAFARAY_LOG_LEVEL_PARAMS = 3,
  YAFARAY_LOG_LEVEL_INFO = 4,
  YAFARAY_LOG_LEVEL_VERBOSE = 5,
  YAFARAY_LOG_LEVEL_DEBUG = 6,
} yafaray_LogLevel_t;

typedef void (*yafaray_ProgressCallback_t)(int done, int total,
                                           const char *tag, void *data);
typedef void (*yafaray_LoggerCallback_t)(yafaray_LogLevel_t level,
                                         double time, const char *message,
                                         void *data);
/* Render callbacks (reference yafaray_c_api.h:41-48). */
typedef void (*yafaray_RenderNotifyViewCallback_t)(const char *view_name,
                                                   void *data);
typedef void (*yafaray_RenderNotifyLayerCallback_t)(
    const char *internal_layer_name, const char *exported_layer_name,
    int width, int height, int exported_channels, void *data);
typedef void (*yafaray_RenderPutPixelCallback_t)(
    const char *view_name, const char *layer_name, int x, int y, float r,
    float g, float b, float a, void *data);
typedef void (*yafaray_RenderFlushAreaCallback_t)(const char *view_name,
                                                  int area_id, int x0, int y0,
                                                  int x1, int y1, void *data);
typedef void (*yafaray_RenderFlushCallback_t)(const char *view_name,
                                              void *data);
typedef void (*yafaray_RenderHighlightAreaCallback_t)(
    const char *view_name, int area_id, int x0, int y0, int x1, int y1,
    void *data);
typedef void (*yafaray_RenderHighlightPixelCallback_t)(
    const char *view_name, int x, int y, float r, float g, float b, float a,
    void *data);

/* --- lifecycle --- */
yafaray_Interface_t *yafaray_createInterface(
    yafaray_InterfaceType_t type, const char *export_path,
    yafaray_LoggerCallback_t logger, void *logger_data, int console_verbosity);
void yafaray_destroyInterface(yafaray_Interface_t *yi);
void yafaray_setLoggingCallback(yafaray_Interface_t *yi,
                                yafaray_LoggerCallback_t logger, void *data);
/* Reset all staged scene state (reference yafaray_clearAll /
 * yafaray_createScene-on-existing-scene semantics). */
void yafaray_clearAll(yafaray_Interface_t *yi);

/* --- parameter staging (ParamMap analogue) --- */
void yafaray_paramsClearAll(yafaray_Interface_t *yi);
void yafaray_paramsSetBool(yafaray_Interface_t *yi, const char *name,
                           yafaray_Bool_t value);
void yafaray_paramsSetInt(yafaray_Interface_t *yi, const char *name,
                          int value);
void yafaray_paramsSetFloat(yafaray_Interface_t *yi, const char *name,
                            double value);
void yafaray_paramsSetString(yafaray_Interface_t *yi, const char *name,
                             const char *value);
void yafaray_paramsSetVector(yafaray_Interface_t *yi, const char *name,
                             double x, double y, double z);
void yafaray_paramsSetColor(yafaray_Interface_t *yi, const char *name,
                            double r, double g, double b, double a);
void yafaray_paramsSetMatrix(yafaray_Interface_t *yi, const char *name,
                             const double m[4][4]);
/* Append one time-step matrix under `name` (reference
 * yafaray_paramsSetMatrixArray: motion-blur instance matrices). */
void yafaray_paramsSetMatrixArray(yafaray_Interface_t *yi, const char *name,
                                  const double m[4][4]);
void yafaray_paramsPushList(yafaray_Interface_t *yi);
void yafaray_paramsEndList(yafaray_Interface_t *yi);
/* Color space applied to subsequent paramsSetColor calls ("sRGB",
 * "LinearRGB", "Raw_Manual_Gamma"; reference yafaray_setInputColorSpace). */
void yafaray_setInputColorSpace(yafaray_Interface_t *yi,
                                const char *color_space, float gamma);

/* --- entity creation (factory dispatch by staged "type" param) --- */
int yafaray_createScene(yafaray_Interface_t *yi);
int yafaray_createMaterial(yafaray_Interface_t *yi, const char *name);
int yafaray_createTexture(yafaray_Interface_t *yi, const char *name);
int yafaray_createLight(yafaray_Interface_t *yi, const char *name);
int yafaray_createCamera(yafaray_Interface_t *yi, const char *name);
int yafaray_defineBackground(yafaray_Interface_t *yi);
/* Same as defineBackground but named, matching the reference's
 * yafaray_createBackground(name). */
int yafaray_createBackground(yafaray_Interface_t *yi, const char *name);
int yafaray_createVolumeRegion(yafaray_Interface_t *yi, const char *name);
int yafaray_createRenderView(yafaray_Interface_t *yi, const char *name);
/* Stage the surface integrator from the current params (reference
 * yafaray_createIntegrator; params reach the render as integrator_*). */
int yafaray_createIntegrator(yafaray_Interface_t *yi, const char *name);
/* Named image output: staged params image_path / color_space / gamma /
 * alpha_premultiply / badge; all outputs are written at render flush. */
int yafaray_createOutput(yafaray_Interface_t *yi, const char *name);
yafaray_Bool_t yafaray_removeOutput(yafaray_Interface_t *yi,
                                    const char *name);
void yafaray_clearOutputs(yafaray_Interface_t *yi);
/* Request an extra exported AOV layer from the staged params ("type" =
 * internal layer name e.g. "z-depth-norm", optional exported_image_name /
 * exported_image_type; reference yafaray_defineLayer). */
void yafaray_defineLayer(yafaray_Interface_t *yi);

/* --- RAM images (reference yafaray_createImage/setImageColor/getImageColor);
 * staged params: width, height, optional type/image_type. A texture created
 * with type "image" and param "image_name" samples the RAM image. --- */
yafaray_Image_t *yafaray_createImage(yafaray_Interface_t *yi,
                                     const char *name);
yafaray_Bool_t yafaray_setImageColor(yafaray_Image_t *img, int x, int y,
                                     float r, float g, float b, float a);
yafaray_Bool_t yafaray_getImageColor(const yafaray_Image_t *img, int x, int y,
                                     float *r, float *g, float *b, float *a);

/* --- geometry streaming (native-buffer fast path) --- */
yafaray_Bool_t yafaray_startGeometry(yafaray_Interface_t *yi);
yafaray_Bool_t yafaray_endGeometry(yafaray_Interface_t *yi);
int yafaray_createObject(yafaray_Interface_t *yi, const char *name);
yafaray_Bool_t yafaray_endObject(yafaray_Interface_t *yi);
unsigned int yafaray_getNextFreeId(yafaray_Interface_t *yi);
int yafaray_addVertex(yafaray_Interface_t *yi, double x, double y, double z);
int yafaray_addVertexWithOrco(yafaray_Interface_t *yi, double x, double y,
                              double z, double ox, double oy, double oz);
/* Second-keyframe position for motion blur (b-spline triangle analogue). */
int yafaray_addVertexTimeStep(yafaray_Interface_t *yi, double x, double y,
                              double z);
void yafaray_addNormal(yafaray_Interface_t *yi, double x, double y, double z);
int yafaray_addUv(yafaray_Interface_t *yi, double u, double v);
int yafaray_addTriangle(yafaray_Interface_t *yi, int a, int b, int c);
int yafaray_addTriangleWithUv(yafaray_Interface_t *yi, int a, int b, int c,
                              int uv_a, int uv_b, int uv_c);
void yafaray_setCurrentMaterial(yafaray_Interface_t *yi, const char *name);
void yafaray_smoothMesh(yafaray_Interface_t *yi, const char *name,
                        double angle);
int yafaray_addInstance(yafaray_Interface_t *yi, const char *base_name,
                        const double m[4][4]);
/* Append a time-step matrix to the last-added instance (reference
 * yafaray_addInstanceArray; motion-blur instances). */
int yafaray_addInstanceArray(yafaray_Interface_t *yi, const char *base_name,
                             const double m[4][4]);

/* --- render --- */
int yafaray_setupRender(yafaray_Interface_t *yi);
int yafaray_render(yafaray_Interface_t *yi,
                   yafaray_ProgressCallback_t progress, void *progress_data,
                   int display_console);
void yafaray_cancelRendering(yafaray_Interface_t *yi);
int yafaray_getSceneFilmWidth(const yafaray_Interface_t *yi);
int yafaray_getSceneFilmHeight(const yafaray_Interface_t *yi);

/* --- render callbacks (fired at pass highlight + final flush, mirroring
 * ImageFilm::flush, reference imagefilm.cc:570-670) --- */
void yafaray_setRenderNotifyViewCallback(
    yafaray_Interface_t *yi, yafaray_RenderNotifyViewCallback_t cb,
    void *data);
void yafaray_setRenderNotifyLayerCallback(
    yafaray_Interface_t *yi, yafaray_RenderNotifyLayerCallback_t cb,
    void *data);
void yafaray_setRenderPutPixelCallback(yafaray_Interface_t *yi,
                                       yafaray_RenderPutPixelCallback_t cb,
                                       void *data);
void yafaray_setRenderFlushAreaCallback(yafaray_Interface_t *yi,
                                        yafaray_RenderFlushAreaCallback_t cb,
                                        void *data);
void yafaray_setRenderFlushCallback(yafaray_Interface_t *yi,
                                    yafaray_RenderFlushCallback_t cb,
                                    void *data);
void yafaray_setRenderHighlightAreaCallback(
    yafaray_Interface_t *yi, yafaray_RenderHighlightAreaCallback_t cb,
    void *data);
void yafaray_setRenderHighlightPixelCallback(
    yafaray_Interface_t *yi, yafaray_RenderHighlightPixelCallback_t cb,
    void *data);

/* --- output --- */
int yafaray_saveImage(yafaray_Interface_t *yi, const char *path);
/* RGBA float32 pixel buffer of the last render (size resx*resy*4);
 * returns resx<<16|resy, or 0 if no render happened. */
int yafaray_getImage(yafaray_Interface_t *yi, float *out, size_t capacity);

/* --- logging (reference Logger: 7 levels, console + callback) --- */
void yafaray_setConsoleVerbosityLevel(yafaray_Interface_t *yi,
                                      yafaray_LogLevel_t level);
void yafaray_setLogVerbosityLevel(yafaray_Interface_t *yi,
                                  yafaray_LogLevel_t level);
yafaray_LogLevel_t yafaray_logLevelFromString(const char *level);
void yafaray_enablePrintDateTime(yafaray_Interface_t *yi,
                                 yafaray_Bool_t value);
void yafaray_setConsoleLogColorsEnabled(yafaray_Interface_t *yi,
                                        yafaray_Bool_t enabled);
void yafaray_printDebug(yafaray_Interface_t *yi, const char *msg);
void yafaray_printVerbose(yafaray_Interface_t *yi, const char *msg);
void yafaray_printInfo(yafaray_Interface_t *yi, const char *msg);
void yafaray_printParams(yafaray_Interface_t *yi, const char *msg);
void yafaray_printWarning(yafaray_Interface_t *yi, const char *msg);
void yafaray_printError(yafaray_Interface_t *yi, const char *msg);

/* --- version & tables (char* results are heap-allocated; release with
 * yafaray_deallocateCharPointer) --- */
int yafaray_getVersionMajor(void);
int yafaray_getVersionMinor(void);
int yafaray_getVersionPatch(void);
const char *yafaray_getVersionString(void);
char *yafaray_getLayersTable(const yafaray_Interface_t *yi);
char *yafaray_getViewsTable(const yafaray_Interface_t *yi);
void yafaray_deallocateCharPointer(char *ptr);

#ifdef __cplusplus
}
#endif

#endif /* YAFARAY_TPU_C_API_H */
