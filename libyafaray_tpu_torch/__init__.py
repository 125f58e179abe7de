"""libyafaray_tpu_torch: the PyTorch / CUDA port of libyafaray_tpu.

A second package beside the JAX one, held against it module by module. It
imports torch and numpy only. The forward path renders every BASELINE
config of the JAX bench: the Cornell box (with shiny-diffuse and glossy
materials), the 203k-triangle terrain of config 3 (image-textured), the
glass caustic scene of config 4 and the single-scatter volume of config 5
(a mesh light, `light_mat`, a uniform fog), and the forest (the terrain
under true instances, some of them moving) under the `pathtracing` and
`directlighting` integrators, with every material and light type of the
JAX package, transparent shadows, chromatic dispersion and the Beer and
sss glass interiors, every procedural texture type over its noise bases,
orco coordinates, every volume region type and the emission,
single-scatter (with its attenuation grid and adaptive marching) and sky
volume integrators, ambient occlusion, the debug integrator, and the
photon-mapping (with its final gather and map files), SPPM (with PM_IRE;
`integrators.sppm.render_sppm`) and bidirectional (with light-tracing
splats) integrators. `render` runs the multi-pass loop of libYafaRay's
clients: adaptive AA over compacted wavefronts of the flagged pixels, the
reconstruction filters, every AOV layer of the JAX package, film save,
resume and merge in its `.film.npz` format, and the photon maps'
processing modes; `io` writes and reads its image files. Scenes compile
without a background, and per render view (`compile_view`: its camera,
its lights, its fixed wavelength). libYafaRay's clients reach it as they
reach the JAX package: `io.export` writes a staged scene as XML, C or
Python, `io.import_xml.load_xml` reads the XML back, and
`capi_runtime.render_for_capi` is the render behind the port's C API
library (`native/`, built with `capi_build`), on the card unless the
render param "device" names another. Every accelerator of the JAX
package compiles: brute force at any face count, the block accelerator
(true instances of meshes) and the LBVH (`scene_accelerator: "bvh"`,
built on the card); instances of spheres and curves are baked. Torch
autograd runs through it: material
and light parameters get gradients, which stop at the intersection
queries as in the JAX package, and `make_train_step` takes an
inverse-rendering SGD step. Several processes render together on
`torch.distributed` (`parallel`): `make_mesh` over the process group,
`render_wavefront_sharded` / `render_sharded` split the pixels over it,
`make_train_step(..., mesh=)` averages the loss and the gradients across
it, `film.psum_merge` merges films, and `parallel.distributed` starts a
render farm (`init_distributed`, `render_node_film`). `render(...,
stats=)` fills a `utils.profiling.RenderStats`; `utils.profiling.trace`
and `device_op_summary` attribute device time to kernels; `utils.logger`
and `utils.sysinfo` are the reference's logger, timers, progress bar and
build info; `io.postprocess.draw_badge` stamps the render-stats banner.
`SceneBuilder.compile`, `render`, `make_train_step` and the meshes run on
the CUDA card unless the caller names another device; importing the
package initializes neither CUDA nor a process group. On the card every
intersection query runs a hand-written kernel: `csrc/mt_intersect.cu` on
the brute-force path (`accel/mt_intersect.py`), `csrc/tiles_traverse.cu`
(static, motion-blur and instancing arms) on the block accelerator
(`accel/tiles.py`), `csrc/lbvh_traverse.cu` on the LBVH
(`accel/lbvh.py`); `csrc/probe_smem.cu` (`accel/probe_smem.py`) probes
the card's shared memory per block.
"""
from . import color, film, io, params, sampler
from .integrators.mc import IntegratorConfig, make_integrator
from .parallel import make_mesh, make_train_step, render_sharded
from .render import AAParams, render, render_pass_fn
from .scene import SceneBuilder
from .scene_types import SceneData

__version__ = "0.1.0"

__all__ = [
    "SceneBuilder", "SceneData", "IntegratorConfig", "make_integrator",
    "render", "render_pass_fn", "AAParams", "color", "film", "io", "params",
    "sampler", "make_mesh", "make_train_step", "render_sharded",
]
