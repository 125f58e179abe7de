#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (libyafaray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reporting on its own lines:
  1. environment: torch and CUDA versions, nvcc, the card's name and power
     limit, the port's sysinfo line (utils.sysinfo); the shared-memory
     probe (kernel d): the largest dynamic shared memory a launch takes
     must equal the card's opt-in limit per block, and its output must be
     exactly 2.0; its launch timed beside a one-element PyTorch fill, the
     launch floor its one launch cannot go under;
  2. build: compiles the five CUDA sources of the package (one nvcc each,
     all started together) before phase 1 reports, timed;
  3. mt_closest against its plain version mt_closest_ref on the card, bit
     for bit (prim ids equal on every ray, max |diff| of t, u and v 0): the
     kernel's edge cases (`mt_edge_cases`: a table without shadow casters,
     visible and invisible rows interleaved across a chunk boundary, an
     exact tie across an invisible row, dead rays among live ones and whole
     dead warps); the Cornell table with random rays; random tables of 300,
     2,047 and 16,384 triangles (384, 2,048 and 16,384 rows) and both
     motion-blur arms at 200 triangles, closest and shadow, excluded ids,
     ray counts not a multiple of the block; the exact-tie case; the ten
     queries of one Cornell pass at 1920x1080 (sample 0, 4 bounces) and the
     ten of one pass of the golden's baked cubes (96 rows, directlighting)
     at the same size, captured as they reach mt_closest. Each timed query
     is printed with its live rays (t_max > t_min), the rows its
     visibility bit keeps, its bound and the kernel's time; kernel and
     plain times for 1080p camera rays against the Cornell table;
 3b. tile_walk (the tiles_traverse kernel) against tile_walk_ref on the
     card, on sorted rays: the 203,522-triangle terrain table (1591 blocks
     of 128) with camera rays and random rays, closest and shadow, excluded
     ids, 1/7 dead rays, ray counts not a multiple of 128; any hit on the
     same table; a 2,415,602-triangle terrain table (blocks of 1024, 8
     sub-chunks, about 155 MB: above the TPU kernel's 96 MiB VMEM budget);
     an exact tie inside a sub-chunk. Closest: prim ids equal on every ray,
     t/u/v within rtol 1e-6; any hit: hit/miss equal on every ray. Kernel
     and plain times per query on the camera and first shadow wavefronts,
     and on the big table (the regime of the TPU's streaming kernel c),
     each beside the pair tests its data needs and its bound;
 3c. the motion-blur and instancing arms of tile_walk against tile_walk_ref
     on the card, on sorted rays with random shutter times: the terrain
     table with synthetic keyframes (linear and quadratic) and the forest's
     instanced table (instanced alone, and with its linear keyframes);
     camera rays (closest, shadow and any hit, 1/7 dead, excluded ids) and
     random rays; each arm's time per camera query beside the static arm's
     on the same rays; then two incoherent wavefronts captured from a
     forest pass (the background light's shadow rays at depth 0, any hit,
     and the first bounce, closest hit), checked the same way and timed
     beside their bounds;
  4. the Cornell box at 1920x1080, 16 spp, 4 bounces through `render`, with
     every intersection query counted on mt_closest, plausibility checks,
     ms per pass, camera rays/s and the kernel's share of a pass;
  5. Cornell kernel path against plain path end to end: 256x256, 2 spp;
  6. the slice: the terrain of BASELINE config 3 (untextured, 203,522
     triangles) at 720x720, 6 spp, 2 bounces through `render` with no
     device argument, with the tile kernel's launches counted, image
     checks, ms per pass, camera rays/s, one pass split by CUDA events
     into kernel, tile_candidates, ray sort/unsort and the rest, each of
     its nine kernel launches beside the pair tests its query needs and
     its bound, and peak device memory;
  7. terrain kernel path against plain path end to end: 128x128, 1 spp;
  8. the slice: the forest (the terrain under 2,000 true instances of a
     96-triangle rock and 16 moving baked ones) at 720x720, 6 spp, 2
     bounces through `render` with no device argument: every tile-kernel
     launch must be the instanced + linear-motion arm; image checks, ms per
     pass, camera rays/s, the pass split by CUDA events (with each launch's
     bound, as in phase 6), peak device memory, the physical and virtual
     table bytes;
  9. forest kernel path against plain path end to end: 128x128, 1 spp;
 10. the instanced cubes against the libYafaRay golden
     tests/golden/instances_ref_160.hdr (160x160, 16 spp, directlighting,
     image x pi), true instances (block accelerator, instancing arm) and
     baked copies (brute force, mt_closest): global scale within 1%,
     4x4-downsampled mean relative error < 0.01 and p99 < 0.04; the two
     renders within 2e-3 of each other;
 11. the headline, forward + backward: the Cornell box at 1920x1080, 16
     spp, 4 bounces, the gradient of mean(rgb) with respect to
     materials.diffuse_color per chunk of 270 rows (518,400 rays) at the
     pixel centres, samples 0-15 (bench.py's bench_cornell_fwd_bwd): ms
     per image and per spp pass, camera rays/s, forward and backward ms
     from CUDA events, peak device memory, mt_closest's launches (10 per
     chunk) and their ms; the ten queries of one chunk held bit for bit
     against mt_closest_ref and timed alone beside it and their bounds
     (the kernels line reports mt_closest per launch at this shape); the
     backward of `take` (its kernel, take_grad) against plain indexing's
     on one chunk's gathers; the gradient finite and not zero, and the
     same chunk twice gives the same gradient (rtol 1e-6);
 12. gradients (diffuse_color, lights.color) through the kernel path
     against the plain path, within rtol 1e-5: the Cornell box at 256x256,
     2 spp, 4 bounces (mt_closest) and the terrain at 128x128, 1 spp, 2
     bounces (tile_walk);
 13. BASELINE config 2: the glossy Cornell box at 512x512, 16 spp, 4
     bounces through `render` (ms per pass, camera rays/s); its kernel
     and plain paths at 256x256, 2 spp; the Blinn exponent's gradient
     through both paths on the Cornell box with a glossy slab (config 2
     compiles its glossy material, but no face uses it);
 14. make_train_step: five SGD steps on the Cornell diffuse colours at
     256x256, 1 bounce, target 0.25, sample 0; the loss must decrease;
 15. the Cornell box under directlighting (the lamp invisible to camera
     rays, one light sample) at 256x256, 96 spp against the libYafaRay
     golden tests/golden/cornell_ref_256.hdr (image x pi): global scale
     within 1%, mean relative error < 4%, 4x4-downsampled p99 < 6% and
     max < 15% (tests/test_refparity.py's bounds);
 16. the slice: BASELINE config 3 as the bench runs it, the image-textured
     terrain (bigmesh_builder(320), a 64x64 texture on uv through a
     texture_mapper node) at 720x720, 6 spp, 2 bounces through `render`:
     every launch the static arm, 54 of them; the split of a pass as in
     phase 6; the top row the sky, the mean alpha phase 6's, the texture
     visible (most covered pixels differ from phase 6's by more than
     1e-2); kernel path against plain path at 128x128, 1 spp; one pass of
     each terrain profiled: kernel launches per pass and device busy share;
 17. the cover-order any hit (YAF_COVER_ORDER=1): every any-hit query of one
     textured-terrain pass and of one forest pass, walked by tile_walk in
     cover order against tile_walk_ref (hit/miss equal on every ray) and
     against the same query front to back, each timed beside its bound
     (the pair tests of each live ray with its tile's candidates up to its
     first hit, tile_walk_ref's `steps`), the prepass
     with and without coverage timed on each; random any-hit rays on phase
     3b's 2.4M-triangle table the same way; the textured terrain rendered
     in cover order at phase 16's size must equal phase 16's image bit
     for bit, with both passes' ms;
 18. texel gradients: the gradient of mean(rgb) with respect to
     textures.texel_pool on the textured terrain at 128x128, 1 spp,
     through the kernel path against the plain path, and the kernel path
     twice (rtol 1e-4: the texel gathers' backward is index_put_ with
     accumulate, whose order on the card is its own); at 720x720, 1 spp,
     the forward and backward ms, peak device memory and tile_walk's
     launches in that run (9).
 19. BASELINE config 4 as bench.py runs it: the glass caustic scene
     (caustic_grad_builder(512, 512)) forward + backward at 512x512, 5
     bounces, pixel centres, samples 1-4, with respect to materials.ior
     and textures.texel_pool: ms per forward + backward, camera rays/s,
     forward and backward ms from CUDA events, peak device memory,
     mt_closest's launches (12 a sample); the IOR gradient and the texel
     gradient's L1 finite and not zero; sample 0 twice gives the same
     gradients (within 1e-6 of the largest); the queries of one forward
     held bit for bit against mt_closest_ref, each timed beside its bound;
     one forward + backward profiled (kernel launches, device busy share);
     kernel path against plain path at 128x128, 1 spp: the image (the
     slice tolerance), the IOR gradient (rtol 1e-5) and the texel
     gradient (rtol 1e-4 plus 1e-6 of the largest);
 20. BASELINE config 5 as bench.py runs it: the homogeneous single-scatter
     volume lit by an emissive mesh (volume_emissive_builder) at 512x512,
     8 spp, 3 bounces, 16 volume steps, through `render` with no device
     argument: ms per pass, camera rays/s, peak device memory,
     mt_closest's launches (28 a pass), one pass profiled (kernel launches,
     device busy share); the image finite, changed by the fog on 99% of
     pixels against the same scene without its volume region, the glow
     triangle bright and warm; the camera segments' mean transmittance
     below 1 and in-scattered radiance above 0; one pass's queries (the 16
     in-scatter shadow queries last) held bit for bit against
     mt_closest_ref, each timed beside its bound; kernel path against
     plain path at 128x128, 1 spp.
 21. every camera type: the Cornell box at 1920x1080, 16 spp, 4 bounces
     through `render` under the orthographic, architect, angular and
     equirectangular cameras and the perspective camera with depth of field
     (aperture 0.05, focus 2.0 on the back boxes; disk and hexagon bokeh):
     ms per pass, camera rays/s, mt_closest's launches (10 a pass); each
     at 256x256, 2 spp, kernel path against plain path; the four camera
     goldens tests/golden/cornell_{ortho,archi,angular,equi}_128.hdr at
     128x128, 24 spp, directlighting (image x pi): global scale within 1%,
     4x4-downsampled mean and p99 relative error within
     tests/test_refparity.py's bounds;
 22. the analytic skies: the textured terrain (phase 16's scene) with a
     sunsky (add_sun, ibl) and a darksky at altitude 0 in place of its sun
     and constant background, 720x720, 6 spp, 2 bounces: the pass as in
     phase 16 (54 static-arm launches), one pass profiled (launches, device
     busy share), kernel path against plain path at 128x128, 1 spp; the
     sky goldens tests/golden/sky_{sunsky,darksky}_128.hdr at 4 spp
     (tests/test_refparity.py's bounds);
 23. analytic spheres and environment maps: the glossy golden scene (a
     sphere on a textured floor) at 1920x1080, 8 spp, 3 bounces on the
     brute-force path (mt_closest and the sphere arm) and on blocks (the
     tile kernel and `sphere_pass`), the two images within the slice bound;
     the same scene lit by a 1024x512 environment map (a smooth sky and a
     sun disc 1,000 times brighter; ibl through its importance tables)
     with a curve, at the same size, and at 128x128 kernel path against
     plain path; the golden tests/golden/glossy_ref_128.hdr at 64 spp
     (region ratios and the floor profile's correlation,
     tests/test_refparity.py's bounds).
 24. every material and light type: the materials Cornell box
     (materials_cornell_builder: Oren-Nayar, coated glossy, a blend and a
     mask by a texture node, rough glass, dispersive glass with Beer
     absorption, sss glass, a transparent veil, a null quad; area, spot,
     IES, sphere and directional lights) at 1920x1080, 2 spp, 4 bounces,
     transparent shadows at depth 4, on brute force (130 mt_closest
     launches a pass: the camera query, 4 bounces and 125 closest-shadow
     queries of the walk, 5 lights x 5 steps x 5 depths), ms a pass,
     camera rays/s, one pass's launches by kind with their time against
     their bounds, one pass profiled (device busy share), peak device
     memory; the same on blocks (130 tile-kernel launches a pass) within
     the slice bound of brute force; kernel path against plain path at
     128x128 (brute force bit for bit; blocks the slice bound); eight
     closest-shadow queries of a pass held against mt_closest_ref (bit for
     bit, each timed beside its bound) and against tile_walk_ref; forward
     + backward at 1920x1080, 1 spp, in chunks of 270 rows wrt the coated-glossy colour, the Oren-Nayar sigma, the light
     colours and the glass absorption, and the same gradients kernel path against plain
     path at 128x128 (rtol 1e-5);
 25. the portal room (portal_room_builder: a bgPortalLight over the window
     of a closed room) at 1920x1080, 2 spp, 4 bounces:
     ms a pass, launches (10 a pass), the floor under the window lit;
     kernel path against plain path at 128x128 bit for bit.
 26. procedural textures and orco coordinates: the procedural Cornell box
     (procedural_cornell_builder: blend, clouds, marble, wood, voronoi,
     musgrave, distorted noise and rgb cube over the newperlin, stdperlin
     and cellnoise bases, a colour ramp, bump through clouds, a cube that
     streams orco coordinates and a slab mapped on its own vertices) at
     1920x1080, 2 spp, 4 bounces through `render` on brute force (10
     mt_closest launches a pass) and on blocks (10 tile-kernel launches),
     the two images within the slice bound; ms a pass, camera rays/s, one
     pass profiled (kernel launches, device busy share, the node
     program's device time), peak device memory; kernel path against
     plain path at 128x128 on both (brute force bit for bit);
 27. the rest of the volume path at 512x512, 1 spp, 3 bounces through
     `render` (volume_regions_builder): the exponential, noise, grid and
     sky regions under single scatter (28 mt_closest launches a pass, the
     last 16 the in-medium shadow queries), the exponential and noise
     regions with "optimize" (the attenuation grid's build timed), the
     grid with "adaptive", the noise region under the EmissionIntegrator
     (it emits) and the Cornell box under a constant background with the
     SkyIntegrator; each: ms a pass, launches a pass, the image changed
     by the volume against the same scene without it, kernel path against
     plain path at 128x128; one pass of the grid profiled; the in-medium
     shadow queries of one pass of the exponential, grid and sky regions
     held bit for bit against mt_closest_ref and timed beside their
     bounds.
 28. the render loop as users drive it: the Cornell box at 1920x1080, 4
     bounces, through `render` with no device argument, adaptive AA (4
     samples, then 3 passes of 2 on the flagged pixels, threshold 0.05,
     the curve's dark detection), the Gauss filter of width 1.5 and 17 AOV
     layers (first-hit, accumulated and flush kinds), on brute force (10
     mt_closest launches a sample) and on blocks (10 tile-kernel
     launches), every layer within the slice bound of the other's (the
     curve flags every pixel, so its later passes are compacted
     wavefronts of the whole image); the same with a flat threshold,
     whose compacted wavefronts hold a fifth of it or less. Per pass its
     kind, lanes, ms and the flagged fraction; one more render of each
     accelerator with every query timed (live rays, ms, bound per pass
     kind) and the filter splat's ms; the first compacted sample's
     queries held bit for bit against mt_closest_ref on brute force, and
     against tile_walk_ref on blocks (prim ids, t/u/v within 1e-6
     relative, hit/miss on the any hits), each timed beside its bound; a
     pass with 17
     layers against one with combined alone; peak memory. At 256x256 both
     adaptive renders through the kernel path against the plain path:
     every layer and noise mask bit for bit on brute force, every layer
     within the slice bound on blocks. Then directlighting with ambient
     occlusion (8 samples: 8 more launches a pass; the AO queries of one
     pass held bit for bit and timed), one debug-integrator pass (one
     launch), and 2 + 2 spp saved to a film file and resumed, equal bit
     for bit to 4 spp.
 29. the last three integrators: photon mapping as its defaults set it
     (100,000 photons of 5 bounces, radius 0.05, the final gather with 16
     samples of up to 3 bounces) on the Cornell box at 1920x1080, 2 spp,
     on brute force and on blocks (the two images within the slice
     bound), the maps built once and timed; the caustic scene (config 4)
     at 512x512 with its caustic map; a generate-save render and a load
     render of the same maps at 512x512, equal bit for bit; SPPM at
     1080p, 8 passes of 50,000 photons, without and with PM_IRE; the
     bidirectional integrator at 1080p, 4 bounces, 2 spp, with the area
     light and with a point light (the splats land). For each: ms a
     pass, launches a pass by kind (camera, bounce, photon, gather,
     connection, splat), peak device memory, the walls red and green.
     At 128x128 each integrator's kernel path against its plain path,
     the images bit for bit and every query of the kernel run equal to
     mt_closest_ref's; on blocks the photon walks of 100,000 photons
     held against tile_walk_ref.
 30. the public entry points: the port's C API library
     (libyafaray_tpu_torch/native/, embedding this Python) and its two C
     clients built with g++ / gcc (capi_build.py) and run as their own
     processes with no device staged, so on the card: each prints its OK
     line, and test00's printed mean and wall sums equal those of its
     staging replayed in this process through render_for_capi (within
     1e-6); export_xml, load_xml and render_for_capi of the Cornell box at
     1920x1080 (16 spp, 4 bounces) and of the terrain at 720x720 (6 spp, 2
     bounces), each equal bit for bit to `render` of the original builder
     (the terrain's is phase 6's image), with the XML's export and parse
     seconds; render views at 1920x1080 and 4 spp through render_for_capi
     (two views of the Cornell box, one with a subset of the lights, and a
     spectral view of a dispersive glass block at a fixed wavelength),
     named outputs written per view, each view equal bit for bit to
     render(compile_view(view)); render_for_capi at 128x128, 2 spp, kernel
     path against plain path on brute force and on blocks, the images bit
     for bit, every mt_closest query equal to mt_closest_ref bit for bit
     and every tile_walk query to tile_walk_ref.

 31. the accelerators complete (each path's kernel counts set to 0 just
     before its render and read just after): the LBVH
     (scene_accelerator "bvh", built on the card; each tree's depth beside
     its refit passes) on the Cornell box at 1920x1080, 16 spp, 4 bounces
     (lbvh_traverse alone, 10 launches a pass) within the slice bound of
     the brute-force render, one pass's queries held bit for bit against
     lbvh_traverse_ref and timed beside their bounds (the box, face and
     sphere tests each walk needed): the kernel alone (its C entry point
     launched in a loop, lbvh.prepare) and the wrapper between CUDA
     events; the textured terrain on the LBVH at
     720x720, 6 spp (the build timed; 9 launches a pass) within the slice
     bound of phase 16's blocks render, its queries held and timed the
     same way; at 128x128 every LBVH query of the Cornell box (camera,
     bounce, shadow any hit), the materials box (the transparent walk's
     closest shadow hits), a moving baked instance (the linear arm), a box
     on two keyframes (the b-spline arm), the instanced spheres and curves
     (sphere leaves, some hits on them) and the terrain, bit for bit, and
     each image kernel path against plain path bit for bit; a hand-made
     tree 60 levels deep whose walk overflows the 48-slot stack as the JAX
     package's does; the walk's edge cases (`lbvh_edge_cases`: dead and
     NaN rays among live ones and whole dead warps, an exact tie of two
     leaves, one-primitive trees of a face and of a sphere, origins on box
     faces and direction components of +-0, a tree copied through numpy),
     closest, shadow closest and any hit, bit for bit. Brute force on the 203,522-face terrain (kernel a, no
     row cap) at 720x720, 6 spp, within the slice bound of phase 16's
     image, each query of a pass timed beside its bound, and at 128x128
     every query bit for bit against mt_closest_ref. Instanced spheres and
     curves (baked) at 512x512 on brute force and on blocks, kernel path
     against plain path bit for bit.
 32. multi-device rendering and observability (parallel/, on
     torch.distributed; the card host has one GPU): (a) on a one-rank NCCL
     mesh in this process, render_sharded of the Cornell box at 1920x1080,
     16 spp, 4 bounces (160 mt_closest launches), ms a pass beside phase
     4's render and the all_gather's ms a pass (CUDA events), the film bit
     for bit equal to the same passes through _pixel_shard_radiance and
     add_samples with no mesh, and at 256x256, 2 spp, kernel path against
     plain path bit for bit; (b) make_train_step on that mesh, phase 14's
     five steps, losses and parameters bit for bit equal to phase 14's;
     (c) two gloo ranks in two processes on cuda:0 (NCCL refuses two ranks
     on one GPU; importing the port there leaves CUDA uninitialized):
     render_wavefront_sharded of the Cornell box at 256x256 and of the
     textured terrain at 128x128 (blocks: kernel b, every tile_walk call
     held against tile_walk_ref), each rank's result bit for bit equal to
     the one-rank mesh's, and three train steps within rtol 1e-5 of the
     one-rank steps and equal across ranks; (d) the render farm:
     init_distributed and render_node_film (256x256, 2 spp,
     directlighting) in the same two processes, merged with
     load_all_in_folder, within 1e-5 of the in-process merge of the same
     two nodes, the nodes' images more than 1e-4 apart; (e)
     render(..., stats=RenderStats()) of the Cornell box at 1080p, 4 spp
     (its summary: 4 passes, 8,294,400 camera rays), then one pass traced
     (utils.profiling.trace) and device_op_summary: its count of
     mt_closest_kernel equal to mt_closest's launch count for that pass
     (10), its ms beside the CUDA-event time of the same launches.

 33. the block prepass kernel (tile_candidates_kernel in
     csrc/tiles_traverse.cu) against tile_candidates_ref, lists equal with
     torch.equal (cand, ent, count): the nine queries of one textured
     terrain pass at 720x720 (captured as they reach tile_candidates; 9
     kernel launches), each front to back and in cover order; the camera
     query with a dead tile in a live chunk and a dead chunk; the forest's
     camera query over its virtual blocks; 5,000 random boxes, more
     candidates a tile than the shared sort's 4,096. Each timed (kernel
     and plain version) beside its bounds: the pair tests at 67 TFLOP/s
     and at 33.5 T instructions/s, the lists at 3.35 TB/s.
 34. take's backward reduction (csrc/take_grad.cu through
     ops/fast_grad.take_grad): every take backward of one train step of
     the Cornell box at 1920x1080 (diffuse_color) and of the caustic scene
     at 512x512 (the IOR and the 1,366-row texel pool), captured as they
     reach take_grad, one kernel reduction each, held against float64
     sums (error over the row's sum |g| under 1e-5); the first texel-pool
     take and the first diffuse_color take also the same bits twice,
     onehot_grad's error beside the kernel's, and timed between CUDA
     events with the calls queued behind a sleeping kernel (device ms a
     call) beside their bound (each lane's index and gradient read once, the
     table written once, at 3.35 TB/s), onehot_grad's device ms and its
     one-hot bmms alone (the library yardstick), and their kernels a call
     as the C entry reports them, held to the layout's (two where it
     splits the lanes over blocks).

Each phase prints its seconds. Phases 11-14 first check that the fp32
matmul precision is "highest" (no TF32). Then one JSON line listing the
kernels, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero; the
script never falls back to the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
import types

DEVICE = "cuda"
WIDTH, HEIGHT, SPP, BOUNCES = 1920, 1080, 16, 4   # the Cornell path
SMALL = 256                                      # phase 5 image side
N_RANDOM, N_CORNELL = 65_537, 2_073_601
N_TABLE = 262_147                 # random rays per random table of phase 3
TABLE_FACES, MOTION_FACES = (300, 2047, 16384), 200
LAMP = 12.0   # radiance of the Cornell lamp (power 12, colour max 1)
TERRAIN_GRID = 320       # 2 * 319^2 = 203,522 triangles
TERRAIN_RES, TERRAIN_SPP, TERRAIN_BOUNCES = 720, 6, 2   # the slice
TERRAIN_SMALL = 128                              # phase 7 image side
BIG_GRID = 1100          # 2 * 1099^2 = 2,415,602 triangles
BIG_BLOCK, VMEM_BUDGET_MIB = 1024, 96   # its blocks; the TPU kernel's budget
N_TILE_RANDOM, N_BIG = 100_003, 32_771
SKY = (0.3, 0.4, 0.6)    # the terrain's constant background
FOREST_INST, FOREST_MOVING = 2000, 16             # the forest's rocks
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "instances_ref_160.hdr")
GOLDEN_RES, GOLDEN_SPP = 160, 16
CHUNK_ROWS = 270         # the headline's chunk: 270 x 1920 = 518,400 rays
GRAD_RTOL = 1e-5         # kernel-path against plain-path gradients
GLOSSY_RES = 512         # BASELINE config 2 (bench.py's glossy cell)
TRAIN_STEPS = 5
CORNELL_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "golden", "cornell_ref_256.hdr")
CORNELL_GOLDEN_RES, CORNELL_GOLDEN_SPP = 256, 96
TEXEL_RTOL = 1e-4        # texel gradients: accumulation order on the card
CAUSTIC_RES, CAUSTIC_BOUNCES = 512, 5     # BASELINE config 4 (bench.py)
CAUSTIC_SAMPLES = 4      # timed forward + backward samples
VOLUME_RES, VOLUME_SPP, VOLUME_BOUNCES = 512, 8, 3   # BASELINE config 5
PATHS_RES = 128          # phases 19-20: kernel path against plain path
# H100 SXM data-sheet peaks (fp32 counts a fused multiply-add as 2 flops)
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
FLOPS_PER_PAIR = 45      # one Möller-Trumbore ray-triangle test
# flops per pair with the keyframe blend (9 vertex rows, 3 or 5 flops each)
FLOPS_PER_PAIR_MOTION = {0: 45, 1: 72, 2: 90}
FLOPS_PER_TRANSFORM = 33  # an instance's ray transform, once per candidate


def _cmd(*args: str) -> str:
    return subprocess.run(list(args), capture_output=True, text=True,
                          check=True).stdout.strip()


_ARM = "kernel.tile_walk.launches."     # tile_walk's launches by arm


def _launches(kernel: str) -> int:
    """Launches of `kernel` in csrc_build's counter."""
    from libyafaray_tpu_torch.csrc_build import launch_counts
    return launch_counts[f"kernel.{kernel}.launches"]


def _zero_launches(*kernels: str) -> None:
    from libyafaray_tpu_torch.csrc_build import launch_counts
    for kernel in kernels:
        launch_counts[f"kernel.{kernel}.launches"] = 0


def _arm_launches() -> dict:
    """tile_walk's launches by arm ("static", "instanced+motion1", ...)."""
    from libyafaray_tpu_torch.csrc_build import launch_counts
    return {k[len(_ARM):]: n for k, n in launch_counts.items()
            if k.startswith(_ARM)}


def _clear_arm_launches() -> None:
    from libyafaray_tpu_torch.csrc_build import launch_counts
    for k in [k for k in launch_counts if k.startswith(_ARM)]:
        del launch_counts[k]


def _cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _once_ms(fn):
    """(fn(), its device ms): one call between CUDA events, no warm-up.
    The plain versions are timed on the call that their check needs
    anyway (each is a chain of eager ops, its first call no slower than
    the next by more than the spread between calls)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _bound_ms(flops: float, nbytes: float):
    """(least time in ms, what bounds it) for the work and the traffic."""
    ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


# ---------------------------------------------------------------- phase 3

def _random_table(rng, f, motion=0, device=None):
    """Packed table of f random triangles with mixed visibility bits (and
    motion keyframes), as in tests/test_pallas_intersect.py."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch.accel.mt_intersect import pack_tris
    vtx = rng.standard_normal((f * 3, 3)).astype(np.float32)
    vis = np.full(f, 3, np.int32)
    vis[::7] = 2    # invisible to camera rays
    vis[::11] = 1   # casts no shadow
    vis_t = torch.from_numpy(vis)
    tabs = [pack_tris(*(torch.from_numpy(vtx[k::3]) for k in range(3)), vis_t)]
    for _ in range(motion):
        vk = vtx + rng.standard_normal(vtx.shape).astype(np.float32) * 0.3
        tabs.append(pack_tris(*(torch.from_numpy(vk[k::3]) for k in range(3)),
                              vis_t))
    return [t.to(device or DEVICE) for t in tabs]


def _rays(rng, n, lo=None, hi=None, n_prims=36, dead_every=0, device=None):
    """Random rays (o, d, t_min, t_max, exclude) on the card; every 5th
    excludes a random prim, every dead_every-th has an empty t-range."""
    import numpy as np
    import torch
    if lo is None:
        o = rng.standard_normal((n, 3)).astype(np.float32) * 2
    else:
        o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = np.full(n, -1, np.int32)
    excl[::5] = rng.integers(0, n_prims, excl[::5].shape)
    t_max = np.full(n, 1e30, np.float32)
    if dead_every:
        t_max[::dead_every] = -1.0
    device = device or DEVICE
    dev = lambda a: torch.from_numpy(a).to(device)
    return (dev(o), dev(d), torch.full((n,), 1e-4, device=device),
            dev(t_max), dev(excl))


def _compare(name, got, want, max_err, phase="3", exact=False):
    """Kernel outputs against the plain version's: prim ids equal on every
    ray, t/u/v within rtol 1e-6 (equal bit for bit with `exact`). Returns
    the running max abs error."""
    import torch
    t, p, u, v = got
    rt, rp, ru, rv = want
    torch.cuda.synchronize()
    mism = int((p != rp).sum())
    if mism:
        raise AssertionError(f"{name}: prim ids differ on {mism} rays")
    for label, a, b in (("t", t, rt), ("u", u, ru), ("v", v, rv)):
        torch.testing.assert_close(a, b, rtol=0.0 if exact else 1e-6,
                                   atol=0.0, equal_nan=exact,
                                   msg=lambda m: f"{name} {label}: {m}")
        max_err = max(max_err, float((a - b).abs().max()))
    print(f"phase {phase}: {name}: {p.numel()} rays, {int((p >= 0).sum())} "
          f"hits, prim ids equal, max |diff| {max_err:.3g}")
    return max_err


def mt_edge_cases(rng, device, n):
    """The cases the kernel's design must get right, as [(name, table, (o,
    d, t_min, t_max, exclude), shadow, the prim ids wanted or None)]: a
    table without shadow casters (every shadow ray misses); 200 stacked
    planes whose camera and shadow bits interleave across the 128-row chunk
    boundary, hit from below past random t_min; an exact tie at t = 1
    between rows 0 and 2 with a camera-invisible copy of row 2 between
    them; and n rays against 300 random triangles where every third ray,
    every seventh from the second on (t_max = t_min), two whole warps and a
    whole block of 128 are dead."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch.accel.mt_intersect import pack_tris
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cases = []
    tab, = _random_table(rng, 200, device=device)
    tab[:, 10] = 0.0
    cases.append(("no shadow casters", tab,
                  _rays(rng, n, n_prims=200, device=device), True,
                  torch.full((n,), -1, dtype=torch.int32, device=device)))
    # planes z = 10 + 0.01 k behind, z = 0.05 + 0.01 (k - 100) in front
    k = np.arange(200)
    z = np.where(k < 100, 10.0 + 0.01 * k, 0.05 + 0.01 * (k - 100))
    corner = lambda x, y: np.stack([np.full(200, x), np.full(200, y), z], 1)
    tab = pack_tris(f32(corner(-2.0, -2.0)), f32(corner(6.0, -2.0)),
                    f32(corner(-2.0, 6.0)),
                    torch.tensor([3, 2, 1, 0], dtype=torch.int32)[k % 4]
                    ).to(device)
    o = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.zeros((n, 1))], 1)
    d = np.concatenate([rng.uniform(-0.05, 0.05, (n, 2)), np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    excl = np.full(n, -1, np.int32)
    excl[::5] = rng.integers(100, 200, excl[::5].shape)
    planes = (dev(o.astype(np.float32)), dev(d.astype(np.float32)),
              dev(rng.uniform(0.0, 0.6, n).astype(np.float32)),
              torch.full((n,), 1e30, device=device), dev(excl))
    for shadow in (False, True):
        cases.append((f"stacked planes across a chunk boundary "
                      f"shadow={shadow}", tab, planes, shadow, None))
    # rows 0 and 2 share the edge x = 0 of the plane z = 1; row 1 is row 2
    # again, cast as a shadow only
    tab = pack_tris(f32([[0, -1, 1], [0, -1, 1], [0, -1, 1]]),
                    f32([[0, 1, 1], [1, -1, 1], [1, -1, 1]]),
                    f32([[-1, -1, 1], [0, 1, 1], [0, 1, 1]]),
                    torch.tensor([3, 2, 3], dtype=torch.int32)).to(device)
    tie = (torch.zeros((4, 3), device=device),
           f32([[0, 0, 1]] * 4).to(device),
           torch.full((4,), 1e-4, device=device),
           torch.full((4,), 1e30, device=device),
           torch.tensor([-1, 0, 2, 1], dtype=torch.int32, device=device))
    for shadow, want in ((False, [0, 2, 0, 0]), (True, [0, 1, 0, 0])):
        cases.append((f"tie across an invisible row shadow={shadow}", tab,
                      tie, shadow, torch.tensor(want, dtype=torch.int32,
                                                device=device)))
    tab, = _random_table(rng, 300, device=device)
    o, d, t_min, t_max, excl = _rays(rng, 4099, n_prims=300, device=device)
    t_max[::3] = -1.0
    t_max[1::7] = t_min[1::7]
    t_max[1024:1088] = -1.0      # two whole warps
    t_max[2048:2176] = -1.0      # a whole block
    for shadow in (False, True):
        cases.append((f"dead rays shadow={shadow}", tab,
                      (o, d, t_min, t_max, excl), shadow, None))
    return cases


def assert_mt_case(name, got, rays, want_prim=None):
    """What every answer of a case must show: rays with an empty range
    (not t_max > t_min) miss with t = t_max and u = v = 0, and the prim ids
    are the wanted ones where the case names them."""
    import torch
    t, p, u, v = got
    _, _, t_min, t_max, _ = rays
    dead = ~(t_max > t_min)
    if bool((p[dead] != -1).any() | (t[dead] != t_max[dead]).any()
            | (u[dead] != 0).any() | (v[dead] != 0).any()):
        raise AssertionError(f"{name}: a ray with an empty range hit")
    if want_prim is not None and not torch.equal(p, want_prim):
        raise AssertionError(f"{name}: prim ids {p.tolist()[:8]}, want "
                             f"{want_prim.tolist()[:8]}")


def capture_mt(scene, cfg):
    """The mt_closest calls of one pass of `scene` at its camera's size
    (sample 0), in pass order, each as (arguments, keywords) with its
    tensors cloned."""
    import torch
    from libyafaray_tpu_torch import render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    kept, real = [], MT.mt_closest
    copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x

    def keep_call(*a, **k):
        kept.append((tuple(copy(x) for x in a),
                     {key: copy(x) for key, x in k.items()}))
        return real(*a, **k)

    MT.mt_closest = keep_call
    try:
        render(scene, cfg, spp=1)
    finally:
        MT.mt_closest = real
    return kept


def mt_bound(args, kw):
    """(live rays, rows kept, bound ms, what bounds it) of one mt_closest
    call: the live rays (t_max > t_min) times the rows whose selected
    visibility bit is set, at the arm's flops per pair, or every input read
    once and the four outputs written once."""
    tab, o, d, t_min, t_max, excl = args
    motion = (0 if kw.get("tris_t1") is None or kw.get("time") is None
              else 2 if kw.get("tris_t2") is not None else 1)
    live = int((t_max > t_min).sum())
    rows = int((tab[:, 10 if kw.get("shadow") else 9] > 0.5).sum())
    nbytes = _nbytes(*args, *(x for x in kw.values() if x is not None
                               and not isinstance(x, bool)))
    return (live, rows) + _bound_ms(
        live * rows * FLOPS_PER_PAIR_MOTION[motion],
        nbytes + 16 * o.shape[0])


def hd_scenes():
    """The Cornell box and the golden's baked cubes (brute force, 96 rows),
    compiled with their cameras at WIDTH x HEIGHT."""
    from libyafaray_tpu_torch.scenes import cornell_builder, instances_builder
    out = []
    for builder in (cornell_builder, instances_builder):
        b = builder()
        b.cameras["cam"]["resx"], b.cameras["cam"]["resy"] = WIDTH, HEIGHT
        out.append(b.compile("cam"))
    return out


def mt_queries(cornell_hd, cubes_hd):
    """[(label, arguments, keywords)]: the queries phase 3 times and
    tools/time_mt_closest.py times builds on: the ten of one Cornell pass
    and the ten of one pass of the golden's baked cubes, both at 1920x1080,
    random tables of TABLE_FACES triangles and both motion arms at
    MOTION_FACES triangles (N_TABLE random rays, closest hits)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import make_integrator
    out = []
    for scene_name, scene, cfg in (
            ("cornell", cornell_hd, {"type": "pathtracing",
                                     "bounces": BOUNCES}),
            ("cubes", cubes_hd, {"type": "directlighting"})):
        for i, (a, k) in enumerate(capture_mt(scene, make_integrator(cfg))):
            kind = "shadow" if k.get("shadow") else "closest"
            out.append((f"{scene_name} {i} ({kind})", a, k))
    rng = np.random.default_rng(17)
    for f in TABLE_FACES:
        tab, = _random_table(rng, f)
        out.append((f"random {f} tris ({tab.shape[0]} rows)",
                    (tab, *_rays(rng, N_TABLE, n_prims=f)), {}))
    for motion in (1, 2):
        tabs = _random_table(rng, MOTION_FACES, motion)
        tt = torch.from_numpy(rng.random(N_TABLE).astype(np.float32)
                              ).to(DEVICE)
        out.append((f"motion{motion} {MOTION_FACES} tris "
                    f"({tabs[0].shape[0]} rows)",
                    (tabs[0], *_rays(rng, N_TABLE, n_prims=MOTION_FACES)),
                    dict(time=tt, tris_t1=tabs[1],
                         tris_t2=tabs[2] if motion == 2 else None)))
    return out


def phase3_mt(cornell, cornell_hd, cubes_hd):
    """mt_closest against mt_closest_ref; returns (max_err, times, bound)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.cameras import shoot_rays
    rng = np.random.default_rng(7)
    max_err = 0.0
    check = lambda name, a, k: _compare(
        name, MT.mt_closest(*a, **k), MT.mt_closest_ref(*a, **k), max_err,
        exact=True)
    for name, tab, rays, shadow, want in mt_edge_cases(rng, DEVICE,
                                                       N_RANDOM):
        got = MT.mt_closest(tab, *rays, shadow=shadow)
        max_err = _compare(name, got, MT.mt_closest_ref(tab, *rays,
                                                        shadow=shadow),
                           max_err, exact=True)
        assert_mt_case(name, got, rays, want)
    tab_c = cornell.geom.tri_table
    for shadow in (False, True):
        max_err = check(f"cornell table, random rays shadow={shadow}",
                        (tab_c, *_rays(rng, N_CORNELL, 0.02, 0.98)),
                        dict(shadow=shadow))
    # exact tie: two triangles sharing the edge x=0 in the plane z=1
    v0 = torch.tensor([[0.0, -1.0, 1.0], [0.0, -1.0, 1.0]])
    v1 = torch.tensor([[0.0, 1.0, 1.0], [1.0, -1.0, 1.0]])
    v2 = torch.tensor([[-1.0, -1.0, 1.0], [0.0, 1.0, 1.0]])
    tab_tie = MT.pack_tris(v0, v1, v2, torch.tensor([3, 3])).to(DEVICE)
    tie = (torch.zeros((1, 3), device=DEVICE),
           torch.tensor([[0.0, 0.0, 1.0]], device=DEVICE),
           torch.tensor([1e-4], device=DEVICE),
           torch.tensor([1e30], device=DEVICE),
           torch.tensor([-1], dtype=torch.int32, device=DEVICE))
    got = MT.mt_closest(tab_tie, *tie)
    max_err = _compare("tie", got, MT.mt_closest_ref(tab_tie, *tie), max_err,
                       exact=True)
    if int(got[1][0]) != 0 or abs(float(got[2][0]) - 0.5) > 1e-6:
        raise AssertionError(f"tie: want prim 0 with u 0.5, got {got}")
    # the queries of a Cornell pass and of the cubes', the random tables
    # and the motion arms: held bit for bit (shadow too on the synthetic
    # ones), each timed beside its bound
    for label, a, k in mt_queries(cornell_hd, cubes_hd):
        max_err = check(label, a, k)
        if not label.startswith(("cornell", "cubes")):
            max_err = check(f"{label} shadow", a, dict(k, shadow=True))
        ms = _cuda_ms(lambda: MT.mt_closest(*a, **k), 10)
        live, rows, bound, by = mt_bound(a, k)
        print(f"phase 3: {label}: {a[1].shape[0]} rays, {live} live, "
              f"{rows} rows kept: mt_closest {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({by}), at {100 * bound / ms:.1f}% of it")

    # kernel and plain times at the main path's shape: 1080p camera rays
    # against the Cornell table
    n = WIDTH * HEIGHT
    pid = torch.arange(n, device=DEVICE)
    px = (pid % WIDTH).float() + 0.5
    py = (pid // WIDTH).float() + 0.5
    o, d, _ = shoot_rays(cornell.camera, px, py)
    q = (o.contiguous(), d.contiguous(), torch.full((n,), 5e-5, device=DEVICE),
         torch.full((n,), 1e30, device=DEVICE),
         torch.full((n,), -1, dtype=torch.int32, device=DEVICE))
    times = {}
    for shadow in (False, True):
        times[shadow] = (
            _cuda_ms(lambda: MT.mt_closest(tab_c, *q, shadow=shadow), 20),
            _cuda_ms(lambda: MT.mt_closest_ref(tab_c, *q, shadow=shadow), 3))
        print(f"phase 3: time at N={n}, {tab_c.shape[0]}-row table, "
              f"shadow={shadow}: mt_closest {times[shadow][0]:.4f} ms, "
              f"mt_closest_ref {times[shadow][1]:.4f} ms")
    live, rows, *bound = mt_bound((tab_c, *q), {})
    print(f"phase 3: mt_closest bound at N={n}, {live} live x {rows} rows: "
          f"{bound[0]:.4f} ms ({bound[1]})")
    return max_err, times, bound


# --------------------------------------------------------------- phase 3b

def _sorted_query(acc, o, d, t_min, t_max, excl, time=None, cover=False):
    """The rays (and their shutter times) in the block accelerator's
    coherence order, prepared for the tile walk (the candidate lists in
    cover order with `cover`): (n, rays, cand, ent, count)."""
    import torch
    from libyafaray_tpu_torch.accel import blocks as BL
    from libyafaray_tpu_torch.accel import tiles as TL
    perm = torch.sort(BL.sort_key(acc, o, d, t_min, t_max),
                      stable=True).indices
    o, d, t_min, t_max, excl = (x[perm].contiguous()
                                for x in (o, d, t_min, t_max, excl))
    time = None if time is None else time[perm].contiguous()
    return (o.shape[0],) + TL.prepare(acc.bmin, acc.bmax, o, d, t_min, t_max,
                                      excl, time, cover)


def _walk_case(name, query, tab, kw, max_err, phase="3b"):
    """tile_walk against tile_walk_ref on one prepared query (n, rays, cand,
    ent, count) over `tab`, with tile_walk's keywords `kw` (shadow, any_hit
    and the keyframe and instancing tables of an arm): prim ids, t, u, v
    on closest hits, hit/miss on any hits. Returns (kernel outputs,
    max_err)."""
    import torch
    from libyafaray_tpu_torch.accel import tiles as TL
    n, *prep = query
    got = TL.tile_walk(*prep, tab, **kw)
    want = TL.tile_walk_ref(*prep, tab, **kw)
    torch.cuda.synchronize()
    any_hit = bool(kw.get("any_hit"))
    label = f"{name} shadow={bool(kw.get('shadow'))} any_hit={any_hit}"
    if any_hit:
        mism = int(((got[1][:n] >= 0) != (want[1][:n] >= 0)).sum())
        if mism:
            raise AssertionError(f"phase {phase}: {label}: hit/miss differs "
                                 f"on {mism} rays")
        print(f"phase {phase}: {label}: {n} rays, "
              f"{int((got[1][:n] >= 0).sum())} hits, hit/miss equal")
    else:
        max_err = _compare(label, (got[0][:n], got[1][:n], got[2][:n],
                                   got[3][:n]),
                           tuple(x[:n] for x in want), max_err, phase=phase)
    return got, max_err


def _needed(cand, ent, count, got, any_hit):
    """The candidate steps this query's data needs, bool[T, Cpad]: every
    tile tests its candidates whose entry bound is within reach of its final
    hits (closest: the largest best t; any hit: the largest t_max of rays
    left unhit)."""
    import torch
    from libyafaray_tpu_torch.accel import tiles as TL
    t = count.shape[0]
    best_t = got[0].view(t, TL.RAY_TILE)
    if any_hit:
        best_t = torch.where(got[1].view(t, TL.RAY_TILE) < 0, best_t,
                             -torch.inf)
    reach = best_t.amax(dim=1, keepdim=True)
    cols = torch.arange(ent.shape[1], device=ent.device)
    return (cols < count[:, None]) & (ent <= reach)


def _walk_bound(prep, got, kw, steps=None):
    """(pair tests needed, bound ms, what bounds it) of one tile_walk call
    (prep: rays, cand, ent, count, tab; kw: its keywords; got: its
    outputs): the needed pair tests at the arm's flops per pair, plus one
    ray transform per needed candidate step of an instance block; every
    input read once and the four outputs written once. A cover-order walk
    needs each live ray tested at the candidate steps up to its first hit:
    `steps` per ray, from tile_walk_ref."""
    import torch
    from libyafaray_tpu_torch.accel import tiles as TL
    rays, cand, ent, count, tab = prep
    motion = (0 if kw.get("tab_t1") is None
              else 2 if kw.get("tab_t2") is not None else 1)
    if steps is None:
        need = (_needed(cand, ent, count, got, bool(kw.get("any_hit")))
                * TL.RAY_TILE)
    else:
        # need[t, c]: the rays of tile t still looked for at its step c
        hist = torch.zeros(count.shape[0], cand.shape[1] + 1,
                           dtype=torch.int64, device=cand.device)
        hist.scatter_add_(1, steps.view(count.shape[0], TL.RAY_TILE),
                          torch.ones_like(hist[:, :1]).expand(
                              -1, TL.RAY_TILE))
        need = hist.flip(1).cumsum(1).flip(1)[:, 1:]
    pairs = int(need.sum()) * tab.shape[2]
    flops = pairs * FLOPS_PER_PAIR_MOTION[motion]
    if kw.get("blk_minv") is not None:
        inst = kw["blk_minv"][cand.long()] > 0
        flops += int((need * inst).sum()) * FLOPS_PER_TRANSFORM
    tabs = [x for x in kw.values() if isinstance(x, torch.Tensor)]
    nbytes = _nbytes(*prep, *tabs) + 4 * rays.shape[0] * 4
    return (pairs,) + _bound_ms(flops, nbytes)


def _mesh(verts, faces, vis, *keyframes):
    """The fields of a Geometry that build_blocks reads, on the card (with
    motion keyframes when given)."""
    import torch
    dev = lambda a: None if a is None else torch.from_numpy(a).to(DEVICE)
    keyframes = keyframes + (None, None)
    return types.SimpleNamespace(
        vertices=dev(verts), faces=dev(faces), face_vis=dev(vis),
        num_faces=len(faces), inst_mat=None,
        has_motion=keyframes[0] is not None,
        vertices_t1=dev(keyframes[0]), vertices_t2=dev(keyframes[1]))


def phase3b_tiles(terrain):
    """tile_walk against tile_walk_ref; returns (max_err, times, bound)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch.accel import blocks as BL
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.cameras import shoot_rays
    from libyafaray_tpu_torch.scenes import bigmesh_grid
    rng = np.random.default_rng(11)
    acc = terrain.blocks
    print(f"phase 3b: terrain table {acc.num_blocks} blocks x "
          f"{acc.block_size} triangles, {_nbytes(acc.tab) / 2**20:.2f} MiB")
    max_err = 0.0
    # (i) camera rays (every pixel centre but the last) and random rays
    res = TERRAIN_RES
    n = res * res - 1
    pid = torch.arange(n, device=DEVICE)
    o, d, _ = shoot_rays(terrain.camera, (pid % res).float() + 0.5,
                         (pid // res).float() + 0.5)
    t_max = torch.full((n,), 1e30, device=DEVICE)
    t_max[::7] = -1.0
    excl = torch.full((n,), -1, dtype=torch.int32, device=DEVICE)
    excl[::5] = torch.randint(0, terrain.geom.num_faces, excl[::5].shape,
                              device=DEVICE, dtype=torch.int32)
    cam = _sorted_query(acc, o.contiguous(), d.contiguous(),
                        torch.full((n,), 5e-5, device=DEVICE), t_max, excl)
    closest, shadow, any_hit = (dict(shadow=False), dict(shadow=True),
                                dict(shadow=True, any_hit=True))
    cam_hit, max_err = _walk_case("terrain camera", cam, acc.tab, closest,
                                  max_err)
    _, max_err = _walk_case("terrain camera", cam, acc.tab, shadow, max_err)
    rnd = _sorted_query(acc, *_rays(rng, N_TILE_RANDOM, [0, 0, -0.5],
                                    [4, 4, 1.5], terrain.geom.num_faces, 7))
    for kw in (closest, shadow):
        _, max_err = _walk_case("terrain random", rnd, acc.tab, kw, max_err)
    # (ii) any hit: the first shadow wavefront (camera hits toward the sun)
    # and the random rays
    _, rays_c, _, _, _ = cam
    hit = cam_hit[1][:n] >= 0
    p = rays_c[:n, 0:3] + rays_c[:n, 3:6] * cam_hit[0][:n, None]
    to_sun = -terrain.lights.direction[0].to(DEVICE).expand(n, 3)
    shadow_q = _sorted_query(
        acc, (p + to_sun * 5e-4).contiguous(), to_sun.contiguous(),
        torch.zeros((n,), device=DEVICE),
        torch.where(hit, 1e30, -1.0).contiguous(),
        torch.where(hit, cam_hit[1][:n].to(torch.int32), -1).contiguous())
    sh_hit, max_err = _walk_case("terrain sun shadow", shadow_q, acc.tab,
                                 any_hit, max_err)
    _, max_err = _walk_case("terrain random", rnd, acc.tab, any_hit, max_err)
    # (iii) 2.4M triangles: blocks of 1024, a table above 96 MiB
    verts, faces, _, _ = bigmesh_grid(BIG_GRID)
    vis = np.full(len(faces), 3, np.int32)
    vis[::7] = 2
    vis[::11] = 1
    big = BL.build_blocks(_mesh(verts, faces, vis))
    mib = _nbytes(big.tab) / 2**20
    print(f"phase 3b: big terrain {len(faces)} triangles, {big.num_blocks} "
          f"blocks x {big.block_size}, {mib:.1f} MiB")
    if big.block_size != BIG_BLOCK or mib <= VMEM_BUDGET_MIB:
        raise AssertionError(f"the big table must have blocks of {BIG_BLOCK} "
                             f"and exceed {VMEM_BUDGET_MIB} MiB")
    o, d, t_min, t_max, excl = _rays(rng, N_BIG, [0, 0, 0.3], [4, 4, 1.5],
                                     len(faces), 7)
    d[: N_BIG // 2, 2] = -d[: N_BIG // 2, 2].abs()    # half look down
    big_q = _sorted_query(big, o, d, t_min, t_max, excl)
    for kw in (shadow, closest):
        big_hit, max_err = _walk_case("big terrain", big_q, big.tab, kw,
                                      max_err)
    _, max_err = _walk_case("big terrain", big_q, big.tab, any_hit, max_err)
    # the kernel's time in this regime (TPU kernel c's): closest hits
    _, *prep = big_q
    big_ms = (_cuda_ms(lambda: TL.tile_walk(*prep, big.tab), 10),
              _once_ms(lambda: TL.tile_walk_ref(*prep, big.tab))[1])
    pairs, *big_bound = _walk_bound((*prep, big.tab), big_hit, closest)
    print(f"phase 3b: time per query, big terrain ({N_BIG} random rays, "
          f"closest): tile_walk {big_ms[0]:.4f} ms, tile_walk_ref "
          f"{big_ms[1]:.4f} ms; {pairs} pair tests needed: bound "
          f"{big_bound[0]:.4f} ms ({big_bound[1]}), the kernel at "
          f"{100 * big_bound[0] / big_ms[0]:.1f}% of it")
    del big, big_q, prep, big_hit
    # (iv) an exact tie inside one sub-chunk, prim ids not in lane order
    tab = torch.zeros((1, 16, TL.SUB), device=DEVICE)
    tab[0, 11] = -2.0
    for lane, (tri, pid_) in enumerate((([0, -1, 1, 1, -1, 1, 0, 1, 1], 5.0),
                                        ([0, -1, 1, 0, 1, 1, -1, -1, 1],
                                         3.0))):
        tab[0, 0:9, lane] = torch.tensor(tri, dtype=torch.float32)
        tab[0, 9:12, lane] = torch.tensor([1.0, 1.0, pid_])
    tie_acc = types.SimpleNamespace(
        tab=tab, bmin=torch.tensor([[-1.0, -1.0, 1.0]], device=DEVICE),
        bmax=torch.tensor([[1.0, 1.0, 1.0]], device=DEVICE))
    tie_q = (1,) + TL.prepare(
        tie_acc.bmin, tie_acc.bmax, torch.zeros((1, 3), device=DEVICE),
        torch.tensor([[0.0, 0.0, 1.0]], device=DEVICE),
        torch.tensor([1e-4], device=DEVICE), torch.tensor([1e30], device=DEVICE),
        torch.tensor([-1], dtype=torch.int32, device=DEVICE))
    got, max_err = _walk_case("tie", tie_q, tie_acc.tab, closest, max_err)
    if int(got[1][0]) != 3 or abs(float(got[2][0]) - 0.5) > 1e-6:
        raise AssertionError(f"tie: want prim 3 with u 0.5, got {got}")

    # kernel and plain times per query at the slice's shape
    times, bounds = {}, {}
    for label, q, hits, kw in (("camera", cam, cam_hit, closest),
                               ("sun shadow", shadow_q, sh_hit, any_hit)):
        _, *prep = q
        times[label] = (
            _cuda_ms(lambda: TL.tile_walk(*prep, acc.tab, **kw), 10),
            _once_ms(lambda: TL.tile_walk_ref(*prep, acc.tab, **kw))[1])
        pairs, *bounds[label] = _walk_bound((*prep, acc.tab), hits, kw)
        print(f"phase 3b: time per query, {label} wavefront ({q[0]} rays): "
              f"tile_walk {times[label][0]:.4f} ms, tile_walk_ref "
              f"{times[label][1]:.4f} ms; {pairs} pair tests needed: bound "
              f"{bounds[label][0]:.4f} ms ({bounds[label][1]}), the kernel "
              f"at {100 * bounds[label][0] / times[label][0]:.1f}% of it")
    return max_err, times, bounds["camera"], dict(
        ms=big_ms[0], plain_ms=big_ms[1], bound_ms=big_bound[0],
        bound_by=big_bound[1])


# --------------------------------------------------------------- phase 3c

# the arms of phase 3c: (name, motion keyframes, instanced)
ARMS = (("instanced", 0, True), ("motion1", 1, False), ("motion2", 2, False),
        ("instanced+motion1", 1, True))


def _arm_tables(acc, motion, instanced):
    """tile_walk's keyword arguments for one arm of the kernel."""
    kw = {}
    if motion:
        kw["tab_t1"] = acc.tab_t1
    if motion == 2:
        kw["tab_t2"] = acc.tab_t2
    if instanced:
        kw.update(blk_base=acc.blk_base, blk_minv=acc.blk_minv,
                  id_delta=acc.id_delta, inv_rows=acc.inv_rows)
    return kw


@contextlib.contextmanager
def _kept_calls(module, name, keep):
    """Inside the context the calls of module.name at positions `keep`
    (in call order) are recorded as (arguments, keywords, outputs), their
    tensors cloned; the yielded list fills as the work runs."""
    import torch
    real, position, kept = getattr(module, name), itertools.count(), []
    copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x

    def keep_call(*a, **k):
        i = next(position)
        out = real(*a, **k)
        if i in keep:
            kept.append((tuple(copy(x) for x in a),
                         {key: copy(x) for key, x in k.items()},
                         tuple(x.clone() for x in out)))
        return out

    setattr(module, name, keep_call)
    try:
        yield kept
    finally:
        setattr(module, name, real)


def _capture_walks(scene, keep):
    """The tile_walk calls at the positions `keep` (in pass order) of one
    pass of `scene` at its camera's size (sample 0, TERRAIN_BOUNCES), each
    as ((rays, cand, ent, count, tab), keywords)."""
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import tiles as TL
    with _kept_calls(TL, "tile_walk", set(keep)) as kept:
        render(scene, make_integrator({"type": "pathtracing",
                                       "bounces": TERRAIN_BOUNCES}), spp=1)
    return [(a, k) for a, k, _ in kept]


def phase3c_arms(forest, static_cam_ms):
    """The motion and instancing arms of tile_walk against tile_walk_ref,
    and two incoherent wavefronts of a forest pass; returns (max_err, {arm:
    dict(ms, plain_ms, bound_ms, bound_by)})."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch.accel import blocks as BL
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.cameras import shoot_rays
    from libyafaray_tpu_torch.scenes import bigmesh_grid
    rng = np.random.default_rng(13)
    # the terrain with two synthetic keyframes: every vertex moves by up to
    # 0.02 per axis and keyframe
    verts, faces, _, _ = bigmesh_grid(TERRAIN_GRID)
    vis = np.full(len(faces), 3, np.int32)
    vis[::7] = 2
    vis[::11] = 1
    keys = [verts + rng.uniform(-0.02, 0.02, verts.shape).astype(np.float32)
            for _ in range(2)]
    moving = BL.build_blocks(_mesh(verts, faces, vis, *keys))
    print(f"phase 3c: terrain with keyframes: {moving.num_blocks} blocks x "
          f"{moving.block_size}, {_nbytes(moving.tab) / 2**20:.2f} MiB per "
          f"keyframe; forest: {forest.blocks.num_blocks} virtual blocks over "
          f"{forest.blocks.tab.shape[0]} physical")
    res = TERRAIN_RES
    n = res * res - 1
    pid = torch.arange(n, device=DEVICE)
    o, d, _ = shoot_rays(forest.camera, (pid % res).float() + 0.5,
                         (pid // res).float() + 0.5)
    o, d = o.contiguous(), d.contiguous()
    t_max = torch.full((n,), 1e30, device=DEVICE)
    t_max[::7] = -1.0
    excl = torch.full((n,), -1, dtype=torch.int32, device=DEVICE)
    excl[::5] = torch.randint(0, forest.geom.num_faces, excl[::5].shape,
                              device=DEVICE, dtype=torch.int32)
    t_min = torch.full((n,), 5e-5, device=DEVICE)
    time_cam = torch.rand((n,), device=DEVICE)
    max_err, out = 0.0, {}
    for arm, motion, instanced in ARMS:
        acc = forest.blocks if instanced else moving
        tabs = _arm_tables(acc, motion, instanced)
        tt = time_cam if motion else None
        cam = _sorted_query(acc, o, d, t_min, t_max, excl, tt)
        cam_hit, max_err = _walk_case(f"{arm} camera", cam, acc.tab, tabs,
                                      max_err, "3c")
        for kw in (dict(shadow=True), dict(shadow=True, any_hit=True)):
            _, max_err = _walk_case(f"{arm} camera", cam, acc.tab,
                                    dict(tabs, **kw), max_err, "3c")
        ro, rd, rt0, rt1, rex = _rays(rng, N_TILE_RANDOM, [0, 0, -0.5],
                                      [4, 4, 1.5], forest.geom.num_faces, 7)
        rt = (torch.rand((N_TILE_RANDOM,), device=DEVICE) if motion
              else None)
        rnd = _sorted_query(acc, ro, rd, rt0, rt1, rex, rt)
        _, max_err = _walk_case(f"{arm} random", rnd, acc.tab, tabs,
                                max_err, "3c")
        _, *prep = cam
        ms = _cuda_ms(lambda: TL.tile_walk(*prep, acc.tab, **tabs), 10)
        plain_ms = _once_ms(lambda: TL.tile_walk_ref(*prep, acc.tab,
                                                    **tabs))[1]
        _, *bound = _walk_bound((*prep, acc.tab), cam_hit, tabs)
        same = ""
        if not instanced:      # the static arm on the same table and rays
            same = (f"; the static arm on the same rays and table "
                    f"{_cuda_ms(lambda: TL.tile_walk(*prep, acc.tab), 10):.4f}"
                    " ms")
        print(f"phase 3c: {arm}: time per camera query ({n} rays): "
              f"tile_walk {ms:.4f} ms, tile_walk_ref {plain_ms:.4f} ms, "
              f"bound {bound[0]:.4f} ms ({bound[1]}){same}; the static arm "
              f"on the same rays over the terrain {static_cam_ms:.4f} ms")
        out[arm] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                        bound_by=bound[1])
    # the incoherent wavefronts of a forest pass, where the kernel spends
    # most of its time: the background light's shadow rays at depth 0 (any
    # hit) and the first bounce's closest hits
    for label, (prep, kw) in zip(("background shadow", "bounce"),
                                 _capture_walks(forest, (2, 3))):
        if bool(kw.get("any_hit")) != (label == "background shadow"):
            raise AssertionError(f"the pass's queries are not in the order "
                                 f"closest hit, sun, background: {label}")
        query = (prep[0].shape[0], *prep[:4])
        got, max_err = _walk_case(f"forest {label}", query, prep[4], kw,
                                  max_err, "3c")
        ms = _cuda_ms(lambda: TL.tile_walk(*prep, **kw), 10)
        pairs, *bound = _walk_bound(prep, got, kw)
        print(f"phase 3c: forest {label} wavefront ({query[0]} rays, "
              f"{int((prep[3] > 0).sum())} tiles with candidates): tile_walk "
              f"{ms:.4f} ms; {pairs} pair tests needed: bound "
              f"{bound[0]:.4f} ms ({bound[1]}), the kernel at "
              f"{100 * bound[0] / ms:.1f}% of it")
    return max_err, out


# ---------------------------------------------------------- phases 4 and 5

def phase4_cornell():
    """The Cornell path: returns (the mt_closest launches of its render, its
    ms a pass)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.scenes import cornell_builder
    width, height, spp, bounces = WIDTH, HEIGHT, SPP, BOUNCES
    n = width * height
    b = cornell_builder()
    b.cameras["cam"]["resx"] = width
    b.cameras["cam"]["resy"] = height
    scene = b.compile("cam").to(DEVICE)
    cfg = make_integrator({"type": "pathtracing", "bounces": bounces})
    render(scene, cfg, spp=1, device=DEVICE)        # warm-up pass
    torch.cuda.synchronize()
    _zero_launches("mt_closest", "tile_walk")
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=spp, device=DEVICE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, tile_launches = _launches("mt_closest"), _launches("tile_walk")
    want = spp * (bounces + 1) * 2
    if launches < want or tile_launches:
        raise AssertionError(f"mt_closest launched {launches} times, want at "
                             f"least {want} (closest + shadow per bounce); "
                             f"tile kernel {tile_launches}, want 0")
    img = F.resolve(film)[..., :3].cpu().numpy()
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"bad image: shape {img.shape}, finite "
                             f"{np.isfinite(img).all()}")
    band = width * 12 // 64
    left = img[:, :band].reshape(-1, 3).mean(0)
    right = img[:, -band:].reshape(-1, 3).mean(0)
    if not (left[0] > left[1] and left[0] > left[2]):
        raise AssertionError(f"left wall not red-dominant: {left}")
    if not (right[1] > right[0] and right[1] > right[2]):
        raise AssertionError(f"right wall not green-dominant: {right}")
    # at 16:9 the ceiling lamp lies above the vertical field of view: no
    # pixel may exceed its radiance (12); phase 5's square image sees it
    if not 0.0 < float(img.max()) <= LAMP + 1e-3:
        raise AssertionError(f"max {img.max()} outside (0, {LAMP}]")
    ms_pass = seconds * 1e3 / spp
    # the kernel's share of one pass, from CUDA events around its launches
    real = MT.mt_closest
    events = []

    def timed(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*a, **k)
        ev[1].record()
        events.append(ev)
        return out

    pass_ev = (torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
    MT.mt_closest = timed
    try:
        pass_ev[0].record()
        render(scene, cfg, spp=1, device=DEVICE, start_sample=spp)
        pass_ev[1].record()
        torch.cuda.synchronize()
    finally:
        MT.mt_closest = real
    kernel_ms = sum(a.elapsed_time(z) for a, z in events)
    pass_ms = pass_ev[0].elapsed_time(pass_ev[1])
    print(f"phase 4: cornell {width}x{height} {spp} spp {bounces} bounces: "
          f"{ms_pass:.2f} ms/pass, {n * spp / seconds:.4g} camera rays/s, "
          f"{launches} kernel launches; instrumented pass {pass_ms:.2f} ms, "
          f"kernel {kernel_ms:.2f} ms ({100 * kernel_ms / pass_ms:.1f}%); "
          f"walls left {left.round(4).tolist()} right "
          f"{right.round(4).tolist()}, max {float(img.max())}, mean "
          f"{float(img.mean()):.6f}")
    return launches, ms_pass


def _paths_agree(phase, img_k, img_p):
    import numpy as np
    close = np.isclose(img_k, img_p, rtol=1e-4, atol=1e-4).all(-1).mean()
    rel_mean = abs(img_k.mean() - img_p.mean()) / abs(img_p.mean())
    print(f"phase {phase}: {img_k.shape[1]}x{img_k.shape[0]}: "
          f"{100 * close:.3f}% of pixels within 1e-4, mean rel diff "
          f"{rel_mean:.3g}, max |diff| {np.abs(img_k - img_p).max():.3g}")
    if close < 0.98 or rel_mean > 1e-3:
        raise AssertionError(f"phase {phase}: kernel path and plain path "
                             "renders disagree")


@contextlib.contextmanager
def _plain(module, name, ref):
    """Inside the context module.name is its plain version `ref`: the swap
    of phases 5, 7, 9, 12 and 13. The kernel must not launch meanwhile."""
    real, before = getattr(module, name), _launches(name)
    setattr(module, name, ref)
    try:
        yield
    finally:
        setattr(module, name, real)
    if _launches(name) != before:
        raise AssertionError("the plain path launched the kernel")


def phase5_cornell_paths():
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.scenes import cornell_builder
    b = cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = SMALL
    small = b.compile("cam")
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    img_k = F.resolve(render(small, cfg, spp=2, device=DEVICE)).cpu().numpy()
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        img_p = F.resolve(render(small, cfg, spp=2, device=DEVICE)).cpu().numpy()
    _paths_agree("5", img_k, img_p)
    if abs(float(img_k[..., :3].max()) - LAMP) > 1e-3:
        raise AssertionError(f"max {img_k[..., :3].max()} of the square "
                             f"render is not the lamp's radiance {LAMP}")


# ---------------------------------------------------- phases 6 to 9

def _slice_render(phase, scene, spp, bounces):
    """Render `scene` at its camera's size through `render` with no device
    argument: one warm-up pass, then `spp` passes with the kernel counts
    set to 0 just before and read just after, then one more pass split by
    CUDA events into the tile kernel, tile_candidates, the rest of the
    queries (ray sort / unsort and packing) and the rest of the pass, with
    each kernel launch's time beside the pair tests its query needs and its
    bound. Returns (image, launches, launches per arm)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import blocks as BL
    from libyafaray_tpu_torch.accel import tiles as TL
    res = scene.camera.resx
    cfg = make_integrator({"type": "pathtracing", "bounces": bounces})
    render(scene, cfg, spp=1)                       # warm-up pass
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches("mt_closest", "tile_walk")
    _clear_arm_launches()
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=spp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, arms = _launches("tile_walk"), _arm_launches()
    mt_launches = _launches("mt_closest")
    peak = torch.cuda.max_memory_allocated()
    img = F.resolve(film).cpu().numpy()
    if img.shape != (scene.camera.resy, res, 4) or not np.isfinite(img).all():
        raise AssertionError(f"bad image: shape {img.shape}, finite "
                             f"{np.isfinite(img).all()}")
    ms_pass = seconds * 1e3 / spp

    spans = {"walk": [], "cand": [], "query": []}
    real = {"walk": TL.tile_walk, "cand": TL.tile_candidates,
            "query": BL.query}
    walks = []     # each kernel launch's (arguments, keywords, outputs)

    def timed(key):
        def fn(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = real[key](*a, **k)
            ev[1].record()
            spans[key].append(ev)
            if key == "walk":
                walks.append((a, k, out))
            return out
        return fn

    pass_ev = (torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
    TL.tile_walk, TL.tile_candidates, BL.query = (
        timed("walk"), timed("cand"), timed("query"))
    try:
        pass_ev[0].record()
        render(scene, cfg, spp=1, start_sample=spp)
        pass_ev[1].record()
        torch.cuda.synchronize()
    finally:
        TL.tile_walk, TL.tile_candidates, BL.query = (
            real["walk"], real["cand"], real["query"])
    ms = {k: sum(a.elapsed_time(z) for a, z in v) for k, v in spans.items()}
    pass_ms = pass_ev[0].elapsed_time(pass_ev[1])
    sort_ms = ms["query"] - ms["walk"] - ms["cand"]
    rest_ms = pass_ms - ms["query"]
    share = lambda x: f"{x:.2f} ms ({100 * x / pass_ms:.1f}%)"
    print(f"phase {phase}: {res}x{scene.camera.resy} {spp} spp {bounces} "
          f"bounces, {scene.geom.num_faces} triangles: {ms_pass:.2f} ms/pass, "
          f"{res * scene.camera.resy * spp / seconds:.4g} camera rays/s, "
          f"{launches} kernel launches {arms}, peak device memory "
          f"{peak / 2**30:.3f} GiB; alpha mean {float(img[..., 3].mean()):.4f}"
          f", image mean {float(img.mean()):.6f}")
    print(f"phase {phase}: one pass {pass_ms:.2f} ms, {len(spans['walk'])} "
          f"queries: kernel {share(ms['walk'])}, tile_candidates "
          f"{share(ms['cand'])}, ray sort/unsort and packing "
          f"{share(sort_ms)}, the rest (camera, sampling, shading, film) "
          f"{share(rest_ms)}")
    per_query = lambda key: ", ".join(f"{a.elapsed_time(z):.2f}"
                                      for a, z in spans[key])
    print(f"phase {phase}: per query in pass order (closest hit, then the "
          f"sun's and the background light's shadow rays, at each depth), "
          f"ms: kernel [{per_query('walk')}]; tile_candidates "
          f"[{per_query('cand')}]")
    for i, ((a, k, out), (e0, e1)) in enumerate(zip(walks, spans["walk"])):
        ms_i = e0.elapsed_time(e1)
        pairs, bound_ms, bound_by = _walk_bound(a, out, k)
        print(f"phase {phase}: query {i} (depth {i // 3}, "
              f"{'any' if k.get('any_hit') else 'closest'} hit): {pairs} pair "
              f"tests needed, bound {bound_ms:.4f} ms ({bound_by}), kernel "
              f"{ms_i:.4f} ms, at {100 * bound_ms / ms_i:.1f}% of the bound")
    del walks
    # per pass: camera + 2 bounces closest hits, sun + bg shadows at 3 depths
    want = spp * (bounces + 1) * 3
    if launches < want or mt_launches:
        raise AssertionError(f"tile kernel launched {launches} times, want at "
                             f"least {want}; mt_closest {mt_launches}, "
                             "want 0")
    return img, launches, arms


def phase6_terrain(terrain):
    """The terrain: returns (image, tile kernel launches of its render)."""
    import numpy as np
    img, launches, arms = _slice_render("6", terrain, TERRAIN_SPP,
                                        TERRAIN_BOUNCES)
    if set(arms) != {"static"}:
        raise AssertionError(f"the terrain ran the arms {arms}")
    # the top row looks past the terrain's far edge: every camera ray
    # escapes, and at depth 0 the background's MIS weight is 1
    top = img[0, :, :3]
    if not np.allclose(top, np.broadcast_to(SKY, top.shape), rtol=1e-5,
                       atol=0) or img[0, :, 3].any():
        raise AssertionError(f"top row is not the background {SKY}: "
                             f"{top.min(0)} .. {top.max(0)}")
    alpha = float(img[..., 3].mean())
    if not 0.2 < alpha < 0.95:
        raise AssertionError(f"terrain covers {alpha} of the frame")
    return img, launches


def phase8_forest(forest, terrain_img):
    """The slice: returns (tile kernel launches, launches per arm)."""
    import numpy as np
    acc = forest.blocks
    phys = _nbytes(acc.tab, acc.tab_t1)
    virt = acc.num_blocks * 16 * acc.block_size * 4 * 2
    print(f"phase 8: forest {forest.geom.num_faces} virtual triangles over "
          f"{forest.geom.num_base_faces} physical, {acc.num_blocks} virtual "
          f"blocks x {acc.block_size} over {acc.tab.shape[0]} physical; "
          f"physical tables (tab + tab_t1) {phys / 2**20:.2f} MiB, the same "
          f"blocks baked {virt / 2**20:.2f} MiB; "
          f"{_nbytes(acc.blk_base, acc.blk_minv, acc.id_delta, acc.inv_rows, acc.bmin, acc.bmax) / 2**20:.3f}"
          " MiB of virtual block tables")
    if (acc.block_size != 128 or acc.blk_base is None or acc.tab_t1 is None
            or not forest.geom.has_motion or forest.geom.inst_mat is None):
        raise AssertionError("the forest must compile to true instances with "
                             "keyframes, in blocks of 128")
    img, launches, arms = _slice_render("8", forest, TERRAIN_SPP,
                                        TERRAIN_BOUNCES)
    if set(arms) != {"instanced+motion1"}:
        raise AssertionError(f"every query must run the instanced + motion "
                             f"arm, ran {arms}")
    # non-trivial: the same camera sees the terrain and, on it, the rocks
    alpha = float(img[..., 3].mean())
    changed = float((np.abs(img[..., :3] - terrain_img[..., :3]).max(-1)
                     > 1e-2).mean())
    print(f"phase 8: alpha mean {alpha:.4f}; {100 * changed:.2f}% of pixels "
          "differ from the bare terrain's by more than 1e-2")
    if not 0.2 < alpha < 0.95 or not 0.01 < changed < 0.9:
        raise AssertionError("the forest image is not plausible")
    return launches, arms


def _kernel_vs_plain(phase, scene, camera):
    """The scene at a small camera, kernel path against plain path."""
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.cameras import make_camera
    from libyafaray_tpu_torch.params import ParamMap
    small = dataclasses.replace(scene, camera=make_camera(ParamMap(dict(
        camera, resx=TERRAIN_SMALL, resy=TERRAIN_SMALL))))
    cfg = make_integrator({"type": "pathtracing",
                           "bounces": TERRAIN_BOUNCES})
    img_k = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
    with _plain(TL, "tile_walk", TL.tile_walk_ref):
        img_p = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
    _paths_agree(phase, img_k, img_p)


# ---------------------------------------------------------------- phase 10

def phase10_golden():
    """The instanced cubes against the libYafaRay golden, true and baked."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.io import load_hdr
    from libyafaray_tpu_torch.scenes import instances_builder
    ref = load_hdr(GOLDEN)[..., :3]
    down = lambda x: x.reshape(GOLDEN_RES // 4, 4, GOLDEN_RES // 4, 4,
                               3).mean(axis=(1, 3))
    films = {}
    for mode in ("true", "baked"):
        b = instances_builder()
        if mode == "true":
            b.set_render_params({"instancing": "true",
                                 "scene_accelerator": "blocks"})
        scene = b.compile("cam")
        if (scene.geom.inst_mat is not None) != (mode == "true"):
            raise AssertionError(f"mode {mode}: wrong instancing")
        _zero_launches("mt_closest", "tile_walk")
        _clear_arm_launches()
        film = render(scene, make_integrator({"type": "directlighting"}),
                      GOLDEN_RES, GOLDEN_RES, spp=GOLDEN_SPP)
        torch.cuda.synchronize()
        counts = dict(mt_closest=_launches("mt_closest"), **_arm_launches())
        if mode == "true" and (_launches("mt_closest") or set(_arm_launches())
                               != {"instanced"}):
            raise AssertionError(f"true instances ran {counts}")
        if mode == "baked" and (_launches("tile_walk")
                                or not _launches("mt_closest")):
            raise AssertionError(f"baked instances ran {counts}")
        films[mode] = F.resolve(film).cpu().numpy()
        img = films[mode][..., :3] * np.pi
        scale = img.mean() / ref.mean()
        rd, od = down(ref), down(img)
        lit = rd.max(-1) > 0.02
        reld = np.abs(od - rd).max(-1)[lit] / rd.max(-1)[lit]
        p99 = float(np.percentile(reld, 99))
        print(f"phase 10: instances {mode} ({counts}): global scale "
              f"{scale:.6f}, downsampled mean rel {reld.mean():.5f}, p99 "
              f"{p99:.5f}")
        if not (np.isfinite(img).all() and abs(scale - 1.0) < 0.01
                and reld.mean() < 0.01 and p99 < 0.04):
            raise AssertionError(f"phase 10: mode {mode} misses the golden")
    diff = float(np.abs(films["true"] - films["baked"]).max())
    print(f"phase 10: true and baked renders: max |diff| {diff:.3g}")
    if diff > 2e-3:
        raise AssertionError("phase 10: true and baked instances disagree")


# ------------------------------------------------------- phases 11 to 15

def _check_fp32_precision():
    """Gradients run in full f32: nothing may have lowered matmul precision
    (TF32 or bf16 passes)."""
    import torch
    prec = torch.get_float32_matmul_precision()
    if prec != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError(f"fp32 matmul precision {prec!r}, allow_tf32 "
                             f"{torch.backends.cuda.matmul.allow_tf32}")


def _leaf_scene(scene, names):
    """The scene with each named column ("materials.diffuse_color") replaced
    by a fresh leaf, put in after the scene reached the card; the leaves."""
    leaves = []
    for name in names:
        table, column = name.split(".")
        leaf = getattr(getattr(scene, table), column).detach().clone()
        leaf.requires_grad_(True)
        scene = dataclasses.replace(scene, **{table: dataclasses.replace(
            getattr(scene, table), **{column: leaf})})
        leaves.append(leaf)
    return scene, leaves


def _pixels(width, r0, r1, device):
    """(px, py, pixel id) of image rows r0..r1 at the pixel centres."""
    import torch
    pid = torch.arange(r0 * width, r1 * width, dtype=torch.int64,
                       device=device)
    return ((pid % width).to(torch.float32) + 0.5,
            (pid // width).to(torch.float32) + 0.5, pid)


def _fwd_bwd(scene, cfg, leaves, pixels, sample, events=None):
    """Gradients of mean(rgb) over `pixels` at `sample` with respect to the
    leaves, through shoot_rays -> integrate -> autograd (bench.py's
    headline chunk); `events` (three CUDA events) split it into forward
    and backward."""
    import torch
    from libyafaray_tpu_torch.cameras import shoot_rays
    from libyafaray_tpu_torch.integrators.mc import integrate
    px, py, pid = pixels
    if events:
        events[0].record()
    o, d, valid = shoot_rays(scene.camera, px, py)
    rgb, _, _ = integrate(scene, cfg, o, d, valid, pid, sample)
    loss = rgb.mean()
    if events:
        events[1].record()
    grads = torch.autograd.grad(loss, leaves)
    if events:
        events[2].record()
    return grads


def _image_grads(scene, cfg, names, spp):
    """Gradients of the sum over `spp` samples of each pass's mean(rgb) over
    the whole frame, as numpy arrays."""
    import torch
    sc, leaves = _leaf_scene(scene.to(DEVICE), names)
    pixels = _pixels(scene.camera.resx, 0, scene.camera.resy, DEVICE)
    total = [torch.zeros_like(x) for x in leaves]
    for s in range(spp):
        for t, g in zip(total, _fwd_bwd(sc, cfg, leaves, pixels, s)):
            t += g
    return [t.cpu().numpy() for t in total]


def _grads_agree(phase, label, got, want, rtol):
    """Kernel-path gradients against plain-path ones, elementwise within
    rtol; both finite and not all zero."""
    import numpy as np
    for g, w, name in zip(got, want, label):
        rel = np.abs(g - w).max() / np.abs(w).max()
        print(f"phase {phase}: {name}: kernel path {g.ravel().round(7)}, "
              f"plain path {w.ravel().round(7)}; max |diff| / max |grad| "
              f"{rel:.3g}")
        if (not np.isfinite(g).all() or not np.abs(w).max() > 0
                or not (np.abs(g - w) <= rtol * np.abs(w)).all()):
            raise AssertionError(f"phase {phase}: {name}: the kernel-path "
                                 f"and plain-path gradients differ beyond "
                                 f"rtol {rtol}")


@contextlib.contextmanager
def _mt_captured():
    """Inside the context every mt_closest call is recorded, in call order,
    as (arguments, keywords, outputs) with its tensors cloned, and timed by
    CUDA events: the yielded (calls, events) fill as the work runs."""
    import torch
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    real, calls, events = MT.mt_closest, [], []
    copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x

    def kept(*a, **k):
        e = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = real(*a, **k)
        e[1].record()
        events.append(e)
        calls.append((tuple(copy(x) for x in a),
                      {key: copy(x) for key, x in k.items()},
                      tuple(x.clone() for x in out)))
        return out

    MT.mt_closest = kept
    try:
        yield calls, events
    finally:
        MT.mt_closest = real


def _hold_queries(phase, calls, labels):
    """Each captured query held bit for bit against mt_closest_ref, then
    timed alone beside the plain version and its bound. Returns the max
    error and per-launch means (ms, plain_ms, bound_ms, bound_by)."""
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    err, rows_out, bound_by = 0.0, [], {}
    for label, (a, k, got) in zip(labels, calls):
        want, plain = _once_ms(lambda: MT.mt_closest_ref(*a, **k))
        err = _compare(label, got, want, err, phase=phase, exact=True)
        ms = _cuda_ms(lambda: MT.mt_closest(*a, **k), 10)
        live, rows, bound, by = mt_bound(a, k)
        rows_out.append((ms, plain, bound))
        bound_by[by] = bound_by.get(by, 0.0) + bound
        print(f"phase {phase}: {label}: {a[1].shape[0]} rays, {live} live, "
              f"{rows} rows kept: mt_closest {ms:.4f} ms, mt_closest_ref "
              f"{plain:.4f} ms, bound {bound:.4f} ms ({by}), at "
              f"{100 * bound / ms:.1f}% of it")
    n = len(rows_out)
    ms, plain, bound = (sum(x) / n for x in zip(*rows_out))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=max(bound_by, key=bound_by.get))


def _hold_walks(phase, calls, labels):
    """Each captured tile_walk call held against tile_walk_ref (prim ids
    equal and t/u/v within rtol 1e-6 on closest hits, hit/miss equal on
    any hits), then timed alone beside the plain version and its bound.
    Returns the max error and per-launch means (ms, plain_ms, bound_ms,
    bound_by)."""
    import torch
    from libyafaray_tpu_torch.accel import tiles as TL
    err, rows_out, bound_by = 0.0, [], {}
    for label, (a, k, got) in zip(labels, calls):
        want, plain = _once_ms(lambda: TL.tile_walk_ref(*a, **k))
        if k.get("any_hit"):
            torch.cuda.synchronize()
            mism = int(((got[1] >= 0) != (want[1] >= 0)).sum())
            if mism:
                raise AssertionError(f"phase {phase}: {label}: hit/miss "
                                     f"differs on {mism} rays")
        else:
            err = _compare(label, got, want, err, phase=phase)
        ms = _cuda_ms(lambda: TL.tile_walk(*a, **k), 10)
        pairs, bound, by = _walk_bound(a, got, k)
        rows_out.append((ms, plain, bound))
        bound_by[by] = bound_by.get(by, 0.0) + bound
        rays = a[0]
        print(f"phase {phase}: {label} ({_kind(k)}"
              f"{', any hit' if k.get('any_hit') else ''}): {rays.shape[0]} "
              f"rays, {int((rays[:, 7] > rays[:, 6]).sum())} live, "
              f"{int((got[1] >= 0).sum())} hits, {pairs} pair tests needed: "
              f"tile_walk {ms:.4f} ms, tile_walk_ref {plain:.4f} ms, bound "
              f"{bound:.4f} ms ({by}), at {100 * bound / ms:.1f}% of it")
    n = len(rows_out)
    ms, plain, bound = (sum(x) / n for x in zip(*rows_out))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=max(bound_by, key=bound_by.get))


def _kind(k):
    return "shadow" if k.get("shadow") else "closest"


def phase11_fwd_bwd():
    """The headline: Cornell 1920x1080, 16 spp, 4 bounces, forward and
    backward with respect to materials.diffuse_color in chunks of 270 rows
    (bench.py's bench_cornell_fwd_bwd). Returns mt_closest's launches and,
    per launch, the error, times and bound of one chunk's queries."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import make_integrator
    from libyafaray_tpu_torch.ops import fast_grad as FG
    from libyafaray_tpu_torch.scenes import cornell_builder
    _check_fp32_precision()
    width, height, spp, bounces = WIDTH, HEIGHT, SPP, BOUNCES
    b = cornell_builder()
    b.cameras["cam"]["resx"] = width
    b.cameras["cam"]["resy"] = height
    scene, leaves = _leaf_scene(b.compile("cam").to(DEVICE),
                                ["materials.diffuse_color"])
    cfg = make_integrator({"type": "pathtracing", "bounces": bounces})
    chunks = [_pixels(width, r, min(r + CHUNK_ROWS, height), DEVICE)
              for r in range(0, height, CHUNK_ROWS)]
    n_chunk = chunks[0][0].shape[0]
    first = _fwd_bwd(scene, cfg, leaves, chunks[0], 0)[0]   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    spans = []
    total = torch.zeros_like(leaves[0])
    _zero_launches("mt_closest")
    t0 = time.perf_counter()
    for s in range(spp):
        for ch in chunks:
            e = (ev(), ev(), ev())
            g, = _fwd_bwd(scene, cfg, leaves, ch, s, e)
            total += g
            spans.append(e)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches("mt_closest")
    peak = torch.cuda.max_memory_allocated()
    fwd_ms = sum(a.elapsed_time(m) for a, m, _ in spans)
    bwd_ms = sum(m.elapsed_time(z) for _, m, z in spans)
    n_chunks = len(spans)
    want = n_chunks * (bounces + 1) * 2
    if launches != want:
        raise AssertionError(f"mt_closest launched {launches} times, want "
                             f"{want} (closest + shadow per depth per chunk)")
    grad = total.cpu().numpy()
    if not np.isfinite(grad).all() or not np.abs(grad).max() > 0:
        raise AssertionError(f"bad gradient {grad}")
    # the same chunk again: the same gradient
    again = _fwd_bwd(scene, cfg, leaves, chunks[0], 0)[0]
    delta = float((again - first).abs().max())
    rel = delta / float(first.abs().max())
    print(f"phase 11: cornell {width}x{height} {spp} spp {bounces} bounces, "
          f"forward + backward wrt diffuse_color in {n_chunks} chunks of "
          f"{n_chunk} rays: {seconds * 1e3:.2f} ms per image, "
          f"{seconds * 1e3 / spp:.2f} ms per spp pass, "
          f"{width * height * spp / seconds:.4g} camera rays/s; CUDA events: "
          f"forward {fwd_ms / n_chunks:.2f} ms + backward "
          f"{bwd_ms / n_chunks:.2f} ms per chunk ({fwd_ms / spp:.2f} + "
          f"{bwd_ms / spp:.2f} ms per pass); peak device memory "
          f"{peak / 2**30:.3f} GiB")
    print(f"phase 11: gradient of the image (sum over chunks) "
          f"{grad.round(6).tolist()}; the same chunk twice: max |diff| "
          f"{delta:.3g} ({rel:.3g} of max |grad|)")
    if rel > 1e-6:
        raise AssertionError("phase 11: the gradient is not reproducible")

    # one chunk again, with mt_closest's launches and take's backwards
    # captured: their times beside the chunk's
    real_grad, takes = FG.take_grad, []

    def grad_captured(idx, g, rows):
        takes.append((idx, g.detach().clone(), rows))
        return real_grad(idx, g, rows)

    FG.take_grad = grad_captured
    try:
        with _mt_captured() as (mt_calls, mt_ev):
            e = (ev(), ev(), ev())
            _fwd_bwd(scene, cfg, leaves, chunks[1], 1, e)
            torch.cuda.synchronize()
    finally:
        FG.take_grad = real_grad
    mt_ms = sum(a.elapsed_time(z) for a, z in mt_ev)
    # the chunk's queries at their own shape: each held bit for bit against
    # mt_closest_ref, then timed alone beside the plain version and its bound
    per_launch = _hold_queries(
        "11", mt_calls, [f"chunk query {i} ({_kind(k)})"
                         for i, (_, k, _) in enumerate(mt_calls)])
    alone_ms, alone_plain, alone_bound = (
        len(mt_calls) * per_launch[k] for k in ("ms", "plain_ms", "bound_ms"))
    # both backwards against the same sums in f64
    take_ms = plain_ms = take_err = plain_err = 0.0
    for idx, g, rows in takes:
        plain = lambda: torch.zeros((rows,) + g.shape[1:], device=DEVICE
                                    ).index_put_((idx,), g, accumulate=True)
        exact = torch.zeros((rows,) + g.shape[1:], dtype=torch.float64,
                            device=DEVICE).index_add_(0, idx, g.double())
        rel = lambda x: float(((x.double() - exact).abs()
                               / exact.abs().clamp_min(1e-30)).max())
        take_err = max(take_err, rel(real_grad(idx, g, rows)))
        plain_err = max(plain_err, rel(plain()))
        take_ms += _cuda_ms(lambda: real_grad(idx, g, rows), 5)
        plain_ms += _cuda_ms(plain, 5)
    print(f"phase 11: one chunk: forward {e[0].elapsed_time(e[1]):.2f} ms, "
          f"backward {e[1].elapsed_time(e[2]):.2f} ms; mt_closest "
          f"{len(mt_ev)} launches per chunk, {mt_ms:.3f} ms of events in the "
          f"chunk, {alone_ms:.4f} ms timed alone (mt_closest_ref "
          f"{alone_plain:.4f} ms, bound {alone_bound:.4f} ms); take: "
          f"{len(takes)} backwards in the chunk, the kernel's reductions "
          f"{take_ms:.3f} ms against plain indexing's backward "
          f"(index_put_ with accumulate) {plain_ms:.3f} ms; max relative "
          f"error against the f64 sums: take {take_err:.3g}, plain "
          f"indexing {plain_err:.3g}")
    if not takes or take_err > 1e-5:
        raise AssertionError("phase 11: take's backward misses the sums")
    if len(mt_calls) != want // n_chunks:
        raise AssertionError(f"phase 11: {len(mt_calls)} mt_closest calls in "
                             "the captured chunk")

    # where a chunk's time goes: the device time of one chunk's kernels
    # (profiler) against the unprofiled chunk's wall time (events above);
    # and the same work in one chunk of the whole frame
    n_k, busy_ms, top = _profiled(
        lambda: _fwd_bwd(scene, cfg, leaves, chunks[2], 2))
    chunk_ms = (fwd_ms + bwd_ms) / n_chunks
    print(f"phase 11: profiled chunk: device busy "
          + (f"{busy_ms:.2f} ms in {n_k} kernel launches, "
             f"{100 * busy_ms / chunk_ms:.1f}% of a chunk's {chunk_ms:.2f} "
             f"ms (idle {100 - 100 * busy_ms / chunk_ms:.1f}%); top: {top}"
             if busy_ms > 0 else "not measured (no device time traced)"))
    whole = _pixels(width, 0, height, DEVICE)
    _fwd_bwd(scene, cfg, leaves, whole, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for s in range(4):
        _fwd_bwd(scene, cfg, leaves, whole, s)
    torch.cuda.synchronize()
    print(f"phase 11: for comparison, the whole frame as one chunk: "
          f"{(time.perf_counter() - t0) * 1e3 / 4:.2f} ms per spp pass "
          f"(4 passes), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches, per_launch


def phase12_grad_paths(terrain):
    """Gradients through the kernel path against the plain path: Cornell
    and the terrain (kernel b). Returns tiles_traverse's launches."""
    import torch
    from libyafaray_tpu_torch import make_integrator
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.cameras import make_camera
    from libyafaray_tpu_torch.params import ParamMap
    from libyafaray_tpu_torch.scenes import TERRAIN_CAMERA, cornell_builder
    _check_fp32_precision()
    names = ["materials.diffuse_color", "lights.color"]
    b = cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = SMALL
    cornell = b.compile("cam")
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    got = _image_grads(cornell, cfg, names, 2)
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        want = _image_grads(cornell, cfg, names, 2)
    _grads_agree("12", [f"cornell {SMALL}x{SMALL} {n}" for n in names], got,
                 want, GRAD_RTOL)
    small = dataclasses.replace(terrain, camera=make_camera(ParamMap(dict(
        TERRAIN_CAMERA, resx=TERRAIN_SMALL, resy=TERRAIN_SMALL))))
    cfg = make_integrator({"type": "pathtracing",
                           "bounces": TERRAIN_BOUNCES})
    _zero_launches("tile_walk")
    got = _image_grads(small, cfg, names, 1)
    torch.cuda.synchronize()
    launches = _launches("tile_walk")
    if launches != (TERRAIN_BOUNCES + 1) * 3:
        raise AssertionError(f"the terrain launched tile_walk {launches} "
                             "times")
    with _plain(TL, "tile_walk", TL.tile_walk_ref):
        want = _image_grads(small, cfg, names, 1)
    _grads_agree("12", [f"terrain {TERRAIN_SMALL}x{TERRAIN_SMALL} {n}"
                        for n in names], got, want, GRAD_RTOL)
    return launches


def phase13_glossy():
    """BASELINE config 2: the glossy Cornell at 512x512, 16 spp, 4 bounces;
    its kernel and plain paths at 256x256; kernel-path and plain-path
    exponent gradients on the Cornell box with the glossy slab."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.scenes import (glossy_cornell_builder,
                                             glossy_slab_builder)
    b = glossy_cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = GLOSSY_RES
    scene = b.compile("cam")
    if 1 not in scene.materials.present_types:
        raise AssertionError("the glossy material is not compiled")
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    render(scene, cfg, spp=1)                       # warm-up pass
    torch.cuda.synchronize()
    _zero_launches("mt_closest")
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=SPP)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches("mt_closest")
    img = F.resolve(film).cpu().numpy()
    if not np.isfinite(img).all() or launches != SPP * (BOUNCES + 1) * 2:
        raise AssertionError(f"glossy render: finite {np.isfinite(img).all()}"
                             f", {launches} mt_closest launches")
    print(f"phase 13: glossy cornell {GLOSSY_RES}x{GLOSSY_RES} {SPP} spp "
          f"{BOUNCES} bounces: {seconds * 1e3 / SPP:.2f} ms/pass, "
          f"{GLOSSY_RES ** 2 * SPP / seconds:.4g} camera rays/s, {launches} "
          f"kernel launches, image mean {float(img.mean()):.6f}")
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = SMALL
    small = b.compile("cam")
    img_k = F.resolve(render(small, cfg, spp=2)).cpu().numpy()
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        img_p = F.resolve(render(small, cfg, spp=2)).cpu().numpy()
    _paths_agree("13", img_k, img_p)
    # no face of config 2 uses its glossy material: the exponent gradient
    # is taken where the glossy slab is in view
    b = glossy_slab_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = SMALL
    slab = b.compile("cam")
    _check_fp32_precision()
    got = _image_grads(slab, cfg, ["materials.exponent"], 2)
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        want = _image_grads(slab, cfg, ["materials.exponent"], 2)
    _grads_agree("13", [f"glossy slab {SMALL}x{SMALL} exponent"], got, want,
                 GRAD_RTOL)
    return launches


def phase14_train():
    """make_train_step: five SGD steps on the Cornell diffuse colours at
    256x256, 1 bounce, target 0.25, sample 0; the loss must decrease.
    Returns (the losses, the parameters after each step) for phase 32."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import make_integrator, make_train_step
    from libyafaray_tpu_torch.scenes import cornell_builder
    _check_fp32_precision()
    b = cornell_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = SMALL
    scene = b.compile("cam")
    step = make_train_step(make_integrator({"type": "pathtracing",
                                            "bounces": 1}), SMALL, SMALL)
    params = {"diffuse_color": scene.materials.diffuse_color}
    target = torch.full((SMALL, SMALL, 3), 0.25, device=DEVICE)
    losses, times, steps = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        params, loss = step(scene, params, target, 0)
        losses.append(float(loss))        # synchronises
        times.append(time.perf_counter() - t0)
        steps.append(params["diffuse_color"].cpu())
    print(f"phase 14: make_train_step {SMALL}x{SMALL}, 1 bounce: losses "
          f"{[round(x, 8) for x in losses]}; ms per step "
          f"{[round(t * 1e3, 2) for t in times]}; diffuse_color now "
          f"{params['diffuse_color'].cpu().numpy().round(5).tolist()}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 14: the loss did not decrease: {losses}")
    return losses, steps


def phase15_cornell_golden():
    """The Cornell box under directlighting against the libYafaRay golden
    tests/golden/cornell_ref_256.hdr, with tests/test_refparity.py's
    bounds."""
    import numpy as np
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.io import load_hdr
    from libyafaray_tpu_torch.scenes import cornell_builder
    ref = load_hdr(CORNELL_GOLDEN)[..., :3]
    b = cornell_builder()
    # the reference's area lights are invisible to camera rays
    b.lights["lamp"]["visibility"] = "invisible"
    b.lights["lamp"]["samples"] = 1
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = CORNELL_GOLDEN_RES
    film = render(b.compile("cam"), make_integrator({"type": "directlighting"}),
                  spp=CORNELL_GOLDEN_SPP)
    img = F.resolve(film)[..., :3].cpu().numpy() * np.pi
    down = lambda x: x.reshape(CORNELL_GOLDEN_RES // 4, 4,
                               CORNELL_GOLDEN_RES // 4, 4, 3).mean((1, 3))
    scale = img.mean() / ref.mean()
    lit = ref.max(-1) > 0.05
    rel = np.abs(img - ref).max(-1)[lit] / ref.max(-1)[lit]
    rd, od = down(ref), down(img)
    litd = rd.max(-1) > 0.05
    reld = np.abs(od - rd).max(-1)[litd] / rd.max(-1)[litd]
    p99 = float(np.percentile(reld, 99))
    print(f"phase 15: cornell directlighting {CORNELL_GOLDEN_RES}x"
          f"{CORNELL_GOLDEN_RES} {CORNELL_GOLDEN_SPP} spp against the "
          f"libYafaRay golden: global scale {scale:.6f}, mean relative error "
          f"{rel.mean():.5f}, 4x4-downsampled p99 {p99:.5f}, max "
          f"{reld.max():.5f}")
    if not (np.isfinite(img).all() and abs(scale - 1.0) < 0.01
            and rel.mean() < 0.04 and p99 < 0.06 and reld.max() < 0.15):
        raise AssertionError("phase 15: the Cornell render misses the golden")


# ------------------------------------------------------- phases 16 to 18

def _profiled(fn):
    """(kernel launches, device busy ms, the four longest kernels as text)
    of fn() under the profiler."""
    import torch
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [k for k in prof.key_averages()
               if k.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda k: -k.self_device_time_total)[:4]
    return (sum(k.count for k in kernels),
            sum(k.self_device_time_total for k in kernels) / 1e3,
            ", ".join(f"{k.key[:48]} {k.self_device_time_total / 1e3:.2f} ms "
                      f"x{k.count}" for k in top))


def _profile_pass(scene, cfg):
    """(kernel launches, device busy ms, ms) of one pass of `scene`: the
    launches and busy time from the profiler, the ms from an unprofiled
    pass (host clock, synchronised)."""
    import torch
    from libyafaray_tpu_torch import render
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render(scene, cfg, spp=1, start_sample=1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n, busy, _ = _profiled(lambda: render(scene, cfg, spp=1, start_sample=1))
    return n, busy, ms


def phase16_textured(textured, terrain, terrain_img):
    """The slice: the textured terrain. Returns (image, tile kernel
    launches of its render)."""
    import numpy as np
    from libyafaray_tpu_torch import make_integrator
    from libyafaray_tpu_torch.scenes import TERRAIN_CAMERA
    pool, prog = textured.textures, textured.nodes
    if pool is None or prog is None or prog.bound != ("node_diffuse",):
        raise AssertionError("the textured terrain must bind a texture node "
                             "to the diffuse colour")
    print(f"phase 16: texel pool {tuple(pool.texel_pool.shape)} "
          f"{pool.texel_pool.dtype} ({pool.num_textures} texture, "
          f"{int(pool.num_mips[0])} mip levels), {prog.num_nodes} shader "
          f"node, interpolation {pool.used_interps}")
    img, launches, arms = _slice_render("16", textured, TERRAIN_SPP,
                                        TERRAIN_BOUNCES)
    want = TERRAIN_SPP * (TERRAIN_BOUNCES + 1) * 3
    if set(arms) != {"static"} or launches != want:
        raise AssertionError(f"the textured terrain ran {launches} launches "
                             f"{arms}, want {want} of the static arm")
    top = img[0, :, :3]
    if not np.allclose(top, np.broadcast_to(SKY, top.shape), rtol=1e-5,
                       atol=0) or img[0, :, 3].any():
        raise AssertionError("the textured terrain's top row is not the sky")
    alpha, alpha6 = float(img[..., 3].mean()), float(terrain_img[..., 3].mean())
    covered = img[..., 3] > 0
    changed = float((np.abs(img[..., :3] - terrain_img[..., :3]).max(-1)
                     > 1e-2)[covered].mean())
    print(f"phase 16: alpha mean {alpha:.6f} (phase 6: {alpha6:.6f}); "
          f"{100 * changed:.2f}% of covered pixels differ from phase 6's "
          "untextured image by more than 1e-2")
    if abs(alpha - alpha6) > 1e-6 or changed < 0.5:
        raise AssertionError("the textured terrain's image is not plausible")
    _kernel_vs_plain("16", textured, TERRAIN_CAMERA)
    cfg = make_integrator({"type": "pathtracing",
                           "bounces": TERRAIN_BOUNCES})
    for label, sc in (("untextured terrain (phase 6's scene)", terrain),
                      ("textured terrain", textured)):
        n, busy, ms = _profile_pass(sc, cfg)
        print(f"phase 16: one pass of the {label}: {n} kernel launches, "
              + (f"device busy {busy:.2f} ms of {ms:.2f} ms "
                 f"({100 * busy / ms:.1f}%)" if busy > 0 else
                 "device busy not measured (no device time traced)"))
    return img, launches


@contextlib.contextmanager
def _cover_order(on: bool):
    """YAF_COVER_ORDER set to 1 (on) or unset inside the context."""
    before = os.environ.pop("YAF_COVER_ORDER", None)
    if on:
        os.environ["YAF_COVER_ORDER"] = "1"
    try:
        yield
    finally:
        os.environ.pop("YAF_COVER_ORDER", None)
        if before is not None:
            os.environ["YAF_COVER_ORDER"] = before


def _capture_any(scene, cover):
    """Every any-hit tile_walk call of one pass of `scene` at its camera's
    size (sample 0, TERRAIN_BOUNCES), in cover order or front to back, each
    as ((rays, cand, ent, count, tab), keywords); and the pass's launches
    per arm."""
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import tiles as TL
    kept, real = [], TL.tile_walk

    def keep_call(*a, **k):
        if k.get("any_hit"):
            kept.append((a, k))
        return real(*a, **k)

    _clear_arm_launches()
    TL.tile_walk = keep_call
    try:
        with _cover_order(cover):
            render(scene, make_integrator({"type": "pathtracing",
                                           "bounces": TERRAIN_BOUNCES}),
                   spp=1)
    finally:
        TL.tile_walk = real
    return kept, _arm_launches()


def _cover_case(label, acc, cover_q, front_q):
    """One any-hit query walked in cover order by the kernel against
    tile_walk_ref and against the front-to-back kernel walk of the same
    rays (hit/miss equal on every ray); times and bound. Returns dict(ms,
    front_ms, plain_ms, bound_ms, bound_by, cand_ms, front_cand_ms)."""
    import torch
    from libyafaray_tpu_torch.accel import tiles as TL
    (*prep, tab), kw = cover_q
    (*fprep, ftab), fkw = front_q
    if not kw.get("cover_order") or fkw.get("cover_order"):
        raise AssertionError(f"phase 17: {label}: not a cover / front pair")
    if not torch.equal(prep[0], fprep[0]):
        raise AssertionError(f"phase 17: {label}: the two orders' rays "
                             "differ")
    steps = torch.zeros(prep[0].shape[0], dtype=torch.int64, device=DEVICE)
    got = TL.tile_walk(*prep, tab, **kw)
    want, plain_ms = _once_ms(
        lambda: TL.tile_walk_ref(*prep, tab, steps=steps, **kw))
    front = TL.tile_walk(*fprep, ftab, **fkw)
    torch.cuda.synchronize()
    for name, other in (("tile_walk_ref", want), ("front to back", front)):
        mism = int(((got[1] >= 0) != (other[1] >= 0)).sum())
        if mism:
            raise AssertionError(f"phase 17: {label}: hit/miss differs from "
                                 f"{name} on {mism} rays")
    r = prep[0]
    rays_args = (acc.bmin, acc.bmax, r[:, 0:3].contiguous(),
                 r[:, 3:6].contiguous(), r[:, 6].contiguous(),
                 r[:, 7].contiguous())
    out = dict(
        ms=_cuda_ms(lambda: TL.tile_walk(*prep, tab, **kw), 5),
        front_ms=_cuda_ms(lambda: TL.tile_walk(*fprep, ftab, **fkw), 5),
        plain_ms=plain_ms,
        cand_ms=_cuda_ms(lambda: TL.tile_candidates(*rays_args,
                                                    any_hit=True), 3),
        front_cand_ms=_cuda_ms(lambda: TL.tile_candidates(*rays_args), 3))
    pairs, out["bound_ms"], out["bound_by"] = _walk_bound(
        (*prep, tab), got, kw, steps=steps)
    live = int((r[:, 7] >= r[:, 6]).sum())
    print(f"phase 17: {label}: {live} live rays, {int((got[1] >= 0).sum())} "
          f"hits, hit/miss equal to tile_walk_ref and to the front-to-back "
          f"walk; {int(steps.sum())} ray-candidate steps needed of "
          f"{int(prep[3].sum()) * TL.RAY_TILE} on the lists ({pairs} pair "
          f"tests): cover order "
          f"{out['ms']:.4f} ms, front to back {out['front_ms']:.4f} ms, "
          f"tile_walk_ref {out['plain_ms']:.2f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}), the kernel at "
          f"{100 * out['bound_ms'] / out['ms']:.1f}% of it; tile_candidates "
          f"with coverage {out['cand_ms']:.3f} ms, without "
          f"{out['front_cand_ms']:.3f} ms")
    return out


def phase17_cover(textured, forest, textured_img):
    """The cover-order arm; returns (arm entries for the kernels line,
    launches of the cover-order render)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import blocks as BL
    from libyafaray_tpu_torch.scenes import bigmesh_grid
    arms = []
    for name, scene, arm in (("textured terrain", textured, "static+cover"),
                             ("forest", forest, "instanced+motion1+cover")):
        cover_q, launched = _capture_any(scene, True)
        front_q, _ = _capture_any(scene, False)
        want = (TERRAIN_BOUNCES + 1) * 2
        if len(cover_q) != want or len(front_q) != want or not launched.get(
                arm):
            raise AssertionError(f"phase 17: {name}: {len(cover_q)} cover "
                                 f"queries, arms {launched}")
        print(f"phase 17: {name}, one pass in cover order: launches "
              f"{launched}")
        cases = [_cover_case(f"{name} any-hit query {i} (depth {i // 2}, "
                             f"{'sun' if i % 2 == 0 else 'background'})",
                             scene.blocks, c, f)
                 for i, (c, f) in enumerate(zip(cover_q, front_q))]
        total = {k: sum(c[k] for c in cases) for k in
                 ("ms", "front_ms", "plain_ms", "bound_ms", "cand_ms",
                  "front_cand_ms")}
        print(f"phase 17: {name}, the pass's {want} any-hit queries: cover "
              f"order {total['ms']:.4f} ms, front to back "
              f"{total['front_ms']:.4f} ms, bound {total['bound_ms']:.4f} "
              f"ms; tile_candidates with coverage {total['cand_ms']:.3f} ms, "
              f"without {total['front_cand_ms']:.3f} ms")
        arms.append(dict(
            arm=arm, launches=launched[arm],
            ms=total["ms"] / want, plain_ms=total["plain_ms"] / want,
            bound_ms=total["bound_ms"] / want,
            bound_by=max((c["bound_by"] for c in cases),
                         key=[c["bound_by"] for c in cases].count),
            front_to_back_ms=total["front_ms"] / want,
            path=f"{name}, one pass in cover order, phase 17 (mean per "
                 "any-hit query)"))
        del cover_q, front_q
    # random any-hit rays on phase 3b's 2.4M-triangle table
    rng = np.random.default_rng(17)
    verts, faces, _, _ = bigmesh_grid(BIG_GRID)
    vis = np.full(len(faces), 3, np.int32)
    vis[::7] = 2
    vis[::11] = 1
    big = BL.build_blocks(_mesh(verts, faces, vis))
    o, d, t_min, t_max, excl = _rays(rng, N_BIG, [0, 0, 0.3], [4, 4, 1.5],
                                     len(faces), 7)
    d[: N_BIG // 2, 2] = -d[: N_BIG // 2, 2].abs()
    kw = dict(shadow=True, any_hit=True)
    cq = _sorted_query(big, o, d, t_min, t_max, excl, cover=True)
    fq = _sorted_query(big, o, d, t_min, t_max, excl)
    big_case = _cover_case(f"big terrain ({len(faces)} triangles, blocks of "
                           f"{big.block_size}), random rays", big,
                           (cq[1:] + (big.tab,), dict(kw, cover_order=True)),
                           (fq[1:] + (big.tab,), kw))
    arms.append(dict(arm="static+cover, blocks of 1024", launches=0,
                     **{k: big_case[k] for k in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by")},
                     front_to_back_ms=big_case["front_ms"],
                     path="phase 17, the regime of TPU kernel c"))
    del big, cq, fq
    # the textured terrain rendered both ways at phase 16's size
    cfg = make_integrator({"type": "pathtracing",
                           "bounces": TERRAIN_BOUNCES})
    images, ms = {}, {}
    for on in (False, True):
        with _cover_order(on):
            torch.cuda.synchronize()
            _clear_arm_launches()
            t0 = time.perf_counter()
            film = render(textured, cfg, spp=TERRAIN_SPP)
            torch.cuda.synchronize()
            ms[on] = (time.perf_counter() - t0) * 1e3 / TERRAIN_SPP
            images[on] = F.resolve(film).cpu().numpy()
            launched = _arm_launches()
    print(f"phase 17: textured terrain {TERRAIN_RES}x{TERRAIN_RES} "
          f"{TERRAIN_SPP} spp: front to back {ms[False]:.2f} ms/pass, cover "
          f"order {ms[True]:.2f} ms/pass ({launched}); the two images equal: "
          f"{np.array_equal(images[True], images[False])}, equal to phase "
          f"16's: {np.array_equal(images[True], textured_img)}")
    if not (np.array_equal(images[True], images[False])
            and np.array_equal(images[True], textured_img)):
        raise AssertionError("phase 17: the cover-order render differs")
    # the arm's launches are those of the cover-order render (the main
    # path in cover order); its times are per any-hit query of one pass
    arms[0].update(launches=launched["static+cover"],
                   path=f"textured terrain rendered in cover order "
                        f"({TERRAIN_SPP} passes), phase 17; times: mean per "
                        "any-hit query of one pass")
    return arms, sum(launched.values())


def phase18_texel_grads(textured):
    """Texel gradients through the kernel path against the plain path, and
    their cost at 720x720. Returns tiles_traverse's launches in the timed
    720x720 forward + backward."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import make_integrator
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.cameras import make_camera
    from libyafaray_tpu_torch.params import ParamMap
    from libyafaray_tpu_torch.scenes import TERRAIN_CAMERA
    _check_fp32_precision()
    names = ["textures.texel_pool"]
    cfg = make_integrator({"type": "pathtracing",
                           "bounces": TERRAIN_BOUNCES})
    small = dataclasses.replace(textured, camera=make_camera(ParamMap(dict(
        TERRAIN_CAMERA, resx=TERRAIN_SMALL, resy=TERRAIN_SMALL))))
    _zero_launches("tile_walk")
    got, = _image_grads(small, cfg, names, 1)
    again, = _image_grads(small, cfg, names, 1)
    torch.cuda.synchronize()
    if _launches("tile_walk") != 2 * (TERRAIN_BOUNCES + 1) * 3:
        raise AssertionError(f"phase 18: {_launches('tile_walk')} tile_walk "
                             f"launches at {TERRAIN_SMALL}x{TERRAIN_SMALL}")
    with _plain(TL, "tile_walk", TL.tile_walk_ref):
        want, = _image_grads(small, cfg, names, 1)
    for label, a, b in (("kernel path against plain path", got, want),
                        ("kernel path twice", again, got)):
        scale = np.abs(b).max()
        ok = np.abs(a - b) <= TEXEL_RTOL * np.abs(b) + 1e-6 * scale
        print(f"phase 18: texel gradient {TERRAIN_SMALL}x{TERRAIN_SMALL}, "
              f"{label}: {int((b != 0).any(-1).sum())} of {b.shape[0]} texels "
              f"with a gradient, max |grad| {scale:.4g}, max |diff| / max "
              f"|grad| {np.abs(a - b).max() / scale:.3g}, max relative diff "
              f"{(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max():.3g}")
        if not (np.isfinite(a).all() and scale > 0 and ok.all()):
            raise AssertionError(f"phase 18: {label}: the texel gradients "
                                 f"differ beyond rtol {TEXEL_RTOL}")
    # the whole 720x720 frame, 1 spp
    sc, leaves = _leaf_scene(textured, names)
    pixels = _pixels(TERRAIN_RES, 0, TERRAIN_RES, DEVICE)
    _fwd_bwd(sc, cfg, leaves, pixels, 0)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    _zero_launches("tile_walk")
    g, = _fwd_bwd(sc, cfg, leaves, pixels, 1, ev)
    torch.cuda.synchronize()
    launches = _launches("tile_walk")
    peak = torch.cuda.max_memory_allocated()
    if launches != (TERRAIN_BOUNCES + 1) * 3:
        raise AssertionError(f"phase 18: {launches} tile_walk launches at "
                             f"{TERRAIN_RES}x{TERRAIN_RES}")
    if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
        raise AssertionError("phase 18: the 720x720 texel gradient is not "
                             "finite or all zero")
    print(f"phase 18: texel gradient {TERRAIN_RES}x{TERRAIN_RES}, 1 spp, "
          f"{TERRAIN_BOUNCES} bounces: forward {ev[0].elapsed_time(ev[1]):.2f}"
          f" ms, backward {ev[1].elapsed_time(ev[2]):.2f} ms, peak device "
          f"memory {peak / 2**30:.3f} GiB, {launches} tile_walk launches; "
          f"{int((g != 0).any(-1).sum())} texels with a gradient")
    return launches


# ------------------------------------------------------- phases 19 and 20

def phase19_caustic():
    """BASELINE config 4: the caustic forward + backward at 512x512, 5
    bounces, pixel centres, with respect to materials.ior and
    textures.texel_pool (bench.py's bench_caustic_grad). Returns
    mt_closest's launches in the timed samples and its per-launch numbers
    on one pass's queries."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.scenes import caustic_grad_builder
    from libyafaray_tpu_torch.scene_types import MAT_GLASS
    _check_fp32_precision()
    res, bounces = CAUSTIC_RES, CAUSTIC_BOUNCES
    names = ["materials.ior", "textures.texel_pool"]
    scene = caustic_grad_builder(res, res).compile("cam")
    glass = int(torch.nonzero(scene.materials.mat_type == MAT_GLASS)[0])
    pool_rows = scene.textures.texel_pool.shape[0]
    sc, leaves = _leaf_scene(scene, names)
    cfg = make_integrator({"type": "pathtracing", "bounces": bounces})
    pixels = _pixels(res, 0, res, DEVICE)
    first = _fwd_bwd(sc, cfg, leaves, pixels, 0)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = lambda: torch.cuda.Event(enable_timing=True)
    spans, totals = [], [torch.zeros_like(x) for x in leaves]
    _zero_launches("mt_closest")
    t0 = time.perf_counter()
    for s in range(1, CAUSTIC_SAMPLES + 1):
        e = (ev(), ev(), ev())
        for t, g in zip(totals, _fwd_bwd(sc, cfg, leaves, pixels, s, e)):
            t += g
        spans.append(e)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches("mt_closest")
    peak = torch.cuda.max_memory_allocated()
    fwd_ms = sum(a.elapsed_time(m) for a, m, _ in spans) / CAUSTIC_SAMPLES
    bwd_ms = sum(m.elapsed_time(z) for _, m, z in spans) / CAUSTIC_SAMPLES
    want = CAUSTIC_SAMPLES * (bounces + 1) * 2
    if launches != want:
        raise AssertionError(f"phase 19: mt_closest launched {launches} "
                             f"times, want {want}")
    g_ior, g_tex = (t.cpu().numpy() for t in totals)
    tex_l1 = float(np.abs(g_tex).sum())
    if not (np.isfinite(g_ior).all() and np.isfinite(g_tex).all()
            and g_ior[glass] != 0 and tex_l1 > 0):
        raise AssertionError(f"phase 19: bad gradients: ior {g_ior}, "
                             f"texel L1 {tex_l1}")
    again = _fwd_bwd(sc, cfg, leaves, pixels, 0)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    rel = max(float((a - b).abs().max() / b.abs().max())
              for a, b in zip(again, first))
    print(f"phase 19: caustic {res}x{res} {bounces} bounces, forward + "
          f"backward wrt ior and texel_pool ({pool_rows} rows), samples 1-"
          f"{CAUSTIC_SAMPLES}: {seconds * 1e3 / CAUSTIC_SAMPLES:.2f} ms per "
          f"forward + backward, {res * res * CAUSTIC_SAMPLES / seconds:.4g} "
          f"camera rays/s; CUDA events: forward {fwd_ms:.2f} ms + backward "
          f"{bwd_ms:.2f} ms; peak device memory {peak / 2**30:.3f} GiB; "
          f"{launches} mt_closest launches")
    print(f"phase 19: gradient of the summed means: ior (glass row {glass}) "
          f"{g_ior[glass]:.6g}, texel L1 {tex_l1:.6g} over "
          f"{int((g_tex != 0).any(-1).sum())} texels; sample 0 twice: "
          f"bit for bit {same}, max |diff| / max |grad| {rel:.3g}")
    if rel > 1e-6:
        raise AssertionError("phase 19: the same sample gave two gradients")

    # one pass's queries, captured as they reach mt_closest
    with _mt_captured() as (calls, events):
        e = (ev(), ev(), ev())
        _fwd_bwd(sc, cfg, leaves, pixels, 1, e)
        torch.cuda.synchronize()
    mt_ms = sum(a.elapsed_time(z) for a, z in events)
    print(f"phase 19: one forward + backward: forward "
          f"{e[0].elapsed_time(e[1]):.2f} ms, backward "
          f"{e[1].elapsed_time(e[2]):.2f} ms; mt_closest {len(calls)} "
          f"launches, {mt_ms:.3f} ms of events")
    per_launch = _hold_queries(
        "19", calls, [f"caustic query {i} ({_kind(k)})"
                      for i, (_, k, _) in enumerate(calls)])
    n_k, busy, top = _profiled(lambda: _fwd_bwd(sc, cfg, leaves, pixels, 2))
    wall = seconds * 1e3 / CAUSTIC_SAMPLES
    print(f"phase 19: one forward + backward profiled: {n_k} kernel "
          f"launches, device busy {busy:.2f} ms of the unprofiled "
          f"{wall:.2f} ms ({100 * busy / wall:.1f}%); top: {top}")

    # kernel path against plain path at 128x128, 1 spp: image and gradients
    small = caustic_grad_builder(PATHS_RES, PATHS_RES).compile("cam")
    img_k = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
    got = _image_grads(small, cfg, names, 1)
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        img_p = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
        want_g = _image_grads(small, cfg, names, 1)
    _paths_agree("19", img_k, img_p)
    _grads_agree("19", [f"caustic {PATHS_RES}x{PATHS_RES} ior"], got[:1],
                 want_g[:1], GRAD_RTOL)
    a, b = got[1], want_g[1]
    scale = np.abs(b).max()
    print(f"phase 19: texel gradient {PATHS_RES}x{PATHS_RES}, kernel path "
          f"against plain path: max |grad| {scale:.4g}, max |diff| / max "
          f"|grad| {np.abs(a - b).max() / scale:.3g}")
    if not (np.isfinite(a).all() and scale > 0 and (
            np.abs(a - b) <= TEXEL_RTOL * np.abs(b) + 1e-6 * scale).all()):
        raise AssertionError("phase 19: the kernel-path and plain-path texel "
                             "gradients differ")
    return launches, per_launch


def _glow_pixel(camera, point):
    """(px, py) where the camera sees `point` (the inverse of shoot_rays)."""
    import torch
    d = torch.tensor(point, device=camera.origin.device) - camera.origin
    z = float((d * camera.cam_z).sum())
    sx = float(camera.focal) * float((d * camera.cam_x).sum()) / z
    sy = -float(camera.focal) * float((d * camera.cam_y).sum()) / z
    return (int((sx + 0.5) * camera.resx),
            int((sy / float(camera.aspect) + 0.5) * camera.resy))


def phase20_volume():
    """BASELINE config 5: the homogeneous single-scatter volume lit by an
    emissive mesh, 512x512, 8 spp, 3 bounces, 16 volume steps, through
    `render` with no device argument. Returns mt_closest's launches in the
    timed render and its per-launch numbers on one pass's queries."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.integrators import volume as VI
    from libyafaray_tpu_torch.scenes import volume_emissive_builder
    b = volume_emissive_builder()
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = VOLUME_RES
    scene = b.compile("cam")
    cfg = make_integrator({"type": "pathtracing", "bounces": VOLUME_BOUNCES})
    per_pass = (VOLUME_BOUNCES + 1) * (1 + scene.lights.num_lights) \
        + cfg.vol_steps
    render(scene, cfg, spp=1)                        # warm-up pass
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches("mt_closest")
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=VOLUME_SPP)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches("mt_closest")
    peak = torch.cuda.max_memory_allocated()
    if launches != VOLUME_SPP * per_pass:
        raise AssertionError(f"phase 20: {launches} mt_closest launches, "
                             f"want {VOLUME_SPP} x {per_pass}")
    img = F.resolve(film).cpu().numpy()
    clear = F.resolve(render(dataclasses.replace(scene, volumes=None), cfg,
                             spp=VOLUME_SPP)).cpu().numpy()
    changed = float((np.abs(img - clear)[..., :3].max(-1) > 1e-4).mean())
    gx, gy = _glow_pixel(scene.camera, (0.5, 0.5, 0.42))
    glow = img[gy, gx, :3]
    n_k, busy, ms = _profile_pass(scene, cfg)
    print(f"phase 20: volume {VOLUME_RES}x{VOLUME_RES} {VOLUME_SPP} spp "
          f"{VOLUME_BOUNCES} bounces, {cfg.vol_steps} volume steps: "
          f"{seconds * 1e3 / VOLUME_SPP:.2f} ms/pass, "
          f"{VOLUME_RES ** 2 * VOLUME_SPP / seconds:.4g} camera rays/s, peak "
          f"device memory {peak / 2**30:.3f} GiB, {launches // VOLUME_SPP} "
          f"mt_closest launches per pass; one pass profiled: {n_k} kernel "
          f"launches, device busy {busy:.2f} of {ms:.2f} ms "
          f"({100 * busy / ms:.1f}%)")
    print(f"phase 20: image mean {float(img[..., :3].mean()):.6f} against "
          f"{float(clear[..., :3].mean()):.6f} without the volume region; "
          f"{100 * changed:.2f}% of pixels changed by more than 1e-4; the "
          f"glow at pixel ({gx}, {gy}) {glow.round(4).tolist()}")
    if not (np.isfinite(img).all() and changed > 0.99 and glow[0] > 1.0
            and glow[0] > glow[1] > glow[2]):
        raise AssertionError("phase 20: the image is not finite, the fog or "
                             "the glow is not visible")

    # the fog's two shares over one pass's camera segments
    from libyafaray_tpu_torch.cameras import shoot_rays
    from libyafaray_tpu_torch.ops import intersect as I
    px, py, pid = _pixels(VOLUME_RES, 0, VOLUME_RES, DEVICE)
    o, d, _ = shoot_rays(scene.camera, px, py)
    t_hit = I.closest_hit(scene, o, d, scene.ray_min_dist, 1e30).t
    tr = VI.transmittance(scene, o, d, t_hit, cfg.vol_steps)
    ins = VI.in_scatter(scene, o, d, t_hit, pid, 0, cfg.vol_steps)
    print(f"phase 20: camera segments: mean transmittance "
          f"{float(tr.mean()):.4f}, mean in-scattered radiance "
          f"{float(ins.mean()):.6f}")
    if not (float(tr.max()) < 1.0 and float(ins.mean()) > 0):
        raise AssertionError("phase 20: the fog neither attenuates nor "
                             "scatters")

    # one pass's queries, the 16 in-scatter shadow queries last
    with _mt_captured() as (calls, events):
        render(scene, cfg, spp=1, start_sample=1)
        torch.cuda.synchronize()
    if len(calls) != per_pass:
        raise AssertionError(f"phase 20: {len(calls)} queries in a pass")
    surface = per_pass - cfg.vol_steps
    labels = [f"volume query {i} ({_kind(k)}"
              + (f", in-scatter step {i - surface})" if i >= surface else ")")
              for i, (_, k, _) in enumerate(calls)]
    print(f"phase 20: one pass: mt_closest {len(calls)} launches, "
          f"{sum(a.elapsed_time(z) for a, z in events):.3f} ms of events")
    per_launch = _hold_queries("20", calls, labels)

    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = PATHS_RES
    small = b.compile("cam")
    img_k = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        img_p = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
    _paths_agree("20", img_k, img_p)
    return launches, per_launch


# ------------------------------------------------------- phases 21 to 23

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "golden")
CAMERA_GOLDEN_RES, CAMERA_GOLDEN_SPP = 128, 24
# tests/test_refparity.py's bounds: 4x4-downsampled mean and p99 relative
CAMERA_GOLDEN_TOL = {"orthographic": (0.04, 0.18),
                     "equirectangular": (0.03, 0.12),
                     "angular": (0.05, 0.14), "architect": (0.04, 0.20)}
SKY_GOLDEN_SPP = 4
SKY_GOLDEN_TOL = {"sunsky": (0.02, 0.10), "darksky": (0.01, 0.03)}
GLOSSY_GOLDEN_SPP = 64
GLOSSY_SPP, GLOSSY_BOUNCES = 8, 3   # phase 23 at 1920x1080 (cut from 16)
ENV_W, ENV_H = 1024, 512                     # phase 23's environment map
# depth of field on the back boxes (about 2 units along the view axis)
DOF = {"aperture": 0.05, "dof_distance": 2.0}


def _camera_variants():
    """Phase 21's cameras: (label, camera params) for the Cornell box."""
    from libyafaray_tpu_torch.scenes import GOLDEN_CAMERAS
    base = {"from": (0.5, -1.35, 0.5), "to": (0.5, 0.5, 0.5),
            "up": (0.5, -1.35, 1.5), "fov": 39.0}
    out = [(kind, dict(base, **GOLDEN_CAMERAS[kind], type=kind))
           for kind in ("orthographic", "architect", "angular",
                        "equirectangular")]
    out += [(f"perspective, aperture {DOF['aperture']}, {bokeh} bokeh",
             dict(base, type="perspective", bokeh_type=bokeh, **DOF))
            for bokeh in ("disk", "hexagon")]
    return out


def _full_render(phase, label, scene, cfg, spp):
    """`spp` passes of `scene` at its camera's size after one warm-up pass,
    with the kernel counts set to 0 just before and read just after. Prints
    ms a pass, camera rays/s and the launches; returns (image, mt_closest
    launches, tile kernel launches)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import render
    cam = scene.camera
    render(scene, cfg, spp=1)                       # warm-up pass
    torch.cuda.synchronize()
    _zero_launches("mt_closest", "tile_walk")
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=spp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mt, tl = _launches("mt_closest"), _launches("tile_walk")
    img = F.resolve(film).cpu().numpy()
    if img.shape != (cam.resy, cam.resx, 4) or not np.isfinite(img).all():
        raise AssertionError(f"phase {phase}: {label}: bad image, shape "
                             f"{img.shape}, finite {np.isfinite(img).all()}")
    print(f"phase {phase}: {label} {cam.resx}x{cam.resy} {spp} spp: "
          f"{seconds * 1e3 / spp:.2f} ms/pass, "
          f"{cam.resx * cam.resy * spp / seconds:.4g} camera rays/s, "
          f"mt_closest {mt} launches, tile kernel {tl}; image mean "
          f"{float(img[..., :3].mean()):.6f}, alpha mean "
          f"{float(img[..., 3].mean()):.4f}")
    return img, mt, tl


def _golden_errors(img, ref, lit_min, down):
    """(global scale, downsampled mean and p99 relative error) of an image
    against a golden, tests/test_refparity.py's measures."""
    import numpy as np
    scale = img.mean() / ref.mean()
    if down:
        k = 4
        pool = lambda x: x.reshape(x.shape[0] // k, k, x.shape[1] // k, k,
                                   3).mean(axis=(1, 3))
        ref, img = pool(ref), pool(img)
    lit = ref.max(-1) > lit_min
    rel = np.abs(img - ref).max(-1)[lit] / ref.max(-1)[lit]
    return scale, float(rel.mean()), float(np.percentile(rel, 99))


def phase21_cameras():
    """Every camera type and depth of field on the Cornell box: returns the
    mt_closest launches of the 1080p renders."""
    import numpy as np
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.io import load_hdr
    from libyafaray_tpu_torch.scenes import (GOLDEN_CAMERA_FILES,
                                             camera_golden_builder,
                                             cornell_builder)
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    launches = 0
    for label, cam in _camera_variants():
        b = cornell_builder()
        b.create_camera("cam", dict(cam, resx=WIDTH, resy=HEIGHT))
        scene = b.compile("cam")
        if scene.camera.kind != cam["type"] or scene.camera.dof != (
                "aperture" in cam):
            raise AssertionError(f"phase 21: {label} compiled as "
                                 f"{scene.camera.kind}")
        img, mt, tl = _full_render("21", label, scene, cfg, SPP)
        if mt != SPP * (BOUNCES + 1) * 2 or tl:
            raise AssertionError(f"phase 21: {label}: {mt} mt_closest and "
                                 f"{tl} tile kernel launches")
        if not 0.0 < float(img[..., :3].mean()) < LAMP:
            raise AssertionError(f"phase 21: {label}: image mean "
                                 f"{img[..., :3].mean()}")
        launches += mt
        b.create_camera("cam", dict(cam, resx=SMALL, resy=SMALL))
        small = b.compile("cam")
        img_k = F.resolve(render(small, cfg, spp=2)).cpu().numpy()
        with _plain(MT, "mt_closest", MT.mt_closest_ref):
            img_p = F.resolve(render(small, cfg, spp=2)).cpu().numpy()
        print(f"phase 21: {label}, kernel path against plain path:")
        _paths_agree("21", img_k, img_p)
    direct = make_integrator({"type": "directlighting"})
    for kind, name in GOLDEN_CAMERA_FILES.items():
        ref = load_hdr(os.path.join(GOLDEN_DIR, name))[..., :3]
        scene = camera_golden_builder(kind, CAMERA_GOLDEN_RES).compile("cam")
        img = F.resolve(render(scene, direct, spp=CAMERA_GOLDEN_SPP))[
            ..., :3].cpu().numpy() * np.pi
        scale, mean, p99 = _golden_errors(img, ref, 0.03, True)
        tol_mean, tol_p99 = CAMERA_GOLDEN_TOL[kind]
        print(f"phase 21: {kind} {CAMERA_GOLDEN_RES}x{CAMERA_GOLDEN_RES} "
              f"{CAMERA_GOLDEN_SPP} spp directlighting against the libYafaRay "
              f"golden {name}: global scale {scale:.6f}, 4x4-downsampled mean "
              f"relative error {mean:.5f} (bound {tol_mean}), p99 {p99:.5f} "
              f"(bound {tol_p99})")
        if not (np.isfinite(img).all() and abs(scale - 1.0) < 0.01
                and mean < tol_mean and p99 < tol_p99):
            raise AssertionError(f"phase 21: the {kind} camera misses the "
                                 "golden")
    return launches


def phase22_skies():
    """The textured terrain under a sunsky (add_sun, ibl) and a darksky at
    altitude 0; the sky goldens. Returns the tile kernel launches of the
    two renders."""
    import numpy as np
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.io import load_hdr
    from libyafaray_tpu_torch.scenes import (TERRAIN_CAMERA, sky_builder,
                                             sky_terrain_builder)
    cfg = make_integrator({"type": "pathtracing",
                           "bounces": TERRAIN_BOUNCES})
    launches = {}
    for kind in ("sunsky", "darksky"):
        scene = sky_terrain_builder(kind, TERRAIN_GRID).compile("cam")
        lt = scene.lights
        if (scene.background.kind != kind or lt.bg_light_idx < 0
                or lt.num_lights != 2 or scene.accel_kind != "blocks"):
            raise AssertionError(f"phase 22: the {kind} terrain must compile "
                                 "a background light and the sun on blocks")
        img, n, arms = _slice_render("22", scene, TERRAIN_SPP,
                                     TERRAIN_BOUNCES)
        want = TERRAIN_SPP * (TERRAIN_BOUNCES + 1) * 3
        if set(arms) != {"static"} or n != want:
            raise AssertionError(f"phase 22: {kind}: {n} launches {arms}, "
                                 f"want {want} of the static arm")
        # the top row looks past the terrain into the sky
        top = img[0, :, :3]
        print(f"phase 22: {kind}: top row (the sky) mean "
              f"{top.mean(0).round(5).tolist()}, alpha mean "
              f"{float(img[..., 3].mean()):.4f}")
        if img[0, :, 3].any() or not top.min() > 0.0:
            raise AssertionError(f"phase 22: {kind}: the top row is not sky")
        launches[kind] = n
        n_k, busy, ms = _profile_pass(scene, cfg)
        print(f"phase 22: one pass of the {kind} terrain: {n_k} kernel "
              "launches, " + (f"device busy {busy:.2f} ms of {ms:.2f} ms "
                              f"({100 * busy / ms:.1f}%)" if busy > 0 else
                              "device busy not measured (no device time "
                              "traced)"))
        _kernel_vs_plain("22", scene, TERRAIN_CAMERA)
    direct = make_integrator({"type": "directlighting"})
    for kind, (tol_mean, tol_p99) in SKY_GOLDEN_TOL.items():
        name = f"sky_{kind}_128.hdr"
        ref = load_hdr(os.path.join(GOLDEN_DIR, name))[..., :3]
        scene = sky_builder(kind, 128).compile("cam")
        img = F.resolve(render(scene, direct, spp=SKY_GOLDEN_SPP))[
            ..., :3].cpu().numpy()
        # the sky is camera-ray radiance on both sides: no factor pi
        scale, mean, p99 = _golden_errors(img, ref, 0.01, False)
        print(f"phase 22: {kind} 128x128 {SKY_GOLDEN_SPP} spp against the "
              f"libYafaRay golden {name}: global scale {scale:.6f}, mean "
              f"relative error {mean:.5f} (bound {tol_mean}), p99 {p99:.5f} "
              f"(bound {tol_p99})")
        if not (np.isfinite(img).all() and abs(scale - 1.0) < 0.01
                and mean < tol_mean and p99 < tol_p99):
            raise AssertionError(f"phase 22: the {kind} sky misses the "
                                 "golden")
    return launches


def phase23_spheres():
    """The glossy golden scene (an analytic sphere) at 1920x1080 on both
    accelerators, then lit by an environment map with a curve; the glossy
    golden. Returns (mt_closest launches by render, tile kernel
    launches)."""
    import numpy as np
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.io import load_hdr
    from libyafaray_tpu_torch.scenes import (env_glossy_builder,
                                             glossy_golden_builder)
    cfg = make_integrator({"type": "pathtracing", "bounces": GLOSSY_BOUNCES,
                           "russian_roulette_min_bounces": 10})
    per_pass = (GLOSSY_BOUNCES + 1) * 2     # a closest hit and a shadow ray
    images, mt_launches = {}, {}
    tile_launches = 0
    for accel in ("brute", "blocks"):
        b = glossy_golden_builder()
        b.cameras["cam"]["resx"], b.cameras["cam"]["resy"] = WIDTH, HEIGHT
        b.set_render_params({"scene_accelerator": accel})
        scene = b.compile("cam")
        if scene.accel_kind != accel or scene.geom.num_spheres != 1:
            raise AssertionError(f"phase 23: the glossy scene compiled to "
                                 f"{scene.accel_kind}")
        img, mt, tl = _full_render("23", f"glossy sphere scene ({accel})",
                                   scene, cfg, GLOSSY_SPP)
        # the lamp is invisible to camera rays: the camera query is traced
        # again past it (ops/intersect.camera_hit)
        want = GLOSSY_SPP * (per_pass + 1)
        if (accel == "brute" and (mt != want or tl)) or (
                accel == "blocks" and (tl != want or mt)):
            raise AssertionError(f"phase 23: {accel}: {mt} mt_closest and "
                                 f"{tl} tile kernel launches, want {want}")
        images[accel] = img
        if accel == "brute":
            mt_launches["glossy sphere scene"] = mt
        else:
            tile_launches = tl
    print("phase 23: the glossy sphere scene, blocks against brute force:")
    _paths_agree("23", images["blocks"], images["brute"])

    t0 = time.perf_counter()
    b = env_glossy_builder(WIDTH, ENV_W, ENV_H)
    b.cameras["cam"]["resy"] = HEIGHT
    scene = b.compile("cam")
    bg = scene.background
    print(f"phase 23: environment-map scene compiled in "
          f"{time.perf_counter() - t0:.2f} s: env map {bg.env_shape[1]}x"
          f"{bg.env_shape[0]}, importance tables max pdf "
          f"{float(bg.env_pdf.max()):.4g}, median "
          f"{float(bg.env_pdf.median()):.4g}; {scene.geom.num_faces} "
          f"triangles ({scene.geom.num_faces - 6} of the curve)")
    if bg.kind != "texture" or bg.env_shape != (ENV_H, ENV_W) or (
            scene.lights.bg_light_idx < 0 or scene.geom.num_faces <= 6):
        raise AssertionError("phase 23: the environment-map scene must "
                             "compile its importance tables, its background "
                             "light and the curve's ribbon")
    img, mt, tl = _full_render("23", "environment-map scene with a curve",
                               scene, cfg, GLOSSY_SPP)
    if mt != GLOSSY_SPP * per_pass or tl:
        raise AssertionError(f"phase 23: environment map: {mt} mt_closest "
                             f"and {tl} tile kernel launches")
    mt_launches["environment-map scene"] = mt
    # the floor under the open sky is lit
    floor = float(img[-HEIGHT // 8:, :, :3].mean())
    print(f"phase 23: environment-map scene: floor band mean {floor:.6f}")
    if not floor > 0.05:
        raise AssertionError("phase 23: the environment map does not light "
                             "the floor")
    small = env_glossy_builder(PATHS_RES, ENV_W, ENV_H).compile("cam")
    img_k = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        img_p = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
    print("phase 23: environment-map scene, kernel path against plain path:")
    _paths_agree("23", img_k, img_p)

    ref = load_hdr(os.path.join(GOLDEN_DIR, "glossy_ref_128.hdr"))[..., :3]
    scene = glossy_golden_builder(128).compile("cam")
    img = F.resolve(render(scene, cfg, spp=GLOSSY_GOLDEN_SPP))[
        ..., :3].cpu().numpy() * np.pi
    scale = img.mean() / ref.mean()
    # tests/test_refparity.py's regions and bounds
    regions = {"backwall": (np.s_[10:40], 0.05), "floor": (np.s_[95:125], 0.05),
               "sphere": (np.s_[58:82, 40:88], 0.12)}
    ratios = {k: float(img[sl].mean() / ref[sl].mean())
              for k, (sl, _) in regions.items()}
    cc = float(np.corrcoef(img[100:120, :, 0].mean(0),
                           ref[100:120, :, 0].mean(0))[0, 1])
    print(f"phase 23: glossy 128x128 {GLOSSY_GOLDEN_SPP} spp against the "
          f"libYafaRay golden glossy_ref_128.hdr: global scale {scale:.6f} "
          f"(bound 0.08), region ratios "
          f"{ {k: round(v, 5) for k, v in ratios.items()} } (bounds 0.05, "
          f"0.05, 0.12), floor profile correlation {cc:.5f} (> 0.98)")
    if not (np.isfinite(img).all() and abs(scale - 1.0) < 0.08 and cc > 0.98
            and all(abs(ratios[k] - 1.0) < tol
                    for k, (_, tol) in regions.items())):
        raise AssertionError("phase 23: the glossy scene misses the golden")
    return mt_launches, tile_launches


# ------------------------------------------------------- phases 24 and 25

# the materials Cornell box and the portal room: 2 of the 16-spp image's
# passes (a pass is measured the same way; the script's time made room
# for phases 26-30)
MATS_SPP = 2
# the materials box's forward + backward: 1 spp of the 16-spp image keeps
# the script in its time (a 16-spp image took 283.3 s in chunks of 270
# rows on the H100: the walk's eager ops make each chunk launch-bound)
MATS_GRAD_SPP = 1
MATS_LIGHTS = 5          # lamp, spot, IES, sphere and directional
SHADOW_DEPTH = 4         # transpShad's default shadowDepth
# the gradient columns of tests/test_torch_materials_slice.py that the
# materials Cornell box reads: the coated glossy's colour, the Oren-Nayar
# sigma, the light colours and the dispersive slab's absorption (its blend
# takes its factor from a texture node, so the blend_value column is not
# read here)
MATS_GRADS = ("materials.glossy_color", "materials.sigma", "lights.color",
              "materials.absorption")


@contextlib.contextmanager
def _mt_classified():
    """Inside the context every mt_closest call is classified as it
    launches (the first of a pass the camera query, then closest-hit
    bounces, and shadow-visibility queries: the transparent walk) and timed
    by CUDA events beside its bound (mt_bound); the yielded dict fills as
    the work runs. Nothing is cloned."""
    import torch
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    real = MT.mt_closest
    rec = dict(kinds=[], events=[], bounds=[])

    def classified(*a, **k):
        e = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = real(*a, **k)
        e[1].record()
        rec["events"].append(e)
        rec["kinds"].append("shadow walk" if k.get("shadow") else
                            "camera" if not rec["kinds"] else "bounce")
        rec["bounds"].append(mt_bound(a, k))
        return out

    MT.mt_closest = classified
    try:
        yield rec
    finally:
        MT.mt_closest = real


def _mats_scene(accel, width=None, height=None):
    """The materials Cornell box on `accel` (1920x1080 by default)."""
    from libyafaray_tpu_torch.scenes import materials_cornell_builder
    b = materials_cornell_builder(width or WIDTH, height or HEIGHT)
    b.set_render_params({"scene_accelerator": accel})
    scene = b.compile("cam")
    if scene.accel_kind != accel:
        raise AssertionError(f"the materials Cornell box compiled to "
                             f"{scene.accel_kind}, not {accel}")
    return scene


def _bit_for_bit(phase, label, img_k, img_p):
    import numpy as np
    diff = float(np.abs(img_k - img_p).max())
    print(f"phase {phase}: {label} {img_k.shape[1]}x{img_k.shape[0]}, "
          f"kernel path against plain path: max |diff| {diff:.3g}")
    if not np.isfinite(img_k).all() or diff != 0.0:
        raise AssertionError(f"phase {phase}: {label}: the kernel path is "
                             "not the plain path bit for bit")


def phase24_materials():
    """The materials Cornell box (every material and light type) at
    1920x1080: forward on brute force and on blocks, kernel against plain
    paths at 128x128, forward + backward in chunks, and captured
    closest-shadow queries of the transparent walk against both plain
    versions. Returns (mt_closest launches, tiles_traverse launches,
    per-launch numbers of the captured walk queries)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.scenes import MATERIALS_INTEGRATOR
    cfg = make_integrator(MATERIALS_INTEGRATOR)
    if cfg.transparent_shadows != SHADOW_DEPTH:
        raise AssertionError("phase 24: transpShad at its default depth")
    depths = BOUNCES + 1
    walk = MATS_LIGHTS * (SHADOW_DEPTH + 1)
    per_pass = depths + depths * walk     # closest queries + walk steps
    scene = _mats_scene("brute")
    m = scene.materials
    lt = scene.lights
    print(f"phase 24: materials Cornell box: {scene.geom.num_faces} "
          f"triangles, material types {m.present_types}, light types "
          f"{lt.present_types}, {lt.num_lights} lights; Oren-Nayar "
          f"{m.has_oren}, blend {m.has_blend}, mask {m.has_mask}, dispersion "
          f"{m.has_dispersion}, Beer {m.has_beer}, sss {m.has_sss}; node "
          f"bindings {scene.nodes.bound}")
    # every material type but plain glossy and light_mat (ported before)
    if lt.num_lights != MATS_LIGHTS or m.present_types != (
            0, 2, 3, 4, 5, 6, 8, 9):
        raise AssertionError("phase 24: the scene lacks a type")
    torch.cuda.reset_peak_memory_stats()
    img, mt, tl = _full_render("24", "materials Cornell box (brute force)",
                               scene, cfg, MATS_SPP)
    peak = torch.cuda.max_memory_allocated()
    if mt != MATS_SPP * per_pass or tl:
        raise AssertionError(f"phase 24: {mt} mt_closest and {tl} tile "
                             f"launches, want {MATS_SPP * per_pass} and 0")
    # the walls: red-dominant left (Oren-Nayar), green-dominant right
    band = WIDTH * 12 // 64
    left = img[:, :band, :3].reshape(-1, 3).mean(0)
    right = img[:, -band:, :3].reshape(-1, 3).mean(0)
    print(f"phase 24: walls left {left.round(4).tolist()} right "
          f"{right.round(4).tolist()}; peak device memory "
          f"{peak / 2**30:.3f} GiB")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError("phase 24: the walls' colours are wrong")

    # one pass instrumented: each launch by kind, its time and its bound
    with _mt_classified() as rec:
        pass_ev = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
        pass_ev[0].record()
        render(scene, cfg, spp=1, start_sample=MATS_SPP)
        pass_ev[1].record()
        torch.cuda.synchronize()
    pass_ms = pass_ev[0].elapsed_time(pass_ev[1])
    by_kind = {}
    for kind, (a, z), (_, _, bound, _) in zip(rec["kinds"], rec["events"],
                                               rec["bounds"]):
        k = by_kind.setdefault(kind, [0, 0.0, 0.0])
        k[0] += 1
        k[1] += a.elapsed_time(z)
        k[2] += bound
    kernel_ms = sum(k[1] for k in by_kind.values())
    print(f"phase 24: one instrumented pass {pass_ms:.2f} ms, mt_closest "
          f"{kernel_ms:.2f} ms of it ({100 * kernel_ms / pass_ms:.1f}%): "
          + "; ".join(f"{kind} {n} launches, {ms:.3f} ms (bound {b:.4f} ms, "
                      f"at {100 * b / max(ms, 1e-9):.1f}% of it)"
                      for kind, (n, ms, b) in by_kind.items()))
    if [by_kind.get(k, [0])[0] for k in ("camera", "bounce", "shadow walk")
        ] != [1, BOUNCES, depths * walk]:
        raise AssertionError(f"phase 24: launches by kind {by_kind}")
    n_k, busy, ms = _profile_pass(scene, cfg)
    print(f"phase 24: one pass profiled: {n_k} kernel launches, "
          + (f"device busy {busy:.2f} ms of {ms:.2f} ms "
             f"({100 * busy / ms:.1f}%)" if busy > 0 else
             "device busy not measured (no device time traced)"))

    # blocks: kernel b on every query, the image within the slice bound
    blocks = _mats_scene("blocks")
    img_b, mt_b, tl_b = _full_render(
        "24", "materials Cornell box (blocks)", blocks, cfg, MATS_SPP)
    if tl_b != MATS_SPP * per_pass or mt_b:
        raise AssertionError(f"phase 24: blocks: {mt_b} mt_closest and "
                             f"{tl_b} tile launches")
    print("phase 24: blocks against brute force:")
    _paths_agree("24", img_b, img)

    # kernel paths against plain paths at 128x128
    for accel, module, name, ref in (
            ("brute", MT, "mt_closest", MT.mt_closest_ref),
            ("blocks", TL, "tile_walk", TL.tile_walk_ref)):
        small = _mats_scene(accel, PATHS_RES, PATHS_RES)
        img_k = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
        with _plain(module, name, ref):
            img_p = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
        if accel == "brute":
            _bit_for_bit("24", "brute force", img_k, img_p)
        else:
            print("phase 24: blocks, kernel path against plain path:")
            _paths_agree("24", img_k, img_p)

    # captured closest-shadow queries, held against the plain versions:
    # at depth 0 the first two steps of the lamp's and the spot's walks and
    # the first of the IES, sphere and directional lights' (launches 1, 2,
    # 6, 7, 11, 16, 21 of a pass), at depth 1 the lamp's first (after the
    # pass's second closest hit)
    keep = {1, 2, 6, 7, 11, 16, 21, 2 + walk}
    with _kept_calls(MT, "mt_closest", keep) as calls:
        render(scene, cfg, spp=1, start_sample=MATS_SPP + 1)
    if not all(k.get("shadow") for _, k, _ in calls):
        raise AssertionError("phase 24: a kept query is not a shadow query")
    per_launch = _hold_queries("24", calls, [
        f"walk query at launch {i}" for i in sorted(keep)])
    with _kept_calls(TL, "tile_walk", keep) as walks:
        render(blocks, cfg, spp=1, start_sample=MATS_SPP + 1)
    tl_err = 0.0
    for i, (a, k, _) in zip(sorted(keep), walks):
        if not k.get("shadow") or k.get("any_hit"):
            raise AssertionError("phase 24: a kept walk is not a closest "
                                 "shadow query")
        n = a[0].shape[0]
        _, tl_err = _walk_case(f"walk query at launch {i}", (n,) + a[:4],
                               a[4], {key: x for key, x in k.items()},
                               tl_err, phase="24")

    # forward + backward at 1080p in chunks of 270 rows
    _check_fp32_precision()
    sc, leaves = _leaf_scene(scene, list(MATS_GRADS))
    chunks = [_pixels(WIDTH, r, min(r + CHUNK_ROWS, HEIGHT), DEVICE)
              for r in range(0, HEIGHT, CHUNK_ROWS)]
    _fwd_bwd(sc, cfg, leaves, chunks[0], 0)             # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches("mt_closest")
    total = [torch.zeros_like(x) for x in leaves]
    t0 = time.perf_counter()
    for s in range(MATS_GRAD_SPP):
        for ch in chunks:
            for t, g in zip(total, _fwd_bwd(sc, cfg, leaves, ch, s)):
                t += g
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    grad_launches = _launches("mt_closest")
    grads = [t.cpu().numpy() for t in total]
    print(f"phase 24: forward + backward {WIDTH}x{HEIGHT} {MATS_GRAD_SPP} "
          f"spp in {len(chunks)} chunks of {CHUNK_ROWS} rows wrt "
          f"{', '.join(MATS_GRADS)}: {seconds * 1e3:.2f} ms, "
          f"{seconds * 1e3 / MATS_GRAD_SPP:.2f} ms per spp pass, mt_closest "
          f"{grad_launches} launches, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"gradient max |g| "
          f"{[float(np.abs(g).max()) for g in grads]}")
    if grad_launches != MATS_GRAD_SPP * len(chunks) * per_pass or not all(
            np.isfinite(g).all() and np.abs(g).max() > 0 for g in grads):
        raise AssertionError("phase 24: the gradients or their launches")
    small = _mats_scene("brute", PATHS_RES, PATHS_RES)
    got = _image_grads(small, cfg, list(MATS_GRADS), 1)
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        want = _image_grads(small, cfg, list(MATS_GRADS), 1)
    _grads_agree("24", MATS_GRADS, got, want, GRAD_RTOL)
    return dict(forward=mt, forward_blocks=tl_b, grads=grad_launches), \
        per_launch, tl_err


def phase25_portal():
    """The portal room at 1920x1080, MATS_SPP spp; kernel path against plain
    path at 128x128. Returns mt_closest's launches."""
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.scene_types import LIGHT_BGPORTAL
    from libyafaray_tpu_torch.scenes import portal_room_builder
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    scene = portal_room_builder().compile("cam")
    if scene.lights.present_types != (LIGHT_BGPORTAL,):
        raise AssertionError("phase 25: the room must be lit by its portal")
    img, mt, tl = _full_render("25", "portal room", scene, cfg, MATS_SPP)
    if mt != MATS_SPP * (BOUNCES + 1) * 2 or tl:
        raise AssertionError(f"phase 25: {mt} mt_closest and {tl} tile "
                             "launches")
    # lit only through the window: the floor band under it
    floor = float(img[-HEIGHT // 6:, WIDTH // 3: 2 * WIDTH // 3, :3].mean())
    print(f"phase 25: floor under the window mean {floor:.6f}")
    if not floor > 0.05:
        raise AssertionError("phase 25: the portal does not light the room")
    small = portal_room_builder(PATHS_RES, PATHS_RES).compile("cam")
    img_k = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        img_p = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
    _bit_for_bit("25", "portal room", img_k, img_p)
    return mt


# ------------------------------------------------------- phases 26 and 27

PROC_SPP = 2             # the procedural Cornell box (cut from 16, 8, 4)


def _texture_path_ms(scene, cfg):
    """(kernel launches, device busy ms, ms, the node program's ms) of one
    pass of `scene`: the launches and busy time from the profiler and the
    ms from an unprofiled pass (`_profile_pass`), and the node program's
    share (the texture path: texture coordinates, noise, procedural types,
    ramps) from CUDA events around each of its runs in one more pass."""
    import torch
    from libyafaray_tpu_torch import render
    from libyafaray_tpu_torch.materials import node_eval as NE
    n_k, busy, ms = _profile_pass(scene, cfg)
    real, events = NE.run_program, []

    def timed(*a, **k):
        e = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = real(*a, **k)
        e[1].record()
        events.append(e)
        return out

    NE.run_program = timed
    try:
        render(scene, cfg, spp=1, start_sample=1)
        torch.cuda.synchronize()
    finally:
        NE.run_program = real
    return n_k, busy, ms, sum(a.elapsed_time(z) for a, z in events), \
        len(events)


def _proc_scene(accel, width=None, height=None):
    """The procedural Cornell box on `accel` (1920x1080 by default)."""
    from libyafaray_tpu_torch.scenes import procedural_cornell_builder
    b = procedural_cornell_builder(width or WIDTH, height or HEIGHT)
    b.set_render_params({"scene_accelerator": accel})
    scene = b.compile("cam")
    if scene.accel_kind != accel:
        raise AssertionError(f"the procedural Cornell box compiled to "
                             f"{scene.accel_kind}, not {accel}")
    return scene


def phase26_procedural():
    """The procedural Cornell box (every procedural texture type, three
    noise bases, a colour ramp, bump through clouds, orco coordinates
    streamed and not) at 1920x1080, 4 spp, 4 bounces on brute force and
    on blocks; kernel against plain paths at 128x128. Returns the
    mt_closest and tiles_traverse launches of the two renders."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.accel import tiles as TL
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    per_pass = 2 * (BOUNCES + 1)     # a closest and a shadow query a depth
    scene = _proc_scene("brute")
    tp = scene.textures
    print(f"phase 26: procedural Cornell box: {scene.geom.num_faces} "
          f"triangles, texture types {tp.used_types}, noise bases "
          f"{tp.used_noise}, up to {tp.max_octaves} octaves, "
          f"{scene.nodes.num_nodes} nodes (bump reads "
          f"{scene.nodes.bump_nodes}), orco table "
          f"{tuple(scene.geom.orcos.shape)}")
    if tp.used_types != tuple(range(1, 9)) or len(tp.used_noise) < 3:
        raise AssertionError("phase 26: the scene lacks a type or a basis")
    torch.cuda.reset_peak_memory_stats()
    img, mt, tl = _full_render("26", "procedural Cornell box (brute force)",
                               scene, cfg, PROC_SPP)
    peak = torch.cuda.max_memory_allocated()
    if mt != PROC_SPP * per_pass or tl:
        raise AssertionError(f"phase 26: {mt} mt_closest and {tl} tile "
                             f"launches, want {PROC_SPP * per_pass} and 0")
    band = WIDTH * 12 // 64
    left = img[:, :band, :3].reshape(-1, 3).mean(0)
    right = img[:, -band:, :3].reshape(-1, 3).mean(0)
    spread = float(img[..., :3].std())
    print(f"phase 26: walls left {left.round(4).tolist()} right "
          f"{right.round(4).tolist()}, image std {spread:.4f}; peak device "
          f"memory {peak / 2**30:.3f} GiB")
    if not (left[0] > left[1] and right[1] > right[0] and spread > 0.02):
        raise AssertionError("phase 26: the walls' colours are wrong")
    n_k, busy, ms, tex_ms, runs = _texture_path_ms(scene, cfg)
    print(f"phase 26: one pass profiled: {n_k} kernel launches, "
          + (f"device busy {busy:.2f} ms of {ms:.2f} ms "
             f"({100 * busy / ms:.1f}%)" if busy > 0 else
             "device busy not measured (no device time traced)")
          + f"; the texture path, {runs} node-program runs a pass, "
          f"{tex_ms:.2f} ms of a pass by CUDA events")

    blocks = _proc_scene("blocks")
    img_b, mt_b, tl_b = _full_render(
        "26", "procedural Cornell box (blocks)", blocks, cfg, PROC_SPP)
    if tl_b != PROC_SPP * per_pass or mt_b:
        raise AssertionError(f"phase 26: blocks: {mt_b} mt_closest and "
                             f"{tl_b} tile launches")
    print("phase 26: blocks against brute force:")
    _paths_agree("26", img_b, img)

    for accel, module, name, ref in (
            ("brute", MT, "mt_closest", MT.mt_closest_ref),
            ("blocks", TL, "tile_walk", TL.tile_walk_ref)):
        small = _proc_scene(accel, PATHS_RES, PATHS_RES)
        img_k = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
        with _plain(module, name, ref):
            img_p = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
        if accel == "brute":
            _bit_for_bit("26", "brute force", img_k, img_p)
        else:
            print("phase 26: blocks, kernel path against plain path:")
            _paths_agree("26", img_k, img_p)
    return dict(brute=mt, blocks=tl_b)


SKY_PM = {"type": "directlighting", "volume_integrator": "SkyIntegrator",
          "alpha": 0.5, "turbidity": 3.0, "sigma_t": 0.4}
# phase 27's runs: (label, region kind or None for the sky integrator's
# Cornell box, integrator params)
VOLUME_RUNS = (
    ("exp", "exp", {}), ("noise", "noise", {}), ("grid", "grid", {}),
    ("sky region", "sky", {}),
    ("exp, optimize", "exp", {"optimize": True}),
    ("noise, optimize", "noise", {"optimize": True}),
    ("grid, adaptive", "grid", {"adaptive": True}),
    ("noise, EmissionIntegrator", "noise",
     {"volume_integrator": "EmissionIntegrator"}),
    ("Cornell box, SkyIntegrator", None, SKY_PM))
VOLUME_EMIT = 0.5        # the emission run's region emits (l_e)
REGIONS_SPP = 1          # phase 27's passes a run (cut from 8, 4, 2)
# the runs whose in-medium shadow queries of one pass are held against
# mt_closest_ref (the noise region's pass costs most, its queries are the
# same kind)
HELD_RUNS = ("exp", "grid", "sky region")


def _volume_run_scene(kind, res, emit=0.0):
    from libyafaray_tpu_torch.scenes import (cornell_builder,
                                             volume_regions_builder)
    if kind is not None:
        return volume_regions_builder(kind, res, emit=emit).compile("cam")
    b = cornell_builder()
    b.create_background({"type": "constant", "color": (2.0, 2.0, 2.5)})
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = res
    return b.compile("cam")


def phase27_volumes():
    """Every volume region type and volume-integrator arm at 512x512, 2 spp,
    3 bounces through `render`: ms a pass, mt_closest launches a pass, the
    volume visible against the same scene without it, kernel path against
    plain path at 128x128; the attenuation grid's build; the in-medium
    shadow queries of one pass of the exponential, grid and sky regions
    held bit for bit against mt_closest_ref. Returns (launches by run, per-launch numbers of
    the held queries)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.integrators import volume as VI
    launches, calls_all, labels_all = {}, [], []
    for label, kind, extra in VOLUME_RUNS:
        pm = dict({"type": "pathtracing", "bounces": VOLUME_BOUNCES}, **extra)
        cfg = make_integrator(pm)
        emit = VOLUME_EMIT if cfg.vol_kind == "emission" else 0.0
        scene = _volume_run_scene(kind, VOLUME_RES, emit)
        if cfg.vol_optimize:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grid = VI.build_attenuation_grid(scene)
            torch.cuda.synchronize()
            print(f"phase 27: {label}: the attenuation grid "
                  f"{tuple(grid.atten.shape)} built in "
                  f"{(time.perf_counter() - t0) * 1e3:.2f} ms (render "
                  "builds it once per call)")
        img, mt, tl = _full_render("27", label, scene, cfg, REGIONS_SPP)
        launches[label] = mt
        lights = scene.lights.num_lights
        want = None
        if cfg.kind == "pathtracing":
            want = (VOLUME_BOUNCES + 1) * (1 + lights) + (
                cfg.vol_steps if cfg.vol_kind == "single_scatter" else 0)
        if tl or (want is not None and mt != REGIONS_SPP * want) or not mt:
            raise AssertionError(f"phase 27: {label}: {mt} mt_closest and "
                                 f"{tl} tile launches, want "
                                 f"{REGIONS_SPP} x {want}")
        clear = F.resolve(render(dataclasses.replace(scene, volumes=None),
                                 make_integrator(dict(
                                     pm, volume_integrator="none")),
                                 spp=REGIONS_SPP)).cpu().numpy()
        diff = np.abs(img - clear)[..., :3].max(-1)
        changed = [float((diff > t).mean()) for t in (1e-4, 1e-6)]
        print(f"phase 27: {label}: image mean {float(img[..., :3].mean()):.6f}"
              f" against {float(clear[..., :3].mean()):.6f} without the "
              f"volume; {100 * changed[0]:.2f}% of pixels changed by more "
              f"than 1e-4, {100 * changed[1]:.2f}% by more than 1e-6")
        # the sky's atmosphere is thin at the box's scale: its share is
        # small, but on every pixel
        if changed[1] < 0.5 or (kind is not None and changed[0] < 0.5):
            raise AssertionError(f"phase 27: {label}: the volume is not "
                                 "visible")
        if label == "grid":
            n_k, busy, ms = _profile_pass(scene, cfg)
            print(f"phase 27: {label}: one pass profiled: {n_k} kernel "
                  f"launches, device busy {busy:.2f} of {ms:.2f} ms "
                  f"({100 * busy / max(ms, 1e-9):.1f}%)")
        if label in HELD_RUNS:
            # one pass's in-medium shadow queries (the last vol_steps)
            with _mt_captured() as (calls, _):
                render(scene, cfg, spp=1, start_sample=REGIONS_SPP)
                torch.cuda.synchronize()
            medium = calls[-cfg.vol_steps:]
            if not all(k.get("shadow") for _, k, _ in medium):
                raise AssertionError("phase 27: an in-scatter query is not "
                                     "a shadow query")
            calls_all += medium
            labels_all += [f"{label} in-scatter step {i}"
                           for i in range(cfg.vol_steps)]
        small = _volume_run_scene(kind, PATHS_RES, emit)
        img_k = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
        with _plain(MT, "mt_closest", MT.mt_closest_ref):
            img_p = F.resolve(render(small, cfg, spp=1)).cpu().numpy()
        _paths_agree("27", img_k, img_p)
    per_launch = _hold_queries("27", calls_all, labels_all)
    return launches, per_launch


# ------------------------------------------------------------- phase 28

# the AOV render: two or more layers of each kind (first-hit, accumulated,
# flush), adaptive AA and the Gauss filter as libYafaRay's clients set them
AOV_LAYERS = ("combined", "normal-geom", "z-depth-abs", "albedo", "uv",
              "mat-index-auto", "debug-wireframe", "env", "shadow",
              "indirect", "diffuse", "diffuse-indirect", "reflect",
              "mat-index-mask-all", "debug-aa-samples", "toon",
              "debug-faces-edges")
AOV_AA = dict(aa_samples=4, aa_passes=4, aa_inc_samples=2, threshold=0.05,
              dark_detection_type="curve")
# the curve's thresholds on the dark box flag every pixel at 4 spp, so its
# compacted wavefronts hold the whole image; the flat threshold flags a
# fifth of it
AOV_AA_FLAT = dict(AOV_AA, dark_detection_type="none")
AOV_FILTER = dict(flt_kind="gauss", flt_width=1.5)
AO_SAMPLES = 8
AOV_PER_LAUNCH = {"ao": "the ambient-occlusion shadow queries of one pass",
                  "compacted": "the queries of the first compacted adaptive "
                               "sample"}
AOV_SMALL = 256          # kernel path against plain path


def _render_module():
    """The port's render module (the package exports its function under the
    same name)."""
    import importlib
    return importlib.import_module("libyafaray_tpu_torch.render")


def _cornell_builder(width, height, accel=None):
    from libyafaray_tpu_torch.scenes import cornell_builder
    b = cornell_builder()
    b.cameras["cam"]["resx"] = width
    b.cameras["cam"]["resy"] = height
    if accel is not None:
        b.set_render_params({"scene_accelerator": accel})
    return b


def _cornell(accel, width, height):
    scene = _cornell_builder(width, height,
                             "blocks" if accel == "blocks" else None
                             ).compile("cam")
    if scene.accel_kind != accel:
        raise AssertionError(f"the Cornell box compiled to "
                             f"{scene.accel_kind}, not {accel}")
    return scene


@contextlib.contextmanager
def _passes_logged():
    """Inside, every pass of `render` is logged in order as a dict: the
    full and compacted sample passes with their lanes and ms
    (host clock between synchronisations), and each noise detection with
    its flagged fraction. `state["kind"]` names the pass under way."""
    import torch
    R = _render_module()
    log, state = [], {"kind": None}
    real_full, real_ids, real_mask = (R.render_pass_fn, R._render_ids,
                                      R.compute_resample_mask)

    def timed(kind, lanes, sample, fn, *a):
        state["kind"] = kind
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        log.append(dict(kind=kind, lanes=lanes, sample=sample,
                        ms=(time.perf_counter() - t0) * 1e3))
        state["kind"] = None
        return out

    def full(scene, cfg, film, s):
        return timed("full", film.width * film.height, s, real_full, scene,
                     cfg, film, s)

    def ids(scene, cfg, film, s, pixel_id, live):
        if state["kind"] is not None:        # inside a full pass
            return real_ids(scene, cfg, film, s, pixel_id, live)
        return timed("compacted", pixel_id.numel(), s, real_ids, scene, cfg,
                     film, s, pixel_id, live)

    def mask(film, aa):
        m = real_mask(film, aa)
        log.append(dict(kind="mask", flagged=float(m.mean())))
        return m

    R.render_pass_fn, R._render_ids, R.compute_resample_mask = full, ids, mask
    try:
        yield log, state
    finally:
        R.render_pass_fn, R._render_ids, R.compute_resample_mask = (
            real_full, real_ids, real_mask)


def _print_passes(label, log):
    """One line per pass of a logged render."""
    flagged = None
    for e in log:
        if e["kind"] == "mask":
            flagged = e["flagged"]
            continue
        extra = ("" if e["kind"] == "full" else
                 f", {100 * flagged:.2f}% flagged")
        print(f"phase 28: {label}: sample {e['sample']} {e['kind']} pass: "
              f"{e['lanes']} lanes, {e['ms']:.2f} ms{extra}")


@contextlib.contextmanager
def _queries_timed(state, keep=lambda tag: False):
    """Inside, every mt_closest and tile_walk call is timed by CUDA events
    and tagged with the pass under way (`state`, from `_passes_logged`) and
    whether ambient occlusion issued it; its live rays and bound are kept as
    device tensors and read after the work (no synchronisation in the
    pass). Calls whose tag `keep` accepts are also kept whole, as
    `_mt_captured` keeps them. Yields the list of records."""
    import torch
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.integrators import mc
    real_mt, real_walk, real_ao = (MT.mt_closest, TL.tile_walk,
                                   mc._sample_ambient_occlusion)
    recs, ao = [], {"on": False}
    copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x

    def events():
        e = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
        e[0].record()
        return e

    def mt(*a, **k):
        e = events()
        out = real_mt(*a, **k)
        e[1].record()
        tab, o, d, t_min, t_max, excl = a
        tag = (state["kind"], ao["on"])
        rec = dict(kernel="mt_closest", tag=tag, events=e, rays=o.shape[0],
                   live=(t_max > t_min).sum(),
                   rows=(tab[:, 10 if k.get("shadow") else 9] > 0.5).sum(),
                   nbytes=_nbytes(*a) + 16 * o.shape[0])
        if keep(tag):
            rec["call"] = (tuple(copy(x) for x in a),
                           {key: copy(x) for key, x in k.items()},
                           tuple(x.clone() for x in out))
        recs.append(rec)
        return out

    def walk(*a, **k):
        e = events()
        out = real_walk(*a, **k)
        e[1].record()
        rays, cand, ent, count, tab = a
        need = _needed(cand, ent, count, out, bool(k.get("any_hit")))
        tabs = [x for x in k.values() if isinstance(x, torch.Tensor)]
        tag = (state["kind"], ao["on"])
        rec = dict(kernel="tile_walk", tag=tag, events=e,
                   rays=rays.shape[0], live=(rays[:, 7] > rays[:, 6]).sum(),
                   pairs=need.sum() * TL.RAY_TILE * tab.shape[2],
                   nbytes=_nbytes(*a, *tabs) + 16 * rays.shape[0])
        if keep(tag):
            rec["call"] = (tuple(copy(x) for x in a),
                           {key: copy(x) for key, x in k.items()},
                           tuple(x.clone() for x in out))
        recs.append(rec)
        return out

    def ao_term(*a, **k):
        ao["on"] = True
        try:
            return real_ao(*a, **k)
        finally:
            ao["on"] = False

    MT.mt_closest, TL.tile_walk, mc._sample_ambient_occlusion = mt, walk, \
        ao_term
    try:
        yield recs
    finally:
        MT.mt_closest, TL.tile_walk, mc._sample_ambient_occlusion = (
            real_mt, real_walk, real_ao)


def _query_rows(recs):
    """The timed queries with their live rays, ms, bound and what bounds it
    (read after the work)."""
    import torch
    torch.cuda.synchronize()
    out = []
    for r in recs:
        live = int(r["live"])
        if r["kernel"] == "mt_closest":
            flops = live * int(r["rows"]) * FLOPS_PER_PAIR
        else:
            flops = int(r["pairs"]) * FLOPS_PER_PAIR
        bound, by = _bound_ms(flops, r["nbytes"])
        out.append(dict(r, live=live, ms=r["events"][0].elapsed_time(
            r["events"][1]), bound=bound, by=by))
    return out


def _print_queries(label, rows):
    """Per pass kind: the launches, their live rays, device ms and bound;
    and one line per launch of the first pass of each kind."""
    seen = set()
    for kind in ("full", "compacted"):
        for ao in (False, True):
            sel = [r for r in rows if r["tag"] == (kind, ao)]
            if not sel:
                continue
            name = f"{kind} passes" + (", ambient occlusion" if ao else "")
            ms = sum(r["ms"] for r in sel)
            bound = sum(r["bound"] for r in sel)
            print(f"phase 28: {label}: {name}: {len(sel)} {sel[0]['kernel']} "
                  f"launches, live rays {min(r['live'] for r in sel)}-"
                  f"{max(r['live'] for r in sel)} of {sel[0]['rays']}-"
                  f"{max(r['rays'] for r in sel)}, {ms:.3f} ms, bound "
                  f"{bound:.4f} ms ({100 * bound / max(ms, 1e-9):.1f}% of "
                  "it)")
            if (kind, ao) in seen:
                continue
            seen.add((kind, ao))
            first = sel[:AO_SAMPLES if ao else 2 * (BOUNCES + 1)]
            for i, r in enumerate(first):
                print(f"phase 28: {label}: {name}, launch {i}: {r['rays']} "
                      f"rays, {r['live']} live, {r['ms']:.4f} ms, bound "
                      f"{r['bound']:.4f} ms ({r['by']})")


def _aov_images(film, label):
    """Every layer of the film resolved on the host, checked finite and of
    its shape."""
    import numpy as np
    from libyafaray_tpu_torch import film as F
    out = {}
    for name in film.layers:
        img = F.resolve(film, name).cpu().numpy()
        c = F.LAYER_CHANNELS[name]
        if img.shape != (film.height, film.width, c) or \
                not np.isfinite(img).all():
            raise AssertionError(f"phase 28: {label}: layer {name}: shape "
                                 f"{img.shape}, finite "
                                 f"{np.isfinite(img).all()}")
        out[name] = img
    return out


def _aov_render(accel, aa_params=AOV_AA):
    """The adaptive AOV render of the Cornell box at 1920x1080 on `accel`
    through `render` with no device argument, with the kernel counts set
    to 0 just before and read just after. Returns (images, mt_closest
    launches, tile kernel launches, the passes' log)."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import make_integrator, render
    R = _render_module()
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    scene = _cornell(accel, WIDTH, HEIGHT)
    render(scene, cfg, spp=1, layer_names=AOV_LAYERS,        # warm-up
           **AOV_FILTER)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    label = (f"AOV render ({accel}, dark detection "
             f"{aa_params['dark_detection_type']})")
    _zero_launches("mt_closest", "tile_walk")
    with _passes_logged() as (log, _):
        t0 = time.perf_counter()
        film = render(scene, cfg, aa=R.AAParams(**aa_params),
                      layer_names=AOV_LAYERS, **AOV_FILTER)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    mt, tl = _launches("mt_closest"), _launches("tile_walk")
    peak = torch.cuda.max_memory_allocated()
    passes = [e for e in log if e["kind"] != "mask"]
    samples = len(passes)
    per = 2 * (BOUNCES + 1)
    want = (samples * per, 0) if accel == "brute" else (0, samples * per)
    if (mt, tl) != want:
        raise AssertionError(f"phase 28: {label}: {mt} mt_closest and {tl} "
                             f"tile launches, want {want}")
    _print_passes(label, log)
    imgs = _aov_images(film, label)
    img = imgs["combined"][..., :3]
    band = WIDTH * 12 // 64
    left = img[:, :band].reshape(-1, 3).mean(0)
    right = img[:, -band:].reshape(-1, 3).mean(0)
    spp = imgs["debug-aa-samples"]
    print(f"phase 28: {label} {WIDTH}x{HEIGHT}, {len(AOV_LAYERS)} layers, "
          f"gauss 1.5: {samples} sample passes in {seconds:.3f} s "
          f"({seconds * 1e3 / samples:.2f} ms a pass), mt_closest {mt} "
          f"launches, tile kernel {tl}; filter weight per pixel "
          f"{float(spp.min()):.3f}-{float(spp.max()):.3f}; walls left "
          f"{left.round(4).tolist()} right {right.round(4).tolist()}; peak "
          f"device memory {peak / 2**30:.3f} GiB")
    if not (left[0] > left[1] and right[1] > right[0]):
        raise AssertionError(f"phase 28: {label}: the walls' colours")
    if not (0 <= imgs["normal-geom"].min() and imgs["normal-geom"].max() <= 1
            and imgs["shadow"].max() > 0 and imgs["indirect"].max() > 0
            and 0 < imgs["toon"].mean() < 1):
        raise AssertionError(f"phase 28: {label}: a layer is empty or out "
                             "of range")
    if samples <= aa_params["aa_samples"]:
        raise AssertionError(f"phase 28: {label}: the adaptive passes "
                             "resampled nothing")
    return imgs, mt, tl, log


def _aov_instrumented(accel):
    """One more adaptive render on `accel` (the flat threshold's, which
    compacts) with every query timed: per pass kind the launches, live
    rays, ms and bounds, and the filter splat's ms (CUDA events around
    add_samples). Returns the first compacted sample's queries, kept whole:
    mt_closest's calls on brute force, tile_walk's on blocks."""
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    R = _render_module()
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    scene = _cornell(accel, WIDTH, HEIGHT)
    real_add, splats = F.add_samples, []

    def add(*a, **k):
        e = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
        e[0].record()
        out = real_add(*a, **k)
        e[1].record()
        splats.append(e)
        return out

    per = 2 * (BOUNCES + 1)
    kept, taken = [], [0]

    def keep(tag):
        # the first compacted sample's queries
        take = tag == ("compacted", False) and taken[0] < per
        taken[0] += take
        return take

    F.add_samples = add
    try:
        with _passes_logged() as (log, state), \
                _queries_timed(state, keep) as recs:
            render(scene, cfg, aa=R.AAParams(**AOV_AA_FLAT),
                   layer_names=AOV_LAYERS, **AOV_FILTER)
            kept += [r["call"] for r in recs if "call" in r]
    finally:
        F.add_samples = real_add
    rows = _query_rows(recs)
    _print_queries(f"AOV render ({accel}), instrumented", rows)
    splat_ms = [a.elapsed_time(z) for a, z in splats]
    print(f"phase 28: AOV render ({accel}): the filter splat (9 taps, "
          f"{len(AOV_LAYERS)} layers) {min(splat_ms):.3f}-"
          f"{max(splat_ms):.3f} ms a pass by CUDA events "
          f"({sum(splat_ms):.2f} ms over {len(splat_ms)} passes)")
    return kept


def _aov_overhead():
    """ms a pass of the 1080p Cornell box, Gauss 1.5, with combined alone
    and with the AOV layers (two passes each, after a warm-up)."""
    import torch
    from libyafaray_tpu_torch import make_integrator, render
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    scene = _cornell("brute", WIDTH, HEIGHT)
    out = {}
    for names in (("combined",), AOV_LAYERS, ("combined",), AOV_LAYERS):
        render(scene, cfg, spp=1, layer_names=names, **AOV_FILTER)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(scene, cfg, spp=2, start_sample=1, layer_names=names,
               **AOV_FILTER)
        torch.cuda.synchronize()
        out.setdefault(len(names), []).append(
            (time.perf_counter() - t0) * 1e3 / 2)
    base, aov = min(out[1]), min(out[len(AOV_LAYERS)])
    print(f"phase 28: AOV overhead: a pass with combined alone "
          f"{base:.2f} ms, with {len(AOV_LAYERS)} layers {aov:.2f} ms "
          f"(+{100 * (aov - base) / base:.1f}%; best of two runs each)")


def _aov_paths():
    """At 256x256 the adaptive AOV render (the curve's dark detection and
    the flat threshold) through the kernel path against the plain path:
    every layer and every noise mask bit for bit on brute force, every
    layer within `_paths_agree`'s bounds on blocks."""
    import numpy as np
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.accel import tiles as TL
    R = _render_module()
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    real_mask = R.compute_resample_mask
    for (accel, module, name, ref), params in itertools.product((
            ("brute", MT, "mt_closest", MT.mt_closest_ref),
            ("blocks", TL, "tile_walk", TL.tile_walk_ref)),
            (AOV_AA, AOV_AA_FLAT)):
        aa = R.AAParams(**params)
        label = f"{accel}, dark detection {params['dark_detection_type']}"
        small = _cornell(accel, AOV_SMALL, AOV_SMALL)
        out = []
        for plain in (False, True):
            masks = []

            def mask(film, aa_):
                m = real_mask(film, aa_)
                masks.append(m.cpu().numpy())
                return m

            R.compute_resample_mask = mask
            try:
                with (_plain(module, name, ref) if plain
                      else contextlib.nullcontext()):
                    film = render(small, cfg, aa=aa, layer_names=AOV_LAYERS,
                                  **AOV_FILTER)
            finally:
                R.compute_resample_mask = real_mask
            out.append((_aov_images(film, label), masks))
        (got, m_k), (want, m_p) = out
        flagged = [round(float(m.mean()), 4) for m in m_k]
        if accel == "brute":
            diff = max(float(np.abs(got[k] - want[k]).max()) for k in got)
            masks_equal = len(m_k) == len(m_p) and all(
                np.array_equal(a, b) for a, b in zip(m_k, m_p))
            print(f"phase 28: {label} {AOV_SMALL}x{AOV_SMALL}, kernel "
                  f"path against plain path: {len(got)} layers, max |diff| "
                  f"{diff:.3g}; {len(m_k)} noise masks (flagged "
                  f"{flagged}) equal: {masks_equal}")
            if diff != 0.0 or not masks_equal:
                raise AssertionError("phase 28: the kernel path is not the "
                                     "plain path bit for bit")
        else:
            same = [float((a == b).mean()) for a, b in zip(m_k, m_p)]
            print(f"phase 28: {label} {AOV_SMALL}x{AOV_SMALL}, kernel path "
                  f"against plain path, every layer (flagged {flagged}, "
                  f"masks equal on {same} of pixels):")
            for k in got:
                if np.abs(want[k]).max() > 0:
                    _paths_agree("28", got[k], want[k])
                elif np.abs(got[k]).max() > 0:
                    raise AssertionError(f"phase 28: {label}: layer {k} is "
                                         "empty on the plain path only")


def _ao_debug_resume():
    """At 1080p on brute force: directlighting with ambient occlusion (its
    AO_SAMPLES shadow queries per pass held bit for bit against
    mt_closest_ref and timed beside their bounds), one debug pass, and a
    2 + 2-spp render saved and resumed from its film file against 4 spp.
    Returns (launches by path, the AO queries' per-launch numbers)."""
    import tempfile
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    scene = _cornell("brute", WIDTH, HEIGHT)
    launches = {}
    dl = {"type": "directlighting", "bounces": BOUNCES}
    imgs = {}
    for label, pm in (("directlighting", dl),
                      ("directlighting with AO",
                       dict(dl, do_AO=True, AO_samples=AO_SAMPLES))):
        cfg = make_integrator(pm)
        names = ("combined", "ao") if cfg.use_ao else ("combined",)
        render(scene, cfg, spp=1, layer_names=names)      # warm-up
        torch.cuda.synchronize()
        _zero_launches("mt_closest")
        t0 = time.perf_counter()
        film = render(scene, cfg, spp=2, layer_names=names)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        launches[label] = _launches("mt_closest")
        imgs[label] = {k: F.resolve(film, k).cpu().numpy() for k in names}
        print(f"phase 28: {label} {WIDTH}x{HEIGHT} 2 spp: {ms:.2f} ms a "
              f"pass, mt_closest {_launches('mt_closest')} launches; image "
              f"mean {float(imgs[label]['combined'][..., :3].mean()):.6f}")
    extra = launches["directlighting with AO"] - launches["directlighting"]
    ao = imgs["directlighting with AO"]["ao"]
    print(f"phase 28: ambient occlusion: {extra} more launches over 2 "
          f"passes, AO layer mean {float(ao.mean()):.4f}, min "
          f"{float(ao.min()):.4f}")
    if extra != 2 * AO_SAMPLES or not 0 < float(ao.mean()) < 1:
        raise AssertionError("phase 28: the AO term's queries or layer")
    if not (imgs["directlighting with AO"]["combined"][..., :3].mean()
            > imgs["directlighting"]["combined"][..., :3].mean()):
        raise AssertionError("phase 28: AO adds no light")
    cfg = make_integrator(dict(dl, do_AO=True, AO_samples=AO_SAMPLES))
    with _mt_captured() as (calls, _):
        with _passes_logged() as (_, state), \
                _queries_timed(state) as recs:
            render(scene, cfg, spp=1, start_sample=2)
    ao_calls = [c for c, r in zip(calls, recs) if r["tag"][1]]
    if len(ao_calls) != AO_SAMPLES:
        raise AssertionError(f"phase 28: {len(ao_calls)} AO queries a pass")
    per_ao = _hold_queries("28", ao_calls, [f"AO shadow query {i}"
                                            for i in range(AO_SAMPLES)])

    cfg = make_integrator({"type": "debug"})
    _zero_launches("mt_closest")
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=1)
    torch.cuda.synchronize()
    launches["debug"] = _launches("mt_closest")
    img = F.resolve(film).cpu().numpy()
    print(f"phase 28: debug integrator {WIDTH}x{HEIGHT} one pass: "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms, mt_closest "
          f"{_launches('mt_closest')} launches, alpha mean "
          f"{float(img[..., 3].mean()):.4f}"
          f", rgb {float(img[..., :3].min()):.4f}-"
          f"{float(img[..., :3].max()):.4f}")
    if _launches("mt_closest") != 1 or not (0 <= img.min() and img.max() <= 1
                                and img[..., 3].mean() > 0.9):
        raise AssertionError("phase 28: the debug pass")

    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    kw = dict(layer_names=("combined", "normal-geom", "indirect"),
              **AOV_FILTER)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cornell.film.npz")
        _zero_launches("mt_closest")
        render(scene, cfg, spp=2, film_path=path, film_load_save_mode="save",
               **kw)
        resumed = render(scene, cfg, spp=2, film_path=path,
                         film_load_save_mode="load", **kw)
        launches["resume"] = _launches("mt_closest")
        straight = render(scene, cfg, spp=4, **kw)
        equal = all(torch.equal(resumed.layers[k], straight.layers[k])
                    for k in straight.layers) and torch.equal(
            resumed.weights, straight.weights)
        size = os.path.getsize(path)
    print(f"phase 28: 2 + 2 spp saved ({size / 2**20:.1f} MiB film file) and "
          f"resumed against 4 spp at {WIDTH}x{HEIGHT}: equal bit for bit: "
          f"{equal}; mt_closest {launches['resume']} launches")
    if not equal or launches["resume"] != 4 * 2 * (BOUNCES + 1):
        raise AssertionError("phase 28: the resumed render differs")
    return launches, per_ao


def phase28_aov():
    """The render loop as users drive it: the adaptive, Gauss-filtered AOV
    render of the Cornell box at 1920x1080 on both accelerators, ambient
    occlusion, the debug integrator and a resumed render; kernel path
    against plain path at 256x256. Returns (mt_closest launches by path,
    tiles_traverse launches, the compacted and AO queries' per-launch
    numbers, those of the compacted queries on blocks)."""
    import numpy as np
    launches = {}
    imgs, launches["aov brute"], _, _ = _aov_render("brute")
    imgs_b, _, tile_launches, _ = _aov_render("blocks")
    print("phase 28: the AOV render on blocks against brute force, every "
          "layer:")
    for k in imgs:
        if np.abs(imgs[k]).max() > 0:
            _paths_agree("28", imgs_b[k], imgs[k])
    _, launches["aov brute flat"], _, log = _aov_render("brute", AOV_AA_FLAT)
    if not any(e["kind"] == "compacted" for e in log):
        raise AssertionError("phase 28: no adaptive pass was compacted")
    compacted = _aov_instrumented("brute")
    per_launch = {"compacted": _hold_queries(
        "28", compacted, [f"first compacted sample, query {i}"
                          for i in range(len(compacted))])}
    walks = _aov_instrumented("blocks")
    per_walk = _hold_walks("28", walks, [
        f"blocks, first compacted sample, query {i}"
        for i in range(len(walks))])
    _aov_overhead()
    _aov_paths()
    more, per_launch["ao"] = _ao_debug_resume()
    launches.update(more)
    return launches, tile_launches, per_launch, per_walk


# ------------------------------------------------------------- phase 29

# the photon-mapping integrator as libYafaRay's clients set it: the JAX
# package's defaults (100,000 photons of 5 bounces, a gather radius of
# 0.05, the final gather with 16 samples of up to 3 bounces under an
# fg_min_pathlen of 0.05), 4 bounces of specular continuation
PM_PARAMS = {"type": "photonmapping"}
PM_SPP = 2               # phase 29's photon-mapping passes (cut from 4)
CAUSTIC_PM_RES = 512        # the caustic scene's caustic map (config 4)
SPPM_PASSES, SPPM_PHOTONS, SPPM_RADIUS = 8, 50_000, 0.05
BIDIR_PARAMS = {"type": "bidirectional", "bounces": 4}
BIDIR_SPP = 2            # phase 29's BDPT passes (cut from 4)
# the parts of an integrator whose queries phase 29 counts apart (the
# functions that issue them); the rest are "bounce" queries (the walks'
# closest hits and the NEE shadow rays)
QUERY_KINDS = (("photon", "libyafaray_tpu_torch.photon", "shoot_photons"),
               ("gather", "libyafaray_tpu_torch.integrators.mc",
                "_final_gather"),
               ("connection", "libyafaray_tpu_torch.integrators.bidir",
                "_connections"),
               ("splat", "libyafaray_tpu_torch.integrators.bidir", "_splats"),
               ("camera", "libyafaray_tpu_torch.ops.intersect",
                "camera_hit"))


@contextlib.contextmanager
def _queries_by_kind(keep=False):
    """Inside, every mt_closest and tile_walk call is counted by the part of
    the integrator that issued it (QUERY_KINDS, else "bounce"); with
    `keep` each mt_closest call is also kept whole (arguments, keywords,
    outputs, cloned) with its kind. Yields (counts, kept)."""
    import importlib
    import torch
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.accel import tiles as TL
    counts, kept, tag = {}, [], [None]
    copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x
    patched = []

    def tagged(kind, fn):
        def run(*a, **k):
            outer, tag[0] = tag[0], tag[0] or kind
            try:
                return fn(*a, **k)
            finally:
                tag[0] = outer
        return run

    def counted(fn, is_mt):
        def run(*a, **k):
            kind = tag[0] or "bounce"
            counts[kind] = counts.get(kind, 0) + 1
            out = fn(*a, **k)
            if keep and is_mt:
                kept.append((kind, tuple(copy(x) for x in a),
                             {key: copy(x) for key, x in k.items()},
                             tuple(x.clone() for x in out)))
            return out
        return run

    for kind, mod, name in QUERY_KINDS:
        m = importlib.import_module(mod)
        patched.append((m, name, getattr(m, name)))
        setattr(m, name, tagged(kind, getattr(m, name)))
    for m, name, is_mt in ((MT, "mt_closest", True),
                           (TL, "tile_walk", False)):
        patched.append((m, name, getattr(m, name)))
        setattr(m, name, counted(getattr(m, name), is_mt))
    try:
        yield counts, kept
    finally:
        for m, name, real in reversed(patched):
            setattr(m, name, real)


def _walls(phase, label, img):
    """The image finite, its left wall red and its right wall green."""
    import numpy as np
    w = img.shape[1]
    left = img[:, : w // 16, :3].mean((0, 1))
    right = img[:, -w // 16:, :3].mean((0, 1))
    ok = (np.isfinite(img).all() and left[0] > left[1]
          and right[1] > right[0] and img[..., :3].mean() > 0)
    print(f"phase {phase}: {label}: image mean "
          f"{float(img[..., :3].mean()):.6f}, left wall rgb "
          f"{np.round(left, 4).tolist()}, right wall rgb "
          f"{np.round(right, 4).tolist()}, finite {np.isfinite(img).all()}")
    if not ok:
        raise AssertionError(f"phase {phase}: {label}: implausible image")


def _per_pass(counts, passes):
    return ", ".join(f"{k} {v / passes:g}" for k, v in sorted(counts.items()))


def _timed_run(label, fn, passes):
    """fn() timed (host clock, synchronised) with the kernel counts set to
    0 just before and read just after, its queries counted by kind and the
    peak device memory taken. Prints and returns (fn's result, mt_closest
    launches, tile kernel launches, counts by kind)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _zero_launches("mt_closest", "tile_walk")
    with _queries_by_kind() as (counts, _):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    mt, tl = _launches("mt_closest"), _launches("tile_walk")
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    print(f"phase 29: {label}: {seconds * 1e3 / passes:.2f} ms a pass "
          f"({passes} passes); launches a pass by kind: "
          f"{_per_pass(counts, passes)} (mt_closest {mt}, tile kernel "
          f"{tl} in all); peak device memory {peak:.3f} GiB above the "
          f"{base / 2 ** 30:.3f} GiB held before")
    if sum(counts.values()) != mt + tl or not mt + tl:
        raise AssertionError(f"phase 29: {label}: {mt + tl} launches, "
                             f"{sum(counts.values())} counted by kind")
    return out, mt, tl, counts


def _pm_render(label, scene, spp, profile=False):
    """Photon mapping through `render`: the maps built once (timed, their
    launches counted), then `spp` passes after a warm-up pass (and with
    `profile` one more pass profiled). Returns (image, mt_closest
    launches, tile kernel launches, photons stored in each map)."""
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    cfg = make_integrator(PM_PARAMS)
    R = _render_module()
    ph, mt_b, tl_b, _ = _timed_run(
        f"{label}: photon maps ({cfg.n_photons} photons, {cfg.pm_bounces} "
        f"bounces, radiance cache {cfg.final_gather})",
        lambda: R._photon_maps(scene, cfg, "generate", None, DEVICE), 1)
    stored = [int(m.num_stored) for m in (ph.diffuse, ph.caustic)]
    print(f"phase 29: {label}: {stored[0]} diffuse and {stored[1]} caustic "
          "photons stored")
    with_maps = dataclasses.replace(scene, photons=ph)
    render(with_maps, cfg, spp=1, start_sample=spp)       # warm-up pass
    film, mt, tl, _ = _timed_run(
        f"{label} {scene.camera.resx}x{scene.camera.resy}",
        lambda: render(with_maps, cfg, spp=spp), spp)
    img = F.resolve(film).cpu().numpy()
    if profile:
        n_k, busy, ms = _profile_pass(with_maps, cfg)
        print(f"phase 29: {label}: one pass profiled: {n_k} kernel launches, "
              f"device busy {busy:.2f} of {ms:.2f} ms "
              f"({100 * busy / max(ms, 1e-9):.1f}%)")
    return img, mt + mt_b, tl + tl_b, stored


def _hold_kinds(label, kept, phase="29"):
    """Each kept mt_closest call held bit for bit against mt_closest_ref,
    one line per kind; the first call of each kind timed beside its plain
    version and its bound. Returns (max error, per-launch means)."""
    import torch
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    err, rows, by_kind, bound_by = 0.0, [], {}, {}
    for kind, a, k, got in kept:
        want, plain = _once_ms(lambda: MT.mt_closest_ref(*a, **k))
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"phase {phase}: {label}: {kind}: prim ids "
                                 "differ from mt_closest_ref")
        for x, y in zip(got, want):
            if not torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)):
                raise AssertionError(f"phase {phase}: {label}: {kind}: outputs "
                                     "differ from mt_closest_ref")
        n = by_kind.setdefault(kind, [0, 0])
        n[0] += 1
        n[1] += int((a[4] > a[3]).sum())
        if n[0] == 1:
            ms = _cuda_ms(lambda: MT.mt_closest(*a, **k), 10)
            live, nrows, bound, by = mt_bound(a, k)
            rows.append((ms, plain, bound))
            bound_by[by] = bound_by.get(by, 0.0) + bound
            print(f"phase {phase}: {label}: first {kind} query: {a[1].shape[0]} "
                  f"rays, {live} live, {nrows} rows kept: mt_closest "
                  f"{ms:.4f} ms, mt_closest_ref {plain:.4f} ms, bound "
                  f"{bound:.4f} ms ({by})")
    print(f"phase {phase}: {label}: every query equal to mt_closest_ref bit for "
          "bit: " + ", ".join(f"{k} {v[0]} queries ({v[1]} live rays)"
                              for k, v in sorted(by_kind.items())))
    m = len(rows)
    ms, plain, bound = (sum(x) / m for x in zip(*rows))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=max(bound_by, key=bound_by.get))


def _integrator_paths(label, scene, run):
    """run(scene) -> image, kernel path against plain path on brute force:
    the images equal bit for bit, and every query of the kernel path equal
    to mt_closest_ref's (`_hold_kinds`)."""
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    with _queries_by_kind(keep=True) as (_, kept):
        img_k = run(scene)
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        img_p = run(scene)
    _bit_for_bit("29", label, img_k, img_p)
    return _hold_kinds(label, kept)


def phase29_integrators():
    """The last three integrators at 1920x1080 on the card: photon mapping
    (brute force and blocks, the caustic scene's caustic map, a map file
    saved and loaded), SPPM (with and without PM_IRE) and bidirectional
    (area and point light); at 128x128 each kernel path against its plain
    path. Returns (mt_closest launches by run, tile kernel launches, the
    per-launch numbers of the held queries by integrator, those of the
    photon walks on blocks)."""
    import tempfile
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.integrators.sppm import render_sppm
    from libyafaray_tpu_torch.scenes import caustic_grad_builder
    launches, per_launch = {}, {}

    # ---- photon mapping
    imgs = {}
    for accel in ("brute", "blocks"):
        img, mt, tl, _ = _pm_render(f"photon mapping ({accel})",
                                    _cornell(accel, WIDTH, HEIGHT), PM_SPP,
                                    profile=accel == "brute")
        _walls("29", f"photon mapping ({accel})", img)
        imgs[accel] = img
        launches[f"photon mapping {accel}"] = (mt, tl)
        if (tl if accel == "blocks" else mt) == 0 or (
                mt if accel == "blocks" else tl):
            raise AssertionError(f"phase 29: photon mapping on {accel}: "
                                 f"{mt} mt_closest, {tl} tile launches")
    _paths_agree("29", imgs["blocks"], imgs["brute"])
    cscene = caustic_grad_builder(CAUSTIC_PM_RES, CAUSTIC_PM_RES).compile(
        "cam")
    img, mt, _, stored = _pm_render("photon mapping, caustic scene", cscene,
                                    1)
    launches["photon mapping caustic"] = (mt, 0)
    if not np.isfinite(img).all() or stored[1] == 0:
        raise AssertionError("phase 29: the caustic scene stored no caustic "
                             "photon")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "maps.npz")
        small = _cornell("brute", 512, 512)
        cfg = make_integrator(PM_PARAMS)
        saved = F.resolve(render(small, cfg, spp=1,
                                 photon_maps_processing="generate-save",
                                 photon_map_path=path)).cpu().numpy()
        loaded = F.resolve(render(small, cfg, spp=1,
                                  photon_maps_processing="load",
                                  photon_map_path=path)).cpu().numpy()
        print(f"phase 29: photon maps saved "
              f"({os.path.getsize(path) / 2 ** 20:.1f} MiB) and loaded")
        _bit_for_bit("29", "a generate-save render against a load render",
                     loaded, saved)

    # ---- SPPM
    cfg = make_integrator({"type": "SPPM", "bounces": BOUNCES})
    cornell = _cornell("brute", WIDTH, HEIGHT)
    for ire in (False, True):
        label = f"SPPM{' with PM_IRE' if ire else ''}"
        img, mt, _, _ = _timed_run(
            f"{label} {WIDTH}x{HEIGHT}, {SPPM_PHOTONS} photons a pass",
            lambda: render_sppm(cornell, cfg, passes=SPPM_PASSES,
                                photons_per_pass=SPPM_PHOTONS,
                                initial_radius=SPPM_RADIUS, pm_ire=ire,
                                device=DEVICE).cpu().numpy(), SPPM_PASSES)
        _walls("29", label, img)
        launches[label] = (mt, 0)

    # ---- bidirectional
    from libyafaray_tpu_torch.scenes import cornell_builder
    cfg = make_integrator(BIDIR_PARAMS)
    for light in ("area", "point"):
        b = cornell_builder(light_kind=light)
        b.cameras["cam"]["resx"], b.cameras["cam"]["resy"] = WIDTH, HEIGHT
        scene = b.compile("cam")
        render(scene, cfg, spp=1, start_sample=BIDIR_SPP)     # warm-up
        film, mt, _, _ = _timed_run(
            f"bidirectional, {light} light, {WIDTH}x{HEIGHT}",
            lambda: render(scene, cfg, spp=BIDIR_SPP), BIDIR_SPP)
        img = F.resolve(film).cpu().numpy()
        splat = float(film.splat.sum())
        print(f"phase 29: bidirectional, {light} light: splat sum {splat:.6g}"
              f" over {float(film.splat_paths):.0f} light subpaths")
        _walls("29", f"bidirectional, {light} light", img)
        if not splat > 0:
            raise AssertionError("phase 29: no light-tracing splat landed")
        launches[f"bidirectional {light}"] = (mt, 0)

    # ---- kernel path against plain path at 128x128 on brute force
    small = _cornell("brute", PATHS_RES, PATHS_RES)
    pm_cfg = make_integrator(PM_PARAMS)
    per_launch["photon mapping"] = _integrator_paths(
        "photon mapping", small, lambda s: F.resolve(
            render(s, pm_cfg, spp=1)).cpu().numpy())
    sppm_cfg = make_integrator({"type": "SPPM", "bounces": BOUNCES})
    per_launch["SPPM"] = _integrator_paths(
        "SPPM with PM_IRE", small, lambda s: render_sppm(
            s, sppm_cfg, passes=2, photons_per_pass=SPPM_PHOTONS,
            initial_radius=SPPM_RADIUS, pm_ire=True,
            device=DEVICE).cpu().numpy())
    bd_cfg = make_integrator(BIDIR_PARAMS)
    per_launch["bidirectional"] = _integrator_paths(
        "bidirectional", small, lambda s: F.resolve(
            render(s, bd_cfg, spp=1)).cpu().numpy())
    # on blocks: the photon walks against tile_walk_ref
    from libyafaray_tpu_torch import photon as PH
    blocks = _cornell("blocks", PATHS_RES, PATHS_RES)
    with _kept_calls(TL, "tile_walk", set(range(pm_cfg.pm_bounces))) as kept:
        PH.shoot_photons(blocks, pm_cfg.n_photons, pm_cfg.pm_bounces)
    per_walk = _hold_walks("29", kept, [f"blocks, photon depth {i}"
                                        for i in range(len(kept))])
    return launches, per_launch, per_walk


# ---------------------------------------------------------------- phase 30

VIEW_SPP = 4             # phase 30's render views at 1080p
SPECTRAL_WL = 0.3        # the spectral view's fixed wavelength
CAPI_PATHS_SPP = 2       # phase 30's 128x128 kernel path against plain path


def _capi_counted(label, fn):
    """fn() with the kernel counts set to 0 just before and read just
    after, timed on the host clock (synchronised). Returns (fn's result,
    mt_closest launches, tile kernel launches)."""
    import torch
    torch.cuda.synchronize()
    _zero_launches("mt_closest", "tile_walk")
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    mt, tl = _launches("mt_closest"), _launches("tile_walk")
    print(f"phase 30: {label}: {seconds:.2f} s, mt_closest {mt}, tile kernel "
          f"{tl} launches")
    return out, mt, tl


def _capi_clients():
    """(a) The port's C library and both C clients built on this host and
    run as their own processes with no device argument (so on the card);
    test00's staging replayed in this process through render_for_capi,
    its printed numbers equal within 1e-6. Returns the replay's
    mt_closest launches."""
    import tempfile
    from libyafaray_tpu_torch import capi_build
    from libyafaray_tpu_torch.capi_runtime import render_for_capi
    from libyafaray_tpu_torch.scenes import capi_test00
    t0 = time.perf_counter()
    out_dir = capi_build.build()
    cflags, ldflags = capi_build.embed_flags()
    print(f"phase 30: built {capi_build.LIBRARY} and "
          f"{', '.join(capi_build.CLIENTS)} in {time.perf_counter() - t0:.2f}"
          f" s ({' '.join(cflags + ldflags)}) into {out_dir}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {name: capi_build.start_client(name, None, tmp)
                 for name in capi_build.CLIENTS}
        outs = {name: p.communicate(timeout=capi_build.CLIENT_TIMEOUT)
                for name, p in procs.items()}
        seconds = time.perf_counter() - t0
        for name, (out, err) in outs.items():
            ok = f"{name[:6]} C client OK"
            print(f"phase 30: {name} (no device staged: the card): exit "
                  f"{procs[name].returncode}, " + " | ".join(
                      out.strip().splitlines()))
            if procs[name].returncode != 0 or ok not in out:
                raise AssertionError(f"phase 30: {name} failed:\n{out}\n"
                                     f"{err[-4000:]}")
        pngs = sorted(os.listdir(tmp))
        print(f"phase 30: both clients in {seconds:.2f} s (run together), "
              f"wrote {pngs}")
        if pngs != ["capi_test00.png", "capi_test05_out.png"]:
            raise AssertionError(f"phase 30: the clients wrote {pngs}")
    b, rp = capi_test00()
    (_, img, w, h), mt, _ = _capi_counted(
        "test00's staging replayed in-process", lambda: render_for_capi(
            b, rp, [], []))
    got = capi_build.parse_numbers(outs["test00_client"][0])
    want = capi_build.client_numbers(img)
    print(f"phase 30: test00_client printed {got}; in-process {want}")
    if (w, h) != (32, 32) or any(abs(got[k] - want[k]) > 1e-6 for k in got):
        raise AssertionError("phase 30: the C client's numbers differ from "
                             "the in-process render's")
    return mt


def _capi_xml(terrain_img):
    """(b) export_xml, load_xml and render_for_capi at full size: the
    Cornell box at 1920x1080 (16 spp, 4 bounces; kernel a) and the
    terrain at 720x720 (6 spp, 2 bounces; kernel b's static arm), each
    equal bit for bit to `render` of the original builder (the terrain's
    is phase 6's image). Returns (mt_closest launches, tile launches)."""
    import tempfile
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.capi_runtime import render_for_capi
    from libyafaray_tpu_torch.io.export import export_xml
    from libyafaray_tpu_torch.io.import_xml import load_xml
    from libyafaray_tpu_torch.scenes import bigmesh_builder
    cornell = _cornell_builder(WIDTH, HEIGHT)
    runs = (("cornell", cornell, {"integrator_bounces": BOUNCES,
                                  "AA_minsamples": SPP}),
            ("terrain", bigmesh_builder(TERRAIN_GRID, textured=False),
             {"integrator_bounces": TERRAIN_BOUNCES,
              "AA_minsamples": TERRAIN_SPP}))
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, b, rp in runs:
            path = os.path.join(tmp, f"{label}.xml")
            t0 = time.perf_counter()
            export_xml(b, path)
            t1 = time.perf_counter()
            loaded = load_xml(path)
            t2 = time.perf_counter()
            n_faces = sum(len(o.faces) for o in b.objects.values())
            print(f"phase 30: {label}: export_xml {t1 - t0:.2f} s, load_xml "
                  f"{t2 - t1:.2f} s ({n_faces} faces, "
                  f"{os.path.getsize(path) / 2**20:.1f} MiB)")
            (_, img, _, _), mt, tl = _capi_counted(
                f"{label} loaded from XML through render_for_capi",
                lambda: render_for_capi(loaded, dict(
                    rp, integrator_type="pathtracing"), [], []))
            launches[label] = (mt, tl)
            if label == "terrain":
                want = terrain_img
            else:
                cfg = make_integrator({"type": "pathtracing",
                                       "bounces": BOUNCES})
                want = F.resolve(render(b.compile("cam"), cfg,
                                        spp=SPP)).cpu().numpy()
            _bit_for_bit("30", f"{label} through XML against the original "
                         "builder's render", img, want)
    if launches["cornell"][1] or launches["terrain"][0] or not (
            launches["cornell"][0] and launches["terrain"][1]):
        raise AssertionError(f"phase 30: XML launches {launches}")
    return launches["cornell"][0], launches["terrain"][1]


def _capi_views():
    """(c) Render views at 1920x1080 through render_for_capi: two views of
    the Cornell box (one with a subset of the lights) and a spectral view
    of the box with a dispersive glass block, named outputs written to a
    temporary directory; each view's image equal to `render` of
    compile_view(view). Returns mt_closest launches by run."""
    import tempfile
    import numpy as np
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.capi_runtime import render_for_capi
    from libyafaray_tpu_torch.scenes import _box, cornell_builder
    b = _cornell_builder(WIDTH, HEIGHT)
    b.create_light("lamp2", {"type": "pointlight", "from": (0.5, 0.3, 0.6),
                             "color": (0.4, 0.6, 1.0), "power": 1.0})
    b.create_camera("side", dict(b.cameras["cam"], **{
        "from": (0.15, -1.2, 0.6), "fov": 45.0}))
    b.create_render_view("front", {"camera_name": "cam"})
    b.create_render_view("side", {"camera_name": "side",
                                  "light_names": "lamp"})
    prism = cornell_builder(extras=[("prism", {
        "type": "glass", "IOR": 1.5, "dispersion_power": 0.5})])
    prism.cameras["cam"]["resx"] = WIDTH
    prism.cameras["cam"]["resy"] = HEIGHT
    prism.create_object("prism")
    prism.set_current_material("prism")
    _box(prism, (0.3, 0.12, 0.05), (0.3, 0.2, 0.3))
    prism.create_render_view("spectral", {"camera_name": "cam",
                                          "wavelength": SPECTRAL_WL})
    rp = {"integrator_type": "pathtracing", "integrator_bounces": BOUNCES,
          "AA_minsamples": VIEW_SPP}
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, builder in (("two views", b), ("spectral view", prism)):
            outputs = [("png", {"image_path": os.path.join(tmp, "out.png")}),
                       ("hdr", {"image_path": os.path.join(tmp, "out.hdr"),
                                "layer": "combined"})]
            (views, _, _, _), mt, _ = _capi_counted(
                f"{label} {WIDTH}x{HEIGHT} {VIEW_SPP} spp through "
                "render_for_capi",
                lambda: render_for_capi(builder, rp, outputs, []))
            launches[label] = mt
            for v, layers in views.items():
                want = F.resolve(render(builder.compile_view(v), cfg,
                                        spp=VIEW_SPP)).cpu().numpy()
                _bit_for_bit("30", f"view {v!r} against "
                             "render(compile_view)", layers["combined"],
                             want)
        files = sorted(os.listdir(tmp))
        print(f"phase 30: named outputs written: {files}")
        if files != ["out.hdr", "out.png", "out_side.hdr", "out_side.png"]:
            raise AssertionError(f"phase 30: outputs {files}")
    fixed = views["spectral"]["combined"]
    free = F.resolve(render(prism.compile("cam"), cfg,
                            spp=VIEW_SPP)).cpu().numpy()
    diff = float(np.abs(fixed - free).max())
    print(f"phase 30: spectral view (wavelength {SPECTRAL_WL}) against the "
          f"per-path wavelengths: max |diff| {diff:.4g}, means "
          f"{float(fixed[..., :3].mean()):.6f} / "
          f"{float(free[..., :3].mean()):.6f}")
    if not diff > 1e-3:
        raise AssertionError("phase 30: the fixed wavelength changed nothing")
    return launches


def _capi_paths():
    """(d) render_for_capi at 128x128 through the kernel path against the
    plain path, on brute force (every mt_closest query held bit for bit
    against mt_closest_ref) and on blocks (every tile_walk query held
    against tile_walk_ref); the images bit for bit. Returns (per-launch
    numbers of kernel a, those of kernel b)."""
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.capi_runtime import render_for_capi
    rp = {"integrator_type": "pathtracing", "integrator_bounces": BOUNCES,
          "AA_minsamples": CAPI_PATHS_SPP}
    run = lambda b: render_for_capi(b, rp, [], [])[1]
    b = _cornell_builder(PATHS_RES, PATHS_RES, "brute")
    with _queries_by_kind(keep=True) as (_, kept):
        img_k = run(b)
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        img_p = run(b)
    _bit_for_bit("30", "render_for_capi on brute force", img_k, img_p)
    per_a = _hold_kinds(f"render_for_capi {PATHS_RES}x{PATHS_RES} brute "
                        "force", kept, "30")
    b = _cornell_builder(PATHS_RES, PATHS_RES, "blocks")
    keep = set(range(CAPI_PATHS_SPP * (BOUNCES + 1) * 2))
    _zero_launches("tile_walk")
    with _kept_calls(TL, "tile_walk", keep) as walks:
        img_k = run(b)
    launched = _launches("tile_walk")
    with _plain(TL, "tile_walk", TL.tile_walk_ref):
        img_p = run(b)
    _bit_for_bit("30", "render_for_capi on blocks", img_k, img_p)
    if not len(walks) == launched == len(keep):
        raise AssertionError(f"phase 30: {launched} tile kernel launches "
                             f"and {len(walks)} walks held on blocks, want "
                             f"{len(keep)} of each")
    per_b = _hold_walks("30", walks, [
        f"blocks {PATHS_RES}x{PATHS_RES} query {i}" for i in range(len(walks))])
    return per_a, per_b


def phase30_entry_points(terrain_img):
    """The public entry points on the card at full width: the C library
    and its clients, XML round trips, render views, and render_for_capi's
    kernel path against its plain path. Returns (mt_closest launches by
    path, tile kernel launches by path, per-launch numbers of a and b)."""
    mt, tl = {}, {}
    mt["C API test00 staging replayed in-process 32x32 4 spp"] = \
        _capi_clients()
    mt[f"cornell through XML {WIDTH}x{HEIGHT} {SPP} spp"], \
        tl[f"terrain through XML {TERRAIN_RES}x{TERRAIN_RES} {TERRAIN_SPP} "
           "spp"] = _capi_xml(terrain_img)
    for label, n in _capi_views().items():
        mt[f"render views: {label} {WIDTH}x{HEIGHT} {VIEW_SPP} spp"] = n
    per_a, per_b = _capi_paths()
    return mt, tl, per_a, per_b


# ---------------------------------------------------------------- phase 31

ACCEL_SMALL = 128        # phase 31: every query held against its plain version
ACCEL_INST_RES = 512     # instanced spheres and curves
FLOPS_PER_BOX = 25       # one slab test: 6 sub, 6 mul, 6 min / max, 4
                         # across the axes and 3 compares
FLOPS_PER_SPHERE = 25    # one ray-sphere test


def _lbvh_kind(k):
    """camera / bounce closest hits, shadow any hits, or the transparent
    walk's closest shadow hits, by the query's flags."""
    if k.get("any_hit"):
        return "shadow any hit"
    return "shadow closest (transparent walk)" if k.get("shadow") \
        else "closest"


def _lbvh_bound(a, k, stats):
    """(bound ms, what bounds it) of one lbvh_traverse call: the box, face
    and sphere tests this walk needed (`stats` from lbvh_traverse_ref) at
    their flops, or every input read once and the four outputs written
    once."""
    import torch
    from libyafaray_tpu_torch.accel import lbvh as LB
    bvh, geom, o = a[0], a[1], a[2]
    motion = LB._motion(geom, k.get("time"))
    flops = (stats["boxes"] * FLOPS_PER_BOX + stats["spheres"]
             * FLOPS_PER_SPHERE + stats["faces"]
             * FLOPS_PER_PAIR_MOTION[motion])
    tabs = [bvh.node_min, bvh.node_max, bvh.node_left, bvh.node_right,
            bvh.node_is_leaf, bvh.prim_order, geom.vertices, geom.faces,
            geom.face_vis]
    if motion:
        tabs += [geom.vertices_t1] + ([geom.vertices_t2] if motion == 2
                                      else [])
    if geom.num_spheres:
        tabs += [geom.sph_center, geom.sph_radius, geom.sph_vis]
    rays = [x for x in a[2:] if isinstance(x, torch.Tensor)]
    rays += [x for x in k.values() if isinstance(x, torch.Tensor)]
    return _bound_ms(flops, _nbytes(*tabs, *rays) + 16 * o.shape[0])


def _exact(label, got, want):
    """Raise unless the kernel's outputs equal the plain version's bit for
    bit (NaN where NaN); returns the max |diff| (0)."""
    import torch
    torch.cuda.synchronize()
    for name, x, y in zip(("t", "prim", "u", "v"), got, want):
        if not torch.equal(torch.nan_to_num(x, nan=-7.0),
                           torch.nan_to_num(y, nan=-7.0)):
            bad = int((x != y).sum())
            raise AssertionError(f"phase 31: {label}: {name} differs from "
                                 f"the plain version on {bad} rays")
    return 0.0


def _hold_lbvh(label, calls, reps=10):
    """Each captured lbvh_traverse call (arguments, keywords, outputs) held
    bit for bit against lbvh_traverse_ref, then timed alone beside the
    plain version and its bound: the kernel alone (its C entry point
    launched in a loop, `lbvh.prepare`) and the wrapper between CUDA
    events (its host work included); printed per kind. Returns the max
    error and the per-launch means (ms: the kernel alone, events_ms,
    plain_ms, bound_ms, bound_by)."""
    import collections
    from libyafaray_tpu_torch.accel import lbvh as LB
    by_kind = collections.defaultdict(list)
    bound_by = {}
    for i, (a, k, got) in enumerate(calls):
        stats = {}
        want, plain = _once_ms(lambda: LB.lbvh_traverse_ref(*a, **k,
                                                            stats=stats))
        _exact(f"{label} query {i}", got, want)
        ms = _cuda_ms(LB.prepare(*a, **k), reps)
        events = _cuda_ms(lambda: LB.lbvh_traverse(*a, **k), reps)
        bound, by = _lbvh_bound(a, k, stats)
        bound_by[by] = bound_by.get(by, 0.0) + bound
        live = int((a[5] > a[4]).sum())
        by_kind[_lbvh_kind(k)].append((ms, plain, bound, live,
                                       int((got[1] >= 0).sum()), stats, by,
                                       events))
    rows = []
    for kind, xs in by_kind.items():
        n = len(xs)
        ms, plain, bound = (sum(x[j] for x in xs) / n for j in range(3))
        events = sum(x[7] for x in xs) / n
        boxes = sum(x[5]["boxes"] for x in xs) / max(1, sum(x[3] for x in xs))
        bys = sorted({x[6] for x in xs})
        print(f"phase 31: {label}: {n} {kind} queries, every one bit for bit "
              f"(max |diff| 0): {sum(x[3] for x in xs)} live rays, "
              f"{sum(x[4] for x in xs)} hits, {boxes:.1f} box tests a live "
              f"ray; per query lbvh_traverse {ms:.4f} ms the kernel alone, "
              f"{events:.4f} ms between events around the wrapper, "
              f"lbvh_traverse_ref {plain:.4f} ms, bound {bound:.4f} ms "
              f"({', '.join(bys)}), at {100 * bound / ms:.1f}% of it")
        rows += xs
    n = len(rows)
    ms, plain, bound = (sum(x[j] for x in rows) / n for j in range(3))
    return dict(max_abs_err=0.0, ms=ms,
                events_ms=sum(x[7] for x in rows) / n, plain_ms=plain,
                bound_ms=bound, bound_by=max(bound_by, key=bound_by.get),
                queries=n)


def _counted(label, scene, cfg, spp, warm=True):
    """`render(scene, cfg, spp)` with no device argument, the kernel counts
    set to 0 just before and read just after: (image, ms a pass,
    {kernel: launches})."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import render
    if warm:
        render(scene, cfg, spp=1)
    torch.cuda.synchronize()
    _zero_launches("lbvh_traverse", "mt_closest", "tile_walk")
    t0 = time.perf_counter()
    film = render(scene, cfg, spp=spp)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(lbvh_traverse=_launches("lbvh_traverse"),
                  mt_closest=_launches("mt_closest"),
                  tiles_traverse=_launches("tile_walk"))
    img = F.resolve(film).cpu().numpy()
    if not np.isfinite(img).all():
        raise AssertionError(f"phase 31: {label}: the image is not finite")
    ms = seconds * 1e3 / spp
    print(f"phase 31: {label}: {img.shape[1]}x{img.shape[0]} {spp} spp, "
          f"{scene.geom.num_faces} triangles, {scene.geom.num_spheres} "
          f"spheres, on {scene.accel_kind}: {ms:.2f} ms a pass, "
          f"{img.shape[0] * img.shape[1] * spp / seconds:.4g} camera rays/s, "
          f"launches {counts}")
    return img, ms, counts


def _only(label, counts, kernel, want=None):
    """The render launched `kernel` (exactly `want` times, when given) and
    no other intersection kernel."""
    others = {k: n for k, n in counts.items() if k != kernel and n}
    if counts[kernel] == 0 or others or (want is not None
                                         and counts[kernel] != want):
        raise AssertionError(f"phase 31: {label}: launches {counts}, want "
                             f"{want or 'some'} of {kernel} alone")
    return counts[kernel]


def _lbvh_tree(label, scene):
    """Print the scene's LBVH depth beside its refit passes; a deeper tree
    is the refit fault of both packages (ROADMAP section 3)."""
    from libyafaray_tpu_torch.accel import lbvh as LB
    p = scene.bvh.prim_order.shape[0]
    depth, passes = LB.tree_depth(scene.bvh), LB.refit_passes(p)
    print(f"phase 31: {label}: LBVH over {p} primitives, "
          f"{scene.bvh.num_nodes} nodes, depth {depth}, refit passes "
          f"{passes}")
    if depth > passes:
        raise AssertionError(f"phase 31: {label}: the tree is deeper than "
                             "its refit")


def _all_calls(module, name):
    """`_kept_calls` of every call."""
    return _kept_calls(module, name, range(1 << 40))


def _lbvh_paths(label, scene, cfg, spp):
    """The scene at 128x128 through the kernel path, every lbvh_traverse
    query captured, and through the plain path: the images bit for bit and
    every query held; in a scene with spheres some hits end on a sphere
    leaf. Returns (launches, per-launch numbers)."""
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import render
    from libyafaray_tpu_torch.accel import lbvh as LB
    _zero_launches("lbvh_traverse")
    with _all_calls(LB, "lbvh_traverse") as kept:
        img_k = F.resolve(render(scene, cfg, spp=spp)).cpu().numpy()
    launches = _launches("lbvh_traverse")
    if launches != len(kept) or not launches:
        raise AssertionError(f"phase 31: {label}: {launches} launches, "
                             f"{len(kept)} queries captured")
    if scene.geom.num_spheres:
        on = sum(int((got[1] >= scene.geom.num_faces).sum())
                 for _, _, got in kept)
        print(f"phase 31: {label}: {on} hits on sphere leaves")
        if not on:
            raise AssertionError(f"phase 31: {label}: no query hit a sphere "
                                 "leaf")
    with _plain(LB, "lbvh_traverse", LB.lbvh_traverse_ref):
        img_p = F.resolve(render(scene, cfg, spp=spp)).cpu().numpy()
    _bit_for_bit("31", label, img_k, img_p)
    return launches, _hold_lbvh(label, kept)


def _small(scene, camera):
    from libyafaray_tpu_torch.cameras import make_camera
    from libyafaray_tpu_torch.params import ParamMap
    return dataclasses.replace(scene, camera=make_camera(ParamMap(dict(
        camera, resx=ACCEL_SMALL, resy=ACCEL_SMALL))))


def _ladder_overflow():
    """The hand-made LBVH 60 levels deep (`scenes.ladder_bvh`) on the card:
    rays at faces 0-47 hit them, rays at 48-60 miss (the walk's 48 slots
    overflow as in the JAX package), kernel and plain version bit for
    bit."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch.accel import lbvh as LB
    from libyafaray_tpu_torch.scene_types import BVH
    from libyafaray_tpu_torch.scenes import ladder_builder, ladder_bvh
    scene = ladder_builder().compile("cam")
    v = scene.geom.vertices[scene.geom.faces.long()].cpu().numpy()
    tables = ladder_bvh(v.min(1), v.max(1))
    bvh = BVH(**{k: torch.from_numpy(x).to(DEVICE)
                 for k, x in tables.items()}, num_nodes=121)
    k = np.arange(61)
    o = np.stack([np.full(61, -1.0), (k % 8) / 10, (k // 8) / 10],
                 -1).astype(np.float32)
    dev = lambda x: torch.from_numpy(x).to(DEVICE)
    args = (bvh, scene.geom, dev(o), dev(np.tile(np.float32([[1, 0, 0]]),
                                                 (61, 1))),
            torch.zeros(61, device=DEVICE),
            torch.full((61,), 1e30, device=DEVICE),
            torch.full((61,), -1, dtype=torch.int32, device=DEVICE))
    got = LB.lbvh_traverse(*args)
    _exact("the ladder 60 levels deep", got, LB.lbvh_traverse_ref(*args))
    hit = (got[1] >= 0).cpu().numpy()
    if not (hit == (k < 48)).all():
        raise AssertionError("phase 31: the ladder's overflow walk is not "
                             "the JAX package's")
    print("phase 31: the hand-made LBVH 60 levels deep: the kernel drops the "
          "pushes past slot 47 and re-reads it, as the plain version and the "
          "JAX walk do: faces 0-47 hit, 48-60 missed, bit for bit")


def _one_prim(sphere, device):
    """A scene of one triangle (its LBVH a single leaf, compiled with
    "bvh") or of one sphere (compiled on brute force, having no face; its
    one-leaf LBVH built here): (bvh, geom)."""
    from libyafaray_tpu_torch.accel import lbvh as LB
    from libyafaray_tpu_torch.scene import SceneBuilder
    b = SceneBuilder()
    b.set_render_params({"scene_accelerator": "bvh"})
    b.create_material("m", {"type": "shinydiffusemat"})
    if sphere:
        b.create_object("ball", {"type": "sphere", "center": (0.2, 0.3, 0.0),
                                 "radius": 0.5})
    else:
        b.create_object("one")
        b.set_current_material("m")
        b.add_triangle(*[b.add_vertex(*p) for p in
                         ((-0.5, -0.5, 0.0), (1.0, -0.2, 0.1),
                          (0.0, 1.0, -0.1))])
    b.create_camera("cam", {"type": "perspective", "from": (0, 0, 5),
                            "to": (0, 0, 0), "resx": 8, "resy": 8})
    scene = b.compile("cam", device=device)
    bvh = scene.bvh if scene.bvh is not None else LB.build_lbvh(scene.geom)
    if bvh.num_nodes != 1:
        raise AssertionError("the one-primitive tree is not one leaf")
    return bvh, scene.geom


TWIN = ((0.2, 0.2, 0.8), (0.8, 0.25, 0.82), (0.4, 0.8, 0.85))


def _twins(device):
    """The Cornell box with one triangle twice, each copy a leaf of its
    own, above the blocks: a ray at it meets two leaves at the same t.
    (bvh, geom)."""
    from libyafaray_tpu_torch.scenes import cornell_builder
    b = cornell_builder()
    b.set_render_params({"scene_accelerator": "bvh"})
    b.create_object("twins")
    b.set_current_material("white")
    for _ in range(2):
        b.add_triangle(*[b.add_vertex(*p) for p in TWIN])
    scene = b.compile("cam", device=device)
    return scene.bvh, scene.geom


def lbvh_edge_cases(device, n=4096, seed=31):
    """The walk's edge cases as lbvh_traverse calls [(label, args,
    kwargs)], each to be held bit for bit against lbvh_traverse_ref, on
    `device`: dead and NaN rays mixed with live ones inside a warp, and
    whole dead warps; an exact tie of two leaves; one-primitive trees (a
    face, a sphere); origins on box faces and direction components of +0
    and -0; a tree copied through numpy as `convert.scene_from_numpy`
    makes one (packed anew). Every case runs closest, shadow closest and
    any hit."""
    import numpy as np
    import torch
    from libyafaray_tpu_torch.scene_types import BVH
    from libyafaray_tpu_torch.scenes import cornell_builder
    rng = np.random.default_rng(seed)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    b = cornell_builder()
    b.set_render_params({"scene_accelerator": "bvh"})
    box = b.compile("cam", device=device)

    def rays(o, d, t_min=None, t_max=None, excl=None):
        m = o.shape[0]
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        return (dev(o.astype(np.float32)), dev(d.astype(np.float32)),
                dev(np.full(m, 1e-4, np.float32) if t_min is None
                    else t_min),
                dev(np.full(m, 1e30, np.float32) if t_max is None
                    else t_max),
                dev(np.full(m, -1, np.int32) if excl is None else excl))

    cases = []
    # dead and NaN rays: warp 0 live, warps 1-2 mixed lane by lane, warps
    # 3-4 dead, warp 5 NaN; the pattern repeats every 8 warps
    o = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.full(n, 1e30, np.float32)
    warp, lane = (np.arange(n) // 32) % 8, np.arange(n) % 32
    mixed = np.isin(warp, (1, 2))
    t_max[mixed & (lane % 7 == 1)] = -1.0
    t_max[mixed & (lane % 7 == 2)] = 1e-4                 # t_max == t_min
    t_min[mixed & (lane % 7 == 3)] = np.nan
    t_max[mixed & (lane % 7 == 4)] = np.nan
    t_min[np.isin(warp, (3, 4))] = 5.0                    # t_max < t_min
    t_max[np.isin(warp, (3, 4))] = 2.0
    r = rays(o, d, t_min, t_max)
    r[0][torch.from_numpy((mixed & (lane % 7 == 5)) | (warp == 5)), 1] = \
        float("nan")
    r[1][torch.from_numpy(mixed & (lane % 7 == 6)), 2] = float("nan")
    cases.append(("dead and NaN rays among live ones", (box.bvh, box.geom)
                  + r))
    # an exact tie: the first of the two leaves popped wins
    tb, tg = _twins(device)
    m = 1024
    w = rng.dirichlet((1, 1, 1), m).astype(np.float32)
    target = w @ np.float32(TWIN)
    o = target + np.float32([0.0, 0.0, 0.1]) + rng.uniform(
        -0.05, 0.05, (m, 3)).astype(np.float32)
    cases.append(("a face twice (an exact tie of two leaves)", (tb, tg)
                  + rays(o, target - o)))
    # one-primitive trees
    for sphere in (False, True):
        ob, og = _one_prim(sphere, device)
        o = np.concatenate([rng.uniform(-0.6, 0.6, (m, 2)),
                            np.full((m, 1), 3.0)], 1)
        d = np.concatenate([rng.uniform(-0.1, 0.1, (m, 2)),
                            np.full((m, 1), -1.0)], 1)
        cases.append((f"a one-primitive tree ({'a sphere' if sphere else 'a face'})",
                      (ob, og) + rays(o, d)))
    # origins on box faces, direction components of +0 and -0
    nmin = box.bvh.node_min.cpu().numpy()
    nmax = box.bvh.node_max.cpu().numpy()
    k = rng.integers(0, nmin.shape[0], n)
    o = np.where(rng.random((n, 3)) < 0.5, nmin[k], nmax[k])
    d = rng.standard_normal((n, 3))
    zero = rng.random((n, 3)) < 0.3
    d[zero] = np.where(rng.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    d[(d == 0).all(1), 0] = 1.0
    cases.append(("origins on box faces, direction components of +-0",
                  (box.bvh, box.geom) + rays(o, d)))
    # a tree made outside build_lbvh, from numpy tables
    copy = BVH(**{f: dev(getattr(box.bvh, f).cpu().numpy()) for f in (
        "node_min", "node_max", "node_left", "node_right", "node_is_leaf",
        "prim_order")}, num_nodes=box.bvh.num_nodes)
    o = rng.uniform(0.05, 0.95, (n, 3))
    cases.append(("the tree copied through numpy (convert's tables)",
                  (copy, box.geom) + rays(o, rng.standard_normal((n, 3)))))
    out = []
    for label, a in cases:
        for kw in ({}, {"shadow": True}, {"shadow": True, "any_hit": True}):
            out.append((label, a, kw))
    return out


def _lbvh_edges():
    """Each of `lbvh_edge_cases` held bit for bit; the tie is won by the
    leaf the walk pops first in both versions. Returns the cases held."""
    from libyafaray_tpu_torch.accel import lbvh as LB
    cases = lbvh_edge_cases(DEVICE)
    for label, a, k in cases:
        got = LB.lbvh_traverse(*a, **k)
        want = LB.lbvh_traverse_ref(*a, **k)
        _exact(f"{label} {_lbvh_kind(k)}", got, want)
        hits = int((got[1] >= 0).sum())
        print(f"phase 31: {label}, {_lbvh_kind(k)}: {a[2].shape[0]} rays, "
              f"{hits} hits, bit for bit")
        if label.startswith("a face twice") and not k:
            prims = set(got[1][got[1] >= 0].tolist())
            print(f"phase 31: the tie is taken by prim ids {sorted(prims)} "
                  "(the leaf popped first)")
    return len(cases)


def _terrain(accel):
    from libyafaray_tpu_torch.scenes import bigmesh_builder
    b = bigmesh_builder(TERRAIN_GRID)
    b.set_render_params({"scene_accelerator": accel})
    t0 = time.perf_counter()
    scene = b.compile("cam")
    import torch
    torch.cuda.synchronize()
    print(f"phase 31: the textured terrain compiled on {accel} in "
          f"{time.perf_counter() - t0:.2f} s")
    if scene.accel_kind != accel:
        raise AssertionError(f"the terrain compiled to {scene.accel_kind}")
    return scene


def phase31_accelerators(textured_img):
    """The accelerators complete, at full width: the LBVH, brute force on
    the 203,522-face terrain, and instanced spheres and curves. Returns
    (lbvh_traverse launches by path, its per-launch numbers by path,
    mt_closest launches by path, kernel a's per-launch numbers on the
    terrain, tiles_traverse launches by path)."""
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator
    from libyafaray_tpu_torch.accel import lbvh as LB
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.scenes import (MATERIALS_INTEGRATOR,
                                             TERRAIN_CAMERA,
                                             accel_instances_builder,
                                             materials_cornell_builder,
                                             motion_cornell_builder)
    launches, per = {}, {}
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    cfg_t = make_integrator({"type": "pathtracing",
                             "bounces": TERRAIN_BOUNCES})

    # the Cornell box on the LBVH at 1080p against brute force
    cornell = _cornell_builder(WIDTH, HEIGHT, "bvh").compile("cam")
    _lbvh_tree("cornell", cornell)
    brute, _, counts = _counted("cornell (brute force)", _cornell(
        "brute", WIDTH, HEIGHT), cfg, SPP)
    img, _, counts = _counted("cornell", cornell, cfg, SPP)
    label = f"cornell {WIDTH}x{HEIGHT} {SPP} spp"
    launches[label] = _only(label, counts, "lbvh_traverse",
                            SPP * (BOUNCES + 1) * 2)
    _paths_agree("31", img, brute)
    with _kept_calls(LB, "lbvh_traverse", range(1 << 40)) as kept:
        _render_module().render(cornell, cfg, spp=1)
    per[f"cornell {WIDTH}x{HEIGHT}, one pass's queries"] = _hold_lbvh(
        f"cornell {WIDTH}x{HEIGHT}, one pass", kept)
    del kept

    # the textured terrain on the LBVH at 720x720 against blocks
    terrain = _terrain("bvh")
    _lbvh_tree("textured terrain", terrain)
    bvh, build_ms = _once_ms(lambda: LB.build_lbvh(terrain.geom))
    print(f"phase 31: the terrain's LBVH built on the card in "
          f"{build_ms:.2f} ms")
    img, _, counts = _counted("textured terrain", terrain, cfg_t,
                              TERRAIN_SPP)
    label = (f"textured terrain {TERRAIN_RES}x{TERRAIN_RES} {TERRAIN_SPP} "
             "spp")
    launches[label] = _only(label, counts, "lbvh_traverse",
                            TERRAIN_SPP * (TERRAIN_BOUNCES + 1) * 3)
    _paths_agree("31", img, textured_img)
    with _all_calls(LB, "lbvh_traverse") as kept:
        _render_module().render(terrain, cfg_t, spp=1)
    per[f"textured terrain {TERRAIN_RES}x{TERRAIN_RES}, one pass's "
        "queries"] = _hold_lbvh(f"textured terrain {TERRAIN_RES}x"
                                f"{TERRAIN_RES}, one pass", kept)
    del kept, bvh

    # every LBVH query at 128x128 bit for bit, each arm
    small = _cornell_builder(ACCEL_SMALL, ACCEL_SMALL, "bvh").compile("cam")
    mats = materials_cornell_builder(ACCEL_SMALL, ACCEL_SMALL)
    mats.set_render_params({"scene_accelerator": "bvh"})
    runs = (("cornell", small, cfg, 2),
            ("materials cornell (transparent shadows)", mats.compile("cam"),
             make_integrator(MATERIALS_INTEGRATOR), 1),
            ("cornell with a moving instance (linear)",
             motion_cornell_builder(1, ACCEL_SMALL).compile("cam"), cfg, 2),
            ("cornell with a box on two keyframes (b-spline)",
             motion_cornell_builder(2, ACCEL_SMALL).compile("cam"), cfg, 2),
            ("instanced spheres and curves (sphere leaves)",
             accel_instances_builder(ACCEL_SMALL, "bvh").compile("cam"), cfg,
             2),
            ("textured terrain", _small(terrain, TERRAIN_CAMERA), cfg_t, 1))
    for label, scene, c, spp in runs:
        label = f"{label} {ACCEL_SMALL}x{ACCEL_SMALL} {spp} spp"
        if scene.accel_kind != "bvh":
            raise AssertionError(f"phase 31: {label}: not on the LBVH")
        launches[label], per[label] = _lbvh_paths(label, scene, c, spp)
    _ladder_overflow()
    edges = _lbvh_edges()
    print(f"phase 31: {edges} edge-case queries bit for bit")
    del terrain

    # brute force on the 203,522-face terrain (kernel a, no row cap)
    terrain = _terrain("brute")
    rows = terrain.geom.tri_table.shape[0]
    if rows != MT.table_rows(terrain.geom.num_faces):
        raise AssertionError("phase 31: the terrain's table is not packed")
    img, _, counts = _counted("textured terrain", terrain, cfg_t,
                              TERRAIN_SPP)
    label = (f"textured terrain {TERRAIN_RES}x{TERRAIN_RES} {TERRAIN_SPP} "
             f"spp on brute force ({rows} rows)")
    mt_launches = {label: _only(label, counts, "mt_closest",
                                TERRAIN_SPP * (TERRAIN_BOUNCES + 1) * 3)}
    _paths_agree("31", img, textured_img)
    with _all_calls(MT, "mt_closest") as kept:
        _render_module().render(terrain, cfg_t, spp=1)
    mt_rows = []
    for i, (a, k, _) in enumerate(kept):
        ms = _cuda_ms(lambda: MT.mt_closest(*a, **k), 2)
        live, kept_rows, bound, by = mt_bound(a, k)
        mt_rows.append((ms, bound, by))
        print(f"phase 31: brute-force terrain {TERRAIN_RES}x{TERRAIN_RES} "
              f"query {i} "
              f"({'shadow' if k.get('shadow') else 'closest'}): {live} live "
              f"rays x {kept_rows} rows: mt_closest {ms:.3f} ms, bound "
              f"{bound:.3f} ms ({by}), at {100 * bound / ms:.1f}% of it")
    del kept
    n = len(mt_rows)
    mt_big = dict(ms=sum(x[0] for x in mt_rows) / n,
                  bound_ms=sum(x[1] for x in mt_rows) / n,
                  bound_by=mt_rows[0][2])
    small_t = _small(terrain, TERRAIN_CAMERA)
    _zero_launches("mt_closest")
    with _all_calls(MT, "mt_closest") as kept:
        _render_module().render(small_t, cfg_t, spp=1)
    if _launches("mt_closest") != len(kept):
        raise AssertionError("phase 31: a kernel-a query escaped the check")
    mt_small = _hold_queries("31", kept, [
        f"brute-force terrain {ACCEL_SMALL}x{ACCEL_SMALL} query {i}"
        for i in range(len(kept))])
    mt_big["plain_ms_128"] = mt_small["plain_ms"]
    del kept, terrain, small_t

    # instanced spheres and curves on both accelerators, 512x512
    cfg3 = make_integrator({"type": "pathtracing", "bounces": 3})
    tl_launches = {}
    for accel, module, name, ref in (
            ("brute", MT, "mt_closest", MT.mt_closest_ref),
            ("blocks", TL, "tile_walk", TL.tile_walk_ref)):
        scene = accel_instances_builder(ACCEL_INST_RES, accel).compile("cam")
        g = scene.geom
        if scene.accel_kind != accel or g.num_spheres != 4:
            raise AssertionError("phase 31: the instanced spheres and curves "
                                 "did not compile as baked copies")
        label = (f"instanced spheres and curves {ACCEL_INST_RES}x"
                 f"{ACCEL_INST_RES} 2 spp on {accel}")
        img_k, _, counts = _counted(label, scene, cfg3, 2)
        kernel = "mt_closest" if accel == "brute" else "tiles_traverse"
        n = _only(label, counts, kernel)
        (mt_launches if accel == "brute" else tl_launches)[label] = n
        with _plain(module, name, ref):
            img_p = F.resolve(_render_module().render(
                scene, cfg3, spp=2)).cpu().numpy()
        _bit_for_bit("31", label, img_k, img_p)
        sph = g.sph_center.cpu().numpy()
        print(f"phase 31: {label}: {g.num_faces} triangles (the strand's "
              f"ribbon and its two baked copies), sphere centres "
              f"{sph.round(4).tolist()}, radii "
              f"{g.sph_radius.cpu().numpy().round(5).tolist()}, visibility "
              f"{g.sph_vis.tolist()}")
    return launches, per, mt_launches, dict(mt_big, **{
        "max_abs_err_128": mt_small["max_abs_err"]}), tl_launches


# ---------------------------------------------------------------- phase 32

SHARD_SMALL = 256        # phase 32: kernel against plain path, two ranks
SHARD_TERRAIN = 128      # the two ranks' textured terrain
SHARD_TRAIN_STEPS = 3    # the two ranks' train steps
SHARD_TRAIN_RTOL = 1e-5  # two block means against one image mean
FARM_RES, FARM_SPP = 256, 2   # each farm node's film
STATS_SPP = 4            # the stats render at 1080p


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _shard_terrain():
    from libyafaray_tpu_torch.scenes import bigmesh_builder
    b = bigmesh_builder(TERRAIN_GRID)
    b.cameras["cam"]["resx"] = b.cameras["cam"]["resy"] = SHARD_TERRAIN
    b.set_render_params({"scene_accelerator": "blocks"})
    return b.compile("cam")


def _sharded_outputs(mesh, out, label, kept=None):
    """The wavefronts and the train steps that phase 32 compares across
    meshes, on `mesh`, into the dict `out`: the Cornell box at 256x256
    (sample 0, 4 bounces), the textured terrain at 128x128 (sample 0, 2
    bounces; its tile_walk calls recorded into `kept` when given) and
    SHARD_TRAIN_STEPS train steps at 256x256 (phase 14's setup). Prints
    the launches of each."""
    import torch
    from libyafaray_tpu_torch import make_integrator
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.parallel import (make_train_step,
                                               render_wavefront_sharded)
    cornell = _cornell("brute", SHARD_SMALL, SHARD_SMALL)
    terrain = _shard_terrain()
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    cfg_t = make_integrator({"type": "pathtracing",
                             "bounces": TERRAIN_BOUNCES})
    _zero_launches("mt_closest", "tile_walk")
    rgb, alpha = render_wavefront_sharded(cornell, cfg, SHARD_SMALL,
                                          SHARD_SMALL, 0, mesh)
    torch.cuda.synchronize()
    out["cornell_rgb"], out["cornell_alpha"] = rgb.cpu(), alpha.cpu()
    out["cornell_launches"] = _launches("mt_closest")
    _zero_launches("mt_closest", "tile_walk")
    walks = (_kept_calls(TL, "tile_walk", range(1 << 40)) if kept is not None
             else contextlib.nullcontext([]))
    with walks as calls:
        rgb, alpha = render_wavefront_sharded(terrain, cfg_t, SHARD_TERRAIN,
                                              SHARD_TERRAIN, 0, mesh)
        torch.cuda.synchronize()
    if kept is not None:
        kept.extend(calls)
    out["terrain_rgb"], out["terrain_alpha"] = rgb.cpu(), alpha.cpu()
    out["terrain_launches"] = _launches("tile_walk")
    step = make_train_step(make_integrator({"type": "pathtracing",
                                            "bounces": 1}),
                           SMALL, SMALL, mesh)
    small = _cornell("brute", SMALL, SMALL)
    params = {"diffuse_color": small.materials.diffuse_color}
    target = torch.full((SMALL, SMALL, 3), 0.25, device=mesh.device)
    losses, steps = [], []
    for _ in range(SHARD_TRAIN_STEPS):
        params, loss = step(small, params, target, 0)
        losses.append(float(loss))
        steps.append(params["diffuse_color"].cpu())
    out["losses"], out["steps"] = losses, steps
    print(f"phase 32: {label}: cornell {SHARD_SMALL}x{SHARD_SMALL} wavefront "
          f"{out['cornell_launches']} mt_closest launches; textured terrain "
          f"{SHARD_TERRAIN}x{SHARD_TERRAIN} wavefront "
          f"{out['terrain_launches']} tile_walk launches; train losses "
          f"{losses}", flush=True)


def _rank_worker(rank: int, port: int, out_dir: str) -> None:
    """One of phase 32's two gloo ranks, a process of its own on cuda:0:
    the sharded wavefronts (the terrain's tile_walk calls held against
    tile_walk_ref), the train steps, and a render-farm node; writes its
    results to out_dir/rank<r>.pt."""
    import torch
    import libyafaray_tpu_torch  # noqa: F401
    from libyafaray_tpu_torch.parallel import distributed as D
    fresh = not torch.cuda.is_initialized()
    rank_, world = D.init_distributed(f"127.0.0.1:{port}", 2, rank,
                                      device="cuda:0", backend="gloo")
    from libyafaray_tpu_torch import csrc_build, make_integrator
    from libyafaray_tpu_torch.parallel import make_mesh
    build_s = csrc_build.build("mt_intersect", "tiles_traverse")
    mesh = make_mesh(device="cuda:0")
    print(f"phase 32: rank {rank_} of {world} on {mesh.device} "
          f"({torch.cuda.get_device_name(mesh.device)}), backend "
          f"{torch.distributed.get_backend()}; CUDA uninitialized after the "
          f"imports: {fresh}; kernels loaded in {build_s:.2f} s", flush=True)
    out, kept = {"fresh": fresh}, []
    _sharded_outputs(mesh, out, f"rank {rank_}", kept)
    held = _hold_walks("32", [(a, k, got) for a, k, got in kept],
                       [f"rank {rank_} terrain walk {i}"
                        for i in range(len(kept))])
    out["walk_err"] = held["max_abs_err"]
    D.render_node_film(_cornell("brute", FARM_RES, FARM_RES),
                       make_integrator({"type": "directlighting"}),
                       FARM_RES, FARM_RES, spp=FARM_SPP, node=rank_,
                       out_dir=os.path.join(out_dir, "farm"),
                       device="cuda:0")
    torch.save(out, os.path.join(out_dir, f"rank{rank_}.pt"))
    torch.distributed.destroy_process_group()


def _equal(label, got, want):
    import torch
    if not torch.equal(got.cpu(), want.cpu()):
        diff = (got.cpu() - want.cpu()).abs().max()
        raise AssertionError(f"phase 32: {label}: not bit for bit (max "
                             f"|diff| {float(diff)})")


def _sharded_main(mesh, cornell_ms):
    """(a): render_sharded of the Cornell box at 1080p on the one-rank NCCL
    mesh; returns (mt_closest launches, ms a pass, collective ms a pass)."""
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.parallel import (Mesh, _pixel_shard_radiance,
                                               render_sharded)
    from libyafaray_tpu_torch.render import pixel_jitter
    scene = _cornell("brute", WIDTH, HEIGHT)
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    render_sharded(scene, cfg, WIDTH, HEIGHT, 1, mesh)      # warm-up pass
    torch.cuda.synchronize()
    events, real = [], Mesh.all_gather

    def timed(self, x):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        y = real(self, x)
        ev[1].record()
        events.append(ev)
        return y

    Mesh.all_gather = timed
    try:
        _zero_launches("mt_closest")
        t0 = time.perf_counter()
        film = render_sharded(scene, cfg, WIDTH, HEIGHT, SPP, mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = _launches("mt_closest")
    finally:
        Mesh.all_gather = real
    coll_ms = sum(a.elapsed_time(z) for a, z in events) / SPP
    ms = seconds * 1e3 / SPP
    want = SPP * (BOUNCES + 1) * 2
    if launches != want:
        raise AssertionError(f"phase 32: render_sharded launched mt_closest "
                             f"{launches} times, want {want}")
    # the same passes with no mesh: the body over every pixel, added at the
    # pixel centres
    ref = F.make_film(WIDTH, HEIGHT)
    pid = torch.arange(WIDTH * HEIGHT, device=DEVICE)
    cx = (pid % WIDTH).float() + 0.5
    cy = (pid // WIDTH).float() + 0.5
    ones = torch.ones(WIDTH * HEIGHT, device=DEVICE)
    for s in range(SPP):
        px, py = pixel_jitter(pid, s, WIDTH)
        rgb, alpha, _ = _pixel_shard_radiance(scene, cfg, px, py, pid, s)
        ref = F.add_samples(ref, cx, cy, {"combined": torch.cat(
            [rgb, alpha[:, None]], 1)}, ones)
    _equal("render_sharded at 1080p against the unsharded passes",
           film.layers["combined"], ref.layers["combined"])
    _equal("its weights", film.weights, ref.weights)
    img = F.resolve(film)[..., :3].cpu().numpy()
    print(f"phase 32: (a) render_sharded on the one-rank NCCL mesh, cornell "
          f"{WIDTH}x{HEIGHT} {SPP} spp {BOUNCES} bounces: {ms:.2f} ms a pass "
          f"(phase 4's render {cornell_ms:.2f}), the all_gather "
          f"{coll_ms:.4f} ms a pass (CUDA events), {launches} mt_closest "
          f"launches; the film bit for bit equal to the same passes through "
          f"_pixel_shard_radiance and add_samples with no mesh; image mean "
          f"{float(img.mean()):.6f}", flush=True)
    # kernel path against plain path at 256x256, 2 spp
    small = _cornell("brute", SMALL, SMALL)
    film_k = render_sharded(small, cfg, SMALL, SMALL, 2, mesh)
    with _plain(MT, "mt_closest", MT.mt_closest_ref):
        film_p = render_sharded(small, cfg, SMALL, SMALL, 2, mesh)
    _equal("render_sharded kernel path against plain path at 256x256",
           film_k.layers["combined"], film_p.layers["combined"])
    print(f"phase 32: (a) render_sharded {SMALL}x{SMALL} 2 spp: kernel path "
          "equal to plain path bit for bit", flush=True)
    return launches, ms, coll_ms


def phase32_multi_device(cornell_ms, train_steps):
    """Multi-device rendering and observability. Returns (mt_closest
    launches by path, tiles_traverse launches by path, the walks' max
    error, the profiled pass's numbers)."""
    import numpy as np
    import tempfile
    import torch
    from libyafaray_tpu_torch import film as F
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import mt_intersect as MT
    from libyafaray_tpu_torch.parallel import make_mesh, make_train_step
    from libyafaray_tpu_torch.parallel import distributed as D
    from libyafaray_tpu_torch.utils import profiling as PF
    rank, world = D.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                                     device="cuda:0", backend="nccl")
    mesh = make_mesh()
    print(f"phase 32: one-rank mesh: rank {rank} of {world}, backend "
          f"{torch.distributed.get_backend()}, device {mesh.device}",
          flush=True)
    mt, tl = {}, {}
    try:
        a_launches, a_ms, coll_ms = _sharded_main(mesh, cornell_ms)
        mt[f"cornell render_sharded {WIDTH}x{HEIGHT} {SPP} spp on a "
           "one-rank NCCL mesh"] = a_launches
        # (b) the train step on the one-rank mesh against phase 14's
        losses, steps = train_steps
        step = make_train_step(make_integrator({"type": "pathtracing",
                                                "bounces": 1}),
                               SMALL, SMALL, mesh)
        scene = _cornell("brute", SMALL, SMALL)
        params = {"diffuse_color": scene.materials.diffuse_color}
        target = torch.full((SMALL, SMALL, 3), 0.25, device=DEVICE)
        for i in range(TRAIN_STEPS):
            params, loss = step(scene, params, target, 0)
            if float(loss) != losses[i]:
                raise AssertionError(f"phase 32: (b) step {i}: loss "
                                     f"{float(loss)} against phase 14's "
                                     f"{losses[i]}")
            _equal(f"(b) step {i}'s parameters against phase 14's",
                   params["diffuse_color"], steps[i])
        print(f"phase 32: (b) make_train_step on the one-rank mesh, "
              f"{SMALL}x{SMALL}, {TRAIN_STEPS} steps: losses and parameters "
              "bit for bit equal to phase 14's (mesh=None)", flush=True)
        # (c) and (d): two gloo ranks in two processes on the card
        with tempfile.TemporaryDirectory() as tmp:
            port = _free_port()
            root = os.path.dirname(os.path.abspath(__file__))
            code = (f"import sys; sys.path.insert(0, {root!r}); "
                    "import chip_smoke; chip_smoke._rank_worker("
                    f"int(sys.argv[1]), {port}, {tmp!r})")
            t0 = time.perf_counter()
            procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for r in range(2)]
            one = {}
            _sharded_outputs(mesh, one, "one rank (NCCL)")
            logs = []
            for p in procs:
                try:
                    logs.append(p.communicate(timeout=600)[0])
                finally:
                    if p.poll() is None:
                        p.kill()
            ranks_s = time.perf_counter() - t0
            for r, (p, log) in enumerate(zip(procs, logs)):
                print(log, end="", flush=True)
                if p.returncode != 0:
                    raise AssertionError(f"phase 32: rank {r} failed "
                                         f"(exit {p.returncode})")
            outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                    for r in range(2)]
            for r, o in enumerate(outs):
                if not o["fresh"]:
                    raise AssertionError(f"phase 32: rank {r}: importing the "
                                         "port initialized CUDA")
                for k in ("cornell_rgb", "cornell_alpha", "terrain_rgb",
                          "terrain_alpha"):
                    _equal(f"(c) rank {r}'s {k} against one rank", o[k],
                           one[k])
                np.testing.assert_allclose(o["losses"], one["losses"],
                                           rtol=SHARD_TRAIN_RTOL)
                for i in range(SHARD_TRAIN_STEPS):
                    np.testing.assert_allclose(
                        o["steps"][i].numpy(), one["steps"][i].numpy(),
                        rtol=SHARD_TRAIN_RTOL)
                    _equal(f"(c) rank {r} step {i} against rank 0",
                           o["steps"][i], outs[0]["steps"][i])
                if o["terrain_launches"] == 0 or o["cornell_launches"] == 0:
                    raise AssertionError(f"phase 32: rank {r} launched no "
                                         "kernel")
                tl[f"textured terrain wavefront {SHARD_TERRAIN}x"
                   f"{SHARD_TERRAIN}, rank {r} of two gloo ranks"] = \
                    o["terrain_launches"]
                mt[f"cornell wavefront {SHARD_SMALL}x{SHARD_SMALL}, rank {r} "
                   "of two gloo ranks"] = o["cornell_launches"]
            rel = max(float(np.max(np.abs(np.asarray(o["losses"])
                                          - one["losses"])
                                   / np.asarray(one["losses"])))
                      for o in outs)
            print(f"phase 32: (c) two gloo ranks on cuda:0 ({ranks_s:.1f} s "
                  "with process start): each rank's cornell and textured "
                  "terrain wavefronts bit for bit equal to one rank's, the "
                  f"terrain's tile_walk calls held against tile_walk_ref; "
                  f"{SHARD_TRAIN_STEPS} train steps within rtol "
                  f"{SHARD_TRAIN_RTOL} of one rank's (loss max rel diff "
                  f"{rel:.3g}), equal across ranks", flush=True)
            walk_err = max(o["walk_err"] for o in outs)
            # (d) the render farm: the two nodes' folder merge
            merged, offset = F.load_all_in_folder(os.path.join(tmp, "farm"))
        cfg = make_integrator({"type": "directlighting"})
        farm = _cornell("brute", FARM_RES, FARM_RES)
        nodes = [D.render_node_film(farm, cfg, FARM_RES, FARM_RES,
                                    spp=FARM_SPP, node=n) for n in (0, 1)]
        img_m = F.resolve(merged).cpu().numpy()
        img_r = F.resolve(F.merge(nodes)).cpu().numpy()
        a, b = (F.resolve(n).cpu().numpy() for n in nodes)
        err, apart = float(np.abs(img_m - img_r).max()), float(
            np.abs(a - b).max())
        print(f"phase 32: (d) render farm: two processes' render_node_film "
              f"{FARM_RES}x{FARM_RES} {FARM_SPP} spp merged by "
              f"load_all_in_folder (offset {offset}) against the in-process "
              f"merge: max |diff| {err:.3g} (bound 1e-5); the nodes' images "
              f"differ by {apart:.4g}", flush=True)
        if not err <= 1e-5 or not apart > 1e-4:
            raise AssertionError("phase 32: (d) the render farm's merge is "
                                 "wrong or its nodes are correlated")
    finally:
        torch.distributed.destroy_process_group()
    # (e) observability: RenderStats through render, the profiler's summary
    scene = _cornell("brute", WIDTH, HEIGHT)
    cfg = make_integrator({"type": "pathtracing", "bounces": BOUNCES})
    stats = PF.RenderStats()
    _zero_launches("mt_closest")
    render(scene, cfg, spp=STATS_SPP, stats=stats)
    stats_launches = _launches("mt_closest")
    mt[f"cornell render with stats {WIDTH}x{HEIGHT} {STATS_SPP} spp"] = \
        stats_launches
    summary = stats.summary()
    print("phase 32: (e) render(..., stats=RenderStats()):\n" + summary,
          flush=True)
    rays = WIDTH * HEIGHT * STATS_SPP
    if (f"passes: {STATS_SPP}" not in summary.splitlines()
            or f"camera rays: {rays}" not in summary.splitlines()):
        raise AssertionError("phase 32: (e) the stats summary is wrong")
    real, events = MT.mt_closest, []

    def timed(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*a, **k)
        ev[1].record()
        events.append(ev)
        return out

    with tempfile.TemporaryDirectory() as log_dir:
        MT.mt_closest = timed
        try:
            _zero_launches("mt_closest")
            with PF.trace(log_dir):
                render(scene, cfg, spp=1, start_sample=STATS_SPP)
            traced = _launches("mt_closest")
        finally:
            MT.mt_closest = real
        top = PF.device_op_summary(log_dir, top=1 << 20)
    event_ms = sum(a.elapsed_time(z) for a, z in events)
    mine = [(n, ms, c) for n, ms, c in top if "mt_closest_kernel" in n]
    count = sum(c for _, _, c in mine)
    prof_ms = sum(ms for _, ms, _ in mine)
    print(f"phase 32: (e) one traced pass: {len(top)} device op names, "
          f"{sum(c for _, _, c in top)} device events, "
          f"{sum(ms for _, ms, _ in top):.2f} ms of device time; the "
          f"heaviest: " + "; ".join(f"{n[:60]} {ms:.3f} ms x{c}"
                                    for n, ms, c in top[:4]), flush=True)
    print(f"phase 32: (e) mt_closest_kernel in the profiler's summary: "
          f"{count} launches, {prof_ms:.4f} ms; counted {traced}; the "
          f"same launches between CUDA events {event_ms:.4f} ms", flush=True)
    if count != traced or traced != (BOUNCES + 1) * 2:
        raise AssertionError(f"phase 32: (e) the profiler counts {count} "
                             f"mt_closest_kernel launches, the counter "
                             f"{traced}, want {(BOUNCES + 1) * 2}")
    return mt, tl, walk_err, dict(ms_per_pass=a_ms, collective_ms=coll_ms,
                                  stats_rays=rays, profiled_ms=prof_ms,
                                  event_ms=event_ms)


# ---------------------------------------------------------------- phase 33

# fp32 instructions of one ray-block slab test in the prepass kernel: 6
# differences, 6 products, 10 min / max, 3 comparisons, the entry's max and
# the running min (no multiply-add: each counts once at the FMA pipe's
# instruction rate, half PEAK_FP32)
PREPASS_INSTR = 27
N_PREPASS_BIG = 5000     # random boxes: more blocks than the shared sort


def _prepass_case(label, args, cover, reps=10):
    """tile_candidates on the card (its kernel) against tile_candidates_ref
    on one query's (bmin, bmax, o, d, t_min, t_max): cand, ent and count
    equal (torch.equal); the kernel's ms beside its bounds and the plain
    version's ms. Returns the numbers."""
    import torch
    from libyafaray_tpu_torch.accel import tiles as TL
    before = _launches("tile_candidates")
    got = TL.tile_candidates(*args, any_hit=cover)
    if _launches("tile_candidates") != before + 1:
        raise AssertionError(f"phase 33: {label}: the prepass kernel did "
                             "not launch")
    want, plain_ms = _once_ms(lambda: TL.tile_candidates_ref(*args,
                                                             any_hit=cover))
    for name, g, w in zip(("cand", "ent", "count"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"phase 33: {label}: {name} differs from tile_candidates_ref "
                f"at {int((g != w).sum())} entries")
    ms = _cuda_ms(lambda: TL.tile_candidates(*args, any_hit=cover), reps)
    t, c_pad = got[0].shape
    c = args[0].shape[0]
    tile_live = (args[5].reshape(t, -1) >= args[4].reshape(t, -1)).any(1)
    live = int(tile_live.sum())
    # the pair tests these inputs need: every tile of a live chunk
    g = TL._chunk_tiles(t, c)
    chunk_live = torch.nn.functional.pad(tile_live, (0, -t % g)).reshape(
        -1, g).any(1)
    tested = sum(min(t, (k + 1) * g) - k * g
                 for k in chunk_live.nonzero()[:, 0].tolist())
    pairs = tested * TL.RAY_TILE * c
    nbytes = t * c_pad * 8 + t * 4 + t * TL.RAY_TILE * 32 + c * 24
    bound, by = _bound_ms(pairs * PREPASS_INSTR, nbytes)
    instr_ms = pairs * PREPASS_INSTR / (PEAK_FP32 / 2) * 1e3
    count = got[2]
    out = dict(tiles=t, live_tiles=live, tested_tiles=tested, blocks=c,
               candidates_per_live_tile=float(count.sum()) / max(live, 1),
               most_candidates=int(count.max()), pair_tests=pairs, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               instruction_bound_ms=instr_ms,
               lists_ms=(t * c_pad * 8) / PEAK_BYTES * 1e3)
    print(f"phase 33: {label} ({'cover' if cover else 'front to back'}): "
          f"{t} tiles ({live} live, {tested} in live chunks), {c} blocks, "
          f"{out['candidates_per_live_tile']:.3f} candidates a live tile "
          f"(most {out['most_candidates']}), lists equal; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.3f} ms; bound {bound:.4f} ms ({by}; {pairs:,} "
          f"pair tests x {PREPASS_INSTR} at 67 TFLOP/s), {instr_ms:.4f} ms at "
          f"33.5 T instructions/s, the lists {out['lists_ms']:.4f} ms at "
          f"3.35 TB/s")
    return out


def _dead_chunk_query(args):
    """The camera query with tile 3 dead in a live chunk (its rays starting
    inside blocks, t_max just below t_min: they still make candidates) and
    the 101st chunk of tiles dead throughout."""
    from libyafaray_tpu_torch.accel import tiles as TL
    bmin, bmax, o, d, t_min, t_max = (x.clone() for x in args)
    t_min = t_min.expand(o.shape[0]).contiguous()
    t_max = t_max.expand(o.shape[0]).contiguous()
    r = slice(3 * TL.RAY_TILE, 4 * TL.RAY_TILE)
    o[r] = 0.5 * (bmin[:TL.RAY_TILE] + bmax[:TL.RAY_TILE])
    t_min[r] = 0.0
    t_max[r] = -1e-3
    g = TL._chunk_tiles(o.shape[0] // TL.RAY_TILE, bmin.shape[0])
    t_max[100 * g * TL.RAY_TILE:101 * g * TL.RAY_TILE] = -1.0
    return (bmin, bmax, o, d, t_min, t_max), g


def _big_boxes(device, n_tiles=16, seed=33):
    """N_PREPASS_BIG random boxes up to 3 wide in [-2, 2]^3 and rays from
    inside the cloud: most tiles list more blocks than the shared sort
    holds."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    u = lambda *s: torch.rand(*s, generator=gen)
    ctr, ext = 4 * u(N_PREPASS_BIG, 3) - 2, 0.01 + 2.99 * u(N_PREPASS_BIG, 3)
    n = n_tiles * 128
    d = torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.full((n,), 1e30)
    t_max[::7] = -1.0
    return tuple(x.to(device) for x in (
        ctr - ext, ctr + ext, u(n, 3) - 0.5, d, torch.full((n,), 1e-4),
        t_max))


def phase33_prepass(textured, forest):
    """The block prepass kernel against tile_candidates_ref. Returns the
    kernels line's entry."""
    import torch
    from libyafaray_tpu_torch import make_integrator, render
    from libyafaray_tpu_torch.accel import tiles as TL
    cfg = make_integrator({"type": "pathtracing",
                           "bounces": TERRAIN_BOUNCES})
    launches = _launches("tile_candidates")
    with _kept_calls(TL, "tile_candidates", set(range(64))) as kept:
        render(textured, cfg, spp=1)
    launches = _launches("tile_candidates") - launches
    want = 3 * (TERRAIN_BOUNCES + 1)
    if len(kept) != want or launches != want:
        raise AssertionError(f"phase 33: a textured terrain pass made "
                             f"{len(kept)} prepass calls and {launches} "
                             f"kernel launches, want {want}")
    per = {}
    for i, (a, k, _) in enumerate(kept):
        for cover in (False, True):
            per[f"textured terrain {TERRAIN_RES}x{TERRAIN_RES} query {i}"
                + (" cover" if cover else "")] = _prepass_case(
                    f"textured terrain query {i}", a, cover)
    dead, g = _dead_chunk_query(kept[0][0])
    for cover in (False, True):
        row = _prepass_case(f"camera query, tile 3 dead, chunk 100 of {g} "
                            "tiles dead", dead, cover)
        got = TL.tile_candidates(*dead, any_hit=cover)
        if not (int(got[2][3]) > 0
                and (got[2][100 * g:101 * g] == 0).all()):
            raise AssertionError("phase 33: the dead tile must list its "
                                 "blocks and the dead chunk none")
        per["dead chunk" + (" cover" if cover else "")] = row
    with _kept_calls(TL, "tile_candidates", {0}) as kept_f:
        render(forest, cfg, spp=1)
    big = _big_boxes(DEVICE)
    for cover in (False, True):
        per["forest camera query" + (" cover" if cover else "")] = \
            _prepass_case("forest camera query (virtual blocks)",
                          kept_f[0][0], cover)
        row = _prepass_case(f"{N_PREPASS_BIG} random boxes", big, cover,
                            reps=3)
        if row["most_candidates"] <= 4096:
            raise AssertionError("phase 33: the random boxes must pass the "
                                 "shared sort's 4,096 entries")
        per[f"{N_PREPASS_BIG} random boxes" + (" cover" if cover else "")] \
            = row
    torch.cuda.synchronize()
    main = per[f"textured terrain {TERRAIN_RES}x{TERRAIN_RES} query 0"]
    queries = [v for k, v in per.items()
               if k.startswith("textured terrain") and "cover" not in k]
    print(f"phase 33: one textured terrain pass's {len(queries)} queries: "
          f"kernel {sum(q['ms'] for q in queries):.3f} ms in all, plain "
          f"{sum(q['plain_ms'] for q in queries):.3f} ms, bound "
          f"{sum(q['bound_ms'] for q in queries):.4f} ms")
    return {"name": "tile_candidates", "route": "cuda",
            "source": "libyafaray_tpu_torch/csrc/tiles_traverse.cu",
            "replaces": "none: the JAX package builds the lists with XLA "
                        "ops (libyafaray_tpu/accel/tiles.py tile_candidates)",
            "launches": launches,
            "max_abs_err": 0.0,
            "timed_on": f"the textured terrain's {TERRAIN_RES}x{TERRAIN_RES} "
                        "camera query",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "per_launch_by_path": per}


# ---------------------------------------------------------------- phase 34

def _train_takes(scene, names, res, bounces, seed):
    """The (idx, g, rows) of every take backward of one make_train_step
    step on `names` at res x res (the benchmark's train and grad cells'
    step), captured as they reach take_grad, and the kernel's launches
    counted meanwhile."""
    import torch
    from libyafaray_tpu_torch import make_integrator, make_train_step
    from libyafaray_tpu_torch.ops import fast_grad as FG
    every = {"diffuse_color": lambda: scene.materials.diffuse_color,
             "ior": lambda: scene.materials.ior,
             "textures.texel_pool": lambda: scene.textures.texel_pool}
    params = {k: every[k]().clone() for k in names}
    step = make_train_step(make_integrator({"type": "pathtracing",
                                            "bounces": bounces}),
                           res[1], res[0], lr=0.05, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    target = 0.5 * torch.rand((res[1], res[0], 3), generator=gen,
                              device=DEVICE)
    kept, real = [], FG.take_grad

    def keep(idx, g, rows):
        kept.append((idx.clone(), g.clone(), rows))
        return real(idx, g, rows)

    before = _launches("take_grad")
    FG.take_grad = keep
    try:
        step(scene, params, target, 0)
        torch.cuda.synchronize()
    finally:
        FG.take_grad = real
    if _launches("take_grad") - before != len(kept) or not kept:
        raise AssertionError(f"phase 34: {len(kept)} takes, "
                             f"{_launches('take_grad') - before} kernel "
                             "reductions")
    return kept


QUEUE_SLEEP = 500_000_000   # cycles of the sleeping kernel of _queued_ms


def _queued_ms(fn, reps: int) -> float:
    """Device ms a call of fn(): `reps` calls queued behind a sleeping
    kernel, so that CUDA events time the device's work back to back and
    not the host's dispatch. (The profiler, late in this script's run,
    loses the device events of windows this short.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise AssertionError("the calls were not all queued before the "
                             "sleeping kernel ended")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _take_case(label, idx, g, rows, reps=20):
    """take_grad on the card against the float64 sums and onehot_grad, the
    same bits twice; its device ms a call (`_queued_ms` over `reps` calls)
    and kernels a call (counted, held to the layout's) beside the bound (each lane's index and gradient
    read once, the table written once, at 3.35 TB/s), the plain version's
    device ms, and the library yardstick: the one-hot `bmm`s of
    onehot_grad alone on a one-hot built beforehand."""
    import torch
    from libyafaray_tpu_torch.csrc_build import launch_counts
    from libyafaray_tpu_torch.ops import fast_grad as FG
    n = idx.shape[0]
    g2 = g.reshape(n, -1).float()
    cols = g2.shape[1]
    got = FG.take_grad(idx, g, rows)
    if not torch.equal(got, FG.take_grad(idx, g, rows)):
        raise AssertionError(f"phase 34: {label}: two calls differ")
    exact = torch.zeros((rows, cols), dtype=torch.float64, device=DEVICE
                        ).index_add_(0, idx, g2.double())
    mag = torch.zeros_like(exact).index_add_(0, idx, g2.double().abs())
    plain = FG.onehot_grad(idx, g, rows)
    scaled = lambda x: float(((x.reshape(rows, -1).double() - exact).abs()
                              / mag.clamp_min(1e-30)).max())
    err, plain_err = scaled(got), scaled(plain)
    ms = _queued_ms(lambda: FG.take_grad(idx, g, rows), reps)
    plain_ms = _queued_ms(lambda: FG.onehot_grad(idx, g, rows), 1)
    # the library call: the bmms of onehot_grad on its one-hot, built here
    chunk = FG._GRAD_CHUNK
    npad = -(-n // chunk) * chunk
    ip = torch.cat([idx, idx.new_full((npad - n,), rows)]).reshape(-1, chunk)
    gp = torch.cat([g2, g2.new_zeros((npad - n, cols))]).reshape(
        ip.shape[0], chunk, cols)
    onehot = (ip[:, None, :] == torch.arange(rows, device=DEVICE)[None, :, None]
              ).float()
    group = max(1, FG._ONEHOT_ELEMS // (chunk * rows))
    bmms = lambda: [torch.bmm(onehot[c:c + group], gp[c:c + group])
                    for c in range(0, ip.shape[0], group)]
    library_ms = _queued_ms(bmms, 1)
    del onehot
    bound_ms, bound_by = _bound_ms(n * cols, n * (8 + 4 * cols)
                                   + rows * 4 * cols)
    warps, blocks, cw, split = FG.take_grad_layout(rows, cols, n,
                                                   FG._sm_count(idx.device))
    # the kernels a call, as the C entry reports them: the reduce, then
    # the combine where the layout splits the lanes over blocks
    before = launch_counts["kernel.take_grad.kernels"]
    FG.take_grad(idx, g, rows)
    kernels = launch_counts["kernel.take_grad.kernels"] - before
    if kernels != (2 if blocks > 1 else 1):
        raise AssertionError(f"phase 34: {label}: {kernels} kernels a call "
                             f"at {blocks} blocks")
    print(f"phase 34: {label}: {n} lanes x {cols} onto {rows} rows: kernel "
          f"{ms:.4f} ms a call ({kernels} kernels, counted; {warps} warps x "
          f"{blocks} blocks, {cw} columns a block, split {split}), bound "
          f"{bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f}% of it); "
          f"onehot_grad {plain_ms:.4f} ms, its bmms alone "
          f"{library_ms:.4f} ms; error over the row's sum |g|: kernel "
          f"{err:.3g}, onehot_grad {plain_err:.3g}; the same bits twice")
    if err > 1e-5 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"phase 34: {label}: the kernel misses the sums")
    return dict(lanes=n, cols=cols, rows=rows, ms=ms,
                launches_a_call=kernels, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_err=err, plain_max_err=plain_err)


def phase34_take_grad():
    """take_grad (csrc/take_grad.cu) on every take backward of one train
    step of the Cornell box at 1920x1080 (diffuse_color, 4 bounces) and of
    the caustic scene at 512x512 (ior and the texel pool, 5 bounces),
    captured as they reach take_grad; the first texel-pool and the first
    diffuse_color take timed and held as `_take_case` says, every other
    one held against the float64 sums. Returns the kernels line's entry."""
    import torch
    from libyafaray_tpu_torch.ops import fast_grad as FG
    from libyafaray_tpu_torch.scenes import caustic_grad_builder
    _check_fp32_precision()
    cornell = _cornell_builder(WIDTH, HEIGHT).compile("cam")
    caustic = caustic_grad_builder(CAUSTIC_RES, CAUSTIC_RES).compile("cam")
    _zero_launches("take_grad")
    takes = {"cornell": _train_takes(cornell, ["diffuse_color"],
                                     (WIDTH, HEIGHT), BOUNCES, 21),
             "caustic": _train_takes(caustic, ["ior", "textures.texel_pool"],
                                     (CAUSTIC_RES, CAUSTIC_RES),
                                     CAUSTIC_BOUNCES, 24)}
    launches = _launches("take_grad")
    worst = 0.0
    for scene, kept in takes.items():
        for idx, g, rows in kept:
            g2 = g.reshape(idx.shape[0], -1).double()
            exact = torch.zeros((rows, g2.shape[1]), dtype=torch.float64,
                                device=DEVICE).index_add_(0, idx, g2)
            mag = torch.zeros_like(exact).index_add_(0, idx, g2.abs())
            got = FG.take_grad(idx, g, rows).reshape(rows, -1).double()
            worst = max(worst, float(((got - exact).abs()
                                      / mag.clamp_min(1e-30)).max()))
        print(f"phase 34: {scene} train step: {len(kept)} take backwards "
              f"({sorted({k[2] for k in kept})} rows, "
              f"{sorted({k[0].shape[0] for k in kept})} lanes)")
    if worst > 1e-5:
        raise AssertionError(f"phase 34: a take misses its sums ({worst:.3g})")
    texel = next(k for k in takes["caustic"] if k[2] > 100)
    diffuse = next(k for k in takes["cornell"] if k[1].dim() == 2)
    per = {f"caustic {CAUSTIC_RES}x{CAUSTIC_RES} texel pool":
               _take_case("caustic texel pool", *texel),
           f"cornell {WIDTH}x{HEIGHT} diffuse_color":
               _take_case("cornell diffuse_color", *diffuse)}
    print(f"phase 34: {launches} kernel reductions in the two steps; every "
          f"take within {worst:.3g} of its row's sum |g| of the float64 sums")
    main = per[f"caustic {CAUSTIC_RES}x{CAUSTIC_RES} texel pool"]
    return {"name": "take_grad", "route": "cuda",
            "source": "libyafaray_tpu_torch/csrc/take_grad.cu",
            "replaces": "none: the JAX package leaves take's one-hot "
                        "backward to XLA's dot_general "
                        "(libyafaray_tpu/ops/fast_grad.py)",
            "launches": launches, "max_abs_err": worst,
            "timed_on": "the caustic train step's first texel-pool take, "
                        "device ms a call between CUDA events, the "
                        "calls queued behind a sleeping kernel",
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "per_launch_by_path": per}


def _probe():
    """Phase 1's probe of shared memory (kernel d); returns its numbers."""
    import torch
    from libyafaray_tpu_torch.accel import probe_smem as PR
    out, nbytes = PR.probe_smem(DEVICE)
    torch.cuda.synchronize()
    limit = PR.optin_limit(DEVICE)
    err = float((out - 2.0).abs().max())
    print(f"phase 1: shared-memory probe: the largest launch took {nbytes} "
          f"bytes ({nbytes // 1024} KiB) of dynamic shared memory; the card's "
          f"opt-in limit per block is {limit} bytes; output max |x - 2| {err}")
    if nbytes != limit or err != 0.0:
        raise AssertionError("the probe disagrees with the card's limit or "
                             "its output is not exactly 2.0")
    ms = _cuda_ms(lambda: PR.launch(nbytes, DEVICE), 20)
    plain_ms = _cuda_ms(lambda: PR.probe_smem_ref(DEVICE), 20)
    # the launch floor: one PyTorch fill of one element, timed alike
    one = torch.empty(1, device=DEVICE)
    floor_ms = _cuda_ms(lambda: one.fill_(1.0), 20)
    print(f"phase 1: probe_smem {ms:.4f} ms a launch; a one-element fill "
          f"{floor_ms:.4f} ms (the launch floor)")
    # the output written once; 2 x 1024 stores and 1024 additions
    bound = _bound_ms(8 * 128, 8 * 128 * 4)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1], launch_floor_ms=floor_ms)


def _timed(phase, fn, *args):
    """fn(*args), with the phase's seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from libyafaray_tpu_torch import csrc_build
    from libyafaray_tpu_torch.accel import tiles as TL
    from libyafaray_tpu_torch.scenes import (bigmesh_builder, cornell_builder,
                                             forest_builder)

    # phase 2's build runs first: phase 1's probe launches a kernel
    names = ("mt_intersect", "tiles_traverse", "lbvh_traverse", "probe_smem",
             "take_grad")
    build_s = csrc_build.build(*names)

    # ---- phase 1: environment and the shared-memory probe
    smi = _cmd("nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader")
    nvcc = _cmd(csrc_build.nvcc(), "--version").splitlines()[-1]
    print(f"phase 1: torch {torch.__version__}, torch CUDA "
          f"{torch.version.cuda}, nvcc: {nvcc}")
    print(smi)
    from libyafaray_tpu_torch.utils.sysinfo import sysinfo_string
    print(f"phase 1: {sysinfo_string()}")
    probe = _probe()

    # ---- phase 2: the five sources, one nvcc each, all started together
    print(f"phase 2: built {', '.join(n + '.cu' for n in names)} in "
          f"{build_s:.2f} s ({' '.join(csrc_build.NVCC_FLAGS)})")
    t0 = time.perf_counter()
    terrain = bigmesh_builder(TERRAIN_GRID, textured=False).compile("cam")
    print(f"phase 2: compiled the terrain scene in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    forest = forest_builder(FOREST_INST, FOREST_MOVING,
                            TERRAIN_GRID).compile("cam")
    print(f"phase 2: compiled the forest scene in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    textured = bigmesh_builder(TERRAIN_GRID).compile("cam")
    print(f"phase 2: compiled the textured terrain scene in "
          f"{time.perf_counter() - t0:.2f} s")
    cornell = cornell_builder().compile("cam")
    mt_err, mt_times, mt_bnd = _timed("3", phase3_mt, cornell, *hd_scenes())
    tl_err, tl_times, tl_bound, big = _timed("3b", phase3b_tiles, terrain)
    arm_err, arm_times = _timed("3c", phase3c_arms, forest,
                                tl_times["camera"][0])
    mt_launches, cornell_ms = _timed("4", phase4_cornell)
    _timed("5", phase5_cornell_paths)
    terrain_img, terrain_launches = _timed("6", phase6_terrain, terrain)
    from libyafaray_tpu_torch.scenes import TERRAIN_CAMERA
    _timed("7", _kernel_vs_plain, "7", terrain, TERRAIN_CAMERA)
    forest_launches, forest_arms = _timed("8", phase8_forest, forest,
                                          terrain_img)
    _timed("9", _kernel_vs_plain, "9", forest, TERRAIN_CAMERA)
    _timed("10", phase10_golden)
    fwd_bwd_launches, mt_chunk = _timed("11", phase11_fwd_bwd)
    grad_tile_launches = _timed("12", phase12_grad_paths, terrain)
    glossy_launches = _timed("13", phase13_glossy)
    train_steps = _timed("14", phase14_train)
    _timed("15", phase15_cornell_golden)
    textured_img, textured_launches = _timed(
        "16", phase16_textured, textured, terrain, terrain_img)
    cover_arms, cover_launches = _timed("17", phase17_cover, textured, forest,
                                        textured_img)
    texel_launches = _timed("18", phase18_texel_grads, textured)
    caustic_launches, mt_caustic = _timed("19", phase19_caustic)
    volume_launches, mt_volume = _timed("20", phase20_volume)
    camera_launches = _timed("21", phase21_cameras)
    sky_launches = _timed("22", phase22_skies)
    sphere_mt, sphere_tiles = _timed("23", phase23_spheres)
    mats_launches, mt_walk, tl_walk_err = _timed("24", phase24_materials)
    portal_launches = _timed("25", phase25_portal)
    proc_launches = _timed("26", phase26_procedural)
    vol_launches, mt_regions = _timed("27", phase27_volumes)
    aov_launches, aov_tiles, aov_per, aov_walk = _timed("28", phase28_aov)
    int_launches, int_per, int_walk = _timed("29", phase29_integrators)
    pm_size = lambda label: (f"{CAUSTIC_PM_RES}x{CAUSTIC_PM_RES}"
                             if "caustic" in label else "1920x1080")
    capi_mt, capi_tl, capi_per_a, capi_per_b = _timed(
        "30", phase30_entry_points, terrain_img)
    (lbvh_launches, lbvh_per, accel_mt, mt_terrain,
     accel_tl) = _timed("31", phase31_accelerators, textured_img)
    shard_mt, shard_tl, shard_walk_err, shard = _timed(
        "32", phase32_multi_device, cornell_ms, train_steps)
    prepass_kernel = _timed("33", phase33_prepass, textured, forest)
    take_kernel = _timed("34", phase34_take_grad)
    lbvh_main = f"cornell {WIDTH}x{HEIGHT} {SPP} spp"
    lbvh_timed = (f"textured terrain {TERRAIN_RES}x{TERRAIN_RES}, one pass's "
                  "queries")

    main_arm = "instanced+motion1"
    arms = [dict(arm="static", launches=terrain_launches,
                 ms=tl_times["camera"][0], plain_ms=tl_times["camera"][1],
                 bound_ms=tl_bound[0], bound_by=tl_bound[1],
                 path="terrain, phase 6")]
    arms += [dict(arm=a, launches=forest_arms.get(a, 0), **arm_times[a],
                  path="forest, phase 8" if a == main_arm else "phase 3c")
             for a, _, _ in ARMS]
    arms.append(dict(arm="static, blocks of 1024", launches=0, **big,
                     path="phase 3b, the regime of TPU kernel c"))
    arms += cover_arms
    print(json.dumps({"kernels": [
        {"name": "mt_closest", "route": "cuda",
         "source": "libyafaray_tpu_torch/csrc/mt_intersect.cu",
         "replaces": "libyafaray_tpu/accel/pallas_intersect.py:49",
         "launches": fwd_bwd_launches,
         "max_abs_err": max(mt_err, mt_chunk["max_abs_err"],
                            mt_caustic["max_abs_err"],
                            mt_volume["max_abs_err"],
                            mt_walk["max_abs_err"],
                            mt_regions["max_abs_err"],
                            *(v["max_abs_err"] for v in aov_per.values()),
                            *(v["max_abs_err"] for v in int_per.values()),
                            capi_per_a["max_abs_err"],
                            mt_terrain["max_abs_err_128"]),
         "sharded_path": shard,
         "launches_by_path": {
             "cornell forward, phase 4": mt_launches,
             "cornell forward + backward, phase 11": fwd_bwd_launches,
             "glossy cornell forward, phase 13": glossy_launches,
             "caustic forward + backward 512x512, phase 19":
                 caustic_launches,
             "volume forward 512x512, phase 20": volume_launches,
             "cornell forward 1920x1080 under the orthographic, architect, "
             "angular and equirectangular cameras and two thin lenses, "
             "phase 21": camera_launches,
             "glossy sphere scene forward 1920x1080 (brute force), phase 23":
                 sphere_mt["glossy sphere scene"],
             "environment-map scene with a curve forward 1920x1080, "
             "phase 23": sphere_mt["environment-map scene"],
             "materials cornell forward 1920x1080 (transparent shadows), "
             "phase 24": mats_launches["forward"],
             "materials cornell forward + backward 1920x1080 1 spp, "
             "phase 24":
                 mats_launches["grads"],
             "portal room forward 1920x1080, phase 25": portal_launches,
             "procedural cornell forward 1920x1080, phase 26":
                 proc_launches["brute"],
             **{f"volume regions 512x512 {label}, phase 27": n
                for label, n in vol_launches.items()},
             "cornell adaptive AOV render 1920x1080 (4 + 3 x 2 samples, "
             "gauss 1.5, 17 layers), phase 28": aov_launches["aov brute"],
             "cornell adaptive AOV render 1920x1080, flat threshold (its "
             "later passes compacted), phase 28":
                 aov_launches["aov brute flat"],
             "cornell directlighting with AO (8 samples) 1920x1080 2 spp, "
             "phase 28": aov_launches["directlighting with AO"],
             "cornell debug integrator 1920x1080 one pass, phase 28":
                 aov_launches["debug"],
             "cornell 2 + 2 spp saved and resumed 1920x1080, phase 28":
                 aov_launches["resume"],
             **{f"{label} {pm_size(label)} (the maps' photon queries "
                "included where it builds them), phase 29": n[0]
                for label, n in int_launches.items()
                if label != "photon mapping blocks"},
             **{f"{label}, phase 30": n for label, n in capi_mt.items()},
             **{f"{label}, phase 31": n for label, n in accel_mt.items()},
             **{f"{label}, phase 32": n for label, n in shard_mt.items()}},
         "per_launch_by_path": {
             "materials cornell, closest-shadow queries of the "
             "transparent walk, phase 24": mt_walk,
             "caustic, one forward + backward's queries, phase 19":
                 mt_caustic,
             "volume, one pass's queries, phase 20": mt_volume,
             "volume regions, in-medium shadow queries of one pass "
             "(exp, grid, sky), phase 27": mt_regions,
             **{f"cornell 1080p, {AOV_PER_LAUNCH[k]}, phase 28": v
                for k, v in aov_per.items()},
             **{f"cornell 128x128 {k}, every query of a render (the first "
                "of each kind timed), phase 29": v
                for k, v in int_per.items()},
             "cornell 128x128 through render_for_capi, every query of a "
             "render (the first of each kind timed), phase 30": capi_per_a,
             "textured terrain 720x720 on brute force (203,648 rows), one "
             "pass's queries timed (plain_ms_128: mt_closest_ref at "
             "128x128, where every query is held bit for bit), phase 31":
                 mt_terrain},
         "timed_on": "the launches of one 518,400-ray chunk of phase 11, "
                     "mean per launch",
         "ms": mt_chunk["ms"], "plain_ms": mt_chunk["plain_ms"],
         "bound_ms": mt_chunk["bound_ms"], "bound_by": mt_chunk["bound_by"],
         "camera_1080p": {"ms": mt_times[False][0],
                          "plain_ms": mt_times[False][1],
                          "bound_ms": mt_bnd[0], "bound_by": mt_bnd[1]},
         "library_ms": None},
        {"name": "tiles_traverse", "route": "cuda",
         "source": "libyafaray_tpu_torch/csrc/tiles_traverse.cu",
         "replaces": "libyafaray_tpu/accel/tiles.py:277",
         "cover_order_replaces": "libyafaray_tpu/accel/tiles.py:300-306 "
                                 "and :158-161",
         "launches": forest_launches,
         "max_abs_err": max(tl_err, arm_err, tl_walk_err,
                            aov_walk["max_abs_err"],
                            int_walk["max_abs_err"],
                            capi_per_b["max_abs_err"], shard_walk_err),
         "ms": arm_times[main_arm]["ms"],
         "plain_ms": arm_times[main_arm]["plain_ms"],
         "bound_ms": arm_times[main_arm]["bound_ms"],
         "bound_by": arm_times[main_arm]["bound_by"],
         "library_ms": None, "arms": arms,
         "launches_by_path": {
             "forest forward, phase 8": forest_launches,
             "terrain forward, phase 6": terrain_launches,
             "terrain forward + backward, phase 12": grad_tile_launches,
             "textured terrain forward, phase 16": textured_launches,
             "textured terrain forward in cover order, phase 17":
                 cover_launches,
             "textured terrain texel gradient 720x720, 1 spp, phase 18":
                 texel_launches,
             "textured terrain under a sunsky forward, phase 22":
                 sky_launches["sunsky"],
             "textured terrain under a darksky forward, phase 22":
                 sky_launches["darksky"],
             "glossy sphere scene forward 1920x1080 on blocks, phase 23":
                 sphere_tiles,
             "materials cornell forward 1920x1080 on blocks (transparent "
             "shadows), phase 24": mats_launches["forward_blocks"],
             "procedural cornell forward 1920x1080 on blocks, phase 26":
                 proc_launches["blocks"],
             "cornell adaptive AOV render 1920x1080 on blocks, phase 28":
                 aov_tiles,
             "cornell photon mapping 1920x1080 on blocks (the maps' "
             "photon queries included), phase 29":
                 int_launches["photon mapping blocks"][1],
             **{f"{label}, phase 30": n for label, n in capi_tl.items()},
             **{f"{label}, phase 31": n for label, n in accel_tl.items()},
             **{f"{label}, phase 32": n for label, n in shard_tl.items()}},
         "per_launch_by_path": {
             "cornell 1080p on blocks, the first compacted sample's "
             "queries, phase 28": aov_walk,
             "cornell 128x128 on blocks, the photon walks of 100,000 "
             "photons, phase 29": int_walk,
             "cornell 128x128 on blocks through render_for_capi, every "
             "query of a render, phase 30": capi_per_b}},
        {"name": "lbvh_traverse", "route": "cuda",
         "source": "libyafaray_tpu_torch/csrc/lbvh_traverse.cu",
         "replaces": "none: the JAX package walks the LBVH outside Pallas "
                     "(libyafaray_tpu/accel/lbvh.py:259-335)",
         "launches": lbvh_launches[lbvh_main],
         "max_abs_err": max(v["max_abs_err"] for v in lbvh_per.values()),
         "timed_on": f"the {lbvh_timed} (phase 31), mean per launch, the "
                     "kernel alone (its C entry point launched in a loop); "
                     "events_ms: the wrapper between CUDA events; the main "
                     "path's (the Cornell box's) under per_launch_by_path",
         "ms": lbvh_per[lbvh_timed]["ms"],
         "events_ms": lbvh_per[lbvh_timed]["events_ms"],
         "plain_ms": lbvh_per[lbvh_timed]["plain_ms"],
         "bound_ms": lbvh_per[lbvh_timed]["bound_ms"],
         "bound_by": lbvh_per[lbvh_timed]["bound_by"],
         "library_ms": None,
         "launches_by_path": {f"{label}, phase 31": n
                              for label, n in lbvh_launches.items()},
         "per_launch_by_path": {f"{label}, phase 31": v
                                for label, v in lbvh_per.items()}},
        prepass_kernel,
        take_kernel,
        {"name": "probe_smem", "route": "cuda",
         "source": "libyafaray_tpu_torch/csrc/probe_smem.cu",
         "replaces": "tools/probe_traversal.py:27",
         "launches": 0, "probe_launches": _launches("probe_smem"), **probe,
         "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
