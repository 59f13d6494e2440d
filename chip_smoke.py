#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ngp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line. After phase 11 the script runs two
lanes at once: phases 12-18b in the main process and its children, and
the fresh processes of phases 19-23 one after another beside them
(:class:`ChildLane`; the NeRF children are host-bound and leave the card
mostly idle). A child's times are then taken beside the other lane's
work; ``chip_smoke.py <child>`` run alone times it alone.

1. env: the card (``nvidia-smi`` name and power limit), torch, CUDA, nvcc.
2. build: compiles every CUDA source of ``ngp_tpu_torch/csrc`` (one nvcc
   each, in parallel) into ``build/ngp_tpu_torch/``, and counts the atomic
   instructions of each kernel in the libraries' SASS (``cuobjdump``).
3. kernel: ``hashgrid_encode_cuda`` against its plain PyTorch twin on the
   card, bit for bit, at N = 2^20 samples, "tpu" tier (L=8, F=2, T=2^18,
   additive) and "upstream" tier (L=16, F=2, T=2^19, XOR), float32 and
   bf16 tables: error, times, a one-call PyTorch yardstick and the bound.
4. kernel_sort: ``bitonic_sort_pos_cuda`` (B5) against its twin, exactly,
   at (B, n) = (4, 2^20) with dense ties; ``torch.sort`` as yardstick;
   the kernel launches one call makes, and each one's device time.
5. golden: the reference snapshot ``tests/golden/golden.ingp`` rendered by
   the port (view 0, stride 4) against the JAX package's frozen render
   ``tests/golden/golden.npz``.
6. serve: three 960×540 views of the full-width "tpu" tier with seeded
   weights over an analytic occupancy grid, through ``render_image``; per
   frame its time, the samples evaluated and the kernel launches, then one
   more frame under ``torch.profiler``: device time per stage, the busiest
   kernels, and the device's busy share of the frame.
7. kernel_main_path and kernel_serve_positions: the kernel case again
   at the serve path's shape (its mean samples per launch, uniform
   positions), then on the positions of the profiled frame's largest
   launch; each also times the encoding's cast of its float32 table to
   bf16 before the call.
8. train: the bench's fallback configuration (``bench.py``: the synthetic
   sphere, 12 views at 128², full-width "tpu" tier, 2^18 sample slots per
   step, grid 128), 400 steps through ``NerfEngine.train``: ms per step,
   network samples per second, final loss, batch geometry, kernel launches
   per step, and the PSNR of view 0, which must reach ``TRAIN_PSNR_MIN``.
   Then one more step, whose grid backward's positions and cotangents
   (x, g) are kept (by reference) for phase 9.
9. kernel_train, segsum_levels and backward_levels: the training kernels
   against their twins at the training step's shapes ("tpu" tier, L=8
   levels, F=2, T=2^18; uniform positions for N the path's mean network
   samples per step and for N the full budget of 163,840, then the kept
   step's own (x, g)): B1's forward on the same uniform positions, the
   fused grid backward (x, g → d(table)), and, on the corner keys and
   addends that the backward's twin makes on the card (L levels of
   M = 8·N), the segment sum (B2, also level by level), the key histogram
   (B3) and the one-level entry points (B4); error, times, a one-call
   PyTorch yardstick and the bound of each. The grid backward and B3 also
   level by level (phase ``backward_levels``).
9b. normals, kernel_normals and debug_modes (before phase 10, whose
   profiler windows leave later ones short of records): on phase train's sphere
   ("tpu" tier), a 960×540 frame of the shade mode and one of the normals
   mode through ``render_rays`` (launches, wall ms, device busy ms); the
   normals frame launches ``hashgrid_input_grad`` and no table gradient,
   and over its pixels of opacity above ``NORMALS_OPACITY`` the median
   cosine between the rendered normal and the sphere's outward normal at
   the hit point must reach ``NORMALS_COS_MIN``. Then the input gradient
   against its twin, bit for bit (and so within the float32 order bound;
   with ptxas's registers a thread), on the frame's own
   positions and cotangents and on a D = 2 case of the image geometry
   (2^18 uniform positions, T = 2^18), and the grid backward with float32
   addends on the frame's (x, g); then the positions, encoding and cost
   modes once each (finite; cost exactly the march's count over 128).
10. train_profile: two windows of 16 more steps (one occupancy-update
   cycle) under ``torch.profiler``: one run as phase train runs them, for
   the device's busy share of a step; one with the backward on the calling
   thread, for the device time per stage (march, network forward, loss,
   backward, grid backward, optimizer, grid update).
11. capture: a real capture end to end. Writes a textured sphere in the
   transforms dialect of instant-ngp's fox scene (OpenCV lens, off-center
   principal point, aabb_scale 2) as 24 train and 4 held-out 800×800 RGBA
   PNG frames into ``build/capture_smoke/``; loads both files with
   ``load_nerf`` (the port's own PNG decoder); trains the full-width "tpu"
   tier (2^18 sample slots per step) for 400 steps; scores the held-out
   views with ``eval_test_transforms``, whose mean PSNR must reach
   ``CAPTURE_PSNR_MIN``; then holds B1 against its twin, bit for bit, on
   the positions of the eval's largest launch (phase
   ``kernel_capture_positions``, timed by CUDA events only).
12. cli: the port's entry point as a user runs it, ``python -m
   ngp_tpu_torch.run``, in subprocesses on the capture of phase 11, with
   ``Testbed``'s default config (instant-ngp's ``base.json``: L=16, F=2,
   T=2^19, XOR hash, float32 table reads). Run 1 trains 400 steps, scores
   the held-out views (gate ``CLI_PSNR_MIN``), saves a snapshot and a
   screenshot; run 2 loads the snapshot, scores the held-out views again
   (within ``CLI_RELOAD_DB`` of run 1), writes a normals-mode screenshot
   (``--render_mode normals``; a view's size, finite, and the run launches
   ``hashgrid_input_grad``), exports a 128³ marching-cubes mesh
   (non-empty, inside the scene's box) and renders a 3-keyframe camera path
   as 8 PNG frames (decoded by the port's reader). Then, in a fresh process
   of this script (``chip_smoke.py cli_checks``: its profiler windows are
   whole, which phase 10 leaves them not), phase ``cli_checks``: the
   snapshot loaded again and trained 64 more steps, the last 16 kept for
   their kernels' shapes; native snapshots round
   trip with parameters, EMA and optimizer moments bit for bit, and the
   bitfield cells the float16 density grid changes are counted; a second
   reference ``.ingp`` of a loaded one has the same parameter and grid
   bytes; B1 against its twin, bit for bit, at that tier on uniform
   positions at those steps' mean launch and on the positions of a
   held-out render's largest launch; the fused grid backward within the
   float32 order bound at the steps' mean and on their last step's own
   (x, g), and the input gradient bit for bit with its twin on the largest
   launch of a normals render of training view 0 at stride 2 (phase
   ``kernel_cli``).
13. image: in a fresh process (``chip_smoke.py image``), the image
   primitive at instant-ngp's configs/image/base.json width (``Testbed``'s
   default: D=2, L=16, F=2, T=2^24, XOR hash; levels 0-8 dense, level 8 of
   exactly 2^24 rows), fitting the 104.9 MP procedural image of
   ``scripts/bench_gigapixel.py`` made on the card in float16: 384 steps
   of 2^18 Stratified positions through ``ImageEngine.train`` in calls of
   128; ms a step (median after step 256), samples/s, peak memory, the
   PSNR of the stride-16 texel subsample (gate ``IMAGE_PSNR_MIN``), the
   full-image MSE and a 1920×1080 render. Then (phase ``image_kernels``)
   B1 bit for bit and the fused backward within the float32 order bound
   on one more step's own positions and cotangents, and (phase
   ``image_profile``) 16 steps under ``torch.profiler``: device ms a step
   by stage (positions and targets, forward, backward, grid backward,
   optimizer).
14. image_cli: ``python -m ngp_tpu_torch.run`` in subprocesses on a
   written 2048² ``.bin`` image: the default config 300 steps with a
   screenshot (gate ``IMAGE_CLI_PSNR_MIN`` on the printed PSNR), then a
   T=2^18 ``--network`` file trained, saved, and loaded in a new process,
   whose MSE line must equal the saved run's.
15. sdf: in a fresh process (``chip_smoke.py sdf``, which also runs alone),
   the SDF primitive at instant-ngp's configs/sdf/base.json width
   (``Testbed``'s default: L=16, F=2, T=2^19, XOR hash, float32 reads, a
   64-wide MLP of 2 hidden layers, MAPE, 2^18 samples a step) on a
   327,680-triangle bumpy sphere written as an OBJ into
   ``build/sdf_smoke/`` and loaded through ``Testbed`` (the BVH build's
   seconds): 500 steps (ms a step, samples/s), the IoU over 2^18
   uniform points (gate ``SDF_IOU_MIN``), 960×540 frames of the shade,
   shade with shadows and normals modes (wall and device ms, launches), a
   ground-truth frame of the BVH's distances and the IoU of the two hit
   masks (gate ``SDF_HIT_IOU_MIN``), a 256³ marching-cubes mesh, one data
   refresh in the raystab sign mode, and a snapshot round trip that must
   give the same IoU. Then (phase ``sdf_kernels``) both BVH kernels bit for
   bit against their twins, each query's nodes processed equal to the
   twin's pops, the closest point on a data refresh's own 2^17 queries and
   the ray hit on the frame's 518,400 rays (µs a node of the longest walk,
   mean and longest walk, bound from the real triangles tested), and B1,
   the fused backward and the input gradient on one step's own (x, g); then
   (phase ``sdf_profile``) 16 steps under ``torch.profiler``: the device's
   busy share and device ms by stage.
16. sdf_cli: ``python -m ngp_tpu_torch.run`` on the mesh, 300 steps with a
   snapshot and a screenshot (it must print ``IoU:``), then the snapshot
   loaded in a new process, which must print the same IoU line.
17. volume: in a fresh process (``chip_smoke.py volume``, which also runs
   alone), the volume primitive at the JAX Testbed's volume config
   (``Testbed``'s default: L=16, F=2, T=2^19, XOR hash, a 64-wide MLP of 2
   hidden layers with a ReLU output, L2, Adam 1e-4) and 2^16 slots a step
   (16,384 episodes) on the JAX package's procedural cloud at 512³ (537 MB
   of float32 density on the card), written as a NanoVDB file by the
   port's writer into ``build/volume_smoke/`` and loaded through
   ``Testbed`` (seconds to make, write, read back and load; bytes): 1,000
   steps (ms a step, samples/s, the fill share, peak memory), the
   correlation of the served model's density with the targets at a
   held-out step's recorded vertices (gate ``VOLUME_VERTEX_CORR_MIN``)
   and with the jittered ground truth at 4,096 uniform points (gate
   ``VOLUME_UNIFORM_CORR_MIN``), a learned and a ground-truth 960×540
   frame (wall and device ms, the learned frame's rounds and
   network evaluations; centre opacity above ``VOLUME_CENTRE_MIN``, the
   corner's below ``VOLUME_CORNER_MAX``, in both), and a snapshot reloaded
   to the same learned frame, bit for bit. Then (phase
   ``volume_kernels``) both walk kernels bit for bit against their twins:
   the training walk (starts, walks and targets in one launch) on a
   step's own key and 16,384 episodes against the twin's composition on
   CUDA tensors, the render walk on the ground-truth frame's 518,400 rays
   and on the first round of the learned frame (``ms`` behind a spin
   kernel, walk lengths, idle lanes a warp, registers, bound), and B1 and
   the fused backward on a step's own (x, g); then (``volume_profile``) 16
   steps under ``torch.profiler``: the busy share and device ms by stage.
18. volume_cli: ``python -m ngp_tpu_torch.run`` on the written cloud, 300
   steps with a snapshot and a screenshot, then the snapshot loaded in a
   new process with another screenshot, which must be the same pixels.
18b. octree: in a fresh process (``chip_smoke.py octree``, which also
   runs alone), ROADMAP A7b and A7c on phase sdf's 327,680-triangle bumpy
   sphere (its own copy in ``build/octree_smoke/``). Phase
   ``octree_build``: the BVH by the C++ host builder and by numpy, and the
   octree at depth ``OCTREE_DEPTH`` both ways, array for array (gates:
   equal), their seconds, each octree's voxels a level, vertices and
   distance-field depth; the C++ octree at ``OCTREE_DEEP`` alone. Phase
   ``octree_sdf``: three runs through ``Testbed`` at the sdf config's width
   (64-wide MLP, MAPE, Adam 1e-4, 2^18 samples a step), ``OCTREE_STEPS``
   steps each: the Takikawa encoding (the schema of
   ``tests/test_octree_takikawa.py:237-243``) over the depth-10 octree, the
   config's hash grid with ``use_octree``, the plain hash grid; ms a step,
   samples/s, load and build seconds, the IoU (gate: above the untrained
   model's), the loss (gate: falls), a 960×540 shade frame (wall and device
   ms, tracer iterations) and its hit mask against the same tracer's
   ground-truth frame (gate ``SDF_HIT_IOU_MIN``), a snapshot reloaded to
   the same IoU (gate); the Takikawa run launches ``segment_sum`` (B2)
   once a step. Phase ``octree_frame_readers``, after the path's
   launches are read: the plain run's frame device ms from the raw
   records and from the profiler's event tree (gate: within 1e-3). Phase
   ``octree_kernels``: B2 on a Takikawa step's own keys
   and addends within the float32 order bound of its twin, with the
   ``index_add_`` yardstick and the keys' contention; B1 and the fused
   backward on an octree hash step's own (x, g). Phase ``octree_profile``:
   two windows of ``OCTREE_PROFILE_STEPS`` Takikawa steps, the busy share
   and device ms by stage. Phase ``octree_cli``: the CLI with a written
   Takikawa ``--network`` file, ``OCTREE_CLI_STEPS`` steps and a
   snapshot, then a reload in a new process printing the same ``IoU:``
   line. B2's row in the ``kernels`` line is phase ``octree_kernels``'.
19. camera: in a fresh process (``chip_smoke.py camera``, which also runs
   alone), camera refinement through ``Testbed`` at its NeRF config
   (instant-ngp's base.json: L=16, F=2, T=2^19, XOR hash, 64-wide MLPs,
   2^18 sample slots a step) on the capture of phase 11 (written again
   when absent), its training poses moved by seeded noise (positions σ
   0.01, rotations σ 0.2°) through ``set_camera_extrinsics``: ``CAMERA_STEPS``
   steps with refinement off and as many with extrinsics, exposure, focal length and
   distortion refined, each scored on the held-out views (gates: the
   refined position offsets moved, the frozen camera group exactly 0, the
   refined loss below 1.2× the frozen one on one batch; the refined run launches
   ``hashgrid_input_grad`` and the float32-addend backward), a timing run
   with exposure alone, and 100 steps on a motion-blurred copy of the
   capture to a falling loss, with ``render(end_matrix=start)`` equal to
   the still render bit for bit. Then (``camera_kernels``) the position
   gradient bit for bit and the float32-addend backward within the float32
   order bound on one refined step's own (x, g), beside the bf16-addend
   backward on the same (x, g), and (``camera_profile``) two windows of 4
   refined steps under ``torch.profiler``: the busy share and device ms by
   stage.
20. supervision: in a fresh process (``chip_smoke.py supervision``, which
   also runs alone), ROADMAP A5c's options through ``Testbed`` at its NeRF
   config on four 800×800 captures of the sphere written into
   ``build/supervision_smoke/`` (depth maps and supplied rays; an opaque
   sky; an envmap behind a transparent background; per-view brightness
   with 8 extra dims), 200 steps a run: depth supervision (gate: the
   held-out median depth error below 0.05 NGP units, beside the
   unsupervised run's), supplied rays (gates: the held-out PSNR within 1
   dB of the camera rays', no culled cell), a trained envmap on the sky
   (gate: its mean sRGB error at seen directions below 0.08), a dataset's
   envmap (gates: unchanged bit for bit, a render's miss pixels equal to
   its lookup within 1e-3), latents (gates: they move, the loss finite, a
   zero-latent render finite; the loss beside a run without them), and
   every option at once, timed against the plain run. Then
   (``supervision_kernels``) B1 bit for bit and the fused backward within
   the float32 order bound on one every-option step's own (x, g), and
   (``supervision_profile``) two windows of 4 such steps under
   ``torch.profiler``, the envmap's read and deposit a stage of their own.
21. nerf_surface: in a fresh process (``chip_smoke.py nerf_surface``, which
   also runs alone), ROADMAP A5d and A6 through ``Testbed`` at its NeRF
   config on phase capture's 800×800 capture (written again when absent),
   200 steps a run. Phase ``prior``: the default cadence; the decoupled
   schedule with probe-sampled updates; the capture with the sphere's
   ``.obj`` and with its ``.xyz`` beside it (``build/nerf_surface_smoke/``);
   each run's ms a step, held-out PSNR, trainable and occupied shares at
   step 0 and at the end and occupancy passes by kind (gates: culled cells
   stay −1, the passes equal the schedule's formula, the cloud prior at most
   1 dB below the default run, the decoupled and mesh runs 10 dB above
   their untrained models; the mesh prior keeps ~85% of the sphere's
   surface cells, ROADMAP C.ref 13).
   Phase ``render_surface`` on the default run's model: a 960×540 frame
   uncropped, with the crop box at the scene box (the same bits) and at a
   half box (the background exactly where rays miss it, fewer samples);
   the "gt" and "error" overlays; a 256² density slice (equal to
   ``chunked_density``); a foveated frame (mean error < 0.08 at the
   centre); ``optimize_mesh_vertices`` on the 128³ mesh, 10 steps (the mean
   |σ(v) − 2.5| falls); each render's ms. Phase ``nerf_surface_kernels``:
   B1 on the slice's positions, the fused backward on a probe-sampled
   step's (x, g) and the position gradient on the mesh's vertices, against
   their twins.
22. encodings: in a fresh process (``chip_smoke.py encodings``, which also
   runs alone), ROADMAP A7a at full width through ``Testbed``: base.json
   with Simplex interpolation and as a TiledGrid on phase capture's
   800×800 capture, 200 steps each (gate: the held-out PSNR 10 dB over
   the untrained model's), a 960×540 frame and a normals frame (gates: the
   position gradient launched, no table gradient, the median cosine with
   the sphere's normal), a reference ``.ingp`` saved and loaded (gate: the
   held-out PSNR within 0.05 dB); the image config (D = 2, 16 × 2^24 rows)
   with Simplex, 200 steps (gate: 5 dB over the untrained model); the sdf
   config's MLP on the bumpy sphere with the Frequency, TriangleWave and
   OneBlob encodings and a Simplex hash grid, 300 steps each (gates: the
   IoU above the untrained model's; the grid's loss halves; a table-free
   encoding's loss falls by 3% and its IoU reaches 0.3, which its run on
   shuffled targets, ``chip_smoke.py encodings_control``, does not), and a
   Simplex normals frame; the launches of these runs. Then phase
   ``encodings_kernels``: the three grid kernels' new instantiations (D =
   2 and 3, Tiled and Simplex) on those runs' own positions and
   cotangents against their twins (forward and position gradient bit for
   bit, the backward within the float32 order bound) with registers,
   times, bounds and the forward's ``embedding_bag`` yardstick.
   ``chip_kernel_ab.py --kernels regs`` sets the Linear instantiations'
   registers beside a parent checkout's.
23. jpeg: in a fresh process (``chip_smoke.py jpeg``, which also runs
   alone), ROADMAP A2 and A15 on the committed JPEG capture
   ``tests/fixtures/jpeg/capture`` (phase capture's 24 + 4 800×800 views
   over black, 4:2:0 quality-90 JPEGs written by PIL on a host with PIL):
   phase ``jpeg_decode`` decodes every fixture with the port's C++ decoder
   (gate: each RGBA decode's sha256 is PIL's, from the fixtures'
   ``manifest.json``) and times the decoder on the host, one thread and
   one a core, beside the PNG reader on phase capture's frames; phase
   ``jpeg_train`` loads the capture with ``load_nerf``, trains the "tpu"
   tier 400 steps with 2^18 sample slots against the capture's black
   background (random training backgrounds off) and scores the held-out views
   (gates: PSNR ``JPEG_PSNR_MIN``, B1 and the fused backward launched in
   training, B1 in the eval); phase ``jpeg_convert`` writes a COLMAP
   text model of the capture's poses, runs ``python -m
   ngp_tpu_torch.scripts.colmap2nerf --keep_colmap_coords`` with sharpness
   on (gates: poses within 1e-5, every sharpness the manifest's exactly)
   and loads its output (gate: the same frames); phase ``jpeg_cli`` runs
   ``python -m ngp_tpu_torch.run`` (``Testbed``'s base.json) 100 steps on
   that output and scores the held-out views (gates: B1 and the backward
   launched, a finite PSNR).
Then the main process's wall seconds by phase (phase ``seconds``, the
children's under their names), the ``kernels`` line, the card's ``name,
power.limit``, and last the ``{"ok": true, ...}`` line. ``python3 chip_smoke.py profiler_probe`` runs
no phase above: it counts how :func:`device_ms`'s profiler windows lose
records (:func:`phase_profiler_probe`).

Each kernel has two times: ``ms``, the device time of one call (the
kernels and the zero-fill of its output that the call puts on the card,
from ``torch.profiler`` over 20 calls; the BVH rows by CUDA events, the
walk rows by CUDA events around calls queued behind a spin kernel, each
row's ``ms_source`` says), and ``call_ms``, what a caller pays per call
(CUDA events around 20 back-to-back calls of the Python wrapper, which
host issue may bound). The library yardstick's ``library_ms`` is timed as
``ms`` is, its zeroed output made inside the timed call. Every profiler
window opens with launches that take the profiler's loss of a window's
first four device records, seen in some processes: ``PROFILER_LEAD_CALLS``
untimed calls in :func:`device_ms`, spin kernels elsewhere
(:func:`_lead_in`). A profiler
window whose ``device_ms`` annotation span lacks records that the window
holds is counted from the whole window and reported
(``profiler_span_short``); one that lacks them outright is profiled
again (``profiler_retry``, with the host's launch records beside the
device's). After three such windows the time comes from CUDA events
around calls queued behind a spin kernel
(``profiler_fallback``), and the row marks that field's source
(``ms_source``, ``library_ms_source``: "cuda_events_queued", or
"cuda_events" for a call that waits on the card itself).

Any failure raises and ends the run with a non-zero exit; so does a host
without CUDA. The script imports torch, numpy and ``ngp_tpu_torch`` only.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
N_KERNEL = 1 << 20
# The card's bf16 matmul products may sum in another order than the CPU that
# froze the golden render; a hidden unit's bf16 rounding can then flip
# (2^-8 of one activation). Composited over a ray that stays well below
# 1e-3, five times the CPU bound of 2e-4.
GOLDEN_TOL = 1e-3
TRAIN_STEPS = 400
TRAIN_PROFILE_STEPS = 16  # one cycle of the stride-residue occupancy updates
# host sleep between a profiler window's edges and the calls it times, and
# the untimed calls between those edges and the timed ones: before them
# more than the profiler loses (it keeps no device record of a window's
# first four launches in some processes), after them two
PROFILER_PAD_S = 0.05
PROFILER_LEAD_CALLS = 8
PROFILER_EDGE_CALLS = 2
# the spin kernels that open every other profiler window, in their own range
PROFILER_LEAD = "profiler_lead"
PROFILER_LEAD_LAUNCHES = 8
# The JAX package's test_train_sphere_to_psnr asks for 20 dB; two sound card
# runs of this configuration read 51.4 and 53.0 dB, so the gate sits well
# above 20 dB to catch a table gradient that is badly wrong.
TRAIN_PSNR_MIN = 40.0
# phase normals: the frame, and its gate (fixed before the first card run):
# over the pixels whose opacity exceeds NORMALS_OPACITY, the median cosine
# between the rendered normal 2·rgb − 1 and the sphere's outward normal at
# the hit point o + d·depth/opacity. Noise reads 0 and a sign error the
# negative of the true reading. A color-only fit of the one-colored sphere
# learns a shell about 0.02 thick of noisy density (σ from 50 to 1400 a few
# samples apart), so each sample's −∇σ/|∇σ| scatters: phase train's
# configuration trained on the CPU (400 steps, 2^18 slots, 128² views)
# reads a median of 0.26 (10%, 25%, 75%, 90% quantiles −0.62, −0.27, 0.68,
# 0.87) on this frame at 96×54. The gate sits between that and noise.
NORMALS_RES = (960, 540)
NORMALS_OPACITY = 0.95
NORMALS_COS_MIN = 0.1
# the sphere of tiny_sphere_dataset (ngp_tpu_torch/data/synthetic.py)
SPHERE_CENTER, SPHERE_RADIUS = (0.5, 0.5, 0.5), 0.2
# the image config's geometry (D=2, L=16, F=2, base 16, scale 2) at a small
# table for the input gradient's D = 2 case
INPUT_GRAD_2D_LOG2 = 18
# phase capture: nerf_synthetic's frame size, the steps, and the gate on the
# held-out views' mean PSNR, fixed before the first card run
CAPTURE_RES = 800
# 1,000 before the nerf_surface phase took the time, 600 before the
# encodings phase did
CAPTURE_STEPS = 400
CAPTURE_PSNR_MIN = 30.0
# phase cli: the capture phase's gate on the CLI's held-out PSNR, the reload's
# agreement, the mesh lattice and the camera-path video (frames at 320×180)
# 1,000 before the nerf_surface phase took the time, 600 before the
# encodings phase did
CLI_STEPS = 400
CLI_PSNR_MIN = CAPTURE_PSNR_MIN
CLI_RELOAD_DB = 0.05
CLI_MESH_RES = 128
CLI_VIDEO = {"w": 320, "h": 180, "fps": 8, "seconds": 1}
# phase cli_checks: steps continued from the snapshot before the kept ones
# (a loaded engine starts its batch geometry afresh and adapts it from step
# 32 on), then the kept steps, whose kernel launches give the shapes
CLI_SETTLE_STEPS = 48
CLI_KEPT_STEPS = 16
# phase image: the gigapixel image's side (104.9 MP), the steps in calls of
# 128 (ms a step: the median of the calls after the first 256 steps), the
# profiled steps, the stride of the PSNR's texel subsample and its gate
IMAGE_SIDE = 10240
# 2,048 before the supervision phase took the time, 1,024 before the
# nerf_surface phase did, 512 before the encodings phase did
IMAGE_STEPS = 384
IMAGE_CALL_STEPS = 128
IMAGE_TIMED_FROM = 256
IMAGE_PROFILE_STEPS = 16
IMAGE_PSNR_STRIDE = 16
IMAGE_PSNR_MIN = 25.0
# phase image_cli: the written .bin image's side, the default config's
# steps and gate; the snapshot round trip's table size and steps
IMAGE_CLI_SIDE = 2048
# 1,000 before the supervision phase took the time, 500 before the
# encodings phase did
IMAGE_CLI_STEPS = 300
IMAGE_CLI_PSNR_MIN = 25.0
IMAGE_SNAPSHOT_LOG2 = 18
IMAGE_SNAPSHOT_STEPS = 200
# phase sdf: the bumpy sphere's subdivisions (327,680 triangles), the steps
# in calls of 100, the profiled steps, the IoU's samples and its gate (that
# of tests/test_sdf.py), the frame, the gate on the IoU of the model's and
# the ground truth's hit masks, the mesh lattice, the CLI's steps; all fixed
# before the first card run
SDF_SUBDIVISIONS = 7
SDF_STEPS = 500  # 1,000 before the encodings phase took the time
SDF_CALL_STEPS = 100
SDF_PROFILE_STEPS = 16
SDF_IOU_SAMPLES = 1 << 18
SDF_IOU_MIN = 0.9
SDF_FRAME = (960, 540)
SDF_HIT_IOU_MIN = 0.9
SDF_MC_RES = 256
SDF_CLI_STEPS = 300
# float32 operations of one test, for the BVH kernels' bound: a point's
# squared distance to a box (6 subtractions, 6 maxima, a 3-term dot); a
# point's closest point on a triangle (Ericson: 15 subtractions, six 3-term
# dots, three 2x2 determinants, the face's 2 divisions and 6 multiply-adds,
# the squared distance and its test); a ray's slab test (6 subtractions, 6
# products, 6 minima/maxima, 4 reductions, 3 tests); Moller-Trumbore (6
# subtractions for the edges, 2 cross products, 4 dots, a division, 3 scalar
# products, 6 tests)
BOX_SQ_DIST_OPS = 17
POINT_TRIANGLE_OPS = 80
BOX_RAY_OPS = 25
RAY_TRIANGLE_OPS = 58


class EventMs(float):
    """A :func:`device_ms` time that the profiler could not give (it kept
    too few device records in every window) and CUDA events did: around
    calls queued behind a spin kernel (``source`` "cuda_events_queued",
    :func:`queued_ms`), or, for a call that waits on the card itself,
    around calls issued one after another ("cuda_events", :func:`cuda_ms`).
    :func:`emit` writes ``<field>_source`` beside it."""

    def __new__(cls, value: float, source: str):
        ms = super().__new__(cls, value)
        ms.source = source
        return ms


class SpinTooShort(AssertionError):
    """The spin kernel of :func:`queued_ms` ended before the host had
    queued every call: the card may have waited for the host."""


def _sourced(obj):
    """``obj`` with ``<key>_source`` beside every :class:`EventMs` value
    of its dicts, at any depth."""
    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            out[key] = _sourced(value)
            if isinstance(value, EventMs):
                out[f"{key}_source"] = value.source
        return out
    if isinstance(obj, (list, tuple)):
        return [_sourced(value) for value in obj]
    return obj


PRINT_LOCK = threading.Lock()  # the lane of children prints beside the main process


def emit(obj):
    with PRINT_LOCK:
        print(json.dumps(_sourced(obj)), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 20, warmup: int = 2, windows: int = 3,
              fallback: bool = True) -> float:
    """Mean device milliseconds per call of ``fn``: the summed durations of
    the kernels and copies that ``iters`` calls put on the card, read from
    ``torch.profiler`` after warm-up. The host's time between them (Python,
    checks, launch issue) is not in it; :func:`cuda_ms` measures that.

    The calls run ``PROFILER_PAD_S`` of host sleep away from both edges of
    the profiler's window, and ``PROFILER_LEAD_CALLS`` more calls run
    before the timed ones inside the window (the profiler may keep no
    device record of the window's first four launches), and
    ``PROFILER_EDGE_CALLS`` after them. The timed calls'
    records are those within the ``device_ms`` annotation's span on the
    device timeline. An operation whose span lacks records that the whole
    window holds (a whole number a call, edge calls included) lost them to
    the span, not to the profiler: it counts from the whole window, and
    the window is reported with where its records lay (phase
    ``profiler_span_short``). An operation short in both (records the
    profiler did not keep; one short is tolerated) is reported (phase
    ``profiler_retry``, with the window's host launch records and device
    records) and profiled again, up to ``windows`` times. Then the time
    comes from CUDA events as an :class:`EventMs` (phase
    ``profiler_fallback``), or, with ``fallback=False``, the call
    raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    n_window = iters + PROFILER_LEAD_CALLS + PROFILER_EDGE_CALLS
    short = {}
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            for _ in range(PROFILER_LEAD_CALLS):
                fn()
            with record_function("device_ms"):
                for _ in range(iters):
                    fn()
            for _ in range(PROFILER_EDGE_CALLS):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.is_user_annotation and e.name == "device_ms"]
        whole, in_span = {}, {}
        for e in events:
            if e.is_user_annotation:
                continue
            t = (e.time_range.start, e.time_range.end)
            whole.setdefault(e.name, []).append(t)
            if any(a <= t[0] and t[1] <= b for a, b in spans):
                in_span.setdefault(e.name, []).append(t)

        def per_call(records, n_calls):
            """Records a call, rounded, or None where more than one is missing."""
            k = max(1, round(len(records) / n_calls))
            return k if abs(len(records) - k * n_calls) <= 1 else None

        # Each operation counts as its mean time times its records per call.
        us, short, span_short = 0.0, {}, {}
        for name, records in whole.items():
            got = in_span.get(name, [])
            k = per_call(got, iters) if spans else None
            if k is None:
                k = per_call(records, n_window)
                if k is None:
                    short[name[:90]] = [len(got), len(records)]
                    continue
                if spans:
                    left = sum(t[1] <= min(a for a, _ in spans) for t in records)
                    span_short[name[:90]] = {"in_span": len(got), "window": len(records),
                                             "before_span": left,
                                             "after_span": len(records) - len(got) - left}
                got = records
            us += sum(b - a for a, b in got) / len(got) * k
        if span_short:
            emit({"phase": "profiler_span_short", "window": window, "calls": iters,
                  "window_calls": n_window, "spans": len(spans), "records": span_short,
                  **_lost_launches(prof)})
        if not short and us > 0:
            return us / 1e3
        emit({"phase": "profiler_retry", "window": window, "calls": iters,
              "window_calls": n_window, "records_in_span_and_window": short or "none",
              **_lost_launches(prof)})
    message = (f"in {windows} windows of {iters} calls the profiler kept "
               f"no whole number of device records a call: {short or 'none'}")
    if not fallback:
        raise AssertionError(message)
    try:
        ms = EventMs(queued_ms(fn), "cuda_events_queued")
    except SpinTooShort:
        ms = EventMs(cuda_ms(fn, iters), "cuda_events")
    emit({"phase": "profiler_fallback", "calls": iters, "windows": windows,
          "records_in_span_and_window": short or "none", "ms": ms})
    return ms


def _lead_in():
    """Open a profiler window: ``PROFILER_LEAD_LAUNCHES`` spin kernels of
    one cycle in a ``PROFILER_LEAD`` range, then a synchronize. In some
    processes the profiler keeps no device record of a window's first four
    launches while it keeps their host launch records (PERF.md §7); these
    launches take that loss, and the readers of the window skip what it
    kept of them (:func:`_outside_lead`)."""
    import torch
    from torch.profiler import record_function

    with record_function(PROFILER_LEAD):
        for _ in range(PROFILER_LEAD_LAUNCHES):
            torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _outside_lead(prof):
    """A test of a device interval (start, end) of ``prof``'s window: True
    unless it lies in the window's :func:`_lead_in` range."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.is_user_annotation
             and e.name == PROFILER_LEAD]
    return lambda a, b: not any(s <= a and b <= t for s, t in spans)


def _lost_launches(prof) -> dict:
    """Of a profiler window: its kernel launches on the host, its device
    records, and the places (in launch order) of the launches whose
    correlation id no device record carries; None where no record
    carries a launch's id."""
    from torch.autograd import DeviceType

    launches = sorted((e.time_range.start, e.id) for e in prof.events()
                      if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name)
    kept = {e.id for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    lost = [i for i, (_, cid) in enumerate(launches) if cid not in kept]
    return {"host_launch_records": len(launches), "device_records": len(kept),
            "lost_launch_places": lost if len(lost) < len(launches) else None}


def _kernel_name(signature: str) -> str:
    """A kernel's name without its namespace and arguments."""
    found = re.search(r"(\w+(?:<\d+>)?)\(", signature)
    return found.group(1) if found else signature[:40]


def launch_sequence_ms(fn, launches: int, windows: int = 3) -> list:
    """Device milliseconds of each kernel one call of ``fn`` launches, in
    launch order, as ``[name, ms]`` pairs: one call under ``torch.profiler``
    padded as in :func:`device_ms` after a :func:`_lead_in`, profiled again (up to ``windows`` times)
    when the trace does not hold ``launches`` records; None (phase
    ``profiler_fallback``) when no window held them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILER_PAD_S)
            _lead_in()
            fn()
            torch.cuda.synchronize()
            time.sleep(PROFILER_PAD_S)
        outside = _outside_lead(prof)
        records = sorted(
            (e.time_range.start, e.time_range.end, e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and outside(e.time_range.start, e.time_range.end))
        if len(records) == launches:
            return [[_kernel_name(name), (b - a) / 1e3] for a, b, name in records]
        emit({"phase": "profiler_retry", "window": window, "calls": 1,
              "records": len(records)})
    emit({"phase": "profiler_fallback", "calls": 1, "windows": windows,
          "launches": launches, "launch_ms": None})
    return None


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up:
    what a caller pays per call, host issue included when the card waits
    for it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 50, spin: int = 100_000_000) -> float:
    """Mean device milliseconds of a call of ``fn``: CUDA events around
    ``iters`` calls queued behind a spin kernel of ``spin`` cycles (~50 ms
    by default; longer where a call issues many launches), so that the
    card runs them back to back whatever the host's time to issue them
    (where a call's host time exceeds its kernel's, events around calls
    issued one after another measure the host). Where the spin ended
    before the host had queued every call, the calls are queued again
    behind a spin four times as long, twice; then :class:`SpinTooShort`
    (a call that waits on the card itself can never be queued so)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        queued = not start.query()
        end.record()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        spin *= 4
    raise SpinTooShort(f"a spin of {spin // 4} cycles ended before {iters} calls were queued")


def phase_env():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        sys.exit(1)
    from ngp_tpu_torch.ops.cuda_build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    emit({"phase": "env", "gpu": nvidia_smi(),
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda, "nvcc": nvcc})


def sass_atomics(library: str) -> dict:
    """The atomic instructions (RED, REDG, ATOM, ATOMG, ATOMS) of each kernel in
    a library's SASS, by opcode: {kernel: {opcode: count}}."""
    from ngp_tpu_torch.ops.cuda_build import nvcc_path

    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    found, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :")[1].strip()[:80]
            continue
        op = re.search(r"\b(?:REDG|RED|ATOMG|ATOMS|ATOM)\.[\w.]+", line)
        if op and kernel:
            ops = found.setdefault(kernel, {})
            ops[op.group(0)] = ops.get(op.group(0), 0) + 1
    return found


def ptxas_registers(kernel) -> dict:
    """Registers a thread of each entry point of a ``CudaKernel``'s
    library, by mangled name, from ptxas's report (``-Xptxas=-v``) in the
    log its build wrote beside it."""
    log = kernel.lib_path().with_suffix(".log")
    found, entry = {}, None
    for line in (log.read_text() if log.exists() else "").splitlines():
        name = re.search(r"entry function '(\w+)'", line)
        if name:
            entry = name.group(1)
        used = re.search(r"Used (\d+) registers", line)
        if used and entry:
            found[entry] = int(used.group(1))
            entry = None
    return found


def phase_build():
    from ngp_tpu_torch.ops.cuda_build import KERNELS, build_all

    t0 = time.perf_counter()
    logs = build_all()
    usage = {
        name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
        for name, log in logs.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": usage})
    emit({"phase": "sass", "atomics": {
        k.name: sass_atomics(str(k.lib_path())) for k in KERNELS}})


def _encoding(tier: str, aabb_scale: int = 4):
    """The tier's position encoding on the card, per_level_scale filled in
    as the engine does for ``aabb_scale``."""
    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.models.factory import create_encoding

    cfg = dict(default_config(tier)["encoding"])
    cfg.setdefault("per_level_scale", math.exp(
        math.log(2048.0 * aabb_scale / cfg["base_resolution"]) / (cfg["n_levels"] - 1)))
    return create_encoding(3, cfg, "cuda")


def _bound(n_bytes: float, n_ops: float) -> dict:
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = n_ops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _kernel_case(tier: str, table_dtype, gen, n: int = N_KERNEL, x=None,
                 aabb_scale: int = 4, profiled: bool = True, enc=None,
                 rows_read: int | None = None):
    """B1 against its twin, exactly, on ``n`` uniform positions (or the
    positions ``x``) with a random table of ``table_dtype``, for the 3D
    tier ``tier``'s encoding or the encoding ``enc`` (``tier`` then names
    it). With a bf16 table it also times the cast of the float32 table
    that the encoding makes before each call ("cast_ms").
    ``profiled=False`` times by CUDA events only (``call_ms``,
    ``plain_ms``): no ``ms``, ``cast_ms`` or library yardstick. The bound
    reads ``rows_read`` table rows (default: every live row)."""
    import torch

    from ngp_tpu_torch.ops.hashgrid import hashgrid_encode_cuda, hashgrid_encode_reference

    enc = enc if enc is not None else _encoding(tier, aabb_scale)
    L, T, F = enc.table.shape
    D = enc.n_input_dims
    C = 1 << D
    master = (torch.rand((L, T, F), generator=gen) * 2 - 1).cuda()
    table = master.to(table_dtype)
    if x is None:
        x = torch.rand((n, D), generator=gen).cuda()
    n = x.shape[0]
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed,
           enc.hash_variant)
    out = hashgrid_encode_cuda(x, table, *geo)
    torch.cuda.synchronize()
    ref = hashgrid_encode_reference(x, table, *geo)
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not torch.equal(out, ref):
        raise AssertionError(f"{tier} {table_dtype}: differs from the twin, "
                             f"max abs err {err}")
    ms = device_ms(lambda: hashgrid_encode_cuda(x, table, *geo)) if profiled else None
    call_ms = cuda_ms(lambda: hashgrid_encode_cuda(x, table, *geo), iters=20)
    plain_ms = cuda_ms(lambda: hashgrid_encode_reference(x, table, *geo),
                       iters=3, warmup=1)
    # bound: positions read and features written once, each table row read
    # once (every live row unless rows_read says); operations: 3D for p,
    # 2^D·(D-1) weight products and 2·2^D·F multiply-adds per (sample,
    # level), float32 rate
    sizes = geo[2].tolist()
    rows_read = sum(sizes) if rows_read is None else rows_read
    row = {
        "tier": tier, "table": str(table_dtype).replace("torch.", ""),
        "N": n, "L": L, "T": T, "F": F, "hash": enc.hash_variant,
        "max_abs_err": err, "max_abs_ref": scale, "call_ms": call_ms, "plain_ms": plain_ms,
        "rows_read": rows_read,
        **_bound(n * D * 4 + n * L * F * 4 + rows_read * F * table.element_size(),
                 n * L * (3 * D + C * (D - 1) + 2 * C * F)),
        "table_bf16_reads_on_main_path": enc.bf16_reads,
    }
    if not profiled:
        return row
    cast = ({"cast_ms": device_ms(lambda: master.to(torch.bfloat16))}
            if table_dtype == torch.bfloat16 else {})
    return {**row, "ms": ms, "library_ms": _embedding_bag_ms(x, table, geo, ref), **cast}


def _embedding_bag_ms(x, table, geo, ref, interp: str = "Linear") -> float:
    """The forward's yardstick: the gather and weighted sum as one library
    call (embedding_bag, mode "sum", per-corner weights), given corner rows
    and weights computed beforehand with the twin's arithmetic (excluded);
    its device ms. It must agree with the twin's output ``ref``."""
    import torch
    import torch.nn.functional as tnf

    from ngp_tpu_torch.ops.hashgrid import _level_corners, _levels, n_corners

    n, D = x.shape
    L, T, F = table.shape
    C = n_corners(D, interp)
    idx = torch.empty((n, L, C), dtype=torch.int64, device="cuda")
    wts = torch.empty((n, L, C), dtype=torch.float32, device="cuda")
    for l, lg in enumerate(_levels(*geo[:4])):
        for c, (i, w) in enumerate(_level_corners(x, *lg, geo[4] == "additive", interp)):
            idx[:, l, c] = l * T + i
            wts[:, l, c] = w
    flat = table.float().reshape(L * T, F)
    bags, bag_w = idx.reshape(-1, C), wts.reshape(-1, C)
    lib = tnf.embedding_bag(bags, flat, per_sample_weights=bag_w, mode="sum")
    lib_err = float((lib.reshape(n, L * F) - ref).abs().max())
    if not lib_err <= 1e-4 * float(ref.abs().max()):
        raise AssertionError(f"yardstick disagrees with the twin: {lib_err}")
    return device_ms(lambda: tnf.embedding_bag(
        bags, flat, per_sample_weights=bag_w, mode="sum"), iters=10)


def phase_kernel():
    import torch

    gen = torch.Generator().manual_seed(0)
    for tier in ("tpu", "upstream"):
        for dt in (torch.float32, torch.bfloat16):
            emit({"phase": "kernel", **_kernel_case(tier, dt, gen)})


def _lookat(eye, target):
    """Camera-to-world (3, 4) looking from ``eye`` at ``target`` with +z up,
    in float32 as tests/test_nerf_engine.py:_lookat_xform computes it."""
    import numpy as np

    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray([0.0, 0.0, 1.0], np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], axis=1).astype(np.float32)


def _dataset(eyes, res, focal, aabb_scale):
    import numpy as np

    from ngp_tpu_torch.data.nerf_loader import NerfDataset
    from ngp_tpu_torch.geometry.camera import Lens

    center = np.full(3, 0.5, np.float32)
    xf = np.stack([_lookat(e, center) for e in eyes])
    n = len(eyes)
    return NerfDataset(
        images=np.zeros((n, res[1], res[0], 4), np.uint8),
        xforms=np.stack([xf, xf], axis=1),
        focal_lengths=np.full((n, 2), focal, np.float32),
        principal_points=np.full((n, 2), 0.5, np.float32),
        lens=Lens(), resolution=res, aabb_scale=aabb_scale,
    )


def phase_golden():
    """The golden fixture: settings of tests/golden/make_golden.py, the
    camera ring of tests/test_nerf_engine.py:_make_dataset(6) (RES 48,
    FOCAL 48, eyes at 1.1 from the center, z = 0.3·sin(3·angle))."""
    import numpy as np
    import torch

    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.hashgrid import HASHGRID_ENCODE

    cfg = {
        "encoding": {"otype": "HashGrid", "n_levels": 8, "n_features_per_level": 2,
                     "log2_hashmap_size": 15, "base_resolution": 16,
                     "per_level_scale": 1.5},
        "network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                    "output_activation": "None", "n_neurons": 64,
                    "n_hidden_layers": 1},
        "dir_encoding": {"otype": "Composite", "nested": [
            {"n_dims_to_encode": 3, "otype": "SphericalHarmonics", "degree": 4},
            {"otype": "Identity"}]},
        "rgb_network": {"otype": "FullyFusedMLP", "activation": "ReLU",
                        "output_activation": "None", "n_neurons": 64,
                        "n_hidden_layers": 2},
    }
    center = np.full(3, 0.5, np.float32)
    eyes = []
    for i in range(6):
        a = 2 * math.pi * i / 6
        eyes.append(center + np.asarray(
            [math.cos(a), math.sin(a), 0.3 * math.sin(3 * a)], np.float32) * 1.1)
    eng = NerfEngine(cfg, _dataset(eyes, (48, 48), 48.0, 1), grid_size=16,
                     n_steps_per_unit=128, seed=11)
    state, grid = eng.load_reference_snapshot(
        os.path.join(ROOT, "tests", "golden", "golden.ingp"))
    HASHGRID_ENCODE.launches["hashgrid_encode"] = 0
    img = eng.render_image(state, grid, 0, stride=4)
    torch.cuda.synchronize()
    launches = HASHGRID_ENCODE.launches["hashgrid_encode"]
    gold = np.load(os.path.join(ROOT, "tests", "golden", "golden.npz"))["render"]
    got = img.cpu().numpy()
    err = float(np.abs(got - gold).max())
    emit({"phase": "golden", "shape": list(got.shape), "max_abs_err": err,
          "tol": GOLDEN_TOL, "samples": eng.last_render_samples,
          "hashgrid_launches": launches})
    if got.shape != gold.shape or not np.allclose(got, gold, rtol=GOLDEN_TOL,
                                                  atol=GOLDEN_TOL):
        raise AssertionError(f"golden render differs: max abs err {err}")
    if launches == 0:
        raise AssertionError("golden render did not launch hashgrid_encode_cuda")


def _sphere_density(grid_cfg, radius: float):
    """An analytic occupancy grid: density 1 inside a ball of ``radius``
    around the scene center (0.5,)³, 0 elsewhere, in every cascade."""
    import torch

    G, C = grid_cfg.grid_size, grid_cfg.n_cascades
    r = (torch.arange(G, device="cuda", dtype=torch.float32) + 0.5) / G - 0.5
    dens = []
    for c in range(C):
        x = r * (2.0 ** c)
        d2 = x[:, None, None] ** 2 + x[None, :, None] ** 2 + x[None, None, :] ** 2
        dens.append((d2 <= radius * radius).float())
    return torch.stack(dens)


def _profile_summary(prof, stages: tuple, outer: str, outer_default: str) -> dict:
    """Device time per stage of a trace whose work sits in ``outer``
    ranges that hold ``stages`` ranges: a kernel belongs to the shortest
    range whose device span holds it; kernels in an ``outer`` range and in
    no stage count as ``outer_default``, kernels outside every range as
    "other"; with each stage's count of kernels and copies. Also the
    device's busy time (union of kernel and copy intervals) and the eight
    kernels with the most device time. The
    profiler puts each range on the device timeline as an annotation span;
    those spans only attribute kernels to stages. The window's
    :func:`_lead_in` kernels are left out."""
    from torch.autograd import DeviceType

    names = set(stages) | {outer}
    spans = []
    ops = []
    outside = _outside_lead(prof)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in names:
            spans.append((e.time_range.start, e.time_range.end, e.name))
        elif not e.is_user_annotation and outside(e.time_range.start, e.time_range.end):
            ops.append((e.time_range.start, e.time_range.end, e.name))

    stage_us = dict.fromkeys((*stages, outer_default, "other"), 0.0)
    stage_ops = dict.fromkeys(stage_us, 0)
    for a, b, _ in ops:
        held = [(t - s, n) for s, t, n in spans if s <= a and b <= t]
        name = min(held)[1] if held else "other"
        stage = outer_default if name == outer else name
        stage_us[stage] += b - a
        stage_ops[stage] += 1
    busy_us, end = 0.0, float("-inf")
    for a, b, _ in sorted(ops):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for a, b, name in ops:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (b - a) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "stage_device_ms": {k: v / 1e3 for k, v in stage_us.items()},
        "stage_device_ops": stage_ops,
        "device_busy_ms": busy_us / 1e3, "device_ops": len(ops),
        "top_device_ms": [[name[:90], ms, n] for name, (ms, n) in top],
    }


def _ranged(name, fn):
    from torch.profiler import record_function

    def run(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)
    return run


def _keep_largest(module, name: str, kept: list):
    """Wrap ``module.name`` so that the arguments of its call with the most
    rows are kept (by reference) in ``kept``; returns the original."""
    fn = getattr(module, name)

    def keep(x, *args, **kwargs):
        if not kept or x.shape[0] > kept[0][0].shape[0]:
            kept[:] = [(x, *args)]
        return fn(x, *args, **kwargs)

    setattr(module, name, keep)
    return fn


def phase_serve():
    """Full-width "tpu" tier, seeded weights, aabb_scale 4, three 960×540
    views of an orbit at radius 2 (60° horizontal field of view) around a
    ball of radius 0.5 in the occupancy grid; K = 192, compaction 0.625."""
    import numpy as np
    import torch

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    res = (960, 540)
    focal = 0.5 * res[0] / math.tan(math.radians(30.0))
    eyes = [np.full(3, 0.5, np.float32)
            + np.asarray([math.cos(a), math.sin(a), 0.3], np.float32) * 2.0
            for a in (0.0, 2.0 * math.pi / 3, 4.0 * math.pi / 3)]
    eng = NerfEngine(default_config("tpu"), _dataset(eyes, res, focal, 4))
    state = eng.init_state()
    grid = eng.grid_from_density(_sphere_density(eng.grid_cfg, 0.5))
    torch.cuda.synchronize()

    reset_launches()
    frames = []
    for view in range(len(eyes)):
        before = launch_counts()
        t0 = time.perf_counter()
        img = eng.render_image(state, grid, view)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if tuple(img.shape) != (res[1], res[0], 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"frame {view}: shape {tuple(img.shape)} or non-finite")
        frame = {"phase": "serve", "frame": view, "ms": ms,
                 "samples": eng.last_render_samples,
                 "launches": {k: n - before[k] for k, n in launch_counts().items()},
                 "mean_rgb": float(img.mean()), "n_lattice": eng.n_lattice,
                 "chunk_rays": eng.ray_chunk}
        frames.append(frame)
        emit(frame)
    launches = launch_counts()
    if launches["hashgrid_encode"] == 0:
        raise AssertionError("serve path launched hashgrid_encode no time")

    # One more render of view 0 under torch.profiler, each ray chunk's
    # stages inside record_function ranges: device time per stage, the
    # heaviest kernels, and the share of the frame the device was busy.
    from torch.profiler import ProfilerActivity, profile

    # The same render also keeps the positions of its largest B1 launch (a
    # reference, no copy), on which phase kernel_serve_positions times B1.
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops

    largest = []
    eng._render_chunk = _ranged("chunk", eng._render_chunk)
    eng._eval_marched = _ranged("shade", eng._eval_marched)
    eng._finish_shade = _ranged("composite", eng._finish_shade)
    encode = _keep_largest(hashgrid_ops, "hashgrid_encode_cuda", largest)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _lead_in()
            t0 = time.perf_counter()
            eng.render_image(state, grid, 0)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        hashgrid_ops.hashgrid_encode_cuda = encode
    emit({"phase": "serve_profile", "view": 0, "wall_ms": wall_ms,
          **_profile_summary(prof, ("shade", "composite"), "chunk", "march")})
    return frames, launches, largest[0][0]


def train_inputs(n_samples: int):
    """The grid backward's inputs at a training step's shape: ``n_samples``
    uniform positions and small cotangents for the "tpu" tier at aabb_scale
    1. Returns (x, g, geometry, T), geometry being the encoding's (scale,
    res, size, hashed, hash_variant)."""
    import torch

    enc = _encoding("tpu", aabb_scale=1)
    L, T, F = enc.table.shape
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed,
           enc.hash_variant)
    gen = torch.Generator().manual_seed(2)
    x = torch.rand((n_samples, 3), generator=gen).cuda()
    g = (torch.randn((n_samples, L * F), generator=gen) * 1e-3).cuda()
    return x, g, geo, T


def segsum_times(keys, vals, T: int, sizes: list) -> dict:
    """Device ms of ``batched_segment_sum`` (zero-fill and kernel) over all
    levels and for each level alone (``sizes``: its rows), beside the
    ``index_add_`` yardstick timed alike: a zeroed output made inside the
    timed call, then one ``index_add_`` of addends rounded to bf16 and keys
    offset per level beforehand (outside the timing, which favours the
    library)."""
    import torch

    from ngp_tpu_torch.ops.segsum import batched_segment_sum

    L, M, F = vals.shape

    def index_add(k, v, rows):
        return lambda: torch.zeros((rows, F), device="cuda").index_add_(0, k, v)

    def times(k, v, lib):
        return {"ms": device_ms(lambda: batched_segment_sum(k, v, T)),
                "library_ms": device_ms(lib)}

    rounded = vals.to(torch.bfloat16).float()
    flat_keys = (keys.long() + torch.arange(L, device="cuda")[:, None] * T).reshape(-1)
    out = {"all_levels": times(keys, vals,
                               index_add(flat_keys, rounded.reshape(-1, F), L * T))}
    out["levels"] = [
        {"level": l, "rows": sizes[l],
         **times(keys[l:l + 1], vals[l:l + 1], index_add(keys[l].long(), rounded[l], T))}
        for l in range(L)]
    return out


def _sum_error(name, got, want, k, v, T, payload: str = "bfloat16"):
    """Max abs error of a float32 sum of addends (rounded to ``payload``)
    against its twin's: within 2·(n−1)·2^-24·Σ|addend| per row (a float32
    sum of n addends in any order is within half that of the exact one),
    untouched rows +0.0."""
    import torch

    from ngp_tpu_torch.ops import segsum

    n = segsum.segment_count_reference(k, T)[..., None].float()
    mass = segsum.segment_sum_reference(k, v.abs(), T, payload)
    excess = (got - want).abs() - 2.0 * n * 2.0 ** -24 * mass
    if float(excess.max()) > 0:
        raise AssertionError(f"{name}: beyond the float32 order bound")
    if bool(torch.signbit(got[mass == 0]).any()) or bool((got[mass == 0] != 0).any()):
        raise AssertionError(f"{name}: an untouched row is not +0.0")
    return float((got - want).abs().max())


def backward_levels(x, g, geo, keys, T: int) -> list:
    """Device ms of the fused grid backward and of the histogram for each
    level alone: the backward on that level's geometry and cotangents, B3
    on its keys (each with its zeroed output)."""
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_cuda
    from ngp_tpu_torch.ops.segsum import segment_count_cuda

    L = geo[0].shape[0]
    F = g.shape[1] // L
    out = []
    for l in range(L):
        one = tuple(t[l:l + 1] for t in geo[:4]) + (geo[4],)
        gl = g[:, l * F:(l + 1) * F].contiguous()
        kl = keys[l:l + 1]
        out.append({
            "level": l, "rows": int(geo[2][l]),
            "backward_ms": device_ms(lambda: hashgrid_backward_cuda(x, gl, *one, None, T)),
            "segment_count_ms": device_ms(lambda: segment_count_cuda(kl, T)),
        })
    return out


def _backward_row(x, g, geo, T: int, keys, vals, payload: str = "bfloat16",
                  interp: str = "Linear") -> dict:
    """The fused grid backward, (x, g) → d(table) with addends rounded to
    ``payload`` (bf16 on the training path, float32 where the positions are
    differentiable) summed in float32, against its twin within the float32
    order bound (``keys`` and ``vals``: the twin's corner keys and
    addends); its times and bound."""
    import torch

    from ngp_tpu_torch.ops import segsum
    from ngp_tpu_torch.ops.hashgrid import (
        hashgrid_backward_cuda,
        hashgrid_backward_reference,
        n_corners,
    )

    (n_samples, D), L, F = x.shape, vals.shape[0], vals.shape[2]
    C = n_corners(D, interp)
    bwd = lambda: hashgrid_backward_cuda(x, g, *geo, None, T, payload, interp)  # noqa: E731
    got = bwd()
    torch.cuda.synchronize()
    err = _sum_error("hashgrid_backward", got,
                     segsum.segment_sum_reference(keys, vals, T, payload), keys, vals, T,
                     payload)
    del got
    return {
        "max_abs_err": err, "ms": device_ms(bwd), "call_ms": cuda_ms(bwd, iters=20),
        "plain_ms": cuda_ms(lambda: hashgrid_backward_reference(x, g, *geo, None, T, payload,
                                                                interp),
                            iters=3, warmup=1),
        "library_ms": None,
        # positions and cotangents read once, d(table) written once;
        # 3D + C·(D−1) weight operations and C·F products and sums per
        # (sample, level), C the corners (2^D, or D + 1 for Simplex)
        **_bound(n_samples * (4 * D + 4 * L * F) + L * T * F * 4,
                 n_samples * L * (3 * D + C * (D - 1) + 2 * C * F)),
    }


def phase_kernel_train(shape: str, x, g, geo, T: int) -> dict:
    """Each training kernel against its twin at a step's shapes: the fused
    grid backward of positions ``x`` (N, 3) and cotangents ``g`` (N, L·F)
    at the encoding geometry ``geo``, then the segment sum, the histogram
    and the one-level entry points on the corner keys and addends that the
    backward's twin makes of them; on uniform positions also B1's forward.
    Per kernel: ``ms``, the device time of a call (its output's zero-fill
    included) from the profiler; ``call_ms``, CUDA events around 20 calls
    of the wrapper; the twin's time, the library yardstick's device time
    (timed alike) and the bound. The segment sum also per level (phase
    ``segsum_levels``), the backward and the histogram too (phase
    ``backward_levels``). Returns the kernels' rows of the ``kernels``
    line (without launches)."""
    import torch

    from ngp_tpu_torch.ops import segsum
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference

    n_samples = x.shape[0]
    sizes = geo[2].tolist()
    # the corner keys (L, 8N) and addends (L, 8N, F) as the backward's twin
    # makes them on the card: the inputs of B2, B3 and B4
    keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
    L, M, F = vals.shape
    rows = {}

    if shape != "captured_step":
        # B1 forward at the step's shape: the same positions, bf16 reads
        emit({"phase": "kernel_train", "shape": shape, "kernel": "hashgrid_encode",
              **_kernel_case("tpu", torch.bfloat16, torch.Generator().manual_seed(3),
                             x=x, aabb_scale=1)})

    rows["hashgrid_backward"] = _backward_row(x, g, geo, T, keys, vals)
    emit({"phase": "backward_levels", "shape": shape, "N": n_samples,
          "levels": backward_levels(x, g, geo, keys, T)})

    # B2: the segment sum of those addends (bf16 payloads)
    got = segsum.segment_sum_cuda(keys, vals, T)
    torch.cuda.synchronize()
    err = _sum_error("segment_sum", got, segsum.segment_sum_reference(keys, vals, T),
                     keys, vals, T)
    del got
    times = segsum_times(keys, vals, T, sizes)
    emit({"phase": "segsum_levels", "shape": shape, "N": n_samples, "M": M, **times})
    b2 = lambda: segsum.segment_sum_cuda(keys, vals, T)  # noqa: E731
    rows["segment_sum"] = {
        "max_abs_err": err, "ms": times["all_levels"]["ms"],
        "call_ms": cuda_ms(b2, iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_sum_reference(keys, vals, T),
                            iters=3, warmup=1),
        # yardstick: one index_add_ into a zeroed flattened table
        # (segsum_times)
        "library_ms": times["all_levels"]["library_ms"],
        # keys and addends read once, the dense table written once
        **_bound(L * M * (4 + 4 * F) + L * T * F * 4, L * M * F),
    }

    # B3: the per-level histogram of the same keys
    got = segsum.segment_count_cuda(keys, T)
    torch.cuda.synchronize()
    if not torch.equal(got, segsum.segment_count_reference(keys, T)):
        raise AssertionError("segment_count differs from the twin")
    flat_keys = (keys.long() + torch.arange(L, device="cuda")[:, None] * T).reshape(-1)
    b3 = lambda: segsum.segment_count_cuda(keys, T)  # noqa: E731
    rows["segment_count"] = {
        "max_abs_err": 0.0, "ms": device_ms(b3), "call_ms": cuda_ms(b3, iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_count_reference(keys, T),
                            iters=3, warmup=1),
        # bincount makes its zeroed output itself
        "library_ms": device_ms(lambda: torch.bincount(flat_keys, minlength=L * T)),
        **_bound(L * M * 4 + L * T * 4, L * M),
    }

    # B4: the one-level entry points, on the finest level's keys
    k1, v1 = keys[-1].contiguous(), vals[-1].contiguous()
    got = segsum.segment_sum_onehot(k1, v1, T)
    torch.cuda.synchronize()
    err = _sum_error("segment_sum_onehot", got[None],
                     segsum.segment_sum_reference(k1[None], v1[None], T),
                     k1[None], v1[None], T)
    k1l, v1b = k1.long(), v1.to(torch.bfloat16).float()
    b4 = lambda: segsum.segment_sum_onehot(k1, v1, T)  # noqa: E731
    rows["segment_sum_onehot"] = {
        "max_abs_err": err, "ms": device_ms(b4), "call_ms": cuda_ms(b4, iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_sum_reference(k1[None], v1[None], T),
                            iters=3, warmup=1),
        "library_ms": device_ms(
            lambda: torch.zeros((T, F), device="cuda").index_add_(0, k1l, v1b)),
        **_bound(M * (4 + 4 * F) + T * F * 4, M * F),
    }
    got = segsum.segment_count_onehot(k1, T)
    torch.cuda.synchronize()
    if not torch.equal(got, segsum.segment_count_reference(k1[None], T)[0]):
        raise AssertionError("segment_count_onehot differs from the twin")
    b4c = lambda: segsum.segment_count_onehot(k1, T)  # noqa: E731
    rows["segment_count_onehot"] = {
        "max_abs_err": 0.0, "ms": device_ms(b4c), "call_ms": cuda_ms(b4c, iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_count_reference(k1[None], T),
                            iters=3, warmup=1),
        "library_ms": device_ms(lambda: torch.bincount(k1l, minlength=T)),
        **_bound(M * 4 + T * 4, M),
    }
    for name, row in rows.items():
        emit({"phase": "kernel_train", "shape": shape, "kernel": name,
              "N": n_samples, "L": L, "M": M, "T": T, "F": F, **row})
    return rows


def phase_kernel_sort() -> dict:
    """B5 against its twin at the size the JAX kernel was written for
    (``ngp_tpu/ops/pallas/sort.py``: 2^20 keys a row): (B, n) = (4, 2^20),
    keys uniform in [0, 2^18) (the "tpu" tier's T, so ties are dense), the
    last 3 of each row INT32_MAX. Keys and perm must equal the twin's
    exactly. Yardstick: ``torch.sort`` along the rows (it writes int64
    indices, 4 bytes an element more than the kernel)."""
    import torch

    from ngp_tpu_torch.ops.sort import (
        INT32_MAX,
        bitonic_sort_launches,
        bitonic_sort_pos_cuda,
        bitonic_sort_pos_reference,
    )

    B, n = 4, 1 << 20
    keys = torch.randint(0, 1 << 18, (B, n), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    keys[:, -3:] = INT32_MAX
    keys = keys.cuda()
    got_k, got_p = bitonic_sort_pos_cuda(keys)
    torch.cuda.synchronize()
    want_k, want_p = bitonic_sort_pos_reference(keys)
    if not (torch.equal(got_k, want_k) and torch.equal(got_p, want_p)):
        raise AssertionError("bitonic_sort_pos differs from the twin")
    lib_k = torch.sort(keys, dim=1).values
    if not (torch.equal(got_k, lib_k) and torch.equal(keys.gather(1, got_p.long()), got_k)):
        raise AssertionError("bitonic_sort_pos: keys not sorted or perm not theirs")
    del want_k, want_p, lib_k
    stages = int(math.log2(n)) * (int(math.log2(n)) + 1) // 2
    b5 = lambda: bitonic_sort_pos_cuda(keys)  # noqa: E731
    row = {
        "max_abs_err": 0.0, "ms": device_ms(b5), "call_ms": cuda_ms(b5, iters=20),
        "plain_ms": cuda_ms(lambda: bitonic_sort_pos_reference(keys), iters=3, warmup=1),
        "library_ms": device_ms(lambda: torch.sort(keys, dim=1)),
        # keys read once, sorted keys and perm written once; one comparison
        # per pair per stage
        **_bound(B * n * 12, B * n // 2 * stages),
    }
    launches = bitonic_sort_launches(n)
    emit({"phase": "kernel_sort", "B": B, "n": n, "stages": stages,
          "launches_per_call": launches,
          "launch_ms": launch_sequence_ms(b5, launches), **row})
    return row


def phase_train():
    """The bench's fallback configuration, 400 steps through
    ``NerfEngine.train`` one step per call (each synchronized and timed);
    then the PSNR of view 0, and one more step whose grid backward's
    arguments are kept (positions, cotangents, geometry; by reference)."""
    import numpy as np
    import torch

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.synthetic import tiny_sphere_dataset
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    eng = NerfEngine(default_config("tpu"), tiny_sphere_dataset(n_views=12, res=128),
                     batch_size=1 << 18)
    state, grid = eng.init_state(), eng.init_grid()
    torch.cuda.synchronize()
    reset_launches()
    step_ms, samples, geometry = [], [], []
    t_start = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, grid, metrics = eng.train(state, grid, 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        samples.append(metrics["network_samples"])
        geometry.append(eng.batch_geometry)
    wall_s = time.perf_counter() - t_start
    launches = launch_counts()
    loss = float(metrics["loss"])
    psnr = eng.psnr(state, grid, 0)
    steady = step_ms[256:]  # after the all-cells warm-up sweeps
    result = {
        "phase": "train", "steps": TRAIN_STEPS, "wall_s": wall_s,
        "median_ms_per_step": float(np.median(steady)),
        "median_ms_per_step_warmup_32_256": float(np.median(step_ms[32:256])),
        "first_step_ms": step_ms[0],
        "network_samples_per_s": float(sum(samples[256:]) / (sum(steady) / 1e3)),
        "network_samples_per_step": float(np.mean(samples[256:])),
        "final_loss": loss, "k_and_rays": list(geometry[-1]),
        "geometry_changes": sorted({tuple(gm) for gm in geometry}),
        "seg_budget": eng._seg_budget,
        "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items()},
        "occupied_fraction": float(grid.bitfield[0].float().mean()),
        "psnr_view0": psnr, "psnr_min": TRAIN_PSNR_MIN,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(result)
    if not math.isfinite(loss):
        raise AssertionError(f"training loss is not finite: {loss}")
    if not psnr >= TRAIN_PSNR_MIN:
        raise AssertionError(f"PSNR {psnr} dB after {TRAIN_STEPS} steps < {TRAIN_PSNR_MIN}")
    for name in ("hashgrid_encode", "hashgrid_backward"):
        if launches[name] == 0:
            raise AssertionError(f"the training path launched {name} no time")

    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops

    backward = hashgrid_ops.hashgrid_backward_cuda
    kept = []

    def keep(x, g, *geo_and_rows):
        kept[:] = [(x, g, *geo_and_rows)]
        return backward(x, g, *geo_and_rows)

    hashgrid_ops.hashgrid_backward_cuda = keep
    try:
        state, grid, _ = eng.train(state, grid, 1)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_backward_cuda = backward
    x, g, scale, res, size, hashed, variant, _, n_rows = kept[0][:9]  # then the payload
    return eng, state, grid, launches, result, (x, g, (scale, res, size, hashed, variant),
                                                n_rows)


def _profile_steps(eng, state, grid, n_steps: int, threaded: bool):
    """``n_steps`` steps as phase train times them (one ``NerfEngine.train``
    call and a synchronize each) under torch.profiler, each step in a
    "step" range. Returns the grid, the trace and the wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            torch.autograd.set_multithreading_enabled(threaded):
        _lead_in()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            with record_function("step"):
                state, grid, _ = eng.train(state, grid, 1)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return grid, prof, wall_ms


def phase_train_profile(eng, state, grid, timed_median_ms: float):
    """Two windows of 16 more steps (one occupancy-update cycle each) under
    torch.profiler, each stage in a record_function range. The first runs
    as phase train does: its device busy time per step over its wall time,
    and over the unprofiled median step, is the device's busy share. The
    second runs the backward on the calling thread, so that its kernels
    fall in the "backward" range (autograd's device thread launches them
    outside it): its device ms per stage is the breakdown."""
    import torch

    from ngp_tpu_torch.engines import nerf as engine_mod
    from ngp_tpu_torch.models import encodings

    march, loss = engine_mod.march_rays, engine_mod.nerf_training_loss
    engine_mod.march_rays = _ranged("march", march)
    engine_mod.nerf_training_loss = _ranged("loss", loss)
    eng._network_on_samples = _ranged("network_forward", eng._network_on_samples)
    eng.apply_grads = _ranged("optimizer", eng.apply_grads)
    eng.update_grid = _ranged("grid_update", eng.update_grid)
    grid_bwd = encodings._GridEncode.backward
    encodings._GridEncode.backward = staticmethod(_ranged("grid_backward", grid_bwd))
    backward = torch.Tensor.backward
    torch.Tensor.backward = _ranged("backward", backward)
    stages = ("march", "network_forward", "loss", "backward", "grid_backward",
              "optimizer", "grid_update")
    n = TRAIN_PROFILE_STEPS
    try:
        for window, threaded in (("as_timed", True), ("backward_on_caller", False)):
            first = state.step
            grid, prof, wall_ms = _profile_steps(eng, state, grid, n, threaded)
            summary = _profile_summary(prof, stages, "step", "step_other")
            busy_ms = summary["device_busy_ms"] / n
            emit({"phase": "train_profile", "window": window,
                  "autograd_multithreading": threaded, "steps": [first, state.step - 1],
                  "wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy_ms,
                  "busy_share_of_profiled_wall": busy_ms / (wall_ms / n),
                  "busy_share_of_unprofiled_median": busy_ms / timed_median_ms,
                  "device_ops_per_step": summary["device_ops"] / n,
                  "stage_device_ms_per_step": {
                      k: v / n for k, v in summary["stage_device_ms"].items()},
                  "top_device_ms": summary["top_device_ms"]})
    finally:
        torch.Tensor.backward = backward
        encodings._GridEncode.backward = staticmethod(grid_bwd)
        engine_mod.march_rays, engine_mod.nerf_training_loss = march, loss


def _camera_rays(eye, center, res, hfov_deg: float):
    """Origins and unit directions (H·W, 3) on the card of a pinhole camera
    at ``eye`` looking at ``center`` (``_lookat``), ``res`` = (W, H), the
    horizontal field of view ``hfov_deg``, through the pixel centers row by
    row."""
    import numpy as np
    import torch

    xf = torch.from_numpy(_lookat(np.asarray(eye, np.float32),
                                  np.asarray(center, np.float32))).cuda()
    W, H = res
    f = 0.5 * W / math.tan(math.radians(hfov_deg) / 2)
    u = (torch.arange(W, device="cuda") + 0.5 - 0.5 * W) / f
    v = (torch.arange(H, device="cuda") + 0.5 - 0.5 * H) / f
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([uu, vv, torch.ones_like(uu)], -1).reshape(-1, 3) @ xf[:, :3].T
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return xf[:, 3].expand(d.shape[0], 3).contiguous(), d


def _busy_ms_raw(prof) -> float:
    """The device's busy ms of a profiler window (union of its kernel and
    copy intervals outside the :func:`_lead_in` range) read from the
    window's raw records: :func:`_profile_summary`'s ``device_busy_ms``
    without building its event tree, which takes over a minute for a
    frame of ~10^5 operations."""
    from torch.autograd import DeviceType

    records = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    lead = [(e.start_ns(), e.end_ns()) for e in records
            if e.is_user_annotation() and e.name() == PROFILER_LEAD]
    ops = sorted((e.start_ns(), e.end_ns()) for e in records if not e.is_user_annotation()
                 and not any(s <= e.start_ns() and e.end_ns() <= t for s, t in lead))
    busy_ns, end = 0, float("-inf")
    for a, b in ops:
        busy_ns += max(0, b - max(a, end))
        end = max(end, b)
    return busy_ns / 1e6


def _frame_device_ms(fn, event_tree: bool = False):
    """The device's busy ms (union of kernel and copy intervals) over one
    call of ``fn`` under torch.profiler, padded as in :func:`device_ms`,
    after a :func:`_lead_in`, from the window's raw records
    (:func:`_busy_ms_raw`); with ``event_tree`` also as
    :func:`_profile_summary` counts it, (raw, event tree)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_PAD_S)
        _lead_in()
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_PAD_S)
    raw = _busy_ms_raw(prof)
    if event_tree:
        return raw, _profile_summary(prof, (), "frame", "frame")["device_busy_ms"]
    return raw


def normals_rays():
    """Rays (o, d) on the card of phase normals' NORMALS_RES view of phase
    train's sphere."""
    import numpy as np

    center = np.asarray(SPHERE_CENTER, np.float32)
    eye = center + np.asarray([math.cos(0.4), math.sin(0.4), 0.3], np.float32) * 1.1
    return _camera_rays(eye, center, NORMALS_RES, 60.0)


def image_geometry_2d_case():
    """The input gradient's D = 2 case on the card: the image config's
    geometry (16 levels, F = 2, base 16, scale 2.0, XOR) at T =
    2^INPUT_GRAD_2D_LOG2, with 2^18 uniform positions, normal cotangents
    and a uniform table from seed 12: (x, g, table, geometry)."""
    import torch

    from ngp_tpu_torch.models.encodings import GridEncoding

    enc = GridEncoding(n_input_dims=2, n_levels=16, n_features_per_level=2,
                       log2_hashmap_size=INPUT_GRAD_2D_LOG2, base_resolution=16,
                       per_level_scale=2.0, hash_variant="tcnn", device="cuda")
    gen = torch.Generator().manual_seed(12)
    L, T, F = enc.table.shape
    x = torch.rand((1 << 18, 2), generator=gen).cuda()
    g = torch.randn((1 << 18, L * F), generator=gen).cuda()
    table = (torch.rand((L, T, F), generator=gen) * 2 - 1).cuda()
    return x, g, table, (enc.level_scale, enc.level_res, enc.level_size,
                         enc.level_hashed, "tcnn")


def _input_grad_row(x, g, table, geo, interp: str = "Linear") -> dict:
    """``hashgrid_input_grad_cuda`` on (x, g, table) against its twin on the
    card: it must give the twin's bits (``bit_exact``), and so lie within
    the float32 order bound 2·(n − 1)·2^-24·Σ|term| per component, which is
    checked too; its registers a thread (:func:`ptxas_registers`), times
    and bound. No single PyTorch call computes dx, so no library time."""
    import torch

    from ngp_tpu_torch.ops.hashgrid import (
        hashgrid_input_grad_cuda,
        hashgrid_input_grad_mass,
        hashgrid_input_grad_reference,
        n_corners,
    )

    x = x.detach()  # a render's positions require grad
    (N, D), (L, T, F) = x.shape, table.shape
    C = n_corners(D, interp)
    run = lambda: hashgrid_input_grad_cuda(x, g, table, *geo, None, interp)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    want = hashgrid_input_grad_reference(x, g, table, *geo, None, interp)
    mass, n = hashgrid_input_grad_mass(x, g, table, *geo, None, interp)
    err = (got - want).abs()
    if bool((err.double() > 2.0 * (n - 1) * 2.0 ** -24 * mass).any()):
        raise AssertionError(f"hashgrid_input_grad: beyond the float32 order bound, "
                             f"max abs err {float(err.max())}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("hashgrid_input_grad: non-finite dx")
    bit_exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
    if not bit_exact:
        raise AssertionError(f"hashgrid_input_grad: not the twin's bits, max abs err "
                             f"{float(err.max())}")
    # the distinct table rows these positions read, each read once
    rows = _distinct_rows(x, geo, interp)
    del want, mass
    registers = _registers("hashgrid_input_grad_kernel",
                           f"Li{D}ELi{F}ELi{int(geo[4] == 'additive')}E", interp)
    return {
        "N": N, "D": D, "L": L, "T": T, "F": F, "hash": geo[4], "interpolation": interp,
        "max_abs_err": float(err.max()), "max_abs_dx": float(got.abs().max()),
        "bit_exact": bit_exact, "rows_read": rows,
        "registers": registers[0] if registers else None,
        "ms": device_ms(run), "call_ms": cuda_ms(run, iters=20),
        "plain_ms": cuda_ms(lambda: hashgrid_input_grad_reference(x, g, table, *geo, None,
                                                                  interp),
                            iters=3, warmup=1),
        "library_ms": None,
        # x and g read and dx written once, each distinct row read once;
        # per (sample, level) 3D for the cell, per corner 2F for the
        # feature sum and D·D for the weight products and the sums, then
        # 2D for dx
        **_bound(N * (4 * D + 4 * L * F + 4 * D) + rows * F * 4,
                 N * L * (3 * D + C * (2 * F + D * D) + 2 * D)),
    }


def phase_normals(eng, state, grid):
    """The debug render modes on phase train's sphere ("tpu" tier: additive
    hash, bf16 reads for σ, float32 reads for ∇σ): a 960×540 frame of the
    shade mode, then of the normals mode (launches counted, wall and
    device ms each), gated on the sphere's analytic normals; the input
    gradient on the normals frame's own positions and cotangents, on a D = 2
    case of the image geometry, and the unrounded grid backward, against
    their twins; then the positions, encoding and cost modes once each.
    Returns the normals frame's launches and the input gradient's row."""
    import numpy as np
    import torch

    from ngp_tpu_torch.engines import nerf as engine_mod
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches
    from ngp_tpu_torch.ops.hashgrid import (
        hashgrid_backward_addends_reference,
        hashgrid_backward_cuda,
        hashgrid_backward_reference,
    )

    center = np.asarray(SPHERE_CENTER, np.float32)
    o, d = normals_rays()
    render = lambda mode: eng.render_rays(state, grid, o, d, mode=mode)  # noqa: E731
    frames, kept = {}, []
    for mode in ("shade", "normals"):
        reset_launches()
        original = _keep_largest(hashgrid_ops, "hashgrid_input_grad_cuda", kept)
        try:
            t0 = time.perf_counter()
            rgb, depth, opacity = render(mode)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            hashgrid_ops.hashgrid_input_grad_cuda = original
        launches = launch_counts()
        frames[mode] = {"wall_ms": wall_ms, "launches": launches,
                        "samples": eng.last_render_samples,
                        "device_ms": _frame_device_ms(lambda: render(mode))}
    if not bool(torch.isfinite(rgb).all()):
        raise AssertionError("normals frame: non-finite values")
    normals_launches = frames["normals"]["launches"]
    if normals_launches["hashgrid_input_grad"] == 0:
        raise AssertionError("the normals frame launched hashgrid_input_grad no time")
    if normals_launches["hashgrid_backward"] != 0:
        raise AssertionError("the normals frame launched the table gradient")

    hit = opacity > NORMALS_OPACITY
    p = o[hit] + d[hit] * (depth[hit] / opacity[hit])[:, None]
    truth = p - torch.from_numpy(center).cuda()
    truth = truth / torch.linalg.norm(truth, dim=-1, keepdim=True)
    n = 2.0 * rgb[hit] - 1.0
    cos = (n * truth).sum(-1) / torch.clamp_min(torch.linalg.norm(n, dim=-1), 1e-12)
    median_cos = float(cos.median()) if cos.numel() else float("nan")
    hit_radius = torch.linalg.norm(p - torch.from_numpy(center).cuda(), dim=-1)
    result = {
        "phase": "normals", "res": list(NORMALS_RES),
        "shade": frames["shade"], "normals": frames["normals"],
        "pixels_gated": int(hit.sum()), "median_cos": median_cos,
        "cos_quantiles_10_50_90": [float(q) for q in torch.quantile(
            cos, torch.tensor([0.1, 0.5, 0.9], device="cuda"))] if cos.numel() else [],
        "median_hit_radius": float(hit_radius.median()) if cos.numel() else None,
        "sphere_radius": SPHERE_RADIUS,
        "opacity_min": NORMALS_OPACITY, "cos_gate": NORMALS_COS_MIN,
    }
    emit(result)
    if not median_cos >= NORMALS_COS_MIN:
        raise AssertionError(f"normals: median cosine {median_cos} < {NORMALS_COS_MIN} "
                             f"over {int(hit.sum())} pixels")

    # the input gradient on the frame's own positions and cotangents (D = 3),
    # then on a D = 2 case of the image config's geometry
    x, g, table, *geo = kept[0]
    x, geo = x.detach(), tuple(geo[:5])
    frame_row = _input_grad_row(x, g, table, geo)
    emit({"phase": "kernel_normals", "kernel": "hashgrid_input_grad",
          "shape": "normals_frame", "launches": normals_launches["hashgrid_input_grad"],
          **frame_row})
    x2, g2, t2, geo2 = image_geometry_2d_case()
    emit({"phase": "kernel_normals", "kernel": "hashgrid_input_grad",
          "shape": "image_geometry_2d", **_input_grad_row(x2, g2, t2, geo2)})
    del x2, g2, t2

    # the unrounded grid backward (float32 addends) on the frame's (x, g)
    T = table.shape[1]
    keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
    bwd = lambda: hashgrid_backward_cuda(x, g, *geo, None, T, "float32")  # noqa: E731
    got = bwd()
    torch.cuda.synchronize()
    err = _sum_error("hashgrid_backward (float32 addends)", got,
                     hashgrid_backward_reference(x, g, *geo, None, T, "float32"),
                     keys, vals, T, "float32")
    del got, keys, vals
    emit({"phase": "kernel_normals", "kernel": "hashgrid_backward", "payload": "float32",
          "shape": "normals_frame", "N": x.shape[0], "max_abs_err": err,
          "ms": device_ms(bwd), "call_ms": cuda_ms(bwd, iters=20)})

    # the other debug modes, once each; the cost mode is the march's count
    counts = []
    march = engine_mod.march_rays

    def keep_counts(*args, **kwargs):
        marched = march(*args, **kwargs)
        counts.append(marched.n_samples)
        return marched

    modes = {}
    for mode in ("positions", "encoding", "cost"):
        engine_mod.march_rays = keep_counts if mode == "cost" else march
        try:
            t0 = time.perf_counter()
            img = render(mode)[0]
            torch.cuda.synchronize()
        finally:
            engine_mod.march_rays = march
        modes[mode] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                       "mean": float(img.mean()), "finite": bool(torch.isfinite(img).all())}
        if not modes[mode]["finite"]:
            raise AssertionError(f"{mode} frame: non-finite values")
    heat = torch.cat(counts).to(torch.float32) / 128.0
    cost_exact = bool(torch.equal(img, heat[:, None].expand(-1, 3)))
    emit({"phase": "debug_modes", **modes, "cost_is_march_count_over_128": cost_exact})
    if not cost_exact:
        raise AssertionError("cost frame differs from the march's count over 128")
    return normals_launches, frame_row


def phase_capture():
    """Write a PNG capture, load it, train on it and score its held-out
    views; then B1 on the eval's positions. Returns the launches of the
    path (load, train, eval), counted from zero."""
    import shutil

    import numpy as np
    import torch

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.data.synthetic import (
        CAPTURE_TEST_VIEWS,
        CAPTURE_TRAIN_VIEWS,
        write_sphere_capture,
    )
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    out = os.path.join(ROOT, "build", "capture_smoke")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    train_json, test_json = write_sphere_capture(out, res=CAPTURE_RES, device="cuda")
    write_s = time.perf_counter() - t0

    reset_launches()
    t0 = time.perf_counter()
    ds, test = load_nerf(train_json), load_nerf(test_json)
    load_s = time.perf_counter() - t0
    n_frames = ds.n_images + test.n_images
    if ds.images.shape != (CAPTURE_TRAIN_VIEWS, CAPTURE_RES, CAPTURE_RES, 4) or \
            test.images.shape != (CAPTURE_TEST_VIEWS, CAPTURE_RES, CAPTURE_RES, 4):
        raise AssertionError(f"load_nerf: frames {ds.images.shape}, {test.images.shape}")

    eng = NerfEngine(default_config("tpu"), ds, batch_size=1 << 18)
    state, grid = eng.init_state(), eng.init_grid()
    torch.cuda.synchronize()
    step_ms, samples = [], []
    for _ in range(CAPTURE_STEPS):
        t0 = time.perf_counter()
        state, grid, metrics = eng.train(state, grid, 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        samples.append(metrics["network_samples"])
    train_launches = launch_counts()

    # the eval keeps the positions of its largest B1 launch (a reference)
    largest = []
    encode = _keep_largest(hashgrid_ops, "hashgrid_encode_cuda", largest)
    try:
        t0 = time.perf_counter()
        scores = eng.eval_test_transforms(state, grid, test)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        hashgrid_ops.hashgrid_encode_cuda = encode
    launches = launch_counts()
    eval_launches = {k: n - train_launches[k] for k, n in launches.items()}

    # one more render of held-out view 0, alone: the render's share of a view
    t0 = time.perf_counter()
    rgb, _, _ = eng.render_view(state, grid, test.xforms[0, 0], test.focal_lengths[0],
                                test.principal_points[0], lens=test.lens,
                                min_transmittance=1e-4)
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    steady = step_ms[256:]
    result = {
        "phase": "capture", "res": CAPTURE_RES, "train_views": ds.n_images,
        "test_views": test.n_images, "lens": [ds.lens.mode, list(ds.lens.params)],
        "aabb_scale": eng.aabb_scale, "cascades": eng.grid_cfg.n_cascades,
        "write_s": write_s, "load_s": load_s, "load_s_per_image": load_s / n_frames,
        "steps": CAPTURE_STEPS, "median_ms_per_step": float(np.median(steady)),
        "median_ms_per_step_warmup_32_256": float(np.median(step_ms[32:256])),
        "network_samples_per_step": float(np.mean(samples[256:])),
        "final_loss": float(metrics["loss"]), "k_and_rays": list(eng.batch_geometry),
        "launches_per_step": {k: n / CAPTURE_STEPS for k, n in train_launches.items()},
        "eval_launches": eval_launches,
        "psnr": scores["psnr"], "min_psnr": scores["min_psnr"],
        "max_psnr": scores["max_psnr"], "ssim": scores["ssim"],
        "per_view_psnr": [v["psnr"] for v in scores["per_view"]],
        "psnr_gate": CAPTURE_PSNR_MIN,
        "eval_ms_per_view": eval_s * 1e3 / scores["n_views"],
        "render_ms_view0": render_ms, "render_samples_view0": eng.last_render_samples,
        "render_finite": bool(torch.isfinite(rgb).all()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit(result)
    if not result["render_finite"] or tuple(rgb.shape) != (CAPTURE_RES, CAPTURE_RES, 3):
        raise AssertionError(f"held-out render: shape {tuple(rgb.shape)} or non-finite")
    if not scores["psnr"] >= CAPTURE_PSNR_MIN:
        raise AssertionError(f"held-out PSNR {scores['psnr']} dB after {CAPTURE_STEPS} "
                             f"steps < {CAPTURE_PSNR_MIN}")
    for name in ("hashgrid_encode", "hashgrid_backward"):
        if launches[name] == 0:
            raise AssertionError(f"the capture path launched {name} no time")
    if eval_launches["hashgrid_encode"] == 0:
        raise AssertionError("the held-out eval launched hashgrid_encode no time")

    # By CUDA events: after phase train_profile's windows, the profiler
    # keeps 13 of 20 records of a kernel in every later window of the
    # process (H100, torch 2.11), and device_ms then fails.
    positions = _kernel_case("tpu", torch.bfloat16, torch.Generator().manual_seed(4),
                             x=largest[0][0], aabb_scale=eng.aabb_scale, profiled=False)
    emit({"phase": "kernel_capture_positions", **positions})
    return launches


def _cli(args: list) -> list:
    """Run ``python -m ngp_tpu_torch.run`` with ``args`` from the repository
    root; returns its output lines, each with the seconds since the start
    at which it arrived. A non-zero exit fails the run."""
    proc = subprocess.Popen([sys.executable, "-u", "-m", "ngp_tpu_torch.run", *args],
                            cwd=ROOT, stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    lines = [(time.perf_counter() - t0, line.rstrip("\n")) for line in proc.stdout]
    if proc.wait() != 0:
        raise AssertionError(f"ngp_tpu_torch.run {' '.join(args)} exited {proc.returncode}:\n"
                             + "\n".join(text for _, text in lines[-20:]))
    return lines


def _cli_line(lines: list, prefix: str) -> tuple:
    """(seconds, text, seconds since the line before) of the first output
    line that starts with ``prefix``."""
    for i, (t, text) in enumerate(lines):
        if text.startswith(prefix):
            return t, text, t - (lines[i - 1][0] if i else 0.0)
    raise AssertionError(f"the CLI printed no line starting with {prefix!r}")


def _cli_scores(lines: list) -> dict:
    text = _cli_line(lines, "test_transforms:")[1]
    return {"psnr": float(re.search(r"PSNR=(\S+)", text).group(1)),
            "min_psnr": float(re.search(r"min=(\S+)", text).group(1)),
            "ssim": float(re.search(r"SSIM=(\S+)", text).group(1))}


def _cli_launches(lines: list) -> dict:
    return json.loads(_cli_line(lines, "kernel launches:")[1].split(":", 1)[1])


def phase_cli():
    """The CLI on phase capture's written capture (runs 1 and 2), then the
    in-process checks in a fresh process (phase ``cli_checks``). Returns
    the two runs' kernel launches, summed."""
    import numpy as np

    from ngp_tpu_torch.data.png import read_png
    from ngp_tpu_torch.utils.camera_path import CameraKeyframe, CameraPath

    capture = os.path.join(ROOT, "build", "capture_smoke")
    out = os.path.join(ROOT, "build", "cli_smoke")
    import shutil

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    train_json = os.path.join(capture, "transforms_train.json")
    test_json = os.path.join(capture, "transforms_test.json")
    snapshot = os.path.join(out, "scene.ingp")
    metrics_file = os.path.join(out, "train_metrics.jsonl")

    # run 1: train, score the held-out views, save, screenshot
    run1 = _cli([train_json, "--test_transforms", test_json, "--n_steps", str(CLI_STEPS),
                 "--save_snapshot", snapshot, "--screenshot", os.path.join(out, "shot.png"),
                 "--metrics_file", metrics_file])
    trained = _cli_line(run1, "trained ")[1]
    train_s = float(re.search(r"in (\S+)s", trained).group(1))
    scores1 = _cli_scores(run1)
    with open(metrics_file) as f:
        records = [json.loads(line) for line in f]
    # a window's record is written when the next window ends; the last at
    # the end of the call
    window_ms = [(b["t"] - a["t"]) / 16 * 1e3 for a, b in zip(records[:-2], records[1:-1])
                 if a["step"] >= 240]
    last = records[-1]
    shot = read_png(os.path.join(out, "shot.png"))

    # run 2: load, score again, a mesh and a camera-path video
    center = np.full(3, 0.5, np.float32)
    path = CameraPath(keyframes=[
        CameraKeyframe.from_matrix(_lookat(center + 1.2 * np.asarray(
            [math.cos(a), math.sin(a), 0.1], np.float32), center), fov=40.0)
        for a in (0.0, math.pi / 3, 2 * math.pi / 3)])
    path_json = os.path.join(out, "path.json")
    path.save(path_json)
    frames_dir = os.path.join(out, "frames")
    mesh_path = os.path.join(out, "mesh.obj")
    normals_png = os.path.join(out, "normals.png")
    run2 = _cli([train_json, "--load_snapshot", snapshot, "--n_steps", "0",
                 "--render_mode", "normals", "--screenshot", normals_png,
                 "--test_transforms", test_json, "--save_mesh", mesh_path,
                 "--marching_cubes_res", str(CLI_MESH_RES), "--video_camera_path", path_json,
                 "--video_n_seconds", str(CLI_VIDEO["seconds"]),
                 "--video_fps", str(CLI_VIDEO["fps"]), "--video_w", str(CLI_VIDEO["w"]),
                 "--video_h", str(CLI_VIDEO["h"]), "--video_output", frames_dir])
    scores2 = _cli_scores(run2)
    _, video_line, video_s = _cli_line(run2, "rendered ")
    _, mesh_line, mesh_s = _cli_line(run2, f"wrote {mesh_path}")
    n_verts, n_faces = (int(v) for v in re.search(r"\((\d+) verts, (\d+) faces\)",
                                                   mesh_line).groups())
    verts = np.asarray([[float(v) for v in line.split()[1:]]
                        for line in open(mesh_path) if line.startswith("v ")], np.float32)
    frames = sorted(os.listdir(frames_dir))
    decoded = [read_png(os.path.join(frames_dir, name)) for name in frames]
    _, _, normals_s = _cli_line(run2, f"wrote {normals_png}")
    normals_shot = read_png(normals_png)
    n_video = CLI_VIDEO["fps"] * CLI_VIDEO["seconds"]
    with open(train_json) as f:
        half = 0.5 * json.load(f)["aabb_scale"]  # the scene's box around (0.5,)³
    result = {
        "phase": "cli", "steps": CLI_STEPS, "config": "Testbed default (base.json)",
        "train_s": train_s, "wall_ms_per_step": train_s / CLI_STEPS * 1e3,
        "median_ms_per_step_256_992": float(np.median(window_ms)),
        "measured_samples_per_step_ema": last["samples_per_s"] * last["step_ms"] / 1e3,
        "final_loss_ema": last["loss_ema"], "k": last["k"],
        "run1_s": run1[-1][0], "run2_s": run2[-1][0],
        "psnr": scores1["psnr"], "min_psnr": scores1["min_psnr"], "ssim": scores1["ssim"],
        "psnr_gate": CLI_PSNR_MIN,
        "psnr_reloaded": scores2["psnr"], "reload_tol_db": CLI_RELOAD_DB,
        "train_view_psnr": [float(_cli_line(r, "PSNR (train view")[1].split(": ")[1].split()[0])
                            for r in (run1, run2)],
        "snapshot_bytes": os.path.getsize(snapshot),
        "snapshot_write_s": _cli_line(run1, "saved snapshot")[2],
        "screenshot": list(shot.shape),
        "mesh_res": CLI_MESH_RES, "mesh_s": mesh_s, "mesh_verts": n_verts,
        "mesh_faces": n_faces, "mesh_bytes": os.path.getsize(mesh_path),
        "normals_screenshot": list(normals_shot.shape), "normals_s": normals_s,
        "normals_screenshot_mean": float(normals_shot.astype(np.float32).mean()),
        "video_frames": len(frames), "video_s_per_frame": video_s / max(len(frames), 1),
        "video_line": video_line,
        "launches": {k: a + b for (k, a), b in zip(_cli_launches(run1).items(),
                                                    _cli_launches(run2).values())},
    }
    emit(result)
    if not scores1["psnr"] >= CLI_PSNR_MIN:
        raise AssertionError(f"CLI held-out PSNR {scores1['psnr']} dB < {CLI_PSNR_MIN}")
    if not abs(scores2["psnr"] - scores1["psnr"]) <= CLI_RELOAD_DB:
        raise AssertionError(f"reloaded held-out PSNR {scores2['psnr']} dB, trained "
                             f"{scores1['psnr']} dB")
    if n_verts == 0 or n_faces == 0 or verts.shape != (n_verts, 3):
        raise AssertionError(f"mesh: {n_verts} verts, {n_faces} faces, read {verts.shape}")
    if not (verts.min() >= 0.5 - half and verts.max() <= 0.5 + half):
        raise AssertionError(f"mesh vertices outside the scene's box: "
                             f"{verts.min()} .. {verts.max()}")
    if len(decoded) != n_video or any(
            d.shape != (CLI_VIDEO["h"], CLI_VIDEO["w"], 3) for d in decoded):
        raise AssertionError(f"video frames: {[d.shape for d in decoded]}")
    for name in ("hashgrid_encode", "hashgrid_backward", "hashgrid_input_grad"):
        if result["launches"][name] == 0:
            raise AssertionError(f"the CLI launched {name} no time")
    with open(train_json) as f:
        meta = json.load(f)
    size = [int(meta["h"]), int(meta["w"]), 3]  # a training view's resolution
    if list(normals_shot.shape) != size or not np.isfinite(
            normals_shot.astype(np.float32)).all():
        raise AssertionError(f"normals screenshot {normals_shot.shape}, a view is {size}")

    _child("cli_checks")  # the in-process checks, in a process of their own
    return result["launches"]


def phase_cli_checks():
    """In a fresh process: phase cli's snapshot loaded by ``Testbed`` and
    trained ``CLI_SETTLE_STEPS`` more steps, then ``CLI_KEPT_STEPS`` steps
    keeping each B1 and grid backward launch's size and the last
    backward's (x, g); the snapshot round trips; then B1 and the fused
    backward at that tier against their twins."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data import ingp_snapshot
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference
    from ngp_tpu_torch.testbed import Testbed

    capture = os.path.join(ROOT, "build", "capture_smoke")
    out = os.path.join(ROOT, "build", "cli_smoke")
    tb = Testbed(scene=os.path.join(capture, "transforms_train.json"))
    eng = tb.engine
    t0 = time.perf_counter()
    tb.load_snapshot(os.path.join(out, "scene.ingp"))
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0

    encode, backward = hashgrid_ops.hashgrid_encode_cuda, hashgrid_ops.hashgrid_backward_cuda
    encode_n, backward_n, kept = [], [], []

    def count_encode(x, *args, **kwargs):
        encode_n.append(x.shape[0])
        return encode(x, *args, **kwargs)

    def keep_backward(x, g, *geo_and_rows):
        backward_n.append(x.shape[0])
        kept[:] = [(x, g, *geo_and_rows)]
        return backward(x, g, *geo_and_rows)

    tb.train(CLI_SETTLE_STEPS)
    hashgrid_ops.hashgrid_encode_cuda = count_encode
    hashgrid_ops.hashgrid_backward_cuda = keep_backward
    try:
        tb.train(CLI_KEPT_STEPS)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_encode_cuda = encode
        hashgrid_ops.hashgrid_backward_cuda = backward
    state, grid = tb.state, tb.grid

    # native snapshot, optimizer included (raw msgpack), and a second save
    snap1, snap2 = (os.path.join(out, f"roundtrip_{i}.msgpack") for i in (1, 2))
    t0 = time.perf_counter()
    eng.save_snapshot(snap1, state, grid, include_optimizer=True)
    native_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state2, grid2 = eng.load_snapshot(snap1)
    torch.cuda.synchronize()
    native_read_s = time.perf_counter() - t0
    eng.save_snapshot(snap2, state2, grid2, include_optimizer=True)
    tensors = lambda st: [  # noqa: E731
        *st.model.parameters(), *st.ema.parameters(),
        *(t for opt in st.opt_state.values() for t in (*opt.mu, *opt.nu))]
    same = (state2.step == state.step
            and [o.count for o in state2.opt_state.values()]
            == [o.count for o in state.opt_state.values()]
            and all(torch.equal(x, y) for x, y in zip(tensors(state), tensors(state2))))
    bitfield_changed = int((grid.bitfield != grid2.bitfield).sum())

    # reference .ingp: save, load, save
    ref1, ref2 = (os.path.join(out, f"reference_{i}.ingp") for i in (1, 2))
    t0 = time.perf_counter()
    eng.save_reference_snapshot(ref1, state, grid)
    ref_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state3, grid3 = eng.load_reference_snapshot(ref1)
    torch.cuda.synchronize()
    ref_read_s = time.perf_counter() - t0
    eng.save_reference_snapshot(ref2, state3, grid3)
    d1, d2 = (ingp_snapshot.load_ingp(p)["snapshot"] for p in (ref1, ref2))
    ref_same = all(d1[k] == d2[k] for k in ("params_binary", "density_grid_binary"))
    emit({"phase": "cli_checks", "kept_steps": [state.step - CLI_KEPT_STEPS, state.step],
          "k_and_rays": list(eng.batch_geometry),
          "snapshot_read_s": read_s,
          "native_write_s": native_write_s, "native_read_s": native_read_s,
          "native_bytes": os.path.getsize(snap1),
          "native_round_trip_bit_identical": same,
          "native_second_save_identical": open(snap1, "rb").read() == open(snap2, "rb").read(),
          "bitfield_cells_changed_by_float16": bitfield_changed,
          "bitfield_cells": int(grid.bitfield.numel()),
          "reference_write_s": ref_write_s, "reference_read_s": ref_read_s,
          "reference_bytes": os.path.getsize(ref1),
          "reference_second_save_same_bytes": ref_same})
    if not same:
        raise AssertionError("native snapshot round trip changed a parameter or moment")
    if not ref_same:
        raise AssertionError("a second reference .ingp differs in its parameter or grid bytes")
    del state2, grid2, state3, grid3

    # B1 at the tier (float32 reads): uniform positions at the steps' mean
    # launch, then the positions of a held-out render's largest launch
    n_mean = int(round(sum(encode_n) / len(encode_n)))
    emit({"phase": "kernel_cli", "kernel": "hashgrid_encode", "shape": "steps_mean",
          **_kernel_case("upstream", torch.float32, torch.Generator().manual_seed(6),
                         n_mean, aabb_scale=eng.aabb_scale)})
    test = load_nerf(os.path.join(capture, "transforms_test.json"))
    largest = []
    _keep_largest(hashgrid_ops, "hashgrid_encode_cuda", largest)
    try:
        eng.render_view(state, grid, test.xforms[0, 0], test.focal_lengths[0],
                        test.principal_points[0], lens=test.lens, min_transmittance=1e-4)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_encode_cuda = encode
    emit({"phase": "kernel_cli", "kernel": "hashgrid_encode", "shape": "render_positions",
          **_kernel_case("upstream", torch.float32, torch.Generator().manual_seed(7),
                         x=largest[0][0], aabb_scale=eng.aabb_scale)})
    del largest

    # the input gradient at the tier, on a normals frame's largest launch
    # (training view 0 at stride 2)
    kept_grad = []
    original = _keep_largest(hashgrid_ops, "hashgrid_input_grad_cuda", kept_grad)
    try:
        eng.render_image(state, grid, 0, stride=2, mode="normals")
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_input_grad_cuda = original
    xg, gg, tg, *geo_g = kept_grad[0]
    emit({"phase": "kernel_cli", "kernel": "hashgrid_input_grad", "shape": "normals_positions",
          **_input_grad_row(xg, gg, tg, tuple(geo_g[:5]))})
    del kept_grad, xg, gg, tg

    # the fused backward at the tier: uniform (x, g) at the steps' mean,
    # then the last step's own
    x, g, scale, res, size, hashed, variant, _, n_rows = kept[0][:9]  # then the payload
    geo = (scale, res, size, hashed, variant)
    gen = torch.Generator().manual_seed(8)
    L = scale.shape[0]
    n_bwd = int(round(sum(backward_n) / len(backward_n)))
    xu = torch.rand((n_bwd, 3), generator=gen).cuda()
    gu = (torch.randn((n_bwd, g.shape[1]), generator=gen) * 1e-3).cuda()
    for shape, (xs, gs) in (("steps_mean", (xu, gu)), ("captured_step", (x, g))):
        keys, vals = hashgrid_backward_addends_reference(xs, gs, *geo)
        emit({"phase": "kernel_cli", "kernel": "hashgrid_backward", "shape": shape,
              "N": xs.shape[0], "L": L, "T": n_rows, "F": vals.shape[2], "hash": variant,
              **_backward_row(xs, gs, geo, n_rows, keys, vals)})
        del keys, vals


def _image_psnr(eng, state, stride: int) -> float:
    """PSNR over the texels (stride·i, stride·j), snapped targets in sRGB,
    as ``scripts/bench_gigapixel.py`` scores its fit."""
    import torch

    from ngp_tpu_torch.engines.image import CHUNK, eval_image_and_snap

    H, W = eng.image.shape[:2]
    xs = (torch.arange(0, W, stride, dtype=torch.float32, device="cuda") + 0.5) / W
    ys = (torch.arange(0, H, stride, dtype=torch.float32, device="cuda") + 0.5) / H
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    pos = torch.stack([X, Y], dim=-1).reshape(-1, 2)
    model = state.inference_model()
    total = torch.zeros((), dtype=torch.float64, device="cuda")
    with torch.no_grad():
        for i in range(0, pos.shape[0], CHUNK):
            p, targets = eval_image_and_snap(eng.image, pos[i:i + CHUNK])
            d = targets - model(p)[:, :3]
            total += torch.sum(d * d) / 3.0
    return -10.0 * math.log10(max(float(total) / pos.shape[0], 1e-12))


def phase_image():
    """In a fresh process (``chip_smoke.py image``): the 104.9 MP gigapixel
    image made on the card in float16, fitted by ``ImageEngine`` with
    ``Testbed``'s default image config (instant-ngp's configs/image/base.json:
    L=16, F=2, T=2^24, XOR hash, RelativeL2, Ema 0.99), Stratified
    positions, 2^18 a step, ``IMAGE_STEPS`` steps in synchronized calls of
    ``IMAGE_CALL_STEPS``; then the subsampled PSNR (gate
    ``IMAGE_PSNR_MIN``), the full-image MSE and a 1920×1080 render. Then
    one more step keeps its grid backward's (x, g): B1 bit for bit and the
    fused backward within the float32 order bound on them (phase
    ``image_kernels``), and last ``IMAGE_PROFILE_STEPS`` steps under
    ``torch.profiler`` for the device time per stage (phase
    ``image_profile``; the profiler windows of the kernels come first, as
    later windows in a process that profiled training lack records)."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.synthetic import gigapixel_image
    from ngp_tpu_torch.engines.image import ImageEngine
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference
    from ngp_tpu_torch.testbed import default_config

    t0 = time.perf_counter()
    img = gigapixel_image(IMAGE_SIDE, "cuda", torch.float16)
    torch.cuda.synchronize()
    synth_s = time.perf_counter() - t0
    cfg = default_config("image")
    eng = ImageEngine(cfg, img, batch_size=1 << 18)
    t0 = time.perf_counter()
    state = eng.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    enc = state.model.encoding
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    step_ms, losses = [], []
    t_start = time.perf_counter()
    for _ in range(IMAGE_STEPS // IMAGE_CALL_STEPS):
        t0 = time.perf_counter()
        state, loss = eng.train(state, IMAGE_CALL_STEPS)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / IMAGE_CALL_STEPS)
        losses.append(loss)
    wall_s = time.perf_counter() - t_start
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.cat(losses).cpu().numpy()
    median_ms = float(np.median(step_ms[IMAGE_TIMED_FROM // IMAGE_CALL_STEPS:]))

    t0 = time.perf_counter()
    psnr = _image_psnr(eng, state, IMAGE_PSNR_STRIDE)
    psnr_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mse = eng.compute_mse(state)
    mse_s = time.perf_counter() - t0
    render_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        frame = eng.render(state, 1920, 1080)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t0) * 1e3)
    sizes = enc.level_size.tolist()
    result = {
        "phase": "image", "side": IMAGE_SIDE, "megapixels": IMAGE_SIDE ** 2 / 1e6,
        "image_dtype": str(img.dtype).replace("torch.", ""),
        "config": "Testbed default (configs/image/base.json)",
        "table": list(enc.table.shape),
        "dense_levels": sum(1 for h in enc.level_hashed.tolist() if not h),
        "live_rows": sum(sizes), "n_params": state.model.n_params,
        "batch": eng.batch_size, "random_mode": eng.random_mode,
        "synth_s": synth_s, "init_s": init_s, "steps": IMAGE_STEPS, "wall_s": wall_s,
        "ms_per_step_by_call": step_ms,
        f"median_ms_per_step_{IMAGE_TIMED_FROM}_{IMAGE_STEPS - 1}": median_ms,
        "samples_per_s": eng.batch_size / (median_ms / 1e3),
        "loss_first_last": [float(losses[0]), float(losses[-1])],
        "losses_finite": bool(np.isfinite(losses).all()),
        "peak_mem_gb": peak_gb,
        "launches": launches,
        "psnr_subsampled": psnr, "psnr_stride": IMAGE_PSNR_STRIDE,
        "psnr_gate": IMAGE_PSNR_MIN, "psnr_s": psnr_s,
        "mse_full": mse, "psnr_full": -10.0 * math.log10(max(mse, 1e-12)), "mse_full_s": mse_s,
        "render_1920x1080_ms": render_ms,
        "render_finite": bool(torch.isfinite(frame).all()),
    }
    emit(result)
    if not result["losses_finite"]:
        raise AssertionError("image training loss is not finite")
    if tuple(frame.shape) != (1080, 1920, 3) or not result["render_finite"]:
        raise AssertionError(f"render: shape {tuple(frame.shape)} or non-finite")
    if not psnr >= IMAGE_PSNR_MIN:
        raise AssertionError(f"image PSNR {psnr} dB after {IMAGE_STEPS} steps "
                             f"< {IMAGE_PSNR_MIN}")
    for name in ("hashgrid_encode", "hashgrid_backward"):
        if launches[name] != IMAGE_STEPS:
            raise AssertionError(f"the image path launched {name} {launches[name]} "
                                 f"times in {IMAGE_STEPS} steps")
    del frame

    # one more step keeps its grid backward's arguments (by reference)
    backward = hashgrid_ops.hashgrid_backward_cuda
    kept = []

    def keep(x, g, *geo_and_rows):
        kept[:] = [(x, g, *geo_and_rows)]
        return backward(x, g, *geo_and_rows)

    hashgrid_ops.hashgrid_backward_cuda = keep
    try:
        state, _ = eng.train(state, 1)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_backward_cuda = backward
    x, g, scale, res, size, hashed, variant, _, n_rows = kept[0][:9]  # then the payload
    geo = (scale, res, size, hashed, variant)
    keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
    L, T = scale.shape[0], n_rows
    # the table rows the step's corners read, level by level
    rows_read = int(torch.unique(keys.long() + torch.arange(L, device="cuda")[:, None] * T
                                 ).numel())
    b1 = _kernel_case("image", torch.float32, torch.Generator().manual_seed(10), x=x,
                      enc=enc, rows_read=rows_read)
    emit({"phase": "image_kernels", "kernel": "hashgrid_encode", "shape": "step_positions",
          **b1})
    bwd = _backward_row(x, g, geo, T, keys, vals)
    emit({"phase": "image_kernels", "kernel": "hashgrid_backward",
          "shape": "step_positions", "N": x.shape[0], "L": L, "T": T,
          "F": vals.shape[2], "hash": variant, **bwd})
    del keys, vals, kept, x, g

    # device time per stage over IMAGE_PROFILE_STEPS more steps, the
    # backward on the calling thread so that its kernels fall in its range
    from torch.profiler import ProfilerActivity, profile, record_function

    from ngp_tpu_torch.models import encodings

    trainer = eng.trainer
    eng.make_batch = _ranged("batch", eng.make_batch)
    trainer.loss = _ranged("forward", trainer.loss)
    trainer.apply_grads = _ranged("optimizer", trainer.apply_grads)
    grid_bwd = encodings._GridEncode.backward
    encodings._GridEncode.backward = staticmethod(_ranged("grid_backward", grid_bwd))
    tensor_backward = torch.Tensor.backward
    torch.Tensor.backward = _ranged("backward", tensor_backward)
    n = IMAGE_PROFILE_STEPS
    try:
        first = state.step
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                torch.autograd.set_multithreading_enabled(False):
            _lead_in()
            t0 = time.perf_counter()
            for _ in range(n):
                with record_function("step"):
                    state, _ = eng.train(state, 1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.Tensor.backward = tensor_backward
        encodings._GridEncode.backward = staticmethod(grid_bwd)
    summary = _profile_summary(prof, ("batch", "forward", "backward", "grid_backward",
                                      "optimizer"), "step", "step_other")
    busy_ms = summary["device_busy_ms"] / n
    emit({"phase": "image_profile", "steps": [first, state.step - 1],
          "wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy_ms,
          "busy_share_of_profiled_wall": busy_ms / (wall_ms / n),
          "busy_share_of_unprofiled_median": busy_ms / median_ms,
          "device_ops_per_step": summary["device_ops"] / n,
          "stage_device_ms_per_step": {k: v / n for k, v in summary["stage_device_ms"].items()},
          "top_device_ms": summary["top_device_ms"]})
    return result, b1, bwd


def _child(phase: str, lane: "ChildLane | None" = None) -> list:
    """Run ``chip_smoke.py phase`` in a fresh process, echo its lines and
    its wall seconds, and return its lines parsed; a non-zero exit fails
    the run. ``lane``, where given, holds the process while it runs, so
    that a failure elsewhere can stop it."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), phase], cwd=ROOT,
                            stdout=subprocess.PIPE, text=True)
    if lane is not None:
        lane.proc = proc
    out, _ = proc.communicate()
    with PRINT_LOCK:
        for line in out.splitlines():
            print(line, flush=True)
    emit({"phase": "child_seconds", "child": phase, "seconds": time.perf_counter() - t0,
          "lane": "second" if lane is not None else "main"})
    if proc.returncode != 0:
        raise AssertionError(f"chip_smoke.py {phase} exited {proc.returncode}")
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


class ChildLane(threading.Thread):
    """Children run one after another beside the main process's own
    phases: a second lane, so that the run takes about as long as the
    longer lane (the NeRF children are host-bound and leave the card
    mostly idle).
    Their times are then taken beside the other lane's work; a child run
    alone (``chip_smoke.py camera``) times it alone. ``lines`` holds each
    child's parsed lines, ``error`` the first failure; :meth:`stop` ends a
    child still running."""

    def __init__(self, phases: tuple):
        super().__init__(daemon=True)
        self.phases, self.lines = phases, {}
        self.error, self.proc, self.stopped = None, None, False
        self.seconds = 0.0

    def run(self):
        t0 = time.perf_counter()
        try:
            for phase in self.phases:
                if self.stopped:
                    break
                self.lines[phase] = _child(phase, lane=self)
        except BaseException as err:  # reported by the main thread
            self.error = err
        self.seconds = time.perf_counter() - t0

    def stop(self):
        self.stopped = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        self.join()


def phase_image_cli():
    """``python -m ngp_tpu_torch.run`` on a written 2048² ``.bin`` image in
    fresh processes: the default config (T=2^24) ``IMAGE_CLI_STEPS`` steps
    with a screenshot, gated at ``IMAGE_CLI_PSNR_MIN`` on the printed PSNR;
    then a ``--network`` file with T=2^``IMAGE_SNAPSHOT_LOG2`` trained and
    saved, and loaded in another process, whose printed MSE line must equal
    the saved run's. Returns the three runs' kernel launches, summed."""
    import shutil

    import torch

    from ngp_tpu_torch.data.png import read_png
    from ngp_tpu_torch.data.synthetic import write_gigapixel_bin
    from ngp_tpu_torch.testbed import default_config

    out = os.path.join(ROOT, "build", "image_cli_smoke")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    t0 = time.perf_counter()
    image = write_gigapixel_bin(os.path.join(out, "gigapixel.bin"), IMAGE_CLI_SIDE, "cuda")
    write_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    def mse_line(lines):
        text = _cli_line(lines, "MSE:")[1]
        return text, float(re.search(r"PSNR: (\S+) dB", text).group(1))

    shot = os.path.join(out, "fit.png")
    run1 = _cli([image, "--n_steps", str(IMAGE_CLI_STEPS), "--screenshot", shot,
                 "--screenshot_w", "512", "--screenshot_h", "512"])
    train_s = float(re.search(r"in (\S+)s", _cli_line(run1, "trained ")[1]).group(1))
    line1, psnr1 = mse_line(run1)

    net = os.path.join(out, "net.json")
    cfg = default_config("image")
    cfg["encoding"]["log2_hashmap_size"] = IMAGE_SNAPSHOT_LOG2
    with open(net, "w") as f:
        json.dump(cfg, f)
    snapshot = os.path.join(out, "fit.ingp")
    run2 = _cli([image, "--network", net, "--n_steps", str(IMAGE_SNAPSHOT_STEPS),
                 "--save_snapshot", snapshot])
    run3 = _cli([image, "--network", net, "--n_steps", "0", "--load_snapshot", snapshot])
    line2, psnr2 = mse_line(run2)
    line3, _ = mse_line(run3)
    runs = (run1, run2, run3)
    result = {
        "phase": "image_cli", "side": IMAGE_CLI_SIDE, "write_s": write_s,
        "steps": IMAGE_CLI_STEPS, "config": "Testbed default (configs/image/base.json)",
        "train_s": train_s, "wall_ms_per_step": train_s / IMAGE_CLI_STEPS * 1e3,
        "mse_line": line1, "psnr": psnr1, "psnr_gate": IMAGE_CLI_PSNR_MIN,
        "screenshot": list(read_png(shot).shape),
        "snapshot_log2_hashmap_size": IMAGE_SNAPSHOT_LOG2,
        "snapshot_steps": IMAGE_SNAPSHOT_STEPS, "snapshot_psnr": psnr2,
        "saved_mse_line": line2, "reloaded_mse_line": line3,
        "snapshot_bytes": os.path.getsize(snapshot),
        "snapshot_write_s": _cli_line(run2, "saved snapshot")[2],
        "run_s": [r[-1][0] for r in runs],
        "launches": {k: sum(_cli_launches(r)[k] for r in runs) for k in _cli_launches(run1)},
    }
    emit(result)
    if not psnr1 >= IMAGE_CLI_PSNR_MIN:
        raise AssertionError(f"image CLI PSNR {psnr1} dB < {IMAGE_CLI_PSNR_MIN}")
    if line3 != line2:
        raise AssertionError(f"reloaded {line3!r}, saved {line2!r}")
    if result["screenshot"] != [512, 512, 3]:
        raise AssertionError(f"screenshot {result['screenshot']}")
    for name in ("hashgrid_encode", "hashgrid_backward"):
        if _cli_launches(run1)[name] == 0:
            raise AssertionError(f"the image CLI launched {name} no time")
    return result["launches"]


def _bvh_bound(stats: dict, tree, n_queries: int, query_bytes: int, out_bytes: int,
               internal_ops: int, triangle_ops: int) -> dict:
    """The bound of a traversal from its twin's visits (``stats``), the
    work the function needs whatever implements it: the distinct nodes
    popped, each node's box, children and flag read once, each distinct
    leaf's real triangles read once, the queries read and the outputs
    written once; the box tests (2 an internal pop, ``internal_ops`` each)
    and the real-triangle tests of each leaf pop (``triangle_ops`` each;
    padding slots are not the function's work) at the float32 rate."""
    visited = stats["visited"]
    nodes = int(visited.sum())
    leaves = visited & tree.node_leaf
    real = (tree.tri_index.view(-1, 4) >= 0).sum(1)
    leaf_tris = int(real[tree.node_a[leaves].long() // 4].sum())
    node_bytes = 4 * 3 + 4 * 3 + 4 + 4 + 1
    return {"nodes_read": nodes, "leaves_read": int(leaves.sum()),
            "internal_pops": stats["internal_pops"], "leaf_pops": stats["leaf_pops"],
            "leaf_real_tests": stats["leaf_real_tests"],
            **_bound(nodes * node_bytes + leaf_tris * 36 + n_queries * (query_bytes + out_bytes),
                     stats["internal_pops"] * 2 * internal_ops
                     + stats["leaf_real_tests"] * triangle_ops)}


def _bvh_row(name: str, run, twin, tree, n_queries: int, query_bytes: int, out_bytes: int,
             internal_ops: int, triangle_ops: int) -> dict:
    """A traversal kernel (``run(visits)``) against its twin
    (``twin(stats)``) on the card: outputs bit for bit and each query's
    nodes processed equal to the twin's pops; its times and bound. ``ms``
    is timed by CUDA events around 20 back-to-back calls, as ``call_ms``
    is: the profiler kept 15 or 16 of 20 records of this kernel in each of
    three windows (the kernel runs milliseconds, the wrapper's host time
    is hidden behind it); ``us_per_iteration`` is ``ms`` over the twin's
    iterations, the longest walk. The twin runs once (seconds: a pop of
    every query an iteration, thousands of iterations where a query near
    the middle of a closed mesh prunes little), timed by events with its
    visit counting (``plain_ms``). No PyTorch call computes a BVH query,
    so no library time."""
    import torch

    visits = torch.full((n_queries,), -1, dtype=torch.int32, device="cuda")
    got = run(visits)
    stats = {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = twin(stats)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max(float((g.double() - w.double()).abs().nan_to_num(0.0).max()) if g.numel() else 0.0
              for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} differs from its twin, max abs err {err}")
    if not torch.equal(visits, stats["visits"]):
        raise AssertionError(f"{name}: nodes processed differ from the twin's pops at "
                             f"{int((visits != stats['visits']).sum())} queries")
    call_ms = cuda_ms(lambda: run(None), iters=20)
    return {"N": n_queries, "max_abs_err": err, "bit_exact": True,
            "ms": call_ms, "ms_source": "cuda_events", "call_ms": call_ms,
            "plain_ms": plain_ms, "twin_iterations": stats["iterations"],
            "us_per_iteration": call_ms * 1e3 / stats["iterations"],
            "visits_equal_twin": True, "visits_mean": float(visits.float().mean()),
            "visits_max": int(visits.max()), "library_ms": None,
            **_bvh_bound(stats, tree, n_queries, query_bytes, out_bytes, internal_ops,
                         triangle_ops)}


def _sdf_frame(eng, state, o, d, mode: str, shadow: bool = False, gt_bvh: bool = False,
               profiled: bool = True):
    """One frame through ``render_rays``: its hit mask, wall and device ms
    (with ``profiled``: the frame again under the profiler) and the
    launches it added."""
    import torch

    from ngp_tpu_torch.ops.cuda_build import launch_counts

    before = launch_counts()
    t0 = time.perf_counter()
    rgb, _, hit = eng.render_rays(state, o, d, gt_bvh, mode=mode, shadow=shadow)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    if not bool(torch.isfinite(rgb).all()):
        raise AssertionError(f"sdf {mode} frame: non-finite values")
    device = ({"device_ms": _frame_device_ms(lambda: eng.render_rays(
        state, o, d, gt_bvh, mode=mode, shadow=shadow))} if profiled else {})
    return hit, {"wall_ms": wall_ms, "launches": launches, **device,
                 "hit_share": float(hit.float().mean()),
                 "mean_rgb": float(rgb.mean())}


def phase_sdf():
    """In a fresh process (``chip_smoke.py sdf``): the SDF primitive at
    instant-ngp's configs/sdf/base.json (``Testbed``'s default: L=16, F=2,
    T=2^19, XOR hash, float32 reads, 64-wide MLP with 2 hidden layers,
    MAPE, Ema 0.95 over ExponentialDecay over Adam at 1e-4) and
    ``SdfEngine``'s batch of 2^18, on the 327,680-triangle bumpy sphere
    written as an OBJ into ``build/sdf_smoke/`` and loaded through
    ``Testbed``. ``SDF_STEPS`` steps in calls of ``SDF_CALL_STEPS``; the
    IoU over 2^18 uniform points (gate ``SDF_IOU_MIN``); 960×540 frames
    of the shade, shade with shadows and normals modes; a ground-truth
    frame (the BVH's distances) and the IoU of its hit mask with the shade
    frame's (gate ``SDF_HIT_IOU_MIN``); a 256³ marching-cubes mesh; one data
    refresh in the raystab sign mode against the watertight one; a
    snapshot saved and loaded, which must give the same IoU. The launch
    counts are read over all of it. Returns what the later phases use."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.synthetic import write_bumpy_sphere_mesh
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches
    from ngp_tpu_torch.testbed import SDF_EYE, SDF_FOV_DEG, SDF_LOOKAT, Testbed

    out = os.path.join(ROOT, "build", "sdf_smoke")
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    mesh_path = write_bumpy_sphere_mesh(os.path.join(out, "bumpy_sphere.obj"), SDF_SUBDIVISIONS)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tb = Testbed(scene=mesh_path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng = tb.engine
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    step_ms, losses = [], []
    t_start = time.perf_counter()
    for _ in range(SDF_STEPS // SDF_CALL_STEPS):
        t0 = time.perf_counter()
        tb.state, loss = eng.train(tb.state, SDF_CALL_STEPS)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / SDF_CALL_STEPS)
        losses.append(loss)
    wall_s = time.perf_counter() - t_start
    train_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.cat(losses).cpu().numpy()
    median_ms = float(np.median(step_ms[1:]))
    state = tb.state

    t0 = time.perf_counter()
    iou = eng.calculate_iou(state, SDF_IOU_SAMPLES)
    iou_s = time.perf_counter() - t0

    o, d = (torch.from_numpy(a).cuda() for a in
            eng.camera_rays(SDF_EYE, SDF_LOOKAT, SDF_FRAME, SDF_FOV_DEG))
    frames = {}
    hit, frames["shade"] = _sdf_frame(eng, state, o, d, "shade")
    _, frames["shade_shadows"] = _sdf_frame(eng, state, o, d, "shade", shadow=True)
    _, frames["normals"] = _sdf_frame(eng, state, o, d, "normals")
    gt_hit, frames["gt_shade"] = _sdf_frame(eng, state, o, d, "shade", gt_bvh=True)
    hit_iou = float((hit & gt_hit).sum()) / max(float((hit | gt_hit).sum()), 1.0)

    t0 = time.perf_counter()
    verts, faces = eng.compute_marching_cubes_mesh(state, SDF_MC_RES)
    mc_s = time.perf_counter() - t0
    vd = eng.signed_distance(torch.from_numpy(verts).cuda()).abs()
    in_box = bool(((verts >= eng.mesh.aabb_min - 1e-6)
                   & (verts <= eng.mesh.aabb_max + 1e-6)).all())

    # one data refresh of the same step in each sign mode
    water_pos, water = eng.training_batch(state.step)
    eng.sign_mode = "raystab"
    t0 = time.perf_counter()
    stab_pos, stab = eng.training_batch(state.step)
    torch.cuda.synchronize()
    raystab_ms = (time.perf_counter() - t0) * 1e3
    eng.sign_mode = "watertight"
    firm = water.abs() > 1e-6
    sign_agree = float((torch.sign(stab[firm]) == torch.sign(water[firm])).float().mean())

    snapshot = os.path.join(out, "sdf.msgpack")  # uncompressed: zlib of 124 MB takes seconds
    t0 = time.perf_counter()
    tb.save_snapshot(snapshot)
    tb.load_snapshot(snapshot)
    snapshot_s = time.perf_counter() - t0
    iou_reloaded = eng.calculate_iou(tb.state, SDF_IOU_SAMPLES)
    launches = launch_counts()

    tree = eng.bvh
    result = {
        "phase": "sdf", "config": "Testbed default (configs/sdf/base.json)",
        "mesh": {"triangles": eng.mesh.n_triangles, "subdivisions": SDF_SUBDIVISIONS,
                 "write_s": write_s, "obj_bytes": os.path.getsize(mesh_path),
                 "testbed_load_s": load_s, "bvh_build_s": eng.bvh_build_s,
                 "bvh_nodes": tree.node_a.shape[0], "bvh_depth": tree.depth},
        "table": list(state.model.encoding.table.shape), "batch": eng.batch_size,
        "steps": SDF_STEPS, "wall_s": wall_s, "ms_per_step_by_call": step_ms,
        "median_ms_per_step": median_ms,
        "samples_per_s": eng.batch_size / (median_ms / 1e3),
        "loss_first_last": [float(losses[0]), float(losses[-1])],
        "losses_finite": bool(np.isfinite(losses).all()), "peak_mem_gb": peak_gb,
        "train_launches": train_launches,
        "iou": iou, "iou_samples": SDF_IOU_SAMPLES, "iou_gate": SDF_IOU_MIN, "iou_s": iou_s,
        "frame": list(SDF_FRAME), "frames": frames,
        "model_gt_hit_iou": hit_iou, "hit_iou_gate": SDF_HIT_IOU_MIN,
        "marching_cubes": {"res": SDF_MC_RES, "s": mc_s, "verts": len(verts),
                           "faces": len(faces), "in_box": in_box,
                           "median_abs_gt_distance": float(vd.median()) if len(verts) else None},
        "raystab_refresh_ms": raystab_ms,
        "raystab_abs_equal": bool(torch.equal(stab.abs(), water.abs())),
        "raystab_sign_agreement": sign_agree,
        "snapshot_s": snapshot_s, "snapshot_bytes": os.path.getsize(snapshot),
        "iou_reloaded": iou_reloaded, "launches": launches,
    }
    emit(result)
    if not result["losses_finite"]:
        raise AssertionError("sdf training loss is not finite")
    if not iou >= SDF_IOU_MIN:
        raise AssertionError(f"sdf IoU {iou} after {SDF_STEPS} steps < {SDF_IOU_MIN}")
    if not hit_iou >= SDF_HIT_IOU_MIN:
        raise AssertionError(f"model and ground-truth hit masks: IoU {hit_iou} "
                             f"< {SDF_HIT_IOU_MIN}")
    if iou_reloaded != iou:
        raise AssertionError(f"reloaded snapshot IoU {iou_reloaded} != {iou}")
    if not (len(faces) and in_box):
        raise AssertionError(f"marching cubes: {len(faces)} faces, inside the box {in_box}")
    if not (result["raystab_abs_equal"] and torch.equal(stab_pos, water_pos)):
        raise AssertionError("raystab refresh: positions or |distances| differ")
    if frames["normals"]["launches"].get("hashgrid_input_grad", 0) == 0 or \
            frames["normals"]["launches"].get("hashgrid_backward", 0):
        raise AssertionError(f"normals frame launches {frames['normals']['launches']}")
    for name in ("hashgrid_encode", "hashgrid_backward", "hashgrid_input_grad",
                 "bvh_closest_point", "bvh_ray_intersect"):
        if launches[name] == 0:
            raise AssertionError(f"the sdf path launched {name} no time")
    return tb, mesh_path, (o, d), launches, median_ms


def phase_sdf_kernels(eng, state, rays) -> dict:
    """The kernels of the SDF path against their twins on the card, at the
    path's shapes: the closest-point kernel on a data refresh's own 2^17
    queries (its offset and uniform points), the ray kernel on the frame's
    518,400 camera rays, and B1, the fused grid backward and the input
    gradient at the sdf config on one training step's own (x, g). Returns
    the rows by kernel."""
    import torch

    from ngp_tpu_torch.ops import bvh as bvh_ops
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference

    tree = eng.bvh
    kept_queries = []
    cp_cuda = bvh_ops.bvh_closest_point_cuda

    def keep_points(tree_, points, *args):
        kept_queries[:] = [points]
        return cp_cuda(tree_, points, *args)

    backward = hashgrid_ops.hashgrid_backward_cuda
    kept = []

    def keep(x, g, *geo_and_rows):
        kept[:] = [(x, g, *geo_and_rows)]
        return backward(x, g, *geo_and_rows)

    bvh_ops.bvh_closest_point_cuda = keep_points
    hashgrid_ops.hashgrid_backward_cuda = keep
    try:
        eng.train(state, 1)  # a call's first step refreshes the data
        torch.cuda.synchronize()
    finally:
        bvh_ops.bvh_closest_point_cuda = cp_cuda
        hashgrid_ops.hashgrid_backward_cuda = backward
    points = kept_queries[0]
    rows = {}
    rows["bvh_closest_point"] = _bvh_row(
        "bvh_closest_point", lambda v: bvh_ops.bvh_closest_point_cuda(tree, points, v),
        lambda stats: bvh_ops.bvh_closest_point_reference(tree, points, stats), tree,
        points.shape[0], 12, 20, BOX_SQ_DIST_OPS, POINT_TRIANGLE_OPS)
    emit({"phase": "sdf_kernels", "kernel": "bvh_closest_point", "shape": "refresh_queries",
          **rows["bvh_closest_point"]})
    o, d = rays
    rows["bvh_ray_intersect"] = _bvh_row(
        "bvh_ray_intersect", lambda v: bvh_ops.bvh_ray_intersect_cuda(tree, o, d, v),
        lambda stats: bvh_ops.bvh_ray_intersect_reference(tree, o, d, stats), tree,
        o.shape[0], 24, 8, BOX_RAY_OPS, RAY_TRIANGLE_OPS)
    emit({"phase": "sdf_kernels", "kernel": "bvh_ray_intersect", "shape": "frame_rays",
          **rows["bvh_ray_intersect"]})

    x, g, scale, res, size, hashed, variant, _, n_rows = kept[0][:9]
    geo = (scale, res, size, hashed, variant)
    enc = state.model.encoding
    keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
    L, T = scale.shape[0], n_rows
    rows_read = int(torch.unique(keys.long() + torch.arange(L, device="cuda")[:, None] * T
                                 ).numel())
    rows["hashgrid_encode"] = _kernel_case("sdf", torch.float32, torch.Generator().manual_seed(13),
                                           x=x, enc=enc, rows_read=rows_read)
    emit({"phase": "sdf_kernels", "kernel": "hashgrid_encode", "shape": "step_positions",
          **rows["hashgrid_encode"]})
    rows["hashgrid_backward"] = _backward_row(x, g, geo, T, keys, vals)
    emit({"phase": "sdf_kernels", "kernel": "hashgrid_backward", "shape": "step_positions",
          "N": x.shape[0], "L": L, "T": T, "F": vals.shape[2], "hash": variant,
          **rows["hashgrid_backward"]})
    del keys, vals
    rows["hashgrid_input_grad"] = _input_grad_row(x, g, enc.table.detach(), geo)
    emit({"phase": "sdf_kernels", "kernel": "hashgrid_input_grad", "shape": "step_positions",
          **rows["hashgrid_input_grad"]})
    return rows


def phase_sdf_profile(eng, state, median_ms: float):
    """``SDF_PROFILE_STEPS`` steps (one data refresh among them) under
    torch.profiler, the backward on the calling thread: the device busy
    share of a step and the device ms by stage (the refresh's samples and
    ground truth, permutation and gather, forward, backward, grid
    backward, optimizer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ngp_tpu_torch.models import encodings

    trainer = eng.trainer
    eng.training_batch = _ranged("refresh", eng.training_batch)
    trainer.loss = _ranged("forward", trainer.loss)
    trainer.apply_grads = _ranged("optimizer", trainer.apply_grads)
    grid_bwd = encodings._GridEncode.backward
    encodings._GridEncode.backward = staticmethod(_ranged("grid_backward", grid_bwd))
    tensor_backward = torch.Tensor.backward
    torch.Tensor.backward = _ranged("backward", tensor_backward)
    n = SDF_PROFILE_STEPS
    try:
        first = state.step
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                torch.autograd.set_multithreading_enabled(False):
            _lead_in()
            t0 = time.perf_counter()
            with record_function("steps"):
                state, _ = eng.train(state, n)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.Tensor.backward = tensor_backward
        encodings._GridEncode.backward = staticmethod(grid_bwd)
        del eng.training_batch, trainer.loss, trainer.apply_grads
    summary = _profile_summary(prof, ("refresh", "forward", "backward", "grid_backward",
                                      "optimizer"), "steps", "permute_and_other")
    busy_ms = summary["device_busy_ms"] / n
    emit({"phase": "sdf_profile", "steps": [first, state.step - 1],
          "wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy_ms,
          "busy_share_of_profiled_wall": busy_ms / (wall_ms / n),
          "busy_share_of_unprofiled_median": busy_ms / median_ms,
          "device_ops_per_step": summary["device_ops"] / n,
          "stage_device_ms_per_step": {k: v / n for k, v in summary["stage_device_ms"].items()},
          "top_device_ms": summary["top_device_ms"]})


def phase_sdf_cli(mesh_path: str) -> dict:
    """``python -m ngp_tpu_torch.run`` on the written mesh in fresh
    processes: ``SDF_CLI_STEPS`` steps with a snapshot and a screenshot,
    which must print ``IoU:``; then the snapshot loaded with no steps, which
    must print the same IoU line. Returns the two runs' kernel launches,
    summed."""
    from ngp_tpu_torch.data.png import read_png

    out = os.path.dirname(mesh_path)
    snapshot, shot = os.path.join(out, "cli.msgpack"), os.path.join(out, "cli.png")
    run1 = _cli([mesh_path, "--n_steps", str(SDF_CLI_STEPS), "--save_snapshot", snapshot,
                 "--screenshot", shot])
    run2 = _cli([mesh_path, "--n_steps", "0", "--load_snapshot", snapshot])
    iou1, iou2 = _cli_line(run1, "IoU:")[1], _cli_line(run2, "IoU:")[1]
    runs = (run1, run2)
    result = {
        "phase": "sdf_cli", "steps": SDF_CLI_STEPS,
        "trained": _cli_line(run1, "trained ")[1], "iou_line": iou1,
        "reloaded_iou_line": iou2, "screenshot": list(read_png(shot).shape),
        "run_s": [r[-1][0] for r in runs],
        "launches": {k: sum(_cli_launches(r)[k] for r in runs) for k in _cli_launches(run1)},
    }
    emit(result)
    if iou2 != iou1:
        raise AssertionError(f"reloaded {iou2!r}, saved {iou1!r}")
    if result["screenshot"] != [512, 512, 3]:
        raise AssertionError(f"screenshot {result['screenshot']}")
    for name in ("hashgrid_encode", "hashgrid_backward", "bvh_closest_point"):
        if _cli_launches(run1)[name] == 0:
            raise AssertionError(f"the sdf CLI launched {name} no time")
    return result["launches"]


def phase_sdf_all():
    """``chip_smoke.py sdf``: phases sdf, sdf_kernels, sdf_profile (the
    profiler's training window last: later windows in the process lack
    records) and sdf_cli; then the launches of the path (phase sdf and
    the CLI runs) on one line."""
    tb, mesh_path, rays, launches, median_ms = phase_sdf()
    phase_sdf_kernels(tb.engine, tb.state, rays)
    phase_sdf_profile(tb.engine, tb.state, median_ms)
    del tb
    cli = phase_sdf_cli(mesh_path)
    emit({"phase": "sdf_launches", "launches": {k: launches[k] + cli[k] for k in launches}})


# the volume phases: instant-ngp's volume config (Testbed's default) on the
# JAX package's procedural cloud at 512³ (a 537 MB float32 density on the card)
VOLUME_RES = 512
VOLUME_STEPS = 1000
VOLUME_CALL_STEPS = 100
VOLUME_PROFILE_STEPS = 16
VOLUME_CORR_SAMPLES = 4096
# the gates on the served density: its correlation with the targets at the
# recorded vertices of a step no run reaches (the distribution training
# sees: 4 events within ~0.01 of where an episode enters the occupied
# cells, as the mean free path is 0.01 / majorant) above 0.5, and its
# correlation with the jittered ground truth at uniform points of the box
# above 0 (noise reads 0). tests/test_volume.py's 0.5 at uniform points
# holds at that test's small config; at this one the JAX package's own fit
# reads 0.075-0.154 there (scripts/volume_fit_spread.py on the CPU, 250
# steps at 2^16 slots or 1,000 at 2^12; PERF.md §6): no vertex supervises
# the cloud's core or the empty space
VOLUME_VERTEX_CORR_MIN = 0.5
VOLUME_UNIFORM_CORR_MIN = 0.0
VOLUME_HELDOUT_STEP = 10_000_000
VOLUME_FRAME = (960, 540)
VOLUME_CENTRE_MIN, VOLUME_CORNER_MAX = 0.5, 0.1  # tests/test_volume.py's opacity gates
VOLUME_CLI_STEPS = 300
# float32 operations of one walk iteration, for the walk kernels' bound: a
# bit-cell lookup (3 products, 3 sums, 3 floors, 6 tests), the flight (the
# polynomial log, ~25, a difference, a maximum, a product) or the skip (3
# axes of a product, floor, sum, product, difference, test and division, 2
# minima, a clamp, a division and a sum), the new position (3 products, 3
# sums), the box test (6) and the flight's uniform (a conversion, a
# product); events' density lookups are not counted (a floor)
WALK_ITER_OPS = 65
# and of an episode's start and targets: the Box-Muller normal (two
# logarithms and square roots, a sine and a cosine polynomial, ~110), three
# uniforms, two normalisations (18), the origin and target (15), the slab
# test (26), the entry (7) and the sky (~33)
WALK_START_OPS = 220
PACKED_BITGRID_BYTES = 128 ** 3 // 8


def _walk_stats(steps, warp: int = 32) -> dict:
    """Walk lengths (iterations a thread ran) and the share of lanes idle in
    a warp: 1 − Σ iterations / Σ over warps of 32 × the warp's longest."""
    import torch

    n = steps.shape[0]
    pad = torch.zeros((-n) % warp, dtype=steps.dtype, device=steps.device)
    w = torch.cat([steps, pad]).view(-1, warp).double()
    total = float(w.sum())
    return {"walk_mean": total / max(n, 1), "walk_max": int(steps.max()) if n else 0,
            "iterations": total,
            "idle_lane_share": 1.0 - total / max(float(w.amax(1).sum()) * warp, 1.0)}


def _walk_row(name: str, run, twin, n: int, io_bytes: int, steps, start_ops: int = 0,
              registers=None) -> dict:
    """A walk kernel (``run()``, its outputs) against its twin (``twin()``)
    on the card, bit for bit; ``ms`` by CUDA events around 50 calls queued
    behind a spin kernel (:func:`queued_ms`, the device's time), ``call_ms``
    by events around 20 calls issued one after another (what a caller
    pays), the twin once by events (``plain_ms``), the walk lengths from
    ``steps``, ptxas's ``registers`` a thread, and the bound: the rays'
    ``io_bytes`` and the packed bitgrid read once, the iterations walked at
    ``WALK_ITER_OPS`` float32 operations each plus ``start_ops``. No
    PyTorch call computes a walk: no library time."""
    import torch

    got = run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = twin()
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = max(float((g.double() - w.double()).abs().nan_to_num(0.0).max()) if g.numel() else 0.0
              for g, w in zip(got, want))
    if not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} differs from its twin, max abs err {err}")
    stats = _walk_stats(steps)
    ms = queued_ms(run)
    return {"N": n, "max_abs_err": err, "bit_exact": True, "ms": ms,
            "ms_source": "cuda_events_queued", "call_ms": cuda_ms(run, iters=20),
            "plain_ms": plain_ms, "library_ms": None, "registers": registers, **stats,
            "us_per_iteration_of_longest": ms * 1e3 / max(stats["walk_max"], 1),
            **_bound(io_bytes + PACKED_BITGRID_BYTES,
                     stats["iterations"] * WALK_ITER_OPS + start_ops)}


def _volume_frame(eng, state, o, d, gt: bool):
    """One frame through ``render_rays``: its opacity, wall and device-busy
    ms, the launches it added and, for the learned frame, its rounds and
    network evaluations."""
    import torch

    import ngp_tpu_torch.engines.volume as engine_module
    from ngp_tpu_torch.ops.cuda_build import launch_counts

    counts = {"rounds": 0, "network_evaluations": 0}
    walk = engine_module.volume_render_walk

    def counted_walk(*args, **kwargs):
        counts["rounds"] += 1
        return walk(*args, **kwargs)

    def counted_network(model, pos):
        counts["network_evaluations"] += pos.shape[0]
        return type(eng)._network(eng, model, pos)

    before = launch_counts()
    engine_module.volume_render_walk, eng._network = counted_walk, counted_network
    try:
        t0 = time.perf_counter()
        col, opa = eng.render_rays(state, o, d, gt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        engine_module.volume_render_walk = walk
        del eng._network
    launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
    if not bool(torch.isfinite(col).all()):
        raise AssertionError(f"volume frame (gt={gt}): non-finite values")
    row = {"wall_ms": wall_ms, "launches": launches,
           "device_ms": _frame_device_ms(lambda: eng.render_rays(state, o, d, gt)),
           "mean_opacity": float(opa.mean()), "mean_rgb": float(col.mean())}
    if not gt:
        row.update(counts)
    W, H = VOLUME_FRAME
    opa = opa.reshape(H, W)
    row["centre_opacity"], row["corner_opacity"] = float(opa[H // 2, W // 2]), float(opa[0, 0])
    return col, opa, row


def phase_volume():
    """In a fresh process (``chip_smoke.py volume``): the volume primitive at
    the JAX Testbed's volume config (``Testbed``'s default: L=16, F=2,
    T=2^19, XOR hash, a 64-wide MLP of 2 hidden layers with a ReLU output,
    L2, Ema 0.95 over ExponentialDecay over Adam at 1e-4) and
    ``VolumeEngine``'s batch of 2^16 slots (16,384 episodes), on the JAX
    package's procedural cloud at ``VOLUME_RES``³ written as a NanoVDB file
    into ``build/volume_smoke/`` by the port's writer and loaded through
    ``Testbed``. ``VOLUME_STEPS`` steps in calls of ``VOLUME_CALL_STEPS``;
    the correlation of the served model's density with the targets at the
    recorded vertices of step ``VOLUME_HELDOUT_STEP`` (gate
    ``VOLUME_VERTEX_CORR_MIN``) and with the jittered ground truth at
    ``VOLUME_CORR_SAMPLES`` uniform points (gate
    ``VOLUME_UNIFORM_CORR_MIN``; also reported over those of the points in
    occupied bit cells); a learned and a
    ground-truth 960×540 frame from the Testbed's camera, each with the
    centre's opacity above ``VOLUME_CENTRE_MIN`` and the corner's below
    ``VOLUME_CORNER_MAX``; a snapshot saved and loaded, whose learned frame
    must be the same bits.
    Returns what the later phases use."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.nanovdb_codec import read_nanovdb_dense, write_nanovdb
    from ngp_tpu_torch.data.volume import procedural_cloud_density
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches
    from ngp_tpu_torch.ops.volume_walk import bit_occupied, density_at
    from ngp_tpu_torch.testbed import VOLUME_EYE, VOLUME_LOOKAT, Testbed

    out = os.path.join(ROOT, "build", "volume_smoke")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "cloud.nvdb")
    t0 = time.perf_counter()
    density = procedural_cloud_density(VOLUME_RES)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_nanovdb(path, density)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not np.array_equal(read_nanovdb_dense(path), density):
        raise AssertionError("the written cloud reads back different")
    read_s = time.perf_counter() - t0
    del density
    t0 = time.perf_counter()
    tb = Testbed(scene=path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng = tb.engine
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    step_ms, losses = [], []
    t_start = time.perf_counter()
    for _ in range(VOLUME_STEPS // VOLUME_CALL_STEPS):
        t0 = time.perf_counter()
        tb.state, loss = eng.train(tb.state, VOLUME_CALL_STEPS)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / VOLUME_CALL_STEPS)
        losses.append(loss)
    wall_s = time.perf_counter() - t_start
    train_launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.cat(losses).cpu().numpy()
    median_ms = float(np.median(step_ms[1:]))
    state = tb.state

    def corr(a, b):
        return float(np.corrcoef(a.cpu().numpy(), b.cpu().numpy())[0, 1])

    pos, targets, valid = eng.generate_training_data(VOLUME_HELDOUT_STEP)
    fill = float(valid.float().mean())
    with torch.no_grad():
        vertex_corr = corr(state.inference_model()(pos[valid])[:, 3], targets[valid, 3])
    gen = torch.Generator(device="cuda").manual_seed(3)
    pts = eng.aabb_min + torch.rand((VOLUME_CORR_SAMPLES, 3), generator=gen, device="cuda") * (
        eng.aabb_max - eng.aabb_min)
    with torch.no_grad():
        pred = state.inference_model()(pts)[:, 3]
    truth = density_at(eng.walk, pts, torch.rand((VOLUME_CORR_SAMPLES, 3), generator=gen,
                                                 device="cuda"))
    uniform_corr = corr(pred, truth)
    occupied = bit_occupied(eng.walk, pts)
    occupied_corr = corr(pred[occupied], truth[occupied])

    o, d = (torch.from_numpy(a).cuda() for a in
            eng.camera_rays(VOLUME_EYE, VOLUME_LOOKAT, VOLUME_FRAME, 50.0))
    reset_launches()
    col, opa, learned = _volume_frame(eng, state, o, d, False)
    _, opa_gt, truth = _volume_frame(eng, state, o, d, True)
    frame_launches = launch_counts()

    snapshot = os.path.join(out, "volume.msgpack")
    t0 = time.perf_counter()
    tb.save_snapshot(snapshot)
    tb.load_snapshot(snapshot)
    snapshot_s = time.perf_counter() - t0
    again, _ = eng.render_rays(tb.state, o, d, False)
    result = {
        "phase": "volume", "config": "Testbed default (the JAX Testbed's volume config)",
        "volume": {"res": VOLUME_RES, "make_s": make_s, "nvdb_write_s": write_s,
                   "nvdb_read_s": read_s, "nvdb_bytes": os.path.getsize(path),
                   "testbed_load_s": load_s,
                   "density_bytes": eng.walk.density.numel() * 4,
                   "majorant": eng.walk.majorant,
                   "occupied_bit_cells": int(eng.walk.bitgrid.sum())},
        "table": list(state.model.encoding.table.shape), "batch": eng.batch_size,
        "steps": VOLUME_STEPS, "wall_s": wall_s, "ms_per_step_by_call": step_ms,
        "median_ms_per_step": median_ms,
        "samples_per_s": eng.batch_size / (median_ms / 1e3), "fill_share": fill,
        "loss_first_last": [float(losses[0]), float(losses[-1])],
        "losses_finite": bool(np.isfinite(losses).all()), "peak_mem_gb": peak_gb,
        "train_launches": train_launches,
        "vertex_density_correlation": vertex_corr, "vertices": int(valid.sum()),
        "vertex_correlation_gate": VOLUME_VERTEX_CORR_MIN,
        "uniform_density_correlation": uniform_corr,
        "uniform_correlation_gate": VOLUME_UNIFORM_CORR_MIN,
        "occupied_density_correlation": occupied_corr, "occupied_points": int(occupied.sum()),
        "frame": list(VOLUME_FRAME), "learned_frame": learned, "gt_frame": truth,
        "mean_abs_opacity_difference": float((opa - opa_gt).abs().mean()),
        "frame_launches": frame_launches,
        "snapshot_s": snapshot_s, "snapshot_bytes": os.path.getsize(snapshot),
        "reloaded_frame_equal": bool(torch.equal(again, col)),
    }
    emit(result)
    if not result["losses_finite"]:
        raise AssertionError("volume training loss is not finite")
    if not vertex_corr > VOLUME_VERTEX_CORR_MIN:
        raise AssertionError(f"volume density correlation at held-out vertices {vertex_corr} "
                             f"<= {VOLUME_VERTEX_CORR_MIN}")
    if not uniform_corr > VOLUME_UNIFORM_CORR_MIN:
        raise AssertionError(f"volume density correlation at uniform points {uniform_corr} "
                             f"<= {VOLUME_UNIFORM_CORR_MIN}")
    for name, row in (("learned", learned), ("ground truth", truth)):
        if not (row["centre_opacity"] > VOLUME_CENTRE_MIN
                and row["corner_opacity"] < VOLUME_CORNER_MAX):
            raise AssertionError(f"{name} frame: centre opacity {row['centre_opacity']}, "
                                 f"corner {row['corner_opacity']}")
    if not result["reloaded_frame_equal"]:
        raise AssertionError("the reloaded snapshot renders another learned frame")
    for name in ("hashgrid_encode", "hashgrid_backward", "volume_train_walk"):
        if train_launches[name] == 0:
            raise AssertionError(f"volume training launched {name} no time")
    if learned["launches"].get("volume_render_walk", 0) != learned["rounds"] or \
            truth["launches"].get("volume_render_walk", 0) != 1:
        raise AssertionError(f"frame launches {learned['launches']}, {truth['launches']}")
    launches = {k: train_launches[k] + frame_launches[k] for k in train_launches}
    return tb, path, (o, d), launches, median_ms


def phase_volume_kernels(eng, state, rays) -> dict:
    """The kernels of the volume path against their twins on the card, at
    the path's shapes: the training walk (starts, walks and targets in one
    launch) on one step's own key and 16,384 episodes against the twin's
    composition (``training_data``: the starts' draws, the slab test, the
    lockstep walk, the sky targets) on CUDA tensors; the render walk on the
    ground-truth frame's 518,400 rays and on the first round of the learned
    frame; then B1 and the fused grid backward on that step's own (x, g).
    Returns the rows by kernel."""
    import torch

    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops import volume_walk as vw
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference

    walk = eng.walk
    kept = {}
    train_cuda, render_cuda = vw.volume_train_walk_cuda, vw.volume_render_walk_cuda
    backward = hashgrid_ops.hashgrid_backward_cuda
    registers = {re.search(r"(train_walk|render_gt|render_round)_kernel", k).group(1): v
                 for k, v in ptxas_registers(vw.VOLUME_WALK).items()}

    def keep_train(vol, key, n, albedo, scattering, envmap, *args):
        kept["train"] = (key, n, albedo, scattering, envmap)
        return train_cuda(vol, key, n, albedo, scattering, envmap, *args)

    def keep_render(vol, pos, dirs, alive, key, gt, iters=None, ids=None, **kw):
        name = "gt" if gt else "round"
        if name not in kept:
            kept[name] = (pos.clone(), dirs, alive.clone(), key,
                          None if gt else iters.clone(), ids)
        return render_cuda(vol, pos, dirs, alive, key, gt, iters, ids, **kw)

    def keep_backward(x, g, *geo_and_rows):
        kept["backward"] = (x, g, *geo_and_rows)
        return backward(x, g, *geo_and_rows)

    vw.volume_train_walk_cuda, vw.volume_render_walk_cuda = keep_train, keep_render
    hashgrid_ops.hashgrid_backward_cuda = keep_backward
    try:
        eng.train(state, 1)
        o, d = rays
        eng.render_rays(state, o, d, True)
        eng.render_rays(state, o, d, False)
        torch.cuda.synchronize()
    finally:
        vw.volume_train_walk_cuda, vw.volume_render_walk_cuda = train_cuda, render_cuda
        hashgrid_ops.hashgrid_backward_cuda = backward
    rows = {}
    key, E, albedo, scattering, envmap = kept["train"]
    steps = torch.zeros((E,), dtype=torch.int32, device="cuda")
    vw.volume_train_walk_cuda(walk, key, E, albedo, scattering, envmap, steps)
    rows["volume_train_walk"] = _walk_row(
        "volume_train_walk",
        lambda: vw.volume_train_walk_cuda(walk, key, E, albedo, scattering, envmap),
        lambda: vw.training_data(walk, key, E, albedo, scattering, envmap)[:3],
        E, E * vw.MAX_TRAIN_VERTICES * (12 + 16 + 1), steps, E * WALK_START_OPS,
        registers.get("train_walk"))
    emit({"phase": "volume_kernels", "kernel": "volume_train_walk", "shape": "step_episodes",
          **rows["volume_train_walk"]})

    pos, dirs, alive, key, _, _ = kept["gt"]
    B = pos.shape[0]
    steps = torch.zeros((B,), dtype=torch.int32, device="cuda")
    vw.volume_render_walk_cuda(walk, pos, dirs, alive, key, True, steps=steps)
    rows["volume_render_walk"] = _walk_row(
        "volume_render_walk",
        lambda: vw.volume_render_walk_cuda(walk, pos, dirs, alive, key, True),
        lambda: vw.render_walk(walk, pos, dirs, alive, vw.HashDraws(key), True)[:2],
        B, B * (12 + 12 + 1) + B * (12 + 4), steps, registers=registers.get("render_gt"))
    emit({"phase": "volume_kernels", "kernel": "volume_render_walk", "shape": "gt_frame_rays",
          **rows["volume_render_walk"]})

    pos, dirs, alive, key, iters, ids = kept["round"]
    n = pos.shape[0]
    # each timed call advances fresh copies (the kernel works in place)
    inputs = [(pos.clone(), alive.clone(), iters.clone()) for _ in range(80)]

    def one_round():
        p, a, it = inputs.pop() if inputs else (pos.clone(), alive.clone(), iters.clone())
        return vw.volume_render_walk_cuda(walk, p, dirs, a, key, False, it, ids)

    got = one_round()
    rows["volume_render_round"] = _walk_row(
        "volume_render_walk (learned round)", one_round,
        lambda: vw.render_walk(walk, pos, dirs, alive, vw.HashDraws(key), False, iters, ids),
        n, n * (12 + 12 + 1 + 4 + 8) + n * (12 + 1 + 4 + 1), got[2] - iters,
        registers=registers.get("render_round"))
    emit({"phase": "volume_kernels", "kernel": "volume_render_walk", "shape": "learned_round",
          **rows["volume_render_round"]})

    x, g, scale, res, size, hashed, variant, _, n_rows = kept["backward"][:9]
    geo = (scale, res, size, hashed, variant)
    enc = state.model.encoding
    keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
    L, T = scale.shape[0], n_rows
    rows_read = int(torch.unique(keys.long() + torch.arange(L, device="cuda")[:, None] * T
                                 ).numel())
    rows["hashgrid_encode"] = _kernel_case("volume", torch.float32,
                                           torch.Generator().manual_seed(17), x=x, enc=enc,
                                           rows_read=rows_read)
    emit({"phase": "volume_kernels", "kernel": "hashgrid_encode", "shape": "step_positions",
          **rows["hashgrid_encode"]})
    rows["hashgrid_backward"] = _backward_row(x, g, geo, T, keys, vals)
    emit({"phase": "volume_kernels", "kernel": "hashgrid_backward", "shape": "step_positions",
          "N": x.shape[0], "L": L, "T": T, "F": vals.shape[2], "hash": variant,
          **rows["hashgrid_backward"]})
    return rows


def phase_volume_profile(eng, state, median_ms: float):
    """``VOLUME_PROFILE_STEPS`` steps under torch.profiler, the backward on
    the calling thread: the device busy share of a step and the device ms
    by stage (the walk and its targets, forward and loss, backward, grid
    backward, optimizer)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from ngp_tpu_torch.engines import volume as volume_engine
    from ngp_tpu_torch.models import encodings

    eng.generate_training_data = _ranged("walk", eng.generate_training_data)
    eng.loss = _ranged("forward", eng.loss)
    apply = volume_engine.apply_grads
    volume_engine.apply_grads = _ranged("optimizer", apply)
    grid_bwd = encodings._GridEncode.backward
    encodings._GridEncode.backward = staticmethod(_ranged("grid_backward", grid_bwd))
    tensor_backward = torch.Tensor.backward
    torch.Tensor.backward = _ranged("backward", tensor_backward)
    n = VOLUME_PROFILE_STEPS
    try:
        first = state.step
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                torch.autograd.set_multithreading_enabled(False):
            _lead_in()
            t0 = time.perf_counter()
            with record_function("steps"):
                state, _ = eng.train(state, n)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.Tensor.backward = tensor_backward
        encodings._GridEncode.backward = staticmethod(grid_bwd)
        volume_engine.apply_grads = apply
        del eng.generate_training_data, eng.loss
    summary = _profile_summary(prof, ("walk", "forward", "backward", "grid_backward",
                                      "optimizer"), "steps", "other_in_step")
    busy_ms = summary["device_busy_ms"] / n
    # the window launched the walk kernel once a step: its records show
    # whether the profiler kept every one
    walk_records = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                       and "train_walk_kernel" in e.name)
    emit({"phase": "volume_profile", "steps": [first, state.step - 1],
          "walk_kernel_records": walk_records, "walk_kernel_launches": n,
          "stage_device_ops_per_step": {k: v / n for k, v in
                                        summary["stage_device_ops"].items()},
          "wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy_ms,
          "busy_share_of_profiled_wall": busy_ms / (wall_ms / n),
          "busy_share_of_unprofiled_median": busy_ms / median_ms,
          "device_ops_per_step": summary["device_ops"] / n,
          "stage_device_ms_per_step": {k: v / n for k, v in summary["stage_device_ms"].items()},
          "top_device_ms": summary["top_device_ms"]})


def phase_volume_cli(path: str) -> dict:
    """``python -m ngp_tpu_torch.run`` on the written cloud in fresh
    processes: ``VOLUME_CLI_STEPS`` steps with a snapshot and a screenshot,
    then the snapshot loaded with no steps and another screenshot, which
    must equal the first. Returns the two runs' kernel launches, summed."""
    from ngp_tpu_torch.data.png import read_png

    out = os.path.dirname(path)
    snapshot = os.path.join(out, "cli.msgpack")
    shots = [os.path.join(out, "cli.png"), os.path.join(out, "cli_reloaded.png")]
    run1 = _cli([path, "--n_steps", str(VOLUME_CLI_STEPS), "--save_snapshot", snapshot,
                 "--screenshot", shots[0]])
    run2 = _cli([path, "--n_steps", "0", "--load_snapshot", snapshot, "--screenshot", shots[1]])
    images = [read_png(p) for p in shots]
    runs = (run1, run2)
    result = {
        "phase": "volume_cli", "steps": VOLUME_CLI_STEPS,
        "trained": _cli_line(run1, "trained ")[1], "screenshot": list(images[0].shape),
        "screenshots_equal": bool((images[0] == images[1]).all()),
        "mean_pixel": float(images[0].mean()),
        "run_s": [r[-1][0] for r in runs],
        "launches": {k: sum(_cli_launches(r)[k] for r in runs) for k in _cli_launches(run1)},
    }
    emit(result)
    if not result["screenshots_equal"]:
        raise AssertionError("the reloaded snapshot's screenshot differs")
    if result["screenshot"] != [512, 512, 3]:
        raise AssertionError(f"screenshot {result['screenshot']}")
    for name in ("hashgrid_encode", "hashgrid_backward", "volume_train_walk",
                 "volume_render_walk"):
        if result["launches"][name] == 0:
            raise AssertionError(f"the volume CLI launched {name} no time")
    return result["launches"]


def phase_volume_all():
    """``chip_smoke.py volume``: phases volume, volume_kernels,
    volume_profile (the profiler's training window last) and volume_cli;
    then the launches of the path (phase volume and the CLI runs) on one
    line."""
    tb, path, rays, launches, median_ms = phase_volume()
    phase_volume_kernels(tb.engine, tb.state, rays)
    phase_volume_profile(tb.engine, tb.state, median_ms)
    del tb
    cli = phase_volume_cli(path)
    emit({"phase": "volume_launches", "launches": {k: launches[k] + cli[k] for k in launches}})


# phase camera: camera refinement on the capture of phase capture at the
# Testbed's NeRF config (instant-ngp's base.json), as the JAX package's
# test_camera_refinement_recovers_pose_noise gates it (after 250 steps).
# 250 steps a run (1,000 took 40 and 75 ms a step, and the phase 276 s
# alone, on an H100; 500 until the supervision phase took the time, 300
# until the encodings phase did)
CAMERA_STEPS = 250
CAMERA_TIMED = (150, 250)  # steps of the runs' timing window (median ms)
CAMERA_EXPOSURE_STEPS = 150  # a timing run with exposure refinement alone,
CAMERA_EXPOSURE_TIMED = (100, 150)  # timed against the frozen run's same steps
CAMERA_POS_SIGMA = 0.01  # NGP units
CAMERA_ROT_SIGMA_DEG = 0.2
CAMERA_MOVED_MIN = 1e-4
CAMERA_LOSS_RATIO_MAX = 1.2
CAMERA_PROFILE_STEPS = 4  # 8 before the encodings phase took the time
CAMERA_BLUR_STEPS = 100
CAMERA_BLUR_RAD = 0.02
CAMERA_BLUR_WINDOW = 20  # steps averaged at each end of the blur run
CAMERA_FRAME = (320, 180)
CAMERA_FLAGS = dict(optimize_extrinsics=True, optimize_exposure=True,
                    optimize_focal_length=True, optimize_distortion=True)


def _capture_jsons():
    """The capture of phase capture, written again where it is absent (the
    phase run alone)."""
    from ngp_tpu_torch.data.synthetic import write_sphere_capture

    out = os.path.join(ROOT, "build", "capture_smoke")
    paths = tuple(os.path.join(out, f"transforms_{s}.json") for s in ("train", "test"))
    if not all(os.path.exists(p) for p in paths):
        paths = write_sphere_capture(out, res=CAPTURE_RES, device="cuda")
    return paths


def _rotation(rotvec):
    """Rodrigues in float64 numpy."""
    import numpy as np

    angle = float(np.linalg.norm(rotvec))
    if angle == 0.0:
        return np.eye(3)
    k = np.asarray(rotvec, np.float64) / angle
    K = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(angle) * K + (1 - math.cos(angle)) * K @ K


def _camera_noise(n_images: int):
    """Pose noise from numpy seed 0: positions N(0, ``CAMERA_POS_SIGMA``)
    per axis, rotation vectors of angle N(0, ``CAMERA_ROT_SIGMA_DEG``)
    about uniform random axes; (n, 3) each, NGP space."""
    import numpy as np

    rng = np.random.default_rng(0)
    pos = rng.normal(0.0, CAMERA_POS_SIGMA, (n_images, 3))
    axes = rng.normal(size=(n_images, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = rng.normal(0.0, math.radians(CAMERA_ROT_SIGMA_DEG), n_images)
    return pos, axes * angles[:, None]


def _noisy_testbed(train_json: str, noise, **flags):
    """``Testbed`` on the capture (its default NeRF config) with every
    training pose moved by ``noise`` through ``set_camera_extrinsics``: the
    camera rotated about its centre, then shifted."""
    import numpy as np

    from ngp_tpu_torch.testbed import Testbed

    tb = Testbed(scene=train_json, device="cuda", **flags)
    pos, rot = noise
    for i in range(tb.n_images):
        m = tb.get_camera_extrinsics(i, convert_to_nerf=False).astype(np.float64)
        m[:, :3] = _rotation(rot[i]) @ m[:, :3]
        m[:, 3] += pos[i]
        tb.set_camera_extrinsics(i, m.astype(np.float32), convert_to_ngp=False)
    return tb


def _camera_run(tb, n_steps: int):
    """``n_steps`` steps of ``tb``, one ``Testbed.train`` call each (it reads
    the step's loss on the host); returns (ms a step, losses)."""
    import torch

    step_ms, losses = [], []
    torch.cuda.synchronize()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        tb.train(1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(tb.loss)
    return step_ms, losses


def _blur_json(train_json: str) -> str:
    """The capture's training transforms with each frame's end pose turned
    ``CAMERA_BLUR_RAD`` about the scene centre's vertical (NeRF z) axis and
    pure motion blur (``rolling_shutter`` (0, 0, 0, 1)), written beside the
    frames' directory into ``build/camera_smoke/``."""
    import numpy as np

    with open(train_json) as f:
        doc = json.load(f)
    base = os.path.dirname(os.path.abspath(train_json))
    turn = np.eye(4)
    turn[:3, :3] = _rotation([0.0, 0.0, CAMERA_BLUR_RAD])
    for fr in doc["frames"]:
        m = np.asarray(fr.pop("transform_matrix"), np.float64)
        fr["transform_matrix_start"] = m.tolist()
        fr["transform_matrix_end"] = (turn @ m).tolist()
        fr["file_path"] = os.path.join(base, fr["file_path"])
    doc["rolling_shutter"] = [0.0, 0.0, 0.0, 1.0]
    out = os.path.join(ROOT, "build", "camera_smoke")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "transforms_blur.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def phase_camera():
    """In a fresh process (``chip_smoke.py camera``, which also runs alone):
    camera refinement through ``Testbed`` at its NeRF config (instant-ngp's
    base.json: L=16, F=2, T=2^19, XOR hash, 64-wide MLPs; 2^18 sample slots
    a step) on the 800×800 capture of phase capture (written again when
    absent), its training poses moved by :func:`_camera_noise`. Two runs of
    ``CAMERA_STEPS`` steps from the same seed: refinement off, and all four
    flags on (extrinsics, exposure, focal length, distortion), each scored
    on the 4 held-out views, each run's median ms a step over the steps
    ``CAMERA_TIMED``; then a timing run of ``CAMERA_EXPOSURE_STEPS`` with
    exposure refinement alone, its median over ``CAMERA_EXPOSURE_TIMED``
    against the frozen run's over the same steps.
    Gates (the JAX package's ``test_camera_refinement_recovers_pose_noise``):
    the refined position offsets moved by more than ``CAMERA_MOVED_MIN``,
    the frozen run's camera group and its EMA exactly 0, the refined loss
    below ``CAMERA_LOSS_RATIO_MAX`` × the frozen one on one batch
    (``engines.nerf.losses_on_one_batch``), both runs' final losses
    finite, and the refined run launched ``hashgrid_input_grad`` and the float32-addend
    ``hashgrid_backward``. Then a motion-blurred copy of the capture
    (:func:`_blur_json`): ``CAMERA_BLUR_STEPS`` steps to a finite, falling
    loss (the mean of the last ``CAMERA_BLUR_WINDOW`` steps below the
    first's), and ``Testbed.render`` with an end pose equal to the start
    equal to the still render, bit for bit. The line gives the seconds of
    each part. Returns the refined Testbed, its median ms a step and the
    launches of the phase's runs."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.engines.nerf import losses_on_one_batch
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches
    from ngp_tpu_torch.testbed import Testbed

    train_json, test_json = _capture_jsons()
    test = load_nerf(test_json)
    with open(train_json) as f:
        n_images = len(json.load(f)["frames"])
    noise = _camera_noise(n_images)

    reset_launches()
    runs, launches, seconds = {}, {}, {}
    for name, flags, n_steps, (a, b) in (
            ("frozen", {}, CAMERA_STEPS, CAMERA_TIMED),
            ("refined", CAMERA_FLAGS, CAMERA_STEPS, CAMERA_TIMED),
            ("exposure", {"optimize_exposure": True}, CAMERA_EXPOSURE_STEPS,
             CAMERA_EXPOSURE_TIMED)):
        before = launch_counts()
        t0 = time.perf_counter()
        tb = _noisy_testbed(train_json, noise, **flags)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        step_ms, losses = _camera_run(tb, n_steps)
        launches[name] = {k: v - before[k] for k, v in launch_counts().items()}
        run = {"load_s": load_s, "steps": n_steps, "timed_steps": [a, b],
               "median_ms_per_step_after_timing_start": float(np.median(step_ms[a:])),
               "median_ms_per_step_timed": float(np.median(step_ms[a:b])),
               "final_loss": losses[-1], "mean_loss_last_100": float(np.mean(losses[-100:])),
               "k_and_rays": list(tb.engine.batch_geometry)}
        cam = tb.state.camera
        run["camera_max_abs"] = {k: float(getattr(cam, k).detach().abs().max())
                                 for k in cam.NAMES}
        if name != "exposure":
            scores = tb.engine.eval_test_transforms(tb.state, tb.grid, test)
            run["psnr"] = scores["psnr"]
            run["per_view_psnr"] = [v["psnr"] for v in scores["per_view"]]
        if name == "frozen":
            a, b = CAMERA_EXPOSURE_TIMED
            run["median_ms_per_step_exposure_window"] = float(np.median(step_ms[a:b]))
            run["camera_all_zero"] = not any(
                bool(p.any()) for c in (tb.state.camera, tb.state.camera_ema)
                for p in c.parameters())
        if name == "refined":
            pos = cam.pos.detach().cpu().numpy().astype(np.float64)
            rot = cam.rot.detach().cpu().numpy().astype(np.float64)

            def corr(a, b):
                a, b = a.ravel() - a.mean(), b.ravel() - b.mean()
                return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

            run["pos_corr_with_minus_noise"] = corr(pos, -noise[0])
            run["rot_corr_with_minus_noise"] = corr(rot, -noise[1])
            refined = tb
            paired = tuple(losses_on_one_batch(
                [(t.engine, t.state, t.grid) for t in (refined, frozen)]))
            del frozen
        runs[name] = run
        if name == "frozen":
            frozen = tb
        elif name == "exposure":
            del tb
        seconds[name] = time.perf_counter() - t0
    ratio = (runs["refined"]["median_ms_per_step_timed"]
             / runs["frozen"]["median_ms_per_step_timed"])
    exposure_ratio = (runs["exposure"]["median_ms_per_step_timed"]
                      / runs["frozen"]["median_ms_per_step_exposure_window"])

    # motion blur on the capture, then still and shuttered renders
    t0 = time.perf_counter()
    before = launch_counts()
    blur = Testbed(scene=_blur_json(train_json), device="cuda")
    if blur.engine.xforms_end is None:
        raise AssertionError("the motion-blurred capture kept no end poses")
    blur_ms, blur_losses = _camera_run(blur, CAMERA_BLUR_STEPS)
    w = CAMERA_BLUR_WINDOW
    first, last = float(np.mean(blur_losses[:w])), float(np.mean(blur_losses[-w:]))
    m0 = blur.engine.xforms[0].cpu().numpy()
    m1 = blur.engine.xforms_end[0].cpu().numpy()
    W, H = CAMERA_FRAME
    still = blur.render(W, H, camera_matrix=m0)
    same = blur.render(W, H, camera_matrix=m0, end_matrix=m0.copy(), shutter_fraction=0.5)
    shuttered = blur.render(W, H, camera_matrix=m0, end_matrix=m1, shutter_fraction=1.0)
    launches["blur"] = {k: v - before[k] for k, v in launch_counts().items()}
    del blur
    seconds["blur"] = time.perf_counter() - t0
    total = launch_counts()
    result = {
        "phase": "camera", "res": CAPTURE_RES, "train_views": n_images,
        "test_views": test.n_images, "config": "Testbed nerf default (base.json)",
        "noise": {"pos_sigma": CAMERA_POS_SIGMA, "rot_sigma_deg": CAMERA_ROT_SIGMA_DEG,
                  "seed": 0},
        "runs": runs, "paired_final_loss": {"refined": paired[0], "frozen": paired[1]},
        "timed_steps": list(CAMERA_TIMED), "refined_over_frozen_ms": ratio,
        "exposure_over_frozen_ms": exposure_ratio,
        "launches": launches,
        "blur": {"steps": CAMERA_BLUR_STEPS, "median_ms_per_step": float(np.median(blur_ms[w:])),
                 "mean_loss_first": first, "mean_loss_last": last,
                 "end_matrix_equal_start_bit_exact": bool(np.array_equal(same, still)),
                 "shuttered_max_abs_diff_from_still": float(np.abs(shuttered - still).max()),
                 "shuttered_finite": bool(np.isfinite(shuttered).all())},
        "gates": {"moved_min": CAMERA_MOVED_MIN, "loss_ratio_max": CAMERA_LOSS_RATIO_MAX},
        "seconds": seconds,
    }
    emit(result)
    fro, ref = runs["frozen"], runs["refined"]
    if not (math.isfinite(fro["final_loss"]) and math.isfinite(ref["final_loss"])):
        raise AssertionError(f"camera: non-finite loss {fro['final_loss']}, {ref['final_loss']}")
    if not ref["camera_max_abs"]["pos"] > CAMERA_MOVED_MIN:
        raise AssertionError(f"camera: the refined position offsets moved "
                             f"{ref['camera_max_abs']['pos']} <= {CAMERA_MOVED_MIN}")
    if not fro["camera_all_zero"]:
        raise AssertionError("camera: the frozen run's camera group is not zero")
    if not paired[0] < CAMERA_LOSS_RATIO_MAX * paired[1]:
        raise AssertionError(f"camera: refined loss {paired[0]} >= "
                             f"{CAMERA_LOSS_RATIO_MAX} x frozen {paired[1]} on one batch")
    for name in ("hashgrid_encode", "hashgrid_backward", "hashgrid_input_grad"):
        if launches["refined"][name] == 0:
            raise AssertionError(f"camera: the refined run launched {name} no time")
    if launches["frozen"]["hashgrid_input_grad"] != 0:
        raise AssertionError("camera: the frozen run launched hashgrid_input_grad")
    if not (math.isfinite(last) and last < first):
        raise AssertionError(f"camera: the blurred run's loss went {first} -> {last}")
    if not result["blur"]["end_matrix_equal_start_bit_exact"]:
        raise AssertionError("camera: render(end_matrix=start) differs from the still render")
    if not (result["blur"]["shuttered_finite"]
            and result["blur"]["shuttered_max_abs_diff_from_still"] > 0):
        raise AssertionError("camera: the shuttered render is not finite or did not move")
    return refined, runs["refined"]["median_ms_per_step_timed"], total


def phase_camera_kernels(tb) -> None:
    """The position gradient and the float32-addend grid backward on one
    refined step's own positions and cotangents (the largest call of each;
    the table as the step leaves it), against their twins: the position
    gradient bit for bit, the backward within the float32 order bound; each
    with its times and bound; and the bf16-addend backward of a frozen step
    on the same (x, g)."""
    import torch

    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference

    kept_dx, kept_bwd = [], []
    input_grad = _keep_largest(hashgrid_ops, "hashgrid_input_grad_cuda", kept_dx)
    backward = _keep_largest(hashgrid_ops, "hashgrid_backward_cuda", kept_bwd)
    try:
        tb.train(1)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_input_grad_cuda = input_grad
        hashgrid_ops.hashgrid_backward_cuda = backward
    x, g, table, *geo = kept_dx[0]
    x, geo = x.detach(), tuple(geo[:5])
    row = _input_grad_row(x, g, table.detach(), geo)
    emit({"phase": "camera_kernels", "kernel": "hashgrid_input_grad",
          "shape": "refined_step", **row})
    xb, gb, *rest = kept_bwd[0]
    payload = rest[7] if len(rest) > 7 else "bfloat16"
    if payload != "float32" or not torch.equal(xb, x):
        raise AssertionError(f"camera: the refined step's table gradient took {payload} "
                             "addends or other positions than the position gradient")
    T = rest[6]
    keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
    # the float32-addend backward the refined step runs, then the bf16 one
    # of a frozen step on the same (x, g), for the cost of the addends
    for payload in ("float32", "bfloat16"):
        emit({"phase": "camera_kernels", "kernel": "hashgrid_backward", "payload": payload,
              "shape": "refined_step", "N": x.shape[0], "L": table.shape[0], "T": T,
              "F": table.shape[2], "hash": geo[4],
              **_backward_row(x, g, geo, T, keys, vals, payload)})
    del keys, vals


def phase_camera_profile(tb, median_ms: float) -> None:
    """Two windows of ``CAMERA_PROFILE_STEPS`` refined steps under
    torch.profiler (:func:`_profile_steps`), each stage in a record_function
    range: the first as phase camera times them, for the device's busy
    share; the second with the backward on the calling thread, for the
    device ms per stage (march, the refined rays, network forward, loss,
    backward, the position gradient, the grid backward, optimizer, grid
    update)."""
    import torch

    from ngp_tpu_torch.engines import nerf as engine_mod
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops

    eng = tb.engine
    march, loss = engine_mod.march_rays, engine_mod.nerf_training_loss
    input_grad = hashgrid_ops.hashgrid_input_grad_cuda
    grid_bwd = hashgrid_ops.hashgrid_backward_cuda
    backward = torch.Tensor.backward
    engine_mod.march_rays = _ranged("march", march)
    engine_mod.nerf_training_loss = _ranged("loss", loss)
    hashgrid_ops.hashgrid_input_grad_cuda = _ranged("input_grad", input_grad)
    hashgrid_ops.hashgrid_backward_cuda = _ranged("grid_backward", grid_bwd)
    torch.Tensor.backward = _ranged("backward", backward)
    for attr, stage in (("_adjusted_rays", "camera_rays"),
                        ("_network_on_samples", "network_forward"),
                        ("apply_grads", "optimizer"), ("update_grid", "grid_update")):
        setattr(eng, attr, _ranged(stage, getattr(eng, attr)))
    stages = ("march", "camera_rays", "network_forward", "loss", "backward", "input_grad",
              "grid_backward", "optimizer", "grid_update")
    n = CAMERA_PROFILE_STEPS
    state, grid = tb.state, tb.grid
    try:
        for window, threaded in (("as_timed", True), ("backward_on_caller", False)):
            first = state.step
            grid, prof, wall_ms = _profile_steps(eng, state, grid, n, threaded)
            summary = _profile_summary(prof, stages, "step", "step_other")
            busy_ms = summary["device_busy_ms"] / n
            emit({"phase": "camera_profile", "window": window,
                  "autograd_multithreading": threaded, "steps": [first, state.step - 1],
                  "wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy_ms,
                  "busy_share_of_profiled_wall": busy_ms / (wall_ms / n),
                  "busy_share_of_unprofiled_median": busy_ms / median_ms,
                  "device_ops_per_step": summary["device_ops"] / n,
                  "stage_device_ms_per_step": {
                      k: v / n for k, v in summary["stage_device_ms"].items()},
                  "stage_device_ops_per_step": {
                      k: v / n for k, v in summary["stage_device_ops"].items()},
                  "top_device_ms": summary["top_device_ms"]})
    finally:
        torch.Tensor.backward = backward
        engine_mod.march_rays, engine_mod.nerf_training_loss = march, loss
        hashgrid_ops.hashgrid_input_grad_cuda = input_grad
        hashgrid_ops.hashgrid_backward_cuda = grid_bwd
        for attr in ("_adjusted_rays", "_network_on_samples", "apply_grads", "update_grid"):
            delattr(eng, attr)
    tb.grid = grid


def phase_camera_all():
    """``chip_smoke.py camera``: phases camera (its launches read at its
    end), camera_kernels and camera_profile; then the launches on one
    line."""
    t0 = time.perf_counter()
    tb, median_ms, launches = phase_camera()
    t1 = time.perf_counter()
    phase_camera_kernels(tb)
    t2 = time.perf_counter()
    phase_camera_profile(tb, median_ms)
    t3 = time.perf_counter()
    emit({"phase": "camera_launches", "launches": launches,
          "seconds": {"camera": t1 - t0, "camera_kernels": t2 - t1,
                      "camera_profile": t3 - t2}})


# phase supervision: latents, environment maps, depth supervision and
# supplied rays (ROADMAP A5c) through Testbed at its NeRF config
# (instant-ngp's base.json) on 800×800 captures of phase capture's sphere
# 250, as the JAX package's depth test trains, before the encodings phase
# took the time
SUPERVISION_STEPS = 200
SUPERVISION_TIMED = (100, 200)  # steps of the runs' timing window (median ms)
SUPERVISION_ALL_STEPS = 150  # a run with every option on, timed against the
SUPERVISION_ALL_TIMED = (100, 150)  # plain run's same steps
SUPERVISION_DEPTH_LAMBDA = 0.5
SUPERVISION_DEPTH_OPACITY = 0.5
SUPERVISION_DEPTH_ERR_MAX = 0.05  # NGP units, tests/test_depth_and_shutter.py:108
SUPERVISION_RAYS_DB = 1.0
SUPERVISION_SKY_ERR_MAX = 0.08  # mean sRGB error, tests/test_envmap.py:140
SUPERVISION_SKY_PROBES = 4096
SUPERVISION_SKY_ENVMAP = (32, 64)  # (H, W), as the JAX package's test trains it
SUPERVISION_MISS_TOL = 1e-3
SUPERVISION_LATENTS = 8
SUPERVISION_MOVED_MIN = 1e-5  # tests/test_nerf_engine.py:224
SUPERVISION_PROFILE_STEPS = 4  # 8 before the encodings phase took the time
SUPERVISION_FRAME = (320, 180)


def _supervision_captures() -> dict:
    """The phase's four captures (``write_sphere_capture`` at
    ``CAPTURE_RES``, written into ``build/supervision_smoke/``): depth maps
    and supplied rays; an opaque sky; a transparent background with an
    envmap; per-view brightness with ``SUPERVISION_LATENTS`` extra dims.
    The sky's capture has ``aabb_scale`` 1 and its cameras 3 units from
    the centre, so that most of its sky pixels' rays miss the scene box:
    density in the box explains the sky seen through it as well as the
    envmap does (the JAX package's sky test trains its grid's decay at
    0.41 for that), and at the other captures' 1.2 units every ray
    crosses the box.
    Returns {name: (train json, test json)}."""
    from ngp_tpu_torch.data.synthetic import write_sphere_capture

    root = os.path.join(ROOT, "build", "supervision_smoke")
    return {name: write_sphere_capture(os.path.join(root, name), res=CAPTURE_RES,
                                       device="cuda", **kw)
            for name, kw in (("depth_rays", dict(depth=True, rays=True)),
                             ("sky", dict(sky=True, aabb_scale=1, distance=3.0)),
                             ("envmap", dict(envmap=True)),
                             ("appearance", dict(brightness_seed=0,
                                                 n_extra_learnable_dims=SUPERVISION_LATENTS)))}


def _json_variant(path: str, name: str, **keys) -> str:
    """A copy of the transforms json ``path`` beside it, named ``name``,
    with top-level ``keys`` set (a value of None removes the key)."""
    with open(path) as f:
        doc = json.load(f)
    for k, v in keys.items():
        if v is None:
            doc.pop(k, None)
        else:
            doc[k] = v
    out = os.path.join(os.path.dirname(path), name)
    with open(out, "w") as f:
        json.dump(doc, f)
    return out


def _heldout_depth_error(tb, test) -> dict:
    """Each held-out view of ``test`` rendered by ``render_view`` at the
    capture's resolution (pixel centres, min transmittance 1e-4): the
    median |rendered depth − the analytic distance to the sphere| over the
    pixels of opacity > ``SUPERVISION_DEPTH_OPACITY`` (the ground truth 0
    where the pixel's ray misses it), over all views."""
    import torch

    from ngp_tpu_torch.data.synthetic import capture_view

    W, H = test.resolution
    errs, misses = [], 0
    for i in range(test.n_images):
        _, depth, opacity = tb.engine.render_view(
            tb.state, tb.grid, test.xforms[i, 0], test.focal_lengths[i],
            test.principal_points[i], width=W, height=H, lens=test.lens,
            min_transmittance=1e-4)
        gt = torch.from_numpy(capture_view(test.xforms[i, 0], W, test.focal_lengths[i],
                                           test.principal_points[i], test.lens,
                                           device="cuda")["distance"]).cuda()
        m = opacity > SUPERVISION_DEPTH_OPACITY
        errs.append((depth - gt)[m].abs())
        misses += int((m & (gt == 0)).sum())
    err = torch.cat(errs)
    return {"median_abs_err": float(err.median()), "mean_abs_err": float(err.mean()),
            "pixels": int(err.numel()), "pixels_whose_ray_misses_the_sphere": misses}


def _sky_error(tb) -> dict:
    """The served envmap's mean sRGB error against the analytic sky at
    ``SUPERVISION_SKY_PROBES`` directions the training views saw it along
    (their pixels whose rays miss the sphere, a numpy seed's pick): the
    JAX package's ``test_envmap_learns_synthetic_sky`` measure."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.synthetic import capture_view, sky_srgb
    from ngp_tpu_torch.ops.envmap import read_envmap
    from ngp_tpu_torch.ops.tonemap import linear_to_srgb

    eng, ds = tb.engine, tb.engine.dataset
    dirs = []
    for i in range(0, ds.n_images, 3):
        view = capture_view(eng.xforms[i].cpu().numpy(), ds.resolution[0],
                            ds.focal_lengths[i], ds.principal_points[i], ds.lens,
                            device="cuda")
        d = view["dirs"][view["distance"] == 0]
        dirs.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    dirs = np.concatenate(dirs)
    pick = np.random.default_rng(0).choice(dirs.shape[0], SUPERVISION_SKY_PROBES, replace=False)
    d = torch.from_numpy(dirs[pick].astype(np.float32)).cuda()
    with torch.no_grad():
        env = read_envmap(tb.state.inference_envmap().image, d)
        got = linear_to_srgb(torch.clamp_min(env[:, :3], 0.0))
    err = (got - sky_srgb(d)).abs()
    return {"mean_srgb_err": float(err.mean()), "max_srgb_err": float(err.max()),
            "probes": SUPERVISION_SKY_PROBES}


def _supervision_run(json_path: str, n_steps: int, test_json: str | None = None, **flags):
    """``Testbed`` on ``json_path`` with engine keywords ``flags``,
    ``n_steps`` steps (:func:`_camera_run`); returns (Testbed, record)."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.testbed import Testbed

    t0 = time.perf_counter()
    tb = Testbed(scene=json_path, device="cuda", **flags)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    step_ms, losses = _camera_run(tb, n_steps)
    run = {"load_s": load_s, "steps": n_steps, "step_ms": step_ms,
           "final_loss": losses[-1], "mean_loss_last_100": float(np.mean(losses[-100:])),
           "losses_finite": bool(np.isfinite(losses).all()),
           "k_and_rays": list(tb.engine.batch_geometry)}
    if test_json is not None:
        test = load_nerf(test_json)
        scores = tb.engine.eval_test_transforms(tb.state, tb.grid, test)
        run["psnr"] = scores["psnr"]
        run["per_view_psnr"] = [v["psnr"] for v in scores["per_view"]]
    return tb, run


def phase_supervision():
    """In a fresh process (``chip_smoke.py supervision``, which also runs
    alone): ROADMAP A5c's options through ``Testbed`` at its NeRF config
    (instant-ngp's base.json: L=16, F=2, T=2^19, XOR hash, 64-wide MLPs;
    2^18 sample slots a step) on 800×800 captures of the sphere
    (:func:`_supervision_captures`), ``SUPERVISION_STEPS`` steps a run:

    - depth: depth maps, λ = ``SUPERVISION_DEPTH_LAMBDA``, camera rays;
      gate: the held-out median depth error (:func:`_heldout_depth_error`)
      below ``SUPERVISION_DEPTH_ERR_MAX``; the same error of the plain run
      (λ = 0, the same capture and steps) reported beside it;
    - supplied rays: the capture's ``rays_*.dat``; gates: the held-out
      PSNR (camera-model test views) within ``SUPERVISION_RAYS_DB`` of the
      plain run's, and no culled cell in ``init_grid``'s grid;
    - a trained envmap of ``SUPERVISION_SKY_ENVMAP`` on the sky capture
      (no random background and the occupancy decay 0.41, as the JAX test
      trains it); gate: the learned sky's mean sRGB error
      (:func:`_sky_error`) below ``SUPERVISION_SKY_ERR_MAX``;
    - a dataset's envmap: gates: the envmap bit for bit unchanged after
      training, and the miss pixels (opacity 0) of a ``SUPERVISION_FRAME``
      render from 4 units away within ``SUPERVISION_MISS_TOL`` of the
      dataset envmap's lookup;
    - latents (E = ``SUPERVISION_LATENTS``) on the appearance capture;
      gates: the latents moved by more than ``SUPERVISION_MOVED_MIN``, the
      loss finite, a zero-latent render finite; the last-100-step mean
      loss reported beside a run without latents;
    - every option at once (latents, a trained envmap, depth supervision
      on supplied rays), ``SUPERVISION_ALL_STEPS`` steps, its median ms a
      step over ``SUPERVISION_ALL_TIMED`` against the plain run's same
      steps.

    Every run's losses finite; the phase launched B1 and the fused grid
    backward. Returns the every-option Testbed, its median ms a step and
    the launches of the phase's runs."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches
    from ngp_tpu_torch.ops.envmap import read_envmap
    from ngp_tpu_torch.ops.tonemap import linear_to_srgb

    t0 = time.perf_counter()
    caps = _supervision_captures()
    seconds = {"write_captures": time.perf_counter() - t0}
    dr_train, dr_test = caps["depth_rays"]
    camera_json = _json_variant(dr_train, "transforms_camera_rays.json",
                                enable_ray_loading=False)
    all_json = _json_variant(dr_train, "transforms_all.json",
                             n_extra_learnable_dims=SUPERVISION_LATENTS)
    app_train, _ = caps["appearance"]
    plain_app_json = _json_variant(app_train, "transforms_no_latents.json",
                                   n_extra_learnable_dims=None)
    test = load_nerf(dr_test)
    a, b = SUPERVISION_TIMED
    reset_launches()
    runs, gates = {}, {}

    def timed(run, lo, hi):
        ms = run.pop("step_ms")
        run["median_ms_per_step_timed"] = float(np.median(ms[lo:hi]))
        run["timed_steps"] = [lo, hi]
        return ms

    def clock(name, t):
        seconds[name] = time.perf_counter() - t

    t = time.perf_counter()
    tb, run = _supervision_run(camera_json, SUPERVISION_STEPS, dr_test)
    plain_ms = timed(run, a, b)
    run["depth"] = _heldout_depth_error(tb, test)
    runs["plain"] = run
    del tb
    clock("plain", t)

    t = time.perf_counter()
    tb, run = _supervision_run(camera_json, SUPERVISION_STEPS,
                               depth_supervision_lambda=SUPERVISION_DEPTH_LAMBDA)
    timed(run, a, b)
    run["depth"] = _heldout_depth_error(tb, test)
    runs["depth"] = run
    gates["depth"] = run["depth"]["median_abs_err"] < SUPERVISION_DEPTH_ERR_MAX
    del tb
    clock("depth", t)

    t = time.perf_counter()
    tb, run = _supervision_run(dr_train, SUPERVISION_STEPS, dr_test)
    timed(run, a, b)
    run["culled_cells_at_init"] = int((tb.engine.init_grid().density < 0).sum())
    run["supplied_rays"] = tb.engine.rays is not None
    run["psnr_minus_camera_rays_db"] = run["psnr"] - runs["plain"]["psnr"]
    runs["rays"] = run
    gates["rays"] = (run["supplied_rays"] and run["culled_cells_at_init"] == 0
                     and abs(run["psnr_minus_camera_rays_db"]) <= SUPERVISION_RAYS_DB)
    del tb
    clock("rays", t)

    t = time.perf_counter()
    sky_train, _ = caps["sky"]
    tb, run = _supervision_run(sky_train, SUPERVISION_STEPS, train_envmap=True,
                               envmap_resolution=SUPERVISION_SKY_ENVMAP,
                               train_with_random_bg=False, density_grid_decay=0.41)
    timed(run, a, b)
    run["sky"] = _sky_error(tb)
    run["envmap_shape"] = list(tb.state.envmap.image.shape)
    runs["sky"] = run
    gates["sky"] = run["sky"]["mean_srgb_err"] < SUPERVISION_SKY_ERR_MAX
    del tb
    clock("sky", t)

    t = time.perf_counter()
    env_train, _ = caps["envmap"]
    tb, run = _supervision_run(env_train, SUPERVISION_STEPS)
    timed(run, a, b)
    image = torch.as_tensor(tb.engine.dataset.envmap, device="cuda")
    unchanged = torch.equal(tb.state.envmap.image.detach(), image)
    # 4 units from the centre: the frame's edges miss the scene box
    eye = 0.5 + 4.0 * np.asarray([0.8, 0.45, 0.4]) / np.linalg.norm([0.8, 0.45, 0.4])
    o, d = _camera_rays(eye, np.full(3, 0.5), SUPERVISION_FRAME, 60.0)
    rgb, _, opacity = tb.engine.render_rays(tb.state, tb.grid, o, d)
    miss = opacity == 0
    with torch.no_grad():
        want = linear_to_srgb(torch.clamp_min(read_envmap(image, d[miss])[:, :3], 0.0))
    miss_err = float((rgb[miss] - want).abs().max()) if bool(miss.any()) else float("nan")
    run.update(envmap_bit_exact_after_training=unchanged, miss_pixels=int(miss.sum()),
               hit_pixels=int((opacity > 0.5).sum()), miss_pixels_max_abs_err=miss_err,
               envmap_adam_count=tb.state.opt_state["envmap"].count)
    runs["dataset_envmap"] = run
    gates["dataset_envmap"] = (unchanged and run["miss_pixels"] > 0
                               and miss_err <= SUPERVISION_MISS_TOL)
    del tb
    clock("dataset_envmap", t)

    t = time.perf_counter()
    for name, path in (("no_latents", plain_app_json), ("latents", app_train)):
        tb, run = _supervision_run(path, SUPERVISION_STEPS)
        timed(run, a, b)
        if name == "latents":
            lat0 = tb.engine.init_state().camera.latents.detach()
            run["latents_max_abs_moved"] = float((tb.state.camera.latents.detach()
                                                  - lat0).abs().max())
            frame = tb.engine.render_image(tb.state, tb.grid, 0, stride=4)
            run["zero_latent_render_finite"] = bool(torch.isfinite(frame).all())
            run["latents_shape"] = list(tb.state.camera.latents.shape)
            gates["latents"] = (run["latents_max_abs_moved"] > SUPERVISION_MOVED_MIN
                                and run["zero_latent_render_finite"])
        runs[name] = run
        del tb
    runs["latents"]["mean_loss_last_100_over_no_latents"] = (
        runs["latents"]["mean_loss_last_100"] / runs["no_latents"]["mean_loss_last_100"])
    clock("latents", t)

    t = time.perf_counter()
    lo, hi = SUPERVISION_ALL_TIMED
    tb, run = _supervision_run(all_json, SUPERVISION_ALL_STEPS, train_envmap=True,
                               depth_supervision_lambda=SUPERVISION_DEPTH_LAMBDA)
    timed(run, lo, hi)
    run["plain_median_ms_same_steps"] = float(np.median(plain_ms[lo:hi]))
    run["over_plain_ms"] = run["median_ms_per_step_timed"] / run["plain_median_ms_same_steps"]
    runs["all"] = run
    clock("all", t)

    launches = launch_counts()
    result = {"phase": "supervision", "res": CAPTURE_RES,
              "config": "Testbed nerf default (base.json)", "runs": runs,
              "gates": {"depth_median_err_max": SUPERVISION_DEPTH_ERR_MAX,
                        "rays_db": SUPERVISION_RAYS_DB, "sky_err_max": SUPERVISION_SKY_ERR_MAX,
                        "miss_tol": SUPERVISION_MISS_TOL, "moved_min": SUPERVISION_MOVED_MIN,
                        "passed": gates},
              "launches": launches, "seconds": seconds}
    emit(result)
    for name, run in runs.items():
        if not run["losses_finite"]:
            raise AssertionError(f"supervision: run {name}'s loss is not finite")
    for name, ok in gates.items():
        if not ok:
            raise AssertionError(f"supervision: gate {name} failed ({runs[name] if name in runs else ''})")
    for name in ("hashgrid_encode", "hashgrid_backward"):
        if launches[name] == 0:
            raise AssertionError(f"supervision: the phase launched {name} no time")
    return tb, run["median_ms_per_step_timed"], launches


class _EnvmapRanges:
    """``ops/envmap.read_envmap`` with its forward and its backward (the
    4-corner deposit) each in a record_function range named "envmap": the
    backward's range opens in an identity autograd Function on the read's
    output (its backward runs when the output's gradient is complete) and
    closes in one on the image (its backward runs once the read's nodes
    have). Autograd runs the ready node of the highest sequence number
    first, so no node created outside the read runs between the two."""

    def __init__(self, read):
        import torch
        from torch.profiler import record_function

        ranges = []

        class Open(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                r = record_function("envmap")
                r.__enter__()
                ranges.append(r)
                return g

        class Close(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                if ranges:
                    ranges.pop().__exit__(None, None, None)
                return g

        self.read, self.open, self.close = read, Open, Close
        self.record_function = record_function

    def __call__(self, image, dirs):
        with self.record_function("envmap"):
            if not image.requires_grad:
                return self.read(image, dirs)
            return self.open.apply(self.read(self.close.apply(image), dirs))


def phase_supervision_kernels(tb) -> None:
    """B1 and the fused grid backward on one every-option step's own
    positions and cotangents (the backward's largest call; B1 on its
    positions with a random table, as the other phases hold it), against
    their twins: B1 bit for bit, the backward within the float32 order
    bound, each with its times and bound."""
    import torch

    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference

    kept = []
    backward = _keep_largest(hashgrid_ops, "hashgrid_backward_cuda", kept)
    try:
        tb.train(1)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_backward_cuda = backward
    x, g, scale, res, size, hashed, variant, _, n_rows = kept[0][:9]  # then the payload
    payload = kept[0][9] if len(kept[0]) > 9 else "bfloat16"
    geo = (scale, res, size, hashed, variant)
    keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
    L, T = scale.shape[0], n_rows
    rows_read = int(torch.unique(keys.long() + torch.arange(L, device="cuda")[:, None] * T
                                 ).numel())
    enc = tb.state.model.pos_encoding
    dtype = torch.bfloat16 if enc.bf16_reads else torch.float32
    b1 = _kernel_case("base.json", dtype, torch.Generator().manual_seed(18), x=x.detach(),
                      enc=enc, rows_read=rows_read)
    emit({"phase": "supervision_kernels", "kernel": "hashgrid_encode", "shape": "step_positions",
          **b1})
    emit({"phase": "supervision_kernels", "kernel": "hashgrid_backward", "payload": payload,
          "shape": "step_positions", "N": x.shape[0], "L": L, "T": T, "F": vals.shape[2],
          "hash": variant, **_backward_row(x, g, geo, T, keys, vals, payload)})
    del keys, vals, kept


def phase_supervision_profile(tb, median_ms: float) -> None:
    """Two windows of ``SUPERVISION_PROFILE_STEPS`` every-option steps under
    torch.profiler (:func:`_profile_steps`), each stage in a
    record_function range: the first as phase supervision times them, for
    the device's busy share; the second with the backward on the calling
    thread, for the device ms per stage (march, the envmap's read and
    deposit, network forward, loss, backward, the grid backward, optimizer,
    grid update)."""
    import torch

    from ngp_tpu_torch.engines import nerf as engine_mod
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops

    eng = tb.engine
    march, loss = engine_mod.march_rays, engine_mod.nerf_training_loss
    read = engine_mod.read_envmap
    grid_bwd = hashgrid_ops.hashgrid_backward_cuda
    backward = torch.Tensor.backward
    engine_mod.march_rays = _ranged("march", march)
    engine_mod.nerf_training_loss = _ranged("loss", loss)
    engine_mod.read_envmap = _EnvmapRanges(read)
    hashgrid_ops.hashgrid_backward_cuda = _ranged("grid_backward", grid_bwd)
    torch.Tensor.backward = _ranged("backward", backward)
    for attr, stage in (("_network_on_samples", "network_forward"),
                        ("apply_grads", "optimizer"), ("update_grid", "grid_update")):
        setattr(eng, attr, _ranged(stage, getattr(eng, attr)))
    stages = ("march", "envmap", "network_forward", "loss", "backward", "grid_backward",
              "optimizer", "grid_update")
    n = SUPERVISION_PROFILE_STEPS
    state, grid = tb.state, tb.grid
    try:
        for window, threaded in (("as_timed", True), ("backward_on_caller", False)):
            first = state.step
            grid, prof, wall_ms = _profile_steps(eng, state, grid, n, threaded)
            summary = _profile_summary(prof, stages, "step", "step_other")
            busy_ms = summary["device_busy_ms"] / n
            emit({"phase": "supervision_profile", "window": window,
                  "autograd_multithreading": threaded, "steps": [first, state.step - 1],
                  "wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy_ms,
                  "busy_share_of_profiled_wall": busy_ms / (wall_ms / n),
                  "busy_share_of_unprofiled_median": busy_ms / median_ms,
                  "device_ops_per_step": summary["device_ops"] / n,
                  "stage_device_ms_per_step": {
                      k: v / n for k, v in summary["stage_device_ms"].items()},
                  "stage_device_ops_per_step": {
                      k: v / n for k, v in summary["stage_device_ops"].items()},
                  "top_device_ms": summary["top_device_ms"]})
    finally:
        torch.Tensor.backward = backward
        engine_mod.march_rays, engine_mod.nerf_training_loss = march, loss
        engine_mod.read_envmap = read
        hashgrid_ops.hashgrid_backward_cuda = grid_bwd
        for attr in ("_network_on_samples", "apply_grads", "update_grid"):
            delattr(eng, attr)
    tb.grid = grid


def phase_supervision_all():
    """``chip_smoke.py supervision``: phases supervision (its launches read
    at its end), supervision_kernels and supervision_profile; then the
    launches on one line."""
    t0 = time.perf_counter()
    tb, median_ms, launches = phase_supervision()
    t1 = time.perf_counter()
    phase_supervision_kernels(tb)
    t2 = time.perf_counter()
    phase_supervision_profile(tb, median_ms)
    t3 = time.perf_counter()
    emit({"phase": "supervision_launches", "launches": launches,
          "seconds": {"supervision": t1 - t0, "supervision_kernels": t2 - t1,
                      "supervision_profile": t3 - t2}})


# phase nerf_surface: the decoupled occupancy schedule and geometry-seeded
# priors (ROADMAP A5d) and the rest of the NeRF render surface (A6) through
# Testbed at its NeRF config (instant-ngp's base.json) on phase capture's
# 800×800 sphere
SURFACE_STEPS = 200  # 250 before the encodings phase took the time
SURFACE_TIMED = (100, 200)  # steps of the runs' timing window (median ms)
SURFACE_PRIOR_DB = 1.0  # the cloud prior's held-out PSNR at most this below the plain run's
SURFACE_TRAINED_DB = 10.0  # the decoupled and mesh runs' gain over the untrained model
SURFACE_FRAME = (960, 540)
SURFACE_FRAME_FOCAL = 1100.0  # pixels: the sphere ~460 pixels across at 1.2 units
# the lower half of a box about the sphere (z up): the frame's edges miss it
SURFACE_HALF_BOX = ((0.2, 0.2, 0.2), (0.8, 0.8, 0.5))
SURFACE_SLICE_RES = 256
SURFACE_FOVEA = (0.5, 0.5, 0.15)  # steepness (= the buffer scale), centre, radius
SURFACE_FOVEA_ERR_MAX = 0.08  # tests/test_foveation.py:73
SURFACE_FOVEA_WINDOW = 80  # pixels a side of the central window
SURFACE_MESH_RES = 128
SURFACE_MESH_STEPS = 10
SURFACE_MESH_THRESH = 2.5


def _surface_captures() -> dict:
    """Phase capture's 800×800 capture (written again where absent) and two
    copies of its json beside links to its frames, each with the sphere's
    surface as a prior (``write_sphere_prior``): ``mesh/mesh.obj`` (an
    icosphere of 20,480 triangles) and ``cloud/cloud.xyz`` (20,000
    points). Returns {name: (train json, test json)}."""
    import shutil

    from ngp_tpu_torch.data.synthetic import write_sphere_prior

    train_json, test_json = _capture_jsons()
    src = os.path.dirname(train_json)
    root = os.path.join(ROOT, "build", "nerf_surface_smoke")
    shutil.rmtree(root, ignore_errors=True)
    out = {"plain": (train_json, test_json)}
    for name, fmt in (("mesh", "obj"), ("cloud", "xyz")):
        d = os.path.join(root, name)
        os.makedirs(d)
        for split in ("train", "test"):
            os.symlink(os.path.join(src, split), os.path.join(d, split))
            shutil.copy(os.path.join(src, f"transforms_{split}.json"), d)
        write_sphere_prior(d, fmt, subdivisions=5)
        out[name] = tuple(os.path.join(d, f"transforms_{s}.json") for s in ("train", "test"))
    return out


def _surface_cells_kept(grid_density) -> dict:
    """Of the cascade-0 cells whose cube the capture sphere's surface
    crosses (the cells an exact voxelisation marks, as the reference's
    box–triangle test does), how many the grid keeps trainable (not −1)."""
    import numpy as np

    from ngp_tpu_torch.data.synthetic import CAPTURE_CENTER, CAPTURE_RADIUS

    G = grid_density.shape[1]
    edges = np.arange(G + 1) / G

    def span(c):  # nearest and farthest distance from c over each cell, per axis
        lo, hi = edges[:-1] - c, edges[1:] - c
        near = np.where((lo <= 0) & (hi >= 0), 0.0, np.minimum(abs(lo), abs(hi)))
        return near, np.maximum(abs(lo), abs(hi))

    (nx, fx), (ny, fy), (nz, fz) = (span(c) for c in CAPTURE_CENTER)
    dmin = np.sqrt(nx[:, None, None] ** 2 + ny[None, :, None] ** 2 + nz[None, None, :] ** 2)
    dmax = np.sqrt(fx[:, None, None] ** 2 + fy[None, :, None] ** 2 + fz[None, None, :] ** 2)
    cross = (dmin <= CAPTURE_RADIUS) & (dmax >= CAPTURE_RADIUS)
    kept = grid_density[0].cpu().numpy() >= 0
    return {"surface_cells": int(cross.sum()), "kept": int((cross & kept).sum()),
            "kept_share": float((cross & kept).sum() / cross.sum())}


def _grid_events(n_steps: int, reference: bool) -> dict:
    """The occupancy passes of steps 0..n_steps−1 by the schedule's formula
    (JAX ``engines/nerf.py:1285-1297`` at the default intervals): under the
    reference cadence an update every clamp(step/16, 1, 16) steps, all
    cells before 256; decoupled an update every 16 steps, all cells before
    32, else a decay every 4."""
    n = {"warmup": 0, "update": 0, "decay": 0}
    for s in range(n_steps):
        if reference:
            if s % min(max(s // 16, 1), 16) == 0:
                n["warmup" if s < 256 else "update"] += 1
        elif s % 16 == 0:
            n["warmup" if s < 32 else "update"] += 1
        elif s % 4 == 0:
            n["decay"] += 1
    return n


def _counted_grid_passes(eng) -> dict:
    """Count ``eng``'s occupancy passes by kind (the instance's
    ``update_grid`` and ``decay_grid`` wrapped)."""
    counts = {"warmup": 0, "update": 0, "decay": 0}
    update, decay = eng.update_grid, eng.decay_grid

    def counted_update(state, grid, warmup, **kw):
        counts["warmup" if warmup else "update"] += 1
        return update(state, grid, warmup, **kw)

    def counted_decay(grid):
        counts["decay"] += 1
        return decay(grid)

    eng.update_grid, eng.decay_grid = counted_update, counted_decay
    return counts


def _surface_run(json_path: str, test, untrained: bool = False, **flags):
    """``Testbed`` on ``json_path`` with engine keywords ``flags``,
    ``SURFACE_STEPS`` steps (:func:`_camera_run`), scored on ``test``;
    returns (Testbed, record). The record holds the shares of cells not
    culled and occupied at step 0 and at the end, the passes counted by
    kind, and whether every cell culled at step 0 is −1 at the end
    (``culled_kept``)."""
    import numpy as np
    import torch

    from ngp_tpu_torch.testbed import Testbed

    t0 = time.perf_counter()
    tb = Testbed(scene=json_path, device="cuda", **flags)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    eng = tb.engine
    culled0 = tb.grid.density < 0
    share = lambda grid: {"trainable": float((grid.density >= 0).float().mean()),  # noqa: E731
                          "occupied": float(grid.bitfield.float().mean())}
    run = {"load_s": load_s, "cells_at_step_0": share(tb.grid),
           "sphere_surface_cells_at_step_0": _surface_cells_kept(tb.grid.density)}
    if untrained:
        run["untrained_psnr"] = eng.eval_test_transforms(tb.state, tb.grid, test)["psnr"]
    counts = _counted_grid_passes(eng)
    step_ms, losses = _camera_run(tb, SURFACE_STEPS)
    lo, hi = SURFACE_TIMED
    scores = eng.eval_test_transforms(tb.state, tb.grid, test)
    run.update(steps=SURFACE_STEPS, median_ms_per_step_timed=float(np.median(step_ms[lo:hi])),
               timed_steps=[lo, hi], final_loss=losses[-1],
               losses_finite=bool(np.isfinite(losses).all()),
               psnr=scores["psnr"], per_view_psnr=[v["psnr"] for v in scores["per_view"]],
               cells_at_end=share(tb.grid), grid_passes=dict(counts),
               culled_kept=bool((tb.grid.density[culled0] == -1.0).all()),
               culled_cells=int(culled0.sum()), k_and_rays=list(eng.batch_geometry))
    del eng.update_grid, eng.decay_grid
    return tb, run


def phase_nerf_surface_prior():
    """Phase ``prior``: four runs of ``SURFACE_STEPS`` steps through
    ``Testbed`` at its NeRF config (instant-ngp's base.json: L=16, F=2,
    T=2^19, XOR hash; 2^18 sample slots a step) on the 800×800 capture: the
    default cadence; ``reference_prep_cadence=False,
    grid_stride_update=False`` (the decoupled schedule with probe-sampled
    updates); the capture with the sphere's ``.obj`` beside it; with its
    ``.xyz``. Each: ms a step (median over ``SURFACE_TIMED``), the held-out
    PSNR, the shares of cells trainable (not culled) and occupied at step 0
    and at the end, the share of the sphere's surface cells kept
    (:func:`_surface_cells_kept`), the passes by kind. Gates: every cell
    culled at step 0 still −1 at the end; the passes equal
    :func:`_grid_events`; the cloud prior's PSNR at most
    ``SURFACE_PRIOR_DB`` below the default run's (a prior that trains the
    scene better than the frustum alone passes); the decoupled and mesh
    runs' at least ``SURFACE_TRAINED_DB`` above their untrained models';
    a prior culls more than the frustum. The mesh prior is not held within
    ``SURFACE_PRIOR_DB`` of the default run: the JAX package's
    ``seed_grid_from_mesh``, which the port copies cell for cell, samples
    each triangle at half-voxel spacing and leaves about 15% of the
    sphere's surface cells culled for good (ROADMAP C.ref 13; the
    record's ``psnr_minus_default_db`` shows the cost). Returns (the
    default run's Testbed, the decoupled run's Testbed, the capture's test
    set)."""
    from ngp_tpu_torch.data.nerf_loader import load_nerf

    t0 = time.perf_counter()
    caps = _surface_captures()
    seconds = {"captures": time.perf_counter() - t0}
    test = load_nerf(caps["plain"][1])
    runs, kept = {}, {}
    for name, path, flags in (
            ("default", caps["plain"][0], {}),
            ("decoupled_probe", caps["plain"][0],
             dict(reference_prep_cadence=False, grid_stride_update=False)),
            ("mesh_prior", caps["mesh"][0], {}), ("cloud_prior", caps["cloud"][0], {})):
        t = time.perf_counter()
        tb, run = _surface_run(path, test, untrained=name in ("decoupled_probe", "mesh_prior"),
                               **flags)
        run["expected_grid_passes"] = _grid_events(SURFACE_STEPS, not flags)
        runs[name] = run
        if name in ("default", "decoupled_probe"):
            kept[name] = tb
        del tb
        seconds[name] = time.perf_counter() - t
    base = runs["default"]
    gates = {
        "culled_kept": all(r["culled_kept"] for r in runs.values()),
        "grid_passes": all(r["grid_passes"] == r["expected_grid_passes"]
                           for r in runs.values()),
        "cloud_prior_psnr": runs["cloud_prior"]["psnr"] >= base["psnr"] - SURFACE_PRIOR_DB,
        "prior_culls": all(runs[n]["culled_cells"] > base["culled_cells"]
                           for n in ("mesh_prior", "cloud_prior")),
        "decoupled_and_mesh_trained": all(
            runs[n]["psnr"] >= runs[n]["untrained_psnr"] + SURFACE_TRAINED_DB
            for n in ("decoupled_probe", "mesh_prior")),
        "losses_finite": all(r["losses_finite"] for r in runs.values()),
    }
    for n in ("mesh_prior", "cloud_prior"):
        runs[n]["psnr_minus_default_db"] = runs[n]["psnr"] - base["psnr"]
    emit({"phase": "prior", "res": CAPTURE_RES, "config": "Testbed nerf default (base.json)",
          "runs": runs, "gates": {"prior_db": SURFACE_PRIOR_DB,
                                  "trained_db": SURFACE_TRAINED_DB, "passed": gates},
          "seconds": seconds})
    for name, ok in gates.items():
        if not ok:
            raise AssertionError(f"prior: gate {name} failed")
    return kept["default"], kept["decoupled_probe"], test


def _timed(fn):
    """(fn's result, its wall ms with the card synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_nerf_surface_render(tb, test):
    """Phase ``render_surface`` on the default run's model: a
    ``SURFACE_FRAME`` frame from held-out view 0's pose (pinhole,
    ``SURFACE_FRAME_FOCAL``) uncropped, with the crop box at the scene box
    (gate: the same bits) and at ``SURFACE_HALF_BOX`` (gates: the
    background exactly at the rays that miss it, fewer marched samples);
    training view 0 with the "gt" (gate: its left half the ground truth
    exactly) and "error" overlays (finite, in [0, 1]); a
    ``SURFACE_SLICE_RES``² density slice (gate: equal to
    ``chunked_density`` at its positions, activated); a foveated frame at
    buffer scale ``SURFACE_FOVEA[0]`` (gate: mean |difference| from the
    full frame in the central ``SURFACE_FOVEA_WINDOW``² window below
    ``SURFACE_FOVEA_ERR_MAX``); ``optimize_mesh_vertices`` on the
    ``SURFACE_MESH_RES``³ mesh, ``SURFACE_MESH_STEPS`` steps (gate: the
    mean |σ(v) − thresh| over the vertices falls). The ms of each render
    beside the full frame's. Returns the mesh (vertices, faces)."""
    import numpy as np
    import torch

    from ngp_tpu_torch.geometry.camera import Lens
    from ngp_tpu_torch.geometry.foveation import Foveation
    from ngp_tpu_torch.ops.composite import density_activation

    eng, state, grid = tb.engine, tb.state, tb.grid
    W, H = SURFACE_FRAME
    xf = test.xforms[0, 0]
    focal = (SURFACE_FRAME_FOCAL, SURFACE_FRAME_FOCAL)
    gates, out = {}, {}

    def frame():
        return eng.render_view(state, grid, xf, focal, width=W, height=H, lens=Lens())

    (full, _, _), out["frame_ms"] = _timed(frame)
    full_samples = eng.last_render_samples
    aabb = (eng.aabb.min.cpu().numpy(), eng.aabb.max.cpu().numpy())
    tb.render_aabb = aabb
    (same, _, _), out["crop_scene_box_ms"] = _timed(frame)
    gates["crop_at_scene_box_bit_exact"] = torch.equal(same, full)
    tb.render_aabb = SURFACE_HALF_BOX
    (half, _, _), out["crop_half_box_ms"] = _timed(frame)
    half_samples = eng.last_render_samples
    tb.render_aabb = None
    o = torch.as_tensor(np.asarray(xf, np.float32)[:, 3], device="cuda")
    u = (torch.arange(W, device="cuda") + 0.5 - 0.5 * W) / focal[0]
    v = (torch.arange(H, device="cuda") + 0.5 - 0.5 * H) / focal[1]
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([uu, vv, torch.ones_like(uu)], -1).reshape(-1, 3) @ torch.as_tensor(
        np.asarray(xf, np.float32)[:, :3], device="cuda").T
    box = [torch.tensor(b, dtype=torch.float32, device="cuda") for b in SURFACE_HALF_BOX]
    t0 = (box[0] - o) / d
    t1 = (box[1] - o) / d
    miss = (torch.clamp_min(torch.minimum(t0, t1).amax(-1), 0.0)
            > torch.maximum(t0, t1).amin(-1)).reshape(H, W)
    bg = torch.as_tensor(eng.background_color, dtype=torch.float32, device="cuda")
    gates["crop_half_box_background"] = bool(miss.any()) and bool((half[miss] == bg).all())
    gates["crop_half_box_fewer_samples"] = half_samples < full_samples
    out.update(full_samples=full_samples, half_box_samples=half_samples,
               half_box_miss_pixels=int(miss.sum()))

    gt_img, out["overlay_gt_ms"] = _timed(
        lambda: eng.render_image(state, grid, 0, overlay="gt"))
    err_img, out["overlay_error_ms"] = _timed(
        lambda: eng.render_image(state, grid, 0, overlay="error"))
    _, out["view_0_ms"] = _timed(lambda: eng.render_image(state, grid, 0))
    gt = eng.images[0, ..., :3].to(torch.float32) / 255.0
    half_w = gt_img.shape[1] // 2
    gates["overlay_gt_left_half"] = torch.equal(gt_img[:, :half_w], gt[:, :half_w])
    gates["overlay_error_in_range"] = bool(torch.isfinite(err_img).all()) and bool(
        (err_img >= 0).all() and (err_img <= 1).all())

    res = SURFACE_SLICE_RES
    sl, out["density_slice_ms"] = _timed(lambda: eng.render_density_slice(state, 0.5, res))
    xs = (np.arange(res) + 0.5) / res
    px, py = np.meshgrid(xs, xs)
    pos = torch.as_tensor(np.stack([px, np.full_like(px, 0.5), py], -1).reshape(-1, 3),
                          dtype=torch.float32, device="cuda")
    want = density_activation(eng.density_act)(
        eng.chunked_density(eng.inference_params(state), pos)).cpu().numpy()
    gates["density_slice_equal"] = bool(np.array_equal(sl.reshape(-1), want))
    out["density_slice_range"] = [float(sl.min()), float(sl.max())]

    fov = Foveation.make(*SURFACE_FOVEA)
    (fov_img, buf), out["foveated_ms"] = _timed(lambda: eng.render_view_foveated(
        state, grid, xf, focal, fov, width=W, height=H, buffer_scale=SURFACE_FOVEA[0]))
    h, w, k = H // 2, W // 2, SURFACE_FOVEA_WINDOW // 2
    fovea_err = float((fov_img[h - k:h + k, w - k:w + k] - full[h - k:h + k, w - k:w + k]
                       ).abs().mean())
    gates["foveated_centre"] = fovea_err < SURFACE_FOVEA_ERR_MAX
    out.update(foveated_buffer=list(buf), foveated_centre_mean_abs_err=fovea_err,
               foveated_whole_mean_abs_err=float((fov_img - full).abs().mean()))

    (verts, faces), mesh_ms = _timed(lambda: eng.compute_marching_cubes_mesh(
        state, SURFACE_MESH_RES, SURFACE_MESH_THRESH))
    verts, faces = np.ascontiguousarray(verts), np.ascontiguousarray(faces)
    if len(faces) == 0:
        raise AssertionError(f"render_surface: the {SURFACE_MESH_RES}³ mesh at "
                             f"{SURFACE_MESH_THRESH} is empty")
    model = eng.inference_params(state)

    def off_surface(v):
        raw = eng.chunked_density(model, eng.aabb.relative_pos(torch.as_tensor(v).cuda()))
        return float((raw - SURFACE_MESH_THRESH).abs().mean())

    before = off_surface(verts)
    opt, opt_ms = _timed(lambda: eng.optimize_mesh_vertices(
        state, verts, faces, SURFACE_MESH_STEPS, SURFACE_MESH_THRESH))
    after = off_surface(opt)
    gates["mesh_off_surface_falls"] = after < before
    out.update(mesh_vertices=len(verts), mesh_faces=len(faces), mesh_s=mesh_ms / 1e3,
               mesh_opt_s=opt_ms / 1e3, mesh_opt_steps=SURFACE_MESH_STEPS,
               mesh_mean_abs_sigma_minus_thresh=[before, after],
               mesh_max_moved=float((opt.cpu() - torch.from_numpy(verts)).abs().max()))
    emit({"phase": "render_surface", "frame": [W, H], "half_box": SURFACE_HALF_BOX,
          **out, "gates": {"fovea_err_max": SURFACE_FOVEA_ERR_MAX, "passed": gates}})
    for name, ok in gates.items():
        if not ok:
            raise AssertionError(f"render_surface: gate {name} failed")
    return verts, faces


def _distinct_rows(x, geo, interp: str = "Linear") -> int:
    """The distinct table rows the positions ``x`` read over every level."""
    import torch

    from ngp_tpu_torch.ops.hashgrid import _level_corners, _levels

    rows = 0
    for lg in _levels(*geo[:4]):
        rows += int(torch.unique(torch.cat(
            [i for i, _ in _level_corners(x, *lg, geo[4] == "additive", interp)])).numel())
    return rows


def _registers(kernel: str, args: str, interp: str = "Linear") -> list:
    """ptxas's registers a thread of ``kernel``'s instantiations whose
    template arguments (as mangled) are ``args`` and then the interpolation
    flag (``Lb0E`` Linear, ``Lb1E`` Simplex); a build from before Simplex
    has no flag, and its instantiations count as Linear."""
    from ngp_tpu_torch.ops.hashgrid import HASHGRID_ENCODE

    flags = ("Lb1E",) if interp == "Simplex" else ("Lb0E", "")
    found = []
    for name, n in ptxas_registers(HASHGRID_ENCODE).items():
        m = re.search(kernel + r"I(\w*?)EEv", name)
        if m and m.group(1).startswith(args) and m.group(1)[len(args):] in flags:
            found.append(n)
    return found


def phase_nerf_surface_kernels(tb, probe_tb, verts, faces):
    """Phase ``nerf_surface_kernels``: B1 on the density slice's own
    ``SURFACE_SLICE_RES``² positions (the served table, as the slice reads
    it; bit for bit), the fused grid backward on one probe-sampled run's
    step's own (x, g) (within the float32 order bound), and the position
    gradient on the mesh's own vertices (one vertex step's call; bit for
    bit), each against its twin with its times and bound."""
    import torch

    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference

    eng = tb.engine
    kept = []
    encode = _keep_largest(hashgrid_ops, "hashgrid_encode_cuda", kept)
    try:
        eng.render_density_slice(tb.state, 0.5, SURFACE_SLICE_RES)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_encode_cuda = encode
    x, table, *geo = kept[0]
    geo = tuple(geo[:5])
    enc = eng.inference_params(tb.state).pos_encoding
    dtype = torch.bfloat16 if enc.bf16_reads else torch.float32
    row = _kernel_case("base.json", dtype, torch.Generator().manual_seed(19), x=x.detach(),
                       enc=enc, rows_read=_distinct_rows(x, geo))
    got = hashgrid_ops.hashgrid_encode_cuda(x, table, *geo)
    if not torch.equal(got, hashgrid_ops.hashgrid_encode_reference(x, table, *geo)):
        raise AssertionError("nerf_surface_kernels: B1 differs from its twin on the "
                             "slice's served table")
    emit({"phase": "nerf_surface_kernels", "kernel": "hashgrid_encode",
          "shape": "density_slice_positions", **row})

    kept = []
    backward = _keep_largest(hashgrid_ops, "hashgrid_backward_cuda", kept)
    try:
        probe_tb.train(1)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_backward_cuda = backward
    x, g, scale, res, size, hashed, variant, _, n_rows = kept[0][:9]
    payload = kept[0][9] if len(kept[0]) > 9 else "bfloat16"
    geo = (scale, res, size, hashed, variant)
    keys, vals = hashgrid_backward_addends_reference(x, g, *geo)
    emit({"phase": "nerf_surface_kernels", "kernel": "hashgrid_backward", "payload": payload,
          "shape": "probe_sampled_step", "N": x.shape[0], "L": scale.shape[0], "T": n_rows,
          "F": vals.shape[2], "hash": variant,
          **_backward_row(x, g, geo, n_rows, keys, vals, payload)})
    del keys, vals, kept

    kept = []
    input_grad = _keep_largest(hashgrid_ops, "hashgrid_input_grad_cuda", kept)
    try:
        eng.optimize_mesh_vertices(tb.state, verts, faces, 1, SURFACE_MESH_THRESH)
        torch.cuda.synchronize()
    finally:
        hashgrid_ops.hashgrid_input_grad_cuda = input_grad
    x, g, table, *geo = kept[0]
    row = _input_grad_row(x.detach(), g, table.detach(), tuple(geo[:5]))
    emit({"phase": "nerf_surface_kernels", "kernel": "hashgrid_input_grad",
          "shape": "mesh_vertices", **row})
    _library_shares(probe_tb, tb, verts, faces)


def _library_shares(probe_tb, tb, verts, faces):
    """The two library calls of this slice's paths against the device time
    of the pass that makes them: the atomic max-splat (``scatter_reduce_``)
    of a probe-sampled update on its own cells and densities against the
    update's busy ms, and the 1-ring and normal sums (``index_add_``) on the
    mesh against one vertex step's busy ms (ROADMAP A12 queues a kernel
    for either above a few per cent)."""
    import torch

    from ngp_tpu_torch.ops import occupancy as occ
    from ngp_tpu_torch.ops.composite import density_activation
    from ngp_tpu_torch.ops.mesh_opt import vertex_ring_and_normals

    eng, cfg = probe_tb.engine, probe_tb.engine.grid_cfg
    n_part = cfg.n_cells // eng.grid_sample_divisor * cfg.n_cascades
    idx, pos = occ.sample_update_cells(cfg, probe_tb.grid.density, n_part, n_part,
                                       generator=eng.generator)
    sigma = density_activation(eng.density_act)(
        eng.chunked_density(probe_tb.state.model, eng.aabb.relative_pos(pos)))
    thick = sigma * occ.MIN_CONE_STEPSIZE
    splat_ms = device_ms(lambda: occ.splat_max(cfg, idx, thick))
    update_ms = _frame_device_ms(lambda: eng.update_grid(probe_tb.state, probe_tb.grid, False))
    v = torch.from_numpy(verts).cuda()
    f = torch.from_numpy(faces).cuda().long()
    ring_ms = device_ms(lambda: vertex_ring_and_normals(v, f))
    step_ms = _frame_device_ms(lambda: tb.engine.optimize_mesh_vertices(
        tb.state, verts, faces, 1, SURFACE_MESH_THRESH))
    emit({"phase": "nerf_surface_kernels", "library": "splat_max (scatter_reduce_ amax)",
          "samples": int(idx.numel()), "ms": splat_ms, "update_busy_ms": update_ms,
          "share": splat_ms / update_ms})
    emit({"phase": "nerf_surface_kernels", "library": "1-ring and normal sums (index_add_)",
          "faces": int(f.shape[0]), "ms": ring_ms, "vertex_step_busy_ms": step_ms,
          "share": ring_ms / step_ms})


def phase_nerf_surface_all():
    """``chip_smoke.py nerf_surface``: phases prior, render_surface and
    nerf_surface_kernels; then the launches of the first two (counted from
    zero) on one line. The phases launched B1, the fused backward and the
    position gradient."""
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    t0 = time.perf_counter()
    reset_launches()
    tb, probe_tb, test = phase_nerf_surface_prior()
    t1 = time.perf_counter()
    verts, faces = phase_nerf_surface_render(tb, test)
    launches = launch_counts()
    t2 = time.perf_counter()
    phase_nerf_surface_kernels(tb, probe_tb, verts, faces)
    t3 = time.perf_counter()
    emit({"phase": "nerf_surface_launches", "launches": launches,
          "seconds": {"prior": t1 - t0, "render_surface": t2 - t1,
                      "nerf_surface_kernels": t3 - t2}})
    for name in ("hashgrid_encode", "hashgrid_backward", "hashgrid_input_grad"):
        if launches[name] == 0:
            raise AssertionError(f"nerf_surface: the phases launched {name} no time")


ENC_NERF_STEPS = 200
ENC_NERF_TRAINED_DB = 10.0  # held-out PSNR over the untrained model's
ENC_RELOAD_DB = 0.05  # the .ingp round trip's held-out PSNR, as CLI_RELOAD_DB
ENC_FRAME = (960, 540)
ENC_IMAGE_STEPS = 200
ENC_IMAGE_TRAINED_DB = 5.0
ENC_SDF_STEPS = 300
ENC_SDF_LOSS_RATIO = 0.5  # the hash grid's last loss below half of step 0's
ENC_SDF_WINDOW = 10  # steps averaged at each end of a table-free encoding's run
# a table-free encoding's gates, set between what its sound runs read and
# what its run with shuffled targets reads (``chip_smoke.py
# encodings_control``): the loss's window mean falls by at least this share,
# and the trained IoU reaches this
ENC_SDF_FREE_DROP = 0.03
ENC_SDF_FREE_IOU = 0.33
ENC_SDF_FREE = ({"otype": "Frequency"}, {"otype": "TriangleWave"}, {"otype": "OneBlob"})
ENC_SDF_ENCODINGS = ENC_SDF_FREE + ({"otype": "HashGrid", "interpolation": "Simplex"},)
ENC_KERNELS = ("hashgrid_encode", "hashgrid_backward", "hashgrid_input_grad")


def _enc_name(cfg: dict) -> str:
    return cfg.get("interpolation") or cfg["otype"]


def _variant_rows(shape: str, kernels: tuple, x, g, table, geo, interp: str) -> list:
    """Phase ``encodings_kernels``: of the three grid kernels, ``kernels``,
    in the instantiation of ``geo``'s grid (Tiled levels need no flag: the
    geometry's masks make them) and ``interp``, on one path's own positions
    ``x``, cotangents ``g`` and table: B1 bit for bit against its twin with
    ``embedding_bag`` as yardstick, the fused backward (bf16 addends) within
    the float32 order bound, the position gradient bit for bit; each with
    ptxas's registers, times and bound. A Simplex sample reads D + 1 rows
    where a Linear one reads 2^D. Emits the rows and returns them."""
    import torch

    from ngp_tpu_torch.ops.hashgrid import (
        hashgrid_backward_addends_reference,
        hashgrid_encode_cuda,
        hashgrid_encode_reference,
        n_corners,
    )

    x, table = x.detach(), table.detach()
    (N, D), (L, T, F) = x.shape, table.shape
    C = n_corners(D, interp)
    base = {"phase": "encodings_kernels", "shape": shape, "N": N, "D": D, "L": L, "T": T,
            "F": F, "hash": geo[4], "interpolation": interp,
            "wrapping_levels": sum(1 for r, s, h in zip(*(t.tolist() for t in geo[1:4]))
                                   if not h and r ** D > s)}
    rows = []
    if "hashgrid_encode" in kernels:
        fwd = lambda: hashgrid_encode_cuda(x, table, *geo, None, interp)  # noqa: E731
        got = fwd()
        torch.cuda.synchronize()
        ref = hashgrid_encode_reference(x, table, *geo, None, interp)
        if not torch.equal(got, ref):
            raise AssertionError(f"encodings_kernels {shape}: B1 differs from its twin, max "
                                 f"abs err {float((got - ref).abs().max())}")
        n_rows = _distinct_rows(x, geo, interp)
        rows.append({
            **base, "kernel": "hashgrid_encode", "max_abs_err": 0.0, "rows_read": n_rows,
            "registers": _registers("hashgrid_encode_kernel", f"Li{D}ELi{F}Ef", interp),
            "ms": device_ms(fwd), "call_ms": cuda_ms(fwd, iters=20),
            "plain_ms": cuda_ms(lambda: hashgrid_encode_reference(x, table, *geo, None, interp),
                                iters=3, warmup=1),
            "library_ms": _embedding_bag_ms(x, table, geo, ref, interp),
            # x read and features written once, each distinct row read once;
            # 3D for the cell, D·D for the ranks and weights or C·(D − 1)
            # weight products, 2·C·F multiply-adds per (sample, level)
            **_bound(N * (4 * D + 4 * L * F) + n_rows * F * 4,
                     N * L * (3 * D + (D * D if interp == "Simplex" else C * (D - 1))
                              + 2 * C * F)),
        })
        del got, ref
    if "hashgrid_backward" in kernels:
        keys, vals = hashgrid_backward_addends_reference(x, g, *geo, None, interp)
        rows.append({**base, "kernel": "hashgrid_backward", "payload": "bfloat16",
                     "registers": _registers("hashgrid_backward_kernel", f"Li{D}ELi{F}ELb1E",
                                             interp),
                     **_backward_row(x, g, geo, T, keys, vals, "bfloat16", interp)})
        del keys, vals
    if "hashgrid_input_grad" in kernels:
        rows.append({**_input_grad_row(x, g, table, geo, interp), **base,
                     "kernel": "hashgrid_input_grad"})
    for row in rows:
        emit(row)
    return rows


def _keep_call(module, name: str, run):
    """Run ``run()`` with ``module.name`` wrapped so that its largest call's
    positional arguments are kept; returns them."""
    import torch

    kept = []
    original = _keep_largest(module, name, kept)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        setattr(module, name, original)
    return kept[0]


def _enc_nerf_run(name: str, encoding: dict, caps, test) -> list:
    """Phase ``encodings_nerf``: ``Testbed`` at its NeRF config (base.json)
    with ``encoding`` merged into its position encoding, on the 800×800
    capture: the untrained and trained held-out PSNR over
    ``ENC_NERF_STEPS`` steps (gate ``ENC_NERF_TRAINED_DB``), a
    ``ENC_FRAME`` frame, a normals frame of the same camera (gates: the
    position gradient launched, no table gradient; the median cosine with
    the capture sphere's outward normal at the opaque pixels reaches
    ``NORMALS_COS_MIN``), a reference ``.ingp`` saved and loaded (gate: the
    held-out PSNR within ``ENC_RELOAD_DB``), and one more step. Returns the
    kernel cases (:func:`_variant_rows`' arguments) on that step's own (x,
    g) (forward and backward) and on the normals frame's largest position
    gradient call (the position gradient)."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.synthetic import CAPTURE_CENTER
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.cuda_build import launch_counts
    from ngp_tpu_torch.testbed import Testbed, default_config

    cfg = default_config("nerf")
    cfg["encoding"].update(encoding)
    t0 = time.perf_counter()
    tb = Testbed(scene=caps[0], config=cfg, device="cuda")
    eng = tb.engine
    enc = eng.network.pos_encoding
    run = {"encoding": cfg["encoding"], "grid_type": enc.grid_type,
           "interpolation": enc.interpolation, "bf16_reads": enc.bf16_reads,
           "load_s": time.perf_counter() - t0,
           "untrained_psnr": eng.eval_test_transforms(tb.state, tb.grid, test)["psnr"]}
    step_ms, losses = _camera_run(tb, ENC_NERF_STEPS)
    run.update(steps=ENC_NERF_STEPS, median_ms_per_step=float(np.median(step_ms[50:])),
               final_loss=losses[-1], losses_finite=bool(np.isfinite(losses).all()),
               psnr=eng.eval_test_transforms(tb.state, tb.grid, test)["psnr"])
    center = np.asarray(CAPTURE_CENTER, np.float32)
    eye = center + np.asarray([math.cos(0.4), math.sin(0.4), 0.3], np.float32) * 1.1
    o, d = _camera_rays(eye, center, ENC_FRAME, 60.0)
    frames, kept = {}, []
    for mode in ("shade", "normals"):
        before = launch_counts()
        original = _keep_largest(hashgrid_ops, "hashgrid_input_grad_cuda", kept)
        try:
            (rgb, depth, opacity), wall_ms = _timed(
                lambda: eng.render_rays(tb.state, tb.grid, o, d, mode=mode))
        finally:
            hashgrid_ops.hashgrid_input_grad_cuda = original
        frames[mode] = {"wall_ms": wall_ms, "finite": bool(torch.isfinite(rgb).all()),
                        "launches": {k: v - before[k] for k, v in launch_counts().items()
                                     if v != before[k]}}
    hit = opacity > NORMALS_OPACITY
    p = o[hit] + d[hit] * (depth[hit] / opacity[hit])[:, None]
    truth = torch.nn.functional.normalize(p - torch.from_numpy(center).cuda(), dim=-1)
    n = 2.0 * rgb[hit] - 1.0
    cos = (n * truth).sum(-1) / torch.clamp_min(torch.linalg.norm(n, dim=-1), 1e-12)
    frames["normals"].update(pixels_gated=int(hit.sum()),
                             median_cos=float(cos.median()) if cos.numel() else float("nan"))
    path = os.path.join(ROOT, "build", "encodings_smoke", f"{name}.ingp")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    eng.save_reference_snapshot(path, tb.state, tb.grid)
    state2, grid2 = eng.load_reference_snapshot(path)
    run["ingp"] = {"bytes": os.path.getsize(path), "round_trip_s": time.perf_counter() - t0,
                   "psnr_reloaded": eng.eval_test_transforms(state2, grid2, test)["psnr"]}
    del state2, grid2
    run["frames"] = frames
    emit({"phase": "encodings_nerf", "run": name, "config": "Testbed nerf default (base.json)",
          "res": CAPTURE_RES, **run})
    gates = {
        "trained": run["psnr"] >= run["untrained_psnr"] + ENC_NERF_TRAINED_DB,
        "losses_finite": run["losses_finite"],
        "frames_finite": frames["shade"]["finite"] and frames["normals"]["finite"],
        "normals_launches": (frames["normals"]["launches"].get("hashgrid_input_grad", 0) > 0
                             and not frames["normals"]["launches"].get("hashgrid_backward")),
        "normals_cos": frames["normals"]["median_cos"] >= NORMALS_COS_MIN,
        "ingp_reload": abs(run["ingp"]["psnr_reloaded"] - run["psnr"]) <= ENC_RELOAD_DB,
    }
    for gate, ok in gates.items():
        if not ok:
            raise AssertionError(f"encodings_nerf {name}: gate {gate} failed")

    interp = enc.interpolation
    x, g, *geo = _keep_call(hashgrid_ops, "hashgrid_backward_cuda", lambda: tb.train(1))
    xi, gi, ti, *geo_i = kept[0]
    return [(f"nerf_{name}_step", ENC_KERNELS[:2], x, g,
             tb.state.model.pos_encoding.table, tuple(geo[:5]), interp),
            (f"nerf_{name}_normals_frame", ENC_KERNELS[2:], xi, gi, ti, tuple(geo_i[:5]),
             interp)]


def _enc_image_run() -> list:
    """Phase ``encodings_image``: ``ImageEngine`` at ``Testbed``'s image
    config (configs/image/base.json: D = 2, L=16, F=2, T=2^24) with Simplex
    interpolation on the 104.9 MP procedural image, ``ENC_IMAGE_STEPS``
    steps (gate: the stride-16 PSNR ``ENC_IMAGE_TRAINED_DB`` above the
    untrained model's), then one more step. Returns the D = 2 kernel cases
    on that step's own (x, g): Simplex on the trained table, Tiled on a
    Tiled grid of the same config (random table), whose levels 12-15
    wrap."""
    import numpy as np
    import torch

    from ngp_tpu_torch.data.synthetic import gigapixel_image
    from ngp_tpu_torch.engines.image import ImageEngine
    from ngp_tpu_torch.models.factory import create_encoding
    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.testbed import default_config

    img = gigapixel_image(IMAGE_SIDE, "cuda", torch.float16)
    cfg = default_config("image")
    cfg["encoding"]["interpolation"] = "Simplex"
    eng = ImageEngine(cfg, img, batch_size=1 << 18)
    state = eng.init_state()
    untrained = _image_psnr(eng, state, IMAGE_PSNR_STRIDE)
    t0 = time.perf_counter()
    state, losses = eng.train(state, ENC_IMAGE_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    losses = losses.cpu().numpy()
    psnr = _image_psnr(eng, state, IMAGE_PSNR_STRIDE)
    emit({"phase": "encodings_image", "config": "Testbed image default + Simplex",
          "side": IMAGE_SIDE, "table": list(state.model.encoding.table.shape),
          "steps": ENC_IMAGE_STEPS, "wall_s": wall_s, "ms_per_step": wall_s * 1e3 / ENC_IMAGE_STEPS,
          "loss_first_last": [float(losses[0]), float(losses[-1])],
          "untrained_psnr_subsampled": untrained, "psnr_subsampled": psnr,
          "gate_db": ENC_IMAGE_TRAINED_DB})
    if not (np.isfinite(losses).all() and psnr >= untrained + ENC_IMAGE_TRAINED_DB):
        raise AssertionError(f"encodings_image: PSNR {psnr} dB, untrained {untrained} dB")
    x, g, *geo = _keep_call(hashgrid_ops, "hashgrid_backward_cuda",
                            lambda: eng.train(state, 1))
    tcfg = dict(cfg["encoding"], otype="TiledGrid", interpolation="Linear")
    tiled = create_encoding(2, tcfg, "cuda")
    tiled.reset_parameters(torch.Generator().manual_seed(20))
    tgeo = (tiled.level_scale, tiled.level_res, tiled.level_size, tiled.level_hashed,
            tiled.hash_variant)
    return [("image_simplex_step", ENC_KERNELS, x, g, state.model.encoding.table,
             tuple(geo[:5]), "Simplex"),
            ("image_step_on_a_tiled_grid", ENC_KERNELS, x, g, tiled.table, tgeo, "Linear")]


def _enc_sdf_mesh() -> str:
    """The 327,680-triangle bumpy sphere's OBJ, written once into
    ``build/encodings_smoke/`` (not phase sdf's copy, which the other lane
    may be writing)."""
    from ngp_tpu_torch.data.synthetic import write_bumpy_sphere_mesh

    out = os.path.join(ROOT, "build", "encodings_smoke")
    os.makedirs(out, exist_ok=True)
    mesh = os.path.join(out, "bumpy_sphere.obj")
    if not os.path.exists(mesh):
        write_bumpy_sphere_mesh(mesh, SDF_SUBDIVISIONS)
    return mesh


def _enc_sdf_run(tb, encoding: dict, shuffled: bool = False) -> tuple:
    """``Testbed`` on the bumpy sphere with the sdf config's network and
    ``encoding`` (tcnn's defaults) in place of its hash grid: made anew where
    ``tb`` is None, else ``tb`` reloaded (``reload_network_from_json``);
    untrained IoU over 2^18 points, ``ENC_SDF_STEPS`` steps, trained IoU.
    With ``shuffled`` the steps train on one batch whose distances are
    permuted across its points (a broken input: the encoding of each point
    meets another point's target). Returns (the Testbed, the run's
    readings, the losses)."""
    import torch

    from ngp_tpu_torch.testbed import Testbed, default_config

    cfg = default_config("sdf")
    cfg["encoding"] = dict(cfg["encoding"], **encoding) if "interpolation" in encoding \
        else dict(encoding)
    t0 = time.perf_counter()
    if tb is None:
        tb = Testbed(scene=_enc_sdf_mesh(), config=cfg)
    else:
        tb.reload_network_from_json(cfg)
    eng = tb.engine
    load_s = time.perf_counter() - t0
    if shuffled:
        pos, dist = eng.training_batch(0)
        perm = torch.randperm(dist.shape[0], generator=torch.Generator().manual_seed(7))
        eng.override_training_data = (pos, dist[perm.to(dist.device)])
    untrained = eng.calculate_iou(tb.state, SDF_IOU_SAMPLES)
    t0 = time.perf_counter()
    tb.state, losses = eng.train(tb.state, ENC_SDF_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    losses = losses.cpu().numpy()
    w = ENC_SDF_WINDOW
    return tb, {"encoding": cfg["encoding"], "shuffled_targets": shuffled,
                "n_output_dims": tb.state.model.encoding.n_output_dims, "load_s": load_s,
                "steps": ENC_SDF_STEPS, "ms_per_step": wall_s * 1e3 / ENC_SDF_STEPS,
                "loss_step0_last": [float(losses[0]), float(losses[-1])],
                "loss_window_means": [float(losses[:w].mean()), float(losses[-w:].mean())],
                "loss_window_drop": float(1.0 - losses[-w:].mean() / losses[:w].mean()),
                "untrained_iou": untrained,
                "iou": eng.calculate_iou(tb.state, SDF_IOU_SAMPLES)}, losses


def _enc_sdf_runs() -> list:
    """Phase ``encodings_sdf``: ``Testbed`` on the 327,680-triangle bumpy
    sphere at its sdf config's MLP (64 wide, 2 hidden layers, MAPE, 2^18
    samples a step) with each of ``ENC_SDF_ENCODINGS``
    (:func:`_enc_sdf_run`: the first built with it, the others through
    ``reload_network_from_json``). Gates: finite losses; the IoU above the
    untrained network's; the Simplex hash grid's last loss below
    ``ENC_SDF_LOSS_RATIO`` of step 0's; the table-free encodings', whose MLP
    alone learns at the config's Adam of 1e-4, the mean of the last
    ``ENC_SDF_WINDOW`` steps at least ``ENC_SDF_FREE_DROP`` below the
    first's and the IoU at least ``ENC_SDF_FREE_IOU``, both above what the
    run reads with shuffled targets (``chip_smoke.py encodings_control``).
    For the Simplex hash grid a 960×540 normals frame (the D = 3 Simplex
    position gradient; gate: launched). Returns the kernel case on that
    frame's largest position gradient call."""
    import numpy as np
    import torch

    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops.cuda_build import launch_counts
    from ngp_tpu_torch.testbed import SDF_EYE, SDF_FOV_DEG, SDF_LOOKAT

    tb, runs, case = None, {}, None
    for encoding in ENC_SDF_ENCODINGS:
        name = _enc_name(encoding)
        tb, run, losses = _enc_sdf_run(tb, encoding)
        runs[name] = run
        ok = np.isfinite(losses).all() and run["iou"] > run["untrained_iou"]
        if name == "Simplex":
            eng = tb.engine
            o, d = (torch.from_numpy(a).cuda() for a in
                    eng.camera_rays(SDF_EYE, SDF_LOOKAT, SDF_FRAME, SDF_FOV_DEG))
            before = launch_counts()
            kept = []
            original = _keep_largest(hashgrid_ops, "hashgrid_input_grad_cuda", kept)
            try:
                (rgb, _, hit), wall_ms = _timed(
                    lambda: eng.render_rays(tb.state, o, d, False, mode="normals"))
            finally:
                hashgrid_ops.hashgrid_input_grad_cuda = original
            run["normals_frame"] = {
                "wall_ms": wall_ms, "finite": bool(torch.isfinite(rgb).all()),
                "hit_share": float(hit.float().mean()),
                "launches": {k: v - before[k] for k, v in launch_counts().items()
                             if v != before[k]}}
            x, g, table, *geo = kept[0]
            case = ("sdf_simplex_normals_frame", ENC_KERNELS[2:], x, g, table, tuple(geo[:5]),
                    "Simplex")
            ok = (ok and losses[-1] < ENC_SDF_LOSS_RATIO * losses[0]
                  and run["normals_frame"]["finite"]
                  and run["normals_frame"]["launches"].get("hashgrid_input_grad", 0) > 0)
        else:
            ok = (ok and run["loss_window_drop"] >= ENC_SDF_FREE_DROP
                  and run["iou"] >= ENC_SDF_FREE_IOU)
        if not ok:
            emit({"phase": "encodings_sdf", "runs": runs})
            raise AssertionError(f"encodings_sdf {name}: a gate failed")
    emit({"phase": "encodings_sdf", "config": "Testbed sdf default, encodings replaced",
          "triangles": tb.engine.mesh.n_triangles, "runs": runs,
          "gates": {"simplex_loss_ratio": ENC_SDF_LOSS_RATIO, "window": ENC_SDF_WINDOW,
                    "free_drop": ENC_SDF_FREE_DROP, "free_iou": ENC_SDF_FREE_IOU}})
    return [case]


def phase_encodings_control():
    """``chip_smoke.py encodings_control`` (not part of the smoke run): the
    table-free SDF encodings' runs of :func:`_enc_sdf_runs` with shuffled
    targets, the broken input that the gates ``ENC_SDF_FREE_DROP`` and
    ``ENC_SDF_FREE_IOU`` must tell from a sound run; one line, no gate."""
    phase_env()
    tb, runs = None, {}
    for encoding in ENC_SDF_FREE:
        tb, runs[_enc_name(encoding)], _ = _enc_sdf_run(tb, encoding, shuffled=True)
    emit({"phase": "encodings_control", "config": "Testbed sdf default, encodings replaced",
          "runs": runs})


def phase_encodings_all():
    """``chip_smoke.py encodings``: ROADMAP A7a at full width through
    ``Testbed``: a Simplex and a TiledGrid NeRF (base.json) on the 800×800
    capture (:func:`_enc_nerf_run`), a Simplex image fit at the image config
    (:func:`_enc_image_run`) and four SDF encodings on the bumpy sphere
    (:func:`_enc_sdf_runs`), their launches counted from zero to the end of
    the runs; then phase ``encodings_kernels`` on the runs' own inputs
    (:func:`_variant_rows`: the three grid kernels at D = 2 and 3, Tiled and
    Simplex), the launches and seconds on one line, and a summary of the
    kernel rows."""
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    caps = _capture_jsons()
    test = load_nerf(caps[1])
    seconds, cases = {}, []
    reset_launches()
    for name, encoding in (("simplex", {"interpolation": "Simplex"}),
                           ("tiled", {"otype": "TiledGrid"})):
        t0 = time.perf_counter()
        cases += _enc_nerf_run(name, encoding, caps, test)
        seconds[f"nerf_{name}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cases += _enc_image_run()
    seconds["image"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cases += _enc_sdf_runs()
    seconds["sdf"] = time.perf_counter() - t0
    launches = launch_counts()
    t0 = time.perf_counter()
    rows = [row for case in cases for row in _variant_rows(*case)]
    seconds["encodings_kernels"] = time.perf_counter() - t0
    emit({"phase": "encodings_launches", "launches": launches, "seconds": seconds})
    keys = ("kernel", "shape", "D", "interpolation", "wrapping_levels", "N", "max_abs_err",
            "registers", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"phase": "encodings_kernel_rows",
          "rows": [{k: r.get(k) for k in keys} for r in rows]})
    for name in ENC_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"encodings: the runs launched {name} no time")


# the octree phases (ROADMAP A7b, A7c): the triangle octree, the Takikawa
# encoding and the native host builders on phase sdf's 327,680-triangle
# bumpy sphere at the sdf config's width
OCTREE_DEPTH = 10  # the octree of the runs; 8 Takikawa output levels from level 2
OCTREE_DEEP = 11  # the deepest octree allowed, built natively only
OCTREE_STEPS = 500
OCTREE_CALL_STEPS = 100
OCTREE_PROFILE_STEPS = 4
OCTREE_CLI_STEPS = 100
# the schema of tests/test_octree_takikawa.py:237-243 (the reference's
# configs/sdf/takikawa.json is not in the repository), its depth set by
# octree_depth (the CLI's file: n_levels = OCTREE_DEPTH)
OCTREE_TAKIKAWA = {"otype": "Takikawa", "n_levels": 5, "starting_level": 2,
                   "n_features_per_level": 2}
OCTREE_RUNS = (("takikawa", OCTREE_TAKIKAWA, {"octree_depth": OCTREE_DEPTH}),
               ("hash_octree", None, {"use_octree": True, "octree_depth": OCTREE_DEPTH}),
               ("hash_plain", None, {}))


def _octree_mesh() -> str:
    """The 327,680-triangle bumpy sphere's OBJ: phase sdf's, which the
    main lane wrote before this child, else written once into
    ``build/octree_smoke/``."""
    from ngp_tpu_torch.data.synthetic import write_bumpy_sphere_mesh

    os.makedirs(os.path.join(ROOT, "build", "octree_smoke"), exist_ok=True)
    for mesh in (os.path.join(ROOT, "build", "sdf_smoke", "bumpy_sphere.obj"),
                 os.path.join(ROOT, "build", "octree_smoke", "bumpy_sphere.obj")):
        if os.path.exists(mesh):
            return mesh
    return write_bumpy_sphere_mesh(mesh, SDF_SUBDIVISIONS)


def _octree_stats(a: dict) -> dict:
    return {"nodes_per_level": [len(c) for c in a["codes"]], "vertices": a["n_vertices"],
            "dt_depth": a["dt_depth"]}


def phase_octree_build(mesh_path: str) -> None:
    """The host builders on the bumpy sphere: the BVH by the C++ builder
    and by numpy, and the octree at ``OCTREE_DEPTH`` both ways, each pair
    array for array (gates: equal), with their seconds; the C++ octree at
    ``OCTREE_DEEP`` alone (the numpy build's candidate list would take
    gigabytes there). Each build runs alone in this process, before the
    timed runs."""
    import numpy as np

    from ngp_tpu_torch.geometry import triangle_bvh as bvh
    from ngp_tpu_torch.geometry import triangle_octree as octree
    from ngp_tpu_torch.geometry.mesh import load_mesh
    from ngp_tpu_torch.ops import host_build

    t0 = time.perf_counter()
    tris = load_mesh(mesh_path).triangles
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_build.library()
    compile_s = time.perf_counter() - t0

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    def equal(a: dict, b: dict) -> bool:
        for key, x in a.items():
            y = b[key]
            if isinstance(x, list):
                if len(x) != len(y) or not all(np.array_equal(u, v) and u.dtype == v.dtype
                                               for u, v in zip(x, y)):
                    return False
            elif not np.array_equal(np.asarray(x), np.asarray(y)):
                return False
        return True

    native_bvh, native_bvh_s = timed(bvh.build_bvh_arrays_native, tris)
    numpy_bvh, numpy_bvh_s = timed(bvh.build_bvh_arrays, tris)
    native_oct, native_oct_s = timed(octree.octree_arrays, tris, OCTREE_DEPTH)
    numpy_oct, numpy_oct_s = timed(octree.octree_arrays_numpy, tris, OCTREE_DEPTH)
    deep, deep_s = timed(octree.octree_arrays, tris, OCTREE_DEEP)
    result = {
        "phase": "octree_build", "triangles": int(tris.shape[0]), "mesh_load_s": load_s,
        "host_library_compile_s": compile_s, "host_threads": os.cpu_count(),
        "bvh": {"native_s": native_bvh_s, "numpy_s": numpy_bvh_s,
                "equal": equal(native_bvh, numpy_bvh),
                "nodes": len(native_bvh["node_a"]), "depth": native_bvh["depth"]},
        "octree": {"depth": OCTREE_DEPTH, "native_s": native_oct_s, "numpy_s": numpy_oct_s,
                   "equal": equal(native_oct, numpy_oct), **_octree_stats(native_oct)},
        "octree_deep": {"depth": OCTREE_DEEP, "native_s": deep_s, **_octree_stats(deep)},
    }
    emit(result)
    if not result["bvh"]["equal"]:
        raise AssertionError("the native and numpy BVH builds differ")
    if not result["octree"]["equal"]:
        raise AssertionError(f"the native and numpy octree builds differ at depth "
                             f"{OCTREE_DEPTH}")


def _octree_config(encoding: dict | None) -> dict:
    from ngp_tpu_torch.testbed import default_config

    cfg = default_config("sdf")
    if encoding is not None:
        cfg["encoding"] = dict(encoding)
    return cfg


def _octree_run(mesh_path: str, name: str, encoding: dict | None, kw: dict):
    """One run of phase ``octree_sdf``: ``Testbed`` on the mesh (its load,
    BVH and octree build seconds), the untrained IoU, ``OCTREE_STEPS``
    steps in calls of ``OCTREE_CALL_STEPS`` (ms a step, samples/s, losses),
    the IoU over 2^18 points, a 960×540 shade frame (wall and device ms,
    launches, the tracer's iterations: the longest ray's and the mean), the
    ground-truth frame of the same tracer (wall ms) and the two hit masks'
    IoU, and a snapshot reloaded to the same IoU; the seconds of each part.
    Returns (the Testbed, the run's readings, its gates' verdicts)."""
    import numpy as np
    import torch

    from ngp_tpu_torch.ops.cuda_build import launch_counts
    from ngp_tpu_torch.testbed import SDF_EYE, SDF_FOV_DEG, SDF_LOOKAT, Testbed

    seconds, t0 = {}, [time.perf_counter()]

    def lap(part: str):
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[part] = now - t0[0]
        t0[0] = now

    tb = Testbed(scene=mesh_path, config=_octree_config(encoding), **kw)
    lap("load")
    eng = tb.engine
    untrained = eng.calculate_iou(tb.state, SDF_IOU_SAMPLES)
    lap("untrained_iou")
    before = launch_counts()
    step_ms, losses = [], []
    for _ in range(OCTREE_STEPS // OCTREE_CALL_STEPS):
        t1 = time.perf_counter()
        tb.state, loss = eng.train(tb.state, OCTREE_CALL_STEPS)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3 / OCTREE_CALL_STEPS)
        losses.append(loss)
    train_launches = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
    losses = torch.cat(losses).cpu().numpy()
    median_ms = float(np.median(step_ms[1:]))
    lap("train")
    state = tb.state
    iou = eng.calculate_iou(state, SDF_IOU_SAMPLES)
    lap("iou")

    o, d = (torch.from_numpy(a).cuda() for a in
            eng.camera_rays(SDF_EYE, SDF_LOOKAT, SDF_FRAME, SDF_FOV_DEG))
    trace, steps = eng._trace, []

    def keep_steps(*args, **kwargs):
        out = trace(*args, **kwargs)
        steps.append(out[2])
        return out

    eng._trace = keep_steps
    try:
        hit, frame = _sdf_frame(eng, state, o, d, "shade")
    finally:
        del eng._trace
    frame["tracer_iterations"] = {"longest_ray": int(steps[0].max()),
                                  "mean": float(steps[0].float().mean())}
    gt_hit, gt_frame = _sdf_frame(eng, state, o, d, "shade", gt_bvh=True, profiled=False)
    hit_iou = float((hit & gt_hit).sum()) / max(float((hit | gt_hit).sum()), 1.0)
    lap("frames")

    snapshot = os.path.join(ROOT, "build", "octree_smoke", f"{name}.msgpack")
    t1 = time.perf_counter()
    tb.save_snapshot(snapshot)
    tb.load_snapshot(snapshot)
    snapshot_s = time.perf_counter() - t1
    iou_reloaded = eng.calculate_iou(tb.state, SDF_IOU_SAMPLES)
    lap("snapshot_and_iou")
    w = ENC_SDF_WINDOW
    oc = eng.octree
    run = {
        "config": tb.network_config["encoding"], **kw, "testbed_load_s": seconds["load"],
        "bvh_build_s": eng.bvh_build_s, "octree_build_s": eng.octree_build_s,
        "octree": None if oc is None else {"depth": oc.max_depth, "nodes": oc.n_nodes,
                                           "vertices": oc.n_vertices},
        "table": list(state.model.encoding.table.shape),
        "n_output_dims": state.model.encoding.n_output_dims,
        "steps": OCTREE_STEPS, "ms_per_step_by_call": step_ms,
        "median_ms_per_step": median_ms,
        "samples_per_s": eng.batch_size / (median_ms / 1e3),
        "loss_step0_last": [float(losses[0]), float(losses[-1])],
        "loss_window_means": [float(losses[:w].mean()), float(losses[-w:].mean())],
        "untrained_iou": untrained, "iou": iou, "iou_reloaded": iou_reloaded,
        "snapshot_s": snapshot_s, "frame": frame, "gt_frame": gt_frame,
        "model_gt_hit_iou": hit_iou, "train_launches": train_launches, "seconds": seconds,
    }
    gates = {
        "losses_finite": bool(np.isfinite(losses).all()),
        "loss_falls": run["loss_window_means"][1] < run["loss_window_means"][0],
        "iou_over_untrained": iou > untrained,
        "hit_iou": hit_iou >= SDF_HIT_IOU_MIN,
        "reload_same_iou": iou_reloaded == iou,
    }
    return tb, run, gates


def phase_octree_sdf(mesh_path: str):
    """The three runs of :data:`OCTREE_RUNS` through ``Testbed`` at the
    sdf config's width (its 64-wide MLP of 2 hidden layers, MAPE, the
    optimizer stack at Adam 1e-4, 2^18 samples a step): the Takikawa
    encoding over the octree at ``OCTREE_DEPTH``, the config's hash grid
    with ``use_octree`` at that depth, and the plain hash grid
    (:func:`_octree_run`). Gates for each: finite losses that fall (the
    last ``ENC_SDF_WINDOW`` steps' mean below the first's), the IoU above
    the untrained model's, the shade frame's hit mask within
    ``SDF_HIT_IOU_MIN`` IoU of the ground truth's, the reloaded snapshot's
    IoU the same; the Takikawa run launches ``segment_sum`` a step and the
    hash runs none. Returns the three Testbeds by name and the Takikawa
    run's median ms a step."""
    runs, kept = {}, {}
    failed = []
    for name, encoding, kw in OCTREE_RUNS:
        tb, run, gates = _octree_run(mesh_path, name, encoding, kw)
        runs[name] = {**run, "gates": gates}
        failed += [f"{name}: {gate}" for gate, ok in gates.items() if not ok]
        b2 = run["train_launches"].get("segment_sum", 0)
        if b2 != (OCTREE_STEPS if name == "takikawa" else 0):
            failed.append(f"{name}: segment_sum launched {b2} times in {OCTREE_STEPS} steps")
        kept[name] = tb
        del tb
    emit({"phase": "octree_sdf", "config": "Testbed sdf default; takikawa: the schema of "
          "tests/test_octree_takikawa.py:237-243", "runs": runs})
    if failed:
        raise AssertionError(f"octree_sdf gates failed: {failed}")
    return kept, runs["takikawa"]["median_ms_per_step"]


def _octree_frame_readers(tb) -> None:
    """The plain hash run's shade frame under one profiler window, its
    device ms read from the raw records (:func:`_busy_ms_raw`, which every
    child's frame ms uses) and from :func:`_profile_summary`'s event tree
    (gate: within 1e-3 of each other). Run after the path's launches are
    read."""
    import torch

    from ngp_tpu_torch.testbed import SDF_EYE, SDF_FOV_DEG, SDF_LOOKAT

    eng = tb.engine
    o, d = (torch.from_numpy(a).cuda() for a in
            eng.camera_rays(SDF_EYE, SDF_LOOKAT, SDF_FRAME, SDF_FOV_DEG))
    raw, tree = _frame_device_ms(lambda: eng.render_rays(tb.state, o, d, False, mode="shade"),
                                 event_tree=True)
    emit({"phase": "octree_frame_readers", "frame": "hash_plain shade",
          "device_ms_raw": raw, "device_ms_event_tree": tree})
    if abs(raw - tree) > 1e-3 * tree:
        raise AssertionError(f"frame device ms: raw records {raw}, event tree {tree}")


def phase_octree_kernels(taki_tb, hash_tb) -> None:
    """B2 (``segment_sum_cuda``) on one Takikawa step's own keys (1,
    levels·N·8) and addends against its twin within the float32 order
    bound, with its times, its bound (keys and addends read and the table
    written once at the card's rate), the ``index_add_`` yardstick on the
    same bf16-rounded addends and the keys' contention (the most addends
    on one row, the share on the coarsest level's rows); then B1 and the
    fused backward on one octree hash-grid step's own (x, g) against their
    twins (:func:`_kernel_case`, :func:`_backward_row`). Returns B2's row."""
    import torch

    from ngp_tpu_torch.ops import hashgrid as hashgrid_ops
    from ngp_tpu_torch.ops import segsum
    from ngp_tpu_torch.ops.hashgrid import hashgrid_backward_addends_reference

    eng = taki_tb.engine
    keys, vals, T = _keep_call(segsum, "segment_sum_cuda",
                               lambda: eng.train(taki_tb.state, 1))[:3]
    enc = taki_tb.state.model.encoding
    L, M, F = vals.shape
    got = segsum.segment_sum_cuda(keys, vals, T)
    torch.cuda.synchronize()
    err = _sum_error("segment_sum", got, segsum.segment_sum_reference(keys, vals, T),
                     keys, vals, T)
    del got
    counts = torch.bincount(keys[0].long(), minlength=T)
    coarsest = enc.octree.verts[enc.starting_level]
    k_long, rounded = keys[0].long(), vals[0].to(torch.bfloat16).float()
    b2 = lambda: segsum.segment_sum_cuda(keys, vals, T)  # noqa: E731
    row = {
        "N": M // (8 * enc.n_levels), "levels": enc.n_levels, "L": L, "M": M, "T": T, "F": F,
        "max_abs_err": err, "ms": device_ms(b2), "call_ms": cuda_ms(b2, iters=20),
        "plain_ms": cuda_ms(lambda: segsum.segment_sum_reference(keys, vals, T),
                            iters=3, warmup=1),
        "library_ms": device_ms(
            lambda: torch.zeros((T, F), device="cuda").index_add_(0, k_long, rounded)),
        "rows_touched": int((counts > 0).sum()), "max_row_addends": int(counts.max()),
        "coarsest_level_rows": int(coarsest.max() - coarsest.min() + 1),
        "coarsest_level_addend_share": float(
            counts[int(coarsest.min()):int(coarsest.max()) + 1].sum()) / M,
        # keys and addends read once, the dense table written once
        **_bound(L * M * (4 + 4 * F) + L * T * F * 4, L * M * F),
    }
    emit({"phase": "octree_kernels", "kernel": "segment_sum", "shape": "takikawa_step", **row})
    del keys, vals, k_long, rounded

    heng = hash_tb.engine
    x, g, scale, res, size, hashed, variant, _, n_rows = _keep_call(
        hashgrid_ops, "hashgrid_backward_cuda", lambda: heng.train(hash_tb.state, 1))[:9]
    geo = (scale, res, size, hashed, variant)
    henc = hash_tb.state.model.encoding
    hkeys, hvals = hashgrid_backward_addends_reference(x, g, *geo)
    HL = scale.shape[0]
    rows_read = int(torch.unique(hkeys.long() + torch.arange(HL, device="cuda")[:, None]
                                 * n_rows).numel())
    emit({"phase": "octree_kernels", "kernel": "hashgrid_encode", "shape": "octree_step",
          **_kernel_case("sdf", torch.float32, torch.Generator().manual_seed(13), x=x,
                         enc=henc, rows_read=rows_read)})
    emit({"phase": "octree_kernels", "kernel": "hashgrid_backward", "shape": "octree_step",
          "N": x.shape[0], **_backward_row(x, g, geo, n_rows, hkeys, hvals)})
    return row


def phase_octree_profile(tb, median_ms: float) -> None:
    """Two windows of ``OCTREE_PROFILE_STEPS`` Takikawa steps under
    torch.profiler, the backward on the calling thread: the device's busy
    share of a step and its device ms by stage (the data refresh, the
    octree lookups and weights, the blend, the MLP forward, the backward's
    MLP and the rest, the table gradient's addends, the segment sum, the
    optimizer)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ngp_tpu_torch.models import takikawa

    eng, trainer = tb.engine, tb.engine.trainer
    model = tb.state.model
    eng.training_batch = _ranged("refresh", eng.training_batch)
    trainer.loss = _ranged("forward", trainer.loss)
    trainer.apply_grads = _ranged("optimizer", trainer.apply_grads)
    model.encoding.gather_plan = _ranged("lookup", model.encoding.gather_plan)
    model.network.forward = _ranged("mlp_forward", model.network.forward)
    blend, segment_sum = takikawa._blend, takikawa.batched_segment_sum
    takikawa._blend = _ranged("blend", blend)
    takikawa.batched_segment_sum = _ranged("segment_sum", segment_sum)
    table_bwd = takikawa._GatherBlend.backward
    takikawa._GatherBlend.backward = staticmethod(_ranged("table_backward", table_bwd))
    tensor_backward = torch.Tensor.backward
    torch.Tensor.backward = _ranged("backward", tensor_backward)
    n = OCTREE_PROFILE_STEPS
    try:
        for window in range(2):
            first = tb.state.step
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
                    torch.autograd.set_multithreading_enabled(False):
                _lead_in()
                t0 = time.perf_counter()
                with record_function("steps"):
                    tb.state, _ = eng.train(tb.state, n)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            summary = _profile_summary(
                prof, ("refresh", "forward", "lookup", "blend", "mlp_forward", "backward",
                       "table_backward", "segment_sum", "optimizer"), "steps",
                "permute_and_other")
            busy_ms = summary["device_busy_ms"] / n
            emit({"phase": "octree_profile", "window": window,
                  "steps": [first, tb.state.step - 1],
                  "wall_ms_per_step": wall_ms / n, "device_busy_ms_per_step": busy_ms,
                  "busy_share_of_profiled_wall": busy_ms / (wall_ms / n),
                  "busy_share_of_unprofiled_median": busy_ms / median_ms,
                  "device_ops_per_step": summary["device_ops"] / n,
                  "stage_device_ms_per_step": {k: v / n for k, v in
                                               summary["stage_device_ms"].items()},
                  "top_device_ms": summary["top_device_ms"]})
    finally:
        torch.Tensor.backward = tensor_backward
        takikawa._GatherBlend.backward = staticmethod(table_bwd)
        takikawa._blend, takikawa.batched_segment_sum = blend, segment_sum
        del eng.training_batch, trainer.loss, trainer.apply_grads
        del model.encoding.gather_plan, model.network.forward


def phase_octree_cli(mesh_path: str) -> dict:
    """``python -m ngp_tpu_torch.run`` on the mesh with a written Takikawa
    ``--network`` file (the sdf config with :data:`OCTREE_TAKIKAWA` at
    ``n_levels`` = ``OCTREE_DEPTH``) in fresh processes:
    ``OCTREE_CLI_STEPS`` steps with a snapshot, which must print ``IoU:``,
    then the snapshot loaded with no steps, which must print the same IoU
    line. Returns the two runs' kernel launches, summed."""
    out = os.path.join(ROOT, "build", "octree_smoke")
    network = os.path.join(out, "takikawa.json")
    with open(network, "w") as f:
        json.dump(_octree_config(dict(OCTREE_TAKIKAWA, n_levels=OCTREE_DEPTH)), f)
    snapshot = os.path.join(out, "cli.msgpack")
    run1 = _cli([mesh_path, "--mode", "sdf", "--network", network, "--n_steps",
                 str(OCTREE_CLI_STEPS), "--save_snapshot", snapshot])
    run2 = _cli([mesh_path, "--mode", "sdf", "--network", network, "--n_steps", "0",
                 "--load_snapshot", snapshot])
    iou1, iou2 = _cli_line(run1, "IoU:")[1], _cli_line(run2, "IoU:")[1]
    runs = (run1, run2)
    result = {
        "phase": "octree_cli", "steps": OCTREE_CLI_STEPS, "network": network,
        "trained": _cli_line(run1, "trained ")[1], "iou_line": iou1,
        "reloaded_iou_line": iou2, "run_s": [r[-1][0] for r in runs],
        "launches": {k: sum(_cli_launches(r)[k] for r in runs) for k in _cli_launches(run1)},
    }
    emit(result)
    if iou2 != iou1:
        raise AssertionError(f"reloaded {iou2!r}, saved {iou1!r}")
    if _cli_launches(run1)["segment_sum"] != OCTREE_CLI_STEPS:
        raise AssertionError(f"the Takikawa CLI launched segment_sum "
                             f"{_cli_launches(run1)['segment_sum']} times")
    return result["launches"]


def phase_octree_all():
    """``chip_smoke.py octree``: phases octree_build, octree_sdf (its
    launches counted from zero), octree_frame_readers, octree_kernels,
    octree_profile and octree_cli; then the path's
    launches (the runs and the CLI) and the phases' seconds on one line.
    The kernels' libraries are the main process's (phase build), or built
    at first use when the child runs alone."""
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    seconds, t0 = {}, time.perf_counter()

    def lap(name: str):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    phase_env()
    mesh_path = _octree_mesh()
    lap("env_mesh")
    phase_octree_build(mesh_path)
    lap("octree_build")
    reset_launches()
    tbs, median_ms = phase_octree_sdf(mesh_path)
    launches = launch_counts()
    lap("octree_sdf")
    _octree_frame_readers(tbs.pop("hash_plain"))
    lap("octree_frame_readers")
    taki_tb = tbs.pop("takikawa")
    phase_octree_kernels(taki_tb, tbs.pop("hash_octree"))
    lap("octree_kernels")
    phase_octree_profile(taki_tb, median_ms)
    del taki_tb
    lap("octree_profile")
    cli = phase_octree_cli(mesh_path)
    lap("octree_cli")
    emit({"phase": "octree_launches", "launches": {k: launches[k] + cli[k] for k in launches},
          "seconds": seconds})


# the JPEG phases (ROADMAP A2, A15): the committed JPEG capture of
# tests/fixtures/jpeg (phase capture's 800×800 frames over black, written
# by PIL as 4:2:0 quality-90 JPEGs; make_fixtures.py) read by the port's
# C++ decoder on a host without PIL, trained on, and converted again from
# a COLMAP text model of its poses
JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")
JPEG_STEPS = CAPTURE_STEPS
# CAPTURE_PSNR_MIN less 5 dB: the frames carry no alpha, and the
# background is trained as the black it is
JPEG_PSNR_MIN = CAPTURE_PSNR_MIN - 5.0
JPEG_DECODE_REPEATS = 5
JPEG_POSE_TOL = 1e-5


def _jpeg_files(manifest: dict, prefix: str = "") -> list:
    return [os.path.join(JPEG_FIXTURES, rel) for rel in sorted(manifest["rgba_sha256"])
            if rel.startswith(prefix)]


def _host_cpu() -> str:
    """The host CPU's model name (or its architecture, where /proc/cpuinfo
    names no model) and the cores this process may use."""
    import platform

    name = platform.machine() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            name = next(line.split(":", 1)[1].strip() for line in f
                        if line.startswith("model name"))
    except (OSError, StopIteration):
        pass
    return f"{name}, {len(os.sched_getaffinity(0))} cores"


def phase_jpeg_decode(manifest: dict) -> None:
    """Every fixture decoded (RGBA) against the manifest's sha256 of PIL's
    decode (gate: all equal); then the decoder's rate on the host over the
    capture's 28 frames, on one thread and on one a core (the files read
    once, decode only, the median of ``JPEG_DECODE_REPEATS``), and
    ``read_jpegs_rgba`` with its file reads beside ``read_pngs_rgba`` on
    phase capture's PNG frames of the same views where they exist."""
    import hashlib

    import numpy as np

    from ngp_tpu_torch.data.jpeg import read_jpegs_rgba
    from ngp_tpu_torch.ops import host_build

    t0 = time.perf_counter()
    host_build.library()
    build_s = time.perf_counter() - t0
    paths = _jpeg_files(manifest)
    got = read_jpegs_rgba(paths)
    digests = {os.path.relpath(p, JPEG_FIXTURES): hashlib.sha256(img.tobytes()).hexdigest()
               for p, img in zip(paths, got)}
    wrong = sorted(rel for rel, d in digests.items() if d != manifest["rgba_sha256"][rel])
    capture = _jpeg_files(manifest, "capture/")
    datas = [open(p, "rb").read() for p in capture]
    pixels = sum(h * w for h, w, _ in (img.shape for img in read_jpegs_rgba(capture)))
    cores = len(os.sched_getaffinity(0))
    rates = {}
    for threads in (1, cores):
        times = []
        for _ in range(JPEG_DECODE_REPEATS):
            t0 = time.perf_counter()
            host_build.jpeg_decode(datas, rgba=True, n_threads=threads)
            times.append(time.perf_counter() - t0)
        rates[threads] = pixels / 1e6 / float(np.median(times))
    times = []
    for _ in range(JPEG_DECODE_REPEATS):
        t0 = time.perf_counter()
        read_jpegs_rgba(capture)
        times.append(time.perf_counter() - t0)
    read_s = float(np.median(times))
    # phase capture's PNG frames of the same views, where the main process
    # wrote them (absent when the child runs alone)
    png_dir = os.path.join(ROOT, "build", "capture_smoke")
    png = [os.path.join(png_dir, rel[len("capture/"):-len(".jpg")] + ".png")
           for rel in sorted(manifest["rgba_sha256"]) if rel.startswith("capture/")]
    png_s = None
    if all(os.path.exists(p) for p in png):
        from ngp_tpu_torch.data.png import read_pngs_rgba

        t0 = time.perf_counter()
        read_pngs_rgba(png)
        png_s = (time.perf_counter() - t0) / len(png)
    emit({"phase": "jpeg_decode", "host_cpu": _host_cpu(), "library_build_s": build_s,
          "files": len(paths), "sha256_equal": len(paths) - len(wrong), "sha256_wrong": wrong,
          "capture_frames": len(capture), "capture_megapixels": pixels / 1e6,
          "capture_bytes": sum(len(d) for d in datas),
          "mp_per_s_1_thread": rates[1], "mp_per_s_all_threads": rates[cores],
          "threads": cores, "read_jpegs_rgba_s": read_s,
          "read_s_per_frame": read_s / len(capture), "png_read_s_per_frame": png_s,
          "timing": "host wall clock, files warm"})
    if wrong:
        raise AssertionError(f"jpeg: {len(wrong)} fixtures decode unlike PIL: {wrong[:4]}")


def phase_jpeg_train():
    """``load_nerf`` on the JPEG capture, ``JPEG_STEPS`` steps of the
    full-width "tpu" tier with 2^18 sample slots, as phase capture trains
    its PNG capture but against the capture's black background, then the
    held-out eval (gate: ``JPEG_PSNR_MIN``); B1
    and the fused backward launched in training and B1 in the eval. Returns
    the train dataset and the launches."""
    import numpy as np
    import torch

    from ngp_tpu_torch.config import default_config
    from ngp_tpu_torch.data.nerf_loader import load_nerf
    from ngp_tpu_torch.engines.nerf import NerfEngine
    from ngp_tpu_torch.ops.cuda_build import launch_counts, reset_launches

    cap = os.path.join(JPEG_FIXTURES, "capture")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ds = load_nerf(os.path.join(cap, "transforms_train.json"))
    test = load_nerf(os.path.join(cap, "transforms_test.json"))
    load_s = time.perf_counter() - t0
    if ds.images.shape != (24, CAPTURE_RES, CAPTURE_RES, 4) or test.n_images != 4:
        raise AssertionError(f"jpeg load_nerf: frames {ds.images.shape}, {test.images.shape}")
    # the capture's background is opaque black: it trains against that
    # black (instant-ngp's random training background off), as its users
    # set it; with random backgrounds the model must fill the box with
    # black density, and 400 steps read 10.7 dB held out (PERF.md §6)
    eng = NerfEngine(default_config("tpu"), ds, batch_size=1 << 18,
                     background_color=(0.0, 0.0, 0.0), train_with_random_bg=False)
    state, grid = eng.init_state(), eng.init_grid()
    torch.cuda.synchronize()
    step_ms = []
    t_train = time.perf_counter()
    for _ in range(JPEG_STEPS):
        t0 = time.perf_counter()
        state, grid, metrics = eng.train(state, grid, 1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_s = time.perf_counter() - t_train
    train_launches = launch_counts()
    t0 = time.perf_counter()
    scores = eng.eval_test_transforms(state, grid, test)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = launch_counts()
    eval_launches = {k: n - train_launches[k] for k, n in launches.items()}
    emit({"phase": "jpeg_train", "train_views": ds.n_images, "test_views": test.n_images,
          "load_s": load_s, "load_s_per_image": load_s / (ds.n_images + test.n_images),
          "steps": JPEG_STEPS, "train_s": train_s,
          "median_ms_per_step": float(np.median(step_ms[256:])),
          "final_loss": float(metrics["loss"]), "psnr": scores["psnr"],
          "min_psnr": scores["min_psnr"], "ssim": scores["ssim"], "psnr_gate": JPEG_PSNR_MIN,
          "eval_ms_per_view": eval_s * 1e3 / scores["n_views"],
          "train_launches": {k: v for k, v in train_launches.items() if v},
          "eval_launches": {k: v for k, v in eval_launches.items() if v},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not scores["psnr"] >= JPEG_PSNR_MIN:
        raise AssertionError(f"jpeg: held-out PSNR {scores['psnr']} dB after {JPEG_STEPS} "
                             f"steps < {JPEG_PSNR_MIN}")
    for name in ("hashgrid_encode", "hashgrid_backward"):
        if train_launches[name] == 0:
            raise AssertionError(f"jpeg: training launched {name} no time")
    if eval_launches["hashgrid_encode"] == 0:
        raise AssertionError("jpeg: the held-out eval launched hashgrid_encode no time")
    return ds, launches


def _rotmat_to_qvec(r):
    """(w, x, y, z) of a rotation matrix, by its largest-diagonal branch."""
    tr = r[0, 0] + r[1, 1] + r[2, 2]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        return (s / 4, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                (r[1, 0] - r[0, 1]) / s)
    i = max(range(3), key=lambda a: r[a, a])
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(0.0, 1.0 + r[i, i] - r[j, j] - r[k, k])) * 2
    q = [(r[k, j] - r[j, k]) / s, 0.0, 0.0, 0.0]
    q[1 + i], q[1 + j], q[1 + k] = s / 4, (r[j, i] + r[i, j]) / s, (r[k, i] + r[i, k]) / s
    return tuple(q)


def phase_jpeg_convert(manifest: dict, ds) -> None:
    """A COLMAP text model (OPENCV with the capture's intrinsics; each
    train frame's pose as COLMAP's world-to-camera quaternion and
    translation) written from the capture's poses, converted by ``python -m
    ngp_tpu_torch.scripts.colmap2nerf --keep_colmap_coords`` with
    sharpness on (gates: every pose within ``JPEG_POSE_TOL`` of the
    capture's, every sharpness the manifest's exactly), then loaded by
    ``load_nerf`` (gate: the same frames, poses within the tolerance)."""
    import shutil

    import numpy as np

    from ngp_tpu_torch.data.nerf_loader import load_nerf

    work = os.path.join(ROOT, "build", "jpeg_smoke")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(os.path.join(JPEG_FIXTURES, "capture"), work)
    meta = json.load(open(os.path.join(work, "transforms_train.json")))
    os.makedirs(os.path.join(work, "colmap_text"))
    with open(os.path.join(work, "colmap_text", "cameras.txt"), "w") as f:
        f.write("# the capture's camera\n1 OPENCV {w} {h} {fl_x!r} {fl_y!r} {cx!r} {cy!r} "
                "{k1!r} {k2!r} {p1!r} {p2!r}\n".format(**meta))
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    lines, names = ["# the capture's poses"], []
    for i, fr in enumerate(meta["frames"]):
        w2c = np.linalg.inv(np.asarray(fr["transform_matrix"]) @ flip)
        q, t = _rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3]
        names.append(os.path.basename(fr["file_path"]))
        lines += [" ".join([str(i + 1), *map(repr, map(float, q)), *map(repr, map(float, t)),
                            "1", names[-1]]), "0 0 -1"]
    with open(os.path.join(work, "colmap_text", "images.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ngp_tpu_torch.scripts.colmap2nerf", "--images", "train",
         "--text", "colmap_text", "--keep_colmap_coords", "--aabb_scale", "2",
         "--out", "transforms_colmap.json"],
        cwd=work, env={**os.environ, "PYTHONPATH": ROOT}, capture_output=True, text=True)
    convert_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"colmap2nerf exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.load(open(os.path.join(work, "transforms_colmap.json")))
    pose_err = max(float(np.abs(np.asarray(o["transform_matrix"])
                                - np.asarray(fr["transform_matrix"])).max())
                   for o, fr in zip(out["frames"], meta["frames"]))
    sharp = {f"capture/train/{n}": o.get("sharpness") for n, o in zip(names, out["frames"])}
    sharp_wrong = sorted(k for k, v in sharp.items() if v != manifest["sharpness"][k])
    t0 = time.perf_counter()
    conv = load_nerf(os.path.join(work, "transforms_colmap.json"))
    load_s = time.perf_counter() - t0
    same_frames = conv.images.shape == ds.images.shape and np.array_equal(conv.images, ds.images)
    xform_err = float(np.abs(conv.xforms - ds.xforms).max())
    emit({"phase": "jpeg_convert", "frames": len(out["frames"]), "convert_s": convert_s,
          "max_pose_err": pose_err, "pose_tol": JPEG_POSE_TOL,
          "sharpness_equal": len(sharp) - len(sharp_wrong), "sharpness_wrong": sharp_wrong,
          "load_s": load_s, "same_frames": bool(same_frames), "max_xform_err": xform_err,
          "lens": [conv.lens.mode, list(conv.lens.params)]})
    if len(out["frames"]) != len(meta["frames"]) or not pose_err <= JPEG_POSE_TOL:
        raise AssertionError(f"colmap2nerf: {len(out['frames'])} frames, pose error {pose_err}")
    if sharp_wrong:
        raise AssertionError(f"colmap2nerf: sharpness unlike the manifest's: {sharp_wrong[:4]}")
    if not same_frames or not xform_err <= JPEG_POSE_TOL:
        raise AssertionError(f"load_nerf of the conversion: frames equal {same_frames}, "
                             f"pose error {xform_err}")


JPEG_CLI_STEPS = 100


def phase_jpeg_cli() -> dict:
    """``python -m ngp_tpu_torch.run`` (``Testbed``'s default base.json
    config) on phase ``jpeg_convert``'s COLMAP-converted capture of JPEG
    frames, ``JPEG_CLI_STEPS`` steps, scored on the capture's held-out
    views (gates: B1 and the fused backward launched, a finite PSNR; none
    on its value: the CLI trains on random backgrounds, which this
    capture's opaque black defeats in few steps). Returns its launches."""
    work = os.path.join(ROOT, "build", "jpeg_smoke")
    t0 = time.perf_counter()
    lines = _cli([os.path.join(work, "transforms_colmap.json"), "--n_steps",
                  str(JPEG_CLI_STEPS), "--test_transforms",
                  os.path.join(work, "transforms_test.json")])
    launches = _cli_launches(lines)
    scores = _cli_scores(lines)
    emit({"phase": "jpeg_cli", "steps": JPEG_CLI_STEPS, "seconds": time.perf_counter() - t0,
          **scores, "launches": {k: v for k, v in launches.items() if v}})
    for name in ("hashgrid_encode", "hashgrid_backward"):
        if launches[name] == 0:
            raise AssertionError(f"jpeg cli: the run launched {name} no time")
    if not math.isfinite(scores["psnr"]):
        raise AssertionError(f"jpeg cli: held-out PSNR {scores['psnr']}")
    return launches


def phase_jpeg_all():
    """``chip_smoke.py jpeg``: ROADMAP A2 and A15 on the committed JPEG
    capture (:func:`phase_jpeg_decode`, :func:`phase_jpeg_train`,
    :func:`phase_jpeg_convert`, :func:`phase_jpeg_cli`), the launches
    counted from zero over the training, the eval and the CLI, and each
    part's seconds."""
    manifest = json.load(open(os.path.join(JPEG_FIXTURES, "manifest.json")))
    seconds = {}
    t0 = time.perf_counter()
    phase_jpeg_decode(manifest)
    seconds["decode"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds, launches = phase_jpeg_train()
    seconds["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_jpeg_convert(manifest, ds)
    seconds["convert"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli = phase_jpeg_cli()
    seconds["cli"] = time.perf_counter() - t0
    emit({"phase": "jpeg_launches", "launches": {k: launches[k] + cli[k] for k in launches},
          "seconds": seconds})


PROBE_WINDOWS = 80


def phase_profiler_probe():
    """``chip_smoke.py profiler_probe``: ``PROBE_WINDOWS`` profiler windows
    of :func:`device_ms` (one window each, no retry) on B1 ("tpu" tier,
    2^20 uniform positions, bf16 table) and as many on the render walk
    (the ground-truth walk of 2^19 rays through the 128³ procedural cloud):
    how many windows held every record in the annotation's span, how many
    lost records to the span only (``profiler_span_short``: the window
    held them), and how many lost them from the window itself (the
    profiler's own loss). One JSON line a kernel."""
    import torch

    from ngp_tpu_torch.data.volume import procedural_cloud
    from ngp_tpu_torch.ops.hashgrid import hashgrid_encode_cuda
    from ngp_tpu_torch.ops.volume_walk import WalkVolume, volume_render_walk_cuda

    enc = _encoding("tpu")
    x = torch.rand((N_KERNEL, 3), generator=torch.Generator().manual_seed(2)).cuda()
    table = enc.table.detach().to(torch.bfloat16)
    geo = (enc.level_scale, enc.level_res, enc.level_size, enc.level_hashed, enc.hash_variant)
    walk = WalkVolume.of(procedural_cloud(128), 0.01, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    pos = torch.rand((1 << 19, 3), generator=gen, device="cuda") * 0.5 + 0.25
    dirs = torch.nn.functional.normalize(torch.randn((1 << 19, 3), generator=gen,
                                                     device="cuda"), dim=-1)
    alive = torch.ones((1 << 19,), dtype=torch.bool, device="cuda")
    seen = []
    global emit
    printing = emit
    emit = seen.append
    try:
        for name, fn in (("hashgrid_encode", lambda: hashgrid_encode_cuda(x, table, *geo)),
                         ("volume_render_walk",
                          lambda: volume_render_walk_cuda(walk, pos, dirs, alive, 1, True))):
            counts = {"whole": 0, "span_short": 0, "window_short": 0}
            for _ in range(PROBE_WINDOWS):
                before = len(seen)
                try:
                    device_ms(fn, windows=1, fallback=False)
                except AssertionError:
                    counts["window_short"] += 1
                    continue
                short = [e for e in seen[before:] if e["phase"] == "profiler_span_short"]
                counts["span_short" if short else "whole"] += 1
            span_lines = [e for e in seen if e["phase"] == "profiler_span_short"]
            printing({"phase": "profiler_probe", "kernel": name, "windows": PROBE_WINDOWS,
                      **counts, "span_short_examples": span_lines[:3]})
            seen.clear()
    finally:
        emit = printing


def main():
    seconds, lap_t0 = {}, [time.perf_counter()]

    def lap(name: str):
        """The wall seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        seconds[name] = now - lap_t0[0]
        lap_t0[0] = now

    phase_env()
    import torch

    phase_build()
    lap("env_build")
    phase_kernel()
    sort_row = phase_kernel_sort()
    phase_golden()
    lap("kernel_sort_golden")
    frames, launches, x_serve = phase_serve()
    lap("serve")

    # B1 at the serve path's shape: "tpu" tier, bf16 table reads, as many
    # uniform samples as the path's launches averaged; then on the positions
    # of the frame's largest launch, whose neighbours lie near in space
    n_main = sum(f["samples"] for f in frames) // launches["hashgrid_encode"]
    main_case = _kernel_case("tpu", torch.bfloat16, torch.Generator().manual_seed(1),
                             n_main)
    emit({"phase": "kernel_main_path", **main_case})
    emit({"phase": "kernel_serve_positions",
          **_kernel_case("tpu", torch.bfloat16, torch.Generator().manual_seed(1),
                         x=x_serve)})
    del x_serve
    lap("kernel_serve")

    eng, state, grid, train_launches, train, step_inputs = phase_train()
    lap("train")
    # the kernels at the path's mean network samples per step on uniform
    # positions (the kernels line), at the step's full sample budget, and on
    # the kept step's own positions and cotangents
    train_rows = phase_kernel_train(
        "main_path", *train_inputs(int(train["network_samples_per_step"])))
    phase_kernel_train("full_budget", *train_inputs(eng.samples_per_step))
    phase_kernel_train("captured_step", *step_inputs)
    del step_inputs
    lap("kernel_train")
    # before train_profile, after whose windows the profiler loses records
    normals_launches, input_grad_row = phase_normals(eng, state, grid)
    lap("normals")
    phase_train_profile(eng, state, grid, train["median_ms_per_step"])
    lap("train_profile")
    del eng, state, grid
    capture_launches = phase_capture()
    lap("capture")
    # the NeRF children (host-bound, the card mostly idle) in a second lane
    # beside the main lane's CLI, image, sdf and volume paths; about as
    # long as it
    torch.cuda.empty_cache()  # the lanes' processes share the card's memory
    lane = ChildLane(("supervision", "camera", "nerf_surface", "encodings", "jpeg"))
    lane.start()
    try:
        cli_launches = phase_cli()
        lap("cli")
        image_launches = next(line for line in _child("image")
                              if line.get("phase") == "image")["launches"]
        lap("image")
        image_cli_launches = phase_image_cli()
        lap("image_cli")
        sdf_lines = _child("sdf")
        lap("sdf")
        volume_lines = _child("volume")
        lap("volume")
        octree_lines = _child("octree")
        lap("octree")
        lane.join()
        lap("second_lane_wait")
    finally:
        lane.stop()
    if lane.error is not None:
        raise lane.error
    seconds["second_lane"] = lane.seconds
    sdf_rows = {line["kernel"]: line for line in sdf_lines if line.get("phase") == "sdf_kernels"}
    sdf_launches = next(line for line in sdf_lines
                        if line.get("phase") == "sdf_launches")["launches"]
    volume_rows = {(line["kernel"], line["shape"]): line for line in volume_lines
                   if line.get("phase") == "volume_kernels"}
    volume_launches = next(line for line in volume_lines
                           if line.get("phase") == "volume_launches")["launches"]
    octree_launches = next(line for line in octree_lines
                           if line.get("phase") == "octree_launches")["launches"]
    # B2's row: on its path's own input, a Takikawa step's keys and addends
    train_rows["segment_sum"] = next(
        line for line in octree_lines
        if line.get("phase") == "octree_kernels" and line["kernel"] == "segment_sum")

    def lane_launches(child: str, phase: str) -> dict:
        return next(line for line in lane.lines[child] if line.get("phase") == phase)["launches"]

    camera_launches = lane_launches("camera", "camera_launches")
    supervision_launches = lane_launches("supervision", "supervision_launches")
    surface_launches = lane_launches("nerf_surface", "nerf_surface_launches")
    encodings_launches = lane_launches("encodings", "encodings_launches")
    jpeg_launches = lane_launches("jpeg", "jpeg_launches")
    emit({"phase": "seconds", "main": seconds,
          "total": sum(v for k, v in seconds.items() if k != "second_lane")})
    later = {k: cli_launches[k] + image_launches[k] + image_cli_launches[k] + sdf_launches[k]
             + volume_launches[k] + camera_launches[k] + supervision_launches[k]
             + surface_launches[k] + encodings_launches[k] + octree_launches[k]
             + jpeg_launches[k] for k in cli_launches}

    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def fields(row):
        """The kernels line's keys of ``row``, with its times' sources
        where the row names them (CUDA events rather than the profiler)."""
        return {**{k: row[k] for k in keys},
                **{k: row[k] for k in ("ms_source", "library_ms_source") if k in row}}

    kernels = [{
        "name": "hashgrid_encode_cuda", "route": "cuda",
        "source": "ngp_tpu_torch/csrc/hashgrid_encode.cu",
        "replaces": "ngp_tpu/ops/pallas/hashgrid.py:66",
        "launches": (launches["hashgrid_encode"] + train_launches["hashgrid_encode"]
                     + capture_launches["hashgrid_encode"] + later["hashgrid_encode"]),
        **fields(main_case),
    }]
    for name, source, replaces, launched in (
        ("hashgrid_backward", "hashgrid_encode.cu",
         "ngp_tpu/models/encodings.py:378", train_launches["hashgrid_backward"]),
        # B2: the Takikawa table gradient (phase octree); on the grid paths
        # the fused backward does its work
        ("segment_sum", "segment_sum.cu", "ngp_tpu/ops/pallas/segsum_sorted.py:67",
         train_launches["segment_sum"]),
        ("segment_count", "segment_sum.cu", "ngp_tpu/ops/pallas/segsum.py:135",
         train_launches["segment_count"]),
        # B4's entry points run the two kernels above with one level and
        # count their launches under their own names; the main path (like
        # the JAX package's, _MXU_DIRECT_MAX_T = 0) does not call them
        ("segment_sum_onehot", "segment_sum.cu", "ngp_tpu/ops/pallas/segsum.py:47",
         train_launches["segment_sum_onehot"]),
        ("segment_count_onehot", "segment_sum.cu", "ngp_tpu/ops/pallas/segsum.py:47",
         train_launches["segment_count_onehot"]),
    ):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"ngp_tpu_torch/csrc/{source}",
                        "replaces": replaces,
                        "launches": launched + capture_launches[name] + later[name],
                        **fields(train_rows[name])})
    # the position gradient has no TPU kernel: the JAX package runs XLA
    # autodiff of its differentiable gather (ngp_tpu/models/encodings.py:824)
    kernels.append({"name": "hashgrid_input_grad", "route": "cuda",
                    "source": "ngp_tpu_torch/csrc/hashgrid_encode.cu",
                    "replaces": "ngp_tpu/models/encodings.py:824",
                    "launches": normals_launches["hashgrid_input_grad"]
                    + later["hashgrid_input_grad"],
                    **fields(input_grad_row)})
    # B5 is on no path of either package (ngp_tpu/ops/pallas/sort.py:24-31):
    # its launches on the serve, train and capture paths are counted all the same
    kernels.append({"name": "bitonic_sort_pos", "route": "cuda",
                    "source": "ngp_tpu_torch/csrc/bitonic_sort.cu",
                    "replaces": "ngp_tpu/ops/pallas/sort.py:77",
                    "launches": launches["bitonic_sort_pos"]
                    + train_launches["bitonic_sort_pos"]
                    + capture_launches["bitonic_sort_pos"]
                    + later["bitonic_sort_pos"],
                    **fields(sort_row)})
    # the BVH traversals have no TPU kernel: the JAX package runs them as
    # lax.while_loops; their rows come from phase sdf_kernels
    for name, line in (("bvh_closest_point", 190), ("bvh_ray_intersect", 291)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "ngp_tpu_torch/csrc/triangle_bvh.cu",
                        "replaces": f"ngp_tpu/geometry/triangle_bvh.py:{line}",
                        "launches": later[name], **fields(sdf_rows[name])})
    # the delta-tracking walks have no TPU kernel: the JAX package runs them
    # as lax.fori_loops; their rows come from phase volume_kernels (the
    # render walk's on the ground-truth frame's rays)
    for name, shape, line in (("volume_train_walk", "step_episodes", 182),
                              ("volume_render_walk", "gt_frame_rays", 288)):
        kernels.append({"name": name, "route": "cuda",
                        "source": "ngp_tpu_torch/csrc/volume_walk.cu",
                        "replaces": f"ngp_tpu/engines/volume.py:{line}",
                        "launches": later[name],
                        **fields(volume_rows[(name, shape)])})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:] == ["cli_checks"]:
        phase_cli_checks()
    elif sys.argv[1:] == ["image"]:
        phase_image()
    elif sys.argv[1:] == ["sdf"]:
        phase_sdf_all()
    elif sys.argv[1:] == ["volume"]:
        phase_volume_all()
    elif sys.argv[1:] == ["camera"]:
        phase_camera_all()
    elif sys.argv[1:] == ["supervision"]:
        phase_supervision_all()
    elif sys.argv[1:] == ["nerf_surface"]:
        phase_nerf_surface_all()
    elif sys.argv[1:] == ["encodings"]:
        phase_encodings_all()
    elif sys.argv[1:] == ["octree"]:
        phase_octree_all()
    elif sys.argv[1:] == ["jpeg"]:
        phase_jpeg_all()
    elif sys.argv[1:] == ["encodings_control"]:
        phase_encodings_control()
    elif sys.argv[1:] == ["profiler_probe"]:
        phase_env()
        phase_profiler_probe()
    else:
        main()
