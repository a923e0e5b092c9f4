"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: builds the CUDA
kernels, holds each against its plain PyTorch version at its path's shapes,
then drives the port's paths through those kernels and checks their output:

  * full-body batched marker IK at B = 2048 (LM 5 + 6 compacted on the worst
    128): kernels K1 (FK by binary lifting, held against its plain version
    at B = 2048 and at the clip's B = 32) and K2+K3 (damped Cholesky in
    32-wide panels), the latter held against its plain version and timed
    against cholesky_ex + cholesky_solve at the paths' batch sizes 2048, 128
    and 1024, and K6 (the position rows' model-space Jacobian), held
    against its plain version at the IK cell's B = 65536 on the CMU rig and
    at B = 2048 on the full-body rig (column-tiled), and K6's projection
    form (camera projection rows' model-space Jacobian), held against its
    plain version at the multi-view cell's B = 16384 (31 cameras) and at
    config 6k's shape, its launches counted on one call of the cell's path;
  * the shadowed render of a posed 32-frame clip at 640×480, 2×2
    supersampled (benchmarks/bench_suite.py config 7): K1, and K4b (binned
    plane rasterizer) for the camera and shadow-map passes of every frame,
    held against its plain version on passes with and without overflow
    tiles (frames 0, 5, 11), with each frame's overflow tiles and the
    device time of the clip's 64 launches;
  * the shadowed render of a mesh under the bin capacity (the clip's first
    120 faces): K4a (plane rasterizer, every face tested once per tile and
    scanned only where it may cover the tile), held against its plain
    version on that render's camera and shadow passes and on the clip's
    612-face camera pass unbinned;
  * K5's entry points (ops/chol_pallas.py), fed the full residual stack's
    normal equations at B = 2048 padded to n = 160: K5a and K5b (32-wide
    panels, n % 32 == 0), both reaching K2+K3's kernel;
  * bench.py's full residual stack (position + orientation + limits + pose
    prior) at B = 2048, Gauss-Newton 2 + 1 on the worst 1024: K1, K2+K3;
  * the repaired faults: the damped solve past the kernel's shared memory,
    with matrix right-hand sides and in float64 (ROADMAP F7), gradients
    through K1 (F8) and K4b's merge scratch grown after a launch on another
    stream (F9);
  * benchmarks/bench_suite.py config 2 on the full stack by Levenberg-
    Marquardt on the normal equations: the single frame (one system, K2+K3
    at B = 1), and 2b, the GN 2 + 1 solve at B = 2048 scored against each
    element's 40-iteration LM optimum (conv_at_1e5), at B = 256 too: K1,
    K2+K3;
  * config 4, the skinned-mesh fit of pose and 8 blend-shape coefficients
    to 306 vertices (P = 165): 4b at B = 256 (GN 4 + 2 on the worst 64) and
    the single frame by LM: K1, and K2+K3 at n = 165 (held against its
    plain version and timed at B = 256);
  * config 5 and 5f, the sequence solve of F = 1024 frames on the 16-joint
    test rig and on the full-body rig (GN 8 on the block-banded normal
    equations, SPIKE with 32 parts): K1 (the frame contexts, held at
    B = 1024) and K2+K3 (the SPIKE locals' batched Thomas steps, held at
    (32, 23) with 70 right-hand sides and (32, 156) with 470 on systems of
    the path), each config's final error against JAX CPU's; and the
    full-body sequence at F = 256 with an acceleration term, whose
    forward-mode Jacobians run through K1's jvp and vmap rules, held
    against the plain FK's;
  * config 6, marker tracking, on config 6s (a synthetic 343-frame × 41-
    marker clip on the CMU rig, 73 parameters): calibration, the locators-
    only round, per-frame tracking, the smoothed refine and hierarchical
    batched tracking, every pose solve by forward-mode Jacobians through
    K1 and steps through K2+K3: per stage frames/s, the marker errors
    against JAX CPU's and the launches; the AD Jacobian held against the
    analytic one at B = 343, K1 held at B = 1 and 343, K2+K3 at (1, 73) and
    (343, 73);
  * config C, batched IK at B = 2048 over every rigid module of the error
    catalog (position, both distorted cameras' projections, the projection
    matrix, aim, fixed axis, normal and distance in a union, joint-to-joint,
    state, the six limit record types, capsule and floor collision): LM 10
    on the normal equations, blockwise analytic Jacobians and forward mode
    through K1, K2+K3 at (2048, 157): each module's median energy,
    conv_at_1e5 and divergent count against JAX CPU's on the first 256
    elements; K2+K3 held at (2048, 157), the forward-mode rows through K1
    against the plain FK's;
  * config 6k, config 6s's clip with the 2D keypoints of four cameras:
    batched tracking from the calibrated identity and the refine, both with
    markers and keypoints, against JAX CPU's marker and reprojection errors;
    the forward-mode rows through K1 against the plain FK's at B = 343,
    K2+K3 held at (343, 73);
  * config D, differentiable IK at B = 2048: θ* by torch_interop.solve_ik_torch
    (GN 20, K1 and K2+K3) and the gradients of Σ w·θ* to the targets and the
    constraint weights by the implicit function theorem (the normal
    equations through K1, one K2+K3 solve at (2048, 157), the energy's
    directional derivative through K1's jvp rule): the per-element energies
    and gradients against JAX CPU's vmapped solve_ik_ift, the backward's
    K2+K3 solve held against the plain one; the solver variants on its
    problem (QR, trust-region QR, CG with K1 under every JVP and VJP sweep,
    line search, gradient descent, histories) against JAX CPU's;
  * config 4x, config 4b with the point-triangle, vertex-distance and
    camera-vertex projection modules (forward-mode Jacobians through K1):
    their rows and Jacobians on the card against the CPU's, each module's
    median final energy against JAX CPU's;
  * config SL, skinned-locator IK at B = 2048 (the full-body rig's 80
    locators turned into skinned locators, 16 sliding locator-to-triangle
    constraints; LM 10, forward mode through K1 with the posed mesh, K2+K3
    at (2048, 157)): the tables and each module's median energy,
    conv_at_1e5 and get_locator_error's skinned branch against JAX CPU's;
  * config G, glove-fused tracking of 343 frames (a glove bone under each
    wrist, 169 parameters, two 7-finger glove streams): the sequence solve
    and per-frame tracking of 32 frames, their marker and glove figures
    against JAX CPU's, the glove offsets' bake round trip; K1 held at
    B = 343, K2+K3 on a SPIKE step and a per-frame step;
  * config 4ad, config 4b by the forward-mode Jacobian (bench_suite.py's
    force_ad A/B): solves/s, speedup_analytic, median_param_sq_err against
    JAX CPU's;
  * config 7p, the pymomentum renderer's scene on config 7's clip at
    640 × 480: the offline viewer (render_motion with the checkerboard
    ground and the skeleton overlay: K1 once, K4b a frame) and its GIF,
    decoded again, and the Phong scene (render_mesh_phong 2× supersampled,
    K4b at 1280 × 960 over back faces culled to (0, 0, 0); the skeleton's
    cylinders, K4b; an 80-face sphere, K4a; the locators as dense dots; a
    label): frames/s of each, frames 0-1's coverage and mean colour against
    JAX CPU's and against the CPU's render; the three passes held against
    the plain version; the dense and windowed rasterizers on the card
    against the CPU's, and the three methods' face maps, ties aside;
  * config SC, SDF-collision IK at B = 2048 on the full-body rig: an
    obstacle's and a ground slab's signed distance fields built by
    mesh_to_sdf on the card (held against the same code on the CPU), LM 10
    over the 80 markers, SdfCollision of all 612 vertices and VertexSdf on
    the 32 lowest, analytic Jacobians through the LBS walk, K1 and K2+K3 at
    (2048, 157): each module's median energy, conv_at_1e5, the obstacle's
    penetration before and after, the support contacts of JAX CPU's solved
    poses against JAX CPU's, and a joint-attached grid (its rows by forward
    mode through K1) at B = 256; K1 held at B = 2048, K2+K3 at (2048, 157);
  * config 5c, config 5's sequence solve held off a ground slab by
    SdfCollisionSequence (forward mode through K1's jvp rule, SPIKE's steps
    through K2+K3): the final error against JAX CPU's;
  * config U, retargeting and character surgery on the full-body rig with
    one body a joint at B = 2048: U1 transform_pose by a 0.7 rad turn and a
    4.3 m move (K1; FK of the result against the moved poses, their skinned
    vertices, the 4×4 form of torch_interop.transform_pose), U2 inverse FK
    (re-FK error; joint parameters against JAX CPU's), U3 IK on the rig
    scaled by 1.15 with the bodies' centre of mass and U4 IK on the rig
    simplified off its legs and feet (LM 10; K1, K2+K3 at (2048, 157) and
    (2048, 115)): each module's median energy, conv_at_1e5 and U4's tables
    against JAX CPU's; K1 held at U4's 37 joints, K2+K3 at (2048, 115);
  * the multi-process paths on two gloo ranks sharing the card: config 5fs
    (config 5f through solve_sequence_sharded, 512 frames a rank), a
    window-3 sequence whose frames pad, IKs (solve_ik_sharded at B = 2048)
    and sharded tracking of config 6s's clip, each held against the
    single-device port solve on the same inputs and 5fs against JAX CPU's
    final error; K1 and K2+K3 launched on each rank, K2+K3 held at the
    widest system of a rank's SPIKE step, K1 at a rank's 512 frames;
  * config IO, the file layer (momentum_tpu_torch/io): the full-body rig
    with bodies, a 1024-frame motion and markers through .glb, and its
    .model, .locators, legacy JSON, .mppca and .mmo, loaded onto the card
    and held to what was written; JAX's reference files
    (tools/jax_reference_io) read onto the card and held to what JAX's
    loaders gave; the 1024 frames' skeleton states loaded by FK on K1; the
    main path's IK on the loaded rig (K1, K2+K3) against the in-memory rig;
    config 6s's clip through a .trc file, tracked hierarchically (K1,
    K2+K3 at (343, 73)) against the in-memory clip's run; each format's
    save and load times and bytes;
  * config IO2, the file layer's second part: JAX's FBX, USD, BVH and URDF
    files (tools/jax_reference_io2) read onto the card and held to what
    JAX's loaders gave; the full-body rig with a 1024-frame motion through
    .fbx, .usda, .usdc and .bvh; its 1024 frames' global states through
    save_with_skel_states to .usda and .fbx and back by FK on K1; the
    marker-file pipeline, process_marker_file on config 6s's clip as .trc
    and the CMU rig as .usda + .model (calibration and per-frame tracking,
    K1, K2+K3 at (1, 73)) to .fbx, .bvh and .glb, against process_markers
    on the in-memory clip, and the process-markers CLI in a subprocess on
    the same files; each format's save and load times and bytes.

    python3 chip_smoke.py

Runs from the root of a checkout of the repo (it imports momentum_tpu_torch
from there). Needs one CUDA card and nvcc (the kernels build into
build/momentum_tpu_torch/ at first use). Imports nothing of JAX. Every failed
check raises, so the exit code is non-zero. A passing run prints, before its
last line, one JSON line
with each kernel's launches on its path, its error against the plain version,
its time, the plain version's, the library call's where one exists, and its
bound: the larger of its bytes (each input read once, each output written
once) at 3.35 TB/s and its f32 flops at 67 TFLOP/s, from this run's inputs
(for K4a, the flops of the faces its per-tile test keeps).
The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time

import numpy as np
import torch

BATCH = 2048
CLIP_FRAMES = 32  # the render clip's frames: K1's batch on that path
SEED = 0
FK_TOL = 2e-5  # abs, f32: kernel and plain version lift alike; PyTorch's kernels may fuse
# of the largest |component| of the plain states, where that is larger: the
# mm-scale CMU rig's translations reach ~2 000, whose float32 ulp is 1.2e-4
FK_REL_TOL = 1e-6
# of max|grad|: K1's backward is the plain VJP; index_select's backward sums atomically
FK_GRAD_TOL = 1e-5
PSD_RELRES_TOL = 1e-5  # max ‖(A+D)x − b‖/‖b‖; plain cholesky_ex gives ~2e-7 here
PSD_X_TOL = 1e-3  # max |x_kernel − x_plain| / max |x_plain|: κ reaches ~1e8 here
# where κ is larger (config 4b's blend-shape columns): the kernel's forward
# error against float64 within this factor of the plain float32 solve's
X_FWD_FACTOR = 10.0
CONV_MIN = 0.98  # JAX CPU runs of this workload give 0.99–1.0
RASTER_TOL = dict(depth=1e-5, bary=1e-5, attrs=1e-4)  # abs; face maps must be identical
# mean(imgs > 0) of config 7's 32-frame clip rendered by the JAX package on the
# CPU (its "auto" = windowed path; config 7's recipe, seed 0); PERF.md §6
CLIP_COVERAGE_JAX_CPU = 0.010333353678385417
CLIP_COVERAGE_RTOL = 0.02
# bench.py's full-stack recipe (GN 2 + 1 on the worst half) run by the JAX
# package on the CPU at B = 256, seed 0: marker conv@1e-5 and median marker
# energy (PERF.md §2)
FULLSTACK_CONV_JAX_CPU = 1.0
FULLSTACK_MEDIAN_JAX_CPU = 5.70412e-08
FULLSTACK_CONV_SLACK = 0.01
# benchmarks/bench_suite.py configs 2 and 4 run by the JAX package on the CPU
# (tools/jax_reference.py, the recipes of testing/workloads.py): config 2's
# single-frame LM energy; 2b's conv_at_1e5 (GN 2 + 1 within 1e-5 of each
# element's 40-iteration LM optimum) at B = 2048 and 256, seed 0; config 4's
# single-frame LM energy; 4b's median_param_sq_err at B = 256, seed 1
CONFIG2_FRAME_ENERGY_JAX_CPU = 0.002596117788925767
CONFIG2B_CONV_JAX_CPU = {2048: 0.029296875, 256: 0.078125}
CONFIG2B_CONV_SLACK = 0.01
CONFIG4_FRAME_ENERGY_JAX_CPU = 0.00023250572849065065
CONFIG4B_PARAM_SQ_ERR_JAX_CPU = 4.2157122237540534e-10
# the frame energies on the card against JAX on the CPU (the port on the CPU
# matches to 7e-7 and 1.1e-5: tests/test_torch_port_{lm_normal,vertex}.py)
FRAME_ENERGY_RTOL = 1e-2
# 4b's median_param_sq_err: the port on the CPU is within 1.015 of JAX at B = 16
CONFIG4B_FACTOR = 2.0
SMALL_MESH_FACES = 120  # ≤ bin_capacity 128: the render takes K4a
# the batch sizes the paths give K2+K3: IK 2048 and its compacted 128, the
# full stack's refinement on 1024 (testing/workloads.py)
PSD_BATCHES = (BATCH, 128, 1024)
# (B, n, k) of K2+K3's factor-only form, then its substitution: config 5f's
# SPIKE forward step and config G's step
FACTOR_ONLY_SHAPES = ((32, 156, 470), (10, 169, 508))
# benchmarks/bench_suite.py config 5 (the 16-joint test rig) and 5f (the
# full-body rig) at F = 1024, GN 8, run by the JAX package on the CPU
# (python tools/jax_reference.py --configs 5,5f): the final error; both run
# their 8 iterations without converging
SEQUENCE_FRAMES = 1024
SEQUENCE_ERROR_JAX_CPU = {"5": 5.676108360290527, "5f": 414.1357116699219}
SEQUENCE_ITERATIONS_JAX_CPU = 8
SEQUENCE_RTOL = 1e-2  # the port on the CPU matches JAX to 1e-5 at F = 130
# the normal equations with an acceleration term through K1 against the same
# with FK on the plain version: max|Δ| / max|block| per block
SEQUENCE_NE_RTOL = 1e-4
ACCEL_FRAMES = 256
# benchmarks/bench_suite.py config 6's five stages on config 6s, the synthetic
# 343-frame clip of testing/workloads.py::build_tracking_clip, run by the JAX
# package on the CPU (python tools/jax_reference.py --configs 6s --out-6s
# tools/jax_reference_6s.json): per stage the median and p90 marker error (mm)
# over the visible markers of its motion (the calibration stages' over their 10
# sampled frames), the calibrated scale_global, and the calibration's outputs
# (identity, locator offsets). JAX's calibration reverts its scale solve (a NaN
# step, the NaN guard): scale_global stays at its start, 0.0 (ROADMAP F14)
TRACKING_JAX_CPU_FILE = "tools/jax_reference_6s.json"
TRACKING_JAX_CPU_MOTION_FILE = "tools/jax_reference_6s_per_frame.npy"
TRACKING_MEDIAN_RTOL, TRACKING_MEDIAN_ATOL_MM = 0.02, 0.02
TRACKING_P90_RTOL = 0.05
# the two calibration stages' motions are LM fits from the rest pose, cut at
# 25 iterations before they converge: their iterates split between float32
# implementations after a few accepted steps (frame 0: 2e-4 apart after one,
# 2.4 mm after ten, the port against JAX on the CPU), so their medians are
# held like the p90s (the port on the CPU lands 0.3% and 2.6% from JAX's). The
# later stages take JAX's inputs, so that each is held to JAX's on the same
# ones: per-frame and hierarchical tracking JAX's calibrated rig and identity,
# the refine JAX's per-frame motion. The refine's result moves with the input's
# components along the rig's near-null directions (collinear clavicle and
# shoulder x axes): JAX's own refine moves 3% in the median and 5.5% in the
# p90 under a 1e-6 perturbation of its input (PERF.md §6)
TRACKING_CALIBRATION_MEDIAN_RTOL = 0.05
TRACKING_SCALE_TOL = 2e-3  # against JAX CPU's
TRACKING_TRUE_SCALE = 0.1  # the clip's truth, printed beside the result
# the forward-mode Jacobian through K1 against the analytic one, of max|J|
AD_JAC_RTOL = 1e-4
# config C, batched IK over the whole rigid error catalog at B = 2048, held
# on its first 256 elements (the same draws at every batch size) against the
# JAX package on the CPU (python tools/jax_reference.py --configs catalog
# --out-catalog tools/jax_reference_catalog.json): every module's median
# final energy within 20% (an energy under 1e-8 of the median total is float32
# roundoff of a converged term: held to that), conv_at_1e5 within 0.01, no
# divergent element
CATALOG_JAX_CPU_FILE = "tools/jax_reference_catalog.json"
CATALOG_HELD = 256
CATALOG_MEDIAN_RTOL, CATALOG_MEDIAN_FLOOR = 0.2, 1e-8
CATALOG_CONV_SLACK = 0.01
# forward-mode rows through K1 against the same through fk_global_plain, of max|J|
AD_K1_RTOL = 1e-5
# config 6k, config 6s's clip with the four cameras' keypoints, against JAX CPU
# (python tools/jax_reference.py --configs 6k --out-6k tools/jax_reference_6k.json):
# config 6s's tolerances, the median reprojection error held like the medians
KEYPOINTS_JAX_CPU_FILE = "tools/jax_reference_6k.json"
# config D, differentiable IK at B = 2048 (GN 20), held on its first 256
# elements against the JAX package's vmapped solve_ik_ift on the CPU (python
# tools/jax_reference.py --configs diffik --out-diffik
# tools/jax_reference_diffik.json, which writes the per-element arrays the
# smoke reads beside it, as .npz): the median energy at θ* within 20% (the IK rule); ∂L/∂targets'
# median per-element relative L2 error within 5e-2. GN 20 at regularization
# 1e-6 leaves about a third of the elements off a stationary point in both
# packages (gradient rmse up to ~10, the port and JAX each), where the IFT
# gradient is not defined and the two packages' iterates part. On the
# elements stationary in both (rmse ≤ 1e-3), 95% of the elements'
# ∂L/∂targets and ∂L/∂cweight within 5e-2 in relative L2: a few reach
# another stationary point in each package (the port on the CPU: 2 of 115
# at B = 256, 0.36 and 0.59 apart, the other 113 under 6.2e-3), so the
# relative L2 error pooled over the elements is printed, not held
DIFFIK_JAX_CPU_ARRAYS = "tools/jax_reference_diffik.npz"
DIFFIK_HELD = 256
DIFFIK_ENERGY_RTOL = 0.2
DIFFIK_STATIONARY = 1e-3
DIFFIK_GRAD_TOL = 5e-2
DIFFIK_SHARE_MIN = 0.95
# solve_ik_ift called directly against solve_ik_torch: the same computation,
# apart from the atomic adds of index_select's backward
DIFFIK_DIRECT_TOL = 1e-4
# the solver variants on config D's position problem, against JAX CPU at
# B = 256 (python tools/jax_reference.py --configs variants --out-variants
# tools/jax_reference_variants.json): the median final energy within 20%
VARIANTS_JAX_CPU_FILE = "tools/jax_reference_variants.json"
VARIANT_MEDIAN_RTOL = 0.2
# config 4x against JAX CPU (python tools/jax_reference.py --configs 4x
# --out-4x tools/jax_reference_4x.json): each module's median final energy on
# the first 64 elements within 20%; the card's rows and forward-mode
# Jacobians against the CPU's, of max|.|
VERTEX_EXTRA_JAX_CPU_FILE = "tools/jax_reference_4x.json"
VERTEX_EXTRA_HELD = 64
VERTEX_EXTRA_MEDIAN_RTOL = 0.2
VERTEX_EXTRA_ROWS_RTOL = 1e-4
# config SL, skinned-locator IK at B = 2048, held on its first 256 elements
# against the JAX package on the CPU (python tools/jax_reference.py --configs
# skinned --out-skinned tools/jax_reference_skinned.json): the
# skinned-locator tables and the triangle recipe equal to JAX's (indices
# exact, weights and rest positions within 1e-6), then config C's holds
# (each module's median final energy within 20%, conv_at_1e5 within 0.01, no
# divergent element) and get_locator_error of the first 32 solves within 2%
SKINNED_JAX_CPU_FILE = "tools/jax_reference_skinned.json"
SKINNED_HELD = 256
SKINNED_TABLE_TOL = 1e-6
SKINNED_LOCATOR_ERROR_RTOL = 0.02
SKINNED_AD_ROWS_BATCH = 128  # the forward-mode rows' hold: 157 tangents of 612 vertices each
# config G, glove-fused tracking of 343 frames, against JAX CPU (python
# tools/jax_reference.py --configs glove --out-glove
# tools/jax_reference_glove.json; JAX's sequence with the gloves split per
# joint, ROADMAP F21): the sequence's final error within 1e-2, the marker
# error median within 2% (0.02 mm at least) and p90 within 5%, the glove
# residual medians within 2%; per-frame tracking of the first 32 frames: the
# same medians and the median energy within 2%
GLOVE_JAX_CPU_FILE = "tools/jax_reference_glove.json"
GLOVE_ERROR_RTOL = 1e-2
GLOVE_MEDIAN_RTOL = 0.02
GLOVE_BAKE_TOL = 1e-6
# config 4ad, config 4b solved with the forward-mode Jacobian (force_ad),
# against JAX CPU's same route (python tools/jax_reference.py --configs 4ad
# --out-4ad tools/jax_reference_4ad.json): median_param_sq_err within 2×, no
# divergent element
SCENE_JAX_CPU_FILE = "tools/jax_reference_7p.json"
SCENE_FIGURE_RTOL = 0.02  # coverage and mean colour against JAX CPU's planes figures
SCENE_HELD_FRAMES = (0, 1)  # the frames JAX CPU rendered, and the CPU re-render's
SCENE_METHOD_AGREEMENT = 0.999  # dense, windowed and planes face maps on the covered pixels
VERTEX_AD_JAX_CPU_FILE = "tools/jax_reference_4ad.json"
VERTEX_AD_FACTOR = 2.0
VERTEX_AD_ROWS_BATCH = 64
# config SC (SDF-collision IK at B = 2048) and 5c (config 5 held off a
# ground slab), against JAX CPU's (python tools/jax_reference.py --configs
# sdf --out-sdf tools/jax_reference_sdf.json, which also writes JAX's solved
# parameters to tools/jax_reference_sdf.npz): each module's median final
# energy on the first 256 within 20% (or under 1e-8 of the total),
# conv_at_1e5 within 0.01, nothing divergent; the support contacts of JAX's
# solved poses, computed on the card: active masks equal, polygon areas
# within 1e-3 relative; 5c's final error within 1e-2. mesh_to_sdf on the
# card against the same code on the CPU: values within 1e-5 of the grid's
# extent, signs equal on 99.9% of the voxels (the obstacle's 64³ × 1280-face
# grid on every 8th voxel, the CPU's brute force taking ~50 s for all)
SDF_JAX_CPU_FILE = "tools/jax_reference_sdf.json"
SDF_JAX_CPU_ARRAYS = "tools/jax_reference_sdf.npz"
SDF_HELD = 256
SDF_VALUE_TOL = 1e-5
SDF_SIGN_SHARE = 0.999
SDF_CPU_STRIDE = 8
SDF_AREA_RTOL = 1e-3
SDF_AD_ROWS_BATCH = 64
# the joint-attached rows are φ(v) − target, differences of distances of
# ~1e-2 m at the warm starts, so the float32 rounding of the posed vertices
# (~1e-7 m, K1 against the plain FK) is ~1e-5 of the largest row, and the
# trilinear gradient jumps across a voxel face: 1e-4 of max|J| and of the
# rows (measured 2.9e-5 and 1.4e-5 on one H100)
SDF_AD_K1_RTOL = 1e-4
SDF_SEQUENCE_RTOL = 1e-2
# config U (retargeting and character surgery at B = 2048) against JAX CPU's
# (python tools/jax_reference.py --configs utility --out-utility
# tools/jax_reference_utility.json, which writes JAX's inverse-FK joint
# parameters of the first 256 truths beside it as .npz): U1's FK of the
# retargeted poses against the moved poses within 1e-4 m and 1e-4 rad (the
# quaternions normalized, in float64), their skinned vertices within 1e-4 m,
# the 4×4 form within 1e-5 of the skel_state form; JAX's transform_pose is
# off by 2π on this move (ROADMAP F25), printed beside; U2's re-FK within
# 1e-4 m and its joint parameters within 1e-5 of JAX CPU's (the truths keep
# |ry| ≤ 0.3, away from the gimbal branch); U3 and U4 config C's holds on the
# first 256, each module's median after LM 10 within UTILITY_MEDIAN_RTOL and
# after LM UTILITY_EARLY within UTILITY_EARLY_RTOL; U4's tables (joint
# parents, parameter names and transform, every limit table, locator
# parents, mesh faces) equal to JAX CPU's
UTILITY_JAX_CPU_FILE = "tools/jax_reference_utility.json"
UTILITY_JAX_CPU_ARRAYS = "tools/jax_reference_utility.npz"
UTILITY_HELD = 256
UTILITY_FK_TOL = 1e-4
UTILITY_FORM_TOL = 1e-5
UTILITY_JP_TOL = 1e-5
# The limits on U3's and U4's medians, from tools/utility_spread.py on one
# H100 (B = 256, JAX CPU's five seeds of tools/jax_reference_utility.json).
# Near LM 10 both solves still converge linearly, an iteration cutting the
# median energy by ~40% toward ~1e-9 m², and two float32 implementations
# part there: after LM 10 the port's medians land up to 28% from JAX CPU's
# with the kernels, 22% with both kernels' plain versions on the card, 11%
# on the CPU; a solve one iteration short (LM 9) lands 50% to 106% off.
# After LM 3 (medians ~1e-4) every variant lands within 0.44%; the centre of
# mass held by masses off by N(0, 1e-3) lands 1.8% to 11% off.
UTILITY_MEDIAN_RTOL = 0.35
UTILITY_EARLY = 3
UTILITY_EARLY_RTOL = 0.01

# phase_sharded: config 5fs (config 5f through solve_sequence_sharded), the
# window-3 sequence, IKs and sharded tracking, on 2 gloo ranks that share
# the one card. 5fs is held as config 5f (its final error within
# SEQUENCE_RTOL of JAX CPU's) and to the single-device port solve's
# iteration count; its parameters are not held (null directions drift,
# ROADMAP F5). The window-3 sequence (q = 2) at a frame count that pads on
# 2 ranks, its error within SHARDED_ERROR_RTOL of the single-device port
# solve's (the CPU tests' tolerance between the two). IKs: the driver's IK
# at B = 2048 by solve_ik_sharded (tests/test_parallel_batch.py's options),
# conv@1e-5 within 0.01 and the median Σr² within 1% of solve_ik's on the
# same inputs; tracking config 6s's clip cut to 342 frames with the
# hierarchical stage's batched settings (LM 10 + 5 on the worst 64), its
# per-frame marker error's median within 2% and p90 within 5% of
# track_poses_batched's
SHARDED_RANKS = 2
SHARDED_TIMEOUT = 400.0
SHARDED_ACCEL_FRAMES = 254  # 254 = 2 ranks × q 2 × 63 + 2: two padding frames
SHARDED_ACCEL_ITERATIONS = 4
SHARDED_ERROR_RTOL = 1e-3
SHARDED_IK_OPTIONS = dict(max_iterations=10, regularization=1e-6, energy_from_residual=True)
SHARDED_CONV_SLACK = 0.01
SHARDED_MEDIAN_RTOL = 0.01
SHARDED_TRACK_FRAMES = 342
SHARDED_TRACK_MEDIAN_RTOL, SHARDED_TRACK_P90_RTOL = 0.02, 0.05

# phase_io, config IO: the file layer on the card. The round trips hold
# integers and names equal and floats bit for bit (every format stores
# float32 or its exact decimal); the tables a loader computes by FK (the
# inverse bind pose, skeleton states) within FK_TOL. The IK on the loaded
# rig is the same arithmetic as on the in-memory rig: conv@1e-5 within
# IO_CONV_SLACK and the median Σr² within IO_MEDIAN_RTOL (bit equality is
# printed). Tracking the .trc take (positions rounded to the TRC's 5
# decimals) within 2% / 5% of the in-memory clip's marker errors.
IO_FRAMES = 1024
IO_REPEATS = 3
IO_SEED = 17
IO_CONV_SLACK = 0.01
IO_MEDIAN_RTOL = 0.01
IO_TRACK_MEDIAN_RTOL, IO_TRACK_P90_RTOL = 0.02, 0.05

# phase_io2, config IO2: the file layer's second part and the marker-file
# pipeline. The round trips hold what each format carries at the precision
# it stores (stated beside each hold); the skeleton states written through
# save_with_skel_states (inverse FK in float32, the pseudo-inverse for USD)
# and loaded back by FK within IO2_STATES_TOL. The pipeline runs on config
# 6s's first IO2_PIPELINE_FRAMES frames (three runs of it at once: the
# call, the in-memory run and the CLI with its call); its marker errors
# within IO_TRACK_MEDIAN_RTOL / IO_TRACK_P90_RTOL of the in-memory run's
IO2_PIPELINE_FRAMES = 128
IO2_CLI_ITERATIONS = 15
IO2_CLI_OPTIONS = ("--calib-frames", "10", "--major-iter", "2", "--max-iter",
                   str(IO2_CLI_ITERATIONS), "--method", "levenberg_marquardt")
IO2_WORKER_TIMEOUT = 600.0
IO2_STATES_TOL = FK_TOL  # both ends by FK in float32 (K1 and plain agree to FK_TOL)

# phase_jacobian, K6: of max|J|; the kernel sums the same float32 factors
# as the plain form in another order (the tree walk, [t]×R before PT)
JAC_TOL = 1e-5
JAC_F64_ROWS = 256  # elements held against the plain form in float64

# phase_projection_jacobian, K6's projection form: of max|J|; the same
# float32 chain as the plain form in another order (p_eye by R·p + t, the
# derivative's products), as K6
PROJ_TOL = 2e-6
# the plain form's (B, K, C, 2, P) intermediates at the cell's B would not
# fit whole: held in blocks of PROJ_BLOCK elements, timed in blocks of
# PROJ_TIME_BLOCK
PROJ_BLOCK = 1024
PROJ_TIME_BLOCK = 4096
PROJ_CELL = "mv31.b16384"


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU only")
    try:
        from momentum_tpu_torch.testing.profile_workload import card_name_and_power_limit
    except ModuleNotFoundError as e:
        raise RuntimeError("chip_smoke.py runs from the root of a checkout of the repo: "
                           "momentum_tpu_torch is not importable here") from e

    kind = torch.cuda.get_device_name(0)
    smi = card_name_and_power_limit()
    print(f"device: {kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)
    return kind, smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from momentum_tpu_torch.ops import build

    names = ("fk", "psd", "raster", "jacobian")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per source, all at once
        list(pool.map(build.build, names))
    for name in names:
        build.load(name)
    print(f"build: {time.perf_counter() - t0:.1f} s into {build.BUILD_DIR}")
    for name in names:
        log = str(build.build(name)) + ".log"  # already built: returns the path
        with open(log) as f:
            print(f"  csrc/{name}.cu ptxas: " + " | ".join(
                ln.strip() for ln in f if "registers" in ln or "spill" in ln))


def _hold_fk(skel, local, label):
    """K1 against the plain version on local states (B, nJ, 8): max error,
    the kernel's time (CUDA events around launches queued behind a sleep
    kernel, and the profiler's device time), the plain version's, the bound."""
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.testing.profile_workload import (
        bound, event_ms, fmt_ms, kernel_device_ms)

    batch = local.shape[0]
    out = fk_ops.fk_global(skel, local)
    ref = fk_ops.fk_global_plain(skel, local)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    tol = max(FK_TOL, FK_REL_TOL * float(ref.abs().max()))
    ms = event_ms(lambda: fk_ops.fk_global(skel, local), busy=True)
    dev_ms = kernel_device_ms(lambda: fk_ops.fk_global(skel, local), "fk_global_kernel")
    plain_ms = event_ms(lambda: fk_ops.fk_global_plain(skel, local))
    # local states read, global states written, the lifting table; one
    # skel_state compose per joint: quaternion product 28 flops, rotated
    # and scaled translation 36, scale 1
    b_fk = bound(2 * local.numel() * 4 + skel.prefix_table.numel() * 4,
                 batch * local.shape[1] * 65)
    print(f"K1 fk_global_kernel (B={batch}, nJ={local.shape[1]}, "
          f"{skel.prefix_table.shape[0]} levels, {label}): max|kernel - plain| = {err:.3e} "
          f"(tol {tol:.1e}); kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), plain "
          f"{plain_ms:.4f} ms, bound {b_fk['bound_ms']:.6f} ms ({b_fk['bound_by']}), "
          f"{b_fk['bound_ms'] / ms:.1%} of it")
    if not err <= tol:
        raise AssertionError(f"fk_global_kernel disagrees with the plain FK at "
                             f"B = {batch} ({label}): {err}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b_fk, library_ms=None,
                device_ms=dev_ms)


def phase_fk(char, x0):
    """K1 against the plain version at the IK path's B = 2048 and the
    clip's B = 32 (one launch for all its frames)."""
    from momentum_tpu_torch.character import fk

    skel = char.skeleton
    local_all = fk.local_skel_states(skel, char.parameter_transform.apply(x0)).contiguous()
    numbers = {batch: _hold_fk(skel, local_all[:batch].contiguous(), label)
               for batch, label in ((BATCH, "IK path"), (CLIP_FRAMES, "the clip's frames"))}
    return numbers[BATCH], numbers


def phase_psd(char, ef0, targets, x0):
    """K2+K3 on the IK path's own normal equations at x0 (LM damping), at the
    batch sizes the paths give it: against the plain version by relative
    residual and by x, timed in turns against the library's
    cholesky_ex + cholesky_solve; then ROADMAP F1 with pivots that fail in
    the first panel, the second, the third, and the ragged last one; then the
    factor-only form at the SPIKE shapes, through the substitution."""
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.profile_workload import (
        factor_bound, fmt_ms, in_turns, kernel_device_ms, library_solve, solve_bound)

    fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    rows, j = fn.residual_and_jacobian(x0)
    jt = j.transpose(-1, -2)
    a_all = (jt @ j).contiguous()
    b_all = (jt @ rows[..., None])[..., 0].contiguous()
    d_all = (0.01 * torch.clamp(a_all.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5).contiguous()
    del rows, j, jt

    def relres(a, damp, b, sol):
        ad = (a + torch.diag_embed(damp)).double()
        r = (ad @ sol.double()[..., None])[..., 0] - b.double()
        return float((torch.linalg.norm(r, dim=-1) / torch.linalg.norm(b.double(), dim=-1)).max())

    numbers = {}
    for batch in PSD_BATCHES:
        a, damp, b = (t[:batch].contiguous() for t in (a_all, d_all, b_all))
        n = a.shape[1]
        x = psd.damped_chol_solve(a, damp, b)
        x_plain = psd.damped_chol_solve_plain(a, damp, b)
        res_k, res_p = relres(a, damp, b, x), relres(a, damp, b, x_plain)
        err = float((x - x_plain).abs().max())
        x_rel = err / float(x_plain.abs().max())
        t = in_turns({"kernel": lambda: psd.damped_chol_solve(a, damp, b),
                      "library": library_solve(a, damp, b),
                      "plain": lambda: psd.damped_chol_solve_plain(a, damp, b)})
        dev_ms = kernel_device_ms(lambda: psd.damped_chol_solve(a, damp, b),
                                  "damped_chol_solve_kernel")
        lib_dev_ms = kernel_device_ms(library_solve(a, damp, b), "", per_call=None)
        b_psd = solve_bound(batch, n)
        print(f"K2+K3 damped_chol_solve_kernel (B={batch}, n={n}, IK normal equations): "
              f"max rel. residual kernel {res_k:.3e} / plain {res_p:.3e} (tol "
              f"{PSD_RELRES_TOL:.0e}); max|x_kernel - x_plain| = {err:.3e} ({x_rel:.3e} of "
              f"max|x|, tol {PSD_X_TOL:.0e}); in turns: kernel {t['kernel']:.4f} ms, library "
              f"cholesky_ex + cholesky_solve {t['library']:.4f} ms, plain {t['plain']:.4f} ms; "
              f"device time kernel {fmt_ms(dev_ms)} ms, library {fmt_ms(lib_dev_ms)} ms; bound "
              f"{b_psd['bound_ms']:.4f} ms ({b_psd['bound_by']}), "
              f"{b_psd['bound_ms'] / t['kernel']:.1%} of it")
        if not (res_k <= PSD_RELRES_TOL and x_rel <= PSD_X_TOL):
            raise AssertionError(f"damped_chol_solve_kernel disagrees with the plain solve "
                                 f"at B = {batch}")
        numbers[batch] = dict(max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                              **b_psd, library_ms=t["library"], device_ms=dev_ms,
                              library_device_ms=lib_dev_ms)

    # ROADMAP F1: a system whose pivot fails comes back all-NaN from both
    # versions, in the first 32-wide panel, the second (factored under the
    # first's trailing update), the third, the ragged last one (row 150 of
    # 157) or through a NaN; its neighbours are unaffected
    bad = a_all[:7].clone()
    bad[1, 5, 5] = bad[2, 70, 70] = bad[3, 150, 150] = bad[5, 40, 40] = -1e6
    bad[4, 100, 100] = float("nan")
    want_nan = [False, True, True, True, True, True, False]
    for name, solve in (("kernel", psd.damped_chol_solve),
                        ("plain", psd.damped_chol_solve_plain)):
        xb = solve(bad, d_all[:7].contiguous(), b_all[:7].contiguous())
        nan_rows = torch.isnan(xb).all(dim=-1).tolist()
        finite_rows = torch.isfinite(xb).all(dim=-1).tolist()
        if nan_rows != want_nan or finite_rows != [not w for w in want_nan]:
            raise AssertionError(f"F1: {name} solve of indefinite systems gave "
                                 f"nan rows {nan_rows}, finite rows {finite_rows}")
    print("K2+K3 F1: systems failing in panels 1, 2, 3 and the ragged last one, and a NaN, "
          "are all-NaN in kernel and plain, their neighbours finite")

    # The factor-only form at the SPIKE shapes (FACTOR_ONLY_SHAPES): n = 156
    # the IK path's leading unknowns, n = 169 a damped random SPD system made
    # from SEED, k random right-hand sides. Held by relative residual through
    # the substitution; its factor kernel timed alone by the profiler beside
    # the library's cholesky_ex (device time, every kernel of the call) and
    # the plain factor (CUDA events).
    factor_only = {}
    g = torch.Generator().manual_seed(SEED)
    for batch, n, k in FACTOR_ONLY_SHAPES:
        if n <= a_all.shape[1]:
            a = a_all[:batch, :n, :n].contiguous()
            damp = d_all[:batch, :n].contiguous()
        else:
            j = torch.randn(batch, n + 20, n, generator=g).cuda()
            a = (j.transpose(-1, -2) @ j).contiguous()
            damp = (0.01 * a.diagonal(dim1=-2, dim2=-1) + 1e-5).contiguous()
        b = torch.randn(batch, n, k, generator=g).cuda()
        call = lambda: psd.damped_chol_solve(a, damp, b)  # noqa: E731
        x = call()
        x_plain = psd.damped_chol_solve_plain(a, damp, b)
        res_k, res_p = _relres_cols(a, damp, b, x), _relres_cols(a, damp, b, x_plain)
        err = float((x - x_plain).abs().max())
        ad = a + torch.diag_embed(damp)
        ms = kernel_device_ms(call, psd.KERNELS[0])
        lib_ms = kernel_device_ms(lambda: torch.linalg.cholesky_ex(ad), "", per_call=None)
        plain_ms = in_turns({"plain": lambda: torch.linalg.cholesky_ex(
            a + torch.diag_embed(damp))})["plain"]
        b_f = factor_bound(batch, n)
        print(f"K2+K3 factor-only form (B={batch}, n={n}), then the substitution (k={k}): max "
              f"rel. residual kernel {res_k:.3e} / plain {res_p:.3e} (kernel's tol: "
              f"{X_FWD_FACTOR:.0f}x the plain's, at least {PSD_RELRES_TOL:.0e}); max|x - x_plain| "
              f"{err / float(x_plain.abs().max()):.3e} of max|x|; the factor's device time "
              f"{fmt_ms(ms)} ms, library cholesky_ex {fmt_ms(lib_ms)} ms, plain factor (events) "
              f"{plain_ms:.4f} ms; bound {b_f['bound_ms']:.4f} ms ({b_f['bound_by']})")
        if not res_k <= max(PSD_RELRES_TOL, X_FWD_FACTOR * res_p):
            raise AssertionError(f"damped_chol_solve_kernel's factor-only form disagrees with "
                                 f"the plain solve at (B, n, k) = {(batch, n, k)}")
        factor_only[f"{batch}x{n}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b_f,
                                           library_ms=lib_ms, k=k)
    return numbers[BATCH], numbers, factor_only


def phase_jacobian():
    """K6 against its plain version (the merged PyTorch form) at the IK
    cell's shape, B = 65536 on the CMU rig (C = 41, nJ = 23, P = 73, one
    column tile), and at B = 2048 on the full-body rig (C = 80, nJ = 51,
    P = 157, column-tiled), each under the L2 loss (a (C,) row scale):
    max|kernel − plain| against JAC_TOL of max|J|, the kernel's time (CUDA
    events in turns with the plain version, and the profiler's device time),
    the plain version's and the bound. The forms' errors against float64
    are printed on the first JAC_F64_ROWS elements."""
    from momentum_tpu_torch.ops import jacobian as jac_ops
    from momentum_tpu_torch.solver.analytic_jacobian import JacobianContext
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character
    from momentum_tpu_torch.testing.profile_workload import (
        bound, fmt_ms, in_turns, kernel_device_ms)
    from momentum_tpu_torch.testing.workloads import point_jacobian_inputs
    from portbench.rig import load_rig, port_character

    numbers = {}
    for label, char, batch in (
            ("cmu41", port_character(load_rig("portbench/rigs/cmu41.json"), "cuda"), 65536),
            ("fullbody", create_fullbody_character(device="cuda"), BATCH)):
        args = point_jacobian_inputs(char, batch, seed=SEED)
        jc, world, parents, pt_mat, scale = args
        nj, c, p = jc.anc_mask.shape[0], parents.shape[0], pt_mat.shape[1]
        before = jac_ops.launches
        out = jac_ops.point_jacobian_model(*args[:4], scale=scale)
        if jac_ops.launches != before + 1:
            raise AssertionError(f"K6 at {label}: {jac_ops.launches - before} launches")
        ref = jac_ops.point_jacobian_model_plain(*args[:4], scale=scale)
        err = float((out - ref).abs().max()) / float(ref.abs().max())
        del ref
        k = JAC_F64_ROWS
        jc64 = JacobianContext(jc.anc_mask.double(), jc.joint_pos[:k].double(),
                               jc.trans_axis[:k].double(), jc.rot_axis[:k].double())
        ref64 = jac_ops.point_jacobian_model_plain(jc64, world[:k].double(), parents,
                                                   pt_mat.double(), scale=scale.double())
        plain32 = jac_ops.point_jacobian_model_plain(
            JacobianContext(jc.anc_mask, jc.joint_pos[:k], jc.trans_axis[:k], jc.rot_axis[:k]),
            world[:k], parents, pt_mat, scale=scale)
        scale64 = float(ref64.abs().max())
        err64 = {name: float((j.double() - ref64).abs().max()) / scale64
                 for name, j in (("kernel", out[:k]), ("plain", plain32))}
        del out, ref64, plain32
        t = in_turns({"kernel": lambda: jac_ops.point_jacobian_model(*args[:4], scale=scale),
                      "plain": lambda: jac_ops.point_jacobian_model_plain(*args[:4],
                                                                          scale=scale)})
        dev_ms = kernel_device_ms(lambda: jac_ops.point_jacobian_model(*args[:4], scale=scale),
                                  jac_ops.KERNEL)
        # J written once; axes (18 floats a joint), positions (3), points (3
        # a constraint), scales, the transform, the mask and the parents
        # read once. Per element 60 flops a (joint, column) pair (the
        # factors, their walk down the tree) and 7 an entry of J.
        nbytes = 4 * (batch * 3 * c * p + batch * nj * 21 + batch * c * 3 + scale.numel()
                      + pt_mat.numel() + nj * nj + c)
        b_k6 = bound(nbytes, batch * (60 * nj * p + 21 * c * p))
        tile = jac_ops.point_jacobian_tile(nj, c, p)
        print(f"K6 point_jacobian_kernel (B={batch}, C={c}, nJ={nj}, P={p}, {label}, "
              f"column tile {tile}): max|kernel - plain| {err:.3e} of max|J| (tol "
              f"{JAC_TOL:.0e}); against float64 on {k} elements: kernel {err64['kernel']:.3e}, "
              f"plain {err64['plain']:.3e}; in turns: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms; device time {fmt_ms(dev_ms)} ms; bound "
              f"{b_k6['bound_ms']:.4f} ms ({b_k6['bound_by']}), "
              f"{b_k6['bound_ms'] / t['kernel']:.1%} of it")
        if not err <= JAC_TOL:
            raise AssertionError(f"point_jacobian_kernel disagrees with the plain form at "
                                 f"{label}: {err}")
        numbers[f"{batch}x{c}x{nj}x{p}"] = dict(
            max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"], device_ms=dev_ms,
            **b_k6, library_ms=None, column_tile=tile, f64_err=err64)
        del args, jc, world
        torch.cuda.empty_cache()
    return numbers


def _projection_plain_blocks(args, block):
    """The plain projection form of `args` (projection_jacobian_inputs'
    tuple), `block` elements at a time: (slice, J) pairs, one at a time."""
    from momentum_tpu_torch.ops import jacobian as jac_ops

    jc, world, parents, pt, rot, trans, params, scale = args
    for i in range(0, world.shape[0], block):
        sl = slice(i, i + block)
        part = dataclasses.replace(jc, joint_pos=jc.joint_pos[sl], trans_axis=jc.trans_axis[sl],
                                   rot_axis=jc.rot_axis[sl])
        yield sl, jac_ops.projection_jacobian_model_plain(part, world[sl], parents, pt, rot,
                                                          trans, params, scale[sl])


def phase_projection_jacobian():
    """K6's projection form (projection_jacobian_model over
    projection_jacobian_kernel) against its plain form at the multi-view
    cell's shape, B = 16384 on the CMU rig (C = 41 points, K = 31 cameras,
    nJ = 23, P = 73: J 12.2 GB), and at config 6k's (B = 343, K = 3 analytic
    cameras), on testing/workloads.py's cameras and scales: max|kernel −
    plain| against PROJ_TOL of max|J|, the plain form in blocks of
    PROJ_BLOCK elements; the kernel's time (CUDA events in turns with the
    plain form, that in blocks of PROJ_TIME_BLOCK, and the profiler's device
    time), the plain form's and the bound (portbench/projection_work.py).
    Then the cell's own path: one call of PROJ_CELL's driver
    (solve_compacted on the 31 cameras' modules, as the benchmark runs it)
    after its warm-up, the form's launches counted from zero just before
    it: one an LM iteration of each stage, and no K6 launch."""
    from momentum_tpu_torch.ops import jacobian as jac_ops
    from momentum_tpu_torch.testing.profile_workload import (
        bound, fmt_ms, in_turns, kernel_device_ms)
    from momentum_tpu_torch.testing.workloads import projection_jacobian_inputs
    from portbench import run as bench_run
    from portbench.projection_work import projection_jacobian_work
    from portbench.rig import load_rig, port_character

    char = port_character(load_rig("portbench/rigs/cmu41.json"), "cuda")
    numbers = {}
    for label, batch, cameras in (("the cell's", 16384, 31), ("config 6k's", 343, 3)):
        args = projection_jacobian_inputs(char, batch, cameras, seed=SEED)
        jc, world, parents, pt = args[:4]
        nj, c, p = jc.anc_mask.shape[0], parents.shape[0], pt.shape[1]
        before = jac_ops.projection_launches
        out = jac_ops.projection_jacobian_model(*args)
        if jac_ops.projection_launches != before + 1:
            raise AssertionError(f"projection form at {label} shape: "
                                 f"{jac_ops.projection_launches - before} launches")
        worst = top = 0.0
        for sl, ref in _projection_plain_blocks(args, PROJ_BLOCK):
            worst = max(worst, float((out[sl] - ref).abs().max()))
            top = max(top, float(ref.abs().max()))
        err = worst / top
        del out
        torch.cuda.empty_cache()

        def plain():
            for _ in _projection_plain_blocks(args, PROJ_TIME_BLOCK):
                pass

        t = in_turns({"kernel": lambda: jac_ops.projection_jacobian_model(*args),
                      "plain": plain})
        dev_ms = kernel_device_ms(lambda: jac_ops.projection_jacobian_model(*args),
                                  jac_ops.PROJECTION_KERNEL)
        b = bound(*projection_jacobian_work(batch, cameras, c, nj, p))
        tile = jac_ops.projection_jacobian_tile(nj, c, cameras, p)
        print(f"K6 projection_jacobian_kernel (B={batch}, C={c}, K={cameras}, nJ={nj}, P={p}, "
              f"{label} shape, column tile {tile}): max|kernel - plain| {err:.3e} of max|J| "
              f"(tol {PROJ_TOL:.0e}); in turns: kernel {t['kernel']:.4f} ms, plain "
              f"{t['plain']:.4f} ms (blocks of {min(batch, PROJ_TIME_BLOCK)}); device time "
              f"{fmt_ms(dev_ms)} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
              f"{b['bound_ms'] / t['kernel']:.1%} of it")
        if not err <= PROJ_TOL:
            raise AssertionError(f"projection_jacobian_kernel disagrees with the plain form at "
                                 f"{label} shape: {err}")
        numbers[f"{batch}x{c}x{cameras}x{nj}x{p}"] = dict(
            max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"], device_ms=dev_ms, **b,
            library_ms=None, column_tile=tile)
        del args, jc, world
        torch.cuda.empty_cache()

    _, config, traffic = bench_run.resolve_cell(bench_run.load_benchmark(), PROJ_CELL)
    driver = bench_run.load_module(bench_run.ROOT / "portbench" / "drivers"
                                   / f"{config['kind']}.py")
    with bench_run.matmul_tf32(False):
        cell = driver.build(config, traffic, SEED, torch.device("cuda"))
        cell.warm()
        torch.cuda.synchronize()
        jac_ops.projection_launches = 0
        k6 = jac_ops.launches
        cell.call(0)
        torch.cuda.synchronize()
    launched, stages = jac_ops.projection_launches, list(cell.work["stages"])
    iterations = sum(iters for _, iters in stages)
    print(f"{PROJ_CELL} path, one call: {launched} projection form launches, stages (batch, "
          f"LM iterations) {stages}, {jac_ops.launches - k6} K6 launches")
    if launched != iterations or jac_ops.launches != k6:
        raise AssertionError(f"{PROJ_CELL}: {launched} projection launches for {iterations} "
                             f"LM iterations, {jac_ops.launches - k6} K6 launches")
    cell.release()
    del cell
    torch.cuda.empty_cache()
    return numbers, {PROJ_CELL: launched}


def phase_main_path(char, ef0, targets, x0, smi):
    from momentum_tpu_torch.ops import fk as fk_ops, jacobian as jac_ops, psd
    from momentum_tpu_torch.testing.workloads import make_solve_batch

    solve = make_solve_batch(char, ef0, BATCH)
    solve(targets, x0)  # warm-up: library loads, cuBLAS/cuSOLVER handles
    torch.cuda.synchronize()
    fk_ops.launches = 0
    psd.launches = 0
    jac_ops.launches = 0
    t0 = time.perf_counter()
    res = solve(targets, x0)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = {"fk_global_kernel": fk_ops.launches,
              "damped_chol_solve_kernel": psd.launches,
              "point_jacobian_kernel": jac_ops.launches}
    for _ in range(2):
        t0 = time.perf_counter()
        solve(targets, x0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    e = res.error.cpu().numpy()
    conv = float(np.mean(e < 1e-5))
    med = float(np.nanmedian(e))
    div = float(np.mean(~np.isfinite(e)))
    wall = statistics.median(walls)
    print(f"main path (B={BATCH}, LM 5 + 6 compacted on 128, {res.iterations} iterations): "
          f"conv@1e-5 {conv:.4f}, median sum-r2 {med:.3e}, divergent {div:.4f}, "
          f"batch wall {wall * 1e3:.1f} ms (median of {len(walls)}), "
          f"{BATCH / wall:.0f} solves/s on {smi}; kernel launches {counts}")
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"the main path did not run through every kernel: {counts}")
    if res.params.shape != x0.shape or not bool(torch.isfinite(res.params).all()):
        raise AssertionError("main path: parameters of the wrong shape or not finite")
    if not (div == 0.0 and conv >= CONV_MIN):
        raise AssertionError(f"main path accuracy: divergent {div}, conv@1e-5 {conv}")
    return counts


def phase_small_reference():
    """The main path at B = 64 on the card (kernels) and on the CPU (plain
    versions) from the same seed: the same convergence statistics. The
    tolerances are the CPU parity tests' against the JAX package."""
    from momentum_tpu_torch.testing.workloads import (
        build_fullbody_ik_problem, make_solve_batch)

    stats = {}
    for device in ("cuda", "cpu"):
        char, ef0, targets, x0 = build_fullbody_ik_problem(64, seed=SEED, device=device)
        e = make_solve_batch(char, ef0, 64)(targets, x0).error.cpu().numpy()
        stats[device] = (float(np.mean(e < 1e-5)), float(np.median(e)), bool(np.isfinite(e).all()))
    (conv_g, med_g, fin_g), (conv_c, med_c, _) = stats["cuda"], stats["cpu"]
    print(f"small reference (B=64): card conv@1e-5 {conv_g:.4f} median {med_g:.3e}; "
          f"cpu plain conv@1e-5 {conv_c:.4f} median {med_c:.3e}")
    if not (fin_g and abs(conv_g - conv_c) <= 2 / 64 and abs(med_g / med_c - 1) <= 0.2):
        raise AssertionError("the card's B = 64 solve disagrees with the CPU's")


def phase_chol(char, efs, targets, q, x0):
    """K5a and K5b on the full stack's own normal equations at x0 (B = 2048,
    n = 157), padded to n = 160 with identity rows and columns and zero
    damping: the path's run (each entry point once, counted); K2+K3's kernel
    on the unpadded n = 157 systems against the plain solve; then each
    kernel against its plain version by relative residual, and against the
    plain solve of the unpadded system; times in turns with the library's
    cholesky_ex + cholesky_solve; ROADMAP F1 and F6. Both entry points reach
    K2+K3's kernel (32-wide panels, csrc/psd.cu), which counts the launches."""
    from momentum_tpu_torch.ops import chol, psd
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.profile_workload import in_turns, library_solve, solve_bound

    fn = SkeletonSolverFunction(char, (dataclasses.replace(efs[0], target=targets),
                                       dataclasses.replace(efs[1], target=q), *efs[2:]))
    jtj, jtr, _ = fn.normal_equations(x0)
    damp = torch.full_like(jtr, 1e-5)  # the full stack's GN regularization
    a, d, b = chol.pad_identity(jtj.contiguous(), damp, jtr.contiguous())
    xs, counts = {}, {}
    for name, entry in (("K5a", chol.chol_solve), ("K5b", chol.chol_solve_blocked)):
        torch.cuda.synchronize()
        psd.launches = 0
        xs[name] = entry(a, d, b)
        torch.cuda.synchronize()
        counts[name] = psd.launches
    if counts != {"K5a": 1, "K5b": 1}:
        raise AssertionError(f"K5's entry points did not launch damped_chol_solve_kernel: "
                             f"{counts}")

    def relres(sol, a=a, d=d, b=b):
        ad = (a + torch.diag_embed(d)).double()
        r = (ad @ sol.double()[..., None])[..., 0] - b.double()
        return float((torch.linalg.norm(r, dim=-1) / torch.linalg.norm(b.double(), dim=-1)).max())

    # the kernel's own padding (157 -> 160 rows in shared memory) on the
    # unpadded systems, held against the plain solve
    ju, ru = jtj.contiguous(), jtr.contiguous()
    x_unpadded = psd.damped_chol_solve_plain(ju, damp, ru)
    x_k23 = psd.damped_chol_solve(ju, damp, ru)
    res_u = relres(x_k23, ju, damp, ru)
    x_rel_u = float((x_k23 - x_unpadded).abs().max() / x_unpadded.abs().max())
    print(f"K2+K3 damped_chol_solve_kernel (B={ju.shape[0]}, n={ju.shape[1]} unpadded, "
          f"full-stack normal equations): max rel. residual {res_u:.3e} (tol "
          f"{PSD_RELRES_TOL:.0e}); max|x - x_plain| {x_rel_u:.3e} of max|x| (tol {PSD_X_TOL:.0e})")
    if not (res_u <= PSD_RELRES_TOL and x_rel_u <= PSD_X_TOL):
        raise AssertionError("damped_chol_solve_kernel disagrees with the plain solve on the "
                             "full stack's unpadded systems")
    numbers = {}
    for name, x, plain in (("K5a chol_solve -> damped_chol_solve_kernel", xs["K5a"],
                            chol.chol_solve_plain),
                           ("K5b chol_solve_blocked -> damped_chol_solve_kernel", xs["K5b"],
                            chol.chol_solve_blocked_plain)):
        x_plain = plain(a, d, b)
        res_k, res_p = relres(x), relres(x_plain)
        err = float((x - x_plain).abs().max())
        x_rel = err / float(x_plain.abs().max())
        to_unpadded = float((x[:, :157] - x_unpadded).abs().max() / x_unpadded.abs().max())
        pad_max = float(x[:, 157:].abs().max())
        kernel = chol.chol_solve if name.startswith("K5a") else chol.chol_solve_blocked
        t = in_turns({"kernel": lambda: kernel(a, d, b), "library": library_solve(a, d, b),
                      "plain": lambda: plain(a, d, b)})
        b_k5 = solve_bound(a.shape[0], a.shape[1])
        print(f"{name} (B={a.shape[0]}, n={a.shape[1]} padded from 157, full-stack normal "
              f"equations): max rel. residual kernel {res_k:.3e} / plain {res_p:.3e} (tol "
              f"{PSD_RELRES_TOL:.0e}); max|x - x_plain| = {err:.3e} ({x_rel:.3e} of max|x|, tol "
              f"{PSD_X_TOL:.0e}); against the plain solve unpadded {to_unpadded:.3e} of max|x|; "
              f"padding rows max|x| {pad_max:.1e}; in turns: kernel {t['kernel']:.4f} ms, "
              f"library {t['library']:.4f} ms, plain {t['plain']:.4f} ms; bound "
              f"{b_k5['bound_ms']:.4f} ms ({b_k5['bound_by']})")
        if not (res_k <= PSD_RELRES_TOL and x_rel <= PSD_X_TOL and to_unpadded <= PSD_X_TOL
                and pad_max == 0.0):
            raise AssertionError(f"{name} disagrees with the plain solve")
        numbers[name[:3]] = dict(max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"], **b_k5,
                                 library_ms=t["library"])

    # ROADMAP F1: an indefinite system (its pivot fails in the third panel)
    # comes back all-NaN from every version, its neighbours finite
    bad = a[:4].clone()
    bad[2, 70, 70] = -1e3
    for name, solve in (("K5a", chol.chol_solve), ("K5b", chol.chol_solve_blocked),
                        ("plain", chol.chol_solve_blocked_plain)):
        xb = solve(bad, d[:4].contiguous(), b[:4].contiguous())
        nan_rows = torch.isnan(xb).all(dim=-1).tolist()
        finite_rows = torch.isfinite(xb).all(dim=-1).tolist()
        if nan_rows != [False, False, True, False] or finite_rows != [True, True, False, True]:
            raise AssertionError(f"F1: {name} solve of an indefinite system gave "
                                 f"nan rows {nan_rows}, finite rows {finite_rows}")
    # ROADMAP F6: the blocked entry point refuses n % 32 != 0
    try:
        chol.chol_solve_blocked(jtj.contiguous(), damp, jtr.contiguous())
    except ValueError:
        pass
    else:
        raise AssertionError("F6: chol_solve_blocked took n = 157")
    print("K5 F1: the indefinite system is all-NaN in K5a, K5b and plain, its neighbours "
          "finite; F6: chol_solve_blocked refuses n = 157")
    return counts, numbers


def phase_full_stack(char, efs, targets, q, x0, smi):
    """bench.py's full residual stack at B = 2048: GN 2 full-batch + 1 on the
    worst 1024 by marker energy, through K1 and K2+K3; 3 timed runs."""
    from momentum_tpu_torch.ops import fk as fk_ops, psd
    from momentum_tpu_torch.testing.workloads import make_fullstack_solve

    solve = make_fullstack_solve(char, efs, BATCH)
    solve(targets, q, x0)  # warm-up
    torch.cuda.synchronize()
    fk_ops.launches = psd.launches = 0
    t0 = time.perf_counter()
    params, energy, _ = solve(targets, q, x0)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = {"fk_global_kernel": fk_ops.launches, "damped_chol_solve_kernel": psd.launches}
    for _ in range(2):
        t0 = time.perf_counter()
        solve(targets, q, x0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    e = energy.cpu().numpy()
    conv = float(np.mean(e < 1e-5))
    med = float(np.nanmedian(e))
    div = float(np.mean(~np.isfinite(e)))
    wall = statistics.median(walls)
    print(f"full stack (B={BATCH}, pos + ori + limits + pose prior, GN 2 + 1 on the worst "
          f"1024): marker conv@1e-5 {conv:.4f} (JAX CPU at B=256: {FULLSTACK_CONV_JAX_CPU:.4f}), "
          f"median marker energy {med:.4e} (JAX CPU {FULLSTACK_MEDIAN_JAX_CPU:.4e}), divergent "
          f"{div:.4f}, batch wall {wall * 1e3:.1f} ms (median of {len(walls)}), "
          f"{BATCH / wall:.0f} solves/s on {smi}; kernel launches {counts}")
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"the full stack did not run through every kernel: {counts}")
    if params.shape != x0.shape or not bool(torch.isfinite(params).all()):
        raise AssertionError("full stack: parameters of the wrong shape or not finite")
    if not (div == 0.0 and conv >= FULLSTACK_CONV_JAX_CPU - FULLSTACK_CONV_SLACK):
        raise AssertionError(f"full stack accuracy: divergent {div}, conv@1e-5 {conv}")
    return counts


# K6's launches by the path that ran them, as `_counts(path)` read them
K6_LAUNCHES = {}


def _counts(path=None):
    """K1's and K2+K3's launches since `_reset_counts`; K6's (which most
    paths never launch) go into K6_LAUNCHES under `path`."""
    from momentum_tpu_torch.ops import fk as fk_ops, jacobian as jac_ops, psd

    if path is not None:
        K6_LAUNCHES[path] = jac_ops.launches
    return {"fk_global_kernel": fk_ops.launches, "damped_chol_solve_kernel": psd.launches}


def _reset_counts():
    from momentum_tpu_torch.ops import fk as fk_ops, jacobian as jac_ops, psd

    torch.cuda.synchronize()
    fk_ops.launches = psd.launches = jac_ops.launches = 0


def phase_config2_lm(smi):
    """bench_suite.py config 2: the full stack's single frame by LM (x0 of
    shape (P,): K2+K3 on one system an iteration), then 2b at B = 2048: the
    GN 2 + 1 solve's energy against each element's 40-iteration LM optimum on
    the normal equations (conv_at_1e5, median_excess_vs_40it); both counted.
    2b again at B = 256 (not counted), the batch of the second JAX figure."""
    from momentum_tpu_torch.testing.workloads import (
        build_fullstack_frame, build_fullstack_problem, fullstack_lm_optimum,
        make_fullstack_solve, solve_fullstack_frame)

    char, efs, x0 = build_fullstack_frame(seed=SEED, device="cuda")
    solve_fullstack_frame(char, efs, x0)  # warm-up
    _reset_counts()
    t0 = time.perf_counter()
    res = solve_fullstack_frame(char, efs, x0)
    energy = float(res.error)
    frame_ms = (time.perf_counter() - t0) * 1e3
    frame_counts = counts = _counts("config2_lm")
    if res.params.shape != x0.shape or not bool(torch.isfinite(res.params).all()):
        raise AssertionError("config 2 frame: parameters of the wrong shape or not finite")
    print(f"config 2 frame (full stack, LM {res.iterations} iterations, one system of n = "
          f"{x0.shape[0]}): energy {energy:.6e} (JAX CPU {CONFIG2_FRAME_ENERGY_JAX_CPU:.6e}), "
          f"wall {frame_ms:.1f} ms on {smi}; kernel launches {frame_counts}")
    if not abs(energy / CONFIG2_FRAME_ENERGY_JAX_CPU - 1) <= FRAME_ENERGY_RTOL:
        raise AssertionError(f"config 2 frame: energy {energy} is not within "
                             f"{FRAME_ENERGY_RTOL} of the JAX CPU figure")
    numbers = dict(frame_energy=energy)
    for batch in (BATCH, 256):
        char, efs, targets, q, x0 = build_fullstack_problem(batch, seed=SEED, device="cuda")
        _reset_counts()
        _, marker, err = make_fullstack_solve(char, efs, batch)(targets, q, x0)
        t0 = time.perf_counter()
        ref = fullstack_lm_optimum(char, efs, targets, q, x0)
        excess = (err - ref.error).cpu().numpy()
        lm_ms = (time.perf_counter() - t0) * 1e3
        if batch == BATCH:
            counts = {k: n + frame_counts[k] for k, n in _counts("config2_lm 2b").items()}
        conv, med = float(np.mean(excess < 1e-5)), float(np.median(excess))
        want = CONFIG2B_CONV_JAX_CPU[batch]
        print(f"config 2b (B={batch}, full stack GN 2 + 1 against the {ref.iterations}-iteration "
              f"LM optimum on the normal equations): conv_at_1e5 {conv:.6f} (JAX CPU {want:.6f}), "
              f"median_excess_vs_40it {med:.6e}, marker conv@1e-5 "
              f"{float((marker < 1e-5).float().mean()):.4f}; the LM optimum took {lm_ms:.1f} ms")
        if not (np.isfinite(excess).all() and abs(conv - want) <= CONFIG2B_CONV_SLACK):
            raise AssertionError(f"config 2b at B = {batch}: conv_at_1e5 {conv} is not within "
                                 f"{CONFIG2B_CONV_SLACK} of the JAX CPU figure {want}")
        numbers[f"conv_at_1e5_B{batch}"] = conv
        numbers[f"median_excess_vs_40it_B{batch}"] = med
    print(f"config 2 path (frame LM + 2b at B={BATCH}) kernel launches {counts}")
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"config 2 did not run through every kernel: {counts}")
    return counts, numbers


def phase_vertex_fit(smi):
    """bench_suite.py config 4: 4b at B = 256 (3 timed runs, the first
    counted) and the single frame by LM (counted with it); then K2+K3 at
    config 4b's n = 165 on its own normal equations at x0, held against the
    plain version and timed in turns with the library call."""
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.profile_workload import in_turns, library_solve, solve_bound
    from momentum_tpu_torch.testing.workloads import (
        VERTEX_FIT_BATCH, build_vertex_fit_problem, make_vertex_fit_solve,
        solve_vertex_fit_frame)

    prob = build_vertex_fit_problem(VERTEX_FIT_BATCH, device="cuda")
    batch = prob.x0.shape[0]
    solve = make_vertex_fit_solve(prob.char, prob.ef0, batch)
    solve(prob.targets, prob.x0)  # warm-up
    _reset_counts()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solve(prob.targets, prob.x0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) == 1:
            counts_4b = _counts("vertex_fit 4b")
    _reset_counts()
    frame = solve_vertex_fit_frame(prob.char, prob.ef0, prob.targets_frame,
                                   torch.zeros_like(prob.gt_frame))
    frame_energy = float(frame.error)
    counts_frame = _counts("vertex_fit frame")
    counts = {k: counts_4b[k] + counts_frame[k] for k in counts_4b}
    sq = ((res.params - prob.gt) ** 2).sum(-1).cpu().numpy()
    divergent = int((~np.isfinite(sq)).sum())
    med = float(np.median(sq))
    wall = statistics.median(walls)
    print(f"config 4b (B={batch}, P={prob.char.num_model_parameters}, {prob.ef0.num_rows()} "
          f"vertex rows, GN 4 + 2 on the worst 64): {batch / wall:.0f} solves/s (median wall "
          f"{wall * 1e3:.1f} ms of {len(walls)}) on {smi}; median_param_sq_err {med:.6e} (JAX "
          f"CPU {CONFIG4B_PARAM_SQ_ERR_JAX_CPU:.6e}), divergent {divergent}; kernel launches "
          f"{counts_4b}")
    print(f"config 4 frame (LM {frame.iterations} iterations from zero, one system of n = "
          f"{prob.gt_frame.shape[0]}): energy {frame_energy:.6e} (JAX CPU "
          f"{CONFIG4_FRAME_ENERGY_JAX_CPU:.6e}); kernel launches {counts_frame}")
    if divergent or not 1 / CONFIG4B_FACTOR <= med / CONFIG4B_PARAM_SQ_ERR_JAX_CPU <= CONFIG4B_FACTOR:
        raise AssertionError(f"config 4b: median_param_sq_err {med} not within a factor "
                             f"{CONFIG4B_FACTOR} of the JAX CPU figure, or {divergent} divergent")
    if not abs(frame_energy / CONFIG4_FRAME_ENERGY_JAX_CPU - 1) <= FRAME_ENERGY_RTOL:
        raise AssertionError(f"config 4 frame: energy {frame_energy} is not within "
                             f"{FRAME_ENERGY_RTOL} of the JAX CPU figure")
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"config 4 did not run through every kernel: {counts}")

    fn = SkeletonSolverFunction(prob.char, (dataclasses.replace(prob.ef0, target=prob.targets),))
    rows, j = fn.residual_and_jacobian(prob.x0)
    jt = j.transpose(-1, -2)
    a = (jt @ j).contiguous()
    b = (jt @ rows[..., None])[..., 0].contiguous()
    d = torch.full_like(b, 1e-5)  # 4b's GN regularization
    x = psd.damped_chol_solve(a, d, b)
    x_plain = psd.damped_chol_solve_plain(a, d, b)
    ad = (a + torch.diag_embed(d)).double()
    r = (ad @ x.double()[..., None])[..., 0] - b.double()
    relres = float((torch.linalg.norm(r, dim=-1) / torch.linalg.norm(b.double(), dim=-1)).max())
    err = float((x - x_plain).abs().max())
    # the blend-shape columns are ~1e-2 of the pose columns and the damping
    # 1e-5: x is held by its forward error against the float64 solve, next
    # to the plain float32 solve's own, not by PSD_X_TOL
    x64 = psd.damped_chol_solve_plain(a.double(), d.double(), b.double())
    fwd = {name: float((sol.double() - x64).abs().max() / x64.abs().max())
           for name, sol in (("kernel", x), ("plain", x_plain))}
    t = in_turns({"kernel": lambda: psd.damped_chol_solve(a, d, b),
                  "library": library_solve(a, d, b),
                  "plain": lambda: psd.damped_chol_solve_plain(a, d, b)})
    b_psd = solve_bound(*a.shape[:2])
    print(f"K2+K3 damped_chol_solve_kernel (B={a.shape[0]}, n={a.shape[1]}, config 4b's normal "
          f"equations at x0): max rel. residual {relres:.3e} (tol {PSD_RELRES_TOL:.0e}); "
          f"max|x - x_plain| {err / float(x_plain.abs().max()):.3e} of max|x|; forward error "
          f"against float64 kernel {fwd['kernel']:.3e} / plain {fwd['plain']:.3e} (kernel's "
          f"tol: {X_FWD_FACTOR:.0f}x the plain's, at least {PSD_X_TOL:.0e}); in turns: kernel "
          f"{t['kernel']:.4f} ms, library {t['library']:.4f} ms, plain {t['plain']:.4f} ms; "
          f"bound {b_psd['bound_ms']:.4f} ms ({b_psd['bound_by']}), "
          f"{b_psd['bound_ms'] / t['kernel']:.1%} of it")
    if not (relres <= PSD_RELRES_TOL
            and fwd["kernel"] <= max(PSD_X_TOL, X_FWD_FACTOR * fwd["plain"])):
        raise AssertionError("damped_chol_solve_kernel disagrees with the plain solve on "
                             "config 4b's normal equations")
    numbers = dict(solves_per_s=batch / wall, median_param_sq_err=med, divergent=divergent,
                   frame_energy=frame_energy,
                   psd_256x165=dict(max_abs_err=err, forward_error=fwd, ms=t["kernel"],
                                    plain_ms=t["plain"], **b_psd, library_ms=t["library"]))
    return counts, numbers


def _hold_psd_matrix(a, d, b, label):
    """K2+K3 on (B, n, n) systems with (B, n, k) or (B, n) right-hand sides, held
    against the plain version by the rule for ill-conditioned systems:
    its relative residual and its forward error against the float64 solve
    each within X_FWD_FACTOR of the plain float32 solve's (at least
    PSD_RELRES_TOL and PSD_X_TOL). A SPIKE step's Schur complement, its
    spike columns ~1e-3 of the rest, leaves the plain solve itself a
    residual of ~2e-3 in some columns (config 5, measured on one H100). The kernel,
    the library's cholesky_ex + cholesky_solve and the plain version timed
    in turns; the bound. The device time sums the call's kernels: the
    factor and, for k > 1, the substitution."""
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.testing.profile_workload import (
        fmt_ms, in_turns, kernel_device_ms, library_solve, solve_bound)

    batch, n = b.shape[:2]
    k = b.shape[2] if b.ndim == 3 else 1
    x = psd.damped_chol_solve(a, d, b)
    x_plain = psd.damped_chol_solve_plain(a, d, b)
    res_k, res_p = _relres_cols(a, d, b, x), _relres_cols(a, d, b, x_plain)
    err = float((x - x_plain).abs().max())
    x64 = psd.damped_chol_solve_plain(a.double(), d.double(), b.double())
    fwd = {name: float((sol.double() - x64).abs().max() / x64.abs().max())
           for name, sol in (("kernel", x), ("plain", x_plain))}
    t = in_turns({"kernel": lambda: psd.damped_chol_solve(a, d, b),
                  "library": library_solve(a, d, b),
                  "plain": lambda: psd.damped_chol_solve_plain(a, d, b)})
    kernels = psd.KERNELS[:1 if k == 1 else 2]
    dev_ms = kernel_device_ms(lambda: psd.damped_chol_solve(a, d, b), kernels,
                              per_call=len(kernels))
    b_psd = solve_bound(batch, n, k)
    print(f"K2+K3 {' + '.join(kernels)} (B={batch}, n={n}, k={k}, {label}): max rel. "
          f"residual kernel {res_k:.3e} / plain {res_p:.3e} (kernel's tol: {X_FWD_FACTOR:.0f}x "
          f"the plain's, at least {PSD_RELRES_TOL:.0e}); max|x - x_plain| "
          f"{err / float(x_plain.abs().max()):.3e} of max|x|; forward error "
          f"against float64 kernel {fwd['kernel']:.3e} / plain {fwd['plain']:.3e} (kernel's "
          f"tol: {X_FWD_FACTOR:.0f}x the plain's, at least {PSD_X_TOL:.0e}); in turns: kernel "
          f"{t['kernel']:.4f} ms, library {t['library']:.4f} ms, plain {t['plain']:.4f} ms; "
          f"device time kernel {fmt_ms(dev_ms)} ms; bound {b_psd['bound_ms']:.4f} ms "
          f"({b_psd['bound_by']}), {b_psd['bound_ms'] / t['kernel']:.1%} of it")
    if not (res_k <= max(PSD_RELRES_TOL, X_FWD_FACTOR * res_p)
            and fwd["kernel"] <= max(PSD_X_TOL, X_FWD_FACTOR * fwd["plain"])):
        raise AssertionError(f"damped_chol_solve_kernel disagrees with the plain solve on "
                             f"{label}")
    return dict(max_abs_err=err, forward_error=fwd, ms=t["kernel"], plain_ms=t["plain"],
                **b_psd, library_ms=t["library"], device_ms=dev_ms, batch_n_k=[batch, n, k])


def _sequence_systems(fn, pf, u, k):
    """The (a, damp, b) of the last K2+K3 call with k right-hand sides in one
    GN iteration of solve_sequence: a SPIKE forward step's Schur complement
    as the sequence path assembles it."""
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.sequence import solve_sequence
    from momentum_tpu_torch.solver import SolverOptions

    seen = []
    real = psd.damped_chol_solve

    def record(a, damp, b):
        if b.ndim == 3 and b.shape[-1] == k:
            seen[:] = [(a.clone(), damp.clone(), b.clone())]
        return real(a, damp, b)

    psd.damped_chol_solve = record
    try:
        solve_sequence(fn, pf, u, SolverOptions(max_iterations=1))
    finally:
        psd.damped_chol_solve = real
    if not seen:
        raise AssertionError(f"the sequence solve gave K2+K3 no system with {k} right-hand sides")
    return seen[0]


def phase_sequence(smi):
    """bench_suite.py config 5 (16-joint test rig) and 5f (full-body rig) at
    F = 1024: GN 8 on the block-banded normal equations, SPIKE with 32 parts
    whose batched Thomas steps run K2+K3 on (32, p, p) systems; the frame
    contexts through K1. For each: frames/s (F over the median wall of 3
    warm solves, the first counted), the final error against JAX CPU's, the
    wall of one GN iteration, the device idle share of a profiled solve, the
    peak device memory; K1 held at B = 1024 on the rig; K2+K3 held at the
    SPIKE forward step's shape on a system of the path."""
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.solver import SolverOptions
    from momentum_tpu_torch.testing.profile_workload import device_busy
    from momentum_tpu_torch.testing.workloads import build_sequence_problem, make_sequence_solve

    counts, numbers = {}, {}
    for name, fullbody in (("5", False), ("5f", True)):
        prob = build_sequence_problem(SEQUENCE_FRAMES, fullbody=fullbody, device="cuda")
        fn, frames = prob.fn, SEQUENCE_FRAMES
        solve = make_sequence_solve(fn)
        solve(prob.pf0, prob.u0)  # warm-up
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = solve(prob.pf0, prob.u0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if len(walls) == 1:
                counts[name] = _counts(f"sequence {name}")
                peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        wall = statistics.median(walls)
        one = make_sequence_solve(fn, SolverOptions(max_iterations=1))
        it_walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            one(prob.pf0, prob.u0)
            torch.cuda.synchronize()
            it_walls.append(time.perf_counter() - t0)
        prof_wall, busy_ms, _ = device_busy(lambda: solve(prob.pf0, prob.u0))
        idle = None if busy_ms is None else 1 - busy_ms / (prof_wall * 1e3)
        err, want = float(res.error), SEQUENCE_ERROR_JAX_CPU[name]
        p, nu = fn.num_per_frame, fn.num_universal
        print(f"config {name} (F={frames}, P={fn.character.num_model_parameters}, per-frame "
              f"{p}, universal {nu}, GN {res.iterations}): {frames / wall:.1f} frames/s "
              f"(median wall {wall * 1e3:.1f} ms of {len(walls)}) on {smi}; final error "
              f"{err:.6e} (JAX CPU {want:.6e}), iterations {res.iterations} (JAX CPU "
              f"{SEQUENCE_ITERATIONS_JAX_CPU}), converged {bool(res.converged)}; one GN "
              f"iteration {statistics.median(it_walls) * 1e3:.1f} ms; device busy "
              + (f"{busy_ms:.1f} of {prof_wall * 1e3:.1f} ms profiled, idle share {idle:.3f}; "
                 if busy_ms is not None else "not measured (the profile saw no device time); ")
              + f"peak memory {peak_gb:.3f} GiB; kernel launches {counts[name]}")
        if res.per_frame.shape != prob.pf0.shape or not bool(torch.isfinite(res.per_frame).all()):
            raise AssertionError(f"config {name}: parameters of the wrong shape or not finite")
        if not (abs(err / want - 1) <= SEQUENCE_RTOL
                and res.iterations == SEQUENCE_ITERATIONS_JAX_CPU):
            raise AssertionError(f"config {name}: final error {err} not within {SEQUENCE_RTOL} "
                                 f"of the JAX CPU figure {want}, or {res.iterations} iterations")
        if any(n == 0 for n in counts[name].values()):
            raise AssertionError(f"config {name} did not run through every kernel: "
                                 f"{counts[name]}")
        skel = fn.character.skeleton
        local = fk.local_skel_states(
            skel, fn.character.parameter_transform.apply(prob.gt)).contiguous()
        k = nu + 1 + 3 * p  # [b_prev | rhs | left spike | right spike] of a forward step
        numbers[name] = dict(
            frames_per_s=frames / wall, error=err, iterations=res.iterations,
            converged=bool(res.converged), gn_iteration_ms=statistics.median(it_walls) * 1e3,
            device_busy_ms=busy_ms, profiled_wall_ms=prof_wall * 1e3, idle_share=idle,
            peak_memory_gib=peak_gb,
            fk=_hold_fk(skel, local, f"config {name}'s frames"),
            psd=_hold_psd_matrix(*_sequence_systems(fn, prob.pf0, prob.u0, k),
                                 f"config {name}'s SPIKE forward step"))
        del prob, fn, solve, one, res
    return counts, numbers


def phase_sequence_accel():
    """K1 under forward mode on the card: the full-body sequence at F = 256
    with an acceleration term (window 3, so q = 2 and banded_to_tridiag
    runs) on the position targets and motion smoothness. Its normal
    equations at the truth, whose window Jacobians push 3·156 + 1 tangents
    through FK by K1's jvp and vmap rules, held against the same with FK on
    fk_global_plain; then one GN step of the whole solve."""
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.sequence import AccelerationSequenceErrorFunction, solve_sequence
    from momentum_tpu_torch.sequence.solver import _normal_equations
    from momentum_tpu_torch.solver import SolverOptions
    from momentum_tpu_torch.testing.workloads import build_sequence_problem

    prob = build_sequence_problem(ACCEL_FRAMES, fullbody=True, device="cuda")
    nj = prob.fn.character.skeleton.num_joints
    fn = dataclasses.replace(prob.fn, sequence_errors=prob.fn.sequence_errors + (
        AccelerationSequenceErrorFunction.create(nj, weight=0.5, device="cuda"),))
    pf, u = fn.split(prob.gt)
    systems, launches, peak_gb = {}, {}, {}
    for name in ("kernel", "plain"):
        if name == "plain":
            real, fk_ops.fk_global = fk_ops.fk_global, fk_ops.fk_global_plain
        try:
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            systems[name] = _normal_equations(fn, pf, u)
            torch.cuda.synchronize()
            launches[name] = _counts()["fk_global_kernel"]
            peak_gb[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        finally:
            if name == "plain":
                fk_ops.fk_global = real
    (dk, ok, uck, ubk, rfk, ruk, q), (dp, op, ucp, ubp, rfp, rup, _) = (
        systems["kernel"], systems["plain"])
    pairs = {"diag": (dk, dp), "u_coupling": (uck, ucp), "u_block": (ubk, ubp),
             "rhs_f": (rfk, rfp), "rhs_u": (ruk, rup),
             **{f"offs[{d}]": (a, b) for d, (a, b) in enumerate(zip(ok, op), 1)}}
    rel = {k: float((a - b).abs().max() / b.abs().max()) for k, (a, b) in pairs.items()}
    res = solve_sequence(fn, *fn.split(torch.zeros_like(prob.gt)), SolverOptions(max_iterations=1))
    print(f"sequence with acceleration (5f rig, F={ACCEL_FRAMES}, windows 2 and 3, q={q}): "
          f"normal equations through K1 ({launches['kernel']} launches) against FK on "
          f"fk_global_plain ({launches['plain']}): max|Δ| / max|block| "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (tol {SEQUENCE_NE_RTOL:.0e}); peak memory {peak_gb['kernel']:.3f} GiB through "
          f"K1, {peak_gb['plain']:.3f} plain; "
          f"one GN step from zero: error {float(res.error):.6e}")
    if q != 2 or launches["kernel"] == 0 or launches["plain"] != 0:
        raise AssertionError(f"acceleration sequence: q = {q}, K1 launches {launches}")
    if not all(v <= SEQUENCE_NE_RTOL for v in rel.values()):
        raise AssertionError(f"acceleration sequence: the normal equations through K1 "
                             f"disagree with the plain FK's: {rel}")
    if not bool(torch.isfinite(res.per_frame).all()):
        raise AssertionError("acceleration sequence: the GN step is not finite")
    return dict(max_rel_err=rel, fk_launches=launches["kernel"], peak_memory_gib=peak_gb)


def _hold_ad_jacobian(char, markers, x):
    """The forward-mode Jacobian of config 6s's marker rows at x (B, 73)
    (solver/gauss_newton.py::ad_jacobian: FK's primal through K1, its
    tangents by K1's jvp and vmap rules) against the analytic one, to
    AD_JAC_RTOL of max|J|; K1's launches in one call; both timed."""
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian
    from momentum_tpu_torch.testing.profile_workload import event_ms
    from momentum_tpu_torch.tracking import TrackingConfig
    from momentum_tpu_torch.tracking.tracker import _marker_error_template

    ef0, per_frame = _marker_error_template(char, markers, TrackingConfig())
    fn = SkeletonSolverFunction(char, (per_frame(ef0, markers.positions, markers.occluded),))
    _reset_counts()
    rows_ad, jt_ad = ad_jacobian(fn.residual, x)
    torch.cuda.synchronize()
    k1 = fk_ops.launches
    rows, jac = fn.residual_and_jacobian(x)
    err = float((jt_ad.transpose(-1, -2) - jac).abs().max() / jac.abs().max())
    row_err = float((rows_ad - rows).abs().max() / rows.abs().max())
    ms_ad = event_ms(lambda: ad_jacobian(fn.residual, x), reps=3, samples=3)
    ms_an = event_ms(lambda: fn.residual_and_jacobian(x), reps=3, samples=3)
    print(f"AD Jacobian (config 6s's marker rows, B={x.shape[0]}, R={rows.shape[-1]}, "
          f"P={x.shape[-1]}): forward mode through K1 ({k1} K1 launches a call) against the "
          f"analytic Jacobian: max|ΔJ| {err:.3e} of max|J| (tol {AD_JAC_RTOL:.0e}), rows "
          f"{row_err:.3e}; wall {ms_ad:.2f} ms a call, the analytic {ms_an:.2f} ms")
    if not (err <= AD_JAC_RTOL and row_err <= AD_JAC_RTOL and k1 >= 1):
        raise AssertionError(f"the AD Jacobian through K1 disagrees with the analytic one "
                             f"({err}, rows {row_err}) or launched K1 {k1} times")
    return dict(max_rel_err=err, k1_launches_per_call=k1, ms=ms_ad, analytic_ms=ms_an,
                batch=x.shape[0])


def _tracking_systems(char, markers, identity, motion):
    """The (a, damp, b) of the last K2+K3 call of an LM solve of config 6s
    at the two shapes its path gives K2+K3: one frame ((1, 73), per-frame
    tracking from `identity`) and every frame ((343, 73), the batched
    refine from `motion`)."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.tracking import MarkerSequence, track_poses_batched

    seen = {}
    real = psd.damped_chol_solve

    def record(a, damp, b):
        seen[a.shape[0]] = (a.clone(), damp.clone(), b.clone())
        return real(a, damp, b)

    psd.damped_chol_solve = record
    try:
        one = MarkerSequence(markers.positions[:1], markers.occluded[:1], markers.names)
        w.track_clip_per_frame(char, one, identity)
        cfg = dataclasses.replace(w._tracking_configs()[1], max_iter=2)
        track_poses_batched(char, markers, cfg, initial=motion)
    finally:
        psd.damped_chol_solve = real
    return seen[1], seen[markers.num_frames]


def phase_tracking(smi):
    """benchmarks/bench_suite.py config 6 (:441-560) on config 6s, the
    synthetic 343-frame × 41-marker clip on the CMU rig (73 parameters, mm):
    calibration (10 frames, 2 rounds of LM 25 and the scale's sequence
    solve), the locators-only round, then, from JAX CPU's calibrated rig and
    identity, per-frame tracking (LM 15, each frame warm-started), the
    smoothed refine of JAX CPU's per-frame motion (GN 10 with line search,
    float64 normal equations) and hierarchical batched tracking (keyframes
    every 8, then LM 10 + 5 on the worst 64). Every pose solve takes its
    Jacobian by
    forward mode (ad_jacobian), FK through K1, damped solves through K2+K3.
    Per stage: frames/s (the clip's 343 frames over the stage's wall), the
    median and p90 marker error against JAX CPU's, the K1 and K2+K3
    launches; the calibrated scale_global against JAX CPU's. Then the AD
    Jacobian held against the analytic one at B = 343, K1 held at B = 1
    and 343, K2+K3 held and timed at (1, 73) and (343, 73) on systems of
    the path. The idle share comes from profile_workload --workload
    tracking: after a profile of 16 frames of per-frame tracking here, the
    next profiles saw no kernel at all (on one H100)."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.character import fk

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, TRACKING_JAX_CPU_FILE)) as f:
        jax_cpu = json.load(f)
    jax_motion = torch.as_tensor(np.load(os.path.join(here, TRACKING_JAX_CPU_MOTION_FILE)),
                                 device="cuda")
    clip = w.build_tracking_clip(w.TRACKING_FRAMES, seed=SEED, device="cuda")
    markers, frames = clip.markers, clip.markers.num_frames
    sampled = w.calibration_frames(frames)
    counts, numbers = {}, {}

    def stage(name, run, char_of, rows=slice(None)):
        _reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = _counts(f"tracking {name}")
        char, motion = char_of(out)
        d = w.clip_marker_errors_mm(char, markers, motion, rows)
        med, p90 = float(np.median(d)), float(np.percentile(d, 90))
        want = jax_cpu[name]
        med_rtol = (TRACKING_CALIBRATION_MEDIAN_RTOL if name in ("calibrate", "locators")
                    else TRACKING_MEDIAN_RTOL)
        n_solves = counts[name]["damped_chol_solve_kernel"]
        print(f"config 6s {name}: {frames / wall:.2f} frames/s (wall {wall:.2f} s) on {smi}; "
              f"marker error median {med:.4f} mm (JAX CPU {want['median_mm']:.4f}), p90 "
              f"{p90:.4f} mm (JAX CPU {want['p90_mm']:.4f}); kernel launches {counts[name]}"
              + (f"; {wall / n_solves * 1e3:.2f} ms per K2+K3 launch" if n_solves else ""))
        if not (bool(torch.isfinite(motion).all())
                and abs(med - want["median_mm"]) <= max(med_rtol * want["median_mm"],
                                                        TRACKING_MEDIAN_ATOL_MM)
                and abs(p90 - want["p90_mm"]) <= TRACKING_P90_RTOL * want["p90_mm"]):
            raise AssertionError(f"config 6s {name}: marker error median {med} / p90 {p90} "
                                 f"not within tolerance of JAX CPU's {want}")
        numbers[name] = dict(frames_per_s=frames / wall, wall_s=wall, median_mm=med,
                             p90_mm=p90, launches=counts[name])
        return out

    identity, _ = stage("calibrate", lambda: w.calibrate_clip(clip),
                        lambda o: (clip.char, o[1]), sampled)
    scale, want_scale = float(identity[6]), jax_cpu["scale_global"]
    print(f"config 6s calibrated scale_global {scale:.6f} (JAX CPU {want_scale:.6f}, tol "
          f"{TRACKING_SCALE_TOL:.0e}; the clip's truth {TRACKING_TRUE_SCALE}, |Δ| "
          f"{abs(scale - TRACKING_TRUE_SCALE):.6f})")
    if not abs(scale - want_scale) <= TRACKING_SCALE_TOL:
        raise AssertionError(f"config 6s: scale_global {scale} not within {TRACKING_SCALE_TOL} "
                             f"of JAX CPU's {want_scale}")
    char2, _ = stage("locators", lambda: w.calibrate_clip_locators(clip, identity),
                     lambda o: o, sampled)
    # the tracking stages start from JAX's calibrated rig and identity
    jax_offsets = torch.as_tensor(jax_cpu["locator_offsets"], device="cuda")
    jax_identity = torch.as_tensor(jax_cpu["identity"], device="cuda")
    shift = float((char2.locators.offset - jax_offsets).abs().max())
    print(f"config 6s calibration against JAX CPU's: locator offsets max|Δ| {shift:.3f} mm, "
          f"identity max|Δ| {float((identity - jax_identity).abs().max()):.3e}")
    rig = dataclasses.replace(clip.char, locators=dataclasses.replace(clip.char.locators,
                                                                      offset=jax_offsets))
    stage("per_frame", lambda: w.track_clip_per_frame(rig, markers, jax_identity),
          lambda o: (rig, o.motion))
    stage("refine", lambda: w.refine_clip(rig, markers, jax_motion), lambda o: (rig, o.motion))
    hier = stage("hierarchical", lambda: w.track_clip_hierarchical(rig, markers, jax_identity),
                 lambda o: (rig, o.motion))
    char2, identity = rig, jax_identity
    total = {k: sum(c[k] for c in counts.values()) for k in counts["per_frame"]}
    if any(n == 0 for n in total.values()):
        raise AssertionError(f"config 6s did not run through every kernel: {counts}")

    numbers.update(scale_global=scale,
                   ad_jacobian=_hold_ad_jacobian(char2, markers, hier.motion))
    skel = char2.skeleton
    local = fk.local_skel_states(skel, char2.parameter_transform.apply(hier.motion)).contiguous()
    fk_numbers = {b: _hold_fk(skel, local[:b].contiguous(), f"config 6s, B = {b}")
                  for b in (1, frames)}
    one, every = _tracking_systems(char2, markers, identity, hier.motion)
    psd_numbers = {"1x73": _hold_psd_matrix(*one, "config 6s per-frame LM step"),
                   f"{frames}x73": _hold_psd_matrix(*every, "config 6s batched LM step")}
    return counts, numbers, fk_numbers, psd_numbers


def _hold_ad_rows(solver_fn, x, label, rtol=AD_K1_RTOL):
    """The forward-mode Jacobian of solver_fn's rows at x (B, P) with FK's
    primal on K1 against the same with FK on fk_global_plain, to `rtol` of
    max|J| (AD_K1_RTOL by default); K1's launches in the first."""
    from momentum_tpu_torch.ops import fk as fk_ops
    from momentum_tpu_torch.solver.gauss_newton import ad_jacobian

    out, launches = {}, {}
    for name in ("kernel", "plain"):
        if name == "plain":
            real, fk_ops.fk_global = fk_ops.fk_global, fk_ops.fk_global_plain
        try:
            _reset_counts()
            out[name] = ad_jacobian(solver_fn.residual, x)
            torch.cuda.synchronize()
            launches[name] = _counts()["fk_global_kernel"]
        finally:
            if name == "plain":
                fk_ops.fk_global = real
    (rk, jk), (rp, jp) = out["kernel"], out["plain"]
    err = float((jk - jp).abs().max() / jp.abs().max())
    row_err = float((rk - rp).abs().max() / rp.abs().max())
    print(f"forward-mode rows of {label} (B={x.shape[0]}, R={rk.shape[-1]}, P={x.shape[-1]}) "
          f"through K1 ({launches['kernel']} launches) against fk_global_plain "
          f"({launches['plain']}): max|ΔJ| {err:.3e} of max|J|, rows {row_err:.3e} (tol "
          f"{rtol:.0e})")
    if not (err <= rtol and row_err <= rtol and launches["kernel"] >= 1
            and launches["plain"] == 0):
        raise AssertionError(f"{label}: forward-mode rows through K1 disagree with the plain "
                             f"FK's ({err}, rows {row_err}) or launches {launches}")
    return dict(max_rel_err=err, rows_rel_err=row_err, k1_launches=launches["kernel"],
                batch=x.shape[0])


def _record_systems(run):
    """Every (a, damp, b) that `run()` gives K2+K3, the last of each shape
    (of a, and b's column count), cloned."""
    from momentum_tpu_torch.ops import psd

    seen = {}
    real = psd.damped_chol_solve

    def record(a, damp, b):
        key = tuple(a.shape) + ((b.shape[-1],) if b.ndim == a.ndim else ())
        seen[key] = (a.clone(), damp.clone(), b.clone())
        return real(a, damp, b)

    psd.damped_chol_solve = record
    try:
        run()
    finally:
        psd.damped_chol_solve = real
    return seen


def _last_system(run, batch):
    """The (a, damp, b) of the last K2+K3 call of `run()` on `batch` systems
    (of the first shape seen at that batch)."""
    seen = [v for k, v in _record_systems(run).items() if k[0] == batch]
    if not seen:
        raise AssertionError(f"the path gave K2+K3 no system at B = {batch}")
    return seen[0]


def phase_catalog(smi):
    """Config C: batched IK at B = 2048 over every rigid module of the
    catalog on the full-body rig (workloads.build_catalog_ik_problem): LM 10
    through solve_ik on the normal equations, the blockwise analytic
    Jacobians and forward mode for CameraProjection, PlaneCollision and the
    Union; K1 every context, K2+K3 at (2048, 157). Figures on the first 256
    elements against JAX CPU's and on all 2048: each module's median final
    energy, conv_at_1e5 (against the solve continued 20 iterations), the
    divergent count; solves/s (the median of 3 warm solves) and the peak
    memory (the idle share comes from profile_workload --workload catalog).
    Then K2+K3 held at (2048, 157) on the path's normal equations and the
    forward-mode rows held through K1 against the plain FK."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, CATALOG_JAX_CPU_FILE)) as f:
        want = json.load(f)
    problem = w.build_catalog_ik_problem(w.CATALOG_BATCH, seed=SEED, device="cuda")
    batch = problem.x0.shape[0]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = w.solve_catalog(problem)
    torch.cuda.synchronize()
    counts = _counts("catalog")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    walls = []
    for _ in range(3):  # warm
        t0 = time.perf_counter()
        w.solve_catalog(problem)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    more = w.solve_catalog(problem, x0=res.params, iterations=w.CATALOG_MORE)
    held = w.catalog_figures(problem, res.params, more.params, slice(0, CATALOG_HELD))
    full = w.catalog_figures(problem, res.params, more.params)
    print(f"config C (catalog IK, B={batch}, P={problem.x0.shape[-1]}, "
          f"{len(problem.modules)} modules, LM {w.CATALOG_ITERATIONS}): {batch / wall:.1f} "
          f"solves/s (median wall {wall:.3f} s of 3 warm runs) on {smi}; peak memory "
          f"{peak_gb:.3f} GiB; kernel launches {counts}")
    floor = CATALOG_MEDIAN_FLOOR * want["median_energy"]["total"]
    bad = []
    for label, jax_med in want["median_energy"].items():
        med = held["median_energy"][label]
        ok = abs(med - jax_med) <= CATALOG_MEDIAN_RTOL * jax_med + floor
        bad += [] if ok else [label]
        print(f"  config C {label}: median final energy {med:.6e} on the first "
              f"{CATALOG_HELD} (JAX CPU {jax_med:.6e}){'' if ok else ' OUT OF TOLERANCE'}; "
              f"all {batch}: {full['median_energy'][label]:.6e}")
    print(f"  config C conv_at_1e5 {held['conv_at_1e5']:.4f} on the first {CATALOG_HELD} "
          f"(JAX CPU {want['conv_at_1e5']:.4f}), {full['conv_at_1e5']:.4f} on all {batch}; "
          f"divergent {held['divergent']} / {full['divergent']} (JAX CPU {want['divergent']})")
    if bad or abs(held["conv_at_1e5"] - want["conv_at_1e5"]) > CATALOG_CONV_SLACK \
            or full["divergent"] or any(n == 0 for n in counts.values()):
        raise AssertionError(f"config C: medians {bad} out of tolerance, conv_at_1e5 "
                             f"{held['conv_at_1e5']} (JAX CPU {want['conv_at_1e5']}), divergent "
                             f"{full['divergent']}, or launches {counts}")
    efs = tuple(ef for _, ef in problem.modules)
    fn = SkeletonSolverFunction(problem.char, efs)
    ad_fn = SkeletonSolverFunction(problem.char, tuple(ef for ef in efs
                                                       if not ef.has_analytic_jacobian))
    numbers = dict(solves_per_s=batch / wall, wall_s=wall, peak_memory_gib=peak_gb,
                   first_256=held, all=full, launches=counts,
                   ad_rows=_hold_ad_rows(ad_fn, problem.x0, "config C's forward-mode modules"))
    a, b = fn.normal_equations(problem.x0)[:2]
    damp = (0.01 * torch.clamp(a.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5).contiguous()
    psd_numbers = _hold_psd_matrix(a.contiguous(), damp, b.contiguous(),
                                   "config C's normal equations at the warm starts")
    return counts, numbers, psd_numbers


def phase_keypoints(smi):
    """Config 6k: config 6s's 343-frame clip and the keypoints of four
    cameras about 4 m from the walk (pinhole, two OpenCV, fisheye; 1280 × 720;
    the truth locators' projections + N(0, 1 px), 5% unobserved), from JAX
    CPU's config 6s calibration: track_poses_batched of every frame with
    markers and keypoints (LM 15, projection weight 1.5) from the calibrated
    identity, and refine_motion of JAX CPU's per-frame motion with them.
    Per stage frames/s, the median and p90 marker error (mm) and the median
    reprojection error (px) against JAX CPU's, the launches (the idle share
    comes from profile_workload --workload keypoints). Then the forward-mode rows of the keypoint solve
    held through K1 against the plain FK at B = 343, and K2+K3 held at
    (343, 73) on a system of the batched stage."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.tracking import tracker

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, KEYPOINTS_JAX_CPU_FILE)) as f:
        want = json.load(f)
    with open(os.path.join(here, TRACKING_JAX_CPU_FILE)) as f:
        jax_6s = json.load(f)
    jax_motion = torch.as_tensor(np.load(os.path.join(here, TRACKING_JAX_CPU_MOTION_FILE)),
                                 device="cuda")
    clip = w.build_tracking_clip(w.TRACKING_FRAMES, seed=SEED, device="cuda")
    keypoints = w.build_keypoint_clip(clip, seed=SEED)
    markers, frames = clip.markers, clip.markers.num_frames
    rig = dataclasses.replace(clip.char, locators=dataclasses.replace(
        clip.char.locators, offset=torch.as_tensor(jax_6s["locator_offsets"], device="cuda")))
    identity = torch.as_tensor(jax_6s["identity"], device="cuda")
    counts, numbers = {}, {}

    def stage(name, run):
        _reset_counts()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = _counts(f"keypoints {name}")
        d = w.clip_marker_errors_mm(rig, markers, out.motion)
        px = w.clip_reprojection_errors_px(rig, keypoints, out.motion)
        got = dict(median_mm=float(np.median(d)), p90_mm=float(np.percentile(d, 90)),
                   median_px=float(np.median(px)))
        ref = want[name]
        print(f"config 6k {name}: {frames / wall:.2f} frames/s (wall {wall:.2f} s) on {smi}; "
              f"marker error median {got['median_mm']:.4f} mm (JAX CPU {ref['median_mm']:.4f}), "
              f"p90 {got['p90_mm']:.4f} mm (JAX CPU {ref['p90_mm']:.4f}); reprojection error "
              f"median {got['median_px']:.4f} px (JAX CPU {ref['median_px']:.4f}); kernel "
              f"launches {counts[name]}")
        if not (bool(torch.isfinite(out.motion).all())
                and abs(got["median_mm"] - ref["median_mm"])
                <= max(TRACKING_MEDIAN_RTOL * ref["median_mm"], TRACKING_MEDIAN_ATOL_MM)
                and abs(got["p90_mm"] - ref["p90_mm"]) <= TRACKING_P90_RTOL * ref["p90_mm"]
                and abs(got["median_px"] - ref["median_px"])
                <= TRACKING_MEDIAN_RTOL * ref["median_px"]):
            raise AssertionError(f"config 6k {name}: {got} not within tolerance of JAX CPU's "
                                 f"{ref}")
        numbers[name] = dict(frames_per_s=frames / wall, wall_s=wall, launches=counts[name],
                             **got)
        return out

    batched = stage("batched", lambda: w.track_clip_keypoints(rig, markers, keypoints, identity))
    stage("refine", lambda: w.refine_clip_keypoints(rig, markers, keypoints, jax_motion))
    total = {k: sum(c[k] for c in counts.values()) for k in counts["batched"]}
    if any(n == 0 for n in total.values()):
        raise AssertionError(f"config 6k did not run through every kernel: {counts}")
    cfg = w._keypoint_configs()[0]
    solve = tracker._frame_solve(rig, markers, cfg, None, keypoints)
    ef = solve.per_frame(solve.ef0, markers.positions, markers.occluded)
    kp_efs = tuple(pf(e0, t, c) for (e0, pf), (t, c) in zip(solve.kp, solve.kp_data))
    numbers["ad_rows"] = _hold_ad_rows(
        SkeletonSolverFunction(rig, (ef,) + solve.others + kp_efs), batched.motion,
        "config 6k's marker, limit and keypoint modules")
    one_step = dataclasses.replace(cfg, max_iter=2)
    system = _last_system(lambda: tracker.track_poses_batched(
        rig, markers, one_step, initial=identity, camera_keypoints=keypoints), frames)
    psd_numbers = _hold_psd_matrix(*system, "config 6k batched LM step")
    return counts, numbers, psd_numbers


def _phi_leaves(prob):
    """Config D's differentiable inputs: fresh leaves of its targets,
    per-constraint weights and warm starts."""
    return tuple(t.clone().requires_grad_() for t in (prob.targets, prob.cweight, prob.x0))


def _diff_ik_split(fn, theta, mask, g, reg):
    """For fn's inputs that require grad, the CUDA-event times (ms, the median of 3 runs of 3) of the IFT
    backward's three layers at θ*, as solver/diff_ik.py runs them: the
    normal equations (K1 in their context), the damped solve of
    (2·JᵀJ + damp) u = g·mask (K2+K3), and the energy's directional
    derivative along u by forward mode (K1's primal and jvp rule),
    reverse-differentiated in the targets and weights."""
    from momentum_tpu_torch.math.linalg import damped_psd_solve
    from momentum_tpu_torch.solver.diff_ik import _leaves, _swap
    from momentum_tpu_torch.testing.profile_workload import event_ms

    def hessian():
        with torch.no_grad():
            return fn.normal_equations(theta)[0]

    h = 2.0 * hessian() * (mask[:, None] * mask[None, :])
    damp = reg + (1.0 - mask)
    u = damped_psd_solve(h, damp, g * mask) * mask
    leaves = _leaves(fn.error_functions, [])

    def phi_part():
        fresh = [t.detach().requires_grad_() for t in leaves]
        f2 = _swap(fn, {id(t): f for t, f in zip(leaves, fresh)})
        _, de = torch.func.jvp(f2.error, (theta,), (u,))
        return torch.autograd.grad(-de.sum(), fresh)

    return dict(normal_equations_ms=event_ms(hessian, reps=3, samples=3),
                damped_solve_ms=event_ms(lambda: damped_psd_solve(h, damp, g * mask),
                                         reps=3, samples=3),
                phi_gradient_ms=event_ms(phi_part, reps=3, samples=3))


def phase_diff_ik(smi):
    """Config D, differentiable IK at B = 2048 (workloads.build_diff_ik_problem):
    θ* by torch_interop.solve_ik_torch (GN 20 through K1 and K2+K3, the
    prior, scale_global disabled) and the loss Σ w·θ* back-propagated by the
    IFT. Solves/s of the forward and the backward's ms (CUDA events, the
    median of 3 warm calls), the launches of each, the median gradient rmse
    at θ*; on the first 256 elements against JAX CPU's vmapped solve_ik_ift:
    the per-element energy (the median within 20%), ∂L/∂targets per element
    (the median relative L2 error within 5e-2) and, on the elements at a
    stationary point in both, the shares of ∂L/∂targets and ∂L/∂cweight
    within 5e-2 (95% at least), the relative L2 error pooled over them
    printed; x0's pass-through gradient exact; the same gradients through solve_ik_ift directly, to rounding.
    The backward's K2+K3 solve at (2048, 157) held against the plain one;
    one split of the backward into its three layers."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.solver import gradient_rmse, solve_ik_ift

    here = os.path.dirname(os.path.abspath(__file__))
    ref = np.load(os.path.join(here, DIFFIK_JAX_CPU_ARRAYS))
    prob = w.build_diff_ik_problem(w.DIFF_IK_BATCH, seed=SEED, device="cuda")
    batch = prob.x0.shape[0]

    def forward():
        t, c, x0 = _phi_leaves(prob)
        return (t, c, x0), w.solve_diff_ik(prob, t, c, x0)

    def loss(theta):
        return (theta * prob.w).sum()

    leaves, theta = forward()  # warm-up
    loss(theta).backward()
    fwd_ms, bwd_ms = [], []
    for i in range(3):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        _reset_counts()
        e0.record()
        leaves, theta = forward()
        e1.record()
        torch.cuda.synchronize()
        if i == 0:
            fwd_counts = _counts("diff_ik fwd")
            _reset_counts()
        loss(theta).backward()
        e2.record()
        torch.cuda.synchronize()
        if i == 0:
            bwd_counts = _counts("diff_ik bwd")
        fwd_ms.append(e0.elapsed_time(e1))
        bwd_ms.append(e1.elapsed_time(e2))
    fwd, bwd = statistics.median(fwd_ms), statistics.median(bwd_ms)
    t, c, x0 = leaves
    theta = theta.detach()
    fn = w.diff_ik_solver_fn(prob, {"targets": prob.targets, "cweight": prob.cweight})
    energy = fn.error(theta)
    rmse = gradient_rmse(fn, theta, prob.mask)
    held = slice(0, DIFFIK_HELD)
    e_t, e_j = energy[held].cpu().double().numpy(), ref["energy"][held].astype(np.float64)
    g_t = t.grad[held].cpu().double().numpy().reshape(DIFFIK_HELD, -1)
    g_j = ref["grad_targets"][held].astype(np.float64).reshape(DIFFIK_HELD, -1)
    rel_t = np.linalg.norm(g_t - g_j, axis=-1) / np.linalg.norm(g_j, axis=-1)
    stationary = ((rmse[held].cpu().numpy() <= DIFFIK_STATIONARY)
                  & (ref["gradient_rmse"][held] <= DIFFIK_STATIONARY))
    c_t = c.grad[held].cpu().double().numpy()
    c_j = ref["grad_cweight"][held].astype(np.float64)
    rel_c = np.linalg.norm(c_t - c_j, axis=-1) / np.linalg.norm(c_j, axis=-1)
    pooled_c = float(np.linalg.norm(c_t[stationary] - c_j[stationary])
                     / np.linalg.norm(c_j[stationary]))
    share = {name: float(np.mean(rel[stationary] < DIFFIK_GRAD_TOL))
             for name, rel in (("targets", rel_t), ("cweight", rel_c))}
    x0_bar = x0.grad.clone()
    scale = prob.char.parameter_transform.names.index("scale_global")
    x0_ok = (bool(torch.equal(x0_bar[:, scale], prob.w[:, scale]))
             and float(x0_bar[:, torch.arange(x0_bar.shape[1], device=x0_bar.device) != scale].abs().max()) == 0.0)
    divergent = int((~torch.isfinite(energy)).sum())
    med_e, med_ej = float(np.median(e_t)), float(np.median(e_j))
    print(f"config D (differentiable IK, B={batch}, P={theta.shape[-1]}, GN "
          f"{w.diff_ik_options().max_iterations}, loss sum(w theta*)): forward {batch / fwd * 1e3:.0f} "
          f"solves/s ({fwd:.1f} ms), backward {bwd:.2f} ms (CUDA events, the median of 3 warm "
          f"calls) on {smi}; kernel launches forward {fwd_counts}, backward {bwd_counts}; median "
          f"gradient rmse at theta* {float(rmse.median()):.3e}, {float(rmse[held].median()):.3e} "
          f"on the first {DIFFIK_HELD} (JAX CPU {np.median(ref['gradient_rmse'][held]):.3e}); "
          f"divergent {divergent}")
    print(f"  config D on the first {DIFFIK_HELD}: median energy {med_e:.6e} (JAX CPU "
          f"{med_ej:.6e}); dL/dtargets median per-element rel. L2 error {np.median(rel_t):.3e}, "
          f"{np.mean(rel_t < DIFFIK_GRAD_TOL):.3f} of elements under {DIFFIK_GRAD_TOL:.0e}; "
          f"{int(stationary.sum())} elements stationary in both (gradient rmse <= "
          f"{DIFFIK_STATIONARY:.0e}): shares under {DIFFIK_GRAD_TOL:.0e} {share} (at least "
          f"{DIFFIK_SHARE_MIN}), dL/dcweight median per-element rel. L2 error "
          f"{np.median(rel_c[stationary]):.3e} and rel. L2 error over them {pooled_c:.3e}; x0's "
          f"pass-through gradient {'exact' if x0_ok else 'WRONG'}")
    if not (abs(med_e - med_ej) <= DIFFIK_ENERGY_RTOL * med_ej and divergent == 0
            and np.median(rel_t) <= DIFFIK_GRAD_TOL
            and min(share.values()) >= DIFFIK_SHARE_MIN and x0_ok
            and all(n > 0 for n in list(fwd_counts.values()) + list(bwd_counts.values()))):
        raise AssertionError(f"config D out of tolerance of JAX CPU's, or launches forward "
                             f"{fwd_counts} backward {bwd_counts}")

    # the same gradients through solve_ik_ift directly, from the same inputs
    t2, c2, x2 = _phi_leaves(prob)
    fn2 = w.diff_ik_solver_fn(prob, {"targets": t2, "cweight": c2})
    loss(solve_ik_ift(fn2, x2, prob.mask, w.diff_ik_options())).backward()
    direct = {name: float(torch.linalg.vector_norm(a.grad - b.grad)
                          / torch.linalg.vector_norm(b.grad))
              for name, a, b in (("targets", t2, t), ("cweight", c2, c), ("x0", x2, x0))}
    print(f"  config D through solve_ik_ift directly: rel. L2 difference of the gradients to "
          f"solve_ik_torch's {direct} (tol {DIFFIK_DIRECT_TOL:.0e})")
    if not all(d <= DIFFIK_DIRECT_TOL for d in direct.values()):
        raise AssertionError(f"config D: solve_ik_ift and solve_ik_torch disagree: {direct}")

    # the backward's K2+K3 system at (2048, 157), and one split of the backward
    seen = []
    real = psd.damped_chol_solve

    def record(a, damp, b):
        seen.append((a.clone(), damp.clone(), b.clone()))
        return real(a, damp, b)

    _, theta3 = forward()
    psd.damped_chol_solve = record
    try:
        loss(theta3).backward()
    finally:
        psd.damped_chol_solve = real
    if len(seen) != 1:
        raise AssertionError(f"config D's backward made {len(seen)} K2+K3 calls, not 1")
    psd_numbers = _hold_psd_matrix(*seen[0], "config D's IFT backward at theta*")
    t4, c4, _ = _phi_leaves(prob)
    split = _diff_ik_split(w.diff_ik_solver_fn(prob, {"targets": t4, "cweight": c4}), theta,
                           prob.mask, prob.w, w.diff_ik_options().regularization)
    print(f"  config D backward split (CUDA events): {split}")
    numbers = dict(forward_solves_per_s=batch / fwd * 1e3, forward_ms=fwd, backward_ms=bwd,
                   forward_launches=fwd_counts, backward_launches=bwd_counts,
                   median_gradient_rmse=float(rmse.median()), median_energy=med_e,
                   median_rel_l2_targets=float(np.median(rel_t)),
                   share_targets_under_tol=float(np.mean(rel_t < DIFFIK_GRAD_TOL)),
                   stationary_in_both=int(stationary.sum()), share_stationary_under_tol=share,
                   median_rel_l2_cweight_stationary=float(np.median(rel_c[stationary])),
                   rel_l2_cweight_stationary=pooled_c, direct=direct, backward_split=split)
    return prob, fwd_counts, bwd_counts, numbers, psd_numbers


def phase_solver_variants(prob, smi):
    """The solver variants (workloads.variant_recipe) on config D's position
    problem at B = 2048: GN by QR, LM by QR (TrustRegionQR), matrix-free GN
    by CG (K1 under every JVP and VJP sweep), GN with the line search,
    gradient descent, GN with histories (their shapes asserted): each one's
    wall, launches and median final energy on the first 256 elements against
    JAX CPU's (within 20%), divergent 0."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, VARIANTS_JAX_CPU_FILE)) as f:
        want = json.load(f)
    fn = SkeletonSolverFunction(prob.char,
                                (dataclasses.replace(prob.ef0, target=prob.targets),))
    batch, p = prob.x0.shape
    counts, numbers = {}, {}
    for name, (cls, opts, _) in w.variant_recipe().items():
        _reset_counts()
        t0 = time.perf_counter()
        _, res = w.solve_variant(prob, name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[name] = _counts(f"solver_variants {name}")
        e = fn.error(res.params).cpu().double().numpy()
        med, ref = float(np.median(e[:DIFFIK_HELD])), want[name]["median_energy"]
        divergent = int((~np.isfinite(e)).sum())
        hist = ""
        if opts.get("store_history"):
            n = opts["max_iterations"]
            shapes = (tuple(res.error_history.shape), tuple(res.param_history.shape))
            if shapes != ((n, batch), (n, batch, p)):
                raise AssertionError(f"variant {name}: history shapes {shapes}")
            hist = f"; histories {shapes}"
        print(f"variant {name} ({cls}, {res.iterations} iterations, B={batch}): wall "
              f"{wall * 1e3:.1f} ms on {smi}; median final energy {med:.6e} on the first "
              f"{DIFFIK_HELD} (JAX CPU {ref:.6e}), divergent {divergent}; kernel launches "
              f"{counts[name]}{hist}")
        if not (abs(med - ref) <= VARIANT_MEDIAN_RTOL * ref and divergent == 0):
            raise AssertionError(f"variant {name}: median {med} not within "
                                 f"{VARIANT_MEDIAN_RTOL} of JAX CPU's {ref}, or {divergent} "
                                 f"divergent")
        numbers[name] = dict(wall_s=wall, median_energy=med, divergent=divergent,
                             iterations=res.iterations, launches=counts[name])
    total = {k: sum(c[k] for c in counts.values()) for k in counts["gn_qr"]}
    if total["fk_global_kernel"] == 0 or counts["gn_line_search"]["damped_chol_solve_kernel"] == 0:
        raise AssertionError(f"the solver variants did not run through every kernel: {counts}")
    numbers["qr_step"] = _time_qr_step(fn, prob.x0, smi)
    return counts, numbers


def _time_qr_step(fn, x, smi):
    """The QR variants' library call at the path's shape: torch.linalg.qr of
    the damped stack [J; √damp·I] (B, R + P, P) at x, timed by CUDA events
    (two warm-up calls, the median of 2), beside K2+K3 on the same step's
    normal equations; the QR is the one JAX makes too (jnp.linalg.qr outside
    any Pallas kernel), not a kernel to port."""
    from momentum_tpu_torch.math.linalg import damped_psd_solve
    from momentum_tpu_torch.testing.profile_workload import event_ms

    rows, j = fn.residual_and_jacobian(x)
    p = x.shape[-1]
    damp = torch.full((p,), 1e-3, device=x.device)
    aug = torch.cat([j, torch.diag_embed(torch.sqrt(damp)).expand(j.shape[0], p, p)], dim=-2)
    qr_ms = event_ms(lambda: torch.linalg.qr(aug), reps=1, samples=2)
    jtj = j.transpose(-1, -2) @ j
    jtr = (j.transpose(-1, -2) @ rows[..., None])[..., 0]
    chol_ms = event_ms(lambda: damped_psd_solve(jtj, damp, jtr))
    print(f"GN's QR step at B={aug.shape[0]}: torch.linalg.qr of ({aug.shape[1]}, {p}) stacks "
          f"{qr_ms:.1f} ms; K2+K3 on the same step's normal equations ({p}, {p}) "
          f"{chol_ms:.4f} ms (CUDA events) on {smi}")
    return dict(qr_ms=qr_ms, damped_chol_solve_ms=chol_ms, shape=list(aug.shape))


def phase_vertex_extra(smi):
    """Config 4x: config 4b at B = 256 with the point-triangle,
    vertex-distance and camera-vertex projection modules (forward-mode
    Jacobians; workloads.build_vertex_extra_problem), GN 4 + 2 as 4b: each new
    module's rows and forward-mode Jacobian on the card at 16 warm starts
    against the port's CPU computation, then each module's median final
    energy on the first 64 elements against JAX CPU's (within 20%),
    divergent 0, the wall of one solve and the launches."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, VERTEX_EXTRA_JAX_CPU_FILE)) as f:
        want = json.load(f)
    prob = w.build_vertex_extra_problem(device="cuda")
    cpu = w.build_vertex_extra_problem(device="cpu")
    labels = ("vertex_position", "point_triangle", "vertex_distance", "camera_vertex")
    rows_err = {}
    x16 = prob.fit.x0[:16]
    for label, card_ef, cpu_ef in zip(labels[1:], w.vertex_extra_modules(
            prob, prob.fit.targets[:16], prob.distance.target[:16],
            prob.camera.target[:16])[1:], w.vertex_extra_modules(
            cpu, cpu.fit.targets[:16], cpu.distance.target[:16], cpu.camera.target[:16])[1:]):
        rk, jk = SkeletonSolverFunction(prob.fit.char, (card_ef,)).residual_and_jacobian(x16)
        rc, jc = SkeletonSolverFunction(cpu.fit.char, (cpu_ef,)).residual_and_jacobian(x16.cpu())
        rows_err[label] = dict(
            rows=float((rk.cpu() - rc).abs().max() / rc.abs().max()),
            jacobian=float((jk.cpu() - jc).abs().max() / jc.abs().max()))
    print(f"config 4x modules' rows and forward-mode Jacobians (B=16, P="
          f"{prob.fit.x0.shape[-1]}) on the card against the CPU, of max|.|: {rows_err} (tol "
          f"{VERTEX_EXTRA_ROWS_RTOL:.0e})")
    if not all(v <= VERTEX_EXTRA_ROWS_RTOL for d in rows_err.values() for v in d.values()):
        raise AssertionError(f"config 4x: the card's rows or Jacobians disagree with the "
                             f"CPU's: {rows_err}")
    _reset_counts()
    t0 = time.perf_counter()
    res = w.make_vertex_extra_solve(prob)(prob.fit.x0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts("vertex_extra")
    fn = SkeletonSolverFunction(prob.fit.char, w.vertex_extra_modules(
        prob, prob.fit.targets, prob.distance.target, prob.camera.target))
    ctx = fn.context(res.params)
    per = {lab: ef.error(prob.fit.char, ctx).cpu().double().numpy()
           for lab, ef in zip(labels, fn.error_functions)}
    divergent = int((~np.isfinite(sum(per.values()))).sum())
    batch = prob.fit.x0.shape[0]
    print(f"config 4x (B={batch}, P={prob.fit.x0.shape[-1]}, GN 4 + 2 on the worst 64, "
          f"{res.iterations} iterations): wall {wall:.2f} s (one solve, the first) on {smi}; "
          f"divergent {divergent}; kernel launches {counts}")
    bad, medians = [], {}
    for lab in labels:
        med, ref = float(np.median(per[lab][:VERTEX_EXTRA_HELD])), want["median_energy"][lab]
        medians[lab] = med
        ok = abs(med - ref) <= VERTEX_EXTRA_MEDIAN_RTOL * ref
        bad += [] if ok else [lab]
        print(f"  config 4x {lab}: median final energy {med:.6e} on the first "
              f"{VERTEX_EXTRA_HELD} (JAX CPU {ref:.6e}){'' if ok else ' OUT OF TOLERANCE'}; "
              f"all {batch}: {float(np.median(per[lab])):.6e}")
    if bad or divergent or any(n == 0 for n in counts.values()):
        raise AssertionError(f"config 4x: medians {bad} out of tolerance, {divergent} "
                             f"divergent, or launches {counts}")
    return counts, dict(wall_s=wall, median_energy=medians, divergent=divergent,
                        rows_and_jacobians=rows_err, launches=counts)


def _load_jax_cpu(name):
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, name)) as f:
        return json.load(f)


def phase_skinned_locators(smi):
    """Config SL: skinned-locator IK at B = 2048 on the full-body rig with
    its 80 locators turned into skinned locators
    (workloads.build_skinned_ik_problem): SkinnedLocator targets from each
    element's truth, 16 sliding SkinnedLocatorTriangle constraints, the
    limits; solve_ik's LM 10 on the normal equations, every row of the two
    modules by forward mode through K1 (the posed mesh's tangents in chunks,
    SkeletonSolverFunction.AD_MESH_FLOATS), K2+K3 at (2048, 157). The tables
    against JAX CPU's; the figures on the first 256 against JAX CPU's and on
    all 2048; the wall of the counted (cold) solve and of one warm one; the
    peak memory; get_locator_error's skinned branch on the first 32. Then
    K2+K3 held at (2048, 157) on the path's normal equations, and the
    forward-mode rows through K1 against the plain FK's at B = 128."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.tracking import get_locator_error

    want = _load_jax_cpu(SKINNED_JAX_CPU_FILE)
    prob = w.build_skinned_ik_problem(w.SKINNED_BATCH, seed=SEED, device="cuda")
    sl, tables, tri = prob.char.skinned_locators, want["tables"], prob.modules[1][1]
    table_err = dict(
        parents=int((sl.parents.cpu() != torch.as_tensor(tables["parents"])).sum()),
        tri_indices=int((tri.tri_indices.cpu() != torch.as_tensor(tables["tri_indices"])).sum()),
        candidates=int((tri.candidates.cpu() != torch.as_tensor(tables["candidates"])).sum()),
        skin_weights=float((sl.skin_weights.cpu() - torch.as_tensor(
            tables["skin_weights"])).abs().max()),
        rest_position=float((sl.rest_position.cpu() - torch.as_tensor(
            tables["rest_position"])).abs().max()))
    print(f"config SL skinned-locator tables against JAX CPU's ({sl.num_locators} locators, K = "
          f"{sl.parents.shape[1]}, {float((sl.skin_weights > 0).sum(1).float().mean()):.3f} "
          f"nonzero weights each; {tri.num_rows() // 3} triangle constraints): {table_err}")
    if (table_err["parents"] or table_err["tri_indices"] or table_err["candidates"]
            or sl.names != tuple(tables["names"])
            or max(table_err["skin_weights"], table_err["rest_position"]) > SKINNED_TABLE_TOL):
        raise AssertionError(f"config SL: the skinned-locator tables differ from JAX CPU's: "
                             f"{table_err}")
    batch = prob.x0.shape[0]
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = w.solve_catalog(prob)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = _counts("skinned_locators")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    w.solve_catalog(prob)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    more = w.solve_catalog(prob, x0=res.params, iterations=w.CATALOG_MORE)
    held = w.catalog_figures(prob, res.params, more.params, slice(0, SKINNED_HELD))
    full = w.catalog_figures(prob, res.params, more.params)
    print(f"config SL (skinned-locator IK, B={batch}, P={prob.x0.shape[-1]}, LM "
          f"{res.iterations}): {batch / wall:.1f} solves/s (warm wall {wall:.3f} s; the counted "
          f"cold solve {cold:.3f} s) on {smi}; peak memory {peak_gb:.3f} GiB; kernel launches "
          f"{counts}")
    floor = CATALOG_MEDIAN_FLOOR * want["median_energy"]["total"]
    bad = []
    for label, jax_med in want["median_energy"].items():
        med = held["median_energy"][label]
        ok = abs(med - jax_med) <= CATALOG_MEDIAN_RTOL * jax_med + floor
        bad += [] if ok else [label]
        print(f"  config SL {label}: median final energy {med:.6e} on the first "
              f"{SKINNED_HELD} (JAX CPU {jax_med:.6e}){'' if ok else ' OUT OF TOLERANCE'}; "
              f"all {batch}: {full['median_energy'][label]:.6e}")
    frames = want["locator_error"]["frames"]
    avg, mx = get_locator_error(prob.char, w.skinned_marker_sequence(prob, frames),
                                res.params[:frames])
    want_avg = want["locator_error"]["average"]
    print(f"  config SL conv_at_1e5 {held['conv_at_1e5']:.4f} on the first {SKINNED_HELD} "
          f"(JAX CPU {want['conv_at_1e5']:.4f}), {full['conv_at_1e5']:.4f} on all {batch}; "
          f"divergent {held['divergent']} / {full['divergent']} (JAX CPU {want['divergent']}); "
          f"get_locator_error of the first {frames}: average {avg:.6e} (JAX CPU "
          f"{want_avg:.6e}), max {mx:.6e}")
    if bad or abs(held["conv_at_1e5"] - want["conv_at_1e5"]) > CATALOG_CONV_SLACK \
            or full["divergent"] or any(n == 0 for n in counts.values()) \
            or abs(avg - want_avg) > SKINNED_LOCATOR_ERROR_RTOL * want_avg:
        raise AssertionError(f"config SL: medians {bad} out of tolerance, conv_at_1e5 "
                             f"{held['conv_at_1e5']} (JAX CPU {want['conv_at_1e5']}), divergent "
                             f"{full['divergent']}, locator error {avg} (JAX CPU {want_avg}), "
                             f"or launches {counts}")
    efs = tuple(ef for _, ef in prob.modules)
    fn = SkeletonSolverFunction(prob.char, efs)
    n = SKINNED_AD_ROWS_BATCH
    ad_fn = SkeletonSolverFunction(prob.char, (dataclasses.replace(
        efs[0], target=efs[0].target[:n]), efs[1]))
    numbers = dict(solves_per_s=batch / wall, wall_s=wall, cold_wall_s=cold,
                   peak_memory_gib=peak_gb, first_256=held, all=full, launches=counts,
                   locator_error=dict(average=avg, max=mx), tables=table_err,
                   ad_rows=_hold_ad_rows(ad_fn, prob.x0[:n].contiguous(),
                                         "config SL's skinned-locator modules"))
    a, b = fn.normal_equations(prob.x0)[:2]
    damp = (0.01 * torch.clamp(a.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5).contiguous()
    psd_numbers = _hold_psd_matrix(a.contiguous(), damp, b.contiguous(),
                                   "config SL's normal equations at the warm starts")
    return counts, numbers, psd_numbers


def phase_glove(smi):
    """Config G: glove-fused tracking on the full-body rig with a glove bone
    under each wrist (53 joints, 169 parameters; workloads.build_glove_clip):
    343 frames of the 80 markers and two 7-finger glove streams. The
    sequence solve (track_sequence, LM 10 with line search, one stacked
    position and orientation module per hand; K1 for the frame contexts,
    K2+K3 on SPIKE's steps), then per-frame tracking of the first 32 frames
    (LM 15, forward mode through K1, K2+K3 at (1, 169)): walls, launches,
    the final error and the marker and glove figures against JAX CPU's; the
    bake round trip of the solved glove parameters. Then K1 held at
    B = 343 on the glove rig, K2+K3 held on a SPIKE step and a per-frame
    step of the path, and the per-frame modules' forward-mode rows through
    K1 against the plain FK's at 32 frames."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.math import euler, quaternion as quat
    from momentum_tpu_torch.solver import SkeletonSolverFunction
    from momentum_tpu_torch.testing.fixtures import create_fullbody_character
    from momentum_tpu_torch.tracking import track_sequence, tracker
    from momentum_tpu_torch.tracking.glove_utils import (
        add_glove_bones, bake_glove_offsets_from_params)

    want = _load_jax_cpu(GLOVE_JAX_CPU_FILE)
    clip = w.build_glove_clip(w.GLOVE_FRAMES, seed=SEED, device="cuda")
    frames = clip.markers.num_frames
    counts, numbers, bad = {}, {}, []

    def held(part, figs, jax_figs):
        for k, v in figs.items():
            ref = jax_figs[k]
            if k == "error":
                tol = GLOVE_ERROR_RTOL * abs(ref)
            elif k == "median_mm":
                tol = max(GLOVE_MEDIAN_RTOL * ref, TRACKING_MEDIAN_ATOL_MM)
            else:
                tol = (TRACKING_P90_RTOL if k.startswith("p90") else GLOVE_MEDIAN_RTOL) * ref
            ok = abs(v - ref) <= tol
            bad.extend([] if ok else [f"{part} {k}"])
            print(f"  config G {part} {k}: {v:.6g} (JAX CPU {ref:.6g})"
                  + ("" if ok else " OUT OF TOLERANCE"))

    _reset_counts()
    t0 = time.perf_counter()
    seq = w.track_glove_sequence(clip)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["sequence"] = _counts("glove sequence")
    print(f"config G sequence (F={frames}, P={clip.char.num_model_parameters}, "
          f"{clip.char.num_joints} joints, 2 gloves of 7 fingers): {frames / wall:.1f} frames/s "
          f"(wall {wall:.2f} s) on {smi}; kernel launches {counts['sequence']}")
    figs = dict(error=float(seq.errors[0]), **w.glove_figures(clip, seq.motion))
    held("sequence", figs, want["sequence"])
    numbers["sequence"] = dict(frames_per_s=frames / wall, wall_s=wall, **figs,
                               launches=counts["sequence"])

    head = w.glove_clip_head(clip)
    n_head = head.markers.num_frames
    _reset_counts()
    t0 = time.perf_counter()
    pf = w.track_glove_per_frame(head)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["per_frame"] = _counts("glove per_frame")
    print(f"config G per-frame (the first {n_head} frames, LM 15 each): {n_head / wall:.2f} "
          f"frames/s (wall {wall:.2f} s) on {smi}; kernel launches {counts['per_frame']}")
    figs = dict(median_energy=float(np.median(pf.errors.cpu().numpy())),
                **w.glove_figures(head, pf.motion))
    held("per_frame", figs, want["per_frame"])
    numbers["per_frame"] = dict(frames_per_s=n_head / wall, wall_s=wall, **figs,
                                launches=counts["per_frame"])

    base = add_glove_bones(create_fullbody_character(device="cuda"), clip.config)
    baked = bake_glove_offsets_from_params(base, seq.motion[0], clip.char, clip.config)
    bake_err = 0.0
    for h, wrist in enumerate(clip.config.wrist_joint_names):
        bone = baked.skeleton.joint_names.index("glove_" + wrist)
        solved = seq.motion[0, 157 + 6 * h:163 + 6 * h]
        pre = quat.from_rotation_matrix(euler.euler_xyz_to_matrix(solved[3:]))
        bake_err = max(bake_err,
                       float((baked.skeleton.translation_offset[bone] - solved[:3]).abs().max()),
                       float((baked.skeleton.pre_rotation[bone] - pre).abs().max()))
    print(f"config G bake round trip ({baked.num_joints} joints, P={baked.num_model_parameters}):"
          f" the baked glove bones against the solved offsets, max|Δ| {bake_err:.3e} (tol "
          f"{GLOVE_BAKE_TOL:.0e})")
    numbers["bake_max_abs_err"] = bake_err
    if bad or bake_err > GLOVE_BAKE_TOL or not bool(torch.isfinite(seq.motion).all()) \
            or any(n == 0 for c in counts.values() for n in c.values()):
        raise AssertionError(f"config G: {bad} out of tolerance, bake {bake_err}, or launches "
                             f"{counts}")

    solve = tracker._frame_solve(clip.char, head.markers, w._glove_tracking_configs()[1], None,
                                 glove_data=head.gloves, glove_config=clip.config)
    frame_fn = SkeletonSolverFunction(clip.char, (solve.per_frame(
        solve.ef0, head.markers.positions, head.markers.occluded),) + solve.others
        + tracker._glove_modules(solve.gloves))
    # at the rest pose: the rows are then the markers' whole distances, as
    # large as the positions whose float32 FK they hold (at the solved
    # motion they are the ~2 mm noise, 1e-3 of the positions)
    numbers["ad_rows"] = _hold_ad_rows(frame_fn, torch.zeros_like(pf.motion),
                                       "config G's marker, limit and glove modules")
    skel = clip.char.skeleton
    local = fk.local_skel_states(skel, clip.char.parameter_transform.apply(seq.motion))
    fk_numbers = _hold_fk(skel, local.contiguous(), f"config G's {frames} frames, 53 joints")
    one_step = dataclasses.replace(w._glove_tracking_configs()[0], max_iter=1)
    seen = _record_systems(lambda: track_sequence(
        clip.char, clip.markers, one_step, initial=clip.initial, glove_data=clip.gloves,
        glove_config=clip.config))
    p = clip.char.num_model_parameters
    spike = max((k for k in seen if len(k) == 4 and k[1] == p), key=lambda k: k[3])
    psd_numbers = {"{}x{}_k{}".format(*spike[:2], spike[3]): _hold_psd_matrix(
                       *seen[spike], "config G's SPIKE step"),
                   "1x{}".format(p): _hold_psd_matrix(*_last_system(
                       lambda: w.track_glove_per_frame(w.glove_clip_head(clip, 1)), 1),
                       "config G's per-frame LM step")}
    return counts, numbers, fk_numbers, psd_numbers


def phase_vertex_ad(smi):
    """Config 4ad, bench_suite.py:370-375: config 4b at B = 256 (uncut)
    solved by GN 6 with SkeletonSolverFunction(..., force_ad=True), the
    vertex rows' Jacobian by forward mode through the skinning (K1's jvp
    rule) instead of the analytic LBS walk, against 4b's analytic solve in
    turns (3 warm runs each): solves/s, speedup_analytic (the AD wall over
    the analytic one), median_param_sq_err against JAX CPU's AD route; the
    forward-mode rows through K1 against the plain FK's at B = 64, and
    K2+K3 held on the AD solve's last system at (256, 165)."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    want = _load_jax_cpu(VERTEX_AD_JAX_CPU_FILE)
    prob = w.build_vertex_fit_problem(w.VERTEX_FIT_BATCH, device="cuda")
    batch = prob.x0.shape[0]
    solves = {"analytic": w.make_vertex_fit_solve(prob.char, prob.ef0, batch),
              "ad": w.make_vertex_fit_ad_solve(prob.char, prob.ef0)}
    for solve in solves.values():
        solve(prob.targets, prob.x0)  # warm-up
    walls = {k: [] for k in solves}
    for i in range(3):
        for name, solve in solves.items():
            if name == "ad" and i == 0:
                _reset_counts()
            t0 = time.perf_counter()
            out = solve(prob.targets, prob.x0)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            if name == "ad":
                if i == 0:
                    counts = _counts("vertex_ad")
                res = out
    wall = {k: statistics.median(v) for k, v in walls.items()}
    sq = ((res.params - prob.gt) ** 2).sum(-1).cpu().numpy()
    divergent = int((~np.isfinite(sq)).sum())
    med = float(np.median(sq))
    speedup = wall["ad"] / wall["analytic"]
    print(f"config 4ad (config 4b with force_ad, B={batch}, GN {res.iterations}): "
          f"{batch / wall['ad']:.0f} solves/s (median wall {wall['ad'] * 1e3:.1f} ms of 3; "
          f"analytic 4b {wall['analytic'] * 1e3:.1f} ms in turns), speedup_analytic "
          f"{speedup:.2f} on {smi}; median_param_sq_err {med:.6e} (JAX CPU "
          f"{want['median_param_sq_err']:.6e}), divergent {divergent}; kernel launches {counts}")
    ratio = med / want["median_param_sq_err"]
    if divergent or not 1 / VERTEX_AD_FACTOR <= ratio <= VERTEX_AD_FACTOR \
            or any(n == 0 for n in counts.values()):
        raise AssertionError(f"config 4ad: median_param_sq_err {med} not within a factor "
                             f"{VERTEX_AD_FACTOR} of JAX CPU's, {divergent} divergent, or "
                             f"launches {counts}")
    rows_fn = SkeletonSolverFunction(prob.char, (dataclasses.replace(
        prob.ef0, target=prob.targets[:VERTEX_AD_ROWS_BATCH]),), force_ad=True)
    numbers = dict(solves_per_s=batch / wall["ad"], wall_s=wall["ad"],
                   analytic_wall_s=wall["analytic"], speedup_analytic=speedup,
                   median_param_sq_err=med, divergent=divergent, launches=counts,
                   ad_rows=_hold_ad_rows(rows_fn, prob.x0[:VERTEX_AD_ROWS_BATCH].contiguous(),
                                         "config 4ad's vertex rows"))
    psd_numbers = _hold_psd_matrix(*_last_system(lambda: solves["ad"](prob.targets, prob.x0),
                                                 batch), "config 4ad's last GN step")
    return counts, numbers, psd_numbers


def _hold_mesh_to_sdf(label, mesh, resolution, sign_method, stride, smi):
    """One field by mesh_to_sdf on the card (its ms: the first build, and the
    median of 3 more), held against the same code on the CPU on every
    `stride`-th voxel (mesh_distances over those grid points): values
    within SDF_VALUE_TOL of the grid's extent, signs equal on SDF_SIGN_SHARE
    of them."""
    from momentum_tpu_torch.axel import sdf as sdf_mod

    vertices, faces = mesh
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        field = sdf_mod.mesh_to_sdf(vertices, faces, resolution, sign_method=sign_method,
                                    device="cuda")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    v_cpu = torch.as_tensor(vertices, dtype=torch.float32)
    f_cpu = torch.as_tensor(faces).long()
    origin, spacing, grid = sdf_mod.mesh_grid(v_cpu, resolution)
    pick = torch.arange(0, grid.shape[0], stride)
    dist, inside = sdf_mod.mesh_distances(grid[pick], v_cpu, f_cpu, sign_method)
    cpu = torch.where(inside, -1.0, 1.0) * dist
    card = field.values.reshape(-1)[pick.cuda()].cpu()
    extent = float((field.spacing * (torch.tensor(resolution, device="cuda") - 1)).max())
    err = float((card.abs() - cpu.abs()).abs().max()) / extent
    signs = float((torch.sign(card) == torch.sign(cpu)).float().mean())
    frame_err = max(float((field.origin.cpu() - origin).abs().max()),
                    float((field.spacing.cpu() - spacing).abs().max()))
    print(f"mesh_to_sdf {label} ({len(faces)} faces, {'x'.join(map(str, resolution))}, "
          f"{sign_method}) on the card: {walls[0]:.1f} ms first, "
          f"{statistics.median(walls[1:]):.1f} ms warm (median of 3) on {smi}; against the CPU "
          f"on {len(pick)} voxels (every {stride}): max |value| difference {err:.3e} of the "
          f"extent (tol {SDF_VALUE_TOL:.0e}), signs equal on {signs:.5f} (min "
          f"{SDF_SIGN_SHARE}), origin/spacing {frame_err:.1e}")
    if not (err <= SDF_VALUE_TOL and signs >= SDF_SIGN_SHARE and frame_err <= 1e-6):
        raise AssertionError(f"mesh_to_sdf {label} on the card disagrees with the CPU: "
                             f"{err}, signs {signs}, frame {frame_err}")
    return dict(first_ms=walls[0], ms=statistics.median(walls[1:]), value_err=err,
                sign_share=signs, voxels_held=len(pick))


def _penetration_line(label, before, after, want=None):
    """Print the obstacle's penetration before and after a solve (each
    (fraction, per-element deepest depth)); → the figures."""
    frac_b, depth_b = before
    frac_a, depth_a = after
    pen = depth_b > 0
    med_b = float(np.median(depth_b[pen])) if pen.any() else 0.0
    med_a = float(np.median(depth_a[pen])) if pen.any() else 0.0
    print(f"  config SC penetration ({label}): {frac_b:.4f} of the elements have a vertex in "
          f"the obstacle before, {frac_a:.4f} after; the deepest vertex's median depth over "
          f"those {int(pen.sum())} {med_b * 1e3:.3f} mm before, {med_a * 1e3:.3f} mm after"
          + ("" if want is None else
             f" (JAX CPU {want['before_fraction']:.4f} → {want['after_fraction']:.4f}, "
             f"{want['before_median_depth'] * 1e3:.3f} → "
             f"{want['after_median_depth'] * 1e3:.3f} mm)"))
    return dict(before_fraction=frac_b, after_fraction=frac_a, before_median_depth=med_b,
                after_median_depth=med_a)


def _hold_figures(config, held, full, want, batch, rtol=CATALOG_MEDIAN_RTOL):
    """Each module's median final energy on the first elements against JAX
    CPU's (within `rtol`, or CATALOG_MEDIAN_FLOOR of the median total),
    conv_at_1e5 and the divergent counts; raises on any of them."""
    floor = CATALOG_MEDIAN_FLOOR * want["median_energy"]["total"]
    bad = []
    for label, jax_med in want["median_energy"].items():
        med = held["median_energy"][label]
        ok = abs(med - jax_med) <= rtol * jax_med + floor
        bad += [] if ok else [label]
        print(f"  config {config} {label}: median final energy {med:.6e} on the first "
              f"{held['batch']} (JAX CPU {jax_med:.6e}){'' if ok else ' OUT OF TOLERANCE'}; "
              f"all {batch}: {full['median_energy'][label]:.6e}")
    print(f"  config {config} conv_at_1e5 {held['conv_at_1e5']:.4f} on the first "
          f"{held['batch']} (JAX CPU {want['conv_at_1e5']:.4f}), {full['conv_at_1e5']:.4f} on "
          f"all {batch}; divergent {held['divergent']} / {full['divergent']} (JAX CPU "
          f"{want['divergent']})")
    if bad or abs(held["conv_at_1e5"] - want["conv_at_1e5"]) > CATALOG_CONV_SLACK \
            or full["divergent"]:
        raise AssertionError(f"config {config}: medians {bad} out of tolerance, conv_at_1e5 "
                             f"{held['conv_at_1e5']} (JAX CPU {want['conv_at_1e5']}), or "
                             f"divergent {full['divergent']}")


def _hold_early(stage, sub, want):
    """Each module's median energy after LM UTILITY_EARLY on the first
    UTILITY_HELD elements within UTILITY_EARLY_RTOL of JAX CPU's → the
    medians; raises otherwise."""
    import momentum_tpu_torch.testing.workloads as w

    res = w.solve_catalog(sub, iterations=UTILITY_EARLY)
    early = {k: float(np.median(v[:UTILITY_HELD].cpu().numpy().astype(np.float64)))
             for k, v in w.catalog_energies(sub, res.params).items()}
    jax_early = want["early_median_energy"]
    bad = [k for k in jax_early if abs(early[k] - jax_early[k]) > UTILITY_EARLY_RTOL
           * jax_early[k]]
    print(f"  config {stage} after LM {UTILITY_EARLY} on the first {UTILITY_HELD}: "
          + "; ".join(f"{k} median {early[k]:.6e} (JAX CPU {jax_early[k]:.6e})"
                      for k in jax_early)
          + f" (tol {UTILITY_EARLY_RTOL:.0%}){' OUT OF TOLERANCE' if bad else ''}")
    if bad:
        raise AssertionError(f"config {stage}: medians {bad} after LM {UTILITY_EARLY} out of "
                             f"tolerance")
    return early


def phase_sdf_collision(smi):
    """Config SC: SDF-collision IK at B = 2048 on the full-body rig
    (workloads.build_sdf_collision_problem): its three fields built by
    mesh_to_sdf on the card (the 1280-face obstacle and the ground slab at
    64³, the handle at 32³), each held against the CPU; LM 10 through
    solve_ik over Position on the 80 locators, SdfCollision of all 612
    vertices against the obstacle and VertexSdf holding the 32 lowest
    vertices on the ground, both with analytic Jacobians through the LBS
    walk; K1 every context, K2+K3 at (2048, 157). Solves/s (the median of 3
    warm solves), the peak memory; the figures on the first 256 against
    JAX CPU's and on all 2048; the obstacle's penetration before and after;
    the support contacts of JAX's solved poses against JAX CPU's, and of
    the port's own; the joint-attached grid (the handle on r_hand0, its rows
    by forward mode) at B = 256 against JAX CPU's. Then K1 held at the
    warm starts (B = 2048), K2+K3 at (2048, 157) on the path's normal
    equations, the joint-attached rows through K1 against the plain FK's."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    want = _load_jax_cpu(SDF_JAX_CPU_FILE)
    here = os.path.dirname(os.path.abspath(__file__))
    jax_params = np.load(os.path.join(here, SDF_JAX_CPU_ARRAYS))["params"]
    problem = w.build_sdf_collision_problem(w.SDF_BATCH, seed=SEED, device="cuda")
    r = problem.recipe
    fields = {label: _hold_mesh_to_sdf(label, (r[f"{label}_vertices"], r[f"{label}_faces"]),
                                       res, method, stride, smi)
              for label, res, method, stride in (
                  ("obstacle", w.SDF_RESOLUTION, "winding", SDF_CPU_STRIDE),
                  ("ground", w.SDF_RESOLUTION, "normal", 1),
                  ("handle", w.SDF_HAND_RESOLUTION, "winding", 1))}
    batch = problem.x0.shape[0]
    before = w.sdf_penetration(problem, problem.x0)
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    res = w.solve_catalog(problem)
    torch.cuda.synchronize()
    counts = _counts("sdf_collision")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    walls = []
    for _ in range(3):  # warm
        t0 = time.perf_counter()
        w.solve_catalog(problem)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    more = w.solve_catalog(problem, x0=res.params, iterations=w.CATALOG_MORE)
    held = w.catalog_figures(problem, res.params, more.params, slice(0, SDF_HELD))
    full = w.catalog_figures(problem, res.params, more.params)
    print(f"config SC (SDF-collision IK, B={batch}, P={problem.x0.shape[-1]}, "
          f"{sum(ef.num_rows() for _, ef in problem.modules)} rows, LM "
          f"{w.CATALOG_ITERATIONS}): {batch / wall:.1f} solves/s (median wall {wall:.3f} s of "
          f"3 warm runs) on {smi}; peak memory {peak_gb:.3f} GiB; kernel launches {counts}")
    _hold_figures("SC", held, full, want, batch)
    if any(n == 0 for n in counts.values()):
        raise AssertionError(f"config SC did not run through every kernel: {counts}")
    after = w.sdf_penetration(problem, res.params)
    penetration = dict(
        all=_penetration_line(f"all {batch}", before, after),
        first_256=_penetration_line(
            f"the first {SDF_HELD}",
            w.sdf_penetration(problem, problem.x0, slice(0, SDF_HELD)),
            w.sdf_penetration(problem, res.params, slice(0, SDF_HELD)), want["penetration"]))

    # the support contacts on the card: JAX's solved poses held, the port's
    # own reported beside
    jp = torch.as_tensor(jax_params[:SDF_HELD], device="cuda")
    active, areas = w.sdf_support_contacts(problem, jp, SDF_HELD)
    want_active = np.asarray(want["contacts"]["active"], bool)
    want_areas = np.asarray(want["contacts"]["areas"])
    mask_diff = int((active != want_active).sum())
    area_err = float(np.max(np.abs(areas - want_areas) / np.maximum(np.abs(want_areas), 1e-12)
                            * (np.abs(areas - want_areas) > 1e-9)))
    own_active, own_areas = w.sdf_support_contacts(problem, res.params[:SDF_HELD], SDF_HELD)
    own_diff = int((own_active != want_active).sum())
    print(f"  config SC support contacts on the card (plane y = {r['ground_top']:.4f}, margin "
          f"{w.SDF_CONTACT_HEIGHT} m, {active.shape[1]} candidates an element) of JAX CPU's "
          f"solved poses, first {SDF_HELD}: {int(active.sum())} active (JAX CPU "
          f"{int(want_active.sum())}), {mask_diff} mask entries differ; polygon areas max rel. "
          f"difference {area_err:.3e} (tol {SDF_AREA_RTOL:.0e}) over the "
          f"{int((want_areas > 0).sum())} elements with a polygon (JAX CPU), median area "
          f"{float(np.median(areas)):.6f} m²; of the port's own solved poses: "
          f"{int(own_active.sum())} active, {own_diff} mask entries differ from JAX CPU's, "
          f"median area {float(np.median(own_areas)):.6f} m²")
    if mask_diff or not area_err <= SDF_AREA_RTOL:
        raise AssertionError(f"config SC support contacts: {mask_diff} mask entries differ or "
                             f"areas {area_err}")

    # the joint-attached grid: forward-mode rows, B = 256
    joint = w.sdf_joint_problem(problem)
    _reset_counts()
    res_j = w.solve_catalog(joint)
    torch.cuda.synchronize()
    joint_counts = _counts("sdf_collision joint")
    t0 = time.perf_counter()
    w.solve_catalog(joint)
    torch.cuda.synchronize()
    joint_wall = time.perf_counter() - t0
    more_j = w.solve_catalog(joint, x0=res_j.params, iterations=w.CATALOG_MORE)
    fig_j = w.catalog_figures(joint, res_j.params, more_j.params)
    print(f"config SC joint-attached grid (VertexSdf on {len(r['hand_index'])} finger vertices "
          f"against the handle's field on r_hand0, forward mode, B={joint.x0.shape[0]}): "
          f"{joint.x0.shape[0] / joint_wall:.1f} solves/s (warm wall {joint_wall:.3f} s); "
          f"kernel launches {joint_counts}")
    _hold_figures("SC joint-attached", fig_j, fig_j, want["joint_attached"], joint.x0.shape[0])
    if any(n == 0 for n in joint_counts.values()):
        raise AssertionError(f"config SC joint-attached grid: launches {joint_counts}")
    n = SDF_AD_ROWS_BATCH
    hand = joint.modules[1][1]
    ad_fn = SkeletonSolverFunction(problem.char, (dataclasses.replace(
        hand, target_distance=hand.target_distance[:n]),))
    numbers = dict(solves_per_s=batch / wall, wall_s=wall, peak_memory_gib=peak_gb,
                   first_256=held, all=full, launches=counts, penetration=penetration,
                   fields=fields, contacts=dict(active=int(active.sum()), mask_diff=mask_diff,
                                                area_rel_err=area_err, own_mask_diff=own_diff),
                   joint_attached=dict(figures=fig_j, launches=joint_counts,
                                       solves_per_s=joint.x0.shape[0] / joint_wall),
                   ad_rows=_hold_ad_rows(ad_fn, joint.x0[:n].contiguous(),
                                         "config SC's joint-attached VertexSdf",
                                         rtol=SDF_AD_K1_RTOL))
    skel = problem.char.skeleton
    local = fk.local_skel_states(
        skel, problem.char.parameter_transform.apply(problem.x0)).contiguous()
    fk_numbers = _hold_fk(skel, local, "config SC's warm starts")
    fn = SkeletonSolverFunction(problem.char, tuple(ef for _, ef in problem.modules))
    a, b = fn.normal_equations(problem.x0)[:2]
    damp = (0.01 * torch.clamp(a.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5).contiguous()
    psd_numbers = _hold_psd_matrix(a.contiguous(), damp, b.contiguous(),
                                   "config SC's normal equations at the warm starts")
    return counts, joint_counts, numbers, fk_numbers, psd_numbers


def phase_sdf_sequence(smi):
    """Config 5c: config 5's sequence solve (16-joint test rig, F = 1024, GN
    8) with SdfCollisionSequence on its 8 lowest rest vertices against a
    ground slab's field (mesh_to_sdf at 64³ on the card): its rows by
    forward mode through K1's jvp rule, SPIKE's Thomas steps through K2+K3.
    Frames/s (median of 3 warm solves, the first counted), the final error
    against JAX CPU's; K1 held at B = 1024 on its truths, K2+K3 on a SPIKE
    forward step of the path."""
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.testing.workloads import (
        build_sdf_sequence_problem, make_sequence_solve)

    want = _load_jax_cpu(SDF_JAX_CPU_FILE)["config5c"]
    prob = build_sdf_sequence_problem(SEQUENCE_FRAMES, device="cuda")
    fn = prob.fn
    solve = make_sequence_solve(fn)
    solve(prob.pf0, prob.u0)  # warm-up
    _reset_counts()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solve(prob.pf0, prob.u0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if len(walls) == 1:
            counts = _counts("sdf_sequence")
    wall = statistics.median(walls)
    err = float(res.error)
    print(f"config 5c (F={SEQUENCE_FRAMES}, config 5 with SdfCollisionSequence on "
          f"{fn.sequence_errors[-1].vertex_index.numel()} vertices, GN {res.iterations}): "
          f"{SEQUENCE_FRAMES / wall:.1f} frames/s (median wall {wall * 1e3:.1f} ms of 3) on "
          f"{smi}; final error {err:.6e} (JAX CPU {want['error']:.6e}), iterations "
          f"{res.iterations} (JAX CPU {want['iterations']}); kernel launches {counts}")
    if not (abs(err / want["error"] - 1) <= SDF_SEQUENCE_RTOL
            and bool(torch.isfinite(res.per_frame).all())
            and all(n > 0 for n in counts.values())):
        raise AssertionError(f"config 5c: final error {err} not within {SDF_SEQUENCE_RTOL} of "
                             f"JAX CPU's {want['error']}, or launches {counts}")
    skel = fn.character.skeleton
    local = fk.local_skel_states(skel, fn.character.parameter_transform.apply(prob.gt))
    p, nu = fn.num_per_frame, fn.num_universal
    numbers = dict(frames_per_s=SEQUENCE_FRAMES / wall, error=err, iterations=res.iterations,
                   launches=counts)
    fk_numbers = _hold_fk(skel, local.contiguous(), "config 5c's frames")
    psd_numbers = _hold_psd_matrix(*_sequence_systems(fn, prob.pf0, prob.u0, nu + 1 + 3 * p),
                                   "config 5c's SPIKE forward step")
    return counts, numbers, fk_numbers, psd_numbers


def _walls(run, n=3):
    """The median wall (s) of n calls of run, each synchronized."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def phase_character_utilities(smi):
    """Config U (workloads.build_utility_problem) at B = 2048 on the
    full-body rig with one body a joint. U1: transform_pose of the truths by
    the config's move, poses/s (median of 3 warm calls), FK of the result
    against the moved poses, the skinned vertices, the 4×4 form on the first
    256; U2: inverse FK of FK(joint parameters), states/s, the re-FK error,
    the local round trip, the first 256 against JAX CPU's; U3: LM 10 on the
    rig scaled by 1.15 (Position and CenterOfMass.from_physical_properties),
    U4: LM 10 on the simplified rig; each solves/s and config C's holds
    against JAX CPU's (the medians within UTILITY_MEDIAN_RTOL), the medians
    after LM UTILITY_EARLY against JAX CPU's; U4's tables against JAX CPU's. Then K1 held at U4's
    kept joints (B = 2048), K2+K3 at (2048, P') on U4's normal equations."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch import compat, torch_interop
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.math import skel_state as ss
    from momentum_tpu_torch.solver import SkeletonSolverFunction

    want = _load_jax_cpu(UTILITY_JAX_CPU_FILE)
    here = os.path.dirname(os.path.abspath(__file__))
    jax_jp = np.load(os.path.join(here, UTILITY_JAX_CPU_ARRAYS))["joint_parameters"]
    prob = w.build_utility_problem(w.UTILITY_BATCH, seed=SEED, device="cuda")
    batch = prob.truth.shape[0]
    counts, numbers = {}, {}

    # U1: retarget
    w.retarget(prob, prob.truth)  # warm-up
    _reset_counts()
    moved = w.retarget(prob, prob.truth)
    torch.cuda.synchronize()
    counts["U1"] = _counts("character_utilities U1")
    wall = _walls(lambda: w.retarget(prob, prob.truth))
    fig = w.retarget_figures(prob, prob.truth, moved)
    head = prob.truth[:UTILITY_HELD]
    by_matrix = torch_interop.transform_pose(prob.char, head, ss.to_matrix(prob.xform))
    form_err = float((by_matrix - moved[:UTILITY_HELD]).abs().max())
    print(f"config U1 retarget (transform_pose, B={batch}, turn {w.UTILITY_TURN} rad about y, "
          f"shift {w.UTILITY_SHIFT} m): {batch / wall:.1f} poses/s (median wall "
          f"{wall * 1e3:.2f} ms of 3) on {smi}; FK of the result against the moved poses: "
          f"max position error {fig['max_position_error']:.3e} m, max rotation error "
          f"{fig['max_rotation_error']:.3e} rad (tol {UTILITY_FK_TOL:.0e}); skinned vertices "
          f"{fig['max_vertex_error']:.3e} m; the 4x4 form on the first {UTILITY_HELD} "
          f"{form_err:.3e} from the skel_state form (tol {UTILITY_FORM_TOL:.0e}); JAX CPU's "
          f"transform_pose on this move: max position error "
          f"{want['u1']['max_position_error']:.6f} m (ROADMAP F25), "
          f"{want['u1']['max_position_error_inside_pi']:.3e} m on a move inside pi; "
          f"kernel launches {counts['U1']}")
    if not (fig["max_position_error"] <= UTILITY_FK_TOL and fig["max_rotation_error"]
            <= UTILITY_FK_TOL and fig["max_vertex_error"] <= UTILITY_FK_TOL
            and form_err <= UTILITY_FORM_TOL and counts["U1"]["fk_global_kernel"] > 0):
        raise AssertionError(f"config U1: {fig}, 4x4 form {form_err}, launches {counts['U1']}")
    numbers["U1"] = dict(poses_per_s=batch / wall, wall_ms=wall * 1e3, form_error=form_err,
                         **fig)

    # U2: inverse FK
    _reset_counts()
    jp_back, fig = w.inverse_fk_figures(prob, prob.truth)
    torch.cuda.synchronize()
    counts["U2"] = _counts("character_utilities U2")
    states = compat.model_parameters_to_skeleton_state(prob.char, prob.truth)
    wall = _walls(lambda: compat.skeleton_state_to_joint_parameters(prob.char, states))
    jp_err = float(np.abs(jp_back[:UTILITY_HELD].cpu().numpy() - jax_jp).max())
    print(f"config U2 inverse FK (B={batch}): {batch / wall:.1f} states/s (median wall "
          f"{wall * 1e3:.2f} ms of 3) on {smi}; re-FK max position error "
          f"{fig['max_refk_position_error']:.3e} m (tol {UTILITY_FK_TOL:.0e}); joint "
          f"parameters {fig['max_joint_parameter_error']:.3e} from the forward ones, "
          f"{fig['max_local_joint_parameter_error']:.3e} through the local states; the first "
          f"{UTILITY_HELD} against JAX CPU's {jp_err:.3e} (tol {UTILITY_JP_TOL:.0e}); kernel "
          f"launches {counts['U2']}")
    if not (fig["max_refk_position_error"] <= UTILITY_FK_TOL and jp_err <= UTILITY_JP_TOL
            and counts["U2"]["fk_global_kernel"] > 0):
        raise AssertionError(f"config U2: {fig}, against JAX CPU {jp_err}")
    numbers["U2"] = dict(states_per_s=batch / wall, wall_ms=wall * 1e3, jax_cpu_error=jp_err,
                         **fig)

    # U3 and U4: IK on the scaled and the simplified rig
    pp = prob.scaled.char.physical_properties
    digest = dict(mass=w.array_digest(pp.mass.cpu().numpy()),
                  scaled_inertia=w.array_digest(pp.inertia.cpu().numpy()))
    print(f"config U3 bodies on the scaled rig: total mass {float(pp.total_mass()):.4f} kg "
          f"(preserve_mass), tables {'equal to' if digest == want['bodies'] else 'DIFFER FROM'}"
          f" JAX CPU's")
    if digest != want["bodies"]:
        raise AssertionError(f"config U3: the bodies differ from JAX CPU's: {digest}")
    tables = w.simplified_tables(prob.simplified.char)
    bad = [k for k in tables if tables[k] != want["u4"]["tables"][k]]
    print(f"config U4 simplified rig: {prob.simplified.char.num_joints} joints, "
          f"{prob.simplified.x0.shape[-1]} parameters, {tables['num_vertices']} vertices, "
          f"{prob.simplified.char.locators.num_locators} locators; tables (joint parents, "
          f"parameter names and transform, {len(tables['limits'])} limit tables, locator "
          f"parents, mesh faces) {'equal to JAX CPU' if not bad else 'DIFFER: ' + str(bad)}")
    if bad:
        raise AssertionError(f"config U4: tables {bad} differ from JAX CPU's")
    for stage, sub, key in (("U3", prob.scaled, "u3"), ("U4", prob.simplified, "u4")):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        res = w.solve_catalog(sub)
        torch.cuda.synchronize()
        counts[stage] = _counts(f"character_utilities {stage}")
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        wall = _walls(lambda: w.solve_catalog(sub))
        more = w.solve_catalog(sub, x0=res.params, iterations=w.CATALOG_MORE)
        held = w.catalog_figures(sub, res.params, more.params, slice(0, UTILITY_HELD))
        full = w.catalog_figures(sub, res.params, more.params)
        print(f"config {stage} ({'scaled' if stage == 'U3' else 'simplified'} IK, B={batch}, "
              f"P={sub.x0.shape[-1]}, {sum(ef.num_rows() for _, ef in sub.modules)} rows, LM "
              f"{w.CATALOG_ITERATIONS}): {batch / wall:.1f} solves/s (median wall {wall:.3f} s "
              f"of 3 warm runs) on {smi}; peak memory {peak_gb:.3f} GiB; kernel launches "
              f"{counts[stage]}")
        _hold_figures(stage, held, full, want[key], batch, rtol=UTILITY_MEDIAN_RTOL)
        held["early_median_energy"] = _hold_early(stage, sub, want[key])
        if any(n == 0 for n in counts[stage].values()):
            raise AssertionError(f"config {stage} did not run through every kernel: "
                                 f"{counts[stage]}")
        numbers[stage] = dict(solves_per_s=batch / wall, wall_s=wall, peak_memory_gib=peak_gb,
                              first_256=held, all=full)
    numbers["launches"] = counts
    simple = prob.simplified
    skel = simple.char.skeleton
    local = fk.local_skel_states(skel, simple.char.parameter_transform.apply(simple.x0))
    fk_numbers = _hold_fk(skel, local.contiguous(), "config U4's kept joints")
    fn = SkeletonSolverFunction(simple.char, tuple(ef for _, ef in simple.modules))
    a, b = fn.normal_equations(simple.x0)[:2]
    damp = (0.01 * torch.clamp(a.diagonal(dim1=-2, dim2=-1), min=1e-12) + 1e-5).contiguous()
    psd_numbers = _hold_psd_matrix(a.contiguous(), damp, b.contiguous(),
                                   "config U4's normal equations at the warm starts")
    return counts, numbers, fk_numbers, psd_numbers


def _frame_vertices(char, motion, frame=0):
    """The skinned vertices of frame `frame` of the clip."""
    from momentum_tpu_torch.testing.workloads import clip_vertices

    return clip_vertices(char, motion[frame])


def _raster_bound(planes, tab, n_attr, fids, ovf, w, h, th, covered):
    """bound() of one rasterizer pass, its face-tile pairs scanned and its
    live faces, and (K4a) the unculled scan's time at the f32 peak, which
    the per-tile test makes no floor. Bytes: the tables and bins read,
    depth, face, bary and attributes written. Flops: each tile scans the
    live faces it keeps (those in its bin, or every live face when it
    overflows; K4a the faces its per-tile test keeps, `tile_face_may_cover`,
    after that test's 4 planes × 9 flops for every live face; the padding
    rows and killed planes, a0 = b0 = 0, need no test) against its th·128
    pixels. A face's 4 planes cost 4 products a·x per column and 4 products
    b·y per row of the tile, then 2 adds per plane and pixel; each covered
    pixel then evaluates its 3 barycentrics and attributes at 4 flops each."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.testing.profile_workload import bound

    gi, gj = raster._grid(w, h, th)
    live = (planes[:, 0] != 0) | (planes[:, 1] != 0)
    n_live = int(live.sum())
    per_pair = 128 * 4 + th * 4 + th * 128 * 8
    tests = 0
    extra = {}
    if fids is None:
        scanned = int((raster.tile_face_may_cover(planes, w, h, th) & live).sum())
        tests = gi * gj * n_live * 4 * 9
        extra["unculled_scan_ms"] = bound(0, gi * gj * n_live * per_pair)["bound_ms"]
    else:
        in_bin = (fids != raster.NOFACE) & live[fids.long().clamp(max=planes.shape[0] - 1)]
        scanned = int(torch.where(ovf.bool(), n_live, in_bin.sum(1)).sum())
    b = bound(sum(t.numel() * t.element_size() for t in (planes, tab, fids, ovf)
                  if t is not None) + h * w * 4 * (2 + 3 + n_attr),
              tests + scanned * per_pair + covered * 4 * (3 + n_attr))
    return b, scanned, n_live, extra


def phase_raster(char, cam, motion):
    """K4a and K4b against the plain version on the card. K4b at config 7's
    shapes: the camera pass (1280×960, 6 attributes, binned) of frame 0 (one
    overflow tile) and frame 5 (none), the shadow-map pass (256×256, binned)
    of frame 0 (none) and frame 11 (one), and frame 0's camera pass with
    bin_capacity 8 (77 tiles take the overflow scan). K4a on its path, the
    small-mesh render (the first 120 faces, frame 0: camera and shadow
    passes, unbinned at th = 4), and on frame 0's 612-face camera pass with
    cull=False."""
    from momentum_tpu_torch.rasterizer import render

    meshes = {"clip": char.mesh.faces, "small": char.mesh.faces[:SMALL_MESH_FACES].contiguous()}
    inputs = {(mesh, frame): render.shadowed_passes(cam, _frame_vertices(char, motion, frame),
                                                    meshes[mesh], 1280, 960)
              for mesh, frame in (("clip", 0), ("clip", 5), ("clip", 11), ("small", 0))}
    binned, full = "raster_planes_binned_kernel", "raster_planes_kernel"
    cases = [("camera pass, frame 0", binned, "clip", 0, "camera", {}),
             ("camera pass, frame 5", binned, "clip", 5, "camera", {}),
             ("shadow pass, frame 0", binned, "clip", 0, "shadow", {}),
             ("shadow pass, frame 11", binned, "clip", 11, "shadow", {}),
             ("small mesh camera pass", full, "small", 0, "camera", {}),
             ("small mesh shadow pass", full, "small", 0, "shadow", {}),
             ("camera pass, frame 0, cull=False", full, "clip", 0, "camera", dict(cull=False)),
             ("camera pass, frame 0, bin_capacity=8", binned, "clip", 0, "camera",
              dict(bin_capacity=8))]
    numbers = {}
    for label, kernel, mesh, frame, pass_, extra in cases:
        sv, w, h, kw = inputs[mesh, frame][pass_]
        numbers[label] = _hold_raster(label, kernel, sv, meshes[mesh], w, h, dict(kw, **extra))
    return numbers


def _hold_raster(label, kernel, sv, faces, w, h, kw):
    """`kernel` (K4a or K4b, whichever rasterize_planes launches for these
    arguments) against the plain version on the card: face maps identical,
    depth, barycentrics and attributes within RASTER_TOL; then the kernel
    alone timed (profiler and CUDA events), the plain scan on the same
    tables and the whole rasterize_planes call, and its bound."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.testing.profile_workload import event_ms, kernel_device_ms

    before = raster.launches[kernel]
    out = raster.rasterize_planes(sv, faces, w, h, **kw)
    ref = raster.rasterize_planes_plain(sv, faces, w, h, **kw)
    torch.cuda.synchronize()
    if raster.launches[kernel] != before + 1:
        raise AssertionError(f"{label}: {kernel} was not launched")
    if not torch.equal(out["face"], ref["face"]):
        n = int((out["face"] != ref["face"]).sum())
        raise AssertionError(f"{label}: {kernel}'s face map differs from the plain "
                             f"version's at {n} pixels")
    hit = ref["face"] >= 0
    errs = {"depth": float((out["depth"][hit] - ref["depth"][hit]).abs().max())
            if bool(hit.any()) else 0.0}
    for key in ("bary", "attrs"):
        if key in ref:
            errs[key] = float((out[key] - ref[key]).abs().max())
    if not bool(torch.isinf(out["depth"][~hit]).all()):
        raise AssertionError(f"{label}: an empty pixel's depth is not inf")
    bad = {k: e for k, e in errs.items() if not e <= RASTER_TOL[k]}
    if bad:
        raise AssertionError(f"{label}: {kernel} disagrees with the plain version: {bad}")

    # the kernel alone against the plain version's scan, on the same tables
    args = raster._kernel_args(sv, faces, w, h, **kw)
    ovf, th = args[4], args[7]
    cull = ovf is not None
    n_ovf = int(ovf.sum()) if cull else 0
    covered = int(hit.sum())
    b_raster, scanned, n_live, unculled = _raster_bound(*args, covered)
    busy_ms = event_ms(lambda: raster._raster_kernel(*args, True), busy=True)
    # the profiler's kernel time, else the launches queued behind a sleep
    ms = kernel_device_ms(lambda: raster._raster_kernel(*args, True), kernel) or busy_ms
    plain_ms = event_ms(lambda: raster._raster_plain(*args, 128, True))
    call_ms = event_ms(lambda: raster.rasterize_planes(sv, faces, w, h, **kw))
    err = max(errs.values())
    print(f"{kernel} [{label}] ({w}x{h}, F={faces.shape[0]}, th={th}, "
          f"{n_ovf} of {ovf.numel() if cull else 0} tiles overflow): face maps identical, "
          f"max|kernel - plain| " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
          + f"; kernel {ms:.4f} ms on the device ({busy_ms:.4f} ms in CUDA events "
          f"behind a sleep), plain {plain_ms:.4f} ms, whole rasterize_planes "
          f"{call_ms:.4f} ms; bound {b_raster['bound_ms']:.4f} ms "
          f"({b_raster['bound_by']}, {scanned} face-tile pairs scanned of {n_live} live "
          f"faces, {covered} covered pixels)"
          + (f"; the unculled scan alone {unculled['unculled_scan_ms']:.4f} ms at the f32 "
             "peak (no floor: the per-tile test drops faces)" if unculled else ""))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b_raster, library_ms=None,
                events_ms=busy_ms, overflow_tiles=n_ovf, faces=faces.shape[0],
                pairs_scanned=scanned, **unculled)


def phase_clip_passes(char, cam, motion):
    """Every K4b pass of the clip (32 camera and 32 shadow passes): the
    overflow tiles of each, the sum of their bounds, and the sum of the
    plain version's scans of them (one call each, CUDA events)."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.testing.workloads import render_clip_passes

    counts = {"camera": [], "shadow": []}
    bound_ms = plain_ms = 0.0
    passes = render_clip_passes(char, cam, motion)
    raster._raster_plain(*passes[0]["camera"], 128, False)  # warm-up
    for frame in passes:
        for name, args in frame.items():
            counts[name].append(int(args[4].sum()))
            covered = int((raster._raster_kernel(*args, False)["face"] >= 0).sum())
            bound_ms += _raster_bound(*args, covered)[0]["bound_ms"]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            raster._raster_plain(*args, 128, False)
            end.record()
            torch.cuda.synchronize()
            plain_ms += start.elapsed_time(end)
    print(f"K4b overflow tiles per frame of the clip: camera {counts['camera']} (of 1200 "
          f"tiles), shadow {counts['shadow']} (of 64); the 64 passes' bounds sum to "
          f"{bound_ms:.4f} ms, their plain scans to {plain_ms:.4f} ms")
    return dict(overflow_tiles=counts, bound_ms=bound_ms, plain_ms=plain_ms)


def phase_render_clip(char, cam, motion, smi):
    """The render path: 32 frames, FK in one batch (K1), skinning, two
    raster passes per frame (K4b) and a 2×2 box filter; 3 timed runs, then
    the device time of K4b's 64 launches and K1's one per clip (profiler)."""
    from momentum_tpu_torch.ops import fk as fk_ops, raster
    from momentum_tpu_torch.testing.profile_workload import fmt_ms, kernel_device_ms
    from momentum_tpu_torch.testing.workloads import make_render_clip

    render_clip = make_render_clip(char, cam)
    render_clip(motion)  # warm-up
    torch.cuda.synchronize()
    fk_ops.launches = 0
    raster.launches.update(dict.fromkeys(raster.launches, 0))
    t0 = time.perf_counter()
    imgs = render_clip(motion)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts = {"fk_global_kernel": fk_ops.launches, **raster.launches}
    for _ in range(2):
        t0 = time.perf_counter()
        render_clip(motion)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    device_ms = {name: kernel_device_ms(lambda: render_clip(motion), name, reps=2,
                                        per_call=per_call)
                 for name, per_call in (("raster_planes_binned_kernel", 2 * motion.shape[0]),
                                        ("fk_global_kernel", 1))}
    frames = motion.shape[0]
    wall = statistics.median(walls)
    cov = float((imgs > 0).float().mean())
    covered = (imgs > 0).any(dim=-1)
    mean_color = imgs[covered].mean(dim=0).tolist()
    print(f"render clip ({frames} frames, 640x480 @ 2x2 SS, shadow map 256): "
          f"{frames / wall:.2f} frames/s (median wall {wall * 1e3:.1f} ms of {len(walls)}) "
          f"on {smi}; mean coverage {cov:.6f} (JAX CPU {CLIP_COVERAGE_JAX_CPU:.6f}), "
          f"mean colour of covered pixels {[round(c, 6) for c in mean_color]}; "
          f"kernel launches {counts}; device ms per clip (profiler): K4b "
          f"{fmt_ms(device_ms['raster_planes_binned_kernel'])} over its 64 launches, K1 "
          f"{fmt_ms(device_ms['fk_global_kernel'])}")
    if imgs.shape != (frames, 480, 640, 3) or not bool(torch.isfinite(imgs).all()):
        raise AssertionError(f"render clip: images {tuple(imgs.shape)} of the wrong shape "
                             "or not finite")
    if not abs(cov / CLIP_COVERAGE_JAX_CPU - 1) <= CLIP_COVERAGE_RTOL:
        raise AssertionError(f"render clip: mean coverage {cov} is not within "
                             f"{CLIP_COVERAGE_RTOL:.0%} of the JAX CPU figure")
    if counts["raster_planes_binned_kernel"] != 2 * frames or counts["fk_global_kernel"] < 1:
        raise AssertionError(f"render clip: expected {2 * frames} K4b launches and ≥ 1 K1 "
                             f"launch, got {counts}")
    return counts, imgs, device_ms


def phase_small_mesh(char, cam, motion):
    """A mesh under the bin capacity renders through K4a, both passes."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.rasterizer import render

    verts = _frame_vertices(char, motion)
    faces = char.mesh.faces[:SMALL_MESH_FACES].contiguous()
    render.render_mesh_shadowed(cam, verts, faces, 1280, 960)  # warm-up
    torch.cuda.synchronize()
    raster.launches.update(dict.fromkeys(raster.launches, 0))
    out = render.render_mesh_shadowed(cam, verts, faces, 1280, 960)
    torch.cuda.synchronize()
    counts = dict(raster.launches)
    ref = render.render_mesh_shadowed(cam.to("cpu"), verts.cpu(), faces.cpu(), 1280, 960)
    same = out["face"].cpu() == ref["face"]
    flipped = int((out["mask"].cpu() != ref["mask"]).sum())
    cov = int(ref["mask"].sum())
    err = float((out["color"].cpu() - ref["color"])[same].abs().max())
    print(f"small mesh ({SMALL_MESH_FACES} faces, 1280x960, shadowed): {cov} covered "
          f"pixels, {flipped} differ from the CPU's plain render, colour |Δ| ≤ {err:.2e} "
          f"where the faces agree; kernel launches {counts}")
    if counts != {"raster_planes_kernel": 2, "raster_planes_binned_kernel": 0}:
        raise AssertionError(f"small mesh: expected 2 K4a launches, got {counts}")
    if not (cov > 0 and flipped <= max(3, cov // 1000) and err <= 1e-3):
        raise AssertionError("small mesh: the card's render disagrees with the CPU's")
    return counts


def phase_render_reference(card_clip, imgs_card):
    """Frames 0-1 of the clip rendered again on the CPU (plain versions),
    built anew there from the same seed: the same masks up to max(3, 0.1%)
    of the covered pixels; where both pick the same face, the same shadow
    factor on ≥ 99% of them and the same colour where that agrees too."""
    from momentum_tpu_torch.rasterizer import render
    from momentum_tpu_torch.testing.workloads import build_render_clip, make_render_clip

    cpu_clip = build_render_clip(32, seed=SEED, device="cpu")
    renders = {}
    for device, (char, motion, cam) in (("cuda", card_clip), ("cpu", cpu_clip)):
        renders[device] = [
            render.render_mesh_shadowed(cam, _frame_vertices(char, motion, i),
                                        char.mesh.faces, 1280, 960) for i in (0, 1)]
    for i in (0, 1):
        g, c = renders["cuda"][i], renders["cpu"][i]
        mg, mc = g["mask"].cpu(), c["mask"]
        same = (g["face"].cpu() == c["face"]) & mc
        flipped = int((mg != mc).sum())
        cov = int(mc.sum())
        # FK, skinning and camera differ in their last bits between the
        # devices; a world position on a shadow-map texel edge or at the depth
        # bias may then flip lit ↔ shadowed, which changes the colour by ~0.1
        lit_same = g["shadow"].cpu() == c["shadow"]
        lit_agree = float(lit_same[same].float().mean())
        err = float((g["color"].cpu() - c["color"])[same & lit_same].abs().max())
        print(f"render reference frame {i}: {cov} covered pixels on the CPU, {flipped} "
              f"differ on the card; where the faces agree, the shadow factor agrees on "
              f"{lit_agree:.5f} of them and the colour |Δ| ≤ {err:.2e} where it does too")
        if not (cov > 0 and flipped <= max(3, cov // 1000) and lit_agree >= 0.99
                and err <= 1e-3):
            raise AssertionError(f"frame {i}: the card's render disagrees with the CPU's")
    char, motion, cam = cpu_clip
    aa = make_render_clip(char, cam)(motion[:2])
    print(f"render reference: box-filtered frames 0-1, card vs CPU max|Δ| "
          f"{float((imgs_card[:2].cpu() - aa).abs().max()):.3e}, mean coverage card "
          f"{float((imgs_card[:2] > 0).float().mean()):.6f} / CPU "
          f"{float((aa > 0).float().mean()):.6f}")


def _decode_gif(path):
    """(width, height, [index frames (H, W) uint8]) of a GIF89a file with a
    global colour table and LZW-coded frames (what gui/gif.py writes)."""
    import struct

    data = open(path, "rb").read()
    if data[:6] != b"GIF89a":
        raise AssertionError(f"{path}: not a GIF89a file")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    frames = []
    while data[pos] != 0x3B:
        if data[pos] == 0x21:  # an extension: skip its sub-blocks
            pos += 2
            while data[pos]:
                pos += data[pos] + 1
            pos += 1
            continue
        if data[pos] != 0x2C:
            raise AssertionError(f"{path}: unexpected block 0x{data[pos]:02x} at {pos}")
        fw, fh = struct.unpack("<HH", data[pos + 5:pos + 9])
        min_code_size = data[pos + 10]
        pos += 11
        codes = bytearray()
        while data[pos]:
            codes += data[pos + 1:pos + 1 + data[pos]]
            pos += data[pos] + 1
        pos += 1
        pixels = _lzw_decode(bytes(codes), min_code_size)
        frames.append(np.frombuffer(pixels, np.uint8)[:fw * fh].reshape(fh, fw))
    return w, h, frames


def _lzw_decode(data: bytes, min_code_size: int) -> bytes:
    """GIF's variable-width LZW, codes packed from the low bit up."""
    clear = 1 << min_code_size
    out = bytearray()
    table, prev = None, None
    code_size = min_code_size + 1
    buf = nbits = pos = 0
    while True:
        while nbits < code_size:
            buf |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = buf & ((1 << code_size) - 1)
        buf >>= code_size
        nbits -= code_size
        if code == clear:
            table = [bytes([i]) for i in range(clear)] + [b"", b""]
            code_size, prev = min_code_size + 1, None
            continue
        if code == clear + 1:
            return bytes(out)
        entry = table[code] if code < len(table) else prev + prev[:1]
        out += entry
        if prev is not None:
            table.append(prev + entry[:1])
            if len(table) == 1 << code_size and code_size < 12:
                code_size += 1
        prev = entry


def _scene_figures(images, ground_rgb):
    """Mean over the given frames of the coverage (the share of pixels that
    differ from the ground alone) and of the mean colour of those pixels:
    tools/jax_reference.py::scene_figures."""
    cov, col = [], []
    for image in images:
        covered = np.abs(image - ground_rgb).max(-1) > 0
        cov.append(float(covered.mean()))
        col.append(image[covered].mean(0))
    return float(np.mean(cov)), np.mean(col, axis=0)


def _hold_scene_figures(part, images, ground_rgb, jax_cpu):
    """Frames SCENE_HELD_FRAMES' figures against JAX CPU's planes ones."""
    cov, col = _scene_figures(images, ground_rgb)
    ref = [jax_cpu[m][str(i)] for m in ("planes", "windowed") for i in SCENE_HELD_FRAMES]
    n = len(SCENE_HELD_FRAMES)
    ref_cov = [float(np.mean([r["coverage"] for r in ref[k * n:(k + 1) * n]])) for k in (0, 1)]
    ref_col = [np.mean([r["mean_color"] for r in ref[k * n:(k + 1) * n]], axis=0)
               for k in (0, 1)]
    cov_err = abs(cov / ref_cov[0] - 1)
    col_err = float(np.max(np.abs(col / ref_col[0] - 1)))
    print(f"config 7p {part}, frames {list(SCENE_HELD_FRAMES)}: coverage {cov:.6f} (JAX CPU "
          f"planes {ref_cov[0]:.6f}, windowed {ref_cov[1]:.6f}), mean colour "
          f"{[round(float(c), 6) for c in col]} (JAX CPU planes "
          f"{[round(float(c), 6) for c in ref_col[0]]}, windowed "
          f"{[round(float(c), 6) for c in ref_col[1]]}): relative errors {cov_err:.4f}, "
          f"{col_err:.4f} against planes")
    if not (cov_err <= SCENE_FIGURE_RTOL and col_err <= SCENE_FIGURE_RTOL):
        raise AssertionError(f"config 7p {part}: coverage or mean colour not within "
                             f"{SCENE_FIGURE_RTOL:.0%} of JAX CPU's planes figures")
    return dict(coverage=cov, mean_color=[float(c) for c in col], coverage_rel_err=cov_err,
                mean_color_rel_err=col_err)


def _timed_runs(run):
    """Warm-up, then 3 runs each ending in a synchronize: (the first timed
    run's launches, its output, the median wall s)."""
    from momentum_tpu_torch.ops import fk as fk_ops, raster

    run()
    torch.cuda.synchronize()
    walls = []
    for i in range(3):
        if i == 0:
            fk_ops.launches = 0
            raster.launches.update(dict.fromkeys(raster.launches, 0))
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            counts = {"fk_global_kernel": fk_ops.launches, **raster.launches}
            first = out
    return counts, first, statistics.median(walls)


def phase_scene_methods(char, cam, motion):
    """The dense and windowed rasterizers on the card against the same
    functions on the CPU (frame 0's viewer camera pass, 640 × 480, 612
    faces: face maps equal, depth and barycentrics within 1e-5), and the
    three methods' face maps against each other on the card."""
    from momentum_tpu_torch.rasterizer import render
    from momentum_tpu_torch.testing.profile_workload import event_ms
    from momentum_tpu_torch.testing.workloads import SCENE_HEIGHT as H, SCENE_WIDTH as W

    sv = render.screen_vertices(cam, _frame_vertices(char, motion))
    faces = char.mesh.faces
    methods = {"dense": lambda v, f: render.rasterize(v, f, W, H),
               "windowed": lambda v, f: render._rasterize_dispatch(v, f, W, H,
                                                                   method="windowed"),
               "planes": lambda v, f: render._rasterize_dispatch(v, f, W, H, method="planes")}
    card = {m: fn(sv, faces) for m, fn in methods.items()}
    numbers = {}
    for m in ("dense", "windowed"):
        cpu = methods[m](sv.cpu(), faces.cpu())
        got = {k: v.cpu() for k, v in card[m].items()}
        hit = cpu["face"] >= 0
        equal = torch.equal(got["face"], cpu["face"])
        depth = float((got["depth"][hit] - cpu["depth"][hit]).abs().max())
        bary = float((got["bary"] - cpu["bary"]).abs().max())
        ms = event_ms(lambda fn=methods[m]: fn(sv, faces), reps=3, samples=3)
        print(f"rasterize {m} on the card vs the CPU ({W}x{H}, F={faces.shape[0]}): face maps "
              f"equal {equal}, max|Δ| depth {depth:.3e}, bary {bary:.3e}; {ms:.4f} ms a call")
        if not (equal and depth <= 1e-5 and bary <= 1e-5):
            raise AssertionError(f"{m}: the card's z-buffer differs from the CPU's")
        numbers[m] = dict(ms=ms, depth_err=depth, bary_err=bary)
    numbers["planes"] = dict(ms=event_ms(lambda: methods["planes"](sv, faces), reps=3,
                                         samples=3))
    covered = (card["dense"]["face"] >= 0) | (card["windowed"]["face"] >= 0) | (
        card["planes"]["face"] >= 0)
    for a, b in (("dense", "windowed"), ("dense", "planes"), ("windowed", "planes")):
        fa, fb, da, db = card[a]["face"], card[b]["face"], card[a]["depth"], card[b]["depth"]
        both = (fa >= 0) & (fb >= 0)
        rel = (da - db).abs() / db.abs().clamp(min=1.0)
        # a depth tie: the two winners' depths within the methods' own depth
        # difference where they pick the same face (planes evaluate depth as
        # a·x + b·y + c, ~1e-3 relative off the barycentric sum on slivers),
        # or within 1e-5 (the windowed pass breaks ties on quantized depth)
        tau = max(float(rel[both & (fa == fb)].max()), 1e-5)
        differ = (fa != fb) & covered
        ties = differ & both & (rel <= tau)
        agree = 1.0 - float((differ & ~ties).sum()) / float(covered.sum())
        numbers[f"{a}_vs_{b}"] = dict(agree=agree, differ=int(differ.sum()),
                                      ties=int(ties.sum()), tie_rel_depth=tau)
        print(f"face maps {a} vs {b} on the card: {int(differ.sum())} of {int(covered.sum())} "
              f"covered pixels differ, {int(ties.sum())} of them depth ties (within {tau:.2e} "
              f"relative: the two methods' largest depth gap on a shared face, or 1e-5): agreement "
              f"{agree:.6f} ties aside")
        if not agree >= SCENE_METHOD_AGREEMENT:
            raise AssertionError(f"{a} and {b} face maps agree on {agree} of the covered "
                                 "pixels, depth ties aside")
    print(f"rasterize planes on the card: {numbers['planes']['ms']:.4f} ms a call")
    return numbers


def phase_scene(smi):
    """Config 7p on the card: the offline viewer (render_motion with the
    ground and the skeleton overlay, 32 frames: K1 once, K4b per frame, the
    dense checkerboard once) and its GIF, decoded again; the Phong scene
    (make_scene_render: per frame K4b at 1280 × 960 for render_mesh_phong,
    K4b for the skeleton's cylinders, K4a for the 80-face sphere, the dense
    locator dots and the label). Frames/s of each, median of 3 warm runs;
    frames 0-1's figures against JAX CPU's; frames 0-1 rendered again on the
    CPU (plain versions); the three new kernel passes held; the three
    rasterizer methods."""
    import tempfile

    from momentum_tpu_torch.gui import render_motion, save_gif
    from momentum_tpu_torch.gui.gif import _quantize
    from momentum_tpu_torch.rasterizer import downsample, render, render_mesh_phong
    from momentum_tpu_torch.rasterizer.materials import _phong_screen
    from momentum_tpu_torch.testing import workloads as wl

    char, motion, cam = wl.build_scene_clip(32, seed=SEED, device="cuda")
    frames, w, h = motion.shape[0], wl.SCENE_WIDTH, wl.SCENE_HEIGHT
    jax_cpu = _load_jax_cpu(SCENE_JAX_CPU_FILE)
    binned, full = "raster_planes_binned_kernel", "raster_planes_kernel"

    passes = wl.scene_passes(char, cam, motion)
    held = {label: _hold_raster(label, kernel, *passes[name])
            for label, kernel, name in (("config 7p Phong pass, frame 0", binned, "phong"),
                                        ("config 7p skeleton pass, frame 0", binned, "skeleton"),
                                        ("config 7p sphere pass, frame 0", full, "sphere"))}
    states, verts, _ = wl.scene_poses(char, motion[:1])
    depth = cam.project(states[0, :, :3])[0][:, 2]
    width_px = 2 * wl.SCENE_BONE_RADIUS * float(cam.intrinsics.fx) / depth
    print(f"config 7p bones: radius {wl.SCENE_BONE_RADIUS} m, {float(width_px.min()):.2f} to "
          f"{float(width_px.max()):.2f} px wide at frame 0's joints; the skeleton pass has "
          f"{passes['skeleton'][1].shape[0]} faces, the Phong pass "
          f"{int((passes['phong'][1] != 0).any(1).sum())} of {passes['phong'][1].shape[0]} "
          "faces left by back-face culling")
    if not float(width_px.min()) >= 3.0:
        raise AssertionError("config 7p: a bone is under 3 px wide")
    methods = phase_scene_methods(char, cam, motion)
    ground_rgb = wl.scene_ground(cam, verts[0])[1].cpu().numpy()

    def viewer():
        return render_motion(char, motion, w, h, camera=cam, ground=True, skeleton_overlay=True)

    view_counts, views, view_wall = _timed_runs(viewer)
    render_scene = wl.make_scene_render(char, cam)
    scene_counts, scenes, scene_wall = _timed_runs(lambda: render_scene(motion))
    print(f"config 7p viewer ({frames} frames, {w}x{h}, ground + skeleton overlay): "
          f"{frames / view_wall:.2f} frames/s (median wall {view_wall * 1e3:.1f} ms of 3) on "
          f"{smi}; launches {view_counts}")
    print(f"config 7p Phong scene ({frames} frames, {w}x{h} @ 2x2 SS, ground, skeleton, "
          f"sphere, locators, label): {frames / scene_wall:.2f} frames/s (median wall "
          f"{scene_wall * 1e3:.1f} ms of 3) on {smi}; launches {scene_counts}")
    for name, imgs in (("viewer", views), ("Phong scene", scenes)):
        if imgs.shape != (frames, h, w, 3) or not np.isfinite(imgs).all():
            raise AssertionError(f"config 7p {name}: images {imgs.shape} of the wrong shape "
                                 "or not finite")
    if (view_counts[binned], view_counts[full]) != (frames, 0) or \
            view_counts["fk_global_kernel"] < 1:
        raise AssertionError(f"config 7p viewer: expected {frames} K4b launches and ≥ 1 K1 "
                             f"launch, got {view_counts}")
    if (scene_counts[binned], scene_counts[full]) != (2 * frames, frames) or \
            scene_counts["fk_global_kernel"] < 1:
        raise AssertionError(f"config 7p scene: expected {2 * frames} K4b and {frames} K4a "
                             f"launches and ≥ 1 K1 launch, got {scene_counts}")
    held_frames = list(SCENE_HELD_FRAMES)
    figures = {"viewer": _hold_scene_figures("viewer", views[held_frames], ground_rgb,
                                             jax_cpu["viewer"]),
               "phong": _hold_scene_figures("Phong scene", scenes[held_frames], ground_rgb,
                                            jax_cpu["phong"])}

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "motion.gif")
        t0 = time.perf_counter()
        save_gif(path, views, fps=30.0)
        gif_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        gw, gh, decoded = _decode_gif(path)
    want = [_quantize((np.clip(v, 0.0, 1.0) * 255).astype(np.uint8)) for v in views]
    same = len(decoded) == frames and all(np.array_equal(d, q) for d, q in zip(decoded, want))
    print(f"config 7p GIF: {size} bytes in {gif_s:.2f} s, decodes to {len(decoded)} frames of "
          f"{gw}x{gh}, equal to the quantized frames: {same}")
    if not (same and (gw, gh) == (w, h)):
        raise AssertionError("config 7p: the GIF does not decode to the rendered frames")

    # frames 0-1 again on the CPU, built anew there from the same seed
    cchar, cmotion, ccam = wl.build_scene_clip(32, seed=SEED, device="cpu")
    cviews = render_motion(cchar, cmotion[held_frames], w, h, camera=ccam, ground=True,
                           skeleton_overlay=True)
    gstates, gverts, _ = wl.scene_poses(char, motion[held_frames])
    _, cverts, _ = wl.scene_poses(cchar, cmotion[held_frames])
    reference = {}
    for k, i in enumerate(held_frames):
        g = render_mesh_phong(cam, gverts[k], char.mesh.faces, w, h, supersample=2)
        c = render_mesh_phong(ccam, cverts[k], cchar.mesh.faces, w, h, supersample=2)
        # the faces agree at a pixel when they agree at its 2 × 2 subsamples:
        # the supersampled pass's face maps, as render_mesh_phong rasterizes it
        subsamples = [render._rasterize_dispatch(*_phong_screen(cm, v, ch.mesh.faces, 2),
                                                 2 * w, 2 * h)["face"].cpu()
                      for cm, v, ch in ((cam, gverts[k], char), (ccam, cverts[k], cchar))]
        faces_agree = downsample((subsamples[0] == subsamples[1]).float(), 2) == 1.0
        mc, cov = c["mask"], int(c["mask"].sum())
        flipped = int((g["mask"].cpu() != mc).sum())
        face_same = faces_agree & mc
        delta = (g["color"].cpu() - c["color"]).abs().max(-1).values[face_same]
        off = int((delta > 1e-3).sum())
        view_agree = float((np.abs(views[i] - cviews[k]).max(-1) <= 1e-3).mean())
        # smooth shading interpolates the vertex normals, so on a sliver face
        # the devices' last-bit differences in the skinned vertices move a
        # pixel's barycentrics, and its colour, past 1e-3 now and then
        print(f"config 7p frame {i} against the CPU: Phong pass {cov} covered pixels, {flipped} "
              f"differ on the card; of the {int(face_same.sum())} whose four subsamples' faces "
              f"agree, {off} differ in colour by > 1e-3 (the largest by "
              f"{float(delta.max()):.3e}); viewer frame colours agree to 1e-3 on "
              f"{view_agree:.6f} of the pixels")
        allowed = max(3, cov // 1000)
        if not (cov > 0 and flipped <= allowed and off <= allowed and view_agree >= 0.999):
            raise AssertionError(f"config 7p frame {i}: the card's render disagrees with the "
                                 "CPU's")
        reference[str(i)] = dict(covered=cov, flipped=flipped, colour_off=off,
                                 viewer_agree=view_agree)
    numbers = dict(viewer=dict(frames_per_s=frames / view_wall, wall_s=view_wall,
                               launches=view_counts, gif_bytes=size, gif_s=gif_s),
                   phong=dict(frames_per_s=frames / scene_wall, wall_s=scene_wall,
                              launches=scene_counts),
                   figures=figures, cpu_reference=reference, methods=methods,
                   bone_width_px=[float(width_px.min()), float(width_px.max())])
    return dict(viewer=view_counts, phong=scene_counts), numbers, held


def _relres_cols(a, damp, b, x):
    """max over systems and right-hand-side columns of ‖(A+D)x − b‖/‖b‖, and
    ‖(A+D)x‖ for a column b = 0 (the SPIKE spikes' columns are zero in
    most rows)."""
    cols_b = b[..., None] if b.ndim == a.ndim - 1 else b
    cols_x = x[..., None] if x.ndim == a.ndim - 1 else x
    ad = (a + torch.diag_embed(damp)).double()
    nr = torch.linalg.norm(ad @ cols_x.double() - cols_b.double(), dim=-2)
    nb = torch.linalg.norm(cols_b.double(), dim=-2)
    return float(torch.where(nb > 0, nr / torch.where(nb > 0, nb, 1.0), nr).max())


def phase_f7():
    """ROADMAP F7: float32 systems past the kernel's shared memory (n = 225
    and 300) and (B, n, 3) right-hand sides go through math/linalg.py to
    damped_chol_solve_kernel, one launch each, as JAX gives them its TPU
    kernel, and are held against the plain solve; float64 takes the plain
    solve on the card with no launch. The kernel's workspace form (n = 300)
    is timed in turns with the plain solve."""
    from momentum_tpu_torch.math import linalg
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.testing.profile_workload import in_turns

    g = torch.Generator(device="cpu").manual_seed(SEED)

    def spd(n, dtype=torch.float32):
        j = torch.randn(64, n + 20, n, generator=g, dtype=torch.float64)
        a = j.transpose(-1, -2) @ j
        damp = 0.01 * a.diagonal(dim1=-2, dim2=-1) + 1e-5
        b = torch.randn(64, n, generator=g, dtype=torch.float64)
        return tuple(t.to(dtype).cuda() for t in (a, damp, b))

    def rhs3(system):
        a, d, b = system
        return a, d, torch.stack([b, 2 * b + 1, -b], dim=-1).contiguous()

    cases = {"n = 225": (spd(225), 1), "n = 300": (spd(300), 1),
             "(B, n, 3) right-hand side": (rhs3(spd(157)), 1),
             "n = 300, (B, n, 3) right-hand side": (rhs3(spd(300)), 1),
             "float64": (spd(157, torch.float64), 0)}
    report = []
    for label, ((a, d, b), want) in cases.items():
        psd.launches = 0
        x = linalg.damped_psd_solve(a, d, b)
        launched = psd.launches
        x_plain = psd.damped_chol_solve_plain(a, d, b)
        torch.cuda.synchronize()
        res = _relres_cols(a, d, b, x)
        x_rel = float((x - x_plain).abs().max() / x_plain.abs().max())
        report.append(f"{label}: {launched} launch(es), max rel. residual {res:.2e}, "
                      f"max|x - x_plain| {x_rel:.2e} of max|x|")
        if (launched != want or x.shape != b.shape or not res <= PSD_RELRES_TOL
                or not x_rel <= PSD_X_TOL):
            raise AssertionError("F7: " + report[-1])
    a, d, b = cases["n = 300"][0]
    t = in_turns({"kernel": lambda: psd.damped_chol_solve(a, d, b),
                  "plain": lambda: psd.damped_chol_solve_plain(a, d, b)})
    print("F7: " + "; ".join(report) + f" (tol {PSD_RELRES_TOL:.0e}, {PSD_X_TOL:.0e}); "
          f"n = 300, B = 64 in turns: kernel (workspace form) {t['kernel']:.4f} ms, "
          f"plain {t['plain']:.4f} ms")


def phase_f8(char, x0):
    """ROADMAP F8: gradients of a seeded loss through K1 (its backward is the
    VJP of the plain lifted FK) against those through the plain FK, at
    B = 256 of the IK problem. The loss is quadratic in the FK output, so
    its cotangent, and the gradient, carry K1's forward."""
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.ops import fk as fk_ops

    skel = char.skeleton
    g = torch.Generator(device="cpu").manual_seed(SEED)
    weight = torch.randn(256, skel.num_joints, 8, generator=g).cuda()
    grads, launched = {}, {}
    for name, fk_fn in (("kernel", fk_ops.fk_global), ("plain", fk_ops.fk_global_plain)):
        x = x0[:256].clone().requires_grad_()
        fk_ops.launches = 0
        out = fk_fn(skel, fk.local_skel_states(skel, char.parameter_transform.apply(x)))
        (0.5 * (out * weight).square().sum()).backward()
        grads[name], launched[name] = x.grad, fk_ops.launches
    rel = float((grads["kernel"] - grads["plain"]).abs().max() / grads["plain"].abs().max())
    print(f"F8: gradients through K1 against the plain FK (B=256): max|Δ| {rel:.2e} of "
          f"max|grad| (tol {FK_GRAD_TOL:.0e}); K1 launches {launched}")
    if launched != {"kernel": 1, "plain": 0} or not rel <= FK_GRAD_TOL:
        raise AssertionError(f"F8: gradients through K1 disagree: {rel}, launches {launched}")


def phase_f9(char, cam, motion):
    """ROADMAP F9: K4b's merge scratch grown by a pass on a side stream while
    that stream's earlier launch with the smaller scratch still waits behind
    a sleep; the default stream meanwhile allocates and zeroes memory of the
    small keys' size. Both streams' face maps must be the plain version's."""
    from momentum_tpu_torch.ops import raster
    from momentum_tpu_torch.rasterizer import render

    faces = char.mesh.faces
    passes = render.shadowed_passes(cam, _frame_vertices(char, motion), faces, 1280, 960)
    (sv, w, h, kw), (svl, wl, hl, kwl) = passes["shadow"], passes["camera"]
    refs = [raster.rasterize_planes_plain(sv, faces, w, h, bin_capacity=8, **kw)["face"],
            raster.rasterize_planes_plain(svl, faces, wl, hl, bin_capacity=8, **kwl)["face"]]
    torch.cuda.synchronize()
    raster._scratch.clear()
    raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)  # small pair, default stream
    small = raster._scratch[sv.device][0]
    n_keys, old_ptr = small.numel(), small.data_ptr()
    del small
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # ~0.1 s: the host queues all below first
        a = raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)
        b = raster.rasterize_planes(svl, faces, wl, hl, bin_capacity=8, **kwl)  # grows it
    reused = []
    for _ in range(64):
        reused.append(torch.zeros(n_keys, dtype=torch.int64, device=sv.device))
        if reused[-1].data_ptr() == old_ptr:
            break
    c = raster.rasterize_planes(sv, faces, w, h, bin_capacity=8, **kw)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    same = [torch.equal(a["face"], refs[0]), torch.equal(b["face"], refs[1]),
            torch.equal(c["face"], refs[0])]
    print(f"F9: merge scratch grown on a side stream ({n_keys} -> "
          f"{raster._scratch[sv.device][0].numel()} keys); face maps equal to the plain "
          f"version's: side small {same[0]}, side large {same[1]}, default small {same[2]}")
    if not all(same):
        raise AssertionError(f"F9: a face map differs from the plain version's: {same}")


class _RegionTimer:
    """Wraps module functions to time each call: the host's clock around a
    synchronized call and CUDA events on the current stream. Times are
    exclusive: a region's excludes the wrapped regions called inside it
    (the collectives within the assembly count as collectives)."""

    def __init__(self):
        self.host, self.device, self._stack, self._saved = {}, {}, [], []

    def wrap(self, module, attr, label):
        real = getattr(module, attr)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self._stack.append([0.0, 0.0])
            t0 = time.perf_counter()
            start.record()
            out = real(*args, **kwargs)
            end.record()
            torch.cuda.synchronize()
            host, dev = time.perf_counter() - t0, start.elapsed_time(end) / 1e3
            nested_host, nested_dev = self._stack.pop()
            if self._stack:
                self._stack[-1][0] += host
                self._stack[-1][1] += dev
            self.host[label] = self.host.get(label, 0.0) + host - nested_host
            self.device[label] = self.device.get(label, 0.0) + max(dev - nested_dev, 0.0)
            return out

        self._saved.append((module, attr, real))
        setattr(module, attr, timed)

    def restore(self):
        for module, attr, real in reversed(self._saved):
            setattr(module, attr, real)
        self._saved = []


def _sharded_rank(rank, world):
    """One rank of phase_sharded on cuda:0: config 5fs (its launches, walls,
    result), a GN iteration's split, the widest K2+K3 system of the solve
    (rank 0), the window-3 sequence, IKs and sharded tracking. Returns CPU
    tensors and plain values."""
    import torch.distributed as dist

    import momentum_tpu_torch.parallel.collectives as C
    import momentum_tpu_torch.sequence.sharded as S
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.parallel import solve_ik_sharded, track_poses_sharded
    from momentum_tpu_torch.sequence import AccelerationSequenceErrorFunction
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions

    torch.cuda.set_device(0)
    out, counts = {}, {}

    def synced_wall(run):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        dist.barrier()
        return res, time.perf_counter() - t0

    # ---- config 5fs: the main path, counted ----
    prob = w.build_sequence_problem(SEQUENCE_FRAMES, fullbody=True, device="cuda")
    opts = SolverOptions(max_iterations=SEQUENCE_ITERATIONS_JAX_CPU)

    def solve():
        return S.solve_sequence_sharded(prob.fn, prob.pf0, prob.u0, options=opts)

    solve()  # warm-up
    _reset_counts()
    res, wall = synced_wall(solve)
    counts["5fs"] = _counts("sharded_rank 5fs")
    walls = [wall] + [synced_wall(solve)[1] for _ in range(2)]
    out["5fs"] = dict(per_frame=res.per_frame.cpu(), universal=res.universal.cpu(),
                      error=float(res.error), iterations=res.iterations,
                      converged=bool(res.converged), walls=walls)

    # ---- a GN iteration's split, two iterations timed region by region ----
    timer = _RegionTimer()
    for module, attr, label in (
            (S, "_local_normal_equations", "assembly"),
            (S, "block_tridiag_solve", "local SPIKE (K2+K3)"), (S, "_lu_solve", "interface LU"),
            (S, "_sharded_error", "energy"), (S, "_sharded_step", "rest of the step"),
            (C, "shift", "collectives"), (C, "all_reduce_sum", "collectives"),
            (C, "all_reduce_max", "collectives"), (C, "all_gather", "collectives")):
        timer.wrap(module, attr, label)
    try:
        two = SolverOptions(max_iterations=2)
        _, wall2 = synced_wall(lambda: S.solve_sequence_sharded(prob.fn, prob.pf0, prob.u0,
                                                                options=two))
    finally:
        timer.restore()
    out["split"] = dict(host=timer.host, device=timer.device, iterations=2, wall=wall2)

    # ---- the widest K2+K3 system of an iteration (rank 0 returns it) ----
    seen, real = [], psd.damped_chol_solve

    def record(a, damp, b):
        if b.ndim == 3 and (not seen or b.shape[-1] > seen[0][2].shape[-1]):
            seen[:] = [(a.cpu(), damp.cpu(), b.cpu())]
        return real(a, damp, b)

    psd.damped_chol_solve = record
    try:
        S.solve_sequence_sharded(prob.fn, prob.pf0, prob.u0, options=SolverOptions(max_iterations=1))
    finally:
        psd.damped_chol_solve = real
    if rank == 0:
        out["widest"] = seen[0]
    del prob

    # ---- the window-3 sequence, padded ----
    acc = w.build_sequence_problem(SHARDED_ACCEL_FRAMES, fullbody=True, device="cuda")
    nj = acc.fn.character.skeleton.num_joints
    fn = dataclasses.replace(acc.fn, sequence_errors=acc.fn.sequence_errors + (
        AccelerationSequenceErrorFunction.create(nj, weight=0.5, device="cuda"),))
    n_it = SHARDED_ACCEL_ITERATIONS
    _reset_counts()
    res = S.solve_sequence_sharded(fn, acc.pf0, acc.u0, options=SolverOptions(
        max_iterations=n_it, min_iterations=n_it))
    torch.cuda.synchronize()
    counts["window3"] = _counts("sharded_rank window3")
    out["window3"] = dict(error=float(res.error), iterations=res.iterations,
                          finite=bool(torch.isfinite(res.per_frame).all()))
    del acc, fn

    # ---- IKs ----
    char, ef0, targets, x0 = w.build_fullbody_ik_problem(BATCH, seed=SEED, device="cuda")
    ik_fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    _reset_counts()
    res, wall = synced_wall(lambda: solve_ik_sharded(
        ik_fn, x0, options=SolverOptions(**SHARDED_IK_OPTIONS)))
    counts["iks"] = _counts("sharded_rank iks")
    out["iks"] = dict(params=res.params.cpu(), error=res.error.cpu(), wall=wall)
    del char, ef0, targets, x0, ik_fn

    # ---- tracking ----
    clip = w.build_tracking_clip(w.TRACKING_FRAMES, seed=SEED, device="cuda")
    markers = dataclasses.replace(clip.markers,
                                  positions=clip.markers.positions[:SHARDED_TRACK_FRAMES],
                                  occluded=clip.markers.occluded[:SHARDED_TRACK_FRAMES])
    cfg = dataclasses.replace(w._tracking_configs()[1], refine=(10, 5, 64))
    _reset_counts()
    res, wall = synced_wall(lambda: track_poses_sharded(clip.char, markers, config=cfg,
                                                        initial=clip.seed_params))
    counts["tracking"] = _counts("sharded_rank tracking")
    out["tracking"] = dict(motion=res.motion.cpu(), errors=res.errors.cpu(), wall=wall)
    out["counts"] = counts
    return out


def _sharded_references():
    """The single-device port solves phase_sharded holds the ranks against,
    on the same inputs: config 5f, the window-3 sequence, IK and tracking."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.sequence import AccelerationSequenceErrorFunction, solve_sequence
    from momentum_tpu_torch.solver import SkeletonSolverFunction, SolverOptions, solve_ik
    from momentum_tpu_torch.tracking import track_poses_batched

    ref = {}
    prob = w.build_sequence_problem(SEQUENCE_FRAMES, fullbody=True, device="cuda")
    res = w.make_sequence_solve(prob.fn)(prob.pf0, prob.u0)
    ref["5f"] = dict(per_frame=res.per_frame.cpu(), error=float(res.error),
                     iterations=res.iterations)
    skel = prob.fn.character.skeleton
    ref["local"] = fk.local_skel_states(
        skel, prob.fn.character.parameter_transform.apply(prob.gt)).contiguous()
    ref["skel"] = skel
    acc = w.build_sequence_problem(SHARDED_ACCEL_FRAMES, fullbody=True, device="cuda")
    nj = acc.fn.character.skeleton.num_joints
    fn = dataclasses.replace(acc.fn, sequence_errors=acc.fn.sequence_errors + (
        AccelerationSequenceErrorFunction.create(nj, weight=0.5, device="cuda"),))
    n_it = SHARDED_ACCEL_ITERATIONS
    res = solve_sequence(fn, acc.pf0, acc.u0, SolverOptions(max_iterations=n_it,
                                                             min_iterations=n_it))
    ref["window3"] = dict(error=float(res.error), iterations=res.iterations)
    char, ef0, targets, x0 = w.build_fullbody_ik_problem(BATCH, seed=SEED, device="cuda")
    ik_fn = SkeletonSolverFunction(char, (dataclasses.replace(ef0, target=targets),))
    res = solve_ik(ik_fn, x0, None, SolverOptions(**SHARDED_IK_OPTIONS), "levenberg_marquardt")
    ref["iks"] = dict(params=res.params.cpu(), error=res.error.cpu())
    clip = w.build_tracking_clip(w.TRACKING_FRAMES, seed=SEED, device="cuda")
    markers = dataclasses.replace(clip.markers,
                                  positions=clip.markers.positions[:SHARDED_TRACK_FRAMES],
                                  occluded=clip.markers.occluded[:SHARDED_TRACK_FRAMES])
    cfg = dataclasses.replace(w._tracking_configs()[1], refine=(10, 5, 64))
    res = track_poses_batched(clip.char, markers, cfg, initial=clip.seed_params)
    ref["tracking"] = dict(motion=res.motion.cpu(), errors=res.errors.cpu())
    ref["clip"] = (clip.char, markers)
    return ref


def _frame_marker_errors_mm(char, markers, motion):
    """(F,) each frame's mean distance (mm) of its visible markers."""
    from momentum_tpu_torch.tracking.tracker import _match_locators

    li, mi = _match_locators(char, markers)
    world = char.locators.world_positions(char.skeleton_states(motion.cuda())).cpu().numpy()
    pos, occ = markers.positions.cpu().numpy(), markers.occluded.cpu().numpy()
    dist = np.linalg.norm(world[:, li] - pos[:, mi], axis=-1)
    vis = ~occ[:, mi]
    return (dist * vis).sum(axis=1) / np.maximum(vis.sum(axis=1), 1)


def phase_sharded(smi):
    """The port's multi-process paths on the card: two gloo ranks (spawned,
    joined within SHARDED_TIMEOUT) share cuda:0 and run config 5fs
    (config 5f through solve_sequence_sharded: 512 frames a rank, SPIKE
    with 16 parts on each, the interface system on both), the window-3
    sequence at a frame count that pads, IKs at B = 2048 (1024 a rank) and
    sharded tracking of config 6s's clip; the single-device port solves
    on the same inputs afterwards. Holds: 5fs's final error against JAX
    CPU's and its iterations against the single-device solve's; the
    window-3 error; IKs' conv@1e-5 and median; tracking's marker error;
    K1 and K2+K3 launched on each rank; K2+K3 held at the shard's widest
    system, K1 at a rank's 512 frames."""
    from momentum_tpu_torch.testing.distributed import Ranks

    t0 = time.perf_counter()
    with Ranks(SHARDED_RANKS, _sharded_rank, timeout=SHARDED_TIMEOUT) as ranks:
        got = ranks.results()
    ranks_s = time.perf_counter() - t0
    ref = _sharded_references()
    r0 = got[0]
    for r, g in enumerate(got):
        if any(n == 0 for part in g["counts"].values() for n in part.values()):
            raise AssertionError(f"rank {r} did not run every kernel on every path: "
                                 f"{g['counts']}")
        if g["5fs"]["error"] != r0["5fs"]["error"] or not torch.equal(
                g["5fs"]["per_frame"], r0["5fs"]["per_frame"]):
            raise AssertionError(f"rank {r}'s 5fs result differs from rank 0's")

    # ---- 5fs ----
    s5, f5 = r0["5fs"], ref["5f"]
    wall = statistics.median(s5["walls"])
    want = SEQUENCE_ERROR_JAX_CPU["5f"]
    gap = s5["error"] / f5["error"] - 1
    dparam = float((s5["per_frame"] - f5["per_frame"]).abs().max())
    print(f"config 5fs (F={SEQUENCE_FRAMES} on {SHARDED_RANKS} gloo ranks sharing one card, "
          f"GN {s5['iterations']}): {SEQUENCE_FRAMES / wall:.1f} frames/s (median wall "
          f"{wall * 1e3:.1f} ms of {len(s5['walls'])}; both ranks on one card: the speed of a "
          f"correctness run, not a scaling figure) on {smi}; final error {s5['error']:.6e} "
          f"(JAX CPU {want:.6e}; single-device port {f5['error']:.6e}, relative gap "
          f"{gap:.3e}), iterations {s5['iterations']} (single-device {f5['iterations']}); "
          f"largest |Δ per-frame parameter| against the single-device solve {dparam:.3e} "
          f"(not held: null directions drift, F5)")
    if not (abs(s5["error"] / want - 1) <= SEQUENCE_RTOL
            and s5["iterations"] == f5["iterations"]):
        raise AssertionError(f"config 5fs: error {s5['error']} against JAX CPU's {want}, "
                             f"iterations {s5['iterations']} against {f5['iterations']}")
    if not bool(torch.isfinite(s5["per_frame"]).all()):
        raise AssertionError("config 5fs: parameters not finite")

    # ---- a GN iteration's split ----
    split = r0["split"]
    n_it = split["iterations"]
    parts = ("assembly", "collectives", "local SPIKE (K2+K3)", "interface LU", "energy",
             "rest of the step")
    print("config 5fs, a GN iteration on rank 0, exclusive times (host clock around "
          "synchronized calls / CUDA events, ms): " + ", ".join(
              f"{k} {split['host'].get(k, 0.0) / n_it * 1e3:.2f} / "
              f"{split['device'].get(k, 0.0) / n_it * 1e3:.2f}" for k in parts)
          + f"; the iteration {split['wall'] / n_it * 1e3:.2f} wall")

    # ---- window 3 ----
    w3, w3r = r0["window3"], ref["window3"]
    rel = abs(w3["error"] / w3r["error"] - 1)
    print(f"window-3 sequence (5f rig, F={SHARDED_ACCEL_FRAMES}, q=2, padded to "
          f"{-(-SHARDED_ACCEL_FRAMES // 4) * 4} on {SHARDED_RANKS} ranks, GN "
          f"{w3['iterations']}): error {w3['error']:.6e}, single-device {w3r['error']:.6e}, "
          f"relative {rel:.3e} (tol {SHARDED_ERROR_RTOL:.0e})")
    if not (w3["finite"] and rel <= SHARDED_ERROR_RTOL
            and w3["iterations"] == w3r["iterations"]):
        raise AssertionError(f"window-3 sequence: {w3} against {w3r}")

    # ---- IKs ----
    ik, ikr = r0["iks"], ref["iks"]
    e, er = ik["error"].numpy(), ikr["error"].numpy()
    conv, conv_r = float(np.mean(e < 1e-5)), float(np.mean(er < 1e-5))
    med, med_r = float(np.nanmedian(e)), float(np.nanmedian(er))
    dp = float((ik["params"] - ikr["params"]).abs().max())
    print(f"IKs (B={BATCH}, {BATCH // SHARDED_RANKS} a rank, LM 10): conv@1e-5 {conv:.4f} "
          f"(solve_ik {conv_r:.4f}), median sum-r2 {med:.4e} (solve_ik {med_r:.4e}), "
          f"largest |Δparams| {dp:.3e}; {BATCH / ik['wall']:.0f} solves/s (one card for both "
          f"ranks)")
    if not (abs(conv - conv_r) <= SHARDED_CONV_SLACK
            and abs(med / med_r - 1) <= SHARDED_MEDIAN_RTOL):
        raise AssertionError(f"IKs: conv {conv} / {conv_r}, median {med} / {med_r}")

    # ---- tracking ----
    char, markers = ref["clip"]
    fe = _frame_marker_errors_mm(char, markers, r0["tracking"]["motion"])
    fr = _frame_marker_errors_mm(char, markers, ref["tracking"]["motion"])
    print(f"sharded tracking (config 6s's clip, {SHARDED_TRACK_FRAMES} frames, LM 10 + 5 on "
          f"the clip's worst 64): per-frame marker error median {np.median(fe):.4f} mm / p90 "
          f"{np.percentile(fe, 90):.4f} (track_poses_batched {np.median(fr):.4f} / "
          f"{np.percentile(fr, 90):.4f}); largest per-frame difference "
          f"{np.abs(fe - fr).max():.3e} mm; {SHARDED_TRACK_FRAMES / r0['tracking']['wall']:.1f} "
          f"frames/s")
    if not (abs(np.median(fe) / np.median(fr) - 1) <= SHARDED_TRACK_MEDIAN_RTOL
            and abs(np.percentile(fe, 90) / np.percentile(fr, 90) - 1)
            <= SHARDED_TRACK_P90_RTOL):
        raise AssertionError("sharded tracking's marker errors disagree with "
                             "track_poses_batched's")

    # ---- kernels at the shard's shapes ----
    a, damp, b = (t.cuda() for t in r0["widest"])
    psd_numbers = _hold_psd_matrix(a, damp, b, "config 5fs's widest SPIKE step on a rank")
    fk_numbers = _hold_fk(ref["skel"], ref["local"][:SEQUENCE_FRAMES // SHARDED_RANKS],
                          "config 5fs's frames on a rank")
    launches = {f"rank{r}": g["counts"] for r, g in enumerate(got)}
    print(f"phase_sharded: {time.perf_counter() - t0:.1f} s (ranks {ranks_s:.1f} s); "
          f"launches {launches}")
    numbers = dict(frames_per_s=SEQUENCE_FRAMES / wall, error=s5["error"],
                   single_device_error=f5["error"], relative_gap=gap,
                   max_abs_param_diff=dparam, iterations=s5["iterations"],
                   split_ms={k: [split["host"].get(k, 0.0) / n_it * 1e3,
                                 split["device"].get(k, 0.0) / n_it * 1e3] for k in parts},
                   window3=dict(error=w3["error"], single_device=w3r["error"]),
                   iks=dict(conv_at_1e5=conv, median=med, solve_ik_conv=conv_r,
                            solve_ik_median=med_r, max_abs_param_diff=dp),
                   tracking=dict(median_mm=float(np.median(fe)),
                                 batched_median_mm=float(np.median(fr))))
    return launches, numbers, fk_numbers, psd_numbers


def _timed(run, repeats=1):
    """(result of the last call, median wall in s) of `run`, each call
    ending in a synchronize."""
    walls = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return out, statistics.median(walls)


def phase_io(smi, tracking_numbers):
    """Config IO, the file layer on the card (momentum_tpu_torch/io): the
    full-body rig with config U's bodies written to .glb with a 1024-frame
    motion, its markers, an identity and timestamps, and loaded onto the
    card, every member held to the written one (integers and names equal,
    floats bit for bit, the inverse bind pose recomputed by K1 within
    FK_TOL); its .model, .locators, legacy JSON, the full stack's .mppca and
    the .mmo round-tripped the same way; every file of tools/jax_reference_io
    read onto the card and held against what JAX's loaders gave
    (jax_reference_io.npz); the 1024 frames' skeleton states written as
    animation channels and loaded by FK on K1 (median of IO_REPEATS, within
    FK_TOL); the main path's IK at B = 2048 on the loaded rig against the same
    solve on the in-memory rig (conv@1e-5 within IO_CONV_SLACK, median Σr²
    within IO_MEDIAN_RTOL); config 6s's clip written as .trc, read back
    through compat.load_markers and tracked by track_clip_hierarchical
    (K1, K2+K3 at (343, 73)), its marker errors within 2% / 5% of the
    in-memory clip's run (phase_tracking's hierarchical stage, same rig,
    identity and settings); the committed take's real-format .c3d equal to
    its .trc to the TRC's 5 decimals. Each format's save and load times and
    bytes."""
    import pathlib
    import shutil

    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch import compat, io as tio
    from momentum_tpu_torch.character import Character
    from momentum_tpu_torch.device import to_host
    from momentum_tpu_torch.io import character_io, legacy_json, locators, pose_prior

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "io_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    counts, numbers, files = {}, {}, {}

    def record(fmt, name, save, load):
        """Save and load one format; its times and bytes."""
        _, save_s = _timed(save)
        loaded, load_s = _timed(load)
        size = os.path.getsize(path(name))
        files[fmt] = dict(save_ms=save_s * 1e3, load_ms=load_s * 1e3, bytes=size)
        print(f"config IO {fmt}: save {save_s * 1e3:.2f} ms, load onto the card "
              f"{load_s * 1e3:.2f} ms, {size} bytes")
        return loaded

    def hold(label, got, want, tol=0.0):
        bad = w.io_mismatches(got, want, tol)
        print(f"config IO {label}: {len(want)} tables held"
              + (f"; MISMATCHED {bad}" if bad else ""))
        if bad:
            raise AssertionError(f"config IO {label}: tables differ: {bad}")

    # 1. the rig with its bodies and a 1024-frame motion, round-tripped
    char, ef0, targets, x0 = w.build_fullbody_ik_problem(BATCH, seed=SEED, device="cuda")
    char = dataclasses.replace(char, physical_properties=w.utility_character(
        device="cuda").physical_properties)
    # a take-like motion: every parameter amp·sin(4πt + phase) over the
    # 1024 frames, amp U(0.05, 0.3), phase U(0, 2π)
    rng = np.random.default_rng(IO_SEED)
    p = char.num_model_parameters
    t = np.linspace(0.0, 1.0, IO_FRAMES)[:, None]
    motion = torch.as_tensor((rng.uniform(0.05, 0.3, p) * np.sin(
        4 * np.pi * t + rng.uniform(0, 2 * np.pi, p))).astype(np.float32), device="cuda")
    states = char.skeleton_states(motion)
    from momentum_tpu_torch.tracking import MarkerSequence

    markers = MarkerSequence(positions=char.locators.world_positions(states),
                             occluded=torch.as_tensor(rng.random((IO_FRAMES, 80)) < 0.05,
                                                      device="cuda"),
                             names=char.locators.names)
    identity = torch.as_tensor(rng.normal(0, 0.01, char.num_joints * 7).astype(np.float32),
                               device="cuda")
    stamps = 1_000_000 + 8_333 * np.arange(IO_FRAMES, dtype=np.int64)
    loaded, got_motion, fps, got_markers = record(
        "glb (rig, 1024 frames, markers)", "rig.glb",
        lambda: tio.save_character_glb(path("rig.glb"), char, motion=motion, fps=120.0,
                                       markers=markers, identity=identity, timestamps=stamps),
        lambda: tio.load_character_glb(path("rig.glb"), return_markers=True, device="cuda"))
    if loaded.skeleton.joint_parent.device.type != "cuda" or not got_motion.is_cuda:
        raise AssertionError("config IO: the loaded rig is not on the card")
    ibp = float((loaded.inverse_bind_pose - char.inverse_bind_pose).abs().max())
    hold("glb rig round trip (inverse bind pose max|d| "
         f"{ibp:.3e}, bit-equal {ibp == 0.0})", w.character_tables(loaded, "c"),
         w.character_tables(char, "c"), FK_TOL)
    lm_motion, lm_names, lm_identity, lm_joints = compat.load_motion(path("rig.glb"))
    hold("glb motion, markers, identity, timestamps",
         {"motion": to_host(got_motion), "positions": to_host(got_markers.positions),
          "occluded": to_host(got_markers.occluded), "names": np.asarray(got_markers.names),
          "fps": np.asarray(fps), "load_motion": lm_motion, "identity": lm_identity,
          "joints": np.asarray(lm_joints), "params": np.asarray(lm_names),
          "stamps": Character.load_motion_timestamps(path("rig.glb"))},
         {"motion": to_host(motion), "positions": to_host(markers.positions),
          "occluded": to_host(markers.occluded), "names": np.asarray(markers.names),
          "fps": np.asarray(120.0), "load_motion": to_host(motion),
          "identity": to_host(identity), "joints": np.asarray(char.skeleton.joint_names),
          "params": np.asarray(char.parameter_transform.names), "stamps": stamps})
    pt, limits = record(
        "model", "rig.model",
        lambda: pathlib.Path(path("rig.model")).write_text(tio.write_model_definition(
            char.parameter_transform, char.skeleton, char.limits)),
        lambda: tio.load_model_definition(path("rig.model"), loaded.skeleton))
    keep = ("transform", "offsets", "parameter_names", "parameter_sets") + w.IO_LIMIT_KEYS
    sub = lambda c: {k: v for k, v in w.character_tables(c, "m").items()  # noqa: E731
                     if k.split(".", 1)[1] in keep}
    hold(".model round trip", sub(dataclasses.replace(char, parameter_transform=pt,
                                                     limits=limits)), sub(char))
    loc = record("locators", "rig.locators", lambda: locators.save_locators(
        path("rig.locators"), char), lambda: tio.load_locators(path("rig.locators"), loaded))
    hold(".locators round trip", {k: to_host(getattr(loc, k)) for k in (
        "parent", "offset", "weight")} | {"names": np.asarray(loc.names)},
        {k: to_host(getattr(char.locators, k)) for k in ("parent", "offset", "weight")}
        | {"names": np.asarray(char.locators.names)})
    legacy = record("legacy json", "rig.json",
                    lambda: legacy_json.save_legacy_json(path("rig.json"), char),
                    lambda: tio.load_legacy_json(path("rig.json"), device="cuda"))
    skel_keys = ("joint_parent", "pre_rotation", "translation_offset", "joint_names",
                 "locator_parent", "locator_offset", "locator_weight", "locator_names")
    sub = lambda c: {k: v for k, v in w.character_tables(c, "j").items()  # noqa: E731
                     if k.split(".", 1)[1] in skel_keys}
    hold("legacy json round trip", sub(legacy), sub(char))
    prior = w.fullstack_modules(char, "cuda")[3].prior
    got_prior = record("mppca", "stack.mppca",
                       lambda: pose_prior.save_mppca(path("stack.mppca"), prior),
                       lambda: tio.load_mppca(path("stack.mppca"), device="cuda"))
    hold(".mppca round trip (L recomputed in float64 on the host)",
         {k: to_host(getattr(got_prior, k)) for k in ("mu", "cinv", "rpre")},
         {k: to_host(getattr(prior, k)) for k in ("mu", "cinv", "rpre")})
    mmo = record("mmo (1024 frames)", "rig.mmo",
                 lambda: character_io.save_character(path("rig.mmo"), char, motion=motion),
                 lambda: tio.load_mmo(path("rig.mmo")))
    hold(".mmo round trip", {"poses": mmo[0], "names": np.asarray(mmo[2])},
         {"poses": to_host(motion), "names": np.asarray(char.parameter_transform.names)})

    # 2. the files JAX wrote, read onto the card
    ref_dir = os.path.join(here, w.IO_REFERENCE_DIR)
    want = dict(np.load(os.path.join(ref_dir, "jax_reference_io.npz")))
    got, read_s = _timed(lambda: w.io_reference_loads(ref_dir, device="cuda"))
    hold(f"JAX's {len(os.listdir(ref_dir)) - 1} reference files read in {read_s:.2f} s "
         f"(FK-computed tables within {FK_TOL:.0e})", got, want, FK_TOL)

    # 3. skeleton-state loading (K1): FK over every frame of the file
    record("glb (1024 frames of skeleton states)", "states.glb",
           lambda: char.save_gltf_from_skel_states(path("states.glb"), states, fps=120.0),
           lambda: Character.load_gltf_with_skel_states(path("states.glb"), fps=120.0,
                                                        device="cuda"))
    _reset_counts()
    # at the file's own 120 Hz: the rate inferred from the float32 key times
    # is 120.001831 and drifts off the keys (ROADMAP F27)
    (_, got_states, _), load_s = _timed(lambda: Character.load_gltf_with_skel_states(
        path("states.glb"), fps=120.0, device="cuda"), IO_REPEATS)
    counts["state_load"] = {k: n // IO_REPEATS for k, n in _counts("io state_load").items()}
    err = float((got_states - states).abs().max())
    print(f"config IO skeleton-state load (F = {IO_FRAMES}, nJ = {char.num_joints}): "
          f"{IO_FRAMES / load_s:.0f} frames/s (median of {IO_REPEATS}, "
          f"{load_s * 1e3:.1f} ms) on {smi}; max|states - written| {err:.3e} "
          f"(tol {FK_TOL:.0e}); kernel launches a load {counts['state_load']}")
    if not (err <= FK_TOL and counts["state_load"]["fk_global_kernel"] >= 1):
        raise AssertionError(f"config IO: skeleton states {err} off or K1 not launched")
    numbers["state_load"] = dict(frames_per_s=IO_FRAMES / load_s, ms=load_s * 1e3,
                                 max_abs_err=err, launches=counts["state_load"])

    # 4. the main path's IK on the loaded rig against the in-memory rig
    from momentum_tpu_torch.testing.workloads import make_solve_batch

    runs = {}
    for name, rig in (("in_memory", char), ("loaded", loaded)):
        solve = make_solve_batch(rig, ef0, BATCH)
        solve(targets, x0)  # warm-up
        _reset_counts()
        res, wall = _timed(lambda: solve(targets, x0))
        counts[f"ik_{name}"] = _counts(f"io ik_{name}")
        e = res.error.cpu().numpy()
        runs[name] = dict(conv=float(np.mean(e < 1e-5)), median=float(np.nanmedian(e)),
                          solves_per_s=BATCH / wall, params=res.params)
    a, b = runs["loaded"], runs["in_memory"]
    same = bool(torch.equal(a["params"], b["params"]))
    print(f"config IO IK on the loaded rig (B = {BATCH}, LM 5 + 6 on 128): conv@1e-5 "
          f"{a['conv']:.4f} (in memory {b['conv']:.4f}), median sum-r2 {a['median']:.4e} "
          f"({b['median']:.4e}), parameters bit-equal {same}; {a['solves_per_s']:.0f} "
          f"solves/s on {smi}; kernel launches {counts['ik_loaded']}")
    if not (abs(a["conv"] - b["conv"]) <= IO_CONV_SLACK
            and abs(a["median"] - b["median"]) <= IO_MEDIAN_RTOL * b["median"]
            and all(n > 0 for n in counts["ik_loaded"].values())):
        raise AssertionError(f"config IO: IK on the loaded rig {a} against {b}")
    numbers["ik"] = dict(conv_at_1e5=a["conv"], median=a["median"],
                         in_memory_conv_at_1e5=b["conv"], in_memory_median=b["median"],
                         bit_equal=same, solves_per_s=a["solves_per_s"])

    # 5. config 6s's clip through a .trc file, tracked
    clip = w.build_tracking_clip(w.TRACKING_FRAMES, seed=SEED, device="cuda")
    raw = tio.RawMarkerData(np.where(to_host(clip.markers.occluded)[..., None], np.nan,
                                     to_host(clip.markers.positions)),
                            to_host(clip.markers.occluded), clip.markers.names, 120.0)
    take = record("trc (343 frames x 41 markers)", "take.trc",
                  lambda: tio.save_trc(path("take.trc"), raw),
                  lambda: compat.load_markers(path("take.trc"))[0].to_marker_sequence(
                      device="cuda"))
    with open(os.path.join(here, TRACKING_JAX_CPU_FILE)) as f:
        jax_cpu = json.load(f)
    rig = dataclasses.replace(clip.char, locators=dataclasses.replace(
        clip.char.locators, offset=torch.as_tensor(jax_cpu["locator_offsets"], device="cuda")))
    jax_identity = torch.as_tensor(jax_cpu["identity"], device="cuda")
    _reset_counts()
    hier, wall = _timed(lambda: w.track_clip_hierarchical(rig, take, jax_identity))
    counts["tracking"] = _counts("io tracking")
    d = w.clip_marker_errors_mm(rig, take, hier.motion)
    med, p90 = float(np.median(d)), float(np.percentile(d, 90))
    ref = tracking_numbers["hierarchical"]
    print(f"config IO tracking of the .trc take (343 frames, hierarchical): "
          f"{w.TRACKING_FRAMES / wall:.2f} frames/s on {smi}; marker error median {med:.4f} mm "
          f"(in memory {ref['median_mm']:.4f}), p90 {p90:.4f} mm ({ref['p90_mm']:.4f}); "
          f"kernel launches {counts['tracking']}")
    if not (bool(torch.isfinite(hier.motion).all())
            and abs(med - ref["median_mm"]) <= IO_TRACK_MEDIAN_RTOL * ref["median_mm"]
            and abs(p90 - ref["p90_mm"]) <= IO_TRACK_P90_RTOL * ref["p90_mm"]
            and all(n > 0 for n in counts["tracking"].values())):
        raise AssertionError(f"config IO: tracking of the .trc take {med} / {p90} against {ref}")
    numbers["tracking"] = dict(frames_per_s=w.TRACKING_FRAMES / wall, median_mm=med,
                               p90_mm=p90, in_memory_median_mm=ref["median_mm"],
                               in_memory_p90_mm=ref["p90_mm"])
    trc = tio.load_markers(os.path.join(ref_dir, "take.trc"))[0]
    c3d, c3d_s = _timed(lambda: tio.load_markers(os.path.join(ref_dir, "take_real.c3d"))[0])
    vis = ~trc.occluded
    printed = np.asarray([float(f"{v:.5f}") for v in c3d.positions[vis].reshape(-1)],
                         np.float32)
    if not (np.array_equal(c3d.occluded, trc.occluded)
            and np.array_equal(printed, trc.positions[vis].reshape(-1))):
        raise AssertionError("config IO: the committed .c3d's positions are not its .trc's")
    print(f"config IO c3d (64 frames, real points): read {c3d_s * 1e3:.2f} ms, "
          f"{os.path.getsize(os.path.join(ref_dir, 'take_real.c3d'))} bytes; positions equal "
          f"the .trc's to its 5 decimals")
    numbers["files"] = files
    shutil.rmtree(out_dir)

    # the kernels at the phase's shapes: K1 at the load's 1024 frames, K2+K3
    # at the .trc take's batched LM step
    from momentum_tpu_torch.character import fk

    local = fk.local_skel_states(loaded.skeleton,
                                 loaded.parameter_transform.apply(motion)).contiguous()
    fk_numbers = _hold_fk(loaded.skeleton, local, f"config IO's state load, B = {IO_FRAMES}")
    _, every = _tracking_systems(rig, take, jax_identity, hier.motion)
    psd_numbers = _hold_psd_matrix(*every, "config IO, the .trc take's batched LM step")
    return counts, numbers, fk_numbers, psd_numbers


def _io2_configs(cli_settings=False):
    """(tracking, calibration) configs of config IO2's pipeline: phase_tracking's
    (config 6's LM settings, workloads._tracking_configs), or with
    cli_settings those the process-markers CLI builds from
    IO2_CLI_OPTIONS (LM, IO2_CLI_ITERATIONS for both, regularization 0.05)."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.tracking import CalibrationConfig, TrackingConfig

    if not cli_settings:
        calibration, tracking, _ = w._tracking_configs()
        return tracking, calibration
    lm = "levenberg_marquardt"
    return (TrackingConfig(max_iter=IO2_CLI_ITERATIONS, method=lm, regularization=0.05),
            CalibrationConfig(calib_frames=10, major_iter=2, max_iter=IO2_CLI_ITERATIONS,
                              method=lm, regularization=0.05))


def _io2_worker(kind, out_dir, device):
    """One of config IO2's pipeline runs in a process of its own, beside
    the main process's process_marker_file call and the CLI: "in_memory",
    process_markers on the in-memory CMU rig and clip (cut to
    IO2_PIPELINE_FRAMES) with phase_tracking's settings, its motion and
    marker errors to in_memory.npz; "cli_call", process_marker_file on the
    phase's files with the CLI's settings, to call.mmo."""
    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch.tracking import MarkerSequence, process_marker_file, process_markers

    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    t0 = time.perf_counter()
    if kind == "in_memory":
        clip = w.build_tracking_clip(w.TRACKING_FRAMES, seed=SEED, device=device)
        n = IO2_PIPELINE_FRAMES
        markers = MarkerSequence(clip.markers.positions[:n], clip.markers.occluded[:n],
                                 clip.markers.names)
        result, _, _ = process_markers(clip.char, clip.seed_params, markers, *_io2_configs(),
                                       calibrate=True)
        d = w.clip_marker_errors_mm(clip.char, markers, result.motion)
        np.savez(path("in_memory.npz"), motion=result.motion.cpu().numpy(),
                 median_mm=np.median(d), p90_mm=np.percentile(d, 90),
                 wall_s=time.perf_counter() - t0)
    elif kind == "cli_call":
        process_marker_file(path("take.trc"), path("call.mmo"), *_io2_configs(True),
                            character_path=path("cmu.usda"), model_path=path("cmu.model"),
                            calibrate=True, device=device)
    else:
        raise ValueError(kind)


def _dense_skin(char):
    """(V, nJ) skin weights of a character, whatever the order of each
    vertex's influences."""
    sw = char.skin_weights
    d = torch.zeros(char.mesh.num_vertices, char.num_joints, device=sw.weight.device)
    return d.scatter_add_(1, sw.index.long(), sw.weight)


def _hold_bvh(label, got_c, got_jp, char, jp, translation_tol):
    """A BVH load against the written rig and joint parameters: the
    hierarchy and names (the loaded rig has an end site under each leaf,
    interleaved in the file's depth-first order), the offsets within 1e-6
    (printed to 6 decimals), the roots' translations within
    `translation_tol` and every joint rotation's matrix within 1e-6 (degrees
    printed to 6 decimals, the ZYX angles re-extracted in float32; past
    |ry| = π/2 the loader picks the other triple of the same rotation).
    BVH has no pre-rotations and no scale. → the three max|d|."""
    from momentum_tpu_torch.math import quaternion as quat

    names = list(got_c.skeleton.joint_names)
    perm = [names.index(nm) for nm in char.skeleton.joint_names]
    parents = char.skeleton.parents_np
    got_parents = got_c.skeleton.parents_np
    if any(got_parents[perm[j]] != (perm[p] if p >= 0 else -1) for j, p in enumerate(parents)):
        raise AssertionError(f"config IO2 {label}: the hierarchy differs")
    idx = torch.as_tensor(perm, device=got_jp.device)
    got7 = got_jp.reshape(got_jp.shape[0], -1, 7).index_select(1, idx)
    jp7 = jp.reshape(jp.shape[0], -1, 7)
    roots = torch.as_tensor(parents < 0, device=got_jp.device)
    e_off = _io2_held(f"{label} offsets", got_c.skeleton.translation_offset.index_select(0, idx),
                      char.skeleton.translation_offset, 1e-6)
    e_tr = _io2_held(f"{label} root translations", got7[:, roots, :3], jp7[:, roots, :3],
                     translation_tol)
    def rot(x):
        return quat.to_rotation_matrix(quat.euler_to_quaternion(x[..., 3:6], order="ZYX"))

    e_rot = _io2_held(f"{label} rotations", rot(got7), rot(jp7), 1e-6)
    return e_off, e_tr, e_rot


def _io2_held(label, got, want, atol, rtol=0.0):
    """max|got - want| (float64, NaN equal to NaN), raising past
    atol + rtol·|want|."""
    got = np.asarray(torch.as_tensor(got).detach().cpu(), np.float64)
    want = np.asarray(torch.as_tensor(want).detach().cpu(), np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"config IO2 {label}: shape {got.shape} against {want.shape}")
    both = np.isnan(got) & np.isnan(want)
    diff = np.where(both, 0.0, np.abs(got - want))
    err = float(np.max(diff)) if diff.size else 0.0
    if not np.all(diff <= atol + rtol * np.abs(np.where(both, 0.0, want))):
        raise AssertionError(f"config IO2 {label}: max|d| {err} past {atol} + {rtol}|x|")
    return err


def phase_io2(smi):
    """Config IO2, the file layer's second part on the card (FBX, USD, URDF,
    BVH) and the marker-file pipeline: JAX's files of
    tools/jax_reference_io2 read onto the card and held against what JAX's
    loaders gave; the full-body rig with its bodies and a 1024-frame motion
    round-tripped through .fbx, .usda, .usdc and .bvh, every member each
    format carries held to the written one (FbxBuilder's bytes save_fbx's);
    the 1024 frames' global states through save_with_skel_states (inverse
    FK, the pseudo-inverse) to .usda and .fbx and loaded back by FK on K1 at
    B = 1024; config 6s's clip (cut to IO2_PIPELINE_FRAMES) written as .trc
    with the CMU rig as .usda + .model through process_marker_file
    (calibration, per-frame tracking: K1, K2+K3 at (1, 73)) to .fbx, the
    result saved to .bvh and by save_motion to .glb, each read back to the
    result, its marker errors against process_markers on the in-memory rig
    and clip (a worker process); the CLI in a subprocess on the same files
    to .mmo, its motion the same call's with the CLI's settings (a worker
    process). Each format's save and load times and bytes."""
    import pathlib
    import shutil
    import subprocess
    import sys

    import momentum_tpu_torch.testing.workloads as w
    from momentum_tpu_torch import io as tio
    from momentum_tpu_torch.character import fk
    from momentum_tpu_torch.device import to_host
    from momentum_tpu_torch.io import usd
    from momentum_tpu_torch.tracking import (
        MarkerSequence, app_utils, process_marker_file, save_motion)

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", "io2_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = lambda name: os.path.join(out_dir, name)  # noqa: E731
    counts, numbers, files = {}, {}, {}
    t_phase = time.perf_counter()

    def record(fmt, name, save, load):
        _, save_s = _timed(save)
        loaded, load_s = _timed(load)
        size = os.path.getsize(path(name))
        files[fmt] = dict(save_ms=save_s * 1e3, load_ms=load_s * 1e3, bytes=size)
        print(f"config IO2 {fmt}: save {save_s * 1e3:.2f} ms, load onto the card "
              f"{load_s * 1e3:.2f} ms, {size} bytes")
        return loaded

    def hold_tables(label, got, want, tol=0.0, computed=()):
        bad = w.io_mismatches(got, want, tol, computed)
        print(f"config IO2 {label}: {len(want)} tables held" + (f"; MISMATCHED {bad}" if bad
                                                                  else ""))
        if bad:
            raise AssertionError(f"config IO2 {label}: tables differ: {bad}")

    # 0. the pipeline's files and its two worker processes, started first:
    # they run while this process does the rest (each process ~8 s to reach
    # the card; the runs are bound by the host's dispatch)
    clip = w.build_tracking_clip(w.TRACKING_FRAMES, seed=SEED, device="cuda")
    n = IO2_PIPELINE_FRAMES
    markers = MarkerSequence(clip.markers.positions[:n], clip.markers.occluded[:n],
                             clip.markers.names)
    occ = to_host(markers.occluded)
    tio.save_trc(path("take.trc"), tio.RawMarkerData(
        np.where(occ[..., None], np.nan, to_host(markers.positions)), occ,
        list(markers.names), 120.0))
    cmu = clip.char
    tio.save_usda(path("cmu.usda"), cmu)
    pathlib.Path(path("cmu.model")).write_text(tio.write_model_definition(
        cmu.parameter_transform, cmu.skeleton, cmu.limits))
    pathlib.Path(path("identity.json")).write_text(json.dumps(to_host(clip.seed_params)
                                                              .tolist()))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([here, os.environ.get("PYTHONPATH", "")]))
    cli_args = ["--markers", path("take.trc"), "--character", path("cmu.usda"), "--model",
                path("cmu.model"), "--out", path("cli.mmo"), *IO2_CLI_OPTIONS]
    procs = {
        "cli": subprocess.Popen([sys.executable, "-m",
                                 "momentum_tpu_torch.tracking.process_markers_app", *cli_args],
                                cwd=here, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True),
        **{kind: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--io2-worker",
                                   kind, out_dir, "cuda"], cwd=here, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
           for kind in ("in_memory", "cli_call")}}
    try:
        # 1. JAX's files, read onto the card
        ref_dir = os.path.join(here, w.IO2_REFERENCE_DIR)
        want = dict(np.load(os.path.join(ref_dir, "jax_reference_io2.npz")))
        got, read_s = _timed(lambda: w.io2_reference_loads(ref_dir, device="cuda"))
        hold_tables(f"JAX's {len(os.listdir(ref_dir)) - 1} reference files read in {read_s:.2f} s "
                    f"(FK-computed tables, the USD rest poses, the BVH motion within "
                    f"{FK_TOL:.0e})", got, want, FK_TOL, w.IO2_COMPUTED)

        # 2. the full-body rig with its bodies and a 1024-frame take-like
        # motion through each format, written and loaded by the port
        char = w.utility_character(device="cuda")
        rng = np.random.default_rng(IO_SEED)
        p = char.num_model_parameters
        t = np.linspace(0.0, 1.0, IO_FRAMES)[:, None]
        motion = torch.as_tensor((rng.uniform(0.05, 0.3, p) * np.sin(
            4 * np.pi * t + rng.uniform(0, 2 * np.pi, p))).astype(np.float32), device="cuda")
        jp = char.parameter_transform.apply(motion)
        states = char.skeleton_states(motion)
        tables = w.character_tables(char, "c")
        rest = ("c.pre_rotation", "c.translation_offset")

        loaded, got_jp, _ = record(
            "fbx (rig, 1024 frames)", "rig.fbx",
            lambda: tio.save_fbx(path("rig.fbx"), char, motion=motion, fps=120.0),
            lambda: tio.load_fbx_with_motion(path("rig.fbx"), fps=120.0, device="cuda"))
        if not (loaded.skeleton.joint_parent.is_cuda and got_jp.is_cuda):
            raise AssertionError("config IO2: the loaded FBX rig is not on the card")
        got_t = w.character_tables(loaded, "c")
        # FBX stores the pre-rotations as XYZ Euler degrees (float32 on the
        # way out): held within FK_TOL; the skin as clusters, held as the
        # dense (V, nJ) weights; no parameter transform, limits or locators
        e_pre = _io2_held("fbx pre-rotations", got_t["c.pre_rotation"], tables["c.pre_rotation"],
                          FK_TOL)
        keep = ("c.joint_parent", "c.joint_names", "c.translation_offset", "c.mesh_vertices",
                "c.mesh_faces", "c.inverse_bind_pose") + tuple(
                    k for k in tables if k.startswith("c.body_"))
        hold_tables("fbx rig round trip", {k: got_t[k] for k in keep},
                    {k: tables[k] for k in keep}, FK_TOL)

        e_skin = _io2_held("fbx skin weights", _dense_skin(loaded), _dense_skin(char), 1e-6)
        # joint parameters through float32 curves: rotations (as degrees) and
        # scales (as 2^s) within 1e-6 plus 2 ulps of float32 relative (a
        # tracked angle may wind to tens of radians); translations are
        # written with the rest offset added, so within 1e-6 plus 2 ulps of
        # float32 at the largest t + offset
        tr = (jp.reshape(IO_FRAMES, -1, 7)[..., :3] + char.skeleton.translation_offset)
        t_tol = 1e-6 + 2.0 ** -22 * float(tr.abs().max())
        jp7, got7 = jp.reshape(IO_FRAMES, -1, 7), got_jp.reshape(IO_FRAMES, -1, 7)
        e_fbx = max(_io2_held("fbx translations", got7[..., :3], jp7[..., :3], t_tol),
                    _io2_held("fbx rotations and scales", got7[..., 3:], jp7[..., 3:], 1e-6,
                              2.4e-7))
        builder = tio.FbxBuilder().add_character(char).add_motion(motion, fps=120.0).to_bytes()
        if builder != pathlib.Path(path("rig.fbx")).read_bytes():
            raise AssertionError("config IO2: FbxBuilder.to_bytes differs from save_fbx's bytes")
        print(f"config IO2 fbx round trip: pre-rotations max|d| {e_pre:.3e}, skin {e_skin:.3e}, "
              f"joint parameters {e_fbx:.3e} (translations tol {t_tol:.1e}); "
              f"FbxBuilder.to_bytes equal to save_fbx's")

        # USD carries no limits, parameter sets or pose presets, and its skin
        # as each vertex's influences sorted by weight (held as the dense
        # weights); the rest pose comes from the rest matrices by from_matrix
        # (FK_TOL); usda writes floats with 8 significant digits (a float32
        # needs 9): its floats within 2e-7 relative, usdc's bit for bit
        skip = rest + ("c.parameter_sets", "c.pose_constraints", "c.skin_index",
                       "c.skin_weight") + tuple(f"c.{k}" for k in w.IO_LIMIT_KEYS)
        for ext in ("usda", "usdc"):
            got_c, got_m = record(f"{ext} (rig, 1024 frames)", f"rig.{ext}",
                                  lambda: tio.save_usd(path(f"rig.{ext}"), char, motion=motion,
                                                       fps=120.0),
                                  lambda: tio.load_usd(path(f"rig.{ext}"), device="cuda"))
            got_t = w.character_tables(got_c, "c")
            missing = set(tables) - set(got_t) - {"c.mesh_normals"}
            if missing:
                raise AssertionError(f"config IO2: {ext} lost {sorted(missing)}")
            e_rest = max(_io2_held(f"{ext} rest pose", got_t[k], tables[k], FK_TOL)
                         for k in rest)
            common = [k for k in tables if k in got_t and k not in skip]
            rtol = 2e-7 if ext == "usda" else 0.0
            text = [k for k in common if rtol and np.asarray(tables[k]).dtype.kind == "f"
                    and k != "c.inverse_bind_pose"]
            e_text = max([_io2_held(f"{ext} {k}", got_t[k], tables[k], 0.0, rtol)
                          for k in text] + [_io2_held(f"{ext} motion", got_m, motion, 0.0, rtol),
                                            _io2_held(f"{ext} skin weights", _dense_skin(got_c),
                                                      _dense_skin(char), 0.0, rtol)])
            hold_tables(f"{ext} rig round trip", {k: got_t[k] for k in common if k not in text},
                        {k: tables[k] for k in common if k not in text}, FK_TOL)
            print(f"config IO2 {ext} round trip: rest pose max|d| {e_rest:.3e}, floats, skin "
                  f"and motion {e_text:.3e} (rtol {rtol:.0e})")

        got_c, got_jp, _ = record(
            "bvh (rig, 1024 frames)", "rig.bvh",
            lambda: tio.save_bvh(path("rig.bvh"), char, jp, fps=120.0),
            lambda: tio.load_bvh(path("rig.bvh"), device="cuda"))
        # BVH carries the hierarchy, the offsets and, per frame, the roots'
        # translations and every joint's ZYX rotation (no pre-rotations, no
        # scale), printed to 6 decimals: offsets and translations within
        # 5e-7 plus float32 rounding, the rotations (degrees printed to 6
        # decimals, the Euler angles re-extracted in float32) within 1e-6
        e_off, e_tr, e_rot = _hold_bvh("bvh", got_c, got_jp, char, jp, 1e-6)
        print(f"config IO2 bvh round trip: offsets max|d| {e_off:.3e}, root translations "
              f"{e_tr:.3e}, rotations {e_rot:.3e}; {got_c.num_joints - char.num_joints} end "
              f"sites")

        # 3. the 1024 frames' global states through save_with_skel_states
        # and back by FK (K1 at B = 1024)
        numbers["skel_states"] = {}
        for ext in (".usda", ".fbx"):
            name = f"states{ext}"
            _, save_s = _timed(lambda: char.save_with_skel_states(path(name), states, fps=120.0))
            if ext == ".usda":
                def load():
                    return usd.load_character_with_skel_states(path(name), device="cuda")[1]
            else:
                def load():
                    c, j, _ = tio.load_fbx_with_motion(path(name), fps=120.0, device="cuda")
                    return fk.global_skel_states(c.skeleton, j)
            # one timed load: parsing the 10 MB .usda takes seconds on the host
            _reset_counts()
            got_s, load_s = _timed(load)
            k = f"state_load_{ext[1:]}"
            counts[k] = _counts(f"io2 {k}")
            err_t = float((got_s[..., :3] - states[..., :3]).abs().max())
            err_r = float((got_s[..., 3:] - states[..., 3:]).abs().max())
            print(f"config IO2 skeleton states through {ext} (F = {IO_FRAMES}): save "
                  f"{save_s * 1e3:.1f} ms, {os.path.getsize(path(name))} bytes; load "
                  f"{IO_FRAMES / load_s:.0f} frames/s ({load_s * 1e3:.1f} ms) on {smi}; "
                  f"max|d| translations {err_t:.3e} m, "
                  f"rotations and scales {err_r:.3e} (tol {IO2_STATES_TOL:.0e}); kernel "
                  f"launches a load {counts[k]}")
            if not (max(err_t, err_r) <= IO2_STATES_TOL and counts[k]["fk_global_kernel"] >= 1):
                raise AssertionError(f"config IO2: skeleton states through {ext} "
                                     f"{err_t} / {err_r} off, or K1 not launched")
            numbers["skel_states"][ext[1:]] = dict(
                frames_per_s=IO_FRAMES / load_s, load_ms=load_s * 1e3, save_ms=save_s * 1e3,
                max_abs_err_translation=err_t, max_abs_err_rotation_scale=err_r,
                launches=counts[k])
        fk_local = fk.local_skel_states(char.skeleton, jp).contiguous()

        # 4. the marker-file pipeline: the CMU rig from .usda + .model, the
        # .trc take, calibration and per-frame tracking, to .fbx
        tracking, calibration = _io2_configs()
        _reset_counts()
        result, wall = _timed(lambda: process_marker_file(
            path("take.trc"), path("take.fbx"), tracking, calibration,
            character_path=path("cmu.usda"), model_path=path("cmu.model"),
            identity_path=path("identity.json"), calibrate=True, device="cuda"))
        counts["pipeline"] = _counts("io2 pipeline")
        rig, identity = app_utils.load_character_with_identity(
            path("cmu.usda"), path("cmu.model"), path("identity.json"), device="cuda")
        d = w.clip_marker_errors_mm(rig, markers, result.motion)
        med, p90 = float(np.median(d)), float(np.percentile(d, 90))
        print(f"config IO2 process_marker_file (.trc {n} frames x 41 markers, CMU rig from "
              f".usda + .model, calibration + per-frame tracking, to .fbx): {n / wall:.2f} "
              f"frames/s (wall {wall:.2f} s) on {smi}; marker error median {med:.4f} mm, p90 "
              f"{p90:.4f} mm; kernel launches {counts['pipeline']}")
        if not (bool(torch.isfinite(result.motion).all())
                and all(v > 0 for v in counts["pipeline"].values())):
            raise AssertionError(f"config IO2: the pipeline's motion is not finite or a kernel "
                                 f"was not launched: {counts['pipeline']}")
        pt = rig.parameter_transform
        rjp = pt.apply(result.motion)
        rjp7 = rjp.reshape(n, -1, 7)
        tr = rjp7[..., :3] + rig.skeleton.translation_offset
        t_tol = 1e-6 + 2.0 ** -22 * float(tr.abs().max())
        _, fbx_jp, _ = tio.load_fbx_with_motion(path("take.fbx"), fps=120.0, device="cuda")
        fbx7 = fbx_jp.reshape(n, -1, 7)
        e_fbx = max(_io2_held("pipeline .fbx translations", fbx7[..., :3], rjp7[..., :3], t_tol),
                    _io2_held("pipeline .fbx rotations and scales", fbx7[..., 3:],
                              rjp7[..., 3:], 1e-6, 2.4e-7))
        tio.save_bvh(path("take.bvh"), rig, rjp, fps=120.0)
        bvh_c, bvh_jp, _ = tio.load_bvh(path("take.bvh"), device="cuda")
        # the CMU rig is in mm: its root translations (to 2000 mm) printed to
        # 6 decimals, then rounded to float32
        roots = torch.as_tensor(rig.skeleton.parents_np < 0, device="cuda")
        b_tol = 1e-6 + 2.0 ** -23 * float(rjp7[:, roots, :3].abs().max())
        e_bvh = max(_hold_bvh("pipeline .bvh", bvh_c, bvh_jp, rig, rjp, b_tol))
        scaling = torch.as_tensor(pt.scaling_parameters, device="cuda")
        ident = torch.where(scaling, result.motion[0], torch.zeros_like(result.motion[0]))
        save_motion(path("take.glb"), rig, ident, result.motion, markers, fps=120.0)
        glb_m, glb_names, glb_identity, _ = tio.load_motion(path("take.glb"))
        stripped = torch.where(scaling, torch.zeros_like(result.motion), result.motion)
        e_glb = max(_io2_held("pipeline .glb motion", glb_m, stripped, 1e-6),
                    _io2_held("pipeline .glb identity", glb_identity, pt.apply(ident), 1e-6))
        print(f"config IO2 pipeline outputs read back: .fbx joint parameters max|d| "
              f"{e_fbx:.3e} (translations tol {t_tol:.1e}), .bvh {e_bvh:.3e} (root translations "
              f"tol {b_tol:.1e}), .glb (save_motion, identity split out) {e_glb:.3e}")

        # the in-memory run and the CLI, from their processes
        outs = {}
        for kind, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=IO2_WORKER_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                raise AssertionError(f"config IO2: the {kind} process ran past "
                                     f"{IO2_WORKER_TIMEOUT} s")
            outs[kind] = out
            if proc.returncode != 0:
                raise AssertionError(f"config IO2: the {kind} process exited "
                                     f"{proc.returncode}:\n{err[-4000:]}")
        mem = dict(np.load(path("in_memory.npz")))
        ref_med, ref_p90 = float(mem["median_mm"]), float(mem["p90_mm"])
        print(f"config IO2 pipeline against process_markers on the in-memory rig and clip "
              f"(another process, {float(mem['wall_s']):.1f} s): median {med:.4f} mm "
              f"({ref_med:.4f}), p90 {p90:.4f} mm ({ref_p90:.4f}); motion max|d| "
              f"{float(np.abs(to_host(result.motion) - mem['motion']).max()):.3e}")
        if not (abs(med - ref_med) <= IO_TRACK_MEDIAN_RTOL * ref_med
                and abs(p90 - ref_p90) <= IO_TRACK_P90_RTOL * ref_p90):
            raise AssertionError(f"config IO2: marker errors {med} / {p90} against the "
                                 f"in-memory run's {ref_med} / {ref_p90}")
        cli_motion, _, cli_names, _ = tio.load_mmo(path("cli.mmo"))
        call_motion = tio.load_mmo(path("call.mmo"))[0]
        same = bool(np.array_equal(cli_motion, call_motion))
        cli_d = w.clip_marker_errors_mm(rig, markers, torch.as_tensor(cli_motion, device="cuda"))
        print(f"config IO2 CLI (python -m momentum_tpu_torch.tracking.process_markers_app "
              f"{' '.join(IO2_CLI_OPTIONS)}): exit 0, .mmo {cli_motion.shape} loads, motion "
              f"bit-equal to process_marker_file's with the CLI's settings {same}; marker error "
              f"median {float(np.median(cli_d)):.4f} mm; its lines: "
              + " | ".join(outs["cli"].strip().splitlines()))
        if not (same and list(cli_names) == list(rig.parameter_transform.names)):
            raise AssertionError("config IO2: the CLI's motion is not the call's")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()

    numbers.update(files=files, pipeline=dict(
        frames=n, frames_per_s=n / wall, wall_s=wall, median_mm=med, p90_mm=p90,
        in_memory_median_mm=ref_med, in_memory_p90_mm=ref_p90, launches=counts["pipeline"],
        cli_bit_equal=same), phase_s=time.perf_counter() - t_phase)
    # the kernels at the phase's shapes: K1 at the state loads' 1024 frames,
    # K2+K3 at the pipeline's per-frame step (1, 73)
    fk_numbers = _hold_fk(char.skeleton, fk_local, f"config IO2's state loads, B = {IO_FRAMES}")
    one, _ = _tracking_systems(rig, MarkerSequence(markers.positions[:2], markers.occluded[:2],
                                                   markers.names), identity, result.motion[:2])
    psd_numbers = _hold_psd_matrix(*one, "config IO2, the pipeline's per-frame LM step")
    shutil.rmtree(out_dir)
    print(f"config IO2: {time.perf_counter() - t_phase:.1f} s")
    return counts, numbers, fk_numbers, psd_numbers


def main():
    t_start = time.perf_counter()

    def lap(label):
        print(f"[{time.perf_counter() - t_start:.1f} s: {label} done]", flush=True)

    kind, smi = phase_device()
    phase_build()
    from momentum_tpu_torch.testing.workloads import build_fullbody_ik_problem

    char, ef0, targets, x0 = build_fullbody_ik_problem(BATCH, seed=SEED, device="cuda")
    fk_numbers, fk_by_batch = phase_fk(char, x0)
    psd_numbers, psd_by_batch, psd_factor_only = phase_psd(char, ef0, targets, x0)
    counts = phase_main_path(char, ef0, targets, x0, smi)
    jac_numbers = phase_jacobian()
    proj_numbers, proj_launches = phase_projection_jacobian()
    phase_small_reference()
    phase_f7()
    phase_f8(char, x0)
    lap("f8")
    del char, ef0, targets, x0

    from momentum_tpu_torch.testing.workloads import build_fullstack_problem

    fs = build_fullstack_problem(BATCH, seed=SEED, device="cuda")
    chol_counts, chol_numbers = phase_chol(*fs)
    fs_counts = phase_full_stack(*fs, smi)
    lap("full_stack")
    del fs
    config2_counts, config2_numbers = phase_config2_lm(smi)
    lap("config2_lm")
    vertex_counts, vertex_numbers = phase_vertex_fit(smi)
    lap("vertex_fit")
    seq_counts, seq_numbers = phase_sequence(smi)
    lap("sequence")
    seq_numbers["acceleration"] = phase_sequence_accel()
    lap("sequence_accel")
    track_counts, track_numbers, track_fk, track_psd = phase_tracking(smi)
    lap("tracking")
    io_counts, io_numbers, io_fk, io_psd = phase_io(smi, track_numbers)
    lap("io")
    io2_counts, io2_numbers, io2_fk, io2_psd = phase_io2(smi)
    lap("io2")
    catalog_counts, catalog_numbers, catalog_psd = phase_catalog(smi)
    lap("catalog")
    kp_counts, kp_numbers, kp_psd = phase_keypoints(smi)
    lap("keypoints")
    diff_prob, dik_fwd, dik_bwd, dik_numbers, dik_psd = phase_diff_ik(smi)
    lap("diff_ik")
    var_counts, var_numbers = phase_solver_variants(diff_prob, smi)
    del diff_prob
    lap("solver_variants")
    vx_counts, vx_numbers = phase_vertex_extra(smi)
    lap("vertex_extra")
    sl_counts, sl_numbers, sl_psd = phase_skinned_locators(smi)
    lap("skinned_locators")
    glove_counts, glove_numbers, glove_fk, glove_psd = phase_glove(smi)
    lap("glove")
    vad_counts, vad_numbers, vad_psd = phase_vertex_ad(smi)
    lap("vertex_ad")
    sc_counts, sc_joint_counts, sc_numbers, sc_fk, sc_psd = phase_sdf_collision(smi)
    lap("sdf_collision")
    c5_counts, c5_numbers, c5_fk, c5_psd = phase_sdf_sequence(smi)
    lap("sdf_sequence")
    u_counts, u_numbers, u_fk, u_psd = phase_character_utilities(smi)
    lap("character_utilities")
    sh_counts, sh_numbers, sh_fk, sh_psd = phase_sharded(smi)
    lap("sharded")

    from momentum_tpu_torch.ops import psd
    from momentum_tpu_torch.testing.workloads import build_render_clip

    rchar, motion, cam = build_render_clip(32, seed=SEED, device="cuda")
    raster_numbers = phase_raster(rchar, cam, motion)
    clip_passes = phase_clip_passes(rchar, cam, motion)
    clip_counts, imgs, clip_device_ms = phase_render_clip(rchar, cam, motion, smi)
    small_counts = phase_small_mesh(rchar, cam, motion)
    phase_render_reference((rchar, motion, cam), imgs)
    phase_f9(rchar, cam, motion)
    lap("f9")
    del rchar, motion, cam
    scene_counts, scene_numbers, scene_held = phase_scene(smi)
    lap("scene")
    k4a = ("small mesh camera pass", "small mesh shadow pass", "camera pass, frame 0, cull=False")
    kernels = [
        dict(name="fk_global_kernel", route="cuda", source="momentum_tpu_torch/csrc/fk.cu",
             replaces="momentum_tpu/ops/fk_pallas.py:62",
             launches=counts["fk_global_kernel"], **fk_numbers,
             full_stack_launches=fs_counts["fk_global_kernel"],
             config2_lm_launches=config2_counts["fk_global_kernel"],
             vertex_fit_launches=vertex_counts["fk_global_kernel"],
             clip_launches=clip_counts["fk_global_kernel"],
             scene_launches={part: n["fk_global_kernel"] for part, n in scene_counts.items()},
             clip_device_ms=clip_device_ms["fk_global_kernel"],
             sequence_launches={c: n["fk_global_kernel"] for c, n in seq_counts.items()},
             by_batch={str(b): nums for b, nums in fk_by_batch.items()},
             sequence_B1024={c: seq_numbers[c].pop("fk") for c in seq_counts},
             tracking_launches={st: n["fk_global_kernel"] for st, n in track_counts.items()},
             **{f"tracking_B{b}": nums for b, nums in track_fk.items()},
             catalog_launches=catalog_counts["fk_global_kernel"],
             catalog_ad_rows=catalog_numbers.pop("ad_rows"),
             keypoint_launches={st: n["fk_global_kernel"] for st, n in kp_counts.items()},
             keypoint_ad_rows=kp_numbers.pop("ad_rows"),
             diff_ik_launches=dict(forward=dik_fwd["fk_global_kernel"],
                                   backward=dik_bwd["fk_global_kernel"]),
             variant_launches={v: n["fk_global_kernel"] for v, n in var_counts.items()},
             vertex_extra_launches=vx_counts["fk_global_kernel"],
             skinned_launches=sl_counts["fk_global_kernel"],
             skinned_ad_rows=sl_numbers.pop("ad_rows"),
             glove_launches={st: n["fk_global_kernel"] for st, n in glove_counts.items()},
             glove_B343=glove_fk, glove_ad_rows=glove_numbers.pop("ad_rows"),
             vertex_ad_launches=vad_counts["fk_global_kernel"],
             vertex_ad_rows=vad_numbers.pop("ad_rows"),
             sdf_collision_launches=sc_counts["fk_global_kernel"],
             sdf_joint_launches=sc_joint_counts["fk_global_kernel"],
             sdf_collision_B2048=sc_fk, sdf_joint_ad_rows=sc_numbers.pop("ad_rows"),
             sdf_sequence_launches=c5_counts["fk_global_kernel"], sdf_sequence_B1024=c5_fk,
             utility_launches={st: n["fk_global_kernel"] for st, n in u_counts.items()},
             utility_U4_B2048=u_fk,
             sharded_launches={r: {part: n["fk_global_kernel"] for part, n in c.items()}
                               for r, c in sh_counts.items()},
             sharded_B512=sh_fk,
             io_launches={part: n["fk_global_kernel"] for part, n in io_counts.items()},
             io_B1024=io_fk,
             io2_launches={part: n["fk_global_kernel"] for part, n in io2_counts.items()},
             io2_B1024=io2_fk),
        dict(name="damped_chol_solve_kernel + damped_chol_subst_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/psd.cu",
             replaces="momentum_tpu/ops/psd_pallas.py:53",
             also_replaces=["momentum_tpu/ops/psd_pallas.py:120"],
             kernels=list(psd.KERNELS),
             launches=counts["damped_chol_solve_kernel"], **psd_numbers,
             full_stack_launches=fs_counts["damped_chol_solve_kernel"],
             config2_lm_launches=config2_counts["damped_chol_solve_kernel"],
             vertex_fit_launches=vertex_counts["damped_chol_solve_kernel"],
             by_batch={str(b): {k: v for k, v in nums.items() if k != "max_abs_err"}
                       for b, nums in psd_by_batch.items()},
             factor_only=psd_factor_only,
             vertex_fit_256x165=vertex_numbers.pop("psd_256x165"),
             sequence_launches={c: n["damped_chol_solve_kernel"] for c, n in seq_counts.items()},
             **{"sequence_{}x{}_k{}".format(*nums["batch_n_k"]): nums
                for nums in (seq_numbers[c].pop("psd") for c in seq_counts)},
             tracking_launches={st: n["damped_chol_solve_kernel"]
                                for st, n in track_counts.items()},
             **{f"tracking_{shape}": nums for shape, nums in track_psd.items()},
             catalog_launches=catalog_counts["damped_chol_solve_kernel"],
             catalog_2048x157=catalog_psd,
             keypoint_launches={st: n["damped_chol_solve_kernel"] for st, n in kp_counts.items()},
             keypoints_343x73=kp_psd,
             diff_ik_launches=dict(forward=dik_fwd["damped_chol_solve_kernel"],
                                   backward=dik_bwd["damped_chol_solve_kernel"]),
             diff_ik_backward_2048x157=dik_psd,
             variant_launches={v: n["damped_chol_solve_kernel"] for v, n in var_counts.items()},
             vertex_extra_launches=vx_counts["damped_chol_solve_kernel"],
             skinned_launches=sl_counts["damped_chol_solve_kernel"],
             skinned_2048x157=sl_psd,
             glove_launches={st: n["damped_chol_solve_kernel"]
                             for st, n in glove_counts.items()},
             **{f"glove_{shape}": nums for shape, nums in glove_psd.items()},
             vertex_ad_launches=vad_counts["damped_chol_solve_kernel"],
             vertex_ad_256x165=vad_psd,
             sdf_collision_launches=sc_counts["damped_chol_solve_kernel"],
             sdf_joint_launches=sc_joint_counts["damped_chol_solve_kernel"],
             sdf_collision_2048x157=sc_psd,
             sdf_sequence_launches=c5_counts["damped_chol_solve_kernel"],
             **{"sdf_sequence_{}x{}_k{}".format(*c5_psd["batch_n_k"]): c5_psd},
             utility_launches={st: n["damped_chol_solve_kernel"] for st, n in u_counts.items()},
             **{"utility_{}x{}".format(*u_psd["batch_n_k"][:2]): u_psd},
             sharded_launches={r: {part: n["damped_chol_solve_kernel"] for part, n in c.items()}
                               for r, c in sh_counts.items()},
             **{"sharded_{}x{}_k{}".format(*sh_psd["batch_n_k"]): sh_psd},
             io_launches={part: n["damped_chol_solve_kernel"] for part, n in io_counts.items()},
             **{"io_{}x{}".format(*io_psd["batch_n_k"][:2]): io_psd},
             io2_launches={part: n["damped_chol_solve_kernel"]
                           for part, n in io2_counts.items()},
             **{"io2_{}x{}".format(*io2_psd["batch_n_k"][:2]): io2_psd}),
        dict(name="point_jacobian_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/jacobian.cu", replaces=None,
             path="the position rows' model-space Jacobian (PositionErrorFunction."
                  "jacobian_model): the IK cell's shape and the full-body rig's",
             launches=counts["point_jacobian_kernel"], by_shape=jac_numbers,
             path_launches={k: n for k, n in K6_LAUNCHES.items() if n}),
        dict(name="projection_jacobian_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/jacobian.cu", replaces=None,
             path="the camera projection rows' model-space Jacobian (CameraProjectionError"
                  "Function.group_jacobian_model): the multi-view cell's shape and config 6k's",
             launches=proj_launches, by_shape=proj_numbers),
        dict(name="damped_chol_solve_kernel (K5a entry point chol_solve)", route="cuda",
             source="momentum_tpu_torch/csrc/psd.cu",
             replaces="momentum_tpu/ops/chol_pallas.py:55",
             launches=chol_counts["K5a"],
             path="chol_solve on the full stack's normal equations (n = 160)",
             **chol_numbers["K5a"]),
        dict(name="raster_planes_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/raster.cu",
             replaces="momentum_tpu/ops/raster_pallas.py:196",
             launches=small_counts["raster_planes_kernel"],
             path="shadowed render of a mesh under the bin capacity",
             **raster_numbers[k4a[0]],
             passes={label: raster_numbers[label] for label in k4a[1:]}
             | {"config 7p sphere pass, frame 0": scene_held["config 7p sphere pass, frame 0"]},
             scene_launches={part: n["raster_planes_kernel"]
                             for part, n in scene_counts.items()}),
        dict(name="raster_planes_binned_kernel", route="cuda",
             source="momentum_tpu_torch/csrc/raster.cu",
             replaces="momentum_tpu/ops/raster_pallas.py:220",
             launches=clip_counts["raster_planes_binned_kernel"],
             path="shadowed render of the 32-frame clip",
             **raster_numbers["camera pass, frame 0"],
             passes={label: nums for label, nums in raster_numbers.items()
                     if label not in k4a}
             | {label: nums for label, nums in scene_held.items() if "sphere" not in label},
             scene_launches={part: n["raster_planes_binned_kernel"]
                             for part, n in scene_counts.items()},
             clip=dict(device_ms=clip_device_ms["raster_planes_binned_kernel"],
                       **clip_passes)),
        dict(name="damped_chol_solve_kernel (K5b entry point chol_solve_blocked)",
             route="cuda", source="momentum_tpu_torch/csrc/psd.cu",
             replaces="momentum_tpu/ops/chol_pallas.py:93",
             launches=chol_counts["K5b"],
             path="chol_solve_blocked on the full stack's normal equations (n = 160)",
             **chol_numbers["K5b"]),
    ]
    print(json.dumps({"config2": config2_numbers, "config4": vertex_numbers,
                      "config5": seq_numbers, "config6s": track_numbers,
                      "configC": catalog_numbers, "config6k": kp_numbers,
                      "configD": dik_numbers, "variants": var_numbers,
                      "config4x": vx_numbers, "configSL": sl_numbers, "configG": glove_numbers,
                      "config4ad": vad_numbers, "config7p": scene_numbers,
                      "configSC": sc_numbers, "config5c": c5_numbers,
                      "configU": u_numbers, "config5fs": sh_numbers, "configIO": io_numbers,
                      "configIO2": io2_numbers}))
    print(f"K6 launches by path (the rest launched none): "
          f"{ {k: n for k, n in K6_LAUNCHES.items() if n} }; none: "
          f"{sorted(k for k, n in K6_LAUNCHES.items() if not n)}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--io2-worker"]:
        _io2_worker(*sys.argv[2:5])
    else:
        main()
