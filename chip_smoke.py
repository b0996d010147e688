#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tpubody_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

  1. build   — compile the CUDA kernels from tpubody_torch/csrc with nvcc
               for sm_90a (first use builds; the time is printed);
  2. kernels — hold the fused LBS kernel to its plain PyTorch version on
               the card, TF32 off: full width (512 frames, the 6890-vertex
               humanoid), SMPL-X's served shape (512 bodies of 10,475
               vertices, 55 joints, betas and expression: K = 486 + 20 + 1
               = 507, with a translation) and ragged shapes (5 and 70
               frames, 700 vertices), shared and per-frame betas,
               axis-angle and rotation-matrix poses, both precisions (max |d| < 2e-5 for "highest",
               relative error < 1e-4 for "bf16x3", the bars of
               tests/test_pallas_lbs.py);
  3. serve   — the main path through its entry points at full width:
               hmr_smpl_step (ResNet-50, 224^2, bf16 backbone, 6890-vertex
               body) behind InferenceServer(buckets=(1, 4, 16, 64)), 24
               concurrent requests, each checked against the step applied
               directly to its image (in the batch the server formed, and
               alone); the launch counters are zeroed just before and read
               just after, and every kernel of the path must have
               launched; the fp32 step on the card is also held to the
               same step on the CPU;
  5. timing  — fused_lbs in both precisions against one PyTorch call
               computing the same contractions (timed in turns in one
               run), its plain version and its bound;
  6. raster  — hold the fused raster kernel to its plain PyTorch version
               on tables that _bin_fused builds: two frames of the video
               clip at full width (1024^2, the humanoid avatar; the base
               pass and each ladder rung; 3 and 6 channels), two random
               64x128 scenes, a 24-channel attribute stack, a scene
               whose chunk budget overflows, and a heavy tile (38 chunks:
               more than the blocks of a cluster) and a sliver scene of
               two frames each at clusters of 1 and 2 blocks a tile.
               Gate: win equal at every pixel, attributes within 1e-6 of
               the largest attribute (phase 9 holds the 8-frame launches
               of the video path to the same gate);
  7. video   — the animation path at full width through its entry point:
               a humanoid avatar (6890 vertices, 13,524 faces) saved with
               save_avatar, a seeded 64-frame AMASS-format clip, then
               animate_from_amass(..., stride=1, size=1024) with the
               defaults.  The launch counters are zeroed just before and
               fused_raster must have launched (blocks x passes) times.
               The frames handed to the writer are collected and checked
               (64 frames of 1024x1024, body inside the projected bbox,
               consecutive frames different).  Where cv2 is missing the
               encoder, and only the encoder, is replaced by a frame
               collector.  Run once more for 8 frames with
               i420_transfer=False, crop_transfer=False;
  8. oracle  — two frames through render_frames_tiled and through the
               fragment renderer render_frames at 256^2: more than 99.5%
               of values within 2e-2;
  9. video timing — frames/s of a warm second pass of the video path and
               CUDA-event times per layer; fused_raster per pass of an
               8-frame block, held to its plain version on the block's own
               tables (phase 6's gate) and timed against it and its bound
               (bytes: the valid chunks and the outputs; operations: the
               real faces, not sentinel slots, at every pixel of their
               tile), at the cluster size the wrapper chooses and at 1 and
               2, with the histogram of chunks a tile (max, p99, share of
               empty tiles); the base pass of 1-6 and 8 frames at clusters
               of 1 and 2, each held to the plain version and timed (where
               the wrapper's threshold comes from).

  10. zbuffer — hold the z-buffer kernel to its plain PyTorch version on
               tables that bin_faces builds: the body-map scene at full
               width (the fitted 6890-vertex SMPLH body at 1024^2, focal
               5000; front, back and all faces), two random 64x128 scenes
               of two frames, a scene under 64 faces (the wrapped key), one
               whose tiles overflow, and a heavy tile (10 chunks of 128) and
               a sliver scene at clusters of 1 and 2.  Gate: equal at
               every pixel.  On
               the body-map scene its face ids are also held to the fused
               raster kernel's (at least 99.9% of the pixels);
  11. reconstruct — the device half of the reconstruct pipeline at full
               width: the in-memory demo fixture (humanoid(52, 6890) and
               humanoid(24, 6890), the demo pose and betas, focal 5000 at
               1024^2; the photo mask rendered at other betas, so the warp
               moves pixels), through the helper of
               tpubody_torch.pipelines.reconstruct with the cache off, and
               the front normal map once more through rasterize_tiled.  The
               launch counters are zeroed just before and read just after:
               fused_raster 3 launches, zbuffer 1.  Gates: background 1.0
               and weights summing to 1 in the value map, the warped map
               filling the photo mask, PCG's relative residual under 1e-3,
               finite depths that are zero outside the mask, the
               rasterize_tiled map equal to the fused one's within 2e-3 on
               99.9% of the pixels.  The same path at 256^2 on the card
               and on the CPU, within the tests' tolerances;
  12. rtiming — CUDA-event spans of the stages and the warp's substages in
               a second run of the helper, the card's busy share of
               normal2depth and of the warp under torch.profiler, the
               z-buffer kernel alone against its plain version and its
               bound (at the chosen cluster size and at 1 and 2), and
               fused_raster at 24 channels, each with its histogram of
               chunks a tile.

  13. stage   — hold the fused residual-stage kernel to its plain PyTorch
               version on the card, TF32 off: the four small shapes of
               tests/test_pallas_resnet.py (3 blocks with a downsample at
               12x12, 2 identity blocks at 8x8, a single block at 10x10, 2
               blocks at 11x19, all with 4 features), a zero input, and
               a 20 -> 10 -> 20 chain (channels off a multiple of 8: x
               padded, y sliced), full width at batch 8 (stage 1: 56^2,
               64 -> 256 channels, 3 blocks; stage 2 tail: 28^2, 512
               channels, 3 blocks) and ResNet-50's stage 3 and 4 tails at
               batch 512 (14^2, 1024 -> 256 -> 1024, 5 blocks; 7^2,
               2048 -> 512 -> 2048, 2 blocks: C_mid above 128, the wide
               route, one launch a bottleneck at stage 3 and two at
               stage 4), with seeded weights and BatchNorm
               statistics.  The plain version takes its sums in float64,
               each rounded once to f32 (the library's fp32 convolutions
               miss that on a share of elements that depends on the
               algorithm it picks: printed for scale).  Gate, on every
               block alone and on the small chains: max |d| within 2 bf16
               ulps of the largest output (2^-7 of it) and at least 99% of
               the elements equal bit for bit: both round h1, h2 and y to
               bf16 at the same places and differ only in the order of
               their f32 sums.  A full-width chain: 4 ulps;
  14. backbone — the fused stage on the full-width serving model:
               create_hmr(dtype=bf16) (ResNet-50 at (3, 4, 6, 3)) with
               seeded BatchNorm statistics, 512 images of 224^2 through the
               model's own stem, then fuse_stage(layer1, [0, 1, 2]) ->
               run_stage against layer1 by the library's bf16
               convolutions, layer2[0] by the library, and
               fuse_stage(layer2, [1, 2, 3]) -> run_stage against
               layer2[1:], and likewise layer3[1:] (after layer3[0]) and
               layer4[1:] (after layer4[0]): max |d| / max |ref| < 2e-2
               (the bar of tests/test_pallas_resnet.py).  The launch
               counters are zeroed just before and fused_stage must have
               launched 15 times (3 + 3 + 5, and 2 a bottleneck of stage
               4).  The same four outputs are then held to the plain
               version on the same inputs and weights, all 512 images in
               chunks of 8 (the gates of phase 13, block by block on the
               first chunk), which also times the plain version at that
               batch.  Stages 3 and 4 are timed on the model's activations
               in turns with the library's chain (kernel, library,
               library, kernel).  Then tpubody_torch.bench.fused_stage(1)
               and (2)
               (kernel and library ms at batch 512, in one run), the bound,
               and the s2d stem against conv7 (fp32 within 1e-4, and
               both stems' ms in bf16).

  15. fit     — the fitting path (no kernel of the port lies on it: its
               forward is the differentiable torch-op LBS on a reduced
               model, as tpubody's is) at full width: the seeded SMPLH
               stand-in (52 joints, 6890 vertices) with seeded PCA hand
               bases, a seeded VPoser decoder, 64 frames of seeded poses
               projected (focal 5000, 1024^2 center) with 2 px noise,
               through BatchFitter at FitConfig() defaults (VPoser, 12
               PCA hand components, 30 iterations, 5 stages, both
               orientation candidates: 128 lanes).  The launch counters
               are zeroed just before and read just after: every kernel
               0 times.  Gates: every loss finite; the mean reprojection
               error after the fit below 0.35x the zero pose's at the
               true camera (tests/test_fit.py's bar); card vs CPU on 4
               frames at maxiters=3, TF32 off: losses within rtol 1e-3,
               pose, betas and camera within 1e-3.  Then fit_sequence on a
               16-frame clip at blocks 1 and 8 (finite, 16 frames), and
               gen_smplh once into a temporary directory (conf.yaml,
               smplh.pkl readable by reconstruct.load_fit_pickle,
               pre_smplh.pkl, smplh.obj, the overlay PNG);
  16. fitserve — 8 requests through InferenceServer(buckets=(4,)) ->
               fit_smplh_step, each held to BatchFitter.apply on its batch
               of 4 (within 1e-5), latency p50/p99;
  17. ftiming — tpubody_torch.bench.fit at N=8 and N=64 (ms/frame of the
               first and of a warm call, the camera stage vs the body
               stages by CUDA events, objective evaluations an iteration,
               line-search steps, device-to-host reads), fit_sequence's
               ms/frame at blocks 1 and 8 (from phase 15), and the card's
               busy share of a warm N=64 fit at 1 iteration a stage: its
               device time under torch.profiler over its wall time
               without the profiler.

  18. rwhole  — the whole public reconstruct() at full width with the hand
               graft: demo.make_fixture's humanoid (6890 vertices) at
               1024^2 written as the reference's fixture directory, read
               by load_test_dir, then reconstruct(..., replace_hands=True)
               with the cache off (twice; the second with
               TPUBODY_DETAIL=1, whose stitch/* substages it prints; the
               two must give equal stitched points and avatars) and on.
               The launch counters are zeroed just before each run and
               read just after: fused_raster 3, the others 0 (the
               kernel line's launches_reconstruct).  Gates: the hands were
               grafted, finite avatar, weights summing to 1, and
               points.npy, faces.npy, J_3d.npy, the avatar pickle, out.ply
               and out.glb (with the cache on, the device stages' files
               too) load back to the result.  Stage times, shares of the
               warm run, stitched vertex and face counts.  Then at 256^2:
               the host half (stitch, rig, graft) on the same pulled
               device outputs with the card and with the CPU (mesh and
               joints equal, avatar within 1e-4), and the whole chain on
               the card against the CPU (the bars of phase 11 on the
               stitched positions and joints, the avatar's joints within
               1% of its extent);
  19. demo    — demo.run_demo at 256^2 with an 8-frame animation: every
               artefact exists (an MP4 and a GLB among them), the hands
               were grafted, fused_raster launched 3 times for the body
               maps and at least once for the one block of video (a base
               pass and the ladder rungs the avatar needs; launches_demo),
               no other kernel.

  20. train   — the training path (no kernel of the port lies on it: the
               loss uses the torch-op LBS, the backbone the library's
               convolutions, as in tpubody): train-hmr through the CLI's
               own function at its defaults (fp32 HMR, full ResNet-50 and
               3-step IEF, 224^2, batch 32, Adam 1e-4) on --render 64
               (rendered at 240^2 and cropped), 20 steps: every loss
               finite, the 3D eval finite, the checkpoint holds step 20.
               Then at full width: 30 steps on one fixed batch reduce the
               loss; the checkpoint round-trips bit for bit and 2 steps
               resumed from it equal 2 steps without the save (cuDNN
               deterministic); one step at batch 4, 64^2 on the card
               against the CPU in float64 (loss 1e-9, gradients 1e-6 of
               each tensor's largest, BatchNorm statistics 1e-9; fp32
               printed).  Launch counters zeroed before and read after: 0
               of each kernel;
  21. remat   — the same step with remat against without, same batch and
               weights (cuDNN deterministic): loss and gradients within
               1e-4, the BatchNorm statistics equal and counted once;
               torch.cuda.max_memory_allocated of both (remat lower);
               ms/step by CUDA events (10 steps after 3) and images/s;
  22. pose2d  — train-pose2d at its defaults (128^2, features 32, batch 16,
               the 1200-vertex humanoid's 24 joints) with --domain-rand
               for 100 steps (--chunk 20): pixel error after < before,
               ms/step; the synthesizer and the train step alone by CUDA
               events; detect-pose --ckpt on one rendered 256^2 image
               writes OpenPose JSON that fit.keypoints reads back with 67
               slots; the synthesizer given the same draws on the card and
               on the CPU at 128^2 (keypoints within 1e-4 px, at most 1%
               of the pixels beyond 1e-4); 0 launches of each kernel;
  23. asf     — animate with a CMU .amc clip and --asf through the CLI at
               256^2, 8 frames (tpubody's sample skeleton, retargeted to
               the 24-joint humanoid avatar): the MP4 has 8 frames and
               fused_raster launched once a pass of each block.

  24. quant   — int8 HMR serving at full width: hmr_smpl_step(quantize=
               True) (ResNet-50, 224^2, the 6890-vertex body; PTQ on the 4
               default calibration images) behind InferenceServer(buckets=
               (1, 4, 16, 64)), 24 requests, each held to the step applied
               directly to its batch (1e-5); counters zeroed before the
               server and read after: fused_lbs and int8_requant must
               have launched.  The
               int8 forward on the card against the CPU route (float64
               products) at batch 4 on the same parameters: at least 99.9%
               of the int8 codes equal at every conv input, outputs within
               1e-4.  The int8 outputs against forward_folded on the
               calibration images: err/scale of pose6d < 0.15 (tpubody's
               bar), rotations orthonormal within 1e-4.  torch._int_mm's
               CUDA rules (M > 16; K, N multiples of 8; the operand
               layouts) checked, and both layouts of the second operand
               timed.  Frames/s of the int8 and the bf16 step at batch 512
               in turns (int8, bf16, bf16, int8; bench's timing helper),
               the int8 step's split by its program spans (quantize +
               im2col, products, epilogue, head, LBS) and each step's peak
               memory; the int8 step on the same 512 frames from host
               memory (the main path: copied in chunks of
               serving.chunk_frames, 256 at 224^2, under the backbone), the
               counters zeroed just before, must go in ceil(512 / 256)
               chunks and launch int8_requant 53 times a chunk and
               fused_lbs once (launches_step, chunks in the result); int8_requant at each launch of one backbone at
               batch 512 (seeded sums, bit-equal to its plain version),
               timed by CUDA events and summed, beside the plain version
               and its byte bound (the kernel line's fifth entry);
  25. mesh    — a single-process mesh of the card listed twice: LBS at
               F=512 over the 2 shards against unsharded (fused_lbs's
               bf16x3 gate, 2 launches); the fp32 serving step behind
               InferenceServer(sharding=) against the step on the whole
               batch (1e-4); fit_frames(mesh=) on 8 frames at 2 iterations
               a stage against unsharded (phase 15's whole-fit bars);
               animate_video(mesh=) on 16 frames at 256^2: fused_raster
               launched, frames equal to the unsharded ones (and two
               unsharded runs equal);
  26. multihost — two processes of this script (--multihost-worker) on the
               card, joined by torch.distributed with gloo at a free
               localhost port (NCCL admits one rank a GPU), each with a
               timeout: a frames array gathered in process order and a
               mean by all_reduce, each checked; animate_video(multihost=
               True) on the 16-frame clip at 256^2: each rank launches
               fused_raster, rank 0's MP4 has 16 frames and they equal
               the single-process frames;
  27. closure — vertex_normals on a video block (8 frames of the 6890-
               vertex avatar) and on 8 frames of the stitched avatar of a
               whole reconstruction at 1024^2 (phase 18's where it ran):
               two runs bit-equal, the block equal to its frames one at a
               time, the card within 1e-6 of the CPU; the largest vertex
               degree; the old index_add_ form's run-to-run spread, and
               both forms timed in turns by CUDA events on the same
               inputs.  One 8-frame block at 1024^2 rendered twice through
               the block renderer of animate_video (fused_raster; the
               counters zeroed before and read after): equal frames.  Card
               against CPU: resize_image for every method at a shrinking
               and a growing 224^2 crop (nearest equal, else within 1e-5
               of the range), scale_and_crop(host=False), unpose at 512
               frames x 6890 vertices (1e-4, and its round trip),
               save_npz and write_obj from tensors on the card.
  28. layernorm — add_layernorm (csrc/add_layernorm.cu): one HMR 2.0
               step (hmr_smpl_step(arch="hmr2_vith"), the cell's path) at
               512 frames of 256^2 from host memory (copied in chunks of
               serving.chunk_frames, 256 at 256^2, under the encoder), the
               counters zeroed just before it, must go in ceil(512 / 256)
               chunks and launch it 64 times a chunk
               (the kernel line's launches, and launches_hmr2 for the
               others).  Then at the encoder's
               shape, 98,304 tokens of 1280 (512 frames of 192), a bf16
               branch, in the step's two forms, each held to its plain
               version: bf16 output with x + branch kept (x + branch
               bit-equal, the output within a bf16 ulp of the largest
               magnitude and unequal on under 0.1% of elements) and the
               last block's float32 output without x + branch (within
               2e-6 of the largest magnitude).  Both timed by CUDA
               events, beside the byte bound (1.51 GB at 3.35 TB/s) and
               the eager add + F.layer_norm + cast on the same inputs,
               its plain version, as library_ms (the kernel line's sixth
               entry).  Then Multi-HMR's form at its encoder's shape,
               262,208 tokens of 1024 (64 frames of 4,097), with
               LayerScale's float32 per-channel scale on the branch, in the
               same two forms at the same bars, timed beside its bound.
  29. multihmr — one Multi-HMR step (hmr_smpl_step(arch=
               "multihmr_896_l"), the cell's path) at 64 frames of 896^2
               from host memory, in 4 chunks of serving.chunk_frames (16
               at 896^2) under the encoder, the counters zeroed just
               before it: (64, 8, 10475, 3) finite vertices and (64, 8,
               3) translations, 48 add_layernorm launches a chunk and one
               fused_lbs (launches_multihmr for every kernel).
  30. sapiens — Sapiens-2B pose's attention half at a 16-frame chunk of
               3,072 tokens in 32 heads of 60, the published heads run as
               they are and zero-padded to 64 (the model's route), held to
               each other and timed in turns; then one keypoint_step at 32
               frames of 1024^2 from host memory, in 2 chunks of 16 under
               the encoder, the counters zeroed just before it: (32, 308,
               2) finite keypoints, (32, 308) confidences in [0, 1], 96
               add_layernorm launches a chunk (launches_sapiens for every
               kernel).  Then add_layernorm at the encoder's shape, 49,152
               tokens of 1920 (a chunk of 16 frames of 3,072), where a
               lane's last chunk of 8 lies past the row's end, in the
               step's two forms at phase 28's bars, timed beside its byte
               bound (the add_layernorm entry's "sapiens" when phase 28
               ran).  The step must launch soft_argmax twice (its one
               decode).  Then soft_argmax (csrc/soft_argmax.cu) at the
               decode's shape, 32 frames of 256 x 192 heatmaps of 308
               keypoints, held to pose2d.soft_argmax in float64 (x, y
               within 1e-3 px, confidences within 1e-5), the same bits on
               a second call, timed beside its byte bound (1.94 GB at 3.35
               TB/s) and the plain version (the kernel line's seventh
               entry).

It then prints the whole script's time, the kernel line (each kernel with the card's name and power
limit), the card's name and power limit, and, last,
{"ok": true, "device": {...}}.  It needs one CUDA GPU and no network.
``--phases a,b`` runs a subset (names: lbs, serve, bench, raster, video,
oracle, vtiming, zbuffer, reconstruct, rtiming, stage, backbone, fit,
fitserve, ftiming, rwhole, demo, train, remat, pose2d, asf, quant, mesh,
multihost, closure, layernorm, multihmr, sapiens, and the extra
vprofile: a torch.profiler pass over the video path) and prints no result
line: a development aid.
"""
from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM data-sheet peaks (the table of the repository's measurement
# notes): HBM bytes/s, fp32 FLOP/s outside the tensor cores, dense bf16
# tensor-core FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12

SAME_BATCH_ATOL = 1e-5    # served vs the same batch applied directly
BATCH1_VERT_ATOL = 0.1    # m; bf16 at batch 1 vs in a bucket (see below)
CPU_HMR_ATOL = 1e-4       # fp32 HMR outputs, card vs CPU
CPU_VERT_ATOL = 1e-4      # LBS, card vs CPU: the repo's vertex budget
RASTER_ATTR_REL = 1e-6    # fused_raster attrs vs plain, of the largest attr
ORACLE_ATOL = 2e-2        # tiled vs fragment renderer, per value
ORACLE_AGREE = 0.995      # share of values that must agree
# The raster kernels, operations per face and pixel of the function they
# compute (every real face of a tile at every pixel of it, as the plain
# version does): three edge functions of one multiply and two adds each
# (9), the three a*px products shared by a thread's four pixels (0.75),
# three comparisons (3); depth and key only where a pixel is covered (not
# counted).  Sentinel slots are not counted.  The kernels evaluate fewer
# pairs (the warp rejection) and issue these as unfused instructions, half
# the rate that the fp32 peak (which counts an FMA as two) assumes.
RASTER_OPS_PER_FACE_PIXEL = 12.75
VIDEO_FRAMES = 64
VIDEO_SIZE = 1024
T_1024 = (VIDEO_SIZE // 8) * (VIDEO_SIZE // 128)   # raster tiles a frame
CLUSTER_FRAMES = (1, 2, 3, 4, 5, 6, 8)   # phase 9: launches at both clusters
RECON_SIZE = 1024
RECON_SMALL = 256         # the card-vs-CPU run of the reconstruct path
FACE_ID_AGREE = 0.999     # zbuffer vs fused_raster face ids, share of pixels
TILED_MAP_ATOL = 2e-3     # rasterize_tiled (exact barycentrics) vs fused
TILED_MAP_AGREE = 0.999
PCG_RELRES = 1e-3
# The 24 rendered weights sum to 1 inside the body: within 1e-4 at 1024^2.
# At 256^2 every face of the 6890-vertex body is smaller than a pixel, the
# affine planes' slopes (~ 1 / area) are large, and their float32 rounding
# reaches the sum: 1e-3 there.
WSUM_ATOL = 1e-4
WSUM_ATOL_SMALL = 1e-3
DEPTH_REL = 1e-3          # card vs CPU depth, of the depth range
WEIGHT_ATOL = 1e-3        # card vs CPU stitch weights (they cross as f16)
CHAIN_MEAN_REL = 1e-2     # free-running chain: mean depth difference
TIGHT_SHARE = 0.999       # share of pixels held to the tight bars
WHOLE_VERTS = 6890        # the demo fixture's humanoid in phases 18-19
DEMO_SIZE = 256
DEMO_FRAMES = 8
# The host half card vs CPU on the same pulled device outputs: the stitch
# is numpy on the host (the card only closes the mask, max pools: exact),
# so mesh and joints are equal; the rig's SMPL forwards run in float32 on
# each device, and their last bits reach the avatar through the float64
# repose and inverse LBS: BASELINE.json's vertex bar.
HOST_AVATAR_ATOL = 1e-4
# The whole chain card vs CPU: the depth maps differ as in phase 11 (tight
# bars on 99.9% of the pixels, 1% of the range on average), so the
# stitched positions are held the same way, the recovered joints within 1%
# of the depth range, and the avatar's joints within 1% of its extent.
SHAPE_SHARE = 1e-3        # stitched vertex counts, card vs CPU, if unequal
BACKBONE_BATCH = 512
TAIL_BATCH = 512          # phase 13's stage 3 and 4 tails
# fused_stage vs its plain version.  Both round h1, h2 and y to bf16 at the
# same places and differ in the order of their f32 sums, so an element can
# land on the other side of a rounding boundary.  One block on the same
# input bits: within 2 bf16 ulps of the largest output, 99% of the elements
# equal bit for bit (measured: 1 ulp; 99.58% to 99.98% at full width, 100%
# at 4 features).  That is the gate that binds, and it is applied to every
# block of every case, at full width too.  A chain compounds the
# difference: a 1-ulp change of one input moves C_mid sums of h1, each of
# which feeds 9 * C_mid sums of h2, so after three blocks at full width
# 97.3% (stage 1) and 85.1% (stage 2's tail) of the elements were equal, 2
# ulps apart at most, where two evaluations of the plain version itself
# (the card's convolutions and the CPU's) agreed on 99.4% and 98.3%.  The
# share of equal elements of a full-width chain depends on the weights and
# says nothing a block's does not, so it is printed and not gated: a
# full-width chain is held to 4 ulps, the small chains (as every single
# block) to 2 ulps and 99%.
STAGE_EQUAL = 0.99        # share of elements equal bit for bit
STAGE_CHAIN_ULPS = 4      # full-width chain of three blocks
STAGE_CHUNK = 8           # images a call of the plain version at batch 512
STAGE_LIB_REL = 2e-2      # fused_stage vs the library's bf16 chain
STEM_ATOL = 1e-4          # s2d vs conv7 stem, fp32 HMR outputs
FIT_N = 64                # frames of the fit phase (128 lanes)
FIT_REPROJ = 0.35         # fitted / zero-pose reprojection error
FIT_CPU_N = 4             # frames of the card-vs-CPU fit
FIT_CPU_ITERS = 2          # held to the whole-fit bar up to this budget
FIT_OBJ_RTOL = 1e-5        # objective value, card vs CPU
FIT_GRAD_REL = 1e-4        # objective gradient, of the largest |g|
FIT_RTOL = 1e-3           # whole-fit bar: loss rtol; pose/betas/cam_t atol
FIT_ATOL = 1e-3
FIT_CLIP = 16             # frames of the fit_sequence clip
FIT_SERVE_ATOL = 1e-5     # served vs BatchFitter.apply on the same batch
FIT_PROFILE_ITERS = 1     # iterations a stage of the profiled fit
# The shape of the in-memory fixture's "photo" (the fit's shape is
# tpubody_torch.pipelines.demo.DEMO_BETAS).
PHOTO_BETAS = np.array([0.6, 1.5, 0, 0, 0, 0, 0, 0, 0, 0], np.float64)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
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
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lbs_inputs(body, F, rng, rotmat, per_frame_beta, with_trans):
    import torch

    from tpubody_torch.core import fused_lbs, rotations

    dev = body.device
    aa = torch.as_tensor(rng.normal(scale=0.3, size=(F, body.num_joints, 3)),
                         dtype=torch.float32, device=dev)
    poses = rotations.rodrigues(aa) if rotmat else aa
    n_shape = body.num_betas + body.num_expressions
    shape = (F, n_shape) if per_frame_beta else (n_shape,)
    beta = torch.as_tensor(rng.normal(scale=0.5, size=shape),
                           dtype=torch.float32, device=dev)
    trans = (torch.as_tensor(rng.normal(size=(F, 3)), dtype=torch.float32,
                             device=dev) if with_trans else None)
    layouts = fused_lbs.model_layouts(body, n_shape)
    feat, g = fused_lbs.lbs_prologue(layouts, body.parents, poses, beta,
                                     pose_is_rotmat=rotmat)
    return layouts, feat, g, trans, (poses, beta)


def phase_kernels(dev):
    import torch

    from tpubody_torch.core import fused_lbs
    from tpubody_torch.models import humanoid, params, smpl

    rng = np.random.default_rng(0)
    full = humanoid.humanoid(n_joints=24, n_verts=6890, device=dev)
    ragged = params.synthetic(n_joints=24, n_verts=700, seed=2, device=dev)
    # SMPL-X as Multi-HMR serves it: betas and expression, a translation
    smplx = params.synthetic(n_joints=55, n_verts=10475, seed=4, device=dev)
    cases = [
        ("full aa shared-beta trans", full, 512, False, False, True),
        ("full rotmat per-frame-beta", full, 512, True, True, False),
        ("smplx rotmat per-frame-beta+expr trans", smplx, 512, True, True,
         True),
        ("ragged aa shared-beta trans", ragged, 5, False, False, True),
        ("ragged rotmat per-frame-beta trans", ragged, 5, True, True, True),
        # past one 64-frame tile, with a ragged second one
        ("ragged 70 frames aa shared-beta trans", ragged, 70, False, False,
         True),
    ]
    main_err = None
    for name, body, F, rotmat, pfb, tr in cases:
        layouts, feat, g, trans, (poses, beta) = lbs_inputs(
            body, F, rng, rotmat, pfb, tr)
        for prec in fused_lbs.PRECISIONS:
            got = fused_lbs.fused_lbs(layouts, feat, g, trans, prec)
            torch.cuda.synchronize()
            ref = fused_lbs.fused_lbs_reference(layouts.basis, layouts.wT,
                                                feat, g, trans, prec)
            if got.shape != (F, body.num_verts, 3):
                raise RuntimeError(f"{name}: shape {tuple(got.shape)}")
            if layouts.basis.shape[1] != feat.shape[1]:
                raise RuntimeError(f"{name}: K {feat.shape[1]} against the "
                                   f"layout's {layouts.basis.shape[1]}")
            err = (got - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            ok = err < 2e-5 if prec == "highest" else rel < 1e-4
            log(f"  {name:40s} {prec:8s} K={feat.shape[1]} "
                f"max|d|={err:.3e} rel={rel:.3e}"
                f" {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"fused_lbs disagrees with its plain "
                                   f"version: {name} {prec}")
            if prec == "highest":
                lbs = smpl.forward_batch(body, poses, beta, trans,
                                         pose_is_rotmat=rotmat).verts
                err_lbs = (got - lbs).abs().max().item()
                if err_lbs >= 2e-5:
                    raise RuntimeError(f"fused_lbs vs torch-op LBS {name}: "
                                       f"{err_lbs}")
            if name.startswith("full rotmat") and prec == "bf16x3":
                main_err = err
    return full, main_err


def phase_serve(dev):
    import torch

    from tpubody_torch import native
    from tpubody_torch.models import smpl
    from tpubody_torch.pipelines import serving

    rng = np.random.default_rng(1)
    images = rng.normal(size=(24, 224, 224, 3)).astype(np.float32)
    step = serving.hmr_smpl_step(device=dev)
    batches = []          # (batch images, outputs) of every dispatched batch

    def recording_step(batch):
        out = step(batch)
        batches.append((batch.clone(), out))
        return out

    native.reset_launches()
    server = serving.InferenceServer(recording_step, step.image_shape,
                                     buckets=(1, 4, 16, 64), device=dev)
    batches.clear()       # drop the warm-up batches
    futures = [None] * len(images)

    def send(i):
        futures[i] = server.submit(images[i])

    t0 = time.perf_counter()
    with server:
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        results = [f.result(timeout=300) for f in futures]
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    snap = server.stats.snapshot()
    log(f"  served {snap['requests']} requests in {snap['batches']} batches"
        f" of sizes {[len(b) for b, _ in batches]} ({wall:.3f} s):"
        f" p50 {snap['latency_p50_ms']:.3f} ms,"
        f" p99 {snap['latency_p99_ms']:.3f} ms; launches {launches}")
    if launches["fused_lbs"] == 0:
        raise RuntimeError("fused_lbs was not launched on the serving path")

    # Each future against the step applied directly to its image, in the
    # bucket batch the server formed for it: same inputs and shapes, so
    # the same result up to SAME_BATCH_ATOL.  The step at batch 1 is also
    # compared, at the looser BATCH1_VERT_ATOL: cuDNN may choose other
    # bf16 algorithms per batch size, and at the stand-in mean parameters
    # (tpubody's default_mean_params) the second 6D column is near zero,
    # so bf16 noise turns the Gram-Schmidt frame measurably.
    direct = [step(b) for b, _ in batches]
    worst = worst_1 = 0.0
    for img, (verts, cam) in zip(images, results):
        if verts.shape != (6890, 3) or cam.shape != (3,):
            raise RuntimeError(f"bad shapes {verts.shape} {cam.shape}")
        if not (np.isfinite(verts).all() and np.isfinite(cam).all()):
            raise RuntimeError("non-finite served output")
        x = torch.as_tensor(img, device=dev)
        hits = [(k, r) for k, (b, _) in enumerate(batches)
                for r in range(len(b)) if torch.equal(b[r], x)]
        if not hits:
            raise RuntimeError("a request's image is in no dispatched batch")
        k, r = hits[0]
        v_d, c_d = direct[k][0][r].cpu().numpy(), direct[k][1][r].cpu().numpy()
        worst = max(worst, float(np.abs(verts - v_d).max()),
                    float(np.abs(cam - c_d).max()))
        v_1, _ = step(img[None])
        worst_1 = max(worst_1, float(np.abs(verts - v_1[0].cpu().numpy()).max()))
    log(f"  served vs direct (same batch): max|d|={worst:.3e};"
        f" vs direct at batch 1: verts max|d|={worst_1:.3e} m")
    if worst > SAME_BATCH_ATOL or worst_1 > BATCH1_VERT_ATOL:
        raise RuntimeError("served results differ from the direct step")

    # Reference on a small input: the fp32 step on the card against the
    # same step on the CPU, in its two well-conditioned parts: the HMR
    # outputs (cuDNN, TF32 off, vs CPU convolutions), and the LBS on the
    # same rotations and shapes (the fused kernel vs the CPU torch-op LBS).
    step32 = serving.hmr_smpl_step(dtype=torch.float32, device=dev)
    step_cpu = serving.hmr_smpl_step(dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        out_gpu = step32.hmr(torch.as_tensor(images[:2], device=dev))
        out_cpu = step_cpu.hmr(torch.as_tensor(images[:2]))
        err_hmr = max((a.cpu() - b).abs().max().item() for a, b in
                      zip(out_gpu, out_cpu))
        v_gpu = smpl.forward_batch_verts(
            step32.body, out_cpu.rotmats.to(dev), out_cpu.shape.to(dev),
            pose_is_rotmat=True)
        v_cpu = smpl.forward_batch_verts(
            step_cpu.body, out_cpu.rotmats, out_cpu.shape,
            pose_is_rotmat=True)
    err_lbs = (v_gpu.cpu() - v_cpu).abs().max().item()
    log(f"  fp32 card vs CPU: HMR outputs max|d|={err_hmr:.3e},"
        f" verts on the same inputs max|d|={err_lbs:.3e}")
    if err_hmr > CPU_HMR_ATOL or err_lbs > CPU_VERT_ATOL:
        raise RuntimeError("the card disagrees with the CPU reference")
    return launches, snap


def phase_timing(body, launches, main_err):
    import torch

    from tpubody_torch.core import fused_lbs

    rng = np.random.default_rng(3)
    layouts, feat, g, _, _ = lbs_inputs(body, 512, rng, True, True, False)
    F, K = feat.shape
    J, V = layouts.wT.shape
    g2 = g.permute(0, 2, 1).reshape(F * 12, J).contiguous()

    def library():
        return (torch.matmul(feat, layouts.basis),
                torch.matmul(g2, layouts.wT))

    # library, kernel in both precisions, then both again in reverse order
    lib_ms, per = [], {p: dict(ms=[]) for p in fused_lbs.PRECISIONS}
    for order in (fused_lbs.PRECISIONS, fused_lbs.PRECISIONS[::-1]):
        lib_ms.append(time_ms(library))
        for prec in order:
            per[prec]["ms"].append(time_ms(
                lambda: fused_lbs.fused_lbs(layouts, feat, g, None, prec)))
    library_ms = min(lib_ms)
    for prec in fused_lbs.PRECISIONS:
        per[prec]["ms"] = min(per[prec]["ms"])
        per[prec]["plain_ms"] = time_ms(lambda: fused_lbs.fused_lbs_reference(
            layouts.basis, layouts.wT, feat, g, None, prec))
    # The least time for this work: each input read once and the output
    # written once, against the operations (contractions: 2*3*K and 2*12*J
    # per frame-vertex, as 3 bf16 products in bf16x3 and 6 in "highest";
    # apply + trans: 24 fp32) at the peak rate of their type.
    nbytes = 4 * (layouts.basis.numel() + layouts.wT.numel() + feat.numel()
                  + g.numel() + F * V * 3)
    contract = 2.0 * F * V * (3 * K + 12 * J)
    apply_ms = 24.0 * F * V / PEAK_FP32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    bounds = {"bf16x3": 3 * contract / PEAK_BF16 * 1e3 + apply_ms,
              "highest": 6 * contract / PEAK_BF16 * 1e3 + apply_ms}
    for prec in fused_lbs.PRECISIONS:
        log(f"  fused_lbs {prec:8s} {per[prec]['ms']:.4f} ms, library "
            f"{library_ms:.4f} ms, ratio {per[prec]['ms'] / library_ms:.3f};"
            f" bound {max(bytes_ms, bounds[prec]):.4f} ms; plain "
            f"{per[prec]['plain_ms']:.4f} ms")
    main = "bf16x3"
    bound_ms = max(bytes_ms, bounds[main])
    entry = {
        "name": "fused_lbs",
        "route": "cuda",
        "source": "tpubody_torch/csrc/fused_lbs.cu",
        "replaces": "tpubody/core/pallas_lbs.py:63",
        "replaces_fn": "tpubody/core/pallas_lbs.py::_fused_kernel",
        "precision": main,
        "shape": {"F": F, "V": V, "J": J, "K": K},
        "launches": launches["fused_lbs"],
        "max_abs_err": main_err,
        "max_err": main_err,
        "ms": per[main]["ms"],
        "kernel_ms": per[main]["ms"],
        "plain_ms": per[main]["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= bounds[main] else "operations",
        "library_ms": library_ms,
        "library_ratio": per[main]["ms"] / library_ms,
        "highest": {
            "ms": per["highest"]["ms"],
            "plain_ms": per["highest"]["plain_ms"],
            "bound_ms": max(bytes_ms, bounds["highest"]),
            "bound_by": ("bytes" if bytes_ms >= bounds["highest"]
                         else "operations"),
        },
    }
    return entry


# -- the animation/video path ------------------------------------------------
def random_scene(H, W, n_faces, max_extent, seed, n_chan):
    """Random triangles with bounded projected extent, some offscreen (the
    scene generator of tests/test_pallas_raster.py)."""
    rng = np.random.default_rng(seed)
    V = n_faces
    verts = np.stack([rng.uniform(-20, W + 20, V), rng.uniform(-20, H + 20, V),
                      rng.uniform(1.0, 5.0, V)], 1).astype(np.float32)
    faces = rng.integers(0, V, (n_faces, 3)).astype(np.int32)
    tri = verts[faces]
    cent = tri.mean(1, keepdims=True)
    scale = np.minimum(
        1.0, max_extent / (np.abs(tri[..., :2] - cent[..., :2])
                           .max((1, 2), keepdims=True) * 2 + 1e-6))
    tri = cent + (tri - cent) * scale
    verts2 = tri.reshape(-1, 3).astype(np.float32)
    faces2 = np.arange(n_faces * 3).reshape(n_faces, 3).astype(np.int32)
    attrs = rng.uniform(size=(verts2.shape[0], n_chan)).astype(np.float32)
    return verts2, faces2, attrs


def piled_scene(n_faces):
    """n_faces faces piled on one tile: 13 chunks of 32 at 400; at 1200, 38
    of 32 and 10 of 128, more chunks than the blocks of a cluster."""
    rng = np.random.default_rng(3)
    V = 3 * n_faces
    v = np.stack([rng.uniform(4, 100, V), rng.uniform(1, 6, V),
                  rng.uniform(1, 2, V)], 1).astype(np.float32)
    f = np.arange(V).reshape(n_faces, 3).astype(np.int32)
    a = rng.uniform(size=(V, 3)).astype(np.float32)
    return v, f, a


def sliver_scene(H, W, n_faces=80, seed=11):
    """Long thin triangles, 5-40 pixels long and 1e-3 to 0.5 pixels wide."""
    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(0, W, n_faces), rng.uniform(0, H, n_faces)], 1)
    ang = rng.uniform(0, 2 * np.pi, n_faces)
    d = np.stack([np.cos(ang), np.sin(ang)], 1)
    nrm = np.stack([-d[:, 1], d[:, 0]], 1)
    length = rng.uniform(5, 40, n_faces)[:, None]
    width = 10 ** rng.uniform(-3, np.log10(0.5), n_faces)[:, None]
    p1 = p0 + length * d
    p2 = p0 + rng.uniform(0, 1, (n_faces, 1)) * length * d + width * nrm
    xy = np.stack([p0, p1, p2], 1).reshape(-1, 2)
    v = np.concatenate([xy, rng.uniform(1, 5, (xy.shape[0], 1))], 1)
    f = np.arange(3 * n_faces).reshape(n_faces, 3).astype(np.int32)
    a = rng.uniform(size=(3 * n_faces, 3)).astype(np.float32)
    return v.astype(np.float32), f, a


def two_frames(v, dev):
    """A scene and its copy shifted by (3, 1) pixels, as a batch of 2."""
    import torch

    return torch.as_tensor(np.stack([v, v + np.float32([3.0, 1.0, 0.0])]),
                           device=dev)


def chunk_histogram(per_tile):
    """Chunks a tile: the largest, the 99th percentile, the share of empty
    tiles."""
    import torch

    n = per_tile.reshape(-1).float()
    return {"max": int(n.max()), "p99": float(torch.quantile(n, 0.99)),
            "empty_share": float((n == 0).float().mean())}


def real_faces(edges):
    """Slots of a table whose edge functions are not the sentinel's
    (a = b = 0, c = -1): edges (..., 3 edges, 3)."""
    sent = ((edges[..., 0] == 0) & (edges[..., 1] == 0)
            & (edges[..., 2] == -1)).all(dim=-1)
    return int((~sent).sum())


def make_avatar_and_clip(workdir):
    """The humanoid avatar at SMPL's size, saved in the avatar pickle
    schema, and a seeded 64-frame clip in AMASS format -> (avatar,
    avatar_path, clip_path)."""
    from tpubody_torch.mesh import rigging
    from tpubody_torch.models import humanoid

    raw = humanoid.humanoid_numpy(n_joints=24, n_verts=6890)
    rng = np.random.default_rng(5)
    V = raw["v_template"].shape[0]
    avatar = rigging.avatar_from_numpy(
        raw["v_template"], raw["weights"],
        rng.uniform(0.3, 0.9, size=(V, 3)), raw["faces"],
        raw["j_regressor"] @ raw["v_template"], raw["parents"])
    avatar_path = os.path.join(workdir, "avatar.pkl")
    rigging.save_avatar(avatar_path, avatar)

    # Smooth joint angles of about 0.3 rad and a small root translation.
    t = np.arange(VIDEO_FRAMES)[:, None] / VIDEO_FRAMES
    amp = rng.uniform(-0.3, 0.3, size=(1, 66))
    freq = rng.integers(1, 3, size=(1, 66))
    phase = rng.uniform(0, 2 * np.pi, size=(1, 66))
    poses = np.zeros((VIDEO_FRAMES, 156))
    poses[:, :66] = amp * np.sin(2 * np.pi * freq * t + phase)
    trans = 0.05 * np.sin(2 * np.pi * t + rng.uniform(0, 6, size=(1, 3)))
    clip_path = os.path.join(workdir, "clip.npz")
    np.savez(clip_path, poses=poses, trans=trans, mocap_framerate=30.0)
    return avatar, avatar_path, clip_path


class VideoSetup:
    """The video path's inputs on the card: avatar, clip, render plan and
    the skinned frames."""

    def __init__(self, dev, workdir):
        import torch

        from tpubody_torch.io import motion
        from tpubody_torch.mesh import rigging
        from tpubody_torch.render import video

        self.dev = dev
        self.avatar, self.avatar_path, self.clip_path = \
            make_avatar_and_clip(workdir)
        self.clip = motion.read_amass(self.clip_path)
        self.cam_t = np.array([0.0, 0.0, 2.5])
        self.plan = video.plan_tiled_render(
            self.avatar.v_template, self.avatar.faces, self.cam_t,
            VIDEO_SIZE, VIDEO_SIZE, video.DEFAULT_FOCAL)

        def on(x, dtype):
            return torch.as_tensor(np.asarray(x, dtype), device=dev)

        self.faces = on(self.avatar.faces, np.int32)
        self.colors = on(self.avatar.color, np.float32)
        self.cam = on(self.cam_t, np.float32)
        # (faces, span_x, span_y, total_chunks) of the base pass and rungs
        self.passes = [(on(self.plan["small_faces"], np.int32),
                        self.plan["span_x"], self.plan["span_y"],
                        self.plan["total_chunks"])]
        for lf, spec in zip(self.plan["ladder_faces"],
                            self.plan["ladder_specs"]):
            self.passes.append((on(lf, np.int32), spec[0], spec[1], spec[3]))
        self.verts = rigging.animate(self.avatar, self.clip.poses,
                                     self.clip.trans, device=dev)

    def screen_attrs(self, frames, shading):
        from tpubody_torch.render import video

        return video._screen_and_attrs(
            self.verts[frames], self.faces, self.colors, self.cam,
            VIDEO_SIZE, VIDEO_SIZE, video.DEFAULT_FOCAL, shading)


def check_raster_case(name, verts, faces, attrs, H, W, total_chunks, sx, sy,
                      cluster=None):
    """Bin, run the kernel (in clusters of ``cluster`` blocks a tile where
    it is given, else as fused_raster chooses) and its plain version on the
    same table, and hold them together -> (attr max |d|, overflow, hits)."""
    import torch

    from tpubody_torch.render import tiled_raster as TR

    table, cstarts, nvalid, overflow, meta = TR._bin_fused(
        verts, faces, attrs, H, W, total_chunks, sx, sy)
    fb, dl = meta["fb"], meta["depth_levels"]
    if cluster is None:
        win, attr = TR.fused_raster(table, cstarts, H, W, fb, dl)
    else:
        win, attr = TR._fused_raster_launch(table, cstarts, H, W, fb, dl,
                                            cluster)
    torch.cuda.synchronize()
    win_p, attr_p = TR.fused_raster_reference(table, cstarts, H, W, fb, dl)
    err, hits = hold_raster(
        name, win, attr, win_p, attr_p,
        f" chunks={int(nvalid.sum()):6d} overflow={int(overflow.sum()):4d}")
    return err, int(overflow.sum()), hits


def hold_raster(name, win, attr, win_p, attr_p, info=""):
    """The raster gate: fused_raster's (win, attr) against its plain
    version's on the same table; logs one line (with ``info``) ->
    (attr max |d|, hits), or raises where they disagree."""
    import torch

    from tpubody_torch.render import raster

    B, C, H, W = attr_p.shape
    if win.shape != (B, H, W) or attr.shape != (B, C, H, W):
        raise RuntimeError(f"{name}: shapes {win.shape} {attr.shape}")
    n_diff = int((win != win_p).sum())
    hits = int((win != raster.INT32_MAX).sum())
    err = (attr - attr_p).abs().max().item()
    bar = RASTER_ATTR_REL * max(attr_p.abs().max().item(), 1e-30)
    ok = n_diff == 0 and err <= bar and bool(torch.isfinite(attr).all())
    log(f"  {name:34s} C={C:2d}{info} hits={hits:8d}"
        f" win diffs={n_diff} attr max|d|={err:.3e}"
        f" {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"fused_raster disagrees with its plain version: "
                           f"{name}")
    return err, hits


def phase_raster_kernels(setup):
    import torch

    dev = setup.dev
    worst = 0.0
    # (a) two frames of the clip at full width, every pass, both shadings.
    for shading in ("gouraud", "phong"):
        screen, attrs = setup.screen_attrs([0, 37], shading)
        for i, (faces, sx, sy, tc) in enumerate(setup.passes):
            name = f"clip 1024^2 {shading} pass {i} F={faces.shape[0]}"
            err, ov, hits = check_raster_case(
                name, screen, faces, attrs, VIDEO_SIZE, VIDEO_SIZE, tc, sx,
                sy)
            worst = max(worst, err)
            if hits == 0:
                raise RuntimeError(f"{name}: nothing was covered")
    # (b) random scenes, (c) a 24-channel stack.
    for seed, n_faces, ext, C in ((4, 40, 12, 6), (5, 30, 10, 3),
                                  (6, 40, 12, 24)):
        v, f, a = random_scene(64, 128, n_faces, ext, seed, C)
        err, ov, hits = check_raster_case(
            f"random scene seed {seed} 64x128",
            torch.as_tensor(v, device=dev)[None], torch.as_tensor(f, device=dev),
            torch.as_tensor(a, device=dev)[None], 64, 128, 8 * 5, 2, 5)
        worst = max(worst, err)
        if ov or not hits:
            raise RuntimeError("random scene: unexpected overflow or no hit")
    # (d) 400 faces piled on one tile (13 chunks) with a budget of 8.
    v, f, a = piled_scene(400)
    err, ov, hits = check_raster_case(
        "overflowing budget 64x128",
        torch.as_tensor(v, device=dev)[None], torch.as_tensor(f, device=dev),
        torch.as_tensor(a, device=dev)[None], 64, 128, 8, 2, 5)
    if ov == 0:
        raise RuntimeError("the overflow case dropped no face")
    worst = max(worst, err)
    # (e) a heavy tile (38 chunks: more than the blocks of a cluster) and
    # slivers, two frames, at each cluster size of the kernel
    for name, (v, f, a) in (("heavy tile 64x128", piled_scene(1200)),
                            ("slivers 64x128", sliver_scene(64, 128))):
        for cluster in (1, 2):
            err, ov, hits = check_raster_case(
                f"{name} cluster {cluster}", two_frames(v, dev),
                torch.as_tensor(f, device=dev),
                torch.as_tensor(np.stack([a, a]), device=dev),
                64, 128, 8 * 8, 2, 5, cluster)
            worst = max(worst, err)
            if not hits:
                raise RuntimeError(f"{name}: nothing was covered")
    return worst


class FrameCollector:
    """Stands in for the MP4 encoder where cv2 is missing, and records the
    frames handed to the writer either way (the methods of
    tpubody_torch.render.video.VideoWriter)."""

    frames = []
    inner_cls = None      # the real VideoWriter where cv2 imports

    def __init__(self, path, fps=30.0, size=(VIDEO_SIZE, VIDEO_SIZE)):
        self.path = path
        self.inner = (FrameCollector.inner_cls(path, fps=fps, size=size)
                      if FrameCollector.inner_cls else None)

    def write(self, frame):
        from tpubody_torch.render import video

        FrameCollector.frames.append(("rgb", video.quantize_u8(frame).copy()))
        if self.inner:
            self.inner.write(frame)

    def write_i420(self, planes):
        FrameCollector.frames.append(("i420", np.array(planes)))
        if self.inner:
            self.inner.write_i420(planes)

    def close(self):
        if self.inner:
            self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def i420_luma(planes):
    return planes[: planes.shape[0] * 2 // 3]


def check_frames(frames, n, bbox, what):
    """n frames of 1024x1024, not all background, body pixels inside the
    projected bbox, consecutive frames different."""
    if len(frames) != n:
        raise RuntimeError(f"{what}: {len(frames)} frames, expected {n}")
    x0, x1, y0, y1 = bbox
    prev = None
    for kind, f in frames:
        if kind == "i420":
            if f.shape != (VIDEO_SIZE * 3 // 2, VIDEO_SIZE) or \
                    f.dtype != np.uint8:
                raise RuntimeError(f"{what}: I420 frame {f.shape} {f.dtype}")
            body = i420_luma(f) < 235          # white background: Y = 235
        else:
            if f.shape != (VIDEO_SIZE, VIDEO_SIZE, 3) or f.dtype != np.uint8:
                raise RuntimeError(f"{what}: RGB frame {f.shape} {f.dtype}")
            body = (f < 255).any(axis=-1)
        ys, xs = np.nonzero(body)
        if ys.size < 10000:
            raise RuntimeError(f"{what}: a frame shows no body")
        if xs.min() < x0 - 1 or xs.max() > x1 + 1 or ys.min() < y0 - 1 \
                or ys.max() > y1 + 1:
            raise RuntimeError(
                f"{what}: body pixels x [{xs.min()}, {xs.max()}] y "
                f"[{ys.min()}, {ys.max()}] outside the projected bbox {bbox}")
        if prev is not None and np.array_equal(prev, f):
            raise RuntimeError(f"{what}: two consecutive frames are equal")
        prev = f


def phase_video(setup, workdir):
    import torch

    from tpubody_torch import native
    from tpubody_torch.pipelines import animate
    from tpubody_torch.render import video

    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    log(f"  cv2 {'imports: frames are encoded to MP4' if have_cv2 else 'is missing: the encoder is replaced by a frame collector'}")
    FrameCollector.inner_cls = video.VideoWriter if have_cv2 else None
    real_writer = video.VideoWriter
    video.VideoWriter = FrameCollector
    try:
        bb = video.screen_bbox(setup.verts, setup.cam, VIDEO_SIZE, VIDEO_SIZE,
                               video.DEFAULT_FOCAL).cpu().numpy()
        bbox = (float(bb[0]), float(bb[1]), float(bb[2]), float(bb[3]))
        passes = len(setup.passes)
        log(f"  plan: base {setup.passes[0][0].shape[0]} faces, spans "
            f"{setup.passes[0][1]}x{setup.passes[0][2]}, "
            f"{setup.passes[0][3]} chunks; rungs "
            f"{[(int(p[0].shape[0]), p[3]) for p in setup.passes[1:]]}; "
            f"fragment buckets {len(setup.plan['large_buckets'])}")
        if passes != 3 or setup.plan["large_buckets"]:
            raise RuntimeError("the plan is not base + two ladder rungs")

        out = os.path.join(workdir, "clip.mp4")
        results = {}
        for run in ("cold", "warm"):
            FrameCollector.frames = []
            native.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            animate.animate_from_amass(setup.avatar_path, setup.clip_path,
                                       out, stride=1, size=VIDEO_SIZE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(native.LAUNCHES)
            want = (VIDEO_FRAMES // 8) * passes
            log(f"  {run}: {VIDEO_FRAMES} frames in {wall:.3f} s = "
                f"{VIDEO_FRAMES / wall:.2f} frames/s; launches {launches}")
            if launches["fused_raster"] != want:
                raise RuntimeError(
                    f"fused_raster launched {launches['fused_raster']} times "
                    f"on the video path, expected {want}")
            kinds = {k for k, _ in FrameCollector.frames}
            check_frames(FrameCollector.frames, VIDEO_FRAMES, bbox,
                         f"animate_from_amass ({run})")
            if have_cv2 and os.path.getsize(out) < 10000:
                raise RuntimeError("the MP4 is missing or trivial")
            results[run] = dict(wall_s=wall, fps=VIDEO_FRAMES / wall,
                                launches=launches, transfer=sorted(kinds))
        if have_cv2:
            log(f"  MP4: {os.path.getsize(out)} bytes")

        # The uint8-RGB full-frame transfer, 8 frames.
        from tpubody_torch.io import motion

        FrameCollector.frames = []
        clip8 = motion.MotionClip(setup.clip.poses[:8], setup.clip.trans[:8],
                                  setup.clip.fps)
        animate.animate_video(setup.avatar, clip8,
                              os.path.join(workdir, "clip8.mp4"),
                              size=VIDEO_SIZE, i420_transfer=False,
                              crop_transfer=False)
        check_frames(FrameCollector.frames, 8, bbox, "animate_video (RGB)")
        if {k for k, _ in FrameCollector.frames} != {"rgb"}:
            raise RuntimeError("the RGB transfer produced I420 frames")
        log("  8 frames with i420_transfer=False, crop_transfer=False: ok")
    finally:
        video.VideoWriter = real_writer
        FrameCollector.frames = []
    results["have_cv2"] = have_cv2
    return results


def phase_oracle(setup):
    import torch

    from tpubody_torch.pipelines import animate
    from tpubody_torch.render import video

    size, focal = 256, 625.0
    dev = setup.dev
    av = setup.avatar
    plan, pt, _ = animate._tiled_plan(av.v_template, av.faces, setup.cam_t,
                                      size, focal, 2, dev)
    bg = torch.ones((size, size, 3), dtype=torch.float32, device=dev)
    verts = setup.verts[[0, VIDEO_FRAMES - 1]]
    tiled = video.render_frames_tiled(
        verts, pt["small_faces"], pt["large_buckets"], setup.faces,
        setup.colors, setup.cam, bg, height=size, width=size, focal=focal,
        max_chunks=plan["max_chunks"], span_x=plan["span_x"],
        span_y=plan["span_y"], total_chunks=plan["total_chunks"],
        large_windows=plan["large_windows"], ladder_faces=pt["ladder_faces"],
        ladder_specs=plan["ladder_specs"], to_uint8=False)
    w = video.auto_window(av.v_template, av.faces, setup.cam_t, size, size,
                          focal)
    frag = video.render_frames(verts, setup.faces, setup.colors, setup.cam,
                               bg, height=size, width=size, focal=focal,
                               window=w)
    torch.cuda.synchronize()
    agree = ((tiled - frag).abs() <= ORACLE_ATOL).float().mean().item()
    body = (frag < 1.0).any(dim=-1).float().mean().item()
    log(f"  tiled vs fragment renderer at {size}^2 (window {w}): "
        f"{agree * 100:.3f}% of values within {ORACLE_ATOL}; body covers "
        f"{body * 100:.1f}% of the frame")
    if agree <= ORACLE_AGREE or body < 0.02:
        raise RuntimeError("the tiled renderer disagrees with the fragment "
                           "renderer")
    return agree


class LayerTimer:
    """CUDA-event spans around the layers of a render block, taken inside
    one run of the block: each wrapped function records an event on the
    stream before and after its call, so a layer's time is the card's time
    between the two, launch gaps included, and the layers are disjoint
    parts of the block's total."""

    def __init__(self):
        self.spans = []               # (name, start event, end event)

    def wrap(self, name, fn):
        import torch

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.spans.append((name, start, end))
            return out

        return timed

    def ms(self):
        """name -> list of span times, in call order."""
        out = {}
        for name, start, end in self.spans:
            out.setdefault(name, []).append(start.elapsed_time(end))
        return out


def phase_video_timing(setup, workdir, video_res, raster_err):
    """CUDA-event times per layer of one 8-frame block, and the kernel
    against its plain version and its bound."""
    import torch

    from tpubody_torch.mesh import rigging
    from tpubody_torch.pipelines import animate
    from tpubody_torch.render import tiled_raster as TR
    from tpubody_torch.render import video

    dev = setup.dev
    block = setup.verts[:8].contiguous()
    H = W = VIDEO_SIZE
    n_pass = len(setup.passes)
    raster_err = 0.0 if raster_err is None else raster_err
    split = {}
    split["skinning_64_frames"] = time_ms(lambda: rigging.animate(
        setup.avatar, setup.clip.poses, setup.clip.trans, device=dev),
        iters=10, warmup=2)

    # The block's layers, inside the block: the same render_block that
    # animate_video drives, with its layers wrapped in event spans.
    render_block, chunk, i420 = animate._block_renderer(
        setup.avatar, None, setup.cam_t, VIDEO_SIZE, video.DEFAULT_FOCAL,
        None, 8, i420=True, device=dev)
    iters = 10
    for _ in range(2):
        render_block(block)
    timer = LayerTimer()
    patched = [(video, "_screen_and_attrs", "transform_normals"),
               (TR, "_bin_fused", "binning"),
               (TR, "fused_raster", "fused_raster"),
               (video, "_composite", "composite"),
               (video, "_shade_and_pack", "shade_i420")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]
    try:
        for mod, attr, name in patched:
            setattr(mod, attr, timer.wrap(name, getattr(mod, attr)))
        split["render_block"] = time_ms(lambda: render_block(block),
                                        iters=iters, warmup=0)
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    spans = timer.ms()
    for name, times in spans.items():
        split[name] = sum(times) / iters
    # what is left: the depth rebuilt from the winning key in
    # render_attrs_tiled, and the gaps between the layers
    split["depth_from_key_and_gaps"] = split["render_block"] - sum(
        split[name] for name in spans)
    if len(spans["binning"]) != iters * n_pass:
        raise RuntimeError("the block did not bin once per pass")

    # The kernel alone, per pass: back-to-back launches on the block's own
    # tables (L2 warm), held to its plain version on them (the route the
    # main path takes at 8 frames), its bound.
    screen, attrs = setup.screen_attrs(slice(0, 8), "gouraud")
    passes = []
    for i, (faces, sx, sy, tc) in enumerate(setup.passes):
        table, cstarts, nvalid, _, meta = TR._bin_fused(
            screen, faces, attrs, H, W, tc, sx, sy)
        fb, dl = meta["fb"], meta["depth_levels"]
        B, MAXC, CF, G, _ = table.shape
        win, attr = TR.fused_raster(table, cstarts, H, W, fb, dl)
        torch.cuda.synchronize()
        win_p, attr_p = TR.fused_raster_reference(table, cstarts, H, W, fb,
                                                  dl)
        err, _ = hold_raster(f"video block B={B} pass {i}", win, attr, win_p,
                             attr_p, f" cluster={TR.cluster_for(B * T_1024)}")
        raster_err = max(raster_err, err)
        del win, attr, win_p, attr_p
        k_ms = time_ms(lambda: TR.fused_raster(table, cstarts, H, W, fb, dl),
                       iters=20, warmup=3)
        cluster_ms = {c: time_ms(lambda: TR._fused_raster_launch(
            table, cstarts, H, W, fb, dl, c), iters=20, warmup=3)
            for c in (1, 2)}
        p_ms = time_ms(lambda: TR.fused_raster_reference(
            table, cstarts, H, W, fb, dl), iters=2, warmup=1)
        chunks = int(torch.clamp(nvalid, max=MAXC).sum())
        edges = table[:, :, :, 0:3, :][
            torch.arange(MAXC, device=dev)[None] < nvalid[:, None]]
        real = real_faces(edges)
        # (face, warp) pairs the kernel's rejection keeps
        kept = int((~TR.warp_rejects(edges[:, :, None],
                                     TR.warp_rects(dev))).sum())
        nbytes = chunks * CF * G * 3 * 4 + cstarts.numel() * 4 \
            + B * H * W * 4 * (1 + G - 5)
        ops = real * TR.LP * RASTER_OPS_PER_FACE_PIXEL
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        ops_ms = ops / PEAK_FP32 * 1e3
        passes.append(dict(
            faces=int(faces.shape[0]), spans=[sx, sy], total_chunks=tc,
            valid_chunks=chunks, real_faces_in_chunks=real,
            kept_face_warp_pairs=kept,
            chunks_a_tile=chunk_histogram(cstarts[:, 1:] - cstarts[:, :-1]),
            cluster=TR.cluster_for(B * T_1024),
            bin_ms_in_block=sum(spans["binning"][i::n_pass]) / iters,
            ms_in_block=sum(spans["fused_raster"][i::n_pass]) / iters,
            ms=k_ms, ms_by_cluster=cluster_ms, plain_ms=p_ms,
            bytes_ms=bytes_ms, ops_ms=ops_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations"))

    # Where clusters of 2 stop paying: the base pass of 1 to 8 frames at
    # both sizes, each launch held to the plain version (the wrapper takes
    # 2 up to TR.CLUSTER_TILES tiles a launch, 1 above).
    faces, sx, sy, tc = setup.passes[0]
    by_frames = {}
    for nf in CLUSTER_FRAMES:
        sc, at = setup.screen_attrs(slice(0, nf), "gouraud")
        table, cstarts, _, _, meta = TR._bin_fused(sc, faces, at, H, W, tc,
                                                   sx, sy)
        fb, dl = meta["fb"], meta["depth_levels"]
        win_p, attr_p = TR.fused_raster_reference(table, cstarts, H, W, fb,
                                                  dl)
        by_frames[nf] = {}
        for c in (1, 2):
            win, attr = TR._fused_raster_launch(table, cstarts, H, W, fb, dl,
                                                c)
            torch.cuda.synchronize()
            err, _ = hold_raster(f"base pass {nf} frames cluster {c}", win,
                                 attr, win_p, attr_p)
            raster_err = max(raster_err, err)
            by_frames[nf][c] = time_ms(lambda: TR._fused_raster_launch(
                table, cstarts, H, W, fb, dl, c), iters=20, warmup=3)
        log(f"  base pass, {nf} frames ({nf * T_1024} tiles): ms at clusters "
            f"of 1, 2: {by_frames[nf][1]:.4f}, {by_frames[nf][2]:.4f}; the "
            f"wrapper takes {TR.cluster_for(nf * T_1024)}")

    frames = render_block(block)
    host = torch.empty(frames.shape, dtype=frames.dtype, pin_memory=True)
    split["copy_to_host"] = time_ms(
        lambda: host.copy_(frames, non_blocking=True), iters=10, warmup=2)
    if video_res["have_cv2"]:
        planes = host.numpy()
        with video.VideoWriter(os.path.join(workdir, "mux.mp4"),
                               size=(VIDEO_SIZE, VIDEO_SIZE)) as wr:
            t0 = time.perf_counter()
            for f in planes:
                wr.write_i420(f)
            split["mux_host_8_frames"] = (time.perf_counter() - t0) * 1e3
    else:
        split["mux_host_8_frames"] = None
    res = dict(frames_per_s=video_res["warm"]["fps"],
               frames_per_s_cold=video_res["cold"]["fps"],
               frames=VIDEO_FRAMES, size=VIDEO_SIZE, block=chunk,
               transfer=video_res["warm"]["transfer"],
               have_cv2=video_res["have_cv2"],
               block_split_ms=split, passes=passes,
               base_pass_ms_by_frames_and_cluster=by_frames)
    log(f"  video: {res['frames_per_s']:.2f} frames/s warm "
        f"({res['frames_per_s_cold']:.2f} cold); ms per 8-frame block: "
        + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not measured"
                    for k, v in split.items()))
    for i, p in enumerate(passes):
        log(f"  pass {i}: {p}")
    log(json.dumps({"video": res}))

    base = passes[0]
    return {
        "name": "fused_raster",
        "route": "cuda",
        "source": "tpubody_torch/csrc/fused_raster.cu",
        "replaces": "tpubody/render/pallas_raster.py:600",
        "replaces_fn": "tpubody/render/pallas_raster.py::_fused_kernel",
        "shape": {"B": 8, "H": H, "W": W, "C": 3, "CF": TR.CF_FUSED,
                  "faces": base["faces"], "valid_chunks": base["valid_chunks"],
                  "pass": "base (pass 0 of 3)"},
        "launches": video_res["warm"]["launches"]["fused_raster"],
        "max_abs_err": raster_err,
        "max_err": raster_err,
        "ms": base["ms"],
        "kernel_ms": base["ms"],
        "plain_ms": base["plain_ms"],
        "bound_ms": base["bound_ms"],
        "bound_by": base["bound_by"],
        "library_ms": None,
        "passes": passes,
    }


def phase_video_profile(setup, workdir):
    """torch.profiler over one warm pass of the video path: the card's busy
    share of the wall time and its time by kernel.  Not part of the default
    run (``--phases video,vprofile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpubody_torch.pipelines import animate

    out = os.path.join(workdir, "profile.mp4")

    def run():
        animate.animate_from_amass(setup.avatar_path, setup.clip_path, out,
                                   stride=1, size=VIDEO_SIZE)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    if busy_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    log(f"  profiled pass: {VIDEO_FRAMES} frames in {wall_ms:.1f} ms under "
        f"the profiler; device kernels busy {busy_ms:.1f} ms = "
        f"{busy_ms / wall_ms * 100:.1f}% of the wall time (idle "
        f"{100 - busy_ms / wall_ms * 100:.1f}%)")
    for key, ms, count in rows[:12]:
        log(f"    {ms:9.3f} ms {count:6d} x  {key[:90]}")
    log(json.dumps({"video_profile": {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "top": [{"kernel": k[:120], "ms": ms, "count": c}
                for k, ms, c in rows[:12]]}}))


# -- the reconstruct path ----------------------------------------------------
class ReconSetup:
    """The demo fixture in memory on ``dev``: the two humanoid models at
    SMPL's size, the fit (pose, betas, a camera centred on the posed body:
    focal 5000 at 1024^2), the posed vertices, and the photo mask: the same
    body at PHOTO_BETAS through the same camera."""

    def __init__(self, dev, size, n_verts=6890):
        import torch

        from tpubody_torch.models import humanoid, smpl
        from tpubody_torch.pipelines import demo, reconstruct as rec
        from tpubody_torch.render import bodymaps

        self.dev, self.size = dev, size
        self.smplh = humanoid.humanoid(52, n_verts, device=dev)
        self.smpl = humanoid.humanoid(24, n_verts, device=dev)
        pose = demo.demo_pose(52, 0)

        def posed(betas):
            return smpl.forward(
                self.smplh,
                torch.as_tensor(pose, dtype=torch.float32, device=dev),
                torch.as_tensor(betas, dtype=torch.float32, device=dev)).verts

        self.verts = posed(demo.DEMO_BETAS)
        v = self.verts.cpu().numpy().astype(np.float64)
        focal = 5000.0 * size / 1024.0
        center = np.array([size / 2.0, size / 2.0])
        c = (v.min(axis=0) + v.max(axis=0)) / 2.0
        extent = float((v.max(axis=0) - v.min(axis=0))[:2].max()) * 1.35
        cam_t = np.array([-c[0], -c[1],
                          extent * focal / (0.85 * size) - c[2]])
        self.fit = rec.FitResult(
            shape=demo.DEMO_BETAS, pose=pose.reshape(-1),
            camera_center=center,
            camera_rotation=np.eye(3), camera_translation=cam_t,
            camera_fx=focal)
        photo = bodymaps.render_body_maps(
            posed(PHOTO_BETAS), self.smplh.faces, self.smpl.weights, cam_t,
            center, size, size, focal=focal, device=dev)
        self.mask = photo.mask.cpu().numpy()
        self.mask_u8 = self.mask.astype(np.uint8) * 255

    def scene(self):
        """The body-map passes on the card: screen-space vertices, and
        (name, faces, attrs) of the front, back and all-faces pass."""
        import torch

        from tpubody_torch.render import bodymaps, raster

        dev = self.dev

        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=dev)

        screen = bodymaps.project_to_screen(
            self.verts, f32(self.fit.camera_translation),
            f32(self.fit.camera_center), self.fit.camera_fx)
        faces_np = np.asarray(self.smplh.faces).astype(np.int32)
        front, back = bodymaps._front_back_faces(self.verts, faces_np)
        allf = torch.as_tensor(faces_np, device=dev)
        return screen, [
            ("front", front,
             (raster.vertex_normals(self.verts, front) + 1.0) * 0.5),
            ("back", back,
             (raster.vertex_normals(self.verts, back) + 1.0) * 0.5),
            ("all", allf, self.smpl.weights.to(dev))]

    def run(self, workdir, timer=None, detail=None, cache=False):
        """The helper of the reconstruct pipeline on this fixture ->
        ((J_2d, stitch weights, front depth, back depth), keep, timer)."""
        from tpubody_torch.pipelines import reconstruct as rec
        from tpubody_torch.utils.cache import StageCache
        from tpubody_torch.utils.profiling import StageTimer

        timer = timer or StageTimer()
        keep = {}
        out = rec._device_stages(
            self.mask_u8, self.fit, self.smplh, self.smpl,
            StageCache(workdir, enabled=cache), timer, detail, keep=keep)
        return out, keep, timer


def zbuffer_plan(screen, faces, H, W):
    """Spans, a chunk capacity under which no tile of this pass overflows,
    and the fused path's chunk budget ->
    (span_x, span_y, max_chunks, total_chunks)."""
    import torch

    from tpubody_torch.render import bodymaps, tiled_raster as TR

    sx, sy, tc = bodymaps._tiled_plan(screen, faces, H, W)
    nc = 4
    while int(TR.bin_faces(screen[None], faces, H, W, nc, sx, sy)[2].sum()):
        nc *= 2
        if nc > 32:
            raise RuntimeError("a tile holds more than 4096 faces")
    torch.cuda.synchronize()
    return sx, sy, nc, tc


def check_zbuffer_case(name, verts, faces, H, W, nc, sx, sy, cluster=None):
    """Bin, run the kernel (in clusters of ``cluster`` blocks a tile where
    it is given, else as zbuffer chooses) and its plain version on the same
    table and hold them together -> (max |key difference|, overflow, hits,
    zbuf)."""
    import torch

    from tpubody_torch.render import raster, tiled_raster as TR

    table, nchunks, overflow = TR.bin_faces(verts, faces, H, W, nc, sx, sy)
    fb = raster._face_bits(int(faces.shape[0]))
    dl = 1 << (31 - fb)
    z = (TR.zbuffer(table, nchunks, H, W, fb, dl) if cluster is None else
         TR._zbuffer_launch(table, nchunks, H, W, fb, dl, cluster))
    torch.cuda.synchronize()
    z_p = TR.zbuffer_reference(table, nchunks, H, W, fb, dl)
    if z.shape != (verts.shape[0], H, W) or z.dtype != torch.int32:
        raise RuntimeError(f"{name}: zbuf {tuple(z.shape)} {z.dtype}")
    n_diff = int((z != z_p).sum())
    err = float((z.to(torch.int64) - z_p.to(torch.int64)).abs().max())
    hits = int((z != raster.INT32_MAX).sum())
    log(f"  {name:34s} NC={nc:2d} chunks={int(nchunks.sum()):5d}"
        f" overflow={int(overflow.sum()):4d} hits={hits:8d}"
        f" diffs={n_diff} {'ok' if n_diff == 0 else 'FAIL'}")
    if n_diff:
        raise RuntimeError(f"zbuffer disagrees with its plain version: "
                           f"{name}")
    return err, int(overflow.sum()), hits, z


def phase_zbuffer(recon):
    """-> the largest |key difference| between the kernel and its plain
    version over the cases (0, or the phase has raised)."""
    import torch

    from tpubody_torch.render import raster, tiled_raster as TR

    dev = recon.dev
    H = W = recon.size
    total = 0.0
    # (a) the body-map scene at full width, and the fused kernel's face ids
    screen, passes = recon.scene()
    for name, faces, attrs in passes:
        sx, sy, nc, tc = zbuffer_plan(screen, faces, H, W)
        err, ov, hits, z = check_zbuffer_case(
            f"body maps {H}^2 {name} F={faces.shape[0]}", screen[None],
            faces, H, W, nc, sx, sy)
        total = max(total, err)
        if hits < 0.03 * H * W:
            raise RuntimeError(f"body maps {name}: nothing was covered")
        table, cstarts, _, ov2, meta = TR._bin_fused(
            screen[None], faces, attrs[None, :, :3].contiguous(), H, W, tc,
            sx, sy)
        win, _ = TR.fused_raster(table, cstarts, H, W, meta["fb"],
                                 meta["depth_levels"])
        fid_mask = (1 << meta["fb"]) - 1
        none = raster.INT32_MAX
        same = ((z == none) & (win == none)) | \
            ((z != none) & (win != none) & ((z & fid_mask) == (win & fid_mask)))
        share = same.float().mean().item()
        keys = (z == win).float().mean().item()
        log(f"    face ids equal to fused_raster's on {share * 100:.4f}% of "
            f"the pixels (whole keys on {keys * 100:.4f}%; fused overflow "
            f"{int(ov2.sum())})")
        if share < FACE_ID_AGREE:
            raise RuntimeError("zbuffer and fused_raster disagree on the "
                               "winning faces")
    # (b) random scenes of two frames, (c) under 64 faces: the wrapped key
    for seed, n_faces, ext, nc in ((0, 40, 12, 3), (4, 40, 12, 2),
                                   (7, 90, 10, 1)):
        v, f, _ = random_scene(64, 128, n_faces, ext, seed, 3)
        vb = torch.as_tensor(np.stack([v, v + np.float32([3.0, 1.0, 0.0])]),
                             device=dev)
        err, ov, hits, _ = check_zbuffer_case(
            f"random scene seed {seed} 64x128 x2", vb,
            torch.as_tensor(f, device=dev), 64, 128, nc, 2, 5)
        total = max(total, err)
        if ov or not hits:
            raise RuntimeError("random scene: unexpected overflow or no hit")
    # (d) 400 faces piled on one tile with a capacity of 128 and of 256
    v, f, _ = piled_scene(400)
    for nc in (1, 2):
        err, ov, hits, _ = check_zbuffer_case(
            "overflowing tile 64x128", torch.as_tensor(v, device=dev)[None],
            torch.as_tensor(f, device=dev), 64, 128, nc, 2, 5)
        total = max(total, err)
        if ov == 0:
            raise RuntimeError("the overflow case dropped no face")
    # (e) a heavy tile (10 chunks of 128: more than the blocks of a
    # cluster) and slivers, two frames, at each cluster size of the kernel
    for name, (v, f, _) in (("heavy tile 64x128", piled_scene(1200)),
                            ("slivers 64x128", sliver_scene(64, 128))):
        for cluster in (1, 2):
            err, ov, hits, _ = check_zbuffer_case(
                f"{name} cluster {cluster}", two_frames(v, dev),
                torch.as_tensor(f, device=dev), 64, 128, 10, 2, 5, cluster)
            total = max(total, err)
            if ov or not hits:
                raise RuntimeError(f"{name}: overflow or no hit")
    return total


def check_recon_outputs(recon, out, keep, what, wsum_atol=WSUM_ATOL):
    """The gates of the reconstruct path on one run of the helper."""
    import torch

    J_2d, weights, front, back = out
    S = recon.size
    mask = recon.mask
    value = keep["value"]
    if tuple(value.shape) != (S, S, 30) or J_2d.shape != (24, 2):
        raise RuntimeError(f"{what}: shapes {tuple(value.shape)} {J_2d.shape}")
    body = ~(value[..., :3] == 1.0).all(dim=-1)
    share = body.float().mean().item()
    bg = value[~body]
    wsum = value[..., 6:][body].sum(dim=-1)
    werr = (wsum - 1.0).abs().max().item()
    if not (0.05 < share < 0.6) or not bool((bg[:, :3] == 1.0).all()) \
            or not bool((bg[:, 6:] == 1.0).all()) or werr > wsum_atol:
        raise RuntimeError(f"{what}: value map: body share {share}, weights "
                           f"sum off by {werr}")
    warp = keep["warp"]
    m = torch.as_tensor(mask, device=warp.device)
    filled = (warp.abs().sum(dim=-1) > 0)
    if not bool(filled[m].all()) or bool((warp[~m] != 0).any()):
        raise RuntimeError(f"{what}: the warped map does not fill the mask")
    moved = int((body.cpu().numpy() != mask).sum())
    pcg = keep["pcg"]
    if not pcg["relative_residual"] < PCG_RELRES:
        raise RuntimeError(f"{what}: PCG relative residual "
                           f"{pcg['relative_residual']}")
    for d in (front, back):
        if d.shape != (S, S) or not np.isfinite(d).all() \
                or (d[~mask] != 0).any() or not d[mask].max() > 0:
            raise RuntimeError(f"{what}: bad depth map")
    if weights.shape != (S, S, 24) or not np.isfinite(weights).all():
        raise RuntimeError(f"{what}: bad stitch weights")
    log(f"  {what}: body {share * 100:.2f}% of the frame, photo mask "
        f"{mask.mean() * 100:.2f}% ({moved} pixels differ); weights sum to 1 "
        f"within {werr:.2e}; PCG {pcg['iterations']} iterations, relative "
        f"residual {pcg['relative_residual']:.3e}; depth range front "
        f"{front.max():.3f} back {back.max():.3f}")


def phase_reconstruct(recon, workdir):
    import torch

    from tpubody_torch import native
    from tpubody_torch.render import tiled_raster as TR

    dev = recon.dev
    S = recon.size
    screen, passes = recon.scene()
    _, front_faces, front_attrs = passes[0]
    sx, sy, nc, _ = zbuffer_plan(screen, front_faces, S, S)

    # The main path: the helper with the cache off, then the front normal
    # map once more through the z-buffer rasterizer.
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, keep, timer = recon.run(workdir)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tiled, overflow = TR.rasterize_tiled(
        screen, front_faces, front_attrs, S, S, max_chunks=nc, span_x=sx,
        span_y=sy, return_overflow=True)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    log(f"  helper at {S}^2 (cold): {wall:.3f} s; launches {launches}")
    log("  " + timer.report().replace("\n", "\n  "))
    if launches["fused_raster"] != 3 or launches["zbuffer"] != 1:
        raise RuntimeError(f"the reconstruct path launched {launches}, "
                           f"expected fused_raster 3 and zbuffer 1")
    check_recon_outputs(recon, out, keep, f"reconstruct {S}^2")

    # rasterize_tiled's map against the fused kernel's front normal map
    fused = keep["value"][..., :3]
    fmask = ~(fused == 1.0).all(dim=-1)
    tmap = torch.where(tiled.mask[..., None], tiled.attrs,
                       torch.ones_like(tiled.attrs))
    same_mask = (tiled.mask == fmask).float().mean().item()
    close = ((tmap - fused).abs().amax(dim=-1) <= TILED_MAP_ATOL
             ).float().mean().item()
    log(f"  rasterize_tiled front normals vs the fused map: coverage equal "
        f"on {same_mask * 100:.4f}% of the pixels, values within "
        f"{TILED_MAP_ATOL} on {close * 100:.4f}%; overflow {int(overflow)}")
    if int(overflow) or min(same_mask, close) < TILED_MAP_AGREE:
        raise RuntimeError("rasterize_tiled disagrees with the fused map")

    # A small input: the same path on the card and on the CPU, fp32.
    small = ReconSetup(dev, RECON_SMALL)
    small_cpu = ReconSetup("cpu", RECON_SMALL)
    if not np.array_equal(small.mask, small_cpu.mask):
        n = int((small.mask != small_cpu.mask).sum())
        log(f"  {RECON_SMALL}^2: the photo masks differ on {n} pixels; the "
            f"CPU's is used for both")
        small.mask, small.mask_u8 = small_cpu.mask, small_cpu.mask_u8
    out_g, keep_g, _ = small.run(workdir)
    out_c, keep_c, _ = small_cpu.run(workdir)
    check_recon_outputs(small, out_g, keep_g, f"card {RECON_SMALL}^2",
                        WSUM_ATOL_SMALL)
    rng = float(out_c[2].max() - out_c[2].min())
    sil_g = (keep_g["value"][..., :3] == 1.0).all(dim=-1).cpu()
    sil_c = (keep_c["value"][..., :3] == 1.0).all(dim=-1)
    same_sil = bool(torch.equal(sil_g, sil_c))
    # Tight bars on TIGHT_SHARE of the pixels, not all: where a warped
    # position lies within float32 rounding of a pixel boundary, the MVC's
    # transcendentals (libm on the CPU, CUDA's on the card) round it to
    # neighbouring pixels, so single pixels of the scatter take their value
    # from the next source pixel, and the depth bends a little around them.
    d_front = np.abs(out_g[2] - out_c[2])
    d_back = np.abs(out_g[3] - out_c[3])
    d_w = np.abs(out_g[1] - out_c[1]).max(axis=-1)
    depth_ok = float(((d_front <= DEPTH_REL * rng)
                      & (d_back <= DEPTH_REL * rng)).mean())
    w_ok = float((d_w <= WEIGHT_ATOL).mean())
    log(f"  fp32 card vs CPU at {RECON_SMALL}^2: silhouettes "
        f"{'equal' if same_sil else 'differ'}; depth max|d| front "
        f"{d_front.max():.3e} back {d_back.max():.3e} (range {rng:.3f}), "
        f"mean {d_front.mean():.3e}, within {DEPTH_REL} of the range on "
        f"{depth_ok * 100:.4f}% of the pixels; stitch weights max|d| "
        f"{d_w.max():.3e}, within {WEIGHT_ATOL} on {w_ok * 100:.4f}%; PCG "
        f"iterations {keep_g['pcg']['iterations']} vs "
        f"{keep_c['pcg']['iterations']}")
    if not np.array_equal(out_g[0], out_c[0]):
        raise RuntimeError("projected joints differ between card and CPU")
    if max(d_front.mean(), d_back.mean()) > CHAIN_MEAN_REL * rng:
        raise RuntimeError("the card's depth disagrees with the CPU's")
    if same_sil and (min(depth_ok, w_ok) < TIGHT_SHARE
                     or max(d_front.max(), d_back.max())
                     > CHAIN_MEAN_REL * rng
                     or abs(keep_g["pcg"]["iterations"]
                            - keep_c["pcg"]["iterations"]) > 2):
        raise RuntimeError("the card disagrees with the CPU on equal "
                           "silhouettes")

    return dict(launches=launches, wall_s=wall, pcg=keep["pcg"])


class EventStageTimer:
    """The interface of tpubody_torch.utils.profiling.StageTimer with
    CUDA-event spans: an event is recorded on the stream when a stage
    begins and when it ends, nothing synchronises in between, and a
    stage's time is the card's clock between the two (the host's work and
    the launch gaps inside the stage included)."""

    def __init__(self):
        self.records = []
        self.spans = []

    def stage(self, name):
        import contextlib

        import torch

        @contextlib.contextmanager
        def span():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self.spans.append((name, start, end))

        return span()

    def ms(self):
        import torch

        torch.cuda.synchronize()
        out = {}
        for name, start, end in self.spans:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def device_busy(fn):
    """Run fn under torch.profiler -> (device busy ms, number of device
    kernels and copies, the five largest rows)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return busy, sum(r[2] for r in rows), rows[:5]


def phase_recon_timing(recon, workdir, recon_res, zbuffer_diffs):
    """Stage and substage times of a warm run of the helper, the card's
    busy share of its two long stages, and the two raster kernels alone at
    the body-map shapes."""
    import torch

    from tpubody_torch.image import warp as warp_lib
    from tpubody_torch.render import raster, tiled_raster as TR
    from tpubody_torch.solve import normal2depth as n2d

    dev = recon.dev
    S = recon.size
    timer = EventStageTimer()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, keep, _ = recon.run(workdir, timer=timer, detail=timer)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stages = timer.ms()
    log(f"  helper at {S}^2 (warm): {wall_ms:.1f} ms on the host's clock; "
        f"CUDA-event spans, ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))

    # The card's busy share of the two long stages.
    value, mask_dev = keep["value"], torch.as_tensor(recon.mask, device=dev)
    warped6 = keep["warp"][..., :6].contiguous()
    busy = {}
    for name, fn in (
            ("normal2depth", lambda: n2d.normal2depth(warped6, mask_dev)),
            ("warp", lambda: warp_lib.warp_stage(recon.mask_u8, value))):
        fn()
        span_ms = time_ms(fn, iters=2, warmup=0)
        busy_ms, count, top = device_busy(fn)
        busy[name] = dict(span_ms=span_ms, device_busy_ms=busy_ms,
                          device_ops=count,
                          gap_share=1.0 - busy_ms / span_ms)
        log(f"  {name}: {span_ms:.3f} ms a run; under the profiler {count} "
            f"device kernels and copies busy {busy_ms:.3f} ms: "
            f"{(1 - busy_ms / span_ms) * 100:.1f}% of the stage is gaps")
        for key, ms, c in top:
            log(f"    {ms:9.3f} ms {c:6d} x  {key[:90]}")

    # The kernels alone at the body-map shapes (back to back, L2 warm).
    screen, passes = recon.scene()
    zb, fused = [], []
    for name, faces, attrs in passes:
        sx, sy, nc, tc = zbuffer_plan(screen, faces, S, S)
        table, nchunks, _ = TR.bin_faces(screen[None], faces, S, S, nc, sx,
                                         sy)
        fb = raster._face_bits(int(faces.shape[0]))
        dl = 1 << (31 - fb)
        k_ms = time_ms(lambda: TR.zbuffer(table, nchunks, S, S, fb, dl),
                       iters=50, warmup=5)
        cluster_ms = {c: time_ms(lambda: TR._zbuffer_launch(
            table, nchunks, S, S, fb, dl, c), iters=50, warmup=5)
            for c in (1, 2)}
        p_ms = time_ms(lambda: TR.zbuffer_reference(table, nchunks, S, S, fb,
                                                    dl), iters=3, warmup=1)
        bin_ms = time_ms(lambda: TR.bin_faces(screen[None], faces, S, S, nc,
                                              sx, sy), iters=5, warmup=1)
        chunks = int(nchunks.sum())
        live = (torch.arange(nc, device=dev)[None, None]
                < nchunks[..., None])                       # (1, T, NC)
        real = real_faces(table.reshape(1, -1, nc, 5, TR.CF, 4)[
            live][:, 0:3, :, 0:3].permute(0, 2, 1, 3))
        nbytes = chunks * 5 * TR.CF * 4 * 4 + nchunks.numel() * 4 + S * S * 4
        ops = real * TR.LP * RASTER_OPS_PER_FACE_PIXEL
        bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
        zb.append(dict(
            name=name, faces=int(faces.shape[0]), spans=[sx, sy],
            max_chunks=nc, live_chunks=chunks, real_faces_in_chunks=real,
            live_tiles=int((nchunks > 0).sum()), table_mb=table.numel() * 4e-6,
            chunks_a_tile=chunk_histogram(nchunks), cluster=TR.cluster_for(
                (S // TR.TILE_H) * (S // TR.TILE_W)),
            ms=k_ms, ms_by_cluster=cluster_ms, plain_ms=p_ms, bin_ms=bin_ms,
            bytes_ms=bytes_ms, ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations"))

        ftab, cstarts, nvalid, _, meta = TR._bin_fused(
            screen[None], faces, attrs[None].contiguous(), S, S, tc, sx, sy)
        ffb, fdl = meta["fb"], meta["depth_levels"]
        fk_ms = time_ms(lambda: TR.fused_raster(ftab, cstarts, S, S, ffb,
                                                fdl), iters=50, warmup=5)
        fp_ms = time_ms(lambda: TR.fused_raster_reference(
            ftab, cstarts, S, S, ffb, fdl), iters=2, warmup=1)
        _, MAXC, CFf, G, _ = ftab.shape
        fchunks = int(torch.clamp(nvalid, max=MAXC).sum())
        freal = real_faces(ftab[:, :, :, 0:3, :][
            torch.arange(MAXC, device=dev)[None] < nvalid[:, None]])
        fbytes = fchunks * CFf * G * 3 * 4 + cstarts.numel() * 4 \
            + S * S * 4 * (1 + G - 5)
        fops = freal * TR.LP * RASTER_OPS_PER_FACE_PIXEL
        fb_ms, fo_ms = fbytes / PEAK_BYTES * 1e3, fops / PEAK_FP32 * 1e3
        fused.append(dict(
            name=name, C=G - 5, total_chunks=tc, valid_chunks=fchunks,
            real_faces_in_chunks=freal,
            chunks_a_tile=chunk_histogram(cstarts[:, 1:] - cstarts[:, :-1]),
            ms=fk_ms, plain_ms=fp_ms, bytes_ms=fb_ms, ops_ms=fo_ms,
            bound_ms=max(fb_ms, fo_ms),
            bound_by="bytes" if fb_ms >= fo_ms else "operations"))
    for p in zb:
        log(f"  zbuffer {p}")
    for p in fused:
        log(f"  fused_raster {p}")
    res = dict(size=S, wall_ms_warm=wall_ms, wall_s_cold=recon_res["wall_s"],
               stage_ms=stages, busy=busy, pcg=recon_res["pcg"], zbuffer=zb,
               fused_raster=fused)
    log(json.dumps({"reconstruct": res}))

    allp = zb[-1]
    entry = {
        "name": "zbuffer",
        "route": "cuda",
        "source": "tpubody_torch/csrc/zbuffer.cu",
        "replaces": "tpubody/render/pallas_raster.py:231",
        "replaces_fn": "tpubody/render/pallas_raster.py::_raster_kernel",
        "shape": {"B": 1, "H": S, "W": S, "CF": TR.CF,
                  "faces": allp["faces"], "max_chunks": allp["max_chunks"],
                  "live_chunks": allp["live_chunks"],
                  "pass": "all faces (the front pass is the one launched "
                          "on the main path)"},
        "launches": recon_res["launches"]["zbuffer"],
        "max_abs_err": zbuffer_diffs,
        "ms": allp["ms"],
        "plain_ms": allp["plain_ms"],
        "bound_ms": allp["bound_ms"],
        "bound_by": allp["bound_by"],
        "library_ms": None,
        "passes": zb,
    }
    return entry, fused


# -- the whole reconstruction and the demo (phases 18-19) --------------------
def stage_split(timer):
    """A StageTimer's records -> (top-level stage seconds, substage
    seconds): substages are the names with a '/' (TPUBODY_DETAIL=1)."""
    top, sub = {}, {}
    for r in timer.records:
        d = sub if "/" in r["stage"] else top
        d[r["stage"]] = d.get(r["stage"], 0.0) + r["seconds"]
    return top, sub


def check_artifacts(out_dir, res, replace_hands, cache, what):
    """The files a reconstruction writes exist and load back."""
    from tpubody_torch.mesh import gltf, meshio, rigging

    pkl = "replace_hands_recover.pkl" if replace_hands else "or_recover.pkl"
    names = ["points.npy", "faces.npy", "J_3d.npy", pkl, "out.ply",
             "out.glb"]
    if cache:
        names += ["smplh_value.npy", "warp_and_filled.npy",
                  "depth_front.npy", "depth_back.npy"]
    missing = [n for n in names if not os.path.exists(
        os.path.join(out_dir, n))]
    if missing:
        raise RuntimeError(f"{what}: missing artefacts {missing}")
    avatar = rigging.load_avatar(os.path.join(out_dir, pkl))
    verts, faces, _ = meshio.read_ply(os.path.join(out_dir, "out.ply"))
    g, _ = gltf.read_glb(os.path.join(out_dir, "out.glb"))
    if (not np.array_equal(avatar.v_template, res.avatar.v_template)
            or not np.array_equal(faces, res.faces)
            or np.abs(verts - res.points[:, :3]).max() > 1e-3
            or len(g["skins"][0]["joints"]) != 24
            or not np.array_equal(np.load(os.path.join(out_dir,
                                                       "points.npy")),
                                  res.points)):
        raise RuntimeError(f"{what}: the artefacts do not load back to the "
                           f"result")


def check_result(res, what, graft=True):
    """A finite avatar with normalised weights; with ``graft`` the hands
    were grafted (the avatar has more vertices than the stitched mesh)."""
    a = res.avatar
    grafted = a.v_template.shape[0] > res.points.shape[0]
    if (not np.isfinite(a.v_template).all() or not np.isfinite(a.joints).all()
            or np.abs(a.weights.sum(axis=1) - 1.0).max() > 1e-6
            or res.points.shape[1] != 30 or grafted != graft):
        raise RuntimeError(f"{what}: bad avatar (grafted {grafted})")
    return dict(stitched_vertices=int(res.points.shape[0]),
                stitched_faces=int(res.faces.shape[0]),
                avatar_vertices=int(a.v_template.shape[0]),
                avatar_faces=int(a.faces.shape[0]))


def phase_reconstruct_whole(dev, workdir):
    """The public reconstruct() at full width with the hand graft, cache
    off (twice) then on; the host half on the card against the CPU on the
    same pulled device outputs, and the whole chain card against CPU, at
    RECON_SMALL."""
    import torch

    from tpubody_torch import native
    from tpubody_torch.pipelines import demo, reconstruct as rec
    from tpubody_torch.utils.cache import StageCache
    from tpubody_torch.utils.profiling import StageTimer

    S = RECON_SIZE
    t0 = time.perf_counter()
    fixture = os.path.join(workdir, "whole_fixture")
    smplh, smpl = demo.make_fixture(fixture, size=S, verts=WHOLE_VERTS,
                                    device=dev)
    front, back, mask, fit = rec.load_test_dir(fixture)
    log(f"  demo.make_fixture at {S}^2, {WHOLE_VERTS} vertices: "
        f"{time.perf_counter() - t0:.2f} s; mask {(mask > 0).mean() * 100:.2f}"
        f"% of the frame")

    runs, meshes = [], []
    for i, (cache, detail) in enumerate(((False, False), (False, True),
                                         (True, True))):
        out_dir = os.path.join(workdir, f"whole_{i}")
        timer = StageTimer()
        if detail:
            os.environ["TPUBODY_DETAIL"] = "1"
        try:
            native.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = rec.reconstruct(front, back, mask, fit, smplh, smpl,
                                  out_dir=out_dir, replace_hands=True,
                                  cache=cache, timer=timer, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(native.LAUNCHES)
        finally:
            os.environ.pop("TPUBODY_DETAIL", None)
        what = f"reconstruct {S}^2 cache {'on' if cache else 'off'} #{i}"
        counts = check_result(res, what)
        check_artifacts(out_dir, res, True, cache, what)
        want = {k: (3 if k == "fused_raster" else 0) for k in launches}
        if launches != want:
            raise RuntimeError(f"{what}: launches {launches}, expected "
                               f"{want}")
        top, sub = stage_split(timer)
        meshes.append(res)
        runs.append(dict(cache=cache, detail=detail, wall_s=wall,
                         stage_s=top, substage_s=sub, launches=launches,
                         **counts))
        log(f"  {what}: {wall:.3f} s; launches {launches}; {counts}")
        log("    stages, s: " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in top.items()))
        if sub:
            log("    substages, s: " + ", ".join(f"{k} {v:.4f}"
                                                 for k, v in sub.items()))
    # The same inputs twice with the cache off: the card's chain is
    # deterministic.
    a, b = meshes[0], meshes[1]
    same = a.points.shape == b.points.shape and bool(
        np.array_equal(a.points, b.points)) and np.array_equal(
            a.avatar.v_template, b.avatar.v_template)
    log(f"  cache-off runs #0 and #1: stitched points and avatar "
        f"{'equal' if same else 'differ'}"
        + ("" if same or a.points.shape != b.points.shape else
           f" (max|d| {np.abs(a.points - b.points).max(axis=0)[:3]})")
        + f"; avatars of {a.avatar.v_template.shape[0]} and "
        f"{b.avatar.v_template.shape[0]} vertices")
    if not same:
        raise RuntimeError("two cache-off reconstructions differ")
    warm = runs[1]["stage_s"]
    total = sum(warm.values())
    log("  warm run, shares: " + ", ".join(
        f"{k} {v / total * 100:.1f}%" for k, v in warm.items()))

    # The host half on the same pulled device outputs, card and CPU.
    small = os.path.join(workdir, "small_fixture")
    smplh_s, smpl_s = demo.make_fixture(small, size=RECON_SMALL,
                                        verts=WHOLE_VERTS, device=dev)
    front_s, back_s, mask_s, fit_s = rec.load_test_dir(small)
    sc = StageCache(os.path.join(workdir, "small_cache"), enabled=False)
    pulled = rec._device_stages(mask_s, fit_s, smplh_s, smpl_s, sc,
                                StageTimer(), None)
    host = {}
    for name, model in (("card", smpl_s), ("cpu", smpl_s.to("cpu"))):
        host[name] = rec._host_stages(front_s, back_s, fit_s, model, *pulled,
                                      sc, False, True, StageTimer(), None)
    g, c = host["card"], host["cpu"]
    graft = g.avatar.v_template.shape[0] > g.points.shape[0]
    check_result(g, f"host half on the card at {RECON_SMALL}^2", graft)
    check_result(c, f"host half on the CPU at {RECON_SMALL}^2", graft)
    same_mesh = (np.array_equal(g.points, c.points)
                 and np.array_equal(g.faces, c.faces)
                 and np.array_equal(g.joints3d, c.joints3d))
    host_diff = {}
    if g.avatar.v_template.shape == c.avatar.v_template.shape:
        host_diff = {k: float(np.abs(getattr(g.avatar, k)
                                     - getattr(c.avatar, k)).max())
                     for k in ("v_template", "joints", "weights", "or_pose")}
    log(f"  host half at {RECON_SMALL}^2 on the card's pulled outputs, card "
        f"vs CPU: stitched mesh and joints {'equal' if same_mesh else 'DIFFER'}"
        f"; hands grafted {graft}; avatar max|d| {host_diff}")
    if (not same_mesh or not host_diff
            or max(host_diff.values()) > HOST_AVATAR_ATOL
            or not np.array_equal(g.avatar.faces, c.avatar.faces)):
        raise RuntimeError("the host half on the card disagrees with the "
                           "CPU on the same inputs")

    # The whole chain, card against CPU.
    chain = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        chain[name] = rec.reconstruct(front_s, back_s, mask_s, fit_s,
                                      smplh_s, smpl_s, replace_hands=True,
                                      cache=False, device=d)
    g, c = chain["card"], chain["cpu"]
    for name, r in chain.items():
        check_result(r, f"reconstruct {RECON_SMALL}^2 on the {name}",
                     r.avatar.v_template.shape[0] > r.points.shape[0])
    same_count = g.points.shape == c.points.shape and \
        np.array_equal(g.faces, c.faces)
    log(f"  whole chain at {RECON_SMALL}^2, card vs CPU: stitched "
        f"{g.points.shape[0]} vs {c.points.shape[0]} vertices, faces "
        f"{'equal' if same_count else 'differ'}")
    whole_diff = {}
    if same_count:
        rng = float(np.ptp(c.points[:, 2]))
        dp = np.abs(g.points[:, :3] - c.points[:, :3]).max(axis=1)
        whole_diff = dict(
            position_max=float(dp.max()), position_mean=float(dp.mean()),
            range=rng, tight_share=float((dp <= DEPTH_REL * rng).mean()),
            joints3d=float(np.abs(g.joints3d - c.joints3d).max()))
        extent = float(np.ptp(c.avatar.v_template, axis=0).max())
        whole_diff["avatar_joints"] = float(
            np.abs(g.avatar.joints - c.avatar.joints).max())
        whole_diff["avatar_extent"] = extent
        log(f"    {whole_diff}")
        if (whole_diff["tight_share"] < TIGHT_SHARE
                or whole_diff["position_mean"] > CHAIN_MEAN_REL * rng
                or whole_diff["joints3d"] > CHAIN_MEAN_REL * rng
                or whole_diff["avatar_joints"] > CHAIN_MEAN_REL * extent):
            raise RuntimeError("the whole chain on the card disagrees with "
                               "the CPU")
    elif abs(g.points.shape[0] - c.points.shape[0]) \
            > SHAPE_SHARE * c.points.shape[0]:
        raise RuntimeError("the card's stitched mesh differs in size from "
                           "the CPU's")
    return dict(size=S, verts=WHOLE_VERTS, runs=runs,
                cache_off_runs_equal=same,
                host_half_card_vs_cpu=host_diff,
                whole_chain_card_vs_cpu=whole_diff,
                launches=runs[0]["launches"]), a.avatar


def phase_demo(dev, workdir):
    """run_demo at DEMO_SIZE with an 8-frame animation, through the
    fused_raster kernel on both of its paths."""
    import torch

    from tpubody_torch import native
    from tpubody_torch.mesh import gltf, meshio, rigging
    from tpubody_torch.pipelines import demo

    out = os.path.join(workdir, "demo")
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    arts = demo.run_demo(out, size=DEMO_SIZE, animate_frames=DEMO_FRAMES,
                         device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    names = ("front_rgb.png", "back_rgb.png", "mask.png", "0_keypoints.json",
             "smplh.pkl", "conf.yaml", "replace_hands_recover.pkl",
             "out.ply", "demo.mp4", "avatar.glb")
    missing = [n for n in names if not os.path.exists(arts.get(n, ""))]
    if missing:
        raise RuntimeError(f"run_demo: missing {missing}")
    mp4 = os.path.getsize(arts["demo.mp4"])
    avatar = rigging.load_avatar(arts["replace_hands_recover.pkl"])
    verts, _, _ = meshio.read_ply(arts["out.ply"])
    g, _ = gltf.read_glb(arts["avatar.glb"])
    grafted = avatar.v_template.shape[0] > verts.shape[0]
    # 3 body-map passes, then a base pass and its ladder rungs (as many as
    # the avatar's face sizes ask for) a block of 8 frames of video
    blocks = -(-DEMO_FRAMES // 8)
    others = {k: v for k, v in launches.items() if k != "fused_raster"}
    log(f"  run_demo at {DEMO_SIZE}^2, {DEMO_FRAMES} frames: {wall:.3f} s; "
        f"launches {launches}; demo.mp4 {mp4} bytes; avatar "
        f"{avatar.v_template.shape[0]} vertices (stitched {verts.shape[0]}), "
        f"hands grafted {grafted}; GLB {len(g['nodes'])} nodes")
    if (launches["fused_raster"] < 3 + blocks or any(others.values())
            or mp4 <= 0 or not grafted or len(g["skins"][0]["joints"]) != 24):
        raise RuntimeError(f"run_demo: launches {launches} (expected "
                           f"fused_raster at least {3 + blocks}, no other), "
                           f"mp4 {mp4} bytes, grafted {grafted}")
    return dict(wall_s=wall, launches=launches, mp4_bytes=mp4,
                avatar_vertices=int(avatar.v_template.shape[0]))


# -- the fused residual stage ------------------------------------------------
def seeded_chain(c_in, feats, n, seed, full_width, c_out=None):
    """n stride-1 Bottlenecks of the port on the CPU in float32, of
    ``c_out`` output channels (4 * feats where None).  Small chains draw
    every weight and BatchNorm statistic uniformly from [0.05, 0.4]
    (tests/test_pallas_resnet.py); full-width ones take the model's seeded
    initialisation and seeded BatchNorm statistics."""
    import torch

    from tpubody_torch import bench
    from tpubody_torch.models import hmr

    mods = []
    for _ in range(n):
        blk = hmr.Bottleneck(c_in, feats, 1)
        if c_out is not None and c_out != feats * 4:
            blk.conv3 = torch.nn.Conv2d(feats, c_out, 1, bias=False)
            blk.bn3 = torch.nn.BatchNorm2d(c_out)
            blk.downsample = None if c_in == c_out else torch.nn.Sequential(
                torch.nn.Conv2d(c_in, c_out, 1, bias=False),
                torch.nn.BatchNorm2d(c_out))
        mods.append(blk)
        c_in = feats * 4 if c_out is None else c_out
    chain = torch.nn.Sequential(*mods).eval()
    if full_width:
        hmr.init_weights(chain, seed)
        bench.randomize_batchnorm(chain, seed)
    else:
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for t in chain.state_dict().values():
                if t.dtype.is_floating_point:
                    t.copy_(torch.as_tensor(
                        rng.uniform(0.05, 0.4, tuple(t.shape)), dtype=t.dtype))
    return chain


def ulps2(scale):
    """Two bf16 ulps at the binade of `scale`."""
    return 2.0 * 2.0 ** (np.floor(np.log2(scale)) - 7)


def plain_f32_sums(x_nhwc, stage):
    """The plain version's arithmetic with float32 sums (the library's fp32
    convolutions) instead of float64 ones: printed for scale only."""
    import torch
    import torch.nn.functional as F

    def conv(h, A, b, taps=1):
        w = A.float()
        w = (w[:, :, None, None] if taps == 1 else
             w.reshape(A.shape[0], 3, 3, A.shape[0]).permute(0, 3, 1, 2))
        return F.conv2d(h, w, padding=taps // 2) + b.reshape(1, -1, 1, 1)

    def rounded(v):
        return v.to(torch.bfloat16).float()

    y = x_nhwc.to(torch.bfloat16).permute(0, 3, 1, 2).float()
    for A1, b1, A2, b2, A3, b3, Ad, bd in stage.blocks():
        res = y if Ad is None else conv(y, Ad, bd)
        h1 = rounded(torch.relu(conv(y, A1, b1)))
        h2 = rounded(torch.relu(conv(h1, A2, b2, taps=3)))
        y = rounded(torch.relu(conv(h2, A3, b3) + res))
    return y.permute(0, 2, 3, 1)


def block_by_block(x_nhwc, fused, fp32_share=False):
    """Each block alone, on the plain version's input to it: what one launch
    computes, held to what the plain version computes from the same bits.
    -> (largest difference in units of 2 ulps of that block's largest
    output, smallest share of elements equal bit for bit); with
    ``fp32_share`` also, for scale, the smallest share of a block's
    elements on which :func:`plain_f32_sums` equals the plain version
    (float64 sums, each rounded once)."""
    import torch

    from tpubody_torch.models import fused_resnet as FR

    h, worst_err, worst_equal = x_nhwc.to(torch.bfloat16), 0.0, 1.0
    share32 = 1.0
    for blk in fused.blocks():
        one = FR.FusedStage(*blk, *[getattr(fused, f)
                                    for f in FR.FIELDS[8:]], n_rest=0)
        a = FR.run_stage(h, one).float()
        if fp32_share:
            f32 = plain_f32_sums(h, one)
        h = FR.run_stage_reference(h, one)
        d = (a - h.float()).abs()
        worst_err = max(worst_err, d.max().item()
                        / ulps2(h.float().abs().max().item()))
        worst_equal = min(worst_equal, (d == 0).float().mean().item())
        if fp32_share:
            share32 = min(share32, (f32 == h.float()).float().mean().item())
    if fp32_share:
        return worst_err, worst_equal, share32
    return worst_err, worst_equal


def phase_stage(dev):
    import torch

    from tpubody_torch import native
    from tpubody_torch.models import fused_resnet as FR

    # name, (B, H, W, C_in), features, blocks, x seed, weight seed, kind,
    # output channels (4 x features where None).  "full": full width at
    # batch 8; "tail": ResNet-50's stage 3 and 4 tails (C_mid 256, 512: the
    # wide route) at batch 512, held to the plain version block
    # by block at that batch.
    cases = [
        ("3 blocks, downsample 12x12", (2, 12, 12, 8), 4, 3, 1, 0, "small",
         None),
        ("2 blocks, identity 8x8", (2, 8, 8, 16), 4, 2, 2, 0, "small", None),
        ("single block 10x10", (1, 10, 10, 8), 4, 1, 3, 0, "small", None),
        ("2 blocks, ragged 11x19", (2, 11, 19, 8), 4, 2, 4, 0, "small", None),
        ("zero input 9x9", (1, 9, 9, 8), 4, 2, None, 5, "small", None),
        ("2 blocks, 20 -> 10 -> 20, 9x11", (2, 9, 11, 20), 10, 2, 10, 11,
         "small", 20),
        ("stage 1 full width", (8, 56, 56, 64), 64, 3, 6, 7, "full", None),
        ("stage 2 tail full width", (8, 28, 28, 512), 128, 3, 8, 9, "full",
         None),
        (f"stage 3 tail, batch {TAIL_BATCH}", (TAIL_BATCH, 14, 14, 1024), 256,
         5, 12, 13, "tail", None),
        (f"stage 4 tail, batch {TAIL_BATCH}", (TAIL_BATCH, 7, 7, 2048), 512,
         2, 14, 15, "tail", None),
    ]
    lib = native.library()
    for name, shape, feats, n, xseed, wseed, kind, c_out in cases:
        chain = seeded_chain(shape[-1], feats, n, wseed, kind != "small",
                             c_out)
        fused = FR.fuse_stage(chain, list(range(n))).to(dev)
        x = np.zeros(shape, np.float32) if xseed is None else \
            np.random.default_rng(xseed).normal(size=shape).astype(np.float32)
        xd = torch.as_tensor(x, device=dev)
        before = native.LAUNCHES["fused_stage"]
        got = FR.run_stage(xd, fused)
        torch.cuda.synchronize()
        launches = sum(lib.tpubody_fused_stage_launches(
            shape[2], blk["c_mid"], int(blk["wd"] is not None))
            for blk in fused.packed)
        if native.LAUNCHES["fused_stage"] != before + launches:
            raise RuntimeError(f"{name}: run_stage did not launch {launches} "
                               f"times")
        want = FR.run_stage_reference(xd, fused)
        c_out = c_out or feats * 4
        if got.shape != shape[:3] + (c_out,) or got.dtype != torch.bfloat16:
            raise RuntimeError(f"{name}: {tuple(got.shape)} {got.dtype}")
        g, w = got.float(), want.float()
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        equal = (g == w).float().mean().item()
        with torch.no_grad():
            f32 = chain.to(dev)(xd.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        rel32 = (g - f32).abs().max().item() / f32.abs().max().item()
        full = kind != "small"
        worst_err, worst_equal, *share32 = block_by_block(xd, fused, full)
        ok = (bool(torch.isfinite(g).all()) and scale > 0
              and worst_err <= 1.0 and worst_equal >= STAGE_EQUAL
              and err <= (STAGE_CHAIN_ULPS / 2 if full else 1) * ulps2(scale)
              and (full or equal >= STAGE_EQUAL)
              and rel32 < STAGE_LIB_REL)
        log(f"  {name:28s} {str(shape):18s} block by block: max|d| "
            f"{2 * worst_err:.1f} ulp, equal bits {worst_equal * 100:.4f}%;"
            f" chain: max|d|={err:.3e} of max {scale:.3e}"
            f" ({2 * err / ulps2(scale):.1f} ulp), equal bits"
            f" {equal * 100:.4f}%; vs the f32 chain rel {rel32:.2e}"
            f" {'ok' if ok else 'FAIL'}")
        if full:
            log(f"    for scale: the plain version with float32 sums (the "
                f"library's fp32 convolutions) equals it (float64 sums) on "
                f"{share32[0] * 100:.4f}% of a block's elements at least")
        if kind == "full":
            cpu = FR.run_stage_reference(xd.cpu(), fused.to("cpu")).float()
            log(f"    for scale: the plain version on the card vs on the CPU "
                f"(two sum orders), chain: equal bits "
                f"{(w.cpu() == cpu).float().mean().item() * 100:.4f}%, "
                f"max|d|={(w.cpu() - cpu).abs().max().item():.3e}")
        if not ok:
            raise RuntimeError(f"fused_stage disagrees with its plain "
                               f"version: {name}")


def hold_to_plain(x_nhwc, y, fused, name):
    """run_stage's output y on the whole batch x, held to the plain version,
    which takes the batch STAGE_CHUNK images at a time (it keeps a dozen
    float32 copies of what it is given).  Every chunk is compared with its
    rows of y, and the first also block by block.  -> max |kernel - plain|,
    the plain version's ms for the whole batch (CUDA events around each
    call, summed), the smallest share of equal elements of a chunk."""
    import torch

    from tpubody_torch.models import fused_resnet as FR

    B = x_nhwc.shape[0]
    FR.run_stage_reference(x_nhwc[:STAGE_CHUNK], fused)      # warm-up
    events, err, scale, equal = [], 0.0, 0.0, 1.0
    for i in range(0, B, STAGE_CHUNK):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = FR.run_stage_reference(x_nhwc[i:i + STAGE_CHUNK], fused)
        end.record()
        events.append((start, end))
        g, w = y[i:i + STAGE_CHUNK].float(), want.float()
        err = max(err, (g - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
        equal = min(equal, (g == w).float().mean().item())
    torch.cuda.synchronize()
    plain_ms = sum(a.elapsed_time(b) for a, b in events)
    blk_err, blk_equal, share32 = block_by_block(x_nhwc[:STAGE_CHUNK], fused,
                                                 True)
    ok = (scale > 0 and blk_err <= 1.0 and blk_equal >= STAGE_EQUAL
          and err <= STAGE_CHAIN_ULPS / 2 * ulps2(scale))
    log(f"  {name} vs the plain version, {B // STAGE_CHUNK} chunks of "
        f"{STAGE_CHUNK}: chain max|d|={err:.3e} of max {scale:.3e} "
        f"({2 * err / ulps2(scale):.1f} ulp), smallest share of equal bits "
        f"{equal * 100:.4f}%; first chunk block by block: max|d| "
        f"{2 * blk_err:.1f} ulp, equal bits {blk_equal * 100:.4f}% (for "
        f"scale, float32 sums: {share32 * 100:.4f}%); plain "
        f"{plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"fused_stage disagrees with its plain version "
                           f"on the model: {name}")
    return err, plain_ms, equal


def phase_backbone(dev):
    """The fused stage on the serving model's activations and weights at
    batch 512 and its times beside the library's -> the kernel line's
    entry."""
    import torch

    from tpubody_torch import bench, native
    from tpubody_torch.models import fused_resnet as FR
    from tpubody_torch.models import hmr

    B = BACKBONE_BATCH
    rng = np.random.default_rng(11)
    images = torch.as_tensor(
        rng.normal(size=(B, 224, 224, 3)).astype(np.float32), device=dev)
    model = hmr.create_hmr(dtype=torch.bfloat16, device=dev)
    bench.randomize_batchnorm(model.backbone, seed=12)
    bb = model.backbone

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    def rel(got, ref):
        return ((got.float() - ref.float()).abs().max()
                / ref.float().abs().max()).item()

    with torch.inference_mode():
        x1 = bb.stem(images)                      # (512, 64, 56, 56)
        fused = {1: FR.fuse_stage(bb.layer1, [0, 1, 2]).to(dev),
                 2: FR.fuse_stage(bb.layer2, [1, 2, 3]).to(dev),
                 3: FR.fuse_stage(bb.layer3, [1, 2, 3, 4, 5]).to(dev),
                 4: FR.fuse_stage(bb.layer4, [1, 2]).to(dev)}
        # the library's head of each stage, then its stride-1 chain
        head = {1: None, 2: bb.layer2[0], 3: bb.layer3[0], 4: bb.layer4[0]}
        chain = {1: bb.layer1, 2: bb.layer2[1:], 3: bb.layer3[1:],
                 4: bb.layer4[1:]}
        native.reset_launches()
        xs, ys, refs, x = {}, {}, {}, x1
        for s in (1, 2, 3, 4):
            xs[s] = x if head[s] is None else head[s](x)
            ys[s] = FR.run_stage(nhwc(xs[s]), fused[s])
            refs[s] = x = chain[s](xs[s])
        torch.cuda.synchronize()
        launches = dict(native.LAUNCHES)
        rels = {s: rel(ys[s], nhwc(refs[s])) for s in ys}
        shapes = tuple(tuple(ys[s].shape) for s in ys)
        finite = all(bool(torch.isfinite(y.float()).all())
                     for y in ys.values())
        want = 3 + 3 + 5 + 2 * 2      # stage 4: two launches a bottleneck
        log(f"  run_stage on the model at batch {B}: layer1, layer2[1:], "
            f"layer3[1:], layer4[1:] {shapes} vs the library rel "
            + ", ".join(f"{rels[s]:.3e}" for s in rels)
            + f"; launches {launches}")
        if shapes != ((B, 56, 56, 256), (B, 28, 28, 512), (B, 14, 14, 1024),
                      (B, 7, 7, 2048)) or not finite:
            raise RuntimeError(f"bad outputs {shapes}, finite {finite}")
        if max(rels.values()) >= STAGE_LIB_REL:
            raise RuntimeError("the fused stage disagrees with the library's "
                               "bf16 chain")
        if launches["fused_stage"] != want:
            raise RuntimeError(f"fused_stage launched "
                               f"{launches['fused_stage']} times, expected "
                               f"{want}")
        del refs
        # the same outputs against the plain version, on the same inputs
        # and weights, at the same batch
        names = {1: "layer1", 2: "layer2[1:]", 3: "layer3[1:]",
                 4: "layer4[1:]"}
        plain = {s: hold_to_plain(nhwc(xs[s]), ys[s], fused[s], names[s])
                 for s in ys}
        del ys
        # the kernel on the model's own activations; stages 3 and 4 in
        # turns with the library's chain (kernel, library, library, kernel)
        path_ms, model_library_ms, run_launches = {}, {}, {}
        for s in (1, 2, 3, 4):
            def kernel():
                return FR.run_stage(nhwc(xs[s]), fused[s])

            def library():
                return chain[s](xs[s])

            if s <= 2:
                path_ms[s] = time_ms(kernel, 10, 2)
                continue
            before = native.LAUNCHES["fused_stage"]
            kernel()
            run_launches[s] = native.LAUNCHES["fused_stage"] - before
            k1, l1 = time_ms(kernel, 10, 2), time_ms(library, 10, 2)
            l2, k2 = time_ms(library, 10, 2), time_ms(kernel, 10, 2)
            path_ms[s], model_library_ms[s] = (k1 + k2) / 2, (l1 + l2) / 2
            log(f"  {names[s]} on the model's activations, in turns: kernel "
                f"{k1:.3f} / {k2:.3f} ms, library {l1:.3f} / {l2:.3f} ms")
        del xs, x1

    stages = {}
    for s in (3, 4):
        H = W = {3: 14, 4: 7}[s]
        work = bench.stage_work(fused[s], B, H, W)
        bytes_ms = work["bytes"] / PEAK_BYTES * 1e3
        ops_ms = work["flop"] / PEAK_BF16 * 1e3
        stages[str(s)] = dict(
            shape=[H, W, int(fused[s].A1_0.shape[1]),
                   int(fused[s].A3_0.shape[0])],
            batch=B, blocks=fused[s].n_rest + 1, on="the serving model",
            launches_per_run=run_launches[s],
            parity_rel_err=rels[s], ms=path_ms[s],
            library_ms=model_library_ms[s],
            library_ratio=path_ms[s] / model_library_ms[s],
            max_abs_err=plain[s][0], plain_ms=plain[s][1],
            plain_equal_share=plain[s][2], flop=work["flop"],
            bytes=work["bytes"], bytes_ms=bytes_ms, ops_ms=ops_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            tflops=work["flop"] / path_ms[s] * 1e-9)
        log(f"  stage {s}: {stages[str(s)]}")
    for s in (1, 2):
        res = bench.fused_stage(s, batch=B, iters=20, device=dev)
        bytes_ms = res["bytes"] / PEAK_BYTES * 1e3
        ops_ms = res["flop"] / PEAK_BF16 * 1e3
        if res["parity_rel_err"] >= STAGE_LIB_REL:
            raise RuntimeError(f"bench.fused_stage({s}): parity "
                               f"{res['parity_rel_err']}")
        stages[str(s)] = dict(
            shape=res["shape"], batch=B, blocks=res["blocks"],
            launches_per_run=res["launches_per_run"],
            parity_rel_err=res["parity_rel_err"],
            ms=res["fused_ms"], ms_on_model=path_ms[s],
            library_ratio=res["fused_ms"] / res["library_ms"],
            library_ms=res["library_ms"],
            max_abs_err=plain[s][0], plain_ms=plain[s][1],
            plain_equal_share=plain[s][2],
            flop=res["flop"], bytes=res["bytes"], bytes_ms=bytes_ms,
            ops_ms=ops_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            tflops=res["flop"] / res["fused_ms"] * 1e-9)
        log(f"  stage {s}: {stages[str(s)]}")
    stages = {k: stages[k] for k in sorted(stages)}

    # the space-to-depth stem against the direct one, same state dict
    m7 = hmr.create_hmr(dtype=torch.float32, device=dev, seed=3)
    ms2d = hmr.create_hmr(dtype=torch.float32, device=dev, seed=3, stem="s2d")
    ms2d.load_state_dict(m7.state_dict())
    with torch.inference_mode():
        a, b = m7(images[:8]), ms2d(images[:8])
        stem_err = max((p - q).abs().max().item() for p, q in zip(a, b))
        feat_err = (m7.backbone.stem(images[:8])
                    - ms2d.backbone.stem(images[:8])).abs().max().item()
        s2d16 = hmr.create_hmr(dtype=torch.bfloat16, device=dev, stem="s2d")
        stem_ms = {
            "conv7": time_ms(lambda: bb.stem(images), 10, 2),
            "s2d": time_ms(lambda: s2d16.backbone.stem(images), 10, 2)}
    log(f"  s2d vs conv7 stem, fp32, 8 images: HMR outputs max|d|="
        f"{stem_err:.3e}, stem features max|d|={feat_err:.3e}; bf16 stem at "
        f"batch {B}: conv7 {stem_ms['conv7']:.3f} ms, s2d "
        f"{stem_ms['s2d']:.3f} ms")
    if stem_err > STEM_ATOL or feat_err > STEM_ATOL:
        raise RuntimeError("the s2d stem disagrees with conv7")
    log(json.dumps({"backbone": {
        "batch": B, "stem_ms": stem_ms,
        "fused_vs_library_rel": list(rels.values()), "stages": stages}}))

    main = stages["1"]
    return {
        "name": "fused_stage",
        "route": "cuda",
        "source": "tpubody_torch/csrc/fused_stage.cu",
        "replaces": "tpubody/models/pallas_resnet.py:167",
        "replaces_fn": "tpubody/models/pallas_resnet.py::_stage_kernel",
        "shape": {"B": B, "H": 56, "W": 56, "C_in": 64, "C_mid": 64,
                  "C_out": 256, "blocks": 3,
                  "stage": "1 (stage 2's, 3's and 4's tails under stages)"},
        "launches": launches["fused_stage"],
        "max_abs_err": main["max_abs_err"],
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "stages": stages,
    }


# -- the fitting path (phases 15-17) ----------------------------------------
def fit_setup(dev):
    from tpubody_torch import bench
    from tpubody_torch.fit import vposer as vposer_lib

    model = bench.fit_model(6890, seed=0, device=dev)
    decoder = vposer_lib.create_decoder(0, device=dev)
    return model, decoder


def hold_fits(a, b, what, rtol=FIT_RTOL, atol=FIT_ATOL):
    """Two FitBatchOutputs under the whole-fit bar -> the max differences."""
    d = {"loss_rel": float(np.max(np.abs(a.loss - b.loss)
                                  / np.maximum(np.abs(b.loss), 1e-9)))}
    for f in ("pose", "shape", "camera_translation"):
        d[f] = float(np.abs(getattr(a, f) - getattr(b, f)).max())
    log(f"  {what}: {d}")
    if d["loss_rel"] > rtol or max(d[f] for f in
                                   ("pose", "shape",
                                    "camera_translation")) > atol:
        raise RuntimeError(f"{what}: outside the whole-fit bar "
                           f"(rtol {rtol}, atol {atol}): {d}")
    return d


def fit_objective_diff(model, decoder, cpu_model, cpu_decoder, kps,
                       center):
    """The staged objective's value and gradient at the same seeded lane
    parameters on the card and on the CPU, every stage's weights ->
    {"value_rel", "grad_rel"} (gradient error over the largest |g|)."""
    import torch

    from tpubody_torch.fit import smplify

    cfg = smplify.FitConfig()
    n = kps.shape[0]
    rng = np.random.default_rng(41)
    base = {"global_orient": rng.normal(scale=0.2, size=(n, 3)),
            "betas": rng.normal(scale=0.5, size=(n, 10)),
            "cam_t": np.array([[0.0, 0.0, 12.0]] * n)
            + rng.normal(scale=0.05, size=(n, 3)),
            "lhand": rng.normal(scale=0.5, size=(n, cfg.num_pca_comps)),
            "rhand": rng.normal(scale=0.5, size=(n, cfg.num_pca_comps)),
            "pose_embedding": rng.normal(scale=0.5, size=(n, 32))}
    out = []
    for m, d, dev in ((model, decoder, model.device),
                      (cpu_model, cpu_decoder, torch.device("cpu"))):
        f = smplify.BatchFitter(m, cfg, dec_params=d, device=dev)
        k = torch.as_tensor(kps, device=dev)
        c = torch.as_tensor(np.tile(center, (n, 1)), device=dev)
        res = []
        for w in f.ws:
            p = {key: torch.tensor(v, dtype=torch.float32, device=dev,
                                   requires_grad=True)
                 for key, v in base.items()}
            v = f.shared_loss(p, w, k[..., :2], k[..., 2], c)
            g = torch.autograd.grad(v.sum(), list(p.values()))
            res.append((v.detach().cpu().numpy(),
                        np.concatenate([x.cpu().numpy().reshape(n, -1)
                                        for x in g], axis=1)))
        out.append(res)
    value_rel = max(float(np.max(np.abs(a[0] - b[0]) / np.abs(b[0])))
                    for a, b in zip(*out))
    grad_rel = max(float(np.abs(a[1] - b[1]).max() / np.abs(b[1]).max())
                   for a, b in zip(*out))
    return {"value_rel": value_rel, "grad_rel": grad_rel}


def phase_fit(dev, model, decoder, workdir):
    import torch

    from tpubody_torch import bench, native
    from tpubody_torch.fit import keypoints as kp_lib
    from tpubody_torch.fit import smplify
    from tpubody_torch.pipelines import gen_smplh
    from tpubody_torch.pipelines import reconstruct as rec

    truth = bench.fit_truth(model, decoder, FIT_N, seed=11)
    target = bench.project_fit(model, **truth)
    kps = bench.fit_keypoints(target, seed=11)
    center = np.full(2, bench.FIT_SIZE / 2.0, np.float32)
    cfg = smplify.FitConfig()

    native.reset_launches()
    t0 = time.perf_counter()
    fitter = smplify.BatchFitter(model, cfg, dec_params=decoder, device=dev)
    out = fitter(kps, center)
    torch.cuda.synchronize()
    fit_ms = 1e3 * (time.perf_counter() - t0)
    launches = dict(native.LAUNCHES)
    log(f"  kernel launches on the fit path: {launches}")
    if any(launches.values()):
        raise RuntimeError(f"the fit path launched a kernel: {launches}")
    if not np.isfinite(out.loss).all():
        raise RuntimeError("non-finite fit losses")
    zero = dict(pose=np.zeros_like(truth["pose"]),
                betas=np.zeros_like(truth["betas"]), cam_t=truth["cam_t"])
    base = np.linalg.norm(bench.project_fit(model, **zero) - target,
                          axis=-1).mean()
    fitted = np.linalg.norm(bench.project_fit(
        model, out.pose, out.shape, out.camera_translation) - target,
        axis=-1).mean()
    log(f"  {FIT_N} frames: mean reprojection error {fitted:.3f} px after "
        f"the fit, {base:.3f} px for the zero pose ({fitted / base:.4f}x); "
        f"mean loss {float(np.mean(out.loss)):.2f}; {fit_ms:.0f} ms "
        f"({fit_ms / FIT_N:.1f} ms/frame, the first fit); counts "
        f"{fitter.stats}")
    if not fitted < FIT_REPROJ * base:
        raise RuntimeError(f"fit reprojection {fitted} >= {FIT_REPROJ} x "
                           f"{base}")

    # Card vs CPU, TF32 off (main sets it): the objective and its gradient
    # at the same seeded parameters, then whole fits of a few frames at
    # budgets of 1-3 iterations a stage.  fp32 L-BFGS with a line search
    # amplifies rounding: the fits are held to the whole-fit bar up to
    # FIT_CPU_ITERS, where they have not parted yet; the 3-iteration
    # difference is printed (ROADMAP Queue 3, "Sensitivities").
    cpu_model = model.to("cpu")
    cpu_decoder = copy.deepcopy(decoder).to("cpu")
    obj = fit_objective_diff(model, decoder, cpu_model, cpu_decoder,
                             kps[:FIT_CPU_N], center)
    log(f"  card vs CPU objective at seeded parameters, 5 stages: {obj}")
    if obj["value_rel"] > FIT_OBJ_RTOL or obj["grad_rel"] > FIT_GRAD_REL:
        raise RuntimeError(f"card vs CPU objective: {obj}")
    cpu_diff = {}
    for iters in (1, 2, 3):
        cfgk = smplify.FitConfig(maxiters=iters)
        gpu = smplify.BatchFitter(model, cfgk, dec_params=decoder,
                                  device=dev)(kps[:FIT_CPU_N], center)
        cpu = smplify.BatchFitter(cpu_model, cfgk, dec_params=cpu_decoder,
                                  device="cpu")(kps[:FIT_CPU_N], center)
        what = f"card vs CPU, {FIT_CPU_N} frames at maxiters={iters}"
        if iters <= FIT_CPU_ITERS:
            cpu_diff[iters] = hold_fits(gpu, cpu, what)
        else:
            cpu_diff[iters] = hold_fits(gpu, cpu, what + " (printed only)",
                                        rtol=np.inf, atol=np.inf)

    seq = {}
    clip = bench.fit_clip(model, decoder, FIT_CLIP, seed=5)
    for block in (1, 8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        so = smplify.fit_sequence(model, clip, center, cfg,
                                  dec_params=decoder, block=block,
                                  device=dev)
        ms = 1e3 * (time.perf_counter() - t0)
        if so.pose.shape != (FIT_CLIP, 156) or not np.isfinite(
                so.loss).all():
            raise RuntimeError(f"fit_sequence block {block}: "
                               f"{so.pose.shape}, losses {so.loss}")
        seq[block] = {"ms_per_frame": ms / FIT_CLIP,
                      "mean_loss": float(np.mean(so.loss))}
        log(f"  fit_sequence T={FIT_CLIP} block {block}: "
            f"{ms / FIT_CLIP:.1f} ms/frame, mean loss "
            f"{seq[block]['mean_loss']:.2f}")

    import cv2
    gdir = os.path.join(workdir, "gen_smplh")
    os.makedirs(gdir, exist_ok=True)
    img = np.full((bench.FIT_SIZE, bench.FIT_SIZE, 3), 96, np.uint8)
    cv2.imwrite(os.path.join(gdir, "img.png"), img)
    k = kps[0].astype(np.float64)
    kp_lib.write_openpose_json(os.path.join(gdir, "keypoints.json"),
                               k[:25], k[25:46], k[46:67])
    t0 = time.perf_counter()
    fit = gen_smplh.gen_smplh(os.path.join(gdir, "img.png"),
                              os.path.join(gdir, "keypoints.json"),
                              os.path.join(gdir, "out"), model=model,
                              dec_params=decoder, device=dev)
    gen_ms = 1e3 * (time.perf_counter() - t0)
    made = sorted(os.listdir(os.path.join(gdir, "out")))
    want = ["conf.yaml", "pre_smplh.pkl", "smplh.obj", "smplh.pkl",
            "smplh2rgb_rend.png"]
    back = rec.load_fit_pickle(os.path.join(gdir, "out", "smplh.pkl"))
    if made != want or back.pose.shape != (156,) or not np.allclose(
            back.pose, fit.pose):
        raise RuntimeError(f"gen_smplh artifacts {made}, pose "
                           f"{back.pose.shape}")
    log(f"  gen_smplh: {gen_ms:.0f} ms, artifacts {made}")
    return {"launches": launches, "reproj_px": float(fitted),
            "zero_pose_px": float(base), "cpu_diff": cpu_diff,
            "sequence": seq, "gen_smplh_ms": gen_ms}


def phase_fit_serve(dev, model, decoder):
    import torch

    from tpubody_torch import bench
    from tpubody_torch.fit import smplify
    from tpubody_torch.pipelines import serving

    truth = bench.fit_truth(model, decoder, 8, seed=21)
    kps = bench.fit_keypoints(bench.project_fit(model, **truth), seed=21)
    center = np.full(2, bench.FIT_SIZE / 2.0, np.float32)
    step, spec = serving.fit_smplh_step(model, smplify.FitConfig(),
                                        dec_params=decoder, device=dev)
    t0 = time.perf_counter()
    server = serving.InferenceServer(step, buckets=(4,), request_spec=spec,
                                     max_delay_ms=200.0, device=dev)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    with server:
        futs = [server.submit({"keypoints": kps[i], "center": center})
                for i in range(8)]
        served = [f.result(timeout=600) for f in futs]
    stats = server.stats.snapshot()
    worst = 0.0
    for g in range(2):
        direct = step(
            {"keypoints": torch.as_tensor(kps[4 * g:4 * g + 4], device=dev),
             "center": torch.as_tensor(np.tile(center, (4, 1)),
                                       device=dev)})
        for i in range(4):
            for key in ("pose", "shape", "cam_t", "loss"):
                d = float(np.abs(served[4 * g + i][key]
                                 - direct[key][i].cpu().numpy()).max())
                worst = max(worst, d)
    log(f"  8 requests in batches of 4: served vs direct max |d| {worst:.3g};"
        f" warm-up {warm_ms:.0f} ms; latency p50 "
        f"{stats['latency_p50_ms']:.0f} ms, p99 "
        f"{stats['latency_p99_ms']:.0f} ms; {stats['batches']} batches")
    if worst > FIT_SERVE_ATOL:
        raise RuntimeError(f"served fit differs from the direct one: {worst}")
    return {"latency_p50_ms": stats["latency_p50_ms"],
            "latency_p99_ms": stats["latency_p99_ms"],
            "served_vs_direct": worst, "warmup_ms": warm_ms}


def phase_fit_timing(dev, model, decoder, fit_res):
    from tpubody_torch import bench
    from tpubody_torch.fit import smplify

    res = {}
    for n in (8, FIT_N):
        r = bench.fit(n, model=model, decoder=decoder, device=dev)
        res[n] = r
        log(f"  fit_frames N={n}: first {r['first_ms_per_frame']:.1f} "
            f"ms/frame (setup {r['first_setup_ms']:.1f} ms), warm "
            f"{r['warm_ms_per_frame']:.1f} ms/frame (setup "
            f"{r['warm_setup_ms']:.1f} ms); camera stage "
            f"{r['camera_ms']:.1f} ms, body stages {r['stages_ms']:.1f} ms;"
            f" counts {json.dumps(r['counts'])}")
    if fit_res is not None:
        for block, r in fit_res["sequence"].items():
            log(f"  fit_sequence T={FIT_CLIP} block {block}: "
                f"{r['ms_per_frame']:.1f} ms/frame")
    # The busy share: a warm fit of FIT_N frames at FIT_PROFILE_ITERS
    # iterations a stage (the profiler traces every kernel: the full
    # budget's 2 million take minutes), its device time under the
    # profiler over its wall time without it.
    truth = bench.fit_truth(model, decoder, FIT_N, seed=31)
    kps = bench.fit_keypoints(bench.project_fit(model, **truth), seed=31)
    center = np.full(2, bench.FIT_SIZE / 2.0, np.float32)
    fitter = smplify.BatchFitter(
        model, smplify.FitConfig(maxiters=FIT_PROFILE_ITERS),
        dec_params=decoder, device=dev)
    fitter(kps, center)                    # captures the graphs
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitter(kps, center)
    wall = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    busy, n_kernels, top = device_busy(lambda: fitter(kps, center))
    wall_prof = 1e3 * (time.perf_counter() - t0)
    log(f"  warm N={FIT_N} fit at maxiters={FIT_PROFILE_ITERS}: wall "
        f"{wall:.1f} ms; under torch.profiler device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}% of the unprofiled wall; wall "
        f"{wall_prof:.1f} ms under the profiler), {n_kernels} device "
        f"kernels and copies, {fitter.stats}; top {top}")
    res["busy_share"] = busy / wall
    print(json.dumps({"fit_timing": {str(k): v for k, v in res.items()}}),
          flush=True)
    return res


# -- the training path (phases 20-23) -----------------------------------------

TRAIN_RENDER = 64         # --render examples of train-hmr (phase 20)
TRAIN_STEPS = 20          # train-hmr steps through the CLI
TRAIN_BATCH = 32          # train-hmr's defaults: batch 32 at 224^2, fp32
TRAIN_SIZE = 224
TRAIN_FIXED_STEPS = 30    # steps on one fixed batch that must reduce the loss
TRAIN_CPU_BATCH = 4       # card vs CPU: one step at batch 4, 64^2
TRAIN_CPU_SIZE = 64
# Card vs CPU in float64: train-mode BatchNorm over few values a channel
# makes the step ill-conditioned (fp32 rounding alone moves gradients by
# percent; tests/torch_train_common.py), so the gate runs in float64, where
# the same amplification leaves about 1e-10; fp32 is printed, not gated.
TRAIN_LOSS_REL = 1e-9
TRAIN_GRAD_REL = 1e-6     # per tensor, of its largest |g|
TRAIN_STAT_REL = 1e-9     # BatchNorm running statistics, per tensor
# remat vs none on the card, cuDNN deterministic: the recomputation runs
# the forward's own kernels, so a difference is a fault; the bar leaves
# room for another algorithm choice on the recomputed activations.
REMAT_GRAD_REL = 1e-4
TIMED_STEPS = 10          # CUDA-event timing after 3 warm-up steps
POSE_STEPS = 100          # train-pose2d at its defaults, --domain-rand
POSE_CHUNK = 20
POSE_CPU_BATCH = 4        # card vs CPU synthesizer, the same draws, 128^2
POSE_IMG_ATOL = 1e-4      # image values in [0, 1]; a pixel whose centre is
POSE_IMG_SHARE = 0.01     # within rounding of an edge may take the other
POSE_KP_ATOL = 1e-4       # face: at most 1% beyond the bar; keypoints, px
DETECT_SIZE = 256
ASF_SIZE = 256
ASF_FRAMES = 8
ASF_CAM_Z = 20.0          # frames the 1.7 m humanoid at focal 2500 in 256^2

# The sample skeleton of tpubody's tests/test_asf.py (lfemur, ltibia,
# upperback under the root; CMU names, which ASF_SMPL_MAP sends to SMPL
# joints 1, 4 and 3).
SAMPLE_ASF = """
:version 1.10
:name VICON
:units
  mass 1.0
  length 0.45
  angle deg
:documentation
  test skeleton
:root
  order TX TY TZ RX RY RZ
  axis XYZ
  position 0 0 0
  orientation 0 0 0
:bonedata
  begin
     id 1
     name lfemur
     direction 0.34 -0.93 0
     length 7.0
     axis 0 0 20 XYZ
    dof rx ry rz
    limits (-160.0 20.0)
           (-70.0 70.0)
           (-60.0 70.0)
  end
  begin
     id 2
     name ltibia
     direction 0.34 -0.94 0
     length 7.3
     axis 0 0 20 XYZ
    dof rx
    limits (-10.0 170.0)
  end
  begin
     id 3
     name upperback
     direction 0.0 1.0 0.0
     length 2.0
     axis 0 0 0 XYZ
  end
:hierarchy
  begin
    root lfemur upperback
    lfemur ltibia
  end
"""


def amc_text(frames):
    """An AMC clip over SAMPLE_ASF: a stride of the left leg."""
    lines = ["#!OML:ASF", ":FULLY-SPECIFIED", ":DEGREES"]
    for f in range(frames):
        ph = 2 * np.pi * f / frames
        lines += [str(f + 1),
                  f"root {0.5 * f:.3f} 16.0 -2.0 {4 * np.sin(ph):.3f} "
                  f"-5.0 3.0",
                  f"lfemur {-35 * np.sin(ph):.3f} -8.0 5.0",
                  f"ltibia {40 + 35 * np.cos(ph):.3f}"]
    return "\n".join(lines) + "\n"


class deterministic:
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations (index_add among them) for a comparison that must be
    bit for bit; restored on exit."""

    def __enter__(self):
        import torch
        self.old = (torch.backends.cudnn.deterministic,
                    torch.backends.cudnn.benchmark,
                    torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        return self

    def __exit__(self, *exc):
        import torch
        torch.backends.cudnn.deterministic = self.old[0]
        torch.backends.cudnn.benchmark = self.old[1]
        torch.use_deterministic_algorithms(self.old[2],
                                           warn_only=self.old[3])


def rel_err(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-300)


class TrainSetup:
    """The training path's inputs on ``dev``: the full-width body
    (humanoid(24, 6890), as train-hmr --render uses), a rendered batch of
    TRAIN_BATCH examples at TRAIN_SIZE^2 (rendered at +16 and cropped, as
    the CLI does) and TRAIN_CPU_BATCH of them at TRAIN_CPU_SIZE^2."""

    def __init__(self, dev):
        from tpubody_torch.io import dataset as ds
        from tpubody_torch.models import hmr_train
        from tpubody_torch.models import humanoid

        self.dev = dev
        self.smpl = humanoid.humanoid(n_joints=24, n_verts=6890, seed=0,
                                      device=dev)
        data = ds.rendered_hmr_dataset(TRAIN_BATCH, image_size=TRAIN_SIZE + 16,
                                       seed=1, device=dev)
        self.examples = ds.ArrayDataset([
            ds.preprocess_example(e, size=TRAIN_SIZE) for e in data._examples])
        self.batch = ds.collate(self.examples._examples).to(dev)
        self.small = ds.collate([
            ds.preprocess_example(e, size=TRAIN_CPU_SIZE)
            for e in data._examples[:TRAIN_CPU_BATCH]])
        self.step = hmr_train.make_train_step(self.smpl,
                                              img_size=float(TRAIN_SIZE))

    def fresh(self, seed=0, remat=False):
        import torch

        from tpubody_torch.models import hmr as hmr_lib
        from tpubody_torch.models import hmr_train

        model = hmr_lib.create_hmr(dtype=torch.float32, device=self.dev,
                                   seed=seed, remat=remat)
        return hmr_train.create_train_state(model, lr=1e-4)

    def gen(self, seed):
        import torch
        return torch.Generator(device=self.dev).manual_seed(seed)


def same_state(a, b):
    """Two TrainStates' weights, statistics and optimizer moments equal
    bit for bit -> the first differing name or None."""
    import torch

    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        if not torch.equal(x, y):
            return k
    sa = a.optimizer.state_dict()["state"]
    sb = b.optimizer.state_dict()["state"]
    for i in sa:
        for k in sa[i]:
            if not torch.equal(sa[i][k].cpu(), sb[i][k].cpu()):
                return f"optimizer {i}.{k}"
    return None


def step_card_vs_cpu(setup, dtype):
    """One loss + backward of the same seeded model on the card and on the
    CPU at TRAIN_CPU_BATCH x TRAIN_CPU_SIZE^2 in ``dtype``, dropout off ->
    (loss rel, worst gradient rel, worst statistic rel, their names)."""
    import torch

    from tpubody_torch.models import hmr as hmr_lib
    from tpubody_torch.models import hmr_train
    from tpubody_torch.models import humanoid

    sd = hmr_lib.create_hmr(dtype=torch.float32, device="cpu",
                            seed=3).state_dict()
    out = {}
    for d in (setup.dev, torch.device("cpu")):
        model = hmr_lib.HMR(hmr_lib.default_mean_params()).to(dtype)
        model.load_state_dict(sd)
        model.to(d).train()
        model.drop.p = 0.0
        smpl = humanoid.humanoid(n_joints=24, n_verts=6890, seed=0,
                                 dtype=dtype, device=d)
        batch = hmr_train.TrainBatch(*[x.to(d, dtype) for x in setup.small])
        loss, _ = hmr_train.loss_fn(model, smpl, batch, None,
                                    img_size=float(TRAIN_CPU_SIZE))
        loss.backward()
        out[d.type] = (loss.detach(),
                       {k: p.grad for k, p in model.named_parameters()},
                       {k: x for k, x in model.state_dict().items()
                        if k.endswith(("running_mean", "running_var"))})
    (lc, gc, sc), (lh, gh, sh) = out["cuda" if setup.dev.type == "cuda"
                                     else "cpu"], out["cpu"]
    grad = max((rel_err(gc[k], gh[k]), k) for k in gh)
    stat = max((rel_err(sc[k], sh[k]), k) for k in sh)
    return rel_err(lc, lh), grad, stat


def phase_train(dev, workdir, setup):
    """train-hmr through the CLI at its defaults on --render data, then the
    step's gates at full width -> the phase's numbers."""
    import torch

    from tpubody_torch import cli, native
    from tpubody_torch.utils import checkpoint as ckpt_lib
    from tpubody_torch.utils.metrics import read_jsonl

    res = {}
    out = os.path.join(workdir, "hmr.pt")
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(["--device", str(dev), "train-hmr", "--render",
                   str(TRAIN_RENDER), "--steps", str(TRAIN_STEPS),
                   "--out", out])
    torch.cuda.synchronize()
    res["cli_wall_s"] = time.perf_counter() - t0
    recs = read_jsonl(out + "_metrics.jsonl")
    losses = [r["loss"] for r in recs if r["tag"] == "train"]
    evals = [r for r in recs if r["tag"] == "eval"]
    log(f"  train-hmr --render {TRAIN_RENDER} --steps {TRAIN_STEPS} "
        f"(batch {TRAIN_BATCH}, {TRAIN_SIZE}^2, fp32, humanoid(24, 6890)): "
        f"rc {rc}, {res['cli_wall_s']:.3f} s with the render and the eval; "
        f"losses {losses[0]:.6f} -> {losses[-1]:.6f}; eval {evals}")
    if (rc != 0 or len(losses) != TRAIN_STEPS
            or not np.all(np.isfinite(losses)) or len(evals) != 1
            or not all(np.isfinite(evals[0][k])
                       for k in ("mpjpe", "pa_mpjpe", "pve"))):
        raise RuntimeError("train-hmr: a loss or the 3D eval is not finite")
    res["eval"] = {k: evals[0][k] for k in ("mpjpe", "pa_mpjpe", "pve")}
    restored = ckpt_lib.restore_train_state(out, setup.fresh(seed=5))
    if restored.step != TRAIN_STEPS:
        raise RuntimeError(f"train-hmr's checkpoint holds step "
                           f"{restored.step}")

    # 30 steps on one fixed batch reduce the loss.
    state = setup.fresh()
    gen = setup.gen(0)
    fixed = []
    for _ in range(TRAIN_FIXED_STEPS):
        state, m = setup.step(state, setup.batch, gen)
        fixed.append(float(m["loss"]))
    log(f"  {TRAIN_FIXED_STEPS} steps on one batch: loss {fixed[0]:.6f} -> "
        f"{fixed[-1]:.6f}")
    if not (np.all(np.isfinite(fixed)) and fixed[-1] < fixed[0]):
        raise RuntimeError("the loss did not fall on a fixed batch")
    res["fixed_batch_loss"] = (fixed[0], fixed[-1])

    # The checkpoint round-trips bit for bit; 2 steps resumed from it equal
    # 2 steps without the save (deterministic kernels on both sides).
    with deterministic():
        path = os.path.join(workdir, "state.pt")
        ckpt_lib.save_train_state(path, state)
        restored = ckpt_lib.restore_train_state(path, setup.fresh(seed=1))
        diff = same_state(state, restored)
        if diff is not None or restored.step != state.step:
            raise RuntimeError(f"the checkpoint round trip differs at {diff}")
        ga, gb = setup.gen(7), setup.gen(7)
        for _ in range(2):
            state, ma = setup.step(state, setup.batch, ga)
            restored, mb = setup.step(restored, setup.batch, gb)
            if not torch.equal(ma["loss"], mb["loss"]):
                raise RuntimeError("resumed steps differ in the loss")
        diff = same_state(state, restored)
        if diff is not None:
            raise RuntimeError(f"resumed steps differ at {diff}")
    log(f"  checkpoint: {os.path.getsize(path)} bytes, round trip and 2 "
        f"resumed steps equal bit for bit")

    # Card vs CPU, one step at batch 4, 64^2, full depth, dropout off.
    loss64, grad64, stat64 = step_card_vs_cpu(setup, torch.float64)
    loss32, grad32, stat32 = step_card_vs_cpu(setup, torch.float32)
    log(f"  card vs CPU, float64: loss {loss64:.3e} (bar "
        f"{TRAIN_LOSS_REL:g}), gradients {grad64[0]:.3e} at {grad64[1]} "
        f"(bar {TRAIN_GRAD_REL:g}), BN statistics {stat64[0]:.3e} at "
        f"{stat64[1]} (bar {TRAIN_STAT_REL:g}); float32 (not gated): loss "
        f"{loss32:.3e}, gradients {grad32[0]:.3e} at {grad32[1]}, "
        f"statistics {stat32[0]:.3e}")
    if (loss64 > TRAIN_LOSS_REL or grad64[0] > TRAIN_GRAD_REL
            or stat64[0] > TRAIN_STAT_REL):
        raise RuntimeError("train step: card and CPU disagree")
    res["card_vs_cpu"] = dict(loss_f64=loss64, grad_f64=grad64[0],
                              stat_f64=stat64[0], loss_f32=loss32,
                              grad_f32=grad32[0], stat_f32=stat32[0])
    res["launches"] = dict(native.LAUNCHES)
    log(f"  launches {res['launches']}")
    if any(res["launches"].values()):
        raise RuntimeError("the training path launched a kernel")
    return res


def step_split(setup, state, gen, steps):
    """CUDA-event ms of the forward (loss included), the backward and the
    Adam step, each summed over ``steps`` steps and divided by them."""
    import torch

    from tpubody_torch.models import hmr_train

    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(steps)]
    for e in ev:
        e[0].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss, _ = hmr_train.loss_fn(state.model, setup.smpl, setup.batch,
                                    gen, img_size=float(TRAIN_SIZE))
        e[1].record()
        loss.backward()
        e[2].record()
        state.optimizer.step()
        e[3].record()
    torch.cuda.synchronize()
    return {name: sum(e[i].elapsed_time(e[i + 1]) for e in ev) / steps
            for i, name in enumerate(("forward", "backward", "adam"))}


KERNEL_CLASSES = (("convolution", ("conv", "cudnn", "xmma", "implicit_gemm",
                                   "winograd", "fft", "dgrad", "wgrad")),
                  ("matmul", ("gemm", "gemv", "cublas", "sm90_", "cutlass")),
                  ("reduction", ("reduce",)),
                  ("elementwise", ("elementwise", "vectorized", "unrolled",
                                   "fill", "copy", "CatArray", "where",
                                   "index")))


def step_kernel_classes(fn):
    """fn under torch.profiler -> device ms by kernel class (name
    patterns above, first match), the busy total and the kernel count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out, n = {}, 0
    for e in prof.key_averages():
        if (e.device_time_total <= 0
                or e.device_type != torch.autograd.DeviceType.CUDA):
            continue
        name = e.key.lower()
        cls = next((c for c, pats in KERNEL_CLASSES
                    if any(p.lower() in name for p in pats)), "other")
        out[cls] = out.get(cls, 0.0) + e.device_time_total / 1e3
        n += e.count
    busy = sum(out.values())
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return out, busy, n


def phase_remat(dev, setup):
    """The step with remat against without on the same batch and weights:
    loss and gradients, BatchNorm statistics equal (one update a step),
    peak memory, ms/step."""
    import torch

    from tpubody_torch import native
    from tpubody_torch.models import hmr_train

    native.reset_launches()
    res, out = {}, {}
    with deterministic():
        for remat in (False, True):
            state = setup.fresh(remat=remat)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, _ = hmr_train.loss_fn(state.model, setup.smpl, setup.batch,
                                        setup.gen(0),
                                        img_size=float(TRAIN_SIZE))
            loss.backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            out[remat] = (loss.detach(),
                          {k: p.grad.clone()
                           for k, p in state.model.named_parameters()},
                          {k: x.clone()
                           for k, x in state.model.state_dict().items()
                           if "running" in k or "tracked" in k})
            res[f"peak_gb_remat_{remat}"] = peak / 1e9
            res[f"activation_gb_remat_{remat}"] = (peak - base) / 1e9
            del state, loss
    grad = max((rel_err(out[True][1][k], g), k)
               for k, g in out[False][1].items())
    unequal = [k for k, x in out[False][2].items()
               if not torch.equal(out[True][2][k], x)]
    tracked = {int(x) for k, x in out[True][2].items() if "tracked" in k}
    loss_d = rel_err(out[True][0], out[False][0])
    log(f"  remat vs none at batch {TRAIN_BATCH}, {TRAIN_SIZE}^2: loss "
        f"{loss_d:.3e}, gradients {grad[0]:.3e} at {grad[1]} (bar "
        f"{REMAT_GRAD_REL:g}), BN statistics unequal in {len(unequal)} "
        f"tensors, num_batches_tracked {sorted(tracked)}; peak memory "
        f"{res['peak_gb_remat_False']:.3f} GB without, "
        f"{res['peak_gb_remat_True']:.3f} GB with remat (above the model: "
        f"{res['activation_gb_remat_False']:.3f} / "
        f"{res['activation_gb_remat_True']:.3f} GB)")
    if (loss_d > REMAT_GRAD_REL or grad[0] > REMAT_GRAD_REL or unequal
            or tracked != {1}):
        raise RuntimeError("remat changed the step or the statistics")
    if not res["peak_gb_remat_True"] < res["peak_gb_remat_False"]:
        raise RuntimeError("remat did not lower the peak memory")
    res.update(loss_rel=loss_d, grad_rel=grad[0])

    for remat in (False, True):
        state = setup.fresh(remat=remat)
        gen = setup.gen(1)
        for _ in range(3):
            state, m = setup.step(state, setup.batch, gen)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(TIMED_STEPS):
            state, m = setup.step(state, setup.batch, gen)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / TIMED_STEPS
        res[f"ms_step_remat_{remat}"] = ms
        res[f"images_s_remat_{remat}"] = TRAIN_BATCH / ms * 1e3
        del state
    log(f"  ms/step (CUDA events, {TIMED_STEPS} steps after 3): "
        f"{res['ms_step_remat_False']:.3f} without remat = "
        f"{res['images_s_remat_False']:.1f} images/s, "
        f"{res['ms_step_remat_True']:.3f} with = "
        f"{res['images_s_remat_True']:.1f} images/s")

    # Where a step's time goes: forward / backward / Adam by CUDA events,
    # the device time by kernel class under torch.profiler (3 steps), and
    # the input pipeline's host time a batch (DeviceLoader: flips,
    # collate, pinned copy on its side stream; no step consumes them).
    from tpubody_torch.io import dataset as ds

    for remat in (False, True):
        state = setup.fresh(remat=remat)
        gen = setup.gen(2)
        step_split(setup, state, gen, 2)
        res[f"split_remat_{remat}"] = step_split(setup, state, gen,
                                                 TIMED_STEPS)
        del state
    state = setup.fresh()
    gen = setup.gen(3)
    classes, busy, n = step_kernel_classes(
        lambda: [setup.step(state, setup.batch, gen) for _ in range(3)])
    res["kernel_classes_ms_3_steps"] = classes
    res["busy_ms_3_steps"] = busy
    del state
    loader = ds.DeviceLoader(setup.examples, batch_size=TRAIN_BATCH,
                             num_epochs=None, prefetch=2, device=dev,
                             transforms=[lambda e, r: ds.random_flip(e, r)])
    it = iter(loader)
    next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2 * TIMED_STEPS):
        next(it)
    torch.cuda.synchronize()
    res["loader_ms_batch"] = ((time.perf_counter() - t0)
                              / (2 * TIMED_STEPS) * 1e3)
    it.close()
    def fmt(split):
        return ", ".join(f"{k} {v:.3f}" for k, v in split.items())

    log(f"  split, ms a step (CUDA events): without remat "
        f"{fmt(res['split_remat_False'])}; with "
        f"{fmt(res['split_remat_True'])}; "
        f"device ms by kernel class over 3 steps: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            classes.items(), key=lambda kv: -kv[1]))
        + f" (busy {busy:.3f} ms, {n} kernels and copies); DeviceLoader "
        f"{res['loader_ms_batch']:.3f} ms a batch of {TRAIN_BATCH} on the "
        f"host")
    res["launches"] = dict(native.LAUNCHES)
    if any(res["launches"].values()):
        raise RuntimeError("the remat step launched a kernel")
    return res


def phase_pose2d(dev, workdir):
    """train-pose2d at its defaults with --domain-rand, detect-pose on a
    rendered image with its checkpoint, the synthesizer card vs CPU."""
    import contextlib
    import io
    import re

    import torch

    from tpubody_torch import cli, native
    from tpubody_torch.fit import keypoints as kp_lib
    from tpubody_torch.image import ops as img_ops
    from tpubody_torch.models import humanoid, pose2d
    from tpubody_torch.pipelines import pose_train
    from tpubody_torch.utils import checkpoint as ckpt_lib

    res = {}
    ckpt = os.path.join(workdir, "pose2d.pt")
    native.reset_launches()
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--device", str(dev), "train-pose2d", "--out", ckpt,
                       "--steps", str(POSE_STEPS), "--domain-rand",
                       "--chunk", str(POSE_CHUNK)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = re.search(r"pixel err: ([\d.naninf]+) -> ([\d.naninf]+)",
                  buf.getvalue())
    before, after = float(m.group(1)), float(m.group(2))
    res.update(pixel_err_before=before, pixel_err_after=after,
               cli_wall_s=wall, ms_per_step_cli=wall / POSE_STEPS * 1e3)
    log(f"  train-pose2d --steps {POSE_STEPS} --domain-rand --chunk "
        f"{POSE_CHUNK} (size 128, features 32, batch 16, 24 joints): rc "
        f"{rc}, {wall:.3f} s = {res['ms_per_step_cli']:.3f} ms a step "
        f"(render included); pixel error {before:.4f} -> {after:.4f}")
    if rc != 0 or not after < before:
        raise RuntimeError("train-pose2d did not reduce the pixel error")

    # The step and the synthesizer alone (CUDA events).
    raw = ckpt_lib.restore_pytree(ckpt)
    model = pose2d.Pose2D(n_keypoints=int(raw["meta"]["n_keypoints"]),
                          features=int(raw["meta"]["features"])).to(dev)
    model.load_state_dict(raw["variables"])
    step = pose2d.make_train_step(model, torch.optim.Adam(model.parameters(),
                                                          lr=1e-3))
    body = humanoid.humanoid(n_joints=24, n_verts=1200, seed=0, device=dev)
    synth = pose_train.make_synthesizer(body, size=128, domain_rand=True)
    gen = torch.Generator().manual_seed(11)
    data = synth(gen, 16)
    for name, fn in (("synth", lambda: synth(gen, 16)),
                     ("step", lambda: step(data.images, data.keypoints))):
        res[f"ms_{name}"] = time_ms(fn, iters=10, warmup=2)
    log(f"  batch 16 at 128^2: synthesizer {res['ms_synth']:.3f} ms, train "
        f"step {res['ms_step']:.3f} ms (CUDA events, 10 after 2)")

    # detect-pose --ckpt on one rendered 256^2 image.
    synth256 = pose_train.make_synthesizer(body, size=DETECT_SIZE)
    img = synth256(torch.Generator().manual_seed(12), 1).images[0]
    png = os.path.join(workdir, "person.png")
    img_ops.write_image(png, img.cpu().numpy())
    js = os.path.join(workdir, "0_keypoints.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--device", str(dev), "detect-pose", png, js,
                       "--ckpt", ckpt])
    kps = kp_lib.read_openpose_json(js, use_hands=True).keypoints
    log(f"  detect-pose --ckpt on a {DETECT_SIZE}^2 render: rc {rc}, "
        f"{kps.shape[0]} slots read back, confidence of the 24 body slots "
        f"{float(kps[:24, 2].mean()):.4f}")
    if (rc != 0 or kps.shape[0] != 67 or not np.isfinite(kps).all()
            or (kps[24:, 2] != 0).any()):
        raise RuntimeError("detect-pose's JSON does not read back")

    # The synthesizer on the card and on the CPU, the same draws.
    host = pose_train.make_synthesizer(
        humanoid.humanoid(n_joints=24, n_verts=1200, seed=0), size=128,
        domain_rand=True)
    draws = synth.draw(torch.Generator().manual_seed(13), POSE_CPU_BATCH)
    a, b = synth.render(draws), host.render(draws)
    kp_d = float((a.keypoints.cpu() - b.keypoints).abs().max())
    off = float(((a.images.cpu() - b.images).abs().amax(-1)
                 > POSE_IMG_ATOL).float().mean())
    log(f"  synthesizer card vs CPU, {POSE_CPU_BATCH} x 128^2: keypoints "
        f"{kp_d:.3e} px (bar {POSE_KP_ATOL:g}), pixels beyond "
        f"{POSE_IMG_ATOL:g}: {100 * off:.4f}% (bar {100 * POSE_IMG_SHARE:g}%)")
    if kp_d > POSE_KP_ATOL or off > POSE_IMG_SHARE:
        raise RuntimeError("the synthesizer differs between card and CPU")
    res.update(card_vs_cpu_kp_px=kp_d, card_vs_cpu_pixel_share=off)
    res["launches"] = dict(native.LAUNCHES)
    log(f"  launches {res['launches']}")
    if any(res["launches"].values()):
        raise RuntimeError("the pose2d path launched a kernel")
    return res


def phase_asf(dev, workdir):
    """animate with an .amc clip and --asf through the CLI."""
    import contextlib
    import io

    import torch

    from tpubody_torch import cli, native
    from tpubody_torch.io import asf as asf_lib
    from tpubody_torch.pipelines import animate
    from tpubody_torch.render import video

    avatar, avatar_path, _ = make_avatar_and_clip(workdir)
    asf, amc = (os.path.join(workdir, n) for n in ("skel.asf", "walk.amc"))
    with open(asf, "w") as f:
        f.write(SAMPLE_ASF)
    with open(amc, "w") as f:
        f.write(amc_text(ASF_FRAMES))
    clip = asf_lib.read_amc(asf, amc)
    moving = [j for j in range(24) if np.abs(clip.poses[:, j]).max() > 0]
    cam_t = np.array([0.0, 0.0, ASF_CAM_Z])
    plan, _, chunk = animate._tiled_plan(
        avatar.v_template, avatar.faces, cam_t, ASF_SIZE, video.DEFAULT_FOCAL,
        8, dev)
    passes = 1 + sum(len(f) > 0 for f in plan["ladder_faces"])
    want = -(-ASF_FRAMES // chunk) * passes

    out = os.path.join(workdir, "walk.mp4")
    native.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--device", str(dev), "animate", avatar_path, amc,
                       "--asf", asf, out, "--size", str(ASF_SIZE),
                       "--stride", "1", "--cam-z", str(ASF_CAM_Z)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    import cv2
    cap = cv2.VideoCapture(out)
    frames = 0
    while cap.read()[0]:
        frames += 1
    cap.release()
    log(f"  animate walk.amc --asf skel.asf at {ASF_SIZE}^2: rc {rc}, "
        f"{wall:.3f} s, {frames} frames in the MP4; SMPL joints moved "
        f"{moving}; launches {launches} (fused_raster expected {want}: "
        f"{passes} passes a block of {chunk})")
    others = {k: v for k, v in launches.items() if k != "fused_raster"}
    if (rc != 0 or frames != ASF_FRAMES or launches["fused_raster"] != want
            or any(others.values()) or moving != [0, 1, 4]):
        raise RuntimeError("the .amc animation failed its gates")
    return dict(wall_s=wall, frames=frames, launches=launches,
                passes=passes)


# -- slice E2: int8 serving and frame-axis distribution ----------------------
QUANT_BATCH = 512         # the flagship's batch, timed beside the bf16 step
QUANT_CPU_BATCH = 4       # the int8 forward, card vs the CPU route
QUANT_CODE_SHARE = 0.999  # int8 codes equal at every conv input, card vs CPU
QUANT_FIDELITY = 0.15     # tpubody's bar: err / scale of pose6d, int8 vs f32
ORTHO_ATOL = 1e-4         # rotations of the int8 outputs orthonormal
QUANT_CONVS = 53          # int8_requant launches a backbone call
QUANT_ITERS = 10          # CUDA-event timing after 3 warm-up steps
MESH_LBS_FRAMES = 512
MESH_FIT_N = 8            # frames of the sharded fit, 2 iterations a stage
MESH_FIT_ITERS = 2
DIST_FRAMES = 16          # clip of the sharded and the two-process animation
DIST_SIZE = 256
DIST_TIMEOUT_S = 300      # each worker process of phase 26
# Frames of the sharded or two-process animation against the unsharded
# ones: equal.  The card's renderer is bit-reproducible since the vertex
# normals are summed in a fixed order (phase 27), and a frame's pixels do
# not depend on the other frames of its block or on the shard it lies in.
DIST_FRAME_LSB = 0
DIST_FRAME_SHARE = 0.0


def frames_agree(a, b, what):
    """uint8 frames a and b under the bar above -> (max |d|, share of
    values that differ)."""
    if a.shape != b.shape:
        raise RuntimeError(f"{what}: frames {a.shape} vs {b.shape}")
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    worst, share = int(d.max()), float((d > 0).mean())
    log(f"  {what}: max |d| {worst} LSB, share of values that differ "
        f"{share:.3e} (bar {DIST_FRAME_LSB} LSB on {DIST_FRAME_SHARE})")
    if worst > DIST_FRAME_LSB or share > DIST_FRAME_SHARE:
        raise RuntimeError(f"{what}: frames disagree")
    return worst, share


def serve_requests(step, images, buckets, dev, sharding=None):
    """Every image as one request through InferenceServer(step) from its
    own thread -> (results, [(batch, outputs)] dispatched after warm-up,
    launches during the whole run, server stats).  The launch counters are
    zeroed just before the server is built (its warm-up included) and read
    after the last result."""
    from tpubody_torch import native
    from tpubody_torch.pipelines import serving

    batches = []

    class Recording:
        """The step, recording each dispatched batch and its outputs (a
        replica per shard device: ``to``)."""

        def __init__(self, inner):
            self.inner = inner

        def to(self, device):
            return Recording(self.inner.to(device))

        def __call__(self, batch):
            out = self.inner(batch)
            batches.append((batch.clone(), out))
            return out

    native.reset_launches()
    server = serving.InferenceServer(Recording(step), step.image_shape,
                                     buckets=buckets, device=dev,
                                     sharding=sharding)
    batches.clear()       # drop the warm-up batches
    futures = [None] * len(images)

    def send(i):
        futures[i] = server.submit(images[i])

    with server:
        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        results = [f.result(timeout=300) for f in futures]
    return results, batches, dict(native.LAUNCHES), server.stats.snapshot()


def hold_served(step, images, results, batches, dev):
    """Each served result against the step applied directly to the batch
    (or shard) it was dispatched in -> the largest difference."""
    import torch

    worst = 0.0
    direct = [step(b) for b, _ in batches]
    for img, (verts, cam) in zip(images, results):
        if not (np.isfinite(verts).all() and np.isfinite(cam).all()):
            raise RuntimeError("non-finite served output")
        x = torch.as_tensor(img, device=dev)
        hits = [(k, r) for k, (b, _) in enumerate(batches)
                for r in range(len(b)) if torch.equal(b[r].to(dev), x)]
        if not hits:
            raise RuntimeError("a request's image is in no dispatched batch")
        k, r = hits[0]
        worst = max(worst,
                    float(np.abs(verts - direct[k][0][r].cpu().numpy()).max()),
                    float(np.abs(cam - direct[k][1][r].cpu().numpy()).max()))
    return worst


def int_mm_rules(dev):
    """torch._int_mm's CUDA rules as hmr_quant relies on them, and the two
    layouts of the second operand timed on a layer1 conv2 product at
    batch 512 (M = 1,605,632, K = 576, N = 64)."""
    import torch

    def runs(m, k, n, col_major):
        a = torch.ones(m, k, dtype=torch.int8, device=dev)
        b = (torch.ones(n, k, dtype=torch.int8, device=dev).t() if col_major
             else torch.ones(k, n, dtype=torch.int8, device=dev))
        try:
            c = torch._int_mm(a, b)
            torch.cuda.synchronize()
            return bool((c == k).all())
        except RuntimeError:
            return False

    rules = {"M16": runs(16, 64, 64, True), "M17_col": runs(17, 64, 64, True),
             "M17_row": runs(17, 64, 64, False),
             "K147": runs(32, 147, 64, True), "K152": runs(32, 152, 64, True)}
    if rules != {"M16": False, "M17_col": True, "M17_row": False,
                 "K147": False, "K152": True}:
        raise RuntimeError(f"torch._int_mm's rules changed: {rules}")
    M, K, N = QUANT_BATCH * 56 * 56, 576, 64
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device=dev)
    w = torch.randint(-127, 128, (N, K), dtype=torch.int8, device=dev)
    ms = {"column_major": time_ms(lambda: torch._int_mm(a, w.t()), 10, 2),
          "row_major": time_ms(lambda: torch._int_mm(a, w.t().contiguous()),
                               10, 2)}
    tops = {k: 2.0 * M * K * N / (v * 1e-3) / 1e12 for k, v in ms.items()}
    return rules, ms, tops


def phase_quant(dev):
    """int8 HMR serving at full width (hmr_smpl_step(quantize=True))."""
    import torch

    from tpubody_torch import bench, native
    from tpubody_torch.models import hmr as hmr_lib
    from tpubody_torch.models import hmr_quant as hq
    from tpubody_torch.pipelines import serving

    rules, mm_ms, mm_tops = int_mm_rules(dev)
    log(f"  torch._int_mm rules {rules}; layer1 conv2 product at batch "
        f"{QUANT_BATCH}: ms {mm_ms}, int8 TOP/s {mm_tops}")

    # The int8 step through its entry point, and its parameters rebuilt
    # by hand from the same seeded float32 HMR (the fidelity check needs
    # the folded tree); both must agree.
    t0 = time.perf_counter()
    step = serving.hmr_smpl_step(quantize=True, device=dev)
    build_s = time.perf_counter() - t0
    calib = np.random.default_rng(0).normal(
        scale=0.5, size=(4, 224, 224, 3)).astype(np.float32)
    folded = hq.fold_batchnorm(hmr_lib.create_hmr(dtype=torch.float32,
                                                  device=dev))
    qp = hq.quantize(folded, hq.calibrate(folded, calib))
    for a, b in zip(hq_convs(qp), hq_convs(step.hmr.qparams)):
        if not (torch.equal(a.w, b.w) and torch.equal(a.x_scale, b.x_scale)):
            raise RuntimeError("hmr_smpl_step(quantize=True) quantized "
                               "other weights than the seeded model's")

    rng = np.random.default_rng(24)
    images = rng.normal(size=(24, 224, 224, 3)).astype(np.float32)
    results, batches, launches, snap = serve_requests(
        step, images, (1, 4, 16, 64), dev)
    log(f"  served {snap['requests']} requests in {snap['batches']} batches"
        f" of sizes {[len(b) for b, _ in batches]}: p50 "
        f"{snap['latency_p50_ms']:.3f} ms, p99 {snap['latency_p99_ms']:.3f}"
        f" ms; launches {launches}")
    for name in ("fused_lbs", "int8_requant"):
        if launches[name] == 0:
            raise RuntimeError(f"{name} was not launched on the int8 path")
    worst = hold_served(step, images, results, batches, dev)
    log(f"  served vs direct (same batch): max|d|={worst:.3e}")
    if worst > SAME_BATCH_ATOL:
        raise RuntimeError("served int8 results differ from the direct step")

    # The card against the CPU route on the same parameters: the int8
    # codes at every conv input and the outputs.
    x = torch.as_tensor(images[:QUANT_CPU_BATCH], device=dev)
    qp_cpu = hq.QuantizedHMR(qp).to("cpu").qparams
    codes = {}
    with torch.inference_mode():
        xf = hq._backbone_int8(qp, x, observe=lambda n, c: codes.setdefault(
            n, [c.cpu()]))
        out = hq._ief_head(qp["head"], xf, hmr_lib.default_mean_params())
        xf_c = hq._backbone_int8(qp_cpu, x.cpu(),
                                 observe=lambda n, c: codes[n].append(c))
        out_c = hq._ief_head(qp_cpu["head"], xf_c,
                             hmr_lib.default_mean_params())
    shares = {n: float((a == b).float().mean()) for n, (a, b) in
              codes.items()}
    err_cpu = max((getattr(out, f).cpu() - getattr(out_c, f)).abs().max()
                  .item() for f in ("pose6d", "shape", "cam", "rotmats"))
    log(f"  int8 card vs CPU route, batch {QUANT_CPU_BATCH}: codes equal at "
        f"{len(shares)} conv inputs, least share {min(shares.values()):.6f}"
        f" (bar {QUANT_CODE_SHARE}); outputs max|d|={err_cpu:.3e} (bar "
        f"{CPU_HMR_ATOL})")
    if min(shares.values()) < QUANT_CODE_SHARE or err_cpu > CPU_HMR_ATOL:
        raise RuntimeError("the int8 forward on the card disagrees with "
                           "the CPU route")

    # Fidelity against the folded float32 network, tpubody's bar.
    with torch.inference_mode():
        got = hq.forward(qp, calib)
        ref = hq.forward_folded(folded, calib)
    fid = ((got.pose6d - ref.pose6d).abs().max()
           / (ref.pose6d.abs().max() + 1e-6)).item()
    R = got.rotmats.reshape(-1, 3, 3).double()
    ortho = (R @ R.transpose(1, 2) - torch.eye(3, dtype=torch.float64,
                                               device=dev)).abs().max().item()
    log(f"  int8 vs forward_folded on the calibration images: err/scale "
        f"{fid:.4e} (bar {QUANT_FIDELITY}), rotations |RR^T - I| "
        f"{ortho:.3e} (bar {ORTHO_ATOL})")
    if not fid < QUANT_FIDELITY or ortho > ORTHO_ATOL:
        raise RuntimeError("the int8 outputs miss tpubody's fidelity bar")

    # Throughput at the flagship's batch beside the bf16 step, in turns,
    # with bench's own timing helper; then the int8 step's split.
    big = torch.as_tensor(np.random.default_rng(0).normal(
        size=(QUANT_BATCH, 224, 224, 3)).astype(np.float32), device=dev)
    bf16 = bench.make_step(dev)
    int8 = serving.HMRSMPLStep(hq.QuantizedHMR(qp), bf16.body, dev, 224)
    timed = {"int8": [], "bf16": []}
    peak = {}
    with torch.inference_mode():
        for name in ("int8", "bf16", "bf16", "int8"):
            fn = int8 if name == "int8" else bf16
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            timed[name].append(bench._event_ms(lambda: fn(big), QUANT_ITERS,
                                               3))
            peak[name] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        split_ms = span_split(lambda: int8(big), 5)
    # The main path: the same frames from host memory, copied in chunks
    # under the backbone (serving.chunk_frames), the counters zeroed just
    # before: int8_requant 53 times a chunk, fused_lbs once.
    host = big.cpu().numpy()
    chunks = int8._chunks(host)
    chunk = serving.chunk_frames(host.shape[1:])
    if chunks != -(-QUANT_BATCH // chunk):
        raise RuntimeError(f"the int8 step takes {QUANT_BATCH} host frames "
                           f"in {chunks} pieces, not in chunks of {chunk}")
    native.reset_launches()
    with torch.inference_mode():
        int8(host)
    torch.cuda.synchronize()
    step_launches = dict(native.LAUNCHES)
    log(f"  int8 step on {QUANT_BATCH} host frames in {chunks} chunks: "
        f"launches {step_launches}")
    if (step_launches["int8_requant"] != QUANT_CONVS * chunks
            or step_launches["fused_lbs"] != 1):
        raise RuntimeError(f"the int8 step on {chunks} chunks launched "
                           f"{step_launches}, not {QUANT_CONVS} "
                           f"int8_requant a chunk and fused_lbs once")
    requant = requant_timing(qp, dev)
    requant["launches"] = launches["int8_requant"]
    ms = {k: min(v) for k, v in timed.items()}
    res = {
        "batch": QUANT_BATCH,
        "int8_ms": ms["int8"], "int8_fps": QUANT_BATCH * 1e3 / ms["int8"],
        "bf16_ms": ms["bf16"], "bf16_fps": QUANT_BATCH * 1e3 / ms["bf16"],
        "turns_ms": timed, "int8_split_ms": split_ms,
        "peak_gb_above_model": peak, "build_s": build_s,
        "latency_p50_ms": snap["latency_p50_ms"],
        "latency_p99_ms": snap["latency_p99_ms"],
        "code_share_min": min(shares.values()), "cpu_err": err_cpu,
        "fidelity": fid, "int_mm_ms": mm_ms, "int_mm_tops": mm_tops,
        "launches": launches, "chunks": chunks,
        "launches_step": step_launches, "requant": requant,
        "card": card_line()}
    log(f"  int8 step {ms['int8']:.3f} ms = {res['int8_fps']:.1f} frames/s;"
        f" bf16 step {ms['bf16']:.3f} ms = {res['bf16_fps']:.1f} frames/s "
        f"(batch {QUANT_BATCH}, in turns {timed}); int8 split ms {split_ms};"
        f" peak GB above the inputs {peak}")
    return res


def requant_timing(qp, dev):
    """int8_requant at the launches of one backbone at QUANT_BATCH frames
    of 224^2 (recorded from one frame: M grows with the batch), each
    distinct launch timed by CUDA events on seeded sums, beside the plain
    version (the eager chain it replaces, on the card) and the least time
    its bytes take -> the kernel line's entry.  Sums over the backbone."""
    import torch
    from collections import Counter

    from tpubody_torch.models import hmr_quant as hq

    calls = []
    launch = hq.requantize

    def recording(acc, qc, relu, res=None, scales=(), keep=False):
        calls.append((acc.shape[0] * QUANT_BATCH, acc.shape[1], relu,
                      res is not None, len(scales), keep))
        return launch(acc, qc, relu, res, scales, keep)

    hq.requantize = recording
    try:
        with torch.inference_mode():
            hq._backbone_int8(qp, torch.zeros((1, 224, 224, 3), device=dev))
    finally:
        hq.requantize = launch
    g = torch.Generator(dev).manual_seed(17)
    total = {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "gb": 0.0}
    for (M, O, relu, with_res, n, keep), count in Counter(calls).items():
        acc = torch.randint(-3000, 3001, (M, O), generator=g, device=dev,
                            dtype=torch.int32)
        qc = hq.QConv(w=torch.zeros((O, 8), dtype=torch.int8, device=dev),
                      w_scale=torch.rand(O, generator=g, device=dev) * 0.01,
                      b=torch.randn(O, generator=g, device=dev),
                      x_scale=torch.tensor(0.02, device=dev),
                      kernel=(1, 1, 8), strides=(1, 1),
                      padding=((0, 0), (0, 0)))
        res = (torch.randn(M, O, generator=g, device=dev) if with_res
               else None)
        scales = [torch.tensor(0.05 + 0.01 * k, device=dev)
                  for k in range(n)]
        args = (acc, qc, relu, res, scales, keep)
        got, want = hq.requantize(*args), hq.requantize_reference(*args)
        if not (all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
                and (not keep or torch.equal(got[1], want[1]))):
            raise RuntimeError(f"int8_requant differs from its plain version"
                               f" at {(M, O, relu, with_res, n, keep)}")
        del got, want
        nbytes = M * O * (4 + 4 * with_res + 4 * keep + n)
        total["kernel_ms"] += count * time_ms(lambda: hq.requantize(*args),
                                              10, 2)
        total["plain_ms"] += count * time_ms(
            lambda: hq.requantize_reference(*args), 3, 1)
        total["bound_ms"] += count * nbytes / PEAK_BYTES * 1e3
        total["gb"] += count * nbytes / 1e9
    log(f"  int8_requant over one backbone at batch {QUANT_BATCH} "
        f"({len(calls)} launches, {total['gb']:.2f} GB): "
        f"{total['kernel_ms']:.3f} ms, bound {total['bound_ms']:.3f} ms "
        f"(share {total['bound_ms'] / total['kernel_ms']:.3f}), plain "
        f"{total['plain_ms']:.3f} ms")
    return {
        "name": "int8_requant",
        "route": "cuda",
        "source": "tpubody_torch/csrc/int8_requant.cu",
        "replaces": None,
        "shape": {"batch": QUANT_BATCH, "image": 224,
                  "launches_backbone": len(calls)},
        "ms": total["kernel_ms"],
        "kernel_ms": total["kernel_ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes",
        "gb": total["gb"],
    }


LN_FRAMES = 512           # phase 28: the HMR 2.0 cell's batch
LN_TOKENS = LN_FRAMES * 192  # the encoder's tokens at that batch
LN_DIM = 1280
LN_F32_BAR = 2e-6          # float32 output: of its largest magnitude


def hmr2_step_launches(dev):
    """One HMR 2.0 step (hmr_smpl_step(arch="hmr2_vith"), the cell's path)
    at LN_FRAMES frames of 256^2 from host memory, copied in chunks under
    the encoder, the counters zeroed just before it -> (the launches of
    that step, its chunks)."""
    import torch

    from tpubody_torch import native
    from tpubody_torch.pipelines import serving

    step = serving.hmr_smpl_step(arch="hmr2_vith", device=dev)
    images = np.random.default_rng(28).normal(
        size=(LN_FRAMES, 256, 256, 3)).astype(np.float32)
    chunks = step._chunks(images)
    chunk = serving.chunk_frames(images.shape[1:])
    if chunks != -(-LN_FRAMES // chunk):
        raise RuntimeError(f"the HMR 2.0 step takes {LN_FRAMES} host frames "
                           f"in {chunks} pieces, not in chunks of {chunk}")
    native.reset_launches()
    verts, cam = step(images)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    if not (torch.isfinite(verts).all() and torch.isfinite(cam).all()):
        raise RuntimeError("non-finite HMR 2.0 output")
    del step, images, verts, cam
    torch.cuda.empty_cache()
    return launches, chunks


def hold_layernorm_forms(x, branch, norm, scale=None):
    """add_layernorm in the encoders' two forms on the same inputs, each
    held to its plain version (raises where one differs) -> their
    differences: the blocks' form (bf16 output, x + branch kept: the new
    stream bit-equal, the output within a bf16 ulp of the largest
    magnitude and unequal on under 0.1% of elements) and the last block's
    (float32 output without x_new, within LN_F32_BAR of the largest
    magnitude).  ``scale``: LayerScale's per-channel scale, or None."""
    import torch

    from tpubody_torch import native
    from tpubody_torch.models import hmr2

    bf16, res = torch.bfloat16, {}
    before = native.LAUNCHES["add_layernorm"]
    got_x, got_h = hmr2.add_layernorm(x, branch, norm, bf16, scale=scale)
    want_x, want_h = hmr2.add_layernorm_reference(x, branch, norm, bf16,
                                                  scale=scale)
    torch.cuda.synchronize()
    diff = (got_h.float() - want_h.float()).abs()
    res["max_diff"] = float(diff.max())
    res["unequal_share"] = float((diff > 0).float().mean())
    ulp = 2.0 ** (int(np.floor(np.log2(float(want_h.float().abs()
                                                 .max())))) - 7)
    if (native.LAUNCHES["add_layernorm"] != before + 1
            or not torch.equal(got_x, want_x)
            or res["max_diff"] > ulp or res["unequal_share"] >= 1e-3):
        raise RuntimeError(f"add_layernorm differs from its plain "
                           f"version: {res}")
    del got_x, got_h, want_x, want_h, diff
    none, got_h = hmr2.add_layernorm(x, branch, norm, torch.float32,
                                     keep_x=False, scale=scale)
    _, want_h = hmr2.add_layernorm_reference(x, branch, norm, torch.float32,
                                             keep_x=False, scale=scale)
    torch.cuda.synchronize()
    res["last_block_max_diff"] = float((got_h - want_h).abs().max())
    bar = LN_F32_BAR * float(want_h.abs().max())
    if (none is not None or got_h.dtype != torch.float32
            or native.LAUNCHES["add_layernorm"] != before + 2
            or not res["last_block_max_diff"] <= bar):
        raise RuntimeError(f"add_layernorm's float32 form without "
                           f"x_new differs from its plain version: "
                           f"{res['last_block_max_diff']} (bar {bar})")
    return res


def layernorm_inputs(M, D, dev, seed):
    """Seeded float32 x (M, D), a bf16 branch and a LayerNorm of D."""
    import torch

    from tpubody_torch.models import hmr2

    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(M, D, generator=g, device=dev) * 2 + 0.5
    branch = torch.randn(M, D, generator=g, device=dev).to(torch.bfloat16)
    norm = torch.nn.LayerNorm(D, eps=hmr2.ENCODER_EPS, device=dev)
    with torch.no_grad():
        norm.weight.normal_(1.0, 0.1, generator=g)
        norm.bias.normal_(0.0, 0.1, generator=g)
    return x, branch, norm, g


def phase_layernorm(dev):
    """add_layernorm on the HMR 2.0 step (its launches), then at the main
    path's shape in both of the step's forms, each held to its plain
    version, and timed beside its byte bound and the eager chain; then
    Multi-HMR's LayerScale form at its encoder's shape, held and timed
    alike -> (the kernel line's entry, the step's launches)."""
    import torch

    from tpubody_torch.models import hmr2

    step_launches, chunks = hmr2_step_launches(dev)
    M, D, bf16 = LN_TOKENS, LN_DIM, torch.bfloat16
    x, branch, norm, _ = layernorm_inputs(M, D, dev, 20)
    res = {"name": "add_layernorm", "route": "cuda",
           "source": "tpubody_torch/csrc/add_layernorm.cu", "replaces": None,
           "shape": {"tokens": M, "dim": D, "branch": "bf16", "out": "bf16"},
           "bound_by": "bytes", "launches": step_launches["add_layernorm"],
           "chunks": chunks}
    if res["launches"] != 64 * chunks:
        raise RuntimeError(f"the HMR 2.0 step launched add_layernorm "
                           f"{res['launches']} times, not 64 x {chunks} "
                           f"chunks")
    with torch.no_grad():
        args = (x, branch, norm, bf16)
        res.update(hold_layernorm_forms(x, branch, norm))
        res["kernel_ms"] = time_ms(lambda: hmr2.add_layernorm(*args), 50, 5)
        res["last_block_ms"] = time_ms(
            lambda: hmr2.add_layernorm(x, branch, norm, torch.float32,
                                       keep_x=False), 50, 5)
        res["library_ms"] = time_ms(
            lambda: hmr2.add_layernorm_reference(*args), 20, 3)
    nbytes = M * D * (4 + 2 + 4 + 2)
    res.update(ms=res["kernel_ms"], plain_ms=res["library_ms"],
               gb=nbytes / 1e9, bound_ms=nbytes / PEAK_BYTES * 1e3)
    res["share"] = res["bound_ms"] / res["kernel_ms"]
    log(f"  HMR 2.0 step at {LN_FRAMES} host frames in {chunks} chunks: "
        f"launches {step_launches}")
    log(f"  add_layernorm at {M} x {D} (bf16 branch and output, "
        f"{res['gb']:.3f} GB): {res['kernel_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms (share {res['share']:.3f}), eager chain "
        f"{res['library_ms']:.4f} ms; max diff {res['max_diff']:.3g}, "
        f"unequal share {res['unequal_share']:.3g}; float32 output without "
        f"x_new {res['last_block_ms']:.4f} ms, max diff "
        f"{res['last_block_max_diff']:.3g}")
    del x, branch, norm
    res["layerscale"] = phase_layernorm_scaled(dev)
    log(json.dumps({"layernorm": res, "card": card_line()}))
    return res, step_launches


def phase_layernorm_scaled(dev):
    """Multi-HMR's form of add_layernorm, ``x + γ ⊙ branch``, at its
    encoder's shape (MH_FRAMES frames of 4,097 tokens of 1024), held to its
    plain version in both forms and timed beside the byte bound -> its
    result."""
    import torch

    from tpubody_torch.models import hmr2

    M, D = MH_FRAMES * 4097, 1024
    x, branch, norm, g = layernorm_inputs(M, D, dev, 23)
    # LayerScale as the benchmark seeds it: U(0.1, 0.5) a channel
    gamma = torch.rand(D, generator=g, device=dev) * 0.4 + 0.1
    res = {"shape": {"tokens": M, "dim": D, "branch": "bf16",
                     "scale": "float32"}}
    with torch.no_grad():
        res.update(hold_layernorm_forms(x, branch, norm, gamma))
        res["kernel_ms"] = time_ms(lambda: hmr2.add_layernorm(
            x, branch, norm, torch.bfloat16, scale=gamma), 50, 5)
        res["last_block_ms"] = time_ms(lambda: hmr2.add_layernorm(
            x, branch, norm, torch.float32, keep_x=False, scale=gamma),
            50, 5)
    nbytes = M * D * (4 + 2 + 4 + 2)
    res.update(gb=nbytes / 1e9, bound_ms=nbytes / PEAK_BYTES * 1e3)
    res["share"] = res["bound_ms"] / res["kernel_ms"]
    log(f"  add_layernorm with LayerScale at {M} x {D} ({res['gb']:.3f} "
        f"GB): {res['kernel_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
        f"(share {res['share']:.3f}); max diff {res['max_diff']:.3g}, "
        f"unequal share {res['unequal_share']:.3g}; float32 output without "
        f"x_new {res['last_block_ms']:.4f} ms, max diff "
        f"{res['last_block_max_diff']:.3g}")
    return res


MH_FRAMES = 64            # phase 29: the Multi-HMR cell's batch


def phase_multihmr(dev):
    """One Multi-HMR step (hmr_smpl_step(arch="multihmr_896_l"), the cell's
    path) at MH_FRAMES frames of 896^2 from host memory, copied in chunks
    under the encoder, the counters zeroed just before it -> its result
    (shapes, chunks, launches)."""
    import torch

    from tpubody_torch import native
    from tpubody_torch.pipelines import serving

    step = serving.hmr_smpl_step(arch="multihmr_896_l", device=dev)
    P = step.hmr.persons
    images = np.random.default_rng(29).normal(
        size=(MH_FRAMES, 896, 896, 3)).astype(np.float32)
    chunks = step._chunks(images)
    want_chunks = -(-MH_FRAMES // serving.chunk_frames(images.shape[1:]))
    native.reset_launches()
    t0 = time.perf_counter()
    verts, transl = step(images)
    torch.cuda.synchronize()
    res = {"frames": MH_FRAMES, "persons": P, "chunks": chunks,
           "cold_s": time.perf_counter() - t0,
           "verts": list(verts.shape), "transl": list(transl.shape),
           "launches": dict(native.LAUNCHES)}
    if (tuple(verts.shape) != (MH_FRAMES, 8, 10475, 3)
            or tuple(transl.shape) != (MH_FRAMES, 8, 3)):
        raise RuntimeError(f"the Multi-HMR step answers {res['verts']} and "
                           f"{res['transl']}")
    if not (torch.isfinite(verts).all() and torch.isfinite(transl).all()):
        raise RuntimeError("non-finite Multi-HMR output")
    if (chunks != want_chunks
            or res["launches"]["add_layernorm"] != 48 * chunks
            or res["launches"]["fused_lbs"] != 1):
        raise RuntimeError(f"the Multi-HMR step in {chunks} pieces (not "
                           f"{want_chunks}) launched {res['launches']}: not "
                           f"add_layernorm 48 times a chunk and fused_lbs "
                           f"once")
    del step, images, verts, transl
    torch.cuda.empty_cache()
    log(f"  Multi-HMR step at {MH_FRAMES} host frames of 896^2, {P} persons "
        f"each: {res}")
    return res


SP_FRAMES = 32            # phase 30: the Sapiens cell's batch
SP_CHUNK = 16             # a copy chunk of 1024^2 frames
SP_TOKENS, SP_DIM, SP_HEADS = 3072, 1920, 32


def phase_sapiens(dev):
    """Sapiens-2B pose (models/sapiens.py): its attention half at one copy
    chunk (SP_CHUNK frames of 3,072 tokens, 32 heads of 60) by the two
    routes, the published heads run as they are (SDPA picks its own
    kernel for a width that is not a multiple of 8) and zero-padded to 64
    in the weights (hmr2.Attention, which the model serves), held to each
    other and timed in turns; then one keypoint_step at SP_FRAMES host
    frames of 1024^2 in 2 chunks under the encoder, the counters zeroed
    just before it: (32, 308, 2) finite keypoints, (32, 308) confidences
    in [0, 1], 96 add_layernorm launches a chunk and SA_LAUNCHES
    soft_argmax; then add_layernorm and soft_argmax at the step's shapes
    (phase_layernorm_sapiens, phase_soft_argmax)."""
    import torch
    import torch.nn.functional as F

    from tpubody_torch import native
    from tpubody_torch.models import hmr2
    from tpubody_torch.pipelines import serving

    res = {}
    B, N, D, H = SP_CHUNK, SP_TOKENS, SP_DIM, SP_HEADS
    d = D // H
    gen = torch.Generator(device=dev).manual_seed(30)
    with torch.inference_mode():
        padded = hmr2.Attention(D, H).to(dev).to(torch.bfloat16).eval()
        sd = {k: (0.02 * torch.randn(v.shape, generator=gen, device=dev)
                  ).to(torch.bfloat16)
              for k, v in padded.state_dict().items()}
        padded.load_state_dict(sd)
        x = torch.randn((B, N, D), generator=gen, device=dev).to(
            torch.bfloat16)

        def published():
            q, k, v = F.linear(x, sd["qkv.weight"], sd["qkv.bias"]).view(
                B, N, 3, H, d).permute(2, 0, 3, 1, 4)
            y = F.scaled_dot_product_attention(q, k, v)
            return F.linear(y.transpose(1, 2).reshape(B, N, D),
                            sd["proj.weight"], sd["proj.bias"])

        a, b = published().float(), padded(x).float()
        res["routes_max_diff"] = float((a - b).abs().max())
        res["routes_scale"] = float(a.abs().max())
        del a, b
        if res["routes_max_diff"] > 0.02 * res["routes_scale"]:
            raise RuntimeError(f"the padded attention is not the published "
                               f"one: {res}")
        times = {"published_ms": [], "padded_ms": []}
        for _ in range(2):
            times["published_ms"].append(time_ms(published, iters=20))
            times["padded_ms"].append(time_ms(lambda: padded(x), iters=20))
        res.update(times)
        del x, padded
    torch.cuda.empty_cache()

    step = serving.keypoint_step(device=dev)
    images = np.random.default_rng(30).normal(
        size=(SP_FRAMES, 1024, 1024, 3)).astype(np.float32)
    chunks = step._chunks(images)
    native.reset_launches()
    t0 = time.perf_counter()
    keypoints, conf = step(images)
    torch.cuda.synchronize()
    res.update(frames=SP_FRAMES, chunks=chunks,
               cold_s=time.perf_counter() - t0,
               keypoints=list(keypoints.shape), conf=list(conf.shape),
               launches=dict(native.LAUNCHES))
    if (tuple(keypoints.shape) != (SP_FRAMES, 308, 2)
            or tuple(conf.shape) != (SP_FRAMES, 308)
            or not bool(torch.isfinite(keypoints).all())
            or not bool(((conf >= 0) & (conf <= 1)).all())):
        raise RuntimeError(f"the Sapiens step answers {res}")
    if (chunks != 2 or res["launches"]["add_layernorm"] != 96 * chunks
            or res["launches"]["soft_argmax"] != SA_LAUNCHES):
        raise RuntimeError(f"the Sapiens step in {chunks} pieces launched "
                           f"{res['launches']}: not 2 chunks of 96 "
                           f"add_layernorm and {SA_LAUNCHES} soft_argmax")
    del step, images, keypoints, conf
    torch.cuda.empty_cache()
    log(f"  Sapiens attention half at {B} x {N} tokens, {H} heads of {d}, "
        f"and the step at {SP_FRAMES} host frames of 1024^2: {res}")
    res["layernorm"] = phase_layernorm_sapiens(dev)
    res["soft_argmax"] = phase_soft_argmax(dev, res["launches"]["soft_argmax"])
    return res


def phase_layernorm_sapiens(dev):
    """add_layernorm at the Sapiens encoder's shape (SP_CHUNK frames of
    3,072 tokens of 1,920: 240 chunks of 8 a row, 7.5 a lane of 32, so
    each row's last lane stops half way), held to its plain version in
    both of the step's forms and timed beside the byte bound -> its
    result."""
    import torch

    from tpubody_torch.models import hmr2

    M, D = SP_CHUNK * SP_TOKENS, SP_DIM
    x, branch, norm, _ = layernorm_inputs(M, D, dev, 30)
    res = {"shape": {"tokens": M, "dim": D, "branch": "bf16",
                     "out": "bf16"}}
    with torch.no_grad():
        res.update(hold_layernorm_forms(x, branch, norm))
        res["kernel_ms"] = time_ms(lambda: hmr2.add_layernorm(
            x, branch, norm, torch.bfloat16), 50, 5)
        res["last_block_ms"] = time_ms(lambda: hmr2.add_layernorm(
            x, branch, norm, torch.float32, keep_x=False), 50, 5)
    del x, branch, norm
    torch.cuda.empty_cache()
    nbytes = M * D * (4 + 2 + 4 + 2)
    res.update(gb=nbytes / 1e9, bound_ms=nbytes / PEAK_BYTES * 1e3)
    res["share"] = res["bound_ms"] / res["kernel_ms"]
    log(f"  add_layernorm at Sapiens' {M} x {D} ({res['gb']:.3f} GB): "
        f"{res['kernel_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms (share "
        f"{res['share']:.3f}); max diff {res['max_diff']:.3g}, unequal "
        f"share {res['unequal_share']:.3g}; float32 output without x_new "
        f"{res['last_block_ms']:.4f} ms, max diff "
        f"{res['last_block_max_diff']:.3g}")
    return res


SA_LAUNCHES = 2           # soft_argmax launches a decode: slices, merge
SA_XY_BAR, SA_CONF_BAR = 1e-3, 1e-5


def soft_argmax_inputs(B, h, w, K, dev, seed):
    """(B, h, w, K) float32 heatmap logits: -d^2 / (2 sigma^2) about a
    random centre a keypoint, sigma 1.5 to 6 pixels, plus noise."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.arange(h, device=dev).view(1, h, 1, 1).float()
    xx = torch.arange(w, device=dev).view(1, 1, w, 1).float()
    cy = torch.rand((B, 1, 1, K), generator=g, device=dev) * h
    cx = torch.rand((B, 1, 1, K), generator=g, device=dev) * w
    sigma = 1.5 + 4.5 * torch.rand((B, 1, 1, K), generator=g, device=dev)
    logits = torch.randn((B, h, w, K), generator=g, device=dev).mul_(0.5)
    return logits.sub_(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma ** 2))


def phase_soft_argmax(dev, step_launches):
    """soft_argmax (csrc/soft_argmax.cu) at the Sapiens decode's shape,
    SP_FRAMES frames of 256 x 192 heatmaps of 308 keypoints, held to its
    plain version (pose2d.soft_argmax) in float64 (x, y within SA_XY_BAR
    px, the confidence within SA_CONF_BAR; the float32 eager chain's
    distance reported beside it), the same bits on a second call, timed
    beside its byte bound and the plain version in float32 -> the kernel
    line's entry."""
    import torch

    from tpubody_torch.models import pose2d

    B, h, w, K = SP_FRAMES, 256, 192, 308
    logits = soft_argmax_inputs(B, h, w, K, dev, 30)
    res = {"name": "soft_argmax", "route": "cuda",
           "source": "tpubody_torch/csrc/soft_argmax.cu", "replaces": None,
           "shape": {"frames": B, "heatmap": [h, w], "keypoints": K},
           "bound_by": "bytes", "launches": step_launches}
    with torch.inference_mode():
        got = pose2d.soft_argmax_decode(logits, 4)
        again = pose2d.soft_argmax_decode(logits, 4)
        exact = pose2d.soft_argmax(logits.double(), 4)
        eager = pose2d.soft_argmax(logits, 4)
        for name, want in (("", exact), ("eager_", eager)):
            res[name + "max_xy_diff"] = float(
                (got[..., :2].double() - want[..., :2]).abs().max())
            res[name + "max_conf_diff"] = float(
                (got[..., 2].double() - want[..., 2]).abs().max())
        res["eager_vs_exact_max_xy_diff"] = float(
            (eager[..., :2].double() - exact[..., :2]).abs().max())
        res["same_bits"] = bool(torch.equal(got, again))
        del exact, eager
        torch.cuda.empty_cache()
        res["kernel_ms"] = time_ms(
            lambda: pose2d.soft_argmax_decode(logits, 4), 50, 5)
        res["plain_ms"] = time_ms(lambda: pose2d.soft_argmax(logits, 4), 5, 1)
    del logits, got, again
    torch.cuda.empty_cache()
    nbytes = B * h * w * K * 4
    res.update(ms=res["kernel_ms"], gb=nbytes / 1e9,
               bound_ms=nbytes / PEAK_BYTES * 1e3)
    res["share"] = res["bound_ms"] / res["kernel_ms"]
    log(f"  soft_argmax at ({B}, {h}, {w}, {K}) ({res['gb']:.3f} GB): "
        f"{res['kernel_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms (share "
        f"{res['share']:.3f}), plain version {res['plain_ms']:.3f} ms; max "
        f"diff x/y {res['max_xy_diff']:.3g} px, conf "
        f"{res['max_conf_diff']:.3g} (float64 plain version; float32 "
        f"{res['eager_max_xy_diff']:.3g} px, which is "
        f"{res['eager_vs_exact_max_xy_diff']:.3g} px from float64); same "
        f"bits twice {res['same_bits']}")
    if (res["max_xy_diff"] > SA_XY_BAR or res["max_conf_diff"] > SA_CONF_BAR
            or not res["same_bits"]):
        raise RuntimeError(f"soft_argmax is not its plain version: {res}")
    return res


def span_split(fn, iters):
    """Run ``fn`` ``iters`` times under ``torch.profiler`` -> {span name:
    device ms a call} from the program's own spans
    (``tpubody_torch.utils.profiling``), each name's spans summed within
    a call; the root span's name reads its whole call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpubody_torch.utils import profiling

    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    records = profiling.spans()
    profiling.clear()
    out = {}
    for r in records:
        out[r["name"]] = out.get(r["name"], 0.0) + r["device_ms"] / iters
    return out


def hq_convs(qparams):
    yield qparams["stem"]
    for stage in qparams["blocks"]:
        for blk in stage:
            yield from blk.values()


def dist_avatar_and_clip(workdir):
    """The phase 7 avatar and the first DIST_FRAMES frames of its clip ->
    (avatar, clip, avatar_path, clip_path) (the files for the workers)."""
    from tpubody_torch.io import motion

    avatar, avatar_path, clip_path = make_avatar_and_clip(workdir)
    clip = motion.read_amass(clip_path)
    clip = motion.MotionClip(clip.poses[:DIST_FRAMES],
                             clip.trans[:DIST_FRAMES], clip.fps)
    return avatar, clip, avatar_path, clip_path


def dist_render_kwargs():
    """The sharded and the two-process animation: 256^2 framing the
    humanoid as phase 23 does, full RGB frames to the writer."""
    return dict(size=DIST_SIZE, cam_t=np.array([0.0, 0.0, ASF_CAM_Z]),
                crop_transfer=False, i420_transfer=False)


def recorded_frames(fn):
    """Run fn with the MP4 writer recording -> the uint8 frames written
    (an empty array where it wrote none)."""
    from tpubody_torch.render import video

    frames = []
    write = video.VideoWriter.write

    def recording(self, frame):
        frames.append(video.quantize_u8(np.asarray(frame)).copy())
        write(self, frame)

    video.VideoWriter.write = recording
    try:
        fn()
    finally:
        video.VideoWriter.write = write
    return np.asarray(frames)


def phase_mesh(dev, workdir):
    """A single-process mesh of the card listed twice."""
    import torch

    from tpubody_torch import bench, native
    from tpubody_torch.dist import mesh as mesh_lib
    from tpubody_torch.fit import smplify
    from tpubody_torch.fit import vposer as vposer_lib
    from tpubody_torch.models import humanoid, smpl
    from tpubody_torch.pipelines import animate, serving

    mesh = mesh_lib.make_mesh(devices=[dev, dev])
    launches = dict.fromkeys(native.LAUNCHES, 0)

    def count(fn):
        native.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k, v in native.LAUNCHES.items():
            launches[k] += v
        return out, dict(native.LAUNCHES)

    # LBS at F=512, sharded against unsharded, fused_lbs's gate.
    body = humanoid.humanoid(n_joints=24, n_verts=6890, device=dev)
    rng = np.random.default_rng(25)
    _, _, _, _, (poses, beta) = lbs_inputs(body, MESH_LBS_FRAMES, rng, True,
                                           True, False)
    whole = smpl.forward_batch_verts(body, poses, beta, pose_is_rotmat=True)

    def sharded_lbs():
        bodies = mesh_lib.replicate(body, mesh)
        p, b = mesh_lib.shard_frames((poses, beta), mesh)
        outs = []
        for m, d, ps, bs in zip(bodies, mesh.devices, p.shards, b.shards):
            with mesh_lib.on_device(d):
                outs.append(smpl.forward_batch_verts(m, ps, bs,
                                                     pose_is_rotmat=True))
        return torch.cat(outs)

    got, lbs_launches = count(sharded_lbs)
    rel = ((got - whole).abs().max() / whole.abs().max()).item()
    log(f"  LBS F={MESH_LBS_FRAMES} over 2 shards vs unsharded: rel "
        f"{rel:.3e} (fused_lbs's bf16x3 gate 1e-4); launches {lbs_launches}")
    if rel >= 1e-4 or lbs_launches["fused_lbs"] != 2:
        raise RuntimeError("sharded LBS disagrees with unsharded")

    # The f32 serving step behind a sharded server.
    step32 = serving.hmr_smpl_step(dtype=torch.float32, device=dev)
    images = np.random.default_rng(26).normal(
        size=(8, 224, 224, 3)).astype(np.float32)
    results, batches, served, snap = serve_requests(
        step32, images, (2, 8), dev, mesh_lib.frames_sharding(mesh))
    for k, v in served.items():
        launches[k] += v
    with torch.inference_mode():
        v_all, c_all = step32(images)
    err = max(max(float(np.abs(v - v_all[i].cpu().numpy()).max()),
                  float(np.abs(c - c_all[i].cpu().numpy()).max()))
              for i, (v, c) in enumerate(results))
    log(f"  f32 step behind InferenceServer(sharding) vs unsharded: "
        f"max|d|={err:.3e} (bar {CPU_HMR_ATOL}); batches "
        f"{[len(b) for b, _ in batches]} (shards); launches {served}")
    if err > CPU_HMR_ATOL or served["fused_lbs"] == 0:
        raise RuntimeError("the sharded server disagrees with unsharded")

    # fit_frames over the mesh against unsharded.
    model = bench.fit_model(6890, seed=0, device=dev)
    decoder = vposer_lib.create_decoder(0, device=dev)
    truth = bench.fit_truth(model, decoder, MESH_FIT_N, seed=12)
    kps = bench.fit_keypoints(bench.project_fit(model, **truth), seed=12)
    center = np.full(2, bench.FIT_SIZE / 2.0, np.float32)
    cfg = smplify.FitConfig(maxiters=MESH_FIT_ITERS)
    t0 = time.perf_counter()
    plain = smplify.fit_frames(model, kps, center, cfg, dec_params=decoder,
                               device=dev)
    t1 = time.perf_counter()
    sharded, fit_launches = count(lambda: smplify.fit_frames(
        model, kps, center, cfg, dec_params=decoder, mesh=mesh, device=dev))
    t2 = time.perf_counter()
    d = hold_fits(sharded, plain, f"fit_frames over 2 shards vs unsharded, "
                  f"{MESH_FIT_N} frames at {MESH_FIT_ITERS} iterations")
    log(f"  fit {t1 - t0:.3f} s unsharded, {t2 - t1:.3f} s sharded")

    # animate_video over the mesh against unsharded.
    avatar, clip, _, _ = dist_avatar_and_clip(workdir)
    kw = dist_render_kwargs()
    plain = [recorded_frames(lambda: animate.animate_video(
        avatar, clip, os.path.join(workdir, "plain.mp4"), device=dev, **kw))
        for _ in range(2)]
    mesh_frames, anim_launches = count(lambda: recorded_frames(
        lambda: animate.animate_video(
            avatar, clip, os.path.join(workdir, "mesh.mp4"), mesh=mesh,
            device=dev, **kw)))
    log(f"  animate_video(mesh): {mesh_frames.shape[0]} frames, launches "
        f"{anim_launches}")
    again = frames_agree(plain[1], plain[0], "unsharded run vs unsharded")
    agree = frames_agree(mesh_frames, plain[0],
                         "animate_video(mesh) vs unsharded")
    if (mesh_frames.shape[0] != DIST_FRAMES
            or anim_launches["fused_raster"] == 0):
        raise RuntimeError("animate_video over the mesh failed its gates")
    return dict(lbs_rel=rel, serve_err=err, fit=d, frames=agree,
                frames_run_to_run=again, launches=launches,
                card=card_line())


def phase_multihost(dev, workdir):
    """Two gloo processes on the one card (NCCL admits one rank a GPU)."""
    import socket

    from tpubody_torch.pipelines import animate

    avatar, clip, _, _ = dist_avatar_and_clip(workdir)
    single = recorded_frames(lambda: animate.animate_video(
        avatar, clip, os.path.join(workdir, "single.mp4"), device=dev,
        **dist_render_kwargs()))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-worker",
         str(rank), "2", str(port), workdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=DIST_TIMEOUT_S)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, text in enumerate(logs):
        for line in text.strip().splitlines()[-6:]:
            log(f"  [rank {rank}] {line}")
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"a multihost worker failed: "
                           f"{[p.returncode for p in procs]}")
    info = [json.load(open(os.path.join(workdir, f"mh_{r}.json")))
            for r in range(2)]
    frames = np.load(os.path.join(workdir, "mh_frames_0.npy"))
    import cv2
    cap = cv2.VideoCapture(os.path.join(workdir, "mh.mp4"))
    in_mp4 = 0
    while cap.read()[0]:
        in_mp4 += 1
    cap.release()
    log(f"  2 processes: slices {[i['slice'] for i in info]}, gather ok "
        f"{[i['gather_ok'] for i in info]}, mean ok "
        f"{[i['mean_ok'] for i in info]}; launches "
        f"{[i['launches'] for i in info]}; rank 0 wrote {frames.shape[0]} "
        f"frames ({in_mp4} in the MP4)")
    agree = frames_agree(frames, single, "rank 0's frames vs one process")
    if (not all(i["gather_ok"] and i["mean_ok"] for i in info)
            or any(i["launches"]["fused_raster"] == 0 for i in info)
            or in_mp4 != DIST_FRAMES
            or [i["slice"] for i in info] != [[0, 8], [8, 16]]):
        raise RuntimeError("the two-process run failed its gates")
    launches = {k: sum(i["launches"][k] for i in info)
                for k in info[0]["launches"]}
    return dict(launches=launches, per_rank=[i["launches"] for i in info],
                frames=agree, wall_s=[i["wall_s"] for i in info],
                card=card_line())


def multihost_worker(rank, world, port, workdir) -> int:
    """One rank of phase 26: gloo on the shared card."""
    import torch
    import torch.distributed as dist

    from tpubody_torch import native
    from tpubody_torch.dist import multihost
    from tpubody_torch.io import motion
    from tpubody_torch.mesh import rigging
    from tpubody_torch.pipelines import animate

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo",
                         timeout_s=120.0)
    mesh = multihost.global_mesh(device=dev)
    full = np.arange(24 * 5 * 3, dtype=np.float32).reshape(24, 5, 3)
    start, stop = multihost.process_frame_slice(24)
    garr = multihost.global_frames_array(full[start:stop], mesh)
    local = garr.gather()
    total = local.sum(dtype=torch.float64).cpu()
    dist.all_reduce(total)
    gathered = multihost.gather_frames_to_host(local * 2.0 + 1.0)
    gather_ok = bool(np.array_equal(gathered, full * 2.0 + 1.0))
    mean_ok = abs(float(total) / full.size - float(full.mean())) < 1e-9

    avatar = rigging.load_avatar(os.path.join(workdir, "avatar.pkl"))
    clip = motion.read_amass(os.path.join(workdir, "clip.npz"))
    clip = motion.MotionClip(clip.poses[:DIST_FRAMES],
                             clip.trans[:DIST_FRAMES], clip.fps)
    native.reset_launches()
    t0 = time.perf_counter()
    frames = recorded_frames(lambda: animate.animate_video(
        avatar, clip, os.path.join(workdir, "mh.mp4"), multihost=True,
        device=dev, **dist_render_kwargs()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rank == 0:
        np.save(os.path.join(workdir, "mh_frames_0.npy"), frames)
    elif len(frames):
        raise RuntimeError("a rank other than 0 wrote frames")
    s, e = multihost.process_frame_slice(DIST_FRAMES)
    with open(os.path.join(workdir, f"mh_{rank}.json"), "w") as f:
        json.dump(dict(slice=[s, e], gather_ok=gather_ok, mean_ok=mean_ok,
                       launches=dict(native.LAUNCHES), wall_s=wall), f)
    dist.destroy_process_group()
    print(f"rank {rank}: gather {gather_ok}, mean {mean_ok}, launches "
          f"{dict(native.LAUNCHES)}, {wall:.3f} s", flush=True)
    return 0


# -- slice G: the vertex-normal sum in a fixed order, the last functions ----
CLOSURE_FRAMES = 8        # a video block
VN_CPU_ATOL = 1e-6        # vertex_normals, card vs CPU (unit vectors)
RESIZE_REL = 1e-5         # resize_image card vs CPU, of the image's range
UNPOSE_FRAMES = 512
VN_ITERS = 50


def vertex_normals_index_add(verts, faces):
    """The port's earlier vertex normals (three ``index_add_`` passes,
    float atomics on the card, then ``torch.linalg.norm``): the "before"
    of phase 27, kept here only."""
    import torch

    tri = faces.to(torch.int64)
    v0, v1, v2 = (verts[..., tri[:, k], :] for k in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.index_add_(-2, tri[:, k], fn)
    return vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True),
                            min=1e-12)


def hold_vertex_normals(name, verts, faces):
    """vertex_normals on a block of frames on the card: two runs and the
    prebuilt-table form bit-equal, the block equal to its frames one at a
    time, the card within VN_CPU_ATOL of the CPU; the old index_add_ form's
    run-to-run spread; both forms timed in turns (old, new, new, old) on
    the same inputs, the new one with the table prebuilt as the video path
    holds it, and the table's build."""
    import torch

    from tpubody_torch.render import raster

    V = int(verts.shape[-2])
    t0 = time.perf_counter()
    inc = raster.incidence_table(faces, V)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_faces = int(faces.shape[0])
    deg = torch.bincount(faces.reshape(-1).to(torch.int64), minlength=V)
    hist = torch.bincount(deg).cpu().numpy()
    a = raster.vertex_normals(verts, faces, inc)
    b = raster.vertex_normals(verts, faces, inc)
    c = raster.vertex_normals(verts, faces)
    frames = all(torch.equal(a[i], raster.vertex_normals(verts[i], faces, inc))
                 for i in range(verts.shape[0]))
    cpu = raster.vertex_normals(verts.cpu(), faces.cpu())
    cpu_err = float((a.cpu() - cpu).abs().max())
    old = [vertex_normals_index_add(verts, faces) for _ in range(2)]
    old_spread = float((old[0] != old[1]).float().mean())
    old_vs_new = float((old[0] - a).abs().max())
    times = {}
    for form in ("old", "new", "new", "old"):
        fn = ((lambda: vertex_normals_index_add(verts, faces)) if form == "old"
              else (lambda: raster.vertex_normals(verts, faces, inc)))
        times.setdefault(form, []).append(time_ms(fn, iters=VN_ITERS))
    res = dict(frames=int(verts.shape[0]), vertices=V, faces=n_faces,
               largest_degree=int(inc.offsets.diff().max()),
               degree_counts={int(d): int(n) for d, n in enumerate(hist)
                              if n},
               runs_equal=torch.equal(a, b) and torch.equal(a, c),
               batch_equals_frames=frames, cpu_max_abs=cpu_err,
               index_add_share_differing=old_spread,
               index_add_vs_new_max_abs=old_vs_new,
               new_ms=times["new"], index_add_ms=times["old"],
               table_build_s=build_s)
    log(f"  vertex_normals, {name}: {json.dumps(res)}")
    if not (res["runs_equal"] and frames) or cpu_err > VN_CPU_ATOL:
        raise RuntimeError(f"vertex_normals on {name}: two runs or a batch "
                           f"and its frames differ, or the card is more than "
                           f"{VN_CPU_ATOL} from the CPU")
    return res


def phase_closure(dev, workdir, avatar=None):
    """The vertex normals' fixed-order sum on a video block and on the
    stitched avatar, one video block rendered twice through fused_raster,
    and the last public functions card against CPU."""
    import torch

    from tpubody_torch import native
    from tpubody_torch.image import ops as image_ops
    from tpubody_torch.io import motion
    from tpubody_torch.mesh import rigging
    from tpubody_torch.models import humanoid, params, smpl
    from tpubody_torch.pipelines import animate, demo, reconstruct as rec
    from tpubody_torch.render import video

    out = {}
    setup_avatar, _, clip_path = make_avatar_and_clip(workdir)
    clip = motion.read_amass(clip_path)
    cam_t = np.array([0.0, 0.0, 2.5])
    posed = rigging.animate(setup_avatar, clip.poses[:CLOSURE_FRAMES],
                            clip.trans[:CLOSURE_FRAMES], device=dev)
    cam = torch.as_tensor(cam_t, dtype=torch.float32, device=dev)
    faces = torch.as_tensor(np.asarray(setup_avatar.faces, np.int32),
                            device=dev)
    out["video_block"] = hold_vertex_normals(
        f"{CLOSURE_FRAMES} frames x 6890 vertices",
        video._to_camera(posed, cam), faces)

    if avatar is None:
        fixture = os.path.join(workdir, "closure_fixture")
        smplh, smpl_m = demo.make_fixture(fixture, size=RECON_SIZE,
                                          verts=WHOLE_VERTS, device=dev)
        front, back, mask, fit = rec.load_test_dir(fixture)
        avatar = rec.reconstruct(front, back, mask, fit, smplh, smpl_m,
                                 replace_hands=True, cache=False,
                                 device=dev).avatar
    posed_a = rigging.animate(avatar, clip.poses[:CLOSURE_FRAMES],
                              clip.trans[:CLOSURE_FRAMES], device=dev)
    faces_a = torch.as_tensor(np.asarray(avatar.faces, np.int32), device=dev)
    out["avatar"] = hold_vertex_normals(
        f"the stitched avatar, {CLOSURE_FRAMES} frames",
        video._to_camera(posed_a, cam), faces_a)

    # One video block twice through fused_raster, as animate_video renders
    # it (the table built once by the block renderer).
    render_block, _, _ = animate._block_renderer(
        setup_avatar, None, cam_t, VIDEO_SIZE, video.DEFAULT_FOCAL, None,
        CLOSURE_FRAMES, device=dev)
    native.reset_launches()
    first = render_block(posed)
    second = render_block(posed)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    out["video_frames_equal"] = torch.equal(first, second)
    log(f"  one {CLOSURE_FRAMES}-frame block at {VIDEO_SIZE}^2 rendered "
        f"twice: frames {'equal' if out['video_frames_equal'] else 'DIFFER'}"
        f"; launches {launches}")
    if not out["video_frames_equal"] or launches["fused_raster"] < 2:
        raise RuntimeError("two renders of one video block differ")

    # The last public functions, card against CPU.
    rng = np.random.default_rng(27)
    resize = {}
    for tag, hw in (("shrink", (300, 260)), ("grow", (120, 90))):
        img = rng.uniform(0, 255, size=hw + (3,)).astype(np.float32)
        for method in ("nearest", "linear", "bilinear", "triangle", "cubic",
                       "bicubic", "lanczos3", "lanczos5"):
            g = image_ops.resize_image(img, 224, 224, method, device=dev)
            c = image_ops.resize_image(img, 224, 224, method, device="cpu")
            d = float((g.cpu() - c).abs().max())
            resize[f"{method}_{tag}"] = d
            bar = 0.0 if method == "nearest" else RESIZE_REL * 255.0
            if d > bar or g.shape != (224, 224, 3):
                raise RuntimeError(f"resize_image {method} {tag}: card vs "
                                   f"CPU {d} (bar {bar})")
    img = rng.uniform(0, 255, size=(500, 500, 3)).astype(np.float32)
    crop = {route: image_ops.scale_and_crop(img, (250.0, 250.0), 2.5, 224,
                                            host=False, device=route)
            for route in (dev, "cpu")}
    crop_err = float(np.abs(crop[dev] - crop["cpu"]).max())
    log(f"  resize_image card vs CPU, max|d| on [0, 255] (bar nearest 0, "
        f"else {RESIZE_REL} of the range): {json.dumps(resize)}; "
        f"scale_and_crop(host=False) {crop_err:.3e}")
    if crop_err > RESIZE_REL * 255.0:
        raise RuntimeError("scale_and_crop(host=False) card vs CPU")

    body = humanoid.humanoid(n_joints=24, n_verts=6890, device=dev)
    poses, beta, trans = (
        torch.as_tensor(rng.normal(scale=sc, size=(UNPOSE_FRAMES,) + shape),
                        dtype=torch.float32, device=dev)
        for sc, shape in ((0.3, (24, 3)), (0.5, (10,)), (1.0, (3,))))
    state = smpl.forward_batch(body, poses, beta, trans)
    back = smpl.unpose(body, state.verts, state, trans)
    torch.cuda.synchronize()
    back_cpu = smpl.unpose(body.to("cpu"), state.verts.cpu(),
                           smpl.BodyState(*(x.cpu() for x in state)),
                           trans.cpu())
    unpose_cpu = float((back.cpu() - back_cpu).abs().max())
    round_trip = float((back - state.v_posed).abs().max())
    npz = os.path.join(workdir, "closure_model.npz")
    params.save_npz(npz, body)
    loaded = params.load_npz(npz, device=dev)
    npz_equal = all(torch.equal(getattr(loaded, k), getattr(body, k))
                    for k in ("v_template", "shapedirs", "posedirs",
                              "j_regressor", "weights"))
    objs = []
    for name, (v, f) in (("card", (state.verts[0], faces)),
                         ("cpu", (state.verts[0].cpu(), setup_avatar.faces))):
        path = os.path.join(workdir, f"closure_{name}.obj")
        smpl.write_obj(path, v, f)
        with open(path, "rb") as fh:
            objs.append(fh.read())
    log(f"  unpose at {UNPOSE_FRAMES} x 6890: card vs CPU {unpose_cpu:.3e}, "
        f"round trip {round_trip:.3e} (bars {CPU_VERT_ATOL}); save_npz from "
        f"the card round-trips {npz_equal}; write_obj from the card "
        f"byte-equal {objs[0] == objs[1]}")
    if (unpose_cpu > CPU_VERT_ATOL or round_trip > CPU_VERT_ATOL
            or not npz_equal or objs[0] != objs[1]):
        raise RuntimeError("unpose, save_npz or write_obj failed on the card")
    out.update(resize_card_vs_cpu=resize, scale_and_crop_card_vs_cpu=crop_err,
               unpose_card_vs_cpu=unpose_cpu, unpose_round_trip=round_trip,
               launches=launches, card=card_line())
    return out


ALL_PHASES = ("lbs", "serve", "raster", "video", "oracle", "vtiming",
              "zbuffer", "reconstruct", "rtiming", "stage", "backbone",
              "fit", "fitserve", "ftiming", "rwhole", "demo", "train",
              "remat", "pose2d", "asf", "quant", "mesh", "multihost",
              "closure", "layernorm", "multihmr", "sapiens")
EXTRA_PHASES = ("vprofile",)


def main() -> int:
    import torch

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--multihost-worker", nargs=4, default=None,
                    metavar=("RANK", "WORLD", "PORT", "DIR"),
                    help=argparse.SUPPRESS)   # one process of phase 26
    args = ap.parse_args()
    if args.multihost_worker:
        rank, world, port, workdir = args.multihost_worker
        return multihost_worker(int(rank), int(world), int(port), workdir)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    full = set(phases) == set(ALL_PHASES)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    from tpubody_torch import native

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    t0 = time.perf_counter()
    lib = native.build()
    log(f"  built {lib} in {time.perf_counter() - t0:.2f} s")
    for path in sorted(glob.glob(os.path.join(os.path.dirname(lib), "*.log"))):
        with open(path) as f:     # nvcc -Xptxas -v: registers, spills
            for line in f:
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    log(f"  {os.path.basename(path)}: {line.strip()}")
    native.library()

    kernels = []
    if "lbs" in phases:
        log("phase 2: fused_lbs vs its plain version")
        body, main_err = phase_kernels(dev)
    if "serve" in phases:
        log("phase 3: main path through InferenceServer -> hmr_smpl_step")
        launches, _ = phase_serve(dev)
    if "lbs" in phases and "serve" in phases:
        log("phase 5: fused_lbs timing")
        kernels.append(phase_timing(body, launches, main_err))

    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if set(phases) & {"raster", "video", "oracle", "vtiming",
                          "vprofile"}:
            setup = VideoSetup(dev, workdir)
        raster_err = None
        if "raster" in phases:
            log("phase 6: fused_raster vs its plain version")
            raster_err = phase_raster_kernels(setup)
        if "video" in phases:
            log("phase 7: video path through animate_from_amass at "
                f"{VIDEO_SIZE}^2, {VIDEO_FRAMES} frames")
            video_res = phase_video(setup, workdir)
        if "oracle" in phases:
            log("phase 8: tiled renderer vs the fragment renderer")
            phase_oracle(setup)
        if "vtiming" in phases and "video" in phases:
            log("phase 9: video timing")
            kernels.append(phase_video_timing(setup, workdir, video_res,
                                              raster_err))
        if "vprofile" in phases:
            log("extra phase: profile of the video path")
            phase_video_profile(setup, workdir)
        if set(phases) & {"zbuffer", "reconstruct", "rtiming"}:
            recon = ReconSetup(dev, RECON_SIZE)
        zbuffer_diffs = None
        if "zbuffer" in phases:
            log("phase 10: zbuffer vs its plain version")
            zbuffer_diffs = phase_zbuffer(recon)
        if "reconstruct" in phases:
            log(f"phase 11: reconstruct path at {RECON_SIZE}^2, 6890 "
                f"vertices")
            recon_res = phase_reconstruct(recon, workdir)
        if "rtiming" in phases and "reconstruct" in phases:
            log("phase 12: reconstruct timing")
            entry, fused24 = phase_recon_timing(recon, workdir, recon_res,
                                                zbuffer_diffs)
            for k in kernels:
                if k["name"] == "fused_raster":
                    k["body_map_passes"] = fused24
            kernels.append(entry)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    if "stage" in phases:
        log("phase 13: fused_stage vs its plain version")
        phase_stage(dev)
    if "backbone" in phases:
        log(f"phase 14: the fused stage on the full-width backbone, batch "
            f"{BACKBONE_BATCH}")
        kernels.append(phase_backbone(dev))

    fit_res = None
    if set(phases) & {"fit", "fitserve", "ftiming"}:
        fit_model, fit_decoder = fit_setup(dev)
        fit_dir = tempfile.mkdtemp(prefix="chip_smoke_fit_")
        try:
            if "fit" in phases:
                log(f"phase 15: the fitting path, {FIT_N} frames at "
                    f"FitConfig() defaults")
                fit_res = phase_fit(dev, fit_model, fit_decoder, fit_dir)
                for k in kernels:
                    k["launches_fit"] = fit_res["launches"][k["name"]]
        finally:
            shutil.rmtree(fit_dir, ignore_errors=True)
        if "fitserve" in phases:
            log("phase 16: fit_smplh_step behind InferenceServer")
            phase_fit_serve(dev, fit_model, fit_decoder)
        if "ftiming" in phases:
            log("phase 17: fit timing")
            phase_fit_timing(dev, fit_model, fit_decoder, fit_res)

    whole_avatar = None
    if set(phases) & {"rwhole", "demo"}:
        whole_dir = tempfile.mkdtemp(prefix="chip_smoke_whole_")
        try:
            if "rwhole" in phases:
                log(f"phase 18: the whole reconstruct() at {RECON_SIZE}^2 "
                    f"with the hand graft")
                whole, whole_avatar = phase_reconstruct_whole(dev,
                                                              whole_dir)
                log(json.dumps({"reconstruct_whole": whole}))
                for k in kernels:
                    k["launches_reconstruct"] = whole["launches"][k["name"]]
            if "demo" in phases:
                log(f"phase 19: run_demo at {DEMO_SIZE}^2, {DEMO_FRAMES} "
                    f"frames")
                demo_res = phase_demo(dev, whole_dir)
                for k in kernels:
                    k["launches_demo"] = demo_res["launches"][k["name"]]
        finally:
            shutil.rmtree(whole_dir, ignore_errors=True)

    if set(phases) & {"train", "remat", "pose2d", "asf"}:
        train_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
        try:
            if set(phases) & {"train", "remat"}:
                train_setup = TrainSetup(dev)
            if "train" in phases:
                log(f"phase 20: train-hmr at its defaults (--render "
                    f"{TRAIN_RENDER}, batch {TRAIN_BATCH}, {TRAIN_SIZE}^2)")
                train = phase_train(dev, train_dir, train_setup)
                log(json.dumps({"train": train, "card": card_line()}))
                for k in kernels:
                    k["launches_train"] = train["launches"][k["name"]]
            if "remat" in phases:
                log("phase 21: remat against none")
                remat = phase_remat(dev, train_setup)
                log(json.dumps({"remat": remat, "card": card_line()}))
                for k in kernels:
                    k["launches_remat"] = remat["launches"][k["name"]]
            if "pose2d" in phases:
                log("phase 22: train-pose2d and detect-pose")
                pose = phase_pose2d(dev, train_dir)
                log(json.dumps({"pose2d": pose, "card": card_line()}))
                for k in kernels:
                    k["launches_pose2d"] = pose["launches"][k["name"]]
            if "asf" in phases:
                log(f"phase 23: animate an .amc clip at {ASF_SIZE}^2")
                asf = phase_asf(dev, train_dir)
                log(json.dumps({"asf": asf, "card": card_line()}))
                for k in kernels:
                    k["launches_asf"] = asf["launches"][k["name"]]
        finally:
            shutil.rmtree(train_dir, ignore_errors=True)

    if "quant" in phases:
        log(f"phase 24: int8 HMR serving (hmr_smpl_step(quantize=True)), "
            f"batch {QUANT_BATCH}")
        quant = phase_quant(dev)
        log(json.dumps({"quant": quant}))
        for k in kernels:
            k["launches_quant"] = quant["launches"][k["name"]]
        kernels.append(quant["requant"])
    if set(phases) & {"mesh", "multihost"}:
        dist_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_")
        try:
            if "mesh" in phases:
                log("phase 25: a mesh of the card listed twice")
                mesh_res = phase_mesh(dev, dist_dir)
                log(json.dumps({"mesh": mesh_res}))
                for k in kernels:
                    k["launches_mesh"] = mesh_res["launches"][k["name"]]
            if "multihost" in phases:
                log("phase 26: two gloo processes on the card")
                mh = phase_multihost(dev, dist_dir)
                log(json.dumps({"multihost": mh}))
                for k in kernels:
                    k["launches_multihost"] = mh["launches"][k["name"]]
        finally:
            shutil.rmtree(dist_dir, ignore_errors=True)

    if "closure" in phases:
        closure_dir = tempfile.mkdtemp(prefix="chip_smoke_closure_")
        try:
            log("phase 27: vertex normals in a fixed order, the last public "
                "functions")
            t0 = time.perf_counter()
            closure = phase_closure(dev, closure_dir, whole_avatar)
            closure["phase_s"] = time.perf_counter() - t0
            log(json.dumps({"closure": closure}))
            for k in kernels:
                k["launches_closure"] = closure["launches"][k["name"]]
        finally:
            shutil.rmtree(closure_dir, ignore_errors=True)

    if "layernorm" in phases:
        log("phase 28: add_layernorm on the HMR 2.0 step and at its "
            "encoder's shape, then with LayerScale at Multi-HMR's")
        ln, hmr2_launches = phase_layernorm(dev)
        for k in kernels:
            k["launches_hmr2"] = hmr2_launches[k["name"]]
        kernels.append(ln)
    if "multihmr" in phases:
        log(f"phase 29: the Multi-HMR step, {MH_FRAMES} frames of 896^2")
        mh = phase_multihmr(dev)
        log(json.dumps({"multihmr": mh, "card": card_line()}))
        for k in kernels:
            k["launches_multihmr"] = mh["launches"][k["name"]]

    if "sapiens" in phases:
        log(f"phase 30: Sapiens' 60-wide heads by two routes, then the "
            f"keypoint step, {SP_FRAMES} frames of 1024^2")
        sp = phase_sapiens(dev)
        log(json.dumps({"sapiens": sp, "card": card_line()}))
        kernels.append(sp["soft_argmax"])
        for k in kernels:
            k["launches_sapiens"] = sp["launches"][k["name"]]
            if k["name"] == "add_layernorm":
                k["sapiens"] = sp["layernorm"]

    log(f"chip_smoke: the whole script took "
        f"{time.perf_counter() - t_start:.1f} s")
    smi = card_line()
    if not full:
        log(f"phases {phases} passed on {smi} (subset: no result line)")
        return 0
    for k in kernels:
        k["card"] = smi
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
