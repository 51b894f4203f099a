#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Six main paths run at full width (640x480, 1000 features), all with the
default configuration (subpixel refinement on): the tracking step
(`tracking_forward_step`, 1024 local-map points); the tracker's
per-frame pair for each sensor: the motion stage against 1024 last-frame
points (`fused_motion_track_packed` for a monocular frame,
`fused_stereo_motion_track_packed` for a stereo pair,
`fused_rgbd_motion_track_packed` for an image and its depth map), then
`fused_local_map_track` against a 2048-row candidate table; and the
System (`slam/system.py`, synchronous local mapping, the bundled
vocabulary: every keyframe into the keyframe database and through the
loop closer, which needs more than 10 keyframes to look for a loop) over a
30-frame RGB-D sequence (`System.track_rgbd`) and a 30-frame stereo
sequence (`System.track_stereo`) of the synthetic scene (500 landmarks,
seed 5, 0.05 m a frame); and the monocular System (`System.track_monocular`,
two-view initialization at 2000 features, its global BA) over a 40-frame
lateral sweep (500 landmarks, seed 3) and over the same sweep with a
kidnap (frames 22-26 a flat grey image; relocalization without a
vocabulary). The JAX package's other three routes follow the Systems: the
main-path image through `extract_features` on the per-level route
(ORB_TPU_FORCE_PACKED=0, patch form: K1 once a level, the standalone K4
twice a level), the RGB-D sequence through a System with the staged
mapper (ORB_TPU_STAGED_MAPPER=1: K7 under the epipolar band once per
neighbour pair, K6 once per fuse target), and the native C++ map core
(models/native_core.py, built with g++) on that System's map. The loop phase runs the monocular System with the bundled
vocabulary (the keyframe database, loop closing after local mapping) over
tests/test_loop_pipeline.py's 132-frame ring survey at that test's 400x300
and 500 features (at 640x480 and 1000 features the JAX System never
initializes on it), and over the kidnap sequence, which it relocalizes
through the database's BoW candidates. Then three paths of the
asynchronous System and the localization-only mode, at full width: a
localization session (an RGB-D System maps the first 15 frames of an RGB-D
survey along the ring survey's path, a second loads the saved map,
`activate_localization_mode()`, and tracks frames 7-39, past the mapped
sectors, in visual odometry from about frame 30); the RGB-D sequence
through an asynchronous System (`async_mapping=True`: mapping and loop
closing on a worker thread, global BA on its own, each on its own CUDA
stream), then `shutdown()`; and tests/test_async_pipeline.py's global BA
stress over the monocular sweep, asynchronous (every global BA held in
flight and relaunched every 5 frames). Last, the datasets phase: the
port's writers lay out four mini datasets at the published settings of
the reference's Examples/*.yaml in a temporary directory (KITTI 00-02
stereo, 1241x376 and 2000 features, 60 frames of the KITTI-class drive
under CAMERA_PHOTO; TUM fr1 RGB-D, the RGB-D System's scene through
TUM1's lens, 16-bit depth; EuRoC stereo, raw pairs through the published
cameras and mounting rotations, rectified by the driver; TUM fr1
monocular, the sweep through TUM1's lens), and the port's driver
(examples/run_dataset.py) runs each from disk, as a user runs it. Then the
online phase: the RGB-D and stereo sequences published over loopback TCP
(examples/run_live.publish_frames) into the live driver
(run_live.run_live over a SocketSource) with no drops; the RGB-D sequence
published paced at 30 and 10 frames/s into run_live with its drop policy
through the default asynchronous System, the viewer thread (slam/viewer.py,
PNG streaming) off and on in turns, each run inside utils/profiling's
device_trace; the AR demo (examples/run_ar.run: the monocular System at
400x300 and 1000 features, plane anchoring by slam/ar.py); and the
online entry points' command lines, each in a subprocess, the five at
once: `python -m orb_slam2_commit_tpu_torch.examples.run_live --sim
--frames 30`, the live driver with `--listen` (this process publishes the
RGB-D sequence to it) and with `--watch` (a directory of the sequence's
PNGs), `run_ar` and `run_synthetic_mono`. Last, the map-scale phase: (a)
global BA as the loop closer runs it (`LoopCloser.run_global_ba`, 5
iterations, PCG) on the real map snapshot
`orb_slam2_commit_tpu/data/real_map_850m.npz` (156 keyframes, 7,781
points of the JAX package's 850 m stereo drive, loaded by the port's
`load_map`), plain (ORB_DISTRIBUTED_GBA=0) and sharded over a process
group of one rank (ORB_DISTRIBUTED_GBA=1: parallel/multihost.py's NCCL
world of one, parallel/distributed_ba.py), each twice, and once on the
CPU (in float32 and in float64): each route's runs bit-identical, the
sharded route bit-identical to the plain one, and so the point-sharded
solve (distributed_bundle_adjust_points, which the loop closer does not
take) on the same problem, twice; the card's keyframe
centres, rotations and points each within real_map_bound of the CPU's
(between the CPU's float32-vs-float64 spread and how far the solve moved
the map, so a solve that did nothing fails), each route's wall time, ms an
LM iteration and device idle share printed; (b) tests/test_sim3.py's
300-vertex drifted loop through `optimize_sim3_graph(solver="auto")`
(block-Jacobi PCG above 256 vertices) in float64, that test's precision,
twice on the card (eager, then replayed: `optimize_sim3_graph_jit`) and
once on the CPU: the largest centre error under its 0.10 m gate, the
runs bit-identical, card vs CPU within
tests/test_torch_sim3.py's 2e-3; and in float32, the System's precision,
over the two steps its LM accepts there, card vs CPU within the same
2e-3; (c) meanwhile, both drives' command lines (`python -m
orb_slam2_commit_tpu_torch.examples.scale_drive --stereo --frames=40 ...`
and `...multiloop_drive`, at the full drives' settings over their first
40 frames' arc): exit 0, a summary with every key of the JAX drivers',
both global BA routes timed (neither raised), the kidnap probe
relocalized without an error, every kernel of the stereo per-frame path launched (the
drive's counts).

Phases (any failure exits non-zero and prints no result line):
  1. the card: name, count, torch/CUDA versions, nvidia-smi name + power limit;
  2. build every kernel's library from csrc/ (one nvcc per source, all at
     once) and print nvcc's register, stack and spill lines;
  3. each kernel against its plain PyTorch version on the card, on the
     tensors the main paths give it (recorded from one run of a path),
     K1 and K2 also on a canvas with pad rows and columns (K2 also with
     every cell low), K3 in its map form also on that canvas's score map,
     on a width that is not a multiple of 4 and with 30-pixel cells, and
     in its row form on the main map's cell matrix, the fused K4 + K5
     launch (both windows bit for bit, offsets within K5_TOL) also on the
     320x240 canvas and on centres at and past every edge
     (interop.patch_edge_yx), the standalone K4 (P = 31, 39 and 17) and K5
     on the same inputs, K6 also on the CPU
     tests' cases with one window and with two, with a narrower second
     window, with every row invalid and past one shared-memory chunk, K7
     on the stereo band also on the CPU tests' band cases (one on every
     edge of the band) and K7 under a caller's mask on the stereo pair's
     band masks; K7 under each candidate test (launched twice, and also
     against K7 under the mask its plain version builds): under the
     validity flags on the System's reference-keyframe matcher's input and
     on relocalization's candidates (a batch axis, the column table
     shared), under the epipolar band on the System's triangulation calls
     (a batch axis, the row table shared), under the window on the
     monocular initialization's [2000, 2000] calls, each batched call also
     with an empty problem and with every row empty, and on interop's
     CANDIDATE_CASES and CANDIDATE_CARD_CASES (2000 x 1000 with B = 8 and
     either side shared, 5000 columns, ties, rows with no candidate and
     with one, the tests' exact edges, degenerate epipolar lines, NaN
     coordinates under clear flags); K6 with a batch axis on the System's
     fuse problems (also with an empty problem and with every row empty);
     at the dataset paths' shapes, on the calls recorded in each dataset
     cell's first --sync run through the driver, in the KITTI cell's
     first 5 frames through kitti-mono and in the online phase's AR run
     (held after phase 4's dataset and online runs): K1-K5 on the
     1241x376, 752x480, 640x480 and 400x300 canvases, K6, K7's
     band at 2000 and 1200 features a side, K7 under the flags, under the
     epipolar band and under the window (four 1024-column passes at twice
     2000 features in kitti-mono), K8 at up to 2000 observations,
     and K8 also on a problem tiled past 1024 and past 7000 rows, launched
     twice; the ring survey's first global BA and essential graph, each
     solved twice from its recorded problem and required bit-identical;
     the loop callers' recorded calls (K6 in match_by_sim3 and the
     loop neighbourhood's match_fuse, K7 under the flags over the loop
     candidates and over relocalization's BoW candidates, from a warm-up
     run of each loop sequence), each launched twice and exact, also with
     every row (K6: every column) empty and with an empty first candidate;
  4. each main path through the port's entry points, with the kernels'
     launch counts reset just before and read just after it, and its
     result held against the same call on the CPU; the stereo matcher
     also on the card's own features and pyramids, on the card and the CPU;
     the eight single-dispatch forms (slam/jit_frontend.py's `*_jit`, CUDA
     graphs: phase_graphs), each captured once and replayed, every replay
     bit for bit its eager call on the same inputs (the main ones and two
     noisy frames), a held result unchanged by the next replay, launches
     per replay equal to the eager call's; every System run logs its graph
     captures and replays, and no form of the tracker's has more than 2
     graphs under one configuration; the mapper's and the loop closer's
     single-dispatch forms (phase_mapper_graphs: local BA, a triangulation
     and a fuse pass recorded from the RGB-D System's eager warm-up, the
     ring survey's essential graph and global BA), every replay bit for bit
     its eager call and BA's and the pose graph's device-loop forms run
     eagerly too, launches per replay the eager call's, and no
     device-to-host copy or synchronization from a replayed local BA's
     first replay to the read of its result or in a replayed global BA
     segment (torch.profiler); the staged tracker's single-dispatch forms
     (phase_staged_graphs, after the localization session: the staged
     frame's extraction on both routes and stereo front end, the pose LM,
     the four matcher forms, EPnP RANSAC, the two-view bootstrap and the
     BoW descent, on calls recorded from the monocular kidnap run and the
     localization session), every replay bit for bit its eager call, its
     launches all from replays and the eager call's, one replay for a
     one-graph form, and the host's reads of the device in a replayed call
     those of its eigensolves and SVDs alone (torch.profiler); EPnP's
     batched Horn SVD bit for bit one call a case; the localization
     session (four turns), the monocular sweep's first 20 frames and the
     RGB-D System with the staged tracker (ORB_TPU_FUSED_TRACK=0, every
     frame OK and the ATE gate; two turns each) run eager (every form at
     its eager function) and replayed in turns, bit for bit the same, with
     frames/s, stage ms, captures, replays, pool bytes and the idle share,
     and the kidnap sequence's eager warm-up against its counted run; the
     loop closer's, the staged mapper's and AR's single-dispatch forms
     (phase_loop_graphs, after phase_staged_graphs: the Sim3 RANSAC and
     LM, SearchBySim3 both ways, the loop's and the staged mapper's fuse,
     the staged triangulation matcher, the loop closer's brute force over
     its candidates and the plane fit, on calls recorded from the ring
     survey, the staged-mapper RGB-D System, the AR demo and the
     full-width loop run), every replay bit for bit its eager call, K6's
     and K7's launches inside the replays the eager call's, the host's
     reads those of the SVDs and the eigh alone; the staged-mapper System
     and the AR demo eager and replayed in turns, bit for bit; the sharded
     global BA on the real map (a world of one over NCCL) through the
     device loop, its all-reduces captured, eager and replayed in turns,
     bit for bit the plain solve, with its ms an LM iteration and idle
     share; the full-width loop run (phase_full_loop: the multi-loop
     drive's figure-eight at 640x480, 1500 features, stereo, to its first
     corrected loop; the ring survey at full width never initializes)
     eager (the loop path's forms eager) and replayed in two subprocesses
     beside each other and beside the first phases, which build inputs
     and time nothing, read before the first timed phase, untimed, each
     within tests/test_loop_pipeline.py's four gates, bit for bit each
     other;
     the System's sequences held to every frame OK, the ATE gate, at
     least 2 keyframes, points made by triangulation and a fuse pass, and
     the RGB-D sequence's first frames against the CPU's; the monocular
     sweep held to its initialization, every frame after it OK, >= 3
     keyframes and 150 points, the scale-aligned ATE gate, K7 launched at
     initialization, and its first frames past the initialization against
     the CPU's (the same host sample sets); the kidnap sequence held to
     LOST during the occlusion, relocalized after it through K7 batched
     over the candidates, and its recovered poses on the trajectory; the
     ring survey held to tests/test_loop_pipeline.py's four gates (a loop
     closed, its edge and a map change, the corrected prefix's ATE below
     the drifted one, the final ATE under 0.015 x span), K6 and K7 counted
     by loop caller, the vocabulary's word and node ids of every keyframe
     and the database's candidate lists against the CPU, and the accepted
     candidate's sim3_ransac and optimize_sim3 against the CPU on the same
     sample sets; the kidnap sequence with the vocabulary relocalized
     through the database. The per-level extraction: K1 launched once a
     level, the standalone K4 twice a level and no other kernel, its
     features against the packed route on the card (valid, octave,
     response and descriptors equal, keypoints within ROUTES_XY_TOL,
     angles within ROUTES_ANGLE_TOL) and against the same route on the CPU
     (the rules of the packed route's comparison), each of its K1 and K4
     calls against the plain version; the staged mapper: every frame OK,
     the ATE gate, no launch with a batch axis, per mapped keyframe K7
     under the epipolar band once per neighbour pair and K6 once per fuse
     target plus the reverse pass, its map against the batched route's
     (equal or the first difference, logged); the native map core loaded,
     its three counts equal numpy's on that map. Every synchronous System sequence's runs in the
     process (a warm-up, the counted run, a profiled run, and eager runs
     and runs through the graphs in turns) are held to each other bit for
     bit: trajectory entries, keyframes, keyframe poses, point positions. The localization session held to
     tests/test_localization_vo.py's gates (the map unchanged after every
     frame, no temporal point left, >= 8 frames tracked), a frame in VO,
     the ATE gate, K6 and K8 launched, its first 3 frames against the same
     session on the CPU; the asynchronous RGB-D System to every frame OK,
     the ATE gate, keyframes mapped on the worker, both threads ended with
     no error; the global BA stress to tests/test_async_pipeline.py's
     gates (>= 2 launches, >= 1 relaunch over a run in flight, every
     launch merged or aborted, none running, OK, the scale-aligned ATE
     under 0.10 x span); each dataset cell twice with --sync, the launch
     counts reset before and read after each run: every frame OK after
     the first OK, >= 2 keyframes, the ATE of the exported trajectory under
     tests/test_dataset_drivers.py's gate for the mode, every kernel of
     the path launched and none off it, the two runs' trajectory files
     equal byte for byte; the KITTI cell once more with the driver's
     defaults (asynchronous, the bundled vocabulary) under the same gate;
     the KITTI cell's first 5 frames and the TUM RGB-D cell's first 10
     (TUM1's lens) on the card and the CPU: the same keyframes, frame and
     keyframe poses within ROT_DEG_TOL / T_TOL, raw keypoints within
     XY_TOL and undistorted ones within UNDIST_XY_TOL on all but
     FEATURE_FLIP_TOL of the valid features; the KITTI cell's first 5
     frames through kitti-mono (K7 under the initialization's window);
     each run's frames, keyframes, ATE, the driver's tracking times,
     frames/s, PNG read time and (EuRoC) the rectification's time a pair;
     the online phase, each path with its launch counts reset just before
     and read just after it: over the wire, every frame in and tracked,
     the arrays the System's stages got equal bit for bit to the direct
     feed's, and the run bit-identical to the direct runs; live, the
     tracked timestamps increasing, no render error, every streamed PNG an
     [H, W, 3] uint8 image, device_trace active with a non-empty trace,
     the ATE of the returned poses under 0.015 x span, and printed: frames
     in, tracked and dropped, the tracker's ms a tracked frame, the states,
     the renders and the device's idle share from the trace; AR, the cube
     anchored and overlaid on at least the CPU run's frames less 2, the
     PNGs, fit_plane_ransac on the card against the CPU on the same sample
     sets, the anchored normal's angle to the ground plane printed (the AR
     run's kernel calls recorded and held in phase 3); each command line
     (the live driver with --sim, --listen fed over TCP by this process and
     --watch on a directory of PNGs; the AR demo; the synthetic monocular
     demo), exit 0 and its result line;
  5. timing: the step's and each pair's frames/s eager and replayed in
     turns, with device busy time and idle share (and the Systems' frames/s
     and the asynchronous tracker's ms a frame, eager and replayed, after
     the Systems in phase 4); throughput of each path by the bench recipe (the System's
     frames/s over a sequence, after a warm-up sequence, with its stage
     times, initialization's and relocalization's among them, and, under
     torch.profiler, its keyframe frames and plain frames); per stage its
     synchronised wall time and device time; under torch.profiler the
     device's busy time, idle share and operations per call; the loop
     closer's stages (detect_loop, compute_sim3, the essential graph,
     global BA) each under torch.profiler, and one keyframe's vocabulary
     descent; per kernel its
     device-busy time (and its CUDA-event time in a row; the standalone K4
     on the per-level route's 16 calls of one image), its plain
     version's and one library call's where one exists, and the least time
     the card could take (its bound); per caller of K7 under a candidate
     test, in turns, the test in the kernel against the caller's mask built
     by PyTorch and K7 under it (device busy, events, device operations,
     idle share); the RGB-D System asynchronous and synchronous in turns
     (frames/s, the tracker thread's ms per frame, device idle share under
     torch.profiler); K1, K7's band, K7 under the window and K8 also at the
     dataset paths' shapes (logged only); one image's extraction on the
     per-level and the packed route in turns (device busy); map_tri and
     map_fuse per keyframe, staged against batched; one
     update_covisibility through the native core and through numpy.
Then a `kernels` JSON line, the nvidia-smi line, and last the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import logging
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

try:
    from orb_slam2_commit_tpu_torch import interop
    from orb_slam2_commit_tpu_torch.kernels import (
        _build, level, matching as kmatching, patches, pose_lm, select, subpix)
    from orb_slam2_commit_tpu_torch.geometry import pnp, sim3_solver, twoview
    from orb_slam2_commit_tpu_torch.models import native_core, serialization, vocabulary
    from orb_slam2_commit_tpu_torch.models.kf_database import KeyFrameDatabase
    from orb_slam2_commit_tpu_torch.ops import extractor, lie, pyramid, stereo
    from orb_slam2_commit_tpu_torch.ops import subpix as ops_subpix
    from orb_slam2_commit_tpu_torch.ops import packed_extractor as pe
    from orb_slam2_commit_tpu_torch.optim import (
        ba, linalg, pose_graph, pose_opt, segment, sim3_opt)
    from orb_slam2_commit_tpu_torch.parallel import distributed_ba as dba, multihost
    from orb_slam2_commit_tpu_torch.slam import (
        jit_frontend, jit_mapper, loop_closing, matchers, tracking)
    from orb_slam2_commit_tpu_torch.slam.local_mapping import LocalMapper
    from orb_slam2_commit_tpu_torch.slam.system import LOOP_GRAPHED, STAGED_GRAPHED, System
    from orb_slam2_commit_tpu_torch.slam.tracking import Tracker
    from orb_slam2_commit_tpu_torch.examples import run_ar, run_dataset, run_live
    from orb_slam2_commit_tpu_torch.slam import ar
    from orb_slam2_commit_tpu_torch.utils import cuda_graph, mini_dataset, synthetic, trajectory
    from orb_slam2_commit_tpu_torch.utils.png import read_png, write_png
    from orb_slam2_commit_tpu_torch.utils.profiling import device_trace
    from orb_slam2_commit_tpu_torch.utils.config import (
        EUROC_RAW_CAMERAS, euroc_stereo_config, kitti_00_02_config, synthetic_config,
        tum_fr1_config)
    from orb_slam2_commit_tpu_torch.slam.jit_frontend import (
        fused_local_map_track, fused_motion_track_packed,
        fused_rgbd_motion_track_packed, fused_stereo_motion_track_packed,
        pose_inputs, tracking_forward_step)
except ImportError as e:   # the script was copied away from its repository
    raise SystemExit(f"chip_smoke: run it from the repository root ({e})")

# The H100 SXM's published rates (NVIDIA data sheet), for the bounds.
# Integer operations (K6, K7) are counted at the float32 rate as well.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

WIDTH, HEIGHT, N_FEATURES, N_POINTS, N_CANDIDATES = 640, 480, 1000, 1024, 2048
LM_TH = 3.0        # TrackerConfig.search_radius_local_map
# Pose bounds of the port's tests (rotation in degrees, translation).
ROT_DEG_TOL, T_TOL = 0.05, 2e-3
XY_TOL = 1e-4      # px, refined keypoints card vs CPU
# px, stereo u_right against the CPU on the same features and pyramids
# (tests/test_torch_stereo.py); depth = bf / (x - u_right) to DEPTH_RTOL.
U_RIGHT_TOL, DEPTH_RTOL = 1e-3, 1e-5
# px, RGB-D ur = u - bf / z card vs CPU: the keypoint's XY_TOL plus the
# float32 rounding of the difference near 640 px.
UR_TOL = 2e-4
# Share of features whose stereo validity may differ card vs CPU end to
# end (their descriptors above level 0 may differ, ROADMAP.md section 3).
STEREO_FLIP_TOL = 0.01
K5_TOL = 1e-5      # px, K5 vs its plain version (tests/test_subpix.py:69,82)
K8_INLIER_TOL = 0.005   # share of observations whose inlier flag may differ
# Rows of the tiled K8 problems: past one row per thread (the kernel runs
# 256 threads) and past the rows it stages in shared memory (7000).
K8_TILED_ROWS = (2048, 8192)
# Calls traced by torch.profiler for the device's busy time and idle share.
PROFILE_CALLS = 5
# Timed calls of each kernel row (phase 5), and blocks of 64 frames of each
# frames/s reading (bench.py's recipe), cut from 50 and 25 calls and from
# 5 and 3 blocks as the script grew.
KERNEL_ROW_CALLS = 8
FPS_BLOCKS = 2

# A K6 problem past one shared-memory chunk of the kernel (2048 columns).
K6_CHUNKED = dict(seed=8, m=256, n=20000)

# The System's sequences: 30 frames of the synthetic scene at full width.
SYSTEM_FRAMES = 30
SYSTEM_SCENE = dict(n_points=500, seed=5, step=0.05)
# ATE gate, no scale alignment: tests/test_pipeline.py's RGB-D gate of
# 0.015 x the trajectory's span, the same for the stereo sequence.
ATE_SPAN_GATE = 0.015
# Frames of the RGB-D sequence also run on the CPU (fused route forced
# there): past the third keyframe (frame 9), whose local mapping runs the
# first local BA; the card's frame and keyframe poses held to the CPU's
# within ROT_DEG_TOL / T_TOL.
SYSTEM_CPU_FRAMES = 10
# The System's kernels: each must launch in a sequence (K7 under the
# validity flags for reference-keyframe tracking, under the epipolar band
# for triangulation); K3's row form, the standalone K4 and K5 and K7 under
# a caller's mask have no caller there, and K7 under the window (the
# monocular initialization) none in the RGB-D and stereo Systems.
SYSTEM_LAUNCHED = ("level_preprocess", "combine_nms", "cell_topk_map", "describe_patches",
                   "projection_hamming_top2", "valid_hamming_top2", "epipolar_hamming_top2",
                   "pose_lm")
SYSTEM_UNUSED = ("cell_topk", "extract_patches", "corner_subpix", "masked_hamming_top2")
# The monocular sweep's: K7 under the window (initialization) in place of
# the flags (reference-keyframe tracking may not run in a sweep).
MONO_LAUNCHED = tuple(k for k in SYSTEM_LAUNCHED if k != "valid_hamming_top2") + (
    "window_hamming_top2",)
# Recorded calls kept per kernel for phase 3 and the kernel rows.
SYSTEM_RECORDED = 4

# The monocular System: tests/test_pipeline.py's lateral sweep (500
# landmarks, seed 3, 0.025 m peak step, depths 1.5-4 m) at full width, 40
# frames (tests/test_robustness.py's kidnap length), 2000 features until
# it initializes. Gates of the JAX tests: every frame after the
# initialization OK, >= 3 keyframes, >= 150 points, scale-aligned ATE
# under 0.02 x span.
MONO_FRAMES = 40
MONO_SCENE = dict(n_points=500, seed=3, step=0.025, motion="sweep",
                  depth_range=(1.5, 4.0), spread=2.0)
MONO_ATE_GATE = 0.02
MONO_MIN_KFS, MONO_MIN_POINTS = 3, 150
# The kidnap: these frames replaced by a flat 96-grey image, no vocabulary
# (tests/test_robustness.py); recovered poses after the kidnap within a
# median of 0.05 x span of the ground truth, in the frame fixed by the
# frames before it.
KIDNAP = range(22, 27)
KIDNAP_GATE = 0.05
# Frames after the initialization also run on the CPU (the same host
# sample sets): the same initialization frame and keyframes, poses
# within ROT_DEG_TOL / T_TOL.
MONO_CPU_FRAMES = 10
# K7 under a candidate test has four callers in the monocular System; a
# recorded call is told apart by its form and shapes (k7_caller).
K7_CALLERS = ("reference keyframe", "initialization", "triangulation", "relocalization")
# K7's forms with the caller's test in the kernel, and the MASK form.
K7_FORMS = ("valid_hamming_top2", "window_hamming_top2", "epipolar_hamming_top2")

# The loop phase: tests/test_loop_pipeline.py's ring survey (132 frames,
# 1.35 turns, seed 4; 900 ring landmarks) at that test's size, 400x300 and
# 500 features, monocular, the bundled vocabulary, synchronous mapping: at
# 640x480 and 1000 features the JAX System never initializes on this
# survey (a CPU run of it). Its gates: >= 1 loop closed and the state
# OK at the end, a loop edge and a map change, the corrected prefix's
# scale-aligned ATE below the drifted one, the final one under 0.015 x
# span.
LOOP_WIDTH, LOOP_HEIGHT, LOOP_FEATURES = 400, 300, 500
LOOP_SCENE = dict(n_frames=132, frac=1.35, seed=4)
LOOP_ATE_SPAN = 0.015
# The new callers of K6 and K7 (chip_smoke.loop_kernel_calls tells them
# apart by the loop method running).
LOOP_CALLERS = ("match_by_sim3", "loop match_fuse", "compute_sim3", "BoW relocalization")
LOOP_RECORDED = 4
# compute_sim3's K7 also over this many candidates against one keyframe.
LOOP_STACKED = 5
# The loop closer's stages timed under torch.profiler in the warm-up run
# (the first calls of each; the survey closes one loop).
LOOP_PROFILED = ("detect_loop", "compute_sim3", "_optimize_essential_graph", "run_global_ba")
LOOP_PROFILE_CALLS = 2
# sim3_ransac and optimize_sim3 card vs CPU on the same inputs and sample
# sets: s and R within the tolerance, t within it times its largest
# component (or 1 where that is smaller); 1e-4 for the closed-form RANSAC
# fit, 5e-3 for the LM. The LM's limit lies between the card-vs-CPU
# readings of six ring surveys (4.5e-6 to 1.41e-3, the largest where the
# LM moved 0.27 from its start; NVIDIA H100 80GB HBM3, 700.00 W) and the
# control's (the LM skipped: 0.0205 and more, PERF.md section 6).
SIM3_TOL = {"sim3_ransac": 1e-4, "optimize_sim3": 5e-3}

# The localization session (Tracker.localization_only): an RGB-D System
# with the bundled vocabulary maps the first LOC_MAPPED frames of an RGB-D
# survey along the ring survey's path and scene (LOOP_SCENE; the ring's
# landmarks, radii and far wall as render_loop_sequence's) at full width
# and saves the map; a second System loads it, switches to the
# localization-only mode and tracks frames LOC_FIRST to LOC_FRAMES - 1.
# The path turns away from the mapped sectors: from about frame 30 on
# almost no map point is in view, and the tracker rides its temporal VO
# points (a CPU run of this session). The RGB-D System's own sequence
# cannot show that: every one of its 30 frames keeps ~800 map inliers of
# a map made from frames 0-14 (a CPU run). Gates of
# tests/test_localization_vo.py: the map unchanged after every frame (no
# keyframe, no point, the allocation cursor as loaded), no temporal point
# left after a frame, >= LOC_MIN_TRACKED frames tracked; and a frame in VO,
# temporal points spawned, the tracked frames' ATE under ATE_SPAN_GATE x
# their span, K6 and K8 launched; the first LOC_CPU_FRAMES frames against
# the same session on the CPU.
LOC_MAPPED, LOC_FIRST, LOC_FRAMES = 15, 7, 40
LOC_MIN_TRACKED, LOC_CPU_FRAMES = 8, 3
# The global BA runner under tracking (tests/test_async_pipeline.py's
# stress): the monocular sweep, asynchronous, with the bundled vocabulary;
# every global BA held until released, relaunched every GBA_EVERY frames
# once the map has GBA_MIN_KFS keyframes; scale-aligned ATE under
# GBA_ATE_GATE x span (that test's gate).
GBA_EVERY, GBA_MIN_KFS, GBA_ATE_GATE = 5, 4, 0.10
# Asynchronous against synchronous RGB-D System runs, in turns (2 before a
# depth cut).
ASYNC_TURNS = 1

# The online phase (examples/run_live.py, slam/viewer.py, slam/ar.py,
# examples/run_ar.py). (a) The RGB-D and stereo sequences published over
# loopback TCP into run_live, no drops, synchronous: bit-identical to
# phase 4's direct runs. (b) The RGB-D sequence published paced at each of
# LIVE_RATES frames/s (ts = i / rate) into run_live with the drop policy,
# through the default asynchronous System with the bundled vocabulary,
# the viewer off and on in turns (LIVE_VIEWER), each run inside its own
# device_trace: tracked timestamps increasing, no render error, every
# streamed PNG an [H, W, 3] uint8 image, the ATE of the returned poses
# under ATE_SPAN_GATE x span. (c) run_ar at its defaults: the cube
# overlaid on at least AR_OVERLAID_CPU - 2 frames (AR_OVERLAID_CPU: the
# frames a CPU run of run_ar on the card's route overlays, 3-23 of 24);
# fit_plane_ransac on the run's final map on the card and the CPU on the
# same AR_ITERS sample sets: the same best hypothesis, normals within
# AR_FIT_RAD, inlier flags equal but for points within AR_FLAG_BAND x
# scale of the threshold. The anchored normal's angle to the scene's
# ground plane (AR_GROUND) after the trajectory's similarity alignment is
# printed, not gated: the anchor (the JAX package's, kept) draws its
# samples over the map's whole point table, where almost no sample is of
# three valid points, so its plane is the least-variance direction of the
# whole cloud, about 60 deg from the ground in both packages (run_ar on
# the CPU: 63.8 deg in JAX, 60.0 deg in the port).
# (d) The online entry points' command lines, each in a subprocess.
LIVE_RATES = (30.0, 10.0)
LIVE_VIEWER = (False, True)
AR_OVERLAID_CPU = 21
AR_GROUND = (0.1, 1.0, -0.15)      # utils/synthetic.make_scene's plane normal
AR_FIT_RAD, AR_FLAG_BAND, AR_ITERS = 1e-4, 1e-5, 128
CLI_FRAMES = 30

# The datasets phase: four mini datasets written by the port's writers at
# the published settings of the reference's Examples/*.yaml (absent from
# the snapshot, SURVEY.md; their values are utils/config's
# kitti_00_02_config, euroc_stereo_config with EUROC_RAW_CAMERAS, and
# tum_fr1_config), each run through the port's driver. Only the frame
# counts are cut.
# The EuRoC raw cameras' mounting rotations (degrees) and the scene and
# path of tests/test_dataset_drivers.py's EuRoC stereo case.
EUROC_MOUNTS = {"LEFT": dict(yaw=1.2, pitch=0.5), "RIGHT": dict(yaw=-0.8, pitch=0.7, roll=0.4)}
EUROC_SCENE = dict(seed=9, n_points=500, step=0.06)
# scripts/scale_drive.py's circuit (1600 frames, 0.185 m a frame), its
# first 60 frames.
KITTI_DRIVE = dict(n_frames=1600, stereo=True, seed=7)
DATASET_FRAMES = {"kitti_00-02_stereo": 60, "tum_fr1_rgbd": 30, "euroc_stereo": 30,
                  "tum_fr1_mono": 40}
# ATE gates, x the path's span: tests/test_dataset_drivers.py's for the
# same mode (TUM monocular scale-aligned).
DATASET_GATES = {"kitti_00-02_stereo": 0.02, "tum_fr1_rgbd": 0.02, "euroc_stereo": 0.025,
                 "tum_fr1_mono": 0.03}
# The cells whose first frames run on the card and on the CPU (KITTI's
# canvas; TUM1's lens through the fused RGB-D stages), and how many.
DATASET_VS_CPU = {"kitti_00-02_stereo": 5, "tum_fr1_rgbd": 10}
# px, the undistorted keypoints (Frame.xy) card vs CPU: the raw keypoints'
# XY_TOL through TUM1's undistortion, whose gain is at most 1.0005 over
# the image, plus the float32 rounding of its iterations near 640 px
# (6.1e-5 px an ulp).
UNDIST_XY_TOL = 2e-4
# Share of the valid features whose valid flag, octave or keypoint may
# differ card vs CPU end to end: responses above level 0 differ in their
# last bits (ROADMAP.md section 3), so a cell's choice may flip where two
# candidates tie (STEREO_FLIP_TOL's reason).
FEATURE_FLIP_TOL = STEREO_FLIP_TOL
# Every dataset run launches these (the stereo runs also K7's band, the
# monocular ones K7 under the window) and none of SYSTEM_UNUSED.
DATASET_LAUNCHED = ("level_preprocess", "combine_nms", "cell_topk_map", "describe_patches",
                    "projection_hamming_top2", "epipolar_hamming_top2", "pose_lm")
DATASET_FILES = ("_tum.txt", "_kf_tum.txt", "_kitti.txt")
# The kernel rows timed at the dataset paths' shapes, and the run whose
# launches each reports.
DATASET_TIMED = {
    "KITTI canvas 1241x376": "the KITTI cell's first --sync run",
    "KITTI pair, 2000 x 2000": "the KITTI cell's first --sync run",
    "KITTI monocular initialization": "the KITTI cell's first 5 frames through kitti-mono",
    "KITTI stereo frame, 2000 observations": "the KITTI cell's first --sync run"}
# The kernels recorded in each cell's first --sync run: (module, calls
# kept: the first ones, or all of them, to keep the largest).
DATASET_RECORDED = {
    "level_preprocess": (level, 2), "combine_nms": (level, 2), "cell_topk_map": (select, 2),
    "describe_patches": (patches, 2), "projection_hamming_top2": (kmatching, SYSTEM_RECORDED),
    "stereo_band_top2": (kmatching, 2), "valid_hamming_top2": (kmatching, SYSTEM_RECORDED),
    "epipolar_hamming_top2": (kmatching, SYSTEM_RECORDED), "pose_lm": (pose_lm, None),
    "window_hamming_top2": (kmatching, None)}
# K7 under the KITTI initialization's window (twice 2000 features): more
# columns than any earlier phase gives it (the monocular sweep's 2000),
# four of the kernel's 1024-column passes (MT_CHUNK, csrc/matching.cu).
K7_WINDOW_MIN_COLUMNS = 2049

# The map-scale phase. (a) The real map snapshot (156 keyframes, 7,781
# points, a mid-drive checkpoint of the JAX package's 850 m stereo city
# drive; its `_meta` holds those capacities) under the drive's
# configuration, global BA as run_global_ba runs it (keyframe 0 fixed, 5
# LM iterations: PCG from 64 cameras on). (b) tests/test_sim3.py's
# 300-vertex drifted loop (PCG above 256 vertices): its gate on the
# largest centre error, and tests/test_torch_sim3.py's card-vs-CPU bound.
# (c) The drives' command lines at 640x480, stereo.
REPO = os.path.dirname(os.path.abspath(__file__))
REAL_MAP = os.path.join(REPO, "orb_slam2_commit_tpu", "data", "real_map_850m.npz")
REAL_MAP_SIZE = (156, 7781)
REAL_MAP_CONFIG = dict(width=640, height=480, n_features=1500, sensor="stereo")
REAL_MAP_GBA_ITERS = 5
GRAPH_K = 300
# LM iterations of the 300-vertex graph's eager-against-replayed solves
# (the gate's solve runs all 20, replayed): eager, each takes ~1.2-1.7 s.
GRAPH_COMPARED_ITERS = 5
GRAPH_PCG_GATE = 0.10
GRAPH_CENTRE_TOL = 2e-3
# In float32 the graph's LM accepts two steps (17.5 m -> 10.86 m from the
# truth) and rejects every later one (ROADMAP queue 3); the card is held to
# the CPU over those two.
GRAPH_F32_ITERS = 2
DRIVE_FRAMES = 40
# The full drives' settings (tests/test_scale.py::TestFullDrive: 1600
# frames over 1.18 laps; tests/test_multiloop.py::TestFullFigure8: 1400
# frames over 2.15 lobes), cut to their first 40 frames' arc: the same
# speed a frame (over the whole circuit, 40 frames would move ~9 m a frame,
# and the tracker loses every one).
DRIVES = {"scale_drive": ("--points=120000", "--features=1500", "--r0=40", "--max-depth=12",
                          f"--frac={1.18 * DRIVE_FRAMES / 1600:.6f}"),
          "multiloop_drive": ("--points=120000", "--features=1500",
                              f"--laps={2.15 * DRIVE_FRAMES / 1400:.6f}")}
# Every kernel of the stereo System's per-frame path launches in a drive.
DRIVE_LAUNCHED = ("level_preprocess", "combine_nms", "cell_topk_map", "describe_patches",
                  "stereo_band_top2", "projection_hamming_top2", "pose_lm")

# K3 runs in its map form; K4 and K5 in one fused launch (describe_patches)
# per extraction. K3's row form and the standalone K4 and K5 have no caller
# on the main paths, nor has K7 under a caller's mask; K7 under a
# candidate test has its callers in the System only, as have K6 and K7 with
# a batch axis.
STEP_WANT = {"level_preprocess": 1, "combine_nms": 1, "cell_topk_map": 1,
             "cell_topk": 0, "describe_patches": 1, "extract_patches": 0,
             "corner_subpix": 0, "projection_hamming_top2": 1, "stereo_band_top2": 0,
             "masked_hamming_top2": 0, "valid_hamming_top2": 0, "window_hamming_top2": 0,
             "epipolar_hamming_top2": 0, "pose_lm": 1}
# The motion stage's two searches (th, 2 th) share one K6 launch.
PAIR_WANT = dict(STEP_WANT, projection_hamming_top2=2, pose_lm=2)
# Two extractions and the stereo matcher's one K7 band launch (both
# directions).
STEREO_WANT = dict(PAIR_WANT, level_preprocess=2, combine_nms=2, cell_topk_map=2,
                   describe_patches=2, stereo_band_top2=1)
WANT = {"monocular": PAIR_WANT, "stereo": STEREO_WANT, "rgbd": PAIR_WANT}
MOTION = {"monocular": fused_motion_track_packed,
          "stereo": fused_stereo_motion_track_packed,
          "rgbd": fused_rgbd_motion_track_packed}
PATH = {"monocular": "pair", "stereo": "stereo pair", "rgbd": "RGB-D pair"}


def log(*parts):
    print(*parts, flush=True)


def rot_angle_deg(Ra, Rb):
    """Angle between two rotations, from |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2)
    (the arccos of the trace loses ~0.03 deg to float32 rounding near 0)."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return float(np.degrees(2 * np.arcsin(min(1.0, d / (2 * np.sqrt(2))))))


def gpu_time_ms(fn, iters, warmup=3):
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ops(prof):
    """The device operations of a finished torch.profiler run -> (their
    count, their summed durations in ms); raises if there are none."""
    from torch.autograd import DeviceType

    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise AssertionError("the profiler saw no device operation")
    return len(ops), sum(e.time_range.elapsed_us() for e in ops) / 1e3


def traced_calls(fn, iters, warmup=3, sessions=2):
    """fn() `iters` times under torch.profiler (the device traced alone),
    after `warmup` calls; of `sessions` such sessions the one with the most
    device time -> (wall ms, device busy ms, device operations, busy ms by
    operation name), each per call; busy None where no session saw a
    device operation. Late in a long process a session's device records
    can come back short (on the card a K7 row once read 0.0010 ms against
    0.0042 ms for the same call a row later, and a 5-call session of one
    launch a call none at all)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    best = (0.0, None, 0.0, {})
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / iters * 1e3
        ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / iters
        if ops and (best[1] is None or busy > best[1]):
            by_name = {}
            for e in ops:
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0][:48]
                by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
            best = (wall, busy, len(ops) / iters, by_name)
    return best


def device_busy_ms(fn, iters, warmup=3, sessions=2):
    """Device time per call of fn(): the summed durations of the device
    operations it ran, under torch.profiler over `iters` calls, and the
    same per operation name (traced_calls). The host's gaps between them
    are not counted, so a call whose launches take less device time than
    the host needs to issue them reads its device time (CUDA events over
    calls in a row would read the host's issue rate). Where neither of
    traced_calls' two sessions saw a device operation (the profiler drops
    whole sessions late in a long process), three more are taken.
    sessions: traced_calls' first sessions (the kernel rows' plain and
    library times take one: a depth cut)."""
    _, busy, _, by_name = traced_calls(fn, iters, warmup, sessions)
    if busy is None:
        _, busy, _, by_name = traced_calls(fn, iters, 0, sessions=3)
        log(f"device_busy_ms: two profiler sessions saw no device operation; three more "
            f"{'saw them' if busy is not None else 'saw none either'}")
    if busy is None:
        raise AssertionError("the profiler saw no device operation")
    return busy, by_name


def smi_clocks():
    """The card's SM clock and power draw now, from nvidia-smi."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def as_tensors(arrays, device):
    """numpy arrays -> tensors on device, uint32 as int32 bits."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                  if a.dtype == np.uint32 else np.ascontiguousarray(a)
                                  ).to(device) for a in arrays)


@contextlib.contextmanager
def recording(module, name, calls, keep=None):
    """Record the arguments of every call of module.name into calls (of
    the first `keep` calls only, where keep is given)."""
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        if keep is None or len(calls) < keep:
            calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def env_set(**values):
    """The environment variables set inside the block, restored after it
    (the routes are read at each call)."""
    prev = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(f"device: {name} x{count}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    t0 = time.perf_counter()
    results = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(results)} "
        f"(one nvcc per source, in parallel)")
    for name, (seconds, text) in sorted(results.items()):
        log(f"  {name}.cu: {seconds:.1f} s")
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("   ", line.strip())


# ---------------------------------------------------------------------------
# The main paths
# ---------------------------------------------------------------------------

def run_pair(config, motion, cands):
    """The tracker's per-frame pair through its entry points: the motion
    stage for config.sensor, then the local-map stage on the features it
    left on the card. motion = (image[, image_r or depth], pt_f32,
    pt_desc, meta_f32)."""
    out = MOTION[config.sensor](*motion, config)
    feat_state, lm_meta = interop.local_map_args(out, motion[-3], LM_TH)
    lm = fused_local_map_track(out[1], out[2], feat_state, *cands, lm_meta, config)
    return out, lm


def main_path_inputs(image, config, motion, cands):
    """The tensors each kernel gets on the main paths, on the card: K1-K4
    from the tracking step's extraction (as in slice 1), the fused K4 + K5
    launch's and K6-K8's from one recorded run of the pair (the standalone
    K5 on the 31x31 windows of that launch's call)."""
    orb = config.orb
    plan = pe.make_plan(orb, HEIGHT, WIDTH)
    canvas = pe.build_canvas(image, plan)
    blur_c, hi_c, lo_c = level.level_preprocess(
        canvas, float(orb.ini_th_fast), float(orb.min_th_fast))
    bounds = torch.from_numpy(pe._bounds_np(plan, hi_c.shape[0])).to(image.device)
    score = level.combine_nms(hi_c, lo_c, bounds)
    yx, _, _ = pe.select_flat(score, plan, orb)
    small, small_bounds, small_plan, small_orb = padded_canvas(image.device)
    ths = (float(orb.ini_th_fast), float(orb.min_th_fast))
    s_blur, s_hi, s_lo = level.level_preprocess(small, *ths)
    small_score = level.combine_nms(s_hi, s_lo, small_bounds)
    x = dict(canvas=canvas, blur=blur_c, hi=hi_c, lo=lo_c, bounds=bounds,
             score=score, cells=select.cell_matrix(score, orb.cell_size),
             cell=orb.cell_size, k=orb.cell_top_k, yx=yx, ths=ths,
             small_canvas=small, small_bounds=small_bounds, small_score=small_score,
             small_blur=s_blur, small_yx=pe.select_flat(small_score, small_plan, small_orb)[0])

    # K6: the motion stage's two-window call and the local-map stage's.
    k45, k6, k8 = [], [], []
    with recording(patches, "describe_patches", k45), \
            recording(kmatching, "projection_hamming_top2", k6), \
            recording(pose_lm, "pose_lm", k8):
        run_pair(config, motion, cands)
    torch.cuda.synchronize()
    if (len(k45), len(k6), len(k8)) != (1, 2, 2) or len(k6[0][0][2]) != 2:
        raise AssertionError(f"recorded {len(k45)} K4 + K5, {len(k6)} K6, {len(k8)} K8 calls")
    p_canvas, _, p_yx, refine = k45[0][0]
    if not refine:
        raise AssertionError("the pair's extraction did not refine its keypoints")
    half = patches.PATCH_SIZE // 2
    x.update(k45=k45[0][0], k5=(patches.extract_patches_plain(p_canvas, p_yx, patches.PATCH_SIZE),
                                half, half),
             k6=[c[0] for c in k6], k8=[c[0] for c in k8])
    return x


def padded_canvas(device):
    """The packed canvas of frame 1 at 320x240 and 400 features (the JAX
    package's example size): [1248, 320], whose outputs are [1280, 384], so
    K1 reads pad rows and columns through its tables; the row bounds of
    those outputs, the canvas plan and the ORB configuration."""
    config, images, _, _ = interop._scene(320, 240, 400, 2)
    plan = pe.make_plan(config.orb, 240, 320)
    canvas = pe.build_canvas(torch.as_tensor(images[1], dtype=torch.float32, device=device),
                             plan)
    hp = level._round_up(canvas.shape[0], level.STRIPE)
    return canvas, torch.from_numpy(pe._bounds_np(plan, hp)).to(device), plan, config.orb


def tiled_problem(args, rows):
    """A K8 problem with its observation rows repeated up to `rows`."""
    R0, t0, points, obs, *cam = args
    reps = -(-rows // points.shape[0])

    def tile(a):
        return a.repeat(reps, *([1] * (a.dim() - 1)))[:rows].contiguous()

    return (R0, t0, tile(points), type(obs)(*(tile(a) for a in obs)), *cam)


def stereo_path_inputs(config, motion, cands):
    """The tensors K7 and K8 get on the stereo pair, from one recorded run
    of it: K7's band launch (both directions) and K8's two problems, now
    with stereo rows. K7 under a mask gets the band's mask and its
    transpose, built by the plain mask builder from the band's inputs."""
    band, k8 = [], []
    with recording(kmatching, "stereo_band_top2", band), \
            recording(pose_lm, "pose_lm", k8):
        run_pair(config, motion, cands)
    torch.cuda.synchronize()
    if (len(band), len(k8)) != (1, 2):
        raise AssertionError(f"recorded {len(band)} K7 band, {len(k8)} K8 calls on the "
                             f"stereo pair")
    args = band[0][0]
    desc_l, xy_l, octave_l, scale_l, valid_l, desc_r, xy_r, octave_r, valid_r, max_d = args
    mask = kmatching.stereo_band_mask(xy_l, octave_l, scale_l, valid_l, xy_r, octave_r,
                                      valid_r, max_d)
    return dict(k7_band=args, k7=[(desc_l, desc_r, mask),
                                  (desc_r, desc_l, mask.t().contiguous())],
                k8_stereo=[c[0] for c in k8])


def band_problems(x):
    """(what, args) of K7 band's phase-3 cases: the stereo pair's recorded
    call and the CPU tests' band cases (interop.BAND_CASES)."""
    dev = x["canvas"].device
    yield "stereo pair", x["k7_band"]
    scales = torch.from_numpy(interop.BAND_SCALES).to(dev)
    for name, case in interop.BAND_CASES.items():
        dl, xy_l, ol, vl, dr, xy_r, orr, vr = as_tensors(interop.band_problem(**case), dev)
        yield name, (dl, xy_l, ol, scales[torch.clamp(ol, 0, 7).long()], vl, dr, xy_r, orr,
                     vr, interop.BAND_MAX_D)


def check_band(what, args):
    """K7 band against its plain version: all four outputs of both
    directions bit for bit."""
    got = kmatching.stereo_band_top2(*args)
    want = kmatching.stereo_band_top2_plain(*args)
    torch.cuda.synchronize()
    for side, g, w in zip(("left -> right", "right -> left"), got, want):
        if not all(torch.equal(a, b) for a, b in zip(g, w)):
            raise AssertionError(f"K7 band differs on {what}, {side}: " + ", ".join(
                f"{max_abs(a, b):g}" for a, b in zip(g, w)))
    log(f"K7 stereo_band_top2, {what} [{args[0].shape[0]}, {args[5].shape[0]}]: exact in "
        f"all four outputs of both directions (rows with a candidate: "
        f"{[int((g[0] <= 256).sum()) for g in got]})")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def k6_problems(x):
    """(what, args) of K6's phase-3 cases: the pair's two recorded calls,
    each CPU-test case with one window and with two (r, 2r), one with a
    second window narrower than the first, one with every row invalid, and
    one past a shared-memory chunk."""
    dev = x["canvas"].device

    def windows(args, *radii):
        return (*args[:2], radii, *args[3:])

    motion, local_map = x["k6"]
    yield "motion stage, two windows", motion
    yield "local-map stage", local_map
    for name, case in interop.TOP2_CASES.items():
        args = as_tensors(interop.top2_problem(**case), dev)
        yield name, windows(args, args[2])
        yield f"{name}, two windows", windows(args, args[2], 2 * args[2])
    args = as_tensors(interop.top2_problem(**interop.TOP2_CASES["257x513"]), dev)
    yield "257x513, second window narrower", windows(args, args[2], 0.5 * args[2])
    args = (*args[:5], torch.zeros_like(args[5]), *args[6:])
    yield "257x513, every row invalid, two windows", windows(args, args[2], 2 * args[2])
    args = as_tensors(interop.top2_problem(**K6_CHUNKED), dev)
    yield "past one chunk, two windows", windows(args, args[2], 2 * args[2])


def check_k6(what, args):
    """K6 against its plain version (each window on its own): all four
    outputs of each window bit for bit."""
    got = kmatching.projection_hamming_top2(*args)
    want = kmatching.projection_hamming_top2_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if not all(torch.equal(a, b) for a, b in zip(g, w)):
            raise AssertionError(f"K6 differs on {what}: " + ", ".join(
                f"{max_abs(a, b):g}" for a, b in zip(g, w)))
    log(f"K6 projection_hamming_top2, {what} [{args[0].shape[0]}, {args[6].shape[0]}]: "
        f"exact in all four outputs (rows with a candidate: "
        f"{[int((g[0] <= 256).sum()) for g in got]})")


def describe_problems(x):
    """(what, (canvas, blurred canvas, yx)) of the patch kernels' phase-3
    cases: the step's and the pair's calls, the 320x240 canvas's keypoints,
    and centres at and past every edge of both canvases."""
    canvas, blur, small, s_blur = x["canvas"], x["blur"], x["small_canvas"], x["small_blur"]
    yield "step", (canvas, blur, x["yx"])
    yield "pair", x["k45"][:3]
    yield "320x240 canvas", (small, s_blur, x["small_yx"])
    for name, c, b in (("main canvas", canvas, blur), ("320x240 canvas", small, s_blur)):
        yield f"{name}, edge centres", (c, b, torch.from_numpy(
            interop.patch_edge_yx(*c.shape)).to(c.device))


def guard_ratios(ic):
    """det / s^2 of each keypoint's two 2x2 solves ([K, 2]; the guard
    passes above 1e-6), by the plain version's arithmetic in float64 on the
    9x9 centre of its 31x31 window: printed where K5 misses K5_TOL."""
    half, r = patches.PATCH_SIZE // 2, ops_subpix.HALF + 1
    win = ic[:, half - r:half + r + 1, half - r:half + r + 1].double()
    gy = 0.5 * (win[:, 2:, 1:-1] - win[:, :-2, 1:-1])
    gx = 0.5 * (win[:, 1:-1, 2:] - win[:, 1:-1, :-2])
    d = torch.arange(-ops_subpix.HALF, ops_subpix.HALF + 1, dtype=torch.float64,
                     device=ic.device)
    py, px = torch.meshgrid(d, d, indexing="ij")
    cy = cx = torch.zeros(ic.shape[0], 1, 1, dtype=torch.float64, device=ic.device)
    ratios = []
    for _ in range(ops_subpix.ITERS):
        wgt = torch.exp(-((px - cx) ** 2 + (py - cy) ** 2) / (2.0 * ops_subpix.HALF ** 2))
        a, b, c = ((wgt * g).sum((1, 2)) for g in (gx * gx, gx * gy, gy * gy))
        bx = (wgt * (gx * gx * px + gx * gy * py)).sum((1, 2))
        by = (wgt * (gx * gy * px + gy * gy * py)).sum((1, 2))
        det = a * c - b * b
        ratios.append(det / (a + c).clamp_min(1e-12) ** 2)
        ok = (ratios[-1] > 1e-6)[:, None, None]
        cx = torch.where(ok, ((c * bx - b * by) / det).clamp(-1, 1)[:, None, None], cx)
        cy = torch.where(ok, ((a * by - b * bx) / det).clamp(-1, 1)[:, None, None], cy)
    return torch.stack(ratios, 1)


def check_offsets(what, got, want, ic):
    """Offsets within K5_TOL of the plain version's -> max |d|; where they
    are not, the count of keypoints beyond it and their windows' det / s^2
    (a guard that flips between the two sum orders) before the failure."""
    err = max_abs(got, want)
    if not err <= K5_TOL:
        bad = ((got - want).abs().amax(dim=1) > K5_TOL).nonzero().flatten()
        log(f"{what}: {bad.numel()} keypoints beyond {K5_TOL:g} px; det / s^2 of their "
            f"two solves (the guard is 1e-6): {guard_ratios(ic[bad]).cpu().tolist()}")
        raise AssertionError(f"{what}: offsets differ from the plain version by {err} px")
    return err


def check_describe(what, canvas, blur, yx):
    """The fused K4 + K5 launch against its plain version, with and without
    refinement: both windows bit for bit, offsets within K5_TOL -> their
    max |d|."""
    ic, brief, off = patches.describe_patches(canvas, blur, yx, True)
    ic_u, brief_u, none = patches.describe_patches(canvas, blur, yx, False)
    w_ic, w_brief, w_off = patches.describe_patches_plain(canvas, blur, yx, True)
    torch.cuda.synchronize()
    for name, got, want in (("31x31", ic, w_ic), ("39x39", brief, w_brief),
                            ("unrefined 31x31", ic_u, w_ic),
                            ("unrefined 39x39", brief_u, w_brief)):
        if not torch.equal(got, want):
            raise AssertionError(f"describe_patches: {name} windows differ on the {what} "
                                 f"inputs: {max_abs(got, want)}")
    if none is not None:
        raise AssertionError("describe_patches gave offsets without refinement")
    err = check_offsets(f"describe_patches on the {what} inputs", off, w_off, w_ic)
    log(f"K4 + K5 describe_patches, {what}, K={yx.shape[0]}, canvas {tuple(canvas.shape)}, "
        f"blurred {tuple(blur.shape)}: both windows exact with and without refinement, "
        f"offsets max|d| = {err:g} px (tolerance {K5_TOL:g}; "
        f"{int((w_off != 0).any(dim=1).sum())} keypoints moved)")
    return err


def check_extract(what, image, yx, p):
    got = patches.extract_patches(image, yx, p)
    want = patches.extract_patches_plain(image, yx, p)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"K4 P={p} differs on the {what} inputs: {max_abs(got, want)}")
    log(f"K4 extract_patches, {what}, K={yx.shape[0]}, P={p}, image {tuple(image.shape)}: exact")


def check_k5(what, ic):
    half = patches.PATCH_SIZE // 2
    got = subpix.corner_subpix_from_patches(ic, half, half)
    want = subpix.corner_subpix_from_patches_plain(ic, half, half)
    torch.cuda.synchronize()
    err = check_offsets(f"K5 corner_subpix on the {what} windows", got, want, ic)
    log(f"K5 corner_subpix, {what} {tuple(ic.shape)}: max|d| = {err:g} px "
        f"(tolerance {K5_TOL:g})")
    return err


def check_top2(name, what, kernel, plain, args, shape):
    """A top-2 kernel against its plain version: all four outputs exact."""
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} differs on {what}: " + ", ".join(
            f"{max_abs(g, w):g}" for g, w in zip(got, want)))
    log(f"{name}, {what} {tuple(shape)}: exact in all four outputs "
        f"({int((got[0] <= 256).sum())} of {got[0].numel()} rows with a candidate)")


K7_RANKS = {"valid_hamming_top2": (2, 2, 1, 1), "window_hamming_top2": (2, 2, 1, 1, 2, 2),
             "epipolar_hamming_top2": (2, 2, 1, 1, 2, 2, 2, 1)}


def k7_batch(name, args):
    """() or (B,): the batch axis of a call of K7 under a candidate test."""
    return kmatching._lead(*zip(args, K7_RANKS[name]))


def k7_mask(name, args):
    """The [*B, M, N] mask that the form's plain version builds (its
    caller's mask before this kernel tested it)."""
    return kmatching.CANDIDATE_MASKS[name](*args).contiguous()


def emptied(args, first=True):
    """A call's arguments with its first problem's row flags cleared (its
    column flags where the rows are shared by the problems), or with every
    row flag cleared."""
    args = list(args)
    if not first:
        args[2] = torch.zeros_like(args[2])
        return tuple(args)
    i = 2 if args[2].dim() == 2 else 3
    flags = args[i].clone()
    flags[0] = False
    args[i] = flags
    return tuple(args)


def candidate_cases(device):
    """(what, form, args) of interop's K7 cases under a candidate test, the
    CPU tests' and the card's (past one chunk of columns; B = 8 with either
    side shared), as tensors on `device`."""
    for name, kw in {**interop.CANDIDATE_CASES, **interop.CANDIDATE_CARD_CASES}.items():
        args = interop.candidate_problem(**kw)
        yield f"case {name}", f"{kw['test']}_hamming_top2", tuple(
            a if isinstance(a, float) else interop.to_device(a, device) for a in args)


def k7_problems(x):
    """(what, form, args) of the phase-3 cases of K7 under a candidate
    test: the System's recorded reference-keyframe (validity flags) and
    triangulation (the epipolar band, a batch of neighbour pairs) calls,
    the monocular System's initialization (the window, [2000, 2000]) and
    relocalization (the flags, a batch of candidates, the frame's table
    shared) calls, each batched call's first also with its first problem
    emptied and with every row empty; and interop's cases."""
    for key, name, what in (("sys_k7", "valid_hamming_top2", "System reference-keyframe match"),
                            ("sys_k7b", "epipolar_hamming_top2", "System triangulation"),
                            ("mono_k7_init", "window_hamming_top2",
                             "monocular initialization"),
                            ("mono_k7_reloc", "valid_hamming_top2",
                             "relocalization (shared columns)")):
        for i, args in enumerate(x[key]):
            yield f"{what} call {i}", name, args
        if k7_batch(name, x[key][0]):
            yield f"{what} call 0, first problem empty", name, emptied(x[key][0])
            yield f"{what} call 0, every row empty", name, emptied(x[key][0], first=False)
    yield from candidate_cases("cuda")


def check_form(what, name, args, twice=True):
    """K7 under a candidate test against its plain version and against K7
    under the mask that plain version builds, and (twice) a second launch
    against the first: all four outputs exact."""
    fn = getattr(kmatching, name)
    got = fn(*args)
    again = fn(*args) if twice else got
    want = kmatching.CANDIDATE_PLAINS[name](*args)
    mask = k7_mask(name, args)
    under = kmatching.masked_hamming_top2(args[0], args[1], mask)
    torch.cuda.synchronize()
    for other, against in ((want, "its plain version"), (under, "K7 under its mask"),
                           (again, "a second launch")):
        if not all(torch.equal(g, w) for g, w in zip(got, other)):
            raise AssertionError(f"K7 {name} differs from {against} on {what}: " + ", ".join(
                f"{int((g != w).sum())} rows" for g, w in zip(got, other)))
    log(f"K7 {name}, {what} {tuple(mask.shape)}: exact against its plain version and K7 "
        f"under its mask{', twice bit-identical' if twice else ''} "
        f"({int(mask.sum())} candidate pairs, {int((got[0] <= 256).sum())} of "
        f"{got[0].numel()} rows with a candidate)")


def batched_k6_problems(x):
    """(what, args) of the phase-3 cases of K6 with a batch axis: the
    System's recorded fuse calls, the first with its first target's rows
    invalid, and with every row invalid."""
    for i, args in enumerate(x["sys_k6b"]):
        yield f"System fuse call {i}", args
    args = list(x["sys_k6b"][0])
    valid = args[5].clone()
    valid[0] = False
    yield "fuse call 0, first target's rows invalid", (*args[:5], valid, *args[6:])
    yield "fuse call 0, every row invalid", (*args[:5], torch.zeros_like(valid), *args[6:])


def phase_kernels(x):
    """Each kernel against its plain version on the card (not counted as
    main-path launches: the counts are reset before each main path)."""
    rows = {}
    th_hi, th_lo = x["ths"]
    canvas = x["canvas"]

    # K1 bit for bit against the plain version on the padded canvas: the
    # main path's canvas (no pad rows or columns) and a smaller one with both.
    for image in (canvas, x["small_canvas"]):
        got = level.level_preprocess(image, th_hi, th_lo)
        padded, hp, wp = level.pad_level(image)
        want = level.level_preprocess_plain(padded, hp, wp, th_hi, th_lo)
        torch.cuda.synchronize()
        err = max(max_abs(g, w) for g, w in zip(got, want))
        log(f"K1 level_preprocess {tuple(image.shape)} -> 3x{tuple(got[0].shape)}: "
            f"max|d| = {err:g}")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K1 is not bit-exact: it differs by up to {err}")
    rows["level_preprocess"] = 0.0

    # K2 bit for bit on the main canvas's maps, on the 320x240 canvas's
    # (pad rows and columns, another width) and with every cell low.
    _, s_hi, s_lo = level.level_preprocess(x["small_canvas"], th_hi, th_lo)
    for what, hi, lo, bounds in (
            ("main canvas", x["hi"], x["lo"], x["bounds"]),
            ("320x240 canvas", s_hi, s_lo, x["small_bounds"]),
            ("every cell low", torch.zeros_like(x["hi"]), x["lo"], x["bounds"])):
        got = level.combine_nms(hi, lo, bounds)
        want = level.combine_nms_plain(hi, lo, bounds)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 differs on the {what}: max|d| = {max_abs(got, want)}")
        log(f"K2 combine_nms, {what} {tuple(hi.shape)}: exact "
            f"({int((got > 0).sum())} maxima)")
    rows["combine_nms"] = 0.0

    # K3 bit for bit: the map form on the main canvas's score map, on the
    # 320x240 canvas's, on a width that is not a multiple of 4 (read entry
    # by entry, its last cell's columns zero) and with 30-pixel cells (rows
    # of 900, -inf past them); the row form on the main map's cell matrix.
    score, cell, k = x["score"], x["cell"], x["k"]
    for what, m, c in (("main canvas", score, cell), ("320x240 canvas", x["small_score"], cell),
                       ("width 598", score[:, :598].contiguous(), cell),
                       ("30-pixel cells", score[: score.shape[0] // 30 * 30], 30)):
        gv, ga = select.cell_topk_map(m, c, k)
        wv, wa = select.cell_topk_map_plain(m, c, k)
        torch.cuda.synchronize()
        if not (torch.equal(gv, wv) and torch.equal(ga, wa)):
            raise AssertionError(
                f"K3 map form differs on the {what}: vals {max_abs(gv, wv)}, "
                f"args {max_abs(ga, wa)}")
        log(f"K3 cell_topk_map, {what} {tuple(m.shape)}, cell {c}, k={k}: exact "
            f"({gv.shape[0]} cells, {int(torch.isinf(gv).sum())} -inf slots)")
    gv, ga = select.cell_topk(x["cells"], k)
    wv, wa = select.cell_topk_plain(x["cells"], k)
    torch.cuda.synchronize()
    if not (torch.equal(gv, wv) and torch.equal(ga, wa)):
        raise AssertionError(
            f"K3 differs: vals {max_abs(gv, wv)}, args {max_abs(ga, wa)}")
    log(f"K3 cell_topk {tuple(x['cells'].shape)} k={k}: exact")
    rows["cell_topk_map"] = rows["cell_topk"] = 0.0

    # The fused K4 + K5 launch, and the standalone K4 and K5 on the same
    # inputs (the standalone K5 on the plain 31x31 windows).
    rows["describe_patches"] = rows["extract_patches"] = rows["corner_subpix"] = 0.0
    for what, (c, b, yx) in describe_problems(x):
        rows["describe_patches"] = max(rows["describe_patches"], check_describe(what, c, b, yx))
        for img, p in ((c, 31), (b, 39), (c, 17)):
            check_extract(what, img, yx, p)
        ic = patches.extract_patches_plain(c, yx, patches.PATCH_SIZE)
        rows["corner_subpix"] = max(rows["corner_subpix"], check_k5(what, ic))

    for what, args in k6_problems(x):
        check_k6(what, args)
    rows["projection_hamming_top2"] = 0.0

    for what, args in band_problems(x):
        check_band(what, args)
    rows["stereo_band_top2"] = 0.0

    # K7 under a caller's mask on the stereo band's masks; K7 under each
    # candidate test on its callers' recorded calls and on interop's cases
    # (also against K7 under the mask it replaces); K6 with a batch axis on
    # its fuse problems.
    for what, args in [("stereo band mask", a) for a in x["k7"]]:
        check_top2("K7 masked_hamming_top2", what, kmatching.masked_hamming_top2,
                   kmatching.masked_hamming_top2_plain, args, args[2].shape)
    rows["masked_hamming_top2"] = 0.0
    for what, name, args in k7_problems(x):
        check_form(what, name, args)
    rows.update({name: 0.0 for name in K7_FORMS})
    for what, args in batched_k6_problems(x):
        check_top2("K6 projection_hamming_top2", what,
                   lambda *a: kmatching.projection_hamming_top2(*a)[0],
                   lambda *a: kmatching.projection_hamming_top2_plain(*a)[0], args,
                   (*args[1].shape[:2], args[6].shape[1]))

    # K8 on the pairs' four problems and on one stereo problem tiled past
    # 1024 rows; each launched twice, which must give the same bits.
    worst = 0.0
    problems = [("pair", a) for a in x["k8"]] + [("stereo pair", a) for a in x["k8_stereo"]]
    problems += [("stereo pair, tiled", tiled_problem(x["k8_stereo"][0], n))
                 for n in K8_TILED_ROWS]
    for path, args in problems:
        worst = max(worst, check_k8(path, args))
    if not int((x["k8_stereo"][0][3].is_stereo & x["k8_stereo"][0][3].valid).sum()):
        raise AssertionError("the stereo pair gave K8 no stereo row")
    # With no valid observation every step is rejected: the pose stays put.
    R0, t0, points, obs, *cam = x["k8"][0]
    none = obs._replace(valid=torch.zeros_like(obs.valid),
                        is_stereo=torch.zeros_like(obs.is_stereo))
    got = pose_lm.pose_lm(R0, t0, points, none, *cam)
    torch.cuda.synchronize()
    if not (torch.equal(got.R, R0) and torch.equal(got.t, t0) and int(got.n_inliers) == 0):
        raise AssertionError("K8 moved the pose without a valid observation")
    log("K8 pose_lm with no valid observation: pose unchanged, 0 inliers")
    rows["pose_lm"] = worst
    return rows


def check_k8(path, args):
    """K8 against its plain version on one problem, launched twice (the
    same bits): the pose within ROT_DEG_TOL / T_TOL, at most K8_INLIER_TOL
    of the inlier flags differing, n_inliers the flags' int64 count ->
    the largest |d| of R and t."""
    got = pose_lm.pose_lm(*args)
    again = pose_lm.pose_lm(*args)
    want = pose_opt.pose_optimization_plain(*args)
    torch.cuda.synchronize()
    d_rot = rot_angle_deg(got.R.cpu(), want.R.cpu())
    d_t = float((got.t - want.t).norm())
    obs = args[3]
    n_obs = obs.valid.shape[0]
    differ = int((got.inliers != want.inliers).sum())
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"K8 pose_lm on the {path}, O={n_obs} ({int((obs.is_stereo & obs.valid).sum())} "
        f"stereo rows): rot {d_rot:.3g} deg, |dt| {d_t:.3g}, max|dR| "
        f"{max_abs(got.R, want.R):.3g}, inliers {int(got.n_inliers)} vs "
        f"{int(want.n_inliers)}, {differ} flags differ; repeat bit-identical: {same}")
    if not (d_rot < ROT_DEG_TOL and d_t < T_TOL and differ <= K8_INLIER_TOL * n_obs):
        raise AssertionError("K8 differs from its plain version beyond the bounds")
    if not same:
        raise AssertionError("two K8 launches on one input differ")
    n = got.n_inliers
    if n.dtype != torch.int64 or n.dim() != 0 or n.device != args[2].device \
            or int(n) != int(got.inliers.sum()):
        raise AssertionError(f"K8 n_inliers {n!r} is not the inliers' int64 count")
    return max(max_abs(got.R, want.R), max_abs(got.t, want.t))


# ---------------------------------------------------------------------------
# Phase 4: the main paths, their launch counts, and the CPU
# ---------------------------------------------------------------------------

def check_counts(what, counts, want):
    log(f"{what} launches: {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, expected {want}")


def _feature_diffs(card, cpu):
    """card / cpu: dicts of numpy xy, response, octave, valid, desc (and
    angle). -> (max keypoint |d| px, descriptors that differ [N] bool,
    max response |d|, max angle |d| or None)."""
    d_xy = float(np.abs(card["xy"] - cpu["xy"]).max())
    desc = np.any(card["desc"] != cpu["desc"], axis=1)
    d_resp = float(np.abs(card["response"] - cpu["response"]).max())
    d_ang = (float(np.abs(card["angle"] - cpu["angle"]).max())
             if "angle" in card else None)
    return d_xy, desc, d_resp, d_ang


def check_same_canvas(what, image, config):
    """Extraction after the pyramid, on the card's canvas, on the card and
    on the CPU: octaves, valid flags, responses, angles and descriptors bit
    for bit, refined keypoints within XY_TOL (K5 against its plain
    version)."""
    cam, orb = config.camera, config.orb
    plan = pe.make_plan(orb, cam.height, cam.width)
    canvas = pe.build_canvas(image, plan)
    card, cpu = (interop.features_to_numpy(pe.features_from_canvas(c, plan, orb))
                 for c in (canvas, canvas.cpu()))
    d_xy, desc, d_resp, d_ang = _feature_diffs(card, cpu)
    log(f"{what} on the card's canvas, card vs cpu: keypoints max|d| {d_xy:.3g} px, "
        f"{int(desc.sum())} descriptors differ, responses max|d| {d_resp:g}, "
        f"angles max|d| {d_ang:g}")
    for key in ("octave", "valid", "response", "angle", "desc"):
        if not np.array_equal(card[key], cpu[key]):
            raise AssertionError(f"{what}: {key} differs between card and CPU")
    if not d_xy <= XY_TOL:
        raise AssertionError(f"{what}: keypoints differ by {d_xy} px")


def check_features(what, card, cpu, scale=1.2):
    """End to end, each device from the image: octaves and valid flags bit
    for bit, refined keypoints within XY_TOL, and at level 0 (the image
    itself) descriptors and responses bit for bit. Above level 0 the
    canvas comes from the pyramid's resize products, which the card's and
    the CPU's BLAS sum in different orders, so blurred values, responses
    and angles differ in the last bits and descriptor bits flip where two
    samples tie (ROADMAP.md section 3); those differences are printed.
    scale: the pyramid's scale factor."""
    for key in ("octave", "valid"):
        if not np.array_equal(card[key], cpu[key]):
            raise AssertionError(f"{what}: {key} differs between card and CPU")
    d_xy, desc, d_resp, _ = _feature_diffs(card, cpu)
    lvl0 = cpu["octave"] == 0
    desc &= cpu["valid"]
    by_level = np.bincount(cpu["octave"][desc], minlength=8).tolist()
    log(f"{what} card vs cpu: keypoints max|d| {d_xy:.3g} px; descriptors that "
        f"differ {int(desc.sum())} of {int(cpu['valid'].sum())} valid "
        f"(by level {by_level}); responses max|d| {d_resp:g}")
    if not d_xy <= XY_TOL:
        # ROADMAP queue 3: once 7.32e-4 px in one process of many. The
        # keypoint's level, and its subpixel offset on each device (its
        # level coordinates less the nearest integer).
        i = int(np.abs(card["xy"] - cpu["xy"]).max(axis=1).argmax())
        lv = int(cpu["octave"][i])
        offs = [(d["xy"][i] / scale ** lv - np.round(d["xy"][i] / scale ** lv)).tolist()
                for d in (card, cpu)]
        log(f"{what}: keypoint {i} at level {lv}: card xy {card['xy'][i].tolist()} offset "
            f"{offs[0]}, cpu xy {cpu['xy'][i].tolist()} offset {offs[1]}")
        raise AssertionError(f"{what}: keypoints differ by {d_xy} px")
    if desc[lvl0].any() or not np.array_equal(card["response"][lvl0], cpu["response"][lvl0]):
        raise AssertionError(f"{what}: level-0 descriptors or responses differ")


def check_pose_and_counts(what, card, cpu):
    """card / cpu: (R, t, n_matches or None, n_inliers)."""
    (R, t, n_m, n_i), (cR, ct, c_m, c_i) = card, cpu
    d_rot, d_t = rot_angle_deg(R, cR), float(np.linalg.norm(t - ct))
    log(f"{what}: card n_matches={n_m} n_inliers={n_i}; cpu n_matches={c_m} "
        f"n_inliers={c_i}; card vs cpu rot {d_rot:.5f} deg, |dt| {d_t:.6f}")
    if not (np.isfinite(R).all() and np.isfinite(t).all()):
        raise AssertionError(f"{what}: non-finite pose")
    for a, b in ((n_m, c_m), (n_i, c_i)):
        if a is not None and abs(a - b) > 0.01 * b:
            raise AssertionError(f"{what}: card and CPU counts differ by more than 1%")
    if not (d_rot < ROT_DEG_TOL and d_t < T_TOL):
        raise AssertionError(f"{what}: card and CPU poses differ beyond the bounds")


def phase_step(config, args):
    """The tracking step on the card through the entry points, the launch
    counts read around it, and the same step on the CPU."""
    _build.reset_launches()
    res = tracking_forward_step(*args, config)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    check_counts("tracking step", counts, STEP_WANT)

    cpu_args = tuple(a.cpu() for a in args)
    cpu = tracking_forward_step(*cpu_args, config)
    R, t = res.R.cpu().numpy(), res.t.cpu().numpy()
    n_m, n_i = int(res.n_matches), int(res.n_inliers)
    if res.feat_xy.shape != (N_FEATURES, 2):
        raise AssertionError("wrong feature shape")
    R_gt, t_gt = cpu_args[6].numpy(), cpu_args[7].numpy()
    log(f"tracking step vs ground truth of frame 1: rot {rot_angle_deg(R, R_gt):.4f} "
        f"deg, |dt| {np.linalg.norm(t - t_gt):.5f}")
    check_pose_and_counts("tracking step", (R, t, n_m, n_i),
                          (cpu.R.numpy(), cpu.t.numpy(), int(cpu.n_matches),
                           int(cpu.n_inliers)))
    cam = config.camera
    feats = [interop.features_to_numpy(extractor.extract_features(
        im, config.orb, cam.height, cam.width)) for im in (args[0], cpu_args[0])]
    check_features("tracking step extraction", *feats)
    check_same_canvas("tracking step extraction", args[0], config)
    if not np.array_equal(feats[0]["xy"], res.feat_xy.cpu().numpy()):
        raise AssertionError("the step's keypoints are not its extraction's")
    if n_m < 100 or n_i < 0.8 * n_m:
        raise AssertionError("too few matches or inliers on the card")
    return counts


def _packed_features(feat, desc):
    return dict(xy=feat[:, 0:2], response=feat[:, 4], octave=feat[:, 6].astype(np.int32),
                valid=feat[:, 7] > 0.5, desc=desc)


def check_stereo_columns(what, f, cf, bf):
    """The stereo pair's depth and ur columns, card vs CPU end to end: at
    most STEREO_FLIP_TOL of the features differ in stereo validity, and on
    each device depth = bf / (x - ur) to DEPTH_RTOL."""
    ok, c_ok = f[:, 9] >= 0, cf[:, 9] >= 0
    both = ok & c_ok
    log(f"{what} stereo matches: card {int(ok.sum())}, cpu {int(c_ok.sum())}, "
        f"{int((ok != c_ok).sum())} differ; u_right max|d| where both "
        f"{float(np.abs(f[both, 9] - cf[both, 9]).max()):.3g} px")
    if (ok != c_ok).mean() > STEREO_FLIP_TOL or ok.sum() < 0.3 * len(ok):
        raise AssertionError(f"{what}: stereo matches differ between card and CPU")
    for side in (f, cf):
        v = side[:, 9] >= 0
        if not ((side[~v, 8:10] == -1).all() and np.allclose(
                side[v, 8], bf / (side[v, 2] - side[v, 9]), rtol=DEPTH_RTOL, atol=0)):
            raise AssertionError(f"{what}: depth is not bf / (x - u_right)")


def stereo_match_args(config, image_l, image_r):
    """stereo_match's arguments as stereo_frontend builds them: both
    images' features and pyramid stacks, bf, the baseline, the scale
    factors."""
    cam, orb = config.camera, config.orb
    shapes = orb.level_shapes(cam.height, cam.width)
    fl, fr = (extractor.extract_features(im, orb, cam.height, cam.width)
              for im in (image_l, image_r))
    stacks = [stereo.pyramid_stack(pyramid.build_pyramid(im, shapes))
              for im in (image_l, image_r)]
    return (fl.xy, fl.octave, fl.desc, fl.valid, fr.xy, fr.octave, fr.desc,
            fr.valid, *stacks, cam.bf, cam.baseline,
            stereo._scale_factors(image_l.device, orb))


def check_same_canvas_stereo(config, image_l, image_r):
    """The stereo matcher (K7 twice, SAD scan, median cut) on the card's
    own features and pyramid stacks, run on the card and on the CPU: valid
    flags equal, u_right within U_RIGHT_TOL, depth = bf / (x - u_right)."""
    cam = config.camera
    args = stereo_match_args(config, image_l, image_r)
    card = stereo.stereo_match(*args)
    cpu = stereo.stereo_match(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    card = [t.cpu().numpy() for t in card]
    cpu = [t.numpy() for t in cpu]
    v = cpu[2]
    d_u = float(np.abs(card[0] - cpu[0])[v].max()) if v.any() else 0.0
    log(f"stereo match on the card's features and pyramids, card vs cpu: "
        f"{int(card[2].sum())} / {int(v.sum())} valid, u_right max|d| {d_u:.3g} px "
        f"(bit-exact: {np.array_equal(card[0], cpu[0])}), depth bit-exact: "
        f"{np.array_equal(card[1], cpu[1])}")
    if not np.array_equal(card[2], v) or not d_u <= U_RIGHT_TOL or v.sum() < 0.3 * len(v):
        raise AssertionError("stereo match differs between card and CPU")
    x = args[0][:, 0].cpu().numpy()
    for u_right, depth, valid in (card, cpu):
        if not np.allclose(depth[valid], cam.bf / (x[valid] - u_right[valid]),
                           rtol=DEPTH_RTOL, atol=0):
            raise AssertionError("stereo depth is not bf / (x - u_right)")


def check_rgbd_columns(what, f, cf):
    """The RGB-D pair's depth and ur columns, card vs CPU: depth bit for
    bit wherever both devices round the raw keypoint to the same pixel, ur
    within UR_TOL there."""
    same_px = np.all(np.round(f[:, 2:4]) == np.round(cf[:, 2:4]), axis=1)
    d_ur = float(np.abs(f[same_px, 9] - cf[same_px, 9]).max())
    log(f"{what}: {int((f[:, 8] > 0).sum())} features with depth (cpu "
        f"{int((cf[:, 8] > 0).sum())}); {int((~same_px).sum())} keypoints round to "
        f"another pixel; ur max|d| {d_ur:.3g} px")
    if not np.array_equal(f[same_px, 8], cf[same_px, 8]) or not d_ur <= UR_TOL:
        raise AssertionError(f"{what}: depth or ur differs between card and CPU")


def phase_pair(config, motion, cands):
    """A pair on the card through the entry points, the launch counts read
    around it, and the same calls on the CPU."""
    what = PATH[config.sensor]
    _build.reset_launches()
    out, lm = run_pair(config, motion, cands)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    check_counts(what, counts, WANT[config.sensor])

    cpu_out, cpu_lm = run_pair(config, tuple(a.cpu() for a in motion),
                               tuple(a.cpu() for a in cands))
    (m, f, d), (cm, cf, cd) = (interop.packed_to_numpy(*o) for o in (out, cpu_out))
    (lmm, lmf, lmv), (clm, clf, clv) = (interop.packed_to_numpy(*o) for o in (lm, cpu_lm))
    for name, a in (("motion meta", m), ("motion features", f), ("local-map meta", lmm)):
        if not np.isfinite(a).all():
            raise AssertionError(f"{what}: non-finite {name}")
    if f.shape != (N_FEATURES, 12) or lmf.shape != (N_FEATURES, 2) \
            or lmv.shape != (N_CANDIDATES,):
        raise AssertionError(f"{what}: wrong output shapes")
    check_features(f"{what} extraction", _packed_features(f, d), _packed_features(cf, cd))
    check_same_canvas(f"{what} extraction", motion[0], config)
    if config.sensor == "stereo":
        check_stereo_columns(what, f, cf, config.camera.bf)
        check_same_canvas_stereo(config, motion[0], motion[1])
    elif config.sensor == "rgbd":
        check_rgbd_columns(what, f, cf)
    check_pose_and_counts(f"{what} motion stage",
                          (m[0:9].reshape(3, 3), m[9:12], int(m[12]), int(m[13])),
                          (cm[0:9].reshape(3, 3), cm[9:12], int(cm[12]), int(cm[13])))
    # The local-map stage's matches: the features bound after it, kept
    # from the motion stage or newly bound to a candidate.
    new, c_new = lmf[:, 0] >= 0, clf[:, 0] >= 0
    bound = new | ((f[:, 10] >= 0) & (f[:, 11] > 0.5))
    c_bound = c_new | ((cf[:, 10] >= 0) & (cf[:, 11] > 0.5))
    log(f"{what} local-map stage: {int(lmv.sum())} candidates visible (cpu "
        f"{int(clv.sum())}), {int(new.sum())} new bindings (cpu {int(c_new.sum())})")
    check_pose_and_counts(
        f"{what} local-map stage",
        (lmm[0:9].reshape(3, 3), lmm[9:12], int(bound.sum()), int(lmm[12])),
        (clm[0:9].reshape(3, 3), clm[9:12], int(c_bound.sum()), int(clm[12])))
    if int(m[12]) < 100 or int(m[13]) < 0.8 * int(m[12]) or int(lmm[12]) < int(m[13]):
        raise AssertionError(f"{what}: too few matches or inliers on the card")
    return counts


# ---------------------------------------------------------------------------
# The single-dispatch forms (slam/jit_frontend.py's *_jit): CUDA graphs
# ---------------------------------------------------------------------------

# Each form -> its eager function, by name in jit_frontend.
GRAPH_FORMS = ("tracking_forward_step", "fused_motion_track", "fused_stereo_motion_track",
               "fused_rgbd_motion_track", "fused_motion_track_packed",
               "fused_stereo_motion_track_packed", "fused_rgbd_motion_track_packed",
               "fused_local_map_track")
PACKED_FORM = {"monocular": "fused_motion_track_packed",
               "stereo": "fused_stereo_motion_track_packed",
               "rgbd": "fused_rgbd_motion_track_packed"}
GRAPH_FPS_BLOCKS = 1
# phase_graph_systems' turns (four until PR 19: its depth cut).
GRAPH_SYSTEM_TURNS = ("eager", "graphs")
# Graph captures of one form under one configuration in one System run: the
# monocular motion stage sees twice the features after initialization.
GRAPHS_PER_FORM = 2
# The bytes the live graphs' pools held at the end of each System run
# (run_system), before the System released its own, and what the graphs
# it captured still held after its shutdown.
GRAPH_POOL_BYTES = []
GRAPH_POOL_AFTER = []
# (captures, replays, pool bytes at the run's end) of each System run.
RUN_GRAPHS = []
# Each kernel of the tracker's forms -> the CUDA function its launch runs
# (csrc/), as torch.profiler names it. K2's launch also runs
# cell_flag_kernel, which is not counted.
KERNEL_SYMBOLS = {"level_preprocess": "level_kernel", "combine_nms": "combine_nms_kernel",
                  "cell_topk_map": "cell_topk_kernel", "describe_patches": "describe_kernel",
                  "projection_hamming_top2": "projection_top2_kernel",
                  "stereo_band_top2": "stereo_band_top2_kernel", "pose_lm": "pose_lm_kernel"}


def bundle_adjust_early(problem, fx, fy, cx, cy, bf, n_iters=10, use_robust=True,
                        point_chunk=1024, lam0=1e-4, axis_name=None, solver="auto",
                        point_sharded=False, *, segs=None):
    """bundle_adjust_jit's parameters onto the early-exit form
    (ba.bundle_adjust, whose group parameter sits after solver)."""
    return ba.bundle_adjust(problem, fx, fy, cx, cy, bf, n_iters, use_robust, point_chunk,
                            lam0, solver, axis_name, point_sharded, segs=segs)


# The mapper's and the loop closer's single-dispatch forms -> their eager
# functions (module, form, eager function): BA's early-exit form,
# the pose graph's eager loop, the mapper's two batched functions.
MAPPER_FORMS = ((ba, "bundle_adjust_jit", bundle_adjust_early),
                (pose_graph, "optimize_sim3_graph_jit", pose_graph.optimize_sim3_graph),
                (jit_mapper, "fused_triangulation_jit", jit_mapper.fused_triangulation),
                (jit_mapper, "fused_fuse_forward_jit", jit_mapper.fused_fuse_forward))
# The staged tracker's single-dispatch forms -> their eager functions
# (module, form, eager function): the staged frame's extraction and
# stereo front end, the pose LM, the matchers, EPnP RANSAC, the two-view
# bootstrap and the BoW descent.
STAGED_FORMS = ((extractor, "extract_features_jit", extractor.extract_features),
                (stereo, "stereo_frontend_jit", stereo.stereo_frontend),
                (pose_opt, "pose_optimization_jit", pose_opt.pose_optimization),
                (matchers, "match_for_initialization_jit", matchers.match_for_initialization),
                (matchers, "match_projection_last_frame_jit",
                 matchers.match_projection_last_frame),
                (matchers, "match_brute_force_jit", matchers.match_brute_force),
                (matchers, "search_local_points_jit", matchers.search_local_points),
                (pnp, "epnp_ransac_many_jit", pnp.epnp_ransac_many),
                (twoview, "initialize_two_view_jit", twoview.initialize_two_view),
                (vocabulary, "_descend_jit", vocabulary._descend))


# The loop closer's, the staged mapper's and the AR anchor's
# single-dispatch forms -> their eager functions: the Sim3 RANSAC and LM,
# SearchBySim3 both ways, the loop's and the staged mapper's fuse, the
# staged triangulation matcher, the plane fit. (The loop closer's brute
# force over its candidates is STAGED_FORMS' match_brute_force_jit; the
# sharded global BA is MAPPER_FORMS' bundle_adjust_jit.)
LOOP_FORMS = ((sim3_solver, "sim3_ransac_jit", sim3_solver.sim3_ransac),
              (sim3_opt, "optimize_sim3_jit", sim3_opt.optimize_sim3),
              (matchers, "search_by_sim3_jit", matchers.search_by_sim3),
              (matchers, "match_fuse_jit", matchers.match_fuse),
              (matchers, "match_for_triangulation_jit", matchers.match_for_triangulation),
              (matchers, "search_fuse_jit", matchers.search_fuse),
              (ar, "fit_plane_ransac_jit", ar.fit_plane_ransac))


@contextlib.contextmanager
def eager_forms(forms=None):
    """The module references to every single-dispatch form (the
    tracker's, the staged tracker's, the mapper's and the loop closer's),
    or to `forms` ((module, form, eager function) entries), pointed at
    their eager functions inside the block (an eager run to compare
    with)."""
    if forms is None:
        forms = ([(jit_frontend, f"{n}_jit", getattr(jit_frontend, n)) for n in GRAPH_FORMS]
                 + list(MAPPER_FORMS) + list(STAGED_FORMS) + list(LOOP_FORMS))
    saved = [(module, form, getattr(module, form)) for module, form, _ in forms]
    for module, form, eager in forms:
        setattr(module, form, eager)
    try:
        yield
    finally:
        for module, form, fn in saved:
            setattr(module, form, fn)


def run_pair_graphed(config, motion, cands):
    """run_pair through the single-dispatch forms."""
    out = getattr(jit_frontend, PACKED_FORM[config.sensor] + "_jit")(*motion, config)
    feat_state, lm_meta = interop.local_map_args(out, motion[-3], LM_TH)
    lm = jit_frontend.fused_local_map_track_jit(out[1], out[2], feat_state, *cands, lm_meta,
                                                config)
    return out, lm


def same_bits(a, b):
    """Two results (tensors or tuples of them) equal bit for bit, floats
    included (compared as integers of their width, so NaNs compare too)."""
    xs, ys = tree_leaves(a), tree_leaves(b)
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.view(ints.get(x.dtype, x.dtype)), y.view(ints.get(y.dtype, y.dtype)))
        for x, y in zip(xs, ys))


def graph_form_inputs(config, args, pairs):
    """form name -> (config, [its arguments on the main path's inputs, then
    on two noisy frames of phase_fps]); the local-map form on each
    monocular motion result's features."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def noisy(image):
        return [image] + [image + 0.5 * torch.randn(image.shape, generator=gen, device="cuda")
                          for _ in range(2)]

    forms = {"tracking_forward_step": (config, [(im,) + tuple(args[1:])
                                                for im in noisy(args[0])])}
    for sensor, (cfg, motion, cands) in pairs.items():
        n_img = 1 if sensor == "monocular" else 2
        pt_f32, pt_desc, meta = motion[n_img:]
        pt_pos, pt_oct, pt_ang, pt_val, R, t, tz = jit_frontend._unpack_inputs(pt_f32, meta)
        tail = (pt_pos, pt_desc, pt_oct, pt_ang, pt_val, R, t) + (
            (tz,) if sensor != "monocular" else ())
        packed = [(im,) + motion[1:] for im in noisy(motion[0])]
        forms[PACKED_FORM[sensor]] = (cfg, packed)
        forms[PACKED_FORM[sensor].replace("_packed", "")] = (
            cfg, [p[:n_img] + tail for p in packed])
        if sensor == "monocular":
            lm = []
            for p in packed:
                out = jit_frontend.fused_motion_track_packed(*p, cfg)
                feat_state, lm_meta = interop.local_map_args(out, pt_f32, LM_TH)
                lm.append((out[1], out[2], feat_state) + tuple(cands) + (lm_meta,))
            forms["fused_local_map_track"] = (cfg, lm)
    return forms


def phase_graphs(config, args, pairs):
    """Each single-dispatch form at full width: the first call captures its
    graph and later calls only replay it; a replay's every output equal bit
    for bit to the eager call's on the same inputs, and its launches per
    kernel the eager call's; two replays on two noisy frames each equal to
    its own eager call, the first one's result unchanged after the second;
    a call given the graph's own input buffers equal too. It starts and
    ends with no graph held, so each form's first call captures."""
    cuda_graph.release()
    for name, (cfg, calls) in graph_form_inputs(config, args, pairs).items():
        jit, eager = getattr(jit_frontend, f"{name}_jit"), getattr(jit_frontend, name)
        keys, caps = set(cuda_graph.graphs), cuda_graph.n_captures()
        jit(*calls[0], cfg)
        new = [g for k, g in cuda_graph.graphs.items() if k not in keys]
        if len(new) != 1 or new[0].replays != 1:
            raise AssertionError(f"{name}_jit: the first call made {len(new)} captures")
        g = new[0]
        torch.cuda.synchronize()
        _build.reset_launches()
        want = eager(*calls[0], cfg)
        torch.cuda.synchronize()
        eager_counts = {k: v for k, v in _build.launches.items() if v}
        _build.reset_launches()
        got = jit(*calls[0], cfg)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _build.launches.items() if v}
        if counts != eager_counts:
            raise AssertionError(f"{name}_jit: a replay launched {counts}, the eager call "
                                 f"{eager_counts}")
        if not same_bits(got, want):
            raise AssertionError(f"{name}_jit: the replay differs from the eager call")
        first = jit(*calls[1], cfg)
        held = tree_map(torch.clone, first)
        second = jit(*calls[2], cfg)
        wants = [eager(*c, cfg) for c in calls[1:]]
        torch.cuda.synchronize()
        if not (same_bits(first, wants[0]) and same_bits(second, wants[1])):
            raise AssertionError(f"{name}_jit: a replay on a noisy frame differs from its "
                                 f"eager call")
        if not same_bits(first, held):
            raise AssertionError(f"{name}_jit: a held result changed at the next replay")
        for buf, a in zip(g.inputs, calls[1]):
            buf.copy_(a)
        own = jit(*g.inputs, cfg)
        torch.cuda.synchronize()
        if not same_bits(own, wants[0]):
            raise AssertionError(f"{name}_jit: a call on the graph's own inputs differs")
        if cuda_graph.n_captures() - caps != 1 or g.replays != 5:
            raise AssertionError(f"{name}_jit: {cuda_graph.n_captures() - caps} captures, "
                                 f"{g.replays} replays of 5 calls")
        log(f"{name}_jit: captured once, 5 replays, each bit for bit its eager call's "
            f"(a held result unchanged); launches per replay {counts}; graph pool "
            f"{g.pool_bytes} bytes")
    cuda_graph.release()


# phase_graph_timing's turns (four before its depth cut).
GRAPH_TIMING_TURNS = ("eager", "graphs")


def phase_graph_timing(config, args, pairs, power):
    """Eager against replayed, in turns (GRAPH_TIMING_TURNS) in this
    process: the step's and each pair's frames/s by phase_fps's
    recipe (GRAPH_FPS_BLOCKS blocks), and each one's device busy time and
    idle share under torch.profiler (profiled_calls: it sees the kernels
    of a replayed graph). The profiled calls' kernels, counted by name,
    equal the launches the calls added (for the graphs: what their replays
    added, the tallies recorded at capture; counted_profile)."""
    image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t = args
    paths = {"tracking step": (lambda step: lambda im, fb: step(
        im, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t + 0.0 * fb,
        config).n_inliers, (tracking_forward_step, jit_frontend.tracking_forward_step_jit),
        image, lambda step: lambda: step(*args, config))}
    for sensor, (cfg, motion, cands) in pairs.items():
        def make(pair, cfg=cfg, motion=motion, cands=cands):
            return lambda im, fb: pair(cfg, (im,) + motion[1:-1] + (motion[-1] + 0.0 * fb,),
                                       cands)[1][0][12]

        def once(pair, cfg=cfg, motion=motion, cands=cands):
            return lambda: pair(cfg, motion, cands)
        paths[PATH[sensor]] = (make, (run_pair, run_pair_graphed), motion[0], once)
    for what, (make, (eager, graphed), image, once) in paths.items():
        rows = {"eager": [], "graphs": []}
        for kind in GRAPH_TIMING_TURNS:
            fn = eager if kind == "eager" else graphed
            fps = phase_fps(f"{what} ({kind})", make(fn), image, power, GRAPH_FPS_BLOCKS)
            once(fn)()
            rows[kind].append((fps,) + counted_profile(f"{what} ({kind})", once(fn)))
        log(f"{what}, eager against graphs in turns: " + "; ".join(
            f"{kind} frames/s {[round(r[0], 2) for r in rs]}, wall ms "
            f"{[round(r[1], 3) for r in rs]}, device busy ms {[round(r[2], 3) for r in rs]}, "
            f"idle share {[round(1.0 - r[2] / r[1], 4) for r in rs]}, device operations "
            f"{[round(r[3]) for r in rs]}" for kind, rs in rows.items())
            + f", on {power}")
    cuda_graph.release()


def counted_profile(what, fn, sessions=5):
    """PROFILE_CALLS calls of fn under torch.profiler -> (wall ms, device
    busy ms, device operations), each per call, from the device records
    inside the calls' window (a record_function range), after one call in
    the session outside it (late in a long process the profiler can drop
    a session's first device records: traced_calls). The window's kernels
    of the tracker's forms, counted by their CUDA function's name
    (KERNEL_SYMBOLS), equal the launches its calls added. More kernels
    than launches, or a launch of another kernel, fails at once; fewer is
    taken again, up to `sessions` sessions, and fails after the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    for i in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            before = dict(_build.launches)
            with record_function("counted calls"):
                t0 = time.perf_counter()
                for _ in range(PROFILE_CALLS):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / PROFILE_CALLS * 1e3
        launches = {k: v - before[k] for k, v in _build.launches.items() if v > before[k]}
        events = prof.events()
        (window,) = [e.time_range for e in events
                     if e.name == "counted calls" and e.device_type == DeviceType.CPU]
        ops = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name != "counted calls"
               and window.start <= e.time_range.start <= window.end]
        seen = {k: sum(1 for e in ops if re.search(rf"\b{sym}\b", e.name))
                for k, sym in KERNEL_SYMBOLS.items()}
        counted = {k: launches.get(k, 0) for k in KERNEL_SYMBOLS}
        if set(launches) - set(KERNEL_SYMBOLS) or any(seen[k] > counted[k] for k in seen):
            raise AssertionError(f"{what}: the profiler saw kernels {seen}, the launch counts "
                                 f"say {launches}")
        if seen == counted and any(seen.values()):
            log(f"{what}: the profiled kernels by name equal the launches counted, "
                f"{ {k: v for k, v in seen.items() if v} } (session {i + 1})")
            busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
            return wall, busy / PROFILE_CALLS, len(ops) / PROFILE_CALLS
        log(f"{what}: session {i + 1} of the profiler saw kernels {seen} of {counted}")
    raise AssertionError(f"{what}: in {sessions} profiler sessions the kernels seen never "
                         f"equalled the launches counted")


# ---------------------------------------------------------------------------
# The System: RGB-D and stereo sequences with synchronous local mapping
# ---------------------------------------------------------------------------

# The kernels whose System inputs phase 3 and the kernel rows use.
SYSTEM_KERNELS = K7_FORMS + ("projection_hamming_top2",)


def has_batch_axis(name, args):
    """Whether a recorded call of K7 under a candidate test or of K6 has a
    leading batch axis (the mapper's calls, relocalization's, loop
    closing's)."""
    return bool(k7_batch(name, args)) if name in K7_FORMS else args[1].dim() == 3


# The mapper's batched functions' graphs (the triangulation's matcher,
# the forward fuse): every K7 and K6 launch of their replays has a batch
# axis.
BATCHED_GRAPHS = ("triangulation_match", "fused_fuse_forward")


def batched_replays():
    """{kernel: launches} that replays of the mapper's batched graphs added
    since the process started."""
    out = {}
    for fn in BATCHED_GRAPHS:
        for k, n in cuda_graph.replayed_by.get(fn, {}).items():
            out[k] = out.get(k, 0) + n
    return out


@contextlib.contextmanager
def batched_launches(counts):
    """counts[name] += 1 for each launch of K7 under a candidate test or
    of K6 with a batch axis: read off the kernel's launch counter around
    each call of its wrapper, and added by the replays of the mapper's
    batched graphs inside the block."""
    fns = {name: getattr(kmatching, name) for name in SYSTEM_KERNELS}
    replayed = batched_replays()

    def spy(name):
        def call(*args):
            before = _build.launches[name]
            out = fns[name](*args)
            if has_batch_axis(name, args):
                counts[name] += _build.launches[name] - before
            return out
        return call

    for name in SYSTEM_KERNELS:
        counts[name] = 0
        setattr(kmatching, name, spy(name))
    try:
        yield counts
    finally:
        for name, fn in fns.items():
            setattr(kmatching, name, fn)
        for name, n in batched_replays().items():
            counts[name] += n - replayed.get(name, 0)


def system_sequence(sensor, kidnap=False):
    """(config, images [T, H, W], depth maps or right images (None for the
    monocular sweep), ground-truth poses) of the sensor's sequence; with
    kidnap the sweep's KIDNAP frames are a flat 96-grey image."""
    config = synthetic_config(WIDTH, HEIGHT, N_FEATURES, sensor=sensor)
    if sensor == "monocular":
        images, poses, _ = synthetic.render_sequence(
            config.camera, n_frames=MONO_FRAMES, **MONO_SCENE)
        if kidnap:
            images[list(KIDNAP)] = 96.0
        return config, images, None, poses
    if sensor == "rgbd":
        images, poses, _, depths = synthetic.render_sequence(
            config.camera, n_frames=SYSTEM_FRAMES, with_depth=True, **SYSTEM_SCENE)
        return config, images, depths, poses
    lefts, rights, poses, _ = synthetic.render_stereo_sequence(
        config.camera, n_frames=SYSTEM_FRAMES, **SYSTEM_SCENE)
    return config, lefts, rights, poses


def run_system(seq, device="cuda", n_frames=SYSTEM_FRAMES, around=None, vocabulary=None,
               async_mapping=False, track_s=None, first_frame=0, sys_=None):
    """A System over the sequence through its entry point (track_monocular,
    track_rgbd or track_stereo) on `device`, without a vocabulary unless
    one is given, then its shutdown (an asynchronous System's queue
    drained, its threads joined) -> (system, state name per frame, pose per
    frame, seconds). around(i): a context manager around frame i; track_s:
    a list that gets each entry call's seconds (the caller's thread); the
    frames from first_frame on; sys_: a System to drive in place of a new
    one."""
    config, first, second, _ = seq
    if sys_ is None:
        sys_ = System(config, vocabulary=vocabulary, async_mapping=async_mapping,
                      device=device)
    if config.sensor == "monocular":
        def track(i):
            return sys_.track_monocular(first[i], i / config.camera.fps)
    else:
        entry = sys_.track_rgbd if config.sensor == "rgbd" else sys_.track_stereo

        def track(i):
            return entry(first[i], second[i], i / config.camera.fps)
    states, poses = [], []
    keys, caps, reps = set(cuda_graph.graphs), cuda_graph.n_captures(), cuda_graph.n_replays()
    t0 = time.perf_counter()
    for i in range(first_frame, first_frame + n_frames):
        t1 = time.perf_counter()
        with around(i) if around else contextlib.nullcontext():
            poses.append(track(i))
        if track_s is not None:
            track_s.append(time.perf_counter() - t1)
        states.append(sys_.tracking_state().name)
    check_system_graphs(sys_, keys, caps, reps)
    sys_.shutdown()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    left = [g for k, g in cuda_graph.graphs.items() if k not in keys]
    GRAPH_POOL_AFTER.append(sum(g.pool_bytes for g in left))
    if left:
        log(f"System {config.sensor}: {len(left)} of its graphs left after shutdown, "
            f"holding {GRAPH_POOL_AFTER[-1]} bytes")
    return sys_, states, poses, seconds


def system_name(sensor):
    return f"System {'RGB-D' if sensor == 'rgbd' else sensor}"


# Each synchronous System sequence's runs in this process (name -> [(run,
# fingerprint)]), held bit for bit to its first run: every run builds a
# fresh System, every sampler is seeded, and BA's and the pose graph's
# sums add in an order fixed by the data (optim/segment.py).
RUNS = {}
# Each synchronous System sequence's frames/s in phase_system.
SYSTEM_FPS = {}


def fingerprint(sys_):
    """What a run leaves behind: each frame's trajectory entry (its
    reference keyframe, pose relative to it, lost or not), the keyframes
    (frame ids, kept or culled, poses) and the points (positions, kept)."""
    m = sys_.map
    n = m.next_kf
    tr = sys_.tracker.trajectory
    return {
        "frames' reference keyframes": np.asarray([e.ref_kf for e in tr]),
        "frames lost": np.asarray([e.lost for e in tr]),
        "frames' relative poses": np.asarray(
            [np.concatenate([e.R_rel.ravel(), e.t_rel]) for e in tr]).reshape(len(tr), 12),
        "keyframes' frame ids": m.kf_frame_id[:n].copy(),
        "keyframes kept": m.kf_valid[:n].copy(),
        "keyframe poses": np.concatenate([m.kf_pose_R[:n].reshape(n, 9), m.kf_pose_t[:n]], 1),
        "point positions": m.pt_pos[:m.next_pt].copy(),
        "points kept": m.pt_valid[:m.next_pt].copy(),
    }


def remember(name, run, sys_):
    RUNS.setdefault(name, []).append((run, fingerprint(sys_)))


def first_difference(a, b):
    """Where two fingerprint arrays first differ (row index, and both rows
    or shapes)."""
    if a.shape != b.shape:
        return f"shapes {a.shape} and {b.shape}"
    rows = np.nonzero(~np.all((a == b).reshape(a.shape[0], -1), axis=1))[0]
    i = int(rows[0])
    return f"{rows.size} rows differ, first row {i}: {a[i].tolist()} against {b[i].tolist()}"


def check_same_bits(name):
    """Every run of the sequence against its first, bit for bit."""
    runs = RUNS.get(name, [])
    if len(runs) < 2:
        raise AssertionError(f"{name}: {len(runs)} runs to compare")
    first_run, first = runs[0]
    for run, fp in runs[1:]:
        for key, want in first.items():
            got = fp[key]
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"{name}: the {run} run differs from the {first_run} run "
                                     f"in its {key}: {first_difference(got, want)}")
    log(f"{name}: {len(runs)} runs ({', '.join(r for r, _ in runs)}) bit-identical: "
        f"{first['frames lost'].size} frames' trajectory entries, "
        f"{first['keyframes kept'].size} keyframes, {first['points kept'].size} points")


@contextlib.contextmanager
def triangulation_counted(made):
    """Append to `made` the points each keyframe's triangulation makes."""
    fn = LocalMapper._create_new_points_batched

    def spy(self, kf):
        before = self.map.next_pt
        fn(self, kf)
        made.append(self.map.next_pt - before)

    LocalMapper._create_new_points_batched = spy
    try:
        yield made
    finally:
        LocalMapper._create_new_points_batched = fn


@contextlib.contextmanager
def profiled(out, key, device_only=False):
    """torch.profiler around the block -> out[key] = (wall ms, device busy
    ms, device operations); device_only: the device's activity alone (a
    lighter trace, for whole System runs). A session whose device records
    the profiler dropped (it has, late in a long process: PRs 11, 17 and
    18) leaves out[key] unset and is logged; each caller requires the
    sessions it reports."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([] if device_only else [ProfilerActivity.CPU])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    if not any(e.device_type == DeviceType.CUDA for e in prof.events()):
        log(f"profiled {key}: the profiler recorded no device operation in this session "
            f"(its records dropped); left out")
        return
    n_ops, busy = device_ops(prof)
    out[key] = (wall, busy, n_ops)


def system_path_inputs(seqs):
    """One warm-up run of each sequence on the card, eager (eager_forms:
    the recorded arguments are the wrappers' own, not a graph's buffers;
    every kernel built and every table made before the timed runs),
    recording the System's calls of K7 under the validity flags
    (reference-keyframe tracking) and under the epipolar band
    (triangulation, with a batch axis) and of K6 with a batch axis (the
    forward fuse pass) on the RGB-D sequence: the first SYSTEM_RECORDED
    calls of each; and its first local BA, triangulation and fuse pass
    (MAPPER_UNITS, for phase_mapper_graphs)."""
    out = {}
    for sensor, seq in seqs.items():
        calls = {name: [] for name in SYSTEM_KERNELS}
        units = {name: [] for name in MAPPER_UNITS}
        with contextlib.ExitStack() as stack:
            stack.enter_context(eager_forms())
            for name in SYSTEM_KERNELS:
                stack.enter_context(recording(kmatching, name, calls[name]))
            if sensor == "rgbd":
                for name, (module, attr) in MAPPER_UNITS.items():
                    stack.enter_context(recording(module, attr, units[name], keep=1))
            sys_, states, _, seconds = run_system(seq, vocabulary="default")
        remember(system_name(sensor), "warm-up", sys_)
        split = {(name, batched): [c[0] for c in calls[name]
                                   if has_batch_axis(name, c[0]) == batched]
                 for name in SYSTEM_KERNELS for batched in (False, True)}
        log(f"System {sensor} warm-up: {seconds:.2f} s for {SYSTEM_FRAMES} frames, "
            f"{sys_.map.next_kf} keyframes inserted; calls (kernel, batch axis): "
            f"{ {k: len(v) for k, v in split.items()} }")
        if sensor == "rgbd":
            out = dict(sys_k7=split["valid_hamming_top2", False],
                       sys_k7b=split["epipolar_hamming_top2", True],
                       sys_k6b=split["projection_hamming_top2", True])
            for key, c in list(out.items()) + list(units.items()):
                if not c:
                    raise AssertionError(f"the System's RGB-D run made no {key} call")
            MAPPER_RECORDED.update({name: c[0] for name, c in units.items()})
    return {key: c[:SYSTEM_RECORDED] for key, c in out.items()}


def system_vs_cpu(seq):
    """The sequence's first SYSTEM_CPU_FRAMES frames on the card and on the
    CPU, on the route the card takes (fused, forced there), each past its
    first local BA: the same states and keyframes, frame poses and the
    keyframe poses the BAs left within ROT_DEG_TOL / T_TOL of each other.
    The card's and the CPU's pyramids differ above level 0 (ROADMAP queue
    3), so this holds the outcome, not the bits."""
    with env_set(ORB_TPU_FUSED_TRACK="1"):
        cpu_sys, states, poses, seconds = run_system(seq, "cpu", SYSTEM_CPU_FRAMES,
                                                     vocabulary="default")
    card_sys, card_states, card_poses, _ = run_system(seq, "cuda", SYSTEM_CPU_FRAMES,
                                                      vocabulary="default")
    n_lba = [int(s_.timings().get("map_lba", {}).get("count", 0)) for s_ in (card_sys, cpu_sys)]
    if min(n_lba) < 1:
        raise AssertionError(f"System RGB-D, first {SYSTEM_CPU_FRAMES} frames: local BA ran "
                             f"{n_lba} times (card, cpu)")
    worst = (0.0, 0.0)
    for i in range(SYSTEM_CPU_FRAMES):
        if states[i] != card_states[i] or (poses[i] is None) != (card_poses[i] is None):
            raise AssertionError(f"System frame {i}: card {card_states[i]}, cpu {states[i]}")
        if poses[i] is not None:
            d = (rot_angle_deg(poses[i][0], card_poses[i][0]),
                 float(np.linalg.norm(poses[i][1] - card_poses[i][1])))
            worst = tuple(max(a, b) for a, b in zip(worst, d))
    kfs = [(m.next_kf, m.kf_frame_id[:m.next_kf].tolist(), m.kf_valid[:m.next_kf].tolist())
           for m in (card_sys.map, cpu_sys.map)]
    if kfs[0] != kfs[1]:
        raise AssertionError(f"System RGB-D keyframes: card {kfs[0]}, cpu {kfs[1]}")
    kf_worst = (0.0, 0.0)
    cm, pm = card_sys.map, cpu_sys.map
    for k in range(cm.next_kf):
        d = (rot_angle_deg(pm.kf_pose_R[k], cm.kf_pose_R[k]),
             float(np.linalg.norm(pm.kf_pose_t[k] - cm.kf_pose_t[k])))
        kf_worst = tuple(max(a, b) for a, b in zip(kf_worst, d))
    log(f"System RGB-D, first {SYSTEM_CPU_FRAMES} frames card vs cpu ({seconds:.1f} s on "
        f"the CPU; local BA ran {n_lba[0]} times on the card, {n_lba[1]} on the CPU): states "
        f"and keyframes {kfs[0][1]} equal, frame poses within rot {worst[0]:.5f} deg, |dt| "
        f"{worst[1]:.6f}; keyframe poses after the BAs within rot {kf_worst[0]:.5f} deg, "
        f"|dt| {kf_worst[1]:.6f}")
    if not (max(worst[0], kf_worst[0]) < ROT_DEG_TOL and max(worst[1], kf_worst[1]) < T_TOL):
        raise AssertionError("the System's card and CPU poses differ beyond the bounds")


def phase_system(seqs, power):
    """Each sequence on the card through the System's entry point, the
    launch counts reset just before and read just after it: every frame
    after the first OK, the ATE gate, >= 2 keyframes, points made by
    triangulation, a fuse pass, every kernel of the path launched (K6
    and K7 under the epipolar band with a batch axis), and every keyframe in
    the database and through the loop closer; frames/s over the sequence
    (after system_path_inputs' warm-up), the stage times, and a third run
    with frames 3-14 each under torch.profiler (keyframe frames and plain
    frames apart). The RGB-D
    sequence's first frames also against the CPU. -> (launch counts,
    launches with a batch axis), each per sensor."""
    counts, batched_counts = {}, {}
    for sensor, seq in seqs.items():
        what = system_name(sensor)
        _, _, _, gt = seq
        made, batched = [], batched_counts.setdefault(sensor, {})
        _build.reset_launches()
        with triangulation_counted(made), batched_launches(batched):
            sys_, states, poses, seconds = run_system(seq, vocabulary="default")
        remember(what, "counted", sys_)
        c = counts[sensor] = dict(_build.launches)
        log(f"{what} launches: {c}; of them with a batch axis: {batched}")
        want = SYSTEM_LAUNCHED + (("stereo_band_top2",) if sensor == "stereo" else ())
        if [k for k in want if c[k] < 1] or [k for k in SYSTEM_UNUSED if c[k]] or \
                (sensor == "rgbd" and c["stereo_band_top2"]) or c["window_hamming_top2"] or \
                min(batched["epipolar_hamming_top2"], batched["projection_hamming_top2"]) < 1:
            raise AssertionError(f"{what}: a kernel of the path did not launch, or "
                                 f"one off the path did")
        if any(st != "OK" for st in states) or any(p is None for p in poses):
            raise AssertionError(f"{what}: states {states}")
        timings = sys_.timings()
        n_mapped = int(timings.get("local_mapping", {}).get("count", 0))
        n_fuse = int(timings.get("map_fuse", {}).get("count", 0))
        m = sys_.map
        if not np.array_equal(sys_.kf_database.present[:m.next_kf], m.kf_valid[:m.next_kf]) \
                or int(timings["loop_closing"]["count"]) != n_mapped:
            raise AssertionError(f"{what}: a keyframe missed the database or the loop closer")
        est = sys_.trajectory_positions()
        gt_c = np.asarray([-R.T @ t for R, t in gt])
        rmse = trajectory.ate_rmse(est, gt_c, align_scale=False)
        span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
        log(f"{what}: {SYSTEM_FRAMES} frames all OK, {sys_.map.next_kf} keyframes inserted "
            f"({sys_.map.n_keyframes()} kept), {n_mapped} mapped, {sum(made)} points by "
            f"triangulation ({made}), {n_fuse} fuse passes, {sys_.map.n_points()} points; "
            f"ATE {rmse:.6f} m over a {span:.3f} m span (gate {ATE_SPAN_GATE} x span)")
        if sys_.map.next_kf < 2 or sum(made) < 1 or n_fuse < 1:
            raise AssertionError(f"{what}: too few keyframes, triangulated points or fuses")
        if not rmse < ATE_SPAN_GATE * span:
            raise AssertionError(f"{what}: ATE {rmse} over the gate")
        SYSTEM_FPS[sensor] = SYSTEM_FRAMES / seconds
        log(f"{what}: {SYSTEM_FRAMES / seconds:.2f} frames/s over the sequence "
            f"({seconds:.3f} s) on {power}; launches per mapped keyframe: " + ", ".join(
                [f"{k} with a batch axis {batched[k] / max(n_mapped, 1):.2f}"
                 for k in SYSTEM_KERNELS]
                + [f"{k} {c[k] / max(n_mapped, 1):.2f}"
                   for k in K7_FORMS + ("projection_hamming_top2", "pose_lm")]))
        per_kf = {k: timings[k]["total_s"] * 1e3 / max(n_mapped, 1)
                  for k in ("map_tri", "local_mapping") if k in timings}
        log(f"{what}: ms per mapped keyframe (host clock; they follow the host, PERF.md "
            f"section 5): " + ", ".join(f"{k} {v:.3f}" for k, v in per_kf.items()))
        for stage, st in sorted(timings.items()):
            log(f"    {what} stage {stage}: {int(st['count'])} x {st['mean_ms']:.3f} ms "
                f"(max {st['max_ms']:.3f}, total {st['total_s'] * 1e3:.1f} ms)")

        profs = {}
        sys3, _, _, _ = run_system(seq, vocabulary="default", around=lambda i: (
            profiled(profs, i) if 3 <= i < 15 else contextlib.nullcontext()))
        remember(what, "profiled", sys3)
        check_same_bits(what)
        kf_frames = {int(f) for f in sys3.map.kf_frame_id[:sys3.map.next_kf]}
        for kind, frames in (("keyframe", sorted(kf_frames & set(profs))),
                             ("plain", sorted(set(profs) - kf_frames))):
            if not frames:
                raise AssertionError(f"{what}: no {kind} frame among frames 3-14")
            wall, busy, n_ops = (np.mean([profs[i][j] for i in frames]) for j in range(3))
            first = profs[frames[0]]
            log(f"profiled {what} {kind} frames {frames}: mean {wall:.3f} ms wall, "
                f"{busy:.3f} ms device busy, idle share {1.0 - busy / wall:.4f}, "
                f"{n_ops:.0f} device operations; frame {frames[0]}: {first[0]:.3f} ms wall, "
                f"{first[1]:.3f} ms busy, idle share {1.0 - first[1] / first[0]:.4f}, "
                f"{first[2]} operations, on {power}")
        if sensor == "rgbd":
            system_vs_cpu(seq)
    return counts, batched_counts


def phase_graph_systems(seqs, power, errs):
    """The synchronous RGB-D and stereo Systems and the asynchronous RGB-D
    System, eager (the tracker's forms pointed at the eager functions)
    and through the graphs, in turns (GRAPH_SYSTEM_TURNS, each under a
    device-only profile): each
    synchronous eager run bit-identical to the graph runs of its
    sequence (check_same_bits); frames/s, and the asynchronous tracker
    thread's ms a frame. The first eager runs of the synchronous Systems
    record the kernels' calls (DATASET_RECORDED: the tracker's calls are
    wrapper calls there, not replays), each held against its plain
    version (phase_dataset_kernels; errs updated)."""
    rows, recorded, mapping, idle = {}, {}, {}, {}
    for turn, kind in enumerate(GRAPH_SYSTEM_TURNS):
        with eager_forms() if kind == "eager" else contextlib.nullcontext():
            for sensor, seq in seqs.items():
                calls = {k: [] for k in DATASET_RECORDED}
                prof = {}
                with contextlib.ExitStack() as stack:
                    if turn == 0:
                        for k, (module, _) in DATASET_RECORDED.items():
                            stack.enter_context(recording(module, k, calls[k]))
                    stack.enter_context(profiled(prof, "run", device_only=True))
                    sys_, _, _, seconds = run_system(seq, vocabulary="default")
                if GRAPH_POOL_AFTER[-1]:
                    raise AssertionError(f"{system_name(sensor)} ({kind}): its graphs hold "
                                         f"{GRAPH_POOL_AFTER[-1]} bytes after shutdown")
                t = sys_.timings()
                n_kf = max(int(t.get("local_mapping", {}).get("count", 0)), 1)
                mapping.setdefault((system_name(sensor), kind), []).append(
                    tuple(round(t[s]["total_s"] * 1e3 / n_kf, 1) if s in t else None
                          for s in ("local_mapping", "map_tri", "map_fuse", "map_lba"))
                    + RUN_GRAPHS[-1])
                if prof:
                    wall, busy, _ = prof["run"]
                    idle[(system_name(sensor), kind)] = round(1.0 - busy / wall, 4)
                if turn == 0:
                    # The first two calls of each kernel and the last two
                    # (the tracker's forms on OK frames); K8's as kept_calls
                    # keeps them.
                    recorded[f"eager {system_name(sensor)}"] = (seq[0], kept_calls({
                        k: c if k == "pose_lm" or len(c) <= 4 else c[:2] + c[-2:]
                        for k, c in calls.items()}))
                remember(system_name(sensor), kind, sys_)
                rows.setdefault((system_name(sensor), kind), []).append(
                    round(SYSTEM_FRAMES / seconds, 2))
            track_s = []
            _, _, _, seconds = run_system(seqs["rgbd"], vocabulary="default",
                                          async_mapping=True, track_s=track_s)
            rows.setdefault(("asynchronous System RGB-D", kind), []).append(
                (round(SYSTEM_FRAMES / seconds, 2), round(1e3 * float(np.mean(track_s)), 3)))
    for sensor in seqs:
        check_same_bits(system_name(sensor))
    phase_dataset_kernels(recorded, errs)
    log("Systems, eager against graphs in turns (frames/s; asynchronous: (frames/s, the "
        "tracker thread's mean ms a frame)): " + "; ".join(
            f"{what} {kind} {v}" for (what, kind), v in rows.items()) + f", on {power}")
    log("Systems, eager against graphs in turns, per run (ms a mapped keyframe of "
        "local_mapping, map_tri, map_fuse, map_lba; CUDA graph captures, replays, the live "
        "pools' bytes at the run's end; 0 bytes after its shutdown): " + "; ".join(
            f"{what} {kind} {v}" for (what, kind), v in mapping.items())
        + "; idle share over a whole run (each turn, under torch.profiler): "
        + ", ".join(f"{what} {kind} {v}" for (what, kind), v in idle.items())
        + f", on {power}")


def check_system_graphs(sys_, keys, caps, reps):
    """A System run's CUDA graphs, before its shutdown releases them: the
    captures since `caps` and replays since `reps` logged, and the
    graphs not among `keys` counted by function, the tracker's forms held
    to GRAPHS_PER_FORM a form and configuration; the bytes every live
    graph's pool holds are logged and kept (GRAPH_POOL_BYTES)."""
    by = {}
    for k, g in cuda_graph.graphs.items():
        if k not in keys:
            by.setdefault((k[0].__name__, k[1]), []).append(g)
    held = sum(g.pool_bytes for g in cuda_graph.graphs.values())
    GRAPH_POOL_BYTES.append(held)
    RUN_GRAPHS.append((cuda_graph.n_captures() - caps, cuda_graph.n_replays() - reps, held))
    by_fn = {}
    for (n, _), gs in by.items():
        by_fn[n] = by_fn.get(n, 0) + len(gs)
    cam = sys_.config.camera
    log(f"System {sys_.config.sensor} {cam.width}x{cam.height}, "
        f"{sys_.config.orb.n_features} features: {RUN_GRAPHS[-1][0]} CUDA graph captures, "
        f"{RUN_GRAPHS[-1][1]} replays; graphs by function {by_fn}; "
        f"{len(cuda_graph.graphs)} graphs' pools hold {held} bytes")
    over = [n for (n, _), gs in by.items() if n in GRAPH_FORMS and len(gs) > GRAPHS_PER_FORM]
    if over:
        raise AssertionError(f"more than {GRAPHS_PER_FORM} graphs of {over} under one "
                             f"configuration in one System run")


# ---------------------------------------------------------------------------
# The mapper's and the loop closer's single-dispatch forms: CUDA graphs
# ---------------------------------------------------------------------------

# The mapper's units recorded from the RGB-D System's eager warm-up run
# (system_path_inputs): name -> (module, the attribute its caller calls).
MAPPER_UNITS = {"local BA": (ba, "local_bundle_adjust"),
                "triangulation": (jit_mapper, "fused_triangulation_jit"),
                "fuse": (jit_mapper, "fused_fuse_forward_jit")}
# name -> (args, kwargs) of the first call of each unit.
MAPPER_RECORDED = {}
# CUDA runtime calls that make the host wait for the device.
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
# Calls of each unit timed each way, in turns (eager, replayed, replayed,
# eager) of this many calls.
UNIT_CALLS = 1
# LM iterations of a global BA segment (GlobalBARunner's default).
GBA_SEGMENT_ITERS = 5


def host_waits(fn):
    """fn() under torch.profiler, inside a record_function window -> (its
    result, the device-to-host copies and the synchronizing CUDA runtime
    calls (SYNC_CALLS) in the window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("host_waits window"):
            out = fn()
    events = prof.events()
    w = [e for e in events if e.name == "host_waits window" and e.device_type == DeviceType.CPU]
    if len(w) != 1:
        raise AssertionError(f"the profiler recorded {len(w)} host_waits windows")
    lo, hi = w[0].time_range.start, w[0].time_range.end
    d2h = sum(1 for e in events if e.device_type == DeviceType.CUDA and "DtoH" in e.name
              and lo <= e.time_range.start <= hi)
    syncs = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in SYNC_CALLS
                and lo <= e.time_range.start and e.time_range.end <= hi)
    return out, d2h, syncs


def synced_ms(fn, calls=UNIT_CALLS):
    """Mean wall ms of fn() over `calls` calls, each ended by a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def mapper_units(solves):
    """name -> (the functions of its graphs (cuda_graph.release's owners),
    eager call, device-loop call run eagerly or None, single-dispatch
    call): the RGB-D System's first local BA (both stages), triangulation
    and fuse pass, and the ring survey's essential graph and global BA."""
    def call(fn, args, kwargs):
        return lambda: fn(*args, **kwargs)

    def in_context(ctx, fn, args, kwargs):
        def run():
            with ctx():
                return fn(*args, **kwargs)
        return run

    (lba_a, lba_k), (tri_a, _), (fuse_a, _) = (MAPPER_RECORDED[n] for n in MAPPER_UNITS)
    (gba_a, gba_k), (eg_a, eg_k) = solves["global BA"], solves["essential graph"]
    return {
        "local BA": (ba.GRAPHED, in_context(eager_forms, ba.local_bundle_adjust, lba_a, lba_k),
                     in_context(cuda_graph.eager, ba.local_bundle_adjust, lba_a, lba_k),
                     call(ba.local_bundle_adjust, lba_a, lba_k)),
        "triangulation": ((jit_mapper.triangulation_match, jit_mapper.triangulation_gates),
                          call(jit_mapper.fused_triangulation, tri_a, {}), None,
                          call(jit_mapper.fused_triangulation_jit, tri_a, {})),
        "fuse": ((jit_mapper.fused_fuse_forward,), call(jit_mapper.fused_fuse_forward, fuse_a, {}),
                 None, call(jit_mapper.fused_fuse_forward_jit, fuse_a, {})),
        "essential graph": (pose_graph.GRAPHED, call(pose_graph.optimize_sim3_graph, eg_a, eg_k),
                            in_context(cuda_graph.eager, pose_graph.optimize_sim3_graph_blocks,
                                       eg_a, eg_k),
                            call(pose_graph.optimize_sim3_graph_jit, eg_a, eg_k)),
        "global BA": (ba.GRAPHED, call(ba.bundle_adjust, gba_a, gba_k),
                      in_context(cuda_graph.eager, ba.bundle_adjust_loop, gba_a, gba_k),
                      call(ba.bundle_adjust_jit, gba_a, gba_k)),
    }


def check_ordered_sums():
    """The card's segment sums (optim/segment.py) over the recorded local
    BA's observation -> camera table, of seeded [O, 6, 6] float32 values:
    the same bits with the table padded to twice its width, and whether
    they equal the CPU's index_add_ (float32 additions in row order)."""
    problem = MAPPER_RECORDED["local BA"][0][0]
    obs = problem.obs
    seg = segment.segments(obs.cam_idx, problem.R.shape[0], obs.valid)
    gen = torch.Generator(device="cuda").manual_seed(0)
    vals = torch.randn((obs.cam_idx.shape[0], 6, 6), generator=gen, device="cuda")
    got = segment.segment_sum(vals, seg)
    wide = seg._replace(gather=torch.cat([seg.gather, torch.full_like(seg.gather, vals.shape[0])],
                                         1))
    same = same_bits(segment.segment_sum(vals, wide), got)
    cpu = segment.segment_sum(vals.cpu(), segment.segments(obs.cam_idx.cpu(), seg.n,
                                                           obs.valid.cpu()))
    log(f"segment sums on the card ({seg.n} segments of up to {seg.gather.shape[1]} rows): "
        f"bit-identical with the table twice as wide {same}; equal to the CPU's index_add_ "
        f"bit for bit {same_bits(got.cpu(), cpu)} (largest difference "
        f"{max_abs(got.cpu(), cpu):.3g})")
    if not same:
        raise AssertionError("the card's segment sums depend on the table's width")


def unit_moved(name, solves, out):
    """How far a solve moved its problem (', largest |d t| ..., |d point|
    ...'), '' for the mapper's matchers."""
    if name in ("triangulation", "fuse"):
        return ""
    args = (MAPPER_RECORDED["local BA"] if name == "local BA" else
            solves["global BA" if name == "global BA" else "essential graph"])[0]
    before = args[0]
    after = out[0] if name != "essential graph" else out
    parts = [f"|d t| {max_abs(after.t, before.t):.4g}"]
    if name != "essential graph":
        valid = before.point_valid
        parts.append(f"|d point| {max_abs(after.points[valid], before.points[valid]):.4g}")
    return "; the solve moved its problem by largest " + ", ".join(parts)


def phase_mapper_graphs(solves, power):
    """The mapper's and the loop closer's single-dispatch forms on their
    recorded inputs (MAPPER_UNITS from the RGB-D System's eager warm-up;
    the ring survey's global BA and essential graph): each unit's graphs
    released first, so the first single-dispatch call captures and the
    second only replays; both replays bit for bit the eager call (BA's
    early-exit form, the pose graph's eager loop, the mapper's eager
    functions), and so is the device-loop form run eagerly
    (cuda_graph.eager); a replay's launches per kernel equal the eager
    call's (K7 under the epipolar band in the triangulation, K6 batched in
    the fuse); synced ms eager and replayed in turns. Then under
    torch.profiler the device-to-host copies and synchronizations from a
    local BA's first replay to the read of its result, and in one global
    BA segment (GBA_SEGMENT_ITERS iterations, its tables made before),
    eager and replayed: none replayed."""
    check_ordered_sums()
    units = mapper_units(solves)
    for name, (owners, eager, device_loop, single) in units.items():
        cuda_graph.release(*owners)
        caps, reps = cuda_graph.n_captures(), cuda_graph.n_replays()
        torch.cuda.synchronize()
        _build.reset_launches()
        want = eager()
        torch.cuda.synchronize()
        eager_counts = {k: v for k, v in _build.launches.items() if v}
        looped = device_loop() if device_loop is not None else want
        first = single()
        torch.cuda.synchronize()
        captured = cuda_graph.n_captures() - caps
        _build.reset_launches()
        reps = cuda_graph.n_replays()
        got = single()
        torch.cuda.synchronize()
        counts = {k: v for k, v in _build.launches.items() if v}
        replays = cuda_graph.n_replays() - reps
        if not same_bits(looped, want):
            raise AssertionError(f"{name}: the device-loop form run eagerly differs from the "
                                 f"eager form")
        if not (same_bits(first, want) and same_bits(got, want)):
            raise AssertionError(f"{name}: a replay differs from the eager call")
        if counts != eager_counts:
            raise AssertionError(f"{name}: a replay launched {counts}, the eager call "
                                 f"{eager_counts}")
        if not captured or cuda_graph.n_captures() - caps != captured:
            raise AssertionError(f"{name}: {captured} captures at the first call, "
                                 f"{cuda_graph.n_captures() - caps} in all")
        ms = {"eager": [], "replayed": []}
        for kind in ("eager", "replayed", "replayed", "eager"):
            ms[kind].append(round(synced_ms(eager if kind == "eager" else single), 3))
        live = [g for k, g in cuda_graph.graphs.items() if k[0] in owners]
        moved = unit_moved(name, solves, got)
        log(f"{name}: replayed bit for bit the eager call"
            f"{' and the device-loop form run eagerly' if device_loop else ''}; "
            f"{captured} graphs captured ({sum(g.pool_bytes for g in live)} pool bytes), "
            f"{replays} replays a call, launches a call {counts or 'none'} (eager "
            f"{eager_counts or 'none'}); synced ms eager {ms['eager']}, replayed "
            f"{ms['replayed']}, on {power}{moved}")

    lba_a, lba_k = MAPPER_RECORDED["local BA"]
    gba_a, gba_k = solves["global BA"]

    def local_ba(segs):
        """ba.local_bundle_adjust's two stages on tables made before."""
        problem, r1 = ba.bundle_adjust_jit(*lba_a, n_iters=5, use_robust=True, segs=segs,
                                           **lba_k)
        problem = problem._replace(obs=problem.obs._replace(valid=r1.inlier))
        return ba.bundle_adjust_jit(problem, *lba_a[1:], n_iters=10, use_robust=False,
                                    segs=segs, **lba_k)

    windows = {
        "local BA": (ba.obs_segments(lba_a[0], lba_k.get("point_chunk", 1024)), local_ba),
        "global BA segment": (ba.obs_segments(gba_a[0], gba_k.get("point_chunk", 1024)),
                              lambda segs: ba.bundle_adjust_jit(
                                  *gba_a, **dict(gba_k, n_iters=GBA_SEGMENT_ITERS), segs=segs)),
    }
    for name, (segs, solve) in windows.items():
        row = {}
        for kind in ("eager", "replayed"):
            with eager_forms() if kind == "eager" else contextlib.nullcontext():
                solve(segs)
                (_, res), d2h, syncs = host_waits(lambda: solve(segs))
            interop.to_host(res.inlier)
            row[kind] = (d2h, syncs)
        log(f"{name}, from its first replay to the read of its result (the tables made "
            f"before): device-to-host copies and synchronizations eager {row['eager']}, "
            f"replayed {row['replayed']}")
        if row["replayed"] != (0, 0) or row["eager"][1] < 1:
            raise AssertionError(f"{name}: the replayed window read the device "
                                 f"{row['replayed']}, or the eager one was not seen "
                                 f"waiting {row['eager']}")


# ---------------------------------------------------------------------------
# The staged tracker's single-dispatch forms: CUDA graphs
# ---------------------------------------------------------------------------

# The staged forms' calls recorded from the card's runs (the monocular
# kidnap run and the localization session; the stereo front end on the
# stereo pair's images): form -> [(source, signature, args, kwargs)], the
# first STAGED_KEEP calls of each signature (tensor shapes and dtypes, the
# other arguments but tz_rel, which changes every frame). phase_staged_graphs
# takes one call a signature: the first with a candidate (no boolean tensor
# argument all False), else the first.
STAGED_RECORDED = {}
STAGED_KEEP = 4
# Calls of each unit timed each way, in turns (eager, replayed, replayed,
# eager) of this many calls (3 before a depth cut).
STAGED_UNIT_CALLS = 2
# The System runs eager and replayed in turns (the last two under a
# device-only profile: the idle share): the localization session four
# turns; the RGB-D System with the staged tracker two; the sweep two over
# its first SWEEP_TURN_FRAMES frames (its initialization and the first
# keyframes: the staged part of a monocular run), each profiled over
# MONO_PROFILED_FRAMES only (a whole sweep's trace took ~45 s to read
# back).
STAGED_TURNS = ("eager", "replayed", "replayed", "eager")
TWO_TURNS = ("eager", "replayed")
SWEEP_TURN_FRAMES = 20
MONO_PROFILED_FRAMES = range(10, 20)
# Profiler sessions a host-read count may be taken over, until the
# replayed call's synchronizations equal its library calls' (the most of
# each: the profiler can drop a record, never add one).
HOST_READ_SESSIONS = 3
# The kernels of the staged RGB-D System's frames, launched by the staged
# forms' replays in a replayed run: extraction (K1-K5), the projection
# matchers (K6), the pose LM (K8).
STAGED_RGBD_REPLAYED = ("level_preprocess", "combine_nms", "cell_topk_map", "describe_patches",
                        "projection_hamming_top2", "pose_lm")
# One row a unit call for the log's summary: (form, source, eager ms,
# replayed ms, replays, library calls, host reads eager / replayed).
STAGED_ROWS = []
# The modules whose forms replay more than one graph a call, around
# library calls: EPnP RANSAC, two-view initialization, the Sim3 RANSAC,
# the plane fit.
MULTI_GRAPH_MODULES = (pnp, twoview, sim3_solver, ar)


def staged_signature(form, args, kwargs):
    leaves = tree_leaves((args, {k: v for k, v in kwargs.items() if k != "tz_rel"}))
    return (form,) + tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
                           for a in leaves)


@contextlib.contextmanager
def staged_recording(source, forms=STAGED_FORMS, store=STAGED_RECORDED):
    """Record the forms' calls inside the block into store (nothing read
    on the host): the staged forms into STAGED_RECORDED by default."""
    counts = {}
    saved = [(module, form, getattr(module, form)) for module, form, _ in forms]

    def spy(form, fn):
        def call(*args, **kwargs):
            sig = staged_signature(form, args, kwargs)
            if counts.get(sig, 0) < STAGED_KEEP:
                counts[sig] = counts.get(sig, 0) + 1
                store.setdefault(form, []).append((source, sig, args, kwargs))
            return fn(*args, **kwargs)
        return call

    for module, form, fn in saved:
        setattr(module, form, spy(form, fn))
    try:
        yield
    finally:
        for module, form, fn in saved:
            setattr(module, form, fn)


@contextlib.contextmanager
def linalg_recorded(calls):
    """calls.append((fn, args)) for each batched eigensolve and SVD
    (optim/linalg.py) inside the block."""
    saved = {name: getattr(linalg, name) for name in ("eigh", "svd")}

    def spy(fn):
        def call(*args):
            calls.append((fn, args))
            return fn(*args)
        return call

    for name, fn in saved.items():
        setattr(linalg, name, spy(fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(linalg, name, fn)


def staged_calls(form, store=STAGED_RECORDED):
    """[(source, args, kwargs)]: one recorded call of the form a signature,
    the first with a candidate (no boolean tensor argument all False)."""
    by_sig = {}
    for source, sig, args, kwargs in store.get(form, []):
        full = not any(isinstance(a, torch.Tensor) and a.dtype == torch.bool and a.numel()
                       and not bool(a.any()) for a in tree_leaves((args, kwargs)))
        if sig not in by_sig or (full and not by_sig[sig][0]):
            by_sig[sig] = (full, (source, args, kwargs))
    return [call for _, call in by_sig.values()]


def staged_replayed(owners=STAGED_GRAPHED):
    """{kernel: launches} that replays of the owners' graphs (the staged
    forms' by default) added since the process started."""
    out = {}
    for fn in owners:
        for k, n in cuda_graph.replayed_by.get(fn.__name__, {}).items():
            out[k] = out.get(k, 0) + n
    return out


def staged_unit(module, form, eager, source, args, kwargs, power, timed=True):
    """One recorded call of a staged form: its graphs released, so the
    first call captures and the second only replays; both bit for bit the
    eager call; the second call's launches per kernel the eager call's, all
    of them added by replays; one replay for a one-graph form (none of its
    library calls between replays); under torch.profiler the host's waits
    for the device (SYNC_CALLS) in a replayed call equal those of its
    library calls alone (recorded from that call and run again on their
    inputs; the device-to-host copies logged beside them); synced ms
    eager and replayed in turns (unless timed is False)."""
    what = f"{form} ({source})"
    jit = getattr(module, form)
    cuda_graph.release(*module.GRAPHED)
    torch.cuda.synchronize()
    _build.reset_launches()
    want = eager(*args, **kwargs)
    torch.cuda.synchronize()
    eager_counts = {k: v for k, v in _build.launches.items() if v}
    caps = cuda_graph.n_captures()
    first = jit(*args, **kwargs)
    torch.cuda.synchronize()
    captured = cuda_graph.n_captures() - caps
    _build.reset_launches()
    reps, before = cuda_graph.n_replays(), dict(cuda_graph.replayed_launches)
    lib = []
    with linalg_recorded(lib):
        got = jit(*args, **kwargs)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.launches.items() if v}
    replays = cuda_graph.n_replays() - reps
    from_replays = {k: v - before.get(k, 0) for k, v in cuda_graph.replayed_launches.items()
                    if v > before.get(k, 0)}
    if not (same_bits(first, want) and same_bits(got, want)):
        raise AssertionError(f"{what}: a replay differs from the eager call")
    if counts != eager_counts or from_replays != counts:
        raise AssertionError(f"{what}: a call launched {counts} ({from_replays} from replays), "
                             f"the eager call {eager_counts}")
    check_unit_replays(what, captured, cuda_graph.n_captures() - caps, replays, len(lib),
                       module not in MULTI_GRAPH_MODULES)
    fns = {"eager": lambda: eager(*args, **kwargs), "replayed": lambda: jit(*args, **kwargs),
           "library calls alone": lambda: [f(*a) for f, a in lib]}
    waits = {kind: host_waits(fn)[1:] for kind, fn in fns.items()}
    for _ in range(HOST_READ_SESSIONS - 1):
        if waits["replayed"][1] == waits["library calls alone"][1]:
            break
        for kind in ("replayed", "library calls alone"):
            waits[kind] = tuple(map(max, waits[kind], host_waits(fns[kind])[1:]))
    if waits["replayed"][1] != waits["library calls alone"][1]:
        raise AssertionError(f"{what}: a replayed call waited for the device "
                             f"{waits['replayed'][1]} times, its library calls alone "
                             f"{waits['library calls alone'][1]} times")
    ms = {"eager": [], "replayed": []}
    for kind in ("eager", "replayed", "replayed", "eager") if timed else ():
        fn = eager if kind == "eager" else jit
        ms[kind].append(round(synced_ms(lambda: fn(*args, **kwargs), STAGED_UNIT_CALLS), 3))
    pool = sum(g.pool_bytes for k, g in cuda_graph.graphs.items() if k[0] in module.GRAPHED)
    log(f"{what}: replayed bit for bit the eager call; {captured} graphs captured ({pool} pool "
        f"bytes), {replays} replays a call around {len(lib)} library calls; launches a call "
        f"{counts or 'none'}, all from replays (eager {eager_counts or 'none'}); host reads "
        f"(device-to-host copies, synchronizations) eager {waits['eager']}, replayed "
        f"{waits['replayed']}, its library calls alone {waits['library calls alone']}; synced "
        f"ms eager {ms['eager']}, replayed {ms['replayed']}, on {power}")
    STAGED_ROWS.append((form, source, ms["eager"], ms["replayed"], replays, len(lib),
                        waits["eager"], waits["replayed"]))
    return got, counts, replays, len(lib)


def check_unit_replays(what, captured, captures, replays, n_lib, one_graph):
    """A staged form's graphs all captured at its first call (none at the
    second), each replayed once at the second call; a one-graph form with
    no library call between replays."""
    if not captured or captures != captured or replays != captured \
            or (one_graph and (replays != 1 or n_lib)):
        raise AssertionError(f"{what}: {captured} captures at the first call, {captures} in "
                             f"all, {replays} replays and {n_lib} library calls at the second")


def check_horn_svds(source, args, kwargs):
    """EPnP's three Horn SVDs in one batched call (pnp._horn_svds) against
    one call each, on a recorded RANSAC's matrices: bit for bit."""
    samples, X, uv, valid, sigma2, fx, fy, cx, cy = args[:9]
    key = (fx, fy, cx, cy, kwargs.get("min_inliers", 10), kwargs.get("chi2_th", 5.991))
    Xs, uvs, spread = pnp._ransac_gather(samples, X, uv, key)
    w, V = linalg.eigh(spread)
    cws, alphas, MtM, _ = pnp._solve_null(Xs, uvs, w, V, key)
    _, V = linalg.eigh(MtM)
    _, covs, _ = pnp._solve_cases(Xs, cws, alphas, V, key)
    joint = pnp._horn_svds(covs)
    alone = [linalg.svd(c) for c in covs]
    same = all(same_bits((U, Vh), (a[0], a[2])) for (U, Vh), a in zip(joint, alone))
    log(f"EPnP's Horn SVDs ({source}, {tuple(covs[0].shape)} each): one batched call bit for "
        f"bit three calls {same}")
    if not same:
        raise AssertionError("EPnP's batched Horn SVDs differ from one call a case")


def window_profiled(prof, frames):
    """run_system's `around` hook: one device-only torch.profiler session
    over frames[0] to frames[-1] (profiled: prof["run"])."""
    stack = contextlib.ExitStack()

    @contextlib.contextmanager
    def around(i):
        if i == frames[0]:
            stack.enter_context(profiled(prof, "run", device_only=True))
        try:
            yield
        finally:
            if i == frames[-1]:
                stack.close()
    return around


def staged_turns(what, run, stages, power, want_replayed=(), turns=STAGED_TURNS,
                 owners=STAGED_GRAPHED):
    """run(prof) -> (system, frames, seconds, (captures, replays, pool
    bytes at the run's end)) in turns: eager (eager_forms) and replayed;
    in the last two turns prof is a dict for run to profile itself into
    (profiled's "run": the whole run or a window), else None. Every run
    remembered under `what` and held bit for bit to that name's other runs
    (check_same_bits); an eager run captures and replays nothing, a
    replayed one launches each of want_replayed from the staged forms'
    replays. Logs frames/s, the stages' mean ms, captures, replays, pool
    bytes and the idle share. owners: the functions whose replays' launches
    are counted (the staged forms' by default)."""
    rows, t0 = [], time.perf_counter()
    for turn, kind in enumerate(turns):
        prof = {} if turn >= len(turns) - 2 else None
        before = staged_replayed(owners)
        with eager_forms() if kind == "eager" else contextlib.nullcontext():
            sys_, n_frames, seconds, graphs = run(prof)
        replayed = {k: v - before.get(k, 0) for k, v in staged_replayed(owners).items()
                    if v > before.get(k, 0)}
        if kind == "eager" and graphs[:2] != (0, 0):
            raise AssertionError(f"{what} (eager): {graphs[0]} captures, {graphs[1]} replays")
        if kind == "replayed" and [k for k in want_replayed if not replayed.get(k)]:
            raise AssertionError(f"{what} (replayed): the forms' replays launched "
                                 f"{replayed}")
        t = sys_.timings()
        remember(what, kind, sys_)
        rows.append((kind, round(n_frames / seconds, 2),
                     {k: round(t[k]["mean_ms"], 3) for k in stages if k in t},
                     graphs, round(1.0 - prof["run"][1] / prof["run"][0], 4)
                     if prof and "run" in prof else "not recorded", replayed))
    check_same_bits(what)
    log(f"{what}, eager against replayed in turns (frames/s; mean ms of "
        f"{', '.join(stages)}; CUDA graph captures, replays, the live pools' bytes at the "
        f"run's end; idle share (the last two turns); launches from the forms' "
        f"replays): " + "; ".join(
            f"{kind} {fps}, {st}, {g}, idle {idle}, {rep or 'none'}"
            for kind, fps, st, g, idle, rep in rows) + f", on {power} (the turns took "
        f"{time.perf_counter() - t0:.1f} s)")
    return rows


def phase_staged_graphs(pairs, seqs, power):
    """The staged tracker's single-dispatch forms on the calls recorded
    from the card's monocular kidnap run and localization session (and the
    stereo front end on the stereo pair's images), each through
    staged_unit; the extraction also on the per-level route
    (ORB_TPU_FORCE_PACKED=0: K1 and the standalone K4 per level in the
    replay); EPnP's batched Horn SVDs against one call each. Then the
    RGB-D System with the staged tracker (ORB_TPU_FUSED_TRACK=0) eager and
    replayed in turns (staged_turns), each run held to every frame OK and
    the ATE gate. It starts with no graph of the staged forms held."""
    cfg, motion, _ = pairs["stereo"]
    cam = cfg.camera
    args = (motion[0], motion[1], cfg.orb, cam.height, cam.width, cam.bf, cam.baseline)
    STAGED_RECORDED.setdefault("stereo_frontend_jit", []).append(
        ("stereo pair", staged_signature("stereo_frontend_jit", args, {}), args, {}))
    missing = [form for _, form, _ in STAGED_FORMS if not STAGED_RECORDED.get(form)]
    if missing:
        raise AssertionError(f"no call of {missing} was recorded")
    cuda_graph.release(*STAGED_GRAPHED)
    for module, form, eager in STAGED_FORMS:
        for source, args, kwargs in staged_calls(form):
            staged_unit(module, form, eager, source, args, kwargs, power)
    source, args, kwargs = staged_calls("extract_features_jit")[0]
    with env_set(ORB_TPU_FORCE_PACKED="0"):
        staged_unit(extractor, "extract_features_jit", extractor.extract_features,
                    f"{source}, per-level route", args, kwargs, power)
    check_horn_svds(*staged_calls("epnp_ransac_many_jit")[0])
    cuda_graph.release(*STAGED_GRAPHED)

    seq = seqs["rgbd"]
    _, _, _, gt = seq
    gt_c = centres(gt)
    span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    what = "System RGB-D, staged tracker"

    def run(prof):
        with env_set(ORB_TPU_FUSED_TRACK="0"), \
                profiled(prof, "run", device_only=True) if prof is not None \
                else contextlib.nullcontext():
            sys_, states, poses, seconds = run_system(seq, vocabulary="default")
        rmse = trajectory.ate_rmse(sys_.trajectory_positions(), gt_c, align_scale=False)
        if any(st != "OK" for st in states) or not rmse < ATE_SPAN_GATE * span:
            raise AssertionError(f"{what}: states {states}, ATE {rmse} (gate "
                                 f"{ATE_SPAN_GATE * span})")
        return sys_, SYSTEM_FRAMES, seconds, RUN_GRAPHS[-1]

    staged_turns(what, run, ("extract_frame", "track", "local_mapping"), power,
                 STAGED_RGBD_REPLAYED, TWO_TURNS)
    log("staged forms, per recorded call (form, source, synced ms eager, replayed, replays "
        "a call, library calls between them, host reads eager, replayed): "
        + "; ".join(str(r) for r in STAGED_ROWS) + f", on {power}")


# ---------------------------------------------------------------------------
# The loop closer's, the staged mapper's and the AR anchor's single-dispatch
# forms, and the sharded global BA through the device loop
# ---------------------------------------------------------------------------

# The loop path's forms whose calls are recorded (from phase_loop's ring
# survey and from the eager turns of phase_loop_graphs' runs) and held
# replay against eager call: LOOP_FORMS and the loop closer's brute force
# over its candidates.
LOOP_UNIT_FORMS = LOOP_FORMS + ((matchers, "match_brute_force_jit",
                                 matchers.match_brute_force),)
LOOP_RECORDED_CALLS = {}
# The functions the loop path's forms capture (their replays' launches
# counted in the turns).
LOOP_OWNERS = LOOP_GRAPHED + tuple(
    f for f in matchers.GRAPHED
    if f.__name__ in ("_brute_force", "_sim3_search", "_fuse", "_triangulation", "_search_fuse"))
# The loop closure at full width. The ring survey's scene and path at
# 640x480 with 1000 features (monocular, the 7-DoF Sim3 path) never
# initializes, in either package (a CPU run of the JAX System; the port's
# CPU run and a run on the card), so the full-width loop run is the
# multi-loop drive's (the figure-eight at its full-drive settings, stereo,
# 640x480, 1500 features, the drive's keyframe thresholds) with a
# synchronous System, to its first corrected loop. Its first
# FULL_LOOP_FRAMES stereo frames are rendered once, a file each, by
# RENDER_PROCS subprocesses of this script (frame k by process k mod
# RENDER_PROCS); its two turns (eager: the loop path's forms eager,
# LOOP_UNIT_FORMS; replayed), two more, read each frame as it is written.
# All of them run beside the first steps, which build inputs and time
# nothing; the timed phases start after both turns have ended
# (FULL_LOOP_TIMEOUT_S each). Neither turn is timed.
FULL_LOOP = dict(width=640, height=480, n_features=1500, sensor="stereo")
FULL_LOOP_DRIVE = dict(n_frames=1400, n_points=120000, seed=13, r=25.0, laps=2.15,
                       max_depth=12.0)
# The first loop closes at frame 660 (on an H100).
FULL_LOOP_FRAMES = 720
RENDER_PROCS = 8
FULL_LOOP_TIMEOUT_S = 600
# The AR demo's frames in each turn (its default).
AR_TURN_FRAMES = 24


def full_loop_config():
    cfg = synthetic_config(**FULL_LOOP)
    return dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, kf_baseline_depth_ratio=0.08, kf_view_angle_deg=8.0))


def full_loop_frame(root, k):
    return os.path.join(root, f"frame_{k:04d}.npy")


def render_full_loop(index, root):
    """Frames index, index + RENDER_PROCS, ... of the full-width loop run's
    drive, each [2, H, W] (left, right) into its own file under root
    (written under another name, then renamed), in a process of its own."""
    frames, _, _ = synthetic.figure8_frames(full_loop_config().camera, stereo=True,
                                            **FULL_LOOP_DRIVE)
    for k in range(int(index), FULL_LOOP_FRAMES, RENDER_PROCS):
        _, left, right = next(frames(k))
        path = full_loop_frame(root, k)
        np.save(path + ".part.npy", np.stack([left, right]))
        os.replace(path + ".part.npy", path)
    return 0


def full_loop_turn(kind, out, root):
    """One turn of the full-width loop run (kind "eager": the loop path's
    forms at their eager functions, eager_forms(LOOP_UNIT_FORMS), and
    their calls recorded; "replayed"), in a process of its own: the
    drive's frames (each read from root once render_full_loop has written
    it) through a synchronous System until its first loop closure ->
    out.npz (the System's fingerprint), out.json (states, the four gates,
    the loop path's captures and replays, all captures, replays and pool
    bytes, launches) and, for the eager turn, out.pt (one recorded call of
    each form a signature, on the CPU)."""
    torch.set_num_threads(1)
    cfg = full_loop_config()
    poses = synthetic.figure8_trajectory(FULL_LOOP_DRIVE["n_frames"], r=FULL_LOOP_DRIVE["r"],
                                         laps=FULL_LOOP_DRIVE["laps"])
    gt_c = centres(poses)
    what = f"full-width loop run ({kind})"
    sys_ = System(cfg, async_mapping=False, device="cuda")
    pre = {}
    correct = sys_.loop_closer.correct_loop

    def correct_spy(*args, **kwargs):
        if "ate" not in pre:
            n = len(sys_.tracker.trajectory)
            pre.update(ate=loop_ate(sys_, gt_c[:n]), n=n, frame=sys_.frame_count - 1)
        return correct(*args, **kwargs)

    sys_.loop_closer.correct_loop = correct_spy
    store, states = {}, []
    _build.reset_launches()
    caps, reps = cuda_graph.n_captures(), cuda_graph.n_replays()
    with contextlib.ExitStack() as stack:
        if kind == "eager":
            stack.enter_context(eager_forms(LOOP_UNIT_FORMS))
            stack.enter_context(staged_recording(what, LOOP_UNIT_FORMS, store))
        for k in range(FULL_LOOP_FRAMES):
            path = full_loop_frame(root, k)
            while not os.path.exists(path):
                time.sleep(0.05)
            left, right = np.load(path)
            sys_.track_stereo(left, right, k / 30.0)
            states.append(sys_.tracking_state().name)
            if sys_.loop_closer.n_loops_closed >= 1:
                break
        torch.cuda.synchronize()
    loop_graphs = [g for k, g in cuda_graph.graphs.items() if k[0] in LOOP_OWNERS]
    graphs = graphs_since(caps, reps)
    prefix, final, span = loop_gates(what, sys_, states, pre, gt_c[:len(states)])
    np.savez(out + ".npz", **fingerprint(sys_))
    with open(out + ".json", "w") as f:
        json.dump({"states": states, "gates": [prefix, final, span, pre["ate"]],
                   "frame": pre["frame"], "graphs": graphs,
                   "loop_graphs": [len(loop_graphs), sum(g.replays for g in loop_graphs)],
                   "launches": dict(_build.launches),
                   "closures": sys_.loop_closer.correction_stats,
                   "n_keyframes": int(sys_.map.n_keyframes()),
                   "n_points": int(sys_.map.pt_valid.sum())}, f)
    if kind == "eager":
        def cpu(tree):
            return tree_map(lambda a: a.cpu() if isinstance(a, torch.Tensor) else a, tree)
        torch.save({form: [(source, cpu(args), cpu(kwargs))
                           for source, args, kwargs in loop_unit_calls(form, store)]
                    for form in store}, out + ".pt")
    sys_.shutdown()
    return 0


def start_full_loop_turns(root):
    """Start the full-width loop run's render processes and both of its
    turns, one host thread each -> (the frames' directory, the render
    processes, {kind: (out, process)})."""
    env = dict(os.environ, TMPDIR=root, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    frames = os.path.join(root, "full_loop_frames")
    os.makedirs(frames)
    renders = [started_process([sys.executable, os.path.abspath(__file__),
                                "--render-full-loop", str(i), frames], env,
                               os.path.join(root, f"full_loop_render_{i}"))
               for i in range(RENDER_PROCS)]
    procs = {}
    for kind in ("eager", "replayed"):
        out = os.path.join(root, f"full_loop_{kind}")
        procs[kind] = (out, started_process(
            [sys.executable, os.path.abspath(__file__), "--full-loop-turn", kind, out, frames],
            env, out))
    return frames, renders, procs


def phase_full_loop(started, power):
    """The full-width loop run's two turns (start_full_loop_turns): each
    exits 0 having closed its first loop within tests/test_loop_pipeline.py's
    four gates, the replayed turn bit for bit the eager one, its forms'
    replays launching K6 and K7; then each form's calls recorded by the
    eager turn, on the card, through staged_unit (phase_loop_graphs (b);
    not timed, as the ring survey's calls are). The turns ran beside each
    other, so nothing of theirs is read as a time."""
    frames, renders, procs = started
    for proc in renders:
        _, stderr = finished(proc, FULL_LOOP_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"rendering the full-width loop run's frames exited "
                                 f"{proc.returncode}: {stderr[-3000:]}")
    turns = {}
    for kind, (out, proc) in procs.items():
        _, stderr = finished(proc, FULL_LOOP_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"full-width loop run ({kind}) exited {proc.returncode}: "
                                 f"{stderr[-3000:]}")
        with open(out + ".json") as f:
            turns[kind] = json.load(f)
        RUNS.setdefault("full-width loop run", []).append((kind, dict(np.load(out + ".npz"))))
        r = turns[kind]
        log(f"full-width loop run ({kind}; the multi-loop drive at "
            f"{FULL_LOOP['width']}x{FULL_LOOP['height']}, {FULL_LOOP['n_features']} features, "
            f"stereo, synchronous): first loop closed "
            f"{[(c['kf'], c['loop_kf']) for c in r['closures']]} at frame {r['frame']} of "
            f"{len(r['states'])} frames, {r['n_keyframes']} keyframes, {r['n_points']} "
            f"points; ATE before the correction {r['gates'][3]:.6f}, of that prefix after it "
            f"{r['gates'][0]:.6f}, final {r['gates'][1]:.6f} over a {r['gates'][2]:.3f} span "
            f"(gate {LOOP_ATE_SPAN} x span); the loop path's graphs captured, replayed "
            f"{r['loop_graphs']}; all captures, replays, pool bytes {r['graphs']}; "
            f"launches {r['launches']}; on {power} (not timed: the two turns shared the card)")
    shutil.rmtree(frames)
    check_same_bits("full-width loop run")
    if turns["eager"]["loop_graphs"] != [0, 0] or not turns["replayed"]["loop_graphs"][1]:
        raise AssertionError(f"full-width loop run: the loop path's graphs (captured, "
                             f"replayed) in the eager turn {turns['eager']['loop_graphs']}, "
                             f"in the replayed turn {turns['replayed']['loop_graphs']}")
    recorded = torch.load(procs["eager"][0] + ".pt", weights_only=False)
    cuda_graph.release(*LOOP_OWNERS)
    for module, form, eager in LOOP_UNIT_FORMS:
        for source, args, kwargs in recorded.get(form, []):
            args, kwargs = tree_map(lambda a: a.cuda() if isinstance(a, torch.Tensor) else a,
                                    (args, kwargs))
            staged_unit(module, form, eager, source, args, kwargs, power, timed=False)
    cuda_graph.release(*LOOP_OWNERS)
    log(f"full-width loop run: its forms' recorded calls replayed against eager "
        f"({ {form: len(v) for form, v in recorded.items()} } by form)")


def loop_unit_calls(form, store=None):
    """The recorded calls of a loop-path form (staged_calls), one a
    source; of the brute force, the loop closer's (a candidate axis on
    side B)."""
    calls = staged_calls(form, LOOP_RECORDED_CALLS if store is None else store)
    if form == "match_brute_force_jit":
        calls = [c for c in calls if c[1][3].dim() == 3]
    return list({source: (source, args, kwargs) for source, args, kwargs in calls}.values())


def graphs_since(caps, reps):
    """(captures, replays since those counts, the live graphs' pool bytes)."""
    return (cuda_graph.n_captures() - caps, cuda_graph.n_replays() - reps,
            sum(g.pool_bytes for g in cuda_graph.graphs.values()))


def phase_loop_graphs(seqs, power):
    """The loop closer's, the staged mapper's and the AR anchor's
    single-dispatch forms, and the sharded global BA through the device
    loop, on the card:
    (a) the staged mapper's RGB-D System (ORB_TPU_STAGED_MAPPER=1) eager
        and replayed in turns, bit for bit, every frame OK and the ATE
        gate; the AR demo (run_ar) the same, the cube anchored and the
        anchors' planes equal; the eager turns record the forms' calls
        (the full-width loop run's turns run beside the other phases:
        phase_full_loop);
    (b) every recorded call of each form (these runs' and phase_loop's ring
        survey's; the full-width loop run's in phase_full_loop) through
        staged_unit: the replay bit for bit the eager
        call, the launches a call equal and all from replays, the replays
        and library calls a call, the host's waits those of the SVDs and
        the eigendecomposition alone, synced ms each way in turns;
    (c) the sharded global BA on the real map (ORB_DISTRIBUTED_GBA=1, a
        world of one over NCCL): eager (the early-exit form) and replayed
        (the device loop, the all-reduces in its graphs) in turns, the
        last two under torch.profiler, bit for bit each other and the plain
        replayed solve; ms an LM iteration and the idle share."""
    rows_at = len(STAGED_ROWS)
    cuda_graph.release(*LOOP_OWNERS)

    # (a) The runs in turns, the eager turns recorded.
    rgbd = seqs["rgbd"]
    gt_r = centres(rgbd[3])
    span = float(np.linalg.norm(gt_r[-1] - gt_r[0]))
    what = "System RGB-D, staged mapper"

    def mapper_run(prof):
        # Not profiled (the idle share not recorded): a depth cut.
        eager = matchers.search_fuse_jit is matchers.search_fuse
        with env_set(ORB_TPU_STAGED_MAPPER="1"), \
                staged_recording(what, LOOP_UNIT_FORMS, LOOP_RECORDED_CALLS) if eager \
                else contextlib.nullcontext():
            sys_, states, poses, seconds = run_system(rgbd, vocabulary="default")
        rmse = trajectory.ate_rmse(sys_.trajectory_positions(), gt_r, align_scale=False)
        if any(st != "OK" for st in states) or not rmse < ATE_SPAN_GATE * span:
            raise AssertionError(f"{what}: states {states}, ATE {rmse} (gate "
                                 f"{ATE_SPAN_GATE * span})")
        return sys_, SYSTEM_FRAMES, seconds, RUN_GRAPHS[-1]

    staged_turns(what, mapper_run, ("track", "map_tri", "map_fuse", "local_mapping"), power,
                 ("epipolar_hamming_top2", "projection_hamming_top2"), TWO_TURNS, LOOP_OWNERS)

    what = "AR demo (run_ar)"
    planes = []

    def ar_run(prof):
        caps, reps = cuda_graph.n_captures(), cuda_graph.n_replays()
        eager = ar.fit_plane_ransac_jit is ar.fit_plane_ransac
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ar_") as out, \
                staged_recording(what, LOOP_UNIT_FORMS, LOOP_RECORDED_CALLS) if eager \
                else contextlib.nullcontext():
            t0 = time.perf_counter()
            run = run_ar.run(AR_TURN_FRAMES, out_dir=out, device="cuda")
            seconds = time.perf_counter() - t0
        if run.anchor.Twp is None:
            raise AssertionError(f"{what}: no plane anchored")
        planes.append((run.anchor.Twp, run.anchor.size, list(run.overlaid)))
        return run.system, AR_TURN_FRAMES, seconds, graphs_since(caps, reps)

    staged_turns(what, ar_run, ("extract_frame", "track"), power, (), TWO_TURNS, LOOP_OWNERS)
    if not all(np.array_equal(p[0], planes[0][0]) and p[1:] == planes[0][1:] for p in planes):
        raise AssertionError(f"{what}: the turns anchored different planes")
    log(f"{what}: the same plane anchored in every turn, bit for bit (size "
        f"{planes[0][1]:.4f}, overlaid on {sum(planes[0][2])} of {AR_TURN_FRAMES} frames)")

    # (b) Every recorded call of each form, replay against eager call.
    missing = [form for _, form, _ in LOOP_UNIT_FORMS if not loop_unit_calls(form)]
    if missing:
        raise AssertionError(f"no call of {missing} was recorded")
    cuda_graph.release(*LOOP_OWNERS)
    per_form = {}
    for module, form, eager in LOOP_UNIT_FORMS:
        for source, args, kwargs in loop_unit_calls(form):
            if form == "fit_plane_ransac_jit":
                # The sample sets drawn once, on the card, so that every
                # call of the unit scores the same hypotheses.
                gen = torch.Generator().manual_seed(0)
                kwargs = dict(kwargs, generator=None, idx=ar.sample_indices(
                    args[0].shape[0], kwargs.get("n_iters", 128), gen).to(args[0].device))
                args = args[:2]
            _, counts, replays, n_lib = staged_unit(module, form, eager, source, args,
                                                    kwargs, power)
            per_form.setdefault(form, []).append((source, counts, replays, n_lib))
    cuda_graph.release(*LOOP_OWNERS)
    log("loop-path forms, per recorded call (form: [(source, launches a call, all from "
        "replays and equal to the eager call's; replays; library calls between them)]): "
        + "; ".join(f"{form}: {calls}" for form, calls in per_form.items()))
    log("loop-path forms, per recorded call (form, source, synced ms eager, replayed, "
        "replays a call, library calls between them, host reads eager, replayed): "
        + "; ".join(str(r) for r in STAGED_ROWS[rows_at:]) + f", on {power}")

    # (c) The sharded global BA, eager and replayed in turns.
    runs, profs = {"eager": [], "replayed": []}, {"eager": {}, "replayed": {}}
    for turn, kind in enumerate(("eager", "replayed", "replayed", "eager")):
        runs[kind].append(real_map_gba("1", "cuda", profs[kind] if turn >= 2 else None,
                                       eager=kind == "eager"))
    plain, _, _ = real_map_gba("0", "cuda")
    if not all(same_map(plain, r[0]) for rs in runs.values() for r in rs):
        raise AssertionError("sharded real-map global BA: a turn differs from the plain "
                             "replayed solve")
    for kind, rs in runs.items():
        wall_ms, busy_ms, n_ops = profs[kind].get("gba", (rs[-1][1] * 1e3, 0.0, 0))
        log(f"sharded real-map global BA ({REAL_MAP_SIZE[0]} keyframes, {REAL_MAP_SIZE[1]} "
            f"points, world 1 over NCCL), {kind}: {[round(r[1], 4) for r in rs]} s a run, "
            f"{rs[-1][2]} LM iterations, {[round(r[1] * 1e3 / max(r[2], 1), 2) for r in rs]} "
            f"ms an iteration; the profiled run's device busy {busy_ms:.1f} of {wall_ms:.1f} "
            f"ms, idle share {1.0 - busy_ms / wall_ms:.4f}, {n_ops} device operations; bit "
            f"for bit the plain replayed solve, on {power}")


# ---------------------------------------------------------------------------
# The JAX package's other routes: per-level extraction, the staged mapper and
# the native map core
# ---------------------------------------------------------------------------

# JAX tests/test_packed_extractor.py's tolerances between its two routes.
ROUTES_XY_TOL = 2e-3
ROUTES_ANGLE_TOL = 1e-6
# Device-busy timing of one image's extraction: calls a session, turns.
ROUTE_CALLS, ROUTE_TURNS = 5, 2
# Calls of one covisibility update timed each way (median taken).
COVIS_REPS = 20
# The staged mapper: triangulated positions, card against CPU (float32 DLT
# eigensolves; per point, |d| / |p|), and its System's points made against
# the batched route's (tests/test_torch_staged_mapper.py's POINTS_RTOL).
STAGED_TRI_RTOL = 5e-4
POINTS_RTOL = 0.02


def per_level_features(image, orb):
    """extract_features on the per-level route, patch form (K1 once a
    level, the standalone K4 twice a level)."""
    with env_set(ORB_TPU_FORCE_PACKED="0", ORB_TPU_FORCE_PATCHES="1"):
        return extractor.extract_features(image, orb, HEIGHT, WIDTH)


def packed_features(image, orb):
    with env_set(ORB_TPU_FORCE_PACKED="1"):
        return extractor.extract_features(image, orb, HEIGHT, WIDTH)


def phase_per_level(image, config, power):
    """The per-level extraction route on the main path's 640x480 image
    through extract_features, its launch counts reset just before and read
    just after: K1 once a level, the standalone K4 twice a level, nothing
    else. Held to the packed route on the card (JAX
    tests/test_packed_extractor.py's tolerances) and to the same route on
    the CPU (phase 4's rules); each of its K1 and K4 calls against the
    plain version; both routes' device-busy time per image, in turns. ->
    (launch counts, the recorded K1 calls, the recorded K4 calls)."""
    orb = config.orb
    want = dict.fromkeys(_build.launches, 0)
    want.update(level_preprocess=orb.n_levels, extract_patches=2 * orb.n_levels)
    torch.cuda.synchronize()
    _build.reset_launches()
    feats = per_level_features(image, orb)
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    check_counts("per-level extraction (ORB_TPU_FORCE_PACKED=0, patch route)", counts, want)

    got = interop.features_to_numpy(feats)
    ref = interop.features_to_numpy(packed_features(image, orb))
    v = ref["valid"]
    for key in ("valid", "octave", "response"):
        if not np.array_equal(got[key], ref[key]):
            raise AssertionError(f"per-level extraction: {key} differs from the packed route")
    if not np.array_equal(got["desc"][v], ref["desc"][v]):
        raise AssertionError("per-level extraction: descriptors differ from the packed route")
    d_xy = float(np.abs(got["xy"] - ref["xy"])[v].max())
    d_ang = float(np.abs(np.angle(np.exp(1j * (got["angle"].astype(np.float64)
                                                - ref["angle"]))))[v].max())
    log(f"per-level extraction vs the packed route on the card: valid, octave, response "
        f"and {int(v.sum())} descriptors equal; keypoints max|d| {d_xy:.3g} px (tolerance "
        f"{ROUTES_XY_TOL}), angles max|d| {d_ang:.3g} rad (tolerance {ROUTES_ANGLE_TOL})")
    if not (d_xy <= ROUTES_XY_TOL and d_ang <= ROUTES_ANGLE_TOL):
        raise AssertionError("per-level extraction: keypoints or angles off the packed route")
    check_features("per-level extraction", got,
                   interop.features_to_numpy(per_level_features(image.cpu(), orb)))

    k1, k4 = [], []
    with recording(level, "level_preprocess", k1), recording(patches, "extract_patches", k4):
        per_level_features(image, orb)
    k1, k4 = [c[0] for c in k1], [c[0] for c in k4]
    for img, th_hi, th_lo in k1:
        padded, hp, wp = level.pad_level(img)
        for name, g, w in zip(("blur", "score_hi", "score_lo"),
                              level.level_preprocess(img, th_hi, th_lo),
                              level.level_preprocess_plain(padded, hp, wp, th_hi, th_lo)):
            if not torch.equal(g, w):
                raise AssertionError(f"K1 {name} differs on the per-level {tuple(img.shape)} "
                                     f"level: {max_abs(g, w)}")
    log(f"K1 level_preprocess on the per-level route's {len(k1)} levels "
        f"{[tuple(a[0].shape) for a in k1]}: exact")
    for i, (img, yx, p) in enumerate(k4):
        check_extract(f"per-level route, level {i // 2}", img, yx, p)

    for turn in range(ROUTE_TURNS):
        ms = {name: device_busy_ms(lambda: fn(image, orb), ROUTE_CALLS)[0]
              for name, fn in (("per-level", per_level_features), ("packed", packed_features))}
        log(f"extraction of one {WIDTH}x{HEIGHT} image, turn {turn}: per-level route "
            f"{ms['per-level']:.4f} ms device busy, packed route {ms['packed']:.4f} ms, "
            f"on {power}")
    return counts, k1, k4


def map_stage_ms(timings, n_mapped):
    return ", ".join(f"{k} {timings[k]['total_s'] * 1e3 / max(n_mapped, 1):.3f}"
                     for k in ("map_tri", "map_fuse") if k in timings)


def _flat(outputs):
    """A top-2 kernel's outputs (K7's four tensors, or K6's four per
    window) as one flat list."""
    if isinstance(outputs, torch.Tensor):
        return [outputs]
    return [t for o in outputs for t in _flat(o)]


def check_recorded(name, calls, kernel, plain):
    """Each recorded call of a top-2 kernel, launched again on its
    arguments, against its plain version on the same inputs: every output
    exact -> (calls, rows with a candidate, rows)."""
    hit = rows = 0
    for i, (args, kwargs) in enumerate(calls):
        got, want = _flat(kernel(*args, **kwargs)), _flat(plain(*args, **kwargs))
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version on recorded call "
                                 f"{i}: " + ", ".join(f"{int((g != w).sum())} rows"
                                                      for g, w in zip(got, want)))
        hit += int((got[0] <= 256).sum())
        rows += got[0].numel()
    return len(calls), hit, rows


def map_after(m):
    """The tables a mapping step may change, copied."""
    return dict(next_pt=int(m.next_pt), kf_point_idx=m.kf_point_idx.copy(),
                pt_valid=m.pt_valid[:m.next_pt].copy(), pt_pos=m.pt_pos[:m.next_pt].copy())


def replay_on_cpu(what, config, kf, before, card):
    """The staged triangulation of keyframe kf on the CPU (K7's plain
    version, the DLT in float32 on the CPU), from the card's map just
    before it: next_pt, every binding and every point's validity equal to
    what the card left -> the largest |d| / |p| over the points' positions.
    (The fuse is not replayed so: its projections into each target, in
    float32 on either device, put a few points on either side of a
    window's edge.)"""
    ms = interop.map_state_from_numpy(before)
    with env_set(ORB_TPU_STAGED_MAPPER="1"):
        LocalMapper(config, ms, device="cpu")._create_new_points_staged(kf)
    cpu = map_after(ms)
    for key in ("next_pt", "kf_point_idx", "pt_valid"):
        if not np.array_equal(card[key], cpu[key]):
            raise AssertionError(
                f"{what}: the triangulation of keyframe {kf} on the card and on the CPU "
                f"differ in {key} ({card['next_pt']} and {cpu['next_pt']} points, "
                f"{int((card['kf_point_idx'] != cpu['kf_point_idx']).sum())} bindings differ)")
    if not card["next_pt"]:
        return 0.0
    return float((np.linalg.norm(card["pt_pos"] - cpu["pt_pos"], axis=1)
                  / np.maximum(np.linalg.norm(cpu["pt_pos"], axis=1), 1e-12)).max())


def phase_staged_mapper(seq, power):
    """The RGB-D sequence through a synchronous System with the staged
    mapper (ORB_TPU_STAGED_MAPPER=1), its forms replayed as on the card's
    main path, the launch counts reset just before and read just after:
    every frame OK, the ATE gate, the System's kernels launched, nothing
    with a batch axis, and per mapped keyframe K7 under the epipolar band
    once per neighbour pair and K6 once per fuse target (plus the reverse
    pass), each launched by a replay of the triangulation's or the fuse's
    graph, beside one eager launch per graph captured (its warm-up). Each
    recorded call of those two forms (cloned) run again through its eager
    function: the K7 and K6 calls it makes against their plain versions.
    Each keyframe's staged triangulation replayed on the CPU from the
    card's map just before it (bindings equal, positions to
    STAGED_TRI_RTOL); the same keyframes as a batched run of the sequence
    and a point count within POINTS_RTOL of its. Its map against the
    batched route's first run (equal, or the first difference); map_tri
    and map_fuse per keyframe in a staged run with no spies against the
    batched run. -> (launch counts, the System)."""
    what = "System RGB-D, staged mapper"
    batched_sys, _, _, _ = run_system(seq, vocabulary="default")
    mapped = []
    tri, fuse = LocalMapper._create_new_points_staged, LocalMapper._fuse_neighbors

    def launched(fn, kernel, body):
        """body() -> (kernel's launches in it, those that fn's replays
        added, fn's graphs captured in it)."""
        def now():
            return (_build.launches[kernel],
                    cuda_graph.replayed_by.get(fn.__name__, {}).get(kernel, 0),
                    sum(1 for k in cuda_graph.graphs if k[0] is fn))
        before = now()
        body()
        return tuple(b - a for a, b in zip(before, now()))

    def tri_spy(self, kf):
        pairs = len(self._neighbor_pairs(kf)[1])
        before = interop.map_state_to_numpy(self.map)
        k7 = launched(matchers._triangulation, "epipolar_hamming_top2", lambda: tri(self, kf))
        mapped.append(dict(kf=kf, pairs=pairs, k7=k7,
                           made=self.map.next_pt - before["next_pt"],
                           tri=(before, map_after(self.map))))

    def fuse_spy(self, kf):
        targets = self._fuse_targets(kf)
        pts = self.map.kf_point_idx[kf]
        has_pts = bool(self.map.pt_valid[pts[pts >= 0]].any())
        k6 = launched(matchers._search_fuse, "projection_hamming_top2", lambda: fuse(self, kf))
        mapped[-1].update(targets=len(targets),
                          want_k6=(len(targets) if has_pts else 0) + (1 if targets else 0),
                          k6=k6)

    # Each call of the two forms, its arguments cloned (the caller's
    # tensors are not kept).
    forms = {matchers.match_for_triangulation: "match_for_triangulation_jit",
             matchers.search_fuse: "search_fuse_jit"}
    form_calls = {eager: [] for eager in forms}
    saved = {form: getattr(matchers, form) for form in forms.values()}

    def form_spy(eager, fn):
        def call(*args, **kwargs):
            form_calls[eager].append(tree_map(
                lambda a: a.clone() if isinstance(a, torch.Tensor) else a, (args, kwargs)))
            return fn(*args, **kwargs)
        return call

    batched = {}
    LocalMapper._create_new_points_staged, LocalMapper._fuse_neighbors = tri_spy, fuse_spy
    for eager, form in forms.items():
        setattr(matchers, form, form_spy(eager, saved[form]))
    try:
        with env_set(ORB_TPU_STAGED_MAPPER="1"), batched_launches(batched):
            torch.cuda.synchronize()
            _build.reset_launches()
            sys_, states, poses, seconds = run_system(seq, vocabulary="default")
            counts = dict(_build.launches)
    finally:
        LocalMapper._create_new_points_staged, LocalMapper._fuse_neighbors = tri, fuse
        for form, fn in saved.items():
            setattr(matchers, form, fn)
    log(f"{what} launches: {counts}; of them with a batch axis: {batched}")
    if [k for k in SYSTEM_LAUNCHED if counts[k] < 1] or [k for k in SYSTEM_UNUSED if counts[k]] \
            or any(batched.values()):
        raise AssertionError(f"{what}: a kernel of the path did not launch, or one off it did")
    if any(st != "OK" for st in states) or any(p is None for p in poses):
        raise AssertionError(f"{what}: states {states}")
    # (launches, of them in replays, graphs captured): a replay per pair or
    # target, and a warm-up launch per graph captured.
    bad = [m for m in mapped if m["k7"] != (m["pairs"] + m["k7"][2], m["pairs"], m["k7"][2])
           or m["k6"] != (m["want_k6"] + m["k6"][2], m["want_k6"], m["k6"][2])]
    log(f"{what}: per mapped keyframe (kf, neighbour pairs, K7 epipolar (launches, of them in "
        f"replays, graphs captured), points triangulated, fuse targets, K6 in the fuse "
        f"(launches, in replays, graphs captured)): "
        f"{[(m['kf'], m['pairs'], m['k7'], m['made'], m['targets'], m['k6']) for m in mapped]}")
    if not mapped or bad or sum(m["pairs"] for m in mapped) < 1:
        raise AssertionError(f"{what}: launches off one replay per pair and per target and "
                             f"one warm-up per graph: {bad}")

    # Each recorded call of the two forms through its eager function (a
    # replay is bit for bit its eager call: phase_loop_graphs): the K7 and
    # K6 calls it makes, against their plain versions.
    # (name, eager function, calls wanted, wrapper, plain version, the
    # arguments' row and column tables)
    for name, eager, want, kernel, plain, cols in (
            ("K7 epipolar_hamming_top2", matchers.match_for_triangulation,
             sum(m["pairs"] for m in mapped), kmatching.epipolar_hamming_top2,
             kmatching.epipolar_hamming_top2_plain, (0, 1)),
            ("K6 projection_hamming_top2", matchers.search_fuse,
             sum(m["want_k6"] for m in mapped), kmatching.projection_hamming_top2,
             kmatching.projection_hamming_top2_plain, (1, 6))):
        calls = []
        with recording(kmatching, kernel.__name__, calls):
            for args, kwargs in form_calls[eager]:
                eager(*args, **kwargs)
        if len(form_calls[eager]) != want or len(calls) != want:
            raise AssertionError(f"{what}: {len(form_calls[eager])} calls of {forms[eager]} "
                                 f"recorded, {len(calls)} of {name} from them, for {want} "
                                 f"replays")
        n, hit, rows = check_recorded(name, calls, kernel, plain)
        shapes = sorted({tuple(a[i].shape[-2] for i in cols) for a, _ in calls})
        log(f"{name} on the staged run's {n} replayed calls (each recomputed by "
            f"{forms[eager]}'s eager function on its recorded inputs; rows x columns "
            f"{shapes}): exact against its plain version in every output ({hit} of {rows} "
            f"rows with a candidate)")

    config = sys_.mapper.config
    d_tri = max(replay_on_cpu(what, config, m["kf"], *m["tri"]) for m in mapped)
    made = sum(m["made"] for m in mapped)
    log(f"{what}: each of {len(mapped)} keyframes' staged triangulation replayed on the CPU "
        f"from the card's map: bindings and validity equal; {made} points triangulated, "
        f"positions max |d| / |p| {d_tri:.3g} (tolerance {STAGED_TRI_RTOL})")
    if not (made >= 1 and d_tri <= STAGED_TRI_RTOL):
        raise AssertionError(f"{what}: {made} points triangulated, or positions off the CPU's")

    gt_c = np.asarray([-R.T @ t for R, t in seq[3]])
    rmse = trajectory.ate_rmse(sys_.trajectory_positions(), gt_c, align_scale=False)
    span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    a, b = sys_.map, batched_sys.map
    log(f"{what}: {SYSTEM_FRAMES} frames all OK in {seconds:.2f} s, {a.next_kf} "
        f"keyframes, {a.next_pt} points made ({a.n_points()} kept; the batched route "
        f"{b.next_pt} made, {b.n_points()} kept, tolerance {POINTS_RTOL}); ATE {rmse:.6f} m "
        f"over a {span:.3f} m span (gate {ATE_SPAN_GATE} x span)")
    if not rmse < ATE_SPAN_GATE * span:
        raise AssertionError(f"{what}: ATE {rmse} over the gate")
    if not np.array_equal(a.kf_frame_id[:a.next_kf], b.kf_frame_id[:b.next_kf]) \
            or abs(a.next_pt - b.next_pt) > POINTS_RTOL * b.next_pt:
        raise AssertionError(f"{what}: keyframes {a.kf_frame_id[:a.next_kf].tolist()} and "
                             f"{a.next_pt} points against the batched route's "
                             f"{b.kf_frame_id[:b.next_kf].tolist()} and {b.next_pt}")
    first_run, first = RUNS[system_name("rgbd")][0]
    fp = fingerprint(sys_)
    diffs = [f"{key}: {first_difference(fp[key], want)}" for key, want in first.items()
             if fp[key].shape != want.shape or not np.array_equal(fp[key], want)]
    log(f"{what} against the batched route's {first_run} run: "
        + ("equal, bit for bit" if not diffs else "differs; first difference in " + diffs[0]))
    with env_set(ORB_TPU_STAGED_MAPPER="1"):
        timed_sys, _, _, _ = run_system(seq, vocabulary="default")
    for name, s_ in (("staged", timed_sys), ("batched", batched_sys)):
        t = s_.timings()
        n = int(t.get("local_mapping", {}).get("count", 0))
        log(f"{what}: {name} route ms per mapped keyframe ({n} mapped; host clock): "
            f"{map_stage_ms(t, n)} on {power}")
    return counts, sys_


def phase_native_core(sys_, power):
    """The native map core loads on the card's host, and its three counts
    equal the plain numpy versions on the System's final map; one
    update_covisibility timed through each."""
    if native_core.get_lib() is None:
        raise AssertionError("the native map core did not build or load (g++ missing?)")
    m = sys_.map
    kpi, kv, n_pts = m.kf_point_idx, m.kf_valid, m.cfg.max_points
    kfs = np.nonzero(kv)[0]
    for k in kfs:
        if not np.array_equal(native_core.covis_row(kpi, kv, n_pts, int(k)),
                              native_core.covis_row_plain(kpi, kv, n_pts, int(k))):
            raise AssertionError(f"native covis_row differs from numpy at keyframe {k}")
    for name in ("obs_counts", "covis_matrix"):
        if not np.array_equal(getattr(native_core, name)(kpi, kv, n_pts),
                              getattr(native_core, f"{name}_plain")(kpi, kv, n_pts)):
            raise AssertionError(f"native {name} differs from numpy")
    k = int(kfs[-1])
    ms = {}
    fn = native_core.covis_row
    for name, row in (("native", fn), ("numpy", native_core.covis_row_plain)):
        native_core.covis_row = row
        try:
            times = []
            for _ in range(COVIS_REPS):
                t0 = time.perf_counter()
                m.update_covisibility(k)
                times.append((time.perf_counter() - t0) * 1e3)
        finally:
            native_core.covis_row = fn
        ms[name] = float(np.median(times))
    log(f"native map core ({native_core.library_path().name}): covis_row on {kfs.size} "
        f"keyframes, obs_counts and covis_matrix equal numpy on the final map "
        f"({kpi.shape[0]} x {kpi.shape[1]} table, {n_pts} points); one update_covisibility "
        f"median of {COVIS_REPS}: native {ms['native']:.4f} ms, numpy {ms['numpy']:.4f} ms "
        f"(host clock, on the card's host; {power})")


# ---------------------------------------------------------------------------
# The monocular System: two-view initialization, the lateral sweep, and
# relocalization after a kidnap
# ---------------------------------------------------------------------------

def k7_caller(name, args):
    """The caller of a recorded call of K7 under a candidate test, from its
    form and shapes: initialization (the window), triangulation (the
    epipolar band), relocalization (the flags, a batch of candidates
    against the frame's shared descriptor table) or reference-keyframe
    tracking (the flags, one problem)."""
    if name == "window_hamming_top2":
        return "initialization"
    if name == "epipolar_hamming_top2":
        return "triangulation"
    if args[0].dim() == 3:
        return "relocalization"
    if args[1].dim() == 3:
        raise AssertionError("a monocular run without a vocabulary matched loop candidates")
    return "reference keyframe"


@contextlib.contextmanager
def replays_seen(on_replay):
    """on_replay(graph, times) after each replay of a CUDA graph inside the
    block (cuda_graph.Graph.replayed, which adds the replay's launches)."""
    fn = cuda_graph.Graph.replayed

    def spy(self, times=1):
        fn(self, times)
        on_replay(self, times)

    cuda_graph.Graph.replayed = spy
    try:
        yield
    finally:
        cuda_graph.Graph.replayed = fn


def replayed_k7_caller(g):
    """The K7 caller of a replayed graph's K7 launches and the problems one
    launch carries, or None: the staged matchers' graphs (initialization's
    window; the flags, batched over relocalization's candidates or one
    reference keyframe) and the mapper's triangulation (batched, or the
    staged mapper's one pair)."""
    if g.name == "_init_match":
        return "initialization", 1
    if g.name == "triangulation_match":
        return "triangulation", g.inputs[2].shape[0]
    if g.name == "_triangulation":
        return "triangulation", 1
    if g.name == "_brute_force":
        desc_a, desc_b = g.inputs[0], g.inputs[3]
        if desc_b.dim() == 3:
            raise AssertionError("a monocular run without a vocabulary matched loop "
                                 "candidates")
        return ("relocalization", desc_a.shape[0]) if desc_a.dim() == 3 else (
            "reference keyframe", 1)
    return None


@contextlib.contextmanager
def k7_launches_by_caller(counts, problems):
    """counts[caller] += launches of K7 under a candidate test by each
    caller, and problems[caller] += the problems they carried (read off
    the launch counters around each eager call, and off the tallies of
    the replays of the graphs that launch it: replayed_k7_caller)."""
    fns = {name: getattr(kmatching, name) for name in K7_FORMS}

    def on_replay(g, times):
        hit = replayed_k7_caller(g)
        if hit is not None:
            n = sum(g.launches.get(k, 0) for k in K7_FORMS) * times
            counts[hit[0]] += n
            problems[hit[0]] += n * hit[1]

    def spy(name):
        def call(*args):
            before = _build.launches[name]
            out = fns[name](*args)
            caller = k7_caller(name, args)
            n = _build.launches[name] - before
            counts[caller] += n
            problems[caller] += n * (k7_batch(name, args) or (1,))[0]
            return out
        return call

    for caller in K7_CALLERS:
        counts[caller] = problems[caller] = 0
    for name in K7_FORMS:
        setattr(kmatching, name, spy(name))
    try:
        with replays_seen(on_replay):
            yield counts
    finally:
        for name, fn in fns.items():
            setattr(kmatching, name, fn)


# The eager warm-up of the kidnap sequence (mono_path_inputs): its stage
# timings and frames/s, against the counted (replayed) run in phase_mono.
MONO_WARMUP = {}


def mono_path_inputs(kidnap_seq):
    """One warm-up run of the kidnap sequence on the card, eager
    (eager_forms; every kernel of the monocular path built, both feature
    budgets' tables made),
    recording the calls of K7 at initialization (under the window) and at
    relocalization (under the flags, those with a candidate pair): the
    first SYSTEM_RECORDED of each."""
    calls = {name: [] for name in K7_FORMS}
    with contextlib.ExitStack() as stack:
        # Eager: the recorded arguments are the wrappers' own, not a graph's.
        stack.enter_context(eager_forms())
        for name in K7_FORMS:
            stack.enter_context(recording(kmatching, name, calls[name]))
        sys_, states, _, seconds = run_system(kidnap_seq, n_frames=MONO_FRAMES)
    remember("System monocular kidnap", "warm-up", sys_)
    MONO_WARMUP.update(timings=sys_.timings(), fps=MONO_FRAMES / seconds)
    by = {c: [a for name in K7_FORMS for a, _ in calls[name] if k7_caller(name, a) == c]
          for c in K7_CALLERS}
    log(f"System monocular kidnap warm-up: {seconds:.2f} s for {MONO_FRAMES} frames, "
        f"{sys_.map.next_kf} keyframes inserted, states {''.join(st[0] for st in states)}; "
        f"K7 calls by caller: { {c: len(v) for c, v in by.items()} }")
    # An occluded frame has no feature, so its relocalization call has no
    # candidate pair: keep the calls that have.
    by["relocalization"] = [a for a in by["relocalization"]
                            if bool(k7_mask("valid_hamming_top2", a).any())]
    for c in ("initialization", "relocalization"):
        if not by[c]:
            raise AssertionError(f"the monocular kidnap run made no K7 call at {c} "
                                 f"with a candidate")
    return dict(mono_k7_init=by["initialization"][:SYSTEM_RECORDED],
                mono_k7_reloc=by["relocalization"][:SYSTEM_RECORDED])


def mono_vs_cpu(seq, init_frame):
    """The sweep up to MONO_CPU_FRAMES frames past its initialization on the
    card and on the CPU, on the card's route (fused, forced there), each
    tracker drawing the same host sample sets: the same initialization
    frame and keyframes, frame and keyframe poses within ROT_DEG_TOL /
    T_TOL (in the map's units, the median depth at initialization)."""
    n = init_frame + 1 + MONO_CPU_FRAMES
    with env_set(ORB_TPU_FUSED_TRACK="1"):
        cpu_sys, states, poses, seconds = run_system(seq, "cpu", n)
    card_sys, card_states, card_poses, _ = run_system(seq, "cuda", n)
    if states != card_states:
        raise AssertionError(f"System monocular states: card {card_states}, cpu {states}")
    worst = (0.0, 0.0)
    for p, c in zip(poses, card_poses):
        if (p is None) != (c is None):
            raise AssertionError("System monocular: a frame tracked on one device only")
        if p is not None:
            d = (rot_angle_deg(p[0], c[0]), float(np.linalg.norm(p[1] - c[1])))
            worst = tuple(max(a, b) for a, b in zip(worst, d))
    kfs = [m.kf_frame_id[:m.next_kf].tolist() for m in (card_sys.map, cpu_sys.map)]
    if kfs[0] != kfs[1]:
        raise AssertionError(f"System monocular keyframes: card {kfs[0]}, cpu {kfs[1]}")
    kf_worst = (0.0, 0.0)
    cm, pm = card_sys.map, cpu_sys.map
    for k in range(cm.next_kf):
        d = (rot_angle_deg(pm.kf_pose_R[k], cm.kf_pose_R[k]),
             float(np.linalg.norm(pm.kf_pose_t[k] - cm.kf_pose_t[k])))
        kf_worst = tuple(max(a, b) for a, b in zip(kf_worst, d))
    log(f"System monocular, {n} frames card vs cpu ({seconds:.1f} s on the CPU): "
        f"initialized at frame {states.index('OK')} on both, keyframes {kfs[0]} equal, "
        f"frame poses within rot {worst[0]:.5f} deg, |dt| {worst[1]:.6f}; keyframe poses "
        f"within rot {kf_worst[0]:.5f} deg, |dt| {kf_worst[1]:.6f}")
    if not (max(worst[0], kf_worst[0]) < ROT_DEG_TOL and max(worst[1], kf_worst[1]) < T_TOL):
        raise AssertionError("the monocular System's card and CPU poses differ beyond the bounds")


def centres(poses):
    return np.asarray([-R.T @ t for R, t in poses])


def phase_mono(seq, kidnap_seq, power):
    """The sweep on the card through track_monocular, the launch counts
    reset just before and read just after it: it initializes (K7 under the
    window, [2000, 2000]), every frame after that OK, >= 3 keyframes, >= 150
    points, the scale-aligned ATE gate, every kernel of the path launched;
    frames/s (after mono_path_inputs' warm-up), stage times, a second run
    with frames 3-14 under torch.profiler, and the first frames against
    the CPU. Then the kidnap sequence, its counts read the same way: LOST
    during the occlusion, relocalized after it (K7 batched over the
    candidates), recovered poses within KIDNAP_GATE; the staged forms'
    calls recorded (STAGED_RECORDED); its frames/s and stage ms against
    the eager warm-up's (mono_path_inputs). Then the sweep's first
    SWEEP_TURN_FRAMES frames eager and replayed in turns (staged_turns,
    TWO_TURNS), bit for bit the same. -> (launch counts of the sweep, K7 launches by
    caller over both runs, problems by caller)."""
    what = "System monocular"
    _, _, _, gt = seq
    by_caller, problems = {}, {}
    _build.reset_launches()
    with k7_launches_by_caller(by_caller, problems):
        sys_, states, poses, seconds = run_system(seq, n_frames=MONO_FRAMES)
    remember(what, "counted", sys_)
    c = dict(_build.launches)
    log(f"{what} launches: {c}; K7 by caller: {by_caller} (problems {problems})")
    if [k for k in MONO_LAUNCHED if c[k] < 1] or [k for k in SYSTEM_UNUSED if c[k]] \
            or c["stereo_band_top2"] or by_caller["initialization"] < 1:
        raise AssertionError(f"{what}: a kernel of the path did not launch, one off the "
                             f"path did, or the initialization's K7 did not launch")
    if "OK" not in states:
        raise AssertionError(f"{what}: never initialized ({states})")
    f0 = states.index("OK")
    if any(st != "OK" for st in states[f0:]) or any(p is None for p in poses[f0:]):
        raise AssertionError(f"{what}: states {states}")
    timings = sys_.timings()
    n_mapped = int(timings.get("local_mapping", {}).get("count", 0))
    est = sys_.trajectory_positions()
    gt_c = centres(gt)
    rmse = trajectory.ate_rmse(est, gt_c[len(gt_c) - len(est):], align_scale=True)
    span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    log(f"{what}: initialized at frame {f0}, {MONO_FRAMES - f0} frames OK, "
        f"{sys_.map.next_kf} keyframes inserted ({sys_.map.n_keyframes()} kept), "
        f"{n_mapped} mapped, {sys_.map.n_points()} points; scale-aligned ATE {rmse:.6f} "
        f"over a {span:.3f} m span (gate {MONO_ATE_GATE} x span)")
    if sys_.map.n_keyframes() < MONO_MIN_KFS or sys_.map.n_points() < MONO_MIN_POINTS:
        raise AssertionError(f"{what}: too few keyframes or points")
    if not rmse < MONO_ATE_GATE * span:
        raise AssertionError(f"{what}: ATE {rmse} over the gate")
    log(f"{what}: {MONO_FRAMES / seconds:.2f} frames/s over the sequence ({seconds:.3f} s) "
        f"on {power}; launches per mapped keyframe: " + ", ".join(
            f"{k} {c[k] / max(n_mapped, 1):.2f}"
            for k in K7_FORMS + ("projection_hamming_top2", "pose_lm")))
    for stage, st in sorted(timings.items()):
        log(f"    {what} stage {stage}: {int(st['count'])} x {st['mean_ms']:.3f} ms "
            f"(max {st['max_ms']:.3f}, total {st['total_s'] * 1e3:.1f} ms)")

    profs = {}
    sys2, _, _, _ = run_system(seq, n_frames=MONO_FRAMES, around=lambda i: (
        profiled(profs, i) if 3 <= i < 15 else contextlib.nullcontext()))
    remember(what, "profiled", sys2)
    check_same_bits(what)
    kf_frames = {int(f) for f in sys2.map.kf_frame_id[:sys2.map.next_kf]}
    for kind, frames in (("keyframe", sorted(kf_frames & set(profs))),
                         ("plain", sorted(set(profs) - kf_frames))):
        if not frames:
            raise AssertionError(f"{what}: no {kind} frame among frames 3-14")
        wall, busy, n_ops = (np.mean([profs[i][j] for i in frames]) for j in range(3))
        log(f"profiled {what} {kind} frames {frames}: mean {wall:.3f} ms wall, "
            f"{busy:.3f} ms device busy, idle share {1.0 - busy / wall:.4f}, "
            f"{n_ops:.0f} device operations, on {power}")
    mono_vs_cpu(seq, f0)

    what = "System monocular kidnap"
    _, _, _, gt = kidnap_seq
    kid_caller, kid_problems = {}, {}
    _build.reset_launches()
    with k7_launches_by_caller(kid_caller, kid_problems), staged_recording("monocular kidnap"):
        sys_, states, poses, seconds = run_system(kidnap_seq, n_frames=MONO_FRAMES)
    remember(what, "counted", sys_)
    check_same_bits(what)
    kc = dict(_build.launches)
    log(f"{what} launches: {kc}; K7 by caller: {kid_caller} "
        f"(problems {kid_problems}); states {''.join(st[0] for st in states)}")
    tr = sys_.tracker
    if "LOST" not in states[KIDNAP.start:KIDNAP.stop] or states[-1] != "OK" \
            or tr.last_reloc_frame_id < KIDNAP.stop or kid_caller["relocalization"] < 1:
        raise AssertionError(f"{what}: not lost during the occlusion, or not relocalized "
                             f"after it (last relocalization at frame "
                             f"{tr.last_reloc_frame_id})")
    gt_c = centres(gt)
    pre = [i for i in range(KIDNAP.start) if poses[i] is not None]
    post = [i for i in range(KIDNAP.stop + 1, MONO_FRAMES) if poses[i] is not None]
    s_, R_a, t_a = trajectory.umeyama_alignment(
        centres([poses[i] for i in pre]), gt_c[pre], True)
    err = np.linalg.norm(s_ * centres([poses[i] for i in post]) @ R_a.T + t_a - gt_c[post],
                         axis=1)
    span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    timings = sys_.timings()
    log(f"{what}: relocalized at frame {tr.last_reloc_frame_id} against keyframe "
        f"{tr.ref_kf}; {len(post)} frames tracked after it, median error "
        f"{np.median(err):.6f} over a {span:.3f} m span (gate {KIDNAP_GATE} x span); "
        + ", ".join(f"{k} {int(timings[k]['count'])} x {timings[k]['mean_ms']:.3f} ms "
                    f"(max {timings[k]['max_ms']:.3f})"
                    for k in ("track_reloc", "reloc_match", "reloc_epnp") if k in timings)
        + f", on {power}")
    if len(post) < 8 or not np.median(err) < KIDNAP_GATE * span:
        raise AssertionError(f"{what}: recovered poses off the trajectory")
    warm = MONO_WARMUP["timings"]
    log(f"{what}, eager (mono_path_inputs' warm-up, the first run of the sequence) against "
        f"replayed (the counted run), bit for bit the same: frames/s "
        f"{MONO_WARMUP['fps']:.2f} against {MONO_FRAMES / seconds:.2f}; "
        + ", ".join(f"{k} {warm[k]['mean_ms']:.3f} against {timings[k]['mean_ms']:.3f} ms"
                    for k in ("init_twoview", "track_reloc", "reloc_match", "reloc_epnp")
                    if k in warm and k in timings) + f", on {power}")

    def run(prof):
        sys_, _, _, seconds = run_system(
            seq, n_frames=SWEEP_TURN_FRAMES,
            around=None if prof is None else window_profiled(prof, MONO_PROFILED_FRAMES))
        return sys_, SWEEP_TURN_FRAMES, seconds, RUN_GRAPHS[-1]

    staged_turns(f"System monocular, first {SWEEP_TURN_FRAMES} frames", run,
                 ("extract_frame", "init_twoview", "track"), power,
                 ("level_preprocess", "window_hamming_top2", "pose_lm"), TWO_TURNS)
    for k in K7_CALLERS:
        by_caller[k] += kid_caller[k]
        problems[k] += kid_problems[k]
    return c, by_caller, problems


# ---------------------------------------------------------------------------
# Place recognition and loop closing: the ring survey with the bundled
# vocabulary, and the kidnap sequence's BoW relocalization
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def loop_kernel_calls(counts, calls=None):
    """counts[caller] += the launches of K6 and K7 by each loop caller:
    K7 in compute_sim3 (every candidate's brute force in one launch), K6 in
    its SearchBySim3 (match_by_sim3, one launch a direction) and in its
    loop-neighbourhood projection (match_fuse), K7 in relocalization with a
    keyframe database (BoW candidates; replayed in the staged matcher's
    graph, `_brute_force`, counted off its tally). The caller of a launch
    is the loop method running when it happens (a stack of spies); the
    replays of the loop closer's graphs add their tallies. With `calls`,
    also calls[caller].append(args) for each call made outside a capture
    (the eager calls and each graph's warm-up)."""
    stack = []
    spied = [(loop_closing.LoopCloser, "compute_sim3"),
             (loop_closing.LoopCloser, "_search_by_sim3"), (Tracker, "_relocalize")]
    methods = {(cls, name): getattr(cls, name) for cls, name in spied}

    def method_spy(cls, name):
        fn = methods[cls, name]

        def call(self, *args, **kwargs):
            bow = name != "_relocalize" or self.kf_database is not None
            stack.append(name if bow else None)
            try:
                return fn(self, *args, **kwargs)
            finally:
                stack.pop()
        return call

    kernels = {name: getattr(kmatching, name) for name in SYSTEM_KERNELS}

    def caller_of(kernel):
        top = stack[-1] if stack else None
        if top == "_search_by_sim3":
            return "match_by_sim3" if kernel == "projection_hamming_top2" else None
        if top == "compute_sim3":
            return {"valid_hamming_top2": "compute_sim3",
                    "projection_hamming_top2": "loop match_fuse"}.get(kernel)
        if top == "_relocalize" and kernel == "valid_hamming_top2":
            return "BoW relocalization"
        return None

    def kernel_spy(kernel):
        fn = kernels[kernel]

        def call(*args):
            caller = caller_of(kernel)
            before = _build.launches[kernel]
            out = fn(*args)
            if caller is not None:
                counts[caller] += _build.launches[kernel] - before
                # Not inside a capture; clones, since a graph's first call
                # (its warm-up) passes the graph's own buffers.
                if calls is not None and not torch.cuda.is_current_stream_capturing():
                    calls[caller].append(tuple(a.clone() if isinstance(a, torch.Tensor)
                                               else a for a in args))
            return out
        return call

    def on_replay(g, times):
        # The loop closer's graphs (the brute force over its candidates,
        # SearchBySim3, the widening's fuse) and relocalization's brute
        # force, by the loop method running.
        for kernel, n in g.launches.items():
            if caller_of(kernel) is not None:
                counts[caller_of(kernel)] += n * times

    for caller in LOOP_CALLERS:
        counts[caller] = 0
        if calls is not None:
            calls.setdefault(caller, [])
    for (cls, name) in spied:
        setattr(cls, name, method_spy(cls, name))
    for kernel in SYSTEM_KERNELS:
        setattr(kmatching, kernel, kernel_spy(kernel))
    try:
        with replays_seen(on_replay):
            yield counts
    finally:
        for (cls, name), fn in methods.items():
            setattr(cls, name, fn)
        for kernel, fn in kernels.items():
            setattr(kmatching, kernel, fn)


def loop_sequence():
    """(config, images [132, H, W], ground-truth poses) of the ring survey."""
    config = synthetic_config(LOOP_WIDTH, LOOP_HEIGHT, LOOP_FEATURES)
    images, poses, _ = synthetic.render_loop_sequence(config.camera, **LOOP_SCENE)
    return config, images, poses


def loop_ate(sys_, gt_c):
    """Scale-aligned ATE of the tracked frames so far (tests/test_loop_pipeline.py)."""
    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    off = len(gt_c) - len(est)
    return trajectory.ate_rmse(est[~lost], gt_c[off:off + len(est)][~lost], align_scale=True)


def run_loop(seq, device="cuda", on_close=None):
    """The ring survey through System.track_monocular with the bundled
    vocabulary -> (system, states, seconds, pre) where pre holds the ATE and
    the trajectory's length when the first correction starts. on_close():
    called as each correction starts."""
    config, images, poses = seq
    sys_ = System(config, async_mapping=False, device=device)
    if sys_.loop_closer is None:
        raise AssertionError("the System built no loop closer with the bundled vocabulary")
    gt_c = centres(poses)
    pre = {}
    correct = sys_.loop_closer.correct_loop

    def correct_spy(*args, **kwargs):
        if "ate" not in pre:
            pre.update(ate=loop_ate(sys_, gt_c), n=len(sys_.tracker.trajectory),
                       frame=sys_.frame_count - 1)
        if on_close is not None:
            on_close()
        return correct(*args, **kwargs)

    sys_.loop_closer.correct_loop = correct_spy
    states = []
    t0 = time.perf_counter()
    for i in range(images.shape[0]):
        sys_.track_monocular(images[i], i / config.camera.fps)
        states.append(sys_.tracking_state().name)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return sys_, states, seconds, pre


def loop_gates(what, sys_, states, pre, gt_c):
    """tests/test_loop_pipeline.py:67-105's four gates -> their numbers."""
    closer = sys_.loop_closer
    if states[-1] != "OK" or closer.n_loops_closed < 1:
        raise AssertionError(f"{what}: state {states[-1]}, {closer.n_loops_closed} loops closed")
    if not sys_.map.loop_edges or sys_.map.big_change_idx < 1:
        raise AssertionError(f"{what}: no loop edge or map change")
    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    off, n = len(gt_c) - len(est), pre["n"]
    prefix = trajectory.ate_rmse(est[:n][~lost[:n]], gt_c[off:off + n][~lost[:n]],
                                 align_scale=True)
    final = loop_ate(sys_, gt_c)
    span = float(np.abs(gt_c).max() * 2)
    if not prefix < pre["ate"]:
        raise AssertionError(f"{what}: corrected prefix ATE {prefix} not below {pre['ate']}")
    if not final < LOOP_ATE_SPAN * span:
        raise AssertionError(f"{what}: final ATE {final} over {LOOP_ATE_SPAN} x {span}")
    return prefix, final, span


@contextlib.contextmanager
def loop_stages_profiled(profs):
    """profs[stage] += (wall ms, device busy ms, device operations) of the
    first LOOP_PROFILE_CALLS calls of each of the loop closer's stages, each
    under torch.profiler: detect_loop, compute_sim3, and inside
    correct_loop the essential graph and global BA."""
    fns = {name: getattr(loop_closing.LoopCloser, name) for name in LOOP_PROFILED}

    def spy(name):
        fn = fns[name]

        def call(self, *args, **kwargs):
            if len(profs.setdefault(name, [])) >= LOOP_PROFILE_CALLS:
                return fn(self, *args, **kwargs)
            out = {}
            with profiled(out, name):
                result = fn(self, *args, **kwargs)
            if name in out:
                profs[name].append(out[name])
            return result
        return call

    for name in LOOP_PROFILED:
        setattr(loop_closing.LoopCloser, name, spy(name))
    try:
        yield profs
    finally:
        for name, fn in fns.items():
            setattr(loop_closing.LoopCloser, name, fn)


def loop_path_inputs(seq, kidnap_seq):
    """One warm-up run of the ring survey on the card (the vocabulary's
    tables uploaded, every kernel of the path built), the loop closer's
    stages each under torch.profiler and the loop callers' K6 and K7 calls
    recorded; then the kidnap sequence with the vocabulary, eager
    (eager_forms), its BoW relocalization calls recorded (those with a
    candidate pair), and the
    survey's sim3_ransac and optimize_sim3 calls. -> (inputs: the first
    LOOP_RECORDED calls of each caller, the stages' profiles, the Sim3
    calls)."""
    calls, counts, profs, sim3_calls, solves = {}, {}, {}, ([], []), {}
    with loop_kernel_calls(counts, calls), loop_stages_profiled(profs), \
            sim3_recorded(*sim3_calls), loop_solves_recorded(solves):
        sys_, states, seconds, pre = run_loop(seq)
    remember("ring survey", "warm-up", sys_)
    with eager_forms(), loop_kernel_calls(counts, calls):
        kid, kid_states, _, _ = run_system(kidnap_seq, n_frames=MONO_FRAMES,
                                           vocabulary="default")
    remember("System monocular kidnap with the vocabulary", "warm-up", kid)
    log(f"ring survey warm-up: {seconds:.2f} s for {len(states)} frames (its loop stages "
        f"under the profiler), {sys_.map.next_kf} keyframes inserted, loops closed at "
        f"{[(s['kf'], s['loop_kf']) for s in sys_.loop_closer.correction_stats]} (frame "
        f"{pre.get('frame')}); kidnap with the vocabulary: states "
        f"{''.join(st[0] for st in kid_states)}; loop callers' K6/K7 calls: "
        f"{ {c: len(v) for c, v in calls.items()} }")
    calls["BoW relocalization"] = [a for a in calls["BoW relocalization"]
                                   if bool(k7_mask("valid_hamming_top2", a).any())]
    for caller in LOOP_CALLERS:
        if not calls[caller]:
            raise AssertionError(f"the warm-up runs made no {caller} call with a candidate")
    if set(solves) != {"global BA", "essential graph"}:
        raise AssertionError(f"the ring survey's warm-up recorded only {sorted(solves)}")
    return ({f"loop_{c}": v[:LOOP_RECORDED] for c, v in calls.items()}, profs, sim3_calls,
            solves)


@contextlib.contextmanager
def loop_solves_recorded(store):
    """store["global BA"] and store["essential graph"]: the arguments of
    the first bundle_adjust_jit call inside LoopCloser.run_global_ba and of
    the first optimize_sim3_graph_jit call (the essential graph)."""
    gba = loop_closing.LoopCloser.run_global_ba
    bundle, graph = ba.bundle_adjust_jit, pose_graph.optimize_sim3_graph_jit
    inside = []

    def run_global_ba(self, *args, **kwargs):
        inside.append(1)
        try:
            return gba(self, *args, **kwargs)
        finally:
            inside.pop()

    def bundle_adjust(*args, **kwargs):
        if inside:
            store.setdefault("global BA", (args, kwargs))
        return bundle(*args, **kwargs)

    def optimize_sim3_graph(*args, **kwargs):
        store.setdefault("essential graph", (args, kwargs))
        return graph(*args, **kwargs)

    loop_closing.LoopCloser.run_global_ba = run_global_ba
    ba.bundle_adjust_jit = bundle_adjust
    pose_graph.optimize_sim3_graph_jit = optimize_sim3_graph
    try:
        yield store
    finally:
        loop_closing.LoopCloser.run_global_ba = gba
        ba.bundle_adjust_jit = bundle
        pose_graph.optimize_sim3_graph_jit = graph


def solve_tensors(out):
    """The tensors of a solve's result, flattened in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in solve_tensors(o)]
    return []


def phase_solves_twice(solves):
    """Global BA and the essential graph of the ring survey's first loop
    closure, each solved twice on the card from its recorded problem
    through its single-dispatch form: the same bits (their sums over
    observations and edges add in a fixed order, optim/segment.py)."""
    fns = {"global BA": ba.bundle_adjust_jit,
           "essential graph": pose_graph.optimize_sim3_graph_jit}
    for name, fn in fns.items():
        args, kwargs = solves[name]
        outs = [solve_tensors(fn(*args, **kwargs)) for _ in range(2)]
        torch.cuda.synchronize()
        if len(outs[0]) != len(outs[1]) or not all(
                torch.equal(a, b) for a, b in zip(*outs)):
            raise AssertionError(f"{name} solved twice on one problem: the bits differ")
        problem = args[0]
        size = (f"{problem.R.shape[0]} cameras, {problem.points.shape[0]} points, "
                f"{problem.obs.cam_idx.shape[0]} observations" if name == "global BA" else
                f"{problem.s.shape[0]} vertices, {problem.edge_i.shape[0]} edges")
        log(f"{name} of the ring survey's loop closure ({size}) solved twice: "
            f"{len(outs[0])} result tensors bit-identical")


def loop_problems(x):
    """(caller, what, kernel, args) of the loop phase's phase-3 cases
    (kernel: "K6" or K7's form under the validity flags): every recorded
    call; K7's batched calls also with the first candidate emptied and
    with every row empty; compute_sim3's also as LOOP_STACKED candidates
    (every recorded call's, in turn) against the first call's keyframe
    table, as is and with the first candidate emptied; K6's also with every
    row invalid and with every column invalid."""
    for caller in LOOP_CALLERS:
        kernel = "K6" if caller in ("match_by_sim3", "loop match_fuse") else "valid_hamming_top2"
        recorded = x[f"loop_{caller}"]
        for i, args in enumerate(recorded):
            yield caller, f"{caller} call {i}", kernel, args
        args = recorded[0]
        if kernel != "K6":
            if k7_batch(kernel, args):
                yield caller, f"{caller} call 0, first problem empty", kernel, emptied(args)
            yield caller, f"{caller} call 0, every row empty", kernel, emptied(args, False)
            if caller == "compute_sim3":
                tables = [(b, k) for _, db_i, _, ok_i in recorded for b, k in zip(db_i, ok_i)]
                tables = [tables[i % len(tables)] for i in range(LOOP_STACKED)]
                stacked = (args[0], torch.stack([b for b, _ in tables]), args[2],
                           torch.stack([k for _, k in tables]))
                what = f"{caller}, {LOOP_STACKED} candidates of {len(recorded)} calls"
                yield caller, what, kernel, stacked
                yield caller, f"{what}, first candidate empty", kernel, emptied(stacked)
        else:
            rows, cols = list(args), list(args)
            rows[5] = torch.zeros_like(args[5])
            cols[9] = torch.zeros_like(args[9])
            yield caller, f"{caller} call 0, every row invalid", kernel, tuple(rows)
            yield caller, f"{caller} call 0, every column invalid", kernel, tuple(cols)


def phase_loop_kernels(x):
    """The loop callers' recorded K6 and K7 calls against the plain
    versions on the card (K7 also against K7 under its mask): all four
    outputs exact, and a second launch bit for bit the first."""
    for caller, what, kernel, args in loop_problems(x):
        if kernel != "K6":
            check_form(what, kernel, args)
            continue
        got = kmatching.projection_hamming_top2(*args)[0]
        again = kmatching.projection_hamming_top2(*args)[0]
        want = kmatching.projection_hamming_top2_plain(*args)[0]
        torch.cuda.synchronize()
        shape = (tuple(args[1].shape), tuple(args[6].shape))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{what}: the kernel differs from its plain version")
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            raise AssertionError(f"{what}: two launches differ")
        log(f"{what} {shape}: exact in all four outputs, two launches bit-identical "
            f"({int((got[0] < kmatching.BIG_DIST).sum())} of {got[0].numel()} rows with a "
            f"candidate)")


def loop_vs_cpu(sys_, sim3_runs):
    """The ring survey's card state against the CPU: every kept keyframe's
    word and node ids (exact), the database's loop and relocalization
    candidates against a CPU database built from the same descriptors
    (the same lists), and every sim3_ransac and optimize_sim3 call of the
    surveys in sim3_runs ({run: (ransac calls, optimize calls)}) on the
    CPU with the same inputs and sample sets (inlier masks equal; the
    transforms, where the RANSAC accepted one, within SIM3_TOL). Beside
    each LM's reading: float32's own spread on that call (the CPU's LM in
    float32 against float64) and the control (its initial transform, the
    RANSAC's, against the CPU's LM: the LM skipped), of which the largest
    must lie beyond the limit."""
    m, voc, db = sys_.map, sys_.vocabulary, sys_.kf_database
    kfs = [int(k) for k in np.where(m.kf_valid)[0]]
    for k in kfs:
        for a, b in zip(voc.transform(m.kf_desc[k], m.kf_feat_valid[k], device="cuda"),
                        voc.transform(m.kf_desc[k], m.kf_feat_valid[k], device="cpu")):
            if not np.array_equal(a, b):
                raise AssertionError(f"keyframe {k}: word or node ids differ card vs CPU")
    cpu_db = KeyFrameDatabase(voc, db.present.shape[0], device="cpu")
    cpu_db._ensure_cols(db.word_ids.shape[1])
    for k in kfs:
        cpu_db.add(k, m.kf_desc[k], m.kf_feat_valid[k])
    n_lists = n_cands = 0
    for k in kfs:
        for s in (0.0, 0.05):
            a = db.detect_loop_candidates(m, k, s)
            if a != cpu_db.detect_loop_candidates(m, k, s):
                raise AssertionError(f"keyframe {k}: loop candidates differ card vs CPU")
            n_lists, n_cands = n_lists + 1, n_cands + len(a)
        frame = types.SimpleNamespace(desc=m.kf_desc[k], valid=m.kf_feat_valid[k])
        a = db.detect_relocalization_candidates(frame)
        if a != cpu_db.detect_relocalization_candidates(frame):
            raise AssertionError(f"keyframe {k}: relocalization candidates differ card vs CPU")
        n_lists, n_cands = n_lists + 1, n_cands + len(a)
    log(f"ring survey card vs CPU: word and node ids of {len(kfs)} keyframes exact; "
        f"{n_lists} candidate lists ({n_cands} candidates) equal")

    def cpu(args, dtype=None):
        return tuple((a.cpu().to(dtype) if dtype and a.is_floating_point() else a.cpu())
                     if isinstance(a, torch.Tensor) else a for a in args)

    def gap(got, want):
        t_scale = max(1.0, float(want[2].abs().max()))
        return max(max_abs(got[0].cpu(), want[0]), max_abs(got[1].cpu(), want[1]),
                   max_abs(got[2].cpu(), want[2]) / t_scale)

    gaps = {"sim3_ransac": [], "optimize_sim3": []}
    spreads, controls, bad, lm_calls = [], [], [], []
    for run, (ransac_calls, opt_calls) in sim3_runs.items():
        calls = [("sim3_ransac", c) for c in ransac_calls] + \
            [("optimize_sim3", c) for c in opt_calls]
        for what, (args, kwargs, card) in calls:
            fn = sim3_solver.sim3_ransac if what == "sim3_ransac" else sim3_opt.optimize_sim3
            got = fn(*cpu(args), **kwargs)
            if not torch.equal(card.inliers.cpu(), got.inliers) or \
                    int(card.n_inliers) != int(got.n_inliers):
                bad.append(f"{run} {what}: inliers differ card vs CPU")
            if what == "sim3_ransac" and not bool(got.ok):
                continue
            want = (got.s12, got.R12, got.t12)
            gaps[what].append(gap((card.s12, card.R12, card.t12), want))
            if what == "optimize_sim3":
                got64 = fn(*cpu(args, torch.float64), **kwargs)
                spreads.append(gap(want, (got64.s12, got64.R12, got64.t12)))
                controls.append(gap(args[:3], want))
                lm_calls.append((gaps[what][-1], run, args, kwargs, card, got64))
        log(f"{run} survey's Sim3 calls card vs CPU: {len(ransac_calls)} sim3_ransac, "
            f"{len(opt_calls)} optimize_sim3")
    log(f"Sim3 card vs CPU (max |d| of s, R and t/max(1, |t|)): sim3_ransac "
        f"{[float(f'{g:.3g}') for g in gaps['sim3_ransac']]}, optimize_sim3 "
        f"{[float(f'{g:.3g}') for g in gaps['optimize_sim3']]}; float32's spread, the CPU's "
        f"LM in float32 vs float64: {[float(f'{g:.3g}') for g in spreads]}; the control, "
        f"each LM's initial transform vs the CPU's LM: {[float(f'{g:.3g}') for g in controls]}"
        f" (tolerances {SIM3_TOL})")
    sim3_float32_envelope(max(lm_calls, key=lambda c: c[0]), gap, cpu)
    for what, g in gaps.items():
        if not g or not max(g) < SIM3_TOL[what]:
            bad.append(f"{what}: card vs CPU {g} not under {SIM3_TOL[what]}")
    if not max(controls, default=0.0) > SIM3_TOL["optimize_sim3"]:
        bad.append(f"the LM skipped lands within {SIM3_TOL['optimize_sim3']} of the LM: "
                   f"{controls}")
    if bad:
        raise AssertionError("; ".join(bad))


SIM3_JITTERS = 8


def sim3_float32_envelope(call, gap, cpu):
    """The optimize_sim3 call that reads largest card vs CPU, against
    float32's own spread on it: the CPU's LM in float64 is the reference;
    the CPU's LM in float32 on the inputs as they are and on SIM3_JITTERS
    copies with every float input moved by up to one float32 ulp
    (relative 2^-23, seeded) gives the envelope of float32 solutions; the
    card's solution is printed against it. With CHIP_SMOKE_RECORD_DIR set,
    the call's inputs and both results are saved there (sim3_call.pt)."""
    reading, run, args, kwargs, card, got64 = call
    ref = (got64.s12, got64.R12, got64.t12)
    fn = sim3_opt.optimize_sim3
    base = cpu(args)
    envelope = []
    for seed in range(SIM3_JITTERS + 1):
        gen = torch.Generator().manual_seed(seed)
        moved = tuple(a * (1 + (torch.rand(a.shape, generator=gen, dtype=torch.float64)
                                * 2 - 1).to(a.dtype) * 2.0 ** -23)
                      if seed and isinstance(a, torch.Tensor) and a.is_floating_point() else a
                      for a in base)
        got = fn(*moved, **kwargs)
        envelope.append(gap((got.s12, got.R12, got.t12), ref))
    card_gap = gap((card.s12, card.R12, card.t12), ref)
    log(f"optimize_sim3 reading largest card vs CPU ({run} survey, {reading:.3g}): the card "
        f"vs the CPU's float64 LM {card_gap:.3g}; the CPU's float32 LM vs float64 "
        f"{envelope[0]:.3g}, over {SIM3_JITTERS} one-ulp jitters of its inputs "
        f"{min(envelope):.3g}-{max(envelope):.3g}: the card lies "
        f"{'inside' if card_gap <= max(envelope) else 'OUTSIDE'} float32's spread")
    record = os.environ.get("CHIP_SMOKE_RECORD_DIR")
    if record:
        os.makedirs(record, exist_ok=True)
        torch.save({"args": base, "kwargs": kwargs, "run": run,
                    "card": tuple(t.cpu() for t in (card.s12, card.R12, card.t12)),
                    "cpu64": tuple(t.cpu() for t in ref)},
                   os.path.join(record, "sim3_call.pt"))


@contextlib.contextmanager
def sim3_recorded(ransac_calls, opt_calls):
    """Record (args, kwargs, result) of every sim3_ransac and optimize_sim3
    call the loop closer makes (through their single-dispatch forms)."""
    fns = (sim3_solver.sim3_ransac_jit, sim3_opt.optimize_sim3_jit)

    def spy(fn, out):
        def call(*args, **kwargs):
            res = fn(*args, **kwargs)
            out.append((args, kwargs, res))
            return res
        return call

    sim3_solver.sim3_ransac_jit = spy(fns[0], ransac_calls)
    sim3_opt.optimize_sim3_jit = spy(fns[1], opt_calls)
    try:
        yield
    finally:
        sim3_solver.sim3_ransac_jit, sim3_opt.optimize_sim3_jit = fns


def phase_loop(seq, kidnap_seq, profs, warm_sim3, power):
    """The ring survey on the card, the launch counts reset just before and
    read just after it (the loop path's forms' calls recorded for
    phase_loop_graphs): the four gates of tests/test_loop_pipeline.py,
    every kernel of the monocular path launched and K6 and K7 by each loop
    caller; frames/s and the loop stages' times; the card against the CPU;
    the warm-up's profiles of the loop stages. Then the kidnap sequence with the
    vocabulary, counted the same way: relocalized through the database's
    candidates. -> (launches by loop caller over both runs, their stage
    timings)."""
    what = "ring survey"
    _, _, poses = seq
    gt_c = centres(poses)
    by_caller, ransac_calls, opt_calls, at_close = {}, [], [], []
    _build.reset_launches()
    caps = cuda_graph.n_captures()
    with loop_kernel_calls(by_caller), sim3_recorded(ransac_calls, opt_calls), \
            staged_recording(what, LOOP_UNIT_FORMS, LOOP_RECORDED_CALLS):
        sys_, states, seconds, pre = run_loop(
            seq, on_close=lambda: at_close.append(len(opt_calls)))
    c = dict(_build.launches)
    remember(what, "counted", sys_)
    with eager_forms():
        eager_sys, _, eager_seconds, _ = run_loop(seq)
    remember(what, "eager", eager_sys)
    check_same_bits(what)
    stages = {}
    for kind, s_, secs in (("replayed", sys_, seconds), ("eager", eager_sys, eager_seconds)):
        t = s_.timings()
        stages[kind] = (round(len(states) / secs, 2),
                        [round(s["correct_s"], 4) for s in s_.loop_closer.correction_stats],
                        *(round(t[k]["total_s"] * 1e3, 1) if k in t else None
                          for k in ("loop_essential_graph", "loop_gba")))
    log(f"{what}, replayed against eager (frames/s, correct_loop s, essential graph ms, "
        f"global BA ms): {stages}, on {power}; the replayed run captured "
        f"{cuda_graph.n_captures() - caps} graphs (its loop closure's among them)")
    log(f"{what} launches: {c}; K6/K7 by loop caller: {by_caller}")
    if [k for k in SYSTEM_LAUNCHED if c[k] < 1] or [k for k in SYSTEM_UNUSED if c[k]] \
            or c["stereo_band_top2"] or min(by_caller[k] for k in LOOP_CALLERS[:3]) < 1:
        raise AssertionError(f"{what}: a kernel of the path or a loop caller's did not "
                             f"launch, or one off the path did")
    prefix, final, span = loop_gates(what, sys_, states, pre, gt_c)
    closer = sys_.loop_closer
    timings = sys_.timings()
    n_kf = int(timings["loop_closing"]["count"])
    log(f"{what}: {len(states)} frames, {sys_.map.next_kf} keyframes inserted "
        f"({sys_.map.n_keyframes()} kept), {closer.n_loops_closed} loop(s) closed "
        f"{[(s['kf'], s['loop_kf']) for s in closer.correction_stats]} at frame "
        f"{pre['frame']}, loop edges {sys_.map.loop_edges}; scale-aligned ATE before the "
        f"correction {pre['ate']:.6f}, of that prefix after it {prefix:.6f}, final "
        f"{final:.6f} over a {span:.3f} span (gate {LOOP_ATE_SPAN} x span)")
    log(f"{what}: {len(states) / seconds:.2f} frames/s over the sequence ({seconds:.3f} s) on "
        f"{power}; correct_loop {[round(s['correct_s'], 4) for s in closer.correction_stats]} "
        f"s; {n_kf} keyframes through loop_closing")
    for stage, st in sorted(timings.items()):
        log(f"    {what} stage {stage}: {int(st['count'])} x {st['mean_ms']:.3f} ms "
            f"(max {st['max_ms']:.3f}, total {st['total_s'] * 1e3:.1f} ms)")
    for stage in LOOP_PROFILED:
        p = profs.get(stage, [])
        if p:
            wall, busy, n_ops = (float(np.mean([v[j] for v in p])) for j in range(3))
            log(f"profiled {stage} ({len(p)} calls in the warm-up run): mean {wall:.3f} ms "
                f"wall, {busy:.3f} ms device busy, idle share {1.0 - busy / wall:.4f}, "
                f"{n_ops:.0f} device operations, on {power}")
    if not at_close or not at_close[0]:
        raise AssertionError(f"{what}: correct_loop never ran, or with no optimize_sim3")
    loop_vs_cpu(sys_, {"warm-up": warm_sim3, "counted": (ransac_calls, opt_calls)})

    # vocabulary.transform of one keyframe's descriptors: device busy and
    # synced wall per call.
    m = sys_.map
    k = int(np.where(m.kf_valid)[0][-1])
    desc, valid = m.kf_desc[k], m.kf_feat_valid[k]

    def transform():
        return sys_.vocabulary.transform(desc, valid, device="cuda")

    busy, by_name = device_busy_ms(transform, 20)
    t0 = time.perf_counter()
    for _ in range(20):
        transform()
    log(f"vocabulary.transform of keyframe {k}'s {int(valid.sum())} descriptors "
        f"({sys_.vocabulary.levels} levels, k = {sys_.vocabulary.k}): "
        f"{(time.perf_counter() - t0) / 20 * 1e3:.3f} ms synced wall, {busy:.4f} ms device "
        f"busy per call, on {power}")

    what = "System monocular kidnap with the vocabulary"
    kid_caller = {}
    _build.reset_launches()
    with loop_kernel_calls(kid_caller):
        kid, kid_states, kid_seconds, _ = run_system(kidnap_seq, n_frames=MONO_FRAMES,
                                                     vocabulary="default")
    remember(what, "counted", kid)
    check_same_bits(what)
    tr = kid.tracker
    kt = kid.timings()
    log(f"{what} launches: {dict(_build.launches)}; K6/K7 by loop caller: {kid_caller}; "
        f"states {''.join(st[0] for st in kid_states)}; relocalized at frame "
        f"{tr.last_reloc_frame_id} against keyframe {tr.ref_kf}; "
        + ", ".join(f"{s} {int(kt[s]['count'])} x {kt[s]['mean_ms']:.3f} ms "
                    f"(max {kt[s]['max_ms']:.3f})"
                    for s in ("track_reloc", "reloc_bow", "reloc_match", "reloc_epnp",
                              "loop_closing") if s in kt) + f", on {power}")
    if "LOST" not in kid_states[KIDNAP.start:KIDNAP.stop] or kid_states[-1] != "OK" \
            or tr.last_reloc_frame_id < KIDNAP.stop or kid_caller["BoW relocalization"] < 1:
        raise AssertionError(f"{what}: not lost during the occlusion, or not relocalized "
                             f"after it through the database's candidates")
    for k in LOOP_CALLERS:
        by_caller[k] += kid_caller[k]
    return by_caller


# ---------------------------------------------------------------------------
# The localization-only mode, the asynchronous System, the global BA runner
# ---------------------------------------------------------------------------

def localization_sequence():
    """(config, images [LOC_FRAMES, H, W], depth maps, ground-truth poses)
    of the RGB-D survey along the ring survey's path, at full width."""
    config = synthetic_config(WIDTH, HEIGHT, N_FEATURES, sensor="rgbd")
    rng = np.random.default_rng(LOOP_SCENE["seed"])
    scene = synthetic.ring_scene(rng, n_points=900, center=np.array([2.0, 0.0, 0.0]),
                                 radius_range=(7.0, 9.0))
    poses = synthetic.loop_trajectory(LOOP_SCENE["n_frames"], radius=2.0,
                                      frac=LOOP_SCENE["frac"])[:LOC_FRAMES]
    rendered = [synthetic.render(scene, R, t, config.camera, with_depth=True, max_depth=12.0)
                for R, t in poses]
    return (config, np.stack([r[0] for r in rendered]), np.stack([r[1] for r in rendered]),
            poses)


def map_sizes(m):
    return m.n_keyframes(), m.n_points(), m.next_pt


def localizer(config, path, device):
    """A System with the map saved at path loaded, in the localization-only
    mode."""
    sys_ = System(config, async_mapping=False, device=device)
    sys_.load_map(path)
    sys_.activate_localization_mode()
    return sys_


def localized_run(seq, path, prof=None):
    """A new card System localizing against the saved map over frames
    LOC_FIRST to LOC_FRAMES - 1 (under a device-only profile into prof
    where given), then its shutdown -> (system, frames, seconds,
    (captures, replays, the live pools' bytes at the run's end)); none of
    its graphs left after the shutdown."""
    config, images, depths, _ = seq
    sys_ = localizer(config, path, "cuda")
    keys, caps, reps = set(cuda_graph.graphs), cuda_graph.n_captures(), cuda_graph.n_replays()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiled(prof, "run", device_only=True) if prof is not None \
            else contextlib.nullcontext():
        for i in range(LOC_FIRST, LOC_FRAMES):
            sys_.track_rgbd(images[i], depths[i], i / config.camera.fps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    graphs = (cuda_graph.n_captures() - caps, cuda_graph.n_replays() - reps,
              sum(g.pool_bytes for g in cuda_graph.graphs.values()))
    sys_.shutdown()
    left = [k for k in cuda_graph.graphs if k not in keys]
    if left:
        raise AssertionError(f"localization session: {len(left)} of its graphs left after "
                             f"shutdown")
    return sys_, LOC_FRAMES - LOC_FIRST, seconds, graphs


def phase_localization(seq, power):
    """The localization session on the card (see LOC_MAPPED), the launch
    counts reset just before the localized frames and read just after
    them, with its gates, the staged forms' calls recorded
    (STAGED_RECORDED); then its first frames on the CPU; then the session
    eager and replayed in turns (staged_turns), each run bit for bit the
    counted one. -> launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        return _localization(seq, power, tmp)


def _localization(seq, power, tmp):
    what = "localization session"
    config, images, depths, gt = seq
    mapper, states, _, seconds = run_system(seq, n_frames=LOC_MAPPED, vocabulary="default")
    if any(st != "OK" for st in states):
        raise AssertionError(f"{what}: mapping states {states}")
    path = os.path.join(tmp, "map.npz")
    mapper.save_map(path)
    loc = {device: localizer(config, path, device) for device in ("cuda", "cpu")}
    card = loc["cuda"]
    loaded = map_sizes(card.map)
    spawned = []
    spawn = card.tracker._spawn_temporal_vo_points

    def spawn_counted():
        spawn()
        spawned.append(int(card.tracker._temporal_points.size))

    card.tracker._spawn_temporal_vo_points = spawn_counted
    frames = range(LOC_FIRST, LOC_FRAMES)
    poses, vo = [], []
    _build.reset_launches()
    t0 = time.perf_counter()
    with staged_recording(what):
        for i in frames:
            poses.append(card.track_rgbd(images[i], depths[i], i / config.camera.fps))
            vo.append(bool(card.tracker.vo_only))
            if map_sizes(card.map) != loaded or card.tracker._temporal_points.size:
                raise AssertionError(f"{what}, frame {i}: the map changed "
                                     f"({map_sizes(card.map)} against {loaded} loaded) or "
                                     f"temporal points were left")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = dict(_build.launches)
    remember(what, "counted", card)
    tracked = [i for i, p in zip(frames, poses) if p is not None]
    vo_frames = [i for i, v in zip(frames, vo) if v]
    est = card.trajectory_positions()
    lost = np.asarray([e.lost for e in card.tracker.trajectory], bool)
    gt_c = centres(gt)[LOC_FIRST:]
    gt_c = gt_c[len(gt_c) - len(est):]
    rmse = trajectory.ate_rmse(est[~lost], gt_c[~lost], align_scale=False)
    span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    log(f"{what}: a map of frames 0-{LOC_MAPPED - 1} ({loaded[0]} keyframes, {loaded[1]} "
        f"points) loaded on the card; frames {LOC_FIRST}-{LOC_FRAMES - 1}: {len(tracked)} "
        f"tracked, in VO {vo_frames}, temporal points spawned {spawned}; the map unchanged "
        f"after every frame; ATE {rmse:.6f} over a {span:.3f} m span (gate {ATE_SPAN_GATE} x "
        f"span); {len(frames) / seconds:.2f} frames/s on {power}; launches {c}")
    if len(tracked) < LOC_MIN_TRACKED or not vo_frames or not any(spawned):
        raise AssertionError(f"{what}: too few frames tracked, none in VO or no temporal point")
    if not rmse < ATE_SPAN_GATE * span:
        raise AssertionError(f"{what}: ATE {rmse} over the gate")
    if [k for k in ("level_preprocess", "combine_nms", "cell_topk_map", "describe_patches",
                    "projection_hamming_top2", "pose_lm") if c[k] < 1] or \
            [k for k in SYSTEM_UNUSED if c[k]]:
        raise AssertionError(f"{what}: a kernel of the staged path did not launch, or one "
                             f"off the path did")
    cpu = loc["cpu"]
    worst = (0.0, 0.0)
    for k, i in enumerate(frames[:LOC_CPU_FRAMES]):
        want = cpu.track_rgbd(images[i], depths[i], i / config.camera.fps)
        if (want is None) != (poses[k] is None) or bool(cpu.tracker.vo_only) != vo[k]:
            raise AssertionError(f"{what}, frame {i}: card and CPU differ in state or VO")
        if want is not None:
            d = (rot_angle_deg(want[0], poses[k][0]),
                 float(np.linalg.norm(want[1] - poses[k][1])))
            worst = tuple(max(a, b) for a, b in zip(worst, d))
    log(f"{what}, frames {LOC_FIRST}-{LOC_FIRST + LOC_CPU_FRAMES - 1} card vs cpu: poses "
        f"within rot {worst[0]:.5f} deg, |dt| {worst[1]:.6f}")
    if not (worst[0] < ROT_DEG_TOL and worst[1] < T_TOL):
        raise AssertionError(f"{what}: card and CPU poses differ beyond the bounds")
    card.shutdown()
    staged_turns(what, lambda prof: localized_run(seq, path, prof),
                 ("extract_frame", "track", "track_reloc", "reloc_bow", "reloc_match",
                  "reloc_epnp"), power, ("level_preprocess", "projection_hamming_top2",
                                         "pose_lm"))
    return c


def background_threads_done(what, sys_):
    """After shutdown: the mapping worker and the global BA runner have
    ended and raised nothing."""
    w = sys_.mapping_worker
    gba = sys_.loop_closer.gba_runner if sys_.loop_closer is not None else None
    if w.thread.is_alive() or w.error is not None or (
            gba is not None and (gba.running or gba.error is not None)):
        raise AssertionError(f"{what}: a background thread is alive or failed")


def phase_async(seq, sync_fps, power):
    """The 30-frame RGB-D sequence through an asynchronous System (the
    bundled vocabulary, mapping and loop closing on the worker's thread and
    stream), then shutdown, the launch counts reset just before and read
    just after: every frame OK, the ATE gate, keyframes mapped, the threads
    ended with no error, the path's kernels launched. -> launch counts."""
    what = "System RGB-D asynchronous"
    _, _, _, gt = seq
    _build.reset_launches()
    sys_, states, poses, seconds = run_system(seq, vocabulary="default", async_mapping=True)
    c = dict(_build.launches)
    w = sys_.mapping_worker
    background_threads_done(what, sys_)
    if any(st != "OK" for st in states) or any(p is None for p in poses) or w.processed < 1:
        raise AssertionError(f"{what}: states {states}, {w.processed} keyframes mapped")
    want = [k for k in SYSTEM_LAUNCHED if k != "valid_hamming_top2"]
    if [k for k in want if c[k] < 1] or [k for k in SYSTEM_UNUSED if c[k]]:
        raise AssertionError(f"{what}: a kernel of the path did not launch, or one off the "
                             f"path did")
    gt_c = centres(gt)
    rmse = trajectory.ate_rmse(sys_.trajectory_positions(), gt_c, align_scale=False)
    span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    log(f"{what}: {SYSTEM_FRAMES} frames all OK, {sys_.map.next_kf} keyframes inserted "
        f"({sys_.map.n_keyframes()} kept), {w.processed} mapped on the worker ({local_bas(sys_)} "
        f"local BAs), {w.dropped} dropped; ATE {rmse:.6f} m over a {span:.3f} m span (gate {ATE_SPAN_GATE} x span); "
        f"{SYSTEM_FRAMES / seconds:.2f} frames/s to the end of shutdown (synchronous: "
        f"{sync_fps:.2f}), on {power}; launches {c}")
    if not rmse < ATE_SPAN_GATE * span:
        raise AssertionError(f"{what}: ATE {rmse} over the gate")
    return c


def local_bas(sys_):
    """How many local BAs the System's mapper ran (skipped while keyframes
    wait)."""
    return int(sys_.timings().get("map_lba", {}).get("count", 0))


def phase_gba_stress(seq, power):
    """tests/test_async_pipeline.py's stress at full width: the monocular
    sweep through an asynchronous System with the bundled vocabulary, every
    global BA held until released and relaunched every GBA_EVERY frames
    once the map has GBA_MIN_KFS keyframes; release, shutdown. Gates: >= 2
    launches, >= 1 relaunch over a run in flight, every launch (and every
    launch by a loop closure) merged or aborted, none running, OK at the
    end, the scale-aligned ATE gate. -> launch counts."""
    what = "global BA runner under tracking"
    config, images, _, gt = seq
    sys_ = System(config, async_mapping=True, device="cuda")
    gba = sys_.loop_closer.gba_runner
    gate = threading.Event()
    run = gba._run

    def gated_run(m, anchor_kf, n_iters, gen):
        gate.wait(timeout=120.0)
        return run(m, anchor_kf, n_iters, gen)

    gba._run = gated_run
    launched = relaunched = 0
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        for i in range(MONO_FRAMES):
            sys_.track_monocular(images[i], i / config.camera.fps)
            if sys_.map.n_keyframes() >= GBA_MIN_KFS and i % GBA_EVERY == 0:
                relaunched += gba.running
                gba.launch(sys_.map, anchor_kf=0)
                launched += 1
    finally:
        gate.set()
    sys_.shutdown()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    c = dict(_build.launches)
    background_threads_done(what, sys_)
    by_closer = len(sys_.loop_closer.correction_stats)
    est = sys_.trajectory_positions()
    lost = np.asarray([e.lost for e in sys_.tracker.trajectory], bool)
    gt_c = centres(gt)[MONO_FRAMES - len(est):]
    rmse = trajectory.ate_rmse(est[~lost], gt_c[~lost], align_scale=True)
    span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    log(f"{what}: {launched} launches ({relaunched} over a run in flight) and {by_closer} by "
        f"loop closures, {gba.n_merged} merged, {gba.n_aborted} aborted; state "
        f"{sys_.tracking_state().name}, {sys_.map.n_keyframes()} keyframes, "
        f"{sys_.mapping_worker.processed} mapped ({local_bas(sys_)} local BAs), "
        f"{sys_.mapping_worker.dropped} dropped; scale-aligned ATE {rmse:.6f} over a {span:.3f} m span (gate {GBA_ATE_GATE} x span); "
        f"{MONO_FRAMES / seconds:.2f} frames/s on {power}; launches {c}")
    if launched < 2 or relaunched < 1 or gba.n_merged + gba.n_aborted != launched + by_closer:
        raise AssertionError(f"{what}: launches and merges or aborts do not add up")
    if sys_.tracking_state().name != "OK" or not rmse < GBA_ATE_GATE * span:
        raise AssertionError(f"{what}: state {sys_.tracking_state().name}, ATE {rmse}")
    return c


def phase_async_timing(seq, power):
    """The RGB-D System asynchronous and synchronous in turns
    (ASYNC_TURNS each, the same process): frames/s to the end of shutdown
    and the tracker thread's ms per frame (each track_rgbd call); then one
    run of each under torch.profiler: device busy and idle share over the
    run (busy summed over both streams)."""
    rows = {True: [], False: []}
    for _ in range(ASYNC_TURNS):
        for async_mapping in (True, False):
            track_s = []
            sys_, _, _, seconds = run_system(seq, vocabulary="default",
                                             async_mapping=async_mapping, track_s=track_s)
            rows[async_mapping].append((SYSTEM_FRAMES / seconds, 1e3 * float(np.mean(track_s)),
                                        1e3 * float(np.max(track_s)), sys_.map.next_kf,
                                        local_bas(sys_)))
    profs = {}
    for async_mapping in (True, False):
        with profiled(profs, async_mapping):
            run_system(seq, vocabulary="default", async_mapping=async_mapping)
    for async_mapping in (True, False):
        name = "asynchronous" if async_mapping else "synchronous"
        if async_mapping not in profs:
            raise AssertionError(f"System RGB-D {name}: the profiler recorded no device "
                                 f"operation over a whole run")
        wall, busy, n_ops = profs[async_mapping]
        log(f"System RGB-D {name}, in turns: frames/s "
            f"{[round(r[0], 2) for r in rows[async_mapping]]}, tracker thread ms per frame "
            f"mean {[round(r[1], 3) for r in rows[async_mapping]]} max "
            f"{[round(r[2], 3) for r in rows[async_mapping]]}, keyframes "
            f"{[r[3] for r in rows[async_mapping]]}, local BAs {[r[4] for r in rows[async_mapping]]}"
            f"; one run under torch.profiler: {wall:.1f} "
            f"ms wall, {busy:.1f} ms device busy, idle share {1.0 - busy / wall:.4f}, {n_ops} "
            f"device operations, on {power}")


# ---------------------------------------------------------------------------
# The datasets phase: the System run from files on disk by the port's driver
# (examples/run_dataset.py), at the published settings of the reference's
# Examples/*.yaml
# ---------------------------------------------------------------------------

class DatasetCell(NamedTuple):
    mode: str           # the driver's mode
    args: tuple         # its arguments after the mode, before the out prefix
    poses: list         # ground-truth (R_cw, t_cw) per frame
    config: object      # the settings' SLAMConfig
    gate: float         # ATE gate, x the path's span
    align_scale: bool   # monocular: the ATE after a similarity alignment


def stamps(n, fps):
    return [i / fps for i in range(n)]


def write_kitti_cell(root):
    """KITTI 00-02 stereo: the first DATASET_FRAMES frames of the drive, and
    a copy of its first DATASET_VS_CPU frames -> (cell, that copy's cell)."""
    cfg = kitti_00_02_config()
    frames, poses, _ = synthetic.drive_frames(cfg.camera, photo=synthetic.CAMERA_PHOTO,
                                              **KITTI_DRIVE)
    n = DATASET_FRAMES["kitti_00-02_stereo"]
    lefts, rights = [], []
    for _, left, right in frames():
        lefts.append(left)
        rights.append(right)
        if len(lefts) == n:
            break
    yaml = mini_dataset.write_settings_yaml(os.path.join(root, "KITTI00-02.yaml"), cfg)
    ts = stamps(n, cfg.camera.fps)
    cells = []
    for name, k in (("kitti", n), ("kitti_first", DATASET_VS_CPU["kitti_00-02_stereo"])):
        seq = mini_dataset.write_kitti(os.path.join(root, name), lefts[:k], ts[:k], rights[:k])
        cells.append(DatasetCell("kitti-stereo", (seq, yaml), poses[:k], cfg,
                                 DATASET_GATES["kitti_00-02_stereo"], False))
    return cells


def write_tum_rgbd_cell(root):
    """TUM fr1 RGB-D: the RGB-D System's scene through TUM1's lens, depth
    as 16-bit PNGs at DepthMapFactor 5000, and a copy of its first
    DATASET_VS_CPU frames -> (cell, that copy's cell)."""
    cfg = tum_fr1_config("rgbd")
    n = DATASET_FRAMES["tum_fr1_rgbd"]
    images, poses, _, depths = synthetic.render_sequence(cfg.camera, n_frames=n,
                                                         with_depth=True, **SYSTEM_SCENE)
    yaml = mini_dataset.write_settings_yaml(os.path.join(root, "TUM1_rgbd.yaml"), cfg,
                                            depth_map_factor=cfg.camera.depth_map_factor)
    cells = []
    for name, k in (("tum_rgbd", n), ("tum_rgbd_first", DATASET_VS_CPU["tum_fr1_rgbd"])):
        seq = os.path.join(root, name)
        assoc = mini_dataset.write_tum_rgbd(seq, images[:k], depths[:k],
                                            stamps(k, cfg.camera.fps),
                                            depth_map_factor=cfg.camera.depth_map_factor)
        cells.append(DatasetCell("tum-rgbd", (seq, assoc, yaml), poses[:k], cfg,
                                 DATASET_GATES["tum_fr1_rgbd"], False))
    return cells


def write_euroc_cell(root):
    """EuRoC stereo: raw pairs through the published cameras (K, D) and
    sub-degree mounting rotations, as tests/test_dataset_drivers.py renders
    them; the settings' LEFT.* / RIGHT.* blocks (R from those rotations)
    for the driver's rectification."""
    cfg = euroc_stereo_config()
    n = DATASET_FRAMES["euroc_stereo"]
    b = cfg.camera.baseline
    raw = {side: dataclasses.replace(cfg.camera, fx=k[0], fy=k[1], cx=k[2], cy=k[3],
                                     k1=d[0], k2=d[1], p1=d[2], p2=d[3], k3=d[4])
           for side, (k, d) in EUROC_RAW_CAMERAS.items()}
    mounts = {side: synthetic.mount_rotation(**{a: np.radians(v) for a, v in m.items()})
              for side, m in EUROC_MOUNTS.items()}
    scene = synthetic.make_scene(np.random.default_rng(EUROC_SCENE["seed"]),
                                 n_points=EUROC_SCENE["n_points"])
    poses = synthetic.look_ahead_trajectory(n, step=EUROC_SCENE["step"])
    images = {"LEFT": [], "RIGHT": []}
    for R, t in poses:
        for side, shift in (("LEFT", 0.0), ("RIGHT", b)):
            C = -R.T @ (t - np.array([shift, 0.0, 0.0]))
            Rm = mounts[side] @ R
            images[side].append(synthetic.render(scene, Rm, -Rm @ C, raw[side]))
    seq = mini_dataset.write_euroc(os.path.join(root, "euroc"), images["LEFT"],
                                   stamps(n, cfg.camera.fps), rights=images["RIGHT"])
    yaml = mini_dataset.write_settings_yaml(os.path.join(root, "EuRoC.yaml"), cfg)
    K = {side: np.array([[c.fx, 0, c.cx], [0, c.fy, c.cy], [0, 0, 1.0]])
         for side, c in raw.items()}
    D = {side: np.array(d) for side, (_, d) in EUROC_RAW_CAMERAS.items()}
    P = np.array([[cfg.camera.fx, 0, cfg.camera.cx, 0], [0, cfg.camera.fy, cfg.camera.cy, 0],
                  [0, 0, 1.0, 0]])
    P_r = P.copy()
    P_r[0, 3] = -cfg.camera.bf
    # The raw cameras were rendered with x_raw = mount @ x_rect: R = mount^T.
    mini_dataset.append_euroc_stereo_blocks(yaml, K["LEFT"], D["LEFT"], mounts["LEFT"].T, P,
                                            K["RIGHT"], D["RIGHT"], mounts["RIGHT"].T, P_r)
    return DatasetCell("euroc-stereo", (seq, yaml), poses, cfg, DATASET_GATES["euroc_stereo"],
                       False)


def write_tum_mono_cell(root):
    """TUM fr1 monocular: the monocular sweep through TUM1's lens."""
    cfg = tum_fr1_config("monocular")
    n = DATASET_FRAMES["tum_fr1_mono"]
    images, poses, _ = synthetic.render_sequence(cfg.camera, n_frames=n, **MONO_SCENE)
    seq = mini_dataset.write_tum_mono(os.path.join(root, "tum_mono"), images,
                                      stamps(n, cfg.camera.fps))
    yaml = mini_dataset.write_settings_yaml(os.path.join(root, "TUM1_mono.yaml"), cfg)
    return DatasetCell("tum-mono", (seq, yaml), poses, cfg, DATASET_GATES["tum_fr1_mono"], True)


def write_datasets(root):
    """The four cells' mini datasets under root (the port's writers) ->
    ({name: cell}, {name: the cell's first frames as a cell of their own}
    for the DATASET_VS_CPU cells)."""
    t0 = time.perf_counter()
    kitti, kitti_first = write_kitti_cell(root)
    tum_rgbd, tum_rgbd_first = write_tum_rgbd_cell(root)
    cells = {"kitti_00-02_stereo": kitti, "tum_fr1_rgbd": tum_rgbd,
             "euroc_stereo": write_euroc_cell(root), "tum_fr1_mono": write_tum_mono_cell(root)}
    log(f"datasets: {', '.join(f'{k} ({len(c.poses)} frames)' for k, c in cells.items())} "
        f"rendered and written in {time.perf_counter() - t0:.1f} s")
    return cells, {"kitti_00-02_stereo": kitti_first, "tum_fr1_rgbd": tum_rgbd_first}


def run_cell(cell, out, *flags):
    """The port's driver on a cell, as a user runs it -> its DatasetRun."""
    run = run_dataset.run([cell.mode, *cell.args, out, *flags])
    if run is None:
        raise AssertionError(f"the driver refused {cell.mode} {cell.args}")
    if run.system.device.type == "cuda":
        torch.cuda.synchronize()
    return run


def cell_ate(cell, run):
    """The ATE of the run's exported trajectory against the renderer's
    ground truth, frames matched by timestamp -> (rmse, span)."""
    ts, est = mini_dataset.load_tum_trajectory(run.out + "_tum.txt")
    gt = centres(cell.poses)[np.round(ts * cell.config.camera.fps).astype(int)]
    rmse = trajectory.ate_rmse(est, gt, align_scale=cell.align_scale)
    return rmse, float(np.linalg.norm(gt[-1] - gt[0]))


def kept_calls(calls):
    """One run's recorded calls ({kernel: [(args, kwargs)]}) -> {kernel:
    [args]}, K8's kept to the SYSTEM_RECORDED with the most observations
    and K7 under the window's to the 2 with the most columns."""
    out = {name: [args for args, _ in c] for name, c in calls.items() if c}
    if "pose_lm" in out:
        out["pose_lm"] = sorted(out["pose_lm"],
                                key=lambda a: -a[3].valid.shape[0])[:SYSTEM_RECORDED]
    if "window_hamming_top2" in out:
        out["window_hamming_top2"] = sorted(out["window_hamming_top2"],
                                            key=lambda a: -a[1].shape[-2])[:2]
    return out


def phase_dataset_kernels(d, errs):
    """Phase 3 at the dataset paths' shapes: each kernel against its plain
    version on every call kept from each cell's first --sync run, from
    the KITTI cell's kitti-mono run (phase_datasets) and from the online
    phase's AR run (d: {run: (config, calls)}), exact where phase_kernels
    is exact; errs (the kernels' largest errors) updated."""
    for cell, (cfg, calls) in d.items():
        where = f"{cell} ({cfg.camera.width}x{cfg.camera.height}, {cfg.orb.n_features} features)"
        for image, th_hi, th_lo in calls.get("level_preprocess", ()):
            got = level.level_preprocess(image, th_hi, th_lo)
            padded, hp, wp = level.pad_level(image)
            want = level.level_preprocess_plain(padded, hp, wp, th_hi, th_lo)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K1 differs on {where}, canvas {tuple(image.shape)}")
            log(f"K1 level_preprocess, {where}, canvas {tuple(image.shape)} -> "
                f"3x{tuple(got[0].shape)}: exact")
        for hi, lo, bounds in calls.get("combine_nms", ()):
            got = level.combine_nms(hi, lo, bounds)
            want = level.combine_nms_plain(hi, lo, bounds)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K2 differs on {where}: {max_abs(got, want)}")
            log(f"K2 combine_nms, {where}, maps {tuple(hi.shape)}: exact "
                f"({int((got > 0).sum())} maxima)")
        for m, c, k in calls.get("cell_topk_map", ()):
            gv, ga = select.cell_topk_map(m, c, k)
            wv, wa = select.cell_topk_map_plain(m, c, k)
            torch.cuda.synchronize()
            if not (torch.equal(gv, wv) and torch.equal(ga, wa)):
                raise AssertionError(f"K3 map form differs on {where}")
            log(f"K3 cell_topk_map, {where}, score map {tuple(m.shape)}, cell {c}, k={k}: "
                f"exact")
        for c, b, yx, _ in calls.get("describe_patches", ()):
            errs["describe_patches"] = max(errs["describe_patches"],
                                           check_describe(where, c, b, yx))
        for i, args in enumerate(calls.get("projection_hamming_top2", ())):
            check_k6(f"{where} call {i}", args)
        for i, args in enumerate(calls.get("stereo_band_top2", ())):
            if args[0].shape[0] < cfg.orb.n_features - 50:
                raise AssertionError(f"K7 band got {args[0].shape[0]} rows on {where}")
            check_band(f"{where} pair {i}", args)
        for form in ("valid_hamming_top2", "epipolar_hamming_top2", "window_hamming_top2"):
            for i, args in enumerate(calls.get(form, ())):
                check_form(f"{where} call {i}", form, args)
        for i, args in enumerate(calls.get("pose_lm", ())):
            errs["pose_lm"] = max(errs["pose_lm"], check_k8(f"{where} frame, call {i}", args))


def check_dataset_run(name, cell, run, counts, power, what):
    """One driver run held to its cell's gates: every frame OK after the
    first OK, the ATE gate, >= 2 keyframes, every kernel of the path
    launched and none off it (counts) -> (rmse, span)."""
    sensor = run.system.config.sensor
    states = [s.name for s in run.states]
    first = states.index("OK") if "OK" in states else len(states)
    if first == len(states) or any(s != "OK" for s in states[first:]):
        raise AssertionError(f"{name} {what}: states {states}")
    want = DATASET_LAUNCHED + (("stereo_band_top2",) if sensor == "stereo" else ()) + (
        ("window_hamming_top2",) if sensor == "monocular" else ())
    if [k for k in want if counts[k] < 1] or [k for k in SYSTEM_UNUSED if counts[k]]:
        raise AssertionError(f"{name} {what}: a kernel of the path did not launch, or one "
                             f"off the path did: {counts}")
    m = run.system.map
    if m.next_kf < 2:
        raise AssertionError(f"{name} {what}: {m.next_kf} keyframes")
    rmse, span = cell_ate(cell, run)
    n = len(run.track_s)
    seconds = sum(run.track_s) + run.shutdown_s
    ordered = np.sort(run.track_s)
    remap = (f", rectification {np.mean(run.remap_s) * 1e3:.3f} ms a pair"
             if run.remap_s else "")
    log(f"{name} {what}: {n} frames, OK from frame {first}, {m.next_kf} keyframes "
        f"({m.n_keyframes()} kept), {m.n_points()} points; ATE {rmse:.6f} m over a "
        f"{span:.3f} m span (gate {cell.gate} x span = {cell.gate * span:.6f}); tracking "
        f"median {ordered[n // 2] * 1e3:.3f} ms, mean {np.mean(run.track_s) * 1e3:.3f} ms; "
        f"{n / seconds:.2f} frames/s to the end of shutdown; PNG read "
        f"{np.mean(run.read_s) * 1e3:.3f} ms a frame{remap}; on {power}")
    if not rmse < cell.gate * span:
        raise AssertionError(f"{name} {what}: ATE {rmse} over the gate {cell.gate * span}")
    return rmse, span


def dataset_vs_cpu(name, cell, root, power):
    """A cell's first frames through the driver on the card and on the CPU
    (the card's route, fused, forced there), every tracked Frame recorded:
    the same frames tracked and the same keyframes, frame and keyframe
    poses within ROT_DEG_TOL / T_TOL; over all frames, the valid features
    held (valid flag and octave equal, raw keypoints within XY_TOL) all but
    FEATURE_FLIP_TOL of them, and on those the undistorted keypoints
    (Frame.xy: the staged extraction's and the fused stages'
    undistortion) within UNDIST_XY_TOL."""
    runs, frames, seconds = {}, {}, {}
    for device in ("cuda", "cpu"):
        calls = []
        flags = ("--sync",) if device == "cuda" else ("--sync", "--device=cpu")
        with recording(System, "_track_frame", calls), (
                env_set(ORB_TPU_FUSED_TRACK="1") if device == "cpu" else contextlib.nullcontext()):
            t0 = time.perf_counter()
            runs[device] = run_cell(cell, os.path.join(root, f"out_{name}_first_{device}"),
                                    *flags)
            seconds[device] = time.perf_counter() - t0
        frames[device] = [args[1] for args, _ in calls]
    n = len(cell.poses)
    card, cpu = runs["cuda"].system, runs["cpu"].system
    a, b = card._resolve_trajectory(), cpu._resolve_trajectory()
    if [e[0] for e in a] != [e[0] for e in b] or len(a) != n:
        raise AssertionError(f"{name} first frames: card frames {[e[0] for e in a]}, "
                             f"cpu {[e[0] for e in b]}")
    worst = [max(rot_angle_deg(x[1], y[1]) for x, y in zip(a, b)),
             max(float(np.linalg.norm(centres([x[1:]])[0] - centres([y[1:]])[0]))
                 for x, y in zip(a, b))]
    cm, pm = card.map, cpu.map
    if cm.kf_frame_id[:cm.next_kf].tolist() != pm.kf_frame_id[:pm.next_kf].tolist():
        raise AssertionError(f"{name} first frames: the card's and the CPU's keyframes differ")
    for k in range(cm.next_kf):
        worst[0] = max(worst[0], rot_angle_deg(cm.kf_pose_R[k], pm.kf_pose_R[k]))
        worst[1] = max(worst[1], float(np.linalg.norm(cm.kf_pose_t[k] - pm.kf_pose_t[k])))
    if len(frames["cuda"]) != n or len(frames["cpu"]) != n:
        raise AssertionError(f"{name} first frames: {len(frames['cuda'])} frames tracked on "
                             f"the card, {len(frames['cpu'])} on the CPU")
    flips = same = far = 0
    d_raw = d_xy = d_far = moved = 0.0
    for f, g in zip(frames["cuda"], frames["cpu"]):
        agree = (f.valid == g.valid) & (f.octave == g.octave)
        both = agree & g.valid
        flips += int((~agree & (f.valid | g.valid)).sum())
        raw = np.abs(f.xy_raw[both] - g.xy_raw[both]).max(axis=1)
        close = raw <= XY_TOL
        far += int((~close).sum())
        same += int(close.sum())
        d_raw = max(d_raw, float(raw[close].max(initial=0.0)))
        d_far = max(d_far, float(raw.max(initial=0.0)))
        d_xy = max(d_xy, float(np.abs(f.xy[both][close] - g.xy[both][close]).max(initial=0.0)))
        moved = max(moved, float(np.abs(g.xy[both] - g.xy_raw[both]).max(initial=0.0)))
    log(f"{name}, first {n} frames card ({power}) vs cpu ({seconds['cpu']:.1f} s on the CPU, "
        f"{seconds['cuda']:.1f} s on the card): keyframes {cm.kf_frame_id[:cm.next_kf].tolist()} "
        f"equal, frame and keyframe poses within rot {worst[0]:.5f} deg, |dt| {worst[1]:.6f}; "
        f"features: {flips} with a valid flag or octave that differs, {far} keypoints apart "
        f"by more than {XY_TOL} px (up to {d_far:.3g} px), {same} held: raw keypoints max|d| "
        f"{d_raw:.3g} px, "
        f"undistorted (Frame.xy) max|d| {d_xy:.3g} px, the undistortion moving them by up to "
        f"{moved:.3f} px")
    if not (worst[0] < ROT_DEG_TOL and worst[1] < T_TOL):
        raise AssertionError(f"{name}: the card's and the CPU's poses differ beyond the bounds")
    if flips + far > FEATURE_FLIP_TOL * (same + far + flips) or not d_xy <= UNDIST_XY_TOL:
        raise AssertionError(f"{name}: the card's and the CPU's keypoints differ")


def phase_datasets(root, cells, firsts, power):
    """Each cell through the port's driver on the card, twice with --sync,
    the launch counts reset just before and read just after each run and
    the kernels' inputs recorded in the first (DATASET_RECORDED): the
    cell's gates (check_dataset_run) and the two runs' trajectory files
    equal byte for byte; the KITTI cell once more the way a user runs it
    (asynchronous, the bundled vocabulary), under the same ATE gate; the
    DATASET_VS_CPU cells' first frames on the card and on the CPU
    (dataset_vs_cpu); the KITTI cell's first frames through kitti-mono, its
    launches counted and K7 under the initialization's window recorded.
    -> (launch counts per cell (its first run), the kitti-mono run's,
    {run: (config, its kept calls)} for phase_dataset_kernels)."""
    counts, recorded = {}, {}
    for name, cell in cells.items():
        outs = []
        for r in range(2):
            out = os.path.join(root, f"out_{name}_{r}")
            calls = {k: [] for k in DATASET_RECORDED}
            with contextlib.ExitStack() as stack:
                if r == 0:
                    for k, (module, keep) in DATASET_RECORDED.items():
                        stack.enter_context(recording(module, k, calls[k], keep))
                _build.reset_launches()
                run = run_cell(cell, out, "--sync")
                c = dict(_build.launches)
            if r == 0:
                counts[name] = c
                recorded[name] = (cell.config, kept_calls(calls))
            log(f"{name} run {r} launches: {c}")
            check_dataset_run(name, cell, run, c, power, f"run {r} (--sync)")
            outs.append(out)
        for suffix in DATASET_FILES:
            a, b = (open(o + suffix, "rb").read() for o in outs)
            if a != b:
                raise AssertionError(f"{name}: the two --sync runs' {suffix} differ")
        log(f"{name}: the two --sync runs' trajectory files are equal byte for byte")

    name, cell = "kitti_00-02_stereo", cells["kitti_00-02_stereo"]
    _build.reset_launches()
    run = run_cell(cell, os.path.join(root, "out_kitti_async"))
    c = dict(_build.launches)
    if run.system.mapping_worker is None:
        raise AssertionError("the driver's default System maps on the tracking thread")
    background_threads_done(f"{name} asynchronous", run.system)
    check_dataset_run(name, cell, run, c, power, "asynchronous (the driver's default)")
    log(f"{name} asynchronous: the tracker's ms a frame, mean "
        f"{np.mean(run.track_s) * 1e3:.3f}, max {max(run.track_s) * 1e3:.3f}; "
        f"{run.system.mapping_worker.processed} keyframes mapped on the worker, on {power}; "
        f"launches {c}")

    for name, first in firsts.items():
        dataset_vs_cpu(name, first, root, power)

    first = firsts["kitti_00-02_stereo"]
    mono = first._replace(mode="kitti-mono",
                          config=dataclasses.replace(first.config, sensor="monocular"))
    calls = {"window_hamming_top2": []}
    with recording(kmatching, "window_hamming_top2", calls["window_hamming_top2"]):
        _build.reset_launches()
        run_cell(mono, os.path.join(root, "out_kitti_mono"), "--sync", "--no-vocab")
        mono_counts = dict(_build.launches)
    recorded["kitti-mono"] = (mono.config, kept_calls(calls))
    win = recorded["kitti-mono"][1].get("window_hamming_top2", [])
    if not win or win[0][1].shape[-2] < K7_WINDOW_MIN_COLUMNS:
        raise AssertionError(f"K7's window got {[a[1].shape[-2] for a in win]} columns on the "
                             f"KITTI initialization")
    log(f"kitti-mono, the KITTI cell's first {len(first.poses)} frames: launches {mono_counts}")
    if not mono_counts["window_hamming_top2"]:
        raise AssertionError("kitti-mono: K7 under the initialization's window never launched")
    return counts, mono_counts, recorded


# ---------------------------------------------------------------------------
# The online phase: the System fed live (examples/run_live.py) over the
# wire, with the drop policy and the viewer thread, and AR anchoring
# (examples/run_ar.py), on the card
# ---------------------------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def publisher(items, port, rate=None):
    """A thread that connects to the subscriber on the loopback port (as
    soon as it listens) and publishes items with run_live.publish_frames,
    item i at i / rate seconds after connecting when rate is given, then
    closes the connection (the end of the stream)."""
    errors = []

    def serve():
        try:
            deadline = time.time() + 120.0
            while True:
                try:
                    sock = socket.create_connection(("127.0.0.1", port), timeout=5.0)
                    break
                except ConnectionRefusedError:
                    if time.time() > deadline:
                        raise
                    time.sleep(0.002)
            with sock:
                t0 = time.time()
                for i, item in enumerate(items):
                    if rate is not None:
                        wait = t0 + i / rate - time.time()
                        if wait > 0:
                            time.sleep(wait)
                    run_live.publish_frames(sock, [item])
        except Exception as e:   # handed to the caller, which raises it
            errors.append(e)

    thread = threading.Thread(target=serve, name="publisher", daemon=True)
    thread.start()
    return thread, errors


def live_over_wire(items, config, rate=None, device="cuda", **kw):
    """items published over loopback TCP (paced at rate frames/s, or as
    fast as they go) into a SocketSource that run_live consumes ->
    its LiveRun."""
    port = free_port()
    thread, errors = publisher(items, port, rate)
    run = run_live.run_live(run_live.SocketSource(port=port, listen=True), config,
                            device=device, **kw)
    thread.join(timeout=60.0)
    if errors or thread.is_alive():
        raise AssertionError(f"the publisher failed: {errors or 'still running'}")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return run


def phase_online_wire(seqs, power, device="cuda"):
    """(a) Each of phase 4's synchronous System sequences (RGB-D, stereo)
    published over loopback TCP and tracked by run_live with no drops, the
    launch counts reset just before and read just after: all 30 frames in
    and tracked; every image and depth map or right image the System's
    stages got equal bit for bit to the sequence's (the arrays a direct
    track_rgbd / track_stereo call gets); the run's trajectory, keyframes
    and map bit-identical to phase 4's direct runs in this process; the
    path's kernels launched. -> launch counts per sensor."""
    counts = {}
    for sensor in ("rgbd", "stereo"):
        seq = seqs[sensor]
        config, first, second, _ = seq
        items = [(i / config.camera.fps, first[i], second[i]) for i in range(SYSTEM_FRAMES)]
        entry = "_track" if sensor == "rgbd" else "_track_stereo"
        seen = []
        with recording(System, entry, seen):
            _build.reset_launches()
            run = live_over_wire(items, config, device=device, drop_when_behind=False)
            c = counts[sensor] = dict(_build.launches)
        what = system_name(sensor)
        if (run.n_in, run.n_tracked, run.n_dropped) != (SYSTEM_FRAMES, SYSTEM_FRAMES, 0):
            raise AssertionError(f"{what} over the wire: {run.n_in} in, {run.n_tracked} "
                                 f"tracked, {run.n_dropped} dropped")
        for i, (args, kwargs) in enumerate(seen):
            if sensor == "rgbd":
                image, ts, aux = args[1], args[2], kwargs["depth"]
            else:
                image, aux, ts = args[1:4]
            if ts != items[i][0] or any(a.dtype != b.dtype or not np.array_equal(a, b)
                                        for a, b in ((image, first[i]), (aux, second[i]))):
                raise AssertionError(f"{what} over the wire: frame {i}'s arrays differ from "
                                     f"the direct feed's")
        if len(seen) != SYSTEM_FRAMES:
            raise AssertionError(f"{what} over the wire: {len(seen)} frames reached the System")
        remember(what, "over the wire", run.system)
        check_same_bits(what)
        want = SYSTEM_LAUNCHED + (("stereo_band_top2",) if sensor == "stereo" else ())
        if [k for k in want if c[k] < 1] or [k for k in SYSTEM_UNUSED if c[k]]:
            raise AssertionError(f"{what} over the wire: a kernel of the path did not "
                                 f"launch, or one off the path did: {c}")
        log(f"{what} over loopback TCP (run_live, no drops): {run.n_in} frames in, "
            f"{run.n_tracked} tracked, every image and "
            f"{'depth map' if sensor == 'rgbd' else 'right image'} equal bit for bit to the "
            f"direct feed's ({first.dtype}, {second.dtype}); {run.n_in / run.seconds:.2f} "
            f"frames/s to the end of shutdown, on {power}; launches {c}")
    return counts


def trace_busy_ms(log_dir):
    """The one Chrome trace device_trace wrote into log_dir -> (its size in
    bytes, the card's busy ms: the union of its kernels', copies' and
    sets' intervals over every stream, device operations)."""
    names = [f for f in os.listdir(log_dir) if f.startswith("trace_")]
    if len(names) != 1:
        raise AssertionError(f"device_trace wrote {names} into {log_dir}")
    path = os.path.join(log_dir, names[0])
    size = os.path.getsize(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0.0)) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return size, busy / 1e3, len(spans)


def check_live_run(what, run, gt, rate, stream_dir):
    """One live run's gates -> (ATE, span, tracked ms mean, median)."""
    if run.n_in != SYSTEM_FRAMES or run.n_in != len(run.fed_ts) + run.n_dropped:
        raise AssertionError(f"{what}: {run.n_in} frames in, {len(run.fed_ts)} fed, "
                             f"{run.n_dropped} dropped")
    if any(b <= a for a, b in zip(run.fed_ts, run.fed_ts[1:])):
        raise AssertionError(f"{what}: tracked timestamps not increasing: {run.fed_ts}")
    background_threads_done(what, run.system)
    tracked = [(ts, p) for ts, p in zip(run.fed_ts, run.poses) if p is not None]
    if len(tracked) < 3:
        raise AssertionError(f"{what}: {len(tracked)} frames tracked")
    est = centres([p for _, p in tracked])
    gt_c = centres(gt)[[int(round(ts * rate)) for ts, _ in tracked]]
    rmse = trajectory.ate_rmse(est, gt_c, align_scale=False)
    span = float(np.linalg.norm(gt_c[-1] - gt_c[0]))
    if not rmse < ATE_SPAN_GATE * span:
        m = run.system.map
        raise AssertionError(
            f"{what}: ATE {rmse} over the gate {ATE_SPAN_GATE * span}; frames fed "
            f"{[int(round(ts * rate)) for ts in run.fed_ts]}, states {run.states}, keyframes' "
            f"frames {m.kf_frame_id[:m.next_kf].tolist()}, tracked centres' errors "
            f"{np.round(np.linalg.norm(est - gt_c, axis=1), 4).tolist()}")
    v = run.viewer
    if v is not None:
        if v.n_errors:
            raise AssertionError(f"{what}: {v.n_errors} render errors, the last "
                                 f"{v.last_error!r}")
        pngs = sorted(os.listdir(stream_dir))
        if not pngs or v.n_rendered < 1:
            raise AssertionError(f"{what}: {v.n_rendered} renders, {len(pngs)} PNG files")
        cam = run.system.config.camera
        for name in pngs:
            image = read_png(os.path.join(stream_dir, name))
            if image.shape != (cam.height, cam.width, 3) or image.dtype != np.uint8:
                raise AssertionError(f"{what}: {name} reads back as {image.dtype} "
                                     f"{image.shape}")
    ms = 1e3 * np.asarray([s for s, p in zip(run.track_s, run.poses) if p is not None])
    return rmse, span, float(ms.mean()), float(np.median(ms))


@contextlib.contextmanager
def triangulating(count):
    """count[0] += 1 for each keyframe the mapper triangulates from
    (jit_mapper.fused_triangulation_jit, which runs the matcher that K7
    under the epipolar band serves): a keyframe with no neighbour past the
    baseline, or with every feature already bound to a point (an RGB-D
    keyframe's depth makes points of them), triangulates nothing. The
    worker thread's calls are counted too."""
    fn = jit_mapper.fused_triangulation_jit

    def spy(*args, **kwargs):
        count[0] += 1
        return fn(*args, **kwargs)

    jit_mapper.fused_triangulation_jit = spy
    try:
        yield
    finally:
        jit_mapper.fused_triangulation_jit = fn


def phase_online_live(seq, power, root, device="cuda"):
    """(b) The RGB-D sequence published at each of LIVE_RATES frames/s,
    paced, ts = i / rate, into run_live with the drop policy, through the
    default asynchronous System (the bundled vocabulary), the viewer off
    and on (LIVE_VIEWER, in turns: run_live's ViewerLoop, at the stream's
    rate, streaming PNGs), each run inside its own device_trace with the
    launch counts reset just before and read just after it: check_live_run's
    gates, the trace active and not empty, every kernel of the path
    launched (K7 under the epipolar band where the mapper triangulated).
    -> the launch counts summed over the runs."""
    config, first, second, gt = seq
    config = dataclasses.replace(config, system=dataclasses.replace(config.system,
                                                                   async_mapping=True))
    total = {k: 0 for k in _build.launches}
    rows = {}
    for rate in LIVE_RATES:
        items = [(i / rate, first[i], second[i]) for i in range(SYSTEM_FRAMES)]
        for turn, viewer_on in enumerate(LIVE_VIEWER):
            what = f"live RGB-D at {rate:g} frames/s, viewer {'on' if viewer_on else 'off'}"
            trace_dir = os.path.join(root, f"trace_{rate:g}_{turn}")
            stream_dir = os.path.join(root, f"stream_{rate:g}_{turn}")
            os.makedirs(stream_dir)
            tri = [0]
            with device_trace(trace_dir) as active, triangulating(tri):
                _build.reset_launches()
                run = live_over_wire(items, config, rate, device, fps=rate,
                                     viewer_dir=stream_dir if viewer_on else None)
                c = dict(_build.launches)
            if not active:
                raise AssertionError(f"{what}: device_trace was not active")
            size, busy, n_ops = trace_busy_ms(trace_dir)
            if not size or not n_ops:
                raise AssertionError(f"{what}: the trace holds {n_ops} device operations "
                                     f"({size} bytes)")
            # Which frames the drop policy lets through decides whether a
            # mapped keyframe has anything to triangulate.
            want = [k for k in SYSTEM_LAUNCHED if k != "valid_hamming_top2"
                    and (k != "epipolar_hamming_top2" or tri[0])]
            if [k for k in want if c[k] < 1] or [k for k in SYSTEM_UNUSED if c[k]]:
                raise AssertionError(f"{what}: a kernel of the path did not launch, or one "
                                     f"off the path did: {c} ({tri[0]} triangulations)")
            rmse, span, mean_ms, median_ms = check_live_run(what, run, gt, rate, stream_dir)
            for k, v in c.items():
                total[k] += v
            idle = 1.0 - busy / (run.seconds * 1e3)
            w = run.system.mapping_worker
            rows.setdefault((rate, viewer_on), []).append(
                (run.n_dropped, mean_ms, median_ms, idle))
            renders = ""
            if run.viewer is not None:
                vt = run.viewer.timings.summary()
                renders = (f", {run.viewer.n_rendered} renders ({run.viewer.n_errors} "
                           f"errors, {len(os.listdir(stream_dir))} PNGs read back as [H, W, 3] "
                           f"uint8), a render's ms (mean, max): " + ", ".join(
                               f"{k} {vt[k]['mean_ms']:.2f} {vt[k]['max_ms']:.2f}"
                               for k in ("lock_wait", "draw", "png") if k in vt))
            log(f"{what} (turn {turn}): {run.n_in} frames in, {run.n_tracked} tracked, "
                f"{run.n_dropped} dropped ({run.n_dropped / run.n_in:.3f}); the tracker's "
                f"ms a tracked frame mean {mean_ms:.3f}, median {median_ms:.3f}; states "
                f"{sorted(set(run.states))}; {run.system.map.next_kf} keyframes, "
                f"{w.processed} mapped on the worker, {w.dropped} dropped{renders}; ATE "
                f"{rmse:.6f} m over a {span:.3f} m span (gate {ATE_SPAN_GATE} x span); "
                f"{run.seconds:.3f} s to the end of shutdown; {tri[0]} triangulations; "
                f"device_trace {size} bytes, "
                f"{n_ops} device operations, {busy:.1f} ms busy, idle share {idle:.4f}; "
                f"on {power}; launches {c}")
    for (rate, viewer_on), r in rows.items():
        log(f"live RGB-D at {rate:g} frames/s, viewer {'on' if viewer_on else 'off'}, "
            f"in turns: dropped {[x[0] for x in r]} of {SYSTEM_FRAMES}, tracker ms a tracked "
            f"frame mean {[round(x[1], 3) for x in r]} median {[round(x[2], 3) for x in r]}, "
            f"idle share {[round(x[3], 4) for x in r]}, on {power}")
    return total


def angle_deg(a, b):
    """The angle between two directions, up to sign, in degrees (atan2 of
    the cross and dot products: exact near 0, where arccos is not)."""
    a, b = (np.asarray(v, np.float64) / np.linalg.norm(v) for v in (a, b))
    return float(np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b)), abs(a @ b))))


def ar_normal_error_deg(run):
    """The anchored plane's normal against the scene's ground plane, in
    degrees, up to sign, after the similarity alignment (Umeyama) of the
    run's trajectory to the ground truth."""
    est = run.system.trajectory_positions()
    lost = np.asarray([e.lost for e in run.system.tracker.trajectory], bool)
    gt_c = centres(run.poses_gt)[len(run.poses_gt) - len(est):]
    _, R, _ = trajectory.umeyama_alignment(est[~lost], gt_c[~lost])
    return angle_deg(R @ run.anchor.Twp[:3, 2], AR_GROUND)


def fit_card_vs_cpu(what, pts, valid, device="cuda"):
    """fit_plane_ransac on the points on the card and on the CPU, on the
    same AR_ITERS sample sets: the same best hypothesis, normals within
    AR_FIT_RAD (up to sign), inlier flags equal but for points within
    AR_FLAG_BAND x scale of the threshold -> a line to log."""
    pts = torch.from_numpy(np.ascontiguousarray(pts, np.float32))
    valid = torch.from_numpy(np.array(valid, bool))
    idx = ar.sample_indices(len(pts), AR_ITERS, torch.Generator().manual_seed(7))
    card = ar.fit_plane_ransac(pts.to(device), valid.to(device), idx=idx)
    cpu = ar.fit_plane_ransac(pts, valid, idx=idx)
    n_card, n_cpu = card.normal.cpu().double().numpy(), cpu.normal.double().numpy()
    rad = np.radians(angle_deg(n_card, n_cpu))
    th = float(cpu.threshold)
    dist = np.abs(pts.double().numpy() @ n_cpu + float(cpu.offset))
    differ = card.inliers.cpu().numpy() != cpu.inliers.numpy()
    near = np.abs(dist - th) <= AR_FLAG_BAND * th / 0.02
    line = (f"fit_plane_ransac card vs CPU on {what} ({int(valid.sum())} valid of "
            f"{len(pts)} points, {AR_ITERS} sample sets): best hypothesis {int(card.best)} / "
            f"{int(cpu.best)}, normals {rad:.3g} rad apart, threshold "
            f"{float(card.threshold):.6g} / {th:.6g}, inliers {int(card.n_inliers)} / "
            f"{int(cpu.n_inliers)}, {int(differ.sum())} flags differ "
            f"({int((differ & near).sum())} within {AR_FLAG_BAND} x scale of the threshold)")
    if int(card.best) != int(cpu.best) or not rad < AR_FIT_RAD or (differ & ~near).any():
        raise AssertionError(line)
    return line


def phase_online_ar(power, root, device="cuda"):
    """(c) run_ar's path (examples/run_ar.run at its defaults) with the
    launch counts reset just before and read just after it and the
    kernels' calls recorded (DATASET_RECORDED; held to their plain versions
    by phase_dataset_kernels): the cube anchored and overlaid on at least
    AR_OVERLAID_CPU - 2 frames, every PNG an [H, W, 3] uint8 image,
    fit_card_vs_cpu on the final map's point table (as ARAnchor takes it)
    and on its valid points alone; the monocular path's kernels launched;
    the anchored normal's angle to the ground plane printed.
    -> (launch counts, (config, kept calls))."""
    calls = {k: [] for k in DATASET_RECORDED}
    with contextlib.ExitStack() as stack:
        for k, (module, keep) in DATASET_RECORDED.items():
            stack.enter_context(recording(module, k, calls[k], keep))
        _build.reset_launches()
        t0 = time.perf_counter()
        run = run_ar.run(out_dir=os.path.join(root, "ar"), device=device)
        seconds = time.perf_counter() - t0
        c = dict(_build.launches)
    n = len(run.overlaid)
    overlaid = [i for i, o in enumerate(run.overlaid) if o]
    if run.anchor.Twp is None or len(overlaid) < AR_OVERLAID_CPU - 2:
        raise AssertionError(f"AR: the cube overlaid on frames {overlaid}")
    for path in run.pngs:
        image = read_png(path)
        if image.shape != (300, 400, 3) or image.dtype != np.uint8:
            raise AssertionError(f"AR: {path} reads back as {image.dtype} {image.shape}")
    err = ar_normal_error_deg(run)
    if [k for k in MONO_LAUNCHED if c[k] < 1] or [k for k in SYSTEM_UNUSED if c[k]]:
        raise AssertionError(f"AR: a kernel of the path did not launch, or one off the path "
                             f"did: {c}")
    log(f"AR (run_ar, {n} frames at 400x300, 1000 features): the cube overlaid on "
        f"{len(overlaid)} frames ({overlaid[0]}-{overlaid[-1]}; the CPU run: "
        f"{AR_OVERLAID_CPU}), size {run.anchor.size:.4f}; the anchored normal "
        f"{err:.4f} deg from the ground plane after the similarity alignment; "
        f"{run.system.map.n_keyframes()} keyframes, {run.system.map.n_points()} points; "
        f"{n / seconds:.2f} frames/s with the overlay and the PNGs, on {power}; launches {c}")
    m = run.system.map
    log(fit_card_vs_cpu("the final map's point table, as ARAnchor takes it", m.pt_pos,
                        m.pt_valid, device))
    log(fit_card_vs_cpu("the final map's valid points", m.pt_pos[m.pt_valid],
                        np.ones(int(m.pt_valid.sum()), bool), device))
    return c, (run.system.config, kept_calls(calls))


def phase_online_cli(seqs, power, root, flags=()):
    """(d) The port's online entry points by their command lines, each in
    a subprocess on the card, the five at once (TMPDIR under root), with
    `flags` appended:
    the live driver on the synthetic stream (--sim), listening for the
    RGB-D sequence that this process publishes over loopback TCP (--listen,
    the settings YAML written by utils/mini_dataset), and watching a
    directory of the sequence's frames as 8-bit PNGs (--watch, monocular);
    the AR demo; the synthetic monocular demo. Each must exit 0 and print
    its result line."""
    config, first, second, _ = seqs["rgbd"]
    yaml = mini_dataset.write_settings_yaml(os.path.join(root, "live.yaml"), config)
    watch = os.path.join(root, "watch")
    os.makedirs(watch)
    for i in range(SYSTEM_FRAMES):
        write_png(os.path.join(watch, f"{i:06d}.png"),
                  np.clip(np.round(first[i]), 0, 255).astype(np.uint8))
    port = free_port()
    live = "orb_slam2_commit_tpu_torch.examples.run_live"
    runs = [
        ([live, "--sim", "--frames", str(CLI_FRAMES)], f"stream done: {CLI_FRAMES} frames in",
         None),
        ([live, "--listen", str(port), "--settings", yaml, "--sensor", "rgbd"],
         f"stream done: {SYSTEM_FRAMES} frames in",
         [(i / config.camera.fps, first[i], second[i]) for i in range(SYSTEM_FRAMES)]),
        ([live, "--watch", watch, "--settings", yaml], f"stream done: {SYSTEM_FRAMES} frames in",
         None),
        (["orb_slam2_commit_tpu_torch.examples.run_ar", "24", "--out",
          os.path.join(root, "ar_cli")], "total", None),
        (["orb_slam2_commit_tpu_torch.examples.run_synthetic_mono", "40"], "ATE RMSE", None),
    ]
    env = dict(os.environ, TMPDIR=root)
    started = []
    for i, (args, want, items) in enumerate(runs):
        thread, errors = publisher(items, port) if items else (None, [])
        started.append((args, want, thread, errors, time.perf_counter(),
                        started_process([sys.executable, "-m", *args, *flags], env,
                                        os.path.join(root, f"cli{i}"))))
    bad = []
    for args, want, thread, errors, t0, proc in started:
        stdout, stderr = finished(proc)
        if thread is not None:
            thread.join(timeout=60.0)
        done = [line for line in stdout.splitlines() if line.startswith(want)]
        log(f"python -m {' '.join(args)}: exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s (the five at once), on {power}: {done}")
        if proc.returncode != 0 or not done or errors:
            bad.append(f"{args[0]} failed ({errors}): {stderr[-2000:]}")
    if bad:
        raise AssertionError("; ".join(bad))


def phase_online(seqs, power, device="cuda"):
    """The online phase, (a)-(d) -> ({path: launch counts}, the AR run's
    (config, kept calls))."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_online_") as root:
        wire = phase_online_wire(seqs, power, device)
        live = phase_online_live(seqs["rgbd"], power, root, device)
        ar_counts, ar_calls = phase_online_ar(power, root, device)
        phase_online_cli(seqs, power, root,
                         () if torch.device(device).type == "cuda" else ("--device=cpu",))
    log(f"online phase: {time.perf_counter() - t0:.1f} s")
    return {"RGB-D over the wire": wire["rgbd"], "stereo over the wire": wire["stereo"],
            "live RGB-D runs": live, "AR": ar_counts}, ar_calls


# ---------------------------------------------------------------------------
# The map-scale phase
# ---------------------------------------------------------------------------

def real_map():
    """The real map snapshot, loaded by the port's models/serialization,
    its capacities and contents checked."""
    m = serialization.load_map(REAL_MAP)
    sizes = ((m.cfg.max_keyframes, m.cfg.max_points), (m.n_keyframes(), int(m.pt_valid.sum())))
    if any(got != REAL_MAP_SIZE for got in sizes):
        raise AssertionError(f"{REAL_MAP}: capacities and contents {sizes}, "
                             f"not {REAL_MAP_SIZE}")
    return m


def map_poses(m):
    """(keyframe ids, centres [K, 3], rotations, points) of a map."""
    kfs = np.where(m.kf_valid)[0]
    R, t = m.kf_pose_R[kfs], m.kf_pose_t[kfs]
    return kfs, -np.einsum("kba,kb->ka", R, t), R, m.pt_pos[m.pt_valid]


def real_map_gba(route, device, profile=None, eager=False):
    """run_global_ba(anchor_kf=0, n_iters=5) on a fresh copy of the real
    map with ORB_DISTRIBUTED_GBA=route ("eager": "0" with the early-exit
    BA, eager_forms; eager=True: the route's early-exit form) on `device`
    -> (the map, wall s, LM iterations: those the early-exit form took, or
    the device-loop form's replays); under torch.profiler into
    profile["gba"] when given."""
    eager = eager or route == "eager"
    m = real_map()
    closer = loop_closing.LoopCloser(synthetic_config(**REAL_MAP_CONFIG), m, None,
                                     device=device)
    solve, iters = ba._solve_step, [0]

    def counted(*args, **kwargs):
        iters[0] += 1
        return solve(*args, **kwargs)

    before = os.environ.get("ORB_DISTRIBUTED_GBA")
    os.environ["ORB_DISTRIBUTED_GBA"] = "0" if route == "eager" else route
    replays = cuda_graph.n_replays()
    graphed = not eager and torch.device(device).type == "cuda"
    if not graphed:
        ba._solve_step = counted
    try:
        with (profiled(profile, "gba") if profile is not None else contextlib.nullcontext()), \
                (eager_forms() if eager else contextlib.nullcontext()):
            t0 = time.perf_counter()
            closer.run_global_ba(anchor_kf=0, n_iters=REAL_MAP_GBA_ITERS)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        ba._solve_step = solve
        if before is None:
            os.environ.pop("ORB_DISTRIBUTED_GBA", None)
        else:
            os.environ["ORB_DISTRIBUTED_GBA"] = before
    # The device-loop form (plain, or sharded with its all-reduces in the
    # graphs): one replay for the initial cost, one an LM iteration.
    return m, wall, cuda_graph.n_replays() - replays - 1 if graphed else iters[0]


def real_map_point_sharded(device):
    """The point-sharded solve (distributed_bundle_adjust_points, which the
    loop closer does not take) on the problem run_global_ba builds from the
    real map, over the world of one route "1" joined, and the plain
    bundle_adjust on the same problem, each twice in turns -> (bits equal,
    plain s, point-sharded s, each of its second run)."""
    m, cfg = real_map(), synthetic_config(**REAL_MAP_CONFIG)
    kfs = np.where(m.kf_valid)[0]
    problem = tracking.build_ba_problem(
        m, free_kfs=kfs[kfs != 0], fixed_kfs=np.asarray([0]),
        point_ids=np.where(m.pt_valid)[0], orb_cfg=cfg.orb, device=device).problem
    cam = interop.camera_params(cfg)

    def timed(solve, *args, **kwargs):
        t0 = time.perf_counter()
        out, _ = solve(*args, **kwargs)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    part, _ = dba.partition_problem(problem, 1)
    plain, runs = [], []
    for _ in range(2):
        plain.append(timed(ba.bundle_adjust, problem, *cam, n_iters=REAL_MAP_GBA_ITERS,
                           point_chunk=1024))
        runs.append(timed(dba.distributed_bundle_adjust_points, part,
                          multihost.global_group(), *cam, n_iters=REAL_MAP_GBA_ITERS))
    P = problem.points.shape[0]
    same = all(torch.equal(a.R, out.R) and torch.equal(a.t, out.t)
               and torch.equal(a.points, out.points[:P])
               for a, _ in plain for out, _ in runs)
    return same, plain[1][1], runs[1][1]


def real_map_float64():
    """The same global BA on the CPU in float64 (the problem run_global_ba
    builds, its floats widened) -> the map written back."""
    m = real_map()
    kfs = np.where(m.kf_valid)[0]
    cfg = synthetic_config(**REAL_MAP_CONFIG)
    assembled = tracking.build_ba_problem(
        m, free_kfs=kfs[kfs != 0], fixed_kfs=np.asarray([0]),
        point_ids=np.where(m.pt_valid)[0], orb_cfg=cfg.orb, device="cpu")
    wide = ba.BAProblem(*(a.double() if a.is_floating_point() else a
                          for a in assembled.problem[:5]),
                        obs=type(assembled.problem.obs)(*(
                            a.double() if a.is_floating_point() else a
                            for a in assembled.problem.obs)))
    out, res = ba.bundle_adjust(wide, *interop.camera_params(cfg),
                                n_iters=REAL_MAP_GBA_ITERS, point_chunk=1024)
    tracking.write_back_ba(m, assembled, out, res, erase_outliers=False)
    return m


def pose_gap(a, b):
    """(largest keyframe centre distance, largest rotation angle in deg,
    largest point distance) between two maps."""
    _, ca, Ra, pa = map_poses(a)
    _, cb, Rb, pb = map_poses(b)
    return (float(np.linalg.norm(ca - cb, axis=1).max()),
            max(rot_angle_deg(x, y) for x, y in zip(Ra, Rb)),
            float(np.linalg.norm(pa - pb, axis=1).max()))


def same_map(a, b):
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in ("kf_pose_R", "kf_pose_t", "pt_pos"))


def phase_real_map_gba(power, device="cuda"):
    """(a) Global BA on the real map on the card, plain
    (ORB_DISTRIBUTED_GBA=0) and sharded over a world of one
    (ORB_DISTRIBUTED_GBA=1, NCCL), each twice in turns (the second run of
    each under torch.profiler), and once plain on the CPU (and in float64
    there): each route's runs bit-identical, the sharded route bit-identical
    to the plain one, the card against the CPU within real_map_bound. Then
    the point-sharded solve on the same problem, twice, bit-identical to
    the plain one, in turns with it (real_map_point_sharded)."""
    routes = ("0", "eager", "1") if torch.device(device).type == "cuda" else ("0", "1")
    runs = {route: [] for route in routes}
    profs = {route: {} for route in routes}
    traced = torch.device(device).type == "cuda"
    for turn in range(2):
        for route in routes:
            runs[route].append(real_map_gba(route, device,
                                            profs[route] if turn and traced else None))
    cpu, cpu_wall, cpu_iters = real_map_gba("0", "cpu")
    wide = real_map_float64()
    names = {"0": "plain, CUDA graph replays (the device-loop form)",
             "eager": "plain, eager (the early-exit form)",
             "1": "sharded, world 1 over NCCL, CUDA graph replays (the device-loop form)"}
    for route, (first, second) in runs.items():
        if not same_map(first[0], second[0]):
            raise AssertionError(f"real-map global BA, {names[route]}: two runs differ")
        wall_ms, busy_ms, n_ops = profs[route].get("gba", (second[1] * 1e3, 0.0, 0))
        log(f"real-map global BA ({REAL_MAP_SIZE[0]} keyframes, {REAL_MAP_SIZE[1]} points), "
            f"{names[route]}, on {power}: {first[1]:.3f} / {second[1]:.3f} s (first / second "
            f"run), {second[2]} LM iterations, {second[1] * 1e3 / max(second[2], 1):.1f} ms "
            f"an iteration; device busy {busy_ms:.1f} of {wall_ms:.1f} ms, idle share "
            f"{1.0 - busy_ms / wall_ms:.4f}, {n_ops} device operations")
    if not all(same_map(runs["0"][0][0], runs[r][0][0]) for r in routes):
        raise AssertionError("real-map global BA: the eager or the sharded route differs from "
                             "the replayed one")
    same, plain_s, points_s = real_map_point_sharded(device)
    iters = runs["0"][1][2]
    log(f"real-map global BA problem, point-sharded (distributed_bundle_adjust_points, "
        f"world 1 over {dba.backend_for(device).upper()}) against plain bundle_adjust, on "
        f"{power}: {points_s * 1e3 / max(iters, 1):.1f} vs {plain_s * 1e3 / max(iters, 1):.1f} "
        f"ms an iteration ({iters} LM iterations); bits equal {same}")
    if not same:
        raise AssertionError("real-map global BA: the point-sharded solve differs from "
                             "the plain one")
    _, c_cpu, _, _ = map_poses(cpu)
    extent = float(np.linalg.norm(c_cpu.max(axis=0) - c_cpu.min(axis=0)))
    card = pose_gap(runs["0"][0][0], cpu)
    spread = pose_gap(cpu, wide)
    moved = pose_gap(cpu, real_map())
    log(f"real-map global BA card vs CPU (centre m, rotation deg, point m): "
        f"{tuple(float(f'{v:.4g}') for v in card)}; the CPU's float32 vs float64: "
        f"{tuple(float(f'{v:.4g}') for v in spread)}; the solve moved the map by "
        f"{tuple(float(f'{v:.4g}') for v in moved)}; extent {extent:.1f} m; "
        f"the CPU's run {cpu_wall:.3f} s, {cpu_iters} LM iterations; bits equal run to run "
        f"on each route and across routes")
    bound = real_map_bound(spread, moved)
    log(f"real-map global BA bound (centre m, rotation deg, point m): "
        f"{tuple(float(f'{v:.4g}') for v in bound)}")
    if not all(c < b for c, b in zip(card, bound)):
        raise AssertionError(f"real-map global BA card vs CPU {card} not within {bound}")


def real_map_bound(spread, moved):
    """The card-vs-CPU bound of the real-map global BA, for each of centre,
    rotation and point: the geometric mean of the CPU's float32-vs-float64
    spread and how far the CPU's solve moved the map, so above float32's own
    spread and below the movement by the same factor (a card solve that did
    nothing lies `moved` from the CPU's). Raises if the spread is not under
    the movement: the bound could not then tell a solve from none."""
    if not all(s < m for s, m in zip(spread, moved)):
        raise AssertionError(f"real-map global BA: float32's spread {spread} is not under "
                             f"the solve's movement {moved}")
    return tuple(float(np.sqrt(s * m)) for s, m in zip(spread, moved))


def drifted_loop_graph(K, seed=5, skip_every=7):
    """tests/test_sim3.py's _drifted_loop_graph (a chain with a loop,
    drifted estimates, true measurements), its rotations by the port's
    so3_exp in float64 -> (numpy leaves of a Sim3Graph, R_true, t_true)."""
    def so3(w):
        return lie.so3_exp(torch.as_tensor(w, dtype=torch.float64)).numpy()

    rng = np.random.default_rng(seed)
    R_true, t_true = [], []
    for k in range(K):
        ang = 2 * np.pi * k / K
        R = so3([0.0, ang, 0.0])
        c = np.array([np.sin(ang) * 10, 0.0, 10 - np.cos(ang) * 10])
        R_true.append(R)
        t_true.append(-R @ c)
    R_true, t_true = np.stack(R_true), np.stack(t_true)
    R_est, t_est = R_true.copy(), t_true.copy()
    drift_R = so3(rng.normal(0, 0.002, 3))
    acc = np.eye(3)
    for k in range(1, K):
        acc = acc @ drift_R
        R_est[k] = R_true[k] @ acc
        t_est[k] = t_true[k] + rng.normal(0, 0.01 * k, 3)

    def rel(i, j):
        Rij = R_true[i] @ R_true[j].T
        return Rij, t_true[i] - Rij @ t_true[j]

    ei, ej, mR, mt = [], [], [], []
    for k in range(K - 1):
        Rm, tm = rel(k + 1, k)
        ei.append(k + 1), ej.append(k), mR.append(Rm), mt.append(tm)
        if k % skip_every == 0:
            j2 = (k + 4) % K
            Rm, tm = rel(k, j2)
            ei.append(k), ej.append(j2), mR.append(Rm), mt.append(tm)
    Rm, tm = rel(0, K - 1)
    ei.append(0), ej.append(K - 1), mR.append(Rm), mt.append(tm)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    leaves = dict(s=np.ones(K), R=R_est, t=t_est, fixed=fixed, edge_i=np.asarray(ei),
                  edge_j=np.asarray(ej), meas_s=np.ones(len(ei)), meas_R=np.stack(mR),
                  meas_t=np.stack(mt), edge_valid=np.ones(len(ei), bool))
    return leaves, R_true, t_true


FORM_NAME = {pose_graph.optimize_sim3_graph: "eager",
             pose_graph.optimize_sim3_graph_jit: "replayed"}


def phase_large_pose_graph(power, device="cuda"):
    """(b) The 300-vertex drifted loop's essential graph (fix_scale, 20
    iterations, solver "auto": block-Jacobi PCG above 256 vertices) on the
    card twice (optimize_sim3_graph_jit, replayed CUDA graphs) and on the
    CPU, in float64 as tests/test_sim3.py runs it (x64 is on in the
    suite): the largest centre error under the JAX test's 0.10 m, the two
    card runs bit-identical, card vs CPU centres within GRAPH_CENTRE_TOL;
    first, its first GRAPH_COMPARED_ITERS LM iterations eager
    (optimize_sim3_graph) against replayed, bit for bit, each timed.
    Then in float32, the System's precision, once on the card (replayed)
    and once on the CPU over GRAPH_F32_ITERS iterations: card vs CPU
    within GRAPH_CENTRE_TOL, the error below where it started. (In float32
    the LM stalls on this graph in both packages after two steps, 10.86 m
    from the truth: edges whose rotation residual falls below ~5e-4 rad get
    a non-finite Jacobian through so3_log's arccos, and every step after is
    rejected; ROADMAP queue 3.)"""
    leaves, R_true, t_true = drifted_loop_graph(GRAPH_K)
    c_true = -np.einsum("kba,kb->ka", R_true, t_true)
    start = pose_graph._cg_start
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return start(*args, **kwargs)

    def solve(device, dtype, n_iters, fn=pose_graph.optimize_sim3_graph_jit):
        """-> (the solved graph, wall s); calls[0] += the LM steps that took
        the PCG (the eager loop's _cg_start calls, or the replays of its
        graph)."""
        g = pose_graph.Sim3Graph(**{k: torch.from_numpy(
            v.astype(np.int64) if k.startswith("edge_") and v.dtype != bool else
            v.astype(dtype) if v.dtype.kind == "f" else v).to(device)
            for k, v in leaves.items()})
        graphed = fn is pose_graph.optimize_sim3_graph_jit and torch.device(device).type == "cuda"
        if not graphed:
            pose_graph._cg_start = counted
        replays = {k: g_.replays for k, g_ in cuda_graph.graphs.items() if k[0] is start}
        try:
            t0 = time.perf_counter()
            out = fn(g, n_iters=n_iters, fix_scale=True, solver="auto")
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pose_graph._cg_start = start
        calls[0] += sum(g_.replays - replays.get(k, 0) for k, g_ in cuda_graph.graphs.items()
                        if k[0] is start)
        return out, wall

    def centres(g):
        R, t = g.R.double().cpu().numpy(), g.t.double().cpu().numpy()
        return -np.einsum("kba,kb->ka", R, t)

    pre = float(np.linalg.norm(-np.einsum("kba,kb->ka", leaves["R"], leaves["t"]) - c_true,
                               axis=1).max())
    bad = []
    calls[0] = 0
    compared = [solve(device, np.float64, GRAPH_COMPARED_ITERS, fn) for fn in FORM_NAME]
    same = all(torch.equal(x, y) for x, y in zip(compared[0][0], compared[1][0]))
    log(f"pose graph of {GRAPH_K} vertices in float64, its first {GRAPH_COMPARED_ITERS} LM "
        f"iterations ({calls[0]} PCG solves), eager against replayed (its first call's "
        f"captures included), on {power}: " + ", ".join(
            f"{FORM_NAME[fn]} {w:.3f} s, {w * 1e3 / GRAPH_COMPARED_ITERS:.1f} ms an LM iteration"
            for fn, (_, w) in zip(FORM_NAME, compared)) + f"; bit-identical {same}")
    if not same:
        bad.append("float64: the eager and the replayed solves differ")
    jit = pose_graph.optimize_sim3_graph_jit
    for dtype, forms, n_iters in ((np.float64, (jit, jit), 20),
                                  (np.float32, (jit,), GRAPH_F32_ITERS)):
        calls[0] = 0
        card = [solve(device, dtype, n_iters, fn) for fn in forms]
        runs = len(card)
        a = card[0][0]
        card_pcg = calls[0]
        cpu, wall_cpu = solve("cpu", dtype, n_iters)
        same = all(torch.equal(x, y) for x, y in zip(a, card[-1][0]))
        err = float(np.linalg.norm(centres(a) - c_true, axis=1).max())
        gap = float(np.linalg.norm(centres(a) - centres(cpu), axis=1).max())
        log(f"pose graph of {GRAPH_K} vertices ({leaves['edge_i'].size} edges) in "
            f"{np.dtype(dtype).name}, {n_iters} iterations, PCG ({card_pcg} PCG solves on the "
            f"card), on {power}: {' / '.join(f'{w:.3f}' for _, w in card)} s on the card "
            f"(replayed), "
            f"{wall_cpu:.3f} s on the CPU; largest centre error {pre:.4f} m before, "
            f"{err:.6g} m after"
            f"{f' (gate {GRAPH_PCG_GATE})' if dtype == np.float64 else ''}; card vs CPU "
            f"{gap:.3g} m (bound {GRAPH_CENTRE_TOL})"
            f"{'; the two card runs bit-identical' if runs > 1 and same else ''}")
        if not card_pcg or not same or gap >= GRAPH_CENTRE_TOL or err >= pre or (
                dtype == np.float64 and err >= GRAPH_PCG_GATE):
            bad.append(f"{np.dtype(dtype).name}: PCG solves {card_pcg}, bits equal {same}, "
                       f"error {err}, card vs CPU {gap}")
    if bad:
        raise AssertionError(f"the {GRAPH_K}-vertex pose graph: " + "; ".join(bad))


def reference_summary_keys(script):
    """The keys of the summary dict a JAX driver script writes (read from
    its source under scripts/, not imported)."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "scripts", script)).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "summary" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError(f"no summary dict in scripts/{script}")


# Every process started_process started; any still running when the
# script exits (a phase failed before it was read) is killed then.
STARTED = []


@atexit.register
def _stop_started():
    for proc in STARTED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def started_process(cmd, env, prefix):
    """cmd started from the repository root, its output into prefix.out
    and prefix.err."""
    with open(prefix + ".out", "w") as out, open(prefix + ".err", "w") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, text=True, env=env, cwd=REPO)
    proc.prefix = prefix
    STARTED.append(proc)
    return proc


def finished(proc, timeout=600):
    """Wait for a started_process (killed past timeout) -> (stdout, stderr)."""
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(proc.prefix + ".out") as out, open(proc.prefix + ".err") as err:
        return out.read(), err.read()


def start_drive_cli(root, flags=()):
    """Start both drives' command lines (phase_drive_cli) -> their
    (summary path, start time, process) by name."""
    env = dict(os.environ, TMPDIR=root)
    procs = {}
    for name, scene in DRIVES.items():
        out = os.path.join(root, f"{name}.json")
        procs[name] = (out, time.perf_counter(), started_process(
            [sys.executable, "-m", f"orb_slam2_commit_tpu_torch.examples.{name}", "--stereo",
             f"--frames={DRIVE_FRAMES}", *scene, f"--out={out}", *flags], env,
            os.path.join(root, name)))
    return procs


def phase_drive_cli(power, procs):
    """(c) The drives' command lines, both at once, each in a subprocess
    on the card: --stereo --frames=40 at 640x480 with the full drives'
    scene settings (DRIVES). Each must exit 0 and write a summary with
    every key of the JAX driver's, and launch every kernel of the stereo
    per-frame path and none of those off it (the counts in the summary,
    reset as the drive starts). The drives record an error and go on where
    the JAX drivers do, so each such record fails here: the scale drive's
    global BA routes must both be timed (a route that raised reads -1.0 and
    writes a gba_error line to OUT.log), and the multi-loop drive's kidnap
    probe must relocalize, with no error. procs: start_drive_cli's."""
    bad = []
    for name, (out, t0, proc) in procs.items():
        _, stderr = finished(proc)
        if proc.returncode != 0:
            bad.append(f"{name} exited {proc.returncode}: {stderr[-2000:]}")
            continue
        with open(out) as f:
            d = json.load(f)
        missing = reference_summary_keys(f"{name}.py") - set(d)
        c = d["launches"]
        if name == "scale_drive":
            with open(out + ".log") as f:
                errors = [line for line in f if "gba_error" in line]
            walls = (d["gba_wall_s"], d["dist_gba_wall_s"])
            checked = (f"; global BA on the final map {walls[0]:.3f} s plain, {walls[1]:.3f} s "
                       f"sharded")
            if not (walls[0] > 0 and walls[1] > 0) or errors:
                bad.append(f"{name}: global BA walls {walls}, {errors}")
        else:
            kidnap = d["kidnap_reloc"]
            checked = f"; kidnap probe {kidnap}"
            if "error" in kidnap or not kidnap["relocalized"]:
                bad.append(f"{name}: kidnap probe {kidnap}")
        log(f"python -m orb_slam2_commit_tpu_torch.examples.{name} --stereo "
            f"--frames={DRIVE_FRAMES} {' '.join(DRIVES[name])}: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s (both drives at once, beside the pose graph), "
            f"on {power}: {d['final_state']}, {d['n_keyframes']} keyframes, "
            f"{d['n_points']} points, ATE {d['ate_pct_of_path']:.4f}% of the path, median "
            f"frame {d['frame_dt_med_ms']:.1f} ms{checked}; launches " + ", ".join(
                f"{k} {v}" for k, v in c.items() if v))
        if missing:
            bad.append(f"{name}: the summary lacks {sorted(missing)}")
        if [k for k in DRIVE_LAUNCHED if c[k] < 1] or [k for k in SYSTEM_UNUSED if c[k]]:
            bad.append(f"{name}: launches {c}")
    if bad:
        raise AssertionError("; ".join(bad))


def phase_map_scale(power, device="cuda"):
    """The map-scale phase, (a)-(c); (c)'s drives run in their processes
    while (b) runs here (its solve times then share the host)."""
    t0 = time.perf_counter()
    phase_real_map_gba(power, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drives_") as root:
        procs = start_drive_cli(
            root, () if torch.device(device).type == "cuda" else ("--device=cpu",))
        try:
            phase_large_pose_graph(power, device)
        except BaseException:
            for _, _, proc in procs.values():
                proc.kill()
                proc.wait()
            raise
        phase_drive_cli(power, procs)
    log(f"map-scale phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 5: timing
# ---------------------------------------------------------------------------

def phase_fps(name, step, image, power, blocks=FPS_BLOCKS):
    """Frames/s by bench.py's recipe: 8 distinct noisy frames, frame i fed
    frame i-2's inlier count, a value fetch ending each block of 64, best
    of `blocks` blocks. step(image, fb) -> the call's inlier count (a
    tensor). -> the best block's frames/s."""
    gen = torch.Generator(device=image.device).manual_seed(0)
    images = [image + 0.5 * torch.randn(image.shape, generator=gen,
                                        device=image.device)
              for _ in range(8)]
    fb1 = fb2 = torch.zeros((), device=image.device)
    for i in range(16):
        fb2, fb1 = fb1, step(images[i % 8], fb2).to(torch.float32)
    _ = float(fb1) + float(fb2)
    fps_blocks = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for i in range(64):
            fb2, fb1 = fb1, step(images[i % 8], fb2).to(torch.float32)
        final = float(fb1) + float(fb2)
        fps_blocks.append(64 / (time.perf_counter() - t0))
        if not final >= 0:
            raise AssertionError("bad inlier chain")
    log(f"{name} {WIDTH}x{HEIGHT}/{N_FEATURES} feat: {max(fps_blocks):.2f} frames/s "
        f"best of {blocks}x64 (blocks {[round(f, 2) for f in fps_blocks]}) on {power}")
    return max(fps_blocks)


def time_stages(name, stages, power, reps=10):
    """Per stage: host wall time per call with a synchronise after each
    call, and device time per call by CUDA events over calls in a row."""
    for stage, fn in stages:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
        log(f"{name} stage {stage}: {wall:.3f} ms synced wall, "
            f"{gpu_time_ms(fn, reps):.3f} ms device events, per call, on {power}")


def profiled_calls(fn, calls=PROFILE_CALLS):
    """fn under torch.profiler over `calls` calls -> (wall ms, device busy
    ms, device operations), each per call, and the profile."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    n_ops, busy = device_ops(prof)
    return wall, busy / calls, n_ops / calls, prof


def profile_calls(name, fn, power):
    """Under torch.profiler over PROFILE_CALLS calls: the device's busy
    time per call, its idle share of the wall time, the device operations
    per call, and the kernels by device time."""
    wall, busy, n_ops, prof = profiled_calls(fn)
    log(f"profiled {name} ({PROFILE_CALLS} calls): {wall:.3f} ms wall, {busy:.3f} ms "
        f"device busy, idle share {1.0 - busy / wall:.4f}, "
        f"{n_ops:.0f} device operations per call, on {power}")
    log(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12))


def phase_step_timing(config, args, power):
    image, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t = args
    cam, orb = config.camera, config.orb

    phase_fps("tracking step", lambda im, fb: tracking_forward_step(
        im, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t + 0.0 * fb,
        config).n_inliers, image, power)

    def extract():
        return extractor.extract_features(image, orb, cam.height, cam.width)

    feats = extract()

    def match():
        return matchers.match_projection_last_frame(
            pt_pos, pt_desc, pt_octave, pt_angle, pt_valid, R, t,
            feats.xy, feats.desc, feats.angle, feats.octave, feats.valid,
            cam.fx, cam.fy, cam.cx, cam.cy, float(cam.width),
            float(cam.height), th=15.0, n_levels=orb.n_levels,
            scale=orb.scale_factor)

    pts, obs, _ = pose_inputs(feats, match().idx, pt_pos, config)

    def pose():
        return pose_opt.pose_optimization(
            R, t, pts, obs, cam.fx, cam.fy, cam.cx, cam.cy, cam.bf)

    def step():
        return tracking_forward_step(*args, config)

    time_stages("tracking step", (("extraction", extract), ("matching", match),
                                  ("pose_lm", pose), ("step", step)), power)
    profile_calls("tracking step", step, power)


def phase_pair_timing(config, motion, cands, x, power):
    image, pt_f32, pt_desc, meta = motion

    phase_fps("pair", lambda im, fb: run_pair(
        config, (im, pt_f32, pt_desc, meta + 0.0 * fb), cands)[1][0][12],
        image, power)

    out = fused_motion_track_packed(*motion, config)
    feat_state, lm_meta = interop.local_map_args(out, pt_f32, LM_TH)
    (m_top2, l_top2), (m_lm, l_lm) = x["k6"], x["k8"]
    cam = config.camera
    stages = (
        ("extraction", lambda: extractor.extract_features(
            image, config.orb, cam.height, cam.width)),
        ("motion K6 (two windows)", lambda: kmatching.projection_hamming_top2(*m_top2)),
        ("motion pose_lm", lambda: pose_lm.pose_lm(*m_lm)),
        ("motion stage", lambda: fused_motion_track_packed(*motion, config)),
        ("local-map K6", lambda: kmatching.projection_hamming_top2(*l_top2)),
        ("local-map pose_lm", lambda: pose_lm.pose_lm(*l_lm)),
        ("local-map stage", lambda: fused_local_map_track(
            out[1], out[2], feat_state, *cands, lm_meta, config)),
        ("pair", lambda: run_pair(config, motion, cands)),
    )
    time_stages("pair", stages, power)
    profile_calls("pair", lambda: run_pair(config, motion, cands), power)


def phase_sensor_timing(config, motion, cands, x, power):
    """The stereo or RGB-D pair: throughput by the bench recipe (noise on
    the left image), stage times, profile. The stereo pair's stages split
    the motion stage into both extractions, the stereo matcher (with its
    K7 band launch alone), the motion matching with its LM, and the LM
    alone on its stereo rows."""
    what = PATH[config.sensor]
    image, second, pt_f32, pt_desc, meta = motion
    phase_fps(what, lambda im, fb: run_pair(
        config, (im, second, pt_f32, pt_desc, meta + 0.0 * fb), cands)[1][0][12],
        image, power)

    entry = MOTION[config.sensor]
    out = entry(*motion, config)
    feat_state, lm_meta = interop.local_map_args(out, pt_f32, LM_TH)
    stages = []
    if config.sensor == "stereo":
        cam, orb = config.camera, config.orb
        match_args = stereo_match_args(config, image, second)
        feats = extractor.extract_features(image, orb, cam.height, cam.width)
        smatch = stereo.stereo_match(*match_args)
        ur = torch.where(smatch.valid, smatch.u_right, -1.0)
        pt_pos, pt_octave, pt_angle, pt_valid, R, t, tz = jit_frontend._unpack_inputs(
            pt_f32, meta)
        stages += [
            ("extraction x2", lambda: [extractor.extract_features(
                im, orb, cam.height, cam.width) for im in (image, second)]),
            ("stereo match (K7 band, SAD, median)", lambda: stereo.stereo_match(*match_args)),
            ("stereo K7 band", lambda: kmatching.stereo_band_top2(*x["k7_band"])),
            ("motion matching (K6) + pose_lm", lambda: jit_frontend._fused_match_and_pose(
                feats, feats.xy, ur, pt_pos, pt_desc, pt_octave, pt_angle, pt_valid,
                R, t, config, tz_rel=tz)),
            ("motion pose_lm (stereo rows)", lambda: pose_lm.pose_lm(*x["k8_stereo"][0])),
        ]
    stages += [
        ("motion stage", lambda: entry(*motion, config)),
        ("local-map stage", lambda: fused_local_map_track(
            out[1], out[2], feat_state, *cands, lm_meta, config)),
        ("pair", lambda: run_pair(config, motion, cands)),
    ]
    time_stages(what, stages, power)
    profile_calls(what, lambda: run_pair(config, motion, cands), power)


def k6_work(calls):
    """(bytes, operations) of K6 calls without a batch axis: the inputs
    read once and 4 x M results per window written; 8 operations per
    window test of a valid row and 24 per candidate pair."""
    n_bytes = n_ops = 0
    for args in calls:
        desc_a, proj, radii, lo, hi, valid_a, desc_b, xy_b, octave_b, valid_b = args
        cand = (valid_a[:, None] & valid_b[None, :]
                & kmatching.matching.window_mask(proj, xy_b, torch.stack(radii).amax(0))
                & kmatching.matching.octave_band_mask(octave_b, lo, hi))
        n_bytes += (nbytes(desc_a, proj, *radii, lo, hi, valid_a, desc_b, xy_b, octave_b,
                           valid_b) + len(radii) * 4 * valid_a.numel() * 4)
        n_ops += 8 * int(valid_a.sum()) * desc_b.shape[0] + 24 * int(cand.sum())
    return n_bytes, n_ops


# K7's operations per pair with both flags set for its candidate test: two
# differences, two magnitudes and two compares for the window; the line's
# value (two products, two sums), its square, the threshold's product, a
# compare and, near the band's edge, a division for the epipolar band.
K7_TEST_OPS = {"valid_hamming_top2": 0, "window_hamming_top2": 6, "epipolar_hamming_top2": 8}


def k7_work(name, calls):
    """(bytes, operations) of calls of K7 under a candidate test: every
    input table read once and 4 x M results written per problem; 24
    operations per candidate pair and K7_TEST_OPS[name] per pair with both
    flags set."""
    n_bytes = n_ops = 0
    for args in calls:
        mask = k7_mask(name, args)
        flags = kmatching._flags_mask(k7_batch(name, args), args[0].shape[-2],
                                      args[1].shape[-2], args[2], args[3])
        n_bytes += nbytes(*(a for a in args if torch.is_tensor(a))) + 16 * mask[..., 0].numel()
        n_ops += 24 * int(mask.sum()) + K7_TEST_OPS[name] * int(flags.sum())
    return n_bytes, n_ops


def k7_routes(caller, name, calls, power):
    """A K7 caller's recorded calls two ways, in turns (test, mask, mask,
    test): K7 with the caller's candidate test in the kernel, and the
    caller's mask built by PyTorch then K7 under it (its route before the
    test moved into the kernel). Each reading: under torch.profiler
    (traced_calls) the device-busy ms, the device operations and the idle
    share of the traced calls' wall time, a call; and ms by CUDA events
    over calls in a row."""
    fn = getattr(kmatching, name)
    routes = {"test in the kernel": lambda: [fn(*a) for a in calls],
              "mask built + K7 under it": lambda: [kmatching.masked_hamming_top2(
                  a[0], a[1], k7_mask(name, a)) for a in calls]}
    readings = {label: [] for label in routes}
    for label in (*routes, *reversed(routes)):
        wall, busy, n_ops, _ = traced_calls(routes[label], KERNEL_ROW_CALLS)
        events = gpu_time_ms(routes[label], KERNEL_ROW_CALLS)
        readings[label].append((busy, events, n_ops, wall))
    for label, r in readings.items():
        measured = [v for v in r if v[0] is not None]
        log(f"K7 {caller}, {label} ({len(calls)} calls): device busy ms "
            f"{[round(v[0], 4) for v in measured]}, events ms "
            f"{[round(v[1], 4) for v in r]}, device operations "
            f"{[round(v[2], 1) for v in measured]}, idle share "
            f"{[round(1.0 - v[0] / v[3], 4) for v in measured]} "
            f"({len(r) - len(measured)} of {len(r)} readings saw no device operation), "
            f"on {power}")


def phase_kernel_timing(x, dx, errs, counts, batched, power):
    th_hi, th_lo = x["ths"]
    canvas, blur = x["canvas"], x["blur"]
    padded, hp, wp = level.pad_level(canvas)
    yx = x["yx"]
    kernels = []

    def each(fn, calls):
        return lambda: [fn(*args) for args in calls]

    def row(name, src, replaces, fn, plain, library, n_bytes, n_ops, iters=KERNEL_ROW_CALLS,
            caller=None):
        """One kernel's line: ms, plain_ms and library_ms are device busy
        times per call; the CUDA-event time of the same calls in a row, and
        the device time of each operation the call ran, are logged beside
        ms. With `caller` (a part of the kernel's inputs, its launches
        counted in `batched`) the line is only logged."""
        ms, by_name = device_busy_ms(fn, iters)
        clocks = smi_clocks()
        events_ms = gpu_time_ms(fn, iters)
        plain_ms = device_busy_ms(plain, max(iters // 10, 5), sessions=1)[0]
        lib_ms = (device_busy_ms(library, iters, sessions=1)[0] if library is not None
                  else None)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        if caller is None:
            kernels.append({
                "name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": counts[name], "max_abs_err": errs[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib_ms,
            })
        else:
            run = ("the monocular sweep and the kidnap sequence"
                   if caller in ("monocular initialization",
                                 "relocalization, batch axis, shared columns")
                   else "the ring survey and the kidnap sequence with the vocabulary"
                   if caller in LOOP_CALLERS else DATASET_TIMED[caller]
                   if caller in DATASET_TIMED else "the System's RGB-D run")
            name = f"{name} ({caller}; {batched[caller]} launches in {run})"
        log(f"{name}: {ms:.4f} ms device busy, {events_ms:.4f} ms by events in a row "
            f"(plain {plain_ms:.4f} ms, library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms by {b_by}; {n_bytes / 1e6:.3f} MB, "
            f"{n_ops / 1e6:.2f} Mop) on {power}")
        log("    device ms per call by operation: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])))
        log(f"    right after the device-busy timing: {clocks}")
        return ms

    # K1 (the function the main path calls) reads the canvas and its two
    # pad-index tables once and writes three maps; ~300 float operations
    # per pixel (26 for the blur, 17 per circle bit x 16). Its row is the
    # wrapper's time; the log line beside it gives the kernel's own.
    n_px = hp * wp
    row("level_preprocess", "orb_slam2_commit_tpu_torch/csrc/level.cu",
        "orb_slam2_commit_tpu/ops/pallas_level.py:143",
        lambda: level.level_preprocess(canvas, th_hi, th_lo),
        lambda: level.level_preprocess_plain(padded, hp, wp, th_hi, th_lo),
        None, canvas.numel() * 4 + (hp + wp + 12) * 4 + 3 * n_px * 4, 300 * n_px)
    # K2 needs score_hi inside each row's bounds (for the cell flags and
    # the high cells), score_lo inside the bounds of the low cells (flags
    # from the plain version's masked maps), the two bound columns, and
    # writes one map; counted from this run's maps.
    hi, lo, bounds = x["hi"], x["lo"], x["bounds"]
    h2, w2 = hi.shape
    inside = level.bounds_mask(bounds, w2)
    has_hi = (torch.where(inside, hi, 0.0).reshape(h2 // level.CELL, level.CELL, -1, level.CELL)
              .amax(dim=(1, 3)) > 0)
    low_inside = inside & ~has_hi.repeat_interleave(level.CELL, 0).repeat_interleave(
        level.CELL, 1)
    k2_bytes = 4 * (int(inside.sum()) + int(low_inside.sum()) + hi.numel() + 2 * h2)
    log(f"K2 reads {int(inside.sum())} score_hi and {int(low_inside.sum())} score_lo "
        f"pixels inside the bounds of the [{h2}, {w2}] maps ({int(has_hi.sum())} of "
        f"{has_hi.numel()} cells high)")
    row("combine_nms", "orb_slam2_commit_tpu_torch/csrc/level.cu",
        "orb_slam2_commit_tpu/ops/pallas_level.py:327",
        lambda: level.combine_nms(hi, lo, bounds),
        lambda: level.combine_nms_plain(hi, lo, bounds),
        None, k2_bytes, 20 * hi.numel())
    # K3 reads the score map (its map form, the main path's) or the cell
    # matrix (its row form) once and writes k values and indices per cell;
    # k rounds of one compare per entry. The library call is torch.topk on
    # the cell matrix.
    score, cells, cell, k = x["score"], x["cells"], x["cell"], x["k"]
    row("cell_topk_map", "orb_slam2_commit_tpu_torch/csrc/select.cu",
        "orb_slam2_commit_tpu/ops/pallas_select.py:64",
        lambda: select.cell_topk_map(score, cell, k),
        lambda: select.cell_topk_map_plain(score, cell, k),
        lambda: torch.topk(cells, k, dim=1),
        score.numel() * 4 + 2 * cells.shape[0] * k * 4, k * cells.numel())
    row("cell_topk", "orb_slam2_commit_tpu_torch/csrc/select.cu",
        "orb_slam2_commit_tpu/ops/pallas_select.py:64",
        lambda: select.cell_topk(cells, k),
        lambda: select.cell_topk_plain(cells, k),
        lambda: torch.topk(cells, k, dim=1),
        cells.numel() * 4 + 2 * cells.shape[0] * k * 4, k * cells.numel())

    # K4 (both windows of a frame): the distinct image pixels the windows
    # cover, the centres, and the windows written. covered() -> (that pixel
    # count, the call's index grids: the library call of the standalone K4).
    def covered(img, c_yx, p):
        h, w = img.shape
        d = torch.arange(-(p // 2), p // 2 + 1, device=img.device)
        ys = (c_yx[:, 0:1].long().clamp(0, h - 1) + d).clamp(0, h - 1)
        xs = (c_yx[:, 1:2].long().clamp(0, w - 1) + d).clamp(0, w - 1)
        mask = torch.zeros(h * w, dtype=torch.bool, device=img.device)
        mask[(ys[:, :, None] * w + xs[:, None, :]).reshape(-1)] = True
        return int(mask.sum()), (img, ys[:, :, None], xs[:, None, :])

    n_k = yx.shape[0]
    k4_bytes = sum(covered(img, yx, p)[0] * 4 + n_k * 8 + n_k * p * p * 4
                   for img, p in ((canvas, 31), (blur, 39)))

    # The fused K4 + K5 launch (the main paths' one per extraction): K4's
    # bytes for both windows plus the two offsets of each keypoint (its 81
    # window pixels are among the canvas pixels K4 reads); K5's ~2,700
    # float operations per keypoint (gradients, 2 x 49 weighted terms with
    # their exp, the 2x2 solves).
    row("describe_patches", "orb_slam2_commit_tpu_torch/csrc/patches.cu",
        "orb_slam2_commit_tpu/ops/pallas_patches.py:81",
        lambda: patches.describe_patches(canvas, blur, yx, True),
        lambda: patches.describe_patches_plain(canvas, blur, yx, True),
        None, k4_bytes + 8 * n_k, 2700 * n_k)

    # The standalone K4 on its main-path calls: the per-level route's two
    # windows a level (31x31 of the level, 39x39 of its blur) over the 8
    # levels of one image; per call the distinct pixels its windows cover,
    # the centres and the windows written. The library call is the plain
    # version's last line, one aten::index per call on index grids built
    # beforehand.
    k4_calls = x["level_k4"]
    k4_cover = [covered(*args) for args in k4_calls]
    level_k4_bytes = sum(n * 4 + a[1].shape[0] * (8 + a[2] * a[2] * 4)
                         for (n, _), a in zip(k4_cover, k4_calls))
    row("extract_patches", "orb_slam2_commit_tpu_torch/csrc/patches.cu",
        "orb_slam2_commit_tpu/ops/pallas_patches.py:81",
        each(patches.extract_patches, k4_calls), each(patches.extract_patches_plain, k4_calls),
        lambda: [img[ys, xs] for _, (img, ys, xs) in k4_cover], level_k4_bytes, 0, iters=20)

    # The standalone K5 (no caller on the main paths) needs the 81 window
    # pixels of each patch and writes two offsets.
    p5, cy, cx = x["k5"]
    row("corner_subpix", "orb_slam2_commit_tpu_torch/csrc/subpix.cu",
        "orb_slam2_commit_tpu/ops/subpix.py:182",
        lambda: subpix.corner_subpix_from_patches(p5, cy, cx),
        lambda: subpix.corner_subpix_from_patches_plain(p5, cy, cx),
        None, p5.shape[0] * (81 * 4 + 8), 2700 * p5.shape[0])

    # K6, the pair's two launches (the motion stage's with two windows):
    # each reads its row and column tables once and writes 4 x M results
    # per window; ~8 operations per window test of a valid row (an invalid
    # row needs none) and 24 (8 XOR, 8 popcount, 8 adds) per candidate
    # pair of either window, counted from this run's masks.
    k6_bytes = k6_ops = k6_ops_all_rows = 0
    for args in x["k6"]:
        m_rows, n_cols = args[0].shape[0], args[6].shape[0]
        r_any = torch.stack(args[2]).amax(dim=0)
        mask = (args[5][:, None] & args[9][None, :]
                & kmatching.matching.window_mask(args[1], args[7], r_any)
                & kmatching.matching.octave_band_mask(args[8], args[3], args[4]))
        k6_bytes += nbytes(*args[:2], *args[2], *args[3:]) + len(args[2]) * 4 * m_rows * 4
        k6_ops += 8 * int(args[5].sum()) * n_cols + 24 * int(mask.sum())
        k6_ops_all_rows += 8 * m_rows * n_cols + 24 * int(mask.sum())
    log(f"K6 operations in the pair's launches: {k6_ops / 1e6:.2f} M with window tests "
        f"of valid rows only (the bound's count), {k6_ops_all_rows / 1e6:.2f} M with "
        f"every row's")

    def all_k6(fn):
        return lambda: [fn(*args) for args in x["k6"]]

    row("projection_hamming_top2", "orb_slam2_commit_tpu_torch/csrc/matching.cu",
        "orb_slam2_commit_tpu/ops/pallas_matching.py:246",
        all_k6(kmatching.projection_hamming_top2),
        all_k6(kmatching.projection_hamming_top2_plain), None, k6_bytes, k6_ops)

    # K7 band, the stereo pair's launch: it reads both sides' tables once
    # and writes 4 x (N_l + N_r) results; ~8 operations per band test of a
    # valid row (both directions) and 24 (8 XOR, 8 popcount, 8 adds) per
    # candidate pair in each direction, counted from this run's mask.
    band = x["k7_band"]
    n_l, n_r = band[0].shape[0], band[5].shape[0]
    n_pairs = int(x["k7"][0][2].sum())
    band_bytes = nbytes(*band[:9]) + 4 * (n_l + n_r) * 4
    band_ops = 8 * (int(band[4].sum()) * n_r + int(band[8].sum()) * n_l) + 2 * 24 * n_pairs
    log(f"K7 band: {n_pairs} candidate pairs, {int(band[4].sum())} of {n_l} left and "
        f"{int(band[8].sum())} of {n_r} right rows valid")
    row("stereo_band_top2", "orb_slam2_commit_tpu_torch/csrc/matching.cu",
        "orb_slam2_commit_tpu/ops/pallas_matching.py:113",
        lambda: kmatching.stereo_band_top2(*band),
        lambda: kmatching.stereo_band_top2_plain(*band), None, band_bytes, band_ops)

    # K7 under a caller's mask (no caller on the main paths) on the masks
    # that the RGB-D System's recorded reference-keyframe and triangulation
    # calls build: it reads its two descriptor tables and its mask once and
    # writes 4 x M results per problem; one operation per mask entry and 24
    # per candidate pair. K7 under a candidate test on its callers'
    # recorded calls reads its tables (descriptors, flags, coordinates,
    # F12, sigma^2) once and writes the same results; 24 operations per
    # candidate pair and the test's own per pair with both flags set
    # (K7_TEST_OPS).
    def top2_work(calls):
        n_bytes = sum(nbytes(*args) + 4 * args[2].shape[-2] * args[2].shape[:-2].numel() * 4
                      for args in calls)
        n_ops = sum(args[2].numel() + 24 * int(args[2].sum()) for args in calls)
        return n_bytes, n_ops

    k7_src = ("orb_slam2_commit_tpu_torch/csrc/matching.cu",
              "orb_slam2_commit_tpu/ops/pallas_matching.py:113")
    masked = [(a[0], a[1], k7_mask("valid_hamming_top2", a)) for a in x["sys_k7"]] + \
        [(a[0], a[1], k7_mask("epipolar_hamming_top2", a)) for a in x["sys_k7b"]]
    row("masked_hamming_top2", *k7_src, each(kmatching.masked_hamming_top2, masked),
        each(kmatching.masked_hamming_top2_plain, masked), None, *top2_work(masked))
    k7_callers = (("reference-keyframe match", "valid_hamming_top2", x["sys_k7"]),
                  ("triangulation, batch axis", "epipolar_hamming_top2", x["sys_k7b"]),
                  ("monocular initialization", "window_hamming_top2", x["mono_k7_init"]),
                  ("relocalization, batch axis, shared columns", "valid_hamming_top2",
                   x["mono_k7_reloc"]),
                  ("compute_sim3", "valid_hamming_top2", x["loop_compute_sim3"]),
                  ("BoW relocalization", "valid_hamming_top2", x["loop_BoW relocalization"]))
    for caller, name, calls in k7_callers[:3]:
        row(name, *k7_src, each(getattr(kmatching, name), calls),
            each(kmatching.CANDIDATE_PLAINS[name], calls), None, *k7_work(name, calls))
    for caller, name, calls in k7_callers:
        log(f"K7 {caller} calls (B, M, N): " + ", ".join(
            f"{tuple(m.shape)} {int(m.sum())} pairs, {int(m.any(-1).sum())} rows with a "
            f"candidate" for m in (k7_mask(name, a) for a in calls)))
        row(name, *k7_src, each(getattr(kmatching, name), calls),
            each(kmatching.CANDIDATE_PLAINS[name], calls), None, *k7_work(name, calls),
            caller=caller)
        k7_routes(caller, name, calls, power)

    # K6 with a batch axis on the System's recorded fuse calls (one
    # keyframe's points, their descriptors shared, into B targets): inputs
    # once, 4 x B x M results; 8 operations per window test of a valid row
    # and 24 per candidate pair.
    k6b_bytes = k6b_ops = 0
    for args in x["sys_k6b"]:
        desc_a, proj, (radius,), lo, hi, valid_a, desc_b, xy_b, octave_b, valid_b = args
        k6b_bytes += nbytes(desc_a, proj, radius, *args[3:]) + 4 * valid_a.numel() * 4
        cand = (valid_a[:, :, None] & valid_b[:, None, :]
                & kmatching.matching.window_mask(proj, xy_b, radius)
                & kmatching.matching.octave_band_mask(octave_b, lo, hi))
        k6b_ops += 8 * int(valid_a.sum()) * desc_b.shape[1] + 24 * int(cand.sum())
    log("K6 fuse calls (B, P, N): " + ", ".join(
        f"({a[1].shape[0]}, {a[1].shape[1]}, {a[6].shape[1]}) {int(a[5].sum())} valid rows"
        for a in x["sys_k6b"]))
    row("projection_hamming_top2", "orb_slam2_commit_tpu_torch/csrc/matching.cu",
        "orb_slam2_commit_tpu/ops/pallas_matching.py:246",
        each(kmatching.projection_hamming_top2, x["sys_k6b"]),
        each(kmatching.projection_hamming_top2_plain, x["sys_k6b"]), None,
        k6b_bytes, k6b_ops, caller="fuse, batch axis")

    # The loop phase's K6 callers: SearchBySim3 (one direction a call,
    # [N_kf] rows) and the loop neighbourhood's projection ([P] rows, a
    # power of two); its K7 callers are timed above. Bytes and operations
    # counted as above.
    for caller in ("match_by_sim3", "loop match_fuse"):
        calls = x[f"loop_{caller}"]
        log(f"{caller} calls: " + ", ".join(
            f"({a[1].shape[0]}, {a[6].shape[0]}) {int(a[5].sum())} valid rows" for a in calls))
        row("projection_hamming_top2", "orb_slam2_commit_tpu_torch/csrc/matching.cu",
            "orb_slam2_commit_tpu/ops/pallas_matching.py:246",
            each(kmatching.projection_hamming_top2, calls),
            each(kmatching.projection_hamming_top2_plain, calls), None,
            *k6_work(calls), caller=caller)

    # K8, the pair's two launches: inputs read once, pose and inlier flags
    # written; operations from the evaluations each launch ran on this
    # input (the kernel reports them).
    k8_bytes = k8_ops = k8_evals = 0
    for args in x["k8"]:
        n_evals, obs_evals, rounds = pose_lm.work_done(*args)
        obs = args[3]
        k8_bytes += nbytes(args[0], args[1], args[2], obs.uvr, obs.inv_sigma2,
                           obs.is_stereo, obs.valid) + 48 + 8 + obs.valid.numel()
        k8_evals += n_evals
        k8_ops += (pose_lm.OPS_PER_EVAL * obs_evals
                   + pose_lm.OPS_PER_CLASSIFY * rounds * int(obs.valid.sum()))
        log(f"K8 O={obs.valid.numel()}: {n_evals:.0f} evaluations over {rounds:.0f} "
            f"rounds, {obs_evals:.0f} observation evaluations")

    def all_k8(fn):
        return lambda: [fn(*args) for args in x["k8"]]

    ms = row("pose_lm", "orb_slam2_commit_tpu_torch/csrc/pose_lm.cu",
             "orb_slam2_commit_tpu/optim/pallas_pose_opt.py:381",
             all_k8(pose_lm.pose_lm), all_k8(pose_opt.pose_optimization_plain),
             None, k8_bytes, k8_ops)
    log(f"pose_lm: {ms / k8_evals * 1e3:.3f} us per evaluation ({k8_evals:.0f} "
        f"evaluations in the pair's two launches) on {power}")

    # The dataset paths' new shapes, on the KITTI cell's recorded calls
    # (logged only), by the rows' counts above: K1 on the 1241-wide canvas,
    # K7's band at 2000 x 2000, K7 under the initialization's window at
    # twice 2000 features, K8 at 2000 observations.
    kitti = dx["kitti_00-02_stereo"][1]
    image, k_hi, k_lo = kitti["level_preprocess"][0]
    k_pad, k_hp, k_wp = level.pad_level(image)
    row("level_preprocess", "orb_slam2_commit_tpu_torch/csrc/level.cu",
        "orb_slam2_commit_tpu/ops/pallas_level.py:143",
        lambda: level.level_preprocess(image, k_hi, k_lo),
        lambda: level.level_preprocess_plain(k_pad, k_hp, k_wp, k_hi, k_lo), None,
        image.numel() * 4 + (k_hp + k_wp + 12) * 4 + 3 * k_hp * k_wp * 4, 300 * k_hp * k_wp,
        caller="KITTI canvas 1241x376")
    band = kitti["stereo_band_top2"][0]
    n_l, n_r = band[0].shape[0], band[5].shape[0]
    n_pairs = int(kmatching.stereo_band_mask(*band[1:5], *band[6:10]).sum())
    row("stereo_band_top2", "orb_slam2_commit_tpu_torch/csrc/matching.cu",
        "orb_slam2_commit_tpu/ops/pallas_matching.py:113",
        lambda: kmatching.stereo_band_top2(*band),
        lambda: kmatching.stereo_band_top2_plain(*band), None,
        nbytes(*band[:9]) + 4 * (n_l + n_r) * 4,
        8 * (int(band[4].sum()) * n_r + int(band[8].sum()) * n_l) + 2 * 24 * n_pairs,
        caller="KITTI pair, 2000 x 2000")
    win = dx["kitti-mono"][1]["window_hamming_top2"][:1]
    row("window_hamming_top2", "orb_slam2_commit_tpu_torch/csrc/matching.cu",
        "orb_slam2_commit_tpu/ops/pallas_matching.py:113",
        each(kmatching.window_hamming_top2, win),
        each(kmatching.CANDIDATE_PLAINS["window_hamming_top2"], win), None,
        *k7_work("window_hamming_top2", win), caller="KITTI monocular initialization")
    k8 = kitti["pose_lm"][:1]
    evals, obs_evals, rounds = pose_lm.work_done(*k8[0])
    obs = k8[0][3]
    ms = row("pose_lm", "orb_slam2_commit_tpu_torch/csrc/pose_lm.cu",
             "orb_slam2_commit_tpu/optim/pallas_pose_opt.py:381",
             each(pose_lm.pose_lm, k8), each(pose_opt.pose_optimization_plain, k8), None,
             nbytes(*k8[0][:3], obs.uvr, obs.inv_sigma2, obs.is_stereo, obs.valid) + 56
             + obs.valid.numel(),
             pose_lm.OPS_PER_EVAL * obs_evals
             + pose_lm.OPS_PER_CLASSIFY * rounds * int(obs.valid.sum()),
             caller="KITTI stereo frame, 2000 observations")
    log(f"pose_lm at 2000 observations: {ms / evals * 1e3:.3f} us per evaluation "
        f"({evals:.0f} evaluations) on {power}")
    return kernels


def main() -> int:
    if sys.argv[1:2] == ["--full-loop-turn"]:
        # A turn of the full-width loop run, started by run_phases.
        return full_loop_turn(*sys.argv[2:5])
    if sys.argv[1:2] == ["--render-full-loop"]:
        # Frames of the full-width loop run, started by run_phases.
        return render_full_loop(*sys.argv[2:4])
    # Each capture of a CUDA graph, and each System's captures and released
    # graphs at its shutdown, logged by the package.
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    for logger in ("orb_slam2_commit_tpu_torch.utils.cuda_graph",
                   "orb_slam2_commit_tpu_torch.slam.system"):
        logging.getLogger(logger).addHandler(handler)
        logging.getLogger(logger).setLevel(logging.INFO)
    name, count, power = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_datasets_") as data_root:
        run_phases(power, data_root)
    log(power)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


def run_phases(power, data_root):
    """Phases 3-5 (the datasets' files under data_root), then the kernels'
    JSON line. Each step's seconds are logged as it ends."""
    t0 = time.perf_counter()
    last = [t0]

    def done(step):
        now = time.perf_counter()
        log(f"step {step}: {now - last[0]:.1f} s ({now - t0:.1f} s in all); card memory "
            f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
        last[0] = now
    # The full-width loop run's two turns, beside the steps up to the
    # datasets' writing, which build inputs and time nothing; read before
    # the System warm-ups.
    full_loop = start_full_loop_turns(data_root)
    config, args = interop.make_example(WIDTH, HEIGHT, N_FEATURES, N_POINTS, "cuda")
    pairs = {sensor: interop.make_fused_example(
        WIDTH, HEIGHT, N_FEATURES, N_POINTS, N_CANDIDATES, "cuda", sensor=sensor)
        for sensor in ("monocular", "stereo", "rgbd")}
    torch.cuda.synchronize()
    _, motion, cands = pairs["monocular"]
    log(f"examples {WIDTH}x{HEIGHT}, {N_FEATURES} features: "
        f"{time.perf_counter() - t0:.1f} s; step: {int(args[5].sum())} bound of "
        f"{N_POINTS} map points; pairs: {int((motion[1][:, 5] > 0.5).sum())} of "
        f"{N_POINTS} last-frame points, {int((cands[0][:, 8] > 0.5).sum())} of "
        f"{N_CANDIDATES} candidates valid, tz_rel {float(motion[-1][12]):.4f}; "
        f"subpixel refinement {config.orb.subpixel_refine}")

    x = main_path_inputs(args[0], *pairs["monocular"])
    x.update(stereo_path_inputs(*pairs["stereo"]))
    done("main and stereo path inputs")
    seqs = {sensor: system_sequence(sensor) for sensor in ("rgbd", "stereo")}
    mono_seq = system_sequence("monocular")
    kidnap_seq = system_sequence("monocular", kidnap=True)
    loop_seq = loop_sequence()
    done("sequences rendered")
    cells, firsts = write_datasets(data_root)
    done("datasets written")
    phase_full_loop(full_loop, power)
    done("the full-width loop run")
    x.update(system_path_inputs(seqs))
    done("System path inputs")
    x.update(mono_path_inputs(kidnap_seq))
    done("monocular path inputs")
    loop_x, loop_profs, loop_sim3, loop_solves = loop_path_inputs(loop_seq, kidnap_seq)
    x.update(loop_x)
    done("loop path inputs")
    errs = phase_kernels(x)
    phase_loop_kernels(x)
    phase_solves_twice(loop_solves)
    done("phase 3")
    counts = {sensor: phase_pair(*pair) for sensor, pair in pairs.items()}
    phase_step(config, args)
    done("pairs and step")
    phase_graphs(config, args, pairs)
    phase_mapper_graphs(loop_solves, power)
    done("graphs")
    system_counts, system_batched = phase_system(seqs, power)
    done("Systems")
    phase_graph_systems(seqs, power, errs)
    done("Systems, eager against graphs")
    level_counts, x["level_k1"], x["level_k4"] = phase_per_level(args[0], config, power)
    staged_counts, staged_sys = phase_staged_mapper(seqs["rgbd"], power)
    phase_native_core(staged_sys, power)
    done("per-level extraction, staged mapper and native core")
    mono_counts, mono_k7, mono_problems = phase_mono(mono_seq, kidnap_seq, power)
    done("monocular")
    loop_counts = phase_loop(loop_seq, kidnap_seq, loop_profs, loop_sim3, power)
    done("loop")
    loc_counts = phase_localization(localization_sequence(), power)
    done("localization")
    phase_staged_graphs(pairs, seqs, power)
    done("staged graphs")
    phase_loop_graphs(seqs, power)
    done("loop graphs")
    new_counts = {"per-level extraction of one image": level_counts,
                  "RGB-D System with the staged mapper": staged_counts,
                  "localization session": loc_counts,
                  "asynchronous RGB-D System": phase_async(seqs["rgbd"], SYSTEM_FPS["rgbd"],
                                                           power),
                  "global BA runner stress": phase_gba_stress(mono_seq, power)}
    done("asynchronous")
    dataset_counts, kitti_mono, dataset_x = phase_datasets(data_root, cells, firsts, power)
    done("datasets")
    online_counts, dataset_x["AR run"] = phase_online(seqs, power)
    done("online")
    phase_dataset_kernels(dataset_x, errs)
    done("dataset kernels")
    phase_step_timing(config, args, power)
    phase_pair_timing(*pairs["monocular"], x, power)
    for sensor in ("stereo", "rgbd"):
        phase_sensor_timing(*pairs[sensor], x, power)
    phase_async_timing(seqs["rgbd"], power)
    phase_graph_timing(config, args, pairs, power)
    done("timing")
    # Launches per call: K1-K6 and K8 on the monocular pair (their timed
    # inputs), K7's band form on the stereo pair, K7 under a caller's mask,
    # under the flags and under the epipolar band over the System's RGB-D
    # sequence, under the window over the monocular sweep; the callers'
    # lines of K6 and K7 with their launches (with a batch axis) in those
    # runs.
    rgbd = system_counts["rgbd"]
    kitti = dataset_counts["kitti_00-02_stereo"]
    kernels = phase_kernel_timing(x, dataset_x, errs, dict(
        counts["monocular"],
        extract_patches=level_counts["extract_patches"],
        stereo_band_top2=counts["stereo"]["stereo_band_top2"],
        masked_hamming_top2=rgbd["masked_hamming_top2"],
        valid_hamming_top2=rgbd["valid_hamming_top2"],
        epipolar_hamming_top2=rgbd["epipolar_hamming_top2"],
        window_hamming_top2=mono_counts["window_hamming_top2"]), {
        "reference-keyframe match": (rgbd["valid_hamming_top2"]
                                     - system_batched["rgbd"]["valid_hamming_top2"]),
        "triangulation, batch axis": system_batched["rgbd"]["epipolar_hamming_top2"],
        "fuse, batch axis": system_batched["rgbd"]["projection_hamming_top2"],
        "monocular initialization": mono_k7["initialization"],
        "relocalization, batch axis, shared columns": mono_k7["relocalization"],
        **loop_counts,
        "KITTI canvas 1241x376": kitti["level_preprocess"],
        "KITTI pair, 2000 x 2000": kitti["stereo_band_top2"],
        "KITTI monocular initialization": kitti_mono["window_hamming_top2"],
        "KITTI stereo frame, 2000 observations": kitti["pose_lm"]}, power)
    done("kernel timing")
    phase_map_scale(power)
    done("map scale")
    log(f"K7 under a candidate test over the monocular sweep and the kidnap sequence, by "
        f"caller: launches {mono_k7}, problems {mono_problems}")
    for path, c in new_counts.items():
        log(f"launches over the {path}: " + ", ".join(f"{k} {v}" for k, v in c.items() if v))
    for cell, c in dataset_counts.items():
        log(f"launches over the {cell} dataset's first --sync run: " + ", ".join(
            f"{k} {v}" for k, v in c.items() if v))
    log("launches over the four dataset cells' first --sync runs: " + ", ".join(
        f"{k} {sum(c[k] for c in dataset_counts.values())}" for k in _build.launches))
    for path, c in online_counts.items():
        log(f"launches over the online phase's {path}: " + ", ".join(
            f"{k} {v}" for k, v in c.items() if v))

    log(f"CUDA graphs: {cuda_graph.n_captures()} captured, {cuda_graph.n_replays()} replays in "
        f"the whole run; a System run captured {min(r[0] for r in RUN_GRAPHS)}-"
        f"{max(r[0] for r in RUN_GRAPHS)} and replayed {min(r[1] for r in RUN_GRAPHS)}-"
        f"{max(r[1] for r in RUN_GRAPHS)}; the live graphs' pools held at most "
        f"{max(GRAPH_POOL_BYTES)} bytes at a System run's end, its own graphs at most "
        f"{max(GRAPH_POOL_AFTER)} bytes after its shutdown; {len(cuda_graph.graphs)} graphs "
        f"left, holding {sum(g.pool_bytes for g in cuda_graph.graphs.values())} bytes")
    log(json.dumps({"kernels": kernels}))


if __name__ == "__main__":
    sys.exit(main())
