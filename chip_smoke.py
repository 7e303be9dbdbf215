#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``tropical_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: every kernel of the main paths from ``tropical_torch/csrc/`` (one
   ``nvcc`` per source, all started together, with the instrumented builds
   of ``min_dist`` and ``bvh`` and the first designs of ``bvh``,
   ``lattice_encode`` and ``device_engine``, K4c's a build of its own, and
   K6's ``faces``),
   with the ``-Xptxas -v`` register and shared-memory summary; no spills;
3. kernels vs plain: each kernel against its plain PyTorch version, bit for
   bit (the encode's table gradients, scattered by atomicAdd, to a stated
   tolerance), on inputs hard for it.  ``min_dist`` at the flat path's shapes, its
   launch plan and the share of its work that took the exact path (from an
   instrumented build), then kernel, plain and library times (CUDA
   events); ``trilinear_roots`` on the rows of
   ``tests/trilinear_cases.py:kernel_pq`` and 100,000 seeded rows; the
   encode's forward, backward (also in x alone, as the normals take it)
   and double backward on the small, medium and large grids (the large one
   hashes a level) at B = 0, 1, 1,000 and 278,528, and on sphere-small with
   every point in one cell of every level, with every point on cell
   boundaries, far outside the cube (dense bases past int32) and at a
   ragged B = 100,003, on grids of 1, 5 and 16 levels and on a grid whose
   corner indices wrap past the int64 limit, the scatters' spread printed;
   timed at B = 1,000, beside a CUDA graph's cost of one node;
4. flat main path: the CLI ``-e -m small -d sphere -s 1 --gt_res 128`` on
   ``cuda``, through the device extraction engine (``extract/device.py``:
   the distance skeleton, the busy insertions, K2-K5, the final filter and
   the faces, K6), held to the JAX
   CLI's funnel of the same route (``tests/golden/sphere_flat_presets.json``,
   22862/41055 => 10138/20396, 20336: the golden's post-filter counts), the
   committed mesh and the kernel launch counts (the encode's forward on
   every net evaluation, its backward for the faces' normals, in x alone:
   no backward of the flat or the curved run scatters a table gradient;
   the device engine's kernels on the extraction, K6's two of each of its
   four; on every path, a BVH build and one ``bvh_ray`` trace a traced
   mesh);
4b. both engines in one call, on sphere-small flat and on sphere-medium
   curved: the device engine and the host engine (``engine="host"``, held
   to the golden 51455/69581 => 10138/20396, 20336 on the flat path, to the
   curved golden within 0.5 %), each extraction's warm ``take``, and its
   host syncs, device-to-host copies and kernel launches counted by
   torch.profiler; the device engine makes one read a busy insertion on
   the flat path, and on the curved path the reads ``Engine._curved``
   counts, printed for each curved busy insertion, and two for the faces
   (K6); the device engine's
   syncs, copies, launches and reads held to ``ENGINE_COUNTS``; the
   ``trilinear_roots`` launches of each (the host engine's curved path is
   the path of K7's own launch);
5. curved main path: the CLI ``-e -m medium -d sphere -s 1 -f --gt_res
   128`` on ``cuda``, through the device engine (K4c between K4's split and
   its finish), held to the JAX CLI's curved funnel
   (``tests/golden/sphere_curved_presets.json``) or, where only
   eps-boundary flips move it, within 0.5 % of it and to the committed JAX
   vertex set within 1e-5 for all but 0.5 %, |sdf| < 2e-4 on every vertex,
   the launch counts (no ``trilinear_roots`` launch: its solve runs inside
   ``curved_roots``; K4c's by busy insertions, insertions with curved rows
   and with rescued rows, none of ``curved_select``, K4's two a busy
   insertion, K6's two of each, the encode's by forwards), the reads of
   each curved busy insertion and finite CD/AD;
6. each kernel at the largest shape its main path gave it: ``min_dist``
   timed; ``trilinear_roots`` held bitwise to its plain version on every
   row set the curved path solved (the rows ``curved_roots`` gathered from
   the corner forward), their device times summed beside the
   extraction's ``take``, and on the largest of them and on the 100,000
   seeded rows its device time (a CUDA graph of calls, ``graph_ms``), one
   wrapper call, the plain version and ``torch.linalg.eigvals`` on the
   companion matrices timed; the three hash-grid encode kernels held to
   their plain versions and timed at the flat run's largest forward and at
   its largest backward (the faces' normals), and the forward also on that
   largest forward's own points, a marching-cubes slab at 128;
7. training path: ``train()`` on the sphere dataset at sphere-small's full
   width (10 epochs of 50 steps of 1,000 points) from the JAX initial
   params in ``tests/golden/sphere_small_train_1.npz``
   (``scripts/train_golden.py``): one forward, two backwards and one double
   backward of the encode a step, each backward scattering its table
   gradient; every 10-step window of the losses held
   to the golden's JAX runs (``golden_verdict``) and the sdf at its probes
   to twice the one-ulp JAX witness's spread, and the same check shown to
   fail a run with the double backward's table gradient zeroed; one
   ``bvh_closest`` and one ``bvh_ray`` parity count a resample;
   the trained net extracted on the flat path and evaluated at ``--gt_res
   128``, its "Ours" CD at most twice the committed checkpoint's (phase 4);
   a training step timed with the kernels and with the plain encode, the
   labels' time per epoch, each epoch and the whole run, and the device's
   busy share over ten steps (torch.profiler);
8. training CLI: ``python -m tropical_torch.stanford.train -c -m small -d
   sphere -s 1 --epochs 1`` in a process of its own: it trains, extracts,
   and writes nothing under ``tropical/`` nor a checkpoint;
9. evaluate CLI: ``python -m tropical_torch.stanford.evaluate -d sphere -m
   small -s 1 -t mtet`` (pseudo-GT at 256, marching tetrahedra at 16..96)
   and ``... -t mc --gt_res 128``, in-process on phase 4's mesh: every row
   of each table (unrounded) and the on-grid count held to the JAX CLI's
   (``tests/golden/sphere_small_evaluate_1.json``,
   ``scripts/evaluate_golden.py``), a row's vertex count exactly once the
   grid values that are exactly 0 in the port's field take JAX's; the
   launches (the encode forward once a grid slab, ``min_dist`` twice a
   scored row), the stage times; the exported tetrahedra meshes at 16..64
   against the committed ones; marching tetrahedra at 48 on the card
   bitwise the CPU's over the card's field; every crossing on the slabs'
   shared planes merged (tetrahedra at 32..96, cubes at 128 and 256); the
   encode forward at the run's largest forward (the 256 pseudo-GT's first
   slab, 17 * 256^2 points) bitwise its plain version and timed;
10. the BVH tracer (``csrc/bvh.cu``): ``bvh_ray``'s first hits of the
   100,000 evaluation rays bitwise the plain tiles' on every mesh the flat,
   curved, -t mtet and -t mc runs traced (the -t mtet run's pseudo-GT
   among them) and on an icosphere with adversarial rays added (zero
   direction components, rays through shared vertices and edges, origins
   on box faces); its parity counts and ``bvh_closest``'s squared
   distances on one resample of the training labels, and the squared
   distances from points near the centre of the labels' icosphere and of
   the pseudo-GT (through the warp pass), on vertices, on edge midpoints,
   on duplicates and with a NaN point; ``bvh_hierarchy`` and ``bvh_refit``
   bitwise their plain versions on every traced mesh and on meshes of 1
   and 2 triangles; the box and triangle tests each query makes and the
   parts of the tree the queries read (an instrumented build, with the
   first one-thread ``bvh_closest``), and the two-pass query's own tests;
   each kernel's device time (a CUDA graph of raw launches) beside its
   bound, its plain version's time and its first design's (``BVH_FIRST``:
   both ``bvh_ray`` modes and ``bvh_hierarchy`` bitwise the designs while
   timed), the nodes ``bvh_hierarchy`` gave its warp pass, ``bvh_closest`` and ``bvh_refit`` also on the centre sets
   and the flat ladder's largest mesh; and one build call split into its
   parts (Morton keys, sort, leaf gather, ``box_pad``'s read to the host,
   hierarchy and refit calls);
11. the device engine's kernels against their plain versions, bit for
   bit, at sphere-small's and sphere-large's shapes: the lattice encode
   (K2, one launch for every level) at the M^3 skeleton lattice with its
   derivatives, and every stage call of the skeleton (K3), of the final
   insertion and of the busiest hidden one (K4, K5), recorded from a run
   of the engine; each kernel's device time (CUDA graphs), its plain
   version's and its bound (bytes at 3.35 TB/s, or K2's operations at
   33.5 TFLOP/s: the bytes the function needs, not the traffic of K5's
   column table and counts, which is printed apart; K3's the whole
   skeleton's, ``k3_bytes``, with the first design's stage-sum figure on
   a line of its own); the redesigned K2 and K5 calls (the column table, the pair
   scan's two passes, the row compaction) also held bitwise and timed in
   their first designs' builds (``cuda_build.LATTICE_FIRST``,
   ``DEVICE_ENGINE_FIRST``) in the same call, and the compaction beside
   ``index_select`` on the same rows (K5's ``compact_rows_library_ms``,
   against its ``compact_rows_ms``: one library call computes the
   compaction, none the whole of K5, whose ``library_ms`` stays null);
   K3's whole skeleton, dist and sign, bitwise in both designs and the
   plain versions, its first design's stage calls (the two torch.cumsum
   calls among them) recorded from its own run and timed, its launches,
   and the three-axis pool beside ``max_pool3d`` (``pool_library_ms``;
   K3's ``library_ms`` stays null); the distance skeleton split by CUDA
   events in both designs (the corner tables, K2, the MLP and its
   tangents, the sdf and |grad|, K3 with the read); K4's stage calls in
   both designs, each recorded from its own build's run (the first
   design's torch.cumsum a stage), held bitwise to the plain versions, as
   recorded and with the sign override planted, the design's also after
   three replays of a CUDA graph of one call, timed, with the launches of
   each build's run (3 or 4 a busy insertion) and the bound ``k4_bytes``;
   how often the override fires at the busy insertions (also sphere-medium's,
   in phase 12);
11b. K4c (the selection in ``split_select``'s curved instance,
   ``curved_roots``, ``curved_resolve``, ``curved_filter``, and K4's finish
   alone on the survivors) at sphere-medium curved: every call of the
   busiest curved insertion and of the final one, recorded from a run of
   the engine, bitwise its plain version in the design (also after three
   replays of a CUDA graph of one call) and in K4c's first design
   (``cuda_build.CURVED_FIRST``, through the same calls: ``curved_select``
   after the flat selection, ``curved_pick``, K7 and ``curved_points``,
   ``curved_gd`` then ``curved_mix``, the filter a thread a row, the
   finish with its own override test), and planted calls with rescued
   rows (``curved_gd``, then the rescue's ``curved_mix``), strict drops and
   the override firing (and the finish on those survivors); each kernel's
   device time (CUDA graphs) in both designs (the selection's whole,
   against the flat selection's bytes and the curved rows', and less the
   flat selection, against the curved rows' bytes or the first design's
   pass of its own; ``curved_roots`` and ``curved_gd`` also as a pair at
   the final insertion), its plain version's and its bound
   (``k4c_bound_ms``: ``curved_roots`` also against K7's operations) beside
   a graph node's floor, and ``index_select`` of the filter's survivors'
   rows;
11c. a rescue on the card: the x30000 kinked net of the CPU tests' GD
   fixture from the port's own seeded init (``kinked_net``), its curved
   loop from the device skeleton bitwise the host engine's (vertices,
   outputs, edges and failover counters) with rows rescued, and K4c's
   launches there (the rescue's ``curved_mix`` and second filter among
   them);
11d. K6 (``final_keep``, ``face_keys``, ``face_regions``, ``face_fans``,
   ``csrc/faces.cu``) at sphere-small flat, sphere-medium curved and
   sphere-large flat, in the design and in the first design of face_keys
   and face_fans (``cuda_build.FACES_FIRST``): every stage call of
   ``Engine.faces``, recorded from a run of each build's engine, bitwise
   its plain version, also after three replays of a CUDA graph of one
   call, and the planted calls of ``tests/faces_cases.py`` in both builds
   (duplicate regions in an A, B, A signature run, repeated ids, 1, 2, 8,
   9, 12 and 100 members, exact score ties, cell offsets -1, 0 and M - 1,
   five tiles of vertices with every zero count, five tiles of region
   slots, one kept region and none); the two builds' faces bitwise equal;
   at sphere-large both against the JAX package's device faces
   (``LARGE_DEVICE_FACES``, the first design first): the vertices within
   1e-5 index for index, the fan contract at 0.5 % or JAX's own host
   against device share, whichever is larger, and every fan that differs
   its polygon started at another vertex, the start K6's score gives on
   JAX's vertices, or with the members at the sort's wrap moved
   (``faces_cases.golden_ties``); the stage's result against the host
   faces (``extract_skeleton`` + ``extract_faces``) on the same loop
   output: the vertices bitwise, the counts exactly, the fan contract (at
   most 0.5 % of the rows differ, 1 % at sphere-large), and every fan that
   differs the same polygon started at another vertex, each member that
   crossed the angular sort's cut within two fixed-point steps of it
   (``faces_cases.fan_ties``); each kernel's device time (CUDA graphs, its
   calls summed) beside its bound (``k6_bytes`` at 3.35 TB/s), a graph
   node's floor and its plain version's time, face_keys' and face_fans'
   beside their first designs', ``face_keys``' vertex gather beside
   ``index_select`` on the same rows; the faces stage's span (CUDA
   events), launches and device time by kernel (torch.profiler) in each
   build;
12. sphere-medium and sphere-large, flat, at full width from the committed
   checkpoints: the funnel within 0.5 % of the JAX CLI's (K6's launches,
   two of each kernel), the same final
   vertex set from the dist and sign skeletons, the loop bitwise the host
   engine's from the device skeleton, the skeleton / loop / faces split;
   and sphere-medium's curved loop from the device skeleton bitwise the
   host engine's (vertices, outputs, edges and failover counters);
13. one JSON line of kernel records, the card's line, and the result line.

It exits non-zero without a result line when CUDA is unavailable or the
package is missing.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import re
import subprocess
import sys
import time

# the evaluation stage timers read this when the package is imported
os.environ["TROPICAL_PROFILE"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_F32_OPS = 67e12
# an unfused f32 product or sum issues as one instruction, at half the rate
# the FMA-counting peak gives
PEAK_F32_UNFUSED_OPS = PEAK_F32_OPS / 2
PEAK_BYTES = 3.35e12

GOLDEN = {"pre_v": 51455, "pre_e": 69581, "post_v": 10138, "post_e": 20396,
          "n_faces": 20336}
MAIN_ARGV = ["-e", "-m", "small", "-d", "sphere", "-s", "1", "--gt_res", "128"]
# tests/golden/self_golden.json "sphere_medium_curved"
CURVED_GOLDEN = {"pre_v": 154654, "pre_e": 231531, "post_v": 43493,
                 "post_e": 87795, "n_faces": 87142}
CURVED_ARGV = ["-e", "-m", "medium", "-d", "sphere", "-s", "1", "-f",
               "--gt_res", "128"]
# the port's own curved funnel through its device engine on the card (PR
# 17 on; eps-boundary flips move it from the JAX CLI's)
CURVED_DEVICE = {"pre_v": 97984, "pre_e": 176224, "post_v": 43487,
                 "post_e": 87783, "n_faces": 87123}
# the JAX host engine's vertices of that extraction (scripts/curved_golden.py)
CURVED_VERTICES = "tests/golden/sphere_medium_curved_vertices.npy"
# the JAX CLI's flat funnels through its own device engine (dist skeleton),
# the route the CLI takes (scripts/flat_golden.py); sphere-small's
# post-filter counts are GOLDEN's, its "A/B" those of the distance skeleton
FLAT_PRESETS = "tests/golden/sphere_flat_presets.json"
# "Ours" plus the seven MC rows 16..64 below the 128 pseudo-GT, two
# nearest-neighbour searches each; the device engine's kernels on the flat
# extraction (4 busy insertions on sphere-small): the lattice encode once
# for every level, the skeleton's 6 launches (2 pools, the words with the
# third axis's max, the flags, the scan, the compaction), then K4's and K5's
# a busy insertion (K4: the selection, the override's check and the finish,
# 3 a busy insertion, and the starting pools' edge words; K5: 15 a hidden
# one, 5 the final, 2 for the starting pools)
MAIN_LAUNCHES = {"min_dist": 16, "trilinear_roots": 0, "lattice_encode": 1,
                 "skeleton_mark": 6, "split_step": 13, "connect_step": 52,
                 "curved_select": 0, "curved_roots": 0, "curved_resolve": 0,
                 "curved_filter": 0, "final_keep": 2, "face_keys": 2,
                 "face_regions": 2, "face_fans": 2}
# K6, the final filter and the faces (csrc/faces.cu), and the lines of the
# JAX engine each replaces (make_extract_fn._run); each launches twice an
# extraction on every path: final_keep a vertex pass and an edge pass,
# face_keys its count and its fill, face_regions the runs and the
# duplicates, face_fans its count and its fill
K6 = ("final_keep", "face_keys", "face_regions", "face_fans")
K6_LAUNCHES = 2
# phase 11d's runs: (sphere preset, flat, the records' key suffix, the
# share of the fan contract against the host faces: 0.53 % of sphere-large's
# rows differed on an H100, its complex finer, each a fan started at another
# vertex of its polygon, which fan_ties holds)
K6_RUNS = (("small", True, "", 0.005),
           ("medium", False, "_medium_curved", 0.005),
           ("large", True, "_large", 0.01))
K6_REPLACES = {"final_keep": "tropical/extract/device.py:1444",
               "face_keys": "tropical/extract/device.py:1527",
               "face_regions": "tropical/extract/device.py:1562",
               "face_fans": "tropical/extract/device.py:1681"}
# the stage functions of tropical_torch/extract/device.py and their kernels:
# the design's, then the first design's of face_keys and face_fans
# (cuda_build.FACES_FIRST: a thread an item, the caller's torch.cumsum and
# torch.sort of the zero counts between them)
K6_STAGES = {"final_keep": "final_keep", "face_keys_count": "face_keys",
             "face_keys_fill": "face_keys",
             "face_regions_runs": "face_regions",
             "face_regions_dups": "face_regions",
             "face_fans_count": "face_fans", "face_fans_fill": "face_fans"}
K6_FIRST_STAGES = {"final_keep": "final_keep",
                   "face_keys_count_first": "face_keys",
                   "face_keys_fill_first": "face_keys",
                   "face_regions_runs": "face_regions",
                   "face_regions_dups": "face_regions",
                   "face_fans_count_first": "face_fans",
                   "face_fans_fill_first": "face_fans"}
# K6's redesigned kernels, timed beside their first designs
K6_REDESIGNED = ("face_keys", "face_fans")
# the JAX package's device faces of sphere-large (its fused program's
# triangles, each row sorted, and vertices; the rows in which its host
# faces differ; scripts/device_faces_golden.py), and the bounds phase 11d
# holds K6's -large output to: the vertices index for index, the fan
# contract at 0.5 % or at JAX's own host-against-device share, whichever is
# larger
LARGE_DEVICE_FACES = "tests/golden/sphere_large_device_faces.npz"
GOLDEN_VERTEX_ERR = 1e-5
GOLDEN_SHARE = 0.005
# the JAX CLI's curved funnels through its own device engine (dist
# skeleton), the route the curved CLI takes (scripts/curved_presets_golden.py)
CURVED_PRESETS = "tests/golden/sphere_curved_presets.json"
# K4c, the curved insertion's kernels (csrc/device_engine.cu), and their
# launches on the curved path: a busy insertion's curved_filter's two (the
# override's test, the strict filter); at an insertion with curved rows one
# curved_roots (K7's solve on the corner forward, and the roots' points)
# and one curved_resolve (the residuals, the rescue's rows and the mix as
# without a rescue); at one with rescued rows also the mix after the rescue
# and the filter's two again.  The curved selection runs inside
# split_select's curved instance (a K4 launch); curved_select, its first
# design's pass of its own (cuda_build.CURVED_FIRST), launches nowhere on
# the path
CURVED_KERNELS = ("curved_select", "curved_roots", "curved_resolve",
                  "curved_filter")
CURVED_PER_BUSY = {"curved_select": 0, "curved_filter": 2}
CURVED_PER_STEP = {"curved_roots": 1, "curved_resolve": 1}
CURVED_PER_RESCUE = {"curved_resolve": 1, "curved_filter": 2}
# K4's launches a busy insertion on the curved path: the selection (its
# curved instance) and the finish alone (no second override test)
K4_PER_CURVED_BUSY = 2
# the stage functions of tropical_torch/extract/device.py that launch each
# (K4's selection and finish recorded beside them: the curved selection,
# and the finish the filter's survivors take)
K4C_STAGES = {"curved_roots": "curved_roots", "curved_gd": "curved_resolve",
              "curved_mix": "curved_resolve", "curved_filter": "curved_filter"}
K4C_ROUTE = ("split_select", "split_finish", *K4C_STAGES)
# the bytes a curved row's selection writes: its slot and plane, its ends
# [2, 3] and its corners [8, 3]
CURVED_ROW_BYTES = 4 + 4 + 24 + 96
# the device engine's extractions in phase 4b (torch.profiler: host syncs,
# device-to-host copies, kernel launches; host reads): sphere-small flat,
# and sphere-medium curved, whose one insertion with curved rows launches
# curved_roots and curved_gd (K4c's first design: curved_pick, K7,
# curved_points, curved_gd and curved_mix) and reads the count words once
# after the strict filter; the faces (K6) read the count vector twice
ENGINE_COUNTS = {"small flat": (10, 8, 400, 8),
                 "medium curved": (15, 13, 405, 13)}
# stage 3b of the JAX engine's busy insertion and its strict filter;
# curved_roots also replaces K7's launch (tropical/core/trilinear.py:91)
# and the roots' points (:612)
K4C_REPLACES = {"curved_select": "tropical/extract/device.py:567",
                "curved_roots": "tropical/extract/device.py:603",
                "curved_resolve": "tropical/extract/device.py:612",
                "curved_filter": "tropical/extract/device.py:701"}
# the bytes a curved row's curved_roots needs: its plane, p and q (the
# corner forward's 16 values) and ends read, its root and point written
CURVED_ROOTS_ROW_BYTES = 4 + 64 + 24 + 12 + 12
# the bytes a curved row's curved_gd needs: the outputs at the plane and at
# idx, the plane and the root read, the residuals and the rank written
# (36), and the mix's: the slot and the ends read, the vertex and the state
# written (44); a rescued row's ends read and its start, direction, plane
# and root written (64); curved_mix after a rescue: a row's slot, ends,
# rank, root and residual at the plane read, vertex and state written
CURVED_GD_ROW_BYTES, CURVED_GD_RESCUED_BYTES = 36 + 44, 24 + 40
CURVED_MIX_ROW_BYTES = 64
# the x30000 kinked net of tests/test_device_curved.py's GD fixture
# (_kinked_net(r_max=6, levels=3, scale=30000)), from the port's own init
# with this seed, whose curved insertions rescue rows
KINKED_SPEC = {"num_layers": 3, "num_hidden": 16, "levels": 3, "r_min": 2,
               "r_max": 6, "T": 19}
KINKED_SCALE, KINKED_SEED = 30000.0, 0
# each kernel's time before its redesign, for the printed comparison only
# (H100 80GB HBM3, 700 W; min_dist at 100k x 100k, trilinear_roots' device
# time at the curved run's largest input, B = 8,460)
PREV_MS = {"min_dist": 4.486, "trilinear_roots": 0.0563}
# the encode kernels' device times before their redesigns, by B (H100 80GB
# HBM3, 700 W; for the printed comparison only)
PREV_ENCODE_MS = {"hashgrid_encode_fwd": {1000: 0.0054, 10171: 0.0065,
                                          278528: 0.0440},
                  "hashgrid_encode_bwd": {1000: 0.0147, 278528: 3.007},
                  "hashgrid_encode_bwd_bwd": {1000: 0.0134, 278528: 3.014}}
# the flat run's largest forward is its first marching-cubes slab at 128
# (SLAB + 1 x-planes of 128 x 128 points; later slabs evaluate SLAB, the
# shared plane reused); the one timed has SLAB + 1 planes from this x
# index, through the middle of the sphere
SLAB_RES, SLAB_X0 = 128, 48

EXACT_COUNT = ("min_dist", ("MIN_DIST_COUNT_EXACT",))
ENCODE = ("hashgrid_encode_fwd", "hashgrid_encode_bwd",
          "hashgrid_encode_bwd_bwd")
ENCODE_REPLACES = {"hashgrid_encode_fwd": "tropical/core/hashgrid.py:163",
                   "hashgrid_encode_bwd": "tropical/stanford/training.py:42",
                   "hashgrid_encode_bwd_bwd": "tropical/stanford/training.py:65"}
# float operations a (point, level) of each encode kernel, unfused (counted
# in csrc/hashgrid_encode.cu: the cell, then per corner the weight, the
# gather's products and sums, the gradients' products and sums)
ENCODE_OPS = {"hashgrid_encode_fwd": 61, "hashgrid_encode_bwd": 150,
              "hashgrid_encode_bwd_bwd": 250}
# the table gradients are atomicAdd scatters in a free order (and so is
# index_add_, the plain version's, on the card): a row that sums n terms in
# another order moves by about 2^-24 sqrt(n) of its size, and a row takes
# at most one term a point and corner.  Held: within SCATTER_ULPS 2^-24
# sqrt(B) of the plain version's largest row (measured 0.3 to 1.0 of
# 2^-24 sqrt(B) at B = 1,000 and 278,528)
SCATTER_ULPS = 4.0
# encode launches of the flat and curved CLI runs, one a net evaluation
# with rows and one backward a normal() call (counted on the CPU with the
# plain versions): flat, 5 forwards in the extraction (4 busy insertions'
# new vertices and the faces' normals; the skeleton takes the lattice
# encode) and 27 in the MC ladder (the largest, 278,528 rows, a slab at
# 128), the faces' normals once; curved (the device engine), the faces'
# normals and the 27 of the ladder (``CURVED_ENCODE``), and in the loop a
# forward a busy insertion, two an insertion with curved rows (the corners
# and the roots' points: 3 busy insertions and 1 with curved rows on the
# CPU), one forward and one backward a step of the GD rescue
# (``failover.COUNTERS``; no step on the CPU) and one more forward of the
# new vertices an insertion with rescued rows
FLAT_ENCODE = {"hashgrid_encode_fwd": 32, "hashgrid_encode_bwd": 1,
               "hashgrid_encode_bwd_bwd": 0}
CURVED_ENCODE = {"hashgrid_encode_fwd": 28, "hashgrid_encode_bwd": 1,
                 "hashgrid_encode_bwd_bwd": 0}
TRAIN_GOLDEN = "tests/golden/sphere_small_train_1.npz"
TRAIN_EPOCHS, TRAIN_BATCH, TRAIN_SEED = 10, 1000, 1
# a step: the forward, the backward for J and for the loss, and the double
# backward the eikonal term's create_graph adds
STEP_LAUNCHES = {"hashgrid_encode_fwd": 1, "hashgrid_encode_bwd": 2,
                 "hashgrid_encode_bwd_bwd": 1}
# the port's losses are held per window of this many steps
WINDOW = 10
CLI_TRAIN_ARGV = ["-c", "-m", "small", "-d", "sphere", "-s", "1",
                  "--epochs", "1"]
# the evaluate CLI on phase 4's mesh: -t mtet at its default --gt_res (256)
# and -t mc at 128, held to the JAX CLI's tables on the committed mesh
# (scripts/evaluate_golden.py, JAX on the CPU, 100,000 rays)
EVAL_ARGV = {"mtet": ["-d", "sphere", "-m", "small", "-s", "1", "-t", "mtet"],
             "mc": ["-d", "sphere", "-m", "small", "-s", "1", "-t", "mc",
                    "--gt_res", "128"]}
EVAL_GOLDEN = "tests/golden/sphere_small_evaluate_1.json"
# a row: CD and AD, unrounded, to these of the golden's: the CD of JAX's
# samples with exact nearest neighbours ("cd_nn"; JAX's own CD lies up to
# some 1e-6 above it, its search picking neighbours by the expanded form),
# JAX's AD.  The "Ours" row scores the port's mesh, not the JAX mesh of
# the golden: the golden's "ours_port_mesh" measures the gap between the
# two meshes' "Ours" CD on the CPU at 256 with 100,000 rays, far inside
# the same 1e-6.  A row's vertex count is exact.  A grid value exactly 0 in the port's field and
# not in JAX's (f32 rounding of the MLP; sphere-small at 256 has one, on
# the CPU and on the card, where JAX's value is 4.47e-8) moves the vertices
# at that point: such a row is rebuilt with JAX's value there (the
# golden's "near_zero"), and that count must be the golden's
EVAL_CD_TOL, EVAL_AD_TOL = 1e-6, 0.1
# the card's marching-tetrahedra meshes against the committed TPU-written
# ones: the same topology, vertices within this (JAX on the CPU reproduces
# them to 3.5e-5, tests/test_torch_isosurface.py)
COMMITTED_MT_TOL = 1e-4
MT_BITWISE_RES = 48
# the -t mtet run's pseudo-GT (the CLI's default for small)
EVAL_GT_RES = 256
BVH = ("bvh_hierarchy", "bvh_refit", "bvh_ray", "bvh_closest")
# the instrumented build that counts the queries' box and triangle tests
# (its bvh_closest the first design, one thread a point: the yardstick of
# the bound), and the one that counts the two-pass bvh_closest's own
BVH_COUNT = ("bvh", ("BVH_COUNT_VISITS",))
BVH_COUNT_DESIGN = ("bvh", ("BVH_COUNT_VISITS", "BVH_COUNT_DESIGN"))
# the first designs of the four BVH kernels, timed beside the redesigns
BVH_FIRST = ("bvh", ("BVH_CLOSEST_ONE_THREAD", "BVH_REFIT_FENCES",
                     "BVH_RAY_ONE_THREAD", "BVH_HIERARCHY_ONE_THREAD"))
# closest-point sets (tests/bvh_cases.py): points within 0.05 of the
# centre of the labels' icosphere (with vertices, edge midpoints, duplicates
# and a NaN point, as many each) and of the 256 pseudo-GT; their seed
BVH_CENTRE_LABELS, BVH_CENTRE_GT, BVH_SET_SEED = 2000, 256, 11
BVH_REPLACES = {"bvh_hierarchy": "tropical/csrc/bvh.cpp:207",
                "bvh_refit": "tropical/csrc/bvh.cpp:207",
                "bvh_ray": "tropical/ops/mesh_queries.py:170",
                "bvh_closest": "tropical/ops/mesh_queries.py:123"}
# float operations of one box test and one triangle test (counted in
# csrc/bvh.cu: box_entry with its caller's two compares, ray_tri_t with the
# hit update; box_dist2 with its compare, closest_dist2 on its longest
# branch, the interior)
BVH_RAY_OPS = (45, 60)
BVH_CLOSEST_OPS = (18, 97)
# the device extraction engine's kernels (csrc/lattice_encode.cu,
# csrc/device_engine.cu), the JAX programs each replaces, and the stage
# functions of tropical_torch/extract/device.py that launch each
DEVICE_ENGINE = ("lattice_encode", "skeleton_mark", "split_step",
                 "connect_step")
DEVICE_ENGINE_SOURCE = {"lattice_encode": "tropical_torch/csrc/lattice_encode.cu"}
DEVICE_ENGINE_REPLACES = {
    "lattice_encode": "tropical/core/hashgrid.py:232",
    "skeleton_mark": "tropical/extract/device.py:2092",
    "split_step": "tropical/extract/device.py:506",
    "connect_step": "tropical/extract/device.py:858"}
# the redesigned K5 stages, timed beside their first designs (which build no
# column table)
REDESIGNED_STAGES = ("connect_table", "connect_count", "connect_fill",
                     "compact_rows")
# K3's stages, and its first design's (cuda_build.DEVICE_ENGINE_FIRST: no
# plain versions of their own, their whole skeleton held to the design's)
K3_STAGES = ("skeleton_pool", "skeleton_words", "skeleton_flags",
             "skeleton_scan", "skeleton_compact")
K3_FIRST_STAGES = ("skeleton_pool", "skeleton_points", "skeleton_edges",
                   "skeleton_cumsum", "skeleton_squeeze")
# the first design's skeleton launches, dist mode (3 pools, the points, the
# edges, the squeeze; the design's are MAIN_LAUNCHES')
K3_FIRST_LAUNCHES = 6
# K4's stages, the design's (split_select, split_finish) and its first
# design's (cuda_build.DEVICE_ENGINE_FIRST: split_mark, the torch.cumsum,
# split_lerp, split_override, split_append), which each build's run records
# from its own engine; the first design's launches on the flat path (4 a
# busy insertion and the starting pools' edge words)
K4_STAGES = ("pack_words", "edge_words", "split_select", "split_finish",
             "split_mark", "split_cumsum", "split_lerp", "split_override",
             "split_append")
K4_FIRST_LAUNCHES = 17
DEVICE_STAGES = {
    **{name: "skeleton_mark" for name in K3_STAGES + K3_FIRST_STAGES},
    **{name: "split_step" for name in K4_STAGES},
    "hit_mark": "connect_step", "candidates": "connect_step",
    "connect_table": "connect_step", "connect_count": "connect_step",
    "connect_fill": "connect_step",
    "census_edges": "connect_step", "census_vertices": "connect_step",
    "compact_rows": "connect_step", "compact_edges": "connect_step"}
# the float operations of a lattice point and level of the lattice encode
# (csrc/lattice_encode.cu: 3 axes' weights of 4, then 7 two-term
# contractions of 3 a feature; with the derivatives 11 more contractions)
LATTICE_OPS = (12 + 7 * 3 * 2, 12 + 18 * 3 * 2)
# the evaluation's rays a mesh (get_rays' default generator)
EVAL_RAYS = 100_000
# the adversarial icosphere: its subdivisions, and the seeds of the
# adversarial sets (tests/bvh_cases.py) added to the evaluation's rays
BVH_ICOSPHERE, BVH_ADVERSARIAL_SEEDS = 4, range(20)


class Tee(io.TextIOBase):
    """Write to stdout and keep a copy."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def check(ok, message):
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def phase(name):
    print(f"\n=== {name} ===", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``iters`` calls, CUDA events."""
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


def graph_ms(fn, reps: int = 100) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, so the host's work per call is not timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, iters=10) / reps


def device_phase():
    phase("1. device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device count {torch.cuda.device_count()}")
    print(f"device: {name}")
    print(smi)
    return name, smi


def build_phase():
    phase("2. build")
    from tropical_torch.ops import cuda_build

    t = time.time()
    targets = ["min_dist", EXACT_COUNT, "trilinear_roots", "hashgrid_encode",
               "bvh", BVH_COUNT, BVH_COUNT_DESIGN, BVH_FIRST, "lattice_encode",
               "device_engine", cuda_build.LATTICE_FIRST,
               cuda_build.DEVICE_ENGINE_FIRST, cuda_build.CURVED_FIRST,
               cuda_build.FACES_FIRST]
    logs = cuda_build.build(targets)
    for target in targets:
        name = cuda_build.label(target)
        print(f"--- {name} ({cuda_build.library_path(target).name})")
        print(logs[name].strip() or "(already built)")
        spills = [int(v) for v in re.findall(r"(\d+) bytes spill", logs[name])]
        check(not any(spills), f"{name}: register spills {spills}")
    print(f"build {time.time() - t:.1f} s")


def min_dist_bound_ms(n: int, m: int) -> tuple[float, str]:
    """Least time for the nearest-neighbour search: 8 f32 operations per
    pair (3 sub, 3 mul, 2 add) against the bytes read and written once."""
    ops = 8.0 * n * m
    nbytes = (n + m) * 3 * 4 + n * (4 + 4)
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sphere_points(n, rng, dev):
    # first-hit samples lie on a surface of radius ~0.6
    p = rng.normal(size=(n, 3))
    p = 0.6 * p / np.linalg.norm(p, axis=1, keepdims=True)
    return torch.from_numpy(p.astype(np.float32)).to(dev)


def kernel_phase():
    phase("3. kernels vs plain")
    return [min_dist_phase(), trilinear_roots_phase(), *encode_phase()]


def min_dist_phase():
    print("--- min_dist")
    from tropical_torch.ops import chamfer as ch
    from tropical_torch.ops import cuda_build

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    def pts(n):
        return sphere_points(n, rng, dev)

    x, y = pts(100_000), pts(100_000)
    cases = {"100000x100000": (x, y),
             "99871x100003": (pts(99_871), pts(100_003))}
    dup = pts(50_000)
    cases["duplicates 60000x100000"] = (dup[:60_000 // 2].repeat(2, 1),
                                        torch.cat([dup, dup]))
    # a cloud offset by +100 with nearest distances ~1e-3: |y|^2 - 2 x.y
    # cancels, and the filter's margin lets most pairs through
    off = torch.from_numpy(
        (100.0 + rng.uniform(0.0, 0.03, size=(50_000, 3))).astype(np.float32))
    cases["offset cloud 20000x30000"] = (off[:20_000].to(dev),
                                         off[20_000:].to(dev))
    # points mirrored across z = 0.3, looked up from the plane: near-ties
    q = rng.uniform(-0.5, 0.5, size=(30_000, 3)).astype(np.float32)
    q[:, 2] = 0.3 + np.abs(q[:, 2])
    mirrored = q.copy()
    mirrored[:, 2] = np.float32(0.6) - q[:, 2]
    on_plane = rng.uniform(-0.5, 0.5, size=(30_000, 3)).astype(np.float32)
    on_plane[:, 2] = 0.3
    cases["mirrored near-ties 30000x60000"] = (
        torch.from_numpy(on_plane).to(dev),
        torch.from_numpy(np.concatenate([q, mirrored])).to(dev))

    max_err = 0.0
    results = {}
    for label, (a, b) in cases.items():
        d2, idx = results[label] = ch.min_nn_distance(a, b)  # CUDA -> kernel
        torch.cuda.synchronize()
        p2, pidx = ch.min_dist_plain(a, b)
        err = float((d2 - p2).abs().max())
        max_err = max(max_err, err)
        bits = int((d2.view(torch.int32) != p2.view(torch.int32)).sum())
        mismatches = int((idx != pidx).sum())
        print(f"{label}: max |d2 - plain| = {err:.3e}, d2 bit mismatches "
              f"{bits}, index mismatches {mismatches}")
        check(bits == 0, f"{label}: kernel d2 differs from plain in {bits} rows")
        check(mismatches == 0,
              f"{label}: kernel index differs from plain in {mismatches} rows")

    n, m = x.shape[0], y.shape[0]
    lib = cuda_build.load("min_dist")
    cfg = ch.kernel_config(lib, 0)
    splits, per_split = ch.split_plan(n, m, cfg["sms"], cfg["resident"],
                                      cfg["rows_per_block"], cfg["panel"])
    plan = {"R": cfg["rows_per_block"] // cfg["threads"], "S": splits,
            "panel": cfg["panel"], "threads": cfg["threads"],
            "group": cfg["group"], "panels_per_split": per_split,
            "sms": cfg["sms"], "blocks_per_sm": cfg["resident"]}
    print(f"min_dist {n}x{m} launch plan: {json.dumps(plan)}")

    # the exact path's share, from the instrumented build (not the main path's)
    counted = cuda_build.load(EXACT_COUNT)
    counts = (ctypes.c_ulonglong * 4)()
    counted.min_dist_exact_counts.argtypes = [ctypes.c_void_p]
    counted.min_dist_exact_counts.restype = ctypes.c_int
    check(counted.min_dist_exact_counts(counts) == 0, "exact counters reset")
    d2c, idxc = ch.run_kernel(counted, x, y)
    torch.cuda.synchronize()
    check(counted.min_dist_exact_counts(counts) == 0, "exact counters read")
    warp_groups, warp_exact, row_groups, row_walks = list(counts)
    check(torch.equal(d2c, results["100000x100000"][0])
          and torch.equal(idxc, results["100000x100000"][1]),
          "the instrumented build disagrees with the kernel")
    exact_share = {"warp_groups": warp_groups, "warp_groups_exact": warp_exact,
                   "warp_share": warp_exact / max(1, warp_groups),
                   "row_groups": row_groups, "row_walks": row_walks,
                   "row_share": row_walks / max(1, row_groups)}
    print(f"min_dist {n}x{m} exact path: {json.dumps(exact_share)}")

    ms = cuda_ms(lambda: ch.min_nn_distance(x, y), iters=20, warmup=2)
    plain_ms = cuda_ms(lambda: ch.min_dist_plain(x, y), iters=3)

    def library():
        # torch.cdist + min, chunked over x: the yardstick, not used by the port
        for r0 in range(0, n, 8192):
            torch.cdist(x[r0:r0 + 8192], y).min(dim=1)

    library_ms = cuda_ms(library, iters=3)
    bound_ms, bound_by = min_dist_bound_ms(n, m)
    print(f"min_dist {n}x{m}: kernel {ms:.3f} ms (before the redesign "
          f"{PREV_MS['min_dist']} ms), plain {plain_ms:.3f} ms, cdist+min "
          f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); kernel "
          f"at {bound_ms / ms:.1%} of the bound")
    return {"name": "min_dist", "route": "cuda",
            "source": "tropical_torch/csrc/min_dist.cu",
            "replaces": "tropical/ops/chamfer_tpu.py:83",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "shape": [n, m], "plan": plan,
            "exact_share": exact_share}


def seeded_rows():
    """100,000 seeded rows (p, q) on the card, a size the path does not
    reach."""
    rng = np.random.default_rng(7)
    return tuple(torch.from_numpy(rng.normal(size=(100_000, 8))
                                  .astype(np.float32)).cuda()
                 for _ in range(2))


def trilinear_roots_phase():
    print("--- trilinear_roots")
    sys.path.insert(0, "tests")
    import trilinear_cases as cases

    p, q, _ = cases.kernel_pq(n_random=0)
    sets = {f"hard cases ({p.shape[0]} rows)":
            tuple(torch.from_numpy(a).cuda() for a in (p, q)),
            "100000 seeded rows": seeded_rows()}
    max_err = max(roots_vs_plain(label, *pq) for label, pq in sets.items())
    return {"name": "trilinear_roots", "route": "cuda",
            "source": "tropical_torch/csrc/trilinear_roots.cu",
            "replaces": "tropical/core/trilinear.py:91",
            "max_abs_err": max_err}


def roots_vs_plain(label, p, q) -> float:
    """The kernel against its plain version on (p, q), to the bit; returns
    the largest absolute difference."""
    from tropical_torch.core import trilinear as tl

    out = tl.intersection_of_two_planes(p, q)  # CUDA -> kernel
    torch.cuda.synchronize()
    plain = tl.intersection_of_two_planes_plain(p, q)
    rows = int((out.view(torch.int32) != plain.view(torch.int32))
               .any(1).sum())
    err = float((out - plain).abs().max())
    sentinels = int((out[:, 0] == -1).sum())
    print(f"trilinear_roots {label}: max |out - plain| = {err:.3e}, rows "
          f"with a bit mismatch {rows}, x sentinels {sentinels}")
    check(rows == 0, f"{label}: kernel differs from plain in {rows} rows")
    return err


def trilinear_roots_ops(p: torch.Tensor, q: torch.Tensor) -> float:
    """The float operations the root solve of these rows needs, counted as
    in csrc/trilinear_roots.cu's note (134 for the coefficients and 20 for
    y; on a non-constant row 16 for the first samples, 19 a cell scanned,
    483 for the last bracket's bisection, 413 a probe and 482 more where it
    bisects a hidden pair).  They are unfused (one rounded product, sum or
    quotient each), so they run at PEAK_F32_UNFUSED_OPS."""
    from tropical_torch.core import roots as rt
    from tropical_torch.core import trilinear as tl

    c = tl.quartic_coeffs(p, q)
    c = torch.where(c.abs() < 1e-9, 0.0, c)
    ts = torch.arange(65, dtype=c.dtype, device=c.device) / 64
    vals, dco = rt._poly_eval(c, ts), rt._deriv(c)
    dvals = rt._poly_eval(dco, ts)
    nonconst = rt._abs_sum(c, 4) > 1e-9
    br, dbr = rt._brackets(vals, nonconst), rt._brackets(dvals, nonconst)
    has = br.any(-1)
    # the scan stops at the lower of the last bracket and the third-highest
    # derivative bracket, once it has both
    above = dbr.flip(1).cumsum(1).flip(1)   # derivative brackets >= a cell
    nd = above[:, 0].clamp(max=3)
    third = (above >= 3).sum(-1) - 1
    stop = torch.minimum(rt._last_true(br), third)
    cells = torch.where(has & (nd == 3), 64 - stop, 64)
    cross = torch.zeros_like(nd)
    cell_ids = torch.arange(64, device=c.device)
    for _ in range(3):  # probes with a hidden pair: one more bisection of p
        dhas = dbr.any(-1)
        didx = rt._last_true(dbr)
        dbr = dbr & (cell_ids[None, :] != didx[:, None])
        m = rt._bisect(dco, ts[didx], ts[didx + 1],
                       dvals.gather(1, didx[:, None])[:, 0])
        pm = rt._poly_eval(c, m[:, None])[:, 0]
        pr = vals.gather(1, didx[:, None] + 1)[:, 0]
        cross += (dhas & (pm * pr < 0)).long()
    per_row = 154 + nonconst.long() * (16 + 19 * cells + 483 * has.long()
                                       + 413 * nd + 482 * cross)
    return float(per_row.sum())


def trilinear_roots_bound_ms(p: torch.Tensor, q: torch.Tensor
                             ) -> tuple[float, str]:
    """Least time for the root solve of these rows: its operations
    (``trilinear_roots_ops``) against 76 bytes a row read and written
    once."""
    ops = trilinear_roots_ops(p, q)
    nbytes = 76.0 * p.shape[0]
    t_ops, t_bytes = ops / PEAK_F32_UNFUSED_OPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def shapes_phase(records, largest, curved_inputs, curved_take):
    """Each kernel at the largest shape its main path gave it."""
    phase("6. kernels at the main paths' largest shapes")
    from tropical_torch.ops import chamfer as ch

    rec = records["min_dist"]
    shape = largest["min_dist"]
    check(shape is not None, "the flat path recorded no min_dist shape")
    rng = np.random.default_rng(1)
    x = sphere_points(shape[0], rng, torch.device("cuda"))
    y = sphere_points(shape[1], rng, torch.device("cuda"))
    ms = cuda_ms(lambda: ch.min_nn_distance(x, y), iters=20, warmup=2)
    bound_ms, _ = min_dist_bound_ms(*shape)
    print(f"min_dist {shape[0]}x{shape[1]} (largest on the flat path): "
          f"kernel {ms:.3f} ms, bound {bound_ms:.3f} ms, at "
          f"{bound_ms / ms:.1%} of the bound")
    rec.update(main_shape=list(shape), main_ms=ms, main_bound_ms=bound_ms)
    trilinear_roots_timing(records["trilinear_roots"], curved_inputs,
                           curved_take)
    encode_at_largest(records, largest)


def trilinear_roots_timing(rec, inputs, extract_s):
    """``trilinear_roots`` on every input of the curved path: bitwise
    against its plain version, the summed device time beside the
    extraction's ``take``; then the largest input and the seeded rows
    timed (``solve_times``)."""
    from tropical_torch.core import trilinear as tl

    rows = [p.shape[0] for p, _ in inputs]
    for i, (p, q) in enumerate(inputs):
        label = f"curved input {i + 1}/{len(inputs)} ({rows[i]} rows)"
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 roots_vs_plain(label, p, q))
    total_ms = sum(graph_ms(lambda p=p, q=q: tl.intersection_of_two_planes(
        p, q)) for p, q in inputs)
    print(f"trilinear_roots on the curved run's {len(inputs)} inputs "
          f"({sum(rows)} rows): {total_ms:.4f} ms of device time summed, "
          f"against the extraction's take {extract_s} s "
          f"({total_ms / 1e3 / extract_s:.4%} of it)")
    largest = inputs[rows.index(max(rows))]
    rec.update(solve_times(*largest, prev_ms=PREV_MS["trilinear_roots"]),
               shape=[max(rows)], curved_rows=rows, curved_sum_ms=total_ms,
               extract_s=extract_s)
    # eigvals takes seconds a call here, and is warm
    rec["seeded_100000"] = solve_times(*seeded_rows(), library_iters=1,
                                       library_warmup=0)


def solve_times(p, q, prev_ms=None, library_iters=3, library_warmup=1):
    """Device time (``graph_ms``), one wrapper call as the path makes it
    (host work included), the plain version, ``eigvals`` and the bound of
    ``trilinear_roots`` on (p, q)."""
    from tropical_torch.core import trilinear as tl

    n = p.shape[0]
    ms = graph_ms(lambda: tl.intersection_of_two_planes(p, q))
    call_ms = cuda_ms(lambda: tl.intersection_of_two_planes(p, q), iters=50,
                      warmup=3)
    plain_ms = cuda_ms(lambda: tl.intersection_of_two_planes_plain(p, q),
                       iters=3)
    # the upstream solver: eigenvalues of the monic companion matrices
    # [B, 4, 4] (the yardstick, not used by the port)
    c = tl.quartic_coeffs(p, q)
    lead = torch.where(c[:, 0] == 0, 1.0, c[:, 0])
    comp = torch.zeros((n, 4, 4), dtype=torch.float32, device=p.device)
    comp[:, 0, :] = torch.nan_to_num(-c[:, 1:] / lead[:, None])
    comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1.0
    library_ms = cuda_ms(lambda: torch.linalg.eigvals(comp),
                         iters=library_iters, warmup=library_warmup)
    bound_ms, bound_by = trilinear_roots_bound_ms(p, q)
    before = "" if prev_ms is None else f" (before the redesign {prev_ms} ms)"
    print(f"trilinear_roots B={n}: kernel {ms:.4f} ms{before} (a wrapper "
          f"call {call_ms:.4f} ms), plain {plain_ms:.3f} ms, eigvals "
          f"{library_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}); kernel "
          f"at {bound_ms / ms:.1%} of the bound")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def encode_spec(size):
    from tropical_torch.stanford.model import net_for_size

    return net_for_size(size, device="cpu").spec.grid


def boundary_points(spec, n, rng):
    """n points on cell boundaries: on every axis, x s_l + 0.5 (in f32, two
    roundings) an integer for a level l drawn per point."""
    out = np.empty((0, 3), np.float32)
    while out.shape[0] < n:
        lv = rng.integers(0, spec.levels, 4 * n)
        s = np.array([spec.level_scale(int(l)) for l in lv], np.float32)[:, None]
        k = rng.integers(0, 40, (4 * n, 3)).astype(np.float32)
        x = ((k - np.float32(0.5)) / s).astype(np.float32)
        pos = (x * s).astype(np.float32) + np.float32(0.5)
        out = np.concatenate([out, x[(pos == np.floor(pos)).all(1)]])
    return out[:n]


def encode_inputs(spec, n, seed, kind="mixed"):
    """Seeded (table, x, dfeat, ddx) on the card.  Points ("mixed") over the
    unit cube and its margin (the extraction canvas reaches past it), a
    quarter on grid planes and faces; or ("one_cell") every point in one
    cell of every level, the table gradients' worst contention; or
    ("boundaries") on cell boundaries; or ("far") far outside the cube,
    where dense bases leave int32; or ("wrap", on the grid
    ``tests/encode_cases.WRAP_SPEC``) with bases at the int64 limit."""
    sys.path.insert(0, "tests")
    import encode_cases

    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    x[: n // 4] = np.round(x[: n // 4] * 4) / 4
    if kind == "one_cell":
        x[:] = np.float32([0.3141, 0.5926, 0.5358])
    elif kind == "boundaries":
        x = boundary_points(spec, n, rng)
    elif kind == "far":
        x = encode_cases.far_points(rng, n)
    elif kind == "wrap":
        x = encode_cases.wrap_points(n)
    table = (0.1 * rng.normal(size=(spec.n_entries, 2))).astype(np.float32)
    dfeat = rng.normal(size=(n, spec.levels * 2)).astype(np.float32)
    ddx = rng.normal(size=(n, 3)).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (table, x, dfeat, ddx))


def encode_vs_plain(recs, label, spec, table, x, dfeat, ddx):
    """The three kernels against their plain versions: features, dx,
    d_dfeat and dx2 to the bit, dtable and dtable2 within SCATTER_ULPS
    2^-24 sqrt(B) of the plain version's largest row.  Updates each record's
    max_abs_err."""
    from tropical_torch.core import hashgrid as hg

    feat = hg.hashgrid_encode_fwd(spec, table, x)
    dx, dt = hg.hashgrid_encode_bwd(spec, table, x, dfeat)
    # the x-only backward, as normal() and the GD rescue launch it
    dx_only, none = hg.hashgrid_encode_bwd(spec, table, x, dfeat,
                                           need_table=False)
    dd, dt2, dx2 = hg.hashgrid_encode_bwd_bwd(spec, table, x, dfeat, ddx)
    torch.cuda.synchronize()
    check(none is None, "an x-only backward returned a table gradient")
    pdx, pdt = hg.encode_backward_plain(spec, table, x, dfeat)
    pdd, pdt2, pdx2 = hg.encode_double_backward_plain(spec, table, x, dfeat,
                                                      ddx)
    pairs = {"feat": (feat, hg.encode_plain(spec, table, x)), "dx": (dx, pdx),
             "dx_only": (dx_only, pdx), "d_dfeat": (dd, pdd),
             "dx2": (dx2, pdx2)}
    bits = {k: int((a.view(torch.int32) != b.view(torch.int32)).sum())
            for k, (a, b) in pairs.items()}

    def err(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    def rel(a, b):
        return err(a, b) / max(float(b.abs().max()), 1e-30)

    scatter = {"dtable": rel(dt, pdt), "dtable2": rel(dt2, pdt2)}
    unit = 2.0 ** -24 * math.sqrt(max(x.shape[0], 1))
    tol = SCATTER_ULPS * unit
    print(f"encode {label}: bit mismatches {bits}; table gradients against "
          f"the plain version's largest row {scatter} (held to {tol:.3e}; "
          f"{max(scatter.values()) / unit:.3f} of 2^-24 sqrt(B))")
    check(not any(bits.values()), f"encode {label}: kernel differs from "
          f"plain: {bits}")
    check(all(v <= tol for v in scatter.values()),
          f"encode {label}: table gradients beyond {tol}: {scatter}")
    errs = {"hashgrid_encode_fwd": [err(*pairs["feat"])],
            "hashgrid_encode_bwd": [err(dx, pdx), err(dt, pdt)],
            "hashgrid_encode_bwd_bwd": [err(dd, pdd), err(dt2, pdt2),
                                        err(dx2, pdx2)]}
    for k, v in errs.items():
        recs[k]["max_abs_err"] = max(recs[k]["max_abs_err"], *v)
    for k, key in (("hashgrid_encode_bwd", "dtable"),
                   ("hashgrid_encode_bwd_bwd", "dtable2")):
        recs[k]["scatter_units_max"] = max(recs[k].get("scatter_units_max", 0.0),
                                           scatter[key] / unit)


def encode_phase():
    print("--- hashgrid encode: forward, backward, double backward")
    from tropical_torch.core import hashgrid as hg

    recs = {k: {"name": k, "route": "cuda",
                "source": "tropical_torch/csrc/hashgrid_encode.cu",
                "replaces": ENCODE_REPLACES[k], "max_abs_err": 0.0}
            for k in ENCODE}
    for size in ("small", "medium", "large"):
        spec = encode_spec(size)
        hashed = [l for l in range(spec.levels) if spec.level_uses_hash(l)]
        print(f"{size}: backwards' private levels {hg.private_levels(spec)} "
              f"({hg.private_rows(spec)} rows)")
        for n in (0, 1, 1000, 278528):
            encode_vs_plain(recs, f"{size} (hashed levels {hashed}) B={n}",
                            spec, *encode_inputs(spec, n, seed=n + 7))
    spec = encode_spec("small")
    for kind in ("one_cell", "boundaries"):
        for n in (1000, 278528):
            encode_vs_plain(recs, f"small {kind} B={n}", spec,
                            *encode_inputs(spec, n, seed=n + 5, kind=kind))
    # the forward's index arithmetic: its 32-bit remainder where the base
    # fits, the 64-bit one where it does not, a remainder a corner where a
    # corner's index wraps past the int64 limit
    encode_vs_plain(recs, "small far outside the cube (bases past int32) "
                    "B=1000", spec, *encode_inputs(spec, 1000, seed=17,
                                                   kind="far"))
    sys.path.insert(0, "tests")
    import encode_cases

    wrap = hg.HashGridSpec(**encode_cases.WRAP_SPEC)
    encode_vs_plain(recs, "one level, bases at the int64 limit B=64", wrap,
                    *encode_inputs(wrap, 64, seed=19, kind="wrap"))
    # level counts that are no power of two, or one, or many; a ragged B
    for levels in (1, 5, 16):
        lspec = hg.HashGridSpec(levels=levels, n_min=2, n_max=32,
                                log2_table=12)
        encode_vs_plain(recs, f"{levels} levels B=1001", lspec,
                        *encode_inputs(lspec, 1001, seed=levels))
    encode_vs_plain(recs, "small ragged B=100003", spec,
                    *encode_inputs(spec, 100_003, seed=23))
    for k, v in encode_times(spec, *encode_inputs(spec, 1000, seed=3)).items():
        recs[k].update(v)
    floor_ms = graph_floor_ms()
    print(f"a CUDA graph's node floor (a one-element in-place add, "
          f"graph_ms): {floor_ms:.5f} ms; the kernels above at B=1000 over "
          f"it: " + ", ".join(f"{k} {recs[k]['ms'] - floor_ms:+.5f} ms"
                              for k in ENCODE))
    recs["hashgrid_encode_fwd"]["graph_floor_ms"] = floor_ms
    return list(recs.values())


def graph_floor_ms() -> float:
    """What one kernel node of a CUDA graph costs on this card: a
    one-element in-place add, captured 100 times by ``graph_ms``."""
    t = torch.zeros(1, device="cuda")
    return graph_ms(lambda: t.add_(1.0))


def encode_rows_touched(spec, x) -> int:
    """The distinct table rows that the corners of the points x reach, over
    every level."""
    from tropical_torch.core import hashgrid as hg

    rows = []
    for l in range(spec.levels):
        pos_grid, frac = hg._level_grid(spec, x, l)
        rows += [idx for _, idx, _ in hg._corners(spec, l, pos_grid, frac,
                                                  spec.n_entries)]
    return int(torch.unique(torch.cat(rows)).numel()) if rows else 0


def encode_bound_ms(name, spec, x):
    """Least time of one encode kernel on the points x: the bytes it must
    move at 3.35 TB/s against its unfused float operations at
    PEAK_F32_UNFUSED_OPS.  Bytes: the points and the gradients read, each
    table row the corners reach read once (the corners' later reads of a
    row are not counted: the table, 281 KB for sphere-small, stays in the
    50 MB L2), the outputs written, a table gradient written once whole."""
    n, L, rows = x.shape[0], spec.levels, spec.n_entries
    points, feats, table = 12 * n, 8 * L * n, 8 * encode_rows_touched(spec, x)
    nbytes = {"hashgrid_encode_fwd": points + table + feats,
              "hashgrid_encode_bwd": points + feats + table + points + 8 * rows,
              "hashgrid_encode_bwd_bwd": (2 * points + feats + table + feats
                                          + 8 * rows + points)}
    t_bytes = nbytes[name] / PEAK_BYTES
    t_ops = ENCODE_OPS[name] * L * n / PEAK_F32_UNFUSED_OPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def encode_times(spec, table, x, dfeat, ddx):
    """Each kernel's device time (graph_ms), one wrapper call, its plain
    version (CUDA events) and its bound on these inputs."""
    from tropical_torch.core import hashgrid as hg

    calls = {
        "hashgrid_encode_fwd": (
            lambda: hg.hashgrid_encode_fwd(spec, table, x),
            lambda: hg.encode_plain(spec, table, x)),
        "hashgrid_encode_bwd": (
            lambda: hg.hashgrid_encode_bwd(spec, table, x, dfeat),
            lambda: hg.encode_backward_plain(spec, table, x, dfeat)),
        "hashgrid_encode_bwd_bwd": (
            lambda: hg.hashgrid_encode_bwd_bwd(spec, table, x, dfeat, ddx),
            lambda: hg.encode_double_backward_plain(spec, table, x, dfeat,
                                                    ddx))}
    n = x.shape[0]
    out = {}
    for name, (kernel, plain) in calls.items():
        ms = graph_ms(kernel)
        call_ms = cuda_ms(kernel, iters=50, warmup=10)
        plain_ms = cuda_ms(plain, iters=10, warmup=2)
        bound_ms, bound_by = encode_bound_ms(name, spec, x)
        prev = PREV_ENCODE_MS.get(name, {}).get(n)
        before = "" if prev is None else f" (before the redesign {prev} ms)"
        print(f"{name} B={n}: kernel {ms:.4f} ms{before} (a wrapper call "
              f"{call_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.5f} ms ({bound_by}); kernel at "
              f"{bound_ms / ms:.1%} of the bound")
        out[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None, "shape": [n, spec.levels]}
    # the forward's lanes a (point, level) at this B
    out["hashgrid_encode_fwd"]["lanes"] = hg._launcher(
        spec, x.get_device(), None).lanes(n)
    # the backward in x alone (normal(), the GD rescue), and the host cost
    # of a zero-filled table gradient against an unfilled one (the launch
    # zero-fills it with cudaMemsetAsync in the same call)
    def x_only():
        return hg.hashgrid_encode_bwd(spec, table, x, dfeat, need_table=False)

    fills = {"x_only_ms": graph_ms(x_only),
             "x_only_call_ms": cuda_ms(x_only, iters=50, warmup=10),
             "zeros_like_call_ms": cuda_ms(lambda: torch.zeros_like(table),
                                           iters=50, warmup=10),
             "empty_like_call_ms": cuda_ms(lambda: torch.empty_like(table),
                                           iters=50, warmup=10)}
    print(f"hashgrid_encode_bwd B={n} in x alone: {json.dumps(fills)}")
    out["hashgrid_encode_bwd"].update(fills)
    return out


def encode_at_largest(records, largest):
    """The encode kernels at the flat run's largest forward (``main_*`` keys
    of each record) and at its largest backward, the faces' normals
    (``normals_*``): held to their plain versions and timed; then the
    forward on the points that largest forward serves, a marching-cubes
    slab (``slab_*``)."""
    spec = encode_spec("small")
    recs = {k: records[k] for k in ENCODE}
    for key, name in (("main", "hashgrid_encode_fwd"),
                      ("normals", "hashgrid_encode_bwd")):
        shape = largest[name]
        check(shape is not None and shape[1] == spec.levels,
              f"flat path's largest {name}: {shape}")
        inputs = encode_inputs(spec, shape[0], seed=11)
        encode_vs_plain(recs, f"small B={shape[0]} (largest {name} on the "
                        "flat path)", spec, *inputs)
        for k, v in encode_times(spec, *inputs).items():
            records[k].update({f"{key}_{f}": val for f, val in v.items()})
        if key == "main":
            encode_on_slab(records["hashgrid_encode_fwd"], "slab", spec,
                           inputs[0], shape)


def slab_points(res=SLAB_RES, x0=SLAB_X0):
    """SLAB + 1 x-planes of the marching-cubes grid at res from x index x0,
    built as ``utils/marching_cubes.slab_fields`` builds a slab's points
    (``np.linspace`` axis in f32, row-major, z fastest), then
    ``preprocess``ed into the unit cube as the net's forward does."""
    from tropical_torch.core.net import preprocess
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.stanford.train import CANVAS_SIZE
    from tropical_torch.utils import marching_cubes as mc

    s = mc.grid_axis(res, CANVAS_SIZE, torch.device("cuda"))
    pts = mc.grid_points(s, x0 * res ** 2, (mc.SLAB + 1) * res ** 2)
    return preprocess(net_for_size("small", device="cpu").spec, pts)


def encode_on_slab(rec, key, spec, table, largest, res=SLAB_RES,
                   x0=SLAB_X0):
    """The forward on a marching-cubes slab's own points (``slab_points``),
    the shape ``largest`` a main path gave it: bitwise its plain version,
    then its device time, one wrapper call, the plain version and its
    bound (``{key}_*`` keys of the record)."""
    from tropical_torch.core import hashgrid as hg

    x = slab_points(res, x0).contiguous()
    check(tuple(largest) == (x.shape[0], spec.levels),
          f"the slab at {res} has {x.shape[0]} points, the path's largest "
          f"forward {largest}")
    feat = hg.hashgrid_encode_fwd(spec, table, x)
    torch.cuda.synchronize()
    bad = int((feat.view(torch.int32)
               != hg.encode_plain(spec, table, x).view(torch.int32)).sum())
    print(f"encode slab at {res} from x index {x0} ({x.shape[0]} points): "
          f"forward bit mismatches {bad}")
    check(bad == 0, f"the forward differs from its plain version on the "
          f"slab at {res}")

    def fwd():
        return hg.hashgrid_encode_fwd(spec, table, x)

    ms, call_ms = graph_ms(fwd), cuda_ms(fwd, iters=50, warmup=10)
    plain_ms = cuda_ms(lambda: hg.encode_plain(spec, table, x), iters=3)
    bound_ms, bound_by = encode_bound_ms("hashgrid_encode_fwd", spec, x)
    print(f"hashgrid_encode_fwd on the slab at {res}: kernel {ms:.4f} ms (a "
          f"wrapper call {call_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}); at {bound_ms / ms:.1%} of the "
          "bound")
    rec.update({f"{key}_{k}": v for k, v in dict(
        shape=list(largest), ms=ms, call_ms=call_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        max_abs_err=0.0).items()})


def golden_params(g):
    return {"table": g["table"],
            "mlp": {"w": [g[f"w{i}"] for i in range(3)],
                    "b": [g[f"b{i}"] for i in range(3)]}}


def window_max(a, width=WINDOW):
    """The largest |a| in each window of ``width`` steps; where ``a``
    stacks several runs ([runs, steps]), the largest over them too."""
    w = np.abs(a).reshape(*a.shape[:-1], -1, width).max(axis=-1)
    return w.max(axis=0) if w.ndim > 1 else w


def golden_verdict(g, totals, l1s, sdf):
    """A training run against the JAX golden: (report, failures).

    The port's Adam rounds as torch.optim.Adam does; the golden's ``adam``
    run is the JAX package with that arithmetic.  Each 10-step window of
    both losses is held:

    - until the first window where twice the one-ulp witness's spread
      covers the adam run's own gap to the golden: to the adam run, within
      twice the summation noise of a loss read out in another order (the
      order witnesses' largest gap to the golden over those windows);
    - from that window on: to the golden, within twice the one-ulp
      witness's spread.

    The sdf at the probes: to the golden, within twice the one-ulp
    witness's spread."""
    report, failures = {}, []
    for key, port in (("totals", totals), ("l1s", l1s)):
        gold = g[f"golden_{key}"]
        spread = window_max(g[f"witness_{key}"] - gold)
        covered = np.nonzero(2 * spread >= window_max(g[f"adam_{key}"] - gold))
        switch = int(covered[0][0]) if len(covered[0]) else len(spread)
        noise = float(window_max(g[f"order_{key}"] - gold)[:switch].max(
            initial=0.0))
        early = window_max(port - g[f"adam_{key}"])[:switch]
        gap = window_max(port - gold)
        over = np.nonzero(early > 2 * noise)[0].tolist()
        over += (switch + np.nonzero(gap[switch:] > 2 * spread[switch:])[0]
                 ).tolist()
        opened = np.nonzero(np.maximum.accumulate(gap) > 1e-6)[0]
        report[key] = {
            "held_to_golden_from_window": switch,
            "gap_to_adam_run": early.tolist(), "early_limit": 2 * noise,
            "gap_to_golden": gap.tolist(), "witness_spread": spread.tolist(),
            "windows_over": over,
            "gap_to_golden_opens_at_window": (int(opened[0]) if len(opened)
                                              else None)}
        if over:
            failures.append(f"{key}: windows {over} beyond their limits")
    gap_p = float(np.abs(sdf - g["golden_sdf"]).max())
    spread_p = float(np.abs(g["witness_sdf"] - g["golden_sdf"]).max())
    report["probes"] = {"gap_to_golden": gap_p, "witness_spread": spread_p}
    if gap_p > 2 * spread_p:
        failures.append(f"probe sdf {gap_p} from the golden, beyond twice "
                        f"the witness's {spread_p}")
    return report, failures


def dtable2_dropped(bwd_bwd):
    """A planted fault: ``bwd_bwd`` with its table gradient zeroed (the
    eikonal term's gradient of the table lost)."""
    def faulty(*args, **kwargs):
        d_dfeat, dtable2, dx2 = bwd_bwd(*args, **kwargs)
        return d_dfeat, None if dtable2 is None else dtable2.zero_(), dx2

    return faulty


def step_ms(net_init, x, y, plain_encode: bool) -> float:
    """One training step on a fixed batch (CUDA events over 10 steps),
    through the kernels or, for the comparison only, through autograd of
    the plain encode."""
    from tropical_torch.core import hashgrid as hg
    from tropical_torch.stanford import training as tr

    net = net_init()
    opt, sched = tr.make_optimizer(net.parameters(), 1e-3, 100)
    encode = hg.encode
    if plain_encode:
        hg.encode = lambda spec, table, xu: hg.encode_plain(spec, table, xu)
    try:
        return cuda_ms(lambda: tr.train_step(net, opt, sched, x, y,
                                             TRAIN_BATCH), iters=10, warmup=3)
    finally:
        hg.encode = encode


def kernel_events(prof):
    """The device's kernel events of a profile: CUDA events that are not
    user annotations (the spans of record_function scopes)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def profiled_steps(net, opt, sched, x, y, steps):
    """``steps`` training steps under torch.profiler: (profile, host wall
    in us)."""
    from torch.profiler import ProfilerActivity, profile

    from tropical_torch.stanford import training as tr

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        for _ in range(steps):
            tr.train_step(net, opt, sched, x, y, TRAIN_BATCH)
        torch.cuda.synchronize()
        wall_us = (time.time() - t) * 1e6
    return prof, wall_us


def first_step(net_init, x, y):
    """The first training step of the process, profiled: its wall and the
    host operations that take most of it (one-time set-up the later steps
    do not pay)."""
    from tropical_torch.stanford import training as tr

    net = net_init()
    opt, sched = tr.make_optimizer(net.parameters(), 1e-3, 100)
    prof, wall_us = profiled_steps(net, opt, sched, x, y, 1)
    top = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)[:8]
    return {"wall_s": wall_us / 1e6,
            "top_host_s": {e.key[:60]: e.cpu_time_total / 1e6 for e in top}}


def step_busy_share(net_init, x, y, steps: int = 10):
    """The device's busy share over ``steps`` warm training steps through
    the kernels: the summed time of the kernel events (torch.profiler) over
    the host clock of the steps, and the kernels a step."""
    from tropical_torch.stanford import training as tr

    net = net_init()
    opt, sched = tr.make_optimizer(net.parameters(), 1e-3, 100)
    for _ in range(3):
        tr.train_step(net, opt, sched, x, y, TRAIN_BATCH)
    prof, wall_us = profiled_steps(net, opt, sched, x, y, steps)
    events = kernel_events(prof)
    busy_us = sum(e.device_time_total for e in events)
    by_name = {}
    for e in events:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_share": busy_us / wall_us,
            "device_us_per_step": busy_us / steps,
            "wall_us_per_step": wall_us / steps,
            "kernels_per_step": len(events) / steps,
            "top_device_us_per_step": {k: v / steps for k, v in top}}


def training_phase(flat_cd):
    """Train from the golden's JAX init; returns the encode launches."""
    phase("7. training path: train() on sphere-small, 10 epochs of 50 steps "
          "of 1,000")
    from tropical_torch.ops import launches
    from tropical_torch.stanford import train as cli
    from tropical_torch.stanford.dataset import StanfordDataset
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.stanford.training import train
    from tropical_torch.utils.ply import Mesh

    g = np.load(TRAIN_GOLDEN)
    dev = torch.device("cuda")

    def net_init():
        return net_for_size("small", "sphere", TRAIN_SEED,
                            device=dev).params_from_numpy(golden_params(g))

    t = time.time()
    ds = StanfordDataset("sphere", rng=np.random.default_rng(TRAIN_SEED),
                         device=dev)
    torch.cuda.synchronize()
    dataset_s = time.time() - t
    label_s = []
    resample = ds.resample

    def timed_resample():
        torch.cuda.synchronize()
        t0 = time.time()
        resample()
        torch.cuda.synchronize()
        label_s.append(time.time() - t0)

    ds.resample = timed_resample
    epoch_end = []

    def epoch_done(_):
        torch.cuda.synchronize()
        epoch_end.append(time.time())

    # the process's first training step, on a net of its own, before the
    # run: the one-time set-up it pays is reported, not timed in the run
    x0, y0 = ds.X[:TRAIN_BATCH], ds.Y[:TRAIN_BATCH]
    print(json.dumps({"first_training_step": first_step(net_init, x0, y0)}))
    net = net_init()
    launches.reset()
    t = time.time()
    totals, l1s = train(net, ds, TRAIN_EPOCHS, TRAIN_BATCH,
                        epoch_callback=epoch_done)
    torch.cuda.synchronize()
    train_s = time.time() - t
    epoch_s = np.diff([t, *epoch_end, t + train_s]).tolist()
    counts = dict(launches.LAUNCHES)
    counts.update({f"{k}_scatters": v for k, v in launches.SCATTERS.items()})
    steps = len(totals)
    print(f"trained {steps} steps in {train_s:.3f} s (epochs {epoch_s}; "
          f"labels {np.mean(label_s):.4f} s an epoch, {label_s}; dataset "
          f"built in {dataset_s:.3f} s); kernel launches {counts}")
    check(steps == TRAIN_EPOCHS * 50, f"{steps} steps")
    want = {k: v * steps for k, v in STEP_LAUNCHES.items()}
    check(all(counts[k] == want[k] for k in ENCODE)
          and counts["min_dist"] == counts["trilinear_roots"] == 0,
          f"training launches {counts}, want {want}")
    # each epoch's resample labels its points: one closest-point query and
    # one parity count; the dataset's tree was built before the run
    resamples = len(label_s)
    check(counts["bvh_closest"] == counts["bvh_ray"] == resamples > 0
          and counts["bvh_hierarchy"] == counts["bvh_refit"] == 0,
          f"training BVH launches {counts}, want {resamples} queries each")
    # every training backward scatters its table gradient (the J pass's too,
    # which autograd.grad(..., x) then discards)
    check(all(counts[f"{k}_scatters"] == want[k] for k in launches.SCATTERS),
          f"training backwards that scattered: {counts}, want {want}")

    # against the JAX golden and its witnesses
    probes = torch.from_numpy(g["probes"]).to(dev)
    report, failures = golden_verdict(g, totals, l1s,
                                      net.sdf(probes)[:, 0].cpu().numpy())
    print(json.dumps({"train_vs_golden": report}))
    check(not failures, "; ".join(failures))

    # a control: the same check fails a run with a wrong training step
    from tropical_torch.core import hashgrid as hg

    bwd_bwd = hg.hashgrid_encode_bwd_bwd
    hg.hashgrid_encode_bwd_bwd = dtable2_dropped(bwd_bwd)
    try:
        fault_net = net_init()
        fault_totals, fault_l1s = train(
            fault_net, StanfordDataset("sphere", rng=np.random.default_rng(
                TRAIN_SEED), device=dev), TRAIN_EPOCHS, TRAIN_BATCH,
            verbose=False)
    finally:
        hg.hashgrid_encode_bwd_bwd = bwd_bwd
    fault_report, fault_failures = golden_verdict(
        g, fault_totals, fault_l1s, fault_net.sdf(probes)[:, 0].cpu().numpy())
    print(json.dumps({"planted_fault_dtable2_zeroed": {
        "failures": fault_failures,
        **{k: {"windows_over": fault_report[k]["windows_over"],
               "gap_to_adam_run": fault_report[k]["gap_to_adam_run"]}
           for k in ("totals", "l1s")},
        "probes": fault_report["probes"]}}))
    check(fault_failures, "the golden check passed a run with the double "
          "backward's table gradient zeroed")

    # the trained net on the flat path, evaluated
    out_dir = os.path.join(cli.OUT_ROOT, "sphere_trained")
    os.makedirs(out_dir, exist_ok=True)
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        _, V, F, take = cli.extract_mesh(net, True)
        mesh = Mesh(V.cpu().numpy() / cli.DATASET_R, F.cpu().numpy())
        check(mesh.vertices.shape[0] > 0, "the trained net's mesh is empty")
        launches.reset()
        with traced_meshes() as meshes:
            cli.evaluate_against_grid_gt(net, mesh, take, cli.DATASET_R, 128,
                                         out_dir, "small_1")
    eval_counts = dict(launches.LAUNCHES)
    check_bvh_launches("the trained net's evaluation", eval_counts, meshes)
    counts.update({f"{k}_evaluation": eval_counts[k] for k in BVH})
    cd = float(re.search(r"^Ours, +\d+, ([-\d.naif]+), ", tee.buf.getvalue(),
                         re.M).group(1))
    print(f"trained net: {mesh.vertices.shape[0]} vertices, "
          f"{mesh.faces.shape[0]} faces, Ours CD {cd} against the committed "
          f"checkpoint's {flat_cd}")
    check(math.isfinite(cd) and 0 < cd <= 2 * flat_cd,
          f"trained net's CD {cd} beyond twice the committed {flat_cd}")

    # one step, through the kernels and through the plain encode
    x, y = next(ds.batches(TRAIN_BATCH))
    times = {"kernels": step_ms(net_init, x, y, False),
             "plain_encode": step_ms(net_init, x, y, True)}
    print(json.dumps({"train_step_ms": times,
                      "speedup": times["plain_encode"] / times["kernels"],
                      "labels_s_per_epoch": float(np.mean(label_s)),
                      "train_s": train_s, "epoch_s": epoch_s,
                      "steps": steps,
                      "step_profile": step_busy_share(net_init, x, y)}))
    return counts


def tree_state(root):
    """(path, size, mtime) of every file under ``root``."""
    state = set()
    for dirpath, _, names in os.walk(root):
        for n in names:
            st = os.stat(os.path.join(dirpath, n))
            state.add((os.path.join(dirpath, n), st.st_size, st.st_mtime_ns))
    return state


def cli_training_phase():
    argv = ["-m", "tropical_torch.stanford.train", *CLI_TRAIN_ARGV]
    phase("8. training CLI: python " + " ".join(argv))
    from tropical_torch.stanford import train as cli

    watched = ("tropical", str(cli.MODELS_DIR))
    before = [tree_state(r) for r in watched]
    t = time.time()
    proc = subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, timeout=900)
    wall = time.time() - t
    print(proc.stdout[-4000:])
    print(proc.stderr[-2000:], file=sys.stderr)
    after = [tree_state(r) for r in watched]
    changed = [sorted(a ^ b)[:5] for a, b in zip(before, after)]
    print(f"CLI exit {proc.returncode} in {wall:.1f} s; files changed under "
          f"{watched}: {changed}")
    check("Finished training." in proc.stdout, "the CLI did not train")
    check("# of vertices and edges" in proc.stdout, "the CLI did not extract")
    check(not any(changed), f"the CLI wrote under {watched}: {changed}")
    # one epoch leaves the sphere without a zero level set (the JAX
    # package's CLI gives the same empty mesh): the CLI then exits 2 with
    # its warning, as the JAX package's does
    empty = "empty extraction" in proc.stdout
    check(proc.returncode == (2 if empty else 0),
          f"CLI exit {proc.returncode} (empty extraction: {empty})")


@contextlib.contextmanager
def traced_meshes():
    """Keep (vertices, faces) of every mesh the evaluation traces, in a
    list."""
    from tropical_torch.utils import chamfer

    kept = []
    sample = chamfer.sample_surface_from_rays

    def keep(rays_o, rays_d, mesh, return_normal=False):
        kept.append((np.array(mesh.vertices, np.float32),
                     np.array(mesh.faces, np.int64)))
        return sample(rays_o, rays_d, mesh, return_normal)

    chamfer.sample_surface_from_rays = keep
    try:
        yield kept
    finally:
        chamfer.sample_surface_from_rays = sample


def check_bvh_launches(label, counts, meshes):
    """One BVH build and one first-hit trace a traced mesh with triangles
    (a mesh of one triangle has no internal node), none for an empty one."""
    faces = [m[1].shape[0] for m in meshes]
    want = {"bvh_hierarchy": sum(f >= 2 for f in faces),
            "bvh_refit": sum(f >= 1 for f in faces),
            "bvh_ray": sum(f >= 1 for f in faces), "bvh_closest": 0}
    got = {k: counts[k] for k in BVH}
    print(f"{label}: BVH launches {json.dumps(got)} for {len(faces)} traced "
          f"meshes of {faces} triangles")
    check(got == want and want["bvh_ray"] > 0,
          f"{label}: BVH launches {got}, want {want}")


def run_cli(argv):
    """The CLI once, with every kernel's count and largest shape and the
    stage timers zeroed just before it.  Returns (stdout, launches, largest
    shapes, wall seconds, the traced meshes)."""
    from tropical_torch.extract import subdivide as sp
    from tropical_torch.ops import launches
    from tropical_torch.stanford import train

    for phases in (sp.PHASES, train.PHASES):
        phases.totals.clear()
        phases.counts.clear()
    launches.reset()
    tee = Tee(sys.stdout)
    t = time.time()
    with contextlib.redirect_stdout(tee), traced_meshes() as meshes:
        rc = train.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts, largest = dict(launches.LAUNCHES), dict(launches.LARGEST)
    counts.update({f"{k}_scatters": v for k, v in launches.SCATTERS.items()})
    check(rc == 0, f"CLI returned {rc}")
    check_bvh_launches(" ".join(argv), counts, meshes)
    print(f"main path wall {wall:.2f} s; kernel launches (and the encode "
          f"backwards' that scattered a table gradient) {counts}")
    # the paths differentiate in x alone (faces' normals, the GD rescue):
    # none of their backwards scatters a table gradient
    for k in launches.SCATTERS:
        check(counts[f"{k}_scatters"] == 0,
              f"{k}: {counts[k + '_scatters']} launches scattered a table "
              "gradient nobody reads")
    return tee.buf.getvalue(), counts, largest, wall, meshes


def summary(text, wall) -> tuple[float, float]:
    """Check the 'Ours' CD/AD row; print the funnel and the stage times.
    Returns the extraction's ``take`` (s) and the "Ours" CD."""
    from tropical_torch.extract import subdivide as sp
    from tropical_torch.stanford import train

    ours_row = re.search(r"^Ours, +\d+, ([-\d.naif]+), +([-\d.naif]+), ",
                         text, re.M)
    check(ours_row, "no 'Ours' row in the evaluation table")
    cd, ad = float(ours_row.group(1)), float(ours_row.group(2))
    print(f"Ours: CD {cd}, AD {ad}")
    check(math.isfinite(cd) and math.isfinite(ad) and cd > 0,
          f"Ours CD {cd} / AD {ad}")
    extract_s = float(re.search(r" take ([\d.]+)", text).group(1))
    funnel = re.search(r"# of vertices and edges = .*faces", text).group(0)
    print(json.dumps({
        "funnel": funnel, "extract_s": extract_s,
        "extract_stage_s": {k: round(v, 4) for k, v in sp.PHASES.totals.items()},
        "eval_stage_s": {k: round(v, 4) for k, v in train.PHASES.totals.items()},
        "wall_s": round(wall, 4), "ours_cd": cd, "ours_ad": ad}))
    return extract_s, cd


def fan_contract(v, ours, ref, against="the committed mesh", share=0.005):
    """The triangles of two meshes on one vertex set (``ours`` mapped onto
    ``ref``'s vertices) under the fan-diagonal contract of
    tests/test_device_faces.py: the rows that differ are as many on each
    side, at most ``share`` of them (0.5 % by default), on the same
    vertices, with the same area (a fan's diagonal taken the other
    way)."""
    s1 = set(map(tuple, np.sort(ours, 1)))
    s2 = set(map(tuple, np.sort(ref, 1)))
    d1, d2 = s1 - s2, s2 - s1

    def area(tris):
        if not tris:
            return 0.0
        p = np.asarray(v, np.float64)[np.asarray(sorted(tris))]
        cr = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        return float(0.5 * np.linalg.norm(cr, axis=1).sum())

    a1, a2 = area(d1), area(d2)
    print(f"triangles against {against}: {len(d1)} / {len(d2)} "
          f"rows differ of {len(s2)}, their areas {a1:.6e} / {a2:.6e}")
    check(len(d1) == len(d2)
          and len(d1) <= share * len(s2)
          and {i for t in d1 for i in t} == {i for t in d2 for i in t}
          and abs(a1 - a2) <= 1e-6 * area(s2) + 1e-12,
          "triangles outside the fan-diagonal contract")
    return len(d1), len(s2)


def main_path_phase():
    phase("4. flat main path: " + " ".join(MAIN_ARGV))
    from tropical_torch.extract import stats
    from tropical_torch.ops.chamfer import min_dist_plain
    from tropical_torch.utils.ply import read_ply

    text, launches, largest, wall, meshes = run_cli(MAIN_ARGV)
    want = preset_funnel("small")
    check(stats.LAST == want, f"funnel {stats.LAST} != the JAX CLI's {want}")
    check({k: stats.LAST[k] for k in ("post_v", "post_e", "n_faces")}
          == {k: GOLDEN[k] for k in ("post_v", "post_e", "n_faces")},
          f"funnel {stats.LAST} != golden {GOLDEN} after the filter")
    for k, want in {**MAIN_LAUNCHES, **FLAT_ENCODE}.items():
        check(launches[k] == want, f"{k}: {launches[k]} launches, want {want}")

    # the exported mesh is the committed JAX one: same counts, and each
    # vertex within 1e-4 of its own twin (nearest-neighbour matching that
    # must be one to one)
    ours = read_ply("meshes_torch/sphere/our_mesh_small_1.ply")
    ref = read_ply("meshes/sphere/our_mesh_small_1.ply")
    check(ours.faces.shape == ref.faces.shape
          and ours.vertices.shape == ref.vertices.shape,
          f"mesh {ours.vertices.shape}/{ours.faces.shape} != committed "
          f"{ref.vertices.shape}/{ref.faces.shape}")
    d2, idx = min_dist_plain(
        torch.from_numpy(ours.vertices.astype(np.float32)).cuda(),
        torch.from_numpy(ref.vertices.astype(np.float32)).cuda())
    vmax = math.sqrt(float(d2.max()))
    one_to_one = int(torch.unique(idx).numel()) == ref.vertices.shape[0]
    print(f"exported vs committed mesh: max vertex distance {vmax:.3e}, "
          f"one to one: {one_to_one}")
    check(vmax <= 1e-4 and one_to_one, "exported mesh differs from committed")
    fan_contract(ref.vertices, idx.cpu().numpy()[ours.faces], ref.faces)
    _, cd = summary(text, wall)
    return launches, largest, cd, meshes


def preset_funnel(size):
    """The JAX CLI's funnel of a sphere preset, flat (``FLAT_PRESETS``)."""
    g = json.load(open(FLAT_PRESETS))[f"sphere_{size}_flat"]
    return {"pre_v": g["pre_v"], "pre_e": g["pre_e"], "post_v": g["post_v"],
            "post_e": g["post_e"], "n_faces": g["n_tris"]}


def sphere_net(size):
    """A sphere preset's committed checkpoint, on the card."""
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.utils import checkpoint as ckpt

    return ckpt.load_into(net_for_size(size, seed=1, device="cuda"),
                          ckpt.find_checkpoint(
                              f"tropical/stanford/models/sphere/"
                              f"sphere_sdf_{size}_1.pth"))


def extraction_counts(net, engine, force=True):
    """One extraction under torch.profiler: (host syncs, device-to-host
    copies, kernel launches).  Syncs: cudaStreamSynchronize,
    cudaDeviceSynchronize and cudaEventSynchronize calls, less the one that
    ends the profiled window; copies: the device's DtoH memcpys; launches:
    the runtime's kernel launch calls."""
    from torch.profiler import ProfilerActivity, profile

    from tropical_torch.extract.subdivide import subpoly

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        subpoly(net, 3, 1.2, force=force, verbose=False, engine=engine)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    syncs = sum(n in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize") for n in names) - 1
    d2h = sum(n.startswith("Memcpy DtoH") for n in names)
    kernels = sum(n in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel", "cuLaunchKernelEx") for n in names)
    return syncs, d2h, kernels


def within(got, want, share=0.005):
    return max(abs(got[k] - want[k]) / want[k] for k in want) <= share


def engines_phase():
    """Both engines in one call, on sphere-small flat and on sphere-medium
    curved: the device engine (the CLI's) and the host engine
    (``engine="host"``), each held to its funnel (the curved ones, where
    eps-boundary flips move them, within 0.5 %), their ``take`` (warm, host
    clock) and their syncs, copies and launches; the device engine's reads,
    one a busy insertion on the flat path and on the curved path as
    ``Engine._curved`` counts them; ``trilinear_roots``' launches in each
    profiled extraction (the host engine's curved path launches it, the
    device engine's runs its solve inside ``curved_roots``).  Returns the
    numbers."""
    phase("4b. the device engine against the host engine, sphere-small flat "
          "and sphere-medium curved")
    from tropical_torch.extract import device as dv
    from tropical_torch.extract import stats
    from tropical_torch.extract.subdivide import subpoly
    from tropical_torch.ops import launches

    out = {}
    for size, force, cases in (
            ("small", True, (("auto", preset_funnel("small")),
                             ("host", GOLDEN))),
            ("medium", False, (("auto", curved_funnel("medium")),
                               ("host", CURVED_GOLDEN)))):
        net = sphere_net(size)
        label = f"{size} {'flat' if force else 'curved'}"
        for engine, want in cases:
            takes = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                subpoly(net, 3, 1.2, force=force, verbose=False,
                        engine=engine)
                torch.cuda.synchronize()
                takes.append(time.perf_counter() - t)
                check(stats.LAST == want or (not force and within(
                    stats.LAST, want)), f"{label} {engine}: funnel "
                    f"{stats.LAST} != {want}")
            launches.reset()
            syncs, d2h, kernels = extraction_counts(net, engine, force)
            rec = out.setdefault(label, {})[engine] = {
                "take_s": takes[1:], "syncs": syncs, "d2h": d2h,
                "launches": kernels, "funnel": dict(stats.LAST),
                "trilinear_roots": launches.LAUNCHES["trilinear_roots"]}
            if engine != "auto":
                continue
            last = dv.LAST
            rec.update(reads=last.reads, busy=last.busy,
                       split_s=[last.t_skeleton, last.t_loop, last.t_faces])
            extra = sum(r for *_, r in last.curved)
            if not force:
                rec["curved_reads"] = curved_reads(last.curved)
            check(last.reads == len(last.busy) + 4 + extra,
                  f"{label}: {last.reads} reads for {len(last.busy)} busy "
                  "insertions: one each, one each for the skeleton and the "
                  f"starting pools, two for the faces, and the curved "
                  f"path's {extra}")
            check((syncs, d2h, kernels, last.reads) == ENGINE_COUNTS[label],
                  f"{label}: (syncs, copies, launches, reads) "
                  f"{(syncs, d2h, kernels, last.reads)} != "
                  f"{ENGINE_COUNTS[label]}")
        del net
        torch.cuda.empty_cache()
    print(json.dumps({
        f"{label}: {'device' if e == 'auto' else e} engine": r
        for label, recs in out.items() for e, r in recs.items()}))
    return out


def k7_rows(d_corner, plane, idx):
    """K7's rows (p at each row's plane, q at idx, [n, 8] each) in the
    corner forward ``d_corner`` [n, 8, R], as ``curved_roots`` reads them."""
    p = d_corner.gather(2, plane.long()[:, None, None].expand(-1, 8, 1))
    return p[..., 0].contiguous(), d_corner[:, :, idx].contiguous()


def curved_funnel(size):
    """The JAX CLI's curved funnel of a sphere preset (``CURVED_PRESETS``)."""
    g = json.load(open(CURVED_PRESETS))[f"sphere_{size}_curved"]
    return {"pre_v": g["pre_v"], "pre_e": g["pre_e"], "post_v": g["post_v"],
            "post_e": g["post_e"], "n_faces": g["n_tris"]}


def curved_reads(curved):
    """The host reads of each curved busy insertion beside its META read:
    [(plane, curved rows, rescued rows, rescue steps, reads)]."""
    return [(p, c, g, s, r + 1) for p, _, c, g, s, _, r in curved]


def curved_path_phase():
    """The curved CLI run, through the device engine.  Returns (launches,
    every (p, q) the root solve was given: K7's rows that ``curved_roots``
    gathered, the extraction's ``take``, the traced meshes)."""
    phase("5. curved main path: " + " ".join(CURVED_ARGV))
    from tropical_torch.extract import device as dv
    from tropical_torch.extract import failover as fo
    from tropical_torch.extract import stats
    from tropical_torch.ops.chamfer import min_dist_plain
    from tropical_torch.stanford import train

    # keep the extracted vertices and the root solve's rows
    kept = {"inputs": []}
    roots, extract = dv.curved_roots, train.extract_mesh

    def keep_inputs(d_corner, plane, e01, idx, kern=None):
        if plane.shape[0]:
            kept["inputs"].append(k7_rows(d_corner, plane, idx))
        return roots(d_corner, plane, e01, idx, kern=kern)

    def keep_mesh(net, force):
        out = extract(net, force)
        kept.update(net=net, vertices=out[1], last=dv.LAST)
        return out

    dv.curved_roots, train.extract_mesh = keep_inputs, keep_mesh
    try:
        text, launches, _, wall, meshes = run_cli(CURVED_ARGV)
    finally:
        dv.curved_roots, train.extract_mesh = roots, extract
    last = kept["last"]
    check(last is not None and len(last.curved) == len(last.busy) > 0,
          "the curved CLI did not extract through the device engine")
    print(f"failover counters {fo.COUNTERS}")
    print(f"device engine: busy insertions (plane, splits, hits, connecting "
          f"edges) {last.busy}; host reads {last.reads}; reads of each "
          f"curved busy insertion (plane, curved rows, rescued rows, rescue "
          f"steps, reads with its META read) {curved_reads(last.curved)}; "
          f"skeleton / loop / faces "
          f"{[last.t_skeleton, last.t_loop, last.t_faces]} s")

    # the funnel against the JAX CLI's; the vertices against the JAX set
    V = kept["vertices"]
    check(stats.LAST == CURVED_DEVICE, f"funnel {stats.LAST} != the device "
          f"engine's {CURVED_DEVICE}")
    want = curved_funnel("medium")
    ref = torch.from_numpy(np.load(CURVED_VERTICES)).cuda()
    d_ours, _ = min_dist_plain(V, ref)
    d_ref, _ = min_dist_plain(ref, V)
    far_ours = int((d_ours.sqrt() > 1e-5).sum())
    far_ref = int((d_ref.sqrt() > 1e-5).sum())
    exact = stats.LAST == want
    diff = {k: stats.LAST[k] - v for k, v in want.items()}
    print(json.dumps({"funnel": stats.LAST, "funnel_exact": exact,
                      "funnel_minus_jax_cli": diff,
                      "vertices": V.shape[0], "jax_vertices": ref.shape[0],
                      "ours_beyond_1e-5_of_jax": far_ours,
                      "jax_beyond_1e-5_of_ours": far_ref,
                      "max_nn_distance": math.sqrt(float(torch.maximum(
                          d_ours.max(), d_ref.max())))}))
    if not exact:
        allowed = 0.005 * ref.shape[0]
        check(within(stats.LAST, want)
              and abs(V.shape[0] - ref.shape[0]) <= allowed
              and far_ours <= allowed and far_ref <= allowed,
              f"funnel {stats.LAST} != the JAX CLI's {want}, and outside "
              "the eps-boundary contract against the JAX vertex set")

    sdf = float(kept["net"].sdf(V).abs().max())
    print(f"max |sdf| on the curved vertices: {sdf:.3e}")
    check(sdf < 2e-4, f"curved vertices off the surface: |sdf| {sdf}")
    steps = fo.COUNTERS["curved_steps"]
    rescues = sum(g > 0 for _, _, _, g, *_ in last.curved)
    check(launches["min_dist"] == 16,
          f"min_dist: {launches['min_dist']} launches, want 16")
    check(steps > 0 and launches["trilinear_roots"] == 0
          and len(kept["inputs"]) == steps,
          f"trilinear_roots: {launches['trilinear_roots']} launches (its "
          f"solve runs inside curved_roots) and {len(kept['inputs'])} "
          f"curved_roots inputs, want one per curved insertion step "
          f"({steps})")
    busy = len(last.busy)
    want_k4c = {**{k: v * busy for k, v in CURVED_PER_BUSY.items()},
                **{k: v * steps for k, v in CURVED_PER_STEP.items()}}
    for k, v in CURVED_PER_RESCUE.items():
        want_k4c[k] += v * rescues
    conn = sum(c > 0 for i, _, _, c in last.busy if i < dv.R_COLS - 1)
    want_k4c.update(split_step=K4_PER_CURVED_BUSY * busy + 1 + conn,
                    lattice_encode=1, skeleton_mark=6,
                    **{k: K6_LAUNCHES for k in K6})
    for k, want_n in want_k4c.items():
        check(launches[k] == want_n, f"{k}: {launches[k]} launches on the "
              f"curved path, want {want_n} ({busy} busy insertions, {steps} "
              f"with curved rows, {rescues} with rescued rows)")
    gd_steps = fo.COUNTERS["gd_steps"]
    for k, want_n in CURVED_ENCODE.items():
        if k == "hashgrid_encode_fwd":
            want_n += busy + 2 * steps + gd_steps + rescues
        elif k == "hashgrid_encode_bwd":
            want_n += gd_steps
        check(launches[k] == want_n, f"{k}: {launches[k]} launches, want "
              f"{want_n} ({busy} busy insertions, {steps} with curved rows, "
              f"{gd_steps} GD steps)")
    return launches, kept["inputs"], summary(text, wall)[0], meshes


def file_digest(path) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def run_evaluate(argv):
    """The evaluate CLI once, in-process, with every kernel's count and
    largest shape and the stage timers zeroed just before it.  Returns
    (stdout, the table's rows unrounded, launches, largest shapes, wall
    seconds, stage seconds, the traced meshes)."""
    from tropical_torch.ops import launches
    from tropical_torch.stanford import evaluate, train

    scored = evaluate.evaluate_against_grid_gt
    kept = []

    def keep_rows(*args, **kwargs):
        kept.append(scored(*args, **kwargs))
        return kept[-1]

    train.PHASES.totals.clear()
    train.PHASES.counts.clear()
    launches.reset()
    tee = Tee(sys.stdout)
    evaluate.evaluate_against_grid_gt = keep_rows
    t = time.time()
    try:
        with contextlib.redirect_stdout(tee), traced_meshes() as meshes:
            rc = evaluate.main(argv)
        torch.cuda.synchronize()
    finally:
        evaluate.evaluate_against_grid_gt = scored
    wall = time.time() - t
    counts, largest = dict(launches.LAUNCHES), dict(launches.LARGEST)
    check(rc == 0 and len(kept) == 1, f"evaluate {argv} returned {rc}")
    check_bvh_launches("evaluate " + " ".join(argv), counts, meshes)
    return (tee.buf.getvalue(), kept[0], counts, largest, wall,
            dict(train.PHASES.totals), meshes)


class PatchedField:
    """A net's field with its values at some grid points replaced: the
    same batches through ``net.sdf``, then the values of the rows at those
    points overwritten."""

    def __init__(self, net, points, values):
        self.net, self.device = net, net.device
        self.points, self.values = points, values

    def sdf(self, x):
        out = self.net.sdf(x).clone()
        rows, which = (x[:, None, :] == self.points[None]).all(-1).nonzero(
            as_tuple=True)
        out[rows, 0] = self.values[which]
        return out


def zeros_as_jax(net, res, near_zero):
    """The grid indices where the port's field at res is exactly 0, and the
    field with JAX's values there (``near_zero``: the golden's ``[i, j, k,
    value]`` at this resolution).  Fails where JAX's field is not near 0
    at such a point, or gave it two values."""
    from tropical_torch.utils.isosurface import sdf_grid
    from tropical_torch.utils.marching_cubes import grid_axis

    zeros = [tuple(z) for z in
             torch.nonzero(sdf_grid(net, res, 1.2) == 0).tolist()]
    jax_vals = {}
    for i, j, k, v in near_zero:
        jax_vals.setdefault((i, j, k), set()).add(v)
    check(all(len(jax_vals.get(z, ())) == 1 for z in zeros),
          f"at {res} the port's field is 0 at {zeros}, JAX's values there "
          f"{[jax_vals.get(z) for z in zeros]}")
    s = grid_axis(res, 1.2, net.device)
    points = torch.stack([torch.stack([s[i], s[j], s[k]])
                          for i, j, k in zeros]) if zeros else s.new_empty(0, 3)
    values = torch.tensor([next(iter(jax_vals[z])) for z in zeros],
                          dtype=torch.float32, device=net.device)
    return zeros, PatchedField(net, points, values)


def hold_eval_table(method, text, rows, golden, net):
    """Each row (unrounded) and the on-grid count against the JAX CLI's
    golden.  A row whose vertex count differs is rebuilt with JAX's values
    at the port's exact zeros and must then give the golden's count."""
    from evaluate_table import parse_table
    from tropical_torch.utils.isosurface import run_marching_tetrahedra
    from tropical_torch.utils.marching_cubes import run_marching_cubes

    printed = parse_table(text)
    want = golden["runs"][method]
    check([(r["label"], r["vertices"]) for r in printed["rows"]]
          == [r[:2] for r in rows], f"{method}: printed rows "
          f"{printed['rows']} are not the returned {rows}")
    check([r[0] for r in rows] == [r["label"] for r in want["rows"]],
          f"{method}: rows {[r[0] for r in rows]}")
    check(printed["on_grid"] == want["on_grid"],
          f"{method}: {printed['on_grid']} vertices on the grid marks, "
          f"golden {want['on_grid']}")
    gt_res = int(rows[1][0])
    for (label, n_verts, cd, ad, t), g in zip(rows, want["rows"]):
        dcd, dad = abs(cd - g["cd_nn"]), abs(ad - g["ad_jax"])
        rebuilt = ""
        if n_verts != g["vertices"]:
            res = int(label)
            zeros, field = zeros_as_jax(net, res,
                                        want["near_zero"].get(str(res), []))
            run = (run_marching_cubes if method == "mc" or res == gt_res
                   else run_marching_tetrahedra)
            n_as_jax = run(field, res, 1.2).vertices.shape[0]
            rebuilt = (f"; exact zeros at {zeros}, with JAX's values there "
                       f"{n_as_jax}")
            check(n_as_jax == g["vertices"], f"{method} row {label}: "
                  f"{n_verts} vertices{rebuilt}, golden {g['vertices']}")
        print(f"  {label:>4}: {n_verts} vertices (golden {g['vertices']}"
              f"{rebuilt}), CD {cd:.9f} (exact neighbours {g['cd_nn']:.9f}, "
              f"off {cd - g['cd_nn']:.3e}; JAX's {g['cd_jax']:.9f}), AD "
              f"{ad:.4f} ({g['ad_jax']:.4f}), {t:.2f} s")
        check(dcd <= EVAL_CD_TOL and dad <= EVAL_AD_TOL,
              f"{method} row {label}: CD {cd}, AD {ad} against the golden "
              f"{g}")
    return rows


def hold_committed_mt(tag):
    """The exported marching-tetrahedra meshes at 16..64 against the
    committed ones: equal faces under a nearest-neighbour bijection."""
    from tropical_torch.ops.chamfer import min_dist_plain
    from tropical_torch.utils.ply import read_ply

    out = {}
    for res in (16, 32, 48, 64):
        name = f"mtet{res:03d}_mesh_{tag}.ply"
        ours = read_ply(os.path.join("meshes_torch", "sphere", name))
        ref = read_ply(os.path.join("meshes", "sphere", name))
        check(ours.faces.shape == ref.faces.shape
              and ours.vertices.shape == ref.vertices.shape,
              f"{name}: {ours.vertices.shape}/{ours.faces.shape} != committed "
              f"{ref.vertices.shape}/{ref.faces.shape}")
        d2, idx = min_dist_plain(
            torch.from_numpy(ours.vertices.astype(np.float32)).cuda(),
            torch.from_numpy(ref.vertices.astype(np.float32)).cuda())
        idx = idx.cpu().numpy()
        dist = float(np.abs(ours.vertices - ref.vertices[idx]).max())
        bijection = len(np.unique(idx)) == len(idx)
        faces = bool(np.array_equal(idx[ours.faces], ref.faces))
        out[res] = {"faces": int(ours.faces.shape[0]), "bijection": bijection,
                    "faces_equal": faces, "max_vertex_distance": dist}
        check(bijection and faces and dist <= COMMITTED_MT_TOL,
              f"{name} against the committed mesh: {out[res]}")
    print(json.dumps({"committed_mtet": out}))


def mt_card_vs_cpu(net):
    """Marching tetrahedra on the card and on the CPU over one field the
    card computed: vertices and triangles bitwise."""
    from tropical_torch.utils import isosurface as iso
    from tropical_torch.utils.marching_cubes import grid_axis, grid_points

    res = MT_BITWISE_RES
    vals = iso.sdf_grid(net, res, 1.2).reshape(-1)
    pts = grid_points(grid_axis(res, 1.2, net.device), 0,
                      res ** 3).to(torch.float64)
    tets = iso.grid_tetrahedra(res, res, net.device)
    v_gpu, t_gpu = iso.marching_tetrahedra(pts, tets, vals)
    v_cpu, t_cpu = iso.marching_tetrahedra(pts.cpu(), tets.cpu(), vals.cpu())
    same = (torch.equal(v_gpu.cpu(), v_cpu)
            and torch.equal(t_gpu.cpu(), t_cpu))
    print(f"marching tetrahedra at {res} on the card's field: "
          f"{v_gpu.shape[0]} vertices, {t_gpu.shape[0]} triangles; card and "
          f"CPU bitwise: {same}")
    check(same and t_gpu.shape[0] > 0,
          "marching tetrahedra differ between the card and the CPU")


def slab_merges(net):
    """Every crossing on the slabs' shared x-planes merges, for marching
    tetrahedra at the ladder's sizes and marching cubes at both pseudo-GTs."""
    from tropical_torch.utils import isosurface as iso
    from tropical_torch.utils import marching_cubes as mc

    out = {}
    for name, slabs, res in [("mt", iso.mt_slabs, r) for r in (32, 48, 64, 96)] \
            + [("mc", mc.mc_slabs, r) for r in (128, 256)]:
        merged, crossings = mc.slab_merge_counts(slabs(net, res, 1.2))
        out[f"{name}{res}"] = [merged, crossings]
        check(merged == crossings > 0,
              f"{name} at {res}: {merged} vertices merged across slabs, "
              f"{crossings} crossings on the shared planes")
    print(json.dumps({"slab_merges_and_crossings": out}))


def evaluate_phase(mesh_digest, records):
    """The evaluate CLI, -t mtet and -t mc, on phase 4's mesh; then the
    encode forward at the runs' largest forward.  Returns each run's
    kernel launches, the -t mtet run's pseudo-GT (its largest traced mesh)
    and each run's traced meshes."""
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.stanford.evaluate import resolutions_for
    from tropical_torch.stanford.train import cached_checkpoint
    from tropical_torch.utils import checkpoint as ckpt
    from tropical_torch.utils.marching_cubes import SLAB

    sys.path.insert(0, "tests")
    mesh = "meshes_torch/sphere/our_mesh_small_1.ply"
    golden = json.load(open(EVAL_GOLDEN))
    net = net_for_size("small", "sphere", 1, device="cuda")
    ckpt.load_into(net, cached_checkpoint("sphere", "small", 1))
    launches, largest, traced = {}, {}, {}
    for method, argv in EVAL_ARGV.items():
        phase("9. evaluate CLI: python -m tropical_torch.stanford.evaluate "
              + " ".join(argv))
        check(file_digest(mesh) == mesh_digest,
              f"{mesh} is not the mesh phase 4 wrote")
        text, rows, counts, shapes, wall, stages, meshes = run_evaluate(argv)
        hold_eval_table(method, text, rows, golden, net)
        gt_res = int(rows[1][0])
        ladder = resolutions_for(method, "small", gt_res)
        want = {"hashgrid_encode_fwd": sum(len(range(0, r - 1, SLAB))
                                           for r in ladder),
                # "Ours" and each baseline row, two searches each
                "min_dist": 2 * (len(rows) - 1)}
        print(json.dumps({"method": method, "wall_s": wall,
                          "eval_stage_s": stages,
                          "row_s": {r[0]: r[4] for r in rows},
                          "launches": counts, "largest": shapes}))
        for k, n in want.items():
            check(counts[k] == n, f"{method}: {k} {counts[k]} launches, "
                  f"want {n}")
        check(counts["trilinear_roots"] == 0
              and counts["hashgrid_encode_bwd"] == 0,
              f"{method}: unexpected launches {counts}")
        launches[method], traced[method] = counts, meshes
        for k, shape in shapes.items():
            if shape and math.prod(shape) > math.prod(largest.get(k, (0,))):
                largest[k] = shape
        if method == "mtet":
            hold_committed_mt("small_1")
            gt_mesh = max(meshes, key=lambda m: m[1].shape[0])

    mt_card_vs_cpu(net)
    slab_merges(net)
    # no search larger than the 100,000 x 100,000 held in phase 3
    check(max(largest["min_dist"]) <= 100000,
          f"evaluate's largest min_dist {largest['min_dist']}")
    phase("9. the encode forward at the evaluate runs' largest forward, the "
          f"{EVAL_GT_RES} pseudo-GT's first slab, on the checkpoint's table")
    encode_on_slab(records["hashgrid_encode_fwd"], "evaluate", net.spec.grid,
                   net.enc.table.detach(), largest["hashgrid_encode_fwd"],
                   EVAL_GT_RES, 0)
    return launches, gt_mesh, traced


# ---- 10. the BVH tracer ---------------------------------------------------------

def bits_equal(a, b) -> bool:
    """The same shape and bits (floats by their bit patterns)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def bvh_bound_ms(nbytes, tests, ops) -> tuple[float, str]:
    """Least time of a BVH kernel: ``nbytes`` at 3.35 TB/s against the
    float operations of the box and triangle ``tests`` it made (``ops`` a
    test of each) at PEAK_F32_UNFUSED_OPS."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = (tests[0] * ops[0] + tests[1] * ops[1]) / PEAK_F32_UNFUSED_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def visit_counts(lib) -> list:
    """(box tests, triangle tests) of an instrumented build since the last
    read, which zeroes them."""
    out = (ctypes.c_ulonglong * 2)()
    lib.bvh_visit_counts.argtypes = [ctypes.c_void_p]
    lib.bvh_visit_counts.restype = ctypes.c_int
    check(lib.bvh_visit_counts(out) == 0, "bvh_visit_counts failed")
    return list(out)


def counted_query(lib, tree, queries, launch) -> dict:
    """One ``launch()`` of the instrumented build's query on ``tree`` over
    ``queries`` rows, with the nodes it reads marked: its (box, triangle)
    tests, the bytes of the tree it read (each box, child pair, triangle
    and face id it touched, once) and each query's tests, their largest and
    the mean over warps (32 consecutive queries) of each warp's largest."""
    n = tree.n
    touched = torch.zeros((3, 2 * n - 1), dtype=torch.uint8, device="cuda")
    per_query = torch.zeros((queries, 2), dtype=torch.int32, device="cuda")
    lib.bvh_count_buffers.argtypes = [ctypes.c_void_p] * 2
    lib.bvh_count_buffers.restype = ctypes.c_int
    check(lib.bvh_count_buffers(touched.data_ptr(), per_query.data_ptr())
          == 0, "bvh_count_buffers failed")
    visit_counts(lib)
    out = launch()
    tests = visit_counts(lib)
    check(lib.bvh_count_buffers(None, None) == 0, "bvh_count_buffers failed")
    marks = touched.sum(dim=1, dtype=torch.int64).tolist()
    expanded_leaves = int(touched[1, n - 1:].sum(dtype=torch.int64))
    nbytes = (24 * marks[0] + 8 * (marks[1] - expanded_leaves)
              + 36 * expanded_leaves + 4 * marks[2])
    q = per_query.to(torch.int64)
    check(q.sum(dim=0).tolist() == tests,
          f"per-query tests {q.sum(dim=0).tolist()} != totals {tests}")
    pad = (-queries) % 32
    warps = torch.cat([q, q.new_zeros((pad, 2))]).view(-1, 32, 2)
    return {"out": out, "tests": tests, "tree_bytes": nbytes,
            "tree_bytes_all": tree_bytes(tree),
            "nodes_read": marks, "mean": (q.double().mean(dim=0)).tolist(),
            "max": q.max(dim=0).values.tolist(),
            "warp_max_mean": warps.max(dim=1).values.double().mean(
                dim=0).tolist()}


def tree_bytes(tree) -> int:
    """All the bytes of a tree a query may read: boxes, children, the
    triangles in leaf order and their face ids."""
    return sum(t.numel() * t.element_size()
               for t in (tree.boxes, tree.children, tree.tris, tree.order))


def traced_vs_plain(label, q, o, d) -> tuple[float, float]:
    """``bvh_ray``'s first hits of the rays (o, d) on the mesh of ``q``
    against the plain tiles, bitwise.  Returns (the plain tiles' ms, the
    largest |t - plain t| over rays that hit)."""
    from tropical_torch.ops import bvh
    from tropical_torch.ops import mesh_queries as mq

    t, fid = bvh.first_hits(q.bvh, o, d)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want_t, want_id = mq.first_hits_plain(q.tris, o, d)
    end.record()
    torch.cuda.synchronize()
    id_bad = int((fid != want_id).sum())
    t_bad = int((t.view(torch.int32) != want_t.view(torch.int32)).sum())
    hit = want_id >= 0
    err = float((t - want_t)[hit].abs().max()) if bool(hit.any()) else 0.0
    print(f"bvh_ray {label}, {q.bvh.n} triangles, {o.shape[0]} rays "
          f"({int(hit.sum())} hit): face id mismatches {id_bad}, t bit "
          f"mismatches {t_bad}; plain {start.elapsed_time(end):.1f} ms")
    check(id_bad == 0 and t_bad == 0,
          f"bvh_ray {label}: {id_bad} face ids and {t_bad} t differ from "
          "the plain tiles")
    return start.elapsed_time(end), err


def build_vs_plain(label, tris, tree) -> None:
    """The card's tree (``bvh_hierarchy``, ``bvh_refit``) over ``tris``
    [n, 3, 3] against the plain build, bitwise: children, parents, far
    ends, boxes, node records and padded triangles."""
    from tropical_torch.ops import bvh

    children, parents, far = bvh.hierarchy_plain(bvh.morton_keys(tris))
    boxes = bvh.refit_plain(tree.tris, children, tree.pad)
    check(torch.equal(children, tree.children)
          and torch.equal(parents, tree.parents)
          and torch.equal(far, tree.far),
          f"{label}: bvh_hierarchy differs from its plain version")
    check(bits_equal(boxes, tree.boxes)
          and bits_equal(bvh.records_plain(children, boxes), tree.records)
          and bits_equal(torch.nn.functional.pad(tree.tris, (0, 3)),
                         tree.tris_padded),
          f"{label}: bvh_refit differs from its plain version "
          f"({tree.n} triangles)")


def same_bits(a, b) -> bool:
    """Bitwise equal, a NaN matching any NaN."""
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and bits_equal(a[~nan].contiguous(), b[~nan].contiguous()))


def closest_sets_vs_plain(cases) -> dict:
    """``bvh_closest`` (both passes, ``run_closest``) on each labelled
    (MeshQuery, points) against the plain tiles, bitwise (a NaN matching a
    NaN).  Returns the points each set queued for pass 2."""
    from tropical_torch.ops import bvh, cuda_build
    from tropical_torch.ops import mesh_queries as mq

    lib = cuda_build.load("bvh")
    queued = {}
    for label, (q, p) in cases.items():
        got, queued[label] = bvh.run_closest(lib, q.bvh, p)
        want = mq.min_dist2_plain(q.tris, p)
        ok = same_bits(got, want)
        print(f"bvh_closest {label}: {p.shape[0]} points, {q.bvh.n} "
              f"triangles, {queued[label]} through pass 2; bitwise the "
              f"plain tiles: {ok}; NaN {int(torch.isnan(want).sum())}, "
              f"zero {int((want == 0).sum())}")
        check(ok, f"bvh_closest differs from the plain tiles on {label}")
    return queued


def closest_runner(lib, tree, p):
    """A raw ``launch_closest`` of ``lib`` on ``tree`` and ``p``, into
    buffers made once; its state is read after timing."""
    from tropical_torch.ops import bvh

    d2 = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    state = torch.zeros(2, dtype=torch.int32, device=p.device)
    queue = torch.empty((p.shape[0], 2), dtype=torch.int32, device=p.device)

    def run():
        bvh.launch_closest(lib, tree, p, d2, state, queue)

    run.state = state
    return run


def refit_runner(lib, tree):
    """A raw ``launch_refit`` of ``lib`` at ``tree``, its arrivals zeroed
    first, into boxes that are checked after timing."""
    from tropical_torch.ops import bvh

    arrivals = torch.zeros(max(tree.n - 1, 1), dtype=torch.int32,
                           device=tree.tris.device)
    boxes = torch.empty_like(tree.boxes)
    records = torch.empty_like(tree.records)
    tris_padded = torch.empty_like(tree.tris_padded)

    def run():
        arrivals.zero_()
        bvh.launch_refit(lib, tree.tris, tree.children, tree.parents,
                         tree.far, tree.pad, arrivals, boxes, records,
                         tris_padded)

    run.boxes, run.records, run.tris_padded = boxes, records, tris_padded
    return run


def bvh_kernel_times(tree, keys, o, d, labels_tree, points, direction,
                     ladder_tree, centre_labels, gt_centre):
    """Device ms of each BVH kernel alone, a CUDA graph of 100 raw
    launches (``ops/bvh.launch_*``: the wrappers' overflow check, a read
    back, is left out): the build at ``tree``'s mesh, first hits of (o, d)
    on it, and the labels' closest-point query and parity count of
    ``points`` on ``labels_tree``; ``bvh_refit`` also at ``ladder_tree``
    and ``bvh_closest`` also on the centre sets, each beside its first
    design (``BVH_FIRST``; on the pseudo-GT's centre set over 3 launches,
    CUDA events, not a graph: its one thread a point walks a large part of
    the tree)."""
    from tropical_torch.ops import bvh, cuda_build

    lib = cuda_build.load("bvh")
    first = cuda_build.load(BVH_FIRST)
    dev = keys.device
    children = torch.empty_like(tree.children)
    parents = torch.full_like(tree.parents, -1)
    far = torch.empty_like(tree.far)
    out_t = torch.empty(o.shape[0], dtype=torch.float32, device=dev)
    out_id = torch.empty(o.shape[0], dtype=torch.int32, device=dev)
    hits = torch.empty(points.shape[0], dtype=torch.int32, device=dev)
    overflow = torch.zeros(1, dtype=torch.int32, device=dev)
    refits = {"bvh_refit": refit_runner(lib, tree),
              "bvh_refit_first": refit_runner(first, tree),
              "bvh_refit_ladder": refit_runner(lib, ladder_tree),
              "bvh_refit_ladder_first": refit_runner(first, ladder_tree)}
    closests = {
        "bvh_closest": closest_runner(lib, labels_tree, points),
        "bvh_closest_first": closest_runner(first, labels_tree, points),
        "bvh_closest_centre_labels": closest_runner(lib, labels_tree,
                                                    centre_labels),
        "bvh_closest_centre_labels_first": closest_runner(
            first, labels_tree, centre_labels),
        "bvh_closest_centre_gt": closest_runner(lib, tree, gt_centre),
        "bvh_closest_centre_gt_first": closest_runner(first, tree,
                                                      gt_centre)}
    first_tree = (torch.empty_like(tree.children),
                  torch.full_like(tree.parents, -1), torch.empty_like(tree.far))
    queue = torch.empty(tree.n, dtype=torch.int32, device=dev)
    first_queue = torch.empty_like(queue)
    first_t, first_id = torch.empty_like(out_t), torch.empty_like(out_id)
    first_hits = torch.empty_like(hits)
    times = {
        "bvh_hierarchy": graph_ms(lambda: bvh.launch_hierarchy(
            lib, keys, children, parents, far, queue)),
        "bvh_hierarchy_first": graph_ms(lambda: bvh.launch_hierarchy(
            first, keys, *first_tree, first_queue)),
        **{k: graph_ms(run) for k, run in refits.items()},
        "bvh_ray": graph_ms(lambda: bvh.launch_ray(
            lib, tree, o, d, False, out_t, out_id, overflow)),
        "bvh_ray_first": graph_ms(lambda: bvh.launch_ray(
            first, tree, o, d, False, first_t, first_id, overflow)),
        "bvh_ray_labels_parity": graph_ms(lambda: bvh.launch_ray(
            lib, labels_tree, points, direction, True, out_t, hits,
            overflow)),
        "bvh_ray_labels_parity_first": graph_ms(lambda: bvh.launch_ray(
            first, labels_tree, points, direction, True, out_t, first_hits,
            overflow))}
    for k, run in closests.items():
        times[k] = (cuda_ms(run, iters=3) if k == "bvh_closest_centre_gt_first"
                    else graph_ms(run))
    torch.cuda.synchronize()
    check(int(overflow) == 0, "a BVH stack overflowed while timed")
    check(all(run.state[0] == 0 for run in closests.values()),
          "a bvh_closest stack or queue overflowed while timed")
    want_t, want_id = bvh.first_hits(tree, o, d)
    check(all(torch.equal(a, b) for a, b in zip(
              first_tree, (tree.children, tree.parents, tree.far)))
          and bits_equal(first_t, want_t) and bits_equal(out_t, want_t)
          and torch.equal(first_id.long(), want_id)
          and torch.equal(out_id.long(), want_id)
          and torch.equal(first_hits, hits),
          "the first designs of bvh_hierarchy and bvh_ray differ from the "
          "designs while timed")
    check(torch.equal(children, tree.children)
          and torch.equal(parents, tree.parents)
          and torch.equal(far, tree.far)
          and all(bits_equal(run.boxes, t.boxes) for run, t in (
              (refits["bvh_refit"], tree), (refits["bvh_refit_first"], tree),
              (refits["bvh_refit_ladder"], ladder_tree),
              (refits["bvh_refit_ladder_first"], ladder_tree)))
          and all(bits_equal(run.records, t.records)
                  and bits_equal(run.tris_padded, t.tris_padded)
                  for run, t in ((refits["bvh_refit"], tree),
                                 (refits["bvh_refit_ladder"], ladder_tree))),
          "the timed build differs from the wrapper's")
    times["queued"] = {k: int(run.state[1]) for k, run in closests.items()}
    times["hierarchy_queued"] = int(queue[0])
    return times


def build_parts_ms(tris) -> dict:
    """One ``bvh.build`` call on ``tris`` [n, 3, 3] split into its parts,
    each timed alone as the whole call is (CUDA events over 20 calls: the
    host's time where the host sets it): the Morton keys, their sort, the
    leaf order and gather, ``box_pad`` (a read back to the host), and the
    hierarchy and refit wrappers (allocation and launch)."""
    from tropical_torch.ops import bvh, cuda_build

    lib = cuda_build.load("bvh")
    n = tris.shape[0]
    flat = tris.reshape(n, 9)
    codes = bvh.morton_codes(tris)
    keys = torch.sort(codes).values
    pad = bvh.box_pad(tris)

    def gather():
        return flat[(keys & 0xFFFFFFFF).to(torch.int32).to(torch.int64)
                    ].contiguous()

    leaf = gather()
    children, parents, far = bvh.run_hierarchy(lib, keys)
    return {"Morton keys": cuda_ms(lambda: bvh.morton_codes(tris), 20),
            "sort": cuda_ms(lambda: torch.sort(codes), 20),
            "leaf order and gather": cuda_ms(gather, 20),
            "box_pad (a host read)": cuda_ms(lambda: bvh.box_pad(tris), 20),
            "hierarchy call": cuda_ms(lambda: bvh.run_hierarchy(lib, keys),
                                      20),
            "refit call": cuda_ms(lambda: bvh.run_refit(
                lib, leaf, children, parents, far, pad), 20)}


def closest_bound_ms(c, npts) -> tuple[float, str]:
    """The bound of a closest-point query over ``npts`` points, from the
    first design's counts ``c`` (``counted_query``): points in, d2 out, the
    part of the tree they read; the tests that design made."""
    return bvh_bound_ms(npts * (12 + 4) + c["tree_bytes"], c["tests"],
                        BVH_CLOSEST_OPS)


def refit_bound_ms(n) -> tuple[float, str]:
    """The build's boxes over ``n`` triangles: triangles, parents and
    children read, boxes written (the [2n-1, 6] layout); 12 min/max a leaf
    and 6 an internal node."""
    return bvh_bound_ms(36 * n + 4 * (2 * n - 1) + 8 * (n - 1)
                        + 24 * (2 * n - 1), (12 * n + 6 * (n - 1), 0), (1, 0))


def bvh_phase(traced, gt_mesh, records):
    """The BVH tracer against the plain tiles: ``bvh_ray`` on every mesh
    the paths traced (``traced``: a label to the meshes of that run; the
    -t mtet run's pseudo-GT, ``gt_mesh``, among them) and an icosphere
    under adversarial rays, the build on each of them; the labels'
    closest-point query and parity count, and the closest-point sets.  Then
    each kernel timed beside its bound and its plain version."""
    phase("10. the BVH tracer against the plain tiles, bit for bit")
    import bvh_cases
    from tropical_torch.ops import bvh, cuda_build
    from tropical_torch.ops import mesh_queries as mq
    from tropical_torch.stanford.dataset import StanfordDataset
    from tropical_torch.utils.chamfer import get_rays
    from tropical_torch.utils.procedural import icosphere

    dev = torch.device("cuda")
    o, d = get_rays(EVAL_RAYS, device=dev)
    ray_err, checked, q, ladder = 0.0, 0, None, None
    for path, meshes in traced.items():
        for i, (v, f) in enumerate(meshes):
            if not f.shape[0]:
                continue
            mesh_q = mq.MeshQuery(v, f, dev)
            label = f"{path}, traced mesh {i + 1}/{len(meshes)}"
            build_vs_plain(label, mesh_q.tris, mesh_q.bvh)
            ms, err = traced_vs_plain(label, mesh_q, o, d)
            ray_err = max(ray_err, err)
            checked += 1
            if v is gt_mesh[0]:
                q, plain_ray_ms = mesh_q, ms
            if path == "flat" and (ladder is None
                                   or mesh_q.bvh.n > ladder.bvh.n):
                ladder = mesh_q
    check(q is not None, "the pseudo-GT is not among the traced meshes")
    print(f"bvh_ray bitwise the plain tiles, and the build its plain "
          f"versions, on all {checked} traced meshes of {len(traced)} runs")
    ico = icosphere(BVH_ICOSPHERE)
    qi = mq.MeshQuery(ico.vertices, ico.faces, dev)
    build_vs_plain(f"icosphere({BVH_ICOSPHERE})", qi.tris, qi.bvh)
    extra = [bvh_cases.adversarial_rays(qi.tris, 0, s)
             for s in BVH_ADVERSARIAL_SEEDS]
    _, err = traced_vs_plain(
        f"icosphere({BVH_ICOSPHERE}) under adversarial rays", qi,
        torch.cat([o, *(e[0] for e in extra)]),
        torch.cat([d, *(e[1] for e in extra)]))
    ray_err = max(ray_err, err)
    for k in (1, 2):  # a root leaf; a root with two leaves
        small = torch.tensor(np.stack([ico.vertices[ico.faces[f]]
                                       for f in range(k)]),
                             dtype=torch.float32, device=dev)
        build_vs_plain(f"{k} triangle(s)", small, bvh.build(small))
    print("the build bitwise its plain versions on meshes of 1 and 2 "
          "triangles")

    tree = q.bvh
    keys = bvh.morton_keys(q.tris)
    children, _, _ = bvh.hierarchy_plain(keys)
    depth = 0
    node = torch.arange(tree.n - 1, 2 * tree.n - 1, device=dev)  # the leaves
    while bool((node >= 0).any()):
        node = torch.where(node >= 0, tree.parents[node.clamp_min(0)], node)
        depth += 1
    print(f"the {EVAL_GT_RES} pseudo-GT's tree: {tree.n} leaves, depth "
          f"{depth - 1}; the flat ladder's largest mesh {ladder.bvh.n} "
          "triangles")

    # one resample of the training labels
    ds = StanfordDataset("sphere", rng=np.random.default_rng(TRAIN_SEED),
                         device=dev)
    lq, points = ds.query, ds.X
    direction = torch.from_numpy(mq._PARITY_DIR).to(dev)
    hits = bvh.crossings(lq.bvh, points, direction)
    d2 = bvh.min_dist2(lq.bvh, points)
    want_hits = mq.crossings_plain(lq.tris, points, direction)
    want_d2 = mq.min_dist2_plain(lq.tris, points)
    print(f"labels: {points.shape[0]} points, {lq.bvh.n} triangles: "
          f"crossing mismatches {int((hits != want_hits).sum())}, d2 bit "
          f"mismatches {int((d2.view(torch.int32) != want_d2.view(torch.int32)).sum())}; "
          f"inside {int((want_hits % 2 == 1).sum())}")
    check(torch.equal(hits, want_hits), "bvh_ray's crossing counts differ "
          "from the plain tiles on the labels")
    check(bits_equal(d2, want_d2), "bvh_closest differs from the plain "
          "tiles on the labels")

    # the closest-point sets, through both passes
    sets = bvh_cases.closest_sets(lq.tris, BVH_CENTRE_LABELS, BVH_SET_SEED)
    gt_centre = bvh_cases.centre_points(q.tris, BVH_CENTRE_GT, BVH_SET_SEED)
    queued = closest_sets_vs_plain({
        "labels": (lq, points),
        **{f"labels {k}": (lq, p) for k, p in sets.items()},
        "pseudo-GT centre": (q, gt_centre)})
    check(queued["labels centre"] > 0 and queued["pseudo-GT centre"] > 0,
          f"the centre sets did not go through pass 2: {queued}")

    # what the queries read and test, from the instrumented builds
    counted = cuda_build.load(BVH_COUNT)
    npts = points.shape[0]
    ray_c = counted_query(counted, tree, EVAL_RAYS, lambda: bvh.run_ray(
        counted, tree, o, d, False))
    parity_c = counted_query(counted, lq.bvh, npts, lambda: bvh.run_ray(
        counted, lq.bvh, points, direction.reshape(1, 3), True))
    closest_sets_c = {
        label: counted_query(counted, t, p.shape[0],
                             lambda t=t, p=p: bvh.run_closest(counted, t, p))
        for label, (t, p) in (("labels", (lq.bvh, points)),
                              ("labels centre", (lq.bvh, sets["centre"])),
                              ("pseudo-GT centre", (tree, gt_centre)))}
    closest_c = closest_sets_c["labels"]
    check(torch.equal(ray_c["out"][1], bvh.first_hits(tree, o, d)[1])
          and torch.equal(parity_c["out"][1], hits.to(torch.int32))
          and bits_equal(closest_c["out"][0], d2)
          and all(c["out"][1] == 0 for c in closest_sets_c.values()),
          "the instrumented build disagrees with the kernels")
    design = cuda_build.load(BVH_COUNT_DESIGN)
    design_c = {
        label: counted_query(design, t, p.shape[0],
                             lambda t=t, p=p: bvh.run_closest(design, t, p))
        for label, (t, p) in (("labels", (lq.bvh, points)),
                              ("labels centre", (lq.bvh, sets["centre"])),
                              ("pseudo-GT centre", (tree, gt_centre)))}
    for label, c in design_c.items():
        check(same_bits(c["out"][0], closest_sets_c[label]["out"][0]),
              f"the design's instrumented build disagrees on {label}")
        print(f"bvh_closest {label}: box and triangle tests {c['tests']} "
              f"in two passes ({c['out'][1]} points through pass 2; the "
              f"largest point's {c['max']}), the bound's one-thread "
              f"traversal {closest_sets_c[label]['tests']} (the largest "
              f"point's {closest_sets_c[label]['max']})")
    counts = {"bvh_ray_pseudo_gt": ray_c, "bvh_ray_labels_parity": parity_c,
              **{f"bvh_closest_{k}": c for k, c in closest_sets_c.items()},
              **{f"bvh_closest_{k}_two_pass": c
                 for k, c in design_c.items()}}
    for c in counts.values():
        del c["out"]
    print(json.dumps({"tests_a_query": counts}))

    # times: kernels alone (device), wrapper calls, plain versions
    times = bvh_kernel_times(tree, keys, o, d, lq.bvh, points,
                             direction.reshape(1, 3), ladder.bvh,
                             sets["centre"], gt_centre)
    build_call_ms = cuda_ms(lambda: bvh.build(q.tris), iters=10)
    build_parts = build_parts_ms(q.tris)
    print(json.dumps({"bvh_build_call_ms": build_call_ms,
                      "parts_ms": build_parts,
                      "parts_sum_ms": sum(build_parts.values())}))
    ray_call_ms = cuda_ms(lambda: bvh.first_hits(tree, o, d), iters=10)
    label_call_ms = cuda_ms(lambda: lq.signed_distance(points), iters=10)
    plain = {"bvh_hierarchy": cuda_ms(lambda: bvh.hierarchy_plain(keys), 3),
             "bvh_refit": cuda_ms(lambda: bvh.refit_plain(
                 tree.tris, children, tree.pad), 3),
             "bvh_ray": plain_ray_ms,
             "bvh_closest": cuda_ms(lambda: mq.min_dist2_plain(lq.tris,
                                                               points), 3)}
    plain_parity_ms = cuda_ms(lambda: mq.crossings_plain(lq.tris, points,
                                                         direction), 3)
    n = tree.n
    bounds = {
        # keys read; children and parents written
        "bvh_hierarchy": bvh_bound_ms(8 * n + 8 * (n - 1) + 4 * (2 * n - 1),
                                      (0, 0), (0, 0)),
        "bvh_refit": refit_bound_ms(n),
        # rays in, (t, id) out; the part of the tree these rays read
        "bvh_ray": bvh_bound_ms(EVAL_RAYS * (24 + 8) + ray_c["tree_bytes"],
                                ray_c["tests"], BVH_RAY_OPS),
        "bvh_closest": closest_bound_ms(closest_c, npts)}
    centre_bounds = {
        "labels centre": closest_bound_ms(closest_sets_c["labels centre"],
                                          BVH_CENTRE_LABELS),
        "pseudo-GT centre": closest_bound_ms(
            closest_sets_c["pseudo-GT centre"], BVH_CENTRE_GT)}
    ladder_bound = refit_bound_ms(ladder.bvh.n)
    parity_bound = bvh_bound_ms(npts * (12 + 4) + 12
                                + parity_c["tree_bytes"], parity_c["tests"],
                                BVH_RAY_OPS)
    shapes = {"bvh_hierarchy": [n], "bvh_refit": [n],
              "bvh_ray": [EVAL_RAYS, n],
              "bvh_closest": [npts, lq.bvh.n]}
    for k in BVH:
        ms = times[k]
        bound_ms, bound_by = bounds[k]
        records[k] = {"name": k, "route": "cuda",
                      "source": "tropical_torch/csrc/bvh.cu",
                      "replaces": BVH_REPLACES[k],
                      "max_abs_err": ray_err if k == "bvh_ray" else 0.0,
                      "ms": ms, "plain_ms": plain[k], "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None,
                      "shape": shapes[k]}
        first = (f", first design {times[k + '_first']:.4f} ms"
                 if k + "_first" in times else "")
        print(f"{k} {shapes[k]}: kernel {ms:.4f} ms{first}, plain "
              f"{plain[k]:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}); "
              f"kernel at {bound_ms / ms:.1%} of the bound")
    centre = {}
    for label, key, npts_set, t in (
            ("labels centre", "centre_labels", BVH_CENTRE_LABELS, lq.bvh),
            ("pseudo-GT centre", "centre_gt", BVH_CENTRE_GT, tree)):
        ms, first_ms = (times[f"bvh_closest_{key}"],
                        times[f"bvh_closest_{key}_first"])
        bound_ms, bound_by = centre_bounds[label]
        centre[key] = {"shape": [npts_set, t.n], "ms": ms,
                       "first_design_ms": first_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       "queued": times["queued"][f"bvh_closest_{key}"],
                       "tests": design_c[label]["tests"],
                       "tests_first_design": closest_sets_c[label]["tests"]}
        print(f"bvh_closest {label} [{npts_set}, {t.n}]: kernel {ms:.4f} "
              f"ms, first design {first_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}); kernel at {bound_ms / ms:.2%} of the bound, "
              f"the first design at {bound_ms / first_ms:.2%}")
    print(f"bvh_refit at the flat ladder's largest mesh [{ladder.bvh.n}]: "
          f"kernel {times['bvh_refit_ladder']:.4f} ms, first design "
          f"{times['bvh_refit_ladder_first']:.4f} ms, bound "
          f"{ladder_bound[0]:.5f} ms ({ladder_bound[1]}); kernel at "
          f"{ladder_bound[0] / times['bvh_refit_ladder']:.1%} of the bound")
    print(f"bvh_ray labels parity [{npts}, {lq.bvh.n}]: kernel "
          f"{times['bvh_ray_labels_parity']:.4f} ms, first design "
          f"{times['bvh_ray_labels_parity_first']:.4f} ms, bound "
          f"{parity_bound[0]:.5f} ms ({parity_bound[1]})")
    records["bvh_ray"].update(
        first_design_ms=times["bvh_ray_first"],
        labels_parity_first_design_ms=times["bvh_ray_labels_parity_first"],
        labels_parity_ms=times["bvh_ray_labels_parity"],
        labels_parity_plain_ms=plain_parity_ms,
        labels_parity_bound_ms=parity_bound[0],
        labels_parity_bound_by=parity_bound[1],
        labels_parity_shape=[npts, lq.bvh.n],
        call_ms=ray_call_ms, tests=ray_c["tests"],
        tests_max=ray_c["max"], tests_warp_max_mean=ray_c["warp_max_mean"],
        tree_bytes_read=ray_c["tree_bytes"],
        labels_parity_tests=parity_c["tests"],
        labels_parity_tree_bytes_read=parity_c["tree_bytes"],
        meshes_checked=checked)
    records["bvh_closest"].update(
        first_design_ms=times["bvh_closest_first"],
        tests=closest_c["tests"], tests_max=closest_c["max"],
        tests_warp_max_mean=closest_c["warp_max_mean"],
        tests_two_pass=design_c["labels"]["tests"],
        queued=times["queued"]["bvh_closest"],
        tree_bytes_read=closest_c["tree_bytes"], labels_call_ms=label_call_ms,
        sets_queued=queued, **centre)
    records["bvh_hierarchy"].update(
        first_design_ms=times["bvh_hierarchy_first"],
        queued=times["hierarchy_queued"])
    records["bvh_refit"].update(
        first_design_ms=times["bvh_refit_first"], build_call_ms=build_call_ms,
        build_call_parts_ms=build_parts,
        depth=depth - 1, ladder_shape=[ladder.bvh.n],
        ladder_ms=times["bvh_refit_ladder"],
        ladder_first_design_ms=times["bvh_refit_ladder_first"],
        ladder_bound_ms=ladder_bound[0], ladder_bound_by=ladder_bound[1])
    print(json.dumps({"bvh_calls_ms": {
        "build at the pseudo-GT (keys, sort, both kernels)": build_call_ms,
        "first hits at the pseudo-GT": ray_call_ms,
        "signed distance of the labels": label_call_ms},
        "labels_parity": {"ms": times["bvh_ray_labels_parity"],
                          "plain_ms": plain_parity_ms,
                          "bound_ms": parity_bound[0],
                          "bound_by": parity_bound[1]}}))

# --- the device extraction engine's kernels (K2-K5) --------------------------

class StageLog:
    """Records the device engine's stage calls while ``on`` (each tensor
    argument cloned: the inputs as the engine gave them), by wrapping the
    stage functions of tropical_torch/extract/device.py."""

    def __init__(self):
        from tropical_torch.extract import device as dv

        self.dv, self.calls, self.on, self.plane = dv, [], False, None
        self.orig = {name: getattr(dv, name)
                     for name in (*DEVICE_STAGES, *K4C_STAGES)}

    def __enter__(self):
        for name, fn in self.orig.items():
            setattr(self.dv, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dv, name, fn)

    def _wrap(self, name, fn):
        def stage(*args, **kw):
            if self.on:
                self.calls.append((name, clones(args), kw, self.plane))
            return fn(*args, **kw)
        return stage


def clones(args):
    return [a.clone() if torch.is_tensor(a) else a for a in args]


def _nb(t):
    return 0 if t is None else t.numel() * t.element_size()


def stage_bytes(name, a):
    """The bytes a stage call must move: each input read once, each output
    written once; of a pool the call gathers from, the rows it reads.  K5's
    pair scan needs the rows, keys and permutation, a candidate's words, a
    count a candidate and the pairs: its column table, gathered rows and
    [n, 9] counts are the design's own traffic (``design_bytes``).  K3's
    bound is its whole skeleton's (``k3_bytes``), none a stage's; K4's the
    function's (``k4_bytes``)."""
    if name in K3_STAGES:
        return 0
    if DEVICE_STAGES.get(name) == "split_step":
        return k4_bytes(name, a)
    if name == "hit_mark":
        return _nb(a[0]) + 4 * a[0].shape[0]
    if name == "candidates":
        n = a[5] + a[6]
        return _nb(a[3]) + n * (12 + 16 + 20)
    if name == "connect_table":
        return 0
    if name in ("connect_count", "connect_fill"):
        n = a[0].shape[0]
        extra = 4 * n + (8 * a[11] if name == "connect_fill" else 0)
        return _nb(a[0]) + _nb(a[1]) + _nb(a[2]) + 16 * n + extra
    if name == "census_edges":
        return sum(_nb(t) for t in a[:6]) + _nb(a[7])
    if name == "census_vertices":
        return _nb(a[0]) + _nb(a[1])
    if name == "compact_rows":
        row = _nb(a[0]) // max(a[0].shape[0], 1)
        return _nb(a[1]) + 2 * a[2] * row
    if name == "compact_edges":
        return _nb(a[1]) + 24 * a[3]
    raise KeyError(name)


def k3_bytes(N, M, n_used, n_edges, dist=True):
    """The bytes K3 must move: out [N, 33] read once, and in dist mode dq
    and |grad sdf| (the pool's input); the marks; the skeleton written once:
    168 bytes a vertex (V, OUT, SB, ZB, SZ), 8 an edge."""
    return (132 + (8 if dist else 0)) * N + 4 * M + 168 * n_used + 8 * n_edges


def k4_bytes(name, a):
    """The bytes K4 must move, by the part of the function a stage call of
    either design computes, each input read once and each output written
    once: the split bits of EB (``split_mark``); of the S split edges their
    ends, both ends' V rows, outputs at plane idx and zero words, and the
    new vertices written, which the forward reads (``split_lerp``); OUTn
    (``split_override``); OUTn's override columns written where it fires,
    the new words, E's rewrite and the right edges written, and but at the
    final insertion the ends' sign words read and the left and right
    edges' split words and last differing columns written
    (``split_append``); ``split_select`` and ``split_finish`` are the sums
    of those two pairs; ``pack_words`` and ``edge_words``: their inputs,
    of a pool the rows gathered, and outputs.  The first design's flags
    and prefix sums, and the design's lanes, ends and shared zero words
    handed from one launch to the next, are traffic of their own."""
    from tropical_torch.extract import device as dv

    if name == "pack_words":
        return _nb(a[0]) + 24 * a[0].shape[0]
    if name == "edge_words":
        return _nb(a[0]) + 12 * a[0].shape[0] + min(
            _nb(a[1]) + _nb(a[2]), 32 * a[0].shape[0])
    if name in ("split_mark", "split_cumsum"):
        return _nb(a[0]) if name == "split_mark" else 0
    if name in ("split_lerp", "split_select"):
        S = a[6]
        return S * (8 + 24 + 8 + 16 + 12) + (
            _nb(a[1]) if name == "split_select" else 0)
    if name == "split_override":
        return _nb(a[0])
    if name in ("split_append", "split_finish"):
        OUTn, bz = a[0], a[1]
        idx, eps, final = a[-3:]
        S = OUTn.shape[0]
        fired = 0
        if int(dv.split_override_plain(OUTn, bz, idx, eps)[0]):
            fired = int(dv._override_mask(bz, idx).sum())
        return 4 * fired + S * (24 + 8 + 4) + (0 if final else S * 40) + (
            _nb(OUTn) if name == "split_finish" else 0)
    raise KeyError(name)


def stage_sum_bytes(N, M, n_used, n_edges):
    """K3's earlier bound, dist mode: the sum over the first design's
    stages of each stage's inputs and outputs (three pools, the points'
    words and keep flags, the edges' int32 flags and used flags, the
    squeeze's reads of their prefix sums), for the comparison with the
    figures recorded against it."""
    edges = 3 * (M - 1) * M * M
    return 220 * N + 8 * edges + 324 * n_used + 8 * n_edges


def design_bytes(name, a):
    """The bytes K5's design moves past ``stage_bytes``: the column table's
    (the rows and keys read, the sorted rows and the table written), and
    the pair scan's counts a candidate and column where the function needs
    a count a candidate."""
    if name == "connect_table":
        W = a[3] + 1
        return 2 * _nb(a[0]) + _nb(a[1]) + _nb(a[2]) + 8 * W * W
    if name in ("connect_count", "connect_fill"):
        return 32 * a[0].shape[0]
    return 0


def _outputs(result, args):
    """A stage call's results, then its tensor arguments (the in-place
    ones changed)."""
    res = result if isinstance(result, tuple) else (result,)
    return [t for t in (*res, *args) if torch.is_tensor(t)]


def _max_err(a, b):
    if a.dtype.is_floating_point:
        d = (a.double() - b.double()).abs()
        return float(d[~d.isnan()].max()) if d.numel() else 0.0
    return float((a != b).any())


def stage_check(log, name, args, kw, reps, first):
    """One recorded stage call, by the kernel and by its plain version on
    the card, and a redesigned stage also by its first design (``first``:
    the first designs' ``Kernels``): held bitwise (every result and every
    argument after the call; K5's first design builds no column table);
    the kernel's device time (``graph_ms``), the first design's, the plain
    version's (CUDA events), the call's bound, and for ``compact_rows``
    the time of ``index_select`` on the same rows (the library call).
    Returns {err, ms, first_ms, plain_ms, bound_ms, design_ms,
    library_ms}, ``design_ms`` the design's own traffic
    (``design_bytes``) at the card's memory rate."""
    dv = log.dv
    fn = log.orig[name]
    redesigned = name in REDESIGNED_STAGES
    kerns = [None, dv.PLAIN]
    if redesigned and name != "connect_table":
        kerns.append(first)
    runs = []
    for kern in kerns:
        a = clones(args)
        runs.append(_outputs(fn(*a, **{**kw, "kern": kern}), a))
    err = 0.0
    for other in runs[1:]:
        for x, y in zip(runs[0], other):
            same = x.shape == y.shape and bits_equal(x, y)
            check(same, f"{name}: kernel != plain or first design "
                  f"({tuple(x.shape)})")
            err = max(err, _max_err(x, y))
    fixed, ffixed, pfixed = clones(args), clones(args), clones(args)
    out = {"err": err, "bound_ms": stage_bytes(name, args) / PEAK_BYTES * 1e3,
           "design_ms": design_bytes(name, args) / PEAK_BYTES * 1e3,
           "ms": graph_ms(lambda: fn(*fixed, **{**kw, "kern": None}),
                          reps=reps),
           "plain_ms": cuda_ms(lambda: fn(*pfixed, **{**kw,
                                                      "kern": dv.PLAIN}),
                               iters=2),
           "first_ms": None, "library_ms": None}
    if redesigned:
        out["first_ms"] = 0.0 if name == "connect_table" else graph_ms(
            lambda: fn(*ffixed, **{**kw, "kern": first}), reps=reps)
    if name == "compact_rows":
        src, cum = args[0], args[1]
        rows = torch.nonzero(torch.diff(cum, prepend=cum.new_zeros(1)) > 0
                             )[:, 0]
        check(bits_equal(src.index_select(0, rows), runs[0][0]),
              "compact_rows != index_select")
        out["library_ms"] = graph_ms(lambda: src.index_select(0, rows),
                                     reps=reps)
    return out


def lattice_times(net, reps, first_lib):
    """K2 at the net's skeleton lattice (M^3 points, the three derivatives):
    the one launch for every level, and its first design (a launch a
    level), each bitwise ``lattice_level_plain`` level by level; their
    device times, the plain version's, the bound (bytes at 3.35 TB/s
    against ``LATTICE_OPS`` at PEAK_F32_UNFUSED_OPS)."""
    from tropical_torch.core import hashgrid as thg

    spec = net.spec.grid
    M = net.marks.shape[0]
    xs = net.preprocess(net.marks * (net.spec.scale * 2) - net.spec.scale)
    tables = thg.lattice_tables(spec, net.enc.table.detach(), M ** 3)
    n, LF = M ** 3, spec.levels * 2
    feat = torch.empty((n, LF), device="cuda")
    grad = torch.empty((3, n, LF), device="cuda")

    def run(lib=None):
        thg.lattice_encode(spec, tables, xs, xs, xs, feat, grad, lib=lib)

    def plain():
        return [thg.lattice_level_plain(spec, tables[l], l, xs, xs, xs, True)
                for l in range(spec.levels)]

    want = plain()
    err = 0.0
    for lib in (None, first_lib):
        feat.fill_(float("nan"))
        grad.fill_(float("nan"))
        run(lib)
        for l, (f, g) in enumerate(want):
            cols = slice(2 * l, 2 * l + 2)
            for x, y in ((feat[:, cols], f), (grad[:, :, cols], g)):
                check(bits_equal(x.contiguous(), y), f"lattice_encode level "
                      f"{l} ({'first design' if lib else 'design'}): kernel "
                      "!= plain")
                err = max(err, _max_err(x, y))
    ms = graph_ms(run, reps=reps)
    first_ms = graph_ms(lambda: run(first_lib), reps=reps)
    plain_ms = cuda_ms(plain, iters=2)
    nbytes = 4 * n * LF * 4 + sum(_nb(t) for t in tables) + 12 * M
    t_bytes = nbytes / PEAK_BYTES
    t_ops = n * spec.levels * LATTICE_OPS[1] / PEAK_F32_UNFUSED_OPS
    return {"err": err, "ms": ms, "first_ms": first_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def skeleton_split(net, kern=None, runs=3):
    """The dist skeleton's device time split by CUDA events (the last of
    ``runs`` warm runs, ms; ``kern`` the first designs' kernels, or None for
    the design): the corner tables, K2 (``lattice_features`` with the
    derivatives), the MLP and its three tangents (``_mlp_tangents``), the
    sdf and |grad| in torch, then K3 with its prefix sums, the skeleton's
    host read and the compaction."""
    from tropical_torch.extract import device as dv

    names = ("lattice_features", "_mlp_tangents", "skeleton_pool",
             "skeleton_words", "skeleton_points")
    orig = {k: getattr(dv, k) for k in names}
    marks = {}

    def mark(key):
        if key not in marks:
            marks[key] = torch.cuda.Event(enable_timing=True)
            marks[key].record()

    def wrap(name, fn):
        def call(*a, **kw):
            mark(f"{name}<")
            r = fn(*a, **kw)
            mark(f"{name}>")
            return r
        return call

    eng = dv.Engine(net, kern=kern)
    try:
        for k, fn in orig.items():
            setattr(dv, k, wrap(k, fn))
        for _ in range(runs):
            marks.clear()
            mark("start")
            eng.skeleton("dist")
            mark("end")
            torch.cuda.synchronize()
    finally:
        for k, fn in orig.items():
            setattr(dv, k, fn)
    k3 = next(f"{k}<" for k in names[2:] if f"{k}<" in marks)
    bounds = [("corner tables", "start", "lattice_features<"),
              ("K2 lattice_encode", "lattice_features<", "lattice_features>"),
              ("_mlp_tangents", "_mlp_tangents<", "_mlp_tangents>"),
              ("sdf and |grad|", "_mlp_tangents>", k3),
              ("K3, prefix sums, read, squeeze", k3, "end"),
              ("skeleton", "start", "end")]
    return {label: marks[a].elapsed_time(marks[b]) for label, a, b in bounds}


def k3_whole(net, first):
    """K3's whole skeleton, dist and sign, by the design, by the first
    design and by the plain versions on the card, held bitwise (every
    result).  Returns {mode: (vertices, edges)}."""
    from tropical_torch.extract import device as dv

    sizes = {}
    for mode in ("dist", "sign"):
        want = dv.Engine(net, kern=dv.PLAIN).skeleton(mode)
        for label, kern in (("design", None), ("first design", first)):
            got = dv.Engine(net, kern=kern).skeleton(mode)
            check(len(got) == len(want) and all(
                bits_equal(x, y) for x, y in zip(got, want)),
                f"K3 {mode} skeleton: {label} != plain")
        sizes[mode] = (want[0].shape[0], want[5].shape[0])
    return sizes


def k3_stage_times(net, reps, kern, label="first design"):
    """K3 in the build of ``kern`` at a net's shapes: the stage calls of its
    dist skeleton (the first design's ``K3_FIRST_STAGES``, where the two
    torch.cumsum calls are a stage), recorded from a run of that build's
    engine and replayed as recorded, each in a CUDA graph.  Returns ({stage:
    ms}, the launches the run recorded)."""
    from tropical_torch.extract import device as dv
    from tropical_torch.ops import launches

    with StageLog() as log:
        before = launches.LAUNCHES["skeleton_mark"]
        log.on, log.plane = True, "skeleton"
        dv.Engine(net, kern=kern).skeleton("dist")
        log.on = False
        count = launches.LAUNCHES["skeleton_mark"] - before
    times = {}
    for name, args, kw, _ in log.calls:
        fixed = clones(args)
        ms = graph_ms(lambda: log.orig[name](*fixed, **kw), reps=reps)
        times[name] = times.get(name, 0.0) + ms
        print(f"  {label}: {name}: {ms:.5f} ms")
    return times, count


def graph_bits(fn, args, kw):
    """The outputs of one call of ``fn`` (its results, then its tensor
    arguments) after a warm-up call and three replays of a CUDA graph of
    one call, on clones of ``args``."""
    a = clones(args)
    fn(*a, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = fn(*a, **kw)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    return _outputs(res, a)


def planted(name, args):
    """A split_finish, split_override or split_append call's arguments with
    the sign override planted: the last row's output at plane idx set to 1
    (split_append's ``viol`` set)."""
    a = clones(args)
    a[0][-1, a[-3] if name != "split_override" else a[2]] = 1.0
    if name == "split_append":
        a[2].fill_(1)
    return a


def k4_stage_times(net, reps, kern, planes, label):
    """K4 in the build of ``kern`` (None: the committed design) at a net's
    shapes: the stage calls of the insertions at ``planes``, recorded from a
    run of that build's engine (the first design's torch.cumsum a stage of
    its own), each held bitwise to its plain version, as recorded and, for
    the override's stages, with the override planted (``planted``), then
    replayed as recorded in a CUDA graph (``graph_ms``; a split_finish
    call whose override fires with OUTn copied back before each replay,
    the copy's time taken off); the design's
    calls also held after three replays of a graph of one call
    (``graph_bits``: its counters and flags return to zero in every
    launch).  Returns {ms, plain_ms, bound_ms (``k4_bytes``), err, stages
    {stage@plane: ms}, launches (the run's K4 launches), planted (the
    planted calls held)}."""
    from tropical_torch.extract import device as dv
    from tropical_torch.ops import launches

    with StageLog() as log:
        class Logged(dv.Engine):
            def step(self, P, idx, *a, **k):
                log.on, log.plane = idx in planes, idx
                try:
                    return super().step(P, idx, *a, **k)
                finally:
                    log.on = False

        before = launches.LAUNCHES["split_step"]
        eng = Logged(net, kern=kern)
        sk = eng.skeleton("dist")
        eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
        torch.cuda.synchronize()
        count = launches.LAUNCHES["split_step"] - before
    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "err": 0.0,
           "stages": {}, "launches": count, "planted": 0}
    for name, args, kw, plane in log.calls:
        if DEVICE_STAGES[name] != "split_step":
            continue
        fn = log.orig[name]
        key = f"{name}@{plane}"
        fixed = clones(args)
        ms = graph_ms(lambda: fn(*fixed, **kw), reps=reps)
        if name == "split_finish" and int(dv.split_override_plain(
                *args[:2], *args[-3:-1])[0]):
            # the override fired: the first call zeroed OUTn's columns in
            # place, so each replay copies the recorded OUTn back first,
            # and the copy's own time is taken off
            pristine = args[0]
            copy_ms = graph_ms(lambda: fixed[0].copy_(pristine), reps=reps)
            ms = graph_ms(lambda: (fixed[0].copy_(pristine),
                                   fn(*fixed, **kw)), reps=reps) - copy_ms
            print(f"  {label}: plane {plane}: {name}: the override fires; "
                  f"OUTn's copy {copy_ms:.5f} ms taken off")
        out["stages"][key] = out["stages"].get(key, 0.0) + ms
        out["ms"] += ms
        out["bound_ms"] += k4_bytes(name, args) / PEAK_BYTES * 1e3
        if name == "split_cumsum":  # torch's, no plain version of its own
            print(f"  {label}: plane {plane}: {name}: {ms:.5f} ms")
            continue
        plain = {**kw, "kern": dv.PLAIN}
        cases = [args] + ([planted(name, args)] if name in (
            "split_finish", "split_override", "split_append") else [])
        for case in cases:
            a = clones(case)
            got = _outputs(fn(*a, **kw), a)
            b = clones(case)
            want = _outputs(fn(*b, **plain), b)
            runs = [got]
            if kern is None and name in ("split_select", "split_finish"):
                runs.append(graph_bits(fn, case, kw))
            for run in runs:
                for x, y in zip(want, run):
                    check(x.shape == y.shape and bits_equal(x, y),
                          f"{label} {name} at plane {plane}: kernel != "
                          f"plain ({tuple(x.shape)})")
                    out["err"] = max(out["err"], _max_err(x, y))
            out["planted"] += case is not args
        pfixed = clones(args)
        plain_ms = cuda_ms(lambda: fn(*pfixed, **plain), iters=2)
        out["plain_ms"] += plain_ms
        print(f"  {label}: plane {plane}: {name}: kernel {ms:.5f} ms, plain "
              f"{plain_ms:.3f} ms, bound "
              f"{k4_bytes(name, args) / PEAK_BYTES * 1e3:.5f} ms")
    return out


def override_fires(net):
    """The sign override at each busy insertion of a run of the engine:
    [(plane, splits, 1 if it fired)], each split_finish call's OUTn tested
    by the plain override before the call."""
    from tropical_torch.extract import device as dv

    fired, finish = [], dv.split_finish

    def tested(OUTn, bz, *a, **kw):
        idx, eps = a[-3], a[-2]
        fired.append((idx, OUTn.shape[0],
                      int(dv.split_override_plain(OUTn, bz, idx, eps)[0])))
        return finish(OUTn, bz, *a, **kw)

    dv.split_finish = tested
    try:
        eng = dv.Engine(net)
        sk = eng.skeleton("dist")
        eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
    finally:
        dv.split_finish = finish
    return fired


def pool_library(log, pool_calls, reps):
    """The three-axis max-pool of |grad sdf| by the pool kernel (the
    design's two launches, and a third along axis 2, which K3 leaves to
    ``skeleton_words``) against ``max_pool3d`` (kernel 2k + 1, stride 1,
    padding k) on the same values: NaN where the kernels give NaN, the same
    bits elsewhere.  Returns (max_pool3d's device time, the three
    launches'), ``graph_ms``."""
    import torch.nn.functional as F

    g, M, k, _ = pool_calls[0][1][:4]
    kw = {**pool_calls[0][2], "kern": None}
    pool = log.orig["skeleton_pool"]

    def kernels():
        out = g
        for axis in range(3):
            out = pool(out, M, k, axis, **kw)
        return out

    def library():
        return F.max_pool3d(g.view(1, 1, M, M, M), 2 * k + 1, stride=1,
                            padding=k).view(-1)

    got, want = kernels(), library()
    nan = got.isnan()
    check(torch.equal(nan, want.isnan()) and bits_equal(got[~nan], want[~nan]),
          "skeleton_pool != max_pool3d")
    return graph_ms(library, reps=reps), graph_ms(kernels, reps=reps)


def engine_stage_times(net, reps, first):
    """K3-K5 at a net's shapes: the skeleton's stage calls, and those of
    the final insertion and of the busiest hidden one (the most split
    edges), recorded from a run of the engine, each held bitwise to its
    plain version (and a redesigned one to its first design) and timed;
    K3's first design from its own run (``k3_stage_times``), its whole
    skeleton held by ``k3_whole``.  Returns {kernel: {err, ms, first_ms,
    plain_ms, bound_ms, ...}} summed over the kernel's calls (a kernel's
    first-design time: its redesigned calls' first designs and its other
    calls' own times; K3's: its first design's stages), the run's busy
    list and the recorded planes."""
    from tropical_torch.extract import device as dv

    busy = dv.Engine(net)
    sk = busy.skeleton("dist")
    busy.loop(*busy.pools(sk[0], sk[1], sk[5], sk[2:5]))
    hidden = [b for b in busy.stats.busy if b[0] < busy.n_hidden]
    planes = {busy.n_hidden, max(hidden, key=lambda b: b[1])[0]}
    with StageLog() as log:
        class Logged(dv.Engine):
            def step(self, P, idx, *a, **k):
                log.on = idx in planes
                log.plane = idx
                try:
                    return super().step(P, idx, *a, **k)
                finally:
                    log.on = False

        eng = Logged(net)
        log.on, log.plane = True, "skeleton"
        sk = eng.skeleton("dist")
        log.on = False
        eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
        out = {k: {"err": 0.0, "ms": 0.0, "first_ms": 0.0, "plain_ms": 0.0,
                   "bound_ms": 0.0, "design_ms": 0.0}
               for k in DEVICE_ENGINE[1:]}
        redesigned = {}
        pool_ms = 0.0
        for name, args, kw, plane in log.calls:
            if DEVICE_STAGES[name] == "split_step":
                continue  # k4_stage_times, both designs from their own runs
            r = stage_check(log, name, args, kw, reps, first)
            rec = out[DEVICE_STAGES[name]]
            rec["err"] = max(rec["err"], r["err"])
            for key in ("ms", "plain_ms", "bound_ms", "design_ms"):
                rec[key] += r[key]
            rec["first_ms"] += r["ms"] if r["first_ms"] is None \
                else r["first_ms"]
            if r["library_ms"] is not None:
                rec["compact_rows_library_ms"] = rec.get(
                    "compact_rows_library_ms", 0.0) + r["library_ms"]
            if name in REDESIGNED_STAGES:
                agg = redesigned.setdefault(name, [0.0, 0.0])
                agg[0] += r["ms"]
                agg[1] += r["first_ms"]
            if name == "skeleton_pool":
                pool_ms += r["ms"]
            first_txt = "" if r["first_ms"] is None else (
                f", first design {r['first_ms']:.5f} ms")
            lib_txt = "" if r["library_ms"] is None else (
                f", index_select {r['library_ms']:.5f} ms")
            design_txt = "" if not r["design_ms"] else (
                f" (the design's own traffic {r['design_ms']:.5f} ms more)")
            bound_txt = "" if name in K3_STAGES else (
                f", bound {r['bound_ms']:.5f} ms{design_txt}")
            print(f"  plane {plane}: {name}: kernel {r['ms']:.5f} ms"
                  f"{first_txt}{lib_txt}, plain {r['plain_ms']:.3f} ms"
                  f"{bound_txt}")
        for name, (ms, fms) in redesigned.items():
            print(f"  {name}, summed: kernel {ms:.5f} ms, first design "
                  f"{fms:.5f} ms")
        rows = out["connect_step"]
        rows["compact_rows_ms"] = redesigned.get("compact_rows", [0, 0])[0]
        rows["compact_rows_first_ms"] = redesigned.get("compact_rows",
                                                       [0, 0])[1]
        k3_calls = [c for c in log.calls if c[3] == "skeleton"]
        pools = [c for c in k3_calls if c[0] == "skeleton_pool"]
        library_ms, pool3_ms = pool_library(log, pools, reps)
    k4 = k4_stage_times(net, reps, None, planes, "design")
    k4_first = k4_stage_times(net, reps, first, planes, "first design")
    check(math.isclose(k4["bound_ms"], k4_first["bound_ms"]),
          f"K4's bound: design {k4['bound_ms']} ms, first design "
          f"{k4_first['bound_ms']} ms")
    out["split_step"].update(
        err=max(k4["err"], k4_first["err"]), ms=k4["ms"],
        plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
        first_ms=k4_first["ms"], stage_ms=k4["stages"],
        first_stage_ms=k4_first["stages"], run_launches=k4["launches"],
        first_launches=k4_first["launches"],
        planted=k4["planted"] + k4_first["planted"])
    first_times, first_launches = k3_stage_times(net, reps, first)
    compact = next(c[1] for c in k3_calls if c[0] == "skeleton_compact")
    M, n_edges, n_used = compact[5], compact[8], compact[9]
    N = M ** 3
    k3 = out["skeleton_mark"]
    k3.update(first_ms=sum(first_times.values()),
              bound_ms=k3_bytes(N, M, n_used, n_edges) / PEAK_BYTES * 1e3,
              stage_sum_bound_ms=stage_sum_bytes(N, M, n_used, n_edges)
              / PEAK_BYTES * 1e3,
              pool_ms=pool_ms, pool3_ms=pool3_ms,
              pool_first_ms=first_times["skeleton_pool"],
              pool_library_ms=library_ms, first_launches=first_launches,
              first_stage_ms=first_times, skeleton=(n_used, n_edges))
    return out, busy.stats.busy, sorted(planes)


def k4c_bytes(name, a, cw):
    """The bytes a K4c call must move, each input read once and each output
    written once (``cw``: the count words after the call), counting only
    the rows that need them: the selection's (``split_select``'s curved
    instance, ``a`` its arguments) as ``k4_bytes`` of the flat selection
    and the curved rows' slots, planes, ends and corners written; the
    curved rows' outputs alone, what the curved instance adds to the flat
    one (``curved_rows``); the first design's ``curved_select``, a pass of
    its own: of the S split rows their ends and both ends' V rows, and of
    the curved rows their shared zero words read (the plane and the
    no-plane count) and their outputs written; ``curved_roots``: a row's
    plane, the 16 corner outputs at the plane and at idx and its ends
    read, its root and point written (``CURVED_ROOTS_ROW_BYTES``);
    ``curved_gd`` with its mix (``CURVED_GD_ROW_BYTES`` a row, and
    ``CURVED_GD_RESCUED_BYTES`` more a rescued row); ``curved_mix`` after a
    rescue (``CURVED_MIX_ROW_BYTES`` a row); of the S rows their zero
    words, state and output at idx read, and of the survivors their rows
    of OUTn, V, lanes and ends read and written (``curved_filter``)."""
    from tropical_torch.extract import device as dv

    if name == "split_select":
        return k4_bytes(name, a) + int(cw[dv.CW_CURVED]) * CURVED_ROW_BYTES
    if name == "curved_rows":
        return int(cw[dv.CW_CURVED]) * CURVED_ROW_BYTES
    if name == "curved_select":
        return a[6] * 32 + int(cw[dv.CW_CURVED]) * (8 + CURVED_ROW_BYTES)
    if name == "curved_roots":
        return a[0].shape[0] * CURVED_ROOTS_ROW_BYTES
    if name == "curved_gd":
        return (a[0].shape[0] * CURVED_GD_ROW_BYTES
                + int(cw[dv.CW_GD]) * CURVED_GD_RESCUED_BYTES)
    if name == "curved_mix":
        return a[0].shape[0] * CURVED_MIX_ROW_BYTES
    if name == "curved_filter":
        return a[0].shape[0] * 16 + int(cw[dv.CW_KEPT]) * 316
    raise KeyError(name)


def k4c_bound_ms(name, a, cw) -> tuple[float, float]:
    """A K4c call's least time: (its bytes at the card's memory rate,
    ``k4c_bytes``; its operations at the unfused f32 rate, K7's on the rows
    of a ``curved_roots`` call, ``trilinear_roots_ops``, else 0)."""
    bytes_ms = k4c_bytes(name, a, cw) / PEAK_BYTES * 1e3
    if name != "curved_roots":
        return bytes_ms, 0.0
    ops = trilinear_roots_ops(*k7_rows(a[0], a[1], a[3]))
    return bytes_ms, ops / PEAK_F32_UNFUSED_OPS * 1e3


def k4c_held(fn, args, label, kw=None, kern=None):
    """One call of a curved-route stage by the kernel (``kern``: None, the
    design; else a build's ``Kernels``) and by the plain version, on clones
    of ``args``: every result (the kernel's rows of the split or curved
    rows' length, the plain version's first) and every tensor argument
    after the call (the count words, the mix's vertices and states, the
    pools the finish rewrites) bitwise; the design also after three replays
    of a CUDA graph of one call, its results (its rank state back at zero
    each launch).  Returns (max error, the count words after the plain
    call)."""
    from tropical_torch.extract import device as dv

    kw = kw or {}

    def run(k):
        a = clones(args)
        res = fn(*a, **{**kw, "kern": k})
        res = res if isinstance(res, tuple) else (res,)
        return [r for r in res if torch.is_tensor(r)], [
            t for t in a if torch.is_tensor(t)]

    (want, wargs), (got, gargs) = run(dv.PLAIN), run(kern)
    err = 0.0
    for x, y in zip(want + wargs, got + gargs):
        y = y[:x.shape[0]]
        check(x.shape == y.shape and bits_equal(x, y),
              f"{label}: kernel != plain ({tuple(x.shape)})")
        err = max(err, _max_err(x, y))
    if kern is None:
        graph = graph_bits(fn, args, {**kw, "kern": None})
        for x, y in zip(want, graph):
            check(bits_equal(x, y[:x.shape[0]]),
                  f"{label}: kernel after graph replays != plain")
    cw = next((t for t in wargs if t.dtype == torch.int32
               and t.numel() == dv.CW), None)
    return err, cw


def split_launches(fn):
    """The K4 launches (``split_step``) one call of ``fn`` makes."""
    from tropical_torch.ops import launches

    before = launches.LAUNCHES["split_step"]
    fn()
    return launches.LAUNCHES["split_step"] - before


def k4c_planted(calls):
    """Planted calls from the recorded ones: the rescue's rows
    (``curved_gd`` with 64 in-range rows moved off the surface at idx, and
    ``curved_mix`` after it with their made-up roots in [0, 1] and
    residuals on both sides of the band, the count words its mix and the
    filter set cleared, as ``Engine._curved`` clears them), strict drops
    with the override firing (``curved_filter`` with a third of the rows
    curved and off the band at their plane, a residual off the band, and a
    violation at a shared plane below idx: column 0 of the first row), and
    K4's finish alone on that filter's survivors (the recorded finish of
    its plane, which the planted survivors index as the recorded ones do).
    Returns [(name, args, kw)]."""
    from tropical_torch.extract import device as dv

    out = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    eps = 1e-4
    for name, args, _, plane in calls:
        if name == "curved_gd":
            a = clones(args)
            outs, ints, idx = a[0], a[2], a[5]
            ok = torch.nonzero(~dv._out_of_range(ints))[:64, 0]
            outs[ok, idx] = 1.0
            out.append((name, a, {}))
            g = clones(a)
            dnew, grank = dv.curved_gd(*g, kern=dv.PLAIN)[:2]
            cw = g[9]
            n_gd = int(cw[dv.CW_GD])
            check(n_gd > 0, "the planted curved_gd call rescues no row")
            gx = torch.rand((n_gd, 3), generator=gen, device="cuda")
            gx[:1] = 0.0
            gx[1:2] = 1.0
            gd0 = (torch.rand(n_gd, generator=gen, device="cuda") - 0.5) * (
                4 * eps)
            cw[dv.CW_ANYD0:] = 0
            out.append(("curved_mix", [g[4], g[3], g[2], dnew, grank, gx, gd0,
                                       g[6], g[7], g[8], cw], {}))
        if name == "curved_filter":
            a = clones(args)
            OUTn, bz, cstate, idx, cw = a[0], a[1], a[5], a[6], a[8]
            S = OUTn.shape[0]
            rows = torch.arange(0, S, 3, device="cuda")
            cstate[rows] = dv.CV_CURVED | dv.CV_OFF
            cw[dv.CW_ANYD0] = 1
            out.append((name, a, {}))
            f = clones(a)
            f[1][0, 0] |= 1
            f[0][0, 0] = 1.0
            out.append((name, f, {}))
            kept = dv.curved_filter(*clones(f), kern=dv.PLAIN)
            check(bool((kept[1][:, idx] == 0).all()),
                  "the planted override did not fire")
            fin = next(c for c in calls if c[0] == "split_finish"
                       and c[3] == plane)
            m = clones(fin[1])
            m[:4] = [t.clone() for t in kept[1:]]
            out.append(("split_finish", m, {"survivors": True}))
    return out


def k4c_times(net, reps, first):
    """K4c at a net's curved run, in the design and in its first design
    (``first``: the CURVED_FIRST build's ``Kernels``): the curved route's
    calls at the busiest curved insertion (the most curved rows) and at
    the final one, recorded from a run of the design's engine, each held
    bitwise to its plain version (``k4c_held``) in both builds and timed (a
    CUDA graph of the call, ``graph_ms``; the plain version by CUDA
    events), with its bound (``k4c_bound_ms``): the selection as the curved
    instance of ``split_select`` whole and less its flat instance on the
    same call (the first design, through the same calls: the flat
    selection and ``curved_select``, two launches, whole and less its
    flat selection), ``curved_roots`` (the first design: ``curved_pick``,
    K7 and ``curved_points``) and ``curved_gd`` with its mix (the first
    design: ``curved_gd``, then ``curved_mix``), also as a pair at the
    final insertion, ``curved_filter`` beside ``index_select`` of the
    survivors' rows, K4's finish on the survivors alone (the first design:
    with its override test); the planted calls (``k4c_planted``: the
    rescue's ``curved_mix`` among them) held bitwise in both builds.
    Returns ({kernel: {err, ms, first_ms, plain_ms, bound_ms, calls,
    ...}}, the run's curved list, the recorded planes, the planted calls
    held)."""
    from tropical_torch.extract import device as dv

    run = dv.Engine(net, force=False)
    sk = run.skeleton("dist")
    run.loop(*run.pools(sk[0], sk[1], sk[5], sk[2:5]))
    curved = [c for c in run.stats.curved if c[2] > 0]
    planes = {run.n_hidden, max(curved, key=lambda c: c[2])[0]}
    with StageLog() as log:
        class Logged(dv.Engine):
            def step(self, P, idx, *a, **k):
                log.on, log.plane = idx in planes, idx
                try:
                    return super().step(P, idx, *a, **k)
                finally:
                    log.on = False

        eng = Logged(net, force=False)
        sk = eng.skeleton("dist")
        eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
        torch.cuda.synchronize()
    calls = [c for c in log.calls if c[0] in K4C_ROUTE]
    out = {k: {"err": 0.0, "ms": 0.0, "first_ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0, "calls": 0}
           for k in CURVED_KERNELS}
    sel = out["curved_select"]
    sel.update(split_select_flat_ms=0.0, increment_ms=0.0,
               increment_bound_ms=0.0, first_split_select_flat_ms=0.0,
               first_increment_ms=0.0, first_alone_bound_ms=0.0)
    out["curved_filter"]["survivor_rows_library_ms"] = 0.0
    finish = {"ms": 0.0, "first_ms": 0.0, "calls": 0}
    # curved_roots and curved_gd at the final insertion: (ms, first_ms)
    pair = {}
    for name, args, kw, plane in calls:
        fn = log.orig[name]
        fixed, ffixed, pfixed = clones(args), clones(args), clones(args)
        if name == "split_select":
            check(len(args) == 9, "split_select: not the curved instance")
            err, cw = k4c_held(fn, args, f"split_select at plane {plane}")
            ferr, _ = k4c_held(fn, args, f"first design's split_select at "
                               f"plane {plane}", kern=first)
            n_launch = [split_launches(lambda: fn(*clones(args), kern=k))
                        for k in (None, first)]
            check(n_launch == [1, 2], f"split_select's launches (design, "
                  f"first design) {n_launch}, not [1, 2]")
            flat, fflat = clones(args[:7]), clones(args[:7])
            ms = graph_ms(lambda: fn(*fixed, kern=None), reps=reps)
            flat_ms = graph_ms(lambda: fn(*flat, kern=None), reps=reps)
            first_ms = graph_ms(lambda: fn(*ffixed, kern=first), reps=reps)
            first_flat_ms = graph_ms(lambda: fn(*fflat, kern=first),
                                     reps=reps)
            plain_ms = cuda_ms(lambda: fn(*pfixed, kern=dv.PLAIN), iters=2)
            bound, inc_bound, alone_bound = (
                k4c_bytes(b, args, cw) / PEAK_BYTES * 1e3
                for b in ("split_select", "curved_rows", "curved_select"))
            sel["err"] = max(sel["err"], err, ferr)
            for key, v in (("ms", ms), ("first_ms", first_ms),
                           ("plain_ms", plain_ms), ("bound_ms", bound),
                           ("split_select_flat_ms", flat_ms),
                           ("increment_ms", ms - flat_ms),
                           ("increment_bound_ms", inc_bound),
                           ("first_split_select_flat_ms", first_flat_ms),
                           ("first_increment_ms", first_ms - first_flat_ms),
                           ("first_alone_bound_ms", alone_bound)):
                sel[key] += v
            sel["calls"] += 1
            print(f"  plane {plane}: split_select, {args[0].shape[0]} edges, "
                  f"{args[6]} split, {int(cw[dv.CW_CURVED])} curved: the "
                  f"curved instance {ms:.5f} ms (bound {bound:.5f} ms), the "
                  f"flat {flat_ms:.5f} ms (the curved rows {ms - flat_ms:.5f} "
                  f"ms, bound {inc_bound:.7f} ms); the first design's flat "
                  f"selection and curved_select {first_ms:.5f} ms, its flat "
                  f"{first_flat_ms:.5f} ms (curved_select "
                  f"{first_ms - first_flat_ms:.5f} ms, bound alone "
                  f"{alone_bound:.5f} ms); plain {plain_ms:.3f} ms")
            continue
        if name == "split_finish":
            check(kw.get("survivors") is True,
                  "split_finish: not on the filter's survivors")
            k4c_held(fn, args, f"split_finish at plane {plane}", kw)
            k4c_held(fn, args, f"first design's split_finish at plane "
                     f"{plane}", kw, kern=first)
            ms = graph_ms(lambda: fn(*fixed, **{**kw, "kern": None}),
                          reps=reps)
            first_ms = graph_ms(lambda: fn(*ffixed, **{**kw, "kern": first}),
                                reps=reps)
            finish["ms"] += ms
            finish["first_ms"] += first_ms
            finish["calls"] += 1
            print(f"  plane {plane}: split_finish on {args[0].shape[0]} "
                  f"survivors: alone {ms:.5f} ms, with the first design's "
                  f"override test {first_ms:.5f} ms")
            continue
        err, cw = k4c_held(fn, args, f"{name} at plane {plane}")
        ferr, _ = k4c_held(fn, args, f"first design's {name} at plane "
                           f"{plane}", kern=first)
        err = max(err, ferr)
        ms = graph_ms(lambda: fn(*fixed, kern=None), reps=reps)
        first_ms = graph_ms(lambda: fn(*ffixed, kern=first), reps=reps)
        if name in ("curved_roots", "curved_gd") and plane == max(planes):
            pair[name] = (ms, first_ms)
        if name == "curved_filter":
            # the survivors' rows by one library call (lanes are strictly
            # increasing: a survivor's lane finds its row)
            res = fn(*clones(args), kern=dv.PLAIN)
            k = torch.searchsorted(args[2], res[3])
            OUTn = args[0]
            fired = not bits_equal(res[1], OUTn.index_select(0, k))
            lib_ms = graph_ms(lambda: OUTn.index_select(0, k), reps=reps)
            out[name]["survivor_rows_library_ms"] += lib_ms
            print(f"  plane {plane}: curved_filter: index_select of the "
                  f"{k.numel()} survivors' rows {lib_ms:.5f} ms (the "
                  f"override {'fired' if fired else 'did not fire'})")
        plain_ms = cuda_ms(lambda: fn(*pfixed, kern=dv.PLAIN), iters=2)
        bytes_ms, ops_ms = k4c_bound_ms(name, args, cw)
        bound = max(bytes_ms, ops_ms)
        rec = out[K4C_STAGES[name]]
        rec["err"] = max(rec["err"], err)
        for key, v in (("ms", ms), ("first_ms", first_ms),
                       ("plain_ms", plain_ms), ("bound_ms", bound),
                       ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
            rec[key] += v
        rec["calls"] += 1
        print(f"  plane {plane}: {name} ({args[0].shape[0]} rows): kernel "
              f"{ms:.5f} ms, first design {first_ms:.5f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.7f} ms (bytes "
              f"{bytes_ms:.7f} ms, operations {ops_ms:.7f} ms)")
    check(set(pair) == {"curved_roots", "curved_gd"},
          f"the final insertion recorded {sorted(pair)}, not curved_roots "
          "and curved_gd")
    out["curved_roots"].update(
        final_pair_ms=pair["curved_roots"][0] + pair["curved_gd"][0],
        final_pair_first_ms=pair["curved_roots"][1] + pair["curved_gd"][1])
    planted = k4c_planted(calls)
    check(any(name == "curved_mix" for name, *_ in planted),
          "no planted curved_mix call")
    for name, args, kw in planted:
        k4c_held(log.orig[name], args, f"{name}, planted", kw)
        k4c_held(log.orig[name], args, f"first design's {name}, planted",
                 kw, kern=first)
        if name == "curved_mix":
            fixed, ffixed = clones(args), clones(args)
            rec = out["curved_resolve"]
            for key, v in (
                    ("planted_mix_ms", graph_ms(lambda: log.orig[name](
                        *fixed, kern=None), reps=reps)),
                    ("planted_mix_first_ms", graph_ms(lambda: log.orig[name](
                        *ffixed, kern=first), reps=reps)),
                    ("planted_mix_bound_ms", k4c_bytes(
                        name, args, None) / PEAK_BYTES * 1e3)):
                rec[key] = rec.get(key, 0.0) + v
    return out, finish, run.stats.curved, sorted(planes), len(planted)


def share(bound_ms, ms):
    """A time's share of its bound, as text (none for a time <= 0: the
    selection's is a difference of two times)."""
    return f"{bound_ms / ms:.1%}" if ms > 0 else "n/a"


def curved_kernels_phase(records, curved_launches):
    """K4c against its plain versions on the card at sphere-medium curved
    (the curved main path's net), bit for bit, in the design and in its
    first design (``cuda_build.CURVED_FIRST``), timed, in the kernel
    records."""
    phase("11b. the curved insertion's kernels (K4c) against their plain "
          "versions, sphere-medium curved")
    from tropical_torch.extract import device as dv
    from tropical_torch.ops import cuda_build

    first = dv.Kernels(cuda_build.load(cuda_build.CURVED_FIRST),
                       torch.device("cuda", 0))
    check(not first.first_split,
          "the CURVED_FIRST build takes K4's first design")
    net = sphere_net("medium")
    k4c, finish, curved, planes, planted = k4c_times(net, 20, first)
    floor_ms = graph_floor_ms()
    print(f"medium curved: busy insertions (plane, splits, curved rows, "
          f"rescued rows, rescue steps, survivors, reads) {curved}; recorded "
          f"planes {planes}; {planted} planted calls bitwise in both designs")
    print(f"medium curved: K4's finish on the survivors, alone "
          f"{finish['ms']:.5f} ms, with the first design's override test "
          f"{finish['first_ms']:.5f} ms ({finish['calls']} calls)")
    records["split_step"].update(curved_finish_ms=finish["ms"],
                                 curved_finish_first_ms=finish["first_ms"])
    for name in CURVED_KERNELS:
        r = k4c[name]
        check(r["calls"] > 0, f"{name}: no call recorded")
        records[name] = {
            "name": name, "route": "cuda",
            "source": "tropical_torch/csrc/device_engine.cu",
            "replaces": K4C_REPLACES[name],
            "launches": curved_launches[name], "launches_flat": 0,
            "max_abs_err": r["err"], "ms": r["ms"], "first_ms": r["first_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": ("operations" if r["ops_ms"] > r["bytes_ms"]
                         else "bytes"),
            "library_ms": None, "calls_timed": r["calls"],
            "graph_node_floor_ms": floor_ms}
        extra = {k: v for k, v in r.items() if k not in (
            "err", "ms", "first_ms", "plain_ms", "bound_ms", "calls")}
        records[name].update(extra)
        if name == "curved_roots":
            records[name].update(
                source="tropical_torch/csrc/device_engine.cu (curved_roots), "
                       "tropical_torch/csrc/trilinear_roots.cuh (K7's kernel)",
                also_replaces=["tropical/core/trilinear.py:91",
                               "tropical/extract/device.py:612"])
        if name == "curved_select":
            records[name]["runs_in"] = (
                "split_select's curved instance (a split_step launch); ms "
                "and bound_ms: that instance whole, against the flat "
                "selection's bytes and the curved rows' outputs; "
                "increment_ms: less the flat instance on the same calls, "
                "against the curved rows' outputs alone (increment_bound_ms); "
                "first_ms: the first design's flat selection and "
                "curved_select; first_increment_ms: its curved_select "
                "launch, against that pass's own bytes "
                "(first_alone_bound_ms)")
        print(f"medium curved: {name}: kernel {r['ms']:.5f} ms "
              f"({share(r['bound_ms'], r['ms'])} of its bound "
              f"{r['bound_ms']:.7f} ms, {records[name]['bound_by']}), first "
              f"design {r['first_ms']:.5f} ms "
              f"({share(r['bound_ms'], r['first_ms'])}), plain "
              f"{r['plain_ms']:.3f} ms, {r['calls']} calls, max err "
              f"{r['err']}{''.join(f', {k} {v:.7f}' for k, v in extra.items())}")
    pair = records["curved_roots"]
    print(f"medium curved, the final insertion: curved_roots + curved_gd "
          f"{pair['final_pair_ms']:.5f} ms in 2 launches, the first design's "
          f"curved_pick, K7, curved_points, curved_gd and curved_mix "
          f"{pair['final_pair_first_ms']:.5f} ms in 5; a graph node's floor "
          f"{floor_ms:.5f} ms; predicted <= 0.008 ms: "
          f"{'met' if pair['final_pair_ms'] <= 0.008 else 'missed'}")
    del net
    torch.cuda.empty_cache()


def device_kernels_phase(records, flat_launches):
    """K2-K5 against their plain versions on the card, bit for bit, at the
    sphere-small (the main path) and sphere-large lattices and insertions,
    the redesigned K2, K3 and K5 also against their first designs; their
    device times (and the first designs'), plain times and bounds in the
    kernel records; K3's pool beside max_pool3d; the skeleton split by CUDA
    events in both designs."""
    phase("11. the device engine's kernels against their plain versions, "
          "sphere-small and sphere-large")
    from tropical_torch.extract import device as dv
    from tropical_torch.ops import cuda_build

    first = dv.Kernels(cuda_build.load(cuda_build.DEVICE_ENGINE_FIRST),
                       torch.device("cuda", 0))
    lattice_first = cuda_build.load(cuda_build.LATTICE_FIRST)
    for size, reps in (("small", 50), ("large", 10)):
        net = sphere_net(size)
        k2 = lattice_times(net, reps, lattice_first)
        print(f"{size}: lattice_encode kernel {k2['ms']:.4f} ms (first "
              f"design {k2['first_ms']:.4f} ms), plain {k2['plain_ms']:.3f} "
              f"ms, bound {k2['bound_ms']:.4f} ms ({k2['bound_by']}), "
              f"M = {net.marks.shape[0]}")
        whole = k3_whole(net, first)
        print(f"{size}: K3's whole skeleton bitwise in both designs and the "
              f"plain versions, dist and sign: (vertices, edges) {whole}")
        stages, busy, planes = engine_stage_times(net, reps, first)
        print(f"{size}: busy insertions (plane, splits, hits, connecting "
              f"edges) {busy}; recorded planes {planes}")
        tag = "" if size == "small" else f"_{size}"
        k3 = stages["skeleton_mark"]
        check(k3["first_launches"] == K3_FIRST_LAUNCHES,
              f"K3's first design launched {k3['first_launches']} kernels")
        print(f"{size}: skeleton_mark: bound {k3['bound_ms']:.4f} ms (the "
              f"function's bytes: out, dq, |grad|, marks read once, "
              f"{k3['skeleton'][0]} vertices and {k3['skeleton'][1]} edges "
              f"written once)")
        print(f"{size}: skeleton_mark: the first design's stage-sum bound "
              f"(its stages' inputs and outputs summed), for comparison "
              f"only: {k3['stage_sum_bound_ms']:.4f} ms")
        print(f"{size}: skeleton_pool: K3's two launches {k3['pool_ms']:.5f} "
              f"ms; three axes: kernel {k3['pool3_ms']:.5f} ms, first "
              f"design {k3['pool_first_ms']:.5f} ms, max_pool3d "
              f"{k3['pool_library_ms']:.5f} ms")
        k4 = stages["split_step"]
        conn = sum(c > 0 for i, _, _, c in busy if i < dv.R_COLS - 1)
        for key, per in (("run_launches", 3), ("first_launches", 4)):
            check(k4[key] == per * len(busy) + 1 + conn,
                  f"K4 {key}: {k4[key]} for {len(busy)} busy insertions")
        if size == "small":
            check(k4["run_launches"] == flat_launches["split_step"]
                  and k4["first_launches"] == K4_FIRST_LAUNCHES,
                  f"K4 launched {k4['run_launches']} / "
                  f"{k4['first_launches']} kernels on the flat path")
        fires = override_fires(net)
        k4["override_fired"] = sum(f for *_, f in fires)
        print(f"{size}: the sign override fired at {k4['override_fired']} "
              f"of {len(fires)} busy insertions (plane, splits, fired): "
              f"{fires}")
        print(f"{size}: split_step: the design {k4['ms']:.5f} ms "
              f"({k4['run_launches']} launches on the run), the first design "
              f"{k4['first_ms']:.5f} ms with its torch.cumsum calls "
              f"({k4['first_launches']} launches), bound "
              f"{k4['bound_ms']:.5f} ms (k4_bytes: "
              f"{k4['bound_ms'] / k4['ms']:.1%} and "
              f"{k4['bound_ms'] / k4['first_ms']:.1%} of it); "
              f"{k4['planted']} calls with a planted override bitwise")
        split = {label: skeleton_split(net, kern) for label, kern in
                 (("design", None), ("first", first))}
        print(f"{size}: the dist skeleton's split (ms, CUDA events): "
              f"{json.dumps(split)}")
        for name in DEVICE_ENGINE:
            r = k2 if name == "lattice_encode" else stages[name]
            rec = records.setdefault(name, {
                "name": name, "route": "cuda",
                "source": DEVICE_ENGINE_SOURCE.get(
                    name, "tropical_torch/csrc/device_engine.cu"),
                "replaces": DEVICE_ENGINE_REPLACES[name],
                "launches": flat_launches[name], "library_ms": None})
            rec.update({f"max_abs_err{tag}": r["err"], f"ms{tag}": r["ms"],
                        f"first_ms{tag}": r["first_ms"],
                        f"plain_ms{tag}": r["plain_ms"],
                        f"bound_ms{tag}": r["bound_ms"],
                        f"bound_by{tag}": r.get("bound_by", "bytes")})
            if "compact_rows_library_ms" in r:
                rec[f"compact_rows_library_ms{tag}"] = r[
                    "compact_rows_library_ms"]
                rec[f"compact_rows_ms{tag}"] = r["compact_rows_ms"]
                rec[f"compact_rows_first_ms{tag}"] = r[
                    "compact_rows_first_ms"]
            if name == "skeleton_mark":
                rec.update({f"{key}{tag}": r[key] for key in (
                    "stage_sum_bound_ms", "pool_ms", "pool3_ms",
                    "pool_first_ms", "pool_library_ms", "first_launches")})
                rec[f"skeleton_split_ms{tag}"] = split
            if name == "split_step":
                rec.update({f"{key}{tag}": r[key] for key in (
                    "run_launches", "first_launches", "override_fired",
                    "planted", "stage_ms", "first_stage_ms")})
            print(f"{size}: {name}: kernel {r['ms']:.4f} ms "
                  f"({r['bound_ms'] / r['ms']:.1%} of its bound "
                  f"{r['bound_ms']:.4f} ms), first design "
                  f"{r['first_ms']:.4f} ms"
                  f"{'' if name not in ('skeleton_mark', 'split_step') else ' (%.1f%% of it)' % (100 * r['bound_ms'] / r['first_ms'])}"
                  f", plain {r['plain_ms']:.3f} ms, max err {r['err']}")
            if r.get("design_ms"):
                print(f"{size}: {name}: the design's own traffic (column "
                      f"table, sorted rows, [n, 9] counts), not in its bound: "
                      f"{r['design_ms']:.4f} ms at the memory rate")
        del net
        torch.cuda.empty_cache()


def k6_bytes(name, a):
    """The bytes a K6 stage call must move, each input read once and each
    output written once, counting only the rows that need them:
    ``final_keep`` a vertex's point, sdf column, keep flag and two marks, an
    edge's ends; ``face_keys_count`` a vertex's point, ends, first sign and
    zero words and key row (the design: and its two ranks in its tile, and
    a tile's 36 class counts; the first design: its zero count), the grid's
    marks and table; ``face_keys_fill`` (the design) a vertex's ranks, a
    used vertex's key row, point read and point written, a replica's key
    and id, the tiles' class counts once and the histogram (the first
    design: a used vertex's order, zero count and id instead of every
    vertex's ranks); the region stages a replica's key,
    permutation entry and id (``runs``: every used point, a replica's
    signature, count, mean and id written; ``dups``: a slot's signature and
    keep flag, a region's start and count, the members of a run of two or
    more); the fans a slot's keep flag, a kept region's start and count,
    its members' ids, its mean and (``count``) its row of the compact list
    and its mean written, a tile's status word (the first design: a slot's
    rank and triangles, a kept region's mean written); ``fill`` (the
    design) a kept region's row of the list, mean and normal, its members'
    ids and points (each used point once at most), its triangles (the first
    design: a slot's flag and offsets instead of the list)."""
    from tropical_torch.extract import device as dv

    if name == "final_keep":
        return a[0].shape[0] * (12 + 4 + 4 + 8) + a[2].shape[0] * 8
    if name == "face_keys_count_first":
        return a[0].shape[0] * (12 + 8 + 8 + 4 + 16) + _nb(a[4]) + _nb(a[5])
    if name == "face_keys_count":
        n = a[0].shape[0]
        tiles = -(-n // dv.KEYS_TILE)
        return (n * (12 + 8 + 8 + 16 + 8) + _nb(a[4]) + _nb(a[5])
                + tiles * 4 * (dv.KZ_MAX + 1))
    if name == "face_keys_fill":
        return (a[0].shape[0] * 8 + a[5] * (16 + 12 + 12) + a[6] * 12
                + _nb(a[3]) + 8 * (dv.KZ_MAX + 1))
    if name == "face_keys_fill_first":
        return a[6] * (8 + 4 + 4 + 16 + 12 + 12) + a[7] * 12
    if name == "face_regions_runs":
        n = a[0].shape[0]
        return n * (8 + 8 + 4 + 8 + 4 + 12 + 4) + _nb(a[3])
    if name == "face_regions_dups":
        ssig = a[0]
        real = ssig != dv.SIG_NONE
        runs = torch.zeros_like(real)
        runs[1:] = real[1:] & (ssig[1:] == ssig[:-1])
        runs[:-1] |= runs[1:].clone()
        members = int(a[2][a[1][runs]].sum())
        return ssig.shape[0] * (8 + 4) + int(real.sum()) * (8 + 4) + (
            4 * members)
    if name == "face_fans_fill":
        kl, n_kept, n_tri = a[0], a[5], a[6]
        members = int(kl[:n_kept, 1].sum())
        points = min(members, a[4].shape[0])
        return (n_kept * (16 + 12 + 12) + 4 * members + 12 * points
                + 24 * n_tri)
    rord, rcnt, svid, keep = a[0], a[1], a[2], a[4]
    j = torch.nonzero(keep)[:, 0]
    members = int(rcnt[rord[j]].sum())
    if name == "face_fans_count":
        tiles = -(-keep.shape[0] // 1024)
        return keep.shape[0] * 4 + j.numel() * (8 + 4 + 12 + 16 + 12) + (
            4 * members + 8 * tiles)
    if name == "face_fans_count_first":
        return keep.shape[0] * (4 + 8) + j.numel() * (8 + 4 + 8 + 12 + 12) + (
            4 * members)
    if name == "face_fans_fill_first":
        points = min(members, a[9].shape[0])
        return keep.shape[0] * 4 + j.numel() * (8 + 4 + 8 + 16 + 12 + 12) + (
            4 * members + 12 * points + 24 * a[10])
    raise KeyError(name)


def faces_profile(eng, args):
    """The faces stage (``Engine.faces``) on a loop's output: its span by
    CUDA events (warm, three runs) and, from one run under torch.profiler,
    its device time by kernel, the K6 kernels, the sorts and the encode
    (the normals) apart, its kernel launch calls and device activities, and
    the host's time by operation (self CPU time): {span_ms, busy_ms,
    launches, kernels, k6_ms, sort_ms, encode_ms, top, host_ms,
    host_top}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spans = []
    for _ in range(3):
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        eng.faces(*args)
        b.record()
        b.synchronize()
        spans.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.faces(*args)
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    k6 = ("keep_vertices", "keep_edges", "face_keys", "face_regions",
          "face_fans")
    group = lambda words: sum(v for n, v in by.items()
                              if any(w in n.lower() for w in words))
    top = sorted(by.items(), key=lambda kv: -kv[1])[:12]
    host = sorted(((e.key, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()), key=lambda kv: -kv[1])
    launched = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                              "cuLaunchKernel", "cuLaunchKernelEx")
                   for e in prof.events())
    return {"span_ms": spans, "busy_ms": sum(by.values()),
            "launches": launched, "kernels": sum(
                e.device_type == DeviceType.CUDA for e in prof.events()),
            "k6_ms": group(k6), "sort_ms": group(("sort",)),
            "encode_ms": group(("hashgrid", "bwd_kernel", "fwd_kernel")),
            "top": [(n[:60], round(v, 5)) for n, v in top],
            "host_ms": sum(v for _, v in host),
            "host_top": [(n[:40], round(v, 4)) for n, v in host[:10]]}


def k6_call(dv, name, args, kw, reps, kern=None):
    """One recorded or planted K6 stage call: by the kernel (``kern``: a
    build's ``Kernels``, None the committed design) and by the plain version
    (``faces_cases.held``), the kernel's results also after three replays of
    a CUDA graph of one call (the count vector, which each replay adds to,
    left out); the kernel's device time (``graph_ms``), the plain version's
    (CUDA events) and the call's bound (``k6_bytes``)."""
    import faces_cases

    faces_cases.held(dv, [(name, args, kw)], kern)
    fn = getattr(dv, name)
    res = fn(*[a.clone() if torch.is_tensor(a) else a for a in args],
             **{**kw, "kern": dv.PLAIN})
    n_res = len(res) if isinstance(res, tuple) else 1
    want = faces_cases.outputs(dv, name, args, kw, dv.PLAIN)[:n_res]
    got = graph_bits(fn, args, {**kw, "kern": kern})[:n_res]
    for x, y in zip(want, got):
        check(x.shape == y.shape and bits_equal(x, y),
              f"{name}: kernel after graph replays != plain")
    fixed, pfixed = clones(args), clones(args)
    return {"ms": graph_ms(lambda: fn(*fixed, **{**kw, "kern": kern}),
                           reps=reps),
            "plain_ms": cuda_ms(lambda: fn(*pfixed, **{**kw,
                                                       "kern": dv.PLAIN}),
                                iters=2),
            "bound_ms": k6_bytes(name, args) / PEAK_BYTES * 1e3}


def golden_check(dv, net, label, fill, Vf, tris):
    """K6's sphere-large output (``Vf``, ``tris``; ``fill`` its recorded
    fill call) against the JAX package's device faces
    (``LARGE_DEVICE_FACES``): the vertices within ``GOLDEN_VERTEX_ERR``
    index for index, the fan contract at the larger of ``GOLDEN_SHARE``
    and JAX's own host-against-device share, and each fan with a row JAX's
    lack its polygon started at another vertex, at the cut
    (``faces_cases.golden_ties``).  Returns the figures."""
    import faces_cases

    g = np.load(LARGE_DEVICE_FACES)
    share = max(GOLDEN_SHARE, float(g["jax_share"]))
    v = Vf.cpu().numpy()
    check(v.shape == g["vertices"].shape
          and tris.shape == g["triangles"].shape,
          f"{label}: K6 {v.shape}, {tuple(tris.shape)} != JAX's device faces' "
          f"{g['vertices'].shape}, {g['triangles'].shape}")
    err = float(np.abs(v - g["vertices"]).max())
    moved = int((np.abs(v - g["vertices"]) > 0).any(1).sum())
    print(f"{label}: vertices against JAX's device faces: max |diff| "
          f"{err:.3e} ({moved} vertices differ), bound {GOLDEN_VERTEX_ERR}")
    check(err <= GOLDEN_VERTEX_ERR, f"{label}: vertices {err} off JAX's")
    differ, rows = fan_contract(g["vertices"], tris.cpu().numpy(),
                                g["triangles"], "JAX's device faces", share)
    ties = faces_cases.golden_ties(dv, net, fill, tris, g["triangles"],
                                   g["vertices"])
    print(f"{label}: {differ} of {rows} rows differ ({differ / rows:.4%}; "
          f"bound {share:.4%}, JAX's own host against device "
          f"{float(g['jax_share']):.4%}); the fans that differ: "
          f"{json.dumps(ties)}")
    check(ties["k6_rows"]
          and ties["differ"] == ties["rotations"] == ties["explained"],
          f"{label}: fans that differ from JAX's device faces other than by "
          f"their start, or that K6's score on JAX's vertices does not "
          f"give: {ties}")
    return {"rows_differ": differ, "rows": rows, "share_bound": share,
            "jax_share": float(g["jax_share"]), "max_vertex_err": err,
            "vertices_differ": moved, "ties": ties}


def faces_phase(records, flat_launches, curved_launches):
    """K6 on the card at sphere-small flat, sphere-medium curved and
    sphere-large flat, in the design and in the first design of face_keys
    and face_fans (``cuda_build.FACES_FIRST``): every stage call of
    ``Engine.faces`` recorded from a run of each build's engine, and the
    planted calls of ``tests/faces_cases.py``, each bitwise its plain
    version (also after graph replays), timed beside its bound, a graph
    node's floor and the plain version; the two builds' results bitwise
    equal; the stage's result against the host faces on the same loop
    output, and at sphere-large against the JAX package's device faces
    (``golden_check``, the first design first); the stage's span, launches
    and device time by kernel in each build.  Adds the K6 kernel
    records."""
    phase("11d. the faces (K6) against their plain versions, sphere-small "
          "flat, sphere-medium curved, sphere-large flat")
    sys.path.insert(0, "tests")
    import faces_cases

    from tropical_torch.extract import device as dv
    from tropical_torch.extract.faces import extract_faces, extract_skeleton
    from tropical_torch.ops import cuda_build

    first = dv.Kernels(cuda_build.load(cuda_build.FACES_FIRST),
                       torch.device("cuda", 0))
    check(first.first_faces, "the FACES_FIRST build takes K6's first design")
    floor_ms = graph_floor_ms()
    for kern, label in ((None, "design"), (first, "first design")):
        planted = faces_cases.planted_calls(dv, "cuda", first=kern is first)
        for name, args, kw in planted:
            k6_call(dv, name, args, kw, reps=10, kern=kern)
        print(f"{len(planted)} planted K6 calls of the {label} bitwise their "
              f"plain versions, also after graph replays")
    print(f"a graph node's floor {floor_ms:.5f} ms")
    for size, force, tag, contract in K6_RUNS:
        net = sphere_net(size)
        eng = dv.Engine(net, force=force)
        eng1 = dv.Engine(net, force=force, kern=first)
        sk = eng.skeleton("dist")
        args = eng.loop(*eng.pools(sk[0], sk[1], sk[5], sk[2:5]))
        (funnel1, V1, t1), calls1 = faces_cases.record(
            dv, lambda: eng1.faces(*args))
        (funnel, Vf, tris), calls = faces_cases.record(
            dv, lambda: eng.faces(*args))
        check([c[0] for c in calls] == list(K6_STAGES)
              and [c[0] for c in calls1] == list(K6_FIRST_STAGES),
              f"{size}: K6 stage calls {[c[0] for c in calls]}, the first "
              f"design's {[c[0] for c in calls1]}")
        check(funnel1 == funnel and bits_equal(V1, Vf)
              and bits_equal(t1, tris),
              f"{size}: the first design's faces != the design's")
        golden = None
        if size == "large":
            golden = {"first_design": golden_check(
                dv, net, f"{size}, the first design", calls1[-1], V1, t1)}
            golden["design"] = golden_check(dv, net, size, calls[-1], Vf,
                                            tris)
        V, OUT, E = args[:3]
        Vh, Eh, vidx = extract_skeleton(V, E.long(), OUT, net, eng.eps)
        _, th = extract_faces(Vh, Eh, net, OUT[vidx], eng.eps)
        check(bits_equal(Vf, Vh) and funnel == (
            V.shape[0], E.shape[0], Vh.shape[0], Eh.shape[0])
            and tris.shape == th.shape,
            f"{size}: K6 {funnel}, {tuple(tris.shape)} != the host faces' "
            f"{Vh.shape[0]}/{Eh.shape[0]}, {tuple(th.shape)}")
        print(f"{size}: K6 against the host faces on the same loop output: "
              f"funnel {funnel}, {tris.shape[0]} triangles, vertices "
              f"bitwise; the first design's faces bitwise the design's")
        fan_contract(Vh.cpu().numpy(), tris.cpu().numpy(), th.cpu().numpy(),
                     "the host faces", contract)
        ties = faces_cases.fan_ties(dv, net, calls[-1], tris, th)
        print(f"{size}: the fans that differ from the host faces': "
              f"{json.dumps(ties)}")
        check(ties["host_rows"] and ties["k6_rows"]
              and ties["differ"] == ties["rotations"] == ties["near"],
              f"{size}: fans that differ from the host faces' other than by "
              f"their start at the cut: {ties}")
        kl, n_kept = calls[-1][1][0], calls[-1][1][5]
        largest = int(kl[:n_kept, 1].max())
        print(f"{size}: {n_kept} kept regions, the largest of {largest} "
              f"members")
        reps = 20 if size == "large" else 50
        per = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "calls": 0,
                   "first_ms": 0.0, "first_bound_ms": 0.0, "first_calls": 0}
               for k in K6}
        timed = [(c, None, "") for c in calls] + [
            (c, first, "first_") for c in calls1
            if K6_FIRST_STAGES[c[0]] in K6_REDESIGNED]
        for (name, a, kw), kern, pre in timed:
            r = k6_call(dv, name, a, kw, reps, kern=kern)
            rec = per[K6_FIRST_STAGES.get(name) or K6_STAGES[name]]
            for key in ("ms", "bound_ms"):
                rec[pre + key] += r[key]
            if not pre:
                rec["plain_ms"] += r["plain_ms"]
            rec[pre + "calls"] += 1
            print(f"{size}: {name}: kernel {r['ms']:.5f} ms "
                  f"({share(r['bound_ms'], r['ms'])} of its bound "
                  f"{r['bound_ms']:.7f} ms, {r['ms'] / floor_ms:.1f} graph "
                  f"nodes' floor), plain {r['plain_ms']:.3f} ms")
        # face_keys' gather of the used vertices beside index_select
        fill = next(c for c in calls if c[0] == "face_keys_fill")[1]
        used = torch.nonzero(next(c for c in calls if c[0] ==
                                  "face_keys_count")[1][3][1])[:, 0]
        check(bits_equal(fill[0].index_select(0, used), Vf),
              f"{size}: index_select of the used rows != face_keys' rows")
        gather_ms = graph_ms(lambda: fill[0].index_select(0, used),
                             reps=reps)
        profs = {}
        for label, e in (("first design", eng1), ("design", eng)):
            prof = profs[label] = faces_profile(e, args)
            print(f"{size}: the faces stage, {label}: span "
                  f"{prof['span_ms']} ms (CUDA events, warm), "
                  f"{prof['launches']} launches, device busy "
                  f"{prof['busy_ms']:.4f} ms (K6 {prof['k6_ms']:.4f}, sorts "
                  f"{prof['sort_ms']:.4f}, encode {prof['encode_ms']:.4f}); "
                  f"by kernel {prof['top']}; host self time "
                  f"{prof['host_ms']:.3f} ms under the profiler, by "
                  f"operation {prof['host_top']}")
        print(f"{size}: the used vertices' gather: index_select "
              f"{gather_ms:.5f} ms ({used.numel()} rows)")
        for k in K6:
            r = per[k]
            rec = records.setdefault(k, {
                "name": k, "route": "cuda",
                "source": "tropical_torch/csrc/faces.cu",
                "replaces": K6_REPLACES[k],
                "launches": flat_launches[k],
                "launches_curved": curved_launches[k],
                "max_abs_err": 0.0, "bound_by": "bytes", "library_ms": None,
                "graph_node_floor_ms": floor_ms})
            rec.update({f"ms{tag}": r["ms"], f"plain_ms{tag}": r["plain_ms"],
                        f"bound_ms{tag}": r["bound_ms"],
                        f"calls_timed{tag}": r["calls"]})
            first_note = ""
            if k in K6_REDESIGNED:
                rec.update({f"first_ms{tag}": r["first_ms"],
                            f"first_bound_ms{tag}": r["first_bound_ms"]})
                first_note = (f", the first design {r['first_ms']:.5f} ms "
                              f"({share(r['first_bound_ms'], r['first_ms'])}"
                              f" of its bound)")
            if k == "face_keys":
                rec[f"gather_library_ms{tag}"] = gather_ms
            if k == "face_fans":
                rec[f"fan_ties{tag}"] = ties
                rec[f"largest_region{tag}"] = largest
                if golden is not None:
                    rec[f"golden{tag}"] = golden
            print(f"{size}: {k}: {r['calls']} calls, kernel {r['ms']:.5f} "
                  f"ms ({share(r['bound_ms'], r['ms'])} of its bound "
                  f"{r['bound_ms']:.7f} ms){first_note}, plain "
                  f"{r['plain_ms']:.3f} ms")
        records["final_keep"].setdefault("faces_stage", {})[size] = profs
        del net, eng, eng1, args, calls, calls1
        torch.cuda.empty_cache()


def host_loop(net, V, E, force=True):
    """The host engine from (V, E) through the final insertion."""
    from tropical_torch.extract import subdivide as sp

    outputs = None
    for l in range(net.num_layers - 1):
        for h in range(net.num_hidden):
            V, E, outputs = sp.subpoly_(V, E, net, l, h, 1e-4, outputs,
                                        force=force)
    return sp.subpoly_(V, E, net, net.num_layers - 2, net.num_hidden, 1e-4,
                       outputs, force=force)


def curved_loop(net, label="medium curved"):
    """The curved loop from the device skeleton against the host engine's
    curved loop from the same skeleton: vertices, outputs, edges and the
    ``failover.COUNTERS`` bit for bit.  The two run the same forwards on
    the same rows in the same batches (cuBLAS rounds by batch size); where
    they differ, the first rows that differ are named.  Returns the device
    engine's counters and its curved insertions."""
    from tropical_torch.extract import device as dv
    from tropical_torch.extract import failover as fo

    eng = dv.Engine(net, force=False)
    sk = eng.skeleton("dist")
    V, E = sk[0], sk[5]
    fo.reset_counters()
    t = time.perf_counter()
    Vd, Od, Ed, *_ = eng.loop(*eng.pools(V, net.outputs(V), E))
    torch.cuda.synchronize()
    t_dev, dev_counts = time.perf_counter() - t, dict(fo.COUNTERS)
    fo.reset_counters()
    t = time.perf_counter()
    Vh, Eh, Oh = host_loop(net, V, E.long(), force=False)
    torch.cuda.synchronize()
    t_host, host_counts = time.perf_counter() - t, dict(fo.COUNTERS)
    same = (Vd.shape == Vh.shape and Ed.shape == Eh.shape
            and bits_equal(Vd, Vh) and bits_equal(Od, Oh)
            and torch.equal(Ed.long(), Eh) and dev_counts == host_counts)
    print(f"{label}: the loop from the device skeleton ({V.shape[0]} "
          f"vertices, {E.shape[0]} edges): {Vd.shape[0]}/{Ed.shape[0]}, the "
          f"host engine's {Vh.shape[0]}/{Eh.shape[0]}, bitwise {same}; "
          f"counters {dev_counts} / {host_counts}; loop {t_dev:.4f} s, host "
          f"engine {t_host:.4f} s; the curved insertions {eng.stats.curved}")
    if not same:
        n = min(Vd.shape[0], Vh.shape[0])
        rows = torch.nonzero((Vd[:n] != Vh[:n]).any(1)
                             | (Od[:n] != Oh[:n]).any(1))[:8, 0].tolist()
        print(f"{label}: the first vertex rows that differ {rows}: "
              f"device {Vd[rows].tolist()}, host {Vh[rows].tolist()}")
    check(same, f"{label}: the device loop != the host engine")
    return dev_counts, eng.stats.curved


def kinked_net(device="cuda"):
    """The x30000 kinked net (``KINKED_SPEC``; tests/test_device_curved.py
    ``_kinked_net(r_max=6, levels=3, scale=30000)``) from the port's own
    init with ``KINKED_SEED``: its table scaled by ``KINKED_SCALE``, so
    that most split edges are curved and their roots poor, and the last
    bias shifted by the mean of the two outputs' difference at 512 seeded
    points of [-1, 1]^3, so that the zero set crosses the cube."""
    from tropical_torch.core.net import NetSpec, TorchNet

    net = TorchNet(NetSpec(**KINKED_SPEC), device=device,
                   generator=torch.Generator().manual_seed(KINKED_SEED))
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (512, 3)).astype(np.float32)).to(device)
    with torch.no_grad():
        net.enc.table.mul_(KINKED_SCALE)
        out = net(x)
        net.fc[-1].bias[1] -= (out[:, 1] - out[:, 0]).mean()
    return net


def rescue_phase(device="cuda"):
    """A curved run whose insertions rescue rows, on the card: the x30000
    kinked net (``kinked_net``), its curved loop from the device skeleton
    bitwise the host engine's (``curved_loop``), with rows rescued, and
    K4c's launches in it: curved_roots and curved_resolve one an insertion
    with curved rows, and at each with rescued rows curved_mix after the
    rescue and curved_filter's two again.  Returns the device engine's
    counters."""
    phase("11c. a rescue on the card: the x30000 kinked net, curved, the "
          "device engine against the host engine")
    from tropical_torch.ops import launches

    net = kinked_net(device)
    launches.reset()
    counts, curved = curved_loop(net, "x30000 kinked")
    steps = sum(c > 0 for _, _, c, *_ in curved)
    rescues = sum(g > 0 for _, _, _, g, *_ in curved)
    print(f"x30000 kinked: {len(curved)} busy insertions, {steps} with curved "
          f"rows, {rescues} with rescued rows ({counts['gd_rows']} rows, "
          f"{counts['gd_steps']} rescue steps); K4c's launches "
          f"{ {k: launches.LAUNCHES[k] for k in CURVED_KERNELS} }")
    check(counts["gd_rows"] > 0 and rescues > 0,
          f"x30000 kinked: no row rescued ({counts})")
    want = {"curved_select": 0, "curved_roots": steps,
            "curved_resolve": steps + rescues,
            "curved_filter": 2 * (len(curved) + rescues)}
    got = {k: launches.LAUNCHES[k] for k in want}
    check(got == want, f"x30000 kinked: K4c's launches {got}, want {want}")
    del net
    if device == "cuda":
        torch.cuda.empty_cache()
    return counts


def same_sets(size, a, b):
    """The final vertex sets of the dist and sign runs: the same count and
    a one-to-one nearest-neighbour match within 5e-6, the port's flat
    bound against JAX (the MLP's summation order: cuBLAS rounds the new
    vertices' forward by the batch's size, and the two skeletons give the
    insertions other batches; on the CPU the sets are equal bit for bit,
    tests/test_torch_device_engine.py); the vertices not bitwise in the
    other set counted."""
    from tropical_torch.ops.chamfer import min_nn_distance

    check(a.shape == b.shape, f"{size}: dist {tuple(a.shape)} != sign "
          f"{tuple(b.shape)} vertices")
    d2, idx = min_nn_distance(a.contiguous(), b.contiguous())
    far = math.sqrt(float(d2.max()))
    one_to_one = int(torch.unique(idx).numel()) == b.shape[0]
    exact = int((d2 > 0).sum())
    print(f"{size}: dist and sign skeletons, {a.shape[0]} final vertices "
          f"each, {exact} not bitwise in the other set, the farthest "
          f"{far:.3e} from its twin, one to one: {one_to_one}")
    check(one_to_one and far <= 5e-6, f"{size}: dist != sign")


def presets_phase():
    """Sphere-medium and sphere-large, flat, at full width from their
    committed checkpoints: the funnel within 0.5 % of the JAX CLI's, the
    same final vertex set from the dist and sign skeletons, the loop equal
    to the host engine's (bit for bit, vertices, outputs and edges in order)
    when both start from the device's skeleton, the time split."""
    phase("12. sphere-medium and sphere-large, flat, and sphere-medium "
          "curved, through the device engine")
    from tropical_torch.extract import device as dv
    from tropical_torch.extract import stats
    from tropical_torch.extract.subdivide import subpoly

    from tropical_torch.ops import launches

    out = {}
    for size in ("medium", "large"):
        net = sphere_net(size)
        takes = []
        launches.reset()
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, vd, td = subpoly(net, 3, 1.2, force=True, verbose=False)
            torch.cuda.synchronize()
            takes.append(time.perf_counter() - t)
        got, want = dict(stats.LAST), preset_funnel(size)
        worst = max(abs(got[k] - want[k]) / want[k] for k in want)
        print(f"{size}: funnel {got}, the JAX CLI's {want} "
              f"({'exact' if got == want else f'within {worst:.3%}'}); "
              f"take {takes}; skeleton / loop / faces "
              f"{[dv.LAST.t_skeleton, dv.LAST.t_loop, dv.LAST.t_faces]} s; "
              f"busy {dv.LAST.busy}; reads {dv.LAST.reads}")
        check(worst <= 0.005, f"{size}: funnel {got} off the JAX CLI's {want}")
        k6 = {k: launches.LAUNCHES[k] for k in K6}
        check(k6 == {k: 2 * K6_LAUNCHES for k in K6},
              f"{size}: K6 launched {k6} in two extractions")
        if size == "medium":  # small's and large's: phase 11
            fires = override_fires(net)
            print(f"{size}: the sign override fired at "
                  f"{sum(f for *_, f in fires)} of {len(fires)} busy "
                  f"insertions (plane, splits, fired): {fires}")
        _, vs, ts = dv.subpoly_device(net, verbose=False, skeleton_mode="sign")
        same_sets(size, vd, vs)
        check(td.shape == ts.shape, f"{size}: dist and sign triangles "
              f"{td.shape} / {ts.shape}")
        eng = dv.Engine(net)
        sk = eng.skeleton("dist")
        V, E = sk[0], sk[5]
        t = time.perf_counter()
        Vd, Od, Ed, *_ = eng.loop(*eng.pools(V, net.outputs(V), E))
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t
        t = time.perf_counter()
        Vh, Eh, Oh = host_loop(net, V, E.long())
        torch.cuda.synchronize()
        t_host = time.perf_counter() - t
        same = (Vd.shape == Vh.shape and Ed.shape == Eh.shape
                and bits_equal(Vd, Vh) and bits_equal(Od, Oh)
                and torch.equal(Ed.long(), Eh))
        print(f"{size}: the loop from the device skeleton ({V.shape[0]} "
              f"vertices, {E.shape[0]} edges): {Vd.shape[0]}/{Ed.shape[0]}, "
              f"the host engine's {Vh.shape[0]}/{Eh.shape[0]}, bitwise "
              f"{same}; loop {t_dev:.4f} s, host engine {t_host:.4f} s")
        check(same, f"{size}: the device loop != the host engine")
        out[size] = {"funnel": got, "take_s": takes,
                     "split_s": [dv.LAST.t_skeleton, dv.LAST.t_loop,
                                 dv.LAST.t_faces]}
        if size == "medium":
            curved_loop(net)
        del net
        torch.cuda.empty_cache()
    return out



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    import tropical_torch  # noqa: F401  (fails outside a checkout)

    name, smi = device_phase()
    build_phase()
    records = {r["name"]: r for r in kernel_phase()}
    flat_launches, flat_largest, flat_cd, flat_meshes = main_path_phase()
    mesh_digest = file_digest("meshes_torch/sphere/our_mesh_small_1.ply")
    engines = engines_phase()
    curved_launches, curved_inputs, curved_take, curved_meshes = \
        curved_path_phase()
    records["min_dist"]["launches"] = flat_launches["min_dist"]
    records["min_dist"]["launches_curved"] = curved_launches["min_dist"]
    # K7's own launches are the host engine's curved path's; the device
    # engine's runs its solve inside curved_roots
    host_k7 = engines["medium curved"]["host"]["trilinear_roots"]
    check(host_k7 > 0, "the host engine's curved extraction launched no "
          "trilinear_roots")
    records["trilinear_roots"].update(
        launches=host_k7,
        launches_path="subpoly(engine='host', force=False), sphere-medium "
                      "(phase 4b)",
        launches_curved=curved_launches["trilinear_roots"],
        runs_in="curved_roots on the device engine's curved path")
    shapes_phase(records, flat_largest, curved_inputs, curved_take)
    train_launches = training_phase(flat_cd)
    for k in ENCODE:
        records[k].update(launches=train_launches[k],
                          launches_flat=flat_launches[k],
                          launches_curved=curved_launches[k])
        if f"{k}_scatters" in train_launches:
            records[k].update(
                scatters=train_launches[f"{k}_scatters"],
                scatters_flat=flat_launches[f"{k}_scatters"],
                scatters_curved=curved_launches[f"{k}_scatters"])
    cli_training_phase()
    eval_launches, gt_mesh, eval_meshes = evaluate_phase(mesh_digest,
                                                         records)
    bvh_phase({"flat": flat_meshes, "curved": curved_meshes,
               **{f"evaluate -t {m}": v for m, v in eval_meshes.items()}},
              gt_mesh, records)
    for k in BVH:
        records[k].update(
            launches=(train_launches if k == "bvh_closest"
                      else flat_launches)[k],
            launches_flat=flat_launches[k], launches_curved=curved_launches[k],
            launches_training=train_launches[k],
            launches_training_evaluation=train_launches[f"{k}_evaluation"])
    for k in ("min_dist", "hashgrid_encode_fwd", *BVH):
        records[k].update(
            launches_evaluate=sum(c[k] for c in eval_launches.values()),
            **{f"launches_evaluate_{m}": c[k]
               for m, c in eval_launches.items()})

    device_kernels_phase(records, flat_launches)
    curved_kernels_phase(records, curved_launches)
    faces_phase(records, flat_launches, curved_launches)
    rescue_phase()
    presets_phase()

    phase("13. result")
    print(json.dumps({"kernels": list(records.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
