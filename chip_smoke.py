"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            the whole run
    python3 chip_smoke.py main       only the named phases (kernels,
                                     packed, reference, main, planner,
                                     planner_wide, terminate_wide,
                                     harness, export, vps, loop, train,
                                     vps_train, demo, dp, tools),
                                     without the result lines

Phases, one line each (any failure exits non-zero):
  1. device   - requires CUDA; prints the card's name and power limit;
  2. build    - compiles pvo_tpu_torch/csrc/corr.cu, corr_exp.cu,
                segsum.cu, dba.cu and cond.cu (nvcc, sm_90a), all at
                once;
  3. kernels  - each CUDA kernel against its plain PyTorch version on the
                same inputs, C=128. K1 and K2 at 30x101, E in {1, 24, 48}:
                <= 2e-2 (bf16 volume); K1 (the bf16 kernel, also at a
                ragged E=3 17x45, and the f32 kernel's three TF32 passes
                at E=2 30x101 and E=3 17x45) must also give >= 99.9% of
                entries bit-equal, every entry within one bf16 ulp and
                pad columns exactly 0; K2 must also reproduce, bit for
                bit, the output of the kernel it replaced on a saved
                case. K3 <= 1e-4 at 30x101 with E in {1, 48, 256}, wide
                47x156 with E in {2, 256} (the backend's chunk on a
                wide stream; its plain version on slices of the edges)
                and tall 128x40, for bf16 features (bf16
                products) and f32 ones (three TF32 passes), through both
                entries (gathered features, and frames + pyramid + edge
                indices in the kernel), on smooth, scattered, mixed,
                NaN/huge and border-band coordinates; the mixed case
                must take both routes of either kernel and the smooth
                one only the tensor cores; the indexed entry on f32
                features must launch once and allocate only its output;
                the f32 kernel also at C=24 (f32 and bf16 features), 1
                to 4 levels, and where the last level is pooled away to
                nothing. For K1-K3 the time stands beside its bound
                (kbench.kernel_bound) and, for K1, beside torch.bmm on
                the same operands (a yardstick the port never calls).
                P1 (X1) and P2 (X2-X5)
                in every variant at their harness shapes and in
                border-straddling bands, |d| <= 2e-2 + 8e-3 |ref| (bf16
                outputs) with >= 99.9% of outputs bit-equal (P2: all of
                them, and the sha256 of the kernel it replaced on a
                saved case), and every two variants' outputs differing
                in >= 1%; P1 (bf16 wgmma products) also on smooth
                coordinates at 64x30x101 and 2x47x156, on mixed and
                NaN/huge ones, at a ragged 3x17x45 and where the last
                level is pooled away to nothing, its (block, level)
                pairs within and above the bounding-box cap equal to
                the numpy model's (smooth: none above). The segment sum
                (segsum.cu, B5) bit-equal to the CPU's index_add_ at
                the planner's full-width shapes (GraphAgg's sum and
                counts; the DBA's Hessian, gradient, C, w, edge x
                depth, Schur, pair and rhs sums; GraphAgg's, C, w and
                edge x depth also at 376x1248, 47x156), each in
                both modes (accumulate, zero start), and in the
                tracker's batched launches (GraphAgg's; the DBA's two
                a full iteration; the first two at 376x1248 too), with
                its kernel time (a CUDA graph of calls) beside the
                card's index_add_ and its bound.
                The DBA's kernels (dba.cu: linearize, Schur terms, the
                damped solve, the update after the solve: the
                back-substitution with
                its edge terms summed per depth frame and the pose
                retraction, one launch) at dba_probe.SHAPES (30x101 with
                E=144, K=P=32, 2048 pair slots, and the same at 47x156,
                planner_wide; E=48; 47x156; 128x40;
                E=1; motion-only; E=48 at 47x155, an odd pixel count;
                the backend's recorded call, E=1008 over K=100 frames,
                and at 40 keyframes, the P (about 39) that phase 5
                gives the solve, and at 40 keyframes of a 376x1248
                stream (planner_wide's terminate); crowded: E=958 over
                32 frames, about
                30 edges a frame; the filler's P=16 motion-only; P =
                K = cuda_dba.SOLVE_MAX_P): each output within 1e-4 of
                the plain version relative to its largest magnitude,
                two calls bit-equal, a CUDA-graph replay equal to the
                eager call,
                the back-substitution's poses within dba_probe.POSE_TOL
                abs/rel of se3.retr on the card,
                dba.dba's poses and disparities after 2 iterations
                within 1e-4 abs/rel of the plain versions' at the
                planner's shape (elsewhere within 4x the plain versions'
                own card-against-CPU difference, if larger); times by
                CUDA graph beside the plain versions', the bound and,
                for the Schur terms, one bmm of every depth frame's
                weighted Gram (whose blocks are all its rows); at
                planner_wide each call timed with the L2 cleared before
                it (DBA_COLD). The
                solve (dba_probe.check_solve) at every shape, up to
                buffer's P = 511 (also the filler's, P=16 motion-only;
                multi_49, P = 49; backend_wide, the backend's call at
                100 keyframes of a 376x1248 stream, P = 99), one block
                (dba_solve) up to P = 48 and the grid kernel
                (dba_solve_grid) above: dx within 1e-4 of the plain
                version, or 4x the plain version's own card-against-CPU
                difference where larger, bit-equal to the numpy
                emulation of its order (scripts/dba_solve_emul.py) up
                to P = 128, its backward error against the f64 system
                within twice the plain version's plus 1e-7, two calls
                bit-equal, a replay equal to eager, and at P <= 48 the
                grid kernel bit-equal to the one block; timed (planner,
                bench_dba, filler, solve_max, multi_49, backend,
                backend_wide, buffer) beside the plain version and
                cholesky_ex + cholesky_solve, the grid kernel also at P
                = 32 and 48;
  4. reference- the port's loop with the kernels (the DBA's too) against
                the same loop with their plain versions, on the card:
                64x96, 8 frames
                + terminate(image_stream), same weights (mask logits
                biased away from the threshold), all 8 poses within
                1e-3;
  5. main     - VOSystem at 240x808 (the bench.py configuration, the
                default one: the planner engages at frame 13 and its
                frames replay one CUDA graph; weights of tame_net(0)),
                40 frames tracked, then
                terminate(image_stream, backend_steps=(7, 12)), with
                every kernel launch counted (a graph's per replay), the
                segment sum's too, and whether the frontend caches K1's
                volume (narrow stream); fps and ms/frame over the
                steady state after initialization (t=13..39), and fps
                over the replayed frames after the capture;
                terminate_s (last update + backend) apart from filler_s;
                the backend's wall time apart from the rest of
                terminate_s, K3's time inside it (wrapper and kernel
                alone, CUDA events) and the share of K3's (block, level)
                pairs that ran on the tensor cores; at the end,
                get_depth() and get_flow() give finite (counter, 240,
                808) and (counter, 240, 808, 2) arrays. Then one more
                terminate under torch.profiler: device ms and kernels
                inside each vo.backend.* / vo.filler.* range and the
                corr kernels' own rows; and depth_consistency_count on
                the video's keyframes (CUDA events, byte bound, counts
                against the CPU's);
  6. harness  - the corr experiment harnesses
                (python -m pvo_tpu_torch.scripts.corr_exp*), each
                program once (corr_exp5 runs corr_exp4's) with its
                kernel's launches counted: P1's and P2's times beside
                their plain versions; P1 through the wrapper and as the
                kernel alone on the harness's uniform coordinates and on
                smooth ones, with bound, share and route counts;
  7. export   - the flow/depth export (scripts.test_vo2.export_pair on
                DroidNet.forward, f32, weights of tame_net(0,
                mask_bias=-2)). K1-K3 at the export's shapes (E=2, f32
                features) against plain, with time and bound. The
                forward with the kernels against the
                same forward with their plain versions, 2 frames, 3
                iterations, at 64x96 (narrow: K1 once, K2 per step) and
                64x1000 (wide: K3 per step): 1/8-res flows and upsampled
                disparities within EXPORT_TOL. Then the path at full
                width, 376x1248 (47x156 features), 15 iterations: one
                warm-up pair, the launch counts set to 0, 5 timed pairs
                (synchronized, readbacks included), the counts read:
                vo2_export_s_per_pair, peak memory, launches of K1/K2/K3
                per pair (must be 0/0/15), K3's time per step (wrapper
                and kernel alone, CUDA events), and one pair under
                torch.profiler (device ms, kernels and aten ops per
                pair). Then the narrow route, 240x808: 1/15/0.
  8. vps      - the VPS predictor (Panoptic FPN R-50 with flow-guided
                fusion, vps/panoptic_fpn.py), weights of
                benchmark_vps.tamed_model(0). The card against the CPU,
                same weights, 128x192, TF32 off: plain, fusion with flow
                and depth, fusion with depth_proj; sem equal on >= 99.9%
                of pixels, the same valid detections (boxes within 1e-2
                px, scores within 1e-4), pan equal on >= 99.5%; the splat
                alone on the same inputs: targets equal on >= 99.9% of
                each level, features bit-equal where they agree. Then
                375x1242 (padded 384x1248), f32 and bf16, plain, fusion
                with device-resident flow and depth, and the file protocol
                (host flow and 1/8-res depth, staged): one warm-up,
                VPS_FRAMES (5) frames with one in flight: vps_frames_per_sec, ms/frame,
                peak memory, valid detections and pasted instances per
                frame (both > 0); one fused frame under torch.profiler:
                device ms by layer, NMS/ROIAlign/splat/stitch device and
                host ms, kernels and aten ops, the card's busy share.
  9. loop     - the PVO loop (scripts.run_pvo_loop, stages in this
                process) at full size, two iterations: a synthetic
                scene of 72 frames at 375x1242, both views
                (data.synth_scene), prepared by scripts.prepare_vkitti,
                weights saved as reference-format checkpoints
                (tame_net(0, LOOP_HEAD_SCALE, LOOP_MASK_BIAS),
                tamed_model(0)); VO 240x808 at VOConfig's thresholds,
                export 376x1248 at 15 iterations, VPS 375x1242 R-50.
                Per stage: seconds, peak memory, corr launches; for
                test_vo the keyframes admitted and removed and the
                backend's edges; for the VPS stages the host stitch's
                seconds. The artifacts of tests/test_pvo_loop.py
                scaled to 64 frames; K1, K2, K3 bf16 and K3 f32 each
                launched in the loop, and each test_vo2 stage 0/0/15
                launches a pair (K3 f32 only); whether the two
                iterations' test_vo (equal inputs, J2) make the same
                keyframe decisions is held (B5).
 10. train    - VO training (parallel/data_parallel.py, f32, TF32 off,
                the plain differentiable lookup). (a) one restart pass
                (sup, 48x64, F=4, 2 iterations, tame_net(0,
                mask_bias=-2)) on the CPU and on the card: loss within
                1e-4 relative; every weight tensor's gradient above 1e-4
                of the total norm within 5e-4 relative L2 with cuDNN on
                (what training runs) and off (B4: TF32 off through
                PyTorch's newer precision API too, utils/device.py); (b)
                bench_train_vo's default protocol (sup, 4 iterations,
                48x64, F=4, TRAIN_DEFAULT_STEPS (20) steps on one
                batch, random weights):
                finite losses, a checkpoint round trip bit-equal, the
                canary on the dynamic-mask BCE (gt_l: the mean of its
                last tenth below half its first tenth's; the total
                loss's curve is chaotic on random weights and its ratio
                is printed, not held);
                steps/s, the loss ratio, peak memory; (c) the reference
                recipe at full size (semisup, 15 iterations, 6 frames,
                200x400 crop, restart loop, remat) on a synthetic scene
                for TRAIN_RECIPE_STEPS (2) outer steps: finite losses and gradients, s/step,
                grad passes/s, peak memory; one more step timed and
                under torch.profiler (kernel ms, busy share, five
                costliest kernels), its peak memory with remat off, and
                the plain lookup's forward and backward alone at the
                recipe's shapes; (d) K1-K3, P1 and P2 launched 0 times
                in (b) and (c) ("launches_train" in the kernels line).
 11. vps_train- VPS training (vps/train.py, f32, TF32 off). (a) the full
                and the fusion loss at 64x96 on the R-50 (random weights
                from seed 0, fixed RPN priorities), card against CPU with
                cuDNN on and off: loss within 1e-4 relative, every
                tensor's gradient above 1e-4 of the total norm within
                VPS_GRAD_TOL relative L2; (b) bench_train_vps's fusion
                finetune (64x96, 150 steps: the last loss below 0.9 of
                the first) and bench_vps_train's full model (R-50 at
                384x1248, tamed weights, VPS_FULL_STEPS (20) steps:
                finite losses that fall), steps/s and peak memory; (c) one full step at
                384x1248 timed and under torch.profiler: kernel ms,
                launches, busy share, the five costliest kernels; (d)
                K1-K3, P1 and P2 launched 0 times in (b) and (c)
                ("launches_vps_train" in the kernels line).
 12. planner  - (run after phase 5) the planner at 240x808 over
                PLANNER_FRAMES (28) frames of bench_track's stream: classic, planner graph,
                planner graph, classic, in turns; the eager planner on
                the card;
                classic and planner graph under an oracle update core.
                Held: engage at frame 13; graph replay bit-equal to the
                eager planner (poses, disparities, decision records);
                each path's two runs bit-equal (B5); under the oracle
                core the planner's decisions equal the classic path's,
                poses within 1e-3; capture fails on any host read;
                PLANNER_SEGSUMS (30) segment-sum launches a replay and
                PLANNER_DBA's DBA-kernel launches (12, 12, 12, 12);
                K3's route counters hold every (block, level) pair of
                the replays' K3 launches (the probe's f32 K3 here).
                Printed: ms and frames/s a run, device ms, kernels, host
                CUDA API calls and busy share a frame, capture seconds,
                the graph's launches a frame.
 12b. planner_wide - (after phase 12, in a process of its own: after
                earlier graphs and profiles in a process the profiler can
                name a later graph's kernels wrongly) the same runs at
                376x1248 (47x156
                features: the "indexed" route, an update's 2E frames
                gathered and pooled once, K3 bf16 on every step; the
                classic runs take the classic frontend's wide route)
                over WIDE_FRAMES (26) frames. Held as in phase 12, and:
                no K1 and no K2 a replay, K3 bf16 once per update step
                that ran; K3's route counters hold every pair of the
                replays' launches; K3 on the engaged planner's own
                operands (lookup_operands, the update's coordinates)
                within 1e-4 of its plain version. A second stream of
                WIDE_RM_FRAMES (18) frames at keyframe_thresh
                WIDE_KF_THRESH (6.0): graph bit-equal to eager; under
                the oracle core the planner removes at least two
                keyframes and equals the classic path (the same removed
                timestamps, poses within 1e-3). Then the first graph
                run tracks on to WIDE_TERM_FRAMES (40) frames, the
                planner re-engaging on its graph, and terminates
                (image_stream, backend_steps=(7, 12)): finite
                trajectory, get_depth() and get_flow() at (counter, 376,
                1248[, 2]), no K1 or K2. Printed: each
                run's numbers as in phase 12, the regime of each update
                frame, K3 at E=48 47x156 (kernel alone by CUDA events,
                plain, bound, routes, launches a replay), the ms of an
                update call's lookup_operands and lookup_pyramid,
                terminate_s, backend_s, K3's calls by edges (the
                backend's 256-edge chunks) and the peak memory, and
                trace_track at 376x1248 in a process of its
                own (kernel ms, kernels, GFLOP and MFU a replayed frame).
 12c. terminate_wide - the damped solve's grid kernel on its path:
                bench_terminate's system tracks WIDE100_KF (100) frames
                of its stream at 376x1248 (every frame a keyframe, the
                planner engaged), then terminate(iter(frames)) with
                every launch counted from 0. Held: the backend's solves
                (P = 99) on dba_solve_grid, launched at least once, the
                four other DBA kernels too, the trajectory finite, at
                least 90 keyframes kept. Printed: the keyframes,
                tracking and terminate seconds, the backend's edges a
                call and the DBA kernels' launches ("launches" of the
                dba_solve_grid row in the kernels line).
 13. demo     - the image-directory demo (scripts/demo.py) as a user
                runs it, a subprocess: DEMO_FRAMES (32) frames of the
                synthetic scene
                at 375x1242 as PNGs with a calib.txt (240x800 after the
                demo's resize), the loop's tamed weights saved under the
                reference key names and passed with --weights, --stride
                1 --vis --live; the viewer's page and state.json fetched
                while it holds, then its standard input closed. Held:
                one finite pose a frame, a non-empty cloud, state.json's
                counter equal to the keyframes, K1, K2, the f32 K3 and
                the segment sum launched ("launches_demo" in the kernels
                line: the demo's own counts); the same frames tracked in
                this process, and consistent_points on the card against
                the CPU on a copy of the video's buffers (masks >= 99.9%
                equal, points within 1e-4 where both keep a pixel).
                Printed: frames/s, terminate s, the cloud's points,
                LiveViewer.update's ms;
 14. dp       - data-parallel training (parallel/data_parallel.py,
                vps/train.py make_full_train_step_dp). (a) NCCL at world
                size 1: the VO recipe (semisup, 15 iterations, 6 frames,
                200x400, restart loop, remat) and the VPS full step (R-50,
                384x1248, 8 GT instances) through the data-parallel steps
                and through the one-card steps, the same weights and
                batches, two optimizer steps, under cuDNN's and
                PyTorch's deterministic switches, the one-card run
                repeated: the data-parallel run within DP_FLOOR_FACTOR
                times the card's own run-to-run difference; (b) two gloo
                ranks on the one card at the default protocol's size
                (48x64, F=4, tamed weights), global batch 2, against one
                process on the same two samples, both under the
                deterministic switches: the ranks bit-equal, the first
                step's applied (summed, unclipped) gradient within 1e-6
                relative L2 of one process's in every tensor (a mean
                where a sum belongs, or a sum taken twice, is 0.5 or 1
                apart), at least DP_EQUAL of the parameters within 1e-6
                and all within 1e-3 after two steps. Printed: s/step of
                each run
                ("launches_dp" in the kernels line: this process's and
                the ranks').
 15. tools    - the developer and analysis CLIs (pvo_tpu_torch/scripts:
                analyze_model, bench_corr, bench_dba, bench_step_parts,
                bench_filler, profile_vo, profile_track,
                profile_terminate, trace_track, trace_vo2, trace_vps,
                profile_vps, profile_vps_pipeline), each through its
                main() in this process on the card (trace_track as a
                process of its own, as a user starts it: see TOOLS_CUTS)
                at the JAX scripts' widths (240x808, 376x1248, 384x1248),
                depth cut as TOOLS_CUTS says (printed in the phase's log
                line). Held:
                bench_corr's K3 within 1e-4 and P1 within 2e-2 + 8e-3
                |ref| with >= 99.9% bit-equal of their plain versions
                before they are timed; trace_track's K1/K2/K3 and
                segment-sum launches in the trace of its replayed frames
                equal to FrameGraph.per_replay's; its planner frame's
                FLOP count on the card equal to the same frame
                program's on the CPU at 64x96 (the same sections run),
                and its MFU in (0, 1]; analyze_model's parameter counts
                on the card equal to the CPU's; every number each CLI
                returns finite. ("launches_tools" in the kernels line.)
After each phase its seconds and its cut of depth (DEPTH_CUTS: a
phase's frames, steps or reps, nothing of its widths or checks). Then
the whole run's seconds with each phase's, one JSON line of kernel
results (the
segment sum's and the DBA kernels' rows too), the card's name and power
limit, and the
contract line {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import gc
import glob
import importlib
import io
import json
import math
import os
import os.path as osp
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pvo_tpu_torch.data.synth_scene import write_synth_scene
from pvo_tpu_torch.parallel import data_parallel as dp
from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.geom.depth_filter import depth_consistency_count
from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.scripts import (analyze_model, bench_corr, bench_dba,
                                   bench_filler, bench_step_parts,
                                   bench_terminate,
                                   bench_train_vo, bench_train_vps,
                                   bench_vo2_export, bench_vps_train, demo,
                                   fault_probe, kbench, prepare_vkitti,
                                   profile_terminate, profile_track,
                                   profile_vo, profile_vps,
                                   profile_vps_pipeline, run_pvo_loop,
                                   dba_probe, segsum_probe, trace_track,
                                   trace_vo2,
                                   trace_vps, train_vo)
from pvo_tpu_torch.scripts.bench_track import (RANGE_PREFIXES, api_calls,
                                               bench_system, corr_rows,
                                               kernel_rows, profiled,
                                               synth_stream, tame_net,
                                               vo_counters)
from pvo_tpu_torch.scripts.benchmark_vps import tamed_model, timed_pass
from pvo_tpu_torch.scripts.harness import harness_inputs
from pvo_tpu_torch.scripts.kbench import (device_time_ms, gpu_line,
                                          kernel_bound)
from pvo_tpu_torch.scripts.test_vo2 import export_pair
from pvo_tpu_torch.utils.config import VOConfig
from pvo_tpu_torch.utils.tracing import range_device_ms
from pvo_tpu_torch.vo import factor_graph, graph_capture
from pvo_tpu_torch.vo import planner as planner_mod
from pvo_tpu_torch.vo.factor_graph import FactorGraph
from pvo_tpu_torch.vo.net import corr as corr_plain
from pvo_tpu_torch.vo.net import cuda_corr
from pvo_tpu_torch.vo.net import cuda_corr_exp
from pvo_tpu_torch.vo.net import cuda_dba
from pvo_tpu_torch.vo.net import cuda_segsum
from pvo_tpu_torch.vo.net.droidnet import DroidNet
from pvo_tpu_torch.utils.io import VKITTI_INTRINSICS
from pvo_tpu_torch.vo.system import VOSystem
from pvo_tpu_torch.vo.video import DepthVideo
from pvo_tpu_torch.vo.visualization import consistent_points
from pvo_tpu_torch.vps import panoptic_fpn as pfpn
from pvo_tpu_torch.vps import train as vps_train_mod

C = 128
TOL = {"build_volumes": 2e-2, "corr_extract": 2e-2, "corr_lookup": 1e-4}
# K1 forms the plain version's products in another f32 summation order
K1_EQUAL = 0.999
# the forward with the kernels against the forward with their plain
# versions, max |d| of the 1/8-res flow (pixels) and of the upsampled
# disparity after 3 iterations. On the wide route K3 differs from plain
# by f32 summation order (1e-4 on the correlation); on the narrow route
# both sides read a bf16 volume and K1 differs from plain by one bf16 ulp
# in under 0.01% of its entries
EXPORT_TOL = 1e-3
EXPORT_SIZE, EXPORT_NARROW, EXPORT_ITERS, EXPORT_PAIRS = \
    (376, 1248), (240, 808), 15, 5
EXPORT_NARROW_PAIRS = 3
# packed bf16 outputs: |d| <= 2e-2 + 8e-3 |ref|, one bf16 ulp above K1/K2,
# and at least PACKED_EQUAL of them bit-equal: the tolerance alone
# cannot tell one rounding variant from another, which differ by one
# bf16 ulp in PACKED_DISTINCT or more of the outputs (17-30% at 30x101)
PACKED_TOL = (2e-2, 8e-3)
PACKED_EQUAL = 0.999
PACKED_DISTINCT = 0.01
REPLACES = {
    "build_volumes": "pvo_tpu/vo/net/pallas_corr.py:412",
    "corr_extract": "pvo_tpu/vo/net/pallas_corr.py:544",
    "corr_lookup": "pvo_tpu/vo/net/pallas_corr.py:611",
}
# the main path's shape for each kernel's headline time: the frontend's
# steady state (48 edges) for K1/K2, the backend's chunk for K3 (bf16
# features, smooth coordinates, the indexed entry)
HEADLINE = {"build_volumes": (48, 30, 101), "corr_extract": (48, 30, 101),
            "corr_lookup": (256, 30, 101),
            # the f32 kernels: the export's narrow route and its step
            "build_volumes_f32": (2, 30, 101), "corr_lookup_f32": (2, 47, 156)}
# the result rows of K1's and K3's f32 kernels (three TF32 passes)
F32_ROWS = {"build_volumes": "build_volumes_f32",
            "corr_lookup": "corr_lookup_f32"}
# K3's checks: (E, H, W) and the coordinates of kbench.lookup_coords
K3_SHAPES = ((1, 30, 101), (48, 30, 101), (256, 30, 101), (2, 47, 156),
             (256, 47, 156), (2, 128, 40))
# the plain K3's f32 volumes (every level's) at most this many bytes at
# once: beyond it (the backend's 256-edge chunk at 47x156 would take
# 73 GB) it runs on slices of the edges (lookup_plain)
PLAIN_VOLUME_BYTES = 16 << 30
# the harness shapes of P1 (X1) and P2 (X2-X5), for their bounds
HARNESS_E = {"corr_lookup_packed": 64, "corr_extract_packed": 32}
# the corr experiment harnesses: TPU kernel -> (harness module, kernel,
# pallas_call site); the JSON line reports each harness's first case
HARNESS = {
    "X1": ("corr_exp", "corr_lookup_packed", "scripts/corr_exp.py:172"),
    "X2": ("corr_exp2", "corr_extract_packed", "scripts/corr_exp2.py:116"),
    "X3": ("corr_exp3", "corr_extract_packed", "scripts/corr_exp3.py:118"),
    "X4": ("corr_exp4", "corr_extract_packed", "scripts/corr_exp4.py:112"),
    "X5": ("corr_exp5", "corr_extract_packed", "scripts/corr_exp5.py:125"),
}
# P2's output-defining variants (X2's rounding, X3's modes) and the X
# kernels each one stands for
# the segment sum's checks: segsum_probe.CASES (the planner frame's sums
# at 240x808) in both modes and segsum_probe.GROUPS (the tracker's
# launches of them), kernel times over SEGSUM_REPS calls in a CUDA graph
SEGSUM_REPS = 20
# a replayed planner frame's segment-sum launches: GraphAgg's one a
# update and the DBA's two a full iteration, 6 updates x 2 iterations
PLANNER_SEGSUMS = 6 + 6 * 2 * 2
# and its DBA kernels' launches: one each an iteration, 6 updates x 2
# iterations
PLANNER_DBA = {"dba_linearize": 12, "dba_schur": 12, "dba_backsub": 12,
               "dba_solve": 12}
# the DBA kernels' checks (dba_probe.SHAPES), those timed and their reps
# (dba_probe alone times them at every shape): the planner's, and the
# wide stream's planner and backend calls at 40 and 100 keyframes; the
# solve is also timed at bench_dba's, the filler's P=16, P = 48 and 49
# (the one block's last, the grid's first), the backend's P=99 and
# P = 511
DBA_TIMED, DBA_REPS = ("planner", "planner_wide", "backend40_wide",
                       "backend_wide"), 20
# the timed shapes whose calls are timed with the L2 cleared before each
# (kbench.graph_time_ms's flush): planner_wide's 35 MB of a call fit the
# 50 MB L2, so back to back its kernels read it from there and beat the
# bound from the memory's rate (backsub at 105-110% of it)
DBA_COLD = ("planner_wide",)
DBA_SOLVE_TIMED = ("planner", "bench_dba", "filler", "solve_max",
                   "multi_49", "backend", "backend_wide", "buffer")
# the shape whose times the kernels line gives each DBA row: the
# planner's, and for the grid solve the wide backend call's P = 99
DBA_ROW_SHAPE = {cuda_dba.GRID: "backend_wide"}
# the TPU-side code each DBA kernel stands in for
DBA_REPLACES = dict.fromkeys(
    ("dba_solve", cuda_dba.GRID),
    "none: XLA's cholesky and solve_triangular in "
    "pvo_tpu/geom/chol.py:21-32, called at pvo_tpu/vo/dba.py:247")
# phase 12: the planner's runs (bench_track's system at 240x808), the
# frames tracked, the first of the timed steady ones (past the engage at
# 13, two eager frames and the capture) and the profiled ones after them
PLANNER_SIZE, PLANNER_FRAMES, PLANNER_STEADY, PLANNER_PROF = \
    (240, 808), 28, 20, 2
# planner_wide: the same runs at 376x1248 (47x156 features: the card's
# "indexed" route, K3 on every update step), with as many frames tracked
# before the timed steady ones (the engage at 13, two eager frames, the
# capture at 16) and as many timed (8)
WIDE_SIZE, WIDE_FRAMES, WIDE_STEADY, WIDE_PROF = (376, 1248), 26, 18, 2
# the second wide stream, which removes keyframes: its frames, the first
# timed one and the keyframe threshold. Under the oracle core
# neighbouring frames lie 4.32 apart at this size (frame_distance at the
# oracle's poses and unit disparity; 8.65 two apart), so above that the
# newest keyframe goes on every update
WIDE_RM_FRAMES, WIDE_RM_STEADY, WIDE_KF_THRESH = 18, 16, 6.0
# phase 12c: the keyframes of the wide terminate whose backend takes the
# grid solve (P = 99, bench_terminate's protocol)
WIDE100_KF = 100
# the frames the terminated wide run has seen: it tracks on after its
# 28 (re-engaging the planner's graph) so that the backend holds more than
# its 256-edge chunk and takes K3 on chunks (at 240x808, 40 frames gave
# 344-376 edges)
WIDE_TERM_FRAMES = 40
# phase 5's split of terminate: the ranges read, and those that must
# hold kernels
TAIL_RANGES = ("vo.backend.", "vo.filler.")
TAIL_LAYERS = ("vo.backend.update", "vo.backend.dba", "vo.filler.fnet",
               "vo.filler.update", "vo.filler.dba")
# the visualizer's disparity tolerance (pvo_tpu/vo/visualization.py)
DEPTH_FILTER_THRESH = 0.005
# phase 9: the loop's scene (frames, views) and iterations; the rows of
# the corr kernels whose launches it counts
# frames: the backend takes K3 (bf16) only beyond 256 edges, and on this
# scene it adds about 4 edges a frame (a keyframe's neighbours; 252-294
# over six runs of 64 frames), so 72 frames
LOOP_FRAMES, LOOP_ITERS = 72, 2
LOOP_VIEWS = ("clone", "15-deg-left")
# the threads that render the scene's frames
LOOP_WORKERS = 8
LOOP_ROWS = ("build_volumes", "corr_extract", "corr_lookup",
             "build_volumes_f32", "corr_lookup_f32")
# the loop's VO weights: tame_net's scale of the flow and mask heads and
# its mask bias, so that test_vo at VOConfig's thresholds (the JAX
# driver passes none) admits and removes keyframes and stays finite
LOOP_HEAD_SCALE, LOOP_MASK_BIAS = 0.2, -2.0
# phase 10: the card's training pass against the CPU's (loss relative,
# gradient relative L2 a tensor, cuDNN on and off), the default
# protocol's steps, the recipe's outer steps
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-4, 5e-4
TRAIN_DEFAULT_STEPS, TRAIN_RECIPE_STEPS = 20, 2
# phase 11: the card's VPS training loss and gradients against the CPU's
# (relative; relative L2 a tensor: cuDNN's f32 convolution gradients,
# 3e-7-8e-6 relative an op, put the R-50's 5.1e-5 from the CPU's at
# worst, fault_probe b4ops and vps), and the full bench's steps
VPS_LOSS_TOL, VPS_GRAD_TOL = 1e-4, 2e-4
VPS_FULL_STEPS = 20
# phase 13: the demo's scene (frames at 375x1242, resized by the demo to
# 240x800) and weights (the loop's: at VOConfig's thresholds the motion
# filter admits frames, and the tracker stays finite); the visualizer's
# card-against-CPU check: the share of mask entries that must agree and
# the points' bound where both keep a pixel
DEMO_FRAMES, DEMO_MASK_EQUAL, DEMO_POINT_TOL = 32, 0.999, 1e-4
# the kernels the demo's narrow stream (30x100 features) must launch:
# K1 once a keyframe, K2 every iteration, the f32 K3 in the probe, the
# segment sum
DEMO_ROWS = ("build_volumes", "corr_extract", "corr_lookup_f32", "segsum",
             *cuda_dba.KERNELS)
# phase 14: the recipe's scene frames, the optimizer steps compared, and
# the two gloo ranks' bounds against one process: the first step's
# applied gradient within DP_GRAD_TOL relative L2 in every tensor (the
# norm floored at 1e-4 of the whole gradient's, as the CPU test holds
# it), and after two steps at least DP_EQUAL of the parameters within
# 1e-6, all within DP_TOL (twice the peak learning rate: Adam moves an
# entry by about the learning rate whatever its gradient, so an entry
# whose gradient is near zero can move either way)
DP_SCENE_FRAMES, DP_STEPS, DP_EQUAL, DP_TOL = 12, 2, 0.999, 1e-3
DP_GRAD_TOL = 1e-6
# phase 14 (a): with cuDNN's and PyTorch's deterministic switches off,
# two one-card runs part by 1.5e-8 in the VPS step and by 5.6e-4 after
# two Adam steps of the recipe; with them on, both repeat themselves bit
# for bit. The data-parallel run must be within DP_FLOOR_FACTOR times the
# card's own run-to-run difference: bit-equal where the card repeats
# itself
DP_FLOOR_FACTOR = 4
# phase 15: each CLI's arguments (the JAX scripts' widths, depth cut to
# keep the phase near 90 s). trace_track runs as a process of its own,
# as a user starts it: after earlier work in a process (profile_terminate,
# or phases 13-14) the profiler names a replayed frame's kernels wrongly
# there (a K1, a K2 and 7-19 segment sums a frame more than the graph
# holds, with the kernel total and the poses equal to the eager
# program's; PERF.md section 7), with 20 warm frames (the capture at 16)
# where its own protocol takes 42. Its card-against-CPU FLOP check, which
# traces nothing, runs in this process: 64x96, 14 warm frames (the
# engage at 13), the count frame next
TOOLS_TRACE_ARGV = ["2", "--warm", "20"]
TOOLS_CUTS = {
    "analyze_model": [],
    "bench_corr": [],
    "bench_dba": [],
    "bench_step_parts": [],
    "bench_filler": ["24", "1"],
    "profile_vo": [],
    "profile_track": ["--frames", "20", "4"],
    "profile_terminate": ["30"],
    "trace_vo2": ["3"],
    "trace_vps": [],
    "profile_vps": ["--reps", "4"],
    "profile_vps_pipeline": ["--frames", "4"],
}
TOOLS_FLOP_HW, TOOLS_FLOP_WARM = (64, 96), 14
# planner_wide's trace_track: two traced replays at 376x1248 after 20
# warm frames (the capture at 16), a process of its own
WIDE_TRACE_ARGV = ["2", "--warm", "20", "--image_size", "376", "1248"]
# the depths cut to keep the whole run under 800 s (each phase's seconds
# are printed beside its cut): widths, checks and paths are as before
DEPTH_CUTS = {
    "kernels": "the DBA kernels timed at the planner's shape alone, "
               "not also at bench_dba's",
    "planner": "frames 40 -> 28 (8 timed steady frames, 20..27)",
    "planner_wide": "frames 40 -> 26 (8 timed steady frames, 18..25), "
                    "trace_track 5 -> 2 traced frames",
    "vps": "timed frames a mode 20 -> 5",
    "train": "default protocol steps 200 -> 20, recipe outer steps 10 -> 2",
    "tools": "trace_track 5 -> 2 traced frames, profile_track 10 -> 4 "
             "timed frames, profile_terminate 40 -> 30 and bench_filler "
             "40 -> 24 keyframes",
    "vps_train": "full-model steps 60 -> 20",
    "demo": "scene frames 72 -> 32",
}
P2_VARIANTS = (
    (dict(), ("X2", "X3", "X4", "X5")),
    (dict(weights="bf16"), ("X2",)),
    (dict(weights="round", round_mid=True), ("X2",)),
    (dict(weights="bf16", round_mid=True), ("X2",)),
    (dict(mode="nostore"), ("X3",)),
    (dict(mode="novab"), ("X3",)),
    (dict(mode="dma"), ("X3",)),
)


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def kernel_inputs(E, H, W, dtype, seed, band=None, width=C):
    """Seeded features and coords; ``band`` = (axis, lo, hi) sends half
    the pixels' coords into a band straddling a border."""
    rng = np.random.RandomState(seed)
    f1 = torch.tensor(rng.randn(E, H, W, width), dtype=torch.float32)
    f2 = torch.tensor(rng.randn(E, H, W, width), dtype=torch.float32)
    cx = rng.uniform(-2.0, W + 1.0, (E, H, W))
    cy = rng.uniform(-2.0, H + 1.0, (E, H, W))
    if band is not None:
        axis, lo, hi = band
        c = cx if axis == "x" else cy
        c[:, H // 2:] = rng.uniform(lo, hi, c[:, H // 2:].shape)
    coords = torch.tensor(np.stack([cx, cy], -1), dtype=torch.float32)
    dev = torch.device("cuda")
    return f1.to(dev, dtype), f2.to(dev, dtype), coords.to(dev)


def check_kernels():
    """Phase 3, K1-K3: returns {row: {"err": worst error, "ms",
    "plain_ms", "bound_ms", "bound_by", "library_ms"}}, the times at the
    row's HEADLINE shape; a row is a kernel, or its f32 kernel
    (F32_ROWS)."""
    res = {k: {"err": 0.0, "library_ms": None}
           for k in (*cuda_corr.KERNELS, *F32_ROWS.values())}

    def record(name, shape, err, fn, plain_fn, plain_reps=10, headline=None,
               library_fn=None, sector_coords=None, **note):
        row = F32_ROWS[name] if note.get("features") == "f32" else name
        ms = device_time_ms(fn)
        plain_ms = device_time_ms(plain_fn, reps=plain_reps)
        bound = kernel_bound(name, *shape, C, features=note.get("features",
                                                                "bf16"),
                             coords=sector_coords)
        times = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound["ms"],
                 "bound_by": bound["bound_by"]}
        if "sector_ms" in bound:
            # the same bound with the taps counted in whole 32-byte sectors
            note = {**note, "sectors_per_pixel":
                    f"{bound['sectors'] / np.prod(shape):.2f}",
                    "sector_bound_ms": f"{bound['sector_ms']:.4f}",
                    "share_of_sector_bound": f"{bound['sector_ms'] / ms:.4f}"}
        if library_fn is not None:
            times["library_ms"] = device_time_ms(library_fn)
        log("kernel", name=name, shape="x".join(map(str, shape)), **note,
            max_abs_err=f"{err:.3g}", tol=TOL[name],
            share_of_bound=f"{bound['ms'] / ms:.4f}",
            **{k: v if isinstance(v, str) else f"{v:.4f}"
               for k, v in times.items()})
        if not err <= TOL[name]:
            raise AssertionError(f"{name} at {shape}: error {err} > "
                                 f"{TOL[name]}")
        r = res[row]
        r["err"] = max(r["err"], err)
        if shape == HEADLINE[row] if headline is None else headline:
            r.update(times)

    # bf16 features pool to a bf16-rounded pyramid, level by level
    f1, f2, _ = kernel_inputs(2, 30, 101, torch.bfloat16, seed=0)
    pyr = cuda_corr.pool_pyramid(f2)
    if not torch.equal(pyr, pyr.bfloat16().float()):
        raise AssertionError("bf16 pyramid levels are not bf16 values")
    log("kernel", name="pool_pyramid", shape="2x30x101",
        bf16_levels_rounded=True)

    shape = (3, 17, 45)
    f1, f2, _ = kernel_inputs(*shape, torch.bfloat16, seed=sum(shape))
    res["build_volumes"]["err"] = max(
        res["build_volumes"]["err"],
        check_volume(shape, torch.bfloat16, cuda_corr.build_volumes(f1, f2),
                     cuda_corr.build_volumes_plain(f1, f2)))

    # K1 on f32 features (three TF32 passes), beside one library product
    # of the same f32 operands
    for shape in ((2, 30, 101), (3, 17, 45)):
        f1, f2, _ = kernel_inputs(*shape, torch.float32, seed=sum(shape))
        vol = cuda_corr.build_volumes(f1, f2)
        pyr = cuda_corr.pool_pyramid(f2)
        a = f1.reshape(shape[0], -1, C) * cuda_corr.SCALE
        b = torch.nn.functional.pad(
            pyr, (0, 0, 0, vol.shape[-1] - pyr.shape[1])).transpose(1, 2)
        record("build_volumes", shape,
               check_volume(shape, torch.float32, vol,
                            cuda_corr.build_volumes_plain(f1, f2)),
               lambda: cuda_corr.build_volumes_pooled(f1, pyr),
               lambda: cuda_corr.build_volumes_plain(f1, f2),
               library_fn=lambda: torch.bmm(a, b), features="f32",
               entry="pooled")
        del vol, pyr, a, b

    # K2 must give the bits of the one-warp, 2-byte-load kernel it replaced
    vol, coords = (t.cuda() for t in kbench.saved_extract_case())
    same = kbench.fingerprint(cuda_corr.corr_extract(vol, coords)) == \
        kbench.SAVED_EXTRACT_SHA256
    log("kernel", name="corr_extract", shape="x".join(map(str, coords.shape)),
        equal_to_replaced_kernel=same)
    if not same:
        raise AssertionError("corr_extract: output differs from the "
                             "replaced kernel's on the saved case")

    for E in (1, 24, 48):
        shape = (E, 30, 101)
        f1, f2, coords = kernel_inputs(*shape, torch.bfloat16, seed=E)
        vol = cuda_corr.build_volumes(f1, f2)
        ref = cuda_corr.build_volumes_plain(f1, f2)
        # the yardstick: one library product of the same bf16 operands
        pyr = cuda_corr.pool_pyramid(f2, dtype=torch.bfloat16)
        a = (f1.reshape(E, -1, C).float() * cuda_corr.SCALE).bfloat16()
        b = torch.nn.functional.pad(
            pyr, (0, 0, 0, vol.shape[-1] - pyr.shape[1])).transpose(1, 2)
        record("build_volumes", shape,
               check_volume(shape, torch.bfloat16, vol, ref),
               lambda: cuda_corr.build_volumes(f1, f2),
               lambda: cuda_corr.build_volumes_plain(f1, f2),
               library_fn=lambda: torch.bmm(a, b))
        ms = device_time_ms(lambda: cuda_corr.build_volumes_pooled(f1, pyr))
        bound = kernel_bound("build_volumes", *shape, C)["ms"]
        log("kernel", name="build_volumes", shape="x".join(map(str, shape)),
            kernel_only_ms=f"{ms:.4f}", bound_ms=f"{bound:.4f}",
            share_of_bound=f"{bound / ms:.4f}")
        del pyr, a, b
        out = cuda_corr.corr_extract(ref, coords)
        err = (out - cuda_corr.corr_extract_plain(ref, coords)).abs().max()
        record("corr_extract", shape, err.item(),
               lambda: cuda_corr.corr_extract(ref, coords),
               lambda: cuda_corr.corr_extract_plain(ref, coords),
               sector_coords=coords.cpu().numpy())
        del vol, ref, out
        torch.cuda.empty_cache()

    for shape in K3_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            check_lookup(shape, dtype, record)
    check_lookup_f32_corners()

    # K3 through the gathered entry (pooling included) on uniform random
    # coordinates with border bands, for f32 features too: the shapes of
    # the kernel table in PERF.md, on kernel_inputs' seeds
    for shape, band, dtype in (
            ((1, 30, 101), None, torch.float32),
            ((24, 30, 101), None, torch.bfloat16),
            ((48, 30, 101), None, torch.bfloat16),
            ((256, 30, 101), None, torch.bfloat16),
            ((1, 47, 156), ("x", 150.0, 160.0), torch.float32),
            ((1, 128, 40), ("y", 122.0, 131.0), torch.float32)):
        f1, f2, coords = kernel_inputs(*shape, dtype, seed=sum(shape),
                                       band=band)
        err = kbench.lookup_err(cuda_corr.corr_lookup(f1, f2, coords),
                                cuda_corr.corr_lookup_plain(f1, f2, coords))
        record("corr_lookup", shape, err,
               lambda: cuda_corr.corr_lookup(f1, f2, coords),
               lambda: cuda_corr.corr_lookup_plain(f1, f2, coords),
               plain_reps=3, headline=False, coords="uniform",
               features="bf16" if dtype == torch.bfloat16 else "f32",
               entry="gathered")
        torch.cuda.empty_cache()
    res["segsum"] = check_segsum()
    res.update(check_dba())
    return res


def check_dba():
    """Phase 3, the DBA's kernels (csrc/dba.cu): at each of
    dba_probe.SHAPES (the planner's full regime at 30x101, E=144, K=P=32,
    2048 pair slots, and at 47x156, planner_wide, also timed; bench_dba's
    E=48; 47x156; 128x40; one edge; the
    planner's shape motion-only; odd_hw, E=48 at 47x155; backend, the
    backend's recorded call at 100 keyframes, E=1008 over K=100 frames;
    backend40 and backend40_wide, its calls at 40 keyframes at 240x808
    and 376x1248; backend_wide, its call at 100 keyframes of a 376x1248
    stream; crowded, E=958 over 32 frames; filler; solve_max, multi_49
    and buffer, P = K = 48, 49 and 511)
    each kernel within dba_probe.TOL of its plain version relative to
    the output's largest magnitude, bit-equal
    twice, a CUDA-graph replay equal to the eager call; dba.dba's poses
    and disparities after 2 iterations within its limit of the plain
    versions' (dba_probe.failures). At DBA_TIMED the kernel times (a
    CUDA graph of DBA_REPS calls, kernel and plain in turns; at DBA_COLD
    with the L2 cleared before each call) beside the bound and, for the
    Schur terms, one torch.bmm of every depth frame's weighted Gram on
    operands stacked outside the timed call.
    Returns the rows' numbers at DBA_ROW_SHAPE (the planner's) with the
    worst error of all."""
    rows = {k: {"err": 0.0} for k in (*cuda_dba.KERNELS, cuda_dba.GRID)}
    for name in dba_probe.SHAPES:
        res = dba_probe.check(
            name, DBA_REPS if name in DBA_TIMED else 0,
            solve_reps=DBA_REPS if name in DBA_SOLVE_TIMED else 0,
            cold=name in DBA_COLD)
        l2 = {"l2": "cleared"} if name in DBA_COLD else {}
        for k, r in res.items():
            if k == "dba_solve":
                check_solve_row(name, r, rows[r["kernel"]], l2)
                continue
            if k == "dba":
                log("kernel", name="dba", shape=name,
                    poses_absrel=f"{r['poses']:.3g}",
                    disps_absrel=f"{r['disps']:.3g}",
                    plain_card_against_cpu=f"{r['plain_card_cpu']:.3g}",
                    limit=f"{r['limit']:.3g}", bit_stable=r["bit_stable"])
                continue
            times = {t: (f"{r[t]:.4f}" if isinstance(r[t], float) else
                         "/".join(f"{v:.4f}" for v in r[t]))
                     for t in ("ms", "plain_ms", "bound_ms", "library_ms")
                     if r.get(t) is not None}
            share = ({"share_of_bound": f"{r['bound_ms'] / min(r['ms']):.4f}",
                      "bound_by": r["bound_by"]} if "ms" in r else {})
            if "pose_err" in r:
                share.update(pose_absrel=f"{r['pose_err']:.3g}",
                             pose_tol=dba_probe.POSE_TOL)
            log("kernel", name=k, shape=name, max_rel_err=f"{r['err']:.3g}",
                tol=dba_probe.TOL, bit_stable=r["bit_stable"],
                graph_equals_eager=r["graph_equal"], **times, **share,
                **(l2 if "ms" in r else {}))
            rows[k]["err"] = max(rows[k]["err"], r["err"])
            if name == "planner":
                rows[k].update(ms=min(r["ms"]), plain_ms=r["plain_ms"],
                               bound_ms=r["bound_ms"],
                               bound_by=r["bound_by"],
                               library_ms=r["library_ms"])
        bad = dba_probe.failures(res)
        if bad:
            raise AssertionError(f"DBA kernels at {name}: {bad}")
    return rows


def check_solve_row(name, r, row, l2):
    """Phase 3, the damped solve at dba_probe shape ``name``
    (dba_probe.check_solve's ``r``; its times, where it has them, taken
    as ``l2`` says): its line, and into ``row`` (its kernel's) the worst
    error and, at the kernel's DBA_ROW_SHAPE, the times."""
    times = {t: (f"{r[t]:.4f}" if isinstance(r[t], float) else
                 "/".join(f"{v:.4f}" for v in r[t]))
             for t in ("ms", "plain_ms", "bound_ms", "library_ms",
                       "grid_ms") if t in r}
    if "ms" in r:
        times.update(share_of_bound=f"{r['bound_ms'] / min(r['ms']):.5f}",
                     bound_by=r["bound_by"])
    log("kernel", name=r["kernel"], shape=name,
        max_rel_err=f"{r['err']:.3g}", limit=f"{r['limit']:.3g}",
        plain_card_against_cpu=f"{r['plain_card_cpu']:.3g}",
        fwd_err_f64=f"{r['fwd']:.3g}",
        plain_fwd_err_f64=f"{r['fwd_plain']:.3g}",
        eta_f64=f"{r['eta']:.3g}", plain_eta_f64=f"{r['eta_plain']:.3g}",
        eta_floor=dba_probe.SOLVE_ETA_FLOOR,
        bit_stable=r["bit_stable"], graph_equals_eager=r["graph_equal"],
        emulation_bit_equal=r["emulation_equal"],
        **({"grid_bit_equal_one_block": r["grid_equal"]}
           if "grid_equal" in r else {}),
        **times, **(l2 if "ms" in r else {}))
    row["err"] = max(row["err"], r["err"])
    if name == DBA_ROW_SHAPE.get(r["kernel"], "planner"):
        row.update(ms=min(r["ms"]), plain_ms=r["plain_ms"],
                   bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                   library_ms=r["library_ms"])


def check_segsum():
    """Phase 3, the segment sum (csrc/segsum.cu, B5): each case of
    segsum_probe.CASES (the planner frame's sums at 240x808, about a
    tenth of each case's rows out of range) in both modes, accumulate and
    zero start, and the tracker's launches of them (segsum_probe.GROUPS,
    one batched launch each, zero start): bit for bit against the CPU's
    index_add_, the kernel's ms (SEGSUM_REPS calls in a CUDA graph)
    beside the plain version on the card (an overflow row and the card's
    index_add_), the card's index_add_ alone (the library call, float
    atomics, one call a job) and the bound with its share. Returns the
    kernel row's numbers at GraphAgg's shape (accumulate), with the
    largest |kernel - CPU| of all."""
    row, worst = {}, 0.0
    runs = ([("case", name, (name,), zero) for name in segsum_probe.CASES
             for zero in (False, True)] +
            [("group", group, names, True)
             for group, names in segsum_probe.GROUPS.items()])
    for kind, label, names, zero in runs:
        r = segsum_probe.measure(names, zero, SEGSUM_REPS, plain=True)
        worst = max(worst, r["max_abs_err"])
        ms, bound = min(r["ms"]), r["bound"]
        log("kernel", name="segsum", **{kind: label},
            mode="zero" if zero else "accumulate",
            rows=sum(segsum_probe.CASES[n][0] for n in names),
            bit_equal_cpu=r["bit_equal_cpu"],
            max_abs_err=f"{r['max_abs_err']:.3g}", ms=f"{ms:.4f}",
            plain_ms=f"{r['plain_ms']:.4f}",
            library_ms=f"{r['library_ms']:.4f}",
            bound_ms=f"{bound['ms']:.4f}", bound_by=bound["bound_by"],
            share_of_bound=f"{bound['ms'] / ms:.4f}")
        if not r["bit_equal_cpu"]:
            raise AssertionError(f"segsum {names} zero={zero}: not the "
                                 f"CPU's index_add_")
        if (kind, label, zero) == ("case", "graph_agg", False):
            row = {"ms": ms, "plain_ms": r["plain_ms"],
                   "bound_ms": bound["ms"], "bound_by": bound["bound_by"],
                   "library_ms": r["library_ms"]}
    row["err"] = worst
    return row


def lookup_plain(f1, f2, coords):
    """corr_lookup_plain(f1, f2, coords) on slices of the edges whose
    volumes fit PLAIN_VOLUME_BYTES: an edge's lookup reads its own
    features alone, so the slices give the same values but for the
    order of the volumes' f32 sums."""
    E, H, W, _ = coords.shape
    per_edge = 4 * H * W * sum(
        h * w for h, w in cuda_corr.level_shapes(H, W, 4))
    n = max(1, PLAIN_VOLUME_BYTES // per_edge)
    return torch.cat([cuda_corr.corr_lookup_plain(f1[s:s + n], f2[s:s + n],
                                                  coords[s:s + n])
                      for s in range(0, E, n)])


def check_lookup(shape, dtype, record):
    """K3 at one shape and feature dtype, on every kind of coordinates,
    through both entries. The frames are the edges' own f1, f2 stacked;
    the indexed entry reads them through shuffled edges."""
    E, H, W = shape
    tensor = dtype == torch.bfloat16
    feats = "bf16" if tensor else "f32"
    f1, f2, _ = kernel_inputs(E, H, W, dtype, seed=sum(shape))
    frames = torch.cat([f1, f2])
    pyr = cuda_corr.lookup_pyramid(frames)
    rng = np.random.RandomState(E)
    ii = torch.as_tensor(rng.permutation(E), device="cuda")
    jj = torch.as_tensor(E + rng.permutation(E), device="cuda")
    for kind in kbench.LOOKUP_COORDS:
        coords = torch.from_numpy(
            kbench.lookup_coords(kind, E, H, W, seed=E + H)).cuda()
        cuda_corr.reset_routes()
        out = cuda_corr.corr_lookup(f1, f2, coords)
        routes = cuda_corr.routes()
        err = kbench.lookup_err(out, lookup_plain(f1, f2, coords))
        # the indexed entry: against its plain version, or (E=256, where
        # that costs 16 GB of volumes again) against the kernel on the
        # gathered features, which the line above has checked
        idx = cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords)
        if E <= 48:
            idx_ref = cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii,
                                                          jj, coords)
        else:
            idx_ref = cuda_corr.corr_lookup(frames[ii], frames[jj], coords)
        # numpy's max keeps a NaN (a NaN on one side only)
        err = float(np.max([err, kbench.lookup_err(idx, idx_ref)]))
        del out, idx, idx_ref
        if kind == "smooth" and routes[1]:
            raise AssertionError(f"corr_lookup {feats} at {shape}: "
                                 f"{routes[1]} (block, level) pairs off the "
                                 "tensor cores on smooth coordinates")
        if kind == "mixed" and not (routes[0] and routes[1]):
            raise AssertionError(f"corr_lookup {feats} at {shape}: the mixed "
                                 f"case took routes {routes}, not both")
        if kind == "smooth":
            # timed through the indexed entry: the backend's (bf16) and
            # the export step's (f32)
            record("corr_lookup", shape, err,
                   lambda: cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj,
                                                         coords),
                   lambda: lookup_plain(f1, f2, coords),
                   plain_reps=3, features=feats, coords=kind,
                   entry="indexed", tensor_core_pairs=routes[0],
                   per_pixel_pairs=routes[1])
        else:
            log("kernel", name="corr_lookup",
                shape="x".join(map(str, shape)), features=feats, coords=kind,
                max_abs_err=f"{err:.3g}", tol=TOL["corr_lookup"],
                tensor_core_pairs=routes[0], per_pixel_pairs=routes[1])
            if not err <= TOL["corr_lookup"]:
                raise AssertionError(f"corr_lookup {feats} at {shape} on "
                                     f"{kind} coordinates: error {err}")
        torch.cuda.empty_cache()
    if (tensor and E in (48, 256)) or (not tensor and E <= 2):
        # the gathered entry pools its edges' f2 on every call (the
        # motion filter's probe is the f32 one at E=1)
        coords = torch.from_numpy(
            kbench.lookup_coords("smooth", E, H, W, seed=E + H)).cuda()
        ms = device_time_ms(lambda: cuda_corr.corr_lookup(f1, f2, coords))
        log("kernel", name="corr_lookup", shape="x".join(map(str, shape)),
            features=feats, coords="smooth", entry="gathered",
            ms=f"{ms:.4f}")
    if not tensor:
        check_no_gather(frames, pyr, ii, jj, coords)


def check_no_gather(frames, pyr, ii, jj, coords):
    """The indexed entry on f32 features indexes the edges' frames in
    the kernel: one launch, and no allocation but its output (a gather
    of frames or pyramids would allocate)."""
    ii, jj = ii.int().contiguous(), jj.int().contiguous()
    torch.cuda.synchronize()
    cuda_corr.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords)
    peak = torch.cuda.max_memory_allocated() - before
    size = out.numel() * out.element_size()
    log("kernel", name="corr_lookup", shape="x".join(map(str, coords.shape)),
        features="f32", entry="indexed", launches=cuda_corr.LAUNCHES[
            "corr_lookup"], allocated_bytes=peak, output_bytes=size)
    # the allocator hands out a block up to 1 MiB larger than asked; one
    # frame's features are 1.5 MB at 30x101, its pyramid more
    if cuda_corr.F32_LAUNCHES["corr_lookup"] != 1 or peak >= size + 2 ** 20:
        raise AssertionError(f"corr_lookup_indexed on f32 features: "
                             f"{cuda_corr.F32_LAUNCHES} launches, {peak} "
                             f"bytes allocated for an output of {size}")


def check_lookup_f32_corners():
    """K3's f32 kernel off the main path's shape: C=24 for f32 and bf16
    features (bf16 ones whose C is no multiple of 16 take it on an f32
    pyramid), 1 to 4 levels, and features under 8 a side, whose last
    level is pooled away to nothing. Both entries, smooth and mixed
    coordinates, <= 1e-4."""
    cases = [((3, 30, 101), 24, torch.float32, 4),
             ((3, 30, 101), 24, torch.bfloat16, 4),
             ((2, 5, 7), C, torch.float32, 4), ((3, 9, 3), 24,
                                                torch.float32, 4)]
    cases += [((2, 30, 101), C, torch.float32, n) for n in (1, 2, 3)]
    for shape, width, dtype, levels in cases:
        E, H, W = shape
        f1, f2, _ = kernel_inputs(E, H, W, dtype, seed=width + levels,
                                  width=width)
        frames = torch.cat([f1, f2])
        pyr = cuda_corr.lookup_pyramid(frames, levels)
        if pyr.dtype != torch.float32:
            raise AssertionError("not the f32 kernel's pyramid")
        ii = torch.arange(E - 1, -1, -1, device="cuda")
        jj = E + torch.arange(E, device="cuda")
        for kind in ("smooth", "mixed"):
            coords = torch.from_numpy(
                kbench.lookup_coords(kind, E, H, W, seed=levels)).cuda()
            cuda_corr.reset_launches()
            err = max(
                kbench.lookup_err(
                    cuda_corr.corr_lookup(f1, f2, coords, levels),
                    cuda_corr.corr_lookup_plain(f1, f2, coords, levels)),
                kbench.lookup_err(
                    cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj,
                                                  coords, levels),
                    cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii, jj,
                                                        coords, levels)))
            log("kernel", name="corr_lookup", shape="x".join(map(str, shape)),
                features=str(dtype).split(".")[-1], C=width, levels=levels,
                coords=kind, max_abs_err=f"{err:.3g}",
                tol=TOL["corr_lookup"])
            if not err <= TOL["corr_lookup"] or \
                    cuda_corr.F32_LAUNCHES["corr_lookup"] != 2:
                raise AssertionError(f"corr_lookup f32 kernel at {shape}, "
                                     f"C={width}, {levels} levels, {kind}: "
                                     f"error {err}")


def check_volume(shape, dtype, vol, ref):
    """K1's volume against its plain version's: returns max |d|; raises
    beyond TOL, below K1_EQUAL bit-equal, beyond one bf16 ulp anywhere,
    or on a nonzero pad column."""
    E, H, W = shape
    n2 = sum(h * w for h, w in cuda_corr.level_shapes(H, W))
    err, equal, ulp_ok, pad = cuda_corr.volume_agreement(vol, ref, n2)
    log("kernel", name="build_volumes", shape="x".join(map(str, shape)),
        features=str(dtype).split(".")[-1], stride=vol.shape[-1],
        max_abs_err=f"{err:.3g}", bit_equal=f"{equal:.6f}",
        within_one_ulp=ulp_ok, pad_max=pad)
    if not (vol.shape == ref.shape == (E, H * W, cuda_corr.padded_n2(n2))
            and err <= TOL["build_volumes"] and equal >= K1_EQUAL
            and ulp_ok and pad == 0.0):
        raise AssertionError(f"build_volumes {dtype} at {shape}: shape "
                             f"{tuple(vol.shape)}, error {err}, {equal:.6f} "
                             f"bit-equal, within one ulp {ulp_ok}, pad {pad}")
    return err


def packed_err(name, shape, variant, out, ref, equal_share=PACKED_EQUAL,
               **note):
    """Max |out - ref| of two packed bf16 outputs (NaN in both counts as
    equal, in one as a failure); raises beyond PACKED_TOL or below
    ``equal_share`` bit-equal."""
    a, b = out.float(), ref.float()
    both_nan = a.isnan() & b.isnan()
    d = (a - b).abs().masked_fill(both_nan, 0.0)
    bad = int((d > PACKED_TOL[0] + PACKED_TOL[1] * b.abs()).sum())
    equal = ((a == b) | both_nan).float().mean().item()
    err = d.max().item()
    log("kernel", name=name, shape="x".join(map(str, shape)),
        variant=repr(variant), **note, max_abs_err=f"{err:.3g}", bad=bad,
        bit_equal=f"{equal:.6f}")
    if bad or equal < equal_share or not np.isfinite(err):
        raise AssertionError(f"{name} {variant} at {shape}: {bad} outputs "
                             f"beyond tolerance, {equal:.6f} bit-equal, "
                             f"max error {err}")
    return err


def check_distinct(name, shape, variants, outs):
    """Every two variants' kernel outputs differ in at least
    PACKED_DISTINCT of the outputs, so that no variant flag is dead."""
    low = min(((outs[i] != outs[j]).float().mean().item(), i, j)
              for i in range(len(outs)) for j in range(i))
    log("kernel", name=name, shape="x".join(map(str, shape)),
        variants=len(outs), min_share_differing=f"{low[0]:.4f}")
    if low[0] < PACKED_DISTINCT:
        raise AssertionError(f"{name} at {shape}: {variants[low[1]]} and "
                             f"{variants[low[2]]} differ in only "
                             f"{low[0]:.4f} of the outputs")


def check_lookup_packed(shape, coords_kind, f1, f2, coords, variants):
    """P1 in ``variants`` against plain on one set of inputs, its route
    counts against the numpy model's; returns (worst max |d|, outputs)."""
    E, H, W = shape
    want = cuda_corr_exp.expected_routes(coords.cpu().numpy(), H, W)
    worst, outs = 0.0, []
    for kw in variants:
        cuda_corr_exp.reset_routes()
        outs.append(cuda_corr_exp.corr_lookup_packed(f1, f2, coords, **kw))
        routes = cuda_corr_exp.routes()
        worst = max(worst, packed_err(
            "corr_lookup_packed", shape, kw, outs[-1],
            cuda_corr_exp.corr_lookup_packed_plain(f1, f2, coords, **kw),
            coords=coords_kind, pairs_within_cap=routes[0],
            pairs_above_cap=routes[1]))
        # smooth: every box within the cap; uniform and mixed: both kinds
        if routes != want or (coords_kind == "smooth" and routes[1]) or (
                coords_kind in ("uniform", "mixed") and not all(routes)):
            raise AssertionError(f"corr_lookup_packed at {shape} on "
                                 f"{coords_kind} coordinates took routes "
                                 f"{routes}, the model says {want}")
    return worst, outs


def check_packed():
    """Phase 3, P1 and P2 in every output-defining variant against their
    plain versions, at the harness shapes and with half the pixels in a
    band over the right or the bottom border; P1 also on the coordinates
    of kbench.lookup_coords and off the harness's shape. Returns the
    worst error of each X kernel."""
    err = dict.fromkeys(HARNESS, 0.0)
    shapes = [((64, 30, 101), None), ((2, 30, 101), ("x", 95.0, 106.0)),
              ((2, 30, 101), ("y", 25.0, 33.0))]
    p1_variants = [dict(order=o, seldt=s) for o in cuda_corr_exp.ORDERS
                   for s in cuda_corr_exp.SELDT]
    for shape, band in shapes:
        f1, f2, coords = kernel_inputs(*shape, torch.bfloat16, seed=7,
                                       band=band)
        e, outs = check_lookup_packed(shape, "uniform" if band is None
                                      else f"band_{band[0]}", f1, f2, coords,
                                      p1_variants)
        err["X1"] = max(err["X1"], e)
        check_distinct("corr_lookup_packed", shape, p1_variants, outs)
        del f1, f2, coords, outs
        torch.cuda.empty_cache()
    # smooth coordinates (every box within the cap), mixed and NaN/huge
    # ones, a ragged shape, and features under 8 a side (level 3 empty)
    for shape, kind in (((64, 30, 101), "smooth"), ((2, 47, 156), "smooth"),
                        ((2, 30, 101), "mixed"), ((2, 30, 101), "wild"),
                        ((3, 17, 45), "smooth"), ((3, 17, 45), "scattered"),
                        ((2, 5, 7), "smooth"), ((2, 5, 7), "scattered")):
        f1, f2, _ = kernel_inputs(*shape, torch.bfloat16, seed=sum(shape))
        coords = torch.from_numpy(
            kbench.lookup_coords(kind, *shape, seed=shape[1])).cuda()
        e, outs = check_lookup_packed(shape, kind, f1, f2, coords,
                                      p1_variants)
        err["X1"] = max(err["X1"], e)
        del f1, f2, coords, outs
        torch.cuda.empty_cache()

    # P2 must give the bits of the 2-byte-load kernel it replaced
    vol, coords = (t.cuda() for t in kbench.saved_extract_case())
    same = kbench.fingerprint(cuda_corr_exp.corr_extract_packed(
        vol, coords)) == kbench.SAVED_EXTRACT_PACKED_SHA256
    log("kernel", name="corr_extract_packed",
        shape="x".join(map(str, coords.shape)), equal_to_replaced_kernel=same)
    if not same:
        raise AssertionError("corr_extract_packed: output differs from the "
                             "replaced kernel's on the saved case")

    shapes[0] = ((32, 30, 101), None)
    for shape, band in shapes:
        f1, f2, coords = kernel_inputs(*shape, torch.bfloat16, seed=8,
                                       band=band)
        vol = cuda_corr.build_volumes(f1, f2)
        outs = []
        for kw, owners in P2_VARIANTS:
            outs.append(cuda_corr_exp.corr_extract_packed(vol, coords, **kw))
            e = packed_err(
                "corr_extract_packed", shape, kw, outs[-1],
                cuda_corr_exp.corr_extract_packed_plain(vol, coords, **kw),
                equal_share=1.0)
            for x in owners:
                err[x] = max(err[x], e)
        check_distinct("corr_extract_packed", shape,
                       [kw for kw, _ in P2_VARIANTS], outs)
        del f1, f2, coords, vol, outs
        torch.cuda.empty_cache()
    return err


class EventTimer:
    """CUDA-event pairs around every call of the functions it wraps."""

    def __init__(self):
        self.calls = []

    def wrap(self, fn, key=lambda *a, **kw: None):
        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.calls.append((key(*a, **kw), start, end))
            return out
        return timed

    def ms(self):
        """[(key, device ms)] of the calls so far, in call order."""
        torch.cuda.synchronize()
        return [(k, s.elapsed_time(e)) for k, s, e in self.calls]


@contextlib.contextmanager
def patched(obj, name, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def plain_kernels():
    """Swap each kernel wrapper (K3's indexed entry and the DBA's kernels
    too) for its plain PyTorch version."""
    names = cuda_corr.KERNELS + ("corr_lookup_indexed",)
    saved = {k: getattr(cuda_corr, k) for k in names}
    for k in names:
        setattr(cuda_corr, k, getattr(cuda_corr, k + "_plain"))
    try:
        with dba_probe.plain():
            yield
    finally:
        for k, fn in saved.items():
            setattr(cuda_corr, k, fn)


def check_reference():
    """Phase 4: the port's loop on the card with the kernels against the
    same loop with each kernel's plain version (the same bf16 volume),
    64x96, 8 frames + terminate(image_stream), f32 compute (bf16 compute
    amplifies rounding through the dynamic-mask vote). The poses of all
    8 frames, from the trajectory filler, must agree within 1e-3 abs.
    The mask head is biased by -2 (every mask logit far below the
    static/dynamic threshold): unbiased, 7% of the logits lie within
    0.05 of it, where a pixel's decision follows rounding, and two runs
    of the same kernel loop already differ by 9e-4."""
    cfg = VOConfig(image_size=(64, 96), warmup=5, filter_thresh=-1.0,
                   keyframe_thresh=0.0, segm_filter=True, max_edges=48,
                   frontend_window=8, dtype_features="float32")

    frames = list(synth_stream(8, 64, 96))

    def run():
        s = VOSystem(cfg, net=tame_net(mask_bias=-2.0), device="cuda",
                     net_dtype=torch.float32)
        for t, img, intr, segm in frames:
            s.track(t, img, intr, segments=segm)
        return (s.terminate(iter(frames), backend_steps=(2,)),
                s.video.disps[:s.video.counter].cpu().numpy())

    traj, disps = run()
    with plain_kernels():
        traj_ref, disps_ref = run()
    pose_err = float(np.abs(traj - traj_ref).max())
    rel = np.abs(disps - disps_ref) / np.abs(disps_ref)
    log("reference", frames=8, pose_max_abs_err=f"{pose_err:.3g}",
        disp_median_rel_err=f"{np.median(rel):.3g}",
        disp_max_rel_err=f"{rel.max():.3g}")
    if not (traj.shape == traj_ref.shape == (8, 7) and pose_err <= 1e-3
            and np.isfinite(disps).all()):
        raise AssertionError("kernel loop disagrees with the plain loop")


def run_main_path():
    """Phase 5: returns the kernel launch counts of the run, K1's and
    K3's split by feature type (F32_ROWS: the motion filter's probe is
    the run's f32 K3; the video's features are bf16, so no f32 K1), and
    the segment sum's ("segsum"). The configuration is bench.py's, the
    default one: the planner engages after initialization and its frames
    replay one CUDA graph, whose launches are counted per replay."""
    H, W, n_frames = 240, 808, 40
    cfg = VOConfig(image_size=(H, W), buffer=128, filter_thresh=0.01,
                   keyframe_thresh=0.0, warmup=12, segm_filter=True)
    frames = list(synth_stream(n_frames, H, W))
    sysm = VOSystem(cfg, net=tame_net(0), device="cuda")
    filler, filler_s = sysm.traj_filler, []

    def timed_filler(stream):
        f0 = time.perf_counter()
        poses = filler(stream)
        torch.cuda.synchronize()
        filler_s.append(time.perf_counter() - f0)
        return poses

    sysm.traj_filler = timed_filler

    # the backend apart from the rest of terminate: its wall time, the
    # edges of each global update, and K3 inside it through the wrapper
    # and as the kernel alone (CUDA events around the library call)
    backend, backend_s, graphs = sysm.backend, [], []
    k3_wrapper, k3_kernel = EventTimer(), EventTimer()

    def timed_backend(steps):
        torch.cuda.synchronize()
        b0 = time.perf_counter()
        backend(steps)
        torch.cuda.synchronize()
        backend_s.append(time.perf_counter() - b0)

    def counted_update(graph, *a, steps=8, **kw):
        graphs.append((graph.n_edges, steps))
        return update_lowmem(graph, *a, steps=steps, **kw)

    sysm.backend = timed_backend
    update_lowmem = FactorGraph.update_lowmem
    lib = cuda_corr._library()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_corr.reset_launches()
    cuda_segsum.reset_launches()
    cuda_dba.reset_launches()

    times, engaged_at = [], None
    for t, img, intr, segm in frames:
        f0 = time.perf_counter()
        sysm.track(t, img, intr, segments=segm)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - f0)
        if engaged_at is None and sysm.planner.engaged:
            engaged_at = t
    # every decision record resolved, so every replay counted
    planner = sysm.planner
    replays = planner.frame_graph.replays if planner.frame_graph else 0
    planner.disengage()
    tracked = dict(cuda_corr.LAUNCHES, **cuda_segsum.LAUNCHES, **cuda_dba.LAUNCHES)
    cuda_corr.reset_routes()
    with contextlib.ExitStack() as stack:
        for entry in ("corr_lookup", "corr_lookup_indexed"):
            stack.enter_context(patched(
                cuda_corr, entry, k3_wrapper.wrap(
                    getattr(cuda_corr, entry),
                    key=lambda *a: a[-1].shape[0])))
        stack.enter_context(patched(lib, "pvo_corr_lookup",
                                    k3_kernel.wrap(lib.pvo_corr_lookup)))
        stack.enter_context(patched(FactorGraph, "update_lowmem",
                                    counted_update))
        t0 = time.perf_counter()
        traj = sysm.terminate(iter(frames), backend_steps=(7, 12))
        torch.cuda.synchronize()
    # terminate_s: the last frontend update and the backend, as measured
    # before terminate filled every frame; filler_s: the filler
    term_s = time.perf_counter() - t0 - filler_s[0]
    launches = dict(cuda_corr.LAUNCHES, **cuda_segsum.LAUNCHES, **cuda_dba.LAUNCHES)
    f32_launches = dict(cuda_corr.F32_LAUNCHES)

    # the frontend initializes at t=12 (warmup 12, admission committed
    # one frame late); steady state is t=13..39; the planner engages at
    # t=13, runs eager frames, captures and then replays
    meas = times[13:]
    replayed = times[n_frames - replays + 1:] if replays > 1 else []
    if engaged_at != 13 or len(replayed) < 10:
        raise AssertionError(f"planner engaged at {engaged_at}, "
                             f"{replays} replays")
    log("main", image=f"{H}x{W}", frames=n_frames, engaged_at=engaged_at,
        graph_replays=replays,
        fps_replayed=f"{len(replayed) / sum(replayed):.3f}",
        keyframes=sysm.video.counter,
        volume_cached=cuda_corr.volume_cache_ok(sysm.video.h, sysm.video.w),
        fps=f"{len(meas) / sum(meas):.3f}",
        ms_per_frame=f"{1e3 * sum(meas) / len(meas):.2f}",
        init_frame_s=f"{times[12]:.3f}", terminate_s=f"{term_s:.3f}",
        filler_s=f"{filler_s[0]:.3f}",
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        **{f"launches_{k}": v for k, v in launches.items()},
        **{f"of_them_f32_{k}": v for k, v in f32_launches.items()})
    # K3 inside terminate: chunks of the backend's global updates
    wrapper = k3_wrapper.ms()
    kernel = [ms for _, ms in k3_kernel.ms()]
    if len(wrapper) != len(kernel):
        raise AssertionError("K3 wrapper and kernel calls do not pair up")
    sizes = sorted({E for E, _ in wrapper})
    per_size = {E: (sum(1 for e, _ in wrapper if e == E),
                    np.mean([w for e, w in wrapper if e == E]),
                    np.mean([k for (e, _), k in zip(wrapper, kernel)
                             if e == E])) for E in sizes}
    updates = sum(steps for _, steps in graphs)
    log("backend", backend_s=f"{sum(backend_s):.3f}",
        rest_of_terminate_s=f"{term_s - sum(backend_s):.3f}",
        calls=len(backend_s), global_updates=updates,
        edges_per_call="/".join(str(n) for n, _ in graphs),
        **{f"{k}_launches_in_terminate": launches[k] - tracked[k]
           for k in launches},
        k3_chunks_per_update=f"{len(wrapper) / max(updates, 1):.2f}",
        k3_wrapper_ms_total=f"{sum(w for _, w in wrapper):.3f}",
        k3_kernel_ms_total=f"{sum(kernel):.3f}",
        **{f"k3_E{E}": f"{n}x(wrapper {w:.4f} ms, kernel {k:.4f} ms)"
           for E, (n, w, k) in per_size.items()})
    tc, simt = cuda_corr.routes()
    log("backend", k3_block_levels_tensor_core=tc,
        k3_block_levels_per_pixel=simt,
        tensor_core_share=f"{tc / max(tc + simt, 1):.4f}")
    if tc == 0:
        raise AssertionError("terminate never took K3's tensor-core route")
    if traj.shape != (n_frames, 7) or not np.isfinite(traj).all():
        raise AssertionError(f"bad trajectory {traj.shape}")
    depth, flow = sysm.get_depth(), sysm.get_flow()
    n = sysm.video.counter
    log("main", get_depth="x".join(map(str, depth.shape)),
        get_flow="x".join(map(str, flow.shape)))
    if not (depth.shape == (n, H, W) and flow.shape == (n, H, W, 2)
            and np.isfinite(depth).all() and np.isfinite(flow).all()):
        raise AssertionError(f"bad accessors {depth.shape} {flow.shape}")
    terminate_split(sysm, frames)
    time_depth_filter(sysm.video)
    # the tracking path's bf16 kernels, and K3's f32 kernel (the probe)
    launches.update({F32_ROWS[k]: v for k, v in f32_launches.items()})
    for k in cuda_corr.F32_KERNELS:
        launches[k] -= f32_launches[k]
    # the solve's grid kernel takes P above 48: the main path's backend at
    # 40 frames stays on the one block (phase terminate_wide drives it)
    missing = [k for k, v in launches.items()
               if v == 0 and k not in ("build_volumes_f32", cuda_dba.GRID)]
    if missing or launches["build_volumes_f32"]:
        raise AssertionError(f"launches on the main path: {launches}; never "
                             f"launched: {missing}")
    terminate = {k: launches[k] - tracked[k] for k in cuda_dba.KERNELS}
    if not all(terminate.values()):
        raise AssertionError(f"terminate never launched a DBA kernel: "
                             f"{terminate}")
    return dict(launches, in_terminate=terminate)


def oracle_core(n):
    """An update core that sets every edge's target to the reprojection
    by a fixed smooth trajectory of ``n`` frames at unit disparity, with
    full weight and fixed damping (tests/test_torch_port_planner.py's
    oracle): bit-stable outputs, so that the planner's decisions can be
    held against the classic path's while its padded widths reorder f32
    sums."""
    tang = torch.zeros(n, 6)
    tang[:, 0] = 0.04 * torch.arange(n)
    tang[:, 4] = 0.01 * torch.arange(n)
    gt = {}

    def core(graph, net, target, raw, dy, ii, jj, valid, w0, K, corr_fn,
             ctx_pre, segms_e):
        v = graph.video
        F = v.poses.shape[0]
        if "poses" not in gt:     # made once, on the first (eager) frame
            gt["poses"] = se3.exp(tang.to(v.poses.device))
        gt_poses = gt["poses"]
        gp = torch.cat([gt_poses, gt_poses[-1:].expand(F - n, 7)])[None]
        gd = torch.ones((1, F) + v.disps.shape[1:], device=v.disps.device)
        coords, vm = projective.projective_transform(
            gp, gd, v.intrinsics[0].expand(1, F, 4), ii, jj)
        target = coords[0]
        weight = (valid[:, None, None, None].float() *
                  vm[0].float()).expand_as(target).clone()
        eta = 1e-4 * torch.ones((K,) + target.shape[1:3], device=ii.device)
        m = torch.where(valid, ii - w0, torch.full_like(ii, K))
        has_edge = cuda_segsum.segment_sum(valid.float(), m, K) > 0
        flow = target - projective.coords_grid(*target.shape[1:3],
                                               device=ii.device)
        return net, target, weight, raw, dy, flow, eta, has_edge

    return core


def planner_run(path, frames, oracle=False, prof_frames=True,
                cell=(PLANNER_SIZE, PLANNER_FRAMES, PLANNER_STEADY),
                kf_thresh=0.0, probe=None, keep=False):
    """One run of bench_track's system (tame_net(0), the segment filter
    on, every frame a keyframe unless ``kf_thresh`` removes some) at
    ``cell``'s size over ``frames`` on ``path``: "classic"
    (pipeline=False), "graph" (the planner, replayed as a CUDA graph) or
    "eager" (the planner's program run eagerly on the card, the reference
    the graph is held against). ``cell`` = (size, frames tracked, first
    steady frame): the steady frames among those tracked are timed as one
    block with one synchronize at the end (bench.py's protocol); the rest
    of ``frames`` run under torch.profiler. K3's route counters are read
    over the steady and profiled frames. ``probe(sysm)`` runs on the
    engaged planner after the last frame; ``keep`` returns the system
    too. Returns the run's decisions, state and numbers."""
    size, n_track, steady = cell
    if not 0 < steady < n_track <= len(frames):
        raise ValueError(f"planner_run: steady frame {steady}, {n_track} "
                         f"tracked of {len(frames)}")
    sysm = bench_system(size, 128, "cuda", pipeline=path != "classic",
                        keyframe_thresh=kf_thresh)
    drv = sysm.planner
    drv.use_graph = path == "graph"
    records, replayed = [], []
    resolve = drv._resolve_one

    def resolve_one():
        replayed.append(drv._records[0][2])
        records.append(resolve().tolist())
        return records[-1]

    drv._resolve_one = resolve_one
    engaged_at = None
    with patched(factor_graph, "update_core",
                 oracle_core(len(frames)) if oracle
                 else factor_graph.update_core):
        for t, img, intr, segm in frames[:n_track]:
            if t == steady:
                torch.cuda.synchronize()
                cuda_corr.reset_routes()
                t0 = time.perf_counter()
            sysm.track(t, img, intr, segments=segm)
            if engaged_at is None and drv.engaged:
                engaged_at = t
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / (n_track - steady)
        with profiled() if prof_frames else contextlib.nullcontext() as prof:
            for t, img, intr, segm in frames[n_track:]:
                sysm.track(t, img, intr, segments=segm)
            torch.cuda.synchronize()
        routes = cuda_corr.routes()
        probed = probe(sysm) if probe is not None else None
    n_prof = len(frames) - n_track
    device_ms, kernels = ((v / n_prof for v in kernel_rows(prof))
                          if prof_frames else (None, None))
    capture_s = drv.frame_graph.capture_s if drv.frame_graph else None
    launches = (drv.frame_graph.per_replay(drv.sections(records[-1]))
                if drv.frame_graph else None)
    drv.disengage()
    if drv.frame_graph and prof_frames:
        check_replay_counts(drv, records[-n_prof:], replayed[-n_prof:],
                            prof)
    if sysm._pending_adm is not None:
        sysm.filterx.resolve_track(sysm._pending_adm)
        sysm._pending_adm = None
    sysm.frontend.resolve()
    g, v = sysm.frontend.graph, sysm.video
    n = v.counter
    # the records of the frames since the routes were reset
    since = len(frames) - steady
    out = {
        "engaged_at": engaged_at, "records": records,
        "decisions": (n, sysm.frontend.t1,
                      sorted(zip(g.ii.tolist(), g.jj.tolist(),
                                 g.age.tolist())),
                      sorted(zip(g.ii_inac.tolist(), g.jj_inac.tolist())),
                      v.tstamp[:n].tolist()),
        "poses": v.poses[:n].cpu(), "disps": v.disps[:n].cpu(),
        "ms": 1e3 * wall, "device_ms": device_ms, "kernels": kernels,
        "api_calls": api_calls(prof) / n_prof if prof_frames else None,
        "busy": device_ms / (1e3 * wall) if prof_frames else None,
        "capture_s": capture_s,
        "launches_per_replay": launches, "n_removed": drv.n_removed,
        "routes": routes, "probe": probed,
        "route_pairs": (route_pairs(drv, records[-since:], v.h, v.w)
                        if drv.frame_graph and all(replayed[-since:])
                        else None),
        "k3_bf16_per_replay": ([k3_bf16_launches(drv, r)
                                for r in records[-since:]]
                               if drv.frame_graph else None)}
    if keep:
        out["sys"] = sysm
    return out


def replay_launches(drv, rec, kernel, f32=False):
    """``kernel``'s launches in one replay of ``drv``'s frame graph that
    ran the sections of record ``rec`` (of them, its f32 kernel's with
    ``f32``)."""
    fgr, k = drv.frame_graph, 1 if f32 else 0
    return sum(fgr.launches[p][k].get(kernel, 0)
               for p in ((),) + drv.sections(rec) if p in fgr.launches)


def k3_bf16_launches(drv, rec):
    """(K3 bf16 launches, update steps that ran) of one replay."""
    bf16 = (replay_launches(drv, rec, "corr_lookup") -
            replay_launches(drv, rec, "corr_lookup", f32=True))
    prog = drv.program
    steps = (prog.steps + prog.steps2 * int(rec[planner_mod.R_STEPS2])
             if rec[planner_mod.R_RAN] else 0)
    return bf16, steps


def route_pairs(drv, records, h, w):
    """The (block, level) pairs K3's route counters must hold after
    replays with ``records``: each launch's
    (cuda_corr.lookup_route_pairs) at the regime's edge width for the
    bf16 kernel, one edge for the f32 probe."""
    total = 0
    for rec in records:
        E = (planner_mod.EB_S if rec[planner_mod.R_SMALL] else drv.EBMAX)
        f32 = replay_launches(drv, rec, "corr_lookup", f32=True)
        bf16 = replay_launches(drv, rec, "corr_lookup") - f32
        total += (bf16 * cuda_corr.lookup_route_pairs(E, h, w, True) +
                  f32 * cuda_corr.lookup_route_pairs(1, h, w, False))
    return total


def same_run(a, b):
    """Two planner_run results bit-equal: decisions, poses, disparities."""
    return (a["decisions"] == b["decisions"] and
            torch.equal(a["poses"], b["poses"]) and
            torch.equal(a["disps"], b["disps"]))


def against_classic(p, c):
    """(decisions equal, max pose difference) of planner_run results."""
    diff = (float((p["poses"] - c["poses"]).abs().max())
            if p["poses"].shape == c["poses"].shape else float("inf"))
    return p["decisions"] == c["decisions"], diff


def check_replay_counts(drv, records, replayed, prof):
    """Holds the launches that FrameGraph.count adds for the profiled
    replays (per_replay of the sections each frame's record names)
    against the kernel rows of their profile: K1, K2, K3 and the segment
    sum."""
    if not all(replayed):
        raise AssertionError(f"profiled frames not all replays: {replayed}")
    derived = trace_track.replay_counted(drv, records)
    seen = trace_track.profile_launches(prof)
    log("planner", replays_profiled=len(records),
        launches_counted=repr(derived), launches_profiled=repr(seen))
    if derived != seen:
        raise AssertionError(f"replayed launches counted {derived}, "
                             f"profiled {seen}")


def planner_runs(tag, frames, cell, probe=None):
    """The runs of phases 12 and planner_wide at ``cell``'s size (as
    planner_run takes it) over ``frames``: classic, planner graph,
    planner graph, classic, in turns, each logged; then the planner's
    program run eagerly on the card, and classic and planner graph under
    the oracle core (oracle_core). ``probe`` runs on the first graph
    run's engaged planner (its result's "probe"); that run's system is
    kept (its "sys"). Held, for both phases: every planner run engages at
    frame 13 and no classic run engages; the graph-replayed planner
    equals the eager one bit for bit (poses, disparities, decisions,
    every decision record); each path's two runs are bit-equal (B5);
    under the oracle core the planner's decisions (keyframes, t1, edges
    with their ages, inactive edges, timestamps) equal the classic
    path's and its poses are within 1e-3 (with the network, its padded
    widths reorder f32 sums and the difference is printed); a replay
    launches PLANNER_SEGSUMS segment sums and PLANNER_DBA's DBA kernels;
    K3's route counters hold every (block, level) pair of the replays'
    K3 launches (check_routes). Returns {"classic": [c1, c2], "graph":
    [p1, p2], "eager": ..., "oracle": {"classic": ..., "graph": ...}}."""
    (H, W), _, _ = cell
    fmt = (lambda v, f: None if v is None else format(v, f))
    by = {}
    for path in ("classic", "graph", "graph", "classic"):
        first_graph = path == "graph" and "graph" not in by
        # the first graph run's system (and its graph) stays alive: with
        # it freed before the second graph run, torch.profiler named
        # that run's replayed kernels wrongly (more than the graph holds)
        r = planner_run(path, frames, cell=cell, keep=first_graph,
                        probe=probe if first_graph else None)
        by.setdefault(path, []).append(r)
        log(tag, path=path, image=f"{H}x{W}", engaged_at=r["engaged_at"],
            keyframes=r["decisions"][0], ms_per_frame=f"{r['ms']:.2f}",
            fps=f"{1e3 / r['ms']:.3f}",
            device_ms_per_frame=fmt(r["device_ms"], ".2f"),
            busy_share=fmt(r["busy"], ".3f"),
            kernels_per_frame=fmt(r["kernels"], ".0f"),
            host_api_calls_per_frame=fmt(r["api_calls"], ".1f"),
            capture_s=fmt(r["capture_s"], ".2f"),
            graph_launches_per_frame=r["launches_per_replay"],
            regimes="".join("c" if rec[planner_mod.R_SMALL] else "f"
                            for rec in r["records"]
                            if rec[planner_mod.R_RAN]))
        gc.collect()
        torch.cuda.empty_cache()
    runs = {**by,
            "eager": planner_run("eager", frames, cell=cell,
                                 prof_frames=False),
            "oracle": {path: planner_run(path, frames, oracle=True,
                                         prof_frames=False, cell=cell)
                       for path in ("classic", "graph")}}
    c1, c2 = by["classic"]
    p1, p2 = by["graph"]
    eager, oracle = runs["eager"], runs["oracle"]
    for r in by["graph"]:
        check_routes(r, tag)
    graph_eager = same_run(p1, eager) and p1["records"] == eager["records"]
    b5 = {"classic": same_run(c1, c2), "planner": same_run(p1, p2)}
    net_equal, net_diff = against_classic(p1, c1)
    decisions, pose_diff = against_classic(oracle["graph"], oracle["classic"])
    log(tag, engaged_at=p1["engaged_at"],
        graph_equals_eager=graph_eager, repeats_b5=b5,
        oracle_decisions_equal_classic=decisions,
        oracle_max_pose_diff_classic=f"{pose_diff:.3g}",
        network_decisions_equal_classic=net_equal,
        network_max_pose_diff_classic=f"{net_diff:.3g}")
    engaged = [r["engaged_at"] for r in (p1, p2, eager, oracle["graph"])]
    never = [r["engaged_at"] for r in (c1, c2, oracle["classic"])]
    if set(engaged) != {13} or any(t is not None for t in never):
        raise AssertionError(f"{tag}: the planner engaged at {engaged}, "
                             f"the classic path at {never}")
    if not graph_eager:
        raise AssertionError(f"{tag}: graph replay differs from the eager "
                             "planner")
    if not (b5["classic"] and b5["planner"]):
        raise AssertionError(f"{tag}: tracking does not repeat itself: "
                             f"{b5}")
    for r in by["graph"]:
        per = r["launches_per_replay"]
        if per["segsum"] != PLANNER_SEGSUMS or \
                any(per[k] != n for k, n in PLANNER_DBA.items()):
            raise AssertionError(
                f"{tag}: segment sums and DBA kernels a replay {per}, "
                f"expected {PLANNER_SEGSUMS} and {PLANNER_DBA}")
    if not decisions or not pose_diff < 1e-3:
        raise AssertionError(f"{tag}: planner against classic (oracle "
                             f"core): decisions equal {decisions}, poses "
                             f"{pose_diff}")
    return runs


def run_planner():
    """Phase 12: the planner (vo/planner.py) at 240x808 over
    PLANNER_FRAMES frames of bench_track's stream, in one process: the
    runs and checks of planner_runs. (fault_probe b5 runs the classic
    path with the card's atomic index_add_ beside the kernel.) Capture
    fails on any host read inside the captured frame, and the run with
    it. Each run's ms a frame (the steady frames, one synchronize),
    device ms, kernels and host CUDA API calls a frame and the busy
    share (torch.profiler, PLANNER_PROF more frames), and the graph's
    launches of each kernel a frame, those counted for the profiled
    replays held against their profile (check_replay_counts)."""
    t_phase = time.perf_counter()
    H, W = PLANNER_SIZE
    frames = list(synth_stream(PLANNER_FRAMES + PLANNER_PROF, H, W))
    runs = planner_runs("planner", frames,
                        (PLANNER_SIZE, PLANNER_FRAMES, PLANNER_STEADY))
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    log("planner", seconds=f"{time.perf_counter() - t_phase:.1f}")


def check_routes(r, tag):
    """A graph run's K3 route counters over its steady and profiled
    replays against the pairs its launches must add (route_pairs): every
    (block, level) pair of the frames' K3 launches counted, on either
    route, inside the replayed graph."""
    tc, simt = r["routes"]
    log(tag, k3_block_levels_tensor_core=tc, k3_block_levels_per_pixel=simt,
        k3_block_levels_expected=r["route_pairs"],
        tensor_core_share=f"{tc / max(tc + simt, 1):.4f}")
    if tc + simt != r["route_pairs"]:
        raise AssertionError(f"{tag}: K3's route counters hold {tc} + "
                             f"{simt} pairs, the replays launched "
                             f"{r['route_pairs']}")


def wide_lookup(sysm):
    """planner_wide: on the engaged planner, K3 bf16 on one update call's
    operands (PlannerProgram.lookup_operands at the full regime's EBMAX
    edges: the 2E gathered frames, their pyramid, fi, fi + E) and the
    update's coordinates (the reprojection by the current poses and
    disparities) against corr_lookup_indexed_plain on the same operands
    (<= 1e-4); the kernel alone (CUDA events) beside the plain version,
    its bound and its (block, level) routes; lookup_operands (the gather
    and the pooling of the 2E frames, once an update call) and
    lookup_pyramid alone."""
    drv, v = sysm.planner, sysm.video
    E = drv.EBMAX
    ii, jj = drv.st.ii[:E].clone(), drv.st.jj[:E].clone()
    ops = drv.program.lookup_operands(ii, jj)
    coords, _ = projective.projective_transform(
        v.poses[None], v.disps[None],
        v.intrinsics[0].expand(1, v.poses.shape[0], 4), ii, jj)
    coords = coords[0].contiguous()
    cuda_corr.reset_routes()
    out = cuda_corr.corr_lookup_indexed(*ops, coords)
    routes = cuda_corr.routes()
    ref = cuda_corr.corr_lookup_indexed_plain(*ops, coords)
    err = kbench.lookup_err(out, ref)
    del out, ref
    torch.cuda.empty_cache()
    bound = kernel_bound("corr_lookup", E, v.h, v.w, C)
    res = {"err": err, "routes": routes,
           "ms": device_time_ms(lambda: cuda_corr.corr_lookup_indexed(
               *ops, coords)),
           "plain_ms": device_time_ms(
               lambda: cuda_corr.corr_lookup_indexed_plain(*ops, coords),
               reps=3),
           "bound_ms": bound["ms"], "bound_by": bound["bound_by"],
           "operands_ms": device_time_ms(
               lambda: drv.program.lookup_operands(ii, jj)),
           "pyramid_ms": device_time_ms(
               lambda: cuda_corr.lookup_pyramid(ops[0]))}
    torch.cuda.empty_cache()
    return res


def wide_terminate(sysm, frames, seen):
    """planner_wide: a planner run at 376x1248 that has tracked
    ``frames[:seen]`` tracks the rest of ``frames`` (the planner
    re-engages on its graph), then terminate(image_stream,
    backend_steps=(7, 12)), timed; the backend apart (its wall time and
    the edges of each global update), K3's calls inside terminate by edge
    count (the backend's 256-edge chunks among them), every kernel's
    launches, the peak memory; get_depth() and get_flow() must give
    finite (counter, 376, 1248[, 2]) arrays."""
    H, W = WIDE_SIZE
    for t, img, intr, segm in frames[seen:]:
        sysm.track(t, img, intr, segments=segm)
    reengaged = sysm.planner.engaged
    backend, backend_s, edges, k3 = sysm.backend, [], [], []

    def timed_backend(steps):
        torch.cuda.synchronize()
        b0 = time.perf_counter()
        backend(steps)
        torch.cuda.synchronize()
        backend_s.append(time.perf_counter() - b0)

    def counted_update(graph, *a, **kw):
        edges.append(graph.n_edges)
        return update_lowmem(graph, *a, **kw)

    update_lowmem, indexed = FactorGraph.update_lowmem, \
        cuda_corr.corr_lookup_indexed

    def counted_k3(fmaps, pyr, ii, jj, coords, *a, **kw):
        k3.append(coords.shape[0])
        return indexed(fmaps, pyr, ii, jj, coords, *a, **kw)

    sysm.backend = timed_backend
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_corr_launches()
    with patched(FactorGraph, "update_lowmem", counted_update), \
            patched(cuda_corr, "corr_lookup_indexed", counted_k3):
        t0 = time.perf_counter()
        traj = sysm.terminate(iter(frames), backend_steps=(7, 12))
        torch.cuda.synchronize()
        term_s = time.perf_counter() - t0
    sysm.backend = backend
    launches = kbench.launch_counts()
    depth, flow = sysm.get_depth(), sysm.get_flow()
    n = sysm.video.counter
    log("planner_wide", frames=len(frames), reengaged=reengaged,
        keyframes=n, terminate_s=f"{term_s:.3f}",
        backend_s=f"{sum(backend_s):.3f}", backend_calls=len(backend_s),
        backend_edges_per_call="/".join(map(str, edges)),
        k3_calls_in_terminate=len(k3),
        k3_edges_per_call="/".join(str(e) for e in sorted(set(k3))),
        k3_chunks=sum(e == sysm.backend.edge_chunk for e in k3),
        peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        get_depth="x".join(map(str, depth.shape)),
        get_flow="x".join(map(str, flow.shape)),
        **{f"launches_{k}": n_ for k, n_ in launches.items()})
    if not (traj.shape == (len(frames), 7) and np.isfinite(traj).all()):
        raise AssertionError(f"wide terminate: trajectory {traj.shape}")
    if not (depth.shape == (n, H, W) and flow.shape == (n, H, W, 2) and
            np.isfinite(depth).all() and np.isfinite(flow).all()):
        raise AssertionError(f"wide accessors {depth.shape} {flow.shape}")
    if launches["build_volumes"] or launches["corr_extract"] or not k3 \
            or not reengaged:
        raise AssertionError(f"wide terminate launched {launches}, "
                             f"re-engaged {reengaged}")


def run_planner_wide():
    """planner_wide (after phase 12): the planner on a wide stream,
    376x1248 (47x156 features: the card's "indexed" route, where the
    program gathers an update's 2E frames, pools them once and runs K3
    bf16 on every step, and the classic frontend's wide route), over
    WIDE_FRAMES frames of bench_track's stream: classic, planner graph,
    planner graph, classic, in turns; the eager planner; classic and
    planner graph under the oracle core, held as planner_runs holds
    them. Also held: a replay launches no K1 and no K2, and K3 bf16 once
    per update step that ran; K3 on the engaged planner's own operands
    within 1e-4 of its plain version (wide_lookup). A second stream of
    WIDE_RM_FRAMES frames at
    keyframe_thresh WIDE_KF_THRESH: graph bit-equal to eager; under the
    oracle core the planner removes at least two keyframes and equals the
    classic path (the same removed timestamps). Then the first graph run
    tracked on to WIDE_TERM_FRAMES and terminated (wide_terminate), and
    trace_track at 376x1248 in a process of its own (kernel ms, GFLOP and
    MFU a replayed frame)."""
    t_phase = time.perf_counter()
    H, W = WIDE_SIZE
    stream = list(synth_stream(WIDE_TERM_FRAMES, H, W))
    frames = stream[:WIDE_FRAMES + WIDE_PROF]
    runs = planner_runs("planner_wide", frames,
                        (WIDE_SIZE, WIDE_FRAMES, WIDE_STEADY),
                        probe=wide_lookup)
    p1 = runs["graph"][0]
    term, lk = p1.pop("sys"), p1["probe"]
    log("planner_wide", kernel="corr_lookup", features="bf16",
        entry="indexed",
        shape=f"{planner_mod.PlannerDriver.EBMAX}x{H // 8}x{W // 8}",
        coords="the planner's own", max_abs_err=f"{lk['err']:.3g}",
        tol=TOL["corr_lookup"], ms=f"{lk['ms']:.4f}",
        plain_ms=f"{lk['plain_ms']:.4f}", bound_ms=f"{lk['bound_ms']:.4f}",
        bound_by=lk["bound_by"],
        share_of_bound=f"{lk['bound_ms'] / lk['ms']:.4f}", library_ms=None,
        tensor_core_pairs=lk["routes"][0], per_pixel_pairs=lk["routes"][1],
        launches_per_replay="/".join(str(n) for n, _ in
                                     p1["k3_bf16_per_replay"]),
        lookup_operands_ms=f"{lk['operands_ms']:.4f}",
        lookup_pyramid_ms=f"{lk['pyramid_ms']:.4f}")
    for r in runs["graph"]:
        per = r["launches_per_replay"]
        if per["build_volumes"] or per["corr_extract"]:
            raise AssertionError(f"planner_wide: launches a replay {per}, "
                                 f"expected no K1 or K2")
        if any(n != steps or not steps for n, steps in
               r["k3_bf16_per_replay"]):
            raise AssertionError(f"planner_wide: K3 bf16 launches against "
                                 f"update steps a replay: "
                                 f"{r['k3_bf16_per_replay']}")
    if not lk["err"] <= TOL["corr_lookup"]:
        raise AssertionError(f"planner_wide: K3 on the planner's operands "
                             f"{lk['err']} from plain")
    del runs, p1
    gc.collect()
    torch.cuda.empty_cache()

    # the stream that removes keyframes
    rm_frames = frames[:WIDE_RM_FRAMES]
    rm_cell = (WIDE_SIZE, WIDE_RM_FRAMES, WIDE_RM_STEADY)
    runs = {(path, oracle): planner_run(path, rm_frames, oracle=oracle,
                                        prof_frames=False, cell=rm_cell,
                                        kf_thresh=WIDE_KF_THRESH)
            for path, oracle in (("graph", False), ("eager", False),
                                 ("graph", True), ("classic", True))}
    g, e = runs["graph", False], runs["eager", False]
    po, co = runs["graph", True], runs["classic", True]
    graph_eager = same_run(g, e) and g["records"] == e["records"]
    decisions, pose_diff = against_classic(po, co)
    removed = {k: sorted(set(float(t) for t, *_ in rm_frames) -
                         set(r["decisions"][4]))
               for k, r in (("planner", po), ("classic", co))}
    log("planner_wide", stream="removal", keyframe_thresh=WIDE_KF_THRESH,
        frames=WIDE_RM_FRAMES, network_n_removed=g["n_removed"],
        network_keyframes=g["decisions"][0], graph_equals_eager=graph_eager,
        oracle_n_removed=po["n_removed"],
        oracle_removed_planner=removed["planner"],
        oracle_removed_classic=removed["classic"],
        oracle_decisions_equal_classic=decisions,
        oracle_max_pose_diff_classic=f"{pose_diff:.3g}")
    if not graph_eager:
        raise AssertionError("planner_wide (removal): graph replay differs "
                             "from the eager planner")
    if not (decisions and pose_diff < 1e-3 and po["n_removed"] >= 2 and
            removed["planner"] == removed["classic"] and
            po["engaged_at"] == 13 and co["engaged_at"] is None):
        raise AssertionError(
            f"planner_wide (removal, oracle core): decisions equal "
            f"{decisions}, poses {pose_diff}, removed {po['n_removed']} "
            f"{removed}, engaged {po['engaged_at']}")
    del runs, g, e, po, co
    gc.collect()
    torch.cuda.empty_cache()

    wide_terminate(term, stream, len(frames))
    del term
    gc.collect()
    torch.cuda.empty_cache()
    out, secs = run_trace_track(WIDE_TRACE_ARGV)
    log("planner_wide", trace_track=" ".join(WIDE_TRACE_ARGV),
        device_ms_per_frame=f"{out['device_ms_per_frame']:.3f}",
        kernels_per_frame=f"{out['kernels_per_frame']:.0f}",
        frame_gflop=f"{out['frame_gflop']:.3f}", mfu=f"{out['mfu']:.4f}",
        sections=repr(out["sections"]),
        launches_traced=repr(out["launches_traced"]),
        seconds=f"{secs:.1f}")
    log("planner_wide", seconds=f"{time.perf_counter() - t_phase:.1f}")


def run_terminate_wide():
    """Phase 12c (see the module's note). Returns the DBA kernels'
    launches in terminate."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    sysm, frames = bench_terminate.tracked_system(WIDE100_KF, WIDE_SIZE,
                                                  dev)
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t0
    reset_corr_launches()
    edges = []
    t0 = time.perf_counter()
    with vo_counters([], edges, []):
        traj = sysm.terminate(iter(frames))
    torch.cuda.synchronize()
    terminate_s = time.perf_counter() - t0
    kf = int(sysm.video.counter)
    launches = dict(cuda_dba.LAUNCHES)
    log("terminate_wide", keyframes=kf, track_s=f"{track_s:.2f}",
        terminate_s=f"{terminate_s:.3f}",
        backend_edges="/".join(map(str, edges)), launches=repr(launches))
    if not np.isfinite(traj).all() or kf < 0.9 * WIDE100_KF:
        raise AssertionError(f"wide terminate: {kf} keyframes, finite "
                             f"{bool(np.isfinite(traj).all())}")
    if not all(launches.values()):
        raise AssertionError(f"wide terminate's DBA launches {launches}")
    return launches


def run_planner_wide_alone():
    """planner_wide in a process of its own (``python3 chip_smoke.py
    planner_wide``), as the whole run starts it: after earlier graphs
    and profiles in a process, torch.profiler can name a later graph's
    replayed kernels wrongly (phase 12's after this phase's; PERF.md
    section 7), and the phase holds its profiled replays' launches. Its
    log lines are printed here; a failure in it fails the run."""
    proc = subprocess.run(
        [sys.executable, osp.abspath(__file__), "planner_wide"],
        capture_output=True, text=True, timeout=900,
        cwd=osp.dirname(osp.abspath(__file__)))
    for line in proc.stdout.splitlines():
        if line.startswith("[planner_wide]"):
            print(line, flush=True)
    if proc.returncode:
        print(proc.stdout[-6000:], proc.stderr[-6000:], file=sys.stderr)
        raise AssertionError(f"planner_wide exited {proc.returncode}")


def terminate_split(sysm, frames):
    """Phase 5: one more terminate(image_stream) after the timed one,
    under torch.profiler: the device ms and kernels inside each range of
    the backend and the filler (vo/factor_graph.py), and the corr
    kernels' own rows (launched through ctypes, inside no range; K3 bf16
    is the backend's, K1 and K2 the filler's)."""
    torch.cuda.synchronize()
    with profiled() as prof:
        sysm.terminate(iter(frames), backend_steps=(7, 12))
        torch.cuda.synchronize()
    ranges = range_device_ms(prof, TAIL_RANGES)
    log("split", **{k: f"{ms:.3f}ms/{n}" for k, (ms, n) in
                    sorted(ranges.items())})
    log("split", **{f"kernel_{k}": f"{ms:.3f}ms/{n}" for k, (ms, n) in
                    corr_rows(prof).items()})
    empty = [k for k in TAIL_LAYERS if ranges.get(k, (0.0, 0))[1] == 0]
    if empty:
        raise AssertionError(f"no kernels inside {empty}")


def time_depth_filter(video):
    """Phase 5: depth_consistency_count (plain torch, the reference's
    CUDA depth_filter) on the video's keyframes as the visualizer calls
    it, by CUDA events, beside its byte bound: the disparities of the
    keyframes and their 3 neighbours each side read once, the counts
    written once. Its counts equal the CPU's on >= 99.9% of pixels (a
    projection on a half pixel may round either way)."""
    n = int(video.counter)
    inds = torch.arange(n, device=video.disps.device)
    thresh = DEPTH_FILTER_THRESH * video.disps[:n].mean(dim=(1, 2)).sqrt()
    args = (video.poses, video.disps, video.intrinsics[0], inds, thresh)
    counts = depth_consistency_count(*args)
    ref = depth_consistency_count(*(a.cpu() for a in args))
    equal = float((counts.cpu() == ref).float().mean())
    ms = device_time_ms(lambda: depth_consistency_count(*args), reps=10)
    F, h, w = video.disps.shape
    nbytes = (min(n + 3, F) * h * w + n * h * w) * 4
    log("depth_filter", keyframes=n, feature_hw=f"{h}x{w}",
        ms=f"{ms:.4f}", bound_ms=f"{1e3 * nbytes / kbench.HBM_BYTES_S:.4f}",
        counts_equal_cpu=f"{equal:.5f}", mean_count=f"{counts.mean():.3f}")
    if equal < 0.999:
        raise AssertionError(f"depth_consistency_count: {equal} equal")


def run_harnesses():
    """Phase 6: each corr experiment harness's main() at its default
    shapes, with its kernel's launches counted from 0; a harness that
    runs another's program (corr_exp5 runs corr_exp4's) takes that
    run's results. Returns {X: (launches, ms and plain_ms of the
    harness's first case, worst max |d|)} and, under "X1 routes",
    corr_exp.time_routes()'s result."""
    res, ran = {}, {}
    for x, (mod, kernel, _) in HARNESS.items():
        main = importlib.import_module(f"pvo_tpu_torch.scripts.{mod}").main
        if main in ran:
            res[x] = res[ran[main]]
            log("harness", kernel=x, module=mod, same_program_as=ran[main])
            continue
        ran[main] = x
        cuda_corr_exp.reset_launches()
        cases = main([])
        n = cuda_corr_exp.LAUNCHES[kernel]
        ms, plain_ms, _ = next(iter(cases.values()))
        err = max(e for _, _, e in cases.values())
        log("harness", kernel=x, module=mod, launches=n,
            first_case=repr(next(iter(cases))), ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", max_abs_err=f"{err:.3g}")
        if n == 0 or not np.isfinite(err):
            raise AssertionError(f"{x}: {n} launches, error {err}")
        res[x] = (n, ms, plain_ms, err)
    # P1 on the harness's coordinates and on smooth ones, wrapper and
    # kernel alone, with the (block, level) pairs of one launch by route
    routes = importlib.import_module(
        "pvo_tpu_torch.scripts.corr_exp").time_routes()
    for kind, r in routes.items():
        log("harness", kernel="X1", coords=kind, ms=f"{r['ms']:.4f}",
            kernel_only_ms=f"{r['kernel_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.4f}",
            share_of_bound=f"{r['bound_ms'] / r['kernel_ms']:.4f}",
            pairs_within_cap=r["routes"][0], pairs_above_cap=r["routes"][1])
        if r["routes"] != r["expected_routes"]:
            raise AssertionError(f"X1 on {kind} coordinates took routes "
                                 f"{r['routes']}, the model says "
                                 f"{r['expected_routes']}")
    if routes["smooth"]["routes"][1] or not all(routes["uniform"]["routes"]):
        raise AssertionError(f"X1's routes: {routes}")
    res["X1 routes"] = routes
    # P2's second bound: the sectors its loads touch on the harness's coords
    E = HARNESS_E["corr_extract_packed"]
    sectors = kernel_bound(
        "corr_extract_packed", E, 30, 101, C,
        coords=harness_inputs(E, 30, 101)[2].cpu().numpy())
    ms = res["X2"][1]
    log("harness", kernel="X2-X5", shape=f"{E}x30x101", ms=f"{ms:.4f}",
        bound_ms=f"{sectors['ms']:.4f}",
        share_of_bound=f"{sectors['ms'] / ms:.4f}",
        sectors_per_pixel=f"{sectors['sectors'] / (E * 3030):.2f}",
        sector_bound_ms=f"{sectors['sector_ms']:.4f}",
        share_of_sector_bound=f"{sectors['sector_ms'] / ms:.4f}")
    return res


def forward_outputs(net, size, iters=3):
    """DroidNet.forward on bench_vo2_export's window at ``size``: (1/8-res
    flows, upsampled disparities) of the last step, and the launches."""
    images, poses, intr8 = bench_vo2_export.bench_inputs(size)
    dev = torch.device("cuda")
    args = (torch.from_numpy(poses)[None].to(dev),
            torch.from_numpy(images)[None].to(dev),
            torch.ones((1, 2, size[0] // 8, size[1] // 8), device=dev),
            torch.from_numpy(intr8).to(dev).expand(1, 2, 4))
    cuda_corr.reset_launches()
    with torch.no_grad():
        out = net(*args, [0, 1], [1, 0], num_steps=iters, ret_flow=True,
                  downsample=True, final_only=True)
    torch.cuda.synchronize()
    return out["flows"][-1], out["disps_up"][-1], dict(cuda_corr.LAUNCHES)


def time_export_kernels():
    """K1-K3 as the export calls them (E=2, f32 features, smooth
    coordinates): error against plain, time, plain time and bound. K1
    (three TF32 passes, beside torch.bmm on the same f32 operands) and K2
    at the narrow 30x101, K3 through the indexed entry at 47x156 (three
    TF32 passes, the edges' frames indexed in the kernel)."""
    def line(name, shape, out, ref, fn, plain_fn, library_fn=None):
        err = (out.float() - ref.float()).abs().max().item()
        ms, plain_ms = device_time_ms(fn), device_time_ms(plain_fn, reps=3)
        bound = kernel_bound(name, *shape, C, features="f32")
        extra = {} if library_fn is None else {
            "library_ms": f"{device_time_ms(library_fn):.4f}"}
        log("export", kernel=name, shape="x".join(map(str, shape)),
            features="f32", max_abs_err=f"{err:.3g}", tol=TOL[name],
            ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bound['ms']:.4f}", bound_by=bound["bound_by"],
            share_of_bound=f"{bound['ms'] / ms:.4f}", **extra)
        if not err <= TOL[name]:
            raise AssertionError(f"{name} at {shape}: error {err}")

    shape = (2, 30, 101)
    f1, f2, _ = kernel_inputs(*shape, torch.float32, seed=5)
    coords = torch.from_numpy(kbench.lookup_coords("smooth", *shape)).cuda()
    vol, ref = cuda_corr.build_volumes(f1, f2), \
        cuda_corr.build_volumes_plain(f1, f2)
    check_volume(shape, torch.float32, vol, ref)
    pyr = cuda_corr.pool_pyramid(f2)
    a = f1.reshape(2, -1, C) * cuda_corr.SCALE
    b = torch.nn.functional.pad(
        pyr, (0, 0, 0, vol.shape[-1] - pyr.shape[1])).transpose(1, 2)
    line("build_volumes", shape, vol, ref,
         lambda: cuda_corr.build_volumes(f1, f2),
         lambda: cuda_corr.build_volumes_plain(f1, f2),
         library_fn=lambda: torch.bmm(a, b))
    line("corr_extract", shape, cuda_corr.corr_extract(vol, coords),
         cuda_corr.corr_extract_plain(vol, coords),
         lambda: cuda_corr.corr_extract(vol, coords),
         lambda: cuda_corr.corr_extract_plain(vol, coords))

    shape = (2, 47, 156)
    frames, _, _ = kernel_inputs(*shape, torch.float32, seed=6)
    coords = torch.from_numpy(kbench.lookup_coords("smooth", *shape)).cuda()
    pyr = cuda_corr.lookup_pyramid(frames)
    ii = torch.tensor([0, 1], device="cuda")
    jj = torch.tensor([1, 0], device="cuda")
    line("corr_lookup", shape,
         cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords),
         cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii, jj, coords),
         lambda: cuda_corr.corr_lookup_indexed(frames, pyr, ii, jj, coords),
         lambda: cuda_corr.corr_lookup_indexed_plain(frames, pyr, ii, jj,
                                                     coords))


def run_export():
    """Phase 7: returns {"376x1248": launches per pair, "240x808": ...}."""
    net = tame_net(0, mask_bias=-2.0).cuda().eval()
    time_export_kernels()

    # the kernels against their plain versions, through the forward
    for size, want in (((64, 96), (1, 3, 0)), ((64, 1000), (0, 0, 3))):
        flow, disp, launches = forward_outputs(net, size)
        with plain_kernels():
            flow_ref, disp_ref, plain_launches = forward_outputs(net, size)
        flow_err = (flow - flow_ref).abs().max().item()
        disp_err = (disp - disp_ref).abs().max().item()
        log("export", check="kernels_vs_plain", image="x".join(map(str, size)),
            iters=3, flow_max_abs_err=f"{flow_err:.3g}",
            disp_up_max_abs_err=f"{disp_err:.3g}", tol=EXPORT_TOL,
            flow_max=f"{flow_ref.abs().max().item():.3g}",
            disp_up_max=f"{disp_ref.abs().max().item():.3g}",
            **{f"launches_{k}": v for k, v in launches.items()})
        if tuple(launches.values()) != want or any(plain_launches.values()):
            raise AssertionError(f"export at {size}: launches {launches}, "
                                 f"under plain_kernels {plain_launches}")
        if not (flow_err <= EXPORT_TOL and disp_err <= EXPORT_TOL):
            raise AssertionError(f"export at {size}: the forward with the "
                                 f"kernels disagrees with the plain one")

    per_pair = {}
    for size, pairs, want in ((EXPORT_SIZE, EXPORT_PAIRS, (0, 0, EXPORT_ITERS)),
                              (EXPORT_NARROW, EXPORT_NARROW_PAIRS,
                               (1, EXPORT_ITERS, 0))):
        H, W = size
        tag = f"{H}x{W}"
        # one warm-up pair, then the counts from 0 over the timed pairs
        bench_vo2_export.time_pairs(net, size, EXPORT_ITERS, pairs=1)
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases still hold counts in the peak: read apart
        held = torch.cuda.memory_allocated()
        cuda_corr.reset_launches()
        s_per_pair, (flow8, disp) = bench_vo2_export.time_pairs(
            net, size, EXPORT_ITERS, pairs=pairs)
        launches = dict(cuda_corr.LAUNCHES)
        per_pair[tag] = {k: v // pairs for k, v in launches.items()}
        f32 = dict(cuda_corr.F32_LAUNCHES)
        if any(f32[k] != launches[k] for k in f32):
            raise AssertionError(f"export at {tag}: f32 features launched "
                                 f"{f32} of {launches} on the f32 kernels")
        log("export", image=tag, iters=EXPORT_ITERS, pairs=pairs,
            features="f32", vo2_export_s_per_pair=f"{s_per_pair:.4f}",
            peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            held_before_gib=f"{held / 2**30:.2f}",
            **{f"launches_per_pair_{k}": v for k, v in per_pair[tag].items()},
            gpu=repr(gpu_line()))
        if tuple(launches.values()) != tuple(pairs * n for n in want):
            raise AssertionError(f"export at {tag}: launches {launches} "
                                 f"over {pairs} pairs, expected {want} each")
        h, w = H // 8, W // 8
        if not (flow8.shape == (h, w, 2) and disp.shape == (h, w)
                and flow8.dtype == disp.dtype == np.float32
                and np.isfinite(flow8).all() and np.isfinite(disp).all()):
            raise AssertionError(f"export at {tag}: bad arrays "
                                 f"{flow8.shape} {disp.shape}")

    # where a pair's time goes at full width: K3 per step through the
    # wrapper and as the kernel alone, then one pair under the profiler
    inputs = bench_vo2_export.bench_inputs(EXPORT_SIZE)
    k3_wrapper, k3_kernel = EventTimer(), EventTimer()
    lib = cuda_corr._library()
    with patched(cuda_corr, "corr_lookup_indexed",
                 k3_wrapper.wrap(cuda_corr.corr_lookup_indexed)), \
            patched(lib, "pvo_corr_lookup",
                    k3_kernel.wrap(lib.pvo_corr_lookup)):
        export_pair(net, *inputs, iters=EXPORT_ITERS)
    wrapper = [ms for _, ms in k3_wrapper.ms()]
    kernel = [ms for _, ms in k3_kernel.ms()]
    bound = kernel_bound("corr_lookup", 2, EXPORT_SIZE[0] // 8,
                         EXPORT_SIZE[1] // 8, C, features="f32")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        export_pair(net, *inputs, iters=EXPORT_ITERS)
        torch.cuda.synchronize()
    # kernel rows only: an op's row repeats its kernels' device time;
    # aten rows count nested ops too (conv2d -> convolution -> cudnn)
    rows = prof.key_averages()
    on_card = [r for r in rows
               if r.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(r.self_device_time_total for r in on_card) / 1e3
    kernels = sum(r.count for r in on_card)
    aten_ops = sum(r.count for r in rows if r.key.startswith("aten::"))
    log("export", image=f"{EXPORT_SIZE[0]}x{EXPORT_SIZE[1]}",
        k3_calls=len(wrapper),
        k3_wrapper_ms_per_step=f"{np.mean(wrapper):.4f}",
        k3_kernel_ms_per_step=f"{np.mean(kernel):.4f}",
        k3_bound_ms=f"{bound['ms']:.4f}", k3_bound_by=bound["bound_by"],
        k3_wrapper_ms_per_pair=f"{sum(wrapper):.3f}",
        profiled_device_ms_per_pair=f"{device_ms:.2f}",
        profiled_kernels_per_pair=kernels, aten_ops_per_pair=aten_ops)
    top = sorted(on_card, key=lambda r: -r.self_device_time_total)[:6]
    log("export", top_kernels=repr("; ".join(
        f"{r.key[:56]} {r.self_device_time_total / 1e3:.2f} ms x{r.count}"
        for r in top)))
    if len(wrapper) != EXPORT_ITERS or len(kernel) != EXPORT_ITERS:
        raise AssertionError("K3 did not run once per iteration")
    return per_pair


# ------------------------------------------------------------------ vps

VPS_SMALL, VPS_SIZE, VPS_FRAMES = (128, 192), (375, 1242), 5
# the card against the CPU, the same tamed weights, TF32 off
VPS_SEM_EQUAL, VPS_PAN_EQUAL, VPS_TARGETS_EQUAL = 0.999, 0.995, 0.999
VPS_BOX_TOL, VPS_SCORE_TOL = 1e-2, 1e-4
VPS_LAYERS = ("vps.backbone", "vps.fpn", "vps.fusion", "vps.semseg",
              "vps.rpn", "vps.box_head", "vps.mask_head")
VPS_OPS = ("vps.nms", "vps.roi_align", "vps.splat", "vps.stitch")
VPS_DEVICE = "cuda"


def vps_inputs(hw, n, seed=0):
    """A moving random texture (BGR uint8), a smooth flow (a few px), a
    smooth depth map and w2c poses advancing along z."""
    rng = np.random.RandomState(seed)
    H, W = hw
    base = rng.randint(0, 255, (H + 2 * n, W + 4 * n, 3), np.uint8)
    imgs = [base[t:t + H, 2 * t:2 * t + W].copy() for t in range(n)]
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    flow = np.stack([2 + 3 * np.sin(xx / (W / 8)) + np.cos(yy / (H / 5)),
                     1 + 2 * np.cos(yy / (H / 6))], -1).astype(np.float32)
    depth = (5 + 2 * np.sin(xx / (W / 5)) + 3 * yy / H).astype(np.float32)
    poses = []
    for t in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.02 * t, 0.0, 0.1 * t]
        poses.append(T)
    return imgs, flow, depth, poses


def vps_sequence(pred, data, intr):
    """plain; fusion with flow and depth; fusion with depth_proj."""
    imgs, flow, depth, poses = data
    pred._video_id, pred.depth_proj = None, False
    outs = [pred(imgs[0], video_id="v", pose_w2c=poses[0])]
    outs.append(pred(imgs[1], video_id="v", flow=flow, depth=depth,
                     pose_w2c=poses[1]))
    pred.depth_proj, pred.intrinsics = True, intr
    outs.append(pred(imgs[2], video_id="v", flow=flow, depth=depth,
                     pose_w2c=poses[2]))
    return outs


def same_detections(a, b):
    """Matches every valid detection of ``a`` with one of ``b``: same
    class, box within VPS_BOX_TOL px, score within VPS_SCORE_TOL (the
    order of two detections whose scores tie within rounding is free)."""
    ia, ib = np.flatnonzero(a["valid"]), list(np.flatnonzero(b["valid"]))
    if len(ia) != len(ib):
        return False
    for i in ia:
        hit = [j for j in ib if a["classes"][i] == b["classes"][j]
               and np.abs(a["boxes"][i] - b["boxes"][j]).max() <= VPS_BOX_TOL
               and abs(a["scores"][i] - b["scores"][j]) <= VPS_SCORE_TOL]
        if not hit:
            return False
        ib.remove(hit[0])
    return True


def check_vps_warp(feats_ref, flow, depth, tag):
    """The splat on the card against the CPU on the same inputs: targets
    equal for >= VPS_TARGETS_EQUAL of the pixels of each level, features
    bit-equal at every target no disagreeing source reaches."""
    cpu = pfpn.flow_warp_features(feats_ref, flow, depth)
    dev = torch.device(VPS_DEVICE)
    card = pfpn.flow_warp_features(
        {k: v.to(dev) for k, v in feats_ref.items()}, flow.to(dev),
        None if depth is None else depth.to(dev))
    fl = flow.permute(2, 0, 1)
    worst = 1.0
    for k, f in feats_ref.items():
        h, w = f.shape[2:]
        mine = pfpn.splat_targets(fl.to(dev), (h, w)).cpu().numpy()
        ref = pfpn.splat_targets(fl, (h, w)).numpy()
        same = mine == ref
        worst = min(worst, same.mean())
        bad = np.zeros(h * w + 1, bool)
        bad[mine[~same]] = bad[ref[~same]] = True
        ok = ~bad[:h * w]
        a = card[k][0].reshape(f.shape[1], -1).cpu().numpy()[:, ok]
        b = cpu[k][0].reshape(f.shape[1], -1).numpy()[:, ok]
        if same.mean() < VPS_TARGETS_EQUAL or not np.array_equal(a, b):
            raise AssertionError(f"vps warp ({tag}) at {k}: targets equal "
                                 f"{same.mean():.5f}, features equal where "
                                 f"they agree: {np.array_equal(a, b)}")
    return worst


def vps_card_against_cpu(model):
    """Step 1: the predictor on the card and on the CPU, full R-50 at
    128x192, three frames; and the splat alone on the same inputs."""
    H, W = VPS_SMALL
    data = vps_inputs(VPS_SMALL, 3, seed=1)
    intr = (725.0087 * W / 1242, 725.0087 * W / 1242, W / 2.0, H / 2.0)
    card = pfpn.PanopticPredictor(model, device=VPS_DEVICE)
    cpu = pfpn.PanopticPredictor(model, device="cpu")
    got, want = vps_sequence(card, data, intr), vps_sequence(cpu, data, intr)
    for name, (pan, _, sem, dets), (cpan, _, csem, cdets) in zip(
            ("plain", "fusion_depth", "depth_proj"), got, want):
        sem_eq, pan_eq = (sem == csem).mean(), (pan == cpan).mean()
        same = same_detections(dets, cdets)
        log("vps", card_vs_cpu=name, image=f"{H}x{W}",
            sem_equal=f"{sem_eq:.5f}", pan_equal=f"{pan_eq:.5f}",
            valid_dets=int(dets["valid"].sum()),
            cpu_valid_dets=int(cdets["valid"].sum()), same_dets=same,
            semantic_classes=len(np.unique(sem)))
        if not (sem_eq >= VPS_SEM_EQUAL and pan_eq >= VPS_PAN_EQUAL and same
                and dets["valid"].any()):
            raise AssertionError(f"vps: the card differs from the CPU on "
                                 f"the {name} frame")
    # the splat alone, on the CPU's reference features: frame 1's f16
    # flow and depth, frame 2's reprojected depth
    imgs, flow, depth, poses = data
    cpu._video_id = None
    cpu(imgs[0], video_id="v")
    feats = cpu._prev
    fl = cpu._upload(flow, torch.float16)
    d16 = cpu._upload(depth, torch.float16)
    d_proj = pfpn.pose_transport_depth(torch.from_numpy(depth),
                                       torch.from_numpy(poses[0]),
                                       torch.from_numpy(poses[1]), intr)
    worst = min(check_vps_warp(feats, fl, None, "flow"),
                check_vps_warp(feats, fl, d16, "depth"),
                check_vps_warp(feats, fl, d_proj, "depth_proj"))
    log("vps", splat_card_vs_cpu="flow, depth, depth_proj",
        targets_equal_worst_level=f"{worst:.5f}", features="bit-equal")


def vps_range_key(e):
    """A profiler range's key: a layer's name, or an op's name with the
    layer it ran in (``nms@rpn``, ``nms@box_head``, ``stitch@host``)."""
    if e.name in VPS_LAYERS:
        return e.name[4:]
    p = e.cpu_parent
    while p is not None and p.name not in VPS_LAYERS:
        p = p.cpu_parent
    return f"{e.name[4:]}@{p.name[4:] if p is not None else 'host'}"


def vps_profile(pred, data):
    """One fused frame (device-resident flow and depth) under
    torch.profiler: {range key: [device ms, host ms, kernels]}, and the
    frame's kernels, aten ops and kernel ms."""
    imgs, flow_dev, depth_dev = data
    pred._video_id = None
    pred(imgs[0], video_id="v")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pred(imgs[1], video_id="v", flow=flow_dev, depth=depth_dev)
        torch.cuda.synchronize()
    cpu = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    ranges = {}
    for e in cpu:
        if e.name in VPS_LAYERS + VPS_OPS:
            r = ranges.setdefault(vps_range_key(e), [0.0, 0.0, 0])
            r[0] += e.device_time_total / 1e3
            r[1] += e.cpu_time_total / 1e3
    for e in cpu:
        p = e
        while e.kernels and p is not None:
            if p.name in VPS_LAYERS + VPS_OPS:
                ranges[vps_range_key(p)][2] += len(e.kernels)
            p = p.cpu_parent
    rows = prof.key_averages()
    on_card = [r for r in rows
               if r.device_type == torch.autograd.DeviceType.CUDA
               and not r.key.startswith("vps.")]
    kernel_ms = sum(r.self_device_time_total for r in on_card) / 1e3
    kernels = sum(r.count for r in on_card)
    aten_ops = sum(r.count for r in rows if r.key.startswith("aten::"))
    return ranges, kernels, aten_ops, kernel_ms


def vps_full_width(model):
    """Step 2: 375x1242 (padded 384x1248), f32 then bf16, each mode one
    warm-up and VPS_FRAMES timed frames; then one fused frame profiled."""
    H, W = VPS_SIZE
    imgs, flow, depth, _ = vps_inputs(VPS_SIZE, VPS_FRAMES + 2)
    rng = np.random.RandomState(0)
    dev = torch.device(VPS_DEVICE)
    flows = [flow + rng.uniform(-0.5, 0.5, flow.shape).astype(np.float32)
             for _ in range(4)]
    depths8 = [np.ascontiguousarray(depth[3::8, 3::8]) * (1 + 0.01 * i)
               for i in range(4)]
    data = (imgs, torch.from_numpy(flow).to(dev),
            torch.from_numpy(depth).to(dev))
    modes = {"plain": {}, "fusion": dict(flow=data[1], depth=data[2]),
             "file": dict(files=(flows, depths8))}
    summary = {}
    for dtype in ("f32", "bf16"):
        pred = pfpn.PanopticPredictor(model, bf16=dtype == "bf16", device=dev)
        for mode, inputs in modes.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            s, outs = timed_pass(pred, imgs, VPS_FRAMES, **inputs)
            dets = np.mean([o[3]["valid"].sum() for o in outs])
            inst = np.mean([sum(seg["isthing"] for seg in o[1])
                            for o in outs])
            shapes = {o[0].shape for o in outs}
            summary[dtype, mode] = s / VPS_FRAMES * 1e3
            log("vps", image=f"{H}x{W}", dtype=dtype, mode=mode,
                frames=VPS_FRAMES,
                vps_frames_per_sec=f"{VPS_FRAMES / s:.3f}",
                ms_per_frame=f"{s / VPS_FRAMES * 1e3:.2f}",
                peak_mem_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
                valid_dets_per_frame=f"{dets:.2f}",
                instances_per_frame=f"{inst:.2f}", gpu=repr(gpu_line()))
            if not (dets > 0 and inst > 0 and shapes == {(H, W)}):
                raise AssertionError(f"vps {dtype} {mode}: {dets} detections"
                                     f", {inst} instances, pan {shapes}")
        ranges, kernels, aten_ops, kernel_ms = vps_profile(pred, data)
        # the splat's bound: the reference levels read once, the warped
        # ones written once, the flow and depth read once
        splat_bytes = sum(2 * v.numel() * v.element_size()
                          for v in pred._prev.values()) + H * W * 3 * 4
        log("vps", profiled=f"{dtype} fusion", image=f"{H}x{W}",
            kernel_ms_per_frame=f"{kernel_ms:.2f}",
            kernels_per_frame=kernels, aten_ops_per_frame=aten_ops,
            busy_share=f"{kernel_ms / summary[dtype, 'fusion']:.3f}",
            splat_bound_ms=f"{1e3 * splat_bytes / kbench.HBM_BYTES_S:.4f}")
        layers = [k[4:] for k in VPS_LAYERS]
        log("vps", profiled=f"{dtype} fusion", device_ms_by_layer=repr(
            "; ".join(f"{k} {ranges.get(k, [0.0])[0]:.2f}"
                      for k in layers)))
        log("vps", profiled=f"{dtype} fusion",
            ops_device_ms_host_ms_kernels=repr("; ".join(
                f"{k} {v[0]:.2f}/{v[1]:.2f}/{v[2]}"
                for k, v in sorted(ranges.items()) if k not in layers)))
        del pred
        torch.cuda.empty_cache()


def run_vps():
    """Phase 8: the VPS predictor (Panoptic FPN R-50 with fusion)."""
    t0 = time.perf_counter()
    model = tamed_model(0)
    vps_card_against_cpu(model)
    vps_full_width(model)
    log("vps", seconds=f"{time.perf_counter() - t0:.1f}")


def loop_checkpoints(root):
    """Reference-format checkpoints of the loop's weights: DroidNet under
    DDP ``module.`` names (tame_net with LOOP_HEAD_SCALE and
    LOOP_MASK_BIAS) and Panoptic FPN under ``model`` (tamed_model(0))."""
    vo, vps = osp.join(root, "droid.pth"), osp.join(root, "panFPN.pth")
    net = tame_net(0, scale=LOOP_HEAD_SCALE, mask_bias=LOOP_MASK_BIAS)
    torch.save({f"module.{k}": v for k, v in net.state_dict().items()}, vo)
    torch.save({"model": tamed_model(0).state_dict()}, vps)
    return vo, vps


def loop_stage_counter(rows):
    """run_pvo_loop.run_stage that appends one row a stage to ``rows``:
    iteration (0: the initial segmentation), stage, seconds, peak GiB,
    the corr kernels' launches inside it (LOOP_ROWS) and the segment
    sum's, for test_vo the
    keyframes admitted and removed and the backend's edges, for the VPS
    stages the frames stitched and the host seconds of the stitch."""
    run_stage = run_pvo_loop.run_stage
    removed, kf, edges, stitch = [], [], [], []
    combine = pfpn.combine_panoptic

    def timed_combine(*a, **kw):
        t0 = time.perf_counter()
        out = combine(*a, **kw)
        stitch.append(time.perf_counter() - t0)
        return out

    def launches():
        f32 = cuda_corr.F32_LAUNCHES
        n = {k: cuda_corr.LAUNCHES[k] - f32.get(k, 0)
             for k in cuda_corr.KERNELS}
        return {**n, **{F32_ROWS[k]: v for k, v in f32.items()},
                **cuda_segsum.LAUNCHES, **cuda_dba.LAUNCHES}

    def counted(script, args_list):
        it = sum(r["stage"] == "test_vo" for r in rows) + \
            (script == "test_vo")
        del removed[:], kf[:], edges[:], stitch[:]
        before = launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with vo_counters(removed, edges, kf), \
                patched(pfpn, "combine_panoptic", timed_combine):
            run_stage(script, args_list)
        torch.cuda.synchronize()
        after = launches()
        row = dict(iteration=it if script != "initial_segmentation" else 0,
                   stage=script, seconds=time.perf_counter() - t0,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches={k: after[k] - before[k] for k in after})
        if script == "test_vo":
            row.update(admitted=kf[0] + len(removed), removed=len(removed),
                       keyframes=kf[0], backend_edges=list(edges),
                       removed_ix=list(removed))
        if stitch:
            row.update(stitched_frames=len(stitch), stitch_s=sum(stitch))
        rows.append(row)
        log("loop", **{k: (f"{v:.2f}" if isinstance(v, float) else
                          repr(v) if isinstance(v, (dict, list)) else v)
                       for k, v in row.items()})

    return counted


def check_loop_artifacts(data, shared, n):
    """tests/test_pvo_loop.py's contracts on the loop's files, scaled to
    ``n`` frames: the trajectory (n finite rows), n-1 finite flow and
    depth exports, the val slice's fused maps, the VPQ report, and the
    fused maps fed back into the clone view's panFPN_segm."""
    traj = np.loadtxt(osp.join(shared, "traj", "Scene02", "15-deg-left",
                               "pvo_traj.txt"))
    if traj.shape != (n, 12) or not np.isfinite(traj).all():
        raise AssertionError(f"trajectory {traj.shape}, finite "
                             f"{np.isfinite(traj).all()}")
    for kind in ("full_flow", "depth"):
        files = sorted(glob.glob(osp.join(shared, kind, "Scene02_*.npy")))
        if len(files) != n - 1 or not all(np.isfinite(np.load(f)).all()
                                          for f in files):
            raise AssertionError(f"{kind}: {len(files)} files, or not finite")
    with open(osp.join(data, "Scene02", "clone", "split_511.json")) as f:
        val = json.load(f)["val"]
    pans = sorted(glob.glob(osp.join(shared, "panoptic_segm_fusion",
                                     "inference", "pan_seg",
                                     "Scene02_*.png")))
    names = [f"rgb_{k:05d}.png" for k in val]
    if [osp.basename(p).split("_", 1)[1] for p in pans] != names:
        raise AssertionError(f"fused maps {pans}, val slice {val}")
    with open(osp.join(shared, "vpq", "Scene02", "vpq-final.txt")) as f:
        rep = json.load(f)
    if not {"vpq_all", "vpq_thing", "vpq_stuff"} <= set(rep):
        raise AssertionError(f"vpq report {rep}")
    fed = osp.join(data, "Scene02", "clone", "panFPN_segm")
    for p, name in zip(pans, names):
        with open(p, "rb") as a, open(osp.join(fed, name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"{name} was not fed back")
    return rep


def run_loop():
    """Phase 9: the PVO loop (scripts/run_pvo_loop.py) at full size, two
    iterations, on a synthetic scene written and prepared by the port.
    Returns the corr kernels' launches inside the loop (LOOP_ROWS) and
    the segment sum's."""
    t0 = time.perf_counter()
    n = LOOP_FRAMES
    with tempfile.TemporaryDirectory() as root:
        data, shared = osp.join(root, "vkitti"), osp.join(root, "shared_data")
        write_synth_scene(data, n_frames=n, workers=LOOP_WORKERS)
        t_scene = time.perf_counter() - t0
        # one thread a view: the views are prepared independently
        with ThreadPoolExecutor(len(LOOP_VIEWS)) as pool:
            list(pool.map(lambda view: prepare_vkitti.main(
                ["--datapath", data, "--scenes", "Scene02", "--views", view,
                 "--device", "cuda"]), LOOP_VIEWS))
        vo, vps = loop_checkpoints(root)
        log("loop", frames=n, views=",".join(LOOP_VIEWS),
            scene_s=f"{t_scene:.2f}",
            prepared_s=f"{time.perf_counter() - t0 - t_scene:.2f}",
            head_scale=LOOP_HEAD_SCALE, mask_bias=LOOP_MASK_BIAS)
        rows = []
        with patched(run_pvo_loop, "run_stage", loop_stage_counter(rows)):
            run_pvo_loop.main(["--datapath", data, "--scenes", "Scene02",
                               "--iters", str(LOOP_ITERS), "--shared_data",
                               shared, "--weights_vo", vo, "--weights_vps",
                               vps, "--device", "cuda"])
        rep = check_loop_artifacts(data, shared, n)
    total = {k: sum(r["launches"][k] for r in rows)
             for k in (*LOOP_ROWS, "segsum", *cuda_dba.KERNELS,
                       cuda_dba.GRID)}
    export = [{k: r["launches"][k] for k in LOOP_ROWS}
              for r in rows if r["stage"] == "test_vo2"]
    per_export = {"build_volumes": 0, "corr_extract": 0, "corr_lookup": 0,
                  "build_volumes_f32": 0,
                  "corr_lookup_f32": (n - 1) * EXPORT_ITERS}
    log("loop", iterations=LOOP_ITERS, launches=repr(total),
        vo2_launches=repr(export), vpq=repr({k: round(rep[k], 4) for k in
                                             ("vpq_all", "vpq_thing",
                                              "vpq_stuff")}),
        seconds=f"{time.perf_counter() - t0:.1f}")
    missing = [k for k in (*LOOP_ROWS, *cuda_dba.KERNELS)
               if k != "build_volumes_f32" and total[k] == 0]
    if missing or export != [per_export] * LOOP_ITERS:
        raise AssertionError(f"loop launches {total}, never launched "
                             f"{missing}; test_vo2 {export}")
    # B5: the iterations' test_vo run on equal inputs (J2), so with the
    # fixed-order sums they make the same keyframe decisions
    vo_runs = [{k: r[k] for k in ("admitted", "removed_ix", "keyframes",
                                  "backend_edges")}
               for r in rows if r["stage"] == "test_vo"]
    log("loop", check="test_vo_repeats", equal=vo_runs[0] == vo_runs[1])
    if vo_runs[0] != vo_runs[1]:
        raise AssertionError(f"the two test_vo runs differ: {vo_runs}")
    return total


def corr_launches():
    """Every corr kernel's launch count by row of the kernels line: K1
    and K3 split by feature type, K2, P1 and P2."""
    out = kbench.launch_counts()
    for k in ("segsum", *cuda_dba.KERNELS):
        del out[k]
    return out


def reset_corr_launches():
    """Sets the corr kernels' counts, the segment sum's and the DBA
    kernels' to 0."""
    cuda_corr.reset_launches()
    cuda_corr_exp.reset_launches()
    cuda_segsum.reset_launches()
    cuda_dba.reset_launches()


def train_card_against_cpu():
    """Phase 10 (a): one restart pass (sup, 48x64, F=4, 2 iterations) on
    the same weights and batch on the CPU and on the card, there with
    cuDNN on (what training runs) and off (PyTorch's own CUDA
    convolutions): the loss within TRAIN_LOSS_TOL relative, every weight
    tensor's gradient above 1e-4 of the total norm within TRAIN_GRAD_TOL
    relative L2 of the CPU's. With cuDNN's weight gradients in fnet's
    instance-normed convolutions (before B4's fix, vo/net/layers.py
    NormedConv2d) fnet's first residual layers read 4.45e-3."""
    batch = dp.make_synthetic_batch(1, F=4, H=48, W=64, seed=0)
    lp, gp = fault_probe.vo_pass(tame_net(0, mask_bias=-2.0).train(), "cpu",
                                 batch)
    total = float(torch.sqrt(sum((g ** 2).sum() for g in gp.values())))
    net = tame_net(0, mask_bias=-2.0).cuda().train()
    ok = True
    for tag, cudnn in (("cudnn_on", True), ("cudnn_off", False)):
        with patched(torch.backends.cudnn, "enabled", cudnn):
            lc, gc = fault_probe.vo_pass(net, "cuda", batch)
        errs = fault_probe.rel_errors(gc, gp, total)
        worst = max(errs, key=errs.get)
        loss_rel = abs(lc - lp) / abs(lp)
        log("train", check=f"card_vs_cpu_{tag}", loss_cuda=f"{lc:.6f}",
            loss_cpu=f"{lp:.6f}", loss_rel_err=f"{loss_rel:.3g}",
            tensors=len(errs), grad_worst_rel_l2=f"{errs[worst]:.3g}",
            worst=worst)
        ok &= (loss_rel <= TRAIN_LOSS_TOL and len(errs) >= 60
               and errs[worst] <= TRAIN_GRAD_TOL)
    if not ok:
        raise AssertionError("the card's gradients disagree with the CPU's")


def train_default():
    """Phase 10 (b): bench_train_vo's default protocol (sup, 4
    iterations, 48x64, F=4, TRAIN_DEFAULT_STEPS steps on one batch,
    random weights from seed 0). Finite losses, a bit-equal checkpoint
    round trip, and the canary on the dynamic-mask BCE (gt_l, which the
    model can fit): its last tenth below half its first tenth. The total
    loss's ratio is printed, not held: on these weights the curve is
    chaotic and the JAX bench's canary a coin toss, in the JAX package
    too (bench_train_vo's docstring)."""
    res = bench_train_vo.default_protocol(steps=TRAIN_DEFAULT_STEPS,
                                          device="cuda")
    finite = bool(np.isfinite(res["loss_curve"]).all())
    learned = res["canary_ok"]
    log("train", protocol="default", steps=TRAIN_DEFAULT_STEPS,
        steps_per_sec=f"{res['steps_per_sec']:.3f}",
        first_step_s=f"{res['first_step_s']:.2f}",
        loss_first10pct=f"{res['loss_first10pct']:.4f}",
        loss_last10pct=f"{res['loss_last10pct']:.4f}",
        vo_train_loss_ratio=f"{res['value']:.4f}",
        gt_l_first10pct=f"{res['gt_l_first10pct']:.4g}",
        gt_l_last10pct=f"{res['gt_l_last10pct']:.4g}",
        peak_mem_gib=f"{res['peak_mem_gib']:.3f}",
        ckpt_roundtrip_ok=res["ckpt_roundtrip_ok"], finite=finite)
    if not (finite and learned and res["ckpt_roundtrip_ok"]):
        raise AssertionError(f"default protocol: finite {finite}, gt_l "
                             f"learned {learned}, checkpoint "
                             f"{res['ckpt_roundtrip_ok']}")


def lookup_fwd_bwd_ms(F=6, h=25, w=50, iters=15, reps=3):
    """The plain correlation lookup as a recipe pass runs it, alone:
    the pyramid of the ring's edges, ``iters`` lookups and their
    backward, f32, CUDA events; the mean of ``reps`` runs in ms."""
    ii, jj = train_vo.ring_edges(F)
    rng = np.random.RandomState(0)
    fmaps = torch.tensor(rng.randn(F, h, w, C), dtype=torch.float32,
                         device="cuda", requires_grad=True)
    grid = torch.stack(torch.meshgrid(
        torch.arange(w, device="cuda", dtype=torch.float32),
        torch.arange(h, device="cuda", dtype=torch.float32),
        indexing="xy"), -1)
    coords = grid + torch.tensor(rng.randn(len(ii), h, w, 2),
                                 dtype=torch.float32, device="cuda")
    ii_t = torch.as_tensor(ii, device="cuda")
    jj_t = torch.as_tensor(jj, device="cuda")

    def run():
        pyr = corr_plain.build_pyramid(fmaps[ii_t], fmaps[jj_t])
        out = sum(corr_plain.lookup(pyr, coords).square().mean()
                  for _ in range(iters))
        out.backward()

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def train_profile(trainer, batch, remat_off):
    """Phase 10 (c): one pass + optimizer step of the recipe on
    ``batch``, timed (wall, synchronized), then under torch.profiler
    (kernel ms, busy share, top kernels), its peak memory, and the same
    pass's peak memory with remat off (``remat_off``: a trainer of the
    same weights)."""
    _, pass_fn, apply_fn, _, state = trainer
    b = dp.to_device(batch, "cuda")

    def one():
        _, _, grads, _ = pass_fn(b, b["poses_init"], b["disps_init"])
        apply_fn(state, grads)

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 2 ** 30

    peak_remat = peak(one)
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profiled() as prof:
        one()
        torch.cuda.synchronize()
    kernel_ms, n_kernels = kernel_rows(prof)
    rows = sorted((r for r in kbench.averages(prof)
                   if r.device_type == torch.autograd.DeviceType.CUDA
                   and not r.key.startswith(RANGE_PREFIXES)),
                  key=lambda r: -r.self_device_time_total)[:5]
    _, pass_off, _, _, _ = remat_off
    peak_off = peak(lambda: pass_off(b, b["poses_init"], b["disps_init"]))
    lookup_ms = lookup_fwd_bwd_ms()
    log("train", step="profiled", wall_ms=f"{wall_ms:.1f}",
        kernel_ms=f"{kernel_ms:.1f}", kernels=n_kernels,
        busy_share=f"{kernel_ms / wall_ms:.3f}",
        peak_mem_gib_remat=f"{peak_remat:.3f}",
        peak_mem_gib_no_remat=f"{peak_off:.3f}",
        plain_lookup_fwd_bwd_ms=f"{lookup_ms:.1f}",
        plain_lookup_share_of_kernel_ms=f"{lookup_ms / kernel_ms:.3f}")
    for r in rows:
        log("train", top_kernel=repr(r.key[:90]),
            ms=f"{r.self_device_time_total / 1e3:.2f}", count=r.count)


def train_recipe():
    """Phase 10 (c): the reference recipe at full size (semisup, 15
    iterations, 6 frames, 200x400 crop, the restart loop, remat) on the
    synthetic scene, TRAIN_RECIPE_STEPS outer steps: finite losses and
    gradients; s/step, grad passes/s, peak memory; then one profiled
    step (train_profile)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = bench_train_vo.synth_dataset_root(osp.join(tmp, "recipe"))
        t_scene = time.perf_counter() - t0
        db = bench_train_vo.recipe_db(root)
        dev = torch.device("cuda")
        trainer = bench_train_vo.recipe_trainer(dev)
        torch.cuda.reset_peak_memory_stats()
        with bench_train_vo.clip_feeder(db) as next_batch:
            curves, passes, t_first, t_rest = bench_train_vo.run_recipe(
                next_batch, trainer, TRAIN_RECIPE_STEPS, dev,
                np.random.default_rng(7), check_grads=True, log_every=0)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            batch = next_batch()
        losses = np.asarray(curves["loss"])
        steps = TRAIN_RECIPE_STEPS - 1
        log("train", protocol="recipe", steps=TRAIN_RECIPE_STEPS,
            scene_s=f"{t_scene:.1f}", first_step_s=f"{t_first:.2f}",
            s_per_step=f"{t_rest / steps:.3f}",
            grad_passes_per_sec=f"{sum(passes[1:]) / t_rest:.3f}",
            grad_passes=sum(passes), peak_mem_gib=f"{peak_gib:.3f}",
            loss_first=f"{losses[0]:.3f}", loss_last=f"{losses[-1]:.3f}",
            res_first=f"{curves['res'][0]:.3f}",
            res_last=f"{curves['res'][-1]:.3f}")
        if not np.isfinite(losses).all():
            raise AssertionError(f"recipe losses not finite: {losses}")
        off = bench_train_vo.recipe_trainer(
            dev, remat=False, model=copy.deepcopy(trainer[0]))
        train_profile(trainer, batch, off)


def run_train():
    """Phase 10: VO training on the card. Returns the launches in (b) and
    (c) of the corr kernels, which must all be 0 (training runs the plain
    lookup, the kernels have no backward), and of the segment sum
    (GraphAgg's forward)."""
    train_card_against_cpu()
    reset_corr_launches()
    train_default()
    train_recipe()
    launches = corr_launches()
    log("train", launches=repr(launches),
        segsum_launches=cuda_segsum.LAUNCHES["segsum"])
    if any(launches.values()) or any(cuda_dba.LAUNCHES.values()):
        raise AssertionError(f"training launched corr or DBA kernels: "
                             f"{launches} {cuda_dba.LAUNCHES}")
    return dict(launches, **cuda_segsum.LAUNCHES, **cuda_dba.LAUNCHES)


def vps_train_card_against_cpu():
    """Phase 11 (a): the full and the fusion loss of vps/train.py at 64x96
    on the R-50 Panoptic FPN (random weights from seed 0, the RPN
    subsample on fixed priorities), card against CPU, with cuDNN on (what
    training runs) and off: the loss within VPS_LOSS_TOL relative, every
    tensor's gradient above 1e-4 of the total norm within VPS_GRAD_TOL
    relative L2 (fault_probe.vps_card_errors)."""
    ok = True
    for mode in ("full", "fusion"):
        for cudnn, (loss_rel, errs) in fault_probe.vps_card_errors(
                mode).items():
            worst = max(errs, key=errs.get)
            log("vps_train", check=f"card_vs_cpu_{mode}", cudnn=cudnn,
                loss_rel_err=f"{loss_rel:.3g}", tensors=len(errs),
                grad_worst_rel_l2=f"{errs[worst]:.3g}", worst=worst)
            ok &= (loss_rel <= VPS_LOSS_TOL and len(errs) >= 60
                   and errs[worst] <= VPS_GRAD_TOL)
    if not ok:
        raise AssertionError("the card's VPS gradients disagree with the "
                             "CPU's")


def vps_train_benches():
    """Phase 11 (b): bench_train_vps's fusion finetune (64x96, 150
    steps; the last loss below 0.9 of the first) and bench_vps_train's
    full model (R-50 at 384x1248, VPS_FULL_STEPS steps; finite losses
    that fall), with steps/s and peak memory."""
    fus = bench_train_vps.fusion_protocol(device="cuda")
    log("vps_train", protocol="fusion", steps=150,
        vps_fusion_train_loss_ratio=f"{fus['value']:.4f}",
        loss_initial=f"{fus['loss_initial']:.3f}",
        loss_final=f"{fus['loss_final']:.3f}",
        steps_per_sec=f"{fus['steps_per_sec']:.3f}",
        first_step_s=f"{fus['first_step_s']:.2f}",
        peak_mem_gib=f"{fus['peak_mem_gib']:.3f}")
    full = bench_vps_train.full_protocol(VPS_FULL_STEPS, "cuda")
    log("vps_train", protocol="full", steps=VPS_FULL_STEPS,
        vps_train_steps_per_sec=f"{full['value']:.3f}",
        ms_per_step=f"{full['ms_per_step']:.1f}",
        init_s=f"{full['init_s']:.2f}",
        first_step_s=f"{full['first_step_s']:.2f}",
        first_step_loss=f"{full['first_step_loss']:.3f}",
        loss_first=f"{full['loss_first']:.3f}",
        loss_last=f"{full['loss_last']:.3f}",
        peak_mem_gib=f"{full['peak_mem_gib']:.3f}")
    if not fus["loss_final"] < 0.9 * fus["loss_initial"]:
        raise AssertionError(f"fusion finetune: {fus['loss_curve']}")
    bench_vps_train.check(full)


def vps_train_profile():
    """Phase 11 (c): one full step at 384x1248 timed (wall, synchronized)
    and under torch.profiler: kernel ms, launches, busy share, the five
    costliest kernels."""
    step, state, batch, _ = bench_vps_train.full_setup("cuda")
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profiled() as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    kernel_ms, n_kernels = kernel_rows(prof)
    log("vps_train", step="profiled", wall_ms=f"{wall_ms:.1f}",
        kernel_ms=f"{kernel_ms:.1f}", kernels=n_kernels,
        busy_share=f"{kernel_ms / wall_ms:.3f}")
    rows = sorted((r for r in kbench.averages(prof)
                   if r.device_type == torch.autograd.DeviceType.CUDA
                   and not r.key.startswith(RANGE_PREFIXES)),
                  key=lambda r: -r.self_device_time_total)[:5]
    for r in rows:
        log("vps_train", top_kernel=repr(r.key[:90]),
            ms=f"{r.self_device_time_total / 1e3:.2f}", count=r.count)


def run_vps_train():
    """Phase 11: VPS training on the card. Returns the launches in (b)
    and (c) of the corr kernels, which must all be 0 (VPS reaches none),
    and of the segment sum."""
    t0 = time.perf_counter()
    vps_train_card_against_cpu()
    reset_corr_launches()
    vps_train_benches()
    vps_train_profile()
    launches = corr_launches()
    log("vps_train", launches=repr(launches),
        segsum_launches=cuda_segsum.LAUNCHES["segsum"],
        seconds=f"{time.perf_counter() - t0:.1f}")
    if any(launches.values()) or any(cuda_dba.LAUNCHES.values()):
        raise AssertionError(f"VPS training launched corr or DBA kernels: "
                             f"{launches} {cuda_dba.LAUNCHES}")
    return dict(launches, **cuda_segsum.LAUNCHES, **cuda_dba.LAUNCHES)


def demo_inputs(root):
    """Phase 13's inputs under ``root``: the synthetic scene's frames as
    PNGs in ``images/``, ``calib.txt`` (vkitti's intrinsics) and the
    loop's tamed weights under the reference key names."""
    import cv2
    write_synth_scene(root, scene="Scene02", views=("clone",),
                      n_frames=DEMO_FRAMES, workers=LOOP_WORKERS)
    images = osp.join(root, "images")
    os.makedirs(images)
    jpgs = sorted(glob.glob(osp.join(root, "Scene02", "clone", "frames",
                                     "rgb", "Camera_0", "*.jpg")))

    def to_png(f):
        name = osp.basename(f)[:-4] + ".png"
        cv2.imwrite(osp.join(images, name), cv2.imread(f))

    with ThreadPoolExecutor(LOOP_WORKERS) as pool:
        list(pool.map(to_png, jpgs))
    calib = osp.join(root, "calib.txt")
    np.savetxt(calib, VKITTI_INTRINSICS[None], delimiter=" ")
    weights = osp.join(root, "droid.pth")
    net = tame_net(0, LOOP_HEAD_SCALE, LOOP_MASK_BIAS)
    torch.save({f"module.{k}": v for k, v in net.state_dict().items()},
               weights)
    return images, calib, weights


def fetch(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}",
                                timeout=30) as r:
        return r.read()


def demo_subprocess(images, calib, weights, cwd):
    """The demo CLI as a user runs it (``--stride 1 --vis --live``):
    the page and ``state.json`` fetched while it holds its final state,
    then its standard input closed. Returns (its JSON line, the page,
    the state)."""
    port = dp.free_port()
    cmd = [sys.executable, "-m", "pvo_tpu_torch.scripts.demo", "--imagedir",
           images, "--calib", calib, "--stride", "1", "--vis", "--live",
           str(port), "--weights", weights]
    env = dict(os.environ, PYTHONPATH=osp.dirname(osp.abspath(__file__)))
    out, page, state = None, None, None
    with open(osp.join(cwd, "demo.stderr"), "w") as err, subprocess.Popen(
            cmd, cwd=cwd, env=env, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=err, text=True) as proc:
        try:
            for line in proc.stdout:
                log("demo", stdout=repr(line.strip()[:200]))
                if line.startswith("{"):
                    out = json.loads(line)
                if line.startswith("live viewer holding"):
                    page = fetch(port, "")
                    state = json.loads(fetch(port, "state.json"))
                    proc.stdin.close()
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
    if rc != 0 or out is None or state is None:
        with open(osp.join(cwd, "demo.stderr")) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"the demo failed (exit {rc}):\n{tail}")
    return out, page, state


def demo_video_card_against_cpu(images, calib, weights):
    """The demo's path in this process on the same frames (the card),
    then ``consistent_points`` on the card against the CPU on a copy of
    the same video buffers: at least DEMO_MASK_EQUAL of the masks equal,
    the points within DEMO_POINT_TOL where both keep a pixel."""
    frames = list(demo.image_stream(images, calib, 1))
    H, W = frames[0][1].shape[:2]
    sysm = VOSystem(VOConfig(image_size=(H, W)), weights_path=weights)
    track_s = demo.track(sysm, frames)
    sysm.terminate(iter(frames))
    v = sysm.video
    cpu = DepthVideo(image_size=(v.ht, v.wd), buffer=v.buffer)
    cpu.counter = v.counter
    for name in ("poses", "disps", "images", "intrinsics"):
        getattr(cpu, name).copy_(getattr(v, name).cpu())
    pts_c, masks_c, _ = consistent_points(v)
    pts_h, masks_h, _ = consistent_points(cpu)
    masks_c = masks_c.cpu()
    equal = float((masks_c == masks_h).float().mean())
    both = masks_c & masks_h
    err = float((pts_c.cpu()[both] - pts_h[both]).abs().max()) \
        if bool(both.any()) else 0.0
    log("demo", check="pointcloud_card_vs_cpu", keyframes=v.counter,
        masks_equal=f"{equal:.6f}", kept=int(both.sum()),
        points_max_abs_err=f"{err:.3g}",
        in_process_frames_per_sec=f"{len(frames) / track_s:.3f}")
    if not (equal >= DEMO_MASK_EQUAL and err <= DEMO_POINT_TOL and
            int(both.sum()) > 0):
        raise AssertionError(f"filtered_pointcloud: masks {equal}, "
                             f"points {err}")


def run_demo():
    """Phase 13: the image-directory demo (scripts/demo.py) on DEMO_FRAMES
    of the synthetic scene at 375x1242 (240x800 after its resize), weights
    of tame_net(0, LOOP_HEAD_SCALE, LOOP_MASK_BIAS) passed with --weights,
    as a subprocess with --stride 1 --vis --live. Held: one finite pose a
    frame, a non-empty cloud, state.json's counter the keyframe count,
    the viewer's page; K1, K2, the f32 K3 and the segment sum launched
    (the demo's own counts); the visualizer's masks and points on the card
    against the CPU. Returns the demo's launches by kernels-line row."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        images, calib, weights = demo_inputs(tmp)
        t_inputs = time.perf_counter() - t0
        run = osp.join(tmp, "run")
        os.makedirs(run)
        out, page, state = demo_subprocess(images, calib, weights, run)
        traj = np.loadtxt(osp.join(run, "demo_traj.txt"))
        with open(osp.join(run, "viz", "cloud.ply")) as f:
            vertices = next(int(line.split()[-1]) for line in f
                            if line.startswith("element vertex"))
        log("demo", image_size=repr(out["image_size"]),
            frames=out["frames"], keyframes=out["keyframes"],
            frames_per_sec=f"{out['frames_per_sec']:.3f}",
            terminate_s=f"{out['terminate_s']:.3f}",
            cloud_points=out["cloud_points"], ply_vertices=vertices,
            viewer_update_ms=f"{out['viewer_update_ms']:.1f}",
            state_counter=state["counter"], state_points=len(state["points"]),
            launches=repr(out["launches"]), inputs_s=f"{t_inputs:.1f}")
        ok = (traj.shape == (DEMO_FRAMES, 7) and np.isfinite(traj).all()
              and out["cloud_points"] > 0 and vertices > 0
              and state["counter"] == out["keyframes"]
              and b"webgl" in page and out["image_size"] == [240, 800])
        if not ok:
            raise AssertionError(f"demo artifacts: traj {traj.shape}, "
                                 f"finite {np.isfinite(traj).all()}, {out}")
        idle = [k for k in DEMO_ROWS if not out["launches"][k]]
        if idle:
            raise AssertionError(f"the demo launched no {idle}")
        demo_video_card_against_cpu(images, calib, weights)
    log("demo", seconds=f"{time.perf_counter() - t0:.1f}")
    return out["launches"]


def max_param_diff(a, b):
    return max(float((x.float() - b[k].float()).abs().max())
               for k, x in a.items() if x.numel())


def two_dp_runs(run_one, run_dp):
    """The one-card run, the data-parallel run and the one-card run
    again, each from the same weights: returns the max |d| of the
    parameters dp vs one card and one card vs itself (the card's own
    floor), and the s/step of each run."""
    p1, s1 = run_one()
    p2, s2 = run_dp()
    p3, s3 = run_one()
    return max_param_diff(p2, p1), max_param_diff(p3, p1), (s1, s2, s3)


def state_of(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def dp_vo_recipe(mesh):
    """Phase 14 (a), VO: the recipe (semisup, 15 iterations, 6 frames,
    200x400, restart loop, remat) for DP_STEPS outer steps on the same
    clips and restart draws, through the one-card steps and through the
    data-parallel steps over ``mesh``."""
    with tempfile.TemporaryDirectory() as tmp:
        root = bench_train_vo.synth_dataset_root(osp.join(tmp, "recipe"),
                                                 n_frames=DP_SCENE_FRAMES)
        db = bench_train_vo.recipe_db(root)
        batches = [{k: v[None] for k, v in db.sample_clip().items()
                    if k != "segments"} for _ in range(DP_STEPS)]

    def run(use_mesh):
        trainer = bench_train_vo.recipe_trainer(mesh.device,
                                                mesh=use_mesh)
        rng = (dp.restart_rng(7, use_mesh) if use_mesh
               else np.random.default_rng(7))
        it = iter(batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, passes, _, _ = bench_train_vo.run_recipe(
            lambda: next(it), trainer, DP_STEPS, mesh.device, rng,
            log_every=0)
        return state_of(trainer[0]), (time.perf_counter() - t0) / DP_STEPS

    return two_dp_runs(lambda: run(None), lambda: run(mesh))


def dp_vps_full(mesh):
    """Phase 14 (a), VPS: the full step (R-50 at 384x1248, 8 padded GT
    instances, tamed weights) for DP_STEPS steps through
    make_full_train_step (the step without a process group) and through
    make_full_train_step_dp over ``mesh``."""
    def run(use_mesh):
        step, state, batch, _ = bench_vps_train.full_setup("cuda")
        model, tx = state.model, state.tx
        if use_mesh:
            step = vps_train_mod.make_full_train_step_dp(model, tx, use_mesh)
            batch = {k: v[None] for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DP_STEPS):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        return state_of(model), (time.perf_counter() - t0) / DP_STEPS

    return two_dp_runs(lambda: run(None), lambda: run(mesh))


def dp_default_rank(mesh, steps):
    """Phase 14 (b), in each spawned rank (and in this process with one
    mesh of its own): bench_train_vo's default protocol (sup, 4
    iterations, 48x64, F=4) on its slice of a global batch of 2, on
    tame_net(0, mask_bias=-2) weights, under the deterministic switches.
    Returns the parameters and the first step's applied gradient (numpy;
    the gradient as the optimizer takes it: after the all-reduce, before
    its clip), the per-step times and the kernel launches."""
    reset_corr_launches()
    model = tame_net(0, mask_bias=-2.0)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    seen, apply = [], dp.Optimizer.step

    def recorded(tx):
        if not seen:
            seen.append({n: (p.grad if p.grad is not None else
                             torch.zeros_like(p)).detach().cpu().numpy()
                         for n, p in zip(names, tx.params)})
        apply(tx)

    dp.Optimizer.step = recorded
    try:
        with deterministic():
            out = bench_train_vo.default_protocol(
                steps=steps, device="cuda", model=model, mesh=mesh, batch=2)
    finally:
        dp.Optimizer.step = apply
    return {"params": {k: v.detach().cpu().numpy()
                       for k, v in model.state_dict().items()},
            "grads": seen[0],
            "first_step_s": out["first_step_s"],
            "steps_per_sec": out["steps_per_sec"],
            "loss_curve": out["loss_curve"],
            "launches": dict(corr_launches(), **cuda_segsum.LAUNCHES,
                         **cuda_dba.LAUNCHES)}


def grad_rel_l2(got, want):
    """The largest relative L2 distance of ``got``'s tensors from
    ``want``'s, each tensor's norm floored at 1e-4 of the whole
    gradient's; returns (distance, its tensor's name)."""
    if got.keys() != want.keys():
        return float("inf"), "keys differ"
    total = np.sqrt(sum((v.astype(np.float64) ** 2).sum()
                        for v in want.values()))
    return max((float(np.linalg.norm(got[k].astype(np.float64) - v) /
                      max(np.linalg.norm(v.astype(np.float64)),
                          1e-4 * total)), k) for k, v in want.items())


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations (a warning where an op has none), restored after."""
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.backends.cudnn.benchmark = flags[1]
        torch.use_deterministic_algorithms(flags[2], warn_only=flags[3])


def run_dp():
    """Phase 14: data-parallel training (parallel/data_parallel.py,
    vps/train.py make_full_train_step_dp). (a) NCCL at world size 1 in
    this process: the VO recipe and the VPS full step through the
    data-parallel steps against the one-card steps, DP_STEPS optimizer
    steps from the same weights on the same batches: parameters
    bit-equal, and the one-card run repeated gives the card's own floor
    beside it; (b) two gloo ranks on the one card (NCCL refuses two ranks
    on one card) at the default protocol's size, global batch 2, against
    one process on the same two samples, both under the deterministic
    switches: the ranks bit-equal to each other, the first step's
    applied gradient within DP_GRAD_TOL relative L2 of one process's in
    every tensor, and after DP_STEPS steps at least DP_EQUAL of the
    parameters within 1e-6 and all within DP_TOL. Returns the launches (this
    process's and the ranks')."""
    t0 = time.perf_counter()
    reset_corr_launches()
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(dp.free_port()))
    try:
        mesh = dp.make_mesh("cuda")
        backend = torch.distributed.get_backend()
        with deterministic():
            vo = dp_vo_recipe(mesh)
            vps = dp_vps_full(mesh)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            os.environ.pop(key, None)
    ok = True
    for name, (d_dp, d_floor, secs) in (("vo_recipe", vo), ("vps_full", vps)):
        log("dp", check=f"world1_{name}", backend=backend, steps=DP_STEPS,
            params_max_abs_dp_vs_one=f"{d_dp:.3g}",
            params_max_abs_one_vs_one=f"{d_floor:.3g}",
            s_per_step_one=f"{secs[0]:.3f}", s_per_step_dp=f"{secs[1]:.3f}",
            s_per_step_one_again=f"{secs[2]:.3f}")
        ok &= d_dp <= DP_FLOOR_FACTOR * d_floor
    launches = dict(corr_launches(), **cuda_segsum.LAUNCHES,
                         **cuda_dba.LAUNCHES)

    t1 = time.perf_counter()
    two = dp.spawn(dp_default_rank, 2, (DP_STEPS,), device="cuda",
                   backend="gloo", share_card=True, timeout=600)
    t_two = time.perf_counter() - t1
    one = dp_default_rank(dp.Mesh(device=torch.device("cuda")), DP_STEPS)
    for r in two:
        for k, n in r["launches"].items():
            launches[k] += n
    launches = {k: v + one["launches"][k] for k, v in launches.items()}
    ranks_equal = all(np.array_equal(v, two[1]["params"][k])
                      for k, v in two[0]["params"].items())
    d = np.concatenate([np.abs(two[0]["params"][k].astype(np.float64) -
                               v).ravel() for k, v in one["params"].items()])
    equal_share = float((d <= 1e-6).mean())
    grad_err, grad_at = grad_rel_l2(two[0]["grads"], one["grads"])
    log("dp", check="gloo_two_ranks_one_card", steps=DP_STEPS,
        ranks_bit_equal=ranks_equal,
        first_grad_rel_l2_max=f"{grad_err:.3g}", first_grad_worst=grad_at,
        grad_tensors=len(one["grads"]),
        params_within_1em6=f"{equal_share:.6f}",
        params_max_abs=f"{d.max():.3g}",
        loss_two=repr([round(x, 6) for x in two[0]["loss_curve"]]),
        loss_one=repr([round(x, 6) for x in one["loss_curve"]]),
        first_step_s_two=f"{two[0]['first_step_s']:.3f}",
        s_per_step_two=f"{1 / two[0]['steps_per_sec']:.3f}",
        first_step_s_one=f"{one['first_step_s']:.3f}",
        s_per_step_one=f"{1 / one['steps_per_sec']:.3f}",
        spawn_s=f"{t_two:.1f}")
    log("dp", launches=repr(launches),
        seconds=f"{time.perf_counter() - t0:.1f}")
    ok &= (ranks_equal and grad_err <= DP_GRAD_TOL
           and equal_share >= DP_EQUAL and d.max() <= DP_TOL)
    if not ok:
        raise AssertionError("the data-parallel steps disagree with the "
                             "one-card steps")
    return launches


def non_finite(obj, path="out"):
    """The paths of the non-finite numbers in a CLI's returned value
    (None, the CPU's marker of a device field, is not a number)."""
    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in non_finite(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in non_finite(v, f"{path}[{i}]")]
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return [] if math.isfinite(obj) else [path]
    return []


def run_tool(name, argv):
    """``main(argv + --device cuda)`` of the CLI ``name``, its printing
    kept and shown only if it fails; raises on a non-finite number in
    what it returns. Returns (its value, seconds)."""
    module = globals()[name]
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = module.main(argv + ["--device", "cuda"])
    except BaseException:
        print(buf.getvalue()[-6000:], file=sys.stderr)
        raise
    bad = non_finite(out)
    if bad:
        print(buf.getvalue()[-6000:], file=sys.stderr)
        raise AssertionError(f"{name} returned non-finite numbers: {bad}")
    # the CLI's systems and their CUDA graphs freed before the next one
    gc.collect()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_trace_track(argv=TOOLS_TRACE_ARGV):
    """``python -m pvo_tpu_torch.scripts.trace_track`` with ``argv`` on
    the card, as a process of its own: its JSON last line and seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pvo_tpu_torch.scripts.trace_track",
         *argv, "--device", "cuda"], capture_output=True,
        text=True, timeout=600)
    if proc.returncode:
        print(proc.stdout[-6000:], proc.stderr[-6000:], file=sys.stderr)
        raise AssertionError(f"trace_track exited {proc.returncode}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = non_finite(out)
    if bad:
        raise AssertionError(f"trace_track returned non-finite numbers: "
                             f"{bad}")
    return out, time.perf_counter() - t0


def frame_flops_card_against_cpu():
    """Phase 15: trace_track's planner frame counted at TOOLS_FLOP_HW on
    the card and on the CPU, the CPU's frame forced through the card's
    sections: the FLOPs must be equal."""
    H, W = TOOLS_FLOP_HW
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        card = trace_track.run(TOOLS_FLOP_HW, TOOLS_FLOP_WARM, 0, "cuda")
        cpu = trace_track.run(TOOLS_FLOP_HW, TOOLS_FLOP_WARM, 0, "cpu",
                              sections=card["sections"])
    log("tools", check="frame_flops_card_vs_cpu", size=f"{H}x{W}",
        card_gflop=f"{card['frame_gflop']:.6f}",
        cpu_gflop=f"{cpu['frame_gflop']:.6f}",
        sections=repr(card["sections"]),
        seconds=f"{time.perf_counter() - t1:.1f}")
    if card["frame_gflop"] != cpu["frame_gflop"] or \
            card["kernel_flops"] != cpu["kernel_flops"]:
        raise AssertionError(f"frame FLOPs: card {card['frame_gflop']} "
                             f"{card['kernel_flops']}, CPU "
                             f"{cpu['frame_gflop']} {cpu['kernel_flops']}")


def run_tools():
    """Phase 15: the developer and analysis CLIs, each through its main()
    in this process on the card with TOOLS_CUTS's arguments; the planner
    frame at 64x96 counted on the card and on the CPU (the card's sections
    forced); trace_track as a process of its own; analyze_model's
    parameter counts against the CPU's. Returns the phase's launches by
    kernels-line row (trace_track's process's included)."""
    t0 = time.perf_counter()
    reset_corr_launches()
    outs, secs = {}, {}
    for name, argv in TOOLS_CUTS.items():
        outs[name], secs[name] = run_tool(name, argv)
    frame_flops_card_against_cpu()
    launches = kbench.launch_counts()
    outs["trace_track"], secs["trace_track"] = run_trace_track()
    for k, n in outs["trace_track"]["launches"].items():
        launches[k] += n

    corr = outs["bench_corr"]
    log("tools", cli="bench_corr", shape="64x30x101",
        k3_ms=f"{corr['k3']['ms']:.4f}",
        k3_err=f"{corr['k3']['max_abs_err']:.3g}",
        k3_share=f"{corr['k3']['share']:.3f}",
        p1_ms=f"{corr['packed']['ms']:.4f}",
        p1_err=f"{corr['packed']['max_abs_err']:.3g}",
        p1_bit_equal=f"{corr['packed']['bit_equal']:.6f}",
        p1_share=f"{corr['packed']['share']:.3f}")
    dba = outs["bench_dba"]
    log("tools", cli="bench_dba", device_ms=f"{dba['device_ms']:.3f}",
        events_ms=f"{dba['events_ms']:.3f}", kernels=dba["launches"],
        top3=repr([[k[:40], round(ms, 3), n] for k, ms, n in dba["top"][:3]]))
    for name, key in (("bench_step_parts", "parts"), ("profile_vo", "pieces")):
        log("tools", cli=name, **{
            part: f"{r['device_ms']:.3f}/{r['events_ms']:.3f}/"
                  f"{r['host_ms']:.3f}"
            for part, r in outs[name][key].items()},
            read="device/events/host ms")
    track = outs["trace_track"]
    log("tools", cli="trace_track", device_ms_per_frame=(
        f"{track['device_ms_per_frame']:.3f}"),
        frame_gflop=f"{track['frame_gflop']:.3f}",
        tflop_per_s=f"{track['tflop_per_s']:.2f}", mfu=f"{track['mfu']:.4f}",
        sections=repr(track["sections"]),
        launches_counted=repr(track["launches_counted"]),
        launches_traced=repr(track["launches_traced"]),
        segsum_ms_launches_per_frame=repr(track["segsum_per_frame"]),
        cond_ms_launches_per_frame=repr(track["cond_per_frame"]),
        kernel_gflop=repr({k: round(v["gflop"], 4)
                           for k, v in track["kernel_flops"].items()}))
    if not (0 < track["mfu"] <= 1 and
            track["launches_counted"] == track["launches_traced"]):
        raise AssertionError(f"trace_track: MFU {track['mfu']}, launches "
                             f"{track['launches_counted']} counted, "
                             f"{track['launches_traced']} traced")
    prof = outs["profile_track"]
    log("tools", cli="profile_track", fps=f"{prof['fps']:.3f}",
        stages=repr({k: round(v["mean_ms"], 3)
                     for k, v in prof["stages"].items()}))
    term = outs["profile_terminate"]
    log("tools", cli="profile_terminate", n_kf=term["n_kf"],
        total_s=f"{term['total_s']:.3f}", keyframes=term["keyframes"],
        filler_s=f"{term['stages']['traj_filler']:.3f}")
    fil = outs["bench_filler"]
    log("tools", cli="bench_filler", seconds=repr(fil["seconds"]),
        profiled_device_ms=f"{fil['profiled']['device_ms']:.2f}",
        profiled_kernels=fil["profiled"]["kernels"],
        dba_range_ms_kernels=repr(fil["profiled"]["ranges"].get(
            "vo.filler.dba")),
        launches=repr(fil["profiled"]["launches"]))
    vo2 = outs["trace_vo2"]
    log("tools", cli="trace_vo2", iters=vo2["iters"],
        device_ms=f"{vo2['device_ms']:.2f}", kernels=vo2["launches"])
    vps = outs["trace_vps"]
    log("tools", cli="trace_vps", plain_device_ms=(
        f"{vps['plain']['device_ms']:.2f}"),
        fused_device_ms=f"{vps['fusion+depth']['device_ms']:.2f}")
    log("tools", cli="profile_vps", **{
        k.replace(" ", "_"): f"{v:.3f}" for kind in ("programs", "copies")
        for k, v in outs["profile_vps"][kind].items()})
    log("tools", cli="profile_vps_pipeline", **{
        k.replace(" ", "_").replace("+", "_"): f"{v['frame']:.2f}"
        for k, v in outs["profile_vps_pipeline"]["modes"].items()})

    model = outs["analyze_model"]
    want = {"vo": analyze_model.param_table(
                DroidNet.from_seed(0), analyze_model.vo_group),
            "vps": analyze_model.param_table(
                pfpn.PanopticFPN(), analyze_model.vps_group)}
    for fam, table in want.items():
        cpu_params = {k: g["jax"] for k, g in table.items()}
        log("tools", cli="analyze_model", family=fam,
            params=repr(model[fam]["params"]), cpu_params=repr(cpu_params))
        if cpu_params != model[fam]["params"]:
            raise AssertionError(f"analyze_model {fam}: card "
                                 f"{model[fam]['params']}, CPU {cpu_params}")
    log("tools", cuts=repr(dict({k: v for k, v in TOOLS_CUTS.items() if v},
                                trace_track=TOOLS_TRACE_ARGV)),
        seconds_by_cli=repr({k: round(v, 1) for k, v in secs.items()}),
        launches=repr(launches),
        seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


PHASES = {"kernels": check_kernels, "packed": check_packed,
          "reference": check_reference, "main": run_main_path,
          "harness": run_harnesses, "export": run_export, "vps": run_vps,
          "loop": run_loop, "train": run_train, "vps_train": run_vps_train,
          "planner": run_planner, "planner_wide": run_planner_wide,
          "terminate_wide": run_terminate_wide,
          "demo": run_demo, "dp": run_dp,
          "tools": run_tools}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log("device", gpu=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count())

    t0 = time.perf_counter()
    sources = (cuda_corr.SOURCE, cuda_corr_exp.SOURCE, cuda_segsum.SOURCE,
               cuda_dba.SOURCE, graph_capture.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(cuda_corr.build, sources))
    log("build", sources=",".join(src.name for src in sources),
        seconds=f"{time.perf_counter() - t0:.2f}")

    only = sys.argv[1:]
    if only:
        # a partial run, for work on one phase: no result lines
        for name in only:
            PHASES[name]()
        print(card)
        return 0

    seconds = {}

    def phase(name, run=None):
        t = time.perf_counter()
        out = (run or PHASES[name])()
        seconds[name] = round(time.perf_counter() - t, 1)
        log(name, phase_seconds=seconds[name],
            depth_cut=repr(DEPTH_CUTS.get(name, "none")))
        return out

    res = phase("kernels")
    packed = phase("packed")
    phase("reference")
    launches = phase("main")
    in_terminate = launches.pop("in_terminate")
    phase("planner")
    phase("planner_wide", run_planner_wide_alone)
    wide100 = phase("terminate_wide")
    harness = phase("harness")
    export = phase("export")
    phase("vps")
    loop = phase("loop")
    train = phase("train")
    vps_train = phase("vps_train")
    demo_launches = phase("demo")
    dp_launches = phase("dp")
    tools_launches = phase("tools")

    # K1 and K3 have a row for each feature type. A bf16 row's launches
    # are phase 5's (the video's features); an f32 row's are the timed
    # pairs of the export route that runs it (K1: 240x808, K3: 376x1248),
    # each counted from 0; the f32 K3 also runs as phase 5's probe. K2 is
    # one kernel on both paths
    pairs = {"build_volumes_f32": (EXPORT_NARROW, EXPORT_NARROW_PAIRS),
             "corr_lookup_f32": (EXPORT_SIZE, EXPORT_PAIRS)}
    f32_of = {v: k for k, v in F32_ROWS.items()}
    kernels = []
    for row in (*cuda_corr.KERNELS, *F32_ROWS.values()):
        k = f32_of.get(row, row)
        n, extra = launches[row], {}
        if row in pairs:
            (H, W), timed = pairs[row]
            tag = f"{H}x{W}"
            extra = {"launches_tracking": n,
                     f"launches_per_pair_{tag}": export[tag][k]}
            n = export[tag][k] * timed
        elif k not in F32_ROWS:
            extra = {f"launches_export_{tag}": per[k]
                     for tag, per in export.items()}
        extra["launches_loop"] = loop[row]
        extra["launches_train"] = train[row]
        extra["launches_vps_train"] = vps_train[row]
        extra["launches_demo"] = demo_launches[row]
        extra["launches_dp"] = dp_launches[row]
        extra["launches_tools"] = tools_launches[row]
        kernels.append({
            "name": row, "route": "cuda",
            "source": "pvo_tpu_torch/csrc/corr.cu", "replaces": REPLACES[k],
            "launches": n, "max_abs_err": res[row]["err"],
            "ms": res[row]["ms"], "plain_ms": res[row]["plain_ms"],
            "bound_ms": res[row]["bound_ms"],
            "bound_by": res[row]["bound_by"],
            "library_ms": res[row]["library_ms"], **extra})
        if n == 0:
            raise AssertionError(f"{row} was never launched on its path")
    kernels.append({
        "name": "segsum", "route": "cuda",
        "source": "pvo_tpu_torch/csrc/segsum.cu",
        "replaces": "none: the card's Tensor.index_add_ (float atomics)",
        "launches": launches["segsum"], "max_abs_err": res["segsum"]["err"],
        **{k: res["segsum"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
        "launches_loop": loop["segsum"], "launches_train": train["segsum"],
        "launches_vps_train": vps_train["segsum"],
        "launches_demo": demo_launches["segsum"],
        "launches_dp": dp_launches["segsum"],
        "launches_tools": tools_launches["segsum"]})
    # the DBA's kernels: phase 5's launches (terminate's within them); the
    # solve's grid kernel (P above 48, which phase 5, the demo and the
    # tools never reach) the wide terminate's at 100 keyframes (phase
    # terminate_wide), phase 5's beside them
    in_terminate[cuda_dba.GRID] = wide100[cuda_dba.GRID]
    for row in (*cuda_dba.KERNELS, cuda_dba.GRID):
        grid = row == cuda_dba.GRID
        n = wide100[row] if grid else launches[row]
        kernels.append({
            "name": row, "route": "cuda",
            "source": "pvo_tpu_torch/csrc/dba.cu",
            "replaces": DBA_REPLACES.get(
                row, "none: XLA einsums in pvo_tpu/vo/dba.py"),
            "launches": n, "max_abs_err": res[row]["err"],
            **{k: res[row][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            **({"launches_main": launches[row]} if grid else {}),
            "launches_in_terminate": in_terminate[row],
            "launches_loop": loop[row], "launches_train": train[row],
            "launches_vps_train": vps_train[row],
            "launches_demo": demo_launches[row],
            "launches_dp": dp_launches[row],
            "launches_tools": tools_launches[row]})
        if not (n and (grid or (loop[row] and demo_launches[row]))):
            raise AssertionError(f"{row} was never launched on a path")
    for x, (_, kernel, site) in HARNESS.items():
        n, ms, plain_ms, err = harness[x]
        bound = kernel_bound(kernel, HARNESS_E[kernel], 30, 101, C)
        extra = {}
        if x == "X1":
            # ms is on the harness's uniform coordinates, through the wrapper
            uniform, smooth = (harness["X1 routes"][k]
                               for k in ("uniform", "smooth"))
            extra = {"kernel_only_ms": uniform["kernel_ms"],
                     "ms_smooth": smooth["ms"],
                     "kernel_only_ms_smooth": smooth["kernel_ms"],
                     "pairs_within_above_cap": uniform["routes"],
                     "pairs_within_above_cap_smooth": smooth["routes"]}
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "pvo_tpu_torch/csrc/corr_exp.cu", "replaces": site,
            "launches": n, "max_abs_err": max(err, packed[x]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound["ms"],
            "bound_by": bound["bound_by"], "library_ms": None,
            "launches_train": train[kernel],
            "launches_vps_train": vps_train[kernel],
            "launches_demo": demo_launches[kernel],
            "launches_dp": dp_launches[kernel],
            "launches_tools": tools_launches[kernel], **extra})
    log("run", seconds=f"{time.perf_counter() - start:.1f}",
        phase_seconds=repr(seconds))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
