#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (nu_scaler_tpu_torch) on one NVIDIA card.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printed on its own line with its seconds:

1. the card: its name, and its power limit as nvidia-smi reports it;
2. the build, through its command line (python -m
   nu_scaler_tpu_torch.kernels._build, run in process): one nvcc call per
   source under nu_scaler_tpu_torch/kernels/csrc/ (resample_fused.cu,
   soft_warp.cu, fsr.cu, conv3x3.cu, trunk_fused.cu, resample_twopass.cu) and
   one g++ call per host library under nu_scaler_tpu_torch/runtime/native/
   (framering.cpp, y4m.cpp), all started together, into
   build/nu_scaler_tpu_torch/, each library's path printed;
3. each kernel wrapper against its plain PyTorch version on the card, at
   1080p→4K: lanczos3, bilinear, nearest, bicubic, lanczos2, mitchell and
   area single frames (0 differing bytes; bicubic also ≥ 50 dB against its
   float64 golden, as bench.py gates it), a batch of 4, and the blend epilogue with t = 0.5 and
   t = (1/3, 2/3); the soft warp at 1080p (≤1 LSB) with K = 4 and 8,
   t = 0.5 and (1/3, 2/3), tiles (8, 128) and (8, 32), and K = 1 and 8
   under a tile (8, 12) whose cell boundaries fall inside runs of pixels,
   on the bench pair (its flow tiles) and on a noise pair with random tile
   motion, with the count of differing bytes; the fused
   FSR kernel (≤1 LSB, bit-exact the target) at s = 2 (1080p, all four
   sharpness tiers and 0.0), 3 (720p), 4 (540p) and 1, batches of 4 at s = 2
   and 3, an odd 37×53 frame and an 83×101 one (no tile divides either
   side) at s = 1..4, the latter also in a batch of 2, on the bench frame
   and seeded noise, with the count of differing bytes; the bf16 3×3 conv (≤ 1 bf16 ulp, as
   conv_cuda.ulp_tolerance states it) with ReLU on and off, with and without
   round_sum, Cout 128, 256 and 1024, Cin 128 and 256 (two halo chunks),
   N = 1 and 4, at the learned tier's trunk grids (270×480, 135×240), a
   ragged 27×40 and a 17×33 that no tile divides, on seeded weights and on
   the committed tpu4b2 / tpu4 weights; the fused trunk (0 values differing
   from the chain of conv3x3 launches, and within trunk_cuda.ulp_tolerance,
   bf16 ulps of the output, of the plain version, with the share of values
   bit-equal to it) at ×2 (1×270×480, 2 blocks, Cout 256), ×4 (1×135×240, 3
   blocks, Cout 1024), N = 4 at ×2 and a ragged 27×40, both roundings, on
   seeded weights and on the committed weights fed the s2d of frames; the two-call
   resample at 1080p→4K (lanczos3, bilinear, nearest, a batch of 4): bit-equal
   to resample_fused or ≤ 1 LSB of the plain version (nearest bit-exact);
4. the main path through the entry points a user calls: PyWgpuUpscaler
   upscale / upscale_batch (lanczos3, ≥50 dB against the float64 golden),
   WgpuFrameInterpolator.interpolate_py (blend) and the fused LivePipeline
   over 8 frames (15 output frames; mid ≥50 dB against the blend of the two
   goldens). The launch counts must show that every kernel ran. Then, on the
   host clock, the latency of upscale(bytes) and the live pipeline's output
   frames per second, with outputs left on the card and fetched to the host.
   Then the flow_soft path, its launch counts read on their own:
   WgpuFrameInterpolator(mode="flow_soft") interpolate_py and
   interpolate_multi_py, and a LivePipeline of 8 frames with a lanczos3
   upscale and the flow_soft interpolator (1 soft_warp_blend and 2
   resample_fused launches per step); the mids against the plain version's
   mids on the same tiles (≥50 dB RGB), the flow tiles on the card against
   the CPU (≤1e-2 px), and on the host clock and CUDA events the
   interpolate_py latency, the live output fps and the per-step split;
4c. the FSR path, its launch counts read on their own: create_fsr_upscaler
   ("quality") upscale at 1080p→4K against the easu_ref → rcas_ref golden
   (≥40 dB and ≤12 LSB), upscale_batch of 4 equal to 4 upscale calls, 720p→4K
   (s = 3) against its plain version, 1366×768→1080p through the general
   path (plain PyTorch on the card) against the CPU (≤1 LSB), and a
   LivePipeline with the FSR upscaler and a flow_soft interpolator (the
   app's live FSR configuration). Then flow_soft on frames its warp tile
   does not divide (the ragged branch): 1366×768 and 1600×900 under the
   default preset and 1080p under "tall8x32", on the card against the CPU
   (≥50 dB RGB). On the host clock and CUDA events: the FSR upscale latency
   and frames per second, and the live FSR output fps;
4d. the learned "ultra" tier, its launch counts read on their own:
   create_advanced_upscaler("ultra") with learned_prefer = "ultra" at
   1080p→4K (x2, tpu4b2: 7 conv launches per frame) and 540p→4K (x4, tpu4:
   9), upscale and upscale_batch of 4; the served bytes against the same
   graph on the conv's plain version on the card (≥ 45 dB RGB, alpha equal)
   and against the port's fp32 twin, ESRGANLiteTPU.forward (≥ 42 dB at x2,
   ≥ 40 dB at x4: the JAX side's gates); upscale_batch equal to 4 upscale
   calls. Then the same tier with trunk_impl="fused" (make_pretrained_upscaler
   and make_pretrained_batch_upscaler at x2 and x4), its counts read on their
   own: one trunk_fused launch and no conv3x3 launch per call; its bytes
   equal to the layered path's (and ≥ 50 dB RGB, alpha equal) and against
   the twin (≥ 42 / 40 dB). On the host clock the upscale(bytes) latency and the upscale_arr
   device frames per second of both trunk_impls;
4e. the two-call resample (make_twopass_resampler, the counterpart of the
   JAX package's make_pallas_resampler) at 1080p→4K lanczos3, a frame and a
   batch of 4, its counts read on their own (two launches a call), against
   the float64 golden (≥ 50 dB), and its device frames per second (the
   counterpart of bench.py's pallas_twocall_lanczos3_fps);
4f. every rung of the learned ladder (RUNGS), each call's counts read on its
   own, through create_advanced_upscaler("ultra") with the committed
   weights: 1366×768 → 2732×1536 on all three ladders (the stride-2 tpu, its
   convs at the kernel's padded widths), also as a batch of 4 and with
   trunk_impl="fused" (one trunk_fused launch, the bytes of "layers");
   720p → 1080p "quality" and 720p → 4K "ultra" (tpu4b2 ×2 and tpu4 ×4 on
   the unfused graph, resized to the target); ESRGANLite at 1365×767 ×2 and
   683×384 ×4; and a stride-8, 192-feature model on seeded weights at 1080p
   ×2, fused (sparse base) and unfused. Gates: the kernel path against the
   same graph on the plain convs (≥ 45 dB RGB, alpha equal), against the
   fp32 twin on the bench frame (≥ 40 dB). Per case, beside the card's name
   and power limit: upscale_arr frames/s and device ms a call, conv
   launches, the conv work at the padded widths against the graph's own,
   and each padded conv against F.conv2d at its real widths;
4g. the live 4:2:0 link and the flow modes, at 1080p→4K: the 4:2:0
   converters (ops/color.py) on the card against the numpy goldens of
   capture/video.py (≥ 50 dB and ≤ 1 LSB, as bench.py's psnr_yuv420_ingest_db
   and psnr_yuv420_deliver_db) and against the CPU (≤ 1 LSB); the live
   4:2:0 step as bench.py builds it (LivePipeline with the fused blend
   kernel, a 4:2:0 ingest_fn and delivery deliver_fn) over 8 frames: 15
   (y, u, v) payloads, the first frame and mid ≥ 50 dB against the golden
   4:2:0 of the float64 goldens of the ingested frames, its launch counts,
   output fps on the card and fetched, and the payload MB in and out; again
   with a PREVIEW_H-row preview (the "area" resample on resample_fused, each
   payload equal to the plain version's); benchmark_live_pipeline's dict;
   modes "flow" and "flow_exact" through WgpuFrameInterpolator (interpolate_py,
   and interpolate_multi_py at t = (1/3, 2/3) for "flow", equal to the single
   calls): the card against the CPU (≥ 50 dB RGB, alpha equal for "flow";
   flow fields ≤ 1e-2 px), both beating the cross-fade on the texture moved
   8 px; a LivePipeline with the lanczos3 upscale and the "flow"
   interpolator (2 resample_fused launches a step, no soft warp); the timing
   API of "blend", "flow_soft", "flow" and "flow_exact" (the JAX keys, every
   value > 0, the total the calibration's);
4h. the learned refinement tier ("flow_soft_ref") at 1080p→4K with the
   committed interp_ref4 weights (128 features, 1 block, stride 4), each
   call's launch counts read on its own: WgpuFrameInterpolator(mode=
   "flow_soft_ref") interpolate_py and interpolate_multi_py at t = (1/3,
   2/3), make_refined_mid_upscaler and make_refined_multi_upscaler, and a
   LivePipeline of 8 frames with the lanczos3 upscale and the flow_soft_ref
   interpolator (4 conv3x3, 1 soft_warp_blend and 0 conv3x3_q launches a
   refined mid, 1 resample_fused a refined 4K mid). Gates: the refined mid
   against the same graph on the conv's plain version on the card (≥ 45 dB
   RGB, alpha equal, ≤ 2 LSB) and against the CPU (≥ 45 dB, ≤ 2 LSB), both
   on the same flow_soft mid, while the net moves that mid by more than 2
   LSB; each of the four convs on its operands of that call against its
   plain version (within conv_cuda.ulp_tolerance); the refined 4K mid in
   one call against make_resampler of interpolate_py's refined mid (≥ 50
   dB, psnr_flow_soft_ref_db); the multi forms equal to the single calls.
   Recorded: the mids of flow_soft and flow_soft_ref against the true mid
   of a texture moved 8 px, the timing API (total, flow, warp, refine), the
   live output fps on the card and fetched, the device ms of the net alone
   and of one refined 4K mid;
4i. the benchmark API at 1080p x2 on the card: py_benchmark_upscaler for
   "wgpu", "fsr" and "dlss" at quality "quality" (fps > 0; the JAX
   harness's names and sizes; each call's launches: 1 resample_fused, 1 fsr,
   8 conv3x3_q a frame for the warm-up and every timed frame), then
   py_run_comparison_benchmark's 16 cells (each fps > 0);
4j. the app (nu_scaler/), unmodified, on the port through the launcher's
   import finder (nu_scaler_tpu_torch.run.serve_port) in this process, each
   run's launch counts read on its own: nu_scaler.transcode of an 8-frame
   1080p C420 clip (the bench frame rolled 16 columns a frame, written by
   the port's Y4MWriter into a temporary directory) at --scale 2 with
   --tech wgpu --algorithm lanczos3 --factor 2 --interp-mode flow_soft
   (resample_fused, soft_warp_blend; 15 frames), --tech fsr --quality
   quality (fsr) and --tech dlss --quality quality --batch 4 (conv3x3_q,
   int8 tpu4b2 x2): each output file (its header and N*(n-1)+1 frames)
   byte-equal to the port's API called directly on the decoded input and
   written by Y4MWriter, the wgpu run's input frames >= 50 dB against the
   float64 golden through the same 4:2:0 round trip, open_reader on the clip
   the native demuxer; nu_scaler.headless --seconds 3 --scale 2 --algorithm
   lanczos3 --interpolate --interp-mode blend (FullScreen: the synthetic
   1920x1080 desktop, on the native ring), its printed stats with 0 errors,
   frames out and the 1920x1080 input, and its output frames/s;
   NuScaler("wgpu", "quality") and NuScaler("dlss", "quality")
   capture_and_upscale(1920, 1080, 3840, 2160), the captured frame the
   synthetic scene at the tick its square's column gives and the output
   byte-equal to the port's upscaler on it; nu_scaler.benchmark_app single
   --tech auto at 1080p x2 (through the aliased detector), a result with
   fps > 0. No module of the JAX side may be loaded;
4k. training (models/train.py, models/data.py, the training half of
   models/interp_refine.py), at full width, depths cut as TRAIN and
   REFINE_TRAIN print them, the checkpoints in a temporary CKPT_ROOT: one
   tpu4b2 x2 train step from the committed 76000 on the card (TF32 switched
   on around it) against the same step on the CPU (losses within a
   relative 1e-5, parameters 99.9% within 1e-6 and all within 6·lr); 100
   steps from a seeded init, the loss falling; the step's device ms and
   crops/s; eval_vs_lanczos3 of 76000 on the card (6 resample_fused
   launches) against the CPU (0.05 dB, 1e-3 SSIM); the CLI's 50 steps
   resumed from the export and its --calibrate --io, the checkpoint served
   1080p -> 4K by make_serving_fn on 8 conv3x3_q launches, bit-equal to its
   plain path and >= 42 dB against make_quant_apply; interp_ref4 from
   112000: a 1080p TripletPool (its mids on soft_warp_blend, its A, B and
   targets equal to a CPU render), 20 steps, calibrate_scales, and
   RefineGraph on the trained module, bf16 (4 conv3x3) and int8 (4
   conv3x3_q), within 2 LSB of the plain convs. No module of the JAX side
   loaded; nothing written under checkpoints/, the committed weights or
   checkpoints_torch/;
4l. the mesh (parallel/mesh.py) at full width on MESH_SHARDS shards that
   share cuda:0, and on every card when more than one is visible (the mesh
   printed on its own line), each call's launches read on its own (the
   kernel once a shard) and its result byte-equal to one call on the card:
   upscale_batch_sharded lanczos3 and fsr_batch_sharded quality, 1080p->4K
   N = 6; interpolate_batch_sharded flow_soft and flow_soft_ref on 4 bench
   pairs; esrgan_batch_sharded "quality" x2, N = 4; upscale_frame_spatial
   1080p->4K (also >= 50 dB against the float64 golden); fsr_frame_spatial;
   interpolate_frame_spatial flow_soft at levels=4 and flow_soft_ref on 2
   shards; interpolate_multi_spatial at (1/3, 2/3); esrgan_infer_spatial of
   the committed tpu4b2 x2 at 540p (fp32 and its int8 twin) on 3 shards;
   PyWgpuUpscaler.upscale_batch and the learned upscale_batch through the
   mesh branch. CUDA-event times of sharded calls beside the single calls
   (shards on one card only add launches: no speed claim). What one card
   cannot check: the copies between cards;
4m. the dp x tp train step (parallel/mesh.py make_2d_mesh, parallel/tp.py,
   esrgan_lite.make_sharded_train_step and gather_model): tpu4b2 x2 at full
   width from the committed 76000 on a 2 x 2 mesh of 4 gloo ranks that share
   cuda:0, batches of 8 x 96^2 from phase 4k's pool: the first step against
   one card's (the loss within a relative 1e-5; the gradients, Adam's
   moments and the parameters against one card's step with the world's L1
   residual signs), 20 steps (the loss falling), the step's CUDA-event ms,
   collectives and launches a rank beside one card's step; the gathered
   weights saved into a temporary CKPT_ROOT and served 1080p -> 4K through
   conv3x3 (7 launches), against the plain conv and against the
   single-device-trained weights; a 1 x 1 NCCL world; with four cards
   visible, the 2 x 2 step on NCCL across them
   (tools/sharded_train_probe.py runs this phase alone);
4n. serving after training, its launches read call by call: with
   phase 4k's root as CKPT_ROOT and the loaders' caches cleared,
   create_advanced_upscaler("ultra") on the "quality" ladder at 1080p -> 4K
   serves the CLI's calibrated tpu4b2 76050 (8 conv3x3_q, 4k's bytes); after
   a further CLI step without calibration, the committed tpu4 x2 int8 at
   80000 (against its plain path and make_quant_apply, phase 4d's gates),
   and "ultra" the new step in bf16 (>= 45 dB against the plain conv);
   WgpuFrameInterpolator("flow_soft_ref") at 1080p the trained interp_ref4
   in int8, 4k's RefineGraph mid. Then tpu4 x2 resumed from 80000 with the
   export's Adam moments, one step card vs CPU (4k's bounds); the tpu4 x2
   teacher's outputs card vs CPU (TEACHER_GATE) and two interp_ref4 steps
   distilled from interp_ref4w, the first loss card vs CPU within 1e-5;
   tpu8 and tpu8w x2 on their committed weights at 1080p -> 4K (phase 4f's
   gates). Every phase runs with CKPT_ROOT an empty temporary directory, so
   a checkpoints_torch/ on the machine changes nothing served; at the end
   nothing may have been written there, under checkpoints/, the committed
   weights or checkpoints_torch/;
4o. the command lines on the card, in process through their main([...]),
   with CKPT_ROOT an empty temporary directory and the loaders' caches
   cleared, at the serving net's full width (128 features, 1 block, 1080p;
   the pools' depths cut and printed), each call's launches read on its own:
   `interp_refine --calibrate` copies the committed interp_ref4@112000 into
   the root and writes its scales (card vs CPU within CLI_SCALE_GATE), and
   "flow_soft_ref" at 1080p then serves 112000 in int8 (4 conv3x3_q, 1
   soft_warp_blend; >= 42 dB against make_quant_apply); a 20-step leg
   resumed from it (losses finite, the step's CUDA-event ms), served in
   bf16 (4 conv3x3); a 2-step distillation from interp_ref4w, the first loss
   card vs CPU within 1e-5; --eval with JAX's protocol at 1080p (its dB and
   SSIM printed) and eval_refine_float card vs CPU at 540p within EVAL_GATE;
   `train --arch tpu4b2 --calibrate --io` copies the committed 76000 and
   "quality" x2 at 1080p -> 4K serves it from the copy on 8 conv3x3_q
   (phase 4d's gates). Nothing written under checkpoints/, the committed
   weights or checkpoints_torch/;
5. times: per kernel the median of 20 CUDA-event timings after 3 warm-ups,
   the plain version's time, and the bound (the larger of bytes moved over
   the memory rate and operations over the rate of their type: fp32, or
   bf16 on the tensor cores for the conv; for the soft warp and FSR, which
   form no FMA, the instruction floor: their operations over half the fp32
   rate, one instruction each), with ptxas' registers and spill stores of
   fsr_kernel<S> and soft_warp_kernel; for the conv, at each shape of
   the learned path, also F.conv2d's time (bf16, channels-last, bias) as the
   library's yardstick, which the port never calls, the weights' repack
   alone, and the kernel's four variants (16×16 or 8×32 tiles, 3 or 4
   weight stages; each the default's bytes) with % of bound, TFLOP/s and
   ptxas' registers and spill stores from the build log; the fused trunk at ×2,
   ×4 and N = 4 against the same chain as conv3x3 launches and as F.conv2d
   calls (no single PyTorch call computes it), its weights' repack alone and
   its ready-flag count, and at ×2 and ×4 in its four variants (16×16 or 8×32
   tiles, 3 or 4 weight stages; each the default's bytes) with ptxas'
   registers and spill stores; the two-call resample, both
   launches and each alone, against resample_fused; phase 4g's flow_soft
   warp stage within 2x of the soft warp wrapper's time; the refinement
   net's four convs at their padded widths (phase 4h's operands) with their
   bounds at the padded and the real widths, plain times, F.conv2d at the
   real widths and ptxas' registers;
6. torch.profiler traces of 7 fused live steps, of 7 flow_soft live steps,
   of 7 flow_soft_ref live steps, of 7 live 4:2:0 steps, of 7 "flow" and 7 "flow_exact" calls,
   of 7 FSR + flow_soft live steps and of 7 learned x2 upscale_arr calls,
   with the layered and with the fused trunk, of 7 calls of phase 4f's
   stride-2, 720p→4K, ESRGANLite ×2 and stride-8 graphs, and of 7 train
   steps each of phase 4k's tpu4b2 and interp_ref4: the device's busy
   share, kernel launches per step and device time by kernel and copy.

The line before the last is the card's name and power limit; the one before
that is the kernels' JSON; the last line is the result JSON. Without a CUDA
device, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

IN_H, IN_W, OUT_H, OUT_W = 1080, 1920, 2160, 3840
SEED = 0
PSNR_GATE_DB = 50.0  # the JAX side's lanczos3 and blend gates
LIVE_FRAMES = 8
PREVIEW_H = 540  # the live 4:2:0 delivery's preview height (phase 4g)
BATCH = 4
SOURCE = "nu_scaler_tpu_torch/kernels/csrc/resample_fused.cu"
SOFT_SOURCE = "nu_scaler_tpu_torch/kernels/csrc/soft_warp.cu"
FSR_SOURCE = "nu_scaler_tpu_torch/kernels/csrc/fsr.cu"
CONV_SOURCE = "nu_scaler_tpu_torch/kernels/csrc/conv3x3.cu"
TRUNK_SOURCE = "nu_scaler_tpu_torch/kernels/csrc/trunk_fused.cu"
TWOPASS_SOURCE = "nu_scaler_tpu_torch/kernels/csrc/resample_twopass.cu"
REPLACES = {
    "resample_fused": "nu_scaler_tpu/kernels/resample_pallas.py:268",
    "resample_fused_batched": "nu_scaler_tpu/kernels/resample_pallas.py:139",
    "resample_fused_blend": "nu_scaler_tpu/kernels/resample_pallas.py:371",
    "soft_warp_blend": "nu_scaler_tpu/kernels/soft_warp_pallas.py:984",
    "fsr": "nu_scaler_tpu/kernels/fsr_pallas.py:207",
    "fsr_batched": "nu_scaler_tpu/kernels/fsr_pallas.py:246",
    "conv3x3": "nu_scaler_tpu/kernels/conv_pallas.py:50",
    "trunk_fused": "nu_scaler_tpu/kernels/conv_pallas.py:183",
    "resample_twopass": "nu_scaler_tpu/kernels/resample_pallas.py:65",
    # the int8 ladders' conv: an XLA conv in the JAX package, a mode of the
    # conv kernel here
    "conv3x3_q": "nu_scaler_tpu/models/esrgan_lite.py:719",
}
FSR_GATE_DB, FSR_GATE_LSB = 40.0, 12  # the JAX side's psnr_fsr_db contract
# the FSR path's other sizes: 720p→4K (s = 3) and 540p (s = 4 in phase 3)
SIZES = {"720p": (720, 1280), "540p": (540, 960)}
GENERAL = ((768, 1366), (1080, 1920))  # a non-integer scale: the general path
FSR_RAGGED = (83, 101)  # FSR frames whose sides no tile of the kernel divides
# flow_soft frames that the warp tile does not divide: (h, w, preset)
RAGGED = ((768, 1366, None), (900, 1600, None), (1080, 1920, "tall8x32"))
SOFT_TILES = ((8, 128), (8, 32))  # the default preset's warp tile, and "tall"'s at 1080p
SOFT_EDGE_TILE = (8, 12)  # its cells' boundaries fall at columns 6 + 12i: inside runs of 4 or 8
FLOW_TILE_GATE_PX = 1e-2  # flow tiles, card vs CPU (and the flow modes' fields)
# the keys of get_last_gpu_duration_detail per mode (the JAX package's
# stage_timings_ms keys), "wall_ms" aside
STAGE_KEYS = {"blend": {"total_ms", "blend_ms"}, "flow_soft": {"total_ms", "flow_ms", "warp_ms"},
              "flow": {"total_ms", "flow_ms", "warp_ms"}, "flow_exact": {"total_ms", "flow_ms", "warp_ms"}}
SPLIT_STEPS = 10
# Published peaks (NVIDIA data sheets): device memory bytes/s, fp32 FLOP/s
# outside the tensor cores. The H100 SXM row is the default.
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}
# bf16 FLOP/s on the tensor cores, dense (NVIDIA data sheets: H100 SXM and
# H200 989 TFLOP/s, H100 PCIe 756)
BF16_PEAKS = {"H100 PCIe": 756e12, "H200": 989e12, "H100": 989e12}
# the learned tier: (upscale, input h, w, arch, step, the JAX side's twin gate)
LEARNED = ((2, IN_H, IN_W, "tpu4b2", 76000, 42.0), (4, *SIZES["540p"], "tpu4", 52000, 40.0))
# the int8 ladders through create_advanced_upscaler("ultra"): (learned_prefer,
# upscale, input h, w, arch, step, the JAX side's int8-twin gate, conv3x3_q and
# conv3x3 launches per frame)
INT8_LEARNED = (("quality", 2, IN_H, IN_W, "tpu4b2", 76000, 42.0, 8, 0),
                ("quality", 4, *SIZES["540p"], "tpu4", 52000, 40.0, 8, 1),
                ("performance", 2, IN_H, IN_W, "tpu4b1", 40000, 42.0, 6, 0))
LEARNED_GATE_DB = 45.0  # kernel path against the plain path, RGB
BENCH_FRAMES = 20  # timed frames per call of the benchmark API (phase 4i)
# the refined mid against the plain convs and the CPU: at most this many LSB
# (measured 1 on the H100), less than the net's own change of the mid
REFINE_MAX_LSB = 2
REFINE_CONVS = ("head", "block0.conv1", "block0.conv2", "tail")
# phase 4f, every rung of the learned ladder: (tag, learned_prefer, input h,
# w, output h, w, the arch JAX's ladder serves, the graph)
RUNGS = (
    ("ultra x2 1366x768", "ultra", 768, 1366, 1536, 2732, "tpu", "FusedServing"),
    ("quality x2 1366x768", "quality", 768, 1366, 1536, 2732, "tpu", "FusedServing"),
    ("performance x2 1366x768", "performance", 768, 1366, 1536, 2732, "tpu", "FusedServing"),
    ("quality 720p->1080p", "quality", 720, 1280, 1080, 1920, "tpu4b2", "UnfusedServing"),
    ("ultra 720p->4K", "ultra", 720, 1280, 2160, 3840, "tpu4", "UnfusedServing"),
    ("quality lite x2 1365x767", "quality", 767, 1365, 1534, 2730, "lite", "UnfusedServing"),
    ("performance lite x4 683x384", "performance", 384, 683, 1536, 2732, "lite", "UnfusedServing"),
)
RUNG_TWIN_GATE_DB = 40.0  # every rung against its fp32 twin, on the bench frame
FUSED_TRUNK_GATE_DB = 50.0  # trunk_impl="fused" against "layers", RGB
# phase 4k, training: the SR trainer's arch, resume step and depths (the
# widths full; n_clips 12 and pool_size 4096 cut), and the refinement net's
TRAIN = dict(arch="tpu4b2", step=76000, batch=8, crop=96, n_clips=2, pool_size=512, lr=2e-4)
LEARN_STEPS = 100  # from a seeded init: the loss must fall
SERVE_STEPS = 50  # the CLI's leg from the export, then calibrated and served
TRAIN_TIMED = 20  # CUDA-event timings of one step, after 3 warm-ups
REFINE_STEP = 112000
# phase 4n: tpu4 x2 teacher outputs (fp32, [0, 1] domain), card against the
# CPU: max |d|, set before the first run (the nine convs' fp32 sums in
# another order on each side); the refinement net's distillation teacher
TEACHER_GATE = 1e-4
DISTILL_TEACHER = ("interp_ref4w", 192, 2)
REFINE_TRAIN = dict(n_clips=1, frames_per_clip=4, pool_size=256, steps=20)
EVAL_GATE = (0.05, 1e-3)  # eval_vs_lanczos3 card vs CPU: dB, SSIM
# phase 4o, the command lines: --calibrate's pool cut to CLI_CLIPS clips of 12
# (8 frames each at 1080p, 256 crops); its scales card vs CPU within a relative
# CLI_SCALE_GATE, set before the first run (the same crops: the soft warp
# kernel is bit-equal to its plain version; fp32 convs summed in another
# order); the distillation leg's steps; eval_refine_float card vs CPU on the
# cut protocol (one seed, 3 frames at 540p), within EVAL_GATE
CLI_CLIPS, CLI_SCALE_GATE, CLI_DISTILL_STEPS = 1, 1e-5, 2
CLI_EVAL_CUT = dict(seeds=(900,), frames=3, height=540, width=960)
# phase 4l, the mesh: shards of the virtual mesh on cuda:0, the dp batch (6:
# padded to 8), the dp pairs, the sp flow_soft_ref mesh (1080 / 4 rows is no
# multiple of the net's stride) and the esrgan_infer_spatial mesh (540p: H
# must divide by the shards x the stride 4)
MESH_SHARDS, MESH_BATCH, MESH_PAIRS, MESH_REFINE_SHARDS, MESH_SR_SHARDS = 4, 6, 4, 2, 3
# phase 4m, the dp x tp train step: TRAIN's arch from the committed export on
# a (data, model) mesh of 4 gloo ranks that share cuda:0 (and on NCCL across
# cuda:0..3 when four cards are visible), SHARD_STEPS steps cycling
# SHARD_CYCLE batches of phase 4k's pool, SHARD_TIMED timed steps. The
# sharded-trained weights served against the single-device-trained ones, set
# before the first run: the two differ by the order of fp32 sums over 20
# Adam steps, which bf16 serving rounds mostly away
SHARD_MESH, SHARD_STEPS, SHARD_CYCLE, SHARD_TIMED = (2, 2), 20, 5, 10
SHARD_SERVE_GATE_DB = 45.0
# The gradients' and moments' bound against one card's step (with the
# world's L1 residual signs): the CPU tests' 1e-6 of each leaf's largest
# entry, or SHARD_SPREAD_FACTOR times the spread one card's own step shows
# when its batch is summed in reverse order, whichever is larger. At full
# width, from a converged checkpoint, a gradient is small against its terms,
# and reordering one card's own sums moves it measurably (the phase prints
# that spread)
SHARD_GRAD_BOUND, SHARD_SPREAD_FACTOR = 1e-6, 4.0
T_START = time.perf_counter()


def say(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        secs = time.perf_counter() - self.t0
        say(f"phase {self.name}: {'ok' if exc is None else 'FAILED'} in {secs:.2f} s")
        return False


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def set_tf32(torch, on: bool) -> tuple:
    """TF32 on or off for cuBLAS matmuls and cuDNN convs through the
    per-backend switches only (mixing them with the legacy ``allow_tf32``
    ones makes PyTorch's global getters raise); returns the earlier values
    for `restore_tf32`."""
    old = (torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision)
    value = "tf32" if on else "ieee"
    torch.backends.cuda.matmul.fp32_precision = value
    torch.backends.cudnn.conv.fp32_precision = value
    return old


def restore_tf32(torch, old: tuple) -> None:
    torch.backends.cuda.matmul.fp32_precision, torch.backends.cudnn.conv.fp32_precision = old


def gradient_pattern(width: int, height: int) -> np.ndarray:
    """The reference benchmark's test pattern (a copy of tests/conftest.py's)."""
    x = np.arange(width, dtype=np.uint64)
    y = np.arange(height, dtype=np.uint64)
    img = np.empty((height, width, 4), dtype=np.uint8)
    img[..., 0] = (x * 255 // width).astype(np.uint8)[None, :]
    img[..., 1] = (y * 255 // height).astype(np.uint8)[:, None]
    img[..., 2] = ((x[None, :] + y[:, None]) * 255 // (width + height)).astype(np.uint8)
    img[..., 3] = 255
    return img


def wave_pattern(width: int, height: int, shift: float) -> np.ndarray:
    """Smooth sinusoidal texture moved right by `shift` columns: a pair whose
    true middle frame is known, and where a cross-fade is visibly wrong."""
    y, x = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.empty((height, width, 4), dtype=np.uint8)
    for c in range(3):
        img[..., c] = np.clip(127.5 + 60.0 * np.sin(2 * np.pi * (x - shift) / 60.0 + c)
                              + 40.0 * np.sin(2 * np.pi * y / 44.0 + 2 * c), 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def bench_frame(h: int, w: int) -> np.ndarray:
    """The bench input at h×w: the gradient pattern with a white box (at
    1080p rows 480:600, columns 640:760)."""
    a = gradient_pattern(w, h)
    a[h * 4 // 9: h * 5 // 9, w // 3: w * 19 // 48, :3] = 255
    return a


def make_frames(rng) -> dict:
    """Frame a is the bench input (gradient + white box); b is a rolled by 16
    columns; n1, n2 are seeded noise, the hardest case for 1-LSB parity."""
    a = bench_frame(IN_H, IN_W)
    return {
        "a": a,
        "b": np.roll(a, 16, axis=1),
        "n1": rng.integers(0, 256, (IN_H, IN_W, 4), np.uint8),
        "n2": rng.integers(0, 256, (IN_H, IN_W, 4), np.uint8),
    }


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR over RGB (alpha excluded), as nu_scaler's ErrorMetrics."""
    d = a[..., :3].astype(np.float64) - b[..., :3].astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse <= 0.0 else 20.0 * np.log10(255.0 / np.sqrt(mse))


def plane_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of two u8 planes of any shape (a 4:2:0 plane has no channels)."""
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return float("inf") if mse <= 0.0 else 10.0 * np.log10(255.0 ** 2 / mse)


def lsb(a: np.ndarray, b: np.ndarray) -> int:
    """Max |a − b| of two u8 arrays."""
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def diff_stats(x, y) -> tuple[int, float]:
    """(max |x − y| in LSB, share of exactly equal values) of two u8 tensors."""
    import torch

    d = (x.to(torch.int16) - y.to(torch.int16)).abs()
    return int(d.max().item()), float((d == 0).double().mean().item())


def golden(torch, frame: np.ndarray, wv, wh):
    """Float64 golden on the card: dense BLAS matmuls on u8/255, then the WGSL
    trunc pack of nu_scaler_tpu_torch.kernels.reference.pack_u8_trunc."""
    f = torch.from_numpy(frame).cuda().double() / 255.0
    tmp = (wv @ f.reshape(IN_H, IN_W * 4)).reshape(OUT_H, IN_W, 4)
    tmp = tmp.permute(0, 2, 1).reshape(OUT_H * 4, IN_W)
    out = (tmp @ wh.T).reshape(OUT_H, 4, OUT_W).permute(0, 2, 1)
    return torch.trunc(torch.clamp(out.float(), 0.0, 1.0) * 255.0).to(torch.uint8)


def time_ms(torch, fn, flush) -> float:
    """Median of 20 CUDA-event timings of fn() after 3 warm-ups. Before each
    timing the L2 cache is flushed (a 256 MB write) and the stream is held
    busy, so the events see the device time and not the host's launch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def live_fps(torch, make_pipe, frames, to_host: bool) -> float:
    """Output frames per second of a live pipeline over two passes of
    `frames` (host numpy frames in), after a warm-up. to_host: every output
    frame is fetched to host memory (`put`), else it stays on the card
    (`put_device`)."""
    pipe = make_pipe()
    put = pipe.put if to_host else pipe.put_device
    drain = pipe.drain if to_host else pipe.drain_device
    for f in frames[:2]:
        put(f)
    drain()
    torch.cuda.synchronize()
    pipe.frames_out = 0
    t0 = time.perf_counter()
    for _ in range(2):
        for f in frames:
            put(f)
    drain()
    torch.cuda.synchronize()
    return pipe.frames_out / (time.perf_counter() - t0)


def device_busy(trace_path, wall_us: float) -> dict:
    """Device activity of a torch.profiler chrome trace: busy share of the
    window (the union of kernel, memcpy and memset intervals) and device time
    by name."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, by_name, n_kernels = [], {}, 0
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ev["ts"], ev["ts"] + ev["dur"]))
            by_name[ev["name"][:60]] = by_name.get(ev["name"][:60], 0.0) + ev["dur"]
            n_kernels += ev["cat"] == "kernel"
    if not spans:
        return {"device_busy_us": None, "busy_share": None,
                "note": "the profiler saw no device activity: not measured"}
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_busy_us": busy, "busy_share": busy / wall_us if wall_us > 0 else None,
            "kernel_launches": n_kernels, "device_us_by_name": dict(top)}


def trace_steps(torch, pipe, frames, path) -> dict:
    """One profiler window over live steps (host numpy frames in, outputs left
    on the card), after a first frame outside the window."""
    from torch.profiler import ProfilerActivity, profile

    pipe.put_device(frames[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames[1:]:
            pipe.put_device(f)
        pipe.drain_device()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    busy = device_busy(path, wall_us)
    steps = len(frames) - 1
    busy["wall_us_per_step"] = wall_us / steps
    if busy.get("kernel_launches") is not None:
        busy["kernel_launches_per_step"] = busy["kernel_launches"] / steps
    return busy


def trace_calls(torch, fn, arg, n: int, path) -> dict:
    """One profiler window over n calls of fn(arg) (outputs left on the
    card), after a first call outside the window."""
    from torch.profiler import ProfilerActivity, profile

    fn(arg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn(arg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    busy = device_busy(path, wall_us)
    busy["wall_us_per_call"] = wall_us / n
    if busy.get("kernel_launches") is not None:
        busy["kernel_launches_per_call"] = busy["kernel_launches"] / n
    return busy


def conv_work(n: int, h: int, w: int, cin: int, cout: int) -> tuple[int, int]:
    """(bytes, bf16 tensor-core operations) of one 3×3 conv: the input, the
    weights and the bias read once, the output written once (bf16); 2·9·Cin
    operations per output value."""
    return 2 * (n * h * w * (cin + cout) + 9 * cin * cout + cout), 2 * 9 * cin * cout * n * h * w


def ptxas_registers(log: str, pattern: str) -> dict:
    """{the match of `pattern` in a kernel's mangled name: "R registers, S
    bytes of spill stores"} of each kernel in nvcc's -Xptxas=-v messages."""
    import re

    found = {}
    for block in log.split("Compiling entry function '")[1:]:
        m = re.search(pattern, block.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if m and regs and spill:
            found[m[0]] = f"{regs[1]} registers, {spill[1]} bytes of spill stores"
    return found


def variant_registers(log: str, pattern: str) -> dict:
    """{(tile width, stages): "R registers, S bytes of spill stores"} of the
    kernels whose mangled names match `pattern`, whose template arguments
    begin <tile height, tile width, stages, ...>."""
    import re

    return {tuple(int(v) for v in re.findall(r"Li(\d+)E", key)[1:3]): r for key, r in
            ptxas_registers(log, pattern).items()}


def conv_registers(log: str) -> dict:
    """The conv's variants with relu off and round_sum on (the timed form)."""
    return variant_registers(log, r"conv3x3_kernelILi\d+ELi\d+ELi\d+ELb0ELi1E")


def trunk_work(x, params) -> tuple[int, int]:
    """(bytes, bf16 tensor-core operations) of the fused trunk on x
    [N, H, W, cin]: x, every layer's weights and bias read once, the output
    written once (bf16); each layer's operations as `conv_work` counts them."""
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    ops = sum(conv_work(n, h, w, k.shape[2], k.shape[3])[1] for k in params[::2])
    weights = sum(k.numel() for k in params[::2]) + sum(b.numel() for b in params[1::2])
    return 2 * (x.numel() + weights + n * h * w * params[-1].shape[0]), ops


def conv2d(x, k, b, relu: bool, round_sum: bool):
    """F.conv2d (bf16, channels-last NCHW, OIHW weights) in the kernel's call
    form, the library's yardstick for the trunk chain: its own rounding."""
    import torch

    y = torch.nn.functional.conv2d(x, k, b, padding=1)
    return torch.relu(y) if relu else y


def soft_warp_work(torch, swc, a, tiles, t: float, tile, k: int, rng: int) -> tuple[int, int]:
    """(bytes, fp32 operations) the soft warp needs on these inputs: frames a
    and b read once, the output written once, the tile arrays read once; per
    pixel 126 operations of cell and motion mixing, accumulation and
    packing, plus 42 per distinct corner candidate of each frame (two
    fractions, three lerps on four channels), as csrc/soft_warp.cu counts
    them."""
    h, w = a.shape[0], a.shape[1]
    frames_in = swc.frame_inputs(tiles, t, k, rng)
    distinct = 0
    for corners in swc.corner_assign(frames_in, h, w, tile):
        s = torch.sort(corners, dim=0).values
        distinct += int((1 + (s[1:] != s[:-1]).sum(dim=0)).sum().item())
    n_tiles = tiles.shape[0] * tiles.shape[1]
    moved = 3 * h * w * 4 + 2 * n_tiles * (8 + 4) + 2 * 2 * k * 4
    return moved, 126 * h * w + 42 * distinct


def fsr_work(torch, fc, src, s: int, sharp: float) -> tuple[int, int]:
    """(bytes, fp32 operations) of the fused FSR kernel on `src` u8
    [N, H, W, 4]: the input read once and the output written once; per input
    pixel 3 to load, 31 for the direction, 3 per phase (offs), 3 per tap
    (base), per tap and phase 2 (distance) + 2 (d², d³) + 1 (compare) + 7
    (accumulate) + 5 for the cubic where d ≤ 2 or 1 further compare where not,
    and per phase 9 to normalise and take luma (+9 with the sharpness mix);
    51 per output pixel for RCAS; as csrc/fsr.cu issues them, without its
    ring's recomputation. The cubic's share is counted on this input."""
    n, h, w = src.shape[0], src.shape[1], src.shape[2]
    rgb = src[..., :3].permute(0, 3, 1, 2).to(torch.float32) * fc.INV_255
    wx, wy = fc._direction(rgb)
    near = 0
    for py in range(s):
        for px in range(s):
            offs = float(np.float32((px + 0.5) / s)) * wx + float(np.float32((py + 0.5) / s)) * wy
            for ty in range(4):
                for tx in range(4):
                    near += int(((float(tx) * wx + float(ty) * wy - offs).abs() <= 2.0).sum().item())
    px_in = n * h * w
    mix = 9 if sharp > fc.SHARP_MIX_MIN else 0
    ops = px_in * (3 + 31 + 3 * s * s + 16 * 3 + 16 * s * s * 13 + s * s * (9 + mix))
    ops += 4 * near + 51 * px_in * s * s
    return px_in * 4 * (1 + s * s), ops


def guarded_listing(root, weights_dir) -> dict:
    """Every file under checkpoints/, the committed weights and
    checkpoints_torch/, with its mtime: what a training phase must leave as
    it found it."""
    dirs = (root / "checkpoints", weights_dir, root / "checkpoints_torch")
    return {str(d): sorted((p.relative_to(d).as_posix(), p.stat().st_mtime_ns) for p in d.rglob("*"))
            if d.exists() else None for d in dirs}


def jax_side_modules(root) -> list:
    """The loaded modules of the JAX side: jax, flax, optax, orbax, or a file
    of the JAX package."""
    jax_dirs = (str(root / "nu_scaler_tpu") + os.sep, str(root / "nu_scaler_core") + os.sep)
    return [n for n, m in list(sys.modules.items())
            if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")
            or (getattr(m, "__file__", None) or "").startswith(jax_dirs)]


class Launches:
    """Reads the kernels' launches one call at a time: each call sets the
    wrappers' counts to 0 just before `fn` and reads them just after it;
    `total` sums them over the calls."""

    def __init__(self, torch, counters) -> None:
        self.torch, self.counters, self.total = torch, counters, {}

    def __call__(self, fn):
        """(fn's result, the launches it made, by kernel)."""
        for c in self.counters:
            c.reset_launches()
        result = fn()
        self.torch.cuda.synchronize()
        got = {k: v for c in self.counters for k, v in c.launches.items()}
        for k, v in got.items():
            self.total[k] = self.total.get(k, 0) + v
        return result, got


def ran(got: dict) -> dict:
    """The kernels a call launched, with their counts."""
    return {k: v for k, v in got.items() if v}


def u8(t01) -> np.ndarray:
    """A [0, 1] tensor rounded to u8 on the host."""
    import torch

    return torch.clamp(torch.round(t01 * 255.0), 0, 255).to(torch.uint8).cpu().numpy()


def param_diffs(a, b) -> tuple[float, float]:
    """(share of parameters within 1e-6, max |d|) of two modules."""
    import torch

    d = torch.cat([(p.detach().cpu() - q.detach().cpu()).abs().flatten()
                   for p, q in zip(a.parameters(), b.parameters())])
    return float((d <= 1e-6).float().mean()), float(d.max())


def app_on_the_port(torch, clip_frames, wv, wh, card) -> dict:
    """Phase 4j: the app (nu_scaler/), unmodified, on the port through the
    launcher's finder (`nu_scaler_tpu_torch.run.serve_port`), in this
    process, on the card:

    - nu_scaler.transcode of an 8-frame 1080p C420 clip (`clip_frames`,
      written by the port's Y4MWriter into a temporary directory) at --scale
      2 on three paths: wgpu lanczos3 with flow_soft at --factor 2
      (resample_fused, soft_warp_blend), fsr "quality" (fsr), and dlss
      "quality" in batches of 4 (the int8 tpu4b2 x2 graph, conv3x3_q). Each
      output file is byte-equal to the port's API called directly on the
      decoded input and written by Y4MWriter (its header and N*(n-1)+1
      frames), and the first path's frames of the input frames are >= 50 dB
      against the float64 golden through the same 4:2:0 round trip;
      open_reader on the clip is the native demuxer;
    - nu_scaler.headless --seconds 3 --scale 2 --algorithm lanczos3
      --interpolate --interp-mode blend: FullScreen capture (the synthetic
      1920x1080 desktop: no display) -> the native ring -> interpolate_py ->
      upscale; the app swallows pipeline errors, so its printed stats must
      show 0 errors, frames out and the 1920x1080 input;
    - NuScaler("wgpu", "quality") and NuScaler("dlss", "quality")
      capture_and_upscale(1920, 1080, 3840, 2160): the captured frame is the
      synthetic scene at the tick its square's column gives, and the output
      the port's upscaler's bytes on it;
    - nu_scaler.benchmark_app single --tech auto at 1080p x2, 20 frames,
      through the aliased detector: a result with fps > 0.

    Each run's launches are read on their own and must include its kernels.
    No module of the JAX side may be loaded. Returns the launches of the
    phase by kernel."""
    import ast
    import contextlib
    import io
    import os
    import re
    import tempfile
    from pathlib import Path

    from nu_scaler_tpu_torch import run as launcher
    from nu_scaler_tpu_torch.capture import screen as cap_screen
    from nu_scaler_tpu_torch.capture import video as cap_video
    from nu_scaler_tpu_torch.capture.sources import SyntheticSource
    from nu_scaler_tpu_torch.capture.video import _rgba_to_yuv420, _yuv420_to_rgba
    from nu_scaler_tpu_torch.core import (
        NuScaler,
        PyAdvancedWgpuUpscaler,
        PyWgpuUpscaler,
        WgpuFrameInterpolator,
        create_advanced_upscaler,
        create_fsr_upscaler,
    )
    from nu_scaler_tpu_torch.kernels import conv_cuda as cc
    from nu_scaler_tpu_torch.kernels import fsr_cuda as fc
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc
    from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
    from nu_scaler_tpu_torch.kernels import trunk_cuda as tc

    launches_of = Launches(torch, (rc, swc, fc, cc, tc))

    def app(module: str, *args: str) -> tuple[int, str]:
        """Run one module of the app; (its exit code, what it printed)."""
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            code = launcher.run_app(module, [str(a) for a in args])
        say(f"  {module}: " + " | ".join(text.getvalue().strip().splitlines()[-2:]))
        return code, text.getvalue()

    root = Path(__file__).resolve().parent
    jax_dirs = (str(root / "nu_scaler_tpu") + os.sep, str(root / "nu_scaler_core") + os.sep)
    tmp = tempfile.TemporaryDirectory(prefix="nu_scaler_4j_")
    xdg = os.environ.get("XDG_DATA_HOME")
    os.environ["XDG_DATA_HOME"] = tmp.name  # the app's log file
    try:
        clip = os.path.join(tmp.name, "clip.y4m")
        writer = cap_video.Y4MWriter(clip, IN_W, IN_H, fps=30.0)
        for f in clip_frames:
            writer.write(f)
        writer.close()
        decoded = list(cap_video.Y4MReader(clip))
        n_in = len(decoded)
        reader = cap_video.open_reader(clip)
        check(isinstance(reader, cap_video.NativeY4MReader), f"open_reader served {type(reader).__name__}")
        check(lsb(next(reader), decoded[0]) <= 1, "the native demuxer is more than 1 LSB from Y4MReader")
        reader.close()

        def expected(path: str, factor: int, frames_out) -> None:
            out = cap_video.Y4MWriter(path, OUT_W, OUT_H, fps=30.0 * factor)
            for data in frames_out:
                out.write(np.frombuffer(data, np.uint8).reshape(OUT_H, OUT_W, 4))
            out.close()

        def direct_wgpu():
            up = PyWgpuUpscaler("quality", "lanczos3")
            up.initialize(IN_W, IN_H, OUT_W, OUT_H)
            it = WgpuFrameInterpolator(mode="flow_soft")
            outs, prev = [], None
            for f in decoded:
                data = f.tobytes()
                if prev is not None:
                    outs += [up.upscale(m) for m in it.interpolate_multi_py(prev, data, IN_W, IN_H, times=(0.5,))]
                outs.append(up.upscale(data))
                prev = data
            return outs

        def direct_fsr():
            up = create_fsr_upscaler("quality")
            up.initialize(IN_W, IN_H, OUT_W, OUT_H)
            return [up.upscale(f.tobytes()) for f in decoded]

        def direct_dlss():
            up = PyAdvancedWgpuUpscaler("ultra", "lanczos3", True)
            up.initialize(IN_W, IN_H, OUT_W, OUT_H)
            return [o for i in range(0, n_in, BATCH) for o in up.upscale_batch([f.tobytes() for f in decoded[i:i + BATCH]])]

        transcodes = {  # tag: (the app's arguments, factor, its kernels, the API called directly)
            "wgpu lanczos3 flow_soft x2": (("--tech", "wgpu", "--algorithm", "lanczos3", "--factor", "2",
                                            "--interp-mode", "flow_soft"), 2,
                                           ("resample_fused", "soft_warp_blend"), direct_wgpu),
            "fsr quality": (("--tech", "fsr", "--quality", "quality"), 1, ("fsr",), direct_fsr),
            "dlss quality batch 4": (("--tech", "dlss", "--quality", "quality", "--batch", str(BATCH)), 1,
                                     ("conv3x3_q",), direct_dlss),
        }
        frame_bytes = OUT_W * OUT_H * 3 // 2
        report = {}
        with launcher.serve_port():
            for tag, (args, factor, kernels, direct) in transcodes.items():
                out_path = os.path.join(tmp.name, f"{tag.split()[0]}.y4m")
                t0 = time.perf_counter()
                (code, printed), got = launches_of(
                    lambda: app("nu_scaler.transcode", clip, out_path, "--scale", "2", *args))
                seconds = time.perf_counter() - t0
                check(code == 0, f"transcode {tag}: exit code {code}")
                check(all(got[k] > 0 for k in kernels), f"transcode {tag}: launches {got}")
                with open(out_path, "rb") as fh:
                    header = fh.readline()
                    size = os.fstat(fh.fileno()).st_size
                n_out = factor * (n_in - 1) + 1
                want_header = f"YUV4MPEG2 W{OUT_W} H{OUT_H} F{30000 * factor}:1000 Ip A1:1 C420jpeg\n".encode()
                check(header == want_header, f"transcode {tag}: header {header!r}")
                check(size == len(header) + n_out * (6 + frame_bytes), f"transcode {tag}: {size} bytes, "
                      f"not {n_out} frames")
                want_path = out_path + ".direct.y4m"
                expected(want_path, factor, direct())
                with open(out_path, "rb") as fa, open(want_path, "rb") as fb:
                    check(fa.read() == fb.read(), f"transcode {tag}: not byte-equal to the API called directly")
                report[tag] = {"seconds": seconds, "frames_out": n_out,
                               "launches": {k: got[k] for k in kernels}}
                if factor == 2:  # the input frames' outputs against the golden, through 4:2:0
                    worst = float("inf")
                    for i, f in enumerate(cap_video.Y4MReader(out_path)):
                        if i % 2 == 0:
                            g = golden(torch, decoded[i // 2], wv, wh).cpu().numpy()
                            worst = min(worst, psnr(f, _yuv420_to_rgba(*_rgba_to_yuv420(g))))
                    check(worst >= PSNR_GATE_DB, f"transcode {tag}: {worst:.2f} dB against the golden")
                    report[tag]["min_psnr_db_vs_golden_420"] = worst

            made = []
            new_ring = cap_screen.ScreenCapture._new_ring

            def recording_ring():
                ring = new_ring()
                made.append(type(ring).__name__)
                return ring

            cap_screen.ScreenCapture._new_ring = staticmethod(recording_ring)
            try:
                (code, printed), got = launches_of(lambda: app(
                    "nu_scaler.headless", "--seconds", "3", "--scale", "2", "--algorithm", "lanczos3",
                    "--interpolate", "--interp-mode", "blend"))
            finally:
                cap_screen.ScreenCapture._new_ring = staticmethod(new_ring)
            stats = ast.literal_eval([ln for ln in printed.splitlines() if ln.startswith("{'frames_in'")][-1])
            check(stats["errors"] == 0 and stats["frames_out"] > 0 and stats["input_size"] == (IN_W, IN_H),
                  f"headless: {stats}")
            check(made == ["NativeFrameRing"], f"headless rings: {made}")
            check(got["resample_fused"] > 0, f"headless: launches {got}")
            report["headless"] = {"stats": stats, "output_fps": stats["frames_out"] / 3.0, "exit_code": code,
                                  "launches": {"resample_fused": got["resample_fused"]}, "card": card}

            for tech, kernel in (("wgpu", "resample_fused"), ("dlss", "conv3x3_q")):
                captured = []

                def facade(tech=tech):
                    ns = NuScaler(tech, "quality")
                    grab = ns.capture.get_frame

                    def spy():
                        got_ = grab()
                        if got_ is not None:
                            captured.append(got_)
                        return got_

                    ns.capture.get_frame = spy
                    try:
                        return ns.capture_and_upscale(IN_W, IN_H, OUT_W, OUT_H)
                    finally:
                        ns.close()

                out, got = launches_of(facade)
                check(got[kernel] > 0, f"NuScaler {tech}: launches {got}")
                data, w, h = captured[-1]
                frame = np.frombuffer(data, np.uint8).reshape(h, w, 4)
                scene = SyntheticSource(w, h)
                side = max(8, min(w, h) // 8)
                px = int(np.flatnonzero((frame[(h - side) // 2, :, :3] == 255).all(axis=1))[0])
                scene._t = next(t for t in range(w) if int(t * scene.speed) % (w - side) == px)
                check(np.array_equal(frame, scene.next_frame()), f"NuScaler {tech}: not the synthetic frame")
                up = PyAdvancedWgpuUpscaler("quality", "bilinear") if tech == "wgpu" else create_advanced_upscaler("ultra")
                up.initialize(IN_W, IN_H, OUT_W, OUT_H)
                check(up.upscale(data) == out, f"NuScaler {tech}: not the upscaler's bytes")
                report[f"NuScaler {tech}"] = {"tick": scene._t - 1, "launches": {kernel: got[kernel]}}

            (code, printed), got = launches_of(lambda: app(
                "nu_scaler.benchmark_app", "single", "--tech", "auto", "--width", IN_W, "--height", IN_H,
                "--scale", "2", "--frames", str(BENCH_FRAMES)))
            fps = re.findall(r"\] \d+x\d+→\d+x\d+: ([0-9.]+) fps", printed)
            check(code == 0 and fps and float(fps[-1]) > 0, f"benchmark_app: exit code {code}, {printed!r}")
            report["benchmark_app"] = {"fps": float(fps[-1]), "launches": {"resample_fused": got["resample_fused"]}}

            loaded = {n: getattr(m, "__file__", None) for n, m in list(sys.modules.items())}
        jax_side = [n for n, f in loaded.items()
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "orbax") or (f and f.startswith(jax_dirs))]
        jax_side += [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "flax", "orbax")]
        check(not jax_side, f"modules of the JAX side loaded: {jax_side}")
        say(f"app on the port [{card}]: " + json.dumps(report, default=str))
    finally:
        if xdg is None:
            os.environ.pop("XDG_DATA_HOME", None)
        else:
            os.environ["XDG_DATA_HOME"] = xdg
        tmp.cleanup()
    return launches_of.total


def training_on_the_card(torch, card, dev, frame, pair) -> tuple[dict, dict]:
    """Phase 4k: the port's training on the card, at full width, with the
    depths TRAIN and REFINE_TRAIN state, its checkpoints written into a
    temporary CKPT_ROOT and served through the port's kernels:

    - (a) the SR trainer, tpu4b2 x2 (128 features, 2 blocks, stride 4) on a
      `PairPool` of video-path crops: a 512x512 fp32 matmul with TF32
      switched on through the per-backend switches (recorded: whether it
      differs from fp32) and inside `conv_cuda.full_fp32_matmul` (equal to
      fp32: the switch cuBLAS follows is the one it sets); one step from the committed 76000 on
      the card (with TF32 switched on around it, as a user's process may
      have it: the step keeps fp32 itself) and on the CPU on the same batch,
      the losses within a relative 1e-5 and every parameter within the CPU
      tests' bound (99.9% within 1e-6, all within 6·lr); 100 steps from a
      seeded init, the mean loss of the last 10 below the first 10's; the
      step's device ms (median of TRAIN_TIMED CUDA-event timings after 3
      warm-ups) and crops/s; `evaluate` (eval_vs_lanczos3) of the committed
      76000 on the card and on the CPU within EVAL_GATE; the CLI's training
      (resumed from the export, saved at 76050 with Adam's state) and its
      --calibrate --io; the checkpoint through `load_model(...,
      directory=)` and `make_serving_fn(..., quant_scales=)` at 1080p -> 4K:
      8 conv3x3_q launches, bit-equal to the same graph on the plain
      versions and >= 42 dB against `make_quant_apply` (phase 4d's
      "quality" x2 gates);
    - (b) the refinement net, interp_ref4 (128 features, 1 block) from the
      committed 112000: a `TripletPool` at 1080p, its mids on the soft warp
      kernel, its A, B and target crops equal to a CPU render of the same
      seed; 20 steps into CKPT_ROOT/interp_ref4, `calibrate_scales` into its
      sidecar; `RefineGraph` on the trained module at 1080p, bf16 (4 conv3x3)
      and int8 (4 conv3x3_q), each within REFINE_MAX_LSB of the same graph
      on the plain versions; the step's device ms;
    - (c) no module of the JAX side loaded; nothing written under
      checkpoints/, nu_scaler_tpu_torch/weights/ or checkpoints_torch/.

    The temporary CKPT_ROOT outlives the phase: phase 4n serves from it and
    removes it. Returns (the launches of the phase by kernel, {tag: (fn,
    arg)}: the SR and refinement train steps for phase 6's traces, the SR
    trainer's `PairPool`, what phase 4n needs: {"tmp": the root, "saved"
    and "rstep": the steps the CLI and the refinement leg saved, "served":
    the 4K bytes of the CLI's calibrated checkpoint, "refine_mid": the int8
    `RefineGraph` mid of the trained net, "pair", "tpool"})."""
    import tempfile
    from pathlib import Path

    from nu_scaler_tpu_torch.kernels import conv_cuda as cc
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc
    from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
    from nu_scaler_tpu_torch.models import data as pdata
    from nu_scaler_tpu_torch.models import esrgan_lite as pel
    from nu_scaler_tpu_torch.models import interp_refine as pir
    from nu_scaler_tpu_torch.models import train as ptrain
    from nu_scaler_tpu_torch.ops import interpolate as interp

    launches_of = Launches(torch, (rc, swc, cc))

    def step_ms(step, batch) -> float:
        """The median of TRAIN_TIMED CUDA-event timings of one step after 3
        warm-ups, in ms."""
        for _ in range(3):
            step(*batch)
        times = []
        for _ in range(TRAIN_TIMED):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(*batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    root = Path(__file__).resolve().parent
    before = guarded_listing(root, pel.WEIGHTS_DIR)
    t = TRAIN
    lr = t["lr"]
    report = {"reduced": {"sr": {"n_clips": f"{t['n_clips']} of 12", "pool_size": f"{t['pool_size']} of 4096",
                                 "learn_steps": LEARN_STEPS, "serve_steps": SERVE_STEPS},
                          "refine": {"n_clips": f"{REFINE_TRAIN['n_clips']} of 12",
                                     "frames_per_clip": f"{REFINE_TRAIN['frames_per_clip']} of 8",
                                     "pool_size": f"{REFINE_TRAIN['pool_size']} of 4096",
                                     "steps": REFINE_TRAIN["steps"]}}, "card": card}
    say("training depths cut (widths full): " + json.dumps(report["reduced"]))
    tmp = tempfile.TemporaryDirectory(prefix="nu_scaler_4k_")
    ckpt_root = ptrain.CKPT_ROOT
    ptrain.CKPT_ROOT = Path(tmp.name)
    try:
        # (a) the SR trainer: the pool, then one step on the card and the CPU
        rng = np.random.default_rng(SEED)
        pool = pdata.PairPool(rng, scale=2, crop=t["crop"], n_clips=t["n_clips"], pool_size=t["pool_size"])
        lrs, hrs = torch.from_numpy(pool.lrs).to(dev), torch.from_numpy(pool.hrs).to(dev)

        def draw():
            idx = torch.from_numpy(rng.integers(0, t["pool_size"], size=t["batch"])).to(dev)
            return lrs[idx], hrs[idx]

        batch = draw()
        steps, losses = {}, {}
        for where in ("card", "cpu"):
            model, step0, own = ptrain.load_latest(t["arch"], 1)
            check(step0 == t["step"] and not own, f"{t['arch']} resumes from step {step0}")
            d = dev if where == "card" else torch.device("cpu")
            model.to(d)
            steps[where] = (model, pel.make_train_step(model, pel.adam(model, lr), "l1"))
        # which switch cuBLAS follows: a matmul with TF32 switched on through
        # the per-backend switch, and inside full_fp32_matmul, against fp32
        mat = torch.from_numpy(np.random.default_rng(1).random((512, 512), np.float32)).to(dev)
        mat_fp32 = mat @ mat
        tf32 = set_tf32(torch, True)
        try:
            mat_tf32 = mat @ mat
            with cc.full_fp32_matmul():
                mat_kept = mat @ mat
        finally:
            restore_tf32(torch, tf32)
        report["tf32_switch"] = {"tf32_on_differs_from_fp32": not torch.equal(mat_tf32, mat_fp32),
                                 "full_fp32_matmul_equals_fp32": bool(torch.equal(mat_kept, mat_fp32))}
        say(f"4k TF32 switches [{card}]: " + json.dumps(report["tf32_switch"]))
        check(report["tf32_switch"]["full_fp32_matmul_equals_fp32"], "full_fp32_matmul let TF32 through")
        # TF32 on around the card's step, as a user's process may have it
        # (PyTorch's own defaults allow it for cuDNN): the step keeps fp32
        tf32 = set_tf32(torch, True)
        try:
            (_, _, losses["card"]), got = launches_of(lambda: steps["card"][1](*batch))
        finally:
            restore_tf32(torch, tf32)
        _, _, losses["cpu"] = steps["cpu"][1](*(x.cpu() for x in batch))
        rel = abs(float(losses["card"]) - float(losses["cpu"])) / float(losses["cpu"])
        within, max_d = param_diffs(steps["card"][0], steps["cpu"][0])
        report["parity"] = {"loss_card": float(losses["card"]), "loss_cpu": float(losses["cpu"]),
                            "loss_rel": rel, "params_within_1e-6": within, "params_max_abs_diff": max_d,
                            "launches": got}
        say(f"4k parity, one tpu4b2 x2 step from {t['step']}, card (TF32 on outside the step) vs CPU [{card}]: "
            + json.dumps(report["parity"]))
        check(rel <= 1e-5, f"train step loss: card vs CPU relative {rel:.3g}")
        check(within >= 0.999 and max_d <= 6 * lr, f"train step params: {within:.6f} within 1e-6, max {max_d:.3g}")
        check(sum(got.values()) == 0, f"the train step launched a kernel: {got}")

        # it learns: 100 steps from a seeded init
        fresh = ptrain.make_model(t["arch"], 1, seed=SEED).to(dev)
        learn = pel.make_train_step(fresh, pel.adam(fresh, lr), "l1")
        seen = []
        t0 = time.perf_counter()
        for _ in range(LEARN_STEPS):
            seen.append(learn(*draw())[2])
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / LEARN_STEPS
        seen = [float(v) for v in seen]
        first, last = float(np.mean(seen[:10])), float(np.mean(seen[-10:]))
        ms = step_ms(learn, draw())
        report["learn"] = {"first10_mean_loss": first, "last10_mean_loss": last, "host_ms_per_step": host_ms,
                           "step_device_ms": ms, "crops_per_s": t["batch"] / ms * 1e3}
        say(f"4k tpu4b2 x2 from a seeded init, {LEARN_STEPS} steps, batch {t['batch']} x {t['crop']}^2 "
            f"[{card}]: " + json.dumps(report["learn"]))
        check(last < first, f"the loss did not fall: {first:.5f} -> {last:.5f}")

        # the held-out eval of the committed checkpoint, card vs CPU
        scores, got = launches_of(lambda: ptrain.evaluate(1, t["arch"]))
        cpu_scores = ptrain.evaluate(1, t["arch"], device="cpu")
        report["eval"] = {"card": scores, "cpu": cpu_scores, "launches": got}
        say(f"4k eval_vs_lanczos3 {t['arch']}@{t['step']} [{card}]: psnr_delta_db {scores['psnr_delta_db']:.4f} "
            f"(CPU {cpu_scores['psnr_delta_db']:.4f}); " + json.dumps(report["eval"]))
        check(got["resample_fused"] == 6, f"eval launches {got}")
        for k in scores:
            bound = EVAL_GATE[0] if k.endswith("_db") else EVAL_GATE[1]
            check(abs(scores[k] - cpu_scores[k]) <= bound, f"eval {k}: card {scores[k]} vs CPU {cpu_scores[k]}")

        # the CLI: train (resumed from the export), calibrate, then serve
        args = ["--arch", t["arch"], "--steps", str(SERVE_STEPS), "--clips", str(t["n_clips"]),
                "--pool", str(t["pool_size"])]
        code, got = launches_of(lambda: ptrain.main(args))
        saved = t["step"] + SERVE_STEPS
        stem = f"esrgan_{t['arch']}_x2_{saved}"
        names = sorted(p.name for p in Path(tmp.name).iterdir())
        check(code == 0 and names == [f"{stem}.json", f"{stem}.npz", f"{stem}_opt.pt"], f"the CLI wrote {names}")
        check(ptrain.main(["--arch", t["arch"], "--calibrate", "--io"]) == 0, "--calibrate failed")
        model, meta = pel.load_model(t["arch"], 2, directory=tmp.name)
        scales = pel.load_act_scales(t["arch"], 2, directory=tmp.name)
        check(meta["step"] == saved and scales and scales["head"] == scales["base"] == 1.0,
              f"the checkpoint's sidecar: step {meta['step']}, scales {scales}")
        committed = pel.load_model(t["arch"], 2)[0]
        moved = max(float((p - q).abs().max()) for p, q in zip(model.parameters(), committed.parameters()))
        check(moved > 0, "the CLI's training moved no parameter")
        serving = pel.make_serving_fn(model, IN_H, IN_W, OUT_H, OUT_W, dev, quant_scales=scales)
        check(isinstance(serving, pel.FusedServing) and serving.quantized and serving.convs_per_frame == 8,
              f"serving {type(serving).__name__}, {serving.convs_per_frame} convs")
        x = torch.from_numpy(frame[None]).to(dev)
        out, got = launches_of(lambda: serving(x)[0].cpu().numpy())
        plain = pel.make_serving_fn_fused(model, IN_H, IN_W, dev, conv=cc.conv3x3_plain, quant_scales=scales,
                                          conv_q=cc.conv3x3_q_plain)(x)[0].cpu().numpy()
        x01 = torch.from_numpy(frame[None, ..., :3].astype(np.float32) / 255.0).to(dev)
        twin = pel.make_quant_apply(model, scales)(x01)[0]
        twin = torch.clamp(torch.round(twin * 255.0), 0, 255).to(torch.uint8).cpu().numpy()
        report["serve"] = {"step": saved, "max_param_moved": moved, "scales": scales, "launches": got,
                           "vs_plain_path_equal": float((out == plain).mean()), "vs_plain_path_db": psnr(out, plain),
                           "alpha_equal": bool(np.array_equal(out[..., 3], plain[..., 3])),
                           "vs_int8_twin_db": psnr(out, twin)}
        say(f"4k the trained {t['arch']} x2 checkpoint served 1080p -> 4K on conv3x3_q [{card}]: "
            + json.dumps(report["serve"]))
        check(got["conv3x3_q"] == 8 and got["conv3x3"] == 0, f"serving launches {got}")
        check(out.shape == (OUT_H, OUT_W, 4) and report["serve"]["vs_plain_path_equal"] == 1.0,
              "the trained int8 graph is not bit-equal to its plain path")
        check(report["serve"]["vs_int8_twin_db"] >= INT8_LEARNED[0][6],
              f"vs the int8-grid twin: {report['serve']['vs_int8_twin_db']:.2f} dB")

        # (b) the refinement net: its pool at 1080p, then a leg from 112000
        r = REFINE_TRAIN
        frng = np.random.default_rng(SEED)
        tpool, got = launches_of(lambda: pir.TripletPool(frng, n_clips=r["n_clips"],
                                                         frames_per_clip=r["frames_per_clip"],
                                                         pool_size=r["pool_size"], height=IN_H, width=IN_W,
                                                         device=dev))
        check(got["soft_warp_blend"] == r["frames_per_clip"] - 2, f"pool mids' launches {got}")
        clip = pdata.clip_through_video_path(pdata.render_clip(IN_H, IN_W, seed=100, frames=r["frames_per_clip"]))
        replay = np.random.default_rng(SEED)
        for i in range(r["pool_size"]):  # the pool's draws: triplet, y, x
            k = replay.integers(0, r["frames_per_clip"] - 2)
            y, x_ = replay.integers(0, IN_H - 96 + 1), replay.integers(0, IN_W - 96 + 1)
            sl = np.s_[y: y + 96, x_: x_ + 96, :3]
            check(np.array_equal(tpool.xs[i, ..., :6],
                                 np.concatenate([clip[k][sl], clip[k + 2][sl]], -1).astype(np.float32) / 255.0)
                  and np.array_equal(tpool.ys[i], clip[k + 1][sl].astype(np.float32) / 255.0),
                  f"pool entry {i}: A, B or target differ from the CPU render")
        loss, got = launches_of(lambda: pir.train(steps=r["steps"], n_clips=r["n_clips"],
                                                  frames_per_clip=r["frames_per_clip"], pool_size=r["pool_size"],
                                                  height=IN_H, width=IN_W, log_every=10))
        check(got["soft_warp_blend"] == r["frames_per_clip"] - 2 and got["conv3x3"] == 0, f"refine leg {got}")
        rmodel, rstep = pir.load_checkpoint()
        check(rstep == REFINE_STEP + r["steps"], f"the refinement leg saved step {rstep}")
        rscales = pir.calibrate_scales(rmodel, crops=tpool.xs)
        pir.save_act_scales(rscales, rstep)
        # the trained step resolves (its scales), while the cached serving
        # net stays the one this process loaded first (phase 4h's) until the
        # loaders' caches are cleared (phase 4n)
        check(pir.load_act_scales() == rscales and pir.load_model()[1]["step"] == REFINE_STEP,
              "the trained step did not resolve, or the cached serving net moved")
        a, b = pair
        soft_mid = interp.soft_interp_fast(a, b, 0.5)
        committed_mid = pir.get_refine_graph(IN_H, IN_W, dev)(a, b, soft_mid).cpu().numpy()
        report["refine"] = {"final_loss": loss, "step": rstep, "scales": rscales}
        refined = {}
        for tag, q in (("bf16", None), ("int8", rscales)):
            graph = pir.RefineGraph(rmodel, IN_H, IN_W, dev, quant_scales=q)
            ker, got = launches_of(lambda: graph(a, b, soft_mid).cpu().numpy())
            refined[tag] = ker
            plain = pir.RefineGraph(rmodel, IN_H, IN_W, dev, conv=cc.conv3x3_plain, quant_scales=q,
                                    conv_q=cc.conv3x3_q_plain)(a, b, soft_mid).cpu().numpy()
            report["refine"][tag] = {"launches": got, "vs_plain_convs_db": psnr(ker, plain),
                                     "vs_plain_convs_max_lsb": lsb(ker, plain),
                                     "alpha_equal": bool(np.array_equal(ker[..., 3], plain[..., 3])),
                                     "vs_committed_net_max_lsb": lsb(ker, committed_mid)}
            want = {"conv3x3": 4, "conv3x3_q": 0} if q is None else {"conv3x3": 0, "conv3x3_q": 4}
            check(all(got[k] == v for k, v in want.items()), f"refine graph {tag} launches {got}")
            check(report["refine"][tag]["vs_plain_convs_max_lsb"] <= REFINE_MAX_LSB
                  and report["refine"][tag]["alpha_equal"], f"refine graph {tag}: {report['refine'][tag]}")
        rm = copy.deepcopy(rmodel).to(dev)
        ridx = torch.from_numpy(np.random.default_rng(1).integers(0, r["pool_size"], size=t["batch"])).to(dev)
        xs, ys = torch.from_numpy(tpool.xs).to(dev), torch.from_numpy(tpool.ys).to(dev)
        refine_step = pel.make_step(rm, pel.adam(rm, lr), lambda xb, yb: pir.refine_loss(rm, xb, yb))
        rms = step_ms(refine_step, (xs[ridx], ys[ridx]))
        traced = {"train_tpu4b2_x2_step": (lambda b_: learn(*b_), draw()),
                  "train_interp_ref4_step": (lambda b_: refine_step(*b_), (xs[ridx], ys[ridx]))}
        report["refine"]["step_device_ms"] = rms
        report["refine"]["crops_per_s"] = t["batch"] / rms * 1e3
        say(f"4k interp_ref4 from {REFINE_STEP}, {r['steps']} steps at 1080p, then its graphs [{card}]: "
            + json.dumps(report["refine"]))

        # (c) no module of the JAX side; nothing written outside CKPT_ROOT
        jax_side = jax_side_modules(root)
        check(not jax_side, f"modules of the JAX side loaded: {jax_side}")
    finally:
        ptrain.CKPT_ROOT = ckpt_root
    check(guarded_listing(root, pel.WEIGHTS_DIR) == before,
          "phase 4k wrote under checkpoints/, the committed weights or checkpoints_torch/")
    say(f"training on the card [{card}]: launches {json.dumps(launches_of.total)}")
    trained = {"tmp": tmp, "saved": saved, "rstep": rstep, "served": out, "refine_mid": refined["int8"],
               "pair": pair, "tpool": tpool}
    return launches_of.total, traced, pool, trained


def mesh_on_the_card(torch, card, dev, frames, golden_a, frame540) -> tuple[dict, dict]:
    """Phase 4l: the mesh functions (nu_scaler_tpu_torch/parallel/mesh.py) at
    full width on a mesh of MESH_SHARDS shards that all sit on `dev` (and
    on every card, when more than one is visible), each call's launches read
    on its own and each result byte-equal to the port's single-device path
    on the card:

    - dp: upscale_batch_sharded lanczos3 1080p->4K and fsr_batch_sharded
      quality, N = MESH_BATCH (one batched launch a shard);
      interpolate_batch_sharded flow_soft and flow_soft_ref on MESH_PAIRS
      bench pairs (one soft warp a pair, four convs a refined pair);
      esrgan_batch_sharded "quality" x2, N = 4 (8 conv3x3_q a frame);
    - sp: upscale_frame_spatial 1080p->4K (also >= PSNR_GATE_DB against the
      float64 golden), fsr_frame_spatial quality 1080p->4K,
      interpolate_frame_spatial flow_soft at levels=4 and flow_soft_ref on
      MESH_REFINE_SHARDS shards, interpolate_multi_spatial at (1/3, 2/3),
      esrgan_infer_spatial of the committed tpu4b2 x2 at 540p (the fp32
      module and its int8 twin) on MESH_SR_SHARDS shards;
    - the API: PyWgpuUpscaler.upscale_batch and the learned upscale_batch
      (create_advanced_upscaler("ultra"), "quality" ladder) through the mesh
      branch (default_mesh patched to the mesh), equal to one card's bytes;
    - CUDA-event times of sharded calls beside the single calls (no speed
      claim: shards on one card only add launches).

    Returns (the launches of the phase by kernel, the times)."""
    from nu_scaler_tpu_torch.core import PyWgpuUpscaler, create_advanced_upscaler
    from nu_scaler_tpu_torch.kernels import conv_cuda as cc
    from nu_scaler_tpu_torch.kernels import fsr_cuda as fc
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc
    from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
    from nu_scaler_tpu_torch.kernels import trunk_cuda as tc
    from nu_scaler_tpu_torch.models import esrgan_lite as pel
    from nu_scaler_tpu_torch.models import interp_refine as pir
    from nu_scaler_tpu_torch.ops import fsr as pfsr
    from nu_scaler_tpu_torch.ops import resample
    from nu_scaler_tpu_torch.parallel import mesh as pmesh

    launches_of = Launches(torch, (rc, swc, fc, cc, tc))
    meshes = {"virtual": pmesh.Mesh((dev,) * MESH_SHARDS)}
    if torch.cuda.device_count() > 1:
        meshes["cards"] = pmesh.make_mesh()
    for tag, m in meshes.items():
        say(f"mesh {tag}: {m!r}")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    batch = np.stack([np.roll(frames["a"], 16 * i, axis=1) for i in range(MESH_BATCH)])
    batch_dev = torch.from_numpy(batch).to(dev)
    pairs_a = batch[:MESH_PAIRS]
    pairs_b = np.stack([np.roll(f, 16, axis=1) for f in pairs_a])
    a_dev, b_dev = (torch.from_numpy(frames[k]).to(dev) for k in ("a", "b"))
    report, times = {}, {}

    def same(tag: str, got, want, launched: dict, want_launches: dict) -> None:
        eq = bool(got.shape == want.shape and torch.equal(got, want))
        report[tag] = {"byte_equal": eq, "launches": {k: v for k, v in launched.items() if v}}
        check(eq, f"mesh {tag}: not byte-equal to the single-device path")
        check(all(launched.get(k, 0) == v for k, v in want_launches.items()),
              f"mesh {tag}: launches {launched}, want {want_launches}")

    up_single = resample.make_resampler(IN_H, IN_W, OUT_H, OUT_W, "lanczos3", dev)
    fsr_single = pfsr.make_fsr_upscaler(IN_H, IN_W, OUT_H, OUT_W, "quality", dev)
    refine_graph = pir.get_refine_graph(IN_H, IN_W, dev)
    for tag, m in meshes.items():
        n = len(m)
        # dp
        out, got = launches_of(lambda: pmesh.upscale_batch_sharded(batch, OUT_H, OUT_W, "lanczos3", m))
        same(f"{tag} upscale_batch_sharded", out, up_single(batch_dev), got, {"resample_fused_batched": n})
        out, got = launches_of(lambda: pmesh.fsr_batch_sharded(batch, OUT_H, OUT_W, "quality", m))
        same(f"{tag} fsr_batch_sharded", out, fsr_single(batch_dev), got, {"fsr_batched": n})
        for mode in ("flow_soft", "flow_soft_ref"):
            refine = refine_graph if mode == "flow_soft_ref" else None
            out, got = launches_of(lambda: pmesh.interpolate_batch_sharded(pairs_a, pairs_b, 0.5, mode, m))
            want = torch.stack([pmesh.pair_mid(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                                               0.5, mode, 2, refine) for x, y in zip(pairs_a, pairs_b)])
            per = -(-MESH_PAIRS // n) * n  # the padded batch
            same(f"{tag} interpolate_batch_sharded {mode}", out, want, got,
                 {"soft_warp_blend": per, "conv3x3": 4 * per if refine is not None else 0})
        learned = batch[:4]
        out, got = launches_of(lambda: pmesh.esrgan_batch_sharded(learned, OUT_H, OUT_W, m, "quality"))
        want = pel.make_pretrained_batch_upscaler(IN_H, IN_W, OUT_H, OUT_W, "quality", dev)(learned)
        same(f"{tag} esrgan_batch_sharded quality x2", out, want, got, {"conv3x3_q": 8 * (-(-4 // n) * n)})
        # sp
        out, got = launches_of(lambda: pmesh.upscale_frame_spatial(frames["a"], OUT_H, OUT_W, "lanczos3", m))
        same(f"{tag} upscale_frame_spatial", out, up_single(a_dev), got, {"resample_fused": n})
        report[f"{tag} upscale_frame_spatial"]["vs_golden_db"] = db = psnr(out.cpu().numpy(), golden_a)
        check(db >= PSNR_GATE_DB, f"mesh {tag} upscale_frame_spatial: {db:.2f} dB against the golden")
        out, got = launches_of(lambda: pmesh.fsr_frame_spatial(frames["a"], OUT_H, OUT_W, "quality", m))
        same(f"{tag} fsr_frame_spatial", out, fsr_single(a_dev), got, {"fsr": n})
        out, got = launches_of(lambda: pmesh.interpolate_frame_spatial(frames["a"], frames["b"], 0.5,
                                                                       "flow_soft", m, levels=4))
        same(f"{tag} interpolate_frame_spatial flow_soft levels=4", out,
             pmesh.pair_mid(a_dev, b_dev, 0.5, "flow_soft", 4), got, {"soft_warp_blend": n})
        ts = (1.0 / 3.0, 2.0 / 3.0)
        out, got = launches_of(lambda: pmesh.interpolate_multi_spatial(frames["a"], frames["b"], ts,
                                                                       "flow_soft", m, levels=4))
        want = torch.stack([pmesh.pair_mid(a_dev, b_dev, t, "flow_soft", 4) for t in ts])
        same(f"{tag} interpolate_multi_spatial (1/3, 2/3)", out, want, got, {"soft_warp_blend": 2 * n})
    # sp flow_soft_ref and the learned module on meshes the shapes allow,
    # of shards on `dev` and, where there are enough, of cards
    def sized_meshes(n: int) -> dict:
        out = {f"{n} shards": pmesh.Mesh((dev,) * n)}
        if "cards" in meshes and torch.cuda.device_count() >= n:
            out[f"{n} cards"] = pmesh.make_mesh(n)
        return out

    for tag, m in sized_meshes(MESH_REFINE_SHARDS).items():
        out, got = launches_of(lambda: pmesh.interpolate_frame_spatial(frames["a"], frames["b"], 0.5,
                                                                       "flow_soft_ref", m, levels=2))
        same(f"{tag} interpolate_frame_spatial flow_soft_ref", out,
             pmesh.pair_mid(a_dev, b_dev, 0.5, "flow_soft_ref", 2, refine_graph), got,
             {"soft_warp_blend": len(m), "conv3x3": 4 * len(m)})
    model = pel.load_model("tpu4b2", 2)[0].to(dev)
    scales = pel.load_act_scales("tpu4b2", 2)
    x540 = torch.from_numpy(frame540[None, ..., :3].astype(np.float32) / 255.0).to(dev)
    with torch.no_grad():
        for kind, fn in (("fp32", model), ("int8 twin", pel.make_quant_apply(model, scales))):
            want = fn(x540)
            for tag, m in sized_meshes(MESH_SR_SHARDS).items():
                out, got = launches_of(lambda: pmesh.esrgan_infer_spatial(
                    model, x540, m, quant_scales=None if kind == "fp32" else scales))
                same(f"{tag} esrgan_infer_spatial tpu4b2 x2 540p {kind}", out, want, got, {})
    # the API's mesh branch: default_mesh patched to the shards on `dev`, and
    # unpatched where several cards are visible (then it gives them all)
    classical = PyWgpuUpscaler("ultra", "lanczos3")
    classical.initialize(IN_W, IN_H, OUT_W, OUT_H)
    learned_api = create_advanced_upscaler("ultra")
    learned_api.adaptive_quality = False
    learned_api.initialize(IN_W, IN_H, OUT_W, OUT_H)
    check(learned_api._serving_tier == "learned" and learned_api._fn.quantized, "the API's learned tier")
    api_stack = batch[:4]
    api_in = [f.tobytes() for f in api_stack]
    real_default = pmesh.default_mesh
    for api, up, single, per_shard in (
        ("PyWgpuUpscaler.upscale_batch", classical, lambda: up_single(api_stack), {"resample_fused_batched": 1}),
        ("learned upscale_batch", learned_api, lambda: pel.make_pretrained_batch_upscaler(
            IN_H, IN_W, OUT_H, OUT_W, "quality", dev)(api_stack), {"conv3x3_q": 8}),
    ):
        want = [f.tobytes() for f in single().cpu().numpy()]
        for tag, m in meshes.items():
            if tag == "virtual":
                pmesh.default_mesh = lambda device=None: m
            try:
                out, got = launches_of(lambda: up.upscale_batch(api_in))
            finally:
                pmesh.default_mesh = real_default
            eq = out == want
            report[f"{tag} API {api} through the mesh"] = {
                "byte_equal": eq, "launches": {k: v for k, v in got.items() if v}}
            check(eq, f"mesh {tag} API {api}: not byte-equal to one card")
            check(all(got.get(k, 0) == v * len(m) for k, v in per_shard.items()),
                  f"mesh {tag} API {api}: launches {got}")
    # CUDA-event times, sharded beside single, inputs on `dev`
    for tag, m in meshes.items():
        for case, sharded, single in (
            (f"dp resample N={MESH_BATCH}", lambda: pmesh.upscale_batch_sharded(batch_dev, OUT_H, OUT_W, "lanczos3", m),
             lambda: up_single(batch_dev)),
            ("sp resample", lambda: pmesh.upscale_frame_spatial(a_dev, OUT_H, OUT_W, "lanczos3", m),
             lambda: up_single(a_dev)),
            ("sp fsr", lambda: pmesh.fsr_frame_spatial(a_dev, OUT_H, OUT_W, "quality", m),
             lambda: fsr_single(a_dev)),
            ("sp flow_soft levels=4",
             lambda: pmesh.interpolate_frame_spatial(a_dev, b_dev, 0.5, "flow_soft", m, levels=4),
             lambda: pmesh.pair_mid(a_dev, b_dev, 0.5, "flow_soft", 4)),
        ):
            times[f"{tag} {case}"] = {"sharded_ms": time_ms(torch, sharded, flush),
                                      "single_ms": time_ms(torch, single, flush), "shards": len(m)}
    say(f"mesh on the card [{card}]: " + json.dumps(report))
    say(f"mesh times, sharded against one call on {dev} (CUDA events) [{card}]: " + json.dumps(times))
    return launches_of.total, times


def step_times(torch, step, batch, n: int) -> tuple[float, float]:
    """(the median CUDA-event ms, the median host ms) of n calls of
    step(*batch), each waited for, after 2 warm-ups."""
    for _ in range(2):
        step(*batch)
    events, host = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step(*batch)
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    return float(np.median(events)), float(np.median(host))


def first_step_record(torch, loss, named, opt) -> dict:
    """A train step's loss, gradients, Adam moments and parameters, copied to the CPU."""

    def cpu(x):
        return x.detach().to("cpu", copy=True)

    return {"loss": float(loss), "grads": {n: cpu(p.grad) for n, p in named},
            "mu": {n: cpu(opt.state[p]["exp_avg"]) for n, p in named},
            "nu": {n: cpu(opt.state[p]["exp_avg_sq"]) for n, p in named},
            "params": {n: cpu(p) for n, p in named}}


def sharded_train_rank(rank, dev, backend, state, batches, ckpt_root, trace_dir) -> dict:
    """Phase 4m's rank (`parallel/mesh.py` `spawn_world`): TRAIN's arch from
    `state` on a SHARD_MESH mesh, SHARD_STEPS sharded steps cycling
    `batches`; the signs of the first step's residuals on the rank's part of
    the batch, the first step's record (`first_step_record`, the rank's
    slices) and collectives, the losses, the conv kernels' launches (none:
    training runs the fp32 forward), rank 0 saving the gathered module
    into `ckpt_root` at TRAIN's step + SHARD_STEPS; then the step's times
    (`step_times`) and, on rank 0, a profiler window of 5 steps."""
    from pathlib import Path

    import torch
    import torch.distributed as dist

    from nu_scaler_tpu_torch.kernels import conv_cuda as cc
    from nu_scaler_tpu_torch.models import esrgan_lite as pel
    from nu_scaler_tpu_torch.models import train as ptrain
    from nu_scaler_tpu_torch.parallel import mesh as pmesh
    from nu_scaler_tpu_torch.parallel import tp

    t = TRAIN
    cc.reset_launches()
    mesh = pmesh.make_2d_mesh(*SHARD_MESH, dev)
    model = pel.ESRGANLiteTPU(upscale=2, **ptrain.ARCHS[t["arch"]])
    model.load_state_dict(state)
    step, sharded, opt = pel.make_sharded_train_step(model, t["lr"], mesh)
    lrs, hrs = (b.to(dev) for b in batches)
    rec = {"coords": (dist.get_rank(mesh.get_group("data")), dist.get_rank(mesh.get_group("model"))),
           "layout": pel.param_shardings(model, mesh), "device": str(dev)}
    # the signs of the first step's residuals on this rank's part of the
    # batch: the subgradient its L1 loss takes (the same forward as the step's)
    k = lrs.shape[1] // SHARD_MESH[0]
    part = slice(rec["coords"][0] * k, (rec["coords"][0] + 1) * k)
    with torch.no_grad(), pel.fp32_training():
        rec["signs"] = torch.sign(sharded(lrs[0][part]) - hrs[0][part]).to(torch.int8).cpu()
    losses = []
    for s in range(SHARD_STEPS):
        tp.reset_collectives()
        _, _, loss = step(lrs[s % len(lrs)], hrs[s % len(hrs)])
        losses.append(loss)
        if s == 0:
            rec["collectives_per_step"] = dict(tp.collectives)
            rec["first"] = first_step_record(torch, loss, list(sharded.named_parameters()), opt)
    rec["losses"] = [float(v) for v in losses]
    full = pel.gather_model(sharded, mesh)
    if rank == 0:
        ptrain.CKPT_ROOT = Path(ckpt_root)
        ptrain.save_checkpoint(full, t["arch"], 1, t["step"] + SHARD_STEPS)
    rec["step_ms"], rec["host_ms"] = step_times(torch, step, (lrs[0], hrs[0]), SHARD_TIMED)
    if rank == 0:
        rec["trace"] = trace_calls(torch, lambda b: step(*b), (lrs[0], hrs[0]), 5,
                                   Path(trace_dir) / f"sharded_{backend}_trace.json")
    else:  # the same steps as rank 0's window: every rank takes part in each collective
        for _ in range(6):
            step(lrs[0], hrs[0])
    torch.cuda.synchronize()
    rec["conv_launches"] = dict(cc.launches)
    return rec


def sharded_training_on_the_card(torch, card, dev, pool, frame) -> tuple[dict, dict]:
    """Phase 4m: the dp x tp train step (`models/esrgan_lite.py`
    `make_sharded_train_step` on `parallel/mesh.py` `make_2d_mesh`) at full
    width: TRAIN's arch (tpu4b2 x2: 128 features, 2 blocks, stride 4; every
    conv splits by 2) from the committed export, batches of TRAIN's size
    drawn from phase 4k's `PairPool`, on a SHARD_MESH mesh:

    - (a) 4 gloo ranks that share `dev` (`sharded_train_rank`): the first
      step against the single-device `make_train_step` on the same batch on
      the card: the loss within a relative 1e-5; every gradient and Adam
      moment within SHARD_GRAD_BOUND of its leaf's largest entry and the
      parameters 99.9% within 1e-6 and all within 6·lr (phase 4k's bound),
      against that step with the world's L1 residual signs (`held`); each
      leaf equal on the ranks that hold it; then SHARD_STEPS steps cycling
      SHARD_CYCLE batches (the mean loss of the last cycle below the
      first's), the collectives a rank makes a step, the step's CUDA-event
      and host ms beside one card's, and rank 0's profiler window;
    - (b) the weights rank 0 gathered and saved into a temporary CKPT_ROOT,
      loaded by `load_model(..., directory=)` and served 1080p -> 4K by
      `make_serving_fn_fused` (7 conv3x3 launches): against the same graph
      on the plain conv (LEARNED_GATE_DB, alpha equal) and against the
      single-device-trained weights after the same steps, served alike
      (SHARD_SERVE_GATE_DB);
    - (c) a 1 x 1 NCCL world in this process: the same first step, against
      the single-device one, and an all-reduce and a gather on NCCL;
    - (d) with four or more cards visible, the 2 x 2 step on NCCL across
      cuda:0..3, with the gates of (a);
    - (e) no module of the JAX side loaded; nothing written under
      checkpoints/, nu_scaler_tpu_torch/weights/ or checkpoints_torch/.

    Returns (the launches of the phase by kernel, the report)."""
    import concurrent.futures
    import tempfile
    from pathlib import Path

    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.kernels import conv_cuda as cc
    from nu_scaler_tpu_torch.models import esrgan_lite as pel
    from nu_scaler_tpu_torch.models import train as ptrain
    from nu_scaler_tpu_torch.parallel import mesh as pmesh
    from nu_scaler_tpu_torch.parallel import tp

    launches_of = Launches(torch, (cc,))
    t = TRAIN
    lr = t["lr"]
    root = Path(__file__).resolve().parent
    before = guarded_listing(root, pel.WEIGHTS_DIR)
    idx = np.random.default_rng(SEED + 4).integers(0, t["pool_size"], size=(SHARD_CYCLE, t["batch"]))
    batches = (torch.from_numpy(pool.lrs[idx]), torch.from_numpy(pool.hrs[idx]))
    start, step0, own = ptrain.load_latest(t["arch"], 1)
    check(step0 == t["step"] and not own, f"{t['arch']} resumes from step {step0}")
    state = {k: v.detach().clone() for k, v in start.state_dict().items()}
    saved = t["step"] + SHARD_STEPS
    report = {"card": card, "mesh": list(SHARD_MESH), "steps": SHARD_STEPS, "cycle": SHARD_CYCLE,
              "batch": f"{t['batch']} x {t['crop']}^2", "lr": lr}
    tmp = tempfile.TemporaryDirectory(prefix="nu_scaler_4m_")
    trace_dir = Path(_build.BUILD_DIR)

    def run_world(backend: str, devices) -> list:
        ckpt = Path(tmp.name) / backend
        return pmesh.spawn_world(sharded_train_rank, backend, devices,
                                 (backend, state, batches, str(ckpt), str(trace_dir)), timeout=600.0)

    def worst(got: dict, want: dict) -> tuple[float, str]:
        return max((float((got[n] - want[n]).abs().max()) / max(float(want[n].abs().max()), 1e-30), n)
                   for n in want)

    def param_diffs(got: dict, want: dict) -> tuple[float, float]:
        d = torch.cat([(got[n] - want[n]).abs().flatten() for n in want])
        return float((d <= 1e-6).float().mean()), float(d.max())

    def first_step(signs=None, reverse: bool = False) -> dict:
        """One card's first step from `start` on batch 0 (`first_step_record`):
        the plain L1 step, or with `signs` the same step with the L1
        subgradient taking those residual signs (mean((pred - hr) * signs):
        its gradient is L1's wherever the signs agree); `reverse`: the batch
        in reverse order, the same function summed in another order."""
        m = copy.deepcopy(start).to(dev)
        o = pel.adam(m, lr)
        if signs is None:
            step = pel.make_train_step(m, o)
        else:
            s = signs.to(dev, torch.float32)
            step = pel.make_step(m, o, lambda x, y: torch.mean((m(x) - y) * s))
        batch = (lr0.flip(0), hr0.flip(0)) if reverse else (lr0, hr0)
        return first_step_record(torch, step(*batch)[2], list(m.named_parameters()), o)

    def held(tag: str, ranks: list, plain: dict, plain_signs, ref_ms: float) -> dict:
        """The gates of (a) on a world's records: its first loss against one
        card's plain step `plain`; its gradients, moments and parameters
        against one card's step with the world's residual signs (an L1
        residual at the kink, |pred - hr| below the fp32 noise of the
        forward, takes the sign the forward's order of sums gives it, and a
        converged checkpoint has some: their count is reported, with the
        gradients' distance from the plain step). Returns the world's report."""
        recs = sorted((r for r in ranks if r["coords"][0] == 0), key=lambda r: r["coords"][1])
        split = {n for n, spec in recs[0]["layout"].items() if spec}
        signs = torch.cat([r["signs"] for r in sorted((r for r in ranks if r["coords"][1] == 0),
                                                      key=lambda r: r["coords"][0])])
        ref = first_step(signs)

        def full(field: str) -> dict:
            return {n: torch.cat([r["first"][field][n] for r in recs], -1) if n in split
                    else recs[0]["first"][field][n] for n in recs[0]["first"][field]}

        for r in ranks:  # each leaf equal on every rank that holds it
            same = [q for q in ranks if q["coords"][1] == r["coords"][1]]
            for field in ("grads", "mu", "nu", "params"):
                for n, v in r["first"][field].items():
                    peers = same if n in split else ranks
                    check(all(torch.equal(q["first"][field][n], v) for q in peers),
                          f"4m {tag}: {field} {n} differs across the ranks that hold it")
        out = {"devices": sorted({r["device"] for r in ranks}), "split_leaves": len(split),
               "replicated_leaves": sorted(set(recs[0]["layout"]) - split),
               "loss_first": recs[0]["first"]["loss"], "loss_first_single": plain["loss"],
               "loss_rel": abs(recs[0]["first"]["loss"] - plain["loss"]) / plain["loss"],
               "residual_sign_flips": int((signs != plain_signs).sum()), "residuals": signs.numel()}
        out["plain_grads_worst_rel"], out["plain_grads_worst_leaf"] = worst(full("grads"), plain["grads"])
        for field in ("grads", "mu", "nu"):
            out[f"{field}_worst_rel"], out[f"{field}_worst_leaf"] = worst(full(field), ref[field])
            out[f"{field}_bound"], out[f"one_card_{field}_spread"] = bounds[field], spreads[field]
        out["params_within_1e-6"], out["params_max_abs_diff"] = param_diffs(full("params"), ref["params"])
        losses = recs[0]["losses"]
        out.update({"first_cycle_mean_loss": float(np.mean(losses[:SHARD_CYCLE])),
                    "last_cycle_mean_loss": float(np.mean(losses[-SHARD_CYCLE:])),
                    "collectives_per_step": recs[0]["collectives_per_step"],
                    "conv_launches": recs[0]["conv_launches"],
                    "step_ms_by_rank": [r["step_ms"] for r in ranks],
                    "host_ms_by_rank": [r["host_ms"] for r in ranks], "single_step_ms": ref_ms,
                    "rank0_trace": recs[0].get("trace")})
        say(f"4m {tag} [{card}]: " + json.dumps(out))
        check(out["loss_rel"] <= 1e-5, f"4m {tag}: first loss relative {out['loss_rel']:.3g}")
        for field in ("grads", "mu", "nu"):
            check(out[f"{field}_worst_rel"] <= bounds[field],
                  f"4m {tag}: {field} {out[f'{field}_worst_leaf']} off by {out[f'{field}_worst_rel']:.3g}")
        check(out["params_within_1e-6"] >= 0.999 and out["params_max_abs_diff"] <= 6 * lr,
              f"4m {tag}: params {out['params_within_1e-6']:.6f} within 1e-6, max {out['params_max_abs_diff']:.3g}")
        check(out["last_cycle_mean_loss"] < out["first_cycle_mean_loss"], f"4m {tag}: the loss did not fall")
        n_split = sum(1 for n in split if n.endswith(".kernel"))
        check(all(r["collectives_per_step"] == {"all_gather": n_split, "all_reduce": n_split}
                  for r in ranks), f"4m {tag}: collectives a step {recs[0]['collectives_per_step']}")
        check(all(sum(r["conv_launches"].values()) == 0 for r in ranks), f"4m {tag}: a train step launched a kernel")
        return out

    try:
        # (a) the world runs while this process steps the single-device reference
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            world = ex.submit(run_world, "gloo", [dev] * (SHARD_MESH[0] * SHARD_MESH[1]))
            lrs, hrs = (b.to(dev) for b in batches)
            lr0, hr0 = lrs[0], hrs[0]
            with torch.no_grad(), pel.fp32_training():
                plain_signs = torch.sign(copy.deepcopy(start).to(dev)(lr0) - hr0).to(torch.int8).cpu()
            single = copy.deepcopy(start).to(dev)
            opt = pel.adam(single, lr)
            sstep = pel.make_train_step(single, opt)
            losses = []
            for s in range(SHARD_STEPS):
                losses.append(sstep(lrs[s % SHARD_CYCLE], hrs[s % SHARD_CYCLE])[2])
                if s == 0:
                    ref = first_step_record(torch, losses[0], list(single.named_parameters()), opt)
            trained_single = copy.deepcopy(single)
            for p in trained_single.parameters():
                p.requires_grad_(False)
            gloo = world.result()
        ref_ms, ref_host_ms = step_times(torch, sstep, (lrs[0], hrs[0]), SHARD_TIMED)
        # one card's own spread: its first step on the batch reversed
        reversed_step = first_step(reverse=True)
        spreads = {field: worst(reversed_step[field], ref[field])[0] for field in ("grads", "mu", "nu")}
        bounds = {field: max(SHARD_GRAD_BOUND, SHARD_SPREAD_FACTOR * v) for field, v in spreads.items()}
        report["single"] = {"losses_first_cycle_mean": float(np.mean([float(v) for v in losses[:SHARD_CYCLE]])),
                            "losses_last_cycle_mean": float(np.mean([float(v) for v in losses[-SHARD_CYCLE:]])),
                            "step_ms": ref_ms, "host_ms": ref_host_ms}
        report["gloo 2x2 on one card"] = held("gloo 2x2 on one card", gloo, ref, plain_signs, ref_ms)

        # (b) the gathered weights, saved by rank 0, served through conv3x3.cu
        model, meta = pel.load_model(t["arch"], 2, directory=Path(tmp.name) / "gloo")
        check(meta["step"] == saved, f"the sharded checkpoint's step {meta['step']}")
        x = torch.from_numpy(frame[None]).to(dev)
        serving = pel.make_serving_fn_fused(model, IN_H, IN_W, dev)
        out, got = launches_of(lambda: serving(x)[0].cpu().numpy())
        plain = pel.make_serving_fn_fused(model, IN_H, IN_W, dev, conv=cc.conv3x3_plain)(x)[0].cpu().numpy()
        single_out, got_single = launches_of(
            lambda: pel.make_serving_fn_fused(trained_single, IN_H, IN_W, dev)(x)[0].cpu().numpy())
        moved = max(float((p.cpu() - state[n]).abs().max()) for n, p in model.state_dict().items())
        report["serve"] = {"step": meta["step"], "max_param_moved": moved, "launches": got,
                           "vs_plain_conv_db": psnr(out, plain), "vs_plain_conv_max_lsb": lsb(out, plain),
                           "alpha_equal": bool(np.array_equal(out[..., 3], plain[..., 3])),
                           "vs_single_trained_db": psnr(out, single_out),
                           "vs_single_trained_max_lsb": lsb(out, single_out),
                           "vs_single_trained_equal": float((out == single_out).mean())}
        say(f"4m the sharded-trained {t['arch']} x2 served 1080p -> 4K on conv3x3 [{card}]: "
            + json.dumps(report["serve"]))
        check(moved > 0, "the sharded steps moved no parameter")
        check(got == {"conv3x3": 7, "conv3x3_q": 0} and got_single["conv3x3"] == 7, f"serving launches {got}")
        check(out.shape == (OUT_H, OUT_W, 4) and report["serve"]["vs_plain_conv_db"] >= LEARNED_GATE_DB
              and report["serve"]["alpha_equal"], f"4m serving vs its plain conv: {report['serve']}")
        check(report["serve"]["vs_single_trained_db"] >= SHARD_SERVE_GATE_DB,
              f"4m served vs the single-device-trained weights: {report['serve']['vs_single_trained_db']:.2f} dB")

        # (c) a 1 x 1 NCCL world in this process
        with pmesh.world(0, 1, "nccl", dev, str(Path(tmp.name) / "nccl_store")):
            mesh = pmesh.make_2d_mesh(1, 1, dev)
            one = copy.deepcopy(start)
            step, sharded, nopt = pel.make_sharded_train_step(one, lr, mesh)
            _, _, loss = step(batches[0][0], batches[1][0])
            rec = first_step_record(torch, loss, list(sharded.named_parameters()), nopt)
            tp.reset_collectives()
            summed = tp.all_reduce(torch.arange(4.0, device=dev), mesh.get_group("data"))
            gathered = tp.all_gather_last(torch.ones(2, 3, device=dev), mesh.get_group("model"))
            nccl = {"backend": torch.distributed.get_backend(),
                    "loss_rel": abs(rec["loss"] - ref["loss"]) / ref["loss"],
                    "collectives": dict(tp.collectives),
                    "probe_ok": bool(torch.equal(summed.cpu(), torch.arange(4.0))
                                     and gathered.shape == (2, 3))}
            nccl["grads_worst_rel"] = worst(rec["grads"], ref["grads"])[0]
            nccl["params_within_1e-6"], nccl["params_max_abs_diff"] = param_diffs(rec["params"], ref["params"])
            nccl["step_ms"], nccl["host_ms"] = step_times(torch, step, (lrs[0], hrs[0]), SHARD_TIMED)
        report["nccl 1x1"] = nccl
        say(f"4m NCCL 1 x 1 world [{card}]: " + json.dumps(nccl))
        check(nccl["backend"] == "nccl" and nccl["probe_ok"] and nccl["loss_rel"] <= 1e-5
              and nccl["grads_worst_rel"] <= SHARD_GRAD_BOUND and nccl["params_within_1e-6"] >= 0.999
              and nccl["params_max_abs_diff"] <= 6 * lr, f"4m NCCL 1 x 1: {nccl}")

        # (d) the step across four cards on NCCL
        if torch.cuda.device_count() >= 4:
            cards = [torch.device("cuda", i) for i in range(4)]
            report["nccl 2x2 on four cards"] = held("nccl 2x2 on four cards", run_world("nccl", cards), ref,
                                                   plain_signs, ref_ms)

        # (e) no module of the JAX side; nothing written outside the temporary root
        jax_side = jax_side_modules(root)
        check(not jax_side, f"modules of the JAX side loaded: {jax_side}")
    finally:
        tmp.cleanup()
    check(guarded_listing(root, pel.WEIGHTS_DIR) == before,
          "phase 4m wrote under checkpoints/, the committed weights or checkpoints_torch/")
    say(f"sharded training on the card [{card}]: launches {json.dumps(launches_of.total)}")
    return launches_of.total, report


def clear_loader_caches() -> None:
    """Empty every loader's cache, as a new process has them: the API then
    serves what the trainer's CKPT_ROOT (else the committed export) holds."""
    from nu_scaler_tpu_torch.models import esrgan_lite as pel
    from nu_scaler_tpu_torch.models import interp_refine as pir
    from nu_scaler_tpu_torch.ops import interpolate as interp

    for fn in (pel._cached_model, pel._build_pretrained, pir.load_model, pir._refine_graph,
               interp._interpolator, interp._multi_interpolator, interp._refined_mid_upscaler,
               interp._refined_multi_upscaler):
        fn.cache_clear()


def serving_after_training(torch, card, dev, frame, pool, trained) -> dict:
    """Phase 4n: train -> serve -> resume at full width, seed 0, through the
    entry points a user calls, after phase 4k's trainers wrote into its
    CKPT_ROOT (`trained`: that root, with the CLI's tpu4b2 x2 step at 76050
    calibrated with --io and interp_ref4 at 112020 calibrated, and what 4k
    served from them), the loaders' caches cleared as a new process has
    them:

    - (b) with 4k's root as CKPT_ROOT: `create_advanced_upscaler("ultra")`
      on the "quality" ladder (the default `learned_prefer`) at 1080p -> 4K
      serves tpu4b2@76050 in int8 from that root, 8 conv3x3_q launches, the
      bytes 4k served through `load_model(directory=)`; the CLI writes
      76051 with no calibration, and "quality" falls to the committed tpu4
      x2 int8 at 80000 (8 conv3x3_q, its bf16 head on conv3x3): against the
      same graph on the plain versions (bit-equal where every conv is int8,
      else >= LEARNED_GATE_DB and alpha equal, phase 4d's rule) and >=
      INT8_LEARNED's x2 gate against `make_quant_apply`; "ultra" serves
      76051 in bf16 (7 conv3x3) >= LEARNED_GATE_DB against the plain conv,
      alpha equal; `WgpuFrameInterpolator("flow_soft_ref")` at 1080p serves
      interp_ref4@112020 in int8 (4 conv3x3_q, 1 soft_warp_blend), its mid
      the one 4k's `RefineGraph` on the trained module gave;
    - (c) with the run's empty CKPT_ROOT: `train.load_latest("tpu4", 1)`
      resumes from the committed 80000 and `load_export_opt_state` restores
      Adam's moments; one step on the card and one on the CPU on a batch of
      TRAIN's size from 4k's `PairPool`: the loss within a relative 1e-5,
      the parameters 99.9% within 1e-6 and all within 6·lr (4k's bounds);
    - (d) `teacher_outputs("tpu4", 1, …)` on 64 pool crops, card against
      CPU, within TEACHER_GATE; two interp_ref4 distillation steps from the
      committed 112000 with the teacher DISTILL_TEACHER resolved from its
      committed export, on 4k's `TripletPool`, card against CPU: the first
      loss within a relative 1e-5;
    - (e) tpu8 and tpu8w x2 on their committed weights at 1080p -> 4K
      through `load_model` + `make_serving_fn` on conv3x3 (9 launches each):
      >= LEARNED_GATE_DB against the same graph on the plain conv, alpha
      equal, and >= RUNG_TWIN_GATE_DB against the fp32 twin (4f's gates).

    Each learned call's arch, step and source directory are printed. 4k's
    root is removed at the end, and the loaders' caches cleared again.
    Returns the launches of the phase by kernel."""
    from pathlib import Path

    from nu_scaler_tpu_torch.core import WgpuFrameInterpolator, create_advanced_upscaler
    from nu_scaler_tpu_torch.kernels import conv_cuda as cc
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc
    from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
    from nu_scaler_tpu_torch.models import esrgan_lite as pel
    from nu_scaler_tpu_torch.models import interp_refine as pir
    from nu_scaler_tpu_torch.models import train as ptrain

    launches_of = Launches(torch, (rc, swc, cc))
    t, lr = TRAIN, TRAIN["lr"]
    cpu = torch.device("cpu")
    report = {"card": card}
    x = torch.from_numpy(frame[None]).to(dev)
    x01 = torch.from_numpy(frame[None, ..., :3].astype(np.float32) / 255.0).to(dev)

    def served(prefer: str):
        """(the learned fn, its 4K output, its launches) of the API's learned
        tier on the `prefer` ladder at 1080p -> 4K."""
        up = create_advanced_upscaler("ultra")
        up.learned_prefer = prefer
        up.initialize(IN_W, IN_H, OUT_W, OUT_H)
        fn = up._fn
        out, got = launches_of(lambda: up.upscale(frame.tobytes()))
        say(f"4n learned {prefer} x2: {fn.arch}@{fn.step} from {fn.directory}, int8 {fn.quantized}, "
            f"launches {json.dumps(got)}")
        return fn, np.frombuffer(out, np.uint8).reshape(OUT_H, OUT_W, 4), got

    run_root = ptrain.CKPT_ROOT
    ptrain.CKPT_ROOT = Path(trained["tmp"].name)
    clear_loader_caches()
    try:
        # (b) serve what 4k's trainers wrote
        fn, out, got = served("quality")
        report["quality_trained"] = {"arch": fn.arch, "step": fn.step, "directory": str(fn.directory),
                                     "quantized": fn.quantized, "launches": got,
                                     "equals_4k_served": bool(np.array_equal(out, trained["served"]))}
        check((fn.arch, fn.step, fn.directory, fn.quantized) == (t["arch"], trained["saved"], ptrain.CKPT_ROOT, True)
              and ran(got) == {"conv3x3_q": 8},
              f"quality after the CLI's calibrated step: {report['quality_trained']}")
        check(report["quality_trained"]["equals_4k_served"], "quality's bytes differ from 4k's served checkpoint")

        further = trained["saved"] + 1
        check(ptrain.main(["--arch", t["arch"], "--steps", "1", "--batch", str(t["batch"]),
                           "--data", "synthetic"]) == 0, "the CLI's further step failed")
        check(pel.sidecar_scales(pel._sidecar(t["arch"], 2, ptrain.CKPT_ROOT)) is None,
              "the further step carries a calibration")
        clear_loader_caches()
        fn, out, got = served("quality")
        model, meta = pel.load_model("tpu4", 2)
        scales = pel.sidecar_scales(meta)
        plain = pel.make_serving_fn_fused(model, IN_H, IN_W, dev, conv=cc.conv3x3_plain, quant_scales=scales,
                                          conv_q=cc.conv3x3_q_plain)(x)[0].cpu().numpy()
        twin = u8(pel.make_quant_apply(model, scales)(x01)[0])
        n_bf16 = got["conv3x3"]
        report["quality_fallback"] = {
            "arch": fn.arch, "step": fn.step, "directory": str(fn.directory), "quantized": fn.quantized,
            "launches": got, "vs_plain_path_equal": float((out == plain).mean()), "vs_plain_path_db": psnr(out, plain),
            "vs_plain_path_max_lsb": lsb(out, plain), "alpha_equal": bool(np.array_equal(out[..., 3], plain[..., 3])),
            "vs_int8_twin_db": psnr(out, twin)}
        say(f"4n quality x2 after a step with no calibration [{card}]: " + json.dumps(report["quality_fallback"]))
        check((fn.arch, fn.step, fn.directory, fn.quantized) == ("tpu4", 80000, pel.WEIGHTS_DIR, True)
              and ran(got) == {"conv3x3_q": 8, **({} if "head" in scales else {"conv3x3": 1})},
              f"quality after the uncalibrated step: {report['quality_fallback']}")
        check(report["quality_fallback"]["vs_plain_path_db"] >= LEARNED_GATE_DB
              and report["quality_fallback"]["alpha_equal"]
              and (n_bf16 > 0 or report["quality_fallback"]["vs_plain_path_equal"] == 1.0),
              f"tpu4 x2 int8 vs its plain path: {report['quality_fallback']}")
        check(report["quality_fallback"]["vs_int8_twin_db"] >= INT8_LEARNED[0][6],
              f"tpu4 x2 int8 vs its twin: {report['quality_fallback']['vs_int8_twin_db']:.2f} dB")

        fn, out, got = served("ultra")
        model, meta = pel.load_model(t["arch"], 2, ptrain.CKPT_ROOT)
        plain = pel.make_serving_fn_fused(model, IN_H, IN_W, dev, conv=cc.conv3x3_plain)(x)[0].cpu().numpy()
        report["ultra_trained"] = {"arch": fn.arch, "step": fn.step, "directory": str(fn.directory),
                                   "quantized": fn.quantized, "launches": got, "vs_plain_conv_db": psnr(out, plain),
                                   "alpha_equal": bool(np.array_equal(out[..., 3], plain[..., 3]))}
        say(f"4n ultra x2 after the further step [{card}]: " + json.dumps(report["ultra_trained"]))
        check((fn.arch, fn.step, fn.directory, fn.quantized, meta["step"])
              == (t["arch"], further, ptrain.CKPT_ROOT, False, further) and ran(got) == {"conv3x3": 7},
              f"ultra after the further step: {report['ultra_trained']}")
        check(report["ultra_trained"]["vs_plain_conv_db"] >= LEARNED_GATE_DB and report["ultra_trained"]["alpha_equal"],
              f"ultra's new step vs its plain conv: {report['ultra_trained']}")

        fr = WgpuFrameInterpolator(mode="flow_soft_ref")
        ab = (trained["pair"][0].cpu().numpy().tobytes(), trained["pair"][1].cpu().numpy().tobytes())
        mid, got = launches_of(lambda: fr.interpolate_py(*ab, IN_W, IN_H))
        meta = pir.load_model()[1]
        mid = np.frombuffer(mid, np.uint8).reshape(IN_H, IN_W, 4)
        report["flow_soft_ref_trained"] = {"net": meta["net"], "step": meta["step"],
                                           "directory": str(pir._newest()[1]),
                                           "int8": pir.get_refine_graph(IN_H, IN_W, dev).quantized, "launches": got,
                                           "equals_4k_graph": bool(np.array_equal(mid, trained["refine_mid"]))}
        say(f"4n flow_soft_ref at 1080p: {meta['net']}@{meta['step']} from "
            f"{report['flow_soft_ref_trained']['directory']} [{card}]: " + json.dumps(report["flow_soft_ref_trained"]))
        check(meta["step"] == trained["rstep"] and report["flow_soft_ref_trained"]["int8"]
              and ran(got) == {"conv3x3_q": 4, "soft_warp_blend": 1}
              and report["flow_soft_ref_trained"]["equals_4k_graph"],
              f"flow_soft_ref after 4k's leg: {report['flow_soft_ref_trained']}")
    finally:
        ptrain.CKPT_ROOT = run_root
        clear_loader_caches()
        trained["tmp"].cleanup()

    # (c) resume tpu4 x2 from the committed 80000 with Adam's moments
    rng = np.random.default_rng(SEED + 5)
    idx = rng.integers(0, pool.lrs.shape[0], size=t["batch"])
    batch = (torch.from_numpy(pool.lrs[idx]), torch.from_numpy(pool.hrs[idx]))
    resumed, losses = {}, {}
    for where, d in (("card", dev), ("cpu", cpu)):
        model, step0, own = ptrain.load_latest("tpu4", 1)
        model.to(d)
        opt = pel.adam(model, lr)
        check(step0 == 80000 and not own and ptrain.load_export_opt_state(opt, model, "tpu4", 1, step0),
              f"tpu4 x2 resumes from {step0} (own {own}) without the export's moments")
        count = {float(s["step"]) for s in opt.state.values()}
        (_, _, losses[where]), got = launches_of(lambda: pel.make_train_step(model, opt, "l1")(
            *(b.to(d) for b in batch)))
        resumed[where] = model
        check(not ran(got) and {float(s["step"]) for s in opt.state.values()} == {c + 1 for c in count},
              f"the tpu4 resume step: launches {got}, Adam counts {count}")
    rel = abs(float(losses["card"]) - float(losses["cpu"])) / float(losses["cpu"])
    within, max_d = param_diffs(resumed["card"], resumed["cpu"])
    report["resume_tpu4_x2"] = {"from": 80000, "adam_count": sorted(count)[0], "loss_card": float(losses["card"]),
                                "loss_cpu": float(losses["cpu"]), "loss_rel": rel, "params_within_1e-6": within,
                                "params_max_abs_diff": max_d}
    say(f"4n tpu4 x2 resumed from 80000 with the export's moments, card vs CPU [{card}]: "
        + json.dumps(report["resume_tpu4_x2"]))
    check(rel <= 1e-5 and within >= 0.999 and max_d <= 6 * lr, f"4n resume: {report['resume_tpu4_x2']}")

    # (d) the teachers: tpu4 x2 for `--distill tpu4`, interp_ref4w for the refinement net
    lrs = pool.lrs[:64]
    t_card = ptrain.teacher_outputs("tpu4", 1, lrs, dev)
    t_cpu = ptrain.teacher_outputs("tpu4", 1, lrs, "cpu")
    report["teacher_tpu4_x2"] = {"crops": int(lrs.shape[0]), "max_abs_diff": float(np.abs(t_card - t_cpu).max()),
                                 "gate": TEACHER_GATE}
    name, t_features, t_blocks = DISTILL_TEACHER
    student0, sstep = pir.load_checkpoint()
    teacher0, tstep = pir.load_checkpoint(name)
    check(sstep == REFINE_STEP and (teacher0.features, teacher0.blocks) == (t_features, t_blocks),
          f"the distillation resolves {pir.NET}@{sstep} and {name} {teacher0.features}/{teacher0.blocks}")
    tpool = trained["tpool"]
    didx = np.random.default_rng(SEED + 6).integers(0, tpool.xs.shape[0], size=(2, t["batch"]))
    dlosses, students = {}, {}
    for where, d in (("card", dev), ("cpu", cpu)):
        student, teacher = copy.deepcopy(student0).to(d), copy.deepcopy(teacher0).to(d)
        step = pel.make_step(student, pel.adam(student, lr),
                             lambda xb, yb, s_=student, t_=teacher: pir.refine_loss(s_, xb, yb, t_, 0.5))
        seen = []
        for i in range(2):
            xb, yb = (torch.from_numpy(a[didx[i]]).to(d) for a in (tpool.xs, tpool.ys))
            (_, _, lv), got = launches_of(lambda: step(xb, yb))
            check(not ran(got), f"the distillation step launched a kernel: {got}")
            seen.append(float(lv))
        dlosses[where], students[where] = seen, student
    rel = abs(dlosses["card"][0] - dlosses["cpu"][0]) / dlosses["cpu"][0]
    within, max_d = param_diffs(students["card"], students["cpu"])
    second_rel = abs(dlosses["card"][1] - dlosses["cpu"][1]) / dlosses["cpu"][1]
    report["distill_interp_ref4w"] = {"student": f"{pir.NET}@{sstep}", "teacher": f"{name}@{tstep}",
                                      "losses_card": dlosses["card"], "losses_cpu": dlosses["cpu"],
                                      "first_loss_rel": rel, "second_loss_rel": second_rel,
                                      "params_within_1e-6": within, "params_max_abs_diff": max_d}
    say(f"4n teachers, card vs CPU [{card}]: " + json.dumps({k: report[k] for k in ("teacher_tpu4_x2",
                                                                                    "distill_interp_ref4w")}))
    check(report["teacher_tpu4_x2"]["max_abs_diff"] <= TEACHER_GATE, f"tpu4 teacher: {report['teacher_tpu4_x2']}")
    check(rel <= 1e-5, f"interp_ref4w distillation, first loss: card vs CPU relative {rel:.3g}")

    # (e) the stride-8 archs on their committed weights
    for arch in ("tpu8", "tpu8w"):
        model, meta = pel.load_model(arch, 2)
        serving = pel.make_serving_fn(model, IN_H, IN_W, OUT_H, OUT_W, dev)
        out, got = launches_of(lambda: serving(x)[0].cpu().numpy())
        plain = pel.make_serving_fn(model, IN_H, IN_W, OUT_H, OUT_W, dev, conv=cc.conv3x3_plain)(x)[0].cpu().numpy()
        twin = u8(pel.make_twin(model, OUT_H, OUT_W)(x01)[0])
        rep = {"step": meta["step"], "features": model.features, "base": model.base_impl,
               "graph": type(serving).__name__, "launches": got, "vs_plain_conv_db": psnr(out, plain),
               "alpha_equal": bool(np.array_equal(out[..., 3], plain[..., 3])), "vs_twin_db": psnr(out, twin)}
        report[f"{arch}_x2"] = rep
        say(f"4n {arch}@{meta['step']} x2 from {pel.WEIGHTS_DIR} at 1080p -> 4K [{card}]: " + json.dumps(rep))
        check(isinstance(serving, pel.FusedServing) and ran(got) == {"conv3x3": serving.convs_per_frame}
              and serving.convs_per_frame == 9, f"{arch}: {rep}")
        check(out.shape == (OUT_H, OUT_W, 4) and rep["vs_plain_conv_db"] >= LEARNED_GATE_DB and rep["alpha_equal"],
              f"{arch} vs its plain conv: {rep}")
        check(rep["vs_twin_db"] >= RUNG_TWIN_GATE_DB, f"{arch} vs its fp32 twin: {rep['vs_twin_db']:.2f} dB")
    say(f"serving after training on the card [{card}]: launches {json.dumps(launches_of.total)}")
    return launches_of.total


def clis_on_the_card(torch, card, dev, frame, pair) -> dict:
    """Phase 4o: the trainers' command lines on the card, in process through
    their `main([...])`, at the serving net's full width (128 features, 1
    block, 1080p frames; the pools' depths cut as REFINE_TRAIN and CLI_CLIPS
    print them), with CKPT_ROOT (and so the refinement net's checkpoint
    directory) an empty temporary directory and the loaders' caches cleared
    before and after:

    - (a) `interp_refine --calibrate --clips CLI_CLIPS` copies the committed
      interp_ref4@112000 into the empty root and writes its scales there
      (6 soft_warp_blend launches a clip: the pool's mids); the same
      `calibrate_scales` on the CPU (the plain soft warp's mids) within a
      relative CLI_SCALE_GATE; `WgpuFrameInterpolator("flow_soft_ref")` at
      1080p then serves 112000 in int8 from the copy (4 conv3x3_q, 1
      soft_warp_blend), its mid `RefineGraph`'s and >= INT8_LEARNED's x2
      gate against `make_quant_apply` (phase 4n's);
    - (b) `interp_refine --steps N` resumes from the calibrated 112000 and
      saves 112000 + N: every loss finite, the step's CUDA-event ms on the
      leg's pool; the new step carries no calibration, so "flow_soft_ref"
      serves it in bf16 (4 conv3x3, 1 soft_warp_blend);
    - (c) `--distill-name interp_ref4w --steps CLI_DISTILL_STEPS` from that
      step, on the card and on the CPU (the card's saved step removed
      first): the first loss within a relative 1e-5 (phase 4n's bound);
    - (d) `--eval` with JAX's protocol (seeds 900-902, 5 frames, 1080p):
      its dB and SSIM printed, 6 soft_warp_blend launches; then
      `eval_refine_float` on CLI_EVAL_CUT, card against CPU, within
      EVAL_GATE;
    - (e) `train --arch tpu4b2 --calibrate --io` copies the committed 76000
      (npz, sidecar, Adam moments) and writes its scales; "quality" x2 at
      1080p -> 4K serves it from the copy on 8 conv3x3_q launches: equal to
      the committed step's served bytes where the scales are the committed
      ones, else phase 4d's gates (bit-equal to the plain path, >= 42 dB
      against `make_quant_apply`).

    No module of the JAX side loaded; nothing written under checkpoints/,
    the committed weights or checkpoints_torch/. Returns the launches of the
    phase by kernel."""
    import contextlib
    import tempfile
    from pathlib import Path

    from nu_scaler_tpu_torch.core import WgpuFrameInterpolator, create_advanced_upscaler
    from nu_scaler_tpu_torch.kernels import conv_cuda as cc
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc
    from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
    from nu_scaler_tpu_torch.models import esrgan_lite as pel
    from nu_scaler_tpu_torch.models import interp_refine as pir
    from nu_scaler_tpu_torch.models import train as ptrain
    from nu_scaler_tpu_torch.ops import interpolate as interp

    launches_of = Launches(torch, (rc, swc, cc))
    root = Path(__file__).resolve().parent
    before = guarded_listing(root, pel.WEIGHTS_DIR)
    r, cpu = REFINE_TRAIN, torch.device("cpu")
    mids_a_clip = 8 - 2  # TripletPool: 8 frames a clip, a mid between each pair two frames apart
    report = {"card": card, "reduced": {"calibrate_clips": f"{CLI_CLIPS} of 12", "train_clips": f"{r['n_clips']} of 12",
                                        "pool": f"{r['pool_size']} of 4096", "steps": f"{r['steps']} of 8000",
                                        "distill_steps": CLI_DISTILL_STEPS, "eval_cut": CLI_EVAL_CUT}}
    say("4o command lines, depths cut (widths full: 128 features, 1 block, 1080p): " + json.dumps(report["reduced"]))

    @contextlib.contextmanager
    def recording(module, name: str):
        """`module.name` wrapped to record what each call returns."""
        seen, fn = [], getattr(module, name)

        def wrapped(*args, **kw):
            seen.append(fn(*args, **kw))
            return seen[-1]

        setattr(module, name, wrapped)
        try:
            yield seen
        finally:
            setattr(module, name, fn)

    @contextlib.contextmanager
    def step_losses():
        """Every loss of the refinement trainer's steps (`pir.make_step`'s)."""
        seen, make = [], pir.make_step

        def recording_make(*args, **kw):
            step = make(*args, **kw)

            def rec(*batch):
                out = step(*batch)
                seen.append(float(out[2]))
                return out

            return rec

        pir.make_step = recording_make
        try:
            yield seen
        finally:
            pir.make_step = make

    def serve_refined():
        """(the mid "flow_soft_ref" serves at 1080p, its launches, the graph
        and sidecar that serve)."""
        fr = WgpuFrameInterpolator(mode="flow_soft_ref")
        ab = (pair[0].cpu().numpy().tobytes(), pair[1].cpu().numpy().tobytes())
        mid, got = launches_of(lambda: fr.interpolate_py(*ab, IN_W, IN_H))
        return (np.frombuffer(mid, np.uint8).reshape(IN_H, IN_W, 4), got, pir.get_refine_graph(IN_H, IN_W, dev),
                pir.load_model()[1])

    size = ["--height", str(IN_H), "--width", str(IN_W)]  # the CLI's defaults at 1080p
    tmp = tempfile.TemporaryDirectory(prefix="nu_scaler_4o_")
    ckpt = Path(tmp.name)
    run_root = ptrain.CKPT_ROOT
    ptrain.CKPT_ROOT = ckpt
    clear_loader_caches()
    try:
        # (a) --calibrate of the committed step on the empty root
        with recording(pir, "calibrate_scales") as cal:
            code, got = launches_of(lambda: pir.main(["--calibrate", "--clips", str(CLI_CLIPS), *size]))
        scales = cal[0]
        sidecar = ckpt / pir.NET / f"{pir.NET}_{REFINE_STEP}.json"
        check(code == 0 and sorted(p.name for p in (ckpt / pir.NET).iterdir())
              == [sidecar.name, sidecar.with_suffix(".npz").name], "--calibrate did not copy the committed step")
        check(pel.sidecar_scales(json.loads(sidecar.read_text())) == scales, "--calibrate's sidecar")
        check(ran(got) == {"soft_warp_blend": mids_a_clip * CLI_CLIPS}, f"--calibrate launches {got}")
        cpu_scales = pir.calibrate_scales(pir.load_checkpoint()[0], n_clips=CLI_CLIPS, height=IN_H, width=IN_W,
                                          device="cpu")
        rel = {k: abs(scales[k] - cpu_scales[k]) / abs(cpu_scales[k]) for k in cpu_scales}
        clear_loader_caches()
        mid, got, graph, meta = serve_refined()
        model = pir.load_model()[0]
        a, b = pair
        soft = interp.soft_interp_fast(a, b, 0.5)
        twin = u8(pir.make_quant_apply(model, scales)(*(t[None, ..., :3].float() / 255.0 for t in (a, b, soft)))[0])
        report["calibrate"] = {"step": meta["step"], "scales": scales, "cpu_scales": cpu_scales,
                               "scales_rel_diff": rel, "launches": got, "directory": str(pir._newest()[1]),
                               "int8": graph.quantized, "equals_graph": bool(np.array_equal(
                                   mid, graph(a, b, soft).cpu().numpy())), "vs_int8_twin_db": psnr(mid, twin)}
        say(f"4o interp_refine --calibrate of {pir.NET}@{REFINE_STEP} on an empty root, then flow_soft_ref at 1080p "
            f"[{card}]: " + json.dumps(report["calibrate"]))
        check(max(rel.values()) <= CLI_SCALE_GATE, f"--calibrate's scales, card vs CPU: {rel}")
        check(meta["step"] == REFINE_STEP and graph.quantized and graph.quant_scales == scales
              and pir._newest()[1] == ckpt / pir.NET and ran(got) == {"conv3x3_q": 4, "soft_warp_blend": 1}
              and report["calibrate"]["equals_graph"], f"flow_soft_ref after --calibrate: {report['calibrate']}")
        check(report["calibrate"]["vs_int8_twin_db"] >= INT8_LEARNED[0][6],
              f"the calibrated mid vs make_quant_apply: {report['calibrate']['vs_int8_twin_db']:.2f} dB")

        # (b) a leg from the calibrated step; the new step serves in bf16
        args = ["--steps", str(r["steps"]), "--clips", str(r["n_clips"]), "--pool", str(r["pool_size"]), *size]
        with step_losses() as losses, recording(pir, "TripletPool") as pools:
            code, got = launches_of(lambda: pir.main(args))
        trained, tstep = pir.load_checkpoint()
        check(code == 0 and tstep == REFINE_STEP + r["steps"] and len(losses) == r["steps"]
              and all(np.isfinite(losses)), f"the leg saved {tstep}, losses {losses}")
        check(ran(got) == {"soft_warp_blend": mids_a_clip * r["n_clips"]}, f"the leg's launches {got}")
        xs, ys = (torch.from_numpy(v).to(dev) for v in (pools[0].xs, pools[0].ys))
        idx = torch.from_numpy(np.random.default_rng(1).integers(0, r["pool_size"], size=TRAIN["batch"])).to(dev)
        rm = copy.deepcopy(trained).to(dev)
        step = pel.make_step(rm, pel.adam(rm, 2e-4), lambda xb, yb: pir.refine_loss(rm, xb, yb))
        step_ms, host_ms = step_times(torch, step, (xs[idx], ys[idx]), TRAIN_TIMED)
        clear_loader_caches()
        _, served_got, graph, meta = serve_refined()
        report["leg"] = {"from": REFINE_STEP, "saved": tstep, "first_loss": losses[0], "final_loss": losses[-1],
                         "launches": got, "step_device_ms": step_ms, "step_host_ms": host_ms,
                         "crops_per_s": TRAIN["batch"] / step_ms * 1e3,
                         "served": {"step": meta["step"], "int8": graph.quantized, "launches": served_got}}
        say(f"4o interp_refine --steps {r['steps']} from the calibrated {REFINE_STEP}, batch {TRAIN['batch']} x 96^2 "
            f"[{card}]: " + json.dumps(report["leg"]))
        check(meta["step"] == tstep and not graph.quantized and ran(served_got) == {"conv3x3": 4, "soft_warp_blend": 1},
              f"flow_soft_ref after the leg: {report['leg']['served']}")

        # (c) distillation from interp_ref4w, card against CPU, each from tstep
        dargs = ["--distill-name", DISTILL_TEACHER[0], "--distill-features", str(DISTILL_TEACHER[1]),
                 "--distill-blocks", str(DISTILL_TEACHER[2]), "--steps", str(CLI_DISTILL_STEPS),
                 "--clips", str(r["n_clips"]), "--pool", str(r["pool_size"]), *size]
        saved = ckpt / pir.NET / f"{pir.NET}_{tstep + CLI_DISTILL_STEPS}"
        dlosses, students, dgot = {}, {}, {}
        for where, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            with step_losses() as losses:
                code, dgot[where] = launches_of(lambda: pir.main(dargs + extra))
            students[where], dstep = pir.load_checkpoint()
            check(code == 0 and dstep == tstep + CLI_DISTILL_STEPS and len(losses) == CLI_DISTILL_STEPS,
                  f"the {where} distillation saved {dstep}, losses {losses}")
            dlosses[where] = losses
            if where == "card":  # the CPU leg starts from tstep too
                for suffix in (".npz", ".json"):
                    saved.with_suffix(suffix).unlink()
        rel = abs(dlosses["card"][0] - dlosses["cpu"][0]) / dlosses["cpu"][0]
        within, max_d = param_diffs(students["card"], students["cpu"])
        report["distill"] = {"student": f"{pir.NET}@{tstep}", "teacher": f"{DISTILL_TEACHER[0]}@"
                             f"{pir.load_checkpoint(DISTILL_TEACHER[0])[1]}", "losses_card": dlosses["card"],
                             "losses_cpu": dlosses["cpu"], "first_loss_rel": rel, "params_within_1e-6": within,
                             "params_max_abs_diff": max_d, "launches": dgot["card"]}
        say(f"4o interp_refine --distill-name {DISTILL_TEACHER[0]}, card vs CPU [{card}]: "
            + json.dumps(report["distill"]))
        check(rel <= 1e-5, f"the distillation's first loss: card vs CPU relative {rel:.3g}")
        check(ran(dgot["card"]) == {"soft_warp_blend": mids_a_clip * r["n_clips"]} and not ran(dgot["cpu"]),
              f"the distillation's launches {dgot}")

        # (d) --eval with JAX's protocol, then the cut protocol card vs CPU
        with recording(pir, "eval_refine_float") as evals:
            code, got = launches_of(lambda: pir.main(["--eval", *size]))
        card_cut = pir.eval_refine_float(**CLI_EVAL_CUT, device=dev)
        cpu_cut = pir.eval_refine_float(**CLI_EVAL_CUT, device="cpu")
        report["eval"] = {"jax_protocol": evals[0], "launches": got, "cut_card": card_cut, "cut_cpu": cpu_cut}
        say(f"4o interp_refine --eval at 1080p (3 seeds x 5 frames) [{card}]: {evals[0]['ref_psnr_db']:.4f} dB / "
            f"{evals[0]['ref_ssim']:.4f} SSIM vs soft {evals[0]['soft_psnr_db']:.4f} / {evals[0]['soft_ssim']:.4f}; "
            + json.dumps(report["eval"]))
        check(code == 0 and ran(got) == {"soft_warp_blend": 6}, f"--eval launches {got}")
        for k in ("soft_psnr_db", "ref_psnr_db", "soft_ssim", "ref_ssim"):
            bound = EVAL_GATE[0] if k.endswith("_db") else EVAL_GATE[1]
            check(abs(card_cut[k] - cpu_cut[k]) <= bound, f"eval {k}: card {card_cut[k]} vs CPU {cpu_cut[k]}")

        # (e) the SR command line's --calibrate --io of the committed step
        arch, sr_step = TRAIN["arch"], TRAIN["step"]
        code, got = launches_of(lambda: ptrain.main(["--arch", arch, "--calibrate", "--io"]))
        stem = f"esrgan_{arch}_x2_{sr_step}"
        names = sorted(p.name for p in ckpt.iterdir() if p.is_file())
        sr_scales = pel.load_act_scales(arch, 2, ckpt)
        check(code == 0 and not ran(got) and names == [f"{stem}.json", f"{stem}.npz", f"{stem}_opt.npz"]
              and sr_scales["head"] == sr_scales["base"] == 1.0, f"train --calibrate --io wrote {names}: {sr_scales}")
        clear_loader_caches()
        up = create_advanced_upscaler("ultra")
        up.learned_prefer = "quality"
        up.initialize(IN_W, IN_H, OUT_W, OUT_H)
        fn = up._fn
        out, got = launches_of(lambda: np.frombuffer(up.upscale(frame.tobytes()), np.uint8).reshape(OUT_H, OUT_W, 4))
        model, meta = pel.load_model(arch, 2)  # the committed export
        committed = pel.sidecar_scales(meta)
        x = torch.from_numpy(frame[None]).to(dev)
        rep = {"arch": fn.arch, "step": fn.step, "directory": str(fn.directory), "quantized": fn.quantized,
               "launches": got, "scales": sr_scales, "scales_equal_committed": sr_scales == committed,
               "scales_rel_diff_committed": {k: abs(sr_scales[k] - v) / abs(v) for k, v in committed.items()}}
        if rep["scales_equal_committed"]:
            want = pel.make_serving_fn_fused(model, IN_H, IN_W, dev, quant_scales=committed)(x)[0].cpu().numpy()
            rep["equals_committed_served"] = bool(np.array_equal(out, want))
        else:
            plain = pel.make_serving_fn_fused(model, IN_H, IN_W, dev, conv=cc.conv3x3_plain, quant_scales=sr_scales,
                                              conv_q=cc.conv3x3_q_plain)(x)[0].cpu().numpy()
            x01 = torch.from_numpy(frame[None, ..., :3].astype(np.float32) / 255.0).to(dev)
            rep["vs_plain_path_equal"] = float((out == plain).mean())
            rep["vs_int8_twin_db"] = psnr(out, u8(pel.make_quant_apply(model, sr_scales)(x01)[0]))
        report["sr_calibrate"] = rep
        say(f"4o train --arch {arch} --calibrate --io on an empty root, then quality x2 1080p -> 4K [{card}]: "
            + json.dumps(rep))
        check((fn.arch, fn.step, fn.directory, fn.quantized) == (arch, sr_step, ckpt, True)
              and ran(got) == {"conv3x3_q": 8}, f"quality after the SR --calibrate: {rep}")
        check(rep.get("equals_committed_served", False) or (rep["vs_plain_path_equal"] == 1.0
                                                            and rep["vs_int8_twin_db"] >= INT8_LEARNED[0][6]),
              f"the calibrated committed step served: {rep}")

        jax_side = jax_side_modules(root)
        check(not jax_side, f"modules of the JAX side loaded: {jax_side}")
    finally:
        ptrain.CKPT_ROOT = run_root
        clear_loader_caches()
        tmp.cleanup()
    check(guarded_listing(root, pel.WEIGHTS_DIR) == before,
          "phase 4o wrote under checkpoints/, the committed weights or checkpoints_torch/")
    say(f"the command lines on the card [{card}]: launches {json.dumps(launches_of.total)}")
    return launches_of.total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    from nu_scaler_tpu_torch.core import (
        PyFsrUpscaler,
        PyWgpuUpscaler,
        WgpuFrameInterpolator,
        create_advanced_upscaler,
        create_fsr_upscaler,
        py_benchmark_upscaler,
        py_run_comparison_benchmark,
    )
    from nu_scaler_tpu_torch.capture.video import _rgba_to_yuv420, _yuv420_to_rgba
    from nu_scaler_tpu_torch.kernels import _build
    from nu_scaler_tpu_torch.kernels import conv_cuda as cc
    from nu_scaler_tpu_torch.kernels import fsr_cuda as fc
    from nu_scaler_tpu_torch.kernels import reference as ref
    from nu_scaler_tpu_torch.kernels import resample_cuda as rc
    from nu_scaler_tpu_torch.kernels import soft_warp_cuda as swc
    from nu_scaler_tpu_torch.kernels import trunk_cuda as tc
    from nu_scaler_tpu_torch.models import esrgan_lite as pel
    from nu_scaler_tpu_torch.models import interp_refine as pir
    from nu_scaler_tpu_torch.ops import color
    from nu_scaler_tpu_torch.ops import interpolate as interp
    from nu_scaler_tpu_torch.ops import resample
    from nu_scaler_tpu_torch.runtime.streaming import LivePipeline, benchmark_live_pipeline
    from nu_scaler_tpu_torch.utils.tracing import device_timer

    # plain versions and goldens in full fp32 / fp64: no TF32 anywhere
    set_tf32(torch, False)
    # every phase serves from an empty trainer's root, so a checkpoints_torch/
    # left on the machine changes nothing a phase serves (phase 4n's (a));
    # what a training phase writes goes into a root of its own
    import tempfile
    from pathlib import Path

    from nu_scaler_tpu_torch.models import train as ptrain

    repo_root = Path(__file__).resolve().parent
    guarded = guarded_listing(repo_root, pel.WEIGHTS_DIR)
    run_root = tempfile.TemporaryDirectory(prefix="nu_scaler_run_")
    ptrain.CKPT_ROOT = Path(run_root.name)

    with Phase("1 card"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=15,
        )
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        card = smi.stdout.strip().splitlines()[0]
        mem_bw, f32_rate = next((v for k, v in PEAKS.items() if k in kind), PEAKS["H100"])
        bf16_rate = next((v for k, v in BF16_PEAKS.items() if k in kind), BF16_PEAKS["H100"])
        say(f"card: {kind} x{count}; nvidia-smi: {card}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}; peaks {mem_bw:.3g} B/s, {f32_rate:.3g} fp32 FLOP/s, "
            f"{bf16_rate:.3g} bf16 FLOP/s")

    with Phase("2 build"):
        # the build's command line (python -m nu_scaler_tpu_torch.kernels._build):
        # one nvcc per kernel source and one g++ per host library (the frame
        # ring and the Y4M demuxer of phase 4j), all started together, each
        # library's path printed
        libraries = (*_build.SIGNATURES, *_build.HOST_SIGNATURES)
        cached = {name for name in libraries if _build.library_path(name).is_file()}
        check(_build.main([]) == 0, "the build's command line failed")
        for name in libraries:
            _build.load_library(name)
            kind_ = "host library" if name in _build.HOST_SIGNATURES else "kernel library"
            say(f"{kind_} {_build.library_path(name).name} ({'cached' if name in cached else 'built'})")

    rng = np.random.default_rng(SEED)
    frames = make_frames(rng)
    dev = torch.device("cuda")
    on_dev = {k: torch.from_numpy(v).to(dev) for k, v in frames.items()}
    plans = {
        algo: resample.make_resampler(IN_H, IN_W, OUT_H, OUT_W, algo, dev).plan
        for algo in ("lanczos3", "bilinear", "nearest")
    }
    lz = plans["lanczos3"]
    errs = {name: 0 for name in REPLACES}

    with Phase("3 kernels vs plain"):
        # the resample: 0 differing bytes against the plain version, at the
        # main path's 1080p→4K, a 4K→1080p downscale (12-tap bands), the
        # non-integer 1366×768→1080p, an output row that 16 bytes do not
        # divide (683×384→1366×768) and a 16× downscale (97-tap bands: 8×8
        # tiles, one footprint buffer)
        other_plans = {
            f"{algo} {iw}x{ih}->{ow}x{oh}": (resample.make_resampler(ih, iw, oh, ow, algo, dev).plan, (ih, iw))
            for algo, (ih, iw), (oh, ow) in (
                ("lanczos3", (2 * IN_H, 2 * IN_W), (IN_H, IN_W)),
                ("lanczos3", GENERAL[0], GENERAL[1]),
                ("bilinear", GENERAL[0], GENERAL[1]),
                ("bilinear", (GENERAL[0][0] // 2, GENERAL[0][1] // 2), GENERAL[0]),
                ("lanczos3", (16 * 128, 16 * 128), (128, 128)),
            )
        }
        for shape_key, (plan, (ih, iw)) in other_plans.items():
            on_dev[shape_key] = torch.from_numpy(rng.integers(0, 256, (ih, iw, 4), np.uint8)).to(dev)
        # the other four algorithms the port accepts, at the main path's 1080p→4K
        more_plans = {algo: resample.make_resampler(IN_H, IN_W, OUT_H, OUT_W, algo, dev).plan
                      for algo in ("bicubic", "lanczos2", "mitchell", "area")}
        fused_cases = [(f"{algo} 1080p->4K", plan, key) for algo, plan in (plans | more_plans).items()
                       for key in ("a", "n1")]
        fused_cases += [(name, plan, name) for name, (plan, _) in other_plans.items()]
        for name, plan, key in fused_cases:
            k = rc.resample_fused(on_dev[key], plan)
            p = rc.resample_plain(on_dev[key], plan)
            torch.cuda.synchronize()
            max_d, exact = diff_stats(k, p)
            n_diff = int((k != p).sum().item())
            say(f"resample_fused {name} [{'noise' if key == name else key}] tile {tuple(plan.tiles)}: "
                f"{n_diff} bytes differ, max {max_d} LSB, exact {exact:.7f}")
            check(n_diff == 0, f"resample_fused {name}: {n_diff} bytes differ")
            errs["resample_fused"] = max(errs["resample_fused"], max_d)
        # bicubic 1080p→4K against its float64 golden, as bench.py:729-737 gates it
        wv_b, wh_b = (torch.from_numpy(ref.filter_weights(n, m, "bicubic")).cuda().double()
                      for n, m in ((IN_H, OUT_H), (IN_W, OUT_W)))
        bicubic_db = psnr(rc.resample_fused(on_dev["a"], more_plans["bicubic"]).cpu().numpy(),
                          golden(torch, frames["a"], wv_b, wh_b).cpu().numpy())
        say(f"resample_fused bicubic 1080p->4K vs the float64 golden: {bicubic_db:.2f} dB (gate {PSNR_GATE_DB})")
        check(bicubic_db >= PSNR_GATE_DB, f"bicubic vs its golden: {bicubic_db:.2f} dB")
        batch = torch.stack([on_dev[k] for k in ("a", "b", "n1", "n2")])
        k = rc.resample_fused_batched(batch, lz)
        p = rc.resample_plain(batch, lz)
        torch.cuda.synchronize()
        max_d, exact = diff_stats(k, p)
        say(f"resample_fused_batched lanczos3 N={BATCH}: max {max_d} LSB, exact {exact:.7f}")
        check(max_d == 0, f"resample_fused_batched: {max_d} LSB")
        for i, key in enumerate(("a", "b", "n1", "n2")):
            check(torch.equal(k[i], rc.resample_fused(on_dev[key], lz)), "batch != single frame")
        errs["resample_fused_batched"] = max_d
        prev = rc.resample_plain(on_dev["n2"], lz)
        for ts in ((0.5,), (1.0 / 3.0, 2.0 / 3.0)):
            for key in ("b", "n1"):
                k = rc.resample_fused_blend(on_dev[key], prev, lz, ts)
                p = rc.resample_blend_plain(on_dev[key], prev, lz, ts)
                own = rc.mix_plain(prev, k[0], ts)
                torch.cuda.synchronize()
                stats = [diff_stats(x, y) for x, y in zip(k, p)]
                say(f"resample_fused_blend ts={[round(t, 4) for t in ts]} [{key}]: "
                    + ", ".join(f"out{i} max {m} LSB exact {e:.7f}" for i, (m, e) in enumerate(stats)))
                check(all(m == 0 for m, _ in stats), f"resample_fused_blend: {stats}")
                check(all(torch.equal(x, y) for x, y in zip(k[1:], own)),
                      "blend mids are not the exact round-mix of the kernel's own upscale")
                errs["resample_fused_blend"] = max(errs["resample_fused_blend"], *(m for m, _ in stats))

        # the soft warp, fed the same tiles as its plain version: the bench
        # pair with its own flow tiles, and a noise pair with random motion
        # kept off integers (a tile mean on an integer may floor either way)
        # (and, at the edge tile, whose half-width puts a cell boundary
        # inside a run of pixels, K = 1 and 8)
        soft_cases = []
        for tile in (*SOFT_TILES, SOFT_EDGE_TILE):
            ty, tx = IN_H // tile[0], IN_W // tile[1]
            motion = rng.uniform(-20.0, 20.0, (ty, tx, 2)).astype(np.float32)
            motion = np.floor(motion) + 0.37
            soft_cases.append((tile, "bench", on_dev["a"], on_dev["b"],
                               interp.flow_tiles_fast(on_dev["a"], on_dev["b"], tile)))
            soft_cases.append((tile, "noise", on_dev["n1"], on_dev["n2"],
                               torch.from_numpy(motion).to(dev)))
        errs["soft_warp_blend"] = 0
        for tile, key, fa, fb, tiles in soft_cases:
            edge = tile == SOFT_EDGE_TILE
            for k_soft in (1, interp.WARP_K) if edge else (interp.SOFT_WARP_K, interp.WARP_K):
                for t in (0.5, 1.0 / 3.0) if edge else (0.5, 1.0 / 3.0, 2.0 / 3.0):
                    kout = swc.soft_warp_blend(fa, fb, tiles, t, tile, interp.WARP_RANGE, k_soft)
                    pout = swc.soft_warp_plain(
                        fa, fb, swc.frame_inputs(tiles, t, k_soft, interp.WARP_RANGE), tile)
                    torch.cuda.synchronize()
                    max_d, exact = diff_stats(kout, pout)
                    n_diff = int((kout != pout).sum().item())
                    say(f"soft_warp_blend tile={tile} [{key}] k={k_soft} t={t:.4f}: "
                        f"{n_diff} of {kout.numel()} bytes differ, max {max_d} LSB, exact {exact:.7f}")
                    check(max_d <= 1, f"soft_warp_blend: {max_d} LSB")
                    errs["soft_warp_blend"] = max(errs["soft_warp_blend"], max_d)

        # the fused FSR kernel, single frames and batches, at the main path's
        # sizes (s = 2 from 1080p, s = 3 from 720p), s = 4 from 540p, s = 1,
        # and an odd size
        sized = {key: bench_frame(h, w) for key, (h, w) in SIZES.items()}
        sized.update({f"{key}-noise": rng.integers(0, 256, (h, w, 4), np.uint8)
                      for key, (h, w) in SIZES.items()})
        sized["odd-noise"] = rng.integers(0, 256, (37, 53, 4), np.uint8)
        # sides that no tile of the kernel divides (nor 8, 16 or 32)
        for i in range(2):
            sized[f"ragged{i}"] = rng.integers(0, 256, (*FSR_RAGGED, 4), np.uint8)
        on_dev.update({k: torch.from_numpy(v).to(dev) for k, v in sized.items()})
        tiers = dict(ref.FSR_SHARPNESS, zero=0.0)
        fsr_cases = [(key, 2, name) for key in ("a", "n1") for name in tiers]
        fsr_cases += [(key, 3, name) for key in ("720p", "720p-noise") for name in ("quality", "zero")]
        fsr_cases += [(key, 4, name) for key in ("540p", "540p-noise") for name in ("quality", "performance")]
        fsr_cases += [("n1", 1, "quality")]
        fsr_cases += [("odd-noise", s_, "ultra") for s_ in (1, 2, 3, 4)]
        fsr_cases += [(("a", "b", "n1", "n2"), 2, "quality"), (("720p", "720p-noise") * 2, 3, "ultra")]
        fsr_cases += [(key, s_, "quality") for s_ in (1, 2, 3, 4) for key in ("ragged0", ("ragged0", "ragged1"))]
        errs["fsr"] = errs["fsr_batched"] = 0
        for key, s_, name in fsr_cases:
            batched = isinstance(key, tuple)
            src = torch.stack([on_dev[k] for k in key]) if batched else on_dev[key]
            kout = (fc.fsr_batched if batched else fc.fsr)(src, s_, tiers[name])
            pout = fc.fsr_plain(src, s_, tiers[name])
            torch.cuda.synchronize()
            check(kout.shape == pout.shape, f"fsr shape {tuple(kout.shape)} != {tuple(pout.shape)}")
            d = (kout.to(torch.int16) - pout.to(torch.int16)).abs()
            n_diff, max_d = int((d > 0).sum().item()), int(d.max().item())
            say(f"fsr{'_batched' if batched else ''} s={s_} {name} "
                f"[{'+'.join(key) if batched else key}] {tuple(src.shape)}: "
                f"{n_diff} of {d.numel()} bytes differ, max {max_d} LSB")
            check(max_d <= 1, f"fsr: {max_d} LSB")
            row = "fsr_batched" if batched else "fsr"
            errs[row] = max(errs[row], max_d)

        # the bf16 conv: seeded weights, and the committed ones as the
        # learned path feeds them (head, a block's conv, tail at x2 and x4)
        served = {u: pel.make_pretrained_upscaler(h_, w_, u * h_, u * w_, "ultra", dev).serving
                  for u, h_, w_, *_ in LEARNED}

        def seeded(n_, h_, w_, cin, cout):
            x = torch.from_numpy(rng.standard_normal((n_, h_, w_, cin), np.float32)).to(dev)
            k = torch.from_numpy(rng.standard_normal((3, 3, cin, cout), np.float32) * 0.05).to(dev)
            b = torch.from_numpy(rng.standard_normal(cout, np.float32) * 0.1).to(dev)
            return tuple(t.to(torch.bfloat16) for t in (x, k, b))

        def act(n_, h_, w_, cin):  # trunk-like activations, |x| up to ~4
            return (torch.from_numpy(rng.standard_normal((n_, h_, w_, cin), np.float32)).to(dev)
                    .to(torch.bfloat16))

        th2, tw2 = IN_H // 4, IN_W // 4
        th4, tw4 = LEARNED[1][1] // 4, LEARNED[1][2] // 4
        conv_cases = []
        for relu in (True, False):
            for rs in (True, False):
                conv_cases.append((f"seeded 1x{th2}x{tw2} 128->128", *seeded(1, th2, tw2, 128, 128), relu, rs))
        conv_cases += [
            ("seeded 4x27x40 128->256 (ragged)", *seeded(4, 27, 40, 128, 256), False, True),
            ("seeded 1x27x40 128->128 (ragged)", *seeded(1, 27, 40, 128, 128), True, False),
            ("seeded 4x27x40 128->1024 (ragged)", *seeded(4, 27, 40, 128, 1024), False, False),
            ("seeded 1x27x40 256->128 (two Cin chunks)", *seeded(1, 27, 40, 256, 128), True, True),
            ("seeded 1x17x33 128->128 (ragged to the tile)", *seeded(1, 17, 33, 128, 128), False, True),
            (f"tpu4b2 head 1x{th2}x{tw2}", act(1, th2, tw2, 128), *served[2].head, False, True),
            (f"tpu4b2 block0.conv1 4x{th2}x{tw2}", act(BATCH, th2, tw2, 128), *served[2].blocks[0][0], True, True),
            (f"tpu4b2 tail 1x{th2}x{tw2} 128->256", act(1, th2, tw2, 128), *served[2].tail, False, True),
            (f"tpu4 block2.conv2 1x{th4}x{tw4}", act(1, th4, tw4, 128), *served[4].blocks[2][1], False, True),
            (f"tpu4 tail 4x{th4}x{tw4} 128->1024", act(BATCH, th4, tw4, 128), *served[4].tail, False, True),
        ]
        errs["conv3x3"] = 0.0
        for name, x, k, b, relu, rs in conv_cases:
            kout = cc.conv3x3(x, k, b, relu, rs)
            pout = cc.conv3x3_plain(x, k, b, relu, rs)
            torch.cuda.synchronize()
            check(kout.shape == pout.shape and kout.dtype == torch.bfloat16, f"conv3x3 {name}: shape")
            d = (kout.float() - pout.float()).abs()
            tol = cc.ulp_tolerance(x, k, pout, rs)
            over, max_d = int((d > tol).sum().item()), float(d.max().item())
            say(f"conv3x3 [{name}] relu={relu} round_sum={rs}: {int((d > 0).sum().item())} of "
                f"{d.numel()} values differ, max {max_d:.6g}, max |d|/tol "
                f"{float((d / tol.clamp_min(1e-30)).max().item()):.3f}, over the bound {over}")
            check(over == 0 and bool(torch.isfinite(kout.float()).all()), f"conv3x3 {name}: {over} over")
            errs["conv3x3"] = max(errs["conv3x3"], max_d)

        # the conv's int8-grid mode, bit-equal to its plain version: seeded
        # int8 grids (weights whose partial sums stay below 2^24, as the
        # committed ones do), and the committed int8 weights of the served
        # graphs fed quantised activations
        served_q = {(prefer, u): pel.make_pretrained_upscaler(h_, w_, u * h_, u * w_, prefer, dev).serving
                    for prefer, u, h_, w_, *_ in INT8_LEARNED}

        def seeded_q(n_, h_, w_, cin, cout, bias):
            xq = torch.from_numpy(rng.integers(-127, 128, (n_, h_, w_, cin)).astype(np.float32))
            kq = np.clip(np.round(rng.standard_normal((3, 3, cin, cout)) * 20), -127, 127)
            scale = torch.from_numpy((rng.random(cout) * 1e-3 + 1e-5).astype(np.float32))
            b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)) if bias else None
            return (xq.to(dev).to(torch.bfloat16), torch.from_numpy(kq.astype(np.float32)).to(dev)
                    .to(torch.bfloat16), scale.to(dev), None if b is None else b.to(dev))

        def served_case(prefer, u, conv, n_=1, relu=False):
            s_ = served_q[(prefer, u)]
            c = {"head": s_.q_head, "trunk": s_.q_trunk, "tail": s_.q_tail, "base": s_.q_base,
                 "block0.conv1": s_.q_blocks[0][0], "block0.conv2": s_.q_blocks[0][1]}[conv]
            hh, ww = s_.in_hw[0] // 4 + 2 * (conv == "base"), s_.in_hw[1] // 4 + 2 * (conv == "base")
            if conv in ("head", "base"):  # the raw u8 s2d on the 128-lane input
                x = torch.from_numpy(rng.integers(0, 256, (n_, hh, ww, 128)).astype(np.float32)).to(dev)
                x[..., 64:] = 0
            else:
                x = torch.from_numpy(rng.standard_normal((n_, hh, ww, 128)).astype(np.float32)).to(dev)
            label = f"{prefer} x{u} committed {conv} {n_}x{hh}x{ww} 128->{c.kq.shape[-1]}"
            return (label, cc.quantize_act(x, c.ax), c.kq, c.scale, c.b, relu)

        q_cases = []
        for relu in (True, False):
            for bias in (True, False):
                q_cases.append((f"seeded 1x{th2}x{tw2} 128->128", *seeded_q(1, th2, tw2, 128, 128, bias), relu))
        q_cases += [
            (f"seeded 1x{th2}x{tw2} 128->256", *seeded_q(1, th2, tw2, 128, 256, True), False),
            (f"seeded 1x{th4}x{tw4} 128->1024", *seeded_q(1, th4, tw4, 128, 1024, True), False),
            (f"seeded 1x{th4}x{tw4} 128->128", *seeded_q(1, th4, tw4, 128, 128, False), True),
            ("seeded 4x17x33 128->256 (ragged to the tile)", *seeded_q(BATCH, 17, 33, 128, 256, True), True),
            ("seeded 1x17x33 128->128 (ragged to the tile)", *seeded_q(1, 17, 33, 128, 128, False), False),
            served_case("quality", 2, "head"),
            served_case("quality", 2, "block0.conv1", BATCH, relu=True),
            served_case("quality", 2, "block0.conv2"),
            served_case("quality", 2, "trunk"),
            served_case("quality", 2, "tail"),
            served_case("quality", 2, "base"),
            served_case("quality", 4, "block0.conv1", relu=True),
            served_case("quality", 4, "tail"),
            served_case("performance", 2, "tail"),
        ]
        errs["conv3x3_q"] = 0.0
        for name, xq, kq, scale, b, relu in q_cases:
            check(cc.int8_sum_bound(kq) < 2.0 ** 24, f"conv3x3_q {name}: sums may leave fp32's integers")
            kout = cc.conv3x3_q(xq, kq, scale, b, relu)
            pout = cc.conv3x3_q_plain(xq, kq, scale, b, relu)
            torch.cuda.synchronize()
            check(kout.shape == pout.shape and kout.dtype == torch.bfloat16, f"conv3x3_q {name}: shape")
            d = (kout.float() - pout.float()).abs()
            n_diff, max_d = int((d > 0).sum().item()), float(d.max().item())
            say(f"conv3x3_q [{name}] relu={relu} bias={b is not None}: {n_diff} of {d.numel()} values "
                f"differ, max |d| {max_d:.6g}; sum bound {cc.int8_sum_bound(kq) / 2.0 ** 24:.4f} of 2^24")
            check(n_diff == 0 and bool(torch.isfinite(kout.float()).all()), f"conv3x3_q {name}: {n_diff} differ")
            errs["conv3x3_q"] = max(errs["conv3x3_q"], max_d)

        # the fused trunk: seeded weights on trunk-like activations, and the
        # committed ones on the served graph's input (the s2d of frames), at
        # the learned path's grids, a batch of 4 and a ragged 27x40
        def seeded_params(blocks, cout):
            out = []
            for layer in range(tc.depth(blocks)):
                co = cout if layer == tc.depth(blocks) - 1 else 128
                k = rng.standard_normal((3, 3, 128, co), np.float32) * 0.05
                b = rng.standard_normal(co, np.float32) * 0.1
                out += [torch.from_numpy(a).to(dev).to(torch.bfloat16) for a in (k, b)]
            return tuple(out)

        def s2d_in(u, keys):  # the trunk's input in the served graph of x{u}
            return served[u].trunk_input(torch.stack([on_dev[k] for k in keys]))[1]

        ragged4 = pel.make_serving_fn_fused(pel.load_model("tpu4", 4)[0], 108, 160, dev).trunk_input(
            torch.from_numpy(rng.integers(0, 256, (1, 108, 160, 4), np.uint8)).to(dev))[1]
        trunk_cases = [
            (f"seeded 1x{th2}x{tw2} 2 blocks ->256", act(1, th2, tw2, 128), seeded_params(2, 256), 2,
             (True, False)),
            (f"seeded 1x{th4}x{tw4} 3 blocks ->1024", act(1, th4, tw4, 128), seeded_params(3, 1024), 3,
             (False,)),
            ("seeded 4x27x40 2 blocks ->256 (ragged)", act(BATCH, 27, 40, 128), seeded_params(2, 256), 2,
             (True, False)),
            (f"tpu4b2, s2d of a, 1x{th2}x{tw2}", s2d_in(2, ("a",)), served[2].trunk_params, 2, (True, False)),
            (f"tpu4b2, s2d of n1, 1x{th2}x{tw2}", s2d_in(2, ("n1",)), served[2].trunk_params, 2, (True,)),
            (f"tpu4b2, s2d of a b n1 n2, 4x{th2}x{tw2}", s2d_in(2, ("a", "b", "n1", "n2")),
             served[2].trunk_params, 2, (True,)),
            (f"tpu4, s2d of 540p, 1x{th4}x{tw4}", s2d_in(4, ("540p",)), served[4].trunk_params, 3,
             (True, False)),
            (f"tpu4, s2d of 540p-noise, 1x{th4}x{tw4}", s2d_in(4, ("540p-noise",)), served[4].trunk_params,
             3, (True,)),
            ("tpu4, s2d of noise, 1x27x40 (ragged)", ragged4, served[4].trunk_params, 3, (True,)),
        ]
        errs["trunk_fused"] = 0.0
        for name, x, params, blocks, roundings in trunk_cases:
            for rs in roundings:
                kout = tc.trunk_fused(x, params, blocks, rs)
                pout = tc.trunk_fused_plain(x, params, blocks, rs)
                chain = tc.trunk_chain(cc.conv3x3, x, params, blocks, rs)
                torch.cuda.synchronize()
                check(kout.shape == pout.shape and kout.dtype == torch.bfloat16, f"trunk_fused {name}: shape")
                d = (kout.float() - pout.float()).abs()
                tol = tc.ulp_tolerance(pout)
                over, max_d = int((d > tol).sum().item()), float(d.max().item())
                n_chain = int((kout != chain).sum().item())
                say(f"trunk_fused [{name}] round_sum={rs}: {n_chain} of {kout.numel()} values differ from "
                    f"the chain of {tc.depth(blocks)} conv3x3 launches; vs plain max |d| {max_d:.6g}, max "
                    f"|d|/tol {float((d / tol).max().item()):.3f} (tol {float(tol):.6g} = {tc.TOL_ULPS} ulps "
                    f"of max |plain| {float(pout.float().abs().max().item()):.6g}), bit-equal "
                    f"{float((d == 0).double().mean().item()):.7f}, over the bound {over}")
                check(n_chain == 0, f"trunk_fused {name}: {n_chain} values differ from the conv3x3 chain")
                check(over == 0 and bool(torch.isfinite(kout.float()).all()), f"trunk_fused {name}: {over} over")
                errs["trunk_fused"] = max(errs["trunk_fused"], max_d)

        # the two-call resample against resample_fused and the plain version
        errs["resample_twopass"] = 0
        two_cases = [(algo, plans[algo], key, on_dev[key]) for algo in plans for key in ("a", "n1")]
        two_cases.append(("lanczos3", lz, "a+b+n1+n2", batch))
        two_cases += [(name, plan, "noise", on_dev[name]) for name, (plan, _) in other_plans.items()]
        for algo, plan, key, src in two_cases:
            k = rc.resample_twopass(src, plan)
            f = (rc.resample_fused_batched if src.dim() == 4 else rc.resample_fused)(src, plan)
            p = rc.resample_plain(src, plan)
            torch.cuda.synchronize()
            max_d, exact = diff_stats(k, p)
            n_diff = int((k != p).sum().item())
            same = bool(torch.equal(k, f))
            say(f"resample_twopass {algo} [{key}] {tuple(src.shape)}: equal to resample_fused {same}; "
                f"vs plain max {max_d} LSB, {n_diff} bytes differ, exact {exact:.7f}")
            check(same, f"resample_twopass {algo}: not equal to resample_fused ({max_d} LSB vs plain)")
            errs["resample_twopass"] = max(errs["resample_twopass"], max_d)

    with Phase("4 main path"):
        t0 = time.perf_counter()
        wv = torch.from_numpy(ref.filter_weights(IN_H, OUT_H, "lanczos3")).cuda().double()
        wh = torch.from_numpy(ref.filter_weights(IN_W, OUT_W, "lanczos3")).cuda().double()
        g = {key: golden(torch, frames[key], wv, wh) for key in ("a", "b")}
        torch.cuda.synchronize()
        g = {key: v.cpu().numpy() for key, v in g.items()}
        say(f"float64 lanczos3 goldens of a and b on the card: {time.perf_counter() - t0:.2f} s")

        live_in = [np.roll(frames["a"], 16 * i, axis=1) for i in range(LIVE_FRAMES)]
        rc.reset_launches()
        up = PyWgpuUpscaler("ultra", "lanczos3")
        up.initialize(IN_W, IN_H, OUT_W, OUT_H)
        out_a = np.frombuffer(up.upscale(frames["a"].tobytes()), np.uint8).reshape(OUT_H, OUT_W, 4)
        outs_b = up.upscale_batch([frames[k].tobytes() for k in ("a", "b", "n1", "n2")])
        mid_bytes = WgpuFrameInterpolator().interpolate_py(
            frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H, time_t=0.5)
        step = resample.make_fused_blend(IN_H, IN_W, OUT_H, OUT_W, "lanczos3", 0.5)

        def make_fused_pipe():
            return LivePipeline(None, depth=2, fused_step_fn=step)

        pipe = make_fused_pipe()
        live_out = []
        for f in live_in:
            live_out += pipe.put(f)
        live_out += pipe.drain()
        torch.cuda.synchronize()
        counts = {k: rc.launches[k] for k in ("resample_fused", "resample_fused_batched",
                                              "resample_fused_blend")}
        say(f"launches on the main path: {json.dumps(counts)}")
        check(all(n > 0 for n in counts.values()), f"a kernel of the path never ran: {counts}")

        p_up = psnr(out_a, g["a"])
        say(f"upscale lanczos3 vs golden: {p_up:.2f} dB, max "
            f"{int(np.abs(out_a.astype(int) - g['a']).max())} LSB, exact "
            f"{float((out_a == g['a']).mean()):.7f}")
        check(p_up >= PSNR_GATE_DB, f"upscale {p_up:.2f} dB < {PSNR_GATE_DB}")
        check(len(outs_b) == BATCH and all(len(o) == OUT_W * OUT_H * 4 for o in outs_b),
              "upscale_batch byte lengths")
        check(outs_b[0] == out_a.tobytes(), "upscale_batch[0] != upscale(a)")
        p_b = psnr(np.frombuffer(outs_b[1], np.uint8).reshape(OUT_H, OUT_W, 4), g["b"])
        say(f"upscale_batch[1] (b) vs golden: {p_b:.2f} dB")
        check(p_b >= PSNR_GATE_DB, f"upscale_batch {p_b:.2f} dB < {PSNR_GATE_DB}")

        mid = np.frombuffer(mid_bytes, np.uint8).reshape(IN_H, IN_W, 4)
        want = interp.blend_only(torch.from_numpy(frames["a"]), torch.from_numpy(frames["b"]), 0.5)
        check(np.array_equal(mid, want.numpy()), "interpolate_py on the card != blend_only on the CPU")
        say("interpolate_py blend at 1080p: equal to blend_only on the CPU")

        check(len(live_out) == 2 * LIVE_FRAMES - 1, f"live frames: {len(live_out)}")
        check(all(o.shape == (OUT_H, OUT_W, 4) and o.dtype == np.uint8 for o in live_out),
              "live frame shape or type")
        for i in range(0, len(live_out) - 2, 2):  # every mid is the round-mix of its neighbours
            a_, b_ = live_out[i].astype(np.float32), live_out[i + 2].astype(np.float32)
            m_ = np.clip(np.round(a_ + (b_ - a_) * np.float32(0.5)), 0, 255).astype(np.uint8)
            check(np.array_equal(live_out[i + 1], m_), f"live mid {i + 1} != mix of its neighbours")
        gm = np.clip(np.round((g["a"].astype(np.float64) + g["b"].astype(np.float64)) * 0.5),
                     0, 255).astype(np.uint8)
        p_live0, p_mid = psnr(live_out[0], g["a"]), psnr(live_out[1], gm)
        say(f"live pipeline: {len(live_out)} frames; first vs golden {p_live0:.2f} dB; "
            f"mid vs round((golden_a + golden_b)/2) {p_mid:.2f} dB")
        check(p_live0 >= PSNR_GATE_DB and p_mid >= PSNR_GATE_DB, "live pipeline below the gate")

        # end to end on the host clock: one upscale(bytes) call, and the live
        # pipeline's output frames per second (host frames in, device frames out)
        lat = []
        for _ in range(6):
            t0 = time.perf_counter()
            up.upscale(frames["a"].tobytes())
            lat.append((time.perf_counter() - t0) * 1e3)
        say("e2e: " + json.dumps({
            "upscale_bytes_ms_median": float(np.median(lat[1:])),
            "live_fused_output_fps_device": live_fps(torch, make_fused_pipe, live_in, False),
            "live_fused_output_fps_host": live_fps(torch, make_fused_pipe, live_in, True),
        }))

    with Phase("4b flow_soft path"):
        # the counts are read for this path on its own
        up_fn = resample.make_resampler(IN_H, IN_W, OUT_H, OUT_W, "lanczos3")
        interp_fn = interp.make_interpolator(IN_H, IN_W, "flow_soft")
        fs = WgpuFrameInterpolator(mode="flow_soft")
        rc.reset_launches()
        swc.reset_launches()
        mid_fs = fs.interpolate_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H,
                                   time_t=0.5)
        mids_3x = fs.interpolate_multi_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H)
        fpipe = LivePipeline(up_fn, interp_fn, depth=2)
        flow_out = []
        per_step = []
        for f in live_in:
            before = (swc.launches["soft_warp_blend"], rc.launches["resample_fused"])
            flow_out += fpipe.put(f)
            per_step.append((swc.launches["soft_warp_blend"] - before[0],
                             rc.launches["resample_fused"] - before[1]))
        flow_out += fpipe.drain()
        torch.cuda.synchronize()
        flow_counts = {**rc.launches, **swc.launches}
        say(f"launches on the flow_soft path: {json.dumps(flow_counts)}; per live step "
            f"(soft_warp_blend, resample_fused): {per_step}")
        check(per_step[0] == (0, 1) and all(c == (1, 2) for c in per_step[1:]),
              f"flow_soft live step launches: {per_step}")
        check(flow_counts["soft_warp_blend"] == 1 + 2 + (LIVE_FRAMES - 1),
              f"soft_warp_blend launches: {flow_counts}")

        # the mids against the plain version's on the same tiles (the port's
        # psnr_flow_soft_db and psnr_soft3x_mids_db)
        tiles = interp.flow_tiles_fast(on_dev["a"], on_dev["b"])
        mid_fs, *mids_3x = (np.frombuffer(m, np.uint8).reshape(IN_H, IN_W, 4)
                            for m in (mid_fs, *mids_3x))
        gates = {}
        for name, got, t in (("psnr_flow_soft_db", mid_fs, 0.5),
                             ("psnr_soft3x_mid1_db", mids_3x[0], 1.0 / 3.0),
                             ("psnr_soft3x_mid2_db", mids_3x[1], 2.0 / 3.0)):
            plain = swc.soft_warp_plain(
                on_dev["a"], on_dev["b"],
                swc.frame_inputs(tiles, t, interp.SOFT_WARP_K, interp.WARP_RANGE),
                interp.WARP_TILE).cpu().numpy()
            gates[name] = psnr(got, plain)
        # value: on a smooth texture moved by 8 px the true mid is the texture
        # moved by 4 px; motion compensation must beat the cross-fade
        w0, w8, w4 = (wave_pattern(IN_W, IN_H, s_) for s_ in (0.0, 8.0, 4.0))
        wave_mid = np.frombuffer(fs.interpolate_py(w0.tobytes(), w8.tobytes(), IN_W, IN_H),
                                 np.uint8).reshape(IN_H, IN_W, 4)
        blend_mid = interp.blend_only(torch.from_numpy(w0), torch.from_numpy(w8), 0.5).numpy()
        gates["wave_mid_vs_truth_db"] = psnr(wave_mid, w4)
        gates["wave_blend_vs_truth_db"] = psnr(blend_mid, w4)
        # the flow stage on the card against the same functions on the CPU,
        # and with TF32 allowed (the flow stage uses no matmul or convolution)
        cpu_tiles = interp.flow_tiles_fast(torch.from_numpy(frames["a"]), torch.from_numpy(frames["b"]))
        gates["flow_tiles_card_vs_cpu_px"] = float((tiles.cpu() - cpu_tiles).abs().max())
        tf32 = set_tf32(torch, True)
        try:
            tf32_tiles = interp.flow_tiles_fast(on_dev["a"], on_dev["b"])
        finally:
            restore_tf32(torch, tf32)
        gates["flow_tiles_tf32_equal"] = bool(torch.equal(tf32_tiles, tiles))
        gates["mean_tile_motion_px"] = [float(v) for v in tiles.mean(dim=(0, 1)).cpu()]
        say("flow_soft gates: " + json.dumps(gates))
        for name in ("psnr_flow_soft_db", "psnr_soft3x_mid1_db", "psnr_soft3x_mid2_db"):
            check(gates[name] >= PSNR_GATE_DB, f"{name} {gates[name]:.2f} dB < {PSNR_GATE_DB}")
        check(gates["wave_mid_vs_truth_db"] > gates["wave_blend_vs_truth_db"],
              "flow_soft does not beat the cross-fade on the moving texture")
        check(gates["flow_tiles_card_vs_cpu_px"] <= FLOW_TILE_GATE_PX, "flow tiles: card != CPU")
        check(gates["flow_tiles_tf32_equal"], "the flow stage changed with TF32 allowed")
        check(len(flow_out) == 2 * LIVE_FRAMES - 1, f"flow_soft live frames: {len(flow_out)}")
        check(all(o.shape == (OUT_H, OUT_W, 4) and o.dtype == np.uint8 for o in flow_out),
              "flow_soft live frame shape or type")
        up_mid = up_fn(torch.from_numpy(mid_fs.copy())).cpu().numpy()
        check(np.array_equal(flow_out[1], up_mid), "live flow_soft mid != upscale(interpolate_py)")

        # end to end: interpolate_py latency (host clock), live output fps
        # (outputs on the card), and the per-step split from CUDA events
        lat = []
        for _ in range(6):
            t0 = time.perf_counter()
            fs.interpolate_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H)
            lat.append((time.perf_counter() - t0) * 1e3)
        split = {"flow_ms": [], "warp_ms": [], "upscales_ms": [], "step_ms": []}
        prev_f, cur_f = on_dev["a"], on_dev["b"]
        for _ in range(SPLIT_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            tl = interp.flow_tiles_fast(prev_f, cur_f)
            ev[1].record()
            mid = swc.soft_warp_blend(prev_f, cur_f, tl, 0.5, interp.WARP_TILE, interp.WARP_RANGE,
                                      interp.SOFT_WARP_K)
            ev[2].record()
            up_fn(mid)
            up_fn(cur_f)
            ev[3].record()
            ev[3].synchronize()
            split["flow_ms"].append(ev[0].elapsed_time(ev[1]))
            split["warp_ms"].append(ev[1].elapsed_time(ev[2]))
            split["upscales_ms"].append(ev[2].elapsed_time(ev[3]))
            split["step_ms"].append(ev[0].elapsed_time(ev[3]))
        say("e2e flow_soft: " + json.dumps({
            "interpolate_py_flow_soft_ms_median": float(np.median(lat[1:])),
            "live_flow_soft_output_fps_device": live_fps(
                torch, lambda: LivePipeline(up_fn, interp_fn, depth=2), live_in, False),
            **{f"{k}_median": float(np.median(v)) for k, v in split.items()},
        }))

    with Phase("4c fsr path"):
        # the app's fsr tier at 1080p→4K; the counts are read for this path
        t0 = time.perf_counter()
        sharp = ref.FSR_SHARPNESS["quality"]
        fsr_golden = ref.rcas_ref(ref.easu_ref(frames["a"], OUT_H, OUT_W, sharp), sharp)
        say(f"easu_ref → rcas_ref golden of a at 1080p→4K on the host: "
            f"{time.perf_counter() - t0:.2f} s")
        fsr_up = create_fsr_upscaler("quality")
        fsr_up.initialize(IN_W, IN_H, OUT_W, OUT_H)
        up720 = create_fsr_upscaler("quality")
        up720.initialize(SIZES["720p"][1], SIZES["720p"][0], OUT_W, OUT_H)
        fsr_interp = interp.make_interpolator(IN_H, IN_W, "flow_soft")

        def make_fsr_pipe():
            return LivePipeline(fsr_up.upscale_arr, fsr_interp, depth=2)

        rc.reset_launches()
        swc.reset_launches()
        fc.reset_launches()
        fsr_a = np.frombuffer(fsr_up.upscale(frames["a"].tobytes()), np.uint8).reshape(OUT_H, OUT_W, 4)
        batch_keys = ("a", "b", "n1", "n2")
        fsr_batch = fsr_up.upscale_batch([frames[k].tobytes() for k in batch_keys])
        fsr_720 = up720.upscale(sized["720p"].tobytes())
        fpipe = make_fsr_pipe()
        fsr_live = []
        for f in live_in:
            fsr_live += fpipe.put(f)
        fsr_live += fpipe.drain()
        torch.cuda.synchronize()
        fsr_counts = {**fc.launches, **swc.launches}
        say(f"launches on the FSR path: {json.dumps(fsr_counts)} (resample: {json.dumps(rc.launches)})")
        check(all(n > 0 for n in fsr_counts.values()), f"a kernel of the FSR path never ran: {fsr_counts}")

        gates = {"psnr_fsr_db": psnr(fsr_a, fsr_golden),
                 "fsr_max_lsb": int(np.abs(fsr_a.astype(int) - fsr_golden).max()),
                 "fsr_exact": float((fsr_a == fsr_golden).mean())}
        singles = [fsr_up.upscale(frames[k].tobytes()) for k in batch_keys]
        gates["batch_equals_singles"] = fsr_batch == singles
        plain720 = fc.fsr_plain(on_dev["720p"], 3, sharp).cpu().numpy()
        gates["fsr_720p_vs_plain_max_lsb"] = int(np.abs(
            np.frombuffer(fsr_720, np.uint8).reshape(OUT_H, OUT_W, 4).astype(int) - plain720).max())
        (gh, gw), (goh, gow) = GENERAL
        g_in = bench_frame(gh, gw).tobytes()
        g_card = create_fsr_upscaler("quality")
        g_cpu = PyFsrUpscaler("quality", device="cpu")
        for u in (g_card, g_cpu):
            u.initialize(gw, gh, gow, goh)
        g_out = [np.frombuffer(u.upscale(g_in), np.uint8).astype(int) for u in (g_card, g_cpu)]
        gates["general_card_vs_cpu_max_lsb"] = int(np.abs(g_out[0] - g_out[1]).max())
        # the live FSR step: every mid is the FSR upscale of the flow_soft mid
        mid0 = fsr_interp(on_dev["a"], torch.from_numpy(live_in[1]).to(dev), 0.5)
        gates["live_frames"] = len(fsr_live)
        gates["live_mid_is_upscaled_mid"] = bool(np.array_equal(
            fsr_live[1], fsr_up.upscale_arr(mid0).cpu().numpy()))
        say("fsr gates: " + json.dumps(gates))
        check(gates["psnr_fsr_db"] >= FSR_GATE_DB and gates["fsr_max_lsb"] <= FSR_GATE_LSB,
              f"FSR vs golden: {gates['psnr_fsr_db']:.2f} dB, {gates['fsr_max_lsb']} LSB")
        check(gates["batch_equals_singles"], "FSR upscale_batch != upscale of each frame")
        check(gates["fsr_720p_vs_plain_max_lsb"] <= 1, "FSR 720p→4K != its plain version")
        check(gates["general_card_vs_cpu_max_lsb"] <= 1, "FSR general path: card != CPU")
        check(gates["live_frames"] == 2 * LIVE_FRAMES - 1, f"FSR live frames: {len(fsr_live)}")
        check(all(o.shape == (OUT_H, OUT_W, 4) and o.dtype == np.uint8 for o in fsr_live),
              "FSR live frame shape or type")
        check(gates["live_mid_is_upscaled_mid"], "FSR live mid != upscale(flow_soft mid)")

        # flow_soft on frames the warp tile does not divide: the card against
        # the CPU, on a texture moved 8 px
        ragged = {}
        for h_, w_, preset in RAGGED:
            w0, w8 = (wave_pattern(w_, h_, s_).tobytes() for s_ in (0.0, 8.0))
            card_i = WgpuFrameInterpolator(preset, mode="flow_soft")
            cpu_i = WgpuFrameInterpolator(preset, mode="flow_soft", device="cpu")
            check(not interp.soft_tiles_fit(h_, w_, card_i.warp_tile), "not a ragged case")
            outs = [np.frombuffer(i_.interpolate_py(w0, w8, w_, h_), np.uint8).reshape(h_, w_, 4)
                    for i_ in (card_i, cpu_i)]
            key = f"{w_}x{h_} tile {card_i.warp_tile}"
            ragged[key] = {"psnr_rgb_db": psnr(outs[0], outs[1]),
                           "max_lsb": int(np.abs(outs[0].astype(int) - outs[1]).max())}
            if preset is None and h_ == RAGGED[0][0]:
                multi = [[np.frombuffer(m, np.uint8).reshape(h_, w_, 4)
                          for m in i_.interpolate_multi_py(w0, w8, w_, h_)] for i_ in (card_i, cpu_i)]
                ragged[key]["multi_psnr_rgb_db"] = min(psnr(x, y) for x, y in zip(*multi))
        say("flow_soft ragged, card vs CPU: " + json.dumps(ragged))
        for key, r_ in ragged.items():
            check(min(v for k, v in r_.items() if "psnr" in k) >= PSNR_GATE_DB,
                  f"flow_soft ragged {key}: {r_}")

        # end to end: upscale(bytes) latency, device frames per second of
        # upscale_arr, and the live FSR + flow_soft output fps
        lat = []
        for _ in range(6):
            t0 = time.perf_counter()
            fsr_up.upscale(frames["a"].tobytes())
            lat.append((time.perf_counter() - t0) * 1e3)
        fsr_up.upscale_arr(on_dev["a"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fsr_up.upscale_arr(on_dev["a"])
        torch.cuda.synchronize()
        say("e2e fsr: " + json.dumps({
            "fsr_upscale_bytes_ms_median": float(np.median(lat[1:])),
            "fsr_upscale_arr_fps_device": 20 / (time.perf_counter() - t0),
            "live_fsr_flow_soft_output_fps_device": live_fps(torch, make_fsr_pipe, live_in, False),
        }))

    with Phase("4d learned path"):
        # the app's "ultra" learned tier, x2 from 1080p and x4 from 540p; the
        # counts are read for this path on its own
        torch.cuda.empty_cache()
        learned_in = {2: frames["a"], 4: sized["540p"]}
        ups = {}
        for u, h_, w_, arch, ckpt_step, _ in LEARNED:
            ups[u] = create_advanced_upscaler("ultra")
            ups[u].learned_prefer = "ultra"
            ups[u].initialize(w_, h_, u * w_, u * h_)
            check(ups[u]._serving_tier == "learned" and ups[u]._fn.arch == arch
                  and ups[u]._fn.step == ckpt_step, f"x{u}: {ups[u]._serving_tier} {ups[u]._fn.arch}")
        batch4 = [np.roll(learned_in[2], 16 * i, axis=1).tobytes() for i in range(BATCH)]
        cc.reset_launches()
        l_out = {u: ups[u].upscale(learned_in[u].tobytes()) for u in ups}
        l_batch = ups[2].upscale_batch(batch4)
        torch.cuda.synchronize()
        learned_counts = dict(cc.launches)
        per_frame = {u: ups[u]._fn.serving.convs_per_frame for u in ups}
        say(f"launches on the learned path: {json.dumps(learned_counts)} "
            f"(conv launches per frame or batch: {json.dumps(per_frame)})")
        check(learned_counts["conv3x3"] == 2 * per_frame[2] + per_frame[4] and per_frame == {2: 7, 4: 9},
              f"conv3x3 launches on the learned path: {learned_counts}")
        check(all(ups[u]._serving_tier == "learned" and ups[u].get_quality_str() == "ultra" for u in ups),
              "the adaptive ladder left the learned tier")

        gates, twins = {}, {}
        for u, h_, w_, arch, _, twin_gate in LEARNED:
            got = np.frombuffer(l_out[u], np.uint8).reshape(u * h_, u * w_, 4)
            model, _ = pel.load_model(arch, u)
            plain_fn = pel.make_serving_fn_fused(model, h_, w_, dev, conv=cc.conv3x3_plain)
            plain = plain_fn(torch.from_numpy(learned_in[u][None]).to(dev))[0].cpu().numpy()
            x01 = torch.from_numpy(learned_in[u][None, ..., :3].astype(np.float32) / 255.0).to(dev)
            twin = model.to(dev)(x01)[0]
            twin_u8 = torch.clamp(torch.round(twin * 255.0), 0, 255).to(torch.uint8).cpu().numpy()
            twins[u] = twin_u8
            gates[f"x{u}_vs_plain_path_db"] = psnr(got, plain)
            gates[f"x{u}_vs_plain_path_max_lsb"] = int(np.abs(got.astype(int) - plain).max())
            gates[f"x{u}_alpha_equal"] = bool(np.array_equal(got[..., 3], plain[..., 3]))
            gates[f"x{u}_vs_twin_db"] = psnr(got, twin_u8)
            check(gates[f"x{u}_vs_plain_path_db"] >= LEARNED_GATE_DB and gates[f"x{u}_alpha_equal"],
                  f"learned x{u} kernel path vs plain path: {gates[f'x{u}_vs_plain_path_db']:.2f} dB")
            check(gates[f"x{u}_vs_twin_db"] >= twin_gate,
                  f"learned x{u} vs twin: {gates[f'x{u}_vs_twin_db']:.2f} dB < {twin_gate}")
            check(got.shape == (OUT_H, OUT_W, 4) and np.all(got[..., 3] == 255), f"learned x{u} shape/alpha")
        singles = [ups[2].upscale(f) for f in batch4]
        gates["x2_batch_equals_singles"] = l_batch == singles
        say("learned gates: " + json.dumps(gates))
        check(gates["x2_batch_equals_singles"], "learned upscale_batch != upscale of each frame")

        # the same tier with the whole trunk in one kernel (trunk_impl="fused");
        # the counts are read for it on its own: one trunk_fused launch and no
        # conv3x3 launch per call
        fused_ups = {u: pel.make_pretrained_upscaler(h_, w_, u * h_, u * w_, "ultra", dev, "fused")
                     for u, h_, w_, *_ in LEARNED}
        fused_batch = pel.make_pretrained_batch_upscaler(IN_H, IN_W, OUT_H, OUT_W, "ultra", dev, "fused")
        check(all(f.serving.trunk_impl == "fused" and f.arch == ups[u]._fn.arch for u, f in fused_ups.items()),
              "the fused trunk's upscalers")
        batch4_arr = np.stack([np.frombuffer(f, np.uint8).reshape(IN_H, IN_W, 4) for f in batch4])
        cc.reset_launches()
        tc.reset_launches()
        f_out, per_call = {}, []
        for u in fused_ups:
            f_out[u] = fused_ups[u](learned_in[u]).cpu().numpy()
            per_call.append((tc.launches["trunk_fused"], cc.launches["conv3x3"]))
        f_batch = fused_batch(batch4_arr).cpu().numpy()
        per_call.append((tc.launches["trunk_fused"], cc.launches["conv3x3"]))
        torch.cuda.synchronize()
        fused_counts = {**tc.launches, **cc.launches}
        say(f"launches on the fused-trunk learned path: {json.dumps(fused_counts)} (running "
            f"(trunk_fused, conv3x3) after x2, x4, the x2 batch of 4: {per_call})")
        check(per_call == [(1, 0), (2, 0), (3, 0)], f"fused trunk launches: {per_call}")

        fgates = {}
        for u, h_, w_, arch, _, twin_gate in LEARNED:
            got = f_out[u]
            layered = np.frombuffer(l_out[u], np.uint8).reshape(u * h_, u * w_, 4)
            fgates[f"x{u}_fused_vs_layers_db"] = psnr(got, layered)
            fgates[f"x{u}_fused_vs_layers_equal"] = float((got == layered).mean())
            fgates[f"x{u}_fused_alpha_equal"] = bool(np.array_equal(got[..., 3], layered[..., 3]))
            fgates[f"x{u}_fused_vs_twin_db"] = psnr(got, twins[u])
            check(got.shape == (OUT_H, OUT_W, 4) and np.all(got[..., 3] == 255), f"fused x{u} shape/alpha")
            check(fgates[f"x{u}_fused_vs_layers_db"] >= FUSED_TRUNK_GATE_DB and fgates[f"x{u}_fused_alpha_equal"],
                  f"fused x{u} vs layers: {fgates[f'x{u}_fused_vs_layers_db']:.2f} dB")
            check(np.array_equal(got, layered),
                  f"fused x{u} vs layers: {fgates[f'x{u}_fused_vs_layers_equal']:.7f} of the bytes equal")
            check(fgates[f"x{u}_fused_vs_twin_db"] >= twin_gate,
                  f"fused x{u} vs twin: {fgates[f'x{u}_fused_vs_twin_db']:.2f} dB < {twin_gate}")
        l_batch_arr = [np.frombuffer(f, np.uint8).reshape(OUT_H, OUT_W, 4) for f in l_batch]
        fgates["x2_batch_fused_vs_layers_db"] = min(psnr(x, y) for x, y in zip(f_batch, l_batch_arr))
        fgates["x2_batch_fused_alpha_equal"] = all(
            np.array_equal(x[..., 3], y[..., 3]) for x, y in zip(f_batch, l_batch_arr))
        fgates["x2_batch_fused_equals_layers"] = all(np.array_equal(x, y) for x, y in zip(f_batch, l_batch_arr))
        fgates["x2_batch_first_equals_single"] = bool(np.array_equal(f_batch[0], f_out[2]))
        say("learned fused-trunk gates: " + json.dumps(fgates))
        check(fgates["x2_batch_fused_vs_layers_db"] >= FUSED_TRUNK_GATE_DB
              and fgates["x2_batch_fused_alpha_equal"], "fused batch vs layered batch")
        check(fgates["x2_batch_fused_equals_layers"], "fused batch != the layered batch, byte for byte")
        check(fgates["x2_batch_first_equals_single"], "fused batch[0] != the fused single frame")

        # end to end: upscale(bytes) latency and upscale_arr device frames/s,
        # the layered and the fused trunk (the same call, upscale_arr's
        # self._fn(arr))
        e2e = {}
        for u in ups:
            lat = []
            for _ in range(6):
                t0 = time.perf_counter()
                ups[u].upscale(learned_in[u].tobytes())
                lat.append((time.perf_counter() - t0) * 1e3)
            e2e[f"learned_x{u}_upscale_bytes_ms_median"] = float(np.median(lat[1:]))
            src = torch.from_numpy(learned_in[u]).to(dev)
            for impl, fn in (("", ups[u].upscale_arr), ("_fused", fused_ups[u])):
                fn(src)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    fn(src)
                torch.cuda.synchronize()
                e2e[f"learned_x{u}{impl}_upscale_arr_fps_device"] = 20 / (time.perf_counter() - t0)
        say("e2e learned: " + json.dumps(e2e))

        # the int8 ladders: create_advanced_upscaler("ultra") with the default
        # learned_prefer ("quality") at x2 and x4, and "performance" at x2; the
        # counts are read for each call on its own
        check(create_advanced_upscaler("ultra").learned_prefer == "quality", "the default learned_prefer")
        q_ups = {}
        for prefer, u, h_, w_, arch, ckpt_step, *_ in INT8_LEARNED:
            q_up = create_advanced_upscaler("ultra")
            if prefer != q_up.learned_prefer:
                q_up.learned_prefer = prefer
            q_up.initialize(w_, h_, u * w_, u * h_)
            got = (q_up._serving_tier, q_up._fn.arch, q_up._fn.step, q_up._fn.quantized)
            check(got == ("learned", arch, ckpt_step, True), f"{prefer} x{u} serves {got}")
            q_ups[(prefer, u)] = q_up
        q_out, q_counts = {}, {}
        for (prefer, u), q_up in q_ups.items():
            cc.reset_launches()
            q_out[(prefer, u)] = q_up.upscale(learned_in[u].tobytes())
            torch.cuda.synchronize()
            q_counts[f"{prefer} x{u}"] = dict(cc.launches)
        cc.reset_launches()
        q_batch = q_ups[("quality", 2)].upscale_batch(batch4)
        torch.cuda.synchronize()
        q_counts[f"quality x2 batch of {BATCH}"] = dict(cc.launches)
        int8_launches = sum(c["conv3x3_q"] for c in q_counts.values())
        say(f"launches on the int8 learned path: {json.dumps(q_counts)}")
        for prefer, u, *_, n_q, n_bf16 in INT8_LEARNED:
            check(q_counts[f"{prefer} x{u}"] == {"conv3x3": n_bf16, "conv3x3_q": n_q},
                  f"{prefer} x{u} launches: {q_counts[f'{prefer} x{u}']}")
        check(q_counts[f"quality x2 batch of {BATCH}"] == {"conv3x3": 0, "conv3x3_q": 8}, "batch launches")

        qgates, q_twins = {}, {}
        for prefer, u, h_, w_, arch, _, twin_gate, _, n_bf16 in INT8_LEARNED:
            tag = f"{prefer}_x{u}"
            got = np.frombuffer(q_out[(prefer, u)], np.uint8).reshape(u * h_, u * w_, 4)
            model, _ = pel.load_model(arch, u)
            scales = pel.load_act_scales(arch, u)
            plain_fn = pel.make_serving_fn_fused(model, h_, w_, dev, conv=cc.conv3x3_plain,
                                                 quant_scales=scales, conv_q=cc.conv3x3_q_plain)
            plain = plain_fn(torch.from_numpy(learned_in[u][None]).to(dev))[0].cpu().numpy()
            x01 = torch.from_numpy(learned_in[u][None, ..., :3].astype(np.float32) / 255.0).to(dev)
            twin = pel.make_quant_apply(model, scales)(x01)[0]
            q_twins[tag] = torch.clamp(torch.round(twin * 255.0), 0, 255).to(torch.uint8).cpu().numpy()
            qgates[f"{tag}_vs_plain_path_db"] = psnr(got, plain)
            qgates[f"{tag}_vs_plain_path_max_lsb"] = int(np.abs(got.astype(int) - plain).max())
            qgates[f"{tag}_vs_plain_path_equal"] = float((got == plain).mean())
            qgates[f"{tag}_alpha_equal"] = bool(np.array_equal(got[..., 3], plain[..., 3]))
            qgates[f"{tag}_vs_int8_twin_db"] = psnr(got, q_twins[tag])
            check(got.shape == (OUT_H, OUT_W, 4) and np.all(got[..., 3] == 255), f"{tag} shape/alpha")
            check(qgates[f"{tag}_vs_plain_path_db"] >= LEARNED_GATE_DB and qgates[f"{tag}_alpha_equal"],
                  f"{tag} kernel path vs plain path: {qgates[f'{tag}_vs_plain_path_db']:.2f} dB")
            # every conv on the int8 grid is bit-equal to its plain version;
            # only a bf16 head (x4: no "head" scale) may move a byte
            check(n_bf16 > 0 or qgates[f"{tag}_vs_plain_path_equal"] == 1.0,
                  f"{tag}: the all-int8 graph is not bit-equal to its plain path")
            check(qgates[f"{tag}_vs_int8_twin_db"] >= twin_gate,
                  f"{tag} vs the int8-grid twin: {qgates[f'{tag}_vs_int8_twin_db']:.2f} dB < {twin_gate}")
        qgates["quality_x2_batch_equals_singles"] = q_batch == [q_ups[("quality", 2)].upscale(f)
                                                                for f in batch4]
        say("int8 learned gates: " + json.dumps(qgates))
        check(qgates["quality_x2_batch_equals_singles"], "int8 upscale_batch != upscale of each frame")

        q_e2e = {}
        for (prefer, u), q_up in q_ups.items():
            lat = []
            for _ in range(6):
                t0 = time.perf_counter()
                q_up.upscale(learned_in[u].tobytes())
                lat.append((time.perf_counter() - t0) * 1e3)
            q_e2e[f"{prefer}_x{u}_upscale_bytes_ms_median"] = float(np.median(lat[1:]))
            src = torch.from_numpy(learned_in[u]).to(dev)
            q_up.upscale_arr(src)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                q_up.upscale_arr(src)
            torch.cuda.synchronize()
            q_e2e[f"{prefer}_x{u}_upscale_arr_fps_device"] = 20 / (time.perf_counter() - t0)
        say("e2e int8 learned: " + json.dumps(q_e2e))

    with Phase("4e two-call resample path"):
        # the counterpart of make_pallas_resampler at 1080p→4K lanczos3; the
        # counts are read for this path on its own (two launches a call)
        two = resample.make_twopass_resampler(IN_H, IN_W, OUT_H, OUT_W, "lanczos3")
        rc.reset_launches()
        two_a = two(frames["a"]).cpu().numpy()
        two_batch = two(np.stack([frames[k] for k in ("a", "b", "n1", "n2")])).cpu().numpy()
        torch.cuda.synchronize()
        two_counts = dict(rc.launches)
        say(f"launches on the two-call path: {json.dumps(two_counts)}")
        check(two_counts["resample_twopass"] == 4 and sum(two_counts.values()) == 4,
              f"two-call launches: {two_counts}")
        tgates = {"twocall_vs_golden_db": psnr(two_a, g["a"]),
                  "twocall_max_lsb": int(np.abs(two_a.astype(int) - g["a"]).max()),
                  "twocall_batch_b_vs_golden_db": psnr(two_batch[1], g["b"]),
                  "twocall_equals_fused_upscale": bool(np.array_equal(two_a, out_a)),
                  "twocall_batch_first_equals_single": bool(np.array_equal(two_batch[0], two_a))}
        src = on_dev["a"]
        two(src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            two(src)
        torch.cuda.synchronize()
        tgates["twocall_lanczos3_fps_device"] = 20 / (time.perf_counter() - t0)
        say("two-call gates: " + json.dumps(tgates))
        check(tgates["twocall_vs_golden_db"] >= PSNR_GATE_DB
              and tgates["twocall_batch_b_vs_golden_db"] >= PSNR_GATE_DB,
              f"two-call resample vs golden: {tgates['twocall_vs_golden_db']:.2f} dB")
        check(tgates["twocall_batch_first_equals_single"], "two-call batch[0] != the single frame")

    with Phase("4f learned, every rung"):
        # every rung of the learned ladder through create_advanced_upscaler
        # ("ultra") at full width with the committed weights: the stride-2
        # arch, the non-exact ratio's unfused graph (down and up to the
        # target), ESRGANLite at x2 and x4; the counts are read for each call
        # on its own. The input is the bench frame with a gradient alpha.
        torch.cuda.empty_cache()
        flush4f = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

        def rung_frame(h_: int, w_: int) -> np.ndarray:
            f = bench_frame(h_, w_)
            f[..., 3] = ((np.arange(h_)[:, None] + np.arange(w_)[None, :]) * 255 // (h_ + w_)).astype(np.uint8)
            return f

        rung_ups, rung_out, rung_counts, rgates, rtimes = {}, {}, {}, {}, {}
        rung_launches = 0
        for tag, prefer, h_, w_, oh_, ow_, arch, graph in RUNGS:
            up = create_advanced_upscaler("ultra")
            up.learned_prefer = prefer
            up.initialize(w_, h_, ow_, oh_)
            fn = up._fn
            got = (up._serving_tier, fn.arch, type(fn.serving).__name__, fn.quantized)
            check(got == ("learned", arch, graph, False), f"{tag}: serves {got}")
            frame = rung_frame(h_, w_)
            cc.reset_launches()
            rung_out[tag] = np.frombuffer(up.upscale(frame.tobytes()), np.uint8).reshape(oh_, ow_, 4)
            torch.cuda.synchronize()
            rung_counts[tag] = dict(cc.launches)
            rung_launches += cc.launches["conv3x3"]
            check(rung_counts[tag] == {"conv3x3": fn.serving.convs_per_frame, "conv3x3_q": 0},
                  f"{tag} launches: {rung_counts[tag]} (want {fn.serving.convs_per_frame} conv3x3)")
            rung_ups[tag] = (up, frame)
        say(f"launches on every rung [{card}]: {json.dumps(rung_counts)}")
        # the three ladders serve the stride-2 arch at 1366x768: the same graph
        check(all(np.array_equal(rung_out[f"{p} x2 1366x768"], rung_out["ultra x2 1366x768"])
                  for p in ("quality", "performance")), "the ladders' stride-2 bytes differ")

        # the batch of 4 through the graph, and trunk_impl="fused"
        h_, w_, oh_, ow_ = 768, 1366, 1536, 2732
        up_s2, frame_s2 = rung_ups["ultra x2 1366x768"]
        batch4_s2 = [np.roll(frame_s2, 16 * i, axis=1).tobytes() for i in range(BATCH)]
        cc.reset_launches()
        b_out = up_s2.upscale_batch(batch4_s2)
        torch.cuda.synchronize()
        rung_counts[f"ultra x2 1366x768 batch of {BATCH}"] = dict(cc.launches)
        rung_launches += cc.launches["conv3x3"]
        check(cc.launches["conv3x3"] == up_s2._fn.serving.convs_per_frame, f"batch launches: {cc.launches}")
        rgates["s2_batch_equals_singles"] = b_out == [up_s2.upscale(f) for f in batch4_s2]
        fused_s2 = pel.make_pretrained_upscaler(h_, w_, oh_, ow_, "ultra", dev, "fused")
        cc.reset_launches()
        tc.reset_launches()
        f_s2 = fused_s2(frame_s2).cpu().numpy()
        torch.cuda.synchronize()
        rung_counts["ultra x2 1366x768 trunk_impl=fused"] = {**tc.launches, **cc.launches}
        rung_trunk_launches = tc.launches["trunk_fused"]
        check((tc.launches["trunk_fused"], cc.launches["conv3x3"]) == (1, 0),
              f"fused stride-2 launches: {rung_counts['ultra x2 1366x768 trunk_impl=fused']}")
        rgates["s2_fused_equals_layers"] = bool(np.array_equal(f_s2, rung_out["ultra x2 1366x768"]))
        say(f"launches, batch and fused trunk [{card}]: "
            f"{json.dumps({k: v for k, v in rung_counts.items() if 'batch' in k or 'fused' in k})}")
        check(rgates["s2_batch_equals_singles"], "stride-2 upscale_batch != upscale of each frame")
        check(rgates["s2_fused_equals_layers"], "stride-2 trunk_impl='fused' != 'layers', byte for byte")

        # the gates: the kernel path against the same graph on the plain
        # convs, and against the fp32 twin (the same model in fp32, then the
        # same resize)
        for tag, prefer, h_, w_, oh_, ow_, arch, graph in RUNGS:
            up, frame = rung_ups[tag]
            if tag.startswith(("quality x2 1366", "performance x2 1366")):
                continue  # the bytes of "ultra x2 1366x768", checked above
            model, _ = pel.load_model(arch, up._fn.serving.upscale)
            plain_fn = pel.make_serving_fn(model, h_, w_, oh_, ow_, dev, conv=cc.conv3x3_plain)
            plain = plain_fn(torch.from_numpy(frame[None]).to(dev))[0].cpu().numpy()
            x01 = torch.from_numpy(frame[None, ..., :3].astype(np.float32) / 255.0).to(dev)
            twin = pel.make_twin(model, oh_, ow_)(x01)[0]
            twin_u8 = torch.clamp(torch.round(twin * 255.0), 0, 255).to(torch.uint8).cpu().numpy()
            got = rung_out[tag]
            rgates[f"{tag}_vs_plain_path_db"] = psnr(got, plain)
            rgates[f"{tag}_vs_plain_path_max_lsb"] = int(np.abs(got.astype(int) - plain).max())
            rgates[f"{tag}_alpha_equal"] = bool(np.array_equal(got[..., 3], plain[..., 3]))
            rgates[f"{tag}_vs_twin_db"] = psnr(got, twin_u8)
            check(rgates[f"{tag}_vs_plain_path_db"] >= LEARNED_GATE_DB and rgates[f"{tag}_alpha_equal"],
                  f"{tag} kernel path vs plain path: {rgates[f'{tag}_vs_plain_path_db']:.2f} dB")
            check(rgates[f"{tag}_vs_twin_db"] >= RUNG_TWIN_GATE_DB,
                  f"{tag} vs twin: {rgates[f'{tag}_vs_twin_db']:.2f} dB < {RUNG_TWIN_GATE_DB}")
        # a stride-8, 192-feature model on seeded weights: the fused graph
        # (sparse base) and the unfused one at 1080p x2, kernel against plain
        gen = torch.Generator().manual_seed(SEED)
        s8 = pel.ESRGANLiteTPU(features=192, blocks=3, upscale=2, stride=8, base_impl="sparse")
        for name, p in s8.named_parameters():
            fan_in = p.shape[0] * p.shape[1] * p.shape[2] if p.dim() == 4 else 1
            p.data = (torch.randn(p.shape, generator=gen) / fan_in ** 0.5 if p.dim() == 4
                      else 0.01 * torch.randn(p.shape, generator=gen))
        s8_frame = rung_frame(IN_H, IN_W)
        s8_graphs = {
            "stride8 fused": (pel.FusedServing(s8, IN_H, IN_W, dev),
                              pel.FusedServing(s8, IN_H, IN_W, dev, conv=cc.conv3x3_plain)),
            "stride8 unfused": (pel.UnfusedServing(s8, IN_H, IN_W, OUT_H, OUT_W, dev),
                                pel.UnfusedServing(s8, IN_H, IN_W, OUT_H, OUT_W, dev, conv=cc.conv3x3_plain)),
        }
        src8 = torch.from_numpy(s8_frame[None]).to(dev)
        for tag, (ker_fn, plain_fn) in s8_graphs.items():
            cc.reset_launches()
            got = ker_fn(src8)[0].cpu().numpy()
            torch.cuda.synchronize()
            rung_counts[tag] = dict(cc.launches)
            rung_launches += cc.launches["conv3x3"]
            check(cc.launches["conv3x3"] == ker_fn.convs_per_frame, f"{tag} launches: {cc.launches}")
            plain = plain_fn(src8)[0].cpu().numpy()
            rgates[f"{tag}_vs_plain_path_db"] = psnr(got, plain)
            rgates[f"{tag}_alpha_equal"] = bool(np.array_equal(got[..., 3], plain[..., 3]))
            check(rgates[f"{tag}_vs_plain_path_db"] >= LEARNED_GATE_DB and rgates[f"{tag}_alpha_equal"],
                  f"{tag} kernel path vs plain path: {rgates[f'{tag}_vs_plain_path_db']:.2f} dB")
        say(f"every-rung gates [{card}]: " + json.dumps(rgates))

        # per case: upscale_arr frames/s and device ms a call; the conv work
        # at the kernel's padded widths against the graph's own widths; and
        # each distinct padded conv against F.conv2d at its real widths
        cuda_gen = torch.Generator(device=dev).manual_seed(SEED)

        def spy_convs(serving, src):
            """(positions, h, w, k, b, relu) of each conv launch of one call."""
            seen, orig = [], serving.conv

            def spy(x, k, b, relu, round_sum):
                seen.append((x.shape[0] * x.shape[1] * x.shape[2], x.shape[1], x.shape[2], k, b, relu))
                return orig(x, k, b, relu, round_sum)

            serving.conv = spy
            try:
                serving(src)
            finally:
                serving.conv = orig
            return seen

        timed = []  # (tag, the call timed, its serving graph, its input batch)
        for tag, *_ in RUNGS:
            if tag.startswith(("quality x2 1366", "performance x2 1366")):
                continue  # the "ultra" call's graph
            up, frame = rung_ups[tag]
            src = torch.from_numpy(frame).to(dev)
            timed.append((tag, functools.partial(up.upscale_arr, src), up._fn.serving, src[None]))
        src = torch.from_numpy(frame_s2).to(dev)
        timed.append(("ultra x2 1366x768 trunk_impl=fused", functools.partial(fused_s2, src),
                      fused_s2.serving, src[None]))
        timed += [(tag, functools.partial(ker_fn, src8), ker_fn, src8) for tag, (ker_fn, _) in s8_graphs.items()]
        conv_pairs = {}
        for tag, run, serving, src in timed:
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                run()
            torch.cuda.synchronize()
            fps = 10 / (time.perf_counter() - t0)
            dev_ms = time_ms(torch, run, flush4f)
            rtimes[tag] = {"upscale_arr_fps_device": fps, "device_ms_per_call": dev_ms}
            if serving.trunk_impl == "fused":
                say(f"time every rung [{tag}] [{card}]: {fps:.2f} frames/s, {dev_ms:.4f} ms a call on "
                    f"the card (one trunk_fused launch)")
                continue
            seen = spy_convs(serving, src)
            padded_ops = sum(2 * 9 * k.shape[2] * k.shape[3] * n_pos for n_pos, _, _, k, _, _ in seen)
            real_ops = sum(2 * 9 * ci * co * n_pos for (n_pos, *_), (ci, co) in zip(seen, serving.widths))
            rtimes[tag].update({"conv_launches": len(seen), "conv_ops_padded": padded_ops,
                                "conv_ops_real": real_ops, "padded_over_real": padded_ops / real_ops})
            say(f"time every rung [{tag}] [{card}]: {fps:.2f} frames/s, {dev_ms:.4f} ms a call on the "
                f"card; {len(seen)} conv launches, {padded_ops / 1e9:.2f} GFLOP at the padded widths "
                f"against {real_ops / 1e9:.2f} at the graph's ({padded_ops / real_ops:.2f}x)")
            for (_, h_c, w_c, k, b, relu), (ci, co) in zip(seen, serving.widths):
                key = (h_c, w_c, k.shape[2], k.shape[3], ci, co)
                if key in conv_pairs or (k.shape[2], k.shape[3]) == (ci, co):
                    continue
                x = torch.randn((1, h_c, w_c, k.shape[2]), generator=cuda_gen, device=dev).to(torch.bfloat16)
                x[..., ci:] = 0
                xc = x[..., :ci].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
                wc = k[:, :, :ci, :co].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                bc = b[:co].contiguous()
                ker_ms = time_ms(torch, lambda: cc.conv3x3(x, k, b, relu, True), flush4f)
                lib_ms = time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wc, bc, padding=1), flush4f)
                lib_d = float((torch.nn.functional.conv2d(xc, wc, bc, padding=1).permute(0, 2, 3, 1).float()
                               - cc.conv3x3(x, k, b, False, True)[..., :co].float()).abs().max().item())
                conv_pairs[key] = {"case": tag, "positions": f"{h_c}x{w_c}",
                                   "padded": f"{k.shape[2]}->{k.shape[3]}", "real": f"{ci}->{co}",
                                   "kernel_ms": ker_ms, "F_conv2d_real_ms": lib_ms,
                                   "max_abs_diff_F_conv2d": lib_d}
                say(f"  conv [{tag}] {h_c}x{w_c} padded {k.shape[2]}->{k.shape[3]}: {ker_ms:.4f} ms; "
                    f"F.conv2d at the real {ci}->{co}: {lib_ms:.4f} ms (max |d| {lib_d:.4g}) [{card}]")
        say(f"e2e every rung [{card}]: " + json.dumps(rtimes))
        del flush4f

    with Phase("4g live 4:2:0 and the flow modes"):
        # the live link's 4:2:0 conversions against the numpy goldens: the
        # capture planes of the bench frame in, the 4K bench frame out
        gy, gu, gv = _rgba_to_yuv420(frames["a"])
        ingest = color.make_yuv420_to_rgba(IN_H, IN_W)
        rgba_in = ingest(*(torch.from_numpy(p).to(dev) for p in (gy, gu, gv))).cpu().numpy()
        rgba_in_cpu = color.make_yuv420_to_rgba(IN_H, IN_W, "cpu")(gy, gu, gv).numpy()
        want_in = _yuv420_to_rgba(gy, gu, gv)
        big = bench_frame(OUT_H, OUT_W)
        planes_out = [p.cpu().numpy() for p in color.make_rgba_to_yuv420(OUT_H, OUT_W)(torch.from_numpy(big).to(dev))]
        planes_cpu = [p.numpy() for p in color.make_rgba_to_yuv420(OUT_H, OUT_W, "cpu")(big)]
        want_out = _rgba_to_yuv420(big)
        color_gates = {
            "psnr_yuv420_ingest_db": psnr(rgba_in, want_in),
            "ingest_max_lsb": lsb(rgba_in, want_in),
            "ingest_card_vs_cpu_max_lsb": lsb(rgba_in, rgba_in_cpu),
            "psnr_yuv420_deliver_db": min(plane_psnr(p, q) for p, q in zip(planes_out, want_out)),
            "deliver_max_lsb": max(lsb(p, q) for p, q in zip(planes_out, want_out)),
            "deliver_card_vs_cpu_max_lsb": max(lsb(p, q) for p, q in zip(planes_out, planes_cpu)),
        }
        say(f"color gates [{card}]: " + json.dumps(color_gates))
        for name in ("psnr_yuv420_ingest_db", "psnr_yuv420_deliver_db"):
            check(color_gates[name] >= PSNR_GATE_DB, f"{name} {color_gates[name]:.2f} dB < {PSNR_GATE_DB}")
        for name in ("ingest_max_lsb", "ingest_card_vs_cpu_max_lsb", "deliver_max_lsb",
                     "deliver_card_vs_cpu_max_lsb"):
            check(color_gates[name] <= 1, f"{name}: {color_gates[name]} LSB")

        # the live 4:2:0 step as bench.py builds it: 4:2:0 planes in, the fused
        # resample + cross-fade kernel, 4:2:0 planes out
        deliver = color.make_delivery_fn(OUT_H, OUT_W, "yuv420")
        live_planes = [_rgba_to_yuv420(f) for f in live_in]

        def make_yuv_pipe(deliver_fn=deliver):
            return LivePipeline(None, depth=2, fused_step_fn=step, ingest_fn=ingest, deliver_fn=deliver_fn)

        rc.reset_launches()
        pipe = make_yuv_pipe()
        yuv_out = []
        for pl in live_planes:
            yuv_out += pipe.put(pl)
        yuv_out += pipe.drain()
        torch.cuda.synchronize()
        yuv_counts = {k: rc.launches[k] for k in ("resample_fused", "resample_fused_blend")}
        say(f"launches on the live 4:2:0 path: {json.dumps(yuv_counts)}")
        check(yuv_counts == {"resample_fused": 1, "resample_fused_blend": LIVE_FRAMES - 1},
              f"live 4:2:0 launches: {yuv_counts}")
        shapes = ((OUT_H, OUT_W), (OUT_H // 2, OUT_W // 2), (OUT_H // 2, OUT_W // 2))
        check(len(yuv_out) == 2 * LIVE_FRAMES - 1, f"live 4:2:0 payloads: {len(yuv_out)}")
        check(all(isinstance(o, tuple) and tuple(p.shape for p in o) == shapes
                  and all(p.dtype == np.uint8 for p in o) for o in yuv_out), "live 4:2:0 payload shapes")
        # the first frame and the first mid against the float64 goldens of the
        # ingested frames (the mid: the round-blend of the two), packed 4:2:0
        ga, gb = (golden(torch, _yuv420_to_rgba(*pl), wv, wh).cpu().numpy() for pl in live_planes[:2])
        gmid = np.clip(np.round((ga.astype(np.float64) + gb.astype(np.float64)) * 0.5), 0, 255).astype(np.uint8)
        live_gates = {
            "first_planes_db": min(plane_psnr(p, q) for p, q in zip(yuv_out[0], _rgba_to_yuv420(ga))),
            "mid_planes_db": min(plane_psnr(p, q) for p, q in zip(yuv_out[1], _rgba_to_yuv420(gmid))),
        }
        say(f"live 4:2:0 vs goldens [{card}]: " + json.dumps(live_gates))
        check(min(live_gates.values()) >= PSNR_GATE_DB, f"live 4:2:0 below the gate: {live_gates}")

        # the same step with a PREVIEW_H-row preview: the area resample on
        # resample_fused, its bytes those of the plain version
        preview = color.make_delivery_fn(OUT_H, OUT_W, "yuv420", PREVIEW_H)
        ph, pw = preview.out_hw
        area = resample.make_resampler(OUT_H, OUT_W, ph, pw, "area")
        rgba_pipe = LivePipeline(None, depth=2, fused_step_fn=step, ingest_fn=ingest)
        rgba_out = []
        for pl in live_planes:
            rgba_out += rgba_pipe.put_device(pl)
        rgba_out += rgba_pipe.drain_device()
        torch.cuda.synchronize()
        rc.reset_launches()
        pipe = make_yuv_pipe(preview)
        prev_out = []
        for pl in live_planes:
            prev_out += pipe.put_device(pl)
        prev_out += pipe.drain_device()
        torch.cuda.synchronize()
        prev_counts = {k: rc.launches[k] for k in ("resample_fused", "resample_fused_blend")}
        say(f"launches on the live 4:2:0 path with a {ph}x{pw} preview: {json.dumps(prev_counts)}")
        check(prev_counts == {"resample_fused": 1 + len(prev_out), "resample_fused_blend": LIVE_FRAMES - 1},
              f"preview launches: {prev_counts}")
        pack = color.make_rgba_to_yuv420(ph, pw)
        for o_rgba, o_yuv in zip(rgba_out, prev_out):
            plain = pack(rc.resample_plain(o_rgba, area.plan))
            check(all(torch.equal(x, y) for x, y in zip(o_yuv, plain)), "preview != its plain version")
        mb_in = color.payload_bytes("yuv420", IN_H, IN_W) / 1e6
        live_e2e = {
            "live_yuv420_output_fps_device": live_fps(torch, make_yuv_pipe, live_planes, False),
            "live_yuv420_output_fps_host": live_fps(torch, make_yuv_pipe, live_planes, True),
            "live_yuv420_preview_output_fps_host": live_fps(
                torch, lambda: make_yuv_pipe(preview), live_planes, True),
            "payload_mb_in": mb_in, "payload_mb_out": color.payload_bytes("yuv420", OUT_H, OUT_W) / 1e6,
            "payload_mb_out_preview": color.payload_bytes("yuv420", ph, pw) / 1e6,
            "payload_mb_out_rgba": color.payload_bytes("rgba", OUT_H, OUT_W) / 1e6,
        }
        say(f"e2e live 4:2:0 [{card}]: " + json.dumps(live_e2e))
        bench = benchmark_live_pipeline(up_fn, interp.make_interpolator(IN_H, IN_W, "blend"), live_in * 2)
        say(f"benchmark_live_pipeline lanczos3 + blend, host frames in and out [{card}]: " + json.dumps(bench))
        check(bench["output_frames"] == 2 * (2 * LIVE_FRAMES - 4), f"benchmark frames: {bench}")

        # the modes "flow" and "flow_exact" through the API, the card against
        # the CPU, and on a texture moved by 8 px against the cross-fade
        w0, w8, w4 = (wave_pattern(IN_W, IN_H, s_) for s_ in (0.0, 8.0, 4.0))
        blend_wave = interp.blend_only(torch.from_numpy(w0), torch.from_numpy(w8), 0.5).numpy()
        cpu_a, cpu_b = torch.from_numpy(frames["a"]), torch.from_numpy(frames["b"])
        mode_gates = {"wave_blend_vs_truth_db": psnr(blend_wave, w4)}
        flow_fns = {"flow": (interp.compute_flow_fast, interp.warp_blend_fast),
                    "flow_exact": (interp.compute_flow, interp.warp_blend)}
        for mode, (flow_of, warp) in flow_fns.items():
            fi = WgpuFrameInterpolator(mode=mode)
            mid = np.frombuffer(fi.interpolate_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H),
                                np.uint8).reshape(IN_H, IN_W, 4)
            flow_card = flow_of(on_dev["a"], on_dev["b"])
            flow_cpu = flow_of(cpu_a, cpu_b)
            mid_cpu = warp(cpu_a, cpu_b, flow_cpu, 0.5).numpy()
            wave = np.frombuffer(fi.interpolate_py(w0.tobytes(), w8.tobytes(), IN_W, IN_H),
                                 np.uint8).reshape(IN_H, IN_W, 4)
            mode_gates[f"{mode}_card_vs_cpu_db"] = psnr(mid, mid_cpu)
            mode_gates[f"{mode}_card_vs_cpu_max_lsb"] = lsb(mid, mid_cpu)
            mode_gates[f"{mode}_alpha_equal"] = bool(np.array_equal(mid[..., 3], mid_cpu[..., 3]))
            mode_gates[f"{mode}_flow_card_vs_cpu_px"] = float((flow_card.cpu() - flow_cpu).abs().max())
            mode_gates[f"{mode}_mean_flow_px"] = [float(v) for v in flow_card.mean(dim=(0, 1)).cpu()]
            mode_gates[f"wave_{mode}_vs_truth_db"] = psnr(wave, w4)
            if mode == "flow":
                ts = (1.0 / 3.0, 2.0 / 3.0)
                mids = fi.interpolate_multi_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H, times=ts)
                mode_gates["flow_multi_equals_single"] = all(
                    m == fi.interpolate_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H, time_t=t)
                    for m, t in zip(mids, ts))
        say(f"flow modes gates [{card}]: " + json.dumps(mode_gates))
        for mode in flow_fns:
            check(mode_gates[f"{mode}_card_vs_cpu_db"] >= PSNR_GATE_DB, f"{mode}: card vs CPU below the gate")
            check(mode_gates[f"{mode}_flow_card_vs_cpu_px"] <= FLOW_TILE_GATE_PX, f"{mode}: flow card != CPU")
            check(mode_gates[f"wave_{mode}_vs_truth_db"] > mode_gates["wave_blend_vs_truth_db"],
                  f"{mode} does not beat the cross-fade on the moving texture")
        check(mode_gates["flow_alpha_equal"], "flow: alpha differs between the card and the CPU")
        check(mode_gates["flow_multi_equals_single"], "flow: interpolate_multi_py != interpolate_py")

        # the live step with a lanczos3 upscale and the flow interpolator: two
        # resample launches a step (mid and current) and no soft warp
        flow_interp = interp.make_interpolator(IN_H, IN_W, "flow")
        rc.reset_launches()
        swc.reset_launches()
        fpipe = LivePipeline(up_fn, flow_interp, depth=2)
        per_step, flow_live = [], []
        for f in live_in:
            before = rc.launches["resample_fused"]
            flow_live += fpipe.put(f)
            per_step.append(rc.launches["resample_fused"] - before)
        flow_live += fpipe.drain()
        torch.cuda.synchronize()
        say(f"launches on the flow live path: resample_fused per step {per_step}, "
            f"soft_warp_blend {swc.launches['soft_warp_blend']}")
        check(per_step == [1] + [2] * (LIVE_FRAMES - 1) and swc.launches["soft_warp_blend"] == 0,
              f"flow live launches: {per_step}")
        check(len(flow_live) == 2 * LIVE_FRAMES - 1, f"flow live frames: {len(flow_live)}")
        g4_counts = {k: yuv_counts[k] + prev_counts[k] for k in yuv_counts}
        g4_counts["resample_fused"] += sum(per_step)

        # the timing API: each mode's device ms and stages, the calibration's
        timing = {}
        for mode, keys in STAGE_KEYS.items():
            fi = WgpuFrameInterpolator(mode=mode)
            fi.interpolate_py(frames["a"].tobytes(), frames["b"].tobytes(), IN_W, IN_H)
            ms, detail = fi.get_last_gpu_duration_ms(), fi.get_last_gpu_duration_detail()
            calibrated = interp.calibrated_step_ms(*fi._last_key, device=dev)
            timing[mode] = {"gpu_duration_ms": ms, **detail}
            check(set(detail) == keys | {"wall_ms"}, f"{mode}: timing keys {sorted(detail)}")
            check(all(v > 0 for v in detail.values()), f"{mode}: a timing is not positive: {detail}")
            check(ms == calibrated == detail["total_ms"], f"{mode}: {ms} ms is not the calibration's")
        say(f"timing API at 1080p (device ms, CUDA events) [{card}]: " + json.dumps(timing))

    with Phase("4h flow_soft_ref path"):
        # the learned refinement tier at 1080p → 4K with the committed
        # interp_ref4 weights (128 features, 1 block, stride 4): its four
        # convs on conv3x3 at the 270x480 s2d grid; each call's counts read
        # on its own
        torch.cuda.empty_cache()
        ref_graph = pir.get_refine_graph(IN_H, IN_W, dev)
        ref_meta = pir.load_model()[1]
        check(not ref_graph.quantized and ref_graph.convs_per_frame == 4,
              f"the refinement graph: quantized {ref_graph.quantized}, {ref_graph.convs_per_frame} convs")
        ts3 = (1.0 / 3.0, 2.0 / 3.0)
        ab = (frames["a"].tobytes(), frames["b"].tobytes())
        fr = WgpuFrameInterpolator(mode="flow_soft_ref")
        mid_up = interp.make_refined_mid_upscaler(IN_H, IN_W, OUT_H, OUT_W)
        multi_up = interp.make_refined_multi_upscaler(IN_H, IN_W, OUT_H, OUT_W, ts3)
        ref_interp = interp.make_interpolator(IN_H, IN_W, "flow_soft_ref")
        check(mid_up.ref is ref_graph and multi_up.ref is ref_graph, "the refined 4K path at 1080p")

        def reset_all():
            cc.reset_launches()
            swc.reset_launches()
            rc.reset_launches()

        def read_all() -> dict:
            torch.cuda.synchronize()
            return {"conv3x3": cc.launches["conv3x3"], "conv3x3_q": cc.launches["conv3x3_q"],
                    "soft_warp_blend": swc.launches["soft_warp_blend"],
                    "resample_fused": rc.launches["resample_fused"]}

        ref_counts = {}
        reset_all()
        mid_ref = np.frombuffer(fr.interpolate_py(*ab, IN_W, IN_H), np.uint8).reshape(IN_H, IN_W, 4)
        ref_counts["interpolate_py"] = read_all()
        reset_all()
        mids_ref = fr.interpolate_multi_py(*ab, IN_W, IN_H, times=ts3)
        ref_counts["interpolate_multi_py"] = read_all()
        reset_all()
        up_mid = mid_up(on_dev["a"], on_dev["b"], 0.5).cpu().numpy()
        ref_counts["make_refined_mid_upscaler"] = read_all()
        reset_all()
        up_multi = multi_up(on_dev["a"], on_dev["b"]).cpu().numpy()
        ref_counts["make_refined_multi_upscaler"] = read_all()
        # the app's live configuration with --interp-mode flow_soft_ref: the
        # lanczos3 upscale and the flow_soft_ref interpolator
        reset_all()
        rpipe = LivePipeline(up_fn, ref_interp, depth=2)
        ref_live, ref_steps = [], []
        for f in live_in:
            before = read_all()
            ref_live += rpipe.put(f)
            after = read_all()
            ref_steps.append(tuple(after[k] - before[k] for k in ("conv3x3", "soft_warp_blend", "resample_fused")))
        ref_live += rpipe.drain()
        ref_counts["live"] = read_all()
        say(f"launches on the flow_soft_ref path, each call on its own [{card}]: {json.dumps(ref_counts)}; "
            f"per live step (conv3x3, soft_warp_blend, resample_fused): {ref_steps}")
        per_mid = {"conv3x3": 4, "conv3x3_q": 0, "soft_warp_blend": 1}
        for name, n_mid, n_up in (("interpolate_py", 1, 0), ("interpolate_multi_py", 2, 0),
                                  ("make_refined_mid_upscaler", 1, 1), ("make_refined_multi_upscaler", 2, 2)):
            want = {k: v * n_mid for k, v in per_mid.items()} | {"resample_fused": n_up}
            check(ref_counts[name] == want, f"{name} launches: {ref_counts[name]}, want {want}")
        check(ref_steps[0] == (0, 0, 1) and all(c == (4, 1, 2) for c in ref_steps[1:]),
              f"flow_soft_ref live step launches: {ref_steps}")
        h4_counts = {k: sum(c[k] for c in ref_counts.values()) for k in ("conv3x3", "soft_warp_blend", "resample_fused")}

        # the gates: the refined mid on the card against the same graph on the
        # conv's plain version on the card, and against the CPU (the same
        # flow_soft mid in), each within REFINE_MAX_LSB, which the net's own
        # change of the mid must exceed; the refined 4K mid in one call
        # against make_resampler of interpolate_py's refined mid (the port's
        # psnr_flow_soft_ref_db); the multi forms against the single calls
        soft_mid = interp.soft_interp_fast(on_dev["a"], on_dev["b"], 0.5)
        ker_mid = ref_graph(on_dev["a"], on_dev["b"], soft_mid).cpu().numpy()
        plain_graph = pir.RefineGraph(pir.load_model()[0], IN_H, IN_W, dev, conv=cc.conv3x3_plain)
        plain_mid = plain_graph(on_dev["a"], on_dev["b"], soft_mid).cpu().numpy()
        cpu_mid = pir.get_refine_graph(IN_H, IN_W, "cpu")(
            torch.from_numpy(frames["a"]), torch.from_numpy(frames["b"]), soft_mid.cpu()).numpy()
        ref_gates = {
            "refined_mid_vs_plain_convs_db": psnr(ker_mid, plain_mid),
            "refined_mid_vs_plain_convs_max_lsb": lsb(ker_mid, plain_mid),
            "refined_mid_alpha_equal": bool(np.array_equal(ker_mid[..., 3], plain_mid[..., 3])),
            "refined_mid_vs_cpu_db": psnr(ker_mid, cpu_mid),
            "refined_mid_vs_cpu_max_lsb": lsb(ker_mid, cpu_mid),
            "api_mid_equals_graph": bool(np.array_equal(mid_ref, ker_mid)),
            "refined_mid_vs_flow_soft_mid_db": psnr(ker_mid, soft_mid.cpu().numpy()),
            "refined_mid_vs_flow_soft_mid_max_lsb": lsb(ker_mid, soft_mid.cpu().numpy()),
        }
        d2s_up = up_fn(torch.from_numpy(mid_ref.copy())).cpu().numpy()
        ref_gates["psnr_flow_soft_ref_db"] = psnr(up_mid, d2s_up)
        ref_gates["refined_4k_equals_d2s_resample"] = bool(np.array_equal(up_mid, d2s_up))
        singles = [mid_up(on_dev["a"], on_dev["b"], t).cpu().numpy() for t in ts3]
        ref_gates["refined_multi_equals_single"] = all(np.array_equal(m, s_) for m, s_ in zip(up_multi, singles))
        ref_gates["multi_py_equals_single"] = mids_ref == [fr.interpolate_py(*ab, IN_W, IN_H, time_t=t) for t in ts3]
        # on a texture moved by 8 px the true mid is the texture moved by 4 px
        w0, w8, w4 = (wave_pattern(IN_W, IN_H, s_) for s_ in (0.0, 8.0, 4.0))
        for mode in ("flow_soft", "flow_soft_ref"):
            wave = np.frombuffer(WgpuFrameInterpolator(mode=mode).interpolate_py(
                w0.tobytes(), w8.tobytes(), IN_W, IN_H), np.uint8).reshape(IN_H, IN_W, 4)
            ref_gates[f"wave_{mode}_vs_truth_db"] = psnr(wave, w4)
        say(f"flow_soft_ref gates, {ref_meta['net']} step {ref_meta['step']} [{card}]: " + json.dumps(ref_gates))
        check(ref_gates["refined_mid_vs_plain_convs_db"] >= LEARNED_GATE_DB and ref_gates["refined_mid_alpha_equal"]
              and ref_gates["refined_mid_vs_plain_convs_max_lsb"] <= REFINE_MAX_LSB,
              f"refined mid vs plain convs: {ref_gates['refined_mid_vs_plain_convs_db']:.2f} dB, "
              f"max {ref_gates['refined_mid_vs_plain_convs_max_lsb']} LSB")
        check(ref_gates["refined_mid_vs_cpu_db"] >= LEARNED_GATE_DB
              and ref_gates["refined_mid_vs_cpu_max_lsb"] <= REFINE_MAX_LSB,
              f"refined mid vs the CPU: {ref_gates['refined_mid_vs_cpu_db']:.2f} dB, "
              f"max {ref_gates['refined_mid_vs_cpu_max_lsb']} LSB")
        check(ref_gates["refined_mid_vs_flow_soft_mid_max_lsb"] > REFINE_MAX_LSB,
              f"the net moves the mid by {ref_gates['refined_mid_vs_flow_soft_mid_max_lsb']} LSB at most: "
              f"the {REFINE_MAX_LSB} LSB gate would not tell a wrong conv from the net")
        check(ref_gates["psnr_flow_soft_ref_db"] >= PSNR_GATE_DB,
              f"psnr_flow_soft_ref_db {ref_gates['psnr_flow_soft_ref_db']:.2f} < {PSNR_GATE_DB}")
        check(ref_gates["refined_multi_equals_single"], "make_refined_multi_upscaler != the single calls")
        check(ref_gates["multi_py_equals_single"], "flow_soft_ref interpolate_multi_py != interpolate_py")
        check(ref_gates["api_mid_equals_graph"], "interpolate_py's refined mid != the graph on its flow_soft mid")
        check(len(ref_live) == 2 * LIVE_FRAMES - 1 and all(o.shape == (OUT_H, OUT_W, 4) for o in ref_live),
              f"flow_soft_ref live frames: {len(ref_live)}")
        check(np.array_equal(ref_live[1], d2s_up), "live flow_soft_ref mid != upscale(interpolate_py)")

        # recorded: the timing API, the live output fps on the card and
        # fetched, and the device ms of the refinement graph alone and of one
        # refined 4K mid (CUDA events, the host's launches hidden)
        fr.interpolate_py(*ab, IN_W, IN_H)
        ref_timing = {"gpu_duration_ms": fr.get_last_gpu_duration_ms(), **fr.get_last_gpu_duration_detail()}
        check(set(ref_timing) == {"gpu_duration_ms", "total_ms", "flow_ms", "warp_ms", "refine_ms", "wall_ms"},
              f"flow_soft_ref timing keys: {sorted(ref_timing)}")
        check(ref_timing["refine_ms"] >= 0 and all(ref_timing[k] > 0 for k in ("total_ms", "flow_ms", "warp_ms")),
              f"flow_soft_ref timing: {ref_timing}")
        ref_e2e = {
            "net_device_ms": 1e3 * device_timer(
                lambda s_: (s_[0], s_[1], ref_graph(s_[0], s_[1], s_[2])), (on_dev["a"], on_dev["b"], soft_mid)),
            "refined_4k_mid_device_ms": 1e3 * device_timer(
                lambda s_: (s_[1], s_[0], mid_up(s_[0], s_[1], 0.5)[:1, :1]),
                (on_dev["a"], on_dev["b"], soft_mid[:1, :1])),
            "live_flow_soft_ref_output_fps_device": live_fps(
                torch, lambda: LivePipeline(up_fn, ref_interp, depth=2), live_in, False),
            "live_flow_soft_ref_output_fps_host": live_fps(
                torch, lambda: LivePipeline(up_fn, ref_interp, depth=2), live_in, True),
        }
        lat = []
        for _ in range(6):
            t0 = time.perf_counter()
            fr.interpolate_py(*ab, IN_W, IN_H)
            lat.append((time.perf_counter() - t0) * 1e3)
        ref_e2e["interpolate_py_flow_soft_ref_ms_median"] = float(np.median(lat[1:]))
        say(f"timing API flow_soft_ref at 1080p (device ms, CUDA events) [{card}]: " + json.dumps(ref_timing))
        say(f"e2e flow_soft_ref [{card}]: " + json.dumps(ref_e2e))

        # the four convs' operands as the graph launches them, for phase 5
        ref_convs, orig_conv = [], ref_graph.conv

        def spy_ref(x, k, b, relu, round_sum):
            ref_convs.append((x, k, b, relu))
            return orig_conv(x, k, b, relu, round_sum)

        ref_graph.conv = spy_ref
        try:
            ref_graph(on_dev["a"], on_dev["b"], soft_mid)
        finally:
            ref_graph.conv = orig_conv
        # each of them on the kernel against its plain version, within the
        # conv's bound (conv_cuda.ulp_tolerance, the sum rounded as served)
        check(len(ref_convs) == ref_graph.convs_per_frame, f"{len(ref_convs)} refinement convs captured")
        for name, (x, k, b, relu) in zip(REFINE_CONVS, ref_convs):
            kout, pout = cc.conv3x3(x, k, b, relu, True), cc.conv3x3_plain(x, k, b, relu, True)
            torch.cuda.synchronize()
            d = (kout.float() - pout.float()).abs()
            tol = cc.ulp_tolerance(x, k, pout, True)
            over, max_d = int((d > tol).sum().item()), float(d.max().item())
            say(f"conv3x3 refinement [{name} 1x{x.shape[1]}x{x.shape[2]} {k.shape[2]}->{k.shape[3]}] "
                f"relu={relu}: {int((d > 0).sum().item())} of {d.numel()} values differ, max {max_d:.6g}, "
                f"max |d|/tol {float((d / tol.clamp_min(1e-30)).max().item()):.3f}, over the bound {over}")
            check(kout.shape == pout.shape and over == 0 and bool(torch.isfinite(kout.float()).all()),
                  f"conv3x3 refinement {name}: {over} over the bound")
            errs["conv3x3"] = max(errs["conv3x3"], max_d)

    with Phase("4i benchmark API"):
        # the API's benchmark on the card at 1080p x2 through the entry points
        # a user calls: wgpu, fsr and dlss (the "quality" ladder: tpu4b2, int8)
        # one call each, its counts on their own (a warm-up frame and
        # BENCH_FRAMES timed frames, each its tier's launches); then the grid
        # of 4 technologies x 4 qualities
        torch.cuda.empty_cache()
        per_frame = {"wgpu": {"resample_fused": 1}, "fsr": {"fsr": 1}, "dlss": {"conv3x3_q": 8, "conv3x3": 0}}
        names = {"wgpu": ("WgpuUpscaler", "Wgpu"), "fsr": ("FsrUpscaler", "FSR"), "dlss": ("LearnedUpscaler", "DLSS")}
        bench_api = {}
        for tech, want in per_frame.items():
            cc.reset_launches()
            fc.reset_launches()
            rc.reset_launches()
            r = py_benchmark_upscaler(tech, "quality", IN_W, IN_H, 2.0, BENCH_FRAMES)
            torch.cuda.synchronize()
            got = {k: {**cc.launches, **fc.launches, **rc.launches}[k] for k in want}
            bench_api[tech] = {"fps": r.fps, "avg_frame_time_ms": r.avg_frame_time_ms,
                               "p50_frame_time_ms": r.p50_frame_time_ms, "p99_frame_time_ms": r.p99_frame_time_ms,
                               "total_duration_ms": r.total_duration_ms, "launches": got}
            check((r.upscaler_name, r.technology, r.quality) == (*names[tech], "Quality"),
                  f"benchmark {tech}: {r!r}")
            check((r.output_width, r.output_height, r.frames_processed) == (OUT_W, OUT_H, BENCH_FRAMES),
                  f"benchmark {tech}: {r.output_width}x{r.output_height}, {r.frames_processed} frames")
            check(r.fps > 0 and 0 < r.p50_frame_time_ms <= r.p99_frame_time_ms, f"benchmark {tech}: {r!r}")
            check(got == {k: v * (BENCH_FRAMES + 1) for k, v in want.items()},
                  f"benchmark {tech}: launches {got}, want {want} a frame for {BENCH_FRAMES + 1} frames")
        grid = py_run_comparison_benchmark(IN_W, IN_H, 2.0, 2)
        check(len(grid) == 16 and all(r.fps > 0 for r in grid), f"the comparison grid: {len(grid)} cells")
        bench_api["grid_fps"] = {f"{r.technology}/{r.quality}": r.fps for r in grid}
        say(f"benchmark API at 1080p x2 (host clock to torch.cuda.synchronize) [{card}]: " + json.dumps(bench_api))

    with Phase("4j the app on the port"):
        # the app (nu_scaler/), unmodified, through the launcher's finder in
        # this process, at 1080p -> 4K: its transcode, its headless live loop,
        # the NuScaler facade and its benchmark CLI; each run's launch counts
        # read on its own
        j4_counts = app_on_the_port(torch, live_in, wv, wh, card)

    with Phase("4k training"):
        # the port's trainers at full width on the card, their checkpoints
        # in a temporary CKPT_ROOT, served through the port's kernels
        k4_counts, train_steps, pool, trained = training_on_the_card(torch, card, dev, learned_in[2],
                                                                     (on_dev["a"], on_dev["b"]))

    with Phase("4l mesh"):
        # the mesh functions on shards that share the card (and on every card
        # when several are visible), each byte-equal to one call; the API's
        # sharded batch branches
        l4_counts, mesh_times = mesh_on_the_card(torch, card, torch.device("cuda", 0), frames, g["a"],
                                                 sized["540p"])

    with Phase("4m sharded training"):
        # the dp x tp train step on 4 ranks that share the card (and on NCCL
        # across four cards when they are visible), a 1 x 1 NCCL world, and
        # the gathered weights served through conv3x3.cu
        m4_counts, _ = sharded_training_on_the_card(torch, card, torch.device("cuda", 0), pool, learned_in[2])

    with Phase("4n serving after training"):
        # what the API serves once phase 4k's trainers wrote (the loaders'
        # caches cleared), tpu4 x2 resumed from 80000, both distillation
        # teachers, and tpu8 / tpu8w x2 on their committed weights
        n4_counts = serving_after_training(torch, card, dev, learned_in[2], pool, trained)

    with Phase("4o the command lines"):
        # the refinement net's command line (--calibrate of the committed
        # step, a leg, a distillation, --eval) and the SR trainer's
        # --calibrate --io, in process, on an empty CKPT_ROOT
        o4_counts = clis_on_the_card(torch, card, dev, learned_in[2], (on_dev["a"], on_dev["b"]))

    with Phase("5 times"):
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        tables = 4 * (OUT_H * (1 + lz.kv) + OUT_W * (1 + lz.kh))
        frame_in, frame_out = IN_H * IN_W * 4, OUT_H * OUT_W * 4

        def no_fma_bound(moved: int, ops: int) -> tuple[float, str]:
            """The larger of the bytes over the memory rate and the
            instruction floor: a kernel that forms no FMA issues one fp32
            instruction per operation, at half the FMA-counted rate."""
            t_bytes, t_floor = moved / mem_bw * 1e3, ops / (f32_rate / 2) * 1e3
            return (t_bytes, "bytes") if t_bytes >= t_floor else (t_floor, "operations")

        def bound(n: int, n_ts: int) -> tuple[float, str]:
            moved = n * frame_in + n * frame_out * (1 + n_ts) + (frame_out if n_ts else 0) + tables
            ops = 2 * n * 4 * (lz.nnz_v * IN_W + lz.nnz_h * OUT_H) + 3 * n_ts * frame_out
            t_bytes, t_ops = moved / mem_bw * 1e3, ops / f32_rate * 1e3
            say(f"  work: {moved} bytes, {ops} fp32 operations")
            return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

        single, prev = on_dev["a"], rc.resample_plain(on_dev["n2"], lz)
        cases = {
            "resample_fused": (
                lambda: rc.resample_fused(single, lz), lambda: rc.resample_plain(single, lz), 1, 0),
            "resample_fused_batched": (
                lambda: rc.resample_fused_batched(batch, lz), lambda: rc.resample_plain(batch, lz),
                BATCH, 0),
            "resample_fused_blend": (
                lambda: rc.resample_fused_blend(on_dev["b"], prev, lz, (0.5,)),
                lambda: rc.resample_blend_plain(on_dev["b"], prev, lz, (0.5,)), 1, 1),
            "resample_fused_blend ts=(1/3,2/3)": (
                lambda: rc.resample_fused_blend(on_dev["b"], prev, lz, (1 / 3, 2 / 3)),
                lambda: rc.resample_blend_plain(on_dev["b"], prev, lz, (1 / 3, 2 / 3)), 1, 2),
        }
        rows = []
        launched = {name: counts[name] + flow_counts.get(name, 0) + g4_counts.get(name, 0)
                    + h4_counts.get(name, 0) + j4_counts.get(name, 0) + k4_counts.get(name, 0)
                    + n4_counts.get(name, 0) + o4_counts.get(name, 0) for name in counts}
        for name, (kernel, plain, n, n_ts) in cases.items():
            b_ms, b_by = bound(n, n_ts)
            ms, plain_ms = time_ms(torch, kernel, flush), time_ms(torch, plain, flush)
            say(f"time {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
                f"{100 * b_ms / ms:.1f}% of bound)")
            if name in REPLACES:
                rows.append({
                    "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                    "launches": launched[name], "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    # no single PyTorch call computes a lanczos3 / filter-table resample
                    "library_ms": None,
                })

        # the resample at its other phase-3 shapes (tools/resample_fused_probe.py
        # times its tiles and its parts)
        other_ms = {}
        for name, (plan, (ih, iw)) in other_plans.items():
            x_ = on_dev[name]
            moved = ih * iw * 4 + plan.out_h * plan.out_w * 4 + 4 * (plan.out_h * (1 + plan.kv) + plan.out_w * (1 + plan.kh))
            ops = 2 * 4 * (plan.nnz_v * iw + plan.nnz_h * plan.out_h)
            t_bytes, t_ops = moved / mem_bw * 1e3, ops / f32_rate * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ms = time_ms(torch, lambda: rc.resample_fused(x_, plan), flush)
            plain_ms = time_ms(torch, lambda: rc.resample_plain(x_, plan), flush)
            say(f"time resample_fused [{name}] tile {tuple(plan.tiles)}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                f"bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of bound)")
            other_ms[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
        rows[0].update({"other_shapes": other_ms, "tile": list(lz.tiles)})

        # the soft warp at the main path's inputs (the bench pair's flow
        # tiles, K = 4, t = 0.5, tile (8, 128)), and at K = 8 and random motion
        soft_timed = {
            "main": (on_dev["a"], on_dev["b"], tiles, interp.SOFT_WARP_K),
            "k8": (on_dev["a"], on_dev["b"], tiles, interp.WARP_K),
            "noise": (on_dev["n1"], on_dev["n2"], soft_cases[1][4], interp.SOFT_WARP_K),
        }
        soft_ms, soft_floor, soft_wrapper_ms = {}, {}, {}
        soft_regs = ptxas_registers(_build.BUILD_LOGS.get("soft_warp", ""), r"soft_warp_kernel\w*")
        soft_regs = next(iter(soft_regs.values()), "not in this build log")
        for name, (fa, fb, tl, k_soft) in soft_timed.items():
            # the kernel alone on its packed inputs; the wrapper's front end
            # (candidates: a scatter-add, a sort, an argmin) is timed apart
            fin = swc.frame_inputs(tl, 0.5, k_soft, interp.WARP_RANGE)
            packed = swc.pack_inputs(fin)
            moved, ops = soft_warp_work(torch, swc, fa, tl, 0.5, interp.WARP_TILE, k_soft,
                                        interp.WARP_RANGE)
            b_ms, b_by = no_fma_bound(moved, ops)
            ms = time_ms(torch, lambda: swc._launch(fa, fb, fin, packed, interp.WARP_TILE, k_soft),
                         flush)
            wrapper_ms = time_ms(torch, lambda: swc.soft_warp_blend(
                fa, fb, tl, 0.5, interp.WARP_TILE, interp.WARP_RANGE, k_soft), flush)
            plain_ms = time_ms(torch, lambda: swc.soft_warp_plain(fa, fb, fin, interp.WARP_TILE),
                               flush)
            say(f"time soft_warp_blend [{name}] k={k_soft}: {ms:.4f} ms (with its front end "
                f"{wrapper_ms:.4f} ms; plain {plain_ms:.4f} ms; {moved} bytes, {ops} fp32 "
                f"operations: bytes {moved / mem_bw * 1e3:.4f} ms, at the FMA rate "
                f"{ops / f32_rate * 1e3:.4f} ms, instruction floor {ops / (f32_rate / 2) * 1e3:.4f} ms; "
                f"bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of it; ptxas {soft_regs})")
            soft_ms[name] = (ms, plain_ms, b_ms, b_by)
            soft_wrapper_ms[name] = wrapper_ms
            soft_floor[name] = ops / (f32_rate / 2) * 1e3
        (ms, plain_ms, b_ms, b_by), noise = soft_ms["main"], soft_ms["noise"]
        # phase 4g's timing API: flow_soft's warp stage (the wrapper, its front
        # end included, CUDA events a step) against the wrapper timed here
        ratio = timing["flow_soft"]["warp_ms"] / soft_wrapper_ms["main"]
        say(f"timing API flow_soft warp_ms {timing['flow_soft']['warp_ms']:.4f} ms against the soft "
            f"warp wrapper's {soft_wrapper_ms['main']:.4f} ms here: {ratio:.2f}x [{card}]")
        check(0.5 <= ratio <= 2.0, f"flow_soft warp_ms is {ratio:.2f}x the soft warp's time")
        rows.append({
            "name": "soft_warp_blend", "route": "cuda", "source": SOFT_SOURCE,
            "replaces": REPLACES["soft_warp_blend"],
            "launches": flow_counts["soft_warp_blend"] + h4_counts["soft_warp_blend"]
            + j4_counts["soft_warp_blend"] + k4_counts["soft_warp_blend"] + n4_counts["soft_warp_blend"]
            + o4_counts["soft_warp_blend"],
            "launches_flow_soft_ref": h4_counts["soft_warp_blend"], "launches_app": j4_counts["soft_warp_blend"],
            "launches_training": k4_counts["soft_warp_blend"],
            "launches_serving_after_training": n4_counts["soft_warp_blend"],
            "launches_command_lines": o4_counts["soft_warp_blend"],
            "max_abs_err": errs["soft_warp_blend"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "ptxas": soft_regs,
            # no single PyTorch call computes the 4-corner candidate blend
            "library_ms": None,
            # the main path's pair has small, uniform motion (few candidates
            # per cell, the cheap case); the noise pair's random tile motion
            # is the costly one, timed on the same terms
            "inputs": "bench pair and its flow tiles, K=4, t=0.5, tile (8,128)",
            "ms_random_motion": noise[0], "plain_ms_random_motion": noise[1],
            "bound_ms_random_motion": noise[2], "bound_by_random_motion": noise[3],
            # the operations at one instruction each (no FMA forms)
            "instruction_floor_ms": soft_floor["main"],
            "instruction_floor_ms_random_motion": soft_floor["noise"],
        })

        # the FSR kernel at the main path's inputs: the bench frame, quality
        # tier, 1080p→4K, 720p→4K, and a batch of 4 at 1080p→4K
        sharp = ref.FSR_SHARPNESS["quality"]
        fsr_batch_in = torch.stack([on_dev[k] for k in ("a", "b", "n1", "n2")])
        fsr_timed = {
            "1080p": (fc.fsr, on_dev["a"], 2),
            "720p": (fc.fsr, on_dev["720p"], 3),
            "batch4": (fc.fsr_batched, fsr_batch_in, 2),
        }
        fsr_ms, fsr_floor = {}, {}
        fsr_regs = {int(k[-2]): r for k, r in ptxas_registers(
            _build.BUILD_LOGS.get("fsr", ""), r"fsr_kernelILi\dE").items()}
        say(f"ptxas fsr_kernel<S>: {json.dumps(fsr_regs) if fsr_regs else 'not in this build log'}")
        for name, (fn, src, s_) in fsr_timed.items():
            moved, ops = fsr_work(torch, fc, src if src.dim() == 4 else src[None], s_, sharp)
            b_ms, b_by = no_fma_bound(moved, ops)
            ms = time_ms(torch, lambda: fn(src, s_, sharp), flush)
            plain_ms = time_ms(torch, lambda: fc.fsr_plain(src, s_, sharp), flush)
            say(f"time fsr [{name}] s={s_} {tuple(src.shape)}: {ms:.4f} ms (plain {plain_ms:.4f} ms; "
                f"{moved} bytes, {ops} fp32 operations: bytes {moved / mem_bw * 1e3:.4f} ms, at the "
                f"FMA rate {ops / f32_rate * 1e3:.4f} ms, instruction floor "
                f"{ops / (f32_rate / 2) * 1e3:.4f} ms; bound {b_ms:.4f} ms by {b_by}, "
                f"{100 * b_ms / ms:.1f}% of it; ptxas fsr_kernel<{s_}> {fsr_regs.get(s_, 'not in this build log')})")
            fsr_ms[name] = (ms, plain_ms, b_ms, b_by)
            fsr_floor[name] = ops / (f32_rate / 2) * 1e3
        for row, key, inputs in (("fsr", "1080p", "bench frame 1080p→4K, quality"),
                                 ("fsr_batched", "batch4", "a, b, n1, n2 at 1080p→4K, quality")):
            ms, plain_ms, b_ms, b_by = fsr_ms[key]
            rows.append({
                "name": row, "route": "cuda", "source": FSR_SOURCE, "replaces": REPLACES[row],
                "launches": fsr_counts[row] + j4_counts[row], "max_abs_err": errs[row], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                # no single PyTorch call computes EASU + RCAS
                "library_ms": None, "inputs": inputs, "ptxas_by_scale": fsr_regs,
                "instruction_floor_ms": fsr_floor[key],
            })
        ms, plain_ms, b_ms, b_by = fsr_ms["720p"]
        rows[-2].update({"ms_720p": ms, "plain_ms_720p": plain_ms, "bound_ms_720p": b_ms,
                         "instruction_floor_ms_720p": fsr_floor["720p"],
                         "bound_by_720p": b_by})

        # the conv at each shape of the learned path, with the committed
        # weights on trunk-like activations; F.conv2d (bf16, channels-last,
        # bias) on the same inputs is the library's yardstick
        main_shape = f"x2 block 1x{th2}x{tw2} 128->128"
        conv_timed = {
            main_shape: (1, th2, tw2, *served[2].blocks[0][1], False),
            f"x2 tail 1x{th2}x{tw2} 128->256": (1, th2, tw2, *served[2].tail, False),
            f"x2 block {BATCH}x{th2}x{tw2} 128->128": (BATCH, th2, tw2, *served[2].blocks[0][1], False),
            f"x4 block 1x{th4}x{tw4} 128->128": (1, th4, tw4, *served[4].blocks[0][1], False),
            f"x4 tail 1x{th4}x{tw4} 128->1024": (1, th4, tw4, *served[4].tail, False),
        }
        conv_ms, by_variant = {}, {}
        regs = conv_registers(_build.BUILD_LOGS.get("conv3x3", ""))
        for name, (n_, h_, w_, k, b, relu) in conv_timed.items():
            x = act(n_, h_, w_, k.shape[2])
            cin, cout = k.shape[2], k.shape[3]
            moved, ops = conv_work(n_, h_, w_, cin, cout)
            t_bytes, t_ops = moved / mem_bw * 1e3, ops / bf16_rate * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            wc = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            lib_out = torch.nn.functional.conv2d(xc, wc, b, padding=1)
            ker_out = cc.conv3x3(x, k, b, relu, True)
            lib_d = float((lib_out.permute(0, 2, 3, 1).float() - ker_out.float()).abs().max().item())
            ms = time_ms(torch, lambda: cc.conv3x3(x, k, b, relu, True), flush)
            plain_ms = time_ms(torch, lambda: cc.conv3x3_plain(x, k, b, relu, True), flush)
            lib_ms = time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wc, b, padding=1), flush)
            pack_ms = time_ms(torch, lambda: cc.pack_weights(k), flush)
            say(f"time conv3x3 [{name}]: {ms:.4f} ms with the weights' repack ({pack_ms:.4f} ms alone) "
                f"(plain {plain_ms:.4f} ms; F.conv2d {lib_ms:.4f} ms, "
                f"max |F.conv2d - kernel| {lib_d:.4g}; bound {b_ms:.4f} ms by {b_by}: {moved} bytes, "
                f"{ops} bf16 operations; {100 * b_ms / ms:.1f}% of bound, "
                f"{ops / ms / 1e9:.1f} TFLOP/s)")
            conv_ms[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "pack_ms": pack_ms}
            # the kernel's tiles and ring depths: every variant gives the
            # default's bytes (each output is summed in the same order)
            for v in cc.VARIANTS:
                check(torch.equal(cc._launch(x, k, b, relu, True, v), ker_out),
                      f"conv3x3 [{name}]: variant {v} changes the bytes")
                v_ms = time_ms(torch, lambda: cc._launch(x, k, b, relu, True, v), flush)
                tag = f"tile {256 // v[0]}x{v[0]}, {v[1]} stages"
                by_variant[f"{name}, {tag}"] = v_ms
                say(f"  conv3x3 [{name}] {tag}{' (default)' if v == cc.DEFAULT_VARIANT else ''}: "
                    f"{v_ms:.4f} ms, {100 * b_ms / v_ms:.1f}% of bound, {ops / v_ms / 1e9:.1f} TFLOP/s; "
                    f"ptxas {regs.get(v, 'not in this build log')}")
        # the refinement net's four convs (phase 4h's operands) at the kernel's
        # padded widths, each beside F.conv2d at the graph's own widths (the
        # head's 192 RGBA s2d lanes, the tail's 64 phases): time, bound at
        # both widths, plain time and ptxas registers of the template it runs
        relu_regs = {False: regs, True: variant_registers(_build.BUILD_LOGS.get("conv3x3", ""),
                                                          r"conv3x3_kernelILi\d+ELi\d+ELi\d+ELb1ELi1E")}
        refine_conv_ms = {}
        for name, (x, k, b, relu), (ci, co) in zip(REFINE_CONVS, ref_convs,
                                                    ((192, 128), (128, 128), (128, 128), (128, 64))):
            n_, h_, w_ = x.shape[:3]
            cin, cout = k.shape[2], k.shape[3]
            moved, ops = conv_work(n_, h_, w_, cin, cout)
            t_bytes, t_ops = moved / mem_bw * 1e3, ops / bf16_rate * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            r_moved, r_ops = conv_work(n_, h_, w_, ci, co)
            b_real = max(r_moved / mem_bw, r_ops / bf16_rate) * 1e3
            xc = x[..., :ci].permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            wc = k[:, :, :ci, :co].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bc = b[:co].contiguous()
            ms = time_ms(torch, lambda: cc.conv3x3(x, k, b, relu, True), flush)
            plain_ms = time_ms(torch, lambda: cc.conv3x3_plain(x, k, b, relu, True), flush)
            lib_ms = time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wc, bc, padding=1), flush)
            ptxas = relu_regs[relu].get(cc.DEFAULT_VARIANT, "not in this build log")
            key = f"{name} 1x{h_}x{w_} {cin}->{cout}"
            say(f"time conv3x3 refinement [{key}] (real {ci}->{co}) [{card}]: {ms:.4f} ms (plain {plain_ms:.4f} "
                f"ms; F.conv2d at the real widths {lib_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}, at the real "
                f"widths {b_real:.4f} ms; {100 * b_ms / ms:.1f}% of bound; ptxas {ptxas})")
            refine_conv_ms[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms_real_widths": lib_ms,
                                   "bound_ms": b_ms, "bound_by": b_by, "bound_ms_real_widths": b_real,
                                   "real": f"{ci}->{co}", "relu": relu, "ptxas": ptxas}
        main = conv_ms[main_shape]
        rows.append({
            "name": "conv3x3", "route": "cuda", "source": CONV_SOURCE, "replaces": REPLACES["conv3x3"],
            "launches": learned_counts["conv3x3"] + h4_counts["conv3x3"] + j4_counts["conv3x3"]
            + k4_counts["conv3x3"] + m4_counts["conv3x3"] + n4_counts["conv3x3"] + o4_counts["conv3x3"],
            "launches_training": k4_counts["conv3x3"], "launches_sharded_training": m4_counts["conv3x3"],
            "launches_serving_after_training": n4_counts["conv3x3"], "launches_command_lines": o4_counts["conv3x3"],
            "max_abs_err": errs["conv3x3"], **main,
            # phase 4h: the refinement net's convs (4 a refined mid) and their times
            "launches_flow_soft_ref": h4_counts["conv3x3"], "refinement_shapes": refine_conv_ms,
            # phase 4f's rungs (the stride-2, unfused, ESRGANLite and stride-8
            # graphs) at the kernel's padded widths, each padded shape beside
            # F.conv2d at its real widths
            "launches_every_rung": rung_launches, "padded_shapes": list(conv_pairs.values()),
            "inputs": f"a tpu4b2 block conv's committed weights on trunk-like activations, "
                      f"1x{th2}x{tw2}x128 -> 128 (the x2 trunk grid of the input)",
            "max_abs_err_units": "bf16 value, every value within conv_cuda.ulp_tolerance",
            "shapes": conv_ms, "ms_by_variant": by_variant,
            "ptxas_by_variant": {f"tile {256 // v[0]}x{v[0]}, {v[1]} stages": r for v, r in regs.items()},
        })

        # the int8-grid conv at each shape of the "quality" x2 and x4 frames,
        # the committed int8 weights on quantised activations; bounds at the
        # bf16 rate (the loop it runs; s8 wgmma would double the rate), and
        # F.conv2d bf16 on the same values as the library's yardstick
        q2, q4 = served_q[("quality", 2)], served_q[("quality", 4)]
        q_timed = {
            f"x2 head 1x{th2}x{tw2} 128->128": (1, th2, tw2, q2.q_head, False),
            f"x2 block 1x{th2}x{tw2} 128->128": (1, th2, tw2, q2.q_blocks[0][1], False),
            f"x2 tail 1x{th2}x{tw2} 128->256": (1, th2, tw2, q2.q_tail, False),
            f"x2 base 1x{th2 + 2}x{tw2 + 2} 128->256": (1, th2 + 2, tw2 + 2, q2.q_base, False),
            f"x2 block {BATCH}x{th2}x{tw2} 128->128": (BATCH, th2, tw2, q2.q_blocks[0][1], False),
            f"x4 block 1x{th4}x{tw4} 128->128": (1, th4, tw4, q4.q_blocks[0][1], False),
            f"x4 tail 1x{th4}x{tw4} 128->1024": (1, th4, tw4, q4.q_tail, False),
        }
        q_ms = {}
        for name, (n_, h_, w_, c, relu) in q_timed.items():
            xq = cc.quantize_act(act(n_, h_, w_, 128), c.ax)
            cin, cout = c.kq.shape[2], c.kq.shape[3]
            moved, ops = conv_work(n_, h_, w_, cin, cout)
            moved += 4 * cout * (1 + (c.b is not None)) - 2 * cout  # fp32 scale and bias, not a bf16 bias
            t_bytes, t_ops = moved / mem_bw * 1e3, ops / bf16_rate * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            xc = xq.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            wc = c.kq.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            bc = None if c.b is None else c.b.to(torch.bfloat16)
            ms = time_ms(torch, lambda: cc.conv3x3_q(xq, c.kq, c.scale, c.b, relu), flush)
            plain_ms = time_ms(torch, lambda: cc.conv3x3_q_plain(xq, c.kq, c.scale, c.b, relu), flush)
            lib_ms = time_ms(torch, lambda: torch.nn.functional.conv2d(xc, wc, bc, padding=1), flush)
            say(f"time conv3x3_q [{name}]: {ms:.4f} ms with the weights' repack (plain {plain_ms:.4f} ms; "
                f"F.conv2d bf16 {lib_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}: {moved} bytes, {ops} "
                f"operations at the bf16 rate; {100 * b_ms / ms:.1f}% of bound, {ops / ms / 1e9:.1f} TOP/s)")
            q_ms[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                          "bound_by": b_by}
        rows.append({
            "name": "conv3x3_q", "route": "cuda", "source": CONV_SOURCE, "replaces": REPLACES["conv3x3_q"],
            "launches": int8_launches + j4_counts["conv3x3_q"] + k4_counts["conv3x3_q"] + n4_counts["conv3x3_q"]
            + o4_counts["conv3x3_q"],
            "max_abs_err": errs["conv3x3_q"],
            "launches_app": j4_counts["conv3x3_q"], "launches_training": k4_counts["conv3x3_q"],
            "launches_serving_after_training": n4_counts["conv3x3_q"],
            "launches_command_lines": o4_counts["conv3x3_q"],
            **q_ms[f"x2 block 1x{th2}x{tw2} 128->128"],
            "inputs": f"the committed tpu4b2 block0.conv2 int8 weights on quantised activations, "
                      f"1x{th2}x{tw2}x128 -> 128 (the quality x2 trunk grid)",
            "max_abs_err_units": "bf16 value; bit-equal to conv_cuda.conv3x3_q_plain in every case",
            "library_note": "F.conv2d in bf16 on the same integer values; PyTorch has no CUDA int8 conv",
            "shapes": q_ms,
        })

        # the fused trunk at the learned path's inputs (the committed weights
        # on the s2d of the bench frame, round_sum as served), against the
        # same chain as conv3x3 launches and as F.conv2d calls
        trunk_timed = {
            "x2": (s2d_in(2, ("a",)), served[2].trunk_params, 2),
            "x4": (s2d_in(4, ("540p",)), served[4].trunk_params, 3),
            f"x2 N={BATCH}": (s2d_in(2, ("a", "b", "n1", "n2")), served[2].trunk_params, 2),
        }
        trunk_ms = {}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for name, (x, params, blocks) in trunk_timed.items():
            moved, ops = trunk_work(x, params)
            t_bytes, t_ops = moved / mem_bw * 1e3, ops / bf16_rate * 1e3
            b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            # F.conv2d's operands: channels-last NCHW, OIHW weights
            xc = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            convs = [t.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                     if t.dim() == 4 else t for t in params]
            ms = time_ms(torch, lambda: tc.trunk_fused(x, params, blocks, True), flush)
            chain_ms = time_ms(torch, lambda: tc.trunk_chain(cc.conv3x3, x, params, blocks, True), flush)
            lib_ms = time_ms(torch, lambda: tc.trunk_chain(conv2d, xc, convs, blocks), flush)
            plain_ms = time_ms(torch, lambda: tc.trunk_fused_plain(x, params, blocks, True), flush)
            pack_ms = time_ms(torch, lambda: tc.pack_params(params), flush)
            p = tc.plan(*x.shape[:3], blocks, params[0].shape[-1], params[-1].shape[0], sms)
            say(f"time trunk_fused [{name}] {tuple(x.shape)}, {tc.depth(blocks)} layers, grid {p.grid}, "
                f"items per layer {p.items}, {p.flags} ready flags: {ms:.4f} ms with the weights' repack "
                f"({pack_ms:.4f} ms alone) (the chain of {tc.depth(blocks)} conv3x3 launches {chain_ms:.4f} "
                f"ms; of {tc.depth(blocks)} F.conv2d calls {lib_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
                f"{b_ms:.4f} ms by {b_by}: {moved} bytes, {ops} bf16 operations; {100 * b_ms / ms:.1f}% of "
                f"bound, {ops / ms / 1e9:.1f} TFLOP/s)")
            trunk_ms[name] = {"ms": ms, "plain_ms": plain_ms, "conv3x3_chain_ms": chain_ms,
                              "library_chain_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "pack_ms": pack_ms, "grid": p.grid, "ready_flags": p.flags}
        # the kernel's tiles and ring depths: every variant must give the
        # default's bytes (each output is summed in the same order)
        by_variant = {}
        trunk_regs = variant_registers(_build.BUILD_LOGS.get("trunk_fused", ""),
                                       r"trunk_kernelILi\d+ELi\d+ELi\d+ELb1E")
        for name in ("x2", "x4"):
            x, params, blocks = trunk_timed[name]
            planned = tc.trunk_fused(x, params, blocks, True)
            for v in cc.VARIANTS:
                check(torch.equal(tc._launch(x, params, blocks, True, v), planned),
                      f"trunk_fused {name}: variant {v} changes the bytes")
                v_ms = time_ms(torch, lambda: tc._launch(x, params, blocks, True, v), flush)
                tag = f"tile {256 // v[0]}x{v[0]}, {v[1]} stages"
                by_variant[f"{name}, {tag}"] = v_ms
                say(f"  trunk_fused [{name}] {tag}{' (default)' if v == cc.DEFAULT_VARIANT else ''}: "
                    f"{v_ms:.4f} ms, {100 * trunk_ms[name]['bound_ms'] / v_ms:.1f}% of bound; "
                    f"ptxas {trunk_regs.get(v, 'not in this build log')}")
        main = trunk_ms["x2"]
        rows.append({
            "name": "trunk_fused", "route": "cuda", "source": TRUNK_SOURCE, "replaces": REPLACES["trunk_fused"],
            "launches": fused_counts["trunk_fused"], "max_abs_err": errs["trunk_fused"], **main,
            "launches_every_rung": rung_trunk_launches,
            # no single PyTorch call computes the trunk: library_chain_ms is
            # the same chain as 7 (x2) or 9 (x4) F.conv2d calls
            "library_ms": None,
            "inputs": f"the committed tpu4b2 weights on the s2d of the bench frame, 1x{th2}x{tw2}x128 -> "
                      f"256, 2 blocks, round_sum (the x2 serving graph's trunk)",
            "max_abs_err_units": "bf16 value against trunk_fused_plain, every value within "
                                 "trunk_cuda.ulp_tolerance; 0 values differ from the chain of conv3x3 launches",
            "shapes": trunk_ms, "ms_by_variant": by_variant,
            "ptxas_by_variant": {f"tile {256 // v[0]}x{v[0]}, {v[1]} stages": r for v, r in trunk_regs.items()},
        })

        # the two-call resample at the main path's input (the bench frame,
        # 1080p→4K lanczos3): both launches, each alone, and resample_fused
        single4 = single[None]
        mid = rc._launch_vert(single4, 1, lz)
        b_ms, b_by = bound(1, 0)
        inter = 2 * OUT_H * IN_W * 4 * 4  # the fp32 intermediate, written once and read once
        b_inter = (frame_in + frame_out + tables + inter) / mem_bw * 1e3
        ms = time_ms(torch, lambda: rc.resample_twopass(single, lz), flush)
        vert_ms = time_ms(torch, lambda: rc._launch_vert(single4, 1, lz), flush)
        horiz_ms = time_ms(torch, lambda: rc._launch_horiz(mid, 1, lz), flush)
        fused_ms = time_ms(torch, lambda: rc.resample_fused(single, lz), flush)
        plain_ms = time_ms(torch, lambda: rc.resample_plain(single, lz), flush)
        say(f"time resample_twopass lanczos3: {ms:.4f} ms (vertical {vert_ms:.4f}, horizontal "
            f"{horiz_ms:.4f}; resample_fused {fused_ms:.4f}; plain {plain_ms:.4f}; bound {b_ms:.4f} ms by "
            f"{b_by}, {b_inter:.4f} ms with the fp32 intermediate; {100 * b_ms / ms:.1f}% and "
            f"{100 * b_inter / ms:.1f}% of them)")
        rows.append({
            "name": "resample_twopass", "route": "cuda", "source": TWOPASS_SOURCE,
            "replaces": REPLACES["resample_twopass"], "launches": two_counts["resample_twopass"],
            "max_abs_err": errs["resample_twopass"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a filter-table resample
            "library_ms": None, "inputs": "bench frame 1080p→4K lanczos3, two launches a call",
            "ms_vertical": vert_ms, "ms_horizontal": horiz_ms, "resample_fused_ms": fused_ms,
            "bound_ms_with_intermediate": b_inter,
        })

    with Phase("6 trace"):
        # profiler windows over 7 live steps each (host frames in, device
        # frames out): where a step's time goes, and the device's idle share
        from pathlib import Path

        busy = trace_steps(torch, make_fused_pipe(), live_in,
                           Path(_build.BUILD_DIR) / "live_trace.json")
        say("trace: " + json.dumps(busy))
        busy = trace_steps(torch, LivePipeline(up_fn, interp_fn, depth=2), live_in,
                           Path(_build.BUILD_DIR) / "flow_soft_trace.json")
        say("trace flow_soft: " + json.dumps(busy))
        busy = trace_steps(torch, make_yuv_pipe(), live_planes, Path(_build.BUILD_DIR) / "live_yuv420_trace.json")
        say(f"trace live 4:2:0 [{card}]: " + json.dumps(busy))
        pair_dev = (on_dev["a"], on_dev["b"])
        for mode in ("flow", "flow_exact"):
            fn = interp.make_interpolator(IN_H, IN_W, mode)
            busy = trace_calls(torch, lambda p, fn=fn: fn(p[0], p[1], 0.5), pair_dev, 7,
                               Path(_build.BUILD_DIR) / f"{mode}_trace.json")
            say(f"trace {mode} interpolate [{card}]: " + json.dumps(busy))
        busy = trace_steps(torch, LivePipeline(up_fn, ref_interp, depth=2), live_in,
                           Path(_build.BUILD_DIR) / "flow_soft_ref_trace.json")
        say(f"trace flow_soft_ref [{card}]: " + json.dumps(busy))
        busy = trace_steps(torch, make_fsr_pipe(), live_in,
                           Path(_build.BUILD_DIR) / "fsr_flow_soft_trace.json")
        say("trace fsr + flow_soft: " + json.dumps(busy))
        busy = trace_calls(torch, ups[2].upscale_arr, torch.from_numpy(frames["a"]).to(dev), 7,
                           Path(_build.BUILD_DIR) / "learned_x2_trace.json")
        say("trace learned x2 upscale_arr: " + json.dumps(busy))
        busy = trace_calls(torch, fused_ups[2], torch.from_numpy(frames["a"]).to(dev), 7,
                           Path(_build.BUILD_DIR) / "learned_x2_fused_trace.json")
        say("trace learned x2 upscale_arr, trunk_impl=fused: " + json.dumps(busy))
        busy = trace_calls(torch, q_ups[("quality", 2)].upscale_arr, torch.from_numpy(frames["a"]).to(dev),
                           7, Path(_build.BUILD_DIR) / "learned_quality_x2_trace.json")
        say("trace learned quality x2 (int8) upscale_arr: " + json.dumps(busy))
        # phase 4f's rungs: where a call's device time goes on the padded graphs
        for tag in ("ultra x2 1366x768", "ultra 720p->4K", "quality lite x2 1365x767"):
            up, frame = rung_ups[tag]
            busy = trace_calls(torch, up.upscale_arr, torch.from_numpy(frame).to(dev), 7,
                               Path(_build.BUILD_DIR) / f"rung_{tag.split()[1].replace('>', '')}_trace.json")
            say(f"trace every rung [{tag}] upscale_arr [{card}]: " + json.dumps(busy))
        busy = trace_calls(torch, s8_graphs["stride8 fused"][0], src8, 7,
                           Path(_build.BUILD_DIR) / "rung_stride8_trace.json")
        say(f"trace every rung [stride8 fused] [{card}]: " + json.dumps(busy))
        # phase 4k's train steps: where a step's time goes
        for tag, (fn, arg) in train_steps.items():
            busy = trace_calls(torch, fn, arg, 7, Path(_build.BUILD_DIR) / f"{tag}_trace.json")
            say(f"trace {tag} [{card}]: " + json.dumps(busy))

    # phase 4l's launches join every kernel's count of the main path's run
    for row in rows:
        row["launches_mesh"] = l4_counts.get(row["name"], 0)
        row["launches"] += row["launches_mesh"]
    # (a) no phase wrote into the run's root, or under checkpoints/, the
    # committed weights or checkpoints_torch/
    check(not any(Path(run_root.name).iterdir()), "a phase wrote into the run's CKPT_ROOT")
    check(guarded_listing(repo_root, pel.WEIGHTS_DIR) == guarded,
          "the run wrote under checkpoints/, the committed weights or checkpoints_torch/")
    run_root.cleanup()
    say(f"total {time.perf_counter() - T_START:.1f} s")
    say(json.dumps({"kernels": rows}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
