#!/usr/bin/env python3
"""Drive the torch port's frame paths once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Model: Depth-Anything-V2-Large (DINOv2 ViT-L/14, seeded random weights) at
depth resolution 518 on a 4K BGRA capture, through `build_bound` →
`ProgramCache` → `FrameEngine` and the five hand-written CUDA kernels of
`desktop2stereo_tpu_torch`: attention (K2) on all 24 encoder layers, the
both-eyes DIBR pass (K1: the finished Half-SBS frame, or both f32 eyes for
the generic tail), the fast compositor's warp (K3), the single-eye DIBR
(K5) behind `ops.stereo.dibr_render`, and the fused int8 dense (K4) on the
four products of every encoder layer of the int8 model (`quant="int8"`).
The streaming family runs beside it: Video-Depth-Anything-Large (the same
ViT-L encoder, a temporal DPT head carrying a 31-frame window) at 518 on
the same 4K capture, and a real-shape Video-Depth-Anything-Small checkpoint
that the script writes itself goes through the loader and the CLI.  Then
the Depth-Anything-3 family at depth resolution 504 (a 280x504 input, 721
tokens): DA3-LARGE (ViT-L with QK-norm, 2D RoPE and cross-view layers from
layer 8, the DualDPT head), DA3MONO-LARGE (DPT head, sky post), int8
DA3-LARGE and DA3NESTED-GIANT-LARGE (ViT-G with SwiGLU, 40 layers, beside a
ViT-L metric branch), through the same entry points.  Then the classic DPT
family on the same capture: dpt-beit-large-512 at 512 (a 288x512 input, 577
tokens, BEiT-L with a relative-position bias that K2's table entry gathers
in shared memory from each layer's interpolated table, the tables carried
from frame to frame), its int8 form, dpt-large and
dpt-hybrid-midas at 384 (224x384, 337 tokens) and dpt-dinov2-giant-kitti at
518 (ViT-G with SwiGLU, 40 layers, 778 tokens).  Then the last three
families: zoedepth-nyu-kitti at 512 (the BEiT trunk and K2's table entry,
a metric-bins head in f32), DepthPro-Large at 1536 (35 overlapping tiles of
three scales through one DINOv2-L as a batch of 35, beside an image
encoder; K2 at batch 35, K4 at 25 550 rows in its int8 form) and
InfiniDepth-Large at 512 (a DINOv3 trunk with RoPE'd q/k and five prefix
tokens, an f32 conv stem, an implicit MLP head over every pixel).

Phases, each of which raises on failure (non-zero exit, no result line):

1. device: CUDA present; the card's name and power limit from nvidia-smi;
   which of cv2, PIL, PyYAML and the XR client's GL presenters' OpenGL,
   glfw and xr (pyopenxr) the host has (no phase needs the last three);
2. build: nvcc builds the five kernel sources, all at once;
3. kernel parity on the card against the plain PyTorch versions; K2's
   table entry also against its dense-bias entry on the expanded bias, and
   K2's three instances' registers, spills and resident blocks an SM;
4. kernel times beside the plain versions, one PyTorch library call where
   one computes the same function, and the bound (bytes over the memory
   rate, operations over the peak): each callable device-only (10 calls
   captured into a CUDA graph, its replays timed with CUDA events) and eager
   (CUDA events around 10 calls, the host's cost included), median of
   interleaved runs; K2's table entry at BEiT-L's [1, 577, 16, 64] in turns
   with the dense-bias entry, SDPA with the bias as a float mask and the
   unbiased entry;
5. flagship path: Half-SBS (fused tail), FRAMES 4K frames through
   FrameEngine; launch counts (24 attention + one K1 per frame);
6. reference: one small frame through the flagship program on the card
   (bf16) and on the CPU in f32 (plain versions), compared;
7. generic tail, high quality: Full-SBS, FRAMES frames; K1 eyes once a frame;
8. generic tail, fast quality: Half-SBS, FRAMES frames; K3 twice a frame;
9. mode cycling: all nine display modes twice, switched live after every
   delivered frame; each output shape and K1 once a frame (none in Depth);
10. `dibr_render` at 4K, both eyes: K5 twice;
11. reference for the generic tail (Full-SBS high, Half-SBS fast);
12. int8 against bf16: both models from one seed on one model input, raw
    output correlation and max relative error;
13. int8 flagship path: Half-SBS (fused tail), FRAMES 4K frames; launches
    24 attention + 96 K4 (4 per layer) + one K1 per frame;
14. int8 reference: one small frame through the int8 program on the card
    (bf16) and on the CPU in f32 (plain versions), compared;
15. traced frames: one flagship and one int8 4K frame as FrameEngine runs
    them (`_dispatch`: the upload through the pinned staging ring, the
    program, the copies back into pinned memory; `_finish`: the wait on the
    `done` event), and beside them one flagship frame through the harness's
    pageable path (a numpy frame into ProgramCache, `.cpu()` downloads),
    under torch.profiler with CUDA activity: device ms by kernel and by group
    (K1-K5, GEMM, convolution, elementwise, copies, other), the device's busy
    ms and its idle share of the frame;
16. the port's CLI on the card, `desktop2stereo_tpu_torch.cli.run` in this
    process: (a) a settings file written by the port's `save_settings`
    (DA-V2-Large, depth resolution 518, processing resolution 2160,
    Half-SBS, Set FPS 1000), a 4K synthetic source, the null sink, once
    with `--frames FRAMES` and once for CLI_SECONDS (`--duration`): exit 0,
    the sink's frames and shape, exactly 24 K2 and one K1 launches per frame
    in the warm-up and in the run; frames/s from the timed run; (b)
    letterboxed 4K BGRA frames (a 2.39:1 picture between 16:9 bars) written
    into the port's ShmFrameRing, `--source shm --crop auto`: the crop rect
    found on the card equals the plain CPU path's on the same frame, and the
    output has the cropped size;
17. VDA flagship: Video-Depth-Anything-Large at 518, Half-SBS (fused tail),
    FRAMES 4K frames through FrameEngine: launches 24 attention + one K1
    per frame and no other kernel, the eight caches' shapes after the run,
    stage ms (pre / model / tail) and frames/s, the four temporal modules'
    ms (CUDA events around each), peak device memory, and one traced frame
    as in phase 15, the temporal modules' kernels totalled inside their
    `record_function` ranges where the trace holds GPU-side ranges;
18. VDA reference: three small frames streamed (first, step, step) through
    the VDA program on the card (bf16) and on the CPU (f32, plain
    versions), each held to phase 6's thresholds;
19. int8 VDA: INT8_VDA_FRAMES 4K frames, launches 24 attention + 96 K4 +
    one K1 per frame;
20. checkpoint: a real-shape Video-Depth-Anything-Small checkpoint in the
    original naming (seeded, F16) written by the port's own writer as one
    file and as three shards with an index: `build_bound(...,
    checkpoint=path)` on the card holds exactly the CPU load's tensors,
    and `cli.run` with `--model Video-Depth-Anything-Small --checkpoint
    <index>` runs FRAMES 4K frames into the null sink, exit 0, 12 K2 and
    one K1 launches per frame;
21-26. the DA3 family (`da3_phases`), each path with exact launches; phase
    23 holds DA3-LARGE and DA3MONO-LARGE card bf16 against CPU f32 on a
    small frame, and DA3MONO-LARGE's raw depth (over the non-sky pixels)
    and sky mask as well, since the sky fill covers most of its frame on
    random weights;
27. remote topology, Half-SBS: `cli.run --source tcp:0 --sink xr --port 0
    --xr-no-input` on the phase-16 settings file for REMOTE_SECONDS, fed by a
    capture agent in a thread (the port's TcpFrameSender connection
    streaming seeded 4K BGRA frames over loopback, each packed beforehand:
    zlib-compressed noisy synthetic frames, the worst case for zlib, then
    zlib-compressed desktop-like frames, then the synthetic ones raw) and
    polled by the port's FrameNetClient in a process of its own: exit 0; 24
    K2 and one K1 a frame; the client's frames [2160, 3840, 3] u8 with depth
    [294, 518] f32 in [0, 1], each (rgb, depth) pair one the engine pushed
    into the sink (CRC-32 of the rgb and of the zu16 depth on both sides);
    the source's received / delivered / dropped add up and every delivered
    frame is one the agent sent (CRC-32 taken at the source, before the
    program); ingest fps, engine and client frames/s, bytes a frame, the
    wire ratio and the host's zlib decode ms of each frame set;
28. the same with `--display-mode Mono`, raw: the generic tail, one K1
    (eyes mode: both eyes in one pass, the left one kept) a frame;
29. `--sink rtmp --out rtmp://127.0.0.1/live/d2s` with a fake ffmpeg first on
    PATH: its argv equals the run's sink's `ffmpeg_argv` (held against the
    JAX sink's by the CPU tests) and its stdin took exactly the pushed
    Half-SBS frames' bytes;
30. the web control panel (`service.control.serve(port=0)` in a thread):
    POST /start spawns the port's CLI on the card (synthetic source, null
    sink), /status and /logs are polled until its stats line shows frames,
    POST /stop ends it with exit 0 within the grace period;
31. dpt-beit-large-512 at 512, Half-SBS (fused tail), FRAMES 4K frames
    through FrameEngine: 24 K2 a frame, all through the table entry
    (counted apart, `attention_relpos`; the dense-bias entry,
    `attention_bias`, none), one K1, stage ms, peak memory, one traced
    frame; the carry: ProgramCache runs `first` once a stream and output
    size (`compute_rel_pos_tables` called once over frames that include a
    live display-mode switch, once more for another capture size), the 24
    tables [16, 2208] bf16 and their MB, and the ms of building them; the
    dense-bias API (`multi_head_attention(..., bias=)`, the JAX package's)
    on the 24 expanded tables against the table entry, 24 launches each;
    one small frame (first) and a second (step), card bf16 against CPU f32
    at phase 6's thresholds;
32. dpt-large at 384: CLASSIC_FRAMES frames, 24 K2 and one K1 a frame (no
    biased launch), and its small-frame reference;
33. dpt-hybrid-midas at 384: CLASSIC_FRAMES frames, 12 K2 and one K1, and
    its reference;
34. dpt-dinov2-giant-kitti at 518: CLASSIC_FRAMES frames, 40 K2 and one K1,
    its reference, and the two giant names built on the host's CPU with
    `quant="none"` (no QuantLinear) and `quant="int8"` (160), each run on a
    small input;
35. int8 dpt-beit-large-512: correlation with the bf16 model on one model
    input, then CLASSIC_FRAMES frames: 24 K2 (table entry), 144 K4 (query, key,
    value, proj, fc1, fc2 of every layer) and one K1 a frame;
36. `cli.run --model dpt-beit-large-512` on a settings file at depth
    resolution 512, 4K synthetic source, null sink, FRAMES frames: exit 0,
    24 K2 (table entry) and one K1 a frame in the warm-up and the run;
37. a real-shape dpt-beit-base-384 checkpoint in the HF naming (seeded,
    F16) written by the port's writer: `build_bound(..., checkpoint=path)`
    on the card holds exactly the CPU load's tensors, and `cli.run --model
    dpt-beit-base-384 --checkpoint <file>` runs FRAMES 4K frames into the
    null sink (12 K2 through the table entry and one K1 a frame);
38. zoedepth-nyu-kitti at 512 (BEiT-L/16 on a 24² window, the classic
    decoder as its relative head, the f32 metric-bins head with the patch
    transformer's domain vote), CLASSIC_FRAMES 4K frames: 24 K2 a frame,
    all through the table entry, and one K1; K2's table entry on the
    model's own tables at the 18x32 and 14x24 grids against its plain
    version; the carry's 24 tables and MB, the metric head f32 under the
    bf16 trunk; one traced frame; one small frame, card bf16 against CPU
    f32; `cli.run
    --model zoedepth-nyu --depth-res 384` (the 14x24 grid) for
    LAST_CLI_SECONDS, 24 table-entry K2 and one K1 a frame in the warm-up
    and the run;
39. DepthPro-Large at 1536: K2 at [35, 730, 16, 64] (qkv views and
    contiguous) against its plain version and timed beside SDPA and its
    bound; CLASSIC_FRAMES 4K frames with 48 K2 (24 at batch 35, 24 for the
    image encoder) and one K1 a frame, the EMA carry's shape after the run,
    one traced frame; one small frame, card bf16 against the same model in
    f32 on the CPU (a full 1536² forward there); K4 exact at the int8 towers' shapes (25 550 and 730
    rows, the four ViT-L products) and timed at 25 550 rows beside
    `torch._int_mm` and its bound; the int8 model (192 K4 a frame) against
    bf16 on one model input, and CLASSIC_FRAMES int8 frames;
40. InfiniDepth-Large at 512 (a DINOv3 ViT-L with RoPE'd q/k, 581 tokens):
    K2 at [1, 581, 16, 64] with fresh RoPE'd q/k and a v view against its
    plain version; CLASSIC_FRAMES 4K frames, 24 K2 and one K1 a frame, the
    conv stem f32, one traced frame; one small frame, card bf16 against CPU
    f32; the int8
    model (96 K4 a frame) against bf16, and CLASSIC_FRAMES int8 frames;
    `cli.run --model InfiniDepth-SmallPlus --depth-res 512` for
    LAST_CLI_SECONDS, 12 K2 and one K1 a frame;
41. K1 over a stream axis of STREAMS = 2 frames (one launch, the grid's z
    axis): at the 4K eye (Half-SBS) and the 4K frame (eyes), bit-equal to
    two one-frame launches, timed beside them, the plain version and the
    bound (twice one frame's);
42. DA-V2-Large @518 on one 4K stream through FrameEngine, then two streams
    (seeds 0 and 7) round-robin through MultiStreamEngine, MULTI_FRAMES a
    stream: frames/s a stream and in total, exactly 24 K2 and one K1 a
    frame, peak memory;
43. the same two streams through BatchedStreamEngine (a BatchedProgramCache
    of S = 2): frames/s, steps and the step ms, exactly 24 K2 (at batch 2)
    and one K1 (over the stream axis) a step; the batched generic tails,
    MULTI_STEPS steps each: Full-SBS high (one K1 eyes over the stream axis
    a step), Half-SBS fast (K3 twice a row); each row of a batched step on
    small frames is held against the card's single-stream program and the
    CPU f32 run at phase 6's thresholds in phases 11 (bf16), 14 (int8), 18
    (VDA) and 31 (BEiT);
44. batched int8: each row's raw depth against bf16 at batch 2 (K4 at 1 556
    rows; correlation >= INT8_MIN_CORR), MULTI_STEPS frames a stream with
    24 K2, 96 K4 and one K1 a step;
45. batched VDA-Large, MULTI_STEPS steps with the second row stale on every
    other one: its caches bit-equal across each stale step and moved on
    each fresh one, the carry (2 x 8 caches) MB, peak memory, 24 K2 and one
    K1 a step;
46. batched dpt-beit-large-512, the same pattern: no error on a stale row,
    the carry one set of 24 tables for the batch, never rebuilt, 24 K2
    through the table entry and one K1 a step;
47. `cli.run --streams 2` and `--streams 2 --batched` for MULTI_CLI_SECONDS
    on the phase-16 settings file (null sinks): frames/s a stream, one K1
    and 24 K2 a frame run (round-robin) or a step (batched) in the warm-up
    and the run; `cli.run --profile-dir` for PROFILE_CLI_SECONDS: its Chrome
    trace (taken on the engine's compute thread) holds K1's and K2's kernels
    and the d2s.preprocess / d2s.model / d2s.tail ranges;
48. `python -m desktop2stereo_tpu_torch.tools.aot_compile` for 2160x3840 in
    a process of its own with an empty build directory (D2S_BUILD_DIR):
    the five sources' nvcc seconds and the warm seconds; `depth_visualize`
    on assets/golden.png on the card;
49. the XR client's render (`tools/xr_client.py:render_stereo`) in this
    process on a seeded 4K RGB frame and a [294, 518] depth: Full-SBS and
    Half-SBS at roll 0 launch exactly two K5 (one an eye) and no other
    kernel, roll 0.1 none; each card frame in uint8 against the same call
    with device "cpu" (at most 1 LSB on at most 0.1% of values); CUDA-event
    ms (median of XR_TIMED) of the upload, the depth upsample, the warp of
    both eyes, the arrangement and the download, and the render frames/s
    (numpy frame in, numpy SBS out);
50. the client end to end: the port's CLI in a process of its own on the
    phase-16 settings with `--display-mode Mono --sink xr --port 0` (the
    2D frame and its depth, as a headset user serves them), and
    `xr_client.main(["--present", "png", "--frames", XR_E2E_FRAMES, ...])`
    in this process: exit 0, exactly 2 K5 a frame, the PNGs [2160, 7680, 3],
    frames/s first to last PNG (the PNG encode included); then `--theater
    on --theater-size 480 270` for XR_THEATER_FRAMES frames, its compose ms;
51. `xr_client.main(["--test", "--present", "png", "--theater", "on", ...])`
    on the card: the white 1280x720 frame with zero depth, so every warped
    eye rounds to 255 (zero parallax), 2 K5 a frame, the screen white in
    each eye, and the first frame within 1 LSB of the same run with
    `--device cpu`;
52-56. the multi-GPU path (`desktop2stereo_tpu_torch/parallel/`): first,
    in this process, K2 at one rank's [1, 778, 8, 64] and K4 at one rank's
    four ViT-L shapes (qkv and fc1 column shards, proj and fc2 row shards in
    int32 mode) against their plain versions (K4 exactly) and timed beside
    them, their library call and their bound; then one spawned group of
    TP = 2 ranks (NCCL with a card each where two cards are visible, else
    both ranks on card 0 over gloo; a line says which), which takes the
    weights phases 5, 12 and 34 drew through shared host memory. Each rank:
    54. DP = 2 (a 2 x 1 mesh in the same world): two seeded model inputs,
    its row bit-equal to the one-frame model's, 24 K2; 52. TP = 2, bf16,
    DA-V2-Large @518 (294x518, 778 tokens): exactly 24 K2 at [1, 778, 8,
    64], one held against `attention_ref` on the layer-0 activations, depth
    against the unsharded model on the same card at phase 6's mean bound
    (over the reference's range), the step ms (CUDA events, median of
    PARALLEL_STEP_RUNS), weights and peak against the unsharded model's; 56.
    the all-reduce of one row-parallel partial [1, 778, 1024] f32 (two a
    layer), labelled with the backend; 53. TP = 2, int8: 24 K2 and 96 K4
    (48 column-, 48 row-parallel calls), each of the four shard shapes exact
    against `quant_dense_ref` on the layer-0 activations, depth against the
    unsharded int8 model (bit-equal, or the difference printed); 55. TP = 2
    + SP, dpt-dinov2-giant-kitti @518 (ViT-G SwiGLU, 40 layers, 12 heads a
    rank): 40 K2, depth against the unsharded model, weights and peak
    against the unsharded model's;
57. K2's f32 body (`--fp32`, the converter's gate): its three entries
    (`d2s_attention_f32_fwd`, `_bias_f32_`, `_relpos_f32_`) against their
    f32 plain versions within F32_ATTN_MAX_ABS at the flagship's [1, 778, 16,
    64] (qkv views and contiguous), BEiT-L's [1, 577, 16, 64] with its 18x32
    table (f32 and bf16 tables, the table entry bit-equal to the dense entry
    on the expansion), DepthPro's [35, 730, 16, 64] and ragged shapes;
    registers, spills and resident blocks; times beside the plain version,
    f32 SDPA (with the bias as a float mask) and the bound at the f32
    CUDA-core peak;
58. `--fp32` on the card: `cli.run` on the phase-16 settings with `--fp32`
    for FP32_CLI_SECONDS (weights and compute f32, exactly 24 f32 K2 and one
    K1 a frame, no bf16 K2, in the warm-up and the run; frames/s); then
    DA-V2-Large @518 (one frame) and dpt-beit-large-512 @512 (first and
    step, the f32 table entry): the f32 CPU models of phases 6 and 31
    copied to the card, run on the same 216x384 frames and held against
    those phases' CPU outputs to the FP32_REF_* bounds (tighter than phase
    6's); the dense-bias API on the f32
    BEiT's 24 carried tables, bit-equal to the table entry;
59. the checkpoint tool (`desktop2stereo_tpu_torch/tools/convert.py`):
    `port_depth`, the gate's pipeline, on the synthetic 1080p scene for the
    two f32 models of phase 58, card against CPU, rel_err_max below
    CONVERTER_MAX_REL, 24 f32 K2 each; `--model Video-Depth-Anything-Small
    --verify --skip-download` in a process of its own with HF_HOME on a hub
    layout holding phase 20's checkpoint (exit 0, the parameter count of the
    converted tree); the jobs that need `transformers`: where the host lacks
    it, `--make-random-snapshot`, `--verify-depth` and `--model-path` each
    exit non-zero naming it; where it has it, the gate on a DA-V2-Small
    random snapshot at 126 on the card must pass.  Every subprocess runs
    with HF_HUB_OFFLINE=1 and `--skip-download`: nothing reaches a network.

A line near the end gives the wall seconds of each phase group.

Every phase that drives a path sets the kernels' launch counts to 0 just
before it and reads them just after; launches recorded into a CUDA graph
(phase 4) are not counted.

The line before the last is a JSON object describing the kernels; the last
line is {"ok": true, "device": {...}}.  A JSON report with every number also
goes to chiprun_out/chip_smoke.json, and the traces to
chiprun_out/trace_flagship.json, trace_int8.json,
trace_flagship_pageable.json, trace_vda.json, trace_da3.json and
trace_da3_full_outputs.json, trace_beit.json, trace_zoedepth.json,
trace_depthpro.json and trace_infinidepth.json.  Each kernels entry's
`launches_by_path` holds each path's count from its own run (the
flagship's, DA3-LARGE's, the remote Half-SBS run's and the classic DPT
paths'; K1 eyes: generic high and remote Mono; int8: the int8 paths; K5:
`dibr_render` in phase 10 and the XR client's runs in phases 49-51), and
`launches` their sum; K1's stream axis has entries of its own,
`dibr_pair_half_s2` and `dibr_pair_eyes_s2` (the batched paths' launches,
timed at S = 2 in phase 41), and the round-robin path's launches join the
one-frame entries.  K2's two biased entry points have entries of their
own: `attention_relpos` (the table entry, launched by the BEiT paths),
timed at BEiT-L's [1, 577, 16, 64] with an 18x32 grid's [16, 2208] bf16
table, and `attention_bias` (the dense entry, launched by the dense-bias
API in phase 31), timed there with the [16, 577, 577] bf16 bias; both
beside SDPA with the dense bias as a float `attn_mask`.  The multi-GPU
path's launches (one rank's, phases 52-55) have entries of their own,
timed at one rank's shapes: `attention_tp` (K2 at [1, 778, 8, 64]; its
launches: TP bf16, TP int8, the giant's TP + SP at [1, 778, 12, 64], DP),
`quant_matmul_tp_col` (timed at fc1's column shard) and
`quant_matmul_tp_row` (fc2's row shard, int32 out).  K2's f32 body has
three: `attention_f32` (timed at [1, 778, 16, 64]; launches: the `--fp32`
CLI run, the f32 reference, the converter's DA-V2-Large), `attention_bias_f32`
(timed at BEiT-L's shape with an f32 [16, 577, 577] bias; launched by the f32
dense-bias API) and `attention_relpos_f32` (timed there with the f32 18x32
table; launches: the f32 BEiT reference, the dense-bias API's comparison, the
converter's BEiT).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FLAGSHIP_MODEL = "Depth-Anything-V2-Large"
FRAME_SHAPE = (2160, 3840, 4)        # 4K BGRA capture, output height 2160
EYE = (FRAME_SHAPE[0], FRAME_SHAPE[1] // 2)
FULL = FRAME_SHAPE[:2]               # the generic tail's eyes: full width
ATTN_SHAPE = (1, 778, 16, 64)        # ViT-L/14 at 294x518: 21*37 + 1 tokens
BIAS_ATTN_SHAPE = (1, 577, 16, 64)   # BEiT-L/16 at 288x512: 18*32 + 1 tokens
# the table entry's parity grids: BEiT-L @512 (16:9 and 4:3 captures), the 32x32
# pretraining window, and ragged N = 2, 19, 64, 129 about the 64/128-row tiles
RELPOS_GRIDS = ((18, 32), (24, 32), (32, 32), (1, 1), (3, 6), (7, 9), (8, 16))
FRAMES = 30
TIMED_RUNS = 25
SEED = 0
IPD, STRENGTH = 0.064, 2.0

# K1 / K5 (u8 after quantisation): at most 1 LSB off, on at most 0.1% of values
# (one value where a frame holds fewer than 1000)
DIBR_MAX_LSB = 1
DIBR_MAX_SHARE = 1e-3
# the DIBR kernels' edge shapes: widths below one 4-pixel group, one more than
# a 512-pixel segment, 8K full width; heights 1-4 (the ±2-row taps clamp)
DIBR_EDGES = ((1, 1), (2, 2), (3, 3), (4, 513), (3, 7680))
# K2 (bf16 in/out, f32 accumulation) vs the f32 plain version on unit-normal
# inputs: bf16 output rounding (2^-9 relative) plus bf16 probabilities
ATTN_MAX_ABS = 2e-2
# K3 (f32 on 0..255 values, the same px on both sides): lerp rounding only
WARP_MAX_ABS = 1e-3
# K4: the kernel rounds at the plain version's points, so none; a mismatch
# is a rounding point to find
QUANT_MAX_ABS = 0.0
# int8 encoder against the bf16 one (same seed, same model input): JAX on
# the CPU gives correlation 0.991 for this model at 126x224
INT8_MIN_CORR = 0.98
# ViT-L's four encoder products at M = 778 tokens: (name, K, F)
VIT_L_DENSE = (("qkv", 1024, 3072), ("proj", 1024, 1024), ("fc1", 1024, 4096),
               ("fc2", 4096, 1024))
# Whole path, card bf16 vs CPU f32 on one small frame.  bf16 drift through
# 24 layers and the percentile normalisation moves depth by a few hundredths
# and turns into warp shifts at depth edges, so the SBS bound is on the mean
# and on the share of pixels far off, not on the maximum.
REF_DEPTH_MEAN_ABS = 0.03
REF_SBS_MEAN_LSB = 3.0
REF_SBS_SHARE_OVER_32 = 0.03

# The card's peaks for the bound: HBM bytes/s and dense operations/s (bf16
# tensor cores; f32 outside them; int8 tensor cores), NVIDIA's data sheets.
# The SXM part unless the name says otherwise.
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12, 1513e12),
         "H100 NVL": (3.9e12, 835e12, 60e12, 1670e12),
         "H100": (3.35e12, 989e12, 67e12, 1979e12)}
# f32 operations per output pixel of the elementwise kernels, counted from
# their sources with every sweep tap taken (the most the data can need):
# K3 lerp per channel 4 + floor/frac/clamps 2; K5 24 taps x 12 + 2 vertical
# taps x 6 + warp 14 + blend 9 + centre 10; K1 the shared taps once, warp
# and blend per eye, the shaping and falloff once.  K1 and K5 stop their
# sweeps early and take fewer; their bytes bound them either way
OPS_PER_PX = {"warp3": 14, "dibr_fill": 330, "dibr_pair": 360}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def host_packages():
    """Version (or "absent") of what some sources and sinks import when they
    are made: cv2 (mjpeg, viewer, video, window), PIL (png, image), PyYAML,
    which the port does not use, and the XR client's GL presenters' OpenGL
    (PyOpenGL), glfw and xr (pyopenxr), which no phase needs."""
    import importlib

    out = {}
    for name in ("cv2", "PIL", "yaml", "OpenGL", "glfw", "xr"):
        try:
            out[name] = getattr(importlib.import_module(name), "__version__", "present")
        except Exception:  # ImportError, or a binding that fails to load
            out[name] = "absent"
    return out


def peaks(name: str):
    return next((v for k, v in PEAKS.items() if k in name), PEAKS["H100"])


def bound_ms(name: str, nbytes: float, ops: float, unit: str):
    """(least ms the card could take, "bytes" or "operations"); `unit` is
    the peak the operations run at: "bf16", "f32" or "int8"."""
    bw, bf16, f32, int8 = peaks(name)
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / {"bf16": bf16, "f32": f32, "int8": int8}[unit] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def config(programs, mode="Half-SBS", quality="high", model=FLAGSHIP_MODEL, res=518):
    """bench.py's flagship settings (Settings defaults otherwise), with the
    model-resolution depth a null sink takes; `res` the depth resolution."""
    return programs.ProgramConfig(
        model_name=model, depth_resolution=res, output_height=2160,
        display_mode=mode, ipd=IPD, depth_strength=STRENGTH, convergence=0.0,
        foreground_scale=0.0, aa_strength=2.0, ema_alpha=0.9,
        temporal_smooth=True, quality=quality, emit_depth="model")


def synthetic_frames(np, count: int, h: int, w: int, seed: int):
    """Seeded BGRA frames: a moving smooth scene plus noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for t in range(count):
        base = 128 + 90 * np.sin((xx + 40 * t) / 97.0) * np.cos(yy / 71.0)
        rgb = base[..., None] + np.array([0.0, 25.0, -25.0], np.float32)
        rgb = rgb + rng.normal(0, 10, (h, w, 3)).astype(np.float32)
        bgra = np.empty((h, w, 4), np.uint8)
        bgra[..., :3] = np.clip(rgb[..., ::-1], 0, 255)
        bgra[..., 3] = 255
        frames.append(bgra)
    return frames


def time_calls(torch, fns, runs: int = TIMED_RUNS, reps: int = 10, warm: int = 3,
               graph: bool = False):
    """Median ms per call of each callable in `fns` (name → fn), `runs`
    samples each, the callables in turns whose order flips every sample.
    Eager: CUDA events around `reps` back-to-back calls, so where a call's
    host work (Python, allocation, launch) outlasts its device work the
    figure holds the host's cost.  graph=True: the `reps` calls are captured
    once into a CUDA graph (after warm-up on a side stream) and the events
    bracket a replay, so the figure is device time only."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            for fn in fns.values():
                fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    runners = {}
    for name, fn in fns.items():
        if graph:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(reps):
                    fn()
            g.replay()
            runners[name] = g.replay
        else:
            runners[name] = lambda fn=fn: [fn() for _ in range(reps)]
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    items = list(runners.items())
    for i in range(runs):
        for name, run in (items if i % 2 == 0 else items[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    return {name: statistics.median(v) for name, v in times.items()}


def time_both(torch, fns):
    """Graph-timed (device-only) ms per call of each callable, with the
    eager (host-inclusive) figures under "eager"."""
    graphed = time_calls(torch, fns, graph=True)
    torch.cuda.empty_cache()
    return dict(graphed, eager=time_calls(torch, fns))


def log_timing(name, tm, card) -> None:
    """One `time_both` result beside its plain version, library call and bound."""
    ea = tm["eager"]
    lib = (f", library {tm['library']:.4f} (eager {ea['library']:.4f})"
           if tm.get("library") is not None else "")
    if "dense" in tm:
        lib += (f" (SDPA with the dense bias as a float mask); the dense entry "
                f"{tm['dense']:.4f} (eager {ea['dense']:.4f}), the unbiased entry "
                f"{tm['unbiased']:.4f} (eager {ea['unbiased']:.4f})")
    if "kernel_int32" in tm:
        lib += (f" (torch._int_mm on int8 x; K4's int32 mode with row_scale 1 "
                f"{tm['kernel_int32']:.4f}), bf16 F.linear {tm['linear_bf16']:.4f} "
                f"(eager {ea['linear_bf16']:.4f})")
    log(f"[time] {name} {tm['shape']}: kernel {tm['kernel']:.4f} ms (eager "
        f"{ea['kernel']:.4f}), plain {tm['plain']:.4f} (eager {ea['plain']:.4f}){lib}, "
        f"bound {tm['bound'][0]:.4f} ({tm['bound'][1]}) ms per call (device-only: CUDA "
        f"graphs of 10 calls; eager: events around 10 calls, host included; median of "
        f"{TIMED_RUNS}; {card})")


# Kernel groups of a traced frame: the port's kernels by their function
# names, then library kernels by name; memcpy and memset activity is "copies"
TRACE_GROUPS = (
    ("K1 dibr_pair", r"\bdibr_pair_kernel\b"),
    ("K2 attention", r"\battention_fwd_kernel(_relpos)?\b"),
    ("K3 warp", r"\bwarp_kernel\b"),
    ("K4 quant_matmul", r"\b(quantize_rows_kernel|quant_gemm_kernel)\b"),
    ("K5 dibr_fill", r"\bdibr_fill_kernel\b"),
    ("convolution", r"conv|fprop|dgrad|wgrad|cudnn|implicit"),
    ("gemm", r"gemm|nvjet|xmma|cutlass|cublas|gemv"),
    ("elementwise", r"elementwise|vectorized|unrolled|catarray|copy_kernel|fill"),
)


def summarize_trace(events, spans=()):
    """Device ms by kernel name and by group, busy ms and idle share of the
    span from the host's "frame" range to the end of the last device
    activity, from a chrome trace's events.  For each host range named in
    `spans` (a `record_function` label), the device ms of the kernels inside
    its GPU-side ranges (the trace's gpu_user_annotation events), or None
    where the trace holds none."""
    import re

    frame = next(e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == "frame")
    start = float(frame["ts"])
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and "dur" in e and float(e["ts"]) >= start]
    if not dev:
        raise AssertionError("the trace holds no device activity: no kernel ran on the card")
    end = max([start + float(frame["dur"])] + [float(e["ts"]) + float(e["dur"]) for e in dev])
    busy, reach = 0.0, start
    for e in sorted(dev, key=lambda e: float(e["ts"])):
        a, b = max(float(e["ts"]), reach), float(e["ts"]) + float(e["dur"])
        if b > a:
            busy += b - a
            reach = b
    groups, names = {}, {}
    for e in dev:
        name = e["name"]
        if e["cat"] != "kernel":
            group = "copies"
        else:
            group = next((g for g, pat in TRACE_GROUPS if re.search(pat, name, re.I)), "other")
        for table, key in ((groups, group), (names, name)):
            slot = table.setdefault(key, {"ms": 0.0, "calls": 0})
            slot["ms"] += float(e["dur"]) / 1e3
            slot["calls"] += 1
    top = dict(sorted(names.items(), key=lambda kv: -kv[1]["ms"])[:20])
    inside = {}
    for label in spans:
        ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                  if e.get("cat") == "gpu_user_annotation" and e.get("name") == label]
        kernels = [e for e in dev if e["cat"] == "kernel"
                   and any(a <= float(e["ts"]) < b for a, b in ranges)]
        inside[label] = ({"ms": sum(float(e["dur"]) for e in kernels) / 1e3,
                          "calls": len(kernels), "ranges": len(ranges)} if ranges else None)
    return {"span_ms": (end - start) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (end - start), "groups": groups, "top_kernels": top,
            "spans": inside}


def dense_inputs(np, torch, dev, M, K, F, dtype, with_bias, seed):
    """K4's inputs: activations whose rows span four decades, an int8 weight
    [F, K] with f32 per-feature scales of a lecun-normal weight's size, and
    a bias."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)) * 10.0 ** rng.uniform(-2, 2, (M, 1))
    x = torch.from_numpy(x.astype(np.float32)).to(dev, dtype)
    wq = torch.from_numpy(rng.integers(-127, 128, (F, K)).astype(np.int8)).to(dev)
    scale = torch.from_numpy((rng.random(F) + 1.0).astype(np.float32) / (127 * K ** 0.5)).to(dev)
    bias = (torch.from_numpy(rng.standard_normal(F).astype(np.float32) * 0.1).to(dev)
            if with_bias else None)
    return x, wq, scale, bias


def u8_diff(torch, got, want):
    """(max LSB, share of values that differ) after u8 quantisation."""
    q = lambda x: (x + 0.5).clamp(0.0, 255.0).to(torch.uint8).int()  # noqa: E731
    diff = (q(got) - q(want)).abs()
    return int(diff.max().item()), (diff > 0).float().mean().item()


def edgy_depth(np, rng, h, w):
    """Runs of random depth levels plus noise: many depth edges."""
    runs = np.repeat(rng.random((h, w // 3 + 1)), 3, axis=1)[:, :w]
    return np.clip(runs + rng.normal(0, 0.01, (h, w)), 0, 1).astype(np.float32)


def check_u8(name, lsb, share, extra="", n=None):
    ok = lsb <= DIBR_MAX_LSB and (share <= DIBR_MAX_SHARE
                                  or n is not None and n < 1000 and share * n <= 1)
    log(f"[parity] {name}: max {lsb} LSB (tol {DIBR_MAX_LSB}), differing {share:.2e} "
        f"(tol {DIBR_MAX_SHARE:.0e}){extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")


class SaturatingSource:
    """Hands the engine a new frame as soon as it has taken the previous one:
    the compute stage always has its next frame, and latest-wins drops none."""

    def __init__(self, frames, count: int) -> None:
        self.frames = frames
        self.count = count
        self.sent = 0
        self.engine = None

    def grab(self):
        if self.sent == self.count:
            return None
        if not self.engine.raw_box.wait_taken(timeout=120.0):
            raise TimeoutError("the engine took no frame for 120 s")
        frame = self.frames[self.sent % len(self.frames)]
        self.sent += 1
        return frame


class CheckingNullSink:
    """Discards frames after checking them (and the model-res depth)."""

    wants_depth = True

    def __init__(self, shape) -> None:
        self.shape = shape
        self.count = 0

    def check(self, sbs, depth, shape) -> None:
        import numpy as np

        if sbs.shape != shape or sbs.dtype != np.uint8:
            raise AssertionError(f"frame {sbs.dtype} {sbs.shape}, want uint8 {shape}")
        if depth is None or not np.isfinite(depth).all():
            raise AssertionError("depth missing or not finite")

    def push(self, sbs, depth, stats) -> None:
        self.check(sbs, depth, self.shape)
        self.count += 1


class LockstepSource:
    """Hands out the next frame only after the sink delivered the previous
    one, so a switch made in the sink applies to exactly the next frame."""

    def __init__(self, frames, count: int) -> None:
        import threading

        self.frames = frames
        self.count = count
        self.sent = 0
        self.delivered = threading.Event()
        self.delivered.set()

    def grab(self):
        if self.sent == self.count:
            return None
        if not self.delivered.wait(timeout=120.0):
            raise TimeoutError("the sink delivered no frame for 120 s")
        self.delivered.clear()
        frame = self.frames[self.sent % len(self.frames)]
        self.sent += 1
        return frame


class CyclingSink(CheckingNullSink):
    """Checks each frame against its mode's shape and the K1 launches so far,
    then requests the next display mode."""

    def __init__(self, program, source, k1, modes, shapes) -> None:
        super().__init__(None)
        self.program, self.source, self.k1 = program, source, k1
        self.modes, self.shapes = modes, shapes
        self.k1_want = 0

    def push(self, sbs, depth, stats) -> None:
        mode = self.modes[self.count % len(self.modes)]
        self.check(sbs, depth, self.shapes[mode])
        self.k1_want += mode != "Depth"
        if self.k1.launches != self.k1_want:
            raise AssertionError(f"{mode}: {self.k1.launches} K1 launches after "
                                 f"{self.count + 1} frames, want {self.k1_want}")
        self.count += 1
        self.program.cycle_display_mode()
        self.source.delivered.set()


def zero_counts(counters) -> None:
    for k in counters.values():
        k.launches = 0


def read_counts(counters) -> dict:
    """Each kernel's launches, and K2's dense-bias and table entries' and its
    three f32 entries' apart (also counted under "attention")."""
    counts = {n: k.launches for n, k in counters.items()}
    entries = counters["attention"].entry_launches
    counts["attention_bias"] = entries.get("d2s_attention_bias_fwd", 0)
    counts["attention_relpos"] = entries.get("d2s_attention_relpos_fwd", 0)
    counts["attention_f32"] = entries.get("d2s_attention_f32_fwd", 0)
    counts["attention_bias_f32"] = entries.get("d2s_attention_bias_f32_fwd", 0)
    counts["attention_relpos_f32"] = entries.get("d2s_attention_relpos_f32_fwd", 0)
    return counts


def run_engine(FrameEngine, program, source, sink, counters, frames):
    """Counts to 0, frames through FrameEngine, counts read: (fps, counts, stats)."""
    engine = FrameEngine(source, program, sink, target_fps=0.0)
    source.engine = engine
    zero_counts(counters)
    t0 = time.perf_counter()
    stats = engine.run(duration=600.0)
    wall_s = time.perf_counter() - t0
    counts = read_counts(counters)
    if engine.frames != frames or sink.count + engine.out_box.dropped != frames:
        raise AssertionError(f"{engine.frames} frames run, {sink.count} delivered, "
                             f"{engine.out_box.dropped} superseded; want {frames} run")
    return frames / wall_s, counts, stats


def stage_times(torch, programs, program, frame_np, cfg, spec, dev, generic: bool):
    """Per-stage device ms at the stage seams (CUDA events, host launch gaps
    included), median of TIMED_RUNS frames after 3 warm ones.  A stateful
    model carries its state: frame 0 runs `first`, the timed frames `step`."""
    p = program.program
    state = programs.init_state(*programs.ema_shape(cfg, spec, *FRAME_SHAPE[:2]), device=dev)
    names = ("pre", "model", "post", "stereo") if generic else ("pre", "model", "tail")
    times = {n: [] for n in names + ("step",)}
    with torch.inference_mode():
        frame = torch.from_numpy(frame_np).to(dev)
        for i in range(TIMED_RUNS + 3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            rgb, model_in = p.preprocess(frame)
            ev[1].record()
            raw, carry = p.model_stage(model_in, state.model)
            ev[2].record()
            if generic:
                small = p.post_stage(raw, state.ema_depth)
                ev[3].record()
                out, _ = p.stereo_stage(rgb, small)
            else:
                out, _, small = p.post_stereo_stage(raw, state.ema_depth, rgb)
            ev[-1].record()
            ev[-1].synchronize()
            state = programs.FrameState(ema_depth=small, model=carry)
            if i >= 3:
                for j, n in enumerate(names):
                    times[n].append(ev[j].elapsed_time(ev[j + 1]))
                times["step"].append(ev[0].elapsed_time(ev[-1]))
    return {k: statistics.median(v) for k, v in times.items()}, out


def ref_stats(torch, name, got, want, cpu_s=0.0):
    """Phase 6's comparison of the card's (sbs, depth) `got` with the
    reference `want`, both on the host: errors and whether they pass."""
    (sbs_c, depth_c), (sbs_r, depth_r) = got, want
    if not torch.isfinite(depth_c).all() or sbs_c.shape != sbs_r.shape:
        raise AssertionError(f"reference {name}: non-finite depth or shape mismatch")
    d_err = (depth_c.float() - depth_r.float()).abs()
    s_err = (sbs_c.int() - sbs_r.int()).abs().float()
    ref = {"depth_mean_abs": d_err.mean().item(), "depth_max_abs": d_err.max().item(),
           "sbs_mean_lsb": s_err.mean().item(), "sbs_max_lsb": s_err.max().item(),
           "sbs_share_over_32": (s_err > 32).float().mean().item(), "cpu_s": cpu_s,
           "shape": list(sbs_c.shape)}
    ref["ok"] = (ref["depth_mean_abs"] <= REF_DEPTH_MEAN_ABS
                 and ref["sbs_mean_lsb"] <= REF_SBS_MEAN_LSB
                 and ref["sbs_share_over_32"] <= REF_SBS_SHARE_OVER_32)
    return ref


def reference_check(torch, name, card_prog, cpu_prog, frame, keep=None):
    """Phase 6's check of one frame; the CPU's output is appended to `keep`
    where one is given."""
    got = tuple(t.cpu() for t in card_prog(frame))
    t0 = time.perf_counter()
    want = cpu_prog(frame)
    if keep is not None:
        keep.append(want)
    ref = ref_stats(torch, name, got, want, time.perf_counter() - t0)
    sbs_c, ok, cpu_s = got[0], ref["ok"], ref["cpu_s"]
    log(f"[reference] {name}, 216x384 frame, card bf16 vs CPU f32: depth mean "
        f"{ref['depth_mean_abs']:.4f} (tol {REF_DEPTH_MEAN_ABS}) max {ref['depth_max_abs']:.4f}; "
        f"sbs {tuple(sbs_c.shape)} mean {ref['sbs_mean_lsb']:.3f} LSB (tol {REF_SBS_MEAN_LSB}) "
        f"max {ref['sbs_max_lsb']:.0f}, >32 LSB {ref['sbs_share_over_32']:.2e} "
        f"(tol {REF_SBS_SHARE_OVER_32}); the CPU run {cpu_s:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"reference {name}: the card's output disagrees with the CPU f32 run")
    return ref


class CliRun:
    """One in-process `cli.run(argv)`, keeping what it made: the source,
    program and sink from `make_components`, and the FrameEngine with the
    launch counts when it started (after the warm-up and the preload of the
    shape probe).  The counts are set to 0 just before the run."""

    def __init__(self, counters, on_parts=None) -> None:
        self.counters = counters
        self.on_parts = on_parts  # called with the parts as soon as they are made
        self.parts = None
        self.engine = None
        self.warm_counts = None

    def __call__(self, argv):
        from desktop2stereo_tpu_torch import cli
        from desktop2stereo_tpu_torch.pipeline import engine as engine_mod

        run = self
        make_components, engine_cls = cli.make_components, engine_mod.FrameEngine

        def recording_make_components(args, settings):
            run.parts = make_components(args, settings)
            if run.on_parts is not None:
                run.on_parts(run.parts)
            return run.parts

        class RecordingEngine(engine_cls):
            def start(self) -> None:
                run.engine = self
                run.warm_counts = read_counts(run.counters)
                self.started_at = time.perf_counter()
                super().start()

        cli.make_components, engine_mod.FrameEngine = recording_make_components, RecordingEngine
        zero_counts(self.counters)
        try:
            rc = cli.run(argv)
        finally:
            cli.make_components, engine_mod.FrameEngine = make_components, engine_cls
        self.wall_s = time.perf_counter() - self.engine.started_at
        self.counts = read_counts(self.counters)
        return rc

    def check_launches(self, name, layers, warm_frames, biased=False, f32=False):
        """`layers` K2 (all of them through the table entry where `biased`,
        none through the dense-bias entry; all through the f32 entries and
        none through the bf16 ones with `f32`) and one K1 per frame run, none
        of the others, in the warm-up (`warm_frames` frames) and in the run."""
        eng = self.engine
        run_counts = {n: self.counts[n] - self.warm_counts[n] for n in self.counts}
        want = {n: 0 for n in self.counts}
        want.update(attention=layers, dibr_pair=1)
        k2 = {(True, False): "attention_relpos", (True, True): "attention_relpos_f32",
              (False, True): "attention_f32"}.get((biased, f32))
        if k2:
            want[k2] = layers
        log(f"[cli] {name}: launches in the warm-up " + ", ".join(
            f"{n} {c} (want {want[n] * warm_frames})" for n, c in self.warm_counts.items())
            + f"; in the run of {eng.frames} frames " + ", ".join(
            f"{n} {c} (want {want[n] * eng.frames})" for n, c in run_counts.items()))
        if any(self.warm_counts[n] != want[n] * warm_frames
               or run_counts[n] != want[n] * eng.frames for n in want):
            raise AssertionError(f"cli {name}: a kernel was not launched as the path needs")
        return {"warmup": self.warm_counts, "run": run_counts}


# ProgramCache.warmup runs each stage once, then 2 whole frames
CLI_WARM_FRAMES = 3
CLI_SECONDS = 10.0


def cli_settings(out_dir, model=FLAGSHIP_MODEL, res=518, name="cli_settings.yaml"):
    """A settings file (the flagship's unless told otherwise), written by the
    port's save_settings."""
    from desktop2stereo_tpu_torch.core.config import Settings, load_settings, save_settings

    path = out_dir / name
    if path.exists():
        path.unlink()
    # Set FPS high enough that the capture never waits
    settings = Settings(model=model, depth_resolution=res, output_resolution=2160,
                        display_mode="Half-SBS", fps=1000.0)
    save_settings(settings, path)
    if load_settings(path) != settings:
        raise AssertionError("the settings file does not read back to what was written")
    return path


def cli_flagship(np, counters, layers, card, out_dir):
    """16a. `cli.run` at full width: DA-V2-Large @518, a 4K synthetic
    source, Half-SBS, the null sink.  `--frames FRAMES` as a user would ask
    for a short run: the source outpaces the engine and latest-wins
    supersedes most of its frames, so the frames/s comes from a second run
    of CLI_SECONDS (`--duration`, an endless source)."""
    base = ["--settings", str(cli_settings(out_dir)), "--source", "synthetic",
            "--size", f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--sink", "null",
            "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"]
    want_shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    out = {}
    for name, extra in (("frames", ["--frames", str(FRAMES)]),
                        ("timed", ["--duration", str(CLI_SECONDS)])):
        run = CliRun(counters)
        rc = run(base + extra)
        _, program, sink, _ = run.parts
        eng = run.engine
        # a run the CLI ends (frame count, duration) may stop the sink before
        # it takes the last frame; every other frame is delivered or superseded
        if (rc != 0 or sink.frames < 1 or sink.last_shape != want_shape
                or not eng.frames - 1 <= sink.frames + eng.out_box.dropped <= eng.frames):
            raise AssertionError(f"cli flagship {name}: rc {rc}, {eng.frames} frames run, "
                                 f"{sink.frames} delivered of shape {sink.last_shape}, "
                                 f"want {want_shape}")
        launches = run.check_launches(f"flagship {name}", layers, CLI_WARM_FRAMES)
        final = eng.stats_final()
        fps = eng.frames / run.wall_s
        log(f"[cli] flagship {name}: python -m desktop2stereo_tpu_torch.cli --settings "
            f"(DA-V2-Large @518, Half-SBS, Set FPS 1000) --source synthetic --size "
            f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} --sink null {' '.join(extra)}: exit {rc}; "
            f"{eng.frames} frames run ({eng.dropped} superseded), {sink.frames} delivered "
            f"{sink.last_shape}; {fps:.2f} frames/s (frames run over {run.wall_s:.2f} s from "
            f"the engine's start to the CLI's return), the CLI's fps counter {final.fps:.2f} "
            f"(1% low {final.fps_1pct_low:.2f}); {card}")
        out[name] = dict(rc=rc, frames_run=eng.frames, delivered=sink.frames,
                         dropped=eng.dropped, fps=fps, fps_counter=final.fps,
                         fps_1pct_low=final.fps_1pct_low, wall_s=run.wall_s,
                         launches=launches)
    return out


def letterboxed_frame(np, seed):
    """A 4K BGRA frame holding a 2.39:1 picture between black 16:9 bars."""
    h, w = FRAME_SHAPE[:2]
    pic_h = int(round(w / 2.39))
    top = (h - pic_h) // 2
    frame = np.zeros((h, w, 4), np.uint8)
    frame[..., 3] = 255
    frame[top:top + pic_h] = synthetic_frames(np, 1, pic_h, w, seed)[0]
    return frame


def cli_crop(np, torch, counters, layers, card, out_dir):
    """16b. Letterboxed 4K frames through the port's shm ring into `cli.run`
    with `--crop auto`: the crop found on the card equals the plain CPU
    path's on the same frame, and the output has the cropped size."""
    import os
    import threading

    from desktop2stereo_tpu_torch.native import ShmFrameRing
    from desktop2stereo_tpu_torch.ops.normalize import process_frame_size
    from desktop2stereo_tpu_torch.pipeline.crop import BGR, apply_crop, crop_from_stats, crop_stats

    frame = letterboxed_frame(np, SEED + 2)
    ring_bytes = 3 * frame.nbytes
    vfs = os.statvfs("/dev/shm")
    if vfs.f_bavail * vfs.f_frsize < ring_bytes + (1 << 20):
        raise AssertionError(f"/dev/shm holds {vfs.f_bavail * vfs.f_frsize} free bytes; the "
                             f"ring of three 4K BGRA slots needs {ring_bytes}")
    name = f"/d2s_smoke_{os.getpid()}"
    ring = ShmFrameRing(name, max_bytes=frame.nbytes, slots=3)
    stop = threading.Event()

    def produce():  # a capture agent writing the same picture, ~200 frames/s
        while not stop.is_set():
            ring.write(frame)
            time.sleep(0.005)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    run = CliRun(counters)
    try:
        rc = run(["--settings", str(cli_settings(out_dir)), "--source", "shm", "--input", name,
                  "--crop", "auto", "--sink", "null", "--frames", str(FRAMES),
                  "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"])
    finally:
        stop.set()
        producer.join()
        ring.close()
    _, program, sink, _ = run.parts
    eng = run.engine
    h, w = FRAME_SHAPE[:2]
    card_stats = crop_stats(torch.from_numpy(frame).cuda(), BGR).cpu().numpy()
    cpu_stats = crop_stats(torch.from_numpy(frame), BGR).numpy()
    card_rect = program.controllers[0].crop
    cpu_rect = crop_from_stats(cpu_stats, w, h)
    ch, cw = apply_crop(torch.empty(h, w), cpu_rect).shape
    want_shape = (*process_frame_size(ch, cw, 2160), 3)
    ok = (rc == 0 and card_rect == cpu_rect and cpu_rect[3] < 1.0 and sink.frames >= 1
          and sink.last_shape == want_shape)
    log(f"[cli] crop: {FRAMES} letterboxed {h}x{w} BGRA frames (2.39:1 picture) through the "
        f"port's ShmFrameRing, --crop auto: exit {rc}; crop stats card {card_stats.tolist()}, "
        f"CPU {cpu_stats.tolist()}; rect on the card {card_rect}, plain CPU path {cpu_rect}; "
        f"{eng.frames} frames run, {sink.frames} delivered {sink.last_shape} (want "
        f"{want_shape}) {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("cli crop: the card's crop or the output size is off")
    launches = run.check_launches("crop", layers, CLI_WARM_FRAMES)
    return dict(rc=rc, card_rect=list(card_rect), cpu_rect=list(cpu_rect),
                card_stats=card_stats.tolist(), cpu_stats=cpu_stats.tolist(),
                frames_run=eng.frames, delivered=sink.frames, shape=list(sink.last_shape),
                launches=launches)


# ---- 27-30: the remote topology ---------------------------------------------

REMOTE_DISTINCT = 4      # seeded 4K frames the capture agent cycles through
REMOTE_SECONDS = 6.0     # each remote CLI run (`--duration`)
RTMP_URL = "rtmp://127.0.0.1/live/d2s"
MODEL_SHAPE = (294, 518)  # DA-V2-Large's input for a 4K capture at 518
CONTROL_S = 600.0         # bound on the control panel's worker reaching its first stats line


# The XR client, in a process of its own as on the headset's workstation:
# polls the xr sink (raw rgb, zu16 depth) until the stop file exists, then
# prints what it received as one JSON line
XR_CLIENT = r"""
import json, os, sys, time, zlib
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, sys.argv[1])
from desktop2stereo_tpu_torch.xr.net import FrameNetClient, _encode_depth
client = FrameNetClient(port=int(sys.argv[2]))
pool = ThreadPoolExecutor(2)  # the rgb's CRC-32 off the poll loop (each packet is a fresh array)
seen, t0, t1 = [], None, None
try:
    while not os.path.exists(sys.argv[3]):
        p = client.poll(timeout=0.5)
        if p is None:
            continue
        t1 = time.perf_counter()
        t0 = t0 or t1
        d = p.depth
        zd = _encode_depth(d)
        seen.append([list(p.rgb.shape), str(p.rgb.dtype), p.rgb.nbytes, len(zd),
                     list(d.shape), str(d.dtype), float(d.min()), float(d.max()),
                     pool.submit(zlib.crc32, p.rgb), zlib.crc32(zd)])
except (ConnectionError, OSError):
    pass  # the sink went away at the end of the run
client.close()
pool.shutdown()
for s in seen:
    s[8] = s[8].result()
print(json.dumps({"seen": seen, "s": (t1 - t0) if seen else 0.0}))
"""


class RemoteFeed:
    """A capture agent and an XR client around one in-process `cli.run`.

    Once the CLI has made its parts, a thread connects the port's
    TcpFrameSender to the tcp source's bound port and streams REMOTE_DISTINCT
    seeded 4K BGRA frames in a cycle, each packed once (`_pack`: raw, or
    zlib-compressed as `--compress zlib` does) and written as fast as
    loopback takes it, until the run ends; the agent's compression is left
    out of the rate (a desktop does it on its own cores).  The source's
    `grab` is wrapped to hand each delivered frame to a thread that takes
    its CRC-32 (the frames are fresh arrays the program only reads) for the
    check after the run.  With an xr sink, XR_CLIENT runs in a subprocess,
    and the sink's `push` is wrapped to take the CRC-32 of each pushed SBS
    frame and of its depth as the wire carries it (`_encode_depth`) before
    the sink has it, so each frame the client received can be matched to a
    pushed one."""

    def __init__(self, packets, client: bool, out_dir):
        import queue
        import threading

        self.packets, self.client = packets, client
        self.stop = threading.Event()
        self.stop_file = out_dir / "xr_client.stop"
        self.crcs, self.ingest_fps, self.client_out = [], [], None
        self.pushed, self.push_crc_s = set(), 0.0
        self.sent, self.sent_s = 0, 0.0
        self.source = self.sink = self.proc = None
        self.threads = []
        self._delivered = queue.SimpleQueue()

    def on_parts(self, parts):
        import threading

        self.source, _, self.sink, _ = parts
        grab = self.source.grab

        def kept_grab():
            frame = grab()
            if frame is not None:
                self._delivered.put(frame)
                self.ingest_fps.append(self.source.stats()["ingest_fps"])
            return frame

        self.source.grab = kept_grab
        if self.client:
            self._hash_pushes()
        self.threads = [threading.Thread(target=t, daemon=True)
                        for t in (self._hasher, self._agent)]
        for t in self.threads:
            t.start()
        if self.client:
            if self.stop_file.exists():
                self.stop_file.unlink()
            self.proc = subprocess.Popen(
                [sys.executable, "-c", XR_CLIENT, str(ROOT), str(self.sink.port),
                 str(self.stop_file)], stdout=subprocess.PIPE, text=True)

    def _hash_pushes(self):
        import zlib

        import numpy as np

        from desktop2stereo_tpu_torch.xr.net import _encode_depth

        push = self.sink.push

        def hashed_push(sbs, depth, stats):
            t0 = time.perf_counter()
            self.pushed.add((zlib.crc32(np.ascontiguousarray(sbs)),
                             zlib.crc32(_encode_depth(depth))))
            self.push_crc_s += time.perf_counter() - t0
            push(sbs, depth, stats)

        self.sink.push = hashed_push

    def _hasher(self):
        import zlib

        while True:
            frame = self._delivered.get()
            if frame is None:
                return
            self.crcs.append(zlib.crc32(frame))  # releases the GIL on a frame

    def _agent(self):
        from desktop2stereo_tpu_torch.sources.net import TcpFrameSender

        snd = TcpFrameSender("127.0.0.1", self.source.port)
        t0 = time.perf_counter()
        try:
            while not self.stop.is_set():
                snd.sock.sendall(self.packets[self.sent % len(self.packets)])
                self.sent += 1
                self.sent_s = time.perf_counter() - t0
        except OSError:
            pass  # the source closed at the end of the run
        finally:
            snd.close()

    def finish(self):
        self.stop.set()
        self._delivered.put(None)
        if self.proc is not None:
            self.stop_file.touch()
            out, _ = self.proc.communicate(timeout=60)
            if self.proc.returncode != 0:
                raise AssertionError(f"the XR client exited {self.proc.returncode}")
            self.client_out = json.loads(out.strip().splitlines()[-1])
        for t in self.threads:
            t.join(60)
            if t.is_alive():
                raise AssertionError(f"remote feed: thread {t.name} did not end")


def remote_packets(frames, compress: str):
    """The agent's frames, each packed once as TcpFrameSender sends it (in
    parallel: zlib releases the GIL), their CRC-32s, and the ms it took."""
    import socket
    import zlib

    from desktop2stereo_tpu_torch.sources.net import TcpFrameSender

    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    snd = TcpFrameSender("127.0.0.1", lst.getsockname()[1], compress=compress)
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(frames)) as pool:
            packets = list(pool.map(snd._pack, frames))
        pack_ms = (time.perf_counter() - t0) * 1e3
    finally:
        snd.close()
        lst.close()
    return packets, {zlib.crc32(f) for f in frames}, pack_ms


def zlib_decode_ms(packet) -> float:
    """The host's ms to inflate one zlib 4K frame at the source (median of 5)."""
    from desktop2stereo_tpu_torch.sources.net import _FRAME_HDR, _decode_payload

    _, w, h, c, flags, _ = _FRAME_HDR.unpack(packet[:_FRAME_HDR.size])
    payload = packet[_FRAME_HDR.size:]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        _decode_payload(payload, w, h, c, flags)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def remote_run(counters, layers, card, out_dir, name, packets, crcs, sink_argv,
               mode="Half-SBS", client=True, on_parts=None):
    """One `cli.run --source tcp:0` on the flagship settings file for
    REMOTE_SECONDS (`--duration`: a steady stream, as phase 16a times the
    CLI), fed by a RemoteFeed; checks the exit code, the launches (24 K2 and
    one K1 a frame), the source's stats, and that every delivered frame is
    one the agent sent (by CRC-32).  Returns (measurements, CliRun,
    RemoteFeed)."""
    feed = RemoteFeed(packets, client, out_dir)

    def parts(p):
        feed.on_parts(p)
        if on_parts is not None:
            on_parts(p)

    run = CliRun(counters, on_parts=parts)
    try:
        rc = run(["--settings", str(cli_settings(out_dir)), "--source", "tcp:0",
                  "--display-mode", mode, "--duration", str(REMOTE_SECONDS), *sink_argv,
                  "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"])
    finally:
        feed.finish()
    eng = run.engine
    st = feed.source.stats()
    bad = sum(c not in crcs for c in feed.crcs)
    fps = eng.frames / run.wall_s
    readings = [v for v in feed.ingest_fps if v > 0]
    out = dict(rc=rc, frames_run=eng.frames, dropped=eng.dropped, engine_fps=fps,
               sent=feed.sent, received=st["frames_received"],
               delivered=st["frames_delivered"], net_dropped=st["frames_dropped"],
               decode_errors=st["decode_errors"], not_sent=bad,
               ingest_fps=statistics.median(readings) if readings else 0.0,
               received_per_s=st["frames_received"] / feed.sent_s if feed.sent_s else 0.0,
               wall_s=run.wall_s)
    ok = (rc == 0 and st["decode_errors"] == 0 and bad == 0
          and st["frames_delivered"] == len(feed.crcs)
          and st["frames_received"] == st["frames_delivered"] + st["frames_dropped"]
          and st["frames_delivered"] <= st["frames_received"] <= feed.sent
          and 1 <= eng.frames <= st["frames_delivered"])
    log(f"[remote] {name}: cli --source tcp:0 --display-mode {mode} {' '.join(sink_argv)} "
        f"--duration {REMOTE_SECONDS}: exit {rc}; the agent sent {feed.sent} 4K BGRA frames in "
        f"{feed.sent_s:.2f} s; the source received {st['frames_received']}, delivered "
        f"{st['frames_delivered']}, dropped {st['frames_dropped']}, decode errors "
        f"{st['decode_errors']}; {bad} delivered frames not among the sent ones (CRC-32); "
        f"ingest fps {out['ingest_fps']:.2f} (the source's stats, median of its readings at "
        f"each delivery), {out['received_per_s']:.2f} frames received a second of sending; "
        f"engine {eng.frames} frames run ({eng.dropped} superseded), {fps:.2f} frames/s over "
        f"{run.wall_s:.2f} s; {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError(f"remote {name}: exit code, ingest stats or frames off")
    out["launches"] = run.check_launches(f"remote {name}", layers, CLI_WARM_FRAMES)
    return out, run, feed


def remote_client_check(feed, name, want_rgb, card):
    """The XR client's frames: the frame's shape in u8, the depth at the
    model's resolution in f32 within [0, 1], and each (rgb, depth) pair, by
    CRC-32, one the engine pushed into the sink; its frames/s and bytes a
    frame."""
    seen, secs = feed.client_out["seen"], feed.client_out["s"]
    not_pushed = sum((p[8], p[9]) not in feed.pushed for p in seen)
    ok = bool(seen) and not_pushed == 0 and all(
        tuple(rgb_shape) == want_rgb and rgb_dtype == "uint8" and tuple(d_shape) == MODEL_SHAPE
        and d_dtype == "float32" and 0.0 <= d_min <= d_max <= 1.0
        for rgb_shape, rgb_dtype, _, _, d_shape, d_dtype, d_min, d_max, _, _ in seen)
    crc_ms = feed.push_crc_s * 1e3 / len(feed.pushed) if feed.pushed else 0.0
    fps = (len(seen) - 1) / secs if len(seen) > 1 and secs else 0.0
    rgb_b = statistics.median(p[2] for p in seen) if seen else 0
    dep_b = statistics.median(p[3] for p in seen) if seen else 0
    lo = min((p[6] for p in seen), default=None)
    hi = max((p[7] for p in seen), default=None)
    log(f"[remote] {name} XR client (the port's FrameNetClient in a process of its own, raw "
        f"rgb, zu16 depth): {len(seen)} frames, {fps:.2f} frames/s (first to last), rgb "
        f"{rgb_b} bytes and depth {dep_b} bytes a frame (median); the first frame "
        f"{seen[0][:2] if seen else None}, depth {seen[0][4:6] if seen else None} in "
        f"[{lo}, {hi}] (want {list(want_rgb)} uint8, depth {list(MODEL_SHAPE)} float32 in "
        f"[0, 1]); {not_pushed} of its frames not among the {len(feed.pushed)} pushed ones "
        f"(CRC-32 of the rgb and the zu16 depth; {crc_ms:.2f} ms a push on the sink thread) "
        f"{'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError(f"remote {name}: the XR client's frames are off")
    return dict(frames=len(seen), fps=fps, rgb_bytes=rgb_b, depth_bytes=dep_b,
                not_pushed=not_pushed, pushed=len(feed.pushed), push_crc_ms=crc_ms)


def desktop_frames(np, count: int, h: int, w: int, seed: int):
    """Seeded BGRA frames that look like a desktop: a flat wallpaper and
    taskbar, windows with flat title bars and borders, and lines of text
    drawn from a seeded 64-glyph font (8x14 cells), light and dark themes;
    each frame moves the windows and scrolls their text."""
    rng = np.random.default_rng(seed)
    glyphs = (rng.random((64, 14, 8)) < 0.3)
    glyphs[:, :2] = glyphs[:, 12:] = glyphs[:, :, 7] = False  # line gap and letter gap
    glyphs[0] = False  # the space
    lines, cols = 60, 200
    text = rng.integers(1, 64, (lines + count * 2, cols))
    text[rng.random(text.shape) < 0.18] = 0
    windows = [((0.08, 0.06, 0.42, 0.55), (235, 235, 235), (30, 30, 30), (190, 120, 40)),
               ((0.30, 0.38, 0.48, 0.50), (35, 30, 30), (200, 210, 210), (90, 90, 90)),
               ((0.58, 0.10, 0.38, 0.42), (250, 250, 250), (60, 60, 60), (140, 80, 200))]
    frames = []
    for t in range(count):
        bgra = np.empty((h, w, 4), np.uint8)
        bgra[...] = (120, 80, 30, 255)  # wallpaper
        bgra[h - h // 27:] = (40, 40, 40, 255)  # taskbar
        for i, ((y, x, hh, ww), bg, fg, bar) in enumerate(windows):
            y0, x0 = int(y * h) + 23 * t * (i - 1), int(x * w) + 41 * t * (1 - i)
            wh, ww = int(hh * h), int(ww * w)
            y0, x0 = min(max(y0, 0), h - wh - 1), min(max(x0, 0), w - ww - 1)
            bgra[y0:y0 + wh, x0:x0 + ww, :3] = (128, 128, 128)  # border
            bgra[y0 + 1:y0 + 31, x0 + 1:x0 + ww - 1, :3] = bar
            area = bgra[y0 + 31:y0 + wh - 1, x0 + 1:x0 + ww - 1, :3]
            area[...] = bg
            rows, cs = min(area.shape[0] // 14, lines), min(area.shape[1] // 8 - 2, cols)
            ink = glyphs[text[2 * t + i:2 * t + i + rows, :cs]]  # [rows, cs, 14, 8]
            ink = ink.transpose(0, 2, 1, 3).reshape(rows * 14, cs * 8)
            area[:rows * 14, 8:8 + cs * 8][ink] = fg
        frames.append(bgra)
    return frames


def remote_phases(np, counters, layers, card, out_dir):
    """27-29: the remote topology through `cli.run` on the flagship
    settings file (DA-V2-Large @518), fed over loopback by a capture agent:
    zlib on the noisy synthetic frames (the worst case for zlib) and on
    desktop-like ones, then raw."""
    want_rgb = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    raw_bytes = FRAME_SHAPE[0] * FRAME_SHAPE[1] * 4
    out = {}
    xr = ["--sink", "xr", "--port", "0", "--xr-no-input"]
    frames = synthetic_frames(np, REMOTE_DISTINCT, *FRAME_SHAPE[:2], seed=SEED + 27)
    desktop = desktop_frames(np, REMOTE_DISTINCT, *FRAME_SHAPE[:2], seed=SEED + 27)
    runs = (("xr_zlib", frames, "zlib"),
            ("xr_zlib_desktop", desktop, "zlib"), ("xr_raw", frames, "none"))
    for name, feed_frames, compress in runs:  # 27: Half-SBS into the xr sink
        packets, crcs, pack_ms = remote_packets(feed_frames, compress)
        res, _, feed = remote_run(counters, layers, card, out_dir, name, packets, crcs, xr)
        res["client"] = remote_client_check(feed, name, want_rgb, card)
        res["wire_bytes"] = statistics.median(len(p) for p in packets)
        res["pack_ms"] = pack_ms / len(packets)
        if compress == "zlib":
            res["zlib_decode_ms"] = zlib_decode_ms(packets[0])
            log(f"[remote] {name}: {res['wire_bytes']} wire bytes a 4K BGRA frame "
                f"({res['wire_bytes'] / raw_bytes:.4f} of raw); compress {res['pack_ms']:.1f} ms "
                f"a frame (the agent's side, {len(packets)} in parallel), decode at the source "
                f"{res['zlib_decode_ms']:.1f} ms a frame (median of 5); {card}")
        out[name] = res
        del feed

    # 28: Mono, raw: the generic tail, whose stereo stage computes both eyes
    # in one K1 pass (eyes mode) and keeps the left one
    res, _, feed = remote_run(counters, layers, card, out_dir, "xr_mono", packets, crcs, xr,
                              mode="Mono")
    res["client"] = remote_client_check(feed, "xr_mono", want_rgb, card)
    out["xr_mono"] = res
    del feed

    # 29: the rtmp sink into a fake ffmpeg first on PATH
    out["rtmp"] = rtmp_phase(counters, layers, card, out_dir, packets, crcs)
    return out


def rtmp_phase(counters, layers, card, out_dir, packets, crcs):
    """29. The rtmp sink into a fake ffmpeg first on PATH: its argv and the
    bytes on its stdin."""
    import os

    fake = out_dir / "fake_ffmpeg"
    if fake.exists():
        for f in fake.iterdir():
            f.unlink()
    fake.mkdir(exist_ok=True)
    ffmpeg = fake / "ffmpeg"
    # ignores SIGTERM (the sink terminates it right after closing its stdin)
    ffmpeg.write_text(f"#!/bin/sh\ntrap '' TERM\nprintf '%s\\n' \"$0\" \"$@\" > \"{fake}/$$.argv\"\n"
                      f"wc -c > \"{fake}/$$.tmp\" && mv \"{fake}/$$.tmp\" \"{fake}/$$.bytes\"\n")
    ffmpeg.chmod(0o755)
    pushed = {"n": 0}

    def count_pushes(parts):
        sink = pushed["sink"] = parts[2]
        push = sink.push

        def counted(*a):
            push(*a)
            pushed["n"] += 1

        sink.push = counted

    path = os.environ["PATH"]
    os.environ["PATH"] = f"{fake}{os.pathsep}{path}"
    try:
        res, _, _ = remote_run(counters, layers, card, out_dir, "rtmp", packets, crcs,
                                 ["--sink", "rtmp", "--out", RTMP_URL], client=False,
                                 on_parts=count_pushes)
    finally:
        os.environ["PATH"] = path
    deadline = time.monotonic() + 60
    while not list(fake.glob("*.bytes")) and time.monotonic() < deadline:
        time.sleep(0.05)
    argvs = sorted(fake.glob("*.argv"))
    counts = [int(f.read_text()) for f in sorted(fake.glob("*.bytes"))]
    want = pushed["sink"].ffmpeg_argv(*FRAME_SHAPE[:2])
    got = argvs[0].read_text().splitlines() if argvs else None
    frame_bytes = FRAME_SHAPE[0] * FRAME_SHAPE[1] * 3
    ok = len(argvs) == 1 and counts == [pushed["n"] * frame_bytes] and pushed["n"] >= 1 \
        and got == want
    log(f"[remote] rtmp: ffmpeg started {len(argvs)} time(s) with argv {got} (want {want}); "
        f"{counts} bytes on its stdin for {pushed['n']} pushed frames of {frame_bytes} bytes "
        f"(Half-SBS 2160x3840 rgb24) {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("remote rtmp: the ffmpeg argv or the bytes on its stdin are off")
    res.update(argv=got, stdin_bytes=counts, pushed=pushed["n"])
    return res


def control_phase(card, out_dir):
    """30. The web control panel in a thread of this process: POST /start
    with the synthetic source and the null sink spawns the port's CLI on the
    card (DA-V2-Large @518); /status and /logs are polled until the worker's
    stats line shows frames; POST /stop ends it through the stop file, and
    it exits 0 within the grace period."""
    import os
    import threading
    import urllib.parse
    import urllib.request

    from desktop2stereo_tpu_torch.service import control

    work = out_dir / "control"
    work.mkdir(exist_ok=True)
    cwd, pythonpath = os.getcwd(), os.environ.get("PYTHONPATH")
    os.chdir(work)  # the panel keeps its log, stop file and settings here
    os.environ["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), pythonpath) if p)
    server = control.serve(port=0, settings_path=str(work / "settings.yaml"))
    manager = server.manager
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def get(path):
        return urllib.request.urlopen(url + path, timeout=60).read()

    def post(path, fields):
        urllib.request.urlopen(urllib.request.Request(
            url + path, data=urllib.parse.urlencode(fields).encode()), timeout=60).read()

    try:
        t0 = time.perf_counter()
        post("/start", {"source": "synthetic", "sink": "null", "model": FLAGSHIP_MODEL,
                        "depth_resolution": "518", "output_resolution": "1080",
                        "display_mode": "Half-SBS", "fps": "1000"})
        status = {}
        while not status.get("stats", {}).get("fps"):
            if time.perf_counter() - t0 > CONTROL_S or not manager.running:
                raise AssertionError("control: the worker showed no frames:\n"
                                     + get("/logs").decode(errors="replace")[-4000:])
            time.sleep(0.25)
            status = json.loads(get("/status"))
        first_s = time.perf_counter() - t0
        logs = get("/logs").decode(errors="replace")
        t1 = time.perf_counter()
        post("/stop", {})
        rc = manager.proc.wait(60)
        stop_s = time.perf_counter() - t1
    finally:
        if manager.running:
            manager.proc.kill()
            manager.proc.wait(60)
        server.shutdown()
        server.server_close()
        thread.join(60)
        os.chdir(cwd)
        if pythonpath is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = pythonpath
    tail = (work / "logs" / "worker.log").read_text(errors="replace")
    ok = (rc == 0 and "device: cuda" in logs and "stop.request received" in tail
          and stop_s < 8.5 and status["stats"]["fps"] > 0)
    log(f"[control] POST /start (synthetic 1080x1920, null sink, DA-V2-Large @518): the worker "
        f"(pid {status['pid']}) showed {status['stats']} in /status {first_s:.2f} s after the "
        f"POST (stats every 2 s); POST /stop: exit {rc} in {stop_s:.2f} s (grace 8 s: the stop "
        f"file, then SIGINT at 4 s) {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("control: the worker did not run on the card or stop cleanly:\n"
                             + tail[-4000:])
    return dict(spawn_to_stats_s=first_s, stats=status["stats"], rc=rc, stop_s=stop_s)


VDA_MODEL = "Video-Depth-Anything-Large"
CKPT_MODEL = "Video-Depth-Anything-Small"
INT8_VDA_FRAMES = 10


def vda_cache_shapes(spec, mh: int, mw: int):
    """The eight caches' shapes at a model input of mh x mw: the patch grid
    (temporal module 0, neck[2] channels), the stride-2 half grid (module 1,
    neck[3]), the grid and twice the grid (modules 2 and 3, the fusion
    channels), two attention sites each."""
    gh, gw = mh // spec.patch_size, mw // spec.patch_size
    neck, fusion = spec.neck_channels, spec.fusion_channels
    sites = ((gh * gw, neck[2]), (((gh + 1) // 2) * ((gw + 1) // 2), neck[3]),
             (gh * gw, fusion), (4 * gh * gw, fusion))
    return [(1, p, 31, c) for p, c in sites for _ in range(2)]


def temporal_flops(pixels: int, channels: int, window: int = 32) -> float:
    """Operations of one temporal module in a streaming step (one query
    frame, K and V over the whole window): proj_in and proj_out, two
    attention blocks (q, K and V over the window, logits and P·V, to_out)
    and the GEGLU feed-forward (C → 8C, 4C → C)."""
    R, C, n = pixels, channels, window
    attn = 2 * R * C * C + 2 * 2 * R * n * C * C + 2 * 2 * R * n * C + 2 * R * C * C
    return 2 * 2 * R * C * C + 2 * attn + 2 * R * C * 8 * C + 2 * R * 4 * C * C


def vda_original_arrays(np, spec, seed: int):
    """A Video-Depth-Anything checkpoint in its original naming (pretrained.*
    and head.*) at `spec`'s widths, values drawn from a seeded normal (x0.02)
    and stored as F16, as a release would ship them."""
    hidden, layers, _, mlp = spec.dims
    neck, fusion = spec.neck_channels, spec.fusion_channels
    rng = np.random.default_rng(seed)
    sd = {}

    def add(name, *shape):
        sd[name] = (rng.standard_normal(shape, dtype=np.float32) * 0.02).astype(np.float16)

    add("pretrained.cls_token", 1, 1, hidden)
    add("pretrained.pos_embed", 1, 37 * 37 + 1, hidden)
    add("pretrained.patch_embed.proj.weight", hidden, 3, spec.patch_size, spec.patch_size)
    for n in ("pretrained.patch_embed.proj.bias", "pretrained.norm.weight",
              "pretrained.norm.bias"):
        add(n, hidden)
    for i in range(layers):
        p = f"pretrained.blocks.{i}."
        for n in ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias", "attn.proj.bias",
                  "ls1.gamma", "ls2.gamma", "mlp.fc2.bias"):
            add(p + n, hidden)
        add(p + "attn.qkv.weight", 3 * hidden, hidden)
        add(p + "attn.qkv.bias", 3 * hidden)
        add(p + "attn.proj.weight", hidden, hidden)
        add(p + "mlp.fc1.weight", mlp, hidden)
        add(p + "mlp.fc1.bias", mlp)
        add(p + "mlp.fc2.weight", hidden, mlp)
    for i, ch in enumerate(neck):
        add(f"head.projects.{i}.weight", ch, hidden, 1, 1)
        add(f"head.projects.{i}.bias", ch)
        add(f"head.scratch.layer{i + 1}_rn.weight", fusion, ch, 3, 3)
    for i, k in ((0, 4), (1, 2), (3, 3)):
        add(f"head.resize_layers.{i}.weight", neck[i], neck[i], k, k)
        add(f"head.resize_layers.{i}.bias", neck[i])
    for rn in (1, 2, 3, 4):
        p = f"head.scratch.refinenet{rn}."
        add(p + "out_conv.weight", fusion, fusion, 1, 1)
        add(p + "out_conv.bias", fusion)
        for unit in (1, 2):
            for conv in (1, 2):
                add(p + f"resConfUnit{unit}.conv{conv}.weight", fusion, fusion, 3, 3)
                add(p + f"resConfUnit{unit}.conv{conv}.bias", fusion)
    for m, C in enumerate((neck[2], neck[3], fusion, fusion)):
        p = f"head.motion_modules.{m}.temporal_transformer."
        for n in ("norm.weight", "norm.bias", "proj_in.bias", "proj_out.bias"):
            add(p + n, C)
        add(p + "proj_in.weight", C, C)
        add(p + "proj_out.weight", C, C)
        bp = p + "transformer_blocks.0."
        for a in range(2):
            ap = bp + f"attention_blocks.{a}."
            for n in ("to_q", "to_k", "to_v", "to_out.0"):
                add(ap + n + ".weight", C, C)
            add(ap + "to_out.0.bias", C)
            add(bp + f"norms.{a}.weight", C)
            add(bp + f"norms.{a}.bias", C)
        for n in ("ff_norm.weight", "ff_norm.bias", "ff.net.2.bias"):
            add(bp + n, C)
        add(bp + "ff.net.0.proj.weight", 8 * C, C)
        add(bp + "ff.net.0.proj.bias", 8 * C)
        add(bp + "ff.net.2.weight", C, 4 * C)
    add("head.scratch.output_conv1.weight", fusion // 2, fusion, 3, 3)
    add("head.scratch.output_conv1.bias", fusion // 2)
    add("head.scratch.output_conv2.0.weight", 32, fusion // 2, 3, 3)
    add("head.scratch.output_conv2.0.bias", 32)
    add("head.scratch.output_conv2.2.weight", 1, 32, 1, 1)
    add("head.scratch.output_conv2.2.bias", 1)
    return sd


class _Probe:
    """Within `with`: every call of `owner.attr` (a method of a class, or a
    function of a module that its callers look up there) bracketed by CUDA
    events (`records`, in call order) or inside `record_function(label)`."""

    def __init__(self, torch, owner, attr: str, label=None) -> None:
        self.torch, self.owner, self.attr, self.label = torch, owner, attr, label
        self.records = []

    def __enter__(self):
        torch, orig, probe = self.torch, getattr(self.owner, self.attr), self
        self.orig = orig

        def wrapped(*args, **kw):
            if probe.label is not None:
                with torch.profiler.record_function(probe.label):
                    return orig(*args, **kw)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = orig(*args, **kw)
            b.record()
            probe.records.append((a, b))
            return out

        setattr(self.owner, self.attr, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.orig)


def vda_phases(np, torch, programs, build_bound, drive, driven, trace, paths, frames,
               policy, dev, card):
    """17-19: Video-Depth-Anything-Large at depth resolution 518 on 4K
    Half-SBS (the fused tail): FRAMES frames through FrameEngine with exact
    launches, the eight cache shapes, stage ms, the temporal modules' ms,
    peak memory and a traced frame; three small frames streamed on the card
    (bf16) and on the CPU (f32) against each other; the int8 encoder."""
    from desktop2stereo_tpu_torch.models import vda as VDA

    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vda, vda_spec = build_bound(VDA_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED)
    out["build_s"] = time.perf_counter() - t0
    layers = len(vda.backbone.layer)
    shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    cfg = drive("vda", vda, "Half-SBS", "high", shape, {"attention": layers, "dibr_pair": 1},
                net_spec=vda_spec)
    program = driven.pop("vda")
    mh, mw = programs.ema_shape(cfg, vda_spec, *FRAME_SHAPE[:2])
    want = vda_cache_shapes(vda_spec, mh, mw)
    (key,) = program._states
    carry = program._states[key].model
    got = [tuple(c.shape) for c in carry]
    carry_mb = sum(c.numel() * c.element_size() for c in carry) / 1e6
    ok = got == want and all(c.dtype == policy.compute_dtype for c in carry)
    log(f"[vda] carry after {FRAMES} frames, key {key}: {len(carry)} caches {got} (want "
        f"{want}), {carry_mb:.1f} MB {carry[0].dtype} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("vda: the carry's caches have the wrong shapes")

    # the temporal modules' share of a steady-state frame: CUDA events around
    # each module's forward (eager, host gaps included), median of 10 frames
    with _Probe(torch, VDA.TemporalTransformer, "forward") as probe:
        per_frame = []
        for i in range(11):
            probe.records.clear()
            program(frames[i % len(frames)])
            torch.cuda.synchronize()
            if i:
                per_frame.append([a.elapsed_time(b) for a, b in probe.records])
    site_ms = [statistics.median(f[m] for f in per_frame) for m in range(4)]
    gh, gw = mh // vda_spec.patch_size, mw // vda_spec.patch_size
    pixels = (gh * gw, ((gh + 1) // 2) * ((gw + 1) // 2), gh * gw, 4 * gh * gw)
    chans = (vda_spec.neck_channels[2], vda_spec.neck_channels[3], vda_spec.fusion_channels,
             vda_spec.fusion_channels)
    flops = [temporal_flops(p, c) for p, c in zip(pixels, chans)]
    bound = bound_ms(policy.name, sum(c.numel() * c.element_size() for c in carry),
                     sum(flops), "bf16")
    out["temporal"] = dict(module_ms=site_ms, total_ms=statistics.median(map(sum, per_frame)),
                           gflop=[f / 1e9 for f in flops], bound=bound)
    log(f"[vda] temporal modules in a streamed 4K frame (CUDA events around each module, "
        f"eager, median of 10): " + ", ".join(
            f"module {m} [{p} px, C {c}] {ms:.3f} ms for {f / 1e9:.1f} GFLOP"
            for m, (p, c, ms, f) in enumerate(zip(pixels, chans, site_ms, flops)))
        + f"; total {out['temporal']['total_ms']:.3f} ms for {sum(flops) / 1e12:.3f} TFLOP, "
        f"bound {bound[0]:.3f} ms ({bound[1]}); {card}")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["carry_mb"] = carry_mb
    out["cache_shapes"] = [list(g) for g in got]
    log(f"[vda] peak device memory since the model build {out['peak_mem_gb']:.2f} GB "
        f"(torch.cuda.max_memory_allocated); {card}")
    del program

    with _Probe(torch, VDA.TemporalTransformer, "forward", label="vda_temporal"):
        out["trace"] = trace("vda", vda, vda_spec, cfg, "engine",
                             {"K2 attention": layers, "K1 dibr_pair": 1}, spans=("vda_temporal",))

    # -- 18. three small frames streamed on the card and on the CPU -------
    cpu_vda, _ = build_bound(VDA_MODEL, device="cpu", dtype=torch.float32, seed=SEED)
    card_prog = programs.ProgramCache(cfg, vda, vda_spec, compute_dtype=policy.compute_dtype)
    cpu_prog = programs.ProgramCache(cfg, cpu_vda, vda_spec, compute_dtype=torch.float32)
    small = synthetic_frames(np, 3, 216, 384, SEED + 5)
    out["reference"] = [reference_check(torch, f"vda frame {i} ({'step' if i else 'first'})",
                                        card_prog, cpu_prog, f) for i, f in enumerate(small)]
    (key,) = card_prog._states
    rel = [((c.float().cpu() - r).abs().max() / r.abs().max().clamp_min(1e-6)).item()
           for c, r in zip(card_prog._states[key].model, cpu_prog._states[key].model)]
    out["reference_carry_max_rel"] = rel
    log(f"[vda] carry after 3 small frames, card bf16 against CPU f32, max abs err over max "
        f"abs per cache: " + ", ".join(f"{r:.4f}" for r in rel))
    # the batched program (phase 45's path): two streams, first then step
    out["batched_reference"] = batched_reference(
        np, torch, programs, "vda", cfg, vda, cpu_vda, vda_spec, policy,
        [small[:2], small[1:]])
    del cpu_vda, cpu_prog, card_prog

    # -- 19. int8 VDA ----------------------------------------------------------
    t0 = time.perf_counter()
    vda_q, _ = build_bound(VDA_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED,
                           quant="int8")
    out["int8_build_s"] = time.perf_counter() - t0
    drive("vda_int8", vda_q, "Half-SBS", "high", shape,
          {"attention": layers, "quant_matmul": 4 * layers, "dibr_pair": 1},
          net_spec=vda_spec, n_frames=INT8_VDA_FRAMES)
    driven.pop("vda_int8")
    out["paths"] = {k: paths[k] for k in ("vda", "vda_int8")}
    del vda, vda_q
    torch.cuda.empty_cache()
    return out


def checkpoint_phase(np, torch, build_bound, counters, dev, card, out_dir):
    """20. A real-shape Video-Depth-Anything-Small checkpoint (original
    naming, F16, seeded) written by the port's writer as one file and as
    three shards with an index: `build_bound(..., checkpoint=path)` on the
    card holds the tensors the CPU load holds, and the CLI runs
    `--model Video-Depth-Anything-Small --checkpoint <index>` on a 4K
    synthetic source into the null sink (12 K2 and one K1 a frame)."""
    import tempfile

    from desktop2stereo_tpu_torch.core.registry import get_spec
    from desktop2stereo_tpu_torch.models import safetensors_io

    spec = get_spec(CKPT_MODEL)
    out = {}
    with tempfile.TemporaryDirectory(prefix="d2s_smoke_ckpt_") as tmp:
        tmp = Path(tmp)
        arrays = vda_original_arrays(np, spec, SEED + 7)
        (tmp / "sharded").mkdir()
        t0 = time.perf_counter()
        single = tmp / "model.safetensors"
        safetensors_io.save_file(arrays, single)
        index = safetensors_io.save_sharded(arrays, tmp / "sharded", shards=3)
        out["write_s"] = time.perf_counter() - t0
        out["params"] = int(sum(a.size for a in arrays.values()))
        out["bytes"] = single.stat().st_size
        ref = None
        for layout, path in (("single", single), ("sharded", index)):
            t0 = time.perf_counter()
            on_card, _ = build_bound(CKPT_MODEL, device=dev, dtype=torch.float32,
                                     checkpoint=str(path))
            load_s = time.perf_counter() - t0
            on_cpu, _ = build_bound(CKPT_MODEL, device="cpu", checkpoint=str(path))
            card_sd = {k: v.cpu() for k, v in on_card.state_dict().items()}
            cpu_sd = on_cpu.state_dict()
            ref = ref or cpu_sd
            raw = safetensors_io.load_tensors(path, dev)
            ok = (set(card_sd) == set(cpu_sd) == set(ref)
                  and all(torch.equal(card_sd[k], cpu_sd[k]) and torch.equal(cpu_sd[k], ref[k])
                          for k in cpu_sd)
                  and len(raw) == len(arrays)
                  and all(torch.equal(raw[k].cpu(), torch.from_numpy(arrays[k])) for k in arrays))
            log(f"[checkpoint] {CKPT_MODEL}, {out['params']} parameters as F16 "
                f"({out['bytes'] / 1e6:.1f} MB), {layout}: build_bound on the card "
                f"{load_s:.2f} s; {len(card_sd)} tensors equal to the CPU load (and to the "
                f"single file's), the raw tensors read onto the card equal to the written "
                f"ones {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"checkpoint {layout}: the card's load differs from the CPU's")
            out[layout] = dict(load_s=load_s, tensors=len(card_sd))
            del on_card, on_cpu, raw
        run = CliRun(counters)
        rc = run(["--settings", str(cli_settings(out_dir)), "--model", CKPT_MODEL,
                  "--checkpoint", index, "--source", "synthetic",
                  "--size", f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--sink", "null",
                  "--frames", str(FRAMES), "--stop-file", str(out_dir / "stop.request"),
                  "--stats-every", "0"])
    _, _, sink, _ = run.parts
    eng = run.engine
    want_shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    ok = rc == 0 and sink.frames >= 1 and sink.last_shape == want_shape
    log(f"[checkpoint] python -m desktop2stereo_tpu_torch.cli --model {CKPT_MODEL} "
        f"--checkpoint <index> --source synthetic --size {FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} "
        f"--sink null --frames {FRAMES}: exit {rc}; {eng.frames} frames run, {sink.frames} "
        f"delivered {sink.last_shape} {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("cli with --checkpoint: exit code or output off")
    out["cli"] = dict(rc=rc, frames_run=eng.frames, delivered=sink.frames,
                      launches=run.check_launches("checkpoint", spec.dims[1], CLI_WARM_FRAMES))
    return out


DA3_MODEL = "DA3-LARGE"
DA3_MONO_MODEL = "DA3MONO-LARGE"
DA3_NESTED_MODEL = "DA3NESTED-GIANT-LARGE"
DA3_RES = 504           # the top of the DA3 menu: a 280x504 input, 721 tokens
DA3_INPUT = (280, 504)
DA3_SHORT_FRAMES = 10   # int8 and NESTED runs
# int8 against bf16 DA3-LARGE on one model input: the JAX package's bound
# for the DA3 family (tests/test_quant.py, DA3-SMALL on the CPU)
INT8_DA3_MIN_CORR = 0.99


# DA3MONO's raw outputs, card bf16 vs CPU f32 on one model input: the depth
# over the reference's non-sky pixels, normalised as the metric post does
# (1/d, percentile clip), under phase 6's depth bound; the sky masks may
# disagree on at most this share of pixels
REF_SKY_MASK_DISAGREE = 0.03


def sky_reference_check(torch, D3, normalize_depth, name, card_net, cpu_net, model_in, dev,
                        dtype):
    """predict(depth, sky) of the mono preset on the card and on the CPU:
    the depth where the CPU's mask says non-sky (what the sky fill would
    hide in the frame's output), the masks' agreement, and the sky share."""
    with torch.inference_mode():
        c = card_net.predict(model_in.to(dev, dtype), ("depth", "sky"))
        r = cpu_net.predict(model_in.float().cpu(), ("depth", "sky"))
    dc, sc = c["depth"].float().cpu()[0, 0], c["sky"].float().cpu()[0, 0]
    dr, sr = r["depth"][0, 0], r["sky"][0, 0]
    non_sky = sr < D3.SKY_THRESHOLD
    err = (normalize_depth(torch.where(non_sky, dc, 0.0), metric=True)
           - normalize_depth(torch.where(non_sky, dr, 0.0), metric=True)).abs()[non_sky]
    ref = {"sky_share_cpu": 1.0 - non_sky.float().mean().item(),
           "non_sky_pixels": int(non_sky.sum().item()),
           "mask_disagree": ((sc < D3.SKY_THRESHOLD) != non_sky).float().mean().item(),
           "non_sky_depth_mean_abs": err.mean().item() if err.numel() else float("nan"),
           "non_sky_depth_max_abs": err.max().item() if err.numel() else float("nan")}
    ok = (bool(torch.isfinite(dc).all()) and err.numel() > 0
          and ref["non_sky_depth_mean_abs"] <= REF_DEPTH_MEAN_ABS
          and ref["mask_disagree"] <= REF_SKY_MASK_DISAGREE)
    log(f"[reference] {name} raw depth and sky, model input {list(model_in.shape)}, card bf16 "
        f"vs CPU f32: sky share {ref['sky_share_cpu']:.4f} ({ref['non_sky_pixels']} non-sky "
        f"pixels); masks disagree on {ref['mask_disagree']:.2e} (tol {REF_SKY_MASK_DISAGREE}); "
        f"normalised non-sky depth mean {ref['non_sky_depth_mean_abs']:.4f} "
        f"(tol {REF_DEPTH_MEAN_ABS}) max {ref['non_sky_depth_max_abs']:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"reference {name}: the raw depth or sky mask disagrees with the CPU")
    return ref


def finite_share(torch, net, program, frame_np, dev):
    """The model's raw depth on one 4K frame's model input, and the share
    of its values that are finite (exp heads on random weights can
    overflow)."""
    with torch.inference_mode():
        _, model_in = program.program.preprocess(torch.from_numpy(frame_np).to(dev))
        raw = net(model_in)
        return model_in, raw, torch.isfinite(raw).float().mean().item()


def da3_phases(np, torch, programs, build_bound, drive, driven, trace, paths, frames, counters,
               policy, dev, card, out_dir):
    """21-26: the Depth-Anything-3 family at depth resolution 504 on 4K
    Half-SBS (the fused tail): DA3-LARGE (exact launches, stage ms, peak
    memory, the share of finite depth, a traced frame without the ray branch
    or the camera decoder, beside a traced full-output call that runs them);
    DA3MONO-LARGE (the sky post's ms); card bf16 against CPU f32 for both;
    int8 DA3-LARGE (K4, correlation with bf16); DA3NESTED-GIANT-LARGE (64 K2
    a frame, build s, peak memory); the CLI with `--model DA3-LARGE`."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    from desktop2stereo_tpu_torch.models import da3 as D3
    from desktop2stereo_tpu_torch.ops.depth_post import normalize_depth

    out = {}
    shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)

    def build(name, **kw):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net, net_spec = build_bound(name, device=dev, dtype=policy.compute_dtype, seed=SEED, **kw)
        return net, net_spec, time.perf_counter() - t0

    # -- 21. DA3-LARGE @504, 4K Half-SBS ------------------------------------
    net, spec, build_s = build(DA3_MODEL)
    layers = len(net.backbone.layer)
    cfg = drive("da3", net, "Half-SBS", "high", shape, {"attention": layers, "dibr_pair": 1},
                net_spec=spec, res=DA3_RES)
    program = driven.pop("da3")
    mi_shape = programs.ema_shape(cfg, spec, *FRAME_SHAPE[:2])
    if tuple(mi_shape) != DA3_INPUT:
        raise AssertionError(f"da3: model input {mi_shape}, want {DA3_INPUT}")
    model_in, raw, finite = finite_share(torch, net, program, frames[0], dev)
    peak = torch.cuda.max_memory_allocated() / 1e9
    out["large"] = dict(build_s=build_s, peak_mem_gb=peak, finite_share=finite,
                        model_input=list(model_in.shape))
    log(f"[da3] {DA3_MODEL} built in {build_s:.1f} s; model input {list(model_in.shape)} "
        f"({DA3_INPUT[0] // 14 * DA3_INPUT[1] // 14 + 1} tokens); raw depth finite on "
        f"{finite:.6f} of {raw.numel()} values, range {raw.float().nan_to_num().min().item():.4g}"
        f"..{raw.float().nan_to_num().max().item():.4g}; peak device memory {peak:.2f} GB; {card}")

    # the traced frame runs neither the ray branch nor the camera decoder:
    # both are bracketed by record_function ranges, and a full-output call
    # (every output of the preset) traced beside it shows the ranges with
    # their kernels
    spans = ("da3_ray", "da3_cam_dec")
    with _Probe(torch, D3.DA3DualDPT, "_aux", "da3_ray"), \
            _Probe(torch, D3.DA3CameraDec, "forward", "da3_cam_dec"):
        tr = trace("da3", net, spec, cfg, "engine", {"K2 attention": layers, "K1 dibr_pair": 1},
                   spans=spans)
        with torch.inference_mode():
            for _ in range(3):
                net.predict(model_in)
            torch.cuda.synchronize()
            # as `trace` does: a discarded warm-up call, then the traced one
            path = out_dir / "trace_da3_full_outputs.json"
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1),
                         on_trace_ready=lambda p: p.export_chrome_trace(str(path))) as prof:
                for _ in range(2):
                    with record_function("frame"):
                        full = net.predict(model_in)
                    torch.cuda.synchronize()
                    prof.step()

    def events_of(p):
        data = json.loads(p.read_text())
        return data["traceEvents"] if isinstance(data, dict) else data

    def host_ranges(events, label):
        return sum(1 for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == label)

    full_events, frame_events = events_of(path), events_of(out_dir / "trace_da3.json")
    full_tr = summarize_trace(full_events, spans)
    conv_frame = tr["groups"].get("convolution", {}).get("calls", 0)
    conv_full = full_tr["groups"].get("convolution", {}).get("calls", 0)
    ranges = {k: (host_ranges(frame_events, k), host_ranges(full_events, k)) for k in spans}
    ok = (all(f == 0 and g == 1 for f, g in ranges.values())
          and all(tr["spans"][k] is None for k in spans) and set(full) == set(D3.ANYVIEW_OUTPUTS))
    log(f"[da3] traced 4K frame: da3_ray and da3_cam_dec ranges on the host "
        + ", ".join(f"{k} {f}" for k, (f, _) in ranges.items())
        + f" (the ray branch and the camera decoder did not run), {conv_frame} convolution "
        f"kernels; a traced predict(every output) on the same input: host ranges "
        + ", ".join(f"{k} {g}" for k, (_, g) in ranges.items()) + "; on the card " + ", ".join(
            f"{k} {v['ms']:.3f} ms in {v['calls']} kernels" if v else f"{k} not separable"
            for k, v in full_tr["spans"].items())
        + f", {conv_full} convolution kernels, busy {full_tr['busy_ms']:.3f} ms "
        f"{'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("da3: the frame ran a dead branch, or the full call missed one")
    out["large"].update(trace=tr, full_outputs_trace=dict(
        busy_ms=full_tr["busy_ms"], spans=full_tr["spans"], groups=full_tr["groups"]))
    del program, full, raw

    # -- 22. DA3MONO-LARGE: the DPT head with the sky post -------------------
    mono, mono_spec, mono_build_s = build(DA3_MONO_MODEL)
    mono_cfg = drive("da3_mono", mono, "Half-SBS", "high", shape,
                     {"attention": layers, "dibr_pair": 1}, net_spec=mono_spec, res=DA3_RES)
    program = driven.pop("da3_mono")
    _, raw, mono_finite = finite_share(torch, mono, program, frames[0], dev)
    with _Probe(torch, D3, "sky_to_max_depth") as probe:
        per_frame = []
        for i in range(11):
            probe.records.clear()
            program(frames[i % len(frames)])
            torch.cuda.synchronize()
            if i:
                per_frame.append(probe.records[0][0].elapsed_time(probe.records[0][1]))
    with torch.inference_mode():
        sky = mono.predict(model_in, ("depth", "sky"))["sky"]
    sky_share = (sky >= 0.3).float().mean().item()
    out["mono"] = dict(build_s=mono_build_s, finite_share=mono_finite,
                       sky_post_ms=statistics.median(per_frame), sky_share=sky_share,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[da3] {DA3_MONO_MODEL}: sky post (two sorts of {raw[0].numel()} values and the "
        f"fill, on the card) {out['mono']['sky_post_ms']:.3f} ms (CUDA events around it in "
        f"the frame, eager, median of 10); sky share {sky_share:.4f}; raw depth finite on "
        f"{mono_finite:.6f}; built in {mono_build_s:.1f} s; {card}")
    del program, raw, sky

    # -- 23. card bf16 against CPU f32 on a small frame ----------------------
    small = synthetic_frames(np, 1, 216, 384, SEED + 1)[0]
    out["reference"] = {}
    for name, card_net, net_cfg in ((DA3_MODEL, net, cfg), (DA3_MONO_MODEL, mono, mono_cfg)):
        cpu_net, net_spec = build_bound(name, device="cpu", dtype=torch.float32, seed=SEED)
        card_prog = programs.ProgramCache(net_cfg, card_net, net_spec,
                                          compute_dtype=policy.compute_dtype)
        cpu_prog = programs.ProgramCache(net_cfg, cpu_net, net_spec, compute_dtype=torch.float32)
        out["reference"][name] = reference_check(torch, f"{name} @{DA3_RES}", card_prog,
                                                 cpu_prog, small)
        if name == DA3_MONO_MODEL:
            # the frame's depth is mostly the sky fill on random weights:
            # hold the raw depth and the sky mask as well
            _, cpu_in = cpu_prog.program.preprocess(torch.from_numpy(small))
            out["reference"][name + " raw"] = sky_reference_check(
                torch, D3, normalize_depth, f"{name} @{DA3_RES}", card_net, cpu_net, cpu_in,
                dev, policy.compute_dtype)
        del cpu_net, cpu_prog, card_prog
    del mono

    # -- 24. int8 DA3-LARGE -------------------------------------------------
    net_q, _, q_build_s = build(DA3_MODEL, quant="int8")
    with torch.inference_mode():
        raw_f = net(model_in)[0].float()
        raw_q = net_q(model_in)[0].float()
    both = torch.stack([raw_f.flatten(), raw_q.flatten()])
    corr = torch.corrcoef(both)[0, 1].item()
    rel = ((raw_q - raw_f).abs().max() / raw_f.abs().max().clamp_min(1e-6)).item()
    ok = bool(torch.isfinite(both).all()) and corr > INT8_DA3_MIN_CORR
    log(f"[da3] int8 {DA3_MODEL} against bf16 on one {list(model_in.shape)} model input: "
        f"correlation {corr:.5f} (min {INT8_DA3_MIN_CORR}), max rel err {rel:.4f}; built in "
        f"{q_build_s:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("int8 DA3 does not track the bf16 model")
    out["int8"] = dict(corr=corr, max_rel_err=rel, build_s=q_build_s)
    drive("da3_int8", net_q, "Half-SBS", "high", shape,
          {"attention": layers, "quant_matmul": 4 * layers, "dibr_pair": 1}, net_spec=spec,
          n_frames=DA3_SHORT_FRAMES, res=DA3_RES)
    driven.pop("da3_int8")
    del net_q, raw_f, raw_q, both

    # -- 25. DA3NESTED-GIANT-LARGE ---------------------------------------------
    del net
    nested, nested_spec, nested_build_s = build(DA3_NESTED_MODEL)
    n_layers = len(nested.da3.backbone.layer) + len(nested.da3_metric.backbone.layer)
    drive("da3_nested", nested, "Half-SBS", "high", shape,
          {"attention": n_layers, "dibr_pair": 1}, net_spec=nested_spec,
          n_frames=DA3_SHORT_FRAMES, res=DA3_RES)
    program = driven.pop("da3_nested")
    _, raw, nested_finite = finite_share(torch, nested, program, frames[0], dev)
    params = sum(p.numel() for p in nested.parameters())
    out["nested"] = dict(build_s=nested_build_s, layers=n_layers, params=params,
                         finite_share=nested_finite,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[da3] {DA3_NESTED_MODEL}: {params} parameters (ViT-G {len(nested.da3.backbone.layer)}"
        f" layers with SwiGLU + ViT-L {len(nested.da3_metric.backbone.layer)}), built in "
        f"{nested_build_s:.1f} s (drawn in f32 on the host, moved to the card in bf16); raw "
        f"depth finite on {nested_finite:.6f}; peak device memory "
        f"{out['nested']['peak_mem_gb']:.2f} GB; {card}")
    del nested, program, raw
    torch.cuda.empty_cache()

    # -- 26. the CLI with --model DA3-LARGE ------------------------------------
    run = CliRun(counters)
    rc = run(["--settings", str(cli_settings(out_dir)), "--model", DA3_MODEL, "--depth-res",
              str(DA3_RES), "--source", "synthetic", "--size",
              f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--sink", "null", "--frames", str(FRAMES),
              "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"])
    _, _, sink, _ = run.parts
    eng = run.engine
    ok = rc == 0 and sink.frames >= 1 and sink.last_shape == shape
    log(f"[cli] python -m desktop2stereo_tpu_torch.cli --model {DA3_MODEL} --depth-res "
        f"{DA3_RES} --source synthetic --size {FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} --sink null "
        f"--frames {FRAMES}: exit {rc}; {eng.frames} frames run, {sink.frames} delivered "
        f"{sink.last_shape} {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("cli with --model DA3-LARGE: exit code or output off")
    out["cli"] = dict(rc=rc, frames_run=eng.frames, delivered=sink.frames,
                      launches=run.check_launches("da3", layers, CLI_WARM_FRAMES))
    out["paths"] = {k: paths[k] for k in ("da3", "da3_mono", "da3_int8", "da3_nested")}
    return out


BEIT_MODEL = "dpt-beit-large-512"
BEIT_RES, BEIT_INPUT = 512, (288, 512)          # 18 x 32 patches + cls: 577 tokens
DPT_LARGE_MODEL = "dpt-large"
HYBRID_MODEL = "dpt-hybrid-midas"
CLASSIC_RES, CLASSIC_INPUT = 384, (224, 384)    # 14 x 24 + 1: 337 tokens
DPT_DINOV2_MODEL = "dpt-dinov2-giant-kitti"
DPT_DINOV2_RES, DPT_DINOV2_INPUT = 518, (294, 518)  # 21 x 37 + 1: 778 tokens
BEIT_CKPT_MODEL = "dpt-beit-base-384"
CLASSIC_FRAMES = 10  # the classic paths other than the BEiT flagship


def beit_hf_arrays(np, spec, seed: int):
    """A real-shape DPT-BEiT checkpoint in the HF naming (DPTForDepthEstimation
    with a BeitBackbone), drawn from a seed, as F16 arrays: fan-in scaled
    kernels, unit-normal relative-position tables, LayerScale near 1."""
    from desktop2stereo_tpu_torch.models.beit import BEIT_PRESETS

    rng = np.random.default_rng(seed)
    D, layers, heads, mlp, _, window = BEIT_PRESETS[spec.name]
    neck, fusion, p = spec.neck_channels, spec.fusion_channels, spec.patch_size
    out = {}

    def arr(name, shape, std=0.02, mean=0.0):
        out[name] = (mean + std * rng.standard_normal(shape, dtype=np.float32)).astype(np.float16)

    def linear(name, fin, fout, bias=True):
        arr(name + ".weight", (fout, fin), fin ** -0.5)
        if bias:
            arr(name + ".bias", (fout,))

    def conv(name, cin, cout, k, bias=True):
        arr(name + ".weight", (cout, cin, k, k), (cin * k * k) ** -0.5)
        if bias:
            arr(name + ".bias", (cout,))

    def norm(name, c):
        arr(name + ".weight", (c,), 0.1, 1.0)
        arr(name + ".bias", (c,))

    arr("backbone.embeddings.cls_token", (1, 1, D))
    conv("backbone.embeddings.patch_embeddings.projection", 3, D, p)
    for i in range(layers):
        lp = f"backbone.encoder.layer.{i}."
        ap = lp + "attention.attention."
        norm(lp + "layernorm_before", D)
        norm(lp + "layernorm_after", D)
        linear(ap + "query", D, D)
        linear(ap + "key", D, D, bias=False)
        linear(ap + "value", D, D)
        arr(ap + "relative_position_bias.relative_position_bias_table",
            ((2 * window - 1) ** 2 + 3, heads), 1.0)
        linear(lp + "attention.output.dense", D, D)
        linear(lp + "intermediate.dense", D, mlp)
        linear(lp + "output.dense", mlp, D)
        arr(lp + "lambda_1", (D,), 0.1, 1.0)
        arr(lp + "lambda_2", (D,), 0.1, 1.0)
    for i, (c, f) in enumerate(zip(neck, (4, 2, 1, -2))):
        linear(f"neck.reassemble_stage.readout_projects.{i}.0", 2 * D, D)
        rp = f"neck.reassemble_stage.layers.{i}."
        conv(rp + "projection", D, c, 1)
        if f > 1:
            arr(rp + "resize.weight", (c, c, f, f), c ** -0.5)
            arr(rp + "resize.bias", (c,))
        elif f < 0:
            conv(rp + "resize", c, c, 3)
        conv(f"neck.convs.{i}", c, fusion, 3, bias=False)
    for j in range(4):
        fp = f"neck.fusion_stage.layers.{j}."
        conv(fp + "projection", fusion, fusion, 1)
        for r in (1, 2):
            for c in (1, 2):
                conv(fp + f"residual_layer{r}.convolution{c}", fusion, fusion, 3)
    conv("head.head.0", fusion, fusion // 2, 3)
    conv("head.head.2", fusion // 2, 32, 3)
    conv("head.head.4", 32, 1, 1)
    return out


class FamilyPaths:
    """What the family phases share: build a registry model on the card, drive
    it through FrameEngine at 4K Half-SBS (the fused tail) with exact
    launches, and hold small frames against the CPU's f32 run."""

    def __init__(self, np, torch, programs, build_bound, drive, driven, frames, policy, dev,
                 card) -> None:
        self.torch, self.programs, self.build_bound = torch, programs, build_bound
        self.drive, self.driven, self.frames = drive, driven, frames
        self.policy, self.dev, self.card = policy, dev, card
        self.small = synthetic_frames(np, 2, 216, 384, SEED + 1)

    def build(self, name, **kw):
        torch = self.torch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        net, net_spec = self.build_bound(name, device=self.dev, dtype=self.policy.compute_dtype,
                                         seed=SEED, **kw)
        return net, net_spec, time.perf_counter() - t0

    def path(self, key, name, res, want_input, n_frames, biased=False, quant="none", k2=None,
             **kw):
        """Build, check the model input, drive n_frames 4K frames with exact
        launches (`k2` K2 a frame, by default one a trunk layer); returns
        (net, spec, cfg, the path's report, one model input)."""
        torch, programs = self.torch, self.programs
        net, spec, build_s = self.build(name, quant=quant)
        trunk = getattr(net, "backbone", None) or getattr(net, "patch_encoder", net)
        layers = len(trunk.layer)
        k2 = layers if k2 is None else k2
        want = {"attention": k2, "dibr_pair": 1, **kw}
        if biased:  # every K2 launch through the table entry, none through the dense one
            want["attention_relpos"] = k2
        shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
        cfg = self.drive(key, net, "Half-SBS", "high", shape, want, net_spec=spec,
                         n_frames=n_frames, res=res)
        program = self.driven.pop(key)
        mi = tuple(programs.ema_shape(cfg, spec, *FRAME_SHAPE[:2]))
        if mi != want_input:
            raise AssertionError(f"{key}: model input {mi}, want {want_input}")
        (state,) = program._states.values()
        model_in, raw, finite = finite_share(torch, net, program, self.frames[0], self.dev)
        rep = dict(build_s=build_s, layers=layers, k2=k2, model_input=list(model_in.shape),
                   depth_shape=list(raw.shape), ema_carry=list(state.ema_depth.shape),
                   finite_share=finite, params=sum(p.numel() for p in net.parameters()),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        tokens = ("" if spec.square_only else
                  f" ({mi[0] // spec.patch_size}x{mi[1] // spec.patch_size} patches)")
        log(f"[{key}] {name}{' int8' if quant != 'none' else ''} @{res}: model input "
            f"{list(model_in.shape)}{tokens}, depth at the head's resolution "
            f"{list(raw.shape)}, EMA carry after the run {rep['ema_carry']}, finite on "
            f"{finite:.6f}; {layers} layers, {rep['params']} parameters, built in "
            f"{build_s:.1f} s; peak device memory {rep['peak_mem_gb']:.2f} GB; {self.card}")
        return net, spec, cfg, rep, model_in

    def reference(self, name, card_net, cfg, n_frames=1, keep=None):
        """Small frames through the card's program (bf16) and the CPU's
        (f32, plain versions), each held to phase 6's thresholds; the CPU's
        outputs are appended to `keep` where one is given."""
        torch, programs = self.torch, self.programs
        cpu_net, spec = self.build_bound(name, device="cpu", dtype=torch.float32, seed=SEED)
        card_prog = programs.ProgramCache(cfg, card_net, spec,
                                          compute_dtype=self.policy.compute_dtype)
        cpu_prog = programs.ProgramCache(cfg, cpu_net, spec, compute_dtype=torch.float32)
        refs = [reference_check(torch, f"{name} @{cfg.depth_resolution} frame {i}", card_prog,
                                cpu_prog, self.small[i], keep) for i in range(n_frames)]
        return refs, cpu_net


def classic_dpt_phases(np, torch, programs, build_bound, drive, driven, trace, paths, frames,
                       counters, policy, dev, card, out_dir):
    """31-37: the classic DPT family at 4K Half-SBS (the fused tail):
    dpt-beit-large-512 (K2's table entry, the carried tables), dpt-large,
    dpt-hybrid-midas, dpt-dinov2-giant-kitti, int8 dpt-beit-large-512, each
    with exact launches and (but int8) a small-frame reference; the CLI on
    the BEiT flagship; a real-shape dpt-beit-base-384 checkpoint."""
    from desktop2stereo_tpu_torch.models import beit as D_BEIT
    from desktop2stereo_tpu_torch.ops.attention import multi_head_attention
    from desktop2stereo_tpu_torch.ops.kernels import attention as K2
    from desktop2stereo_tpu_torch.ops.quant import QuantLinear

    gen = torch.Generator(device=dev).manual_seed(SEED + 31)

    out = {}
    shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    fam = FamilyPaths(np, torch, programs, build_bound, drive, driven, frames, policy, dev, card)
    path, reference = fam.path, fam.reference

    # -- 31. dpt-beit-large-512 @512: K2's table entry, the carried tables -----
    net, spec, cfg, rep, model_in = path("beit", BEIT_MODEL, BEIT_RES, BEIT_INPUT, FRAMES,
                                         biased=True)
    calls = []
    make_tables = D_BEIT.compute_rel_pos_tables

    def counted(*args):
        calls.append(args[1:])
        return make_tables(*args)

    D_BEIT.compute_rel_pos_tables = counted
    try:
        prog = programs.ProgramCache(cfg, net, spec, compute_dtype=policy.compute_dtype)
        for i in range(4):  # first, then steps through a live display-mode switch
            if i == 2:
                prog.set_display_mode("Half-TAB")
            prog(frames[i % len(frames)])
        (key,) = prog._states
        carry = prog._states[key].model
        calls_one = len(calls)
        prog(frames[0][:, : FRAME_SHAPE[1] * 3 // 4])  # 4:3: another output size and carry
        torch.cuda.synchronize()
    finally:
        D_BEIT.compute_rel_pos_tables = make_tables
    carry_mb = sum(t.numel() * t.element_size() for t in carry) / 1e6
    dense_mb = rep["layers"] * 16 * 577 * 577 * 2 / 1e6  # what PR 10's dense carry held
    other = next(v.model for k, v in prog._states.items() if k != key)
    R = K2.relative_position_count(18, 32)
    ok = (calls_one == 1 and len(calls) == 2 and len(carry) == rep["layers"]
          and all(t.shape == (16, R) and t.dtype == policy.compute_dtype
                  and t.is_contiguous() for t in carry)
          and prog._states[key].model is carry
          and other[0].shape == (16, K2.relative_position_count(24, 32)))
    with torch.inference_mode():  # the once-per-shape cost of building the carry
        times = []
        for _ in range(6):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            make_tables(net.backbone, 18, 32)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
    rep.update(carry_mb=carry_mb, carry_tensors=len(carry), table_builds=len(calls),
               carry_build_ms=statistics.median(times[1:]))
    log(f"[beit] carry: compute_rel_pos_tables ran {calls_one} time(s) over 4 frames of one "
        f"stream (first, step, a live switch to Half-TAB, step) and {len(calls)} with a 4:3 "
        f"capture after them (grids {[c[:2] for c in calls]}); {len(carry)} tables "
        f"{list(carry[0].shape)} {str(carry[0].dtype)[6:]}, {carry_mb:.3f} MB (the dense "
        f"biases were {dense_mb:.1f} MB), built in {rep['carry_build_ms']:.3f} ms (CUDA "
        f"events, median of 5) {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("beit: the tables were not built once per stream and size")

    # the dense-bias API (the JAX package's `multi_head_attention(..., bias=)`):
    # the 24 carried tables expanded, each through the dense entry, against
    # the table entry on the same q/k/v; counts set to 0 before, read after
    B, N, H, D = BIAS_ATTN_SHAPE
    with torch.inference_mode():
        q, k, v = (torch.randn(B, N, H, D, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        dense = [K2.expand_rel_pos(t, 18, 32) for t in carry]
        zero_counts(counters)
        by_dense = [multi_head_attention(q, k, v, bias=b) for b in dense]
        by_table = [multi_head_attention(q, k, v, rel_pos=(t, 18, 32)) for t in carry]
        torch.cuda.synchronize()
        api_counts = read_counts(counters)
    diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(by_dense, by_table))
    ok = (api_counts["attention_bias"] == rep["layers"]
          and api_counts["attention_relpos"] == rep["layers"] and diff <= ATTN_MAX_ABS)
    log(f"[beit] the dense-bias API on the {rep['layers']} layers' expanded tables: launches "
        f"attention_bias {api_counts['attention_bias']}, attention_relpos "
        f"{api_counts['attention_relpos']}; the two entries differ by at most {diff:.3e} "
        f"({'equal' if all(torch.equal(a, b) for a, b in zip(by_dense, by_table)) else 'NOT equal'}"
        f") {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("beit: the dense-bias API and the table entry disagree")
    paths["beit_dense_api"] = dict(launches=api_counts, max_abs_vs_table=diff)
    del prog, carry, other, q, k, v, dense, by_dense, by_table
    rep["trace"] = trace("beit", net, spec, cfg, "engine",
                         {"K2 attention": rep["layers"], "K1 dibr_pair": 1})
    want = []
    rep["reference"], cpu_net = reference(BEIT_MODEL, net, cfg, n_frames=2, keep=want)
    # the batched program (phase 46's path): two streams, first then step
    rep["batched_reference"] = batched_reference(
        np, torch, programs, "beit", cfg, net, cpu_net, spec, policy,
        [fam.small, fam.small[::-1]])
    KEPT["f32"][BEIT_MODEL] = dict(net=cpu_net, spec=spec, cfg=cfg, frames=fam.small,
                                   want=want)
    del cpu_net
    out["beit"] = rep

    # -- 35. int8 dpt-beit-large-512 ---------------------------------------------
    net_q, _, _, rep_q, _ = path("beit_int8", BEIT_MODEL, BEIT_RES, BEIT_INPUT, CLASSIC_FRAMES,
                                 biased=True, quant="int8", quant_matmul=6 * 24)
    with torch.inference_mode():
        raw_f = net(model_in)[0].float()
        raw_q = net_q(model_in)[0].float()
    both = torch.stack([raw_f.flatten(), raw_q.flatten()])
    corr = torch.corrcoef(both)[0, 1].item()
    n_quant = sum(isinstance(m, QuantLinear) for m in net_q.modules())
    ok = bool(torch.isfinite(both).all()) and corr >= INT8_MIN_CORR and n_quant == 6 * 24
    log(f"[beit_int8] int8 {BEIT_MODEL} ({n_quant} int8 products) against bf16 on one "
        f"{list(model_in.shape)} model input: correlation {corr:.5f} (min {INT8_MIN_CORR}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("int8 dpt-beit does not track the bf16 model")
    rep_q.update(corr=corr)
    out["beit_int8"] = rep_q
    del net_q, raw_f, raw_q, both, net

    # -- 32./33. dpt-large and dpt-hybrid-midas @384 ------------------------------
    for key, name in (("dpt_large", DPT_LARGE_MODEL), ("dpt_hybrid", HYBRID_MODEL)):
        net, spec, cfg, rep, _ = path(key, name, CLASSIC_RES, CLASSIC_INPUT, CLASSIC_FRAMES)
        rep["reference"], _ = reference(name, net, cfg)
        out[key] = rep
        del net

    # -- 34. dpt-dinov2-giant-kitti @518, and the giant names on the CPU --------
    net, spec, cfg, rep, _ = path("dpt_dinov2", DPT_DINOV2_MODEL, DPT_DINOV2_RES,
                                  DPT_DINOV2_INPUT, CLASSIC_FRAMES)
    rep["reference"], cpu_net = reference(DPT_DINOV2_MODEL, net, cfg)
    del net
    torch.cuda.empty_cache()
    sweep = {}
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (1, 56, 84, 3), dtype=np.float32))
    for name in ("dpt-dinov2-giant-kitti", "dpt-dinov2-giant-nyu"):
        for quant in ("none", "int8"):
            t0 = time.perf_counter()
            if (name, quant) == (DPT_DINOV2_MODEL, "none"):
                m = cpu_net  # the reference's CPU model
            else:
                m, _ = build_bound(name, device="cpu", seed=SEED, quant=quant)
            with torch.inference_mode():
                d = m(x)
            n_quant = sum(isinstance(mm, QuantLinear) for mm in m.modules())
            ok = (tuple(d.shape) == (1, 64, 96) and bool(torch.isfinite(d).all())
                  and n_quant == (0 if quant == "none" else 4 * 40))
            sweep[f"{name} {quant}"] = dict(s=time.perf_counter() - t0, int8_products=n_quant)
            log(f"[dpt_dinov2] build_bound({name!r}, device='cpu', quant={quant!r}): depth "
                f"{list(d.shape)} finite on a 56x84 input, {n_quant} int8 products "
                f"{'ok' if ok else 'FAIL'} ({sweep[f'{name} {quant}']['s']:.1f} s on the host)")
            if not ok:
                raise AssertionError(f"{name} quant={quant}: build or output off")
            del m
    # the giant's weights (this seed's draw, as the card's model holds them)
    # for the multi-GPU phase 55
    KEPT["giant"] = {k: v.to(torch.bfloat16) for k, v in cpu_net.state_dict().items()}
    cpu_net = None
    rep["cpu_builds"] = sweep
    out["dpt_dinov2"] = rep

    # -- 36. the CLI with --model dpt-beit-large-512 -------------------------------
    run = CliRun(counters)
    rc = run(["--settings", str(cli_settings(out_dir, BEIT_MODEL, BEIT_RES, "cli_beit.yaml")),
              "--source", "synthetic", "--size", f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}",
              "--sink", "null", "--frames", str(FRAMES),
              "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"])
    _, program, sink, _ = run.parts
    eng = run.engine
    ok = (rc == 0 and sink.frames >= 1 and sink.last_shape == shape
          and program.cfg.model_name == BEIT_MODEL and program.cfg.depth_resolution == BEIT_RES)
    log(f"[cli] python -m desktop2stereo_tpu_torch.cli --settings (dpt-beit-large-512 @512, "
        f"Half-SBS) --source synthetic --size {FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} --sink null "
        f"--frames {FRAMES}: exit {rc}; {eng.frames} frames run, {sink.frames} delivered "
        f"{sink.last_shape} {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("cli with --model dpt-beit-large-512: exit code or output off")
    out["cli"] = dict(rc=rc, frames_run=eng.frames, delivered=sink.frames,
                      launches=run.check_launches("beit", 24, CLI_WARM_FRAMES, biased=True))
    del run, program, sink, eng

    # -- 37. a real-shape dpt-beit-base-384 checkpoint ---------------------------------
    import tempfile

    from desktop2stereo_tpu_torch.core.registry import get_spec
    from desktop2stereo_tpu_torch.models import safetensors_io

    ckpt_spec = get_spec(BEIT_CKPT_MODEL)
    with tempfile.TemporaryDirectory(prefix="d2s_smoke_beit_") as tmp:
        path_ = Path(tmp) / "model.safetensors"
        arrays = beit_hf_arrays(np, ckpt_spec, SEED + 9)
        safetensors_io.save_file(arrays, path_)
        t0 = time.perf_counter()
        on_card, _ = build_bound(BEIT_CKPT_MODEL, device=dev, dtype=torch.float32,
                                 checkpoint=str(path_))
        load_s = time.perf_counter() - t0
        on_cpu, _ = build_bound(BEIT_CKPT_MODEL, device="cpu", checkpoint=str(path_))
        card_sd = {k: v.cpu() for k, v in on_card.state_dict().items()}
        cpu_sd = on_cpu.state_dict()
        table = "backbone.layer.3.relative_position_bias.relative_position_bias_table"
        ok = (set(card_sd) == set(cpu_sd) and all(torch.equal(card_sd[k], cpu_sd[k])
                                                  for k in cpu_sd)
              and torch.equal(cpu_sd[table], torch.from_numpy(arrays[
                  "backbone.encoder.layer.3.attention.attention.relative_position_bias."
                  "relative_position_bias_table"].astype(np.float32))))
        params = int(sum(a.size for a in arrays.values()))
        log(f"[checkpoint] {BEIT_CKPT_MODEL}, {params} parameters as F16 "
            f"({path_.stat().st_size / 1e6:.1f} MB, HF naming): build_bound on the card "
            f"{load_s:.2f} s; {len(card_sd)} tensors equal to the CPU load, a bias table equal "
            f"to the written one {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("beit checkpoint: the card's load differs from the CPU's")
        del on_card, on_cpu, card_sd, cpu_sd
        run = CliRun(counters)
        rc = run(["--settings", str(cli_settings(out_dir)), "--model", BEIT_CKPT_MODEL,
                  "--depth-res", str(CLASSIC_RES), "--checkpoint", str(path_),
                  "--source", "synthetic", "--size", f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}",
                  "--sink", "null", "--frames", str(FRAMES),
                  "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"])
    _, _, sink, _ = run.parts
    eng = run.engine
    ok = rc == 0 and sink.frames >= 1 and sink.last_shape == shape
    log(f"[checkpoint] python -m desktop2stereo_tpu_torch.cli --model {BEIT_CKPT_MODEL} "
        f"--depth-res {CLASSIC_RES} --checkpoint <file> --source synthetic --size "
        f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} --sink null --frames {FRAMES}: exit {rc}; "
        f"{eng.frames} frames run, {sink.frames} delivered {sink.last_shape} "
        f"{'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("cli with the beit checkpoint: exit code or output off")
    out["checkpoint"] = dict(params=params, load_s=load_s, rc=rc, frames_run=eng.frames,
                             launches=run.check_launches("beit checkpoint", 12,
                                                         CLI_WARM_FRAMES, biased=True))
    out["paths"] = {k: paths[k] for k in ("beit", "beit_int8", "dpt_large", "dpt_hybrid",
                                          "dpt_dinov2")}
    return out


ZOE_MODEL, ZOE_RES, ZOE_INPUT = "zoedepth-nyu-kitti", 512, (288, 512)  # 18 x 32 + 1 tokens
ZOE_CLI_MODEL, ZOE_CLI_RES = "zoedepth-nyu", 384  # 14 x 24 + 1: the table entry's other grid
ZOE_GRIDS = ((18, 32), (14, 24))
DEPTHPRO_MODEL, DEPTHPRO_RES = "DepthPro-Large", 1536
DEPTHPRO_ATTN_SHAPE = (35, 730, 16, 64)  # 1 + 9 + 25 tiles of 27² + 1 tokens
# the int8 towers' products: the patch encoder's 35 x 730 rows and the image
# encoder's 730, (name, K, F) as VIT_L_DENSE
DEPTHPRO_ROWS = (35 * 730, 730)
INFINI_MODEL, INFINI_RES, INFINI_INPUT = "InfiniDepth-Large", 512, (288, 512)
INFINI_ATTN_SHAPE = (1, 581, 16, 64)  # 18 x 32 patch tokens + cls + 4 storage tokens
INFINI_CLI_MODEL = "InfiniDepth-SmallPlus"
LAST_CLI_SECONDS = 3.0


def last_families_phases(np, torch, F, programs, build_bound, drive, driven, trace, paths,
                         frames, counters, policy, dev, card, out_dir, timing, worst):
    """38-40: ZoeDepth, DepthPro and InfiniDepth at 4K Half-SBS (the fused
    tail), each with exact launches: K2 at their new shapes against its
    plain version, K4 exact at DepthPro's 25 550 rows, the int8 forms against
    bf16, the carries, the peaks, the CLI."""
    from desktop2stereo_tpu_torch.models import beit as D_BEIT
    from desktop2stereo_tpu_torch.models import infinidepth as D_INF
    from desktop2stereo_tpu_torch.ops.kernels import attention as K2
    from desktop2stereo_tpu_torch.ops.kernels import quant_matmul as K4
    from desktop2stereo_tpu_torch.ops.quant import QuantLinear

    started = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 38)
    fam = FamilyPaths(np, torch, programs, build_bound, drive, driven, frames, policy, dev, card)
    out = {}

    def k2_parity(label, key, got, want):
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        worst[key] = max(worst[key], err)
        ok = err <= ATTN_MAX_ABS and got.shape == want.shape
        log(f"[parity] {label}: max abs err {err:.3e} (tol {ATTN_MAX_ABS:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: the kernel disagrees with its plain version")
        return err

    def correlate(key, name, net, net_q, model_in, n_quant, want_quant):
        with torch.inference_mode():
            raw_f = net(model_in)[0].float()
            raw_q = net_q(model_in)[0].float()
        both = torch.stack([raw_f.flatten(), raw_q.flatten()])
        corr = torch.corrcoef(both)[0, 1].item()
        ok = bool(torch.isfinite(both).all()) and corr >= INT8_MIN_CORR and n_quant == want_quant
        log(f"[{key}] int8 {name} ({n_quant} int8 products, want {want_quant}) against bf16 on "
            f"one {list(model_in.shape)} model input: correlation {corr:.5f} (min "
            f"{INT8_MIN_CORR}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"int8 {name} does not track the bf16 model")
        return corr

    def cli(key, model, res, k2, biased=False):
        run = CliRun(counters)
        rc = run(["--settings", str(cli_settings(out_dir)), "--model", model, "--depth-res",
                  str(res), "--source", "synthetic", "--size",
                  f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--sink", "null", "--duration",
                  str(LAST_CLI_SECONDS), "--stop-file", str(out_dir / "stop.request"),
                  "--stats-every", "0"])
        _, program, sink, _ = run.parts
        eng = run.engine
        ok = (rc == 0 and sink.frames >= 1 and sink.last_shape == (*FRAME_SHAPE[:2], 3)
              and program.cfg.model_name == model and program.cfg.depth_resolution == res)
        log(f"[cli] python -m desktop2stereo_tpu_torch.cli --model {model} --depth-res {res} "
            f"--source synthetic --size {FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} --sink null "
            f"--duration {LAST_CLI_SECONDS}: exit {rc}; {eng.frames} frames run, {sink.frames} "
            f"delivered {sink.last_shape} in {run.wall_s:.2f} s, "
            f"{eng.frames / run.wall_s:.2f} frames/s {'ok' if ok else 'FAIL'}; {card}")
        if not ok:
            raise AssertionError(f"cli with --model {model}: exit code or output off")
        return dict(rc=rc, frames_run=eng.frames, delivered=sink.frames, wall_s=run.wall_s,
                    fps=eng.frames / run.wall_s,
                    launches=run.check_launches(key, k2, CLI_WARM_FRAMES, biased=biased))

    # -- 38. zoedepth-nyu-kitti @512: BEiT-L on a 24² window, K2's table entry ----
    net, spec, cfg, rep, _ = fam.path("zoedepth", ZOE_MODEL, ZOE_RES, ZOE_INPUT, CLASSIC_FRAMES,
                                      biased=True)
    with torch.inference_mode():
        prog = programs.ProgramCache(cfg, net, spec, compute_dtype=policy.compute_dtype)
        prog(frames[0])
        prog(frames[1])
        (state,) = prog._states.values()
        carry = state.model
        # the table entry at both grids, on the model's own layer-0 tables
        for gh, gw in ZOE_GRIDS:
            N = gh * gw + 1
            table = D_BEIT.compute_rel_pos_tables(net.backbone, gh, gw)[0]
            q, k, v = (torch.randn(1, N, 16, 64, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(3))
            k2_parity(f"attention_relpos zoedepth {gh}x{gw} [1,{N},16,64] + its layer-0 table "
                      f"{list(table.shape)} {str(table.dtype)[6:]} (R = "
                      f"{K2.relative_position_count(gh, gw)}, "
                      f"{K2.relpos_smem_bytes(N, table.shape[1])} B shared)",
                      "attention_relpos", K2.attention_relpos(q, k, v, table, gh, gw),
                      K2.attention_relpos_ref(q.float(), k.float(), v.float(), table, gh, gw))
    R = K2.relative_position_count(*ZOE_GRIDS[0])
    head_dtypes = {p.dtype for p in net.metric_head.parameters()}
    carry_mb = sum(t.numel() * t.element_size() for t in carry) / 1e6
    ok = (len(carry) == 24 and all(t.shape == (16, R) and t.dtype == policy.compute_dtype
                                   for t in carry) and head_dtypes == {torch.float32})
    log(f"[zoedepth] carry: {len(carry)} tables {list(carry[0].shape)} "
        f"{str(carry[0].dtype)[6:]}, {carry_mb:.3f} MB; the metric head's parameters "
        f"{sorted(str(d)[6:] for d in head_dtypes)} under a {str(policy.compute_dtype)[6:]} "
        f"trunk {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("zoedepth: carry or metric head dtype off")
    rep.update(carry_mb=carry_mb, carry_tensors=len(carry))
    del prog, state, carry
    rep["trace"] = trace("zoedepth", net, spec, cfg, "engine",
                         {"K2 attention": 24, "K1 dibr_pair": 1})
    rep["reference"], _ = fam.reference(ZOE_MODEL, net, cfg)
    out["zoedepth"] = rep
    del net
    out["zoedepth_cli"] = cli("zoedepth cli", ZOE_CLI_MODEL, ZOE_CLI_RES, 24, biased=True)

    # -- 39. DepthPro-Large @1536: 35 tiles through one ViT-L, K2 at batch 35 -----
    B, N, H, D = DEPTHPRO_ATTN_SHAPE
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t_.unflatten(-1, (H, D)) for t_ in qkv.split(H * D, dim=-1))
    with torch.inference_mode():
        k2_parity(f"attention {list(DEPTHPRO_ATTN_SHAPE)} qkv views (DepthPro's tiles)",
                  "attention", K2.attention(q, k, v),
                  K2.attention_ref(q.float(), k.float(), v.float()))
        qc, kc, vc = (t_.contiguous() for t_ in (q, k, v))
        k2_parity(f"attention {list(DEPTHPRO_ATTN_SHAPE)} contiguous", "attention",
                  K2.attention(qc, kc, vc), K2.attention_ref(qc.float(), kc.float(), vc.float()))
    qh, kh, vh = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))
    t = time_both(torch, {"plain": lambda: K2.attention_ref(q, k, v),
                          "kernel": lambda: K2.attention(q, k, v),
                          "library": lambda: F.scaled_dot_product_attention(qh, kh, vh)})
    timing["attention_b35"] = dict(t, shape=f"{list(DEPTHPRO_ATTN_SHAPE)} bf16 qkv views",
                                   bound=bound_ms(policy.name, 4 * B * N * H * D * 2,
                                                  4 * B * H * N * N * D, "bf16"))
    log_timing("attention_b35", timing["attention_b35"], card)
    del qkv, q, k, v, qc, kc, vc, qh, kh, vh
    torch.cuda.empty_cache()

    net, spec, cfg, rep, model_in = fam.path("depthpro", DEPTHPRO_MODEL, DEPTHPRO_RES,
                                             (DEPTHPRO_RES, DEPTHPRO_RES), CLASSIC_FRAMES, k2=48)
    rep["trace"] = trace("depthpro", net, spec, cfg, "engine",
                         {"K2 attention": 48, "K1 dibr_pair": 1})
    # the same model in f32 on the CPU: one full 1536² forward, 35 tiles
    rep["reference"], _ = fam.reference(DEPTHPRO_MODEL, net, cfg)
    out["depthpro"] = rep

    # K4 at the int8 towers' shapes, exactly, and timed at 25 550 rows
    for rows in DEPTHPRO_ROWS:
        for name, kin, fout in VIT_L_DENSE:
            args = dense_inputs(np, torch, dev, rows, kin, fout, torch.bfloat16, True,
                                seed=rows + kin + fout)
            got, want = K4.quant_dense(*args), K4.quant_dense_ref(*args)
            torch.cuda.synchronize()
            err = (got.double() - want.double()).abs().max().item()
            worst["quant_matmul"] = max(worst["quant_matmul"], err)
            ok = got.shape == want.shape and err <= QUANT_MAX_ABS
            log(f"[parity] quant_matmul DepthPro {name} [{rows},{kin}]x[{kin},{fout}] bf16 + "
                f"bias: max abs err {err:.3e} (tol {QUANT_MAX_ABS}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"quant_matmul at DepthPro's {name}: kernel disagrees")
            if rows != DEPTHPRO_ROWS[0]:
                continue
            x, wq, scale, bias = args
            xq8 = x.float().clamp(-127, 127).round().to(torch.int8)
            wt = wq.t()
            t = time_both(torch, {"plain": lambda: K4.quant_dense_ref(x, wq, scale, bias),
                                  "kernel": lambda: K4.quant_dense(x, wq, scale, bias),
                                  "library": lambda: torch._int_mm(xq8, wt)})
            timing[f"quant_matmul_depthpro_{name}"] = dict(
                t, shape=f"{name} [{rows},{kin}] bf16 x [{fout},{kin}] int8 + bias",
                bound=bound_ms(policy.name, 2 * rows * kin + fout * kin + 8 * fout
                               + 2 * rows * fout, 2 * rows * kin * fout, "int8"))
            log_timing(f"quant_matmul_depthpro_{name}", timing[f"quant_matmul_depthpro_{name}"],
                       card)
            del x, wq, scale, bias, xq8, wt
            torch.cuda.empty_cache()
        del args, got, want
    net_q, _, _, rep_q, _ = fam.path("depthpro_int8", DEPTHPRO_MODEL, DEPTHPRO_RES,
                                     (DEPTHPRO_RES, DEPTHPRO_RES), CLASSIC_FRAMES, k2=48,
                                     quant="int8", quant_matmul=192)
    rep_q["corr"] = correlate("depthpro_int8", DEPTHPRO_MODEL, net, net_q, model_in,
                              sum(isinstance(m, QuantLinear) for m in net_q.modules()), 192)
    out["depthpro_int8"] = rep_q
    del net, net_q, model_in
    torch.cuda.empty_cache()

    # -- 40. InfiniDepth-Large @512: DINOv3 + RoPE, 5 prefix tokens; SmallPlus CLI --
    B, N, H, D = INFINI_ATTN_SHAPE
    with torch.inference_mode():
        qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (t_.unflatten(-1, (H, D)) for t_ in qkv.split(H * D, dim=-1))
        sin, cos = D_INF._rope_on(D, 18, 32, dev, torch.bfloat16)
        q, k = D_INF.rope_apply(q, sin, cos), D_INF.rope_apply(k, sin, cos)
        k2_parity(f"attention {list(INFINI_ATTN_SHAPE)} RoPE'd q/k (fresh), v a qkv view "
                  f"(InfiniDepth)", "attention", K2.attention(q, k, v),
                  K2.attention_ref(q.float(), k.float(), v.float()))
        del qkv, q, k, v
    net, spec, cfg, rep, model_in = fam.path("infinidepth", INFINI_MODEL, INFINI_RES,
                                             INFINI_INPUT, CLASSIC_FRAMES)
    stem = {p.dtype for p in net.basic_encoder.parameters()}
    if stem != {torch.float32}:
        raise AssertionError(f"infinidepth: the conv stem runs in {stem}, not float32")
    rep["trace"] = trace("infinidepth", net, spec, cfg, "engine",
                         {"K2 attention": 24, "K1 dibr_pair": 1})
    rep["reference"], _ = fam.reference(INFINI_MODEL, net, cfg)
    out["infinidepth"] = rep
    net_q, _, _, rep_q, _ = fam.path("infinidepth_int8", INFINI_MODEL, INFINI_RES, INFINI_INPUT,
                                     CLASSIC_FRAMES, quant="int8", quant_matmul=96)
    rep_q["corr"] = correlate("infinidepth_int8", INFINI_MODEL, net, net_q, model_in,
                              sum(isinstance(m, QuantLinear) for m in net_q.modules()), 96)
    out["infinidepth_int8"] = rep_q
    del net, net_q, model_in
    torch.cuda.empty_cache()
    out["infinidepth_cli"] = cli("infinidepth cli", INFINI_CLI_MODEL, INFINI_RES, 12)
    out["paths"] = {k: paths[k] for k in ("zoedepth", "depthpro", "depthpro_int8",
                                          "infinidepth", "infinidepth_int8")}
    out["wall_s"] = time.perf_counter() - started
    log(f"[last families] phases 38-40 in {out['wall_s']:.1f} s of wall time, builds and "
        f"host references included; {card}")
    return out


# ---- 41-48: multi-stream serving, the profiler and the build tools -----------

STREAMS = 2
MULTI_FRAMES = 30         # frames a stream through the round-robin and batched engines
MULTI_STEPS = 10          # steps of the batched int8, VDA, BEiT and generic paths
MULTI_CLI_SECONDS = 10.0
PROFILE_CLI_SECONDS = 3.0
PLAIN_RUNS = 5            # timed samples of phase 41's plain version


class StreamSource(SaturatingSource):
    """A SaturatingSource for stream `idx` of a multi-stream engine: the next
    frame as soon as the engine took that stream's previous one."""

    def __init__(self, frames, count: int, idx: int) -> None:
        super().__init__(frames, count)
        self.idx = idx

    def grab(self):
        if self.sent == self.count:
            return None
        if not self.engine.streams[self.idx].raw.wait_taken(timeout=120.0):
            raise TimeoutError(f"the engine took no frame of stream {self.idx} for 120 s")
        frame = self.frames[self.sent % len(self.frames)]
        self.sent += 1
        return frame


class CountedProgram:
    """A program that counts its calls (a batched engine's steps)."""

    def __init__(self, program) -> None:
        self.program, self.calls = program, 0
        self.device, self.stateful = program.device, program.stateful

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.program(*args, **kw)


def run_streams(engine_cls, program, frame_sets, counters, n_frames, shape):
    """Counts to 0, `n_frames` a stream through a multi-stream engine of
    saturating sources into checking null sinks, counts read: (per-stream
    frames/s over the wall time, the engine's stats, counts, the sinks)."""
    sources = [StreamSource(fs, n_frames, i) for i, fs in enumerate(frame_sets)]
    sinks = [CheckingNullSink(shape) for _ in frame_sets]
    engine = engine_cls(sources, program, sinks, target_fps=0.0)
    for s in sources:
        s.engine = engine
    zero_counts(counters)
    t0 = time.perf_counter()
    stats = engine.run(duration=600.0)
    wall_s = time.perf_counter() - t0
    counts = read_counts(counters)
    for st, sink in zip(engine.streams, sinks):
        if st.frames != n_frames or sink.count + st.out.dropped != n_frames:
            raise AssertionError(f"stream {st.idx}: {st.frames} frames run, {sink.count} "
                                 f"delivered, {st.out.dropped} superseded; want {n_frames}")
    return [n_frames / wall_s] * len(frame_sets), stats, counts, wall_s


def check_counts(name, counts, want, per):
    """Each kernel's launches against `want` (kernel → launches a frame or a
    step) times `per`; the others none."""
    log(f"[{name}] launches " + ", ".join(
        f"{k} {n} (want {want.get(k, 0) * per})" for k, n in counts.items()))
    if any(counts[k] != want.get(k, 0) * per for k in counts):
        raise AssertionError(f"{name}: a kernel was not launched as the path needs")


def batched_reference(np, torch, programs, name, cfg, card_net, cpu_net, spec, policy, steps):
    """Each row of each batched step (S = 2 small frames, `steps` a list of
    frame pairs) on the card (bf16) against the single-stream program on the
    card on that row's frames, and against the CPU's f32 single-stream
    programs (one a stream), both at phase 6's thresholds."""
    card_b = programs.BatchedProgramCache(cfg, card_net, spec,
                                          compute_dtype=policy.compute_dtype,
                                          num_streams=len(steps[0]))
    card_1 = programs.ProgramCache(cfg, card_net, spec, compute_dtype=policy.compute_dtype)
    cpu_1 = programs.ProgramCache(cfg, cpu_net, spec, compute_dtype=torch.float32)
    out = []
    for t, pair in enumerate(steps):
        rows = [x.cpu() for x in card_b(np.stack(pair))]
        for s, frame in enumerate(pair):
            got = (rows[0][s], rows[1][s])
            single = tuple(x.cpu() for x in card_1(frame, stream=s))
            t0 = time.perf_counter()
            cpu = cpu_1(frame, stream=s)
            cpu_s = time.perf_counter() - t0
            vs_single = ref_stats(torch, name, got, single)
            vs_cpu = ref_stats(torch, name, got, cpu, cpu_s)
            ok = vs_single["ok"] and vs_cpu["ok"]
            log(f"[reference] {name} batched S={len(pair)}, step {t} row {s}, 216x384: against "
                f"the card's single-stream program depth mean {vs_single['depth_mean_abs']:.4f}, "
                f"sbs mean {vs_single['sbs_mean_lsb']:.3f} LSB; against CPU f32 depth mean "
                f"{vs_cpu['depth_mean_abs']:.4f} (tol {REF_DEPTH_MEAN_ABS}), sbs "
                f"{tuple(got[0].shape)} mean {vs_cpu['sbs_mean_lsb']:.3f} LSB (tol "
                f"{REF_SBS_MEAN_LSB}), >32 LSB {vs_cpu['sbs_share_over_32']:.2e} (tol "
                f"{REF_SBS_SHARE_OVER_32}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"batched reference {name}: a row disagrees")
            out.append({"step": t, "row": s, "vs_single": vs_single, "vs_cpu": vs_cpu})
    return out


def step_ms(torch, program, batch, runs=TIMED_RUNS):
    """Device ms of one batched step (CUDA events around the program call,
    host launch gaps included), median of `runs` after 3 warm ones."""
    times = []
    with torch.inference_mode():
        for i in range(runs + 3):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            program(batch)
            b.record()
            b.synchronize()
            if i >= 3:
                times.append(a.elapsed_time(b))
    program.reset()
    return statistics.median(times)


def k1_stream_axis(np, torch, K1, policy, card, timing, worst):
    """41. K1 over a stream axis of STREAMS frames at the 4K eye (Half-SBS)
    and the 4K frame (eyes): bit-equal to STREAMS one-frame launches, timed
    device-only and eager beside the one-frame launches, the plain version
    and the bound (STREAMS times one frame's bytes and operations)."""
    dev = policy.device
    rng = np.random.default_rng(41)
    dkw = dict(ipd=IPD, depth_strength=STRENGTH, convergence=0.01)
    out = {}
    for key, (h, w), eyes in (("dibr_pair_half_s2", EYE, False),
                              ("dibr_pair_eyes_s2", FULL, True)):
        rgb = torch.from_numpy(rng.random((STREAMS, 3, h, w), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((STREAMS, h, w), dtype=np.float32)).to(dev)
        if eyes:
            batched = lambda: K1.dibr_pair_eyes(rgb, dep, **dkw)  # noqa: E731
            singles = lambda: [K1.dibr_pair_eyes(rgb[s], dep[s], **dkw)  # noqa: E731
                               for s in range(STREAMS)]
            plain = lambda: K1.dibr_pair_eyes_ref(rgb, dep, **dkw)  # noqa: E731
            got, one = batched(), singles()
            err = max((g[s] - o).abs().max().item()
                      for s in range(STREAMS) for g, o in zip(got, one[s]))
            equal = all(torch.equal(g[s], o) for s in range(STREAMS) for g, o in zip(got, one[s]))
            out_bytes = 2 * 3 * 4
        else:
            batched = lambda: K1.dibr_pair_half(rgb, dep, feather=0.0, **dkw)  # noqa: E731
            singles = lambda: [K1.dibr_pair_half(rgb[s], dep[s], feather=0.0, **dkw)  # noqa: E731
                               for s in range(STREAMS)]
            plain = lambda: K1.dibr_pair_half_ref(rgb, dep, feather=0.0, **dkw)  # noqa: E731
            got, one = batched(), singles()
            err = max((got[s].int() - one[s].int()).abs().max().item() for s in range(STREAMS))
            equal = all(torch.equal(got[s], one[s]) for s in range(STREAMS))
            out_bytes = 2 * 3
        torch.cuda.synchronize()
        worst[key] = float(err)
        log(f"[parity] K1 stream axis {key} [{STREAMS}, 3, {h}, {w}]: max abs {err} against "
            f"{STREAMS} one-frame launches ({'bit-equal' if equal else 'NOT equal'})")
        if not equal:
            raise AssertionError(f"{key}: the stream axis is not bit-equal to one-frame launches")
        t = time_both(torch, {"kernel": batched, "singles": singles})
        # the plain version (20-40 ms a call) over PLAIN_RUNS samples
        t["plain"] = time_calls(torch, {"plain": plain}, runs=PLAIN_RUNS, graph=True)["plain"]
        t["eager"]["plain"] = time_calls(torch, {"plain": plain}, runs=PLAIN_RUNS)["plain"]
        px = STREAMS * h * w
        timing[key] = dict(t, library=None,
                           shape=f"[{STREAMS}, 3, {h}, {w}] {'eyes f32' if eyes else 'Half-SBS'}",
                           bound=bound_ms(policy.name, (4 * 4 + out_bytes) * px,
                                          OPS_PER_PX["dibr_pair"] * px, "f32"))
        tm = timing[key]
        log(f"[time] {key}: one launch over {STREAMS} frames {tm['kernel']:.4f} ms (eager "
            f"{tm['eager']['kernel']:.4f}), {STREAMS} one-frame launches {tm['singles']:.4f} "
            f"(eager {tm['eager']['singles']:.4f}), plain {tm['plain']:.4f} (median of "
            f"{PLAIN_RUNS}; eager {tm['eager']['plain']:.4f}), bound "
            f"{tm['bound'][0]:.4f} ({tm['bound'][1]}) ms (CUDA graphs of 10 calls; {card})")
        out[key] = {k: tm[k] for k in ("kernel", "singles", "plain", "bound", "eager")}
        del rgb, dep, got, one
    torch.cuda.empty_cache()
    return out


class CliMultiRun(CliRun):
    """CliRun for `--streams N`: records the multi-stream engine as CliRun
    records the FrameEngine."""

    def __call__(self, argv):
        from desktop2stereo_tpu_torch.pipeline import multi

        run = self
        classes = multi.MultiStreamEngine, multi.BatchedStreamEngine

        def recording(cls):
            class Recording(cls):
                def start(self) -> None:
                    run.engine = self
                    run.warm_counts = read_counts(run.counters)
                    self.started_at = time.perf_counter()
                    super().start()
            return Recording

        multi.MultiStreamEngine, multi.BatchedStreamEngine = map(recording, classes)
        try:
            return super().__call__(argv)
        finally:
            multi.MultiStreamEngine, multi.BatchedStreamEngine = classes


def cli_multi_phases(np, counters, layers, card, out_dir):
    """47. `cli.run --streams 2` and `--streams 2 --batched` for
    MULTI_CLI_SECONDS on the flagship settings file (4K synthetic sources
    with seeds 0 and 1, null sinks): exit 0, each stream's frames and shape,
    one K1 and `layers` K2 a frame run (round-robin) or a step (batched) in
    the warm-up and the run; per-stream frames/s.  Then `--profile-dir` on
    the flagship for PROFILE_CLI_SECONDS: the trace holds K2's and K1's
    kernels and the frame program's d2s.* ranges."""
    import shutil

    base = ["--settings", str(cli_settings(out_dir)), "--source", "synthetic",
            "--size", f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--sink", "null",
            "--stop-file", str(out_dir / "stop.request"), "--stats-every", "0"]
    want_shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    out = {}
    for name, extra in (("streams", ["--streams", str(STREAMS)]),
                        ("batched", ["--streams", str(STREAMS), "--batched"])):
        run = CliMultiRun(counters)
        rc = run(base + extra + ["--duration", str(MULTI_CLI_SECONDS)])
        eng = run.engine
        sinks = [st.sink for st in eng.streams]
        frames = [st.frames for st in eng.streams]
        if rc != 0 or any(s.frames < 1 or s.last_shape != want_shape for s in sinks):
            raise AssertionError(f"cli {name}: rc {rc}, delivered "
                                 f"{[(s.frames, s.last_shape) for s in sinks]}")
        run_counts = {n: run.counts[n] - run.warm_counts[n] for n in run.counts}
        # round-robin: a K1 a frame run; batched: a K1 a step
        steps = run_counts["dibr_pair"]
        ok = (run.warm_counts["dibr_pair"] == CLI_WARM_FRAMES
              and run.warm_counts["attention"] == layers * CLI_WARM_FRAMES
              and run_counts["attention"] == layers * steps
              and (steps == sum(frames) if name == "streams" else steps >= max(frames))
              and all(c == 0 for n, c in run_counts.items()
                      if n not in ("attention", "dibr_pair")))
        fps = [f / run.wall_s for f in frames]
        log(f"[cli] {name}: python -m desktop2stereo_tpu_torch.cli --settings (DA-V2-Large "
            f"@518, Half-SBS) --source synthetic --size {FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} "
            f"--sink null {' '.join(extra)} --duration {MULTI_CLI_SECONDS:g}: exit {rc}; frames "
            f"a stream {frames}, delivered {[s.frames for s in sinks]}; frames/s a stream "
            + ", ".join(f"{v:.2f}" for v in fps) + f", total {sum(fps):.2f} (over "
            f"{run.wall_s:.2f} s); launches in the warm-up {run.warm_counts}, in the run "
            f"{run_counts} ({steps} {'frames' if name == 'streams' else 'steps'}) "
            f"{'ok' if ok else 'FAIL'}; {card}")
        if not ok:
            raise AssertionError(f"cli {name}: a kernel was not launched as the path needs")
        out[name] = dict(rc=rc, frames=frames, delivered=[s.frames for s in sinks],
                         fps=fps, total_fps=sum(fps), wall_s=run.wall_s, steps=steps,
                         launches={"warmup": run.warm_counts, "run": run_counts})

    trace_dir = out_dir / "cli_profile"
    shutil.rmtree(trace_dir, ignore_errors=True)
    run = CliRun(counters)
    rc = run(base + ["--duration", str(PROFILE_CLI_SECONDS), "--profile-dir", str(trace_dir)])
    files = sorted(trace_dir.glob("*.json"))
    if rc != 0 or len(files) != 1:
        raise AssertionError(f"cli --profile-dir: rc {rc}, trace files {files}")
    size_mb = files[0].stat().st_size / 1e6
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1 = sum("dibr_pair_kernel" in k for k in kernels)
    k2 = sum("attention_fwd_kernel" in k for k in kernels)
    ranges = {}
    for e in events:
        if str(e.get("name", "")).startswith("d2s.") and e.get("cat") == "user_annotation":
            ranges[e["name"]] = ranges.get(e["name"], 0) + 1
    frames_run = run.engine.frames
    ok = k1 >= 1 and k2 >= layers and {"d2s.preprocess", "d2s.model", "d2s.tail"} <= set(ranges)
    log(f"[cli] --profile-dir: {frames_run} frames in {PROFILE_CLI_SECONDS:g} s, one Chrome "
        f"trace of {size_mb:.1f} MB with {len(kernels)} kernels, K1 dibr_pair_kernel {k1}, K2 "
        f"attention_fwd_kernel {k2}, ranges {ranges} {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("cli --profile-dir: the trace lacks K1, K2 or the d2s.* ranges")
    shutil.rmtree(trace_dir)  # the counts are kept, not the trace
    out["profile"] = dict(rc=rc, frames=frames_run, trace_mb=size_mb, kernels=len(kernels),
                          k1=k1, k2=k2, ranges=ranges)
    return out


def tools_phase(card, out_dir):
    """48. `tools/aot_compile.py` for 2160x3840 in a process of its own with
    an empty build directory: the five kernel sources' nvcc seconds and the
    warm seconds; `tools/depth_visualize.py` on assets/golden.png on the card
    in this process."""
    import io
    import os
    import re
    import shutil
    from contextlib import redirect_stdout

    from desktop2stereo_tpu_torch.tools import depth_visualize

    build_dir = out_dir / "aot_build"
    shutil.rmtree(build_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "desktop2stereo_tpu_torch.tools.aot_compile", "--model",
           FLAGSHIP_MODEL, "--depth-res", "518", "--shapes",
           f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--output-resolution", str(FRAME_SHAPE[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900,
                          env=dict(os.environ, D2S_BUILD_DIR=str(build_dir)))
    wall_s = time.perf_counter() - t0
    shutil.rmtree(build_dir, ignore_errors=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[aot]")]
    nvcc = {m.group(1): float(m.group(2))
            for m in re.finditer(r"(\w+\.cu) nvcc ([0-9.]+)s", proc.stdout)}
    warm = re.search(rf"\[aot\] {FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}: warm in ([0-9.]+)s",
                     proc.stdout)
    ok = proc.returncode == 0 and len(nvcc) == 5 and warm is not None
    log(f"[tools] {' '.join(cmd[2:])} (empty build directory), exit {proc.returncode} in "
        f"{wall_s:.1f} s: " + " | ".join(lines) + f" {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError(f"aot_compile failed:\n{proc.stdout}\n{proc.stderr}")
    buf = io.StringIO()
    vis_out = out_dir / "depth_vis" / "golden"
    with redirect_stdout(buf):
        depth_visualize.main([str(ROOT / "assets" / "golden.png"), "--model", FLAGSHIP_MODEL,
                              "--depth-res", "518", "--out", str(vis_out)])
    m = re.search(r"shape=\((\d+), (\d+)\) min=([-0-9.]+) max=([-0-9.]+) mean=([-0-9.]+)",
                  buf.getvalue())
    png = vis_out.with_name(vis_out.name + "_depth.png")
    ok = m is not None and png.exists() and 0.0 <= float(m.group(3)) <= float(m.group(4)) <= 1.0
    log(f"[tools] depth_visualize assets/golden.png --model {FLAGSHIP_MODEL} --depth-res 518 "
        f"on the card: {m.group(0) if m else buf.getvalue()} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("depth_visualize did not print its stats or write its PNG")
    shutil.rmtree(vis_out.parent)
    return dict(aot=dict(rc=proc.returncode, wall_s=wall_s, nvcc_s=nvcc,
                         warm_s=float(warm.group(1)), lines=lines),
                depth_visualize=dict(shape=[int(m.group(1)), int(m.group(2))],
                                     min=float(m.group(3)), max=float(m.group(4)),
                                     mean=float(m.group(5))))


def multi_stream_phases(np, torch, programs, build_bound, counters, frames, policy, dev, card,
                        out_dir, timing, worst):
    """41-48: K1's stream axis; DA-V2-Large @518 on two 4K streams through
    MultiStreamEngine (round-robin) and BatchedStreamEngine beside one
    stream's FrameEngine; the batched generic tails; batched int8, VDA-Large
    (a stale row a step in two) and dpt-beit-large-512; the CLI's
    `--streams`, `--batched` and `--profile-dir`; the two build tools."""
    from desktop2stereo_tpu_torch.ops.kernels import dibr as K1
    from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine
    from desktop2stereo_tpu_torch.pipeline.multi import BatchedStreamEngine, MultiStreamEngine

    started = time.perf_counter()
    out = {"k1_stream_axis": k1_stream_axis(np, torch, K1, policy, card, timing, worst)}
    paths = {}
    feeds = [frames, synthetic_frames(np, 4, FRAME_SHAPE[0], FRAME_SHAPE[1], SEED + 7)]
    shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    batch = torch.from_numpy(np.stack([feeds[0][0], feeds[1][0]])).to(dev)

    # -- 42. the flagship on one stream, then two round-robin ------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, spec = build_bound(FLAGSHIP_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED)
    layers = len(model.backbone.layer)
    cfg = config(programs)
    single = programs.ProgramCache(cfg, model, spec, compute_dtype=policy.compute_dtype)
    single.warmup(FRAME_SHAPE)
    fps1, counts, _ = run_engine(FrameEngine, single, SaturatingSource(frames, MULTI_FRAMES),
                                 CheckingNullSink(shape), counters, MULTI_FRAMES)
    check_counts("single", counts, {"attention": layers, "dibr_pair": 1}, MULTI_FRAMES)
    del single
    rr = programs.ProgramCache(cfg, model, spec, compute_dtype=policy.compute_dtype)
    rr.warmup(FRAME_SHAPE)
    fps, stats, counts, wall_s = run_streams(MultiStreamEngine, rr, feeds, counters,
                                             MULTI_FRAMES, shape)
    check_counts("round_robin", counts, {"attention": layers, "dibr_pair": 1},
                 STREAMS * MULTI_FRAMES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    paths["round_robin"] = dict(fps=fps, total_fps=sum(fps), single_fps=fps1, launches=counts,
                                fps_counter=[s["fps"] for s in stats.values()], wall_s=wall_s,
                                peak_mem_gb=peak, frames=MULTI_FRAMES)
    log(f"[multi] round-robin, {STREAMS} streams of 4K Half-SBS ({FLAGSHIP_MODEL} @518), "
        f"{MULTI_FRAMES} frames each through MultiStreamEngine: frames/s a stream "
        + ", ".join(f"{v:.2f}" for v in fps) + f", total {sum(fps):.2f}; one stream through "
        f"FrameEngine just before {fps1:.2f}; peak device memory {peak:.2f} GB; {card}")
    del rr

    # -- 43. batched: the fused tail, then the generic tails -----------------
    torch.cuda.reset_peak_memory_stats()
    prog = CountedProgram(programs.BatchedProgramCache(cfg, model, spec,
                                                       compute_dtype=policy.compute_dtype,
                                                       num_streams=STREAMS))
    prog.program.warmup(FRAME_SHAPE)
    prog.calls = 0
    fps, stats, counts, wall_s = run_streams(BatchedStreamEngine, prog, feeds, counters,
                                             MULTI_FRAMES, shape)
    check_counts("batched", counts, {"attention": layers, "dibr_pair": 1}, prog.calls)
    step = step_ms(torch, prog.program, batch)
    peak = torch.cuda.max_memory_allocated() / 1e9
    paths["batched"] = dict(fps=fps, total_fps=sum(fps), steps=prog.calls, step_ms=step,
                            launches=counts, fps_counter=[s["fps"] for s in stats.values()],
                            wall_s=wall_s, peak_mem_gb=peak, frames=MULTI_FRAMES)
    log(f"[multi] batched, {STREAMS} streams through BatchedStreamEngine: {MULTI_FRAMES} "
        f"frames a stream in {prog.calls} steps; frames/s a stream "
        + ", ".join(f"{v:.2f}" for v in fps) + f", total {sum(fps):.2f} (round-robin "
        f"{paths['round_robin']['total_fps']:.2f}, one stream {fps1:.2f}); a step "
        f"{step:.3f} ms (CUDA events around the program call, median of {TIMED_RUNS}); peak "
        f"device memory {peak:.2f} GB; {card}")
    del prog
    for key, mode, quality, want in (
            ("batched_generic_high", "Full-SBS", "high", {"attention": layers, "dibr_pair": 1}),
            ("batched_generic_fast", "Half-SBS", "fast",
             {"attention": layers, "warp": 2 * STREAMS})):
        p = programs.BatchedProgramCache(config(programs, mode, quality), model, spec,
                                         compute_dtype=policy.compute_dtype, num_streams=STREAMS)
        p.warmup(FRAME_SHAPE)
        zero_counts(counters)
        t0 = time.perf_counter()
        with torch.inference_mode():
            for t in range(MULTI_STEPS):
                sbs, _ = p(np.stack([feeds[0][t % 4], feeds[1][t % 4]]))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_counts(counters)
        check_counts(key, counts, want, MULTI_STEPS)
        want_shape = (STREAMS, FRAME_SHAPE[0], 2 * FRAME_SHAPE[1] if mode == "Full-SBS"
                      else FRAME_SHAPE[1], 3)
        if tuple(sbs.shape) != want_shape:
            raise AssertionError(f"{key}: output {tuple(sbs.shape)}, want {want_shape}")
        paths[key] = dict(steps=MULTI_STEPS, launches=counts,
                          step_ms=step_ms(torch, p, batch), wall_s=wall_s)
        log(f"[multi] {key} ({mode} {quality}): {MULTI_STEPS} steps of {STREAMS} 4K frames, "
            f"output {want_shape}; a step {paths[key]['step_ms']:.3f} ms; {card}")
        del p

    # -- 44. batched int8: K4 at STREAMS x 778 rows ----------------------------
    model_q, _ = build_bound(FLAGSHIP_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED,
                             quant="int8")
    with torch.inference_mode():
        fp = programs.FrameProgram(cfg, model, spec, policy.compute_dtype, streams=STREAMS)
        _, model_in = fp.preprocess(batch)
        raw_f, raw_q = model(model_in).float(), model_q(model_in).float()
    corr = [torch.corrcoef(torch.stack([raw_f[s].flatten(), raw_q[s].flatten()]))[0, 1].item()
            for s in range(STREAMS)]
    log(f"[multi] int8 against bf16 at batch {STREAMS} (model input "
        f"{list(model_in.shape)}, K4 at {STREAMS} x {ATTN_SHAPE[1]} rows): correlation a row "
        + ", ".join(f"{c:.5f}" for c in corr) + f" (min {INT8_MIN_CORR})")
    if min(corr) < INT8_MIN_CORR or not torch.isfinite(raw_q).all():
        raise AssertionError("batched int8: a row does not track the bf16 model")
    del fp, model_in, raw_f, raw_q
    prog = CountedProgram(programs.BatchedProgramCache(cfg, model_q, spec,
                                                       compute_dtype=policy.compute_dtype,
                                                       num_streams=STREAMS))
    prog.program.warmup(FRAME_SHAPE)
    prog.calls = 0
    fps, stats, counts, wall_s = run_streams(BatchedStreamEngine, prog, feeds, counters,
                                             MULTI_STEPS, shape)
    check_counts("batched_int8", counts,
                 {"attention": layers, "quant_matmul": 4 * layers, "dibr_pair": 1}, prog.calls)
    paths["batched_int8"] = dict(fps=fps, total_fps=sum(fps), steps=prog.calls, corr=corr,
                                 launches=counts, step_ms=step_ms(torch, prog.program, batch))
    log(f"[multi] batched int8: {MULTI_STEPS} frames a stream in {prog.calls} steps, total "
        f"{sum(fps):.2f} frames/s, a step {paths['batched_int8']['step_ms']:.3f} ms; {card}")
    del prog, model_q, model
    torch.cuda.empty_cache()

    # -- 45. batched VDA-Large: the second row stale every other step ---------
    torch.cuda.reset_peak_memory_stats()
    vda, vda_spec = build_bound(VDA_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED)
    vcfg = config(programs, model=VDA_MODEL)
    prog = programs.BatchedProgramCache(vcfg, vda, vda_spec, compute_dtype=policy.compute_dtype,
                                        num_streams=STREAMS)
    prog.warmup(FRAME_SHAPE)
    zero_counts(counters)
    rows = [feeds[0][0], feeds[1][0]]
    stale_equal, moved = [], []
    t0 = time.perf_counter()
    for t in range(MULTI_STEPS):
        fresh = None if t == 0 else [True, t % 2 == 0]
        for s in range(STREAMS):
            if fresh is None or fresh[s]:
                rows[s] = feeds[s][t % 4]
        before = None if fresh is None else [c[1].clone() for c in
                                             next(iter(prog._states.values())).model]
        prog(np.stack(rows), fresh=fresh)
        carry = next(iter(prog._states.values())).model
        if before is not None:
            same = all(torch.equal(c[1], b) for c, b in zip(carry, before))
            (stale_equal if not fresh[1] else moved).append(same)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts(counters)
    check_counts("batched_vda", counts, {"attention": len(vda.backbone.layer), "dibr_pair": 1},
                 MULTI_STEPS)
    carry_mb = sum(c.numel() * c.element_size() for c in carry) / 1e6
    peak = torch.cuda.max_memory_allocated() / 1e9
    ok = (all(stale_equal) and not any(moved) and len(carry) == 8
          and all(c.shape[0] == STREAMS for c in carry))
    paths["batched_vda"] = dict(steps=MULTI_STEPS, launches=counts, carry_mb=carry_mb,
                                peak_mem_gb=peak, stale_steps=len(stale_equal),
                                stale_rows_bit_equal=all(stale_equal),
                                cache_shapes=[list(c.shape) for c in carry], wall_s=wall_s,
                                step_ms=step_ms(torch, prog, batch))
    log(f"[multi] batched {VDA_MODEL}: {MULTI_STEPS} steps, the second row stale on "
        f"{len(stale_equal)} of them: its caches bit-equal across each stale step "
        f"{all(stale_equal)}, moved on each fresh one {not any(moved)}; the carry 8 caches "
        f"{[list(c.shape) for c in carry][:2]}..., {carry_mb:.1f} MB ({carry_mb / STREAMS:.1f} "
        f"MB a stream); a step {paths['batched_vda']['step_ms']:.3f} ms; peak device memory "
        f"{peak:.2f} GB {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("batched vda: a stale row's caches moved, or the carry is off")
    del prog, vda, carry, before
    torch.cuda.empty_cache()

    # -- 46. batched dpt-beit-large-512: one set of tables, a stale row -------
    torch.cuda.reset_peak_memory_stats()
    beit, beit_spec = build_bound(BEIT_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED)
    bcfg = config(programs, model=BEIT_MODEL, res=512)
    prog = programs.BatchedProgramCache(bcfg, beit, beit_spec,
                                        compute_dtype=policy.compute_dtype, num_streams=STREAMS)
    prog.warmup(FRAME_SHAPE)
    zero_counts(counters)
    rows = [feeds[0][0], feeds[1][0]]
    kept = None
    for t in range(MULTI_STEPS):
        fresh = None if t == 0 else [True, t % 2 == 0]
        for s in range(STREAMS):
            if fresh is None or fresh[s]:
                rows[s] = feeds[s][t % 4]
        prog(np.stack(rows), fresh=fresh)
        carry = next(iter(prog._states.values())).model
        if kept is not None and carry is not kept:
            raise AssertionError("batched beit: the tables were rebuilt or masked")
        kept = carry
    torch.cuda.synchronize()
    counts = read_counts(counters)
    nl = len(beit.backbone.layer)
    check_counts("batched_beit", counts,
                 {"attention": nl, "attention_relpos": nl, "dibr_pair": 1}, MULTI_STEPS)
    carry_mb = sum(c.numel() * c.element_size() for c in kept) / 1e6
    ok = len(kept) == nl and all(c.ndim == 2 and c.shape == kept[0].shape for c in kept)
    paths["batched_beit"] = dict(steps=MULTI_STEPS, launches=counts, carry_mb=carry_mb,
                                 tables=[list(kept[0].shape), str(kept[0].dtype)],
                                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                                 step_ms=step_ms(torch, prog, batch))
    log(f"[multi] batched {BEIT_MODEL}: {MULTI_STEPS} steps with the second row stale on every "
        f"other one, no error; the carry one set of {len(kept)} tables {list(kept[0].shape)} "
        f"{kept[0].dtype}, {carry_mb:.2f} MB for the batch; a step "
        f"{paths['batched_beit']['step_ms']:.3f} ms; peak device memory "
        f"{paths['batched_beit']['peak_mem_gb']:.2f} GB {'ok' if ok else 'FAIL'}; {card}")
    if not ok:
        raise AssertionError("batched beit: the carry is not one set of tables")
    del prog, beit, kept, carry, batch
    torch.cuda.empty_cache()

    # -- 47. the CLI; 48. the tools ---------------------------------------------
    out["cli"] = cli_multi_phases(np, counters, layers, card, out_dir)
    out["tools"] = tools_phase(card, out_dir)
    out["paths"] = paths
    out["seconds"] = time.perf_counter() - started
    log(f"[multi] phases 41-48 took {out['seconds']:.1f} s")
    return out


# The XR client (phases 49-51): the flagship's model-resolution depth as the
# xr sink serves it, the stage timings' samples, and the client's runs
XR_DEPTH = (294, 518)
XR_TIMED = 10
XR_E2E_FRAMES = 5
XR_THEATER_FRAMES = 3
XR_THEATER_SIZE = (480, 270)
XR_SERVER_UP_S = 300.0


def xr_depth(np, rng, h, w):
    """A seeded [h, w] f32 depth in [0, 1]: a slope, two near objects, noise."""
    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w], np.float32)[:, None, None]
    d = (0.25 + 0.4 * xx + 0.3 * (((xx - 0.3) ** 2 + (yy - 0.5) ** 2) < 0.02)
         + 0.2 * (((xx - 0.7) ** 2 + (yy - 0.4) ** 2) < 0.01))
    return np.clip(d + rng.normal(0, 0.01, (h, w)), 0.0, 1.0).astype(np.float32)


def png_frames(np, path):
    from PIL import Image

    return [np.array(Image.open(p)) for p in sorted(path.glob("frame_*.png"))]


class XrServer:
    """The port's CLI serving `--sink xr --port 0` in a process of its own;
    `port` is read from its "streaming at tcp://HOST:PORT" line, and `stop()`
    ends it through its stop file (killed if it outlasts the wait)."""

    def __init__(self, argv, out_dir) -> None:
        import os
        import re
        import threading

        self.stop_file = out_dir / "xr_server.stop"
        self.stop_file.unlink(missing_ok=True)
        self.lines, self.port = [], None
        found = threading.Event()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "desktop2stereo_tpu_torch.cli", *argv, "--stop-file",
             str(self.stop_file)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p)))

        def read():
            for line in self.proc.stdout:
                self.lines.append(line.rstrip())
                m = re.search(r"streaming at tcp://[^:\s]+:(\d+)", line)
                if m and self.port is None:
                    self.port = int(m.group(1))
                    found.set()
            found.set()

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        if not found.wait(XR_SERVER_UP_S) or self.port is None:
            self.stop()
            raise AssertionError("the xr server never said where it streams:\n"
                                 + "\n".join(self.lines[-30:]))

    def stop(self) -> int:
        self.stop_file.touch()
        try:
            rc = self.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self.reader.join(30)
        return rc


def xr_client_phases(np, torch, counters, card, out_dir, dev, frame_shape=FRAME_SHAPE[:2]):
    """49-51: the port's XR client (`tools/xr_client.py`) on the card."""
    import shutil

    from desktop2stereo_tpu_torch.tools import xr_client as XC

    h, w = frame_shape
    rng = np.random.default_rng(SEED + 49)
    rgb = np.ascontiguousarray(synthetic_frames(np, 1, h, w, SEED + 49)[0][..., 2::-1])
    depth = xr_depth(np, rng, *XR_DEPTH)
    out = {"launches": {}}

    # -- 49. the client's render at 4K on the card, in this process ----------
    cases = (("Full-SBS", 0.0), ("Half-SBS", 0.0), ("Full-SBS", 0.1))
    worst = {"lsb": 0, "share": 0.0}
    render = {}
    for mode, roll in cases:
        name = f"{mode} roll {roll}"
        zero_counts(counters)
        got = XC.render_stereo(rgb, depth, IPD, STRENGTH, 0.01, mode=mode, roll=roll,
                               device=dev)
        torch.cuda.synchronize()
        counts = read_counts(counters)
        check_counts(f"xr-client render_stereo {name} at {h}x{w} (depth {XR_DEPTH[0]}x"
                     f"{XR_DEPTH[1]})", counts, {"dibr_fill": 2 if roll == 0.0 else 0}, 1)
        want_shape = (h, 2 * w if mode == "Full-SBS" else w - w % 2, 3)
        if got.dtype != torch.uint8 or tuple(got.shape) != want_shape or got.device != dev:
            raise AssertionError(f"render_stereo {name}: {got.dtype} {tuple(got.shape)} on "
                                 f"{got.device}, want uint8 {want_shape} on {dev}")
        t0 = time.perf_counter()
        ref = XC.render_stereo(rgb, depth, IPD, STRENGTH, 0.01, mode=mode, roll=roll,
                               device="cpu")
        cpu_s = time.perf_counter() - t0
        lsb, share = u8_diff(torch, got.cpu(), ref)
        worst.update(lsb=max(worst["lsb"], lsb), share=max(worst["share"], share))
        check_u8(f"xr client render_stereo {name}, card against --device cpu", lsb, share,
                 f" (the CPU call {cpu_s:.1f} s)")
        render[name] = dict(shape=list(want_shape), lsb=lsb, share=share, cpu_s=cpu_s,
                            counts=counts)
        if roll == 0.0:
            out["launches"][f"xr_render_{mode}"] = counts["dibr_fill"]

    # stage times: CUDA events around one call, median of XR_TIMED, in turns
    rgb_d, dep_d = XC.to_device(rgb, dev), XC.to_device(depth, dev)
    rgb_f = rgb_d.to(torch.float32)
    dep_full = XC._resize_bilinear(dep_d, h, w)
    eyes = [XC.warp_eye(rgb_f, dep_full, e * IPD / 2, STRENGTH, 0.01) for e in (-1, 1)]
    sbs = {m: XC.arrange_sbs(*eyes, m) for m in ("Full-SBS", "Half-SBS")}
    stages = time_calls(torch, {
        "upload_rgb": lambda: XC.to_device(rgb, dev),
        "upload_depth": lambda: XC.to_device(depth, dev),
        "upsample": lambda: XC._resize_bilinear(dep_d, h, w),
        "warp_both_eyes": lambda: [XC.warp_eye(rgb_f, dep_full, e * IPD / 2, STRENGTH, 0.01)
                                   for e in (-1, 1)],
        **{f"arrange_{m}": lambda m=m: XC.arrange_sbs(*eyes, m) for m in sbs},
        **{f"download_{m}": lambda m=m: sbs[m].cpu() for m in sbs},
    }, runs=XR_TIMED, reps=1)
    fps = {}
    for mode in ("Full-SBS", "Half-SBS"):
        XC.render_stereo(rgb, depth, IPD, STRENGTH, 0.01, mode=mode, device=dev).cpu()
        t0 = time.perf_counter()
        for _ in range(XR_TIMED):
            XC.render_stereo(rgb, depth, IPD, STRENGTH, 0.01, mode=mode,
                             device=dev).cpu().numpy()
        fps[mode] = XR_TIMED / (time.perf_counter() - t0)
    del rgb_d, dep_d, rgb_f, dep_full, eyes, sbs
    log(f"[xr-client] render at {h}x{w}, depth {XR_DEPTH[0]}x{XR_DEPTH[1]} (CUDA events "
        f"around one call, median of {XR_TIMED}, the stages in turns): " + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
        + "; render frames/s (numpy frame in, numpy SBS out, host included, "
        f"{XR_TIMED} frames): " + ", ".join(f"{m} {v:.2f}" for m, v in fps.items())
        + f"; {card}")
    out["render"] = dict(cases=render, stages_ms=stages, fps=fps, worst=worst)

    # -- 50. the client end to end against the port's CLI in a process of its own
    server = XrServer(["--settings", str(cli_settings(out_dir)), "--source", "synthetic",
                       "--size", f"{h}x{w}", "--sink", "xr", "--port", "0", "--xr-no-input",
                       "--display-mode", "Mono", "--duration", "900", "--stats-every", "0"],
                      out_dir)
    pushed, push_ms, composed = [], [], []
    png_push, compose = XC.PngPresenter.push, XC.SoftTheaterCompositor.compose

    def timed_push(self, frame):
        t0 = time.perf_counter()
        ok = png_push(self, frame)
        pushed.append(time.perf_counter())
        push_ms.append((pushed[-1] - t0) * 1e3)
        return ok

    def timed_compose(self, rgb_np, depth_np):
        t0 = time.perf_counter()
        res = compose(self, rgb_np, depth_np)
        composed.append((time.perf_counter() - t0) * 1e3)
        return res

    XC.PngPresenter.push, XC.SoftTheaterCompositor.compose = timed_push, timed_compose
    e2e = {}
    try:
        for name, frames, extra, want_shape in (
                ("flat", XR_E2E_FRAMES, [], (h, 2 * w, 3)),
                ("theater", XR_THEATER_FRAMES,
                 ["--theater", "on", "--theater-size", *map(str, XR_THEATER_SIZE)],
                 (XR_THEATER_SIZE[1], 2 * XR_THEATER_SIZE[0], 3))):
            png_dir = out_dir / f"xr_client_{name}"
            shutil.rmtree(png_dir, ignore_errors=True)
            for kept in (pushed, push_ms, composed):
                kept.clear()
            zero_counts(counters)
            t0 = time.perf_counter()
            rc = XC.main(["--host", "127.0.0.1", "--port", str(server.port), "--present", "png",
                          "--frames", str(frames), "--out", str(png_dir), "--poll-timeout",
                          "5", "--no-input", *extra])
            wall_s = time.perf_counter() - t0
            counts = read_counts(counters)
            check_counts(" ".join(["xr-client main --present png", *extra, "--frames",
                                   str(frames), "against the CLI --sink xr"]), counts,
                         {"dibr_fill": 2}, frames)
            pngs = png_frames(np, png_dir)
            ok = rc == 0 and len(pngs) == frames and all(
                p.shape == want_shape and p.dtype == np.uint8 for p in pngs)
            span = pushed[-1] - pushed[0] if len(pushed) > 1 else 0.0
            client_fps = (len(pushed) - 1) / span if span > 0 else 0.0
            compose_ms = statistics.median(composed) if composed else None
            png_ms = statistics.median(push_ms)
            log(f"[xr-client] {name}: exit {rc}, {len(pngs)} PNGs of "
                f"{pngs[0].shape if pngs else None} (want {frames} of {want_shape}); "
                f"{client_fps:.2f} frames/s first to last PNG written (the PNG encode "
                f"included: median {png_ms:.1f} ms a frame), {wall_s:.1f} s from main() to "
                f"its return"
                + (f"; compose (warp both eyes, theater, host raster) median "
                   f"{compose_ms:.1f} ms" if compose_ms is not None else "")
                + f" {'ok' if ok else 'FAIL'}; {card}")
            if not ok:
                raise AssertionError(f"xr client {name}: rc {rc}, PNGs "
                                     f"{[p.shape for p in pngs]}, want {frames} x {want_shape}")
            e2e[name] = dict(rc=rc, pngs=len(pngs), shape=list(want_shape), fps=client_fps,
                             wall_s=wall_s, png_ms=png_ms, compose_ms=compose_ms,
                             counts=counts)
            out["launches"][f"xr_client_{name}"] = counts["dibr_fill"]
            shutil.rmtree(png_dir, ignore_errors=True)
    finally:
        XC.PngPresenter.push, XC.SoftTheaterCompositor.compose = png_push, compose
        server_rc = server.stop()
    log(f"[xr-client] the server (python -m desktop2stereo_tpu_torch.cli --settings "
        f"(DA-V2-Large @518) --source synthetic --size {h}x{w} --sink xr --port 0 "
        f"--display-mode Mono) on port {server.port}: exit {server_rc} after its stop file")
    if server_rc != 0:
        raise AssertionError("the xr server failed:\n" + "\n".join(server.lines[-30:]))
    out["e2e"] = e2e

    # -- 51. --test: white 1280x720, zero depth, the theater, on the card ------
    warped = []
    warp_eye = XC.warp_eye

    def kept_warp(*args, **kw):
        res = warp_eye(*args, **kw)
        warped.append((float(res.min()), float(res.max())))
        return res

    runs = {}
    XC.warp_eye = kept_warp
    try:
        for device, frames in (("cuda", XR_THEATER_FRAMES), ("cpu", 1)):
            png_dir = out_dir / f"xr_selftest_{device}"
            shutil.rmtree(png_dir, ignore_errors=True)
            zero_counts(counters)
            rc = XC.main(["--test", "--present", "png", "--theater", "on", "--theater-size",
                          *map(str, XR_THEATER_SIZE), "--frames", str(frames), "--out",
                          str(png_dir), "--device", device])
            runs[device] = (rc, read_counts(counters), png_frames(np, png_dir))
            shutil.rmtree(png_dir, ignore_errors=True)
    finally:
        XC.warp_eye = warp_eye
    (rc, counts, pngs), (cpu_rc, cpu_counts, cpu_pngs) = runs["cuda"], runs["cpu"]
    check_counts(f"xr-client main --test --present png --theater on --frames "
                 f"{XR_THEATER_FRAMES}", counts, {"dibr_fill": 2}, XR_THEATER_FRAMES)
    tw, th = XR_THEATER_SIZE
    white = all(254.5 <= lo <= hi < 255.5 for lo, hi in warped)  # each rounds to 255
    ok = (rc == cpu_rc == 0 and len(pngs) == XR_THEATER_FRAMES and len(cpu_pngs) == 1
          and all(p.shape == (th, 2 * tw, 3) for p in pngs + cpu_pngs) and white
          and all(min(p[th // 2, tw // 2].min(), p[th // 2, tw + tw // 2].min()) > 180
                  for p in pngs))
    lsb, share = u8_diff(torch, torch.from_numpy(pngs[0]), torch.from_numpy(cpu_pngs[0])) \
        if ok else (None, None)
    log(f"[xr-client] selftest: exit {rc}, {len(pngs)} PNGs {[p.shape for p in pngs[:1]]}; "
        f"every warped eye (card {XR_THEATER_FRAMES * 2}, CPU 2) rounds to 255 everywhere (zero "
        f"depth, zero parallax: the unwarped white frame) {white}; each eye's screen centre "
        f"white; "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("xr client --test on the card: exit, PNGs or the white screen off")
    check_u8("xr client --test theater frame, card against --device cpu", lsb, share)
    out["selftest"] = dict(rc=rc, pngs=len(pngs), counts=counts, lsb=lsb, share=share)
    out["launches"]["xr_selftest"] = counts["dibr_fill"]
    return out


# -- 52-56. the multi-GPU path ---------------------------------------------------

TP = 2                               # the model axis of phases 52, 53 and 55
TP_ATTN_SHAPE = (1, 778, 8, 64)      # K2 on one rank's heads: ViT-L @518 at tp = 2
TP_LAYERS, GIANT_LAYERS = 24, 40     # K2 a rank and frame: ViT-L's layers, ViT-G's
GIANT_TP_HEADS = 12                  # ViT-G's 24 heads at tp = 2
# K4 on one rank's slice of ViT-L's four products at tp = 2: (name, role, K, F)
TP_DENSE = (("qkv", "col", 1024, 1536), ("fc1", "col", 1024, 2048),
            ("proj", "row", 512, 1024), ("fc2", "row", 2048, 1024))
PARALLEL_DEADLINE_S = 600.0
PARALLEL_STEP_RUNS = 7               # timed steps a sharded path (gloo steps take ~0.5-1.5 s)
# CPU copies of weights drawn by earlier phases (the flagship's, its int8
# form, dpt-dinov2-giant-kitti's), so that the ranks draw nothing; under
# "f32", phase 6's and phase 31's f32 CPU models with their configs, small
# frames and outputs, which phases 58 and 59 hold the card's f32 runs against
KEPT = {"f32": {}}


def parallel_rank(ctx, states, seed):
    """One rank of phases 52-55, in a process of its own (`spawn`): the
    world of TP ranks holds a 1 x TP mesh (`ctx`) and a TP x 1 mesh for
    data parallelism.  Every rank builds each model whole from `states`
    (on the meta device, then the shared host tensors), runs it whole on
    its card as the reference, then shards it.  → every rank's report, by
    rank (gathered)."""
    import itertools

    import numpy as np
    import torch
    import torch.distributed as dist

    from desktop2stereo_tpu_torch.core.registry import get_spec
    from desktop2stereo_tpu_torch.core.runtime import make_mesh, set_tf32
    from desktop2stereo_tpu_torch.models.factory import FAMILIES
    from desktop2stereo_tpu_torch.ops.kernels import attention as K2
    from desktop2stereo_tpu_torch.ops.kernels import quant_matmul as K4
    from desktop2stereo_tpu_torch.ops.quant import activation_scale
    from desktop2stereo_tpu_torch.parallel.introspect import count_launches
    from desktop2stereo_tpu_torch.parallel.sharding import (
        ColumnParallelQuantLinear, ParallelContext, RowParallelQuantLinear, parallel_frame_apply,
        shard_model)

    set_tf32(False)
    torch.set_grad_enabled(False)
    dev = ctx.device
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, *MODEL_SHAPE, 3), dtype=np.float32)).to(
        dev, torch.bfloat16)
    frames = torch.from_numpy(rng.standard_normal((2, *MODEL_SHAPE, 3), dtype=np.float32)).to(
        torch.bfloat16)
    rep = {"rank": ctx.rank, "backend": ctx.backend, "device": str(dev),
           "world": dist.get_world_size()}

    def build(name, state, quant=False):
        spec = get_spec(name)
        with torch.device("meta"):
            net = FAMILIES[spec.family][0](spec, quant=quant)
        net.load_state_dict(state, strict=True, assign=True)
        return net.eval()

    def fresh():
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    def weight_bytes(net):
        return sum(t.numel() * t.element_size()
                   for t in itertools.chain(net.parameters(), net.buffers()))

    def step_ms(fn):
        """CUDA events around one call, median of PARALLEL_STEP_RUNS after 2
        warm-up calls; the ranks start each sample together."""
        for _ in range(2):
            fn()
        times = []
        for _ in range(PARALLEL_STEP_RUNS):
            torch.cuda.synchronize(dev)
            dist.barrier(group=ctx.mesh.model_group)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def depth_err(got, want):
        """Phase 6's measure: both depths over the reference's range."""
        want = want.float()
        span = (want.max() - want.min()).clamp_min(1e-12)
        err = ((got.float() - want) / span).abs()
        return dict(mean_abs=err.mean().item(), max_abs=err.max().item(),
                    finite=bool(torch.isfinite(got).all()), shape=list(got.shape),
                    ok=bool(torch.isfinite(got).all()) and err.mean().item() <= REF_DEPTH_MEAN_ABS)

    def whole_run(name, state, quant=False):
        fresh()
        net = build(name, state, quant).to(dev)
        ref = net(x)
        peak = torch.cuda.max_memory_allocated(dev)
        return net, ref, dict(weight_bytes=weight_bytes(net), peak_bytes=peak,
                              step_ms=step_ms(lambda: net(x)))

    # -- 54. DP = 2 (a TP x 1 mesh in the same world), the whole model ----------
    whole, ref, rep["whole"] = whole_run(FLAGSHIP_MODEL, states["flagship"])
    ctx_dp = ParallelContext(make_mesh(TP, 1, dev))
    dp_run = parallel_frame_apply(whole, ctx_dp)
    got, launches = count_launches(dp_run, frames)
    d = ctx_dp.data_index
    single = whole(frames[d:d + 1].to(dev))
    rep["dp"] = dict(data_index=d, launches=launches, equal=bool(torch.equal(got, single)),
                     max_abs=(got.float() - single.float()).abs().max().item(),
                     step_ms=step_ms(lambda: dp_run(frames)))
    del whole, dp_run

    # -- 52. TP = 2, bf16 ----------------------------------------------------------
    fresh()
    net = shard_model(build(FLAGSHIP_MODEL, states["flagship"]), ctx)
    run = parallel_frame_apply(net, ctx)
    att = net.backbone.layer[0].attention
    seen = {}
    hook = att.register_forward_pre_hook(lambda m, a: seen.setdefault("in", a[0]))
    depth, launches = count_launches(run, x)
    hook.remove()
    q, k, v = (t.unflatten(-1, (att.num_heads, att.head_dim))
               for t in att.qkv(seen["in"]).split(att.num_heads * att.head_dim, dim=-1))
    k2_err = (K2.attention(q, k, v).float()
              - K2.attention_ref(q.float(), k.float(), v.float())).abs().max().item()
    peak = torch.cuda.max_memory_allocated(dev)
    # the reduction a row-parallel product ends in: [1, 778, 1024] f32, two a layer
    part = torch.ones(1, MODEL_SHAPE[0] // 14 * (MODEL_SHAPE[1] // 14) + 1, 1024, device=dev)
    reduce_ms = []
    for i in range(TIMED_RUNS + 3):  # median of TIMED_RUNS after 3 warm-up calls
        torch.cuda.synchronize(dev)
        dist.barrier(group=ctx.mesh.model_group)
        t0 = time.perf_counter()
        ctx.model_all_reduce(part)
        torch.cuda.synchronize(dev)
        if i >= 3:
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
    rep["tp_bf16"] = dict(launches=launches, heads=att.num_heads, k2_shape=list(q.shape),
                          k2_max_abs=k2_err, depth=depth_err(depth, ref),
                          weight_bytes=weight_bytes(net), peak_bytes=peak,
                          step_ms=step_ms(lambda: run(x)),
                          all_reduce_ms=statistics.median(reduce_ms),
                          all_reduce_shape=list(part.shape))
    del net, run, seen, q, k, v, part

    # -- 53. TP = 2, int8 -------------------------------------------------------------
    whole_q, ref_q, rep["whole_int8"] = whole_run(FLAGSHIP_MODEL, states["int8"], quant=True)
    del whole_q
    fresh()
    net = shard_model(build(FLAGSHIP_MODEL, states["int8"], quant=True), ctx)
    run = parallel_frame_apply(net, ctx)
    calls = {"col": 0, "row": 0}
    inputs = {}
    hooks = []
    for m in net.modules():
        role = ("col" if isinstance(m, ColumnParallelQuantLinear) else
                "row" if isinstance(m, RowParallelQuantLinear) else None)
        if role is not None:
            hooks.append(m.register_forward_hook(
                lambda m, a, o, role=role: calls.__setitem__(role, calls[role] + 1)))
    layer0 = net.backbone.layer[0]
    dense = {"qkv": layer0.attention.qkv, "proj": layer0.attention.proj,
             "fc1": layer0.mlp.fc1, "fc2": layer0.mlp.fc2}
    for name, m in dense.items():
        hooks.append(m.register_forward_pre_hook(
            lambda m, a, name=name: inputs.setdefault(name, a[0])))
    depth_q, launches = count_launches(run, x)
    for h in hooks:
        h.remove()
    shapes = {}
    for name, role, _, _ in TP_DENSE:
        m, xin = dense[name], inputs[name]
        if role == "col":
            args, kw = (xin, m.weight_q, m.scale, m.bias), {}
        else:  # the int32 entry with the full-K scale, as tp_quant_dense calls it
            absmax = xin.float().abs().amax(dim=-1, keepdim=True)
            ctx.model_all_reduce(absmax, "max")
            args = (xin, m.weight_q, m.scale)
            kw = dict(row_scale=activation_scale(absmax), out_dtype=torch.int32)
        got, want = K4.quant_dense(*args, **kw), K4.quant_dense_ref(*args, **kw)
        shapes[name] = dict(role=role, x=list(xin.shape), weight_q=list(m.weight_q.shape),
                            out=str(got.dtype), equal=bool(torch.equal(got, want)),
                            max_abs=(got.double() - want.double()).abs().max().item())
    rep["tp_int8"] = dict(launches=launches, calls=calls, k4=shapes,
                          equal=bool(torch.equal(depth_q, ref_q)),
                          max_abs=(depth_q.float() - ref_q.float()).abs().max().item(),
                          differing=int((depth_q != ref_q).sum()), values=depth_q.numel(),
                          depth=depth_err(depth_q, ref_q), weight_bytes=weight_bytes(net),
                          peak_bytes=torch.cuda.max_memory_allocated(dev),
                          step_ms=step_ms(lambda: run(x)))
    del net, run, inputs, dense, layer0, ref_q, depth_q

    # -- 55. TP = 2 + SP, dpt-dinov2-giant-kitti -----------------------------------------
    whole_g, ref_g, rep["whole_giant"] = whole_run(DPT_DINOV2_MODEL, states["giant"])
    del whole_g
    fresh()
    net = shard_model(build(DPT_DINOV2_MODEL, states["giant"]), ctx)
    run = parallel_frame_apply(net, ctx, sequence_parallel=True)
    depth_g, launches = count_launches(run, x)
    mlp = net.backbone.layer[0].mlp
    rep["tp_sp_giant"] = dict(launches=launches,
                              heads=net.backbone.layer[0].attention.num_heads, mlp=type(mlp).__name__,
                              hidden=(mlp.weights_out if hasattr(mlp, "weights_out")
                                      else mlp.fc2).in_features,
                              depth=depth_err(depth_g, ref_g), weight_bytes=weight_bytes(net),
                              peak_bytes=torch.cuda.max_memory_allocated(dev),
                              step_ms=step_ms(lambda: run(x)))
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, rep)
    return everyone


def parallel_phases(np, torch, F, K2, K4, card, dev, policy, timing, worst):
    """Phases 52-56: the multi-GPU path (`desktop2stereo_tpu_torch/parallel/`)
    in one spawned group of TP ranks; the kernels at one rank's shapes
    first, in this process.  → the report (each rank's, and the launches)."""
    from desktop2stereo_tpu_torch.core.runtime import mesh_device
    from desktop2stereo_tpu_torch.parallel.launch import spawn

    out = {}
    _, backend = mesh_device(None, TP, 0)
    how = ("NCCL, one card a rank" if backend == "nccl" else
           "gloo with both ranks on card 0 (gloo moves CUDA tensors through host memory)")
    log(f"[parallel] {TP} ranks, {how}: {torch.cuda.device_count()} card(s) visible; {card}")
    out["backend"], out["world"] = backend, TP

    # K2 and K4 at one rank's shapes: against the plain versions, then timed
    gen = torch.Generator(device=dev).manual_seed(SEED + 52)
    B, N, H, D = TP_ATTN_SHAPE
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t_.unflatten(-1, (H, D)) for t_ in qkv.split(H * D, dim=-1))
    err = (K2.attention(q, k, v).float()
           - K2.attention_ref(q.float(), k.float(), v.float())).abs().max().item()
    worst["attention_tp"] = err
    if err > ATTN_MAX_ABS:
        raise AssertionError(f"attention at {list(TP_ATTN_SHAPE)}: max abs err {err:.3e}")
    qh, kh, vh = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))
    t = time_both(torch, {"plain": lambda: K2.attention_ref(q, k, v),
                          "kernel": lambda: K2.attention(q, k, v),
                          "library": lambda: F.scaled_dot_product_attention(qh, kh, vh)})
    timing["attention_tp"] = dict(t, shape=f"{list(TP_ATTN_SHAPE)} bf16 qkv views (one rank "
                                           f"of ViT-L @518 at tp = {TP})",
                                  bound=bound_ms(policy.name, 4 * B * N * H * D * 2,
                                                 4 * B * H * N * N * D, "bf16"))
    del qkv, q, k, v, qh, kh, vh
    M = MODEL_SHAPE[0] // 14 * (MODEL_SHAPE[1] // 14) + 1
    for name, role, kin, fout in TP_DENSE:
        x, wq, scale, bias = dense_inputs(np, torch, dev, M, kin, fout, torch.bfloat16, True,
                                          seed=kin + fout + 52)
        if role == "col":
            args, kw = (x, wq, scale, bias), {}
        else:  # the int32 entry, a row scale over a longer K (clips nothing)
            args = (x, wq, scale)
            kw = dict(row_scale=x.float().abs().amax(dim=-1, keepdim=True) / 127.0,
                      out_dtype=torch.int32)
        got, want = K4.quant_dense(*args, **kw), K4.quant_dense_ref(*args, **kw)
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item()
        key = f"quant_matmul_tp_{role}"
        worst[key] = max(worst.get(key, 0.0), err)
        log(f"[parallel] quant_matmul {name} shard [{M},{kin}]x[{fout},{kin}] ({role}, "
            f"{str(got.dtype)[6:]} out): max abs err {err:.3e} (tol {QUANT_MAX_ABS}) "
            f"{'ok' if err <= QUANT_MAX_ABS and got.shape == want.shape else 'FAIL'}")
        if err > QUANT_MAX_ABS or got.shape != want.shape:
            raise AssertionError(f"quant_matmul {name} shard disagrees with its plain version")
        xq8 = x.float().clamp(-127, 127).round().to(torch.int8)
        wt = wq.t()
        t = time_both(torch, {"plain": lambda: K4.quant_dense_ref(*args, **kw),
                              "kernel": lambda: K4.quant_dense(*args, **kw),
                              "library": lambda: torch._int_mm(xq8, wt)})
        out_bytes = (4 if role == "row" else 2) * M * fout
        timing[f"quant_matmul_tp_{name}"] = dict(
            t, shape=f"{name} shard [{M},{kin}] bf16 x [{fout},{kin}] int8 ({role}, "
                     f"{'int32 out, row_scale' if role == 'row' else 'bf16 out + bias'})",
            bound=bound_ms(policy.name, 2 * M * kin + fout * kin + 8 * fout + out_bytes,
                           2 * M * kin * fout, "int8"))
        del x, wq, scale, bias, got, want, xq8, wt, args, kw
    for name in ["attention_tp"] + [f"quant_matmul_tp_{n}" for n, *_ in TP_DENSE]:
        log_timing(name, timing[name], card)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # the three models' weights, kept from phases 5, 12 and 34, into shared
    # host memory for the ranks
    states = {key: {k: v.contiguous().share_memory_() for k, v in KEPT.pop(key).items()}
              for key in ("flagship", "int8", "giant")}
    t0 = time.perf_counter()
    ranks = spawn(parallel_rank, 1, TP, "cuda", states, SEED, deadline_s=PARALLEL_DEADLINE_S)
    out["group_s"] = time.perf_counter() - t0
    del states
    out["ranks"] = ranks
    gb = 1e9
    for r in ranks:
        tag = f"rank {r['rank']} ({r['device']}, {r['backend']}, world {r['world']}; {card})"
        w, dp, tp, q, g = (r["whole"], r["dp"], r["tp_bf16"], r["tp_int8"], r["tp_sp_giant"])
        log(f"[parallel] 52. TP={TP} bf16 {FLAGSHIP_MODEL} @518, {tag}: K2 launches "
            f"{tp['launches']} (want d2s_attention_fwd {TP_LAYERS}) at {tp['k2_shape']}, one against "
            f"attention_ref max abs {tp['k2_max_abs']:.3e}; depth against the unsharded model "
            f"mean {tp['depth']['mean_abs']:.3e} max {tp['depth']['max_abs']:.3e} of its range "
            f"(tol mean {REF_DEPTH_MEAN_ABS}); step {tp['step_ms']:.3f} ms (unsharded "
            f"{w['step_ms']:.3f}); weights {tp['weight_bytes'] / gb:.3f} GB (unsharded "
            f"{w['weight_bytes'] / gb:.3f}), peak {tp['peak_bytes'] / gb:.3f} GB (unsharded "
            f"{w['peak_bytes'] / gb:.3f})")
        log(f"[parallel] 56. all-reduce of one row-parallel partial {tp['all_reduce_shape']} "
            f"f32 ({backend}{', gloo-on-one-card, not NVLink' if backend == 'gloo' else ''}), "
            f"{tag}: {tp['all_reduce_ms']:.3f} ms, {2 * tp['all_reduce_ms']:.3f} ms a layer "
            f"(two a layer)")
        if (tp["launches"] != {"d2s_attention_fwd": TP_LAYERS} or tp["heads"] != TP_ATTN_SHAPE[2]
                or tp["k2_max_abs"] > ATTN_MAX_ABS or not tp["depth"]["ok"]):
            raise AssertionError(f"TP bf16 on rank {r['rank']}: {tp}")
        k4 = "; ".join(f"{n} {v['role']} x {v['x']} w {v['weight_q']} {v['out'][6:]} "
                       f"{'exact' if v['equal'] else 'max abs %.3e' % v['max_abs']}"
                       for n, v in q["k4"].items())
        log(f"[parallel] 53. TP={TP} int8, {tag}: launches {q['launches']} (want "
            f"d2s_attention_fwd {TP_LAYERS}, d2s_quant_dense {4 * TP_LAYERS}), column- / "
            f"row-parallel calls "
            f"{q['calls']['col']} / {q['calls']['row']}; K4 on the layer-0 activations: {k4}; "
            f"depth against the unsharded int8 model: "
            + ("bit-equal" if q["equal"] else
               f"max abs {q['max_abs']:.3e}, {q['differing']} of {q['values']} values differ, "
               f"mean {q['depth']['mean_abs']:.3e} of its range")
            + f"; step {q['step_ms']:.3f} ms (unsharded {r['whole_int8']['step_ms']:.3f}); "
            f"peak {q['peak_bytes'] / gb:.3f} GB (unsharded "
            f"{r['whole_int8']['peak_bytes'] / gb:.3f})")
        if (q["launches"] != {"d2s_attention_fwd": TP_LAYERS, "d2s_quant_dense": 4 * TP_LAYERS}
                or q["calls"] != {"col": 2 * TP_LAYERS, "row": 2 * TP_LAYERS}
                or not all(v["equal"] for v in q["k4"].values()) or not q["depth"]["ok"]):
            raise AssertionError(f"TP int8 on rank {r['rank']}: {q}")
        log(f"[parallel] 54. DP={TP} (two seeded frames), {tag}: data index "
            f"{dp['data_index']}, launches {dp['launches']}, depth "
            f"{'bit-equal to' if dp['equal'] else 'max abs %.3e from' % dp['max_abs']} the "
            f"one-frame model's; step {dp['step_ms']:.3f} ms")
        if not dp["equal"] or dp["launches"] != {"d2s_attention_fwd": TP_LAYERS}:
            raise AssertionError(f"DP on rank {r['rank']}: {dp}")
        wg = r["whole_giant"]
        log(f"[parallel] 55. TP={TP} + SP {DPT_DINOV2_MODEL} @518, {tag}: K2 launches "
            f"{g['launches']} (want d2s_attention_fwd {GIANT_LAYERS}) with {g['heads']} heads, "
            f"{g['mlp']} hidden {g['hidden']} a rank; depth against the unsharded model mean "
            f"{g['depth']['mean_abs']:.3e} max {g['depth']['max_abs']:.3e} of its range; step "
            f"{g['step_ms']:.3f} ms (unsharded {wg['step_ms']:.3f}); weights "
            f"{g['weight_bytes'] / gb:.3f} GB (unsharded {wg['weight_bytes'] / gb:.3f}), peak "
            f"{g['peak_bytes'] / gb:.3f} GB (unsharded {wg['peak_bytes'] / gb:.3f})")
        if (g["launches"] != {"d2s_attention_fwd": GIANT_LAYERS} or g["heads"] != GIANT_TP_HEADS
                or not g["depth"]["ok"]):
            raise AssertionError(f"TP + SP giant on rank {r['rank']}: {g}")
    r0 = ranks[0]
    out["launches"] = {"attention_tp": {"tp_bf16": r0["tp_bf16"]["launches"]["d2s_attention_fwd"],
                                        "tp_int8": r0["tp_int8"]["launches"]["d2s_attention_fwd"],
                                        "tp_sp_giant": r0["tp_sp_giant"]["launches"][
                                            "d2s_attention_fwd"]},
                       "attention_dp": r0["dp"]["launches"]["d2s_attention_fwd"],
                       "quant_matmul_tp_col": r0["tp_int8"]["calls"]["col"],
                       "quant_matmul_tp_row": r0["tp_int8"]["calls"]["row"]}
    log(f"[parallel] the group: {out['group_s']:.1f} s, ranks started, built and run")
    return out


# ---- 57-59: K2 in f32, `--fp32` on the card, the checkpoint tool -------------------------

# K2's f32 body against its f32 plain version on unit-normal inputs: summation
# order and exp2f only
F32_ATTN_MAX_ABS = 1e-4
F32_RAGGED_SHAPE = (2, 130, 4, 64)   # either side of the f32 body's 32-row and 64-key tiles
F32_RAGGED_GRID = (8, 16)            # 129 tokens, with a table
FP32_CLI_SECONDS = 5.0
# the card in f32 against the CPU in f32 on phase 6's 216x384 frame: the same
# arithmetic in another summation order, so far inside phase 6's bf16 bounds
FP32_REF_DEPTH_MEAN_ABS = 1e-3
FP32_REF_SBS_MEAN_LSB = 0.5
FP32_REF_SBS_SHARE_OVER_32 = 1e-3
# the converter's pipeline, card f32 against CPU f32: the JAX gate test's
# headroom on rel_err_max (tests/test_verify_depth_gate.py:70)
CONVERTER_MAX_REL = 2e-3
GATE_MODEL, GATE_RES = "Depth-Anything-V2-Small", 126
CONVERT = [sys.executable, "-m", "desktop2stereo_tpu_torch.tools.convert"]


def k2_f32_phase(np, torch, F, K2, card, dev, policy, timing, worst):
    """57. K2's f32 body: its three entries against their plain versions at
    the flagship's, BEiT-L's (with its 18x32 table) and DepthPro's shapes and
    ragged ones, the table entry bit-equal to the dense entry on the
    expansion; registers and spills; times beside the plain version, f32
    SDPA and the bound at the f32 CUDA-core peak."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 57)

    def qkv(shape, views):
        B, N, H, D = shape
        if views:  # the encoder's q/k/v views of one qkv projection
            base = torch.randn(B, N, 3 * H * D, generator=gen, device=dev)
            return [t.unflatten(-1, (H, D)) for t in base.split(H * D, dim=-1)]
        return [torch.randn(shape, generator=gen, device=dev) for _ in range(3)]

    def check(label, got, want, key):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst[key] = max(worst.get(key, 0.0), err)
        ok = err <= F32_ATTN_MAX_ABS and got.shape == want.shape and got.dtype == torch.float32
        log(f"[parity] {label}: max abs err {err:.3e} (tol {F32_ATTN_MAX_ABS:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: K2's f32 body disagrees with its plain version")

    for shape in (ATTN_SHAPE, BIAS_ATTN_SHAPE, DEPTHPRO_ATTN_SHAPE, F32_RAGGED_SHAPE):
        for views in ((True, False) if shape == ATTN_SHAPE else (True,)):
            q, k, v = qkv(shape, views)
            check(f"attention_f32 {list(shape)} {'qkv views' if views else 'contiguous'}",
                  K2.attention(q, k, v), K2.attention_ref(q, k, v), "attention_f32")
    del q, k, v
    # BEiT's layout: query, key and value are three contiguous products
    for (gh, gw), (B, H) in (((18, 32), (1, 16)), (F32_RAGGED_GRID, (2, 4))):
        N, R = gh * gw + 1, K2.relative_position_count(gh, gw)
        q, k, v = qkv((B, N, H, 64), views=False)
        for tdt in (torch.float32, torch.bfloat16):
            table = (2.0 * torch.randn(H, R, generator=gen, device=dev)).to(tdt)
            dense = K2.expand_rel_pos(table, gh, gw)
            want = K2.attention_ref(q, k, v, dense.float())
            by_table = K2.attention_relpos(q, k, v, table, gh, gw)
            by_dense = K2.attention(q, k, v, dense)
            label = f"{gh}x{gw} [{B},{N},{H},64] + {str(tdt)[6:]} table [{H},{R}]"
            check(f"attention_relpos_f32 {label}", by_table, want, "attention_relpos_f32")
            check(f"attention_bias_f32 {label}, expanded", by_dense, want, "attention_bias_f32")
            if not torch.equal(by_table, by_dense):
                raise AssertionError(f"{label}: the f32 table entry differs from the f32 dense "
                                     f"entry on the expanded table")
    log("[parity] the f32 table entry equals the f32 dense entry on the expanded table, bit "
        "for bit, at both grids and both table dtypes")
    info = {}
    for entry, f32 in (("attention_f32", False), ("attention_bias_f32", False),
                       ("attention_bias_f32", True), ("attention_relpos_f32", False),
                       ("attention_relpos_f32", True)):
        i = K2.kernel_info(entry, f32, BIAS_ATTN_SHAPE[1], K2.relative_position_count(18, 32))
        info[f"{entry}{' f32 operand' if f32 else ''}"] = i
        log(f"[kernel] {entry}{' (f32 bias or table)' if f32 else ''} at [1, 577, 16, 64]: "
            f"{i['registers']} registers, {i['local_bytes']} local (spill) bytes a thread, "
            f"{i['smem_bytes']} bytes of dynamic shared memory, {i['blocks_per_sm']} resident "
            f"blocks an SM")
        if i["local_bytes"] or i["blocks_per_sm"] < 2:
            raise AssertionError(f"{entry}: spills or fewer than two blocks an SM: {i}")

    def timed(key, shape, label, bias=None, table=None):
        B, N, H, D = shape
        q, k, v = qkv(shape, views=bias is None and table is None)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        nbytes, extra = 4 * B * N * H * D * 4, ""
        if table is not None:
            gh, gw = table
            tab = 2.0 * torch.randn(H, K2.relative_position_count(gh, gw), generator=gen,
                                    device=dev)
            dense = K2.expand_rel_pos(tab, gh, gw)
            fns = {"plain": lambda: K2.attention_relpos_ref(q, k, v, tab, gh, gw),
                   "kernel": lambda: K2.attention_relpos(q, k, v, tab, gh, gw),
                   "library": lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                     attn_mask=dense[None]),
                   "dense": lambda: K2.attention(q, k, v, dense),
                   "unbiased": lambda: K2.attention(q, k, v)}
            nbytes += tab.numel() * 4
            extra = f" + f32 table {list(tab.shape)} ({gh}x{gw})"
        elif bias is not None:
            dense = 2.0 * torch.randn(H, N, N, generator=gen, device=dev)
            fns = {"plain": lambda: K2.attention_ref(q, k, v, dense),
                   "kernel": lambda: K2.attention(q, k, v, dense),
                   "library": lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                                     attn_mask=dense[None])}
            nbytes += dense.numel() * 4
            extra = f" + f32 bias {list(dense.shape)}"
        else:
            fns = {"plain": lambda: K2.attention_ref(q, k, v),
                   "kernel": lambda: K2.attention(q, k, v),
                   "library": lambda: F.scaled_dot_product_attention(qh, kh, vh)}
        t = time_both(torch, fns)
        timing[key] = dict(t, shape=f"{list(shape)} f32 {label}{extra}",
                           bound=bound_ms(policy.name, nbytes, 4 * B * H * N * N * D, "f32"))
        log_timing(key, timing[key], card)
        torch.cuda.empty_cache()

    timed("attention_f32", ATTN_SHAPE, "qkv views")
    timed("attention_f32_depthpro", DEPTHPRO_ATTN_SHAPE, "qkv views (DepthPro's tiles)")
    timed("attention_bias_f32", BIAS_ATTN_SHAPE, "contiguous", bias=True)
    timed("attention_relpos_f32", BIAS_ATTN_SHAPE, "contiguous", table=(18, 32))
    return dict(kernel_info=info, worst={k: worst[k] for k in ("attention_f32",
                                                                "attention_bias_f32",
                                                                "attention_relpos_f32")})


def fp32_phases(np, torch, programs, counters, card, out_dir, dev, layers, paths):
    """58. `--fp32` on the card: the CLI flagship for FP32_CLI_SECONDS (24 f32
    K2 a frame, no bf16 one); DA-V2-Large @518 and dpt-beit-large-512 @512 in
    f32 on the card against the f32 CPU runs of phases 6 and 31 (their kept
    models copied to the card, on the same frames); the dense-bias API on the
    f32 BEiT's tables.  Returns the report
    and the models, {name: (CPU model, card model, spec)}, for phase 59."""
    import copy

    from desktop2stereo_tpu_torch.ops.attention import multi_head_attention
    from desktop2stereo_tpu_torch.ops.kernels import attention as K2

    out, models = {}, {}
    run = CliRun(counters)
    rc = run(["--settings", str(cli_settings(out_dir)), "--source", "synthetic",
              "--size", f"{FRAME_SHAPE[0]}x{FRAME_SHAPE[1]}", "--sink", "null", "--fp32",
              "--duration", str(FP32_CLI_SECONDS), "--stop-file", str(out_dir / "stop.request"),
              "--stats-every", "0"])
    _, program, sink, _ = run.parts
    eng = run.engine
    want_shape = (FRAME_SHAPE[0], FRAME_SHAPE[1], 3)
    dtypes = {p.dtype for p in program.program.model.parameters()}
    if (rc != 0 or sink.frames < 1 or sink.last_shape != want_shape
            or program.program.compute_dtype != torch.float32 or dtypes != {torch.float32}
            or not eng.frames - 1 <= sink.frames + eng.out_box.dropped <= eng.frames):
        raise AssertionError(f"cli --fp32: rc {rc}, {eng.frames} frames run, {sink.frames} "
                             f"delivered of shape {sink.last_shape}, compute "
                             f"{program.program.compute_dtype}, weights {dtypes}")
    launches = run.check_launches("fp32 flagship", layers, CLI_WARM_FRAMES, f32=True)
    final = eng.stats_final()
    fps = eng.frames / run.wall_s
    log(f"[fp32] python -m desktop2stereo_tpu_torch.cli --settings (DA-V2-Large @518, "
        f"Half-SBS, Set FPS 1000) --source synthetic --size {FRAME_SHAPE[0]}x{FRAME_SHAPE[1]} "
        f"--sink null --fp32 --duration {FP32_CLI_SECONDS}: exit {rc}; {eng.frames} frames run "
        f"({eng.dropped} superseded), {sink.frames} delivered {sink.last_shape}; {fps:.2f} "
        f"frames/s (the CLI's fps counter {final.fps:.2f}); weights and compute f32, TF32 "
        f"matmul/cudnn {torch.backends.cuda.matmul.allow_tf32}/"
        f"{torch.backends.cudnn.allow_tf32}; {card}")
    out["cli"] = dict(rc=rc, frames_run=eng.frames, delivered=sink.frames, fps=fps,
                      fps_counter=final.fps, wall_s=run.wall_s, launches=launches)
    paths["fp32_cli"] = dict(launches=launches["run"], fps=fps)

    for key, name, biased in (("fp32_reference", FLAGSHIP_MODEL, False),
                              ("fp32_beit_reference", BEIT_MODEL, True)):
        # phase 6's (31's) f32 CPU model, config, frames and outputs: DA-V2-Large
        # on one frame, BEiT first and then a step on the carried tables
        kept = KEPT["f32"].pop(name)
        cpu_net, spec, cfg, want = kept["net"], kept["spec"], kept["cfg"], kept["want"]
        res, n_frames = cfg.depth_resolution, len(want)
        t0 = time.perf_counter()
        card_net = copy.deepcopy(cpu_net).to(dev)
        copy_s = time.perf_counter() - t0
        n = len(card_net.backbone.layer)
        card_prog = programs.ProgramCache(cfg, card_net, spec, compute_dtype=torch.float32)
        zero_counts(counters)
        got = [tuple(t.cpu() for t in card_prog(f)) for f in kept["frames"][:n_frames]]
        torch.cuda.synchronize()
        counts = read_counts(counters)
        entry = "attention_relpos_f32" if biased else "attention_f32"
        refs = []
        for i in range(n_frames):
            r = ref_stats(torch, name, got[i], want[i])
            r["ok"] = (r["depth_mean_abs"] <= FP32_REF_DEPTH_MEAN_ABS
                       and r["sbs_mean_lsb"] <= FP32_REF_SBS_MEAN_LSB
                       and r["sbs_share_over_32"] <= FP32_REF_SBS_SHARE_OVER_32)
            refs.append(r)
            log(f"[fp32] {name} @{res} frame {i}, 216x384, card f32 vs CPU f32: depth mean "
                f"{r['depth_mean_abs']:.3e} (tol {FP32_REF_DEPTH_MEAN_ABS:.0e}) max "
                f"{r['depth_max_abs']:.3e}; sbs mean {r['sbs_mean_lsb']:.4f} LSB (tol "
                f"{FP32_REF_SBS_MEAN_LSB}) max {r['sbs_max_lsb']:.0f}, >32 LSB "
                f"{r['sbs_share_over_32']:.2e} (tol {FP32_REF_SBS_SHARE_OVER_32:.0e}); the "
                f"CPU's output from phase {31 if biased else 6}, its model copied to the card "
                f"in {copy_s:.1f} s {'ok' if r['ok'] else 'FAIL'}")
        check_counts(f"fp32 {name} reference", counts,
                     {"attention": n, entry: n, "dibr_pair": 1}, n_frames)
        if not all(r["ok"] for r in refs):
            raise AssertionError(f"fp32 {name}: the card's f32 run disagrees with the CPU's")
        out[key] = dict(frames=refs, launches=counts, copy_s=copy_s)
        paths[key] = dict(launches=counts)
        models[name] = (cpu_net, card_net, spec)
        if not biased:
            continue
        # the dense-bias API on the f32 model's carried tables, as phase 31 on
        # the bf16 one: each expanded table through the f32 dense entry
        # against the f32 table entry on the same q/k/v
        (state,) = card_prog._states.values()
        carry = state.model
        gen = torch.Generator(device=dev).manual_seed(SEED + 58)
        H, R = carry[0].shape
        with torch.inference_mode():
            q, k, v = (torch.randn(1, 18 * 32 + 1, H, 64, generator=gen, device=dev)
                       for _ in range(3))
            dense = [K2.expand_rel_pos(t, 18, 32) for t in carry]
            zero_counts(counters)
            by_dense = [multi_head_attention(q, k, v, bias=b) for b in dense]
            by_table = [multi_head_attention(q, k, v, rel_pos=(t, 18, 32)) for t in carry]
            torch.cuda.synchronize()
            api = read_counts(counters)
        equal = all(torch.equal(a, b) for a, b in zip(by_dense, by_table))
        ok = equal and R == K2.relative_position_count(18, 32) and all(
            t.dtype == torch.float32 and t.shape == (H, R) for t in carry)
        check_counts("fp32 BEiT dense-bias API", api,
                     {"attention": 2 * n, "attention_bias_f32": n, "attention_relpos_f32": n}, 1)
        log(f"[fp32] the dense-bias API on the f32 model's {len(carry)} tables "
            f"{list(carry[0].shape)} {str(carry[0].dtype)[6:]}: the f32 dense entry equals the "
            f"f32 table entry {'bit for bit' if equal else 'NOT'} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("fp32 BEiT: the dense-bias API and the table entry disagree")
        paths["fp32_beit_dense_api"] = dict(launches=api)
    return out, models


def converter_phase(np, torch, counters, card, dev, models, out_dir, paths):
    """59. The checkpoint tool: `port_depth` (the gate's pipeline) on the card
    against the CPU, both f32, on the synthetic 1080p scene for DA-V2-Large
    @518 and dpt-beit-large-512 @512; `--verify` in a process of its own on
    phase 20's checkpoint in a hub layout; the jobs that need `transformers`
    (absent: each exits naming it; present: the gate on a DA-V2-Small random
    snapshot at 126, on the card)."""
    import importlib.util
    import os
    import tempfile

    from desktop2stereo_tpu_torch.core.registry import get_spec
    from desktop2stereo_tpu_torch.models import safetensors_io
    from desktop2stereo_tpu_torch.models.convert_hf import convert_vda
    from desktop2stereo_tpu_torch.tools import convert

    out = {}
    img = convert._load_image(None)
    for key, name, res, entry in (("converter_da_v2", FLAGSHIP_MODEL, 518, "attention_f32"),
                                  ("converter_beit", BEIT_MODEL, BEIT_RES,
                                   "attention_relpos_f32")):
        cpu_net, card_net, spec = models[name]
        n = len(card_net.backbone.layer)
        t0 = time.perf_counter()
        want = convert.port_depth(cpu_net, spec, img, res, "cpu")
        cpu_s = time.perf_counter() - t0
        zero_counts(counters)
        t0 = time.perf_counter()
        got = convert.port_depth(card_net, spec, img, res, dev)
        card_s = time.perf_counter() - t0
        counts = read_counts(counters)
        rel_max = float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-6))
        rel_mean = float(np.abs(got - want).mean() / max(float(np.abs(want).mean()), 1e-6))
        ok = (got.shape == want.shape and bool(np.isfinite(got).all())
              and rel_max < CONVERTER_MAX_REL)
        log(f"[convert] port_depth {name} @{res} on the synthetic {img.shape[0]}x{img.shape[1]} "
            f"scene, raw depth {list(got.shape)}: card f32 against CPU f32 rel_err_max "
            f"{rel_max:.3e} (tol {CONVERTER_MAX_REL:.0e}), rel_err_mean {rel_mean:.3e}; card "
            f"{card_s:.2f} s, CPU {cpu_s:.2f} s {'ok' if ok else 'FAIL'}; {card}")
        check_counts(f"convert {name}", counts, {"attention": n, entry: n}, 1)
        if not ok:
            raise AssertionError(f"convert {name}: the card's pipeline disagrees with the CPU's")
        out[key] = dict(rel_err_max=rel_max, rel_err_mean=rel_mean, shape=list(got.shape),
                        card_s=card_s, cpu_s=cpu_s, launches=counts)
        paths[key] = dict(launches=counts)
    del models

    spec = get_spec(CKPT_MODEL)
    with tempfile.TemporaryDirectory(prefix="d2s_smoke_convert_") as tmp:
        # phase 20's checkpoint, where the hub cache keeps a snapshot
        snap = (Path(tmp) / "hub" / f"models--{spec.hf_repo.replace('/', '--')}" / "snapshots"
                / "smoke")
        snap.mkdir(parents=True)
        arrays = vda_original_arrays(np, spec, SEED + 7)
        safetensors_io.save_file(arrays, snap / "model.safetensors")
        # the leaves of the converted tree: what the JAX tool's param_count counts
        leaves = lambda t: (sum(map(leaves, t.values())) if isinstance(t, dict)  # noqa: E731
                            else int(np.size(t)))
        params = leaves(convert_vda(arrays, spec))
        # USE_TF=0: transformers imports no TensorFlow where a host has one
        env = dict(os.environ, HF_HOME=tmp, HOME=tmp, HF_HUB_OFFLINE="1", USE_TF="0")

        def convert_run(*argv):
            t0 = time.perf_counter()
            proc = subprocess.run(CONVERT + list(argv), cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=600)
            return proc, time.perf_counter() - t0

        proc, s = convert_run("--model", CKPT_MODEL, "--verify", "--skip-download")
        want_line = (f"[convert] {CKPT_MODEL}: {snap / 'model.safetensors'} -> "
                     f"{params / 1e6:.1f}M params OK")
        ok = proc.returncode == 0 and want_line in proc.stdout
        log(f"[convert] python -m desktop2stereo_tpu_torch.tools.convert --model {CKPT_MODEL} "
            f"--verify --skip-download (HF_HOME: a hub layout holding phase 20's checkpoint): "
            f"exit {proc.returncode} in {s:.1f} s; {proc.stdout.strip().splitlines()[-1:]} "
            f"(want {params} parameters) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"convert --verify: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        out["verify"] = dict(rc=proc.returncode, seconds=s, params=params)

        snap_dir = Path(tmp) / "snapshot"
        if importlib.util.find_spec("transformers") is None:
            jobs = {"--make-random-snapshot": ("--model", GATE_MODEL, "--make-random-snapshot",
                                               str(snap_dir)),
                    "--verify-depth": ("--model", GATE_MODEL, "--verify-depth", "--checkpoint",
                                       str(snap_dir), "--skip-download"),
                    "--model-path": ("--model-path", str(snap_dir))}
            with ThreadPoolExecutor(len(jobs)) as pool:
                runs = dict(zip(jobs, pool.map(lambda a: convert_run(*a), jobs.values())))
            ok = all(p.returncode != 0 and "transformers" in p.stderr for p, _ in runs.values())
            for job, (p, s) in runs.items():
                log(f"[convert] {job} without transformers: exit {p.returncode} in {s:.1f} s, "
                    f"{p.stderr.strip().splitlines()[-1:]}")
            if not ok:
                raise AssertionError("convert: a transformers job did not exit naming it")
            out["transformers"] = dict(present=False, exits={j: p.returncode
                                                              for j, (p, _) in runs.items()})
        else:
            proc, s = convert_run("--model", GATE_MODEL, "--make-random-snapshot",
                                  str(snap_dir), "--verify-depth", "--skip-download",
                                  "--depth-res", str(GATE_RES))
            verdict = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.stdout else {}
            ok = proc.returncode == 0 and verdict.get("pass") is True
            log(f"[convert] the gate on a {GATE_MODEL} random snapshot @{GATE_RES} on the card: "
                f"exit {proc.returncode} in {s:.1f} s, {verdict} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"convert --verify-depth: {proc.stderr[-2000:]}")
            out["transformers"] = dict(present=True, verdict=verdict)
    return out


def main() -> int:
    if not (ROOT / "desktop2stereo_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no desktop2stereo_tpu_torch package beside {__file__}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the port on an NVIDIA GPU and has no CPU mode", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from desktop2stereo_tpu_torch.core.config import DISPLAY_MODES
    from desktop2stereo_tpu_torch.core.runtime import cuda_policy
    from desktop2stereo_tpu_torch.models.factory import build_bound
    from desktop2stereo_tpu_torch.ops import stereo as S
    from desktop2stereo_tpu_torch.ops.kernels import attention as K2
    from desktop2stereo_tpu_torch.ops.kernels import dibr as K1
    from desktop2stereo_tpu_torch.ops.kernels import dibr_fill as K5
    from desktop2stereo_tpu_torch.ops.kernels import quant_matmul as K4
    from desktop2stereo_tpu_torch.ops.kernels import warp as K3
    from desktop2stereo_tpu_torch.ops.kernels.build import build_all
    from desktop2stereo_tpu_torch.pipeline import programs
    from desktop2stereo_tpu_torch.pipeline.engine import FrameEngine

    report = {}
    marks = [("start", time.perf_counter())]

    def mark(label):  # the wall time of the phase group that ends here
        marks.append((label, time.perf_counter()))

    # launch counters by kernel (K1's two entry points share one; read_counts
    # adds K2's dense-bias and table entries as "attention_bias" and
    # "attention_relpos")
    counters = {"attention": K2.KERNEL, "dibr_pair": K1.KERNEL, "warp": K3.KERNEL,
                "dibr_fill": K5.KERNEL, "quant_matmul": K4.KERNEL}

    # -- 1. device ---------------------------------------------------------
    policy = cuda_policy(0, allow_tf32=False)
    dev = policy.device
    card = card_line()
    log(card)
    log(f"[device] {policy.name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"compute {policy.compute_dtype}, TF32 matmul/cudnn "
        f"{torch.backends.cuda.matmul.allow_tf32}/{torch.backends.cudnn.allow_tf32}; "
        f"peaks for the bound {peaks(policy.name)}")
    report["card"] = card
    report["host_packages"] = host_packages()
    log("[device] host packages the sinks and sources import when made: " + ", ".join(
        f"{k} {v}" for k, v in report["host_packages"].items()))

    # -- 2. build: one nvcc per source, all started together ----------------
    t0 = time.perf_counter()
    built = build_all()  # builds (if missing) and loads
    build_s = time.perf_counter() - t0
    log("[build] " + ", ".join(
        f"{name} {s:.2f} s" if s is not None else f"{name} already built"
        for name, s in built.items()) + f" (nvcc in parallel); all loaded in {build_s:.2f} s")
    report["build_s"] = build_s
    mark("1-2 device and build")

    # -- 3. kernel parity ----------------------------------------------------
    worst = {"dibr_pair_half": 0.0, "dibr_pair_eyes": 0.0, "attention": 0.0,
             "warp": 0.0, "dibr_fill": 0.0, "quant_matmul": 0.0}
    for (eh, ew) in (EYE, (50, 200), (96, 256)) + DIBR_EDGES:
        rng = np.random.default_rng(eh + ew)
        rgb = torch.from_numpy(rng.random((3, eh, ew), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((eh, ew), dtype=np.float32) if eh > 4
                               else edgy_depth(np, rng, eh, ew)).to(dev)
        for feather in (0.0, S.FEATHER_WIDTH):
            for arrangement in ("sbs", "tab"):
                kw = dict(ipd=IPD, depth_strength=STRENGTH, convergence=0.01,
                          feather=feather, arrangement=arrangement)
                got = K1.dibr_pair_half(rgb, dep, **kw)
                want = K1.dibr_pair_half_ref(rgb, dep, **kw)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != torch.uint8:
                    raise AssertionError(f"dibr {got.dtype} {tuple(got.shape)} vs {tuple(want.shape)}")
                diff = (got.int() - want.int()).abs()
                lsb, share = int(diff.max().item()), (diff > 0).float().mean().item()
                worst["dibr_pair_half"] = max(worst["dibr_pair_half"], lsb)
                check_u8(f"dibr half eye {eh}x{ew} feather={feather} {arrangement}", lsb, share,
                         n=diff.numel())

    for (h, w) in (FULL, (50, 200), (96, 256)) + DIBR_EDGES:
        rng = np.random.default_rng(h * w)
        rgb = torch.from_numpy(rng.random((3, h, w), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((h, w), dtype=np.float32) if h > 4
                               else edgy_depth(np, rng, h, w)).to(dev)
        kw = dict(ipd=IPD, depth_strength=STRENGTH, convergence=0.01)
        got = K1.dibr_pair_eyes(rgb, dep, **kw)
        want = K1.dibr_pair_eyes_ref(rgb, dep, **kw)
        torch.cuda.synchronize()
        for side, g, wt in zip(("left", "right"), got, want):
            if g.shape != (3, h, w) or g.dtype != torch.float32:
                raise AssertionError(f"dibr eyes {g.dtype} {tuple(g.shape)}")
            lsb, share = u8_diff(torch, g, wt)
            f32 = (g - wt).abs().max().item()
            worst["dibr_pair_eyes"] = max(worst["dibr_pair_eyes"], f32)
            check_u8(f"dibr eyes {h}x{w} {side}", lsb, share, f"; f32 max abs {f32:.3e}",
                     n=g.numel())

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for shape, views in ((ATTN_SHAPE, True), (ATTN_SHAPE, False),
                         ((2, 130, 4, 64), False), ((1, 1370, 12, 64), False)):
        B, N, H, D = shape
        if views:  # the encoder's strided q/k/v views of one qkv projection
            qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
        else:
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(3))
        got = K2.attention(q, k, v).float()
        want = K2.attention_ref(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst["attention"] = max(worst["attention"], err)
        ok = err <= ATTN_MAX_ABS and got.shape == want.shape
        log(f"[parity] attention {list(shape)}{' qkv views' if views else ''} bf16: "
            f"max abs err {err:.3e} (tol {ATTN_MAX_ABS:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("attention kernel disagrees with its plain version")

    # the dense-bias entry: BEiT-L's shape with BEiT's layout (three
    # contiguous products: query, key, value) and as qkv views, and ragged N
    # on either side of the tiles; the bias in bf16 and in f32, scaled so
    # that it moves the softmax
    worst["attention_bias"] = 0.0
    for shape, views in ((BIAS_ATTN_SHAPE, False), (BIAS_ATTN_SHAPE, True),
                         ((2, 1, 4, 64), True), ((2, 63, 4, 64), True),
                         ((2, 130, 4, 64), True)):
        B, N, H, D = shape
        if views:
            qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
            q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
        else:
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(3))
        for bias_dtype in (torch.bfloat16, torch.float32):
            bias = (2.0 * torch.randn(H, N, N, generator=gen, device=dev)).to(bias_dtype)
            got = K2.attention(q, k, v, bias).float()
            want = K2.attention_ref(q.float(), k.float(), v.float(), bias.float())
            moved = (want - K2.attention_ref(q.float(), k.float(), v.float())).abs().max().item()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst["attention_bias"] = max(worst["attention_bias"], err)
            ok = err <= ATTN_MAX_ABS and got.shape == want.shape and (N == 1 or moved > 0.1)
            log(f"[parity] attention {list(shape)} {'qkv views' if views else 'contiguous'} + "
                f"{str(bias_dtype)[6:]} bias "
                f"[{H},{N},{N}]: max abs err {err:.3e} (tol {ATTN_MAX_ABS:.0e}); the bias moves "
                f"the plain output by up to {moved:.3f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("biased attention kernel disagrees with its plain version")

    # the table entry: BEiT-L @512's 18x32 grid (577 tokens), the 4:3
    # capture's 24x32, the 32x32 pretraining window, and ragged N = 2, 19, 64,
    # 129; contiguous q/k/v (BEiT's three products) and qkv views; the table
    # in bf16 (as the model carries it) and in f32.  Against the plain version
    # and against the dense entry on the expanded bias (the same f32 operands
    # and operations, so equal bit for bit)
    worst["attention_relpos"] = 0.0
    relpos_vs_dense = 0.0
    for (gh, gw) in RELPOS_GRIDS:
        N = gh * gw + 1
        B, H = (1, 16) if N > 500 else (2, 4)
        R = K2.relative_position_count(gh, gw)
        for views in (False, True):
            if views:
                qkv = torch.randn(B, N, 3 * H * 64, generator=gen, device=dev).to(torch.bfloat16)
                q, k, v = (t.unflatten(-1, (H, 64)) for t in qkv.split(H * 64, dim=-1))
            else:
                q, k, v = (torch.randn(B, N, H, 64, generator=gen, device=dev).to(torch.bfloat16)
                           for _ in range(3))
            for tdt in (torch.bfloat16, torch.float32):
                table = (2.0 * torch.randn(H, R, generator=gen, device=dev)).to(tdt)
                got = K2.attention_relpos(q, k, v, table, gh, gw)
                dense = K2.expand_rel_pos(table, gh, gw)
                want = K2.attention_ref(q.float(), k.float(), v.float(), dense.float())
                same = K2.attention(q, k, v, dense)
                plain = K2.attention_ref(q.float(), k.float(), v.float())
                moved = (want - plain).abs().max().item()
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                vs_dense = (got.float() - same.float()).abs().max().item()
                worst["attention_relpos"] = max(worst["attention_relpos"], err)
                relpos_vs_dense = max(relpos_vs_dense, vs_dense)
                ok = (err <= ATTN_MAX_ABS and vs_dense <= ATTN_MAX_ABS and got.shape == q.shape
                      and (N == 1 or moved > 0.1))
                log(f"[parity] attention_relpos {gh}x{gw} [{B},{N},{H},64] "
                    f"{'qkv views' if views else 'contiguous'} + {str(tdt)[6:]} table [{H},{R}]: "
                    f"max abs err {err:.3e} (tol {ATTN_MAX_ABS:.0e}); against the dense entry "
                    f"max abs {vs_dense:.3e} ({'equal' if torch.equal(got, same) else 'NOT equal'}"
                    f"); the bias moves the plain output by up to {moved:.3f} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("table attention kernel disagrees with its plain version")
    relpos_info = {}
    for entry, f32 in (("attention", False), ("attention_bias", False), ("attention_bias", True),
                       ("attention_relpos", False), ("attention_relpos", True)):
        info = K2.kernel_info(entry, f32, BIAS_ATTN_SHAPE[1], K2.relative_position_count(18, 32))
        relpos_info[f"{entry}{' f32' if f32 else ''}"] = info
        log(f"[kernel] {entry}{' f32' if f32 else ''} at [1, 577, 16, 64]: {info['registers']} "
            f"registers, {info['local_bytes']} local (spill) bytes a thread, "
            f"{info['smem_bytes']} bytes of dynamic shared memory, {info['blocks_per_sm']} "
            f"resident blocks an SM (cudaFuncGetAttributes, "
            f"cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
        if entry == "attention_relpos" and (info["local_bytes"] or info["blocks_per_sm"] < 2):
            raise AssertionError(f"attention_relpos: spills or fewer than two blocks an SM: {info}")
    report["attention_kernel_info"] = relpos_info
    report["relpos_vs_dense_max_abs"] = relpos_vs_dense

    def fast_px(dep):
        """The fast compositor's reflected warp position, left eye."""
        W = dep.shape[1]
        shifts = -dep * STRENGTH * (IPD * W) * S.DEPTH_STRENGTH_SBS
        base = torch.arange(W, dtype=torch.float32, device=dep.device)[None, :]
        return S._reflect_coords(base + shifts, W).contiguous()

    for (h, w, c) in ((*FULL, 3), (50, 200, 3), (96, 256, 3), (9, 1, 3)):
        rng = np.random.default_rng(h + w + c)
        img = torch.from_numpy(rng.random((h, w, c), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
        px = fast_px(dep)
        got = K3.horizontal_sample(img, px)
        want = K3.horizontal_sample_ref(img, px)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst["warp"] = max(worst["warp"], err)
        ok = err <= WARP_MAX_ABS and got.shape == want.shape
        log(f"[parity] warp [{h},{w},{c}] reflected px at strength {STRENGTH}: max abs err "
            f"{err:.3e} (tol {WARP_MAX_ABS:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("warp kernel disagrees with its plain version")

    def fill_inputs(h, w, seed, eye=-IPD / 2):
        """rgb, RAW depth, conf and clamped px as dibr_render builds them."""
        rng = np.random.default_rng(seed)
        rgb = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32) * 255).to(dev)
        dep = torch.from_numpy(rng.random((h, w), dtype=np.float32) if h > 4
                               else edgy_depth(np, rng, h, w)).to(dev)
        _, px, _, conf = S.dibr_geometry(dep, eye, STRENGTH, 0.01)
        return rgb, dep, conf.contiguous(), px.clamp(0.0, w - 1.0).contiguous()

    for (h, w) in (FULL, (50, 200), (96, 256)) + DIBR_EDGES:
        args = fill_inputs(h, w, seed=h + 2 * w)
        for sign in (-1.0, 1.0):
            got = K5.dibr_warp_fill_blend(*args, sweep_sign=sign)
            want = K5.dibr_warp_fill_blend_ref(*args, sweep_sign=sign)
            torch.cuda.synchronize()
            lsb, share = u8_diff(torch, got, want)
            f32 = (got - want).abs().max().item()
            worst["dibr_fill"] = max(worst["dibr_fill"], f32)
            check_u8(f"dibr_fill {h}x{w} sweep {sign:+.0f}", lsb, share,
                     f"; f32 max abs {f32:.3e}", n=got.numel())

    def check_quant(label, got, want):
        torch.cuda.synchronize()
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        worst["quant_matmul"] = max(worst["quant_matmul"], err)
        ok = got.shape == want.shape and got.dtype == want.dtype and err <= QUANT_MAX_ABS
        log(f"[parity] quant_matmul {label}: max abs err {err:.3e} (tol {QUANT_MAX_ABS}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"quant_matmul {label}: kernel disagrees with its plain version")

    M_TOK = ATTN_SHAPE[1]
    for name, kin, fout in VIT_L_DENSE:
        args = dense_inputs(np, torch, dev, M_TOK, kin, fout, torch.bfloat16, True,
                            seed=kin + fout)
        check_quant(f"{name} [{M_TOK},{kin}]x[{kin},{fout}] bf16 + bias",
                    K4.quant_dense(*args), K4.quant_dense_ref(*args))
    for rows in (1, 7, 130):
        for kin in (64, 256):
            for fout in (96, 200):
                args = dense_inputs(np, torch, dev, rows, kin, fout, torch.float32, False,
                                    seed=rows * kin + fout)
                check_quant(f"[{rows},{kin}]x[{kin},{fout}] f32 no bias",
                            K4.quant_dense(*args), K4.quant_dense_ref(*args))
    x, wq, scale, bias = dense_inputs(np, torch, dev, 130, 256, 200, torch.bfloat16, True, seed=9)
    rs = x.float().abs().amax(dim=-1, keepdim=True) / 200.0  # clips the largest values
    check_quant("row_scale [130,256]x[256,200] bf16", K4.quant_dense(x, wq, scale, bias, rs),
                K4.quant_dense_ref(x, wq, scale, bias, rs))
    # int32 mode: integer-valued activations and row_scale 1, so q = x
    x, wq, scale, _ = dense_inputs(np, torch, dev, M_TOK, 1024, 4096, torch.float32, False, seed=10)
    xi = x.clamp(-127, 127).round().to(torch.bfloat16)
    ones = torch.ones(M_TOK, 1, device=dev)
    acc = K4.quant_dense(xi, wq, scale, row_scale=ones, out_dtype=torch.int32)
    check_quant(f"int32 [{M_TOK},1024]x[1024,4096]", acc,
                K4.quant_dense_ref(xi, wq, scale, row_scale=ones, out_dtype=torch.int32))
    exact = (xi.double() @ wq.double().T).to(torch.int64)
    if not torch.equal(acc.to(torch.int64), exact):
        raise AssertionError("quant_matmul int32 mode differs from the exact integer product")
    log("[parity] quant_matmul int32 mode equals the exact int64 product")
    del x, xi, wq, scale, acc, exact

    # -- 4. kernel times -----------------------------------------------------
    timing = {}
    rng = np.random.default_rng(1)
    rgb_e = torch.from_numpy(rng.random((3, *EYE), dtype=np.float32) * 255).to(dev)
    dep_e = torch.from_numpy(rng.random(EYE, dtype=np.float32)).to(dev)
    dkw = dict(ipd=IPD, depth_strength=STRENGTH, convergence=0.0)
    t = time_both(torch, {"plain": lambda: K1.dibr_pair_half_ref(rgb_e, dep_e, **dkw),
                          "kernel": lambda: K1.dibr_pair_half(rgb_e, dep_e, **dkw)})
    px_e = EYE[0] * EYE[1]
    timing["dibr_pair_half"] = dict(t, library=None, shape=f"eye {EYE[0]}x{EYE[1]} Half-SBS",
                                    bound=bound_ms(policy.name, 4 * 4 * px_e + 2 * 3 * px_e,
                                                   OPS_PER_PX["dibr_pair"] * px_e, "f32"))
    del rgb_e, dep_e

    rgb_f = torch.from_numpy(rng.random((3, *FULL), dtype=np.float32) * 255).to(dev)
    dep_f = torch.from_numpy(rng.random(FULL, dtype=np.float32)).to(dev)
    t = time_both(torch, {"plain": lambda: K1.dibr_pair_eyes_ref(rgb_f, dep_f, **dkw),
                          "kernel": lambda: K1.dibr_pair_eyes(rgb_f, dep_f, **dkw)})
    px_f = FULL[0] * FULL[1]
    timing["dibr_pair_eyes"] = dict(t, library=None, shape=f"frame {FULL[0]}x{FULL[1]} eyes f32",
                                    bound=bound_ms(policy.name, 4 * 4 * px_f + 2 * 3 * 4 * px_f,
                                                   OPS_PER_PX["dibr_pair"] * px_f, "f32"))
    del rgb_f, dep_f

    B, N, H, D = ATTN_SHAPE
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t_.unflatten(-1, (H, D)) for t_ in qkv.split(H * D, dim=-1))
    qh, kh, vh = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))  # [B,H,N,D]
    t = time_both(torch, {"plain": lambda: K2.attention_ref(q, k, v),
                          "kernel": lambda: K2.attention(q, k, v),
                          "library": lambda: F.scaled_dot_product_attention(qh, kh, vh)})
    timing["attention"] = dict(t, shape=f"{list(ATTN_SHAPE)} bf16 qkv views",
                               bound=bound_ms(policy.name, 4 * B * N * H * D * 2,
                                              4 * B * H * N * N * D, "bf16"))
    del qkv, q, k, v, qh, kh, vh

    # the dense-bias entry at BEiT-L's shape; the yardstick is SDPA with the same
    # bias as a float mask, added to the scaled logits as the kernel adds it
    B, N, H, D = BIAS_ATTN_SHAPE
    qkv = torch.randn(B, N, 3 * H * D, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t_.unflatten(-1, (H, D)) for t_ in qkv.split(H * D, dim=-1))
    qh, kh, vh = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))
    bias = (2.0 * torch.randn(H, N, N, generator=gen, device=dev)).to(torch.bfloat16)
    mask = bias[None]
    t = time_both(torch, {
        "plain": lambda: K2.attention_ref(q, k, v, bias),
        "kernel": lambda: K2.attention(q, k, v, bias),
        "library": lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)})
    timing["attention_bias"] = dict(
        t, shape=f"{list(BIAS_ATTN_SHAPE)} bf16 qkv views + bf16 bias [{H},{N},{N}]",
        bound=bound_ms(policy.name, 4 * B * N * H * D * 2 + H * N * N * 2,
                       4 * B * H * N * N * D, "bf16"))
    del bias, mask

    # the table entry at the same shape with a bf16 table of the 18x32 grid,
    # in turns with the dense entry on its expansion, SDPA with that
    # expansion as a float mask (the library yardstick), the unbiased entry
    # and the plain version; its bound reads q/k/v/out and the table once
    R = K2.relative_position_count(18, 32)
    table = (2.0 * torch.randn(H, R, generator=gen, device=dev)).to(torch.bfloat16)
    bias = K2.expand_rel_pos(table, 18, 32)
    mask = bias[None]
    t = time_both(torch, {
        "plain": lambda: K2.attention_relpos_ref(q, k, v, table, 18, 32),
        "kernel": lambda: K2.attention_relpos(q, k, v, table, 18, 32),
        "library": lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
        "dense": lambda: K2.attention(q, k, v, bias),
        "unbiased": lambda: K2.attention(q, k, v)})
    timing["attention_relpos"] = dict(
        t, shape=f"{list(BIAS_ATTN_SHAPE)} bf16 qkv views + bf16 table [{H},{R}] (18x32)",
        bound=bound_ms(policy.name, 4 * B * N * H * D * 2 + H * R * 2,
                       4 * B * H * N * N * D, "bf16"))
    del qkv, q, k, v, qh, kh, vh, bias, mask, table

    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.random((*FULL, 3), dtype=np.float32) * 255).to(dev)
    dep = torch.from_numpy(rng.random(FULL, dtype=np.float32)).to(dev)
    px = fast_px(dep)
    # the library yardstick: grid_sample on NCHW with the row held fixed
    img_nchw = img.permute(2, 0, 1)[None].contiguous()
    gy = torch.linspace(-1.0, 1.0, FULL[0], device=dev)[:, None].expand(FULL)
    grid = torch.stack([px / (FULL[1] - 1) * 2.0 - 1.0, gy], dim=-1)[None].contiguous()
    t = time_both(torch, {
        "plain": lambda: K3.horizontal_sample_ref(img, px),
        "kernel": lambda: K3.horizontal_sample(img, px),
        "library": lambda: F.grid_sample(img_nchw, grid, mode="bilinear",
                                         padding_mode="border", align_corners=True)})
    timing["warp"] = dict(t, shape=f"[{FULL[0]},{FULL[1]},3] f32",
                          bound=bound_ms(policy.name, (3 * 4 * 2 + 4) * px_f,
                                         OPS_PER_PX["warp3"] * px_f, "f32"))
    del img, dep, px, img_nchw, grid, gy

    args = fill_inputs(*FULL, seed=3)
    t = time_both(torch, {"plain": lambda: K5.dibr_warp_fill_blend_ref(*args, sweep_sign=-1.0),
                          "kernel": lambda: K5.dibr_warp_fill_blend(*args, sweep_sign=-1.0)})
    timing["dibr_fill"] = dict(t, library=None, shape=f"frame {FULL[0]}x{FULL[1]} one eye",
                               bound=bound_ms(policy.name, (3 * 4 * 2 + 3 * 4) * px_f,
                                              OPS_PER_PX["dibr_fill"] * px_f, "f32"))
    del args
    for name, kin, fout in VIT_L_DENSE:
        x, wq, scale, bias = dense_inputs(np, torch, dev, M_TOK, kin, fout, torch.bfloat16,
                                          True, seed=kin + fout)
        xq = x.float().clamp(-127, 127).round()
        xi, xq8 = xq.to(torch.bfloat16), xq.to(torch.int8)
        ones = torch.ones(M_TOK, 1, device=dev)
        wt = wq.t()  # [K, F] column-major, the layout cuBLASLt's int8 product takes
        w_bf16 = torch.randn(fout, kin, generator=gen, device=dev).bfloat16()
        b_bf16 = bias.bfloat16()
        t = time_both(torch, {
            "plain": lambda: K4.quant_dense_ref(x, wq, scale, bias),
            "kernel": lambda: K4.quant_dense(x, wq, scale, bias),
            "kernel_int32": lambda: K4.quant_dense(xi, wq, scale, row_scale=ones,
                                                   out_dtype=torch.int32),
            "library": lambda: torch._int_mm(xq8, wt),
            "linear_bf16": lambda: F.linear(x, w_bf16, b_bf16)})
        timing[f"quant_matmul_{name}"] = dict(
            t, shape=f"{name} [{M_TOK},{kin}] bf16 x [{fout},{kin}] int8 + bias",
            bound=bound_ms(policy.name, 2 * M_TOK * kin + fout * kin + 8 * fout
                           + 2 * M_TOK * fout, 2 * M_TOK * kin * fout, "int8"))
        del x, wq, scale, bias, xq, xi, xq8, ones, wt, w_bf16, b_bf16
    for name, tm in timing.items():
        log_timing(name, tm, card)
    torch.cuda.empty_cache()
    mark("3-4 kernel parity and times")

    # -- 5. flagship path: Half-SBS, fused tail -------------------------------
    t0 = time.perf_counter()
    model, spec = build_bound(FLAGSHIP_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED)
    model_build_s = time.perf_counter() - t0
    layers = len(model.backbone.layer)  # 24 for ViT-L
    frames = synthetic_frames(np, 4, FRAME_SHAPE[0], FRAME_SHAPE[1], SEED)
    paths = {}
    driven = {}  # path name → its ProgramCache, for the checks after a run

    def drive(name, net, mode, quality, want_shape, want, net_spec=None, n_frames=FRAMES,
              res=518):
        """Warm up, run `n_frames` frames of model `net` at depth resolution
        `res` through FrameEngine, check the counts `want` (kernel →
        launches per frame), time the stages."""
        net_spec = net_spec or spec
        cfg = config(programs, mode, quality, net_spec.name, res)
        program = programs.ProgramCache(cfg, net, net_spec, compute_dtype=policy.compute_dtype)
        warm = program.warmup(FRAME_SHAPE)
        source = SaturatingSource(frames, n_frames)
        sink = CheckingNullSink(want_shape)
        fps, counts, stats = run_engine(FrameEngine, program, source, sink, counters, n_frames)
        log(f"[{name}] {net_spec.name} {mode} {quality}: {n_frames} frames, {sink.count} "
            f"delivered; launches " + ", ".join(
                f"{k} {n} (want {want.get(k, 0) * n_frames})" for k, n in counts.items()))
        if any(counts[k] != want.get(k, 0) * n_frames for k in counts):
            raise AssertionError(f"{name}: a kernel was not launched as the path needs")
        driven[name] = program
        generic = not program.program.fused(*FRAME_SHAPE[:2])
        stages, out = stage_times(torch, programs, program, frames[0], cfg, net_spec, dev,
                                  generic)
        if tuple(out.shape) != want_shape or out.dtype != torch.uint8:
            raise AssertionError(f"{name}: step output {out.dtype} {tuple(out.shape)}")
        log(f"[{name}] engine {fps:.2f} frames/s over {n_frames} frames (fps counter "
            f"{stats.fps:.2f}); stage ms " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
            + f" (CUDA events at the stage seams, host launch gaps included, median of "
            f"{TIMED_RUNS}); first calls " + ", ".join(f"{k} {v:.2f}" for k, v in warm.items())
            + f"; {card}")
        paths[name] = dict(mode=mode, quality=quality, engine_fps=fps, fps_counter=stats.fps,
                           stage_ms=stages, warmup_s=warm, launches=counts)
        return cfg

    log(f"[main] {FLAGSHIP_MODEL} built in {model_build_s:.1f} s")
    flagship_cfg = drive("main", model, "Half-SBS", "high", (FRAME_SHAPE[0], FRAME_SHAPE[1], 3),
                         {"attention": layers, "dibr_pair": 1})

    # -- 6. reference on a small frame: card bf16 vs CPU f32 ----------------
    small_frame = synthetic_frames(np, 1, 216, 384, SEED + 1)[0]
    cpu_model, _ = build_bound(FLAGSHIP_MODEL, device="cpu", dtype=torch.float32, seed=SEED)
    refs = {}

    def reference(name, cfg, card_net, cpu_net, keep=None):
        card_prog = programs.ProgramCache(cfg, card_net, spec, compute_dtype=policy.compute_dtype)
        cpu_prog = programs.ProgramCache(cfg, cpu_net, spec, compute_dtype=torch.float32)
        refs[name] = reference_check(torch, f"{name}: {cfg.display_mode} {cfg.quality}",
                                     card_prog, cpu_prog, small_frame, keep)

    main_want = []
    reference("main", flagship_cfg, model, cpu_model, main_want)

    # -- 7./8. generic tail, high and fast quality ----------------------------
    full_cfg = drive("generic_high", model, "Full-SBS", "high",
                     (FRAME_SHAPE[0], 2 * FRAME_SHAPE[1], 3), {"attention": layers, "dibr_pair": 1})
    fast_cfg = drive("generic_fast", model, "Half-SBS", "fast",
                     (FRAME_SHAPE[0], FRAME_SHAPE[1], 3), {"attention": layers, "warp": 2})

    # -- 9. mode cycling: every mode twice, switched after each frame -------
    h, w = FRAME_SHAPE[:2]
    shapes = {m: (h, w, 3) for m in DISPLAY_MODES}
    shapes.update({"Full-SBS": (h, 2 * w, 3), "Full-TAB": (2 * h, w, 3)})
    cycle = programs.ProgramCache(config(programs), model, spec,
                                  compute_dtype=policy.compute_dtype)
    n_cycle = 2 * len(DISPLAY_MODES)
    source = LockstepSource(frames, n_cycle)
    sink = CyclingSink(cycle, source, K1.KERNEL, DISPLAY_MODES, shapes)
    zero_counts(counters)
    engine = FrameEngine(source, cycle, sink, target_fps=0.0)
    t0 = time.perf_counter()
    engine.run(duration=600.0)
    cycle_s = time.perf_counter() - t0
    cycle_counts = read_counts(counters)
    want_k1 = n_cycle - 2  # Depth, twice, runs no DIBR
    log(f"[cycle] {sink.count} frames through all {len(DISPLAY_MODES)} modes twice in "
        f"{cycle_s:.2f} s, each output shape checked; launches "
        + ", ".join(f"{k} {n}" for k, n in cycle_counts.items())
        + f" (want dibr_pair {want_k1}, attention {layers * n_cycle})")
    if (sink.count != n_cycle or cycle_counts["dibr_pair"] != want_k1
            or cycle_counts["attention"] != layers * n_cycle):
        raise AssertionError("mode cycling: frames or launches off")
    report["cycle"] = dict(frames=sink.count, seconds=cycle_s, launches=cycle_counts)
    del cycle, engine

    # -- 10. dibr_render at 4K, both eyes: K5 ---------------------------------
    rng = np.random.default_rng(4)
    rgb = torch.from_numpy(rng.random((*FULL, 3), dtype=np.float32) * 255).to(dev)
    dep = torch.from_numpy(rng.random(FULL, dtype=np.float32)).to(dev)
    zero_counts(counters)
    eyes = [S.dibr_render(rgb, dep, e * IPD / 2, STRENGTH, 0.0) for e in (-1, 1)]
    torch.cuda.synchronize()
    render_counts = read_counts(counters)
    ok = (render_counts["dibr_fill"] == 2 and sum(render_counts.values()) == 2
          and all(bool(torch.isfinite(e).all()) and e.min().item() >= 0.0
                  and e.max().item() <= 255.0 and e.shape == rgb.shape for e in eyes))
    log(f"[dibr_render] both eyes at {FULL[0]}x{FULL[1]}: launches "
        + ", ".join(f"{k} {n}" for k, n in render_counts.items())
        + f" (want dibr_fill 2); outputs finite in [0, 255] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("dibr_render did not run K5 twice, or its output is off")
    del rgb, dep, eyes

    # -- 11. reference for the generic tail ------------------------------------
    reference("generic_high", full_cfg, model, cpu_model)
    reference("generic_fast", fast_cfg, model, cpu_model)
    # the batched program's rows on the same frames (phase 43's path)
    pair = [small_frame, synthetic_frames(np, 1, 216, 384, SEED + 8)[0]]
    refs["batched"] = batched_reference(np, torch, programs, "main", flagship_cfg, model,
                                        cpu_model, spec, policy, [pair])
    KEPT["f32"][FLAGSHIP_MODEL] = dict(net=cpu_model, spec=spec, cfg=flagship_cfg,
                                       frames=[small_frame], want=main_want)
    del cpu_model

    # -- 12. int8 against bf16: one seed, one model input ---------------------
    t0 = time.perf_counter()
    model_q, _ = build_bound(FLAGSHIP_MODEL, device=dev, dtype=policy.compute_dtype, seed=SEED,
                             quant="int8")
    int8_build_s = time.perf_counter() - t0
    log(f"[int8] {FLAGSHIP_MODEL} int8 built in {int8_build_s:.1f} s (float draw, "
        f"quantisation on the CPU and the move to the card)")
    with torch.inference_mode():
        fp = programs.FrameProgram(flagship_cfg, model, spec, policy.compute_dtype)
        _, model_in = fp.preprocess(torch.from_numpy(frames[0]).to(dev))
        raw_f = model(model_in)[0].float()
        raw_q = model_q(model_in)[0].float()
    corr = torch.corrcoef(torch.stack([raw_f.flatten(), raw_q.flatten()]))[0, 1].item()
    rel = ((raw_q - raw_f).abs().max() / raw_f.abs().max().clamp_min(1e-6)).item()
    finite = bool(torch.isfinite(raw_q).all())
    ok = finite and corr >= INT8_MIN_CORR
    log(f"[int8] raw depth [{', '.join(map(str, raw_q.shape))}], int8 vs bf16 on the card: "
        f"correlation {corr:.5f} (min {INT8_MIN_CORR}), max rel err {rel:.4f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the int8 model does not track the bf16 model")
    report["int8_vs_bf16"] = dict(corr=corr, max_rel_err=rel, shape=list(raw_q.shape),
                                  model_input=list(model_in.shape))
    del fp, model_in, raw_f, raw_q  # the bf16 model stays for phase 15
    torch.cuda.empty_cache()

    # -- 13. int8 flagship path: Half-SBS, fused tail ------------------------
    drive("int8", model_q, "Half-SBS", "high", (FRAME_SHAPE[0], FRAME_SHAPE[1], 3),
          {"attention": layers, "quant_matmul": 4 * layers, "dibr_pair": 1})

    # -- 14. int8 reference on a small frame: card bf16 vs CPU f32 -----------
    cpu_model_q, _ = build_bound(FLAGSHIP_MODEL, device="cpu", dtype=torch.float32, seed=SEED,
                                 quant="int8")
    reference("int8", flagship_cfg, model_q, cpu_model_q)
    report["int8_vs_bf16"]["reference"] = refs["int8"]
    refs["batched_int8"] = batched_reference(np, torch, programs, "int8", flagship_cfg, model_q,
                                             cpu_model_q, spec, policy, [pair])
    del cpu_model_q

    # -- 15. one traced flagship frame and one traced int8 frame --------------
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    def trace(name, net, net_spec, cfg, staging, want, spans=()):
        """One traced 4K frame of `net`, after a warm-up and 3 untraced
        frames (a stateful model's carry is warm: the traced frame runs
        `step`), its kernel instances checked against `want`."""
        program = programs.ProgramCache(cfg, net, net_spec, compute_dtype=policy.compute_dtype)
        program.warmup(FRAME_SHAPE)
        engine = None
        if staging == "engine":
            # as FrameEngine runs a frame: _dispatch uploads it through the
            # pinned staging ring, runs the program and enqueues the copies
            # back into pinned memory; _finish waits on the `done` event
            engine = FrameEngine(None, program, CheckingNullSink(None), target_fps=0.0)

            def frame():
                t0 = time.perf_counter()
                engine._finish((*engine._dispatch(frames[1]), t0, t0))
        else:
            def frame():  # pageable upload from numpy, .cpu() downloads
                sbs, depth = program(frames[1])
                return sbs.cpu(), depth.cpu()

        for _ in range(3):
            frame()
        torch.cuda.synchronize()
        # the first frame under the profiler is its warm-up, traced and
        # discarded: CUPTI loses the device records of the first ~2 ms of
        # host launches after it starts (the upload's copy, the preprocess,
        # a ZoeDepth frame's first K2)
        path = out_dir / f"trace_{name}.json"
        host_ops = []

        def ready(p):  # the active frame's trace, kept when its cycle ends
            p.export_chrome_trace(str(path))
            host_ops.extend(p.key_averages())

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=ready) as prof:
            for _ in range(2):
                with record_function("frame"):
                    frame()
                torch.cuda.synchronize()
                prof.step()
        trace_json = json.loads(path.read_text())
        tr = summarize_trace(trace_json["traceEvents"] if isinstance(trace_json, dict)
                             else trace_json, spans)
        tr["staging"] = staging
        # the host's cost of getting the 4K frame onto the card, untraced
        # (median of 10): the engine's staging (copy into the pinned slot,
        # then a non-blocking H2D enqueue), or a pageable upload, which
        # returns when the copy is done
        up = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if staging == "engine":
                engine._staging.upload(frames[1])
            else:
                torch.from_numpy(frames[1]).to(dev)
            up.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        tr["upload_host_ms"] = statistics.median(up)
        # the host's side of the frame: CPU ops by self time (all threads)
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                       for e in host_ops), key=lambda kv: -kv[1])[:8]
        tr["host_top"] = [{"op": k, "self_ms": ms, "calls": n} for k, ms, n in host]
        g = tr["groups"]
        how = ("FrameEngine._dispatch/_finish: pinned upload, program, pinned download"
               if staging == "engine" else
               "harness path, not the engine's: pageable upload, program, .cpu()")
        log(f"[trace] {name} 4K frame ({net_spec.name}; {how}; {card}): span "
            f"{tr['span_ms']:.3f} ms, device busy {tr['busy_ms']:.3f} ms, idle share "
            f"{tr['idle_share']:.3f}; the upload's host ms, untraced, median of 10: "
            f"{tr['upload_host_ms']:.3f}; device ms (kernels) by group: "
            + ", ".join(f"{k} {v['ms']:.3f} ({v['calls']})"
                        for k, v in sorted(g.items(), key=lambda kv: -kv[1]["ms"]))
            + "".join(f"; of which inside {k}: " + (f"{v['ms']:.3f} ms ({v['calls']} kernels, "
                                                     f"{v['ranges']} ranges)" if v else
                                                     "not separable (no GPU-side range "
                                                     "in the trace)")
                      for k, v in tr["spans"].items())
            + "; top kernels: " + "; ".join(f"{k[:60]} {v['ms']:.3f} ({v['calls']})"
                                             for k, v in list(tr["top_kernels"].items())[:8])
            + "; host ops by self CPU ms: " + "; ".join(
                f"{h['op'][:40]} {h['self_ms']:.3f} ({h['calls']})" for h in tr["host_top"]))
        if any(g.get(k, {}).get("calls") != n for k, n in want.items()):
            raise AssertionError(f"trace {name}: kernel instances off, want {want}")
        return tr

    traces = {}
    for name, net, staging in (("flagship", model, "engine"), ("int8", model_q, "engine"),
                               ("flagship_pageable", model, "pageable")):
        want = {"K2 attention": layers, "K1 dibr_pair": 1}
        if name == "int8":
            want["K4 quant_matmul"] = 2 * 4 * layers  # the row pass and the product a call
        traces[name] = trace(name, net, spec, flagship_cfg, staging, want)
    report["trace"] = traces
    mark("5-15 DA-V2-Large paths, references, traces")
    # the weights the multi-GPU phases (52-55) shard, kept on the host
    KEPT["flagship"] = {k: v.cpu() for k, v in model.state_dict().items()}
    KEPT["int8"] = {k: v.cpu() for k, v in model_q.state_dict().items()}
    del model, model_q
    torch.cuda.empty_cache()

    # -- 16. the port's CLI on the card ----------------------------------------
    report["cli"] = {
        "flagship": cli_flagship(np, counters, layers, card, out_dir),
        "crop": cli_crop(np, torch, counters, layers, card, out_dir),
    }
    mark("16 the CLI")

    # -- 17. VDA flagship: Video-Depth-Anything-Large, 4K Half-SBS ----------
    report["vda"] = vda_phases(np, torch, programs, build_bound, drive, driven, trace, paths,
                               frames, policy, dev, card)

    # -- 20. a real-shape checkpoint on the card, and the CLI with it -------
    mark("17-19 VDA")
    report["checkpoint"] = checkpoint_phase(np, torch, build_bound, counters, dev, card, out_dir)
    mark("20 checkpoint")

    # -- 21-26. the Depth-Anything-3 family at 504 ----------------------------
    report["da3"] = da3_phases(np, torch, programs, build_bound, drive, driven, trace, paths,
                               frames, counters, policy, dev, card, out_dir)
    mark("21-26 DA3")

    # -- 27-29. the remote topology; 30. the control panel ----------------------
    report["remote"] = remote_phases(np, counters, layers, card, out_dir)
    for name in ("xr_raw", "xr_zlib", "xr_zlib_desktop", "xr_mono"):
        r = report["remote"][name]
        log(f"[remote] {name}: engine {r['engine_fps']:.2f} frames/s against the synthetic-source "
            f"flagship's {paths['main']['engine_fps']:.2f} (phase 5) and the CLI's "
            f"{report['cli']['flagship']['timed']['fps']:.2f} (phase 16a) in this call; ingest "
            f"{r['ingest_fps']:.2f} fps; the XR client {r['client']['fps']:.2f} frames/s; {card}")
    report["control"] = control_phase(card, out_dir)
    mark("27-30 remote topology")

    # -- 31-37. the classic DPT family ------------------------------------------------
    report["classic_dpt"] = classic_dpt_phases(np, torch, programs, build_bound, drive, driven,
                                               trace, paths, frames, counters, policy, dev,
                                               card, out_dir)
    mark("31-37 classic DPT")

    # -- 38-40. ZoeDepth, DepthPro and InfiniDepth --------------------------------------------
    report["last_families"] = last_families_phases(np, torch, F, programs, build_bound, drive,
                                                   driven, trace, paths, frames, counters,
                                                   policy, dev, card, out_dir, timing, worst)
    mark("38-40 ZoeDepth, DepthPro, InfiniDepth")

    # -- 41-48. multi-stream serving, the profiler and the build tools ---------------
    report["multi"] = multi_stream_phases(np, torch, programs, build_bound, counters, frames,
                                          policy, dev, card, out_dir, timing, worst)
    multi = report["multi"]["paths"]
    mark("41-48 multi-stream and tools")

    # -- 49-51. the XR client: render at 4K, end to end, the self-test -------------
    report["xr_client"] = xr_client_phases(np, torch, counters, card, out_dir, dev)
    mark("49-51 XR client")

    # -- 52-56. the multi-GPU path: TP, TP int8, DP, TP + SP on the giant -----------
    report["parallel"] = parallel_phases(np, torch, F, K2, K4, card, dev, policy, timing, worst)
    par = report["parallel"]["launches"]
    mark("52-56 the multi-GPU path")

    # -- 57. K2 in f32; 58. `--fp32` on the card; 59. the checkpoint tool -----------
    report["k2_f32"] = k2_f32_phase(np, torch, F, K2, card, dev, policy, timing, worst)
    mark("57 K2 in f32")
    report["fp32"], f32_models = fp32_phases(np, torch, programs, counters, card, out_dir, dev,
                                             layers, paths)
    mark("58 --fp32")
    report["convert"] = converter_phase(np, torch, counters, card, dev, f32_models, out_dir,
                                        paths)
    del f32_models
    mark("59 the checkpoint tool")
    report["phase_seconds"] = {label: round(b - a, 1) for (_, a), (label, b)
                               in zip(marks, marks[1:])}
    log("[time] wall s by phase group: " + ", ".join(
        f"{k} {v}" for k, v in report["phase_seconds"].items())
        + f"; in all {marks[-1][1] - marks[0][1]:.1f} s")

    def entry(name, source, replaces, key, by_path):
        """`launches` sums the runs in `by_path` (path → that run's count,
        each read from its own run with the counts set to 0 before it)."""
        tm = timing[key]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(by_path.values()), "launches_by_path": by_path,
                "max_abs_err": float(worst[name]), "ms": tm["kernel"],
                "plain_ms": tm["plain"], "bound_ms": tm["bound"][0],
                "bound_by": tm["bound"][1], "library_ms": tm.get("library")}

    csrc = "desktop2stereo_tpu_torch/csrc/"
    pallas = "desktop2stereo_tpu/ops/pallas/"

    def launches(kernel, *names):
        return {n: paths[n]["launches"][kernel] for n in names}

    def remote_launches(kernel, name):  # a remote CLI run's count, after its warm-up
        return {f"remote_{name}": report["remote"][name]["launches"]["run"][kernel]}

    def multi_launches(kernel, *names):  # the multi-stream paths' counts (41-46)
        return {f"multi_{n}": multi[n]["launches"][kernel] for n in names}

    # each entry's launches: the slice's main path, and the DA3, classic DPT,
    # ZoeDepth, DepthPro and InfiniDepth paths' beside it
    classic = ("beit", "dpt_large", "dpt_hybrid", "dpt_dinov2")
    last = ("zoedepth", "depthpro", "infinidepth")
    kernels = [
        entry("dibr_pair_half", csrc + "dibr_pair.cu", pallas + "dibr.py:535",
              "dibr_pair_half", {**launches("dibr_pair", "main", "da3", *classic, *last),
                                 **remote_launches("dibr_pair", "xr_raw"),
                                 **multi_launches("dibr_pair", "round_robin")}),
        entry("dibr_pair_half_s2", csrc + "dibr_pair.cu", pallas + "dibr.py:535",
              "dibr_pair_half_s2", multi_launches("dibr_pair", "batched", "batched_int8",
                                                  "batched_vda", "batched_beit")),
        entry("dibr_pair_eyes", csrc + "dibr_pair.cu", pallas + "dibr.py:535",
              "dibr_pair_eyes", {**launches("dibr_pair", "generic_high"),
                                 **remote_launches("dibr_pair", "xr_mono")}),
        entry("dibr_pair_eyes_s2", csrc + "dibr_pair.cu", pallas + "dibr.py:535",
              "dibr_pair_eyes_s2", multi_launches("dibr_pair", "batched_generic_high")),
        entry("attention", csrc + "attention.cu", pallas + "flash_attention.py:79",
              "attention", {**launches("attention", "main", "da3", "dpt_large", "dpt_hybrid",
                                       "dpt_dinov2", "depthpro", "infinidepth"),
                            **remote_launches("attention", "xr_raw"),
                            **multi_launches("attention", "round_robin", "batched",
                                             "batched_vda")}),
        entry("attention_bias", csrc + "attention.cu", pallas + "flash_attention.py:79",
              "attention_bias", launches("attention_bias", "beit_dense_api")),
        entry("attention_relpos", csrc + "attention.cu", pallas + "flash_attention.py:79",
              "attention_relpos", {**launches("attention_relpos", "beit", "beit_int8",
                                              "zoedepth"),
                                   **multi_launches("attention_relpos", "batched_beit")}),
        # K2's f32 body: `--fp32` (the CLI and the small-frame references) and
        # the converter's pipeline (phases 58-59)
        entry("attention_f32", csrc + "attention.cu", pallas + "flash_attention.py:79",
              "attention_f32", launches("attention_f32", "fp32_cli", "fp32_reference",
                                        "converter_da_v2")),
        entry("attention_bias_f32", csrc + "attention.cu", pallas + "flash_attention.py:79",
              "attention_bias_f32", launches("attention_bias_f32", "fp32_beit_dense_api")),
        entry("attention_relpos_f32", csrc + "attention.cu", pallas + "flash_attention.py:79",
              "attention_relpos_f32", launches("attention_relpos_f32", "fp32_beit_reference",
                                               "fp32_beit_dense_api", "converter_beit")),
        entry("warp", csrc + "warp.cu", pallas + "warp.py:93", "warp",
              {**launches("warp", "generic_fast"),
               **multi_launches("warp", "batched_generic_fast")}),
        entry("dibr_fill", csrc + "dibr_fill.cu", pallas + "dibr.py:709", "dibr_fill",
              {"dibr_render": render_counts["dibr_fill"],
               **report["xr_client"]["launches"]}),
        entry("quant_matmul", csrc + "quant_matmul.cu", pallas + "quant_matmul.py:122",
              "quant_matmul_fc1", {**launches("quant_matmul", "int8", "da3_int8", "beit_int8",
                                              "depthpro_int8", "infinidepth_int8"),
                                   **multi_launches("quant_matmul", "batched_int8")}),
        # the multi-GPU path: one rank's launches (phases 52-55), timed at one
        # rank's shapes
        entry("attention_tp", csrc + "attention.cu", pallas + "flash_attention.py:79",
              "attention_tp", {**par["attention_tp"], "dp": par["attention_dp"]}),
        entry("quant_matmul_tp_col", csrc + "quant_matmul.cu", pallas + "quant_matmul.py:122",
              "quant_matmul_tp_fc1", {"tp_int8": par["quant_matmul_tp_col"]}),
        entry("quant_matmul_tp_row", csrc + "quant_matmul.cu", pallas + "quant_matmul.py:122",
              "quant_matmul_tp_fc2", {"tp_int8": par["quant_matmul_tp_row"]}),
    ]
    report.update(kernels=kernels, timing=timing, frames=FRAMES, paths=paths,
                  reference=refs, model_build_s=model_build_s, int8_build_s=int8_build_s,
                  torch=torch.__version__, cuda=torch.version.cuda)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    log("[device] host packages the sinks and sources import when made: " + ", ".join(
        f"{k} {v}" for k, v in report["host_packages"].items()))
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
