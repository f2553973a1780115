"""On-card smoke run of the PyTorch port: the mesh -> u8 frame path, the
2D canvas, the textured mesh -> u8 frame path, the float/depth Gouraud
rasterizer, the wf= and mxu= routes of the u8 entries, the recorded
2D frame -> u8 pipeline, the audio engine with the MIDI -> WAV app, and
the blended quad batch (BASELINE config 2).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX.  Phases, one line each (or a few), any failure
raising:
  1. device: the card, and its name and power limit from nvidia-smi;
  2. build: K1, K3, K2b, K2a, K5, K6, K1-wf, K1-mxu
     (csrc/tile_raster.cu), K4 (csrc/canvas_span.cu), the audio
     scatter kernel (csrc/audio_scatter.cu) and K7 (csrc/tile_blend.cu)
     compiled from the checkout, one nvcc each, started together; ptxas registers and
     spills for each instantiation, the MMA walk's held to no spill, at
     most MMA_MAX_REGS registers and no serialized wgmma (ptxas warning
     C7518) (phase 16 adds the count of HGMMA
     instructions in the library's SASS, from cuobjdump), and K5's, K2b's,
     K6's and K2a's split walks held to no spill and every K2b, K6 and K2a
     instantiation present, their registers printed, and no kernel of the
     one-block-a-tile walk left in the build; then the MMA
     walk's layout probe: one wgmma of the walk's own operands against
     the float64 product of the same bf16 parts, before any walk uses it;
  3. k1 vs plain: the per-frame prep of mesh_10k at 1920x1080 (tiles
     32x32, span (5, 3), capacity 1024) for 4 cameras (opaque, no z test)
     and one of them again with opaque=False, z_clip=True, fed to K1 and
     to its plain torch version on the card; the packed (NT, P) outputs
     must be bit-equal.  Then the same at the tile shapes of the kernel's
     other instantiations (1, 2, 8 and 16 pixels a thread, the JAX
     entry's default 128x16 among them), one of them with runs longer
     than the capacity (a flagged overflow, whose reads stay in bounds);
     then K1's split walk on runs at its boundaries (testing.crafted_runs:
     1, S, S + 1, 2S, 2S + 1 and 1024 slots with NaN rows, a run read past
     the pair array, runs overlapping past the item list's capacity) at
     the kernel's S; mesh_10k's run statistics (longest, mean, tiles over
     S, items);
  4. mesh main path: MeshVideoPipeline over 48 frames, batch 16, into a
     tiled sink and into a plain sink, after 3 timed runs of each whose
     sink drops the frames; no overflow, K1 launched once per batch,
     every frame more than 10 % mesh, tiled == plain after the detile,
     and one frame equal to the same frame rendered on the CPU by the
     plain versions;
  5. mesh times: K1 and plain ms/frame (CUDA events), pipeline frames/s,
     peak device memory; K1 in turns (the stream held by a sleep while
     the calls queue, so device time alone), one frame a launch and 4
     frames in one, at 32x32 and 128x16, beside the bound, with ptxas
     registers
     and blocks an SM of the split walk on the CUDA and the tensor cores;
  6. k4 vs plain: at 1920x1080, in float32 and float64, K4 and its plain
     version on (a) bench.py's 60-command canvas frame (one run, its 42
     blits among its arithmetic draws) over a nonzero framebuffer, (b) a
     seeded 64-command frame of all 9 arithmetic kinds, mostly
     full-frame or large, under rotations, scales and colour transforms,
     (c) a seeded run of texture blits of the three kinds among lines
     and rects, rotated, scaled, partly off the frame, and 3 blits whose
     index leaves the atlas (NaN texels at the same places, their
     payload bits printed), (d) SET_PIXEL and APPLY_PIXEL on both sides
     of tile borders, (e) every 4th frame of the benchmark's chart
     traffic over its atlas (one run each); (b) and (d) again on a
     1000x700 frame (partial tiles); bit-equal, with the tiles each run
     launches, and render_span.sampled counting every blit; then a run
     that touches no tile: no launch, no change;
  7. canvas main path: RenderContext(1920, 1080, True) on the card
     (float32) through 45 frames of bench.py's draw(t) with 4 seeded
     128x128 textures, one flush a frame; K4 launched once a frame, and
     the last frame's u8 buffer bit-equal to the same script run on the
     CPU through the port;
  8. canvas times: ms/frame on the host clock (3 runs of 45 frames, each
     ended by a sync), K4 and plain ms per launch on phase 6's 1080p runs
     (a), (b), (c) and two of (e) (CUDA events) beside each run's bound,
     host launch and
     sync calls a
     frame and the device's busy share (profiler, 16 frames), peak
     device memory;
  9. blits card vs cpu: two seeded 1920x1080 frames of what bench.py's
     frame leaves out, rotated and scaled blits and milrenderer's hit
     effects (Helpers' dissolve textures), drawn on the card and on the
     CPU in float32 and float64; the u8 frames bit-equal, except float32
     hit effects within HIT_FLIP_SHARE of their pixels and nowhere else;
     then torch.sin and the dissolve alpha, card against CPU, as the
     cause;
 10. tex vs plain: the per-frame prep of bench.py's textured mesh_10k
     (planar uvs, seeded 256x256 u8 texture) at 1920x1080 (tiles 32x32,
     span (5, 3), capacity 1024) for 4 cameras (perspective-correct,
     z_clip on), one with z_clip off, one affine, one with a 300x200
     texture and one with crafted uv rows (huge, negative, tiny or zero
     denominators, NaN), fed to K3, K2b and K2a and to their plain
     versions on the card; packed texels, texel indices, keys and the
     float attributes' bits must be equal; K3's and K2b's split walks on
     phase 3's boundary runs (K2b also with crafted uv rows, and 4 frames
     in one launch: one with a run past its pair array, two with crafted
     uv rows), z test on and off; K2a's split walk on the same boundary
     runs (a run past the array, runs overlapping past the item list's
     capacity: the plan's fallback) at 128x8, 128x16 and 32x32, one frame
     a launch and 4 in one launch, z test on and off, and on knife-edge
     rows on its warp boxes' borders at 128x16, keys and attribute bits
     equal, with the share of (row, warp) pairs its cull keeps;
 11. textured main paths: MeshVideoPipeline(uvs=, tex_u8=) on its
     default device over 48 frames, batch 16, into a tiled and a plain
     sink, after 3 timed runs into a sink that drops the frames: no
     overflow, K3 launched once a batch, tiled == plain, one frame equal
     to the CPU plain path's; render_textured (K2a) on one frame, rgba
     and depth equal card vs CPU, then K2a against its plain version,
     keys and attribute bits, at render_textured's own shapes (128x8
     tiles, span (2, 10), capacity 512) on that frame's prep and the 4
     cameras'; render_binned_tex_idx_batch (K2b) over the 4 cameras, one
     launch for the 4 frames, bit-equal to the plain version;
 12. textured times: K3, K2b and K2a and their plain versions ms/frame
     (CUDA events; K3 and K2b at 32x32 tiles, K2b's with the 4 frames in
     one launch, its main path's, K2a at render_textured's shapes) beside
     each bound; K3 beside K2b (both the split walk, apart by K3's texel
     load) in turns (calls queued behind a sleep), one frame a launch and
     4 in one, at 32x32 and 128x16, each beside its bound,
     with registers and blocks an SM; K2a in turns at its three main
     paths' shapes (render_textured's 128x8 and render_gouraud_pallas
     (flat=True)'s 128x16 one frame a launch, the batch entry's flat
     route at 128x32 with the 4 frames in one launch), each beside its
     bound (the larger of its bytes and its culled walk's operations,
     the kept share from tile_raster.pairs_cull_keep) and the old
     yardstick, with its registers and blocks an SM; the device time by
     kernel, host
     launches and syncs a frame and the busy share (profiler, 16
     frames), pipeline frames/s, peak device memory;
 13. k5 / k6 vs plain: at 1920x1080 on mesh_10k for 4 cameras, K5 on
     render_gouraud_pallas's default prep (128x16 tiles, capacity 512,
     span (8, 8), box-culled bins) one frame a launch, on the 4 frames in
     one launch at the batch defaults (128x32, span (8, 4)) and on one
     frame at 32x8, and on crafted bins (testing.crafted_bins: runs of 1,
     S, S + 1, 2S, 2S + 1, K and K + 37 slots, NaN and knife-edge rows;
     one frame at 128x16 and 4 in one launch at 128x32), against its
     plain version: keys and float bits equal, no overflow, and the share
     of (row, warp) pairs K5's cull keeps; K2a's batched launch on the 4 frames' pair preps at the
     batch defaults against its plain version, the same; K6 on the 4
     frames' rows gathered in pair order (32x32,
     span (5, 3), capacity 1024, opaque, no z test) against its plain
     version and K1's batched launch, and one frame a launch; K6 on
     phase 3's boundary runs with rows gathered in pair order (one frame
     a launch: CAP the pair array's length, and cut below the runs' end
     by 10 rows and by 1000, when the item list no longer fits; 4 frames
     in one launch, one with a run past CAP, and all 1000 rows past it)
     against its plain version and, where the rows hold every run, K1;
     render_gouraud_pallas_batch (dynrows=g) for g in 1, 2, 4 against the
     u8 route: bit-equal;
 14. gouraud main path: render_gouraud_pallas at its defaults on the 4
     frames, K5 launched once a frame, no overflow, frame 0 equal to the
     CPU's; render_gouraud_pallas(flat=True) at its defaults (128x16) on
     the 4 frames, K2a launched once a frame, each frame bit-equal to K2a's
     plain version on its prep, frame 0 equal to the CPU's;
     render_gouraud_pallas_batch over the 4 frames on each route
     (K5, K2a, K1, K6), one launch each, each frame equal to
     render_gouraud_pallas's at the same shapes; render_gouraud_binned,
     render_gouraud (naive), near clipping (the eye inside the ring of
     quads) on the K5, flat f32 (K2a), flat u8 (K1) and binned routes,
     render_gouraud_binned(perspective_correct=True),
     render_binned_pallas(return_ids=True), render_textured_binned on the
     textured scene and render_blended on BASELINE config 2's scene, card
     against CPU at 480x270 or 240x135, equal;
 15. gouraud times: K5 (one frame a launch and batched), K6, K1's batched
     launch and the plain versions, ms/frame (CUDA events) beside each
     bound (K5's from the walk its cull leaves, beside the old yardstick
     of every walked pair at every tile pixel), K5's registers and blocks
     an SM; render_gouraud_pallas frames/s (host clock), the device time
     by kernel, host launches a frame and the busy share (profiler, 16
     frames), peak device memory;
 16. wf / mxu vs plain: at 1920x1080 on mesh_10k for the 4 cameras, K1-wf
     against its plain version and K1, bit-equal, at render_gouraud_u8's
     defaults (128x16, capacity 512, span (8, 8)) and at the video shape
     (32x32, span (5, 3), capacity 1024, opaque, no z test), for wf in 1, 8
     and NT, one frame a launch and the 4 frames in one launch, and on
     phase 3's boundary runs; K1-mxu (mxu=1 and 2, opaque and not, at the
     video shape; mxu=1 at the defaults) against its plain version and
     mxu=1 against K1 (K1-wf's mxu walk bit-equal to K1-mxu's), the shares
     of differing pixels, of pixels off by more than 1 level and of
     hit-mask flips printed and held to MXU_SHARE and MXU_BIG_SHARE (and
     against K1 to JAX's budget, FMA_MXU_SHARE and FMA_MXU_BIG_SHARE); K3's
     mxu walk on bench.py's textured mesh_10k (perspective-correct and
     affine) against its plain version, the same texel on at least
     TEX_SAME_SHARE of the pixels, and K3 (FMA_TEX_SAME_SHARE); as a control
     of those limits, the plain versions at mxu=2 against mxu=1, printed;
     the boundary runs over affine tables
     through K1-mxu, K1-wf's mxu walk and K3's mxu walk; then the entries,
     each kernel's launches counted from zero:
     render_gouraud_pallas(flat, u8, wf=8) and (mxu=1) on the 4 frames, one
     launch a frame, frame 0 card against CPU (wf bit-equal, mxu within the
     budget), render_gouraud_pallas_batch(mxu=1) one launch and equal to
     the single frames, render_textured_u8_batch(mxu=1) one launch, frame 0
     against the CPU;
 17. wf / mxu times: K1-wf (wf 1, 8, NT) and K1-mxu (mxu 1, 2), one frame
     a launch and batched, in turns beside K1's single and batched
     launches on the same frames (calls queued behind a sleep), at the
     video shape and the entries' defaults; K3's mxu walk beside K3 the
     same way; the plain versions; bounds (K1-mxu's the larger of its
     tensor-core work at the dense bf16 peak and its CUDA-core work),
     registers and blocks an SM;
 18. frame pipeline: bench.py:700-775's e2e mix (a fill, 24 split blits
     of 4 seeded 128x128 textures, 8 rects) recorded at 1920x1080
     float32 on a MultiThreadedVideoRenderContextPreparer, 45 frames
     through BatchedVideoPipeline at batch 15 from a zero fb0, both on
     their default device, the card; K4 launched once a frame (added to
     its kernel-table entry), every frame the sink receives bit-equal to
     the same frame flushed by a RenderContext on the card from fb0, the
     last one to the CPU port's; then the mix beside a 256x256 shared
     texture its owner redraws every frame and 2 hit effects of it: each
     frame bit-equal to its flush at its record point (from an owner of
     its own) outside the hit effects' windows, within HIT_FLIP_SHARE
     inside, the store no longer growing after 2 batches and the
     retired region sets bounded; then ms/frame and frames/s on the host
     clock (3 runs after a warm one, into a sink that drops the frames),
     launches, syncs and copies a frame, the device's busy share
     (profiler, 15 frames) and peak device memory.
 19. audio vs cpu: each AudioClip op at bench.py:778-822's scale (a
     112 s, 44.1 kHz stereo float64 target), run twice on the card and
     once on the CPU port: gain, resample (48 -> 44.1 kHz stereo, 44.1
     -> 18 kHz, 2 -> 1 channel), cut (in range, past the end, from a
     negative start), overlay (with a negative start), overlay_many on
     the scatter route (64 events x 4,096 frames) and on the FFT route,
     overlay_groups (200 groups of 1-40 events, clips of 2k-48k frames);
     the two card runs bit-identical, card = CPU bit for bit but on the
     FFT route (within AUDIO_FFT_ATOL), and the save_as_wav bytes equal
     (on the FFT route within one level, the share printed); then the
     scatter kernel at the mixer's shape (a ~115.6 s stereo float32
     target, 1,500 events of 1.0 s clips from 219): bit-equal to its plain
     version on the card, one launch a call, its device ms a call
     (queued), the plain slice-add loop's host ms and device busy time
     (profiler), the host's ms to enqueue an overlay_groups call, the
     byte bounds, registers;
 20. audio main path: apps.hjm_mixer.main on its default device, the
     card, on a seeded song (SONG_NOTES notes, ~2 minutes) and a seeded
     bank of 396 48 kHz WAVs written to a temporary directory: the WAV
     bytes bit-equal to the same call with device="cpu"; groups, events,
     launches and busy share (profiler), wall time and xRT (host clock),
     the bank's decode and resample share, peak device memory; then the
     web service's mix_request on the card and the CPU (synth_base within
     AUDIO_FFT_ATOL, the answer within one level), and which encoder ran;
 21. audio times: bench.py's mixdown (876 overlays of a 0.5 s clip onto
     the 112 s target, the FFT route, then to_int16_device) in float64
     and float32: best of 3 on the host clock after a warm run, CUDA-event
     device time, xRT, save_as_wav time and bytes, launches and busy
     share (profiler), peak device memory;
 22. mesh batch: the mesh cell's shapes (mesh_10k, 1920x1080, tiles
     32x32, span (5, 3), capacity 1024, batch 16, opaque, no z test):
     the batch's prep (prepare_frame with 16 matrices) equal on the card
     to the 16 per-frame preps (starts, counts, table, overflow, the
     pairs of tiles < NT), and render_gouraud_u8_loop's frames, detiled
     and tiled, bit-equal to the 16 frames of render_gouraud_u8, with
     one K1 launch a call; then ms a batch of the loop and of the 16
     per-frame renders in turns (host clock, each call ended by a sync;
     and CUDA events with the calls queued, device time alone), host
     launch and copy calls a batch and the device's busy share
     (profiler).
 23. blend: the blended quad batch of the cell baseline_textured_720p
     (its configuration and the system's inputs: the scene, the opaque
     depth ramp from the first frame, 32x32 tiles, span 12x12, capacity
     2048): at 320x192 with 256 quads and 4 frames, K7 against its plain
     version on the card's prep and render_blended_u8_loop's frames on
     the card against the CPU's, bit for bit; at 1280x720 with 4,096
     quads and 16 frames a launch, K7's device ms a batch (CUDA events,
     queued) beside its bound (rooflines/tile_blend over the reference's
     covered and drawn fragments, operations at the kernel table's
     float32 peak), K7 against its plain version on the same card
     tensors, bit for bit, and that plain version's device ms, the
     loop's ms (prep, K7, detile), registers; then
     MeshVideoPipeline(blend=True) over 3 batches held to one prep and
     one K7 launch a batch.
The line before the last is the kernel table as JSON (the audio path has
no Pallas kernel, so no row of its own; the scatter kernel and K7,
which replace none, have theirs), the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import inspect
import json
import math
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

WIDTH, HEIGHT = 1920, 1080
PROD = dict(tile_w=32, tile_h=32, capacity=1024, span_x=5, span_y=3)
FRAMES, BATCH = 48, 16
# (tile_w, tile_h, capacity, opaque, z_clip) for the kernel's other
# pixels-per-thread instantiations; 64x64 with capacity 64 overflows
OTHER_SHAPES = [(16, 16, 1024, False, True), (32, 16, 1024, True, False),
                (128, 16, 2048, False, True), (64, 64, 64, True, True)]
CANVAS_FRAMES = 45
SMALL_FRAME = (1000, 700)   # K4 at partial tiles (31.25 x 21.9 of them)
CHART_EVERY = 4             # phase 6 checks every 4th recorded chart frame
PROFILE_FRAMES = 16
# Float32 hit effects may differ between the card and the CPU on this
# share of the pixels their windows hold: torch.sin is not correctly
# rounded on either, differs by an ulp on ~20 % of the arguments, and the
# x43758.5453 hash of the dissolve noise turns that into ~3e-3, enough to
# flip an alpha at the threshold (ROADMAP "Parity contracts").
HIT_FLIP_SHARE = 1e-3

# One H100 SXM at its full 700 W (NVIDIA's data sheet): memory rate, and
# the peak rates of separate operations outside the tensor cores.  The
# data sheet's 67 TFLOP/s float32 and 34 TFLOP/s float64 count a fused
# multiply-add as two operations; both kernels are built with
# -fmad=false for bit parity and count each multiply and add as one, so
# those issue at half the rates.
MEM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.float32: 33.5e12, torch.float64: 17e12}
# K1's operations per (pixel, triangle) of the walk, counted from
# csrc/tile_raster.cu: 3 edges (2 mul, 2 add each), z (3 mul, 2 add),
# 3 coverage compares, the z quantisation (mul, convert), the key (shift,
# or) and the running-minimum test (compare, and)
K1_OPS_PER_PAIR = 26
# The textured epilogues' operations per pixel slot, counted from
# csrc/tile_raster.cu: K2b 31 (three attributes of 5, the guarded
# denominator 2, per coordinate a divide, a multiply and a conversion,
# 4 clamps, the index 2, the sky select 2), K3 32 (K2b's and the texel
# load's address), K2a 25 (four attributes of 5, the sky test and 4
# selects)
K2B_EPI_OPS, K3_EPI_OPS, K2A_EPI_OPS = 31, 32, 25
# K1's opaque u8 epilogue a pixel slot, counted from csrc/tile_raster.cu:
# three channels of 5 (the attribute) and 4 (x255, two clamps, the
# conversion), the packing 6, the sky select 2.  K6 and K1's batched launch
# are held to bounds with it (K1's table row keeps its walk-only bound)
U8_EPI_OPS = 35
# K4's operations per pixel of a command's box, counted from
# csrc/canvas_span.cu: ~14 for the snapped inverse point, 4-8 compares,
# 10 for the blend (RECT 28, LINE ~60, FILL 10): ~25 on a typical frame
K4_OPS_PER_PIXEL = 25
# K5's cull a (row, warp), counted from csrc/tile_raster.cu (box_culled):
# per edge the two corner selects (2 compares, 2 selects), the edge (2
# mul, 2 add), its sign test and the or: 30; the ballots and the mask
# walk are a few a row and warp more
CULL_OPS = 30


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def camera(mesh, k: float, step: float):
    """bench.py's 1080p camera, turned k * step radians about y."""
    proj = mesh.perspective(1.0, WIDTH / HEIGHT, 0.1, 10.0)
    view = mesh.look_at([0.0, 0.6, 3.2], [0, 0, 0], [0, 1, 0])
    return (proj @ view @ mesh.rotation_y(k * step)).astype(np.float32)


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean device ms per call of fn over reps calls, after one warm-up.
    With ``queued`` the stream first sleeps for longer than the host
    takes to queue the calls (1.5 x a synced call's wall time, at most
    0.1 s; torch.cuda._sleep counts cycles, taken at 2 GHz, above the
    H100's clock), so the events time the device's work back to back and
    not the host's launches; without it (the kernel table's times, as in
    every earlier run) a call the host queues slower than the device runs
    it is timed at the host's rate."""
    fn()
    torch.cuda.synchronize()
    if queued:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ahead_s = min(0.1, 1.5 * reps * (time.perf_counter() - t))
        torch.cuda._sleep(int(ahead_s * 2e9))
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def ptxas_summary(log: str) -> str:
    """'entry: N registers, S B spill stores/loads' for each kernel
    instantiation in an nvcc -Xptxas=-v log."""
    out, entry = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry, spill = m.group(1), "spills not reported"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and entry:
            spill = f"{m.group(1)}/{m.group(2)} B spill stores/loads"
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.append(f"{entry}: {m.group(1)} registers, {spill}")
            entry = None
    return "; ".join(out)


class PlainSink:
    def __init__(self):
        self.frames = []

    def put_frame_u8(self, u8):
        self.frames.append(u8)


class TiledSink:
    def __init__(self):
        self.tiles = []

    def put_frame_tiled_u8(self, tiles, w, h, tw, th):
        self.tiles.append((tiles, w, h, tw, th))


class DropSink:
    """Keeps no frame, as an encoder after encoding it: the pipeline's
    pinned host buffers are then reused, not allocated for every batch."""

    def put_frame_u8(self, u8):
        pass

    def put_frame_tiled_u8(self, tiles, w, h, tw, th):
        pass


def profile_frames(run, n: int):
    """Profile run() (n frames), ended by a sync: (host cudaLaunchKernel,
    cudaStreamSynchronize and cudaMemcpyAsync calls a frame, the device's
    busy share as text, the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    calls = {"cudaLaunchKernel": 0, "cudaStreamSynchronize": 0,
             "cudaMemcpyAsync": 0}
    spans = []
    for e in prof.events():
        if e.name in calls:
            calls[e.name] += 1
        elif e.name == "cudaLaunchKernelExC":
            calls["cudaLaunchKernel"] += 1
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
    busy_us, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    per_frame = {k: v / n for k, v in calls.items()}
    busy = (f"{busy_us / 1e3} ms of {wall_us / 1e3} ms wall, busy share "
            f"{busy_us / wall_us:.4f}") if spans else \
        "not measured (the profiler recorded no device activity)"
    return per_frame, busy, prof


def pairs_bound(frames, p: int, epi_ops: int, out_bytes_px: int):
    """(bound ms, 'bytes'|'operations', bytes ms, operations ms, pairs) of
    a tile walk, the mean over ``frames``, each (pairs walked, tiles,
    input bytes): the inputs once and ``out_bytes_px`` a pixel slot of
    output; K1_OPS_PER_PAIR operations per (pair, pixel) and ``epi_ops``
    per pixel slot, ``p`` pixels a tile."""
    byte_s, op_s, pairs = [], [], []
    for n_pairs, tiles, in_bytes in frames:
        slots = tiles * p
        byte_s.append((in_bytes + out_bytes_px * slots) / MEM_BYTES_S)
        op_s.append((n_pairs * p * K1_OPS_PER_PAIR + slots * epi_ops)
                    / PEAK_OPS_S[torch.float32])
        pairs.append(n_pairs)
    bytes_ms = 1e3 * float(np.mean(byte_s))
    ops_ms = 1e3 * float(np.mean(op_s))
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms, pairs


def culled_bound(old, keeps, p: int) -> tuple:
    """K5's and K2a's bound, the larger of the bytes (``old``, their
    pairs_bound with K2A_EPI_OPS and 4 + 16 B a pixel slot out) and the
    culled walk's operations: per frame of ``keeps``, each (kept, tested,
    tiles), the kept (row, warp) pairs x the pixels of a warp (tiles of
    ``p``) x K1_OPS_PER_PAIR, plus CULL_OPS a tested (row, warp) and
    K2A_EPI_OPS a pixel slot.  Returns (bound ms, 'bytes'|'operations',
    bytes ms, culled operations ms, pairs, the old yardstick's operations
    ms (every walked pair at every tile pixel), the kept share of the
    tested (row, warp) pairs)."""
    from libnativecpurenderer_tpu_torch.ops.tile_raster import WARPS
    ops_ms = 1e3 * float(np.mean([
        (kept * (p // WARPS) * K1_OPS_PER_PAIR + tested * CULL_OPS
         + tiles * p * K2A_EPI_OPS) / PEAK_OPS_S[torch.float32]
        for kept, tested, tiles in keeps]))
    by = "bytes" if old[2] >= ops_ms else "operations"
    share = sum(k[0] for k in keeps) / max(1, sum(k[1] for k in keeps))
    return max(old[2], ops_ms), by, old[2], ops_ms, old[4], old[3], share


def k2a_bound(preps, tile) -> tuple:
    """:func:`culled_bound` of K2a on these frames' preps (sorted_pad,
    starts, counts, table) made at ``tile``'s tile shape, the kept
    (row, warp) pairs from the plain mirror tile_raster.pairs_cull_keep
    on these inputs."""
    from libnativecpurenderer_tpu_torch.ops import tile_raster
    tw, th = tile["tile_w"], tile["tile_h"]
    keeps = [(int(tile_raster.pairs_cull_keep(sp, st, c, t, WIDTH, tw,
                                              th).sum()),
              int(c.clamp(min=0).sum()) * tile_raster.WARPS, c.numel())
             for sp, st, c, t, *_ in preps]
    return culled_bound(walk_bound(preps, K2A_EPI_OPS, 4 + 4 * 4,
                                   tile=tile), keeps, tw * th)


def walk_bound(preps, epi_ops: int, out_bytes_px: int, extra_bytes: int = 0,
               tile=PROD):
    """:func:`pairs_bound` of the walk over the sorted pairs on these
    frames' preps, made at ``tile``'s tile shape: the table, the pairs
    walked, starts and counts and ``extra_bytes`` of other inputs."""
    frames = []
    for sorted_pad, starts, counts, table, *_ in preps:
        n_pairs = int(counts.sum())
        frames.append((n_pairs, starts.numel(),
                       4 * (table.numel() + n_pairs + 2 * starts.numel())
                       + extra_bytes))
    return pairs_bound(frames, tile["tile_w"] * tile["tile_h"], epi_ops,
                       out_bytes_px)


def run_stats(preps) -> str:
    """The runs of these frames' preps against the split walk's S: the
    longest, the mean, the empty runs, the tiles longer than S, and the
    items the plan lists (none for an empty run, one for a run of up to S
    slots, ceil(count / S) for a longer one), each over the frames."""
    from libnativecpurenderer_tpu_torch.ops.tile_raster import SEG as seg
    cs = [p[2].reshape(-1).long().cpu() for p in preps]
    items = [int(torch.where(c > seg, (c + seg - 1) // seg,
                             (c > 0).long()).sum()) for c in cs]
    return (f"longest {[int(c.max()) for c in cs]}, mean "
            f"{[round(float(c.float().mean()), 2) for c in cs]}, empty "
            f"{[int((c == 0).sum()) for c in cs]}, tiles over "
            f"S={seg} {[int((c > seg).sum()) for c in cs]} of "
            f"{cs[0].numel()}, items {items}")


def split_cases(dev, bgp, mxu: bool = False):
    """Inputs at the split walk's boundaries (testing.crafted_runs, one
    row of 32x32 tiles) at the kernel's S: runs of 1, S, S + 1, 2S, 2S + 1
    and 1024 slots with NaN rows, the same with the last run read 300
    slots past the pair array (an overflowed run), and every tile's run
    the whole pair array (runs that overlap, so the item list would
    outgrow its capacity and the plan makes every tile one item); with
    ``mxu`` the tables are the matrix-unit walk's affine ones.
    Returns [(label, walk args of K1 without opaque/z_clip)]."""
    from libnativecpurenderer_tpu_torch.ops.tile_raster import SEG as seg
    from libnativecpurenderer_tpu_torch.testing import crafted_runs
    cases = []
    lengths = [1, seg, seg + 1, 2 * seg, 2 * seg + 1, 1024]
    for label, past in (("boundaries", 0), ("run past the array", 300)):
        sp, st, ct, tb, w = crafted_runs(lengths, seed=seg, past_end=past,
                                         mxu=mxu)
        cases.append((f"{label} S={seg}", tuple(
            x.to(dev) for x in (sp, st, ct, tb)) + (bgp, w, 32, 32)))
    sp, st, ct, tb, w = crafted_runs(lengths, seed=seg, mxu=mxu)
    n = int(ct.sum())
    cases.append((f"overlapping runs S={seg}", (
        sp.to(dev), torch.zeros_like(st).to(dev),
        torch.full_like(ct, n).to(dev), tb.to(dev), bgp, w, 32, 32)))
    return cases


def split_frames(dev, seeds, past_end=(), uv=(), knife=(), tile=(32, 32)):
    """The boundary runs of :func:`split_cases` at the kernel's S, one
    frame a seed, stacked as B frames (a leading B on each input): frame
    i's last run read 300 slots past its pair array for i in
    ``past_end``, its uv rows crafted (testing.crafted_uv_table: huge,
    negative, tiny, zero and NaN denominators) for i in ``uv``, every
    third row of each run a knife-edge row (testing.knife_edge_rows) for
    i in ``knife``; tiles of ``tile`` (w, h).  Returns (sorted_pad,
    starts, counts, table) on ``dev`` and the width."""
    from libnativecpurenderer_tpu_torch.ops.tile_raster import SEG as seg
    from libnativecpurenderer_tpu_torch.testing import (crafted_runs,
                                                        crafted_uv_table)
    lengths = [1, seg, seg + 1, 2 * seg, 2 * seg + 1, 1024]
    frames = []
    for i, sd in enumerate(seeds):
        sp, st, ct, tb, w = crafted_runs(
            lengths, *tile, seed=sd, past_end=300 if i in past_end else 0,
            knife=i in knife)
        frames.append((sp, st, ct, crafted_uv_table(tb) if i in uv else tb))
    return tuple(torch.stack([f[i] for f in frames]).to(dev)
                 for i in range(4)), w


def gathered_rows(sorted_pad, table, cap: int):
    """K6's input: each frame's table rows in pair order,
    ``table[sorted_pad[:cap] & IDX_MASK]``, (B, cap, ROW_W)."""
    from libnativecpurenderer_tpu_torch.ops.raster3d import IDX_MASK
    return torch.stack([t[(s[:cap] & IDX_MASK).long()]
                        for s, t in zip(sorted_pad, table)])


def k2a_split_checks(dev) -> float:
    """K2a against its plain version, keys and attribute bits, on the
    split walk's boundary runs (testing.crafted_runs at the kernel's S: 1,
    S, S + 1, 2S, 2S + 1 and 1024 slots with NaN rows and depths outside
    [0, 1]), the same with the last run read 300 slots past the pair
    array, runs that overlap past the item list's capacity (the plan's
    fallback: every tile one item) and 4 frames in one launch (one with a
    run past its array, one with knife-edge rows), at 128x8, 128x16 (K2a's
    warp boxes and cull) and 32x32 (none), the z test on and off; then
    knife-edge rows on the warp boxes' borders (testing.knife_edge_rows)
    at 128x16.  Prints each with the share of (row, warp) pairs the cull
    keeps (tile_raster.pairs_cull_keep); returns the largest |delta| of
    the attributes."""
    from libnativecpurenderer_tpu_torch.ops import tile_raster
    from libnativecpurenderer_tpu_torch.testing import crafted_runs
    seg = tile_raster.SEG
    lengths = [1, seg, seg + 1, 2 * seg, 2 * seg + 1, 1024]
    cases = []
    for tile in ((128, 8), (128, 16), (32, 32)):
        tag = f"{tile[0]}x{tile[1]}"
        for label, past in (("boundaries", 0), ("run past the array", 300)):
            sp, st, ct, tb, w = crafted_runs(lengths, *tile, seed=seg,
                                             past_end=past)
            cases.append((f"{label} {tag}", (sp, st, ct, tb), w, tile))
        sp, st, ct, tb, w = crafted_runs(lengths, *tile, seed=seg + 1)
        n = int(ct.sum())
        cases.append((f"overlapping runs (the plan's fallback) {tag}",
                      (sp, torch.zeros_like(st), torch.full_like(ct, n), tb),
                      w, tile))
        four, w4 = split_frames(dev, [41, 42, 43, 44], past_end=(1,),
                                knife=(2,), tile=tile)
        cases.append((f"4 frames in one launch (a run past the array, "
                      f"knife-edge rows) {tag}", four, w4, tile))
    sp, st, ct, tb, w = crafted_runs(lengths, 128, 16, seed=seg + 2,
                                     knife=True)
    cases.append(("knife-edge rows 128x16", (sp, st, ct, tb), w, (128, 16)))
    err = 0.0
    for label, walk, w, (tw, th) in cases:
        walk = tuple(x.to(dev) for x in walk)
        keep = tile_raster.pairs_cull_keep(*walk, w, tw, th)
        n_walk = int(walk[2].clamp(min=0).sum()) * tile_raster.WARPS
        for z_clip in (True, False):
            args = (*walk, w, tw, th)
            (gk, gr), (wk, wr) = (
                tile_raster.raster_tiles_keys_f32(*args, z_clip=z_clip),
                tile_raster.raster_tiles_keys_f32_reference(*args,
                                                            z_clip=z_clip))
            torch.cuda.synchronize()
            bad = same_bits(gk, wk) + same_bits(gr, wr)
            fin = torch.isfinite(gr) & torch.isfinite(wr)
            d = float((gr - wr)[fin].abs().max()) if bool(fin.any()) else 0.0
            err = max(err, d)
            print(f"[tex vs plain] K2a split walk, {label}, z_clip={z_clip}: "
                  f"{bad} of {gk.numel()} keys and {gr.numel()} attribute "
                  f"values differ in their bits; "
                  f"{float((wk != tile_raster.SKY_KEY).float().mean()):.3f} "
                  f"covered, {int((wk < 0).sum())} negative keys (depths "
                  f"above 1, z test off); runs {walk[2].tolist()}; (row, "
                  f"warp) pairs the cull keeps {int(keep.sum())} of {n_walk}",
                  flush=True)
            if bad:
                raise AssertionError(f"K2a differs from its plain version at "
                                     f"{label}, z_clip={z_clip}")
    return err


def occupancy(_kernels, tex: bool, tile_w: int, tile_h: int, z_clip: bool,
              walks=("split FMA", "split MMA")) -> str:
    """ptxas registers and resident blocks an SM of the kernels a launch
    at tiles of tile_w x tile_h runs, for each of ``walks``
    (``_kernels.WALKS``): by default K1's (K3's) split walk on the CUDA
    cores (K1, K3, K1-wf) and on the tensor cores (K1-mxu, K3's mxu
    walk)."""
    out = []
    for walk in walks:
        regs, n = _kernels.tile_raster_occupancy(walk, tex, tile_w, tile_h,
                                                 z_clip)
        out.append(f"{walk} walk {regs} registers, {n} blocks an SM")
    return "; ".join(out)


def in_turns(fns: dict, reps: int = 10) -> dict:
    """Mean device ms a call of each of fns (name -> call), timed twice in
    turns (a b .. b a), CUDA events with the calls queued behind a sleep
    (:func:`cuda_ms` with ``queued``): name -> [first, second]."""
    names = list(fns)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append(cuda_ms(fns[n], reps, queued=True))
    return out


# the MMA walk's instantiations, tile_raster_split_kernel<PPT, ZCLIP, EPI,
# WALK_MMA, GRAIN>, and the layout probe, by their mangled names
MMA_ENTRY = re.compile(r"tile_raster_split_kernelILi\d+ELb[01]ELi\d+ELi1ELb"
                       r"[01]E|mma_probe_kernel")
MMA_MAX_REGS = 128


def check_mma_build(log: str) -> str:
    """Raises when ptxas serialized a wgmma (warning C7518) or when an
    instantiation of the MMA walk spills or takes more than MMA_MAX_REGS
    registers (2 blocks of 256 threads an SM); returns a summary."""
    if "C7518" in log:
        raise AssertionError("ptxas serialized the wgmma products (C7518)")
    mma = [e for e in ptxas_summary(log).split("; ") if MMA_ENTRY.search(e)]
    if not mma:
        raise AssertionError("no MMA walk instantiation in the build log")
    for e in mma:
        m = re.search(r": (\d+) registers, (\d+)/(\d+) B spill", e)
        if not m or int(m.group(1)) > MMA_MAX_REGS or int(m.group(2)) or \
                int(m.group(3)):
            raise AssertionError(f"the MMA walk spills or exceeds "
                                 f"{MMA_MAX_REGS} registers: {e}")
    return (f"{len(mma)} MMA walk instantiations, no C7518, no spill, at "
            f"most {MMA_MAX_REGS} registers")


# K5's instantiations, tile_raster_split_kernel<PPT, true, KEYS_F32,
# WALK_FMA, false, BINS, BOX>, by their mangled names
K5_ENTRY = re.compile(r"tile_raster_split_kernelILi\d+ELb1ELi3ELi0ELb0ELi1E"
                      r"Lb[01]E")


def check_k5_build(log: str) -> str:
    """Raises when an instantiation of K5's split walk spills; returns
    their registers and spills."""
    k5 = [e for e in ptxas_summary(log).split("; ") if K5_ENTRY.search(e)]
    if not k5:
        raise AssertionError("no K5 split walk instantiation in the build "
                             "log")
    for e in k5:
        m = re.search(r": (\d+) registers, (\d+)/(\d+) B spill", e)
        if not m or int(m.group(2)) or int(m.group(3)):
            raise AssertionError(f"K5's split walk spills: {e}")
    return "K5's split walk (PPT, BOX: registers, spills): " + "; ".join(
        re.sub(r"^.*tile_raster_split_kernelILi(\d+)E\w*ELi1ELb([01])E\w*",
               r"PPT \1, BOX \2", e) for e in k5)


# K2b's and K6's split walk instantiations, tile_raster_split_kernel<PPT,
# ZCLIP, TEX_IDX, WALK_FMA, false, PAIRS, false> and <PPT, false,
# U8_GOURAUD, WALK_FMA, false, ROWS, false>, by their mangled names
ROWS_IDX_ENTRY = {
    "K2b": re.compile(r"tile_raster_split_kernelILi(\d+)ELb([01])ELi2ELi0E"
                      r"Lb0ELi0ELb0E"),
    "K6": re.compile(r"tile_raster_split_kernelILi(\d+)ELb([01])ELi0ELi0E"
                     r"Lb0ELi2ELb0E")}


def split_regs(log: str, name: str, pat, want: set) -> dict:
    """{groups of ``pat``: registers} of the split walk's instantiations
    whose mangled names ``pat`` matches in the build log; raises when one
    spills or when the set of groups is not ``want``."""
    found = {}
    for e in ptxas_summary(log).split("; "):
        k = pat.search(e)
        if not k:
            continue
        m = re.search(r": (\d+) registers, (\d+)/(\d+) B spill", e)
        if not m or int(m.group(2)) or int(m.group(3)):
            raise AssertionError(f"{name}'s split walk spills: {e}")
        found[tuple(int(g) for g in k.groups())] = int(m.group(1))
    if set(found) != want:
        raise AssertionError(f"{name}'s split walk instantiations "
                             f"{sorted(found)}, expected {sorted(want)}")
    return found


def check_k2b_k6_build(log: str) -> str:
    """Raises when an instantiation of K2b's or K6's split walk spills, or
    when one is missing (K2b: 1-16 pixels a thread, z test on and off;
    K6: 1-16, z test off); returns their registers and spills."""
    out = []
    for name, pat in ROWS_IDX_ENTRY.items():
        found = split_regs(log, name, pat, {
            (n, z) for n in (1, 2, 4, 8, 16)
            for z in ((0, 1) if name == "K2b" else (0,))})
        out.append(f"{name} " + ", ".join(
            f"PPT {n} z {z}: {r}" for (n, z), r in sorted(found.items())))
    return ("K2b's and K6's split walk (registers, no spill): "
            + "; ".join(out))


# K2a's split walk instantiations, tile_raster_split_kernel<PPT, ZCLIP,
# KEYS_F32, WALK_FMA, false, PAIRS, BOX>, by their mangled names
K2A_ENTRY = re.compile(r"tile_raster_split_kernelILi(\d+)ELb([01])ELi3ELi0E"
                       r"Lb0ELi0ELb([01])E")


def check_k2a_build(log: str) -> str:
    """Raises when an instantiation of K2a's split walk spills, when one is
    missing (1-16 pixels a thread, z test on and off, with and without
    the warp boxes) or when the one-block-a-tile walk's kernel
    (tile_raster_kernel) is still in the build; returns their registers
    and spills."""
    if "tile_raster_kernel" in log:
        raise AssertionError("the one-block-a-tile walk's kernel is in the "
                             "build")
    found = split_regs(log, "K2a", K2A_ENTRY, {
        (n, z, b) for n in (1, 2, 4, 8, 16) for z in (0, 1) for b in (0, 1)})
    return ("K2a's split walk (registers, no spill): " + ", ".join(
        f"PPT {n} z {z} box {b}: {r}"
        for (n, z, b), r in sorted(found.items())))


# K4's instantiations, canvas_span_kernel<float> and <double> (runs
# without blits) and canvas_span_blit_kernel<float> and <double>, and the
# spill ptxas may take in each float and each double one (B stored, B
# loaded): the float kernel's 40/40 B at 64 registers was measured faster
# than the scalar-pixel kernel's 80 registers without spill (PERF.md);
# the double kernels spill nothing
K4_ENTRY = re.compile(r"canvas_span_(kernel|blit_kernel)I([fd])E")
K4_SPILL_OK = {"f": (40, 40), "d": (0, 0)}
# the same kernels by their names in a profile
K4_ENTRY_NAME = re.compile(r"canvas_span_(blit_)?kernel<")


def check_k4_build(log: str) -> str:
    """Raises when an instantiation of K4 spills more than K4_SPILL_OK;
    returns their registers and spills."""
    out = {}
    for e in ptxas_summary(log).split("; "):
        k = K4_ENTRY.search(e)
        if not k:
            continue
        m = re.search(r": (\d+) registers, (\d+)/(\d+) B spill", e)
        ok = K4_SPILL_OK[k.group(2)]
        if not m or int(m.group(2)) > ok[0] or int(m.group(3)) > ok[1]:
            raise AssertionError(f"K4 spills more than {ok[0]}/{ok[1]} B: "
                                 f"{e}")
        kind = "float" if k.group(2) == "f" else "double"
        out[k.groups()] = (f"{k.group(1)} {kind} {m.group(1)} registers, "
                           f"{m.group(2)}/{m.group(3)} B spill (accepted "
                           f"{ok[0]}/{ok[1]})")
    if len(out) != 2 * len(K4_SPILL_OK):
        raise AssertionError("K4's float and double kernels, with and "
                             "without blits, are not all in the build log")
    return "K4 (registers, spills): " + "; ".join(out.values())


def build_kernels(_kernels) -> float:
    """Build every kernel library of the port in parallel (one nvcc per
    source), load them, print the ptxas summary and hold the MMA walk's,
    K5's, K2b's and K6's, K2a's and K4's builds to
    :func:`check_mma_build`, :func:`check_k5_build`,
    :func:`check_k2b_k6_build`, :func:`check_k2a_build` and
    :func:`check_k4_build`; returns the seconds."""
    names = ("tile_raster", "canvas_span", "audio_scatter", "tile_blend")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_kernels.build, names))
    _kernels.tile_raster()
    _kernels.canvas_span()
    _kernels.audio_scatter()
    _kernels.tile_blend()
    build_s = time.perf_counter() - t0
    print(f"[build] {', '.join(n + '.cu' for n in names)} built and loaded "
          f"in {build_s:.1f} s", flush=True)
    for n in names:
        print(f"[build] ptxas {n}: {ptxas_summary(_kernels.build_log(n))}",
              flush=True)
    print(f"[build] {check_mma_build(_kernels.build_log('tile_raster'))}",
          flush=True)
    print(f"[build] {check_k5_build(_kernels.build_log('tile_raster'))}",
          flush=True)
    print(f"[build] "
          f"{check_k2b_k6_build(_kernels.build_log('tile_raster'))}",
          flush=True)
    print(f"[build] {check_k2a_build(_kernels.build_log('tile_raster'))}",
          flush=True)
    print(f"[build] {check_k4_build(_kernels.build_log('canvas_span'))}",
          flush=True)
    return build_s


def mesh_phases(dev, card: str) -> dict:
    """Phases 3-5: K1 against its plain version, the mesh main path and
    its times; returns K1's entry of the kernel table."""
    from libnativecpurenderer_tpu_torch import MeshVideoPipeline, interop
    from libnativecpurenderer_tpu_torch.models import mesh
    from libnativecpurenderer_tpu_torch.ops import raster3d, tile_raster

    verts_np, faces_np, colors_np = mesh.mesh_10k()
    verts, faces, colors = interop.mesh_to_torch(verts_np, faces_np,
                                                 colors_np, dev)
    pre = (raster3d.pregather_mesh(verts, faces), colors[faces])

    def k1_vs_plain(mvp, opaque, z_clip, cfg, expect_overflow):
        """Prep one frame, run K1 and the plain version on it, require
        bit-equal outputs; returns (kernel args, max u8 |delta|)."""
        prep = raster3d.prepare_frame(
            verts, faces, colors, WIDTH, HEIGHT, torch.from_numpy(mvp).to(dev),
            z_clip=z_clip, pre=pre, **cfg)
        ovf = bool(prep["overflow"])
        if expect_overflow is not None and ovf != expect_overflow:
            raise AssertionError(f"overflow flag {ovf} at {cfg}")
        args = (prep["sorted_pad"], prep["starts"], prep["counts"],
                prep["table"], prep["packed_bg"], WIDTH, cfg["tile_w"],
                cfg["tile_h"])
        got = tile_raster.raster_tiles_flat_u8(*args, opaque=opaque,
                                               z_clip=z_clip)
        want = tile_raster.raster_tiles_flat_u8_reference(
            *args, opaque=opaque, z_clip=z_clip)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        err = int((tile_raster.tiles_u8(got).int()
                   - tile_raster.tiles_u8(want).int()).abs().max())
        print(f"[k1 vs plain] tiles {cfg['tile_w']}x{cfg['tile_h']} "
              f"capacity {cfg['capacity']} opaque={opaque} z_clip={z_clip} "
              f"overflow={ovf}: "
              f"{bad} of {got.numel()} packed pixels differ (max u8 "
              f"|delta| {err}); pairs {int(prep['counts'].sum())}, longest "
              f"run {int(prep['counts'].max())}", flush=True)
        if bad:
            raise AssertionError("K1 and its plain version disagree")
        return args, err

    tile_raster.raster_tiles_flat_u8.launches = 0
    cams = [camera(mesh, k, 0.45) for k in range(4)]
    preps = []
    max_err = 0
    for mvp in cams:
        args, err = k1_vs_plain(mvp, True, False, PROD, False)
        preps.append(args)
        max_err = max(max_err, err)
    max_err = max(max_err, k1_vs_plain(cams[1], False, True, PROD, False)[1])
    # the flag is not the point at these shapes (a wide quad may exceed
    # the span at 16x16), except where runs must outgrow the capacity
    for tw, th, cap, opaque, z_clip in OTHER_SHAPES:
        cfg = dict(tile_w=tw, tile_h=th, capacity=cap, span_x=8, span_y=8)
        max_err = max(max_err, k1_vs_plain(
            cams[2], opaque, z_clip, cfg, True if cap < 1024 else None)[1])
    # the split walk's boundary runs
    cases = split_cases(dev, preps[0][4])
    for label, args in cases:
        for opaque, z_clip in ((True, False), (False, True)):
            got = tile_raster.raster_tiles_flat_u8(
                *args, opaque=opaque, z_clip=z_clip)
            want = tile_raster.raster_tiles_flat_u8_reference(
                *args, opaque=opaque, z_clip=z_clip)
            torch.cuda.synchronize()
            bad = same_bits(got, want)
            print(f"[k1 vs plain] split walk, {label}, opaque={opaque} "
                  f"z_clip={z_clip}: {bad} of {got.numel()} packed pixels "
                  f"differ; runs {args[2].tolist()}, "
                  f"{float((want != args[4]).float().mean()):.3f} covered",
                  flush=True)
            if bad:
                raise AssertionError(f"K1 differs from its plain version at "
                                     f"{label}")
    print(f"[k1 runs] mesh_10k 1080p, 32x32, the 4 cameras: "
          f"{run_stats(preps)}", flush=True)
    n_k1 = 5 + len(OTHER_SHAPES) + 2 * len(cases)
    if tile_raster.raster_tiles_flat_u8.launches != n_k1:
        raise AssertionError("a K1 comparison did not launch the kernel")

    def run_pipeline(sink, n, tiled):
        """frames/s of n frames through a MeshVideoPipeline into sink."""
        pipe = MeshVideoPipeline(sink, WIDTH, HEIGHT, verts_np, faces_np,
                                 colors=colors_np, batch=BATCH, tiled=tiled,
                                 device=dev)
        t = time.perf_counter()
        for k in range(n):
            pipe.submit(camera(mesh, k, 0.03))
        pipe.finish()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t)

    # frames/s after a warm-up, 3 runs each, frames dropped by the sink
    fps = {}
    for tiled in (True, False):
        run_pipeline(DropSink(), 2 * BATCH, tiled)
        fps[tiled] = sorted(run_pipeline(DropSink(), FRAMES, tiled)
                            for _ in range(3))
    # the checked run, kernel launches counted from zero
    torch.cuda.reset_peak_memory_stats()
    tile_raster.raster_tiles_flat_u8.launches = 0
    tiled_sink, plain_sink = TiledSink(), PlainSink()
    run_pipeline(tiled_sink, FRAMES, None)
    run_pipeline(plain_sink, FRAMES, None)
    launches = tile_raster.raster_tiles_flat_u8.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if launches != 2 * -(-FRAMES // BATCH):
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{2 * FRAMES} frames at batch {BATCH}")
    if not len(tiled_sink.tiles) == len(plain_sink.frames) == FRAMES:
        raise AssertionError("a sink did not get every frame")
    covered = []
    for (tiles, w, h, tw, th), frame in zip(tiled_sink.tiles,
                                            plain_sink.frames):
        if frame.shape != (HEIGHT, WIDTH, 4) or frame.dtype != np.uint8:
            raise AssertionError(f"frame {frame.shape} {frame.dtype}")
        if not np.array_equal(raster3d.detile_u8_host(tiles, w, h, tw, th),
                              frame):
            raise AssertionError("tiled and plain frames differ")
        covered.append(float((frame[..., 3] == 255).mean()))
    if min(covered) <= 0.10:
        raise AssertionError(f"a frame covers only {min(covered):.3f}")
    # the same frame through the plain versions on the CPU
    k = FRAMES - 1
    cpu = interop.mesh_to_torch(verts_np, faces_np, colors_np, "cpu")
    ref, ovf_ref = raster3d.render_gouraud_u8_loop(
        *cpu, WIDTH, HEIGHT, torch.from_numpy(camera(mesh, k, 0.03))[None])
    cpu_diff = int((torch.from_numpy(plain_sink.frames[k]) != ref[0])
                   .any(-1).sum())
    print(f"[mesh main path] MeshVideoPipeline {FRAMES} frames x2 (tiled, "
          f"plain): overflow False, K1 launches {launches} = batches "
          f"rendered, mesh covers {min(covered):.3f}..{max(covered):.3f} "
          f"of each frame, tiled == plain; frame {k} vs the CPU plain "
          f"path: {cpu_diff} pixels differ", flush=True)
    if bool(ovf_ref) or cpu_diff:
        raise AssertionError("card frame differs from the CPU plain path")

    def k1_all():
        for a in preps:
            tile_raster.raster_tiles_flat_u8(*a, opaque=True, z_clip=False)

    def plain_all():
        for a in preps:
            tile_raster.raster_tiles_flat_u8_reference(*a, opaque=True,
                                                       z_clip=False)

    k1 = tile_raster.raster_tiles_flat_u8
    saved = k1.launches
    k1_ms = cuda_ms(k1_all, 10) / len(preps)
    plain_ms = cuda_ms(plain_all, 2) / len(preps)

    # K1 in turns, queued (device time alone): one frame a launch and the
    # 4 frames in one launch, at the video shape and at
    # render_gouraud_u8's defaults (128x16, capacity 512, span (8, 8),
    # opaque off, z test on)
    from libnativecpurenderer_tpu_torch.ops import _kernels
    gdef = defaults(raster3d.render_gouraud_u8)
    d_preps = []
    for mvp in cams:
        p = raster3d.prepare_frame(verts, faces, colors, WIDTH, HEIGHT,
                                   torch.from_numpy(mvp).to(dev),
                                   z_clip=True, pre=pre, **gdef)
        if bool(p["overflow"]):
            raise AssertionError("a 128x16 prep overflows")
        d_preps.append((p["sorted_pad"], p["starts"], p["counts"],
                        p["table"], p["packed_bg"], WIDTH, gdef["tile_w"],
                        gdef["tile_h"]))
    for label, (pp, cfg, opaque, z_clip) in {
            "32x32": (preps, PROD, True, False),
            "128x16": (d_preps, gdef, False, True)}.items():
        kw = dict(opaque=opaque, z_clip=z_clip)
        four = tuple(torch.stack([a[i] for a in pp]) for i in range(4)) \
            + pp[0][4:]
        n = len(pp)
        t = in_turns({
            "K1": lambda: [k1(*a, **kw) for a in pp],
            "K1 batch": lambda: k1(*four, **kw)})
        t = {k: [v / n for v in vs] for k, vs in t.items()}
        b = walk_bound(pp, 0, 4, tile=cfg)
        be = walk_bound(pp, U8_EPI_OPS, 4, tile=cfg)
        print(f"[mesh times] {card}: K1's split walk at {label} "
              f"({cfg}, opaque={opaque}, z_clip={z_clip}), ms/frame in "
              f"turns (CUDA events, calls queued behind a sleep, mean of 4 "
              f"cameras; 'batch' = the 4 frames in one launch): "
              + "; ".join(f"{k} {v}" for k, v in t.items())
              + f"; bound {b[0]} ms/frame by {b[1]} (walk only; with the "
              f"u8 epilogue {be[0]}), K1 at {b[0] / min(t['K1']):.4f} "
              f"of it one frame a launch, {be[0] / min(t['K1 batch']):.4f}"
              f" of the epilogue bound batched; "
              f"{occupancy(_kernels, False, cfg['tile_w'], cfg['tile_h'], z_clip)}",
              flush=True)
    k1.launches = saved

    # K1's bound on these 4 frames: the walk alone (its epilogue is not
    # counted, as in the bounds first reported for it)
    bound_ms, bound_by, bytes_ms, ops_ms, pairs = walk_bound(preps, 0, 4)
    print(f"[mesh times] {card}: K1 {k1_ms} ms/frame, plain version "
          f"{plain_ms} ms/frame (1080p mesh_10k, 32x32 tiles, CUDA "
          f"events, mean of 4 cameras); K1 bound {bound_ms} ms/frame by "
          f"{bound_by} (bytes {bytes_ms} ms, operations {ops_ms} ms; "
          f"pairs walked {pairs}), K1 at {bound_ms / k1_ms:.4f} of it; "
          f"pipeline frames/s, 3 runs of {FRAMES} frames, batch {BATCH}, "
          f"host clock: tiled sink {fps[True]}, plain sink {fps[False]}; "
          f"peak device memory {peak_mib} MiB", flush=True)
    return {"name": "raster_tiles_flat_u8", "route": "cuda",
            "source": "libnativecpurenderer_tpu_torch/csrc/tile_raster.cu",
            "replaces": "libnativecpurenderer_tpu/ops/pallas_raster.py:125",
            "launches": launches, "max_abs_err": max_err,
            "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def mesh_batch_phase(dev, card: str) -> None:
    """Phase 22: the batch's prep and render_gouraud_u8_loop at the mesh
    cell's shapes against the per-frame prep and render_gouraud_u8, bit
    for bit on the card, then their ms a batch and launches."""
    from libnativecpurenderer_tpu_torch import interop
    from libnativecpurenderer_tpu_torch.models import mesh
    from libnativecpurenderer_tpu_torch.ops import raster3d, tile_raster

    verts_np, faces_np, colors_np = mesh.mesh_10k()
    mesh_t = interop.mesh_to_torch(verts_np, faces_np, colors_np, dev,
                                   torch.float32)
    verts, faces, colors = mesh_t
    # the cell's orbit: 0.03 rad a frame from an angle of its own
    mvps = torch.from_numpy(np.stack(
        [camera(mesh, 40 + k, 0.03) for k in range(BATCH)])).to(dev)
    kw = dict(PROD, opaque=True, z_clip=False)
    prep_kw = dict(PROD, z_clip=False)
    pre = (raster3d.pregather_mesh(verts, faces), colors[faces])
    calls, frames = (raster3d.prepare_frame.calls,
                     raster3d.prepare_frame.frames)
    got = raster3d.prepare_frame(*mesh_t, WIDTH, HEIGHT, mvps, pre=pre,
                                 **prep_kw)
    took = (raster3d.prepare_frame.calls - calls,
            raster3d.prepare_frame.frames - frames)
    nt = got["counts"].shape[-1]
    bad = []
    for i in range(BATCH):
        one = raster3d.prepare_frame(*mesh_t, WIDTH, HEIGHT, mvps[i],
                                     pre=pre, **prep_kw)
        for k in ("starts", "counts", "overflow"):
            if not torch.equal(got[k][i], one[k]):
                bad.append(f"{k} of frame {i}")
        if not torch.equal(got["table"][i].view(torch.int32),
                           one["table"].view(torch.int32)):
            bad.append(f"table of frame {i}")
        n = int(((one["sorted_pad"] >> raster3d.IDX_BITS) < nt).sum())
        if not torch.equal(got["sorted_pad"][i, :n], one["sorted_pad"][:n]):
            bad.append(f"pairs of frame {i}")
    print(f"[mesh batch] the batch's prep, {BATCH} frames in one call "
          f"(calls, frames counted: {took}): sorted_pad "
          f"{tuple(got['sorted_pad'].shape)}, table "
          f"{tuple(got['table'].shape)}; differs from the per-frame preps "
          f"in {bad or 'nothing'}; overflow {got['overflow'].tolist()}",
          flush=True)
    if bad or took != (1, BATCH):
        raise AssertionError("the batch's prep differs from the per-frame "
                             "preps")

    k1 = tile_raster.raster_tiles_flat_u8
    saved = k1.launches

    def loop(tiled=False):
        return raster3d.render_gouraud_u8_loop(*mesh_t, WIDTH, HEIGHT, mvps,
                                               tiled=tiled)

    def per_frame(tiled=False):
        out = [raster3d.render_gouraud_u8(*mesh_t, WIDTH, HEIGHT, m,
                                          tiled=tiled, pre=pre, **kw)
               for m in mvps]
        return (torch.stack([f for f, _ in out]),
                torch.stack([o for _, o in out]).any())

    for tiled in (False, True):
        k1.launches = 0
        fb, ovf = loop(tiled)
        n_loop = k1.launches
        ff, ovf1 = per_frame(tiled)
        torch.cuda.synchronize()
        diff = int((fb != ff).any(-1).sum())
        print(f"[mesh batch] render_gouraud_u8_loop, {BATCH} frames "
              f"{'tiled' if tiled else 'detiled'} {tuple(fb.shape)}: K1 "
              f"launches {n_loop}; {diff} pixels differ from "
              f"render_gouraud_u8 frame by frame ({k1.launches - n_loop} "
              f"launches); overflow {bool(ovf)} / {bool(ovf1)}", flush=True)
        if diff or n_loop != 1 or bool(ovf) or bool(ovf1):
            raise AssertionError("the batched loop differs from the "
                                 "per-frame renders")

    def wall_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    walls = {"loop": [], "per frame": []}
    for name in ("loop", "per frame", "per frame", "loop"):
        walls[name].append(wall_ms(loop if name == "loop" else per_frame))
    dev_ms = in_turns({"loop": loop, "per frame": per_frame}, reps=3)
    calls_loop, busy_loop, _ = profile_frames(loop, BATCH)
    calls_one, busy_one, _ = profile_frames(per_frame, BATCH)
    k1.launches = saved
    print(f"[mesh batch] {card}: ms a batch of {BATCH} frames at "
          f"{WIDTH}x{HEIGHT} ({kw}), in turns: host clock, each call ended "
          f"by a sync: {walls}; device, CUDA events, calls queued: "
          f"{dev_ms}; host calls a frame (profiler): loop {calls_loop}, "
          f"per frame {calls_one}; busy: loop {busy_loop}; per frame "
          f"{busy_one}", flush=True)


def textured_scene():
    """bench.py:546-553's textured mesh_10k: planar uvs from x and y, and
    its seeded 256x256 u8 RGBA texture."""
    from libnativecpurenderer_tpu_torch.models import mesh
    verts, faces, _ = mesh.mesh_10k()
    uvs = (verts[:, :2] - verts[:, :2].min(0)) / np.ptp(verts[:, :2], 0)
    tex_u8 = np.random.default_rng(1).integers(0, 256, (256, 256, 4)).astype(
        np.uint8)
    return verts, faces, uvs, tex_u8


def textured_phases(dev, card: str) -> list:
    """Phases 10-12: K3, K2b and K2a against their plain versions, the
    textured main path (MeshVideoPipeline with uvs/tex_u8, render_textured,
    render_binned_tex_idx_batch) and its times; returns the three kernels'
    entries of the kernel table."""
    from libnativecpurenderer_tpu_torch import MeshVideoPipeline, interop
    from libnativecpurenderer_tpu_torch.models import mesh
    from libnativecpurenderer_tpu_torch.ops import raster3d, tile_raster
    from libnativecpurenderer_tpu_torch.testing import crafted_uv_table

    verts_np, faces_np, uvs_np, tex_np = textured_scene()
    verts, faces, uvs, tex = interop.textured_mesh_to_torch(
        verts_np, faces_np, uvs_np, tex_np, dev)
    v4f, fuv = raster3d.pregather_mesh(verts, faces), uvs[faces]
    tex_packed = raster3d.pack_texture_u8(tex)
    tex_dims = tuple(tex.shape[:2])
    # 300 wide, 200 high: clamping on sizes that are not powers of two
    tex2_np = np.random.default_rng(2).integers(0, 256, (200, 300, 4)).astype(
        np.uint8)
    tex2 = torch.from_numpy(tex2_np).to(dev)
    bgp = tile_raster.pack_bg(torch.zeros(4, device=dev))
    kernels = (tile_raster.raster_tiles_tex_u8,
               tile_raster.raster_tiles_tex_idx,
               tile_raster.raster_tiles_keys_f32)
    cfg = dict(PROD)
    # render_textured's own defaults, the shapes its K2a launch walks
    sig = inspect.signature(raster3d.render_textured).parameters
    rt_cfg = {n: sig[n].default
              for n in ("tile_w", "tile_h", "capacity", "span_x", "span_y")}

    def prep(mvp, persp=True, z_clip=True, shape=cfg):
        return raster3d.prepare_textured_frame(
            verts, faces, fuv, WIDTH, HEIGHT, torch.from_numpy(mvp).to(dev),
            perspective_correct=persp, z_clip=z_clip, v4f=v4f, **shape)

    def calls(walk, packed, dims, z_clip, plain, shape=cfg):
        """K3, K2b, K2a (or their plain versions) on one prep made at
        tile shape ``shape``, each a call without arguments."""
        sfx = "_reference" if plain else ""
        tw, th = shape["tile_w"], shape["tile_h"]
        k3 = getattr(tile_raster, "raster_tiles_tex_u8" + sfx)
        k2b = getattr(tile_raster, "raster_tiles_tex_idx" + sfx)
        k2a = getattr(tile_raster, "raster_tiles_keys_f32" + sfx)
        return (lambda: k3(*walk, packed, dims, bgp, WIDTH, tw, th,
                           z_clip=z_clip),
                lambda: k2b(*walk, dims, WIDTH, tw, th, z_clip=z_clip),
                lambda: k2a(*walk, WIDTH, tw, th, z_clip=z_clip))

    # 10. K3, K2b and K2a against their plain versions, bit for bit
    cams = [camera(mesh, k, 0.45) for k in range(4)]
    cases = [(f"camera {k}", cams[k], True, True, None) for k in range(4)]
    cases += [("camera 1 z_clip=False", cams[1], True, False, None),
              ("camera 2 affine", cams[2], False, True, None),
              ("camera 3 300x200 texture", cams[3], True, True, "tex2"),
              ("camera 0 crafted uv rows", cams[0], True, True, "crafted")]
    errs = [0, 0, 0.0]
    preps = []
    for label, mvp, persp, z_clip, variant in cases:
        pr = prep(mvp, persp, z_clip)
        if bool(pr["overflow"]):
            raise AssertionError(f"textured prep overflows at {label}")
        table = (crafted_uv_table(pr["table"]) if variant == "crafted"
                 else pr["table"])
        walk = (pr["sorted_pad"], pr["starts"], pr["counts"], table)
        packed, dims = ((raster3d.pack_texture_u8(tex2), (200, 300))
                        if variant == "tex2" else (tex_packed, tex_dims))
        got = [c() for c in calls(walk, packed, dims, z_clip, False)]
        want = [c() for c in calls(walk, packed, dims, z_clip, True)]
        torch.cuda.synchronize()
        bad = [int((got[0] != want[0]).sum()), int((got[1] != want[1]).sum()),
               int((got[2][0] != want[2][0]).sum())
               + int((got[2][1].view(torch.int32)
                      != want[2][1].view(torch.int32)).sum())]
        d3 = int((tile_raster.tiles_u8(got[0]).int()
                  - tile_raster.tiles_u8(want[0]).int()).abs().max())
        d2b = int((got[1] - want[1]).abs().max())
        fin = torch.isfinite(want[2][1]) & torch.isfinite(got[2][1])
        d2a = float((got[2][1] - want[2][1])[fin].abs().max())
        errs = [max(errs[0], d3), max(errs[1], d2b), max(errs[2], d2a)]
        hit = got[1] >= 0
        print(f"[tex vs plain] {label}: K3 {bad[0]}, K2b {bad[1]}, K2a "
              f"{bad[2]} of {got[0].numel()} pixels' values differ (max "
              f"|delta| u8 {d3}, index {d2b}, f32 {d2a}); "
              f"{float(hit.float().mean()):.3f} of the slots covered, "
              f"{int(got[1][hit].unique().numel())} distinct texels; pairs "
              f"{int(pr['counts'].sum())}", flush=True)
        if any(bad):
            raise AssertionError(f"a textured kernel and its plain version "
                                 f"disagree at {label}")
        if variant is None and persp and z_clip:
            preps.append(walk)
    # K3's and K2b's split walks on the boundary runs (K2b also with
    # crafted uv rows), one frame a launch, then K2b on 4 frames in one
    # launch (one with a run read past its pair array, two with crafted
    # uv rows)
    idx_cases = []
    for label, args in split_cases(dev, bgp):
        sp, st, ct, tb, _, w, tw, th = args
        for z_clip in (True, False):
            targs = (sp, st, ct, tb, tex_packed, tex_dims, bgp, w, tw, th)
            got = tile_raster.raster_tiles_tex_u8(*targs, z_clip=z_clip)
            want = tile_raster.raster_tiles_tex_u8_reference(
                *targs, z_clip=z_clip)
            torch.cuda.synchronize()
            bad = same_bits(got, want)
            print(f"[tex vs plain] K3 split walk, {label}, z_clip={z_clip}: "
                  f"{bad} of {got.numel()} pixels' texels differ; "
                  f"{float((want != bgp).float().mean()):.3f} covered",
                  flush=True)
            if bad:
                raise AssertionError(f"K3 differs from its plain version at "
                                     f"{label}")
        idx_cases += [(label, (sp, st, ct, tb), w),
                      (f"{label}, crafted uv rows",
                       (sp, st, ct, crafted_uv_table(tb)), w)]
    four, w4 = split_frames(dev, [11, 12, 13, 14], past_end=(1,), uv=(2, 3))
    idx_cases.append(("4 frames in one launch (boundaries, a run past the "
                      "array, 2 with crafted uv rows)", four, w4))
    for label, walk, w in idx_cases:
        for z_clip in (True, False):
            iargs = (*walk, tex_dims, w, 32, 32)
            got = tile_raster.raster_tiles_tex_idx(*iargs, z_clip=z_clip)
            want = tile_raster.raster_tiles_tex_idx_reference(
                *iargs, z_clip=z_clip)
            torch.cuda.synchronize()
            bad = same_bits(got, want)
            errs[1] = max(errs[1], int((got - want).abs().max()))
            print(f"[tex vs plain] K2b split walk, {label}, z_clip={z_clip}: "
                  f"{bad} of {got.numel()} texel indices differ; "
                  f"{float((want >= 0).float().mean()):.3f} covered, "
                  f"{int(want[want >= 0].unique().numel())} distinct texels",
                  flush=True)
            if bad:
                raise AssertionError(f"K2b differs from its plain version at "
                                     f"{label}")
    # K2a's split walk on the boundary runs and knife-edge rows
    errs[2] = max(errs[2], k2a_split_checks(dev))
    print(f"[tex runs] textured mesh_10k 1080p, 32x32, the 4 cameras: "
          f"{run_stats(preps)}", flush=True)

    # 11. the main paths, each kernel's launches counted from zero
    def run_pipeline(sink, n, tiled, surface=None):
        """frames/s of n frames through a textured MeshVideoPipeline on
        its default device (the card) — or a Gouraud one, with
        ``surface=dict(colors=...)``."""
        pipe = MeshVideoPipeline(sink, WIDTH, HEIGHT, verts_np, faces_np,
                                 batch=BATCH, tiled=tiled,
                                 **(surface or dict(uvs=uvs_np,
                                                    tex_u8=tex_np)))
        t = time.perf_counter()
        for k in range(n):
            pipe.submit(camera(mesh, k, 0.03))
        pipe.finish()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t)

    # frames/s, the textured and the Gouraud pipeline in turns in this
    # process (T, G, G, T, T, G), so the two compare on one host state
    gouraud = dict(colors=mesh.mesh_10k()[2])
    run_pipeline(DropSink(), 2 * BATCH, True)
    run_pipeline(DropSink(), 2 * BATCH, True, gouraud)
    fps, fps_g = [], []
    for turn in "TGGTTG":
        if turn == "T":
            fps.append(run_pipeline(DropSink(), FRAMES, True))
        else:
            fps_g.append(run_pipeline(DropSink(), FRAMES, True, gouraud))
    fps, fps_g = sorted(fps), sorted(fps_g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2 ** 20
    for k in kernels:
        k.launches = 0
    tiled_sink, plain_sink = TiledSink(), PlainSink()
    run_pipeline(tiled_sink, FRAMES, None)
    run_pipeline(plain_sink, FRAMES, None)
    k3_launches = [k.launches for k in kernels]
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if k3_launches != [2 * -(-FRAMES // BATCH), 0, 0]:
        raise AssertionError(f"K3, K2b, K2a launched {k3_launches} times for "
                             f"{2 * FRAMES} textured frames at batch "
                             f"{BATCH}")
    if not len(tiled_sink.tiles) == len(plain_sink.frames) == FRAMES:
        raise AssertionError("a sink did not get every frame")
    lit = []
    for (tiles, w, h, tw, th), frame in zip(tiled_sink.tiles,
                                            plain_sink.frames):
        if frame.shape != (HEIGHT, WIDTH, 4) or frame.dtype != np.uint8:
            raise AssertionError(f"frame {frame.shape} {frame.dtype}")
        if not np.array_equal(raster3d.detile_u8_host(tiles, w, h, tw, th),
                              frame):
            raise AssertionError("tiled and plain textured frames differ")
        lit.append(float(frame.any(-1).mean()))
    if min(lit) <= 0.10:
        raise AssertionError(f"a textured frame covers only {min(lit):.3f}")
    k = FRAMES - 1
    mvp_k = torch.from_numpy(camera(mesh, k, 0.03))
    cpu = interop.textured_mesh_to_torch(verts_np, faces_np, uvs_np, tex_np,
                                         "cpu")
    ref, ovf_ref = raster3d.render_textured_u8_loop(*cpu, WIDTH, HEIGHT,
                                                    mvp_k[None])
    cpu_diff = int((torch.from_numpy(plain_sink.frames[k]) != ref[0])
                   .any(-1).sum())
    print(f"[tex main path] MeshVideoPipeline(uvs=, tex_u8=) on its default "
          f"device, {FRAMES} frames x2 (tiled, plain): overflow False, "
          f"K3, K2b, K2a launches {k3_launches}, tiled == plain, "
          f"{min(lit):.3f}..{max(lit):.3f} of each frame lit; frame {k} vs "
          f"the CPU plain path: {cpu_diff} pixels differ", flush=True)
    if bool(ovf_ref) or cpu_diff:
        raise AssertionError("card textured frame differs from the CPU plain "
                             "path")

    # render_textured (K2a) on one frame, a float texture made on the host
    tex_f_np = tex_np.astype(np.float32) / 255.0
    for kk in kernels:
        kk.launches = 0
    rgba, zq, ovf = raster3d.render_textured(
        verts, faces, uvs, torch.from_numpy(tex_f_np).to(dev), WIDTH, HEIGHT,
        mvp_k.to(dev))
    k2a_launches = [kk.launches for kk in kernels]
    rgba_c, zq_c, ovf_c = raster3d.render_textured(
        cpu[0], cpu[1], cpu[2], torch.from_numpy(tex_f_np), WIDTH, HEIGHT,
        mvp_k)
    d_rgba = int((rgba.cpu() != rgba_c).any(-1).sum())
    d_z = int((zq.cpu() != zq_c).sum())
    print(f"[tex main path] render_textured (float texture, "
          f"{rt_cfg['tile_w']}x{rt_cfg['tile_h']} tiles) on frame {k}: K3, "
          f"K2b, K2a launches {k2a_launches}; card vs CPU: {d_rgba} rgba "
          f"pixels and {d_z} depths differ; overflow {bool(ovf)}/"
          f"{bool(ovf_c)}", flush=True)
    if k2a_launches != [0, 0, 1] or d_rgba or d_z or bool(ovf) or bool(ovf_c):
        raise AssertionError("render_textured on the card differs from the "
                             "CPU, or did not launch K2a once")
    # K2a against its plain version at render_textured's shapes, on frame
    # k's prep (the launch above) and the 4 cameras': keys and rgba bits
    rt_preps = []
    for label, mvp in [(f"frame {k}", mvp_k.numpy())] + [
            (f"camera {i}", c) for i, c in enumerate(cams)]:
        pr = prep(mvp, shape=rt_cfg)
        walk = (pr["sorted_pad"], pr["starts"], pr["counts"], pr["table"])
        k2a, k2a_plain = (calls(walk, None, None, True, plain, rt_cfg)[2]
                          for plain in (False, True))
        (gk, gr), (wk, wr) = k2a(), k2a_plain()
        torch.cuda.synchronize()
        bad = int((gk != wk).sum()) + int(
            (gr.view(torch.int32) != wr.view(torch.int32)).sum())
        d2a = float((gr - wr).abs().max())
        errs[2] = max(errs[2], d2a)
        print(f"[tex main path] K2a vs plain at render_textured's shapes "
              f"{rt_cfg}, {label}: {bad} of {gk.numel()} keys and "
              f"{gr.numel()} attribute values differ (max |delta| f32 "
              f"{d2a}); {float((gk != tile_raster.SKY_KEY).float().mean()):.3f}"
              f" of the slots covered; pairs {int(pr['counts'].sum())}, "
              f"overflow {bool(pr['overflow'])}", flush=True)
        if bad or bool(pr["overflow"]):
            raise AssertionError(f"K2a and its plain version disagree at "
                                 f"render_textured's shapes, {label}")
        if label.startswith("camera"):
            rt_preps.append(walk)

    # render_binned_tex_idx_batch (K2b) over the 4 cameras' preps
    for kk in kernels:
        kk.launches = 0
    idx = tile_raster.render_binned_tex_idx_batch(
        *(torch.stack([p[i] for p in preps]) for i in range(4)), WIDTH,
        HEIGHT, cfg["tile_w"], cfg["tile_h"], tex_dims)
    k2b_launches = [kk.launches for kk in kernels]
    idx_ref = torch.stack([tile_raster._detile_plane(
        tile_raster.raster_tiles_tex_idx_reference(
            *p, tex_dims, WIDTH, cfg["tile_w"], cfg["tile_h"], z_clip=True),
        WIDTH, HEIGHT, cfg["tile_w"], cfg["tile_h"]) for p in preps])
    d_idx = int((idx != idx_ref).sum())
    print(f"[tex main path] render_binned_tex_idx_batch over {len(preps)} "
          f"frames: K3, K2b, K2a launches {k2b_launches}; (B, H, W) "
          f"{tuple(idx.shape)}, {d_idx} indices differ from the plain "
          f"version", flush=True)
    if k2b_launches != [0, 1, 0] or d_idx:
        raise AssertionError("render_binned_tex_idx_batch did not run K2b "
                             "once for its frames, or disagrees")

    # 12. times: each kernel and its plain version (CUDA events, mean of
    # the 4 cameras), the pipeline on the host clock and in the profiler
    # (K3 and K2b at the 32x32 tiles of the pipeline and the batch entry,
    # K2a at render_textured's shapes)
    timed = {"K3": (preps, cfg), "K2b": (preps, cfg), "K2a": (rt_preps, rt_cfg)}
    ms = {}
    for i, name in enumerate(("K3", "K2b", "K2a")):
        pp, shape = timed[name]
        kern = [calls(w, tex_packed, tex_dims, True, False, shape)[i]
                for w in pp]
        plain = [calls(w, tex_packed, tex_dims, True, True, shape)[i]
                 for w in pp]
        ms[name] = (cuda_ms(lambda: [c() for c in kern], 10) / len(pp),
                    cuda_ms(lambda: [c() for c in plain], 2) / len(pp))
    # K2b's main path, render_binned_tex_idx_batch, is the 4 frames in one
    # launch: the kernel table times that launch (one frame a launch:
    # k2b_one)
    k2b_one = ms["K2b"][0]
    four_tex = tuple(torch.stack([w[i] for w in preps]) for i in range(4))
    ms["K2b"] = (cuda_ms(lambda: tile_raster.raster_tiles_tex_idx(
        *four_tex, tex_dims, WIDTH, cfg["tile_w"], cfg["tile_h"],
        z_clip=True), 10) / len(preps), ms["K2b"][1])
    # K3 beside K2b, both the split walk, which differ by K3's texel
    # load, in turns: one frame a launch and the 4 frames in one launch,
    # at 32x32 and at 128x16 (capacity 512, span (8, 8))
    from libnativecpurenderer_tpu_torch.ops import _kernels
    shape16 = dict(tile_w=128, tile_h=16, capacity=512, span_x=8, span_y=8)
    tex_turns = {}
    for label, (pp, shape) in {
            "32x32": (preps, cfg),
            "128x16": ([(lambda p: (p["sorted_pad"], p["starts"],
                                    p["counts"], p["table"]))(
                prep(m, shape=shape16)) for m in cams], shape16)}.items():
        tw, th = shape["tile_w"], shape["tile_h"]
        four = tuple(torch.stack([w[i] for w in pp]) for i in range(4))
        n = len(pp)
        t = in_turns({
            "K3": lambda: [tile_raster.raster_tiles_tex_u8(
                *w, tex_packed, tex_dims, bgp, WIDTH, tw, th, z_clip=True)
                for w in pp],
            "K2b": lambda: [tile_raster.raster_tiles_tex_idx(
                *w, tex_dims, WIDTH, tw, th, z_clip=True) for w in pp],
            "K3 batch": lambda: tile_raster.raster_tiles_tex_u8(
                *four, tex_packed, tex_dims, bgp, WIDTH, tw, th,
                z_clip=True),
            "K2b batch": lambda: tile_raster.raster_tiles_tex_idx(
                *four, tex_dims, WIDTH, tw, th, z_clip=True)})
        t = {k: [v / n for v in vs] for k, vs in t.items()}
        tex_turns[label] = t
        b = walk_bound(pp, K3_EPI_OPS, 4, 4 * tex_packed.numel(), tile=shape)
        b2 = walk_bound(pp, K2B_EPI_OPS, 4, tile=shape)
        print(f"[tex times] {card}: K3 beside K2b (both the split walk; K3 "
              f"also loads the texel) at {label} ({shape}), ms/frame in "
              f"turns (CUDA events, calls queued behind a sleep, mean of 4 "
              f"cameras; 'batch' = the 4 frames in one launch): "
              + "; ".join(f"{k} {v}" for k, v in t.items())
              + f"; K3 bound {b[0]} ms/frame by {b[1]}, K3 at "
              f"{b[0] / min(t['K3']):.4f} of it one frame a launch, "
              f"{b[0] / min(t['K3 batch']):.4f} batched; K2b bound {b2[0]} "
              f"ms/frame by {b2[1]}, K2b at {b2[0] / min(t['K2b']):.4f} of "
              f"it one frame a launch, {b2[0] / min(t['K2b batch']):.4f} "
              f"batched; {occupancy(_kernels, True, tw, th, True)}; runs "
              f"{run_stats(pp)}", flush=True)
    # K2a in turns at its three main paths' shapes: render_textured's
    # 128x8 (one frame a launch), render_gouraud_pallas(flat=True)'s
    # 128x16 (one frame a launch) and the batch entry's flat route at
    # 128x32 (the 4 frames in one launch), each beside its bound
    cverts, cfaces, ccolors = interop.mesh_to_torch(
        verts_np, faces_np, mesh.mesh_10k()[2], dev)
    k2a_shapes = {"128x8 (render_textured)": (rt_preps, rt_cfg, False)}
    for label, entry, batched in (
            ("render_gouraud_pallas(flat=True)",
             raster3d.render_gouraud_pallas, False),
            ("render_gouraud_pallas_batch(flat=True)",
             raster3d.render_gouraud_pallas_batch, True)):
        shape = defaults(entry)
        pp = []
        for m in cams:
            pr = raster3d.prepare_frame(
                cverts, cfaces, ccolors, WIDTH, HEIGHT,
                torch.from_numpy(m).to(dev), z_clip=True, exact_c=False,
                **shape)
            if bool(pr["overflow"]):
                raise AssertionError(f"the {label} prep overflows")
            pp.append(tuple(pr[k] for k in ("sorted_pad", "starts", "counts",
                                            "table")))
        k2a_shapes[f"{shape['tile_w']}x{shape['tile_h']} ({label})"] = (
            pp, shape, batched)
    k2a = tile_raster.raster_tiles_keys_f32
    fns = {}
    for label, (pp, shape, batched) in k2a_shapes.items():
        tw, th = shape["tile_w"], shape["tile_h"]
        if batched:
            four = tuple(torch.stack([w[i] for w in pp]) for i in range(4))
            fns[label] = (lambda four=four, tw=tw, th=th:
                          k2a(*four, WIDTH, tw, th, z_clip=True))
        else:
            fns[label] = (lambda pp=pp, tw=tw, th=th:
                          [k2a(*w, WIDTH, tw, th, z_clip=True) for w in pp])
    k2a_turns = {k: [v / len(cams) for v in vs]
                 for k, vs in in_turns(fns).items()}
    for label, (pp, shape, batched) in k2a_shapes.items():
        b = k2a_bound(pp, shape)
        t = min(k2a_turns[label])
        how = "the 4 frames in one launch" if batched else \
            "one frame a launch"
        print(f"[tex times] {card}: K2a at {label} ({shape}, z test on), "
              f"{how}, ms/frame in turns (CUDA events, calls queued behind "
              f"a sleep, mean of 4 cameras): {k2a_turns[label]}; bound "
              f"{b[0]} ms/frame by {b[1]} (bytes {b[2]} ms, the culled "
              f"walk's operations {b[3]} ms, the cull keeping {b[6]:.4f} of "
              f"the (row, warp) pairs (the plain mirror pairs_cull_keep); "
              f"pairs walked {b[4]}), K2a at {b[0] / t:.4f} of it; the old "
              f"yardstick (every walked pair at every tile pixel) {b[5]} "
              f"ms, K2a at {b[5] / t:.4f} of it; "
              f"{occupancy(_kernels, False, shape['tile_w'], shape['tile_h'], True, walks=('split pairs f32',))}",
              flush=True)
    for kk in kernels:
        kk.launches = 0
    pipe = MeshVideoPipeline(DropSink(), WIDTH, HEIGHT, verts_np, faces_np,
                             uvs=uvs_np, tex_u8=tex_np, batch=BATCH)

    def frames16():
        for k in range(PROFILE_FRAMES):
            pipe.submit(camera(mesh, k, 0.03))
        pipe.finish()

    frames16()   # warm
    per_frame, busy, prof = profile_frames(frames16, PROFILE_FRAMES)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # bounds: the walk's operations and bytes, plus each epilogue's
    # operations a pixel slot (counted from csrc/tile_raster.cu) and its
    # outputs (K3 also reads the texture once)
    bounds = {"K3": walk_bound(preps, K3_EPI_OPS, 4, 4 * tex_packed.numel()),
              "K2b": walk_bound(preps, K2B_EPI_OPS, 4),
              "K2a": k2a_bound(rt_preps, rt_cfg)}
    for name in ("K3", "K2b", "K2a"):
        b_ms, b_by, bb, bo, pairs, *_ = bounds[name]
        shape = timed[name][1]
        how = (f" with the 4 frames in one launch ({k2b_one} one frame a "
               f"launch)" if name == "K2b" else "")
        print(f"[tex times] {card}: {name} {ms[name][0]} ms/frame{how}, plain "
              f"version {ms[name][1]} ms/frame (1080p textured mesh_10k, "
              f"{shape['tile_w']}x{shape['tile_h']} tiles, span "
              f"({shape['span_x']}, {shape['span_y']}), CUDA events, mean "
              f"of 4 cameras); bound {b_ms} "
              f"ms/frame by {b_by} (bytes {bb} ms, operations {bo} ms; "
              f"pairs walked {pairs}), {name} at {b_ms / ms[name][0]:.4f} of "
              f"it", flush=True)
    print(f"[tex times] device ms per frame by kernel (profiler): "
          + "; ".join(f"{name[:60]} {1e-3 * us / PROFILE_FRAMES:.4f}"
                      for name, us in top), flush=True)
    print(f"[tex times] {card}: textured pipeline frames/s, 3 runs of "
          f"{FRAMES} frames, batch {BATCH}, tiled sink dropping frames, host "
          f"clock: {fps} (Gouraud, in turns with them: {fps_g}); per "
          f"frame over {PROFILE_FRAMES} profiled frames: "
          f"{per_frame['cudaLaunchKernel']} cudaLaunchKernel, "
          f"{per_frame['cudaStreamSynchronize']} cudaStreamSynchronize, "
          f"{per_frame['cudaMemcpyAsync']} cudaMemcpyAsync; device {busy}; "
          f"peak device memory {peak_mib} MiB in the checked main path, "
          f"{peak_mib - base_mib} MiB above the {base_mib} MiB held before "
          f"it", flush=True)
    src = "libnativecpurenderer_tpu_torch/csrc/tile_raster.cu"
    tpu = "libnativecpurenderer_tpu/ops/pallas_raster.py"
    rows = []
    for name, fn, line, launches, err in (
            ("K3", "raster_tiles_tex_u8", 895, k3_launches[0], errs[0]),
            ("K2b", "raster_tiles_tex_idx", 793, k2b_launches[1], errs[1]),
            ("K2a", "raster_tiles_keys_f32", 805, k2a_launches[2], errs[2])):
        rows.append({"name": fn, "route": "cuda", "source": src,
                     "replaces": f"{tpu}:{line}", "launches": launches,
                     "max_abs_err": err, "ms": ms[name][0],
                     "plain_ms": ms[name][1], "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1], "library_ms": None})
    return rows


def defaults(fn, names=("tile_w", "tile_h", "capacity", "span_x",
                         "span_y")) -> dict:
    """The tile configuration an entry takes by default."""
    sig = inspect.signature(fn).parameters
    return {n: sig[n].default for n in names}


def same_bits(a, b) -> int:
    """How many elements of two int or float tensors differ in their bits."""
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def same_bits_but_nan(a, b) -> int:
    """How many elements of two float tensors differ in their bits where
    they are not both NaN (a NaN against a number counts)."""
    both = torch.isnan(a) & torch.isnan(b)
    ia = a.view(torch.int64 if a.dtype == torch.float64 else torch.int32)
    ib = b.view(ia.dtype)
    return int(((ia != ib) & ~both).sum())


def gouraud_phases(dev, card: str, k2a_row: dict) -> list:
    """Phases 13-15: K5 and K6 against their plain versions (K6 also
    against K1's batched launch), the float and depth Gouraud main path
    (render_gouraud_pallas, with flat=True too, render_gouraud_pallas_batch
    on every route, the tensor-op routes and near clipping, card against
    CPU) and its times; returns K5's and K6's entries of the kernel
    table, and adds K2a's launches on its two Gouraud main paths to
    ``k2a_row``, its entry."""
    from libnativecpurenderer_tpu_torch import interop
    from libnativecpurenderer_tpu_torch.models import mesh
    from libnativecpurenderer_tpu_torch.ops import _kernels, raster3d, \
        tile_raster

    verts_np, faces_np, colors_np = mesh.mesh_10k()
    verts, faces, colors = interop.mesh_to_torch(verts_np, faces_np,
                                                 colors_np, dev)
    cpu = interop.mesh_to_torch(verts_np, faces_np, colors_np, "cpu")
    pre = (raster3d.pregather_mesh(verts, faces), colors[faces])
    F = faces.shape[0]
    k5, k6, k1 = (tile_raster.raster_tiles_bins_f32,
                  tile_raster.raster_tiles_rows_u8,
                  tile_raster.raster_tiles_flat_u8)
    single = defaults(raster3d.render_gouraud_pallas)
    batch = defaults(raster3d.render_gouraud_pallas_batch)
    dyn = dict(PROD)       # K6's and K1's batched launch: opaque, no z test
    rows_cap = 49152       # render_gouraud_pallas_batch's default
    bgp = tile_raster.pack_bg(torch.zeros(4, device=dev))
    cams = [camera(mesh, k, 0.45) for k in range(4)]
    mvps = torch.from_numpy(np.stack(cams)).to(dev)

    def bins_prep(mvp, cfg):
        """render_gouraud_pallas's default prep of one frame at ``cfg``:
        (bins with NO_TRI sent to the pad row, counts, table, overflow)."""
        tri, attrs, edges = raster3d._setup_edges(
            verts, faces, mvp, WIDTH, HEIGHT, v4f=pre[0], attrs=pre[1])
        bins, counts, ovf = raster3d.bin_triangles(
            tri["sxy"], edges[-1], WIDTH, HEIGHT, cfg["tile_w"],
            cfg["tile_h"], cfg["capacity"], cfg["span_x"], cfg["span_y"])
        return (torch.where(bins == raster3d.NO_TRI, F, bins), counts,
                tile_raster.build_table(*edges, attrs), ovf)

    # 13. K5 and K6 against their plain versions, bit for bit
    saved = [k.launches for k in (k5, k6, k1)]
    errs = [0.0, 0]

    def k5_vs_plain(label, bins, counts, table, cfg, width=WIDTH):
        args = (bins, counts, table, width, cfg["tile_w"], cfg["tile_h"])
        (gk, gr), (wk, wr) = k5(*args), \
            tile_raster.raster_tiles_bins_f32_reference(*args)
        torch.cuda.synchronize()
        bad = same_bits(gk, wk) + same_bits(gr, wr)
        err = float((gr - wr).abs().max())
        errs[0] = max(errs[0], err)
        cts = counts.clamp(max=bins.shape[-1])
        kept = tile_raster.bins_cull_keep(*args)
        print(f"[k5 vs plain] {label}, tiles {cfg['tile_w']}x{cfg['tile_h']}"
              f", capacity {cfg['capacity']}, span ({cfg['span_x']}, "
              f"{cfg['span_y']}): {bad} of {gk.numel()} keys and "
              f"{gr.numel()} attribute values differ in their bits (max "
              f"|delta| {err}); "
              f"{float((gk != raster3d.SKY_KEY).float().mean()):.3f} of the "
              f"slots covered; pairs walked {int(cts.sum())}, longest run "
              f"{int(cts.max())}, (row, warp) pairs the cull keeps (the "
              f"plain mirror bins_cull_keep on these inputs) "
              f"{int(kept.sum())} of {int(cts.sum()) * tile_raster.WARPS} "
              f"({float(kept.sum()) / max(1, int(cts.sum())) / tile_raster.WARPS:.4f})",
              flush=True)
        if bad:
            raise AssertionError(f"K5 and its plain version disagree: "
                                 f"{label}")

    k5_preps = []
    for k, mvp in enumerate(mvps):
        b, c, t, ovf = bins_prep(mvp, single)
        if bool(ovf):
            raise AssertionError(f"bins overflow at camera {k}")
        k5_vs_plain(f"camera {k}", b, c, t, single)
        k5_preps.append((b, c, t))
    bp = [bins_prep(mvp, batch) for mvp in mvps]
    if any(bool(p[3]) for p in bp):
        raise AssertionError("bins overflow at the batch defaults")
    k5_batch = tuple(torch.stack([p[n] for p in bp]) for n in range(3))
    k5_vs_plain(f"{len(bp)} cameras in one launch", *k5_batch, batch)
    small = dict(tile_w=32, tile_h=8, capacity=512, span_x=8, span_y=8)
    b, c, t, ovf = bins_prep(mvps[0], small)
    if bool(ovf):
        raise AssertionError("bins overflow at 32x8")
    k5_vs_plain("camera 0", b, c, t, small)
    # the split walk's boundaries and the cull's knife edges: runs of 1, S,
    # S + 1, 2S, 2S + 1, K and more than K slots (an overflowed bins row),
    # NaN rows and knife-edge triangles (testing.crafted_bins), one frame
    # at the single defaults' K and 4 in one launch at the batch's
    from libnativecpurenderer_tpu_torch.testing import crafted_bins
    seg = tile_raster.SEG
    for label, cfg, seeds in (("crafted runs", single, [0]),
                              ("crafted runs, 4 frames in one launch",
                               batch, [1, 2, 3, 4])):
        K = cfg["capacity"]
        lengths = [1, seg, seg + 1, 2 * seg, 2 * seg + 1, K, K + 37]
        cases = [crafted_bins(lengths, K, cfg["tile_w"], cfg["tile_h"],
                              seed=sd) for sd in seeds]
        bins_c, counts_c, table_c = (
            torch.stack([cs[i] for cs in cases]).to(dev) if len(cases) > 1
            else cases[0][i].to(dev) for i in range(3))
        wide = dict(cfg, capacity=K)
        k5_vs_plain(f"{label} {lengths}", bins_c, counts_c, table_c,
                    dict(wide, span_x="-", span_y="-"),
                    width=cases[0][3])

    # K2a's batched launch (the batch entry's flat f32 route) against its
    # plain version at the batch defaults
    k2a = tile_raster.raster_tiles_keys_f32
    saved.append(k2a.launches)
    fb = [raster3d.prepare_frame(verts, faces, colors, WIDTH, HEIGHT, mvp,
                                 pre=pre, exact_c=False, **batch)
          for mvp in mvps]
    if any(bool(p["overflow"]) for p in fb):
        raise AssertionError("the K2a batch preps overflow")
    k2a_args = tuple(torch.stack([p[n] for p in fb])
                     for n in ("sorted_pad", "starts", "counts", "table"))
    k2a_args += (WIDTH, batch["tile_w"], batch["tile_h"])
    (gk, gr), (wk, wr) = (k2a(*k2a_args, z_clip=True),
                          tile_raster.raster_tiles_keys_f32_reference(
                              *k2a_args, z_clip=True))
    torch.cuda.synchronize()
    bad = same_bits(gk, wk) + same_bits(gr, wr)
    print(f"[k2a vs plain] {len(fb)} cameras in one launch, tiles "
          f"{batch['tile_w']}x{batch['tile_h']}, capacity {batch['capacity']}"
          f", span ({batch['span_x']}, {batch['span_y']}): {bad} of "
          f"{gk.numel()} keys and {gr.numel()} attribute values differ (max "
          f"|delta| {float((gr - wr).abs().max())}); pairs walked "
          f"{k2a_args[2].sum(1).tolist()}", flush=True)
    if bad:
        raise AssertionError("K2a's batched launch and its plain version "
                             "disagree")

    fp = [raster3d.prepare_frame(verts, faces, colors, WIDTH, HEIGHT, mvp,
                                 z_clip=False, pre=pre, **dyn)
          for mvp in mvps]
    sps, starts, counts, tables = (torch.stack([p[n] for p in fp])
                                   for n in ("sorted_pad", "starts",
                                             "counts", "table"))
    rows = gathered_rows(sps, tables, rows_cap)
    ends = starts[:, -1] + counts[:, -1]
    if any(bool(p["overflow"]) for p in fp) or bool(
            (ends > rows_cap - dyn["capacity"]).any()):
        raise AssertionError("the K6 preps overflow")
    k6_args = (rows, starts, counts, bgp, WIDTH, dyn["tile_w"], dyn["tile_h"])
    k1_args = (sps, starts, counts, tables, bgp, WIDTH, dyn["tile_w"],
               dyn["tile_h"])
    got6 = k6(*k6_args)
    want6 = tile_raster.raster_tiles_rows_u8_reference(*k6_args)
    got1 = k1(*k1_args, opaque=True, z_clip=False)
    torch.cuda.synchronize()
    bad = [same_bits(got6, want6), same_bits(got6, got1)]
    errs[1] = int((tile_raster.tiles_u8(got6).int()
                   - tile_raster.tiles_u8(want6).int()).abs().max())
    print(f"[k6 vs plain] {len(fp)} cameras in one launch, tiles "
          f"{dyn['tile_w']}x{dyn['tile_h']}, span ({dyn['span_x']}, "
          f"{dyn['span_y']}), opaque, z_clip off, rows_cap {rows_cap}: "
          f"{bad[0]} of {got6.numel()} packed pixels differ from the plain "
          f"version, {bad[1]} from K1's batched launch; pairs "
          f"{counts.sum(1).tolist()}, pair runs end at {ends.tolist()}",
          flush=True)
    if any(bad):
        raise AssertionError("K6 disagrees with its plain version or K1")

    def k6_vs_plain(label, rows_, starts_, counts_, width, k1_args_=None):
        """K6 on (B, CAP) rows against its plain version and, where the
        rows hold every run, K1's launch on the same frames: bit-equal."""
        a6 = (rows_, starts_, counts_, bgp, width, dyn["tile_w"],
              dyn["tile_h"])
        got = k6(*a6)
        want = tile_raster.raster_tiles_rows_u8_reference(*a6)
        same1 = (same_bits(got, k1(*k1_args_, opaque=True, z_clip=False))
                 if k1_args_ is not None else "-")
        torch.cuda.synchronize()
        bad6 = same_bits(got, want)
        errs[1] = max(errs[1], int((tile_raster.tiles_u8(got).int()
                                    - tile_raster.tiles_u8(want).int())
                                   .abs().max()))
        ends_ = (starts_[:, -1] + counts_[:, -1]).tolist()
        print(f"[k6 vs plain] {label}: {bad6} of {got.numel()} packed pixels "
              f"differ from the plain version, {same1} from K1; CAP "
              f"{rows_.shape[1]}, runs end at {ends_}, "
              f"{float((want != bgp).float().mean()):.3f} covered",
              flush=True)
        if bad6 or same1 not in (0, "-"):
            raise AssertionError(f"K6 disagrees with its plain version or "
                                 f"K1: {label}")

    # one frame a launch on the 4 cameras
    for i in range(len(fp)):
        k6_vs_plain(f"camera {i}, one frame a launch", rows[i:i + 1],
                    starts[i:i + 1], counts[i:i + 1], WIDTH,
                    tuple(a[i:i + 1] for a in k1_args[:4]) + k1_args[4:])
    # the split walk's boundary runs (phase 3's), rows gathered in pair
    # order: one frame a launch, with CAP the pair array's length and cut
    # below the runs' end (by 10 rows: the item list still fits; by 1000:
    # it does not, and the plan walks each tile as one item), then 4
    # frames in one launch, one of them with a run read past CAP
    for label, args in split_cases(dev, bgp):
        sp, st, ct, tb, _, w, tw, th = args
        one = (sp[None], st[None], ct[None], tb[None])
        end = int(st[-1] + ct[-1])
        for cut_label, cap in (("", sp.shape[0]),
                               (", 10 rows past CAP", end - 10),
                               (", 1000 rows past CAP", end - 1000)):
            if cut_label and not label.startswith("boundaries"):
                continue
            k6_vs_plain(f"{label}{cut_label}, one frame a launch",
                        gathered_rows(one[0], one[3], cap), one[1], one[2],
                        w, None if cut_label else one + (bgp, w, tw, th))
    four, w4 = split_frames(dev, [21, 22, 23, 24], past_end=(3,))
    k6_vs_plain("boundaries, 4 frames in one launch, frame 3's last run "
                "past CAP", gathered_rows(four[0], four[3],
                                          four[0].shape[1]),
                four[1], four[2], w4, four + (bgp, w4, 32, 32))
    end = int((four[1][:, -1] + four[2][:, -1]).min())
    k6_vs_plain("boundaries, 4 frames in one launch, 1000 rows past CAP",
                gathered_rows(four[0], four[3], end - 1000), four[1],
                four[2], w4)
    u8_kw = dict(flat=True, u8=True, opaque=True, z_clip=False, **dyn)
    ref_u8, _, ovf_u8 = raster3d.render_gouraud_pallas_batch(
        verts, faces, colors, WIDTH, HEIGHT, mvps, **u8_kw)
    for g in (1, 2, 4):
        fr, _, ovf = raster3d.render_gouraud_pallas_batch(
            verts, faces, colors, WIDTH, HEIGHT, mvps, dynrows=g, **u8_kw)
        d = int((fr != ref_u8).any(-1).sum())
        print(f"[k6 vs plain] render_gouraud_pallas_batch(dynrows={g}) over "
              f"{len(fp)} frames: {d} pixels differ from the flat u8 route "
              f"(K1); overflow {bool(ovf)}", flush=True)
        if d or bool(ovf) or bool(ovf_u8):
            raise AssertionError(f"dynrows={g} differs from the u8 route")
    for k, n in zip((k5, k6, k1, k2a), saved):
        k.launches = n

    # 14. the main path, each kernel's launches counted from zero
    kernels = {"K5": k5, "K6": k6, "K1": k1,
               "K2a": tile_raster.raster_tiles_keys_f32}

    def counted(fn):
        for kk in kernels.values():
            kk.launches = 0
        out = fn()
        return out, {n: kk.launches for n, kk in kernels.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2 ** 20
    frames, n_single = counted(lambda: [
        raster3d.render_gouraud_pallas(verts, faces, colors, WIDTH, HEIGHT,
                                       mvp) for mvp in mvps])
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if n_single != {"K5": len(cams), "K6": 0, "K1": 0, "K2a": 0}:
        raise AssertionError(f"render_gouraud_pallas launched {n_single} "
                             f"for {len(cams)} frames")
    for rgba, zq, ovf in frames:
        if (bool(ovf) or rgba.shape != (HEIGHT, WIDTH, 4)
                or not bool(torch.isfinite(rgba).all())):
            raise AssertionError("a render_gouraud_pallas frame is wrong")
    lit = [float((zq < 1.0).float().mean()) for _, zq, _ in frames]
    t0 = time.perf_counter()
    rgba_c, zq_c, ovf_c = raster3d.render_gouraud_pallas(
        *cpu, WIDTH, HEIGHT, mvps[0].cpu())
    cpu_s = time.perf_counter() - t0
    d_rgba = int((frames[0][0].cpu() != rgba_c).any(-1).sum())
    d_z = int((frames[0][1].cpu() != zq_c).sum())
    print(f"[gouraud main path] render_gouraud_pallas (defaults {single}) "
          f"on {len(cams)} frames at {WIDTH}x{HEIGHT}: launches {n_single}, "
          f"no overflow, {min(lit):.3f}..{max(lit):.3f} of each frame "
          f"covered; frame 0 vs the CPU ({cpu_s:.1f} s): {d_rgba} rgba "
          f"pixels and {d_z} depths differ", flush=True)
    if d_rgba or d_z or bool(ovf_c):
        raise AssertionError("render_gouraud_pallas on the card differs from "
                             "the CPU")
    # render_gouraud_pallas(flat=True) at its defaults (128x16): K2a once
    # a frame, each frame equal to the plain version's on its own prep,
    # and frame 0 to the CPU's
    flat_frames, n_flat = counted(lambda: [
        raster3d.render_gouraud_pallas(verts, faces, colors, WIDTH, HEIGHT,
                                       mvp, flat=True) for mvp in mvps])
    if n_flat != {"K5": 0, "K6": 0, "K1": 0, "K2a": len(cams)}:
        raise AssertionError(f"render_gouraud_pallas(flat=True) launched "
                             f"{n_flat} for {len(cams)} frames")
    zeros = torch.zeros(4, device=dev)
    d_plain = 0
    for mvp, (rgba, zq, ovf) in zip(mvps, flat_frames):
        pr = raster3d.prepare_frame(verts, faces, colors, WIDTH, HEIGHT, mvp,
                                    bg=zeros, z_clip=True, exact_c=False,
                                    **single)
        keys_p, rgba_p = tile_raster.detile_keys_rgba(
            *tile_raster.raster_tiles_keys_f32_reference(
                pr["sorted_pad"], pr["starts"], pr["counts"], pr["table"],
                WIDTH, single["tile_w"], single["tile_h"], z_clip=True),
            WIDTH, HEIGHT, single["tile_w"], single["tile_h"], zeros,
            torch.float32)
        zq_p = (keys_p >> raster3d.IDX_BITS).to(torch.float32) \
            / raster3d._z_levels(torch.float32, dev)
        d_plain += same_bits(rgba, rgba_p) + same_bits(zq, zq_p)
        if bool(ovf) or bool(pr["overflow"]):
            raise AssertionError("a render_gouraud_pallas(flat=True) frame "
                                 "overflows")
    rgba_c, zq_c, ovf_c = raster3d.render_gouraud_pallas(
        *cpu, WIDTH, HEIGHT, mvps[0].cpu(), flat=True)
    d_cpu = int((flat_frames[0][0].cpu() != rgba_c).any(-1).sum()) + int(
        (flat_frames[0][1].cpu() != zq_c).sum())
    print(f"[gouraud main path] render_gouraud_pallas(flat=True) (defaults "
          f"{single}) on {len(cams)} frames: launches {n_flat}; {d_plain} "
          f"rgba values and depths differ in their bits from K2a's plain "
          f"version on each frame's prep; frame 0 vs the CPU: {d_cpu} "
          f"pixels and depths differ", flush=True)
    if d_plain or d_cpu or bool(ovf_c):
        raise AssertionError("render_gouraud_pallas(flat=True) differs from "
                             "K2a's plain version or the CPU")
    routes = {"non-flat (K5)": (dict(), "K5"),
              "flat f32 (K2a)": (dict(flat=True), "K2a"),
              "flat u8 (K1)": (u8_kw, "K1"),
              "dynrows=2 (K6)": (dict(u8_kw, dynrows=2), "K6")}
    batch_launches = {}
    for label, (kw, kern) in routes.items():
        (fb, zq, ovf), n = counted(
            lambda: raster3d.render_gouraud_pallas_batch(
                verts, faces, colors, WIDTH, HEIGHT, mvps, **kw))
        want = {kk: int(kk == kern) for kk in kernels}
        batch_launches[kern] = n[kern]
        # each frame against the single-frame entry at the same shapes
        one = {k: kw.get(k, batch[k]) for k in batch}
        single_kw = dict(one, **{k: v for k, v in kw.items()
                                 if k in ("flat", "u8", "opaque", "z_clip")})
        diff = 0
        for i, mvp in enumerate(mvps):
            r1, z1, _ = raster3d.render_gouraud_pallas(
                verts, faces, colors, WIDTH, HEIGHT, mvp, **single_kw)
            diff += int((fb[i] != r1).any(-1).sum())
            if z1 is not None:
                diff += int((zq[i] != z1).sum())
        print(f"[gouraud main path] render_gouraud_pallas_batch {label} over "
              f"{len(cams)} frames: launches {n}, (B, H, W, 4) "
              f"{tuple(fb.shape)} {str(fb.dtype)[6:]}, overflow {bool(ovf)}; "
              f"{diff} pixels and depths differ from render_gouraud_pallas "
              f"frame by frame", flush=True)
        if n != want or bool(ovf) or diff:
            raise AssertionError(f"the batch route {label} is wrong")

    # the tensor-op routes and near clipping at reduced frames, card vs
    # CPU (their CPU side is slow at 1080p)
    def card_vs_cpu(label, fn, w, h):
        t0 = time.perf_counter()
        got = fn(dev, w, h)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = fn("cpu", w, h)
        t_cpu = time.perf_counter() - t0
        # the u8 routes return no depth (None)
        got = tuple(x for x in (got if isinstance(got, tuple) else (got,))
                    if x is not None)
        want = tuple(x for x in (want if isinstance(want, tuple)
                                 else (want,)) if x is not None)
        bad = [int((g.cpu() != x).sum()) for g, x in zip(got, want)
               if g.dim()]
        flags = [bool(x) for x in got + want if not x.dim()]
        print(f"[gouraud main path] {label} at {w}x{h}, card vs CPU: "
              f"{bad} values differ; overflow {flags}; card {t_card:.2f} s, "
              f"CPU {t_cpu:.2f} s", flush=True)
        if any(bad) or any(flags):
            raise AssertionError(f"{label}: card differs from the CPU")

    def on(d, w, h, eye=(0.0, 0.6, 3.2)):
        v, f, c = (verts, faces, colors) if d == dev else cpu
        m = (mesh.perspective(1.0, w / h, 0.1, 10.0)
             @ mesh.look_at(list(eye), [0, 0, 0], [0, 1, 0])
             @ mesh.rotation_y(0.3))
        return v, f, c, w, h, torch.from_numpy(m.astype(np.float32)).to(d)

    fine = dict(tile_w=16, tile_h=8, capacity=512, batch_tiles=32)
    # whole-frame spans for the clipped triangles, which project large
    wide = dict(span_x=8, span_y=9, capacity=512)
    card_vs_cpu("render_gouraud_binned", lambda d, w, h: (
        raster3d.render_gouraud_binned(*on(d, w, h), **fine)), 480, 270)
    card_vs_cpu("render_gouraud (naive)", lambda d, w, h: (
        raster3d.render_gouraud(*on(d, w, h))), 240, 135)
    # near clipping: the eye inside the ring of quads, some of whose
    # triangles cross the camera plane
    near_eye = (1.45, 0.05, 0.0)
    v_, f_, _, _, _, m_ = on(dev, 480, 270, near_eye)
    w4 = raster3d._clip_rows(raster3d.pregather_mesh(v_, f_), m_)[..., 3]
    n_in = (w4 > raster3d.NEAR_EPS).sum(1)
    crossing = int(((n_in == 1) | (n_in == 2)).sum())
    print(f"[gouraud main path] near clip camera: {crossing} triangles "
          f"cross the near plane, {int((n_in == 0).sum())} lie behind it",
          flush=True)
    if not crossing:
        raise AssertionError("the near clip camera clips nothing")
    card_vs_cpu("render_gouraud_pallas(near_clip=True) (K5)", lambda d, w, h: (
        raster3d.render_gouraud_pallas(*on(d, w, h, near_eye),
                                       near_clip=True, tile_w=64, tile_h=32,
                                       **wide)), 480, 270)
    for label, kw in (("flat f32 (K2a)", dict(flat=True)),
                      ("flat u8 (K1)", dict(flat=True, u8=True))):
        card_vs_cpu(f"render_gouraud_pallas(near_clip=True) {label}",
                    lambda d, w, h, kw=kw: raster3d.render_gouraud_pallas(
                        *on(d, w, h, near_eye), near_clip=True, tile_w=64,
                        tile_h=32, **wide, **kw), 480, 270)
    card_vs_cpu("render_gouraud_binned(near_clip=True)", lambda d, w, h: (
        raster3d.render_gouraud_binned(*on(d, w, h, near_eye),
                                       near_clip=True, tile_w=32, tile_h=16,
                                       **wide)), 240, 135)
    card_vs_cpu("render_gouraud_binned(perspective_correct=True)",
                lambda d, w, h: raster3d.render_gouraud_binned(
                    *on(d, w, h), perspective_correct=True, **fine), 480, 270)

    def return_ids(d, w, h):
        # render_binned_pallas with the global triangle ids in the keys
        v, f, c, _, _, m = on(d, w, h)
        tri, attrs, edges = raster3d._setup_edges(v, f, m, w, h,
                                                  attrs=c[f])
        bins, counts, ovf = raster3d.bin_triangles(
            tri["sxy"], edges[-1], w, h, 16, 8, 512, 8, 8)
        return tile_raster.render_binned_pallas(
            bins, counts, *edges, attrs, torch.zeros(4, device=d), w, h, 16,
            8, return_ids=True) + (ovf,)

    card_vs_cpu("render_binned_pallas(return_ids=True) (K5)", return_ids,
                480, 270)
    t_verts, t_faces, t_uvs, t_tex = textured_scene()
    # the texels as floats, made on the host so both sides read the same
    t_texf = torch.from_numpy(t_tex.astype(np.float32) / np.float32(255.0))

    def textured_binned(d, w, h):
        v, f, u, _ = interop.textured_mesh_to_torch(t_verts, t_faces, t_uvs,
                                                    t_tex, d)
        return raster3d.render_textured_binned(v, f, u, t_texf.to(d), w, h,
                                               on(d, w, h)[-1], **fine)

    card_vs_cpu("render_textured_binned", textured_binned, 480, 270)
    q_verts, q_faces, q_uvs = mesh.quad_batch(6, seed=3)
    q_faces = q_faces[np.argsort(-q_verts[q_faces[:, 0], 2], kind="stable")]
    q_tex = np.random.default_rng(3).uniform(0, 1, (64, 64, 4))

    def blended(d, w, h):
        v, f, u, t = (torch.tensor(a, dtype=torch.float32 if i != 1
                                   else torch.int64, device=d)
                      for i, a in enumerate((q_verts, q_faces, q_uvs,
                                             q_tex)))
        return raster3d.render_blended(v, f, u, t, w, h)

    card_vs_cpu("render_blended (BASELINE config 2's scene)", blended, 480,
                270)

    # 15. times
    def k5_all():
        for p in k5_preps:
            k5(*p, WIDTH, single["tile_w"], single["tile_h"])

    def k5_plain_all():
        for p in k5_preps:
            tile_raster.raster_tiles_bins_f32_reference(
                *p, WIDTH, single["tile_w"], single["tile_h"])

    saved = [k.launches for k in (k5, k6, k1)]
    n4 = len(cams)
    ms = {"K5": (cuda_ms(k5_all, 10) / n4, cuda_ms(k5_plain_all, 2) / n4),
          "K5 batch": (cuda_ms(lambda: k5(*k5_batch, WIDTH, batch["tile_w"],
                                          batch["tile_h"]), 10) / n4,
                       cuda_ms(lambda: tile_raster.
                               raster_tiles_bins_f32_reference(
                                   *k5_batch, WIDTH, batch["tile_w"],
                                   batch["tile_h"]), 2) / n4),
          "K6": (cuda_ms(lambda: k6(*k6_args), 10) / n4,
                 cuda_ms(lambda: tile_raster.raster_tiles_rows_u8_reference(
                     *k6_args), 2) / n4),
          "K1 batch": (cuda_ms(lambda: k1(*k1_args, opaque=True,
                                          z_clip=False), 10) / n4, None)}
    for k, n in zip((k5, k6, k1), saved):
        k.launches = n

    def k5_frames(preps, cfg):
        # per frame: the walked bins, the counts and the table read once
        walked = [int(c.clamp(max=b.shape[1]).sum()) for b, c, _ in preps]
        return [(n, c.numel(), 4 * (n + c.numel() + t.numel()))
                for n, (_, c, t) in zip(walked, preps)]

    def k5_bound(preps, cfg):
        """:func:`culled_bound` of K5, the kept (row, warp) pairs from the
        plain mirror bins_cull_keep on these inputs."""
        tw, th = cfg["tile_w"], cfg["tile_h"]
        keeps = [(int(tile_raster.bins_cull_keep(b, c, t, WIDTH, tw,
                                                 th).sum()),
                  int(c.clamp(max=b.shape[-1]).sum()) * tile_raster.WARPS,
                  c.numel()) for b, c, t in preps]
        return culled_bound(pairs_bound(k5_frames(preps, cfg), tw * th,
                                        K2A_EPI_OPS, 4 + 4 * 4), keeps,
                            tw * th)

    bounds = {
        "K5": k5_bound(k5_preps, single),
        "K5 batch": k5_bound([(p[0], p[1], p[2]) for p in bp], batch),
        # K6 reads each walked row once (32 floats), starts and counts
        "K6": pairs_bound([(int(counts[i].sum()), counts.shape[1],
                            4 * (32 * int(counts[i].sum())
                                 + 2 * counts.shape[1]))
                           for i in range(n4)],
                          dyn["tile_w"] * dyn["tile_h"], U8_EPI_OPS, 4),
        # K1 reads the pairs and the table
        "K1 batch": pairs_bound([(int(counts[i].sum()), counts.shape[1],
                                  4 * (int(counts[i].sum())
                                       + tables[i].numel()
                                       + 2 * counts.shape[1]))
                                 for i in range(n4)],
                                dyn["tile_w"] * dyn["tile_h"], U8_EPI_OPS,
                                4)}
    shapes = {"K5": single, "K5 batch": batch, "K6": dyn, "K1 batch": dyn}
    for name, (k_ms, p_ms) in ms.items():
        b_ms, b_by, bb, bo, pairs, *old = bounds[name]
        cfg = shapes[name]
        plain = (f"plain version {p_ms} ms/frame" if p_ms is not None
                 else "plain version not timed (K6's computes the same)")
        yard = (f"; the old yardstick (every walked pair at every tile "
                f"pixel, before the cull) {old[0]} ms, K5 at "
                f"{old[0] / k_ms:.4f} of it" if old else "")
        print(f"[gouraud times] {card}: {name} {k_ms} ms/frame, {plain} "
              f"(1080p mesh_10k, {cfg['tile_w']}x{cfg['tile_h']} tiles, "
              f"span ({cfg['span_x']}, {cfg['span_y']}), CUDA events, mean "
              f"of {n4} cameras); bound {b_ms} ms/frame by {b_by} (bytes "
              f"{bb} ms, operations {bo} ms; pairs walked {pairs}), {name} "
              f"at {b_ms / k_ms:.4f} of it, at {bb / k_ms:.4f} of the bytes "
              f"alone{yard}", flush=True)
    for label, cfg in (("128x16", single), ("128x32", batch)):
        regs, per_sm = _kernels.tile_raster_occupancy(
            "split bins", False, cfg["tile_w"], cfg["tile_h"], True)
        print(f"[gouraud times] K5's split walk at {label}: {regs} "
              f"registers, {per_sm} blocks an SM", flush=True)

    def frames_n(n):
        for k in range(n):
            raster3d.render_gouraud_pallas(
                verts, faces, colors, WIDTH, HEIGHT,
                torch.from_numpy(camera(mesh, k, 0.03)).to(dev))

    frames_n(4)   # warm
    fps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames_n(PROFILE_FRAMES * 2)
        torch.cuda.synchronize()
        fps.append(PROFILE_FRAMES * 2 / (time.perf_counter() - t0))
    per_frame, busy, prof = profile_frames(lambda: frames_n(PROFILE_FRAMES),
                                           PROFILE_FRAMES)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[gouraud times] device ms per frame by kernel (profiler): "
          + "; ".join(f"{name[:60]} {1e-3 * us / PROFILE_FRAMES:.4f}"
                      for name, us in top), flush=True)
    print(f"[gouraud times] {card}: render_gouraud_pallas (defaults) "
          f"frames/s, 3 runs of {PROFILE_FRAMES * 2} frames each ended by a "
          f"sync, host clock: {sorted(fps)}; per frame over "
          f"{PROFILE_FRAMES} profiled frames: "
          f"{per_frame['cudaLaunchKernel']} cudaLaunchKernel, "
          f"{per_frame['cudaStreamSynchronize']} cudaStreamSynchronize, "
          f"{per_frame['cudaMemcpyAsync']} cudaMemcpyAsync; device {busy}; "
          f"peak device memory {peak_mib} MiB over {n4} frames, "
          f"{peak_mib - base_mib} MiB above the {base_mib} MiB held before "
          f"them", flush=True)
    k2a_row["launches"] += n_flat["K2a"] + batch_launches["K2a"]
    tpu = "libnativecpurenderer_tpu/ops/pallas_raster.py"
    src = "libnativecpurenderer_tpu_torch/csrc/tile_raster.cu"
    return [{"name": "raster_tiles_bins_f32", "route": "cuda", "source": src,
             "replaces": f"{tpu}:1433",
             "launches": n_single["K5"] + batch_launches["K5"],
             "max_abs_err": errs[0], "ms": ms["K5"][0],
             "plain_ms": ms["K5"][1], "bound_ms": bounds["K5"][0],
             "bound_by": bounds["K5"][1], "library_ms": None},
            {"name": "raster_tiles_rows_u8", "route": "cuda", "source": src,
             "replaces": f"{tpu}:1294", "launches": batch_launches["K6"],
             "max_abs_err": errs[1], "ms": ms["K6"][0],
             "plain_ms": ms["K6"][1], "bound_ms": bounds["K6"][0],
             "bound_by": bounds["K6"][1], "library_ms": None}]


# K1-mxu's operations, counted from csrc/tile_raster.cu: per (pixel,
# triangle) the product's 4 walk planes x 16 terms x 2 on the tensor
# cores, and on the CUDA cores K1's walk without its plane evaluation (3
# coverage compares, the z quantisation, the key, the running minimum:
# 9); per pixel slot the u8 epilogue (K1's 35) or K3's (32) with each
# attribute an affine plane on the CUDA cores, (a_x x + a_y y) + c, 4
# operations where K1's interpolation takes 5
MMA_OPS_PER_PAIR = 4 * 16 * 2
MXU_OPS_PER_PAIR = K1_OPS_PER_PAIR - 17
MXU_U8_EPI_OPS, MXU_TEX_EPI_OPS = U8_EPI_OPS - 3, K3_EPI_OPS - 3
# dense bf16 on the tensor cores (NVIDIA's data sheet, H100 SXM, 700 W)
PEAK_BF16_S = 989e12
# K1-mxu and K3's mxu walk against their plain versions.  The attributes
# are the plain version's bits wherever the winner agrees; only a key or
# a coverage test can differ (the tensor cores' float32 sums are not
# rounded to nearest one addition at a time, so a plane at a knife edge
# may fall the other way).  Pixels differing: at most MXU_SHARE; by more
# than one level, off-texel or flipped in the hit mask: at most
# MXU_BIG_SHARE (1 - TEX_SAME_SHARE for texels); a check allows at least
# one such pixel.  Readings on an H100 (PERF.md): 0 to 4.8e-7 of the 4
# cameras' pixels, one pixel of 6,144 on a crafted run; controls (printed
# each run): mxu=1 against K1, whose attributes round otherwise, 6.4e-2
# differing and texels 5.9e-4 off; the plain version at one bf16 pass
# (mxu=2) against three, 0.15-0.17 differing, 0.039 by more than a
# level, 0.008 hit-mask flips and 0.14 of the texels off.
MXU_SHARE, MXU_BIG_SHARE = 1e-3, 1e-4
TEX_SAME_SHARE = 1 - MXU_BIG_SHARE   # the same texel
# mxu=1 against the FMA walk (K1, K3): JAX's budget of its mxu walk
# against the FMA walk (test_pallas_raster.test_u8_mxu_walk_matches);
# textured: the same texel on at least 99 %
FMA_MXU_SHARE, FMA_MXU_BIG_SHARE, FMA_TEX_SAME_SHARE = 0.15, 0.002, 0.99


def within(share: float, limit: float, n: int) -> bool:
    """share (a mean, so count / n) of n pixels is within limit, at least
    one pixel allowed."""
    return round(share * n) <= max(1.0, limit * n)


def mma_bound(preps, tile, epi_ops: int, out_bytes_px: int,
              extra_bytes: int = 0):
    """(bound ms, 'bytes'|'operations', bytes ms, tensor-core ms,
    CUDA-core ms, pairs) of the matrix-unit walk over these preps, the
    mean a frame: the inputs once and the output; MMA_OPS_PER_PAIR at the
    dense bf16 peak, MXU_OPS_PER_PAIR and ``epi_ops`` a slot at the
    float32 rate."""
    p = tile["tile_w"] * tile["tile_h"]
    byte_s, tc_s, cc_s, pairs = [], [], [], []
    for sorted_pad, starts, counts, table, *_ in preps:
        n = int(counts.sum())
        slots = starts.numel() * p
        byte_s.append((4 * (table.numel() + n + 2 * starts.numel())
                       + extra_bytes + out_bytes_px * slots) / MEM_BYTES_S)
        tc_s.append(n * p * MMA_OPS_PER_PAIR / PEAK_BF16_S)
        cc_s.append((n * p * MXU_OPS_PER_PAIR + slots * epi_ops)
                    / PEAK_OPS_S[torch.float32])
        pairs.append(n)
    b, tc, cc = (1e3 * float(np.mean(x)) for x in (byte_s, tc_s, cc_s))
    return (max(b, tc, cc), "bytes" if b >= max(tc, cc) else "operations",
            b, tc, cc, pairs)


def u8_shares(got, want):
    """(share of pixels differing, share by more than one level, max
    |delta|) of two packed u8 outputs."""
    from libnativecpurenderer_tpu_torch.ops.tile_raster import tiles_u8
    d = (tiles_u8(got).int() - tiles_u8(want).int()).abs().amax(-1)
    return (float((d > 0).float().mean()), float((d > 1).float().mean()),
            int(d.max()))


def sass_mma_count(_kernels) -> str:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in the built
    tile_raster library's SASS, from cuobjdump where the toolkit has it;
    raises when there is no HGMMA (the MMA walk would not be on the
    tensor cores' warpgroup path)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "--dump-sass",
                              str(_kernels.build("tile_raster"))],
                             capture_output=True, text=True, timeout=300)
    except OSError:
        return "not measured (no cuobjdump)"
    if out.returncode:
        return f"not measured (cuobjdump rc {out.returncode})"
    lines = out.stdout.splitlines()
    n = sum("HGMMA" in ln for ln in lines)
    n_old = sum("HMMA" in ln for ln in lines)
    if not n:
        raise AssertionError("the tile_raster library holds no HGMMA "
                             "instruction")
    return f"{n} HGMMA instructions, {n_old} HMMA"


def mma_probe(rows, ox: int, oy: int, tile_w: int, mxu: int):
    """The card's side of the layout probe: the C entry
    tile_raster_mma_probe (one warpgroup builds B from the n <= 16 affine
    rows with the walk's build_b and A of a tile's first 64 pixels with
    a_frag, runs one wgmma_64x64 and writes what lane_planes reads) on
    CUDA rows; (64, 16, 4) float32 as testing.mma_probe_plain returns."""
    from libnativecpurenderer_tpu_torch.ops import _kernels
    out = torch.empty((64, 16, 4), dtype=torch.float32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        _kernels.launch_tile_raster("tile_raster_mma_probe", rows.data_ptr(),
                                    rows.shape[0], ox, oy, tile_w, mxu,
                                    out.data_ptr(), stream)
    return out


def probe_phase(dev) -> None:
    """The MMA walk's layout probe, before any walk depends on it: one
    product of the walk's own operands (:func:`mma_probe`: build_b,
    a_frag, the wgmma descriptor, lane_planes) against the float64
    product of the same bf16 parts (tile_raster.mma_operands), for
    mxu 1 and 2, 16 and 13 rows (3 NaN pad columns), at a tile far from
    the origin (its coordinates need both bf16 parts).  A wrong fragment,
    descriptor or column order moves whole planes; the tensor cores'
    float32 sums (15 terms, not rounded to nearest one addition at a time)
    may differ from the float64 one by some ulps of the terms' magnitude,
    so the error is held to 2^-16 of the sum of the terms' magnitudes."""
    from libnativecpurenderer_tpu_torch.ops import tile_raster as tr
    from libnativecpurenderer_tpu_torch.testing import crafted_runs
    table = crafted_runs([16], seed=7, nan_share=0.0, mxu=True)[3]
    p = torch.arange(64)
    for mxu in (1, 2):
        for n in (16, 13):
            rows = table[:n].contiguous()
            ox, oy, tw = 1792, 1040, 32
            got = mma_probe(rows.to(dev), ox, oy, tw, mxu).cpu()
            A, B, cols = tr.mma_operands(rows, (ox + p % tw).float(),
                                         (oy + p // tw).float(), mxu)
            want = torch.full((64, 16, 4), math.nan, dtype=torch.float64)
            want[:, cols[:, 0], cols[:, 1]] = A.double() @ B.double()
            mag = torch.zeros_like(want)
            mag[:, cols[:, 0], cols[:, 1]] = A.double().abs() @ \
                B.double().abs()
            live = ~torch.isnan(want)
            err = float(((got.double() - want).abs()[live]
                         / mag[live].clamp(min=1e-30)).max())
            nan_ok = bool(torch.equal(torch.isnan(got), ~live))
            print(f"[probe] wgmma m64n64k16, mxu={mxu}, {n} rows: max "
                  f"|card - float64 product| / sum |terms| = {err:.3g} "
                  f"over {int(live.sum())} planes; NaN pad columns "
                  f"{'in place' if nan_ok else 'WRONG'}", flush=True)
            if not err <= 2.0 ** -16 or not nan_ok:
                raise AssertionError(f"the MMA walk's layout probe fails "
                                     f"(mxu={mxu}, {n} rows)")


def wf_mxu_phases(dev, card: str) -> list:
    """Phases 16-17: K1-wf against its plain version and K1, K1-mxu and
    K3's matrix-unit walk against their plain versions and the default
    walk, the boundary runs through both, the wf= and mxu= routes of the
    entries, card against CPU, and their times; returns the three
    kernels' entries of the kernel table."""
    from libnativecpurenderer_tpu_torch import interop
    from libnativecpurenderer_tpu_torch.models import mesh
    from libnativecpurenderer_tpu_torch.ops import _kernels, raster3d
    from libnativecpurenderer_tpu_torch.ops import tile_raster as tr

    verts_np, faces_np, colors_np = mesh.mesh_10k()
    verts, faces, colors = interop.mesh_to_torch(verts_np, faces_np,
                                                 colors_np, dev)
    pre = (raster3d.pregather_mesh(verts, faces), colors[faces])
    cams = [camera(mesh, k, 0.45) for k in range(4)]
    mvps = torch.from_numpy(np.stack(cams)).to(dev)
    k1, wf_k, mxu_k, tex_k = (tr.raster_tiles_flat_u8,
                              tr.raster_tiles_flat_u8_wf,
                              tr.raster_tiles_flat_u8_mxu,
                              tr.raster_tiles_tex_u8_mxu)
    counted = (k1, wf_k, mxu_k, tex_k)
    saved = [k.launches for k in counted]
    print(f"[build] tile_raster SASS: {sass_mma_count(_kernels)}", flush=True)

    def stacked(cfg, opaque, z_clip, mxu=0):
        """The 4 cameras' preps at cfg: (per-frame kernel args, the 4
        frames' args stacked)."""
        preps = [raster3d.prepare_frame(verts, faces, colors, WIDTH, HEIGHT,
                                        mvp, z_clip=z_clip, pre=pre, mxu=mxu,
                                        **cfg) for mvp in mvps]
        if any(bool(p["overflow"]) for p in preps):
            raise AssertionError(f"a prep overflows at {cfg}")
        keys = ("sorted_pad", "starts", "counts", "table")
        tail = (preps[0]["packed_bg"], WIDTH, cfg["tile_w"], cfg["tile_h"])
        one = [tuple(p[k] for k in keys) + tail for p in preps]
        return one, tuple(torch.stack([p[k] for p in preps])
                          for k in keys) + tail

    def flips(got, want, bgp):
        """Share of pixels that are background in one and not the other:
        the hit mask's flips."""
        return float(((got == bgp) != (want == bgp)).float().mean())

    # 16. K1-wf against its plain version and K1, bit for bit
    gdef = defaults(raster3d.render_gouraud_u8)
    wf_cases = {"defaults": (gdef, False, True), "video": (PROD, True, False)}
    wf_preps = {}
    for label, (cfg, opaque, z_clip) in wf_cases.items():
        one, four = stacked(cfg, opaque, z_clip)
        wf_preps[label] = (one, four)
        kw = dict(opaque=opaque, z_clip=z_clip)
        nt = int(four[2].shape[-1])
        want4 = tr.raster_tiles_flat_u8_reference(*four, **kw)
        k1_4 = k1(*four, **kw)
        k1_1 = torch.stack([k1(*a, **kw) for a in one])
        bad_k1 = same_bits(k1_4, want4) + same_bits(k1_1, want4)
        for wf in (1, 8, nt):
            got4 = wf_k(*four, wf=wf, **kw)
            got1 = torch.stack([wf_k(*a, wf=wf, **kw) for a in one])
            torch.cuda.synchronize()
            bad = [same_bits(got1, want4), same_bits(got4, want4),
                   same_bits(got1, k1_1), same_bits(got4, k1_4)]
            print(f"[k1-wf vs plain] {label} ({cfg['tile_w']}x"
                  f"{cfg['tile_h']}, capacity {cfg['capacity']}, span "
                  f"({cfg['span_x']}, {cfg['span_y']}), opaque={opaque}, "
                  f"z_clip={z_clip}, {nt} tiles a frame) wf={wf}: one frame "
                  f"a launch / 4 frames in one launch, {bad[0]} / {bad[1]} "
                  f"of {got4.numel()} packed pixels differ from the plain "
                  f"version, {bad[2]} / {bad[3]} from K1's launches; K1 vs "
                  f"plain {bad_k1}", flush=True)
            if any(bad) or bad_k1:
                raise AssertionError(f"K1-wf wf={wf} differs at {label}")
    # ... and on the split walk's boundary runs
    bgp0 = wf_preps["video"][0][0][4]
    for label, args in split_cases(dev, bgp0):
        nt_c = int(args[2].shape[-1])
        for opaque, z_clip in ((True, False), (False, True)):
            kw = dict(opaque=opaque, z_clip=z_clip)
            want = tr.raster_tiles_flat_u8_reference(*args, **kw)
            bad = [same_bits(wf_k(*args, wf=wf, **kw), want)
                   for wf in (1, 8, nt_c)]
            print(f"[k1-wf vs plain] {label}, opaque={opaque} z_clip="
                  f"{z_clip}, wf 1 / 8 / {nt_c}: {bad} of {want.numel()} "
                  f"packed pixels differ", flush=True)
            if any(bad):
                raise AssertionError(f"K1-wf differs at {label}")

    # K1-mxu: mxu=1 and 2, opaque and not, against its plain version
    # (MXU_SHARE, MXU_BIG_SHARE), and mxu=1 against K1 on the default
    # walk's prep (JAX's budget, FMA_MXU_*); 4 frames in one launch and
    # camera 0 alone; the plain version at mxu=2 against mxu=1 printed as
    # a control of the limits
    mxu_preps = {}
    errs = {"K1-wf": 0, "K1-mxu": 0, "K3-mxu": 0}
    shares = []

    def mxu_check(tag, got, want, bgp, mxu, base=None):
        """Shares of K1-mxu's pixels off ``want``, its plain version (and
        off ``base``, K1), printed and held to their limits."""
        n = got.numel()
        s_w, f_w = u8_shares(got, want), flips(got, want, bgp)
        errs["K1-mxu"] = max(errs["K1-mxu"], s_w[2])
        shares.append(s_w[0])
        ok = (within(s_w[0], MXU_SHARE, n)
              and within(s_w[1], MXU_BIG_SHARE, n)
              and within(f_w, MXU_BIG_SHARE, n))
        line = (f"[k1-mxu vs plain] {tag} mxu={mxu}: pixels differing from "
                f"the plain version {s_w[0]}, by more than 1 level "
                f"{s_w[1]}, max |delta| {s_w[2]}, hit-mask flips {f_w} "
                f"(limits {MXU_SHARE}, {MXU_BIG_SHARE} of {n})")
        if base is not None:
            s_b, f_b = u8_shares(got, base), flips(got, base, bgp)
            ok = ok and (s_b[0] <= FMA_MXU_SHARE
                         and s_b[1] <= FMA_MXU_BIG_SHARE
                         and f_b <= FMA_MXU_BIG_SHARE)
            line += (f"; against K1 (the FMA walk) {s_b[0]}, by more than 1 "
                     f"level {s_b[1]}, max {s_b[2]}, hit-mask flips {f_b} "
                     f"(limits {FMA_MXU_SHARE}, {FMA_MXU_BIG_SHARE})")
        print(line, flush=True)
        if not ok:
            raise AssertionError(f"K1-mxu is outside its budget at {tag}")

    for opaque in (True, False):
        z_clip = not opaque
        kw = dict(opaque=opaque, z_clip=z_clip)
        base = k1(*stacked(PROD, opaque, z_clip)[1], **kw)
        one, four = stacked(PROD, opaque, z_clip, mxu=1)
        mxu_preps[opaque] = (one, four)
        bgp = four[4]
        tag = f"video opaque={opaque} z_clip={z_clip}"
        wants = {}
        for mxu in (1, 2):
            got4 = mxu_k(*four, mxu=mxu, **kw)
            got1 = mxu_k(*one[0], mxu=mxu, **kw)
            want4 = wants[mxu] = tr.raster_tiles_flat_u8_mxu_reference(
                *four, mxu=mxu, **kw)
            torch.cuda.synchronize()
            mxu_check(f"{tag}, 4 frames in one launch", got4, want4, bgp,
                      mxu, base if mxu == 1 else None)
            mxu_check(f"{tag}, camera 0 alone", got1, want4[0], bgp, mxu)
            # the split walk claiming 8 items at a time: the same walk
            bad_wf = same_bits(wf_k(*four, wf=8, mxu=mxu, **kw), got4)
            print(f"[k1-mxu vs plain] K1-wf (wf=8) with mxu={mxu}, 4 frames "
                  f"in one launch: {bad_wf} packed pixels differ from "
                  f"K1-mxu's launch", flush=True)
            if bad_wf:
                raise AssertionError("K1-wf's mxu walk differs from K1-mxu")
        c = u8_shares(wants[2], wants[1])
        print(f"[k1-mxu vs plain] control, {tag}, 4 frames: the plain "
              f"version at mxu=2 (one bf16 pass) against mxu=1: {c[0]} of "
              f"the pixels differ, {c[1]} by more than 1 level, max |delta| "
              f"{c[2]}, hit-mask flips {flips(wants[2], wants[1], bgp)}",
              flush=True)
    mxu_preps["defaults"] = stacked(gdef, False, True, mxu=1)
    mxu_preps["video"] = mxu_preps[True]
    one, four = mxu_preps["defaults"]
    kw = dict(opaque=False, z_clip=True)
    want4 = tr.raster_tiles_flat_u8_mxu_reference(*four, mxu=1, **kw)
    base = k1(*wf_preps["defaults"][1], **kw)
    mxu_check("defaults (128x16), 4 frames in one launch",
              mxu_k(*four, mxu=1, **kw), want4, four[4], 1, base)
    mxu_check("defaults (128x16), camera 0 alone", mxu_k(*one[0], mxu=1, **kw),
              want4[0], four[4], 1)

    # K3's matrix-unit walk on bench.py's textured mesh_10k
    t_verts, t_faces, t_uvs, t_tex = textured_scene()
    tv, tf, tu, tt = interop.textured_mesh_to_torch(t_verts, t_faces, t_uvs,
                                                    t_tex, dev)
    v4f, fuv = raster3d.pregather_mesh(tv, tf), tu[tf]
    tex_packed = raster3d.pack_texture_u8(tt)
    tex_dims = tuple(tt.shape[:2])
    # a background no texel of the texture is: sky is exact
    bgp = tr.pack_bg(torch.tensor([0.5, 0.25, 0.75, 0.0], device=dev))
    if bool((tex_packed == bgp).any()):
        raise AssertionError("the background is a texel")

    def tex_check(tag, got, want, label):
        """The share of the same texel and of hit-mask flips against
        ``want``: its plain version (TEX_SAME_SHARE, MXU_BIG_SHARE) or K3
        (JAX's budget), printed and held."""
        n = got.numel()
        same = float((got == want).float().mean())
        hit_share = flips(got, want, bgp)
        if label.startswith("its"):
            errs["K3-mxu"] = max(errs["K3-mxu"], u8_shares(got, want)[2])
            shares.append(1.0 - same)
            ok = (within(1.0 - same, MXU_BIG_SHARE, n)
                  and within(hit_share, MXU_BIG_SHARE, n))
        else:
            ok = (same >= FMA_TEX_SAME_SHARE
                  and hit_share <= FMA_MXU_BIG_SHARE)
        print(f"[k3-mxu vs plain] {tag}: against {label} {same} of the "
              f"pixels the same texel, hit-mask flips {hit_share}",
              flush=True)
        if not ok:
            raise AssertionError(f"K3's mxu walk is outside its budget "
                                 f"against {label} at {tag}")

    tcfg = defaults(raster3d.render_textured_u8_batch)
    tex_preps = {}
    for persp in (True, False):
        def tprep(mxu):
            ps = [raster3d.prepare_textured_frame(
                tv, tf, fuv, WIDTH, HEIGHT, mvp, perspective_correct=persp,
                z_clip=True, v4f=v4f, mxu=mxu, **tcfg) for mvp in mvps]
            if any(bool(p["overflow"]) for p in ps):
                raise AssertionError("a textured prep overflows")
            return tuple(torch.stack([p[k] for p in ps]) for k in
                         ("sorted_pad", "starts", "counts", "table"))
        walk, walk0 = tprep(1), tprep(0)
        tex_preps[persp] = (walk, walk0)
        targs = (tex_packed, tex_dims, bgp, WIDTH, tcfg["tile_w"],
                 tcfg["tile_h"])
        got = tex_k(*walk, *targs, z_clip=True, mxu=1)
        got0 = tex_k(*(x[0] for x in walk), *targs, z_clip=True, mxu=1)
        want = tr.raster_tiles_tex_u8_mxu_reference(*walk, *targs,
                                                    z_clip=True, mxu=1)
        k3 = tr.raster_tiles_tex_u8(*walk0, *targs, z_clip=True)
        torch.cuda.synchronize()
        tag = (f"{'perspective' if persp else 'affine'} ({tcfg})")
        tex_check(f"{tag}, 4 frames in one launch", got, want,
                  "its plain version")
        tex_check(f"{tag}, camera 0 alone", got0, want[0],
                  "its plain version")
        tex_check(f"{tag}, 4 frames in one launch", got, k3,
                  "K3 (the FMA walk)")
        want2 = tr.raster_tiles_tex_u8_mxu_reference(*walk, *targs,
                                                     z_clip=True, mxu=2)
        print(f"[k3-mxu vs plain] control, {tag}, 4 frames: the plain "
              f"version at mxu=2 (one bf16 pass) against mxu=1: "
              f"{float((want2 == want).float().mean())} of the pixels the "
              f"same texel, hit-mask flips {flips(want2, want, bgp)}",
              flush=True)

    # the boundary runs through the MMA walk (affine tables of the same
    # crafted runs): K1-mxu and K3's mxu walk against their plain versions,
    # K1-wf (wf 8) with mxu bit-equal to K1-mxu
    for label, args in split_cases(dev, bgp0, mxu=True):
        for opaque, z_clip in ((True, False), (False, True)):
            kw = dict(opaque=opaque, z_clip=z_clip)
            got = mxu_k(*args, mxu=1, **kw)
            want = tr.raster_tiles_flat_u8_mxu_reference(*args, mxu=1, **kw)
            mxu_check(f"{label}, opaque={opaque} z_clip={z_clip}", got,
                      want, args[4], 1)
            bad_wf = same_bits(wf_k(*args, wf=8, mxu=1, **kw), got)
            if bad_wf:
                raise AssertionError(f"K1-wf's mxu walk differs from "
                                     f"K1-mxu at {label}")
        targs = (tex_packed, tex_dims, bgp, args[5], 32, 32)
        tex_check(f"{label}", tex_k(*args[:4], *targs, z_clip=True, mxu=1),
                  tr.raster_tiles_tex_u8_mxu_reference(
                      *args[:4], *targs, z_clip=True, mxu=1),
                  "its plain version")
    print(f"[k1-mxu vs plain] shares of pixels off the plain version over "
          f"every check above: max {max(shares)}, mean "
          f"{float(np.mean(shares))}", flush=True)

    # the entries, each kernel's launches counted from zero just before
    def run_counted(fn):
        for k in counted:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k.__name__: k.launches for k in counted}

    cpu = interop.mesh_to_torch(verts_np, faces_np, colors_np, "cpu")
    main = {}
    for label, kw, kern in (("wf=8", dict(wf=8), wf_k),
                            ("mxu=1", dict(mxu=1), mxu_k)):
        frames, n = run_counted(lambda: [raster3d.render_gouraud_pallas(
            verts, faces, colors, WIDTH, HEIGHT, mvp, flat=True, u8=True,
            **kw) for mvp in mvps])
        main[kern.__name__] = n[kern.__name__]
        want = {k.__name__: len(cams) * (k is kern) for k in counted}
        t0 = time.perf_counter()
        ref, _, ovf_c = raster3d.render_gouraud_pallas(
            *cpu, WIDTH, HEIGHT, mvps[0].cpu(), flat=True, u8=True, **kw)
        cpu_s = time.perf_counter() - t0
        got = frames[0][0].cpu()
        d = (got.int() - ref.int()).abs().amax(-1)
        share, big = float((d > 0).float().mean()), float((d > 1).float()
                                                          .mean())
        ovf = any(bool(o) for _, _, o in frames) or bool(ovf_c)
        print(f"[wf/mxu main path] render_gouraud_pallas(flat, u8, {label}) "
              f"at its defaults on {len(cams)} frames: launches {n}; frame 0 "
              f"card vs CPU ({cpu_s:.1f} s): {share} of the pixels differ, "
              f"{big} by more than 1 level; overflow {ovf}", flush=True)
        if n != want or ovf or (kern is wf_k and share) or not (
                within(share, MXU_SHARE, d.numel())
                and within(big, MXU_BIG_SHARE, d.numel())):
            raise AssertionError(f"render_gouraud_pallas {label} is wrong")
    u8_kw = dict(flat=True, u8=True, opaque=True, z_clip=False, **PROD)
    (fb, _, ovf), n = run_counted(lambda: raster3d.render_gouraud_pallas_batch(
        verts, faces, colors, WIDTH, HEIGHT, mvps, mxu=1, **u8_kw))
    main["raster_tiles_flat_u8_mxu"] += n["raster_tiles_flat_u8_mxu"]
    one_f = torch.stack([raster3d.render_gouraud_pallas(
        verts, faces, colors, WIDTH, HEIGHT, mvp, mxu=1, **u8_kw)[0]
        for mvp in mvps])
    d_b = int((fb != one_f).any(-1).sum())
    print(f"[wf/mxu main path] render_gouraud_pallas_batch(flat, u8, mxu=1) "
          f"over {len(cams)} frames: launches {n}; {d_b} pixels differ from "
          f"render_gouraud_pallas frame by frame; overflow {bool(ovf)}",
          flush=True)
    if n["raster_tiles_flat_u8_mxu"] != 1 or d_b or bool(ovf):
        raise AssertionError("the mxu batch route is wrong")
    (tfb, tovf), n = run_counted(lambda: raster3d.render_textured_u8_batch(
        tv, tf, tu, tt, WIDTH, HEIGHT, mvps, mxu=1))
    main["raster_tiles_tex_u8_mxu"] = n["raster_tiles_tex_u8_mxu"]
    t0 = time.perf_counter()
    tcpu = interop.textured_mesh_to_torch(t_verts, t_faces, t_uvs, t_tex,
                                          "cpu")
    tref, _ = raster3d.render_textured_u8_batch(*tcpu, WIDTH, HEIGHT,
                                                mvps[:1].cpu(), mxu=1)
    cpu_s = time.perf_counter() - t0
    same = float((tfb[0].cpu() == tref[0]).all(-1).float().mean())
    print(f"[wf/mxu main path] render_textured_u8_batch(mxu=1) at its "
          f"defaults {tcfg} over {len(cams)} frames: launches {n}; frame 0 "
          f"card vs CPU ({cpu_s:.1f} s): {same} of the pixels the same; "
          f"overflow {bool(tovf)}", flush=True)
    if n["raster_tiles_tex_u8_mxu"] != 1 or bool(tovf) or not within(
            1.0 - same, MXU_BIG_SHARE, HEIGHT * WIDTH):
        raise AssertionError("render_textured_u8_batch(mxu=1) is wrong")
    for k, s in zip(counted, saved):
        k.launches = s
    rows = {"K1-wf": (739, "raster_tiles_flat_u8_wf"),
            "K1-mxu": (285, "raster_tiles_flat_u8_mxu"),
            "K3-mxu": (895, "raster_tiles_tex_u8_mxu")}

    # 17. times, ms a frame, mean of the 4 cameras.  In turns, the calls
    # queued behind a sleep (device time alone): K1-wf (wf 1, 8, NT) and
    # K1-mxu (mxu 1, 2) beside K1's split walk on the same frames, one
    # frame a launch and the 4 frames in one launch, at the video shape
    # (32x32, opaque, no z test) and at the entries' defaults (128x16);
    # K3's mxu walk beside K3 at render_textured_u8_batch's defaults.
    # The kernel table's times are cuda_ms without the sleep, the timer of
    # every earlier run.
    n4 = len(cams)
    t, turns, bounds, plain = {}, {}, {}, {}
    for label, (cfg, opaque, z_clip) in wf_cases.items():
        one, four = wf_preps[label]
        mone, mfour = mxu_preps[label]
        kw = dict(opaque=opaque, z_clip=z_clip)
        nt = int(four[2].shape[-1])
        fns = {"K1": lambda: [k1(*a, **kw) for a in one],
               "K1 batch": lambda: k1(*four, **kw)}
        for wf in (1, 8, nt):
            fns[f"K1-wf {wf}"] = (lambda wf=wf: [wf_k(*a, wf=wf, **kw)
                                                 for a in one])
            fns[f"K1-wf {wf} batch"] = lambda wf=wf: wf_k(*four, wf=wf, **kw)
        for mxu in (1, 2):
            fns[f"K1-mxu {mxu}"] = (lambda mxu=mxu: [mxu_k(*a, mxu=mxu, **kw)
                                                     for a in mone])
            fns[f"K1-mxu {mxu} batch"] = (lambda mxu=mxu: mxu_k(
                *mfour, mxu=mxu, **kw))
        tl = {k: [v / n4 for v in vs] for k, vs in in_turns(fns).items()}
        turns[label] = tl
        t[label] = {"K1-wf 8": cuda_ms(fns["K1-wf 8"], 10) / n4,
                    "K1-mxu 1": cuda_ms(fns["K1-mxu 1"], 10) / n4}
        plain[("K1-wf", label)] = cuda_ms(
            lambda: tr.raster_tiles_flat_u8_reference(*four, **kw), 2) / n4
        plain[("K1-mxu", label)] = cuda_ms(
            lambda: tr.raster_tiles_flat_u8_mxu_reference(*mfour, mxu=1,
                                                          **kw), 2) / n4
        bounds[("K1-wf", label)] = walk_bound(one, U8_EPI_OPS, 4, tile=cfg)
        bounds[("K1-mxu", label)] = mma_bound(mone, cfg, MXU_U8_EPI_OPS, 4)
        print(f"[wf/mxu times] {card}: ms/frame at {WIDTH}x{HEIGHT} "
              f"mesh_10k, {label} ({cfg}, opaque={opaque}, z_clip={z_clip}; "
              f"in turns, CUDA events, calls queued behind a sleep, mean of "
              f"{n4} cameras; 'batch' = the 4 frames in one launch; NT = "
              f"{nt}): " + "; ".join(f"{k} {v}" for k, v in tl.items())
              + f"; the kernel table's timer (not queued): {t[label]}; "
              f"{occupancy(_kernels, False, cfg['tile_w'], cfg['tile_h'], z_clip)}",
              flush=True)
        for name, keys in (("K1-wf", [f"K1-wf {wf}" for wf in (1, 8, nt)]),
                           ("K1-mxu", ["K1-mxu 1", "K1-mxu 2"])):
            b = bounds[(name, label)]
            ops = (f"operations {b[3]} ms, walk + {U8_EPI_OPS} ops a slot"
                   if name == "K1-wf" else
                   f"tensor cores {b[3]} ms at {PEAK_BF16_S:.3g} bf16 op/s, "
                   f"CUDA cores {b[4]} ms at "
                   f"{PEAK_OPS_S[torch.float32]:.3g} op/s")
            at = "; ".join(
                f"{k} at {b[0] / min(tl[k]):.4f} one frame a launch, "
                f"{b[0] / min(tl[k + ' batch']):.4f} batched (K1 "
                f"{min(tl['K1']) / min(tl[k]):.3f}x, batched "
                f"{min(tl['K1 batch']) / min(tl[k + ' batch']):.3f}x its "
                f"speed)" for k in keys)
            print(f"[wf/mxu times] {name} {label}: plain version "
                  f"{plain[(name, label)]} ms/frame; bound {b[0]} ms/frame by "
                  f"{b[1]} (bytes {b[2]} ms, {ops}; pairs {b[-1]}); {at}",
                  flush=True)
    twalk, twalk0 = tex_preps[True]
    targs = (tex_packed, tex_dims, bgp, WIDTH, tcfg["tile_w"], tcfg["tile_h"])
    t1, t10 = ([tuple(x[i] for x in w) for i in range(n4)]
               for w in (twalk, twalk0))
    fns = {"K3-mxu": lambda: [tex_k(*w, *targs, z_clip=True, mxu=1)
                              for w in t1],
           "K3": lambda: [tr.raster_tiles_tex_u8(*w, *targs, z_clip=True)
                          for w in t10],
           "K3-mxu batch": lambda: tex_k(*twalk, *targs, z_clip=True, mxu=1),
           "K3 batch": lambda: tr.raster_tiles_tex_u8(*twalk0, *targs,
                                                      z_clip=True)}
    tl = {k: [v / n4 for v in vs] for k, vs in in_turns(fns).items()}
    turns["tex"] = tl
    t["K3-mxu"] = cuda_ms(fns["K3-mxu batch"], 10) / n4
    plain[("K3-mxu", "tex")] = cuda_ms(
        lambda: tr.raster_tiles_tex_u8_mxu_reference(*twalk, *targs,
                                                     z_clip=True, mxu=1),
        2) / n4
    b = bounds[("K3-mxu", "tex")] = mma_bound(
        t1, tcfg, MXU_TEX_EPI_OPS, 4, 4 * tex_packed.numel())
    print(f"[wf/mxu times] {card}: K3's mxu walk beside K3 (the FMA split "
          f"walk, same frames), ms/frame in turns ({tcfg}, "
          f"perspective-correct; calls queued behind a sleep; 'batch' = the "
          f"4 frames in one launch): "
          + "; ".join(f"{k} {v}" for k, v in tl.items())
          + f"; the kernel table's timer (not queued, batched) {t['K3-mxu']};"
          f" plain version {plain[('K3-mxu', 'tex')]} ms/frame; bound {b[0]} "
          f"ms/frame by {b[1]} (bytes {b[2]} ms, tensor cores {b[3]} ms, "
          f"CUDA cores {b[4]} ms; pairs {b[5]}); K3-mxu at "
          f"{b[0] / min(tl['K3-mxu']):.4f} of it one frame a launch, "
          f"{b[0] / min(tl['K3-mxu batch']):.4f} batched; "
          f"{occupancy(_kernels, True, tcfg['tile_w'], tcfg['tile_h'], True)}",
          flush=True)
    for k, s in zip(counted, saved):
        k.launches = s
    src = "libnativecpurenderer_tpu_torch/csrc/tile_raster.cu"
    tpu = "libnativecpurenderer_tpu/ops/pallas_raster.py"
    # the main path's shapes: render_gouraud_pallas's defaults, one frame
    # a launch; K3-mxu the batch entry's 4 frames in one launch
    key = {"K1-wf": ("defaults", "K1-wf 8"),
           "K1-mxu": ("defaults", "K1-mxu 1"), "K3-mxu": ("tex", None)}
    out = []
    for name, (line, fn) in rows.items():
        label, tk = key[name]
        out.append({"name": fn, "route": "cuda", "source": src,
                    "replaces": f"{tpu}:{line}", "launches": main[fn],
                    "max_abs_err": errs[name],
                    "ms": t[label][tk] if tk else t["K3-mxu"],
                    "plain_ms": plain[(name, label)],
                    "bound_ms": bounds[(name, label)][0],
                    "bound_by": bounds[(name, label)][1],
                    "library_ms": None})
    return out


def bench_draw(ctx, texs, t):
    """bench.py:488-508's draw(t): the ~60-command canvas frame at
    1920x1080 (a dim full-frame fill, a gradient, 8 lines, 30 split blits,
    12 plain blits, 8 rects)."""
    W, H = WIDTH, HEIGHT
    ctx.fill_color(0.05, 0.05, 0.08, 0.25)
    ctx.draw_vertical_grd(0, H - 200, W, 200, 0, 0, 0, 0, 0, 0, 0, 0.8)
    r2 = np.random.default_rng(42)
    for i in range(8):
        x = float(r2.uniform(100, W - 100) + 30 * math.sin(t + i))
        y = float(r2.uniform(100, H - 100))
        ctx.draw_line(x, y, x + 90, y + 40, 6.0, 0.9, 0.9, 1.0, 0.8)
    for i in range(30):
        x = float(r2.uniform(0, W - 140) + 40 * math.sin(t * 2 + i))
        y = float(r2.uniform(0, H - 140))
        ctx.draw_splitted_texture(texs[i % 4], x, y, 100.0, 50.0,
                                  0.1, 0.9, 0.0, 1.0)
    for i in range(12):
        ctx.draw_texture(texs[i % 4], float(r2.uniform(0, W - 120)),
                         float(r2.uniform(0, H - 120)), 80.0, 80.0)
    for i in range(8):
        ctx.draw_rect(float(r2.uniform(0, W - 60)),
                      float(r2.uniform(0, H - 60)),
                      40.0, 24.0, 0.2, 0.8, 0.4, 0.7)


def frame64(ctx, seed: int):
    """A seeded frame of 60 drawn arithmetic commands, mostly full-frame
    or large, each under its own rotation, scale, translation and colour
    transform; 4 NOOP rows are inserted into the returned list.  Returns
    host (kinds int32, params float64), 64 rows."""
    rng = np.random.default_rng(seed)
    W, H = WIDTH, HEIGHT
    ctx.set_color(*rng.uniform(0, 1, 4))
    for i in range(59):
        ctx.save_state()
        ctx.translate(*rng.uniform(0, [W, H]))
        ctx.rotate(rng.uniform(-math.pi, math.pi))
        ctx.scale(*rng.uniform(0.6, 1.6, 2))
        ctx.set_color_transform(*rng.uniform(0.5, 1.2, 4))
        col = rng.uniform(0, 1, 4)
        kind = i % 7
        if kind == 0:
            ctx.fill_color(*rng.uniform(0, 1, 3), rng.uniform(0.05, 0.4))
        elif kind == 1:
            w, h = rng.uniform([800, 500], [1800, 1000])
            ctx.draw_rect(-w / 2, -h / 2, w, h, *col)
        elif kind == 2:
            ctx.draw_circle(0.0, 0.0, rng.uniform(300, 700), *col)
        elif kind == 3:
            ctx.draw_line(-1100.0, rng.uniform(-200, 200), 1100.0,
                          rng.uniform(-200, 200), rng.uniform(50, 300), *col)
        elif kind == 4:
            ctx.draw_vertical_grd(-W, -H, 2 * W, 2 * H, *col,
                                  *rng.uniform(0, 1, 4))
        elif kind == 5:
            ctx.set_pixel(int(rng.integers(0, W)), int(rng.integers(0, H)),
                          *col)
        else:
            ctx.apply_pixel(int(rng.integers(0, W)),
                            int(rng.integers(0, H)), *col)
        ctx.restore_state()
    kinds, params = (np.array(a) for a in ctx._cmds.snapshot())
    ctx._cmds.clear()
    at = np.sort(rng.choice(np.arange(1, 61), 4, replace=False))
    kinds = np.insert(kinds, at, 0).astype(np.int32)
    params = np.insert(params, at, 0.0, axis=0)
    return kinds, params


def rotated_blits(ctx, texs):
    """The blits bench_draw leaves out: 12 draw_texture and 12 split
    blits, each under a seeded rotation and scale, over a dim fill."""
    rng = np.random.default_rng(11)
    ctx.fill_color(0.1, 0.1, 0.15, 1.0)
    for i in range(12):
        ctx.save_state()
        ctx.translate(*rng.uniform([150, 150], [WIDTH - 150, HEIGHT - 150]))
        ctx.rotate(rng.uniform(-math.pi, math.pi))
        ctx.scale(*rng.uniform(0.6, 2.0, 2))
        ctx.set_color_transform(*rng.uniform(0.5, 1.0, 4))
        ctx.draw_texture(texs[i % 4], -64.0, -64.0, 128.0, 128.0)
        ctx.draw_splitted_texture(texs[(i + 1) % 4], -70.0, -35.0, 140.0,
                                  70.0, 0.1, 0.9, 0.2, 0.8)
        ctx.restore_state()


def hit_effects(ctx, group):
    """24 hit effects of one group of Helpers' dissolve textures, drawn as
    apps/milrenderer.py:725-740 draws them: progress p picks the texture
    and sets the size; a third at the identity transform (the fast path),
    the rest under a note's translation and rotation."""
    rng = np.random.default_rng(12)
    ctx.fill_color(0.1, 0.1, 0.15, 1.0)
    for i in range(24):
        p = (i + 0.5) / 24
        size = (WIDTH + HEIGHT) * 0.12 * (1.0 - (1.0 - p) ** 3)
        tex = group[int(p * (len(group) - 1))]
        x, y = rng.uniform([size, size], [WIDTH - size, HEIGHT - size])
        ctx.save_state()
        if i % 3 == 0:
            ctx.draw_texture(tex, x - size / 2, y - size / 2, size, size)
        else:
            ctx.translate(x, y)
            ctx.rotate(rng.uniform(-math.pi, math.pi))
            ctx.draw_texture(tex, -size / 2, -size / 2, size, size)
        ctx.restore_state()


def blit_phase(dev) -> None:
    """Phase 9: rotated blits and hit effects, the card's u8 frame against
    the CPU's, in float32 and float64; then the cause of the float32 hit
    effects' flips (HIT_FLIP_SHARE)."""
    import random

    from libnativecpurenderer_tpu_torch import Helpers, RenderContext, \
        Texture
    from libnativecpurenderer_tpu_torch.ops import commands as C
    from libnativecpurenderer_tpu_torch.ops import noise
    from libnativecpurenderer_tpu_torch.ops.executor import sample_window

    rng = np.random.default_rng(5)
    texs = [Texture._from_array(rng.random((128, 128, 4)), True)
            for _ in range(4)]
    # a 512x512 ring mask, as milrenderer's resampled perfect_circ.png
    yy, xx = np.mgrid[0:512, 0:512] / 511.0 - 0.5
    ring = np.clip(1.0 - np.abs(np.hypot(xx, yy) - 0.35) * 8.0, 0.0, 1.0)
    mask = Texture._from_array(
        np.stack([np.ones_like(ring)] * 3 + [ring], -1), True)
    random.seed(3)
    group = Helpers.create_milthm_hit_effect_textures(mask, 30)

    for dtype in (torch.float32, torch.float64):
        for name, draw, arg in (("rotated blits", rotated_blits, texs),
                                ("hit effects", hit_effects, group)):
            u8 = []
            for d in (dev, "cpu"):
                ctx = RenderContext(WIDTH, HEIGHT, True, dtype, device=d)
                draw(ctx, arg)
                kinds, params = ctx._cmds.snapshot()
                u8.append(ctx.uint8_buffer())
            # the pixels the hit effects' windows hold (as a flush cuts them)
            inside = np.zeros((HEIGHT, WIDTH), bool)
            boxes = params[:, 6:10].astype(str(dtype)[6:])
            for k, box in zip(kinds.tolist(), boxes):
                win = sample_window(box, WIDTH, HEIGHT)
                if k == C.KIND_HITEFFECT and win is not None:
                    inside[win[2]:win[3], win[0]:win[1]] = True
            px = (u8[0] != u8[1]).any(-1)
            drawn = float((u8[1] != u8[1][0, 0]).any(-1).mean())
            allowed = (int(HIT_FLIP_SHARE * inside.sum())
                       if dtype == torch.float32 and inside.any() else 0)
            print(f"[blits card vs cpu] {name} {str(dtype)[6:]} "
                  f"{WIDTH}x{HEIGHT}: {int(px.sum())} pixels differ "
                  f"({int(px[~inside].sum())} outside the "
                  f"{int(inside.sum())} pixels of hit effect "
                  f"windows; allowed {allowed} inside), max u8 |delta| "
                  f"{int(np.abs(u8[0].astype(int) - u8[1]).max())}; "
                  f"{drawn:.3f} of the frame drawn", flush=True)
            if px[~inside].any() or px.sum() > allowed:
                raise AssertionError(f"{name}: card frame differs from the "
                                     f"CPU port")
            if drawn < 0.05:
                raise AssertionError(f"{name}: the frame is mostly empty")

    # the cause: torch.sin on the card and on the CPU, and the dissolve
    gen = torch.Generator().manual_seed(4)
    for dtype in (torch.float32, torch.float64):
        x = (torch.rand(1 << 20, generator=gen, dtype=torch.float64)
             * 4e4).to(dtype)
        s = torch.sin(x.to(dev)).cpu()
        sd = int((s != torch.sin(x)).sum())
        uv = torch.rand((2, 512, 512), generator=gen,
                        dtype=torch.float64).to(dtype)
        flips = []
        for tex in group[5::6]:
            a_cpu = noise.hit_effect_alpha(uv[0], uv[1], tex.seed, tex.t)
            a_dev = noise.hit_effect_alpha(uv[0].to(dev), uv[1].to(dev),
                                           tex.seed, tex.t).cpu()
            flips.append(int((a_cpu != a_dev).sum()))
        print(f"[blits card vs cpu] {str(dtype)[6:]}: torch.sin differs "
              f"on {sd} of {x.numel()} arguments in [0, 4e4); "
              f"hit_effect_alpha differs on {flips} of {512 * 512} seeded "
              f"uv for t = {[tex.t for tex in group[5::6]]}", flush=True)


def border_pixels(ctx, w: int, h: int):
    """SET_PIXEL and APPLY_PIXEL on both sides of 32x32 tile borders, at
    the frame's edges and just off it, and a rect with a fractional box
    across a tile border: a sparse run of tiles on their own."""
    for x in (31, 32, 63, 64, w // 2 - 1, w // 2, w - 1, w):
        for y in (0, 31, 32, h - 1):
            ctx.set_pixel(x, y, 0.9, 0.2, 0.1, 0.7)
            ctx.apply_pixel(x, min(y + 1, h), 0.1, 0.7, 0.3, 0.4)
    ctx.draw_rect(95.5, 62.25, 1.0, 3.5, 0.3, 0.3, 0.9, 0.8)


def texture_mix(ctx, texs, seed: int):
    """A seeded run of 48 texture blits among lines and rects at
    1920x1080: fast blits at the identity (partly off the frame too),
    plain and split blits under rotations, scales, translations and
    colour transforms; then 3 blits whose texel index leaves the atlas
    (a region origin below it: NaN texels; above it: a negative index,
    counted from the end; 2^32 / AW rows down: int32 wraparound back into
    the atlas).  Returns host (kinds int32, params float64) and the rows
    of the 3 crafted blits."""
    rng = np.random.default_rng(seed)
    W, H = WIDTH, HEIGHT
    for i in range(72):
        op = i % 6
        tex = texs[int(rng.integers(len(texs)))]
        w, h = rng.uniform([20, 20], [400, 300])
        x, y = rng.uniform([-w / 2, -h / 2], [W - w / 2, H - h / 2])
        if op == 0:
            ctx.draw_texture(tex, x, y, w, h)
        elif op == 1:
            ctx.draw_line(x, y, *rng.uniform([0, 0], [W, H]),
                          rng.uniform(1, 12), *rng.uniform(0, 1, 4))
        elif op == 2:
            ctx.draw_rect(x, y, w, h, *rng.uniform(0, 1, 4))
        else:
            ctx.save_state()
            ctx.translate(x, y)
            ctx.rotate(rng.uniform(-math.pi, math.pi))
            ctx.scale(*rng.uniform(0.4, 2.5, 2))
            ctx.set_color_transform(*rng.uniform(0.5, 1.2, 4))
            if op == 3:
                ctx.draw_texture(tex, -w / 2, -h / 2, w, h)
            else:
                ctx.draw_splitted_texture(tex, -w / 2, -h / 2, w, h,
                                          *np.sort(rng.uniform(0, 1, 2)),
                                          *np.sort(rng.uniform(0, 1, 2)))
            ctx.restore_state()
    n0 = ctx._cmds.n
    ah, aw = ctx._store.atlas.shape[:2]
    ctx.draw_texture(texs[0], 300.0, 200.0, 160.0, 120.0)
    ctx.rotate(0.3)
    ctx.draw_texture(texs[1], 900.0, 300.0, 200.0, 140.0)
    ctx.draw_splitted_texture(texs[2], 500.0, 600.0, 240.0, 90.0,
                              0.2, 0.8, 0.0, 1.0)
    ctx.set_transform(1, 0, 0, 1, 0, 0)
    q = ctx._cmds.params
    q[n0, 21] = ah + 3
    q[n0 + 1, 21] = -ah
    if 2 ** 32 % aw:
        raise AssertionError(f"atlas width {aw} does not divide 2^32")
    q[n0 + 2, 21] = 2 ** 32 // aw
    kinds, params = (np.array(a) for a in ctx._cmds.snapshot())
    ctx._cmds.clear()
    return kinds, params, (n0, n0 + 1, n0 + 2)


def chart_frames(ctx, every: int):
    """Every ``every``-th recorded frame of the benchmark's chart traffic
    (``bench_torch/traffic/milthm_chart.jsonl``), recorded on ``ctx``
    over the mix's textures (texels seeded); {frame: (kinds, params)}."""
    from bench_torch.harness import traffic
    from libnativecpurenderer_tpu_torch import Texture
    mix = traffic.load("milthm_chart")
    rng = np.random.default_rng(17)
    texs = {}
    for name, t in sorted(mix["textures"].items()):
        arr = rng.random((t["height"], t["width"], 4))
        texs[name] = Texture._from_array(arr, t["alpha"])
    out = {}
    for i in range(0, len(mix["lines"]), every):
        for name, *args in mix["lines"][i]:
            getattr(ctx, name)(*[texs[a] if isinstance(a, str) else a
                                 for a in args])
        out[i] = tuple(np.array(a) for a in ctx._cmds.snapshot())
        ctx._cmds.clear()
    return out


def k4_bound(kinds, p, dtype):
    """(bound ms, 'bytes'|'operations', bytes ms, operations ms) of one K4
    run at 1920x1080 from its host params p (in the frame's type): the
    tiles some command may touch (the kernel's test) read and written
    once plus the commands, and for each texture blit the texels of its
    region or of its box's pixels, whichever is fewer, read once;
    K4_OPS_PER_PIXEL operations per pixel of each command's box clamped
    to the frame (FILL: every pixel)."""
    from libnativecpurenderer_tpu_torch.ops import canvas_kernel
    from libnativecpurenderer_tpu_torch.ops import commands as C
    from libnativecpurenderer_tpu_torch.ops.executor import sample_window
    W, H, T = WIDTH, HEIGHT, canvas_kernel.TILE
    touched = np.zeros((-(-H // T), -(-W // T)), bool)
    pixels = texels = 0
    for k, q in zip(kinds.tolist(), p):
        hit = canvas_kernel.tiles_touched(k, q, W, H)
        touched |= hit
        if k == C.KIND_FILL:
            pixels += W * H
        elif k in (C.KIND_SET_PIXEL, C.KIND_APPLY_PIXEL):
            pixels += int(hit.any())
        elif k != C.KIND_NOOP:
            win = sample_window(q[6:10], W, H)
            if win is not None:
                box = (win[1] - win[0]) * (win[3] - win[2])
                pixels += box
                if k in canvas_kernel.TEXTURE_KINDS:
                    texels += min(box, int(q[22]) * int(q[23]))
    tw = np.minimum(W - np.arange(0, W, T), T)[None, :]
    th = np.minimum(H - np.arange(0, H, T), T)[:, None]
    px_touched = int((touched * (tw * th)).sum())
    item = p.dtype.itemsize
    nbytes = ((2 * px_touched + texels) * 4 * item
              + len(kinds) * (32 * item + 4))
    bytes_ms = 1e3 * nbytes / MEM_BYTES_S
    ops_ms = 1e3 * pixels * K4_OPS_PER_PIXEL / PEAK_OPS_S[dtype]
    if bytes_ms >= ops_ms:
        return bytes_ms, "bytes", bytes_ms, ops_ms
    return ops_ms, "operations", bytes_ms, ops_ms


def canvas_phases(dev, card: str) -> dict:
    """Phases 6-8: K4 against its plain version, the canvas main path and
    its times; returns K4's entry of the kernel table."""
    from libnativecpurenderer_tpu_torch import RenderContext, Texture
    from libnativecpurenderer_tpu_torch.ops import _kernels, canvas_kernel

    rng = np.random.default_rng(0)
    texs = [Texture._from_array(rng.random((128, 128, 4)), True)
            for _ in range(4)]

    # 6. K4 against its plain version on the card, each dtype's runs
    # recorded on a context of that dtype (the blits' regions are in its
    # atlas)
    def record_runs(dtype):
        rec = RenderContext(WIDTH, HEIGHT, True, dtype, device=dev)
        bench_draw(rec, texs, 0.0)
        bk, bp = (np.array(a) for a in rec._cmds.snapshot())
        rec._cmds.clear()
        if canvas_kernel.kernel_runs(bk.tolist()) != [(0, len(bk))]:
            raise AssertionError("bench frame is not one K4 run")
        runs = {f"bench frame ({len(bk)} cmds)": (bk, bp)}
        k64, p64 = frame64(rec, 7)
        if len(k64) != 64 or set(k64.tolist()) != canvas_kernel.ARITH_KINDS:
            raise AssertionError("the 64-command frame misses a kind")
        runs["64-cmd frame"] = (k64, p64)
        tk, tp, off = texture_mix(rec, texs, 13)
        if (canvas_kernel.kernel_runs(tk.tolist()) != [(0, len(tk))]
                or not canvas_kernel.TEXTURE_KINDS <= set(tk.tolist())):
            raise AssertionError("the texture mix is not one K4 run of "
                                 "every texture kind")
        runs[f"texture mix ({off[0]} cmds)"] = (tk[:off[0]], tp[:off[0]])
        runs["texture mix off the atlas"] = (tk[off[0]:], tp[off[0]:])
        border_pixels(rec, WIDTH, HEIGHT)
        runs["tile-border pixels"] = tuple(np.array(a)
                                           for a in rec._cmds.snapshot())
        rec._cmds.clear()
        for i, (ck, cp) in chart_frames(rec, CHART_EVERY).items():
            if (canvas_kernel.kernel_runs(ck.tolist()) != [(0, len(ck))]
                    or not set(ck.tolist()) & canvas_kernel.TEXTURE_KINDS):
                raise AssertionError(f"chart frame {i} is not one K4 run "
                                     f"of blits")
            runs[f"chart frame {i} ({len(ck)} cmds)"] = (ck, cp)
        small = RenderContext(*SMALL_FRAME, True, dtype, device=dev)
        small_runs = {f"64-cmd frame {SMALL_FRAME[0]}x{SMALL_FRAME[1]}":
                      frame64(small, 9)}
        border_pixels(small, *SMALL_FRAME)
        small_runs[f"tile-border pixels {SMALL_FRAME[0]}x"
                   f"{SMALL_FRAME[1]}"] = tuple(
            np.array(a) for a in small._cmds.snapshot())
        small._cmds.clear()
        return rec, runs, small_runs

    gen = torch.Generator().manual_seed(1)
    fb_seed = torch.rand((HEIGHT, WIDTH, 4), generator=gen,
                         dtype=torch.float64)
    cases = []      # (label, dtype, fb0, kinds, params, host params, atlas)
    max_err = 0.0
    saved = canvas_kernel.render_span.launches, \
        canvas_kernel.render_span.sampled
    for dtype in (torch.float32, torch.float64):
        rec, runs, small_runs = record_runs(dtype)
        atlas_t = rec._store.atlas
        # phase 8 times the bench frame, the 64-command frame, the mix and
        # two chart frames; the rest check bits only
        chart = [label for label in runs if label.startswith("chart")]
        timed = {label for label in runs
                 if label.startswith(("bench", "64-cmd", "texture mix ("))}
        timed |= {chart[0], chart[len(chart) // 2]}
        fb0 = fb_seed.to(dtype).to(dev)
        small0 = fb_seed[:SMALL_FRAME[1], :SMALL_FRAME[0]].contiguous().to(
            dtype).to(dev)
        n_tex = 0
        for label, (k, p) in list(runs.items()) + list(small_runs.items()):
            f0 = fb0 if label in runs else small0
            ph = p.astype(np.float32 if dtype == torch.float32
                          else np.float64)
            kt = torch.from_numpy(k.astype(np.int32))
            pt = torch.from_numpy(ph).to(dev)
            tiles = canvas_kernel.touched_tiles(k, ph, f0.shape[1],
                                                f0.shape[0])
            s0 = canvas_kernel.render_span.sampled
            got = canvas_kernel.render_span(f0.clone(), kt, pt, ph, atlas_t)
            n_tex += canvas_kernel.render_span.sampled - s0
            want = canvas_kernel.render_span_reference(f0.clone(), kt, pt,
                                                       atlas_t)
            torch.cuda.synchronize()
            bad = same_bits(got, want)
            nans = int(torch.isnan(got).sum())
            # NaN texels: the same places; their payload bits are the
            # card's, printed
            bad_nan = same_bits_but_nan(got, want) if nans else bad
            err = float((got - want).abs().nan_to_num(0.0).max())
            changed = int((got != f0).any(-1).sum())
            print(f"[k4 vs plain] {label} {str(dtype)[6:]} "
                  f"{f0.shape[1]}x{f0.shape[0]}: {bad} of {got.numel()} "
                  f"values differ in their bits (max |delta| {err}); "
                  f"{nans} NaN values, {bad_nan} differing where not both "
                  f"NaN; {changed} pixels changed; "
                  f"{'all' if tiles is None else tiles.size} tiles "
                  f"launched", flush=True)
            if bad_nan or not changed or (nans and "off the atlas"
                                          not in label):
                raise AssertionError("K4 and its plain version disagree")
            if "off the atlas" in label and not nans:
                raise AssertionError("no texel read NaN off the atlas")
            max_err = max(max_err, err)
            if label in timed:
                cases.append((label, dtype, fb0, kt, pt, ph, atlas_t))
        want_tex = sum(int(np.isin(k, sorted(canvas_kernel.TEXTURE_KINDS))
                           .sum()) for k, _ in runs.values())
        print(f"[k4 vs plain] {str(dtype)[6:]}: render_span.sampled counted "
              f"{n_tex} texture commands of the {want_tex} in the runs",
              flush=True)
        if n_tex != want_tex:
            raise AssertionError("render_span.sampled miscounts")
        # a run that touches no tile launches nothing and changes nothing
        rec.draw_rect(-90.0, -60.0, 40.0, 20.0, 1, 1, 1, 1)
        rec.set_pixel(WIDTH + 40, 7, 1, 1, 1, 1)
        rec.draw_texture(texs[0], -300.0, 10.0, 100.0, 100.0)
        k, p = (np.array(a) for a in rec._cmds.snapshot())
        rec._cmds.clear()
        ph = p.astype(np.float32 if dtype == torch.float32 else np.float64)
        n0 = canvas_kernel.render_span.launches
        got = canvas_kernel.render_span(
            fb0.clone(), torch.from_numpy(k.astype(np.int32)),
            torch.from_numpy(ph).to(dev), ph, atlas_t)
        torch.cuda.synchronize()
        n_new = canvas_kernel.render_span.launches - n0
        print(f"[k4 vs plain] a run that touches no tile "
              f"{str(dtype)[6:]}: {n_new} launches, "
              f"{same_bits(got, fb0)} values changed", flush=True)
        if n_new or same_bits(got, fb0):
            raise AssertionError("an empty K4 run launched or wrote")
    canvas_kernel.render_span.launches, \
        canvas_kernel.render_span.sampled = saved

    # 7. the canvas main path, K4 launches counted from zero
    def run_frames(ctx, n, t0=0):
        for i in range(n):
            bench_draw(ctx, texs, (t0 + i) * 0.016)
            ctx.flush()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2 ** 20
    canvas_kernel.render_span.launches = 0
    ctx = RenderContext(WIDTH, HEIGHT, True, device=dev)
    run_frames(ctx, CANVAS_FRAMES)
    launches = canvas_kernel.render_span.launches
    card_u8 = ctx.uint8_buffer()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if launches != CANVAS_FRAMES:
        raise AssertionError(f"K4 launched {launches} times for "
                             f"{CANVAS_FRAMES} frames")
    t = time.perf_counter()
    cpu = RenderContext(WIDTH, HEIGHT, True, device="cpu")
    run_frames(cpu, CANVAS_FRAMES)
    cpu_u8 = cpu.uint8_buffer()
    cpu_s = time.perf_counter() - t
    if card_u8.shape != (HEIGHT, WIDTH, 4) or card_u8.dtype != np.uint8:
        raise AssertionError(f"frame {card_u8.shape} {card_u8.dtype}")
    diff = int((card_u8 != cpu_u8).sum())
    lit = float((card_u8[..., :3] > 0).any(-1).mean())
    print(f"[canvas main path] RenderContext 1920x1080 float32 on the card, "
          f"{CANVAS_FRAMES} frames of bench.py's draw(t), one flush each: "
          f"K4 launches {launches} = frames; last frame's u8 vs the "
          f"same script on the CPU through the port ({cpu_s:.1f} s): "
          f"{diff} bytes differ; {lit:.3f} of the pixels lit", flush=True)
    if diff:
        raise AssertionError("card canvas frame differs from the CPU port")
    if lit < 0.5:
        raise AssertionError("the canvas frame is mostly dark")

    # 8. times
    frame_ms = []
    for r in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_frames(ctx, CANVAS_FRAMES, CANVAS_FRAMES * (r + 1))
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t) / CANVAS_FRAMES)
    per_frame, busy, prof = profile_frames(
        lambda: run_frames(ctx, PROFILE_FRAMES), PROFILE_FRAMES)

    # device time of the main path's K4 launches (one a frame)
    k4_prof = [e.time_range.end - e.time_range.start for e in sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and K4_ENTRY_NAME.search(e.name)),
        key=lambda e: e.time_range.start)]
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    # K4's own time: CUDA events around raw launches (the kinds and the
    # tile list already on the card), so the wrapper's host work cannot
    # leave the card idle
    k4_ms = {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for label, dtype, fb0, kt, pt, ph, atlas_t in cases:
        fb = fb0.clone()
        kd = kt.to(dev)
        tiles = canvas_kernel.touched_tiles(kt.numpy(), ph, WIDTH, HEIGHT)
        td = None if tiles is None else torch.from_numpy(tiles).to(dev)

        def raw():
            _kernels.launch_canvas_span(
                fb.data_ptr(), WIDTH, HEIGHT, kd.data_ptr(), pt.data_ptr(),
                kd.numel(), 0 if td is None else td.data_ptr(),
                0 if td is None else td.numel(), atlas_t.data_ptr(),
                atlas_t.shape[0], atlas_t.shape[1], dtype == torch.float64,
                stream)

        k_ms = cuda_ms(raw, 50)
        p_ms = cuda_ms(lambda: canvas_kernel.render_span_reference(
            fb, kt, pt, atlas_t), 3)
        b_ms, b_by, bb, bo = k4_bound(kt.numpy(), ph, dtype)
        k4_ms[(label, dtype)] = (k_ms, p_ms, b_ms, b_by)
        print(f"[canvas times] {card}: K4 {label} {str(dtype)[6:]} "
              f"{k_ms} ms/launch, plain version {p_ms} ms (CUDA events); "
              f"bound {b_ms} ms by {b_by} (bytes {bb} ms, operations "
              f"{bo} ms), K4 at {b_ms / k_ms:.4f} of it", flush=True)
    if k4_prof:
        print(f"[canvas times] {card}: K4 in the profiled main path, "
              f"device ms per launch (one a frame): "
              f"{1e-3 * float(np.mean(k4_prof))}", flush=True)
    print(f"[canvas times] device ms per frame by kernel (profiler): "
          + "; ".join(f"{name[:60]} {1e-3 * us / PROFILE_FRAMES:.4f}"
                      for name, us in top), flush=True)
    print(f"[canvas times] {card}: canvas {sorted(frame_ms)} ms/frame "
          f"(host clock, 3 runs of {CANVAS_FRAMES} frames each ended by a "
          f"sync, record + flush); per frame over {PROFILE_FRAMES} "
          f"profiled frames: {per_frame['cudaLaunchKernel']} "
          f"cudaLaunchKernel, {per_frame['cudaStreamSynchronize']} "
          f"cudaStreamSynchronize, {per_frame['cudaMemcpyAsync']} "
          f"cudaMemcpyAsync; device {busy}; peak device memory "
          f"{peak_mib} MiB in the main path, {peak_mib - base_mib} MiB "
          f"above the {base_mib} MiB held before it", flush=True)

    bench = [v for (label, dtype), v in k4_ms.items()
             if label.startswith("bench") and dtype == torch.float32]
    bound = max(bench, key=lambda v: v[2])
    return {"name": "render_span", "route": "cuda",
            "source": "libnativecpurenderer_tpu_torch/csrc/canvas_span.cu",
            "replaces": "libnativecpurenderer_tpu/ops/canvas_kernel.py:52",
            "launches": launches, "max_abs_err": max_err,
            "ms": float(np.mean([v[0] for v in bench])),
            "plain_ms": float(np.mean([v[1] for v in bench])),
            "bound_ms": float(np.mean([v[2] for v in bench])),
            "bound_by": bound[3], "library_ms": None}


PIPE_FRAMES, PIPE_BATCH = 45, 15
SHARED_SIZE = 256


def e2e_draw(ctx, texs, t):
    """bench.py:720-732's draw(t), the e2e cell's frame at 1920x1080: a dim
    full-frame fill, 24 split blits of 4 textures and 8 rects."""
    W, H = WIDTH, HEIGHT
    ctx.fill_color(0.05, 0.05, 0.08, 0.25)
    r2 = np.random.default_rng(42)
    for i in range(24):
        x = float(r2.uniform(0, W - 140) + 40 * math.sin(t * 2 + i))
        y = float(r2.uniform(0, H - 140))
        ctx.draw_splitted_texture(texs[i % 4], x, y, 100.0, 50.0,
                                  0.1, 0.9, 0.0, 1.0)
    for i in range(8):
        ctx.draw_rect(float(r2.uniform(0, W - 60)),
                      float(r2.uniform(0, H - 60)),
                      40.0, 24.0, 0.2, 0.8, 0.4, 0.7)


def owner_draw(owner, i):
    """Frame i of the shared texture's owner: a fill and a circle, both
    changing with i."""
    s = SHARED_SIZE
    owner.fill_color((i % 8) / 8.0, 0.3, 1.0 - (i % 5) / 5.0,
                     0.5 + (i % 2) / 4.0)
    owner.draw_circle(s / 2 + 40 * math.sin(i), s / 2, 30.0 + 2 * (i % 20),
                      0.9, 0.8, 0.1, 0.9)


def shared_draw(ctx, shared, hit, i):
    """The shared variant's draws beside the e2e mix: the owner's shared
    texture, moving with i, and two hit effects of it (the fast path and
    a rotated one)."""
    ctx.draw_texture(shared, 200.0 + 8 * i, 300.0, 256.0, 256.0)
    ctx.draw_texture(hit, 900.0, 200.0, 300.0, 300.0)
    ctx.save_state()
    ctx.translate(1400.0, 700.0)
    ctx.rotate(0.05 * i)
    ctx.draw_texture(hit, -150.0, -150.0, 300.0, 300.0)
    ctx.restore_state()


def pipeline_phase(dev, card: str, k4_row: dict) -> None:
    """Phase 18: the record -> u8 pipeline on bench.py:700-775's e2e mix;
    adds its K4 launches to K4's entry of the kernel table."""
    from libnativecpurenderer_tpu_torch import (
        BatchedVideoPipeline, HitEffectTexture,
        MultiThreadedVideoRenderContextPreparer, RenderContext, Texture)
    from libnativecpurenderer_tpu_torch import atlas
    from libnativecpurenderer_tpu_torch.ops import canvas_kernel
    from libnativecpurenderer_tpu_torch.ops import commands as C
    from libnativecpurenderer_tpu_torch.ops.executor import sample_window

    rng = np.random.default_rng(0)
    texs = [Texture._from_array(rng.random((128, 128, 4)), True)
            for _ in range(4)]
    # the proxy, the pipelines and the flushing contexts on their default
    # device, the card
    rec = MultiThreadedVideoRenderContextPreparer(None, WIDTH, HEIGHT, True)
    dtype = rec._dtype
    fb0 = torch.zeros((HEIGHT, WIDTH, 4), dtype=dtype, device=dev)
    flush_ctx = RenderContext(WIDTH, HEIGHT, True)
    if rec.device.type != dev.type or flush_ctx.device.type != dev.type:
        raise AssertionError("the proxy is not on the card")

    def record(n, sink, extra=None):
        """Record n frames of the mix on the proxy (extra(i) draws more
        after each) into a pipeline of batch PIPE_BATCH from fb0."""
        pipe = BatchedVideoPipeline(sink, WIDTH, HEIGHT, PIPE_BATCH, dtype,
                                    fb0)
        if pipe.device.type != dev.type:
            raise AssertionError("the pipeline is not on the card")
        for i in range(n):
            e2e_draw(rec, texs, i * 0.016)
            if extra is not None:
                extra(i)
            pipe.submit(*rec._cmds.snapshot())
            rec._cmds.clear()
        pipe.finish()

    def flushed(draw):
        """The u8 frame of draw(ctx) flushed by a RenderContext from fb0."""
        flush_ctx._fb.copy_(fb0)
        draw(flush_ctx)
        return flush_ctx.uint8_buffer()

    # (a), (b): the main path, K4's launches counted from zero
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2 ** 20
    sink = PlainSink()
    canvas_kernel.render_span.launches = 0
    record(PIPE_FRAMES, sink)
    launches = canvas_kernel.render_span.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    if launches != PIPE_FRAMES:
        raise AssertionError(f"K4 launched {launches} times for "
                             f"{PIPE_FRAMES} pipeline frames")
    if len(sink.frames) != PIPE_FRAMES:
        raise AssertionError(f"the sink got {len(sink.frames)} frames")
    bad = []
    for i, fr in enumerate(sink.frames):
        if fr.shape != (HEIGHT, WIDTH, 4) or fr.dtype != np.uint8:
            raise AssertionError(f"frame {fr.shape} {fr.dtype}")
        want = flushed(lambda c: e2e_draw(c, texs, i * 0.016))
        if not np.array_equal(fr, want):
            bad.append(i)
    k = PIPE_FRAMES - 1
    cpu = RenderContext(WIDTH, HEIGHT, True, device="cpu")
    e2e_draw(cpu, texs, k * 0.016)
    cpu_diff = int((cpu.uint8_buffer() != sink.frames[k]).sum())
    lit = float((sink.frames[k][..., :3] > 0).any(-1).mean())
    print(f"[pipeline main path] MultiThreadedVideoRenderContextPreparer "
          f"-> BatchedVideoPipeline at {WIDTH}x{HEIGHT} "
          f"{str(dtype)[6:]} on the card, {PIPE_FRAMES} frames of "
          f"bench.py's e2e mix at batch {PIPE_BATCH} from a zero fb0: K4 "
          f"launches {launches} = frames; frames differing from their "
          f"RenderContext flush on the card: {bad}; frame {k} vs the CPU "
          f"port: {cpu_diff} bytes differ; {lit:.4f} of its pixels lit",
          flush=True)
    if bad or cpu_diff:
        raise AssertionError("a pipeline frame differs from its flush")
    if lit < 0.05:
        raise AssertionError("the pipeline frame is mostly dark")
    del sink

    # (c), (d): a shared texture and hit effects of it beside the mix,
    # against their own owner's on the flushing path
    owners = [RenderContext(SHARED_SIZE, SHARED_SIZE, True)
              for _ in range(2)]
    shared = [o.as_texture_shared() for o in owners]
    hits = [HitEffectTexture(m, 0.37, 0.45, 0.59, 0.56, 0.99)
            for m in shared]
    store = atlas.get_store(dtype, rec.device)
    wants, inside, marks, retired = [], [], [], []

    def extra(i):
        for o in owners:
            owner_draw(o, i)
        shared_draw(rec, shared[0], hits[0], i)
        kinds, params = rec._cmds.snapshot()
        box = np.zeros((HEIGHT, WIDTH), bool)
        for kd, q in zip(kinds.tolist(), params[:, 6:10].astype(np.float32)):
            win = sample_window(q, WIDTH, HEIGHT)
            if kd == C.KIND_HITEFFECT and win is not None:
                box[win[2]:win[3], win[0]:win[1]] = True
        inside.append(box)
        wants.append(flushed(lambda c: (e2e_draw(c, texs, i * 0.016),
                                        shared_draw(c, shared[1], hits[1],
                                                    i))))
        marks.append(store._y_next)
        retired.append(len(shared[0]._retired))

    sink = PlainSink()
    record(PIPE_FRAMES, sink, extra)
    flips, outside, allowed = [], 0, 0
    for fr, want, box in zip(sink.frames, wants, inside):
        px = (fr != want).any(-1)
        outside += int(px[~box].sum())
        flips.append(int(px.sum()))
        allowed = max(allowed, int(HIT_FLIP_SHARE * box.sum()))
    settled = 2 * PIPE_BATCH
    print(f"[pipeline shared texture] {PIPE_FRAMES} frames of the mix with "
          f"a {SHARED_SIZE}x{SHARED_SIZE} shared texture its owner redraws "
          f"each frame and 2 hit effects of it, batch {PIPE_BATCH}, "
          f"against the same frames flushed at their record point: "
          f"{outside} pixels differ outside the hit effects' windows, "
          f"pixels differing a frame {flips} (allowed {allowed} inside); "
          f"store rows in use after each batch "
          f"{marks[PIPE_BATCH - 1::PIPE_BATCH]}, retired region sets at "
          f"most {max(retired)}, {len(shared[0]._region_pool.get(store, []))}"
          f" regions in the pool", flush=True)
    if outside or max(flips) > allowed:
        raise AssertionError("a shared-texture pipeline frame differs from "
                             "its flush")
    if marks[-1] != marks[settled]:
        raise AssertionError(f"the store still grows: {marks}")
    if max(retired) > 2 * PIPE_BATCH + 2:
        raise AssertionError(f"retired region sets pile up: {retired}")
    if not (sink.frames[-1][..., 3] > 0).any():
        raise AssertionError("the shared variant drew nothing")
    del sink, wants

    # (e) times, with a sink that drops the frames
    drop = DropSink()
    record(PIPE_FRAMES, drop)                       # warm
    frame_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        record(PIPE_FRAMES, drop)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t) / PIPE_FRAMES)
    t = time.perf_counter()
    for i in range(PIPE_FRAMES):              # the record alone
        e2e_draw(rec, texs, i * 0.016)
        rec._cmds.snapshot()
        rec._cmds.clear()
    record_ms = 1e3 * (time.perf_counter() - t) / PIPE_FRAMES
    per_frame, busy, prof = profile_frames(
        lambda: record(PIPE_BATCH, drop), PIPE_BATCH)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    mid = sorted(frame_ms)[1]
    print(f"[pipeline times] {card}: e2e record -> u8 at {WIDTH}x{HEIGHT} "
          f"{str(dtype)[6:]}, batch {PIPE_BATCH}: {sorted(frame_ms)} "
          f"ms/frame, {1e3 / mid} frames/s at the median (host clock, 3 "
          f"runs of {PIPE_FRAMES} frames after a warm run, record, render, "
          f"u8 and the pinned copy to a sink that drops the frames); per "
          f"frame over {PIPE_BATCH} profiled frames: "
          f"{per_frame['cudaLaunchKernel']} cudaLaunchKernel, "
          f"{per_frame['cudaStreamSynchronize']} cudaStreamSynchronize, "
          f"{per_frame['cudaMemcpyAsync']} cudaMemcpyAsync; device {busy}; "
          f"peak device memory {peak_mib} MiB in the main path, "
          f"{peak_mib - base_mib} MiB above the {base_mib} MiB held before "
          f"it; the record alone {record_ms} ms/frame (host clock, "
          f"{PIPE_FRAMES} frames)", flush=True)
    print(f"[pipeline times] device ms per frame by kernel (profiler): "
          + "; ".join(f"{name[:60]} {1e-3 * us / PIPE_BATCH:.4f}"
                      for name, us in top), flush=True)
    k4_row["launches"] += launches



# Phases 19-21: the audio engine and the MIDI -> WAV path.  bench.py's
# audio cell (bench.py:778-822): a 112 s, 44.1 kHz stereo target and 876
# overlays of a 0.5 s clip.  No Pallas kernel lies on this path; the
# scatter routes' kernel (csrc/audio_scatter.cu), which replaces none, is
# the kernel table's last row.
AUDIO_RATE, AUDIO_SECONDS = 44100, 112.0
AUDIO_OVERLAYS = 876
# the FFT route's tolerance, card against CPU: the JAX package's own for
# that route (tests/test_audio_golden.py:244-269); every other route is
# held bit-equal
AUDIO_FFT_ATOL = 1e-9
# phase 20's seeded stand-ins for the reference's rr.mid and instrument
# banks (neither is in the repo): ~2 minutes, 1,500 notes on 4 channels,
# notes 36-108, two tempo changes; banks ha/ji/mi x files 12-143 of 1.0 s
# decaying tones, 48 kHz s16 stereo, as the reference's are laid out
SONG_NOTES, SONG_CHANNELS, SONG_LO, SONG_HI = 1500, 4, 36, 108
BANK_RATE, BANK_SECONDS = 48000, 1.0
# phase 19's scatter kernel at the mixer cell's shape: a ~115.6 s song's
# target, 1,500 events of 1.0 s clips (44.1 kHz) from ~219 of the bank's
SCATTER_SECONDS, SCATTER_CLIPS, SCATTER_EVENTS = 115.6, 219, 1500


def wav_i16(wav: bytes) -> np.ndarray:
    """The int16 samples of a WAV's data chunk (header of 44 bytes)."""
    return np.frombuffer(wav[44:], "<i2").astype(np.int32)


def same_wav(a: bytes, b: bytes) -> tuple:
    """(bytes equal, samples differing, largest difference in levels)."""
    if a == b:
        return True, 0, 0
    if len(a) != len(b) or a[:44] != b[:44]:
        raise AssertionError("the WAV headers or lengths differ")
    d = np.abs(wav_i16(a) - wav_i16(b))
    return False, int((d > 0).sum()), int(d.max())


def audio_ops_phase(dev, card: str) -> dict:
    """Phase 19: each AudioClip op at bench scale on the card twice and on
    the CPU port, float64; then the scatter kernel's times.  Returns the
    kernel table's row of the scatter kernel, its launches on the main
    path left to phase 20."""
    from libnativecpurenderer_tpu_torch import AudioClip, config

    rng = np.random.default_rng(19)
    n = int(AUDIO_RATE * AUDIO_SECONDS)
    tgt = rng.standard_normal((n, 2)) * 0.05
    src48 = rng.standard_normal((int(48000 * AUDIO_SECONDS), 2)) * 0.05
    three = rng.standard_normal((3 * AUDIO_RATE, 2)) * 0.1
    short = rng.standard_normal((4096, 2)) * 0.1
    half = rng.standard_normal((AUDIO_RATE // 2, 2)) * 0.1
    scatter_secs = np.concatenate([rng.uniform(0, AUDIO_SECONDS, 61),
                                   [-0.05, AUDIO_SECONDS - 0.01, 200.0]])
    fft_secs = np.concatenate([rng.uniform(0, AUDIO_SECONDS, 124),
                               [-0.2, -0.2, AUDIO_SECONDS, 300.0]])
    groups = [(rng.standard_normal((int(rng.integers(2000, 48001)), 2))
               * 0.1, rng.uniform(-0.5, AUDIO_SECONDS,
                                  int(rng.integers(1, 41))))
              for _ in range(200)]

    def clip(arr, d, rate=AUDIO_RATE):
        return AudioClip._from_array(rate, 2, arr, device=d)

    def overlays(d):
        c = clip(tgt, d)
        c.overlay(clip(three, d), 0.45 * AUDIO_SECONDS, time_unit="second")
        c.overlay(clip(three, d), -AUDIO_RATE)       # wraps to the end
        return c

    def many(src, secs):
        def run(d):
            c = clip(tgt, d)
            c.overlay_many(clip(src, d), secs)
            return c
        return run

    def grouped(d):
        c = clip(tgt, d)
        c.overlay_groups([(clip(a, d), secs) for a, secs in groups])
        return c

    def op(fn):
        def run(d):
            c = clip(tgt, d)
            fn(c)
            return c
        return run

    def bucketed(k, rows):
        b = 1
        while b < k:
            b *= 2
        return b * rows <= 2 ** 20

    assert bucketed(len(scatter_secs), len(short))
    assert not bucketed(len(fft_secs), len(half))
    cases = [
        ("gain x0.7", False, op(lambda c: c.apply_volume_gain(0.7))),
        ("resample 48 -> 44.1 kHz stereo", False,
         lambda d: (lambda c: (c.resample(AUDIO_RATE, 2), c)[1])(
             clip(src48, d, 48000))),
        ("resample 44.1 -> 18 kHz", False, op(lambda c: c.resample(18000,
                                                                   2))),
        ("resample 2 -> 1 channel", False,
         op(lambda c: c.resample(AUDIO_RATE, 1))),
        ("cut 10-70 s of 112", False,
         op(lambda c: c.cut(AUDIO_SECONDS * 10 / 112,
                            AUDIO_SECONDS * 70 / 112, time_unit="second"))),
        ("cut past the end", False, op(lambda c: c.cut(n - 1000,
                                                       n + AUDIO_RATE))),
        # dynamic_slice counts a negative start from the padded end
        ("cut from a negative start", False,
         op(lambda c: c.cut(-(n // 2), AUDIO_RATE - n // 2))),
        ("overlay of 3 s at 50 s of 112 and at -1 s", False, overlays),
        (f"overlay_many scatter route ({len(scatter_secs)} events x "
         f"{len(short)} frames)", False, many(short, scatter_secs)),
        (f"overlay_many FFT route ({len(fft_secs)} events x {len(half)} "
         f"frames)", True, many(half, fft_secs)),
        (f"overlay_groups ({len(groups)} groups, "
         f"{sum(len(g[1]) for g in groups)} events, 2k-48k frames)", False,
         grouped),
    ]
    prev = config.default_dtype()
    config.set_default_dtype(torch.float64)
    try:
        for name, fft, run in cases:
            a, b, c = run(dev), run(dev), run("cpu")
            if a.device.type != dev.type or c.device.type != "cpu":
                raise AssertionError(f"{name}: not on the devices asked")
            ha, hb, hc = a.numpy(), b.numpy(), c.numpy()
            if ha.shape != hc.shape:
                raise AssertionError(f"{name}: shapes {ha.shape} "
                                     f"{hc.shape}")
            repeat = int((ha.view(np.uint64) != hb.view(np.uint64)).sum())
            off = int((ha.view(np.uint64) != hc.view(np.uint64)).sum())
            err = float(np.abs(ha - hc).max())
            eq, wav_n, wav_lv = same_wav(a.save_as_wav(), c.save_as_wav())
            print(f"[audio vs cpu] {card}: {name}, {ha.shape[0]} frames "
                  f"float64: card twice {'bit-identical' if not repeat else f'{repeat} samples differ'}; card vs "
                  f"CPU {off} of {ha.size} samples differ, largest "
                  f"{err} (allowed {AUDIO_FFT_ATOL if fft else 0}); "
                  f"save_as_wav bytes "
                  f"{'equal' if eq else f'differ on {wav_n} samples of {ha.size} ({wav_n / ha.size} of them), by at most {wav_lv} level'}",
                  flush=True)
            if repeat:
                raise AssertionError(f"{name}: two card runs differ")
            if (err > AUDIO_FFT_ATOL) if fft else off:
                raise AssertionError(f"{name}: the card differs from the "
                                     f"CPU")
            if (wav_lv > 1) if fft else not eq:
                raise AssertionError(f"{name}: the WAV bytes differ")
            if not np.isfinite(ha).all() or not ha.any():
                raise AssertionError(f"{name}: not finite or all zero")
            del a, b, c
    finally:
        config.set_default_dtype(prev)
    return scatter_times(dev, card)


def scatter_times(dev, card: str) -> dict:
    """Phase 19's scatter kernel (csrc/audio_scatter.cu) at the mixer's
    shape: one call bit-equal to the plain version on the card, one launch
    a call; then its device ms a call (queued), the plain version's
    host and device time, the host's ms to enqueue a whole
    overlay_groups call, and the byte bounds; and one 1 s overlay onto
    the full-length target, kernel against the plain version's slice add.
    Returns the kernel table's row, ``launches`` None."""
    from libnativecpurenderer_tpu_torch.ops import _kernels, audio_ops

    rng = np.random.default_rng(22)
    rows = int(AUDIO_RATE * SCATTER_SECONDS)
    clips = [torch.from_numpy(rng.standard_normal((AUDIO_RATE, 2)).astype(
        np.float32) * 0.1).to(dev) for _ in range(SCATTER_CLIPS)]
    which = rng.integers(0, SCATTER_CLIPS, SCATTER_EVENTS)
    onsets = np.sort(rng.integers(0, rows - AUDIO_RATE, SCATTER_EVENTS))
    starts = [onsets[which == k] for k in range(SCATTER_CLIPS)]
    lens = [AUDIO_RATE] * SCATTER_CLIPS
    table, _ = audio_ops.segment_table(rows, lens, starts)
    base = torch.from_numpy(rng.standard_normal((rows, 2)).astype(
        np.float32) * 0.05).to(dev)
    got, want = base.clone(), base.clone()
    launches = audio_ops.scatter_table.launches
    audio_ops.scatter_table(got, clips, table)
    one = audio_ops.scatter_table.launches - launches
    audio_ops.scatter_table_reference(want, clips, table)
    torch.cuda.synchronize()
    off = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    tgt = base.clone()
    kernel_ms = [cuda_ms(lambda: audio_ops.scatter_table(tgt, clips, table),
                         20, queued=True) for _ in range(2)]
    # the plain loop's 1,500 launches take the host longer than the card
    # takes to run them, so its device time is the profiler's busy time
    def plain():
        audio_ops.scatter_table_reference(tgt, clips, table)

    torch.cuda.synchronize()
    t = time.perf_counter()
    plain()
    torch.cuda.synchronize()
    plain_wall = 1e3 * (time.perf_counter() - t)
    _, plain_busy, _ = profile_frames(plain, 1)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        audio_ops.overlay_groups(tgt, clips, lens, starts)
        host.append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    used = sum(1 for st in starts if st.size)
    n_bytes = rows * 2 * 4 * 2 + used * AUDIO_RATE * 2 * 4
    bound_ms = 1e3 * n_bytes / MEM_BYTES_S
    event_bytes = rows * 2 * 4 * 2 + int(table[:, 1].sum()) * 2 * 4
    print(f"[scatter kernel] {card}: a {rows}-row stereo float32 target, "
          f"{SCATTER_EVENTS} events of {AUDIO_RATE}-row clips from {used} "
          f"clips, {len(table)} runs: kernel vs plain version "
          f"{'bit-equal' if not off else f'{off} samples DIFFER'}, {one} "
          f"launch a call; kernel {kernel_ms} ms a call (CUDA events, 20 "
          f"calls queued, twice); plain slice-add loop {plain_wall} ms "
          f"a call on the host clock, device {plain_busy}; overlay_groups "
          f"on the host {sorted(host)} ms (enqueue, no sync); bound "
          f"{bound_ms:.4f} ms by bytes ({n_bytes / 1e6:.1f} MB: the target "
          f"read and written, each clip read once), the kernel at "
          f"{bound_ms / min(kernel_ms):.3f}; each event's rows read once "
          f"besides: {event_bytes / 1e6:.1f} MB, "
          f"{1e3 * event_bytes / MEM_BYTES_S:.4f} ms; "
          f"ptxas {ptxas_summary(_kernels.build_log('audio_scatter'))}",
          flush=True)
    if off or one != 1:
        raise AssertionError("the scatter kernel differs from its plain "
                             "version or did not launch once")

    # one overlay of a 1 s clip onto the full-length target: the launch
    # covers the tiles of the clip's rows alone, as the slice add does
    start = rows // 2
    single = audio_ops.segment_table(rows, [AUDIO_RATE], [[start]])[0]
    got, want = base.clone(), base.clone()
    audio_ops.overlay(got, clips[0], start)
    audio_ops.scatter_table_reference(want, clips[:1], single)
    torch.cuda.synchronize()
    one_off = int((got.view(torch.int32) != want.view(torch.int32)).sum())

    def one_kernel():
        audio_ops.overlay(tgt, clips[0], start)

    def one_plain():
        audio_ops.scatter_table_reference(
            tgt, clips[:1],
            audio_ops.segment_table(rows, [AUDIO_RATE], [[start]])[0])

    one_ms, one_host = {}, {}
    for name, fn in (("kernel", one_kernel), ("plain", one_plain),
                     ("kernel", one_kernel), ("plain", one_plain)):
        one_ms.setdefault(name, []).append(cuda_ms(fn, 50, queued=True))
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        one_host.setdefault(name, []).append(
            1e3 * (time.perf_counter() - t) / 50)
    one_bytes = 3 * AUDIO_RATE * 2 * 4
    print(f"[scatter kernel] {card}: one overlay of a {AUDIO_RATE}-row "
          f"clip at row {start} of the {rows}-row target: kernel vs plain "
          f"{'bit-equal' if not one_off else f'{one_off} samples DIFFER'};"
          f" device ms a call (CUDA events, 50 queued, in turns) kernel "
          f"{one_ms['kernel']}, plain slice add {one_ms['plain']}; host "
          f"ms a call (50 calls, then a sync) kernel {one_host['kernel']},"
          f" plain {one_host['plain']}; bound "
          f"{1e3 * one_bytes / MEM_BYTES_S:.5f} ms by bytes "
          f"({one_bytes / 1e6:.3f} MB: the clip's rows of the target read "
          f"and written, the clip read)", flush=True)
    if one_off:
        raise AssertionError("one overlay: the kernel differs from its "
                             "plain version")
    return {"name": "audio_scatter", "route": "cuda",
            "source": "libnativecpurenderer_tpu_torch/csrc/audio_scatter.cu",
            "replaces": None, "launches": None, "max_abs_err": 0.0,
            "ms": float(np.mean(kernel_ms)),
            "plain_ms": plain_wall, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def seeded_song() -> bytes:
    """Phase 20's song: SONG_NOTES notes on SONG_CHANNELS channels, notes
    SONG_LO-SONG_HI, chords and runs, program changes, two tempo changes;
    a format-0 SMF at 480 ticks a quarter, ~2 minutes."""
    rng = np.random.default_rng(20)
    ev = [(0, bytes([0xFF, 0x51, 0x03]) + (500000).to_bytes(3, "big"))]
    ev += [(0, bytes([0xC0 | c, int(rng.integers(0, 128))]))
           for c in range(SONG_CHANNELS)]
    tick = 0
    for k in range(SONG_NOTES):
        tick += 0 if rng.random() < 0.25 else int(rng.integers(50, 150))
        c = int(rng.integers(0, SONG_CHANNELS))
        note = int(rng.integers(SONG_LO, SONG_HI + 1))
        ev.append((tick, bytes([0x90 | c, note,
                                int(rng.integers(40, 128))])))
        ev.append((tick + int(rng.integers(60, 900)),
                   bytes([0x80 | c, note, 0])))
        if k in (SONG_NOTES // 3, 2 * SONG_NOTES // 3):
            uspq = 420000 if k < SONG_NOTES // 2 else 560000
            ev.append((tick, bytes([0xFF, 0x51, 0x03])
                       + uspq.to_bytes(3, "big")))
    ev.sort(key=lambda e: e[0])

    def vlq(v):
        out = [v & 0x7F]
        v >>= 7
        while v:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        return bytes(reversed(out))

    track, last = b"", 0
    for t, data in ev:
        track += vlq(t - last) + data
        last = t
    track += b"\x00\xFF\x2F\x00"
    return (b"MThd" + (6).to_bytes(4, "big") + (0).to_bytes(2, "big")
            + (1).to_bytes(2, "big") + (480).to_bytes(2, "big")
            + b"MTrk" + len(track).to_bytes(4, "big") + track)


def write_bank(root: str) -> None:
    """Phase 20's seeded instrument banks: ha/ji/mi x files 12-143, each a
    1.0 s decaying tone (the file's note, an instrument's harmonics, a
    little seeded noise), 48 kHz s16 stereo."""
    import os
    import wave
    rng = np.random.default_rng(21)
    t = np.arange(int(BANK_RATE * BANK_SECONDS)) / BANK_RATE
    for bi, name in enumerate(("ha", "ji", "mi")):
        os.makedirs(os.path.join(root, name))
        for n in range(12, 144):
            f = 440.0 * 2 ** ((n - 69) / 12)
            tone = sum(np.sin(2 * np.pi * f * (h + 1) * t) / (h + 1)
                       for h in range(bi + 1))
            tone = 0.25 * tone * np.exp(-t * (3.0 + bi))
            pcm = np.stack([tone, tone * 0.9], 1)
            pcm += rng.standard_normal(pcm.shape) * 0.002
            with wave.open(os.path.join(root, name, f"{n}.wav"), "wb") as w:
                w.setnchannels(2)
                w.setsampwidth(2)
                w.setframerate(BANK_RATE)
                w.writeframes((np.clip(pcm, -1, 1) * 32767).astype(
                    "<i2").tobytes())


def audio_main_phase(dev, card: str, scatter_row: dict) -> dict:
    """Phase 20: apps.hjm_mixer.main on the card (the default device) on a
    seeded song and bank, against the same call on the CPU; then the web
    service's request, card against CPU.  Returns phase 19's
    ``scatter_row`` with the scatter kernel's launches in one card mix."""
    import os
    import tempfile
    import types
    from libnativecpurenderer_tpu_torch import media
    from libnativecpurenderer_tpu_torch.apps import hjm_mixer
    from libnativecpurenderer_tpu_torch.apps import hjm_mixer_server as srv
    from libnativecpurenderer_tpu_torch.audio import AudioClip
    from libnativecpurenderer_tpu_torch.ops import audio_ops

    song = seeded_song()
    with tempfile.TemporaryDirectory() as td:
        t = time.perf_counter()
        write_bank(os.path.join(td, "bank"))
        bank_s = time.perf_counter() - t
        mid_fp = os.path.join(td, "song.mid")
        with open(mid_fp, "wb") as f:
            f.write(song)

        def mix(out, **kw):
            hjm_mixer.main(types.SimpleNamespace(
                res=os.path.join(td, "bank"), input=mid_fp,
                output=os.path.join(td, out), min_note=SONG_LO,
                max_note=SONG_HI, dnote=0, base=None, offset=0, **kw))
            with open(os.path.join(td, out), "rb") as f:
                return f.read()

        seen = {}
        real_groups = AudioClip.overlay_groups
        real_load = hjm_mixer.Bank._load

        def spy_groups(self, pairs):
            pairs = list(pairs)
            seen["calls"] = seen.get("calls", 0) + 1
            seen["groups"] = len(pairs)
            seen["events"] = sum(len(s) for _, s in pairs)
            seen["device"] = self.device.type
            return real_groups(self, pairs)

        AudioClip.overlay_groups = spy_groups
        try:
            audio_ops.scatter_table.launches = 0
            card_wav = mix("card.wav")                  # warm, the default
            launches = audio_ops.scatter_table.launches
            if seen["device"] != dev.type:
                raise AssertionError("the mix did not run on the card")
            if seen["calls"] != 1 or launches != 1:
                raise AssertionError(
                    f"the mix made {seen['calls']} overlay_groups calls "
                    f"and {launches} scatter kernel launches, not 1 and 1")
        finally:
            AudioClip.overlay_groups = real_groups
        walls = []
        torch.cuda.reset_peak_memory_stats()
        base_mib = torch.cuda.memory_allocated() / 2 ** 20
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            again = mix("card2.wav")
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if again != card_wav:
                raise AssertionError("two card mixes differ")
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        # the bank's share: each file's decode on the host and resample
        # on the card (Bank._load), each ended by a sync, in a run of its
        # own
        spent = [0.0]

        def timed(real):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*a, **k)
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t0
                return out
            return run

        hjm_mixer.Bank._load = timed(real_load)
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            mix("card3.wav")
            torch.cuda.synchronize()
            bank_wall = time.perf_counter() - t
        finally:
            hjm_mixer.Bank._load = real_load
        calls, busy, _ = profile_frames(lambda: mix("card4.wav"), 1)
        t = time.perf_counter()
        cpu_wav = mix("cpu.wav", device="cpu")
        cpu_s = time.perf_counter() - t
        eq, n_off, lv = same_wav(card_wav, cpu_wav)
        song_s = (len(card_wav) - 44) / (4 * 44100)
        best = min(walls)
        print(f"[audio main path] {card}: hjm_mixer.main on the card (its "
              f"default device), a seeded {len(song)}-byte song of "
              f"{SONG_NOTES} notes on {SONG_CHANNELS} channels (notes "
              f"{SONG_LO}-{SONG_HI}, two tempo changes; {song_s} s) and a "
              f"seeded 48 kHz bank of 396 x {BANK_SECONDS} s files "
              f"(written in {bank_s} s): {seen['groups']} groups, "
              f"{seen['events']} events, one overlay_groups call, "
              f"{launches} scatter kernel launch; WAV "
              f"bytes card vs CPU "
              f"{'bit-equal' if eq else f'DIFFER on {n_off} samples by up to {lv}'}"
              f" ({len(card_wav)} bytes); wall {sorted(walls)} s (host "
              f"clock, after a warm run), xRT {song_s / best} at the best; "
              f"the bank's decode (host) and resample (card) "
              f"{spent[0]} s of a {bank_wall} s run, share "
              f"{spent[0] / bank_wall}; {calls['cudaLaunchKernel']} "
              f"cudaLaunchKernel, {calls['cudaStreamSynchronize']} "
              f"cudaStreamSynchronize, {calls['cudaMemcpyAsync']} "
              f"cudaMemcpyAsync a mix, device {busy}; peak device memory "
              f"{peak_mib} MiB, {peak_mib - base_mib} MiB above the "
              f"{base_mib} MiB held; the CPU port's mix {cpu_s} s",
              flush=True)
        if not eq:
            raise AssertionError("the card's WAV differs from the CPU's")
        pcm = wav_i16(card_wav)
        if song_s < 0.05 * SONG_NOTES or not (pcm != 0).mean() > 0.5:
            raise AssertionError("the mix is short or mostly silent")

        # the web service's request: synth -> mix -> 18 kHz -> encode
        base_card = srv.synth_base(song, device=dev)
        base_cpu = srv.synth_base(song, device="cpu")
        syn_err = float(np.abs(base_card.numpy() - base_cpu.numpy()).max())
        del base_card, base_cpu
        t = time.perf_counter()
        body_card = srv.mix_request(song, SONG_LO, SONG_HI, 0, 0,
                                    os.path.join(td, "bank"), device=dev)
        req_s = time.perf_counter() - t
        body_cpu = srv.mix_request(song, SONG_LO, SONG_HI, 0, 0,
                                   os.path.join(td, "bank"), device="cpu")
        enc = ("the native MP3 encoder (libtpurmedia.so)"
               if media.native_available() else
               "no native runtime: a WAV at the MP3 rate 18 kHz snaps to")
        if media.native_available():
            req_eq, req_n, req_lv = body_card == body_cpu, -1, -1
        else:
            req_eq, req_n, req_lv = same_wav(body_card, body_cpu)
        print(f"[audio main path] {card}: mix_request on the card "
              f"{req_s} s (host clock, synth on the host, mix and "
              f"resample on the card), {len(body_card)} bytes from {enc}; "
              f"synth_base card vs CPU largest difference {syn_err} "
              f"(allowed {AUDIO_FFT_ATOL}); the answer card vs CPU "
              f"{'bit-equal' if req_eq else f'differs on {req_n} samples by up to {req_lv} level'}",
              flush=True)
        if syn_err > AUDIO_FFT_ATOL:
            raise AssertionError("synth_base: the card differs from the CPU")
        if not req_eq and (media.native_available() or req_lv > 1):
            raise AssertionError("mix_request: the card differs from the "
                                 "CPU")
    return dict(scatter_row, launches=launches)


def audio_times_phase(dev, card: str) -> None:
    """Phase 21: bench.py:778-822's mixdown on the port's card, float64
    and float32."""
    from libnativecpurenderer_tpu_torch import AudioClip, config
    from libnativecpurenderer_tpu_torch.ops import audio_ops

    prev = config.default_dtype()
    try:
        for dtype in (torch.float64, torch.float32):
            config.set_default_dtype(dtype)
            rng = np.random.default_rng(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mib = torch.cuda.memory_allocated() / 2 ** 20
            target = AudioClip._from_array(
                AUDIO_RATE, 2, rng.standard_normal(
                    (int(AUDIO_RATE * AUDIO_SECONDS), 2)) * 0.05,
                device=dev)
            sfx = AudioClip._from_array(
                AUDIO_RATE, 2, rng.standard_normal(
                    (AUDIO_RATE // 2, 2)) * 0.1, device=dev)
            offsets = np.sort(rng.uniform(0, AUDIO_SECONDS - 1,
                                          AUDIO_OVERLAYS))

            def mixdown():
                target.overlay_many(sfx, offsets)
                return audio_ops.to_int16_device(target._buf)

            mixdown()                                   # warm
            torch.cuda.synchronize()
            walls, dev_ms = [], []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t = time.perf_counter()
                e0.record()
                pcm = mixdown()
                e1.record()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
                dev_ms.append(e0.elapsed_time(e1))
            peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
            t = time.perf_counter()
            wav = target.save_as_wav()
            wav_s = time.perf_counter() - t
            calls, busy, prof = profile_frames(mixdown, 1)
            by_name = {}
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + (
                        e.time_range.end - e.time_range.start)
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            if not (torch.isfinite(target._buf).all() and pcm.any()):
                raise AssertionError("the mixdown is not finite")
            best = min(walls)
            print(f"[audio times] {card}: bench.py's mixdown, "
                  f"{AUDIO_OVERLAYS} overlays of a 0.5 s clip onto a "
                  f"{AUDIO_SECONDS} s 44.1 kHz stereo target "
                  f"({str(dtype)[6:]}, the FFT route) + to_int16_device: "
                  f"{sorted(walls)} s (host clock, 3 runs after a warm "
                  f"one, each ended by a sync), xRT {AUDIO_SECONDS / best}"
                  f" at the best; device {sorted(dev_ms)} ms (CUDA "
                  f"events); save_as_wav {wav_s} s for {len(wav)} bytes; "
                  f"{calls['cudaLaunchKernel']} cudaLaunchKernel, "
                  f"{calls['cudaStreamSynchronize']} cudaStreamSynchronize,"
                  f" {calls['cudaMemcpyAsync']} cudaMemcpyAsync a mixdown,"
                  f" device {busy}; peak device memory {peak_mib} MiB, "
                  f"{peak_mib - base_mib} MiB above the {base_mib} MiB "
                  f"held", flush=True)
            print(f"[audio times] {str(dtype)[6:]} device ms of the "
                  f"mixdown by kernel (profiler): "
                  + "; ".join(f"{name[:60]} {1e-3 * us:.4f}"
                              for name, us in top), flush=True)
            del target, sfx, pcm
    finally:
        config.set_default_dtype(prev)

# phase 23: the blended quad batch (BASELINE config 2), its reduced check
# and its cell's shape
BLEND_SMALL = (320, 192, 256, 4)        # width, height, quads, frames
BLEND_CELL = (1280, 720, 4096, 16)
BLEND_KW = dict(tile_w=32, tile_h=32, capacity=2048, span_x=12, span_y=12)


def blend_inputs(dev, width: int, height: int, quads: int, frames: int,
                 seed: int = 2):
    """The blend cell's inputs at a size, on ``dev``: its configuration
    (``bench_torch/configs/baseline_quads_720p.json``) and traffic mix
    (``quad_orbit``) with the size changed, made by the cell's own
    ``systems.quad_blend_video.inputs`` (the scene, the sprite and the
    opaque depth ramp from the first frame): (verts, faces, uvs, tex)
    tensors, the opaque depth and the first ``frames`` matrices."""
    from bench_torch.harness import traffic
    from bench_torch.systems import quad_blend_video
    bench = Path(__file__).resolve().parent / "bench_torch"
    config = json.loads((bench / "configs" / "baseline_quads_720p.json")
                        .read_text())
    mix = json.loads((bench / "traffic" / "quad_orbit.json").read_text())
    config.update(width=width, height=height, quads=quads)
    made = quad_blend_video.inputs(config, mix, seed, dev)
    gen = traffic.generator(mix, config, seed)
    mvps = np.stack([gen.frame(k) for k in range(frames)])
    mesh = tuple(torch.from_numpy(made[k]).to(dev)
                 for k in ("verts", "faces", "uvs", "tex"))
    return (mesh, torch.from_numpy(made["opaque_depth"]).to(dev),
            torch.from_numpy(mvps).to(dev))


def blend_phase(dev, card: str) -> dict:
    """Phase 23: K7 and the blended mode.  At a reduced size the card's
    K7 against its plain version on the same prep, and the card's
    render_blended_u8_loop against the CPU's, bit for bit; at the cell's
    shape K7 against its plain version on the same card tensors, bit for
    bit, K7's device ms a batch (CUDA events, queued) beside its bound
    (rooflines/tile_blend over the reference's fragments) and its plain
    version's, the loop's ms a batch, and MeshVideoPipeline's K7
    launches and preps over 3 batches.  Returns K7's kernel-table
    row."""
    from bench_torch.references import quad_blend
    from bench_torch.rooflines import tile_blend as roof
    from libnativecpurenderer_tpu_torch import MeshVideoPipeline
    from libnativecpurenderer_tpu_torch.ops import _kernels, raster3d, \
        tile_raster

    k7 = tile_raster.raster_tiles_blend_u8
    w, h, q, n = BLEND_SMALL
    mesh, od, mvps = blend_inputs(dev, w, h, q, n)
    pre = raster3d.blend_pre(*mesh)
    prep = raster3d.prepare_blended_frame(
        mesh[0], mesh[1], pre[1], w, h, mvps, centres=pre[3], **BLEND_KW)
    args = [prep[k] for k in ("sorted_pad", "starts", "counts", "table",
                              "order")]
    bg = torch.zeros(4, device=dev)
    got = k7(*args, od, pre[2], (256, 256), bg, w, h, 32, 32)
    want = tile_raster.raster_tiles_blend_u8_reference(
        *[a.cpu() for a in args], od.cpu(), pre[2].cpu(), (256, 256),
        bg.cpu(), w, h, 32, 32)
    off_plain = int((got.cpu() != want).sum())
    card_frames, ovf = raster3d.render_blended_u8_loop(
        *mesh, w, h, mvps, opaque_depth=od, **BLEND_KW)
    cpu_frames, _ = raster3d.render_blended_u8_loop(
        *[a.cpu() for a in mesh], w, h, mvps.cpu(), opaque_depth=od.cpu(),
        **BLEND_KW)
    off_cpu = int((card_frames.cpu() != cpu_frames).any(-1).sum())
    lit = float((cpu_frames[..., 3] > 0).double().mean())
    print(f"[blend] {q} quads at {w}x{h}, {n} frames: K7 vs its plain "
          f"version on the card's prep: {off_plain} pixel words differ; "
          f"render_blended_u8_loop card vs CPU: {off_cpu} pixels differ; "
          f"overflow {bool(ovf)}; share of pixels drawn {lit:.3f}",
          flush=True)
    if off_plain or off_cpu or bool(ovf) or lit < 0.01:
        raise AssertionError("K7 differs from its plain version, or the "
                             "card's frames from the CPU's")

    w, h, q, n = BLEND_CELL
    mesh, od, mvps = blend_inputs(dev, w, h, q, n)
    pre = raster3d.blend_pre(*mesh)
    prep = raster3d.prepare_blended_frame(
        mesh[0], mesh[1], pre[1], w, h, mvps, centres=pre[3], **BLEND_KW)
    args = [prep[k] for k in ("sorted_pad", "starts", "counts", "table",
                              "order")]
    counts = prep["counts"]
    runs = (f"pairs a frame {float(counts.sum()) / n:.0f}, longest run "
            f"{int(counts.max())}, overflow "
            f"{bool(prep['overflow'].any())}")

    def kernel():
        return k7(*args, od, pre[2], (256, 256), bg, w, h, 32, 32)

    def plain():
        return tile_raster.raster_tiles_blend_u8_reference(
            *args, od, pre[2], (256, 256), bg, w, h, 32, 32)

    off_plain = int((kernel() != plain()).sum())
    print(f"[blend] {q} quads at {w}x{h}, {n} frames a launch: K7 vs its "
          f"plain version on the same card tensors: {off_plain} pixel "
          f"words differ", flush=True)
    if off_plain:
        raise AssertionError("K7 differs from its plain version at the "
                             "cell's shape")
    plain_ms = cuda_ms(plain, 1)

    def loop():
        raster3d.render_blended_u8_loop(*mesh, w, h, mvps, opaque_depth=od,
                                        pre=pre, **BLEND_KW)

    kernel_ms = [cuda_ms(kernel, 5, queued=True) for _ in range(2)]
    loop_ms = in_turns({"loop": loop}, reps=3)["loop"]
    scene = {"verts": mesh[0], "faces": mesh[1], "uvs": mesh[2],
             "tex": mesh[3], "bg": bg}
    covered = drawn = 0
    for m in mvps.cpu():
        c, d = quad_blend.fragments(scene, m, w, h, od)
        covered += c
        drawn += d
    work = {"frames": n, "covered": covered, "drawn": drawn,
            "pixels": n * w * h, "frame_bytes": 64,
            "shared_bytes": 256 * 256 * 4 + w * h * 4 + q * 4 * 5 * 4
            + q * 2 * 3 * 4}
    n_bytes, n_ops = roof.work(work)
    bound_ms = 1e3 * max(n_bytes / MEM_BYTES_S,
                         n_ops / PEAK_OPS_S[torch.float32])
    print(f"[blend] {card}: {q} quads at {w}x{h}, {n} frames a launch "
          f"({runs}): K7 {kernel_ms} ms a batch (CUDA events, 5 queued, "
          f"twice), the loop (prep, K7, detile) {loop_ms} ms; covered "
          f"fragments a frame {covered / n:.0f}, drawn {drawn / n:.0f} (z "
          f"test rejects {1 - drawn / covered:.3f}); bound {bound_ms:.4f} "
          f"ms a batch ({n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} G "
          f"operations at {PEAK_OPS_S[torch.float32]:.3g} op/s): K7 at "
          f"{bound_ms / min(kernel_ms):.3f}; the plain version {plain_ms} "
          f"ms a batch; ptxas "
          f"{ptxas_summary(_kernels.build_log('tile_blend'))}", flush=True)

    class Drop:
        def put_frame_u8(self, frame):
            pass

    saved = k7.launches, raster3d.prepare_blended_frame.calls
    k7.launches = 0
    calls = raster3d.prepare_blended_frame.calls
    pipe = MeshVideoPipeline(Drop(), w, h, *[a.cpu().numpy() for a in
                                             (mesh[0], mesh[1])],
                             uvs=mesh[2].cpu().numpy(),
                             tex_u8=mesh[3].cpu().numpy(), blend=True,
                             opaque_depth=od, batch=n, device=dev,
                             **BLEND_KW)
    for _ in range(3):
        for m in mvps.cpu().numpy():
            pipe.submit(m)
    pipe.finish()
    launches = k7.launches
    preps = raster3d.prepare_blended_frame.calls - calls
    k7.launches = saved[0] + launches
    print(f"[blend] MeshVideoPipeline(blend=True), 3 batches of {n}: K7 "
          f"launches {launches}, preps {preps}", flush=True)
    if launches != 3 or preps != 3:
        raise AssertionError("the blended pipeline is not one prep and "
                             "one K7 launch a batch")
    return {"name": "tile_blend", "route": "cuda",
            "source": "libnativecpurenderer_tpu_torch/csrc/tile_blend.cu",
            "replaces": None, "launches": launches, "max_abs_err": 0.0,
            "ms": min(kernel_ms) / n, "plain_ms": plain_ms / n,
            "bound_ms": bound_ms / n,
            "bound_by": ("bytes" if n_bytes / MEM_BYTES_S
                         > n_ops / PEAK_OPS_S[torch.float32]
                         else "operations"),
            "library_ms": None}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA card")
    from libnativecpurenderer_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {card}", flush=True)
    build_kernels(_kernels)
    probe_phase(dev)
    k1 = mesh_phases(dev, card)
    k4 = canvas_phases(dev, card)
    blit_phase(dev)
    tex_rows = textured_phases(dev, card)
    gouraud_rows = gouraud_phases(dev, card, tex_rows[2])
    wf_mxu_rows = wf_mxu_phases(dev, card)
    pipeline_phase(dev, card, k4)
    scatter_row = audio_main_phase(dev, card, audio_ops_phase(dev, card))
    audio_times_phase(dev, card)
    mesh_batch_phase(dev, card)
    blend_row = blend_phase(dev, card)
    print(json.dumps({"kernels": [k1, k4, *tex_rows, *gouraud_rows,
                                  *wf_mxu_rows, scatter_row, blend_row]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
