"""On-card smoke run of the PyTorch port's mesh -> u8 frame path.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
imports nothing of JAX.  Phases, one line each, any failure raising:
  1. device: the card, and its name and power limit from nvidia-smi;
  2. build: K1 (csrc/tile_raster.cu) compiled from the checkout;
  3. kernel vs plain: the per-frame prep of mesh_10k at 1920x1080 (tiles
     32x32, span (5, 3), capacity 1024) for 4 cameras (opaque, no z test)
     and one of them again with opaque=False, z_clip=True, fed to K1 and
     to its plain torch version on the card; the packed (NT, P) outputs
     must be bit-equal.  Then the same at the tile shapes of the kernel's
     other instantiations (1, 2, 8 and 16 pixels a thread, the JAX
     entry's default 128x16 among them), one of them with runs longer
     than the capacity (a flagged overflow, whose reads stay in bounds);
  4. main path: MeshVideoPipeline over 48 frames, batch 16, into a tiled
     sink and into a plain sink, after 3 timed runs of each whose sink
     drops the frames; no overflow, K1 launched once per frame,
     every frame more than 10 % mesh, tiled == plain after the detile, and
     one frame equal to the same frame rendered on the CPU by the plain
     versions;
  5. times on the card: K1 and plain ms/frame (CUDA events), pipeline
     frames/s, peak device memory.
The line before the last is the kernel table as JSON, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

WIDTH, HEIGHT = 1920, 1080
PROD = dict(tile_w=32, tile_h=32, capacity=1024, span_x=5, span_y=3)
FRAMES, BATCH = 48, 16
# (tile_w, tile_h, capacity, opaque, z_clip) for the kernel's other
# pixels-per-thread instantiations; 64x64 with capacity 64 overflows
OTHER_SHAPES = [(16, 16, 1024, False, True), (32, 16, 1024, True, False),
                (128, 16, 2048, False, True), (64, 64, 64, True, True)]


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs a CUDA card")
    from libnativecpurenderer_tpu_torch import MeshVideoPipeline, interop
    from libnativecpurenderer_tpu_torch.models import mesh
    from libnativecpurenderer_tpu_torch.ops import _kernels, raster3d
    from libnativecpurenderer_tpu_torch.ops import tile_raster

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; nvidia-smi: {card}", flush=True)

    t0 = time.perf_counter()
    _kernels.tile_raster()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _kernels.build_log("tile_raster")
             .splitlines() if "registers" in ln or "spill" in ln]
    print(f"[build] tile_raster.cu built and loaded in {build_s:.1f} s; "
          f"ptxas: {' | '.join(ptxas[:4])}", flush=True)

    verts_np, faces_np, colors_np = mesh.mesh_10k()
    verts, faces, colors = interop.mesh_to_torch(verts_np, faces_np,
                                                 colors_np, dev)
    pre = (raster3d.pregather_mesh(verts, faces), colors[faces])

    # 3. K1 against its plain version, same prep, on the card
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
    if tile_raster.raster_tiles_flat_u8.launches != 5 + len(OTHER_SHAPES):
        raise AssertionError("a K1 comparison did not launch the kernel")

    # 4. the main path
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
    if launches != 2 * FRAMES:
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{2 * FRAMES} frames")
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
    print(f"[main path] MeshVideoPipeline {FRAMES} frames x2 (tiled, "
          f"plain): overflow False, K1 launches {launches} = frames "
          f"rendered, mesh covers {min(covered):.3f}..{max(covered):.3f} "
          f"of each frame, tiled == plain; frame {k} vs the CPU plain "
          f"path: {cpu_diff} pixels differ", flush=True)
    if bool(ovf_ref) or cpu_diff:
        raise AssertionError("card frame differs from the CPU plain path")

    # 5. times
    def k1_all():
        for a in preps:
            tile_raster.raster_tiles_flat_u8(*a, opaque=True, z_clip=False)

    def plain_all():
        for a in preps:
            tile_raster.raster_tiles_flat_u8_reference(*a, opaque=True,
                                                       z_clip=False)

    saved = tile_raster.raster_tiles_flat_u8.launches
    k1_ms = cuda_ms(k1_all, 10) / len(preps)
    plain_ms = cuda_ms(plain_all, 2) / len(preps)
    tile_raster.raster_tiles_flat_u8.launches = saved
    print(f"[times] {card}: K1 {k1_ms} ms/frame, plain version "
          f"{plain_ms} ms/frame (1080p mesh_10k, 32x32 tiles, CUDA "
          f"events, mean of 4 cameras); pipeline frames/s, 3 runs of "
          f"{FRAMES} frames, batch {BATCH}, host clock: tiled sink "
          f"{fps[True]}, plain sink {fps[False]}; peak device memory "
          f"{peak_mib} MiB; build {build_s} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "raster_tiles_flat_u8", "route": "cuda",
        "source": "libnativecpurenderer_tpu_torch/csrc/tile_raster.cu",
        "replaces": "libnativecpurenderer_tpu/ops/pallas_raster.py:125",
        "launches": launches, "max_abs_err": max_err,
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
