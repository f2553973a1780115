"""K1's, K3's, K2b's, K6's and K2a's split walks, K5 and K4 of two
checkouts of the PyTorch port, timed in turns on one card, so that a
change to the kernels is measured against the commit before it.

    python3 tools/torch_walk_turns.py --base DIR [--approx]

DIR is another checkout of the repo (for example the parent commit,
unpacked with ``git archive``); each package builds its own
``csrc/tile_raster.cu`` and ``csrc/canvas_span.cu`` into its own
``_build/``, and the libraries are loaded side by side in this process.
On 1920x1080 ``mesh_10k`` for
chip_smoke.py's 4 cameras, one frame a launch and the 4 frames in one
launch: K1 at the video shape (32x32, span (5, 3), capacity 1024, opaque,
no z test) and at render_gouraud_u8's defaults (128x16, span (8, 8),
capacity 512, z test), K3 and K2b (``raster_tiles_tex_idx``) on bench.py's
textured mesh (perspective-correct, z test) at 32x32 and at 128x16, K6
(``raster_tiles_rows_u8``) at the video shape on each frame's table rows
gathered in pair order (rows_cap 49152, render_gouraud_pallas_batch's
default).  Both checkouts' outputs must be bit-equal.  Times are
chip_smoke.in_turns: CUDA events, the calls queued behind a sleep (device
time alone), each timed twice in the order base, this, this, base.  Also
prints the registers and spills ptxas reported for both builds' split
walks on the CUDA cores (K1, K3, K2b, K2a, K5, K6: whichever the build
has) and for the one-block-a-tile walk's kernel (``fma_tile``, where a
build still has it).

K2a (``raster_tiles_keys_f32``) at its three main paths' shapes, z test
on: render_textured's prep of bench.py's textured mesh at 128x8 (span
(2, 10), capacity 512) one frame a launch, render_gouraud_pallas
(flat=True)'s at 128x16 (span (8, 8)) one frame a launch and the batch
entry's flat prep at 128x32 (span (8, 4)) with the 4 frames in one
launch; keys and attribute bits equal between the checkouts.

K5 (``raster_tiles_bins_f32``) on render_gouraud_pallas's prep of the same
4 cameras: one frame a launch at its defaults (128x16, capacity 512, span
(8, 8)) and the 4 frames in one launch at the batch entry's (128x32, span
(8, 4)); keys and attribute bits equal between the checkouts.

K4 (``render_span``) at 1920x1080 in float32 and float64 on chip_smoke's
runs: the two arithmetic runs of bench.py's canvas frame and the seeded
64-command frame, each on a fresh copy of a seeded frame, outputs
bit-equal between the checkouts.  With ``--approx``, then, for the
64-command frame, this checkout's kernel against a variant build of the
same source whose division and square root are the approximate ones
(``__fdividef``, ``x * rsqrtf(x)``; in double through float), in turns:
how much of the frame's time the IEEE sequences take (the variant's
values are not the plain version's and are not compared; one more nvcc
build, so it is off by default).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import itertools
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

PKG = "libnativecpurenderer_tpu_torch"
SHAPES = {"32x32": dict(tile_w=32, tile_h=32, capacity=1024, span_x=5,
                        span_y=3),
          "128x16": dict(tile_w=128, tile_h=16, capacity=512, span_x=8,
                         span_y=8)}


def load_base(root: Path):
    """The port's package of the checkout at root, imported as
    ``base_port`` beside this checkout's (it imports itself relatively)."""
    spec = importlib.util.spec_from_file_location(
        "base_port", root / PKG / "__init__.py",
        submodule_search_locations=[str(root / PKG)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["base_port"] = mod
    spec.loader.exec_module(mod)
    return mod


# (EPI, SRC) of the split walk's CUDA-core instantiations, by kernel
SPLIT_KERNELS = {(0, 0): "K1", (1, 0): "K3", (2, 0): "K2b", (3, 0): "K2a",
                 (3, 1): "K5", (0, 2): "K6"}


def fma_split_regs(log: str) -> str:
    """'kernel PPT/ZCLIP[/BOX] regs spills' of the split walk's CUDA-core
    instantiations with one item a claim (K1, K3, K2b, K2a, K5, K6, as the
    build has them) and of the one-block-a-tile walk's kernel
    (tile_raster_kernel<PPT, ZCLIP>, K2a's where a build has it) in a
    ptxas -v log."""
    out = []
    for e in cs.ptxas_summary(log).split("; "):
        # tile_raster_split_kernel<PPT, ZCLIP, EPI[, WALK_FMA, false[,
        # SRC, BOX]]>
        m = re.search(r"split_kernelILi(\d+)ELb([01])ELi(\d+)E(?:Li0ELb0E"
                      r"(?:Li(\d)ELb([01])E)?)?EEv\w*: (.*)", e)
        if m:
            name = SPLIT_KERNELS.get((int(m.group(3)), int(m.group(4) or 0)),
                                     f"EPI {m.group(3)}")
            box = "/box" if m.group(5) == "1" else ""
            out.append(f"{name} {m.group(1)}/{m.group(2)}{box} "
                       f"{m.group(6)}")
        m = re.search(r"tile_raster_kernelILi(\d+)ELb([01])EEEv\w*: (.*)", e)
        if m:
            out.append(f"fma_tile (K2a) {m.group(1)}/{m.group(2)} "
                       f"{m.group(3)}")
    return "; ".join(sorted(out))


def turns_line(card, what, t):
    """One line of in-turns times (name -> [first, second]) with the
    ratio this / base, one call and batched where both are timed."""
    ratio = [f"{s or 'one'} {np.mean(t[f'this{s}']) / np.mean(t[f'base{s}']):.4f}"
             for s in ("", " batch") if f"this{s}" in t]
    print(f"[walk turns] {card}: {what}: "
          + "; ".join(f"{k} {x}" for k, x in t.items())
          + f"; this / base {', '.join(ratio)}", flush=True)


def k5_turns(card, dev, ours, base_tr, mvps, verts, faces, pre):
    """K5 of both checkouts on the 4 cameras, in turns."""
    r3, tr = ours["ops.raster3d"], ours["ops.tile_raster"]
    F = faces.shape[0]
    for label, cfg, batched in (
            ("128x16", dict(tile_w=128, tile_h=16, capacity=512, span_x=8,
                            span_y=8), False),
            ("128x32", dict(tile_w=128, tile_h=32, capacity=512, span_x=8,
                            span_y=4), True)):
        preps = []
        for m in mvps:
            tri, attrs, edges = r3._setup_edges(
                verts, faces, m, cs.WIDTH, cs.HEIGHT, v4f=pre[0],
                attrs=pre[1])
            bins, counts, ovf = r3.bin_triangles(
                tri["sxy"], edges[-1], cs.WIDTH, cs.HEIGHT, cfg["tile_w"],
                cfg["tile_h"], cfg["capacity"], cfg["span_x"],
                cfg["span_y"])
            if bool(ovf):
                raise AssertionError(f"K5's bins overflow at {label}")
            preps.append((torch.where(bins == r3.NO_TRI, F, bins), counts,
                          tr.build_table(*edges, attrs)))
        tail = (cs.WIDTH, cfg["tile_w"], cfg["tile_h"])
        four = tuple(torch.stack([p[i] for p in preps]) for i in range(3))
        calls = {n: t.raster_tiles_bins_f32
                 for n, t in (("base", base_tr), ("this", tr))}
        outs = {n: [call(*p, *tail) for p in preps] + [call(*four, *tail)]
                for n, call in calls.items()}
        torch.cuda.synchronize()
        bad = sum(cs.same_bits(a, b)
                  for x, y in zip(outs["base"], outs["this"])
                  for a, b in zip(x, y))
        if bad:
            raise AssertionError(f"K5 at {label}: the checkouts differ on "
                                 f"{bad} values")
        fns = {}
        for n, call in calls.items():
            if batched:
                fns[f"{n} batch"] = lambda call=call: call(*four, *tail)
            else:
                fns[n] = lambda call=call: [call(*p, *tail) for p in preps]
        t = {k: [x / len(preps) for x in vs]
             for k, vs in cs.in_turns(fns).items()}
        turns_line(card, f"K5 at {label} ({cfg}), ms/frame in turns "
                   f"(queued, mean of 4 cameras; 'batch' = the 4 frames in "
                   f"one launch; keys and attribute bits equal)", t)


def k2a_turns(card, ours, base_tr, mvps, verts, faces, colors, tex_mesh):
    """K2a of both checkouts on the 4 cameras at its three main paths'
    shapes, in turns (see the module docstring); ``tex_mesh`` = (verts,
    faces, face uvs) of the textured scene."""
    r3, tr = ours["ops.raster3d"], ours["ops.tile_raster"]
    keys = ("sorted_pad", "starts", "counts", "table")
    shapes = (
        ("128x8 (render_textured)", cs.defaults(r3.render_textured), True,
         False),
        ("128x16 (render_gouraud_pallas(flat=True))",
         cs.defaults(r3.render_gouraud_pallas), False, False),
        ("128x32 (render_gouraud_pallas_batch(flat=True))",
         cs.defaults(r3.render_gouraud_pallas_batch), False, True))
    tv, tf, fuv = tex_mesh
    for label, cfg, textured, batched in shapes:
        if textured:
            preps = [r3.prepare_textured_frame(
                tv, tf, fuv, cs.WIDTH, cs.HEIGHT, m, perspective_correct=True,
                z_clip=True, exact_c=False, **cfg) for m in mvps]
        else:
            preps = [r3.prepare_frame(verts, faces, colors, cs.WIDTH,
                                      cs.HEIGHT, m, z_clip=True,
                                      exact_c=False, **cfg) for m in mvps]
        if any(bool(p["overflow"]) for p in preps):
            raise AssertionError(f"a K2a prep overflows at {label}")
        tail = (cs.WIDTH, cfg["tile_w"], cfg["tile_h"])
        one = [tuple(p[k] for k in keys) for p in preps]
        four = tuple(torch.stack([p[k] for p in preps]) for k in keys)
        calls = {n: t.raster_tiles_keys_f32 for n, t in (("base", base_tr),
                                                          ("this", tr))}
        outs = {n: [call(*a, *tail, z_clip=True) for a in one]
                + [call(*four, *tail, z_clip=True)]
                for n, call in calls.items()}
        torch.cuda.synchronize()
        bad = sum(cs.same_bits(a, b)
                  for x, y in zip(outs["base"], outs["this"])
                  for a, b in zip(x, y))
        if bad:
            raise AssertionError(f"K2a at {label}: the checkouts differ on "
                                 f"{bad} values")
        fns = {}
        for n, call in calls.items():
            if batched:
                fns[f"{n} batch"] = lambda call=call: call(*four, *tail,
                                                           z_clip=True)
            else:
                fns[n] = lambda call=call: [call(*a, *tail, z_clip=True)
                                            for a in one]
        t = {k: [x / len(one) for x in vs]
             for k, vs in cs.in_turns(fns).items()}
        turns_line(card, f"K2a at {label} ({cfg}, z test on), ms/frame in "
                   f"turns (queued, mean of 4 cameras; 'batch' = the 4 "
                   f"frames in one launch; keys and attribute bits equal)",
                   t)


def k6_turns(card, ours, base_tr, mvps, verts, faces, colors, pre):
    """K6 of both checkouts on the 4 cameras at the video shape, each
    frame's table rows gathered in pair order (rows_cap 49152), one frame
    a launch and the 4 frames in one, in turns."""
    r3, tr = ours["ops.raster3d"], ours["ops.tile_raster"]
    cfg, rows_cap = SHAPES["32x32"], 49152
    preps = [r3.prepare_frame(verts, faces, colors, cs.WIDTH, cs.HEIGHT, m,
                              z_clip=False, pre=pre, **cfg) for m in mvps]
    if any(bool(p["overflow"]) for p in preps):
        raise AssertionError("a K6 prep overflows")
    rows = cs.gathered_rows(torch.stack([p["sorted_pad"] for p in preps]),
                            torch.stack([p["table"] for p in preps]),
                            rows_cap)
    starts, counts = (torch.stack([p[k] for p in preps])
                      for k in ("starts", "counts"))
    if bool((starts[:, -1] + counts[:, -1] > rows_cap).any()):
        raise AssertionError("the K6 runs end past rows_cap")
    tail = (preps[0]["packed_bg"], cs.WIDTH, cfg["tile_w"], cfg["tile_h"])
    calls = {n: t.raster_tiles_rows_u8 for n, t in (("base", base_tr),
                                                     ("this", tr))}
    one = [(rows[i:i + 1], starts[i:i + 1], counts[i:i + 1])
           for i in range(len(preps))]
    outs = {n: (torch.cat([call(*a, *tail) for a in one]),
                call(rows, starts, counts, *tail))
            for n, call in calls.items()}
    torch.cuda.synchronize()
    bad = [cs.same_bits(outs["base"][i], outs["this"][i]) for i in range(2)]
    if any(bad):
        raise AssertionError(f"K6: the checkouts differ on {bad} pixels")
    fns = {}
    for n, call in calls.items():
        fns[n] = lambda call=call: [call(*a, *tail) for a in one]
        fns[f"{n} batch"] = lambda call=call: call(rows, starts, counts,
                                                   *tail)
    t = {k: [x / len(one) for x in vs] for k, vs in cs.in_turns(fns).items()}
    turns_line(card, f"K6 at 32x32 ({cfg}, rows_cap {rows_cap}, opaque, no "
               f"z test), ms/frame in turns (queued, mean of 4 cameras; "
               f"'batch' = the 4 frames in one launch; outputs bit-equal)",
               t)


def k4_runs(dev):
    """chip_smoke's K4 runs at 1920x1080: {label: (kinds, params)}."""
    from libnativecpurenderer_tpu_torch import RenderContext, Texture
    from libnativecpurenderer_tpu_torch.ops import executor
    rng = np.random.default_rng(0)
    texs = [Texture._from_array(rng.random((128, 128, 4)), True)
            for _ in range(4)]
    rec = RenderContext(cs.WIDTH, cs.HEIGHT, True, device=dev)
    cs.bench_draw(rec, texs, 0.0)
    bk, bp = (np.array(a) for a in rec._cmds.snapshot())
    rec._cmds.clear()
    # the arithmetic runs, which K4 takes in every checkout
    runs, lo = {}, 0
    for arith, group in itertools.groupby(
            bk.tolist(), lambda k: k not in executor.SAMPLING_KINDS):
        n = len(list(group))
        if arith:
            runs[f"bench run {len(runs) + 1} ({n} cmds)"] = (
                bk[lo:lo + n], bp[lo:lo + n])
        lo += n
    runs["64-cmd frame"] = cs.frame64(rec, 7)
    return runs


def approx_canvas_lib(k):
    """This checkout's canvas_span.cu built with approximate division and
    square root (see the module docstring), loaded; its entry takes the
    same arguments."""
    import ctypes
    import subprocess
    src = (k.CSRC / "canvas_span.cu").read_text()
    subs = {
        "{ return __fdiv_rn(a, b); }": "{ return __fdividef(a, b); }",
        "{ return __fsqrt_rn(a); }": "{ return __fmul_rn(a, rsqrtf(a)); }",
        "{ return __ddiv_rn(a, b); }":
            "{ return (double)__fdividef((float)a, (float)b); }",
        "{ return __dsqrt_rn(a); }":
            "{ return (double)__fmul_rn((float)a, rsqrtf((float)a)); }"}
    for old, new in subs.items():
        if src.count(old) != 1:
            raise AssertionError(f"canvas_span.cu has no single {old!r}")
        src = src.replace(old, new)
    k.BUILD_DIR.mkdir(exist_ok=True)
    cu = k.BUILD_DIR / "canvas_span_approx.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    subprocess.run([k._nvcc(), *k.NVCC_FLAGS, "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.canvas_span.argtypes = k.canvas_span().canvas_span.argtypes
    lib.canvas_span.restype = ctypes.c_int
    return lib


def k4_turns(card, dev, ours, base_ck, approx: bool):
    """K4 of both checkouts on chip_smoke's runs, in turns; then, with
    ``approx``, the IEEE division and square root against approximate
    ones."""
    ck, k = ours["ops.canvas_kernel"], ours["ops._kernels"]
    runs = k4_runs(dev)
    gen = torch.Generator().manual_seed(1)
    seed = torch.rand((cs.HEIGHT, cs.WIDTH, 4), generator=gen,
                      dtype=torch.float64)
    approx_lib = approx_canvas_lib(k) if approx else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    for dtype in (torch.float32, torch.float64):
        fb0 = seed.to(dtype).to(dev)
        npd = np.float32 if dtype == torch.float32 else np.float64
        for label, (kinds, params) in runs.items():
            ph = params.astype(npd)
            kt = torch.from_numpy(kinds.astype(np.int32))
            pt = torch.from_numpy(ph).to(dev)
            calls = {"base": lambda fb: base_ck.render_span(fb, kt, pt, ph),
                     "this": lambda fb: ck.render_span(fb, kt, pt, ph)}
            outs = {n: call(fb0.clone()) for n, call in calls.items()}
            torch.cuda.synchronize()
            bad = cs.same_bits(outs["base"], outs["this"])
            if bad:
                raise AssertionError(f"K4 {label}: the checkouts differ "
                                     f"on {bad} values")
            fbs = {n: fb0.clone() for n in calls}
            t = cs.in_turns({n: (lambda n=n: calls[n](fbs[n]))
                             for n in calls}, reps=20)
            turns_line(card, f"K4 {label} {str(dtype)[6:]} 1920x1080, "
                       f"ms/launch in turns (queued; outputs bit-equal)", t)
            if approx_lib is None or not label.startswith("64"):
                continue
            kd = kt.to(dev)
            tiles = ck.touched_tiles(kinds, ph, cs.WIDTH, cs.HEIGHT)
            td = None if tiles is None else torch.from_numpy(tiles).to(dev)
            fb = fb0.clone()

            def raw(lib):
                err = lib.canvas_span(
                    fb.data_ptr(), cs.WIDTH, cs.HEIGHT, kd.data_ptr(),
                    pt.data_ptr(), kd.numel(),
                    0 if td is None else td.data_ptr(),
                    0 if td is None else td.numel(), 0, 0, 0,
                    int(dtype == torch.float64), stream)
                if err:
                    raise RuntimeError(f"canvas_span failed: {err}")

            t = cs.in_turns({"IEEE": lambda: raw(k.canvas_span()),
                             "approximate": lambda: raw(approx_lib)}, reps=20)
            print(f"[walk turns] {card}: K4 {label} {str(dtype)[6:]} with "
                  f"IEEE against approximate division and square root, "
                  f"ms/launch in turns (queued): "
                  + "; ".join(f"{n} {x}" for n, x in t.items())
                  + f"; IEEE / approximate "
                  f"{np.mean(t['IEEE']) / np.mean(t['approximate']):.4f}",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--approx", action="store_true",
                    help="also time K4's 64-command frame against a build "
                         "with approximate division and square root")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    dev = torch.device("cuda", 0)
    ours = {m: importlib.import_module(f"{PKG}.{m}") for m in
            ("interop", "models.mesh", "ops._kernels", "ops.raster3d",
             "ops.tile_raster", "ops.canvas_kernel")}
    load_base(args.base.resolve())
    base_k = importlib.import_module("base_port.ops._kernels")
    base_tr = importlib.import_module("base_port.ops.tile_raster")
    base_ck = importlib.import_module("base_port.ops.canvas_kernel")
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda a: a[0].build(a[1]),
                      [(k, n) for k in (ours["ops._kernels"], base_k)
                       for n in ("tile_raster", "canvas_span")]))
    for name, k in (("base", base_k), ("this", ours["ops._kernels"])):
        k.tile_raster()
        k.canvas_span()
        print(f"[walk turns] ptxas, split walk on the CUDA cores, one item "
              f"a claim, kernel PPT/ZCLIP[/box] registers spills, {name}: "
              f"{fma_split_regs(k.build_log('tile_raster'))}", flush=True)
        print(f"[walk turns] ptxas, K4, {name}: "
              f"{cs.ptxas_summary(k.build_log('canvas_span'))}", flush=True)
    log = ours["ops._kernels"].build_log("tile_raster")
    print(f"[walk turns] this: {cs.check_k5_build(log)}; "
          f"{cs.check_k2b_k6_build(log)}; {cs.check_k2a_build(log)}",
          flush=True)
    card = cs.nvidia_smi()
    mesh, interop = ours["models.mesh"], ours["interop"]
    r3, tr = ours["ops.raster3d"], ours["ops.tile_raster"]
    v, f, c = mesh.mesh_10k()
    verts, faces, colors = interop.mesh_to_torch(v, f, c, dev)
    pre = (r3.pregather_mesh(verts, faces), colors[faces])
    mvps = [torch.from_numpy(cs.camera(mesh, k, 0.45)).to(dev)
            for k in range(4)]
    tv_np, tf_np, tu_np, tt_np = cs.textured_scene()
    tv, tf, tu, tt = interop.textured_mesh_to_torch(tv_np, tf_np, tu_np,
                                                    tt_np, dev)
    v4f, fuv = r3.pregather_mesh(tv, tf), tu[tf]
    tex = r3.pack_texture_u8(tt)
    tex_dims = tuple(tt.shape[:2])
    bgp = tr.pack_bg(torch.tensor([0.5, 0.25, 0.75, 0.0], device=dev))
    keys = ("sorted_pad", "starts", "counts", "table")

    for kernel in ("K1", "K3", "K2b"):
        for label, cfg in SHAPES.items():
            if kernel == "K1":
                opaque = label == "32x32"
                preps = [r3.prepare_frame(verts, faces, colors, cs.WIDTH,
                                          cs.HEIGHT, m, z_clip=not opaque,
                                          pre=pre, **cfg) for m in mvps]
                tail = (preps[0]["packed_bg"], cs.WIDTH, cfg["tile_w"],
                        cfg["tile_h"])
                kw = dict(opaque=opaque, z_clip=not opaque)
                what = f"opaque={opaque}, z_clip={not opaque}"
                calls = {n: (lambda a, t=t: t.raster_tiles_flat_u8(*a, **kw))
                         for n, t in (("base", base_tr), ("this", tr))}
            else:
                preps = [r3.prepare_textured_frame(
                    tv, tf, fuv, cs.WIDTH, cs.HEIGHT, m,
                    perspective_correct=True, z_clip=True, v4f=v4f, **cfg)
                    for m in mvps]
                what = "perspective-correct, z_clip=True"
                if kernel == "K3":
                    tail = (tex, tex_dims, bgp, cs.WIDTH, cfg["tile_w"],
                            cfg["tile_h"])
                    calls = {n: (lambda a, t=t: t.raster_tiles_tex_u8(
                        *a, z_clip=True)) for n, t in (("base", base_tr),
                                                       ("this", tr))}
                else:
                    tail = (tex_dims, cs.WIDTH, cfg["tile_w"], cfg["tile_h"])
                    calls = {n: (lambda a, t=t: t.raster_tiles_tex_idx(
                        *a, z_clip=True)) for n, t in (("base", base_tr),
                                                       ("this", tr))}
            if any(bool(p["overflow"]) for p in preps):
                raise AssertionError(f"a prep overflows at {cfg}")
            one = [tuple(p[k] for k in keys) + tail for p in preps]
            four = tuple(torch.stack([p[k] for p in preps])
                         for k in keys) + tail
            outs = {n: (torch.stack([call(a) for a in one]), call(four))
                    for n, call in calls.items()}
            torch.cuda.synchronize()
            bad = [int((outs["base"][i] != outs["this"][i]).sum())
                   for i in range(2)]
            if any(bad):
                raise AssertionError(f"{kernel} at {label}: the checkouts "
                                     f"differ on {bad} pixels")
            fns = {}
            for n, call in calls.items():
                fns[n] = lambda call=call: [call(a) for a in one]
                fns[f"{n} batch"] = lambda call=call: call(four)
            t = {k: [x / len(one) for x in vs]
                 for k, vs in cs.in_turns(fns).items()}
            turns_line(card, f"{kernel} at {label} ({cfg}, {what}), ms/frame "
                       f"in turns (queued, mean of 4 cameras; 'batch' = the "
                       f"4 frames in one launch; outputs bit-equal)", t)
    k6_turns(card, ours, base_tr, mvps, verts, faces, colors, pre)
    k2a_turns(card, ours, base_tr, mvps, verts, faces, colors, (tv, tf, fuv))
    k5_turns(card, dev, ours, base_tr, mvps, verts, faces, pre)
    k4_turns(card, dev, ours, base_ck, args.approx)


if __name__ == "__main__":
    main()
