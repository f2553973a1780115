"""K1's and K3's split walks of two checkouts of the PyTorch port, timed in
turns on one card, so that a change to the tile kernels is measured
against the commit before it.

    python3 tools/torch_walk_turns.py --base DIR

DIR is another checkout of the repo (for example the parent commit,
unpacked with ``git archive``); each package builds its own
``csrc/tile_raster.cu`` into its own ``_build/``, and the two libraries
are loaded side by side in this process.  On 1920x1080 ``mesh_10k`` for
chip_smoke.py's 4 cameras, one frame a launch and the 4 frames in one
launch: K1 at the video shape (32x32, span (5, 3), capacity 1024, opaque,
no z test) and at render_gouraud_u8's defaults (128x16, span (8, 8),
capacity 512, z test), K3 on bench.py's textured mesh (perspective-
correct, z test) at 32x32 and at 128x16.  Both checkouts' outputs must be
bit-equal.  Times are chip_smoke.in_turns: CUDA events, the calls queued
behind a sleep (device time alone), each timed twice in the order base,
this, this, base.  Also prints the registers and spills ptxas reported
for both builds' split walks on the CUDA cores.  Needs a CUDA card and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
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


def fma_split_regs(log: str) -> str:
    """'PPT/ZCLIP/EPI regs spills' of the split walk's CUDA-core
    instantiations (one item a claim) in a ptxas -v log."""
    out = []
    for e in cs.ptxas_summary(log).split("; "):
        # tile_raster_split_kernel<PPT, ZCLIP, EPI[, WALK_FMA, false]>
        m = re.search(r"split_kernelILi(\d+)ELb([01])ELi(\d+)E(Li0ELb0E)?"
                      r"EEv\w*: (.*)", e)
        if m:
            out.append(f"{m.group(1)}/{m.group(2)}/{m.group(3)} "
                       f"{m.group(5)}")
    return "; ".join(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    dev = torch.device("cuda", 0)
    ours = {m: importlib.import_module(f"{PKG}.{m}") for m in
            ("interop", "models.mesh", "ops._kernels", "ops.raster3d",
             "ops.tile_raster")}
    load_base(args.base.resolve())
    base_k = importlib.import_module("base_port.ops._kernels")
    base_tr = importlib.import_module("base_port.ops.tile_raster")
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda k: k.build("tile_raster"),
                      (ours["ops._kernels"], base_k)))
    for name, k in (("base", base_k), ("this", ours["ops._kernels"])):
        k.tile_raster()
        print(f"[walk turns] ptxas, split walk on the CUDA cores, "
              f"PPT/ZCLIP/EPI registers spills, {name}: "
              f"{fma_split_regs(k.build_log('tile_raster'))}", flush=True)
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

    for kernel in ("K1", "K3"):
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
                tail = (tex, tex_dims, bgp, cs.WIDTH, cfg["tile_w"],
                        cfg["tile_h"])
                what = "perspective-correct, z_clip=True"
                calls = {n: (lambda a, t=t: t.raster_tiles_tex_u8(
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
            ratio = [float(np.mean(t[f"this{s}"]) / np.mean(t[f"base{s}"]))
                     for s in ("", " batch")]
            print(f"[walk turns] {card}: {kernel} at {label} ({cfg}, "
                  f"{what}), ms/frame in turns (queued, mean of 4 cameras; "
                  f"'batch' = the 4 frames in one launch; outputs "
                  f"bit-equal): "
                  + "; ".join(f"{k} {x}" for k, x in t.items())
                  + f"; this / base {ratio[0]:.4f}, batched {ratio[1]:.4f}",
                  flush=True)


if __name__ == "__main__":
    main()
