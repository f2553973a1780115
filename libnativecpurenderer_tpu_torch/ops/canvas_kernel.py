"""Canvas command runs: kernel K4.

Counterpart of ``libnativecpurenderer_tpu/ops/canvas_kernel.py``: the
TPU tile kernel ``_make_kernel`` (``:52``) launched by
``render_span_kernel`` (``pl.pallas_call`` at ``:286``), widened to the
texture blits (TEX, TEX_FAST, SPLIT_TEX), which the TPU flush ran through
its executor.  Its tiled planar framebuffer (``tile_fb``/``detile_fb``),
per-tile command bins and command-count buckets are TPU layout and
compile machinery and are not ported.

:func:`render_span` is the wrapper: on CUDA tensors it launches the
hand-written kernel in ``csrc/canvas_span.cu`` (or raises) over the tiles
:func:`touched_tiles` lists, on CPU tensors it runs
:func:`render_span_reference`, the executor's branches
(``ops/executor.py``) applied command by command over the full frame.
The two are bit-identical on the card.  Both update the framebuffer in
place.  The wrapper counts its kernel launches in
``render_span.launches`` and the texture commands of the runs it takes
in ``render_span.sampled``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import commands as C
from . import executor

# the kinds whose colour is computed from the params alone
ARITH_KINDS = frozenset((
    C.KIND_NOOP, C.KIND_SET_COLOR, C.KIND_FILL, C.KIND_RECT,
    C.KIND_CIRCLE, C.KIND_LINE, C.KIND_VGRD, C.KIND_SET_PIXEL,
    C.KIND_APPLY_PIXEL))
# the texture blits: a nearest texel of the atlas
TEXTURE_KINDS = frozenset((C.KIND_TEX, C.KIND_TEX_FAST, C.KIND_SPLIT_TEX))
# kinds this kernel can execute (all but HITEFFECT, whose noise shader
# stays in the executor)
KERNEL_KINDS = ARITH_KINDS | TEXTURE_KINDS

# the kernel's tile edge (csrc/canvas_span.cu TILE)
TILE = 32
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def kernel_runs(kind_list):
    """(lo, hi) of each maximal run of ``KERNEL_KINDS`` in a recorded
    kind list: the K4 calls a flush makes."""
    runs, i, n = [], 0, len(kind_list)
    while i < n:
        j = i + 1
        if kind_list[i] in KERNEL_KINDS:
            while j < n and kind_list[j] in KERNEL_KINDS:
                j += 1
            runs.append((i, j))
        i = j
    return runs


# the kinds whose mask lies in their box (p[6:10]) and at their pixel
# (p[14], p[15])
_BOX_KINDS = (C.KIND_SET_COLOR, C.KIND_RECT, C.KIND_CIRCLE, C.KIND_LINE,
              C.KIND_VGRD, C.KIND_TEX, C.KIND_TEX_FAST, C.KIND_SPLIT_TEX)
_PIXEL_KINDS = (C.KIND_SET_PIXEL, C.KIND_APPLY_PIXEL)


def tiles_touched(kind, p, width: int, height: int):
    """The kernel's culling test (``touches`` in csrc/canvas_span.cu) on
    the host: a (ceil(H/TILE), ceil(W/TILE)) bool array of the tiles whose
    pixels the command's mask may admit.  ``p`` is the command's numpy
    params row; the test is made in its dtype, as the kernel makes it in
    the frame's."""
    ox = np.arange(0, width, TILE).astype(p.dtype)[None, :]
    oy = np.arange(0, height, TILE).astype(p.dtype)[:, None]
    ex, ey = ox + p.dtype.type(TILE), oy + p.dtype.type(TILE)
    shape = (oy.size, ox.size)
    if kind == C.KIND_FILL:
        return np.ones(shape, bool)
    if kind in _BOX_KINDS:
        return (p[7] > ox) & (p[6] < ex) & (p[9] > oy) & (p[8] < ey)
    if kind in _PIXEL_KINDS:
        return (p[14] >= ox) & (p[14] < ex) & (p[15] >= oy) & (p[15] < ey)
    return np.zeros(shape, bool)


def touched_tiles(kinds, p, width: int, height: int):
    """The tiles K4 launches a block for: the union over the run of
    :func:`tiles_touched`, vectorised, as ascending int32 tile ids
    ty * ceil(W / TILE) + tx; None when a FILL touches every tile (the
    whole grid).  ``kinds`` (N,) ints, ``p`` the (N, PARAM_W) host params
    in the frame's dtype; each test is the kernel's, a conjunction of a
    column test and a row test, made in p's dtype."""
    kinds = np.asarray(kinds)
    if (kinds == C.KIND_FILL).any():
        return None
    edge = p.dtype.type(TILE)
    ox = np.arange(0, width, TILE).astype(p.dtype)
    oy = np.arange(0, height, TILE).astype(p.dtype)
    cols = np.zeros((kinds.size, ox.size), bool)
    rows = np.zeros((kinds.size, oy.size), bool)
    box, pix = np.isin(kinds, _BOX_KINDS), np.isin(kinds, _PIXEL_KINDS)
    q = p[box]
    cols[box] = (q[:, 7:8] > ox) & (q[:, 6:7] < ox + edge)
    rows[box] = (q[:, 9:10] > oy) & (q[:, 8:9] < oy + edge)
    q = p[pix]
    cols[pix] = (q[:, 14:15] >= ox) & (q[:, 14:15] < ox + edge)
    rows[pix] = (q[:, 15:16] >= oy) & (q[:, 15:16] < oy + edge)
    union = rows.T.astype(np.int32) @ cols.astype(np.int32)
    return np.flatnonzero(union).astype(np.int32)


def _check_inputs(fb, kinds, params):
    if fb.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fb must be float32 or float64, got {fb.dtype}")
    if fb.dim() != 3 or fb.shape[2] != 4:
        raise ValueError(f"fb must be (H, W, 4), got {tuple(fb.shape)}")
    if not fb.is_contiguous():
        raise ValueError("fb must be contiguous")
    if params.dtype != fb.dtype:
        raise TypeError(f"params are {params.dtype}, fb is {fb.dtype}")
    if params.device != fb.device:
        raise ValueError(f"params are on {params.device}, fb on "
                         f"{fb.device}")
    if (params.dim() != 2 or params.shape[1] != C.PARAM_W
            or not params.is_contiguous()):
        raise ValueError(f"params must be a contiguous (N, {C.PARAM_W}), "
                         f"got {tuple(params.shape)}")
    if kinds.device.type != "cpu" or kinds.dtype != torch.int32:
        raise ValueError("kinds must be a host int32 tensor: they were "
                         "recorded and routed on the host")
    if kinds.shape != (params.shape[0],):
        raise ValueError(f"kinds {tuple(kinds.shape)} and params "
                         f"{tuple(params.shape)} disagree")
    bad = set(kinds.tolist()) - KERNEL_KINDS
    if bad:
        raise ValueError(f"kinds {sorted(bad)} are not K4's kinds: it "
                         f"takes only {sorted(KERNEL_KINDS)}")


def _check_atlas(atlas, fb):
    if atlas is None:
        raise ValueError("the run holds texture blits: the atlas is "
                         "required")
    if atlas.dtype != fb.dtype:
        raise TypeError(f"atlas is {atlas.dtype}, fb is {fb.dtype}")
    if atlas.device != fb.device:
        raise ValueError(f"atlas is on {atlas.device}, fb on {fb.device}")
    if atlas.dim() != 3 or atlas.shape[2] != 4 or not atlas.is_contiguous():
        raise ValueError(f"atlas must be a contiguous (AH, AW, 4), got "
                         f"{tuple(atlas.shape)}")
    if fb.device.type == "cuda" and atlas.data_ptr() % 16:
        raise ValueError("atlas must be 16-byte aligned (texels are read "
                         "16 bytes at a time)")


def render_span(fb, kinds, params, host_params=None, atlas=None):
    """Kernel K4: apply a run of canvas commands to ``fb`` in place, and
    return ``fb``.

    fb: contiguous (H, W, 4) float32 or float64; kinds: (N,) host int32
    tensor of ``KERNEL_KINDS``; params: contiguous (N, PARAM_W) in
    fb.dtype on fb's device; host_params: the same params as a host
    numpy array (the flush holds one), from which the tiles to launch are
    listed; required unless fb is on the CPU.  Only its shape and dtype
    are checked against ``params``: its values must be theirs, or the
    kernel skips tiles the params touch.  atlas: the contiguous
    (AH, AW, 4) atlas in fb.dtype on fb's device, 16-byte aligned,
    required when the run holds a texture blit (``TEXTURE_KINDS``) and
    unread otherwise.  For every pixel, in recorded order, each command
    whose mask admits it blends its colour in, exactly as
    :func:`executor.render_commands` does.

    CUDA tensors launch the kernel on the current stream over the tiles
    :func:`touched_tiles` lists, after one non-blocking upload of the
    kinds and that list from pinned memory (no sync); a run that touches
    no tile launches nothing.  CPU tensors run
    :func:`render_span_reference`."""
    _check_inputs(fb, kinds, params)
    k = kinds.numpy()
    dev = fb.device
    if host_params is None:
        if dev.type != "cpu":
            raise ValueError("host_params are required off the CPU: the "
                             "tiles to launch are listed from them")
    elif (host_params.shape != tuple(params.shape)
          or host_params.dtype != _NP_DTYPES[params.dtype]):
        raise ValueError(f"host_params {host_params.shape} "
                         f"{host_params.dtype} are not the params' host "
                         f"copy")
    n_tex = int(np.isin(k, sorted(TEXTURE_KINDS)).sum())
    if n_tex:
        _check_atlas(atlas, fb)
    else:
        atlas = None
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no K4 kernel for device {dev}")
    render_span.sampled += n_tex
    if dev.type == "cpu":
        return render_span_reference(fb, kinds, params, atlas)
    n = k.size
    if n == 0:
        return fb
    if fb.data_ptr() % 16:
        raise ValueError("fb must be 16-byte aligned (pixels are moved 16 "
                         "bytes at a time)")
    height, width = fb.shape[0], fb.shape[1]
    tiles = touched_tiles(k, host_params, width, height)
    if tiles is not None and tiles.size == 0:
        return fb
    ntx, nty = -(-width // TILE), -(-height // TILE)
    if tiles is not None and tiles.size == ntx * nty:
        tiles = None
    n_tiles = 0 if tiles is None else tiles.size
    host = kinds if tiles is None else torch.cat(
        [kinds, torch.from_numpy(tiles)])
    from . import _kernels
    up = host.pin_memory().to(dev, non_blocking=True)
    ah, aw = (0, 0) if atlas is None else atlas.shape[:2]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _kernels.launch_canvas_span(
            fb.data_ptr(), width, height, up.data_ptr(), params.data_ptr(),
            n, up.data_ptr() + 4 * n if n_tiles else 0, n_tiles,
            0 if atlas is None else atlas.data_ptr(), ah, aw,
            fb.dtype == torch.float64, stream)
    render_span.launches += 1
    return fb


render_span.launches = 0
render_span.sampled = 0


def render_span_reference(fb, kinds, params, atlas=None):
    """Plain torch version of K4: the executor's branches applied command
    by command over the full frame, in place; returns ``fb``."""
    return executor.render_commands(fb, kinds.tolist(), params, atlas)
