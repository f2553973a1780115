"""K2a on the split walk (``csrc/tile_raster.cu``), as the plain mirror of
tests/test_torch_walk_split.py on the CPU.

K2a computes K5's outputs (the key and the four float attributes of each
pixel's winner, SKY_KEY and zeros for sky) with its rows from the sorted
pairs, so it walks K1's runs and items (B * nt + B * ids_len // S items
in the list) with K5's epilogue; at tiles 128 wide, each of its main
paths' shapes, each warp walks only the rows the cull keeps for its box
(``tile_raster.warp_boxes``, ``tile_raster.cull_keep``), as K5 does.
The mirror (:func:`test_torch_walk_split.split_walk` with ``cull``) is
held bit for bit, keys and float bits, to
``raster_tiles_keys_f32_reference`` for S in 1..128, with the z test on
and off, on runs at the split's boundaries (1, S, S + 1, 2S, 2S + 1 and
1024 slots, NaN rows, depths outside [0, 1]) at 128x8, 128x16, 128x32
and 32x32 (no boxes), knife-edge rows on the warp boxes' borders, a run
read past the pair array, runs that overlap past the item list's
capacity (the plan's fallback: every tile one item of its whole run),
``mesh_10k`` at a small frame (the textured table at render_textured's
128x8, the Gouraud table at render_gouraud_pallas's 128x16), one frame
and 4 in one launch.  ``tile_raster.pairs_cull_keep``, the count of
kept (row, warp) pairs behind K2a's bound, is held to a brute-force
count in numpy, and a (row, box) it culls is never covered by the walk.
The kernel itself is held to the plain version on the card by
``chip_smoke.py`` (phases 10, 11, 13 and 14).
"""

import functools

import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu_torch import interop
from libnativecpurenderer_tpu_torch.models import mesh
from libnativecpurenderer_tpu_torch.ops import raster3d as r3
from libnativecpurenderer_tpu_torch.ops import tile_raster as tt
from libnativecpurenderer_tpu_torch.testing import crafted_runs
from test_torch_walk_split import (SEGS, _box_covered, _warp_box, plan,
                                   split_walk)

torch.set_num_threads(1)


def _lengths(seg):
    return [1, seg, seg + 1, 2 * seg, 2 * seg + 1, 1024]


def _crafted(seg, tile, seed, **kw):
    sp, st, ct, table, width = crafted_runs(_lengths(seg), *tile,
                                            seed=seed, **kw)
    return sp, st, ct, table, width, tile


def _overlapping(seg, tile):
    """Every tile's run the whole pair array: the runs overlap, the item
    list outgrows its capacity and the plan makes every tile one item."""
    sp, st, ct, table, width, _ = _crafted(seg, tile, seg + 5)
    n = int(ct.sum())
    return (sp, torch.zeros_like(st), torch.full_like(ct, n), table, width,
            tile)


def _four_frames(seg, tile):
    """Boundary runs from 4 seeds stacked as 4 frames, frame 1's last
    run read 300 slots past its pair array, frame 2's rows knife-edged."""
    cases = [crafted_runs(_lengths(seg), *tile, seed=30 + i,
                          past_end=300 if i == 1 else 0, knife=i == 2)
             for i in range(4)]
    return tuple(torch.stack([c[i] for c in cases]) for i in range(4)) + (
        cases[0][4], tile)


@functools.lru_cache(maxsize=None)
def _mesh_prep(textured: bool):
    """mesh_10k at 256x160 through the prep of K2a's entries: the textured
    table (bench.py's planar uvs, perspective-correct) at
    render_textured's 128x8, span (2, 10), or the Gouraud table at
    render_gouraud_pallas's 128x16, span (8, 8); exact_c off and the z
    test on, as those entries make them."""
    v, f, c = mesh.mesh_10k()
    m = torch.from_numpy((mesh.perspective(1.0, 256 / 160, 0.1, 10.0)
                          @ mesh.look_at([0.0, 0.6, 3.2], [0, 0, 0],
                                         [0, 1, 0])
                          @ mesh.rotation_y(0.45)).astype(np.float32))
    if textured:
        uvs = (v[:, :2] - v[:, :2].min(0)) / np.ptp(v[:, :2], 0)
        verts, faces, uv, _ = interop.textured_mesh_to_torch(
            v, f, uvs, np.zeros((8, 8, 4), np.uint8), "cpu")
        prep = r3.prepare_textured_frame(
            verts, faces, uv[faces], 256, 160, m, tile_w=128, tile_h=8,
            capacity=4096, span_x=2, span_y=10, perspective_correct=True,
            z_clip=True, exact_c=False)
        tile = (128, 8)
    else:
        verts, faces, colors = interop.mesh_to_torch(v, f, c, "cpu",
                                                     torch.float32)
        prep = r3.prepare_frame(verts, faces, colors, 256, 160, m,
                                tile_w=128, tile_h=16, capacity=4096,
                                span_x=8, span_y=8, z_clip=True,
                                exact_c=False)
        tile = (128, 16)
    assert not bool(prep["overflow"])
    return (prep["sorted_pad"], prep["starts"], prep["counts"],
            prep["table"], 256, tile)


KEYS_CASES = {
    "boundaries 128x8": lambda s: _crafted(s, (128, 8), s),
    "boundaries 128x16": lambda s: _crafted(s, (128, 16), s + 1),
    "boundaries 128x32": lambda s: _crafted(s, (128, 32), s + 2),
    "boundaries 32x32": lambda s: _crafted(s, (32, 32), s + 3),
    "knife edges 128x16": lambda s: _crafted(s, (128, 16), s + 4,
                                             knife=True),
    "past the pair array 128x8": lambda s: _crafted(s, (128, 8), s,
                                                    past_end=300),
    "overlapping runs 128x16": lambda s: _overlapping(s, (128, 16)),
    "textured mesh_10k 128x8": lambda s: _mesh_prep(True),
    "mesh_10k 128x16": lambda s: _mesh_prep(False),
    "4 frames 128x32": lambda s: _four_frames(s, (128, 32))}


def _cap(sp, ct, seg):
    """The item list's capacity at S = seg: the wrapper's
    B * nt + B * ids_len // S."""
    return ct.numel() + (ct.numel() // ct.shape[-1]) * sp.shape[-1] // seg


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("case", list(KEYS_CASES))
def test_split_keys_f32_equals_plain_walk(case, seg):
    sp, st, ct, table, width, (tw, th) = KEYS_CASES[case](seg)
    cap = _cap(sp, ct, seg)
    if case.startswith("overlapping"):
        assert len(plan(ct, seg)[0]) > cap      # the plan's fallback
    if not case.startswith(("textured", "mesh")):
        assert int(torch.isnan(table[..., :-1, 0]).sum()) > 0
    for z_clip, order in ((True, None), (False, seg)):
        best, attr = split_walk(sp, st, ct, table, width, tw, th, z_clip,
                                seg, order=order, cap=cap, cull=True)
        got_k, got_r = tt._keys_f32_epilogue(best, attr)
        want_k, want_r = tt.raster_tiles_keys_f32_reference(
            sp, st, ct, table, width, tw, th, z_clip=z_clip)
        assert (want_k != r3.SKY_KEY).float().mean() > 0.2
        assert torch.equal(got_k, want_k)
        assert torch.equal(got_r.view(torch.int32), want_r.view(torch.int32))
        if not z_clip and not case.startswith(("textured", "mesh")):
            assert int((want_k < 0).sum()) > 0     # depths above 1 wrap


@pytest.mark.parametrize("case", list(KEYS_CASES))
def test_pairs_cull_keep_is_the_brute_force_count(case):
    # the kept (row, warp) pairs of K2a's bound: every walked run slot of
    # every tile against every warp's box, in numpy's float32 (each
    # product and sum rounded), through the kernel's clamps
    sp, st, ct, table, width, (tw, th) = KEYS_CASES[case](tt.SEG)
    keep = tt.pairs_cull_keep(sp, st, ct, table, width, tw, th)
    nt, nb = ct.shape[-1], ct.numel()
    assert keep.shape == (nb, max(1, int(ct.max())), tt.WARPS)
    spn = sp.reshape(-1, sp.shape[-1]).numpy()
    stn, ctn = st.reshape(-1).numpy(), ct.reshape(-1).numpy()
    tb = table.reshape(-1, table.shape[-2], tt.ROW_W).numpy()
    layout = tt.warp_boxes(tw, th)
    want = np.zeros(keep.shape, bool)
    for b in range(nb):
        f, n = b // nt, int(ctn[b])
        idx = np.minimum(stn[b] + np.arange(n), spn.shape[-1] - 1)
        rows = tb[f][np.minimum(spn[f][idx] & r3.IDX_MASK,
                                tb.shape[1] - 1)]
        if layout is None:
            want[b, :n] = True
            continue
        for w, (x0, x1, y0, y1) in enumerate(
                _warp_box(b, nt, width, tw, th).numpy()):
            culled = np.zeros(n, bool)
            for i in range(3):
                a, bb, c = rows[:, 3 * i], rows[:, 3 * i + 1], rows[:, 3 * i + 2]
                x = np.where(a > 0, x1, x0).astype(np.float32)
                y = np.where(bb > 0, y1, y0).astype(np.float32)
                culled |= (a * x + bb * y) + c < 0
            want[b, :n, w] = ~culled
    assert np.array_equal(keep.numpy(), want)
    share = want.sum() / max(1, int(ct.clamp(min=0).sum()) * tt.WARPS)
    if layout is not None and not case.startswith("overlapping"):
        assert share < 0.9      # the cull skips rows
    elif layout is None:
        assert share == 1.0     # no warp boxes at this width


@pytest.mark.parametrize("case", ["boundaries 128x16", "knife edges 128x16",
                                  "mesh_10k 128x16"])
def test_pairs_cull_never_skips_a_covered_box(case):
    # where pairs_cull_keep drops a (run slot, warp), the walk covers no
    # pixel of the warp's box with that row
    sp, st, ct, table, width, (tw, th) = KEYS_CASES[case](tt.SEG)
    keep = tt.pairs_cull_keep(sp, st, ct, table, width, tw, th)
    rows_at = tt._pairs_rows_at(sp, st, ct, table)
    nt, culled = ct.shape[-1], 0
    for b in range(ct.numel()):
        n = int(ct.reshape(-1)[b])
        rows = rows_at(torch.tensor([b]), torch.arange(n)[None])[0]
        covered = _box_covered(rows, _warp_box(b, nt, width, tw, th))
        assert not bool((covered & ~keep[b, :n]).any())
        culled += int((~keep[b, :n]).sum())
    assert culled > 0
