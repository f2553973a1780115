"""K2b and K6 on the split walk (``csrc/tile_raster.cu``), as the plain
mirror of tests/test_torch_walk_split.py on the CPU.

K2b is K3's walk with the TEX_IDX epilogue: the winner's clamped-nearest
texel index itself, -1 for sky (the plan fills a long tile's keys with
SKY_KEY and its last item turns what is still SKY_KEY into -1).  K6 is
K1's walk (opaque, no z test) over the ROWS source: slot j of tile t is
row starts[t] + j of the frame's rows gathered in pair order, clamped
below their count CAP, and the item list holds B * nt + B * CAP // S
items (``tile_raster._split_scratch`` with no pair array).  The mirror
(:func:`test_torch_walk_split.split_walk`) is held bit for bit to
``raster_tiles_tex_idx_reference`` and ``raster_tiles_rows_u8_reference``
(and K6 to K1's plain version where its rows hold every run) for S in
1..128, on runs at the split's boundaries (1, S, S + 1, 2S, 2S + 1 and
1024 slots) with NaN rows, a run read past the pair array, crafted uv
rows (huge, negative, tiny, zero and NaN denominators,
``testing.crafted_uv_table``), K6 frames whose runs end past CAP (with
the item list fitting its capacity, and overflowing it: the plan then
walks every tile as one item), ``mesh_10k`` at a small frame, one frame
and 3 in one launch.  The plan for ROWS walks every slot once within the
capacity the wrapper allocates.  Source-level checks: K2b's, K6's and
K2a's entries take the split walk, every walk entry of the file does
and the one-block-a-tile walk (``fma_tile``) is gone, and
``_kernels.WALKS`` names the occupancy entry's walk numbers.  The kernels
themselves are held to the plain versions on the card by
``chip_smoke.py`` (phases 10, 11 and 13).
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu_torch import interop
from libnativecpurenderer_tpu_torch.models import mesh
from libnativecpurenderer_tpu_torch.ops import _kernels
from libnativecpurenderer_tpu_torch.ops import raster3d as r3
from libnativecpurenderer_tpu_torch.ops import tile_raster as tt
from libnativecpurenderer_tpu_torch.testing import (crafted_runs,
                                                    crafted_uv_table)
from test_torch_walk_split import (BGP, SEGS, _boundary_case, _frames,
                                   _mesh_case, plan, split_walk)

torch.set_num_threads(1)

DIMS = (48, 64)     # (th, tw): not square


def _gathered(sp, table):
    """Each frame's rows in pair order, ``table[sp & IDX_MASK]``, with a
    leading B: K6's input for the pair walk's (sp, table)."""
    if sp.dim() == 1:
        sp, table = sp[None], table[None]
    return torch.stack([t[(s & r3.IDX_MASK).long()]
                        for s, t in zip(sp, table)])


def _rows_case(sp, st, ct, table, width, cut=0):
    """(rows, starts, counts, width, K1's walk inputs or None): K6's
    inputs with a leading B; ``cut`` rows fewer than the runs' end, so
    the last runs read past CAP (clamped), and then no K1 equivalent."""
    rows = _gathered(sp, table)
    st, ct = (st[None], ct[None]) if st.dim() == 1 else (st, ct)
    if cut:
        end = int((st[:, -1] + ct[:, -1]).max())
        return rows[:, :end - cut].contiguous(), st, ct, width, None
    k1 = (sp.reshape(st.shape[0], -1), st, ct,
          table.reshape(st.shape[0], -1, tt.ROW_W))
    return rows, st, ct, width, k1


def _crafted(seg):
    return crafted_runs([1, seg, seg + 1, 2 * seg, 2 * seg + 1, 1024],
                        seed=seg)


ROWS_CASES = {
    "boundaries": lambda s: _rows_case(*_crafted(s)),
    "runs past CAP": lambda s: _rows_case(*_crafted(s), cut=10),
    "runs past CAP, list full": lambda s: _rows_case(
        *_crafted(s), cut=1000),
    "mesh_10k": lambda s: _rows_case(*_mesh_case()),
    "3 frames": lambda s: _rows_case(*_frames([1, 2, 3]), 6 * 32)}


def _rows_cap(counts, rows, seg):
    """The item list's capacity for K6 at S = seg: the wrapper's
    B * nt + B * CAP // S."""
    return counts.numel() + counts.shape[0] * rows.shape[-2] // seg


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("case", list(ROWS_CASES))
def test_split_rows_u8_equals_plain_walk(case, seg):
    rows, st, ct, width, k1 = ROWS_CASES[case](seg)
    best, attr = split_walk(None, st, ct, rows, width, 32, 32, False, seg,
                            cap=_rows_cap(ct, rows, seg))
    got = tt._u8_epilogue(best, attr, BGP, True)
    want = tt.raster_tiles_rows_u8_reference(rows, st, ct, BGP, width, 32,
                                             32)
    assert (want != BGP).float().mean() > 0.2
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    if k1 is not None:
        # the rows hold every run: K1's walk over the pair array
        assert torch.equal(want, tt.raster_tiles_flat_u8_reference(
            *k1, BGP, width, 32, 32, opaque=True, z_clip=False))


@pytest.mark.parametrize("case", list(ROWS_CASES))
def test_rows_plan_walks_every_slot_once_within_capacity(case):
    # runs that end inside the rows fit the wrapper's list, so the split
    # is on; a frame whose runs end far past CAP (flagged by the caller)
    # may not fit, and the plan then walks every tile as one item
    rows, st, ct, _, _ = ROWS_CASES[case](tt.SEG)
    _, cap, _ = tt._split_scratch(None, ct, rows)
    assert cap == _rows_cap(ct, rows, tt.SEG) >= ct.numel()
    split, _ = plan(ct, tt.SEG)
    items, k_of = plan(ct, tt.SEG, cap)
    if case.endswith("list full"):
        assert len(split) > cap
        assert len(items) == int((ct > 0).sum()) and max(k_of) == 1
    else:
        assert items == split and len(items) <= cap
        assert max(k_of) > 1
    walked = {}
    for b, lo, hi in items:
        assert hi - lo <= tt.SEG or k_of[b] == 1
        walked.setdefault(b, []).extend(range(lo, hi))
    for b, c in enumerate(ct.reshape(-1).tolist()):
        assert sorted(walked.get(b, [])) == list(range(c))
    if case.startswith("runs past CAP"):
        assert int((st[:, -1] + ct[:, -1]).max()) > rows.shape[-2]


@functools.lru_cache(maxsize=None)
def _tex_mesh_case():
    """bench.py's textured ``mesh_10k`` (planar uvs) at 256x160, 32x32
    tiles, perspective-correct, z test on: (sorted_pad, starts, counts,
    table, width)."""
    v, f, _ = mesh.mesh_10k()
    uvs = (v[:, :2] - v[:, :2].min(0)) / np.ptp(v[:, :2], 0)
    tex = np.zeros(DIMS + (4,), np.uint8)
    verts, faces, uv, _ = interop.textured_mesh_to_torch(v, f, uvs, tex,
                                                         "cpu")
    m = (mesh.perspective(1.0, 256 / 160, 0.1, 10.0)
         @ mesh.look_at([0.0, 0.6, 3.2], [0, 0, 0], [0, 1, 0])
         @ mesh.rotation_y(0.45)).astype(np.float32)
    prep = r3.prepare_textured_frame(
        verts, faces, uv[faces], 256, 160, torch.from_numpy(m), tile_w=32,
        tile_h=32, capacity=4096, span_x=9, span_y=6,
        perspective_correct=True, z_clip=True)
    assert not bool(prep["overflow"])
    return (prep["sorted_pad"], prep["starts"], prep["counts"],
            prep["table"], 256)


def _crafted_uv(case):
    sp, st, ct, table, width = case
    return sp, st, ct, crafted_uv_table(table), width


def _uv_frames(seeds):
    """Boundary runs at the kernel's S with crafted uv rows, one frame
    a seed, stacked as B frames."""
    cases = [_crafted_uv(crafted_runs(
        [1, tt.SEG, tt.SEG + 1, 2 * tt.SEG, 2 * tt.SEG + 1, 1024], seed=s))
        for s in seeds]
    return tuple(torch.stack([c[i] for c in cases]) for i in range(4)) + (
        cases[0][4],)


IDX_CASES = {
    "boundaries": lambda s: _boundary_case(s),
    "past the pair array": lambda s: _boundary_case(s, past_end=300),
    "crafted uv rows": lambda s: _crafted_uv(_boundary_case(s)),
    "textured mesh_10k": lambda s: _tex_mesh_case(),
    "3 frames, crafted uv rows": lambda s: _uv_frames([4, 5, 6])}


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("case", list(IDX_CASES))
def test_split_tex_idx_equals_plain_walk(case, seg):
    sp, st, ct, table, width = IDX_CASES[case](seg)
    for z_clip in (True, False):
        best, attr = split_walk(sp, st, ct, table, width, 32, 32, z_clip,
                                seg)
        got = tt._tex_idx_epilogue(best, attr, DIMS)
        want = tt.raster_tiles_tex_idx_reference(sp, st, ct, table, DIMS,
                                                 width, 32, 32,
                                                 z_clip=z_clip)
        hit = want >= 0
        assert hit.float().mean() > 0.2
        assert int(want[hit].unique().numel()) > 50     # texels spread
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def _source():
    return (Path(tt.__file__).resolve().parent.parent / "csrc"
            / "tile_raster.cu").read_text()


def _body(src, head):
    """The text of the function whose definition starts with ``head``, up
    to its closing brace at column 0."""
    i = src.index(head)
    return src[i:src.index("\n}\n", i) + 3]


@pytest.mark.parametrize("entry,epi,source", [
    ("tile_raster_tex_idx", "TEX_IDX", None),
    ("tile_raster_rows_u8", "U8_GOURAUD", "ROWS"),
    ("tile_raster_keys_f32", "KEYS_F32", None)])
def test_k2b_k6_entries_take_the_split_walk(entry, epi, source):
    # the entry launches the split walk (the plan kernel, then the
    # persistent walk) with its epilogue and row source, and takes the
    # split walk's scratch
    body = _body(_source(), f"int {entry}(")
    args = f"<{epi}, {source}>" if source else f"<{epi}>"
    assert f"return launch_split{args}(" in body
    assert "SPLIT_ARGS" in body and "PLAN" in body
    assert "launch(" not in body.replace("launch_split", "")


def test_fma_tile_is_k2a_only():
    # no kernel is left on the one-block-a-tile walk: fma_tile, its
    # kernel, its launchers and its row chunk are gone, and every walk
    # entry of the file returns a launch of the split walk
    src = _source()
    for name in ("fma_tile", "tile_raster_kernel", "launch_ppt", "CHUNK =",
                 "CHUNK]"):
        assert name not in src
    assert not re.search(r"[^_\w]launch\(", src)
    entries = [e for e in re.findall(r"\nint (tile_raster_\w+)\(", src)
               if e not in ("tile_raster_occupancy", "tile_raster_mma_probe")]
    assert {"tile_raster_u8", "tile_raster_tex_u8", "tile_raster_tex_idx",
            "tile_raster_keys_f32", "tile_raster_bins_f32",
            "tile_raster_rows_u8"} == set(entries)
    for e in entries:
        assert re.search(r"return launch_split<[^>]*>\(",
                         _body(src, f"int {e}(")), e
    assert re.findall(r"__global__ void[^;{]*\n(\w+)\(", src) == [
        "split_plan_kernel", "tile_raster_split_kernel", "mma_probe_kernel"]


def test_occupancy_walks_are_the_c_entrys():
    # _kernels.WALKS names the C entry's walk numbers in order: its index
    # is the number tile_raster_occupancy switches on
    body = _body(_source(), "int tile_raster_occupancy(")
    cases = re.findall(r'case (\d+):\s*// "([^"]+)"', body)
    assert [(int(n), w) for n, w in cases] == list(enumerate(_kernels.WALKS))
    assert "default:" in body
