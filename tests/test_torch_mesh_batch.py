"""The batch's prep: ``prepare_frame`` and ``prepare_textured_frame`` with
B matrices (B, 4, 4) in one pass over (B, F), with the default and the
affine (``mxu``) tables, ``bin_triangles`` over B frames, and the loop
entries that rasterize the batch with one K1 or K3 launch, against the
per-frame preps and renders, bit for bit.

Each batch of three holds a close frame whose runs fit ``capacity``, a
far frame whose runs overflow it, and a frame whose camera sits inside
the mesh, so that some faces lie behind the w = 1e-6 plane.  Two layouts: the mesh cell's
32x32 tiles with span (5, 3), and 16x16 tiles with span 8x8 over a mesh
of F >= 4096 faces, which takes the tall split's top-k pass.
"""

import numpy as np
import pytest
import torch

from libnativecpurenderer_tpu_torch.models import mesh
from libnativecpurenderer_tpu_torch.ops import raster3d as tr
from libnativecpurenderer_tpu_torch.ops import tile_raster as tt

torch.set_num_threads(1)

BG = torch.tensor([0.12, 0.34, 0.56, 1.0])
# (subdiv, width, height, render keywords); capacity such that the far
# camera's runs (the whole sphere in a few tiles) overflow it and the
# close camera's do not
LAYOUTS = {
    "cell": (2, 96, 64, dict(tile_w=32, tile_h=32, capacity=96, span_x=5,
                             span_y=3, z_clip=False)),
    "tall": (4, 96, 64, dict(tile_w=16, tile_h=16, capacity=512, span_x=8,
                             span_y=8, z_clip=True)),
}
# the frames of a batch: eye distance from the sphere's centre
CLOSE, FAR, INSIDE = 1.25, 3.0, 0.5


def _scene(layout):
    subdiv, w, h, kw = LAYOUTS[layout]
    verts, faces = mesh.icosphere(subdiv)
    colors = np.concatenate([np.abs(verts), np.ones((len(verts), 1))], 1)
    uvs = (verts[:, :2] * 0.5 + 0.5).clip(0.0, 1.0)
    rng = np.random.default_rng(18)
    tex = torch.from_numpy(rng.integers(0, 256, (8, 16, 4), dtype=np.uint8))
    t = (torch.from_numpy(verts.astype(np.float32)),
         torch.from_numpy(faces.astype(np.int64)),
         torch.from_numpy(colors.astype(np.float32)),
         torch.from_numpy(uvs.astype(np.float32)), tex)
    return t, w, h, kw


def _mvps(w, h, dists):
    out = []
    for i, d in enumerate(dists):
        eye = np.array([np.sin(0.7 * i + 0.3), 0.35, np.cos(0.7 * i + 0.3)])
        eye = eye / np.linalg.norm(eye) * d
        out.append(mesh.perspective(1.1, w / h, 0.1, 10.0)
                   @ mesh.look_at(eye, [0, 0, 0], [0, 1, 0])
                   @ mesh.rotation_x(0.2 * i))
    return torch.from_numpy(np.stack(out).astype(np.float32))


def _prep(kind, mesh_t, w, h, mvp, kw):
    verts, faces, colors, uvs, _ = mesh_t
    if kind == "gouraud":
        return tr.prepare_frame(verts, faces, colors, w, h, mvp, bg=BG,
                                **kw)
    return tr.prepare_textured_frame(verts, faces, uvs[faces], w, h, mvp,
                                     perspective_correct=True, **kw)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_frames_equal(kind, mesh_t, w, h, mvps, got, kw):
    """Each frame of the batch's prep ``got`` equals its own prep, bit for
    bit (``sorted_pad`` in its pairs of tiles < NT); returns the frames'
    overflow flags."""
    nt = got["counts"].shape[-1]
    flags = []
    for i in range(mvps.shape[0]):
        one = _prep(kind, mesh_t, w, h, mvps[i], kw)
        for k in ("starts", "counts", "table", "overflow"):
            assert torch.equal(_bits(got[k][i]), _bits(one[k])), k
        sp, sp1 = got["sorted_pad"][i], one["sorted_pad"]
        assert sp.shape == sp1.shape
        valid = int(((sp1 >> tr.IDX_BITS) < nt).sum())
        assert int(((sp >> tr.IDX_BITS) < nt).sum()) == valid
        assert torch.equal(sp[:valid], sp1[:valid])
        flags.append(bool(one["overflow"]))
    return flags


@pytest.mark.parametrize("layout", ["cell", "tall"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("kind", ["gouraud", "textured"])
def test_batched_prep_equals_per_frame(kind, n, layout):
    mesh_t, w, h, kw = _scene(layout)
    if layout == "tall":
        assert mesh_t[1].shape[0] >= 4096
    dists = [INSIDE] if n == 1 else [CLOSE, FAR, INSIDE]
    mvps = _mvps(w, h, dists)
    fn = tr.prepare_frame if kind == "gouraud" else tr.prepare_textured_frame
    calls, frames = fn.calls, fn.frames
    got = _prep(kind, mesh_t, w, h, mvps, kw)
    assert (fn.calls - calls, fn.frames - frames) == (1, n)
    assert got["sorted_pad"].shape[0] == n and got["overflow"].shape == (n,)
    flags = _assert_frames_equal(kind, mesh_t, w, h, mvps, got, kw)
    for i in range(n):
        if dists[i] == INSIDE:
            # the camera inside the sphere: faces behind w = 1e-6
            v4f = tr.pregather_mesh(mesh_t[0], mesh_t[1])
            w_clip = tr._clip_rows(v4f, mvps[i])[..., 3]
            assert bool((w_clip <= tr.NEAR_EPS).any())
    if n == 3:
        # the close frame fits; the far frame's runs overflow capacity
        assert not flags[0]
        assert int(got["counts"][1].max()) > kw["capacity"]
        assert flags[1]


@pytest.mark.parametrize("layout", ["cell", "tall"])
@pytest.mark.parametrize("n", [1, 3])
def test_bin_triangles_batch_equals_per_frame(n, layout):
    """The materialised binning over B frames: bins, counts and overflow
    each equal to that frame binned alone."""
    mesh_t, w, h, kw = _scene(layout)
    verts, faces, colors = mesh_t[:3]
    dists = [INSIDE] if n == 1 else [CLOSE, FAR, INSIDE]
    mvps = _mvps(w, h, dists)
    cfg = (w, h, kw["tile_w"], kw["tile_h"], kw["capacity"], kw["span_x"],
           kw["span_y"])

    def binned(m):
        tri, _, edges = tr._setup_edges(verts, faces, m, w, h)
        return tr.bin_triangles(tri["sxy"], edges[-1], *cfg)

    bins, counts, ovf = binned(mvps)
    nt = counts.shape[-1]
    assert bins.shape == (n, nt, kw["capacity"]) and ovf.shape == (n,)
    flags = []
    for i in range(n):
        b1, c1, o1 = binned(mvps[i])
        assert b1.shape == (nt, kw["capacity"]) and o1.shape == ()
        assert torch.equal(bins[i], b1)
        assert torch.equal(counts[i], c1)
        assert torch.equal(ovf[i], o1)
        flags.append(bool(o1))
    if n == 3 and layout == "cell":
        # the close frame fits; the far frame's runs overflow capacity
        assert flags[:2] == [False, True]


@pytest.fixture
def counted_launches(monkeypatch):
    """K1 and K3 wrappers on CPU tensors as on the card: each call counts
    a launch, whose output is the plain version's."""
    monkeypatch.setattr(tt, "_on_cpu", lambda table, kernel: False)
    monkeypatch.setattr(
        tt, "_launch_u8",
        lambda sp, st, c, t, bg, w, tw, th, opaque, z_clip, **_:
        tt.raster_tiles_flat_u8_reference(sp, st, c, t, bg, w, tw, th,
                                          opaque=opaque, z_clip=z_clip))
    monkeypatch.setattr(
        tt, "_launch_tex_u8",
        lambda sp, st, c, t, tex, dims, bg, w, tw, th, z_clip, **_:
        tt.raster_tiles_tex_u8_reference(sp, st, c, t, tex, dims, bg, w, tw,
                                         th, z_clip=z_clip))


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("kind", ["gouraud", "textured"])
def test_loop_equals_stacked_per_frame(kind, tiled, counted_launches):
    mesh_t, w, h, kw = _scene("cell")
    verts, faces, colors, uvs, tex = mesh_t
    kw = dict(kw, capacity=512)
    mvps = _mvps(w, h, [CLOSE, FAR, INSIDE])
    if kind == "gouraud":
        kw.update(opaque=True)
        counter = tt.raster_tiles_flat_u8

        def loop():
            return tr.render_gouraud_u8_loop(verts, faces, colors, w, h,
                                             mvps, bg=BG, tiled=tiled, **kw)

        def one(m):
            return tr.render_gouraud_u8(verts, faces, colors, w, h, m,
                                        bg=BG, tiled=tiled, **kw)
    else:
        counter = tt.raster_tiles_tex_u8

        def loop():
            return tr.render_textured_u8_loop(verts, faces, uvs, tex, w, h,
                                              mvps, bg=BG, tiled=tiled,
                                              **kw)

        def one(m):
            return tr.render_textured_u8(verts, faces, uvs, tex, w, h, m,
                                         bg=BG, tiled=tiled, **kw)
    before = counter.launches
    frames, ovf = loop()
    assert counter.launches == before + 1
    want = [one(m) for m in mvps]
    assert frames.dtype == torch.uint8
    assert torch.equal(frames, torch.stack([f for f, _ in want]))
    assert bool(ovf) == any(bool(o) for _, o in want)


@pytest.mark.parametrize("entry,kw", [
    ("gouraud", dict(flat=True)),
    ("gouraud", dict(flat=True, u8=True)),
    ("gouraud", dict(flat=True, u8=True, mxu=1)),
    ("gouraud", dict(flat=True, u8=True, opaque=True, z_clip=False,
                     dynrows=2)),
    ("textured", dict(mxu=0)),
    ("textured", dict(mxu=1))], ids=["k2a", "k1", "k1_mxu", "k6", "k3",
                                     "k3_mxu"])
def test_batch_entries_prep_once(entry, kw):
    """``render_gouraud_pallas_batch``'s flat routes and
    ``render_textured_u8_batch`` prep their B frames in one call."""
    (verts, faces, colors, uvs, tex), w, h, _ = _scene("cell")
    mvps = _mvps(w, h, [CLOSE, FAR, INSIDE])
    fn = tr.prepare_frame if entry == "gouraud" else tr.prepare_textured_frame
    calls, frames = fn.calls, fn.frames
    if entry == "gouraud":
        out = tr.render_gouraud_pallas_batch(verts, faces, colors, w, h,
                                             mvps, bg=BG, **kw)[0]
    else:
        out = tr.render_textured_u8_batch(verts, faces, uvs, tex, w, h,
                                          mvps, bg=BG, **kw)[0]
    assert (fn.calls - calls, fn.frames - frames) == (1, 3)
    assert out.shape[:3] == (3, h, w)


@pytest.mark.parametrize("kind,opt", [("gouraud", "near_clip"),
                                      ("gouraud", "mxu"),
                                      ("textured", "mxu")])
def test_batched_prep_refuses_near_clip_and_mxu(kind, opt):
    """The batch's prep refuses ``near_clip``; with ``mxu`` it builds
    each frame's affine table in the one pass, equal to the per-frame
    preps."""
    mesh_t, w, h, kw = _scene("cell")
    mvps = _mvps(w, h, [CLOSE, FAR])
    kw = dict(kw, **{opt: 1})
    if opt == "near_clip":
        with pytest.raises(ValueError, match="does not take near_clip"):
            _prep(kind, mesh_t, w, h, mvps, kw)
        # one matrix keeps every option
        _prep(kind, mesh_t, w, h, mvps[0], kw)
        return
    got = _prep(kind, mesh_t, w, h, mvps, kw)
    plain = _prep(kind, mesh_t, w, h, mvps, dict(kw, mxu=0))
    assert got["table"].shape == plain["table"].shape
    assert not torch.equal(_bits(got["table"]), _bits(plain["table"]))
    flags = _assert_frames_equal(kind, mesh_t, w, h, mvps, got, kw)
    assert flags == [False, True]
