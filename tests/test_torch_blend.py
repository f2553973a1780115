"""The blended quad batch (BASELINE config 2) on the binned path: K7's
plain version, ``render_blended_u8_loop`` and ``MeshVideoPipeline``'s
blended mode against ``render_blended`` (the per-triangle plain path),
frame by frame and bit for bit; the draw order's rule; the opaque
depth's limits; and the cell's reference, which reads a reversed order,
a dropped z test and a dropped blend above the cell's limit.

The scenes are the cell's recipe (``bench_torch/scenes/quad_cloud``) cut
to 48-96 quads at 160x96: the orbit's front, oblique and near edge-on
views, so that runs hold up to a few dozen triangles and every tile
shape's pixels-per-thread case is walked.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_torch.generators import camera_orbit as orbit
from bench_torch.references import quad_blend as ref
from bench_torch.scenes import quad_cloud
from libnativecpurenderer_tpu_torch import MeshVideoPipeline
from libnativecpurenderer_tpu_torch.ops import raster3d as r3
from libnativecpurenderer_tpu_torch.ops import tile_raster as tr

torch.set_num_threads(1)

W, H = 160, 96
KW = dict(tile_w=32, tile_h=32, capacity=2048, span_x=12, span_y=12)
ANGLES = (0.0, 0.8, 1.45, 2.6)          # front, oblique, edge-on, behind
LIMIT = json.loads((Path(__file__).resolve().parent.parent / "bench_torch"
                    / "limits" / "baseline_textured_720p.json").read_text())[
                        "worst_frame_off_share"]


def scene(quads=64, seed=3, tex=(32, 32)):
    """(verts, faces, uvs, tex_u8) tensors of the cell's recipe."""
    v, f, uv = quad_cloud.build(quads, seed)
    t = quad_cloud.sprite(tex, seed)
    return (torch.from_numpy(v.astype(np.float32)), torch.from_numpy(f),
            torch.from_numpy(uv.astype(np.float32)), torch.from_numpy(t))


def mvps(angles, w=W, h=H):
    base = (orbit.perspective(1.0, w / h, 0.1, 10.0)
            @ orbit.look_at([0.0, 0.6, 3.2], [0, 0, 0], [0, 1, 0]))
    return torch.from_numpy(np.stack(
        [base @ orbit.rotation_y(a) for a in angles]).astype(np.float32))


def depth_ramp(mesh, m, w=W, h=H):
    scene = dict(zip(("verts", "faces", "uvs", "tex"), mesh))
    return torch.from_numpy(quad_cloud.opaque_ramp(
        ref.fragment_depths(scene, m, w, h), w, h))


def texf(tex):
    return tex.to(torch.float32) / torch.full((), 255.0)


def blended(mesh, m, od, w=W, h=H, bg=None):
    """``render_blended`` of the faces in the draw order, quantised."""
    verts, faces, uvs, tex = mesh
    draw, _ = r3.blend_order(r3.quad_centres(verts, faces), m)
    fb = r3.render_blended(verts, faces[draw.long()], uvs, texf(tex), w, h,
                           m, opaque_depth=od, bg=bg)
    return tr._quant_u8(fb).to(torch.uint8)


def differing(a, b):
    return int((a != b).any(-1).sum())


def float32_constant_prep(mesh, m, kw):
    """``prepare_blended_frame``'s prep with the edges' constants formed
    in float32, as ``render_blended`` forms them (the blend prep forms
    them in float64 and rounds once, as the u8 entries do)."""
    verts, faces, uvs, _ = mesh
    draw, step = r3.blend_order(r3.quad_centres(verts, faces), m)
    tri, _, edges, prep = r3._prep_geometry(
        verts, faces, m, W, H, z_clip=True, exact_c=False, ids=step,
        tall_split=False, **kw)
    A, B, C, _, inv_area, sign, valid = edges
    prep["table"] = tr.build_blend_table(A, B, C, tri["z"], inv_area, sign,
                                         valid, uvs[faces])
    prep["order"] = draw
    return prep


@pytest.mark.parametrize("angle", ANGLES)
@pytest.mark.parametrize("tile", [(32, 32), (16, 16), (64, 8), (64, 32)])
def test_k7_plain_equals_render_blended(tile, angle):
    """K7's plain version over the blend prep with ``render_blended``'s
    edge constants equals ``render_blended`` of the faces in draw order,
    frame by frame, for each tile shape."""
    mesh = scene()
    m = mvps([angle])[0]
    od = depth_ramp(mesh, m)
    kw = dict(KW, tile_w=tile[0], tile_h=tile[1])
    prep = float32_constant_prep(mesh, m, kw)
    assert not bool(prep["overflow"])
    bg = torch.tensor([0.1, 0.2, 0.3, 0.0])
    tex = mesh[3]
    packed = tr.raster_tiles_blend_u8(
        prep["sorted_pad"], prep["starts"], prep["counts"], prep["table"],
        prep["order"], od, r3.pack_texture_u8(tex), tuple(tex.shape[:2]),
        bg, W, H, *tile)
    got = tr.detile_packed(packed, W, H, *tile)
    want = blended(mesh, m, od, bg=bg)
    assert (want[..., 3] > 0).any()
    assert differing(got, want) == 0


def test_runs_list_each_tile_in_draw_order():
    """The binning with draw steps as ids: each run's steps rise, so K7
    walks back to front; and every step of a run draws a face."""
    mesh = scene()
    verts, faces, uvs, _ = mesh
    prep = r3.prepare_blended_frame(
        verts, faces, uvs[faces], W, H, mvps([0.3])[0],
        centres=r3.quad_centres(verts, faces), **KW)
    steps = prep["sorted_pad"] & tr.IDX_MASK
    for s, n in zip(prep["starts"].tolist(), prep["counts"].tolist()):
        run = steps[s:s + n]
        assert bool((run[1:] > run[:-1]).all())
    assert sorted(prep["order"].tolist()) == list(range(faces.shape[0]))


@pytest.mark.parametrize("seed", [4, 10])
def test_loop_equals_per_frame_calls(seed):
    """B frames in one prep and one K7 pass equal each frame's own call,
    detiled and tiled."""
    mesh = scene(quads=96, seed=seed)
    ms = mvps(ANGLES)
    od = depth_ramp(mesh, ms[0])
    calls, frames = (r3.prepare_blended_frame.calls,
                     r3.prepare_blended_frame.frames)
    got, ovf = r3.render_blended_u8_loop(*mesh, W, H, ms, opaque_depth=od,
                                         **KW)
    assert (r3.prepare_blended_frame.calls - calls,
            r3.prepare_blended_frame.frames - frames) == (1, len(ANGLES))
    tiles, _ = r3.render_blended_u8_loop(*mesh, W, H, ms, opaque_depth=od,
                                         tiled=True, **KW)
    assert not bool(ovf)
    for i, m in enumerate(ms):
        one, _ = r3.render_blended_u8_loop(*mesh, W, H, m, opaque_depth=od,
                                           **KW)
        assert torch.equal(got[i], one)
        assert np.array_equal(r3.detile_u8_host(tiles[i], W, H, 32, 32),
                              one.numpy())


def test_loop_departs_from_render_blended_at_knife_edges():
    """The loop's edges form their constants in float64 and round once,
    as the u8 entries do; ``render_blended`` forms them in float32.  That
    is the only op order that differs (K7 over ``render_blended``'s
    constants equals it, above), and it moves at most 0.1 % of the
    pixels: a covered knife edge, a depth or a texel index."""
    mesh = scene(quads=96, seed=4)
    ms = mvps(ANGLES)
    od = depth_ramp(mesh, ms[0])
    loop, _ = r3.render_blended_u8_loop(*mesh, W, H, ms, opaque_depth=od,
                                        **KW)
    moved = sum(differing(loop[i], blended(mesh, m, od))
                for i, m in enumerate(ms))
    assert moved <= 1e-3 * len(ANGLES) * W * H


class Frames:
    def __init__(self):
        self.frames, self.tiled = [], []

    def put_frame_u8(self, frame):
        self.frames.append(np.array(frame))


class TiledFrames(Frames):
    def put_frame_tiled_u8(self, tiles, w, h, tw, th):
        self.tiled.append(r3.detile_u8_host(tiles, w, h, tw, th))


@pytest.mark.parametrize("sink", [Frames, TiledFrames])
def test_pipeline_blend_mode(sink):
    """MeshVideoPipeline(blend=True) on the CPU: each delivered frame
    equals the loop entry's, one prep and one K7 pass a batch."""
    mesh = scene(quads=48, seed=6)
    ms = mvps([0.1 + 0.03 * k for k in range(6)])
    od = depth_ramp(mesh, ms[0])
    out = sink()
    calls = r3.prepare_blended_frame.calls
    pipe = MeshVideoPipeline(out, W, H, *[a.numpy() for a in mesh[:2]],
                             uvs=mesh[2].numpy(), tex_u8=mesh[3].numpy(),
                             blend=True, opaque_depth=od.numpy(), batch=4,
                             device="cpu", **KW)
    for m in ms:
        pipe.submit(m.numpy())
    pipe.finish()
    frames = out.tiled if sink is TiledFrames else out.frames
    assert len(frames) == len(ms) and r3.prepare_blended_frame.calls == \
        calls + 2
    loop, _ = r3.render_blended_u8_loop(*mesh, W, H, ms, opaque_depth=od,
                                        **KW)
    for i in range(len(ms)):
        assert np.array_equal(frames[i], loop[i].numpy())


def test_pipeline_blend_mode_arguments():
    mesh = [a.numpy() for a in scene(quads=4)]
    with pytest.raises(ValueError, match="blend=True"):
        MeshVideoPipeline(Frames(), W, H, mesh[0], mesh[1],
                          colors=np.ones((len(mesh[0]), 4)), blend=True,
                          device="cpu")
    with pytest.raises(ValueError, match="opaque_depth"):
        MeshVideoPipeline(Frames(), W, H, *mesh[:2], uvs=mesh[2],
                          tex_u8=mesh[3], opaque_depth=np.ones((H, W)),
                          device="cpu")
    with pytest.raises(ValueError, match="opaque_depth must be"):
        MeshVideoPipeline(Frames(), W, H, *mesh[:2], uvs=mesh[2],
                          tex_u8=mesh[3], blend=True,
                          opaque_depth=np.ones((W, H)), device="cpu")
    with pytest.raises(TypeError):
        MeshVideoPipeline(Frames(), W, H, *mesh[:2], uvs=mesh[2],
                          tex_u8=mesh[3], blend=True, opaque=True,
                          device="cpu")
    with pytest.raises(ValueError, match="quads"):
        MeshVideoPipeline(Frames(), W, H, mesh[0], mesh[1][:3],
                          uvs=mesh[2], tex_u8=mesh[3], blend=True,
                          device="cpu")


def test_order_rule_back_to_front_and_ties():
    """Quads farther in clip w first; ties (here quads of one centre)
    by quad index; a pair that float32 keys cannot tell apart in the
    float64 order; the program's order and the reference's agree."""
    base = np.array([[-0.1, -0.1, 0.0], [0.1, -0.1, 0.0], [0.1, 0.1, 0.0],
                     [-0.1, 0.1, 0.0]])
    # quad 0 and quad 3 share a centre; quads 1 and 2 lie one float32
    # step apart in z, far below float32's resolution of w
    zs = [0.5, 0.2, float(np.nextafter(np.float32(0.2), np.float32(1))),
          0.5, 0.9]
    verts = np.concatenate([base + [0.3 * i, 0, z] for i, z in
                            enumerate(zs)])
    verts[12:16, 0] = verts[0:4, 0]
    b = 4 * np.arange(len(zs))
    faces = np.stack([np.stack([b, b + 1, b + 2], 1),
                      np.stack([b, b + 2, b + 3], 1)], 1).reshape(-1, 3)
    v = torch.from_numpy(verts.astype(np.float32))
    f = torch.from_numpy(faces)
    m = mvps([0.0])[0]
    cen = r3.quad_centres(v, f)
    w = [float(m.double()[3, :3] @ c + m.double()[3, 3]) for c in cen]
    assert np.float32(w[1]) == np.float32(w[2]) and w[1] > w[2]
    assert w[0] == w[3]
    draw, step = r3.blend_order(cen, m)
    quads = draw[::2].tolist()
    # the camera looks down -z from z = 3.2: larger z is nearer
    assert [q // 2 for q in quads] == [1, 2, 0, 3, 4]
    assert draw.tolist()[1::2] == [q + 1 for q in quads]
    assert torch.equal(step[draw.long()], torch.arange(len(faces),
                                                       dtype=torch.int32))
    assert torch.equal(ref.draw_order(ref.centres(v, f), m),
                       draw.long())
    batch_draw, _ = r3.blend_order(cen, torch.stack([m, m]))
    assert torch.equal(batch_draw[1], draw)


def test_opaque_depth_limits():
    """A zero opaque depth draws nothing (every frame is the background);
    an opaque depth of ones tests only near and far, as the default
    does, and a quad past the far plane draws only where z <= 1."""
    mesh = scene()
    ms = mvps(ANGLES[:2])
    zero, _ = r3.render_blended_u8_loop(
        *mesh, W, H, ms, opaque_depth=torch.zeros((H, W)), **KW)
    assert int(zero.sum()) == 0
    ones, _ = r3.render_blended_u8_loop(
        *mesh, W, H, ms, opaque_depth=torch.ones((H, W)), **KW)
    default, _ = r3.render_blended_u8_loop(*mesh, W, H, ms, **KW)
    assert torch.equal(ones, default) and int(ones[..., 3].sum()) > 0
    # one quad, tilted from z = -3 to z = -11: its far part lies past the
    # far plane (10 from the eye at z = 3.2)
    verts = torch.tensor([[-1.0, -1.0, -3.0], [1.0, -1.0, -3.0],
                          [1.0, 1.0, -11.0], [-1.0, 1.0, -11.0]])
    faces = torch.tensor([[0, 1, 2], [0, 2, 3]])
    uvs = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    tex = torch.full((4, 4, 4), 200, dtype=torch.uint8)
    m = mvps([0.0])[0]
    far, _ = r3.render_blended_u8_loop(verts, faces, uvs, tex, W, H, m,
                                       opaque_depth=torch.ones((H, W)),
                                       **KW)
    tri = r3.setup_triangles(verts, faces, m, W, H)
    assert float(tri["z"].max()) > 1.0 and float(tri["z"].min()) < 1.0
    beyond, _ = r3.render_blended_u8_loop(verts, faces, uvs, tex, W, H, m,
                                          opaque_depth=torch.full((H, W),
                                                                  2.0),
                                          **KW)
    drawn = int((far[..., 3] > 0).sum())
    assert 0 < drawn < int((beyond[..., 3] > 0).sum())
    assert differing(far, blended((verts, faces, uvs, tex), m,
                                  torch.ones((H, W)))) == 0


def reference_share(mesh, m, od, frame):
    """The cell's off share of one frame against the reference."""
    want = ref.render({"verts": mesh[0], "faces": mesh[1], "uvs": mesh[2],
                       "tex": mesh[3], "bg": torch.zeros(4)}, m, W, H, od)
    return float(((frame.int() - want.int()).abs().amax(-1) > 1)
                 .double().mean())


@pytest.mark.parametrize("mutation", ["none", "reversed order",
                                      "no z test", "no blend"])
def test_reference_reads_a_broken_blend_above_the_limit(mutation,
                                                        monkeypatch):
    """The loop entry reads under the cell's limit against the cell's
    reference; with its order reversed, its z test dropped (an opaque
    depth of 2 passes every fragment) or its blend dropped (every texel
    opaque), above it."""
    mesh = scene(quads=96, seed=7)
    m = mvps([0.4])[0]
    od = depth_ramp(mesh, m)
    if mutation == "reversed order":
        real = r3.blend_order

        def reversed_order(centres, mvp):
            draw, _ = real(centres, mvp)
            draw = draw.flip(-1)
            step = torch.empty_like(draw).scatter_(
                -1, draw.long(), torch.arange(draw.shape[-1],
                                              dtype=torch.int32))
            return draw, step
        reversed_order.quads = 0
        monkeypatch.setattr(r3, "blend_order", reversed_order)
    if mutation == "no blend":
        real_unpack = tr.unpack_texels

        def opaque(texel):
            c = real_unpack(texel)
            return torch.cat([c[..., :3], torch.ones_like(c[..., 3:])], -1)
        monkeypatch.setattr(tr, "unpack_texels", opaque)
    frame, _ = r3.render_blended_u8_loop(
        *mesh, W, H, m, opaque_depth=(torch.full((H, W), 2.0)
                                      if mutation == "no z test" else od),
        **KW)
    share = reference_share(mesh, m, od, frame)
    if mutation == "none":
        assert share <= LIMIT
    else:
        assert share > LIMIT


def test_reference_fragments_agree_with_its_frame():
    """The reference's count of drawn fragments is order-free, and so is
    the set of pixels its frame draws: the drawn pixels of its frame are
    those with a drawn fragment."""
    mesh = scene(quads=32, seed=8)
    m = mvps([0.5])[0]
    od = depth_ramp(mesh, m)
    sc = {"verts": mesh[0], "faces": mesh[1], "uvs": mesh[2],
          "tex": mesh[3], "bg": torch.zeros(4)}
    covered, drawn = ref.fragments(sc, m, W, H, od)
    assert 0 < drawn < covered
    frame, _ = r3.render_blended_u8_loop(*mesh, W, H, m, opaque_depth=od,
                                         **KW)
    assert int((frame[..., 3] > 0).sum()) <= drawn
    assert math.isclose(reference_share(mesh, m, od, frame), 0.0,
                        abs_tol=LIMIT)


@pytest.mark.parametrize("tall_split", [True, False])
def test_binning_ids_relabel_each_run(tall_split):
    """``bin_triangles_flat(ids=)`` lists each tile the triangles the
    plain binning lists, each under its id, sorted by it, with the tall
    split's top-k pass (F >= 4096) and without it; B frames bin as each
    frame alone."""
    mesh = scene(quads=2048, seed=9)
    verts, faces = mesh[0], mesh[1]
    ms = mvps([0.2, 1.3])
    tri = r3.setup_triangles(verts, faces, ms, W, H)
    A, B, C, _, sign, valid = r3.edge_coeffs(tri["sxy"], tri["z"],
                                             tri["valid"], True)
    _, step = r3.blend_order(r3.quad_centres(verts, faces), ms)
    args = (W, H, 16, 16, 4096, 8, 8)
    sp, st, cn, ovf = r3.bin_triangles_flat(
        tri["sxy"], valid, *args, edges=(A, B, C, sign), ids=step,
        tall_split=tall_split)
    for b in range(2):
        kw = dict(edges=(A[b], B[b], C[b], sign[b]), tall_split=tall_split)
        one = r3.bin_triangles_flat(tri["sxy"][b], valid[b], *args,
                                    ids=step[b], **kw)
        plain = r3.bin_triangles_flat(tri["sxy"][b], valid[b], *args, **kw)
        assert torch.equal(st[b], one[1]) and torch.equal(cn[b], one[2])
        assert torch.equal(cn[b], plain[2]) and bool(ovf[b]) == bool(one[3])
        for s, n in zip(st[b].tolist(), cn[b].tolist()):
            got = (sp[b, s:s + n] & tr.IDX_MASK).tolist()
            want = step[b][(plain[0][s:s + n] & tr.IDX_MASK).long()]
            assert got == sorted(want.tolist())
