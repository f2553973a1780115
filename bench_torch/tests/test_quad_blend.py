"""The blended quad cell's own pieces on the CPU: the system's cut
(a sound run, and a traced one that reads the blend prep's span), the
reference against the port's per-triangle ``render_blended`` at a small
size, and the roofline's fragment counts on a scene counted by hand."""

import numpy as np
import pytest
import torch

from bench_torch.generators import camera_orbit as orbit
from bench_torch.references import quad_blend as ref
from bench_torch.rooflines import tile_blend as roof
from bench_torch.scenes import quad_cloud
from bench_torch.tests import small
from libnativecpurenderer_tpu_torch.ops import raster3d

CELL = "baseline_textured_720p"
W, H = 160, 96


def test_small_cut_runs_and_reads_the_prep_span():
    c = small.cell(CELL)
    assert (c.config["width"], c.config["height"], c.config["quads"],
            c.config["batch"]) == (160, 96, 64, 4)
    out = small.run(c, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["blend_prep_ms_per_frame"]["value"] > 0
    # the CPU loads no kernel library: the roofline has nothing to read
    assert "blend_roofline" not in out["metrics"]
    with pytest.raises(ValueError, match="no variant"):
        small.cell(CELL, textured=True)


@pytest.mark.parametrize("angle", [0.2, 1.0, 2.9])
def test_reference_against_render_blended(angle):
    """The reference (the blend in float64, the configuration's float32
    geometry) against the port's per-triangle path in float32 with the
    faces in the reference's order, and against the loop entry.  The
    per-triangle path forms the edges' constants in float32 where the
    configuration rounds them once from float64, so it parts from the
    reference at knife edges (a few pixels, under 0.1 %); the loop entry
    keeps to the configuration and to the cell's limit."""
    c = small.cell(CELL)
    v, f, uv = quad_cloud.build(64, 5)
    tex = torch.from_numpy(quad_cloud.sprite((32, 32), 5))
    verts = torch.from_numpy(v.astype(np.float32))
    faces = torch.from_numpy(f)
    uvs = torch.from_numpy(uv.astype(np.float32))
    base = (orbit.perspective(1.0, W / H, 0.1, 10.0)
            @ orbit.look_at([0.0, 0.6, 3.2], [0, 0, 0], [0, 1, 0]))
    m = torch.from_numpy((base @ orbit.rotation_y(angle)).astype(np.float32))
    scene = {"verts": verts, "faces": faces, "uvs": uvs, "tex": tex,
             "bg": torch.zeros(4)}
    od = torch.from_numpy(quad_cloud.opaque_ramp(
        ref.fragment_depths(scene, m, W, H), W, H))
    want = ref.render(scene, m, W, H, od)
    order = ref.draw_order(ref.centres(verts, faces), m)
    fb = raster3d.render_blended(
        verts, faces[order], uvs,
        tex.to(torch.float32) / torch.full((), 255.0), W, H, m,
        opaque_depth=od)
    got = torch.clamp(fb * 255, 0, 255).to(torch.int32)

    def off(frame):
        return float(((frame.int() - want.int()).abs().amax(-1) > 1)
                     .double().mean())
    assert (want[..., 3] > 0).any()
    assert off(got) <= 1e-3
    loop, _ = raster3d.render_blended_u8_loop(
        verts, faces, uvs, tex, W, H, m, opaque_depth=od, tile_w=32,
        tile_h=32, capacity=2048, span_x=12, span_y=12)
    assert off(loop) <= c.limits["worst_frame_off_share"]


def test_fragments_and_roofline_on_a_hand_counted_quad():
    """One quad over pixels 2..6 x 2..6 of an 8x8 frame (identity
    matrix, z 0: depth 0.5): each triangle covers 15 pixels, the
    diagonal's 5 twice, 30 fragments; an opaque depth below 0.5 left of
    x = 4 leaves 18 drawn (the right triangle's 12, the left's 6)."""
    verts = torch.tensor([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0],
                          [0.5, 0.5, 0.0], [-0.5, 0.5, 0.0]])
    scene = {"verts": verts, "faces": torch.tensor([[0, 1, 2], [0, 2, 3]]),
             "uvs": torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0],
                                  [0.0, 1.0]]),
             "tex": torch.full((2, 2, 4), 255, dtype=torch.uint8),
             "bg": torch.zeros(4)}
    m = torch.eye(4)
    assert ref.fragments(scene, m, 8, 8, torch.ones((8, 8))) == (30, 30)
    od = torch.ones((8, 8))
    od[:, :4] = 0.25
    assert ref.fragments(scene, m, 8, 8, od) == (30, 18)
    frame = ref.render(scene, m, 8, 8, od)
    assert int((frame[..., 3] > 0).sum()) == 15       # x 4..6, y 2..6
    work = {"frames": 1, "covered": 30, "drawn": 18, "pixels": 64,
            "shared_bytes": 1000, "frame_bytes": 64}
    n_bytes, n_ops = roof.work(work)
    assert n_bytes == 1000 + 64 + 64 * roof.OUT_PIXEL_BYTES
    assert n_ops == (30 * roof.COVERED_OPS + 18 * roof.DRAWN_OPS
                     + 64 * roof.PIXEL_OPS)
