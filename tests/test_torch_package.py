"""Package-level contracts of the PyTorch port: it imports no JAX, never
falls back to the CPU when a CUDA device is asked for, and rejects the
JAX package's TPU layout knobs."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import libnativecpurenderer_tpu_torch as port
from libnativecpurenderer_tpu_torch import config, interop
from libnativecpurenderer_tpu_torch.ops import raster3d as tr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    code = ("import sys, libnativecpurenderer_tpu_torch as p; "
            "import libnativecpurenderer_tpu_torch.ops.tile_raster; "
            "import libnativecpurenderer_tpu_torch.ops._kernels; "
            "import libnativecpurenderer_tpu_torch.ops.canvas_kernel; "
            "import libnativecpurenderer_tpu_torch.ops.executor; "
            "import libnativecpurenderer_tpu_torch.ops.noise; "
            "import libnativecpurenderer_tpu_torch.ops.sampling; "
            "import libnativecpurenderer_tpu_torch.context; "
            "import libnativecpurenderer_tpu_torch.helpers; "
            "import libnativecpurenderer_tpu_torch.core.state; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'libnativecpurenderer_tpu.')) "
            "or m == 'libnativecpurenderer_tpu']; "
            "print(p.get_version(), bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1 []"


def _tri():
    verts = np.array([[-0.5, -0.5, 0.2], [0.7, -0.2, 0.2], [0.0, 0.8, 0.2]],
                     np.float32)
    return verts, np.array([[0, 1, 2]]), np.ones((3, 4), np.float32)


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts, faces, colors = _tri()
    with pytest.raises(RuntimeError, match="is_available"):
        interop.mesh_to_torch(verts, faces, colors, "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        interop.prep_to_torch([0], [0], [0], np.zeros((1, 32)), "cuda:0")
    with pytest.raises(RuntimeError, match="is_available"):
        port.MeshVideoPipeline(object(), 16, 16, verts, faces,
                               colors=colors, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        port.RenderContext(16, 16, True)           # the default device
    with pytest.raises(RuntimeError, match="is_available"):
        interop.commands_to_torch([0], np.zeros((1, 32)), torch.float32,
                                  "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        interop.canvas_to_torch(np.zeros((2, 2, 4)), np.zeros((2, 2, 4)),
                                "cuda")


@pytest.mark.parametrize("knob,value", [
    ("interpret", True), ("resident_out", True), ("mega", 8), ("wf", 8),
    ("out8", True), ("ktail", 8), ("mxu", 1), ("dynrows", 1),
    ("near_clip", True)])
def test_tpu_knobs_raise_type_error(knob, value):
    verts, faces, colors = interop.mesh_to_torch(*_tri(), "cpu")
    if knob in ("near_clip", "wf", "mxu"):
        # parameters of the single-frame entry now (the JAX entry has
        # them: wf walks K1-wf, mxu K1-mxu); the loop entry and the
        # pipeline, like JAX's loop, do not
        frame, ovf = tr.render_gouraud_u8(verts, faces, colors, 16, 16,
                                          **{knob: value})
        assert frame.shape == (16, 16, 4) and not bool(ovf)
        assert frame[..., 3].any()
    else:
        with pytest.raises(TypeError):
            tr.render_gouraud_u8(verts, faces, colors, 16, 16,
                                 **{knob: value})
    with pytest.raises(TypeError):
        tr.render_gouraud_u8_loop(verts, faces, colors, 16, 16,
                                  torch.eye(4)[None], **{knob: value})
    with pytest.raises(TypeError):
        port.MeshVideoPipeline(object(), 16, 16, *_tri()[:2],
                               colors=_tri()[2], device="cpu",
                               **{knob: value})


@pytest.mark.parametrize("knob,value", [
    ("interpret", True), ("resident_out", True), ("mega", 8), ("wf", 8),
    ("out8", True), ("ktail", 8), ("wide_split", True), ("mxu", 1)])
def test_gouraud_pallas_tpu_knobs_raise_type_error(knob, value):
    # the float entries refuse the TPU layout knobs; kcc is accepted and
    # changes no value.  wf and mxu are taken on the flat u8 route (the
    # batch entry takes mxu only, as JAX's) and refused with a ValueError
    # on the others, as the JAX entries assert
    verts, faces, colors = interop.mesh_to_torch(*_tri(), "cpu")
    u8 = dict(flat=True, u8=True)
    eye = torch.eye(4)[None]
    if knob in ("wf", "mxu"):
        frame, _, ovf = tr.render_gouraud_pallas(verts, faces, colors, 16,
                                                 16, **u8, **{knob: value})
        assert frame.shape == (16, 16, 4) and not bool(ovf)
        with pytest.raises(ValueError):
            tr.render_gouraud_pallas(verts, faces, colors, 16, 16,
                                     **{knob: value})
    else:
        for kw in (dict(), u8):
            with pytest.raises(TypeError):
                tr.render_gouraud_pallas(verts, faces, colors, 16, 16,
                                         **kw, **{knob: value})
    if knob == "mxu":
        frames, _, ovf = tr.render_gouraud_pallas_batch(
            verts, faces, colors, 16, 16, eye, **u8, mxu=value)
        assert frames.shape == (1, 16, 16, 4) and not bool(ovf)
        with pytest.raises(ValueError):
            tr.render_gouraud_pallas_batch(verts, faces, colors, 16, 16,
                                           eye, mxu=value)
    else:
        for kw in (dict(), u8):
            with pytest.raises(TypeError):
                tr.render_gouraud_pallas_batch(verts, faces, colors, 16, 16,
                                               eye, **kw, **{knob: value})
    a = tr.render_gouraud_pallas(verts, faces, colors, 16, 16, kcc=8)
    b = tr.render_gouraud_pallas(verts, faces, colors, 16, 16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_textured_pipeline_not_ported_yet():
    # named when the textured half raised NotImplementedError; it is
    # ported now, and this checks the arguments it takes: exactly one of
    # colors and (uvs, tex_u8), the textured loop's keywords
    verts, faces, colors = _tri()
    uvs, tex = np.zeros((3, 2)), np.zeros((4, 4, 4), np.uint8)
    pipe = port.MeshVideoPipeline(object(), 16, 16, verts, faces, uvs=uvs,
                                  tex_u8=tex, device="cpu",
                                  perspective_correct=False)
    assert pipe._render is tr.render_textured_u8_loop
    for bad in (dict(), dict(colors=colors, uvs=uvs, tex_u8=tex),
                dict(uvs=uvs), dict(tex_u8=tex), dict(colors=colors,
                                                      tex_u8=tex)):
        with pytest.raises(ValueError, match="exactly one"):
            port.MeshVideoPipeline(object(), 16, 16, verts, faces,
                                   device="cpu", **bad)
    with pytest.raises(TypeError):
        port.MeshVideoPipeline(object(), 16, 16, verts, faces, uvs=uvs,
                               tex_u8=tex, device="cpu", opaque=True)


def test_default_dtype_feeds_mesh_tensors():
    prev = config.default_dtype()
    try:
        config.set_default_dtype(torch.float64)
        v, f, c = interop.mesh_to_torch(*_tri(), "cpu")
        assert v.dtype == c.dtype == torch.float64 and f.dtype == torch.int64
        with pytest.raises(ValueError):
            config.set_default_dtype(torch.int32)
    finally:
        config.set_default_dtype(prev)
    assert interop.mesh_to_torch(*_tri(), "cpu")[0].dtype == torch.float32


@pytest.mark.parametrize("knob,value", [
    ("flush_mode", "scan"), ("canvas_kernel", False), ("canvas_group_g", 4),
    ("flush_unrolled", True), ("flush_unroll_min_seen", 1),
    ("flush_unroll_compile_cap", 160), ("pipeline_vmap", True),
    ("interpret", True)])
def test_canvas_tpu_knobs_raise_type_error(knob, value):
    with pytest.raises(TypeError):
        port.RenderContext(16, 16, True, device="cpu", **{knob: value})
    # nor does the port's config carry them
    assert not hasattr(config, f"set_{knob}")


def test_atlas_store_needs_a_device():
    # no public function of the port falls to the CPU when no device is
    # named: the atlas store takes its device as a required argument
    from libnativecpurenderer_tpu_torch import atlas
    with pytest.raises(TypeError):
        atlas.get_store(torch.float32)
    store = atlas.get_store(None, "cpu")
    assert store.dtype == config.default_dtype()
    assert store.atlas.device == torch.device("cpu")
