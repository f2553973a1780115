"""Package-level contracts of the PyTorch port: it imports no JAX, never
falls back to the CPU when a CUDA device is asked for, and rejects the
JAX package's TPU layout knobs, and its modules import one way."""

import ast
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
PORT = os.path.join(REPO, "libnativecpurenderer_tpu_torch")


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
            "import libnativecpurenderer_tpu_torch.ops.audio_ops; "
            "import libnativecpurenderer_tpu_torch.audio; "
            "import libnativecpurenderer_tpu_torch.media; "
            "import libnativecpurenderer_tpu_torch.models.midi; "
            "import libnativecpurenderer_tpu_torch.apps.hjm_mixer; "
            "import libnativecpurenderer_tpu_torch.apps.hjm_mixer_server; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'libnativecpurenderer_tpu.')) "
            "or m == 'libnativecpurenderer_tpu']; "
            "print(p.get_version(), bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1 []"
    # of the JAX package's public names only VideoCap is left to port
    import libnativecpurenderer_tpu as R
    assert set(R.__all__) - set(port.__all__) == {"VideoCap"}


def _imports_of(rel):
    """Each import statement of the port's module ``rel`` as (the dotted
    names it imports, its relative level, whether a function holds
    it)."""
    with open(os.path.join(PORT, rel)) as f:
        tree = ast.parse(f.read())
    local = {id(n) for fn in ast.walk(tree)
             if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(fn)}
    out = []
    for n in ast.walk(tree):
        if isinstance(n, ast.ImportFrom):
            mod = n.module or ""
            names = [mod] + [f"{mod}.{a.name}" for a in n.names]
            out.append((names, n.level, id(n) in local))
        elif isinstance(n, ast.Import):
            out.append(([a.name for a in n.names], 0, id(n) in local))
    return out


def _names_module(names, module):
    return any(module in name.split(".") for name in names)


def test_mesh_imports_point_one_way():
    """Mesh entries -> kernel wrappers -> ``_kernels``, the canvas ops
    beside them: the kernel wrappers and the canvas ops import nothing of
    ``raster3d``, ``sampling`` nothing of the package, and ``raster3d``
    and ``testing`` import ``tile_raster`` once, at module top."""
    for rel in ("ops/tile_raster.py", "ops/sampling.py", "ops/executor.py"):
        assert not any(_names_module(names, "raster3d")
                       for names, _, _ in _imports_of(rel)), rel
    assert all(level == 0 for _, level, _ in _imports_of("ops/sampling.py"))
    for rel in ("ops/raster3d.py", "testing.py"):
        imports = _imports_of(rel)
        assert not any(_names_module(names, "tile_raster") and local
                       for names, _, local in imports), rel
        assert any(_names_module(names, "tile_raster") and not local
                   for names, _, local in imports), rel
    # the names the tests and tools read through raster3d still resolve
    from libnativecpurenderer_tpu_torch.ops import sampling, tile_raster
    for name in ("IDX_BITS", "IDX_MASK", "Z_LEVELS", "NO_TRI", "SKY_KEY"):
        assert getattr(tr, name) == getattr(tile_raster, name)
    assert tr._to_i32 is sampling._to_i32 is tile_raster._to_i32


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


def test_audio_defaults_to_the_card(monkeypatch, tmp_path):
    # every AudioClip constructor and the mixer run on the card unless
    # given device="cpu": with no card the default raises, the CPU runs
    import types
    import wave
    from libnativecpurenderer_tpu_torch.apps import hjm_mixer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wav = str(tmp_path / "a.wav")
    with wave.open(wav, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(8000)
        w.writeframes(np.arange(40, dtype="<i2").tobytes())

    class Seg:
        sample_width, frame_rate, channels = 2, 8000, 1

        def get_array_of_samples(self, array_type_override=None):
            return [1, 2, 3]

    mid = tmp_path / "a.mid"
    mid.write_bytes(b"MThd" + (6).to_bytes(4, "big") + bytes([0, 0, 0, 1,
                                                             1, 224])
                    + b"MTrk" + (8).to_bytes(4, "big")
                    + bytes([0, 0x90, 60, 100, 0, 0xFF, 0x2F, 0]))
    makers = {
        "init": lambda **k: port.AudioClip(8000, 2, [0.1, 0.2], **k),
        "_from_array": lambda **k: port.AudioClip._from_array(
            8000, 1, np.zeros((4, 1)), **k),
        "slient": lambda **k: port.AudioClip.slient(8000, 2, 4, **k),
        "silent": lambda **k: port.AudioClip.silent(8000, 2, 4, **k),
        "from_file": lambda **k: port.AudioClip.from_file(wav, **k),
        "from_pydub_seg": lambda **k: port.AudioClip.from_pydub_seg(Seg(),
                                                                    **k),
        "int16": lambda **k: port.Int16CreatedAudioClip(8000, 1, [7, 8],
                                                        **k),
        "interop": lambda **k: interop.audio_clip_to_torch(
            8000, 1, np.zeros((4, 1)), k.get("device", "cuda")),
    }
    for name, make in makers.items():
        with pytest.raises(RuntimeError, match="is_available"):
            make()
        clip = make(device="cpu")
        assert clip.device == torch.device("cpu"), name
        assert clip.clone().device == torch.device("cpu"), name

    def args(**k):
        return types.SimpleNamespace(
            res=str(tmp_path), input=str(mid), output=str(tmp_path / "o.wav"),
            min_note=0, max_note=1, dnote=0, base=None, offset=0, **k)

    with pytest.raises(RuntimeError, match="is_available"):
        hjm_mixer.main(args())                    # the namespace's default
    with pytest.raises(RuntimeError, match="is_available"):
        hjm_mixer.main(args(device=hjm_mixer.build_parser().parse_args(
            ["-r", "r", "-i", "i", "-o", "o"]).device))
    hjm_mixer.main(args(device="cpu"))            # no note in range: silence
    with wave.open(str(tmp_path / "o.wav")) as w:
        assert w.getnframes() == 44100


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
