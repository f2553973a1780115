"""Build and load the port's CUDA kernels and its host cores.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
the package's ``_build/`` directory, named by a hash of the source and the
flags (so an edited source rebuilds), and loaded with ``ctypes``.  Pointers
and the stream are passed as ``c_void_p``; every C entry returns a
``cudaError_t``, and a non-zero one raises here.

``-fmad=false`` keeps nvcc from contracting a multiply and an add into one
fused operation: the kernels must round each product and sum the way the
plain torch versions do, bit for bit.  It governs the CUDA-core
arithmetic only: the matrix-unit walk (K1-mxu, ``wgmma``, which needs
``sm_90a``) accumulates its walk planes on the tensor cores, whose
float32 sums are not rounded to nearest one addition at a time, and is
held to its plain version within a tolerance.  ``-Xptxas=-v`` writes each kernel's register and
shared-memory use into the build log beside the library.

``csrc/<name>.c`` is a CPython extension module for the host (the record
core, ``csrc/record.c``; the SMF core, ``csrc/smf.c``), loaded by
:func:`host_core`.  The host's C compiler builds it the same way,
at first use, against the running Python's headers, under the same kind
of hashed name (the hash covers the Python's extension suffix too), and
``importlib`` loads it.  ``-ffp-contract=off`` keeps the compiler from
fusing a multiply into an add: the core must round each double operation
as CPython's float operations do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas=-v")
CC_FLAGS = ("-O2", "-fPIC", "-shared", "-ffp-contract=off", "-Wall",
            "-I", sysconfig.get_paths()["include"])

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from csrc/ at first use")


def _cc() -> str:
    for cand in ("gcc", "cc"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C compiler (gcc or cc) found: the port's host "
                       "cores are built from csrc/*.c at first use")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (with nvcc) or ``csrc/<name>.c`` (with
    the host's C compiler) unless its library is already built; returns
    the library's path.  The compiler's output is kept in a ``.log``
    beside it."""
    src = CSRC / f"{name}.cu"
    if src.exists():
        compiler, flags, key = _nvcc, NVCC_FLAGS, ""
    else:
        src = CSRC / f"{name}.c"
        compiler, flags = _cc, CC_FLAGS
        key = sysconfig.get_config_var("EXT_SUFFIX") or ""
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                         + key.encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([compiler(), *flags, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    log = res.stdout + res.stderr
    lib.with_suffix(".log").write_text(log)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"compiling {src.name} failed "
                           f"(rc {res.returncode}):\n{log}")
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """The compiler's output of the current build of ``name``."""
    return build(name).with_suffix(".log").read_text()


# why a host core could not be built or loaded, by name
core_errors: dict[str, str] = {}
# the same for the record core (None: it was, or has not been tried)
record_error: str | None = None


@functools.cache
def host_core(name: str):
    """The host core ``csrc/<name>.c`` as a loaded extension module,
    built at the first call; None where it cannot be built or loaded (no
    C compiler or no Python headers: ``core_errors[name]`` says why), and
    the callers take their Python path."""
    try:
        path = build(name)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except (OSError, RuntimeError, ImportError) as exc:
        core_errors[name] = f"{type(exc).__name__}: {exc}"
        return None


def record_core():
    """The record core (``csrc/record.c``): :func:`host_core`'s, with
    ``record_error`` saying why it is None."""
    global record_error
    core = host_core("record")
    record_error = core_errors.get("record")
    return core


def tile_raster() -> ctypes.CDLL:
    """The loaded ``tile_raster`` library (K1, K3, K2b, K2a, K5, K6, K1-wf,
    K1-mxu), built if needed."""
    lib = _libs.get("tile_raster")
    if lib is None:
        lib = ctypes.CDLL(str(build("tile_raster")))
        p, i = ctypes.c_void_p, ctypes.c_int
        # ids, ids_len, starts, counts, nblocks, nt, table, nrows, ntx,
        # tile_w, tile_h, z_clip; then each entry's epilogue; then the
        # stream
        walk = [p, i, p, p, i, i, p, i, i, i, i, i]
        split = [p, i, p]   # the split walk's items, cap, counters
        for entry, epilogue in (("tile_raster_u8",
                                 [p, i, i, i, p] + split),
                                ("tile_raster_tex_u8",
                                 [p, i, i, p, i, p] + split),
                                ("tile_raster_tex_idx", [i, i, p] + split),
                                ("tile_raster_keys_f32", [p, p] + split),
                                ("tile_raster_bins_f32", [p, p] + split),
                                ("tile_raster_rows_u8", [p, i, p] + split)):
            fn = getattr(lib, entry)
            fn.argtypes = walk + epilogue + [p]
            fn.restype = ctypes.c_int
        # rows, n, ox, oy, tile_w, mxu, out, stream
        lib.tile_raster_mma_probe.argtypes = [p, i, i, i, i, i, p, p]
        lib.tile_raster_mma_probe.restype = ctypes.c_int
        lib.tile_raster_occupancy.argtypes = [i, i, i, i, i, p]
        lib.tile_raster_occupancy.restype = ctypes.c_int
        lib.tile_raster_error_string.argtypes = [ctypes.c_int]
        lib.tile_raster_error_string.restype = ctypes.c_char_p
        _libs["tile_raster"] = lib
    return lib


def canvas_span() -> ctypes.CDLL:
    """The loaded ``canvas_span`` library (K4), built if needed."""
    lib = _libs.get("canvas_span")
    if lib is None:
        lib = ctypes.CDLL(str(build("canvas_span")))
        p, i = ctypes.c_void_p, ctypes.c_int
        # fb, W, H, kinds, params, n, tiles, n_tiles, atlas, AH, AW,
        # is_double, stream
        lib.canvas_span.argtypes = [p, i, i, p, p, i, p, i, p, i, i, i, p]
        lib.canvas_span.restype = ctypes.c_int
        lib.canvas_span_error_string.argtypes = [ctypes.c_int]
        lib.canvas_span_error_string.restype = ctypes.c_char_p
        _libs["canvas_span"] = lib
    return lib


def launch_canvas_span(fb, width, height, kinds, params, n, tiles, n_tiles,
                       atlas, atlas_h, atlas_w, is_double, stream) -> None:
    """Launch K4 over the n_tiles tiles listed at ``tiles`` (0: every
    tile), its texture blits reading the atlas_h x atlas_w atlas at
    ``atlas`` (0, 0, 0: none) (pointers and stream as ints); raises on a
    refused launch."""
    lib = canvas_span()
    err = lib.canvas_span(fb, width, height, kinds, params, n, tiles,
                          n_tiles, atlas, atlas_h, atlas_w, int(is_double),
                          stream)
    if err:
        raise RuntimeError(
            f"canvas_span launch failed: cudaError {err} "
            f"({lib.canvas_span_error_string(err).decode()})")


def audio_scatter() -> ctypes.CDLL:
    """The loaded ``audio_scatter`` library (the scatter routes' segment
    table executor), built if needed."""
    lib = _libs.get("audio_scatter")
    if lib is None:
        lib = ctypes.CDLL(str(build("audio_scatter")))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # target, rows, C, row_lo, row_hi, table, n_runs, ptrs, is_double,
        # stream
        lib.audio_scatter.argtypes = [p, ll, i, ll, ll, p, i, p, i, p]
        lib.audio_scatter.restype = ctypes.c_int
        lib.audio_scatter_error_string.argtypes = [ctypes.c_int]
        lib.audio_scatter_error_string.restype = ctypes.c_char_p
        _libs["audio_scatter"] = lib
    return lib


def launch_audio_scatter(target, rows, channels, row_lo, row_hi, table,
                         n_runs, ptrs, is_double, stream) -> None:
    """Launch the segment table executor over the n_runs rows at
    ``table`` into the (rows, channels) target, whose target rows all lie
    in ``[row_lo, row_hi)``, each group's source at ``ptrs`` (pointers and
    stream as ints); raises on a refused launch."""
    lib = audio_scatter()
    err = lib.audio_scatter(target, rows, channels, row_lo, row_hi, table,
                            n_runs, ptrs, int(is_double), stream)
    if err:
        raise RuntimeError(
            f"audio_scatter launch failed: cudaError {err} "
            f"({lib.audio_scatter_error_string(err).decode()})")


def tile_blend() -> ctypes.CDLL:
    """The loaded ``tile_blend`` library (K7), built if needed."""
    lib = _libs.get("tile_blend")
    if lib is None:
        lib = ctypes.CDLL(str(build("tile_blend")))
        p, i = ctypes.c_void_p, ctypes.c_int
        # ids, ids_len, starts, counts, nblocks, nt, table, nrows, order,
        # n_faces, ntx, tile_w, tile_h, depth, width, height, tex, tex_w,
        # tex_h, bg, out, stream
        lib.tile_blend_u8.argtypes = [p, i, p, p, i, i, p, i, p, i, i, i, i,
                                      p, i, i, p, i, i, p, p, p]
        lib.tile_blend_u8.restype = ctypes.c_int
        lib.tile_blend_error_string.argtypes = [ctypes.c_int]
        lib.tile_blend_error_string.restype = ctypes.c_char_p
        _libs["tile_blend"] = lib
    return lib


def launch_tile_blend(*args) -> None:
    """Launch K7 (pointers and stream as ints, in the order of
    ``tile_blend_u8``'s argtypes); raises on a refused launch."""
    lib = tile_blend()
    err = lib.tile_blend_u8(*args)
    if err:
        raise RuntimeError(
            f"tile_blend_u8 launch failed: cudaError {err} "
            f"({lib.tile_blend_error_string(err).decode()})")


# The walks of ``tile_raster_occupancy``, each at its C entry's number
# (its index here)
WALKS = ("split FMA", "split MMA", "split bins", "split pairs f32")


def tile_raster_occupancy(walk: str, tex: bool, tile_w: int, tile_h: int,
                          z_clip: bool) -> tuple[int, int]:
    """(registers a thread, resident blocks an SM) of the kernel a launch
    at tiles of ``tile_w`` x ``tile_h`` pixels runs, ``walk`` one of
    :data:`WALKS`: K1's (K3's with ``tex``) split walk on the CUDA cores
    or on the tensor cores (K1-mxu, K3's mxu walk); "split bins" K5's
    kernel (``tex`` and ``z_clip`` not read) and "split pairs f32" K2a's
    (``tex`` not read), each with its warp boxes and cull at tiles 128
    wide, as their launches take them."""
    lib = tile_raster()
    regs = ctypes.c_int(0)
    n = lib.tile_raster_occupancy(WALKS.index(walk), int(tex), tile_w,
                                  tile_h, int(z_clip), ctypes.byref(regs))
    if n < 0:
        raise RuntimeError(f"tile_raster_occupancy failed: cudaError {-n} "
                           f"({lib.tile_raster_error_string(-n).decode()})")
    return regs.value, n


def launch_tile_raster(entry: str, *args) -> None:
    """Launch ``entry`` of the tile_raster library (pointers and stream
    as ints, in the order of its ``argtypes``); raises on a refused
    launch."""
    lib = tile_raster()
    err = getattr(lib, entry)(*args)
    if err:
        raise RuntimeError(
            f"{entry} launch failed: cudaError {err} "
            f"({lib.tile_raster_error_string(err).decode()})")
