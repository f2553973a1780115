"""Host media I/O: audio decode + encode bindings, and the u8 detile.

The port's copy of ``libnativecpurenderer_tpu/media.py``.  The reference
links FFmpeg's libav* into its native core (``libNativeCPURenderer.h:20-25``,
``compile.sh``); this repo does the same through its own C++ runtime
(``native/media.cpp`` -> ``native/build/libtpurmedia.so``, built by
``make -C native``), which both packages load with ctypes: native code is
shared, not ported.  Without the build, decoding reads 16-bit PCM WAVs
with the stdlib and encoding writes a WAV whatever the file's extension,
as the JAX package does.  Everything here runs on the host.
"""

from __future__ import annotations

import ctypes
import os
import wave
from typing import Optional, Tuple

import numpy as np

from .ops.audio_ops import to_int16

_LIB_NAMES = ("libtpurmedia.so",)
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _find_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    here = os.path.dirname(os.path.abspath(__file__))
    # the repo's native/build beside this package, then the loader's path
    candidates = [
        os.path.join(here, "..", "native", "build", n) for n in _LIB_NAMES
    ] + [os.path.join(here, n) for n in _LIB_NAMES] + list(_LIB_NAMES)
    for c in candidates:
        try:
            lib = ctypes.CDLL(c)
        except OSError:
            continue
        _configure(lib)
        _lib = lib
        break
    return _lib


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.MediaDecodeAudio.argtypes = (c.c_char_p, c.POINTER(c.c_longlong),
                                     c.POINTER(c.c_longlong),
                                     c.POINTER(c.c_longlong))
    lib.MediaDecodeAudio.restype = c.c_void_p
    lib.MediaFreeBuffer.argtypes = (c.c_void_p,)
    lib.MediaFreeBuffer.restype = None

    lib.EncCreate.argtypes = (c.c_char_p, c.c_longlong, c.c_longlong,
                              c.c_double, c.c_longlong)
    lib.EncCreate.restype = c.c_void_p
    lib.EncAddAudio.argtypes = (c.c_void_p, c.c_void_p, c.c_longlong,
                                c.c_longlong, c.c_longlong, c.c_longlong)
    lib.EncAddAudio.restype = c.c_int
    lib.EncPutFrame.argtypes = (c.c_void_p, c.c_void_p, c.c_longlong,
                                c.c_longlong)
    lib.EncPutFrame.restype = c.c_int
    lib.EncPutFrameTiled.argtypes = (c.c_void_p, c.c_void_p, c.c_longlong,
                                     c.c_longlong, c.c_longlong,
                                     c.c_longlong)
    lib.EncPutFrameTiled.restype = c.c_int
    lib.MediaDetileU8.argtypes = (c.c_void_p, c.c_void_p, c.c_longlong,
                                  c.c_longlong, c.c_longlong, c.c_longlong)
    lib.MediaDetileU8.restype = None
    lib.EncFinish.argtypes = (c.c_void_p,)
    lib.EncFinish.restype = c.c_int

    lib.MediaEncodeAudioFile.argtypes = (c.c_char_p, c.c_void_p,
                                         c.c_longlong, c.c_longlong,
                                         c.c_longlong, c.c_longlong)
    lib.MediaEncodeAudioFile.restype = c.c_int


def native_available() -> bool:
    return _find_lib() is not None


def detile_u8(tiles: np.ndarray, width: int, height: int, tile_w: int,
              tile_h: int) -> np.ndarray:
    """C detile of a tiled u8 frame (the tile kernels' ``tiled=True``
    output): (NT, tile_h*tile_w, 4) uint8 -> (H, W, 4) uint8 raster
    order, cropping padded slots; NumPy when the native build is
    absent."""
    lib = _find_lib()
    src = np.ascontiguousarray(tiles, dtype=np.uint8)
    dst = np.empty((height, width, 4), np.uint8)
    if lib is None:
        ntx = (width + tile_w - 1) // tile_w
        nty = (height + tile_h - 1) // tile_h
        a = src.reshape(nty, ntx, tile_h, tile_w, 4)
        a = np.moveaxis(a, 2, 1).reshape(nty * tile_h, ntx * tile_w, 4)
        dst[:] = a[:height, :width]
        return dst
    lib.MediaDetileU8(dst.ctypes.data_as(ctypes.c_void_p),
                      src.ctypes.data_as(ctypes.c_void_p),
                      width, height, tile_w, tile_h)
    return dst


def decode_audio(path: str) -> Tuple[int, int, np.ndarray]:
    """Decode any audio file to (sample_rate, channels, float64 (N, C))."""
    lib = _find_lib()
    if lib is not None:
        c = ctypes
        rate = c.c_longlong()
        channels = c.c_longlong()
        frames = c.c_longlong()
        ptr = lib.MediaDecodeAudio(path.encode(), c.byref(rate),
                                   c.byref(channels), c.byref(frames))
        if ptr:
            n = frames.value * channels.value
            buf = np.ctypeslib.as_array(
                c.cast(ptr, c.POINTER(c.c_float)), shape=(n,)).copy()
            lib.MediaFreeBuffer(ptr)
            return (rate.value, channels.value,
                    buf.astype(np.float64).reshape(frames.value,
                                                   channels.value))
        raise IOError(f"native decode failed for {path}")
    return _decode_wav(path)


def _decode_wav(path: str) -> Tuple[int, int, np.ndarray]:
    """stdlib fallback: 16-bit PCM WAV only (the instrument banks under
    test_files/{ha,ji,mi} are 48 kHz s16 stereo WAVs)."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise IOError("WAV fallback supports 16-bit PCM only")
        rate = w.getframerate()
        channels = w.getnchannels()
        raw = w.readframes(w.getnframes())
    pcm = np.frombuffer(raw, np.int16).astype(np.float64) / 32768.0
    return rate, channels, pcm.reshape(-1, channels)


_LAME_RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)


def encode_audio_file(path: str, pcm_f32: np.ndarray, rate: int,
                      bit_rate: int = 180000) -> None:
    """Encode (N, C) float PCM to a compressed file (mp3/aac by extension)
    via the native runtime; falls back to writing a WAV.

    MP3 only supports fixed MPEG sample rates; off-grid rates are snapped
    to the nearest supported one with a host linear resample."""
    arr = np.ascontiguousarray(pcm_f32, np.float32)
    if path.lower().endswith(".mp3") and rate not in _LAME_RATES:
        new_rate = min(_LAME_RATES, key=lambda r: abs(r - rate))
        n_out = int(arr.shape[0] * new_rate / rate)
        t_out = np.arange(n_out) * (rate / new_rate)
        t_in = np.arange(arr.shape[0])
        arr = np.stack([np.interp(t_out, t_in, arr[:, c])
                        for c in range(arr.shape[1])], axis=1)
        arr = np.ascontiguousarray(arr, np.float32)
        rate = new_rate
    lib = _find_lib()
    if lib is not None:
        rc = lib.MediaEncodeAudioFile(
            path.encode(), arr.ctypes.data_as(ctypes.c_void_p),
            int(rate), int(arr.shape[1]), int(arr.shape[0]), int(bit_rate))
        if rc != 0:
            raise IOError(f"native audio encode failed ({rc}) for {path}")
        return
    # fallback: ignore extension, write RIFF/WAVE
    pcm16 = to_int16(arr)
    with wave.open(path, "wb") as w:
        w.setnchannels(arr.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm16.tobytes())
