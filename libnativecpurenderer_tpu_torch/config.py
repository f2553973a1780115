"""Global configuration for the PyTorch port.

Counterpart of ``libnativecpurenderer_tpu/config.py:31-45``: the default
floating dtype of the tensors the port builds from host arrays
(``interop.mesh_to_torch``, textures, ``RenderContext`` framebuffers),
and the texture atlas geometry.  The raster path computes its setup in
that dtype and always hands the tile kernel a float32 row table, as the
JAX package does.

There is no device setting: every function runs on the device of the
tensors it is given, and ``MeshVideoPipeline`` and ``RenderContext`` take
an explicit ``device=``.  The JAX package's flush and compile knobs pick
TPU routes and have no counterpart.
"""

from __future__ import annotations

import torch

_default_dtype = torch.float32


def set_default_dtype(dtype: torch.dtype) -> None:
    global _default_dtype
    if not dtype.is_floating_point:
        raise ValueError(f"default dtype must be floating, got {dtype}")
    _default_dtype = dtype


def default_dtype() -> torch.dtype:
    return _default_dtype


# Texture atlas geometry (see atlas.py)
ATLAS_WIDTH = 4096
ATLAS_INIT_HEIGHT = 1024
