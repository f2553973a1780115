"""The least work of the mesh raster (K1, K3), counted from a frame's
inputs: the mesh and the matrix read once, each covered (pixel, triangle)
fragment tested, each covered pixel shaded, each u8 pixel written once.

The operation counts are the reference's arithmetic, one operation each
(a multiply, an add, a compare): nothing is taken from the program's
binning, tiles, walks or culls, so a new walk changes the kernel's time
and not its yardstick.
"""

# three edge functions (2 multiplies and 2 adds each), three sign tests,
# the depth (3 multiplies, 2 adds), its quantisation and key (2), the
# depth compare (1)
FRAGMENT_OPS = 23
# Gouraud: three weights (3 multiplies), three colour channels (3
# multiplies and 2 adds each), each channel's quantisation (a multiply
# and two clamps)
GOURAUD_PIXEL_OPS = 27
# textured: three weights, 1/w, u/w and v/w (3 multiplies and 2 adds
# each), two divides, two scalings, two truncations and clamps (2 each)
TEXTURED_PIXEL_OPS = 26
OUT_PIXEL_BYTES = 4          # RGBA u8


def work(c: dict) -> tuple:
    """(bytes, operations) of the frames counted in ``c`` (the mesh
    system's ``work``)."""
    px_ops = TEXTURED_PIXEL_OPS if c["textured"] else GOURAUD_PIXEL_OPS
    n_bytes = c["input_bytes"] + c["pixels"] * OUT_PIXEL_BYTES
    n_ops = c["fragments"] * FRAGMENT_OPS + c["covered_pixels"] * px_ops
    return n_bytes, n_ops
