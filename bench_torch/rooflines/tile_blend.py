"""The least work of the blended quad batch (K7), counted from a frame's
inputs: the texture, the opaque depth and the quads read once, each
frame's matrix read and its u8 pixels written once; each covered
(pixel, triangle) fragment tested, each fragment that passes the z test
blended, each pixel quantised.

The operation counts are the reference's arithmetic, one operation each
(a multiply, an add, a compare, a divide): the fragments are the
reference's coverage (``references/quad_blend.fragments``), nothing is
taken from the program's binning, tiles or runs, so a new walk changes
the kernel's time and not its yardstick.
"""

# a covered fragment: three edge functions (2 multiplies and 2 adds
# each), three sign tests, three weights (a multiply each), the depth (3
# multiplies, 2 adds) and its two tests
COVERED_OPS = 25
# a drawn fragment: u and v (3 multiplies and 2 adds each), the texel
# index (2 scalings, 2 truncations, 4 clamps, a multiply and an add), the
# four channels' divides, the blend (1 - a, 6 multiplies, 3 adds, the
# alpha's maximum)
DRAWN_OPS = 35
# a pixel: four channels quantised (a multiply and two clamps each)
PIXEL_OPS = 12
OUT_PIXEL_BYTES = 4          # RGBA u8


def work(c: dict) -> tuple:
    """(bytes, operations) of the frames counted in ``c`` (the blend
    system's ``work``)."""
    n_bytes = (c["shared_bytes"] + c["frames"] * c["frame_bytes"]
               + c["pixels"] * OUT_PIXEL_BYTES)
    n_ops = (c["covered"] * COVERED_OPS + c["drawn"] * DRAWN_OPS
             + c["pixels"] * PIXEL_OPS)
    return n_bytes, n_ops
