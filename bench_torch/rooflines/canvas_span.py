"""The least work of the canvas kernel (K4) over a frame's draw calls
(fill, rect, line, gradient) and texture blits, counted from the draw
list by the reference: each pixel that some call covers read and written
once, each call's arguments read once, each texel a blit reads read once
a frame, and for every pixel a call covers its coverage test, colour or
texel index, colour transform and blend.

Operation counts are the reference renderer's arithmetic, one operation
each; nothing comes from the program's tiles or its kernel source.
"""

# the colour transform's 4 multiplies, 1 - a, then per colour channel
# dst * (1 - a) + src * a
BLEND_OPS = 14
# a blit's texel: u and v clamped (four compares), then the flat index
# (a multiply and an add)
TEXEL_OPS = 4 + 2
PER_PX_OPS = {
    "fill_color": BLEND_OPS,
    "draw_rect": 4 + BLEND_OPS,                   # four bound compares
    # four bound compares, t = (y - y0) / h, four lerps (3 each)
    "draw_vertical_grd": 4 + 2 + 12 + BLEND_OPS,
    # even-odd test: per quad edge two compares, the crossing's x
    # (sub, mul, div, add), the compare and the flip
    "draw_line": 4 * 8 + BLEND_OPS,
    # four bound compares, u and v (a subtract and a multiply each)
    "draw_texture": 4 + 4 + TEXEL_OPS + BLEND_OPS,
    # the fast path: no bound test
    "draw_texture_fast": 4 + TEXEL_OPS + BLEND_OPS,
    # as draw_texture, then each of u and v remapped into its part,
    # (u0 + (u1 - u0) * u / tw) * tw: five operations
    "draw_splitted_texture": 4 + 4 + 10 + TEXEL_OPS + BLEND_OPS,
}
ARGS = {"fill_color": 4, "draw_rect": 8, "draw_vertical_grd": 12,
        "draw_line": 9, "draw_texture": 4, "draw_texture_fast": 4,
        "draw_splitted_texture": 8}


def work(c: dict) -> tuple:
    """(bytes, operations) of the frames counted in ``c`` (the chart
    system's ``work``)."""
    word = c["px_bytes"] // 4
    n_bytes = (2 * c["union_px"] * c["px_bytes"] + c["texel_bytes"]
               + sum(ARGS[k] * n * word for k, n in c["calls"].items()))
    n_ops = sum(PER_PX_OPS[k] * n for k, n in c["covered_px"].items())
    return n_bytes, n_ops
