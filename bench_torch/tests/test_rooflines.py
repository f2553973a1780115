"""The roofline counts against brute-force counts at a small size: the
mesh raster's covered fragments and pixels (and the reference's frame)
against a per-pixel loop over every triangle, K4's covered and union
pixels and the texels its blits read against pixels marked one by one
under a plain rotation."""

import math

import numpy as np
import pytest
import torch

from bench_torch.generators import camera_orbit as orbit
from bench_torch.harness import peaks
from bench_torch.references import canvas as canvas_ref
from bench_torch.references import mesh_raster
from bench_torch.rooflines import canvas_span, raster
from bench_torch.scenes import mesh_10k
from bench_torch.systems import chart_video

W, H = 40, 24


def brute_mesh(verts, faces, colors, mvp):
    """(u8 frame, covered fragments, covered pixels) by a loop over every
    pixel and triangle, in float64."""
    v4 = np.concatenate([verts, np.ones((len(verts), 1))], 1)
    clip = v4 @ mvp.T
    w = clip[:, 3]
    ndc = clip[:, :3] / w[:, None]
    sx = np.round((ndc[:, 0] * 0.5 + 0.5) * W * 256) / 256
    sy = np.round((0.5 - ndc[:, 1] * 0.5) * H * 256) / 256
    sz = ndc[:, 2] * 0.5 + 0.5
    best = {}
    frags = 0
    for fi, (a, b, c) in enumerate(faces):
        if min(w[a], w[b], w[c]) <= 1e-6:
            continue
        x0, y0, x1, y1, x2, y2 = sx[a], sy[a], sx[b], sy[b], sx[c], sy[c]
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        if abs(area) <= 1e-12:
            continue
        s = math.copysign(1.0, area)
        for py in range(H):
            for px in range(W):
                e0 = (y1 - y2) * px + (x2 - x1) * py + (x1 * y2 - x2 * y1)
                e1 = (y2 - y0) * px + (x0 - x2) * py + (x2 * y0 - x0 * y2)
                e2 = (y0 - y1) * px + (x1 - x0) * py + (x0 * y1 - x1 * y0)
                if e0 * s < 0 or e1 * s < 0 or e2 * s < 0:
                    continue
                ws = (e0 / area, e1 / area, e2 / area)
                z = ws[0] * sz[a] + ws[1] * sz[b] + ws[2] * sz[c]
                if not 0 <= z <= 1:
                    continue
                frags += 1
                key = (int(min(max(z * mesh_raster.Z_LEVELS, 0),
                               mesh_raster.Z_LEVELS)) << 18) | fi
                if key < best.get((py, px), (key + 1,))[0]:
                    col = (ws[0] * colors[a] + ws[1] * colors[b]
                           + ws[2] * colors[c])
                    best[(py, px)] = (key, col)
    out = np.zeros((H, W, 4), np.uint8)
    for (py, px), (_, col) in best.items():
        out[py, px, :3] = np.clip(col[:3] * 255, 0, 255).astype(np.uint8)
        out[py, px, 3] = 255
    return out, frags, len(best)


@pytest.mark.parametrize("angle", [0.0, 1.3])
def test_mesh_counts_against_brute_force(angle):
    v, f = mesh_10k.icosphere(1)
    v = v.astype(np.float32).astype(np.float64)
    col = np.concatenate([(v + 1) / 2, np.ones((len(v), 1))], 1)
    mvp = (orbit.perspective(1.0, W / H, 0.1, 10.0)
           @ orbit.look_at([0, 0.6, 3.2], [0, 0, 0], [0, 1, 0])
           @ orbit.rotation_y(angle)).astype(np.float32)
    want, frags, px = brute_mesh(v, f, col, mvp.astype(np.float64))
    mesh = dict(verts=torch.from_numpy(v), faces=torch.from_numpy(f),
                colors=torch.from_numpy(col))
    got, n_frag, n_px = mesh_raster.render(mesh, torch.from_numpy(mvp), W, H)
    assert (n_frag, n_px) == (frags, px) and frags > px > 50
    assert np.array_equal(got.numpy(), want)
    c = {"textured": False, "input_bytes": 1000, "pixels": W * H,
         "fragments": n_frag, "covered_pixels": n_px}
    n_bytes, n_ops = raster.work(c)
    assert n_bytes == 1000 + 4 * W * H
    assert n_ops == 23 * frags + 27 * px
    assert peaks.bound_s(n_bytes, n_ops) == max(n_bytes / 3.35e12,
                                                 n_ops / 67e12)


FRAME = [
    ["fill_color", 0.1, 0.1, 0.1, 0.5],
    ["save_state"], ["translate", 20.5, 6.25], ["rotate_degree", 30],
    ["draw_rect", 0, 0, 9.5, 4, 1, 0, 0, 0.5],
    ["draw_vertical_grd", -3, -2, 6, 7, 0, 0, 0, 0, 1, 1, 1, 1],
    ["draw_texture", "t", 0, 0, 5, 5],
    ["draw_line", 1, 1, 12, 3, 2, 1, 1, 1, 0.8],
    ["restore_state"],
    ["draw_line", 2, 20, 30, 22, 3, 0, 1, 0, 1],
    ["draw_splitted_texture", "t", 1, 1, 10, 10, 0, 1, 0, 1],
]


C30, S30 = math.cos(math.pi / 6), math.sin(math.pi / 6)
TW, TH = 9, 7                # texture "t"'s texels


def rot(x, y):
    return (20.5 + C30 * x - S30 * y, 6.25 + S30 * x + C30 * y)


def local(x, y, rotated):
    """Pixel (x, y)'s centre mapped back by the inverse of the rotation
    (or not at all) and snapped to 2^-20."""
    u, v = x, y
    if rotated:
        dx, dy = x - 20.5, y - 6.25
        u, v = C30 * dx + S30 * dy, -S30 * dx + C30 * dy
    return round(u * 2 ** 20) / 2 ** 20, round(v * 2 ** 20) / 2 ** 20


def covered(inside, rotated, rect=None):
    """Pixels whose centre ``local`` maps to a point ``inside`` holds:
    marked one by one, over the whole frame (a line) or over the pixel
    box of the rect's corners, mapped by the rotation where ``rotated``
    and truncated (x, y, w, h: a rect's draw)."""
    lo_x, lo_y, hi_x, hi_y = 0, 0, W, H
    if rect is not None:
        x, y, w, h = rect
        pts = [(x, y), (x + w, y), (x, y + h), (x + w, y + h)]
        if rotated:
            pts = [rot(*p) for p in pts]
        lo_x = max(0, int(min(p[0] for p in pts)))
        hi_x = min(W, int(max(p[0] for p in pts)))
        lo_y = max(0, int(min(p[1] for p in pts)))
        hi_y = min(H, int(max(p[1] for p in pts)))
    mark = np.zeros((H, W), bool)
    for y in range(lo_y, hi_y):
        for x in range(lo_x, hi_x):
            mark[y, x] = inside(*local(x, y, rotated))
    return mark


def texels(mask, point, to_uv):
    """The flat indices of the texels that ``mask``'s pixels read: (u,
    v) of a pixel's ``point`` by ``to_uv``, u clamped to [0, TW - 2], v
    to [0, TH - 2], each truncated."""
    out = set()
    for y, x in zip(*np.nonzero(mask)):
        u, v = to_uv(*point(int(x), int(y)))
        u = 0.0 if u < 0 else (TW - 2.0 if u >= TW - 1 else u)
        v = 0.0 if v < 0 else (TH - 2.0 if v >= TH - 1 else v)
        out.add(int(v) * TW + int(u))
    return out


def in_rect(x, y, w, h):
    return lambda u, v: x <= u <= x + w and y <= v <= y + h


def in_quad(pts):
    def inside(u, v):
        res, j = False, 3
        for i in range(4):
            (xi, yi), (xj, yj) = pts[i], pts[j]
            if (yi > v) != (yj > v) and u < (xj - xi) * (v - yi) / (
                    yj - yi) + xi:
                res = not res
            j = i
        return res
    return inside


def chart_system():
    sysm = chart_video.System.__new__(chart_video.System)
    sysm.width, sysm.height, sysm.px_bytes = W, H, 16
    sysm.texels = {"t": torch.zeros((TH, TW, 4), dtype=torch.float32)}
    return sysm


def test_canvas_counts_against_marked_pixels():
    masks = {
        "fill_color": [np.ones((H, W), bool)],
        "draw_rect": [covered(in_rect(0, 0, 9.5, 4), True,
                              (0, 0, 9.5, 4))],
        "draw_vertical_grd": [covered(in_rect(-3, -2, 6, 7), True,
                                      (-3, -2, 6, 7))],
        "draw_texture": [covered(in_rect(0, 0, 5, 5), True, (0, 0, 5, 5))],
        "draw_line": [
            covered(in_quad(canvas_ref.line_quad(1, 1, 12, 3, 2)), True),
            covered(in_quad(canvas_ref.line_quad(2, 20, 30, 22, 3)), False)],
        "draw_splitted_texture": [covered(in_rect(1, 1, 10, 10), False,
                                          (1, 1, 10, 10))],
    }
    # the rotated blit's (u, v), then the split blit's, whose part is
    # the whole texture: (0 + (1 - 0) * u / tw) * tw
    read = texels(masks["draw_texture"][0],
                  lambda x, y: local(x, y, True),
                  lambda u, v: (u * (TW / 5), v * (TH / 5)))
    read |= texels(masks["draw_splitted_texture"][0],
                   lambda x, y: local(x, y, False),
                   lambda u, v: ((0.0 + 1.0 * ((u - 1) * (TW / 10)) / TW)
                                 * TW,
                                 (0.0 + 1.0 * ((v - 1) * (TH / 10)) / TH)
                                 * TH))
    # the frame, a fill alone, and the frame without its fill
    c = chart_system().work([FRAME, FRAME[:1], FRAME[1:]],
                            "cpu")["canvas_span"]
    by_call = {k: sum(int(m.sum()) for m in ms) for k, ms in masks.items()}
    for k in by_call:
        by_call[k] *= 1 if k == "fill_color" else 2
    by_call["fill_color"] *= 2
    assert c["covered_px"] == by_call
    union = np.logical_or.reduce(
        [m for k, ms in masks.items() if k != "fill_color" for m in ms])
    assert c["union_px"] == 2 * W * H + int(union.sum())
    assert c["calls"] == {"fill_color": 2, "draw_rect": 2,
                          "draw_vertical_grd": 2, "draw_texture": 2,
                          "draw_line": 4, "draw_splitted_texture": 2}
    assert all(0 < n < W * H for k, n in by_call.items() if k != "fill_color")
    assert 1 < len(read) < TW * TH
    assert c["texel_bytes"] == 2 * len(read) * 16
    n_bytes, n_ops = canvas_span.work(c)
    assert n_bytes == 2 * c["union_px"] * 16 + c["texel_bytes"] + 4 * (
        2 * 4 + 2 * 8 + 2 * 12 + 2 * 4 + 4 * 9 + 2 * 8)
    assert n_ops == sum(canvas_span.PER_PX_OPS[k] * n
                        for k, n in by_call.items())


def test_canvas_counts_a_fast_blit():
    """A blit under no transform takes the fast path: every pixel from
    trunc(x) while i < x + w, no bound test."""
    frame = [["draw_texture", "t", 2.5, 3, 6, 4]]
    c = chart_system().work([frame], "cpu")["canvas_span"]
    mask = np.zeros((H, W), bool)
    mask[3:7, 2:9] = True
    read = texels(mask, lambda x, y: (x, y),
                  lambda u, v: ((u - 2.5) * (TW / 6), (v - 3) * (TH / 4)))
    assert c["calls"] == {"draw_texture_fast": 1}
    assert c["covered_px"] == {"draw_texture_fast": 28}
    assert c["union_px"] == 28 and 1 < len(read) < TW * TH
    assert c["texel_bytes"] == len(read) * 16
    assert canvas_span.work(c) == (
        2 * 28 * 16 + len(read) * 16 + 4 * 4,
        28 * canvas_span.PER_PX_OPS["draw_texture_fast"])
