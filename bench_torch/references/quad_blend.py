"""Plain PyTorch reference of BASELINE config 2: a batch of textured quads
alpha-blended back to front over an opaque depth, to a u8 frame.

It follows the port's plain per-triangle path (``render_blended`` of the
port's ``ops/raster3d``), with the draw order of the configuration
(``baseline_quads_720p.json``, ``"order"``) computed here by its stated
rule, and imports nothing of the program.  Per frame:

* the order: each quad's key is the clip-space w of its centre,
  ((a + b) + (c + d)) / 4 of its corners (faces 2q, 2q + 1 = (a, b, c),
  (a, c, d)), ((m30 x + m31 y) + m32 z) + m33, all in float64 from the
  float32 matrix and vertices; quads farther first, ties by quad index,
  each quad's two faces together, 2q then 2q + 1;
* the projection of every vertex, the 1/256-px snap of x and y, the
  depth z = ndc z / 2 + 1/2 and w > 1e-6;
* each triangle over its pixel box clamped to the frame: edge functions
  at integer pixel coordinates, covered where all
  three (times the sign of the doubled area) are >= 0 (so a quad's
  diagonal is blended twice), barycentric weights, z, u and v as their
  weighted sums, drawn where covered and 0 <= z <= opaque_depth; the
  nearest texel clamp(trunc(u tw), 0, tw - 1), clamp(trunc(v th), 0,
  th - 1) as c / 255; then at each pixel its drawn fragments in draw
  order, rgb = rgb (1 - a) + texel a, alpha = max(alpha, a), from bg;
* each channel clip(v * 255, 0, 255) truncated to u8.

Precision.  The blend, its sums over the layers and the quantisation
are float64.  The coverage test is exact: float64 edge functions of the
snapped corners.  Three steps are discontinuities of the frame, where a
float64 value would part from the configuration's float32 one at knife
edges by a whole texel, a whole fragment or a snapped vertex, and each
is evaluated in the configuration's stated float32 op order
(``"geometry"`` in the configuration): the projection and the snap
(clip rows ((v0 m_r0 + v1 m_r1) + v2 m_r2) + v3 m_r3, ndc = clip / w),
the depth of the z test and the (u, v) of the texel index (edges
(A x + B y) + C with C = x_j y_k - x_k y_j formed in float64 and
rounded once, weights e_i (1 / area), sums (w0 q0 + w1 q1) + w2 q2).
Measured on the CPU at 1280x720 (seed 1, the camera 1.4 rad from the
front, quads near edge-on), each part in float64 put this many more of
the frame's pixels over a level from the program: the (u, v) 8.2e-4,
the snap 5.7e-4, the depth 3.4e-4, the coverage 1.1e-5, 1.7e-3 in all,
beyond the ``altered`` fault's 1.1e-3 (PERF.md).

Where it departs from the port's ``render_blended``: the blend in
float64, the coverage exact, a triangle evaluated only over its pixel
box (outside it no edge test can pass), and the order computed here.
``dtype=torch.bfloat16`` is the control: every step above, the float32
ones too, in bfloat16 (the order stays the configuration's float64
rule).
"""

from __future__ import annotations

import torch

SUBPIXEL = 256.0
W_MIN = 1e-6


def centres(verts, faces):
    """(Q, 3) float64 quad centres, ((a + b) + (c + d)) / 4."""
    f = faces.reshape(-1, 2, 3)
    v = verts.to(torch.float64)
    a, b, c, d = (v[f[:, 0, 0]], v[f[:, 0, 1]], v[f[:, 0, 2]],
                  v[f[:, 1, 2]])
    return ((a + b) + (c + d)) * 0.25


def draw_order(cen, mvp):
    """(F,) int64: the face drawn at each step, quads back to front by
    the float64 clip-space w of their centres, ties by quad index."""
    m = mvp.to(torch.float64).to(cen.device)
    w = ((m[3, 0] * cen[:, 0] + m[3, 1] * cen[:, 1]) + m[3, 2] * cen[:, 2]
         ) + m[3, 3]
    q = torch.sort(-w, stable=True).indices
    return torch.stack([2 * q, 2 * q + 1], 1).reshape(-1)


def project(verts, mvp, width: int, height: int, dtype):
    """Per-vertex snapped screen x, y, depth z and w > 1e-6, by the
    configuration's float32 op order (bfloat16 for the control)."""
    d = torch.float32 if dtype == torch.float64 else dtype
    v = torch.cat([verts, verts.new_ones((verts.shape[0], 1))], 1).to(d)
    m = mvp.to(verts.device, d)
    clip = (((v[:, 0:1] * m[:, 0] + v[:, 1:2] * m[:, 1])
             + v[:, 2:3] * m[:, 2]) + v[:, 3:4] * m[:, 3])
    w = clip[:, 3]
    ok = w > W_MIN
    ws = torch.where(ok, w, torch.ones_like(w))
    ndc = clip[:, :3] / ws[:, None]
    sx = torch.round((ndc[:, 0] * 0.5 + 0.5) * width * SUBPIXEL) / SUBPIXEL
    sy = torch.round((0.5 - ndc[:, 1] * 0.5) * height * SUBPIXEL) / SUBPIXEL
    sz = ndc[:, 2] * 0.5 + 0.5
    return sx, sy, sz, ok


CHUNK = 1 << 22             # fragments expanded at once


def _triangles(scene, mvp, width: int, height: int, dtype):
    """Per triangle, in draw order: the edges (exact, and in the
    geometry's precision), sign, 1 / area, z, (u, v), validity and the
    pixel box clamped to the frame."""
    faces = scene["faces"]
    mvp = torch.as_tensor(mvp)
    g = torch.float32 if dtype == torch.float64 else dtype  # geometry's
    sx, sy, sz, ok = project(scene["verts"], mvp, width, height, dtype)
    order = draw_order(centres(scene["verts"], faces), mvp)
    f = faces[order]                                       # (F, 3) drawn
    x, y = sx[f], sy[f]
    area = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
            - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
    valid = ok[f].all(1) & (area.abs() > 1e-12)
    # edge i opposite vertex i: A_i px + B_i py + C_i; exact in float64
    # (the control: bfloat16)
    i0, i1 = [1, 2, 0], [2, 0, 1]
    x6 = x.to(torch.float64 if g == torch.float32 else g)
    y6 = y.to(x6.dtype)
    A6 = y6[:, i0] - y6[:, i1]
    B6 = x6[:, i1] - x6[:, i0]
    C6 = x6[:, i0] * y6[:, i1] - x6[:, i1] * y6[:, i0]
    # the boxes clamp to the frame in integers (bfloat16 holds no 1279)
    big = 1 << 20
    x0 = torch.ceil(x.amin(1)).clamp(-big, big).long().clamp(min=0)
    x1 = torch.floor(x.amax(1)).clamp(-big, big).long().clamp(max=width - 1)
    y0 = torch.ceil(y.amin(1)).clamp(-big, big).long().clamp(min=0)
    y1 = torch.floor(y.amax(1)).clamp(-big, big).long().clamp(
        max=height - 1)
    nx = (x1 - x0 + 1).clamp(min=0)
    return {"A6": A6, "B6": B6, "C6": C6, "A": A6.to(g), "B": B6.to(g),
            "C": C6.to(g), "sign": torch.sign(area).to(x6.dtype),
            "inv_area": 1.0 / torch.where(valid, area, torch.ones_like(area)),
            "z": sz[f], "uv": scene["uvs"].to(g)[f], "x0": x0, "y0": y0,
            "nx": nx,
            "n": torch.where(valid, nx * (y1 - y0 + 1).clamp(min=0), 0)}


def _fragments(tri, width: int, opaque_depth):
    """Each triangle's pixel box expanded, ``CHUNK`` fragments at a time
    and in draw order: per chunk (step, flat pixel, covered, drawn, z, u,
    v), each fragment's values the painter's at that pixel.  With
    ``opaque_depth`` None every covered fragment is drawn."""
    n = tri["n"]
    dev = n.device
    ends = torch.cumsum(n, 0).tolist()
    bounds, lo, base = [], 0, 0
    for i, e in enumerate(ends):
        if e - base > CHUNK and i > lo:
            bounds.append((lo, i))
            lo, base = i, ends[i - 1]
    bounds.append((lo, len(ends)))
    for lo, hi in bounds:
        t = torch.repeat_interleave(torch.arange(lo, hi, device=dev),
                                    n[lo:hi])
        first = torch.cumsum(n[lo:hi], 0) - n[lo:hi]
        off = (torch.arange(t.shape[0], device=dev)
               - torch.repeat_interleave(first, n[lo:hi]))
        px = tri["x0"][t] + off % tri["nx"][t]
        py = tri["y0"][t] + off // tri["nx"][t]
        X6 = px.to(tri["A6"].dtype)[:, None]
        Y6 = py.to(tri["A6"].dtype)[:, None]
        e6 = (tri["A6"][t] * X6 + tri["B6"][t] * Y6) + tri["C6"][t]
        cov = (e6 * tri["sign"][t, None] >= 0).all(1)
        X, Y = X6.to(tri["A"].dtype), Y6.to(tri["A"].dtype)
        wgt = (((tri["A"][t] * X + tri["B"][t] * Y) + tri["C"][t])
               * tri["inv_area"][t, None])

        def sums(q):
            return ((wgt[:, 0] * q[:, 0] + wgt[:, 1] * q[:, 1])
                    + wgt[:, 2] * q[:, 2])

        pix = py * width + px
        z = sums(tri["z"][t])
        draw = cov if opaque_depth is None else (
            cov & (z >= 0) & (z <= opaque_depth.reshape(-1)[pix]))
        yield t, pix, cov, draw, z, sums(tri["uv"][t, :, 0]), \
            sums(tri["uv"][t, :, 1])


def render(scene, mvp, width: int, height: int, opaque_depth, *,
           dtype=torch.float64):
    """The u8 frame (H, W, 4) of ``scene`` under ``mvp``.  ``scene``:
    dict of tensors on one device: verts (V, 3), faces (F, 3) int64, uvs
    (V, 2), tex (th, tw, 4) uint8 and bg (4,); ``opaque_depth`` (H, W).
    ``dtype``: the blend's (float64; the control's bfloat16, which then
    takes every step).

    Each triangle's fragments are evaluated over its pixel box; then the
    drawn fragments of every pixel are blended in draw order, layer by
    layer: layer k blends the k-th drawn fragment of each pixel that has
    one, so each pixel sees the painter's sequence of blends."""
    dev = scene["verts"].device
    tri = _triangles(scene, mvp, width, height, dtype)
    od = opaque_depth.to(dev, tri["A"].dtype)
    tex = scene["tex"]
    th, tw = tex.shape[0], tex.shape[1]
    pix, texel = [], []
    for _, p, _, draw, _, u, v in _fragments(tri, width, od):
        ui = torch.trunc(u[draw] * tw).clamp(0, tw - 1).long()
        vi = torch.trunc(v[draw] * th).clamp(0, th - 1).long()
        pix.append(p[draw].to(torch.int32))
        texel.append((vi * tw + ui).to(torch.int32))
    pix, texel = torch.cat(pix), torch.cat(texel)
    # drawn fragments come in draw order; a stable sort by pixel keeps it
    # within each pixel, and each fragment's rank there is its layer
    by_pix = torch.sort(pix, stable=True).indices
    pix, texel = pix[by_pix], texel[by_pix]
    per_pix = torch.bincount(pix, minlength=height * width)
    first = torch.cumsum(per_pix, 0) - per_pix
    layer = torch.arange(pix.shape[0], device=dev) - first[pix.long()]
    by_layer = torch.sort(layer, stable=True).indices
    pix, texel = pix[by_layer], texel[by_layer]
    sizes = torch.bincount(layer).tolist()
    texf = (tex.to(dtype) / 255).reshape(-1, 4)
    fb = scene["bg"].to(dev, dtype).expand(height * width, 4).clone()
    lo = 0
    for size in sizes:
        p = pix[lo:lo + size].long()
        t = texf[texel[lo:lo + size].long()]
        a = t[:, 3:]
        c = fb[p]
        fb[p] = torch.cat([c[:, :3] * (1 - a) + t[:, :3] * a,
                           torch.maximum(c[:, 3:], a)], 1)
        lo += size
    fb = fb.reshape(height, width, 4)
    return torch.clamp(fb * 255, 0, 255).to(torch.int32).to(torch.uint8)


def fragments(scene, mvp, width: int, height: int, opaque_depth):
    """(covered, drawn) of one frame: the (pixel, triangle) fragments
    whose edge tests pass, and those of them that pass the z test too,
    as :func:`render` tests them."""
    tri = _triangles(scene, mvp, width, height, torch.float64)
    od = opaque_depth.to(scene["verts"].device, torch.float32)
    covered = drawn = 0
    for _, _, cov, draw, _, _, _ in _fragments(tri, width, od):
        covered += int(cov.sum())
        drawn += int(draw.sum())
    return covered, drawn


def fragment_depths(scene, mvp, width: int, height: int):
    """(N,) the depths of one frame's covered (pixel, triangle)
    fragments, as :func:`render`'s z test reads them (the configuration's
    float32 sums), in draw order."""
    tri = _triangles(scene, mvp, width, height, torch.float64)
    return torch.cat([z[cov] for _, _, cov, _, z, _, _
                      in _fragments(tri, width, None)])
