"""Plain PyTorch reference of the mesh -> u8 frame: projection, the
1/256-px snap, edge functions, packed depth keys and the winner's
Gouraud colour or perspective-correct nearest texel.

It follows the float64 NumPy oracle of the repository's first package
(the projection, the snap, edge functions over each triangle's pixel box,
keys ``zq << 18 | face``, ``clip(v * 255)`` truncated), rewritten as
whole-frame tensor operations: every (pixel, triangle) fragment of every
triangle's clamped box is expanded at once, the least key of each pixel
is taken with ``scatter_reduce``, and the winners shade in a second pass.
It imports nothing of the program.

``dtype`` is the arithmetic's precision (float64 for the reference);
``tf32=True`` rounds the projection's operands to TF32's 10-bit mantissa
first, as a TF32 matrix product does: the control.
"""

from __future__ import annotations

import torch

SUBPIXEL = 256.0
IDX_BITS = 18
Z_LEVELS = (1 << (31 - IDX_BITS)) - 1
SKY_KEY = (1 << 62)
W_MIN = 1e-6
# fragments expanded at once (bounds the memory of one pass)
CHUNK = 1 << 22


def tf32_round(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to
    even), as float32."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def project(verts, mvp, width: int, height: int, dtype, tf32=False):
    """Per-vertex snapped screen x, y, depth z, 1/w and w > 1e-6."""
    v4 = torch.cat([verts, verts.new_ones((verts.shape[0], 1))], 1)
    m = mvp.to(verts.device)
    if tf32:
        clip = tf32_round(v4) @ tf32_round(m).T
    else:
        clip = v4.to(dtype) @ m.to(dtype).T
    clip = clip.to(dtype)
    w = clip[:, 3]
    ok = w > W_MIN
    ws = torch.where(ok, w, torch.ones_like(w))
    ndc = clip[:, :3] / ws[:, None]
    sx = torch.round((ndc[:, 0] * 0.5 + 0.5) * width * SUBPIXEL) / SUBPIXEL
    sy = torch.round((0.5 - ndc[:, 1] * 0.5) * height * SUBPIXEL) / SUBPIXEL
    sz = ndc[:, 2] * 0.5 + 0.5
    return sx, sy, sz, 1.0 / ws, ok


class _Faces:
    """Per-face setup: corners, doubled area, sign and pixel boxes."""

    def __init__(self, sx, sy, sz, ok, faces, width, height):
        f = faces
        self.x = sx[f]                       # (F, 3)
        self.y = sy[f]
        self.z = sz[f]
        x, y = self.x, self.y
        area2 = ((x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
                 - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0]))
        valid = ok[f].all(1) & (area2.abs() > 1e-12)
        self.area2 = area2
        self.sign = torch.sign(area2)
        big = 1 << 20
        x0 = torch.floor(x.amin(1)).clamp(-big, big).long().clamp(min=0)
        x1 = torch.ceil(x.amax(1)).clamp(-big, big).long().clamp(
            max=width - 1)
        y0 = torch.floor(y.amin(1)).clamp(-big, big).long().clamp(min=0)
        y1 = torch.ceil(y.amax(1)).clamp(-big, big).long().clamp(
            max=height - 1)
        nx = (x1 - x0 + 1).clamp(min=0)
        ny = (y1 - y0 + 1).clamp(min=0)
        self.x0, self.y0, self.nx = x0, y0, nx
        self.n = torch.where(valid, nx * ny, torch.zeros_like(nx))

    def chunks(self):
        """Face ranges whose boxes hold at most CHUNK fragments (one
        face's box alone may hold more)."""
        ends = torch.cumsum(self.n, 0).tolist()
        lo, base = 0, 0
        for i, e in enumerate(ends):
            if e - base > CHUNK and i > lo:
                yield lo, i
                lo, base = i, ends[i - 1]
        if lo < len(ends):
            yield lo, len(ends)

    def fragments(self, lo, hi, width):
        """(face ids, flat pixel, covered, weights (N, 3), depth) of the
        fragments of faces lo..hi."""
        n = self.n[lo:hi]
        dev = n.device
        fid = torch.repeat_interleave(torch.arange(lo, hi, device=dev), n)
        first = torch.cumsum(n, 0) - n
        off = (torch.arange(fid.shape[0], device=dev)
               - torch.repeat_interleave(first, n))
        nx = self.nx[fid]
        pxi = self.x0[fid] + off % nx
        pyi = self.y0[fid] + off // nx
        x, y = self.x[fid], self.y[fid]
        px = pxi.to(x.dtype)
        py = pyi.to(x.dtype)
        x0, x1, x2 = x[:, 0], x[:, 1], x[:, 2]
        y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
        e0 = (y1 - y2) * px + (x2 - x1) * py + (x1 * y2 - x2 * y1)
        e1 = (y2 - y0) * px + (x0 - x2) * py + (x2 * y0 - x0 * y2)
        e2 = (y0 - y1) * px + (x1 - x0) * py + (x0 * y1 - x1 * y0)
        s = self.sign[fid]
        cov = (e0 * s >= 0) & (e1 * s >= 0) & (e2 * s >= 0)
        a = self.area2[fid]
        wts = torch.stack([e0 / a, e1 / a, e2 / a], 1)
        zf = self.z[fid]
        z = wts[:, 0] * zf[:, 0] + wts[:, 1] * zf[:, 1] + wts[:, 2] * zf[:, 2]
        cov = cov & (z >= 0) & (z <= 1)
        return fid, pyi * width + pxi, cov, wts, z


def _keys(z, fid):
    zq = torch.clamp(z * Z_LEVELS, 0, Z_LEVELS).long()
    return (zq << IDX_BITS) | fid


def render(mesh, mvp, width: int, height: int, *, dtype=torch.float64,
           tf32=False):
    """The u8 frame (H, W, 4) of ``mesh`` under ``mvp``, the number of
    covered (pixel, triangle) fragments and the number of covered
    pixels.  ``mesh``: dict of tensors on one device: verts
    (V, 3), faces (F, 3) int64, and either colors (V, 4) (Gouraud,
    opaque: alpha 255) or uvs (V, 2) with tex (th, tw, 4) uint8
    (perspective-correct nearest texel, clamped).  Pixels no triangle
    covers are 0."""
    verts = mesh["verts"].to(dtype)
    faces = mesh["faces"]
    sx, sy, sz, iw, ok = project(verts, mvp, width, height, dtype, tf32)
    fc = _Faces(sx, sy, sz, ok, faces, width, height)
    dev = verts.device
    best = torch.full((height * width,), SKY_KEY, dtype=torch.int64,
                      device=dev)
    covered = 0
    spans = list(fc.chunks())
    for lo, hi in spans:
        fid, pix, cov, _, z = fc.fragments(lo, hi, width)
        covered += int(cov.sum())
        best.scatter_reduce_(0, pix[cov], _keys(z[cov], fid[cov]), "amin")
    out = torch.zeros((height * width, 4), dtype=torch.uint8, device=dev)
    textured = "tex" in mesh
    if textured:
        tex = mesh["tex"]
        th, tw = tex.shape[0], tex.shape[1]
        uvf = mesh["uvs"].to(dtype)[faces]             # (F, 3, 2)
        iwf = iw[faces]                                # (F, 3)
    else:
        colf = mesh["colors"].to(dtype)[faces]         # (F, 3, 4)
    for lo, hi in spans:
        fid, pix, cov, wts, z = fc.fragments(lo, hi, width)
        win = cov & (_keys(z, fid) == best[pix])
        fid, pix, wts = fid[win], pix[win], wts[win]
        if textured:
            q = (wts * iwf[fid]).sum(1)
            uw = (wts[:, :, None] * uvf[fid] * iwf[fid][:, :, None]).sum(1)
            u = uw[:, 0] / q
            v = uw[:, 1] / q
            ui = torch.trunc(u * tw).clamp(-tw, 2 * tw).long().clamp(
                0, tw - 1)
            vi = torch.trunc(v * th).clamp(-th, 2 * th).long().clamp(
                0, th - 1)
            out[pix] = tex[vi, ui]
        else:
            c = (wts[:, :, None] * colf[fid]).sum(1)
            q8 = torch.trunc(torch.clamp(c[:, :3] * 255.0, 0, 255)).to(
                torch.uint8)
            out[pix, :3] = q8
            out[pix, 3] = 255
    return (out.reshape(height, width, 4), covered,
            int((best != SKY_KEY).sum()))
