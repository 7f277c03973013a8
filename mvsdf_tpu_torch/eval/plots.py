"""Visualization artifacts (port of ``mvsdf_tpu/eval/plots.py``): the
rendered-vs-GT image pair, a depth-map grid and the static 3-D scene
snapshot, each written as one PNG by the port's own writer
(``data/png.write_png``), and the camera viewing cones of the snapshot and
the HTML scene.

The JAX package draws with matplotlib, which the GPU machine lacks. Here
the depth maps use matplotlib's viridis colormap (a copy of its 256-entry
table, CC0) and the normalisation ``imshow`` applies as the JAX code calls
it; the snapshot is a numpy z-buffer rasteriser that views the scene as
mplot3d's ``get_proj`` does.
"""
from __future__ import annotations

import numpy as np

from ..data.png import write_png

# matplotlib's viridis colormap (CC0), its 256 RGB entries rounded to uint8
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
    "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
    "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
    "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
    "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
    "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
    "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
    "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
    "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
    "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
    "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
    "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
    "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
    "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
    "f6e620f8e621fbe723fde725"), np.uint8).reshape(256, 3)
# the JAX package's figure: 9 x 9 inches at 100 dpi
SNAPSHOT_PX = 900
# mplot3d: the camera's distance, and the 2-D window its projection fills
# (Axes3D.set_top_view)
_DIST = 10.0
_WINDOW = (-0.95 / _DIST, 0.9 / _DIST)
# set_box_aspect((1, 1, 1)): each side 1.8294640721620434 * 25/24 / sqrt(3)
_BOX = 1.8294640721620434 * 25 / 24 / np.sqrt(3.0)
_CRIMSON = (220, 20, 60)


def lin2img(flat, img_res):
    """(B, HW, C) -> (B, H, W, C) (ref plots.py:375-377)."""
    H, W = img_res
    return np.asarray(flat).reshape(-1, H, W, flat.shape[-1])


def to_uint8(img):
    """[-1, 1] floats -> uint8 (0 at -1, 255 at 1)."""
    return np.round(np.clip((np.asarray(img) + 1) / 2, 0, 1) *
                    255).astype(np.uint8)


def plot_image_grid(path, rgb_pred, rgb_gt, img_res):
    """Rendered | ground truth side by side, one row per image (ref
    plots.py:356-373), as a PNG of (B H, 2 W) RGB pixels. Inputs (B, HW, 3)
    in [-1, 1]."""
    pred = to_uint8(lin2img(rgb_pred, img_res))
    gt = to_uint8(lin2img(rgb_gt, img_res))
    grid = np.concatenate([pred, gt], axis=2)       # (B, H, 2W, 3)
    write_png(path, grid.reshape(-1, grid.shape[2], 3))


def _camera_cone_lines(pose, depth=0.3, half=0.18):
    """Wireframe viewing cone for one camera-to-world pose (4, 4): apex at
    the camera center, square base ``depth`` along the optical axis (the
    reference draws the same cones via plotly, ref plots.py:67-111)."""
    R = pose[:3, :3]
    c = pose[:3, 3]
    corners = np.array([[-half, -half, 1.0], [half, -half, 1.0],
                        [half, half, 1.0], [-half, half, 1.0]]) * depth
    base = (corners @ R.T) + c
    lines = [(c, b) for b in base]
    lines += [(base[i], base[(i + 1) % 4]) for i in range(4)]
    return lines


def viridis_index(x):
    """matplotlib's colormap lookup of normalised values x (float32):
    entry floor(256 x), x == 1 -> 255, below 0 -> 0 (the under colour is
    the first entry), 1 and above -> 255 (the over colour), NaN -> 0."""
    xa = np.asarray(x, np.float32) * np.float32(256)
    xa[xa == 256] = 255
    idx = np.zeros(xa.shape, np.int64)
    ok = np.isfinite(xa)
    idx[ok] = np.clip(xa[ok], 0, 255).astype(np.int64)
    idx[np.isposinf(xa)] = 255
    return idx


def plot_depth_maps(path, depths, img_res):
    """Depth maps side by side as one PNG of (H, B W) RGB pixels (ref
    plots.py:342-354). depths (B, HW). Each map is coloured by viridis
    over [vmin, vmax] = [its smallest positive depth, its largest depth]
    (0 without a positive one), in float32 as matplotlib's ``Normalize``
    computes it, so unset pixels take the lowest colour."""
    d = lin2img(np.asarray(depths, np.float32)[..., None], img_res)[..., 0]
    out = []
    for b in range(d.shape[0]):
        m = d[b] > 0
        vmin = d[b][m].min() if m.any() else np.float32(0)
        vmax = d[b].max()
        if vmin == vmax:
            x = np.zeros_like(d[b])
        else:
            x = (d[b] - vmin) / (vmax - vmin)
        out.append(VIRIDIS[viridis_index(x)])
    write_png(path, np.concatenate(out, axis=1))


def scene_projection(lo, hi, elev=25.0, azim=-60.0):
    """The 4 x 4 projection mplot3d's ``Axes3D.get_proj`` gives an axes
    with x, y and z limits [lo, hi] each, box aspect (1, 1, 1), the
    perspective projection of focal length 1, ``view_init(elev, azim)``
    and roll 0."""
    aspect = np.full(3, _BOX)
    world = np.diag(np.append(aspect / (hi - lo), 1.0))
    world[:3, 3] = -lo * aspect / (hi - lo)
    R = 0.5 * aspect
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    eye = R + _DIST * ps
    norm_elev = (elev + 180.0) % 360.0 - 180.0
    V = np.array([0.0, 0.0, -1.0 if abs(norm_elev) > 90.0 else 1.0])
    w = (eye - R) / np.linalg.norm(eye - R)
    u = np.cross(V, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    view = np.eye(4)
    view[:3, :3] = [u, v, w]
    shift = np.eye(4)
    shift[:3, 3] = -eye
    zf, zb = -_DIST, _DIST
    persp = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0],
                      [0, 0, (zf + zb) / (zf - zb), -2 * zf * zb / (zf - zb)],
                      [0, 0, -1.0, 0]])
    return persp @ (view @ shift) @ world


def scene_box(verts, poses=None):
    """(lo, hi) of the snapshot's cube box: centred on, and spanning, the
    vertices and the camera centres ((0, 1) with neither)."""
    allpts = [np.asarray(verts, np.float64)] if len(verts) else []
    if poses is not None:
        allpts.append(np.asarray(poses, np.float64)[:, :3, 3])
    if not allpts:
        return np.zeros(3), np.ones(3)
    ap = np.concatenate(allpts, 0)
    lo, hi = ap.min(0), ap.max(0)
    c = (lo + hi) / 2
    r = float((hi - lo).max()) / 2 + 1e-6
    return c - r, c + r


def window_to_pixels(tx, ty, size=SNAPSHOT_PX):
    """mplot3d's 2-D projected coordinates to pixel coordinates of the
    snapshot: the window of ``Axes3D.set_top_view`` spread over the image,
    y down."""
    lo, hi = _WINDOW
    return ((tx - lo) / (hi - lo) * size, (hi - ty) / (hi - lo) * size)


def project(M, pts, size=SNAPSHOT_PX):
    """Points (N, 3) -> (pixel x, pixel y, depth), the depth increasing
    away from the eye (mplot3d's projected z)."""
    vec = M @ np.concatenate([pts.T, np.ones((1, len(pts)))])
    tx, ty, tz = vec[:3] / vec[3]
    px, py = window_to_pixels(tx, ty, size)
    return px, py, tz


class _Canvas:
    """An RGB image with a depth buffer: nearer samples win."""

    def __init__(self, size):
        self.size = size
        self.rgb = np.full((size * size, 3), 255, np.uint8)
        self.z = np.full(size * size, np.inf)

    def splat(self, col, row, z, colors):
        """Samples at integer pixels (col, row) with depths z and colours
        (one per sample, or one for all): each pixel keeps its nearest."""
        ok = (col >= 0) & (col < self.size) & (row >= 0) & \
            (row < self.size) & np.isfinite(z)
        colors = np.broadcast_to(np.asarray(colors, np.uint8),
                                 (len(z), 3))[ok]
        pix = (row[ok] * self.size + col[ok]).astype(np.int64)
        z = z[ok]
        order = np.lexsort((z, pix))
        first = np.ones(len(order), bool)
        first[1:] = pix[order][1:] != pix[order][:-1]
        win = order[first]
        near = z[win] < self.z[pix[win]]
        win = win[near]
        self.z[pix[win]] = z[win]
        self.rgb[pix[win]] = colors[win]

    def triangles(self, x, y, z, colors, budget=1 << 22):
        """Fill triangles (T, 3) in pixel coordinates at their pixel
        centres, depth interpolated linearly; a triangle that covers no
        centre still marks the pixel of its centroid."""
        cx, cy = x.mean(1), y.mean(1)
        self.splat(np.floor(cx).astype(np.int64),
                   np.floor(cy).astype(np.int64), z.mean(1), colors)
        c0 = np.clip(np.ceil(x.min(1) - 0.5), 0, self.size).astype(np.int64)
        c1 = np.clip(np.floor(x.max(1) - 0.5), -1,
                     self.size - 1).astype(np.int64)
        r0 = np.clip(np.ceil(y.min(1) - 0.5), 0, self.size).astype(np.int64)
        r1 = np.clip(np.floor(y.max(1) - 0.5), -1,
                     self.size - 1).astype(np.int64)
        nc, nr = np.maximum(c1 - c0 + 1, 0), np.maximum(r1 - r0 + 1, 0)
        area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - \
            (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
        count = np.where(area != 0, nc * nr, 0)
        ends = np.cumsum(count)
        start = 0
        while start < len(count):
            # triangles [start, stop) hold at most ``budget`` candidates
            base = ends[start - 1] if start else 0
            stop = max(start + 1, int(np.searchsorted(ends, base + budget,
                                                      side="right")))
            t = np.repeat(np.arange(start, stop), count[start:stop])
            k = np.arange(len(t)) - np.repeat(ends[start:stop] - base -
                                              count[start:stop],
                                              count[start:stop])
            col = c0[t] + k % nc[t]
            row = r0[t] + k // np.maximum(nc[t], 1)
            px, py = col + 0.5, row + 0.5
            xt, yt = x[t], y[t]
            # barycentric weights from the signed areas
            w0 = (xt[:, 1] - px) * (yt[:, 2] - py) - \
                (xt[:, 2] - px) * (yt[:, 1] - py)
            w1 = (xt[:, 2] - px) * (yt[:, 0] - py) - \
                (xt[:, 0] - px) * (yt[:, 2] - py)
            w = np.stack([w0, w1, area[t] - w0 - w1], 1) / area[t][:, None]
            inside = (w >= 0).all(1)
            zt = (w * z[t]).sum(1)
            self.splat(col[inside], row[inside], zt[inside],
                       colors[t[inside]])
            start = stop

    def segments(self, a, b):
        """Line segments between (N, 3) pixel-space endpoints (x, y,
        depth), one sample a pixel along each."""
        n = np.maximum(np.ceil(np.abs(b[:, :2] - a[:, :2]).max(1)), 1)
        seg = np.repeat(np.arange(len(a)), n.astype(np.int64) + 1)
        k = np.arange(len(seg)) - np.repeat(np.cumsum(n + 1) - n - 1,
                                            (n + 1).astype(np.int64))
        f = (k / n[seg])[:, None]
        p = a[seg] + f * (b[seg] - a[seg])
        self.splat(np.floor(p[:, 0]).astype(np.int64),
                   np.floor(p[:, 1]).astype(np.int64), p[:, 2], _CRIMSON)

    def discs(self, x, y, z, radius, color):
        """Filled discs of ``radius`` pixels around each point."""
        r = int(np.ceil(radius))
        dx, dy = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1))
        keep = dx ** 2 + dy ** 2 <= radius ** 2
        dx, dy = dx[keep], dy[keep]
        col = (np.floor(x)[:, None] + dx).ravel().astype(np.int64)
        row = (np.floor(y)[:, None] + dy).ravel().astype(np.int64)
        self.splat(col, row, np.repeat(z, len(dx)), color)

    def image(self):
        return self.rgb.reshape(self.size, self.size, 3)


def plot_scene_snapshot(path, verts, faces, poses=None, face_colors=None,
                        points=None, max_faces=30000, elev=25, azim=-60):
    """Surface mesh + camera cones + optional point scatter, as the JAX
    package's matplotlib snapshot draws them (ref plots.py:12-65), written
    as a (900, 900) RGB PNG.

    verts (V, 3), faces (F, 3); poses (N, 4, 4) camera-to-world;
    face_colors optional (F,) scalars in [0, 1] (viridis; otherwise the
    face normal's shade against a fixed light); points optional (M, 3),
    drawn red. The same face and point subsets (``default_rng(0)`` and
    ``default_rng(1)``), a cube box spanning the vertices and camera
    centres, and mplot3d's view at ``elev`` / ``azim``
    (``scene_projection``). Triangles fill the pixel centres they cover
    behind a depth buffer, and so do the cones and points. Unlike the
    matplotlib figure it draws no axes, ticks or panes."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces)
    if poses is not None:
        poses = np.asarray(poses, np.float64)
    canvas = _Canvas(SNAPSHOT_PX)
    M = scene_projection(*scene_box(verts, poses), elev, azim)
    if len(faces):
        fcol = None if face_colors is None else np.asarray(face_colors)
        if len(faces) > max_faces:
            sel = np.random.default_rng(0).choice(len(faces),
                                                  size=max_faces,
                                                  replace=False)
            faces = faces[sel]
            fcol = None if fcol is None else fcol[sel]
        tris = verts[faces]
        if fcol is not None:
            colors = VIRIDIS[viridis_index(np.clip(fcol, 0, 1))]
        else:
            n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
            n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)
            lum = np.clip(0.4 + 0.6 * np.abs(n @ np.array([0.4, 0.5, 0.77])),
                          0, 1)
            colors = np.round(np.stack([lum * 0.6, lum * 0.7, lum], -1) *
                              255).astype(np.uint8)
        x, y, z = project(M, tris.reshape(-1, 3))
        canvas.triangles(x.reshape(-1, 3), y.reshape(-1, 3),
                         z.reshape(-1, 3), colors)
    if points is not None and len(points):
        pts = np.asarray(points, np.float64)
        sel = np.random.default_rng(1).choice(
            len(pts), size=min(5000, len(pts)), replace=False)
        x, y, z = project(M, pts[sel])
        canvas.splat(np.floor(x).astype(np.int64),
                     np.floor(y).astype(np.int64), z, (255, 0, 0))
    if poses is not None:
        ends = np.array([(a, b) for p in poses
                         for a, b in _camera_cone_lines(p)])
        a = np.stack(project(M, ends[:, 0]), 1)
        b = np.stack(project(M, ends[:, 1]), 1)
        canvas.segments(a, b)
        x, y, z = project(M, poses[:, :3, 3])
        canvas.discs(x, y, z, 2.0, _CRIMSON)
    write_png(path, canvas.image())
