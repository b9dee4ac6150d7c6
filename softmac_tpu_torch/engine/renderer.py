"""Offscreen scene renderer on tensors (``softmac_tpu/engine/renderer.py``).

The same software rasterizer as the JAX package's ``PointRenderer``, the
same pixels, on tensors of a device it is given (the env's: the card by
default, the CPU when asked). A frame is drawn in this order:

    background and the checkerboard floor, one ray per pixel
    floor shadows: every opaque caster (meshes, cloth, particles) projected
    along the light onto the floor into one boolean mask, darkened once
    opaque meshes, flat-shaded per face (shade = 0.35 + 0.65 |n.l|)
    the cloth, Gouraud-shaded from area-weighted vertex normals
    the target overlay and the particles, square splats far to near
    transparent meshes, alpha-blended far to near without writing depth
    ssaa box downsampling and the truncating uint8 cast

No Python loop visits a triangle or a pixel. Each mesh's triangles are
sorted far to near by mean depth (a stable sort), and every (triangle,
bounding-box pixel) pair becomes one candidate, in chunks of at most
``MAX_CANDIDATES`` pairs (by device: ~1.3 GB of float64 candidate data on
the card). The sequential z-buffer of the JAX renderer
(a strict ``<`` depth test, so among equal depths the first drawn stays)
is the per-pixel minimum of (depth, draw rank), taken with two
``scatter_reduce(amin)`` passes; a splat pass keeps the last point drawn of
those in front of the pass's depth, the per-pixel maximum of the draw rank.
Both are deterministic on the card, where ``index_put_`` with repeated
indices is not. A transparent mesh composes each pixel's covering
triangles in rank order, one layer of the pixel's candidates at a time, so
the blend is the JAX renderer's own sequence of operations.

Pixel samples sit at integer pixel coordinates; bounding boxes and splat
positions truncate toward zero as the JAX renderer's ``int()`` and
``astype(int)`` do. Where the two differ it is in the last bit of a BLAS
product or of the smooth normals' scatter sum, and ties of mean depth
between triangles, which NumPy's unstable ``argsort`` orders its own way.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from softmac_tpu_torch.engine import quat as Q

_BACKGROUND = (0.86, 0.9, 0.96)
_CLOTH_COLOR = (0.85, 0.7, 0.3)
_TARGET_COLOR = (0.35, 0.75, 0.35)
_PARTICLE_COLOR = (0.2, 0.3, 0.8)
_PRIM_COLOR = (0.6, 0.6, 0.65, 1.0)
_SHADOW = 0.62
MAX_CANDIDATES = {"cuda": 1 << 24, "cpu": 1 << 21}


def _rot_xy(pitch, yaw):
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return ry @ rx


def int_color_to_rgb(c) -> torch.Tensor:
    """0xRRGGBB integers to RGB in [0, 1], float64."""
    c = torch.as_tensor(np.asarray(c) if not torch.is_tensor(c) else c)
    c = c.to(torch.int64)
    return torch.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255],
                       dim=-1).to(torch.float64) / 255.0


def _trunc_index(v, lo, hi):
    """``v.astype(int)`` for the values that can land in [lo, hi): truncate
    toward zero; far or non-finite values map outside the range."""
    v = torch.where(torch.isfinite(v), v, torch.full_like(v, lo - 1.0))
    return torch.trunc(v.clamp(lo - 1.0, hi + 1.0)).to(torch.int64)


class PointRenderer:
    def __init__(self, cfg, env, res=(512, 512), device=None):
        self.cfg = cfg
        self.env = env
        self.out_res = tuple(cfg.get("image_res", res))
        self.ssaa = max(int(cfg.get("ssaa", 2)), 1)
        self.res = tuple(r * self.ssaa for r in self.out_res)
        self.shadows = bool(cfg.get("shadows", True))
        if device is None:
            device = getattr(env, "device", "cpu")
        self.device = torch.device(device)
        self.dtype = torch.float64       # the JAX renderer's NumPy float64
        self.camera_pos = np.asarray(cfg.camera_pos, np.float64)
        pitch, yaw = cfg.camera_rot
        self.R = _rot_xy(pitch, yaw)        # camera-to-world
        self.fov = math.pi / 3
        self.light_dir = _rot_xy(*cfg.light_rot) @ np.array([0.0, 0.0, -1.0])
        self.floor_y = 0.0

        # rest-frame primitive meshes (world = R p_local + pos per frame)
        self.prim_meshes = getattr(env, "prim_meshes", [])
        self.prim_colors = getattr(env, "prim_colors", [])
        self._target = None          # (points (M, 3), kind) overlay

    def set_target(self, points, kind="points"):
        """Overlay target geometry (reference soft_cloth renderer:79-97)."""
        self._target = (self._t(points), kind)

    # ------------------------------------------------------------------
    def _t(self, a, dtype=None):
        if a is None:
            return None
        if not torch.is_tensor(a):
            a = torch.as_tensor(np.asarray(a))
        if dtype is None:
            dtype = self.dtype if a.is_floating_point() else a.dtype
        return a.to(device=self.device, dtype=dtype)

    def _project(self, pts):
        """world (M, 3) -> (screen x, y, depth, valid)."""
        h, w = self.res[1], self.res[0]
        cam = (pts - self._cam) @ self._R   # world->camera (R orthonormal)
        z = -cam[:, 2]
        valid = z > 1e-4
        f = 0.5 * h / math.tan(self.fov / 2)
        zs = torch.where(valid, z, torch.ones_like(z))
        sx = w / 2 + f * cam[:, 0] / zs
        sy = h / 2 - f * cam[:, 1] / zs
        return sx, sy, z, valid

    # ------------------------------------------------------------------
    # triangle coverage: (triangle, bounding-box pixel) candidates
    # ------------------------------------------------------------------
    def _cover(self, sx, sy, tri, keep):
        """Coverage of screen triangles ``tri`` (T, 3) (those with ``keep``),
        as the JAX renderer's ``_tri_cover`` rules: the bbox clipped to the
        frame with ``int()`` truncation, degenerate triangles (|d| < 1e-12)
        and empty boxes skipped, pixel samples at integer coordinates. Yields
        chunks (t, pix, w0, w1, w2) of the covered candidates (inside the
        triangle, barycentric weights all >= 0), in triangle order."""
        h, w = self.res[1], self.res[0]
        xs, ys = sx[tri], sy[tri]                      # (T, 3)
        x0 = torch.trunc(xs.amin(1).clamp_min(0.0).clamp_max(float(w)))
        x1 = torch.trunc(xs.amax(1).clamp_max(w - 1.0).clamp_min(-1.0)) + 1
        y0 = torch.trunc(ys.amin(1).clamp_min(0.0).clamp_max(float(h)))
        y1 = torch.trunc(ys.amax(1).clamp_max(h - 1.0).clamp_min(-1.0)) + 1
        a = ys[:, 1] - ys[:, 2]
        b = xs[:, 2] - xs[:, 1]
        c = ys[:, 2] - ys[:, 0]
        e = xs[:, 0] - xs[:, 2]
        d = a * e + b * (ys[:, 0] - ys[:, 2])
        ok = keep & (x0 < x1) & (y0 < y1) & (d.abs() >= 1e-12)
        bw = (x1 - x0).to(torch.int64)
        area = torch.where(ok, bw * (y1 - y0).to(torch.int64),
                           torch.zeros_like(bw))
        x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
        ends = torch.cumsum(area, 0).cpu().numpy()
        start, done = 0, 0
        T = len(tri)
        while start < T:
            stop = int(np.searchsorted(
                ends, done + MAX_CANDIDATES[self.device.type], side="right"))
            stop = min(max(stop, start + 1), T)
            total = int(ends[stop - 1]) - done
            if total > 0:
                cnt = area[start:stop]
                t = torch.repeat_interleave(
                    torch.arange(start, stop, device=self.device), cnt,
                    output_size=total)
                first = torch.cumsum(cnt, 0) - cnt
                local = (torch.arange(total, device=self.device)
                         - first[t - start])
                gx = x0[t] + local % bw[t]
                gy = y0[t] + local // bw[t]
                gxf, gyf = gx.to(self.dtype), gy.to(self.dtype)
                dx, dy = gxf - xs[t, 2], gyf - ys[t, 2]
                w0 = (a[t] * dx + b[t] * dy) / d[t]
                w1 = (c[t] * dx + e[t] * dy) / d[t]
                w2 = 1 - w0 - w1
                inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
                yield (t[inside], gy[inside] * w + gx[inside], w0[inside],
                       w1[inside], w2[inside])
            done = int(ends[stop - 1])
            start = stop

    def _raster_mesh(self, img, depth, verts, faces, color, alpha=1.0,
                     smooth=False):
        """Rasterize one mesh into img (H*W, 3) and depth (H*W,), both flat:
        far to near by mean depth; opaque (alpha >= 0.999) writes depth with
        a strict test, transparent blends without writing it."""
        sx, sy, z, valid = self._project(verts)
        tri = faces
        v0, v1, v2 = verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]
        n_raw = torch.linalg.cross(v1 - v0, v2 - v0)   # area-weighted
        shade = 0.35 + 0.65 * torch.abs((n_raw / _norm(n_raw)) @ self._L)
        if smooth:
            vn = torch.zeros_like(verts)
            for k in range(3):
                vn.index_add_(0, tri[:, k], n_raw)
            vshade = 0.35 + 0.65 * torch.abs((vn / _norm(vn)) @ self._L)
        base = self._t(np.asarray(color[:3], np.float64))
        zt = z[tri]
        order = torch.sort(-((zt[:, 0] + zt[:, 1] + zt[:, 2]) / 3),
                           stable=True).indices           # far to near
        tri = tri[order]
        shade = shade[order]
        keep = valid[tri].all(dim=1)
        zt = z[tri]
        opaque = alpha >= 0.999
        for t, pix, w0, w1, w2 in self._cover(sx, sy, tri, keep):
            zp = w0 * zt[t, 0] + w1 * zt[t, 1] + w2 * zt[t, 2]
            sel = zp < depth[pix]
            t, pix, zp = t[sel], pix[sel], zp[sel]
            w0, w1, w2 = w0[sel], w1[sel], w2[sel]
            if smooth:
                vs = vshade[tri[t]]
                sh = w0 * vs[:, 0] + w1 * vs[:, 1] + w2 * vs[:, 2]
            else:
                sh = shade[t]
            if opaque:
                # the sequential strict test leaves the least (depth, rank)
                best = torch.full_like(depth, math.inf).scatter_reduce(
                    0, pix, zp, "amin")
                at_min = zp == best[pix]
                rank = torch.where(at_min, t, torch.full_like(t, len(tri)))
                first = torch.full(depth.shape, len(tri), dtype=torch.int64,
                                   device=self.device).scatter_reduce(
                    0, pix, rank, "amin")
                win = at_min & (t == first[pix])
                depth[pix[win]] = zp[win]
                img[pix[win]] = base * sh[win][:, None]
            else:
                self._blend(img, pix, (alpha * base) * sh[:, None], alpha)

    @staticmethod
    def _blend(img, pix, src, alpha):
        """img[p] = src + (1 - alpha) img[p] for each candidate in order:
        each pixel's candidates (already in draw order) one layer at a
        time."""
        if len(pix) == 0:
            return
        pix_s, perm = torch.sort(pix, stable=True)
        src = src[perm]
        n = len(pix_s)
        idx = torch.arange(n, device=pix.device)
        new = torch.ones(n, dtype=torch.bool, device=pix.device)
        new[1:] = pix_s[1:] != pix_s[:-1]
        seg = torch.cummax(torch.where(new, idx, torch.zeros_like(idx)),
                           0).values
        layer = idx - seg
        for k in range(int(layer.max()) + 1):
            m = layer == k
            p = pix_s[m]
            img[p] = src[m] + (1 - alpha) * img[p]

    # ------------------------------------------------------------------
    # point splats
    # ------------------------------------------------------------------
    def _screen_points(self, sx, sy, valid, size):
        """Projected points' integer corners on screen (truncated toward
        zero) and the mask of those whose (size+1)^2 square fits the
        frame."""
        h, w = self.res[1], self.res[0]
        xi = _trunc_index(sx, 0, w)
        yi = _trunc_index(sy, 0, h)
        ok = valid & (xi >= 0) & (xi < w - size) & (yi >= 0) & (yi < h - size)
        return xi, yi, ok

    def _splat_points(self, img, depth, pts, colors, size=1):
        w = self.res[0]
        sx, sy, z, valid = self._project(pts)
        order = torch.sort(-z, stable=True).indices        # far to near
        sx, sy, z, valid = sx[order], sy[order], z[order], valid[order]
        xi, yi, ok = self._screen_points(sx, sy, valid, size)
        xi, yi, z, colors = xi[ok], yi[ok], z[ok], colors[order][ok]
        rank = torch.arange(len(z), device=self.device)
        for dy in range(size + 1):
            for dx in range(size + 1):
                pix = (yi + dy) * w + xi + dx
                sel = z < depth[pix]
                # the last point drawn of those in front of this pass
                last = torch.full(depth.shape, -1, dtype=torch.int64,
                                  device=self.device).scatter_reduce(
                    0, pix[sel], rank[sel], "amax")
                win = sel & (last[pix] == rank)
                depth[pix[win]] = z[win]
                img[pix[win]] = colors[win]

    # ------------------------------------------------------------------
    # floor shadows
    # ------------------------------------------------------------------
    def _shadow_light(self):
        """Downward light direction for shadow projection, or None when the
        light is too close to horizontal for a sane floor projection."""
        L = self.light_dir
        if abs(L[1]) < 0.2:
            return None
        return L if L[1] < 0 else -L

    def _flatten_to_floor(self, pts, L):
        """Project world points along L onto the floor plane; the mask of
        points that cast (above the floor)."""
        t = (self.floor_y - pts[:, 1]) / float(L[1])
        out = pts + t[:, None] * self._t(L)
        out[:, 1] = self.floor_y
        return out, t > 0

    def _apply_shadows(self, img, mesh_casters, point_casters, psize):
        """Darken floor pixels covered by the light-projected silhouettes of
        the casters, once, through a boolean mask; right after the floor."""
        L = self._shadow_light()
        if L is None:
            return
        h, w = self.res[1], self.res[0]
        mask = torch.zeros(h * w, dtype=torch.bool, device=self.device)
        for verts, faces in mesh_casters:
            flat, cast = self._flatten_to_floor(verts, L)
            keep = cast[faces].all(dim=1)
            sx, sy, _, valid = self._project(flat)
            keep = keep & valid[faces].all(dim=1)
            for _, pix, _, _, _ in self._cover(sx, sy, faces, keep):
                mask[pix] = True
        for pts in point_casters:
            flat, cast = self._flatten_to_floor(pts, L)
            sx, sy, _, valid = self._project(flat[cast])
            xi, yi, ok = self._screen_points(sx, sy, valid, psize)
            xi, yi = xi[ok], yi[ok]
            for dy in range(psize + 1):
                for dx in range(psize + 1):
                    mask[(yi + dy) * w + xi + dx] = True
        img[mask] *= _SHADOW

    def _draw_floor(self, img, depth):
        """Checkerboard ground plane via per-pixel ray casting."""
        h, w = self.res[1], self.res[0]
        f = 0.5 * h / math.tan(self.fov / 2)
        gy, gx = torch.meshgrid(
            torch.arange(h, device=self.device, dtype=self.dtype),
            torch.arange(w, device=self.device, dtype=self.dtype),
            indexing="ij")
        dirs_cam = torch.stack([(gx - w / 2) / f, -(gy - h / 2) / f,
                                -torch.ones_like(gx)], dim=-1)
        dirs = (dirs_cam @ self._R.T).reshape(-1, 3)
        oy = float(self.camera_pos[1] - self.floor_y)
        dy = dirs[:, 1]
        t = torch.where(dy < -1e-9, oy / -torch.clamp_max(dy, -1e-9),
                        torch.full_like(dy, math.inf))
        hit = torch.isfinite(t)
        ts = torch.where(hit, t, torch.zeros_like(t))
        px = float(self.camera_pos[0]) + ts * dirs[:, 0]
        pz = float(self.camera_pos[2]) + ts * dirs[:, 2]
        checker = ((torch.floor(px / 0.125).to(torch.int64)
                    + torch.floor(pz / 0.125).to(torch.int64)) % 2
                   ).to(self.dtype)
        col = 0.62 + 0.18 * checker
        sel = hit & (t < depth)
        img[sel] = col[sel][:, None].expand(-1, 3)
        depth[sel] = t[sel]

    # ------------------------------------------------------------------
    def render(self, particles_x, particle_colors, bodies=None,
               cloth=None, extra_points=None):
        """One frame as a uint8 (H, W, 3) numpy array. ``particles_x``
        (N, 3) and ``particle_colors`` ((N,) 0xRRGGBB integers, (N, 3)
        floats, or None), ``bodies`` a BodyState (pos, quat per mesh of
        ``prim_meshes``), ``cloth`` (vertices, faces); arrays or tensors."""
        h, w = self.res[1], self.res[0]
        s = self.ssaa
        self._cam = self._t(self.camera_pos)
        self._R = self._t(self.R)
        self._L = self._t(self.light_dir)
        img = self._t(np.array(_BACKGROUND)).repeat(h * w, 1)
        depth = torch.full((h * w,), math.inf, dtype=self.dtype,
                           device=self.device)

        self._draw_floor(img, depth)

        # opaque meshes first, then particles, then transparent meshes
        # blended on top (the liquid shows through the glass, alpha 0.8)
        opaque, transparent = [], []
        if bodies is not None and len(self.prim_meshes) > 0:
            pos = self._t(bodies.pos)
            rot = Q.quat2mat(self._t(bodies.quat))
            for i, (verts, faces) in enumerate(self.prim_meshes):
                world = self._t(verts) @ rot[i].T + pos[i]
                color = (np.asarray(self.prim_colors[i])
                         if i < len(self.prim_colors)
                         else np.array(_PRIM_COLOR))
                alpha = float(color[3]) if len(color) > 3 else 1.0
                faces = self._t(faces, torch.int64)
                if alpha >= 0.999:
                    opaque.append((world, faces, color))
                else:
                    transparent.append((world, faces, color, alpha))
        if cloth is not None:
            cloth = (self._t(cloth[0]), self._t(cloth[1], torch.int64))
        has_particles = particles_x is not None and len(particles_x) > 0
        if has_particles:
            particles_x = self._t(particles_x)

        if self.shadows:
            casters = [(wld, fcs) for wld, fcs, _ in opaque]
            if cloth is not None:
                casters.append(cloth)
            self._apply_shadows(img, casters,
                                [particles_x] if has_particles else [],
                                psize=s)

        for world, faces, color in opaque:
            self._raster_mesh(img, depth, world, faces, color)

        if cloth is not None:
            self._raster_mesh(img, depth, cloth[0], cloth[1],
                              np.array(_CLOTH_COLOR), smooth=True)

        if self._target is not None:
            tpts = self._target[0]
            tcols = self._t(np.array([_TARGET_COLOR])).expand(len(tpts), 3)
            self._splat_points(img, depth, tpts, tcols, size=s - 1)

        if has_particles:
            cols = particle_colors
            if cols is None:
                cols = self._t(np.array([_PARTICLE_COLOR])).expand(
                    len(particles_x), 3)
            else:
                cols = cols if torch.is_tensor(cols) else torch.as_tensor(
                    np.asarray(cols))
                if not cols.is_floating_point():
                    cols = int_color_to_rgb(cols.cpu())
                cols = self._t(cols)
            self._splat_points(img, depth, particles_x, cols, size=2 * s - 1)

        for world, faces, color, alpha in transparent:
            self._raster_mesh(img, depth, world, faces, color, alpha=alpha)

        img = img.reshape(h // s, s, w // s, s, 3)
        if s > 1:
            # NumPy's mean over (1, 3): a sum in memory order, then / s^2
            acc = img[:, 0, :, 0]
            for i in range(s):
                for j in range(s):
                    if i or j:
                        acc = acc + img[:, i, :, j]
            img = acc / (s * s)
        else:
            img = img[:, 0, :, 0]
        return (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()


def _norm(v):
    """Row norms of (M, 3), floored at 1e-12, as (M, 1)."""
    return torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                      + v[:, 2] * v[:, 2]).clamp_min(1e-12)[:, None]
