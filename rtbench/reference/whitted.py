"""The reference Whitted renderer, at chosen pixels, in plain PyTorch.

Semantics (those of the viewer's shader): every sample of pixel (x, y) is
jittered by the hash ``fract(sin(x*12.9898 + y*78.233 + 1113.1*seed) *
43758.5453)`` with seeds ``spp + s`` and ``spp + s + 0.5``, and leaves the
camera along ``ux*right + uy*up + 2.5*forward``, normalised. Each of at
most ``bounces + 1`` iterations finds the closest hit in ``(1e-3, 1e4)``
among all instances' triangles (two-sided Moller-Trumbore, the smooth
normal interpolated from the corners and taken to world space by the
inverse transpose). A miss ends the sample with the sky in the ray's
direction (z flipped), bilinear between texels quantised to 8 bits,
which replaces its radiance. A front-facing diffuse hit sends a shadow
ray from 1e-2 along the normal toward the light and, if nothing lies in
``(1e-3, distance)``, adds ``0.9**s`` times Blinn-Phong, and ends; a
back-facing one ends. A mirror reflects and a refractive hit refracts
(index 1.52, total internal reflection), from 1e-2 off the surface. The
radiance starts at the ambient ``Iamb * ka``; a sample still going after
the last iteration keeps it. The pixel is the mean over samples.

The intersection is brute force: every ray against every triangle of an
instance whose bounding sphere it meets, as one product of ray features
``(d x o, d, o, 1)`` with per-triangle coefficients giving ``det``,
``u*det``, ``v*det`` and ``t*det`` (the scalar triple products of
Moller-Trumbore, expanded), in blocks that fit. ``dtype`` sets the
precision of all of it (float32; bfloat16 for the control).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from rtbench.reference import scene_math

FOCAL_LENGTH = 2.5
RAY_TMIN, RAY_TMAX = 1e-3, 1e4
HIT_EPSILON = 1e-2
DET_EPS = 1e-9
SAMPLE_DECAY = 0.9
IOR = 1.52
AMBIENT = tuple(0.8 * k for k in (0.1, 0.3, 0.1))     # Iamb * ka
KD, KS, SHININESS = (0.2, 1.0, 0.2), (0.8, 0.8, 0.8), 100.0
MATERIALS = {"diffuse": 0, "mirror": 1, "refractive": 2}
BLOCK_ELEMS = 1 << 24   # (rays x triangles) of one block's products


@contextlib.contextmanager
def exact_matmul():
    """float32 products in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _skew(a):
    """(T, 3) -> (T, 9): the row-major matrix of ``x -> a x x``."""
    z = torch.zeros_like(a[:, 0])
    return torch.stack([z, -a[:, 2], a[:, 1], a[:, 2], z, -a[:, 0],
                        -a[:, 1], a[:, 0], z], dim=1)


def _normalize(v):
    n = torch.sqrt(_dot(v, v))
    return v * (1.0 / torch.clamp_min(n, 1e-30))[..., None]


class Instance:
    """One placed mesh: its triangles' coefficients (16, 4, T), corner
    normals, bounding sphere and material, in ``dtype`` on ``device``."""

    def __init__(self, positions, normals, triangles, material: str,
                 device, dtype):
        p = torch.as_tensor(np.asarray(positions, np.float32), device=device)
        nrm = torch.as_tensor(np.asarray(normals, np.float32), device=device)
        tri = torch.as_tensor(np.asarray(triangles, np.int64), device=device)
        v0, v1, v2 = (p[tri[:, k]] for k in range(3))
        e1, e2 = v1 - v0, v2 - v0
        n_face = _cross(e1, e2)
        zeros3 = torch.zeros_like(v0)
        one = torch.ones_like(v0[:, :1])
        z9 = torch.zeros((v0.shape[0], 9), device=device)
        rows = [
            torch.cat([z9, _cross(e2, e1), zeros3, one * 0], 1),          # det
            torch.cat([_skew(e2), -_cross(e2, v0), zeros3, one * 0], 1),  # u det
            torch.cat([-_skew(e1), -_cross(v0, e1), zeros3, one * 0], 1),  # v det
            torch.cat([z9, zeros3, n_face, -_dot(v0, n_face)[:, None]], 1),  # t det
        ]
        self.coef = torch.stack(rows, dim=1).permute(2, 1, 0).contiguous().to(dtype)
        self.normals = tuple(nrm[tri[:, k]].to(dtype) for k in range(3))
        lo, hi = p.min(dim=0).values, p.max(dim=0).values
        self.center = (lo + hi) * 0.5
        self.radius = float(torch.sqrt(((p - self.center) ** 2).sum(1)).max())
        self.material = MATERIALS[material]
        self.count = tri.shape[0]


def _features(o, d):
    dxo = (d[:, :, None] * o[:, None, :]).reshape(-1, 9)
    return torch.cat([dxo, d, o, torch.ones_like(o[:, :1])], dim=1)


class Reference:
    """The reference scene: instances with their transforms, the light,
    and the sky quantised as the device holds it."""

    def __init__(self, config: dict, meshes, sky: torch.Tensor, device,
                 dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        self.instances = [Instance(*mesh, obj["material"], device, dtype)
                          for mesh, obj in zip(meshes, config["objects"])]
        self.animations = [obj["animation"] for obj in config["objects"]]
        self.light = torch.tensor(config["light_position"], device=device,
                                  dtype=torch.float32).to(dtype)
        self.light_intensity = float(np.float32(config["light_intensity"]))
        sky8 = torch.clamp(sky.to(device, torch.float32) * 255.0 + 0.5, 0, 255)
        self.sky = (sky8.to(torch.int32).to(torch.float32) * (1.0 / 255.0)).to(dtype)
        self.width, self.height = int(config["width"]), int(config["height"])
        self.spp = int(config["samples_per_pixel"])
        self.bounces = int(config["max_bounce_count"])
        self.transforms = None

    def set_history(self, history) -> None:
        """Place the instances after the animation steps ``history``."""
        mats = scene_math.instance_matrices(self.animations, list(history))
        pairs = [scene_math.affine_pair(m) for m in mats]
        self.transforms = [tuple(torch.as_tensor(x, device=self.device).to(self.dtype)
                                 for x in pair) for pair in pairs]

    # -- rays against triangles ------------------------------------------
    def _object_rays(self, i, o, d):
        _, w2o = self.transforms[i]
        return o @ w2o[:, :3].T + w2o[:, 3], d @ w2o[:, :3].T

    def _may_hit(self, inst, o, d):
        """Rays whose line meets the instance's bounding sphere (loosely)."""
        oc = inst.center.to(o.dtype) - o
        dn = d / torch.clamp_min(torch.sqrt(_dot(d, d)), 1e-30)[:, None]
        dist2 = _dot(oc, oc) - _dot(oc, dn) ** 2
        r = inst.radius * 1.01 + 1e-3
        return dist2.float() <= r * r

    def _blocks(self, inst, n_rays):
        tc = max(1, min(inst.count, BLOCK_ELEMS // max(1, n_rays)))
        return range(0, inst.count, tc), tc

    def closest(self, o, d, tmax):
        """(t, inst, prim, u, v) of the closest hit within (RAY_TMIN,
        tmax) per ray; inst -1 on a miss."""
        n = o.shape[0]
        best = tmax.clone()
        inst_id = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        prim = torch.zeros((n,), dtype=torch.int64, device=self.device)
        bu = torch.zeros_like(best)
        bv = torch.zeros_like(best)
        for i, inst in enumerate(self.instances):
            oo, dd = self._object_rays(i, o, d)
            sel = self._may_hit(inst, oo, dd).nonzero().squeeze(1)
            if not sel.numel():
                continue
            for r0 in range(0, sel.numel(), 4096):
                rows = sel[r0:r0 + 4096]
                feat = _features(oo[rows], dd[rows])
                b_t = best[rows].clone()
                b_p = torch.full_like(rows, -1)
                b_u = torch.zeros_like(b_t)
                b_v = torch.zeros_like(b_t)
                starts, tc = self._blocks(inst, rows.numel())
                for t0 in starts:
                    coef = inst.coef[:, :, t0:t0 + tc]
                    det, uu, vv, tt = (feat @ coef.reshape(16, -1)).reshape(
                        rows.numel(), 4, -1).unbind(1)
                    ok = torch.abs(det) > DET_EPS
                    inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
                    u, v, t = uu * inv, vv * inv, tt * inv
                    hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1)
                           & (t > RAY_TMIN) & (t < b_t[:, None]))
                    tm = torch.where(hit, t, torch.full_like(t, float("inf")))
                    t_blk, j = tm.min(dim=1)
                    better = t_blk < b_t
                    b_t = torch.where(better, t_blk, b_t)
                    b_p = torch.where(better, j + t0, b_p)
                    b_u = torch.where(better, u.gather(1, j[:, None])[:, 0], b_u)
                    b_v = torch.where(better, v.gather(1, j[:, None])[:, 0], b_v)
                found = b_p >= 0
                idx = rows[found]
                best[idx] = b_t[found]
                inst_id[idx] = i
                prim[idx] = b_p[found]
                bu[idx] = b_u[found]
                bv[idx] = b_v[found]
        return best, inst_id, prim, bu, bv

    def occluded(self, o, d, tmax):
        """Whether some triangle lies within (RAY_TMIN, tmax) per ray."""
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=self.device)
        for i, inst in enumerate(self.instances):
            oo, dd = self._object_rays(i, o, d)
            sel = (self._may_hit(inst, oo, dd) & ~occ).nonzero().squeeze(1)
            for r0 in range(0, sel.numel(), 4096):
                rows = sel[r0:r0 + 4096]
                feat = _features(oo[rows], dd[rows])
                hit_any = torch.zeros(rows.numel(), dtype=torch.bool,
                                      device=self.device)
                starts, tc = self._blocks(inst, rows.numel())
                for t0 in starts:
                    coef = inst.coef[:, :, t0:t0 + tc]
                    det, uu, vv, tt = (feat @ coef.reshape(16, -1)).reshape(
                        rows.numel(), 4, -1).unbind(1)
                    ok = torch.abs(det) > DET_EPS
                    inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
                    u, v, t = uu * inv, vv * inv, tt * inv
                    hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1)
                           & (t > RAY_TMIN) & (t < tmax[rows][:, None]))
                    hit_any |= hit.any(dim=1)
                occ[rows] = hit_any
        return occ

    def normal(self, inst_id, prim, u, v):
        """World unit shading normals at hits (rows with inst_id >= 0)."""
        out = torch.zeros((inst_id.shape[0], 3), dtype=self.dtype, device=self.device)
        for i, inst in enumerate(self.instances):
            rows = (inst_id == i).nonzero().squeeze(1)
            if not rows.numel():
                continue
            p, uu, vv = prim[rows], u[rows][:, None], v[rows][:, None]
            n_obj = ((1.0 - uu - vv) * inst.normals[0][p] + uu * inst.normals[1][p]
                     + vv * inst.normals[2][p])
            _, w2o = self.transforms[i]
            out[rows] = n_obj @ w2o[:, :3]
        return _normalize(out)

    # -- sky --------------------------------------------------------------
    def sky_color(self, d):
        """Bilinear, clamp-to-edge cube-map lookup in direction (x, y, -z)."""
        x, y, z = d[:, 0], d[:, 1], -d[:, 2]
        ax, ay, az = x.abs(), y.abs(), z.abs()
        is_x = (ax >= ay) & (ax >= az)
        is_y = ~is_x & (ay >= az)
        face = torch.where(is_x, torch.where(x >= 0, 0, 1),
                           torch.where(is_y, torch.where(y >= 0, 2, 3),
                                       torch.where(z >= 0, 4, 5)))
        ma = torch.clamp_min(torch.where(is_x, ax, torch.where(is_y, ay, az)), 1e-30)
        sc = torch.where(is_x, torch.where(x >= 0, -z, z),
                         torch.where(is_y, x, torch.where(z >= 0, x, -x)))
        tc = torch.where(is_y, torch.where(y >= 0, z, -z), -y)
        s = 0.5 * (sc / ma + 1.0)
        t = 0.5 * (tc / ma + 1.0)
        h, w = self.sky.shape[1], self.sky.shape[2]
        fx, fy = s * w - 0.5, t * h - 0.5
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx, wy = (fx - x0)[:, None], (fy - y0)[:, None]
        x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
        xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
        ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
        tex = self.sky
        top = tex[face, ya, xa] * (1 - wx) + tex[face, ya, xb] * wx
        bot = tex[face, yb, xa] * (1 - wx) + tex[face, yb, xb] * wx
        return top * (1 - wy) + bot * wy

    # -- the frame --------------------------------------------------------
    def primary(self, camera, px, py, sample):
        dt = self.dtype
        px, py, sample = (x.to(dt) for x in (px, py, sample))

        def rnd(seed):
            x = torch.sin(px * 12.9898 + py * 78.233 + 1113.1 * seed) * 43758.5453
            return x - torch.floor(x)

        seed0 = float(self.spp) + sample
        jx, jy = rnd(seed0), rnd(seed0 + 0.5)
        ux = ((px + jx) / self.width) * 2.0 - 1.0
        uy = -(((py + jy) / self.height) * 2.0 - 1.0)
        cam = torch.as_tensor(camera, device=self.device).to(dt)
        d = ux[:, None] * cam[1] + uy[:, None] * cam[2] + FOCAL_LENGTH * cam[3]
        return cam[0].expand_as(d).clone(), _normalize(d)

    def render(self, camera, pixels, stats=None):
        """Colours (P, 3) f32 of ``pixels`` (P, 2) int (x, y) seen by
        ``camera`` (4, 3) rows position, right, up, forward, with the
        instances where :meth:`set_history` put them. ``stats``, if a
        dict, receives the share of primary samples that hit geometry."""
        dt, dev, spp = self.dtype, self.device, self.spp
        pix = torch.as_tensor(np.asarray(pixels), device=dev)
        n = pix.shape[0] * spp
        px = pix[:, 0].repeat_interleave(spp).to(torch.float32)
        py = pix[:, 1].repeat_interleave(spp).to(torch.float32)
        sample = torch.arange(spp, device=dev, dtype=torch.float32).repeat(pix.shape[0])
        o, d = self.primary(camera, px, py, sample)
        color = torch.tensor(AMBIENT, dtype=dt, device=dev).repeat(n, 1)
        decay = torch.pow(torch.tensor(SAMPLE_DECAY, dtype=dt, device=dev),
                          sample.to(dt))
        live = torch.arange(n, device=dev)
        kd, ks = (torch.tensor(k, dtype=dt, device=dev) for k in (KD, KS))
        with exact_matmul():
            for j in range(self.bounces + 1):
                if not live.numel():
                    break
                ol, dl = o[live], d[live]
                t, inst, prim, u, v = self.closest(
                    ol, dl, torch.full((live.numel(),), RAY_TMAX, dtype=dt, device=dev))
                if j == 0 and stats is not None:
                    stats["primary_hit_share"] = float((inst >= 0).float().mean())
                miss = inst < 0
                color[live[miss]] = self.sky_color(dl[miss])
                hit = (~miss).nonzero().squeeze(1)
                live, ol, dl = live[hit], ol[hit], dl[hit]
                t, inst, prim, u, v = t[hit], inst[hit], prim[hit], u[hit], v[hit]
                pos = ol + t[:, None] * dl
                nrm = self.normal(inst, prim, u, v)
                mat = torch.tensor([x.material for x in self.instances],
                                   device=dev)[inst]
                ndotd = _dot(dl, nrm)
                lit = (mat == 0) & (ndotd < 0)
                if lit.any():
                    rows = lit.nonzero().squeeze(1)
                    p_l, n_l, d_l = pos[rows], nrm[rows], dl[rows]
                    to_light = self.light - p_l
                    dist = torch.sqrt(_dot(to_light, to_light))
                    ldir = to_light * (1.0 / torch.clamp_min(dist, 1e-30))[:, None]
                    occ = self.occluded(p_l + HIT_EPSILON * n_l, ldir, dist)
                    h = _normalize(ldir - d_l)
                    ndotl = torch.clamp_min(_dot(n_l, ldir), 0.0)
                    spec = torch.clamp_min(_dot(n_l, h), 0.0) ** SHININESS
                    phong = self.light_intensity * (kd * ndotl[:, None]
                                                    + ks * spec[:, None])
                    add = torch.where(occ[:, None], torch.zeros_like(phong),
                                      decay[live[rows]][:, None] * phong)
                    color[live[rows]] = color[live[rows]] + add
                cont = (mat == 1) | (mat == 2)
                mirror = mat[cont] == 1
                live, pos, nrm, dl = live[cont], pos[cont], nrm[cont], dl[cont]
                no, nd = self._mirror(pos, nrm, dl)
                ro, rd = self._refract(pos, nrm, dl)
                o[live] = torch.where(mirror[:, None], no, ro)
                d[live] = torch.where(mirror[:, None], nd, rd)
        return color.float().reshape(-1, spp, 3).mean(dim=1)

    @staticmethod
    def _mirror(pos, n, d):
        return pos + HIT_EPSILON * n, d - (2.0 * _dot(d, n))[:, None] * n

    @staticmethod
    def _refract(pos, n, d):
        ndoti = _dot(d, n)
        out = ndoti > 0
        n_f = torch.where(out[:, None], -n, n)
        ndoti_f = torch.where(out, -ndoti, ndoti)
        ratio = torch.where(out, torch.full_like(ndoti, IOR),
                            torch.full_like(ndoti, 1.0 / IOR))
        k = 1.0 - ratio * ratio * (1.0 - ndoti_f * ndoti_f)
        tir = (k < 0)[:, None]
        d_tir = d - (2.0 * _dot(d, n_f))[:, None] * n_f
        coeff = ratio * ndoti_f + torch.sqrt(torch.clamp_min(k, 0.0))
        r = _normalize(ratio[:, None] * d - coeff[:, None] * n_f)
        return (torch.where(tir, pos + HIT_EPSILON * n_f, pos - HIT_EPSILON * n_f),
                torch.where(tir, d_tir, r))
