"""The plain reference path tracer: the radiance of chosen pixels of a
frame, worked out again from the scene files, the camera and the render
settings, in plain PyTorch in any floating type (float64 for the
reference, a lower type for the control).

It follows ``tests/oracle_volpath.py`` of this repository (a scalar NumPy
transcription of the reference renderer's ``volpath.comp.glsl``), taken as
that file stood when the benchmark was added, written over lanes: one lane
a pixel, each pixel's samples in turn on one PCG32 stream seeded with the
pixel's linear index, as the shader's thread runs them. README.md beside
this file lists where it departs from that source. It imports nothing of
the program and takes nothing the program made: every table below is
derived here from ``scene.read_scene``.

Each bounce runs on the live lanes only (gathered, then written back), and
every hit query is a brute-force closest hit over all triangles: the
plane distance and the barycentrics are dot products with per-triangle
vectors, taken as two matrix products a query.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .scene import SceneData

MASK32 = 0xFFFFFFFF
INV_FOURPI = 0.07957747154594767
PI = 3.14159265359
INV_PI = 0.31830988618
TWOPI = 6.28318530718
REFLECTANCE = 0.8
T_MIN = 1e-4
T_MAX = 1e4
NO_INTERACTION = 500000.0
BARY_SLACK = 1e-6  # shared edges do not let a ray through
DET_EPS = 1e-12
ISO_EPS = 1e-4
LANE_BLOCK = 4096  # lanes a hit query takes at once


class Settings(NamedTuple):
    """The render settings the configuration states."""

    max_depth: int = 32
    rr_depth: int = 16
    nee_max_media: int = 4
    tir: str = "reflect"  # reflect | kill
    background: int = 1  # 0 grey, 1 checkerboard, 2 Cornell colours


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _normalize(v):
    return v / torch.clamp(torch.sqrt(_dot(v, v)), min=1e-20)[..., None]


def _rng(state, mask=None):
    """PCG32 step and RXS-M-XS output (volpath:233-246) on int64 words;
    the float is the shader's float(word) / 4294967295.0f, that is the word
    rounded to float32 over 2^32. Lanes outside ``mask`` keep their state."""
    new = (state * 747796405 + 1) & MASK32
    word = (((new >> ((new >> 28) + 4)) ^ new) * 277803737) & MASK32
    word = (word >> 22) ^ word
    value = word.to(torch.float32) / 4294967296.0
    if mask is not None:
        new = torch.where(mask, new, state)
    return new, value


class Tables:
    """Per-triangle vectors and the media of one scene on one device in
    one floating type."""

    def __init__(self, scene: SceneData, settings: Settings, device, dtype):
        self.dtype, self.device, self.settings = dtype, torch.device(device), settings
        tri = torch.as_tensor(scene.triangles, dtype=torch.float64)
        v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        n = _cross(e1, e2)
        g11, g12, g22 = _dot(e1, e1), _dot(e1, e2), _dot(e2, e2)
        det = g11 * g22 - g12 * g12
        ok = det > 0
        det = torch.where(ok, det, torch.ones_like(det))
        # (P - v0) . au and (P - v0) . av are the barycentrics of P toward
        # v1 and v2 for a point P in the triangle's plane.
        au = (g22[:, None] * e1 - g12[:, None] * e2) / det[:, None]
        av = (g11[:, None] * e2 - g12[:, None] * e1) / det[:, None]
        put = lambda x: x.to(device=self.device, dtype=dtype)  # noqa: E731
        self.ntri = tri.shape[0]
        self.planes = put(torch.cat([n, au, av]).T.contiguous())  # (3, 3T)
        self.offsets = put(torch.cat([_dot(n, v0), _dot(au, v0), _dot(av, v0)]))  # (3T,)
        self.valid = ok.to(self.device)
        self.v0, self.e1, self.e2 = put(v0), put(e1), put(e2)
        self.normal = put(n / torch.sqrt(_dot(n, n)).clamp(min=1e-300)[:, None])
        # The first medium row whose id is the triangle's (volpath:137-145).
        row = np.full(self.ntri, -1, np.int64)
        for i in reversed(range(len(scene.media))):
            row[scene.mat_ids == scene.media[i].mat_id] = i
        has = row >= 0
        media = scene.media or []
        ss = np.zeros((self.ntri, 3))
        sa = np.zeros((self.ntri, 3))
        g = np.zeros(self.ntri)
        ior = np.ones(self.ntri)
        for i, m in enumerate(media):
            sel = row == i
            ss[sel] = np.asarray(m.sigma_s) * scene.scale
            sa[sel] = np.asarray(m.sigma_a) * scene.scale
            g[sel] = sum(m.g) / 3.0
            ior[sel] = m.ior
        host = lambda a: put(torch.as_tensor(a, dtype=torch.float64))  # noqa: E731
        self.has_med = torch.as_tensor(has, device=self.device)
        self.sigma_s, self.sigma_a, self.g, self.ior = host(ss), host(sa), host(g), host(ior)
        self.light_pos = host(np.asarray(scene.light_pos))
        self.light_int = host(np.asarray(scene.light_color) * scene.light_intensity)

    def closest(self, o, d, t_max):
        """(hit, t, prim, u, v) of each ray's closest triangle with t in
        (T_MIN, t_max); the lowest index wins a tie."""
        outs = [self._closest(o[i:i + LANE_BLOCK], d[i:i + LANE_BLOCK], t_max[i:i + LANE_BLOCK])
                for i in range(0, o.shape[0], LANE_BLOCK)]
        return tuple(torch.cat(x) for x in zip(*outs))

    def _closest(self, o, d, t_max):
        n = self.ntri
        om = o @ self.planes - self.offsets
        dm = d @ self.planes
        dn = dm[:, :n]
        t = -om[:, :n] / torch.where(dn.abs() > DET_EPS, dn, torch.ones_like(dn))
        u = om[:, n:2 * n] + t * dm[:, n:2 * n]
        v = om[:, 2 * n:] + t * dm[:, 2 * n:]
        ok = (self.valid & (dn.abs() > DET_EPS) & (u >= -BARY_SLACK) & (v >= -BARY_SLACK)
              & (u + v <= 1.0 + BARY_SLACK) & (t > T_MIN) & (t < t_max[:, None]))
        t = torch.where(ok, t, torch.full_like(t, math.inf))
        prim = torch.argmin(t, dim=1)
        take = lambda x: x.gather(1, prim[:, None])[:, 0]  # noqa: E731
        tb = take(t)
        return torch.isfinite(tb), tb, prim, take(u), take(v)

    def position(self, prim, u, v):
        """The hit point rebuilt from the barycentrics (volpath:161-170)."""
        return self.v0[prim] + u[:, None] * self.e1[prim] + v[:, None] * self.e2[prim]

    def color(self, pos, normal):
        """Procedural base colour (volpath:198-226)."""
        bg = self.settings.background
        if bg == 1:
            even = ((torch.remainder(torch.floor(pos[:, 0]), 2.0) == 0)
                    == (torch.remainder(torch.floor(pos[:, 1]), 2.0) == 0))
            c = torch.where(even, 0.8, 0.3).to(self.dtype)
            return c[:, None].expand(-1, 3)
        base = torch.full_like(pos, 0.8)
        if bg == 2:
            zero = torch.zeros_like(pos[:, 0])
            red = torch.stack([zero + 0.8, zero, zero], -1)
            green = torch.stack([zero, zero + 0.8, zero], -1)
            base = torch.where((normal[:, 0] > 0.99)[:, None], red,
                               torch.where((normal[:, 0] < -0.99)[:, None], green, base))
        return base

    def direct(self, pos):
        """Light reaching ``pos`` from the point light (volpath:337-426):
        through at most ``nee_max_media`` medium boundary pairs, each
        segment attenuated by its entry medium and 0.9; an opaque hit
        occludes; a lane still marching after the last pair is dark."""
        to_light = self.light_pos - pos
        dist = torch.sqrt(_dot(to_light, to_light))
        inv = 1.0 / torch.clamp(dist, min=1e-20)
        value = self.light_int * (inv * inv)[:, None]
        ldir = to_light * inv[:, None]
        trans = torch.ones_like(pos)
        origin = pos.clone()
        remaining = dist.clone()
        for _ in range(self.settings.nee_max_media):
            run = (remaining > 0).nonzero()[:, 0]
            if run.numel() == 0:
                break
            o, ld, rem = origin[run], ldir[run], remaining[run]
            hit1, t1, p1, u1, v1 = self.closest(o, ld, rem * 0.999)
            med1 = self.has_med[p1]
            tr = torch.where((hit1 & ~med1)[:, None], torch.zeros_like(o), trans[run])
            enter = hit1 & med1
            rem_after = rem - t1
            pos1 = self.position(p1, u1, v1)
            hit2, t2, p2, u2, v2 = self.closest(pos1, ld, torch.clamp(rem_after, min=T_MIN))
            hit2 = hit2 & enter
            med2 = self.has_med[p2]
            tr = torch.where((hit2 & ~med2)[:, None], torch.zeros_like(tr), tr)
            pair = hit2 & med2
            seg = torch.minimum(t2, rem_after)
            seg_tr = torch.exp(-(self.sigma_s[p1] + self.sigma_a[p1]) * seg[:, None])
            trans[run] = torch.where(pair[:, None], tr * 0.9 * seg_tr, tr)
            origin[run] = torch.where(pair[:, None], self.position(p2, u2, v2), o)
            remaining[run] = torch.where(pair, rem_after - t2, torch.zeros_like(rem))
        trans = torch.where((remaining > 0)[:, None], torch.zeros_like(trans), trans)
        return value * trans


def _refract(d, n, eta):
    """Snell refraction with the unflipped normal (volpath:550-562); the
    second value is total internal reflection."""
    cos_i = -_dot(d, n)
    sin2_t = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return eta[:, None] * d + (eta * cos_i - cos_t)[:, None] * n, sin2_t >= 1.0


def _fresnel(n1, n2, d, n):
    """Unpolarised Fresnel reflectance (volpath:320-335), 0 under total
    internal reflection."""
    cos1 = torch.clamp(_dot(_normalize(d), _normalize(n)).abs(), 0.0, 1.0)
    theta1 = torch.acos(cos1)
    sin_t2 = n1 / n2 * torch.sin(theta1)
    theta2 = torch.asin(torch.clamp(sin_t2, -1.0, 1.0))
    c1, c2 = torch.cos(theta1), torch.cos(theta2)
    rs = (n1 * c1 - n2 * c2) / (n1 * c1 + n2 * c2)
    rp = (n1 * c2 - n2 * c1) / (n1 * c2 + n2 * c1)
    r = (rs * rs + rp * rp) * 0.5
    return torch.where(sin_t2 >= 1.0, torch.zeros_like(r), r)


def _boundary(d, n, ior):
    """Both boundary events' quantities (volpath:633-667, :723-753): the
    reflected direction, the transmitted one (the reflection under total
    internal reflection), the reflectance and the total internal
    reflection flag."""
    out = _dot(d, n) > 0
    n1 = torch.where(out, ior, torch.ones_like(ior))
    n2 = torch.where(out, torch.ones_like(ior), ior)
    refl = _normalize(d - (2.0 * _dot(d, n))[:, None] * n)
    refr, tir = _refract(d, n, n1 / n2)
    trans = torch.where(tir[:, None], refl, _normalize(torch.where(tir[:, None], n, refr)))
    return refl, trans, _fresnel(n1, n2, d, n), tir


def _free_flight(rand, ss, sa, dist):
    """Distance sampling in a homogeneous medium (volpath:482-543)."""
    ext = ss + sa
    density = ext.amin(dim=-1)
    albedo = torch.where(ext > 0, ss / torch.clamp(ext, min=1e-30), torch.full_like(ext, -1.0))
    weight = albedo.amax(dim=-1)
    weight = torch.where(weight > 0, torch.clamp(weight, min=0.5), weight)
    draw = rand < weight
    scaled = torch.where(draw, rand / torch.where(draw, weight, torch.ones_like(weight)),
                         torch.zeros_like(rand))
    sample = -torch.log(torch.clamp(1.0 - scaled, min=1e-37)) / torch.clamp(density, min=1e-30)
    sample = torch.where(draw & (density > 0), sample, torch.full_like(sample, NO_INTERACTION))
    success = sample < dist
    t = torch.where(success, sample, dist)
    p_fail = torch.exp(-density * t)
    p_success = density * p_fail * weight
    p_fail = weight * p_fail + (1.0 - weight)
    trans = torch.exp(-ext * t[:, None])
    trans = torch.where((trans.amax(dim=-1) < 1e-4)[:, None], torch.zeros_like(trans), trans)
    return success, t, p_fail, p_success, trans


def _phase_sample(axis, g, r1, r2):
    """Henyey-Greenstein direction about ``axis`` (volpath:444-479); an
    isotropic medium samples the sphere."""
    iso = g.abs() < ISO_EPS
    tmp = (1.0 - g * g) / (1.0 - g + 2.0 * g * r1)
    cos_t = torch.where(iso, 1.0 - 2.0 * r1,
                        (1.0 + g * g - tmp * tmp) / (2.0 * torch.where(iso, torch.ones_like(g), g)))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = TWOPI * r2
    nx, ny, nz = axis[:, 0], axis[:, 1], axis[:, 2]
    zero = torch.zeros_like(nx)
    ia = 1.0 / torch.sqrt(torch.clamp(nx * nx + nz * nz, min=1e-20))
    ib = 1.0 / torch.sqrt(torch.clamp(ny * ny + nz * nz, min=1e-20))
    t = torch.where((nx.abs() > ny.abs())[:, None], torch.stack([nz * ia, zero, -nx * ia], -1),
                    torch.stack([zero, nz * ib, -ny * ib], -1))
    s = _cross(t, axis)
    return (s * (sin_t * torch.cos(phi))[:, None] + t * (sin_t * torch.sin(phi))[:, None]
            + axis * cos_t[:, None])


def _disk(r1, r2):
    """Concentric square-to-disk map (volpath:272-297)."""
    u, v = 2.0 * r1 - 1.0, 2.0 * r2 - 1.0
    zero = (u == 0) & (v == 0)
    use_u = u * u > v * v
    one = torch.ones_like(u)
    r = torch.where(use_u, u, v)
    phi = torch.where(use_u, (PI / 4.0) * (v / torch.where(use_u, u, one)),
                      PI / 2.0 - (u / torch.where(use_u | (v == 0), one, v)) * (PI / 4.0))
    r = torch.where(zero, torch.zeros_like(r), r)
    phi = torch.where(zero, torch.zeros_like(phi), phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def _bounce(tb: Tables, o, d, thr, rad, st, depth):
    """One bounce of live lanes (volpath:606-798); returns the new state
    and each lane's liveness."""
    cfg, dt = tb.settings, tb.dtype
    k = o.shape[0]
    z3 = torch.zeros_like(thr)
    got, _t, prim, u, v = tb.closest(o, d, torch.full((k,), T_MAX, dtype=dt, device=o.device))
    pos = tb.position(prim, u, v)
    nrm = tb.normal[prim]
    has_med = got & tb.has_med[prim]
    ss = torch.where(has_med[:, None], tb.sigma_s[prim], z3)
    sa = torch.where(has_med[:, None], tb.sigma_a[prim], z3)
    g = torch.where(has_med, tb.g[prim], torch.zeros_like(tb.g[prim]))
    ior = torch.where(has_med, tb.ior[prim], torch.ones_like(tb.ior[prim]))

    refl1, trans1, r1, tir1 = _boundary(d, nrm, ior)
    st, rf = _rng(st, has_med)
    do_reflect = has_med & (rf.to(dt) < r1)
    transmitted = has_med & ~do_reflect
    dir_after = torch.where(do_reflect[:, None], refl1,
                            torch.where(transmitted[:, None], trans1, d))
    o = torch.where(do_reflect[:, None], pos, o)
    depth = depth + has_med.to(depth.dtype)

    seg = torch.full((k,), T_MAX, dtype=dt, device=o.device)
    tr_idx = transmitted.nonzero()[:, 0]
    if tr_idx.numel():
        hit, t, _p, _u, _v = tb.closest(pos[tr_idx], dir_after[tr_idx],
                                        torch.full((tr_idx.numel(),), T_MAX, dtype=dt,
                                                   device=o.device))
        seg[tr_idx] = torch.where(hit, t, torch.full_like(t, T_MAX))
    st, rd = _rng(st, transmitted)
    success, ms_t, p_fail, p_success, trans = _free_flight(rd.to(dt), ss, sa, seg)
    scatter = transmitted & success
    if cfg.tir == "kill":
        scatter = scatter & ~tir1
    pass_med = transmitted & ~scatter

    diffuse = got & ~has_med
    shade = diffuse & ~(_dot(d, nrm) > 0)

    light = z3.clone()
    nee = (scatter | shade).nonzero()[:, 0]
    if nee.numel():
        light[nee] = tb.direct(pos[nee])
    phase0 = INV_FOURPI * (1.0 - g * g) / ((1.0 + g * g) * torch.sqrt(1.0 + g * g))

    # Scatter (volpath:693-710): the NEE from the boundary point, the
    # phase at outDir = 0, the new origin along the new direction.
    scale = torch.where((p_success > 0)[:, None],
                        ss * trans / torch.where(p_success > 0, p_success,
                                                 torch.ones_like(p_success))[:, None], z3)
    thr = torch.where(scatter[:, None], thr * scale, thr)
    rad = rad + torch.where(scatter[:, None], thr * light * phase0[:, None], z3)
    st, ph1 = _rng(st, scatter)
    st, ph2 = _rng(st, scatter)
    hg = _phase_sample(dir_after, g, ph1.to(dt), ph2.to(dt))
    o = torch.where(scatter[:, None], pos + hg * ms_t[:, None], o)
    new_dir = torch.where(scatter[:, None], hg, dir_after)

    # Pass-through (volpath:713-756): the second boundary with the entry
    # normal.
    pscale = torch.where((p_fail > 0)[:, None],
                         trans / torch.where(p_fail > 0, p_fail, torch.ones_like(p_fail))[:, None],
                         z3)
    thr = torch.where(pass_med[:, None], thr * pscale, thr)
    refl2, trans2, r2, tir2 = _boundary(dir_after, nrm, ior)
    st, rf2 = _rng(st, pass_med)
    pass_dir = torch.where((rf2.to(dt) < r2)[:, None], refl2, trans2)
    o = torch.where(pass_med[:, None], pos + dir_after * ms_t[:, None], o)
    new_dir = torch.where(pass_med[:, None], pass_dir, new_dir)

    # Diffuse (volpath:758-779): the local disk direction used as a world
    # direction, the eval's frame mix.
    st, q1 = _rng(st, shade)
    st, q2 = _rng(st, shade)
    dx, dy = _disk(q1.to(dt), q2.to(dt))
    temp = 1.0 - dx * dx - dy * dy
    wo = torch.stack([dx, dy, torch.where(temp <= 0, torch.full_like(temp, 1e-10),
                                          torch.sqrt(torch.clamp(temp, min=0.0)))], -1)
    thr = torch.where(shade[:, None], thr * REFLECTANCE, thr)
    seen = (_dot(-d, nrm) > 0) & (_dot(wo, nrm) > 0)
    deval = torch.where(seen, REFLECTANCE * INV_PI * wo[:, 2], torch.zeros_like(wo[:, 2]))
    rad = rad + torch.where(shade[:, None], thr * light * deval[:, None] * tb.color(pos, nrm), z3)
    wo = _normalize(wo)
    o = torch.where(shade[:, None], pos + wo * T_MIN, o)
    new_dir = torch.where(shade[:, None], wo, new_dir)
    d = torch.where((do_reflect | scatter | pass_med | shade)[:, None], new_dir, d)

    # Depth and Russian roulette (volpath:786-797).
    enders = scatter | shade
    depth = depth + (enders | pass_med).to(depth.dtype)
    rr = enders & (depth > cfg.rr_depth)
    st, rq = _rng(st, rr)
    q = torch.clamp(thr.amax(dim=-1), max=0.95)
    survive = rq.to(dt) <= q
    thr = torch.where((rr & survive)[:, None], thr / torch.clamp(q, min=1e-20)[:, None], thr)
    alive = (do_reflect | pass_med | (enders & (~rr | survive))) & (depth < cfg.max_depth)
    if cfg.tir == "kill":
        alive = alive & ~((transmitted & tir1) | (pass_med & tir2))
    return o, d, thr, rad, st, depth, alive


class Camera(NamedTuple):
    origin: torch.Tensor
    forward: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    fov_scale: float


def make_camera(position, look_at, fov_deg, device, dtype) -> Camera:
    """Look-at basis with world up (volpath:575-592) and the shader's
    ``2 pi - radians(fov)`` forward scale."""
    pos = torch.tensor(position, dtype=torch.float64)
    forward = _normalize(torch.tensor(look_at, dtype=torch.float64) - pos)
    right = _normalize(_cross(forward, torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64)))
    up = _normalize(_cross(right, forward))
    put = lambda x: x.to(device=device, dtype=dtype)  # noqa: E731
    return Camera(put(pos), put(forward), put(right), put(up), TWOPI - math.radians(fov_deg))


def render_pixels(tb: Tables, camera: Camera, pixels, width: int, height: int,
                  samples: int) -> torch.Tensor:
    """(K, 3) mean radiance of the pixels ``pixels`` ((K, 2) x, y) of a
    width x height frame over ``samples`` samples, in ``tb.dtype``."""
    dev, dt = tb.device, tb.dtype
    pix = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=dev)
    k = pix.shape[0]
    state = (pix[:, 1] * width + pix[:, 0]) & MASK32
    acc = torch.zeros((k, 3), dtype=dt, device=dev)
    for _ in range(samples):
        state, j1 = _rng(state)
        state, j2 = _rng(state)
        u = (2.0 * (pix[:, 0].to(dt) + j1.to(dt)) - width) / height
        v = -(2.0 * (pix[:, 1].to(dt) + j2.to(dt)) - height) / height
        d = _normalize(u[:, None] * camera.right + v[:, None] * camera.up
                       + camera.fov_scale * camera.forward)
        o = camera.origin.expand(k, 3).clone()
        thr = torch.ones((k, 3), dtype=dt, device=dev)
        rad = torch.zeros((k, 3), dtype=dt, device=dev)
        depth = torch.zeros((k,), dtype=torch.int64, device=dev)
        live = torch.arange(k, device=dev)
        while live.numel():
            out = _bounce(tb, o[live], d[live], thr[live], rad[live], state[live], depth[live])
            for dst, src in zip((o, d, thr, rad, state, depth), out[:6]):
                dst[live] = src
            live = live[out[6]]
        acc += rad
    return acc / samples
