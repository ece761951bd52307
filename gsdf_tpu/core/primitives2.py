"""2D primitives.

Numerical semantics transcribed from the reference oracle
(cpu_evaluators.go:551-818; constructors/bounds primitives2d.go:14-700).
Branchy scalar algorithms (ellipse, exact bezier, arc) become jnp.where
selections — both branches evaluate vectorized, the select picks per lane,
which is exactly how the GLSL versions execute on GPU warps.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..geometry.boxes import Box
from . import mathx as mx
from .node import Shader2D

_f32 = np.float32


class Circle(Shader2D):
    """(cpu_evaluators.go:661, primitives2d.go:228)."""

    PARAMS = ("r",)
    CONT_PARAMS = ("r",)

    def __init__(self, r):
        self.r = _f32(r)

    def distance(self, p):
        return mx.length(p) - self.r

    def bounds(self) -> Box:
        r = self.r
        return Box(np.array([-r, -r], _f32), np.array([r, r], _f32))


class Line2D(Shader2D):
    """Thick segment (cpu_evaluators.go:551, primitives2d.go:15)."""

    PARAMS = ("a", "b", "width")

    def __init__(self, a, b, width):
        self.a = np.asarray(a, dtype=_f32)
        self.b = np.asarray(b, dtype=_f32)
        self.width = _f32(width)

    def distance(self, p):
        a = jnp.asarray(self.a)
        ba = jnp.asarray(self.b - self.a)
        dotba = float(np.dot(self.b - self.a, self.b - self.a))
        w = self.width / _f32(2)
        pa = p - a
        h = mx.clamp(mx.dot(pa, ba) / dotba, 0.0, 1.0)
        return mx.length(pa - h[..., None] * ba) - w

    def bounds(self) -> Box:
        w = self.width / 2
        lo = np.minimum(self.a, self.b) - w
        hi = np.maximum(self.a, self.b) + w
        return Box(lo, hi)


class Lines2D(Shader2D):
    """Batch of thick segments, min-reduced (cpu_evaluators.go:1145,
    primitives2d.go:70). Segments become one device gather-free broadcast —
    the SSBO/inline split of the reference is irrelevant under XLA."""

    PARAMS = ("points", "width")

    def __init__(self, points, width):
        self.points = np.asarray(points, dtype=_f32).reshape(-1, 2, 2)
        self.width = _f32(width)

    def distance(self, p):
        w = self.width / _f32(2)
        a = jnp.asarray(self.points[:, 0, :])  # (S,2)
        b = jnp.asarray(self.points[:, 1, :])
        ba = b - a
        dotba = jnp.sum(ba * ba, axis=-1)  # (S,)
        pa = p[..., None, :] - a  # (...,S,2)
        h = mx.clamp(jnp.sum(pa * ba, axis=-1) / dotba, 0.0, 1.0)
        v = pa - h[..., None] * ba
        d2 = jnp.min(jnp.sum(v * v, axis=-1), axis=-1)
        d2 = jnp.minimum(jnp.asarray(1e23, jnp.float32), d2)
        return jnp.sqrt(d2) - w

    def bounds(self) -> Box:
        pts = self.points.reshape(-1, 2)
        w = self.width / 2
        return Box(pts.min(axis=0) - w, pts.max(axis=0) + w)


class Arc2D(Shader2D):
    """(cpu_evaluators.go:564, primitives2d.go:176)."""

    PARAMS = ("radius", "angle", "thick")

    def __init__(self, radius, angle, thick):
        self.radius = _f32(radius)
        self.angle = _f32(angle)
        self.thick = _f32(thick)

    def distance(self, p):
        r = self.radius
        t = self.thick / _f32(2)
        s = _f32(math.sin(float(self.angle) / 2))
        c = _f32(math.cos(float(self.angle) / 2))
        px = jnp.abs(p[..., 0])
        py = p[..., 1]
        d_end = mx.hypot(px - r * s, py - r * c) - t
        d_arc = jnp.abs(mx.hypot(px, py) - r) - t
        return jnp.where(c * px > s * py, d_end, d_arc)

    def bounds(self) -> Box:
        r = self.radius + self.thick
        rcos = self.radius * _f32(math.cos(float(self.angle) / 2)) - self.thick
        return Box(np.array([-r, rcos], _f32), np.array([r, r], _f32))


class EquilateralTriangle(Shader2D):
    """(cpu_evaluators.go:669, primitives2d.go:266)."""

    PARAMS = ("h_tri",)
    CONT_PARAMS = ("h_tri",)

    def __init__(self, h_tri):
        self.h_tri = _f32(h_tri)

    def distance(self, p):
        k = _f32(mx.SQRT3)
        r = self.h_tri / k
        px = jnp.abs(p[..., 0]) - r
        py = p[..., 1] + r / k
        cond = px + k * py > 0
        px2 = (px - k * py) * _f32(0.5)
        py2 = (-k * px - py) * _f32(0.5)
        px = jnp.where(cond, px2, px)
        py = jnp.where(cond, py2, py)
        px = px - mx.clamp(px, -2 * r, 0.0)
        return -mx.hypot(px, py) * mx.sign(py)

    def bounds(self) -> Box:
        height = float(self.h_tri)
        side = height / mx.TRIBISECT
        long_bisect = side / mx.SQRT3
        short_bisect = long_bisect / 2
        return Box(
            np.array([-side / 2, -short_bisect], _f32),
            np.array([side / 2, long_bisect], _f32),
        )


class Rectangle(Shader2D):
    """(cpu_evaluators.go:685, primitives2d.go:308)."""

    PARAMS = ("d",)
    CONT_PARAMS = ("d",)

    def __init__(self, d):
        self.d = np.asarray(d, dtype=_f32)

    def distance(self, p):
        b = jnp.asarray(self.d * _f32(0.5))
        d = jnp.abs(p) - b
        return mx.length(jnp.maximum(d, 0.0)) + jnp.minimum(
            0.0, jnp.maximum(d[..., 0], d[..., 1])
        )

    def bounds(self) -> Box:
        h = self.d * _f32(0.5)
        return Box(-h, h)


class Hexagon2D(Shader2D):
    """(cpu_evaluators.go:718, primitives2d.go:349)."""

    PARAMS = ("side",)
    CONT_PARAMS = ("side",)

    def __init__(self, side):
        self.side = _f32(side)

    def distance(self, p):
        r = self.side
        kx, ky = _f32(-mx.TRIBISECT), _f32(0.5)
        kz = _f32(0.577350269)
        px = jnp.abs(p[..., 0])
        py = jnp.abs(p[..., 1])
        m = 2 * jnp.minimum(kx * px + ky * py, 0.0)
        px = px - m * kx
        py = py - m * ky
        px = px - mx.clamp(px, -kz * r, kz * r)
        py = py - r
        return mx.sign(py) * mx.hypot(px, py)

    def bounds(self) -> Box:
        s = float(self.side)
        w = s / mx.TRIBISECT
        return Box(np.array([-w, -s], _f32), np.array([w, s], _f32))


class Octagon2D(Shader2D):
    """(cpu_evaluators.go:731, primitives2d.go:386)."""

    PARAMS = ("c",)
    CONT_PARAMS = ("c",)

    def __init__(self, constrain):
        self.c = _f32(constrain)

    def distance(self, p):
        kx, ky, kz = _f32(-0.9238795325), _f32(0.3826834323), _f32(0.4142135623)
        r = self.c
        kzr = kz * r
        px = jnp.abs(p[..., 0])
        py = jnp.abs(p[..., 1])
        m1 = 2 * jnp.minimum(kx * px + ky * py, 0.0)
        px = px - m1 * kx
        py = py - m1 * ky
        m2 = 2 * jnp.minimum(-kx * px + ky * py, 0.0)
        px = px - m2 * -kx
        py = py - m2 * ky
        px = px - mx.clamp(px, -kzr, kzr)
        py = py - r
        return mx.sign(py) * mx.hypot(px, py)

    def bounds(self) -> Box:
        s = self.c
        return Box(np.array([-s, -s], _f32), np.array([s, s], _f32))


class Ellipse2D(Shader2D):
    """IQ iterative-free exact ellipse (cpu_evaluators.go:750,
    primitives2d.go:422; https://iquilezles.org/articles/ellipsedist)."""

    PARAMS = ("a", "b")
    CONT_PARAMS = ("a", "b")

    def __init__(self, a, b):
        self.a = _f32(a)
        self.b = _f32(b)

    def distance(self, p):
        px = jnp.abs(p[..., 0])
        py = jnp.abs(p[..., 1])
        swap = px > py
        sx = jnp.where(swap, py, px)
        sy = jnp.where(swap, px, py)
        a = jnp.where(swap, self.b, self.a)
        b = jnp.where(swap, self.a, self.b)

        l = b * b - a * a
        m = a * sx / l
        m2 = m * m
        n = b * sy / l
        n2 = n * n
        c = (m2 + n2 - 1) / _f32(3)
        c3 = c * c * c
        q = c3 + 2 * m2 * n2
        d = c3 + m2 * n2
        g = m + m * n2

        # branch d < 0 (3 real roots)
        h_acos = mx.acos(jnp.clip(q / c3, -1.0, 1.0)) / _f32(3)
        sh = jnp.sin(h_acos)
        ch = jnp.cos(h_acos)
        t_ = _f32(mx.SQRT3) * sh
        rx_a = jnp.sqrt(jnp.maximum(-c * (ch + t_ + 2) + m2, 0.0))
        ry_a = jnp.sqrt(jnp.maximum(-c * (ch - t_ + 2) + m2, 0.0))
        co_a = (ry_a + mx.sign(l) * rx_a + jnp.abs(g) / (rx_a * ry_a) - m) / _f32(2)

        # branch d >= 0 (1 real root)
        h_ = 2 * m * n * jnp.sqrt(jnp.maximum(d, 0.0))
        s_ = mx.sign(q + h_) * jnp.cbrt(jnp.abs(q + h_))
        u_ = mx.sign(q - h_) * jnp.cbrt(jnp.abs(q - h_))
        rx_b = -s_ - u_ - 4 * c + 2 * m2
        ry_b = _f32(mx.SQRT3) * (s_ - u_)
        rm = mx.hypot(rx_b, ry_b)
        co_b = (ry_b / jnp.sqrt(jnp.maximum(rm - rx_b, 1e-38)) + 2 * g / rm - m) / _f32(2)

        co = jnp.where(d < 0, co_a, co_b)
        co = jnp.clip(co, 0.0, 1.0)
        si = jnp.sqrt(jnp.maximum(1 - co * co, 0.0))
        # one trig-free Newton polish on the closest-point angle
        # (co, si) = (cos t, sin t): t <- t - g/g' where g = dD/dt of the
        # squared distance. The closed form above is exact in reals but
        # acos/cbrt rounding differs between backends and can cost up to
        # ~4e-4 near the boundary; the polish restores float32-limited
        # accuracy on every backend.
        gg = (b * b - a * a) * si * co + a * sx * si - b * sy * co
        gp = (b * b - a * a) * (co * co - si * si) + a * sx * co + b * sy * si
        delta = jnp.where(jnp.abs(gp) > _f32(1e-30), gg / gp, 0.0)
        delta = jnp.clip(delta, -0.5, 0.5)
        c_new = co + delta * si
        s_new = si - delta * co
        inv = _f32(1.0) / mx.hypot(c_new, s_new)
        co = jnp.clip(c_new * inv, 0.0, 1.0)
        si = jnp.sqrt(jnp.maximum(1 - co * co, 0.0))
        rx = a * co
        ry = b * si
        return mx.hypot(rx - sx, ry - sy) * mx.sign(sy - ry)

    def bounds(self) -> Box:
        a, b = self.a, self.b
        return Box(np.array([-a, -b], _f32), np.array([a, b], _f32))


class Polygon2D(Shader2D):
    """Winding-number polygon (cpu_evaluators.go:793, primitives2d.go:459;
    https://www.shadertoy.com/view/wdBXRW).

    Small polygons vectorize over all edges at once (one broadcast).
    Larger polygons scan over edges with `lax.scan` so peak memory stays
    O(points) instead of O(points * edges) — results are bit-identical
    (min and the winding flip count are order-independent)."""

    PARAMS = ("vert",)

    #: edge count above which the scan (O(points)-memory) path is used
    SCAN_THRESHOLD = 8

    def __init__(self, vertices):
        self.vert = np.asarray(vertices, dtype=_f32).reshape(-1, 2)

    def distance(self, p):
        v1n = self.vert  # (V,2) current vertex
        v2n = np.roll(self.vert, 1, axis=0)  # (V,2) previous vertex
        if len(v1n) <= self.SCAN_THRESHOLD:
            return self._distance_broadcast(p, v1n, v2n)
        return self._distance_scan(p, v1n, v2n)

    def _distance_broadcast(self, p, v1n, v2n):
        v1 = jnp.asarray(v1n)
        v2 = jnp.asarray(v2n)
        e = v2 - v1
        w = p[..., None, :] - v1  # (...,V,2)
        ee = jnp.sum(e * e, axis=-1)
        h = mx.clamp(jnp.sum(w * e, axis=-1) / ee, 0.0, 1.0)
        b = w - h[..., None] * e
        d = jnp.min(jnp.sum(b * b, axis=-1), axis=-1)

        py = p[..., 1:2]  # keep dim for broadcast (...,1)
        b1 = py >= v1[:, 1]
        b2 = py < v2[:, 1]
        b3 = e[:, 0] * w[..., 1] > e[:, 1] * w[..., 0]
        flip = (b1 & b2 & b3) | (~b1 & ~b2 & ~b3)
        nflips = jnp.sum(flip, axis=-1)
        s = jnp.where(nflips % 2 == 1, -1.0, 1.0).astype(jnp.float32)
        return s * jnp.sqrt(d)

    def _distance_scan(self, p, v1n, v2n):
        import jax

        edges = jnp.asarray(
            np.concatenate([v1n, v2n], axis=1).astype(np.float32)
        )  # (V,4): v1x v1y v2x v2y
        px = p[..., 0]
        py = p[..., 1]

        def body(carry, edge):
            d, nflips = carry
            v1x, v1y, v2x, v2y = edge[0], edge[1], edge[2], edge[3]
            ex, ey = v2x - v1x, v2y - v1y
            wx, wy = px - v1x, py - v1y
            ee = ex * ex + ey * ey
            h = mx.clamp((wx * ex + wy * ey) / ee, 0.0, 1.0)
            bx, by = wx - h * ex, wy - h * ey
            d = jnp.minimum(d, bx * bx + by * by)
            b1 = py >= v1y
            b2 = py < v2y
            b3 = ex * wy > ey * wx
            flip = (b1 & b2 & b3) | (~b1 & ~b2 & ~b3)
            return (d, nflips + flip.astype(jnp.int32)), None

        init = (
            jnp.full(p.shape[:-1], np.inf, dtype=p.dtype),
            jnp.zeros(p.shape[:-1], dtype=jnp.int32),
        )
        # unroll=8: keeps the carry in registers (see scan_fold's
        # contract note; the gain on the GPU is not measured). The fold's
        # min/flip accumulation is pinned against the float64 numpy
        # oracle in tests, not against a sequential fold, so contraction
        # re-association under unrolling is within its tolerance budget.
        (d, nflips), _ = mx.scan_fold(body, init, edges, unroll=8)
        s = jnp.where(nflips % 2 == 1, -1.0, 1.0).astype(jnp.float32)
        return s * jnp.sqrt(d)

    def bounds(self) -> Box:
        return Box(self.vert.min(axis=0), self.vert.max(axis=0))


class Diamond2D(Shader2D):
    """(cpu_evaluators.go:694, primitives2d.go:561)."""

    PARAMS = ("d",)
    CONT_PARAMS = ("d",)

    def __init__(self, d):
        self.d = np.asarray(d, dtype=_f32)

    def distance(self, p):
        b = jnp.asarray(self.d * _f32(0.5))
        pa = jnp.abs(p)
        bmp = b - 2 * pa
        h = mx.clamp(mx.ndot(bmp, b) / jnp.sum(b * b), -1.0, 1.0)
        qx = pa[..., 0] - _f32(0.5) * b[0] * (1 - h)
        qy = pa[..., 1] - _f32(0.5) * b[1] * (1 + h)
        d = mx.hypot(qx, qy)
        return d * mx.sign(pa[..., 0] * b[1] + pa[..., 1] * b[0] - b[0] * b[1])

    def bounds(self) -> Box:
        h = self.d * _f32(0.5)
        return Box(-h, h)


class RoundedX2D(Shader2D):
    """(cpu_evaluators.go:705, primitives2d.go:603)."""

    PARAMS = ("dim", "thick")
    CONT_PARAMS = ("dim", "thick")

    def __init__(self, width, thick):
        self.dim = _f32(width)
        self.thick = _f32(thick)

    def distance(self, p):
        w = self.dim
        r = self.thick
        pa = jnp.abs(p)
        sub = _f32(0.5) * jnp.minimum(pa[..., 0] + pa[..., 1], w)
        return mx.hypot(pa[..., 0] - sub, pa[..., 1] - sub) - r

    def bounds(self) -> Box:
        xd2 = self.dim / 2 + self.thick
        return Box(np.array([-xd2, -xd2], _f32), np.array([xd2, xd2], _f32))


class QuadraticBezier2D(Shader2D):
    """IQ exact quadratic bezier with cancellation-safe branch
    (cpu_evaluators.go:581-659, primitives2d.go:644)."""

    PARAMS = ("a", "b", "c", "thick")

    def __init__(self, a, b, c, thick):
        self.a = np.asarray(a, dtype=_f32)
        self.b = np.asarray(b, dtype=_f32)
        self.c = np.asarray(c, dtype=_f32)
        self.thick = _f32(thick)

    def distance(self, p):
        thick = self.thick / _f32(2)
        A = self.a
        B = self.b
        C = self.c
        a_np = B - A
        a2 = _f32(np.dot(a_np, a_np))
        b_np = A + C - 2 * B
        c_np = 2 * a_np
        kk = _f32(1.0) / _f32(np.dot(b_np, b_np))
        kx = kk * _f32(np.dot(a_np, b_np))
        kx2 = kx * kx

        a = jnp.asarray(a_np)
        bb = jnp.asarray(b_np)
        cc = jnp.asarray(c_np)

        d = jnp.asarray(A) - p  # (...,2)
        ky = kk * (2 * a2 + mx.dot(d, bb)) / _f32(3)
        kz = kk * mx.dot(d, a)
        g = ky - kx2
        q = kx * (2 * kx2 - 3 * ky) + kz
        g3 = g * g * g
        q2 = q * q
        h = q2 + 4 * g3

        # --- 1 root branch (h >= 0) ----------------------------------
        hs = jnp.sqrt(jnp.maximum(h, 0.0))
        x0 = _f32(0.5) * (-q + hs)
        x1 = _f32(0.5) * (-q - hs)
        # cancellation-safe quadratic-Taylor variant when |g| small
        k_safe = (1.0 - g3 / q2) * g3 / q
        small = jnp.abs(g) < 0.001
        x0 = jnp.where(small, k_safe, x0)
        x1 = jnp.where(small, -k_safe - q, x1)
        uv0 = mx.sign(x0) * jnp.cbrt(jnp.abs(x0))
        uv1 = mx.sign(x1) * jnp.cbrt(jnp.abs(x1))
        t = uv0 + uv1
        # single newton iteration for cancellation (NinjaKoala)
        t = t - (t * (t * t + 3.0 * g) + q) / (3.0 * t * t + 3.0 * g)
        t = mx.clamp(t - kx, 0.0, 1.0)
        w = d + t[..., None] * (cc + t[..., None] * bb)
        res1 = jnp.sum(w * w, axis=-1)

        # --- 3 roots branch (h < 0) ----------------------------------
        z = jnp.sqrt(jnp.maximum(-g, 0.0))
        mm = mx.cos_acos_3(q / (2 * g * z))
        nn = jnp.sqrt(jnp.maximum(1 - mm * mm, 0.0)) * _f32(mx.SQRT3)
        tx = mx.clamp((mm + mm) * z - kx, 0.0, 1.0)
        ty = mx.clamp((-nn - mm) * z - kx, 0.0, 1.0)
        qx = d + tx[..., None] * (cc + tx[..., None] * bb)
        qy = d + ty[..., None] * (cc + ty[..., None] * bb)
        dx = jnp.sum(qx * qx, axis=-1)
        dy = jnp.sum(qy * qy, axis=-1)
        res3 = jnp.minimum(dx, dy)

        res = jnp.where(h >= 0, res1, res3)
        return jnp.sqrt(res) - thick

    def bounds(self) -> Box:
        # reference primitives2d.go:648-673 (https://iquilezles.org/articles/bezierbbox)
        p0, p1, p2 = self.a, self.b, self.c
        lo = np.minimum(p0, p2)
        hi = np.maximum(p0, p2)
        if np.any(p1 < lo) or np.any(p1 > hi):
            denom = p0 + p2 - 2 * p1
            with np.errstate(divide="ignore", invalid="ignore"):
                t = np.clip((p0 - p1) / denom, 0.0, 1.0)
            t = np.nan_to_num(t, nan=0.0)
            s = 1.0 - t
            qv = s * s * p0 + 2 * s * t * p1 + t * t * p2
            lo = np.minimum(lo, qv)
            hi = np.maximum(hi, qv)
        th = self.thick / 2
        return Box((lo - th).astype(_f32), (hi + th).astype(_f32))


class BuilderPrimitives2:
    """2D primitive constructors with reference validation rules."""

    def new_circle(self, radius) -> Shader2D:
        if not (radius > 0 and not math.isinf(radius)):
            self.shape_error(f"bad circle radius: {radius:g}")
        return Circle(radius)

    def new_line2d(self, x0, y0, x1, y1, width) -> Shader2D:
        vals = (x0, y0, x1, y1, width)
        if any(math.isnan(v) for v in vals):
            self.shape_error("NaN argument to new_line2d")
        elif width < 0:
            self.shape_error("negative thickness to new_line2d")
        a = np.array([x0, y0], _f32)
        b = np.array([x1, y1], _f32)
        line_len = float(np.linalg.norm(a - b))
        if line_len < width * 1e-6 or line_len < mx.EPSTOL:
            if width == 0:
                self.shape_error("infimal line")
            return self.new_circle(width / 2)
        return Line2D(a, b, width)

    def new_lines2d(self, segments, width) -> Shader2D:
        segments = np.asarray(segments, dtype=_f32).reshape(-1, 2, 2)
        if width < 0:
            self.shape_error("negative thickness to new_lines2d")
        if len(segments) < 2:
            self.shape_error("empty or single points")
        for seg in segments[:-1]:
            if np.array_equal(seg[0], seg[1]):
                self.shape_error("superimposed points in new_lines2d")
        return Lines2D(segments, width)

    def new_arc(self, radius, arc_angle, thick) -> Shader2D:
        if not (radius > 0 and arc_angle > 0 and thick >= 0):
            self.shape_error("invalid argument to new_arc")
        if arc_angle > 2 * math.pi:
            self.shape_error("arc angle exceeds full circle")
        elif 2 * math.pi - arc_angle < mx.EPSTOL:
            arc_angle = 2 * math.pi - 1e-7
        return Arc2D(radius, arc_angle, thick)

    def new_equilateral_triangle(self, triangle_height) -> Shader2D:
        if not (triangle_height > 0 and not math.isinf(triangle_height)):
            self.shape_error("bad equilateral triangle height")
        return EquilateralTriangle(triangle_height)

    def new_rectangle(self, x, y) -> Shader2D:
        if not (x > 0 and y > 0 and not math.isinf(x) and not math.isinf(y)):
            self.shape_error("bad rectangle dimension")
        return Rectangle((x, y))

    def new_hexagon(self, side) -> Shader2D:
        if not (side > 0 and not math.isinf(side)):
            self.shape_error("bad hexagon dimension")
        return Hexagon2D(side)

    def new_octagon(self, constrain) -> Shader2D:
        if not constrain > 0:
            self.shape_error("bad octagon dimension %f", constrain)
        return Octagon2D(constrain)

    def new_ellipse(self, a, b) -> Shader2D:
        if not (a > 0 and b > 0 and not math.isinf(a) and not math.isinf(b)):
            self.shape_error(f"bad ellipse dimension (a={a}, b={b})")
        return Ellipse2D(a, b)

    def new_polygon(self, vertices) -> Shader2D:
        vertices = np.asarray(vertices, dtype=_f32).reshape(-1, 2)
        vertices = self._validate_polygon(vertices)
        return Polygon2D(vertices)

    def _validate_polygon(self, vertices: np.ndarray) -> np.ndarray:
        # reference primitives2d.go:471-490
        if len(vertices) and np.array_equal(vertices[0], vertices[-1]):
            vertices = vertices[:-1]
        if len(vertices) < 3:
            self.shape_error("polygon needs at least 3 distinct vertices")
            return vertices
        if np.any(np.isnan(vertices)):
            self.shape_error("NaN value in vertices")
        prev = len(vertices) - 1
        for i in range(len(vertices)):
            if np.array_equal(vertices[i], vertices[prev]):
                self.shape_error("found two consecutive equal vertices in polygon")
            prev = i
        return vertices

    def new_diamond2d(self, x_width, y_height) -> Shader2D:
        ok = (
            x_width > 0
            and y_height > 0
            and not math.isinf(x_width)
            and not math.isinf(y_height)
        )
        if not ok:
            self.shape_error("bad diamond dimension")
        return Diamond2D((x_width, y_height))

    def new_rounded_x(self, width, thick) -> Shader2D:
        ok = width > 0 and thick > 0 and not math.isinf(width) and not math.isinf(thick)
        if not ok:
            self.shape_error("bad x dimension")
        return RoundedX2D(width, thick)

    def new_quadratic_bezier2d(self, a, b, c, thick) -> Shader2D:
        return QuadraticBezier2D(a, b, c, thick)
