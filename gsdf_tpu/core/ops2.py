"""2D operations and the 2D->3D bridges (Extrude/Revolve).

Numerical semantics transcribed from the reference oracle
(cpu_evaluators.go:506-549,821-1255; constructors/bounds operations2d.go).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..geometry.boxes import Box, rotation_mat2
from . import mathx as mx
from .node import Shader2D, Shader3D
from .ops3 import _round_half_away

_f32 = np.float32


class OpUnion2D(Shader2D):
    """(cpu_evaluators.go:821, operations2d.go:15)."""

    def __init__(self, joined):
        if len(joined) < 2:
            raise ValueError("OpUnion2D must have at least 2 elements")
        self.joined = tuple(joined)

    def children(self):
        return self.joined

    def distance(self, p):
        d = self.joined[0].distance(p)
        for s in self.joined[1:]:
            d = jnp.minimum(d, s.distance(p))
        return d

    def bounds(self) -> Box:
        bb = self.joined[0].bounds()
        for s in self.joined[1:]:
            bb = bb.union(s.bounds())
        return bb


class Difference2D(Shader2D):
    CHILDREN = ("s1", "s2")

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        return jnp.maximum(self.s1.distance(p), -self.s2.distance(p))

    def bounds(self) -> Box:
        return self.s1.bounds()


class Intersection2D(Shader2D):
    CHILDREN = ("s1", "s2")

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        return jnp.maximum(self.s1.distance(p), self.s2.distance(p))

    def bounds(self) -> Box:
        return self.s1.bounds().intersect(self.s2.bounds())


class Xor2D(Shader2D):
    CHILDREN = ("s1", "s2")

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        a = self.s1.distance(p)
        b = self.s2.distance(p)
        return jnp.maximum(jnp.minimum(a, b), -jnp.maximum(a, b))

    def bounds(self) -> Box:
        return self.s1.bounds().union(self.s2.bounds())


class Extrusion(Shader3D):
    """2D -> 3D extrusion along z (cpu_evaluators.go:506, operations2d.go:104)."""

    PARAMS = ("h",)
    CONT_PARAMS = ("h",)
    CHILDREN = ("s",)

    def __init__(self, s: Shader2D, h):
        self.s = s
        self.h = _f32(h)

    def distance(self, p):
        d = self.s.distance(p[..., :2])
        h = self.h / _f32(2)
        wy = jnp.abs(p[..., 2]) - h
        return jnp.minimum(0.0, jnp.maximum(d, wy)) + mx.hypot(
            jnp.maximum(d, 0.0), jnp.maximum(wy, 0.0)
        )

    def bounds(self) -> Box:
        b2 = self.s.bounds()
        hd2 = self.h / 2
        return Box(
            np.array([b2.min[0], b2.min[1], -hd2], _f32),
            np.array([b2.max[0], b2.max[1], hd2], _f32),
        )


class Revolution(Shader3D):
    """Revolve 2D shape about y axis (cpu_evaluators.go:533, operations2d.go:153)."""

    PARAMS = ("off",)
    CONT_PARAMS = ("off",)
    CHILDREN = ("s",)

    def __init__(self, s: Shader2D, off):
        self.s = s
        self.off = _f32(off)

    def distance(self, p):
        qx = mx.hypot(p[..., 0], p[..., 2]) - self.off
        q = jnp.stack([qx, p[..., 1]], axis=-1)
        return self.s.distance(q)

    def bounds(self) -> Box:
        b2 = self.s.bounds()
        radius = max(0.0, float(b2.max[0]) - float(self.off))
        return Box(
            np.array([-radius, b2.min[1], -radius], _f32),
            np.array([radius, b2.max[1], radius], _f32),
        )


class Array2D(Shader2D):
    """Limited 2D grid repetition (cpu_evaluators.go:914, operations2d.go:332)."""

    PARAMS = ("d", "nx", "ny")
    CONT_PARAMS = ("d",)
    CHILDREN = ("s",)

    def __init__(self, s, d, nx, ny):
        self.s = s
        self.d = np.asarray(d, dtype=_f32)
        self.nx, self.ny = int(nx), int(ny)

    def distance(self, p):
        spacing = jnp.asarray(self.d)
        n = jnp.asarray(np.array([self.nx - 1, self.ny - 1], _f32))
        pid = _round_half_away(p / spacing)
        o = mx.sign(p - spacing * pid)
        dist = jnp.full(p.shape[:-1], mx.LARGENUM, dtype=jnp.float32)
        for j in range(2):
            for i in range(2):
                ij = jnp.asarray(np.array([i, j], _f32))
                rid = mx.clamp(pid + ij * o, 0.0, n)
                dist = jnp.minimum(dist, self.s.distance(p - spacing * rid))
        return dist

    def bounds(self) -> Box:
        bb = self.s.bounds()
        size = np.array([self.nx, self.ny], _f32) * self.d
        return Box(bb.min, bb.max + size)


class Offset2D(Shader2D):
    PARAMS = ("f",)
    CONT_PARAMS = ("f",)
    CHILDREN = ("s",)

    def __init__(self, s, f):
        self.s = s
        self.f = _f32(f)

    def distance(self, p):
        return self.s.distance(p) + self.f

    def bounds(self) -> Box:
        # reference operations2d.go:421-430 (incl. its positive-offset quirk)
        bb = self.s.bounds()
        if self.f > 0:
            return bb
        return Box(bb.min + self.f, bb.max - self.f)


class Translate2D(Shader2D):
    PARAMS = ("p_",)
    CONT_PARAMS = ("p_",)
    CHILDREN = ("s",)

    def __init__(self, s, v):
        self.s = s
        self.p_ = np.asarray(v, dtype=_f32)

    def distance(self, p):
        return self.s.distance(p - jnp.asarray(self.p_))

    def bounds(self) -> Box:
        return self.s.bounds().add(self.p_)


class Rotation2D(Shader2D):
    """(cpu_evaluators.go:1186, operations2d.go:495)."""

    PARAMS = ("t",)
    CONT_PARAMS = ("t", "t_inv")
    CHILDREN = ("s",)

    def __init__(self, s, theta):
        self.s = s
        self.t = rotation_mat2(theta)
        self._rebind_derived()

    def _rebind_derived(self):
        """Recompute t_inv from t (invoked by Shader.rebind — see
        ops3.Transform._rebind_derived)."""
        object.__setattr__(
            self,
            "t_inv",
            np.linalg.inv(np.asarray(self.t, np.float64)).astype(_f32),
        )

    def distance(self, p):
        # elementwise mul-adds, not `p @ rot.T` — see
        # ops3.Transform.distance: a float32 dot may run at reduced
        # precision on an accelerator; expanded products stay f32
        rot = self.t_inv
        x, y = p[..., 0], p[..., 1]
        return self.s.distance(
            jnp.stack(
                [
                    x * rot[0, 0] + y * rot[0, 1],
                    x * rot[1, 0] + y * rot[1, 1],
                ],
                axis=-1,
            )
        )

    def bounds(self) -> Box:
        bb = self.s.bounds()
        verts = bb.vertices() @ self.t.T
        return Box(verts.min(axis=0).astype(_f32), verts.max(axis=0).astype(_f32))


class Symmetry2D(Shader2D):
    PARAMS = ("mx_", "my_")
    CHILDREN = ("s",)

    def __init__(self, s, mirror_x, mirror_y):
        self.s = s
        self.mx_ = bool(mirror_x)
        self.my_ = bool(mirror_y)

    def distance(self, p):
        cols = [
            jnp.abs(p[..., i]) if m else p[..., i]
            for i, m in enumerate((self.mx_, self.my_))
        ]
        return self.s.distance(jnp.stack(cols, axis=-1))

    def bounds(self) -> Box:
        bb = self.s.bounds()
        lo = bb.min.copy()
        hi = bb.max.copy()
        for i, m in enumerate((self.mx_, self.my_)):
            if m:
                lo[i] = min(lo[i], -hi[i])
        return Box(lo, hi)


class Annulus2D(Shader2D):
    """2D shell (cpu_evaluators.go:1026, operations2d.go:606)."""

    PARAMS = ("r",)
    CONT_PARAMS = ("r",)
    CHILDREN = ("s",)

    def __init__(self, s, r):
        self.s = s
        self.r = _f32(r)

    def distance(self, p):
        return jnp.abs(self.s.distance(p)) - self.r

    def bounds(self) -> Box:
        return self.s.bounds().pad(self.r)


class CircularArray2D(Shader2D):
    """(cpu_evaluators.go:1094, operations2d.go:655)."""

    PARAMS = ("n_inst", "circle_div")
    CHILDREN = ("s",)

    def __init__(self, s, num_instances, circle_div):
        self.s = s
        self.n_inst = int(num_instances)
        self.circle_div = int(circle_div)

    def distance(self, p):
        angle = _f32(2 * math.pi / self.circle_div)
        ncirc = _f32(self.circle_div)
        ninsm1 = _f32(self.n_inst - 1)
        x, y = p[..., 0], p[..., 1]
        pangle = mx.atan2(y, x)
        pid = jnp.floor(pangle / angle)
        pid = jnp.where(pid < 0, pid + ncirc, pid)
        i0 = jnp.where(pid >= ninsm1, ninsm1, pid)
        i1 = jnp.where(pid >= ninsm1, 0.0, pid + 1.0)

        def rot_t(i, x, y):
            a = angle * i
            c, s = jnp.cos(a), jnp.sin(a)
            return c * x + s * y, -s * x + c * y

        x0, y0 = rot_t(i0, x, y)
        x1, y1 = rot_t(i1, x, y)
        d0 = self.s.distance(jnp.stack([x0, y0], axis=-1))
        d1 = self.s.distance(jnp.stack([x1, y1], axis=-1))
        return jnp.minimum(d0, d1)

    def bounds(self) -> Box:
        bb = self.s.bounds()
        verts = bb.vertices()
        m = rotation_mat2(2 * math.pi / self.circle_div)
        for _ in range(self.n_inst - 1):
            verts = verts @ m.T
            for v in verts:
                bb = bb.include_point(v)
        return bb


class Scale2D(Shader2D):
    PARAMS = ("factor",)
    CONT_PARAMS = ("factor",)
    CHILDREN = ("s",)

    def __init__(self, s, factor):
        self.s = s
        self.factor = _f32(factor)

    def distance(self, p):
        inv = _f32(1.0) / self.factor
        return self.s.distance(p * inv) * self.factor

    def bounds(self) -> Box:
        return self.s.bounds().scale((self.factor,) * 2)


class TranslateMulti2D(Shader2D):
    """N displaced instances, min-reduced (cpu_evaluators.go:1162,
    operations2d.go:756). The displacement list is a static Python loop —
    each instance contributes one fused child evaluation, matching the
    reference's per-displacement evaluation loop."""

    PARAMS = ("displacements",)
    CHILDREN = ("s",)

    def __init__(self, s, displacements):
        self.s = s
        self.displacements = np.asarray(displacements, dtype=_f32).reshape(-1, 2)

    def distance(self, p):
        d = jnp.full(p.shape[:-1], np.finfo(np.float32).max, dtype=jnp.float32)
        for disp in self.displacements:
            d = jnp.minimum(d, self.s.distance(p - jnp.asarray(disp)))
        return d

    def bounds(self) -> Box:
        bb = Box.empty(2)
        elem = self.s.bounds()
        for disp in self.displacements:
            bb = bb.union(elem.add(disp))
        return bb


class Elongate2D(Shader2D):
    PARAMS = ("h",)
    CONT_PARAMS = ("h",)
    CHILDREN = ("s",)

    def __init__(self, s, h):
        self.s = s
        self.h = np.asarray(h, dtype=_f32)

    def distance(self, p):
        h = jnp.asarray(self.h * _f32(0.5))
        q = jnp.abs(p) - h
        w = jnp.minimum(jnp.max(q, axis=-1), 0.0)
        return self.s.distance(jnp.maximum(q, 0.0)) + w

    def bounds(self) -> Box:
        bb = self.s.bounds()
        hi = np.maximum(bb.max, 0).astype(_f32) + self.h * _f32(0.5)
        return Box(-hi, hi)


class BuilderOps2:
    """2D operation constructors with reference validation rules."""

    def union2d(self, *shaders) -> Shader2D:
        if len(shaders) < 2:
            raise ValueError("need at least 2 arguments to union2d")
        joined = []
        for i, s in enumerate(shaders):
            if s is None:
                raise ValueError(f"nil {i} argument to union2d")
            if isinstance(s, OpUnion2D):
                joined.extend(s.joined)
            else:
                joined.append(s)
        return OpUnion2D(joined)

    def extrude(self, s, h) -> Shader3D:
        if s is None:
            self.nilsdf("extrude")
        if h < 0:
            self.shape_error("bad extrusion length")
        return Extrusion(s, h)

    def revolve(self, s, axis_offset=0.0) -> Shader3D:
        if s is None:
            self.shape_error("nil argument to revolve")
        if axis_offset < 0:
            self.shape_error("negative axis offset")
        return Revolution(s, axis_offset)

    def difference2d(self, a, b) -> Shader2D:
        if a is None or b is None:
            self.nilsdf("difference2d")
        return Difference2D(a, b)

    def intersection2d(self, a, b) -> Shader2D:
        if a is None or b is None:
            self.nilsdf("intersection2d")
        return Intersection2D(a, b)

    def xor2d(self, s1, s2) -> Shader2D:
        if s1 is None or s2 is None:
            self.nilsdf("xor2d")
        return Xor2D(s1, s2)

    def array2d(self, s, spacing_x, spacing_y, nx, ny) -> Shader2D:
        if nx <= 0 or ny <= 0:
            self.shape_error("invalid array repeat param")
        ok = (
            spacing_x > 0
            and spacing_y > 0
            and not math.isinf(spacing_x)
            and not math.isinf(spacing_y)
        )
        if not ok:
            self.shape_error("bad array spacing")
        return Array2D(s, (spacing_x, spacing_y), nx, ny)

    def offset2d(self, s, sdf_add) -> Shader2D:
        return Offset2D(s, sdf_add)

    def translate2d(self, s, dir_x, dir_y) -> Shader2D:
        return Translate2D(s, (dir_x, dir_y))

    def rotate2d(self, s, theta) -> Shader2D:
        m = rotation_mat2(theta)
        if abs(float(np.linalg.det(m.astype(np.float64)))) < mx.EPSTOL:
            self.shape_error("badly conditioned rotation")
        return Rotation2D(s, theta)

    def symmetry2d(self, s, mirror_x=False, mirror_y=False) -> Shader2D:
        if not (mirror_x or mirror_y):
            self.shape_error("ineffective symmetry")
        return Symmetry2D(s, mirror_x, mirror_y)

    def annulus(self, s, sub) -> Shader2D:
        if s is None:
            self.nilsdf("annulus")
        if sub <= 0:
            self.shape_error("invalid annular parameter")
        return Annulus2D(s, sub)

    def circular_array2d(self, s, num_instances, circle_div) -> Shader2D:
        if s is None:
            self.nilsdf("circular_array2d")
        if circle_div <= 1 or num_instances <= 0:
            self.shape_error("invalid circarray repeat param")
        if num_instances > circle_div:
            self.shape_error(
                "bad circular array instances, must be less than or equal to circle_div"
            )
        return CircularArray2D(s, num_instances, circle_div)

    def scale2d(self, s, factor) -> Shader2D:
        return Scale2D(s, factor)

    def translate_multi2d(self, s, displacements) -> Shader2D:
        if s is None:
            self.nilsdf("translate_multi2d")
        return TranslateMulti2D(s, displacements)

    def elongate2d(self, s, dir_x, dir_y) -> Shader2D:
        return Elongate2D(s, (dir_x, dir_y))
