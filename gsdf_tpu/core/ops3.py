"""3D CSG operations.

Numerical semantics transcribed from the reference oracle
(cpu_evaluators.go:124-549,1042-1092,1257-1274; constructors/bounds
operations.go:14-891). Each op composes child `distance` calls inside one
jnp trace — XLA fuses the whole tree (the reference needed explicit scratch
VecPool buffers per op; the compiler's buffer allocator replaces that).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from ..geometry.boxes import Box, mul_box3, rotation_mat2, rotation_mat4
from . import mathx as mx
from .node import Shader3D

_f32 = np.float32


def _round_half_away(x):
    """Round half away from zero, matching Go math32.Round / ms3.RoundElem
    (used in cpu_evaluators.go:376). jnp.round is half-to-even, so roll our own."""
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


class OpUnion(Shader3D):
    """n-ary exact union (cpu_evaluators.go:124, operations.go:27).

    Trace-size optimization: children that are Translate nodes of the SAME
    subtree (e.g. 130 displaced hole cylinders) are evaluated through one
    `lax.scan` over their offsets — the subtree is traced once instead of
    once per instance, keeping compile time and program size O(1) in the
    instance count. float32 min is exact/associative, so results are
    bit-identical to the sequential reduction.
    """

    CHILDREN = ()  # dynamic; see children()

    #: minimum identical-translate group size for the scan rewrite
    SCAN_THRESHOLD = 4

    def __init__(self, joined):
        if len(joined) < 2:
            raise ValueError("OpUnion must have at least 2 elements")
        self.joined = tuple(joined)

    def children(self):
        return self.joined

    def distance(self, p):
        import jax

        from ..eval import parametric as par

        # Under parametric binding params are OPERANDS that a later
        # rebind may diverge between members, so grouping must be
        # value-blind (structural hash — also what keys the parametric
        # executable cache) and each member's subtree params must ride
        # the scan. Outside binding params are constants baked at trace
        # time, so the value-inclusive tree_hash is the correct (and
        # tighter) grouping key.
        binding = par.binding_active()
        groups: dict = {}
        ordered = []  # (kind, payload) preserving degradation to sequential
        for s in self.joined:
            if isinstance(s, Translate):
                key = (
                    par.structural_hash(s.s) if binding else s.s.tree_hash()
                )
                groups.setdefault(key, []).append(s)
            else:
                ordered.append(s)
        d = None
        for nodes in groups.values():
            if len(nodes) >= self.SCAN_THRESHOLD:
                child = nodes[0].s
                # jnp.stack: offsets may be tracers under parametric binding
                offsets = jnp.stack(
                    [jnp.asarray(n.p_, dtype=jnp.float32) for n in nodes]
                )  # (G,3)
                spec = par.param_spec(child) if binding else []
                if spec:
                    # each member's flat subtree param vector (identical
                    # layout: structures are equal) scans alongside its
                    # offset and is bound onto the shared child per step,
                    # so a post-compile rebind of ONE member is honored
                    def _flat(sub):
                        return jnp.concatenate([
                            jnp.asarray(
                                getattr(node, name), jnp.float32
                            ).reshape(-1)
                            for node, name, _ in par.param_spec(sub)
                        ])

                    xs = jnp.concatenate(
                        [offsets, jnp.stack([_flat(n.s) for n in nodes])],
                        axis=1,
                    )

                    def body(carry, row, _child=child, _spec=spec):
                        with par._bind_params(_spec, row[3:]):
                            dch = _child.distance(p - row[:3])
                        return jnp.minimum(carry, dch), None

                else:
                    xs = offsets

                    def body(carry, off, _child=child):
                        return (
                            jnp.minimum(carry, _child.distance(p - off)),
                            None,
                        )

                init = jnp.full(p.shape[:-1], mx.LARGENUM, dtype=p.dtype)
                # unroll=1: unrolling the subtree body changes XLA's fusion
                # contraction (1-ulp drift vs the sequential reduction,
                # breaking the scan==sequential bit-exact guarantee); its
                # end-to-end gain on the GPU is not measured
                dg, _ = mx.scan_fold(body, init, xs, unroll=1)
                d = dg if d is None else jnp.minimum(d, dg)
            else:
                ordered.extend(nodes)
        for s in ordered:
            ds = s.distance(p)
            d = ds if d is None else jnp.minimum(d, ds)
        return d

    def bounds(self) -> Box:
        bb = self.joined[0].bounds()
        for s in self.joined[1:]:
            bb = bb.union(s.bounds())
        return bb


class Difference(Shader3D):
    """s1 - s2 (cpu_evaluators.go:168, operations.go:117)."""

    CHILDREN = ("s1", "s2")

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        return jnp.maximum(self.s1.distance(p), -self.s2.distance(p))

    def bounds(self) -> Box:
        return self.s1.bounds()


class Intersection(Shader3D):
    """s1 ^ s2 (cpu_evaluators.go:146, operations.go:160)."""

    CHILDREN = ("s1", "s2")

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        return jnp.maximum(self.s1.distance(p), self.s2.distance(p))

    def bounds(self) -> Box:
        return self.s1.bounds().intersect(self.s2.bounds())


class Xor(Shader3D):
    """Exclusive-or (cpu_evaluators.go:190, operations.go:205)."""

    CHILDREN = ("s1", "s2")

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        a = self.s1.distance(p)
        b = self.s2.distance(p)
        return jnp.maximum(jnp.minimum(a, b), -jnp.maximum(a, b))

    def bounds(self) -> Box:
        return self.s1.bounds().union(self.s2.bounds())


class SmoothUnion(Shader3D):
    """(cpu_evaluators.go:213, operations.go:563)."""

    PARAMS = ("k",)
    CONT_PARAMS = ("k",)
    CHILDREN = ("s1", "s2")

    def __init__(self, k, s1, s2):
        self.k = _f32(k)
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        a = self.s1.distance(p)
        b = self.s2.distance(p)
        k = self.k
        h = mx.clamp(0.5 + 0.5 * (b - a) / k, 0.0, 1.0)
        return mx.mix(b, a, h) - k * h * (1 - h)

    def bounds(self) -> Box:
        return self.s1.bounds().union(self.s2.bounds())


class SmoothDifference(Shader3D):
    """(cpu_evaluators.go:238, operations.go:611)."""

    PARAMS = ("k",)
    CONT_PARAMS = ("k",)
    CHILDREN = ("s1", "s2")

    def __init__(self, k, s1, s2):
        self.k = _f32(k)
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        a = self.s1.distance(p)
        b = self.s2.distance(p)
        k = self.k
        h = mx.clamp(0.5 - 0.5 * (b + a) / k, 0.0, 1.0)
        return mx.mix(a, -b, h) + k * h * (1 - h)

    def bounds(self) -> Box:
        return self.s1.bounds()


class SmoothIntersect(Shader3D):
    """(cpu_evaluators.go:263, operations.go:643)."""

    PARAMS = ("k",)
    CONT_PARAMS = ("k",)
    CHILDREN = ("s1", "s2")

    def __init__(self, k, s1, s2):
        self.k = _f32(k)
        self.s1, self.s2 = s1, s2

    def distance(self, p):
        a = self.s1.distance(p)
        b = self.s2.distance(p)
        k = self.k
        h = mx.clamp(0.5 - 0.5 * (b - a) / k, 0.0, 1.0)
        return mx.mix(b, a, h) + k * h * (1 - h)

    def bounds(self) -> Box:
        return self.s1.bounds().intersect(self.s2.bounds())


class Scale(Shader3D):
    """Uniform scale about origin (cpu_evaluators.go:288, operations.go:248)."""

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
        return self.s.bounds().scale((self.factor,) * 3)


class Symmetry(Shader3D):
    """Mirror about cartesian planes (cpu_evaluators.go:314, operations.go:285)."""

    PARAMS = ("mx_", "my_", "mz_")
    CHILDREN = ("s",)

    def __init__(self, s, mirror_x, mirror_y, mirror_z):
        self.s = s
        self.mx_ = bool(mirror_x)
        self.my_ = bool(mirror_y)
        self.mz_ = bool(mirror_z)

    def distance(self, p):
        cols = [
            jnp.abs(p[..., i]) if m else p[..., i]
            for i, m in enumerate((self.mx_, self.my_, self.mz_))
        ]
        return self.s.distance(jnp.stack(cols, axis=-1))

    def bounds(self) -> Box:
        bb = self.s.bounds()
        lo = bb.min.copy()
        hi = bb.max.copy()
        for i, m in enumerate((self.mx_, self.my_, self.mz_)):
            if m:
                lo[i] = min(lo[i], -hi[i])
        return Box(lo, hi)


class Transform(Shader3D):
    """4x4 matrix transform (cpu_evaluators.go:488, operations.go:340)."""

    PARAMS = ("t",)
    CONT_PARAMS = ("t", "t_inv")
    CHILDREN = ("s",)

    def __init__(self, s, t: np.ndarray):
        self.s = s
        self.t = np.asarray(t, dtype=_f32).reshape(4, 4)
        self._rebind_derived()

    def _rebind_derived(self):
        """Recompute t_inv from t — also invoked by Shader.rebind so
        `rebind({node: {"t": M}})` keeps distance() (which uses only the
        inverse) consistent with bounds() (which uses t)."""
        det = float(np.linalg.det(np.asarray(self.t, np.float64)))
        if abs(det) < mx.EPSTOL:
            raise ValueError("singular Mat4")
        object.__setattr__(
            self,
            "t_inv",
            np.linalg.inv(np.asarray(self.t, np.float64)).astype(_f32),
        )

    def distance(self, p):
        # elementwise mul-adds, NOT `p @ rot.T`: an accelerator may run a
        # float32 dot at reduced precision (bfloat16 inputs on a matrix
        # unit, TF32 on a GPU's tensor cores), which moves corner signs
        # against the CPU oracle (0.4 voxels on the bolt scene at resdiv
        # 256 when this was a dot). Expanded products stay full f32, and
        # tests/test_bringup.py keeps dot_general out of the flagship
        # trees.
        rot = self.t_inv[:3, :3]
        trans = self.t_inv[:3, 3]
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        q = jnp.stack(
            [
                x * rot[0, 0] + y * rot[0, 1] + z * rot[0, 2] + trans[0],
                x * rot[1, 0] + y * rot[1, 1] + z * rot[1, 2] + trans[1],
                x * rot[2, 0] + y * rot[2, 1] + z * rot[2, 2] + trans[2],
            ],
            axis=-1,
        )
        return self.s.distance(q)

    def bounds(self) -> Box:
        return mul_box3(self.t, self.s.bounds())


class Translate(Shader3D):
    """(cpu_evaluators.go:470, operations.go:403)."""

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


class Offset(Shader3D):
    """Add sdfAdd to the SDF (cpu_evaluators.go:454, operations.go:446)."""

    PARAMS = ("off",)
    CONT_PARAMS = ("off",)
    CHILDREN = ("s",)

    def __init__(self, s, off):
        self.s = s
        self.off = _f32(off)

    def distance(self, p):
        return self.s.distance(p) + self.off

    def bounds(self) -> Box:
        bb = self.s.bounds()
        return Box(bb.min + self.off, bb.max - self.off).canon()


class Array(Shader3D):
    """Limited grid domain repetition (cpu_evaluators.go:345, operations.go:488).

    Evaluates the child at the 8 candidate neighboring tiles and min-reduces;
    the static 2x2x2 Python loop unrolls into the trace, mirroring the GLSL
    loop (operations.go:542-551)."""

    PARAMS = ("d", "nx", "ny", "nz")
    CONT_PARAMS = ("d",)
    CHILDREN = ("s",)

    def __init__(self, s, d, nx, ny, nz):
        self.s = s
        self.d = np.asarray(d, dtype=_f32)
        self.nx, self.ny, self.nz = int(nx), int(ny), int(nz)

    def distance(self, p):
        spacing = jnp.asarray(self.d)
        n = jnp.asarray(np.array([self.nx - 1, self.ny - 1, self.nz - 1], _f32))
        pid = _round_half_away(p / spacing)
        o = mx.sign(p - spacing * pid)
        d = jnp.full(p.shape[:-1], mx.LARGENUM, dtype=jnp.float32)
        for k in range(2):
            for j in range(2):
                for i in range(2):
                    ijk = jnp.asarray(np.array([i, j, k], _f32))
                    rid = pid + ijk * o
                    rid = mx.clamp(rid, 0.0, n)
                    d = jnp.minimum(d, self.s.distance(p - spacing * rid))
        return d

    def bounds(self) -> Box:
        bb = self.s.bounds()
        size = np.array([self.nx, self.ny, self.nz], _f32) * self.d
        return Box(bb.min, bb.max + size)


class Elongate(Shader3D):
    """(cpu_evaluators.go:399, operations.go:679)."""

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


class Shell(Shader3D):
    """Exterior shell (cpu_evaluators.go:428, operations.go:723)."""

    PARAMS = ("thick",)
    CONT_PARAMS = ("thick",)
    CHILDREN = ("s",)

    def __init__(self, s, thickness):
        self.s = s
        self.thick = _f32(thickness)

    def distance(self, p):
        t = self.thick
        d = self.s.distance(p * (_f32(1.0) / t))
        return t * (jnp.abs(d) - t)

    def bounds(self) -> Box:
        return self.s.bounds()


class CircularArray(Shader3D):
    """Circular domain repetition about z through origin; child evaluated
    exactly twice regardless of instance count
    (cpu_evaluators.go:1042, operations.go:764)."""

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
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        pangle = mx.atan2(y, x)
        pid = jnp.floor(pangle / angle)
        pid = jnp.where(pid < 0, pid + ncirc, pid)
        i0 = jnp.where(pid >= ninsm1, ninsm1, pid)
        i1 = jnp.where(pid >= ninsm1, 0.0, pid + 1.0)

        def rot_t(i, x, y):
            # MulMatVecTrans(RotationMat2(a), p) = rotate p by -a.
            a = angle * i
            c, s = jnp.cos(a), jnp.sin(a)
            return c * x + s * y, -s * x + c * y

        x0, y0 = rot_t(i0, x, y)
        x1, y1 = rot_t(i1, x, y)
        d0 = self.s.distance(jnp.stack([x0, y0, z], axis=-1))
        d1 = self.s.distance(jnp.stack([x1, y1, z], axis=-1))
        return jnp.minimum(d0, d1)

    def bounds(self) -> Box:
        bb = self.s.bounds()
        from ..geometry.boxes import Box as B

        bb2 = B(bb.min[:2].copy(), bb.max[:2].copy())
        verts = bb2.vertices()
        m = rotation_mat2(2 * math.pi / self.circle_div)
        for _ in range(self.n_inst - 1):
            verts = verts @ m.T
            for v in verts:
                bb2 = bb2.include_point(v)
        lo = bb.min.copy()
        hi = bb.max.copy()
        lo[:2] = bb2.min
        hi[:2] = bb2.max
        return Box(lo, hi)


class Twist(Shader3D):
    """Twist about z: XY rotated by k*z at height z
    (cpu_evaluators.go:1257, operations.go:835)."""

    PARAMS = ("k",)
    CONT_PARAMS = ("k",)
    CHILDREN = ("s",)

    def __init__(self, s, k):
        self.s = s
        self.k = _f32(k)

    def distance(self, p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        c = jnp.cos(self.k * z)
        s = jnp.sin(self.k * z)
        q = jnp.stack([c * x - s * y, s * x + c * y, z], axis=-1)
        return self.s.distance(q)

    def bounds(self) -> Box:
        bb = self.s.bounds()
        verts = bb.vertices()
        max_r = float(np.max(np.hypot(verts[:, 0], verts[:, 1])))
        return Box(
            np.array([-max_r, -max_r, bb.min[2]], _f32),
            np.array([max_r, max_r, bb.max[2]], _f32),
        )


class BuilderOps3:
    """3D operation constructors with reference validation rules."""

    def union(self, *shaders) -> Shader3D:
        if len(shaders) < 2:
            raise ValueError("need at least 2 arguments to union")
        joined = []
        for i, s in enumerate(shaders):
            if s is None:
                self.nilsdf(f"nil arg[{i}] to union")
            if isinstance(s, OpUnion):
                joined.extend(s.joined)
            else:
                joined.append(s)
        return OpUnion(joined)

    def difference(self, a, b) -> Shader3D:
        if a is None or b is None:
            self.nilsdf("difference")
        return Difference(a, b)

    def intersection(self, a, b) -> Shader3D:
        if a is None or b is None:
            self.nilsdf("intersection")
        return Intersection(a, b)

    def xor(self, s1, s2) -> Shader3D:
        if s1 is None or s2 is None:
            self.nilsdf("xor")
        return Xor(s1, s2)

    def smooth_union(self, k, s1, s2) -> Shader3D:
        if s1 is None or s2 is None:
            self.nilsdf("smooth_union")
        return SmoothUnion(k, s1, s2)

    def smooth_difference(self, k, s1, s2) -> Shader3D:
        if s1 is None or s2 is None:
            self.nilsdf("smooth_difference")
        return SmoothDifference(k, s1, s2)

    def smooth_intersect(self, k, s1, s2) -> Shader3D:
        if s1 is None or s2 is None:
            self.nilsdf("smooth_intersect")
        return SmoothIntersect(k, s1, s2)

    def scale(self, s, factor) -> Shader3D:
        return Scale(s, factor)

    def symmetry(self, s, mirror_x=False, mirror_y=False, mirror_z=False) -> Shader3D:
        if not (mirror_x or mirror_y or mirror_z):
            self.shape_error("ineffective symmetry")
        return Symmetry(s, mirror_x, mirror_y, mirror_z)

    def transform(self, s, mat4) -> Shader3D:
        try:
            return Transform(s, mat4)
        except ValueError as e:
            self.shape_error(str(e))
            return Transform(s, np.eye(4, dtype=_f32))

    def rotate(self, s, radians, axis) -> Shader3D:
        axis = np.asarray(axis, dtype=_f32)
        if not np.any(axis):
            self.shape_error("null vector")
        return self.transform(s, rotation_mat4(radians, axis))

    def translate(self, s, x, y, z) -> Shader3D:
        return Translate(s, (x, y, z))

    def offset(self, s, sdf_add) -> Shader3D:
        return Offset(s, sdf_add)

    def array(self, s, spacing_x, spacing_y, spacing_z, nx, ny, nz) -> Shader3D:
        if nx <= 0 or ny <= 0 or nz <= 0:
            self.shape_error("invalid array repeat param")
        if spacing_x <= 0 or spacing_y <= 0 or spacing_z <= 0:
            self.shape_error("invalid array spacing")
        return Array(s, (spacing_x, spacing_y, spacing_z), nx, ny, nz)

    def elongate(self, s, dir_x, dir_y, dir_z) -> Shader3D:
        return Elongate(s, (dir_x, dir_y, dir_z))

    def shell(self, s, thickness) -> Shader3D:
        return Shell(s, thickness)

    def circular_array(self, s, num_instances, circle_div) -> Shader3D:
        if s is None:
            self.nilsdf("circular_array")
        if circle_div <= 1 or num_instances <= 0:
            self.shape_error("invalid circarray repeat param")
        if num_instances > circle_div:
            self.shape_error(
                "bad circular array instances, must be less than or equal to circle_div"
            )
        return CircularArray(s, num_instances, circle_div)

    def twist(self, s, k) -> Shader3D:
        if s is None:
            self.nilsdf("twist")
        if k == 0:
            self.shape_error("zero twist parameter")
        return Twist(s, k)
