"""simplesdf — chainable immutable value API (reference gsdfaux/simplesdf).

Python-idiomatic port of the fogleman-style chainable interface: module
functions create shapes; methods return new values; `.k(r)` sets a pending
smooth-blend radius consumed by the next boolean op; transforms preserve it
(reference simplesdf.go:11-22, ops3d.go:19-89).

    from gsdf_tpu import simplesdf as sdf
    f = sdf.cylinder(1, 5, 0.1)
    f = f.diff(sdf.cylinder(0.5, 8, 0).k(0.1))
    f.save_stl("part.stl")

The module-level builder is not thread safe (like the reference's global
builder, README.md:69).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .core import Builder, Flags

_bld = Builder()
_panic_mode = True


def set_panic_mode(enabled: bool) -> None:
    """Invalid shape arguments raise (True, default) or accumulate
    (reference simplesdf.go:39-49)."""
    global _panic_mode
    _panic_mode = enabled
    flags = _bld.flags
    if enabled:
        flags &= ~Flags.NO_DIMENSION_PANIC
    else:
        flags |= Flags.NO_DIMENSION_PANIC
    _bld.set_flags(flags)


def err() -> Optional[Exception]:
    return _bld.err()


def clear_errors() -> None:
    _bld.clear_errors()


@dataclasses.dataclass(frozen=True)
class STLConfig:
    """(reference simplesdf.go:24-31)."""

    resolution: float = 0.0
    resolution_divisions: int = 1 << 9
    use_cache: bool = False
    #: True: the first GPU (raises without one); False: the host CPU;
    #: None: JAX's default device (pipeline.render_device)
    use_gpu: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class SDF3:
    """Immutable chainable 3D SDF value."""

    s: object
    _k: float = 0.0

    def shader(self):
        """The underlying Shader3D node for use with the wider API."""
        return self.s

    def k(self, k: float) -> "SDF3":
        """Set pending smooth-blend radius for the next boolean op."""
        return SDF3(self.s, k)

    # --- booleans (consume k) ----------------------------------------
    def union(self, *others: "SDF3") -> "SDF3":
        if not others:
            return self
        kmax = max([self._k] + [o._k for o in others])
        if kmax > 0:
            result = self.s
            for o in others:
                result = _bld.smooth_union(max(self._k, o._k), result, o.s)
            return SDF3(result)
        return SDF3(_bld.union(self.s, *[o.s for o in others]))

    def diff(self, b: "SDF3") -> "SDF3":
        k = max(self._k, b._k)
        if k > 0:
            return SDF3(_bld.smooth_difference(k, self.s, b.s))
        return SDF3(_bld.difference(self.s, b.s))

    def intersect(self, b: "SDF3") -> "SDF3":
        k = max(self._k, b._k)
        if k > 0:
            return SDF3(_bld.smooth_intersect(k, self.s, b.s))
        return SDF3(_bld.intersection(self.s, b.s))

    def xor(self, b: "SDF3") -> "SDF3":
        return SDF3(_bld.xor(self.s, b.s))

    # operator sugar (fogleman style): f |= g, f -= g, f &= g
    def __or__(self, b: "SDF3") -> "SDF3":
        return self.union(b)

    def __sub__(self, b: "SDF3") -> "SDF3":
        return self.diff(b)

    def __and__(self, b: "SDF3") -> "SDF3":
        return self.intersect(b)

    # --- transforms (preserve k) -------------------------------------
    def translate(self, x, y, z) -> "SDF3":
        return SDF3(_bld.translate(self.s, x, y, z), self._k)

    def scale(self, factor) -> "SDF3":
        return SDF3(_bld.scale(self.s, factor), self._k)

    def rotate(self, radians, ax, ay, az) -> "SDF3":
        return SDF3(_bld.rotate(self.s, radians, (ax, ay, az)), self._k)

    def rotate_x(self, radians) -> "SDF3":
        return self.rotate(radians, 1, 0, 0)

    def rotate_y(self, radians) -> "SDF3":
        return self.rotate(radians, 0, 1, 0)

    def rotate_z(self, radians) -> "SDF3":
        return self.rotate(radians, 0, 0, 1)

    def mirror(self, x=False, y=False, z=False) -> "SDF3":
        return SDF3(_bld.symmetry(self.s, x, y, z), self._k)

    # --- modifiers (preserve k) --------------------------------------
    def shell(self, thickness) -> "SDF3":
        return SDF3(_bld.shell(self.s, thickness), self._k)

    def offset(self, delta) -> "SDF3":
        return SDF3(_bld.offset(self.s, delta), self._k)

    def elongate(self, x, y, z) -> "SDF3":
        return SDF3(_bld.elongate(self.s, x, y, z), self._k)

    def twist(self, k) -> "SDF3":
        return SDF3(_bld.twist(self.s, k), self._k)

    def array(self, nx, ny, nz, sx, sy, sz) -> "SDF3":
        return SDF3(_bld.array(self.s, sx, sy, sz, nx, ny, nz), self._k)

    def circ_array(self, count, circle_div) -> "SDF3":
        return SDF3(_bld.circular_array(self.s, count, circle_div), self._k)

    # --- output ------------------------------------------------------
    def save_stl(self, filename: str, cfg: STLConfig = STLConfig()) -> dict:
        from .pipeline import RenderConfig, render_shader3d

        res = cfg.resolution
        if res == 0:
            divs = cfg.resolution_divisions or 1 << 9
            res = self.s.bounds().diagonal() / divs
        with open(filename, "wb") as f:
            return render_shader3d(
                self.s,
                RenderConfig(
                    stl_output=f,
                    resolution=res,
                    use_gpu=cfg.use_gpu,
                    enable_caching=cfg.use_cache,
                    silent=True,
                ),
            )

    def _render_indexed(self, cfg: STLConfig):
        from .render.flat import FlatRenderer

        res = cfg.resolution
        if res == 0:
            divs = cfg.resolution_divisions or 1 << 9
            res = self.s.bounds().diagonal() / divs
        # honor use_gpu exactly like save_stl's render_shader3d branch
        from .pipeline.render import render_device

        return FlatRenderer(
            self.s, res, device=render_device(cfg.use_gpu)
        ).render_compact()

    def save_obj(self, filename: str, cfg: STLConfig = STLConfig()) -> int:
        """Save a welded OBJ mesh (indexed; no crack-welding pass needed —
        the compact render is already indexed). Returns triangle count."""
        from .render.mesh_export import write_obj_indexed_file

        verts, tri_idx = self._render_indexed(cfg)
        write_obj_indexed_file(filename, verts, tri_idx)
        return len(tri_idx)

    def save_ply(self, filename: str, cfg: STLConfig = STLConfig()) -> int:
        """Save a welded binary PLY mesh. Returns triangle count."""
        from .render.mesh_export import write_ply_indexed_file

        verts, tri_idx = self._render_indexed(cfg)
        write_ply_indexed_file(filename, verts, tri_idx)
        return len(tri_idx)


@dataclasses.dataclass(frozen=True)
class SDF2:
    """Immutable chainable 2D SDF value."""

    s: object
    _k: float = 0.0

    def shader(self):
        return self.s

    def k(self, k: float) -> "SDF2":
        return SDF2(self.s, k)

    def union(self, *others: "SDF2") -> "SDF2":
        if not others:
            return self
        return SDF2(_bld.union2d(self.s, *[o.s for o in others]))

    def diff(self, b: "SDF2") -> "SDF2":
        return SDF2(_bld.difference2d(self.s, b.s))

    def intersect(self, b: "SDF2") -> "SDF2":
        return SDF2(_bld.intersection2d(self.s, b.s))

    def xor(self, b: "SDF2") -> "SDF2":
        return SDF2(_bld.xor2d(self.s, b.s))

    def __or__(self, b: "SDF2") -> "SDF2":
        return self.union(b)

    def __sub__(self, b: "SDF2") -> "SDF2":
        return self.diff(b)

    def __and__(self, b: "SDF2") -> "SDF2":
        return self.intersect(b)

    def translate(self, x, y) -> "SDF2":
        return SDF2(_bld.translate2d(self.s, x, y), self._k)

    def scale(self, factor) -> "SDF2":
        return SDF2(_bld.scale2d(self.s, factor), self._k)

    def rotate(self, radians) -> "SDF2":
        return SDF2(_bld.rotate2d(self.s, radians), self._k)

    def mirror(self, x=False, y=False) -> "SDF2":
        return SDF2(_bld.symmetry2d(self.s, x, y), self._k)

    def offset(self, delta) -> "SDF2":
        return SDF2(_bld.offset2d(self.s, delta), self._k)

    def elongate(self, x, y) -> "SDF2":
        return SDF2(_bld.elongate2d(self.s, x, y), self._k)

    def array(self, nx, ny, sx, sy) -> "SDF2":
        return SDF2(_bld.array2d(self.s, sx, sy, nx, ny), self._k)

    def circ_array(self, count, circle_div) -> "SDF2":
        return SDF2(_bld.circular_array2d(self.s, count, circle_div), self._k)

    def extrude(self, h) -> SDF3:
        return SDF3(_bld.extrude(self.s, h))

    def revolve(self, offset=0.0) -> SDF3:
        return SDF3(_bld.revolve(self.s, offset))

    def save_png(self, filename: str, width=512, height=512):
        from .pipeline import render_png_file_2d

        return render_png_file_2d(filename, self.s, width, height)


# --- primitive constructors ------------------------------------------

def sphere(r) -> SDF3:
    return SDF3(_bld.new_sphere(r))


def box(x, y, z, round=0.0) -> SDF3:
    return SDF3(_bld.new_box(x, y, z, round))


def cylinder(r, h, round=0.0) -> SDF3:
    return SDF3(_bld.new_cylinder(r, h, round))


def torus(major, minor) -> SDF3:
    return SDF3(_bld.new_torus(major, minor))


def hex_prism(face2face, h) -> SDF3:
    return SDF3(_bld.new_hexagonal_prism(face2face, h))


def tri_prism(tri_height, extrude_len) -> SDF3:
    return SDF3(_bld.new_triangular_prism(tri_height, extrude_len))


def box_frame(x, y, z, edge_thickness) -> SDF3:
    return SDF3(_bld.new_box_frame(x, y, z, edge_thickness))


def circle(r) -> SDF2:
    return SDF2(_bld.new_circle(r))


def rect(x, y) -> SDF2:
    return SDF2(_bld.new_rectangle(x, y))


def hexagon(side) -> SDF2:
    return SDF2(_bld.new_hexagon(side))


def ellipse(a, b) -> SDF2:
    return SDF2(_bld.new_ellipse(a, b))


def arc(radius, arc_angle, thickness) -> SDF2:
    return SDF2(_bld.new_arc(radius, arc_angle, thickness))


def polygon(points) -> SDF2:
    return SDF2(_bld.new_polygon(points))
