"""Flagship demo scenes, packaged so the bench/breadth CLIs and the
examples share ONE construction of each golden part.

These are the four parts whose exact triangle counts gate the benchmark
and regression suites:

- NPT flange          (reference examples/npt-flange/flange.go:23-58)
- fibonacci showerhead (reference examples/fibonacci-showerhead/main.go:30-88)
- ISO M3 bolt          (reference examples/bolt/main.go:27-40)
- knurled cylinder     (reference examples/knurled-cylinder/knurled-cyl.go:57-110)

The `examples/` scripts are thin CLI wrappers over these builders; the
scene math lives here exactly once so a golden count can never drift
between the example, the bench and the tests.
"""
from __future__ import annotations

import math

from .core import Builder

# Exact golden triangle counts for the production compact path
# (reference golden-count discipline: glrender/glrender_test.go:83-102;
# flange/showerhead counts match reference README.md:116,152 pipelines).
# Bolt/knurled counts have no reference number: they are the counts of
# the corner grid evaluated in FLOAT64 at the f32 pipeline's own corner
# positions (pinned in tests/test_bringup.py; the flange/showerhead
# counts equal theirs too). The f32 GPU render gives all four.
GOLDEN_FLANGE_TRIS = 423852  # resdiv 400
GOLDEN_SHOWERHEAD_TRIS = 309872  # resdiv 350
GOLDEN_BOLT_TRIS = 137536  # resdiv 300 (float64 count)
GOLDEN_KNURLED_TRIS = 616324  # resdiv 350 (float64 count)
# The CPU backend's f32 render of the bolt at resdiv 300 departs from the
# float64 count by one corner: it lies 5.1e-9 inside the thread flank, and
# XLA:CPU's fused executable rounds it to +2.4e-7 (the GPU, and the CPU run
# one equation at a time, keep it negative). Pinned so that a change of
# the CPU's rounding shows; examples/sign_diagnosis.py finds such corners.
CPU_F32_BOLT_TRIS = 137528
# scale gates: the flange at resdiv 1000 (102M cubes) through the compact
# path, and the bolt at resdiv 256 through the dual-contour renderer
GOLDEN_FLANGE_1000_TRIS = 2660772
GOLDEN_DC_BOLT_256_TRIS = 99844

def flange_scene(bld: Builder):
    """Threaded NPT pipe fitting with base plate — the reference's README
    benchmark part (reference examples/npt-flange/flange.go:23-58)."""
    from .forge import threads

    tlen = 18.0 / 25.4
    internal_diameter = 1.5 / 2.0
    flange_h = 7.0 / 25.4
    flange_d = 60.0 / 25.4

    npt = threads.NPT()
    npt.set_from_nominal(1.0 / 2.0)

    pipe = threads.nut(bld, threads.NutParams(thread=npt, style=threads.NutStyle.CIRCULAR))

    # Base plate which goes bolted to joint.
    flange = bld.new_cylinder(flange_d / 2, flange_h, flange_h / 8)
    # Join threaded section with flange.
    flange = bld.translate(flange, 0, 0, -tlen / 2)
    union = bld.smooth_union(0.2, pipe, flange)
    # Make through-hole in flange bottom.
    hole = bld.new_cylinder(internal_diameter / 2, 4 * flange_h, 0)
    union = bld.difference(union, hole)
    # Convert from imperial inches to millimeters.
    return bld.scale(union, 25.4)


def fibonacci(n: int):
    """Fibonacci-spiral point placement (reference
    examples/fibonacci-showerhead/main.go:90-96)."""
    angle_of_divergence = 137.3
    spacing = 2.6
    a = n * angle_of_divergence / 360 * math.pi
    r = spacing * math.sqrt(n)
    return r * math.cos(a), r * math.sin(a)


def showerhead_scene(bld: Builder, thread_png=None):
    """Showerhead with plastic buttress thread, knurled grip and 130
    fibonacci-spaced holes (reference
    examples/fibonacci-showerhead/main.go:30-88)."""
    from .forge import threads

    thread_ext_diameter = 65.0
    threaded_length = 5.0
    thread_turns = 3.0
    thread_pitch = threaded_length / thread_turns

    showerhead_base_thick = 2.5
    showerhead_wall = 4.0
    thread_height = 5.0

    shower_thread = threads.PlasticButtress(d=thread_ext_diameter, p=thread_pitch)
    if thread_png:
        from .pipeline import render_png_file_2d

        t2d = shower_thread.thread(bld)
        render_png_file_2d(thread_png, t2d, 512, 512)

    knurled = threads.knurled_head(
        bld, thread_ext_diameter / 2 + showerhead_wall, thread_height, 1
    )
    screw = threads.screw(bld, thread_height + 0.5, shower_thread)
    obj = bld.difference(knurled, screw)

    base = bld.new_cylinder(
        thread_ext_diameter / 2 + showerhead_wall, showerhead_base_thick, 0
    )
    base = bld.translate(
        base, 0, 0, -(threaded_length / 2 + showerhead_base_thick / 2 - 1)
    )

    hole = bld.new_cylinder(0.8, showerhead_base_thick * 10, 0)
    holes = hole
    for i in range(130):
        x, y = fibonacci(i)
        holes = bld.union(holes, bld.translate(hole, x, y, 0))
    base = bld.difference(base, holes)

    return bld.union(obj, base)


def bolt_scene(bld: Builder):
    """M3 ISO bolt with hex head (reference examples/bolt/main.go:27-40)."""
    from .forge import threads

    L, shank = 8, 3
    threader = threads.ISO(d=3, p=0.5, ext=True)
    m3 = threads.bolt(
        bld,
        threads.BoltParams(
            thread=threader,
            style=threads.NutStyle.HEX,
            total_length=L + shank,
            shank_length=shank,
        ),
    )
    return bld.rotate(m3, 2.5 * math.pi / 2, (1, 0, 0.1))


def knurled_scene(bld: Builder, diameter=20.0, hole_diam=0.0, length=0.0,
                  knurl_size=0.0):
    """Knurled cylinder with twisted diamond pattern and vent holes
    (reference examples/knurled-cylinder/knurled-cyl.go:57-110; itself a
    port of fogleman's sdf python knurling example)."""
    r = diameter / 2
    length = length or 5 * r
    hole_diam = hole_diam or r
    knurl_side = knurl_size or r

    smooth_ratio = 0.1
    twist_k = 0.75
    knurl_offset_r = 1.6
    knurl_n = 24

    sk = smooth_ratio * r

    obj = bld.new_cylinder(r, length, smooth_ratio * r)

    knurl_box = bld.new_box(knurl_side, knurl_side, length * 0.8, 0)
    knurl_box = bld.rotate(knurl_box, math.pi / 4, (0, 0, 1))
    knurl_box = bld.translate(knurl_box, knurl_offset_r * r, 0, 0)
    knurl_box = bld.circular_array(knurl_box, knurl_n, knurl_n)
    knurl = bld.union(
        bld.twist(knurl_box, twist_k / r),
        bld.twist(knurl_box, -twist_k / r),
    )
    obj = bld.smooth_difference(sk, obj, knurl)

    obj = bld.smooth_difference(sk, obj, bld.new_cylinder(hole_diam / 2, length + 2 * r, 0))

    vent = bld.new_cylinder(0.25 * r, 3 * r, 0)
    vent = bld.rotate(vent, math.pi / 2, (0, 1, 0))
    obj = bld.smooth_difference(sk, obj, bld.translate(vent, 0, 0, -length / 2))
    return bld.smooth_difference(sk, obj, bld.translate(vent, 0, 0, length / 2))


def _checked(bld: Builder, obj):
    err = bld.err()
    if err:
        raise err
    return obj


def build_flange():
    bld = Builder()
    return _checked(bld, flange_scene(bld))


def build_showerhead():
    bld = Builder()
    return _checked(bld, showerhead_scene(bld))


def build_bolt():
    bld = Builder()
    return _checked(bld, bolt_scene(bld))


def build_knurled():
    bld = Builder()
    return _checked(bld, knurled_scene(bld))
