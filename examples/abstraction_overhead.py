"""Abstraction-overhead microbenchmark: the SAME SDF priced two ways.

The reference keeps hand-written whole-shader evaluators (PolygonGPU,
Lines2DGPU, DisplaceMulti2D — gleval/gpu.go:169-446) precisely to price
its GLSL tree CODEGEN against a raw compute shader; the battery in
examples/test/glsdf3test.go:55-66 is that comparison. This rebuild's
standing claim (eval/special.py docstring) is that this axis collapses:
a jit-traced node tree IS a raw fused kernel to XLA, so the abstraction
costs nothing. This harness MEASURES the claim instead of asserting it:

  * polygon-64v   — core.primitives2.Polygon2D through the tree path
                    vs the same winding-number math hand-written twice
                    (a lax.scan edge fold, and the O(P*V)-memory
                    broadcast form), no node classes anywhere.
  * csg-deep-3d   — Builder tree (sphere smooth-union rounded-box,
                    minus cylinder) vs the same formulas hand-inlined
                    into one flat function.

Every variant evaluates the identical on-device iota-synthesized grid
and fetches ONE scalar checksum (the completion barrier: dispatch is
asynchronous); values are asserted to agree to 2e-6 before timing so
the comparison can't drift apart silently. Expected result: ratios
~1.0x, the tree path within noise of raw, because XLA sees the same
elementwise chain either way (not measured on the GPU yet).

Usage: python examples/abstraction_overhead.py [--repeats 7] [--cpu]
"""
import argparse
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp

_f32 = np.float32


# ----------------------------------------------------------------- raw
# Hand-written kernels: plain functions of (...,2)/(...,3) points, no
# node classes, no Builder, no mathx helpers — what a user would write
# if the framework didn't exist. Formulas transcribed independently
# from the reference semantics (cpu_evaluators.go:793 winding polygon;
# :20 sphere; :28 rounded box; :70 cylinder; :213 smooth union).


def raw_polygon_scan(vert: np.ndarray):
    v1 = vert
    v2 = np.roll(vert, 1, axis=0)
    edges = jnp.asarray(np.concatenate([v1, v2], axis=1).astype(_f32))

    def sdf(p):
        px, py = p[..., 0], p[..., 1]

        def body(carry, edge):
            dd, parity = carry
            ax, ay, bx, by = edge[0], edge[1], edge[2], edge[3]
            ex, ey = bx - ax, by - ay
            wx, wy = px - ax, py - ay
            h = jnp.clip((wx * ex + wy * ey) / (ex * ex + ey * ey), 0.0, 1.0)
            qx, qy = wx - h * ex, wy - h * ey
            dd = jnp.minimum(dd, qx * qx + qy * qy)
            c1 = py >= ay
            c2 = py < by
            c3 = ex * wy > ey * wx
            flip = (c1 & c2 & c3) | (~c1 & ~c2 & ~c3)
            return (dd, parity ^ flip), None

        init = (jnp.full(px.shape, _f32(np.inf)), jnp.zeros(px.shape, bool))
        (dd, parity), _ = jax.lax.scan(body, init, edges, unroll=8)
        return jnp.where(parity, -1.0, 1.0).astype(jnp.float32) * jnp.sqrt(dd)

    return sdf


def raw_polygon_broadcast(vert: np.ndarray):
    v1 = jnp.asarray(vert)
    v2 = jnp.asarray(np.roll(vert, 1, axis=0))

    def sdf(p):
        e = v2 - v1
        w = p[..., None, :] - v1
        h = jnp.clip(
            jnp.sum(w * e, axis=-1) / jnp.sum(e * e, axis=-1), 0.0, 1.0
        )
        q = w - h[..., None] * e
        dd = jnp.min(jnp.sum(q * q, axis=-1), axis=-1)
        py = p[..., 1:2]
        c1 = py >= v1[:, 1]
        c2 = py < v2[:, 1]
        c3 = e[:, 0] * w[..., 1] > e[:, 1] * w[..., 0]
        flip = (c1 & c2 & c3) | (~c1 & ~c2 & ~c3)
        s = jnp.where(jnp.sum(flip, axis=-1) % 2 == 1, -1.0, 1.0)
        return s.astype(jnp.float32) * jnp.sqrt(dd)

    return sdf


def raw_csg_deep(p):
    # sphere r=0.8
    d_sph = jnp.sqrt(jnp.sum(p * p, axis=-1)) - _f32(0.8)
    # box 1x1x1 round 0.05
    rnd = _f32(0.05)
    q = jnp.abs(p) - _f32(0.5) + rnd
    d_box = (
        jnp.sqrt(jnp.sum(jnp.maximum(q, 0.0) ** 2, axis=-1))
        + jnp.minimum(jnp.maximum(q[..., 0], jnp.maximum(q[..., 1], q[..., 2])), 0.0)
        - rnd
    )
    # smooth union k=0.2
    k = _f32(0.2)
    h = jnp.clip(0.5 + 0.5 * (d_box - d_sph) / k, 0.0, 1.0)
    d_u = d_box + (d_sph - d_box) * h - k * h * (1 - h)
    # cylinder r=0.3 h=3.0 (sharp)
    dx = jnp.hypot(p[..., 0], p[..., 1]) - _f32(0.3)
    dy = jnp.abs(p[..., 2]) - _f32(1.5)
    d_cyl = jnp.minimum(0.0, jnp.maximum(dx, dy)) + jnp.hypot(
        jnp.maximum(dx, 0.0), jnp.maximum(dy, 0.0)
    )
    # difference
    return jnp.maximum(d_u, -d_cyl)


# ------------------------------------------------------------- harness


def checksum_times(dist_fn, bb_min, bb_max, shape, repeats, device, passes):
    """Median end-to-end wall of `passes` full-grid evals + ONE scalar
    checksum fetch; positions synthesized on device from iota (the
    production discipline). Each pass shifts the origin by a distinct
    sub-voxel constant so XLA cannot CSE the passes away — amplifying
    device compute over the fixed per-dispatch fetch cost (both paths pay
    the same fetch, but a compute:fetch ratio near zero would hide any
    real difference)."""
    lo = np.asarray(bb_min, _f32)
    hi = np.asarray(bb_max, _f32)
    ndim = len(shape)
    res = _f32(max((hi - lo) / (np.array(shape, _f32) - 1)))

    def impl(origin):
        axes = [
            jax.lax.broadcasted_iota(jnp.float32, shape, a)
            for a in range(ndim)
        ]
        acc = jnp.float32(0.0)
        for s in range(passes):
            shift = _f32(s) * _f32(1e-3) * res
            # axis 0 slowest (z in 3D), matching grid_eval_fn's layout
            p = jnp.stack(
                [
                    origin[i] + shift + axes[ndim - 1 - i] * res
                    for i in range(ndim)
                ],
                axis=-1,
            )
            d = dist_fn(p)
            acc = acc + jnp.sum(jnp.abs(jnp.clip(d, -1.0, 1.0)))
        return acc

    with jax.default_device(device):
        jitted = jax.jit(impl)
        origin = jnp.asarray(lo)
        chk = float(jitted(origin))  # compile + warm
        times = []
        for _ in range(repeats):
            t0 = time.monotonic()
            float(jitted(origin))
            times.append(time.monotonic() - t0)
    return statistics.median(times), chk


def agree(fn_a, fn_b, bb_min, bb_max, ndim, tol, device, n=4096):
    rng = np.random.default_rng(3)
    lo = np.asarray(bb_min, _f32)
    hi = np.asarray(bb_max, _f32)
    pts = (lo + rng.uniform(0, 1, (n, ndim)).astype(_f32) * (hi - lo)).astype(_f32)
    pj = jax.device_put(pts, device)
    da = np.asarray(jax.jit(fn_a, device=device)(pj))
    db = np.asarray(jax.jit(fn_b, device=device)(pj))
    worst = float(np.abs(da - db).max())
    assert worst <= tol, f"tree/raw disagree: {worst} > {tol}"
    return worst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--grid3d", type=int, default=512)
    ap.add_argument("--grid2d", type=int, default=2048)
    ap.add_argument("--passes", type=int, default=8,
                    help="grid evals per dispatch (compute amplification)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]

    from gsdf_tpu.core import Builder

    bld = Builder()
    rng = np.random.default_rng(7)
    # same 64-vertex random polygon as eval.special.run_benchmarks
    poly = rng.uniform(-1, 1, (64, 2)).astype(_f32)
    tree_poly = bld.new_polygon(poly)
    bb2 = tree_poly.bounds()

    tree_csg = bld.difference(
        bld.smooth_union(0.2, bld.new_sphere(0.8), bld.new_box(1, 1, 1, 0.05)),
        bld.new_cylinder(0.3, 3.0, 0.0),
    )
    bb3 = tree_csg.bounds()
    if bld.err():
        raise SystemExit(bld.err())

    raw_scan = raw_polygon_scan(poly)
    raw_bcast = raw_polygon_broadcast(poly)

    w2 = agree(tree_poly.distance, raw_scan, bb2.min, bb2.max, 2, 2e-6, dev)
    w2b = agree(tree_poly.distance, raw_bcast, bb2.min, bb2.max, 2, 2e-6, dev)
    w3 = agree(tree_csg.distance, raw_csg_deep, bb3.min, bb3.max, 3, 2e-6, dev)
    print(f"value agreement (4096 random pts): polygon scan {w2:.2e} "
          f"broadcast {w2b:.2e}  csg {w3:.2e}")

    n2 = (args.grid2d, args.grid2d)
    # the broadcast form materializes O(points*verts) (19 GB at 512^3)
    # — quarter the grid so it fits
    n2b = (args.grid2d // 2, args.grid2d // 2)
    n3 = (args.grid3d,) * 3
    cases = [
        ("polygon-64v tree (Polygon2D node)", tree_poly.distance, bb2, n2),
        ("polygon-64v raw scan kernel", raw_scan, bb2, n2),
        ("polygon-64v raw broadcast kernel", raw_bcast, bb2, n2b),
        ("csg-deep-3d tree (Builder)", tree_csg.distance, bb3, n3),
        ("csg-deep-3d raw inlined kernel", raw_csg_deep, bb3, n3),
    ]
    base = {}
    for name, fn, bb, shape in cases:
        med, chk = checksum_times(
            fn, bb.min, bb.max, shape, args.repeats, dev, args.passes
        )
        geps = int(np.prod(shape)) * args.passes / med / 1e9
        fam = name.split(" ")[0]
        note = ""
        if fam in base:
            note = f"  ({base[fam] / geps:.2f}x the tree path's time/eval)"
        else:
            base[fam] = geps
        print(f"[{med * 1e3:8.2f}ms] {name} {shape}: {geps:.3f} Geval/s"
              f" checksum={chk:.1f}{note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
