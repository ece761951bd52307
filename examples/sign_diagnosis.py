#!/usr/bin/env python3
"""Find the grid corners whose sign differs between a device and the CPU
backend, and the first equations of the tree whose values differ there.

    python examples/sign_diagnosis.py                     # four flagships
    python examples/sign_diagnosis.py --parts bolt --resdiv 300
    python examples/sign_diagnosis.py --cpu --resdiv 40   # CPU against itself

A marching-cubes triangle count depends only on corner signs, so a count
that differs between backends comes from corners within a few f32 ulp of
the surface. For each part this prints:

1. the flat renderer's corner grid (`evaluator.grid_eval_fn`, the eval the
   renderers run) on the device and on the CPU: corners whose sign
   differs, corners that differ in any bit, the largest difference;
2. for each flipped corner, both f32 values and the float64 value at the
   same f32 position (f32 multiply, then add, as the grid synthesises it);
3. the tree evaluated at the flipped corners one equation at a time, each
   equation its own executable, so no fusion can contract a multiply into
   an add across equations, on both backends: whether the signs still
   differ, whether each backend's eager value equals its grid value, and
   the first equations whose outputs differ between the backends, with
   their source lines.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
from jax._src import source_info_util  # noqa: E402
from jax.extend.core import Literal  # noqa: E402

from gsdf_tpu import flagships  # noqa: E402
from gsdf_tpu.eval.evaluator import grid_eval_fn  # noqa: E402
from gsdf_tpu.render.flat import FlatRenderer  # noqa: E402

GOLDEN_RESDIV = {"flange": 400, "showerhead": 350, "bolt": 300, "knurled": 350}
# call primitives whose body is walked equation by equation; any other
# primitive with a body (scan, while, cond) runs as one executable
_INLINE = {"pjit", "jit", "closed_call", "core_call", "custom_jvp_call",
           "custom_vjp_call", "custom_vjp_call_jaxpr", "checkpoint", "remat"}
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep


def corner_grid(tree, resdiv, device):
    fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv)
    shape = (fr.nz + 1, fr.ny + 1, fr.nx + 1)
    origin = np.asarray(fr.origin, np.float32)
    grid = grid_eval_fn(tree, shape, device)(origin, np.float32(fr.res))
    return origin, np.float32(fr.res), np.asarray(grid)


def corner_positions(origin, res, idx):
    """f32 positions of (k, j, i) corners: multiply, then add."""
    kji = idx.astype(np.float32)
    return np.stack(
        [origin[0] + kji[:, 2] * res, origin[1] + kji[:, 1] * res,
         origin[2] + kji[:, 0] * res],
        axis=-1,
    ).astype(np.float32)


def eval_float64(tree, pts):
    with jax.enable_x64(True):
        with jax.default_device(jax.devices("cpu")[0]):
            return np.asarray(jax.jit(tree.distance)(pts.astype(np.float64)))


def _body(eqn):
    if eqn.primitive.name not in _INLINE:
        return None
    for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
        sub = eqn.params.get(key)
        if sub is not None:
            return sub
    return None


def eqn_by_eqn(tree, pts, device):
    """The tree's distance at `pts`, one equation per executable.

    Returns (distances, [(eqn, outputs as numpy)] in execution order)."""
    closed = jax.make_jaxpr(tree.distance)(pts)
    trace = []

    def run(jaxpr, consts, args):
        env = {}

        def read(v):
            return v.val if isinstance(v, Literal) else env[v]

        for v, x in zip(jaxpr.constvars, consts):
            env[v] = jax.device_put(x, device)
        for v, x in zip(jaxpr.invars, args):
            env[v] = x
        for eqn in jaxpr.eqns:
            invals = [read(v) for v in eqn.invars]
            body = _body(eqn)
            if body is not None:
                inner = getattr(body, "jaxpr", body)
                outs = run(inner, getattr(body, "consts", ()), invals)
            else:
                outs = eqn.primitive.bind(*invals, **eqn.params)
                if not eqn.primitive.multiple_results:
                    outs = [outs]
                trace.append((eqn, [np.asarray(o) for o in outs]))
            for v, o in zip(eqn.outvars, outs):
                env[v] = o
        return [read(v) for v in jaxpr.outvars]

    with jax.default_device(device):
        (out,) = run(closed.jaxpr, closed.consts, [jax.device_put(pts, device)])
    return np.asarray(out), trace


def _differ(a, b):
    return (a != b) & ~(np.isnan(a) & np.isnan(b)) if a.dtype.kind == "f" else a != b


def diagnose(name, resdiv, device, ref, max_eqns=12):
    """Prints the report for one part; returns the number of flipped corners."""
    tree = getattr(flagships, f"build_{name}")()
    t0 = time.perf_counter()
    origin, res, g_dev = corner_grid(tree, resdiv, device)
    _, _, g_ref = corner_grid(tree, resdiv, ref)
    flips = np.argwhere(np.signbit(g_dev) != np.signbit(g_ref))
    print(
        f"== {name} resdiv {resdiv} grid {g_dev.shape}: {len(flips)} sign flips "
        f"of {g_dev.size} corners; {int(_differ(g_dev, g_ref).sum())} corners "
        f"differ in any bit; max |d_dev - d_ref| "
        f"{float(np.max(np.abs(g_dev - g_ref))):.3e} "
        f"({time.perf_counter() - t0:.1f} s)",
        flush=True,
    )
    if not len(flips):
        return 0
    pts = corner_positions(origin, res, flips)
    d64 = eval_float64(tree, pts)
    for (k, j, i), p, x in zip(flips, pts, d64):
        print(
            f"  flip ({k},{j},{i}) at {p.tolist()}: device {g_dev[k, j, i]:.8e} "
            f"ref {g_ref[k, j, i]:.8e} float64 {x:.8e}"
        )
    e_dev, tr_dev = eqn_by_eqn(tree, pts, device)
    e_ref, tr_ref = eqn_by_eqn(tree, pts, ref)
    at = tuple(flips.T)
    print(
        f"  one equation at a time: {int(_differ(e_dev, e_ref).sum())} values "
        f"differ, {int((np.signbit(e_dev) != np.signbit(e_ref)).sum())} signs "
        f"differ; eager == grid: device {not _differ(e_dev, g_dev[at]).any()}, "
        f"ref {not _differ(e_ref, g_ref[at]).any()}"
    )
    shown = 0
    for (eqn, o_dev), (_, o_ref) in zip(tr_dev, tr_ref):
        diffs = [_differ(a, b) for a, b in zip(o_dev, o_ref)]
        n = sum(int(d.sum()) for d in diffs)
        if not n:
            continue
        worst = max(
            float(np.max(np.abs(a[d].astype(np.float64) - b[d])))
            for a, b, d in zip(o_dev, o_ref, diffs) if d.any()
        )
        where = source_info_util.summarize(eqn.source_info).replace(_REPO, "")
        ins = [str(getattr(v, "aval", v)) for v in eqn.invars]
        print(
            f"  first-diff eqn {eqn.primitive.name} {ins}: {n} values, "
            f"max |d| {worst:.3e} at {where}"
        )
        shown += 1
        if shown == max_eqns:
            break
    return len(flips)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=",".join(GOLDEN_RESDIV),
                    help="comma-separated flagship names")
    ap.add_argument("--resdiv", type=int, default=None,
                    help="override each part's golden resdiv")
    ap.add_argument("--cpu", action="store_true",
                    help="compare the CPU with itself (a run without a card)")
    ap.add_argument("--max-eqns", type=int, default=12)
    args = ap.parse_args(argv)
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    device, ref = jax.devices()[0], jax.devices("cpu")[0]
    print(f"device {device.platform} {device.device_kind}; reference cpu")
    for name in args.parts.split(","):
        diagnose(name, args.resdiv or GOLDEN_RESDIV[name], device, ref, args.max_eqns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
