#!/usr/bin/env python3
"""Bring-up check of the CSG-to-mesh path on a GPU, through the entry
points a user calls, at the resolutions the reference publishes.

    python chip_smoke.py          # one card: phases a-e
    python chip_smoke.py --four   # four cards: phase f only

Phases (any failure exits non-zero, and no result line is printed):

a. card: the card's name and power limit (nvidia-smi); the native host
   library must be built and loaded (the numpy fallback would change
   what the host does).
b. `gpu`-marked tests, in a child process that runs before this process
   starts any JAX backend, so one process holds the card at a time.
   Then the JAX default device must be a GPU.
c. golden triangle counts, exact, with cold and warm wall times:
   pipeline.render_shader3d (flange 400, to an in-memory STL),
   FlatRenderer.render_compact (showerhead 350, bolt 300, knurled 350,
   flange 1000), DualContourRenderer (bolt 256).
d. path agreement on the flange at resdiv 400: compact == welded
   tri_idx; a parametric edit re-renders with zero new executables;
   raymarch_image renders one frame.
e. plain reference: each flagship tree evaluated at 16M points on the
   GPU and on the CPU backend, max |d_gpu - d_cpu| <= 1e-6 x diagonal;
   compiled.memory_analysis() of the flange-1000 executable.
f. (--four only) parallel.render_sharded_compact of the flange at resdiv
   1000 and parallel.render_dc_sharded of the bolt at resdiv 256 on four
   cards, identical to the single-card renders.

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PARTS = ("build_flange", "build_showerhead", "build_bolt", "build_knurled")
REF_POINTS = 1 << 24
REF_BOUND = 1e-6  # max |d_gpu - d_cpu| over the part's bounding diagonal


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`name, power.limit` of the card(s), as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def require_native() -> None:
    from gsdf_tpu import native

    if native.get_lib() is None:
        raise RuntimeError("native host library did not build or load")


def require_gpu(devices) -> None:
    if not devices or devices[0].platform != "gpu":
        kind = devices[0].platform if devices else "none"
        raise RuntimeError(f"default JAX device is {kind}, not a GPU")


def run_gpu_tests(timeout: float = 900) -> None:
    """`pytest -m gpu` in a child; this process must not hold the card."""
    env = dict(os.environ, GSDF_TEST_GPU="1")
    cmd = [
        sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-p", "no:xdist",
        "-p", "no:cacheprovider", "-q",
    ]
    proc = subprocess.run(cmd, cwd=HERE, env=env, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"gpu-marked tests failed (exit {proc.returncode})")


def _build(name):
    from gsdf_tpu import flagships

    return getattr(flagships, name)()


def _res(tree, resdiv):
    return float(tree.bounds().diagonal()) / resdiv


def render_count(tree, resdiv, route, device) -> int:
    """Triangle count of one render through a user entry point."""
    res = _res(tree, resdiv)
    if route == "stl":
        from gsdf_tpu.pipeline import RenderConfig, render_shader3d

        buf = io.BytesIO()
        stats = render_shader3d(
            tree,
            RenderConfig(
                stl_output=buf, resolution=res, silent=True, device=device
            ),
        )
        if buf.tell() != 84 + 50 * stats["triangles"]:
            raise AssertionError(f"STL of {buf.tell()} bytes for {stats['triangles']} triangles")
        return stats["triangles"]
    if route == "compact":
        from gsdf_tpu.render.flat import FlatRenderer

        return len(FlatRenderer(tree, res, device=device).render_compact()[1])
    if route == "dc":
        from gsdf_tpu.render.dual_contour import DualContourRenderer

        return len(DualContourRenderer(tree, res, device=device).render())
    raise ValueError(f"unknown route {route!r}")


def golden_cases():
    """(label, flagships builder, resdiv, route, exact golden triangle
    count) for the six goldens of gsdf_tpu.flagships."""
    from gsdf_tpu import flagships as f

    return (
        ("flange", "build_flange", 400, "stl", f.GOLDEN_FLANGE_TRIS),
        ("showerhead", "build_showerhead", 350, "compact", f.GOLDEN_SHOWERHEAD_TRIS),
        ("bolt", "build_bolt", 300, "compact", f.GOLDEN_BOLT_TRIS),
        ("knurled", "build_knurled", 350, "compact", f.GOLDEN_KNURLED_TRIS),
        ("bolt", "build_bolt", 256, "dc", f.GOLDEN_DC_BOLT_256_TRIS),
        ("flange", "build_flange", 1000, "compact", f.GOLDEN_FLANGE_1000_TRIS),
    )


def phase_goldens(device, card: str, cases=None) -> None:
    """Every case is rendered and reported; then any miss fails."""
    misses = []
    for label, builder, resdiv, route, golden in cases or golden_cases():
        tree = _build(builder)
        t0 = time.perf_counter()
        n_cold = render_count(tree, resdiv, route, device)
        cold = time.perf_counter() - t0
        # the second render may compile once more at the exact buffer
        # sizes the first one recorded; the third is steady state
        render_count(tree, resdiv, route, device)
        t0 = time.perf_counter()
        n = render_count(tree, resdiv, route, device)
        warm = time.perf_counter() - t0
        log(
            f"golden {label} resdiv {resdiv} ({route}): {n} triangles "
            f"(golden {golden}); cold {cold:.2f} s, warm {warm * 1e3:.1f} ms "
            f"on {card}"
        )
        if n != golden or n_cold != golden:
            misses.append(f"{label} resdiv {resdiv} ({route}): {n_cold}/{n} != {golden}")
    if misses:
        raise AssertionError("golden counts missed: " + "; ".join(misses))


class _LoweringCounter:
    """Counts jaxpr -> MLIR lowerings: each one is a new executable."""

    def __init__(self):
        import jax

        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **kwargs):
        if event == "/jax/core/compile/jaxpr_to_mlir_module_duration":
            self.n += 1


def phase_paths(device, resdiv=400, frame=(256, 256)) -> None:
    from gsdf_tpu.core.wrappers import with_bounds
    from gsdf_tpu.render.flat import FlatRenderer
    from gsdf_tpu.visual.raymarch import raymarch_image

    flange = _build("build_flange")
    res = _res(flange, resdiv)
    cv, ct = FlatRenderer(flange, res, device=device).render_compact()
    wv, wt = FlatRenderer(flange, res, device=device).render_indexed()
    if not np.array_equal(ct, wt):
        raise AssertionError("compact and welded tri_idx differ")
    np.testing.assert_allclose(cv, wv, atol=1e-5 * res)
    log(f"paths: compact == welded tri_idx ({len(ct)} triangles)")

    counter = _LoweringCounter()
    pinned = with_bounds(flange, flange.bounds())
    plate = max(
        (n for n in pinned.visit_bfs() if type(n).__name__ == "Cylinder"),
        key=lambda n: float(n.r),
    )
    fr = FlatRenderer(pinned, res, device=device)
    fr.render_compact(parametric=True)  # compiles; records buffer sizes
    _, t0 = fr.render_compact(parametric=True)  # steady-state executable
    before = counter.n
    pinned.rebind({plate: {"r": float(plate.r) * 0.9}})
    t_start = time.perf_counter()
    _, t1 = fr.render_compact(parametric=True)
    edit_ms = (time.perf_counter() - t_start) * 1e3
    new_exec = counter.n - before
    log(
        f"paths: parametric edit {len(t0)} -> {len(t1)} triangles, "
        f"{new_exec} new executables, {edit_ms:.1f} ms"
    )
    if new_exec or len(t1) == len(t0):
        raise AssertionError("parametric edit recompiled or changed nothing")
    _, t_ref = FlatRenderer(pinned, res, device=device).render_compact()
    if not np.array_equal(t1, t_ref):
        raise AssertionError("parametric edit differs from a fresh render")

    img = raymarch_image(flange, frame[0], frame[1], device=device)
    if img.shape != (frame[1], frame[0], 3) or int(img.max()) == 0:
        raise AssertionError(f"raymarch frame is blank or {img.shape}")
    log(f"paths: raymarch frame {img.shape}, {int((img > 0).any(-1).sum())} lit px")


def phase_reference(device, n_points=REF_POINTS, chunk=1 << 21) -> None:
    import jax

    from gsdf_tpu.eval import new_sdf3

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(0)
    for builder in PARTS:
        tree = _build(builder)
        bb = tree.bounds()
        diag = float(bb.diagonal())
        dev_sdf, cpu_sdf = new_sdf3(tree, device), new_sdf3(tree, cpu)
        worst = 0.0
        for start in range(0, n_points, chunk):
            m = min(chunk, n_points - start)
            pts = rng.uniform(bb.min, bb.max, (m, 3)).astype(np.float32)
            d_dev = dev_sdf.evaluate(pts)
            d_cpu = cpu_sdf.evaluate(pts)
            if not np.isfinite(d_dev).all():
                raise AssertionError(f"{builder}: non-finite distances")
            worst = max(worst, float(np.max(np.abs(d_dev - d_cpu))))
        log(
            f"reference {builder}: {n_points} points, max |d_gpu - d_cpu| "
            f"{worst:.3e} = {worst / diag:.3e} x diagonal (bound {REF_BOUND:g})"
        )
        if worst > REF_BOUND * diag:
            raise AssertionError(f"{builder}: deviation {worst} over bound")


def phase_memory(device, resdiv=1000) -> None:
    """compiled.memory_analysis() of the flange compact executable."""
    from gsdf_tpu.ops import compact_field as cf
    from gsdf_tpu.render.flat import FlatRenderer

    flange = _build("build_flange")
    fr = FlatRenderer(flange, _res(flange, resdiv), device=device)
    fr.render_compact()
    shape = (fr.nz + 1, fr.ny + 1, fr.nx + 1)
    a, v, e, blk = fr._compact_hint
    fn = cf.build_compact_field(flange, shape, a, e, v, device, blk_size=blk)
    compiled = fn.jitted.lower(
        np.asarray(fr.origin, np.float32), np.float32(fr.res), np.float32(0)
    ).compile()
    log(f"memory flange resdiv {resdiv} {shape}: {compiled.memory_analysis()}")
    stats = device.memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        log(f"memory peak_bytes_in_use {stats['peak_bytes_in_use']}")


def phase_four(devices, mc_resdiv=1000, dc_resdiv=256) -> None:
    from gsdf_tpu.flagships import GOLDEN_FLANGE_1000_TRIS
    from gsdf_tpu.parallel import make_mesh, render_dc_sharded, render_sharded_compact
    from gsdf_tpu.render.dual_contour import DualContourRenderer
    from gsdf_tpu.render.flat import FlatRenderer

    mesh = make_mesh(devices)
    flange = _build("build_flange")
    res = _res(flange, mc_resdiv)
    t0 = time.perf_counter()
    sv, st = render_sharded_compact(flange, mesh, res)
    t_s = time.perf_counter() - t0
    cv, ct = FlatRenderer(flange, res, device=devices[0]).render_compact()
    log(
        f"four: sharded compact flange resdiv {mc_resdiv}: {len(st)} triangles "
        f"({t_s:.2f} s cold), single card {len(ct)}"
    )
    if not np.array_equal(st, ct):
        raise AssertionError("sharded compact tri_idx differs from one card")
    np.testing.assert_allclose(sv, cv, atol=1e-6 * res)
    if mc_resdiv == 1000 and len(st) != GOLDEN_FLANGE_1000_TRIS:
        raise AssertionError(
            f"flange resdiv 1000: {len(st)} != {GOLDEN_FLANGE_1000_TRIS}"
        )

    bolt = _build("build_bolt")
    res = _res(bolt, dc_resdiv)
    t0 = time.perf_counter()
    dc_s = render_dc_sharded(bolt, mesh, res)
    t_s = time.perf_counter() - t0
    dc_1 = DualContourRenderer(bolt, res, device=devices[0]).render()
    log(
        f"four: sharded DC bolt resdiv {dc_resdiv}: {len(dc_s)} triangles "
        f"({t_s:.2f} s cold), single card {len(dc_1)}"
    )
    if not np.array_equal(dc_s, dc_1):
        raise AssertionError("sharded DC triangles differ from one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the four-card sharded phase",
    )
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    require_native()
    log("native host library: built and loaded")
    if not args.four:
        run_gpu_tests()
        log(f"gpu-marked tests passed ({time.perf_counter() - t_start:.0f} s)")

    import jax

    devices = jax.devices()
    require_gpu(devices)
    dev = devices[0]
    log(f"jax {jax.__version__}: {len(devices)} x {dev.device_kind}")

    if args.four:
        if len(devices) < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        phase_four(devices)
    else:
        devices = devices[:1]
        phase_goldens(dev, card)
        phase_paths(dev)
        phase_reference(dev)
        phase_memory(dev)
    log(f"total {time.perf_counter() - t_start:.0f} s")
    result = {
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devices),
        },
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
