"""Console entry points (`gsdf-tpu-bench`, `gsdf-tpu-breadth`).

bench_main prints ONE JSON line:
  {"metric": ..., "value": <ms>, "unit": "ms", "vs_baseline": <speedup>}

value        = median wall ms of SDF evaluation + marching cubes + triangle
               fetch + binary STL encode (in-memory), after one warm-up run.
vs_baseline  = baseline_ms / value. Baseline is the reference's best
               SDF->STL on this part: RX 6800 GPU render 706 ms + STL write
               371 ms = 1077 ms (reference README.md:116-117; BASELINE.md).
               >1 means faster than the reference GPU pipeline.

The warm-up run compiles (or loads from the persistent compile cache) every
executable; steady-state production rendering is the regime the reference's
numbers describe (its GLSL compile is likewise excluded from render ms).

The line names the device it ran on (platform, device_kind, count).
bench_main and breadth_main refuse to time the CPU backend: they exit
non-zero when the default JAX device is the CPU.
"""
from __future__ import annotations

import io
import json
import statistics
import time

from .flagships import (
    GOLDEN_BOLT_TRIS,
    GOLDEN_FLANGE_TRIS,
    GOLDEN_KNURLED_TRIS,
    GOLDEN_SHOWERHEAD_TRIS,
    build_bolt,
    build_flange,
    build_knurled,
    build_showerhead,
)


def _bench_part(obj, resdiv, golden, repeats):
    """Median warm SDF->STL wall ms through the compact production path,
    hard-asserting the golden triangle count (golden=None skips the
    assert)."""
    from .render.flat import FlatRenderer
    from .render.stl import write_binary_stl_indexed

    res = obj.bounds().diagonal() / resdiv

    def run():
        t0 = time.monotonic()
        fr = FlatRenderer(obj, res)
        # compact-field production path: one dispatch, ~1.3 MB fetch,
        # native host decode + indexed STL encode
        verts, tri_idx = fr.render_compact()
        buf = io.BytesIO()
        write_binary_stl_indexed(buf, verts, tri_idx)
        return (time.monotonic() - t0) * 1e3, len(tri_idx)

    # warm-up twice: first compiles (or loads the persistent cache), the
    # second reaches steady state (exact-size buffer hints recorded by
    # the first may compile one minimal-buffer executable)
    _, ntris = run()
    run()
    # the perf number is also a correctness gate: exact reference count
    if golden is not None:
        assert ntris == golden, f"triangle count {ntris} != golden {golden}"
    times = [run()[0] for _ in range(repeats)]
    return statistics.median(times), ntris


def _accelerator_devices():
    """jax.devices(), refusing a CPU default: these benchmarks time an
    accelerator, and the goldens they assert are its counts."""
    import jax

    devices = jax.devices()
    if devices[0].platform == "cpu":
        raise SystemExit(
            "the default JAX device is the CPU; this benchmark times an accelerator"
        )
    return devices


def bench_main():
    devices = _accelerator_devices()
    flange_ms, flange_tris = _bench_part(
        build_flange(), 400, GOLDEN_FLANGE_TRIS, repeats=7
    )
    # secondary gate: the other flagship part (deep tree: 130-hole union +
    # buttress screw + knurl) catches part-specific regressions the flange
    # can't; reference RX 6800 end-to-end is 701 ms (README.md:152-156)
    shower_ms, shower_tris = _bench_part(
        build_showerhead(), 350, GOLDEN_SHOWERHEAD_TRIS, repeats=5
    )
    baseline_ms = 706.0 + 371.0  # reference RX6800 flange render + STL write
    print(
        json.dumps(
            {
                "metric": "npt-flange resdiv400 SDF->STL warm (1 chip)",
                "value": round(flange_ms, 1),
                "unit": "ms",
                "vs_baseline": round(baseline_ms / flange_ms, 2),
                "triangles": flange_tris,
                "platform": devices[0].platform,
                "device_kind": devices[0].device_kind,
                "count": len(devices),
                "secondary": {
                    "metric": "fibonacci-showerhead resdiv350 SDF->STL warm",
                    "value": round(shower_ms, 1),
                    "unit": "ms",
                    "vs_baseline": round(701.0 / shower_ms, 2),
                    "triangles": shower_tris,
                },
            }
        )
    )


def breadth_main():
    """Every flagship part through the production compact path, warm
    SDF->STL (in-memory), one row per part. Reuses `_bench_part`
    verbatim so rows are directly comparable to the headline number; all
    four counts are golden gates."""
    _accelerator_devices()
    rows = [
        ("npt-flange", build_flange(), 400, GOLDEN_FLANGE_TRIS),
        ("fibonacci-showerhead", build_showerhead(), 350, GOLDEN_SHOWERHEAD_TRIS),
        ("iso-m3-bolt", build_bolt(), 300, GOLDEN_BOLT_TRIS),
        ("knurled-cylinder", build_knurled(), 350, GOLDEN_KNURLED_TRIS),
    ]
    for name, obj, resdiv, golden in rows:
        ms, n = _bench_part(obj, resdiv, golden, repeats=7)
        print(f"{name} resdiv{resdiv}: {n:,} tris {ms:.0f} ms", flush=True)
