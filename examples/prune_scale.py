"""Pruned-vs-dense comparison at production scale.

At resdiv 400 (6.6M cubes) the pruned renderer's coarse pass adds
dispatches that may dominate; at resdiv 800 (52M cubes) and 1000 (102M
cubes) dense classification costs 8-16x more, so the answer may invert —
this measures it (not measured on the GPU yet).

Per size, warm medians of:
  dense-compact : FlatRenderer.render_compact() — the production path
  pruned (tile) : PrunedRenderer.render() — two-level mask pyramid
                  (eval counts + prune rate reported)

Run on the real chip: python examples/prune_scale.py [resdiv ...]
"""
import json
import statistics
import time

import numpy as np

import _common  # noqa: F401  (ensures gsdf_tpu importable)
from gsdf_tpu.flagships import build_flange


def time_med(fn, repeats=3, label=""):
    t0 = time.monotonic()
    fn()  # warm (compile or cache load)
    print(f"  [{label}] warm-up {time.monotonic()-t0:.1f}s", flush=True)
    times = []
    for _ in range(repeats):
        t0 = time.monotonic()
        out = fn()
        times.append(time.monotonic() - t0)
    print(f"  [{label}] median {statistics.median(times)*1e3:.1f}ms", flush=True)
    return statistics.median(times) * 1e3, out


def main():
    from gsdf_tpu.render.flat import FlatRenderer
    from gsdf_tpu.render.pruned import PrunedRenderer

    resdivs = [int(a) for a in sys.argv[1:]] or [800, 1000]
    tree = build_flange()
    diag = tree.bounds().diagonal()
    rows = []
    for resdiv in resdivs:
        res = diag / resdiv

        fr = FlatRenderer(tree, res)
        ncubes = fr.nx * fr.ny * fr.nz
        dense_ms, (verts, tri_idx) = time_med(
            lambda: FlatRenderer(tree, res).render_compact(),
            label=f"dense-compact {resdiv}",
        )
        ntris_dense = len(tri_idx)

        pc_ms, (pv, pt) = time_med(
            lambda: PrunedRenderer(tree, res).render_compact(),
            label=f"pruned-compact {resdiv}",
        )

        pruned_ms, tris = time_med(
            lambda: PrunedRenderer(tree, res).render(),
            label=f"pruned-soup {resdiv}",
        )
        # fresh renderer per run above; stats from one more run
        pr = PrunedRenderer(tree, res)
        _ = pr.render_compact()
        row = {
            "resdiv": resdiv,
            "grid_cubes": ncubes,
            "triangles": ntris_dense,
            "dense_compact_ms": round(dense_ms, 1),
            "pruned_soup_ms": round(pruned_ms, 1),
            "pruned_compact_ms": round(pc_ms, 1),
            "pruned_triangles": len(pt),
            "pruned_soup_triangles": len(tris),
            "pruned_evaluations": pr.evaluations(),
            "pruned_skipped_evals": pr.total_pruned(),
            "prune_rate_pct": round(
                100.0 * pr.total_pruned() / (pr.evaluations() + pr.total_pruned()), 1
            ),
        }
        rows.append(row)
        print(json.dumps(row))
    print(json.dumps({"rows": rows}))


if __name__ == "__main__":
    main()
