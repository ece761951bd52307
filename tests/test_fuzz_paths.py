"""Differential fuzzing across render paths.

The reference cross-validates its two evaluators on randomized shapes
(gsdf_test.go:233-283, seeded rand). Here the invariant is stronger:
the staged, fused, welded and compact paths all derive triangles from
the SAME classification, so on random CSG trees they must produce
IDENTICAL triangle counts and matching geometry.

Seed counts: CI runs the small defaults below; set GSDF_TPU_FUZZ_SEEDS=N
to widen every gate to N seeds for marathon sweeps (same tests, same
assertions — only the parametrization grows). GSDF_TPU_FUZZ_BASE=B
offsets the range to [B, B+N) so examples/fuzz_marathon.py can shard a
big sweep across subprocesses: XLA:CPU segfaults inside
backend_compile_and_load after ~500 fresh compiles in ONE process
(reproduced 3x at the same sequence position, 2026-08-18, jax 0.9 —
with and without the persistent cache), so a long sweep must recycle
processes. docs/TESTING.md "Fuzz marathons"."""
import os

import numpy as np
import pytest

from gsdf_tpu import Builder
from gsdf_tpu.render.flat import FlatRenderer

bld = Builder()

_FUZZ_SEEDS = int(os.environ.get("GSDF_TPU_FUZZ_SEEDS", "0"))
_FUZZ_BASE = int(os.environ.get("GSDF_TPU_FUZZ_BASE", "0"))


def _seed_range(default):
    n = max(default, _FUZZ_SEEDS)
    return range(_FUZZ_BASE, _FUZZ_BASE + n)


def _random_profile(rng):
    """Random 2D profile for extrude/revolve leaves (the reference's
    randomized extrude/revolve generators build random 2D shapes,
    gsdf_test.go:688-730)."""
    k = int(rng.integers(4))
    if k == 0:
        return bld.new_circle(float(rng.uniform(0.2, 0.5)))
    if k == 1:
        return bld.new_rectangle(
            float(rng.uniform(0.3, 0.8)), float(rng.uniform(0.3, 0.8))
        )
    if k == 2:
        return bld.new_hexagon(float(rng.uniform(0.2, 0.5)))
    n = int(rng.integers(5, 9))
    ang = np.linspace(0, 2 * np.pi, n + 1)[:-1]
    r = rng.uniform(0.25, 0.6, n)
    verts = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
    return bld.new_polygon(verts)


def _random_unary(t, rng, lipschitz=False):
    """One random unary op from the reference's full randomized set
    (rotate/shell/elongate/offset/scale/symmetry/translate/array/
    circarray/twist, gsdf_test.go:233-283, generators :572-730;
    extrude/revolve enter via _random_tree's 2D leaves).
    lipschitz=True substitutes translate for twist — twist is the one
    op in the set whose field legally exceeds the 1-Lipschitz bound the
    pruned renderer's conservative criterion assumes."""
    k = int(rng.integers(10))
    if lipschitz and k == 5:
        k = 8
    if k == 0:
        ax = rng.normal(size=3)
        ax /= np.linalg.norm(ax)
        return bld.rotate(t, float(rng.uniform(0, 3)), tuple(float(a) for a in ax))
    if k == 1:
        return bld.scale(t, float(rng.uniform(0.6, 1.5)))
    if k == 2:
        return bld.offset(t, float(rng.uniform(-0.05, 0.05)))
    if k == 3:
        return bld.shell(t, float(rng.uniform(0.03, 0.1)))
    if k == 4:
        m = rng.uniform(size=3) < 0.5
        if not m.any():
            m[2] = True
        return bld.symmetry(t, *(bool(x) for x in m))
    if k == 5:
        return bld.twist(t, float(rng.uniform(-0.5, 0.5)))
    if k == 6:
        n_div = int(rng.integers(3, 9))
        n_inst = int(rng.integers(2, n_div + 1))
        return bld.circular_array(
            bld.translate(t, float(rng.uniform(1.5, 2.5)), 0.0, 0.0),
            n_inst,
            n_div,
        )
    if k == 7:
        return bld.elongate(t, *(float(x) for x in rng.uniform(0.05, 0.4, 3)))
    if k == 8:
        return bld.translate(t, *(float(x) for x in rng.uniform(-0.5, 0.5, 3)))
    nx, ny, nz = (int(x) for x in rng.integers(1, 3, 3))
    return bld.array(
        t, *(float(x) for x in rng.uniform(1.8, 2.4, 3)), nx, ny, nz
    )


def _random_tree(rng, lipschitz=False):
    prims = [
        lambda: bld.new_sphere(float(rng.uniform(0.3, 1.0))),
        lambda: bld.new_box(
            *(float(x) for x in rng.uniform(0.4, 1.2, 3)), 0.0
        ),
        lambda: bld.new_cylinder(
            float(rng.uniform(0.2, 0.6)), float(rng.uniform(0.5, 1.5)), 0.0
        ),
        lambda: bld.new_torus(
            float(rng.uniform(0.5, 0.9)), float(rng.uniform(0.1, 0.25))
        ),
        lambda: bld.new_hexagonal_prism(
            float(rng.uniform(0.3, 0.7)), float(rng.uniform(0.4, 1.0))
        ),
        # 2D->3D leaves: extrude / revolve of random profiles
        lambda: bld.extrude(_random_profile(rng), float(rng.uniform(0.4, 1.2))),
        lambda: bld.revolve(
            bld.translate2d(
                _random_profile(rng), float(rng.uniform(0.8, 1.5)), 0.0
            ),
            float(rng.uniform(0.0, 0.4)),
        ),
    ]

    def leaf():
        s = prims[rng.integers(len(prims))]()
        off = rng.uniform(-0.5, 0.5, 3)
        return bld.translate(s, *(float(x) for x in off))

    def combine(a, b):
        ops = [
            lambda: bld.union(a, b),
            lambda: bld.difference(a, b),
            lambda: bld.intersection(a, b),
            lambda: bld.smooth_union(float(rng.uniform(0.02, 0.2)), a, b),
            lambda: bld.smooth_difference(float(rng.uniform(0.02, 0.2)), a, b),
        ]
        return ops[rng.integers(len(ops))]()

    t = leaf()
    for _ in range(int(rng.integers(1, 4))):
        t = combine(t, leaf())
    # 1-2 random unary ops on top, drawn from the reference's full set
    for _ in range(int(rng.integers(1, 3))):
        t = _random_unary(t, rng, lipschitz=lipschitz)
    err = bld.err()
    if err:
        bld.clear_errors()
        return None
    return t


@pytest.mark.parametrize("seed", _seed_range(10))
def test_all_paths_agree(seed):
    _all_paths_agree(seed, None)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", _seed_range(4))
def test_all_paths_agree_gpu(seed, gpu_device):
    _all_paths_agree(seed, gpu_device)


def _all_paths_agree(seed, device):
    rng = np.random.default_rng(seed)
    t = _random_tree(rng)
    if t is None:
        pytest.skip("builder rejected random combination")
    bbd = t.bounds().diagonal()
    if not np.isfinite(bbd) or bbd <= 0 or t.bounds().is_empty():
        # empty = inverted box (disjoint intersection): renderers reject
        # these loudly (ValueError), pinned in test_pruned.py
        pytest.skip("degenerate/empty bounds")
    res = bbd / 32

    fused = FlatRenderer(t, res, device=device).render(fused=True)
    staged = FlatRenderer(t, res, device=device).render(fused=False)
    assert len(fused) == len(staged)
    np.testing.assert_allclose(fused, staged, atol=1e-5)

    fr = FlatRenderer(t, res, device=device)
    wv, wt = fr.render_indexed()
    assert len(wt) == len(fused)

    cv, ct = FlatRenderer(t, res, device=device).render_compact()
    np.testing.assert_array_equal(ct, wt)
    np.testing.assert_allclose(cv, wv, atol=1e-5)

    # intersection of empty is possible: only check surface sanity when
    # there is one
    if len(fused):
        assert np.isfinite(fused).all()


@pytest.mark.parametrize("seed", _seed_range(5))
def test_pruned_path_agrees(seed):
    _pruned_path_agrees(seed, None)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", _seed_range(3))
def test_pruned_path_agrees_gpu(seed, gpu_device):
    _pruned_path_agrees(seed, gpu_device)


def _pruned_path_agrees(seed, device):
    """Pruned-vs-dense compact payload fuzzed on RANDOM trees: ids and
    cases (everything count/topology-derived) must match EXACTLY; the
    edge-interpolation t to a tight ABSOLUTE bound.

    Why t is bounded here while the pinned scenes gate it bit-exact
    (test_pruned.py): XLA CPU compiles the same eval math with
    CONSUMER-CONTEXT-dependent codegen — measured (2026-08-18): adding
    a mere `sum(g > 0)` consumer to a double-optimization_barrier'd
    canonical eval changed 56-119 of ~2.3k grid values by 1-25 ulp on
    fuzz trees, so no source-level discipline can pin t universally
    across the differently-structured pruned/dense kernels (the
    barrier-sandwich experiment is recorded in docs/TESTING.md). The
    production configurations ARE pinned bit-exact where they are
    stable; this gate bounds the residual codegen freedom on arbitrary
    trees so a real regression (wrong edge, wrong order, wrong grid)
    still fails loudly — such bugs produce wholesale O(0.1-1) t
    mismatches, not dust. The bound is ABSOLUTE, not ulp: corner-value
    dust is amplified through t = -va/(vb-va) when the edge nearly
    cancels, and t's own ulp shrinks as t -> 0, so a fixed ulp count
    misreads tiny |dt| as huge drift (measured, marathon seed 12:
    |dt| = 2.0e-6 of a voxel at t = 0.058 reads as 538 ulp). |dt| is
    the geometric error — the vertex moves |dt|*res along the edge —
    and is what the 1e-4-voxel ceiling bounds. Twist is excluded:
    pruning's conservative center-prune criterion assumes a
    1-Lipschitz field (render/pruned.py module docstring), which twist
    legally violates."""
    import jax

    from gsdf_tpu.ops.compact_field import compact_field_render
    from gsdf_tpu.render.pruned import PrunedRenderer

    rng = np.random.default_rng(200 + seed)
    t = _random_tree(rng, lipschitz=True)
    if t is None:
        pytest.skip("builder rejected random combination")
    bbd = t.bounds().diagonal()
    if not np.isfinite(bbd) or bbd <= 0 or t.bounds().is_empty():
        # empty = inverted box (disjoint intersection): renderers reject
        # these loudly (ValueError), pinned in test_pruned.py
        pytest.skip("degenerate/empty bounds")
    res = bbd / 32

    device = device or jax.devices()[0]
    pr = PrunedRenderer(t, res, tile_size=8, tiles_per_batch=128, device=device)
    ids_p, cases_p, t_p = pr.compact_payload()
    fr = FlatRenderer(t, res, device=device)
    ids_d, cases_d, t_d, _ = compact_field_render(
        t, fr.origin, fr.res, (fr.nz + 1, fr.ny + 1, fr.nx + 1), device
    )
    np.testing.assert_array_equal(ids_p, ids_d)
    np.testing.assert_array_equal(cases_p, cases_d)
    dt = np.abs(t_p.astype(np.float64) - t_d.astype(np.float64))
    assert dt.max(initial=0.0) <= 1e-4, f"t drift {dt.max():.2e} > 1e-4 voxel"
    if dt.size:  # a tree can legitimately have zero crossing edges
        # secondary sanity gate: the MAJORITY of t values must be
        # bit-exact — if more than half drift, the two paths are running
        # a different computation, not the same one plus codegen dust.
        # (A 25% cap proved arbitrary: marathon seed 119 drifts 39% of
        # values by <= 8.3e-7 through one deep tree whose fused eval
        # XLA:CPU contracts differently per consumer — docs/TESTING.md
        # "The limit of the discipline".)
        assert np.mean(dt > 0) < 0.5, f"{np.mean(dt > 0):.0%} of t drifted"


@pytest.mark.parametrize("seed", _seed_range(5))
def test_cropped_bounds_paths_agree(seed):
    _cropped_bounds_paths_agree(seed, None)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", _seed_range(3))
def test_cropped_bounds_paths_agree_gpu(seed, gpu_device):
    _cropped_bounds_paths_agree(seed, gpu_device)


def _cropped_bounds_paths_agree(seed, device):
    """Surfaces CROPPED by a with_bounds domain touch the grid boundary:
    owner-edge references can point outside the grid, where the compact
    decoder must either resolve identically or fall back to the welded
    path (native and numpy decoders reject identically — ADVICE r2).
    Counts and vertices must match the welded path either way."""
    from gsdf_tpu.core.wrappers import with_bounds
    from gsdf_tpu.geometry.boxes import Box

    rng = np.random.default_rng(100 + seed)
    t = _random_tree(rng)
    if t is None:
        pytest.skip("builder rejected random combination")
    bb = t.bounds()
    if not np.isfinite(bb.diagonal()) or bb.diagonal() <= 0 or bb.is_empty():
        pytest.skip("degenerate/empty bounds")
    # crop to the part's inner 60%: the surface now intersects the domain
    t = with_bounds(t, Box(bb.min * 0.6, bb.max * 0.6))
    res = t.bounds().diagonal() / 32

    fr = FlatRenderer(t, res, device=device)
    wv, wt = fr.render_indexed()
    cv, ct = FlatRenderer(t, res, device=device).render_compact()
    np.testing.assert_array_equal(ct, wt)
    np.testing.assert_allclose(cv, wv, atol=1e-5)


@pytest.mark.parametrize("seed", _seed_range(3))
def test_sharded_paths_agree(seed):
    import jax

    _sharded_paths_agree(seed, jax.devices("cpu")[:8])


@pytest.mark.gpu
@pytest.mark.parametrize("seed", _seed_range(2))
def test_sharded_paths_agree_gpu(seed, gpu_device):
    """The same invariant on a mesh of every GPU the host has (one card
    still runs the sharded executables)."""
    import jax

    _sharded_paths_agree(seed, jax.devices("gpu"))


def _sharded_paths_agree(seed, devices):
    """Random trees through the multi-chip z-slab paths on the 8-vdev
    mesh: sharded compact == single-device compact (identical tri_idx,
    ulp-equal vertices) and sharded DC == single-device DC (same count,
    elementwise-equal triangles in the same order). The fixed-scene
    shard tests (test_parallel.py, test_sharded_dc.py) pin the flagship
    parts bit-exact; this extends the slab-composition invariant to
    arbitrary CSG trees."""
    from gsdf_tpu.parallel import make_mesh, render_sharded_compact
    from gsdf_tpu.parallel.sharded_dc import render_dc_sharded
    from gsdf_tpu.render.dual_contour import DualContourRenderer

    rng = np.random.default_rng(300 + seed)
    t = _random_tree(rng)
    if t is None:
        pytest.skip("builder rejected random combination")
    bbd = t.bounds().diagonal()
    if not np.isfinite(bbd) or bbd <= 0 or t.bounds().is_empty():
        # empty = inverted box (disjoint intersection): renderers reject
        # these loudly (ValueError), pinned in test_pruned.py
        pytest.skip("degenerate/empty bounds")
    res = bbd / 24

    mesh = make_mesh(devices)

    sv, st = render_sharded_compact(t, mesh, res)
    cv, ct = FlatRenderer(t, res, device=devices[0]).render_compact()
    np.testing.assert_array_equal(st, ct)
    np.testing.assert_allclose(sv, cv, atol=1e-6)

    dc_sharded = render_dc_sharded(t, mesh, res)
    dc_single = DualContourRenderer(t, res, device=devices[0]).render()
    assert len(dc_sharded) == len(dc_single)
    np.testing.assert_allclose(dc_sharded, dc_single, atol=1e-6)
