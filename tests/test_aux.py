"""Batcher, special evaluators, colors, minecraft render, block cache."""
import numpy as np
import pytest

from gsdf_tpu import Builder
from gsdf_tpu.eval import BlockCachedSDF3, new_cpu_sdf3, new_sdf2
from gsdf_tpu.eval.batch import Batcher
from gsdf_tpu.eval.special import displace_multi2d, lines2d_gpu, polygon_gpu

bld = Builder()


def test_batcher_ops():
    b = Batcher()
    a = np.array([1.0, -2.0, 3.0], np.float32)
    c = np.array([-1.0, 5.0, 2.0], np.float32)
    np.testing.assert_array_equal(b.union(None, a, c), np.minimum(a, c))
    np.testing.assert_array_equal(b.diff(None, a, c), np.maximum(a, -c))
    np.testing.assert_array_equal(b.intersect(None, a, c), np.maximum(a, c))
    dst = np.empty(3, np.float32)
    import jax.numpy as jnp

    out = b.execute_raw_binary_operation(lambda x, y: x * 2 + y, dst, a, c)
    np.testing.assert_array_equal(out, a * 2 + c)
    assert out is dst


def test_batcher_custom_cache_keys_by_callable():
    """Regression (a round-3 review finding): the custom-op cache must be
    keyed by the callable itself, not id(op) — a GC'd op's id can be
    reused by a new op, which would then silently receive the previous
    op's compiled function."""
    b = Batcher()
    a = np.array([1.0, -2.0, 3.0], np.float32)
    c = np.array([-1.0, 5.0, 2.0], np.float32)

    def run_gc_churn():
        # many short-lived callables to encourage id reuse
        for k in range(64):
            op = eval(f"lambda x, y: x + y * {k}")  # distinct code objects
            b.execute_raw_binary_operation(op, None, a, c)

    run_gc_churn()
    op1 = lambda x, y: x - y  # noqa: E731
    np.testing.assert_array_equal(
        b.execute_raw_binary_operation(op1, None, a, c), a - c
    )
    # keys are the callables themselves
    assert all(callable(k) for k in b._custom)
    assert op1 in b._custom
    # the cache is a bounded LRU: fresh-lambda-per-call churn must not
    # retain a callable + compiled fn per call forever
    for k in range(300):
        b.execute_raw_binary_operation(
            eval(f"lambda x, y: x - y * {k}"), None, a, c
        )
    assert len(b._custom) <= 256
    # an evicted op still computes correctly (recompiles transparently)
    np.testing.assert_array_equal(
        b.execute_raw_binary_operation(op1, None, a, c), a - c
    )


def test_special_evaluators_match_tree():
    verts = [(-0.5, -0.4), (0.5, -0.5), (0.4, 0.5), (-0.3, 0.35)]
    pg = polygon_gpu(verts)
    tree = new_sdf2(bld.new_polygon(verts))
    pts = np.random.default_rng(0).uniform(-1, 1, (128, 2)).astype(np.float32)
    np.testing.assert_allclose(pg.evaluate(pts), tree.evaluate(pts), atol=1e-6)

    segs = [[(0, 0), (1, 0)], [(1, 0), (1, 1)]]
    lg = lines2d_gpu(segs, 0.1)
    lt = new_sdf2(bld.new_lines2d(segs, 0.1))
    np.testing.assert_allclose(lg.evaluate(pts), lt.evaluate(pts), atol=1e-6)

    dm = displace_multi2d(bld.new_circle(0.2), [(0.5, 0), (-0.5, 0)])
    d = dm.evaluate(np.array([[0.5, 0], [-0.5, 0], [0, 0]], np.float32))
    np.testing.assert_allclose(d[:2], -0.2, atol=1e-6)
    assert d[2] > 0


def test_block_cached_sdf3():
    sdf = new_cpu_sdf3(bld.new_sphere(1.0))
    cached = BlockCachedSDF3(sdf, 0.1, 0.1, 0.1)
    pts = np.random.default_rng(1).uniform(-1, 1, (256, 3)).astype(np.float32)
    d1 = cached.evaluate(pts)
    d2 = cached.evaluate(pts)  # all hits; cached per voxel block, so values
    # may come from a neighboring point in the same block (reference
    # BlockCachedSDF3 semantics) — bounded by the block diagonal
    np.testing.assert_allclose(d1, d2, atol=0.1 * np.sqrt(3))
    assert cached.cache_hits() >= 256
    assert cached.evaluations() == 512
    # coordinates outside the 21-bit-per-axis key space (here: a point
    # far more than 2^20 voxels below bb.min) bypass the cache — the
    # packed key would bleed into the neighboring axis field and could
    # COLLIDE with a legitimate voxel, returning a wrong cached value
    far = np.array([[-200000.0, 0.0, 0.0]], np.float32)
    hits0 = cached.cache_hits()
    df1 = cached.evaluate(far)
    df2 = cached.evaluate(far)  # NOT a hit: never stored, re-evaluated
    np.testing.assert_allclose(df1, df2)
    np.testing.assert_allclose(df1[0], 200000.0 - 1.0, rtol=1e-5)
    assert cached.cache_hits() == hits0


def test_cached_exact_sdf3():
    """Exact-position cache (reference cachedExactSDF3,
    gleval/gleval.go:220-292): a hit requires bit-identical coordinates
    and returns the exact previous value; nearby-but-different points
    miss (unlike the voxel-quantized BlockCachedSDF3)."""
    from gsdf_tpu.eval import CachedExactSDF3

    sdf = new_cpu_sdf3(bld.new_sphere(1.0))
    cached = CachedExactSDF3(sdf)
    pts = np.random.default_rng(2).uniform(-1, 1, (256, 3)).astype(np.float32)
    d1 = cached.evaluate(pts)
    assert cached.cache_hits() == 0
    d2 = cached.evaluate(pts)  # bit-identical positions: all hits, exact
    np.testing.assert_array_equal(d1, d2)
    assert cached.cache_hits() == 256
    assert cached.evaluations() == 512
    # a 1-ulp nudge on x misses the cache
    nudged = pts.copy()
    nudged[:, 0] = np.nextafter(nudged[:, 0], np.float32(np.inf))
    cached.evaluate(nudged)
    assert cached.cache_hits() == 256
    # duplicate rows within one batch: the reference does a FULL lookup
    # pass before evaluating any miss (gleval.go:241-266), so in-batch
    # duplicates of a NEW position are ALL misses — every duplicate row
    # re-evaluates, hits += len(pos) - len(seekPos) (gleval.go:287)
    dup = np.repeat(pts[:4], 3, axis=0)  # already cached: all 12 hit
    hits0 = cached.cache_hits()
    np.testing.assert_array_equal(cached.evaluate(dup), np.repeat(d1[:4], 3))
    assert cached.cache_hits() == hits0 + 12
    fresh = np.random.default_rng(3).uniform(2, 3, (4, 3)).astype(np.float32)
    dupf = np.repeat(fresh, 3, axis=0)  # 12 rows, 4 new positions: 0 hits
    hits0 = cached.cache_hits()
    df = cached.evaluate(dupf)
    np.testing.assert_array_equal(df, np.repeat(df[::3], 3))
    assert cached.cache_hits() == hits0
    # ... and a second pass over the same rows is now all hits
    hits0 = cached.cache_hits()
    np.testing.assert_array_equal(cached.evaluate(dupf), df)
    assert cached.cache_hits() == hits0 + 12
    np.testing.assert_array_equal(cached.bounds().min, sdf.bounds().min)
    np.testing.assert_array_equal(cached.bounds().max, sdf.bounds().max)


def test_minecraft_render():
    from gsdf_tpu.render.dual_contour import minecraft_render

    tris = minecraft_render(bld.new_sphere(0.5), 0.1)
    assert len(tris) > 100
    # all triangle vertices lie on the voxel lattice faces
    assert np.all(np.isfinite(tris))
    # faces are axis aligned: each triangle normal is +-1 on one axis
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n = np.abs(n / np.linalg.norm(n, axis=1, keepdims=True))
    assert np.allclose(np.max(n, axis=1), 1.0, atol=1e-6)


def test_colors():
    from gsdf_tpu.pipeline.colors import (
        color_conversion_inigo_quilez,
        color_conversion_linear_gradient,
    )

    d = np.linspace(-1, 1, 64).reshape(8, 8).astype(np.float32)
    img1 = color_conversion_inigo_quilez(0.5)(d)
    img2 = color_conversion_linear_gradient(0, 240, 0.5)(d)
    assert img1.shape == (8, 8, 4) and img1.dtype == np.uint8
    assert img2.shape == (8, 8, 4)
    # gradient endpoints differ
    assert not np.array_equal(img2[0, 0], img2[-1, -1])
    # NaN distances render RED — the IQ palette's bad-field debug flag
    # (reference gsdfaux/color.go:22,31)
    dn = d.copy()
    dn[2, 3] = np.nan
    img3 = color_conversion_inigo_quilez(0.5)(dn)
    np.testing.assert_array_equal(img3[2, 3], (255, 0, 0, 255))
    # non-NaN pixels unchanged
    mask = np.ones((8, 8), bool)
    mask[2, 3] = False
    np.testing.assert_array_equal(img3[mask], img1[mask])


def test_normals_point_outward():
    from gsdf_tpu.eval import normals_central_diff

    sdf = new_cpu_sdf3(bld.new_sphere(1.0))
    pts = np.array([[1, 0, 0], [0, 1, 0], [0, 0, -1]], np.float32)
    n = normals_central_diff(sdf, pts, 1e-3)
    n = n / np.linalg.norm(n, axis=1, keepdims=True)
    np.testing.assert_allclose(n, pts / np.linalg.norm(pts, axis=1, keepdims=True), atol=1e-3)
