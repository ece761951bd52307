"""Flagship-part golden triangle counts, test-enforced.

The reference publishes exact counts for its README benchmark parts
(README.md:116,152); sphere 41072 is locked in test_render_golden.py and
these lock the other two. A perf 'optimization' that breaks count parity
must fail here (and in bench.py's hard assert), mirroring the reference's
golden-count discipline (glrender/glrender_test.go:83-102).

Full-resolution renders on the CPU oracle — marked slow; run with
`pytest -m slow` (examples/acceptance.py covers the on-device variant).
"""
import numpy as np
import pytest

from gsdf_tpu.flagships import (
    GOLDEN_DC_BOLT_256_TRIS,
    GOLDEN_FLANGE_TRIS as GOLDEN_FLANGE,  # resdiv 400 (reference README.md:116)
    GOLDEN_SHOWERHEAD_TRIS as GOLDEN_SHOWERHEAD,  # resdiv 350 (README.md:152)
)
from gsdf_tpu.render.flat import FlatRenderer

GOLDEN_FLANGE_RES = 0.21679485


@pytest.mark.slow
def test_flange_golden_count():
    from gsdf_tpu.flagships import build_flange

    obj = build_flange()
    res = obj.bounds().diagonal() / 400
    assert np.isclose(res, GOLDEN_FLANGE_RES, rtol=1e-6)
    fr = FlatRenderer(obj, res)
    verts, tri_idx = fr.render_compact()
    assert len(tri_idx) == GOLDEN_FLANGE
    # the soup path must agree with the compact path
    tris = FlatRenderer(obj, res).render()
    assert len(tris) == GOLDEN_FLANGE


@pytest.mark.slow
def test_showerhead_golden_count():
    from gsdf_tpu.flagships import build_showerhead

    obj = build_showerhead()
    res = obj.bounds().diagonal() / 350
    fr = FlatRenderer(obj, res)
    verts, tri_idx = fr.render_compact()
    assert len(tri_idx) == GOLDEN_SHOWERHEAD


@pytest.mark.slow
def test_flange_sharded_golden():
    """The flagship part through the 8-device sharded production path:
    golden count AND bit-identical connectivity vs single device. Slab
    padding, halo recompute and id-offset arithmetic are scale/aspect-
    ratio sensitive — the toy parts in test_parallel.py can't catch what
    a 281x281x85 grid can (reference discipline:
    glrender/glrender_test.go:83-102, applied to the scale-out path)."""
    import jax

    from gsdf_tpu.flagships import build_flange
    from gsdf_tpu.parallel.sharded import make_mesh, render_sharded_compact

    obj = build_flange()
    res = obj.bounds().diagonal() / 400
    mesh = make_mesh(jax.devices("cpu")[:8])
    sv, st = render_sharded_compact(obj, mesh, res)
    assert len(st) == GOLDEN_FLANGE
    cv, ct = FlatRenderer(obj, res, device=jax.devices("cpu")[0]).render_compact()
    np.testing.assert_array_equal(st, ct)
    np.testing.assert_allclose(sv, cv, atol=1e-6)


@pytest.mark.slow
def test_showerhead_sharded_golden():
    """Second flagship part sharded: golden count + connectivity parity
    (deep tree: 130-hole fibonacci union + buttress screw + knurl)."""
    import jax

    from gsdf_tpu.flagships import build_showerhead
    from gsdf_tpu.parallel.sharded import make_mesh, render_sharded_compact

    obj = build_showerhead()
    res = obj.bounds().diagonal() / 350
    mesh = make_mesh(jax.devices("cpu")[:8])
    sv, st = render_sharded_compact(obj, mesh, res)
    assert len(st) == GOLDEN_SHOWERHEAD
    cv, ct = FlatRenderer(obj, res, device=jax.devices("cpu")[0]).render_compact()
    np.testing.assert_array_equal(st, ct)
    np.testing.assert_allclose(sv, cv, atol=1e-6)


@pytest.mark.slow
def test_dc_bolt_sharded_golden():
    """The DC flagship anchor through the 8-device sharded path: the
    bolt example scene at resdiv 256 must produce EXACTLY the CPU
    golden 99,844 triangles, bit-identical to the single-device
    device-QEF render (test_dual_contour.py pins the single-device
    golden; this pins the scale-out path at production scale — a
    172x167x103 grid crosses every slab)."""
    import jax

    from gsdf_tpu.parallel import render_dc_sharded
    from gsdf_tpu.render.dual_contour import DualContourRenderer
    from tests.test_dual_contour import _bolt_scene

    m3, res = _bolt_scene()
    from gsdf_tpu.parallel.sharded import make_mesh

    mesh = make_mesh(jax.devices("cpu")[:8])
    t_sharded = render_dc_sharded(m3, mesh, res)
    assert len(t_sharded) == GOLDEN_DC_BOLT_256_TRIS
    t_single = DualContourRenderer(
        m3, res, device=jax.devices("cpu")[0]
    ).render()
    np.testing.assert_array_equal(t_sharded, t_single)
