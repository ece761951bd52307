"""GPU-vs-CPU-oracle parity. `gpu`-marked: these run on a card
(`GSDF_TEST_GPU=1 python -m pytest tests -m gpu -p no:xdist`) and skip
elsewhere; examples/acceptance.py is the full on-device harness."""
import numpy as np
import pytest

import jax

pytestmark = pytest.mark.gpu


def test_cross_device_distances(gpu_device):
    from gsdf_tpu import Builder
    from gsdf_tpu.eval import new_sdf3

    bld = Builder()
    s = bld.smooth_difference(
        0.1,
        bld.union(bld.new_sphere(0.6), bld.new_box(0.8, 0.5, 0.9, 0.05)),
        bld.new_cylinder(0.2, 3.0, 0.0),
    )
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.2, 1.2, (4096, 3)).astype(np.float32)
    d_cpu = new_sdf3(s, jax.devices("cpu")[0]).evaluate(pts)
    d_acc = new_sdf3(s, gpu_device).evaluate(pts)
    # reference CPU<->GPU tolerance is 5e-3 (gsdf_test.go:529); ours is ulps
    np.testing.assert_allclose(d_acc, d_cpu, atol=5e-3)
    assert np.max(np.abs(d_acc - d_cpu)) < 1e-5


def test_render_paths_agree_on_device(gpu_device):
    from gsdf_tpu import Builder
    from gsdf_tpu.render.flat import FlatRenderer

    bld = Builder()
    s = bld.new_sphere(0.7)
    fr = FlatRenderer(s, 0.05, device=gpu_device)
    tris = fr.render()
    verts, idx = fr.render_indexed()
    assert len(idx) == len(tris)


def test_dc_count_backend_invariant(gpu_device):
    """DC triangle counts are backend-invariant: the same rotated scene
    (rotation exercises Transform.distance, whose rotation is written as
    elementwise f32 mul-adds, core/ops3.py, so no reduced-precision
    matrix product can flip a corner's sign) renders the SAME count on
    the CPU oracle and the GPU. The flagship anchor is
    test_dual_contour.py::test_dc_bolt_golden_count_accel (bolt
    resdiv-256 == 99,844 on both backends)."""
    import math

    from gsdf_tpu import Builder
    from gsdf_tpu.render.dual_contour import DualContourRenderer

    bld = Builder()
    s = bld.smooth_union(0.12, bld.new_torus(0.7, 0.22), bld.new_box(0.9, 0.4, 0.6, 0.05))
    s = bld.rotate(s, 2.5 * math.pi / 2, (1, 0, 0.1))
    res = s.bounds().diagonal() / 96
    t_cpu = DualContourRenderer(s, res, device=jax.devices("cpu")[0]).render()
    t_acc = DualContourRenderer(s, res, device=gpu_device).render()
    assert len(t_cpu) == len(t_acc)


def test_compact_path_on_device_matches_cpu(gpu_device):
    """The production compact path on the GPU must produce the same
    triangle count as the CPU oracle render AND bit-identical
    connectivity to the on-device welded path."""
    from gsdf_tpu import Builder
    from gsdf_tpu.render.flat import FlatRenderer

    bld = Builder()
    s = bld.smooth_union(0.15, bld.new_torus(0.7, 0.2), bld.new_sphere(0.5))
    res = s.bounds().diagonal() / 64
    cv, ct = FlatRenderer(s, res, device=gpu_device).render_compact()
    wv, wt = FlatRenderer(s, res, device=gpu_device).render_indexed()
    np.testing.assert_array_equal(ct, wt)
    tris_cpu = FlatRenderer(s, res, device=jax.devices("cpu")[0]).render()
    assert len(ct) == len(tris_cpu)
