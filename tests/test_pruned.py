"""Pruned renderer: exact triangle-set parity with the flat renderer and
pruning statistics (reference octree renderer counterpart)."""
import numpy as np
import pytest

from gsdf_tpu import Builder
from gsdf_tpu.render.flat import FlatRenderer
from gsdf_tpu.render.pruned import PrunedRenderer, render_all

bld = Builder()


def _sorted_rows(tris):
    rows = np.ascontiguousarray(tris.reshape(-1, 9))
    order = np.lexsort(rows.T[::-1])
    return rows[order]


def test_pruned_matches_flat():
    s = bld.difference(
        bld.smooth_union(0.1, bld.new_sphere(0.8), bld.new_box(1.2, 1.2, 0.5, 0.05)),
        bld.new_cylinder(0.3, 4.0, 0.0),
    )
    res = 0.05
    pr = PrunedRenderer(s, res, tile_size=8, tiles_per_batch=256)
    tris_p = pr.render()
    fr = FlatRenderer(s, res)
    tris_f = fr.render()
    assert len(tris_p) == len(tris_f)
    # BIT-identical triangle sets (round 5): the canonical shared eval
    # loop (ops.mc_emit.canonical_grid_eval) makes the tile-atlas grid
    # values equal the dense kernel's on CPU, and the shared emit
    # pipeline does the rest — the historical fusion-ulp tolerance here
    # is retired along with test_pruned_compact_payload_matches_dense's.
    np.testing.assert_array_equal(_sorted_rows(tris_p), _sorted_rows(tris_f))
    # pruning must actually skip evaluations
    assert pr.total_pruned() > 0
    assert pr.evaluations() < fr.evaluations() * 1.5


def test_pruned_streaming():
    s = bld.new_sphere(0.8)
    pr = PrunedRenderer(s, 0.05, tiles_per_batch=64)
    batches = list(pr.read_triangles())
    assert len(batches) >= 1
    total = sum(len(b) for b in batches)
    assert total == len(FlatRenderer(s, 0.05).render())


def test_render_all_helper():
    s = bld.new_sphere(0.5)
    pr = PrunedRenderer(s, 0.06)
    tris = render_all(pr)
    assert len(tris) > 100


def test_pruned_compact_payload_matches_dense():
    """The tile-pruned compact payload must equal the dense compact-field
    payload exactly (ids, cases, tvals) — merge_compact_payloads restores
    global cube order; tile survival covers every active cube."""
    from gsdf_tpu.ops.compact_field import compact_field_render
    import jax

    s = bld.difference(
        bld.smooth_union(0.1, bld.new_sphere(0.8), bld.new_box(1.2, 1.2, 0.5, 0.05)),
        bld.new_cylinder(0.3, 4.0, 0.0),
    )
    res = 0.05
    # tile size 8 does NOT divide this part's grid: edge tiles overhang
    pr = PrunedRenderer(s, res, tile_size=8, tiles_per_batch=256)
    ids_p, cases_p, t_p = pr.compact_payload()

    fr = FlatRenderer(s, res)
    dev = jax.devices()[0]
    nk, nj, ni = fr.nz + 1, fr.ny + 1, fr.nx + 1
    ids_d, cases_d, t_d, _ = compact_field_render(
        s, fr.origin, fr.res, (nk, nj, ni), dev
    )
    np.testing.assert_array_equal(ids_p, ids_d)
    np.testing.assert_array_equal(cases_p, cases_d)
    # t is BIT-EXACT too (round 5): every MC kernel shape routes its CPU
    # grid eval through ops.mc_emit.canonical_grid_eval — one compiled
    # eval loop over a materialized flat (N,3) index buffer — so the
    # tile-atlas values cannot drift from the dense kernel's. The
    # historical <=32-ulp carve-out (LLVM FMA-contraction differences
    # between the (T,9,9,9) and (nk,nj,ni) fused loops) is retired.
    np.testing.assert_array_equal(t_p, t_d)
    # pruning actually skipped fine evaluations
    assert pr.total_pruned() > 0


@pytest.mark.gpu
def test_pruned_compact_payload_bitexact_accel(gpu_device):
    """On the GPU the pruned tile-atlas payload (ids, cases AND t)
    bit-matches the dense compact payload through the FUSED synthesis
    path: XLA:GPU compiles each element's math the same way whatever the
    array's shape, unlike the CPU backend's vectorized loops, which is
    why only the CPU routes through mc_emit.canonical_grid_eval. This
    gate is the standing evidence for that asymmetry."""
    from gsdf_tpu.ops.compact_field import compact_field_render

    s = bld.difference(
        bld.smooth_union(0.1, bld.new_sphere(0.8), bld.new_box(1.2, 1.2, 0.5, 0.05)),
        bld.new_cylinder(0.3, 4.0, 0.0),
    )
    res = 0.05
    pr = PrunedRenderer(s, res, tile_size=8, tiles_per_batch=256, device=gpu_device)
    ids_p, cases_p, t_p = pr.compact_payload()
    fr = FlatRenderer(s, res, device=gpu_device)
    nk, nj, ni = fr.nz + 1, fr.ny + 1, fr.nx + 1
    ids_d, cases_d, t_d, _ = compact_field_render(
        s, fr.origin, fr.res, (nk, nj, ni), gpu_device
    )
    np.testing.assert_array_equal(ids_p, ids_d)
    np.testing.assert_array_equal(cases_p, cases_d)
    np.testing.assert_array_equal(t_p, t_d)


def test_pruned_render_compact_mesh():
    """render_compact: same mesh as the dense production path."""
    s = bld.smooth_union(0.2, bld.new_sphere(0.6), bld.new_box(1.0, 0.7, 0.4, 0.0))
    res = 0.04
    verts_p, tri_p = PrunedRenderer(s, res, tiles_per_batch=128).render_compact()
    verts_d, tri_d = FlatRenderer(s, res).render_compact()
    assert len(tri_p) == len(tri_d)
    np.testing.assert_array_equal(tri_p, tri_d)
    np.testing.assert_allclose(verts_p, verts_d, atol=1e-6)


def test_empty_bounds_tree_rejected_everywhere():
    """Intersection of disjoint parts yields an inverted (empty) bounds
    box. Every renderer must reject it with the reference's loud error
    (flatrenderer.go:54 / octreerenderer.go:232 "resolution not fine
    enough") instead of crashing in grid setup — found by the 60-seed
    fuzz marathon (pruned seed 45 segfaulted the coarse-grid iota with a
    negative dimension before this guard)."""
    import jax

    from gsdf_tpu.parallel import make_mesh, render_sharded, render_sharded_compact
    from gsdf_tpu.parallel.sharded_dc import render_dc_sharded
    from gsdf_tpu.render.dual_contour import DualContourRenderer

    bld2 = Builder()
    t = bld2.intersection(
        bld2.new_sphere(0.4),
        bld2.translate(bld2.new_sphere(0.4), 3.0, 0.0, 0.0),
    )
    assert t.bounds().is_empty()
    mesh = make_mesh(jax.devices("cpu")[:2])
    with pytest.raises(ValueError, match="not fine enough"):
        FlatRenderer(t, 0.05)
    with pytest.raises(ValueError, match="not fine enough"):
        PrunedRenderer(t, 0.05)
    with pytest.raises(ValueError, match="not fine enough"):
        DualContourRenderer(t, 0.05)
    with pytest.raises(ValueError, match="not fine enough"):
        render_sharded(t, mesh, 0.05)
    with pytest.raises(ValueError, match="not fine enough"):
        render_sharded_compact(t, mesh, 0.05)
    with pytest.raises(ValueError, match="not fine enough"):
        render_dc_sharded(t, mesh, 0.05)
