"""Dual contour renderer tests (reference glrender/dual_contour_test.go +
glrender_test.go:22-81)."""
import jax
import numpy as np
import pytest

from gsdf_tpu import Builder
from gsdf_tpu.flagships import GOLDEN_DC_BOLT_256_TRIS
from gsdf_tpu.render.dual_contour import DualContourLeastSquares, DualContourRenderer

bld = Builder()


def _watertight(tris, tol=1e-5):
    """Each directed edge must appear exactly once (closed orientable mesh)."""
    q = np.round(tris / tol).astype(np.int64)
    edges = set()
    for t in q:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            e = (tuple(t[a]), tuple(t[b]))
            if e in edges:
                return False  # duplicate directed edge
            edges.add(e)
    # every edge must have its reverse
    for (a, b) in edges:
        if (b, a) not in edges:
            return False
    return True


def _edges_balanced(tris, tol=1e-5):
    """Every directed edge is matched by an equal count of its reverse.

    Weaker than _watertight on purpose: dual contouring places ONE
    vertex per voxel, so thin features (< ~1 voxel) produce non-manifold
    fins where two quads share a directed edge — an inherent method
    limitation (the reference's DC has it too), not a defect. Balance
    still catches holes, dropped quads and winding errors."""
    from collections import Counter

    q = np.round(tris / tol).astype(np.int64)
    edges = Counter()
    for t in q:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            edges[(tuple(t[a]), tuple(t[b]))] += 1
    return all(edges[e] == edges[(e[1], e[0])] for e in edges)


@pytest.mark.parametrize("chiseled", [False, True])
def test_dc_sphere(chiseled):
    s = bld.new_sphere(1.0)
    dc = DualContourRenderer(s, 1 / 12, DualContourLeastSquares(chiseled=chiseled))
    tris = dc.render()
    assert len(tris) > 500
    r = np.linalg.norm(tris.reshape(-1, 3), axis=1)
    assert abs(r.min() - 1) < 0.02 and abs(r.max() - 1) < 0.02
    assert _watertight(tris)


def test_dc_box_sharp_features():
    """DC's selling point: box corners should be recovered near-exactly."""
    s = bld.new_box(1.0, 0.8, 0.6, 0.0)
    dc = DualContourRenderer(s, 0.1, DualContourLeastSquares(chiseled=True))
    tris = dc.render()
    assert len(tris) > 100
    verts = tris.reshape(-1, 3)
    # some vertex should be near each of the 8 corners
    for sx in (-0.5, 0.5):
        for sy in (-0.4, 0.4):
            for sz in (-0.3, 0.3):
                d = np.linalg.norm(verts - [sx, sy, sz], axis=1).min()
                assert d < 0.08, f"corner ({sx},{sy},{sz}) missed by {d}"
    assert _watertight(tris)


def test_dc_nonuniform_part():
    s = bld.difference(
        bld.smooth_union(0.1, bld.new_sphere(0.6), bld.new_cylinder(0.3, 1.4, 0.0)),
        bld.new_cylinder(0.15, 3.0, 0.0),
    )
    dc = DualContourRenderer(s, 0.05)
    tris = dc.render()
    assert len(tris) > 1000
    assert np.all(np.isfinite(tris))


def test_dc_bolt_stl(tmp_path):
    """Full bolt through dual contouring to STL (reference
    glrender_test.go:22-53)."""
    import io

    from gsdf_tpu.forge import threads
    from gsdf_tpu.render.stl import read_binary_stl, write_binary_stl

    b = threads.bolt(
        bld,
        threads.BoltParams(
            thread=threads.ISO(d=3, p=0.5, ext=True),
            style=threads.NutStyle.HEX,
            total_length=5.0,
            shank_length=2.0,
        ),
    )
    res = b.bounds().diagonal() / 64
    tris = DualContourRenderer(b, res, DualContourLeastSquares(chiseled=True)).render()
    assert len(tris) > 1000
    buf = io.BytesIO()
    write_binary_stl(buf, tris)
    buf.seek(0)
    back = read_binary_stl(buf)
    np.testing.assert_array_equal(tris, back)


def test_dc_device_matches_host_oracle():
    """The on-device f32 QEF (default path) against the float64 host
    oracle (reference dual_contour_vertexplacement.go:25-141 semantics):
    identical triangle counts and vertices to f32 round-off in default
    mode. The uniform 1/norm_step row scaling is solution-invariant, so
    any disagreement is solve precision, not semantics."""
    s = bld.difference(
        bld.smooth_union(0.1, bld.new_sphere(0.8), bld.new_box(1.2, 1.2, 0.5, 0.05)),
        bld.new_cylinder(0.3, 4.0, 0.0),
    )
    res = 0.05
    th = DualContourRenderer(s, res, host_qef=True).render()
    td = DualContourRenderer(s, res).render()
    assert len(th) == len(td)
    assert np.abs(th - td).max() < 1e-3 * res


def test_dc_device_matches_host_oracle_chiseled():
    """Chiseled mode (l2 = 1e-5 against O(1) scaled normal rows): on
    planar voxels the QEF solution is ill-determined by DESIGN (the
    regularization is intentionally tiny to let sharp features win), and
    f32 products perturb M by ~1e-6, amplified by 1/l2 — the device and
    f64-oracle vertices legitimately wander within the planar subspace.
    The gates that hold: identical counts/connectivity (the quad
    topology is position-independent), and the same on-surface quality
    |sdf(vertex)| as the oracle."""
    from gsdf_tpu.eval import new_cpu_sdf3

    s = bld.difference(
        bld.smooth_union(0.1, bld.new_sphere(0.8), bld.new_box(1.2, 1.2, 0.5, 0.05)),
        bld.new_cylinder(0.3, 4.0, 0.0),
    )
    res = 0.05
    c = DualContourLeastSquares(chiseled=True)
    th = DualContourRenderer(s, res, c, host_qef=True).render()
    td = DualContourRenderer(s, res, c).render()
    assert len(th) == len(td)
    sdf = new_cpu_sdf3(s)
    dh = np.abs(sdf.evaluate(th.reshape(-1, 3)))
    dd = np.abs(sdf.evaluate(td.reshape(-1, 3)))
    # same on-surface quality: q99 within 20% of the oracle's, max
    # bounded by the oracle's max plus half a voxel
    assert np.quantile(dd, 0.99) <= np.quantile(dh, 0.99) * 1.2 + 0.05 * res
    assert dd.max() <= dh.max() + 0.5 * res


def _bolt_scene():
    """The bolt example scene (examples/bolt.py, reference
    examples/bolt/main.go:27-40) and its resdiv-256 resolution."""
    import math as _math

    from gsdf_tpu.forge import threads

    L, shank = 8, 3
    m3 = threads.bolt(
        bld,
        threads.BoltParams(
            thread=threads.ISO(d=3, p=0.5, ext=True),
            style=threads.NutStyle.HEX,
            total_length=L + shank,
            shank_length=shank,
        ),
    )
    m3 = bld.rotate(m3, 2.5 * _math.pi / 2, (1, 0, 0.1))
    return m3, m3.bounds().diagonal() / 256


def test_dc_bolt_golden_count():
    """Golden DC anchor: the bolt scene at resdiv 256 produces EXACTLY
    99,844 triangles (flagships.GOLDEN_DC_BOLT_256_TRIS) on the CPU
    backend, identically on the device-QEF and host-oracle paths,
    bit-stable across renders. The accelerator's own exact anchor is
    test_dc_bolt_golden_count_accel below."""
    import jax

    cpu = jax.devices("cpu")[0]
    m3, res = _bolt_scene()
    t1 = DualContourRenderer(m3, res, device=cpu).render()
    assert len(t1) == GOLDEN_DC_BOLT_256_TRIS
    t2 = DualContourRenderer(m3, res, device=cpu).render()
    np.testing.assert_array_equal(t1, t2)  # bit-stable
    th = DualContourRenderer(m3, res, device=cpu, host_qef=True).render()
    assert len(th) == GOLDEN_DC_BOLT_256_TRIS


@pytest.mark.gpu
def test_dc_bolt_golden_count_accel(gpu_device):
    """On the GPU the SAME scene yields EXACTLY the same 99,844
    triangles as the CPU oracle — DC counts are backend-invariant, and
    bit-stable from run to run (the QEF row sums avoid atomics,
    dual_contour.sorted_segment_sum). Transform/Rotation2D rotate with
    elementwise f32 mul-adds, so no reduced-precision matrix product can
    flip a corner's sign. Any drift is a regression to investigate,
    never a tolerance to widen."""
    m3, res = _bolt_scene()
    t1 = DualContourRenderer(m3, res, device=gpu_device).render()
    assert len(t1) == GOLDEN_DC_BOLT_256_TRIS
    t2 = DualContourRenderer(m3, res, device=gpu_device).render()
    np.testing.assert_array_equal(t1, t2)  # bit-stable on the card


def _fuzz_tree(seed):
    rng = np.random.default_rng(1000 + seed)
    prims = [
        lambda: bld.new_sphere(float(rng.uniform(0.4, 0.9))),
        lambda: bld.new_box(*(float(x) for x in rng.uniform(0.5, 1.1, 3)), 0.0),
        lambda: bld.new_cylinder(
            float(rng.uniform(0.25, 0.5)), float(rng.uniform(0.6, 1.2)), 0.0
        ),
        lambda: bld.new_torus(
            float(rng.uniform(0.5, 0.8)), float(rng.uniform(0.12, 0.22))
        ),
    ]
    t = prims[rng.integers(len(prims))]()
    for _ in range(int(rng.integers(1, 3))):
        other = bld.translate(
            prims[rng.integers(len(prims))](),
            *(float(x) for x in rng.uniform(-0.4, 0.4, 3)),
        )
        k = int(rng.integers(3))
        if k == 0:
            t = bld.union(t, other)
        elif k == 1:
            t = bld.smooth_union(float(rng.uniform(0.05, 0.15)), t, other)
        else:
            t = bld.difference(t, other)
    err = bld.err()
    if err:
        bld.clear_errors()
        return None
    return t


from test_fuzz_paths import _seed_range  # noqa: E402


@pytest.mark.parametrize("seed", _seed_range(6))
def test_dc_fuzz_seeded_trees(seed):
    """DC's differential fuzz gate (a round-3 review finding: DC was the one
    renderer absent from the fuzz battery). DC discretizes differently
    from MC, so the gate is geometric, not triangle identity:
    - watertight edge-manifold mesh,
    - every vertex within a voxel diagonal of the surface,
    - bit-identical output across repeated renders (determinism),
    - device path count == host-oracle count."""
    from gsdf_tpu.eval import new_cpu_sdf3

    t = _fuzz_tree(seed)
    if t is None:
        pytest.skip("builder rejected combination")
    res = float(t.bounds().diagonal()) / 48
    dc = DualContourRenderer(t, res)
    tris = dc.render()
    assert len(tris) > 100
    assert _edges_balanced(tris)
    sdf = new_cpu_sdf3(t)
    d = np.abs(sdf.evaluate(tris.reshape(-1, 3)))
    assert d.max() < res * np.sqrt(3), f"vertex {d.max()/res:.2f} voxels off-surface"
    tris2 = DualContourRenderer(t, res).render()
    np.testing.assert_array_equal(tris, tris2)
    th = DualContourRenderer(t, res, host_qef=True).render()
    assert len(th) == len(tris)


def test_dc_parametric_edit_zero_recompile():
    """render(parametric=True): a rebind edit re-renders through the
    SAME per-structure executable (the compact/pruned paths' editing
    contract, extended to DC)."""
    from gsdf_tpu.core.wrappers import with_bounds
    from gsdf_tpu.geometry import box3
    from gsdf_tpu.render import dual_contour as dcm

    bld2 = Builder()
    boss = bld2.new_cylinder(0.45, 1.2, 0.05)
    body = bld2.smooth_union(0.1, bld2.new_box(1.6, 1.0, 0.5, 0.05), boss)
    pinned = with_bounds(body, box3(-1.2, -0.8, -0.9, 1.2, 0.8, 0.9))
    dc = DualContourRenderer(pinned, 0.06)
    t0 = dc.render(parametric=True)
    n_exec = sum(
        1 for k in dcm._dc_cache if isinstance(k, tuple) and k[0] == "mesh-param"
    )
    pinned.rebind({boss: {"r": 0.3}})
    t1 = DualContourRenderer(pinned, 0.06).render(parametric=True)
    assert (
        sum(
            1
            for k in dcm._dc_cache
            if isinstance(k, tuple) and k[0] == "mesh-param"
        )
        == n_exec
    ), "parametric DC edit compiled a new executable"
    assert len(t1) != len(t0)  # the edit changed the surface
    # the edited parametric render equals a fresh non-parametric render
    t_ref = DualContourRenderer(pinned, 0.06).render()
    assert len(t1) == len(t_ref)
    np.testing.assert_allclose(t1, t_ref, atol=1e-6)


def test_dc_edge_field_grid_size_guard():
    """Edge ids pack into bits 0-30 (bit 31 = winding flip): grids with
    3*nvox >= 2^31 must be rejected, not silently corrupted."""
    import jax
    import pytest

    from gsdf_tpu.render.dual_contour import _dc_edges_fn

    bld2 = Builder()
    s = bld2.new_sphere(1.0)
    with pytest.raises(ValueError, match="edge ids"):
        _dc_edges_fn(s, (900, 900, 900), 1024, 0.01, jax.devices()[0])


def test_dc_qef_analytic_corners():
    """Analytic QEF gates (reference glrender/dual_contour_test.go:20-141,
    TestQEFSolver + TestQEFSolverDiagonalPlanes), run through the REAL
    pipeline instead of a hand-assembled solve:
    - orthogonal planes: a box corner voxel's edge crossings are exactly
      the constraints {x=cx, y=cy, z=cz}; the chiseled QEF must recover
      the corner EXACTLY (measured 0.0 — linear interpolation and
      central differences are exact on planar faces, and the 3x3 solve
      is full-rank). Gate 1e-4 in units (res 0.1).
    - diagonal planes: a rotated box; corner voxels whose edges see all
      three faces recover the corner; the worst corner is bounded by
      voxel discretization (a corner voxel may see only 2 faces, and
      its QEF is then ill-determined along the shared edge direction —
      the bias point anchors it, up to ~a voxel off along that edge).
      PER-BACKEND bound, like the DC bolt golden: f32 transcendental
      rounding in the rotation shifts WHICH edges cross at the worst
      corner, so the CPU oracle's worst corner lands in a 3-face voxel
      (gate 0.6 voxels) while an accelerator's may land in a 2-face
      voxel (gate 1.2 voxels, bit-stable per backend). The
      orthogonal-exact gate above is backend-independent.
    - chiseled mode must strictly beat default mode at corners (the
      reference's reason the mode exists)."""
    import math as _math

    s = bld.new_box(1.0, 0.8, 0.6, 0.0)
    corners = np.array(
        [
            [sx, sy, sz]
            for sx in (-0.5, 0.5)
            for sy in (-0.4, 0.4)
            for sz in (-0.3, 0.3)
        ]
    )

    def worst_miss(tree, cs, chiseled, res=0.1):
        dc = DualContourRenderer(
            tree, res, DualContourLeastSquares(chiseled=chiseled)
        )
        verts = dc.render().reshape(-1, 3)
        return max(np.linalg.norm(verts - c, axis=1).min() for c in cs)

    # orthogonal planes: exact recovery
    assert worst_miss(s, corners, chiseled=True) < 1e-4
    # chiseled strictly beats the default at sharp features
    assert worst_miss(s, corners, chiseled=False) > 0.01

    # diagonal planes: rotated box
    ang, axis = 0.35, np.array([1.0, 0.5, 0.25])
    rot = bld.rotate(s, ang, tuple(axis))
    axis = axis / np.linalg.norm(axis)
    K = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    R = np.eye(3) + _math.sin(ang) * K + (1 - _math.cos(ang)) * (K @ K)
    gate = 0.06 if jax.devices()[0].platform == "cpu" else 0.12
    assert worst_miss(rot, corners @ R.T, chiseled=True, res=0.1) < gate


def test_dc_native_finish_matches_numpy_oracle(monkeypatch):
    """The native quad emission (native.gsdf_dc_finish, both rank
    backends) must reproduce finish_dc_mesh_numpy BIT-FOR-BIT — same
    triangles, same order, same block sizes — on a part whose edges
    also touch the grid boundary (partial quads dropped)."""
    from gsdf_tpu import native as nat
    from gsdf_tpu.render import dual_contour as dcm

    if nat.get_lib() is None:
        pytest.skip("native library unavailable")
    s = bld.difference(
        bld.smooth_union(
            0.1, bld.new_sphere(0.6), bld.new_box(1.0, 1.0, 0.4, 0.05)
        ),
        bld.new_cylinder(0.25, 3.0, 0.0),
    )
    captured = {}
    orig = dcm.finish_dc_mesh

    def spy(*a):
        captured["args"] = a
        return orig(*a)

    monkeypatch.setattr(dcm, "finish_dc_mesh", spy)
    tris = DualContourRenderer(s, 0.05).render()
    a = captured["args"]
    offs = np.array([dcm._OFFS[x] for x in range(3)], np.int32)
    tn, bn = dcm.finish_dc_mesh_numpy(*a)
    np.testing.assert_array_equal(tn, tris)  # render used an equal path
    for force_sort in (False, True):  # bitmap rank + sorted-table rank
        tc, bc = nat.dc_finish(*a, offs, force_sort=force_sort)
        assert bn == bc
        np.testing.assert_array_equal(tn, tc)


def test_dc_native_finish_voxel_mismatch_raises():
    """A corrupt payload (derived voxel table != kernel count) must
    raise in the native path exactly like the numpy oracle — never
    truncate."""
    from gsdf_tpu import native as nat
    from gsdf_tpu.render import dual_contour as dcm

    if nat.get_lib() is None:
        pytest.skip("native library unavailable")
    offs = np.array([dcm._OFFS[x] for x in range(3)], np.int32)
    verts = np.zeros((8, 3), np.float32)
    eax = np.array([2], np.int64)  # z edge at (1,1,1) of a 3^3 grid
    lin = np.array([(1 * 3 + 1) * 3 + 1], np.int64)
    flips = np.array([False])
    with pytest.raises(RuntimeError, match="voxel-count mismatch"):
        nat.dc_finish(verts, eax, lin, flips, 3, 3, 3, 99, offs)
    with pytest.raises(RuntimeError, match="voxel-count mismatch"):
        dcm.finish_dc_mesh_numpy(verts, eax, lin, flips, 3, 3, 3, 99)
    # out-of-range edge axis / voxel id (bit-flipped delta stream) must
    # fail cleanly in the native path, never write past the rank tables
    for bad_eax, bad_lin in (([7], [13]), ([2], [27]), ([2], [-1])):
        with pytest.raises(RuntimeError, match="out of range"):
            nat.dc_finish(
                verts, np.array(bad_eax, np.int64),
                np.array(bad_lin, np.int64), flips, 3, 3, 3, 8, offs,
            )


def test_dc_auto_chunk_route_bitexact(monkeypatch):
    """Grids past DualContourRenderer.mono_voxels (the XLA compile wall)
    must auto-route through the slab-chunk composition and reproduce the
    monolithic render BIT-FOR-BIT (the chunked path's payload identity),
    keeping the evaluations() contract populated."""
    s = bld.difference(
        bld.smooth_union(
            0.1, bld.new_sphere(0.7), bld.new_box(1.1, 1.1, 0.5, 0.05)
        ),
        bld.new_cylinder(0.25, 3.0, 0.0),
    )
    res = 0.05
    mono = DualContourRenderer(s, res)
    t_mono = mono.render()
    auto = DualContourRenderer(s, res)
    monkeypatch.setattr(DualContourRenderer, "mono_voxels", 1000)
    monkeypatch.setattr(
        DualContourRenderer, "chunk_points",
        (auto.nx + 2) * (auto.ny + 2) * 8,
    )
    t_auto = auto.render()
    np.testing.assert_array_equal(t_auto, t_mono)
    assert auto.evaluations() > 0
