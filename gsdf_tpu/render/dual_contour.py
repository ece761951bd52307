"""Dual contouring renderer (reference glrender/dual_contour.go +
dual_contour_vertexplacement.go).

Device-native restructuring:
- The reference evaluates 4 points per voxel (origin + 3 edge ends,
  dual_contour.go:93-99). Here ONE dense corner grid eval serves every
  voxel: the voxel's origin/edge-end distances are just neighboring grid
  entries — 4x fewer SDF evaluations.
- Active edges are detected by sign-BIT difference (dual_contour.go:262,
  signbit semantics preserved for -0), vectorized over the 3 edge-direction
  grids.
- Normals at edge crossings come from batched central differences on device
  (gleval.NormalsCentralDiff port).
- The per-voxel least-squares vertex placement (QEF) is assembled and
  solved VECTORIZED on host in float64 — the same normalized-voxel
  formulation, regularization sqrt(1e-5), [-0.1, 1.1] clamp and duplicate
  own-edge rows as the reference (dual_contour_vertexplacement.go:25-141).
- Quad emission per active edge with winding flip by edge direction
  (dual_contour.go:152-217).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.node import Shader3D
from ..eval import evaluator as ev

_f32 = np.float32

_dc_cache: dict = {}


def _dc_edges_fn(tree, shape, a_size, norm_step, device):
    """Compiled (origin, res) -> packed f32 buffer
    [n_edges, idw (a_size), t (a_size), normals (3*a_size)]: the COMPACTED
    active-edge field WITH central-difference normals at the crossings.

    idw = axis*nvox + voxel_linear_id, bit 31 = winding-flip
    ((edge_end - origin) < 0, dual_contour.go:273-275); t = -d0/(dend-d0);
    normals follow gleval.NormalsCentralDiff (6 evals per crossing, step/2
    offsets) computed ON the compacted set in the same dispatch. One
    dispatch, one surface-sized fetch — neither the dense distance grid
    nor the crossing-point batch ever crosses the link."""
    key = (tree.tree_hash(), tuple(shape), a_size, _f32(norm_step), device)
    fn = _dc_cache.get(key)
    if fn is not None:
        return fn
    nk, nj, ni = (int(x) for x in shape)
    nz, ny, nx = nk - 1, nj - 1, ni - 1
    nvox = nz * ny * nx
    if 3 * nvox >= 1 << 31:
        # edge id packs into bits 0-30 (bit 31 = winding flip) below
        raise ValueError("grid too large for int32 edge ids (3*nvox >= 2^31)")
    A = int(a_size)
    half = _f32(norm_step) * _f32(0.5)

    def impl(origin, res):
        iz = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 0)
        iy = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 1)
        ix = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 2)
        p = jnp.stack(
            [origin[0] + ix * res, origin[1] + iy * res, origin[2] + iz * res],
            axis=-1,
        )
        grid = tree.distance(p)
        d0 = grid[:-1, :-1, :-1]
        dxx = grid[:-1, :-1, 1:]
        dyy = grid[:-1, 1:, :-1]
        dzz = grid[1:, :-1, :-1]
        s0 = jnp.signbit(d0)
        flags = jnp.stack(
            [
                s0 != jnp.signbit(dxx),
                s0 != jnp.signbit(dyy),
                s0 != jnp.signbit(dzz),
            ]
        ).reshape(-1)
        safe = lambda de: jnp.where(de == d0, 1.0, de - d0)  # noqa: E731
        t3 = jnp.stack(
            [-d0 / safe(dxx), -d0 / safe(dyy), -d0 / safe(dzz)]
        ).reshape(-1)
        flip = jnp.stack([(dxx - d0) < 0, (dyy - d0) < 0, (dzz - d0) < 0]).reshape(-1)

        n_edges = jnp.sum(flags.astype(jnp.int32))
        pos = jnp.cumsum(flags.astype(jnp.int32)) - 1
        dest = jnp.where(flags, pos, A)
        ids = jnp.arange(3 * nvox, dtype=jnp.int32) | (
            flip.astype(jnp.int32) << 31
        )
        idw = jnp.zeros((A + 1,), jnp.int32).at[dest].set(ids, mode="drop")[:A]
        tv = jnp.zeros((A + 1,), jnp.float32).at[dest].set(t3, mode="drop")[:A]

        # crossing points of the compacted edges (same arithmetic the host
        # decoder uses: origin + index*res, axis += t*res)
        eid = idw & 0x7FFFFFFF
        eax = eid // nvox
        rem = eid % nvox
        ek = rem // (ny * nx)
        ej = (rem // nx) % ny
        ei = rem % nx
        pt = jnp.stack(
            [
                origin[0] + ei.astype(jnp.float32) * res,
                origin[1] + ej.astype(jnp.float32) * res,
                origin[2] + ek.astype(jnp.float32) * res,
            ],
            axis=-1,
        )
        bump = tv * res
        pt = pt + jnp.stack(
            [
                jnp.where(eax == 0, bump, 0.0),
                jnp.where(eax == 1, bump, 0.0),
                jnp.where(eax == 2, bump, 0.0),
            ],
            axis=-1,
        )
        # central differences (gleval.NormalsCentralDiff port): 6 batched
        # evals over the compacted set — negligible next to the dense grid
        eye = jnp.eye(3, dtype=jnp.float32) * half
        nrm = jnp.stack(
            [
                tree.distance(pt + eye[d]) - tree.distance(pt - eye[d])
                for d in range(3)
            ],
            axis=-1,
        )  # (A,3)

        counts_f = jax.lax.bitcast_convert_type(n_edges[None], jnp.float32)
        idw_f = jax.lax.bitcast_convert_type(idw, jnp.float32)
        return jnp.concatenate([counts_f, idw_f, tv, nrm.reshape(-1)])

    jitted = jax.jit(impl)

    def fn(origin, res, _jitted=jitted, _dev=device):
        with jax.default_device(_dev):
            return _jitted(jax.device_put(np.asarray(origin, _f32), _dev), _f32(res))

    _dc_cache[key] = fn
    return fn


class DualContourLeastSquares:
    """Least-squares vertex placement (reference
    dual_contour_vertexplacement.go:18-23)."""

    def __init__(self, chiseled: bool = False):
        self.chiseled = chiseled

    @property
    def norm_step(self) -> float:
        # reference dual_contour_vertexplacement.go:42-46
        return 1e-4 if self.chiseled else 2e-8

    @property
    def sqrt_lambda(self) -> float:
        if self.chiseled:
            return math.sqrt(1e-5) * self.norm_step
        return math.sqrt(1e-5)


# (di, dj, dk) quad-corner voxel offsets per edge axis
# (reference dual_contour.go edge-neighbor tables :277-293); the 5th
# entry duplicates the own voxel: the reference adds the cube's own
# active-edge rows separately from the neighbor rows, so each edge's own
# voxel receives its row twice (dual_contour_vertexplacement.go:57-63).
_OFFS = {
    0: [(0, -1, -1), (0, 0, -1), (0, 0, 0), (0, -1, 0)],
    1: [(-1, 0, -1), (-1, 0, 0), (0, 0, 0), (0, 0, -1)],
    2: [(-1, -1, 0), (0, -1, 0), (0, 0, 0), (-1, 0, 0)],
}
_OFF5 = {a: _OFFS[a] + [(0, 0, 0)] for a in _OFFS}
# most QEF rows one voxel can receive: its 12 edges once each, plus its 3
# owned edges a second time (the 5th _OFF5 entry)
_MAX_VOXEL_ROWS = 15


def sorted_segment_sum(data, seg_ids, num_segments, max_rows):
    """Deterministic jax.ops.segment_sum for rows sorted by segment.

    seg_ids must be ascending, with at most `max_rows` rows per segment;
    ids >= num_segments are dropped. Each segment's rows are added in row
    order, starting from zero — the order of a sequential scatter-add —
    by `max_rows` gathers, where a scatter-add on the GPU uses atomics
    whose order, and so whose rounding, changes from run to run."""
    n = data.shape[0]
    # materialized rows: a producer fused into the gathers below could be
    # contracted into the adds (FMA), differently in each executable
    data = jax.lax.optimization_barrier(data)
    rows = jnp.arange(n, dtype=jnp.int32)
    prev = jnp.concatenate([jnp.full((1,), -1, seg_ids.dtype), seg_ids[:-1]])
    first = (seg_ids != prev) & (seg_ids < num_segments)
    start = (
        jnp.full((num_segments + 1,), n, jnp.int32)
        .at[jnp.where(first, seg_ids, num_segments)]
        .set(rows, mode="drop")[:num_segments]
    )
    segs = jnp.arange(num_segments, dtype=seg_ids.dtype)
    acc = jnp.zeros((num_segments,) + data.shape[1:], data.dtype)
    for r in range(max_rows):
        row = jnp.minimum(start + r, n - 1)
        ok = (start + r < n) & (seg_ids[row] == segs)
        ok = ok.reshape(ok.shape + (1,) * (data.ndim - 1))
        acc = acc + jnp.where(ok, data[row], 0)
    # materialized sums, as a scatter's output is: the solve that reads
    # them must not be fused (and contracted) into this loop
    return jax.lax.optimization_barrier(acc)


def dc_mesh_emit(
    tree, grid, origin, res, a_size, w_size, e_size, half, inv_step, lam,
    k0=None, n_own=None,
):
    """The ONE dual-contour mesh emit (CLAUDE.md one-emit discipline,
    mirroring ops/mc_emit for marching cubes): active-edge compaction ->
    in-kernel central-difference normals -> edge->voxel scatter (sort +
    sorted segment-sum) -> batched elementwise 3x3 QEF solve -> vertex
    placement -> v2 packed payload. Consumed by the single-device
    pipeline (_dc_mesh_fn) and the multi-chip z-slab path
    (parallel/sharded_dc.py) so the two can never diverge.

    `grid` is the corner-distance grid for this (slab of the) render:
    (n_layers+1, ny+1, nx+1) planes covering edge layers [0, n_layers).
    `n_own` restricts QEF voxel ownership to layers [0, n_own) — the
    sharded path passes n_own = n_layers-1 so its one extra (halo) edge
    layer contributes rows to owned voxels without claiming the next
    shard's voxels; None means every layer is owned (single device).
    `k0` (traced int32 layer offset, or None for zero) globalizes the z
    index in POSITION synthesis only (crossing points, voxel origins,
    bias coordinates) — ids in the payload stay slab-local; the host
    globalizes them with the same offset. Integer layer indices are
    exact in f32, so a sharded voxel's QEF sees bit-identical row values
    to the single-device render of the whole grid."""
    nk, nj, ni = grid.shape
    n_layers, ny, nx = nk - 1, nj - 1, ni - 1
    if n_own is None:
        n_own = n_layers
    nvox = n_layers * ny * nx  # edge-id voxel space (incl. halo layer)
    nz = int(n_own)  # owned-voxel layer count
    A = int(a_size)
    W = int(w_size)
    E = int(e_size)
    if A % 32:
        raise ValueError("a_size must be a multiple of 32 (flip-bit packing)")

    def _gz(idx):
        # global z index for position synthesis (exact in f32: integer
        # layer indices); k0=None keeps the single-device jaxpr free of
        # the (traced, unfoldable) +0 add
        return idx if k0 is None else idx + k0

    d0 = grid[:-1, :-1, :-1]
    dxx = grid[:-1, :-1, 1:]
    dyy = grid[:-1, 1:, :-1]
    dzz = grid[1:, :-1, :-1]
    s0 = jnp.signbit(d0)
    flags = jnp.stack(
        [
            s0 != jnp.signbit(dxx),
            s0 != jnp.signbit(dyy),
            s0 != jnp.signbit(dzz),
        ]
    ).reshape(-1)
    safe = lambda de: jnp.where(de == d0, 1.0, de - d0)  # noqa: E731
    t3 = jnp.stack(
        [-d0 / safe(dxx), -d0 / safe(dyy), -d0 / safe(dzz)]
    ).reshape(-1)
    flip3 = jnp.stack(
        [(dxx - d0) < 0, (dyy - d0) < 0, (dzz - d0) < 0]
    ).reshape(-1)

    # sort-based edge compaction (mc_emit.compact_indices, the block-
    # hierarchical path); the slot value IS the flat edge id, so t/flip
    # follow by two surface-sized gathers
    from ..ops import mc_emit as _mc

    n_edges = jnp.sum(flags.astype(jnp.int32))
    slots = _mc.compact_indices(flags, A)
    valid = slots >= 0
    eid = jnp.maximum(slots, 0)
    tv = jnp.where(valid, t3[eid], 0.0)
    eflip = flip3[eid] & valid

    eax = eid // nvox
    rem = eid % nvox
    ek = rem // (ny * nx)
    ej = (rem // nx) % ny
    ei = rem % nx

    # crossing points
    pt = jnp.stack(
        [
            origin[0] + ei.astype(jnp.float32) * res,
            origin[1] + ej.astype(jnp.float32) * res,
            origin[2] + _gz(ek).astype(jnp.float32) * res,
        ],
        axis=-1,
    )
    bump = tv * res
    pt = pt + jnp.stack(
        [
            jnp.where(eax == 0, bump, 0.0),
            jnp.where(eax == 1, bump, 0.0),
            jnp.where(eax == 2, bump, 0.0),
        ],
        axis=-1,
    )
    # central-difference normals on the compacted set, pre-scaled by
    # 1/norm_step (solution-invariant uniform row scaling, see
    # _dc_mesh_fn). ONE batched distance call over the 6 offset sets: six
    # separate calls would trace the (deep) tree six more times — and
    # compile six copies of it on screw trees — while the concatenated
    # batch costs one extra trace.
    eye = jnp.eye(3, dtype=jnp.float32) * half
    pts6 = jnp.concatenate(
        [pt + eye[0], pt + eye[1], pt + eye[2],
         pt - eye[0], pt - eye[1], pt - eye[2]]
    )  # (6A,3)
    d6 = tree.distance(pts6).reshape(6, A)
    nrm = jnp.stack(
        [(d6[d] - d6[3 + d]) * inv_step for d in range(3)], axis=-1
    )  # (A,3)

    # --- edge -> voxel contributions (A,5) ------------------------
    SENT = nz * ny * nx  # sentinel: sorts after every owned voxel id
    con_vox = []
    for c in range(5):
        di = jnp.select(
            [eax == 0, eax == 1], [_OFF5[0][c][0], _OFF5[1][c][0]],
            _OFF5[2][c][0],
        )
        dj = jnp.select(
            [eax == 0, eax == 1], [_OFF5[0][c][1], _OFF5[1][c][1]],
            _OFF5[2][c][1],
        )
        dk = jnp.select(
            [eax == 0, eax == 1], [_OFF5[0][c][2], _OFF5[1][c][2]],
            _OFF5[2][c][2],
        )
        ii2, jj2, kk2 = ei + di, ej + dj, ek + dk
        ok = (
            valid
            & (ii2 >= 0) & (ii2 < nx)
            & (jj2 >= 0) & (jj2 < ny)
            & (kk2 >= 0) & (kk2 < nz)
        )
        lin = (kk2 * ny + jj2) * nx + ii2
        con_vox.append(jnp.where(ok, lin, SENT))
    con_vox = jnp.stack(con_vox, axis=1).reshape(-1)  # (5A,)

    order = jnp.argsort(con_vox)
    sorted_vox = con_vox[order]
    src_slot = order // 5  # originating edge slot
    prev = jnp.concatenate(
        [jnp.full((1,), -1, sorted_vox.dtype), sorted_vox[:-1]]
    )
    live = sorted_vox != SENT
    uniq = live & (sorted_vox != prev)
    seg = jnp.cumsum(uniq.astype(jnp.int32)) - 1
    n_vox = seg[-1] + 1
    seg_ids = jnp.where(live, seg, W)  # W = drop

    # unique voxel ids, ascending, trailing slots = SENT
    uvox = jnp.full((W + 1,), SENT, jnp.int32).at[
        jnp.where(uniq, seg, W)
    ].set(sorted_vox, mode="drop")[:W]

    # contribution payloads gathered through the sort
    ncon = jnp.where(live[:, None], nrm[src_slot], 0.0)  # (5A,3)
    # q in normalized voxel coords: (pt - origin)/res - voxel index
    vk = sorted_vox // (ny * nx)
    vj = (sorted_vox // nx) % ny
    vi = sorted_vox % nx
    qcon = (pt[src_slot] - origin[None, :]) / res - jnp.stack(
        [vi, vj, _gz(vk)], axis=-1
    ).astype(jnp.float32)
    qcon = jnp.where(live[:, None], qcon, 0.0)
    ndq = jnp.sum(ncon * qcon, axis=-1)  # n . q per row

    payload = jnp.concatenate(
        [
            ncon[:, 0:1] * ncon,                       # xx, xy, xz
            ncon[:, 1:2] * ncon[:, 1:],                # yy, yz
            ncon[:, 2:3] * ncon[:, 2:],                # zz
            ncon * ndq[:, None],                       # Atb
            qcon,                                      # q sums
            live[:, None].astype(jnp.float32),         # count
        ],
        axis=1,
    )  # (5A, 13)
    # Off the CPU not a scatter-add: on the GPU one is atomic, and its
    # order changes from run to run. The CPU keeps the scatter: its sums
    # are bit-identical to sorted_segment_sum's, but after the gathers
    # XLA:CPU fuses (and contracts) the solve below differently in the
    # single-device and the sharded executables, and
    # test_sharded_dc.py::test_dc_sharded_chiseled_bitexact fails.
    sums = jax.lax.platform_dependent(
        payload, seg_ids,
        cpu=lambda d, s: jax.ops.segment_sum(
            d, s, num_segments=W, indices_are_sorted=True
        ),
        default=lambda d, s: sorted_segment_sum(d, s, W, _MAX_VOXEL_ROWS),
    )

    cnt = jnp.maximum(sums[:, 12], 1.0)
    bias = sums[:, 9:12] / cnt[:, None]
    l2 = lam * lam
    axx = sums[:, 0] + l2
    axy = sums[:, 1]
    axz = sums[:, 2]
    ayy = sums[:, 3] + l2
    ayz = sums[:, 4]
    azz = sums[:, 5] + l2
    # solve shifted to the bias point: with x = bias + y the system
    # (M+l2*I)y = Atb - M*bias has ~zero right-hand side along
    # M's (near-)null directions, so the f32 solve returns y ~ 0
    # there (x -> bias, exactly the regularization's intent) instead
    # of amplifying rounding noise by 1/l2 — without this shift the
    # chiseled mode (l2 = 1e-5 against O(1) normal rows) wanders up
    # to the full clamp range on planar voxels
    bx = sums[:, 6] - (
        sums[:, 0] * bias[:, 0] + axy * bias[:, 1] + axz * bias[:, 2]
    )
    by = sums[:, 7] - (
        axy * bias[:, 0] + sums[:, 3] * bias[:, 1] + ayz * bias[:, 2]
    )
    bz = sums[:, 8] - (
        axz * bias[:, 0] + ayz * bias[:, 1] + sums[:, 5] * bias[:, 2]
    )

    # Batched 3x3 symmetric solve via Jacobi eigendecomposition with
    # a spectral floor. An adjugate/Cramer solve is unusable here in
    # f32: for near-rank-1 M (planar voxels) the true determinant
    # ~c*l2^2 sits far below the rounding noise of the cofactor
    # products, and the quotient wanders across the full clamp range
    # on a handful of voxels. Eigenvalues of a symmetric matrix are
    # stable to entry perturbation (Weyl), and for clustered
    # eigenvalues the 1/(lam+l2) weights agree, so eigenvector
    # instability inside a cluster cancels. Directions whose
    # eigenvalue is below the f32 noise floor of M are damped to the
    # bias point (y=0 there) — exactly the regularization's intent.
    # ELEMENTWISE Jacobi: the obvious einsum formulation dispatches
    # batched 3x3 matrix products, which an accelerator may pad onto its
    # matrix unit and run at reduced precision; explicit row/column
    # rotations keep everything elementwise f32.
    tr = axx + ayy + azz
    M = {
        (0, 0): axx, (0, 1): axy, (0, 2): axz,
        (1, 1): ayy, (1, 2): ayz, (2, 2): azz,
    }
    one = jnp.ones_like(axx)
    zero = jnp.zeros_like(axx)
    V = {
        (r, cidx): (one if r == cidx else zero)
        for r in range(3)
        for cidx in range(3)
    }

    def mget(r, cidx):
        return M[(r, cidx)] if r <= cidx else M[(cidx, r)]

    for _sweep in range(5):
        for (pp, qq) in ((0, 1), (0, 2), (1, 2)):
            app = mget(pp, pp)
            aqq = mget(qq, qq)
            apq = mget(pp, qq)
            theta = 0.5 * jnp.arctan2(2.0 * apq, aqq - app)
            cth = jnp.cos(theta)
            sth = jnp.sin(theta)
            rr = 3 - pp - qq  # the untouched index
            arp = mget(rr, pp)
            arq = mget(rr, qq)
            c2, s2, cs = cth * cth, sth * sth, cth * sth
            napp = c2 * app - 2.0 * cs * apq + s2 * aqq
            naqq = s2 * app + 2.0 * cs * apq + c2 * aqq
            # rotated off-diagonal (pp,qq) is ~0 by construction
            napq = cs * (app - aqq) + (c2 - s2) * apq
            narp = cth * arp - sth * arq
            narq = sth * arp + cth * arq
            M[(pp, pp)] = napp
            M[(qq, qq)] = naqq
            M[(pp, qq) if pp <= qq else (qq, pp)] = napq
            M[(min(rr, pp), max(rr, pp))] = narp
            M[(min(rr, qq), max(rr, qq))] = narq
            for r in range(3):
                vp = V[(r, pp)]
                vq = V[(r, qq)]
                V[(r, pp)] = cth * vp - sth * vq
                V[(r, qq)] = sth * vp + cth * vq
    lam3 = [mget(0, 0), mget(1, 1), mget(2, 2)]
    # spectral floor: eigenvalues below the accumulated-f32 noise of
    # M are indistinguishable from zero; l2 already floors the well-
    # conditioned case
    floor = jnp.maximum(l2, 1e-6 * tr)
    rhs = [bx, by, bz]
    # y = V diag(1/(lam+floor)) V^T rhs, expanded elementwise
    t = [
        sum(V[(r, cidx)] * rhs[r] for r in range(3))
        / (jnp.maximum(lam3[cidx], 0.0) + floor)
        for cidx in range(3)
    ]
    y = jnp.stack(
        [sum(V[(r, cidx)] * t[cidx] for cidx in range(3)) for r in range(3)],
        axis=-1,
    )
    x = jnp.clip(bias + y, -0.1, 1.1)
    uk = uvox // (ny * nx)
    uj = (uvox // nx) % ny
    ui = uvox % nx
    vo = jnp.stack([ui, uj, _gz(uk)], axis=-1).astype(jnp.float32) * res
    verts = jnp.where(
        (uvox != SENT)[:, None], origin[None, :] + vo + x * res, 0.0
    )  # (W,3)

    # --- pack: delta-encoded edge ids + flip bits (payload v2) ----
    from ..ops.compact_field import _pack_u8

    prev_e = jnp.concatenate([jnp.zeros((1,), eid.dtype), eid[:-1]])
    delta = jnp.where(valid, eid - prev_e, 0)  # valid is a prefix mask
    esc = valid & (delta >= 255)
    n_exc = jnp.sum(esc.astype(jnp.int32))
    deltas = _pack_u8(jnp.where(esc, 255, delta), valid, A)
    pos = _mc.compact_indices(esc, E)
    evalid = pos >= 0
    psafe = jnp.maximum(pos, 0)
    exc_pos = jnp.where(evalid, psafe, 0).astype(jnp.int32)
    exc_delta = jnp.where(evalid, delta[psafe], 0).astype(jnp.int32)
    fb = (eflip & valid).reshape(A // 32, 32).astype(jnp.uint32)
    flip_words = jnp.sum(
        fb << jnp.arange(32, dtype=jnp.uint32)[None, :],
        axis=1,
        dtype=jnp.uint32,
    )

    counts = jnp.stack(
        [n_edges, n_vox, n_exc, jnp.asarray(2, n_edges.dtype)]
    )
    return jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(counts, jnp.float32),
            verts.reshape(-1),
            jax.lax.bitcast_convert_type(deltas, jnp.float32),
            jax.lax.bitcast_convert_type(flip_words, jnp.float32),
            jax.lax.bitcast_convert_type(exc_pos, jnp.float32),
            jax.lax.bitcast_convert_type(exc_delta, jnp.float32),
        ]
    )


def _dc_mesh_fn(
    tree, shape, a_size, w_size, e_size, norm_step, sqrt_lambda, device,
    parametric=False,
):
    """Compiled (origin, res) -> packed f32 buffer for the FULLY-ON-DEVICE
    dual-contour pipeline: grid eval -> active-edge compaction ->
    in-kernel central-difference normals -> edge->voxel scatter (sort +
    sorted segment-sum) -> batched 3x3 QEF normal-equations solve ->
    vertex placement -> quad corner-slot resolution. One dispatch; the
    fetch is surface-sized (final vertices + per-edge quad indices).

    The QEF semantics match the float64 host oracle (_render_host /
    reference dual_contour_vertexplacement.go:25-141) with ONE
    solution-invariant change: every least-squares row (normal rows AND
    the sqrt(1e-5) regularization rows) is scaled by 1/norm_step.
    Scaling A and b uniformly leaves argmin |Ax-b| unchanged but brings
    the raw step-scaled central differences (magnitude ~norm_step) into
    f32-friendly range for the on-device normal-equations solve.

    Payload v2 layout (the wire format lives ONLY in this pack +
    unpack_dc_mesh_payload below — CLAUDE.md compact-format rule):
    [n_edges, n_vox, n_exc, version=2 (4 bitcast i32),
     verts (3*W f32), edge-id deltas u8 packed 4/word (A/4),
     winding-flip bits packed 32/word (A/32),
     exc_pos (E i32), exc_delta (E i32)].
    The per-edge quad corner-slot table (4 i32/edge) and flag word of
    the v1 layout are NOT shipped: edge ids over the valid prefix are
    ASCENDING (compact_indices contract), so they delta-encode to u8
    with an i32 escape table exactly like the MC compact payload
    (compact_field._pack_payload), and the host re-derives corner slots
    and quad validity from the ids against the SAME ascending unique
    voxel keys the kernel used for vertex slots — dropping the fetch
    from 12W+20A to 12W+~1.1A+8E bytes (~2x on typical surfaces).
    """
    if parametric:
        from ..eval.parametric import structural_hash

        tree.tree_hash()  # pre-cache node hashes before tracer binding
        key = (
            "mesh-param", structural_hash(tree), tuple(shape), a_size,
            w_size, e_size, _f32(norm_step), _f32(sqrt_lambda), device,
        )
    else:
        key = (
            "mesh", tree.tree_hash(), tuple(shape), a_size, w_size,
            e_size, _f32(norm_step), _f32(sqrt_lambda), device,
        )
    fn = _dc_cache.get(key)
    if fn is not None:
        return fn
    nk, nj, ni = (int(x) for x in shape)
    nz, ny, nx = nk - 1, nj - 1, ni - 1
    nvox = nz * ny * nx
    if 3 * nvox >= 1 << 31:
        raise ValueError("grid too large for int32 edge ids (3*nvox >= 2^31)")
    A = int(a_size)
    W = int(w_size)
    E = int(e_size)
    if A % 32:
        raise ValueError("a_size must be a multiple of 32 (flip-bit packing)")
    half = _f32(norm_step) * _f32(0.5)
    inv_step = _f32(1.0) / _f32(norm_step)
    lam = _f32(sqrt_lambda) * inv_step  # scaled regularization row weight

    def impl(origin, res):
        iz = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 0)
        iy = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 1)
        ix = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 2)
        p = jnp.stack(
            [origin[0] + ix * res, origin[1] + iy * res, origin[2] + iz * res],
            axis=-1,
        )
        grid = tree.distance(p)
        return dc_mesh_emit(
            tree, grid, origin, res, A, W, E, half, inv_step, lam
        )

    if parametric:
        from ..eval.parametric import _bind_params, param_spec

        spec = param_spec(tree)

        def impl_param(origin, res, flat):
            with _bind_params(spec, flat):
                return impl(origin, res)

        jitted_p = jax.jit(impl_param)

        def fn(origin, res, params=None, _j=jitted_p, _dev=device):
            with jax.default_device(_dev):
                return _j(
                    jax.device_put(np.asarray(origin, _f32), _dev),
                    _f32(res),
                    jax.device_put(params, _dev),
                )

        _dc_cache[key] = fn
        return fn

    jitted = jax.jit(impl)

    def fn(origin, res, params=None, _jitted=jitted, _dev=device):
        with jax.default_device(_dev):
            return _jitted(jax.device_put(np.asarray(origin, _f32), _dev), _f32(res))

    _dc_cache[key] = fn
    return fn


def unpack_dc_mesh_payload(packed, a_size, w_size, e_size):
    """Host-side unpack of the v2 DC mesh buffer (_dc_mesh_fn) ->
    (verts (W,3) f32, eids (min(n_edges,A),) int64, flips bool,
    (n_edges, n_vox, n_exc)). Edge ids are reconstructed with one cumsum
    over the patched delta stream — bit-identical to the pre-delta ids
    (lossless). Counts may exceed a_size/w_size/e_size (overflow): rows
    are then truncated and the caller must grow-and-retry. The wire
    layout lives ONLY in this pack/unpack pair."""
    packed = np.ascontiguousarray(packed)
    A, W, E = int(a_size), int(w_size), int(e_size)
    hdr = packed[:4].view(np.int32)
    n_edges, n_vox, n_exc, version = (int(x) for x in hdr)
    if version != 2:
        raise ValueError(f"unknown DC mesh payload version {version}")
    ncap = min(n_edges, A)
    off = 4
    verts = packed[off : off + 3 * W].reshape(-1, 3)
    off += 3 * W
    d8 = packed[off : off + A // 4].view(np.uint8)[:ncap]
    off += A // 4
    flip_words = packed[off : off + A // 32].view(np.uint32)
    off += A // 32
    ecap = min(n_exc, E)
    exc_pos = packed[off : off + E].view(np.int32)[:ecap]
    off += E
    exc_delta = packed[off : off + E].view(np.int32)[:ecap]
    deltas = d8.astype(np.int64)
    # escape positions are always < ncap: escapes are a subset of the
    # valid prefix, which saturates at A exactly when ncap does
    deltas[exc_pos] = exc_delta
    eids = np.cumsum(deltas)
    flips = np.unpackbits(
        flip_words.view(np.uint8), bitorder="little"
    )[:ncap].astype(bool)
    return verts, eids, flips, (n_edges, n_vox, n_exc)


def finish_dc_mesh(verts, eax, lin, flips, nx, ny, nz, n_vox):
    """Host-side quad emission shared by the single-device and sharded
    DC paths: native C++ (native.dc_finish / gsdf_dc_finish, threaded —
    the DC counterpart of the MC path's gsdf_mc_decode) with
    finish_dc_mesh_numpy as the bit-exact fallback and oracle (pinned in
    test_dual_contour.py). Returns (tris (T,3,3) f32, block sizes)."""
    from ..native import dc_finish

    offs = np.array([_OFFS[a] for a in range(3)], np.int32)  # (3,4,3)
    out = dc_finish(verts, eax, lin, flips, nx, ny, nz, n_vox, offs)
    if out is not None:
        return out
    return finish_dc_mesh_numpy(verts, eax, lin, flips, nx, ny, nz, n_vox)


def finish_dc_mesh_numpy(verts, eax, lin, flips, nx, ny, nz, n_vox):
    """Numpy quad emission — the oracle the native gsdf_dc_finish path
    must match bit-for-bit: re-derive quad corner slots from the edge
    ids (payload v2) and gather final triangles. Returns
    (tris (T,3,3) f32, block sizes).

    The ascending unique of all in-range corner + own voxel ids is
    EXACTLY the kernel's vertex-slot key array (its uvox is the sorted
    unique of the same in-range contribution set — for the sharded path,
    the concatenation of per-slab uniques over disjoint ascending slab
    ranges), so searchsorted reproduces the kernel's vid table
    bit-for-bit. `eax`/`lin` are the edge axis and the edge's origin-
    voxel linear id in the (nx, ny, nz) voxel space — GLOBAL ids for the
    sharded path; `verts` holds the kernel vertex slots (>= n_vox rows,
    kernel order)."""
    ny_, nx_, nz_ = ny, nx, nz
    ek = lin // (ny_ * nx_)
    ej = (lin // nx_) % ny_
    ei = lin % nx_
    offs = np.array([_OFFS[a] for a in range(3)], np.int64)  # (3,4,3)
    di = offs[eax, :, 0]  # (n,4)
    dj = offs[eax, :, 1]
    dk = offs[eax, :, 2]
    ii2 = ei[:, None] + di
    jj2 = ej[:, None] + dj
    kk2 = ek[:, None] + dk
    in_rng = (
        (ii2 >= 0) & (ii2 < nx_)
        & (jj2 >= 0) & (jj2 < ny_)
        & (kk2 >= 0) & (kk2 < nz_)
    )
    clin = (kk2 * ny_ + jj2) * nx_ + ii2  # (n,4)
    own = (ek * ny_ + ej) * nx_ + ei
    uvox = np.unique(np.concatenate([clin[in_rng], own]))
    if len(uvox) != n_vox:
        raise RuntimeError(
            f"DC payload voxel-count mismatch: derived {len(uvox)} "
            f"!= kernel {n_vox}"
        )
    quad_ok = in_rng.all(axis=1)
    vid = np.searchsorted(uvox, clin)
    verts = np.asarray(verts[:n_vox])

    tris = []
    blocks = []
    # per-axis two-block emission, identical order to the host path
    for a in range(3):
        m = quad_ok & (eax == a)
        if not m.any():
            continue
        quads = verts[vid[m]]  # (E,4,3)
        f = flips[m]
        quads[f] = quads[f][:, ::-1, :]
        tris.append(quads[:, [0, 1, 2], :])
        tris.append(quads[:, [2, 3, 0], :])
        blocks += [int(m.sum())] * 2
    if not tris:
        return np.empty((0, 3, 3), _f32), []
    return np.concatenate(tris, axis=0).astype(_f32), blocks


class DualContourRenderer:
    """Voxel dual contouring to a quad-derived triangle mesh.

    Two QEF backends:
    - device (default): the fully-on-device pipeline (_dc_mesh_fn) —
      batched 3x3 normal-equations solve vmapped over active voxels,
      f32 with uniformly scaled rows (SURVEY §7's prescription); the
      fetch is surface-sized.
    - host_qef=True: the float64 host path matching the reference's MGS
      semantics row-for-row (dual_contour_vertexplacement.go:25-141) —
      the parity oracle the device path is tested against.
    """

    def __init__(
        self,
        s: Shader3D,
        res: float,
        contourer: DualContourLeastSquares | None = None,
        device=None,
        host_qef: bool = False,
    ):
        if res <= 0:
            raise ValueError("invalid dual contour resolution")
        self.s = s
        self.res = _f32(res)
        self.contourer = contourer or DualContourLeastSquares()
        self.device = device if device is not None else jax.devices()[0]
        # reference dual_contour.go:31-33: bounds shifted by -res/2 so voxel
        # origins straddle the surface
        bb = s.bounds().add(np.full(3, -res / 2, _f32))
        sz = bb.size()
        self.nx = int(math.ceil(_f32(sz[0]) / self.res)) + 1
        self.ny = int(math.ceil(_f32(sz[1]) / self.res)) + 1
        self.nz = int(math.ceil(_f32(sz[2]) / self.res)) + 1
        if self.nx <= 1 or self.ny <= 1 or self.nz <= 1:
            # inverted (empty-intersection) or sub-voxel bounds: reject
            # loudly like the reference grid renderers (flatrenderer.go:54)
            raise ValueError("resolution not fine enough for dual contouring")
        self.origin = bb.min
        self._evaluations = 0
        self.host_qef = bool(host_qef)

    def evaluations(self) -> int:
        """Distinct SDF points evaluated — same contract as
        FlatRenderer.evaluations()."""
        return self._evaluations

    def render(self, parametric: bool = False) -> np.ndarray:
        """parametric=True compiles per tree STRUCTURE: a rebind edit
        re-renders through the same executable (zero recompiles; the
        grid stays pinned to construction-time bounds — pin generous
        bounds with core.wrappers.with_bounds before editing). The host
        oracle path has no parametric mode (it is the parity reference,
        not a production path)."""
        if self.host_qef:
            return self._render_host()
        return self._render_device(parametric=parametric)

    # Voxel count above which rendering auto-routes through the
    # slab-chunk composition instead of ONE monolithic DC executable
    # (whose compile time grows steeply with the grid) — one small
    # per-chunk executable re-dispatched down the grid, bit-identical
    # triangles. An unmeasured limit on the GPU: it was set by the
    # compile time of another device.
    mono_voxels = 12_000_000
    # corner-point budget per chunk dispatch on the auto-chunk route
    # (unmeasured on the GPU, like mono_voxels)
    chunk_points = 4_000_000

    def _render_device(self, parametric: bool = False) -> np.ndarray:
        """Fully-on-device pipeline; host work is one fetch plus the
        final quad gather. Grids past `mono_voxels` dispatch the SAME
        emit kernel per z-slab chunk (parallel/sharded_dc.py on a
        1-device mesh) instead of one monolithic executable — the
        compile-wall analog of FlatRenderer.compact_cubes' memory
        gate."""
        from ..ops.marching_cubes import _bucket

        res = float(self.res)
        nk, nj, ni = self.nz + 1, self.ny + 1, self.nx + 1
        nvox = self.nz * self.ny * self.nx
        if nvox > self.mono_voxels:
            from ..parallel.sharded import make_mesh
            from ..parallel.sharded_dc import render_dc_sharded

            mesh = make_mesh([self.device])
            counters: dict = {}
            tris = render_dc_sharded(
                self.s, mesh, res, contourer=self.contourer,
                parametric=parametric,
                max_points_per_shard=self.chunk_points,
                counters=counters,
            )
            self._evaluations += (
                counters["corners"] + 6 * counters["edges"]
            )
            return tris
        if parametric:
            from ..eval.parametric import pack_params, structural_hash

            params = jnp.asarray(pack_params(self.s))
            hint_key = ("mhint-param", structural_hash(self.s), (nk, nj, ni))
        else:
            params = None
            hint_key = ("mhint", self.s.tree_hash(), (nk, nj, ni))
        hint = _dc_cache.get(hint_key)
        if hint is not None:
            a_size, w_size, e_size = hint
        else:
            a_size = _bucket(int(12 * max(nvox, 1) ** (2 / 3)) + 4096)
            w_size = a_size
            e_size = _bucket(max(4096, a_size // 8), granule=4096)
        while True:
            fn = _dc_mesh_fn(
                self.s, (nk, nj, ni), a_size, w_size, e_size,
                self.contourer.norm_step, self.contourer.sqrt_lambda,
                self.device, parametric=parametric,
            )
            packed = np.asarray(fn(self.origin, res, params=params))
            verts, eids, flips, (n_edges, n_vox, n_exc) = (
                unpack_dc_mesh_payload(packed, a_size, w_size, e_size)
            )
            if n_edges <= a_size and n_vox <= w_size and n_exc <= e_size:
                break
            if n_edges > a_size:
                a_size = _bucket(n_edges, granule=16384)
            if n_vox > w_size:
                w_size = _bucket(n_vox, granule=16384)
            if n_exc > e_size:
                e_size = _bucket(n_exc, granule=4096)
        if parametric:
            # parametric edits promise ZERO new executables: keep the
            # sizes exactly as compiled (grow-only via the retry loop)
            _dc_cache[hint_key] = (a_size, w_size, e_size)
        else:
            # warm hint: TIGHT sizes (+25% headroom). The initial
            # estimate can be 4-5x over the true edge count, and every
            # padded slot pays 6 normal evaluations plus ~1.3 payload
            # bytes. The second render compiles once more at the tight
            # sizes (the compact path's hint discipline), then stays
            # minimal; never store below what this render actually needed.
            _dc_cache[hint_key] = (
                min(a_size, _bucket(int(n_edges * 1.25) + 1, granule=16384)),
                min(w_size, _bucket(int(n_vox * 1.25) + 1, granule=16384)),
                min(e_size, _bucket(int(n_exc * 1.25) + 64, granule=4096)),
            )
        self._evaluations += nk * nj * ni + 6 * n_edges
        if n_edges == 0:
            return np.empty((0, 3, 3), _f32)
        eax = eids // nvox
        lin = eids % nvox
        tris, blocks = finish_dc_mesh(
            verts, eax, lin, flips, self.nx, self.ny, self.nz, n_vox
        )
        self._debug_blocks = blocks
        return tris

    def _render_host(self) -> np.ndarray:
        res = float(self.res)
        # corner grid (planes): voxel (i,j,k) origin distance = grid[k,j,i],
        # its +x/+y/+z edge-end distances are the adjacent entries.
        # The dense grid STAYS ON DEVICE: one compact-field dispatch ships
        # only the active edges (id+flip word and interpolation t each) —
        # the same minimal-transfer design as ops/compact_field.py.
        from ..ops.marching_cubes import _bucket

        nk, nj, ni = self.nz + 1, self.ny + 1, self.nx + 1
        nvox = self.nz * self.ny * self.nx
        hint_key = ("hint", self.s.tree_hash(), (nk, nj, ni))
        a_size = _dc_cache.get(
            hint_key, _bucket(int(12 * max(nvox, 1) ** (2 / 3)) + 4096)
        )
        while True:
            fn = _dc_edges_fn(
                self.s, (nk, nj, ni), a_size, self.contourer.norm_step, self.device
            )
            packed = np.asarray(fn(self.origin, res))
            n_edges = int(packed[:1].view(np.int32)[0])
            if n_edges <= a_size:
                break
            a_size = _bucket(n_edges, granule=16384)
        # store the size actually compiled (grow-only): re-bucketing the
        # hint down would force a second executable on the next render
        _dc_cache[hint_key] = a_size
        self._evaluations += nk * nj * ni
        idw = packed[1 : 1 + n_edges].view(np.int32)
        tv = packed[1 + a_size : 1 + a_size + n_edges]
        flip_all = idw < 0  # bit 31: (edge_end - origin) < 0
        eid = (idw & 0x7FFFFFFF).astype(np.int64)
        axis_all = eid // nvox
        rem = eid % nvox
        ke = (rem // (self.ny * self.nx)).astype(np.int64)
        je = ((rem // self.nx) % self.ny).astype(np.int64)
        ie = (rem % self.nx).astype(np.int64)

        if n_edges == 0:
            return np.empty((0, 3, 3), _f32)
        nrm_flat = packed[1 + 2 * a_size : 1 + 2 * a_size + 3 * n_edges]
        e_nrm = nrm_flat.reshape(-1, 3)
        self._evaluations += 6 * n_edges  # in-kernel central differences

        # crossing points (same arithmetic as the kernel's)
        e_pts = np.stack(
            [
                self.origin[0] + ie.astype(_f32) * self.res,
                self.origin[1] + je.astype(_f32) * self.res,
                self.origin[2] + ke.astype(_f32) * self.res,
            ],
            axis=-1,
        )
        bump = tv.astype(_f32) * self.res
        for a in range(3):
            m = axis_all == a
            e_pts[m, a] += bump[m]

        # --- sparse edge -> voxel contributions ----------------------------
        # Each active edge contributes its (normal, crossing) row to the 4
        # voxels sharing it (the quad corners) and twice to its own voxel
        # (the reference duplicates own-edge rows,
        # dual_contour_vertexplacement.go:57-63). Everything below operates
        # on the ACTIVE sets only — no dense voxel-grid arrays.
        nz_, ny_, nx_ = self.nz, self.ny, self.nx
        con_edge = []
        con_vox = []
        edge_corners = {}  # axis -> (edge subset ids, (E,4) voxel lin, ok)
        for a in range(3):
            sel = np.nonzero(axis_all == a)[0]
            k, j, i = ke[sel], je[sel], ie[sel]
            corners = []
            all_ok = np.ones(len(sel), bool)
            for (di, dj, dk) in _OFFS[a]:
                kk2, jj2, ii2 = k + dk, j + dj, i + di
                ok = (
                    (kk2 >= 0) & (kk2 < nz_)
                    & (jj2 >= 0) & (jj2 < ny_)
                    & (ii2 >= 0) & (ii2 < nx_)
                )
                lin = (kk2 * ny_ + jj2) * nx_ + ii2
                corners.append(np.where(ok, lin, -1))
                all_ok &= ok
                con_edge.append(sel[ok])
                con_vox.append(lin[ok])
            # own-voxel duplicate row (offset (0,0,0) is always in range)
            own = (k * ny_ + j) * nx_ + i
            con_edge.append(sel)
            con_vox.append(own)
            edge_corners[a] = (sel, np.stack(corners, axis=1), all_ok)
        con_edge = np.concatenate(con_edge)
        con_vox = np.concatenate(con_vox)

        uvox, inv = np.unique(con_vox, return_inverse=True)
        V = len(uvox)
        counts = np.bincount(inv, minlength=V)
        order = np.argsort(inv, kind="stable")
        s_inv = inv[order]
        s_edge = con_edge[order]
        seg_start = np.zeros(V, np.int64)
        np.cumsum(counts[:-1], out=seg_start[1:])
        row_pos = np.arange(len(order)) - seg_start[s_inv]

        # voxel origins from linear ids
        vk = uvox // (ny_ * nx_)
        vj = (uvox // nx_) % ny_
        vi = uvox % nx_
        vo = np.stack(
            [
                self.origin[0] + vi.astype(_f32) * self.res,
                self.origin[1] + vj.astype(_f32) * self.res,
                self.origin[2] + vk.astype(_f32) * self.res,
            ],
            axis=-1,
        ).astype(np.float64)  # (V,3)
        inv_res = 1.0 / res

        # --- assemble QEF rows: up to 15 contribution rows + 3 reg = 18 ----
        R = 18
        A = np.zeros((V, R, 3), np.float64)
        B = np.zeros((V, R), np.float64)
        q = (e_pts[s_edge].astype(np.float64) - vo[s_inv]) * inv_res
        n = e_nrm[s_edge].astype(np.float64)
        A[s_inv, row_pos] = n
        B[s_inv, row_pos] = np.einsum("ij,ij->i", n, q)

        # mean bias over the contribution rows (reference biasVerts mean)
        Qsum = np.zeros((V, 3), np.float64)
        np.add.at(Qsum, s_inv, q)
        bias = Qsum / np.maximum(counts, 1)[:, None]

        sq = self.contourer.sqrt_lambda
        for d in range(3):
            A[np.arange(V), 15 + d, d] = sq
            B[:, 15 + d] = sq * bias[:, d]

        # float64 normal equations; the sqrt(1e-5) reg rows keep AtA
        # nonsingular (unused rows are zero and drop out of the products)
        AtA = np.einsum("vri,vrj->vij", A, A)
        Atb = np.einsum("vri,vr->vi", A, B)
        x = np.linalg.solve(AtA, Atb[..., None])[..., 0]
        x = np.clip(x, -0.1, 1.1)
        final_verts = (x * res + vo).astype(_f32)  # (V,3)

        # --- quad emission per active edge ---------------------------------
        # corner voxel ids resolve by binary search over the sorted active
        # voxel keys (every in-range corner received this edge's row, so it
        # is guaranteed present)
        tris = []
        for a in range(3):
            sel, corners, all_ok = edge_corners[a]
            if not len(sel):
                continue
            corners = corners[all_ok]
            flip = flip_all[sel][all_ok]
            vid = np.searchsorted(uvox, corners)
            quads = final_verts[vid]  # (E,4,3)
            quads[flip] = quads[flip][:, ::-1, :]
            tris.append(quads[:, [0, 1, 2], :])
            tris.append(quads[:, [2, 3, 0], :])
        if not tris:
            return np.empty((0, 3, 3), _f32)
        self._debug_blocks = [len(t) for t in tris]
        return np.concatenate(tris, axis=0).astype(_f32)


def minecraft_render(s: Shader3D, res: float, device=None) -> np.ndarray:
    """Axis-aligned voxel-face debug render (reference minecraftRender,
    glrender/dual_contour.go:297-403): each sign-crossing voxel edge emits
    the voxel face it pierces, yielding a blocky mesh."""
    dc = DualContourRenderer(s, res, device=device)
    nk, nj, ni = dc.nz + 1, dc.ny + 1, dc.nx + 1
    grid = np.asarray(
        ev.evaluate_grid(dc.s, dc.origin, float(dc.res), (nk, nj, ni), dc.device)
    )
    d0 = grid[: dc.nz, : dc.ny, : dc.nx]
    r = float(dc.res)
    tris = []
    # per axis: face at the edge end, spanned by the two other axes
    specs = [
        (grid[: dc.nz, : dc.ny, 1:], 0, (0, 1, 0), (0, 0, 1)),  # x faces
        (grid[: dc.nz, 1:, : dc.nx], 1, (0, 0, 1), (1, 0, 0)),  # y faces
        (grid[1:, : dc.ny, : dc.nx], 2, (1, 0, 0), (0, 1, 0)),  # z faces
    ]
    for dend, axis, ua, ub in specs:
        active = np.signbit(d0) != np.signbit(dend)
        idx = np.argwhere(active)  # (E,3) [k,j,i]
        if len(idx) == 0:
            continue
        flip = (dend - d0)[active] < 0
        base = np.stack(
            [
                dc.origin[0] + idx[:, 2] * r,
                dc.origin[1] + idx[:, 1] * r,
                dc.origin[2] + idx[:, 0] * r,
            ],
            axis=-1,
        ).astype(_f32)
        base[:, axis] += r  # face sits at the edge end
        a = np.asarray(ua, _f32) * r
        b = np.asarray(ub, _f32) * r
        q0 = base
        q1 = base + a
        q2 = base + a + b
        q3 = base + b
        t1 = np.stack([q0, q1, q2], axis=1)
        t2 = np.stack([q2, q3, q0], axis=1)
        t1[flip] = t1[flip][:, ::-1, :]
        t2[flip] = t2[flip][:, ::-1, :]
        tris.append(t1)
        tris.append(t2)
    if not tris:
        return np.empty((0, 3, 3), _f32)
    return np.concatenate(tris, axis=0).astype(_f32)
