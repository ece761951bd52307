"""THE shared marching-cubes emit kernel.

The reference has exactly ONE `mcToTriangles` (glrender/marchcubes.go:34)
consumed by the octree, flat and test paths. This module is its device
analog: every renderer (fused dense, welded indexed, pruned tiles,
multi-chip sharded, staged) composes these jittable pieces instead of
re-implementing classify -> compact -> gather -> interpolate -> emit.

All functions are shape-polymorphic jnp code meant to be called INSIDE a
caller's jit/shard_map trace; none of them jit themselves.

Conventions (identical across callers):
- corner grid grid[k, j, i], z slowest;
- cube linear id = (ck*ny + cj)*nx + ci (x fastest — the reference's
  iteration order, flatrenderer.go:210-212, so triangle order matches);
- corner order and winding per marchcubes.go:222-233 / :63-68;
- corner-0 quick reject |d0| <= 2*sqrt3*res (marchcubes.go:23).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .mc_tables import MC_EDGE_PAIRS, MC_TRI_COUNT, MC_TRI_TABLE

_f32 = np.float32

# float32(2*sqrt3) with the reference's sqrt3 constant (glrender/glrender.go:9)
CUBE_DIAG_FACTOR = np.float32(2 * 1.73205080757)
MC_EPS = 1e-12

# corner offsets (dx,dy,dz) in the reference's corner order
CORNER_OFFSETS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.int32,
)


# per cube-edge e: axis and low-corner offset; the OWNER cube of edge e of
# cube c is c + low_offset, and within the owner it is the low edge `axis`
# (welded/compact vertex identity: every crossing edge has exactly one
# owner whose origin corner is the edge's low end)
EDGE_AXIS = []
EDGE_LOW = []
for _a, _b in MC_EDGE_PAIRS:
    _oa = CORNER_OFFSETS[_a]
    _ob = CORNER_OFFSETS[_b]
    EDGE_AXIS.append(int(np.argmax(_oa != _ob)))
    EDGE_LOW.append(np.minimum(_oa, _ob))
EDGE_AXIS = np.array(EDGE_AXIS, np.int32)  # (12,)
EDGE_LOW = np.array(EDGE_LOW, np.int32)  # (12,3)

# corner index of the far end of each low edge (x,y,z): corners 1,3,4
LOW_EDGE_FAR = np.array([1, 3, 4], np.int32)


def bucket(n: int, minimum: int = 1024, granule: int = 65536) -> int:
    """Round n up: powers of two below `granule`, multiples of `granule`
    above. Bounds both recompile count and padded-transfer waste."""
    b = minimum
    while b < n and b < granule:
        b <<= 1
    if b >= n:
        return b
    return ((n + granule - 1) // granule) * granule


def canonical_grid_eval(tree, origin, res, ix, iy, iz):
    """CPU-backend corner-field evaluation with ONE compiled eval loop
    shared by every MC kernel shape (dense grid, staged z-slab, sharded
    slab, pruned tile atlas) so their grid VALUES can never drift apart.

    ix/iy/iz are int32 GLOBAL corner indices of identical (any) shape;
    returns f32 distances in that shape.

    The int32 indices are flattened to (N, 3) and materialized behind
    lax.optimization_barrier before the position synthesis + tree eval.
    Rationale (measured, docs/TESTING.md "Pruned-path bit-exactness"):
    LLVM applies different FMA-contraction / vectorization choices to
    the fused synth+eval loop depending on the caller's array shape —
    identical f32 positions evaluated through a (T,9,9,9) tile atlas
    diverged from the (nk,nj,ni) dense grid by 1-2 ulp on ~10% of
    corners (positions themselves bit-identical). A materialized flat
    (N,3) operand makes the consumer loop the SAME compiled body for
    every caller, and flat-shape evals are measured bit-stable across
    batch lengths AND row offsets (aligned or not), so dense == tile ==
    slab by construction. The barrier costs one int32 index-buffer
    round-trip — irrelevant on the CPU test/oracle backend.

    GPU kernels do NOT route through this helper: XLA:GPU compiles
    each element's math the same way whatever the array's shape (the
    tile-vs-dense payload is pinned bit-exact on the card by
    test_pruned.py::test_pruned_compact_payload_bitexact_accel), and a
    barrier would force a device-memory round-trip of the index buffer
    on the production path. Call sites keep their fused f32 synthesis
    verbatim off-CPU.
    """
    gidx = jnp.stack(
        [ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)], axis=-1
    )
    # pad the flat batch to a multiple of 64 rows: every element then
    # runs through LLVM's vectorized loop body — a scalar remainder tail
    # compiles with different FMA choices, so a surface corner landing
    # in the tail of one kernel's batch but the body of another's would
    # still diverge (observed: 1-ulp vertex drift on 0.4% of a slabbed
    # render before padding)
    n = gidx.shape[0]
    n_pad = -n % 64
    if n_pad:
        gidx = jnp.pad(gidx, ((0, n_pad), (0, 0)))  # pad rows eval corner 0
    g = jax.lax.optimization_barrier(gidx).astype(jnp.float32)
    p = jnp.stack(
        [
            origin[0] + g[:, 0] * res,
            origin[1] + g[:, 1] * res,
            origin[2] + g[:, 2] * res,
        ],
        axis=-1,
    )
    return tree.distance(p)[:n].reshape(ix.shape)


def canonical_dense_grid_eval(tree, origin, res, shape, k0=None):
    """THE way a CPU kernel evaluates a dense/z-slab corner grid
    (CLAUDE.md hard rule): builds the (nk, nj, ni) int32 corner-index
    iotas (z slowest), adds the optional traced global z-layer offset
    k0 (any integer-valued scalar — an f32-riding exact integer is cast
    losslessly), and routes through canonical_grid_eval. Centralizing
    the index plumbing keeps every dense call site mechanically
    identical — a site that hand-rolled the iotas could transpose an
    axis or add k0 in f32 and silently break the cross-kernel
    bit-exactness this path exists to guarantee. The pruned tile atlas
    (render/pruned.py::_tile_grid) is the one non-dense shape and
    builds its indices itself."""
    nk, nj, ni = (int(x) for x in shape)
    izi = jax.lax.broadcasted_iota(jnp.int32, (nk, nj, ni), 0)
    if k0 is not None:
        izi = izi + jnp.asarray(k0, jnp.int32)
    iyi = jax.lax.broadcasted_iota(jnp.int32, (nk, nj, ni), 1)
    ixi = jax.lax.broadcasted_iota(jnp.int32, (nk, nj, ni), 2)
    return canonical_grid_eval(tree, origin, res, ixi, iyi, izi)


def cube_corner_views(grid):
    """The 8 per-cube corner arrays sliced over the LAST 3 dims (works for
    a dense (nk,nj,ni) grid and for a (T,P,P,P) tile atlas alike)."""
    return (
        grid[..., :-1, :-1, :-1],  # 0: (0,0,0)
        grid[..., :-1, :-1, 1:],  # 1: (+x,0,0)
        grid[..., :-1, 1:, 1:],  # 2: (+x,+y,0)
        grid[..., :-1, 1:, :-1],  # 3: (0,+y,0)
        grid[..., 1:, :-1, :-1],  # 4: (0,0,+z)
        grid[..., 1:, :-1, 1:],  # 5: (+x,0,+z)
        grid[..., 1:, 1:, 1:],  # 6: (+x,+y,+z)
        grid[..., 1:, 1:, :-1],  # 7: (0,+y,+z)
    )


def case_index(corners):
    """256-case MC index from the 8 corner arrays (sign bit per corner)."""
    index = jnp.zeros(corners[0].shape, dtype=jnp.int32)
    for b, v in enumerate(corners):
        index = index | (jnp.int32(v < 0.0) << b)
    return index


def classify(grid, res, extra_mask=None):
    """Dense classification: (case index, active mask).

    active = corner-0 quick-reject AND mixed signs (index not 0/255 — the
    exact set of cases with a non-empty triangle table) AND extra_mask."""
    corners = cube_corner_views(grid)
    index = case_index(corners)
    keep = jnp.abs(corners[0]) <= CUBE_DIAG_FACTOR * res
    active = keep & (index != 0) & (index != 255)
    if extra_mask is not None:
        active = active & extra_mask
    return index, active


def compact_indices(mask_flat, size, method: str = "sort"):
    """Indices of True entries, -1 padded to `size`, order preserving.

    method="sort" (default): single-key sort — actives keep their index
    as the key, inactives get bit 30 set, so ascending order is (actives
    in original order, then inactives).

    method="searchsorted": inclusive cumsum, then output slot s
    binary-searches for the first index with csum == s+1: an O(n)
    memory-bound pass + size*log2(n) gathers. Also the route for inputs
    >= 2^30, where the sort key packing runs out of bits.

    method="scatter": cumsum destinations + drop-mode scatter, the usual
    GPU stream compaction.

    Which is fastest on the GPU is not measured yet."""
    n = mask_flat.shape[0]
    if n >= (1 << 31):
        # every strategy here indexes with int32 (sort keys, cumsum,
        # scatter destinations); past 2^31 entries all of them silently
        # overflow — and the hierarchical branch would mutually recurse
        # with compact_indices_blocks forever. Fail loudly instead.
        raise ValueError(
            f"compact_indices: mask of {n} entries exceeds int32 "
            "addressing (2^31); split the grid into slabs first"
        )
    if method == "searchsorted" or n >= (1 << 30):
        csum = jnp.cumsum(mask_flat.astype(jnp.int32))
        n_active = csum[-1]
        slots = jnp.arange(1, size + 1, dtype=jnp.int32)
        found = jnp.searchsorted(csum, slots, side="left").astype(jnp.int32)
        return jnp.where(slots <= n_active, found, -1)
    if method == "sort" and n > (1 << 21) and 16 * size < n:  # "sort-flat" skips
        # hierarchical: sorting the whole grid would dominate the dense
        # render at scale. Delegate to the ONE two-level-sort
        # implementation (compact_indices_blocks) with block_slots = size:
        # block overflow is then subsumed by the n_active overflow signal
        # (n_blk <= n_active, so a dropped block implies n_active > size
        # and the caller's grow-and-retry already fires).
        return compact_indices_blocks(mask_flat, size, size)[0]
    if method in ("sort", "sort-flat") and n < (1 << 30):
        idx = jnp.arange(n, dtype=jnp.int32)
        keys = jnp.where(mask_flat, idx, idx | (1 << 30))
        s = jax.lax.sort(keys)
        s = s[:size] if n >= size else jnp.pad(s, (0, size - n))
        n_active = jnp.sum(mask_flat.astype(jnp.int32))
        return jnp.where(
            jnp.arange(size, dtype=jnp.int32) < n_active, s, -1
        )
    pos = jnp.cumsum(mask_flat.astype(jnp.int32)) - 1
    idx = jnp.arange(n, dtype=jnp.int32)
    dest = jnp.where(mask_flat, pos, size)
    out = jnp.full((size + 1,), -1, jnp.int32)
    out = out.at[dest].set(idx, mode="drop")
    return out[:size]


def compact_indices_blocks(mask_flat, size, block_slots):
    """Hierarchical order-preserving compaction with an EXPLICIT block-slot
    budget, returning (idx (size,), n_blk true block count i32).

    The two-level sort (compact active 8-blocks, expand survivors,
    compact candidates) costs n/8 + 8*block_slots sort keys instead of
    n. `compact_indices` pins block_slots = size so block overflow is
    impossible; here the caller may pass a TIGHT budget (measured block
    occupancy is ~0.32*n_active on the flange) — which is safe ONLY
    because the true block count is returned for an in-band overflow
    signal: when n_blk > block_slots the result has silently dropped
    active cubes and the caller MUST grow block_slots and retry (the
    compact-field payload header carries n_blk for exactly this,
    mirroring the n_active/n_exc grow-and-retry contract).

    When the hierarchy doesn't pay (small grids or block_slots close to
    n/8) this falls back to the flat sort and reports n_blk = 0 (never
    overflows)."""
    n = mask_flat.shape[0]
    B = 8
    if n <= (1 << 21) or B * int(block_slots) >= n or n >= (1 << 30):
        return compact_indices(mask_flat, size), jnp.zeros((), jnp.int32)
    npad = -(-n // B) * B
    mpad = jnp.pad(mask_flat, (0, npad - n)) if npad != n else mask_flat
    blk_any = mpad.reshape(npad // B, B).any(axis=1)
    n_blk = jnp.sum(blk_any.astype(jnp.int32))
    blk_idx = compact_indices(blk_any, int(block_slots), method="sort")
    valid_blk = blk_idx >= 0
    cand = (
        jnp.maximum(blk_idx, 0)[:, None] * B
        + jnp.arange(B, dtype=jnp.int32)[None, :]
    ).reshape(-1)
    cand_active = mpad[cand] & jnp.repeat(valid_blk, B)
    pos = compact_indices(cand_active, size, method="sort")
    out = jnp.where(pos >= 0, cand[jnp.maximum(pos, 0)], -1)
    n_active = jnp.sum(mask_flat.astype(jnp.int32))
    idx = jnp.where(jnp.arange(size, dtype=jnp.int32) < n_active, out, -1)
    return idx, n_blk


def gather_corners(grid_flat, base_lin, stride_j, stride_k):
    """Gather the 8 corner values per cube. base_lin (A,) is each cube's
    origin-corner linear index in grid_flat; strides give the +j / +k
    steps (+i step is 1). Returns (A,8)."""
    offs = jnp.asarray(CORNER_OFFSETS)
    gi = (
        base_lin[:, None]
        + offs[None, :, 2] * stride_k
        + offs[None, :, 1] * stride_j
        + offs[None, :, 0]
    )
    return grid_flat[gi]


def corner_positions(origin, res, fi, fj, fk):
    """Corner positions (A,8,3) from float32 corner-index coords of each
    cube's origin corner. Reference arithmetic (flatrenderer.go:235-247):
    origin + index*res, then +offset*res per corner."""
    base = jnp.stack(
        [origin[0] + fi * res, origin[1] + fj * res, origin[2] + fk * res],
        axis=-1,
    )  # (A,3)
    offs = jnp.asarray(CORNER_OFFSETS).astype(jnp.float32)
    return base[:, None, :] + offs[None, :, :] * res  # (A,8,3)


def interpolate_edges(v, pc):
    """The 12 edge intersection points per cube (mcInterpolate,
    marchcubes.go:76-98 epsilon rules). v (A,8), pc (A,8,3) -> (A,12,3)."""
    pairs = jnp.asarray(MC_EDGE_PAIRS)
    va, vb = v[:, pairs[:, 0]], v[:, pairs[:, 1]]
    pa, pb = pc[:, pairs[:, 0], :], pc[:, pairs[:, 1], :]
    ca = jnp.abs(va) < MC_EPS
    cb = jnp.abs(vb) < MC_EPS
    t = jnp.where(ca & cb, 0.5, (0.0 - va) / (vb - va))
    pt = pa + t[..., None] * (pb - pa)
    pt = jnp.where((cb & ~ca)[..., None], pb, pt)
    pt = jnp.where((ca & ~cb)[..., None], pa, pt)
    return pt


def emit_triangles(v, pc, valid_cube, t_size):
    """Per-active-cube triangle emission + exact device-side compaction.

    v (A,8) corner values, pc (A,8,3) corner positions, valid_cube (A,)
    (False on -1/padding rows). Returns (tris (t_size,3,3) in reference
    cube-then-table order, total int32). Rows past `total` are zeros;
    callers grow-and-retry when total > t_size.
    """
    A = v.shape[0]
    idx8 = case_index(tuple(v[:, b] for b in range(8)))
    pt = interpolate_edges(v, pc)

    table = jnp.asarray(MC_TRI_TABLE)[idx8]  # (A,5,3) edge ids, -1 padded
    tcounts = jnp.asarray(MC_TRI_COUNT)[idx8]
    flat_pt = pt.reshape(A * 12, 3)
    # flat gather (no (A,5,12) materialization)
    gidx = (
        jax.lax.broadcasted_iota(jnp.int32, (A, 5, 3), 0) * 12
        + jnp.maximum(table, 0)
    ).reshape(-1)
    # reference winding: Triangle{points[t2], points[t1], points[t0]}
    tris = flat_pt[gidx].reshape(A, 5, 3, 3)[:, :, ::-1, :]

    slot = jax.lax.broadcasted_iota(jnp.int32, (A, 5), 1)
    valid = (slot < tcounts[:, None]) & valid_cube[:, None]
    total = jnp.sum(valid.astype(jnp.int32))

    # gather-based compaction: scatter only the row permutation (1 i32 per
    # row), then gather the 9-float triangles
    mask = valid.reshape(A * 5)
    tpos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    tdest = jnp.where(mask, tpos, t_size)
    perm = jnp.full((t_size + 1,), -1, jnp.int32)
    perm = perm.at[tdest].set(jnp.arange(A * 5, dtype=jnp.int32), mode="drop")[
        :t_size
    ]
    out = jnp.where(
        (perm >= 0)[:, None, None],
        tris.reshape(A * 5, 3, 3)[jnp.maximum(perm, 0)],
        0.0,
    )
    return out, total


def dense_grid_mc(grid, origin, res, k0, a_size, t_size):
    """Full dense-grid marching cubes from a device-resident corner grid:
    classify -> compact -> gather -> emit. grid (nk,nj,ni); k0 is the
    grid's plane offset along z (slab/shard rendering) so positions are
    bit-exact with a whole-grid render.

    Returns (tris (t_size,3,3), n_active, total)."""
    nk, nj, ni = grid.shape
    nx, ny = ni - 1, nj - 1
    index, active = classify(grid, res)
    n_active = jnp.sum(active.astype(jnp.int32))
    cube_idx = compact_indices(active.reshape(-1), a_size)

    safe = jnp.maximum(cube_idx, 0)
    ci = safe % nx
    cj = (safe // nx) % ny
    ck = safe // (nx * ny)
    base_lin = ck * (nj * ni) + cj * ni + ci
    v = gather_corners(grid.reshape(-1), base_lin, ni, nj * ni)
    pc = corner_positions(
        origin,
        res,
        ci.astype(jnp.float32),
        cj.astype(jnp.float32),
        ck.astype(jnp.float32) + k0,
    )
    tris, total = emit_triangles(v, pc, cube_idx >= 0, t_size)
    return tris, n_active, total
