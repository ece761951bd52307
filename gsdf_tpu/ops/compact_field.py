"""Compact-field renderer: the minimal-transfer production path.

The path cuts (a) the device->host payload and (b) per-active-cube
gather/emit work on device. It moves the marching-cubes TABLE WALK to
the host (exactly where the reference runs it — its GPU evaluates
distances and marchCubes runs on host, glrender/octreerenderer.go:131 ->
marchcubes.go:34) while keeping everything O(grid) on device:

device (ONE dispatch, ONE fetch):
  grid eval -> classification -> active-cube compaction ->
  per-owner-edge interpolation parameter t -> packed buffer
    [n_active, n_verts, n_exc, version,
     deltas (A/4 words): cube-id DELTAS as u8, 4 per word (active ids
            are ascending; surface runs make most deltas tiny — 255 is
            an escape marker resolved through the exception table),
     cases  (A/4 words): case bytes packed 4 per word (little-endian,
                         so the fetched buffer views directly as u8),
     exc_pos (E i32), exc_delta (E i32): rows whose delta >= 255,
     t      (V f32): compacted crossing-edge parameters]

The delta encoding shrinks the id stream 4x losslessly (1 B/cube + a
small exception table instead of 4 B/cube): flange payload 1.92 ->
1.31 MB. Whether the saved bytes matter over PCIe, against the host
decode they cost, is not measured on the GPU. The host-side unpack is
one numpy cumsum (unpack_compact_payload). The
tile-atlas emit (tile_compact_emit) keeps full i32 ids: its batch
order is tile-major, not id-ascending, so deltas don't compress.

host (native C++, numpy fallback):
  decode ids/cases -> reconstruct vertex coordinates from (cube id, axis, t)
  with the same float32 arithmetic as the device -> walk the 256-case
  tables -> indexed mesh (verts, tri_idx) or STL bytes directly.

Everything the table walk needs is sign-derived (the case byte), so
triangle count/order/connectivity are bit-identical to the welded
device path; vertex coordinates match to the last ulp. Payload is
~4 B/vertex (t) + 2 B/cube (delta+case) ≈ 1.3 MB on the flange (vs 6 MB welded,
16.5 MB soup). Cube ids are full int32: any grid to 2^31 cubes works
(the welded fallback only covers renderer memory limits).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import mc_emit
from .marching_cubes import _MC_EPS, _bucket

_f32 = np.float32

MAX_CUBES = 1 << 31  # int32 cube ids

_cache: dict = {}


def _owner_edge_t(v0, vfar):
    """Interpolation parameter for the 3 low (owner) edges of each cube,
    with the reference's epsilon rules (mcInterpolate,
    marchcubes.go:76-98); endpoint snaps are BAKED INTO t (0 or 1) so the
    host can reconstruct from t alone. v0 (A,1), vfar (A,3) -> (A,3)."""
    ca = jnp.abs(v0) < _MC_EPS
    cb = jnp.abs(vfar) < _MC_EPS
    t = jnp.where(ca & cb, 0.5, (0.0 - v0) / (vfar - v0))
    t = jnp.where(cb & ~ca, 1.0, t)
    t = jnp.where(ca & ~cb, 0.0, t)
    return t


def _crossing_t(idx8, valid, t, V):
    """Crossing flags from the case byte's sign bits + cube-major t
    compaction. Returns (n_verts, tvals (V,))."""
    b0 = idx8 & 1
    cx = b0 != ((idx8 >> 1) & 1)
    cy = b0 != ((idx8 >> 3) & 1)
    cz = b0 != ((idx8 >> 4) & 1)
    crossing = jnp.stack([cx, cy, cz], axis=-1) & valid[:, None]  # (A,3)

    vflags = crossing.reshape(-1)
    vpos = jnp.cumsum(vflags.astype(jnp.int32)) - 1
    n_verts = vpos[-1] + 1
    vdest = jnp.where(vflags, vpos, V)
    tvals = jnp.zeros((V + 1,), jnp.float32)
    tvals = tvals.at[vdest].set(t.reshape(-1), mode="drop")[:V]
    return n_verts, tvals


def _pack_u8(vals, valid, A):
    """u8 values packed 4 per word, little-endian: the fetched words view
    directly as a u8 array on host."""
    v4 = jnp.where(valid, vals, 0).reshape(A // 4, 4)
    return v4[:, 0] | (v4[:, 1] << 8) | (v4[:, 2] << 16) | (v4[:, 3] << 24)


def _blk_slots(a_size: int) -> int:
    """Default block-slot budget for the hierarchical compaction: half
    the active-cube budget is conservative (measured 8-block occupancy is
    ~0.32*n_active on the flange) yet still cuts the dominant sort from
    n/8 + 8*a to n/8 + 4*a keys. Warm renders tighten it further via the
    remembered hint (the true n_blk is in the payload header)."""
    return max(4096, int(a_size) // 2)


def _pack_payload(ids, idx8, valid, t, A, E, V, n_active, n_blk):
    """Shared payload packing for the PRODUCTION (id-ascending) emit:
    cube ids are delta-encoded to u8 with an i32 exception table (rows
    whose delta >= 255 store the 255 escape marker; the true delta goes
    to the table). n_active/n_exc/n_blk are the TRUE counts (may exceed
    A/E/block slots — the caller's grow-and-retry contract depends on
    reporting them unclamped; `valid` saturates at A and must not be
    used for counts).
    Returns the packed 1-D f32 buffer (v3)
    [n_active, n_verts, n_exc, version (bitcast i32), n_blk,
     id deltas u8 packed 4/word (A/4), case bytes packed 4/word (A/4),
     exc_pos (E i32), exc_delta (E i32), t (V f32)]."""
    n_verts, tvals = _crossing_t(idx8, valid, t, V)

    ids = jnp.where(valid, ids, 0)
    prev = jnp.concatenate([jnp.zeros((1,), ids.dtype), ids[:-1]])
    delta = jnp.where(valid, ids - prev, 0)  # valid is a prefix mask
    esc = valid & (delta >= 255)
    n_exc = jnp.sum(esc.astype(jnp.int32))
    deltas = _pack_u8(jnp.where(esc, 255, delta), valid, A)
    cases = _pack_u8(idx8, valid, A)

    pos = mc_emit.compact_indices(esc, E)
    evalid = pos >= 0
    psafe = jnp.maximum(pos, 0)
    exc_pos = jnp.where(evalid, psafe, 0).astype(jnp.int32)
    exc_delta = jnp.where(evalid, delta[psafe], 0).astype(jnp.int32)

    counts = jnp.stack(
        [n_active, n_verts, n_exc, jnp.asarray(3, n_active.dtype), n_blk]
    )
    return jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(counts, jnp.float32),
            jax.lax.bitcast_convert_type(deltas, jnp.float32),
            jax.lax.bitcast_convert_type(cases, jnp.float32),
            jax.lax.bitcast_convert_type(exc_pos, jnp.float32),
            jax.lax.bitcast_convert_type(exc_delta, jnp.float32),
            tvals,
        ]
    )


def unpack_compact_payload(packed, a_size, e_size):
    """Host-side unpack of the v3 buffer -> (ids u32, cases u8,
    tvals f32, (n_active, n_verts, n_exc, n_blk)). ids are reconstructed
    with one cumsum over the patched delta stream — bit-identical to the
    pre-delta ids (lossless encoding). Counts may exceed a_size/e_size/
    the emit's block-slot budget (overflow): rows are then truncated or
    dropped and the caller must retry."""
    packed = np.ascontiguousarray(packed)
    A, E = int(a_size), int(e_size)
    hdr = packed[:5].view(np.int32)
    na, nv, ne, nblk = int(hdr[0]), int(hdr[1]), int(hdr[2]), int(hdr[4])
    na_c, ne_c = min(na, A), min(ne, E)
    off = 5
    d8 = packed[off : off + A // 4].view(np.uint8)[:na_c]
    off += A // 4
    cases = packed[off : off + A // 4].view(np.uint8)[:na_c]
    off += A // 4
    exc_pos = packed[off : off + E].view(np.int32)[:ne_c]
    off += E
    exc_delta = packed[off : off + E].view(np.int32)[:ne_c]
    off += E
    tvals = packed[off : off + nv]
    deltas = d8.astype(np.int64)
    deltas[exc_pos] = exc_delta
    ids = np.cumsum(deltas).astype(np.uint32)
    return ids, cases, tvals, (na, nv, ne, nblk)


def _pack_payload_full_ids(ids, idx8, valid, t, A, V, n_active):
    """v1 packing with full i32 ids — used by the tile-atlas emit, whose
    batch order is tile-major (ids not ascending; deltas don't compress).
    Layout: [n_active, n_verts (bitcast i32), ids (A i32),
    case bytes packed 4/word (A/4), t (V f32)]."""
    n_verts, tvals = _crossing_t(idx8, valid, t, V)
    ids = jnp.where(valid, ids, 0)
    cases = _pack_u8(idx8, valid, A)
    counts = jnp.stack([n_active, n_verts])
    return jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(counts, jnp.float32),
            jax.lax.bitcast_convert_type(ids, jnp.float32),
            jax.lax.bitcast_convert_type(cases, jnp.float32),
            tvals,
        ]
    )


def unpack_compact_payload_full_ids(packed, a_size):
    """Host-side unpack of the v1 full-id buffer (_pack_payload_full_ids)
    -> (ids u32, cases u8, tvals f32, (n_active, n_verts)). The wire
    layout lives ONLY in this pack/unpack pair (CLAUDE.md rule); counts
    may exceed a_size/v_size (overflow): rows are then truncated and the
    caller must retry."""
    packed = np.ascontiguousarray(packed)
    A = int(a_size)
    hdr = packed[:2].view(np.int32)
    na, nv = int(hdr[0]), int(hdr[1])
    na_c = min(na, A)
    off = 2
    ids = packed[off : off + A].view(np.uint32)[:na_c]
    off += A
    cases = packed[off : off + A // 4].view(np.uint8)[:na_c]
    off += A // 4
    tvals = packed[off : off + nv]
    return ids, cases, tvals, (na, nv)


def compact_emit(grid, res, a_size, e_size, v_size, blk_size=None):
    """Classify -> compact -> owner-edge-t -> packed buffer. The ONE
    compact-field emit implementation, shared by the single-device builder
    below, the sharded step (parallel/sharded.py) and the tile-pruned
    emit — the same one-kernel discipline ops/mc_emit.py enforces for the
    soup path (reference: ONE mcToTriangles, glrender/marchcubes.go:34).

    grid: (nkg, nj, ni) corner distances; every cube between grid planes
    is classified, so a sharded caller passes its slab plus one +z halo
    plane. Returns the v3 packed 1-D f32 buffer (delta-encoded slab-local
    ids — see the module docstring / unpack_compact_payload).

    blk_size bounds the hierarchical compaction's block slots (the
    largest remaining device term is this sort); the TRUE block count
    travels in the header so overflow is an explicit retry, never silent
    truncation. None = the conservative _blk_slots(a_size) default.
    """
    nkg, nj, ni = grid.shape
    nx, ny = ni - 1, nj - 1
    A = int(a_size)
    E = int(e_size)
    V = int(v_size)
    BLK = _blk_slots(A) if blk_size is None else int(blk_size)

    index, active = mc_emit.classify(grid, res)
    n_active = jnp.sum(active.astype(jnp.int32))
    cube_id, n_blk = mc_emit.compact_indices_blocks(
        active.reshape(-1), A, BLK
    )
    valid = cube_id >= 0
    safe = jnp.maximum(cube_id, 0)

    # case byte: gather from the dense classification (1 i32/cube)
    idx8 = index.reshape(-1)[safe]

    # corner 0 and the 3 low-edge far corners (+x,+y,+z): 4 gathers
    ci = safe % nx
    cj = (safe // nx) % ny
    ck = safe // (nx * ny)
    base_lin = ck * (nj * ni) + cj * ni + ci
    gflat = grid.reshape(-1)
    strides = jnp.asarray(np.array([0, 1, ni, nj * ni], np.int32))
    v4 = gflat[base_lin[:, None] + strides[None, :]]  # (A,4): v0,vx,vy,vz
    t = _owner_edge_t(v4[:, 0:1], v4[:, 1:])  # (A,3)
    return _pack_payload(safe, idx8, valid, t, A, E, V, n_active, n_blk)


def tile_compact_emit(grid, tile_ijk, dims, res, a_size, v_size):
    """Compact-field emit over a pruned TILE ATLAS — the scaling-path
    counterpart of `compact_emit` (the reference's octree prune feeds the
    same mcToTriangles as its flat path, octreerenderer.go:131 ->
    marchcubes.go:34).

    grid: (T, P, P, P) corner distances of T surviving tiles (P = S+1
    corner planes, S cubes per tile side); tile_ijk (T,3) int32 [i,j,k]
    tile coords, -1 padded. dims = (nx, ny, nz) GLOBAL cube counts: cubes
    past the global grid (partial edge tiles) are masked out and ids are
    global cube ids, so merged payloads from all tiles are exactly the
    dense path's payload (sorted by id — `merge_compact_payloads`).

    Returns the same packed buffer layout as `compact_emit` with GLOBAL
    ids; t-compaction order is batch-local (sorted during the host merge).
    """
    T, P = grid.shape[0], grid.shape[1]
    S = P - 1
    nx, ny, nz = (int(d) for d in dims)
    A = int(a_size)
    if A % 4:
        raise ValueError("a_size must be a multiple of 4")
    V = int(v_size)

    # classification per tile cube, masked to valid tiles AND the global
    # grid extent (edge tiles overhang when S doesn't divide nx/ny/nz)
    base = jnp.maximum(tile_ijk, 0) * S  # (T,3) global cube offsets [i,j,k]
    li = jax.lax.broadcasted_iota(jnp.int32, (T, S, S, S), 3)
    lj = jax.lax.broadcasted_iota(jnp.int32, (T, S, S, S), 2)
    lk = jax.lax.broadcasted_iota(jnp.int32, (T, S, S, S), 1)
    gi = base[:, 0, None, None, None] + li
    gj = base[:, 1, None, None, None] + lj
    gk = base[:, 2, None, None, None] + lk
    in_grid = (
        (tile_ijk[:, 0] >= 0)[:, None, None, None]
        & (gi < nx)
        & (gj < ny)
        & (gk < nz)
    )
    index, active = mc_emit.classify(grid, res, extra_mask=in_grid)
    n_active = jnp.sum(active.astype(jnp.int32))
    slot = mc_emit.compact_indices(active.reshape(-1), A)
    valid = slot >= 0
    safe = jnp.maximum(slot, 0)

    idx8 = index.reshape(-1)[safe]

    # slot -> (tile, local cube) -> global cube id
    ci = safe % S
    cj = (safe // S) % S
    ck = (safe // (S * S)) % S
    ct = safe // (S * S * S)
    tb = jnp.maximum(tile_ijk, 0)[ct]  # (A,3)
    ids = ((tb[:, 2] * S + ck) * ny + (tb[:, 1] * S + cj)) * nx + (
        tb[:, 0] * S + ci
    )

    # corner 0 + the 3 low-edge far corners from the tile atlas
    base_lin = ct * (P * P * P) + ck * (P * P) + cj * P + ci
    gflat = grid.reshape(-1)
    strides = jnp.asarray(np.array([0, 1, P, P * P], np.int32))
    v4 = gflat[base_lin[:, None] + strides[None, :]]
    t = _owner_edge_t(v4[:, 0:1], v4[:, 1:])
    return _pack_payload_full_ids(ids, idx8, valid, t, A, V, n_active)


def merge_compact_payloads(parts):
    """Merge per-batch compact payloads (GLOBAL ids, batch-local t order)
    into the dense path's exact payload: ids ascending (= dense cube
    order), cases aligned, t re-gathered cube-major. Pure numpy, O(A).

    parts: list of (ids u32, cases u8, tvals f32). Returns
    (ids, cases, tvals)."""
    # a surviving coarse tile can contain zero sign-crossing cubes (the
    # prune criterion keeps NEAR-surface tiles): empty parts carry no
    # rows and would break the per-part rebase index arithmetic below
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return (
            np.empty(0, np.uint32),
            np.empty(0, np.uint8),
            np.empty(0, _f32),
        )
    ids = np.concatenate([p[0] for p in parts])
    cases = np.concatenate([p[1] for p in parts])
    tcat = np.concatenate([p[2] for p in parts])

    # crossing-edge count per cube from the case byte (matches the
    # device's crossing computation in _pack_payload)
    b0 = cases & 1
    cnt = (
        (b0 != ((cases >> 1) & 1)).astype(np.int64)
        + (b0 != ((cases >> 3) & 1))
        + (b0 != ((cases >> 4) & 1))
    )
    # each cube's t-slice start within tcat: per-part cumsum, offset by
    # the part's start in the concatenation
    ends = np.cumsum(cnt)
    starts = ends - cnt
    # per-part rebase: subtract the part-local origin, add the part offset
    sizes = np.array([len(p[0]) for p in parts])
    tsizes = np.array([len(p[2]) for p in parts])
    part_row0 = np.cumsum(sizes) - sizes  # first row of each part
    part_t0 = np.cumsum(tsizes) - tsizes  # first t of each part
    row_part = np.repeat(np.arange(len(parts)), sizes)
    starts = starts - starts[part_row0][row_part] + part_t0[row_part]

    order = np.argsort(ids, kind="stable")
    ids = ids[order]
    cases = cases[order]
    cnt_s = cnt[order]
    src = starts[order]
    out_end = np.cumsum(cnt_s)
    out_off = out_end - cnt_s
    total = int(out_end[-1]) if len(out_end) else 0
    flat_src = np.repeat(src - out_off, cnt_s) + np.arange(total)
    return ids, cases, tcat[flat_src].astype(_f32, copy=False)


def build_compact_field(
    tree, shape, a_size, e_size, v_size, device, parametric=False,
    blk_size=None,
):
    """Compiled (origin, res, k0[, params]) -> v3 packed 1-D f32 buffer
    (5 + a_size/4 + a_size/4 + 2*e_size + v_size f32 words; see the
    module docstring for the layout). a_size must be a multiple of 4.
    """
    BLK = _blk_slots(a_size) if blk_size is None else int(blk_size)
    if parametric:
        from ..eval.parametric import _bind_params, param_spec, structural_hash

        tree.tree_hash()  # pre-cache node hashes before tracer binding
        key = (
            "param", structural_hash(tree), tuple(shape),
            a_size, e_size, v_size, BLK, device,
        )
    else:
        key = (
            tree.tree_hash(), tuple(shape), a_size, e_size, v_size, BLK,
            device,
        )
    fn = _cache.get(key)
    if fn is not None:
        return fn

    nk, nj, ni = (int(x) for x in shape)
    nx, ny, nz = ni - 1, nj - 1, nk - 1
    if nx * ny * nz >= MAX_CUBES:
        raise ValueError("grid too large for int32 cube ids")
    A = int(a_size)
    if A % 4:
        raise ValueError("a_size must be a multiple of 4")
    E = int(e_size)
    V = int(v_size)

    def impl(origin, res, k0):
        if device.platform == "cpu":
            grid = mc_emit.canonical_dense_grid_eval(
                tree, origin, res, (nk, nj, ni), k0=k0
            )
            return compact_emit(grid, res, A, E, V, blk_size=BLK)
        iz = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 0) + k0
        iy = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 1)
        ix = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 2)
        p = jnp.stack(
            [origin[0] + ix * res, origin[1] + iy * res, origin[2] + iz * res],
            axis=-1,
        )
        grid = tree.distance(p)
        return compact_emit(grid, res, A, E, V, blk_size=BLK)

    if parametric:
        spec = param_spec(tree)

        def impl_param(origin, res, k0, flat):
            with _bind_params(spec, flat):
                return impl(origin, res, k0)

        jitted_p = jax.jit(impl_param)

        def fn(origin, res, k0=np.float32(0), params=None, _j=jitted_p, _dev=device):
            with jax.default_device(_dev):
                return _j(
                    jax.device_put(origin, _dev),
                    _f32(res),
                    _f32(k0),
                    jax.device_put(params, _dev),
                )

        _cache[key] = fn
        return fn

    jitted = jax.jit(impl)

    def fn(origin, res, k0=np.float32(0), _jitted=jitted, _dev=device):
        with jax.default_device(_dev):
            return _jitted(jax.device_put(origin, _dev), _f32(res), _f32(k0))

    fn.jitted = jitted  # for .lower(...).compile() inspection
    _cache[key] = fn
    return fn


def compact_field_render(
    tree, origin, res, shape, device, size_hint=None, parametric=False, k0=0
):
    """One-dispatch, one-fetch minimal-payload render.

    Returns (ids (n_active,) uint32, cases (n_active,) uint8,
    tvals (n_verts,) f32, hint) — the host-side decoder (native.mc_decode)
    turns these into an indexed mesh or STL bytes. Grow-and-retry on
    buffer overflow, remembered hints per tree (the welded path's
    discipline). k0 offsets the grid's z index (slab dispatch): the
    returned ids are local to the slab."""
    nk, nj, ni = (int(x) for x in shape)
    ncubes = (nk - 1) * (nj - 1) * (ni - 1)
    if parametric:
        from ..eval.parametric import pack_params, structural_hash

        hint_key = ("hint-param", structural_hash(tree), tuple(shape))
        params = jnp.asarray(pack_params(tree))
    else:
        hint_key = ("hint", tree.tree_hash(), tuple(shape))
        params = None
    if size_hint is None:
        size_hint = _cache.get(hint_key)
    if size_hint:
        # 3-tuple hints (older callers/tests) get the conservative
        # default block budget
        if len(size_hint) == 4:
            a_size, v_size, e_size, blk_size = size_hint
        else:
            a_size, v_size, e_size = size_hint
            blk_size = _blk_slots(a_size)
    else:
        est = int(12 * ncubes ** (2 / 3)) + 4096
        a_size = _bucket(min(est, ncubes))
        v_size = _bucket(int(a_size * 1.5))
        e_size = _bucket(max(4096, a_size // 8), granule=4096)
        blk_size = _blk_slots(a_size)
    origin = np.asarray(origin, _f32)
    while True:
        fn = build_compact_field(
            tree, shape, a_size, e_size, v_size, device,
            parametric=parametric, blk_size=blk_size,
        )
        if parametric:
            packed = np.asarray(
                fn(jnp.asarray(origin), _f32(res), k0=_f32(k0), params=params)
            )
        else:
            packed = np.asarray(fn(jnp.asarray(origin), _f32(res), k0=_f32(k0)))
        ids, cases, tvals, (n_active, n_verts, n_exc, n_blk) = (
            unpack_compact_payload(packed, a_size, e_size)
        )
        if (
            n_active <= a_size
            and n_verts <= v_size
            and n_exc <= e_size
            and n_blk <= blk_size
        ):
            # warm block budget: the TRUE occupancy +25% headroom keeps
            # the dominant sort tight on repeat renders; n_blk == 0 means
            # the hierarchy didn't engage (small grid) — keep the
            # conservative default so a later engage can't start from a
            # guaranteed-overflow budget
            hint_blk = (
                min(blk_size, _bucket(int(n_blk * 1.25) + 1, granule=8192))
                if n_blk
                else _blk_slots(_bucket(n_active, granule=16384))
            )
            hint = (
                _bucket(n_active, granule=16384),
                _bucket(n_verts, granule=16384),
                _bucket(max(4096, n_exc), granule=4096),
                hint_blk,
            )
            if parametric:
                prev = _cache.get(hint_key)
                if prev:
                    hint = tuple(max(a, b) for a, b in zip(hint, prev))
            _cache[hint_key] = hint
            return ids, cases, tvals, hint
        if n_active > a_size:
            a_size = _bucket(n_active, granule=16384)
        if n_verts > v_size:
            v_size = _bucket(n_verts, granule=16384)
        if n_exc > e_size:
            e_size = _bucket(n_exc, granule=4096)
        if n_blk > blk_size:
            blk_size = _bucket(n_blk, granule=8192)


def compact_field_render_slabbed(
    tree, origin, res, shape, device, max_points, parametric=False
):
    """Compact-field render for grids past the single-dispatch memory gate:
    the kernel is dispatched per z-slab (k0 offsets, 1-plane overlap) and
    slab payloads concatenate into EXACTLY the whole-grid payload — the
    payload-concatenation identity the sharded path relies on
    (docs/MULTICHIP.md); the reference analogously streams any grid size
    through fixed buffers (glrender/octreerenderer.go:131-178).

    Returns (ids (A,) uint32 GLOBAL cube ids, cases, tvals, n_points
    evaluated). One buffer size is used for every slab (grow-only —
    the running hint is the componentwise MAX of sizes seen, never the
    re-bucketed-down per-call hint), so all equal-height slabs share
    one executable.
    """
    nk, nj, ni = (int(x) for x in shape)
    nx, ny, nz = ni - 1, nj - 1, nk - 1
    if nx * ny * nz >= MAX_CUBES:
        raise ValueError("grid too large for int32 cube ids")
    plane = nj * ni
    n_slabs = max(1, -(-nk * plane // int(max_points)))
    bounds_k = [nz * s // n_slabs for s in range(n_slabs + 1)]
    # seed the hint with the per-slab estimate compact_field_render would
    # make for the TALLEST slab, so slab 0 and the rest size identically
    max_dk = max(
        (bounds_k[s + 1] - bounds_k[s] for s in range(n_slabs)), default=0
    )
    ncubes_slab = nx * ny * max(max_dk, 1)
    est = int(12 * ncubes_slab ** (2 / 3)) + 4096
    a0 = _bucket(min(est, ncubes_slab))
    hint = (
        a0,
        _bucket(int(a0 * 1.5)),
        _bucket(max(4096, a0 // 8), granule=4096),
        _blk_slots(a0),
    )
    if parametric:
        from ..eval.parametric import structural_hash

        tkey = structural_hash(tree)
    else:
        tkey = tree.tree_hash()
    n_points = 0
    ids_parts, case_parts, t_parts = [], [], []
    for s in range(n_slabs):
        k0, k1 = bounds_k[s], bounds_k[s + 1]
        if k1 == k0:
            continue  # more slabs than cube layers (tiny test gates)
        slab_shape = (k1 - k0 + 1, nj, ni)
        n_points += slab_shape[0] * plane
        # fold in the hint compact_field_render remembered for this slab
        # shape on an earlier render of the same tree (passing an explicit
        # size_hint bypasses its own cache lookup): warm repeated renders
        # must not re-pay an overflow retry the first render already paid
        remembered = _cache.get(
            ("hint-param" if parametric else "hint", tkey, slab_shape)
        )
        if remembered:
            hint = tuple(max(a, b) for a, b in zip(hint, remembered))
        ids, cases, tvals, h = compact_field_render(
            tree, origin, res, slab_shape, device,
            size_hint=hint, parametric=parametric, k0=k0,
        )
        # grow-only: a retry inside compact_field_render re-buckets with
        # granule 16384 and its returned hint equals the grown size, so
        # max(passed, returned) is exactly the executable's buffer sizes
        hint = tuple(max(a, b) for a, b in zip(hint, h))
        ids_parts.append(ids.astype(np.uint32) + np.uint32(k0 * nx * ny))
        case_parts.append(cases)
        t_parts.append(tvals)
    return (
        np.concatenate(ids_parts) if ids_parts else np.empty(0, np.uint32),
        np.concatenate(case_parts) if case_parts else np.empty(0, np.uint8),
        np.concatenate(t_parts).astype(_f32) if t_parts else np.empty(0, _f32),
        n_points,
    )
