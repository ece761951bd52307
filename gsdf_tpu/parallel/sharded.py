"""Multi-chip rendering: shard the voxel grid across a 1-D device mesh.

The reference's only process-level parallelism is goroutine k-plane
partitioning of the dense grid (glrender/flatrenderer.go:103-141). The
Device scale-out analog: shard the z (slab) axis of the corner grid over
a `jax.sharding.Mesh`, evaluate each shard's slab locally (pure data
parallel — zero communication, positions synthesized on device), then
exchange a single boundary plane with the +z neighbor (ppermute over ICI)
so each shard can classify the cubes between its planes. Compacted triangle
payloads are all-gathered at the end — the only collective proportional to
output size, matching SURVEY.md §2.10's design note.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.node import Shader3D
from ..ops import mc_emit

_f32 = np.float32

AXIS = "slab"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (AXIS,))


def _replicated(mesh: Mesh, value, dtype=_f32):
    """Commit a host value to the mesh's own devices, replicated.

    Every operand of a sharded step must be created ON the mesh —
    `jnp.asarray` would place it on the process default device (the
    accelerator when one is attached), which both wastes a transfer and breaks
    hermetic CPU-mesh runs (the driver's dryrun_multichip). Integer
    operands (the slab-chunk k_base) must pass dtype=np.int32: the
    default f32 cast would silently round layer offsets >= 2^24."""
    return jax.device_put(
        np.asarray(value, dtype), NamedSharding(mesh, P())
    )


def sharded_grid_eval(tree: Shader3D, mesh: Mesh, shape, origin, res):
    """Evaluate a (nk,nj,ni) corner grid with the k axis sharded over the
    mesh. nk must be divisible by mesh size. Returns a global jax.Array with
    sharding P(AXIS, None, None)."""
    nk, nj, ni = (int(x) for x in shape)
    n_dev = mesh.devices.size
    if nk % n_dev != 0:
        raise ValueError(f"slab axis {nk} not divisible by {n_dev} devices")
    nk_local = nk // n_dev
    origin = _replicated(mesh, origin)
    res = _replicated(mesh, res)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(AXIS, None, None),
        check_vma=False,  # pure DP step; lax.scan carries in deep trees
        # (polygon edges, scan-grouped unions) start as unvarying consts
    )
    def impl(origin, res):
        k0 = jax.lax.axis_index(AXIS) * nk_local
        if mesh.devices.flat[0].platform == "cpu":
            # slab values bit-match the single-device whole-grid kernels
            return mc_emit.canonical_dense_grid_eval(
                tree, origin, res, (nk_local, nj, ni), k0=k0
            )
        iz = jax.lax.broadcasted_iota(jnp.float32, (nk_local, nj, ni), 0) + k0
        iy = jax.lax.broadcasted_iota(jnp.float32, (nk_local, nj, ni), 1)
        ix = jax.lax.broadcasted_iota(jnp.float32, (nk_local, nj, ni), 2)
        p = jnp.stack(
            [origin[0] + ix * res, origin[1] + iy * res, origin[2] + iz * res],
            axis=-1,
        )
        return tree.distance(p)

    return jax.jit(impl)(origin, res)


def sharded_render_step(tree: Shader3D, mesh: Mesh, shape, max_tris_per_shard: int):
    """Build the full multi-chip render step: sharded grid eval + halo
    exchange + per-shard marching cubes + all-gather of triangle payloads.

    Returns a jitted fn (origin, res) -> (tris (n_dev, max_tris, 3, 3),
    counts (n_dev,)) where counts[d] is the number of valid triangles from
    shard d. Triangles of shard d are in reference cube order within the
    shard, so concatenation preserves global order. Steps are cached per
    (tree, shape, M, mesh) like the compact/DC steps — a fresh jit per
    call would re-pay the full mesh compile on every render.
    """
    from ..ops.mc_emit import dense_grid_mc

    nk, nj, ni = (int(x) for x in shape)
    n_dev = mesh.devices.size
    if nk % n_dev != 0:
        raise ValueError(f"slab axis {nk} not divisible by {n_dev} devices")
    nk_local = nk // n_dev
    M = int(max_tris_per_shard)
    key = ("soup", tree.tree_hash(), (nk, nj, ni), M, mesh)
    cached = _step_cache.get(key)
    if cached is not None:
        return cached

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(AXIS, None, None, None), P(AXIS), P(AXIS)),
        check_vma=False,  # see sharded_grid_eval
    )
    def step(origin, res):
        me = jax.lax.axis_index(AXIS)
        k0 = me * nk_local
        # local slab + one extra plane (halo) evaluated redundantly: one
        # plane of recompute beats a ppermute dependency chain at this size,
        # and keeps the step collective-free until the final gather.
        if mesh.devices.flat[0].platform == "cpu":
            grid_ext = mc_emit.canonical_dense_grid_eval(
                tree, origin, res, (nk_local + 1, nj, ni), k0=k0
            )
        else:
            iz = jax.lax.broadcasted_iota(jnp.float32, (nk_local + 1, nj, ni), 0) + k0
            iy = jax.lax.broadcasted_iota(jnp.float32, (nk_local + 1, nj, ni), 1)
            ix = jax.lax.broadcasted_iota(jnp.float32, (nk_local + 1, nj, ni), 2)
            p = jnp.stack(
                [origin[0] + ix * res, origin[1] + iy * res, origin[2] + iz * res],
                axis=-1,
            )
            grid_ext = tree.distance(p)
        # shared MC-emit kernel over this shard's cubes; grid_ext includes
        # the +z halo plane, k0 keeps positions bit-exact with whole-grid
        tris, n_act, total = dense_grid_mc(
            grid_ext, origin, res, k0.astype(jnp.float32), M, M
        )
        return tris[None], total[None], n_act[None]

    jitted = jax.jit(step)
    _step_cache[key] = jitted
    return jitted


_step_cache: dict = {}


def sharded_compact_step(
    tree: Shader3D, mesh: Mesh, shape, a_size: int, v_size: int,
    e_size: int = 8192, parametric: bool = False, blk_size=None,
):
    """Multi-chip COMPACT-FIELD render step (the production path,
    ops/compact_field.py, sharded): each shard evaluates its z-slab
    (+1 halo plane), classifies, compacts its active cubes and crossing
    owner-edge interpolation parameters, and emits one v2 packed buffer
    (delta-encoded ids — ops/compact_field.py module docstring).

    Cube ids are LOCAL to the slab; global id = local + k0*nx*ny, and
    slab order equals global z-order, so the host-side concatenation of
    shard payloads is EXACTLY the single-device compact payload — the
    native decoder (native.mc_decode) consumes it unchanged, owner
    references across slab boundaries resolving in the merged active
    set. No collectives: the only cross-shard data is one redundantly
    evaluated halo plane.

    The emit itself is ops/compact_field.compact_emit — the SAME
    implementation the single-device builder compiles, so any epsilon or
    packing change keeps sharded-vs-single bit-exactness by construction.

    parametric=True traces once per tree STRUCTURE and takes the packed
    continuous-parameter vector as a third (replicated) operand — the
    single-device zero-recompile editing story (eval/parametric.py),
    extended to the mesh. Steps are cached per (tree, shape, sizes, mesh).
    """
    from ..ops.compact_field import _blk_slots, compact_emit

    nk, nj, ni = (int(x) for x in shape)
    n_dev = mesh.devices.size
    if nk % n_dev != 0:
        raise ValueError(f"slab axis {nk} not divisible by {n_dev} devices")
    nk_local = nk // n_dev
    A = int(a_size)
    if A % 4:
        raise ValueError("a_size must be a multiple of 4")
    E = int(e_size)
    V = int(v_size)
    BLK = _blk_slots(A) if blk_size is None else int(blk_size)

    if parametric:
        from ..eval.parametric import _bind_params, param_spec, structural_hash

        tree.tree_hash()  # pre-cache node hashes before tracer binding
        key = ("param", structural_hash(tree), tuple(shape), A, E, V, BLK, mesh)
    else:
        key = (tree.tree_hash(), tuple(shape), A, E, V, BLK, mesh)
    cached = _step_cache.get(key)
    if cached is not None:
        return cached

    def body(origin, res, k_base):
        me = jax.lax.axis_index(AXIS)
        # k_base (traced, replicated int32) offsets this dispatch within
        # the global layer space: the slab-chunk composition re-dispatches
        # one executable per z-chunk (render_sharded_compact max_points_
        # per_shard); k_base=0 is the classic whole-grid call. The global
        # layer index is computed in int32 and cast ONCE, so positions
        # bit-match the whole-grid render's global f32 iota.
        k0 = me * nk_local + k_base
        if mesh.devices.flat[0].platform == "cpu":
            grid = mc_emit.canonical_dense_grid_eval(
                tree, origin, res, (nk_local + 1, nj, ni), k0=k0
            )
            return compact_emit(grid, res, A, E, V, blk_size=BLK)[None]
        iz = (
            jax.lax.broadcasted_iota(jnp.int32, (nk_local + 1, nj, ni), 0)
            + k0
        ).astype(jnp.float32)
        iy = jax.lax.broadcasted_iota(jnp.float32, (nk_local + 1, nj, ni), 1)
        ix = jax.lax.broadcasted_iota(jnp.float32, (nk_local + 1, nj, ni), 2)
        p = jnp.stack(
            [origin[0] + ix * res, origin[1] + iy * res, origin[2] + iz * res],
            axis=-1,
        )
        grid = tree.distance(p)  # local slab + one +z halo plane
        return compact_emit(grid, res, A, E, V, blk_size=BLK)[None]

    if parametric:
        spec = param_spec(tree)

        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=P(AXIS, None),
            check_vma=False,  # see sharded_grid_eval
        )
        def step(origin, res, k_base, flat):
            with _bind_params(spec, flat):
                return body(origin, res, k_base)

    else:

        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), P(), P()),
            out_specs=P(AXIS, None),
            check_vma=False,  # see sharded_grid_eval
        )
        def step(origin, res, k_base):
            return body(origin, res, k_base)

    jitted = jax.jit(step)
    _step_cache[key] = jitted
    return jitted


def render_sharded_compact(
    tree: Shader3D, mesh: Mesh, res: float, size_hint=None, parametric=False,
    max_points_per_shard=None,
):
    """Multi-chip production render: returns (verts (V,3) f32,
    tri_idx (T,3) i32) — identical arrays to the single-device
    FlatRenderer.render_compact (same enumeration order).

    parametric=True compiles per tree STRUCTURE: re-rendering an edited
    (structurally identical) tree reuses the mesh executable with zero
    new compiles — the same contract as render_compact(parametric=True),
    scaled out. Payload-size hints are remembered per structure and only
    grow, so successive edits don't thrash (a_size, v_size) shapes.

    max_points_per_shard composes sharding with the slab dispatch (the
    single-device compact_field_render_slabbed discipline, docs/
    MULTICHIP.md): when one whole-grid dispatch would exceed a shard's
    memory gate, the global z-layer space is partitioned into chunks of
    c_local*n_dev layers, dispatched through ONE executable with a
    traced k_base operand — slab positions stay bit-exact with the
    whole-grid render, and chunk payloads concatenate into exactly the
    whole-grid payload. The int32 cube-id space (MAX_CUBES) still bounds
    the GRID: past 2^31 cubes the wire format's u32 ids would wrap, so
    the path raises cleanly instead."""
    import math as _math

    from ..native import mc_decode
    from ..ops.marching_cubes import _bucket

    bb = tree.bounds().scale_centered((1.01, 1.01, 1.01))
    sz = bb.size()
    res32 = _f32(res)
    nx = int(_math.ceil(_f32(sz[0]) / res32))
    ny = int(_math.ceil(_f32(sz[1]) / res32))
    nz = int(_math.ceil(_f32(sz[2]) / res32))
    if nx <= 0 or ny <= 0 or nz <= 0:
        # inverted (empty-intersection) bounds — reject like the
        # single-device renderers (flatrenderer.go:54)
        raise ValueError("resolution not fine enough for marching cubes")
    n_dev = mesh.devices.size
    nk = nz + 1
    if nk % n_dev:
        nk += n_dev - nk % n_dev

    # slab-chunk composition: chunks of C = c_local*n_dev cube layers,
    # one shared executable re-dispatched with k_base = chunk*C
    plane = (ny + 1) * (nx + 1)
    if max_points_per_shard is not None:
        # clamp to the real grid: an ample budget must not make shards
        # evaluate (or the MAX_CUBES guard count) far-field padding
        # beyond the whole-grid slab split
        c_local = max(1, min(int(max_points_per_shard) // plane - 1,
                             nk // n_dev))
        C = c_local * n_dev
        n_chunks = -(-nk // C)
    else:
        c_local = nk // n_dev
        C = nk
        n_chunks = 1
    nk_total = n_chunks * C  # padded; extra layers cull in the far field
    if nk_total >= 1 << 24:
        # layer indices are cast to f32 for position synthesis; past
        # 2^24 the cast rounds and slabs silently desync from the
        # whole-grid render
        raise ValueError("grid too tall for exact f32 layer indices")
    shape = (C, ny + 1, nx + 1)
    nz_padded = nk_total - 1  # decode space includes padded slabs
    from ..ops.compact_field import MAX_CUBES

    if nx * ny * nz_padded >= MAX_CUBES:
        # global ids (local + (chunk*C + d*c_local)*nx*ny) and the
        # decoder's slot map are int32-bounded, same limit as the
        # single-device builder
        raise ValueError("grid too large for int32 cube ids")
    origin = _replicated(mesh, bb.min)
    res_dev = _replicated(mesh, res32)
    if parametric:
        from ..eval.parametric import pack_params, structural_hash

        hint_key = ("shard-hint", structural_hash(tree), shape, n_chunks, mesh)
        params = _replicated(mesh, pack_params(tree))
    else:
        hint_key = None
        params = None
    if size_hint is None and hint_key is not None:
        size_hint = _step_cache.get(hint_key)
    from ..ops.compact_field import _blk_slots, unpack_compact_payload

    if size_hint:
        if len(size_hint) == 4:
            a_size, v_size, e_size, blk_size = size_hint
        else:
            a_size, v_size, e_size = size_hint
            blk_size = _blk_slots(a_size)
    else:
        ncubes_local = nx * ny * c_local
        est = int(12 * ncubes_local ** (2 / 3)) + 4096
        a_size = _bucket(min(est, ncubes_local))
        v_size = _bucket(int(a_size * 1.5))
        e_size = _bucket(max(4096, a_size // 8), granule=4096)
        blk_size = _blk_slots(a_size)

    ids_parts, case_parts, t_parts = [], [], []
    for chunk in range(n_chunks):
        kb = _replicated(mesh, np.int32(chunk * C), dtype=np.int32)
        # grow-only sizes shared across chunks: every chunk reuses one
        # executable once sizes stabilize (slabbed-path discipline)
        while True:
            step = sharded_compact_step(
                tree, mesh, shape, a_size, v_size, e_size,
                parametric=parametric, blk_size=blk_size,
            )
            args = (
                (origin, res_dev, kb, params)
                if parametric
                else (origin, res_dev, kb)
            )
            packed = np.ascontiguousarray(np.asarray(step(*args)))
            counts = np.ascontiguousarray(packed[:, :5]).view(np.uint32)
            worst_a = int(counts[:, 0].max(initial=0))
            worst_v = int(counts[:, 1].max(initial=0))
            worst_e = int(counts[:, 2].max(initial=0))
            worst_b = int(counts[:, 4].max(initial=0))
            if (
                worst_a <= a_size
                and worst_v <= v_size
                and worst_e <= e_size
                and worst_b <= blk_size
            ):
                break
            if worst_a > a_size:
                a_size = _bucket(worst_a, granule=16384)
            if worst_v > v_size:
                v_size = _bucket(worst_v, granule=16384)
            if worst_e > e_size:
                e_size = _bucket(worst_e, granule=4096)
            if worst_b > blk_size:
                blk_size = _bucket(worst_b, granule=8192)
        for d in range(n_dev):
            ids, cases_d, t_d, _counts = unpack_compact_payload(
                packed[d], a_size, e_size
            )
            # local slab id -> global id (chunk-major, slab order IS
            # global z-order)
            ids_parts.append(
                ids + np.uint32((chunk * C + d * c_local) * nx * ny)
            )
            case_parts.append(cases_d)
            t_parts.append(t_d)
    if hint_key is not None:
        # grow-only: successive edits keep one executable per structure
        _step_cache[hint_key] = (a_size, v_size, e_size, blk_size)
    ids = np.concatenate(ids_parts)
    cases = np.concatenate(case_parts)
    tvals = np.concatenate(t_parts).astype(_f32)
    return mc_decode(ids, cases, tvals, nx, ny, nz_padded, bb.min, res32)


def render_sharded(tree: Shader3D, mesh: Mesh, res: float, max_tris_per_shard=1 << 18):
    """Full multi-chip render: returns (T,3,3) float32 triangles on host.

    Grid sizing matches FlatRenderer; nk is padded up to a multiple of the
    mesh size (extra slabs lie outside bounds and produce no triangles --
    they evaluate beyond the far field where the quick-reject culls them).
    """
    import math as _math

    bb = tree.bounds().scale_centered((1.01, 1.01, 1.01))
    sz = bb.size()
    res32 = _f32(res)
    nx = int(_math.ceil(_f32(sz[0]) / res32))
    ny = int(_math.ceil(_f32(sz[1]) / res32))
    nz = int(_math.ceil(_f32(sz[2]) / res32))
    if nx <= 0 or ny <= 0 or nz <= 0:
        # inverted (empty-intersection) bounds — reject like the
        # single-device renderers (flatrenderer.go:54)
        raise ValueError("resolution not fine enough for marching cubes")
    n_dev = mesh.devices.size
    nk = nz + 1
    if nk % n_dev:
        nk += n_dev - nk % n_dev
    origin = _replicated(mesh, bb.min)
    res_dev = _replicated(mesh, res32)
    M = int(max_tris_per_shard)
    while True:
        step = sharded_render_step(tree, mesh, (nk, ny + 1, nx + 1), M)
        tris, counts, n_act = step(origin, res_dev)
        counts = np.asarray(counts)
        n_act = np.asarray(n_act)
        worst = max(counts.max(initial=0), n_act.max(initial=0))
        if worst <= M:
            break
        # grow-and-retry: never silently truncate (the same discipline as
        # the single-device fused path, ops/fused_render.py)
        while worst > M:
            M *= 2
    tris = np.asarray(tris)
    out = [tris[d, : counts[d]] for d in range(tris.shape[0])]
    return np.concatenate(out, axis=0)
