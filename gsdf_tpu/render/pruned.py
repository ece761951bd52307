"""Pruned tile renderer — the device-side equivalent of the reference's
heapless octree marching-cubes renderer (glrender/octreerenderer.go).

The reference decomposes an octree, evaluates cube centers breadth-first
and discards cubes whose center distance exceeds size*sqrt(3)/2
(octreePrunea, octreerenderer.go:240-284) — skipping ~90-96% of fine
evaluations on typical parts (README.md:116,152).

The device mapping is a fixed two-level mask pyramid (SURVEY.md §7):
1. coarse pass: ONE fused eval of all tile centers; a tile of side S*res
   is pruned when |d(center)| >= S*res*sqrt(3)/2 — the identical
   conservative criterion, vectorized.
2. fine pass: corner grids of surviving tiles only, evaluated as one
   batched (T, S+1, S+1, S+1) dispatch, marching cubes per tile.

Pull-based streaming (`read_triangles`) and `render_all` mirror the
reference Renderer contract (glrender/glrender.go:11-17): triangles arrive
in tile batches, bounding host memory for huge renders.

Caveat shared with the reference: pruning is exact only for 1-Lipschitz
fields; ops like Twist/Scale compositions can exceed that (the reference's
octree has the same property).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..core.node import Shader3D
from ..ops import mc_emit
from ..ops.marching_cubes import _bucket

_f32 = np.float32

_kernel_cache: dict = {}


def _coarse_fn(tree, shape, device, parametric=False):
    if parametric:
        from ..eval.parametric import _bind_params, param_spec, structural_hash

        tree.tree_hash()  # pre-cache node hashes before tracer binding
        key = ("coarse-param", structural_hash(tree), shape, device)
    else:
        key = ("coarse", tree.tree_hash(), shape, device)
    fn = _kernel_cache.get(key)
    if fn is None:
        nk, nj, ni = shape

        def impl(origin, res, tile):
            # tile center positions: origin + (idx + 0.5)*tile*res
            iz = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 0)
            iy = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 1)
            ix = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 2)
            half = tile * res * _f32(0.5)
            p = jnp.stack(
                [
                    origin[0] + ix * (tile * res) + half,
                    origin[1] + iy * (tile * res) + half,
                    origin[2] + iz * (tile * res) + half,
                ],
                axis=-1,
            )
            d = tree.distance(p)
            # prune: |d| >= tile_size * sqrt(3)/2 (octreerenderer.go:262)
            keep = jnp.abs(d) < tile * res * _f32(math.sqrt(3) / 2)
            return keep, jnp.sum(keep.astype(jnp.int32))

        if parametric:
            spec = param_spec(tree)

            def impl_param(origin, res, tile, flat):
                with _bind_params(spec, flat):
                    return impl(origin, res, tile)

            jitted_p = jax.jit(impl_param)

            def fn(origin, res, tile, params=None, _j=jitted_p, _dev=device):
                with jax.default_device(_dev):
                    return _j(
                        jax.device_put(origin, _dev), _f32(res), _f32(tile),
                        jax.device_put(params, _dev),
                    )

            _kernel_cache[key] = fn
            return fn

        jitted = jax.jit(impl)

        def fn(origin, res, tile, params=None, _jitted=jitted, _dev=device):
            with jax.default_device(_dev):
                return _jitted(jax.device_put(origin, _dev), _f32(res), _f32(tile))

        _kernel_cache[key] = fn
    return fn


def _tile_grid(tree, tile_ijk, origin, res, S, platform):
    """The ONE tile position-synthesis + eval shared by both pruned
    kernels (soup _tile_mc_fn and compact _tile_compact_fn), so their
    grid values can never drift apart (the pinned pruned-vs-dense
    parity depends on it). tile_ijk (T,3) [i,j,k] tile coords, negative
    = padding rows (evaluated at tile 0, masked by callers). Returns
    (T,S+1,S+1,S+1) corner distances, [k,j,i] within each tile.

    On CPU the eval routes through mc_emit.canonical_grid_eval — the
    same compiled eval loop as the dense/staged/sharded kernels — so
    the atlas values (and hence the edge-interpolation t) are BIT-EXACT
    vs the dense grid. On the GPU the fused synthesis below is
    bit-exact vs dense (a `gpu` test pins it); see
    canonical_grid_eval's docstring for the asymmetry rationale."""
    P = S + 1
    T = tile_ijk.shape[0]
    if platform == "cpu":
        basei = jnp.maximum(tile_ijk, 0) * S  # (T,3) int32 global offsets
        izi = jax.lax.broadcasted_iota(jnp.int32, (T, P, P, P), 1)
        iyi = jax.lax.broadcasted_iota(jnp.int32, (T, P, P, P), 2)
        ixi = jax.lax.broadcasted_iota(jnp.int32, (T, P, P, P), 3)
        return mc_emit.canonical_grid_eval(
            tree,
            origin,
            res,
            basei[:, 0, None, None, None] + ixi,
            basei[:, 1, None, None, None] + iyi,
            basei[:, 2, None, None, None] + izi,
        )
    base = jnp.maximum(tile_ijk, 0).astype(jnp.float32) * _f32(S)
    iz = jax.lax.broadcasted_iota(jnp.float32, (T, P, P, P), 1)
    iy = jax.lax.broadcasted_iota(jnp.float32, (T, P, P, P), 2)
    ix = jax.lax.broadcasted_iota(jnp.float32, (T, P, P, P), 3)
    p = jnp.stack(
        [
            origin[0] + (base[:, 0, None, None, None] + ix) * res,
            origin[1] + (base[:, 1, None, None, None] + iy) * res,
            origin[2] + (base[:, 2, None, None, None] + iz) * res,
        ],
        axis=-1,
    )
    return tree.distance(p)


def _tile_mc_fn(tree, S, n_tiles, a_size, t_size, device):
    """Batched per-tile corner eval + marching cubes.

    Active cubes are compacted BEFORE edge interpolation (a_size slots),
    exactly like the fused dense path — interpolation cost scales with
    surface cubes, not tile volume.

    Inputs: tile_ijk (n_tiles, 3) int32 tile indices (-1 padded).
    Returns (tris (t_size,3,3), n_active, total_tris).
    """
    key = ("tilemc", tree.tree_hash(), S, n_tiles, a_size, t_size, device)
    fn = _kernel_cache.get(key)
    if fn is None:
        P = S + 1  # corner planes per tile

        def impl(tile_ijk, origin, res):
            grid = _tile_grid(tree, tile_ijk, origin, res, S, device.platform)
            valid_tile = (tile_ijk[:, 0] >= 0)[:, None, None, None]
            index, active = mc_emit.classify(grid, res, extra_mask=valid_tile)
            n_active = jnp.sum(active.astype(jnp.int32))

            # compact active cube slots: flat id = ((t*S+k)*S+j)*S+i
            cube_id = mc_emit.compact_indices(active.reshape(-1), a_size)

            safe = jnp.maximum(cube_id, 0)
            ci = safe % S
            cj = (safe // S) % S
            ck = (safe // (S * S)) % S
            ct = safe // (S * S * S)  # tile slot

            # gather the 8 corner values from the tile grid atlas
            base_lin = ct * (P * P * P) + ck * (P * P) + cj * P + ci
            v = mc_emit.gather_corners(grid.reshape(-1), base_lin, P, P * P)
            # tile corner-index offsets [i,j,k] (same formula as
            # _tile_grid's position synthesis)
            base = jnp.maximum(tile_ijk, 0).astype(jnp.float32) * _f32(S)
            tb = base[ct]  # (A,3)
            pc = mc_emit.corner_positions(
                origin,
                res,
                tb[:, 0] + ci.astype(jnp.float32),
                tb[:, 1] + cj.astype(jnp.float32),
                tb[:, 2] + ck.astype(jnp.float32),
            )
            out, total = mc_emit.emit_triangles(v, pc, cube_id >= 0, t_size)
            return out, n_active, total

        jitted = jax.jit(impl)

        def fn(tile_ijk, origin, res, _jitted=jitted, _dev=device):
            with jax.default_device(_dev):
                return _jitted(
                    jax.device_put(tile_ijk, _dev), jax.device_put(origin, _dev), _f32(res)
                )

        _kernel_cache[key] = fn
    return fn


def _tile_compact_fn(tree, S, n_tiles, a_size, v_size, dims, device, parametric=False):
    """Batched per-tile corner eval + compact-field emit (GLOBAL cube ids).

    The pruned counterpart of ops.compact_field.build_compact_field:
    same shared emit helpers, v1 (full-id) wire layout — tile batches are
    tile-major, not id-ascending, so the dense path's delta encoding
    doesn't apply. Merged batch payloads DECODE to exactly the dense
    path's (ids, cases, t) arrays (merge_compact_payloads)."""
    if parametric:
        from ..eval.parametric import _bind_params, param_spec, structural_hash

        tree.tree_hash()  # pre-cache node hashes before tracer binding
        key = (
            "tilecompact-param", structural_hash(tree),
            S, n_tiles, a_size, v_size, dims, device,
        )
    else:
        key = (
            "tilecompact", tree.tree_hash(),
            S, n_tiles, a_size, v_size, dims, device,
        )
    fn = _kernel_cache.get(key)
    if fn is None:
        from ..ops.compact_field import tile_compact_emit

        def impl(tile_ijk, origin, res):
            grid = _tile_grid(tree, tile_ijk, origin, res, S, device.platform)
            return tile_compact_emit(grid, tile_ijk, dims, res, a_size, v_size)

        if parametric:
            spec = param_spec(tree)

            def impl_param(tile_ijk, origin, res, flat):
                with _bind_params(spec, flat):
                    return impl(tile_ijk, origin, res)

            jitted_p = jax.jit(impl_param)

            def fn(tile_ijk, origin, res, params=None, _j=jitted_p, _dev=device):
                with jax.default_device(_dev):
                    return _j(
                        jax.device_put(tile_ijk, _dev),
                        jax.device_put(origin, _dev),
                        _f32(res),
                        jax.device_put(params, _dev),
                    )

            _kernel_cache[key] = fn
            return fn

        jitted = jax.jit(impl)

        def fn(tile_ijk, origin, res, params=None, _jitted=jitted, _dev=device):
            with jax.default_device(_dev):
                return _jitted(
                    jax.device_put(tile_ijk, _dev),
                    jax.device_put(origin, _dev),
                    _f32(res),
                )

        _kernel_cache[key] = fn
    return fn


class PrunedRenderer:
    """Two-level pruned marching-cubes renderer with streaming output."""

    def __init__(
        self,
        s: Shader3D,
        cube_resolution: float,
        tile_size: int = 8,
        tiles_per_batch: int = 2048,
        device=None,
    ):
        if cube_resolution <= 0:
            raise ValueError("invalid renderer cube resolution")
        self.s = s
        self.res = _f32(cube_resolution)
        self.S = int(tile_size)
        self.tiles_per_batch = int(tiles_per_batch)
        self.device = device if device is not None else jax.devices()[0]

        bb = s.bounds().scale_centered((1.01, 1.01, 1.01))
        sz = bb.size()
        self.nx = int(math.ceil(_f32(sz[0]) / self.res))
        self.ny = int(math.ceil(_f32(sz[1]) / self.res))
        self.nz = int(math.ceil(_f32(sz[2]) / self.res))
        if self.nx <= 0 or self.ny <= 0 or self.nz <= 0:
            # covers inverted (empty-intersection) bounds boxes too — the
            # reference renderers reject these the same way
            # (flatrenderer.go:54, octreerenderer.go:232)
            raise ValueError("resolution not fine enough for marching cubes")
        self.origin = bb.min
        self.tx = -(-self.nx // self.S)
        self.ty = -(-self.ny // self.S)
        self.tz = -(-self.nz // self.S)
        self._evaluations = 0
        self._total_pruned = 0
        self._batches = None

    def evaluations(self) -> int:
        """Distinct SDF points evaluated (coarse tile centers + fine
        corners of surviving tiles) — same contract as
        FlatRenderer.evaluations()."""
        return self._evaluations

    def total_pruned(self) -> int:
        """Fine-grid evaluations avoided by pruning (the reference reports
        TotalPruned*8 omitted evals, octreerenderer.go:66)."""
        return self._total_pruned

    def _prune(self, parametric=False, params=None):
        shape = (self.tz, self.ty, self.tx)
        fn = _coarse_fn(self.s, shape, self.device, parametric=parametric)
        # numpy operands pass straight through: the kernel wrappers
        # device_put onto THEIR device; jnp.asarray here would first
        # commit to the process default device (the _replicated hazard,
        # parallel/sharded.py) — a wasted transfer per call
        keep, n_keep = fn(
            self.origin, self.res, float(self.S), params=params
        )
        self._evaluations += self.tx * self.ty * self.tz
        keep = np.asarray(keep)
        n_keep = int(n_keep)
        tiles = np.argwhere(keep)  # (T,3) [k,j,i]
        # tile_ijk as [i,j,k]
        tiles = tiles[:, ::-1].astype(np.int32)
        pruned_tiles = keep.size - n_keep
        self._total_pruned += pruned_tiles * (self.S + 1) ** 3
        return tiles

    def read_triangles(self):
        """Yield triangle batches (np arrays); renderer-contract streaming."""
        tiles = self._prune()
        P3 = (self.S + 1) ** 3
        for start in range(0, len(tiles), self.tiles_per_batch):
            batch = tiles[start : start + self.tiles_per_batch]
            nb = _bucket(len(batch), minimum=64, granule=self.tiles_per_batch)
            nb = min(nb, self.tiles_per_batch)
            n_real = len(batch)
            if len(batch) < nb:
                pad = np.full((nb - len(batch), 3), -1, np.int32)
                batch = np.concatenate([batch, pad], axis=0)
            # surviving tiles contain surface; expect a surface sheet worth
            # of active cubes per tile (~S^2 scale); grow-and-retry covers
            # the rest. Hints are per-STRUCTURE and grow-only (like the
            # sharded path, parallel/sharded.py:301-303): when parametric
            # edits shift the surviving tile set between renders, a
            # per-batch-start hint would mispredict and re-pay retries;
            # one grown (a_size, t_size) pair stays valid and keeps one
            # executable per structure.
            hkey = ("hints", self.s.tree_hash(), float(self.res))
            hint = _kernel_cache.get(hkey)
            if hint is not None:
                a_size, t_size = hint
            else:
                a_size = _bucket(nb * self.S**2 * 3, minimum=4096)
                t_size = _bucket(a_size * 5 // 2, minimum=4096)
            while True:
                fn = _tile_mc_fn(self.s, self.S, nb, a_size, t_size, self.device)
                out, n_active, total = fn(
                    batch, self.origin, self.res
                )
                n_active = int(n_active)
                total = int(total)
                if n_active <= a_size and total <= t_size:
                    break
                if n_active > a_size:
                    a_size = _bucket(n_active)
                if total > t_size:
                    t_size = _bucket(max(total, a_size * 5 // 2))
            self._evaluations += n_real * P3
            _kernel_cache[hkey] = (a_size, t_size)
            yield np.asarray(out)[:total]

    def render(self) -> np.ndarray:
        parts = list(self.read_triangles())
        if not parts:
            return np.empty((0, 3, 3), _f32)
        return np.concatenate(parts, axis=0)

    def compact_payload(self, parametric=False):
        """Pruned compact-field payload: (ids u32, cases u8, tvals f32).
        For 1-Lipschitz fields the tile-survival criterion guarantees
        every active cube's tile survives, so ids/cases/connectivity are
        IDENTICAL to the dense path's
        (ops.compact_field.compact_field_render); t matches to float32
        round-off (a few tens of ulps: the tile-atlas eval fuses
        differently from the whole-grid kernel and the edge-interpolation
        quotient amplifies 1-ulp grid differences by cancellation;
        pinned in tests/test_pruned.py).

        parametric=True compiles per tree STRUCTURE (eval.parametric):
        edit the tree's continuous parameters and re-render with zero new
        executables (batch-size buckets recur across edits). The grid
        stays pinned to construction-time bounds — pin generous bounds
        (core.wrappers.with_bounds) before editing."""
        from ..ops.compact_field import (
            MAX_CUBES,
            merge_compact_payloads,
            unpack_compact_payload_full_ids,
        )
        from ..ops.mc_emit import bucket as _bk

        if self.nx * self.ny * self.nz >= MAX_CUBES:
            raise ValueError("grid too large for int32 cube ids")
        if parametric:
            from ..eval.parametric import pack_params, structural_hash

            params = pack_params(self.s)
            hkey = ("chints-param", structural_hash(self.s), float(self.res))
        else:
            params = None
            hkey = ("chints", self.s.tree_hash(), float(self.res))
        tiles = self._prune(parametric=parametric, params=params)
        dims = (self.nx, self.ny, self.nz)
        P3 = (self.S + 1) ** 3
        parts = []
        for start in range(0, len(tiles), self.tiles_per_batch):
            batch = tiles[start : start + self.tiles_per_batch]
            nb = _bucket(len(batch), minimum=64, granule=self.tiles_per_batch)
            nb = min(nb, self.tiles_per_batch)
            n_real = len(batch)
            if len(batch) < nb:
                pad = np.full((nb - len(batch), 3), -1, np.int32)
                batch = np.concatenate([batch, pad], axis=0)
            # per-structure grow-only hints (see read_triangles)
            hint = _kernel_cache.get(hkey)
            if hint is not None:
                a_size, v_size = hint
            else:
                a_size = _bk(nb * self.S**2 * 3, minimum=4096)
                v_size = _bk(a_size * 2, minimum=4096)
            while True:
                fn = _tile_compact_fn(
                    self.s, self.S, nb, a_size, v_size, dims, self.device,
                    parametric=parametric,
                )
                packed = np.asarray(
                    fn(batch, self.origin, self.res, params=params)
                )
                ids, cs, tv, (n_active, n_verts) = unpack_compact_payload_full_ids(
                    packed, a_size
                )
                if n_active <= a_size and n_verts <= v_size:
                    break
                if n_active > a_size:
                    a_size = _bk(n_active, granule=16384)
                if n_verts > v_size:
                    v_size = _bk(n_verts, granule=16384)
            self._evaluations += n_real * P3
            _kernel_cache[hkey] = (a_size, v_size)
            parts.append((ids, cs, tv))
        return merge_compact_payloads(parts)

    def render_compact(self, parametric=False):
        """Pruned compact-field render to an indexed mesh (verts, tri_idx)
        — the scaling production path: fine evaluation only touches
        surviving tiles (the reference's 95.7% prune headline,
        README.md:116) while the payload and decode are exactly the dense
        compact path's. Falls back to the dense welded path only on an
        unresolvable owner reference (non-Lipschitz fields).
        parametric=True: see compact_payload."""
        from ..native import mc_decode

        ids, cases, tvals = self.compact_payload(parametric=parametric)
        try:
            return mc_decode(
                ids, cases, tvals, self.nx, self.ny, self.nz,
                np.asarray(self.origin, _f32), self.res,
            )
        except ValueError:
            from .flat import FlatRenderer

            fr = FlatRenderer(self.s, self.res, device=self.device)
            out = fr.render_indexed()
            self._evaluations += fr.evaluations()
            return out


def render_all(renderer) -> np.ndarray:
    """Drain a streaming renderer (reference glrender.RenderAll,
    glrender.go:17)."""
    return renderer.render()
