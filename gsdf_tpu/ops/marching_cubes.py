"""Vectorized device-side marching cubes — the STAGED pipeline.

Device-side replacement for the reference's per-cube CPU marching cubes
(glrender/marchcubes.go:14-98). The per-cube loop becomes three phases:

1. classify (jit): 256-case index + corner-0 quick-reject
   (|d0| > 2*sqrt3*res, flatrenderer.go:218 / marchcubes.go:23).
2. compact: active cube linear indices in x-fastest cube order — the exact
   iteration order of the reference (flatrenderer.go:210-212), so triangle
   ORDER also matches.
3. emit (jit): gather/interpolate/emit on the active set.

All marching-cubes math lives in ops/mc_emit.py — the ONE shared emit
kernel every renderer (fused, welded, pruned, sharded, staged) composes,
mirroring the reference's single mcToTriangles consumed by all paths.
This staged variant exists for cross-checking and for grids too large for
one fused executable; production paths fuse the same pieces into one
dispatch (ops/fused_render.py, ops/fused_welded.py).

Grid convention: grid[k, j, i], shape (nz+1, ny+1, nx+1).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .mc_tables import MC_EDGE_PAIRS, MC_TRI_COUNT, MC_TRI_TABLE  # noqa: F401
from . import mc_emit
from .mc_emit import (  # noqa: F401  (back-compat re-exports)
    CORNER_OFFSETS as _CORNER_OFFSETS,
    CUBE_DIAG_FACTOR as _CUBE_DIAG_FACTOR,
    MC_EPS as _MC_EPS,
    bucket as _bucket,
)

_f32 = np.float32


@functools.partial(jax.jit, static_argnums=())
def _classify(grid, res):
    """Per-cube triangle counts (nz,ny,nx), activity mask, totals."""
    corners = mc_emit.cube_corner_views(grid)
    index = mc_emit.case_index(corners)
    counts = jnp.asarray(MC_TRI_COUNT)[index]
    keep = jnp.abs(corners[0]) <= _CUBE_DIAG_FACTOR * res
    counts = jnp.where(keep, counts, 0)
    active = counts > 0
    return counts, active, jnp.sum(counts), jnp.sum(active.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("size",))
def _active_indices(active, size):
    (idx,) = jnp.nonzero(active.ravel(), size=size, fill_value=-1)
    return idx


@functools.partial(jax.jit, static_argnames=("nx", "ny", "out_size"))
def _emit_compact(grid, cube_idx, origin, res, nx, ny, out_size):
    """Emit + device-side exact compaction via the shared kernel: returns
    (out_size, 3, 3) float32 with the first `total` rows holding triangles
    in reference order. Only this compact payload crosses the link."""
    nj, ni = grid.shape[1], grid.shape[2]
    safe = jnp.maximum(cube_idx, 0)
    ci = safe % nx
    cj = (safe // nx) % ny
    ck = safe // (nx * ny)
    base_lin = ck * (nj * ni) + cj * ni + ci
    v = mc_emit.gather_corners(grid.reshape(-1), base_lin, ni, nj * ni)
    pc = mc_emit.corner_positions(
        origin,
        res,
        ci.astype(jnp.float32),
        cj.astype(jnp.float32),
        ck.astype(jnp.float32),
    )
    tris, total = mc_emit.emit_triangles(v, pc, cube_idx >= 0, out_size)
    return tris, total


def marching_cubes_grid(grid, origin, res, device=None):
    """Run marching cubes over a device-resident corner grid.

    grid: jnp (nz+1, ny+1, nx+1) float32 distances
    origin: (3,) float32 position of grid[0,0,0]
    res: cube edge length

    Returns (triangles np (T,3,3) float32, total_active_cubes int).
    Triangle order matches the reference flat renderer exactly.
    """
    grid = jnp.asarray(grid)
    ny = grid.shape[1] - 1
    nx = grid.shape[2] - 1
    res = _f32(res)
    origin = jnp.asarray(np.asarray(origin, _f32))

    counts, active, total_tris, n_active = _classify(grid, res)
    n_active = int(n_active)
    total_tris = int(total_tris)
    if n_active == 0:
        return np.empty((0, 3, 3), _f32), 0
    size = _bucket(n_active)
    idx = _active_indices(active, size)
    out_size = _bucket(total_tris)
    tris, _ = _emit_compact(grid, idx, origin, res, nx, ny, out_size)
    return np.asarray(tris)[:total_tris], n_active
