"""Evaluation backends: jit-compiled batched SDF evaluation.

JAX replacement for the reference's gleval package:

- `SDF3`/`SDF2` evaluator wrappers replace gleval.SDF3CPU / SDF3Compute
  (gleval/cpu.go:80, gleval/gpu.go:56). One code path serves both the CPU
  oracle and the GPU — backend selection is a jax device, not a
  separate implementation.
- The VecPool scratch machinery (gleval/cpu.go:209) has no equivalent:
  XLA's buffer allocator owns temporaries.
- Compiled executables are cached by (tree structural hash, batch bucket,
  device) — the analog of the reference's shader-name-keyed program cache.
- `evaluate_grid` generates evaluation positions *on device* from origin +
  iota, so the HBM traffic per point is 4 output bytes instead of the
  reference's 12-byte SSBO upload + 4-byte readback (gleval/gpu_cgo.go:159).
"""
from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np

from ..core.node import Shader2D, Shader3D

_f32 = np.float32

_jit_cache: dict = {}


def clear_jit_cache() -> None:
    _jit_cache.clear()


def _bucket(n: int, minimum: int = 512) -> int:
    """Round batch length up to a power of two to bound recompile count."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def _get_compiled(tree, ndim: int, device) -> "jax.stages.Wrapped":
    key = (tree.tree_hash(), ndim, device)
    fn = _jit_cache.get(key)
    if fn is None:
        jitted = jax.jit(lambda p: tree.distance(p))

        def fn(p, _jitted=jitted, _dev=device):
            with jax.default_device(_dev):
                return _jitted(jax.device_put(p, _dev))

        _jit_cache[key] = fn
    return fn


class _EvaluatorBase:
    """Shared logic for 2D/3D evaluator wrappers."""

    _ndim = 3

    def __init__(self, s, device=None):
        self.s = s
        self.device = device if device is not None else jax.devices()[0]
        self._evaluations = 0
        # Construction-time smoke eval: catches broken distance
        # implementations early (reference gleval/cpu.go:26-31).
        smoke = np.zeros((1, self._ndim), _f32)
        d = self.evaluate(smoke)
        if d.shape != (1,):
            raise ValueError(f"bad distance output shape {d.shape}")
        self._evaluations = 0

    def evaluations(self) -> int:
        """Total number of SDF point evaluations (reference gleval/cpu.go:126)."""
        return self._evaluations

    def bounds(self):
        return self.s.bounds()

    def evaluate(self, pos: np.ndarray) -> np.ndarray:
        """Evaluate distances at pos (N,ndim) float32, returning (N,) float32."""
        pos = np.ascontiguousarray(pos, dtype=_f32)
        if pos.ndim != 2 or pos.shape[1] != self._ndim:
            raise ValueError(f"expected (N,{self._ndim}) positions, got {pos.shape}")
        n = pos.shape[0]
        if n == 0:
            return np.empty(0, _f32)
        nb = _bucket(n)
        if nb != n:
            pos = np.concatenate([pos, np.zeros((nb - n, self._ndim), _f32)], axis=0)
        fn = _get_compiled(self.s, self._ndim, self.device)
        out = np.asarray(fn(jnp.asarray(pos)))
        self._evaluations += n
        return out[:n]

    def evaluate_device(self, pos):
        """Device-resident evaluation: pos is a jnp array (..., ndim) already
        on the evaluator's device; returns a jnp array without host sync."""
        fn = _get_compiled(self.s, self._ndim, self.device)
        self._evaluations += int(np.prod(pos.shape[:-1]))
        return fn(pos)


class SDF3(_EvaluatorBase):
    """Batched 3D SDF evaluator (replaces gleval.SDF3, gleval/gleval.go:15)."""

    _ndim = 3

    def __init__(self, s: Shader3D, device=None):
        if not isinstance(s, Shader3D):
            raise TypeError(f"expected Shader3D, got {type(s)}")
        super().__init__(s, device)


class SDF2(_EvaluatorBase):
    """Batched 2D SDF evaluator (replaces gleval.SDF2, gleval/gleval.go:28)."""

    _ndim = 2

    def __init__(self, s: Shader2D, device=None):
        if not isinstance(s, Shader2D):
            raise TypeError(f"expected Shader2D, got {type(s)}")
        super().__init__(s, device)


def new_cpu_sdf3(s: Shader3D) -> SDF3:
    """Oracle evaluator pinned to host CPU (parity tests run against this)."""
    return SDF3(s, device=jax.devices("cpu")[0])


def new_sdf3(s: Shader3D, device=None) -> SDF3:
    return SDF3(s, device)


def new_sdf2(s: Shader2D, device=None) -> SDF2:
    return SDF2(s, device)


# --- grid evaluation (the render hot path) ---------------------------

_grid_cache: dict = {}


def grid_eval_fn(tree: Shader3D, shape: tuple, device, with_k0: bool = False):
    """Compiled dense-grid evaluator: (origin, res) -> (nk,nj,ni) distances,
    where grid[k,j,i] = d(origin + (i*res, j*res, k*res)) — z is the slowest
    (outermost) axis, x the contiguous lane axis.

    Positions are synthesized on device via broadcasted iota; XLA fuses
    synthesis into the SDF arithmetic so no position array ever exists in HBM.

    with_k0=True compiles a traced global z-layer offset operand: slab
    chunking must compute iz = (iota + k0) so slab positions stay
    BIT-IDENTICAL to the whole-grid eval — shifting the origin instead
    ((origin + k*res) + i*res vs origin + (k+i)*res) drifts ~1/3 of
    coordinates by 1 ulp (the fused_render/sharded k0 discipline).

    On the CPU backend the eval routes through
    ops.mc_emit.canonical_grid_eval so the staged pipeline's grid is
    bit-exact vs the fused/welded/compact/pruned/sharded kernels (the
    staged=fused fuzz gate)."""
    key = (tree.tree_hash(), shape, device, bool(with_k0))
    fn = _grid_cache.get(key)
    if fn is None:
        nk, nj, ni = shape

        def impl(origin, res, k0=None):
            if device.platform == "cpu":
                from ..ops.mc_emit import canonical_dense_grid_eval

                return canonical_dense_grid_eval(
                    tree, origin, res, (nk, nj, ni), k0=k0
                )
            iz = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 0)
            if k0 is not None:
                iz = iz + k0
            iy = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 1)
            ix = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 2)
            p = jnp.stack(
                [
                    origin[0] + ix * res,
                    origin[1] + iy * res,
                    origin[2] + iz * res,
                ],
                axis=-1,
            )
            return tree.distance(p)

        if with_k0:
            jitted = jax.jit(impl)

            def fn(origin, res, k0, _jitted=jitted, _dev=device):
                with jax.default_device(_dev):
                    return _jitted(
                        jax.device_put(origin, _dev), res, _f32(k0)
                    )

        else:
            jitted = jax.jit(lambda origin, res: impl(origin, res))

            def fn(origin, res, _jitted=jitted, _dev=device):
                with jax.default_device(_dev):
                    return _jitted(jax.device_put(origin, _dev), res)

        _grid_cache[key] = fn
    return fn


def evaluate_grid(
    tree: Shader3D,
    origin,
    res: float,
    shape: tuple,
    device=None,
    k0=None,
):
    """Evaluate the SDF over a dense corner grid, returning a device array
    of shape (nk,nj,ni): grid[k,j,i] = d(origin + (i,j,k0+k)*res). k0 is
    the global z-layer offset for slab chunking (see grid_eval_fn)."""
    device = device if device is not None else jax.devices()[0]
    shape = tuple(int(x) for x in shape)
    origin = jnp.asarray(np.asarray(origin, _f32))
    if k0 is not None:
        fn = grid_eval_fn(tree, shape, device, with_k0=True)
        return fn(origin, _f32(res), k0)
    fn = grid_eval_fn(tree, shape, device)
    return fn(origin, _f32(res))


def normals_central_diff(
    sdf: SDF3, pos: np.ndarray, step: float, userdata=None
) -> np.ndarray:
    """Central-difference normals, NOT normalized
    (reference gleval/gleval.go:53-108)."""
    step = _f32(step) * _f32(0.5)
    if step <= 0:
        raise ValueError("invalid step")
    pos = np.ascontiguousarray(pos, dtype=_f32)
    n = pos.shape[0]
    normals = np.empty_like(pos)
    for dim in range(3):
        h = np.zeros(3, _f32)
        h[dim] = step
        d1 = sdf.evaluate(pos + h)
        d2 = sdf.evaluate(pos - h)
        normals[:, dim] = d1 - d2
    return normals


class BlockCachedSDF3:
    """Voxel-quantized memo cache wrapping any SDF3
    (reference gleval/gleval.go:110-217).

    Fully vectorized: voxel keys bit-pack into one int64, lookups are a
    single np.searchsorted over the sorted known-key array, and merges
    are one sort per batch — render-scale batches (millions of points)
    cost O(n log n) numpy, never a Python per-point loop."""

    _BIAS = 1 << 20  # 21-bit signed voxel coordinates per axis

    def __init__(self, sdf: SDF3, res_x: float, res_y: float, res_z: float):
        if res_x <= 0 or res_y <= 0 or res_z <= 0:
            raise ValueError("invalid resolution for BlockCachedSDF3")
        self.sdf = sdf
        self.mul = (1.0 / np.array([res_x, res_y, res_z], _f32)).astype(_f32)
        self._keys = np.empty(0, np.int64)  # sorted packed voxel keys
        self._vals = np.empty(0, _f32)
        self._hits = 0
        self._evals = 0

    def cache_hits(self) -> int:
        return self._hits

    def evaluations(self) -> int:
        return self._evals

    def bounds(self):
        return self.sdf.bounds()

    def _pack(self, pos: np.ndarray):
        """(packed int64 keys, valid mask). Coordinates outside the
        21-bit-per-axis key space (bounds spanning > 2^21 voxels, or
        points > 2^20 voxels below bb.min) would bleed into the
        neighboring axis fields and COLLIDE — the reference's
        map[[3]int] (gleval.go:110) cannot, so such rows bypass the
        cache entirely (always evaluate, never stored) instead of
        risking a wrong cached distance."""
        bb = self.sdf.bounds()
        k = ((pos - bb.min) * self.mul).astype(np.int64) + self._BIAS
        valid = np.all((k >= 0) & (k < (1 << 21)), axis=1)
        return k[:, 0] | (k[:, 1] << 21) | (k[:, 2] << 42), valid

    def evaluate(self, pos: np.ndarray) -> np.ndarray:
        pos = np.ascontiguousarray(pos, dtype=_f32)
        if len(pos) == 0:
            raise ValueError("empty buffers")
        packed, valid = self._pack(pos)
        dist = np.empty(len(pos), _f32)
        if len(self._keys):
            at = np.searchsorted(self._keys, packed)
            at_c = np.minimum(at, len(self._keys) - 1)
            hit = (self._keys[at_c] == packed) & valid
            dist[hit] = self._vals[at_c[hit]]
        else:
            hit = np.zeros(len(pos), bool)
        miss = ~hit
        n_miss = int(miss.sum())
        if n_miss:
            d_new = np.asarray(self.sdf.evaluate(pos[miss]), _f32)
            dist[miss] = d_new
            # store one value per voxel, last writer wins (the reference
            # loop stores in order, gleval.go:188-199); out-of-key-space
            # rows are never stored
            vm = valid[miss]
            pm = packed[miss][vm]
            dn = d_new[vm]
            if len(pm):
                rev_first = np.unique(pm[::-1], return_index=True)[1]
                uk, uv = pm[::-1][rev_first], dn[::-1][rev_first]
                keys = np.concatenate([self._keys, uk])
                vals = np.concatenate([self._vals, uv])
                order = np.argsort(keys, kind="stable")
                self._keys, self._vals = keys[order], vals[order]
        self._evals += len(pos)
        self._hits += len(pos) - n_miss
        return dist


class CachedExactSDF3:
    """Exact-position memo cache: hits only on bit-identical (x,y,z)
    float32 positions (reference cachedExactSDF3, gleval/gleval.go:220-292
    — keys are Float32bits of each coordinate). Debug/analysis tool for
    measuring how often a renderer re-evaluates the same point; unlike
    BlockCachedSDF3 a hit is always numerically exact, never quantized.

    Vectorized like BlockCachedSDF3: the three u32 bit patterns form a
    structured key (lexicographic compare), lookups are one searchsorted
    over the sorted known-key array per batch."""

    _DT = np.dtype([("x", "u4"), ("y", "u4"), ("z", "u4")])

    def __init__(self, sdf: SDF3):
        self.sdf = sdf
        self._keys = np.empty(0, self._DT)  # sorted packed bit-keys
        self._vals = np.empty(0, _f32)
        self._hits = 0
        self._evals = 0

    def cache_hits(self) -> int:
        return self._hits

    def evaluations(self) -> int:
        return self._evals

    def bounds(self):
        return self.sdf.bounds()

    def _pack(self, pos: np.ndarray) -> np.ndarray:
        bits = np.ascontiguousarray(pos, dtype=_f32).view(np.uint32)
        return bits.reshape(-1, 3).copy().view(self._DT).reshape(-1)

    def evaluate(self, pos: np.ndarray) -> np.ndarray:
        pos = np.ascontiguousarray(pos, dtype=_f32)
        if len(pos) == 0:
            raise ValueError("empty buffers")
        packed = self._pack(pos)
        dist = np.empty(len(pos), _f32)
        if len(self._keys):
            at = np.searchsorted(self._keys, packed)
            at_c = np.minimum(at, len(self._keys) - 1)
            hit = self._keys[at_c] == packed
            dist[hit] = self._vals[at_c[hit]]
        else:
            hit = np.zeros(len(pos), bool)
        miss = ~hit
        n_miss = int(miss.sum())
        if n_miss:
            pm = packed[miss]
            # the reference does a FULL lookup pass over the batch before
            # evaluating any miss (gleval.go:241-266), so in-batch
            # duplicates of a new position are ALL misses: every duplicate
            # row is re-evaluated and the last store wins
            # (gleval.go:268-287). hits += len(pos) - len(seekPos).
            d_new = np.asarray(self.sdf.evaluate(pos[miss]), _f32)
            dist[miss] = d_new
            rev_first = np.unique(pm[::-1], return_index=True)[1]
            uk, uv = pm[::-1][rev_first], d_new[::-1][rev_first]
            keys = np.concatenate([self._keys, uk])
            vals = np.concatenate([self._vals, uv])
            order = np.argsort(keys, kind="stable")
            self._keys, self._vals = keys[order], vals[order]
        self._evals += len(pos)
        self._hits += len(pos) - n_miss
        return dist
