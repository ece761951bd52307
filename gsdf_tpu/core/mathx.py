"""float32 math helpers shared by all SDF node implementations.

These mirror the scalar helper semantics of the reference kernel
(reference gsdf.go:141-189) so that distances agree to 1e-6 abs:

- sign(0) == 0 (reference signf, gsdf.go:148)
- clamp/mix exactly as GLSL
- cos_acos_3 polynomial approximation of cos(acos(x)/3) (gsdf.go:186)

All functions operate on jnp float32 arrays and are safe under jit.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

# Constants matching reference gsdf.go:16-25.
TRIBISECT = 0.8660254037844386467637231707529361834714026269051903140279
SQRT3 = 1.7320508075688772935274463415058723669428052538103806280558
SQRT2D2 = 0.7071067811865476
LARGENUM = 1e20
EPSTOL = 6e-7


def f32(x):
    return jnp.asarray(x, dtype=jnp.float32)


def clamp(v, lo, hi):
    return jnp.clip(v, lo, hi)


def mix(x, y, a):
    """GLSL mix: x*(1-a) + y*a (reference mixf, gsdf.go:165)."""
    return x * (1 - a) + y * a


def sign(x):
    """sign with sign(0)=0, matching reference signf (gsdf.go:148)."""
    return jnp.sign(x)


def length(v, axis=-1):
    """Euclidean norm along `axis`."""
    return jnp.sqrt(jnp.sum(v * v, axis=axis))


def length_sq(v, axis=-1):
    return jnp.sum(v * v, axis=axis)


def hypot(x, y):
    return jnp.sqrt(x * x + y * y)


def dot(a, b, axis=-1):
    return jnp.sum(a * b, axis=axis)


def ndot(a, b):
    """negative dot: ax*bx - ay*by (reference gsdf.go:178)."""
    return a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]


def cross2(a, b):
    """2D cross product z-component."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def cos_acos_3(x):
    """Polynomial approximation of cos(acos(x)/3) (reference gsdf.go:186-189)."""
    x = jnp.sqrt(0.5 + 0.5 * x)
    return x * (x * (x * (x * -0.008972 + 0.039071) - 0.107074) + 0.576975) + 0.5


def atan2(y, x):
    """jnp.arctan2 (the one spelling every node uses)."""
    return jnp.arctan2(y, x)


def acos(x):
    """jnp.arccos (the one spelling every node uses)."""
    return jnp.arccos(x)


def scan_fold(body, init, xs, unroll: int = 1):
    """lax.scan over the leading axis of xs, carry-only (no per-step ys).

    BIT-EXACTNESS CONTRACT: the default is unroll=1 because unrolling
    lets XLA re-associate FMA contraction across steps — observed as
    1-ulp drift on the scan-grouped OpUnion, which must stay bit-exact
    to sequential folding (pinned in test_ops.py). Callers may opt into
    unrolling ONLY where a test pins the result against the unrolled
    fold itself (or a float64 oracle with tolerance).

    Why opt in: each scan step round-trips the carry (and the point
    batch it closes over) through device memory — on a flange-polygon
    fold that is ~16 B/point/step of carry traffic, and unrolling keeps
    it in registers across steps (the Polygon2D edge fold passes
    unroll=8; the gain on the GPU is not measured)."""
    return jax.lax.scan(
        body, init, xs, unroll=max(1, min(int(unroll), int(xs.shape[0])))
    )
