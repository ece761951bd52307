"""Specialized whole-kernel 2D evaluators (reference gleval/gpu.go:169-446:
PolygonGPU, Lines2DGPU, DisplaceMulti2D).

In the reference these hand-written compute shaders bypass tree codegen to
benchmark raw GPU throughput. Under XLA every node already compiles to a fused
kernel, so these are thin constructors over the corresponding nodes —
retained for API parity and as microbenchmark entry points.
"""
from __future__ import annotations

import numpy as np

from ..core.primitives2 import Lines2D, Polygon2D
from ..core.ops2 import TranslateMulti2D
from .evaluator import SDF2, new_sdf2

_f32 = np.float32


def polygon_gpu(vertices, device=None) -> SDF2:
    """Winding-number polygon evaluator (reference PolygonGPU, gpu.go:169)."""
    return new_sdf2(Polygon2D(np.asarray(vertices, _f32)), device)


def lines2d_gpu(segments, width, device=None) -> SDF2:
    """Batched thick-segment evaluator (reference Lines2DGPU, gpu.go:256)."""
    return new_sdf2(Lines2D(np.asarray(segments, _f32), width), device)


def displace_multi2d(shape2d, displacements, device=None) -> SDF2:
    """Multi-displacement min-union evaluator
    (reference DisplaceMulti2D, gpu.go:355)."""
    return new_sdf2(TranslateMulti2D(shape2d, displacements), device)


def throughput(sdf, n_points: int = 1 << 20, repeats: int = 5, seed: int = 1):
    """Measure raw evaluation throughput of an SDF2/SDF3 — the reference's
    reason for having these special evaluators (it benchmarks PolygonGPU
    et al. in examples/test/glsdf3test.go:55-66).

    Returns (evals_per_second, median_ms). End-to-end wall time including
    the result fetch: dispatch is asynchronous, so the fetch IS the
    completion barrier."""
    import statistics
    import time

    import numpy as np

    rng = np.random.default_rng(seed)
    ndim = 2 if hasattr(sdf, "evaluate2") or _is_2d(sdf) else 3
    bb = sdf.bounds()
    lo = np.asarray(bb.min, _f32)
    hi = np.asarray(bb.max, _f32)
    pts = rng.uniform(0.0, 1.0, (n_points, ndim)).astype(_f32)
    pts = lo + pts * (hi - lo)
    sdf.evaluate(pts)  # warm-up / compile
    times = []
    for _ in range(repeats):
        t0 = time.monotonic()
        d = np.asarray(sdf.evaluate(pts))
        times.append(time.monotonic() - t0)
        assert np.isfinite(d).all()
    med = statistics.median(times)
    return n_points / med, med * 1e3


def _is_2d(sdf) -> bool:
    bb = sdf.bounds()
    return len(np.asarray(bb.min).reshape(-1)) == 2


_chk_cache: dict = {}


def throughput_grid(tree, shape=(256, 256, 256), repeats: int = 5, device=None):
    """On-device evaluation throughput: positions synthesized from iota,
    ONE scalar checksum fetched — measures the device, not the host link
    (`throughput` measures the end-to-end path). Returns
    (evals_per_second, median_ms)."""
    import statistics
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    device = device if device is not None else jax.devices()[0]
    nk, nj, ni = (int(x) for x in shape)
    bb = tree.bounds().scale_centered((1.01, 1.01, 1.01))
    res = _f32(max(bb.size()) / max(nk - 1, 1))
    key = ("chk", tree.tree_hash(), shape, device)
    fn = _chk_cache.get(key)
    if fn is None:

        def impl(origin, res):
            iz = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 0)
            iy = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 1)
            ix = jax.lax.broadcasted_iota(jnp.float32, (nk, nj, ni), 2)
            p = jnp.stack(
                [origin[0] + ix * res, origin[1] + iy * res, origin[2] + iz * res],
                axis=-1,
            )
            d = tree.distance(p)
            return jnp.sum(jnp.abs(jnp.clip(d, -1.0, 1.0)))

        jitted = jax.jit(impl)

        def fn(origin, res, _j=jitted, _dev=device):
            with jax.default_device(_dev):
                return _j(jax.device_put(origin, _dev), res)

        _chk_cache[key] = fn
    origin = np.asarray(bb.min, _f32)
    float(fn(origin, res))  # warm-up: scalar fetch barrier
    times = []
    for _ in range(repeats):
        t0 = time.monotonic()
        float(fn(origin, res))
        times.append(time.monotonic() - t0)
    med = statistics.median(times)
    return nk * nj * ni / med, med * 1e3


def run_benchmarks(n_points: int = 1 << 20, device=None, log=print):
    """The reference's special-evaluator benchmark battery
    (glsdf3test.go:55-66), JAX edition: raw-dispatch throughput of the
    hand-rolled kernels vs a deep CSG tree through the SAME jit pipeline
    — demonstrating that tree composition costs nothing extra (the
    fused-kernel claim). Returns {name: evals_per_second}."""
    import numpy as np

    from ..core import Builder

    bld = Builder()
    rng = np.random.default_rng(7)
    poly = rng.uniform(-1, 1, (64, 2)).astype(_f32)
    segs = rng.uniform(-1, 1, (128, 2, 2)).astype(_f32)
    disp = rng.uniform(-1, 1, (128, 2)).astype(_f32)

    cases = {
        "polygon_gpu(64v)": polygon_gpu(poly, device),
        "lines2d_gpu(128s)": lines2d_gpu(segs, 0.05, device),
        "displace_multi2d(128d)": displace_multi2d(
            bld.new_circle(0.1), disp, device
        ),
    }
    from .evaluator import new_sdf3

    deep = bld.difference(
        bld.smooth_union(0.2, bld.new_sphere(0.8), bld.new_box(1, 1, 1, 0.05)),
        bld.new_cylinder(0.3, 3.0, 0.0),
    )
    cases["deep_tree_3d"] = new_sdf3(deep, device)

    out = {}
    for name, sdf in cases.items():
        eps, ms = throughput(sdf, n_points)
        out[name] = eps
        log(
            f"[{ms:8.2f}ms] {name}: {eps/1e9:.3f} Geval/s end-to-end "
            f"({n_points} host pts incl. link transfer)"
        )
    # chip-only numbers: on-device position synthesis, scalar fetch
    eps, ms = throughput_grid(deep, (256, 256, 256), device=device)
    out["deep_tree_3d_grid_on_device"] = eps
    log(
        f"[{ms:8.2f}ms] deep_tree_3d 256^3 on-device: {eps/1e9:.2f} Geval/s "
        "(chip throughput, checksum fetch)"
    )
    return out
