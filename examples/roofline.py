"""Roofline analysis of the flagship dense-evaluation workload on a GPU.

Answers: what fraction of the card does the flange tree evaluation use,
and what binds it? (BASELINE.json "evals/sec/chip" north-star.)

Method: lower + compile the checksum kernel `throughput_grid` runs
(eval/special.py), read XLA's `cost_analysis()` for flops/
transcendentals/bytes, time it on the card, and compare the achieved
rates with the card's published peaks (PEAKS, keyed by
`device.device_kind`; a kind that is not in the table is an error).

Run: python examples/roofline.py   (on the default device, a GPU)
"""
import json
import statistics
import time

import numpy as np

import _common  # noqa: F401  (ensures gsdf_tpu importable)
from gsdf_tpu.flagships import build_flange

_f32 = np.float32

# Published peaks per device_kind: float32 outside the tensor cores
# (FLOP/s, an FMA counted as 2) and device-memory bandwidth (bytes/s).
# Source: NVIDIA H100 data sheet, SXM part, at the full 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(device_kind: str) -> dict:
    """The published peaks of one card; an unknown kind is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            "add the card's data-sheet rates to PEAKS"
        ) from None


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    peak = peaks(dev.device_kind)
    tree = build_flange()
    shape = (512, 512, 512)
    nk, nj, ni = shape
    n_eval = nk * nj * ni

    bb = tree.bounds().scale_centered((1.01, 1.01, 1.01))
    res = _f32(max(bb.size()) / (nk - 1))
    origin = np.asarray(bb.min, _f32)

    def impl(origin, res):
        iz = jax.lax.broadcasted_iota(jnp.float32, shape, 0)
        iy = jax.lax.broadcasted_iota(jnp.float32, shape, 1)
        ix = jax.lax.broadcasted_iota(jnp.float32, shape, 2)
        p = jnp.stack(
            [origin[0] + ix * res, origin[1] + iy * res, origin[2] + iz * res],
            axis=-1,
        )
        d = tree.distance(p)
        return jnp.sum(jnp.abs(jnp.clip(d, -1.0, 1.0)))

    print(f"lowering + compiling flange tree checksum kernel {shape} ...")
    compiled = jax.jit(impl).lower(jnp.asarray(origin), res).compile()
    ca = compiled.cost_analysis()
    flops = float(ca.get("flops", 0.0))
    transcendentals = float(ca.get("transcendentals", 0.0))
    bytes_accessed = float(ca.get("bytes accessed", 0.0))

    with jax.default_device(dev):
        args = (jax.device_put(jnp.asarray(origin), dev), res)
        compiled(*args).block_until_ready()  # warm
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            compiled(*args).block_until_ready()
            times.append(time.perf_counter() - t0)
    med = statistics.median(times)

    achieved_flops = flops / med
    # fused kernel's true device-memory traffic ~= one f32 per eval
    # written + read once by the reduce (cost_analysis "bytes accessed"
    # counts every logical buffer touch before fusion and overstates it)
    hbm_traffic = 2 * 4.0 * n_eval

    out = {
        "device_kind": dev.device_kind,
        "shape": list(shape),
        "evals": n_eval,
        "median_wall_ms": med * 1e3,
        "geval_per_s": n_eval / med / 1e9,
        "xla_flops_per_eval": flops / n_eval,
        "xla_transcendentals_per_eval": transcendentals / n_eval,
        "achieved_f32_tflops": achieved_flops / 1e12,
        "f32_peak_share": achieved_flops / peak["f32_flops"],
        "hbm_gb_per_s": hbm_traffic / med / 1e9,
        "hbm_peak_share": hbm_traffic / med / peak["hbm_bytes"],
        "xla_bytes_accessed_logical_gb": bytes_accessed / 1e9,
    }
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
