"""Mixed-precision (bf16) grid-classification probe — measurement for
an eval lever that has not been priced on the GPU.

Hypothesis under test: evaluate the corner grid in bfloat16 (coarse
pass), then re-evaluate only the near-surface band in float32, for a
net eval-time win at the golden-exact acceptance bar.

The probe measures the PREREQUISITE: is a bf16 SDF eval actually faster
than f32 on the card for this workload? The production grid eval is
fused from on-device iota synthesis — it reads NOTHING from device
memory and writes one f32 (or bf16) grid, so the usual bf16 win (halved
memory traffic) applies only to the write-back; whether bf16 arithmetic
outside the tensor cores runs faster than f32 is what the probe shows.
Transcendentals (7/eval on the flange chain) run in f32 either way.

Method: the flagship-representative eval chain (sphere + rounded box +
smooth union + cylinder difference — the same op mix the roofline
harness uses) over a 512^3 iota-synthesized grid, reduced to a scalar
checksum ON DEVICE so the fetched payload is 4 bytes and the timing is
pure device compute (block_until_ready, medians of 7 after 2 warmups).
Variants:
  f32:        positions f32, math f32, f32 checksum (the baseline)
  bf16-store: math f32, grid cast to bf16 before the reduction
              (isolates the write-back/reduction-side win)
  bf16-math:  positions and every constant cast to bf16 so the WHOLE
              chain computes in bf16 (upper bound for a bf16 coarse
              pass; correctness irrelevant here - timing only)

Run on the card: `python examples/bf16_probe.py` (add `--cpu` to smoke
it on the host). No GPU result is recorded yet.
"""
import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp


def _chain(p, dt):
    """Flagship-representative SDF chain in dtype dt (sphere + rounded
    box + smooth-union + cylinder difference; 2 sqrt + 1 log-free mix,
    same select/min/max mix as the roofline harness)."""
    c = lambda v: jnp.asarray(v, dt)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d_sph = jnp.sqrt(x * x + y * y + z * z) - c(0.8)
    qx = jnp.abs(x) - c(0.6)
    qy = jnp.abs(y) - c(0.6)
    qz = jnp.abs(z) - c(0.25)
    mx = jnp.maximum(qx, 0.0)
    my = jnp.maximum(qy, 0.0)
    mz = jnp.maximum(qz, 0.0)
    outside = jnp.sqrt(mx * mx + my * my + mz * mz)
    inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
    d_box = outside + inside - c(0.05)
    k = c(0.1)
    h = jnp.clip(c(0.5) + c(0.5) * (d_box - d_sph) / k, 0.0, 1.0)
    d_su = d_box * (c(1.0) - h) + d_sph * h - k * h * (c(1.0) - h)
    d_cyl = jnp.sqrt(x * x + y * y) - c(0.3)
    return jnp.maximum(d_su, -d_cyl)


def _grid_kernel(n, dt, math_dt):
    def impl(origin, res):
        iz = jax.lax.broadcasted_iota(jnp.float32, (n, n, n), 0)
        iy = jax.lax.broadcasted_iota(jnp.float32, (n, n, n), 1)
        ix = jax.lax.broadcasted_iota(jnp.float32, (n, n, n), 2)
        p = jnp.stack(
            [origin[0] + ix * res, origin[1] + iy * res, origin[2] + iz * res],
            axis=-1,
        ).astype(math_dt)
        d = _chain(p, math_dt).astype(dt)
        # checksum in f32 so the fetch is 4 bytes for every variant
        return jnp.sum(d.astype(jnp.float32))

    return jax.jit(impl)


def _median_ms(fn, *args, repeats=7):
    # checksum-forced: FETCH the scalar every run, so each timing ends
    # after the device finished
    for _ in range(2):
        float(np.asarray(fn(*args)))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(np.asarray(fn(*args)))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("-n", type=int, default=512)
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        if args.n == 512:
            args.n = 128
    dev = jax.devices()[0]
    n = args.n
    origin = jax.device_put(np.array([-1.1, -1.1, -1.1], np.float32), dev)
    res = np.float32(2.2 / (n - 1))
    evals = n**3 / 1e9

    with jax.default_device(dev):
        t_f32 = _median_ms(_grid_kernel(n, jnp.float32, jnp.float32), origin, res)
        t_bf16_store = _median_ms(
            _grid_kernel(n, jnp.bfloat16, jnp.float32), origin, res
        )
        t_bf16_math = _median_ms(
            _grid_kernel(n, jnp.bfloat16, jnp.bfloat16), origin, res
        )
    print(f"device={dev.platform} grid={n}^3 ({n**3/1e6:.0f}M evals)")
    print(f"f32 math, f32 grid:    {t_f32:8.2f} ms  {evals/t_f32*1e3:6.2f} Geval/s")
    print(f"f32 math, bf16 grid:   {t_bf16_store:8.2f} ms  {evals/t_bf16_store*1e3:6.2f} Geval/s")
    print(f"bf16 math, bf16 grid:  {t_bf16_math:8.2f} ms  {evals/t_bf16_math*1e3:6.2f} Geval/s")
    print(
        "bf16-math speedup vs f32: "
        f"{t_f32 / t_bf16_math:.2f}x (coarse-pass upper bound; a "
        "mixed-precision pipeline also pays the f32 re-eval of the "
        "near-surface band + the splice)"
    )


if __name__ == "__main__":
    main()
