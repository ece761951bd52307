"""Microbenchmark: stream-compaction strategies on the GPU.

Compares mc_emit.compact_indices methods (searchsorted / sort / scatter)
at production grid sizes, plus the end-to-end effect on the flange
compact render. Run with the card idle; checksum-forced timings.
"""
import statistics
import time

import numpy as np

import _common  # noqa: F401  (ensures gsdf_tpu importable)


def med_ms(fn, repeats=7):
    fn()
    ts = []
    for _ in range(repeats):
        t0 = time.monotonic()
        fn()
        ts.append(time.monotonic() - t0)
    return statistics.median(ts) * 1e3


def main():
    import jax
    import jax.numpy as jnp

    from gsdf_tpu.ops import mc_emit

    dev = jax.devices()[0]
    for n in (6_700_000, 53_000_000):
        # realistic mask: a surface shell (MC active masks are coherent
        # runs along x, NOT random points — block compaction exploits it)
        side = round(n ** (1 / 3))
        ax = np.arange(side, dtype=np.float32) - side / 2
        r2 = (
            ax[:, None, None] ** 2 + ax[None, :, None] ** 2 + ax[None, None, :] ** 2
        )
        mask = np.abs(np.sqrt(r2) - side * 0.38) < 0.9
        mask = mask.reshape(-1)
        mask = mask[: mask.size - mask.size % 8]
        n = mask.size
        size = mc_emit.bucket(int(mask.sum()))
        mask_d = jax.device_put(jnp.asarray(mask), dev)
        print(
            f"surface mask: n={n:,} active={int(mask.sum()):,} "
            f"active blocks(8)={int(mask.reshape(-1, 8).any(1).sum()):,}"
        )
        for method in ("sort", "sort-flat", "searchsorted", "scatter"):
            f = jax.jit(
                lambda m, _meth=method: mc_emit.compact_indices(m, size, _meth)[
                    -1
                ]
            )
            ms = med_ms(lambda: int(f(mask_d)))
            print(f"n={n:>11,} size={size:>8,} {method:>13}: {ms:7.2f} ms")

    from gsdf_tpu.flagships import build_flange
    from gsdf_tpu.render.flat import FlatRenderer

    tree = build_flange()
    res = tree.bounds().diagonal() / 400
    ms = med_ms(lambda: FlatRenderer(tree, res).render_compact(), repeats=7)
    print(f"flange resdiv400 render_compact end-to-end: {ms:.1f} ms")


if __name__ == "__main__":
    main()
