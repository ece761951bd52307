"""Dual-contouring benchmark: the bolt example scene on the GPU.

Warm median SDF -> triangle-mesh wall times for the fully-on-device QEF
pipeline (default and chiseled modes) and payload/fetch sizes, plus the
float64 host-QEF oracle for reference. Run with the card idle;
end-to-end wall times only (dispatch is asynchronous).

`--cpu` runs the same battery on the host CPU backend (the oracle
device); `--resdiv` changes the grid (golden counts only hold at 256).
`--mesh N` instead drives the MULTI-CHIP path on an N-virtual-CPU-device
mesh (parallel/sharded_dc.py): times the sharded render and verifies it
is bit-identical to the single-device result.
"""
import statistics
import time

from _common import example_args  # noqa: F401  (ensures gsdf_tpu importable)


def med_ms(fn, repeats=7):
    fn()
    ts = []
    for _ in range(repeats):
        t0 = time.monotonic()
        fn()
        ts.append(time.monotonic() - t0)
    return statistics.median(ts) * 1e3, ts


def main():
    args = example_args(
        resdiv_default=256,
        mesh=(0, "run the sharded DC path on N virtual CPU devices"),
    )
    if args.mesh:
        # virtual devices must be requested before the backend initializes
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        flags = " ".join(
            f
            for f in flags.split()
            if "host_platform_device_count" not in f
        )
        os.environ["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={args.mesh}"
        ).strip()

    import jax

    if args.mesh:
        jax.config.update("jax_platforms", "cpu")

    from bolt import scene  # the golden bolt scene (examples/bolt.py)

    from gsdf_tpu import Builder
    from gsdf_tpu.render.dual_contour import (
        DualContourLeastSquares,
        DualContourRenderer,
    )

    args_device_cpu = args.cpu or args.mesh
    device = jax.devices("cpu")[0] if args_device_cpu else jax.devices()[0]
    m3 = scene(Builder())
    res = args.res or m3.bounds().diagonal() / args.resdiv
    print(f"device: {device}, bolt scene resdiv {args.resdiv} (res {res:.5f})")

    if args.mesh:
        import numpy as np

        from gsdf_tpu.parallel import make_mesh, render_dc_sharded

        devices = jax.devices("cpu")[: args.mesh]
        assert len(devices) == args.mesh, (
            f"need {args.mesh} CPU devices, have {len(devices)}"
        )
        mesh = make_mesh(devices)
        t_single = DualContourRenderer(m3, res, device=devices[0]).render()
        tris = render_dc_sharded(m3, mesh, res)  # compile + warm hints
        assert np.array_equal(tris, t_single), "sharded DC != single device"
        ms, ts = med_ms(lambda: render_dc_sharded(m3, mesh, res))
        ms1, _ = med_ms(
            lambda d=DualContourRenderer(m3, res, device=devices[0]): d.render()
        )
        print(
            f"sharded DC, {args.mesh}-device CPU mesh: {ms:7.1f} ms median "
            f"of 7 (min {min(ts)*1e3:.1f}), {len(tris):,} triangles, "
            f"BIT-IDENTICAL to single device ({ms1:.1f} ms single-CPU)"
        )
        print(
            "note: virtual CPU devices share this host's cores — this "
            "mode proves correctness and shard overheads, not scaling; "
            "on a real mesh each shard runs on its own chip"
        )
        return

    for label, kw in (
        ("device QEF", {}),
        ("device QEF chiseled", {"contourer": DualContourLeastSquares(chiseled=True)}),
        ("host f64 QEF oracle", {"host_qef": True}),
    ):
        dc = DualContourRenderer(m3, res, device=device, **kw)
        tris = dc.render()  # compile + warm hints
        ms, ts = med_ms(lambda d=dc: d.render())
        print(
            f"{label:>22}: {ms:7.1f} ms median of 7 "
            f"(min {min(ts)*1e3:.1f} / max {max(ts)*1e3:.1f}), "
            f"{len(tris):,} triangles, {dc.evaluations():,} cumulative evals"
        )


if __name__ == "__main__":
    main()
