"""CPU checks of what the GPU bring-up relies on: the compile-cache
location, chip_smoke's phases at tiny sizes and its refusal of a CPU
backend, the benchmark's refusal of a CPU backend, the roofline peak
table, the float64 provenance of the flagship goldens and the CPU's one
known departure from them, matrix-product-free flagship trees, the
atomic-free QEF row sum and the atan2 seam."""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples"))

import chip_smoke  # noqa: E402


def _cache_dir_in_child(env_extra):
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_COMPILATION_CACHE_DIR", "GSDF_TPU_NO_COMPILE_CACHE")
    }
    env.update(env_extra, JAX_PLATFORMS="cpu")
    code = (
        "import jax, gsdf_tpu; "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, check=True, timeout=120,
    )
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env(tmp_path):
    """Where JAX_COMPILATION_CACHE_DIR is set, the package sets no other
    cache directory."""
    assert _cache_dir_in_child({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


def test_compile_cache_default_in_checkout():
    """Without the variable the cache sits at a fixed path inside the
    checkout, listed in .gitignore."""
    from gsdf_tpu.utils.config import DEFAULT_CACHE_DIR

    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert _cache_dir_in_child({}) == DEFAULT_CACHE_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_refuses_cpu_backend():
    with pytest.raises(RuntimeError, match="not a GPU"):
        chip_smoke.require_gpu(jax.devices("cpu"))


def test_chip_smoke_goldens_phase_cpu():
    """The golden phase through both MC entry points and DC, at tiny
    resolutions whose counts the soup path gives."""
    from gsdf_tpu.flagships import build_bolt, build_flange
    from gsdf_tpu.render.dual_contour import DualContourRenderer
    from gsdf_tpu.render.flat import FlatRenderer

    cpu = jax.devices("cpu")[0]
    flange, bolt = build_flange(), build_bolt()
    n_flange = len(FlatRenderer(flange, flange.bounds().diagonal() / 40).render())
    n_bolt = len(DualContourRenderer(bolt, bolt.bounds().diagonal() / 32).render())
    chip_smoke.phase_goldens(cpu, "cpu", cases=[
        ("flange", "build_flange", 40, "stl", n_flange),
        ("flange", "build_flange", 40, "compact", n_flange),
        ("bolt", "build_bolt", 32, "dc", n_bolt),
    ])
    with pytest.raises(AssertionError):
        chip_smoke.phase_goldens(cpu, "cpu", cases=[
            ("flange", "build_flange", 40, "compact", n_flange + 1),
        ])


def test_chip_smoke_paths_phase_cpu():
    chip_smoke.phase_paths(jax.devices("cpu")[0], resdiv=40, frame=(32, 24))


def test_chip_smoke_reference_phase_cpu():
    chip_smoke.phase_reference(jax.devices("cpu")[0], n_points=3000, chunk=1024)


def test_chip_smoke_memory_phase_cpu():
    chip_smoke.phase_memory(jax.devices("cpu")[0], resdiv=40)


def test_chip_smoke_four_phase_cpu():
    chip_smoke.phase_four(jax.devices("cpu")[:4], mc_resdiv=40, dc_resdiv=32)


@pytest.mark.parametrize("entry", ["bench_main", "breadth_main"])
def test_bench_refuses_cpu_backend(entry):
    from gsdf_tpu import cli

    with pytest.raises(SystemExit) as exc:
        getattr(cli, entry)()
    assert exc.value.code not in (0, None)


def test_render_asked_for_gpu_never_runs_on_cpu():
    """use_gpu=True names the first GPU and raises where there is none;
    None takes JAX's default device, False the CPU."""
    import io

    from gsdf_tpu import Builder
    from gsdf_tpu.pipeline import RenderConfig, render_shader3d
    from gsdf_tpu.pipeline.render import render_device

    cpu = jax.devices("cpu")[0]
    assert render_device(False) == cpu and render_device(None) == jax.devices()[0]
    s = Builder().new_sphere(0.5)
    with pytest.raises(RuntimeError):
        render_shader3d(s, RenderConfig(stl_output=io.BytesIO(), resolution=0.1,
                                        use_gpu=True, silent=True))


def test_roofline_peaks_by_device_kind():
    import roofline

    assert roofline.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes"] == 3.35e12
    with pytest.raises(ValueError, match="no published peaks"):
        roofline.peaks("cpu")


def _primitives(closed):
    seen = set()

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            seen.add(eqn.primitive.name)
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(closed.jaxpr)
    return seen


@pytest.mark.parametrize(
    "builder", ["build_flange", "build_showerhead", "build_bolt", "build_knurled"]
)
def test_flagship_tree_has_no_matrix_product(builder):
    """A float32 dot may run in reduced precision on an accelerator (TF32
    on the GPU) and move a corner's sign; the flagship trees evaluate
    with elementwise mul-adds only."""
    from gsdf_tpu import flagships

    tree = getattr(flagships, builder)()
    closed = jax.make_jaxpr(tree.distance)(
        jax.ShapeDtypeStruct((64, 3), jnp.float32)
    )
    assert "dot_general" not in _primitives(closed)


def test_dc_bolt_emit_has_no_matrix_product():
    """The whole DC emit of the bolt (normals + QEF solve) is dot-free."""
    from gsdf_tpu.flagships import build_bolt
    from gsdf_tpu.render.dual_contour import dc_mesh_emit

    bolt = build_bolt()
    origin = jnp.zeros(3, jnp.float32)

    def emit(grid):
        return dc_mesh_emit(
            bolt, grid, origin, jnp.float32(0.1), 1024, 512, 64,
            0.05, 10.0, 1e-3,
        )

    closed = jax.make_jaxpr(emit)(jax.ShapeDtypeStruct((9, 9, 9), jnp.float32))
    assert "dot_general" not in _primitives(closed)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_segment_sum_matches_segment_sum(seed):
    """The atomic-free QEF row sum is bit-identical to the scatter-add it
    replaces on the GPU, with empty segments and dropped rows."""
    from gsdf_tpu.render.dual_contour import sorted_segment_sum

    rng = np.random.default_rng(seed)
    w = 64
    counts = rng.integers(0, 16, w)
    seg = np.repeat(np.arange(w), counts)
    seg = np.concatenate([seg, np.full(rng.integers(1, 9), w)]).astype(np.int32)
    scale = 10.0 ** rng.integers(-3, 4, (len(seg), 1))
    data = (rng.normal(size=(len(seg), 13)) * scale).astype(np.float32)
    ref = jax.jit(
        lambda d, s: jax.ops.segment_sum(
            d, s, num_segments=w, indices_are_sorted=True
        )
    )(data, seg)
    got = jax.jit(lambda d, s: sorted_segment_sum(d, s, w, 15))(data, seg)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_atan2_signed_zero_seam():
    """mathx.atan2 agrees with numpy on the y=0 half-plane seam, signed
    zeros included: a sign flip there shifts angle-dependent SDFs
    (CircularArray, Screw) by 2*pi."""
    from gsdf_tpu.core.mathx import atan2

    zs = np.float32([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 3.0, -3.0])
    y, x = np.meshgrid(zs, zs)
    y, x = y.ravel(), x.ravel()
    got = np.asarray(atan2(jnp.asarray(y), jnp.asarray(x)))
    ref = np.arctan2(y, x)
    np.testing.assert_allclose(got, ref, atol=2e-7)
    seam = (y == 0) | (x == 0)
    np.testing.assert_array_equal(np.signbit(got[seam]), np.signbit(ref[seam]))


def _float64_mc_count(builder, resdiv):
    """Triangle count of the flat renderer's corner grid evaluated in
    float64 at the f32 pipeline's own corner positions (f32 multiply,
    then add): counts that no f32 rounding near the surface can move."""
    from gsdf_tpu import flagships
    from gsdf_tpu.ops.mc_emit import CUBE_DIAG_FACTOR
    from gsdf_tpu.ops.mc_tables import MC_TRI_COUNT
    from gsdf_tpu.render.flat import FlatRenderer

    tree = getattr(flagships, builder)()
    fr = FlatRenderer(tree, tree.bounds().diagonal() / resdiv)
    nk, nj, ni = fr.nz + 1, fr.ny + 1, fr.nx + 1
    o = np.asarray(fr.origin, np.float32)
    r = np.float32(fr.res)
    jj, ii = np.meshgrid(np.arange(nj), np.arange(ni), indexing="ij")
    x = o[0] + ii.astype(np.float32) * r
    y = o[1] + jj.astype(np.float32) * r
    g = np.empty((nk, nj, ni), np.float64)
    with jax.enable_x64(True):
        f = jax.jit(tree.distance)
        for k in range(nk):
            z = np.full_like(x, o[2] + np.float32(k) * r)
            p = np.stack([x, y, z], -1).astype(np.float64).reshape(-1, 3)
            g[k] = np.asarray(f(p)).reshape(nj, ni)
    c = [g[:-1, :-1, :-1], g[:-1, :-1, 1:], g[:-1, 1:, 1:], g[:-1, 1:, :-1],
         g[1:, :-1, :-1], g[1:, :-1, 1:], g[1:, 1:, 1:], g[1:, 1:, :-1]]
    case = np.zeros(c[0].shape, np.int32)
    for bit, v in enumerate(c):
        case |= (v < 0).astype(np.int32) << bit
    active = (np.abs(c[0]) <= CUBE_DIAG_FACTOR * r) & (case != 0) & (case != 255)
    return int(MC_TRI_COUNT[case[active]].sum())


@pytest.mark.parametrize("builder,resdiv,golden", [
    ("build_flange", 400, "GOLDEN_FLANGE_TRIS"),
    ("build_showerhead", 350, "GOLDEN_SHOWERHEAD_TRIS"),
    ("build_bolt", 300, "GOLDEN_BOLT_TRIS"),
    ("build_knurled", 350, "GOLDEN_KNURLED_TRIS"),
])
def test_flagship_golden_is_float64_count(builder, resdiv, golden):
    from gsdf_tpu import flagships

    assert _float64_mc_count(builder, resdiv) == getattr(flagships, golden)


def test_cpu_f32_bolt_count():
    """The CPU's own f32 render of the bolt at resdiv 300 is one corner
    off the float64 golden (flagships.CPU_F32_BOLT_TRIS)."""
    from gsdf_tpu import flagships
    from gsdf_tpu.render.flat import FlatRenderer

    bolt = flagships.build_bolt()
    fr = FlatRenderer(bolt, bolt.bounds().diagonal() / 300, device=jax.devices("cpu")[0])
    assert len(fr.render_compact()[1]) == flagships.CPU_F32_BOLT_TRIS
    assert flagships.CPU_F32_BOLT_TRIS != flagships.GOLDEN_BOLT_TRIS


def test_sign_diagnosis_bolt_corner_cpu():
    """The corner behind CPU_F32_BOLT_TRIS (the one corner whose sign the
    GPU and the CPU render differently): inside in float64 and when the
    CPU runs the tree one equation at a time; outside only in the CPU's
    fused grid executable."""
    import sign_diagnosis as sd
    from gsdf_tpu.flagships import build_bolt

    bolt = build_bolt()
    cpu = jax.devices("cpu")[0]
    origin, res, grid = sd.corner_grid(bolt, 300, cpu)
    pts = sd.corner_positions(origin, res, np.array([[71, 100, 71]]))
    eager, trace = sd.eqn_by_eqn(bolt, pts, cpu)
    assert grid[71, 100, 71] > 0
    assert sd.eval_float64(bolt, pts)[0] < 0 and eager[0] < 0
    assert {e.primitive.name for e, _ in trace} >= {"atan2", "div", "mul"}


def test_sign_diagnosis_runs_cpu(capsys):
    import sign_diagnosis as sd

    sd.main(["--cpu", "--parts", "bolt,knurled", "--resdiv", "40"])
    out = capsys.readouterr().out
    assert out.count(": 0 sign flips") == 2, out
