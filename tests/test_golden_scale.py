"""Scale golden gates: multi-million-triangle renders, regression-pinned
(reference golden-count discipline, glrender/glrender_test.go:83-102,
applied at scale).

The counts were rendered on the CPU backend and hold on the GPU too
(chip_smoke.py, PERF.md). That is not a law: an f32 count depends on how
each backend rounds the few corners that lie within ~1e-7 of the surface.
The bolt at resdiv 300 is the one known case where the CPU's f32 render
(137,528) departs from the float64 count that is the golden (137,536;
gsdf_tpu/flagships.py, tests/test_bringup.py). The rotation in
Transform.distance is written as elementwise f32 mul-adds, so no
reduced-precision matrix product can move a corner's sign.

CPU variants run where the oracle render stays under ~2 minutes; the
full set (including flange resdiv-1000) is `gpu`-marked and runs on a
card under `GSDF_TEST_GPU=1 python -m pytest tests -m gpu -p no:xdist`.
"""
import numpy as np
import pytest

import jax

from gsdf_tpu.flagships import GOLDEN_FLANGE_1000_TRIS, build_bolt, build_flange
from gsdf_tpu.render.dual_contour import DualContourRenderer
from gsdf_tpu.render.flat import FlatRenderer

GOLDEN_FLANGE_800 = 1_704_568
GOLDEN_DC_BOLT_384 = 226_340
GOLDEN_DC_BOLT_512 = 403_104  # >12M voxels: exercises the auto-chunk route


@pytest.mark.slow
def test_flange_800_cpu():
    """1.7M-triangle flange on the CPU oracle (~90 s): the first scale
    point past the flagship golden."""
    obj = build_flange()
    res = obj.bounds().diagonal() / 800
    _, tri = FlatRenderer(obj, res, device=jax.devices("cpu")[0]).render_compact()
    assert len(tri) == GOLDEN_FLANGE_800


@pytest.mark.slow
def test_dc_bolt_512_chunked_cpu():
    """DC at 23.7M voxels on the CPU oracle (~50 s): auto-routes through
    the slab-chunk composition (DualContourRenderer mono_voxels wall) —
    pins both the count and that the chunk route stays engaged."""
    bolt = build_bolt()
    res = bolt.bounds().diagonal() / 512
    dc = DualContourRenderer(bolt, res, device=jax.devices("cpu")[0])
    assert (dc.nx + 2) * (dc.ny + 2) * (dc.nz + 2) > dc.mono_voxels
    tris = dc.render()
    assert len(tris) == GOLDEN_DC_BOLT_512


@pytest.mark.slow
@pytest.mark.gpu
def test_flange_800_accel(gpu_device):
    obj = build_flange()
    res = obj.bounds().diagonal() / 800
    _, tri = FlatRenderer(obj, res, device=gpu_device).render_compact()
    assert len(tri) == GOLDEN_FLANGE_800


@pytest.mark.slow
@pytest.mark.gpu
def test_flange_1000_accel(gpu_device):
    """2.66M triangles (105M corners) — CPU-prohibitive (~4 min), so the
    full-res gate runs on the card; the count is the CPU render's."""
    obj = build_flange()
    res = obj.bounds().diagonal() / 1000
    _, tri = FlatRenderer(obj, res, device=gpu_device).render_compact()
    assert len(tri) == GOLDEN_FLANGE_1000_TRIS


@pytest.mark.slow
@pytest.mark.gpu
def test_dc_bolt_384_accel(gpu_device):
    bolt = build_bolt()
    res = bolt.bounds().diagonal() / 384
    tris = DualContourRenderer(bolt, res, device=gpu_device).render()
    assert len(tris) == GOLDEN_DC_BOLT_384


@pytest.mark.slow
@pytest.mark.gpu
def test_dc_bolt_512_chunked_accel(gpu_device):
    bolt = build_bolt()
    res = bolt.bounds().diagonal() / 512
    tris = DualContourRenderer(bolt, res, device=gpu_device).render()
    assert len(tris) == GOLDEN_DC_BOLT_512
