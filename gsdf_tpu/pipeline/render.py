"""High-level render pipeline (JAX rebuild of reference gsdfaux.RenderShader3D,
gsdfaux/gsdfaux.go:63-241): tree -> evaluator -> renderer -> STL/visual with
stopwatch log lines in the reference's `[dur] msg` format.
"""
from __future__ import annotations

import dataclasses
import time
from typing import BinaryIO, Callable, Optional, TextIO

import numpy as np

from ..core.node import Shader3D
from ..render.flat import FlatRenderer

_f32 = np.float32


@dataclasses.dataclass
class RenderConfig:
    """(reference gsdfaux.go:25-47)."""

    stl_output: Optional[BinaryIO] = None
    visual_output: Optional[TextIO] = None
    resolution: float = 0.0
    #: True renders on the first GPU and raises where there is none;
    #: False on the host CPU backend; None on JAX's default device
    use_gpu: Optional[bool] = None
    silent: bool = False
    #: accepted for API parity with the reference's BlockCachedSDF3 option;
    #: the fused device path evaluates each grid corner exactly once, so a
    #: voxel memo cache cannot reduce work and the flag is a no-op.
    enable_caching: bool = False
    device: object = None


def _stopwatch():
    start = time.monotonic()
    last = [start]

    def lap():
        now = time.monotonic()
        dt = now - last[0]
        last[0] = now
        return dt

    return lap


def _fmt_dur(seconds: float) -> str:
    if seconds < 1e-3:
        return f"{seconds * 1e6:.0f}µs"
    if seconds < 1:
        return f"{seconds * 1e3:.1f}ms"
    return f"{seconds:.3f}s"


def render_device(use_gpu: Optional[bool]):
    """The device a `use_gpu` setting names: the first GPU for True (JAX
    raises where there is none, so a render that asked for the GPU never
    runs on the CPU), the CPU for False, JAX's default device for None."""
    import jax

    if use_gpu is None:
        return jax.devices()[0]
    return jax.devices("gpu" if use_gpu else "cpu")[0]


def render_shader3d(obj: Shader3D, cfg: RenderConfig) -> dict:
    """Render a 3D shape to STL (and optionally a shadertoy visual).

    Returns a stats dict: triangles, evaluations, timings.
    """
    if cfg.resolution <= 0:
        raise ValueError("RenderConfig.resolution must be positive")
    log: Callable[[str], None] = (lambda msg: None) if cfg.silent else print
    lap = _stopwatch()
    stats: dict = {}

    device = cfg.device if cfg.device is not None else render_device(cfg.use_gpu)
    renderer = FlatRenderer(obj, cfg.resolution, device=device)
    log(f"[{_fmt_dur(lap())}] renderer init (grid {renderer.nx}x{renderer.ny}x{renderer.nz})")

    # compact-field production path: minimal device->host payload, native
    # host-side table walk; triangle count matches the soup path exactly,
    # coordinates to the last ulp (falls back to welded for huge grids)
    verts, tri_idx = renderer.render_compact()
    dt_render = lap()
    stats["render_seconds"] = dt_render
    stats["triangles"] = len(tri_idx)
    stats["evaluations"] = renderer.evaluations()
    log(
        f"[{_fmt_dur(dt_render)}] evaluated SDF {renderer.evaluations()} times "
        f"and generated {len(tri_idx)} triangles at resolution {cfg.resolution:.6g}"
    )

    if cfg.stl_output is not None:
        from ..render.stl import write_binary_stl_indexed

        n = write_binary_stl_indexed(cfg.stl_output, verts, tri_idx)
        dt_stl = lap()
        stats["stl_seconds"] = dt_stl
        stats["stl_bytes"] = n
        log(f"[{_fmt_dur(dt_stl)}] wrote {n} bytes STL")

    if cfg.visual_output is not None:
        from ..visual.shadertoy import write_shadertoy_visual

        write_shadertoy_visual(cfg.visual_output, obj)
        log(f"[{_fmt_dur(lap())}] wrote visualization")

    # the indexed mesh, already in hand — callers gather a soup with
    # verts[tri_idx] if they need one (a dense (T,3,3) array is ~3x the
    # indexed payload, so it is not materialized eagerly here)
    stats["verts"] = verts
    stats["tri_idx"] = tri_idx
    return stats


def render_png_file_2d(path, obj, width: int = 512, height: int = 512, device=None):
    """Render a 2D SDF to a PNG file (reference gsdfaux.RenderPNGFile,
    gsdfaux.go:267)."""
    from ..render.image import render_image_2d, write_png

    img = render_image_2d(obj, width, height, device=device)
    write_png(path, img)
    return img


@dataclasses.dataclass
class UIConfig:
    """(reference gsdfaux.UIConfig, gsdfaux.go:49)."""

    width: int = 800
    height: int = 600
    frames: int = 24
    pitch: float = 0.5
    gif_path: Optional[str] = None


def ui(obj: Shader3D, cfg: UIConfig = UIConfig()):
    """Headless counterpart of the reference's interactive raymarch UI
    (gsdfaux.UI): renders an orbiting turntable of the part with the
    device-side sphere tracer and optionally writes an animated GIF. Returns
    the list of (H,W,3) frames."""
    from ..visual.raymarch import turntable

    return turntable(
        obj,
        n_frames=cfg.frames,
        width=cfg.width,
        height=cfg.height,
        pitch=cfg.pitch,
        gif_path=cfg.gif_path,
    )
