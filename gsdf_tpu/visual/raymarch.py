"""Device-side sphere-tracing renderer — the headless counterpart of the
reference's interactive GLFW raymarch UI (gsdfaux/ui.go:17-245).

The reference evaluates the SDF inside a fragment shader (256 steps,
ui.go:322-333); here the identical sphere-tracing loop runs as ONE jit
kernel over the full pixel grid on the accelerator, shading included.
`turntable` renders an orbit sequence (and optionally writes an animated
GIF) — the batch equivalent of the UI's mouse orbit.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.node import Shader3D

_f32 = np.float32

_rm_cache: dict = {}


def _raymarch_fn(
    tree: Shader3D, width: int, height: int, steps: int, device,
    relax: float = 0.8, aa: int = 1, parametric: bool = False,
):
    """relax < 1 under-steps the sphere tracer: screw sweeps and other
    domain-warping ops are not 1-Lipschitz, and full steps overshoot thin
    thread features (speckle artifacts).

    aa > 1 supersamples: the aa*H x aa*W image is rendered AND
    box-filtered on device, so the fetched frame is always H x W x 3 u8,
    1/aa^2 of the supersampled payload. The integer filter reproduces
    the former host filter bit-for-bit: floor(mean + 0.5) on the u8
    samples.

    parametric=True compiles per tree STRUCTURE (eval.parametric): the
    packed continuous-parameter vector becomes a leading operand, so a
    rebind edit re-renders through the SAME executable — the viewer's
    slider loop never recompiles."""
    if parametric:
        from ..eval.parametric import structural_hash

        tree.tree_hash()  # pre-cache node hashes before tracer binding
        key = (
            "param", structural_hash(tree), width, height, steps, device,
            relax, aa,
        )
    else:
        key = (tree.tree_hash(), width, height, steps, device, relax, aa)
    fn = _rm_cache.get(key)
    if fn is not None:
        return fn
    rh, rw = height * aa, width * aa

    def impl(cam_pos, center, scale, yaw, pitch, light_dir):
        iy = jax.lax.broadcasted_iota(jnp.float32, (rh, rw), 0)
        ix = jax.lax.broadcasted_iota(jnp.float32, (rh, rw), 1)
        uv_x = (2.0 * ix - rw) / rh
        uv_y = -(2.0 * iy - rh) / rh

        def scene(p):
            return tree.distance(p * scale + center) / scale

        # camera basis (orbit about +z up, like the UI's yaw/pitch orbit)
        cy, sy = jnp.cos(yaw), jnp.sin(yaw)
        cp, sp = jnp.cos(pitch), jnp.sin(pitch)
        ro = cam_pos * jnp.stack([cy * cp, sy * cp, sp])
        ww = -ro / jnp.sqrt(jnp.sum(ro * ro))
        # at pitch -> +-pi/2 the +z up is parallel to ww (cross = 0,
        # normalize = NaN over the whole frame): fall back to +x up for
        # straight-down/up views. The viewer clamps pitch to +-1.45
        # (|sin| < 0.993) so this select never fires there.
        up = jnp.where(
            jnp.abs(sp) > 0.999,
            jnp.asarray(np.array([1, 0, 0], _f32)),
            jnp.asarray(np.array([0, 0, 1], _f32)),
        )
        uu = jnp.cross(ww, up)
        uu = uu / jnp.sqrt(jnp.sum(uu * uu))
        vv = jnp.cross(uu, ww)
        rd = (
            uv_x[..., None] * uu + uv_y[..., None] * vv + 1.8 * ww
        )
        rd = rd / jnp.sqrt(jnp.sum(rd * rd, axis=-1, keepdims=True))

        def body(_, carry):
            t, done = carry
            p = ro + rd * t[..., None]
            d = scene(p)
            hit = jnp.abs(d) < 1e-4
            newly = hit & ~done
            t = jnp.where(done | newly, t, t + d * np.float32(relax))
            # far plane follows the (traced) camera distance: the scene
            # is normalized to radius <= sqrt(3), so any surface point
            # lies within cam_pos + sqrt(3) along a ray — a fixed far
            # plane would silently render pure sky for cam_dist > ~6
            return t, done | newly | (t > cam_pos + 4.0)

        t0 = jnp.zeros((rh, rw), jnp.float32)
        done0 = jnp.zeros((rh, rw), bool)
        t, done = jax.lax.fori_loop(0, steps, body, (t0, done0))

        pos = ro + rd * t[..., None]
        d_final = scene(pos)
        hit = jnp.abs(d_final) < 1e-3

        # tetrahedral normals
        h = _f32(1e-4)
        k1 = jnp.asarray(np.array([1, -1, -1], _f32))
        k2 = jnp.asarray(np.array([-1, -1, 1], _f32))
        k3 = jnp.asarray(np.array([-1, 1, -1], _f32))
        k4 = jnp.asarray(np.array([1, 1, 1], _f32))
        n = (
            k1 * scene(pos + k1 * h)[..., None]
            + k2 * scene(pos + k2 * h)[..., None]
            + k3 * scene(pos + k3 * h)[..., None]
            + k4 * scene(pos + k4 * h)[..., None]
        )
        n = n / jnp.sqrt(jnp.sum(n * n, axis=-1, keepdims=True) + 1e-20)

        dif = jnp.clip(jnp.sum(n * light_dir, axis=-1), 0.0, 1.0)
        amb = 0.5 + 0.5 * n[..., 2]
        base = jnp.asarray(np.array([0.85, 0.6, 0.3], _f32))
        col_hit = base * (0.25 * amb + 0.8 * dif)[..., None]
        spec = jnp.clip(
            jnp.sum((rd - 2 * jnp.sum(rd * n, axis=-1, keepdims=True) * n) * light_dir, axis=-1),
            0.0,
            1.0,
        ) ** 16
        col_hit = col_hit + 0.15 * spec[..., None]
        sky = jnp.asarray(np.array([0.65, 0.78, 0.9], _f32)) - 0.4 * rd[..., 2:3]
        col = jnp.where(hit[..., None], col_hit, sky)
        col = jnp.clip(col, 0.0, 1.0) ** (1 / 2.2)
        img = (col * 255).astype(jnp.uint8)
        if aa == 1:
            return img
        # device-side box filter over the u8 samples, bit-identical to
        # the former host filter: floor(sum/n + 0.5) = (2*sum+n)//(2n)
        s = jnp.sum(
            img.reshape(height, aa, width, aa, 3).astype(jnp.int32),
            axis=(1, 3),
        )
        n = aa * aa
        return ((2 * s + n) // (2 * n)).astype(jnp.uint8)

    if parametric:
        from ..eval.parametric import _bind_params, param_spec

        spec = param_spec(tree)

        def impl_param(flat, *args):
            with _bind_params(spec, flat):
                return impl(*args)

        jitted_p = jax.jit(impl_param)

        def fn(*args, params, _jitted=jitted_p, _dev=device):
            with jax.default_device(_dev):
                return _jitted(
                    jax.device_put(params, _dev),
                    *[jax.device_put(a, _dev) for a in args],
                )

        _rm_cache[key] = fn
        return fn

    jitted = jax.jit(impl)

    def fn(*args, _jitted=jitted, _dev=device):
        with jax.default_device(_dev):
            return _jitted(*[jax.device_put(a, _dev) for a in args])

    _rm_cache[key] = fn
    return fn


def auto_relax(obj: Shader3D) -> float:
    """Sphere-tracing relaxation appropriate for this tree.

    Domain-warping ops (helical screw sweeps, twist) and shells of scaled
    fields are not 1-Lipschitz: full steps overshoot thin features and
    speckle (the reference's fragment raymarcher has the same artifact).
    Under-step those trees automatically."""
    warping = {"ScrewNode", "Twist"}
    for n in obj.visit_bfs():
        if type(n).__name__ in warping:
            return 0.6
    return 0.8


def raymarch_image_device(
    obj: Shader3D,
    width: int = 512,
    height: int = 512,
    yaw: float = 0.6,
    pitch: float = 0.5,
    cam_dist: float = 2.4,
    steps: int = 196,
    device=None,
    relax: float | None = None,
    aa: int = 1,
    parametric: bool = False,
):
    """Dispatch one shaded view and return the DEVICE array (H,W,3 u8)
    WITHOUT fetching. jax dispatch is asynchronous, so a caller can
    overlap frame N+1's compute with frame N's fetch by holding two
    in-flight arrays and calling np.asarray on the older one — the
    interactive viewer's drag-frame pipelining.

    parametric=True routes through the per-STRUCTURE executable: a
    tree.rebind edit re-renders with zero recompiles (slider loops)."""
    device = device if device is not None else jax.devices()[0]
    relax = auto_relax(obj) if relax is None else relax
    bb = obj.bounds()
    center = bb.center().astype(_f32)
    scale = _f32(max(float(np.max(bb.size())) / 2, 1e-9))
    light = np.array([0.6, 0.4, 0.8], _f32)
    light /= np.linalg.norm(light)
    fn = _raymarch_fn(
        obj, width, height, steps, device, relax, aa=int(aa),
        parametric=parametric,
    )
    args = (
        _f32(cam_dist),
        jnp.asarray(center),
        scale,
        _f32(yaw),
        _f32(pitch),
        jnp.asarray(light),
    )
    if parametric:
        from ..eval.parametric import pack_params

        return fn(*args, params=jnp.asarray(pack_params(obj)))
    return fn(*args)


def raymarch_image(
    obj: Shader3D,
    width: int = 512,
    height: int = 512,
    yaw: float = 0.6,
    pitch: float = 0.5,
    cam_dist: float = 2.4,
    steps: int = 196,
    device=None,
    relax: float | None = None,
    aa: int = 1,
    parametric: bool = False,
) -> np.ndarray:
    """Render one shaded view of the part, returning (H,W,3) uint8.

    relax=None picks a step relaxation automatically (auto_relax).
    aa > 1 supersamples (renders aa*W x aa*H and box-filters down ON
    DEVICE — the reference UI's uAA antialiasing, gsdfaux/ui.go:131-241
    — so the fetched frame is always W x H regardless of aa)."""
    return np.asarray(
        raymarch_image_device(
            obj, width, height, yaw, pitch, cam_dist, steps, device, relax,
            aa, parametric=parametric,
        )
    )


def turntable(
    obj: Shader3D,
    n_frames: int = 24,
    width: int = 384,
    height: int = 384,
    pitch: float = 0.5,
    gif_path: Optional[str] = None,
    device=None,
):
    """Render an orbit of the part; optionally write an animated GIF."""
    frames = [
        raymarch_image(
            obj, width, height, yaw=2 * math.pi * i / n_frames, pitch=pitch,
            device=device,
        )
        for i in range(n_frames)
    ]
    if gif_path:
        from PIL import Image

        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(
            gif_path, save_all=True, append_images=imgs[1:], duration=80, loop=0
        )
    return frames
