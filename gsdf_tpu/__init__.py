"""gsdf_tpu — a signed-distance-function CAD kernel in JAX.

A ground-up rebuild of the capabilities of soypat/gsdf on JAX/XLA:
the CSG tree is a tree of jnp distance functions traced once by jax.jit
(replacing GLSL codegen + OpenGL compute), rendering is vectorized
device-side marching cubes / dual contouring, and engineering layers
(threads, text) compose on top.
"""
from .core import Builder, Flags, Shader2D, Shader3D, ShapeError
from .utils.config import enable_persistent_cache

enable_persistent_cache()

__version__ = "0.1.0"

__all__ = ["Builder", "Flags", "Shader2D", "Shader3D", "ShapeError", "__version__"]
