"""TTF text -> 2D SDF (JAX rebuild of reference forge/textsdf)."""
from .font import Font, FontConfig

__all__ = ["Font", "FontConfig"]
