"""Builder: shape factory with the reference's validation + error policy.

Mirrors reference gsdf.go:27-106: a `Flags` bitmask controls whether invalid
dimensions raise immediately (default) or accumulate for later inspection via
`err()` / `clear_errors()`. The shader-buffer flags of the reference
(FlagUseShaderBuffers / FlagNoShaderBuffers, gsdf.go:36-39) have no XLA
meaning — XLA constants vs. operands replace SSBOs — but are kept as no-op
bits for API parity so user code ports cleanly.
"""
from __future__ import annotations

import enum
from typing import List


class Flags(enum.IntFlag):
    NONE = 0
    #: don't raise on invalid shape dimensions; accumulate errors instead
    #: (reference FlagNoDimensionPanic, gsdf.go:33).
    NO_DIMENSION_PANIC = 1 << 0
    #: kept for API parity; under XLA large vertex arrays are always device
    #: operands, so these bits only affect the `use_shader_buffer` heuristic.
    USE_SHADER_BUFFERS = 1 << 1
    NO_SHADER_BUFFERS = 1 << 2


class ShapeError(ValueError):
    """Raised for invalid shape dimensions when NO_DIMENSION_PANIC unset."""


class BuilderCore:
    """Error-policy core. Shape methods are added by mixin modules."""

    def __init__(self, flags: Flags = Flags.NONE):
        self._flags = flags
        self._accum_errs: List[ShapeError] = []
        self._lim_vec_gpu = 0

    # --- flags (reference gsdf.go:73-85) -----------------------------
    @property
    def flags(self) -> Flags:
        return self._flags

    def set_flags(self, flags: Flags) -> None:
        if flags & Flags.USE_SHADER_BUFFERS and flags & Flags.NO_SHADER_BUFFERS:
            raise ValueError("invalid flag setup: both use/avoid shader buffer bits set")
        self._flags = flags

    # --- error accumulation (reference gsdf.go:88-106) ---------------
    def err(self) -> Exception | None:
        if not self._accum_errs:
            return None
        if len(self._accum_errs) == 1:
            return self._accum_errs[0]
        return ExceptionGroup("accumulated shape errors", list(self._accum_errs))

    def clear_errors(self) -> None:
        self._accum_errs.clear()

    def shape_error(self, msg: str, *args) -> None:
        if args:
            msg = msg % args
        if not self._flags & Flags.NO_DIMENSION_PANIC:
            raise ShapeError(msg)
        self._accum_errs.append(ShapeError(msg))

    def nilsdf(self, msg: str) -> None:
        raise ValueError("nil SDF argument: " + msg)

    def use_shader_buffer(self, components: int) -> bool:
        """Heuristic parity with reference gsdf.go:53-64. Under XLA this only
        decides whether vertex arrays become device operands (always fine)."""
        if self._flags & Flags.NO_SHADER_BUFFERS:
            return False
        lim = self._lim_vec_gpu or 128
        return bool(self._flags & Flags.USE_SHADER_BUFFERS) or components > lim
