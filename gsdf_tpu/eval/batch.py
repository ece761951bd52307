"""Batcher: elementwise binary operations on distance buffers
(reference gleval/batchevaluator.go:13-57 + gpu_cgo.go:18-73).

The reference compiles one-off GLSL compute shaders per operation to
combine distance buffers GPU-side (the building block for CSG over
sectioned SDFs). Here each operation is a jitted elementwise kernel;
arbitrary expressions are user callables over jnp arrays instead of GLSL
strings.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

_f32 = np.float32


class BatcherConfig:
    """(reference batchevaluator.go:9)."""

    def __init__(self, device=None):
        self.device = device


class Batcher:
    """Elementwise binary ops over distance buffers."""

    def __init__(self, cfg: BatcherConfig | None = None):
        cfg = cfg or BatcherConfig()
        self.device = cfg.device if cfg.device is not None else jax.devices()[0]
        self._union = jax.jit(jnp.minimum)
        self._diff = jax.jit(lambda a, b: jnp.maximum(a, -b))
        self._intersect = jax.jit(jnp.maximum)
        # keyed by the op OBJECT (never id(op) — see
        # execute_raw_binary_operation); bounded LRU because the jitted
        # wrapper strongly references the op, so a weak dict would never
        # collect (value -> key chain) and an unbounded one leaks a
        # callable + compiled fn per fresh lambda
        self._custom: "OrderedDict" = OrderedDict()

    def _run(self, fn, dst, a, b):
        out = np.asarray(fn(jnp.asarray(a), jnp.asarray(b)))
        if dst is None:
            return out
        dst[:] = out
        return dst

    def union(self, dst, a, b):
        """dst = min(a, b) (reference runUnion, gpu_cgo.go:18)."""
        return self._run(self._union, dst, a, b)

    def diff(self, dst, a, b):
        """dst = max(a, -b) (reference runDiff)."""
        return self._run(self._diff, dst, a, b)

    def intersect(self, dst, a, b):
        """dst = max(a, b) (reference runIntersect)."""
        return self._run(self._intersect, dst, a, b)

    def execute_raw_binary_operation(self, op: Callable, dst, a, b):
        """Arbitrary elementwise op(a, b) -> d over distance buffers
        (reference ExecuteRawBinaryOperation, batchevaluator.go:13; the
        GLSL expression string becomes a jnp callable).

        The cache is keyed by the callable OBJECT itself, never by
        ``id(op)``: a garbage-collected op's id can be reused by a new
        op, which would silently receive the wrong compiled function.
        It is a bounded LRU (256 ops) so callers that construct a fresh
        lambda per invocation don't leak a callable + compiled function
        each call for the Batcher's lifetime."""
        fn = self._custom.get(op)
        if fn is None:
            fn = jax.jit(op)
            self._custom[op] = fn
            while len(self._custom) > 256:
                self._custom.popitem(last=False)
        else:
            self._custom.move_to_end(op)
        return self._run(fn, dst, a, b)
