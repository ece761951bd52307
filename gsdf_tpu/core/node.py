"""SDF tree node contracts — the JAX replacement for the reference's
dual Shader3D/Shader2D + CPU-evaluator architecture.

In the reference, every node implements (a) GLSL codegen (glbuild/glbuild.go:25-90)
and (b) a vectorized CPU `Evaluate` (cpu_evaluators.go). Here there is ONE
implementation per node: a jnp `distance` function over batched points.
`jax.jit` traces the composed tree into a single fused XLA executable — the
role played by glbuild.Programmer's shader flattening (glbuild.go:299-396)
is subsumed by the compiler. The structural `tree_hash` plays the role of the
reference's shader-name hashing (AppendShaderName) as the compile-cache key.

Nodes are immutable after construction. Parameters are embedded as
compile-time constants in the trace, exactly as the reference embeds them as
GLSL literals.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Tuple

import numpy as np

from ..geometry.boxes import Box


def _param_bytes(v) -> bytes:
    if isinstance(v, np.ndarray):
        return v.astype(np.float32, copy=False).tobytes() + str(v.shape).encode()
    if isinstance(v, (float, np.floating)):
        return np.float32(v).tobytes()
    if isinstance(v, (int, np.integer, bool)):
        return int(v).to_bytes(8, "little", signed=True)
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, (tuple, list)):
        out = b"("
        for x in v:
            out += _param_bytes(x) + b","
        return out + b")"
    raise TypeError(f"unhashable SDF parameter type {type(v)}")


class Shader:
    """Base for all SDF nodes (2D and 3D)."""

    #: subclasses list the names of attributes that are *parameters*
    #: (floats / int / numpy arrays) contributing to structural identity.
    PARAMS: Tuple[str, ...] = ()
    #: subclasses list the names of attributes holding child nodes.
    CHILDREN: Tuple[str, ...] = ()

    _tree_hash_cache: bytes | None = None

    def children(self) -> Tuple["Shader", ...]:
        return tuple(getattr(self, name) for name in self.CHILDREN)

    def tree_hash(self) -> bytes:
        """Structural hash: node type + params + child hashes.

        Used as the jit-compile cache key (analog of the reference's
        generated shader name, glbuild.go:400).
        """
        if self._tree_hash_cache is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(type(self).__qualname__.encode())
            for name in self.PARAMS:
                h.update(name.encode())
                h.update(_param_bytes(getattr(self, name)))
            for c in self.children():
                h.update(c.tree_hash())
            self._tree_hash_cache = h.digest()
        return self._tree_hash_cache

    def visit_bfs(self) -> Iterable["Shader"]:
        """All nodes of the tree in BFS order (root first)."""
        queue = [self]
        while queue:
            n = queue.pop(0)
            yield n
            queue.extend(n.children())

    def visit_dfs(self) -> Iterable["Shader"]:
        """All nodes of the tree in DFS pre-order (root first; reference
        forEachNodeDFS, glbuild/glbuild.go:783)."""
        stack = [self]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(reversed(list(n.children())))

    def node_count(self) -> int:
        return sum(1 for _ in self.visit_bfs())

    def rebind(self, edits: dict) -> "Shader":
        """Supported in-place edit of CONTINUOUS parameters — the
        parametric-editing API (pairs with FlatRenderer's
        parametric=True renders: same structure, zero recompiles).

        edits: {node: {param_name: new_value}} where each node is an
        object in THIS tree and each param is listed in that node's
        CONT_PARAMS. Structural parameters (anything baked into the
        trace) are rejected — rebuild the tree to change those. Values
        are cast to float32; array shapes must match (structural-hash
        stability). Derived continuous values (e.g. a transform's
        inverse matrix) are recomputed automatically: nodes declaring a
        `_rebind_derived()` hook have it invoked after their edits are
        applied, so `rebind({transform: {"t": M}})` is complete by
        itself.

        All cached structural hashes in the tree are invalidated, so
        subsequent NON-parametric renders also see the edit (a fresh
        tree hash -> fresh executable), never a stale cached one.
        Returns self."""
        in_tree = {id(n) for n in self.visit_bfs()}
        for node, kv in edits.items():
            if id(node) not in in_tree:
                raise ValueError(f"{type(node).__name__} node is not in this tree")
            cont = set(getattr(node, "CONT_PARAMS", ()))
            for name, val in kv.items():
                if name not in node.PARAMS:
                    raise AttributeError(
                        f"{type(node).__name__} has no parameter {name!r}"
                    )
                if name not in cont:
                    raise ValueError(
                        f"{type(node).__name__}.{name} is structural (baked "
                        "into the trace); rebuild the tree to change it"
                    )
                old = np.asarray(getattr(node, name), np.float32)
                new = np.asarray(val, np.float32)
                if new.shape != old.shape:
                    raise ValueError(
                        f"{type(node).__name__}.{name}: shape {new.shape} "
                        f"!= existing {old.shape}"
                    )
                object.__setattr__(
                    node, name, new if new.shape else np.float32(val)
                )
            derive = getattr(node, "_rebind_derived", None)
            if derive is not None:
                derive()
        for n in self.visit_bfs():
            object.__setattr__(n, "_tree_hash_cache", None)
        return self


class Shader3D(Shader):
    """A 3D signed-distance node.

    distance(p) evaluates the SDF at p with shape (..., 3) returning (...,)
    float32. Must be jnp-traceable (no data-dependent Python control flow).
    """

    def distance(self, p):  # pragma: no cover - interface
        raise NotImplementedError

    def bounds(self) -> Box:  # pragma: no cover - interface
        raise NotImplementedError


class Shader2D(Shader):
    """A 2D signed-distance node; distance(p) maps (..., 2) -> (...,)."""

    def distance(self, p):  # pragma: no cover - interface
        raise NotImplementedError

    def bounds(self) -> Box:  # pragma: no cover - interface
        raise NotImplementedError
