"""Checkpoint and resume of assembled systems and solver state (PyTorch twin
of `saddle_point_petsc_tpu.utils.checkpoint`).

`.npz` dump and restore of a tree of tensors (assembled operators,
right-hand sides, solutions, Krylov results), and a warm restart that
resumes a Krylov solve from a saved iterate. The file layout is the JAX
package's: one array `leaf_{i}` per leaf in flattening order, and
`__treedef__`, a text description of the structure as bytes (written for
the reader; loading takes the structure from a template).

Flattening: a dataclass flattens its constructor fields in field order, a
tuple or list its items in order; a tensor and a Python int or float are
leaves; None and strings are structure (kept from the
template on load). `PoissonProblem` thus flattens as (A.planes, f,
bc_mask, coords) and `KrylovResult` as (x, iterations, rnorm, rnorm0,
history, converged_reason), the JAX package's pytree orders, so a file
written by either package loads through the other's `load_like`.

Saving goes through the host; `load_like` puts each leaf on its template
leaf's device and in its dtype, and gives a Python scalar where the
template has one.
"""
from __future__ import annotations

import dataclasses
import json
import numbers

import numpy as np
import torch


def _is_leaf(x):
    return isinstance(x, (torch.Tensor, numbers.Number))


def _flatten(tree, leaves):
    """Append tree's leaves to `leaves`; return its structure as text."""
    if _is_leaf(tree):
        leaves.append(tree)
        return "*"
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = [f"{f.name}={_flatten(getattr(tree, f.name), leaves)}"
                 for f in dataclasses.fields(tree) if f.init]
        return f"{type(tree).__name__}({', '.join(parts)})"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_flatten(t, leaves) for t in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    if tree is None or isinstance(tree, str):
        return repr(tree)
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def tree_flatten(tree):
    """(leaves, structure text) of a tree of dataclasses, tuples and lists."""
    leaves = []
    return leaves, _flatten(tree, leaves)


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path, tree):
    """Save a tree of tensors (and Python scalars) to .npz through the host."""
    leaves, structure = tree_flatten(tree)
    arrays = {f"leaf_{i}": _to_host(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def load_leaves(path):
    """The flat leaf list saved by save_pytree (order kept), as CPU tensors."""
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        return [torch.from_numpy(np.array(z[f"leaf_{i}"])) for i in range(n)]


def _like(leaf, tmpl):
    """A loaded leaf (CPU tensor) on the template leaf's device and dtype."""
    if isinstance(tmpl, torch.Tensor):
        return leaf.to(device=tmpl.device, dtype=tmpl.dtype)
    return type(tmpl)(leaf.item())


def _unflatten(tmpl, leaves):
    if _is_leaf(tmpl):
        return _like(next(leaves), tmpl)
    if dataclasses.is_dataclass(tmpl):
        fields = {f.name: _unflatten(getattr(tmpl, f.name), leaves)
                  for f in dataclasses.fields(tmpl) if f.init}
        return type(tmpl)(**fields)
    if isinstance(tmpl, (tuple, list)):
        return type(tmpl)(_unflatten(t, leaves) for t in tmpl)
    return tmpl  # None or a string


def load_like(path, template):
    """Load into the structure of `template` (the structure that was saved)."""
    leaves = load_leaves(path)
    n = len(tree_flatten(template)[0])
    if n != len(leaves):
        raise ValueError(f"{path}: {len(leaves)} leaves saved, the template has {n}")
    return _unflatten(template, iter(leaves))


def save_solver_state(path, result, meta=None):
    """Save a KrylovResult (x, history, counters) for a warm restart, and
    `meta` as JSON beside it."""
    save_pytree(path, result)
    if meta:
        with open(str(path) + ".meta.json", "w") as f:
            json.dump(meta, f)
    return path


def resume_solve(solver, A, b, path, template_result, **kwargs):
    """Resume a Krylov solve from a checkpointed result's iterate (x0)."""
    prev = load_like(path, template_result)
    return solver(A, b, x0=prev.x, **kwargs)
