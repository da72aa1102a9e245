"""The JAX package's scan-unroll switch, kept for its names.

The JAX package scans its layer stacks and chunk recurrences with
``jax.lax.scan`` and unrolls them into Python loops when its dry-run asks
(XLA's cost analysis counts a ``while`` body once).  Eager PyTorch has no
scan to lower: ``scan`` is always a Python loop, so ``unrolled()`` is always
true and ``unroll_scans()`` changes nothing.
"""
from __future__ import annotations

import contextlib

import torch


def unrolled() -> bool:
    return True


@contextlib.contextmanager
def unroll_scans():
    yield


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def scan(body, carry, xs, length=None):
    """``jax.lax.scan``'s contract as a Python loop over the leading axis of
    ``xs`` (a tensor, or a tuple/list/dict of them; None with ``length``):
    returns ``(carry, ys)`` with each ``y`` leaf stacked on a new leading
    axis, or None when the body returns None."""
    n = length if xs is None else _leaves(xs)[0].shape[0]
    ys = []
    for i in range(n):
        x = None if xs is None else _map(lambda a: a[i], xs)
        carry, y = body(carry, x)
        ys.append(y)
    if not ys or all(y is None for y in ys):
        return carry, None
    return carry, _map(lambda *a: torch.stack(a), *ys)
