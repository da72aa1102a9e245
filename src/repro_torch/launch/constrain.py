"""Mesh-aware activation sharding constraints.

``constrain(x, axis0, axis1, ...)`` names the logical mesh axes an
activation's dims should be sharded over under a training mesh.  The port
runs no training mesh yet (ROADMAP §A, A11), so ``constrain`` returns
``x`` unchanged, as in mesh-less runs of the JAX package; the call sites
stand where the JAX package's do.

``BATCH`` is the conventional hierarchical batch axis (pod+data).
"""
from __future__ import annotations

BATCH = ("pod", "data")
MODEL = "model"


def constrain(x, *axes):
    return x
