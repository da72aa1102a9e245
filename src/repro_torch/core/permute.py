"""Row permutations of a host BCSR.

Only the ``identity`` scheme is ported so far; the block-densifying schemes
(jaccard, rcm, shard_balance) come with the reorder slice and raise here.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import bcsr as bcsr_lib


def permute_bcsr(a: bcsr_lib.BCSR, scheme: str = "identity", *,
                 granularity: str = "element"
                 ) -> Tuple[bcsr_lib.BCSR, np.ndarray]:
    """Returns ``(a_permuted, row_perm)`` with ``a_permuted[i] ==
    a[row_perm[i]]`` row-wise."""
    if scheme != "identity":
        raise NotImplementedError(
            f"reorder scheme {scheme!r} is not ported yet; only 'identity'")
    return a, np.arange(a.shape[0], dtype=np.int64)


def invert_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv
