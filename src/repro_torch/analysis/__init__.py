"""Static contract analyzer of the port: ``python -m repro_torch.analysis``.

The twin of ``repro.analysis``, with its budgets restated for the H100.
Three passes prove the invariants the CUDA kernels and the autotune cache
assume:

* ``verify_launch`` -- schedule coverage / sentinel / bounds checks per
  meta, each kernel's CUDA grid against the card's limits and its CTA's
  shared memory against the H100's 227 KB, the compiled functions'
  registers (``cuobjdump -res-usage``), plus the ``REPRO_VERIFY_LAUNCH=1``
  pre-dispatch hook in ``kernels.ops.resolve_backend``;
* ``lint_rules`` -- AST rules over ``src/repro_torch/`` (host syncs and
  obs calls reachable from an autograd Function, lru_cache signatures,
  forward/backward pairing, frozen static metadata, fingerprint field
  coverage, the package facade);
* ``fingerprint_audit`` -- the key grammar (the JAX package's v7 key plus
  ``|dev=<device>``): parse, injectivity, the autotune cache.

``workspace`` holds the shared byte estimators: the JAX package's working
sets (``fits_vmem``, the reference autotuner's ``pick_bn``) and the CUDA
kernels' own shared memory and thread counts (which the port's ``pick_bn``
budgets), with the H100's limits.
"""
from repro_torch.analysis import workspace
from repro_torch.analysis.report import Finding, render

__all__ = ["Finding", "render", "workspace"]
