"""``optim.compress`` against the JAX package's on the same numpy inputs.

``quantize_int8``'s codes and scale are exact (round half to even in both,
the ``+ 1e-12`` and ``/ 127.0`` in float32), and so is ``init_residual``.
Error feedback over R = 4 ranks runs in the 4-rank ``gloo`` group of
``test_torch_train_mesh.py``, against ``jax.vmap(..., axis_name="data")``
(``jax_mesh_reference.py``)."""
# ruff: noqa: E402
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np
import torch

from repro.optim import compress as jcompress
from repro_torch.optim import compress

@pytest.mark.parametrize("x", [
    np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0], np.float32),
    np.random.default_rng(0).standard_normal(300).astype(np.float32),
    np.random.default_rng(1).standard_normal((7, 9)).astype(np.float32) * 3e-7,
    np.zeros(5, np.float32),
])
def test_quantize_int8_codes_and_scale_exact(x):
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(
        compress.dequantize_int8(q, s).numpy(),
        np.asarray(jcompress.dequantize_int8(jq, js)))


def test_init_residual_matches_jax():
    rng = np.random.default_rng(7)
    g = {"w": rng.standard_normal((24, 16)).astype(np.float32),
         "b": rng.standard_normal(16).astype(np.float32),
         "idx": np.arange(5, dtype=np.int32)}
    want = jcompress.init_residual({k: jnp.asarray(v) for k, v in g.items()})
    got = compress.init_residual({k: torch.from_numpy(v)
                                  for k, v in g.items()})
    for k in g:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_psum_needs_an_active_mesh():
    with pytest.raises(ValueError, match="needs an active mesh"):
        compress.compressed_psum(torch.ones(3), "data")
