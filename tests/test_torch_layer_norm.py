"""The port's fused LayerNorm (CPU path: the kernel's plain version behind
the same autograd op) against the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs.  Tolerances are the reference's own
(tests/test_layer_norm_kernel.py): forward 1e-5, gradients 2e-4, bf16 2e-2.
The CUDA kernels themselves are held to these plain versions on the card by
chip_smoke.py and tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.layer_norm import fused_layer_norm as jax_ln
from paddle_tpu_torch.kernels import layer_norm as ptln


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, shape):
    rng = np.random.RandomState(seed)
    E = shape[-1]
    return (rng.randn(*shape).astype("f4") * 2 + 1,
            rng.rand(E).astype("f4") + 0.5,
            rng.randn(E).astype("f4"),
            rng.randn(*shape).astype("f4"))


@pytest.mark.parametrize("shape", [(4, 64, 96), (3, 7, 40)])
def test_forward_matches_jax(shape):
    x, s, b, _ = _inputs(0, shape)
    want = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))) \
        if shape[0] * shape[1] % 8 == 0 else None
    got = ptln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                                torch.from_numpy(b)).numpy()
    if want is None:
        # a row count the Pallas kernel cannot tile: hold the port to the
        # reference's unfused formulation instead
        xf = x.astype("f8")
        mu = xf.mean(-1, keepdims=True)
        var = ((xf - mu) ** 2).mean(-1, keepdims=True)
        want = (xf - mu) / np.sqrt(var + 1e-6) * s + b
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_gradients_match_jax():
    x, s, b, w = _inputs(1, (2, 128, 64))

    def lf(x, s, b):
        return jnp.sum(jax_ln(x, s, b) * jnp.asarray(w))

    want = jax.grad(lf, argnums=(0, 1, 2))(*map(jnp.asarray, (x, s, b)))
    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, s, b))
    (ptln.fused_layer_norm(xt, st, bt) * torch.from_numpy(w)).sum().backward()
    for got, ref, n in zip((xt.grad, st.grad, bt.grad), want,
                           ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=2e-4, rtol=2e-4, err_msg=n)


def test_bf16_matches_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(8, 32, 32).astype("f4")
    s, b = np.ones(32, "f4"), np.zeros(32, "f4")
    want = jax_ln(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s),
                  jnp.asarray(b))
    got = ptln.fused_layer_norm(torch.from_numpy(x).bfloat16(),
                                torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype="f4"), atol=2e-2)


def test_eps_is_reference_default():
    """eps 1e-6 (transformer.py:193), not torch's 1e-5: visible on rows of
    tiny variance."""
    x = np.full((8, 16), 3.0, "f4")
    x[:, ::2] += 1e-3
    s, b = np.ones(16, "f4"), np.zeros(16, "f4")
    want = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = ptln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                                torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    torch_default = torch.nn.functional.layer_norm(
        torch.from_numpy(x), (16,), eps=1e-5).numpy()
    assert np.abs(torch_default - want).max() > 0.1


def test_cpu_path_counts_no_launch():
    from paddle_tpu_torch.kernels import _common

    before = dict(_common.launches)
    x, s, b, _ = _inputs(3, (16, 32))
    ptln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                          torch.from_numpy(b))
    assert _common.launches == before

