"""The port's fused batch norm (CPU path: the kernels' plain versions behind
the same autograd ops) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs.  Tolerances are those of the
reference's own tests (tests/test_fused_bn.py): f32 forward 1e-5, gradients
1e-4, bf16 1e-2.  The CUDA kernels are held to these plain versions on the
card by chip_smoke.py and tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import fused_bn as jfbn
from paddle_tpu_torch.kernels import _common
from paddle_tpu_torch.kernels import fused_bn as pfbn


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F32 = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=1e-2, rtol=1e-2)


def _params(rng, C):
    return (rng.rand(C).astype("f4") + 0.5, rng.randn(C).astype("f4"))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_stats_matches_jax(dtype):
    x = np.random.RandomState(0).randn(6, 7, 5, 16).astype("f4") + 2.0
    s, q = jfbn.bn_stats(jnp.asarray(x, dtype))
    ps, pq = pfbn.bn_stats(_t(x, getattr(torch, dtype)))
    assert ps.dtype == pq.dtype == torch.float32
    np.testing.assert_allclose(_np(ps), np.asarray(s), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(pq), np.asarray(q), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (4, 6, 6, 16)),
    ("bfloat16", (4, 6, 6, 16)),
    ("float32", (3, 5, 7, 11)),       # a row count no block divides
])
def test_fused_bn_train_forward_matches_jax(dtype, shape):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype("f4")
    scale, bias = _params(rng, shape[-1])
    y, m, v = jfbn.fused_bn_train(jnp.asarray(x, dtype), jnp.asarray(scale),
                                  jnp.asarray(bias))
    py, pm, pv = pfbn.fused_bn_train(_t(x, getattr(torch, dtype)), _t(scale),
                                     _t(bias))
    assert py.dtype == getattr(torch, dtype) and pm.dtype == torch.float32
    np.testing.assert_allclose(_np(py), np.asarray(y, np.float32),
                               **(BF16 if dtype == "bfloat16" else F32))
    np.testing.assert_allclose(_np(pm), np.asarray(m), **F32)
    np.testing.assert_allclose(_np(pv), np.asarray(v), **F32)


def _jax_grads(fn, x, scale, bias, w):
    def loss(x, s, b):
        return jnp.sum(fn(x, s, b).astype(jnp.float32) * w)
    return [np.asarray(g, np.float32)
            for g in jax.grad(loss, argnums=(0, 1, 2))(x, scale, bias)]


def _torch_grads(fn, x, scale, bias, w):
    leaves = [t.clone().requires_grad_() for t in (x, scale, bias)]
    (fn(*leaves).float() * w).sum().backward()
    return [_np(t.grad) for t in leaves]


@pytest.mark.parametrize("dtype,shape", [
    ("float32", (4, 5, 5, 8)),
    ("float32", (3, 5, 7, 11)),
    ("bfloat16", (4, 6, 6, 16)),
])
def test_fused_bn_train_backward_matches_jax(dtype, shape):
    """dx / dgamma / dbeta through a loss that weights every output."""
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype("f4")
    scale, bias = _params(rng, shape[-1])
    w = rng.randn(*shape).astype("f4")
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = _jax_grads(lambda x, s, b: jfbn.fused_bn_train(x, s, b)[0],
                      jnp.asarray(x, jd), jnp.asarray(scale), jnp.asarray(bias),
                      jnp.asarray(w))
    got = _torch_grads(lambda x, s, b: pfbn.fused_bn_train(x, s, b)[0],
                       _t(x, td), _t(scale), _t(bias), _t(w))
    for g, r, n in zip(got, want, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(g, r, err_msg=n,
                                   **(BF16 if dtype == "bfloat16" else GRAD))


def test_fused_scale_shift_and_eval_match_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 6, 8).astype("f4")
    scale, bias = _params(rng, 8)
    mean, var = rng.randn(8).astype("f4"), rng.rand(8).astype("f4") + 0.5
    w = rng.randn(4, 6, 6, 8).astype("f4")
    y = jfbn.fused_bn_eval(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                           jnp.asarray(mean), jnp.asarray(var))
    py = pfbn.fused_bn_eval(_t(x), _t(scale), _t(bias), _t(mean), _t(var))
    np.testing.assert_allclose(_np(py), np.asarray(y), **F32)

    # gradients with respect to x, scale and bias through the folded a/b
    def jfn(x, s, b):
        return jfbn.fused_bn_eval(x, s, b, jnp.asarray(mean), jnp.asarray(var))

    def pfn(x, s, b):
        return pfbn.fused_bn_eval(x, s, b, _t(mean), _t(var))

    want = _jax_grads(jfn, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                      jnp.asarray(w))
    got = _torch_grads(pfn, _t(x), _t(scale), _t(bias), _t(w))
    for g, r, n in zip(got, want, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(g, r, err_msg=n, **GRAD)

    # fused_scale_shift itself: da = sum dy*x, db = sum dy
    a, b = rng.randn(8).astype("f4"), rng.randn(8).astype("f4")
    want = _jax_grads(jfbn.fused_scale_shift, jnp.asarray(x), jnp.asarray(a),
                      jnp.asarray(b), jnp.asarray(w))
    got = _torch_grads(pfbn.fused_scale_shift, _t(x), _t(a), _t(b), _t(w))
    for g, r, n in zip(got, want, ("dx", "da", "db")):
        np.testing.assert_allclose(g, r, err_msg=n, **GRAD)


def test_bf16_apply_rounds_a_and_b_to_the_input_dtype():
    """y = x*a + b in bf16 with a and b rounded to bf16 first: on the same
    inputs the port's bf16 output equals JAX's to bf16 resolution and
    differs from an f32 apply rounded once."""
    rng = np.random.RandomState(4)
    x = rng.randn(64, 32).astype("f4")
    a, b = rng.randn(32).astype("f4"), rng.randn(32).astype("f4")
    want = np.asarray(jfbn.fused_scale_shift(jnp.asarray(x, jnp.bfloat16),
                                             jnp.asarray(a), jnp.asarray(b)),
                      np.float32)
    got = _np(pfbn.fused_scale_shift(_t(x, torch.bfloat16), _t(a), _t(b)))
    np.testing.assert_allclose(got, want, atol=2 ** -7 * np.abs(want).max())
    once = _np((_t(x, torch.bfloat16).float() * _t(a) + _t(b)).bfloat16())
    assert np.abs(got - once).max() > 0

    # fused_bn_train's apply: the folded a = scale * rsqrt(v + eps) and
    # b = bias - m * a (f32) are rounded to bf16 before x*a + b in bf16
    scale, bias = _params(rng, 32)
    xb = _t(x, torch.bfloat16)
    y, m, v = pfbn.fused_bn_train(xb, _t(scale), _t(bias))
    fa = _t(scale) * torch.rsqrt(v + 1e-5)
    fb = _t(bias) - m * fa
    torch.testing.assert_close(y, xb * fa.bfloat16() + fb.bfloat16(),
                               rtol=0, atol=0)
    assert (y.float() - (xb.float() * fa + fb).bfloat16().float()).abs().max() > 0


def test_one_pass_variance_as_the_reference():
    """var = E[x^2] - m^2 from the one-sweep f32 sums (fused_bn.py:224), not
    a centred or Welford variance: the port's var is exactly that formula
    of its own sums, and matches JAX's."""
    rng = np.random.RandomState(5)
    x = (3.0 + rng.randn(2, 16, 16, 4)).astype("f4")
    one = np.ones(4, "f4")
    _, m, v = jfbn.fused_bn_train(jnp.asarray(x), jnp.asarray(one),
                                  jnp.asarray(0 * one))
    _, pm, pv = pfbn.fused_bn_train(_t(x), _t(one), _t(0 * one))
    np.testing.assert_allclose(_np(pm), np.asarray(m), **F32)
    np.testing.assert_allclose(_np(pv), np.asarray(v), **F32)
    s, q = pfbn.bn_stats(_t(x))
    n = float(x.size // 4)
    torch.testing.assert_close(pv, q / n - (s / n) * (s / n), rtol=0, atol=0)


def test_statistics_are_not_differentiable():
    x = torch.randn(2, 3, 3, 4, requires_grad=True)
    y, m, v = pfbn.fused_bn_train(x, torch.ones(4), torch.zeros(4))
    assert y.requires_grad and not m.requires_grad and not v.requires_grad


def test_sync_axis_raises():
    """A sync_axis that is not a mesh axis raises; "dp" outside a mesh (or
    at one rank) is the local statistics, bit for bit, as the reference's
    pmean is a no-op there (tests/test_torch_parallel_dp.py holds it across
    ranks)."""
    x = torch.randn(2, 3, 3, 4)
    with pytest.raises(ValueError, match="not a mesh axis"):
        pfbn.fused_bn_train(x, torch.ones(4), torch.zeros(4), sync_axis="model")
    plain = pfbn.fused_bn_train(x, torch.ones(4), torch.zeros(4))
    synced = pfbn.fused_bn_train(x, torch.ones(4), torch.zeros(4), sync_axis="dp")
    for a, b in zip(plain, synced):
        assert torch.equal(a, b)


def test_non_contiguous_input_raises_rather_than_copies():
    """An NCHW-contiguous activation permuted to NHWC has no [M, C] view."""
    x = torch.randn(2, 4, 3, 3).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="channels_last"):
        pfbn.fused_bn_train(x, torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError, match="channels_last"):
        pfbn.bn_stats(x)
    ok = torch.randn(2, 4, 3, 3).contiguous(memory_format=torch.channels_last)
    pfbn.fused_bn_train(ok.permute(0, 2, 3, 1), torch.ones(4), torch.zeros(4))


def test_cpu_path_counts_no_launch():
    before = dict(_common.launches)
    x = torch.randn(2, 3, 3, 4, requires_grad=True)
    y, _, _ = pfbn.fused_bn_train(x, torch.ones(4), torch.zeros(4))
    (y * 2).sum().backward()
    pfbn.fused_bn_eval(x.detach(), torch.ones(4), torch.zeros(4),
                       torch.zeros(4), torch.ones(4))
    assert _common.launches == before
