"""The port's conv2d (CPU path: the wgrad kernel's plain version behind the
same autograd op) against the JAX package's conv2d and its custom VJP with
the Pallas wgrad kernel in interpret mode, on the same numpy inputs.
Tolerances are the reference's own (conv.py, tests/test_conv_kernel.py):
forward 1e-5, dx 2e-4, dw rtol 2e-4 / atol 2e-3; bf16 to 2e-2 of the
largest value (a few roundings of 2^-9)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import conv as jconv
from paddle_tpu_torch.kernels import _common
from paddle_tpu_torch.kernels import conv as pconv


def _inputs(B, H, W, C, K, k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype("f4")
    w = (rng.randn(k, k, C, K) * 0.1).astype("f4")
    dy = rng.randn(B, H, W, K).astype("f4")
    return x, w, dy


def _port(x, w, dy, stride, pad, dtype=torch.float32):
    xt, wt = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (x, w))
    y = pconv.conv2d(xt, wt, stride, pad)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy).to(dtype))
    return [t.detach().float().numpy() for t in (y, dx, dw)]


@pytest.mark.parametrize("shape", [
    (2, 8, 8, 32, 48, 3, "SAME"),
    (2, 5, 7, 32, 32, 3, "SAME"),
    (1, 9, 9, 32, 32, 5, "SAME"),
    (2, 8, 8, 32, 32, 4, ((2, 1), (2, 1))),
    (2, 8, 8, 32, 32, 4, ((1, 2), (1, 2))),
])
def test_conv2d_fwd_dx_dw_match_jax(shape):
    B, H, W, C, K, k, pad = shape
    x, w, dy = _inputs(B, H, W, C, K, k)
    y_ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), 1, pad)
    dx_ref, dw_ref = jconv._bwd(1, pad, (jnp.asarray(x), jnp.asarray(w)),
                                jnp.asarray(dy))
    before = dict(_common.launches)
    y, dx, dw = _port(x, w, dy, 1, pad)
    assert _common.launches == before          # CPU tensors: no kernel
    np.testing.assert_allclose(y, np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, np.asarray(dx_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dw, np.asarray(dw_ref), rtol=2e-4, atol=2e-3)


def test_wgrad_plain_matches_jax_pallas_kernel():
    """The kernel's plain version against the Pallas kernel itself."""
    x, _, dy = _inputs(2, 6, 5, 32, 40, 3, seed=1)
    ref = jconv._wgrad_pallas(jnp.asarray(x), jnp.asarray(dy), 3,
                              interpret=True, pads=(1, 1))
    got = pconv.conv_wgrad(torch.from_numpy(x), torch.from_numpy(dy), 3, 1)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 32, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-3)


def test_ineligible_stride2_1x1_takes_autograd_of_the_plain_conv():
    x, w, dy = _inputs(2, 8, 8, 16, 8, 1, seed=2)
    dy = dy[:, ::2, ::2, :].copy()
    assert pconv._eligible_pads(torch.from_numpy(w), 2, "SAME") is None
    y_ref = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), 2, "SAME")
    dx_ref, dw_ref = jconv._bwd(2, "SAME", (jnp.asarray(x), jnp.asarray(w)),
                                jnp.asarray(dy))
    y, dx, dw = _port(x, w, dy, 2, "SAME")
    np.testing.assert_allclose(y, np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, np.asarray(dx_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw, np.asarray(dw_ref), rtol=1e-5, atol=1e-5)


def test_conv2d_bf16_matches_jax():
    x, w, dy = _inputs(2, 8, 8, 32, 32, 3, seed=3)
    xb, wb, dyb = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, dy))
    y_ref = jconv.conv2d(xb, wb, 1, "SAME")
    dx_ref, dw_ref = jconv._bwd(1, "SAME", (xb, wb), dyb)
    # the same bf16 values on both sides
    y, dx, dw = _port(*(np.array(a.astype(jnp.float32)) for a in (xb, wb, dyb)),
                      1, "SAME", dtype=torch.bfloat16)
    for got, want in ((y, y_ref), (dx, dx_ref), (dw, dw_ref)):
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("padding,k,H", [
    ("SAME", 3, 8), ("SAME", 1, 7), ("VALID", 3, 9), ("SAME", 3, 7)])
@pytest.mark.parametrize("stride", [1, 2])
def test_forward_pads_as_lax_conv(padding, k, H, stride):
    x, w, _ = _inputs(1, H, H, 4, 5, k, seed=4)
    ref = jconv._plain(jnp.asarray(x), jnp.asarray(w), stride, padding)
    got = pconv._plain(torch.from_numpy(x), torch.from_numpy(w), stride,
                       padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_eligibility_matches_the_reference():
    cases = [((3, 3, 32, 8), 1, "SAME"), ((3, 3, 16, 8), 1, "SAME"),
             ((4, 4, 32, 8), 1, "SAME"), ((1, 1, 64, 8), 1, "SAME"),
             ((3, 3, 32, 8), 2, "SAME"), ((4, 4, 32, 8), 1, ((2, 1), (2, 1))),
             ((4, 4, 32, 8), 1, ((2, 1), (1, 2))), ((3, 3, 32, 8), 1, "VALID")]
    for shape, stride, pad in cases:
        w = np.zeros(shape, np.float32)
        assert (pconv._eligible_pads(torch.from_numpy(w), stride, pad)
                == jconv._eligible_pads(w, stride, pad)), (shape, stride, pad)


@pytest.mark.parametrize("dtype,C,K,route", [
    (torch.bfloat16, 64, 64, "mma"),      # ResNet-50's 3x3 at 56 x 56
    (torch.bfloat16, 512, 512, "mma"),    # and at 7 x 7
    (torch.bfloat16, 72, 136, "mma"),     # multiples of 8, ragged tiles
    (torch.bfloat16, 36, 64, "fma"),      # C % 8: no 16-byte copies
    (torch.bfloat16, 64, 44, "fma"),      # K % 8
    (torch.float32, 64, 64, "fma"),       # f32 would be TF32 on tensor cores
])
def test_wgrad_route(dtype, C, K, route):
    assert pconv._wgrad_route(dtype, C, K) == route


@pytest.mark.parametrize("tiles,M,slots,splits", [
    (9, 128 * 56 * 56, 660, 73),     # 56 x 56: fill one wave, no more
    (576, 128 * 7 * 7, 660, 1),      # 7 x 7: the tiles alone fill it
    (576, 128 * 7 * 7, 528, 1),      # more tiles than slots: no split
    (9, 1000, 660, 2),               # at least 8 staging steps a block
])
def test_wgrad_splits_fill_one_wave(tiles, M, slots, splits):
    got = pconv._splits(tiles, M, slots)
    assert got == splits
    assert got == 1 or tiles * got <= slots
