"""The port's flash attention (CPU path: the kernels' plain versions behind
the same autograd op) against the JAX package's Pallas kernels in interpret
mode, on the same numpy inputs: both entries ([B,S,H,D] and packed
[B,S,H*D]), causal and not, the single-kv-block backward (S == block) and
the two-sweep one (S > block).  Tolerances are the reference's own
(tests/test_flash_attention.py): forward atol 2e-6 / rtol 1e-5, gradients
atol 5e-5 / rtol 1e-4, all f32.  The CUDA kernels themselves are held to
these plain versions on the card by chip_smoke.py and
tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import (
    flash_attention as jax_flash, flash_attention_packed as jax_flash_packed)
from paddle_tpu_torch.kernels import flash_attention as pfa

FWD_TOL = dict(atol=2e-6, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)


def _qkvw(seed, B, S, H, D, Sk=None):
    rng = np.random.RandomState(seed)
    Sk = S if Sk is None else Sk
    mk = lambda s: (rng.randn(B, s, H, D) * 0.5).astype(np.float32)
    return mk(S), mk(Sk), mk(Sk), rng.randn(B, S, H, D).astype(np.float32)


def _torch_side(entry, q, k, v, w, causal):
    B, S, H, D = q.shape
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if entry == "packed":
        flat = [t.reshape(t.shape[0], t.shape[1], H * D) for t in ts]
        o = pfa.flash_attention_packed(*flat, H, causal=causal).reshape(q.shape)
    else:
        o = pfa.flash_attention(*ts, causal=causal)
    (o * torch.from_numpy(w)).sum().backward()
    return o.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_side(entry, q, k, v, w, causal, bq, bk):
    B, S, H, D = q.shape

    def fn(a, b, c):
        if entry == "packed":
            flat = [t.reshape(t.shape[0], t.shape[1], H * D) for t in (a, b, c)]
            return jax_flash_packed(
                *flat, H, causal=causal, block_q=bq, block_k=bk).reshape(a.shape)
        return jax_flash(a, b, c, causal=causal, block_q=bq, block_k=bk)

    args = [jnp.asarray(t) for t in (q, k, v)]
    o = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * jnp.asarray(w)),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("entry", ["bshd", "packed"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,bq,bk", [(256, 256, 256),   # single-kv-block bwd
                                     (256, 128, 128)])  # two-sweep bwd
def test_matches_jax(entry, causal, S, bq, bk):
    q, k, v, w = _qkvw(0, B=2, S=S, H=4, D=64)
    o, grads = _torch_side(entry, q, k, v, w, causal)
    o_ref, grads_ref = _jax_side(entry, q, k, v, w, causal, bq, bk)
    np.testing.assert_allclose(o, o_ref, **FWD_TOL)
    for g, gr, n in zip(grads, grads_ref, "qkv"):
        np.testing.assert_allclose(g, gr, err_msg="d%s" % n, **GRAD_TOL)


def test_uneven_q_and_kv_lengths():
    q, k, v, w = _qkvw(3, B=1, S=128, H=2, D=64, Sk=256)
    o, grads = _torch_side("bshd", q, k, v, w, False)
    o_ref, grads_ref = _jax_side("bshd", q, k, v, w, False, 128, 128)
    np.testing.assert_allclose(o, o_ref, **FWD_TOL)
    for g, gr in zip(grads, grads_ref):
        np.testing.assert_allclose(g, gr, **GRAD_TOL)


def test_bf16_rounds_p_like_the_reference():
    """p is rounded to v.dtype before p.v: bf16 outputs agree with the
    reference kernel to bf16 resolution."""
    q, k, v, _ = _qkvw(5, B=1, S=128, H=2, D=64)
    want = np.asarray(jax_flash(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)),
        block_q=128, block_k=128), dtype=np.float32)
    got = pfa.flash_attention(*(torch.from_numpy(t).bfloat16()
                                for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)



@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_forward_route(dtype, route):
    """bf16 takes the tensor-core forward; f32 the FMA one (on the tensor
    cores f32 would be TF32, another result)."""
    assert pfa._fwd_route(dtype) == route


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "fma")])
def test_backward_route(dtype, route):
    """bf16 takes the tensor-core dk/dv and dq kernels; f32 the FMA ones."""
    assert pfa._bwd_route(dtype) == route
