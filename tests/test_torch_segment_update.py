"""The port's segment sum (CPU path: the kernel's plain version) and
``sparse.merge_rows`` against the JAX package's Pallas ``dedup_segment_sum``
in interpret mode and its XLA ``merge_rows``, on the same numpy inputs.
Row ids must agree exactly (both sort stably); values to 1e-5 (f32 sums in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import sparse as jsparse
from paddle_tpu.kernels import segment_update as jseg
from paddle_tpu_torch import sparse as psparse
from paddle_tpu_torch.kernels import _common
from paddle_tpu_torch.kernels import segment_update as pseg

CASES = [
    (1000, 100, 5, 256),        # duplicate-heavy
    (1000, 100000, 5, 256),     # almost no duplicates
    (777, 50, 3, 256),          # N no block divides
    (256, 1, 4, 256),           # one id repeated N times
    (1024, 32, 8, 64),          # runs across many blocks
    (1, 10, 2, 256),            # a single element
]


def _data(n, vocab, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, n).astype(np.int32),
            rng.randn(n, d).astype(np.float32))


def _assert_same(port, ref):
    (pr, pv), (jr, jv) = port, ref
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(pv.float().numpy(),
                               np.asarray(jv, np.float32), atol=1e-5)


@pytest.mark.parametrize("n,vocab,d,block", CASES)
def test_dedup_segment_sum_matches_jax(n, vocab, d, block):
    ids, vals = _data(n, vocab, d, n + vocab)
    ref = jseg.dedup_segment_sum(jnp.asarray(ids), jnp.asarray(vals), vocab,
                                 block=block, interpret=True)
    before = dict(_common.launches)
    got = pseg.dedup_segment_sum(torch.from_numpy(ids), torch.from_numpy(vals),
                                 vocab)
    assert _common.launches == before          # CPU tensors: no kernel
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    _assert_same(got, ref)


def test_out_of_range_ids_keep_their_id_and_drop_on_apply():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, 500).astype(np.int32)
    ids[rng.choice(500, 20, replace=False)] = 64 + rng.randint(0, 9, 20)
    vals = rng.randn(500, 6).astype(np.float32)
    table = rng.randn(64, 6).astype(np.float32)
    _assert_same(pseg.dedup_segment_sum(torch.from_numpy(ids),
                                        torch.from_numpy(vals), 64),
                 jseg.dedup_segment_sum(jnp.asarray(ids), jnp.asarray(vals),
                                        64, interpret=True))
    ref = jseg.apply_rows_update(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(vals), 1.0, interpret=True)
    got = pseg.apply_rows_update(torch.from_numpy(table.copy()),
                                 torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_apply_rows_update_with_a_scale_matches_jax():
    ids, vals = _data(200, 32, 4, 1)
    table = np.random.RandomState(2).randn(32, 4).astype(np.float32)
    ref = jseg.apply_rows_update(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(vals), -0.1, interpret=True)
    got = pseg.apply_rows_update(torch.from_numpy(table.copy()),
                                 torch.from_numpy(ids), torch.from_numpy(vals),
                                 -0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_bf16_values_sum_in_f32():
    ids, vals = _data(600, 20, 3, 3)
    vb = jnp.asarray(vals, jnp.bfloat16)
    jr, jv = jseg.dedup_segment_sum(jnp.asarray(ids), vb, 20, interpret=True)
    pr, pv = pseg.dedup_segment_sum(
        torch.from_numpy(ids),
        torch.from_numpy(np.array(vb.astype(jnp.float32))).bfloat16(), 20)
    assert pv.dtype == torch.bfloat16
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(pv.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))


def test_int64_rows_and_trailing_dims():
    ids, vals = _data(300, 40, 6, 4)
    vals = vals.reshape(300, 2, 3)
    jr, jv = jseg.dedup_segment_sum(jnp.asarray(ids), jnp.asarray(vals), 40,
                                    interpret=True)
    pr, pv = pseg.dedup_segment_sum(torch.from_numpy(ids.astype(np.int64)),
                                    torch.from_numpy(vals), 40)
    assert pr.dtype == torch.int64 and pv.shape == (300, 2, 3)
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("via", ["xla", "kernel"])
def test_merge_rows_matches_jax(via):
    ids, vals = _data(100, 16, 3, 5)
    _assert_same(psparse.merge_rows(torch.from_numpy(ids),
                                    torch.from_numpy(vals), 16, via=via),
                 jsparse.merge_rows(jnp.asarray(ids), jnp.asarray(vals), 16,
                                    via=via))


def test_merge_rows_routing_and_env_flip(monkeypatch):
    ids, vals = _data(100, 16, 3, 6)
    t_ids, t_vals = torch.from_numpy(ids), torch.from_numpy(vals)
    with pytest.raises(ValueError, match="via"):
        psparse.merge_rows(t_ids, t_vals, 16, via="nope")
    monkeypatch.delenv("PADDLE_TPU_SEGMENT_KERNEL", raising=False)
    _assert_same(psparse.merge_rows(t_ids, t_vals, 16),
                 jsparse.merge_rows(jnp.asarray(ids), jnp.asarray(vals), 16))
    monkeypatch.setenv("PADDLE_TPU_SEGMENT_KERNEL", "1")
    got = psparse.merge_rows(t_ids, t_vals, 16)
    _assert_same(got, jsparse.merge_rows(jnp.asarray(ids), jnp.asarray(vals),
                                         16))
    _assert_same(got, jseg.dedup_segment_sum(jnp.asarray(ids),
                                             jnp.asarray(vals), 16,
                                             interpret=True))
    sr = psparse.SelectedRows(t_ids, t_vals, 16)
    torch.testing.assert_close(sr.merged()[1], got[1])


def test_scatter_rows_drop_matches_jax_drop_mode():
    """Drop mode without a host sync (dropped slots add zeros); a
    negative id counts from the end, as JAX indexing normalises it."""
    rows = np.array([1, 4, -1, 1, 3, -5, 0], np.int32)
    vals = np.arange(14, dtype=np.float32).reshape(7, 2)
    ref = jnp.zeros((4, 2)).at[jnp.asarray(rows)].add(jnp.asarray(vals),
                                                       mode="drop")
    got = pseg.scatter_rows_drop(torch.zeros(4, 2), torch.from_numpy(rows),
                                 torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
