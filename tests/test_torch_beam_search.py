"""The port's beam-search ops against the JAX package on the CPU, exactly:
``beam_search_step`` on scores full of planted ties (small integers, and
frozen beams whose non-EOS candidates all score ``pre_score - 1e9``, where
one f32 ulp is 64), in both ``accumulated`` modes, with and without
finished beams; and ``beam_backtrack``.  ``lax.top_k`` gives equal scores
in the order of their flat index, lowest first; the port must pick the
same beams, tokens and parents."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import beam_search_ops as jbs
from paddle_tpu_torch.ops import beam_search_ops as pbs


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The port's side runs thousands of tiny ops.  With a team of intra-op
    threads per process, test processes running side by side wait on each
    other's spinning threads: four processes of the copy-task recipe took
    150 s each with 8 threads and 1 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tied_inputs(seed, B=3, K=4, V=7, frozen=True):
    rng = np.random.RandomState(seed)
    # few distinct values: ties everywhere, inside a beam and across beams
    scores = -rng.randint(0, 3, (B, K, V)).astype(np.float32)
    pre = -rng.randint(0, 2, (B, K)).astype(np.float32)
    pre[0, 1:] = -1e9                     # dead beams, as at step 0
    pre[1, 2] = pre[1, 3] = -2.5          # equal pre_scores
    finished = None
    if frozen:
        finished = np.zeros((B, K), bool)
        finished[1, :3] = True            # most of a sentence's beams frozen
        finished[2, 0] = True
        finished[0, 2] = True             # frozen and dead
    return pre, scores, finished


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("accumulated", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_beam_search_step_matches_jax_with_ties(seed, accumulated, frozen):
    pre, scores, finished = _tied_inputs(seed, frozen=frozen)
    K, end_id = pre.shape[1], 1
    want = jbs.beam_search_step(
        jnp.asarray(pre), jnp.asarray(scores), K, end_id,
        None if finished is None else jnp.asarray(finished), accumulated)
    got = pbs.beam_search_step(
        torch.from_numpy(pre), torch.from_numpy(scores), K, end_id,
        None if finished is None else torch.from_numpy(finished), accumulated)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_frozen_candidates_collapse_and_keep_index_order():
    """Every beam frozen: the top K are each beam's EOS (at its pre_score),
    then the -1e9 candidates.  ``pre_score - 1e9`` rounds to -1e9 for both
    beams, so they tie across beams too, and go in flat-index order:
    tokens 0, 2, ... of beam 0 before any of beam 1."""
    B, K, V, end_id = 1, 2, 6, 1
    pre = np.array([[-0.75, -0.5]], np.float32)
    scores = np.log(np.full((B, K, V), 1.0 / V, np.float32))
    finished = np.ones((B, K), bool)
    for k in (K, 4):
        want = jbs.beam_search_step(jnp.asarray(pre), jnp.asarray(scores), k,
                                    end_id, jnp.asarray(finished))
        got = pbs.beam_search_step(torch.from_numpy(pre), torch.from_numpy(scores),
                                   k, end_id, torch.from_numpy(finished))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    sel, tok, parent = got
    assert sel[0, 2] == sel[0, 3] == np.float32(-1e9)
    np.testing.assert_array_equal(tok.numpy(), [[1, 1, 0, 2]])
    np.testing.assert_array_equal(parent.numpy(), [[1, 0, 0, 0]])


@pytest.mark.parametrize("T,B,K", [(1, 2, 3), (6, 3, 4)])
def test_beam_backtrack_matches_jax(T, B, K):
    rng = np.random.RandomState(T)
    toks = rng.randint(0, 50, (T, B, K)).astype(np.int32)
    parents = rng.randint(0, K, (T, B, K)).astype(np.int32)
    want = np.asarray(jbs.beam_backtrack(jnp.asarray(toks), jnp.asarray(parents)))
    got = pbs.beam_backtrack(torch.from_numpy(toks), torch.from_numpy(parents))
    assert got.shape == (B, K, T) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
