"""The port's multi-rank dry run and one-device entry
(``paddle_tpu_torch/tools/dryrun.py``), the counterparts of the JAX
package's root ``__graft_entry__.py`` ``dryrun_multichip`` and ``entry``.

``python -m paddle_tpu_torch.tools.dryrun 8 --device cpu`` runs a gloo
world of 8 processes at dp = pp = tp = 2 and must exit 0 with the
reference's lines: the mesh, then the four blocks' "OK" lines (the BERT
step over dp/pp/tp, ZeRO, the MoE step, the tp_split program with kReduce
and its layouts verified).  ``entry()``'s BERT-base forward loss, from the
reference ``entry()``'s parameters and batch, equals the reference's at
rtol 1e-3 (bf16 compute, the two sides accumulating in other orders).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent

REFERENCE_LINES = [
    "dp/pp/tp/sp train step OK, loss=",
    "zero (dp-sharded opt state) step OK, loss=",
    "ep (MoE all_to_all) step OK, loss=",
    "program-path dp=4 x tp=2 (kReduce) step OK, loss=",
]


def test_dryrun_on_eight_ranks_prints_the_reference_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.dryrun", "8",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=400)
    assert r.returncode == 0, (r.stdout + r.stderr)[-6000:]
    lines = r.stdout.splitlines()
    assert lines[0] == "dryrun mesh: dp=2 pp=2 tp=2", lines
    for prefix in REFERENCE_LINES:
        hit = [ln for ln in lines if ln.startswith(prefix)]
        assert len(hit) == 1, (prefix, lines)
        loss = float(hit[0][len(prefix):].split(";")[0])
        assert np.isfinite(loss)
    assert lines[-1].endswith("tp+kReduce shardings verified"), lines


def test_dryrun_runs_on_the_card_unless_the_cpu_is_named():
    import inspect

    from paddle_tpu_torch.tools import dryrun

    sig = inspect.signature(dryrun.dryrun_multichip)
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(dryrun.entry).parameters["device"].default is None
    seen = []
    real = dryrun.dryrun_multichip
    dryrun.dryrun_multichip = lambda n, device: seen.append((n, device))
    try:
        dryrun.main(["2"])
        dryrun.main(["2", "--device", "cpu"])
    finally:
        dryrun.dryrun_multichip = real
    assert seen == [(2, "cuda"), (2, "cpu")]


def test_entry_loss_matches_the_reference_entry():
    import __graft_entry__ as ref
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.tools import dryrun

    jfn, (jparams, jbatch) = ref.entry()
    want = float(jax.jit(jfn)(jparams, jbatch))
    fn, (params, batch) = dryrun.entry(device="cpu")
    assert sorted(batch) == sorted(jbatch)
    for k in batch:
        assert batch[k].numpy().tobytes() == np.asarray(jbatch[k]).tobytes()
    with torch.no_grad():
        own = float(fn(params, batch))
        got = float(fn(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         "cpu"), batch))
    assert np.isfinite(own)
    np.testing.assert_allclose(got, want, rtol=1e-3)
