"""The port's launcher and fleet bootstrap, end to end on the CPU
(counterpart of tests/test_distributed.py's multi-process loss parity,
``:157``).

``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2`` starts
two workers (``tests/torch_dist_worker.py``) with the PADDLE_* env contract
on a free port; each ``fleet.init(device="cpu")`` joins a gloo world and
trains BERT tiny at dp = 2.  The launcher exits 0; rank 0's per-step losses
are held to the JAX package's one-process run at dp = 2 on the 8-device CPU
mesh (rtol 1e-5, f32 in another summation order) and to the port's
one-process run at one device on the same global batch, within the
reference's own bar, 2e-3 (tests/test_parallel.py:70: Adam hides the dp
gradient scale up to eps).  An elastic retry restarts both workers after
rank 1 fails its first attempt.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel import MeshSpec as JMeshSpec
from paddle_tpu.parallel import optim as joptim
from paddle_tpu_torch.distributed import launch as plaunch
from paddle_tpu_torch.distributed.role_maker import PaddleCloudRoleMaker
from paddle_tpu_torch.models import bert as pbert
from paddle_tpu_torch.parallel import optim as poptim

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).with_name("torch_dist_worker.py")
STEPS = 3


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(tmp, inputs, *extra, worker_args=()):
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for k in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ENDPOINTS", "PADDLE_CURRENT_ENDPOINT"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--started_port", str(_free_port()),
         *extra, str(WORKER), str(inputs), *worker_args],
        capture_output=True, text=True, timeout=240, env=env, cwd=str(tmp))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    rng = np.random.RandomState(7)
    V = jbert.bert_tiny_config().vocab_size
    batch = {"ids": rng.randint(0, V, (8, 32)).astype(np.int32),
             "labels": rng.randint(0, V, (8, 32)).astype(np.int32),
             "mask": (rng.rand(8, 32) < 0.5).astype(np.float32)}
    batch["mask"][:, 0] = 1.0
    jtr = jbert.build_bert_trainer(jbert.bert_tiny_config(), JMeshSpec(dp=2),
                                   optimizer=joptim.adam())
    params = jax.tree.map(np.asarray, jtr.state["params"])
    inputs = tmp / "inputs.pkl"
    with open(inputs, "wb") as f:
        pickle.dump({"params": params, "batch": batch, "steps": STEPS}, f)
    jax_losses = [float(jtr.step(batch, 1e-3)) for _ in range(STEPS)]
    return tmp, inputs, params, batch, jax_losses


def _losses(out):
    return [float(l.split()[1]) for l in out.splitlines() if l.startswith("LOSS")]


@pytest.fixture(scope="module")
def launched(setup):
    tmp, inputs = setup[:2]
    return _launch(tmp, inputs)


def test_launcher_exits_zero(launched):
    assert launched.returncode == 0, (launched.stdout, launched.stderr[-4000:])


def test_workers_see_the_env_contract(launched):
    ranks = sorted(l for l in launched.stdout.splitlines() if l.startswith("RANK"))
    assert ranks == ["RANK 0 OF 2 ATTEMPT 0", "RANK 1 OF 2 ATTEMPT 0"]


def test_two_rank_losses_match_jax_dp2(setup, launched):
    got = _losses(launched.stdout)
    assert len(got) == STEPS, launched.stdout
    np.testing.assert_allclose(got, setup[4], rtol=1e-5, atol=0)


def test_two_rank_losses_match_one_process(setup, launched):
    """The one-process bar of the reference (test_dist_base.py:891-928)."""
    _, _, params, batch, _ = setup
    tr = pbert.build_bert_trainer(pbert.bert_tiny_config(), device="cpu",
                                  optimizer=poptim.adam(), params=params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    ref = [float(tr.step(tb, 1e-3)) for _ in range(STEPS)]
    np.testing.assert_allclose(_losses(launched.stdout), ref, rtol=2e-3,
                               atol=2e-3)


def test_elastic_retry_restarts_the_fleet(setup):
    tmp, inputs = setup[:2]
    r = _launch(tmp, inputs, "--elastic_retries", "1", "--term_grace_secs",
                "5", worker_args=("--crash-once",))
    assert r.returncode == 0, (r.stdout, r.stderr[-4000:])
    assert "elastic restart 1/1" in r.stderr
    assert "RANK 1 OF 2 ATTEMPT 1" in r.stdout
    np.testing.assert_allclose(_losses(r.stdout), setup[4], rtol=1e-5, atol=0)


def test_launcher_parses_the_backend_and_the_reference_options():
    args = plaunch._parse_args(["--nproc_per_node", "2", "--backend", "gloo",
                                "--elastic_retries", "2", "train.py", "--x"])
    assert (args.nproc_per_node, args.backend, args.elastic_retries) == (2, "gloo", 2)
    assert args.training_script == "train.py"
    assert args.training_script_args == ["--x"]
    with pytest.raises(SystemExit):
        plaunch._parse_args(["--backend", "mpi", "train.py"])


def test_role_maker_reads_the_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2,c:3,d:4")
    rm = PaddleCloudRoleMaker()
    rm.generate_role()
    assert (rm.worker_index(), rm.worker_num()) == (1, 4)
    assert not rm.is_first_worker()
    assert rm.get_trainer_endpoints() == ["a:1", "b:2", "c:3", "d:4"]
