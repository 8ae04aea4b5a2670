"""A worker of ``python -m paddle_tpu_torch.distributed.launch`` for
tests/test_torch_launch.py (the port's counterpart of dist_worker_lr.py).

``fleet.init(device="cpu")`` joins the gloo world the launcher's PADDLE_*
env describes; every rank trains BERT tiny at dp = world size (Adam, from
the parameters and global batch the test wrote, ``sys.argv[1]``), and rank 0
prints ``LOSS <value>`` a step.  With ``--crash-once``, rank 1 exits 3 on
the launcher's first attempt, before it joins, to drive an elastic restart.
"""

import os
import pickle
import sys

import torch

from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.parallel import MeshSpec, optim


def main(argv):
    torch.set_num_threads(1)
    if "--crash-once" in argv and os.environ["PADDLE_RESTART_ATTEMPT"] == "0" \
            and os.environ["PADDLE_TRAINER_ID"] == "1":
        sys.exit(3)
    f = fleet.init(device="cpu")
    sys.stdout.write("RANK %d OF %d ATTEMPT %s\n" % (
        f.worker_index(), f.worker_num(), os.environ["PADDLE_RESTART_ATTEMPT"]))
    with open(argv[0], "rb") as fh:
        inp = pickle.load(fh)
    trainer = bert.build_bert_trainer(
        bert.bert_tiny_config(), MeshSpec(dp=f.worker_num()),
        optimizer=optim.adam(), device="cpu", params=inp["params"])
    batch = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    for _ in range(inp["steps"]):
        loss = float(trainer.step(batch, 1e-3))
        if f.worker_index() == 0:
            sys.stdout.write("LOSS %.8f\n" % loss)
            sys.stdout.flush()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
