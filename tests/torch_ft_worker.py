"""Subprocess worker for ``tests/test_torch_ft.py``'s real-SIGTERM drill:
a tiny dense ``train_from_dataset`` run of the port under FaultGuard
auto-checkpointing, on the CPU.  Chaos is armed from the
``PADDLE_TPU_CHAOS`` env (``sigterm_step@3`` delivers a real SIGTERM at the
3rd step boundary -> checkpoint-and-exit rc=120).

argv: data_dir ckpt_dir out_dir
"""

import os
import sys

import numpy as np

import paddle_tpu_torch as fluid
from paddle_tpu_torch import ft, monitor

FIELDS, VOCAB, BATCH = 3, 40, 8


def main():
    data_dir, ckpt_dir, out_dir = sys.argv[1:4]
    monitor.enable(out_dir)
    files = sorted(os.path.join(data_dir, n) for n in os.listdir(data_dir))
    main_p, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_p, startup):
        ids = fluid.layers.data("feat_ids", shape=[FIELDS], dtype="int64")
        label = fluid.layers.data("label", shape=[1], dtype="float32")
        ds = fluid.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(BATCH)
        ds.set_filelist(files)
        ds.set_use_var([ids, label])
        emb = fluid.layers.embedding(ids, size=[VOCAB, 4], is_sparse=True)
        pred = fluid.layers.fc(
            fluid.layers.reshape(emb, [-1, FIELDS * 4]), 1)
        loss = fluid.layers.mean(
            fluid.layers.sigmoid_cross_entropy_with_logits(pred, label))
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    policy = ft.CheckpointPolicy(ckpt_dir, every_steps=2,
                                 asynchronous=True, resume=True)
    try:
        exe.train_from_dataset(main_p, ds, checkpoint=policy)
        sc = fluid.global_scope()
        params = {v.name: sc.find_tensor_as_numpy(v.name)
                  for v in main_p.list_vars()
                  if v.persistable and sc.has_var(v.name)}
        np.savez(os.path.join(out_dir, "final_params.npz"), **params)
        print("WORKER FINISHED")
    finally:
        monitor.disable()


if __name__ == "__main__":
    main()
