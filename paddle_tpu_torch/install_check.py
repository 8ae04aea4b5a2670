"""Parity: fluid/install_check.py run_check — a one-call self test that
builds, runs and trains a tiny model through the Executor (counterpart of
``paddle_tpu/install_check.py``)."""

import numpy as np

__all__ = ["run_check"]


def run_check(place=None):
    """Trains a one-layer fc on a fixed batch for one step through
    ``Executor(place)`` (``CUDAPlace(0)`` unless a place is given: without
    a card that raises) and prints the device it ran on and the loss;
    returns the loss."""
    import torch

    from . import layers, optimizer
    from .executor import Executor
    from .framework import CUDAPlace, Program, program_guard

    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = layers.data("install_check_x", shape=[4], dtype="float32")
        y = layers.data("install_check_y", shape=[1], dtype="float32")
        pred = layers.fc(x, 1)
        loss = layers.mean(layers.square_error_cost(pred, y))
        optimizer.SGD(0.01).minimize(loss)
    exe = Executor(CUDAPlace(0) if place is None else place)
    exe.run(startup)
    rng = np.random.RandomState(0)
    (lv,) = exe.run(main,
                    feed={"install_check_x": rng.rand(8, 4).astype("f4"),
                          "install_check_y": rng.rand(8, 1).astype("f4")},
                    fetch_list=[loss])
    assert np.isfinite(float(lv)), lv
    dev = exe.device
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "the CPU")
    print("Your paddle_tpu_torch installation works on %s (%s); "
          "forward/backward/update all ran. loss=%.4f"
          % (name, dev, float(lv)))
    return float(lv)
