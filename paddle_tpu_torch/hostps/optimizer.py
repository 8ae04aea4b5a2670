"""Host-side sparse appliers — the Downpour "server-side update".

Counterpart of ``paddle_tpu/hostps/optimizer.py``, a copy (numpy only).

Parity: the reference's PSLib server applies optimizer updates to the rows a
trainer pushed, on the parameter server's CPU (DownpourServer; the public
mirror of the kernels is the SelectedRows branch of each optimizer op,
operators/optimizers/sgd_op.h / adagrad_op.h / adam_op.h sparse paths).
Here the "server" is this process's host RAM (hostps/table.py), so the
appliers are plain numpy, rows-only ("lazy") updates:

- only the pushed rows move; untouched rows and their moments never change
  (the contract tests/test_sparse.py pins for the in-HBM SelectedRows path);
- moment state is per-row (Adam keeps a per-row step so bias correction
  advances only when a row is actually seen — lazy-adam semantics);
- every applier mutates the row buffers IN PLACE: the caller
  (HostSparseTable.push) hands it gathered row copies and writes them back,
  so a multi-GiB table is never duplicated.
"""

import numpy as np

__all__ = ["HostSGD", "HostAdagrad", "HostAdam"]


class HostSGD:
    """Parity: sgd_op.h SelectedRows branch — param -= lr * grad."""

    name = "sgd"

    def slot_shapes(self, dim):
        return {}

    def apply(self, param, grad, slots, lr):
        param -= (lr * grad).astype(param.dtype)


class HostAdagrad:
    """Parity: adagrad_op.h sparse branch — moment += g^2;
    param -= lr * g / (sqrt(moment) + epsilon).  Dense adagrad on a table
    whose untouched rows have zero grad is bit-identical to this lazy form
    (g=0 leaves moment and param alone), which is what the HostPS-vs-in-HBM
    parity test leans on."""

    name = "adagrad"

    def __init__(self, epsilon=1e-6):
        self.epsilon = float(epsilon)

    def slot_shapes(self, dim):
        return {"moment": (dim,)}

    def apply(self, param, grad, slots, lr):
        m = slots["moment"]
        m += grad * grad
        param -= (lr * grad / (np.sqrt(m) + self.epsilon)).astype(param.dtype)


class HostAdam:
    """Parity: adam_op.h sparse ("lazy") branch.  Bias correction uses a
    PER-ROW step count: a row seen for the first time at global step 1000
    gets the step-1 correction, exactly like the reference's lazy-mode adam
    (a fresh row's moments start at zero regardless of wall-clock step)."""

    name = "adam"

    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8):
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)

    def slot_shapes(self, dim):
        return {"m": (dim,), "v": (dim,), "step": ()}

    def apply(self, param, grad, slots, lr):
        b1, b2 = self.beta1, self.beta2
        slots["step"] += 1.0
        t = slots["step"]
        m, v = slots["m"], slots["v"]
        m *= b1
        m += (1 - b1) * grad
        v *= b2
        v += (1 - b2) * grad * grad
        scale = lr * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)   # [N] per row
        param -= (scale[:, None] * m / (np.sqrt(v) + self.epsilon)).astype(
            param.dtype)
