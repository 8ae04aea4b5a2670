"""Op rules of ROADMAP Queue 1 item 3-B that the port has, each against the
JAX package's rule through ``registry.get_lowering`` on the CPU, with
``tests/test_torch_fluid_ops.py``'s harness: the forward to 1e-6 and the
gradients of a seeded cotangent to 1e-5 of the largest magnitude (f32).

``sigmoid_cross_entropy_with_logits`` came with the data path: the CTR
program's loss (``tools/ctr_program.py``).  Its labels hold soft targets
in [0, 1] and, where ``ignore_index`` is exercised, that index, whose
elements give 0 (and no gradient); ``normalize`` divides by the count of
the other labels.
"""

import numpy as np
import pytest

from test_torch_fluid_ops import _randn, _run


@pytest.mark.parametrize("ignore_index", [-100, -1])
@pytest.mark.parametrize("normalize", [False, True])
def test_sigmoid_cross_entropy_with_logits(normalize, ignore_index):
    x = _randn(70, 6, 5) * 4
    x[0, :2] = [60.0, -60.0]          # saturated logits stay finite
    label = np.random.RandomState(71).rand(6, 5).astype(np.float32)
    label[1, ::2] = ignore_index
    attrs = {"normalize": normalize}
    if ignore_index != -100:
        attrs["ignore_index"] = ignore_index
    jouts, _ = _run("sigmoid_cross_entropy_with_logits",
                    {"X": [x], "Label": [label]}, attrs, ["X"], "Out")
    out = np.asarray(jouts["Out"][0])
    if ignore_index == -1:
        assert (out[1, ::2] == 0).all()
