"""MNIST LeNet — program-mode model (BASELINE.json config 1).

Parity: the reference book test python/paddle/fluid/tests/book/
test_recognize_digits.py:65 (`conv_pool` LeNet: two conv+pool layers then
softmax FC) built with the fluid-style layers API, runnable on CPUPlace or
CUDAPlace through the Program/Executor path.  A copy of the JAX package's
``models/lenet.py`` on the port's ``fluid``.
"""

import paddle_tpu_torch as fluid

__all__ = ["build_lenet", "build_mlp"]


def build_lenet(img, label):
    """Returns (prediction, avg_loss, acc).  Parity:
    test_recognize_digits.py convolutional_neural_network()."""
    conv1 = fluid.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2, pool_stride=2,
        act="relu")
    conv2 = fluid.nets.simple_img_conv_pool(
        input=conv1, filter_size=5, num_filters=50, pool_size=2, pool_stride=2,
        act="relu")
    prediction = fluid.layers.fc(input=conv2, size=10, act="softmax")
    loss = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_loss = fluid.layers.mean(loss)
    acc = fluid.layers.accuracy(input=prediction, label=label)
    return prediction, avg_loss, acc


def build_mlp(img, label):
    """Parity: test_recognize_digits.py multilayer_perceptron()."""
    hidden = fluid.layers.fc(input=img, size=200, act="tanh")
    hidden = fluid.layers.fc(input=hidden, size=200, act="tanh")
    prediction = fluid.layers.fc(input=hidden, size=10, act="softmax")
    loss = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_loss = fluid.layers.mean(loss)
    acc = fluid.layers.accuracy(input=prediction, label=label)
    return prediction, avg_loss, acc
