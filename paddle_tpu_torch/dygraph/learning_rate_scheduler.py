"""Dygraph LR schedulers (parity: dygraph/learning_rate_scheduler.py —
NoamDecay, PiecewiseDecay, NaturalExpDecay, ExponentialDecay, InverseTimeDecay,
PolynomialDecay, CosineDecay).

A copy of the JAX package's ``dygraph/learning_rate_scheduler.py``,
which imports no JAX."""

import math

__all__ = ["LearningRateDecay", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay", "CosineDecay"]


class LearningRateDecay:
    def __init__(self, begin=0, step=1):
        self.step_num = begin
        self.step_size = step

    def __call__(self):
        lr = self.step()
        self.step_num += self.step_size
        return lr

    def step(self):
        raise NotImplementedError


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1):
        super().__init__(begin, step)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        a = self.step_num ** -0.5
        b = self.step_num * (self.warmup_steps ** -1.5)
        return (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1):
        super().__init__(begin, step)
        self.boundaries = boundaries
        self.values = values

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.values[i]
        return self.values[-1]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate, staircase=False,
                 begin=0, step=1):
        super().__init__(begin, step)
        self.lr, self.decay_steps, self.decay_rate, self.staircase = (
            learning_rate, decay_steps, decay_rate, staircase)

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.lr * math.exp(-self.decay_rate * div)


class ExponentialDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.lr * (self.decay_rate ** div)


class InverseTimeDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.lr / (1 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.decay_steps = decay_steps
        self.end_lr = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        t = min(self.step_num, self.decay_steps)
        frac = 1 - t / self.decay_steps
        return (self.lr - self.end_lr) * (frac ** self.power) + self.end_lr


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0, step=1):
        super().__init__(begin, step)
        self.lr = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        epoch = self.step_num // self.step_each_epoch
        return 0.5 * self.lr * (1 + math.cos(math.pi * epoch / self.epochs))
