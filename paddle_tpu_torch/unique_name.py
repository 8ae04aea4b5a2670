"""Unique name generator (parity: python/paddle/fluid/unique_name.py).  A copy
of the JAX package's ``unique_name.py``."""

import contextlib

__all__ = ["generate", "switch", "guard"]


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.ids = {}
        self.prefix = prefix

    def __call__(self, key):
        tmp = self.ids.setdefault(key, 0)
        self.ids[key] = tmp + 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
