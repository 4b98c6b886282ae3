"""Unique name generation for IR variables and parameters.

A copy of ``paddle_tpu/fluid/unique_name.py`` (which is jax-free): a
per-prefix counter with nestable guards, so that two programs built
inside fresh guards get identical names.
"""

import contextlib
import threading


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.prefix = prefix
        self.ids = {}

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        else:
            self.ids[key] += 1
        return "%s%s_%d" % (self.prefix, key, self.ids[key])


_local = threading.local()


def _generator():
    if not hasattr(_local, "generator"):
        _local.generator = UniqueNameGenerator()
    return _local.generator


def generate(key):
    return _generator()(key)


def switch(new_generator=None):
    old = _generator()
    _local.generator = new_generator or UniqueNameGenerator()
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
