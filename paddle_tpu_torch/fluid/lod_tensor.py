"""LoDTensor construction helpers (the port's copy of
``paddle_tpu/fluid/lod_tensor.py``). The LoDTensor itself is in
``fluid/lod.py``; this module keeps the reference's module path and its
random-int builder for vocabulary-id sequences."""

import numpy as np

from .lod import LoDTensor, create_lod_tensor  # noqa: F401

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1):
    """LoDTensor of random ints in [low, high] (numpy's global
    generator) with the given length-based LoD: first dim the sum of the
    innermost lengths, then ``base_shape``."""
    total = int(np.sum(recursive_seq_lens[-1]))
    shape = [total] + list(base_shape)
    data = np.random.randint(low, high + 1, shape).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
