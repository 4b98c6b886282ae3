"""DataFeeder: python / numpy minibatch data as a feed dict (the port's
copy of ``paddle_tpu/fluid/data_feeder.py``)."""

import numpy as np

from .framework import Variable

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_names = [
            v.name if isinstance(v, Variable) else v for v in feed_list
        ]
        self.feed_vars = [v for v in feed_list if isinstance(v, Variable)]

    def feed(self, iterable):
        """``iterable``: samples, each a tuple aligned with ``feed_list``;
        each column is stacked along a new dim 0 and shaped and cast as
        its var declares (a declared trailing dim of 1 is added)."""
        columns = [[] for _ in self.feed_names]
        for sample in iterable:
            for i, item in enumerate(sample):
                columns[i].append(np.asarray(item))
        out = {}
        for name, var, col in zip(self.feed_names, self.feed_vars, columns):
            arr = np.stack(col)
            want = var.shape
            if want and len(want) == arr.ndim + 1 and want[-1] == 1:
                arr = arr[..., None]
            if want and len(want) == arr.ndim and all(
                w > 0 for w in want[1:]
            ):
                try:
                    arr = arr.reshape((arr.shape[0],) + tuple(want[1:]))
                except ValueError:
                    pass
            out[name] = arr.astype(var.dtype)
        return out
