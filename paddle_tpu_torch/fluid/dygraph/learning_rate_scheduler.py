"""Dygraph learning-rate decay objects: the port's copy of
``paddle_tpu/fluid/dygraph/learning_rate_scheduler.py`` (reference
``python/paddle/fluid/dygraph/learning_rate_scheduler.py:27-553``).
An optimizer takes one as ``learning_rate=`` in dygraph mode; each
``__call__`` returns the current rate and advances the step counter,
and the eager ``minimize`` calls it once a step. The schedule is host
arithmetic on Python floats; the update ops read the rate as a one-element
tensor.
"""

import math

__all__ = [
    "LearningRateDecay", "PiecewiseDecay", "NaturalExpDecay",
    "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
    "CosineDecay", "NoamDecay",
]


class LearningRateDecay:
    """Base: counts optimizer steps; subclasses define ``step()`` → LR
    for the CURRENT ``step_num`` (reference ``:27``). ``begin`` seeds
    the counter and ``step`` is its per-call increment."""

    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = int(begin)
        self.step_size = int(step)
        self.dtype = dtype

    def __call__(self):
        lr = float(self.step())
        self.step_num += self.step_size
        return lr

    def step(self):
        raise NotImplementedError()

    def __float__(self):
        # a static-graph optimizer folds its LR with float(...); decay
        # OBJECTS are dygraph-only (the static twins live in
        # layers.learning_rate_scheduler) — fail loudly, not silently
        # freezing the first LR into the program
        raise TypeError(
            "%s is a dygraph-mode scheduler; in static graph mode use "
            "fluid.layers.%s instead" % (
                type(self).__name__,
                getattr(self, "_static_twin", "learning_rate_scheduler")))

    # convenience for checkpointing (the reference exposes bare
    # attributes; dict form round-trips through save/load_dygraph)
    def state_dict(self):
        return {"step_num": self.step_num}

    def set_state_dict(self, state):
        self.step_num = int(state["step_num"])


class PiecewiseDecay(LearningRateDecay):
    """``values[i]`` while ``step_num < boundaries[i]``, last value
    afterwards (reference ``:70``)."""

    _static_twin = "piecewise_decay"

    def __init__(self, boundaries, values, begin, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        if len(values) != len(boundaries) + 1:
            raise ValueError(
                "need len(values) == len(boundaries) + 1, got %d and %d"
                % (len(values), len(boundaries)))
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for b, v in zip(self.boundaries, self.values):
            if self.step_num < b:
                return v
        return self.values[-1]


class _RatioDecay(LearningRateDecay):
    """Shared shape of the four ratio schedulers: ``div = step_num /
    decay_steps`` (floored when ``staircase``)."""

    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = float(learning_rate)
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def _div(self):
        d = self.step_num / self.decay_steps
        return float(math.floor(d)) if self.staircase else d


class NaturalExpDecay(_RatioDecay):
    """lr * e^(-decay_rate * div) — reference ``:127``."""

    _static_twin = "natural_exp_decay"

    def step(self):
        return self.learning_rate * math.exp(-self.decay_rate * self._div())


class ExponentialDecay(_RatioDecay):
    """lr * decay_rate^div — reference ``:206``."""

    _static_twin = "exponential_decay"

    def step(self):
        return self.learning_rate * (self.decay_rate ** self._div())


class InverseTimeDecay(_RatioDecay):
    """lr / (1 + decay_rate * div) — reference ``:286``."""

    _static_twin = "inverse_time_decay"

    def step(self):
        return self.learning_rate / (1.0 + self.decay_rate * self._div())


class PolynomialDecay(LearningRateDecay):
    """(lr - end) * (1 - step/decay_steps)^power + end, optionally
    cycling by inflating decay_steps to the enclosing multiple
    (reference ``:360``)."""

    _static_twin = "polynomial_decay"

    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = float(learning_rate)
        self.decay_steps = decay_steps
        self.end_learning_rate = float(end_learning_rate)
        self.power = power
        self.cycle = cycle

    def step(self):
        n, steps = self.step_num, self.decay_steps
        if self.cycle:
            div = math.ceil(n / float(steps))
            if n == 0:
                div = 1.0
            steps = steps * div
        else:
            n = min(n, steps)
        return ((self.learning_rate - self.end_learning_rate)
                * ((1.0 - n / steps) ** self.power)
                + self.end_learning_rate)


class CosineDecay(LearningRateDecay):
    """lr * 0.5 * (cos(epoch * pi / epochs) + 1) with epoch =
    floor(step / step_each_epoch) — reference ``:450``."""

    _static_twin = "cosine_decay"

    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = float(learning_rate)
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        epoch = math.floor(self.step_num / self.step_each_epoch)
        return (self.learning_rate * 0.5
                * (math.cos(epoch * math.pi / self.epochs) + 1.0))


class NoamDecay(LearningRateDecay):
    """d_model^-0.5 * min(step^-0.5, warmup^-1.5 * step) — reference
    ``:506``. ``begin`` defaults to 1 (step 0 would divide by zero)."""

    _static_twin = "noam_decay"

    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 dtype="float32"):
        super().__init__(begin, step, dtype)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        a = self.step_num ** -0.5
        b = (self.warmup_steps ** -1.5) * self.step_num
        return (self.d_model ** -0.5) * min(a, b)
