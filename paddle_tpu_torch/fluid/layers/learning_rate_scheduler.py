"""Learning-rate schedules computed in the program (counterpart of
``paddle_tpu/fluid/layers/learning_rate_scheduler.py``): each returns a
Variable computed from the persistable int64 step counter
``@LR_STEP@``, which one ``increment`` op advances in place each run
(0 at the first run), so on the card the schedule runs inside the
step's CUDA graph and each replay reads the advanced counter. Pass the
result as an optimizer's ``learning_rate``."""

import math

from . import nn, ops, tensor
from .nn import autoincreased_step_counter

__all__ = [
    "exponential_decay", "natural_exp_decay", "inverse_time_decay",
    "polynomial_decay", "piecewise_decay", "noam_decay", "cosine_decay",
    "linear_lr_warmup",
]


def _step_counter():
    counter = autoincreased_step_counter(counter_name="@LR_STEP@", begin=0,
                                         step=1)
    return tensor.cast(counter, "float32")


def noam_decay(d_model, warmup_steps):
    """d_model^-0.5 min(step^-0.5, step warmup^-1.5)."""
    step = _step_counter()
    a = step ** -0.5
    b = step * (warmup_steps ** -1.5)
    return (d_model ** -0.5) * nn.elementwise_min(a, b)


def _decay_steps(step, decay_steps, staircase):
    div = step / float(decay_steps)
    return ops.floor(div) if staircase else div


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr decay_rate^(step / decay_steps), floored when ``staircase``."""
    div = _decay_steps(_step_counter(), decay_steps, staircase)
    return nn.scale(nn.elementwise_pow(
        tensor.fill_constant([1], "float32", decay_rate), div),
        scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr exp(-decay_rate step / decay_steps)."""
    div = _decay_steps(_step_counter(), decay_steps, staircase)
    return nn.scale(ops.exp(nn.scale(div, scale=-float(decay_rate))),
                    scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate step / decay_steps)."""
    div = _decay_steps(_step_counter(), decay_steps, staircase)
    denom = nn.scale(div, scale=float(decay_rate), bias=1.0)
    return nn.elementwise_div(
        tensor.fill_constant([1], "float32", float(learning_rate)), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) (1 - step / decay_steps)^power + end, the step held at
    decay_steps, or with ``cycle`` the decay steps stretched to the next
    multiple past the step."""
    step = _step_counter()
    if cycle:
        div = nn.elementwise_max(
            tensor.fill_constant([1], "float32", 1.0),
            ops.ceil(step / float(decay_steps)))
        frac = nn.elementwise_div(step,
                                  nn.scale(div, scale=float(decay_steps)))
    else:
        step = nn.elementwise_min(
            step, tensor.fill_constant([1], "float32", float(decay_steps)))
        frac = nn.scale(step, scale=1.0 / decay_steps)
    one_minus = nn.scale(frac, scale=-1.0, bias=1.0)
    poly = nn.elementwise_pow(one_minus,
                              tensor.fill_constant([1], "float32", power))
    return nn.scale(poly, scale=float(learning_rate) - end_learning_rate,
                    bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] while step < boundaries[i], values[-1] after the last:
    a select chain from the last boundary back."""
    step = _step_counter()
    lr = tensor.fill_constant([1], "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        condf = tensor.cast(step < float(b), "float32")
        lr = nn.elementwise_add(
            nn.elementwise_mul(condf,
                               tensor.fill_constant([1], "float32", v)),
            nn.elementwise_mul(nn.scale(condf, scale=-1.0, bias=1.0), lr))
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    """lr (cos(pi epoch / epochs) + 1) / 2, epoch = floor(step /
    step_each_epoch)."""
    step = _step_counter()
    epoch = ops.floor(nn.scale(step, scale=1.0 / step_each_epoch))
    cos_arg = nn.scale(epoch, scale=math.pi / epochs)
    return nn.scale(nn.scale(ops.cos(cos_arg), bias=1.0),
                    scale=0.5 * float(learning_rate))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """start_lr to end_lr linearly over ``warmup_steps``, then
    ``learning_rate`` (a float or a schedule's Variable)."""
    step = _step_counter()
    if not isinstance(learning_rate, float):
        lr_after = learning_rate
    else:
        lr_after = tensor.fill_constant([1], "float32", learning_rate)
    frac = nn.scale(step, scale=1.0 / warmup_steps)
    warm = nn.scale(frac, scale=float(end_lr - start_lr),
                    bias=float(start_lr))
    condf = tensor.cast(step < float(warmup_steps), "float32")
    return nn.elementwise_add(
        nn.elementwise_mul(condf, warm),
        nn.elementwise_mul(nn.scale(condf, scale=-1.0, bias=1.0), lr_after))
