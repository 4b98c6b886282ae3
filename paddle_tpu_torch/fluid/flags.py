"""Global flags: the port's copy of ``paddle_tpu/fluid/flags.py``
(``fluid.set_flags`` / ``get_flags``, the reference's gflags surface).
A flag either changes what the executor does (below) or is accepted and
recorded for API compatibility (the allocator and threading flags: the
CUDA caching allocator and torch's thread pool own those).

Live flags:
  FLAGS_check_nan_inf      the executor checks every fetched value and
                           every persistable after a step for non-finite
                           numbers and raises naming the var
  FLAGS_anomaly_policy     what a non-finite training step does:
                           "raise" (default, FloatingPointError),
                           "skip_step" (restore the state from before
                           the step, keep going), "rollback" (restore the
                           last checkpoint; the port has no
                           CheckpointManager yet, so the executor refuses
                           it). Env: PADDLE_ANOMALY_POLICY.
  FLAGS_anomaly_skip_budget  consecutive anomalous steps skip_step
                           tolerates before raising anyway (default 3).
                           Env: PADDLE_ANOMALY_SKIP_BUDGET.
Accepted and recorded: FLAGS_check_program (the port has no
program_check pass), FLAGS_cudnn_deterministic,
FLAGS_eager_delete_tensor_gb, FLAGS_fraction_of_gpu_memory_to_use,
FLAGS_paddle_num_threads.
"""

import os

__all__ = ["set_flags", "get_flags"]

_FLAGS = {
    "FLAGS_check_nan_inf": os.environ.get("FLAGS_check_nan_inf",
                                          "0") in ("1", "true", "True"),
    "FLAGS_check_program": os.environ.get("FLAGS_check_program",
                                          "0") in ("1", "true", "True"),
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_paddle_num_threads": 1,
    "FLAGS_anomaly_policy": os.environ.get("PADDLE_ANOMALY_POLICY",
                                           "raise"),
    "FLAGS_anomaly_skip_budget": int(
        os.environ.get("PADDLE_ANOMALY_SKIP_BUDGET", "3")),
}

_ANOMALY_POLICIES = ("raise", "skip_step", "rollback")


def set_flags(flags):
    """Set one or more global flags (dict of name -> value)."""
    for name, value in flags.items():
        _FLAGS[name] = value


def get_flags(names):
    """Read flags by name (str or list of str)."""
    if isinstance(names, str):
        return {names: _FLAGS.get(names)}
    return {n: _FLAGS.get(n) for n in names}


def check_nan_inf_enabled():
    return bool(_FLAGS.get("FLAGS_check_nan_inf"))


def anomaly_policy():
    """Validated FLAGS_anomaly_policy value (raise|skip_step|rollback).
    Validation happens at READ time, so a bad env var or set_flags value
    fails the first run loudly rather than acting as raise."""
    p = _FLAGS.get("FLAGS_anomaly_policy", "raise")
    if p not in _ANOMALY_POLICIES:
        raise ValueError(
            "FLAGS_anomaly_policy must be one of %s, got %r"
            % ("|".join(_ANOMALY_POLICIES), p))
    return p


def anomaly_skip_budget():
    b = int(_FLAGS.get("FLAGS_anomaly_skip_budget", 3))
    if b < 0:
        raise ValueError(
            "FLAGS_anomaly_skip_budget must be >= 0, got %d" % b)
    return b
