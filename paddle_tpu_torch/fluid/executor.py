"""Scope and Executor: run a Program's global block on one device; on the
card, as one CUDA graph per (program, feed signature).

The port's counterpart of ``paddle_tpu/fluid/executor.py``, one device.
The reference traces a block once into a jitted XLA step and caches it
by (program, edit counter, feed signature, fetch list, state names,
strategy, anomaly bit); every later run of that key is one dispatch.
The port counts hits and misses under the same key, but keys its
compiled steps without what runs outside a step (``iters``, the anomaly
bit, a ``CompiledProgram``), so those runs share one step. A step
(``_CompiledStep``) holds the op plan (``_Plan``: where the ``autodiff``
op sits, its ``wrt`` leaves, which environment entries to drop after
which op, which persistables the ops write) and, on the card, a CUDA
graph of the step:

- run 1 of a key runs eagerly, op by op (``registry.lower_op``): it
  builds the kernels, seeds the scope's generator, warms cuBLAS;
- run 2 captures the step into a ``torch.cuda.CUDAGraph`` (the capture
  runs nothing) and replays it once;
- later runs replay it: feeds are copied into the graph's static
  buffers, one graph launch runs every kernel of the step, fetches are
  read from its static outputs.

An eager run (run 1, the CPU, ``cuda_graphs=False``, and by rule a run
that creates persistables, such as a startup program's, or a program
with host-side ops) lowers the block op by op:

1. the feeds are normalised to their declared dtypes on the device
   (numpy has no bfloat16, so a numpy feed declared bfloat16 raises; a
   torch tensor feed may already be on the device);
2. the program's persistables are gathered from the scope;
3. each ``wrt`` parameter of the block's ``autodiff`` op is bound as a
   fresh autograd leaf that shares the scope tensor's storage, so the
   forward ops build the graph as they run;
4. the ops are lowered in order: those before ``autodiff`` with
   autograd on, each ``stop_gradient`` output detached where it is
   produced, the rest under ``torch.no_grad()``; an environment entry is
   dropped after its last reader, so activations live no longer than
   autograd needs them;
5. the persistables written and those created are committed to the
   scope, and the fetches returned as numpy (bfloat16 as float32).

A captured step binds tensors by address, so its key also holds the
scope (``Scope._uid``), the scope's generator and each state tensor's
shape and dtype, and the step keeps every persistable in the storage it
was captured with: ``adam`` updates in place, and a persistable that an
op writes out of place (AMP's loss-scaling state, written by ``assign``)
is copied back into its storage inside the graph. A scope var replaced
between runs (``set_var``, ``copy_scope``, a loaded checkpoint) is
copied into the captured storage before the next replay, and the scope
rebound to it; one replaced by another shape or dtype is another key.

RNG: each scope holds one ``torch.Generator`` on the executor's device,
seeded from ``program.random_seed`` at its first run and kept across
runs; random ops draw from it in op order. A capture registers it with
the graph (``CUDAGraph.register_generator_state``), so every replay
draws on from the generator's offset, as an eager run would.

Kernel launch counts: the attention wrappers count only the launches
they make, so run 1 of a key counts its kernels and the capture and the
replays count none (a replay launches the graph's kernels without
calling a wrapper; a profiler trace names them).

Also ported: ``iters=k`` (k steps in one call, stacked ``[k, ...]`` or
loop-invariant feeds, each fetch a ``[k, ...]`` trajectory),
``fetch_mode="async"`` (``FetchHandle``), run hooks, the executor's
monitor series, ``FLAGS_check_nan_inf`` and the ``raise`` / ``skip_step``
anomaly policies, the profiler's ``executor_run[...]`` records and
``CompiledProgram`` on one device (``compiler.py``). Not ported yet
(ROADMAP queue 5): the ``rollback`` policy and ``checkpoint=`` (no
``CheckpointManager``), ``prefetch=True`` (no py_reader or DataLoader
staging), ``train_from_dataset`` and ``as_function``.
"""

import contextlib
import itertools
import logging
import threading
import time
import weakref

import numpy as np
import torch

from .. import resolve_device
from . import flags as _flags
from . import framework
from . import monitor as _monitor
from . import profiler as _prof
from .framework import Variable
from .registry import LowerCtx, lower_op, to_torch_dtype

__all__ = ["Scope", "global_scope", "scope_guard", "Executor", "copy_scope",
           "FetchHandle", "GraphCaptureError", "register_run_hook",
           "unregister_run_hook"]

# Programs are held to the reference in fp32, so fp32 products must not
# drop to TF32 on the card (AMP programs cast to bf16 explicitly).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# -- monitor series (the reference's names; process-wide) --------------------
_M_RUN_SECONDS = _monitor.histogram(
    "executor_run_seconds",
    help="Executor.run wall time (feed normalization + cache lookup + "
         "dispatch; includes a device sync only while profiling)")
_M_RUNS = _monitor.counter(
    "executor_run_total", help="completed Executor.run calls")
_M_CACHE_HIT = _monitor.counter(
    "executor_compile_cache_hit_total",
    help="Executor.run served by an already-built step")
_M_CACHE_MISS = _monitor.counter(
    "executor_compile_cache_miss_total",
    help="Executor.run that built a new step (program/feed-signature/"
         "fetch-list/state change)")
_M_CACHE_HIT_MEM = _monitor.counter(
    "executor_compile_cache_hit_total", help="compile-cache hits by tier",
    labels={"tier": "memory"})
_M_CACHE_MISS_MEM = _monitor.counter(
    "executor_compile_cache_miss_total",
    help="compile-cache misses by tier", labels={"tier": "memory"})
_M_BATCHED_RUNS = _monitor.counter(
    "executor_batched_run_total",
    help="Executor.run calls that ran iters>1 steps")
_M_BATCHED_ITERS = _monitor.counter(
    "executor_batched_iters_total",
    help="training steps executed inside batched runs (sum of iters)")
_M_FETCH_SYNC = _monitor.histogram(
    "executor_fetch_sync_seconds",
    help="device->host fetch materialization (the blocking sync): "
         "return_numpy=True observes once per fetch at run time, "
         "fetch_mode='async' only when FetchHandle.numpy()/indexing "
         "forces the value")
_M_ANOMALY = _monitor.counter(
    "executor_anomaly_nonfinite_total",
    help="steps whose fetches/updated state contained non-finite values")
_M_ANOMALY_SKIPPED = _monitor.counter(
    "executor_anomaly_skipped_steps_total",
    help="training steps discarded (state restored) by the skip_step "
         "anomaly policy")
_M_ANOMALY_ROLLBACKS = _monitor.counter(
    "executor_anomaly_rollbacks_total",
    help="rollback-policy restores (the port refuses the policy: "
         "no CheckpointManager yet)")
# the port's own: how steps ran on the card
_M_REPLAYS = _monitor.counter(
    "executor_graph_replay_total",
    help="steps run as one replay of a captured CUDA graph")


def _m_eager_by_rule(rule):
    return _monitor.counter(
        "executor_eager_by_rule_total",
        help="runs on the card kept eager by rule: the run creates "
             "persistables (a startup program), or the program has "
             "host-side ops", labels={"rule": rule})


# one CUDA graph capture at a time in the process (torch's capture
# stream is shared); replays need no lock
_CAPTURE_LOCK = threading.Lock()

# op types that act on the host during a run: the reference runs them
# outside its compiled step, and a graph cannot replay them
_HOST_OPS = frozenset(("save", "load", "print", "py_reader_dequeue",
                       "listen_and_serv", "fl_listen_and_serv",
                       "host_embedding_init"))

# -- run hooks -----------------------------------------------------------------
_RUN_HOOKS = []


def register_run_hook(fn):
    """Register ``fn(record)`` to fire once after every completed
    ``Executor.run``. ``record`` keys: ``program_id`` (Program._uid),
    ``fetch_names``, ``wall_time`` (seconds), ``cache_hit``,
    ``profiler_enabled``; a run with ``iters=k`` (k >= 2) fires once and
    adds ``iters``, an async run adds ``async`` (read
    ``record.get("iters", 1)``). Hook exceptions are logged and
    swallowed. Returns ``fn``, so it composes as a decorator."""
    _RUN_HOOKS.append(fn)
    return fn


def unregister_run_hook(fn):
    """Remove a registered run hook (no-op if absent)."""
    try:
        _RUN_HOOKS.remove(fn)
    except ValueError:
        pass


def _fire_run_hooks(record):
    for fn in list(_RUN_HOOKS):
        try:
            fn(record)
        except Exception:  # observability must not fail a training step
            logging.getLogger(__name__).exception(
                "executor run hook %r failed", fn)


class Scope:
    """name -> tensor store, plus the generator random ops draw from.
    ``_uid`` identifies the scope in the executor's cache (an ``id`` can
    be reused once a scope is collected). (Nested scopes wait for the
    control-flow ops that need them.)"""

    _uid_counter = itertools.count()

    def __init__(self):
        self.vars = {}
        self.generator = None
        self._uid = next(Scope._uid_counter)

    def find_var(self, name):
        return self.vars.get(name)

    def has_var(self, name):
        return name in self.vars

    def set_var(self, name, value):
        self.vars[name] = value

    def local_var_names(self):
        return list(self.vars)

    def rng(self, device, seed):
        """The scope's generator, made on ``device`` and seeded with
        ``seed`` at first use."""
        if self.generator is None:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(int(seed))
        elif self.generator.device != torch.device(device):
            raise RuntimeError("this scope's generator lives on %s, not %s"
                               % (self.generator.device, device))
        return self.generator


_scope_stack = [Scope()]


def global_scope():
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def copy_scope(src, dst, names, device="cuda"):
    """Copy the persistables ``names`` from ``src`` (any scope whose values
    convert to numpy, such as the reference package's after its startup
    program) into ``dst`` on ``device``, names and layouts unchanged. The
    two packages draw different random numbers, so parity runs start from
    the same copied state."""
    device = resolve_device(device)
    for n in names:
        val = src.find_var(n)
        if val is None:
            raise KeyError("%r is not in the source scope" % n)
        dst.set_var(n, torch.from_numpy(np.array(val)).to(device))


def _feed_signature(feed):
    return tuple((n, tuple(np.shape(v)), str(v.dtype))
                 for n, v in sorted(feed.items()))


def _split_batched_feed(feed, block, iters):
    """Classify each ``iters=k`` feed as per-iteration STACKED
    (``[k, ...]``, one slice per step) or loop-INVARIANT (the per-step
    shape, reused every step), as the reference does: a var with a fully
    static declared shape is validated exactly; with a dynamic (-1) dim
    the leading axis decides (``shape[0] == k`` means stacked)."""
    stacked, invariant = {}, {}
    for name, arr in feed.items():
        shape = tuple(np.shape(arr))
        var = block._find_var_recursive(name)
        declared = tuple(int(d) for d in var.shape) \
            if var is not None and var.shape is not None else None
        if declared is not None and all(d >= 0 for d in declared):
            if shape == declared:
                invariant[name] = arr
            elif shape[:1] == (iters,) and shape[1:] == declared:
                stacked[name] = arr
            elif shape[:1] == (iters,):
                raise ValueError(
                    "iters=%d: stacked feed %r has per-step shape %s "
                    "but var %r declares shape %s"
                    % (iters, name, list(shape[1:]), name, list(declared)))
            else:
                raise ValueError(
                    "iters=%d: feed %r has shape %s — pass either the "
                    "per-step shape %s (reused every iteration) or a "
                    "leading-axis stack %s (one slice per iteration)"
                    % (iters, name, list(shape), list(declared),
                       [iters] + list(declared)))
        elif shape[:1] == (iters,):
            stacked[name] = arr
        else:
            invariant[name] = arr
    return stacked, invariant


def _fetch_numpy(t):
    """One fetch on the host (the blocking sync, observed by
    ``executor_fetch_sync_seconds``); numpy has no bfloat16, so a bf16
    fetch comes back as float32."""
    t0 = time.perf_counter()
    out = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    _M_FETCH_SYNC.observe(time.perf_counter() - t0)
    return out


class FetchHandle:
    """A fetch still in flight on the device
    (``Executor.run(..., fetch_mode="async")``): ``run`` returns once the
    step is queued, and the handle holds a device copy of the fetch made
    on the stream right after the step, so a later step cannot overwrite
    it. The sync happens only where host data is asked for:
    ``.numpy()``, indexing, ``np.asarray(handle)``, ``float(handle)``
    (each observes ``executor_fetch_sync_seconds``). ``.value`` is the
    device tensor; ``shape``, ``dtype`` and ``repr`` never sync."""

    __slots__ = ("_value", "name")

    def __init__(self, value, name=None):
        self._value = value
        self.name = name

    @property
    def value(self):
        """The device tensor (no sync)."""
        return self._value

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    def block_until_ready(self):
        """Wait for the step to finish; the value stays on the device.
        Returns self for chaining."""
        if self._value.device.type == "cuda":
            torch.cuda.current_stream(self._value.device).synchronize()
        return self

    def numpy(self):
        """The value on the host (blocking sync)."""
        return _fetch_numpy(self._value)

    def __getitem__(self, idx):
        return self.numpy()[idx]

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def __float__(self):
        return float(self.numpy().reshape(-1)[0])

    def __repr__(self):
        return "FetchHandle(name=%r, shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)


class GraphCaptureError(RuntimeError):
    """Capturing a step into a CUDA graph failed; the message names the
    op at fault where one raised."""


class _Plan:
    """What a run of one block needs besides the tensors, fixed by the
    program and the fetch list: the ops, the index of the ``autodiff``
    op and its ``wrt`` leaves, the environment entries to drop after
    each op, and the persistables the ops write."""

    def __init__(self, program, fetch_names):
        block = program.global_block()
        self.block = block
        self.ops = list(block.ops)
        self.fetch_names = list(fetch_names)
        self.persistable = {v.name for v in program.list_vars()
                            if v.persistable}
        self.grad_at = next((i for i, op in enumerate(self.ops)
                             if op.type == "autodiff"), len(self.ops))
        self.wrt = set(self.ops[self.grad_at].attr("wrt")) \
            if self.grad_at < len(self.ops) else set()
        self.drop_after = _last_readers(
            self.ops, set(fetch_names) | self.persistable)
        self.written = sorted({n for op in self.ops
                               for n in op.output_arg_names()
                               if n in self.persistable})
        self.host_ops = sorted({op.type for op in self.ops
                                if op.type in _HOST_OPS})


class _CompiledStep:
    """One compiled step: the plan and, once captured, the step's CUDA
    graph with the tensors it binds: the static feed buffers, the
    scope's persistables (by storage) and the static fetch outputs.
    ``runs`` counts its runs. A graphed step's key names its scope, held
    weakly (a collected scope's steps are dropped), and its generator,
    held (its id is in the key); an eager executor's steps hold
    neither."""

    def __init__(self, plan, scope=None, generator=None):
        self.plan = plan
        self.scope = None if scope is None else weakref.ref(scope)
        self.generator = generator
        self.runs = 0
        self.graph = None
        self.feeds = {}
        self.state = {}
        self.fetches = []


class Executor:
    """Runs programs on ``place`` ("cuda" by default; "cpu" runs the
    kernels' plain versions). On the card each (program, feed signature)
    is captured into a CUDA graph at its second run and replayed after
    (module docstring); ``cuda_graphs=False`` runs every step eagerly,
    op by op. ``promote_products`` lets mul and matmul take operands of
    two float types (a Predictor's bf16 weights against fp32
    activations); training leaves it off, so a missed cast raises.

    An Executor's graphs share one memory pool. A graph's static buffers
    are rewritten by its next replay, so an executor serves one thread at
    a time; what ``run`` returns never aliases them (numpy, or device
    copies). ``close()`` drops the graphs and their pool."""

    def __init__(self, place=None, promote_products=False, cuda_graphs=True):
        self.place = resolve_device("cuda" if place is None else place)
        self.promote_products = bool(promote_products)
        self.cuda_graphs = bool(cuda_graphs) and self.place.type == "cuda"
        # the reference's cache key (plus, on the card, what a graph
        # binds) -> its compiled step; keys that differ only in what runs
        # outside the step (iters, the anomaly bit, a CompiledProgram's
        # uid) share one step (_steps), so one graph
        self._cache = {}
        self._steps = {}
        self._pool = None
        # consecutive steps discarded by skip_step; a clean step resets it
        self._anomaly_skips = 0

    # -- feeds -----------------------------------------------------------------
    def _host_feed(self, block, name, value):
        """``value`` as a numpy array in the declared dtype of ``name``;
        a torch tensor (a batch already on the card, as the reference
        takes a device array) stays a tensor, on the place and in the
        declared dtype."""
        var = block._find_var_recursive(name)
        if isinstance(value, torch.Tensor):
            if var is not None and var.dtype is not None:
                value = value.to(to_torch_dtype(var.dtype))
            return value.to(self.place)
        if var is not None and var.dtype == framework.BFLOAT16:
            raise TypeError(
                "feed %r is declared bfloat16, which numpy cannot hold; "
                "feed float32 and cast inside the program" % name)
        arr = np.asarray(value)
        if var is not None and arr.dtype != var.dtype:
            arr = arr.astype(var.dtype)
        return np.ascontiguousarray(arr)

    def _device(self, value):
        """A feed value as a tensor on the place (a tensor already there
        passes as it is)."""
        if isinstance(value, torch.Tensor):
            return value
        return torch.from_numpy(value).to(self.place)

    # -- run -------------------------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True, iters=1, fetch_mode=None, prefetch=False,
            checkpoint=None):
        """Run ``program`` (a Program, or a one-device ``CompiledProgram``)
        once, or ``iters`` times.

        ``iters=k`` (k >= 2): k steps in one call. Each feed is either a
        leading-axis stack ``[k, ...]`` (one slice a step) or the plain
        per-step shape (reused every step); the stacks are staged on the
        device once, and each fetch returns the ``[k, ...]`` trajectory,
        read with one host sync at the end. On the card the steps replay
        the key's graph (the first call's first step runs eagerly, its
        second captures).

        ``fetch_mode="async"``: return ``FetchHandle``s; the run does not
        wait for the card. ``"sync"`` or None: ``return_numpy`` decides
        between numpy and device tensors (copies, never the graph's
        static outputs).

        Not ported (ROADMAP queue 5): ``prefetch=True`` and
        ``checkpoint=`` raise ``NotImplementedError``."""
        t_run0 = time.perf_counter()
        if fetch_mode not in (None, "sync", "async"):
            raise ValueError("fetch_mode must be None, 'sync' or 'async', "
                             "got %r" % (fetch_mode,))
        iters = int(iters)
        if iters < 1:
            raise ValueError("iters must be >= 1, got %d" % iters)
        if prefetch:
            if iters == 1:
                raise ValueError(
                    "prefetch=True needs iters>=2: window prefetch overlaps "
                    "the NEXT step-batched window with this one's compute")
            raise NotImplementedError(
                "prefetch=True needs py_reader and DataLoader staging, "
                "which the port has not ported yet (ROADMAP queue 5)")
        if checkpoint is not None:
            raise NotImplementedError(
                "checkpoint= needs fluid.io.CheckpointManager, which the "
                "port has not ported yet (ROADMAP queue 5)")
        policy = _flags.anomaly_policy()
        if policy == "rollback":
            raise NotImplementedError(
                "FLAGS_anomaly_policy 'rollback' restores the last "
                "checkpoint: CheckpointManager is not ported yet (ROADMAP "
                "queue 5); use 'raise' or 'skip_step'")

        from . import compiler
        strategy = None
        if isinstance(program, compiler.CompiledProgram):
            strategy = program
            program = strategy._program
        program = program or framework.default_main_program()
        scope = scope or global_scope()
        block = program.global_block()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        feed = {n: self._host_feed(block, n, v)
                for n, v in (feed or {}).items()}
        if iters > 1:
            stacked, invariant = _split_batched_feed(feed, block, iters)
        state_names = sorted(v.name for v in program.list_vars()
                             if v.persistable and scope.has_var(v.name))
        gen = scope.rng(self.place, program.random_seed)
        # the step's key: the program, one step's feed signature, the
        # fetches and the state; a graph also binds the scope, its
        # generator and its tensors' storage
        step_feed = feed if iters == 1 else dict(
            invariant, **{n: v[0] for n, v in stacked.items()})
        key = (program._uid, program._mutation, _feed_signature(step_feed),
               tuple(fetch_names), tuple(state_names))
        if self.cuda_graphs:
            key += (scope._uid, id(gen), tuple(
                (tuple(t.shape), t.dtype)
                for t in (scope.find_var(n) for n in state_names)))
        # the reference's key, for its hit and miss counts
        run_key = key + (_feed_signature(feed),
                         strategy._uid if strategy is not None else 0,
                         iters, policy != "raise")

        step = self._cache.get(run_key)
        cache_hit = step is not None
        (_M_CACHE_HIT if cache_hit else _M_CACHE_MISS).inc()
        (_M_CACHE_HIT_MEM if cache_hit else _M_CACHE_MISS_MEM).inc()
        if step is None:
            self._drop_dead_scopes()
            step = self._steps.get(key)
            if step is None:
                step = self._steps[key] = _CompiledStep(
                    _Plan(program, fetch_names),
                    *((scope, gen) if self.cuda_graphs else (None, None)))
            self._cache[run_key] = step

        scan = _flags.check_nan_inf_enabled() or policy != "raise"
        snapshot = None
        if policy == "skip_step":
            # device copies of what the step may write: memory the size
            # of those persistables, for as long as the step runs
            snapshot = ({n: scope.find_var(n).clone()
                         for n in step.plan.written if scope.has_var(n)},
                        gen.get_state())
        profiling = _prof.is_profiler_enabled()
        t0 = _prof.now() if profiling else None
        if iters == 1:
            fetches, static, commit = self._step(step, scope, gen, feed)
        else:
            fetches, static, commit = self._window(step, scope, gen,
                                                   stacked, invariant, iters)
        if profiling:
            if self.place.type == "cuda":
                torch.cuda.synchronize(self.place)
            _prof._record(
                ("executor_run[%s#p%d]" % (",".join(fetch_names[:3]),
                                           program._uid) if iters == 1 else
                 "executor_batched_run[%s#p%d;k=%d]" % (
                     ",".join(fetch_names[:3]), program._uid, iters)),
                _prof.now() - t0)

        anomaly = None
        if scan:
            new_state = {n: commit.get(n, scope.find_var(n))
                         for n in state_names}
            new_state.update(commit)
            anomaly = self._scan_anomaly(fetch_names, fetches, new_state)
        if anomaly is not None and snapshot is not None:
            # skip_step: the state from before the step, generator too
            saved, rng_state = snapshot
            for n, t in saved.items():
                scope.find_var(n).copy_(t)
            gen.set_state(rng_state)
        elif anomaly is None:
            for n, t in commit.items():
                scope.set_var(n, t)
        if anomaly is not None:
            self._handle_anomaly(anomaly, policy, iters)
        elif scan:
            self._anomaly_skips = 0

        wall = time.perf_counter() - t_run0
        _M_RUN_SECONDS.observe(wall)
        _M_RUNS.inc()
        if iters > 1:
            _M_BATCHED_RUNS.inc()
            _M_BATCHED_ITERS.inc(iters)
        if _RUN_HOOKS:
            record = {"program_id": program._uid,
                      "fetch_names": list(fetch_names), "wall_time": wall,
                      "cache_hit": cache_hit, "profiler_enabled": profiling}
            if iters > 1:
                record["iters"] = iters
            if fetch_mode == "async":
                record["async"] = True
            _fire_run_hooks(record)

        if static and (fetch_mode == "async" or not return_numpy):
            # the graph's static outputs: its next replay rewrites them
            fetches = [t.clone() for t in fetches]
        if fetch_mode == "async":
            return [FetchHandle(t, name=n)
                    for n, t in zip(fetch_names, fetches)]
        if return_numpy:
            return [_fetch_numpy(t) for t in fetches]
        return fetches

    # -- one step ----------------------------------------------------------------
    def _step(self, step, scope, gen, feed):
        """Run ``step`` once on ``feed`` (numpy arrays or device
        tensors). Returns (fetches, whether they are the graph's static
        outputs, {persistable: tensor} to commit to the scope)."""
        plan = step.plan
        if self._eager(step, scope):
            env = {n: self._device(v) for n, v in feed.items()}
            for n in plan.persistable:
                if n not in env and scope.has_var(n):
                    env[n] = scope.find_var(n)
            ctx = self._lower(plan, env, gen)
            step.runs += 1
            commit = {n: env[n].detach() for n in plan.persistable
                      if n in env and (n in ctx.written
                                       or not scope.has_var(n))}
            return [env[n].detach() for n in plan.fetch_names], False, commit
        if step.graph is None:
            self._capture(step, scope, gen, feed)
        self._replay(step, scope, feed)
        step.runs += 1
        return list(step.fetches), True, {}

    def _eager(self, step, scope):
        """Whether this run of ``step`` runs op by op: always off the
        card or with ``cuda_graphs=False``; by rule when it creates
        persistables or the program has host-side ops; and as the warm
        run of a new key."""
        if not self.cuda_graphs:
            return True
        plan = step.plan
        if plan.host_ops:
            _m_eager_by_rule("host_ops").inc()
            return True
        if any(not scope.has_var(n) for n in plan.written):
            _m_eager_by_rule("creates_persistables").inc()
            return True
        return step.runs == 0 or not plan.ops

    def _lower(self, plan, env, gen):
        """Lower ``plan``'s ops in ``env`` (eagerly, or into the graph
        being captured); returns the LowerCtx."""
        for n in plan.wrt:
            env[n] = env[n].detach().requires_grad_(True)
        ctx = LowerCtx(plan.block, env, gen, self.place)
        ctx.promote_products = self.promote_products
        ops, grad_at = plan.ops, plan.grad_at
        for i, op in enumerate(ops):
            with torch.set_grad_enabled(i <= grad_at < len(ops)):
                lower_op(ctx, op)
            if i < grad_at:
                for n in op.output_arg_names():
                    v = plan.block._find_var_recursive(n)
                    if n in env and v is not None and v.stop_gradient \
                            and n not in plan.wrt:
                        env[n] = env[n].detach()
            for n in plan.drop_after[i]:
                env.pop(n, None)
        return ctx

    def _capture(self, step, scope, gen, feed):
        """Capture ``step`` into a CUDA graph over static feed buffers
        and the scope's persistables (module docstring). Raises
        ``GraphCaptureError`` naming the op at fault; never falls back
        to eager runs."""
        plan = step.plan
        step.feeds = {n: torch.empty(
            tuple(v.shape), dtype=v.dtype if isinstance(v, torch.Tensor)
            else to_torch_dtype(v.dtype), device=self.place)
            for n, v in feed.items()}
        step.state = {n: scope.find_var(n) for n in plan.persistable
                      if scope.has_var(n)}
        env = dict(step.feeds)
        env.update(step.state)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        failed, fetches = None, None
        with _CAPTURE_LOCK:
            try:
                with torch.cuda.graph(graph, pool=self._pool,
                                      capture_error_mode="thread_local"):
                    try:
                        ctx = self._lower(plan, env, gen)
                        for n in sorted(ctx.written):
                            self._write_back(step.state[n], env[n])
                        fetches = [env[n].detach() for n in plan.fetch_names]
                    except Exception as e:  # noqa: BLE001 — re-raised below
                        failed = e
            except RuntimeError as e:
                if failed is None:
                    raise GraphCaptureError(
                        "capturing program %d's step into a CUDA graph "
                        "failed at the end of the capture: %s"
                        % (plan.block.program._uid, e)) from e
        if failed is not None:
            raise GraphCaptureError(
                "capturing program %d's step into a CUDA graph failed: %s"
                % (plan.block.program._uid, failed)) from failed
        step.graph, step.fetches = graph, fetches

    @staticmethod
    def _write_back(stored, value):
        """Inside the capture: a persistable an op wrote out of place is
        copied back into the storage the next replay reads."""
        if value.data_ptr() != stored.data_ptr() or \
                value.stride() != stored.stride():
            stored.copy_(value.detach())

    def _replay(self, step, scope, feed):
        """Copy ``feed`` into the static buffers and any replaced scope
        var into its captured storage, then replay the graph once."""
        for n, v in feed.items():
            src = v if isinstance(v, torch.Tensor) else \
                torch.from_numpy(v).pin_memory()
            step.feeds[n].copy_(src, non_blocking=True)
        for n, t in step.state.items():
            cur = scope.find_var(n)
            if cur is not t:
                t.copy_(cur)
                scope.set_var(n, t)
        step.graph.replay()
        _M_REPLAYS.inc()

    # -- iters=k -------------------------------------------------------------------
    def _window(self, step, scope, gen, stacked, invariant, iters):
        """``iters`` steps of ``step``: the stacked feeds staged on the
        device once, each step fed its slices, each fetch copied into a
        ``[iters, ...]`` trajectory on the device. Eager steps commit
        their state before the next."""
        grown = sorted(n for n in step.plan.written if not scope.has_var(n))
        if grown:
            raise RuntimeError(
                "iters>1 needs loop-invariant state, but this program "
                "creates new persistable vars %s during the step — run the "
                "startup program (iters=1) first so they exist in the "
                "scope" % (grown,))
        staged = {n: self._device(v) for n, v in stacked.items()}
        fixed = {n: self._device(v) for n, v in invariant.items()}
        trajs = None
        for i in range(iters):
            feed = dict(fixed)
            feed.update((n, v[i]) for n, v in staged.items())
            fetches, _, commit = self._step(step, scope, gen, feed)
            for n, t in commit.items():
                scope.set_var(n, t)
            if trajs is None:
                trajs = [torch.empty((iters,) + tuple(f.shape),
                                     dtype=f.dtype, device=f.device)
                         for f in fetches]
            for traj, f in zip(trajs, fetches):
                traj[i].copy_(f)
        return trajs, False, {}

    # -- anomaly policy -------------------------------------------------------------
    @staticmethod
    def _scan_anomaly(fetch_names, fetches, new_state):
        """The first non-finite (kind, var name) among the fetches and
        the state after the step, or None; one host sync by design."""
        named = [("fetch", n, t) for n, t in zip(fetch_names, fetches)]
        named += [("state", n, t) for n, t in new_state.items()]
        named = [(k, n, t) for k, n, t in named
                 if isinstance(t, torch.Tensor) and t.is_floating_point()]
        if not named:
            return None
        finite = torch.stack([torch.isfinite(t).all()
                              for _, _, t in named]).cpu().tolist()
        for (kind, n, _), ok in zip(named, finite):
            if not ok:
                return kind, n
        return None

    def _handle_anomaly(self, where, policy, iters):
        """Apply the policy to a non-finite step (or ``iters=k`` window):
        ``raise`` raises FloatingPointError naming the var (the step's
        in-place updates, ``adam``'s, have landed by then);
        ``skip_step`` (the caller has restored the state from before the
        step) logs, or raises once more than
        ``FLAGS_anomaly_skip_budget`` consecutive steps were skipped."""
        _M_ANOMALY.inc()
        msg = ("non-finite values in %s var %r after running program"
               % where)
        if policy == "raise":
            raise FloatingPointError("FLAGS_check_nan_inf: " + msg)
        self._anomaly_skips += 1
        budget = _flags.anomaly_skip_budget()
        if self._anomaly_skips > budget:
            raise FloatingPointError(
                "anomaly policy %r: %s — %d consecutive anomalous steps "
                "exceeded FLAGS_anomaly_skip_budget=%d"
                % (policy, msg, self._anomaly_skips, budget))
        _M_ANOMALY_SKIPPED.inc(iters)
        logging.getLogger(__name__).warning(
            "anomaly policy skip_step: %s; discarding the step's updates "
            "(%d/%d consecutive)", msg, self._anomaly_skips, budget)

    # -- lifetime --------------------------------------------------------------------
    def _drop_dead_scopes(self):
        """Drop the steps of scopes that were collected: their graphs
        hold the scopes' tensors."""
        for table in (self._cache, self._steps):
            for key in [k for k, s in table.items()
                        if s.scope is not None and s.scope() is None]:
                del table[key]

    def close(self):
        """Drop every cached step, its graph and the graphs' memory
        pool."""
        had_graphs = any(s.graph is not None for s in self._steps.values())
        self._cache.clear()
        self._steps.clear()
        self._pool = None
        if had_graphs:
            torch.cuda.empty_cache()


def _last_readers(ops, keep):
    """For each op index, the env names no later op touches (kept names
    excepted): the run drops them once that op has run."""
    last = {}
    for i, op in enumerate(ops):
        for n in op.input_arg_names() + op.output_arg_names():
            last[n] = i
        if op.type == "autodiff":
            for n in [op.attr("loss"), op.attr("loss_scale_var")] + list(
                    op.attr("wrt")):
                if n:
                    last[n] = i
    out = [[] for _ in ops]
    for n, i in last.items():
        if n not in keep:
            out[i].append(n)
    return out
