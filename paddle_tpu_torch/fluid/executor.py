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
that creates persistables, such as a startup program's, a program with
host-side ops, or a program whose control flow reads a predicate on
the host) lowers the block op by op:

1. the feeds are normalised to their declared dtypes on the device
   (numpy has no bfloat16, so a numpy feed declared bfloat16 raises; a
   torch tensor feed may already be on the device);
2. the program's persistables are gathered from the scope;
3. each ``wrt`` parameter of the block's ``autodiff`` op is bound as a
   fresh autograd leaf that shares the scope tensor's storage, so the
   forward ops build the graph as they run; a parameter with a
   SelectedRows gradient (``sparse_wrt``) is not: its sparse lookup
   binds its output as the leaf instead;
4. the ops are lowered in order: those before ``autodiff`` with
   autograd on, each ``stop_gradient`` output detached where it is
   produced, the rest under ``torch.no_grad()``; an environment entry is
   dropped after its last reader, so activations live no longer than
   autograd needs them;
5. the persistables written and those created are committed to the
   scope, and the fetches returned as numpy (bfloat16 as float32).

Control flow (``ops/control_flow.py``): a control-flow op lowers its
sub-blocks itself, on copies of the environment, in the autograd mode
of its place in the block. The plan counts its transitive reads and
writes (``framework.transitive_args``): an entry one of its sub-blocks
reads lives until it has run, and a persistable a sub-block writes is
one the step writes. A program whose blocks hold, at any depth, a
``while``, a ``cond``, a ``switch`` or an unbounded ``while_loop``
decides on the host inside the step, which a graph cannot capture: it
runs eagerly on the card (rule ``control_flow``). ``static_rnn``, the
bounded ``while_loop``, ``IfElse`` and ``DynamicRNN`` decide nothing on
the host and are captured like any step. As in the reference, no
gradient flows through a ``while`` or an unbounded ``while_loop``, and a
``save`` op inside a sub-block is refused; both before any op runs.

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
anomaly policies, the profiler's ``executor_run[...]`` records,
``CompiledProgram`` on one device (``compiler.py``), the host embedding
tier's hooks and ``train_from_dataset`` / ``infer_from_dataset``.

The host embedding tier (``embedding/host.py``): a run whose block holds
``host_embedding_init`` (a startup program) resets that table's
residency on the host first; before the feeds are normalised, each
host-tier binding maps its raw-ids feed to ``<table>@SLOTS``, admitting
and evicting rows in place in the scope's cache tensors (an ``iters=k``
window as one transaction over its k batches). The slots are a feed
like any other, so ids, residency and ``grow()`` never change a step's
key: no new capture, no new cache miss.

LoD feeds (``fluid/lod.py``): a ``LoDTensor`` feed is decomposed into
its rows, under its name, and its int32 innermost lengths, under
``name@LOD``, both fed like any array. The step's key also holds each
such feed's time bound, ``lod.length_bound`` of its longest length, read
here on the host: the sequence ops and ``dynamic_lstm`` read it from the
environment as a static int, so batches whose longest lengths fall in
one bucket replay one graph, and no op reads a length on the host.

py_reader feeding (``layers/py_reader.py``): a run of a py_reader-fed
program pulls each reader's next batch (``iters=k``: the next k,
stacked) on the host before the step and passes it as an ordinary feed,
so the program keeps its key and its graph; at the end of a pass it runs
no step, resets the readers and raises ``core.EOFException``.
``prefetch=True`` (``iters=k``) then drains, stacks and stages window
i+1 on a thread (``_WindowPrefetch``: the copies on a side stream behind
an event) while window i's replays run.

Fault tolerance, as the reference: ``checkpoint=(manager, n)`` saves a
``fluid.io.CheckpointManager`` version every n committed steps; the
``rollback`` anomaly policy restores its newest intact version (the
scope, the generator, the readers' positions); a preemption signal
(``distributed.preemption``) drains between steps and between windows:
the step commits, the manager force-saves, the process exits 0.

Recompute: an ``autodiff`` op with ``checkpoints`` splits the ops before
it into segments, each but the last run under ``torch.utils.checkpoint``
(``ops/autodiff.py``, ``run_checkpointed``), its draws replayed in the
backward's recomputation.

``as_function`` exposes a block as a pure ``fn(state, feed, rng_state)
-> (fetches, new_state, rng_state)``.

Every run turns TF32 off for its fp32 products while it runs
(``fp32_products``), and leaves the process's flags as they were.

The persistent compile cache (``fluid/compile_cache.py``): with
``PADDLE_COMPILE_CACHE_DIR`` set, or read directories in
``_cache_read_dirs`` (a ``Predictor``'s ``__prelowered__/``), a new step
key looks its plan up on disk by a content key (the program's digest in
place of ``_uid``), with the kernel libraries the plan's warm run
launched; a disk miss builds the step live and writes its entry after
that warm run, once those libraries are known. Counted as
``executor_compile_cache_{hit,miss}_total{tier="disk"}``. The graph
keys (scope, generator, state storage) stay in the memory tier.

Telemetry: a run inside a traced request (``telemetry.enabled()`` with a
current trace, as a serving batch's) records an ``executor.run`` span.
"""

import contextlib
import itertools
import logging
import threading
import time
import weakref

import numpy as np
import torch

from .. import fp32_products, resolve_device
from . import compile_cache as _compile_cache
from . import faults as _faults
from . import flags as _flags
from . import framework
from . import monitor as _monitor
from . import profiler as _prof
from .framework import Variable
from .ops import autodiff
from .registry import LowerCtx, lower_op, to_numpy_dtype, to_torch_dtype
from ..kernels import _build

__all__ = ["Scope", "global_scope", "scope_guard", "Executor", "copy_scope",
           "FetchHandle", "GraphCaptureError", "register_run_hook",
           "unregister_run_hook"]

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
_M_WINDOW_STALL = _monitor.histogram(
    "executor_window_stall_seconds",
    help="host wait for a prefetched iters=k window to finish its "
         "drain+stack+stage (0 when the window was already staged — "
         "the prefetch fully hid the host-side feed work)")
_M_OVERLAP_HIT = _monitor.counter(
    "executor_window_overlap_hit_total",
    help="batched runs served by an already-prefetched window "
         "(drain/stack/stage overlapped the previous window's compute)")
_M_OVERLAP_MISS = _monitor.counter(
    "executor_window_overlap_miss_total",
    help="prefetch-requested batched runs that drained inline "
         "(first window of a pass, or the pass just restarted after EOF)")
_M_PREFETCH_INFLIGHT = _monitor.gauge(
    "executor_window_prefetch_inflight",
    help="window prefetches currently draining/staging in the "
         "background (0 or 1 per Executor)")
_M_ANOMALY = _monitor.counter(
    "executor_anomaly_nonfinite_total",
    help="steps whose fetches/updated state contained non-finite values "
         "(or an injected step.nonfinite fault)")
_M_ANOMALY_SKIPPED = _monitor.counter(
    "executor_anomaly_skipped_steps_total",
    help="training steps discarded (state restored) by the skip_step "
         "anomaly policy")
_M_ANOMALY_ROLLBACKS = _monitor.counter(
    "executor_anomaly_rollbacks_total",
    help="rollback-policy restores to the last intact checkpoint after "
         "a non-finite step")
# the port's own: how steps ran on the card
_M_REPLAYS = _monitor.counter(
    "executor_graph_replay_total",
    help="steps run as one replay of a captured CUDA graph")
_M_CAPTURES = _monitor.counter(
    "executor_graph_capture_total",
    help="steps captured into a CUDA graph")
_M_STATE_COPIES = _monitor.counter(
    "executor_graph_state_copy_total",
    help="scope vars replaced between runs, copied into a graph's "
         "captured storage before its replay")


def _m_eager_by_rule(rule):
    return _monitor.counter(
        "executor_eager_by_rule_total",
        help="runs on the card kept eager by rule: the run creates "
             "persistables (a startup program), the program has "
             "host-side ops, or its control flow reads a predicate on "
             "the host", labels={"rule": rule})


# one CUDA graph capture at a time in the process (torch's capture
# stream is shared); replays need no lock
_CAPTURE_LOCK = threading.Lock()

# op types that act on the host during a run: the reference runs them
# outside its compiled step, and a graph cannot replay them
_HOST_OPS = frozenset(("save", "load", "print", "listen_and_serv",
                       "fl_listen_and_serv", "host_embedding_init"))

# control-flow op types that read a predicate on the host each time they
# decide (``while_loop`` only without ``maximum_trip_count``)
_HOST_DECIDING = frozenset(("while", "cond", "switch"))


def _decides_on_host(op):
    return op.type in _HOST_DECIDING or (
        op.type == "while_loop" and not op.attr("maximum_trip_count"))


def _refuse_loop_gradients(ops, grad_at, seeds):
    """Raise where a ``while`` or an unbounded ``while_loop`` before the
    ``autodiff`` op reads a value that depends on a ``seeds`` leaf: as
    in the reference, whose ``lax.while_loop`` has no reverse mode, no
    gradient flows through it."""
    tainted = set(seeds)
    for op in ops[:grad_at]:
        reads, writes = framework.transitive_args(op)
        if not reads & tainted:
            continue
        loop = next((o for o in framework.walk_ops([op])
                     if o.type == "while" or (
                         o.type == "while_loop"
                         and not o.attr("maximum_trip_count"))), None)
        if loop is not None:
            raise ValueError(
                "Reverse-mode differentiation does not work through a "
                "%r op (an unbounded loop): build the loop with "
                "layers.while_loop(..., maximum_trip_count=N), a bounded "
                "loop that gradients flow through" % loop.type)
        tainted |= writes

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
    be reused once a scope is collected). A child scope (``new_scope``)
    reads through to its parent and keeps what it sets to itself."""

    _uid_counter = itertools.count()

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent
        self.generator = None
        self._uid = next(Scope._uid_counter)

    def new_scope(self):
        return Scope(parent=self)

    def find_var(self, name):
        v = self.vars.get(name)
        if v is None and self.parent is not None:
            return self.parent.find_var(name)
        return v

    def has_var(self, name):
        return name in self.vars or (self.parent is not None
                                     and self.parent.has_var(name))

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


def _dtype_name(v):
    """A feed value's dtype by the IR's name, the same for a numpy array
    and a tensor of that dtype."""
    return str(to_numpy_dtype(v.dtype) if isinstance(v, torch.Tensor)
               else v.dtype)


def _feed_signature(feed):
    return tuple((n, tuple(np.shape(v)), _dtype_name(v))
                 for n, v in sorted(feed.items()))


def _lod_feeds(feed, iters):
    """Decompose each ``LoDTensor`` feed in place, as the reference
    does: its data under its name, its int32 innermost lengths under
    ``name@LOD``, both fed like any array. Returns the feeds' time
    bounds ``{name@LOD_BOUND: int}`` (``lod.length_bound`` of the
    longest length, read here on the host), which key the step. An
    ``iters=k`` run refuses a LoDTensor, in the reference's words."""
    from .lod import LoDTensor, bound_name, length_bound, lod_name

    bounds = {}
    for name in list(feed):
        value = feed[name]
        if not isinstance(value, LoDTensor):
            continue
        if iters > 1:
            raise ValueError(
                "iters>1 does not take LoDTensor feeds — feed dense "
                "arrays (plus explicit length arrays) stacked "
                "[k, ...], or loop exe.run from the host")
        lengths = value.lengths()
        feed[lod_name(name)] = lengths
        feed[name] = value.data()
        bounds[bound_name(name)] = length_bound(
            int(lengths.max()) if lengths.size else 0, value.shape[0])
    return bounds


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
    fetch comes back as float32. On the card the wait is a sync of the
    current stream, which releases the interpreter lock, so the host's
    threads (a window prefetch, a stager) run while the step finishes;
    ``Tensor.cpu()`` alone kept them waiting (PERF.md, PR 17)."""
    t0 = time.perf_counter()
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
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
    op, its dense ``wrt`` leaves and the sparse lookups' outputs it
    reads SelectedRows gradients at, the segments recompute runs under
    ``torch.utils.checkpoint`` ({first op: end}), the environment
    entries to drop after each op, and the persistables the ops
    write."""

    def __init__(self, program, fetch_names):
        block = program.global_block()
        for blk in program.blocks[1:]:
            if any(op.type == "save" for op in blk.ops):
                raise RuntimeError(
                    "a save op inside a control-flow sub-block is not "
                    "supported: the compiled step cannot conditionally "
                    "write host files — move the save op to the global "
                    "block or checkpoint from the host loop "
                    "(fluid.io.save)")
        self.block = block
        self.ops = list(block.ops)
        self.fetch_names = list(fetch_names)
        self.persistable = {v.name for v in program.list_vars()
                            if v.persistable}
        self.grad_at = next((i for i, op in enumerate(self.ops)
                             if op.type == "autodiff"), len(self.ops))
        grad_op = self.ops[self.grad_at] \
            if self.grad_at < len(self.ops) else None
        sparse_wrt = (grad_op.attr("sparse_wrt") or ()) if grad_op else ()
        # a SelectedRows gradient's parameter is no autograd leaf: its
        # lookup's output is (tensor_ops.sparse_leaf)
        self.sparse_outs = frozenset(s[2] for s in sparse_wrt)
        self.wrt = set(grad_op.attr("wrt")) - {s[0] for s in sparse_wrt} \
            if grad_op else set()
        checkpoints = grad_op.attr("checkpoints") if grad_op else None
        if checkpoints and sparse_wrt:
            raise NotImplementedError(autodiff.RECOMPUTE_SPARSE)
        self.recompute = dict(autodiff.checkpoint_segments(
            self.ops, self.grad_at, checkpoints)) if checkpoints else {}
        if grad_op is not None:
            _refuse_loop_gradients(self.ops, self.grad_at, self.wrt
                                   | self.sparse_outs)
        self.drop_after = _last_readers(
            self.ops, set(fetch_names) | self.persistable)
        self.written = sorted({n for op in self.ops
                               for n in framework.transitive_args(op)[1]
                               if n in self.persistable})
        nested = list(framework.walk_ops(self.ops))
        self.host_ops = sorted({op.type for op in nested
                                if op.type in _HOST_OPS})
        self.control_flow = any(_decides_on_host(op) for op in nested)

    def to_entry(self):
        """The plan as plain data for a compile-cache entry: the ops by
        index (their types), names, and the schedules."""
        return {
            "op_types": tuple(op.type for op in self.ops),
            "fetch_names": tuple(self.fetch_names),
            "persistable": tuple(sorted(self.persistable)),
            "grad_at": int(self.grad_at),
            "sparse_outs": tuple(sorted(self.sparse_outs)),
            "wrt": tuple(sorted(self.wrt)),
            "recompute": tuple(sorted(self.recompute.items())),
            "drop_after": tuple(tuple(names) for names in self.drop_after),
            "written": tuple(self.written),
            "host_ops": tuple(self.host_ops),
            "control_flow": bool(self.control_flow),
        }

    @classmethod
    def from_entry(cls, program, fetch_names, data):
        """The plan ``to_entry`` wrote, over ``program``'s ops; raises
        ValueError when the entry does not describe this program and
        fetch list."""
        block = program.global_block()
        ops = list(block.ops)
        if tuple(data["op_types"]) != tuple(op.type for op in ops) or \
                tuple(data["fetch_names"]) != tuple(fetch_names) or \
                len(data["drop_after"]) != len(ops):
            raise ValueError("the cache entry's plan is not this "
                             "program's")
        plan = cls.__new__(cls)
        plan.block = block
        plan.ops = ops
        plan.fetch_names = list(fetch_names)
        plan.persistable = set(data["persistable"])
        plan.grad_at = int(data["grad_at"])
        plan.sparse_outs = frozenset(data["sparse_outs"])
        plan.wrt = set(data["wrt"])
        plan.recompute = {int(i): int(e) for i, e in data["recompute"]}
        plan.drop_after = [list(names) for names in data["drop_after"]]
        plan.written = list(data["written"])
        plan.host_ops = list(data["host_ops"])
        plan.control_flow = bool(data.get("control_flow", False))
        return plan


class _CompiledStep:
    """One compiled step: the plan and, once captured, the step's CUDA
    graph with the tensors it binds: the static feed buffers, the
    scope's persistables (by storage) and the static fetch outputs.
    ``runs`` counts its runs. A graphed step's key names its scope, held
    weakly (a collected scope's steps are dropped), and its generator,
    held (its id is in the key); an eager executor's steps hold
    neither."""

    def __init__(self, plan, scope=None, generator=None, cache_key=None,
                 lod_bounds=None):
        self.plan = plan
        # {name@LOD_BOUND: int}: the time bounds of the step's LoD feeds
        self.lod_bounds = dict(lod_bounds or {})
        self.scope = None if scope is None else weakref.ref(scope)
        self.generator = generator
        # the disk key to write this step's entry under after its warm
        # run (a disk miss with a write dir), else None
        self.cache_key = cache_key
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
        # consecutive steps discarded by skip_step or rollback; a clean
        # step resets it
        self._anomaly_skips = 0
        # after a rollback, the manager's step count the run must commit
        # again before a clean step resets _anomaly_skips
        self._replay_until = 0
        # (reader ids, iters) -> the pending _WindowPrefetch of a
        # prefetching py_reader loop
        self._window_prefetch = {}
        # read-only compile-cache tiers searched before the write dir (a
        # Predictor's model-adjacent __prelowered__/)
        self._cache_read_dirs = []

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
        second captures). A py_reader-fed program takes no feed: the run
        pulls one batch (``iters=k``: k) from each reader first.

        ``fetch_mode="async"``: return ``FetchHandle``s; the run does not
        wait for the card. ``"sync"`` or None: ``return_numpy`` decides
        between numpy and device tensors (copies, never the graph's
        static outputs).

        ``prefetch=True`` (``iters=k``, a py_reader-fed program): once
        window i is queued, a thread drains, stacks and stages window
        i+1 (module docstring); the next run finds it staged
        (``executor_window_overlap_hit_total``).

        ``checkpoint=(manager, every_n_steps)``: after each committed
        step (a window counts k) the ``fluid.io.CheckpointManager``
        advances its counter and saves a version each time it crosses a
        multiple of ``every_n_steps``; also the ``rollback`` policy's
        target.

        A program with host-tier embedding lookups takes the raw ids as
        its feed; the run maps them to cache slots first (module
        docstring)."""
        with fp32_products():
            return self._run(program, feed, fetch_list, scope, return_numpy,
                             iters, fetch_mode, prefetch, checkpoint)

    @staticmethod
    def _check_checkpoint_arg(checkpoint):
        if checkpoint is None:
            return None
        try:
            mgr, every = checkpoint
        except (TypeError, ValueError):
            raise ValueError(
                "checkpoint must be a (CheckpointManager, every_n_steps) "
                "pair, got %r" % (checkpoint,))
        if not hasattr(mgr, "step_completed") or int(every) < 1:
            raise ValueError(
                "checkpoint must be a (CheckpointManager, every_n_steps "
                ">= 1) pair, got %r" % (checkpoint,))
        return mgr, int(every)

    def _run(self, program, feed, fetch_list, scope, return_numpy, iters,
             fetch_mode, prefetch, checkpoint):
        t_run0 = time.perf_counter()
        checkpoint = self._check_checkpoint_arg(checkpoint)
        if fetch_mode not in (None, "sync", "async"):
            raise ValueError("fetch_mode must be None, 'sync' or 'async', "
                             "got %r" % (fetch_mode,))
        iters = int(iters)
        if iters < 1:
            raise ValueError("iters must be >= 1, got %d" % iters)
        if prefetch and iters == 1:
            raise ValueError(
                "prefetch=True needs iters>=2: window prefetch overlaps "
                "the NEXT step-batched window with this one's compute — "
                "single steps already overlap via async dispatch "
                "(fetch_mode='async')")
        policy = _flags.anomaly_policy()

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
        manager = checkpoint[0] if checkpoint else None
        # a preemption signal that already arrived drains here, before
        # the step (drain_exit does not return)
        from ..distributed import preemption
        preemption.maybe_install_from_env()
        preemption.check_drain(manager, program, scope)

        feed = dict(feed or {})
        readers = self._py_reader_feed(program, feed, iters, prefetch)
        _host_tier(program, block, feed, scope, iters)
        lod_bounds = _lod_feeds(feed, iters)
        feed = {n: self._host_feed(block, n, v) for n, v in feed.items()}
        if iters > 1:
            stacked, invariant = _split_batched_feed(feed, block, iters)
        state_names = sorted(v.name for v in program.list_vars()
                             if v.persistable and scope.has_var(v.name))
        gen = scope.rng(self.place, program.random_seed)
        # the step's key: the program, one step's feed signature and its
        # LoD feeds' time bounds, the fetches and the state; a graph also
        # binds the scope, its generator and its tensors' storage
        step_feed = feed if iters == 1 else dict(
            invariant, **{n: v[0] for n, v in stacked.items()})
        key = (program._uid, program._mutation, _feed_signature(step_feed),
               tuple(sorted(lod_bounds.items())), tuple(fetch_names),
               tuple(state_names))
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
                plan, cache_key = self._new_plan(
                    program, fetch_names, step_feed, state_names)
                step = self._steps[key] = _CompiledStep(
                    plan, *((scope, gen) if self.cuda_graphs
                            else (None, None)), cache_key=cache_key,
                    lod_bounds=lod_bounds)
            self._cache[run_key] = step

        scan = (_flags.check_nan_inf_enabled() or policy != "raise"
                or _faults.is_armed("step.nonfinite"))
        snapshot = None
        if policy == "skip_step":
            # device copies of what the step may write: memory the size
            # of those persistables, for as long as the step runs
            snapshot = ({n: scope.find_var(n).clone()
                         for n in step.plan.written if scope.has_var(n)},
                        gen.get_state())
        profiling = _prof.is_profiler_enabled()
        t0 = _prof.now() if profiling else None
        from .. import telemetry as _telemetry

        try:
            with (_telemetry.span("executor.run",
                                  attrs={"program": program._uid,
                                         "cache_hit": cache_hit})
                  if _telemetry.enabled()
                  and _telemetry.current() is not None
                  else contextlib.nullcontext()):
                # a traced request (a serving batch's context is
                # ambient): the step joins the request's trace
                if iters == 1:
                    fetches, static, commit = self._step(step, scope, gen,
                                                         feed)
                else:
                    fetches, static, commit = self._window(
                        step, scope, gen, stacked, invariant, iters)
        except Exception:
            # flight-recorder trigger: capture the ring (open spans show
            # the in-flight request) before the failure unwinds
            _telemetry.flight.dump(reason="executor_exception")
            raise
        if prefetch:
            # window i is queued on the card: drain, stack and stage
            # window i+1 meanwhile
            self._window_prefetch[(tuple(id(r) for r in readers), iters)] = \
                _WindowPrefetch(readers, iters, self.place)
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
            self._handle_anomaly(anomaly, policy, iters, program, scope,
                                 checkpoint, readers)
        else:
            if checkpoint is not None:
                manager.step_completed(program, scope, iters, checkpoint[1])
            # a clean step ends a run of discards; after a rollback, only
            # once the run has committed the step that failed (the
            # rewound readers feed the same batches again)
            if scan and (manager is None or
                         manager._step >= self._replay_until):
                self._anomaly_skips = 0
        # a signal that landed during the step drains now, after the
        # state committed: a step is never torn in half
        preemption.check_drain(manager, program, scope)

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

    # -- py_reader feeding ---------------------------------------------------------
    def _py_reader_feed(self, program, feed, iters, prefetch):
        """Pull this run's batches from the program's py_readers into
        ``feed`` (``iters=k``: k each, stacked ``[k, ...]``), from a
        prefetched window when one is pending; returns the readers. At
        the end of a pass no step runs: the readers are reset and
        ``core.EOFException`` raised (a ragged last window is logged and
        dropped)."""
        from .layers.py_reader import program_py_readers

        readers = program_py_readers(program)
        if not readers:
            if prefetch:
                raise ValueError(
                    "prefetch=True needs a py_reader-fed program — "
                    "explicit feeds are the caller's to stage ahead of "
                    "time (DataLoader use_double_buffer / "
                    "fluid.reader.stage_feed)")
            return readers
        rkey = (tuple(id(r) for r in readers), iters)
        for k, pf in self._window_prefetch.items():
            if k != rkey and set(k[0]) & set(rkey[0]):
                if iters == 1:
                    raise RuntimeError(
                        "a prefetched iters=%d window is pending on this "
                        "program's py_reader(s) — a single-step run "
                        "would race it for batches. Finish the batched "
                        "loop (run with iters=%d until EOF) or "
                        "exe.close() first." % (pf.iters, pf.iters))
                raise RuntimeError(
                    "a prefetched window (iters=%d) is pending on "
                    "py_reader(s) this run (iters=%d) also reads — the "
                    "prefetched batches would be mis-windowed. Keep a "
                    "prefetching batched loop's iters uniform, or "
                    "exe.close() between loops." % (pf.iters, iters))
        pending = self._window_prefetch.pop(rkey, None)
        if pending is not None:
            status = pending.consume()
            if status[0] == "error":
                raise status[1]
            if status[0] == "eof":
                _eof(readers, iters, status[1], status[2], prefetched=True)
            _M_OVERLAP_HIT.inc()
            feed.update(status[1])
            return readers
        if prefetch:
            # the first window of a pass: nothing staged yet
            _M_OVERLAP_MISS.inc()
        steps, eof = _pull_window(readers, iters)
        if eof is not None:
            _eof(readers, iters, *eof)
        feed.update(_stack_window(readers, steps, iters))
        return readers

    def _discard_prefetch(self, readers=None):
        """Join and drop the pending window prefetches (of ``readers``,
        or all): their batches are lost, as any abandoned pass's."""
        ids = None if readers is None else {id(r) for r in readers}
        for k in list(self._window_prefetch):
            if ids is None or set(k[0]) & ids:
                self._window_prefetch.pop(k).discard()

    # -- the disk tier -------------------------------------------------------------
    def _new_plan(self, program, fetch_names, step_feed, state_names):
        """A new step's plan: from the compile cache's disk tier when an
        entry serves its content key (its libraries loaded, no build),
        else built live. Returns (plan, the key to save the entry under
        after the warm run, or None)."""
        if not _compile_cache.active(self._cache_read_dirs):
            return _Plan(program, fetch_names), None
        # the port donates nothing: the bit is the reference's inference
        # value, False
        key = _compile_cache.step_key(
            program, _feed_signature(step_feed), fetch_names, state_names,
            1, False, self.place)
        plan = _compile_cache.lookup(
            key, self._cache_read_dirs,
            validate=lambda data: _Plan.from_entry(program, fetch_names,
                                                   data))
        if plan is not None:
            return plan, None
        return (_Plan(program, fetch_names),
                key if _compile_cache.enabled() else None)

    def _save_entry(self, step, stems):
        """After a disk miss's warm run: write its entry (the plan and
        the libraries ``stems`` the run asked for) to the write dir."""
        key, step.cache_key = step.cache_key, None
        write_dir = _compile_cache.cache_dir()
        if write_dir:
            _compile_cache.save_entry(
                write_dir, key, step.plan.to_entry(), stems,
                label="step#%s" % ",".join(step.plan.fetch_names[:3]))

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
            env.update(step.lod_bounds)
            if step.cache_key is None:
                ctx = self._lower(plan, env, gen)
            else:
                with _build.record_uses() as stems:
                    ctx = self._lower(plan, env, gen)
                self._save_entry(step, stems)
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
        persistables, the program has host-side ops, or its control flow
        reads a predicate on the host; and as the warm run of a new
        key."""
        if not self.cuda_graphs:
            return True
        plan = step.plan
        if plan.host_ops:
            _m_eager_by_rule("host_ops").inc()
            return True
        if plan.control_flow:
            _m_eager_by_rule("control_flow").inc()
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
        ctx.sparse_outs = plan.sparse_outs
        ctx.wrt = frozenset(plan.wrt)
        ops, grad_at = plan.ops, plan.grad_at

        def after_op(i, env):
            if i < grad_at:
                for n in ops[i].output_arg_names():
                    v = plan.block._find_var_recursive(n)
                    if n in env and v is not None and v.stop_gradient \
                            and n not in plan.wrt:
                        env[n] = env[n].detach()
            for n in plan.drop_after[i]:
                env.pop(n, None)

        i = 0
        while i < len(ops):
            end = plan.recompute.get(i)
            if end is not None:
                autodiff.run_checkpointed(ctx, ops, i, end, after_op)
                for j in range(i, end):
                    for n in plan.drop_after[j]:
                        env.pop(n, None)
                i = end
                continue
            with torch.set_grad_enabled(i <= grad_at < len(ops)):
                lower_op(ctx, ops[i])
            after_op(i, env)
            i += 1
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
        env.update(step.lod_bounds)
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
        _M_CAPTURES.inc()

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
                _M_STATE_COPIES.inc()
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

    # -- datasets ------------------------------------------------------------------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """One pass over ``dataset``; returns the number of batches. Each
        batch runs through ``run(..., return_numpy=False)``, so step i is
        queued without waiting, while a ``reader.DeviceStager`` of
        capacity 2 parses batch i+1 and copies it to the place on its
        own stream (``reader.stage_feed``; the consumer's stream waits on
        the copy before the step reads it). The raw-ids feeds a host-tier
        embedding binding reads stay on the host: the table maps them to
        cache slots there, with no copy back from the card. ``debug``
        prints the first values of ``fetch_list`` every
        ``print_period`` batches."""
        if dataset is None:
            raise ValueError("dataset is required")
        if thread:
            dataset.set_thread(thread)
        fetch_list = list(fetch_list or [])
        fetch_info = list(fetch_info or
                          [getattr(v, "name", str(v)) for v in fetch_list])
        from .. import embedding
        from . import compiler
        from .reader import DeviceStager, stage_feed

        prog = program._program if isinstance(
            program, compiler.CompiledProgram) else program
        keep = embedding.host_ids_feeds(
            prog or framework.default_main_program())
        stager = DeviceStager(
            dataset.batch_reader()(),
            transform=lambda feed: stage_feed(feed, self.place,
                                              keep_on_host=keep),
            capacity=2, name="dataset")
        n_batches = 0
        try:
            for staged in stager:
                res = self.run(program, feed=staged, fetch_list=fetch_list,
                               scope=scope, return_numpy=False)
                n_batches += 1
                if debug and fetch_list and n_batches % print_period == 0:
                    print("batch %d: %s" % (n_batches, ", ".join(
                        "%s=%s" % (info, _fetch_numpy(val).ravel()[:4])
                        for info, val in zip(fetch_info, res))))
        finally:
            stager.close()
        return n_batches

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        """``train_from_dataset``'s drive over an inference program (the
        program decides what a step does, not the call)."""
        return self.train_from_dataset(program, dataset, scope, thread,
                                       debug, fetch_list, fetch_info,
                                       print_period)

    # -- anomaly policy -------------------------------------------------------------
    @staticmethod
    def _scan_anomaly(fetch_names, fetches, new_state):
        """The first non-finite (kind, var name) among the fetches and
        the state after the step, or None; one host sync by design. An
        armed ``step.nonfinite`` fault makes the step non-finite."""
        if _faults.take("step.nonfinite"):
            return ("injected", "step.nonfinite")
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

    def _handle_anomaly(self, where, policy, iters, program, scope,
                        checkpoint, readers):
        """Apply the policy to a non-finite step (or ``iters=k`` window):
        ``raise`` raises FloatingPointError naming the var (the step's
        in-place updates, ``adam``'s, have landed by then);
        ``skip_step`` (the caller has restored the state from before the
        step) logs; ``rollback`` restores the newest intact version of
        the run's ``checkpoint=`` manager into the scope, its generator
        and its readers (a pending window prefetch of the readers is
        dropped first), and raises the reference's error without one.
        Both raise once more than ``FLAGS_anomaly_skip_budget``
        consecutive steps were discarded; after a rollback, the steps
        the rewound run commits again do not break the run of discards
        (a batch that makes every pass non-finite ends the run)."""
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
        log = logging.getLogger(__name__)
        if policy == "rollback":
            if checkpoint is None:
                raise RuntimeError(
                    "anomaly policy 'rollback' needs a checkpoint to "
                    "roll back to — call Executor.run(..., "
                    "checkpoint=(CheckpointManager, every_n_steps))")
            self._discard_prefetch(readers)
            self._replay_until = checkpoint[0]._step + iters
            step = checkpoint[0].restore(self, program, scope=scope)
            _M_ANOMALY_ROLLBACKS.inc()
            log.warning("anomaly policy rollback: %s; restored "
                        "checkpoint step %d (%d/%d consecutive)",
                        msg, step, self._anomaly_skips, budget)
        else:
            _M_ANOMALY_SKIPPED.inc(iters)
            log.warning("anomaly policy skip_step: %s; discarding the "
                        "step's updates (%d/%d consecutive)", msg,
                        self._anomaly_skips, budget)

    # -- as a function -----------------------------------------------------------
    def as_function(self, program, feed_specs, fetch_list, scope=None):
        """``program``'s global block as a pure function ``fn(state, feed,
        rng_state) -> (fetches, new_state, rng_state)``, and example
        arguments ``(state, feed, rng_state)``: the scope's persistables,
        ``feed_specs`` ({name: example array}) and the state of the
        scope's generator (a ``ByteTensor``, in the reference's place
        for a jax key; a fresh generator's, seeded from
        ``program.random_seed``, when the scope has none). ``fn`` runs
        the block eagerly on this executor's place on copies of
        ``state``, with a generator of its own set to ``rng_state``: the
        scope and its generator are left untouched."""
        scope = scope or global_scope()
        block = program.global_block()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in fetch_list]
        state_names = sorted(v.name for v in program.list_vars()
                             if v.persistable and scope.has_var(v.name))
        plan = _Plan(program, fetch_names)

        def fn(state, feed, rng_state):
            gen = torch.Generator(device=self.place)
            gen.set_state(rng_state)
            env = {n: self._device(self._host_feed(block, n, v))
                   for n, v in feed.items()}
            env.update((n, t.clone()) for n, t in state.items())
            with fp32_products():
                ctx = self._lower(plan, env, gen)
            fetches = [env[n].detach() for n in plan.fetch_names]
            new_state = {n: env[n].detach() for n in state if n in env}
            new_state.update((n, env[n].detach()) for n in ctx.written
                             if n in env)
            return fetches, new_state, gen.get_state()

        state = {n: scope.find_var(n) for n in state_names}
        gen = scope.generator
        if gen is None:
            gen = torch.Generator(device=self.place)
            gen.manual_seed(int(program.random_seed or 0))
        return fn, (state, dict(feed_specs), gen.get_state())

    # -- lifetime --------------------------------------------------------------------
    def _drop_dead_scopes(self):
        """Drop the steps of scopes that were collected: their graphs
        hold the scopes' tensors."""
        for table in (self._cache, self._steps):
            for key in [k for k, s in table.items()
                        if s.scope is not None and s.scope() is None]:
                del table[key]

    def close(self):
        """Reap any pending window prefetch (joining its thread; the
        batches it pulled are dropped), then drop every cached step, its
        graph and the graphs' memory pool."""
        self._discard_prefetch()
        had_graphs = any(s.graph is not None for s in self._steps.values())
        self._cache.clear()
        self._steps.clear()
        self._pool = None
        if had_graphs:
            torch.cuda.empty_cache()


class _WindowPrefetch:
    """The drain, stack and stage of the next ``iters=k`` py_reader
    window on a thread (``Executor.run(..., iters=k, prefetch=True)``),
    while the card runs the window before it: the k batches of each
    reader are pulled, stacked ``[k, ...]`` and copied to the place
    (``reader.copy_feed``: on the card from pinned memory on the stager
    stream, behind an event). ``consume`` joins the thread (the wait is
    ``executor_window_stall_seconds``) and makes the calling thread's
    stream wait on the copies. The end of the pass is found here and
    acted on by the consuming run: EOF before any step, as inline.

    The readers' ``_committed`` positions hold where the committed steps
    left them while the thread pulls ahead, so a checkpoint saves no
    batch that no step trained on. The thread is non-daemon;
    ``consume`` and ``discard`` join it."""

    def __init__(self, readers, iters, place):
        self.readers = list(readers)
        self.iters = iters
        self.place = place
        self._result = ("error", RuntimeError("prefetch never ran"))
        for r in self.readers:
            r._committed = r.position
        self._thread = threading.Thread(
            target=self._drain, name="paddle-window-prefetch", daemon=False)
        self._thread.start()

    def _drain(self):
        from .reader import copy_feed

        try:
            with _M_PREFETCH_INFLIGHT.track():
                steps, eof = _pull_window(self.readers, self.iters)
                if eof is not None:
                    self._result = ("eof",) + eof
                    return
                self._result = ("ok", copy_feed(
                    _stack_window(self.readers, steps, self.iters),
                    self.place))
        except BaseException as e:  # re-raised by the consuming run
            self._result = ("error", e)

    def _join(self):
        self._thread.join()
        for r in self.readers:
            r._committed = None

    def consume(self):
        """``("ok", feed)``, ``("eof", steps pulled whole, the last
        pull)`` or ``("error", exc)``, after joining the thread."""
        t0 = time.perf_counter()
        self._join()
        _M_WINDOW_STALL.observe(time.perf_counter() - t0)
        if self._result[0] == "ok":
            return ("ok", self._result[1].wait())
        return self._result

    def discard(self):
        """Join and drop the result."""
        self._join()
        self._result = ("error", RuntimeError("prefetch discarded"))


def _pull_window(readers, iters):
    """``iters`` batches from each reader: ([a step's [each reader's
    batch]], None), or at the end of the pass (the steps pulled whole,
    (their count, the last pull: a batch or None per reader))."""
    steps = []
    for _ in range(iters):
        pulled = [r._next() for r in readers]
        if any(v is None for v in pulled):
            return steps, (len(steps), pulled)
        steps.append(pulled)
    return steps, None


def _stack_window(readers, steps, iters):
    """The feed of the pulled ``steps``: each slot's batch, or for
    ``iters=k`` its k batches stacked ``[k, ...]``."""
    feed = {}
    for j, r in enumerate(readers):
        for s, name in enumerate(r.names):
            vals = [step[j][s] for step in steps]
            feed[name] = vals[0] if iters == 1 else np.stack(vals)
    return feed


def _eof(readers, iters, pulled, last, prefetched=False):
    """End of a pass before a step: log what was pulled in vain, reset
    the readers and raise ``core.EOFException``."""
    from . import core

    log = logging.getLogger(__name__)
    if iters == 1:
        dropped = [r.names[0] for r, v in zip(readers, last)
                   if v is not None]
        if dropped:
            log.warning("py_reader EOF: discarding the already-pulled "
                        "batch of %s (readers have unequal lengths)",
                        dropped)
        msg = ("py_reader queue exhausted — reader.reset() and re-start() "
               "for the next pass")
    else:
        if pulled or any(v is not None for v in last):
            log.warning("py_reader EOF during a %sbatched run: discarding "
                        "%d already-pulled batch(es) of a requested "
                        "window of %d", "prefetched " if prefetched else "",
                        pulled, iters)
        msg = ("py_reader queue exhausted before %d batches — "
               "reader.reset() and re-start() for the next pass" % iters)
    for r in readers:
        r.reset()
    raise core.EOFException(msg)


def _host_tier(program, block, feed, scope, iters):
    """The host embedding tier's hooks, before the feeds are normalised:
    a ``host_embedding_init`` op (a startup program's) resets its
    table's residency now, on the host; each host-tier binding adds its
    ``<table>@SLOTS`` feed, admitting and evicting rows (one transaction
    for an ``iters=k`` window)."""
    inits = [op.attr("table_name") for op in block.ops
             if op.type == "host_embedding_init"]
    if not (inits or getattr(program, "_embedding_bindings", None)):
        return
    from .. import embedding

    for name in inits:
        embedding.get_host_table(name).reset_residency()
    embedding.prepare_feed(program, feed, scope, iters=iters)


def _last_readers(ops, keep):
    """For each op index, the env names no later op touches (kept names
    excepted): the run drops them once that op has run. A control-flow
    op touches what its sub-blocks read and write."""
    last = {}
    for i, op in enumerate(ops):
        reads, writes = framework.transitive_args(op)
        for n in sorted(reads | writes):
            last[n] = i
            v = op.block._find_var_recursive(n)
            if getattr(v, "type", None) == "selected_rows":
                last[n + "@ROWS"] = i     # a SelectedRows var's rows
        if op.type == "autodiff":
            for n in [op.attr("loss"), op.attr("loss_scale_var")] + list(
                    op.attr("wrt")) + [s[1] for s in op.attr(
                        "sparse_wrt") or ()]:
                if n:
                    last[n] = i
    out = [[] for _ in ops]
    for n, i in last.items():
        if n not in keep:
            out[i].append(n)
    return out
