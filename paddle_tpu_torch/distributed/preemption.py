"""Graceful preemption for training workers (the port's copy of the
worker side of ``paddle_tpu/distributed/preemption.py``): an eviction
notice arrives as SIGTERM, and a worker that ignores it is killed
seconds later.

``install()`` (or ``PADDLE_PREEMPT_DRAIN=1`` in the environment) registers
SIGTERM/SIGINT handlers that flip a process-wide *drain flag* — nothing
else happens in the handler. ``Executor.run`` checks the flag between
steps (and between ``iters=k`` windows) via ``check_drain``: the
in-flight step finishes and commits, the active ``CheckpointManager``
force-saves, a ``hb.<rank>.preempted`` marker lands in the heartbeat
directory (``PADDLE_HEARTBEAT_DIR``), and the process exits 0. A
launcher reads the marker to tell a clean preempt from a crash; the
launcher's side (``LauncherForward``) waits for ``launch`` (ROADMAP
queue 1 item 8).

``install()`` also wires SIGUSR1, the signal a hung-step watchdog
sends: ``faulthandler`` (C-level, works even when the interpreter is
wedged in native code) dumps every thread's stack to stderr, then
chains into a Python handler that runs the ``on_stack_signal``
callbacks, when bytecode can still run.

This module is the port's one home for ``signal.signal`` calls:
handlers registered elsewhere would clobber the drain flag.
"""

import faulthandler
import json
import logging
import os
import signal
import sys
import threading
import time

from ..fluid import monitor as _monitor

__all__ = [
    "ENV_DRAIN", "install", "uninstall", "installed", "draining",
    "drain_reason", "request_drain", "check_drain", "drain_exit",
    "on_drain", "on_stack_signal", "maybe_install_from_env",
    "preempt_marker_path", "write_preempt_marker", "reset",
]

ENV_DRAIN = "PADDLE_PREEMPT_DRAIN"
ENV_HEARTBEAT_DIR = "PADDLE_HEARTBEAT_DIR"

DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)

_M_SIGNALS = _monitor.counter(
    "preempt_signals_total",
    help="drain requests received (preemption signals + programmatic)")
_M_DRAIN_EXITS = _monitor.counter(
    "preempt_drain_exits_total",
    help="clean drain exits taken (checkpoint forced, marker written, "
         "exit 0)")

_LOCK = threading.Lock()
_DRAIN = threading.Event()
_CALLBACKS = []
_INSTALLED = False
_ENV_CHECKED = False
_PREV = {}
_STACK_SIGNAL = None
_STACK_PREV = None
_STACK_CALLBACKS = []
_REASON = None
_SINCE = None

log = logging.getLogger(__name__)


def _is_main_thread():
    return threading.current_thread() is threading.main_thread()


def draining():
    """True once a preemption signal (or ``request_drain``) arrived —
    the cheap flag ``Executor.run`` polls between steps."""
    return _DRAIN.is_set()


def drain_reason():
    """Why the drain flag was set (``'signal:SIGTERM'``, an API
    caller's reason string), or None."""
    return _REASON


def request_drain(reason="api"):
    """Flip the drain flag programmatically (what the signal handler
    does; also the test hook — no real signal delivery needed)."""
    global _REASON, _SINCE
    if not _DRAIN.is_set():
        _REASON = reason
        _SINCE = time.time()
        _DRAIN.set()
        _M_SIGNALS.inc()
        for fn in list(_CALLBACKS):
            try:
                fn()
            except Exception:  # a broken callback must not block the drain
                log.exception("on_drain callback failed")


def on_drain(fn):
    """Register ``fn`` to run when the drain flag flips (signal or
    ``request_drain``). Callbacks may run ON THE SIGNAL-HANDLER FRAME —
    they must be tiny and async-signal-tolerant (set an Event, wake a
    Condition); a serving replica uses this to break out of its idle
    wait the instant SIGTERM lands instead of polling. If the flag is
    already set, ``fn`` runs immediately. Returns ``fn``."""
    with _LOCK:
        _CALLBACKS.append(fn)
    if _DRAIN.is_set():
        fn()
    return fn


def on_stack_signal(fn):
    """Register ``fn`` to run when the watchdog's stack-dump signal
    (SIGUSR1) lands — AFTER faulthandler has written the C-level stack
    dump. Same frame rules as ``on_drain``: callbacks run on the
    signal-handler frame and must tolerate that (the flight recorder's
    dump is file-write-only). Returns ``fn``."""
    with _LOCK:
        _STACK_CALLBACKS.append(fn)
    return fn


def _handler(signum, frame):
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = str(signum)
    request_drain("signal:%s" % name)


def _stack_handler(signum, frame):
    for fn in list(_STACK_CALLBACKS):
        try:
            fn()
        except Exception:  # postmortem hooks must not kill the worker
            log.exception("on_stack_signal callback failed")


def install(signals=DEFAULT_SIGNALS, stack_dump_signal=signal.SIGUSR1):
    """Register the drain handlers (idempotent). Returns True when
    installed, False when not on the main thread (CPython only allows
    handler registration there; a worker driving training from a
    helper thread should call this from its main thread at startup).

    ``stack_dump_signal`` (default SIGUSR1, None disables) is handed to
    ``faulthandler.register`` so the launcher's hung-step watchdog can
    make this process dump all thread stacks to stderr — which
    ``distributed.launch`` redirects into the worker log."""
    global _INSTALLED, _STACK_SIGNAL, _STACK_PREV
    with _LOCK:
        if _INSTALLED:
            return True
        if not _is_main_thread():
            log.warning("preemption.install skipped: not the main "
                        "thread (signal handlers need it)")
            return False
        for s in signals:
            _PREV[s] = signal.signal(s, _handler)
        if stack_dump_signal is not None:
            # Python handler FIRST, then faulthandler with chain=True:
            # the C-level stack dump always works (even wedged in native
            # code) and chains into _stack_handler — the flight-recorder
            # hook — whenever the interpreter can still run bytecode.
            _STACK_PREV = signal.signal(stack_dump_signal, _stack_handler)
            faulthandler.register(stack_dump_signal, file=sys.stderr,
                                  all_threads=True, chain=True)
            _STACK_SIGNAL = stack_dump_signal
        _INSTALLED = True
        return True


def uninstall():
    """Restore the previous signal handlers (test teardown)."""
    global _INSTALLED, _STACK_SIGNAL, _STACK_PREV
    with _LOCK:
        if not _INSTALLED:
            return
        for s, prev in _PREV.items():
            signal.signal(s, prev)
        _PREV.clear()
        if _STACK_SIGNAL is not None:
            faulthandler.unregister(_STACK_SIGNAL)
            if _STACK_PREV is not None:
                signal.signal(_STACK_SIGNAL, _STACK_PREV)
            _STACK_PREV = None
            _STACK_SIGNAL = None
        _INSTALLED = False


def installed():
    return _INSTALLED


def reset():
    """Full teardown for tests: uninstall handlers, clear the drain
    flag, forget the env check (so a monkeypatched ``PADDLE_PREEMPT_
    DRAIN`` is re-read)."""
    global _REASON, _SINCE, _ENV_CHECKED
    uninstall()
    _DRAIN.clear()
    del _CALLBACKS[:]
    del _STACK_CALLBACKS[:]
    _REASON = None
    _SINCE = None
    _ENV_CHECKED = False


def maybe_install_from_env(environ=None):
    """Install the handlers when ``PADDLE_PREEMPT_DRAIN`` is truthy —
    called by ``Executor.run`` once per process so launched workers
    need zero script plumbing. The env is read once; ``reset()``
    forgets the answer."""
    global _ENV_CHECKED
    if _INSTALLED or _ENV_CHECKED:
        return _INSTALLED
    _ENV_CHECKED = True
    val = (environ if environ is not None else os.environ).get(
        ENV_DRAIN, "")
    if str(val).strip().lower() in ("1", "true", "yes", "on"):
        return install()
    return False


# -- the .preempted marker (next to heartbeat's .exit) ---------------------

def preempt_marker_path(dirname, rank):
    """Marker a drained worker leaves so the launcher (and the
    Watchdog) can tell a clean preempt from a crash — same naming
    convention as the heartbeat's ``hb.<rank>.exit``."""
    return os.path.join(dirname, "hb.%d.preempted" % int(rank))


def write_preempt_marker(dirname=None, rank=None):
    """Write the marker atomically; returns its path, or None when no
    heartbeat dir is configured (not launched — nothing to mark)."""
    dirname = dirname or os.environ.get(ENV_HEARTBEAT_DIR)
    if not dirname:
        return None
    if rank is None:
        rank = int(os.environ.get("PADDLE_TRAINER_ID", 0) or 0)
    path = preempt_marker_path(dirname, rank)
    tmp = "%s.tmp-%d" % (path, os.getpid())
    try:
        with open(tmp, "w") as f:
            json.dump({"ts": time.time(), "pid": os.getpid(),
                       "reason": _REASON}, f)
        os.replace(tmp, path)
    except OSError:
        # launcher tore the dir down already (gang kill in flight)
        return None
    return path


# -- the drain exit itself --------------------------------------------------

def drain_exit(manager=None, program=None, scope=None):
    """Finish draining: force-save through the active
    ``CheckpointManager`` (when the run carried one), write the
    ``.preempted`` marker, and exit 0. A checkpoint failure here is
    logged but never blocks the exit — the eviction deadline does not
    wait for a flaky filesystem, and the previous periodic checkpoint
    is still intact."""
    step = None
    if manager is not None and program is not None:
        try:
            manager.save(program, scope, background=False)
            manager.wait()
            step = manager._step
        except Exception:
            log.exception("preempt drain: final checkpoint failed; "
                          "exiting on the last periodic one")
    write_preempt_marker()
    _M_DRAIN_EXITS.inc()
    sys.stderr.write(
        "preemption: drained cleanly at step %s (%s); exiting 0\n"
        % (step if step is not None else "?", _REASON))
    sys.stderr.flush()
    raise SystemExit(0)


def check_drain(manager=None, program=None, scope=None):
    """The between-steps hook ``Executor.run`` calls: no-op until the
    drain flag is set, then ``drain_exit`` (which does not return). Only
    on the main thread, where a training loop runs: a run on another
    thread (a serving worker's batch) finishes, and its process drains
    through its main thread's ``on_drain`` path (a fleet replica lets
    its in-flight batches finish their replays, then closes)."""
    if not _DRAIN.is_set() or not _is_main_thread():
        return
    drain_exit(manager, program, scope)
