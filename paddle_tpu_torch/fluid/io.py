"""Saving and loading variables and inference models (the port's
counterpart of the parameter and inference-model half of
``paddle_tpu/fluid/io.py``).

On disk the formats are the reference's, so either package reads what
the other wrote:

- one ``<name>.npy`` per variable, or one combined PTC1 file
  (``core/tensor_io.py``) when a ``filename`` is given;
- an inference model directory: ``__model__`` (or ``model_filename``),
  the pruned program as ``ProgramDesc`` protobuf bytes with its feed and
  fetch names (``core/proto_io.py``), beside its parameters.

- a training state (``save`` / ``load``): ``<path>.pdparams`` (the
  parameters) and ``<path>.pdopt`` (the other persistables) in PTC1,
  ``<path>.pdmodel`` the program's ``ProgramDesc`` bytes;
- a ``CheckpointManager`` version: a directory ``ckpt-<step>/`` of
  ``params.pdparams``, ``opt.pdopt`` and ``manifest.json``.

Values come from and go to ``executor.global_scope()`` (the scope of the
innermost ``scope_guard``), as in the reference; loaded tensors are put
on the executor's device. Writes are atomic (temporary file, fsync,
rename).

The generator in a checkpoint: the reference keeps its jax key under
``@rng_state@`` in ``.pdopt``; the port keeps its scope generator's
state there (``torch.Generator.get_state()``: uint8, 16 bytes for a
card's Philox generator). Restoring an entry the generator cannot take
(the reference's threefry key, uint32 [2], or another device's
generator state) seeds the generator with the entry's first 8 bytes
read as a little-endian integer, its top bit cleared, and logs that it
did: Philox cannot continue a threefry stream.

``save_inference_model(prelower=True)`` adds ``__prelowered__/``: the
compile cache's step plans and kernel libraries for the saved program
(``fluid/compile_cache.py``), which a ``Predictor`` cold-starts from.

Not ported: restore with reshard (``strategy=``, ROADMAP queue 1 item 7).
"""

import hashlib
import io as _io
import json
import logging
import os
import shutil
import threading
import time

import numpy as np
import torch

from .. import resolve_device
from . import framework
from . import monitor as _monitor
from . import resilience as _resilience
from .executor import global_scope
from .framework import Program, Variable

__all__ = ["save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "save", "load", "CheckpointManager"]

RNG_STATE_VAR = "@rng_state@"
ENV_CHECKPOINT_DIR = "PADDLE_CHECKPOINT_DIR"
ENV_RESTART_ATTEMPT = "PADDLE_RESTART_ATTEMPT"
RESHARD_ITEM = "ROADMAP queue 1 item 7"

_M_CKPT_SAVES = _monitor.counter(
    "checkpoint_saves_total", help="checkpoint versions committed")
_M_CKPT_SECONDS = _monitor.histogram(
    "checkpoint_save_seconds",
    help="wall time to snapshot + write + commit one checkpoint version "
         "(the write side only for background saves)")
_M_CKPT_RESTORES = _monitor.counter(
    "checkpoint_restores_total", help="successful CheckpointManager restores")
_M_CKPT_CORRUPT = _monitor.counter(
    "checkpoint_corrupt_total",
    help="checkpoint versions rejected by manifest/checksum validation "
         "(torn writes, truncation, bit rot)")
_M_CKPT_FALLBACK = _monitor.counter(
    "checkpoint_latest_fallback_total",
    help="latest() calls that skipped a torn newest version and fell "
         "back to an older intact one")

# a crashed reader's leftover .reading-* guard stops blocking rotation
# after this long
_GUARD_TTL = 300.0


def _atomic_write_bytes(path, data):
    """Temporary file + fsync + rename: ``path`` holds either the old
    bytes or the new ones, never a prefix of the new."""
    tmp = "%s.tmp-%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:  # leave no temporary file behind, then re-raise
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _is_persistable(var):
    return var.persistable


def _is_param(var):
    return isinstance(var, framework.Parameter)


def _selected(main_program, vars, predicate):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    return vars


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Write the scope's values of ``vars`` (or of the program's vars
    that ``predicate`` accepts) to ``dirname``: one ``.npy`` each, or
    all in the PTC1 file ``filename``. Vars the scope lacks are skipped.
    A bfloat16 value needs the PTC1 file (``.npy`` has no bfloat16)."""
    vars = _selected(main_program, vars, predicate)
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    values = {v.name: scope.find_var(v.name) for v in vars
              if scope.find_var(v.name) is not None}
    if filename is not None:
        from .core import tensor_io

        tensor_io.save_combine(os.path.join(dirname, filename), values)
        return
    for name, val in values.items():
        if isinstance(val, torch.Tensor):
            if val.dtype == torch.bfloat16:
                raise TypeError("%r is bfloat16, which .npy cannot hold: "
                                "save it with filename= (PTC1)" % name)
            val = val.detach().cpu().numpy()
        buf = _io.BytesIO()
        np.save(buf, np.asarray(val))
        _atomic_write_bytes(os.path.join(dirname, name + ".npy"),
                            buf.getvalue())


def _load_combined(path):
    """A combined tensor file: PTC1, or a legacy ``.npz``."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"PTC1":
        from .core import tensor_io

        return tensor_io.load_combine(path)
    data = np.load(path, allow_pickle=False)
    return {name: data[name] for name in data.files}


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, predicate=_is_param,
                     filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Read ``vars`` (or the program's vars ``predicate`` accepts) from
    ``dirname`` into the scope as tensors on ``executor.place``; a var
    with no file (or no entry in ``filename``) is left as it is."""
    vars = _selected(main_program, vars, predicate)
    scope = global_scope()
    if filename is not None:
        data = _load_combined(os.path.join(dirname, filename))
    else:
        data = {}
        for v in vars:
            path = os.path.join(dirname, v.name + ".npy")
            if os.path.exists(path):
                data[v.name] = np.load(path)
    for v in vars:
        if v.name in data:
            val = data[v.name]
            if not isinstance(val, torch.Tensor):
                val = torch.from_numpy(np.ascontiguousarray(val))
            scope.set_var(v.name, val.to(executor.place))


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, predicate=_is_param,
                     filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program,
                     predicate=_is_persistable, filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False, prelower=False,
                         prelower_batch_sizes=(1,)):
    """Prune ``main_program`` to what ``target_vars`` need (in eval mode)
    and save it with the parameters it reads, in the reference's layout.
    ``export_for_deployment=False`` keeps the whole program as built;
    ``program_only=True`` writes ``__model__`` alone. Returns the fetch
    names.

    ``prelower=True`` also runs the saved program once per batch size in
    ``prelower_batch_sizes`` (dynamic non-batch dims take 1) and writes
    what the compile cache keeps into ``<dirname>/__prelowered__``: one
    step plan per batch size and the kernel libraries those runs
    launched (``kernels/``). A ``Predictor`` opening this model then
    cold-starts from them, with no ``nvcc`` build and no
    ``PADDLE_COMPILE_CACHE_DIR`` needed; other batch sizes build live
    as usual."""
    main_program = main_program or framework.default_main_program()
    if export_for_deployment:
        pruned = main_program._prune(target_vars)
    else:
        pruned = main_program.clone(for_test=False)
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in target_vars]
    os.makedirs(dirname, exist_ok=True)
    desc = pruned.to_desc()
    desc["feed_names"] = list(feeded_var_names)
    desc["fetch_names"] = fetch_names
    from .core import proto_io

    model_bytes = proto_io.program_to_bytes(desc)
    _atomic_write_bytes(os.path.join(dirname, model_filename or "__model__"),
                        model_bytes)
    if not program_only:
        # only the persistables the pruned program still reads
        needed = {n for blk in pruned.blocks for op in blk.ops
                  for n in op.input_arg_names()}
        vars = [v for v in main_program.list_vars()
                if v.persistable and v.name in needed]
        save_vars(executor, dirname, main_program, vars=vars,
                  filename=params_filename)
    if prelower:
        _prelower(dirname, model_bytes, prelower_batch_sizes, executor)
    return fetch_names


def _prelower(dirname, model_bytes, batch_sizes, executor):
    """Run the saved inference program once per batch size with the
    compile cache routed at ``<dirname>/__prelowered__``: each run's
    step misses, is built live, and its entry (the plan and the kernel
    libraries it launched, copied into ``__prelowered__/kernels/``) is
    written there.

    The program is re-parsed from the exact ``__model__`` bytes just
    written (not the in-memory pruned object), so the content digest in
    the key is the one ``load_inference_model`` computes at cold start;
    the parameters come from the calling scope (they were just saved
    from it), seen through a child scope that keeps the runs' commits and
    generator out of the caller's. Exemplar feeds are zeros in the
    declared shapes: the first dynamic (-1) dim takes the batch size, any
    other dynamic dim takes 1."""
    from . import compile_cache as _compile_cache
    from .core import proto_io
    from .executor import Executor

    desc = proto_io.program_from_bytes(model_bytes)
    program = Program.from_desc(desc)
    block = program.global_block()
    feed_names = list(desc.get("feed_names", []))
    fetch_names = list(desc.get("fetch_names", []))
    out_dir = os.path.join(dirname, _compile_cache.PRELOWERED_DIRNAME)
    exe = Executor(executor.place if executor is not None else None)
    scope = global_scope().new_scope()
    with _compile_cache.override_dir(out_dir):
        for b in batch_sizes:
            feed = {}
            for name in feed_names:
                var = block._find_var_recursive(name)
                if var is None or var.shape is None:
                    raise ValueError(
                        "prelower: feed var %r has no declared shape — "
                        "pass explicit exemplar batches through the "
                        "serving warm-up instead" % name)
                shape, batch_dim_used = [], False
                for d in var.shape:
                    if int(d) < 0:
                        shape.append(1 if batch_dim_used else int(b))
                        batch_dim_used = True
                    else:
                        shape.append(int(d))
                feed[name] = np.zeros(shape, dtype=np.dtype(var.dtype))
            exe.run(program, feed=feed, fetch_list=fetch_names,
                    scope=scope)
    exe.close()


def _place(executor, scope):
    """Where loaded tensors go: the executor's place, else the device of
    the scope's generator or of any tensor it holds, else the card."""
    if executor is not None:
        return executor.place
    if scope.generator is not None:
        return scope.generator.device
    for v in scope.vars.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return resolve_device("cuda")


def _as_tensor(value, device):
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.ascontiguousarray(value))
    return value.to(device)


def save(program, model_path):
    """A training state (the reference's ``io.save``): the scope's
    parameters to ``<model_path>.pdparams``, its other persistables to
    ``.pdopt`` (PTC1) and the program to ``.pdmodel``."""
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    scope = global_scope()
    params, opt = {}, {}
    for v in program.list_vars():
        val = scope.find_var(v.name) if v.persistable else None
        if val is not None:
            (params if _is_param(v) else opt)[v.name] = val
    from .core import tensor_io

    tensor_io.save_combine(model_path + ".pdparams", params)
    tensor_io.save_combine(model_path + ".pdopt", opt)
    _atomic_write_bytes(model_path + ".pdmodel",
                        program.serialize_to_string())


def load(program, model_path, executor=None, var_list=None, strict=True):
    """Read ``save``'s ``.pdparams`` and ``.pdopt`` into the scope, as
    tensors on the executor's place (``_place``). ``strict=True`` raises
    ``FileNotFoundError`` when neither file exists; ``strict=False``
    returns False instead. Returns whether a file was read."""
    scope = global_scope()
    found = False
    for suffix in (".pdparams", ".pdopt"):
        path = model_path + suffix
        if not os.path.exists(path):
            continue
        found = True
        for name, arr in _load_combined(path).items():
            scope.set_var(name, _as_tensor(arr, _place(executor, scope)))
    if not found and strict:
        raise FileNotFoundError(
            "fluid.io.load: neither %s.pdparams nor %s.pdopt exists — "
            "pass strict=False to tolerate a missing checkpoint"
            % (model_path, model_path))
    return found


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Load a saved inference model: its program (through the load gate,
    ``compat.check_program_compatible``) and its persistables into the
    scope. Returns (program, feed names, fetch Variables)."""
    from .core import proto_io

    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        desc = proto_io.program_from_bytes(f.read())
    program = Program.from_desc(desc)
    load_vars(executor, dirname, program, predicate=_is_persistable,
              filename=params_filename)
    fetch_vars = [program.global_block().var(n)
                  for n in desc.get("fetch_names", [])]
    return program, list(desc.get("feed_names", [])), fetch_vars


# -- crash-consistent versioned checkpoints ----------------------------------

_MANIFEST = "manifest.json"
_CKPT_PREFIX = "ckpt-"


def _sha256_file(path, chunk=1 << 20):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _fsync_dir(path):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _program_py_readers(program):
    """(key, reader) of each live py_reader feeding ``program``; the key
    is the reader's first slot name (the same across restarts: slot
    names come from the unique-name counter)."""
    from .layers.py_reader import _READERS

    out = []
    for blk in program.blocks:
        for op in blk.ops:
            if op.type == "py_reader_dequeue":
                r = _READERS.get(int(op.attr("reader_id")))
                if r is not None:
                    out.append((r.names[0], r))
    return out


def _restore_generator(scope, device, value):
    """Put a checkpoint's ``@rng_state@`` entry into the scope's
    generator (made on ``device`` if the scope has none yet). The same
    generator object stays, so a CUDA graph that registered it draws on
    from the restored state. An entry it cannot take is used as a seed
    (module docstring)."""
    gen = scope.generator
    if gen is None:
        gen = scope.generator = torch.Generator(device=device)
    t = value if isinstance(value, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(value))
    if t.dtype == torch.uint8:
        try:
            gen.set_state(t.cpu())
            return
        except (RuntimeError, ValueError):
            pass
    raw = t.cpu().contiguous().view(torch.uint8).numpy().tobytes()[:8]
    seed = int.from_bytes(raw.ljust(8, b"\0"), "little") & (2 ** 63 - 1)
    gen.manual_seed(seed)
    logging.getLogger(__name__).info(
        "checkpoint %s entry (%s %s) is not this %s generator's state; "
        "seeded the generator with %d from its first 8 bytes",
        RNG_STATE_VAR, t.dtype, tuple(t.shape), gen.device, seed)


class CheckpointManager:
    """Versioned, crash-consistent training checkpoints with auto-resume
    (the reference's ``fluid.io.CheckpointManager``).

    Each ``save`` writes ``<dir>/ckpt-<step>/``: ``params.pdparams``,
    ``opt.pdopt`` (the other persistables and the scope generator's
    state, so dropout resumes where it was) and ``manifest.json`` (the
    step, a sha256 and size per file, the py_readers' positions). A
    version is built in a hidden temporary directory, every file
    fsync'd, and committed by one directory rename, so a crash leaves
    only whole versions. ``latest()`` and ``restore()`` check the sums
    and fall back to the newest intact version. ``max_to_keep`` versions
    are kept.

    ``dirname=None`` reads ``PADDLE_CHECKPOINT_DIR``. The snapshot is
    taken on the caller's thread: one device-to-host copy of each
    persistable into pinned buffers the manager keeps from save to save
    (the previous write has finished by then), one sync. The write runs
    there too, or with ``background=True`` on a writer thread, whose
    failure ``wait()`` (and the next ``save``) re-raises. File I/O goes
    through a shared ``resilience.Retry``; a corrupt version is skipped,
    never retried. ``history`` holds a record of each save: its step,
    seconds (``snapshot_s`` on the caller's thread; ``write_s`` and
    ``sha256_s`` once the write is done) and ``bytes``;
    ``last_restore_s`` is the last restore's seconds.

        mgr = fluid.io.CheckpointManager(max_to_keep=3)
        exe.run(startup)
        start = mgr.restore_on_restart(exe, main) or 0
        for step in range(start, total):
            exe.run(main, feed=..., checkpoint=(mgr, 50))
    """

    def __init__(self, dirname=None, max_to_keep=3, background=False,
                 retry=None):
        dirname = dirname or os.environ.get(ENV_CHECKPOINT_DIR)
        if not dirname:
            raise ValueError(
                "CheckpointManager needs a directory: pass dirname= or "
                "set %s (distributed.launch(checkpoint_dir=...) exports "
                "it to workers)" % ENV_CHECKPOINT_DIR)
        self.dirname = dirname
        self.max_to_keep = max(1, int(max_to_keep))
        self.background = bool(background)
        self._step = 0
        self._writer = None
        self._writer_err = None
        self._host = {}
        self.history = []
        self.last_restore_s = None
        self._retry = retry if retry is not None else _resilience.Retry(
            max_attempts=3, base_delay=0.05, max_delay=2.0,
            name="checkpoint.io")
        os.makedirs(dirname, exist_ok=True)

    # -- versions ------------------------------------------------------------
    def _path(self, step):
        return os.path.join(self.dirname, "%s%08d" % (_CKPT_PREFIX, step))

    def steps(self):
        """Every committed version's step, ascending (not validated)."""
        try:
            names = os.listdir(self.dirname)
        except OSError:
            return []
        out = []
        for n in names:
            if n.startswith(_CKPT_PREFIX):
                try:
                    out.append(int(n[len(_CKPT_PREFIX):]))
                except ValueError:
                    pass
        return sorted(out)

    def manifest(self, step):
        """Version ``step``'s parsed manifest (no checksum pass)."""
        with open(os.path.join(self._path(step), _MANIFEST)) as f:
            return json.load(f)

    def validate(self, step):
        """Whether version ``step`` is intact: its manifest parses and
        every file it lists has the recorded size and sha256."""
        d = self._path(step)
        try:
            m = self.manifest(step)
            for fname, meta in m["files"].items():
                p = os.path.join(d, fname)
                if os.path.getsize(p) != meta["bytes"] or \
                        _sha256_file(p) != meta["sha256"]:
                    return False
            return True
        except (OSError, ValueError, KeyError):
            return False

    def latest(self):
        """The newest intact version's step, or None; torn versions are
        counted and skipped."""
        fell_back = False
        for step in reversed(self.steps()):
            if self.validate(step):
                if fell_back:
                    _M_CKPT_FALLBACK.inc()
                return step
            _M_CKPT_CORRUPT.inc()
            fell_back = True
        return None

    # -- save ----------------------------------------------------------------
    def _host_copy(self, name, value):
        """``value`` on the host: a card tensor copied, without a sync,
        into this manager's pinned buffer for ``name``."""
        if not isinstance(value, torch.Tensor):
            return torch.from_numpy(np.array(value))
        value = value.detach()
        if not value.is_cuda:
            return value.clone()
        buf = self._host.get(name)
        if buf is None or buf.shape != value.shape or \
                buf.dtype != value.dtype:
            buf = self._host[name] = torch.empty(
                value.shape, dtype=value.dtype, pin_memory=True)
        buf.copy_(value, non_blocking=True)
        return buf

    def _snapshot(self, program, scope):
        """Host copies of every persistable ``program`` sees in the
        scope, split as ``io.save`` splits them, the generator's state,
        and the py_readers' positions; taken on the caller's thread, so
        a background write never races the training loop."""
        scope = scope or global_scope()
        params, opt = {}, {}
        devices = set()
        for v in program.list_vars():
            val = scope.find_var(v.name) if v.persistable else None
            if val is None:
                continue
            if isinstance(val, torch.Tensor) and val.is_cuda:
                devices.add(val.device)
            (params if _is_param(v) else opt)[v.name] = \
                self._host_copy(v.name, val)
        for d in devices:
            torch.cuda.current_stream(d).synchronize()
        if scope.generator is not None:
            opt[RNG_STATE_VAR] = scope.generator.get_state()
        readers = {key: r.checkpoint_position
                   for key, r in _program_py_readers(program)}
        return params, opt, readers

    def save(self, program, scope=None, step=None, background=None):
        """Write one version at ``step`` (by default the manager's
        counter, which ``Executor.run(checkpoint=...)`` and ``restore``
        advance). A background save returns after the snapshot: call
        ``wait()`` before reading ``latest()`` or exiting. Returns the
        step."""
        step = int(self._step if step is None else step)
        background = self.background if background is None else background
        self.wait()  # one writer at a time; re-raises its failure
        t0 = time.perf_counter()
        params, opt, readers = self._snapshot(program, scope)
        rec = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.history.append(rec)
        args = (step, params, opt, readers, rec)
        if background:
            self._writer = threading.Thread(
                target=self._write_guarded, args=args,
                name="paddle-checkpoint-writer", daemon=False)
            self._writer.start()
        else:
            self._retry.call(self._write_version, *args)
        return step

    def _write_guarded(self, *args):
        try:
            self._retry.call(self._write_version, *args)
        except BaseException as e:  # re-raised on the caller's thread by wait()
            self._writer_err = e

    def _write_version(self, step, params, opt, readers, rec):
        from . import faults
        from .core import tensor_io

        t0 = time.perf_counter()
        hashing = 0.0
        with _M_CKPT_SECONDS.time():
            final = self._path(step)
            tmp = os.path.join(self.dirname, ".tmp-%s%08d-%d" % (
                _CKPT_PREFIX, step, os.getpid()))
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            files = {}
            for fname, arrays in (("params.pdparams", params),
                                  ("opt.pdopt", opt)):
                p = os.path.join(tmp, fname)
                # the directory and its rename commit the version
                tensor_io.save_combine(p, arrays, atomic=False)
                tensor_io._fsync_path(p)
                t1 = time.perf_counter()
                files[fname] = {"sha256": _sha256_file(p),
                                "bytes": os.path.getsize(p)}
                hashing += time.perf_counter() - t1
            faults.check("io.write")  # a crash before the commit
            manifest = {"step": step, "files": files,
                        "reader_positions": readers,
                        "world_size": int(os.environ.get(
                            "PADDLE_TRAINERS_NUM", "1") or 1),
                        "time": time.time()}
            mpath = os.path.join(tmp, _MANIFEST)
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)  # saving a step again replaces it
            os.rename(tmp, final)
            _fsync_dir(self.dirname)
        rec.update(write_s=time.perf_counter() - t0, sha256_s=hashing,
                   bytes=sum(m["bytes"] for m in files.values()))
        _M_CKPT_SAVES.inc()
        self._prune()

    def _guard_path(self, step):
        return os.path.join(self.dirname,
                            ".reading-%08d-%d" % (int(step), os.getpid()))

    def _guarded_steps(self):
        """Versions a live ``restore`` pinned with a ``.reading-*``
        file, which rotation keeps; guards older than ``_GUARD_TTL``
        are a crashed reader's and are removed."""
        guarded = set()
        try:
            names = os.listdir(self.dirname)
        except OSError:
            return guarded
        now = time.time()
        for n in names:
            if not n.startswith(".reading-"):
                continue
            p = os.path.join(self.dirname, n)
            try:
                if now - os.path.getmtime(p) > _GUARD_TTL:
                    os.remove(p)
                    continue
                guarded.add(int(n[len(".reading-"):].split("-")[0]))
            except (OSError, ValueError):
                pass
        return guarded

    def _prune(self):
        guarded = self._guarded_steps()
        for step in self.steps()[:-self.max_to_keep]:
            if step not in guarded:
                shutil.rmtree(self._path(step), ignore_errors=True)
        # temporary directories of crashed writers
        try:
            for n in os.listdir(self.dirname):
                if n.startswith(".tmp-%s" % _CKPT_PREFIX) and \
                        not n.endswith("-%d" % os.getpid()):
                    shutil.rmtree(os.path.join(self.dirname, n),
                                  ignore_errors=True)
        except OSError:
            pass

    def wait(self):
        """Join a background save; re-raise its failure."""
        w, self._writer = self._writer, None
        if w is not None:
            w.join()
        if self._writer_err is not None:
            e, self._writer_err = self._writer_err, None
            raise e

    close = wait

    # -- restore -------------------------------------------------------------
    def restore(self, executor=None, program=None, scope=None, step=None,
                strategy=None):
        """Load version ``step`` (by default the newest intact one) into
        the scope, as tensors on the executor's place: the parameters,
        the optimizer's state, the generator's state, and the positions
        of the program's live py_readers (``resume_at``). Returns the
        step; raises ``FileNotFoundError`` when no version is intact.
        Restore with reshard onto a mesh (``strategy=``) is not ported
        (ROADMAP queue 1 item 7)."""
        if strategy is not None:
            raise NotImplementedError(
                "CheckpointManager.restore(strategy=...) reshards onto a "
                "mesh, which the port has not ported yet (%s)"
                % RESHARD_ITEM)
        self.wait()
        t0 = time.perf_counter()
        from . import compiler

        if isinstance(program, compiler.CompiledProgram):
            program = program._program
        program = program or framework.default_main_program()
        if step is None:
            step = self.latest()
            if step is None:
                raise FileNotFoundError(
                    "no intact checkpoint under %r" % self.dirname)
        elif not self.validate(step):
            raise IOError("checkpoint step %d under %r failed checksum "
                          "validation" % (step, self.dirname))
        scope = scope or global_scope()
        device = _place(executor, scope)
        from .core import tensor_io

        d = self._path(step)
        guard = self._guard_path(step)
        try:
            with open(guard, "w") as f:
                f.write(str(time.time()))
        except OSError:
            guard = None  # an unwritable directory: read unguarded
        try:
            for fname in ("params.pdparams", "opt.pdopt"):
                data = self._retry.call(tensor_io.load_combine,
                                        os.path.join(d, fname))
                for name, arr in data.items():
                    if name == RNG_STATE_VAR:
                        _restore_generator(scope, device, arr)
                    else:
                        scope.set_var(name, _as_tensor(arr, device))
            manifest = self.manifest(step)
        finally:
            if guard:
                try:
                    os.remove(guard)
                except OSError:
                    pass
        positions = manifest.get("reader_positions", {})
        for key, r in _program_py_readers(program):
            if key in positions:
                r.resume_at(int(positions[key]))
        self._step = step
        self.last_restore_s = time.perf_counter() - t0
        _M_CKPT_RESTORES.inc()
        return step

    def restore_on_restart(self, executor=None, program=None, scope=None,
                           strategy=None):
        """For a restarted worker: when ``PADDLE_RESTART_ATTEMPT`` > 0 and
        an intact version exists, restore it and return its step; else
        None (a first start, or no version yet)."""
        attempt = int(os.environ.get(ENV_RESTART_ATTEMPT, "0") or 0)
        if attempt <= 0:
            return None
        # restarted worker: page in + validate the persistent compile
        # cache now, so the first step loads its plan and libraries
        # instead of rebuilding them (a no-op when
        # PADDLE_COMPILE_CACHE_DIR is unset)
        from . import compile_cache as _compile_cache

        _compile_cache.prewarm()
        if self.latest() is None:
            return None
        return self.restore(executor, program, scope, strategy=strategy)

    # -- the executor's hook -------------------------------------------------
    def step_completed(self, program, scope, iters, every_n_steps):
        """Called by ``Executor.run(..., checkpoint=(mgr, n))`` after each
        committed step (or ``iters=k`` window): advances the counter and
        saves when it crosses a multiple of ``every_n_steps``."""
        every = int(every_n_steps)
        if every < 1:
            raise ValueError(
                "checkpoint every_n_steps must be >= 1, got %r"
                % (every_n_steps,))
        before = self._step
        self._step = before + int(iters)
        if self._step // every > before // every:
            self.save(program, scope, step=self._step)
