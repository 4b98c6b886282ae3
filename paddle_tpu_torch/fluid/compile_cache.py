"""Persistent compilation cache: step plans and kernel libraries on disk.

The port's counterpart of ``paddle_tpu/fluid/compile_cache.py``. The
reference serializes XLA executables; a CUDA graph binds addresses and
cannot be written out, so what a cold process of the port pays before
its first answer is the ``nvcc`` build of its kernels (minutes) and, per
step key, building the step's plan, one eager warm run and one capture.
The disk tier removes the build and the plan:

- one entry per step (``<key>.tplan``): the step's plan as plain data
  (the ops' types by index, ``grad_at``, ``wrt``, the drop schedule,
  ``written``, ``host_ops``, ...) and the name and sha256 of every kernel
  library the step's warm run launched;
- those libraries, stored once per directory under ``kernels/``
  (``kernels/_build.py`` reads them before it would build).

A disk hit is the entry loaded AND every library it names loaded with
``ctypes`` (sha256 checked) AND no ``nvcc`` started. The eager warm run
and the capture still happen: ``Server.register``'s warm-up runs them
before a replica registers, so no request pays for them.

Keying: the executor's in-memory key leans on the process-local
``Program._uid``. The disk key replaces it with a content hash of the
program desc (``Program.serialize_to_string``, the bytes
``fluid/core/proto_io.py`` writes, so the digest equals the reference's
for the same desc), with the step's feed signature, fetch and state
names, ``iters``, the donation bit (the port donates nothing: fixed
False, the reference's inference value) and an environment fingerprint
(the format version, torch and CUDA versions, the platform, device name,
compute capability and device count, and on the card ``nvcc``'s flags
and version). A foreign entry therefore misses by file name.

Robustness contract, as the reference's: a corrupted, truncated or
otherwise unloadable entry is never fatal: it is quarantined (renamed
aside, counted in ``compile_cache_quarantined_total``) and the step is
built live. Entries are written as temp file + fsync + rename, so a
concurrent process reads a whole entry or none. An entry is a pickle of
ints, strings and tuples only (no tensors, no code), under its own
suffix: the reference's ``.xc`` entries in the same directory are never
read, quarantined or evicted here, nor the port's by the reference.

Disabled (``PADDLE_COMPILE_CACHE_DIR`` unset and no read directory) the
module is inert, and runs are bit-identical to a build without it.
"""

import contextlib
import hashlib
import logging
import os
import pickle
import threading
import time

from . import monitor as _monitor

__all__ = [
    "ENV_DIR", "ENV_MAX_BYTES", "ENTRY_SUFFIX", "PRELOWERED_DIRNAME",
    "KERNELS_DIRNAME", "FORMAT_VERSION", "cache_dir", "enabled", "active",
    "override_dir", "program_digest", "step_key", "entry_path", "lookup",
    "save_entry", "prewarm", "disk_hit_count", "quarantine",
]

logger = logging.getLogger(__name__)

ENV_DIR = "PADDLE_COMPILE_CACHE_DIR"
ENV_MAX_BYTES = "PADDLE_COMPILE_CACHE_MAX_BYTES"
ENTRY_SUFFIX = ".tplan"         # one step plan per file
QUARANTINE_SUFFIX = ".quarantined"
PRELOWERED_DIRNAME = "__prelowered__"   # model-adjacent read-only tier
KERNELS_DIRNAME = "kernels"             # a tier's kernel libraries
# Bump on any incompatible change to the entry layout: old entries then
# miss via the key hash AND fail the format check.
FORMAT_VERSION = 1

# -- monitor series (the reference's) -----------------------------------------
_M_DISK_HIT = _monitor.counter(
    "executor_compile_cache_disk_hit_total",
    help="steps served from an on-disk entry: its plan loaded and every "
         "kernel library it names loaded, no nvcc (the restart and "
         "cold-start fast path)")
_M_DISK_MISS = _monitor.counter(
    "executor_compile_cache_disk_miss_total",
    help="disk-tier lookups that found no loadable entry (or not its "
         "libraries) and built the step live (counted only when a "
         "cache tier is configured)")
_M_HIT_TIER_DISK = _monitor.counter(
    "executor_compile_cache_hit_total",
    help="compile-cache hits by tier",
    labels={"tier": "disk"})
_M_MISS_TIER_DISK = _monitor.counter(
    "executor_compile_cache_miss_total",
    help="compile-cache misses by tier",
    labels={"tier": "disk"})
_M_LOAD_SECONDS = _monitor.histogram(
    "compile_cache_load_seconds",
    help="wall time to read one cache entry and load its libraries "
         "(what a restart pays INSTEAD of a build)")
_M_SAVE_SECONDS = _monitor.histogram(
    "compile_cache_save_seconds",
    help="wall time to write one cache entry and store its libraries "
         "(paid once per live build when the cache is enabled)")
_M_QUARANTINED = _monitor.counter(
    "compile_cache_quarantined_total",
    help="corrupted/truncated/unloadable cache entries and kernel "
         "libraries renamed aside (the run built live — never fatal)")
_M_EVICTED = _monitor.counter(
    "compile_cache_evicted_total",
    help="cache entries deleted by LRU-by-mtime eviction "
         "(PADDLE_COMPILE_CACHE_MAX_BYTES)")
_M_PREWARMED = _monitor.counter(
    "compile_cache_prewarmed_total",
    help="entries validated and paged in by compile_cache.prewarm "
         "(restore_on_restart)")

_DIR_OVERRIDE = None


# -- configuration ------------------------------------------------------------
def cache_dir():
    """The read-write cache directory, or None when the cache is off.
    ``override_dir`` (the ``save_inference_model(prelower=True)`` path)
    beats the ``PADDLE_COMPILE_CACHE_DIR`` environment variable."""
    if _DIR_OVERRIDE is not None:
        return _DIR_OVERRIDE
    return os.environ.get(ENV_DIR) or None


def enabled():
    return cache_dir() is not None


def active(read_dirs=None):
    """True when any tier could serve or store an entry: the env/override
    write dir, or a read-only dir list (a Predictor's model-adjacent
    ``__prelowered__`` directory works without the env var)."""
    return enabled() or bool(read_dirs)


def max_cache_bytes():
    v = os.environ.get(ENV_MAX_BYTES)
    try:
        return int(v) if v else None
    except ValueError:
        logger.warning("ignoring non-integer %s=%r", ENV_MAX_BYTES, v)
        return None


@contextlib.contextmanager
def override_dir(dirname):
    """Temporarily route the cache at ``dirname`` regardless of the
    environment: ``save_inference_model(prelower=True)`` uses this to
    drop entries and libraries next to the model."""
    global _DIR_OVERRIDE
    prev = _DIR_OVERRIDE
    _DIR_OVERRIDE = dirname
    try:
        yield
    finally:
        _DIR_OVERRIDE = prev


# -- keying -------------------------------------------------------------------
def _env_fingerprint(device):
    """Everything that invalidates an entry without the program
    changing: the format, torch and CUDA versions, the platform, the
    device's name, compute capability and count, and for libraries on
    the card the nvcc flags and version."""
    import torch

    from ..kernels import _build

    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        dev = (torch.cuda.get_device_name(index),
               tuple(torch.cuda.get_device_capability(index)),
               torch.cuda.device_count(),
               tuple(_build.NVCC_FLAGS), _build.nvcc_version())
    else:
        dev = (device.type, None, 1, None, None)
    return (FORMAT_VERSION, torch.__version__, torch.version.cuda,
            device.type) + dev


def program_digest(program):
    """Content hash of the program desc (structure + random_seed), cached
    per mutation counter so repeated key computations don't re-serialize
    the whole desc."""
    cached = getattr(program, "_compile_cache_digest", None)
    if cached is not None and cached[0] == program._mutation:
        return cached[1]
    digest = hashlib.sha256(program.serialize_to_string()).hexdigest()
    program._compile_cache_digest = (program._mutation, digest)
    return digest


def step_key(program, feed_sig, fetch_names, state_names, iters, donate,
             device):
    """Disk key for one step: the executor's in-memory step key with the
    process-local ``Program._uid`` replaced by the content digest, plus
    the environment fingerprint of ``device``. A hex string (the entry's
    file name stem)."""
    parts = (
        _env_fingerprint(device),
        program_digest(program),
        tuple(feed_sig),
        tuple(fetch_names),
        tuple(state_names),
        int(iters),
        bool(donate),
    )
    return hashlib.sha256(repr(parts).encode("utf-8")).hexdigest()


def entry_path(dirname, key):
    return os.path.join(dirname, key + ENTRY_SUFFIX)


def _plain(obj):
    """Whether ``obj`` is plain data: None, bools, ints, strings, and
    tuples or string-keyed dicts of them."""
    if obj is None or isinstance(obj, (bool, int, str)):
        return True
    if isinstance(obj, tuple):
        return all(_plain(x) for x in obj)
    if isinstance(obj, dict):
        return all(isinstance(k, str) and _plain(v) for k, v in obj.items())
    return False


class _PlainUnpickler(pickle.Unpickler):
    """Refuses every global: an entry holds plain data, never an object
    or code to import."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            "cache entries hold plain data only, not %s.%s" % (module, name))


# -- entry I/O ----------------------------------------------------------------
def quarantine(path):
    """Rename a bad entry or library aside (never delete: the bytes are
    evidence) so the next lookup misses instead of re-tripping on it."""
    try:
        os.replace(path, path + QUARANTINE_SUFFIX)
    except OSError:
        # a racing process already moved/removed it — equally gone
        pass
    _M_QUARANTINED.inc()


def _read_entry(path):
    """The entry dict at ``path``; raises on any malformed content."""
    with open(path, "rb") as f:
        blob = f.read()
    import io as _bytes_io

    entry = _PlainUnpickler(_bytes_io.BytesIO(blob)).load()
    if not isinstance(entry, dict) or \
            entry.get("format") != FORMAT_VERSION or \
            not isinstance(entry.get("plan"), dict) or \
            not isinstance(entry.get("libraries"), tuple) or \
            not _plain(entry):
        raise ValueError("unrecognized cache entry layout")
    for lib in entry["libraries"]:
        if not (isinstance(lib, tuple) and len(lib) == 3
                and all(isinstance(x, str) for x in lib)):
            raise ValueError("malformed library record %r" % (lib,))
    return entry


def _atomic_write_bytes(path, blob):
    """Temporary file + fsync + rename. The temporary's name carries the
    thread as well as the process (``io._atomic_write_bytes``' does not):
    two executors of one process may miss the same key at once."""
    tmp = "%s.%d.%d.tmp" % (path, os.getpid(), threading.get_ident())
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def lookup(key, read_dirs=None, validate=None):
    """The step for ``key`` from the first tier that serves it: each read
    dir, then the write dir. An entry that does not load (or that
    ``validate(plan)`` rejects by raising) is quarantined. Its libraries
    load from the tiers' ``kernels/`` (``_build.preload``); when one is
    missing or differs, the lookup is a miss (the step builds live, its
    libraries with ``nvcc``). A hit served by a read-only tier is copied
    into the write dir, libraries too, so the next process finds it
    there. Returns ``validate(plan)`` (the plan dict without one), or
    None on a miss; counts the disk hit or miss. Inert (None, nothing
    counted) with no tier."""
    from ..kernels import _build

    write_dir = cache_dir()
    dirs = list(read_dirs or [])
    if write_dir and write_dir not in dirs:
        dirs.append(write_dir)
    if not dirs:
        return None
    t0 = time.perf_counter()
    lib_dirs = [os.path.join(d, KERNELS_DIRNAME) for d in dirs]
    for d in dirs:
        path = entry_path(d, key)
        if not os.path.exists(path):
            continue
        try:
            entry = _read_entry(path)
            plan = entry["plan"] if validate is None \
                else validate(entry["plan"])
        except Exception as e:
            logger.warning("compile cache entry %s is unloadable (%s: %s); "
                           "quarantining and building live",
                           path, type(e).__name__, e)
            quarantine(path)
            continue
        if not all(_build.preload(stem, name, sha, lib_dirs)
                   for stem, name, sha in entry["libraries"]):
            logger.warning("compile cache entry %s names a kernel library "
                           "no tier holds intact; building live", path)
            break
        try:
            # LRU-by-mtime: a hit is a use
            os.utime(path, None)
        except OSError:
            pass
        _M_DISK_HIT.inc()
        _M_HIT_TIER_DISK.inc()
        _M_LOAD_SECONDS.observe(time.perf_counter() - t0)
        if write_dir and d != write_dir:
            save_entry(write_dir, key, entry["plan"],
                       [stem for stem, _, _ in entry["libraries"]],
                       label=entry.get("label", ""))
        return plan
    _M_DISK_MISS.inc()
    _M_MISS_TIER_DISK.inc()
    return None


def save_entry(dirname, key, plan, stems, label=""):
    """Store the libraries of ``stems`` under ``<dirname>/kernels/`` and
    write the entry (plan + their names and sha256) atomically;
    best-effort (a full disk or permission error costs the NEXT process
    a build, never this run)."""
    from ..kernels import _build

    t0 = time.perf_counter()
    try:
        libs = tuple((stem,) + _build.store(
            stem, os.path.join(dirname, KERNELS_DIRNAME))
            for stem in sorted(stems))
        entry = {"format": FORMAT_VERSION, "label": str(label),
                 "plan": plan, "libraries": libs}
        if not _plain(entry):
            raise TypeError("a cache entry must be plain data")
        blob = pickle.dumps(entry, protocol=pickle.HIGHEST_PROTOCOL)
        os.makedirs(dirname, exist_ok=True)
        _atomic_write_bytes(entry_path(dirname, key), blob)
    except Exception as e:
        logger.warning("compile cache save under %s failed (%s: %s); "
                       "continuing uncached", dirname, type(e).__name__, e)
        return False
    _M_SAVE_SECONDS.observe(time.perf_counter() - t0)
    _evict(dirname)
    return True


def _evict(dirname, budget=None):
    """Delete oldest-mtime entries until the dir fits the byte budget
    (``PADDLE_COMPILE_CACHE_MAX_BYTES``; None/0 = unbounded), then the
    libraries under ``kernels/`` that no entry left in the dir names."""
    budget = max_cache_bytes() if budget is None else budget
    if not budget:
        return 0
    entries = []
    try:
        names = os.listdir(dirname)
    except OSError:
        return 0
    for fn in names:
        if not fn.endswith(ENTRY_SUFFIX):
            continue
        p = os.path.join(dirname, fn)
        try:
            st = os.stat(p)
        except OSError:
            continue
        entries.append((st.st_mtime, st.st_size, p))
    total = sum(sz for _, sz, _ in entries)
    entries.sort()
    evicted = 0
    kept = []
    for mtime, sz, p in entries:
        if total <= budget:
            kept.append(p)
            continue
        try:
            os.remove(p)
        except OSError:
            continue
        total -= sz
        evicted += 1
        _M_EVICTED.inc()
    if evicted:
        _drop_orphan_libraries(dirname, kept)
    return evicted


def _drop_orphan_libraries(dirname, entry_paths):
    named = set()
    for p in entry_paths:
        try:
            named.update(name for _, name, _ in _read_entry(p)["libraries"])
        except Exception:
            return  # cannot tell what is named: keep every library
    kdir = os.path.join(dirname, KERNELS_DIRNAME)
    try:
        files = os.listdir(kdir)
    except OSError:
        return
    for fn in files:
        if fn.endswith(".so") and fn not in named:
            for victim in (fn, fn + ".sha256"):
                try:
                    os.remove(os.path.join(kdir, victim))
                except OSError:
                    pass


# -- pre-warm (restart path) --------------------------------------------------
def prewarm(dirname=None):
    """Validate + page in every entry under ``dirname`` (default: the
    configured cache dir) and every library under its ``kernels/``:
    ``restore_on_restart`` calls it, so a restarted worker finds entries
    hot in the page cache and corrupt ones (and libraries whose sha256
    differs from their sidecar) already quarantined, instead of
    discovering both inside the downtime window. Loads nothing onto the
    device. Returns the number of valid entries."""
    from ..kernels import _build

    dirname = dirname or cache_dir()
    if not dirname or not os.path.isdir(dirname):
        return 0
    ok = 0
    for fn in sorted(os.listdir(dirname)):
        if not fn.endswith(ENTRY_SUFFIX):
            continue
        path = os.path.join(dirname, fn)
        try:
            _read_entry(path)
        except Exception as e:
            logger.warning("prewarm: quarantining bad cache entry %s "
                           "(%s: %s)", path, type(e).__name__, e)
            quarantine(path)
            continue
        ok += 1
        _M_PREWARMED.inc()
    kdir = os.path.join(dirname, KERNELS_DIRNAME)
    if os.path.isdir(kdir):
        for fn in sorted(os.listdir(kdir)):
            path = os.path.join(kdir, fn)
            want = _build._expected_sha(path) if fn.endswith(".so") \
                else None
            if want is not None and _build.sha256_file(path) != want:
                logger.warning("prewarm: quarantining kernel library %s "
                               "(sha256 differs from its sidecar)", path)
                quarantine(path)
    return ok


def disk_hit_count():
    """Current value of the disk-hit counter (serving warm-up snapshots
    it around the ladder to report how many builds a restart skipped)."""
    return _M_DISK_HIT.value
