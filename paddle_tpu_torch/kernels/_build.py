"""Build the hand-written CUDA kernels, or find them built, and bind them.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, which ``ctypes``
loads. Nothing here runs at import. A library's file name carries a hash
of its source and flags, so an edited source is never matched by a stale
library. ``library(stem)`` finds ``csrc/<stem>.cu``'s library in this
order:

1. already loaded in this process;
2. the read tiers: each registered directory (``add_read_dir``; a
   ``Predictor`` registers its model's ``__prelowered__/kernels/``), then
   ``$PADDLE_COMPILE_CACHE_DIR/kernels/``. A file there is loaded only
   when its sha256 equals its ``<name>.sha256`` sidecar; one that
   differs (truncated, overwritten) or that ``ctypes`` refuses is
   renamed aside (``.quarantined``, counted in
   ``compile_cache_quarantined_total``) and never loaded;
3. ``_build/`` beside this module (``$PADDLE_KERNEL_BUILD_DIR`` moves
   it);
4. only then ``nvcc``, into ``$PADDLE_COMPILE_CACHE_DIR/kernels/`` when
   the compile cache is on (the ``fluid.compile_cache`` write directory,
   ``save_inference_model(prelower=True)``'s ``__prelowered__/`` while it
   exports), else into ``_build/``.

``build_all()`` finds or builds every source at once (one ``nvcc`` per
missing file, all started together). ``nvcc_runs`` counts the ``nvcc``
processes this process started. Every write is a temporary file renamed
into place, so a concurrent process sees a whole library or none. A
missing compiler or a failed build raises; there is no fallback.
"""

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
ENV_BUILD_DIR = "PADDLE_KERNEL_BUILD_DIR"
BUILD_DIR = os.environ.get(ENV_BUILD_DIR) or os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS_DIRNAME = "kernels"      # a cache tier's library subdirectory
SHA_SUFFIX = ".sha256"

_LOCK = threading.RLock()
_LIBS = {}             # stem -> ctypes.CDLL
_PATHS = {}            # stem -> the file it was loaded from
_READ_DIRS = []        # registered read tiers, in lookup order
_RECORDING = threading.local()
_NVCC_VERSION = []

# nvcc processes started by this process, and the wall seconds spent
# waiting for them (read by tests and the smoke)
nvcc_runs = 0
nvcc_seconds = 0.0


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc():
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the one
    on ``PATH``, else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels cannot be built")


def nvcc_version():
    """The last line of ``nvcc --version`` (None without a compiler);
    part of the compile cache's key for steps on the card. Read once."""
    if not _NVCC_VERSION:
        try:
            out = subprocess.run([nvcc(), "--version"], capture_output=True,
                                 text=True, timeout=60).stdout
            lines = [ln for ln in out.splitlines() if ln.strip()]
            _NVCC_VERSION.append(lines[-1] if lines else None)
        except (BuildError, OSError, subprocess.SubprocessError):
            _NVCC_VERSION.append(None)
    return _NVCC_VERSION[0]


def _source(stem):
    return os.path.join(CSRC_DIR, stem + ".cu")


def lib_name(stem):
    """The file name of ``csrc/<stem>.cu``'s library: the stem and a hash
    of the source and the flags."""
    with open(_source(stem), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return "lib%s-%s.so" % (stem, digest.hexdigest()[:16])


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# -- tiers ----------------------------------------------------------------------
def add_read_dir(dirname):
    """Register a read tier (a ``__prelowered__/kernels/`` directory);
    idempotent."""
    with _LOCK:
        if dirname not in _READ_DIRS:
            _READ_DIRS.append(dirname)


def write_dir():
    """Where new builds land when the compile cache is on, else None."""
    from ..fluid import compile_cache

    d = compile_cache.cache_dir()
    return os.path.join(d, KERNELS_DIRNAME) if d else None


def read_dirs():
    """The read tiers in lookup order: the registered directories, then
    the compile cache's ``kernels/``."""
    out = list(_READ_DIRS)
    w = write_dir()
    if w and w not in out:
        out.append(w)
    return out


def quarantine(path):
    """Rename a bad library aside (the bytes are evidence) and count it
    in ``compile_cache_quarantined_total``."""
    from ..fluid import compile_cache

    compile_cache.quarantine(path)


def _expected_sha(path):
    try:
        with open(path + SHA_SUFFIX) as f:
            return f.read().strip() or None
    except OSError:
        return None


def _load_verified(path, sha=None):
    """Load ``path`` when its sha256 equals ``sha`` (default: its
    sidecar's); a file that differs or that ``ctypes`` refuses is
    quarantined. Returns the CDLL or None (also when the file or its
    sidecar is not there yet: a racing writer renames the library in
    before its sidecar)."""
    if not os.path.exists(path):
        return None
    want = sha or _expected_sha(path)
    if want is None:
        return None
    try:
        ok = sha256_file(path) == want
    except OSError:
        return None
    if not ok:
        quarantine(path)
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        quarantine(path)
        return None


def _atomic_copy(src, dst):
    tmp = "%s.%d.%d.tmp" % (dst, os.getpid(), threading.get_ident())
    shutil.copyfile(src, tmp)
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, dst)


def _write_sidecar(path, sha):
    tmp = "%s%s.%d.%d.tmp" % (path, SHA_SUFFIX, os.getpid(),
                              threading.get_ident())
    with open(tmp, "w") as f:
        f.write(sha + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path + SHA_SUFFIX)


def store(stem, dirname):
    """Copy the loaded library of ``stem`` into ``dirname`` (a tier's
    ``kernels/``) with its sha256 sidecar, unless a copy with a sidecar
    is there already (names are content hashes: it is never overwritten,
    so a reader never sees a library beside another's sidecar). Returns
    (file name, sha256 of the stored copy)."""
    with _LOCK:
        src = _PATHS[stem]
    name = os.path.basename(src)
    dst = os.path.join(dirname, name)
    have = _expected_sha(dst)
    if have is not None and os.path.exists(dst):
        return name, have
    sha = sha256_file(src)
    if os.path.abspath(dst) != os.path.abspath(src):
        os.makedirs(dirname, exist_ok=True)
        _atomic_copy(src, dst)
    _write_sidecar(dst, sha)
    return name, sha


def loaded_from(stem):
    """The file ``stem``'s library was loaded from, or None."""
    return _PATHS.get(stem)


def preload(stem, name, sha, dirs):
    """Load ``stem``'s library from ``dirs`` as a compile-cache entry
    names it: the file ``name`` with sha256 ``sha``. False when the name
    is not the library this source builds today (an edited source), or
    no intact copy is there (a copy that differs is quarantined); no
    ``nvcc`` runs either way."""
    if name != lib_name(stem):
        return False
    with _LOCK:
        if stem in _LIBS:
            return os.path.basename(_PATHS[stem]) == name
        for d in dirs:
            path = os.path.join(d, name)
            lib = _load_verified(path, sha)
            if lib is not None:
                _LIBS[stem], _PATHS[stem] = lib, path
                return True
        return False


# -- use records ----------------------------------------------------------------
@contextlib.contextmanager
def record_uses():
    """Collect the stems whose library this thread asks for in the body
    (the executor records a step's warm run, so its compile-cache entry
    names the libraries the step launches)."""
    stack = getattr(_RECORDING, "stack", None)
    if stack is None:
        stack = _RECORDING.stack = []
    used = set()
    stack.append(used)
    try:
        yield used
    finally:
        stack.remove(used)


# -- building -------------------------------------------------------------------
def _build(stems, dst_dir):
    """Compile ``csrc/<stem>.cu`` for each stem into ``dst_dir``, in
    parallel. Returns {stem: library path}. Compiler output (``-Xptxas
    -v`` register and shared-memory report) is kept in
    ``_build/<stem>.log``."""
    global nvcc_runs, nvcc_seconds
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    os.makedirs(dst_dir, exist_ok=True)
    exe = nvcc()
    procs = []
    for stem in stems:
        dst = os.path.join(dst_dir, lib_name(stem))
        tmp = "%s.%d.tmp" % (dst, os.getpid())
        log = open(os.path.join(BUILD_DIR, stem + ".log"), "w")
        procs.append((stem, dst, tmp, log, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", tmp, _source(stem)], stdout=log,
            stderr=subprocess.STDOUT)))
        nvcc_runs += 1
    failed, out = [], {}
    for stem, dst, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            sha = sha256_file(tmp)
            os.replace(tmp, dst)
            _write_sidecar(dst, sha)
            out[stem] = dst
        else:
            with open(log.name) as f:
                failed.append("%s (nvcc exit %d):\n%s" % (stem, rc, f.read()))
    nvcc_seconds += time.perf_counter() - t0
    if failed:
        raise BuildError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def _find(stem):
    """A loadable library of ``stem`` in the read tiers or ``_build/``,
    loaded: (CDLL, path), or None."""
    name = lib_name(stem)
    for d in read_dirs():
        path = os.path.join(d, name)
        lib = _load_verified(path)
        if lib is not None:
            return lib, path
    path = os.path.join(BUILD_DIR, name)
    if os.path.exists(path):
        return ctypes.CDLL(path), path
    return None


def _ensure(stems):
    """Load every stem in ``stems`` (under ``_LOCK``): from a tier, else
    built, all missing ones with one ``nvcc`` each in parallel."""
    todo = []
    for stem in stems:
        if stem in _LIBS:
            continue
        found = _find(stem)
        if found is None:
            todo.append(stem)
        else:
            _LIBS[stem], _PATHS[stem] = found
    if todo:
        for stem, path in _build(todo, write_dir() or BUILD_DIR).items():
            _LIBS[stem], _PATHS[stem] = ctypes.CDLL(path), path


def build_all():
    """Find or build every source's library, the missing ones in
    parallel, and load them. Returns {source stem: library path}."""
    stems = [os.path.splitext(os.path.basename(s))[0] for s in sources()]
    with _LOCK:
        _ensure(stems)
        return {s: _PATHS[s] for s in stems}


def loaded(stem):
    """Whether ``library(stem)`` has been loaded already."""
    return stem in _LIBS


def library(stem):
    """The loaded ``ctypes.CDLL`` of ``csrc/<stem>.cu`` (module
    docstring: the lookup order)."""
    for used in getattr(_RECORDING, "stack", ()):
        used.add(stem)
    lib = _LIBS.get(stem)
    if lib is not None:
        return lib
    if not os.path.exists(_source(stem)):
        raise BuildError("no CUDA source csrc/%s.cu" % stem)
    with _LOCK:
        _ensure([stem])
        return _LIBS[stem]
