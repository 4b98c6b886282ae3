"""Build the hand-written CUDA kernels at first use and bind them.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, which ``ctypes``
loads. Nothing here runs at import: the first CUDA launch calls
``library(name)``, which builds every source at once (one ``nvcc`` per
file, all started together) into ``_build/`` beside this module. A
library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a stale one is never loaded. A missing compiler or
a failed build raises; there is no fallback.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}


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


def _target(src):
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (stem,
                                                    digest.hexdigest()[:16]))


def sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build_all():
    """Compile every source whose library is missing, in parallel.
    Returns {source stem: library path}. Each build writes a temporary
    file and renames it into place, so a concurrent process never loads
    a half-written library. Compiler output (``-Xptxas -v`` register and
    shared-memory report) is kept in ``_build/<stem>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo, out = [], {}
    for src in sources():
        stem = os.path.splitext(os.path.basename(src))[0]
        out[stem] = _target(src)
        if not os.path.exists(out[stem]):
            todo.append((stem, src, out[stem]))
    if not todo:
        return out
    exe = nvcc()
    procs = []
    for stem, src, dst in todo:
        tmp = "%s.%d.tmp" % (dst, os.getpid())
        log = open(os.path.join(BUILD_DIR, stem + ".log"), "w")
        procs.append((stem, dst, tmp, log, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", tmp, src], stdout=log,
            stderr=subprocess.STDOUT)))
    failed = []
    for stem, dst, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, dst)
        else:
            with open(log.name) as f:
                failed.append("%s (nvcc exit %d):\n%s" % (stem, rc, f.read()))
    if failed:
        raise BuildError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def loaded(stem):
    """Whether ``library(stem)`` has been built and loaded already."""
    return stem in _LIBS


def library(stem):
    """The loaded ``ctypes.CDLL`` built from ``csrc/<stem>.cu``."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            paths = build_all()
            if stem not in paths:
                raise BuildError("no CUDA source csrc/%s.cu" % stem)
            lib = _LIBS[stem] = ctypes.CDLL(paths[stem])
        return lib
