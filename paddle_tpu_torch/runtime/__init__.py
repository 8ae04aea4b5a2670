"""Native runtime extensions (C++), loaded with ctypes: the port's own
builds of ``datafeed.cc``, the MultiSlot parser and bounded channel behind
``dataset.py``, and ``capi.cc``, the C inference API over an embedded
CPython (counterpart of the JAX package's ``runtime/__init__.py``).

A library is compiled at first use with ``g++ -O3 -shared -fPIC -pthread``
(``capi`` also with this interpreter's include and ``-lpython`` flags)
into the ignored ``build/runtime/`` beside the kernels' ``build/kernels/``,
under a name that carries a hash of its source, its header and its flags,
so an edited source is rebuilt and an unchanged one is reused.  The
sources here are the port's copies; the JAX package's sources and ``.so``
files are never read.

``PADDLE_TPU_NO_NATIVE=1`` selects the pure-Python parser (``load`` returns
None), as in the reference.  Otherwise a failed build raises with the
compiler's output: the data path never falls back to Python quietly.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["load", "library_path", "build_info", "BUILD_DIR"]

HERE = Path(__file__).resolve().parent
BUILD_DIR = Path(os.environ.get(
    "PADDLE_TPU_TORCH_RUNTIME_DIR",
    HERE.parent.parent / "build" / "runtime"))
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_build_lock = threading.Lock()
_cache = {}
# name -> {"path", "seconds" (build, or 0.0 when reused), "built"}
build_info = {}


def _python_flags():
    """Include and link flags for a library that embeds CPython (capi.cc):
    this interpreter's headers, and its shared ``libpython`` where it has
    one (what a plain C program needs).  An interpreter built without one
    exports the C API from its own executable, so inside a Python process
    the library resolves against that and links nothing."""
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = (sysconfig.get_config_var("LDVERSION")
           or sysconfig.get_config_var("VERSION"))
    shared = os.path.join(libdir, "libpython%s.so" % ver)
    if not (sysconfig.get_config_var("Py_ENABLE_SHARED")
            and os.path.exists(shared)):
        return ["-I" + inc], []
    return (["-I" + inc],
            ["-L" + libdir, "-Wl,-rpath," + libdir, "-lpython%s" % ver])


def _flags(name):
    """(compile flags, link flags) of ``name``."""
    if name == "capi":
        cflags, ldflags = _python_flags()
        return CXX_FLAGS + cflags, ldflags
    return list(CXX_FLAGS), []


def library_path(name):
    """Where the build of ``name``'s current source lives."""
    src = HERE / (name + ".cc")
    hdr = HERE / (name + ".h")
    cflags, ldflags = _flags(name)
    h = hashlib.sha256(" ".join(cflags + ldflags).encode())
    h.update(src.read_bytes())
    if hdr.exists():
        h.update(hdr.read_bytes())
    return BUILD_DIR / ("lib%s_%s.so" % (name, h.hexdigest()[:16]))


def _build(name):
    so = library_path(name)
    if so.exists():
        return so, 0.0, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # a private temp name, then an atomic rename: two processes building
    # the same source never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cflags, ldflags = _flags(name)
        r = subprocess.run(["g++", *cflags, str(HERE / (name + ".cc")),
                            "-o", tmp, *ldflags],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("building the native %s library failed:\n%s"
                               % (name, r.stderr))
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, time.perf_counter() - t0, True


def load(name):
    """The native library ``name`` as a ``ctypes.CDLL``, built on first
    use; None when ``PADDLE_TPU_NO_NATIVE`` is set.  Raises when the build
    or the load fails."""
    if os.environ.get("PADDLE_TPU_NO_NATIVE"):
        return None
    with _build_lock:
        if name in _cache:
            return _cache[name]
        t0 = time.perf_counter()
        path, build_s, built = _build(name)
        lib = ctypes.CDLL(str(path))
        build_info[name] = {"path": str(path), "built": built,
                            "build_s": build_s,
                            "build_or_load_s": time.perf_counter() - t0}
        _cache[name] = lib
        return lib
