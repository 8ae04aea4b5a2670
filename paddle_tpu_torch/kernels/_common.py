"""Shared kernel plumbing: device resolution, the CUDA build, launch counts.

Counterpart of ``paddle_tpu/kernels/_common.py`` (which selects Pallas
interpret mode off-TPU).  Here a kernel wrapper takes its plain PyTorch
version only for a tensor that lies on the CPU; for a CUDA tensor it
launches the kernel or raises.

The kernels are CUDA C++ for ``sm_90a`` under ``csrc/``.  At first use each
source is compiled by its own ``nvcc`` (all started together), the objects
are linked into one shared library with a plain C interface, and the library
is loaded with ``ctypes``.  The library's name carries a hash of the sources
and flags, so an edited kernel is rebuilt and an unchanged one is reused.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["resolve_device", "same_pads", "launches", "reset_launches",
           "count_launch", "stream_ptr",
           "load_library", "build_info", "check_status", "dtype_code",
           "ROUTE_CODES"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(os.environ.get(
    "PADDLE_TPU_TORCH_BUILD_DIR",
    Path(__file__).resolve().parent.parent.parent / "build" / "kernels"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Without a card, only an explicit CPU request is accepted."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but no CUDA device is "
                           "available" % device)
    return device


def same_pads(size, k, stride):
    """XLA's "SAME" padding of one spatial axis: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


# -- launch counts ---------------------------------------------------------
# One count per kernel wrapper, raised where the wrapper launches its CUDA
# kernel and nowhere else: a run can show the main path went through it.
launches = {
    "layer_norm_fwd": 0,
    "layer_norm_bwd": 0,
    "flash_attention_fwd": 0,
    "flash_attention_bwd": 0,
    "bn_stats": 0,
    "bn_scale_shift": 0,
    "bn_bwd_reduce": 0,
    "bn_dx": 0,
    "segment_sum": 0,
    "conv_wgrad": 0,
}


def reset_launches():
    for k in launches:
        launches[k] = 0


def count_launch(name):
    launches[name] += 1


# -- build -----------------------------------------------------------------

_lock = threading.Lock()
_lib = None
build_info = {}   # filled by load_library: seconds, path, ptxas summary


def _nvcc():
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA toolkit's "
                       "bin directory on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_path):
    """Compile every source in parallel (one nvcc each), then link."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, obj, p in procs:
            out, _ = p.communicate()
            logs.append(out)
            if p.returncode != 0:
                failed.append("%s:\n%s" % (src.name, out))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / out_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so)] + [str(o) for _, o, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_so, out_path)
    log = "".join(logs)
    (out_path.with_suffix(".log")).write_text(log)
    return time.perf_counter() - t0, log


def _ptxas_summary(log):
    """The ``ptxas info`` lines: registers and shared memory per kernel, and
    each kernel's stack and spill line."""
    return [ln.strip() for ln in log.splitlines()
            if ("ptxas info" in ln and ("Used" in ln or "Compiling" in ln))
            or "spill stores" in ln]


def load_library():
    """Build (once, keyed by the sources' hash) and load the kernels."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = BUILD_DIR / ("libpaddle_tpu_torch_%s.so" % _source_hash())
        if path.exists():
            secs, log = 0.0, (path.with_suffix(".log").read_text()
                              if path.with_suffix(".log").exists() else "")
        else:
            secs, log = _build(path)
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        build_info.update(seconds=secs, path=str(path),
                          ptxas=_ptxas_summary(log))
        _lib = lib
        return lib


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
_SIGNATURES = {
    # x, scale, bias, y, mu, rstd, N, E, eps, dtype, stream
    "ptt_layer_norm_fwd": [_P, _P, _P, _P, _P, _P, _L, _I, _F, _I, _P],
    # x, scale, dy, mu, rstd, dx, scratch, out, done,
    # N, E, n_blocks, dtype, route, stream
    "ptt_layer_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _L, _I, _I, _I, _I, _P],
    # E, dtype, route
    "ptt_layer_norm_bwd_blocks_per_sm": [_I, _I, _I],
    # q, k, v, o, lse, B, H, Sq, Sk, D, scale, causal, route, stream
    "ptt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    # q, k, v, o, do, lse, delta, dq, dk, dv,
    # B, H, Sq, Sk, D, scale, causal, dtype, route, stream
    "ptt_flash_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    # x, scratch, counters, out, M, C, tx, rows_per_block, nblk, group, vec,
    # dtype, stream
    "ptt_bn_stats": [_P, _P, _P, _P, _L, _I, _I, _L, _I, _I, _I, _I, _P],
    # x, a, b, y, M, C, tx, nblk, vec, dtype, stream
    "ptt_bn_scale_shift": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    # dy, x, scratch, counters, out, M, C, tx, rows_per_block, nblk, group,
    # vec, dtype, stream
    "ptt_bn_bwd_reduce": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _I, _I, _I, _I,
                          _P],
    # dy, x, coefs, dx, M, C, tx, nblk, vec, dtype, stream
    "ptt_bn_dx": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    # keys, order, values, out, out_rows, scratch, runs, N, D, height,
    # key64, dtype, stream
    "ptt_segment_sum": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _P],
    # x, dy, partial, dw, B, H, W, C, K, k, pad, splits, per_split, dtype,
    # route, stream
    "ptt_conv_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _L,
                       _I, _I, _P],
    # route
    "ptt_conv_wgrad_blocks_per_sm": [_I],
}


def _declare(lib):
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int


def check_status(name, status):
    """Raise on a non-zero ``cudaGetLastError()`` from a C launcher."""
    if status != 0:
        raise RuntimeError("%s: CUDA launch failed with error %d" %
                           (name, status))


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# a kernel's two routes, as its C entry numbers them: f32 FMAs on the CUDA
# cores, or bf16 products on the tensor cores
ROUTE_CODES = {"fma": 0, "mma": 1}


def dtype_code(dtype, what):
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError("%s: dtype %s not supported (float32 or bfloat16)"
                        % (what, dtype)) from None


def stream_ptr(device):
    return torch.cuda.current_stream(device).cuda_stream
