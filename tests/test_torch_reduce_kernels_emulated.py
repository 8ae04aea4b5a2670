"""The one-launch reduction kernels of ``csrc/segment_update.cu``
(``segsum_kernel``), ``csrc/layer_norm.cu`` (``ln_bwd_vec_kernel``,
``ln_bwd_scalar_kernel``) and ``csrc/fused_bn.cu`` (``bn_stats_kernel``,
``bn_bwd_reduce_kernel``) run on the CPU and held to the plain versions in
``kernels/segment_update.py``, ``kernels/layer_norm.py`` and
``kernels/fused_bn.py``.

``g++`` builds each CUDA source against the stand-in headers in
``tests/cuda_emu/``, which run a block as one fiber per CUDA thread on one
OS thread, each warp running on until its barriers stop it (warp shuffles
through per-warp slots between barriers; ``atomicAdd`` and
``__threadfence`` as host atomics).  One OS thread keeps each case's time
near its CPU time on a loaded machine: the widest take about 5 s.  Blocks run one after another, in order,
reversed or shuffled (by the case's size), so the block that takes a
counter's last ticket, and adds up what the others left, is the last, the
first or one in the middle, as any may be on the card.  That checks the tiles' bookkeeping
(runs crossing one or many tile edges, ragged last tiles, rows wider than
the segment kernel's 32 columns, the fold of the blocks' partial sums, the
batch-norm kernels' channel tiles and ragged row blocks) and that the
counters are back at 0 after a call.  The
speed, the registers and any race the emulation's ordering hides are the
card's to show (``chip_smoke.py``, ``tests/test_torch_kernels_cuda.py``).

Tolerances are the card's (``chip_smoke.py``): values to 1e-4 (f32) or
2e-2 (bf16) of the largest, row ids exactly; two calls give the same bits.
"""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import fused_bn as fbn
from paddle_tpu_torch.kernels import layer_norm as ln
from paddle_tpu_torch.kernels import segment_update as seg

EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = Path(seg.__file__).resolve().parent / "csrc"
TOL_F32, TOL_BF16 = 1e-4, 2e-2
TILE = seg._TILE


def _build(tmp_path_factory, source, program):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    build = tmp_path_factory.mktemp(program)
    for src in (CSRC / source, CSRC / "common.cuh", *EMU.glob("*.h")):
        shutil.copy(src, build)
    exe = build / program
    # -fno-strict-aliasing: the kernels read 16-byte vectors through
    # reinterpret_cast, as CUDA code does; g++ would otherwise drop them
    subprocess.run([gxx, "-std=c++20", "-O2", "-fno-strict-aliasing", "-pthread",
                    "-DPTT_HOST_EMULATION", "-I", str(build), "-o", str(exe),
                    str(EMU / (program + ".cpp"))], check=True,
                   capture_output=True, text=True, timeout=300)
    return exe


@pytest.fixture(scope="module")
def seg_emu(tmp_path_factory):
    return _build(tmp_path_factory, "segment_update.cu", "seg_emu")


@pytest.fixture(scope="module")
def ln_emu(tmp_path_factory):
    return _build(tmp_path_factory, "layer_norm.cu", "ln_emu")


@pytest.fixture(scope="module")
def bn_emu(tmp_path_factory):
    return _build(tmp_path_factory, "fused_bn.cu", "bn_emu")


def _raw(t):
    """A tensor's bytes as numpy (bf16 as its 16 bits)."""
    t = t.contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _load(path, dtype, shape):
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.fromfile(path, dtype=np.int16)).view(
            torch.bfloat16).reshape(shape)
    np_dtype = {torch.float32: np.float32, torch.int32: np.int32,
                torch.int64: np.int64}[dtype]
    return torch.from_numpy(np.fromfile(path, dtype=np_dtype)).reshape(shape)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _order_env(n):
    """The order the emulation runs the grid's blocks in, by size: in order,
    reversed or shuffled, so the block that folds (the last to take a
    ticket) is the grid's last, its first, or one in the middle."""
    return dict(os.environ, PTT_EMU_ORDER=("in", "reverse", "shuffle")[n % 3])


def _ids(case, n, rng):
    if case == "one_id":                      # one run over every tile
        return np.full(n, 7)
    if case == "spanning":
        # a run of 3.5 tiles starting mid-tile, between unique ids, and a
        # run ending exactly at a tile edge
        ids = np.arange(n) * 10
        ids[100:100 + 3 * TILE + 128] = ids[100]
        ids[4 * TILE - 24:4 * TILE] = ids[4 * TILE - 24]
        return ids[rng.permutation(n)]
    if case == "dups":
        return rng.randint(0, 9, n)
    if case == "out_of_range":                # ids < 0 and >= height sort too
        ids = rng.randint(0, 300, n)
        ids[rng.permutation(n)[:5]] = [-3, -1, 1000, 1001, 5000][:min(n, 5)]
        return ids
    return rng.randint(0, 3 * n, n)           # mostly unique


@pytest.mark.parametrize("case,n,d,dtype,key64", [
    ("one_id", 5 * TILE, 11, torch.float32, False),         # 5 tiles, one run
    ("spanning", 5 * TILE + 77, 11, torch.float32, True),   # ragged last tile
    ("dups", 3 * TILE + 1, 8, torch.float32, False),
    ("dups", 700, 8, torch.bfloat16, True),                 # bf16
    ("dups", 2 * TILE, 3, torch.bfloat16, False),
    ("one_id", 36 * TILE + 9, 2, torch.float32, False),     # owner search: 2 rounds
    ("uniform", 1, 11, torch.float32, False),               # N = 1
    ("uniform", TILE + 5, 1, torch.float32, True),          # D = 1
    ("out_of_range", 600, 12, torch.float32, False),
    ("spanning", 5 * TILE + 77, 40, torch.float32, False),  # two column chunks
    ("dups", 600, 37, torch.bfloat16, True),                # two chunks, bf16
    ("one_id", 2 * TILE + 9, 300, torch.bfloat16, False),   # 10 column chunks
    ("spanning", 5 * TILE + 77, 259, torch.float32, False),
])
def test_segment_sum_emulated_matches_plain(seg_emu, tmp_path, case, n, d,
                                            dtype, key64):
    rng = np.random.RandomState(n + d)
    height = 1000
    ids = torch.from_numpy(_ids(case, n, rng).astype(
        np.int64 if key64 else np.int32))
    vals = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dtype)
    keys, order = torch.sort(ids, stable=True)
    _raw(keys).tofile(tmp_path / "keys.bin")
    _raw(order).tofile(tmp_path / "order.bin")
    _raw(vals).tofile(tmp_path / "values.bin")
    subprocess.run([str(seg_emu), str(tmp_path), str(n), str(d),
                    str(int(dtype == torch.bfloat16)), str(int(key64)),
                    str(height), "2"],
                   check=True, capture_output=True, text=True, timeout=120,
                   env=_order_env(n))
    rows_p, out_p = seg.segsum_plain(ids, vals, height)
    outs = [_load(tmp_path / ("out%d.bin" % c), dtype, (n, d)) for c in (0, 1)]
    rows = _load(tmp_path / "rows0.bin", ids.dtype, (n,))
    assert torch.equal(rows, rows_p)
    assert torch.isfinite(outs[0].float()).all()
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    assert _rel(outs[0], out_p) <= tol
    # zeros off the first positions, exactly
    first = torch.ones(n, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    assert not outs[0][~first].float().any()
    # two calls, the same bits; the counter is back at 0
    assert np.array_equal(_raw(outs[0]), _raw(outs[1]))
    assert np.fromfile(tmp_path / "done.bin", dtype=np.uint32)[0] == 0


@pytest.mark.parametrize("N,E,dtype,route,nblk", [
    (50, 768, torch.bfloat16, "vec16", 3),      # BERT's width, ragged rows
    (300, 768, torch.bfloat16, "vec16", 40),    # three groups: two-level fold
    (40, 1024, torch.bfloat16, "vec16", 5),
    (37, 768, torch.float32, "vec16", 4),
    (20, 1024, torch.float32, "vec16", 17),     # a group of one block
    (45, 100, torch.bfloat16, "scalar", 6),     # E off the vector width
    (33, 101, torch.float32, "scalar", 18),     # odd 2E: scalar fold loads
    (9, 768, torch.bfloat16, "scalar", 2),      # the scalar route at 768
])
def test_layer_norm_bwd_emulated_matches_plain(ln_emu, tmp_path, N, E, dtype,
                                               route, nblk):
    rng = np.random.RandomState(N + E)
    x = torch.from_numpy((rng.randn(N, E) * 2 + 1).astype(np.float32)).to(dtype)
    dy = torch.from_numpy(rng.randn(N, E).astype(np.float32)).to(dtype)
    scale = torch.from_numpy((rng.rand(E) + 0.5).astype(np.float32))
    _, mu, rstd = ln.layer_norm_fwd_plain(x.float(), scale, torch.zeros(E),
                                          1e-6)
    if route == "vec16":
        assert ln._bwd_route(x, scale, dy) == "vec16"
    for name, t in (("x", x), ("dy", dy), ("scale", scale), ("mu", mu),
                    ("rstd", rstd)):
        _raw(t).tofile(tmp_path / (name + ".bin"))
    subprocess.run([str(ln_emu), str(tmp_path), str(N), str(E),
                    str(int(dtype == torch.bfloat16)),
                    str(int(route == "vec16")), str(nblk), "2"],
                   check=True, capture_output=True, text=True, timeout=120,
                   env=_order_env(N))
    dx_p, ds_p, db_p = ln.layer_norm_bwd_plain(x.float(), scale, dy.float(),
                                               mu, rstd)
    dxs = [_load(tmp_path / ("dx%d.bin" % c), dtype, (N, E)) for c in (0, 1)]
    outs = [_load(tmp_path / ("out%d.bin" % c), torch.float32, (2, E))
            for c in (0, 1)]
    assert torch.isfinite(dxs[0].float()).all() and torch.isfinite(outs[0]).all()
    assert _rel(dxs[0], dx_p) <= (TOL_BF16 if dtype == torch.bfloat16
                                  else TOL_F32)
    assert _rel(outs[0][0], ds_p) <= TOL_F32
    assert _rel(outs[0][1], db_p) <= TOL_F32
    assert np.array_equal(_raw(dxs[0]), _raw(dxs[1]))
    assert torch.equal(outs[0], outs[1])
    assert np.fromfile(tmp_path / "done.bin", dtype=np.uint32)[0] == 0


@pytest.mark.parametrize("M,C,dtype,nblk,group,route,kernel", [
    (1001, 256, torch.bfloat16, 5, None, "vec16", "stats"),    # 4 tiles, ragged rows
    (1001, 256, torch.bfloat16, 5, None, "vec16", "bwd_reduce"),
    (700, 64, torch.float32, 3, None, "vec16", "stats"),       # f32: 2 tiles of 32
    (700, 64, torch.float32, 3, None, "vec16", "bwd_reduce"),
    (333, 72, torch.bfloat16, 4, None, "vec16", "bwd_reduce"), # last tile 1 vector
    (5, 256, torch.bfloat16, 1, None, "vec16", "stats"),       # M under one block
    (5, 256, torch.float32, 1, None, "vec16", "bwd_reduce"),
    (257, 12, torch.float32, 6, None, "scalar", "stats"),      # C = 12: V = 1
    (257, 12, torch.bfloat16, 6, None, "scalar", "bwd_reduce"),
    (150, 36, torch.bfloat16, 2, None, "scalar", "stats"),     # 2 tiles, last of 4
    (150, 64, torch.float32, 7, None, "scalar", "bwd_reduce"), # V = 1 at a vector width
    (2000, 128, torch.bfloat16, 9, None, "vec16", "stats"),
    (3000, 64, torch.bfloat16, 40, 16, "vec16", "stats"),      # 3 groups: two levels
    (3000, 64, torch.float32, 17, 16, "vec16", "bwd_reduce"),  # a group of one block
    (2000, 256, torch.bfloat16, 20, 6, "vec16_wide", "bwd_reduce"),  # tx 32: 1 tile
    (999, 96, torch.float32, 33, 16, "scalar", "stats"),       # scalar fold, 3 groups
    (4190, 64, torch.bfloat16, 70, None, "vec16", "bwd_reduce"),  # groups of 9
])
def test_bn_reductions_emulated_match_plain(bn_emu, tmp_path, M, C, dtype, nblk,
                                            group, route, kernel):
    """Each case: the two sums against the plain version at chip_smoke.py's
    f32 tolerance, the counters back at 0, and two calls bit for bit.  A
    group smaller than the row blocks takes the two-level fold (each group,
    then the groups); the wrapper's grouping (``_fold_group``) folds up to
    64 row blocks in one level."""
    rng = np.random.RandomState(M + C)
    a = torch.from_numpy((rng.randn(M, C) + 0.5).astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.randn(M, C) * 2).astype(np.float32)).to(dtype)
    tx, vec, tiles = fbn._reduce_layout(a, b)
    if route == "scalar":
        tx, vec = min(32, 1 << (C - 1).bit_length()), 0
    if route == "vec16_wide":             # a tile of 32 vectors, full rows
        tx = 32
    assert vec == route.startswith("vec16")
    rows = -(-M // nblk)
    assert -(-M // rows) == nblk
    group = group or fbn._fold_group(nblk)
    two = kernel == "bwd_reduce"
    _raw(a).tofile(tmp_path / "a.bin")
    _raw(b).tofile(tmp_path / "b.bin")
    subprocess.run([str(bn_emu), str(tmp_path), str(M), str(C),
                    str(int(dtype == torch.bfloat16)), str(vec), str(tx),
                    str(nblk), str(rows), str(group), str(int(two)), "2"],
                   check=True, capture_output=True, text=True, timeout=120,
                   env=_order_env(M + C + nblk))
    want = fbn.bwd_reduce_plain(a, b) if two else fbn.bn_stats_plain(a)
    outs = [_load(tmp_path / ("out%d.bin" % c), torch.float32, (2, C))
            for c in (0, 1)]
    assert torch.isfinite(outs[0]).all()
    for got, w in zip(outs[0], want):
        assert _rel(got, w) <= TOL_F32
    assert torch.equal(outs[0], outs[1])
    assert np.fromfile(tmp_path / "done.bin", dtype=np.uint32)[0] == 0
