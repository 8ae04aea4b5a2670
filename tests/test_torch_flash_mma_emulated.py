"""The tensor-core flash kernels of ``csrc/flash_attention.cu``
(``flash_fwd_mma_kernel``, ``flash_bwd_dkv_mma_kernel``,
``flash_bwd_dq_mma_kernel``) run on the CPU and held to the plain versions
in ``kernels/flash_attention.py``.

``g++`` builds the CUDA source against the stand-in headers in
``tests/cuda_emu/``, which run a block's 128 threads as fibers on one OS
thread (a warp runs on until its barriers stop it) and execute
``cp.async``, ``ldmatrix`` and ``mma.sync`` with PTX's semantics (copies
land only at their ``wait_group``; fragments in PTX's lane layouts).  That
checks the fragment indexing, the masks of ragged and causal tiles, and the
order of the ``cp.async`` ring where there is no card.  The SASS, the
registers and the speed are the card's to show (``chip_smoke.py``), and so
is anything the emulation cannot see: a race between threads that its
barriers happen to order.

Tolerances are the card's for bf16 outputs (``chip_smoke.py`` TOL_BF16):
2e-2 of the largest value, against the f32 plain version on the same bf16
inputs; lse to 1e-5.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EMU = Path(__file__).resolve().parent / "cuda_emu"
CSRC = Path(fa.__file__).resolve().parent / "csrc"
TOL_BF16 = 2e-2


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the host emulation")
    build = tmp_path_factory.mktemp("flash_emu")
    # the kernel source beside the stand-ins: its "mma.cuh" is then theirs
    for src in (CSRC / "flash_attention.cu", CSRC / "common.cuh",
                *EMU.glob("*.h"), EMU / "mma.cuh"):
        shutil.copy(src, build)
    exe = build / "flash_emu"
    subprocess.run([gxx, "-std=c++20", "-O2", "-pthread",
                    "-DPTT_HOST_EMULATION", "-I", str(build), "-o", str(exe),
                    str(EMU / "flash_emu.cpp")], check=True,
                   capture_output=True, text=True, timeout=300)
    return exe


def _bits(t):
    return t.contiguous().view(torch.int16).numpy()


def _bf16(path, shape):
    return torch.from_numpy(np.fromfile(path, dtype=np.int16)).view(
        torch.bfloat16).reshape(shape)


def _rel(got, want):
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("B,H,Sq,Sk,D,causal,scale", [
    (1, 2, 130, 130, 64, False, None),   # ragged last q and kv tiles
    (1, 2, 130, 130, 64, True, None),
    (1, 1, 70, 150, 40, True, None),     # Sq < Sk causal; D off 16
    (1, 1, 150, 70, 64, True, None),     # Sq > Sk causal
    (1, 1, 100, 100, 128, True, None),   # DP = 128 (K, V re-read)
    (1, 1, 96, 64, 128, False, None),
    (1, 1, 100, 100, 64, True, -0.3),    # any scale
    (1, 1, 100, 100, 64, True, 2.0),
    (1, 2, 64, 64, 8, False, None),      # bert_tiny's D = 8
])
def test_mma_kernels_emulated_match_plain(emulator, tmp_path, B, H, Sq, Sk,
                                          D, causal, scale):
    rng = np.random.RandomState(Sq + Sk + D)
    mk = lambda S, m: torch.from_numpy(
        (rng.randn(B, S, H * D) * m).astype(np.float32)).bfloat16()
    q, k, v, do = mk(Sq, 0.5), mk(Sk, 0.5), mk(Sk, 0.5), mk(Sq, 1.0)
    scale = D ** -0.5 if scale is None else scale
    f32 = [t.float() for t in (q, k, v, do)]
    o_p, lse_p = fa.flash_fwd_plain(*f32[:3], H, scale, causal)
    o_b = o_p.bfloat16().float()     # o as the forward stores it
    delta = (f32[3] * o_b).reshape(B, Sq, H, D).sum(-1).transpose(1, 2)
    grads_p = fa.flash_bwd_plain(*f32[:3], o_b, lse_p, f32[3], H, scale,
                                 causal)
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _bits(t).tofile(tmp_path / (name + ".bin"))
    lse_p.numpy().tofile(tmp_path / "lse.bin")
    delta.contiguous().numpy().tofile(tmp_path / "delta.bin")
    subprocess.run([str(emulator), str(tmp_path), str(B), str(H), str(Sq),
                    str(Sk), str(D), repr(float(scale)), str(int(causal))],
                   check=True, capture_output=True, text=True, timeout=300)

    o = _bf16(tmp_path / "o.bin", q.shape)
    lse = torch.from_numpy(np.fromfile(tmp_path / "lse_out.bin",
                                       dtype=np.float32)).reshape(lse_p.shape)
    assert _rel(o, o_p) <= TOL_BF16
    torch.testing.assert_close(lse, lse_p, atol=1e-5, rtol=1e-5)
    for name, want in zip(("dq", "dk", "dv"), grads_p):
        got = _bf16(tmp_path / (name + ".bin"), want.shape)
        assert torch.isfinite(got.float()).all(), name
        assert _rel(got, want) <= TOL_BF16, name
