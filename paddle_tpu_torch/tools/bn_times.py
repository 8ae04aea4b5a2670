"""Times of the fused batch-norm kernels on the card, at ResNet-50's shapes.

    python -m paddle_tpu_torch.tools.bn_times

For each ``[M, C]`` view (bf16, as ResNet-50's bf16 step gives them) and each
of the four kernel wrappers of ``kernels/fused_bn.py`` prints one JSON line:

- ``ms``: CUDA events around 20 back-to-back calls, per call (what the
  caller waits for; at a small shape it may be the host's pace);
- ``device_ms``: the call's CUDA kernels, summed, by ``torch.profiler``,
  with each kernel's launches and device ms a call under ``kernels``;
- ``stream_ms``: 20 calls captured in a CUDA graph and replayed, per call:
  the device's time for the call, the gaps between its launches included,
  without the host's pace;
- the plain version's ``plain_ms``; the PyTorch call that computes the same
  or the nearest function (``library_ms``, with ``library_device_ms``);
- the bytes (each input read once, each output written once), the f32
  operations, and the larger of the two least times at the H100 SXM's peaks
  (``bound_ms``, ``bound_by``).

The views are ``SHAPES``: ResNet-50's largest bottleneck view and its
widest one (``chip_smoke.py``'s ``BN_SHAPES``), then its two smallest views
at B = 128.  Needs a CUDA card.
"""

import json
import subprocess

import torch

# (401408, 256): stage 1's bottleneck output; (6272, 2048): stage 4's; the
# two smallest views of the step: (6272, 512) and (25088, 256)
SHAPES = ((401408, 256), (6272, 2048), (6272, 512), (25088, 256))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (chip_smoke.py CARD_PEAKS)
F32_OPS_PER_S = 67e12          # its f32 CUDA-core rate
EVENT_CALLS = 20


def event_ms(fn, iters=EVENT_CALLS, warmup=3):
    """Milliseconds a call, CUDA events around ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters=EVENT_CALLS, replays=5):
    """Milliseconds a call, CUDA events around replays of a CUDA graph of
    ``iters`` calls, captured after warm-up calls on the capturing stream
    (so a wrapper's workspace for that stream exists before the capture)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (replays * iters)


def inputs(gen, M, C, dtype=torch.bfloat16):
    """x, dy [M, C] and the per-channel a, b (in ``dtype``) and f32 coefs
    [3, C] of the four kernels, on the card, from ``gen``."""
    mk = lambda: (torch.randn(M, C, generator=gen, device="cuda") * 2 + 1).to(dtype)
    x, dy = mk(), mk()
    a = (torch.rand(C, generator=gen, device="cuda") + 0.5).to(dtype)
    b = torch.randn(C, generator=gen, device="cuda").to(dtype)
    coefs = torch.randn(3, C, generator=gen, device="cuda")
    return x, dy, a, b, coefs


def shape_rows(M, C, seed=4):
    """{wrapper: row} at one bf16 [M, C] view: the times above, the bytes
    and operations, and the bound."""
    from paddle_tpu_torch.kernels import fused_bn as fbn
    from paddle_tpu_torch.tools.profile_step import cuda_kernels_per_call

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, dy, a, b, coefs = inputs(gen, M, C)
    weight = torch.rand(C, generator=gen, device="cuda") + 0.5
    mean, invstd = torch.batch_norm_stats(x, 1e-5)
    sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(
        dy, x, mean, invstd, weight, True, True, True)
    count = torch.full((1,), M, dtype=torch.int32, device="cuda")
    el = M * C
    rows = {}
    # (name, kernel, plain, library, bytes, f32 operations)
    for name, fn, plain, lib, nbytes, flops in (
            ("bn_stats", lambda: fbn.stats2(x), lambda: fbn.bn_stats_plain(x),
             lambda: torch.batch_norm_stats(x, 1e-5),
             2 * el + 2 * C * 4, 3 * el),
            ("bn_scale_shift", lambda: fbn.scale_shift2(x, a, b),
             lambda: fbn.scale_shift_plain(x, a, b),
             lambda: torch.addcmul(b, x, a), 4 * el + 2 * C * 2, 2 * el),
            ("bn_bwd_reduce", lambda: fbn.bwd_reduce2(dy, x),
             lambda: fbn.bwd_reduce_plain(dy, x),
             lambda: torch.batch_norm_backward_reduce(
                 dy, x, mean, invstd, weight, True, False, False),
             4 * el + 2 * C * 4, 3 * el),
            ("bn_dx", lambda: fbn.dx2(dy, x, coefs),
             lambda: fbn.dx_plain(dy, x, coefs),
             lambda: torch.batch_norm_backward_elemt(
                 dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, count),
             6 * el + 3 * C * 4, 5 * el)):
        per = cuda_kernels_per_call(fn, calls=10)
        lib_per = cuda_kernels_per_call(lib, calls=10)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_OPS_PER_S * 1e3
        rows[name] = {
            "shape": [M, C], "ms": event_ms(fn),
            "device_ms": sum(ms for _, ms in per.values()),
            "cuda_kernels_per_call": sum(n for n, _ in per.values()),
            "stream_ms": graph_ms(fn),
            "kernels": {k[:80]: {"per_call": n, "device_ms": ms}
                        for k, (n, ms) in per.items()},
            "plain_ms": event_ms(plain),
            "library_ms": event_ms(lib),
            "library_device_ms": sum(ms for _, ms in lib_per.values()),
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bn_times: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    for M, C in SHAPES:
        for name, row in shape_rows(M, C).items():
            print(json.dumps({"name": name, "device": torch.cuda.get_device_name(0),
                              "nvidia_smi": card, **row}), flush=True)


if __name__ == "__main__":
    main()
