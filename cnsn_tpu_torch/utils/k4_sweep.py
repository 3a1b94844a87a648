"""K4's wgmma kernel at the wide b=128 shapes of the two training paths:
its plan, and its time at row-chunk counts around the one it plans, beside
the wmma kernel and cuDNN's weight gradient in the same process.

    python -m cnsn_tpu_torch.utils.k4_sweep [--iters 20]

One JSON line per shape: ``plan`` (``wgrad3x3_wgmma_plan``), ``ms_by_chunks``
(CUDA events around each launch, the 50 MB L2 overwritten and a ~1 ms spin
on the card before each, as ``chip_smoke.py`` times), ``wmma_ms``,
``cudnn_ms``, ``tflops`` and ``smem_fill_tb_s`` (the bytes the TMA loads
bring into shared memory over the planned count's time); every launch's
result is held to the plain version within 1e-5 of Σ|x|·|dy|.  The last
line names the card.  It needs a GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..ops.kernels.conv_wgrad import (PATHS, _kernels, wgrad3x3_cuda,
                                      wgrad3x3_reference, wgrad3x3_wgmma_plan)

# (H = W, Cin, Cout): ResNet-50's four stride-1 3x3 shapes, WRN-40-2's two
# wide ones
SHAPES = ((56, 64, 64), (28, 128, 128), (14, 256, 256), (7, 512, 512),
          (16, 64, 64), (8, 128, 128))
BATCH = 128
SPIN_CYCLES = 2_000_000


def _time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def sweep(hw: int, cin: int, cout: int, iters: int,
          flush: torch.Tensor) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(hw * 1000 + cin)
    x = torch.randn(BATCH, hw, hw, cin, generator=gen,
                    device="cuda").bfloat16()
    dy = torch.randn(BATCH, hw, hw, cout, generator=gen,
                     device="cuda").bfloat16()
    want = wgrad3x3_reference(x, dy)
    scale = wgrad3x3_reference(x.abs(), dy.abs())
    plan = wgrad3x3_wgmma_plan(BATCH, hw, hw, cin, cout)
    pick = plan["chunks"]
    counts = sorted({max(1, pick // 2), max(1, pick - 2), pick, pick + 2,
                     2 * pick})
    out = torch.empty(3, 3, cin, cout, device="cuda")
    part = torch.empty(max(counts), 9, cin, cout, device="cuda")
    launch = _kernels()[1]
    stream = torch.cuda.current_stream().cuda_stream
    ms = {}
    for c in counts:
        def run(c=c):
            err = launch(PATHS["wgmma"][0], 1, 8, x.data_ptr(), dy.data_ptr(),
                         part.data_ptr(), out.data_ptr(), BATCH, hw, hw, cin,
                         cout, c, stream)
            if err != 0:
                raise RuntimeError(f"wgmma launch failed: cudaError {err}")
        run()
        torch.cuda.synchronize()
        if not bool(((out - want).abs() <= 1e-5 * scale).all()):
            raise RuntimeError(f"wgmma at {c} chunks disagrees with plain")
        ms[c] = _time_ms(run, iters, flush)
    w = torch.empty(cout, cin, 3, 3, device="cuda", dtype=torch.bfloat16,
                    memory_format=torch.channels_last)
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    flops = 2 * x.numel() * 9 * cout
    return {"shape": [BATCH, hw, hw, cin, cout], "plan": plan,
            "ms_by_chunks": ms, "planned_ms": ms[pick],
            "best_chunks": min(ms, key=ms.get),
            "wmma_ms": _time_ms(lambda: wgrad3x3_cuda(x, dy, path="wmma"),
                                iters, flush),
            "cudnn_ms": _time_ms(lambda: torch.ops.aten.convolution_backward(
                dyc, xc, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False]), iters, flush),
            "tflops": flops / ms[pick] / 1e9,
            "smem_fill_tb_s": plan["smem_fill_bytes"] / ms[pick] / 1e9}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_sweep: needs a GPU", file=sys.stderr)
        return 1
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for shape in SHAPES:
        print(json.dumps(sweep(*shape, args.iters, flush)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
