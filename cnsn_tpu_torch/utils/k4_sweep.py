"""K4's wgmma and narrow kernels at the b=128 shapes of the two training
paths: each one's plan, and its time around the plan, beside the wmma
kernel and cuDNN's weight gradient in the same process.

    python -m cnsn_tpu_torch.utils.k4_sweep [--iters 20] [--only wide|narrow]

One JSON line per shape.  At the wide shapes (the wgmma kernel):
``plan`` (``wgrad3x3_wgmma_plan``), ``ms_by_chunks`` over row-chunk
counts around the planned one, ``tflops`` and ``smem_fill_tb_s`` (the
bytes the TMA loads bring into shared memory over the planned count's
time).  At WRN-40-2's three narrow shapes (the narrow kernel):
``plans_by_rows`` (``wgrad3x3_narrow_plan`` at each band height, its own
block count), ``ms_by_rows``, ``ms_by_blocks`` (block counts around the
planned one at the planned height), ``smem_fill_tb_s`` and
``partial_gb_s`` (the partials' bytes, written and read, over the
planned time).  Both: ``wmma_ms`` and ``cudnn_ms``; CUDA events around
each launch, the 50 MB L2 overwritten and a ~1 ms spin on the card
before each, as ``chip_smoke.py`` times; every launch's result is held
to the plain version within 1e-5 of Σ|x|·|dy|.  The last line names the
card.  It needs a GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from ..ops.kernels._launch import INT, PTR, bind
from ..ops.kernels.conv_wgrad import (PATHS, _kernels, wgrad3x3_cuda,
                                      wgrad3x3_narrow_plan,
                                      wgrad3x3_reference, wgrad3x3_wgmma_plan)
from .profiling import device_time_breakdown

# (H = W, Cin, Cout): ResNet-50's four stride-1 3x3 shapes, WRN-40-2's two
# wide ones
SHAPES = ((56, 64, 64), (28, 128, 128), (14, 256, 256), (7, 512, 512),
          (16, 64, 64), (8, 128, 128))
# WRN-40-2's three narrow shapes, and the band heights tried at each
NARROW_SHAPES = ((32, 3, 16), (32, 16, 32), (32, 32, 32))
NARROW_ROWS = (2, 4, 6, 8, 16)
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


def _operands(hw: int, cin: int, cout: int):
    gen = torch.Generator(device="cuda").manual_seed(hw * 1000 + cin)
    x = torch.randn(BATCH, hw, hw, cin, generator=gen,
                    device="cuda").bfloat16()
    dy = torch.randn(BATCH, hw, hw, cout, generator=gen,
                     device="cuda").bfloat16()
    return x, dy, wgrad3x3_reference(x, dy), wgrad3x3_reference(x.abs(),
                                                                 dy.abs())


def _checked(run, out, want, scale, what: str):
    run()
    torch.cuda.synchronize()
    if not bool(((out - want).abs() <= 1e-5 * scale).all()):
        raise RuntimeError(f"{what} disagrees with plain")


def _yardsticks(x, dy, iters: int, flush: torch.Tensor) -> dict:
    cin, cout = x.shape[-1], dy.shape[-1]
    w = torch.empty(cout, cin, 3, 3, device="cuda", dtype=torch.bfloat16,
                    memory_format=torch.channels_last)
    xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    return {"wmma_ms": _time_ms(lambda: wgrad3x3_cuda(x, dy, path="wmma"),
                                iters, flush),
            "cudnn_ms": _time_ms(lambda: torch.ops.aten.convolution_backward(
                dyc, xc, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [False, True, False]), iters, flush)}


def sweep(hw: int, cin: int, cout: int, iters: int,
          flush: torch.Tensor) -> dict:
    x, dy, want, scale = _operands(hw, cin, cout)
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
        _checked(run, out, want, scale, f"wgmma at {c} chunks")
        ms[c] = _time_ms(run, iters, flush)
    flops = 2 * x.numel() * 9 * cout
    return {"kernel": PATHS["wgmma"][1], "shape": [BATCH, hw, hw, cin, cout],
            "plan": plan, "ms_by_chunks": ms, "planned_ms": ms[pick],
            "best_chunks": min(ms, key=ms.get),
            **_yardsticks(x, dy, iters, flush),
            "tflops": flops / ms[pick] / 1e9,
            "smem_fill_tb_s": plan["smem_fill_bytes"] / ms[pick] / 1e9}


def sweep_narrow(hw: int, cin: int, cout: int, iters: int,
                 flush: torch.Tensor) -> dict:
    x, dy, want, scale = _operands(hw, cin, cout)
    plan = wgrad3x3_narrow_plan(BATCH, hw, hw, cin, cout)
    launch = bind("conv_wgrad", "cnsn_wgrad3x3_narrow", PTR, PTR, PTR, PTR,
                  INT, INT, INT, INT, INT, INT, INT, PTR)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(3, 3, cin, cout, device="cuda")

    def timed(rows: int, blocks: int) -> float:
        part = torch.empty(max(blocks, 1), 9, cin, cout, device="cuda")

        def run():
            err = launch(x.data_ptr(), dy.data_ptr(), part.data_ptr(),
                         out.data_ptr(), BATCH, hw, hw, cin, cout, rows,
                         blocks, stream)
            if err != 0:
                raise RuntimeError(f"narrow launch failed: cudaError {err}")
        _checked(run, out, want, scale, f"narrow at rows={rows}, "
                 f"blocks={blocks}")
        return _time_ms(run, iters, flush)

    plans, by_rows = {}, {}
    for rows in sorted({*NARROW_ROWS, plan["rows"]}):
        try:
            plans[rows] = wgrad3x3_narrow_plan(BATCH, hw, hw, cin, cout, rows)
        except RuntimeError:  # 3 stages of such bands do not fit
            plans[rows] = None
            continue
        by_rows[rows] = timed(rows, plans[rows]["blocks"])
    pick = plan["blocks"]
    by_blocks = {b: timed(plan["rows"], b) for b in sorted(
        {max(1, pick // 2), pick, min(plan["bands"], 2 * pick)})}
    ms = by_rows[plan["rows"]]
    # device time by kernel (the band kernel, the partials' sum), L2 warm
    part = torch.empty(pick, 9, cin, cout, device="cuda")
    prof = device_time_breakdown(lambda: launch(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), out.data_ptr(), BATCH,
        hw, hw, cin, cout, 0, pick, stream), iters=10, warmup=2, top=4)
    return {"kernel": PATHS["narrow"][1], "shape": [BATCH, hw, hw, cin, cout],
            "plan": plan, "plans_by_rows": plans, "ms_by_rows": by_rows,
            "ms_by_blocks": by_blocks, "planned_ms": ms,
            "best_rows": min(by_rows, key=by_rows.get),
            "best_blocks": min(by_blocks, key=by_blocks.get),
            **_yardsticks(x, dy, iters, flush),
            "smem_fill_tb_s": plan["smem_fill_bytes"] / ms / 1e9,
            "partial_gb_s": 2 * plan["partial_bytes"] / ms / 1e6,
            "warm_ms_by_kernel": {k["name"][:60]: k["ms"]
                                  for k in prof["top_kernels_ms"]},
            "warm_wall_ms": prof["wall_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("wide", "narrow"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_sweep: needs a GPU", file=sys.stderr)
        return 1
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    if args.only != "narrow":
        for shape in SHAPES:
            print(json.dumps(sweep(*shape, args.iters, flush)), flush=True)
    if args.only != "wide":
        for shape in NARROW_SHAPES:
            print(json.dumps(sweep_narrow(*shape, args.iters, flush)),
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
