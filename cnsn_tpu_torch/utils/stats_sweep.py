"""K2's one-launch forward and K3's staged kernel at the shapes of the
main paths: each one's plan and its time around the plan, beside the
kernel it replaced, in the same process.

    python -m cnsn_tpu_torch.utils.stats_sweep [--iters 20] [--only k2|k3]
        [--baseline DIR] [--k2-constants NAME=VALUE,... ...]

K2 (``bn_sums``): one JSON line for each of ResNet-50's 12 BatchNorm2d
input shapes at b=128 224² bf16: ``plan`` (``bn_sums_plan``),
``planned_ms``, ``main_ms`` (the same launch stopped at its partials, no
ticket and no final add; ``final_add_ms`` is the difference),
``ms_by_chunks`` over chunk counts around the planned one (one less than
the plan: the same rows per block without clusters), ``clean_ms`` (timed
after an L2 flush that leaves clean lines, ``_time_clean_ms``) and the
bound.
With ``--baseline DIR`` (a directory holding an earlier
``cnsn_tpu_torch/csrc/bn_stats.cu`` and ``row_pass.cuh`` whose forward is
the two-launch design, ``cnsn_bn_sums_chunks`` and ``cnsn_bn_sums``, as in
a ``git archive`` of that commit), that source is built beside the
package's and timed as ``baseline_ms`` and ``baseline_clean_ms``.  Each
``--k2-constants`` (say ``Sum=float,kFwdBlocksPerSm=5``) builds a copy of
the package's ``csrc/bn_stats.cu`` with those ``constexpr int`` values and
sum type, timed per shape in ``variants_ms``.

K3 (``selfnorm``): one line per SelfNorm shape of ResNet-50 at b=64 and
b=1 and of WRN-40-2 at b=128, in float32 and bfloat16: ``plan``
(``selfnorm_plan``), ``planned_ms``, ``ms_by_plan`` over every (lanes,
cluster) the kernel takes (key ``lanes x cluster``), ``v1_ms`` (the v1
kernel) and the bound.

Times: CUDA events around each launch, the 50 MB L2 overwritten and a
~1 ms spin on the card before each, as ``chip_smoke.py`` times them;
every timed configuration is first held to the plain version (K2: 1e-5
of Σ|x−m0| and of s2; K3: chip_smoke's ``TOL``).  The last line names
the card.  It needs a GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..models.resnet import block_plan
from ..ops.kernels._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from ..ops.kernels._launch import DTYPE_CODE, INT, PTR, vector_width
from ..ops.kernels.bn_stats import _launch as _bn_launch
from ..ops.kernels.bn_stats import (bn_sums_cuda, bn_sums_plan,
                                   bn_sums_reference)
from ..ops.kernels.selfnorm import (PATHS, _launch, selfnorm_infer_reference,
                                    selfnorm_plan)
from .k4_sweep import SPIN_CYCLES, _time_ms

HBM_BYTES_PER_S = 3.35e12
# (H = W, C) of the SelfNorm sites: ResNet-50 at 224² (serving: b=64 and
# b=1), WRN-40-2 at 32² (eval: b=128)
SN_R50 = ((56, 256), (28, 512), (14, 1024), (7, 2048))
SN_WRN = ((32, 16), (32, 32), (16, 64), (8, 128))
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}


def bn_shapes(image: int = 224) -> collections.Counter:
    """{(H = W, C): layers} of ResNet-50's BatchNorm2d inputs."""
    shapes = collections.Counter({(image // 2, 64): 1})
    hw = image // 4
    for blk in block_plan((3, 4, 6, 3)):
        out_hw = hw // blk["stride"]
        shapes[(hw, blk["planes"])] += 1
        shapes[(out_hw, blk["planes"])] += 1
        shapes[(out_hw, 4 * blk["planes"])] += 1 + blk["has_downsample"]
        hw = out_hw
    return shapes


def _baseline(src: Path):
    """The two-launch forward, built from ``src`` beside the package's
    libraries: a callable (x, m0) -> (s1, s2)."""
    out = BUILD_DIR / "baseline" / "libbn_stats_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out),
                    str(src / "cnsn_tpu_torch" / "csrc" / "bn_stats.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    chunks_of = lib.cnsn_bn_sums_chunks
    chunks_of.argtypes, chunks_of.restype = [INT, INT, INT], ctypes.c_int
    fwd = lib.cnsn_bn_sums
    fwd.argtypes = [INT, INT, PTR, PTR, PTR, PTR, PTR, INT, INT, INT, PTR]
    fwd.restype = ctypes.c_int

    def run(x, m0):
        c = x.shape[-1]
        rows, vec = x.numel() // c, vector_width(x)
        chunks = chunks_of(rows, c, vec)
        part = torch.empty((2, chunks, c), device=x.device)
        s1 = torch.empty(c, device=x.device)
        s2 = torch.empty(c, device=x.device)
        err = fwd(DTYPE_CODE[x.dtype], vec, x.data_ptr(), m0.data_ptr(),
                  part.data_ptr(), s1.data_ptr(), s2.data_ptr(), rows, c,
                  chunks, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline bn_sums: cudaError {err}")
        return s1, s2
    return run


def _variant(spec: str):
    """K2's forward built from the package's ``csrc/bn_stats.cu`` with the
    constants of ``spec`` ("NAME=VALUE,...": its ``constexpr int``s, and
    ``Sum`` = double or float), beside the package's libraries: a callable
    (x, m0) -> (s1, s2)."""
    text = (CSRC_DIR / "bn_stats.cu").read_text()
    sums = torch.float64
    for item in spec.split(","):
        name, value = item.split("=")
        if name == "Sum":
            sums = {"double": torch.float64, "float": torch.float32}[value]
            text, n = re.subn(r"using Sum = \w+;", f"using Sum = {value};",
                              text)
        else:
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {int(value)};", text)
        if n != 1:
            raise ValueError(f"--k2-constants: no {name} in bn_stats.cu")
    out = BUILD_DIR / "variants" / re.sub(r"\W", "_", spec)
    out.mkdir(parents=True, exist_ok=True)
    (out / "bn_stats.cu").write_text(text)
    (out / "row_pass.cuh").write_bytes((CSRC_DIR / "row_pass.cuh")
                                       .read_bytes())
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out / "lib.so"),
                    str(out / "bn_stats.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    plan_of, fwd = lib.cnsn_bn_sums_plan, lib.cnsn_bn_sums
    plan_of.argtypes = [INT] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fwd.argtypes = [INT, INT, PTR, PTR, PTR, PTR, INT, PTR, PTR, INT, INT,
                    INT, INT, INT, PTR]
    tickets = torch.zeros(4096, dtype=torch.int32, device="cuda")

    def run(x, m0):
        c = x.shape[-1]
        rows, vec, plan = x.numel() // c, vector_width(x), (ctypes.c_int * 5)()
        if plan_of(DTYPE_CODE[x.dtype], vec, rows, c, 0, plan) != 0:
            raise RuntimeError(f"{spec}: no plan")
        part = torch.empty((2, plan[0] // plan[4], c), dtype=sums,
                           device=x.device)
        s1 = torch.empty(c, device=x.device)
        s2 = torch.empty(c, device=x.device)
        err = fwd(DTYPE_CODE[x.dtype], vec, x.data_ptr(), m0.data_ptr(),
                  part.data_ptr(), tickets.data_ptr(), tickets.numel(),
                  s1.data_ptr(), s2.data_ptr(), rows, c, plan[0], plan[4], 1,
                  torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{spec} bn_sums: cudaError {err}")
        return s1, s2
    return run


def _bn_check(got, want, x, m0, what: str) -> float:
    torch.cuda.synchronize()
    d_abs = (x.float() - m0).abs().sum(dim=(0, 1, 2))
    (s1, s2), (w1, w2) = got, want
    if not (bool(((s1 - w1).abs() <= 1e-5 * d_abs).all())
            and bool(((s2 - w2).abs() <= 1e-5 * w2).all())):
        raise RuntimeError(f"{what} disagrees with plain")
    return max((s1 - w1).abs().max().item(), (s2 - w2).abs().max().item())


def sweep_k2(hw: int, c: int, layers: int, iters: int, flush, baseline,
             variants: dict):
    gen = torch.Generator(device="cuda").manual_seed(hw * 10_000 + c)
    x = (torch.randn(128, hw, hw, c, generator=gen, device="cuda") * 1.5
         + 0.5).bfloat16()
    m0 = torch.randn(c, generator=gen, device="cuda") * 0.3
    want = bn_sums_reference(x, m0)
    plan = bn_sums_plan(x)
    pick = plan["chunks"]
    err = _bn_check(bn_sums_cuda(x, m0), want, x, m0, "bn_sums")
    row = {"kernel": "bn_sums", "shape": [128, hw, hw, c],
           "dtype": "bfloat16", "sites": layers, "plan": plan,
           "max_abs_err": err,
           "planned_ms": _time_ms(lambda: bn_sums_cuda(x, m0), iters, flush),
           "main_ms": _time_ms(lambda: _bn_launch(x, m0, finish=False),
                               iters, flush),
           "bound_ms": (x.numel() * 2 + 3 * c * 4) / HBM_BYTES_PER_S * 1e3}
    row["final_add_ms"] = row["planned_ms"] - row["main_ms"]
    # pick - 1: the same rows per block without clusters
    counts = sorted({max(1, pick // 4), max(1, pick // 2), max(1, pick - 1),
                     2 * pick, 4 * pick} - {pick})
    ms = {}
    for k in counts:
        _bn_check(_bn_launch(x, m0, chunks=k), want, x, m0,
                  f"bn_sums at {k} chunks")
        ms[k] = _time_ms(lambda k=k: _bn_launch(x, m0, chunks=k), iters,
                         flush)
    row["ms_by_chunks"] = ms
    if baseline is not None:
        _bn_check(baseline(x, m0), want, x, m0, "baseline bn_sums")
        row["baseline_ms"] = _time_ms(lambda: baseline(x, m0), iters, flush)
        row["baseline_clean_ms"] = _time_clean_ms(lambda: baseline(x, m0),
                                                  iters, flush)
    row["clean_ms"] = _time_clean_ms(lambda: bn_sums_cuda(x, m0), iters,
                                     flush)
    row["variants_ms"] = {}
    for spec, fn in variants.items():
        _bn_check(fn(x, m0), want, x, m0, spec)
        row["variants_ms"][spec] = _time_ms(lambda fn=fn: fn(x, m0), iters,
                                            flush)
    return row


def _time_clean_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """As ``_time_ms``, but the L2 is overwritten by a read of ``flush``, so
    the lines it leaves are clean: the launch pays no write-back of lines
    dirtied before it."""
    fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.sum()
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def sweep_k3(n: int, side: int, c: int, dtype, iters: int, flush):
    gen = torch.Generator(device="cuda").manual_seed(n * 1000 + c)
    x = (torch.randn(n, side, side, c, generator=gen, device="cuda") * 1.5
         + 0.3).to(dtype)
    w = torch.randn(c, 2, generator=gen, device="cuda") * 0.3
    a = torch.rand(c, generator=gen, device="cuda") * 1.5 + 0.5
    b = torch.randn(c, generator=gen, device="cuda") * 0.1
    want = selfnorm_infer_reference(x, w, a, b).float()
    item = x.element_size()
    plan = selfnorm_plan(x)

    def timed(path, lanes=0, cluster=0):
        def run():
            return _launch(x, w, a, b, 1e-12, path, lanes, cluster)
        got = run()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, **TOL[dtype])
        return _time_ms(run, iters, flush)

    # every (lanes, cluster) the kernel takes for x; it refuses the others
    ms = {}
    for lanes in (1, 2, 4, 8, 16, 32):
        for cluster in (1, 2, 4, 8):
            try:
                ms[f"{lanes}x{cluster}"] = timed("staged", lanes, cluster)
            except RuntimeError as err:
                if "cudaError" not in str(err):
                    raise
    planned = f"{plan['lanes']}x{plan['cluster']}"
    return {"kernel": PATHS["staged"][1], "shape": [n, side, side, c],
            "dtype": str(dtype).split(".")[1], "plan": plan,
            "planned_ms": ms[planned], "best_plan": min(ms, key=ms.get),
            "ms_by_plan": ms, "v1_ms": timed("v1"),
            "bound_ms": 2 * x.numel() * item / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("k2", "k3"))
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--k2-constants", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stats_sweep: needs a GPU", file=sys.stderr)
        return 1
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    if args.only != "k3":
        base = _baseline(args.baseline) if args.baseline else None
        variants = {spec: _variant(spec) for spec in args.k2_constants}
        for (hw, c), layers in sorted(bn_shapes().items(),
                                      key=lambda kv: (-kv[0][0], kv[0][1])):
            print(json.dumps(sweep_k2(hw, c, layers, args.iters, flush,
                                      base, variants)), flush=True)
    if args.only != "k2":
        cases = [(n, s, c) for n in (64, 1) for s, c in SN_R50]
        cases += [(128, s, c) for s, c in SN_WRN]
        for dtype in (torch.bfloat16, torch.float32):
            for n, side, c in cases:
                print(json.dumps(sweep_k3(n, side, c, dtype, args.iters,
                                          flush)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
