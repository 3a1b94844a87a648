#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``cnsn_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version, runs the full-width ResNet-50 +
SelfNorm (pos='post', 16 sites) eval forward on the card against the
CPU, then drives the serving path a user calls (build_classifier →
export_classifier → save_artifact → load_artifact → requests at b=1 and
b=64) with launch counts read around it, and times and profiles bf16
serving at b=64 224².  Weights are random, drawn from a seed.  Every
phase prints one JSON line; any failure raises and exits non-zero.  The
last lines are the kernel summary, the card's name and power limit from
nvidia-smi, and ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is absent or where the
``cnsn_tpu_torch`` package is not beside it.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
BATCH = 64
IMAGE = 224
# (H·W, C, sites) of the 16 SelfNorm sites of ResNet-50 at 224², pos='post'
SN_SHAPES = ((56, 256, 3), (28, 512, 4), (14, 1024, 6), (7, 2048, 3))
# one bf16 ulp is at most 2^-7 of the value; fp32 sums in another order
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=1e-6)}
# Card vs CPU logits, fp32 with TF32 off: 53 convs whose algorithms sum
# in other orders on each side, relative to the logits' scale.
LOGIT_TOL = 1e-3
ARTIFACT_TOL = 1e-3
SERVE_REQUESTS = 100  # timed requests per (batch, path): p90 has 10 beyond
SPIN_CYCLES = 2_000_000  # ~1 ms of card clock: host head start per launch


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    """Fail the run (unlike ``assert``, this survives ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, CUDA events
    around each; the L2 is overwritten between launches (cold caller).
    A spin on the card before each start event lets the host enqueue
    ``fn`` ahead, so a slow host adds no gap inside the timed window."""
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


def phase_build():
    from cnsn_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    lib = build("selfnorm")
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in open(str(lib) + ".log").read().splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": seconds,
          "libraries": {"selfnorm": os.path.relpath(str(lib), ROOT)},
          "ptxas": {"selfnorm": ptxas}})


def phase_kernel_vs_plain(dev):
    from cnsn_tpu_torch.ops import (selfnorm_infer_cuda,
                                    selfnorm_infer_reference)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)  # 256 MB
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for hw_side, c, sites in SN_SHAPES:
            shape = (BATCH, hw_side, hw_side, c)
            x = (torch.randn(shape, generator=gen, device=dev) * 1.5
                 + 0.3).to(dtype)
            w = torch.randn(c, 2, generator=gen, device=dev) * 0.3
            a = torch.rand(c, generator=gen, device=dev) * 1.5 + 0.5
            b = torch.randn(c, generator=gen, device=dev) * 0.1
            got = selfnorm_infer_cuda(x, w, a, b)
            want = selfnorm_infer_reference(x, w, a, b)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       **TOL[dtype])
            check(torch.isfinite(got).all().item(), f"finite K3 {shape}")
            del got, want
            k_ms = time_ms(lambda: selfnorm_infer_cuda(x, w, a, b), 20, flush)
            p_ms = time_ms(lambda: selfnorm_infer_reference(x, w, a, b), 10,
                           flush)
            nbytes = 2 * x.numel() * x.element_size() + 4 * c * 4
            row = {"phase": "kernel_vs_plain", "kernel": "selfnorm_infer",
                   "shape": list(shape), "dtype": str(dtype).split(".")[1],
                   "sites": sites, "max_abs_err": err, "tol": TOL[dtype],
                   "kernel_ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "library_ms": None}
            row["bound_share"] = row["bound_ms"] / k_ms
            emit(row)
            rows.append(row)
            del x
    del flush
    torch.cuda.empty_cache()
    return rows


def phase_model_vs_cpu(dev):
    from cnsn_tpu_torch import build_classifier
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(seed=0, pos="post", cnsn_type="sn")
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(4, IMAGE, IMAGE, 3, generator=gen)
    cpu_model = build_classifier("resnet50", 1000, device="cpu", **kw)
    with torch.no_grad():
        want = cpu_model(images)
    del cpu_model
    model = build_classifier("resnet50", 1000, device=dev, **kw)
    with torch.no_grad():
        model(images.to(dev))  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        LAUNCHES.clear()
        got = model(images.to(dev))
        torch.cuda.synchronize()
    launches = LAUNCHES["selfnorm_infer"]
    got = got.cpu()
    check(got.shape == (4, 1000) and torch.isfinite(got).all().item(),
          "finite (4, 1000) logits")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    emit({"phase": "model_card_vs_cpu", "batch": 4, "dtype": "float32",
          "tf32": False, "max_abs_logit": scale, "max_abs_err": err,
          "err_over_scale": err / scale, "tol_over_scale": LOGIT_TOL,
          "selfnorm_launches_per_forward": launches})
    check(err <= LOGIT_TOL * scale, f"card vs CPU logits {err} > "
          f"{LOGIT_TOL} * {scale}")
    check(launches == 16, f"{launches} K3 launches per forward, not 16")


def phase_serving(dev):
    """The main path: what a user runs to serve, counts read around it."""
    from cnsn_tpu_torch import build_classifier
    from cnsn_tpu_torch.ops.kernels import LAUNCHES
    from cnsn_tpu_torch.serving import (export_classifier, load_artifact,
                                        save_artifact)
    from cnsn_tpu_torch.utils.profiling import device_time_breakdown
    gen = torch.Generator().manual_seed(2)
    requests = [torch.randn(b, IMAGE, IMAGE, 3, generator=gen).to(dev)
                for b in (1, BATCH)]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "resnet50_sn_bf16.pt2")
        LAUNCHES.clear()
        t0 = time.perf_counter()
        model = build_classifier("resnet50", 1000, device=dev, seed=0,
                                 pos="post", cnsn_type="sn",
                                 dtype=torch.bfloat16)
        save_artifact(export_classifier(model, IMAGE), path)
        serve = load_artifact(path, device=dev)
        export_s = time.perf_counter() - t0
        served = [serve(x) for x in requests]
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        artifact_bytes = os.path.getsize(path)
    emit({"phase": "serving_main_path", "export_save_load_s": export_s,
          "artifact_bytes": artifact_bytes, "batches": [1, BATCH],
          "launches": counts})
    check(counts.get("selfnorm_infer") == 16 * len(requests),
          f"main path launches {counts}")

    for x, y in zip(requests, served):
        with torch.no_grad():
            eager = model(x)
        check(y.shape == (x.shape[0], 1000) and torch.isfinite(y).all().item(),
              f"finite served logits at b={x.shape[0]}")
        err = (y.float() - eager.float()).abs().max().item()
        scale = eager.float().abs().max().item()
        emit({"phase": "artifact_vs_eager", "batch": x.shape[0],
              "dtype": "bfloat16", "max_abs_err": err, "max_abs_logit": scale})
        # the artifact runs the same aten ops (conv2d, batch_norm, linear)
        # and the same SelfNorm kernel: equal unless cuDNN picks another
        # algorithm, which bf16 rounding would show far below this bound
        check(err <= ARTIFACT_TOL * scale,
              f"artifact vs eager {err} > {ARTIFACT_TOL} * {scale}")

    # closed loop, one request in flight: each forward timed to its sync
    rates = {}
    for b, x in zip((1, BATCH), requests):
        for name, fn in (("eager", model), ("artifact", serve)):
            with torch.no_grad():
                for _ in range(5):
                    fn(x)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                lat = []
                for _ in range(SERVE_REQUESTS):
                    t0 = time.perf_counter()
                    fn(x)
                    torch.cuda.synchronize()
                    lat.append((time.perf_counter() - t0) * 1e3)
            lat.sort()
            med = statistics.median(lat)
            rates[(b, name)] = med
            emit({"phase": "serving_rate", "model": "resnet50 sn post",
                  "path": name, "batch": b, "image": IMAGE,
                  "dtype": "bfloat16", "requests": SERVE_REQUESTS,
                  "median_ms": med, "p90_ms": lat[int(0.9 * len(lat)) - 1],
                  "img_per_s": b / med * 1e3,
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "card": nvidia_smi_name_power()})

    x = requests[1]
    for name, fn in (("eager", model), ("artifact", serve)):
        with torch.no_grad():
            prof = device_time_breakdown(lambda: fn(x), iters=5)
        # the profiler slows the host; idle share against the plain timing
        prof["idle_share_vs_unprofiled"] = (
            1.0 - prof["device_busy_ms"] / rates[(BATCH, name)])
        emit({"phase": "serving_profile", "path": name, "batch": BATCH,
              "dtype": "bfloat16", **prof})
    return counts


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "cnsn_tpu_torch")):
        print("chip_smoke: cnsn_tpu_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    card = nvidia_smi_name_power()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "host_cpus": os.cpu_count(), "host_loadavg": os.getloadavg()})
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernel_vs_plain(dev)
    phase_model_vs_cpu(dev)
    counts = phase_serving(dev)

    bf16 = [r for r in rows if r["dtype"] == "bfloat16"]
    summary = {"name": "selfnorm_infer", "route": "cuda",
               "source": "cnsn_tpu_torch/csrc/selfnorm.cu",
               "replaces": "cnsn_tpu/ops/pallas/selfnorm.py:64",
               "launches": counts["selfnorm_infer"],
               "max_abs_err": max(r["max_abs_err"] for r in rows),
               "bound_by": "bytes", "library_ms": None}
    # per b=64 bf16 forward: each shape's time times its number of sites
    for key, out in (("kernel_ms", "ms"), ("plain_ms", "plain_ms"),
                     ("bound_ms", "bound_ms")):
        summary[out] = sum(r[key] * r["sites"] for r in bf16)
    emit({"phase": "total", "seconds": time.perf_counter() - t0})
    emit({"kernels": [summary]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
