"""The port's host utilities (cnsn_tpu_torch.utils) on the CPU: the cases
of tests/test_utils.py, run against the JAX package's implementation and
the port's alike (AverageMeter, MetricWriter, device_prefetch, the
provenance snapshot and log tee, the exp-dir layout), and the port's
staging of a batch onto a device."""
import io
import json
import os
import threading
import time
import zipfile

import numpy as np
import pytest
import torch
import yaml

from cnsn_tpu.config import ExperimentConfig as JaxExperimentConfig
from cnsn_tpu.utils import meters as jax_meters
from cnsn_tpu.utils import metrics_io as jax_metrics_io
from cnsn_tpu.utils import prefetch as jax_prefetch
from cnsn_tpu.utils import provenance as jax_provenance
from cnsn_tpu_torch.config import ExperimentConfig
from cnsn_tpu_torch.utils import meters, metrics_io, prefetch, provenance
from test_torch_threads import one_thread  # noqa: F401 (autouse)


PACKAGES = {"jax": (jax_meters, jax_metrics_io, jax_prefetch),
            "port": (meters, metrics_io, prefetch)}


@pytest.fixture(params=sorted(PACKAGES))
def impl(request):
    return PACKAGES[request.param]


def test_average_meter(impl):
    m = impl[0].AverageMeter()
    m.update(1.0, 2)
    m.update(4.0, 1)
    assert m.val == 4.0 and m.count == 3
    np.testing.assert_allclose(m.avg, 2.0)
    m.reset()
    assert (m.val, m.avg, m.sum, m.count) == (0.0, 0.0, 0.0, 0)


def test_log_dir_layout(impl):
    p = impl[0].get_log_dir_path("/tmp/exp", "run")
    parts = p.split(os.sep)
    assert parts[-2].count("_") == 2  # date stamp
    assert parts[-1].startswith("run_")


def test_metric_writer_jsonl(impl, tmp_path):
    w = impl[1].MetricWriter(str(tmp_path))
    w.scalar("loss", 1.5, 3)
    w.scalar("acc", 0.9, 4)
    w.close()
    lines = [json.loads(line) for line in open(w.path)]
    assert lines[0] == {**lines[0], "tag": "loss", "value": 1.5, "step": 3}
    assert lines[1]["tag"] == "acc"
    assert os.path.basename(w.path) == "scalars.jsonl"


class TestDevicePrefetch:
    def test_yields_transformed_in_order(self, impl):
        items = [(np.full((2, 2), i), np.array([i])) for i in range(7)]
        out = list(impl[2].device_prefetch(
            iter(items), lambda b: (b[0] * 2, b[1]), depth=2))
        assert len(out) == 7
        for i, (a, b) in enumerate(out):
            np.testing.assert_array_equal(a, np.full((2, 2), i) * 2)
            assert b[0] == i

    def test_depth_zero_inline(self, impl):
        n_before = threading.active_count()
        out = impl[2].device_prefetch(iter([1, 2, 3]), lambda x: x + 1,
                                      depth=0)
        assert next(out) == 2 and threading.active_count() == n_before
        assert list(out) == [3, 4]

    def test_worker_exception_propagates(self, impl):
        def bad():
            yield 1
            raise RuntimeError("loader died")

        it = impl[2].device_prefetch(bad(), lambda x: x, depth=2)
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="loader died"):
            list(it)

    def test_put_exception_propagates(self, impl):
        def put(x):
            if x == 2:
                raise ValueError("put failed")
            return x

        with pytest.raises(ValueError, match="put failed"):
            list(impl[2].device_prefetch(iter(range(5)), put, depth=2))

    def test_abandoned_generator_releases_worker(self, impl):
        n_before = threading.active_count()
        it = impl[2].device_prefetch(iter(range(100)), lambda x: x, depth=2)
        assert next(it) == 0
        it.close()  # abandon mid-stream
        for _ in range(50):  # the worker should exit promptly
            if threading.active_count() <= n_before:
                break
            time.sleep(0.1)
        assert threading.active_count() <= n_before

    def test_depth_bounds_the_staged_items(self, impl):
        """The worker runs at most ``depth`` items (+ the one it holds)
        ahead of the consumer."""
        made = []

        def put(x):
            made.append(x)
            return x

        it = impl[2].device_prefetch(iter(range(50)), put, depth=2)
        assert next(it) == 0
        time.sleep(0.5)
        assert len(made) <= 1 + 2 + 1
        it.close()


def test_stage_on_the_cpu_shares_the_arrays():
    images = np.arange(24, dtype=np.float32).reshape(2, 2, 2, 3)
    labels = np.array([3, 7], np.int64)
    out = prefetch.stage((images, labels), torch.device("cpu"))
    assert isinstance(out, tuple) and not isinstance(out, prefetch.Staged)
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.int64
    images[0, 0, 0, 0] = 99.0
    assert out[0][0, 0, 0, 0] == 99.0  # a conversion, not a copy
    staged = list(prefetch.device_prefetch(
        [(images, labels)], lambda b: prefetch.stage(b, torch.device("cpu")),
        depth=1))
    assert torch.equal(staged[0][1], torch.tensor([3, 7]))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_provenance_snapshot(pkg, tmp_path):
    """config.yaml + a zip of the package's own code (the port's: its
    Python and CUDA sources, not the JAX package) + the tee."""
    prov, cfg, name = ((jax_provenance, JaxExperimentConfig, "cnsn_tpu")
                       if pkg == "jax" else
                       (provenance, ExperimentConfig, "cnsn_tpu_torch"))
    out = prov.snapshot_experiment(str(tmp_path), cfg(lr=0.42), tee=False)
    assert out["config"] and os.path.exists(out["config"])
    assert yaml.safe_load(open(out["config"]))["lr"] == 0.42
    with zipfile.ZipFile(out["code"]) as z:
        names = z.namelist()
    assert any(n == f"{name}/nn/cnsn.py" for n in names)
    assert any(n == f"{name}/utils/provenance.py" for n in names)
    if pkg == "port":
        assert all(n.startswith("cnsn_tpu_torch/") for n in names)
        assert "cnsn_tpu_torch/csrc/selfnorm.cu" in names
        assert not any(n.startswith("cnsn_tpu_torch/_build/") for n in names)
    buf, log = io.StringIO(), str(tmp_path / "t.log")
    tee = prov.TeeLog(buf, log)
    tee.write("hello\n")
    tee.flush()
    assert buf.getvalue() == "hello\n"
    assert open(log).read() == "hello\n"
    tee.close()
