"""The port stands alone: it runs with neither JAX nor the JAX package
imported, and its entry points do not fall back to the CPU."""
import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cnsn_tpu")


def test_port_runs_without_jax_in_a_fresh_process():
    code = textwrap.dedent("""
        import sys, torch
        import cnsn_tpu_torch
        from cnsn_tpu_torch.serving import export_classifier
        m = cnsn_tpu_torch.build_classifier(
            "resnet50", 10, device="cpu", layers=(1, 1, 1, 1),
            pos="post", cnsn_type="sn")
        with torch.no_grad():
            y = m(torch.randn(2, 32, 32, 3))
        assert y.shape == (2, 10) and bool(torch.isfinite(y).all())
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "optax", "cnsn_tpu"))
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_file_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(_ROOT, "cnsn_tpu_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(_ROOT, "chip_smoke.py"))
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in _FORBIDDEN, (path, mod)


def test_build_classifier_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error")
    from cnsn_tpu_torch import build_classifier
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_classifier("resnet50", 10, layers=(1, 1, 1, 1))
