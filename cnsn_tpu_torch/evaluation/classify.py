"""Clean and corruption evaluation harnesses: port of
``cnsn_tpu/evaluation/classify.py``.

  * ``evaluate``: clean test loss/accuracy (cifar.py:275-289 ``test``).
  * ``evaluate_cifar_c``: 15 corruptions, each a 50k-row pool (5
    severities × 10k), batch 1000, reports mean accuracy and the
    unnormalized mean corruption error 100·(1−mean acc)
    (cifar.py:292-312 ``test_c``).
  * ``compute_mce``: ImageNet-C AlexNet-normalized mCE
    (imagenet.py:85-89,125-140).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from ..data.cifar import CORRUPTIONS, CifarData, CifarLoader, load_cifar_c
from ..utils.prefetch import batch_put, device_prefetch

__all__ = ["evaluate", "evaluate_cifar_c", "compute_mce", "ALEXNET_ERR",
           "CORRUPTIONS"]

# Raw AlexNet errors (hendrycks/robustness), imagenet.py:85-89.
ALEXNET_ERR = (
    0.886428, 0.894468, 0.922640, 0.819880, 0.826268, 0.785948, 0.798360,
    0.866816, 0.826572, 0.819324, 0.564592, 0.853204, 0.646056, 0.717840,
    0.606500,
)


def evaluate(eval_step: Callable, state, loader: Iterable,
             prefetch_depth: int = 2, dp=None) -> Tuple[float, float]:
    """Returns (avg loss over dataset, accuracy).

    ``eval_step`` is the summing step (``StepFns.eval_sum``): each batch's
    (loss sum, hits, rows) stay on the model's device, so the whole
    loader costs ONE host sync.  Batches go to the device through
    ``device_prefetch``; a short last batch runs at its own size (the
    port's forward takes any batch), and its mean equals the JAX
    package's masked mean over the padded batch.

    Across ranks (``dp`` a ``parallel.DataParallel`` of a process group)
    the loader yields each rank's rows, its last batch padded with label
    −1 to a multiple of the ranks (``CifarLoader``/``ImageNetLoader``
    ``shard``), as JAX pads it: each rank evaluates its rows (K3 on the
    card), and one all-reduce of the batches' sums gives the global
    batches' means.
    """
    put = batch_put(next(state.model.parameters()).device)
    rows = []
    for im, lb in device_prefetch(loader, put, depth=prefetch_depth):
        out = eval_step(state, im, lb)
        n = out["n"].double()
        rows.append(torch.stack([out["loss"].double() * n,
                                 out["correct"].double(), n]))
    if not rows:
        return 0.0, 0.0
    sums = torch.stack(rows)                                  # (batches, 3)
    if dp is not None:
        sums = dp.sum(sums)
    sums = sums.cpu()
    n = max(int(sums[:, 2].sum()), 1)
    # reference: total of per-batch mean losses / len(dataset)
    batch_loss = sums[:, 0] / sums[:, 2].clamp(min=1)
    return float(batch_loss.sum()) / n, int(sums[:, 1].sum()) / n


def evaluate_cifar_c(eval_step: Callable, state, corrupt_dir: str,
                     num_classes: int, batch_size: int = 1000,
                     corruptions: Sequence[str] = CORRUPTIONS,
                     verbose: bool = True, prefetch_depth: int = 2,
                     dp=None) -> Tuple[float, Dict[str, float]]:
    """Mean accuracy over the corruption suite; prints per-corruption
    error like the reference.  ``dp``: as ``evaluate``'s, each rank
    reading its rows of every batch."""
    from ..parallel import distributed
    w = distributed.world() if dp is not None else None
    shard = (w.rank, w.size) if w is not None else None
    accs = {}
    for corruption in corruptions:
        images, labels = load_cifar_c(corrupt_dir, corruption)
        data = CifarData(images, labels, num_classes)
        loader = CifarLoader(data, batch_size, mode="eval", shard=shard)
        loss, acc = evaluate(eval_step, state, loader,
                             prefetch_depth=prefetch_depth, dp=dp)
        accs[corruption] = acc
        if verbose:
            print(f"{corruption}\n\tTest Loss {loss:.3f} | "
                  f"Test Error {100 - 100. * acc:.3f}")
    return float(np.mean(list(accs.values()))), accs


def compute_mce(corruption_accs: Dict[str, Sequence[float]]
                ) -> Tuple[float, Dict[str, float]]:
    """AlexNet-normalized mean corruption error over 15 corruptions;
    ``corruption_accs[c]`` holds per-severity accuracies."""
    mce = 0.0
    ce_dict = {}
    for i, c in enumerate(CORRUPTIONS):
        avg_err = 1.0 - float(np.mean(corruption_accs[c]))
        ce = 100.0 * avg_err / ALEXNET_ERR[i]
        ce_dict[c] = ce
        mce += ce / len(CORRUPTIONS)
    return mce, ce_dict
