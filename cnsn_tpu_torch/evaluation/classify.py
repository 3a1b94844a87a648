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
             prefetch_depth: int = 2) -> Tuple[float, float]:
    """Returns (avg loss over dataset, accuracy).

    ``eval_step`` is the summing step (``StepFns.eval_sum``): the per-batch
    results stay on the model's device and add up there, so the whole
    loader costs ONE host sync.  Batches go to the device through
    ``device_prefetch``; a short last batch runs at its own size (the
    port's forward takes any batch), and its mean equals the JAX
    package's masked mean over the padded batch.
    """
    put = batch_put(next(state.model.parameters()).device)
    total_loss = total_correct = total = None
    for im, lb in device_prefetch(loader, put, depth=prefetch_depth):
        out = eval_step(state, im, lb)
        if total_loss is None:
            total_loss, total_correct, total = (out["loss"], out["correct"],
                                                out["n"])
        else:  # device-side accumulation: no per-batch host sync
            total_loss = total_loss + out["loss"]
            total_correct = total_correct + out["correct"]
            total = total + out["n"]
    if total_loss is None:
        return 0.0, 0.0
    total_loss, total_correct, total = torch.stack(
        [total_loss.double(), total_correct.double(),
         total.double()]).tolist()
    n = max(int(total), 1)
    # reference: total of per-batch mean losses / len(dataset)
    return total_loss / n, int(total_correct) / n


def evaluate_cifar_c(eval_step: Callable, state, corrupt_dir: str,
                     num_classes: int, batch_size: int = 1000,
                     corruptions: Sequence[str] = CORRUPTIONS,
                     verbose: bool = True,
                     prefetch_depth: int = 2) -> Tuple[float, Dict[str, float]]:
    """Mean accuracy over the corruption suite; prints per-corruption
    error like the reference."""
    accs = {}
    for corruption in corruptions:
        images, labels = load_cifar_c(corrupt_dir, corruption)
        data = CifarData(images, labels, num_classes)
        loader = CifarLoader(data, batch_size, mode="eval")
        loss, acc = evaluate(eval_step, state, loader,
                             prefetch_depth=prefetch_depth)
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
