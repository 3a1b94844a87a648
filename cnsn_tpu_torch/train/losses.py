"""Losses: cross-entropy and the JSD consistency regularizer.

Port of ``cnsn_tpu/train/losses.py``: softmax over (clean, aug1, aug2),
the mixture clamped to [1e-7, 1] before the log, the mean of three
batchmean KL terms; cross-entropy in (at least) fp32 on clean logits.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy", "error_topk", "jsd_consistency", "softmax_probs"]


def _float(logits: torch.Tensor) -> torch.Tensor:
    return logits.to(torch.promote_types(logits.dtype, torch.float32))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch (torch F.cross_entropy default reduction)."""
    logp = torch.log_softmax(_float(logits), dim=-1)
    return (-logp.gather(-1, labels[:, None].long())[:, 0]).mean()


def softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(_float(logits), dim=-1)


def _kl_batchmean(p: torch.Tensor, log_q: torch.Tensor) -> torch.Tensor:
    """F.kl_div(log_q, p, reduction='batchmean') = Σ p(log p − log q) / B,
    with 0·log 0 := 0."""
    pos = p > 0
    plogp = torch.where(pos, p * torch.log(torch.where(pos, p, 1.0)), 0.0)
    return (plogp - p * log_q).sum() / p.shape[0]


def jsd_consistency(p_clean: torch.Tensor, p_aug1: torch.Tensor,
                    p_aug2: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon-style consistency among three predicted
    distributions (AugMix JSD).  Inputs are probabilities."""
    p_mix = torch.clamp((p_clean + p_aug1 + p_aug2) / 3.0, 1e-7, 1.0)
    log_mix = torch.log(p_mix)
    return (_kl_batchmean(p_clean, log_mix)
            + _kl_batchmean(p_aug1, log_mix)
            + _kl_batchmean(p_aug2, log_mix)) / 3.0


def error_topk(logits: torch.Tensor, labels: torch.Tensor,
               k: int = 1) -> torch.Tensor:
    """Top-k error in percent, ties broken toward the lower class index
    as JAX's stable argsort breaks them."""
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
    correct = (topk == labels[:, None]).any(dim=-1)
    return 100.0 * (1.0 - correct.float().mean())
