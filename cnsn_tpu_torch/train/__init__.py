"""Training of the port: losses, schedules and the train/eval steps."""
from .losses import cross_entropy, error_topk, jsd_consistency, softmax_probs
from .schedules import cosine_lr, imagenet_step_lr, poly_lr, step_lr
from .steps import StepFns, TrainState, create_train_state, sample_cn_mask

__all__ = [
    "cross_entropy", "jsd_consistency", "softmax_probs", "error_topk",
    "cosine_lr", "imagenet_step_lr", "poly_lr", "step_lr",
    "StepFns", "TrainState", "create_train_state", "sample_cn_mask",
]
