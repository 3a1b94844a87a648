from .classify import (ALEXNET_ERR, CORRUPTIONS, compute_mce, evaluate,
                       evaluate_cifar_c)

__all__ = ["ALEXNET_ERR", "CORRUPTIONS", "compute_mce", "evaluate",
           "evaluate_cifar_c"]
