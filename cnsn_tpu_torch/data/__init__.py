"""Data of the port: the CIFAR datasets and host loader (numpy only)."""
from .cifar import (CORRUPTIONS, CifarData, CifarLoader, load_cifar,
                    load_cifar_c)
from .transforms import (cifar_eval_transform, cifar_train_geom,
                         cifar_train_transform, normalize)

__all__ = ["CORRUPTIONS", "CifarData", "CifarLoader", "load_cifar",
           "load_cifar_c", "cifar_eval_transform", "cifar_train_geom",
           "cifar_train_transform", "normalize"]
