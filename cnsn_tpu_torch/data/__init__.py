"""Data of the port: the CIFAR datasets, ImageNet image folders, host
AugMix and the host loaders (numpy and PIL)."""
from .augmix import augmix
from .cifar import (CORRUPTIONS, CifarData, CifarLoader, load_cifar,
                    load_cifar_c)
from .imagenet import (ImageFolderData, ImageNetLoader, imagenet_c_dir,
                       scan_image_folder)
from .transforms import (IMAGENET_MEAN, IMAGENET_STD, center_crop_resize,
                         cifar_eval_transform, cifar_train_geom,
                         cifar_train_transform, imagenet_normalize,
                         normalize, random_resized_crop)
from .workers import PrefetchPool

__all__ = ["CORRUPTIONS", "CifarData", "CifarLoader", "IMAGENET_MEAN",
           "IMAGENET_STD", "ImageFolderData", "ImageNetLoader",
           "PrefetchPool", "augmix", "center_crop_resize",
           "cifar_eval_transform", "cifar_train_geom",
           "cifar_train_transform", "imagenet_c_dir", "imagenet_normalize",
           "load_cifar", "load_cifar_c", "normalize", "random_resized_crop",
           "scan_image_folder"]
