"""Prediction colorization and class metadata for Cityscapes/GTAV: port of
``cnsn_tpu/segmentation/vis.py`` (numpy only).

Stands in for the reference's palette text files and util.colorize
(segmentation/util/util.py colorize, segmentation/data/*_colors.txt):
the standard 19-class Cityscapes trainId names and palette, held here.
"""
from __future__ import annotations

import numpy as np

__all__ = ["CITYSCAPES_CLASSES", "CITYSCAPES_PALETTE",
           "GTAV_CLASSES", "GTAV_PALETTE", "class_metadata", "colorize"]

CITYSCAPES_CLASSES = (
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
)

CITYSCAPES_PALETTE = np.array([
    (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
    (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
    (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
    (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
    (0, 0, 230), (119, 11, 32),
], np.uint8)

# GTAV's labels are mapped to the same 19 trainIds (the reference's
# 'labels_mapped', segmentation/util/dataset.py), and its metadata files
# (segmentation/data/gtav/gtav_{names,colors}.txt) equal Cityscapes'
GTAV_CLASSES = CITYSCAPES_CLASSES
GTAV_PALETTE = CITYSCAPES_PALETTE

_METADATA = {"cityscapes": (CITYSCAPES_CLASSES, CITYSCAPES_PALETTE),
             "gtav": (GTAV_CLASSES, GTAV_PALETTE)}


def class_metadata(dataset: str):
    """(names, palette) of a dataset: the reference's per-dataset
    ``data/<ds>/<ds>_{names,colors}.txt`` (train_cnsn.py's colors_path and
    names_path) as a table."""
    return _METADATA[dataset.lower()]


def colorize(label: np.ndarray, palette: np.ndarray = CITYSCAPES_PALETTE,
             ignore_label: int = 255) -> np.ndarray:
    """(H, W) integer labels → (H, W, 3) uint8 colours; ignored pixels are
    black, a label past the palette takes its last colour."""
    out = np.zeros((*label.shape, 3), np.uint8)
    valid = label != ignore_label
    out[valid] = palette[np.clip(label[valid], 0, len(palette) - 1)]
    return out
