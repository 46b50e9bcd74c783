"""ImageNet normalization of frames (host numpy).

Copy of the eval subset of the JAX package's ``data/augment.py``; the training
augmentations come with the training slice.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(arr):
    """[0,1] float RGB (H, W, 3) -> ImageNet-normalized."""
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_image(arr):
    return arr * IMAGENET_STD + IMAGENET_MEAN
