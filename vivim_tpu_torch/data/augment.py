"""Synchronized image+mask augmentation and ImageNet normalization (host,
PIL).

Copy of the JAX package's ``data/augment.py`` (behavioural contract from
the reference's Multiclass_Data.py:73-174): the same geometric transform
is applied to the frame and all its masks (BICUBIC for the image, NEAREST
for masks); photometric transforms apply to the image only.  Intensity
presets gate per-op probabilities (:154-161):

  none:   all off
  light:  flip .5, rotate .2, crop .1, blur .1, gamma .1
  medium: flip .5, rotate .3, crop .3, blur .2, gamma .2   (default)
  heavy:  flip .5, rotate .4, crop .4, blur .3, gamma .3

Ops: horizontal flip; rotation +-15 deg; crop ratio 0.8-0.95 resized back;
color enhance (brightness/contrast/color/sharpness, range by intensity,
through the fused native chain); Gaussian blur radius 0.5-1.5; gamma
0.7-1.5.  Pepper noise exists but is off by default, as in the reference
(:172).

Every draw comes from the explicit ``random.Random`` passed in, in the
reference's order, so a seed gives the same clip in both packages.
"""

from __future__ import annotations

import random as _random

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter

from vivim_tpu_torch import native

INTENSITY_PROBS = {
    "none": dict(flip=0.0, rotate=0.0, crop=0.0, blur=0.0, gamma=0.0, pepper=0.0),
    "light": dict(flip=0.5, rotate=0.2, crop=0.1, blur=0.1, gamma=0.1, pepper=0.05),
    "medium": dict(flip=0.5, rotate=0.3, crop=0.3, blur=0.2, gamma=0.2, pepper=0.1),
    "heavy": dict(flip=0.5, rotate=0.4, crop=0.4, blur=0.3, gamma=0.3, pepper=0.15),
}

ENHANCE_RANGES = {
    "light": (0.9, 1.1),
    "medium": (0.7, 1.3),
    "heavy": (0.5, 1.5),
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def random_flip(rng, img, masks, p):
    if rng.random() < p:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        masks = [m.transpose(Image.FLIP_LEFT_RIGHT) for m in masks]
    return img, masks


def random_rotation(rng, img, masks, p, angle_range=(-15, 15)):
    if rng.random() < p:
        angle = rng.uniform(*angle_range)
        img = img.rotate(angle, Image.BICUBIC)
        masks = [m.rotate(angle, Image.NEAREST) for m in masks]
    return img, masks


def random_crop(rng, img, masks, p):
    if rng.random() < p:
        width, height = img.size
        ratio = rng.uniform(0.8, 0.95)
        cw, ch = int(width * ratio), int(height * ratio)
        left = rng.randint(0, width - cw)
        top = rng.randint(0, height - ch)
        box = (left, top, left + cw, top + ch)
        img = img.crop(box).resize((width, height), Image.BICUBIC)
        masks = [m.crop(box).resize((width, height), Image.NEAREST)
                 for m in masks]
    return img, masks


def color_enhance(rng, img, intensity):
    if intensity == "none":
        return img
    lo, hi = ENHANCE_RANGES[intensity]
    # factors drawn in the PIL-chain order regardless of backend so the
    # rng stream (and hence geometric sync with masks) is identical
    fb = rng.uniform(lo, hi)
    fc = rng.uniform(lo, hi)
    fcol = rng.uniform(lo, hi)
    fs = rng.uniform(lo, hi)
    arr = native.color_enhance(np.asarray(img, np.uint8), fb, fc, fcol, fs)
    if arr is not None:  # fused C++ chain (~15x the 4-pass PIL throughput)
        return Image.fromarray(arr)
    img = ImageEnhance.Brightness(img).enhance(fb)
    img = ImageEnhance.Contrast(img).enhance(fc)
    img = ImageEnhance.Color(img).enhance(fcol)
    img = ImageEnhance.Sharpness(img).enhance(fs)
    return img


def random_blur(rng, img, p):
    if rng.random() < p:
        img = img.filter(ImageFilter.GaussianBlur(radius=rng.uniform(0.5, 1.5)))
    return img


def random_gamma(rng, img, p, gamma_range=(0.7, 1.5)):
    if rng.random() < p:
        gamma = rng.uniform(*gamma_range)
        # uint8 -> uint8 gamma is a 256-entry LUT (the same mapping as the
        # elementwise pow, ~10x faster at 512px)
        lut = np.uint8(255.0 * np.power(np.arange(256, dtype=np.float32)
                                        / 255.0, gamma))
        img = Image.fromarray(lut[np.asarray(img, np.uint8)])
    return img


def random_pepper(rng, img, p, intensity=0.0015):
    """Salt-and-pepper noise — present but off by default, as in the
    reference (Multiclass_Data.py:172)."""
    if rng.random() < p:
        arr = np.array(img)
        num = int(intensity * arr.size)
        nprng = np.random.default_rng(rng.getrandbits(32))
        xs = nprng.integers(0, arr.shape[0], num)
        ys = nprng.integers(0, arr.shape[1], num)
        arr[xs, ys] = nprng.choice([0, 255], num)
        img = Image.fromarray(arr)
    return img


def apply_augmentation(img, masks, intensity="medium", rng=None,
                       enable_pepper=False):
    """Synchronized augmentation of a frame and its masks.

    Args:
      img: PIL RGB image.  masks: list of PIL L-mode masks.
      intensity: none | light | medium | heavy.
      rng: random.Random (fresh nondeterministic one if None).

    Returns (img, masks).
    """
    rng = rng or _random.Random()
    p = INTENSITY_PROBS[intensity]
    img, masks = random_flip(rng, img, masks, p["flip"])
    img, masks = random_rotation(rng, img, masks, p["rotate"])
    img, masks = random_crop(rng, img, masks, p["crop"])
    img = color_enhance(rng, img, intensity)
    img = random_blur(rng, img, p["blur"])
    img = random_gamma(rng, img, p["gamma"])
    if enable_pepper:
        img = random_pepper(rng, img, p["pepper"])
    return img, masks


def normalize_image(arr):
    """[0,1] float RGB (H, W, 3) -> ImageNet-normalized."""
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_image(arr):
    return arr * IMAGENET_STD + IMAGENET_MEAN
