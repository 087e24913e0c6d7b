"""Detector training augmentations — host-side numpy.

Reference ``maskrcnn_benchmark/data/transforms/transforms.py`` +
``build.py``: training applies Resize, RandomHorizontalFlip (prob 0.5),
optional RandomVerticalFlip and ColorJitter; test applies Resize only
(the CPT extraction configs comment Resize out — handled by
``tools/extract_features.load_image``). Flip box math follows
``structures/bounding_box.py`` transpose with the inclusive TO_REMOVE=1
convention (``x1' = W - x2 - 1``).

Augmentation runs on the host per sample (cheap next to the device step);
images stay uint8/float32 numpy until the canvas upload.

The port's copy of ``cpt_tpu/data/detector_transforms.py`` (its code
unchanged, its imports pointed at the port's modules).
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np

TO_REMOVE = 1


def hflip(image: np.ndarray, boxes: np.ndarray
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Horizontal flip (transforms.py:67-75 via BoxList.transpose)."""
    w = image.shape[1]
    out = boxes.copy()
    out[:, 0] = w - boxes[:, 2] - TO_REMOVE
    out[:, 2] = w - boxes[:, 0] - TO_REMOVE
    return np.ascontiguousarray(image[:, ::-1]), out


def vflip(image: np.ndarray, boxes: np.ndarray
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Vertical flip (transforms.py:77-85)."""
    h = image.shape[0]
    out = boxes.copy()
    out[:, 1] = h - boxes[:, 3] - TO_REMOVE
    out[:, 3] = h - boxes[:, 1] - TO_REMOVE
    return np.ascontiguousarray(image[::-1]), out


def color_jitter(image: np.ndarray, rng: random.Random,
                 brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0) -> np.ndarray:
    """torchvision-style ColorJitter (transforms.py:87-103): factors drawn
    uniformly from [1-x, 1+x] (hue from [-hue, hue]), applied in a random
    order; grayscale via the ITU-R 601 luma weights."""
    img = image.astype(np.float32)

    def adj_brightness(im):
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        return im * f

    def adj_contrast(im):
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        mean = (im @ np.asarray([0.299, 0.587, 0.114],
                                np.float32)).mean()
        return im * f + mean * (1 - f)

    def adj_saturation(im):
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        gray = im @ np.asarray([0.299, 0.587, 0.114], np.float32)
        return im * f + gray[..., None] * (1 - f)

    def adj_hue(im):
        # cheap hue rotation via channel-mix (exact HSV round-trip is not
        # needed: VinVL configs leave hue at 0)
        f = rng.uniform(-hue, hue)
        if f == 0:
            return im
        mean = im.mean(-1, keepdims=True)
        return im + (np.roll(im, 1, axis=-1) - mean) * f

    ops = []
    if brightness > 0:
        ops.append(adj_brightness)
    if contrast > 0:
        ops.append(adj_contrast)
    if saturation > 0:
        ops.append(adj_saturation)
    if hue > 0:
        ops.append(adj_hue)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return np.clip(img, 0, 255).astype(image.dtype)


class TrainTransforms:
    """Compose of the reference's training augmentations
    (``transforms/build.py:5-35``)."""

    def __init__(self, hflip_prob: float = 0.5, vflip_prob: float = 0.0,
                 brightness: float = 0.0, contrast: float = 0.0,
                 saturation: float = 0.0, hue: float = 0.0,
                 seed: int = 0):
        self.hflip_prob = hflip_prob
        self.vflip_prob = vflip_prob
        self.jitter = (brightness, contrast, saturation, hue)
        self.rng = random.Random(seed)

    def __call__(self, image: np.ndarray, boxes: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        if any(v > 0 for v in self.jitter):
            image = color_jitter(image, self.rng, *self.jitter)
        if self.rng.random() < self.hflip_prob:
            image, boxes = hflip(image, boxes)
        if self.rng.random() < self.vflip_prob:
            image, boxes = vflip(image, boxes)
        return image, boxes
