"""Small host utilities (the reference's src/utils.py leftovers).

Counterpart of mapping_tpu/utils/misc.py, in numpy; the chunker takes the
port's metadata rows (a list of dicts, data/metadata.read_metadata) where
the JAX package takes a pandas DataFrame.
"""

import math

import numpy as np

from mapping_tpu_torch.constants import MEAN, STD


def softmax(x, axis=-1):
    """Numerically stable float64 softmax along `axis`."""
    x = np.asarray(x, dtype=np.float64)
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def denormalize_img(image, mean=MEAN, std=STD):
    """Undo the ImageNet normalisation of (..., H, W, 3) NHWC or (3, H, W)
    CHW images."""
    image = np.asarray(image)
    if image.shape[-1] == 3:
        return image * np.asarray(std) + np.asarray(mean)
    return (image * np.asarray(std).reshape(3, 1, 1)
            + np.asarray(mean).reshape(3, 1, 1))


def generate_data_frame_chunks(meta, chunk_size):
    """Consecutive chunks of at most `chunk_size` metadata rows."""
    for i in range(math.ceil(len(meta) / chunk_size)):
        yield meta[i * chunk_size:(i + 1) * chunk_size]


class Averager:
    """Running mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def send(self, value):
        self.sum += float(value)
        self.count += 1

    @property
    def value(self):
        return self.sum / self.count if self.count else 0.0
