"""Image IO (reference: luminoth/io.py:7-17)."""

import numpy as np
from PIL import Image


def read_image(path):
    """Read an image file into an RGB uint8 ndarray."""
    return np.asarray(Image.open(path).convert("RGB"))
