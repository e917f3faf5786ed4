# Copied from brdf_tpu/io/images.py (host numpy; PIL is imported inside the reader, since a machine that reads no image file may lack it; the port imports nothing of brdf_tpu).
"""Image-stack loading and dark-frame subtraction.

Replaces ``CBRDFdata::LoadImages`` / ``LoadDarkImage`` / ``SubtractAmbientLight``
(``brdfdata.cpp:34-61, 117-147``). Two deliberate fixes:

- the reference hard-codes ``.jpeg`` (``brdfdata.cpp:38``) while its shipped
  datasets are ``.png``; here the extension is auto-detected;
- the reference subtracts the dark frame **twice** (once via ``operator-`` and
  once via ``cv::subtract``, ``brdfdata.cpp:140-146``); here it is subtracted
  once, with saturation at zero.

Images come back as float32 in [0, 1], channel order RGB, shape (V, H, W, 3),
matching the 1/255 scaling of ``GetIntensities_FromPixel``
(``brdfdata.cpp:945-960``; that accessor used BGR — an OpenCV artifact, not a
capability — so RGB is used here throughout).
"""

from __future__ import annotations

import os

import numpy as np

_EXTS = (".png", ".jpeg", ".jpg")


def _find_image(folder: str, stem: str) -> str | None:
    for ext in _EXTS:
        path = os.path.join(folder, stem + ext)
        if os.path.exists(path):
            return path
    return None


def _read(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def load_image_stack(folder: str, num_images: int = 16) -> np.ndarray:
    """Load ``1..num_images`` as a (V, H, W, 3) float32 stack in [0, 1]."""
    frames = []
    for i in range(1, num_images + 1):
        path = _find_image(folder, str(i))
        if path is None:
            raise FileNotFoundError(f"image {i} not found under {folder!r} ({_EXTS})")
        frames.append(_read(path))
    return np.stack(frames, axis=0)


def load_dark_frame(folder: str) -> np.ndarray | None:
    path = _find_image(folder, "dark")
    if path is None:
        return None
    return _read(path)


def subtract_dark_frame(stack: np.ndarray, dark: np.ndarray) -> np.ndarray:
    """Subtract the ambient ("dark") frame once, clamping at zero."""
    return np.clip(stack - dark[None], 0.0, 1.0)


def load_scene_images(folder: str, num_images: int = 16, subtract_dark: bool = True) -> np.ndarray:
    """Full image pipeline: load the lit stack and remove ambient light."""
    stack = load_image_stack(folder, num_images)
    if subtract_dark:
        dark = load_dark_frame(folder)
        if dark is not None:
            stack = subtract_dark_frame(stack, dark)
    return stack
