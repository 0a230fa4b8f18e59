"""kgbench base64Image literal vectorizer.

The port's copy of :mod:`mrgcn_tpu.encodings.blob.image`
(without its ``Normalizer``: the model normalises the stored pixels).

Decodes base64-embedded images, converts mode, resizes preserving aspect
ratio, center-crops, and stores CHW uint8 — normalisation is deferred to the
training step to keep uint8 at rest
(reference: mrgcn/encodings/blob/image.py:59-128, 139-166; the deferred-
normalisation memory trick at image.py:78).
"""

from __future__ import annotations

import base64
import logging
from io import BytesIO
from typing import Dict, List, Optional

import numpy as np

from mrgcn_tpu_torch.data.rdf import KGBENCH
from mrgcn_tpu_torch.encodings.common import literal_nodes

logger = logging.getLogger(__name__)


def b64_to_img(b64string: str):
    from PIL import Image
    return Image.open(BytesIO(base64.urlsafe_b64decode(b64string.encode())))


def resize(im, size: int, interpolate_mode):
    """Aspect-preserving resize so the short side equals ``size``
    (reference: blob/image.py:109-118)."""
    w, h = im.size
    if w == size and h == size:
        return im
    if w == h:
        return im.resize((size, size), interpolate_mode)
    if w > h:
        return im.resize(((size * w) // h, size), interpolate_mode)
    return im.resize((size, (h * size) // w), interpolate_mode)


def center_crop(im, size: int):
    w, h = im.size
    left = int(w / 2 - size / 2)
    top = int(h / 2 - size / 2)
    return im.crop((left, top, left + size, top + size))


def generate_features(nodes_map: Dict, node_predicate_map: Dict,
                      config: Dict) -> Optional[List]:
    from PIL import Image

    transform = config["transform"]
    im_mode = transform["mode"]
    channels = len(im_mode)
    im_size_cropped = transform["centerCrop"]
    im_size_base = transform["resizeSize"]
    interpolation = getattr(Image, transform["interpolationMode"])

    encodings: Dict[object, List[np.ndarray]] = {}
    node_idx: Dict[object, List[int]] = {}

    failed = 0
    for node, i in literal_nodes(nodes_map, KGBENCH + "base64Image"):
        try:
            im = b64_to_img(str(node))
            if im.mode != im_mode:
                im = im.convert(im_mode)
            im = resize(im, im_size_base, interpolation)
            im = center_crop(im, im_size_cropped)
        except (ValueError, OSError):
            failed += 1
            continue

        a = np.array(im, dtype=np.uint8)  # HWC (or HW for single channel)
        if a.ndim == 2:
            a = a[None, :, :]
        else:
            a = a.transpose((2, 0, 1))  # CHW

        for p in node_predicate_map.get(node, ()):
            encodings.setdefault(p, []).append(a)
            node_idx.setdefault(p, []).append(i)

    total = sum(len(v) for v in encodings.values())
    logger.debug("Generated %d unique base64Image encodings (%d failed)",
                 total, failed)
    if total <= 0:
        return None

    out = []
    for p in encodings:
        enc = np.stack(encodings[p]).astype(np.uint8)
        M = enc.shape[0]
        out.append([enc,
                    np.asarray(node_idx[p], dtype=np.int32),
                    -np.ones(M, dtype=np.float32)])
    return out
