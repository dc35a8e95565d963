"""Packed, memory-mappable image feature store (the port's copy of
``vqa_attention_networks_tpu/data/feature_store.py``, trimmed to what the
port uses: the store reader, its writer, int8 quantisation and the
synthetic store of the tests and ``chip_smoke.py``).

One packed binary per store, written by either package and read by both:

    <dir>/features.bin    float16 (or int8), [num_images, 196, 2048], row-major
    <dir>/scales.bin      int8 stores only: f16 scales, [num_images, 2048]
    <dir>/index.json      {"image_ids": [...], "shape": [...], "dtype": ...}

A batch gather is one fancy-index into a memmap (or one native call,
``data/native.py``): no per-item Python or file I/O.
"""

from __future__ import annotations

import json
import os
from os.path import join
from typing import Dict, Iterable, Sequence

import numpy as np

from vqa_attention_networks_tpu_torch.data import native

FEATURES_FILE = "features.bin"
INDEX_FILE = "index.json"
SCALES_FILE = "scales.bin"  # int8 stores: per-image-per-channel f16 scales


def quantize_features(features: np.ndarray):
    """int8 symmetric quantisation, one f16 scale per (image, channel) ->
    ``(int8 [B, L, C], f16 scales [B, C], n_clamped)``.

    The scale is computed in f32 and clamped into f16's finite range (a
    channel max above 127 * 65504 would overflow it to inf and the dequant
    to NaN); elements beyond that range saturate and are counted."""
    features = np.asarray(features, np.float32)
    if features.ndim == 2:
        features = features[None]
    amax = np.abs(features).max(axis=1)  # [B, C]
    f16_max = float(np.finfo(np.float16).max)
    scale = np.minimum(amax / 127.0, f16_max).astype(np.float16)
    # an all-zero channel has scale 0: any nonzero divisor round-trips it
    safe = np.where(scale > 0, scale.astype(np.float32), 1.0)
    q = np.rint(features / safe[:, None, :])
    # only a true range overflow counts: the f16 rounding of the scale can
    # push |q| to 128 by half an LSB, which the clip absorbs
    clamped = int((np.abs(features) > 127.0 * f16_max).sum())
    q = np.clip(q, -127, 127).astype(np.int8)
    return q, scale, clamped


class FeatureStoreWriter:
    """Streaming writer of a store, one image grid at a time."""

    def __init__(self, directory: str, num_regions: int = 196,
                 channels: int = 2048, dtype: str = "float16"):
        self.directory = directory
        self.num_regions = num_regions
        self.channels = channels
        self.dtype = np.dtype(dtype)
        os.makedirs(directory, exist_ok=True)
        self._file = open(join(directory, FEATURES_FILE), "wb")
        self._scales_file = (
            open(join(directory, SCALES_FILE), "wb")
            if self.dtype == np.int8 else None
        )
        self._image_ids: list = []
        self.clamped = 0  # elements saturated into the store dtype's range

    def _narrow(self, features: np.ndarray) -> np.ndarray:
        """Cast to the store dtype, clamping instead of overflowing to inf;
        a non-finite input is refused (a poisoned store would surface only
        as NaN losses far from the cause)."""
        features = np.asarray(features)
        bad = int((~np.isfinite(features)).sum())
        if bad:
            raise ValueError(
                f"{bad} non-finite feature values — refusing to write a "
                "poisoned store"
            )
        if self.dtype == np.int8:
            q, scale, clamped = quantize_features(features)
            self.clamped += clamped
            self._scales_file.write(np.ascontiguousarray(scale).tobytes())
            return q
        if (self.dtype == np.float16
                and features.dtype.itemsize > self.dtype.itemsize):
            lim = float(np.finfo(np.float16).max)
            over = int((np.abs(features) > lim).sum())
            if over:
                self.clamped += over
                features = np.clip(features, -lim, lim)
        return np.ascontiguousarray(features, dtype=self.dtype)

    def append(self, image_id: int, features: np.ndarray) -> None:
        """Append one image's [num_regions, channels] grid."""
        if np.ndim(features) != 2:
            # a [B, R, C] batch through the int8 path would write B scale
            # rows for one feature row and misalign every later image
            raise ValueError(f"append takes one [R, C] grid, got "
                             f"{np.shape(features)}")
        features = self._narrow(features)
        if self.dtype == np.int8:
            features = features[0]
        if features.shape != (self.num_regions, self.channels):
            raise ValueError(f"grid of shape {features.shape}, store takes "
                             f"{(self.num_regions, self.channels)}")
        self._file.write(features.tobytes())
        self._image_ids.append(int(image_id))

    def close(self) -> None:
        self._file.close()
        if self._scales_file is not None:
            self._scales_file.close()
        if self.clamped:
            print(f"WARNING: {self.clamped} feature elements exceeded the "
                  f"{self.dtype.name} range and were clamped")
        with open(join(self.directory, INDEX_FILE), "w") as f:
            json.dump({
                "image_ids": self._image_ids,
                "shape": [len(self._image_ids), self.num_regions,
                          self.channels],
                "dtype": self.dtype.name,
            }, f)

    def __enter__(self) -> "FeatureStoreWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            # no index.json: a partial store must not look complete
            self._file.close()
            if self._scales_file is not None:
                self._scales_file.close()
            return
        self.close()


class FeatureStore:
    """Memory-mapped reader with an image_id -> row index."""

    def __init__(self, directory: str):
        with open(join(directory, INDEX_FILE)) as f:
            index = json.load(f)
        shape = tuple(index["shape"])
        self.features = np.memmap(
            join(directory, FEATURES_FILE), dtype=np.dtype(index["dtype"]),
            mode="r", shape=shape,
        )
        self.scales = None
        if self.features.dtype == np.int8:
            self.scales = np.memmap(
                join(directory, SCALES_FILE), dtype=np.float16, mode="r",
                shape=(shape[0], shape[2]),
            )
        self.row_of: Dict[int, int] = {
            img_id: row for row, img_id in enumerate(index["image_ids"])
        }
        self.num_regions = shape[1]
        self.channels = shape[2]

    def __len__(self) -> int:
        return self.features.shape[0]

    def rows_for(self, image_ids: Iterable[int]) -> np.ndarray:
        return np.asarray([self.row_of[int(i)] for i in image_ids],
                          dtype=np.int64)

    def gather(self, image_ids: Sequence[int], dtype=np.float32) -> np.ndarray:
        """A batch of feature grids: [B, num_regions, channels]."""
        return self.gather_rows(self.rows_for(image_ids), dtype)

    @property
    def quantized(self) -> bool:
        return self.features.dtype == np.int8

    def gather_rows_quantized(self, rows: np.ndarray):
        """The int8 feed: (int8 [B, L, C], f16 scales [B, C]); the engine
        dequantises on the device."""
        if not self.quantized:
            raise ValueError("gather_rows_quantized needs an int8 store")
        rows = np.asarray(rows)
        q = native.gather_i8(self.features, rows)
        if q is None:
            q = np.asarray(self.features[rows])
        return q, np.asarray(self.scales[rows])

    def gather_quantized(self, image_ids: Sequence[int]):
        return self.gather_rows_quantized(self.rows_for(image_ids))

    def gather_rows(self, rows: np.ndarray, dtype=np.float32) -> np.ndarray:
        if self.quantized:
            if np.dtype(dtype) == np.int8:
                return np.asarray(self.features[rows])
            # host-side dequant, so every float consumer reads an int8
            # store unchanged
            q = self.features[rows].astype(np.float32)
            s = self.scales[rows].astype(np.float32)
            return (q * s[:, None, :]).astype(dtype)
        if self.features.dtype == np.float16:
            out = None
            if np.dtype(dtype) == np.float32:
                out = native.gather_f16_to_f32(self.features, np.asarray(rows))
            elif np.dtype(dtype) == np.float16:
                out = native.gather_f16(self.features, np.asarray(rows))
            if out is not None:
                return out
        return np.asarray(self.features[rows], dtype=dtype)


def make_synthetic_feature_store(
    directory: str,
    image_ids: Sequence[int],
    num_regions: int = 196,
    channels: int = 2048,
    seed: int = 0,
    dtype: str = "float16",
) -> FeatureStore:
    """Write a small random store (tests and ``chip_smoke.py``); the same
    seed writes the same bytes as the JAX package's function."""
    rng = np.random.default_rng(seed)
    with FeatureStoreWriter(directory, num_regions, channels, dtype) as w:
        for img_id in image_ids:
            w.append(img_id,
                     rng.standard_normal((num_regions, channels)) * 0.5)
    return FeatureStore(directory)
