"""Packed, memory-mappable image feature store (the port's copy of
``vqa_attention_networks_tpu/data/feature_store.py``): the reader, its
writer, int8 quantisation and ``quantize_store``, the reader over the
per-split stores (``CombinedFeatureStore``, ``open_feature_store``), and
the synthetic store of the tests and ``chip_smoke.py``.

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

    def append_batch(self, image_ids: Sequence[int],
                     features: np.ndarray) -> None:
        """Append a [B, num_regions, channels] batch of grids."""
        features = self._narrow(features)
        if features.shape[1:] != (self.num_regions, self.channels):
            raise ValueError(f"grids of shape {features.shape[1:]}, store "
                             f"takes {(self.num_regions, self.channels)}")
        if len(image_ids) != features.shape[0]:
            # a mismatch would shift every later row of the store
            raise ValueError(f"{len(image_ids)} ids for {features.shape[0]} "
                             "feature rows")
        self._file.write(features.tobytes())
        self._image_ids.extend(int(i) for i in image_ids)

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

    def all_rows(self) -> np.ndarray:
        """Every row handle in dense order (as ``CombinedFeatureStore``)."""
        return np.arange(len(self), dtype=np.int64)

    def dense_rows(self, rows: np.ndarray) -> np.ndarray:
        """Row handles are already dense [0, n) positions here."""
        return np.asarray(rows)

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


class CombinedFeatureStore:
    """Reader over several stores (the per-split stores the extraction CLI
    writes: ``resnet152_train`` + ``resnet152_val``), routing each image_id
    to the store that holds it. COCO train and val image ids are disjoint,
    so the union index is unambiguous; a duplicate id raises. A row handle
    is ``(store << 40) | row``."""

    def __init__(self, stores: Sequence[FeatureStore]):
        if not stores:
            raise ValueError("need at least one store")
        self.stores = list(stores)
        self.num_regions = stores[0].num_regions
        self.channels = stores[0].channels
        for store in self.stores[1:]:
            if (store.num_regions, store.channels) != (self.num_regions,
                                                       self.channels):
                raise ValueError(
                    "cannot combine stores with different geometry: "
                    f"{(self.num_regions, self.channels)} vs "
                    f"{(store.num_regions, store.channels)}")
        self._owner: Dict[int, int] = {}
        for si, store in enumerate(self.stores):
            for img_id, row in store.row_of.items():
                if img_id in self._owner:
                    raise ValueError(
                        f"image_id {img_id} appears in more than one member "
                        "store — combined stores need disjoint id spaces")
                self._owner[img_id] = (si << 40) | row

    def __len__(self) -> int:
        return sum(len(s) for s in self.stores)

    def rows_for(self, image_ids: Iterable[int]) -> np.ndarray:
        return np.asarray([self._owner[int(i)] for i in image_ids],
                          dtype=np.int64)

    def _split(self, rows: np.ndarray) -> tuple:
        rows = np.asarray(rows)
        return rows >> 40, rows & ((1 << 40) - 1)

    def gather_rows(self, rows: np.ndarray, dtype=np.float32) -> np.ndarray:
        store_idx, local = self._split(rows)
        out = np.empty((len(local), self.num_regions, self.channels),
                       dtype=dtype)
        for si in np.unique(store_idx):
            sel = store_idx == si
            out[sel] = self.stores[int(si)].gather_rows(local[sel], dtype)
        return out

    def gather(self, image_ids: Sequence[int], dtype=np.float32) -> np.ndarray:
        return self.gather_rows(self.rows_for(image_ids), dtype)

    @property
    def quantized(self) -> bool:
        return all(s.quantized for s in self.stores)

    def all_rows(self) -> np.ndarray:
        """Every row handle, in store-concatenation order."""
        return np.concatenate([
            (np.int64(si) << 40) | np.arange(len(s), dtype=np.int64)
            for si, s in enumerate(self.stores)
        ])

    def dense_rows(self, rows: np.ndarray) -> np.ndarray:
        """Row handles -> dense positions in [0, len(self))."""
        store_idx, local = self._split(rows)
        offsets = np.cumsum([0] + [len(s) for s in self.stores[:-1]])
        return offsets[store_idx] + local

    def gather_rows_quantized(self, rows: np.ndarray):
        if not self.quantized:
            raise ValueError("gather_rows_quantized needs int8 stores")
        store_idx, local = self._split(rows)
        q = np.empty((len(local), self.num_regions, self.channels), np.int8)
        s = np.empty((len(local), self.channels), np.float16)
        for si in np.unique(store_idx):
            sel = store_idx == si
            q[sel], s[sel] = self.stores[int(si)].gather_rows_quantized(
                local[sel])
        return q, s

    def gather_quantized(self, image_ids: Sequence[int]):
        return self.gather_rows_quantized(self.rows_for(image_ids))


def open_feature_store(data_dir: str, feature_type: str = "resnet152"):
    """Open whatever store layout exists: a combined ``<ft>_all``
    directory, or the per-split ``<ft>_train`` + ``<ft>_val`` pair."""
    all_dir = join(data_dir, f"{feature_type}_all")
    if os.path.exists(join(all_dir, INDEX_FILE)):
        return FeatureStore(all_dir)
    stores = [FeatureStore(d) for d in (
        join(data_dir, f"{feature_type}_{split}") for split in ("train", "val"))
        if os.path.exists(join(d, INDEX_FILE))]
    if not stores:
        raise FileNotFoundError(
            f"no feature store under {data_dir} for {feature_type!r} "
            f"(looked for _all, _train, _val)")
    return stores[0] if len(stores) == 1 else CombinedFeatureStore(stores)


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


def quantize_store(src_dir: str, dst_dir: str,
                   batch: int = 256) -> FeatureStore:
    """Convert an f16 or f32 store to int8 with per-channel scales,
    streaming ``batch`` rows at a time."""
    src = FeatureStore(src_dir)
    if src.quantized:
        raise ValueError(f"{src_dir} is already int8")
    ids = [None] * len(src)
    for img_id, row in src.row_of.items():
        ids[row] = img_id
    with FeatureStoreWriter(dst_dir, src.num_regions, src.channels,
                            "int8") as w:
        for start in range(0, len(src), batch):
            rows = np.arange(start, min(start + batch, len(src)))
            w.append_batch([ids[r] for r in rows],
                           np.asarray(src.features[rows], np.float32))
    return FeatureStore(dst_dir)
