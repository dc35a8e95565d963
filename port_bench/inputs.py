"""The weights and image features the benchmark hands to the program and to
the reference alike.

- ``weights``: every leaf of a configuration (its reference's
  ``param_shapes``) drawn from the run's seed on the card, in two calls
  (one uniform draw for the xavier weights and biases, one normal draw),
  float32 as the program keeps its parameters;
- ``f16_store``: a feature store in the program's format (ResNet-like
  grids, ReLU of a normal draw, float16), written once into the checkout's
  ``build/port_bench/`` and read by every later run there: its content is
  the same for every seed (the seed draws which image each question asks
  about), so no run but a checkout's first writes 1.6 GB;
- ``Int8Bank``: int8 grids and per-image float16 scales for the device
  feature banks, a small pool of grids drawn from the seed on the card and
  a scale of its own for every image id, so every image's features differ;
  it reads as an int8 store in host memory (the calls of the program's
  ``FeatureStore`` that the training bank makes), so no run writes it.
"""

from __future__ import annotations

import math
import os
import shutil
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from port_bench.harness import ROOT

BIAS_SCALE = 0.02  # biases are U(-0.02, 0.02): nonzero, so they are checked
CACHE = ROOT / "build" / "port_bench"
STORE_SEED = 0x5EED  # the f16 store's content, the same for every run


def weights(shapes: Dict[str, Tuple[Tuple[int, ...], str]], seed: int,
            device) -> Dict[str, torch.Tensor]:
    """Leaf -> float32 tensor on ``device``, drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uniform = [k for k, (_, init) in shapes.items()
               if not init.startswith("normal")]
    normal = [k for k in shapes if k not in uniform]
    size = {k: math.prod(shape) for k, (shape, _) in shapes.items()}
    u = torch.rand(sum(size[k] for k in uniform), generator=gen,
                   device=device)
    z = torch.randn(sum(size[k] for k in normal) or 1, generator=gen,
                    device=device)
    out, at = {}, 0
    for k in uniform:
        shape, init = shapes[k]
        scale = (BIAS_SCALE if init == "bias"
                 else math.sqrt(6.0 / (shape[0] + shape[-1])))
        out[k] = ((u[at:at + size[k]] * 2 - 1) * scale).reshape(shape)
        at += size[k]
    at = 0
    for k in normal:
        shape, init = shapes[k]
        out[k] = (z[at:at + size[k]] * float(init.split(":")[1])
                  ).reshape(shape)
        at += size[k]
    return out


def tree(flat: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The program's argument: the JAX-layout tree of host arrays."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        layer, leaf = key.split("/")
        out.setdefault(layer, {})[leaf] = value.detach().cpu().numpy()
    return out


def f16_store(n_images: int, regions: int, channels: int, device,
              cache: Optional[Path] = None) -> Path:
    """The directory of an f16 store of ``n_images`` grids (ids 0..n-1),
    written on first use under ``cache`` (default ``CACHE``)."""
    from vqa_attention_networks_tpu_torch.data.feature_store import (
        FeatureStoreWriter,
    )

    path = Path(cache or CACHE) / f"store_f16_{n_images}x{regions}x{channels}"
    if (path / "index.json").exists():
        return path
    part = path.with_name(path.name + ".part")
    shutil.rmtree(part, ignore_errors=True)
    gen = torch.Generator(device=device).manual_seed(STORE_SEED)
    chunk = 64
    with FeatureStoreWriter(str(part), regions, channels, "float16") as w:
        for start in range(0, n_images, chunk):
            n = min(chunk, n_images - start)
            grid = torch.relu(torch.randn(n, regions, channels,
                                          generator=gen, device=device))
            w.append_batch(range(start, start + n),
                           grid.half().cpu().numpy())
    os.replace(part, path)
    return path


def store_rows(path: Path) -> np.ndarray:
    """The raw f16 grids of a store written by ``f16_store`` (image id i is
    row i), read from its file as the reference reads it."""
    import json

    with open(Path(path) / "index.json") as f:
        shape = tuple(json.load(f)["shape"])
    return np.memmap(Path(path) / "features.bin", dtype=np.float16,
                     mode="r", shape=shape)


class Int8Bank:
    """int8 rows and f16 scales of ``n_images`` image ids from ``seed``:
    image i is grid ``pool[pick[i]]`` at scale ``scale[i]`` (per channel).
    ``fetch`` is the signature of the int8 store's ``gather_quantized``;
    image id i is row i of the store it reads as."""

    quantized = True

    def __init__(self, n_images: int, regions: int, channels: int,
                 pool: int, seed: int, device):
        self.num_regions, self.channels = regions, channels
        gen = torch.Generator(device=device).manual_seed(int(seed) ^ 0xB4)
        grids = torch.relu(torch.randn(pool, regions, channels,
                                       generator=gen, device=device))
        self.pool = torch.clamp(torch.round(grids * 32), 0, 127).to(
            torch.int8).cpu().numpy()
        self.scale = (0.02 + 0.02 * torch.rand(
            n_images, channels, generator=gen, device=device)).half(
            ).cpu().numpy()
        self.pick = torch.randint(0, pool, (n_images,), generator=gen,
                                  device=device).cpu().numpy()

    def fetch(self, image_ids: Sequence[int]) -> Tuple[np.ndarray,
                                                       np.ndarray]:
        ids = np.asarray(image_ids, dtype=np.int64)
        return self.pool[self.pick[ids]], self.scale[ids]

    def __len__(self) -> int:
        return len(self.pick)

    def rows_for(self, image_ids: Sequence[int]) -> np.ndarray:
        return np.asarray(image_ids, dtype=np.int64)

    def all_rows(self) -> np.ndarray:
        return np.arange(len(self), dtype=np.int64)

    def dense_rows(self, rows: np.ndarray) -> np.ndarray:
        return np.asarray(rows)

    gather_rows_quantized = gather_quantized = fetch

    def features(self, image_ids: Sequence[int], device) -> torch.Tensor:
        """The reference's features: int8 times the f16 scale, float32."""
        rows, scale = self.fetch(image_ids)
        return (torch.from_numpy(rows).to(device).float()
                * torch.from_numpy(scale).to(device).float()[:, None, :])
