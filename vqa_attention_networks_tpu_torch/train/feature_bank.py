"""The training feature bank (``Config.device_feature_bank``): the whole
feature store in device memory, one copy on each rank's device (port of
``Solver._build_feature_bank`` in ``vqa_attention_networks_tpu/train/
solver.py:369-534``, its replicated placement). Under data parallelism
each rank uploads the whole store and looks up the rows of its own slice
of each batch. The sharded bank and its ring exchange are ROADMAP Queue 1
item 10b.

Batches then carry dense row indices (``data/dataset.py``, ``device_bank=
True``) and ``lookup`` gathers their rows on the device with
``index_select``, as ``aot.serving_forward_banked`` does: no feature bytes
cross the host link during training. The training twin of serving's
``DeviceFeatureCache``.

- **The bytes the host feed would ship.** An int8 store keeps its int8 rows
  and f16 scales, and the lookup applies the int8 feed's dequant,
  ``q.to(dt) * s[:, None, :].to(dt)`` (``dequantize``); a float store's
  rows are held in f16 when the store is f16 (even under f32 compute: the
  lookup's upcast to the feed's f32 is exact), and emitted in the feed's
  dtype. So training from the bank is bit-equal to the host feed.
- **Dense rows.** The table is filled in ``store.all_rows()`` order, so a
  ``CombinedFeatureStore``'s encoded handles map to its dense positions.
- **Budget.** The size is checked against ``Config.device_feature_bank_
  budget`` before anything is uploaded. At 196 x 2048 an image is 405,504
  bytes in int8 with its scales, 802,816 in f16: the full VQA v2
  train+val store (123,287 images) is ~50 GB in int8, which fits an 80 GB
  card beside the model, and ~99 GB in f16, which does not. The default
  budget stays JAX's 8 GiB.
- **Upload** in chunks of about ``UPLOAD_CHUNK_BYTES``, so the host never
  holds a second full copy of the store.
"""

from __future__ import annotations

import numpy as np
import torch

UPLOAD_CHUNK_BYTES = 64 << 20


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """The int8 feed's dequant on the device: int8 rows [B, L, C] times
    their f16 scales [B, C], in ``dtype`` (JAX ``solver.py:203-205``), for
    the training feed, this bank and ``aot.serving_forward``'s int8 feed."""
    return q.to(dtype) * scale[:, None, :].to(dtype)


def _native_f16(store) -> bool:
    if hasattr(store, "stores"):
        return all(_native_f16(s) for s in store.stores)
    return getattr(getattr(store, "features", None), "dtype", None) \
        == np.float16


class FeatureBank:
    """The store's rows on ``device``; ``lookup(rows)`` -> the batch the
    host feed would have given, in ``feed_dtype`` (the dequant's dtype for
    an int8 store)."""

    def __init__(self, store, feed_dtype: torch.dtype, budget: int,
                 device: torch.device):
        n = len(store)
        self.quantized = bool(getattr(store, "quantized", False))
        self.feed_dtype = feed_dtype
        regions, channels = store.num_regions, store.channels
        table_np = (np.int8 if self.quantized
                    else np.float16 if _native_f16(store)
                    or feed_dtype != torch.float32 else np.float32)
        row_bytes = regions * channels * np.dtype(table_np).itemsize + (
            channels * 2 if self.quantized else 0)
        if n * row_bytes > budget:
            raise ValueError(
                f"device_feature_bank: store needs "
                f"{n * row_bytes / 2**30:.1f} GiB on the device ({n} images "
                f"x {row_bytes} B), over the {budget / 2**30:.1f} GiB "
                "budget (Config.device_feature_bank_budget). Quantize the "
                "store (data.feature_store.quantize_store, 2-4x smaller), "
                "raise the budget if the card has headroom (cli/train.py "
                "--device_feature_bank_budget GIB), or fall back to the "
                "host feed.")
        self.rows = torch.empty((n, regions, channels),
                                dtype=getattr(torch, np.dtype(table_np).name),
                                device=device)
        self.scale = (torch.empty((n, channels), dtype=torch.float16,
                                  device=device) if self.quantized else None)
        all_rows = store.all_rows()
        step = max(1, UPLOAD_CHUNK_BYTES // row_bytes)
        for s in range(0, n, step):
            handles = all_rows[s:s + step]
            if self.quantized:
                q, sc = store.gather_rows_quantized(handles)
                self.rows[s:s + len(handles)].copy_(torch.from_numpy(q))
                self.scale[s:s + len(handles)].copy_(torch.from_numpy(
                    np.ascontiguousarray(sc, dtype=np.float16)))
            else:
                self.rows[s:s + len(handles)].copy_(torch.from_numpy(
                    store.gather_rows(handles, dtype=table_np)))

    @property
    def nbytes(self) -> int:
        return self.rows.nbytes + (self.scale.nbytes if self.quantized
                                   else 0)

    def lookup(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows [B] (int64, on the bank's device) -> [B, L, C]."""
        if self.quantized:
            return dequantize(self.rows.index_select(0, rows),
                              self.scale.index_select(0, rows),
                              self.feed_dtype)
        return self.rows.index_select(0, rows).to(self.feed_dtype)
