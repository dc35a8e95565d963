"""The training feature bank (``Config.device_feature_bank``): the whole
feature store in device memory (port of ``Solver._build_feature_bank`` in
``vqa_attention_networks_tpu/train/solver.py:369-534``), in either of
JAX's placements:

- **replicated**: one copy on each rank's device; under data parallelism
  each rank looks up the rows of its own slice of each batch;
- **sharded over the data ranks** (``Config.device_feature_bank_shard``,
  ``shard=(d, D)``): data rank d holds the row block ``[d*n/D,
  (d+1)*n/D)``, the store padded with zero rows so that D divides it (JAX
  ``solver.py:433``), so a rank's bytes drop D-fold. The lookup is JAX's
  ring exchange (``_ring_lookup``, ``lax.ppermute``): each rank's
  (indices, accumulator) pair travels around the data group, and at each
  stop the local block fills the rows it owns by ``torch.where``, never a
  float add; D moves bring the pair home having visited every block. The
  pair carries the stored bytes (int8 rows and f16 scales, or the float
  rows), dequantised once at home, so the result is bit-equal to the
  replicated bank and the host feed. The transport follows the group's
  backend: NCCL sends device tensors (``batch_isend_irecv``); gloo, which
  sends no CUDA tensor, sends host copies.

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
- **Budget.** A rank's size (its block, under the sharded placement) is
  checked against ``Config.device_feature_bank_budget`` before anything
  is uploaded; where a replicated bank over D > 1 data ranks would not
  fit, the message names the sharded one, as JAX's does. At 196 x 2048 an image is 405,504
  bytes in int8 with its scales, 802,816 in f16: the full VQA v2
  train+val store (123,287 images) is ~50 GB in int8, which fits an 80 GB
  card beside the model, and ~99 GB in f16, which does not. The default
  budget stays JAX's 8 GiB.
- **Upload** in chunks of about ``UPLOAD_CHUNK_BYTES``, so the host never
  holds a second full copy of the store.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

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
    an int8 store). ``shard=(d, D)``: data rank d's block of D, the ring's
    ranks being ``group``'s; ``data_size``: the data ranks of a replicated
    bank (the budget message's hint)."""

    def __init__(self, store, feed_dtype: torch.dtype, budget: int,
                 device: torch.device,
                 shard: Optional[Tuple[int, int]] = None, group=None,
                 data_size: int = 1):
        n = len(store)
        self.quantized = bool(getattr(store, "quantized", False))
        self.feed_dtype = feed_dtype
        self.shard, self.group = shard, group
        regions, channels = store.num_regions, store.channels
        table_np = (np.int8 if self.quantized
                    else np.float16 if _native_f16(store)
                    or feed_dtype != torch.float32 else np.float32)
        row_bytes = regions * channels * np.dtype(table_np).itemsize + (
            channels * 2 if self.quantized else 0)
        ways = shard[1] if shard is not None else 1
        n_rows = n + (-n % ways)  # zero rows pad the store so D divides it
        per = n_rows // ways
        if per * row_bytes > budget:
            hint = (" shard the bank over the data ranks "
                    "(Config.device_feature_bank_shard: a rank's bytes drop "
                    f"{data_size}x to "
                    f"{-(-n // data_size) * row_bytes / 2**30:.1f} GiB),"
                    if shard is None and data_size > 1 else "")
            raise ValueError(
                f"device_feature_bank: store needs "
                f"{per * row_bytes / 2**30:.1f} GiB a device ({n} images "
                f"x {row_bytes} B"
                f"{f', sharded {ways}-way' if shard is not None else ''}), "
                f"over the {budget / 2**30:.1f} GiB "
                "budget (Config.device_feature_bank_budget). Quantize the "
                "store (data.feature_store.quantize_store, 2-4x smaller),"
                f"{hint} raise the budget if the card has headroom "
                "(cli/train.py --device_feature_bank_budget GIB), or fall "
                "back to the host feed.")
        first = shard[0] * per if shard is not None else 0
        self.first, self.per = first, per
        self.rows = torch.empty((per, regions, channels),
                                dtype=getattr(torch, np.dtype(table_np).name),
                                device=device)
        self.scale = (torch.empty((per, channels), dtype=torch.float16,
                                  device=device) if self.quantized else None)
        # this block's rows of the store; past n, the zero padding
        all_rows = store.all_rows()[first:min(first + per, n)]
        for t in (self.rows, self.scale):
            if t is not None:
                t[len(all_rows):].zero_()
        step = max(1, UPLOAD_CHUNK_BYTES // row_bytes)
        for s in range(0, len(all_rows), step):
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
        """This rank's bytes of the bank (its block, when sharded)."""
        return self.rows.nbytes + (self.scale.nbytes if self.quantized
                                   else 0)

    def lookup(self, rows: torch.Tensor) -> torch.Tensor:
        """Rows [B] (int64, on the bank's device) -> [B, L, C]. Sharded:
        every data rank of the group calls this together (the ring)."""
        if self.shard is not None and self.shard[1] > 1:
            tables = ring_lookup(
                [t for t in (self.rows, self.scale) if t is not None],
                rows, self.first, self.group)
        else:
            tables = [t.index_select(0, rows)
                      for t in (self.rows, self.scale) if t is not None]
        if self.quantized:
            return dequantize(*tables, self.feed_dtype)
        return tables[0].to(self.feed_dtype)


def ring_lookup(blocks, rows: torch.Tensor, first: int, group):
    """JAX's ``_ring_lookup`` over ``group``: this rank holds rows
    ``[first, first + len(block))`` of each table of ``blocks``; every rank
    of the group passes its own ``rows`` (global indices). -> each table's
    ``rows``, on this rank. The (indices, accumulators) pair moves D times
    around the ring; at each stop the rows this rank's block owns are
    written by ``torch.where``."""
    ways = dist.get_world_size(group)
    me = dist.get_rank(group)
    send_to = dist.get_global_rank(group, (me + 1) % ways)
    recv_from = dist.get_global_rank(group, (me - 1) % ways)
    gloo = dist.get_backend(group) == "gloo"
    per = blocks[0].shape[0]
    idx = rows
    accs = [b.new_zeros((rows.shape[0], *b.shape[1:])) for b in blocks]
    for _ in range(ways):
        local = idx - first
        owned = (local >= 0) & (local < per)
        safe = local.clamp(0, per - 1)
        accs = [torch.where(owned.view(-1, *[1] * (b.dim() - 1)),
                            b.index_select(0, safe), acc)
                for b, acc in zip(blocks, accs)]
        moved = []
        for t in (idx, *accs):
            out = t.cpu() if gloo else t.contiguous()
            buf = torch.empty_like(out)
            moved.append((out, buf))
        ops = []
        for out, buf in moved:
            ops += [dist.P2POp(dist.isend, out, send_to, group),
                    dist.P2POp(dist.irecv, buf, recv_from, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        idx, *accs = [buf.to(rows.device) for _, buf in moved]
    return accs
