"""Batched inference engine (port of ``InferenceEngine`` and
``DeviceFeatureCache`` in ``vqa_attention_networks_tpu/serve.py``), on one
device or split over several.

- Any of the eight families (``models.get_model``), chosen by
  ``cfg.model_name``; each request's question length reaches the model as
  ``ques_length`` (MHB reads it), counted from the non-pad tokens when the
  caller gives none, and clamped at 1.
- One fixed batch size: smaller requests are padded, and the padding is
  dropped from the results.
- bf16 activations and f32 logits; on a CUDA device the family's eval
  forward launches its hand-written kernels (K1 for mhb_coAtt, K4 for
  hieCoAtten; K5 and K7 under their switches, ``ops/grid_fusion.py`` and
  ``ops/attention.py``; mhb, visLstm, iBOWIMG and attentionNet have none,
  as in JAX).
- ``predict_stream`` keeps one batch in flight: PyTorch's launches return
  before the device finishes, so the host assembles batch t+1 while the
  device runs batch t; ``_collect`` is where the results are copied to the
  host, which waits for the device. A whole batch of page-locked features
  (a store's float gather once CUDA is initialised,
  ``data/feature_store.host_empty``) goes to the card without a wait,
  through the tensor that owns its memory (``_host_tensor``).
- By id on one card the banked forward is a CUDA graph (``BankGraph``):
  a batch's padded inputs go to its static buffers through pinned memory
  without a wait, one replay runs the forward, and the top-k comes back
  into pinned host memory behind an event, so the host builds batch t's
  ``Prediction``s while the card runs batch t+1. The split engine, the
  exported artifact, the per-request feed and the CPU run eagerly.
- The device feature cache (``attach_feature_cache``,
  ``predict_batch_by_id``, ``predict_stream_by_id``): the int8 rows and f16
  scales of recently served images stay in device memory, and a request
  names its image by id, so a hit ships no feature bytes to the card.
- ``trained_params`` reads the weights ``cli.train`` exported
  (``utils/checkpoint.save_weights``) as the parameter tree the engine
  takes.
- ``artifact_dir``: the engine serves an exported program
  (``aot.save_serving_artifact``) in place of the eager forward, with its
  own weights as the program's state input (``aot.model_state``, K1's
  layout made once at load), after checking the artifact's metadata
  against itself (JAX ``serve.py:286-332``). It refuses an artifact of a
  family with a kernel whose graph calls none (``fast_path_traced``
  false) where the engine's own forward would call it, and the device
  feature cache, whose banked forward the artifact does not carry.

- ``data_parallel=N`` (JAX ``serve.py:231-270``): one process holds a
  replica of the model on each of N devices (``cuda:0..N-1``, or the
  devices named; N replicas on one named device are the counterpart of
  JAX's emulated devices), splits each padded batch on dim 0, launches
  every shard's forward before it fetches any result, and returns the
  top-k in request order. The device feature cache with N > 1 is JAX's
  sharded bank (``DeviceFeatureCache(mesh=...)``): the cache splits its
  slots over the replicas' devices and the banked forward gathers each
  shard's slots around them (``aot.serving_forward_banked_sharded``).
- While a ``torch.profiler`` session records, the engine records spans
  (``utils/trace.py``), each batch under its own id: ``serve.dispatch``
  around a batch's dispatch, with ``serve.h2d`` (each copy to the device;
  counter ``serve.h2d_bytes``, and ``serve.h2d_pinned_bytes`` for the
  bytes ``_to_device`` copied to a card without a wait from page-locked
  memory), ``bank.ensure`` and ``serve.launch`` (the
  forward's launches, or the graph's replay) inside it; ``serve.collect``
  around its collection, with ``serve.result_wait`` (the copies back, or
  the wait for a replayed batch's event) inside it. Counters
  ``serve.graph_captures`` and ``serve.graph_replays``: one a capture of
  the graph (recaptures included), one a replayed batch.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import (Callable, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch import aot
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.ops import (
    kernels_disabled,
    route_switches,
)
from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt
from vqa_attention_networks_tpu_torch.utils import trace
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)

Fetch = Callable[[List[int]], Tuple[np.ndarray, np.ndarray]]


@dataclass
class Prediction:
    answer_id: int
    top_ids: np.ndarray  # [k]
    top_probs: np.ndarray  # [k]


class TopK(NamedTuple):
    """A dispatched shard's top-k: device tensors still to be copied to the
    host, or (``done`` set) pinned host tensors that hold it once the event
    ``done`` has fired."""
    ids: torch.Tensor  # [b, k]
    probs: torch.Tensor  # [b, k]
    done: Optional[torch.cuda.Event] = None


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a tensor. Where its memory belongs to a torch tensor (an
    array from ``Tensor.numpy()``, or a view of one, such as a shard's
    slice), the tensor lies on that owner's storage at the array's offset
    and shape: PyTorch's caching host allocator records a non-blocking
    copy's event only for a copy made through the owning storage, and
    without that event a page-locked block freed while its copy is in
    flight could be handed to the next gather and overwritten."""
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a)
    owner = a.base
    while isinstance(owner, np.ndarray):
        owner = owner.base
    if not isinstance(owner, torch.Tensor):
        return t
    storage = owner.untyped_storage()
    offset, rest = divmod(a.ctypes.data - storage.data_ptr(), a.itemsize)
    if rest or offset < 0 or (offset * a.itemsize + a.nbytes
                              > storage.nbytes()):
        return t
    return torch.empty(0, dtype=t.dtype).set_(storage, offset, t.shape,
                                              t.stride())


def _host_tensors(arrays) -> List[torch.Tensor]:
    """Host arrays as tensors for a copy to the device (``_host_tensor``),
    their bytes counted under ``serve.h2d_bytes``."""
    host = [_host_tensor(a) for a in arrays]
    if trace.recording():
        trace.count("serve.h2d_bytes", sum(t.nbytes for t in host))
    return host


class DeviceFeatureCache:
    """Device-resident int8 feature bank for repeat-image serving.

    VQA traffic asks ~3 questions of each image (the reference loads the
    features of shared images once per question, data_loader.py:27-32),
    and the per-request feed ships every grid over the host link again.
    The bank keeps the int8 rows [C, L, D] and f16 scales [C, D] of the
    hot images on the device; a request names its image by id and the
    serving forward gathers its slot (``aot.serving_forward_banked``).

    - Cost: ``capacity x (L*D int8 + D f16)`` bytes, 396 KB an image at
      196 x 2048: every VQA-val image (~40k, 15.7 GB) fits on an 80 GB card
      beside the ~1 GB model.
    - Eviction is LRU by last-use tick, and never takes an id of the batch
      being assembled; a batch with more distinct ids than the capacity is
      refused.
    - Misses upload in ONE host-to-device copy of their rows and one of
      their scales, then ``index_copy_`` into the bank. (JAX splits them
      into power-of-two chunks only because ``jit`` compiles one program
      per shape; an eager copy takes any count.) On the card the rows go
      through a pinned staging buffer with a ``non_blocking`` copy; before
      the buffer is written again the host waits on the event recorded
      after that copy, so a copy still in flight never reads rows of the
      next batch.
    - The uploads run on the current stream, the stream of the forward
      and of ``BankGraph``'s replay. ``predict_stream_by_id`` keeps a
      batch in flight, and a slot that batch still gathers from may be
      evicted and rewritten for the next one: stream order puts the
      rewrite after the in-flight gather. An upload moved to a side
      stream would have to wait on an event recorded after the in-flight
      batch's gather.
    - ``devices`` (N > 1, the split engine's replica devices; the port of
      JAX's ``mesh``): the slots split over the devices, capacity rounded
      up to a multiple of N, device i holding slots ``[i*C/N, (i+1)*C/N)``
      (``blocks``, ``scale_blocks``), so the capacity scales with the
      replicas. The LRU bookkeeping is the same, over global slots; a miss
      is written into its owner's block alone; the lookup is the ring of
      ``aot.serving_forward_banked_sharded``.
    """

    def __init__(self, cfg: Config, capacity: int,
                 num_regions: Optional[int] = None,
                 channels: Optional[int] = None,
                 device: Union[str, torch.device, None] = None,
                 devices: Optional[Sequence] = None):
        # the grid follows the store it is fed from, not the config: models
        # pool over whatever L the grid has
        l = num_regions if num_regions is not None else cfg.img_feature_dim
        d = channels if channels is not None else cfg.img_feature_channel
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError(f"capacity {capacity}: at least 1")
        if devices is not None:
            self.devices = [torch.device(x) for x in devices]
        else:
            self.devices = [torch.device(device) if device is not None
                            else cuda_device()]
        self.device = self.devices[0]
        ways = len(self.devices)
        # pad the capacity so every device holds an equal block
        self.capacity = -(-self.capacity // ways) * ways
        per = self.capacity // ways
        self.blocks = [torch.zeros((per, l, d), dtype=torch.int8, device=x)
                       for x in self.devices]
        self.scale_blocks = [torch.zeros((per, d), dtype=torch.float16,
                                         device=x) for x in self.devices]
        self._staging: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._staged: Optional[torch.cuda.Event] = None
        self._slot: dict = {}  # image_id -> slot
        self._order: dict = {}  # image_id -> monotone last-use tick (LRU)
        self._tick = 0
        self._free = list(range(self.capacity - 1, -1, -1))
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.uploads = 0  # host-to-device uploads, one per batch of misses

    def reset_stats(self) -> None:
        """Zero the hit/miss/eviction/upload counters (the contents stay):
        after a warm-up, so that the rates are the steady state's."""
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.uploads = 0

    @property
    def sharded(self) -> bool:
        return len(self.blocks) > 1

    @property
    def rows(self) -> torch.Tensor:
        """The bank's int8 rows (one device's; ``blocks`` when sharded)."""
        self._one_device()
        return self.blocks[0]

    @property
    def scale(self) -> torch.Tensor:
        self._one_device()
        return self.scale_blocks[0]

    def _one_device(self) -> None:
        if self.sharded:
            raise ValueError("a sharded cache holds blocks (blocks, "
                             "scale_blocks), one a device")

    def _touch(self, image_id) -> None:
        self._tick += 1
        self._order[image_id] = self._tick

    def _take_slot(self, batch_ids: set) -> int:
        if self._free:
            return self._free.pop()
        victim = min(
            (i for i in self._order if i not in batch_ids),
            key=self._order.__getitem__,
        )
        self.evictions += 1
        slot = self._slot.pop(victim)
        del self._order[victim]
        return slot

    def _upload(self, rows: np.ndarray, scale: np.ndarray,
                slots: np.ndarray) -> None:
        """Write ``rows`` [k, L, D] int8 and ``scale`` [k, D] f16 into the
        bank's ``slots``: one copy of each to the device, on the current
        stream; sharded, one copy of each owner's rows to its device,
        written into its block alone."""
        if self.sharded:
            per = self.blocks[0].shape[0]
            owner = slots // per
            for b in np.unique(owner):
                sel = owner == b
                dev = self.devices[b]
                idx = torch.from_numpy((slots[sel] % per).astype(
                    np.int64)).to(dev)
                self.blocks[b].index_copy_(
                    0, idx, torch.from_numpy(rows[sel]).to(dev))
                self.scale_blocks[b].index_copy_(
                    0, idx, torch.from_numpy(scale[sel]).to(dev))
            return
        idx = torch.from_numpy(slots.astype(np.int64)).to(self.device)
        if self.device.type != "cuda":
            self.rows.index_copy_(0, idx, torch.from_numpy(rows))
            self.scale.index_copy_(0, idx, torch.from_numpy(scale))
            return
        k = len(slots)
        if self._staging is None or self._staging[0].shape[0] < k:
            if self._staged is not None:
                self._staged.synchronize()
            self._staging = (
                torch.empty((k, *rows.shape[1:]), dtype=torch.int8,
                            pin_memory=True),
                torch.empty((k, scale.shape[1]), dtype=torch.float16,
                            pin_memory=True))
        elif self._staged is not None:
            # the last non_blocking copy may still read the buffer
            self._staged.synchronize()
        host_rows, host_scale = (b[:k] for b in self._staging)
        host_rows.numpy()[...] = rows
        host_scale.numpy()[...] = scale
        self.rows.index_copy_(0, idx,
                              host_rows.to(self.device, non_blocking=True))
        self.scale.index_copy_(0, idx,
                               host_scale.to(self.device, non_blocking=True))
        self._staged = torch.cuda.Event()
        self._staged.record()

    def ensure(self, image_ids: Sequence[int], fetch: Fetch) -> np.ndarray:
        """Slot indices [n] int32 for ``image_ids``, uploading the misses.

        ``fetch(missing_ids) -> (rows [k, L, D] int8, scale [k, D])``, the
        signature of the int8 store's ``gather_quantized``
        (``data/feature_store.py``). The distinct ids of a batch must fit
        the capacity (the cache never evicts the batch it assembles)."""
        with trace.span("bank.ensure"):
            ids = [int(i) for i in image_ids]
            batch_ids = set(ids)
            if len(batch_ids) > self.capacity:
                raise ValueError(
                    f"batch has {len(batch_ids)} distinct images but the "
                    f"device cache holds {self.capacity}"
                )
            missing = sorted({i for i in ids if i not in self._slot})
            if missing:
                rows, scale = fetch(missing)
                rows = np.ascontiguousarray(rows)
                scale = np.ascontiguousarray(scale, dtype=np.float16)
                if rows.dtype != np.int8:
                    raise TypeError(f"fetch gave {rows.dtype} rows: the bank "
                                    "holds the int8 layout")
                slots = np.empty(len(missing), dtype=np.int32)
                for j, image_id in enumerate(missing):
                    slots[j] = self._take_slot(batch_ids)
                    self._slot[image_id] = int(slots[j])
                    self._touch(image_id)
                self._upload(rows, scale, slots)
                self.uploads += 1
            # hits: requests that needed no upload (a repeat of an id missed in
            # this batch still saves its transfer, so it counts)
            self.misses += len(missing)
            self.hits += len(ids) - len(missing)
            idx = np.empty(len(ids), dtype=np.int32)
            for pos, image_id in enumerate(ids):
                self._touch(image_id)
                idx[pos] = self._slot[image_id]
            return idx


class BankGraph:
    """The one-device banked forward (``aot.serving_forward_banked``) of an
    engine, captured in a CUDA graph and replayed once a batch.

    - The graph reads static device buffers (``inputs``: the slot indices
      [B] int64, the questions [B, T] int32 and their lengths [B] int32)
      and the bank's ``rows`` and ``scale``, which ``DeviceFeatureCache``
      allocates once; its top-k ids and probabilities are static too.
    - ``load`` copies a batch into ``inputs`` from pinned memory without
      a wait, after the batch's miss uploads, on the current stream;
      ``replay`` runs the graph there and copies the top-k into pinned host
      tensors of that batch, then records an event after those copies.
      Stream order keeps the next batch's copies from overwriting this
      batch's inputs or outputs before it has used them, and PyTorch's
      caching host allocator reuses a pinned block only once its copy ran.
    - Captured on first use, and again where the graph would go stale: the
      question length T changed, a switch of the kernels' routes was
      flipped (``ops.route_switches``), or a parameter that a family forms
      derived weights from was written (``_derived_state``: K1's layout of
      ``MHBCoAtt``, BAN's weight-normalised weights): they are formed
      again, at new addresses. The other families' graphs read their
      parameters in place. Warm-up runs on a side stream first, as
      ``torch.cuda.graphs`` requires, and lays K1's weights out there.
    - ``captures`` and ``replays`` count what it did, as the cache counts
      its hits.
    """

    WARMUP = 2  # forwards on a side stream before a capture

    def __init__(self, fwd: Callable, model: torch.nn.Module,
                 cache: DeviceFeatureCache, batch_size: int):
        self._fwd = fwd
        self._model = model
        self._cache = cache
        self.device = cache.device
        self.batch_size = batch_size
        self.inputs: Tuple[torch.Tensor, ...] = ()
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Tuple[torch.Tensor, ...] = ()
        self._key: Optional[tuple] = None
        self.captures = self.replays = 0

    def _state(self, seq_len: int) -> tuple:
        derived = getattr(self._model, "_derived_state", None)
        return (seq_len, route_switches(),
                derived() if derived is not None else None)

    def stale(self, seq_len: int) -> bool:
        return self._graph is None or self._state(seq_len) != self._key

    def _forward(self):
        idx, ques, qlen = self.inputs
        with torch.inference_mode():
            return self._fwd(self._model, self._cache.rows,
                             self._cache.scale, idx, ques, qlen)

    def capture(self, seq_len: int) -> None:
        """(Re)capture the forward at question length ``seq_len``."""
        dev = self.device
        with torch.cuda.device(dev):
            # no replay of the old graph in flight when its pool goes
            torch.cuda.synchronize(dev)
            self._graph, self._out = None, ()
            b = self.batch_size
            # valid until the first batch's copies: slot 0, pad tokens
            self.inputs = (
                torch.zeros(b, dtype=torch.int64, device=dev),
                torch.zeros((b, seq_len), dtype=torch.int32, device=dev),
                torch.ones(b, dtype=torch.int32, device=dev))
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(self.WARMUP):
                    self._forward()
            torch.cuda.current_stream(dev).wait_stream(side)
            self._key = self._state(seq_len)
            graph = torch.cuda.CUDAGraph()
            # thread_local: the HTTP server's other threads may launch
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._out = self._forward()
        self._graph = graph
        self.captures += 1

    def load(self, host: Sequence[torch.Tensor]) -> None:
        """Copy a batch's padded host tensors (slot indices, questions,
        lengths) into ``inputs`` through pinned memory, without a wait."""
        for dst, t in zip(self.inputs, host):
            dst.copy_(t.pin_memory(), non_blocking=True)

    def replay(self) -> TopK:
        """Run the graph on what ``inputs`` hold -> its top-k in pinned
        host memory, behind the event after their copies."""
        self._graph.replay()
        host = []
        for t in self._out:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        self.replays += 1
        return TopK(host[0], host[1], done)


def trained_params(cfg: Config, directory: str):
    """The weights ``cli.train`` exported under ``directory``
    (``<model_dir>/<model_name>``, ``utils/checkpoint.load_weights``) as
    the JAX-layout tree ``InferenceEngine`` takes. The engine loads it with
    ``weights.load_jax_params``, which lays K1's weights out again
    (``MHBCoAtt.prepare``): a layout left from other weights would serve
    answers of the wrong model."""
    model = get_model(cfg.model_name)(cfg)
    model.load_state_dict(ckpt.load_weights(directory))
    return to_jax_params(model)


def replica_devices(device, n: int) -> List[torch.device]:
    """The devices of ``n`` replicas: a list names them (its first ``n``);
    one device with an index, or the CPU, holds all ``n``; a bare
    ``cuda`` (the default) is ``cuda:0..n-1``. Raises, in JAX's words,
    where fewer than ``n`` are visible."""
    if isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
        if len(devices) < n:
            raise ValueError(f"data_parallel={n} but only {len(devices)} "
                             "device(s) visible")
        return devices[:n]
    dev = torch.device(device) if device is not None else cuda_device()
    if dev.type != "cuda" or dev.index is not None or n == 1:
        return [dev] * n
    cuda_device()  # raises without a card
    count = torch.cuda.device_count()
    if count < n:
        raise ValueError(f"data_parallel={n} but only {count} device(s) "
                         "visible")
    return [torch.device("cuda", i) for i in range(n)]


class InferenceEngine:
    def __init__(
        self,
        cfg: Config,
        params,
        batch_size: int = 256,
        topk: int = 5,
        artifact_dir: Optional[str] = None,
        input_dtype: str = "float16",
        data_parallel: int = 1,
        device: Union[str, torch.device, Sequence, None] = None,
    ):
        """``params`` is a parameter tree in the JAX layout (numpy arrays),
        the same argument the JAX engine takes. ``device`` defaults to the
        card; the CPU runs only when asked for by name. ``artifact_dir``
        serves the exported program there with these weights.
        ``data_parallel=N`` serves one logical batch split over N replicas
        (``replica_devices(device, N)``)."""
        self.data_parallel = int(data_parallel)
        if self.data_parallel < 1:
            raise ValueError(f"data_parallel={data_parallel}: at least 1")
        if self.data_parallel > 1:
            if artifact_dir is not None:
                raise ValueError(
                    "data_parallel serving splits the eager forward over "
                    "replicas; an exported artifact is a fixed "
                    "single-device program — export per-shard artifacts or "
                    "drop one of the two options")
            if batch_size % self.data_parallel:
                raise ValueError(
                    f"batch_size {batch_size} not divisible by "
                    f"data_parallel {self.data_parallel}")
        if input_dtype not in ("float16", "int8"):
            raise ValueError(f"input_dtype {input_dtype!r}: float16 or int8")
        self.cfg = cfg.replace(compute_dtype="bfloat16")
        self.devices = replica_devices(device, self.data_parallel)
        self.device = self.devices[0]
        self.batch_size = batch_size
        self.input_dtype = input_dtype
        self.topk = min(topk, cfg.a_vocab_size)
        # one replica a device, each with its own K1 layout (made by
        # load_jax_params); self.model is the first
        self.models = [
            load_jax_params(get_model(self.cfg.model_name)(self.cfg).to(d),
                            params).eval()
            for d in self.devices]
        self.model = self.models[0]
        self._cache: Optional[DeviceFeatureCache] = None
        self._graph: Optional[BankGraph] = None
        # batches dispatched and collected, in order: the ids of their
        # spans (utils/trace.py)
        self._dispatched = self._collected = 0
        self._artifact = artifact_dir
        if artifact_dir is None:
            self._fwd = aot.serving_forward(self.cfg, self.topk, input_dtype)
            return
        program, meta = aot.load_serving_artifact(artifact_dir)
        self._check_artifact(meta, batch_size, artifact_dir)
        # the weights of this engine, K1's layout included (made by
        # load_jax_params above, once)
        state = aot.model_state(self.model)
        self._fwd = lambda _model, *inputs: program(state, *inputs)

    def _check_artifact(self, meta: dict, batch_size: int,
                        artifact_dir: str) -> None:
        cfg = self.cfg
        for key, got in (
            ("model_name", cfg.model_name),
            ("batch_size", batch_size),
            ("topk", self.topk),
            ("q_vocab_size", cfg.q_vocab_size),
            ("a_vocab_size", cfg.a_vocab_size),
            ("max_question_length", cfg.max_question_length),
            ("img_feature_dim", cfg.img_feature_dim),
            ("img_feature_channel", cfg.img_feature_channel),
            ("compute_dtype", cfg.compute_dtype),
            ("input_dtype", self.input_dtype),
            ("device", self.device.type),
        ):
            if meta[key] != got:
                raise ValueError(
                    f"serving artifact {key}={meta[key]!r} does not match "
                    f"engine {key}={got!r} ({artifact_dir})")
        # the engine's eager forward, always bf16 (an artifact of another
        # compute dtype is refused above, for that), would call K1
        # (mhb_coAtt unless composed) or K4 (hieCoAtten); a graph without
        # it serves the composed chain: refuse it rather than serve it
        # slower
        kernel_path = (cfg.model_name in aot.FAST_PATH_MODELS
                       and not kernels_disabled()
                       and not (cfg.model_name == "mhb_coAtt"
                                and cfg.fast_path == "composed"))
        if kernel_path and not meta["fast_path_traced"]:
            raise ValueError(
                f"serving artifact {artifact_dir} was exported without "
                f"{cfg.model_name}'s kernel (fast_path_traced=false, e.g. "
                "under VQA_DISABLE_PALLAS): export it again, or serve with "
                "fast_path='composed' / VQA_DISABLE_PALLAS set")

    def attach_feature_cache(self, capacity: int, fetch: Fetch,
                             num_regions: Optional[int] = None,
                             channels: Optional[int] = None,
                             ) -> DeviceFeatureCache:
        """Enable the device feature bank (``DeviceFeatureCache``, on the
        engine's device) and the ``predict_*_by_id`` entry points.
        ``fetch(missing_ids) -> (int8 rows, scales)``, typically the int8
        store's ``gather_quantized``. Needs the int8 engine: the bank holds
        the quantized layout. Under ``data_parallel=N`` the bank is split
        over the N replicas' devices (capacity rounded up to a multiple of
        N) and read through ``aot.serving_forward_banked_sharded``; on
        one card the banked forward is captured in a ``BankGraph`` at the
        first batch."""
        if self.input_dtype != "int8":
            raise ValueError(
                "the device feature cache stores the quantized layout — "
                "construct InferenceEngine(input_dtype='int8')"
            )
        if self._artifact is not None:
            raise ValueError(
                "the device feature cache needs the eager engine; the "
                "exported artifact is a fixed per-request-feed program")
        self._cache = DeviceFeatureCache(
            self.cfg, capacity, num_regions=num_regions, channels=channels,
            devices=self.devices,
        )
        self._fetch = fetch
        # held across ensure() and the dispatch: another thread's eviction
        # must not retarget a slot between this batch's ensure() and the
        # enqueue of its gather (stream order then makes the gather read
        # the slots ensure() resolved)
        self._bank_lock = threading.Lock()
        self._fwd_bank = (
            aot.serving_forward_banked_sharded(self.cfg, self.topk)
            if self.data_parallel > 1
            else aot.serving_forward_banked(self.cfg, self.topk))
        self._graph = (BankGraph(self._fwd_bank, self.model, self._cache,
                                 self.batch_size)
                       if self.device.type == "cuda"
                       and self.data_parallel == 1 else None)
        return self._cache

    def _pad(self, arr: np.ndarray, fill=0) -> Tuple[np.ndarray, int]:
        n = arr.shape[0]
        if n == self.batch_size:
            return arr, n
        if n > self.batch_size:
            raise ValueError(
                f"request of {n} larger than engine batch size "
                f"{self.batch_size}"
            )
        pad = np.full(
            (self.batch_size - n, *arr.shape[1:]), fill, dtype=arr.dtype
        )
        return np.concatenate([arr, pad]), n

    @staticmethod
    def _to_f16(feats: np.ndarray) -> np.ndarray:
        """Overflow-safe f16 cast: |x| > 65504 would become inf and ride the
        forward into NaN logits."""
        if feats.dtype == np.float16:
            return feats
        lim = np.float32(np.finfo(np.float16).max)
        return np.clip(feats, -lim, lim).astype(np.float16)

    def _feature_args(self, image_features, feature_scale):
        if self.input_dtype == "int8":
            if feature_scale is None:
                raise ValueError(
                    "int8 engine needs feature_scale (store.gather_quantized)"
                )
            if image_features.dtype != np.int8:
                raise TypeError(
                    f"int8 engine takes int8 features, got "
                    f"{image_features.dtype}"
                )
            img, n = self._pad(image_features)
            scale, _ = self._pad(feature_scale.astype(np.float16))
            return (img, scale), n
        if feature_scale is not None:
            raise ValueError(
                "feature_scale given to a float16 engine — construct "
                "InferenceEngine(input_dtype='int8') for the quantized feed"
            )
        img, n = self._pad(self._to_f16(image_features))
        return (img,), n

    def _question_args(self, questions, ques_length) -> list:
        """Padded questions and lengths (counted from the non-pad tokens
        when not given, clamped at 1), as host arrays."""
        if ques_length is None:
            ques_length = (questions != 0).sum(axis=1).astype(np.int32)
        ques, _ = self._pad(np.asarray(questions).astype(np.int32))
        qlen, _ = self._pad(
            np.maximum(np.asarray(ques_length).astype(np.int32), 1), fill=1
        )
        return [ques, qlen]

    def _to_device(self, arrays, device=None) -> list:
        """The host arrays on ``device``. To a card, a page-locked array
        (a float gather's, ``feature_store.host_empty``) is copied without
        a wait, its bytes counted under ``serve.h2d_pinned_bytes``; the
        others (user arrays, padded batches, casts, the questions) keep
        the blocking copy, made first, so that it does not wait for the
        non-blocking ones."""
        device = torch.device(self.device if device is None else device)
        with trace.span("serve.h2d"):
            host = _host_tensors(arrays)
            if device.type != "cuda":
                return [t.to(device) for t in host]
            pinned = [t.is_pinned() for t in host]
            out = [None] * len(host)
            for i in sorted(range(len(host)), key=pinned.__getitem__):
                out[i] = host[i].to(device, non_blocking=pinned[i])
            if trace.recording():
                trace.count("serve.h2d_pinned_bytes", sum(
                    t.nbytes for t, p in zip(host, pinned) if p))
            return out

    def _dispatch(self, image_features, questions, ques_length,
                  feature_scale):
        """Pad, upload and launch one batch; returns (device results of
        each replica's shard, n): every shard is launched before any is
        fetched."""
        self._dispatched += 1
        with trace.span("serve.dispatch", self._dispatched):
            feats, n = self._feature_args(image_features, feature_scale)
            arrays = [*feats, *self._question_args(questions, ques_length)]
            shard = self.batch_size // self.data_parallel
            handles = []
            for i, (model, device) in enumerate(zip(self.models,
                                                    self.devices)):
                args = self._to_device(
                    [a[i * shard:(i + 1) * shard] for a in arrays], device)
                with torch.inference_mode(), trace.span("serve.launch"):
                    handles.append(TopK(*self._fwd(model, *args)))
            return handles, n

    def _dispatch_by_id(self, image_ids, questions, ques_length):
        """Resolve the slots (uploading misses) and launch one batch from
        the bank; returns (device results of each replica's shard, n)."""
        if self._cache is None:
            raise RuntimeError(
                "call attach_feature_cache() before predict_*_by_id")
        self._dispatched += 1
        with trace.span("serve.dispatch", self._dispatched):
            arrays = self._question_args(questions, ques_length)
            if self._graph is not None:
                return self._replay_by_id(image_ids, arrays)
            shard = self.batch_size // self.data_parallel
            args = [self._to_device([a[i * shard:(i + 1) * shard]
                                     for a in arrays], device)
                    for i, device in enumerate(self.devices)]
            with self._bank_lock:
                idx = self._cache.ensure(image_ids, self._fetch)
                # padding gathers slot 0: harmless, dropped by n
                idx, n = self._pad(idx.astype(np.int64))
                idx = [self._to_device([idx[i * shard:(i + 1) * shard]],
                                       device)[0]
                       for i, device in enumerate(self.devices)]
                with torch.inference_mode(), trace.span("serve.launch"):
                    if self.data_parallel > 1:
                        handles = [TopK(*h) for h in self._fwd_bank(
                            self.models, self._cache.blocks,
                            self._cache.scale_blocks, idx,
                            [a[0] for a in args], [a[1] for a in args])]
                    else:
                        handles = [TopK(*self._fwd_bank(
                            self.model, self._cache.rows, self._cache.scale,
                            idx[0], *args[0]))]
            return handles, n

    def _replay_by_id(self, image_ids, arrays):
        """``_dispatch_by_id`` through the graph: the slots, then the
        copies into its inputs, the replay and the copies out, all under
        the bank's lock (another thread's batch must not write the static
        buffers in between). -> ([its ``TopK``], n)."""
        graph = self._graph
        with self._bank_lock:
            idx = self._cache.ensure(image_ids, self._fetch)
            idx, n = self._pad(idx.astype(np.int64))
            seq_len = arrays[0].shape[1]
            if graph.stale(seq_len):
                graph.capture(seq_len)
                trace.count("serve.graph_captures", 1)
            with trace.span("serve.h2d"):
                graph.load(_host_tensors([idx, *arrays]))
            with trace.span("serve.launch"):
                handle = graph.replay()
            trace.count("serve.graph_replays", 1)
        return [handle], n

    def predict_batch_by_id(
        self,
        image_ids: Sequence[int],  # [n], n <= batch_size
        questions: np.ndarray,  # [n, T] int32
        ques_length: Optional[np.ndarray] = None,
    ) -> List[Prediction]:
        """``predict_batch`` with the features taken from the device bank
        by image id: a hit ships no feature bytes to the device."""
        return self._collect(*self._dispatch_by_id(image_ids, questions,
                                                   ques_length))

    def predict_stream_by_id(
        self,
        batches: Iterator[Tuple[Sequence[int], np.ndarray,
                                Optional[np.ndarray]]],
    ) -> Iterator[List[Prediction]]:
        """``predict_stream`` over (image_ids, questions, qlen) items
        served from the device bank: batch t+1's miss uploads, copies in,
        forward (on one card a replay) and copies out are enqueued behind
        batch t's before t is collected, so the device runs t+1 while the
        host builds t's ``Prediction``s."""
        pending = None
        for image_ids, questions, ques_length in batches:
            handles = self._dispatch_by_id(image_ids, questions, ques_length)
            if pending is not None:
                yield self._collect(*pending)
            pending = handles
        if pending is not None:
            yield self._collect(*pending)

    def predict_batch(
        self,
        image_features: np.ndarray,  # [n, L, D], n <= batch_size
        questions: np.ndarray,  # [n, T] int32
        ques_length: Optional[np.ndarray] = None,
        feature_scale: Optional[np.ndarray] = None,  # [n, D] f16 (int8 feed)
    ) -> List[Prediction]:
        return self._collect(*self._dispatch(
            image_features, questions, ques_length, feature_scale
        ))

    def predict_stream(
        self,
        batches: Iterator[Sequence],
    ) -> Iterator[List[Prediction]]:
        """Pipelined streaming with one batch in flight. Items are
        (features, questions, qlen) or (features, questions, qlen,
        feature_scale) for the int8 feed. Whole batches of page-locked
        features (a store's float gather in a process that uses the card,
        ``feature_store.host_empty``) are copied to the card without a
        wait, so an array handed in must not be written until its batch
        has been collected."""
        pending = None
        for item in batches:
            feature_scale = item[3] if len(item) > 3 else None
            handles = self._dispatch(item[0], item[1], item[2], feature_scale)
            if pending is not None:
                yield self._collect(*pending)
            pending = handles
        if pending is not None:
            yield self._collect(*pending)

    def _collect(self, handles, n: int) -> List[Prediction]:
        """The top-k of the oldest batch dispatched and not yet collected,
        on the host. A handle of device tensors is copied here, behind
        whatever the stream holds (the next batch's forward too, once it
        is dispatched); a replayed batch's pinned tensors are read once the
        event after their copies has fired, which waits for that batch
        alone."""
        self._collected += 1
        with trace.span("serve.collect", self._collected):
            with trace.span("serve.result_wait"):
                for h in handles:
                    if h.done is not None:
                        h.done.synchronize()
                top_i = np.concatenate([h.ids.cpu().numpy()
                                        for h in handles])[:n]
                top_p = np.concatenate([h.probs.cpu().numpy()
                                        for h in handles])[:n]
            return [Prediction(int(top_i[i, 0]), top_i[i], top_p[i])
                    for i in range(n)]
