"""The serving forward and its exported artifact (port of
``vqa_attention_networks_tpu/aot.py``).

- ``serving_forward``: model -> softmax -> top-k over one fixed batch, for
  the f16 and the int8 feed, ``serving_forward_banked``, the device
  feature cache's, and ``serving_forward_banked_sharded``, the cache's
  split over the replicas of the data-parallel engine.
- ``export_serving`` / ``save_serving_artifact`` / ``load_serving_artifact``
  (JAX ``aot.py:184-287``): ``torch.export.export`` of ``serving_forward``
  at one fixed batch, written as ``serving.pt2`` beside ``serving.json``,
  JAX's metadata sidecar, which the engine checks at load
  (``serve.InferenceEngine(artifact_dir=...)``).

**Weights stay out of the artifact, as in JAX.** The exported program
takes the model's state, every parameter and buffer by name
(``model_state``), as its first input (``torch.func.functional_call``);
the weights come from the weights file ``cli.train`` exported, at load.
That state includes K1's laid-out ``stage1_*`` buffers: the eager model
checks its parameters for changes before each K1 call and lays them out
again (``MHBCoAtt.stage1_weights``), which a traced graph cannot do
without copying the 42 MB layout on every call, so the program takes
the buffers as inputs and the engine lays them out once, after it loads
the weights.

**The kernels.** K1, K4, K5, K7, MCAN's residual + LayerNorm and
attention and BAN's attention map are
``torch.library`` custom ops
(``torch.ops.vqa.*``, ``ops/``), each with a CPU implementation (its plain
version), a CUDA one (the hand-written kernel) and a fake one (its output
shapes). The exported graph calls the ops; which implementation runs is
decided when the program runs, by the device of its inputs. The switches
that choose whether an op is called at all (``VQA_DISABLE_PALLAS``,
``VQA_FORCE_PALLAS``, ``VQA_PALLAS_GLIMPSE``, ``Config.fast_path``) are
read when the graph is traced, as JAX reads them at trace time.
``fast_path_traced`` in the metadata says whether the graph calls K1, K4
MCAN's norm or attention, or BAN's map (``FAST_PATH_OPS``).

JAX's ``platforms`` argument and its ``tpu_lowering`` context are not
ported: they let a build box without a TPU trace the TPU's graph. Here
the graph is the same on every device, but for the device its tensors
were created on, which the metadata records as ``device`` and the engine
checks.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.models.layers import DTYPES
from vqa_attention_networks_tpu_torch.train.feature_bank import dequantize

_PROGRAM = "serving.pt2"
_META = "serving.json"

# families whose bf16 serving forward calls a kernel: mhb_coAtt K1
# (models/mhb_coatt.py), hieCoAtten K4 (models/hiecoatten.py), mcan its
# residual + LayerNorm and its attention (models/mcan.py), ban its
# attention map N3 (models/ban.py); the others
# serve the composed graph by design, so fast_path_traced=False is
# expected for them
FAST_PATH_MODELS = frozenset({"mhb_coAtt", "hieCoAtten", "mcan", "ban"})
# the ops whose presence in the graph sets fast_path_traced
FAST_PATH_OPS = ("vqa.stage1_coattention", "vqa.coattention_core",
                 "vqa.mcan_add_layernorm", "vqa.mcan_attention",
                 "vqa.ban_attention")


def serving_forward(cfg: Config, topk: int,
                    input_dtype: str = "float16") -> Callable[
                        ..., Tuple[torch.Tensor, torch.Tensor]]:
    """THE serving forward of every family. Returns ``fwd(model, img,
    ques, qlen)`` for the f16 feed, ``fwd(model, img_q, scale, ques,
    qlen)`` for the int8 feed; each gives (top ids [N, k] int64, top
    probabilities [N, k] f32). ``model`` is any callable of ``(img, ques,
    qlen)``; ``qlen`` reaches it as ``ques_length`` (MHB reads it). The
    top-k is clamped to the answer vocab, as in the JAX function."""
    topk = min(topk, cfg.a_vocab_size)

    def _head(logits: torch.Tensor):
        probs = torch.softmax(logits, dim=-1)
        # bf16 logits tie often; a stable sort breaks ties by the lower
        # answer id, as lax.top_k does (torch.topk leaves the order open)
        top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
        return top_i[:, :topk], top_p[:, :topk]

    if input_dtype == "int8":
        # quantized feed: dequantise on the device, one multiply
        def fwd_int8(model, img_q, scale, ques, qlen):
            img = dequantize(img_q, scale, DTYPES[cfg.compute_dtype])
            return _head(model(img, ques, qlen))

        return fwd_int8
    if input_dtype != "float16":
        raise ValueError(f"input_dtype {input_dtype!r}: float16 or int8")

    def fwd(model, img, ques, qlen):
        return _head(model(img, ques, qlen))

    return fwd


def serving_forward_banked(cfg: Config, topk: int) -> Callable[
        ..., Tuple[torch.Tensor, torch.Tensor]]:
    """The device feature cache's serving forward: ``fwd(model, bank_rows,
    bank_scale, idx, ques, qlen)`` gathers the int8 rows [C, L, D] and the
    f16 scales [C, D] of the slots ``idx`` [N] on the device, then runs the
    int8 ``serving_forward`` unchanged, so the banked path cannot drift
    from the per-request feed: the same bytes give the same answers. JAX
    gathers in-graph outside any Pallas kernel (``aot.py:101-119``); here
    it is ``index_select``. The sharded bank's forward is
    ``serving_forward_banked_sharded``."""
    base = serving_forward(cfg, topk, "int8")

    def fwd(model, bank_rows, bank_scale, idx, ques, qlen):
        return base(model, bank_rows.index_select(0, idx),
                    bank_scale.index_select(0, idx), ques, qlen)

    return fwd


def ring_gather(row_blocks: Sequence[torch.Tensor],
                scale_blocks: Sequence[torch.Tensor],
                idx: Sequence[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """JAX's ring gather of ``serving_forward_banked_sharded`` over the N
    devices of a split bank: block i (on its device) holds slots ``[i*C/N,
    (i+1)*C/N)``, and shard i's slot indices ``idx[i]`` start on device i.
    Each shard's (indices, int8-row accumulator, scale accumulator) moves
    from device to device around the ring; at each stop the local block
    fills the slots it owns by ``torch.where`` (no float math: bit-exact,
    and int8 rows travel at half the f16 bytes). N moves bring each triple
    home. -> (rows [B/N, L, D] int8, scales [B/N, D] f16) of each shard,
    on its device."""
    n = len(row_blocks)
    per = row_blocks[0].shape[0]
    devices = [b.device for b in row_blocks]
    state = [(i, torch.zeros((i.shape[0], *r.shape[1:]), dtype=r.dtype,
                             device=i.device),
              torch.zeros((i.shape[0], *s.shape[1:]), dtype=s.dtype,
                          device=i.device))
             for i, r, s in zip(idx, row_blocks, scale_blocks)]
    for step in range(n):
        for k, (slots, rows, scale) in enumerate(state):
            d = (k + step) % n  # the device shard k's triple is on
            local = slots - d * per
            owned = (local >= 0) & (local < per)
            safe = local.clamp(0, per - 1)
            rows = torch.where(owned[:, None, None],
                               row_blocks[d].index_select(0, safe), rows)
            scale = torch.where(owned[:, None],
                                scale_blocks[d].index_select(0, safe), scale)
            nxt = devices[(d + 1) % n]
            state[k] = (slots.to(nxt), rows.to(nxt), scale.to(nxt))
    return [s[1] for s in state], [s[2] for s in state]


def serving_forward_banked_sharded(cfg: Config, topk: int) -> Callable[
        ..., List[Tuple[torch.Tensor, torch.Tensor]]]:
    """The banked serving forward of a bank split over the split engine's
    N replicas (JAX ``aot.py:122-185``): ``fwd(models, row_blocks,
    scale_blocks, idx, ques, qlen)``, each a list of N (replica i's model,
    block, slots, questions and lengths on device i), gathers each shard's
    rows and scales around the devices (``ring_gather``), then runs the
    same int8 ``serving_forward`` on each replica: one source of truth
    with the per-request feed and the one-device bank. -> each shard's
    (top ids, top probabilities)."""
    base = serving_forward(cfg, topk, "int8")

    def fwd(models, row_blocks, scale_blocks, idx, ques, qlen):
        rows, scale = ring_gather(row_blocks, scale_blocks, idx)
        return [base(*args) for args in zip(models, rows, scale, ques, qlen)]

    return fwd


def model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The exported program's first input: every parameter and buffer of
    ``model`` by name, K1's laid-out ``stage1_*`` buffers included."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


class _Program(torch.nn.Module):
    """``serving_forward`` over ``(state, *inputs)``. The model is held
    outside the module tree, so the exported program owns no tensor of it:
    ``functional_call`` (strict) swaps every parameter and buffer for the
    state's."""

    def __init__(self, model: torch.nn.Module, fwd: Callable):
        super().__init__()
        self.__dict__["_model"] = model  # not a submodule: no weights
        self._fwd = fwd

    def forward(self, state: Dict[str, torch.Tensor], *inputs):
        model = self.__dict__["_model"]

        def call(*args):
            return torch.func.functional_call(model, state, args,
                                              strict=True)

        return self._fwd(call, *inputs)


def export_serving(cfg: Config, params, batch_size: int, topk: int = 5,
                   input_dtype: str = "float16",
                   device: Union[str, torch.device, None] = None,
                   ) -> torch.export.ExportedProgram:
    """``torch.export`` of the fixed-batch serving forward of ``cfg``'s
    family with ``params`` (a JAX-layout tree; only its shapes and K1's
    layout reach the graph), on ``device`` (default: the card)."""
    from vqa_attention_networks_tpu_torch.models import get_model
    from vqa_attention_networks_tpu_torch.weights import load_jax_params

    device = torch.device(device) if device is not None else cuda_device()
    model = load_jax_params(get_model(cfg.model_name)(cfg).to(device),
                            params).eval()
    shape = (batch_size, cfg.img_feature_dim, cfg.img_feature_channel)
    if input_dtype == "int8":
        feats = (torch.zeros(shape, dtype=torch.int8, device=device),
                 torch.ones(batch_size, cfg.img_feature_channel,
                            dtype=torch.float16, device=device))
    else:
        feats = (torch.zeros(shape, dtype=torch.float16, device=device),)
    ques = torch.ones(batch_size, cfg.max_question_length, dtype=torch.int32,
                      device=device)
    qlen = torch.ones(batch_size, dtype=torch.int32, device=device)
    program = _Program(model, serving_forward(cfg, topk, input_dtype))
    with torch.no_grad():
        exported = torch.export.export(
            program, (model_state(model), *feats, ques, qlen), strict=False)
    if exported.state_dict or exported.constants:
        raise RuntimeError(
            "the exported serving program holds tensors of its own "
            f"({sorted(exported.state_dict)[:3]}, "
            f"{sorted(exported.constants)[:3]}): weights must come from "
            "the state input")
    return exported


def graph_ops(exported: torch.export.ExportedProgram) -> set:
    """The ops the exported graph calls, by name (``vqa.stage1_coattention.
    default``, ``aten.mm.default``, ...)."""
    return {str(node.target) for node in exported.graph.nodes
            if node.op == "call_function"}


def save_serving_artifact(out_dir: str, cfg: Config, params,
                          batch_size: int, topk: int = 5,
                          input_dtype: str = "float16",
                          device: Union[str, torch.device, None] = None,
                          ) -> str:
    """Export and write ``serving.pt2`` and its metadata sidecar
    ``serving.json`` (JAX's keys, less ``platforms``, plus ``device``)."""
    device = torch.device(device) if device is not None else cuda_device()
    exported = export_serving(cfg, params, batch_size, topk, input_dtype,
                              device)
    ops = graph_ops(exported)
    os.makedirs(out_dir, exist_ok=True)
    # the example inputs hold the state: saved, they would put the
    # weights into the artifact
    exported.example_inputs = None
    torch.export.save(exported, os.path.join(out_dir, _PROGRAM))
    meta = {
        "model_name": cfg.model_name,
        "batch_size": batch_size,
        # the clamped value, as the engine compares its own clamped top-k
        "topk": min(topk, cfg.a_vocab_size),
        "input_dtype": input_dtype,
        "q_vocab_size": cfg.q_vocab_size,
        "a_vocab_size": cfg.a_vocab_size,
        "max_question_length": cfg.max_question_length,
        "img_feature_dim": cfg.img_feature_dim,
        "img_feature_channel": cfg.img_feature_channel,
        "compute_dtype": cfg.compute_dtype,
        # the device the graph's own tensors are made on
        "device": device.type,
        # whether the graph calls K1, K4 or MCAN's norm: the fast path
        # was traced
        "fast_path_traced": any(op.startswith(FAST_PATH_OPS) for op in ops),
        "kernel_ops": sorted(op for op in ops if op.startswith("vqa.")),
        "config": dataclasses.asdict(cfg),
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


def load_serving_artifact(artifact_dir: str) -> Tuple[Callable,
                                                      Dict[str, Any]]:
    """-> (``program(state, *inputs)`` -> (top ids, top probabilities),
    the metadata). The graph comes from the artifact, not from tracing the
    model code again; ``state`` is ``model_state`` of a model holding the
    weights to serve."""
    # the ops the graph calls must be registered before it loads
    from vqa_attention_networks_tpu_torch.ops import (  # noqa: F401
        attention,
        ban_attention,
        coattention,
        grid_fusion,
        mcan_attention,
        mcan_norm,
        wq_fusion,
    )

    with open(os.path.join(artifact_dir, _META)) as f:
        meta = json.load(f)
    exported = torch.export.load(os.path.join(artifact_dir, _PROGRAM))
    return exported.module(), meta
