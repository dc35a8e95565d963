"""Reference ``.pth`` checkpoint importer/exporter for every model family
(the port's copy of ``vqa_attention_networks_tpu/utils/torch_import.py``).

The reference's training artifact is ``models/<name>.pth``, a flat torch
``state_dict`` written by ``clean_state_dict`` (reference solver.py:184-190,
utils.py:12-19: the DataParallel ``module.`` prefix is stripped). This
module maps that layout onto the JAX-layout parameter tree (and back),
which ``weights.load_jax_params`` loads into a port module:

    tree = import_state_dict("mhb_coAtt", load_pth("mhb_coAtt.pth"),
                             to_jax_params(model))
    load_jax_params(model, tree)

Layout conversions (torch -> tree):
- ``nn.Linear``      ``weight [out,in]``        -> ``w [in,out]`` (transpose), ``bias -> b``
- 1x1 ``nn.Conv2d``  ``weight [out,in,1,1]``    -> ``w [in,out]`` (squeeze+transpose)
- ``nn.Embedding``   ``weight [V,E]``           -> ``table`` (as-is)
- ``nn.LSTM``        ``weight_ih_l0 [4H,in]``   -> ``w_ih [in,4H]`` (transpose; gate
                     order i,f,g,o on both sides), biases kept as the
                     separate ``b_ih``/``b_hh`` pair
- ``nn.LSTMCell``    same, without the ``_l0`` suffix (visLstm.py:19-20)
- ``nn.BatchNorm1d`` ``weight/bias/running_mean/running_var`` ->
                     ``scale/bias/mean/var``; ``num_batches_tracked`` dropped
                     (momentum is the constant 0.1, networks.py:11,44)

``mhb_coAtt --glove`` checkpoints have no table in the state_dict (the
reference ships GloVe rows as a per-batch input, data_loader.py:47-56): the
template's ``glove_table`` leaf is carried through unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# (torch attribute name, framework key path, layer kind) per model family.
# Attribute names follow each reference nn.Module's __init__ exactly:
#   MHBCoAtt  mhb_coAtt.py:22-59      MHB          mhb_coAtt.py:155-172
#   MFB       mfb.py:22-59            HieCoAtten   hieCoAtten.py:7-16
#   VisLSTM   visLstm.py:8-21         LSTM_Attention visLstm.py:63-75
#   iBOWIMG   networks.py:8-13        AttentionNet networks.py:31-45
Entry = Tuple[str, Tuple[str, ...], str]


def _mfb_entries(multilayer: bool) -> List[Entry]:
    e: List[Entry] = [
        ("word_embedding", ("word_embedding",), "embedding"),
        ("lstm", ("lstm",), "lstm"),
        ("ques_att_conv1", ("ques_att_conv1",), "conv1x1"),
        ("ques_att_conv2", ("ques_att_conv2",), "conv1x1"),
        ("ques_proj1", ("ques_proj1",), "linear"),
        ("img_conv1d", ("img_conv1d",), "conv1x1"),
        ("co_att_conv1", ("co_att_conv1",), "conv1x1"),
        ("co_att_conv2", ("co_att_conv2",), "conv1x1"),
        ("ques_proj2", ("ques_proj2",), "linear"),
        ("img_proj2", ("img_proj2",), "linear"),
        ("linear_pred", ("linear_pred",), "linear"),
    ]
    if multilayer:  # mfb.py:35-37,48-50
        e += [
            ("ques_att_multiconv", ("ques_att_multiconv",), "conv1x1"),
            ("co_att_multiconv", ("co_att_multiconv",), "conv1x1"),
        ]
    return e


def _spec(model_name: str, template: Dict[str, Any]) -> List[Entry]:
    if model_name == "mhb_coAtt":
        return [
            ("word_embedding", ("word_embedding",), "embedding"),
            ("lstm", ("lstm",), "lstm"),
            ("ques_att_conv1", ("ques_att_conv1",), "conv1x1"),
            ("ques_att_conv2", ("ques_att_conv2",), "conv1x1"),
            ("ques_proj1", ("ques_proj1",), "linear"),
            ("img_conv1d", ("img_conv1d",), "conv1x1"),
            ("co_att_conv1", ("co_att_conv1",), "conv1x1"),
            ("co_att_conv2", ("co_att_conv2",), "conv1x1"),
            ("ques_proj2", ("ques_proj2",), "linear"),
            ("ques_proj3", ("ques_proj3",), "linear"),
            ("img_proj2", ("img_proj2",), "linear"),
            ("img_proj3", ("img_proj3",), "linear"),
            ("linear_pred", ("linear_pred",), "linear"),
        ]
    if model_name == "mhb":  # capitalised attributes: mhb_coAtt.py:160-161
        return [
            ("Embedding", ("embedding",), "embedding"),
            ("LSTM", ("lstm",), "lstm"),
            ("linear_q_1", ("linear_q_1",), "linear"),
            ("linear_q_2", ("linear_q_2",), "linear"),
            ("linear_i_1", ("linear_i_1",), "linear"),
            ("linear_i_2", ("linear_i_2",), "linear"),
            ("linear_out", ("linear_out",), "linear"),
        ]
    if model_name in ("mfb", "mfb-multilayer"):
        return _mfb_entries("ques_att_multiconv" in template)
    if model_name == "hieCoAtten":
        return [
            ("img_emb", ("img_emb",), "linear"),
            ("que_emb", ("que_emb",), "embedding"),
            ("fc_Wbv", ("fc_Wbv",), "linear"),
            ("fc_Wbq", ("fc_Wbq",), "linear"),
            ("fc_Wv", ("fc_Wv",), "linear"),
            ("fc_Wq", ("fc_Wq",), "linear"),
            ("fc_Whv", ("fc_Whv",), "linear"),
            ("fc_Whq", ("fc_Whq",), "linear"),
            ("fc", ("fc",), "linear"),
        ]
    if model_name == "visLstm":
        return [
            ("embedding_ques", ("embedding_ques",), "embedding"),
            ("embedding_img", ("embedding_img",), "linear"),
            ("lstm1", ("lstm1",), "lstm_cell"),
            ("lstm2", ("lstm2",), "lstm_cell"),
            ("output_layer", ("output_layer",), "linear"),
        ]
    if model_name == "lstm_attention":  # visLstm.py:72-75
        return [
            ("embedding", ("embedding",), "embedding"),
            ("lstm1", ("lstm1",), "lstm_cell"),
            ("lstm2", ("lstm2",), "lstm_cell"),
            ("output_layer", ("output_layer",), "linear"),
        ]
    if model_name == "iBOWIMG":
        return [
            ("img_emb", ("img_emb",), "linear"),
            ("img_bn", ("img_bn",), "batchnorm"),
            ("que_emb", ("que_emb",), "embedding"),
            ("fc", ("fc",), "linear"),
        ]
    if model_name == "attentionNet":
        e: List[Entry] = [
            ("img_emb", ("img_emb",), "linear"),
            ("que_emb", ("que_emb",), "embedding"),
            ("fc", ("fc",), "linear"),
            ("batchnorm", ("batchnorm",), "batchnorm"),
        ]
        i = 0
        # Attention_layer holds its Attention_1 as ``att_layer`` whose only
        # parameters are the D->1 score linear (networks.py:42 +
        # modules.py:16,38)
        while f"att{i}" in template:
            e.append((f"att{i}.att_layer.fc", (f"att{i}", "att", "fc"),
                      "linear"))
            i += 1
        return e
    raise ValueError(f"no torch import spec for model {model_name!r}")


# ---------------------------------------------------------------------------
# per-kind torch-name -> framework-leaf maps
# ---------------------------------------------------------------------------

# kind -> {torch suffix: (framework leaf, transform)}
def _kind_fields(kind: str) -> Dict[str, Tuple[str, str]]:
    if kind == "linear":
        return {"weight": ("w", "T"), "bias": ("b", "")}
    if kind == "conv1x1":
        return {"weight": ("w", "squeezeT"), "bias": ("b", "")}
    if kind == "embedding":
        return {"weight": ("table", "")}
    if kind == "lstm":
        return {
            "weight_ih_l0": ("w_ih", "T"),
            "weight_hh_l0": ("w_hh", "T"),
            "bias_ih_l0": ("b_ih", ""),
            "bias_hh_l0": ("b_hh", ""),
        }
    if kind == "lstm_cell":
        return {
            "weight_ih": ("w_ih", "T"),
            "weight_hh": ("w_hh", "T"),
            "bias_ih": ("b_ih", ""),
            "bias_hh": ("b_hh", ""),
        }
    if kind == "batchnorm":
        return {
            "weight": ("scale", ""),
            "bias": ("bias", ""),
            "running_mean": ("mean", ""),
            "running_var": ("var", ""),
        }
    raise ValueError(f"unknown layer kind {kind!r}")


def _to_framework(x: np.ndarray, transform: str) -> np.ndarray:
    if transform == "T":
        return np.ascontiguousarray(x.T)
    if transform == "squeezeT":
        if x.ndim != 4 or x.shape[2:] != (1, 1):
            raise ValueError(
                f"expected a 1x1 conv weight [out,in,1,1], got {x.shape}"
            )
        return np.ascontiguousarray(x[:, :, 0, 0].T)
    return np.asarray(x)


def _to_torch_layout(x: np.ndarray, transform: str) -> np.ndarray:
    if transform == "T":
        return np.ascontiguousarray(x.T)
    if transform == "squeezeT":
        return np.ascontiguousarray(x.T)[:, :, None, None]
    return np.asarray(x)


def clean_state_dict(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Strip the DataParallel ``module.`` prefix (reference utils.py:12-19)."""
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def load_pth(path: str) -> Dict[str, np.ndarray]:
    """Load a reference ``.pth`` into a flat {name: float32 ndarray} dict."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(raw, dict):
        raise ValueError(
            f"{path} is not a state_dict (got {type(raw).__name__}); the "
            "reference saves clean_state_dict(model.state_dict()) "
            "(solver.py:190)"
        )
    return {
        k: np.asarray(v.detach().cpu().numpy())
        for k, v in clean_state_dict(raw).items()
    }


def import_state_dict(
    model_name: str,
    state_dict: Dict[str, Any],
    template: Dict[str, Any],
) -> Dict[str, Any]:
    """Map a reference state_dict onto a framework param tree.

    ``template`` is a JAX-layout tree of the family
    (``weights.to_jax_params`` of the module, or
    ``train.solver.init_params``) — it defines the expected shapes; every
    imported leaf is validated against it, and leaves with no torch counterpart
    (``glove_table``) are carried through from the template. Unconsumed
    state_dict entries (beyond BN bookkeeping) and missing entries are
    errors, not silent drift.
    """
    sd = {k: np.asarray(v, np.float32) if not hasattr(v, "detach")
          else np.asarray(v.detach().cpu().numpy(), np.float32)
          for k, v in clean_state_dict(state_dict).items()}
    out: Dict[str, Any] = {}
    consumed = set()

    def _set(path: Tuple[str, ...], leaf: str, value: np.ndarray) -> None:
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value

    def _template_leaf(path: Tuple[str, ...], leaf: str):
        node: Any = template
        for key in path + (leaf,):
            if not isinstance(node, dict) or key not in node:
                return None
            node = node[key]
        return node

    missing: List[str] = []
    for torch_name, fw_path, kind in _spec(model_name, template):
        for suffix, (leaf, transform) in _kind_fields(kind).items():
            tname = f"{torch_name}.{suffix}"
            tleaf = _template_leaf(fw_path, leaf)
            if tname not in sd:
                # a biasless Linear (Attention_2's fc1, modules.py:82) simply
                # lacks the entry; only required leaves are an error
                if tleaf is None and suffix == "bias":
                    continue
                missing.append(tname)
                continue
            consumed.add(tname)
            if tleaf is None:
                raise ValueError(
                    f"{model_name}: state_dict has {tname} but the param "
                    f"tree has no {'/'.join(fw_path)}/{leaf} — checkpoint/"
                    f"config mismatch (e.g. --glove or mfb-multilayer flags)"
                )
            value = _to_framework(sd[tname], transform).astype(np.float32)
            expect = tuple(tleaf.shape)
            if value.shape != expect:
                raise ValueError(
                    f"{model_name}: {tname} maps to "
                    f"{'/'.join(fw_path)}/{leaf} with shape {value.shape}, "
                    f"expected {expect} — vocab/dim mismatch between the "
                    f"checkpoint and this config"
                )
            _set(fw_path, leaf, value)
    if missing:
        raise ValueError(
            f"{model_name}: state_dict is missing {sorted(missing)} — wrong "
            f"model family, or not a reference checkpoint"
        )

    leftovers = {
        k for k in sd
        if k not in consumed and not k.endswith("num_batches_tracked")
    }
    if leftovers:
        raise ValueError(
            f"{model_name}: unconsumed state_dict entries {sorted(leftovers)}"
            " — checkpoint/config mismatch (e.g. a multilayer checkpoint "
            "imported as plain mfb)"
        )

    # leaves with no torch counterpart (the frozen glove table) come from the
    # template — but only whole SUBTREES absent from the spec; per-leaf gaps
    # inside mapped layers were already validated above
    for key, value in template.items():
        if key not in out:
            out[key] = np.asarray(value, np.float32) \
                if not isinstance(value, dict) else value
    return out


def export_state_dict(
    model_name: str, params: Dict[str, Any]
) -> Dict[str, np.ndarray]:
    """Inverse of :func:`import_state_dict`: a reference-layout flat dict.

    Round-trips through ``import_state_dict`` exactly; useful for writing
    checkpoints the reference's ``predict_pytorch.py:70-79`` could load.
    BatchNorm export synthesises ``num_batches_tracked=0`` (torch tracks it
    but never reads it under constant momentum).
    """
    out: Dict[str, np.ndarray] = {}
    for torch_name, fw_path, kind in _spec(model_name, params):
        node: Any = params
        for key in fw_path:
            node = node[key]
        for suffix, (leaf, transform) in _kind_fields(kind).items():
            if leaf not in node:
                continue
            out[f"{torch_name}.{suffix}"] = _to_torch_layout(
                np.asarray(node[leaf], np.float32), transform
            )
        if kind == "batchnorm":
            out[f"{torch_name}.num_batches_tracked"] = np.asarray(0, np.int64)
    return out
