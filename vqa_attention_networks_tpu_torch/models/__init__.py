"""Model registry (port of ``vqa_attention_networks_tpu/models/__init__.py``).

Only ``mhb_coAtt`` is ported so far; every other family raises
``NotImplementedError`` naming its ROADMAP item.
"""

from vqa_attention_networks_tpu.config import MODEL_NAMES

_PENDING = {
    "mfb": "ROADMAP Queue 1 item 7 (other families)",
    "mfb-multilayer": "ROADMAP Queue 1 item 7 (other families)",
    "mhb": "ROADMAP Queue 1 item 7 (other families)",
    "hieCoAtten": "ROADMAP Queue 1 item 7 (other families, with kernel K4)",
    "visLstm": "ROADMAP Queue 1 item 7 (other families)",
    "iBOWIMG": "ROADMAP Queue 1 item 7 (other families)",
    "attentionNet": "ROADMAP Queue 1 item 7 (other families)",
}


def get_model(name: str):
    """The ``nn.Module`` class of a model family."""
    if name == "mhb_coAtt":
        from vqa_attention_networks_tpu_torch.models.mhb_coatt import MHBCoAtt

        return MHBCoAtt
    if name in _PENDING:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet: {_PENDING[name]}"
        )
    raise ValueError(f"model {name!r} not supported; have {list(MODEL_NAMES)}")
