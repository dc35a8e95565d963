"""Model registry (port of ``vqa_attention_networks_tpu/models/__init__.py``).

``mhb_coAtt``, ``hieCoAtten``, ``mfb`` and ``mfb-multilayer`` are ported;
every other family raises ``NotImplementedError`` naming its ROADMAP item.
"""

from vqa_attention_networks_tpu_torch.config import MODEL_NAMES

# the training forward of the family served but not yet trained
TRAINING_PENDING = "ROADMAP Queue 1 item 7 (training of hieCoAtten)"

# the families the Solver trains
TRAINABLE = ("mhb_coAtt", "mfb", "mfb-multilayer")

_PENDING = {
    name: "ROADMAP Queue 1 item 7 (other families)"
    for name in ("mhb", "visLstm", "iBOWIMG", "attentionNet")
}


def get_model(name: str):
    """The ``nn.Module`` class of a model family; it takes the ``Config``."""
    if name == "mhb_coAtt":
        from vqa_attention_networks_tpu_torch.models.mhb_coatt import MHBCoAtt

        return MHBCoAtt
    if name == "hieCoAtten":
        from vqa_attention_networks_tpu_torch.models.hiecoatten import (
            HieCoAtten,
        )

        return HieCoAtten
    if name in ("mfb", "mfb-multilayer"):
        from vqa_attention_networks_tpu_torch.models.mfb import MFB

        return MFB
    if name in _PENDING:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet: {_PENDING[name]}"
        )
    raise ValueError(f"model {name!r} not supported; have {list(MODEL_NAMES)}")
