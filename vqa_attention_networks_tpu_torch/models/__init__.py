"""Model registry (port of ``vqa_attention_networks_tpu/models/__init__.py``).

All eight families are ported, and MCAN (``models/mcan.py``) and BAN
(``models/ban.py``) besides, which the port has and the JAX package has not
(``config.PORT_MODEL_NAMES``); the Solver trains each of them. Every
family's ``forward(img, ques, ques_length=None, *, train, valid,
generator, fusion_seed, reference_kernels, aux)`` takes the same arguments,
the counterpart of the JAX ``apply`` signature: only MHB reads
``ques_length``, only iBOWIMG and attentionNet read ``valid``, and with
``aux=True`` each returns (logits, aux) as ``apply`` does.
"""

from vqa_attention_networks_tpu_torch.config import PORT_MODEL_NAMES

# the families the Solver trains
TRAINABLE = PORT_MODEL_NAMES


def get_model(name: str):
    """The ``nn.Module`` class of a model family; it takes the ``Config``."""
    if name == "mhb_coAtt":
        from vqa_attention_networks_tpu_torch.models.mhb_coatt import MHBCoAtt

        return MHBCoAtt
    if name == "mhb":
        from vqa_attention_networks_tpu_torch.models.mhb_coatt import MHB

        return MHB
    if name == "hieCoAtten":
        from vqa_attention_networks_tpu_torch.models.hiecoatten import (
            HieCoAtten,
        )

        return HieCoAtten
    if name in ("mfb", "mfb-multilayer"):
        from vqa_attention_networks_tpu_torch.models.mfb import MFB

        return MFB
    if name == "visLstm":
        from vqa_attention_networks_tpu_torch.models.vis_lstm import VisLstm

        return VisLstm
    if name == "iBOWIMG":
        from vqa_attention_networks_tpu_torch.models.ibowimg import IBOWIMG

        return IBOWIMG
    if name == "attentionNet":
        from vqa_attention_networks_tpu_torch.models.ibowimg import (
            AttentionNet,
        )

        return AttentionNet
    if name == "mcan":
        from vqa_attention_networks_tpu_torch.models.mcan import MCAN

        return MCAN
    if name == "ban":
        from vqa_attention_networks_tpu_torch.models.ban import BAN

        return BAN
    raise ValueError(
        f"model {name!r} not supported; have {list(PORT_MODEL_NAMES)}")

