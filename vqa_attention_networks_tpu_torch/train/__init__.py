"""Training (port of ``vqa_attention_networks_tpu/train``): the losses and
a single-device ``Solver``."""
