"""Command-line entry points of the port (the JAX package's ``cli/`` with
the same flags; each runs on the card unless ``--device cpu`` is given):

    python -m vqa_attention_networks_tpu_torch.cli.prepare_data  (utils.py __main__)
    python -m vqa_attention_networks_tpu_torch.cli.build_glove
    python -m vqa_attention_networks_tpu_torch.cli.train         (train_models.py)
    python -m vqa_attention_networks_tpu_torch.cli.evaluate      (train_models.py --mode testing)
"""
