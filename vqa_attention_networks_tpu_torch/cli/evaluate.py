"""Evaluation CLI (the port's copy of
``vqa_attention_networks_tpu/cli/evaluate.py``): ``cli.train`` with
``--mode testing`` added, the counterpart of ``train_models.py --mode
testing`` (train_models.py:68-71). It writes ``results/<model>.txt`` (the
reference's line), ``results/<model>.json`` (exact, top-3 and VQA-consensus
accuracy with the per-type breakdowns) and
``results/<model>_predictions.json`` (the leaderboard rows). Under
``torchrun --nproc_per_node N`` each rank scores its slice of every batch
and the primary writes the files (``cli.train``)."""

from vqa_attention_networks_tpu_torch.cli.train import main as _train_main


def main(argv=None) -> None:
    if argv is None:
        import sys

        argv = sys.argv[1:]
    argv = list(argv)
    # token by token: a substring check would match --model_name and run a
    # full training over the weights under evaluation
    has_mode = any(a == "--mode" or a.startswith("--mode=") for a in argv)
    if not has_mode:
        argv = argv + ["--mode", "testing"]
    _train_main(argv)


if __name__ == "__main__":
    main()
