"""Training / testing CLI (the port's copy of
``vqa_attention_networks_tpu/cli/train.py``, the counterpart of
``train_models.py:15-71``): the same flags, one frozen ``Config``, and one
flag more, ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch
versions, as the tests do — nothing falls back to the CPU by itself).

Files, relative to the working directory as in the JAX CLI: checkpoints
and the weights export under ``models/<model>/``, the metric stream under
``runs/<model>/events.jsonl``, and, in testing mode, the results files
under ``results/``.

Switches the port does not run yet (``--grad_accum_steps`` > 1,
``--remat``, ``--device_feature_bank``, an int8 store, ``--model_parallel``
> 1) reach the Solver, which refuses each with its ROADMAP item.
"""

import argparse
import sys

import torch

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data.feature_store import (
    open_feature_store,
)
from vqa_attention_networks_tpu_torch.data.glove import load_glove_table
from vqa_attention_networks_tpu_torch.data.prepare import (
    load_qa_data,
    qa_artifact_path,
)
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.train.solver import Solver
from vqa_attention_networks_tpu_torch.utils.torch_import import (
    import_state_dict,
    load_pth,
)
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)


def build_solver(args) -> Solver:
    base = qa_artifact_path(args.data_dir, args.version, args.num_answer,
                            args.answer_type)
    qa_data = load_qa_data(base)
    # <ft>_all, or the per-split stores <ft>_train + <ft>_val combined
    store = open_feature_store(args.data_dir, args.feature_type)

    cfg = Config(
        model_name=args.model_name,
        q_vocab_size=qa_data.q_vocab_size,
        a_vocab_size=qa_data.a_vocab_size,
        max_question_length=qa_data.max_question_length,
        # the store dictates the image-feature width (a VGG19 store is
        # 512-channel)
        img_feature_channel=store.channels,
        feature_type=args.feature_type,
        glove=bool(args.glove),
        image_first=bool(args.image_first),
        mode=args.mode,
        data_dir=args.data_dir,
        batch_size=args.batch_size,
        num_epoch=args.num_epoch,
        compute_dtype=args.compute_dtype,
        fast_path=args.fast_path,
        dropout_site=args.dropout_site,
        device_feature_bank=bool(args.device_feature_bank),
        device_feature_bank_budget=int(
            args.device_feature_bank_budget * (1 << 30)
        ),
        device_feature_bank_shard=bool(args.device_feature_bank_shard),
        early_stopping=bool(args.early_stopping),
        patience=args.patience,
        early_stop_metric=args.early_stop_metric,
        checkpoint_every_steps=args.checkpoint_every_steps,
        model_parallel=args.model_parallel,
        rng_impl=args.rng_impl,
        remat=bool(args.remat),
        grad_accum_steps=args.grad_accum_steps,
        prefetch_workers=args.prefetch_workers,
        seed=args.seed,
    ).validate()
    print(f"q_vocab_size {cfg.q_vocab_size}")
    print(f"a_vocab_size {cfg.a_vocab_size}")

    glove_table = None
    if cfg.glove:
        glove_table = load_glove_table(f"{args.data_dir}/glove_table.npy")
        if glove_table is None:
            print("WARNING: data/glove_table.npy not found; GloVe rows are "
                  "zero. Build it offline with cli.build_glove.")

    device = (cuda_device() if args.device == "cuda"
              else torch.device(args.device))
    return Solver(cfg, qa_data, store, device=device,
                  glove_table=glove_table, log_dir="runs")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", type=str, default="mhb",
                        help="mfb|mfb-multilayer|mhb|mhb_coAtt|hieCoAtten|"
                             "visLstm|iBOWIMG|attentionNet (default=mhb)")
    parser.add_argument("--version", type=int, default=2)
    parser.add_argument("--image_first", type=int, default=0)
    parser.add_argument("--num_answer", type=int, default=1000)
    parser.add_argument("--answer_type", type=str, default="all",
                        help="all|other|yes/no|number — must match the "
                             "artifact prepare_data wrote")
    parser.add_argument("--mode", type=str, default="training",
                        help="training | testing")
    parser.add_argument("--glove", type=int, default=0)
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--feature_type", type=str, default="resnet152")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_epoch", type=int, default=18)
    parser.add_argument("--compute_dtype", type=str, default="float32")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default: the card; an error without "
                             "one) | cpu (the plain PyTorch versions of "
                             "the kernels, for tests)")
    parser.add_argument("--device_feature_bank", type=int, default=0,
                        help="keep the whole feature store in device "
                             "memory (not ported yet: the Solver refuses "
                             "it)")
    parser.add_argument("--device_feature_bank_budget", type=float,
                        default=8.0, metavar="GIB",
                        help="byte budget for --device_feature_bank, in "
                             "GiB per device")
    parser.add_argument("--device_feature_bank_shard", type=int, default=0,
                        help="shard the bank's rows over the data axis")
    parser.add_argument("--dropout_site", type=str, default="prepool",
                        help="grid-fusion dropout site: 'prepool' keeps "
                             "the reference recipe (mask on the pre-pool "
                             "product, K2); 'pooled' is the "
                             "weight-contracted fast-train mode (K3)")
    parser.add_argument("--fast_path", type=str, default="auto",
                        help="auto|pallas|composed — bf16 mhb_coAtt eval "
                             "dispatch: the K1 kernel or the composed "
                             "chain (config.py fast_path)")
    parser.add_argument("--early_stopping", type=int, default=0)
    parser.add_argument("--patience", type=int, default=10,
                        help="early-stopping patience in epochs "
                             "(reference: solver.py:42-45)")
    parser.add_argument("--early_stop_metric", type=str, default="loss",
                        help="loss (solver.py:160-172) | acc "
                             "(legacy trainer, train_hfd.py:154-166)")
    parser.add_argument("--checkpoint_every_steps", type=int, default=2000,
                        help="mid-training checkpoint cadence; 0 disables "
                             "(final save always writes one)")
    parser.add_argument("--model_parallel", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0,
                        help="controls init, shuffle order and dropout; two "
                             "runs with the same seed are bit-identical")
    parser.add_argument("--grad_accum_steps", type=int, default=1,
                        help="split each optimizer step into N sequential "
                             "microbatches (not ported yet: the Solver "
                             "refuses N > 1)")
    parser.add_argument("--remat", type=int, default=0,
                        help="1 = recompute the forward during backward "
                             "(not ported yet: the Solver refuses it)")
    parser.add_argument("--prefetch_workers", type=int, default=4,
                        help="host batch-assembly threads (the counterpart "
                             "of the reference's 4 DataLoader workers, "
                             "cfg.py:6); 1 = single-producer prefetch")
    parser.add_argument("--rng_impl", type=str, default="threefry2x32",
                        help="accepted for the JAX CLI's flag surface "
                             "(threefry2x32 | rbg) and validated, but it "
                             "has no PyTorch counterpart: the port's "
                             "dropout draws from torch.Generator and K2's "
                             "Philox mask whatever its value")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint")
    parser.add_argument("--torch_checkpoint", type=str, default=None,
                        help="a reference models/<name>.pth state_dict "
                             "(solver.py:190) to evaluate with --mode "
                             "testing (utils/torch_import.py) instead of "
                             "restoring a checkpoint")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    solver = build_solver(args)

    if args.torch_checkpoint:
        if args.mode != "testing":
            sys.exit("--torch_checkpoint is evaluation-only: pass --mode "
                     "testing")
        tree = import_state_dict(args.model_name,
                                 load_pth(args.torch_checkpoint),
                                 to_jax_params(solver.model))
        load_jax_params(solver.model, tree)
        print(f"imported reference checkpoint {args.torch_checkpoint}")
    elif args.resume or args.mode == "testing":
        try:
            solver.restore()
            print(f"restored checkpoint at step {solver.step}")
        except FileNotFoundError:
            if args.mode == "testing":
                print("no checkpoint found for testing mode")
                sys.exit(-1)

    if args.mode == "testing" and solver.best_state is not None:
        # evaluate the early-stopping best snapshot, as the reference's
        # final .pth holds the best weights (solver.py:165,184-190)
        solver.set_weights(solver.best_state)

    try:
        if args.mode == "training":
            solver.train()
            solver.save()
            print("Training done")
        else:
            print(f"Start to evaluate model: {args.model_name}")
            solver.val(full=True)
            print("Testing done")
    finally:
        solver.close()


if __name__ == "__main__":
    main()
