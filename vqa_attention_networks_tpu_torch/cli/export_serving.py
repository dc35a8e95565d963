"""Export a serving artifact (the port's copy of
``vqa_attention_networks_tpu/cli/export_serving.py``): the fixed-batch
serving forward through ``torch.export`` (``aot.save_serving_artifact``),
written as ``serving.pt2`` and its metadata ``serving.json``. The serving
box then runs ``cli.serve --aot_artifact <dir>`` with the weights of its
``--model_dir``: the artifact holds no weight.

- The weights it traces with are ``models/<name>/weights``, which
  ``cli.train`` exports (only their shapes and K1's layout reach the
  graph).
- An int8 store gives the int8 feed's program, as the serving box gathers
  int8 rows from it.
- ``--device`` (default ``cuda``; ``cpu`` for a program served on the CPU,
  as the tests do): the graph makes its own tensors on that device, and
  the engine refuses an artifact of another. JAX's ``--platforms`` is not
  ported (``aot.py``).

Drive:
  python -m vqa_attention_networks_tpu_torch.cli.export_serving \\
      --data_dir data --model_name mhb_coAtt --batch_size 64 \\
      --out models/mhb_coAtt/serving_aot
"""

import argparse
import json

from vqa_attention_networks_tpu_torch.aot import save_serving_artifact
from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data.feature_store import (
    open_feature_store,
)
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.serve import trained_params


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", type=str, default="mhb_coAtt")
    parser.add_argument("--model_dir", type=str, default="./models")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--vocab", type=str, default=None)
    parser.add_argument("--feature_type", type=str, default="resnet152")
    parser.add_argument("--version", type=int, default=2)
    parser.add_argument("--num_answer", type=int, default=1000)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default: the card; an error without "
                             "one) | cpu — the device the program serves on")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)

    vocab_path = args.vocab or (
        f"{args.data_dir}/qa_v{args.version}_{args.num_answer}answers_all"
        ".vocab.json"
    )
    with open(vocab_path) as f:
        vocab = json.load(f)
    store = open_feature_store(args.data_dir, args.feature_type)
    cfg = Config(
        model_name=args.model_name,
        q_vocab_size=vocab["question_vocab"]["UNK"] + 1,
        a_vocab_size=len(vocab["answer_vocab"]),
        max_question_length=vocab["max_question_length"],
        img_feature_channel=store.channels,
        compute_dtype="bfloat16",
    ).validate()
    params = trained_params(cfg, f"{args.model_dir}/{cfg.model_name}")
    # the artifact's feature input must match the store the serving box
    # gathers from: an int8 store serves the quantized feed
    input_dtype = "int8" if getattr(store, "quantized", False) else "float16"
    device = cuda_device() if args.device == "cuda" else args.device
    out = save_serving_artifact(args.out, cfg, params, args.batch_size,
                                args.topk, input_dtype, device)
    print(f"serving artifact written to {out} (input_dtype={input_dtype})")


if __name__ == "__main__":
    main()
