"""Single-image prediction CLI (the port's copy of
``vqa_attention_networks_tpu/cli/predict.py``, the counterpart of
predict_pytorch.py:15-94).

Flow: image -> CNN feature grid (``models/extractor.py``, the one
implementation shared with the server's /predict_image) -> the question
tokenised LEFT-aligned (the training encode; the reference's predict
script right-aligns, predict_pytorch.py:61-66, a skew of its own broken
predict path) -> the model's forward -> the argmax answer and the top-k
(predict_pytorch.py:85-91).

The weights are ``cli.train``'s export under ``--model_dir`` (the port's
own format), or a reference ``.pth`` through ``--torch_checkpoint``
(``utils/torch_import.py``). The CNN is the ResNet-152 trunk by default
(the [196, 2048] grids the models were trained on); ``--backbone vgg19``
is the reference's VGG19 tap (predict_pytorch.py:34-37).

The JAX CLI's flags, and two more: ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch versions, as the tests do; nothing falls back to
the CPU by itself) and ``--compute_dtype`` (the model's activations:
float32, as the JAX CLI computes, or bfloat16, the serving dtype, in which
mhb_coAtt's forward launches K1 and hieCoAtten's K4).
"""

import argparse
import json

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data.text import encode_question
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.serve import trained_params
from vqa_attention_networks_tpu_torch.weights import (
    load_jax_params,
    to_jax_params,
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_path", type=str, default="data/cat.jpg")
    parser.add_argument("--model_name", type=str, default="mhb_coAtt")
    parser.add_argument("--model_dir", type=str, default="./models")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--vocab", type=str, default=None,
                        help="path to the .vocab.json artifact")
    parser.add_argument("--question", type=str,
                        default="Which animal is this?")
    parser.add_argument("--backbone", type=str, default="resnet152",
                        help="resnet152|vgg19")
    parser.add_argument("--weights", type=str, default=None,
                        help=".npz of torchvision backbone state_dict")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--dump_attention", type=str, default=None,
                        help="write the attention maps the family exposes "
                             "at eval time (hieCoAtten av/aq region/word "
                             "maps, mfb glimpse logits) to this .npz; "
                             "mhb_coAtt's fused eval path does not "
                             "materialise its glimpse logits")
    parser.add_argument("--image_first", type=int, default=0,
                        help="MUST match the flag the checkpoint was "
                             "trained with (visLstm token order)")
    parser.add_argument("--glove", type=int, default=0,
                        help="set 1 for checkpoints trained with --glove 1 "
                             "(mhb_coAtt: doubled LSTM input + glove table)")
    parser.add_argument("--glove_table", type=str, default=None,
                        help="data/glove_table.npy — required with "
                             "--glove 1 --torch_checkpoint (the .pth has "
                             "no GloVe vectors)")
    parser.add_argument("--torch_checkpoint", type=str, default=None,
                        help="a reference models/<name>.pth state_dict to "
                             "predict with, imported in place of the "
                             "weights under --model_dir")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        help="float32 (as the JAX CLI) | bfloat16 (the "
                             "serving dtype: mhb_coAtt runs K1, hieCoAtten "
                             "K4)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default: the card; an error without "
                             "one) | cpu (the plain PyTorch versions of "
                             "the kernels, for tests)")
    return parser.parse_args(argv)


def _params(args, cfg: Config):
    """The JAX-layout tree to predict with: a reference ``.pth`` imported
    onto the family's layout, or ``cli.train``'s export."""
    if args.torch_checkpoint:
        from vqa_attention_networks_tpu_torch.utils.torch_import import (
            import_state_dict,
            load_pth,
        )

        template = to_jax_params(get_model(cfg.model_name)(cfg))
        if cfg.glove and cfg.model_name == "mhb_coAtt":
            # a reference .pth has NO glove entries (the reference looks
            # vectors up through spaCy, data_loader.py:18-23): without a
            # real table the import would zero half the LSTM input
            if not args.glove_table:
                raise SystemExit(
                    "--glove 1 with --torch_checkpoint needs --glove_table "
                    "(build data/glove_table.npy with cli.build_glove): the "
                    ".pth carries no GloVe vectors"
                )
            template["glove_table"] = np.load(args.glove_table)
        return import_state_dict(cfg.model_name,
                                 load_pth(args.torch_checkpoint), template)
    try:
        return trained_params(cfg, f"{args.model_dir}/{cfg.model_name}")
    except RuntimeError as e:  # load_state_dict's size mismatch
        if "size mismatch" not in str(e):
            raise
        raise SystemExit(
            f"checkpoint under {args.model_dir}/{cfg.model_name} was "
            f"trained with different shapes than this invocation implies "
            f"(q_vocab={cfg.q_vocab_size}, a_vocab={cfg.a_vocab_size}, "
            f"img_channels={cfg.img_feature_channel} from --backbone "
            f"{args.backbone}) — pass the vocab artifact the model was "
            f"trained with, and the backbone whose features it consumed "
            f"(resnet152-trained checkpoints cannot read vgg19's "
            f"512-channel grids)"
        ) from None


def main(argv=None) -> None:
    args = parse_args(argv)
    device = (cuda_device() if args.device == "cuda"
              else torch.device(args.device))
    print(f"Image: {args.image_path}")
    print(f"Question: {args.question}")

    vocab_path = args.vocab or f"{args.data_dir}/qa_v2_1000answers_all.vocab.json"
    with open(vocab_path) as f:
        vocab = json.load(f)
    q_vocab = vocab["question_vocab"]
    max_len = vocab["max_question_length"]
    ans_of = {i: a for a, i in vocab["answer_vocab"].items()}

    # image -> feature grid (models/extractor.py, shared with the server's
    # /predict_image, so the two cannot drift apart in preprocessing)
    from PIL import Image

    from vqa_attention_networks_tpu_torch.models.extractor import (
        GridExtractor,
    )

    try:
        extractor = GridExtractor(args.backbone, args.weights or None,
                                  warmup=False, device=device)
    except ValueError as e:
        raise SystemExit(str(e))
    if extractor.random_weights:
        print("WARNING: random backbone (no --weights)")
    feats = extractor.from_pil(Image.open(args.image_path))[None]

    ids = np.asarray(
        [encode_question(args.question, q_vocab, max_len)], np.int32
    )
    qlen = np.asarray([max(int((ids != 0).sum()), 1)], np.int32)

    cfg = Config(
        model_name=args.model_name,
        q_vocab_size=vocab["question_vocab"]["UNK"] + 1,
        a_vocab_size=len(vocab["answer_vocab"]),
        max_question_length=max_len,
        img_feature_channel=extractor.channels,
        image_first=bool(args.image_first),
        glove=bool(args.glove),
        compute_dtype=args.compute_dtype,
    ).validate()
    model = load_jax_params(get_model(cfg.model_name)(cfg).to(device),
                            _params(args, cfg)).eval()
    _predict(args, model, cfg, feats, ids, qlen, ans_of, device)


def _predict(args, model, cfg, feats, ids, qlen, ans_of, device) -> None:
    with torch.inference_mode():
        logits, aux = model(torch.from_numpy(feats).to(device),
                            torch.from_numpy(ids).to(device),
                            torch.from_numpy(qlen).to(device), aux=True)
        probs = torch.softmax(logits.float(), dim=-1)[0].cpu().numpy()
    order = np.argsort(-probs)

    print("Ans:", ans_of[int(order[0])])
    print("Top Answers")
    for i in order[: args.topk]:
        print(f"  {ans_of[int(i)]}  ({probs[i]:.4f})")

    if args.dump_attention:
        # every map the family exposes (hieCoAtten: av [196] region and aq
        # [T] word maps, hieCoAtten.py:55; mfb: the 2-glimpse attention
        # logits); None entries are captures the eval forward skips
        maps = {
            k: v[0].float().cpu().numpy()
            for k, v in aux.items()
            if k != "batch_stats" and v is not None
        }
        if maps and cfg.model_name in ("mfb", "mfb-multilayer") \
                and cfg.keep_reference_quirks:
            # under the reference quirk the glimpse pooling is UNIFORM
            # (softmax over a singleton axis, mfb.py:84,118): flag the dump
            # so viewers don't present the logits as the pooling weights
            maps["uniform_quirk"] = np.asarray(True)
        if maps:
            np.savez(args.dump_attention, **maps)
            shapes = ", ".join(f"{k} {v.shape}" for k, v in maps.items())
            print(f"Attention maps -> {args.dump_attention} ({shapes})")
        else:
            print(f"{cfg.model_name} exposes no attention maps; "
                  "nothing written")


if __name__ == "__main__":
    main()
