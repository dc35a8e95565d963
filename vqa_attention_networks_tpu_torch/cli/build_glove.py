"""Build the offline GloVe embedding table for a prepared vocabulary (the
port's copy of ``vqa_attention_networks_tpu/cli/build_glove.py``).

The reference resolves GloVe vectors per item through spaCy
(data_loader.py:18-23,47-56); here the whole vocabulary is embedded once
and the [q_vocab_size, 300] table is stored next to the QA artifact, where
``cli.train --glove 1`` reads it. Host-only: it needs no device.

Usage:
    python -m vqa_attention_networks_tpu_torch.cli.build_glove \\
        --vocab data/qa_v2_1000answers_all.vocab.json --out data/glove_table.npy
"""

import argparse
import json

from vqa_attention_networks_tpu_torch.data.glove import (
    build_glove_table,
    build_glove_table_from_text,
    random_glove_table,
    save_glove_table,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--vocab", type=str, required=True,
                        help="path to <artifact>.vocab.json")
    parser.add_argument("--out", type=str, default="data/glove_table.npy")
    parser.add_argument("--vectors", type=str, default=None,
                        help="standard GloVe text file (e.g. "
                             "glove.840B.300d.txt) — no spaCy needed")
    parser.add_argument("--spacy_model", type=str, default="en_vectors_web_lg")
    parser.add_argument("--random", action="store_true",
                        help="random stand-in table (tests/smoke only)")
    args = parser.parse_args(argv)

    with open(args.vocab) as f:
        vocab = json.load(f)["question_vocab"]

    if args.random:
        table = random_glove_table(vocab)
        print("WARNING: random GloVe table (--random); vectors carry no "
              "semantics")
    elif args.vectors:
        stats: dict = {}
        table = build_glove_table_from_text(vocab, args.vectors, stats=stats)
        print(f"matched {stats['matched']}/{stats['vocab_words']} vocabulary "
              f"words in {args.vectors}")
    else:
        table = build_glove_table(vocab, spacy_model=args.spacy_model)

    save_glove_table(table, args.out)
    print(f"wrote [{table.shape[0]}, {table.shape[1]}] table -> {args.out}")


if __name__ == "__main__":
    main()
