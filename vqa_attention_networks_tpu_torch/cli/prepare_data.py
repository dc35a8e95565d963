"""QA-preparation CLI (the port's copy of
``vqa_attention_networks_tpu/cli/prepare_data.py``, the counterpart of the
reference's ``python utils.py``, utils.py:372-380): the official VQA JSON
under ``<data_dir>/vqa/`` -> ``<data_dir>/qa_v<version>_<n>answers_<type>``
``.npz`` + ``.vocab.json``. Host-only: it needs no device."""

import argparse

from vqa_attention_networks_tpu_torch.data.prepare import (
    prepare_training_data,
)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="prepare packed QA data")
    parser.add_argument("--num_answer", type=int, default=1000,
                        help="number of answers (default=1000)")
    parser.add_argument("--version", type=int, default=2,
                        help="vqa dataset version (1|2, default=2)")
    parser.add_argument("--answer_type", type=str, default="all",
                        help="all|other|yes/no|number (default=all)")
    parser.add_argument("--data_dir", type=str, default="data")
    args = parser.parse_args(argv)

    data = prepare_training_data(
        data_dir=args.data_dir,
        version=args.version,
        num_ans=args.num_answer,
        answer_type=args.answer_type,
    )
    print(f"train questions: {len(data.train)}")
    print(f"val questions:   {len(data.val)}")
    print(f"answer_vocab:    {data.a_vocab_size}")
    print(f"question_vocab:  {data.q_vocab_size} (incl. pad + UNK)")
    print(f"max_question_length: {data.max_question_length}")


if __name__ == "__main__":
    main()
