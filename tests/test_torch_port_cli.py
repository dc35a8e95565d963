"""The port's command line (vqa_attention_networks_tpu_torch/cli), driven
through its argparse entry points with ``--device cpu`` on a
``tools/gen_corpus.py`` workspace, mirroring
``tests/test_cli_integration.py`` (without ``predict``, which waits on the
feature extractor):

- prepare -> train iBOWIMG for one epoch (checkpoints, the weights export,
  the metric stream) -> evaluate (the three results files, whose
  breakdowns reconcile with the split) -> ``--resume`` of a finished run;
- ``--torch_checkpoint`` evaluation of a reference-layout ``.pth``: the
  port's results equal to the JAX CLI's on the same ``.pth`` and
  workspace (predictions equal, the ``.txt`` line equal, accuracies within
  one example's share of JAX's);
- ``mhb_coAtt --glove 1`` takes ``<data_dir>/glove_table.npy`` into the
  model;
- ``evaluate`` detects ``--mode`` by token;
- the default device is the card (an error without one); the Solver's
  switches (``--grad_accum_steps``, ``--remat``, ``--device_feature_bank``)
  train, and ``--model_parallel`` > 1 (ROADMAP Queue 1 item 10b, tensor
  parallelism) asks for its ranks in one process;
- under ``torchrun --nproc_per_node 2`` (gloo CPU ranks) ``evaluate``
  writes the one process's results files and ``train`` one checkpoint
  directory a step and one metric stream.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu.data.feature_store import (
    make_synthetic_feature_store,
)
from vqa_attention_networks_tpu_torch.cli import evaluate, prepare_data, train
from vqa_attention_networks_tpu_torch.data.prepare import (
    load_qa_data,
    qa_artifact_path,
)
from vqa_attention_networks_tpu_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_ANSWER = 6


@pytest.fixture()
def workspace(tmp_path, monkeypatch):
    """A data_dir with a prepared artifact and per-split feature stores at
    the production grid (196 x 2048); the CLIs write under the cwd."""
    data_dir = str(tmp_path / "data")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools/gen_corpus.py"),
                    data_dir, "--n_train", "40", "--n_val", "18"],
                   check=True, capture_output=True, timeout=120)
    monkeypatch.chdir(tmp_path)
    prepare_data.main(["--data_dir", data_dir, "--num_answer",
                       str(NUM_ANSWER)])
    qa = load_qa_data(qa_artifact_path(data_dir, 2, NUM_ANSWER))
    train_ids = sorted(set(qa.train.image_ids.tolist()))
    val_ids = sorted(set(qa.val.image_ids.tolist()) - set(train_ids))
    make_synthetic_feature_store(os.path.join(data_dir, "resnet152_train"),
                                 train_ids, seed=1)
    make_synthetic_feature_store(os.path.join(data_dir, "resnet152_val"),
                                 val_ids, seed=2)
    return data_dir, qa


def _common(data_dir, name="iBOWIMG"):
    return ["--model_name", name, "--data_dir", data_dir, "--num_answer",
            str(NUM_ANSWER), "--batch_size", "8", "--device", "cpu"]


def _results(name="iBOWIMG", where="."):
    with open(os.path.join(where, f"results/{name}.txt")) as f:
        txt = f.read()
    with open(os.path.join(where, f"results/{name}.json")) as f:
        record = json.load(f)
    with open(os.path.join(where, f"results/{name}_predictions.json")) as f:
        preds = json.load(f)
    return txt, record, preds


def test_train_evaluate_cli(workspace, capsys):
    data_dir, qa = workspace
    common = _common(data_dir)
    train.main(common + ["--mode", "training", "--num_epoch", "1",
                         "--checkpoint_every_steps", "2"])
    out = capsys.readouterr().out
    assert "Training done" in out
    steps = -(-len(qa.train) // 8)
    # every 2 steps, the final save, and keep_checkpoints=3
    assert ckpt.all_steps("models/iBOWIMG") == sorted(
        {*range(2, steps + 1, 2), steps})[-3:]
    assert os.path.exists("models/iBOWIMG/weights")
    with open("runs/iBOWIMG/events.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["tag"] for e in events] == [
        "iBOWIMG/loss", "iBOWIMG/acc", "iBOWIMG/qa_pairs_per_sec"]
    assert all(e["step"] == steps for e in events)

    evaluate.main(common)
    out = capsys.readouterr().out
    assert f"restored checkpoint at step {steps}" in out
    assert "Testing done" in out
    txt, record, preds = _results()
    assert txt.startswith("Evaluation accuracy: ")
    n = len(qa.val)
    assert record["num_examples"] == n
    for key in ("accuracy", "top3_accuracy", "vqa_consensus_accuracy",
                "accuracy_reference_denominator"):
        assert 0.0 <= record[key] <= 1.0
    assert [p["question_id"] for p in preds] == qa.val.question_ids.tolist()
    assert set(p["answer"] for p in preds) <= set(qa.answer_vocab)
    for breakdown in ("per_answer_type", "per_question_type"):
        buckets = record[breakdown]
        assert sum(v["num_examples"] for v in buckets.values()) == n
        np.testing.assert_allclose(
            sum(v["vqa_consensus_accuracy"] * v["num_examples"]
                for v in buckets.values()),
            record["vqa_consensus_accuracy"] * n, atol=1e-6)
    assert set(record["per_question_type"]) <= set(qa.question_type_names)

    # a finished run resumes to its end: nothing left to train
    train.main(common + ["--num_epoch", "1", "--resume"])
    assert f"restored checkpoint at step {steps}" in capsys.readouterr().out
    state = ckpt.restore_checkpoint("models/iBOWIMG")
    assert state["step"] == steps


def _reference_pth(path, qa):
    """A reference-layout iBOWIMG state_dict at Config's widths."""
    e = 512
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    sd = {
        "img_emb.weight": rnd(e, 2048), "img_emb.bias": rnd(e),
        "img_bn.weight": rnd(e), "img_bn.bias": rnd(e),
        "img_bn.running_mean": rnd(e),
        "img_bn.running_var": rnd(e).abs() + 0.5,
        "img_bn.num_batches_tracked": torch.tensor(7),
        "que_emb.weight": rnd(qa.q_vocab_size, e),
        "fc.weight": rnd(qa.a_vocab_size, 2 * e),
        "fc.bias": rnd(qa.a_vocab_size),
    }
    torch.save(sd, path)


def test_torch_checkpoint_evaluation_matches_jax(workspace, tmp_path,
                                                 monkeypatch):
    data_dir, qa = workspace
    pth = str(tmp_path / "iBOWIMG.pth")
    _reference_pth(pth, qa)
    args = ["--model_name", "iBOWIMG", "--data_dir", data_dir,
            "--num_answer", str(NUM_ANSWER), "--batch_size", "8",
            "--torch_checkpoint", pth]
    evaluate.main(args + ["--device", "cpu"])
    port = _results()

    from vqa_attention_networks_tpu.cli import evaluate as jax_evaluate

    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jax_evaluate.main(args)
    want = _results()
    assert port[0] == want[0]
    assert port[2] == want[2] and len(port[2]) == len(qa.val)
    n = port[1]["num_examples"]
    assert n == want[1]["num_examples"] == len(qa.val)
    for key in ("accuracy", "top3_accuracy", "vqa_consensus_accuracy"):
        assert abs(port[1][key] - want[1][key]) <= 1.0 / n

    with pytest.raises(SystemExit, match="evaluation-only"):
        train.main(_common(data_dir) + ["--torch_checkpoint", pth])


def test_glove_table_reaches_the_model(workspace, capsys):
    data_dir, qa = workspace
    table = np.random.default_rng(4).standard_normal(
        (qa.q_vocab_size, 300)).astype(np.float32)
    np.save(os.path.join(data_dir, "glove_table.npy"), table)
    args = train.parse_args(_common(data_dir, "mhb_coAtt")
                            + ["--glove", "1", "--mode", "testing"])
    solver = train.build_solver(args)
    np.testing.assert_array_equal(solver.model.glove_table.numpy(), table)
    solver.close()
    os.remove(os.path.join(data_dir, "glove_table.npy"))
    solver = train.build_solver(args)
    assert "glove_table.npy not found" in capsys.readouterr().out
    assert not solver.model.glove_table.any()
    solver.close()


def test_evaluate_mode_detection_is_token_wise(monkeypatch):
    captured = {}
    monkeypatch.setattr(evaluate, "_train_main",
                        lambda a: captured.update(argv=a))

    evaluate.main(["--model_name", "hieCoAtten"])
    assert captured["argv"][-2:] == ["--mode", "testing"]

    evaluate.main(["--model_name", "mhb", "--mode", "training"])
    assert captured["argv"].count("--mode") == 1
    assert "testing" not in captured["argv"]

    evaluate.main(["--mode=testing"])
    assert captured["argv"] == ["--mode=testing"]


@pytest.mark.parametrize("flags", [
    ["--grad_accum_steps", "2"],
    ["--remat", "1"],
    ["--device_feature_bank", "1"],
])
def test_cli_solver_switches_train(workspace, flags, capsys):
    """The flags that reached a refusal until the Solver ran them: one
    epoch trains and exports."""
    data_dir, _ = workspace
    train.main(["--model_name", "iBOWIMG", "--data_dir", data_dir,
                "--num_answer", str(NUM_ANSWER), "--batch_size", "8",
                "--device", "cpu", "--num_epoch", "1"] + flags)
    assert "Training done" in capsys.readouterr().out
    assert os.path.exists("models/iBOWIMG/weights")


@pytest.mark.parametrize("flags,error", [
    ([], RuntimeError),  # the default device: the card
    # tensor parallelism (ROADMAP item 10b, refused until it was ported)
    # needs its ranks: one process names the launcher
    (["--model_parallel", "2"], ValueError),
])
def test_cli_refusals(workspace, flags, error):
    data_dir, _ = workspace
    common = ["--model_name", "iBOWIMG", "--data_dir", data_dir,
              "--num_answer", str(NUM_ANSWER), "--batch_size", "8"]
    if error is RuntimeError:
        if torch.cuda.is_available():
            pytest.skip("a card is visible: the default device exists")
        match = "CUDA"
    else:
        common += ["--device", "cpu"]
        match = "torchrun --nproc_per_node 2"
    with pytest.raises(error, match=match):
        train.main(common + flags)


def _torchrun(module, argv, cwd, ranks=2):
    """``torchrun --standalone --nproc_per_node <ranks> -m <module> argv``
    (gloo ranks on the CPU under ``--device cpu``), failing past 180 s."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    try:
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(ranks), "-m", module, *argv], cwd=cwd,
            env=env, capture_output=True, text=True, timeout=180)
    except subprocess.TimeoutExpired:
        pytest.fail(f"torchrun {module} outlived 180 s")
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return run.stdout


def test_cli_under_torchrun(workspace, tmp_path, capsys):
    """``cli.train`` and ``cli.evaluate`` join torchrun's process group: the
    evaluation of one set of weights on 2 ranks writes the one process's
    results files, and the training writes one checkpoint directory a step
    and one metric stream, as one process does."""
    data_dir, _ = workspace
    train.main(_common(data_dir) + ["--num_epoch", "1",
                                    "--checkpoint_every_steps", "2"])
    evaluate.main(_common(data_dir))
    capsys.readouterr()
    one = _results()
    os.rename("results", "results_one")
    _torchrun("vqa_attention_networks_tpu_torch.cli.evaluate",
              _common(data_dir), str(tmp_path))
    txt, record, preds = _results()
    for rec in (record, one[1]):
        rec.pop("time")
    assert (txt, record, preds) == one
    ranks = tmp_path / "ranks"
    ranks.mkdir()
    out = _torchrun("vqa_attention_networks_tpu_torch.cli.train",
                    _common(data_dir) + ["--num_epoch", "1",
                                         "--checkpoint_every_steps", "2"],
                    str(ranks))
    assert out.count("Training done") == 2  # each rank ends the run
    assert sorted(os.listdir(ranks / "models" / "iBOWIMG")) == sorted(
        os.listdir(tmp_path / "models" / "iBOWIMG"))
    with open(ranks / "runs" / "iBOWIMG" / "events.jsonl") as f:
        written = f.read().splitlines()
    with open(tmp_path / "runs" / "iBOWIMG" / "events.jsonl") as f:
        assert len(written) == len(f.read().splitlines())


def test_cli_trains_on_a_model_axis_with_the_sharded_bank(workspace,
                                                        tmp_path):
    """``cli.train --model_parallel 2 --device_feature_bank 1
    --device_feature_bank_shard 1`` under 4 ranks reaches the Solver on a
    (2, 2) mesh with the bank split over the 2 data ranks. iBOWIMG has no
    fusion projection, so its model axis holds replicas: the weights it
    exports equal, bit for bit, those of 2 data-parallel ranks from the
    host feed."""
    data_dir, _ = workspace
    common = _common(data_dir) + ["--num_epoch", "1",
                                  "--checkpoint_every_steps", "0"]
    runs = {}
    for name, ranks, flags in (
            ("mesh", 4, ["--model_parallel", "2", "--device_feature_bank",
                         "1", "--device_feature_bank_shard", "1"]),
            ("data", 2, [])):
        where = tmp_path / f"run_{name}"
        where.mkdir()
        out = _torchrun("vqa_attention_networks_tpu_torch.cli.train",
                        common + flags, str(where), ranks)
        assert out.count("Training done") == ranks
        runs[name] = ckpt.load_weights(str(where / "models" / "iBOWIMG"))
    assert runs["mesh"].keys() == runs["data"].keys()
    for key, value in runs["data"].items():
        assert torch.equal(runs["mesh"][key], value), key
