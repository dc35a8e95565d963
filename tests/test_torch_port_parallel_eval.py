"""The port's full evaluation over 4 gloo CPU ranks (``Solver.val(full=
True)`` under a process group), against one port process, as JAX's
``tests/test_multiprocess.py:169`` (``test_four_process_eval_padded_final_
batch``) holds its multi-process evaluation against one process.

26 validation questions at batch 8: the fourth batch has 2 valid rows, all
rank 0's, so ranks 1 to 3 score padding only there. Each rank scores its
slice of every batch (bf16 ``mhb_coAtt``: K1's plain version on the CPU);
the loss, exact and top-3 sums are all-reduced and the predictions
gathered (``parallel.host_fetch``), so every rank holds the one-process
figures, and rank 0 alone writes the results files, which equal the one
process's (less the time stamp): one leaderboard row per real question.
"""

import json
import os

import numpy as np
import pytest

from test_torch_port_parallel_ranks import result, run_case, run_ranks
from test_torch_port_parallel import cfg_fields
from vqa_attention_networks_tpu_torch.data import feature_store as port_store
from vqa_attention_networks_tpu_torch.data import prepare as port_prepare

WORLD = 4
N_VAL = 26
FILES = ("mhb_coAtt.txt", "mhb_coAtt.json", "mhb_coAtt_predictions.json")


def _data(root, prepare, store_module):
    qa = prepare.make_synthetic_qa_data(np.random.default_rng(0),
                                        n_train=32, n_val=N_VAL,
                                        num_images=4, max_len=7)
    store = store_module.make_synthetic_feature_store(
        os.path.join(root, "feat"),
        sorted(set(qa.train.image_ids) | set(qa.val.image_ids)), channels=32)
    return qa, store


def _files(results_dir):
    out = {}
    for name in FILES:
        with open(os.path.join(results_dir, name)) as f:
            out[name] = f.read()
    record = json.loads(out["mhb_coAtt.json"])
    record.pop("time")
    out["mhb_coAtt.json"] = record
    return out


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_eval")
    qa, store = _data(str(root / "port"), port_prepare, port_store)
    port_prepare.save_qa_data(qa, str(root / "qa"))
    out = root / "out"
    out.mkdir()

    def case(tag):
        return dict(name="eval", val="full", cfg=cfg_fields(
            qa, compute_dtype="bfloat16", batch_size=8,
            results_dir=str(root / tag / "results")))

    run_ranks(dict(qa=str(root / "qa"), store=str(root / "port" / "feat"),
                   out=str(out), cases=[case("ranks")]), WORLD, root)
    one = run_case(case("one"), qa, store)
    return dict(root=root, out=str(out), one=one)


def test_four_ranks_write_the_one_process_results(evaluated):
    root = evaluated["root"]
    got = _files(root / "ranks" / "results")
    want = _files(root / "one" / "results")
    assert got == want
    rows = json.loads(got["mhb_coAtt_predictions.json"])
    assert len(rows) == N_VAL
    assert len({r["question_id"] for r in rows}) == N_VAL
    assert got["mhb_coAtt.json"]["num_examples"] == N_VAL
    # written once: by rank 0 alone
    for r in range(WORLD):
        with open(root / f"rank{r}.log") as f:
            wrote = f"Wrote {N_VAL} predictions" in f.read()
        assert wrote == (r == 0), r


def test_every_rank_holds_the_one_process_figures(evaluated):
    want = evaluated["one"]["val"]
    for r in range(WORLD):
        got = result(evaluated["out"], "eval", r)["val"]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        assert got[1] == want[1]
