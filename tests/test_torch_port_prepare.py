"""The port's data preparation (vqa_attention_networks_tpu_torch/data:
``text``, ``prepare``, ``legacy_samplers``, ``glove``, ``feature_store``,
``dataset`` and ``cli.prepare_data`` / ``cli.build_glove``) against the JAX
package's on the same inputs. Every comparison is exact: these are host
numpy and string functions with the same arithmetic on both sides.

- ``text``: every function over the strings of ``tests/test_text.py`` and a
  seeded random set of words drawn from the contraction and number tables,
  mixed case, digits and punctuation; outputs equal.
- ``prepare_training_data`` on a ``tools/gen_corpus.py`` corpus (official
  VQA-v2 schema), at answer_type ``all`` and ``yes/no``: each array of the
  two ``.npz`` equal key for key and dtype for dtype (``savez_compressed``
  stamps zip times, so the files are not compared as bytes), the
  ``.vocab.json`` byte-equal, and each package loads the other's artifact.
- The legacy samplers: outputs equal.
- ``build_glove_table_from_text`` on a GloVe text file the test writes, the
  ``build_glove`` CLI (``--vectors`` and ``--random``) and the spaCy path
  (an ImportError without spaCy, in both): tables equal.
- ``FeatureStoreWriter.append_batch`` (f16 and int8), ``quantize_store``:
  files byte-equal; ``open_feature_store`` on both layouts and
  ``CombinedFeatureStore``: row handles and gathers equal.
- ``VqaBatches`` on the prepared artifact: every field of every batch
  equal, the pad rows of the last batch included.
"""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from vqa_attention_networks_tpu.cli import build_glove as jax_build_glove
from vqa_attention_networks_tpu.data import dataset as jax_dataset
from vqa_attention_networks_tpu.data import feature_store as jax_store
from vqa_attention_networks_tpu.data import glove as jax_glove
from vqa_attention_networks_tpu.data import legacy_samplers as jax_samplers
from vqa_attention_networks_tpu.data import prepare as jax_prepare
from vqa_attention_networks_tpu.data import text as jax_text
from vqa_attention_networks_tpu_torch.cli import build_glove as port_build_glove
from vqa_attention_networks_tpu_torch.cli import prepare_data as port_cli
from vqa_attention_networks_tpu_torch.data import dataset as port_dataset
from vqa_attention_networks_tpu_torch.data import feature_store as port_store
from vqa_attention_networks_tpu_torch.data import glove as port_glove
from vqa_attention_networks_tpu_torch.data import legacy_samplers as \
    port_samplers
from vqa_attention_networks_tpu_torch.data import prepare as port_prepare
from vqa_attention_networks_tpu_torch.data import text as port_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_TRAIN, N_VAL = 90, 30  # the corpus's questions per split

# the strings of tests/test_text.py
TEXT_WORDS = ["dont", "CANT", "wont", "Two", "ten", "zero", "none", "Dog",
              "Im", "somebody'd", "Yes", "Three"]
TEXT_SENTENCES = ["What's the dog doing?", "Is this 2 cats?",
                  "What is this zebra?"]


def _random_words(seed=0, n=400):
    rng = np.random.default_rng(seed)
    pool = (list(jax_text.CONTRACTIONS) + list(jax_text.CONTRACTIONS.values())
            + list(jax_text.NUMBER_WORDS) + ["cat", "Blue", "2", "x_y", "é"])
    words = []
    for w in rng.choice(pool, size=n):
        w = str(w)
        if rng.random() < 0.3:
            w = w.upper() if rng.random() < 0.5 else w.capitalize()
        words.append(w)
    return words


def _random_sentences(seed=0, n=60):
    rng = np.random.default_rng(seed)
    words = _random_words(seed, n * 8)
    seps = [" ", "? ", ", ", "-", "'", " ... "]
    return ["".join(w + str(rng.choice(seps)) for w in words[i:i + 8])
            for i in range(0, len(words), 8)]


def test_text_tables_are_the_jax_tables():
    assert port_text.CONTRACTIONS == jax_text.CONTRACTIONS
    assert port_text.NUMBER_WORDS == jax_text.NUMBER_WORDS
    assert port_text._WORD_RE.pattern == jax_text._WORD_RE.pattern


@pytest.mark.parametrize("fn", ["normalize_words", "normalize_answer",
                                "tokenize"])
def test_text_function_matches_jax(fn):
    words = TEXT_WORDS + _random_words()
    sentences = TEXT_SENTENCES + _random_sentences()
    if fn == "normalize_words":
        cases = [words[i:i + 5] for i in range(0, len(words), 5)]
    elif fn == "normalize_answer":
        cases = words
    else:
        cases = sentences
    got = [getattr(port_text, fn)(c) for c in cases]
    want = [getattr(jax_text, fn)(c) for c in cases]
    assert got == want
    # the quirks tests/test_text.py pins hold in the port too
    if fn == "normalize_words":
        assert port_text.normalize_words(["Im", "somebody'd"]) == [
            "im", "somebodyd"]


@pytest.mark.parametrize("right_align", [False, True])
def test_encode_question_matches_jax(right_align):
    vocab = {"what": 1, "is": 2, "this": 3, "UNK": 4}
    for w in _random_words(1, 40):
        vocab.setdefault(jax_text.normalize_answer(w), len(vocab) + 1)
    for s in TEXT_SENTENCES + _random_sentences(1):
        for max_len in (3, 6, 22):
            assert port_text.encode_question(
                s, vocab, max_len, right_align) == jax_text.encode_question(
                s, vocab, max_len, right_align)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("corpus")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools/gen_corpus.py"),
                    str(out), "--n_train", str(N_TRAIN), "--n_val",
                    str(N_VAL), "--seed", "3"],
                   check=True, capture_output=True, timeout=120)
    return str(out)


def _prepared(corpus, tmp_path, answer_type, num_ans=12):
    """Each package's artifact of the same corpus, in its own directory."""
    out = {}
    for name, module in (("jax", jax_prepare), ("port", port_prepare)):
        d = str(tmp_path / name)
        data = module.prepare_training_data(corpus, 2, num_ans, answer_type,
                                            out_dir=d)
        out[name] = (data, module.qa_artifact_path(d, 2, num_ans,
                                                   answer_type))
    return out


@pytest.mark.parametrize("answer_type", ["all", "yes/no"])
def test_prepared_artifacts_match_jax(corpus, tmp_path, answer_type):
    out = _prepared(corpus, tmp_path, answer_type)
    (jdata, jbase), (pdata, pbase) = out["jax"], out["port"]
    assert port_prepare.qa_artifact_path("d", 2, 12, answer_type) == \
        jax_prepare.qa_artifact_path("d", 2, 12, answer_type)
    assert filecmp.cmp(jbase + ".vocab.json", pbase + ".vocab.json",
                       shallow=False)
    with np.load(jbase + ".npz") as j, np.load(pbase + ".npz") as p:
        assert sorted(j.files) == sorted(p.files)
        # every optional field is present: the corpus has all of them
        assert len(j.files) == 20
        for key in j.files:
            assert j[key].dtype == p[key].dtype, key
            np.testing.assert_array_equal(p[key], j[key], err_msg=key)
    assert len(pdata.train) > 0 and len(pdata.val) > 0
    if answer_type == "yes/no":
        assert set(pdata.answer_vocab) <= {"yes", "no", "UNK"}
        assert set(np.unique(pdata.train.answer_types)) == {0}
    # each package reads the other's artifact
    for module, base, other in ((port_prepare, jbase, pdata),
                                (jax_prepare, pbase, jdata)):
        loaded = module.load_qa_data(base)
        for split in ("train", "val"):
            a, b = getattr(loaded, split), getattr(other, split)
            for field in ("questions", "ques_length", "answers", "image_ids",
                          "soft_idx", "soft_val", "soft_n", "answer_types",
                          "question_ids", "question_types"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
            np.testing.assert_array_equal(a.soft_dense(12),
                                          b.soft_dense(12))
        assert loaded.answer_vocab == other.answer_vocab
        assert loaded.question_vocab == other.question_vocab
        assert loaded.question_type_names == other.question_type_names
        assert loaded.q_vocab_size == other.q_vocab_size


def test_vocab_builders_and_pairing_match_jax(corpus):
    q_path, a_path = port_prepare.json_paths(corpus, 2, "train")
    assert (q_path, a_path) == jax_prepare.json_paths(corpus, 2, "train")
    assert port_prepare.json_paths("d", 1, "val") == jax_prepare.json_paths(
        "d", 1, "val")
    with open(q_path) as f:
        qs = json.load(f)["questions"]
    with open(a_path) as f:
        anns = json.load(f)["annotations"]
    for n in (2, 5, 1000):
        vocab = port_prepare.build_answer_vocab(anns, n)
        assert vocab == jax_prepare.build_answer_vocab(anns, n)
        assert port_prepare.build_soft_answers(vocab, anns) == \
            jax_prepare.build_soft_answers(vocab, anns)
        assert port_prepare.build_question_vocab(qs, anns, vocab) == \
            jax_prepare.build_question_vocab(qs, anns, vocab)
    # a re-sorted download is refused, with the same message
    bad = [dict(anns[1])] + anns[1:]
    for module in (port_prepare, jax_prepare):
        with pytest.raises(ValueError, match="not index-aligned"):
            module.build_question_vocab(qs, bad, vocab)


def test_prepare_data_cli_matches_jax(corpus, tmp_path, capsys):
    from vqa_attention_networks_tpu.cli import prepare_data as jax_cli

    printed = {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / name
        d.mkdir()
        os.symlink(os.path.join(corpus, "vqa"), d / "vqa")
        cli.main(["--data_dir", str(d), "--num_answer", "7"])
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"]
    assert "train questions: " in printed["port"]
    assert filecmp.cmp(tmp_path / "jax/qa_v2_7answers_all.vocab.json",
                       tmp_path / "port/qa_v2_7answers_all.vocab.json",
                       shallow=False)


def _store_ids(data):
    return (sorted(set(data.train.image_ids.tolist())),
            sorted(set(data.val.image_ids.tolist())
                   - set(data.train.image_ids.tolist())))


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_append_batch_writes_the_jax_bytes(tmp_path, dtype):
    rng = np.random.default_rng(5)
    ids = [int(i) for i in rng.permutation(1000)[:11]]
    grids = (rng.standard_normal((11, 6, 8)) * 3).astype(np.float32)
    grids[2, :, 3] = 0.0  # an all-zero channel (scale 0 in int8)
    for module, name in ((jax_store, "jax"), (port_store, "port")):
        with module.FeatureStoreWriter(str(tmp_path / name), 6, 8,
                                       dtype) as w:
            w.append_batch(ids[:4], grids[:4])
            w.append(ids[4], grids[4])
            w.append_batch(ids[5:], grids[5:])
    files = ["features.bin", "index.json"] + (
        ["scales.bin"] if dtype == "int8" else [])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(files)
    for f in files:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f,
                           shallow=False), f
    store = port_store.FeatureStore(str(tmp_path / "port"))
    np.testing.assert_array_equal(
        store.gather(ids[::2]),
        jax_store.FeatureStore(str(tmp_path / "jax")).gather(ids[::2]))
    with pytest.raises(ValueError, match="ids for"):
        port_store.FeatureStoreWriter(str(tmp_path / "bad"), 6, 8,
                                      dtype).append_batch(ids[:2], grids[:3])


def test_quantize_store_writes_the_jax_bytes(tmp_path):
    ids = list(range(7, 30, 2))
    src = str(tmp_path / "src")
    jax_store.make_synthetic_feature_store(src, ids, 6, 8, seed=2)
    jax_store.quantize_store(src, str(tmp_path / "jax"), batch=5)
    q = port_store.quantize_store(src, str(tmp_path / "port"), batch=5)
    for f in ("features.bin", "scales.bin", "index.json"):
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f,
                           shallow=False), f
    assert q.quantized
    with pytest.raises(ValueError, match="already int8"):
        port_store.quantize_store(str(tmp_path / "port"),
                                  str(tmp_path / "again"))


@pytest.mark.parametrize("layout", ["all", "split"])
def test_open_feature_store_matches_jax(tmp_path, layout):
    rng = np.random.default_rng(6)
    train_ids = [int(i) for i in rng.permutation(50)[:9]]
    val_ids = [100 + i for i in range(5)]
    if layout == "all":
        jax_store.make_synthetic_feature_store(
            str(tmp_path / "resnet152_all"), train_ids + val_ids, 6, 8)
    else:
        jax_store.make_synthetic_feature_store(
            str(tmp_path / "resnet152_train"), train_ids, 6, 8, seed=1)
        jax_store.make_synthetic_feature_store(
            str(tmp_path / "resnet152_val"), val_ids, 6, 8, seed=2)
    got = port_store.open_feature_store(str(tmp_path))
    want = jax_store.open_feature_store(str(tmp_path))
    assert type(got).__name__ == type(want).__name__ == (
        "FeatureStore" if layout == "all" else "CombinedFeatureStore")
    assert len(got) == len(want) == 14
    asked = val_ids[::2] + train_ids + val_ids[1:2]
    rows = got.rows_for(asked)
    np.testing.assert_array_equal(rows, want.rows_for(asked))
    np.testing.assert_array_equal(got.all_rows(), want.all_rows())
    np.testing.assert_array_equal(got.dense_rows(rows),
                                  want.dense_rows(rows))
    for dtype in (np.float32, np.float16):
        np.testing.assert_array_equal(got.gather(asked, dtype),
                                      want.gather(asked, dtype))
    with pytest.raises(FileNotFoundError):
        port_store.open_feature_store(str(tmp_path), "vgg19")


def test_combined_store_quantized_and_refusals(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jax_store.make_synthetic_feature_store(a, [1, 2, 3], 6, 8, seed=1,
                                           dtype="int8")
    jax_store.make_synthetic_feature_store(b, [7, 8], 6, 8, seed=2,
                                           dtype="int8")
    got = port_store.CombinedFeatureStore(
        [port_store.FeatureStore(a), port_store.FeatureStore(b)])
    want = jax_store.CombinedFeatureStore(
        [jax_store.FeatureStore(a), jax_store.FeatureStore(b)])
    assert got.quantized
    for g, w in zip(got.gather_quantized([8, 1, 7, 3]),
                    want.gather_quantized([8, 1, 7, 3])):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.gather([8, 2]), want.gather([8, 2]))
    with pytest.raises(ValueError, match="more than one member"):
        port_store.CombinedFeatureStore([port_store.FeatureStore(a)] * 2)
    c = str(tmp_path / "c")
    jax_store.make_synthetic_feature_store(c, [9], 6, 4)
    with pytest.raises(ValueError, match="different geometry"):
        port_store.CombinedFeatureStore(
            [port_store.FeatureStore(a), port_store.FeatureStore(c)])


def test_batches_of_a_prepared_corpus_match_jax(corpus, tmp_path):
    """Every field of every batch over both splits of the prepared corpus,
    through the per-split stores: equal, the last batch's pad rows (which
    repeat its last row) included."""
    data = _prepared(corpus, tmp_path, "all")
    train_ids, val_ids = _store_ids(data["port"][0])
    for split, ids in (("train", train_ids), ("val", val_ids)):
        jax_store.make_synthetic_feature_store(
            str(tmp_path / f"resnet152_{split}"), ids, 6, 8)
    stores = {"jax": jax_store.open_feature_store(str(tmp_path)),
              "port": port_store.open_feature_store(str(tmp_path))}
    fields = ("image_features", "questions", "answers", "ques_length",
              "valid", "soft_answers", "soft_idx", "soft_val", "soft_n",
              "answer_types", "question_ids", "question_types")
    n_pad = 0
    for split in ("train", "val"):
        kw = dict(batch_size=16, num_answers=12, soft_answer=True, seed=4,
                  feature_dtype=np.float16)
        got = port_dataset.VqaBatches(getattr(data["port"][0], split),
                                      stores["port"], **kw)
        want = jax_dataset.VqaBatches(getattr(data["jax"][0], split),
                                      stores["jax"], **kw)
        assert len(got) == len(want)
        for g, w in zip(got.epoch(1), want.epoch(1)):
            for field in fields:
                a, b = getattr(g, field), getattr(w, field)
                assert a is not None, field
                assert a.dtype == b.dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)
            n_pad += int((~g.valid).sum())
    assert n_pad > 0


def test_legacy_samplers_match_jax(tmp_path):
    data = port_prepare.make_synthetic_qa_data(np.random.default_rng(3),
                                               n_train=20, n_val=4,
                                               num_images=5)
    bank = np.random.default_rng(4).standard_normal((5, 6, 8))
    id_map = {i: 4 - i for i in range(5)}
    for batch_no in (0, 1, 3, 7):
        got = port_samplers.sample_batch_hard(batch_no, 6, bank, id_map,
                                              data.train)
        want = jax_samplers.sample_batch_hard(batch_no, 6, bank, id_map,
                                              data.train)
        got_s = port_samplers.sample_batch_soft(batch_no, 6, bank, id_map,
                                                data.train, 16)
        want_s = jax_samplers.sample_batch_soft(batch_no, 6, bank, id_map,
                                                data.train, 16)
        for g, w in zip(got + got_s, want + want_s):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _glove_file(path, vocab, dim=300, seed=7):
    """A GloVe text file: most vocabulary words, a word with a space in it,
    a malformed line, a duplicate (the first one wins) and words outside
    the vocabulary."""
    rng = np.random.default_rng(seed)
    words = [w for w in vocab if w != "UNK"][:-2] + ["a b", "zebra", "UNK"]
    lines = []
    for i, w in enumerate(words):
        vec = rng.standard_normal(dim).astype(np.float32)
        lines.append(w + " " + " ".join(f"{v:.6f}" for v in vec))
        if i == 1:
            lines.append(w + " " + " ".join(["9.0"] * dim))  # duplicate
            lines.append("broken 1.0 2.0")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_glove_tables_match_jax(tmp_path):
    vocab = {f"w{i}": i + 1 for i in range(30)}
    vocab["UNK"] = 31
    vectors = _glove_file(tmp_path / "glove.txt", vocab)
    js, ps = {}, {}
    want = jax_glove.build_glove_table_from_text(vocab, vectors, stats=js)
    got = port_glove.build_glove_table_from_text(vocab, vectors, stats=ps)
    np.testing.assert_array_equal(got, want)
    assert ps == js and ps["matched"] == 29 and got.shape == (32, 300)
    assert not got[0].any()  # the pad row
    np.testing.assert_array_equal(port_glove.random_glove_table(vocab, 300, 3),
                                  jax_glove.random_glove_table(vocab, 300, 3))
    port_glove.save_glove_table(got, str(tmp_path / "t.npy"))
    np.testing.assert_array_equal(
        jax_glove.load_glove_table(str(tmp_path / "t.npy")), got)
    assert port_glove.load_glove_table(str(tmp_path / "none.npy")) is None
    # the spaCy path: an ImportError without spaCy, as in JAX
    try:
        import spacy  # noqa: F401
    except ImportError:
        for module in (port_glove, jax_glove):
            with pytest.raises(ImportError):
                module.build_glove_table(vocab)


@pytest.mark.parametrize("source", ["vectors", "random"])
def test_build_glove_cli_matches_jax(tmp_path, capsys, source):
    vocab = {f"w{i}": i + 1 for i in range(12)}
    vocab["UNK"] = 13
    vocab_path = tmp_path / "qa.vocab.json"
    vocab_path.write_text(json.dumps({"question_vocab": vocab}))
    extra = (["--vectors", _glove_file(tmp_path / "g.txt", vocab)]
             if source == "vectors" else ["--random"])
    printed, tables = {}, {}
    for name, cli in (("jax", jax_build_glove), ("port", port_build_glove)):
        out = str(tmp_path / f"{name}.npy")
        cli.main(["--vocab", str(vocab_path), "--out", out] + extra)
        printed[name] = capsys.readouterr().out.replace(out, "OUT")
        tables[name] = np.load(out)
    assert printed["port"] == printed["jax"]
    np.testing.assert_array_equal(tables["port"], tables["jax"])
    assert tables["port"].shape == (14, 300)
