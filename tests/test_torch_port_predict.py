"""The port's ``cli.predict`` and ``cli.extract_features`` against the JAX
package's CLIs, on the CPU, on the same images and weights.

- ``cli.predict``: both CLIs read the same reference ``.pth`` (JAX's
  ``export_state_dict`` of one parameter tree, ``--torch_checkpoint``) and
  the same VGG-19 ``.npz`` (``--backbone vgg19``, a cheaper trunk than
  ResNet-152 at 448), and print the answer and the top-k. With both
  trunks at f32 (the JAX extractor's bf16 is swapped for f32 in both
  packages for this comparison) the printed probabilities agree within
  ``F32_PROB_ATOL`` (4-decimal printing: half a unit of the last digit and
  f32 noise) and the ``--dump_attention`` maps within ``MAP_RTOL`` of each
  map's largest |value|; at the CLIs' own bf16 trunks the probabilities
  agree within ``BF16_PROB_ATOL`` (the trunks' grids differ by ~1e-2 of
  their largest value: ``test_torch_port_backbones.py``). Answers are
  compared at the ranks whose probabilities are clearly apart.
- ``cli.extract_features``: the same images through a depth-(1, 1, 1, 1)
  ResNet ``.npz`` at f32 in both CLIs give stores with the same ids and f16
  rows within one f16 rounding (``STORE_RTOL``) of JAX's.
"""

import contextlib
import functools
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import test_torch_port_backbones as tb
from test_torch_port_mhb_coatt import port_config
from vqa_attention_networks_tpu.cli import extract_features as jax_extract
from vqa_attention_networks_tpu.cli import predict as jax_predict
from vqa_attention_networks_tpu.config import Config
from vqa_attention_networks_tpu.data.feature_store import (
    FeatureStore as JaxStore,
)
from vqa_attention_networks_tpu.models import extractor as jax_extractor
from vqa_attention_networks_tpu.utils.torch_import import export_state_dict
from vqa_attention_networks_tpu_torch.cli import extract_features
from vqa_attention_networks_tpu_torch.cli import predict
from vqa_attention_networks_tpu_torch.data.feature_store import FeatureStore
from vqa_attention_networks_tpu_torch.models import extractor
from vqa_attention_networks_tpu_torch.train.solver import init_params

WORDS = ["what", "color", "is", "the", "cat", "dog", "sky"]
ANSWERS = ["black", "white", "blue", "red", "yes"]
F32_PROB_ATOL = 1e-4
# the bf16 trunks' grids differ by ~1e-2 of their largest value, and the
# answer layer (scaled 16x) turns that into logit differences of ~0.05:
# measured 6e-3 in a probability near 0.85 (hieCoAtten)
BF16_PROB_ATOL = 1e-2
MAP_RTOL = 1e-4
STORE_RTOL = 2.0 ** -10  # one f16 rounding


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    path = tmp_path_factory.mktemp("predict")
    q_vocab = {w: i + 1 for i, w in enumerate(WORDS)}
    q_vocab["UNK"] = len(WORDS) + 1
    vocab = {"question_vocab": q_vocab,
             "answer_vocab": {a: i for i, a in enumerate(ANSWERS)},
             "max_question_length": 6}
    with open(path / "vocab.json", "w") as f:
        json.dump(vocab, f)
    np.savez(path / "vgg.npz", **tb.vgg_state_dict(seed=8))
    Image.open(io.BytesIO(tb._png(3))).save(path / "cat.png")
    return path


@functools.lru_cache(maxsize=None)
def _pth(path, model: str) -> str:
    """A reference ``.pth`` of one JAX parameter tree at the widths the
    predict CLIs build (``Config()`` with the vocab's sizes and VGG's 512
    channels); the answer layer scaled so the answers are apart."""
    cfg = Config(model_name=model, q_vocab_size=len(WORDS) + 2,
                 a_vocab_size=len(ANSWERS), max_question_length=6,
                 img_feature_channel=512).validate()
    params = jax.tree_util.tree_map(
        lambda x: x.numpy(),
        init_params(port_config(cfg), torch.Generator().manual_seed(0)))
    last = {"hieCoAtten": "fc", "mfb": "linear_pred",
            "mhb_coAtt": "linear_pred"}[model]
    params[last] = dict(params[last], w=params[last]["w"] * 16.0)
    file = path / f"{model}.pth"
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in
                export_state_dict(model, params).items()}, file)
    return str(file)


def _run(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    top = re.findall(r"^  (\S+)  \(([0-9.]+)\)$", out, re.M)
    return {"answer": re.search(r"^Ans: (\S+)$", out, re.M).group(1),
            "top": [(a, float(p)) for a, p in top], "out": out}


def _same(got: dict, want: dict, atol: float) -> None:
    gp = np.array([p for _, p in got["top"]])
    wp = np.array([p for _, p in want["top"]])
    assert len(gp) == len(wp) == len(ANSWERS)
    np.testing.assert_allclose(gp, wp, rtol=0, atol=atol)
    gaps = wp[:-1] - wp[1:]
    clear = np.minimum(np.r_[np.inf, gaps], np.r_[gaps, 0.0]) > 2 * atol
    assert [a for (a, _), c in zip(got["top"], clear) if c] == \
        [a for (a, _), c in zip(want["top"], clear) if c]
    assert clear.any()
    if clear[0]:
        assert got["answer"] == want["answer"]


def _argv(path, model, *extra):
    return ["--image_path", str(path / "cat.png"), "--model_name", model,
            "--vocab", str(path / "vocab.json"),
            "--question", "what color is the cat", "--backbone", "vgg19",
            "--weights", str(path / "vgg.npz"),
            "--torch_checkpoint", _pth(path, model), *extra]


@pytest.fixture
def f32_trunks(monkeypatch):
    """Both extractors' VGG trunks at f32 (JAX's is bf16 by construction)."""
    jax_grid = jax_extractor.vgg.grid_features
    monkeypatch.setattr(jax_extractor.vgg, "grid_features",
                        functools.partial(jax_grid, dtype=jnp.float32))
    port_grid = extractor.vgg.grid_features
    monkeypatch.setattr(
        extractor.vgg, "grid_features",
        lambda trunk, x, dtype=None: port_grid(trunk, x,
                                               dtype=torch.float32))


@pytest.mark.parametrize("model", ["hieCoAtten", "mfb", "mhb_coAtt"])
def test_predict_and_its_attention_dump_match_jax(workspace, f32_trunks,
                                                  model):
    """The answer, the top-k and ``--dump_attention``: hieCoAtten's av/aq
    maps, mfb's two glimpses' logits (with the quirk flag), and nothing for
    mhb_coAtt, whose eval forward keeps no maps in either package."""
    want = _run(jax_predict.main, _argv(
        workspace, model, "--dump_attention", str(workspace / "jax.npz")))
    got = _run(predict.main, _argv(
        workspace, model, "--device", "cpu",
        "--dump_attention", str(workspace / "port.npz")))
    _same(got, want, F32_PROB_ATOL)
    if model == "mhb_coAtt":
        assert "exposes no attention maps" in got["out"]
        assert "exposes no attention maps" in want["out"]
        return
    with np.load(workspace / "jax.npz") as j, \
            np.load(workspace / "port.npz") as p:
        assert sorted(p.files) == sorted(j.files)
        assert sorted(j.files) == (["aq", "av"] if model == "hieCoAtten"
                                   else ["co_att_logits", "q_att_logits",
                                         "uniform_quirk"])
        for key in j.files:
            assert p[key].shape == j[key].shape
            want_map = j[key].astype(np.float64)
            np.testing.assert_allclose(
                p[key], want_map, rtol=0,
                atol=MAP_RTOL * max(np.abs(want_map).max(), 1e-30))


def test_predict_at_the_bf16_trunk_matches_jax(workspace):
    """The CLIs as they run, each with its bf16 trunk; the model at f32
    (JAX's predict) and, in the port, at bf16 too (K4's plain version
    here): the same answers."""
    want = _run(jax_predict.main, _argv(workspace, "hieCoAtten"))
    got = _run(predict.main, _argv(workspace, "hieCoAtten", "--device",
                                   "cpu"))
    _same(got, want, BF16_PROB_ATOL)
    got = _run(predict.main, _argv(workspace, "hieCoAtten", "--device",
                                   "cpu", "--compute_dtype", "bfloat16"))
    assert got["answer"] == want["answer"]


def test_predict_refusals(workspace):
    if not torch.cuda.is_available():
        # the default device is the card, never a silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            predict.main(_argv(workspace, "mhb_coAtt"))
    with pytest.raises(SystemExit, match="unknown backbone"):
        predict.main(_argv(workspace, "mhb_coAtt", "--device", "cpu",
                           "--backbone", "alexnet"))
    with pytest.raises(SystemExit, match="glove_table"):
        predict.main(_argv(workspace, "mhb_coAtt", "--device", "cpu",
                           "--glove", "1"))
    assert predict.parse_args([]).device == "cuda"
    assert predict.parse_args([]).compute_dtype == "float32"


def _images(directory, ids, size=64):
    rng = np.random.default_rng(0)
    for i in ids:
        arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(arr).save(directory / f"COCO_val2014_{i:012d}.jpg")


def test_extract_features_matches_the_jax_cli(tmp_path, capsys):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    ids = [3, 7, 11, 19, 23]
    _images(img_dir, ids)
    (img_dir / "annotations.json").write_text("{}")
    (img_dir / "notes_readme.jpg.txt").write_text("x")
    np.savez(tmp_path / "resnet.npz",
             **tb.resnet_state_dict((1, 1, 1, 1), seed=11))
    argv = ["--split", "val", "--image_dir", str(img_dir),
            "--batch_size", "2", "--size", "64", "--dtype", "float32",
            "--weights", str(tmp_path / "resnet.npz")]
    jax_extract.main(argv + ["--output_dir", str(tmp_path / "jax")])
    capsys.readouterr()
    extract_features.main(argv + ["--output_dir", str(tmp_path / "port"),
                                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "skipping 2" in out and "64" in out
    got = FeatureStore(str(tmp_path / "port" / "resnet152_val"))
    want = JaxStore(str(tmp_path / "jax" / "resnet152_val"))
    assert sorted(got.row_of) == sorted(want.row_of) == ids
    g = got.gather(ids, dtype=np.float32)
    w = want.gather(ids, dtype=np.float32)
    assert g.shape == w.shape == (len(ids), 4, 2048)
    np.testing.assert_allclose(g, w, rtol=STORE_RTOL,
                               atol=STORE_RTOL * np.abs(w).max() * 1e-2)
    assert extract_features._image_id("COCO_val2014_000000000042.jpg") == 42
    assert extract_features._image_id("img (1).jpg") is None


def test_convert_weights_round_trip(tmp_path):
    sd = {"conv1.weight": torch.randn(4, 3, 7, 7), "bn1.bias": torch.ones(4)}
    torch.save(sd, tmp_path / "w.pth")
    extract_features.convert_weights([str(tmp_path / "w.pth"),
                                      str(tmp_path / "w.npz")])
    with np.load(tmp_path / "w.npz") as f:
        assert sorted(f.files) == sorted(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(f[k], v.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            extract_features.main(["--image_dir", str(tmp_path)])
