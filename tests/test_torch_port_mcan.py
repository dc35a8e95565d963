"""MCAN (``models/mcan.py``), the family the port has and the JAX package
has not, against its plain float32 reference (``port_bench/reference/
mcan.py``, the benchmark's).

On the CPU, at d = 128 (two heads of 64), two layers a stack, AttFlat's
MLP 32, questions of 6 tokens, a 196-cell grid of 64 channels:

- the eval forward's logits against the reference's, with padded
  questions and zeroed grid cells so that both masks act (and a reference
  that ignores them reads far off); at f32 (the order of sums only) and at
  bf16 (the port's rounding points);
- the three spans of the forward, recorded under a profiler;
- the training forward, every dropout on from one generator: the loss
  (``losses.vqa_score_bce`` over ``vqa_scores``) and every leaf's
  gradient;
- the composed LayerNorm against MCAN's formula (the unbiased std, eps
  added to it), which a biased std or eps under the root would miss: the
  latter on rows of a tiny spread, where eps is not negligible;
- the Solver: two bf16 steps with finite losses, its first f32 loss equal
  to the reference's, and tensor parallelism refused by name;
- ``export_serving``: the graph calls the norm op, and the artifact serves
  the eager engine's answers;
- the benchmark's seeded weights loaded into the model, and its count of
  operations against a hand count.

On the card (skipped here): the fused residual + LayerNorm kernel against
the composed form at MCAN-large's widths and on rows of a tiny spread;
``tests/test_torch_port_serve_
graph.py`` serves MCAN from the CUDA graph. Run them there with
``python -m pytest tests/test_torch_port_mcan.py -q --noconftest``.

This file imports neither JAX nor the JAX package.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from port_bench.reference import mcan as ref
from vqa_attention_networks_tpu_torch import aot
from vqa_attention_networks_tpu_torch.config import (
    MODEL_NAMES,
    PORT_MODEL_NAMES,
    Config,
)
from vqa_attention_networks_tpu_torch.models import TRAINABLE, get_model
from vqa_attention_networks_tpu_torch.models import mcan
from vqa_attention_networks_tpu_torch.ops import card_cases as cc
from vqa_attention_networks_tpu_torch.ops import mcan_norm
from vqa_attention_networks_tpu_torch.serve import InferenceEngine
from vqa_attention_networks_tpu_torch.train.losses import (
    vqa_score_bce,
    vqa_scores,
)
from vqa_attention_networks_tpu_torch.weights import (
    _module_leaves,
    load_jax_params,
)

ROOT = Path(__file__).resolve().parents[1]
N, T, L, D, VOCAB, ANSWERS = 3, 6, 196, 64, 50, 16
SMALL = dict(model_name="mcan", q_vocab_size=VOCAB, a_vocab_size=ANSWERS,
             hidden_dim=128, emb_dim=24, att_num=2, embed_size=32,
             img_feature_channel=D, max_question_length=T)


def small_cfg(**kw) -> Config:
    return Config(**dict(SMALL, **kw)).validate()


def params_for(cfg: Config, seed: int = 0):
    """Every leaf drawn from numpy: weights at a xavier-like scale, biases
    nonzero, LayerNorm gains around 1, so that a leaf read wrong shows."""
    rng = np.random.default_rng(seed)
    tree = mcan.init_params(cfg, torch.Generator().manual_seed(seed))
    out = {}
    for layer, leaves in tree.items():
        out[layer] = {}
        for leaf, v in leaves.items():
            shape = tuple(v.shape)
            if len(shape) == 2:
                x = rng.standard_normal(shape) * math.sqrt(
                    2.0 / (shape[0] + shape[1]))
            elif layer.endswith("norm") or "_norm" in layer:
                x = (1.0 + 0.5 * rng.standard_normal(shape)
                     if leaf == "w" else 0.1 * rng.standard_normal(shape))
            else:
                x = 0.05 * rng.standard_normal(shape)
            out[layer][leaf] = x.astype(np.float32)
    return out


def flat(tree):
    return {f"{layer}/{leaf}": torch.as_tensor(v)
            for layer, leaves in tree.items() for leaf, v in leaves.items()}


def inputs(seed: int = 1):
    """Features with zeroed cells (sample 0: 5 cells, sample 2: 30) and
    questions of 6, 3 and 1 tokens."""
    rng = np.random.default_rng(seed)
    img = np.maximum(rng.standard_normal((N, L, D)), 0).astype(np.float32)
    img[0, 10:15] = 0.0
    img[2, 100:130] = 0.0
    ques = rng.integers(1, VOCAB, (N, T)).astype(np.int64)
    ques[1, 3:] = 0
    ques[2, 1:] = 0
    return torch.from_numpy(img), torch.from_numpy(ques)


def model_for(cfg, tree):
    return load_jax_params(get_model("mcan")(cfg), tree).eval()


def test_mcan_is_a_port_family_beside_the_jax_names():
    assert PORT_MODEL_NAMES == MODEL_NAMES + ("mcan",)
    assert "mcan" in TRAINABLE and get_model("mcan") is mcan.MCAN
    cfg = Config(model_name="mcan").validate()
    assert cfg.soft_answer
    # every MCAN-large width is a default: d 1024, 300-d words, 6 layers,
    # AttFlat 512, dropout 0.1
    assert (cfg.hidden_dim, cfg.emb_dim, cfg.att_num, cfg.embed_size,
            cfg.dropout_fusion) == (1024, 300, 6, 512, 0.1)
    assert mcan.num_heads(1024) == 16


def test_eval_logits_match_the_reference_at_f32():
    """f32 on both sides: only the order of the sums differs (F.linear's
    addmm against matmul and add), over 4 norms and 6 attentions: atol
    1e-4 on logits of a few units. The masks act: the reference with its
    masks filled with 0 instead of -1e9 reads 100 times further off."""
    cfg = small_cfg()
    tree = params_for(cfg)
    img, ques = inputs()
    with torch.no_grad():
        got = model_for(cfg, tree)(img, ques)
        want = ref.forward(flat(tree), img, ques, SMALL)
    assert got.dtype == torch.float32 and got.shape == (N, ANSWERS)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    unmasked = ref.MASK_FILL
    try:
        ref.MASK_FILL = 0.0
        loose = ref.forward(flat(tree), img, ques, SMALL)
    finally:
        ref.MASK_FILL = unmasked
    assert (loose - want).abs().amax(1).min() > 1e-2


def test_eval_logits_match_the_reference_at_bf16():
    """bf16 activations (the residual stream, every product's output and
    the attention maps in bf16; the norms' statistics f32): logits within
    0.1 of the f32 reference's, whose spread is several units; the
    largest error stays under a twentieth of the largest logit."""
    cfg = small_cfg(compute_dtype="bfloat16")
    tree = params_for(cfg)
    img, ques = inputs()
    with torch.no_grad():
        got = model_for(cfg, tree)(img, ques)
        want = ref.forward(flat(tree), img, ques, SMALL)
    assert got.dtype == torch.float32
    err = (got - want).abs().max()
    assert err < 0.1 and err < want.abs().max() / 20


def test_the_forward_records_its_three_spans():
    """Under a profiler the eager forward records ``mcan.encoder``,
    ``mcan.decoder`` and ``mcan.head``, one after another; without one,
    nothing."""
    from torch.profiler import ProfilerActivity, profile

    from vqa_attention_networks_tpu_torch.utils import trace

    cfg = small_cfg(att_num=1)
    model = model_for(cfg, params_for(cfg))
    img, ques = inputs()
    trace.reset()
    try:
        with torch.no_grad():
            model(img, ques)
            assert trace.spans() == []
            with profile(activities=[ProfilerActivity.CPU]):
                model(img, ques)
        got = trace.spans()
        assert [sp.name for sp in got] == ["mcan.encoder", "mcan.decoder",
                                           "mcan.head"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))
    finally:
        trace.reset()


def _grads(model, tree):
    """The model's gradients by the tree's leaves, in the JAX layout."""
    return {path: (t.grad.t() if transpose else t.grad)
            for path, (t, transpose) in _module_leaves(model).items()}


def test_training_loss_and_every_gradient_match_with_dropout_on():
    """f32, dropout 0.1 everywhere, the masks drawn from one generator in
    the reference's order: the summed BCE over VQA scores within 1e-4
    relative, and each leaf's gradient within 1e-4 of its largest
    magnitude (summation order only). The key projections' biases and
    AttFlat's score biases get round-off alone (a constant added to every
    key's score of a softmax leaves it as it was): in both they are under a
    millionth of the median leaf's."""
    cfg = small_cfg()
    tree = params_for(cfg)
    img, ques = inputs()
    soft = torch.zeros(N, ANSWERS)
    soft[0, 3], soft[0, 5] = 0.7, 0.3
    soft[1, 2] = 1.0
    soft[2, 7], soft[2, 1], soft[2, 4] = 0.5, 0.4, 0.1
    soft_n = torch.tensor([10, 10, 10])
    model = model_for(cfg, tree).train()
    logits = model(img, ques, train=True,
                   generator=torch.Generator().manual_seed(7))
    loss = vqa_score_bce(logits, vqa_scores(soft, soft_n))
    loss.backward()
    p = {k: v.requires_grad_() for k, v in flat(tree).items()}
    want_logits = ref.train_forward(
        p, img, ques, SMALL, torch.Generator().manual_seed(7), 0)
    want = ref.loss(want_logits, soft, soft_n)
    want.backward()
    torch.testing.assert_close(loss, want, rtol=1e-4, atol=0)
    # the dropout acted: without it the loss is another
    with torch.no_grad():
        plain = ref.loss(ref.forward(flat(tree), img, ques, SMALL), soft,
                         soft_n)
    assert abs(float(plain) - float(want.detach())) > 1e-3
    got = _grads(model, tree)
    assert set(got) == set(p)
    scales = {k: float(p[k].grad.abs().max()) for k in p}
    floor = 1e-3 * float(np.median(list(scales.values())))
    # round-off alone: the key biases, and AttFlat's score bias (a
    # constant added to every position's score of a softmax)
    invariant = {k for k in p if k.endswith("_k/b")
                 or (k.startswith("attflat") and k.endswith("_out/b"))}
    assert {k for k, v in scales.items() if v < 1e-3 * floor} == invariant
    for k, g in got.items():
        if k in invariant:  # round-off in the port too
            assert float(g.abs().max()) < 1e-3 * floor, k
        else:
            assert float((g - p[k].grad).abs().max()) <= 1e-4 * scales[k], k


def test_vqa_scores_are_mcans_get_score():
    soft = torch.tensor([[0.1, 0.2, 0.3, 0.4, 0.0],
                         [1.0 / 3, 2.0 / 3, 0.0, 0.0, 0.0]])
    got = vqa_scores(soft, torch.tensor([10, 3]))
    assert torch.equal(got, torch.tensor([[0.3, 0.6, 0.9, 1.0, 0.0],
                                          [0.3, 0.6, 0.0, 0.0, 0.0]]))
    # a split without annotator counts reads VQA's ten
    assert torch.equal(vqa_scores(soft[:1]), got[:1])
    logits = torch.randn(2, 5)
    valid = torch.tensor([True, False])
    torch.testing.assert_close(
        vqa_score_bce(logits, got, valid),
        F.binary_cross_entropy_with_logits(logits[:1], got[:1],
                                           reduction="sum"))


def test_composed_norm_is_mcans_formula():
    """a (z - mean) / (std + 1e-6) + b with the unbiased std: in float64 by
    hand at 1e-5 (f32 statistics); the biased std and F.layer_norm (eps
    under the root, biased variance) read 1e-2 off at a width of 8. At
    bf16 the sum x + r is rounded first, the rest is f32."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 8))
    r = rng.standard_normal((5, 8))
    a = 1.0 + 0.5 * rng.standard_normal(8)
    b = 0.1 * rng.standard_normal(8)
    z = x + r
    mean = z.mean(-1, keepdims=True)
    std = z.std(-1, ddof=1, keepdims=True)
    want = a * (z - mean) / (std + 1e-6) + b
    t = [torch.tensor(v, dtype=torch.float32) for v in (x, r, a, b)]
    got = mcan_norm.add_layernorm_composed(*t).double().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    biased = a * (z - mean) / (z.std(-1, keepdims=True) + 1e-6) + b
    assert np.abs(biased - want).max() > 1e-2
    torch_ln = F.layer_norm(t[0] + t[1], (8,), t[2], t[3], eps=1e-6)
    assert np.abs(torch_ln.double().numpy() - want).max() > 1e-2
    # the op runs the composed form on a CPU tensor, bit for bit
    xb, rb = (v.to(torch.bfloat16) for v in t[:2])
    composed = mcan_norm.add_layernorm_composed(xb, rb, t[2], t[3])
    assert composed.dtype == torch.bfloat16
    assert torch.equal(mcan_norm.add_layernorm(xb, rb, t[2], t[3]), composed)
    zb = (xb + rb).double()
    by_hand = (t[2].double() * (zb - zb.mean(-1, keepdim=True))
               / (zb.std(-1, keepdim=True) + 1e-6) + t[3].double())
    torch.testing.assert_close(composed.double(), by_hand, atol=0,
                               rtol=2.0 ** -8)


def tiny_spread_rows(rows: int, d: int, gen: torch.Generator,
                     device="cpu") -> tuple:
    """x and r of a spread of ~1e-3 (z = x + r: std ~1.4e-3), gains about 1:
    there sqrt(var + 1e-6) and std + 1e-6 differ by ~20%, so a norm with
    eps under the root reads far off."""
    x, r = (1e-3 * torch.randn(rows, d, generator=gen, device=device)
            for _ in range(2))
    w = 1.0 + 0.5 * torch.randn(d, generator=gen, device=device)
    b = 0.1 * torch.randn(d, generator=gen, device=device)
    return x, r, w, b


def eps_under_the_root(x, r, w, b) -> torch.Tensor:
    """The unbiased variance with eps under the root: what MCAN's norm is
    not."""
    z = (x + r).float()
    var = z.var(-1, keepdim=True)
    y = w * (z - z.mean(-1, keepdim=True)) / torch.sqrt(var + 1e-6) + b
    return y.to(x.dtype)


def test_composed_norm_adds_eps_to_the_std():
    """Rows of a tiny spread: the composed form is the float64 formula
    (1e-3 on outputs of order 1: the f32 statistics of a 1e-3 spread),
    while eps under the root, with the unbiased variance, reads ~20% off."""
    x, r, w, b = tiny_spread_rows(6, 64, torch.Generator().manual_seed(4))
    z = (x + r).double()
    want = (w.double() * (z - z.mean(-1, keepdim=True))
            / (z.std(-1, keepdim=True) + 1e-6) + b.double())
    got = mcan_norm.add_layernorm_composed(x, r, w, b)
    torch.testing.assert_close(got.double(), want, atol=1e-3, rtol=0)
    wrong = eps_under_the_root(x, r, w, b).double()
    assert float((wrong - want).abs().max()) > 0.1


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from vqa_attention_networks_tpu_torch.data import feature_store
    from vqa_attention_networks_tpu_torch.data import prepare

    qa = prepare.make_synthetic_qa_data(np.random.default_rng(0), n_train=40,
                                        n_val=16, num_images=6, max_len=T)
    store = feature_store.make_synthetic_feature_store(
        str(tmp_path_factory.mktemp("feat")),
        sorted(set(qa.train.image_ids) | set(qa.val.image_ids)), channels=D)
    return qa, store


def solver_cfg(qa, **kw) -> Config:
    return small_cfg(q_vocab_size=qa.q_vocab_size,
                     a_vocab_size=qa.a_vocab_size, batch_size=24,
                     num_epoch=1, checkpoint_every_steps=0,
                     prefetch_workers=1, **kw)


def test_the_solver_trains_mcan(data):
    """bf16, dropout on: two steps of ``train()`` with finite losses, and
    the weights move."""
    from vqa_attention_networks_tpu_torch.train.solver import Solver

    qa, store = data
    solver = Solver(solver_cfg(qa, compute_dtype="bfloat16"), qa, store,
                    device="cpu")
    before = solver.model.proj.weight.detach().clone()
    seen = []
    metrics = solver.train(on_step=lambda step, loss: seen.append(
        float(loss)))
    assert len(seen) == 2 and np.isfinite(seen).all()
    assert all(np.isfinite(v) for v in metrics.values())
    assert not torch.equal(solver.model.proj.weight, before)


def test_the_solvers_first_loss_is_the_references(data):
    """f32, dropout 0: the Solver's first step's loss is the reference's on
    the same rows, scores and weights (rtol 1e-5, summation order)."""
    from vqa_attention_networks_tpu_torch.train.solver import Solver

    qa, store = data
    cfg = solver_cfg(qa, dropout_fusion=0.0, shuffle=False)
    tree = params_for(cfg)
    solver = Solver(cfg, qa, store, params=tree, device="cpu")
    batch = next(iter(solver.batches["train"].epoch()))
    seen = []
    loss_fn = solver._loss
    solver._loss = lambda *a, **k: seen.append(loss_fn(*a, **k)) or seen[-1]
    solver._train_step(batch)
    img = torch.from_numpy(batch.image_features.astype(np.float32))
    logits = ref.forward(flat(tree), img,
                         torch.from_numpy(batch.questions).long(), SMALL)
    want = ref.loss(logits, torch.from_numpy(batch.soft_answers),
                    torch.from_numpy(batch.soft_n))
    torch.testing.assert_close(seen[0], want, rtol=1e-5, atol=0)


def test_the_solver_refuses_tensor_parallel_mcan(data):
    from vqa_attention_networks_tpu_torch.train.solver import Solver

    qa, store = data
    with pytest.raises(ValueError, match="model_parallel=2: tensor "
                       "parallelism splits the MFB fusions' columns "
                       r"\(mfb_out\), and mcan has none"):
        Solver(solver_cfg(qa, model_parallel=2), qa, store, device="cpu")


def test_export_serving_of_mcan(tmp_path, monkeypatch):
    """bf16: the exported graph calls the norm op and the attention op
    (``fast_path_traced``), the attention one node a layer's attention (6
    at two layers a stack: 2 encoder, 2 x 2 decoder), with no score map's
    softmax left; the artifact serves the eager engine's answers bit for
    bit."""
    monkeypatch.delenv("VQA_DISABLE_PALLAS", raising=False)
    cfg = small_cfg(compute_dtype="bfloat16")
    tree = params_for(cfg)
    b = 4
    exported = aot.export_serving(cfg, tree, b, device="cpu")
    ops = aot.graph_ops(exported)
    assert "vqa.mcan_add_layernorm.default" in ops
    assert "vqa.mcan_attention.default" in ops
    targets = [str(node.target) for node in exported.graph.nodes
               if node.op == "call_function"]
    assert targets.count("vqa.mcan_attention.default") == 3 * cfg.att_num
    # what stays composed: AttFlat's two softmaxes and the serving head's
    assert sum("softmax" in t for t in targets) == 3
    aot.save_serving_artifact(str(tmp_path / "aot"), cfg, tree, b,
                              device="cpu")
    meta = json.loads((tmp_path / "aot" / "serving.json").read_text())
    assert meta["fast_path_traced"] is True
    assert meta["kernel_ops"] == ["vqa.mcan_add_layernorm.default",
                                  "vqa.mcan_attention.default"]
    img, ques = inputs()
    feats = img.numpy().astype(np.float16)
    kw = dict(batch_size=b, topk=5, device="cpu")
    got = InferenceEngine(cfg, tree, artifact_dir=str(tmp_path / "aot"),
                          **kw).predict_batch(feats, ques.numpy())
    want = InferenceEngine(cfg, tree, **kw).predict_batch(feats,
                                                          ques.numpy())
    for g, w in zip(got, want):
        assert np.array_equal(g.top_ids, w.top_ids)
        assert np.array_equal(g.top_probs, w.top_probs)


def test_the_benchmarks_weights_load_into_the_model():
    """The benchmark's leaves (``param_shapes``) are the model's, and its
    seeded weights, loaded into the model, give the reference's logits
    (f32, summation order: 1e-4)."""
    from port_bench import inputs as bench_inputs

    cfg = small_cfg()
    shapes = ref.param_shapes(SMALL)
    assert set(shapes) == set(flat(mcan.init_params(cfg, torch.Generator())))
    p = bench_inputs.weights(shapes, 2 ** 31 + 5, "cpu")
    tree = {}
    for key, v in p.items():
        layer, leaf = key.rsplit("/", 1)
        tree.setdefault(layer, {})[leaf] = v.numpy()
    img, ques = inputs()
    with torch.no_grad():
        got = model_for(cfg, tree)(img, ques)
    torch.testing.assert_close(got, ref.forward(p, img, ques, SMALL),
                               atol=1e-4, rtol=1e-4)


def test_the_training_check_holds_the_solver_to_the_reference(capsys):
    """``tools/mcan_train_check.py`` on the CPU at the small size, f32,
    dropout on: the benchmark's training driver runs the Solver and, with
    MCAN's loss, the reference over the same first steps; the logits, the
    first gradient's norms and the parameters' change agree to the order
    of the sums (1e-4), and every gradient reaches the same elements."""
    from port_bench.harness import load_module

    tool = load_module(ROOT / "tools" / "mcan_train_check.py",
                       "mcan_train_check")
    fields = dict(SMALL, compute_dtype="float32")
    fields.pop("model_name")
    threads = torch.get_num_threads()
    try:
        tool.main(["--seed", str(2 ** 31 + 9), "--batch", "8", "--seconds",
                   "0.2", "--device", "cpu", "--fields", json.dumps(fields),
                   "--traffic", json.dumps({"images": 32, "pool": 4,
                                            "warm_steps": 3})])
    finally:
        torch.set_num_threads(threads)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    numbers = out["numbers"]
    assert numbers["support_gap"] == 0.0
    for key in ("logit_err", "change_gap", "change_worst", "grad_worst"):
        assert numbers[key] < 1e-4, (key, numbers)
    assert out["steps"] >= 1 and out["train_qa_pairs_per_s"] > 0


def test_serve_flops_by_hand():
    """T=2, L=3, D=4, d=2 (one head), e=1, AttFlat 2, A=5, one layer."""
    from port_bench.harness import load_module

    counts = load_module(ROOT / "port_bench" / "counts" / "mcan_large.py",
                         "counts.mcan_large")
    s = dict(max_question_length=2, img_feature_dim=3, img_feature_channel=4,
             hidden_dim=2, emb_dim=1, embed_size=2, a_vocab_size=5,
             att_num=1)
    lstm = 2 * 2 * (1 + 2) * 8
    image = 2 * 3 * 4 * 2
    encoder = 4 * 2 * 2 * 2 * 2 + 2 * 2 * 2 * 2 * 2 + 2 * 2 * 2 * 2 * 8
    decoder = (4 * 2 * 3 * 2 * 2 + 2 * 2 * 3 * 3 * 2      # self-attention
               + 2 * 2 * 3 * 2 * 2 + 2 * 2 * 2 * 2 * 2    # q, merge; k, v
               + 2 * 2 * 3 * 2 * 2                        # guided products
               + 2 * 2 * 3 * 2 * 8)                       # FFN
    flat_mlps = 2 * 2 * (2 * 2 + 2) + 2 * 3 * (2 * 2 + 2)
    pools, merges, classifier = 2 * 5 * 2, 2 * 2 * 2 * 4, 2 * 4 * 5
    total = (lstm + image + encoder + decoder + flat_mlps + pools + merges
             + classifier)
    assert counts.serve_flops(s) == total
    assert counts.gemm(s, 3)["bf16"] == 3 * (total - pools)
    assert counts.norm_launches(s) == 6
    # 2 norms over 2 question rows, 3 over 3 grid rows, 1 over a row of 4
    assert counts.norm(s, 1)["bytes"] == (2 * (6 * 2 * 2 + 16)
                                          + 3 * (6 * 3 * 2 + 16)
                                          + 6 * 4 + 32)
    full = dict(max_question_length=14, img_feature_dim=196,
                img_feature_channel=2048, hidden_dim=1024, emb_dim=300,
                embed_size=512, a_vocab_size=3129, att_num=6)
    assert counts.serve_flops(full) == pytest.approx(39.2e9, rel=1e-3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("rows,d", [(256 * 196, 1024), (256 * 14, 1024),
                                    (256, 2048), (37, 128), (5, 24)])
def test_fused_norm_kernel_on_the_card(card, rows, d):
    """MCAN-large's three shapes and two ragged ones: bf16 in and out.
    Both round z = x + r to bf16 and keep the statistics in f32, so they
    differ only in the order of the f32 sums: an output may round one bf16
    ulp apart (2^-7 to 2^-8 of its magnitude), and under 1% do. Near 0 an
    output is the difference of terms of order 1, whose f32 rounding in
    another order leaves ~1e-6 that no ulp of the tiny output covers:
    2^-16 besides (``card_cases.n1_within``)."""
    x, r, w, b = cc.n1_inputs(rows, d, rows + d, card)
    before = mcan_norm.launch_count
    got = mcan_norm.add_layernorm(x, r, w, b)
    torch.cuda.synchronize()
    assert mcan_norm.launch_count == before + 1
    want = mcan_norm.add_layernorm_composed(x, r, w, b)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    diff = (got.float() - want.float()).abs()
    assert cc.n1_within(got, want).all(), float(diff.max())
    assert float((diff > 0).float().mean()) < 0.01
    with pytest.raises(TypeError, match="bf16"):
        mcan_norm.add_layernorm(x.float(), r.float(), w, b)


def test_fused_norm_kernel_adds_eps_to_the_std_on_the_card(card):
    """Rows of a tiny spread at MCAN-large's width, bf16: the kernel within
    the tolerance of ``test_fused_norm_kernel_on_the_card`` of the composed
    form, and a norm with eps under the root outside it on most outputs."""
    x, r, w, b = tiny_spread_rows(256, 1024,
                                  torch.Generator(device=card).manual_seed(5),
                                  card)
    x, r = x.to(torch.bfloat16), r.to(torch.bfloat16)
    got = mcan_norm.add_layernorm(x, r, w, b)
    want = mcan_norm.add_layernorm_composed(x, r, w, b)
    assert cc.n1_within(got, want).all()
    assert float((got.float() != want.float()).float().mean()) < 0.01
    wrong = eps_under_the_root(x, r, w, b)
    assert float((~cc.n1_within(wrong, want)).float().mean()) > 0.5
