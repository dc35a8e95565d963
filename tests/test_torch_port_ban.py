"""BAN (``models/ban.py``), a family the port has and the JAX package has
not, against its plain float32 reference (``port_bench/reference/ban.py``,
the benchmark's), and its attention map N3 (``ops/ban_attention.py``).

On the CPU, at H = 64 (kH = 192), three glimpses, 16-wide word tables,
questions of 6 tokens, a 196-cell grid of 64 channels, the benchmark's
seeded weights (each weight-norm gain but h_mat's twice its direction's
norm, h_mat's its norm, as ban-vqa starts it: a peaked h_mat):

- the eval forward's logits against the reference's, with padded
  questions and zeroed grid cells: at f32 (the order of sums only) and at
  bf16 (the port's rounding points);
- the attention map's twin (what the op runs on a CPU tensor) against
  ban-vqa's composed einsum, masked cells included; h_bias moves no map;
- the weights formed once at load equal the weights formed in a forward,
  and are formed again once a parameter is written; the benchmark's tree,
  with no gain, loads each as its direction's norm;
- the glimpses run in series: swapping two whole glimpses moves the
  logits;
- the four spans of the forward, recorded under a profiler;
- the training forward, every dropout on from one generator: the loss and
  every leaf's gradient (the frozen table none);
- the Solver: two bf16 steps, its first f32 step's loss and Adam's first
  moments against the reference's, and tensor parallelism refused by name;
- ``export_serving``: the graph calls N3's op once, and the artifact serves
  the eager engine's answers;
- the count of operations against a hand count.

On the CPU too: N3's tolerance (``card_cases.n3_within``) takes its map at
its own rounding points and rejects each of ``card_cases.n3_controls``.

On the card (skipped here): N3 against its map at its own rounding points
at BAN-8's shape, at the port's default widths and at ragged ones, each
control rejected; BAN-8 served by id from the CUDA graph, bit-equal to
``aot.serving_forward_banked`` called eagerly, with N3 once a batch. Run
them there with ``python -m pytest tests/test_torch_port_ban.py -q
--noconftest``.

This file imports neither JAX nor the JAX package.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import inputs as bench_inputs
from port_bench.reference import ban as ref
from vqa_attention_networks_tpu_torch import aot
from vqa_attention_networks_tpu_torch.config import (
    MODEL_NAMES,
    PORT_MODEL_NAMES,
    SCORE_MODELS,
    Config,
)
from vqa_attention_networks_tpu_torch.models import TRAINABLE, ban, get_model
from vqa_attention_networks_tpu_torch.models.layers import weight_norm
from vqa_attention_networks_tpu_torch.ops import ban_attention
from vqa_attention_networks_tpu_torch.ops import card_cases as cc
from vqa_attention_networks_tpu_torch.serve import InferenceEngine, TopK
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
SMALL = dict(model_name="ban", q_vocab_size=VOCAB, a_vocab_size=ANSWERS,
             hidden_dim=64, emb_dim=16, att_num=3, img_feature_channel=D,
             max_question_length=T)


def small_cfg(**kw) -> Config:
    return Config(**dict(SMALL, **kw)).validate()


def params_for(fields=None, seed: int = 2 ** 31 + 5, gain: float = 2.0):
    """The benchmark's weights (``reference.param_shapes``, which draws no
    gain) as a JAX-layout tree of numpy arrays, with each weight-norm gain
    but h_mat's set to ``gain`` ||V|| and h_mat's to ||V|| (``gain`` None:
    none set, the benchmark's tree), so that the gains are not all ||V||
    and the logits span a few units."""
    fields = dict(SMALL, **(fields or {}))
    tree = bench_inputs.tree(bench_inputs.weights(ref.param_shapes(fields),
                                                  seed, "cpu"))
    for name, leaves in tree.items():
        if gain is not None and "v" in leaves:
            scale = 1.0 if name == "v_att_h" else gain
            leaves["g"] = np.float32(scale * np.linalg.norm(leaves["v"]))
    return tree


def flat(tree):
    return {f"{layer}/{leaf}": torch.as_tensor(v)
            for layer, leaves in tree.items() for leaf, v in leaves.items()}


def inputs(seed: int = 1):
    """Features with zeroed cells (sample 0: 10 cells, sample 2: 40) and
    questions of 6, 3 and 1 tokens."""
    rng = np.random.default_rng(seed)
    img = np.maximum(rng.standard_normal((N, L, D)), 0).astype(np.float32)
    img[0, 10:20] = 0.0
    img[2, 100:140] = 0.0
    ques = rng.integers(1, VOCAB, (N, T)).astype(np.int64)
    ques[1, 3:] = 0
    ques[2, 1:] = 0
    return torch.from_numpy(img), torch.from_numpy(ques)


def model_for(cfg, tree):
    return load_jax_params(get_model("ban")(cfg), tree).eval()


def test_ban_is_a_port_family_beside_the_jax_names():
    assert PORT_MODEL_NAMES == MODEL_NAMES + ("mcan", "ban")
    assert "ban" in TRAINABLE and get_model("ban") is ban.BAN
    assert "ban" in SCORE_MODELS and small_cfg().soft_answer
    assert "ban" in aot.FAST_PATH_MODELS
    assert "vqa.ban_attention" in aot.FAST_PATH_OPS
    # the benchmark's leaves are the model's, less the gains (||V||)
    cfg = small_cfg()
    gains = {f"{name}/g" for name in ban.layer_shapes(cfg)}
    assert set(ref.param_shapes(SMALL)) | gains == set(flat(ban.init_params(
        cfg, torch.Generator())))
    assert not gains & set(ref.param_shapes(SMALL))


def test_eval_logits_match_the_reference_at_f32():
    """f32 on both sides: only the order of the sums differs (F.linear's
    addmm against matmul and add, the map as one product a sample): 1e-4
    on logits of a few units."""
    cfg = small_cfg()
    tree = params_for()
    img, ques = inputs()
    with torch.no_grad():
        got = model_for(cfg, tree)(img, ques)
        want = ref.forward(flat(tree), img, ques, SMALL)
    assert got.dtype == torch.float32 and got.shape == (N, ANSWERS)
    assert float(want.abs().max()) > 1.0
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_eval_logits_match_the_reference_at_bf16():
    """bf16 activations (every projection's output, the GRU's state, the
    scaled words and the map in bf16; the map's softmax and the pools' sums
    f32): logits within a twentieth of the largest of the f32 reference's,
    at these weights about eight bf16 roundings (2^-8 each) compounded
    through the 14 products of the forward."""
    cfg = small_cfg(compute_dtype="bfloat16")
    tree = params_for()
    img, ques = inputs()
    with torch.no_grad():
        got = model_for(cfg, tree)(img, ques)
        want = ref.forward(flat(tree), img, ques, SMALL)
    err = float((got - want).abs().max())
    assert got.dtype == torch.float32
    assert err < float(want.abs().max()) / 20


def test_attention_map_twin_is_ban_vqas_einsum_with_masked_cells():
    """The op on a CPU tensor (the composed map) against ban-vqa's
    ``einsum('xhyk,bvk,bqk->bhvq') + h_bias``, masked cells at -inf and the
    softmax over all (cell, word) pairs of a glimpse, in f32: the order of
    sums alone (1e-6; the maps are peaked, their largest value 20 times
    the uniform map's). A masked cell gets exactly 0 and each glimpse sums
    to 1."""
    av, aq, h, hb, mask = cc.n3_inputs(3, 5, "cpu", l=L, t=T, g=4, k=192)
    av, aq = av.float(), aq.float()
    mask[1, 50:90] = True
    got = ban_attention.attention_map(av, aq, h, hb, mask)
    s = torch.einsum("hk,bvk,bqk->bhvq", h, av, aq) + hb[None, :, None, None]
    s = s.masked_fill(mask[:, None, :, None], float("-inf"))
    want = torch.softmax(s.reshape(3, 4, -1), -1).reshape(s.shape)
    assert got.shape == (3, 4, L, T) and float(want.max()) > 20 / (L * T)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    assert (got.permute(0, 2, 1, 3)[mask] == 0).all()
    torch.testing.assert_close(got.sum((2, 3)), torch.ones(3, 4))


def test_h_bias_moves_no_map():
    """h_bias shifts each glimpse's scores by one constant, which the joint
    softmax cancels: the map without it is the map with it, to f32
    rounding (the kernel leaves it out)."""
    av, aq, h, hb, mask = cc.n3_inputs(2, 6, "cpu", l=L, t=T, g=3, k=192)
    av, aq = av.float(), aq.float()
    with_bias = ban_attention.attention_map_composed(av, aq, h, 3 * hb, mask)
    without = ban_attention.attention_map_composed(
        av, aq, h, torch.zeros_like(hb), mask)
    torch.testing.assert_close(with_bias, without, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [dict(l=20, t=10, g=8, k=64),
                                   dict(l=23, t=22, g=6, k=128)])
def test_n3_tolerance_takes_the_exact_map_and_rejects_each_control(shape):
    """``card_cases.n3_within`` takes the map at N3's rounding points
    rounded once to bf16 (what an exact kernel writes), and rejects each
    control of ``n3_controls``: the mask ignored, each glimpse's max per
    word (wrong off the peaks alone), and the glimpse that straddles the
    first two warpgroups' rows normalised per warpgroup."""
    av, aq, h, hb, mask = cc.n3_inputs(4, 7, "cpu", **shape)
    mask[:, :3] = True
    exact = cc.n3_exact(av, aq, h, hb, mask)
    assert cc.n3_within(exact.to(torch.bfloat16), exact)
    controls = cc.n3_controls(av, aq, h, hb, mask)
    assert set(controls) == {"mask_ignored", "row_max", "warpgroup_sum"}
    for name, got in controls.items():
        assert not cc.n3_within(got, exact), name


def test_the_map_dispatches_to_n3_in_bf16_eval_only(monkeypatch):
    """In eval at bf16 the forward calls the op (N3 on the card) once;
    under ``VQA_DISABLE_PALLAS``, with ``reference_kernels``, at f32 and in
    training it runs the composed map and never reaches the op."""
    calls = []
    real = ban_attention.attention_map

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(ban_attention, "attention_map", counted)
    monkeypatch.delenv("VQA_DISABLE_PALLAS", raising=False)
    tree = params_for()
    img, ques = inputs()
    bf16 = model_for(small_cfg(compute_dtype="bfloat16"), tree)
    with torch.no_grad():
        fused = bf16(img, ques)
        assert len(calls) == 1
        composed = bf16(img, ques, reference_kernels=True)
        model_for(small_cfg(), tree)(img, ques)
        bf16(img, ques, train=True, generator=torch.Generator())
        monkeypatch.setenv("VQA_DISABLE_PALLAS", "1")
        bf16(img, ques)
    assert len(calls) == 1
    # on the CPU the op is the composed map: the same logits
    assert torch.equal(fused, composed)


def test_weights_formed_once_equal_the_weights_formed_in_a_forward():
    """The ``folded_*`` buffers ``prepare`` forms at load are, bit for bit,
    what a forward forms from (g, V); a parameter written in place makes
    the next eval forward form them again (its logits a fresh model's)."""
    cfg = small_cfg()
    tree = params_for()
    model = model_for(cfg, tree)
    with torch.no_grad():
        formed = model._form()
    buffers = dict(model.named_buffers())
    assert set(formed) == {k[len("folded_"):] for k in buffers}
    for key, value in formed.items():
        assert torch.equal(buffers[f"folded_{key}"], value), key
    # g of weight_norm(dim=None) is one scalar: W = g V / ||V||_F (to f32
    # rounding: the product's order differs)
    layer = model.q_prj1
    w = layer.weight_g * layer.weight_v / layer.weight_v.norm()
    torch.testing.assert_close(formed["q_prj1_w"], w, atol=0, rtol=1e-6)
    img, ques = inputs()
    with torch.no_grad():
        before = model(img, ques)
        model.q_prj1.weight_g.mul_(1.5)
        after = model(img, ques)
    tree["q_prj1"]["g"] = tree["q_prj1"]["g"] * 1.5
    with torch.no_grad():
        fresh = model_for(cfg, tree)(img, ques)
    assert torch.equal(after, fresh)
    assert float((after - before).abs().max()) > 1e-3


def test_a_tree_without_gains_loads_each_as_its_directions_norm():
    """The benchmark's tree has no ``g``: the loader gives each layer
    ``weight_norm``'s first gain, ||V||_F, so the weight is V, and the port
    holds to the reference on it (which forms the same gain), at f32 as
    ``test_eval_logits_match_the_reference_at_f32``; a tree with another
    leaf left out still raises."""
    cfg = small_cfg()
    tree = params_for(gain=None)
    assert not any("g" in leaves for leaves in tree.values())
    model = model_for(cfg, tree)
    for name in ban.layer_shapes(cfg):
        layer = getattr(model, name)
        torch.testing.assert_close(layer.weight_g,
                                   layer.weight_v.double().norm().float(),
                                   atol=0, rtol=1e-6)
        torch.testing.assert_close(
            weight_norm(layer.weight_g, layer.weight_v), layer.weight_v,
            atol=0, rtol=1e-6)
    img, ques = inputs()
    with torch.no_grad():
        got = model(img, ques)
        want = ref.forward(flat(tree), img, ques, SMALL)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    del tree["q_prj0"]["b"]
    with pytest.raises(ValueError, match="missing"):
        model_for(cfg, tree)


def _swap_glimpses(tree, a, b):
    """The tree with glimpses a and b exchanged whole: h_mat's rows (its
    [kH, G] columns) and h_bias, b_net and q_prj."""
    out = {k: dict(v) for k, v in tree.items()}
    h = out["v_att_h"]
    for leaf, axis in (("v", 1), ("b", 0)):
        x = np.array(h[leaf])
        idx = list(range(x.shape[axis]))
        idx[a], idx[b] = b, a
        h[leaf] = np.take(x, idx, axis=axis)
    for name in ("b_net{}_v_net", "b_net{}_q_net", "q_prj{}"):
        out[name.format(a)], out[name.format(b)] = (tree[name.format(b)],
                                                    tree[name.format(a)])
    return out


def test_the_glimpses_run_in_series():
    """Each glimpse reads the Q its predecessor left: with glimpses 0 and 1
    exchanged whole, each still pools with its own map and weights, and
    only the order differs (summed in parallel, the logits would not
    move); the logits move, in the port as in the reference."""
    cfg = small_cfg()
    tree = params_for()
    swapped = _swap_glimpses(tree, 0, 1)
    img, ques = inputs()
    with torch.no_grad():
        got = model_for(cfg, tree)(img, ques)
        other = model_for(cfg, swapped)(img, ques)
        want = ref.forward(flat(swapped), img, ques, SMALL)
    torch.testing.assert_close(other, want, atol=1e-4, rtol=1e-4)
    assert float((other - got).abs().max()) > 1e-2


def test_the_forward_records_its_four_spans():
    """Under a profiler the eager forward records ``ban.question``,
    ``ban.attention``, ``ban.glimpses`` and ``ban.head``, one after
    another; without one, nothing."""
    from torch.profiler import ProfilerActivity, profile

    from vqa_attention_networks_tpu_torch.utils import trace

    cfg = small_cfg(att_num=1)
    model = model_for(cfg, params_for({"att_num": 1}))
    img, ques = inputs()
    trace.reset()
    try:
        with torch.no_grad():
            model(img, ques)
            assert trace.spans() == []
            with profile(activities=[ProfilerActivity.CPU]):
                model(img, ques)
        got = trace.spans()
        assert [sp.name for sp in got] == ["ban.question", "ban.attention",
                                           "ban.glimpses", "ban.head"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))
    finally:
        trace.reset()


def _soft():
    soft = torch.zeros(N, ANSWERS)
    soft[0, 3], soft[0, 5] = 0.7, 0.3
    soft[1, 2] = 1.0
    soft[2, 7], soft[2, 1], soft[2, 4] = 0.5, 0.4, 0.1
    return soft, torch.tensor([10, 10, 10])


def test_training_loss_and_every_gradient_match_with_dropout_on():
    """f32, ban-vqa's dropouts on, the masks drawn from one generator in the
    reference's order: the summed BCE over VQA scores within 1e-4
    relative, and each leaf's gradient within 1e-4 of its largest
    magnitude (summation order only). The frozen table takes none; h_bias
    gets round-off alone (the joint softmax cancels it), under a millionth
    of the median leaf's in both; word 0's rows get exactly 0."""
    cfg = small_cfg()
    tree = params_for()
    img, ques = inputs()
    soft, soft_n = _soft()
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
    with torch.no_grad():  # the dropout acted
        plain = ref.loss(ref.forward(flat(tree), img, ques, SMALL), soft,
                         soft_n)
    assert abs(float(plain) - float(want.detach())) > 1e-3
    leaves = _module_leaves(model)
    assert leaves["w_emb_frozen/table"][0].grad is None
    assert float(leaves["w_emb/table"][0].grad[0].abs().max()) == 0.0
    scales = {k: float(p[k].grad.abs().max()) for k in p
              if k != "w_emb_frozen/table"}
    floor = 1e-3 * float(np.median(list(scales.values())))
    assert {k for k, v in scales.items() if v < 1e-3 * floor} == \
        {"v_att_h/b"}
    for k in scales:
        t, transpose = leaves[k]
        g = t.grad.t() if transpose else t.grad
        if k == "v_att_h/b":  # round-off in the port too
            assert float(g.abs().max()) < 1e-3 * floor
        else:
            assert float((g - p[k].grad).abs().max()) <= 1e-4 * scales[k], k


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


def test_the_solver_trains_ban(data):
    """bf16, dropout on: two steps of ``train()`` with finite losses; the
    weights move and the frozen table does not."""
    from vqa_attention_networks_tpu_torch.train.solver import Solver

    qa, store = data
    solver = Solver(solver_cfg(qa, compute_dtype="bfloat16"), qa, store,
                    device="cpu")
    model = solver.model
    before = model.classifier_fc2.weight_v.detach().clone()
    frozen = model.w_emb_frozen.weight.detach().clone()
    seen = []
    metrics = solver.train(on_step=lambda step, loss: seen.append(
        float(loss)))
    assert len(seen) == 2 and np.isfinite(seen).all()
    assert all(np.isfinite(v) for v in metrics.values())
    assert not torch.equal(model.classifier_fc2.weight_v, before)
    assert torch.equal(model.w_emb_frozen.weight, frozen)


def test_the_solvers_first_step_is_the_references(data):
    """f32, dropout on: the Solver's first step (its dropout generator
    seeded by ``step_randomness``) against the reference from the same
    weights, rows, scores and seed: the loss within 1e-5 relative, and by
    leaf Adam's first moment after the step, over (1 - beta1), within 1e-4
    of the reference gradient's norm (summation order)."""
    from vqa_attention_networks_tpu_torch.train.solver import (
        Solver,
        step_randomness,
    )

    qa, store = data
    cfg = solver_cfg(qa, shuffle=False)
    fields = {k: getattr(cfg, k) for k in SMALL}
    tree = params_for(fields)
    solver = Solver(cfg, qa, store, params=tree, device="cpu")
    batch = next(iter(solver.batches["train"].epoch()))
    seen = []
    loss_fn = solver._loss
    solver._loss = lambda *a, **k: seen.append(loss_fn(*a, **k)) or seen[-1]
    solver._train_step(batch)
    img = torch.from_numpy(batch.image_features.astype(np.float32))
    gen_seed, _ = step_randomness(cfg.seed + 1, 0)
    p = {k: v.requires_grad_() for k, v in flat(tree).items()}
    logits = ref.train_forward(p, img,
                               torch.from_numpy(batch.questions).long(),
                               fields, torch.Generator().manual_seed(gen_seed),
                               0)
    want = ref.loss(logits, torch.from_numpy(batch.soft_answers),
                    torch.from_numpy(batch.soft_n))
    want.backward()
    torch.testing.assert_close(seen[0], want, rtol=1e-5, atol=0)
    state = solver.optimizer.state
    leaves = _module_leaves(solver.model)
    assert leaves["w_emb_frozen/table"][0] not in state
    norms = {path: (float(state[t]["exp_avg"].norm()) / 0.1,
                    float(p[path].grad.norm()))
             for path, (t, _) in leaves.items()
             if path != "w_emb_frozen/table"}
    median = float(np.median([want_ for _, want_ in norms.values()]))
    for path, (got, want_) in norms.items():
        if path == "v_att_h/b":
            assert max(got, want_) < 1e-3 * median
        else:
            assert abs(got - want_) <= 1e-4 * want_, path


def test_the_solver_refuses_tensor_parallel_ban(data):
    from vqa_attention_networks_tpu_torch.train.solver import Solver

    qa, store = data
    with pytest.raises(ValueError, match="model_parallel=2: tensor "
                       "parallelism splits the MFB fusions' columns "
                       r"\(mfb_out\), and ban has none"):
        Solver(solver_cfg(qa, model_parallel=2), qa, store, device="cpu")


def test_export_serving_of_ban(tmp_path, monkeypatch):
    """bf16 (kH a multiple of 64): the exported graph calls N3's op once
    (``fast_path_traced``) and forms no weight (the formed weights are the
    program's inputs); the artifact serves the eager engine's answers bit
    for bit."""
    monkeypatch.delenv("VQA_DISABLE_PALLAS", raising=False)
    cfg = small_cfg(compute_dtype="bfloat16")
    tree = params_for()
    b = 4
    exported = aot.export_serving(cfg, tree, b, device="cpu")
    targets = [str(node.target) for node in exported.graph.nodes
               if node.op == "call_function"]
    assert targets.count("vqa.ban_attention.default") == 1
    assert not any("linalg_vector_norm" in t for t in targets)
    aot.save_serving_artifact(str(tmp_path / "aot"), cfg, tree, b,
                              device="cpu")
    meta = json.loads((tmp_path / "aot" / "serving.json").read_text())
    assert meta["fast_path_traced"] is True
    assert meta["kernel_ops"] == ["vqa.ban_attention.default"]
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


def test_serve_flops_by_hand():
    """T=2, L=3, D=4, H=2 (kH 6), E=1, G=2, A=5."""
    from port_bench.harness import load_module

    counts = load_module(ROOT / "port_bench" / "counts" / "ban8.py",
                         "counts.ban8")
    s = dict(max_question_length=2, img_feature_dim=3, img_feature_channel=4,
             hidden_dim=2, emb_dim=1, att_num=2, a_vocab_size=5)
    gru = 2 * 2 * (2 + 2) * 6
    att = 2 * 3 * 4 * 6 + 2 * 2 * 2 * 6
    att_map = 2 * 2 * 2 * 3 * 6
    glimpses = 2 * (2 * 3 * 4 * 2 + 2 * 2 * 2 * 2)
    pools, products, q_prj = 2 * 2 * 2 * 3 * 2, 2 * 2 * 2 * 2, 2 * 2 * 2 * 2
    classifier = 2 * 2 * 4 + 2 * 4 * 5
    total = (gru + att + att_map + glimpses + pools + products + q_prj
             + classifier)
    assert counts.serve_flops(s) == total
    assert counts.gemm(s, 3)["bf16"] == 3 * (total - att_map - products)
    assert counts.attention(s, 1) == {
        "bytes": 2 * (3 + 2) * 6 + 2 * 2 * 3 * 2 + 4 * 2 * 6 + 3,
        "bf16": att_map}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [dict(cc.N3_SHAPE),
                                   dict(cc.N3_DEFAULT_SHAPE),
                                   dict(l=37, t=5, g=3, k=128),
                                   dict(l=200, t=16, g=8, k=64),
                                   dict(l=53, t=17, g=2, k=192),
                                   dict(l=200, t=24, g=8, k=64)])
def test_n3_kernel_on_the_card(card, shape):
    """BAN-8's shape and the port's default widths (22 words, 6 glimpses:
    three warpgroups) at N = 256, and ragged ones (two warpgroups; three
    for 17 words, and at 192 rows): each entry within one bf16 ulp of the
    map at the kernel's own rounding points (``card_cases.n3_within``),
    one launch, bit-equal reruns; masked cells exactly 0; each control
    rejected. A shape past the kernel raises."""
    n = 256 if shape in (cc.N3_SHAPE, cc.N3_DEFAULT_SHAPE) else 5
    av, aq, h, hb, mask = cc.n3_inputs(n, 391, card, **shape)
    before = ban_attention.launch_count
    got = ban_attention.attention_map(av, aq, h, hb, mask)
    again = ban_attention.attention_map(av, aq, h, hb, mask)
    torch.cuda.synchronize()
    assert ban_attention.launch_count == before + 2
    exact = cc.n3_exact(av, aq, h, hb, mask)
    assert got.dtype == torch.bfloat16 and got.shape == exact.shape
    assert cc.n3_within(got, exact)
    assert torch.equal(got, again)
    assert (got.permute(0, 2, 1, 3)[mask] == 0).all()
    for name, control in cc.n3_controls(av, aq, h, hb, mask).items():
        assert not cc.n3_within(control, exact), name
    with pytest.raises(TypeError, match="bf16"):
        ban_attention.attention_map(av.float(), aq.float(), h, hb, mask)
    wide = torch.zeros(n, 25, av.shape[2], dtype=av.dtype, device=card)
    with pytest.raises(ValueError, match="at most"):
        ban_attention.attention_map(av, wide, h, hb, mask)


def test_banked_ban8_replays_bit_equal_to_the_eager_forward_on_the_card(card):
    """BAN-8 at its published widths (``port_bench/configs/ban8.json``,
    the benchmark's weights), served by id from the CUDA graph: each
    batch's top-k bit-equal to ``aot.serving_forward_banked`` called
    eagerly on the same bank and inputs (a full batch and a partial one),
    one capture, one replay a batch, N3 once a batch on the card."""
    from torch.profiler import ProfilerActivity, profile

    from vqa_attention_networks_tpu_torch.data.feature_store import (
        quantize_features,
    )

    fields = json.loads((ROOT / "port_bench" / "configs" / "ban8.json")
                        .read_text())["fields"]
    cfg = Config(**fields).validate()
    params = bench_inputs.tree(bench_inputs.weights(
        ref.param_shapes(fields), 26, card))
    batch, images = 64, 96
    engine = InferenceEngine(cfg, params, batch_size=batch, topk=5,
                             input_dtype="int8")
    feats = np.random.default_rng(4).standard_normal(
        (images, cfg.img_feature_dim, cfg.img_feature_channel),
        dtype=np.float32)
    rows, scale, _ = quantize_features(np.maximum(feats, 0))
    scale = scale.astype(np.float16)
    cache = engine.attach_feature_cache(images,
                                        lambda ids: (rows[ids], scale[ids]))
    rng = np.random.default_rng(5)
    items = []
    for k in (batch, 13):
        qlen = rng.integers(3, cfg.max_question_length + 1, k)
        ques = rng.integers(1, cfg.q_vocab_size,
                            (k, cfg.max_question_length)).astype(np.int32)
        ques[np.arange(cfg.max_question_length)[None, :] >= qlen[:, None]] = 0
        items.append((rng.integers(0, images, k).tolist(), ques,
                      qlen.astype(np.int32)))
    list(engine.predict_stream_by_id(iter(items)))  # bank and capture
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = list(engine.predict_stream_by_id(iter(items)))
        torch.cuda.synchronize()
    launches = sum(e.name.startswith("ban_attention_kernel")
                   or "ban_attention_kernel" in e.name
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    graph = engine._graph
    assert graph.captures == 1 and graph.replays == 4
    assert launches == len(items)
    fwd = aot.serving_forward_banked(engine.cfg, engine.topk)
    for (ids, ques, qlen), preds in zip(items, got):
        idx, n = engine._pad(np.array([cache._slot[int(i)] for i in ids],
                                      np.int64))
        args = engine._to_device([idx, *engine._question_args(ques, qlen)])
        with torch.inference_mode():
            top_i, top_p = fwd(engine.model, cache.rows, cache.scale, *args)
        want = engine._collect([TopK(top_i, top_p)], n)
        assert len(preds) == len(want) == len(ids)
        for a, b in zip(preds, want):
            np.testing.assert_array_equal(a.top_ids, b.top_ids)
            np.testing.assert_array_equal(a.top_probs, b.top_probs)
