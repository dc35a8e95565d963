"""The port's data-parallel training (``vqa_attention_networks_tpu_torch/
parallel/``, ``train/solver.py`` under DDP) over 2 gloo CPU ranks
(``test_torch_port_parallel_ranks.py``, one spawn for every case),
against the JAX Solver on a 2-device mesh of the emulated CPU devices and
against one port process at the same global batch.

- f32, dropout 0, one set of weights through the carrier: ``mhb_coAtt`` at
  the pre-pool and the pooled site, and iBOWIMG (batch norm), 3 steps of
  batch 16 whose last is padded with all its valid rows on rank 0. The
  per-step losses hold JAX's at rtol 1e-5 and the parameters after the 3
  Adam steps JAX's at rtol 5e-5 (JAX's own multi-process test holds its
  losses and gradients so, ``tests/test_multiprocess.py:68-103``). The
  padded step's loss is JAX's global mean, which the mean of the two
  ranks' own means is not (Queue 3's unequal valid counts).
- Dropout on, against one process: bf16 ``mhb_coAtt`` at the pre-pool site
  (K2's plain version) and f32 with the composed chain. K2's mask and every
  composed mask of rank r are bit-equal to rows ``[r*B/2, (r+1)*B/2)`` of
  the one process's; at f32 the losses and parameters agree to f32
  summation order (rtol 1e-5, 5e-5).
- ``grad_accum_steps=2`` under 2 ranks against one process with the same
  accumulation: each rank's micro-batch i is its slice of the global
  micro-batch i; remat under 2 ranks bit-equal to the run without it.
- The replicated training bank under 2 ranks equals the host feed, losses
  and the full evaluation exactly (JAX ``test_device_bank_train.py:89``);
  so does the sharded bank, half the store on each rank.
- K1's layout after DDP's broadcast: rank 1 starts from other weights, and
  ``val()`` on both ranks gives one process's ``val()`` with rank 0's.
- A checkpoint written under 2 ranks: one ``step_<n>`` directory, restored
  on both ranks; the metric events written once, by rank 0.
- A mid-epoch resume under 2 ranks is bit-equal; early stopping ends both
  ranks after the epoch one process ends after.
- Every family trains two bf16 steps with dropout under 2 ranks.
"""

import json
import os

import jax
import numpy as np
import pytest

from test_torch_port_parallel_ranks import (
    flatten,
    result,
    run_case,
    run_ranks,
)
from vqa_attention_networks_tpu.config import Config as JaxConfig
from vqa_attention_networks_tpu.data import feature_store as jax_store
from vqa_attention_networks_tpu.data import prepare as jax_prepare
from vqa_attention_networks_tpu.parallel import make_mesh
from vqa_attention_networks_tpu.train.solver import Solver as JaxSolver
from vqa_attention_networks_tpu_torch.config import MODEL_NAMES, Config
from vqa_attention_networks_tpu_torch.data import feature_store as port_store
from vqa_attention_networks_tpu_torch.data import prepare as port_prepare

T = 7
WORLD = 2
BATCH = 16
# 40 rows at batch 16: the third batch's 8 valid rows are rank 0's
N_TRAIN, N_VAL = 40, 16
WIDTHS = dict(embed_size=16, att_num=2)
GRAD_ATOL = 2e-5  # of the model's largest gradient (``_hold``)

F32_CASES = {
    "f32_mhb_prepool": dict(model_name="mhb_coAtt"),
    "f32_mhb_pooled": dict(model_name="mhb_coAtt", dropout_site="pooled"),
    "f32_ibowimg": dict(model_name="iBOWIMG", dropout_default=0.0, **WIDTHS),
}


def cfg_fields(qa, **kw) -> dict:
    base = dict(
        model_name="mhb_coAtt", q_vocab_size=qa.q_vocab_size,
        a_vocab_size=qa.a_vocab_size, hidden_dim=16, emb_dim=8,
        img_feature_channel=32, max_question_length=T, mfb_factor=5,
        mfb_out=8, batch_size=BATCH, num_epoch=1, checkpoint_every_steps=0,
        prefetch_workers=1, dropout_lstm=0.0, dropout_fusion=0.0)
    base.update(kw)
    Config(**base).validate()
    return base


def _data(root, prepare, store_module):
    qa = prepare.make_synthetic_qa_data(np.random.default_rng(0),
                                        n_train=N_TRAIN, n_val=N_VAL,
                                        num_images=6, max_len=T)
    store = store_module.make_synthetic_feature_store(
        os.path.join(root, "feat"),
        sorted(set(qa.train.image_ids) | set(qa.val.image_ids)), channels=32)
    return qa, store


def _jax_params(fields) -> dict:
    solver_cfg = JaxConfig(**fields)
    from vqa_attention_networks_tpu.models import get_model

    params = get_model(solver_cfg.model_name).init(
        jax.random.PRNGKey(solver_cfg.seed), solver_cfg)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The workspace, every case's fields and weights, and one 2-rank run
    of all of them."""
    root = tmp_path_factory.mktemp("parallel")
    qa, store = _data(str(root / "port"), port_prepare, port_store)
    port_prepare.save_qa_data(qa, str(root / "qa"))
    int8 = str(root / "port" / "feat_q")
    port_store.quantize_store(str(root / "port" / "feat"), int8)
    out = root / "out"
    out.mkdir()
    cases = []

    def case(name, fields, params_seed=None, **kw):
        c = dict(name=name, cfg=fields, **kw)
        if params_seed is not None:
            path = str(root / f"{name}_params.npz")
            np.savez(path, **flatten(_jax_params(
                dict(fields, seed=params_seed))))
            c["params"] = path
        cases.append(c)
        return c

    for name, kw in F32_CASES.items():
        case(name, cfg_fields(qa, **kw), params_seed=0, steps=3)
    case("dropout_k2", cfg_fields(qa, compute_dtype="bfloat16",
                                  dropout_fusion=0.1, dropout_lstm=0.3),
         steps=1, masks=True)
    case("dropout_f32", cfg_fields(qa, dropout_fusion=0.1, dropout_lstm=0.3),
         steps=3, masks=True)
    case("remat", cfg_fields(qa, dropout_fusion=0.1, dropout_lstm=0.3,
                             remat=True), steps=3)
    case("accum", cfg_fields(qa, dropout_fusion=0.1, dropout_lstm=0.3,
                             grad_accum_steps=2), steps=3)
    bank = cfg_fields(qa, model_name="iBOWIMG", **WIDTHS)
    case("host", bank, train=True, val="full", store=int8)
    case("bank", dict(bank, device_feature_bank=True), train=True,
         val="full", store=int8)
    layout = case("layout", cfg_fields(qa, compute_dtype="bfloat16"),
                  params_seed=0, val_first=True)
    other = str(root / "layout_other.npz")
    np.savez(other, **flatten(_jax_params(dict(layout["cfg"], seed=7))))
    layout["params_rank1"] = other
    case("bank_shard", dict(bank, device_feature_bank=True,
                            device_feature_bank_shard=True), train=True,
         val="full", store=int8)
    case("ckpt", cfg_fields(qa, model_name="iBOWIMG", out_dir=str(
        root / "models"), **WIDTHS), train=True, checkpoint=True,
         log_dir=str(root / "runs"))
    case("resume", cfg_fields(qa, dropout_fusion=0.1, dropout_lstm=0.3,
                              compute_dtype="bfloat16",
                              checkpoint_every_steps=2, num_epoch=2,
                              out_dir=str(root / "resume_models")),
         train=True, resume_step=4)
    case("early", cfg_fields(qa, model_name="iBOWIMG", early_stopping=True,
                             patience=1, num_epoch=4, lr=0.05, **WIDTHS),
         train=True)
    for name in MODEL_NAMES:
        case(f"family_{name}", cfg_fields(
            qa, model_name=name, compute_dtype="bfloat16", dropout_lstm=0.3,
            dropout_fusion=0.1, **WIDTHS), steps=2)
    spec = dict(qa=str(root / "qa"), store=str(root / "port" / "feat"),
                out=str(out),
                cases=cases)
    run_ranks(spec, WORLD, root)
    return dict(root=root, qa=qa, store=store, out=str(out),
                cases={c["name"]: c for c in cases})


def _one_process(spawned, name, **over):
    """The case in this process, without a process group."""
    return run_case(dict(spawned["cases"][name], **over), spawned["qa"],
                    spawned["store"])


def _ranks(spawned, name):
    return [result(spawned["out"], name, r) for r in range(WORLD)]


def _params(arrays, prefix="p/"):
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _jax_run(tmp_path, fields, params_path, steps=3):
    """The JAX Solver on a 2-device mesh of the emulated CPU devices: the
    per-step losses and the parameters after ``steps`` steps."""
    from test_torch_port_parallel_ranks import unflatten

    qa, store = _data(str(tmp_path / "jax"), jax_prepare, jax_store)
    solver = JaxSolver(JaxConfig(**fields), qa, store,
                       mesh=make_mesh(data=WORLD, model=1),
                       log_dir=str(tmp_path / "runs"))
    with np.load(params_path) as f:
        from vqa_attention_networks_tpu.parallel import shard_params

        solver.params = shard_params(solver.mesh, jax.tree_util.tree_map(
            np.asarray, unflatten(dict(f))), None)
    losses, grads = [], None
    for i, batch in enumerate(solver.batches["train"].epoch(0)):
        if i == steps:
            break
        dev = solver._device_batch(batch)
        key = jax.random.fold_in(solver._rng_base, solver.step)
        if i == 0:
            grads = _jax_grads(solver, dev, key)
        solver.params, solver.opt_state, loss, _ = solver._train_step(
            solver.params, solver.opt_state, *dev, key)
        solver.step += 1
        losses.append(float(loss))
    return np.asarray(losses), grads, flatten(jax.tree_util.tree_map(
        np.asarray, solver.params))


def _jax_grads(solver, dev, key):
    """The gradients of the JAX Solver's training loss at its parameters,
    over the mesh's sharded batch (its ``_train_step_fn``'s ``grad_one``)."""
    img, ques, answers, qlen, valid, soft = dev

    def loss_fn(p):
        logits, _ = solver.model.apply(p, solver.cfg, img, ques,
                                       ques_length=qlen, train=True, rng=key,
                                       valid=valid)
        return solver._loss(logits, answers, soft, valid)

    return flatten(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(solver.params)))


def _hold(got, want_losses, want_grads, want_params):
    """Per-step losses at rtol 1e-5; the first step's gradients, element
    by element, at rtol 5e-5 plus GRAD_ATOL of the model's largest (a
    gradient that is 0 up to rounding, as the bias before a batch norm's,
    is summation noise of its terms); and the parameters after the steps
    by JAX's multi-process fingerprint, the sum of every |p|, at rtol 5e-5.
    Adam's first steps are near sign(g) * lr whatever |g|, so a gradient of
    noise moves its parameter by up to lr in either package: element by
    element, the parameters are not held tighter than that."""
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    grads = _params(got, "g/")
    assert grads.keys() == want_grads.keys()
    atol = GRAD_ATOL * max(np.abs(g).max() for g in want_grads.values())
    for key, want in want_grads.items():
        np.testing.assert_allclose(grads[key], want, rtol=5e-5, atol=atol,
                                   err_msg=key)
    params = _params(got)
    assert params.keys() == want_params.keys()
    np.testing.assert_allclose(_fingerprint(params),
                               _fingerprint(want_params), rtol=5e-5)


def _fingerprint(params) -> float:
    return float(sum(np.abs(v.astype(np.float64)).sum()
                     for v in params.values()))


@pytest.mark.parametrize("name", list(F32_CASES))
def test_two_ranks_match_jax_on_a_two_device_mesh(spawned, tmp_path, name):
    c = spawned["cases"][name]
    want_losses, want_grads, want_params = _jax_run(tmp_path, c["cfg"],
                                                    c["params"])
    ranks = _ranks(spawned, name)
    for got in ranks:
        _hold(got, want_losses, want_grads, want_params)
    # the ranks hold one model
    for key, value in _params(ranks[0]).items():
        np.testing.assert_array_equal(_params(ranks[1])[key], value)


def test_padded_batch_loss_is_the_global_mean(spawned, tmp_path):
    """The third batch's valid rows are all rank 0's: its loss is JAX's
    mean over the global batch's valid rows; the mean of the two ranks'
    own means (rank 1's 0) is half of it, which the port does not give."""
    assert N_TRAIN % BATCH <= BATCH // WORLD
    c = spawned["cases"]["f32_mhb_prepool"]
    want, _, _ = _jax_run(tmp_path, c["cfg"], c["params"])
    got = _ranks(spawned, "f32_mhb_prepool")[0]["losses"]
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
    mean_of_means = (want[2] + 0.0) / WORLD
    assert abs(got[2] - mean_of_means) > 1e3 * 1e-5 * abs(want[2])


def _masks(arrays, kind):
    return [arrays[k] for k in sorted(
        (k for k in arrays if k.startswith(kind + "_")),
        key=lambda k: int(k.split("_")[-1]))]


@pytest.mark.parametrize("name", ["dropout_k2", "dropout_f32"])
def test_two_ranks_draw_the_masks_of_one_process(spawned, name):
    one = _one_process(spawned, name)
    ranks = _ranks(spawned, name)
    kinds = ("k2", "dropout") if name == "dropout_k2" else ("dropout",)
    for kind in kinds:
        whole = _masks(one, kind)
        assert whole, kind
        for r, got in enumerate(ranks):
            parts = _masks(got, kind)
            assert len(parts) == len(whole), kind
            for i, (part, full) in enumerate(zip(parts, whole)):
                rows = full.shape[0] // WORLD
                np.testing.assert_array_equal(
                    part, full[r * rows:(r + 1) * rows],
                    err_msg=f"{kind} mask {i}, rank {r}")
                # the control: rank 1's rows are not rank 0's
                assert not np.array_equal(full[:rows], full[rows:2 * rows])
    for got in ranks:
        if name == "dropout_f32":
            _hold(got, one["losses"], _params(one, "g/"), _params(one))
        else:  # bf16: one step, its loss summed in another order
            np.testing.assert_allclose(got["losses"], one["losses"],
                                       rtol=1e-5)


def test_remat_under_two_ranks_is_bit_equal(spawned):
    """Remat's checkpoint sits inside the module DDP wraps (non-reentrant):
    under 2 ranks it recomputes the same masks and gives ``dropout_f32``'s
    losses and parameters bit for bit."""
    for got, want in zip(_ranks(spawned, "remat"),
                         _ranks(spawned, "dropout_f32")):
        np.testing.assert_array_equal(got["losses"], want["losses"])
        for key, value in _params(want).items():
            np.testing.assert_array_equal(_params(got)[key], value)


def test_gradient_accumulation_under_two_ranks(spawned):
    one = _one_process(spawned, "accum")
    for got in _ranks(spawned, "accum"):
        _hold(got, one["losses"], _params(one, "g/"), _params(one))


def test_replicated_bank_equals_the_host_feed_under_two_ranks(spawned):
    for host, bank in zip(_ranks(spawned, "host"), _ranks(spawned, "bank")):
        np.testing.assert_array_equal(bank["losses"], host["losses"])
        np.testing.assert_array_equal(bank["val"], host["val"])
        for key, value in _params(host).items():
            np.testing.assert_array_equal(_params(bank)[key], value)


def test_a_mid_epoch_resume_under_two_ranks_is_bit_equal(spawned):
    """bf16 with dropout, 2 epochs of 3 steps, a checkpoint every 2: both
    ranks restore step 4 (mid-epoch, written once by rank 0) and train to
    the end with the same losses and parameters, bit for bit."""
    for got in _ranks(spawned, "resume"):
        assert len(got["losses"]) == 6
        np.testing.assert_array_equal(got["resumed_losses"],
                                      got["losses"][4:])
        for key, value in _params(got).items():
            np.testing.assert_array_equal(_params(got, "q/")[key], value)
    assert sorted(os.listdir(spawned["root"] / "resume_models" /
                             "mhb_coAtt")) == ["step_2", "step_4", "step_6"]


def test_early_stopping_ends_every_rank_at_one_epoch(spawned):
    """The decision reads the gathered validation figures: every rank
    stops after the same epoch, as one process does."""
    one = _one_process(spawned, "early")
    ranks = _ranks(spawned, "early")
    assert len(one["losses"]) < 4 * 3  # it stopped early
    for got in ranks:
        assert len(got["losses"]) == len(one["losses"])
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_every_family_trains_under_two_ranks(spawned, name):
    """bf16, dropout on, 2 steps: finite losses, one model on both ranks
    (mfb's stage-1 fusion, gradient-dead under its reference quirk, leaves
    parameters no step uses, which DDP is told to look for)."""
    ranks = _ranks(spawned, f"family_{name}")
    for got in ranks:
        assert np.isfinite(got["losses"]).all() and len(got["losses"]) == 2
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    for key, value in _params(ranks[0]).items():
        np.testing.assert_array_equal(_params(ranks[1])[key], value)


def test_sharded_bank_under_two_ranks_names_item_10b(spawned):
    """The sharded training bank (its ring exchange, ROADMAP Queue 1 item
    10b, which it waited for until it was ported) over two ranks: each
    rank holds half the store's rows, and the losses, the full evaluation
    and the parameters equal the host feed's, bit for bit."""
    for host, bank in zip(_ranks(spawned, "host"),
                          _ranks(spawned, "bank_shard")):
        np.testing.assert_array_equal(bank["losses"], host["losses"])
        np.testing.assert_array_equal(bank["val"], host["val"])
        for key, value in _params(host).items():
            np.testing.assert_array_equal(_params(bank)[key], value)
    shard, whole = (_ranks(spawned, name)[0]["bank_bytes"]
                    for name in ("bank_shard", "bank"))
    assert 2 * shard == whole


def test_k1_layout_follows_the_broadcast_weights(spawned):
    """Rank 1 built its model, and K1's layout, from other weights; DDP's
    broadcast of rank 0's and the layout made again after it give both
    ranks one process's ``val()`` with rank 0's weights."""
    one = _one_process(spawned, "layout")
    for got in _ranks(spawned, "layout"):
        np.testing.assert_allclose(got["val_first"], one["val_first"],
                                   rtol=1e-5)
    other = _one_process(spawned, "layout",
                         params=spawned["cases"]["layout"]["params_rank1"])
    assert not np.allclose(other["val_first"], one["val_first"], rtol=1e-5)


def test_checkpoint_and_events_under_two_ranks(spawned):
    root = spawned["root"]
    ranks = _ranks(spawned, "ckpt")
    steps = sorted(os.listdir(root / "models" / "iBOWIMG"))
    assert steps == [f"step_{int(ranks[0]['restored_step'])}"]
    for got in ranks:
        for key, value in _params(got).items():
            np.testing.assert_array_equal(_params(got, "r/")[key], value)
    with open(root / "runs" / "iBOWIMG" / "events.jsonl") as f:
        records = [json.loads(line) for line in f]
    # one epoch: loss, acc and qa-pairs/s, written once
    assert len(records) == 3, records
    assert {r["tag"] for r in records} == {
        "iBOWIMG/loss", "iBOWIMG/acc", "iBOWIMG/qa_pairs_per_sec"}
