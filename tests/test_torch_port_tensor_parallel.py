"""The port's tensor parallelism (``parallel/tensor.py``,
``parallel/sharding.py``, the Solver over a ``(data, model)`` mesh) over 4
gloo CPU ranks at mesh (2, 2) (``test_torch_port_parallel_ranks.py``, one
spawn for every case), against the JAX Solver on a (2, 2) mesh of the
emulated CPU devices and against one port process.

- f32, dropout 0, one set of weights through the carrier: mhb_coAtt at the
  pre-pool and the pooled site, mfb (quirks off), MHB and iBOWIMG (no
  fusion projection: replicated on the model axis), 3 steps of batch 16.
  The losses hold JAX's at rtol 1e-5, the first step's gradients (gathered
  from the shards) at rtol 5e-5 plus ``GRAD_ATOL``, the parameters after
  the steps JAX's fingerprint at rtol 5e-5 (``test_torch_port_parallel.
  _hold``); mfb's gradients, which one port process does not hold to
  JAX's so (a signed sqrt near 0), hold one port process's. The 4 ranks
  hold one model, bit for bit.
- Placement: the fusion projections' weights and biases, by name and
  width as JAX's ``_leaf_spec``, split on the port's dim 0 (JAX's last),
  each rank holding its rows; everything else whole.
- The bf16 eval forward under TP (K1's plain version on the gathered
  weights) equals one process's, and JAX's on its (2, 2) mesh at
  ``test_sharding.py:71-104``'s tolerance.
- Dropout on: each rank's K2 mask (its plain version, at the rank's
  ``row0`` and ``col0``) and every composed mask are the (rows, columns)
  block of the one process's; the f32 runs hold the one process's.
- Remat with ``grad_accum_steps=2`` under TP holds one process's.
- ``val(full=True)`` before a step writes the one process's files; after
  a step it gives what one process gives on the gathered weights (K1's
  layout made again from the changed shards).
- A checkpoint under TP resumes mid-epoch bit-equal and restores in one
  process; a one-process checkpoint restores under TP.
"""

import json
import os

import jax
import numpy as np
import pytest

from test_torch_port_parallel import (
    _data,
    _fingerprint,
    _hold,
    _jax_grads,
    _jax_params,
    _masks,
    _params,
    cfg_fields,
)
from test_torch_port_parallel_ranks import (
    flatten,
    result,
    run_case,
    run_ranks,
    unflatten,
)
from vqa_attention_networks_tpu.config import Config as JaxConfig
from vqa_attention_networks_tpu.data import feature_store as jax_store
from vqa_attention_networks_tpu.data import prepare as jax_prepare
from vqa_attention_networks_tpu.models import get_model as jax_model
from vqa_attention_networks_tpu.parallel import make_mesh, shard_params
from vqa_attention_networks_tpu.parallel.sharding import (
    param_shardings as jax_param_shardings,
)
from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data import feature_store as port_store
from vqa_attention_networks_tpu_torch.data import prepare as port_prepare
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.parallel.sharding import (
    param_shardings,
)

WORLD, DATA, MODEL = 4, 2, 2
DROPOUT = dict(dropout_fusion=0.1, dropout_lstm=0.3)
F32_CASES = {
    "tp_mhb_prepool": dict(model_name="mhb_coAtt"),
    "tp_mhb_pooled": dict(model_name="mhb_coAtt", dropout_site="pooled"),
    "tp_mfb": dict(model_name="mfb", keep_reference_quirks=False),
    "tp_mhb": dict(model_name="mhb"),
    "tp_ibowimg": dict(model_name="iBOWIMG", embed_size=16,
                       dropout_default=0.0),
}
MASK_CASES = {
    "tp_masks_k2": dict(compute_dtype="bfloat16", **DROPOUT),
    "tp_masks_prepool": dict(**DROPOUT),
    "tp_masks_pooled": dict(dropout_site="pooled", **DROPOUT),
    "tp_masks_mhb": dict(model_name="mhb", **DROPOUT),
}


def tp_fields(qa, **kw) -> dict:
    return cfg_fields(qa, **dict(dict(model_parallel=MODEL), **kw))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    root = tmp_path_factory.mktemp("tensor_parallel")
    qa, store = _data(str(root / "port"), port_prepare, port_store)
    port_prepare.save_qa_data(qa, str(root / "qa"))
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
        case(name, tp_fields(qa, **kw), params_seed=0, steps=3,
             shapes=True)
    for name, kw in MASK_CASES.items():
        case(name, tp_fields(qa, **kw), steps=1 if "k2" in name else 3,
             masks=True)
    case("tp_remat_accum", tp_fields(qa, remat=True, grad_accum_steps=2,
                                     **DROPOUT), steps=3)
    eval_inputs = str(root / "eval_inputs.npz")
    rng = np.random.default_rng(3)
    np.savez(eval_inputs,
             img=rng.standard_normal((8, 196, 32)).astype(np.float16),
             ques=rng.integers(1, qa.q_vocab_size, (8, 7)).astype(np.int64))
    case("tp_eval", tp_fields(qa, compute_dtype="bfloat16"), params_seed=0,
         eval_inputs=eval_inputs)
    case("tp_val", tp_fields(qa, compute_dtype="bfloat16",
                             results_dir=str(root / "tp_val_results")),
         params_seed=0, val_first=True, steps=1, val="full")
    case("tp_resume", tp_fields(qa, compute_dtype="bfloat16",
                                checkpoint_every_steps=2, num_epoch=2,
                                out_dir=str(root / "resume_models"),
                                **DROPOUT),
         train=True, resume_step=4)
    # a checkpoint written by one process, restored under TP
    one_dir = str(root / "one_models")
    one = dict(name="tp_restore_one", cfg=tp_fields(
        qa, out_dir=one_dir, checkpoint_every_steps=3, **DROPOUT), steps=0,
        restore=True)
    run_case(dict(one, cfg=dict(one["cfg"], model_parallel=1), train=True,
                  restore=False), qa, store, out=str(root))
    os.rename(root / "tp_restore_one_rank0.npz", root / "one_written.npz")
    cases.append(one)
    spec = dict(qa=str(root / "qa"), store=str(root / "port" / "feat"),
                out=str(out), cases=cases)
    run_ranks(spec, WORLD, root)
    return dict(root=root, qa=qa, store=store, out=str(out),
                eval_inputs=eval_inputs, cases={c["name"]: c for c in cases})


def _ranks(spawned, name):
    return [result(spawned["out"], name, r) for r in range(WORLD)]


def _one_process(spawned, name, **over):
    c = spawned["cases"][name]
    return run_case(dict(c, cfg=dict(c["cfg"], model_parallel=1), **over),
                    spawned["qa"], spawned["store"])


def _one_model(ranks):
    """The ranks hold one model: every parameter, the replicated ones and
    the gathered shards, bit for bit."""
    for got in ranks[1:]:
        for key, value in _params(ranks[0]).items():
            np.testing.assert_array_equal(_params(got)[key], value,
                                          err_msg=key)


def _jax_run(tmp_path, fields, params_path, steps=3):
    """The JAX Solver on a (2, 2) mesh, the fusion projections split over
    'model': the losses, the first step's gradients, the parameters."""
    from vqa_attention_networks_tpu.train.solver import Solver as JaxSolver

    qa, store = _data(str(tmp_path / "jax"), jax_prepare, jax_store)
    cfg = JaxConfig(**fields)
    solver = JaxSolver(cfg, qa, store, mesh=make_mesh(data=DATA, model=MODEL),
                       log_dir=str(tmp_path / "runs"))
    with np.load(params_path) as f:
        solver.params = shard_params(solver.mesh, jax.tree_util.tree_map(
            np.asarray, unflatten(dict(f))), cfg.fusion_dim)
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


def _hold_but_gradients(got, want_losses, want_params):
    """``_hold``'s losses and parameter fingerprint."""
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    np.testing.assert_allclose(_fingerprint(_params(got)),
                               _fingerprint(want_params), rtol=5e-5)


@pytest.mark.parametrize("name", list(F32_CASES))
def test_four_ranks_match_jax_on_a_two_by_two_mesh(spawned, tmp_path, name):
    """mfb's f32 gradients carry a summation-order difference amplified by
    the signed sqrt near 0: one port process's stand 3.9e-3 from JAX's in
    relative norm on this data (ques_proj1/w), outside ``_hold``. So mfb's
    ranks hold JAX's losses and parameters, and one port process's
    gradients too, by ``_hold``."""
    c = spawned["cases"][name]
    want_losses, want_grads, want_params = _jax_run(tmp_path, c["cfg"],
                                                    c["params"])
    ranks = _ranks(spawned, name)
    one = _one_process(spawned, name) if name == "tp_mfb" else None
    for got in ranks:
        if one is None:
            _hold(got, want_losses, want_grads, want_params)
        else:
            _hold_but_gradients(got, want_losses, want_params)
            _hold(got, one["losses"], _params(one, "g/"), _params(one))
    _one_model(ranks)


def test_the_fusion_projections_are_split_as_jax_places_them(spawned):
    """``param_shardings`` names the leaves JAX's ``_leaf_spec`` splits
    over 'model' (on JAX's last dim, the port's dim 0) and no other; each
    rank holds its rows of them."""
    for name in ("tp_mhb_prepool", "tp_mfb", "tp_mhb", "tp_ibowimg"):
        fields = spawned["cases"][name]["cfg"]
        cfg = Config(**fields)
        model = get_model(cfg.model_name)(cfg)
        ours = param_shardings(model, cfg.fusion_dim)
        jcfg = JaxConfig(**fields)
        params = jax_model(jcfg.model_name).init(jax.random.PRNGKey(0), jcfg)
        theirs = flatten(jax.tree_util.tree_map(
            lambda s: np.asarray(s.spec[-1] == "model" if s.spec else False),
            jax_param_shardings(make_mesh(data=DATA, model=MODEL), params,
                                jcfg.fusion_dim)))
        split = {k for k, v in theirs.items() if bool(v)}
        ours_split = {k for k, v in ours.items() if v is not None}
        port_names = {n.rsplit(".", 1)[0].replace(".", "/") + "/" +
                      {"weight": "w", "bias": "b"}.get(n.rsplit(".", 1)[1],
                                                       n.rsplit(".", 1)[1])
                      for n in ours_split}
        assert port_names == split, name
        assert all(v == 0 for v in ours.values() if v is not None)
        if name == "tp_ibowimg":
            assert not split
        for got in _ranks(spawned, name):
            for n, p in model.named_parameters():
                want = list(p.shape)
                if ours[n] is not None:
                    want[0] //= MODEL
                np.testing.assert_array_equal(got[f"shape/{n}"], want,
                                              err_msg=n)


def test_the_eval_forward_under_tp_is_one_processes(spawned):
    """bf16 mhb_coAtt: the eval forward on the gathered weights equals one
    process's bit for bit (K1's plain version on the same weights), and
    JAX's on a (2, 2) mesh at ``test_sharding.py``'s bf16 tolerance."""
    c = spawned["cases"]["tp_eval"]
    one = _one_process(spawned, "tp_eval")
    for got in _ranks(spawned, "tp_eval"):
        np.testing.assert_array_equal(got["logits"], one["logits"])
    jcfg = JaxConfig(**c["cfg"])
    with np.load(c["params"]) as f:
        params = unflatten(dict(f))
    with np.load(spawned["eval_inputs"]) as f:
        img, ques = f["img"], f["ques"].astype(np.int32)
    mesh = make_mesh(data=DATA, model=MODEL)
    logits, _ = jax.jit(lambda p, i, q: jax_model("mhb_coAtt").apply(
        p, jcfg, i, q, train=False))(
        shard_params(mesh, params, jcfg.fusion_dim), img, ques)
    np.testing.assert_allclose(one["logits"], np.asarray(logits),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", list(MASK_CASES))
def test_each_rank_draws_its_block_of_one_processes_masks(spawned, name):
    """Rank r = (d, m) holds rows block d of the global batch and, for a
    column-sharded activation, columns block m: its K2 mask and each
    composed mask are that block of the one process's."""
    one = _one_process(spawned, name)
    ranks = _ranks(spawned, name)
    kinds = ("k2", "dropout") if name == "tp_masks_k2" else ("dropout",)
    for kind in kinds:
        whole = _masks(one, kind)
        assert whole, kind
        split = 0
        for r, got in enumerate(ranks):
            d, m = divmod(r, MODEL)
            parts = _masks(got, kind)
            assert len(parts) == len(whole), kind
            for i, (part, full) in enumerate(zip(parts, whole)):
                rows = full.shape[0] // DATA
                block = full[d * rows:(d + 1) * rows]
                if part.shape[-1] != full.shape[-1]:
                    cols = full.shape[-1] // MODEL
                    assert part.shape[-1] == cols
                    block = block[..., m * cols:(m + 1) * cols]
                    split += 1
                    # the control: column block 1 is not block 0
                    assert not np.array_equal(full[..., :cols],
                                              full[..., cols:2 * cols])
                np.testing.assert_array_equal(
                    part, block, err_msg=f"{kind} mask {i}, rank {r}")
        assert split, f"no {kind} mask of {name} is column-sharded"
    if name == "tp_masks_k2":  # bf16: one step, its loss in another order
        for got in ranks:
            np.testing.assert_allclose(got["losses"], one["losses"],
                                       rtol=1e-5)
    else:
        for got in ranks:
            _hold(got, one["losses"], _params(one, "g/"), _params(one))
    _one_model(ranks)


def test_remat_and_accumulation_under_tp_hold_one_process(spawned):
    one = _one_process(spawned, "tp_remat_accum")
    ranks = _ranks(spawned, "tp_remat_accum")
    for got in ranks:
        _hold(got, one["losses"], _params(one, "g/"), _params(one))
    _one_model(ranks)


def _files(results_dir):
    out = {}
    for name in ("mhb_coAtt.txt", "mhb_coAtt.json",
                 "mhb_coAtt_predictions.json"):
        with open(os.path.join(results_dir, name)) as f:
            out[name] = f.read()
    record = json.loads(out["mhb_coAtt.json"])
    record.pop("time")
    out["mhb_coAtt.json"] = record
    return out


def test_full_evaluation_under_tp(spawned, tmp_path):
    """Before a step every rank's ``val()`` is one process's; after a step
    ``val(full=True)`` gives, and writes, what one process gives on the
    gathered weights: K1's layout follows the changed shards."""
    ranks = _ranks(spawned, "tp_val")
    written = _files(spawned["root"] / "tp_val_results")
    one = _one_process(spawned, "tp_val", steps=0, val=None)
    for got in ranks:  # (loss, accuracy): the loss summed over 2 ranks
        np.testing.assert_allclose(got["val_first"], one["val_first"],
                                   rtol=1e-6)
        assert got["val_first"][1] == one["val_first"][1]
    params = str(tmp_path / "after.npz")
    np.savez(params, **{k[2:]: v for k, v in ranks[0].items()
                        if k.startswith("p/")})
    c = spawned["cases"]["tp_val"]
    after = run_case(dict(c, cfg=dict(c["cfg"], model_parallel=1,
                                      results_dir=str(tmp_path / "one")),
                          params=params, steps=0, val_first=False),
                     spawned["qa"], spawned["store"])
    for got in ranks:
        np.testing.assert_allclose(got["val"], after["val"], rtol=1e-6)
        assert got["val"][1] == after["val"][1]
    assert written == _files(tmp_path / "one")


def test_a_tp_checkpoint_resumes_and_restores_in_one_process(spawned):
    """bf16 with dropout, 2 epochs of 3 steps, a checkpoint every 2 (the
    full tensors, gathered, Adam's moments too): every rank restores step
    4 mid-epoch and trains to the end bit-equal; one process restores the
    last checkpoint as the ranks' gathered weights."""
    from vqa_attention_networks_tpu_torch.train.solver import Solver
    from vqa_attention_networks_tpu_torch.weights import to_jax_params

    ranks = _ranks(spawned, "tp_resume")
    for got in ranks:
        assert len(got["losses"]) == 6
        np.testing.assert_array_equal(got["resumed_losses"],
                                      got["losses"][4:])
        for key, value in _params(got).items():
            np.testing.assert_array_equal(_params(got, "q/")[key], value)
    _one_model(ranks)
    c = spawned["cases"]["tp_resume"]
    solver = Solver(Config(**dict(c["cfg"], model_parallel=1)),
                    spawned["qa"], spawned["store"], device="cpu")
    solver.restore(6)
    restored = flatten(to_jax_params(solver.model))
    for key, value in _params(ranks[0]).items():
        np.testing.assert_array_equal(restored[key], value, err_msg=key)


def test_a_one_process_checkpoint_restores_under_tp(spawned):
    with np.load(spawned["root"] / "one_written.npz") as f:
        one = dict(f)
    for got in _ranks(spawned, "tp_restore_one"):
        assert _params(got).keys() == _params(one).keys()
        for key, value in _params(one).items():
            np.testing.assert_array_equal(_params(got)[key], value)
    assert _fingerprint(_params(one)) > 0


# --------------------------------------------------------------------------
# the pieces, in this process
# --------------------------------------------------------------------------

def test_k2_mask_of_a_shard_is_its_columns_of_one_processes():
    """K2's plain mask at ``col0`` and ``f_total``: a rank's columns (and,
    with ``row0``, rows) of the one-process mask; at col0 = 0 and f_total
    = F the bits it always drew (``test_torch_port_train_fusion``'s
    sha256)."""
    import hashlib

    import torch

    from test_torch_port_train_fusion import MASK_ROW0_ZERO_DIGEST
    from vqa_attention_networks_tpu_torch.ops import train_fusion as tf

    mask = tf.dropout_mask(5, 4, 196, 520, 0.1, col0=0, f_total=520)
    assert hashlib.sha256(mask.numpy().tobytes()).hexdigest() == \
        MASK_ROW0_ZERO_DIGEST
    whole = tf.dropout_mask(9, 6, 11, 40, 0.3)
    for m in range(MODEL):
        for d in range(DATA):
            part = tf.dropout_mask(9, 3, 11, 20, 0.3, row0=3 * d,
                                   col0=20 * m, f_total=40)
            assert torch.equal(part, whole[3 * d:3 * d + 3,
                                           :, 20 * m:20 * m + 20])
    assert not torch.equal(tf.dropout_mask(9, 3, 11, 20, 0.3),
                           whole[:3, :, 20:])


def test_dropout_under_columns_is_a_block_of_one_processes():
    import torch

    from vqa_attention_networks_tpu_torch.models import layers
    from vqa_attention_networks_tpu_torch.parallel.tensor import (
        TensorParallel,
    )

    x = torch.ones(6, 5, 40)
    whole = layers.dropout(x, 0.4, True, torch.Generator().manual_seed(3))
    for m in range(MODEL):
        tp = TensorParallel(None, m, MODEL)
        rows = layers.GlobalRows(torch.Generator().manual_seed(3), 2, 6)
        part = layers.dropout(x[2:4, :, :20], 0.4, True,
                              layers.columns(rows, tp))
        assert torch.equal(part, whole[2:4, :, 20 * m:20 * m + 20])
        alone = layers.columns(torch.Generator().manual_seed(3), tp)
        assert layers.first_column(alone, 20) == (20 * m, 40)
        assert torch.equal(layers.dropout(x[:, :, :20], 0.4, True, alone),
                           whole[..., 20 * m:20 * m + 20])
    assert layers.columns(rows, None) is rows


@pytest.mark.parametrize("site", ["prepool", "pooled"])
def test_a_padded_shard_gives_the_unpadded_fusion(site):
    """K2's and K3's shard of 20 columns at k = 5 (F % 8 != 0, which the
    kernels refuse) zero-padded to 40 by ``on_padded_columns``, through
    the plain versions: the outputs of the unpadded call bit for bit, the
    mask at the shard's place, and its gradients to f32 summation order."""
    import torch

    from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
    from vqa_attention_networks_tpu_torch.ops import train_fusion as tf
    from vqa_attention_networks_tpu_torch.ops.fusion import (
        on_padded_columns,
    )

    g = torch.Generator().manual_seed(8)
    img = torch.randn(3, 9, 16, generator=g).to(torch.bfloat16)
    w, b, q = (torch.randn(*s, generator=g).requires_grad_(True)
               for s in ((16, 20), (20,), (3, 20)))
    cot = torch.randn(3, 9, 4, generator=g)
    if site == "prepool":
        def fuse(w_, b_, q_):
            return tf.train_grid_fuse_reference(img, w_, b_, q_, 4, 5, 0.3,
                                                1, 20, 40)
    else:
        def fuse(w_, b_, q_):
            return pf.pooled_grid_fuse_reference(img, w_, b_, q_, 5)
    widths = []
    got = on_padded_columns(lambda *a: widths.append(a[0].shape[1])
                            or fuse(*a), w, b, q, 5)
    assert widths == [40] and got.shape == (3, 9, 4)
    (got * cot).sum().backward()
    grads = [x.grad.clone() for x in (w, b, q)]
    for x in (w, b, q):
        x.grad = None
    want = fuse(w, b, q)
    (want * cot).sum().backward()
    assert torch.equal(got, want)
    # the gradients' f32 sums run over another width: their order may
    # move a last bit
    for a, x in zip(grads, (w, b, q)):
        torch.testing.assert_close(a, x.grad, rtol=1e-6, atol=1e-6)
