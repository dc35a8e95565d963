"""The Solver's switches (``vqa_attention_networks_tpu_torch/train/
solver.py``): gradient accumulation, remat, the int8 feed, the profiler
and the NaN trap, against their baselines and the JAX ``Solver``, on the
CPU. (The device feature bank: ``test_torch_port_device_bank_train.py``.)

- Gradient accumulation equals the manual average of the micro-batches'
  gradients, each drawn with its own randomness (``step_randomness(base,
  step, i)``): the accumulated ``.grad`` to f32 summation order (rtol
  1e-6, atol 1e-9), and with JAX's SGD(1.0) trick (the parameters' change
  under SGD at rate 1 is the gradient) at JAX's tolerance (rtol 1e-2, atol
  2e-6: the subtraction rounds at the parameters' magnitude).
- Against the JAX Solver at f32 with dropout 0 and ``grad_accum_steps=2``:
  the same per-step losses at ``test_torch_port_solver.py``'s rtol 1e-5,
  and the batch-norm running statistics after the epoch within that
  file's tolerances (``test_other_families_match_the_jax_solver``).
- The batch-norm EMA once per micro-batch in order, skipping a micro-batch
  of padding only: iBOWIMG's running statistics after one step against
  an f64 twin and against the JAX Solver's step (rtol 1e-4, JAX's).
- Remat is bit-equal with dropout on, mhb_coAtt at f32 and at bf16 at the
  pre-pool site (K2's plain version); a control whose dropout generator
  is not replayed in the recomputation fails the same comparison.
- A run resumed mid-epoch under ``grad_accum_steps=2`` is bit-equal to
  the straight run.
- The int8 feed's per-step losses equal the JAX Solver's int8 feed at
  rtol 1e-5 (the same int8 rows and scales, dequantised on the device).
- ``profile_steps`` writes a Chrome trace; ``debug_nans`` lets a sound
  step through and raises at the backward op a NaN weight poisons.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_port_checkpoint import _assert_bit_equal, _state
from test_torch_port_checkpoint import _cfg as ckpt_cfg
from test_torch_port_checkpoint import data as ckpt_data  # noqa: F401
from test_torch_port_solver import (  # noqa: F401
    BN_MOMENTUM,
    WIDTHS,
    _losses_match_the_jax_solver,
    data,
    jax_data,
    small_cfg,
)
from vqa_attention_networks_tpu.config import Config as JaxConfig
from vqa_attention_networks_tpu.data import feature_store as jax_store
from vqa_attention_networks_tpu.parallel import make_mesh
from vqa_attention_networks_tpu.train.solver import Solver as JaxSolver
from vqa_attention_networks_tpu_torch.data import feature_store as port_store
from vqa_attention_networks_tpu_torch.train.solver import (
    Solver,
    step_randomness,
)
from vqa_attention_networks_tpu_torch.weights import to_jax_params


def _first_batch(solver):
    return next(solver.batches["train"].epoch(0))


def _params(solver) -> dict:
    return {k: v.detach().clone() for k, v in
            solver.model.named_parameters()}


def _manual_grads(cfg, qa, store, batch, a, shared_seed=False):
    """The mean of the ``a`` micro-batches' gradients and losses, each
    micro-batch differentiated alone from a fresh Solver's weights with
    the step's randomness for micro-batch i (for micro-batch 0 each, with
    ``shared_seed``)."""
    ref = Solver(cfg.replace(grad_accum_steps=1), qa, store, device="cpu")
    img, ques, qlen, answers, valid, soft = ref._device_batch(batch)
    m = len(batch) // a
    grads, losses = None, []
    for i in range(a):
        rows = slice(i * m, (i + 1) * m)
        gen_seed, fusion_seed = step_randomness(ref._rng_base, 0,
                                                0 if shared_seed else i)
        logits, _ = ref.model(
            img[rows], ques[rows], qlen[rows], train=True, valid=valid[rows],
            generator=torch.Generator().manual_seed(gen_seed),
            fusion_seed=fusion_seed, aux=True)
        loss = ref._loss(logits, answers[rows], soft[rows], valid[rows])
        g = torch.autograd.grad(loss, list(ref.model.parameters()),
                                allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for p, x in zip(ref.model.parameters(), g)]
        grads = g if grads is None else [x + y for x, y in zip(grads, g)]
        losses.append(float(loss))
    names = [n for n, _ in ref.model.named_parameters()]
    return {n: x / a for n, x in zip(names, grads)}, sum(losses) / a


def test_grad_accum_equals_the_manual_average(data):
    """mhb_coAtt at f32, dropout on: the micro-batches' own masks."""
    qa, store = data
    cfg = small_cfg(qa, grad_accum_steps=2)
    solver = Solver(cfg, qa, store, device="cpu")
    batch = _first_batch(solver)
    want, want_loss = _manual_grads(cfg, qa, store, batch, 2)
    loss, _ = solver._train_step(batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
    for name, p in solver.model.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=1e-6, atol=1e-9,
                                   msg=name)
    # JAX's trick: under SGD at rate 1 the parameters move by the gradient
    sgd = Solver(cfg.replace(lr=1.0, lr_decay=False), qa, store,
                 device="cpu")
    sgd.optimizer = torch.optim.SGD(sgd.model.parameters(), lr=1.0)
    before = _params(sgd)
    sgd._train_step(batch)
    for name, p in sgd.model.named_parameters():
        np.testing.assert_allclose((before[name] - p.detach()).numpy(),
                                   want[name].numpy(), rtol=1e-2, atol=2e-6,
                                   err_msg=name)
    # control: the same masks in both micro-batches give other gradients
    shared, _ = _manual_grads(cfg, qa, store, batch, 2, shared_seed=True)
    assert not torch.allclose(solver.model.lstm.weight_hh.grad,
                              shared["lstm.weight_hh"], rtol=1e-3)


@pytest.mark.parametrize("name", ["mhb_coAtt", "iBOWIMG"])
def test_grad_accum_matches_the_jax_solver(data, jax_data, tmp_path, name):
    """f32, dropout 0, ``grad_accum_steps=2``: the per-step losses, and
    (iBOWIMG) the running statistics after the epoch, EMA'd once per
    micro-batch on both sides."""
    kw = dict(model_name=name, grad_accum_steps=2)
    if name != "mhb_coAtt":
        kw.update(dropout_default=0.0, **WIDTHS)
    port, jax_solver = _losses_match_the_jax_solver(data, jax_data, tmp_path,
                                                    **kw)
    got, want = to_jax_params(port.model), jax_solver.params
    mean_atol = BN_MOMENTUM * (2 + 4) * port.cfg.lr
    for layer in ("img_bn",):
        if layer in want:
            for key in ("mean", "var"):
                np.testing.assert_allclose(
                    got[layer][key], np.asarray(want[layer][key]), rtol=1e-4,
                    atol=1e-5 + (mean_atol if key == "mean" else 0.0),
                    err_msg=f"{layer}/{key}")


def _bn_twin(solver, batch, valid, a):
    """The running statistics after one step, by hand in f64: each
    micro-batch's mean and unbiased variance of img_emb(mean over L) over
    its valid rows, EMA'd in order; all-pad micro-batches skipped."""
    w = solver.model.img_emb.weight.detach().double().numpy().T
    b = solver.model.img_emb.bias.detach().double().numpy()
    run = {k: getattr(solver.model.img_bn, k).double().numpy().copy()
           for k in ("mean", "var")}
    img = batch.image_features.astype(np.float64)
    m = len(batch) // a
    for i in range(a):
        rows = slice(i * m, (i + 1) * m)
        x = (img[rows].mean(axis=1) @ w + b)[valid[rows]]
        if len(x) == 0:
            continue
        stats = {"mean": x.mean(axis=0),
                 "var": x.var(axis=0) * (len(x) / max(len(x) - 1, 1))}
        run = {k: (1 - BN_MOMENTUM) * run[k] + BN_MOMENTUM * stats[k]
               for k in run}
    return run


@pytest.mark.parametrize("all_pad", [False, True],
                         ids=["per_microbatch", "all_pad_skipped"])
def test_grad_accum_batch_norm_ema(data, jax_data, tmp_path, all_pad):
    """JAX's ``test_grad_accum_bn_stats_apply_momentum_per_microbatch`` and
    ``test_grad_accum_bn_skips_all_pad_microbatches``: iBOWIMG at
    ``grad_accum_steps=2``; with ``all_pad`` the second micro-batch's rows
    are all marked padding and its statistics are not merged."""
    qa, store = data
    cfg = small_cfg(qa, model_name="iBOWIMG", grad_accum_steps=2,
                    dropout_default=0.0, **WIDTHS)
    jax_solver = JaxSolver(JaxConfig(**dataclasses.asdict(cfg)), *jax_data,
                           mesh=make_mesh(data=1, model=1),
                           log_dir=str(tmp_path / "runs"))
    params = jax.tree_util.tree_map(np.asarray, jax_solver.params)
    solver = Solver(cfg, qa, store, params=params, device="cpu")
    batch = _first_batch(solver)
    n = len(batch) // 2
    if all_pad:
        batch.valid[n:] = False
    want = _bn_twin(solver, batch, batch.valid, 2)
    one_ema = _bn_twin(solver, batch, np.r_[batch.valid[:n],
                                            np.zeros(n, bool)], 2)
    solver._train_step(batch)

    jax_batch = next(jax_solver.batches["train"].epoch(0))
    jax_batch.valid[:] = batch.valid
    dev = jax_solver._device_batch(jax_batch)
    key = jax.random.fold_in(jax_solver._rng_base, 0)
    jax_params, _, _, _ = jax_solver._train_step(
        jax_solver.params, jax_solver.opt_state, *dev, key)
    for key_ in ("mean", "var"):
        got = getattr(solver.model.img_bn, key_).numpy()
        np.testing.assert_allclose(got, want[key_], rtol=1e-4)
        np.testing.assert_allclose(
            got, np.asarray(jax_params["img_bn"][key_]), rtol=1e-4)
        # two EMAs, or one where the second micro-batch is padding only
        assert np.allclose(got, one_ema[key_], rtol=1e-4) == all_pad


REMAT_RUNS = [("float32", "prepool"), ("bfloat16", "prepool")]


@pytest.mark.parametrize("dtype,site", REMAT_RUNS)
def test_remat_is_bit_equal_with_dropout_on(data, dtype, site):
    """mhb_coAtt, dropout 0.3 / 0.1 (at bf16, K2's plain version with its
    seed): a step with and without remat leaves the same parameters, bit
    for bit. Control: a dropout generator shared by the forward and its
    recomputation (not made from its seed inside the checkpointed
    function) draws other masks on the recomputation, and the parameters
    differ."""
    qa, store = data
    cfg = small_cfg(qa, compute_dtype=dtype, dropout_site=site)
    runs = {}
    for remat in (False, True):
        solver = Solver(cfg.replace(remat=remat), qa, store, device="cpu")
        loss, _ = solver._train_step(_first_batch(solver))
        runs[remat] = (float(loss), _params(solver))
    assert runs[False][0] == runs[True][0]
    for name, p in runs[False][1].items():
        assert torch.equal(p, runs[True][1][name]), name

    control = Solver(cfg.replace(remat=True), qa, store, device="cpu")
    made = {}

    def made_once(seed):
        # as a generator made outside the checkpointed function: seeded
        # once a step, the recomputation draws on where the forward ended
        if seed not in made:
            made[seed] = torch.Generator().manual_seed(seed)
        return made[seed]

    control._dropout_generator = made_once
    control._train_step(_first_batch(control))
    assert any(not torch.equal(p, runs[False][1][name])
               for name, p in _params(control).items())


def test_mid_epoch_resume_under_grad_accum_is_bit_equal(ckpt_data,  # noqa
                                                        tmp_path):
    """A checkpoint at step 3 of 4-step epochs, ``grad_accum_steps=2``,
    dropout on (iBOWIMG 0.5): the restored run's losses and its every
    parameter and Adam moment equal the straight run's."""
    qa, store = ckpt_data
    kw = dict(grad_accum_steps=2)
    straight = Solver(ckpt_cfg(qa, tmp_path / "s", num_epoch=2, **kw), qa,
                      store, device="cpu")
    straight_losses = []
    straight.train(on_step=lambda s, loss: straight_losses.append(
        float(loss)))
    first = Solver(ckpt_cfg(qa, tmp_path / "r", checkpoint_every_steps=3,
                            **kw), qa, store, device="cpu")
    first.train()
    second = Solver(ckpt_cfg(qa, tmp_path / "r", num_epoch=2, **kw), qa,
                    store, device="cpu")
    second.restore(step=3)
    losses = []
    second.train(on_step=lambda s, loss: losses.append(float(loss)))
    assert losses == straight_losses[3:]
    _assert_bit_equal(_state(second), _state(straight))


def test_int8_feed_matches_the_jax_solver(data, jax_data, tmp_path):
    """The same int8 store on both sides (each package's ``quantize_store``
    of its f16 store): the batches carry equal int8 rows and the per-step
    losses agree at rtol 1e-5; the host ships int8."""
    qa, store = data
    jqa, jstore = jax_data
    q_port = port_store.quantize_store(_store_dir(store),
                                       str(tmp_path / "port_q"))
    q_jax = jax_store.quantize_store(_store_dir(jstore),
                                     str(tmp_path / "jax_q"))
    port, _ = _losses_match_the_jax_solver((qa, q_port), (jqa, q_jax),
                                           tmp_path)
    batch = _first_batch(port)
    assert batch.image_features.dtype == np.int8
    assert batch.feature_scale.dtype == np.float16


def _store_dir(store) -> str:
    return os.path.dirname(store.features.filename)


def test_profile_steps_writes_a_trace(data, tmp_path):
    qa, store = data
    cfg = small_cfg(qa, profile_steps=2, profile_dir=str(tmp_path / "prof"))
    solver = Solver(cfg, qa, store, device="cpu")
    solver.train()
    assert solver.profile_trace == str(tmp_path / "prof" /
                                       "mhb_coAtt_trace.json")
    with open(solver.profile_trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)
    assert solver.step == 3  # the run went on after the profiled steps


def test_debug_nans_traps_a_nan_weight(data):
    qa, store = data
    cfg = small_cfg(qa, debug_nans=True)
    solver = Solver(cfg, qa, store, device="cpu")
    # a sound step passes the trap (the signed sqrt's gradient makes no
    # NaN of its own)
    loss, _ = solver._train_step(_first_batch(solver))
    assert np.isfinite(float(loss))
    with torch.no_grad():
        solver.model.ques_proj1.weight[0, 0] = float("nan")
    with pytest.raises(RuntimeError, match="nan"):
        solver._train_step(_first_batch(solver))
    # without the trap the same step runs to a NaN loss
    plain = Solver(cfg.replace(debug_nans=False), qa, store, device="cpu")
    with torch.no_grad():
        plain.model.ques_proj1.weight[0, 0] = float("nan")
    loss, _ = plain._train_step(_first_batch(plain))
    assert not np.isfinite(float(loss))
