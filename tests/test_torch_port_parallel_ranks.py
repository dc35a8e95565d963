"""Ranks of the port's data-parallel tests (``tests/test_torch_port_
parallel*.py``; this file holds no test of its own): one CPU process
each, joined over gloo through a ``file://`` store under the test's
``tmp_path`` (parallel pytest workers cannot collide on a port), running
the cases a JSON spec lists and writing each case's result as
``<out>/<case>_rank<r>.npz``. The ranks import no
``jax``; the tests hold their results against JAX in the pytest process.

    python tests/test_torch_port_parallel_ranks.py <spec.json> <rank>

``run_case`` is also what a test calls in its own process, with no process
group, for the one-process run a case is compared with.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np

from vqa_attention_networks_tpu_torch.parallel.dryrun import (
    failures,
    run_processes,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 180.0


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def unflatten(flat, prefix: str = "") -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key in flat:
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(flat[key])
    return tree


def run_ranks(spec: Dict[str, Any], world: int, tmp_path,
              deadline: float = DEADLINE_S) -> None:
    """Run ``world`` ranks on ``spec``; fail (killing every rank) when one
    fails or the deadline passes."""
    import pytest

    spec = dict(spec, world=world,
                rendezvous=f"file://{tmp_path}/rendezvous_{time.time_ns()}")
    path = os.path.join(str(tmp_path), f"spec_{time.time_ns()}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "RANK", "WORLD_SIZE",
                                "MASTER_", "LOCAL_RANK"))}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    failed = failures(run_processes(
        [[sys.executable, os.path.abspath(__file__), path, str(r)]
         for r in range(world)], env, deadline, str(tmp_path)))
    if failed:
        pytest.fail(f"{world} ranks, a deadline of {deadline:.0f} s:\n"
                    f"{failed}")


def result(out_dir: str, case: str, rank: int = 0) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(out_dir, f"{case}_rank{rank}.npz")) as f:
        return dict(f)


@contextlib.contextmanager
def recorded_masks(record: Dict[str, list]):
    """Record the masks a training forward draws, without drawing them
    twice: K2's plain mask (``train_fusion.dropout_mask``) as drawn, and
    each composed dropout's, from a twin of its generator."""
    import torch

    from vqa_attention_networks_tpu_torch.models import layers
    from vqa_attention_networks_tpu_torch.ops import fusion, grid_fusion
    from vqa_attention_networks_tpu_torch.ops import train_fusion as tf

    real_mask, real_dropout = tf.dropout_mask, layers.dropout

    def mask(*args, **kw):
        m = real_mask(*args, **kw)
        record["k2"].append(m.cpu().numpy())
        return m

    def dropout(x, rate, train, generator=None):
        if train and rate > 0 and generator is not None:
            inner = getattr(generator, "generator", generator)
            twin = torch.Generator(device=inner.device)
            twin.set_state(inner.get_state())
            if isinstance(generator, layers.GlobalRows):
                twin = dataclasses.replace(generator, generator=twin)
            ones = torch.ones_like(x)
            record["dropout"].append(
                (real_dropout(ones, rate, train, twin) != 0).cpu().numpy())
        return real_dropout(x, rate, train, generator)

    modules = [(tf, "dropout_mask", mask), (layers, "dropout", dropout),
               (grid_fusion, "dropout", dropout), (fusion, "dropout", dropout)]
    try:
        for module, name, fn in modules:
            setattr(module, name, fn)
        yield record
    finally:
        tf.dropout_mask = real_mask
        for module in (layers, grid_fusion, fusion):
            module.dropout = real_dropout


def run_case(case: Dict[str, Any], qa, store, rank: int = 0,
             out: Optional[str] = None) -> Dict[str, np.ndarray]:
    """One case: a Solver built from ``case["cfg"]`` (and the weights of
    ``case["params"]``, rank 1 taking ``case["params_rank1"]`` where
    given; the store at ``case["store"]`` where given), trained for
    ``case["steps"]`` steps of epoch 0 (or one ``train()`` epoch with
    ``"train": true``), then what the case asks for. The first step's
    gradients come back under ``g/``, the parameters under ``p/``; with
    ``"raises": true`` the Solver's refusal, under ``raised``; with
    ``"resume_step": s`` a second Solver restores step s and trains to the
    end (``resumed_losses``, parameters under ``q/``); with ``"restore":
    true`` the Solver restores the latest checkpoint of ``cfg.out_dir``
    first; with ``"eval_inputs": path`` the eval forward's logits on that
    ``.npz``'s ``img`` and ``ques`` come back under ``logits``; with
    ``"shapes": true`` each parameter's local shape under ``shape/``, and
    ``"bank_bytes"`` the training bank's bytes on this rank. Returns its
    arrays (and writes them to ``out``)."""
    import torch

    from vqa_attention_networks_tpu_torch.config import Config
    from vqa_attention_networks_tpu_torch.train.solver import Solver
    from vqa_attention_networks_tpu_torch.weights import to_jax_params

    torch.manual_seed(0)
    cfg = Config(**case["cfg"]).validate()
    if "store" in case:
        from vqa_attention_networks_tpu_torch.data.feature_store import (
            FeatureStore,
        )

        store = FeatureStore(case["store"])
    key = "params_rank1" if rank == 1 and "params_rank1" in case \
        else "params"
    params = None
    if key in case:
        with np.load(case[key]) as f:
            params = unflatten(dict(f))
    record: Dict[str, list] = {"k2": [], "dropout": []}
    masks = (recorded_masks(record) if case.get("masks")
             else contextlib.nullcontext())
    arrays: Dict[str, np.ndarray] = {}
    try:
        solver = Solver(cfg, qa, store, params=params, device="cpu",
                        log_dir=case.get("log_dir"))
    except Exception as e:  # the case expects the Solver to refuse it
        if not case.get("raises"):
            raise
        arrays["raised"] = np.asarray(f"{type(e).__name__}: {e}")
        if out is not None:
            np.savez(os.path.join(out, f"{case['name']}_rank{rank}.npz"),
                     **arrays)
        return arrays
    losses = []
    if case.get("restore"):
        solver.restore()
    if case.get("shapes"):
        for name, p in solver.model.named_parameters():
            arrays[f"shape/{name}"] = np.asarray(p.shape)
    if solver.bank is not None:
        arrays["bank_bytes"] = np.asarray(solver.bank.nbytes)
    if "eval_inputs" in case:
        with np.load(case["eval_inputs"]) as f:
            img, ques = (torch.from_numpy(f[k]) for k in ("img", "ques"))
        with torch.no_grad():
            arrays["logits"] = solver.eval_model()(img, ques).numpy()
    if case.get("val_first"):
        arrays["val_first"] = np.asarray(solver.val())
    with masks:
        if case.get("train"):
            solver.train(on_step=lambda s, loss: losses.append(float(loss)))
        for i, batch in enumerate(solver.batches["train"].epoch(0)):
            if i == case.get("steps", 0):
                break
            loss, correct = solver._train_step(batch)
            solver.step += 1
            losses.append(float(loss))
            arrays[f"correct_{i}"] = np.asarray(float(correct))
            if i == 0:
                arrays.update(flatten(gradients(solver.model), "g/"))
    arrays["losses"] = np.asarray(losses)
    for name in ("k2", "dropout"):
        for i, m in enumerate(record[name]):
            arrays[f"{name}_{i}"] = m
    arrays.update(flatten(to_jax_params(solver.model), "p/"))
    if case.get("val"):
        arrays["val"] = np.asarray(solver.val(full=case["val"] == "full"))
    if case.get("checkpoint"):
        solver.save_checkpoint()
        restored = Solver(cfg, qa, store, device="cpu")
        restored.restore()
        arrays["restored_step"] = np.asarray(restored.step)
        arrays.update(flatten(to_jax_params(restored.model), "r/"))
    if "resume_step" in case:
        resumed, again = Solver(cfg, qa, store, device="cpu"), []
        resumed.restore(case["resume_step"])
        resumed.train(on_step=lambda s, loss: again.append(float(loss)))
        arrays["resumed_losses"] = np.asarray(again)
        arrays.update(flatten(to_jax_params(resumed.model), "q/"))
        resumed.close()
    solver.close()
    if out is not None:
        np.savez(os.path.join(out, f"{case['name']}_rank{rank}.npz"),
                 **arrays)
    return arrays


def gradients(model) -> Dict[str, Any]:
    """The gradients left in ``model``'s ``.grad`` by the last step (after
    DDP's all-reduce), as a tree in the JAX layout (0 where none)."""
    import copy

    import torch

    from vqa_attention_networks_tpu_torch.models.layers import BatchNorm
    from vqa_attention_networks_tpu_torch.weights import to_jax_params

    twin = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), twin.parameters()):
            q.copy_(p.grad if p.grad is not None else torch.zeros_like(p))
        for module in twin.modules():  # a batch norm's running statistics
            if isinstance(module, BatchNorm):
                module.mean.zero_()
                module.var.zero_()
    return to_jax_params(twin)


def load_data(spec: Dict[str, Any]):
    from vqa_attention_networks_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from vqa_attention_networks_tpu_torch.data.prepare import load_qa_data

    return load_qa_data(spec["qa"]), FeatureStore(spec["store"])


def main(spec_path: str, rank: int) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    import torch

    from vqa_attention_networks_tpu_torch.parallel import (
        initialize_distributed,
    )

    join = dict(init_method=spec["rendezvous"], world_size=spec["world"],
                rank=rank, device="cpu")
    initialize_distributed(**join)
    group = torch.distributed.group.WORLD
    # a second call changes nothing (JAX's idempotence)
    assert initialize_distributed(**join) == torch.device("cpu")
    assert torch.distributed.group.WORLD is group
    qa, store = load_data(spec)
    for case in spec["cases"]:
        run_case(case, qa, store, rank, spec["out"])
    assert "jax" not in sys.modules, "a rank imported jax"


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
