"""Faults planted in the program under the harness, so that a test can see a
run come out not correct (``tests/test_port_bench_faults.py``). A
benchmark run never plants one.

- ``unchanged``: the optimizer's step returns the state unchanged;
- ``half_batch``: half of each batch left out, the loss the mean over the
  rest;
- ``no_exchange``: the gradients are not exchanged between ranks;
- ``alter_answer``: each served answer is altered where it is produced.
"""

from __future__ import annotations

FAULTS = ("unchanged", "half_batch", "no_exchange", "alter_answer")


def plant(fault: str, solver=None, engine=None) -> None:
    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}; choose from {FAULTS}")
    if fault == "unchanged":
        solver.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        loss = solver._loss

        def half(logits, answers, soft, valid, count=None):
            kept = valid.clone()
            kept[kept.shape[0] // 2:] = False
            return loss(logits, answers, soft, kept,
                        None if count is None else count // 2)
        solver._loss = half
    elif fault == "no_exchange":
        import torch

        world = solver.data_parallel

        def local(_state, bucket):
            fut = torch.futures.Future()
            fut.set_result(bucket.buffer().div_(world))
            return fut
        solver._forward.register_comm_hook(None, local)
    elif fault == "alter_answer":
        collect = engine._collect

        def altered(handles, n):
            preds = collect(handles, n)
            vocab = engine.cfg.a_vocab_size
            for p in preds:
                p.top_ids = (p.top_ids + 1) % vocab
                p.answer_id = int(p.top_ids[0])
            return preds
        engine._collect = altered
