"""Training through ``Solver.train``, on one card or data-parallel over the
cell's cards (one rank a card, the ranks child processes of the run).

Set-up builds the ``Solver`` (weights from the seed; the feed its
``Config`` switches in the traffic file's ``solver`` give) over an
``inputs.Int8Bank`` of ``images`` grids (``pool`` distinct ones, every
image its own scales), which the Solver reads as an int8 store in host
memory and, under ``device_feature_bank``, holds whole on the card. It
calls ``val()`` once, as every epoch's end does, so that no kernel loads
inside the window. Then
``train()`` runs: its first ``warm_steps`` steps are set-up, and the first
three of them are the ones the reference follows; the window opens after
them and closes at the first step after it is due (``on_step`` raises
``StopWindow``; on several cards every rank stops at the step rank 0's
clock decides, agreed over a gloo group each step).

The traffic is a job: ``images`` grids, ``questions_per_image`` questions
each with soft answers (``traffic.soft_answers``), ``batch`` the global
batch, in the order drawn (the Solver's shuffle off: the draw is already a
random order, so the reference knows each step's rows), checkpoints off;
``cpu_threads``, where given, the process's intra-op CPU threads.
An epoch is the whole job, so a job as large as VQA v2 train ends none
inside the window.
"""

from __future__ import annotations

import ctypes
import functools
import multiprocessing
import signal
import socket
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from port_bench import check, faults, inputs, serving, traffic
from port_bench.harness import (PROCESS_START, Context, Run, StopWindow,
                                Window, port_config)
from port_bench.reference import common

REF_STEPS = 3
ADAM = (0.9, 0.999, 1e-8)
# the references put in the program's place by ``control.py``: the next
# precision down, the faults a training cell can have, and the two looks:
# the float32 reference with every signed square root's input moved by
# bfloat16's rounding, and with every product's operands in bfloat16
CONTROLS = {
    "float8": lambda batch, world: {"precision": "float8"},
    "look": lambda batch, world: {"look": True},
    "bfloat16": lambda batch, world: {"precision": "bfloat16"},
    "half_batch": lambda batch, world: {"grad_rows": batch // 2,
                                        "loss_rows": batch // 2},
    "no_exchange": lambda batch, world: {"grad_rows": batch // world},
}
_LEAF = {"weight": "w", "bias": "b", "weight_ih": "w_ih",
         "weight_hh": "w_hh", "bias_ih": "b_ih", "bias_hh": "b_hh"}


def reference_key(name: str, shapes: Dict) -> str:
    """A module parameter's name -> its leaf in the reference's table."""
    layer, attr = name.rsplit(".", 1)
    if attr == "weight" and f"{layer}/table" in shapes:
        return f"{layer}/table"
    return f"{layer}/{_LEAF[attr]}"


def job(ctx: Context, cfg) -> Dict[str, np.ndarray]:
    tr = ctx.cell.traffic
    q = traffic.questions(tr, cfg.q_vocab_size, cfg.max_question_length,
                          ctx.seed)
    q.update(traffic.soft_answers(tr, len(q["ques_length"]),
                                  cfg.a_vocab_size, ctx.seed))
    return q


def qa_data(q: Dict[str, np.ndarray], cfg, val_rows: int):
    """The program's QAData: the drawn questions as the train split, its
    first ``val_rows`` again as the val split."""
    from vqa_attention_networks_tpu_torch.data.prepare import QAData, QASplit

    def split(sel):
        return QASplit(questions=q["questions"][sel],
                       ques_length=q["ques_length"][sel],
                       answers=q["answers"][sel],
                       image_ids=q["image_ids"][sel],
                       soft_idx=q["soft_idx"][sel],
                       soft_val=q["soft_val"][sel])

    vocab = {f"w{i}": i for i in range(1, cfg.q_vocab_size - 1)}
    vocab["UNK"] = cfg.q_vocab_size - 1
    return QAData(train=split(slice(None)), val=split(slice(0, val_rows)),
                  answer_vocab={f"a{i}": i for i in range(cfg.a_vocab_size)},
                  question_vocab=vocab,
                  max_question_length=cfg.max_question_length)


def _norms(tensors) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])


def run_rank(ctx: Context, rank: int = 0,
             world: int = 1, init: Optional[str] = None) -> Optional[Run]:
    """One rank's run; rank 0 returns the record, the others None."""
    import torch.distributed as dist
    from vqa_attention_networks_tpu_torch.parallel import distributed
    from vqa_attention_networks_tpu_torch.train.solver import Solver

    cell, tr = ctx.cell, ctx.cell.traffic
    if "cpu_threads" in tr:
        torch.set_num_threads(int(tr["cpu_threads"]))
    dev = torch.device(ctx.device if torch.device(ctx.device).type == "cpu"
                       else f"cuda:{rank}")
    gloo = None
    if world > 1:
        distributed.initialize_distributed(init, world, rank, device=dev)
        gloo = dist.new_group(backend="gloo")
    cfg = port_config(cell, **tr.get("solver", {}), batch_size=tr["batch"],
                      seed=ctx.seed, shuffle=False, num_epoch=10 ** 9,
                      checkpoint_every_steps=0)
    q = job(ctx, cfg)
    shapes = serving.reference_module(cell).param_shapes(
        cell.config["fields"])
    params = inputs.tree(inputs.weights(shapes, ctx.seed, dev))
    bank = inputs.Int8Bank(tr["images"], cfg.img_feature_dim,
                           cfg.img_feature_channel, tr["pool"], ctx.seed, dev)
    serving.reset_peak(dev)
    solver = Solver(cfg, qa_data(q, cfg, tr["batch"]), bank, params=params,
                    device=dev)
    if ctx.fault:
        faults.plant(ctx.fault, solver=solver)
    solver.val()
    first: Dict[str, torch.Tensor] = {}
    loss_fn = solver._loss

    def capture(logits, *args, **kw):
        # the first training step's logits, as the Solver's loss gets them
        first.setdefault("logits", logits.detach().float().cpu())
        return loss_fn(logits, *args, **kw)

    solver._loss = capture
    names = [n for n, _ in solver.model.named_parameters()]
    live = [p for _, p in solver.model.named_parameters()]
    start = [p.detach().clone() for p in live]
    warm = int(tr["warm_steps"])
    last = [warm - 1]
    stamps = []  # the host's time at each step of the window

    def agree(done: bool) -> bool:
        flag = torch.tensor([int(done)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=gloo)
        return bool(flag.item())

    window = Window(ctx.seconds, dev, ctx.trace,
                    agree if gloo is not None else None)

    def on_step(step: int, loss: torch.Tensor) -> None:
        if step == 0:
            solver._loss = loss_fn
            state = solver.optimizer.state
            first["support"] = torch.stack([
                (state[p]["exp_avg"] != 0).sum() if p in state
                else torch.zeros((), dtype=torch.int64, device=p.device)
                for p in live])
            # the first gradient's norms, from Adam's first moment
            first["grad"] = _norms(
                state[p]["exp_avg"] if p in state
                else torch.zeros(1, device=p.device) for p in live
            ) / (1 - ADAM[0])
        if step == REF_STEPS - 1:
            first["change"] = _norms(p - s for p, s in zip(live, start))
            start.clear()
        if step == warm - 1:
            window.open()
        elif step >= warm:
            last[0] = step
            stamps.append(time.perf_counter())
            if window.due():
                raise StopWindow

    try:
        solver.train(on_step)
    except StopWindow:
        pass
    window.close()
    steps = last[0] - warm + 1
    peak = serving.memory_peak(dev)
    profile = window.profile_summary() if ctx.trace else None
    quiet = ({"seconds": window.unprofiled_s, "rows": tr["batch"] * sum(
        map(window.before, stamps))} if window.p0 is not None else {})
    mine = {"peak": peak, "profile": profile, "elapsed": window.elapsed,
            "steps": steps, "logits": first["logits"]}
    ranks = [mine]
    if gloo is not None:
        ranks = [None] * world
        dist.all_gather_object(ranks, mine, group=gloo)
    program = {"logits": torch.cat([r["logits"] for r in ranks]),
               "support": dict(zip(names, first["support"].tolist())),
               "grad": dict(zip(names, first["grad"].tolist())),
               "change": dict(zip(names, first["change"].tolist()))}
    del solver, live, start, on_step, capture, loss_fn
    if world > 1:
        dist.destroy_process_group()
    if rank:
        return None
    serving.free(dev)
    for k in ("support", "grad", "change"):
        program[k] = {reference_key(n, shapes): x
                      for n, x in program[k].items()}
    features = functools.partial(bank.features, device=dev)
    reference = reference_steps(ctx, params, q, features, dev)
    rows = steps * tr["batch"]
    controls = {name: check.train_numbers(
        reference_steps(ctx, params, q, features, dev,
                        **CONTROLS[name](tr["batch"], world)), reference)
        for name in ctx.controls}
    return Run(cell=cell, cfg=cfg, device=dev, window_s=window.elapsed,
               setup_s=window.t0 - PROCESS_START,
               e2e={"train_qa_pairs_per_s": rows / window.elapsed},
               work={"rows": rows, "steps": steps, "batch": tr["batch"]},
               attempted=rows, failed=0,
               checks=check.train_numbers(program, reference),
               memory_peak_bytes=max(r["peak"] for r in ranks),
               profiles=[r["profile"] for r in ranks], controls=controls,
               unprofiled=quiet)


def step_batch(q, features: Callable, step: int, batch: int, answers: int,
               dev):
    sel = slice(step * batch, (step + 1) * batch)
    img = features(q["image_ids"][sel])
    ques = torch.from_numpy(q["questions"][sel]).to(dev)
    soft = common.dense_soft(torch.from_numpy(q["soft_idx"][sel]).to(dev),
                             torch.from_numpy(q["soft_val"][sel]).to(dev),
                             answers)
    return img, ques, soft


def reference_steps(ctx: Context, params, q, features: Callable, dev,
                    precision: str = "float32",
                    grad_rows: Optional[int] = None,
                    loss_rows: Optional[int] = None,
                    look: bool = False) -> Dict:
    """The reference's first REF_STEPS steps of the same job from the same
    weights: its losses, and by leaf its first gradient's norms and
    support (elements it reached), and the change norms; the first logits.
    ``grad_rows``/``loss_rows`` (a fault's reference, never a run's):
    differentiate or report the loss of the batch's first rows alone;
    ``look``: every signed square root's input moved by bfloat16's
    rounding (``common.rounded_sqrt_inputs``)."""
    common.exact_products()
    cell = ctx.cell
    sizes = cell.config["fields"]
    ref = serving.reference_module(cell)
    prec = common.Precision(precision)
    batch = cell.traffic["batch"]
    p = {f"{layer}/{leaf}": torch.tensor(v, device=dev, requires_grad=True)
         for layer, leaves in params.items() for leaf, v in leaves.items()}
    keys = list(p)
    start = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = ADAM
    lr = sizes.get("lr", 7e-4)
    out: Dict = {"losses": []}
    from port_bench.reference.k2_mask import step_randomness

    for step in range(REF_STEPS):
        img, ques, soft = step_batch(q, features, step, batch,
                                     sizes["a_vocab_size"], dev)
        gen_seed, k2_seed = step_randomness(ctx.seed + 1, step)
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
        with common.rounded_sqrt_inputs(look):
            logits = ref.train_forward(p, img, ques, sizes, gen, k2_seed,
                                       prec)
        g_sel = slice(0, grad_rows)
        loss = common.soft_cross_entropy(logits[g_sel], soft[g_sel])
        grads = torch.autograd.grad(loss, [p[k] for k in keys])
        l_sel = slice(0, loss_rows)
        out["losses"].append(float(common.soft_cross_entropy(
            logits[l_sel], soft[l_sel]).detach()))
        if step == 0:
            out["logits"] = logits.detach().cpu()
            out["grad"] = {k: float(torch.linalg.vector_norm(g))
                           for k, g in zip(keys, grads)}
            out["support"] = {k: int((g != 0).sum())
                              for k, g in zip(keys, grads)}
        with torch.no_grad():
            for k, g in zip(keys, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** (step + 1))
                v_hat = v2[k] / (1 - b2 ** (step + 1))
                p[k].sub_(lr * m_hat / (v_hat.sqrt() + eps))
    out["change"] = {k: float(torch.linalg.vector_norm(p[k].detach()
                                                       - start[k]))
                     for k in keys}
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(ctx: Context, rank: int, world: int, init: str) -> None:
    """A rank other than 0: ends with its parent."""
    try:
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except OSError:
        pass
    run_rank(ctx, rank, world, init)


def run(ctx: Context) -> Run:
    world = ctx.cell.chips
    if world == 1:
        return run_rank(ctx)
    init = f"tcp://127.0.0.1:{_free_port()}"
    mp = multiprocessing.get_context("spawn")
    children = [mp.Process(target=_child, args=(ctx, r, world, init),
                           daemon=True) for r in range(1, world)]
    for c in children:
        c.start()
    try:
        record = run_rank(ctx, 0, world, init)
    finally:
        for c in children:
            c.join(timeout=120)
            if c.is_alive():
                c.kill()
                c.join()
    bad = [c.exitcode for c in children if c.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return record
