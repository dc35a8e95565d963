"""A dry run over CPU ranks: the twin of ``dryrun_multichip`` in
``__graft_entry__.py``, on its mesh: ``('data', 'model') = (N/2, 2)`` when
N is even, else ``(N, 1)``.

N processes join a gloo process group through a ``file://`` store. Each
builds the Solver at tiny widths over the same synthetic data and runs one
full training step (loss, gradient and its all-reduce, Adam, the
batch-norm merge) and one ``val()``, for ``mhb_coAtt`` (its fusion
projections split over the model axis) and for iBOWIMG (whose batch norm
takes global statistics). The parent then checks that every rank holds
the same loss, validation figures and parameters (gathered), and that
they are finite.

    python -m vqa_attention_networks_tpu_torch.parallel.dryrun --ranks 4
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MODELS = ("mhb_coAtt", "iBOWIMG")
_MODULE = "vqa_attention_networks_tpu_torch.parallel.dryrun"


def mesh_shape(n_ranks: int) -> Tuple[int, int]:
    """``dryrun_multichip``'s mesh: (N/2, 2) when N is even, else (N, 1)."""
    model = 2 if n_ranks % 2 == 0 else 1
    return n_ranks // model, model


def _config(model_name: str, qa, n_ranks: int):
    from vqa_attention_networks_tpu_torch.config import Config

    data, model = mesh_shape(n_ranks)
    return Config(
        model_name=model_name, q_vocab_size=qa.q_vocab_size,
        a_vocab_size=qa.a_vocab_size, hidden_dim=32, emb_dim=16,
        embed_size=32, img_feature_channel=64,
        max_question_length=qa.max_question_length, mfb_factor=5,
        mfb_out=8, batch_size=2 * n_ranks, checkpoint_every_steps=0,
        prefetch_workers=1, data_parallel=data, model_parallel=model,
    ).validate()


def _write_data(work: str, n_ranks: int) -> None:
    from vqa_attention_networks_tpu_torch.data.feature_store import (
        make_synthetic_feature_store,
    )
    from vqa_attention_networks_tpu_torch.data.prepare import (
        make_synthetic_qa_data,
        save_qa_data,
    )

    qa = make_synthetic_qa_data(np.random.default_rng(0),
                                n_train=2 * n_ranks * 4, n_val=8,
                                num_images=4)
    save_qa_data(qa, os.path.join(work, "qa"))
    make_synthetic_feature_store(
        os.path.join(work, "feat"),
        sorted(set(qa.train.image_ids) | set(qa.val.image_ids)),
        channels=64)


def _rank(rank: int, n_ranks: int, work: str) -> None:
    """One rank: a step and a ``val()`` of each model -> its JSON."""
    import torch

    from vqa_attention_networks_tpu_torch.data.feature_store import (
        FeatureStore,
    )
    from vqa_attention_networks_tpu_torch.data.prepare import load_qa_data
    from vqa_attention_networks_tpu_torch.parallel import (
        initialize_distributed,
    )
    from vqa_attention_networks_tpu_torch.train.solver import Solver
    from vqa_attention_networks_tpu_torch.weights import to_jax_params

    initialize_distributed(init_method=f"file://{work}/rendezvous",
                           world_size=n_ranks, rank=rank, device="cpu")
    qa = load_qa_data(os.path.join(work, "qa"))
    store = FeatureStore(os.path.join(work, "feat"))
    out = {}
    for name in MODELS:
        solver = Solver(_config(name, qa, n_ranks), qa, store, device="cpu")
        loss, correct = solver._train_step(
            next(solver.batches["train"].epoch(0)))
        solver.step += 1
        val_loss, val_acc = solver.val()
        tree = to_jax_params(solver.model)  # the shards gathered

        def l1(node) -> float:
            return sum(l1(v) if isinstance(v, dict)
                       else float(np.abs(v.astype(np.float64)).sum())
                       for v in node.values())

        out[name] = {
            "loss": float(loss), "correct": float(correct),
            "val": [val_loss, val_acc], "mesh": list(mesh_shape(n_ranks)),
            "params_l1": l1(tree),
        }
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def run_processes(commands: Sequence[Sequence[str]], env: Dict[str, str],
                  timeout: float, log_dir: str
                  ) -> List[Tuple[Optional[int], str]]:
    """Start each command as a process of its own (its output in
    ``<log_dir>/rank<i>.log``) and wait for all of them, at most
    ``timeout`` seconds in all; a process still running then is killed.
    -> (exit code, or None for a killed one; the end of its log), in
    order."""
    logs = [open(os.path.join(log_dir, f"rank{i}.log"), "w+")
            for i in range(len(commands))]
    procs = [subprocess.Popen(list(cmd), env=env, stdout=log,
                              stderr=subprocess.STDOUT)
             for cmd, log in zip(commands, logs)]
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        late = [p for p in procs if p.poll() is None]
        for p in late:
            p.kill()
            p.wait()
    out = []
    for p, log in zip(procs, logs):
        log.seek(0)
        out.append((None if p in late else p.returncode, log.read()[-3000:]))
        log.close()
    return out


def failures(results: List[Tuple[Optional[int], str]]) -> str:
    """The logs of the processes ``run_processes`` saw fail or killed, or
    "" when every one exited 0."""
    return "\n".join(
        f"--- rank {i}: "
        f"{'killed at the deadline' if rc is None else f'exit {rc}'} ---\n"
        f"{tail}" for i, (rc, tail) in enumerate(results) if rc != 0)


def dryrun_data_parallel(n_ranks: int, timeout: float = 180.0
                         ) -> List[Dict]:
    """Run the dry run over ``n_ranks`` CPU processes -> each rank's
    figures; raises when a rank fails, the deadline passes (every rank is
    then killed) or the ranks disagree."""
    with tempfile.TemporaryDirectory() as work:
        _write_data(work, n_ranks)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(key, None)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        failed = failures(run_processes(
            [[sys.executable, "-m", _MODULE, "--rank", str(r), "--ranks",
              str(n_ranks), "--work", work] for r in range(n_ranks)],
            env, timeout, work))
        if failed:
            raise RuntimeError(f"dry run over {n_ranks} ranks:\n{failed}")
        results = []
        for r in range(n_ranks):
            with open(os.path.join(work, f"rank{r}.json")) as f:
                results.append(json.load(f))
    for name in MODELS:
        first = results[0][name]
        if not all(np.isfinite(v) for v in (first["loss"], *first["val"])):
            raise RuntimeError(f"{name}: non-finite figures {first}")
        for r, other in enumerate(results[1:], 1):
            if other[name] != first:
                raise RuntimeError(f"{name}: rank {r} holds {other[name]}, "
                                   f"rank 0 {first}")
    return results


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--work", type=str, default=None)
    parser.add_argument("--timeout", type=float, default=180.0)
    args = parser.parse_args(argv)
    if args.rank is not None:
        _rank(args.rank, args.ranks, args.work)
        return
    results = dryrun_data_parallel(args.ranks, args.timeout)
    print(json.dumps({"ranks": args.ranks, **results[0]}))


if __name__ == "__main__":
    main()
