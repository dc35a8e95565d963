"""The port's ``parallel`` package in one process, with no process group:
``initialize_distributed``'s rules (JAX ``parallel/distributed.py:18-64``:
a no-op in one process, loud on a partial configuration), a rank's device,
the mesh's refusals, the rows a rank holds (JAX ``parallel/sharding.py``
``shard_batch``: rank r of W holds ``[r*B/W, (r+1)*B/W)``, and under
accumulation its slice of each micro-batch) and the split engine's
devices; and what the Solver reads from the model under DDP: the ranks a
batch norm's statistics span, and whether a step leaves parameters
unused."""

import copy

import numpy as np
import pytest
import torch

from vqa_attention_networks_tpu_torch.config import Config
from vqa_attention_networks_tpu_torch.data.dataset import Batch
from vqa_attention_networks_tpu_torch.models import get_model
from vqa_attention_networks_tpu_torch.models.layers import (
    BatchNorm,
    span_batch_statistics,
)
from vqa_attention_networks_tpu_torch.parallel import (
    batch_rows,
    distributed,
    host_fetch,
    initialize_distributed,
    is_primary,
    make_mesh,
    rank,
    shard_batch,
    step_rows,
    world_size,
)
from vqa_attention_networks_tpu_torch.serve import replica_devices

ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture
def no_launcher(monkeypatch):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)


def test_one_process_is_a_no_op(no_launcher):
    assert initialize_distributed(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert (rank(), world_size(), is_primary()) == (0, 1, True)
    x = torch.arange(6).reshape(3, 2)
    np.testing.assert_array_equal(host_fetch(x), x.numpy())
    assert distributed.all_reduce_sum(x) is x


@pytest.mark.parametrize("env,kw", [
    (dict(RANK="0"), {}),
    (dict(RANK="1", WORLD_SIZE="2", MASTER_ADDR="localhost"), {}),
    ({}, dict(world_size=2, rank=0)),
    ({}, dict(init_method="file:///nonexistent/rendezvous")),
])
def test_a_partial_configuration_raises(no_launcher, monkeypatch, env, kw):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="configured in part"):
        initialize_distributed(device="cpu", **kw)
    assert not torch.distributed.is_initialized()


def test_a_ranks_device(no_launcher, monkeypatch):
    cpu = torch.device("cpu")
    assert distributed.rank_device("cpu") == cpu
    assert distributed.rank_device(torch.device("cuda", 1)) == \
        torch.device("cuda", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.rank_device("cuda")  # never the CPU by itself
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.rank_device(None) == torch.device("cuda")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.rank_device("cuda") == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="LOCAL_RANK=2 but 2 CUDA"):
        distributed.rank_device("cuda")


def test_the_mesh_needs_a_group_and_has_no_model_axis_yet(no_launcher):
    """A mesh needs a process group, with a model axis too (ROADMAP item
    10b, refused until it was ported; the name is the refusal's); a model
    axis must divide mfb_out (``test_torch_port_tensor_parallel.py`` runs
    the (2, 2) mesh)."""
    from vqa_attention_networks_tpu_torch.parallel.sharding import (
        check_model_axis,
    )

    with pytest.raises(ValueError, match="torchrun --nproc_per_node N"):
        make_mesh(2)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node N"):
        make_mesh(1, model=2)
    check_model_axis(Config(), 4)  # 1000 outputs, 250 a rank
    with pytest.raises(ValueError, match="does not divide mfb_out=1000"):
        check_model_axis(Config(), 3)


def test_the_rows_a_rank_holds():
    assert [batch_rows(8, r, 4) for r in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(AssertionError, match="not divisible by 3"):
        batch_rows(8, 0, 3)
    np.testing.assert_array_equal(step_rows(8, 1, 1, 2), [4, 5, 6, 7])
    # under accumulation: the rank's slice of each micro-batch
    np.testing.assert_array_equal(step_rows(16, 2, 1, 2),
                                  [4, 5, 6, 7, 12, 13, 14, 15])
    every = np.sort(np.concatenate([step_rows(16, 4, r, 2)
                                    for r in range(2)]))
    np.testing.assert_array_equal(every, np.arange(16))


def test_shard_batch_slices_every_per_row_field_but_the_features():
    """The features are the rank's already (``VqaBatches(feature_rows=
    ...)`` gathered its rows alone); every other field is the global
    batch's and is sliced."""
    n = 8
    local = np.arange(4 * 6).reshape(4, 3, 2)
    batch = Batch(image_features=local,
                  questions=np.arange(n * 4).reshape(n, 4),
                  answers=np.arange(n), ques_length=np.arange(n) + 1,
                  valid=np.arange(n) < 5, question_ids=np.arange(n) + 100,
                  image_rows=np.arange(4))
    part = shard_batch(batch, batch_rows(n, 1, 2))
    assert len(part) == 4 and part.soft_answers is None
    np.testing.assert_array_equal(part.answers, [4, 5, 6, 7])
    np.testing.assert_array_equal(part.valid, [True, False, False, False])
    np.testing.assert_array_equal(part.question_ids, [104, 105, 106, 107])
    assert part.image_features is local and part.image_rows is \
        batch.image_rows


def test_replica_devices(monkeypatch):
    cpu = torch.device("cpu")
    assert replica_devices("cpu", 3) == [cpu] * 3
    assert replica_devices(["cpu", "cpu", "cpu"], 2) == [cpu] * 2
    with pytest.raises(ValueError, match="data_parallel=4 but only 2"):
        replica_devices(["cpu", "cpu"], 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            replica_devices(None, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert replica_devices("cuda", 2) == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="data_parallel=4 but only 2 "
                                         "device"):
        replica_devices(None, 4)


SMALL = dict(q_vocab_size=20, a_vocab_size=6, hidden_dim=16, emb_dim=8,
             img_feature_channel=32, mfb_out=8, embed_size=16, att_num=2)


def test_batch_norms_span_the_group_they_are_given():
    """The Solver hands its mesh's data group to every batch norm; a copy of
    the model spans the same group (a process group cannot be copied), and
    a batch norm nobody gave one takes this process's rows."""
    model = get_model("iBOWIMG")(Config(model_name="iBOWIMG", **SMALL))
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert norms and all(m.ranks.group is None for m in norms)
    group = object()  # stands for a process group: only its identity counts
    span_batch_statistics(model, group)
    assert all(m.ranks.group is group for m in norms)
    twin = copy.deepcopy(model)
    assert all(m.ranks.group is group for m in twin.modules()
               if isinstance(m, BatchNorm))
    assert BatchNorm(4).ranks.group is None


@pytest.mark.parametrize("name,quirks,unused", [
    ("mfb", True, True), ("mfb-multilayer", True, True),
    ("mfb", False, False), ("mhb_coAtt", True, False),
    ("iBOWIMG", True, False)])
def test_the_model_says_whether_training_leaves_parameters_unused(
        name, quirks, unused):
    """DDP looks for parameters without a gradient only where the model
    says a step leaves some: mfb under its reference quirk, whose stage-1
    fusion is gradient-dead."""
    cfg = Config(model_name=name, keep_reference_quirks=quirks, **SMALL)
    model = get_model(name)(cfg)
    assert getattr(model, "unused_in_training", False) is unused
