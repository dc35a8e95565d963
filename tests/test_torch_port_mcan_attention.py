"""MCAN's attention op (``ops/mcan_attention.py``): its plain version, the
dispatch of ``MCAN._mha``, and the fused kernel (``csrc/mcan_attention.cu``)
on the card.

On the CPU:

- the op's plain version (what it runs on a CPU tensor) is bit for bit the
  composed attention ``MCAN._mha`` computed before the op existed, at f32
  and bf16, over random shapes and key masks with a fully masked row;
- ``_mha`` calls the op exactly in the fused forward (eval, bf16, heads of
  64, neither ``reference_kernels`` nor ``VQA_DISABLE_PALLAS``), and the
  composed form under training, f32, either switch and narrower heads;
- the key tile the wrapper picks from Lk, and the op under
  ``torch.library.opcheck``;
- the benchmark's ``mcan_attn_roofline``: its bound at MCAN-large's sizes
  and its reading of a profiled stretch.

On the card (skipped here; ``python -m pytest
tests/test_torch_port_mcan_attention.py -q --noconftest`` there): the
kernel at MCAN-large's three shapes and at ragged ones, with random key
masks and fully masked rows, no further from the f32 composed attention
than the composed bf16 form plus one bf16 ulp; bit-stable across CUDA
graph replays; 18 launches an MCAN forward of six layers a stack.

This file imports neither JAX nor the JAX package.
"""

import math

import numpy as np
import pytest
import torch

from test_torch_port_mcan import inputs, model_for, params_for, small_cfg
from vqa_attention_networks_tpu_torch.models import mcan
from vqa_attention_networks_tpu_torch.ops import mcan_attention


def composed_mha_math(q, k, v, mask, heads):
    """``MCAN._mha``'s attention as it was written before the op: the heads
    split by views, q scaled by 1/sqrt(d_h), the map filled with -1e9 at
    masked keys, softmax, the product with v, the heads joined."""
    n, lq, d = q.shape
    lk = k.shape[1]
    dh = d // heads

    def split(x, length):
        return x.view(n, length, heads, dh).transpose(1, 2)

    v = split(v, lk)
    k = split(k, lk)
    q = split(q, lq) / math.sqrt(dh)
    scores = torch.matmul(q, k.transpose(-2, -1))
    scores = scores.masked_fill(mask[:, None, None, :], -1e9)
    att = torch.softmax(scores, dim=-1)
    return torch.matmul(att, v).transpose(1, 2).reshape(n, lq, d)


def attention_inputs(n, heads, lq, lk, seed, dtype=torch.float32,
                     device="cpu"):
    """q, k, v [N, L, 64 heads] from numpy and a random key mask [N, Lk]
    (each sample's masked count drawn from 0 to Lk - 1), sample 0's keys
    all masked."""
    rng = np.random.default_rng(seed)
    d = 64 * heads
    q, k, v = (torch.from_numpy(rng.standard_normal((n, length, d))
                                .astype(np.float32)).to(device, dtype)
               for length in (lq, lk, lk))
    mask = np.zeros((n, lk), dtype=bool)
    for i in range(n):
        mask[i, rng.permutation(lk)[:rng.integers(0, lk)]] = True
    mask[0] = True
    return q, k, v, torch.from_numpy(mask).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lk", [5, 14, 196])
def test_the_ops_plain_version_is_the_composed_mha(dtype, lk):
    q, k, v, mask = attention_inputs(3, 2, {5: 9, 14: 14, 196: 70}[lk], lk,
                                     seed=lk, dtype=dtype)
    got = mcan_attention.attention(q, k, v, mask)
    want = composed_mha_math(q, k, v, mask, 2)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)
    # the fully masked sample is the mean of its values in every row
    torch.testing.assert_close(
        got[0].float(), v[0].float().mean(0).expand_as(got[0]),
        atol=2.0 ** -6 if dtype == torch.bfloat16 else 1e-5, rtol=0)
    # the mask acts: without it the output is another
    open_ = mcan_attention.attention(q, k, v, torch.zeros_like(mask))
    assert not torch.equal(open_, got)


@pytest.mark.parametrize("case,hidden,dtype,expect_op", [
    ("eval_bf16", 128, "bfloat16", True),
    ("train", 128, "bfloat16", False),
    ("f32", 128, "float32", False),
    ("reference_kernels", 128, "bfloat16", False),
    ("disable_pallas", 128, "bfloat16", False),
    ("heads_below_64", 48, "bfloat16", False),
])
def test_mha_takes_the_op_exactly_in_the_fused_forward(
        monkeypatch, case, hidden, dtype, expect_op):
    """Counted by wrapping the op's entry and the composed form where
    ``models/mcan.py`` calls them: the op once an attention (3 a layer:
    the encoder's, the decoder's self- and guided attention) or never (the
    composed form that the op runs on a CPU tensor is not counted)."""
    monkeypatch.delenv("VQA_DISABLE_PALLAS", raising=False)
    if case == "disable_pallas":
        monkeypatch.setenv("VQA_DISABLE_PALLAS", "1")
    calls = {"op": 0, "composed": 0}
    in_op = []
    op, composed = mcan_attention.attention, mcan_attention.attention_composed

    def counted_op(*args, **kw):
        calls["op"] += 1
        in_op.append(True)
        try:
            return op(*args, **kw)
        finally:
            in_op.pop()

    def counted_composed(*args, **kw):
        calls["composed"] += not in_op
        return composed(*args, **kw)

    monkeypatch.setattr(mcan_attention, "attention", counted_op)
    monkeypatch.setattr(mcan_attention, "attention_composed",
                        counted_composed)
    cfg = small_cfg(hidden_dim=hidden, compute_dtype=dtype)
    model = model_for(cfg, params_for(cfg))
    img, ques = inputs()
    kw = {}
    if case == "train":
        model.train()
        kw = dict(train=True, generator=torch.Generator().manual_seed(3))
    if case == "reference_kernels":
        kw = dict(reference_kernels=True)
    with torch.no_grad():
        logits = model(img, ques, **kw)
    assert torch.isfinite(logits).all()
    per_forward = 3 * cfg.att_num
    assert calls == ({"op": per_forward, "composed": 0} if expect_op
                     else {"op": 0, "composed": per_forward}), calls


def test_the_fused_forward_on_the_cpu_is_the_composed_one():
    """On a CPU tensor the op is the composed form, so the bf16 eval
    forward gives the logits of ``reference_kernels=True`` bit for bit."""
    cfg = small_cfg(compute_dtype="bfloat16")
    model = model_for(cfg, params_for(cfg))
    img, ques = inputs()
    with torch.no_grad():
        assert torch.equal(model(img, ques),
                           model(img, ques, reference_kernels=True))


@pytest.mark.parametrize("lk,tile", [(1, 16), (14, 16), (16, 16), (17, 32),
                                     (64, 64), (100, 128), (196, 208),
                                     (208, 208), (209, 256), (256, 256)])
def test_the_key_tile_is_the_least_instance_that_holds_lk(lk, tile):
    assert mcan_attention.key_tile(lk) == tile
    assert mcan_attention.supported(64, lk)


def test_what_the_op_does_not_take():
    assert not mcan_attention.supported(64, 257)
    assert not mcan_attention.supported(32, 14)
    assert not mcan_attention.supported(128, 14)
    with pytest.raises(ValueError, match="at most 256 keys"):
        mcan_attention.key_tile(257)
    q, k, v, mask = attention_inputs(2, 1, 4, 3, seed=0,
                                     dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        mcan_attention.attention_cuda(q, k, v, mask)


def test_the_op_passes_opcheck():
    q, k, v, mask = attention_inputs(2, 2, 7, 5, seed=1,
                                     dtype=torch.bfloat16)
    torch.library.opcheck(mcan_attention.attention_op, (q, k, v, mask))


def test_the_roofline_metric_reads_the_kernel_a_forward():
    """``port_bench/metrics/mcan_attn_roofline.py``: at MCAN-large's sizes
    and N = 256 the 18 calls move 3.96 GB and do 260 GFLOP, so their bound
    is the bytes' 1.18 ms; a stretch of two forwards (62 norm launches)
    with 2.36 ms of the kernel reads 100%; without the kernel, nothing."""
    import json
    from pathlib import Path
    from types import SimpleNamespace

    from port_bench.harness import load_json, load_module

    root = Path(__file__).resolve().parents[1]
    metric = load_module(root / "port_bench" / "metrics"
                         / "mcan_attn_roofline.py", "metric.mcan_attn")
    counts = load_module(root / "port_bench" / "counts" / "mcan_large.py",
                         "counts.mcan_large")
    fields = json.loads((root / "port_bench" / "configs"
                         / "mcan_large.json").read_text())["fields"]
    peaks = load_json(root / "port_bench" / "peaks.json")
    b = metric.bound(fields, 256)
    assert b["bytes"] == pytest.approx(3.96e9, rel=2e-3)
    assert b["bf16"] == pytest.approx(260e9, rel=2e-3)
    bound_s = b["bytes"] / peaks["hbm_bytes_per_s"]
    assert bound_s == pytest.approx(1.18e-3, rel=3e-3)
    ops = {"void mcan_attention_kernel<208>(CUtensorMap_st)": (
        2 * bound_s * 12 / 18, 24),
        "void mcan_attention_kernel<16>(CUtensorMap_st)": (
            2 * bound_s * 6 / 18, 12),
        "void add_layernorm_kernel<4>(bf16 const*)": (1e-3, 62)}
    run = SimpleNamespace(profile={"ops": ops},
                          cell=SimpleNamespace(config={"fields": fields}),
                          work={"batch": 256}, counts=counts, peaks=peaks)
    assert metric.read(run) == pytest.approx(100.0)
    del ops["void mcan_attention_kernel<208>(CUtensorMap_st)"]
    del ops["void mcan_attention_kernel<16>(CUtensorMap_st)"]
    assert metric.read(run) is None
    assert metric.read(SimpleNamespace(profile=None)) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 reference
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("n,heads,lq,lk", [
    (256, 16, 196, 196), (256, 16, 196, 14), (256, 16, 14, 14),
    (3, 2, 70, 5), (2, 2, 64, 100), (2, 1, 130, 256), (4, 3, 1, 33),
], ids=["grid_self", "guided", "words_self", "ragged_5", "tile_128",
        "tile_256", "one_row"])
def test_the_kernel_rounds_no_more_than_the_composed_form(card, n, heads,
                                                          lq, lk):
    """bf16 in and out, random key masks, sample 0's keys all masked: the
    kernel's largest error against the f32 composed attention is at most
    the composed bf16 form's on the same inputs plus one bf16 ulp of the
    output's magnitude; reruns give the same bits."""
    q, k, v, mask = attention_inputs(n, heads, lq, lk, seed=lq * lk + n,
                                     dtype=torch.bfloat16, device=card)
    before = mcan_attention.launch_count
    got = mcan_attention.attention(q, k, v, mask)
    again = mcan_attention.attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert mcan_attention.launch_count == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again)
    want = mcan_attention.attention_composed(q.float(), k.float(), v.float(),
                                             mask, heads)
    composed = mcan_attention.attention_composed(q, k, v, mask, heads)
    err = float((got.float() - want).abs().max())
    composed_err = float((composed.float() - want).abs().max())
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    assert err <= composed_err + ulp, (err, composed_err, ulp)
    assert torch.isfinite(got.float()).all()


def test_the_kernel_refuses_what_it_does_not_take(card):
    q, k, v, mask = attention_inputs(2, 1, 4, 3, seed=0, device=card)
    with pytest.raises(TypeError, match="bf16"):
        mcan_attention.attention(q, k, v, mask)


def test_the_kernel_is_bit_stable_across_graph_replays(card):
    q, k, v, mask = attention_inputs(256, 16, 196, 196, seed=9,
                                     dtype=torch.bfloat16, device=card)
    eager = mcan_attention.attention(q, k, v, mask)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        mcan_attention.attention(q, k, v, mask)  # warm-up off the graph
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mcan_attention.attention(q, k, v, mask)
    replays = []
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    for r in replays:
        assert torch.equal(r, eager)


def test_an_mcan_forward_launches_the_kernel_18_times(card):
    """Six layers a stack at heads of 64 (d = 128), eval, bf16, on the
    card: 6 encoder, 6 decoder self- and 6 guided attentions."""
    cfg = small_cfg(att_num=6, compute_dtype="bfloat16")
    model = model_for(cfg, params_for(cfg)).to(card)
    img, ques = inputs()
    img, ques = img.to(card), ques.to(card)
    with torch.no_grad():
        for _ in range(2):
            before = mcan_attention.launch_count
            logits = model(img, ques)
            torch.cuda.synchronize()
            assert mcan_attention.launch_count == before + 18
    assert torch.isfinite(logits).all()
    assert mcan.num_heads(cfg.hidden_dim) == 2
