"""``VQA_DISABLE_PALLAS``, the process-wide kill switch, in the port as in
the JAX package (``vqa_attention_networks_tpu/config.py:157``): with it set,
every kernel dispatch takes the composed chain that the JAX dispatch takes,
and no kernel entry of the port is reached. K2's dispatch also reads
``VQA_COMPOSED_TRAIN_FUSION``, as the JAX gate does
(``pallas_train_fusion.py:356``).

On the CPU a dispatch that takes a kernel runs the kernel's plain version,
so "no kernel entry is reached" is checked on the entries themselves: each
kernel's dispatcher, its ``*_cuda`` launch and its plain version are
replaced by a function that raises, and the same call without the switch
must reach one of them (the control).

The eval logits under the switch equal the composed forward's bit for bit:
the same ops on the same values. Against the JAX package under the same
switch (its composed chain) they agree within the files' stated bf16
tolerances (``test_torch_port_mhb_coatt.py``, ``..._hiecoatten.py``).
"""

import types

import numpy as np
import pytest
import torch

import test_torch_port_hiecoatten as hie_t
import test_torch_port_mhb_coatt as mhb_t
from vqa_attention_networks_tpu_torch.models import hiecoatten
from vqa_attention_networks_tpu_torch.models import layers as L
from vqa_attention_networks_tpu_torch.ops import attention as att
from vqa_attention_networks_tpu_torch.ops import coattention as co
from vqa_attention_networks_tpu_torch.ops import grid_fusion as gf
from vqa_attention_networks_tpu_torch.ops import kernels_disabled
from vqa_attention_networks_tpu_torch.ops import lstm
from vqa_attention_networks_tpu_torch.ops import pooled_fusion as pf
from vqa_attention_networks_tpu_torch.ops import train_fusion as tf
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
from vqa_attention_networks_tpu_torch.ops.fusion import (
    grid_fuse_weight_contracted,
)

K = 5


class KernelEntryReached(AssertionError):
    pass


def _block(monkeypatch, module, *names):
    """Make each named entry of ``module`` raise KernelEntryReached."""
    for name in names:
        def entry(*args, _name=name, **kwargs):
            raise KernelEntryReached(f"{module.__name__}.{_name}")
        monkeypatch.setattr(module, name, entry)


@pytest.fixture
def no_kernels(monkeypatch):
    """Every kernel entry of the port raises when reached."""
    _block(monkeypatch, wqf, "stage1_coattention", "stage1_coattention_cuda",
           "stage1_coattention_reference")
    _block(monkeypatch, att, "glimpse_attention_cuda")
    _block(monkeypatch, gf, "inference_fusion_cuda")
    _block(monkeypatch, hiecoatten, "coattention_core")
    _block(monkeypatch, co, "coattention_core", "coattention_core_cuda",
           "coattention_core_reference")
    _block(monkeypatch, tf, "train_grid_fuse", "train_grid_fuse_reference",
           "forward_cuda", "d_w_cuda", "d_q_cuda", "d_img_cuda")
    _block(monkeypatch, pf, "pooled_grid_fuse", "pooled_grid_fuse_reference")
    _block(monkeypatch, lstm, "lstm_scan_cuda")
    return monkeypatch


def test_the_switch_is_read_at_each_call(monkeypatch):
    monkeypatch.delenv("VQA_DISABLE_PALLAS", raising=False)
    assert not kernels_disabled()
    monkeypatch.setenv("VQA_DISABLE_PALLAS", "1")
    assert kernels_disabled()
    monkeypatch.setenv("VQA_DISABLE_PALLAS", "")
    assert not kernels_disabled()  # as os.environ.get reads it in JAX


@pytest.mark.parametrize("glimpse", [False, True],
                         ids=["default", "glimpse_switch"])
def test_mhb_coatt_eval_under_the_switch_is_the_composed_forward(
        no_kernels, glimpse):
    cfg = mhb_t.small_cfg(compute_dtype="bfloat16")
    params = mhb_t.params_for(cfg, seed=5)
    img, ques = mhb_t.inputs_for(cfg, seed=6)
    if glimpse:
        no_kernels.setenv("VQA_PALLAS_GLIMPSE", "1")
    # control: without the switch the default path reaches K1's entry
    no_kernels.delenv("VQA_DISABLE_PALLAS", raising=False)
    with pytest.raises(KernelEntryReached, match="stage1_coattention"):
        mhb_t.port_logits(cfg, params, img, ques)
    composed = mhb_t.port_logits(cfg.replace(fast_path="composed"), params,
                                 img, ques)
    no_kernels.setenv("VQA_DISABLE_PALLAS", "1")
    got = mhb_t.port_logits(cfg, params, img, ques)
    assert np.array_equal(got, composed)
    # ... and it is the JAX package's chain under the same switch
    want = mhb_t.jax_logits(cfg, params, img, ques)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=mhb_t.BF16_LOGIT_ATOL)


def test_mhb_coatt_composed_with_k5_switch_under_the_kill_switch(no_kernels):
    # VQA_FORCE_PALLAS opens K5 on the composed path; under the kill switch
    # the JAX dispatch falls to its f32 composed chain (pallas_fusion.py:
    # 267-278), and so does the port: grid_fuse_reference, not K5
    cfg = mhb_t.small_cfg(compute_dtype="bfloat16", fast_path="composed")
    params = mhb_t.params_for(cfg, seed=7)
    img, ques = mhb_t.inputs_for(cfg, seed=8)
    no_kernels.setenv("VQA_FORCE_PALLAS", "1")
    no_kernels.setenv("VQA_DISABLE_PALLAS", "1")
    got = mhb_t.port_logits(cfg, params, img, ques)
    want = mhb_t.jax_logits(cfg, params, img, ques)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=mhb_t.BF16_LOGIT_ATOL)


def _hie_composed(model, img, ques):
    """hieCoAtten's composed eval chain (``hiecoatten.py:105-136`` of the
    JAX package) at bf16, written out with the model's layers."""
    dt = torch.bfloat16
    with torch.inference_mode():
        v_emb = torch.relu(model.img_emb(img.to(dt)))
        q_emb = model.que_emb(ques, dt)
        c = torch.tanh(torch.matmul(model.fc_Wbq(q_emb),
                                    model.fc_Wbv(v_emb).transpose(1, 2)))
        img_w, que_w = model.fc_Wv(v_emb), model.fc_Wq(q_emb)
        hv = torch.tanh(img_w + torch.matmul(c.transpose(1, 2), que_w))
        av = torch.softmax(model.fc_Whv(hv), dim=1)[..., 0]
        hq = torch.tanh(que_w + torch.matmul(c, img_w))
        aq = torch.softmax(model.fc_Whq(hq), dim=1)[..., 0]
        v = torch.matmul(av[:, None, :], v_emb)[:, 0]
        q = torch.matmul(aq[:, None, :], q_emb)[:, 0]
        return model.fc(torch.cat([v, q], dim=-1)).float().numpy()


def test_hiecoatten_eval_under_the_switch_is_the_composed_chain(no_kernels):
    cfg = hie_t.small_cfg(compute_dtype="bfloat16")
    params = hie_t.params_for(cfg, seed=2)
    img, ques = hie_t.inputs_for(cfg, seed=3)
    model = hie_t.port_model(cfg, params)
    ti, tq = torch.from_numpy(img), torch.from_numpy(ques)
    no_kernels.delenv("VQA_DISABLE_PALLAS", raising=False)
    with pytest.raises(KernelEntryReached, match="coattention_core"):
        model(ti, tq)
    no_kernels.setenv("VQA_DISABLE_PALLAS", "1")
    with torch.inference_mode():
        got = model(ti, tq).numpy()
    assert np.array_equal(got, _hie_composed(model, ti, tq))
    want, _ = hie_t.jax_apply(cfg, params, img, ques)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=hie_t.BF16_LOGIT_ATOL)


def _fusion_inputs(seed=0, n=3, l=12, d=48, o=8):
    rng = np.random.default_rng(seed)

    def t(shape, scale, dtype=torch.float32):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dtype)

    return (t((n, l, d), 0.5, torch.bfloat16), t((d, o * K), 0.2),
            t((o * K,), 0.05), t((n, o * K), 0.5, torch.bfloat16))


@pytest.mark.parametrize("switch", ["VQA_DISABLE_PALLAS",
                                    "VQA_COMPOSED_TRAIN_FUSION"])
def test_k2_training_dispatch_takes_the_composed_chain(no_kernels, switch):
    img, w, b, q = _fusion_inputs(seed=1)
    kw = dict(train=True, rate=0.1, site="prepool", seed=9)
    no_kernels.delenv("VQA_DISABLE_PALLAS", raising=False)
    no_kernels.delenv("VQA_COMPOSED_TRAIN_FUSION", raising=False)
    with pytest.raises(KernelEntryReached, match="train_grid_fuse"):
        gf.grid_fuse(img, w, b, q, K, **kw)
    no_kernels.setenv(switch, "1")
    got = gf.grid_fuse(img, w, b, q, K, generator=torch.Generator()
                       .manual_seed(4), **kw)
    # the composed chain, its pre-pool dropout drawn from the generator
    want = gf.grid_fuse_reference(img, w, b, q, K, rate=0.1,
                                  generator=torch.Generator().manual_seed(4))
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_k3_training_dispatch_takes_the_composed_chain(no_kernels):
    img, w, b, q = _fusion_inputs(seed=2)
    kw = dict(train=True, rate=0.3, site="pooled")
    no_kernels.delenv("VQA_DISABLE_PALLAS", raising=False)
    with pytest.raises(KernelEntryReached, match="pooled_grid_fuse"):
        gf.grid_fuse(img, w, b, q, K, **kw)
    no_kernels.setenv("VQA_DISABLE_PALLAS", "1")
    got = gf.grid_fuse(img, w, b, q, K, generator=torch.Generator()
                       .manual_seed(5), **kw)
    # fusion.py:181-200: the weight-contracted chain, then the dropout
    want = L.dropout(grid_fuse_weight_contracted(img, w, b, q, K), 0.3, True,
                     torch.Generator().manual_seed(5))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("site", ["prepool", "pooled"])
def test_mhb_coatt_training_forward_under_the_switch(no_kernels, site):
    cfg = mhb_t.small_cfg(compute_dtype="bfloat16", dropout_site=site)
    params = mhb_t.params_for(cfg, seed=9)
    img, ques = mhb_t.inputs_for(cfg, seed=10)
    model = mhb_t.load_jax_params(mhb_t.get_model(cfg.model_name)(
        mhb_t.port_config(cfg)), params)

    def step():
        logits = model(torch.from_numpy(img), torch.from_numpy(ques),
                       train=True, generator=torch.Generator().manual_seed(0),
                       fusion_seed=3)
        logits.sum().backward()
        return logits

    no_kernels.delenv("VQA_DISABLE_PALLAS", raising=False)
    with pytest.raises(KernelEntryReached):
        step()
    model.zero_grad()
    no_kernels.setenv("VQA_DISABLE_PALLAS", "1")
    logits = step()
    assert torch.isfinite(logits).all()
    grad = model.img_conv1d.weight.grad
    assert grad is not None and torch.isfinite(grad).all() and grad.any()


def test_k8_gate_is_closed_under_the_switch(monkeypatch):
    # the gate reads the tensor's device, dtype and shape, and the card's
    # SM count: a stand-in for a bf16 CUDA tensor and an H100's count need
    # no card
    x = types.SimpleNamespace(device=torch.device("cuda"),
                              dtype=torch.bfloat16, shape=(256, 22, 300))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(
                            multi_processor_count=lstm.H100_SMS))
    monkeypatch.delenv("VQA_DISABLE_PALLAS", raising=False)
    assert lstm.supported(x, 1024)
    assert not lstm.supported(x, 1000)
    # H % 128 == 0, but W_hh's slice does not fit in a block's shared memory
    assert not lstm.supported(x, 2048)
    monkeypatch.setenv("VQA_DISABLE_PALLAS", "1")
    assert not lstm.supported(x, 1024)
