"""Parity of the port's K8 entry (vqa_attention_networks_tpu_torch/ops/
lstm.py ``lstm_seq``) against the JAX package's ``pallas_lstm.lstm_seq``,
whose scan kernel runs in interpret mode on the CPU.

The weights travel as a JAX parameter tree through
``weights.load_jax_params`` into a module holding a ``layers.LSTM``, and
the port's entry takes them in that module's (PyTorch) layout. The port's
plain scan keeps the kernel's rounding points (bf16 xp and h, f32 gates and
c). What can still differ is f32 rounding: the order of the recurrent
product's sums, and XLA's sigmoid and tanh against PyTorch's. That moves an
h at a bf16 rounding boundary by one ulp, and the flip feeds the later
steps through W_hh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from vqa_attention_networks_tpu.ops.pallas_lstm import lstm_seq as jax_lstm_seq
from vqa_attention_networks_tpu_torch.models import layers as L
from vqa_attention_networks_tpu_torch.ops import lstm
from vqa_attention_networks_tpu_torch.weights import load_jax_params


class _Holder(nn.Module):
    def __init__(self, e, h):
        super().__init__()
        self.lstm = L.LSTM(e, h)


def _params(seed, e, h):
    """A JAX-layout LSTM tree whose gate pre-activations lie mostly off the
    sigmoid's flat tails (|x| of a few units)."""
    rng = np.random.default_rng(seed)
    return {
        "w_ih": (rng.standard_normal((e, 4 * h)) / np.sqrt(e)).astype(
            np.float32),
        "w_hh": (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(
            np.float32),
        "b_ih": (rng.standard_normal(4 * h) * 0.1).astype(np.float32),
        "b_hh": (rng.standard_normal(4 * h) * 0.1).astype(np.float32),
    }


def _x(seed, n, t, e):
    x = np.random.default_rng(seed).standard_normal((n, t, e))
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _port(p, x, dtype=torch.bfloat16, nb=None):
    e, four_h = p["w_ih"].shape
    m = load_jax_params(_Holder(e, four_h // 4), {"lstm": p}).lstm
    with torch.no_grad():
        return lstm.lstm_seq(torch.from_numpy(x).to(dtype), m.weight_ih,
                             m.weight_hh, m.bias_ih, m.bias_hh, nb=nb)


def _jax(p, x, dtype=jnp.bfloat16, nb=None):
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    out = jax_lstm_seq(pj, jnp.asarray(x, dtype), interpret=True, nb=nb)
    return np.asarray(out.astype(jnp.float32))


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


# Held per element at two bf16 ulps of the JAX value plus 2^-9 (a few
# ulps of h's typical size, ~0.3): a one-ulp flip of h at one step moves the
# next gates by |W_hh| * ulp(h), and through c the later h by a fraction of
# an ulp. Most elements must be bit-equal.
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lstm_seq_matches_pallas_kernel_interpret(dtype):
    n, t, e, h = 8, 5, 16, 128
    p, x = _params(0, e, h), _x(1, n, t, e)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16"
                else (jnp.float32, torch.float32))
    want = _jax(p, x, jdt)
    before = lstm.launch_count
    got = _port(p, x, tdt)
    assert lstm.launch_count == before  # a CPU tensor takes the plain scan
    assert got.dtype == tdt and got.shape == want.shape == (n, t, h)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= 2 * _bf16_ulp(want) + 2.0 ** -9).all()
    if dtype == "bfloat16":
        assert (got == want).mean() >= 0.9
    else:  # out is the f32 h: all but f32 rounding
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_lstm_seq_is_not_the_composed_scan():
    # control: the composed layers.lstm keeps the gates and c in bf16, and
    # the parity above tells it from the kernel's f32 gates and c
    n, t, e, h = 8, 5, 16, 128
    p, x = _params(2, e, h), _x(3, n, t, e)
    want = _jax(p, x)
    m = load_jax_params(_Holder(e, h), {"lstm": p}).lstm
    with torch.no_grad():
        composed = m(torch.from_numpy(x).to(torch.bfloat16)).float().numpy()
    assert (composed != want).mean() > 0.2


def test_lstm_seq_carry_resets_between_batch_tiles():
    # tests/test_pallas_lstm.py:28-39: two batch tiles, the second tile's
    # rows must not see the first's final state
    n, t, e, h = 16, 4, 8, 128
    p, x = _params(4, e, h), _x(5, n, t, e)
    full = _port(p, x, nb=8).float().numpy()
    half = _port(p, x[8:], nb=8).float().numpy()
    np.testing.assert_allclose(full[8:], half, atol=1e-4, rtol=1e-3)
    want = _jax(p, x, nb=8)
    assert (np.abs(full - want) <= 2 * _bf16_ulp(want) + 2.0 ** -9).all()


def test_explicit_nondividing_nb_is_rejected():
    p = _params(6, 8, 16)
    x = np.zeros((6, 4, 8), np.float32)
    with pytest.raises(ValueError, match="does not divide"):
        _jax(p, x, jnp.float32, nb=4)  # the JAX contract ...
    with pytest.raises(ValueError, match="does not divide"):
        _port(p, x, torch.float32, nb=4)  # ... and the port's
    assert _port(p, x, torch.float32, nb=3).shape == (6, 4, 16)


def test_input_projection_rounds_as_jax():
    # x @ W_ih rounded to bf16, then + bf16(b_ih + b_hh) in bf16
    # (pallas_lstm.py:142-145)
    e, h = 16, 128
    p, x = _params(7, e, h), _x(8, 4, 3, e)
    want = np.asarray((jnp.dot(jnp.asarray(x, jnp.bfloat16),
                               jnp.asarray(p["w_ih"], jnp.bfloat16),
                               preferred_element_type=jnp.bfloat16)
                       + jnp.asarray(p["b_ih"] + p["b_hh"], jnp.bfloat16))
                      .astype(jnp.float32))
    m = load_jax_params(_Holder(e, h), {"lstm": p}).lstm
    got = lstm.input_projection(torch.from_numpy(x).to(torch.bfloat16),
                                m.weight_ih, m.bias_ih, m.bias_hh)
    assert got.dtype == torch.bfloat16
    got = got.float().detach().numpy()
    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    assert (got == want).mean() >= 0.95


def test_kernel_gate_and_cuda_wrapper_refuse_the_cpu():
    x = torch.zeros(2, 3, 512, dtype=torch.bfloat16)
    assert not lstm.supported(x, 128)  # a CPU tensor never takes the kernel
    with pytest.raises(ValueError, match="CUDA"):
        lstm.lstm_scan_cuda(x, torch.zeros(512, 128),
                            torch.zeros(512, dtype=torch.bfloat16))


def test_plain_scan_fed_a_carry():
    # the card's step-by-step check feeds the plain scan another run's h
    # carry: fed its own output it is unchanged; fed a carry shifted by one
    # step, each step but the first moves
    n, t, e, h = 4, 6, 16, 128
    p, x = _params(9, e, h), _x(10, n, t, e)
    m = load_jax_params(_Holder(e, h), {"lstm": p}).lstm
    with torch.no_grad():
        xp = lstm.input_projection(torch.from_numpy(x).to(torch.bfloat16),
                                   m.weight_ih, m.bias_ih, m.bias_hh)
        free = lstm.lstm_scan_reference(xp, m.weight_hh)
        assert torch.equal(
            lstm.lstm_scan_reference(xp, m.weight_hh, h_carry=free), free)
        shifted = torch.cat([torch.zeros_like(free[:, :1]), free[:, :-1]], 1)
        fed = lstm.lstm_scan_reference(xp, m.weight_hh, h_carry=shifted)
    assert torch.equal(fed[:, 0], free[:, 0])
    assert (fed[:, 1:] != free[:, 1:]).float().mean() > 0.9


# The persistent kernel's geometry (ops/lstm.py ``geometry``): at
# mhb_coAtt's H = 1024 every N fits one block per SM on an H100 (132 SMs,
# 232,448 bytes of shared memory a block), so the cooperative launch can
# hold all blocks at once; a block walks its rows in tiles of 128.
@pytest.mark.parametrize("n", [8, 256, 1024, 2048, 4096])
def test_k8_geometry_fits_one_block_per_sm(n):
    t, h = 22, 1024
    geo = lstm.geometry(n, t, h)
    assert geo.blocks <= lstm.H100_SMS
    assert geo.smem_bytes <= lstm.SM90_SMEM_PER_BLOCK == 227 * 1024
    assert geo.units_per_block == lstm.UNITS
    unit_tiles = h // geo.units_per_block
    groups = geo.blocks // unit_tiles
    assert geo.blocks == unit_tiles * groups
    # every row in exactly one group, no group empty
    assert (groups - 1) * geo.rows_per_block < n <= groups * geo.rows_per_block
    assert geo.barriers == t - 1
    # W_hh's 4 x 16 gate rows (bf16, padded by 8) sit in shared memory
    assert geo.smem_bytes >= 4 * geo.units_per_block * h * 2
    # as many row groups as the SMs allow once there are rows for them
    assert groups == (1 if n <= 32 else 2)
    # c in shared memory up to N = 1,408 at H = 1024, then in device memory
    assert geo.c_in_smem == (n <= 1024)


@pytest.mark.parametrize("h", [96, 1000])
def test_k8_geometry_refuses_h_not_a_multiple_of_128(h):
    with pytest.raises(ValueError, match="H % 128"):
        lstm.geometry(8, 22, h)


def test_k8_geometry_refuses_more_shared_memory_than_a_block_has():
    # W_hh's slice and 3 stages of the ring fit up to H = 1280
    with pytest.raises(ValueError, match="shared memory"):
        lstm.geometry(8, 22, 1408)
    with pytest.raises(ValueError, match="shared memory"):
        lstm.geometry(8, 22, 2048)
    with pytest.raises(ValueError, match="SMs"):
        lstm.geometry(8, 22, 4096)


@pytest.mark.parametrize("h", range(128, 1281, 128))
def test_k8_geometry_takes_every_h_up_to_1280(h):
    # past what shared memory holds, c moves to device memory: any N runs
    geo = lstm.geometry(65536, 22, h)
    assert geo.smem_bytes <= lstm.SM90_SMEM_PER_BLOCK
    assert geo.blocks <= lstm.H100_SMS and geo.stages >= 3
    assert not geo.c_in_smem
    assert lstm.geometry(8, 22, h).c_in_smem


@pytest.mark.parametrize("shape,pad", [((3, 5, 300), 4), ((16, 300), 4),
                                       ((2, 30), 2), ((4, 7, 12), 4)])
def test_projection_padding_is_zeros(shape, pad):
    # on the card the projection pads E of x and W_ih to a multiple of 8:
    # the same values, then zeros
    rng = np.random.default_rng(11)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16) for s in (shape, (8, shape[-1])))
    got_x, got_w = lstm._aligned(x, w)
    assert pad == -shape[-1] % 8
    assert got_x.dtype == x.dtype and got_x.shape == (*shape[:-1],
                                                      shape[-1] + pad)
    assert got_w.shape == (8, shape[-1] + pad)
    for got, raw in ((got_x, x), (got_w, w)):
        assert torch.equal(got[..., :shape[-1]], raw)
        assert not got[..., shape[-1]:].any()
