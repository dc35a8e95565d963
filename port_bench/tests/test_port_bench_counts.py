"""The counting files against hand-worked operations and bytes, at the
published widths and at a small shape."""

import pytest

from conftest import ROOT

FULL = dict(max_question_length=22, img_feature_dim=196,
            img_feature_channel=2048, hidden_dim=1024, emb_dim=300,
            mfb_factor=5, mfb_out=1000, a_vocab_size=1000, embed_size=512)
SMALL = dict(max_question_length=2, img_feature_dim=3, img_feature_channel=4,
             hidden_dim=2, emb_dim=1, mfb_factor=2, mfb_out=3,
             a_vocab_size=5, embed_size=2)


def module(name):
    from port_bench import harness

    return harness.load_module(ROOT / "port_bench" / "counts" / f"{name}.py",
                               "counts." + name)


def peaks():
    from port_bench import harness

    return harness.load_json(ROOT / "port_bench" / "peaks.json")


def test_k2_product_and_bounds_at_n64():
    from port_bench.harness import bound_s

    k2 = module("mhb_coatt").k2(FULL, 64)
    # 2 N L D F = 2 * 64 * 196 * 2048 * 5000
    assert k2["forward"]["bf16"] == 2 * 64 * 196 * 2048 * 5000 \
        == pytest.approx(257e9, rel=1e-3)
    assert k2["d_w"]["bf16"] == k2["d_q"]["bf16"] == k2["forward"]["bf16"]
    # the g_prod build is bound by its bytes: g and out (f32 [N, L, O]),
    # q (f32 [N, F]), g_prod (bf16 [N*L, F]) and the d_b partials
    # (f32 [ceil(N*L / 64), F])
    g_bytes = 2 * 4 * 64 * 196 * 1000 + 4 * 64 * 5000 + 2 * 64 * 196 * 5000 \
        + 4 * 196 * 5000
    assert k2["g_prod"]["bytes"] == g_bytes
    total = sum(bound_s(op, peaks()) for op in k2.values())
    assert total == pytest.approx(3 * 257e9 / 989e12 + g_bytes / 3.35e12,
                                  rel=1e-3)
    assert total * 1e3 == pytest.approx(0.85, abs=0.005)


def test_k1_bound_at_n256():
    from port_bench.harness import bound_s

    k1 = module("mhb_coatt").k1(FULL, 256)
    bf16 = 2 * 256 * 196 * (2048 * 1000 + 1000 * 512 + 512 * 2 + 2 * 2048)
    f32 = 2 * 256 * 5 * 2048 * 1000  # the per-question contracted weights
    assert k1["bf16"] == bf16 and k1["f32"] == f32
    assert bound_s(k1, peaks()) * 1e3 == pytest.approx(0.339, abs=5e-4)


def test_small_shape_by_hand():
    m = module("mhb_coatt")
    # T=2, L=3, D=4, H=2, E=1, k=2, O=3, F=6, A=5; c=512, g=2
    k1 = m.k1(SMALL, 1)
    assert k1["bf16"] == 2 * 3 * (4 * 3 + 3 * 512 + 512 * 2 + 2 * 4)
    assert k1["f32"] == 2 * 2 * 4 * 3
    question = 2 * 2 * (1 + 2) * 8 + (2 * 2 * 2 * 512 + 2 * 2 * 512 * 2
                                      + 2 * 2 * 2 * 2) + 2 * 4 * 6
    output = 2 * (2 * 4 * 6 + 2 * 8 * 6) + 2 * 6 * 5
    assert m.serve_flops(SMALL) == question + k1["bf16"] + k1["f32"] + output
    coatt = 2 * 3 * 3 * 512 + 2 * 3 * 512 * 2 + 2 * 3 * 2 * 4
    assert m.train_flops(SMALL) == 3 * (question + coatt + output) \
        + 3 * 2 * 3 * 4 * 6
    h = module("hiecoatten")
    assert h.serve_flops(SMALL) == (2 * 3 * 4 * 2 + 2 * (2 * 3 * 2 * 2)
                                    + 2 * (2 * 2 * 2 * 2) + 3 * (2 * 2 * 3 * 2)
                                    + 2 * (2 * 3 * 2) + 2 * (2 * 2 * 2)
                                    + 2 * 2 * 2 * 5)


def test_full_width_flops():
    m = module("mhb_coatt")
    assert m.serve_flops(FULL) == pytest.approx(1.435e9, rel=1e-3)
    assert m.train_flops(FULL) == pytest.approx(13.88e9, rel=1e-3)
    assert module("hiecoatten").serve_flops(FULL) == pytest.approx(
        0.6554e9, rel=1e-3)
