"""BAN-8's files of the benchmark: its count of operations against a hand
count at the published widths, N3's bound (424 MB at N = 256), the two
readers of its per-layer metrics on a profile made up here, and the layout
of the two cells this configuration's change added (``ban8.serve_byid``,
``hiecoatten.serve_byid``)."""

import json
import types

import pytest

from conftest import ROOT

BAN8 = json.loads((ROOT / "port_bench" / "configs" / "ban8.json")
                  .read_text())["fields"]
CELLS = ("ban8.serve_byid", "hiecoatten.serve_byid")
SERVE_METRICS = ("serve_qa_pairs_per_s", "serve_p95_ms", "device_idle.serve",
                 "mfu.serve", "dispatch_ms.serve", "result_wait_ms.serve",
                 "bank_ensure_ms", "graph_replay_share.serve")


def load(kind, name):
    from port_bench import harness

    return harness.load_module(ROOT / "port_bench" / kind / f"{name}.py",
                               f"{kind}.{name}")


def peaks():
    from port_bench import harness

    return harness.load_json(ROOT / "port_bench" / "peaks.json")


def test_serve_flops_at_the_published_widths_by_hand():
    """T 14, L 196, D 2,048, H 1,280 (kH 3,840), E 300, G 8, A 3,129:
    12.28 GFLOP a question, three quarters of it the glimpses' grid
    projections and BiAttention's."""
    counts = load("counts", "ban8")
    t, l, d, h, e, g, a = 14, 196, 2048, 1280, 300, 8, 3129
    kh = 3 * h
    by_hand = (2 * t * (2 * e + h) * 3 * h          # GRU
               + 2 * l * d * kh + 2 * t * h * kh    # BiAttention's
               + 2 * g * t * l * kh                 # the map S
               + g * (2 * l * d * h + 2 * t * h * h)  # glimpse projections
               + g * (2 * t * l * h + 2 * t * h)    # pools
               + g * 2 * h * h                      # q_prj
               + 2 * h * 2 * h + 2 * 2 * h * a)     # classifier
    assert counts.serve_flops(BAN8) == by_hand
    assert by_hand == pytest.approx(12.28e9, rel=1e-3)
    assert counts.gemm(BAN8, 256)["bf16"] == 256 * (
        by_hand - 2 * g * t * l * kh - g * 2 * t * h)


def test_n3_bound_at_n256():
    """av 385 MB, aq 27.5 MB, P 11.2 MB (bf16), h and the mask: 424 MB,
    0.127 ms at 3.35 TB/s; its 43.2 GFLOP take 0.044 ms at the bf16 peak."""
    from port_bench.harness import bound_s

    op = load("counts", "ban8").attention(BAN8, 256)
    moved = (2 * 256 * 196 * 3840 + 2 * 256 * 14 * 3840
             + 2 * 256 * 8 * 196 * 14 + 4 * 8 * 3840 + 256 * 196)
    assert op["bytes"] == moved == pytest.approx(424.3e6, rel=1e-3)
    assert op["bf16"] == pytest.approx(43.16e9, rel=1e-3)
    assert bound_s(op, peaks()) * 1e3 == pytest.approx(0.1267, abs=1e-4)


def _run(ops, batch=256):
    """A made-up run of the BAN cell: its profile's device operations
    ``ops`` (name -> (seconds, launches))."""
    cell = types.SimpleNamespace(config={"fields": BAN8})
    return types.SimpleNamespace(
        profile={"ops": ops}, cell=cell, work={"batch": batch},
        counts=load("counts", "ban8"), peaks=peaks())


def test_the_two_readers_on_a_made_up_profile():
    """Two forwards (two N3 launches) of 0.2 ms of N3 each and 6 ms of GEMM
    kernels each: N3 at its bound over 0.2 ms, the products at theirs over
    6 ms; N3 itself, a flash kernel and K2's own product are not GEMMs."""
    from port_bench.harness import bound_s

    attn = load("metrics", "ban_attn_roofline")
    gemm = load("metrics", "ban_gemm_roofline")
    counts = load("counts", "ban8")
    ops = {"(anonymous namespace)::ban_attention_kernel(CUtensorMap_st)":
           (4e-4, 2),
           "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT": (8e-3, 24),
           "cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64": (4e-3, 16),
           "flash_fwd_kernel": (1.0, 2), "d_w_gemm_kernel": (1.0, 2),
           "void at::native::vectorized_elementwise_kernel": (1.0, 90)}
    want = bound_s(counts.attention(BAN8, 256), peaks()) / 2e-4 * 100
    assert attn.read(_run(ops)) == pytest.approx(want)
    assert 60 < want < 65
    want = bound_s(counts.gemm(BAN8, 256), peaks()) / 6e-3 * 100
    assert gemm.read(_run(ops)) == pytest.approx(want)
    # no N3 in the stretch (the composed map, or a port without it)
    del ops["(anonymous namespace)::ban_attention_kernel(CUtensorMap_st)"]
    assert attn.read(_run(ops)) is None and gemm.read(_run(ops)) is None
    untraced = types.SimpleNamespace(profile=None)
    assert attn.read(untraced) is None and gemm.read(untraced) is None


def test_the_new_cells_files_and_entries():
    """Each cell's file names its configuration, the by-id traffic and one
    chip, as BENCHMARK.json does; its limits are the serving numbers and
    its fault the altered answer; both cells report the by-id serving
    metrics, and BAN's two roofline metrics read the BAN cell alone."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for name in CELLS:
        spec = json.loads((ROOT / "port_bench" / "workloads"
                           / f"{name}.json").read_text())
        assert {k: spec[k] for k in ("config", "traffic", "chips")} == {
            "config": name.split(".")[0], "traffic": "serve_byid",
            "chips": 1} == {k: entries[name][k]
                            for k in ("config", "traffic", "chips")}
        assert set(spec["limits"]) <= {"logit_err", "answer_gap"}
        assert "logit_err" in spec["limits"]
        assert spec["faults"] == ["alter_answer"]
        for m in SERVE_METRICS:
            assert name in metrics[m]["workloads"], (name, m)
    for m in ("ban_attn_roofline", "ban_gemm_roofline"):
        assert metrics[m]["workloads"] == ["ban8.serve_byid"]
        assert metrics[m]["moves"] == "serve_qa_pairs_per_s"
    config = next(c for c in bench["configs"] if c["name"] == "ban8")
    assert config["file"] == "port_bench/configs/ban8.json"
    assert config["reduced"] == []
