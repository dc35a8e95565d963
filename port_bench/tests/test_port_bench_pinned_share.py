"""``h2d_pinned_share.serve`` reads the port's counters: 100 where every
copied byte came from page-locked memory, None where the counter is absent
(a port that keeps none, as before the counter)."""

import pytest
from torch.profiler import ProfilerActivity, profile

from conftest import ROOT


def share():
    from port_bench.harness import load_module

    return load_module(ROOT / "port_bench" / "metrics"
                       / "h2d_pinned_share.serve.py",
                       "h2d_pinned_share").read(None)


@pytest.fixture
def trace():
    from vqa_attention_networks_tpu_torch.utils import trace

    trace.reset()
    yield trace
    trace.reset()


def test_a_pinned_feed_reads_100(trace):
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            trace.count("serve.h2d_bytes", 205_520_896)
            trace.count("serve.h2d_pinned_bytes", 205_520_896)
    assert share() == 100.0


def test_a_part_pinned_feed_reads_its_share(trace):
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("serve.h2d_bytes", 400)
        trace.count("serve.h2d_pinned_bytes", 100)
    assert share() == 25.0


def test_no_counter_reads_none(trace):
    assert share() is None
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("serve.h2d_bytes", 205_520_896)
    assert share() is None
