"""The per-layer metrics that read the program's own counters, on the CPU
runs of their cells at small sizes: each reads a value (those that need a
capture, which the CPU has not, read nothing), the slot ratio of a
single-graph cell is its walks a call times V_pad x D over the non-zero
slots and repeats across seeds, and a program without the counters gives
nothing and raises nothing.

    python -m pytest perfbench/tests
"""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH / "tests"), str(BENCH.parent / "src")]

import harness  # noqa: E402
import program_counters  # noqa: E402
from repro_torch import trace  # noqa: E402
from test_perfbench_harness import tiny_run  # noqa: E402

#: the metrics that read the counters, and what a CPU run reads of them
COUNTED = {
    "gcn-reddit-bin.score": {"agg_slots_per_nnz.score", "setup_bind_s.score",
                             "setup_batching_s.score"},
    "gcn-cora.train": {"agg_slots_per_nnz.train"},
    "gcn-cora.refresh": {"agg_slots_per_nnz.refresh"},
}
#: read only where the program captures CUDA graphs
CARD_ONLY = {"replay_copy_mb.score", "setup_capture_s.score"}
#: padded-ELL walks a call: train walks layers 0 and 1 forward and layer 1
#: back; refresh runs layer 0 on the fused kernel, layer 1 on the eager tier
WALKS = {"gcn-cora.train": 3, "gcn-cora.refresh": 1}


def counter_metrics(workload):
    return {m["name"] for m in harness.Benchmark().metrics("per_layer", workload)
            if m["source"] == "program_counter"}


@pytest.fixture
def fresh_counters(monkeypatch):
    """This process's counters from zero, as a run of the harness has them."""
    monkeypatch.setattr(trace, "_COUNTS", {})


@pytest.mark.parametrize("workload", sorted(COUNTED))
def test_each_counter_metric_reads_its_cell(workload, tmp_path, fresh_counters):
    assert counter_metrics(workload) == COUNTED[workload] | (
        CARD_ONLY if workload == "gcn-reddit-bin.score" else set())
    r = tiny_run(workload, tmp_path, trace=True)
    assert r["correct"] is True
    read = {k: v["value"] for k, v in r["metrics"].items() if k in counter_metrics(workload)}
    assert set(read) == COUNTED[workload]
    assert all(v > 0 for v in read.values())


@pytest.mark.parametrize("workload", sorted(WALKS))
def test_the_slot_ratio_is_the_walks_of_a_call_and_repeats(workload, tmp_path, monkeypatch):
    """On the CPU nothing is captured, so no warm-up walks beside the calls:
    the ratio is exactly the walks a call times V_pad x D over the non-zero
    slots, on every seed."""
    from repro_torch.graphs.csr import from_edges

    jobs, make = [], harness.job_class

    def keeping(kind):
        class Kept(make(kind)):
            def setup(self):
                jobs.append(self)
                super().setup()

        return Kept

    monkeypatch.setattr(harness, "job_class", keeping)
    metric = f"agg_slots_per_nnz.{workload.split('.')[1]}"
    ratios = []
    for seed in (2**31 + 3, 7):
        monkeypatch.setattr(trace, "_COUNTS", {})
        ratios.append(tiny_run(workload, tmp_path, seed=seed, trace=True)["metrics"][metric]["value"])
    stats, d = jobs[0].stats, from_edges(*jobs[0].edges).max_degree
    assert ratios == [WALKS[workload] * stats.v_pad * d / stats.nnz] * 2


def test_without_the_counters_nothing_is_read(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)  # import fails
    assert program_counters.counters() == {}
    assert program_counters.value("setup.bind_s") is None
    assert program_counters.ratio("agg.slots", "ell.nonzero") is None
