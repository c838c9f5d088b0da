"""The port's counters and spans (``repro_torch.trace``) on the CPU: a
capture's tally, the eager tier's slot walks and the adjacency's non-zero
slots a call, the set-up counters, and the spans under ``torch.profiler``.
The replays' counts need a card (``tests/test_torch_cuda.py``)."""
import ast
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch
from repro_torch import trace
from repro_torch.core.schedule import ModelSchedule
from repro_torch.gnn import GNNConfig, make_node_classification_task
from repro_torch.graphs import BucketPolicy, assemble, bucketize, from_edges

SRC = Path(repro_torch.__file__).resolve().parent
#: the benchmark's own span names (``perfbench/harness.py``, a job's ``span``)
BENCHMARK_SPANS = {"window", "run", "train_step", "sync", "call"}


def counted_since(before: dict) -> dict:
    after = trace.counters()
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def graph(v=90, seed=0):
    rng = np.random.default_rng(seed)
    return from_edges(v, rng.integers(0, v, 3 * v), rng.integers(0, v, 3 * v))


def program(kind="gcn", policy="sp_opt", order="AC", use_pallas=False, v=90):
    dims = [(12, 16), (16, 4)]
    g = graph(v)
    cfg = GNNConfig(kind=kind, f_in=12, hidden=16, n_classes=4, use_pallas=use_pallas)
    prog = repro_torch.compile(cfg, graph=g, device="cpu",
                               schedule=ModelSchedule.from_policies(policy, order, dims))
    return prog, prog.init(torch.Generator().manual_seed(0)), g


def fake_wrapper():
    def kernel():
        trace.count_launch(kernel)

    kernel.launches = 0
    return kernel


def test_under_a_tally_counts_go_to_it_and_each_replay_adds_it():
    k = fake_wrapper()
    before = trace.counters()
    trace.count("test.units", 2)
    k()
    with trace.launch_tally() as tally:
        trace.count("test.units", 3)
        k()
        k()
    assert counted_since(before) == {"test.units": 2}
    assert tally == {"test.units": 3, k: 2} and k.launches == 1
    trace.add_launches(tally)
    trace.add_launches(tally)
    assert counted_since(before) == {"test.units": 8}
    assert k.launches == 5


def test_another_threads_counts_are_not_tallied():
    before = trace.counters()
    done = threading.Event()

    def other():
        trace.count("test.other", 4)
        done.set()

    with trace.launch_tally() as tally:
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
        trace.count("test.mine")
    assert done.is_set() and not t.is_alive()
    assert tally == {"test.mine": 1}
    assert counted_since(before) == {"test.other": 4}


def test_counters_is_a_snapshot():
    trace.count("test.snapshot")
    snap = trace.counters()
    snap["test.snapshot"] = -1
    trace.count("test.snapshot")
    assert trace.counters()["test.snapshot"] >= 2


def test_the_adjacency_counts_its_nonzero_slots_once_on_the_host():
    batch = assemble([graph(20, s) for s in range(3)], BucketPolicy(min_nodes=32))
    prog, _, _ = program()
    bound = prog.bind(batch.graph, pad_degree=batch.d_bucket)
    # the pad rows' weight-0 self-loops do not count
    assert batch.n_pad > 0
    assert bound.adj.nonzero == int(np.count_nonzero(batch.graph.values))
    assert bound.adj.nonzero == int((bound.adj.weights != 0).sum())


@pytest.mark.parametrize("kind", ["gcn", "sage", "gin"])
@pytest.mark.parametrize("policy,order", [("sp_opt", "AC"), ("seq", "CA"), ("pp", "AC"),
                                          ("sp_generic", "CA")])
def test_a_run_counts_one_walk_a_layer_and_the_nonzero_slots(kind, policy, order):
    """The eager tier walks the whole padded ELL once a layer, in bands or
    at once: ``agg.slots`` = layers x V_pad x D, and ``ell.nonzero`` the
    bound adjacency's non-zero slots, once a call."""
    prog, params, g = program(kind, policy, order)
    x = torch.randn(g.n_nodes, 12)
    before = trace.counters()
    prog.run(params, x)
    prog.run(params, x)
    v_pad, d = prog.adj.indices.shape
    assert counted_since(before) == {"agg.slots": 2 * 2 * v_pad * d,
                                     "ell.nonzero": 2 * prog.adj.nonzero}


@pytest.mark.parametrize("policy", ["sp_opt", "pp"])
def test_the_kernel_tiers_fused_layers_walk_no_padded_slot(policy):
    """The fused kernel walks each row's real slots only (its plain version
    stands for it on the CPU and counts nothing); ``pp`` without a mesh is
    the eager fallback on either tier."""
    prog, params, g = program(policy=policy, use_pallas=True)
    before = trace.counters()
    prog.run(params, torch.randn(g.n_nodes, 12))
    v_pad, d = prog.adj.indices.shape
    walks = 2 if policy == "pp" else 0
    assert counted_since(before).get("agg.slots", 0) == walks * v_pad * d


@pytest.mark.parametrize("order,backward_walks", [("AC", 1), ("CA", 2)])
def test_a_train_step_adds_the_backward_walks(order, backward_walks):
    """Layer 0's AC aggregation takes the features, which need no gradient,
    so only layer 1's backward walks; under CA both layers aggregate
    ``x @ w``, and both walk back."""
    prog, params, g = program(policy="sp_generic", order=order)
    task = make_node_classification_task(g, 12, 4, device="cpu")
    before = trace.counters()
    prog.train_step(params, *task)
    v_pad, d = prog.adj.indices.shape
    assert counted_since(before) == {"agg.slots": (2 + backward_walks) * v_pad * d,
                                     "ell.nonzero": prog.adj.nonzero}


def test_bind_bucketize_and_assemble_count_their_host_seconds():
    prog, _, _ = program()
    graphs = [graph(20, s) for s in range(4)]
    before = trace.counters()
    routed = bucketize(graphs, BucketPolicy(min_nodes=32))
    (ids,) = routed.values()
    batch = assemble([graphs[i] for i in ids], BucketPolicy(min_nodes=32))
    mid = trace.counters()
    prog.bind(batch.graph)
    assert set(counted_since(before)) == {"setup.batching_s", "setup.bind_s"}
    assert mid["setup.batching_s"] > before.get("setup.batching_s", 0)
    assert counted_since(mid)["setup.bind_s"] > 0


def spans_of(path: Path) -> list[tuple[str, float, float]]:
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_spans_land_in_the_profilers_trace_inside_the_callers(tmp_path):
    prog, params, g = program(policy="pp")
    batch = assemble([graph(20, s) for s in range(2)], BucketPolicy(min_nodes=32))
    task = make_node_classification_task(g, 12, 4, device="cpu")
    x = torch.randn(g.n_nodes, 12)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("run"):
            prog.bind(batch.graph)
            assemble([graph(20, 5)], BucketPolicy(min_nodes=32))
            prog.run(params, x)
            prog.run(params, x)
            prog.train_step(params, *task)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    spans = spans_of(tmp_path / "trace.json")
    (outer,) = [s for s in spans if s[0] == "run"]
    ours = [s for s in spans if s[0].startswith("repro_torch.")]
    names = [s[0] for s in ours]
    assert names.count("repro_torch.program.run") == 2
    assert names.count("repro_torch.program.build") == 2  # the forward's and the step's
    assert {"repro_torch.program.bind", "repro_torch.program.train_step",
            "repro_torch.batching.assemble"} <= set(names)
    assert all(outer[1] <= a and b <= outer[2] for _, a, b in ours)


def test_with_the_profiler_off_no_span_is_entered(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler on")

    monkeypatch.setattr(trace, "record_function", refused)
    prog, params, g = program(policy="pp")
    batch = assemble([graph(20, s) for s in range(2)], BucketPolicy(min_nodes=32))
    prog.bind(batch.graph)
    prog.run(params, torch.randn(g.n_nodes, 12))
    prog.train_step(params, *make_node_classification_task(g, 12, 4, device="cpu"))
    assert trace.span("repro_torch.test") is trace.NO_SPAN


def span_names() -> list[str]:
    """Every literal name the port passes to ``trace.span`` / ``spanned``."""
    names = []
    for path in SRC.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "spanned")
                    and isinstance(getattr(node.func.value, "id", None), str)
                    and node.func.value.id == "trace"):
                (arg,) = node.args
                assert isinstance(arg, ast.Constant), f"{path}: a span name not literal"
                names.append(arg.value)
    return names


def test_span_names_are_the_ports_own():
    names = span_names()
    assert set(names) >= {
        "repro_torch.program.run", "repro_torch.program.build",
        "repro_torch.program.train_step", "repro_torch.program.bind",
        "repro_torch.capture.warmup", "repro_torch.capture.record",
        "repro_torch.replay.copy_in", "repro_torch.replay.launch",
        "repro_torch.replay.copy_out", "repro_torch.batching.assemble"}
    assert all(n.startswith("repro_torch.") for n in names)
    assert not set(names) & BENCHMARK_SPANS
