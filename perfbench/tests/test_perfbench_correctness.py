"""What decides ``correct``: the plain reference agrees with the port at a
small size on the CPU; a run with the timed path broken underneath comes
out not correct, for each fault a cell can have; the control (the
reference in TF32 in the program's place) fails the cell's limits, on the
CPU by TF32's rounding of the products' operands and on a card (``cuda``
marker) in TF32 itself.

    python -m pytest perfbench/tests
"""
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO / "src")]

import harness  # noqa: E402
from graphgen import single_graph  # noqa: E402
from references import common, gcn  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.api import Program  # noqa: E402
from repro_torch.graphs.csr import from_edges  # noqa: E402

from cell_sizes import CONTROL, TINY  # noqa: E402
from test_perfbench_harness import tiny_run  # noqa: E402


def small_task(seed=0, n_classes=7, f_in=24):
    n, src, dst = single_graph({"generator": "citation", "avg_nodes": 120,
                                "avg_edges": 480, "library_seed": seed})
    g = torch.Generator().manual_seed(seed)
    dims = [(f_in, 16), (16, n_classes)]
    params = [{"w": torch.randn(f, k, generator=g) / f ** 0.5,
               "b": torch.randn(k, generator=g) * 0.1} for f, k in dims]
    x = torch.randn(n, f_in, generator=g)
    labels = torch.randint(0, n_classes, (n,), generator=g, dtype=torch.int32)
    mask = (torch.rand(n, generator=g) < 0.3).float()
    return (n, src, dst), params, x, labels, mask


@pytest.mark.parametrize("use_pallas", [False, True])
def test_reference_forward_agrees_with_the_port(use_pallas):
    (n, src, dst), params, x, *_ = small_task()
    cfg = repro_torch.gnn.GNNConfig("gcn", f_in=24, hidden=16, n_classes=7,
                                    use_pallas=use_pallas)
    prog = repro_torch.compile(cfg, graph=from_edges(n, src, dst), device="cpu")
    got = prog.run(params, x)
    want = gcn.forward(params, gcn.Adjacency(n, src, dst, "cpu"), x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_reference_readout_agrees_with_the_port():
    from repro_torch.graphs import BucketPolicy, assemble

    graphs = [single_graph({"generator": "citation", "avg_nodes": 30 + 7 * i,
                            "avg_edges": 90, "library_seed": i}) for i in range(3)]
    csr = [from_edges(*e) for e in graphs]
    policy = BucketPolicy(min_nodes=64, min_degree=64, max_graphs=4)
    batch = assemble(csr, policy)
    params = small_task()[1]
    x = torch.randn(batch.v_total, 24, generator=torch.Generator().manual_seed(1))
    x[int(batch.sizes.sum()):] = 0
    cfg = repro_torch.gnn.GNNConfig("gcn", f_in=24, hidden=16, n_classes=7)
    prog = repro_torch.compile(cfg, graph=batch.graph, device="cpu")
    got = prog.run(params, x, segment_ids=batch.segment_ids, num_segments=batch.slots,
                   readout="mean")
    for j, (off, size) in enumerate(zip(batch.offsets, batch.sizes)):
        h = gcn.forward(params, gcn.Adjacency(*graphs[j], "cpu"), x[off:off + size])
        torch.testing.assert_close(got[j], common.readout(h, "mean"), rtol=1e-5, atol=1e-6)


def test_reference_sgd_agrees_with_the_port():
    (n, src, dst), params, x, labels, mask = small_task()
    cfg = repro_torch.gnn.GNNConfig("gcn", f_in=24, hidden=16, n_classes=7)
    prog = repro_torch.compile(cfg, graph=from_edges(n, src, dst), device="cpu")
    losses, _, states = common.sgd(gcn, params, gcn.Adjacency(n, src, dst, "cpu"), x, labels,
                                mask, 0.05, 3)
    p = params
    for want_loss, want in zip(losses, states):
        loss, p = prog.train_step(p, x, labels, mask, lr=0.05)
        assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
        for a, b in zip(p, want):
            for k in a:
                torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-7)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0e-5])
    r = common.round_tf32(t)
    assert r[0] == 1.0 + 2 ** -10 and r[1] == 1.0 and r[2] == 1.0 + 2 ** -9
    assert abs(float(r[3]) + 3.0e-5) <= 3.0e-5 * 2 ** -11


# -- faults: the timed path broken underneath, the rest of a run as it is ---

def _stale(run):
    """Every call of a shape answers what its first call answered."""
    first = {}

    def broken(self, *a, **k):
        out = run(self, *a, **k)
        return first.setdefault(tuple(out.shape), out).clone()
    return broken


def _half(run):
    """Half of the batch left out: its answers are the mean of the rest."""
    def broken(self, *a, **k):
        out = run(self, *a, **k).clone()
        h = out.shape[0] // 2
        out[h:] = out[:h].mean(dim=0)
        return out
    return broken


def _altered(run):
    """One answer altered where it is produced."""
    def broken(self, *a, **k):
        out = run(self, *a, **k).clone()
        out[0, 0] += 1e-3 * float(out.abs().max()) + 1e-3
        return out
    return broken


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("workload", ["gcn-reddit-bin.score", "gcn-cora.refresh"])
def test_a_broken_forward_is_not_correct(workload, fault, tmp_path, monkeypatch):
    assert tiny_run(workload, tmp_path)["correct"]
    monkeypatch.setattr(Program, "run", fault(Program.run))
    r = tiny_run(workload, tmp_path)
    assert r["correct"] is False and r["failed"] > 0


def _unchanged(step):
    def broken(self, params, *a, **k):
        loss, _ = step(self, params, *a, **k)
        return loss, [{k_: v.clone() for k_, v in layer.items()} for layer in params]
    return broken


def _half_batch(step):
    def broken(self, params, x, labels, mask, **k):
        idx = torch.nonzero(mask).flatten()
        half = mask.clone()
        half[idx[1::2]] = 0
        return step(self, params, x, labels, half, **k)
    return broken


def _altered_loss(step):
    def broken(self, *a, **k):
        loss, new = step(self, *a, **k)
        return loss * (1 + 1e-3), new
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_loss])
def test_a_broken_training_step_is_not_correct(fault, tmp_path, monkeypatch):
    assert tiny_run("gcn-cora.train", tmp_path)["correct"]
    monkeypatch.setattr(Program, "train_step", fault(Program.train_step))
    r = tiny_run("gcn-cora.train", tmp_path)
    assert r["correct"] is False and r["failed"] > 0


# -- the control: the reference one precision below, in the program's place --

def _job(workload, tmp_path, device, overrides):
    bench = harness.Benchmark()
    cell = bench.cell(workload)
    config = harness.deep_merge(bench.config(cell["config"]), overrides.get("config", {}))
    traffic = harness.deep_merge(bench.traffic(cell["traffic"]), overrides.get("traffic", {}))
    from repro_torch.runtime.store import ProgramStore

    store = ProgramStore(tmp_path / "store")
    job = harness.job_class(traffic["job"])(config, traffic, 7, torch.device(device), store)
    job.setup()
    return job, bench.limits(workload)


def _control_fails(job, limits):
    program = job.readings("program")
    control = job.readings("control")
    assert all(program[k] <= v for k, v in limits.items()), (program, limits)
    assert any(control[k] > v for k, v in limits.items()), (control, limits)


@pytest.mark.parametrize("workload", sorted(CONTROL))
def test_the_control_fails_on_the_cpu(workload, tmp_path):
    _control_fails(*_job(workload, tmp_path, "cpu", CONTROL[workload]))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CONTROL))
def test_the_control_fails_on_the_card(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _control_fails(*_job(workload, tmp_path, "cuda", CONTROL[workload]))


def test_every_cell_has_a_control_size():
    assert set(TINY) == set(CONTROL)
