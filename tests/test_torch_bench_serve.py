"""The port's serving lanes (``repro_torch.bench.serve_gnn``) on the CPU,
against the reference lanes (``benchmarks/serve_gnn.py``, imported from the
repo root): the request streams equal byte for byte; the plain lane's
engine serves the same outputs as the reference engine at 2e-4 with the
weights carried across (``params_from_numpy``); the chaos stream ends in
the same status and error type, request by request; and every lane's own
guards hold at its smoke size (engine vs naive 1e-5, bit-identity across
chaos, restart, async and giant, no build warm, no downgrade).  The
lanes' evidence directories point at ``tmp_path``."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.common as ref_common  # noqa: E402
from benchmarks import serve_gnn as ref  # noqa: E402
import repro_torch.bench.common as port_common  # noqa: E402
from repro_torch.bench import serve_gnn as port  # noqa: E402
from repro_torch.gnn import params_from_numpy  # noqa: E402

TOL_REF = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def out_dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_common, "OUT_DIR", tmp_path / "ref")
    monkeypatch.setattr(port_common, "OUT_DIR", tmp_path / "port")
    monkeypatch.delenv(port.STORE_ENV, raising=False)


def same_request(a, b):
    assert a.rid == b.rid
    ga, gb = a.graph, b.graph
    assert ga.n_nodes == gb.n_nodes
    for field in ("row_ptr", "col_idx", "values"):
        x, y = np.asarray(getattr(ga, field)), np.asarray(getattr(gb, field))
        assert x.dtype == y.dtype and x.shape == y.shape, field
        assert x.tobytes() == y.tobytes(), field
    assert a.x.dtype == b.x.dtype and a.x.shape == b.x.shape
    assert np.asarray(a.x).tobytes() == np.asarray(b.x).tobytes()


def test_lane_constants_are_the_references():
    for name in ("DIMS", "MIX", "N_FULL", "N_SMOKE", "SPEEDUP_FLOOR", "SEED",
                 "N_CHAOS", "N_CHAOS_SMOKE", "CHAOS_FAULT_EVERY",
                 "CHAOS_MAX_NODES", "CHAOS_OVERSIZED_NODES",
                 "CHAOS_SLOWDOWN_CEIL", "CHAOS_CLASSES", "N_RESTART",
                 "N_RESTART_SMOKE", "RESTART_FIRST_MS_CEIL",
                 "RESTART_SPEEDUP_FLOOR", "N_ASYNC", "N_ASYNC_SMOKE",
                 "N_ASYNC_PACED", "N_ASYNC_PACED_SMOKE", "ASYNC_WINDOW_MS",
                 "ASYNC_SPEEDUP_FLOOR", "ASYNC_P99_WINDOW_FACTOR",
                 "ASYNC_PACE_S", "GIANT_SIZES", "GIANT_SIZES_SMOKE",
                 "GIANT_CAP_BYTES", "GIANT_MAX_NODES", "GIANT_SPEEDUP_FLOOR"):
        assert getattr(port, name) == getattr(ref, name), name


def test_streams_are_the_references_byte_for_byte():
    for n, seed in ((port.N_FULL, port.SEED), (port.N_ASYNC_PACED, port.SEED + 1)):
        a, b = port.make_stream(n, seed), ref.make_stream(n, seed)
        assert len(a) == len(b) == n
        for x, y in zip(a, b):
            same_request(x, y)
    (pa, ka, ca), (ra, kb, cb) = (port.make_chaos_stream(port.N_CHAOS),
                                  ref.make_chaos_stream(ref.N_CHAOS))
    assert ka == kb and ca == cb and len(pa) == len(ra) == port.N_CHAOS
    for x, y in zip(pa, ra):
        same_request(x, y)
    for sizes in (port.GIANT_SIZES, port.GIANT_SIZES_SMOKE):
        for x, y in zip(port.make_giant_stream(sizes), ref.make_giant_stream(sizes)):
            same_request(x, y)


def reference_params(engine):
    return params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()}
         for layer in engine.init(jax.random.PRNGKey(0))],
        device="cpu")


def test_engine_serves_the_reference_outputs_with_carried_weights():
    from repro.graphs import BucketPolicy as RefPolicy
    from repro.runtime.engine import InferenceEngine as RefEngine

    requests = ref.make_stream(ref.N_SMOKE)
    ref_engine = RefEngine(ref.DIMS, policy=RefPolicy(max_graphs=64),
                           readout="mean")
    params = reference_params(ref_engine)
    want = ref_engine.submit(requests)

    engine, _, got = port.serve_stream(port.make_stream(port.N_SMOKE), "cpu",
                                       params=params)
    port.check_top_tier(got, engine, "cross-package serve")
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.bucket for r in got] == [r.bucket for r in want]
    for a, b in zip(got, want):
        assert a.status == b.status == "ok"
        np.testing.assert_allclose(a.output, np.asarray(b.output), **TOL_REF)


def test_chaos_statuses_match_the_reference_request_by_request():
    from repro.graphs import BucketPolicy as RefPolicy
    from repro.runtime import FaultInjector, FaultRule, RetryPolicy
    from repro.runtime.engine import InferenceEngine as RefEngine

    # the reference lane's chaos engine, as run_chaos builds it
    requests, kernel_rids, _ = ref.make_chaos_stream(ref.N_CHAOS_SMOKE)
    ref_engine = RefEngine(
        ref.DIMS,
        policy=RefPolicy(max_graphs=64, max_nodes=ref.CHAOS_MAX_NODES),
        readout="mean",
        fault_injector=FaultInjector(
            seed=ref.SEED,
            rules=[FaultRule(kind="exception", rid=r) for r in kernel_rids]),
        retry=RetryPolicy(max_retries=1),
    )
    ref_engine.init(jax.random.PRNGKey(0))
    want = {r.rid: (r.status, r.error_type) for r in ref_engine.submit(requests)}

    *_, results = port.serve_chaos(port.N_CHAOS_SMOKE, "cpu")
    got = {r.rid: (r.status, r.error_type) for r in results}
    assert got == want
    assert sorted({s for s, _ in got.values()}) == ["failed", "ok", "rejected"]


def test_plain_lane_guards_hold_at_smoke_size():
    rows = dict((name, derived) for name, _, derived in port.run(smoke=True, device="cpu"))
    assert rows["serve/engine_warm"].endswith("traces=0")
    fields = dict(f.split("=") for f in rows["serve/speedup"].split(";")[1:])
    assert float(fields["parity"]) <= 1e-5
    assert float(fields["eager"]) <= port.CLOSE_TOL["atol"]


def test_chaos_lane_guards_hold_at_smoke_size():
    (row,) = port.run_chaos(smoke=True, device="cpu")
    assert "failed=2;" in row[2] and "degraded=0;" in row[2]
    assert "bit_identical=90;" in row[2]


def test_restart_lane_revives_without_builds_at_smoke_size():
    from repro_torch.kernels import common as kcommon

    before = kcommon.BUILD_DIR
    rows = dict((name, derived) for name, _, derived in
                port.run_restart(smoke=True, device="cpu"))
    assert "first_traces=0;searches=0;" in rows["serve/restart_revived"]
    assert "nvcc=0;bit_identical=64" in rows["serve/restart_revived"]
    assert rows["serve/restart_speedup"].endswith("corrupt_recovered=1")
    assert kcommon.BUILD_DIR == before  # the throwaway store's dir is let go


def test_async_lane_is_bit_identical_on_two_workers_at_smoke_size():
    rows = dict((name, derived) for name, _, derived in
                port.run_async(smoke=True, device="cpu"))
    assert "devices=2;" in rows["serve/async_blast"]
    assert f";bit_identical={port.N_ASYNC_SMOKE};" in rows["serve/async_blast"]
    assert "traffic_warmed_identical=" in rows["serve/async_blast"]


def test_async_workers_on_one_device_are_two():
    from repro_torch.device import worker_devices
    from repro_torch.runtime.scheduler import worker_labels

    devs = worker_devices("cpu")
    assert devs == [torch.device("cpu")] * 2
    assert worker_labels(devs) == ["cpu#0", "cpu#1"]


def test_async_workers_start_on_the_requested_card(monkeypatch):
    from repro_torch.device import worker_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in (2, 0, 1, 3)]
    assert worker_devices("cuda:2") == cards
    assert worker_devices("cuda:2")[:2] == cards[:2]  # the PP example's mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert worker_devices("cuda:0") == [torch.device("cuda", 0)] * 2


def test_giant_lane_is_bit_identical_to_its_fallback_at_smoke_size():
    rows = dict((name, derived) for name, _, derived in
                port.run_giant(smoke=True, device="cpu"))
    assert "plans=row_stream;" in rows["serve/giant_partitioned"]
    assert rows["serve/giant_warm"] == "traces=0"
    n = len(port.GIANT_SIZES_SMOKE)
    assert f"bit_identical={n}/{n};rejected_without_flag={n}/{n};eager=" in \
        rows["serve/giant_speedup"]


def test_calibrate_lane_reads_only_the_ports_committed_ceiling(tmp_path):
    import json

    from repro_torch.bench import calibrate_model

    assert calibrate_model._committed_error_ceil() == calibrate_model.ERROR_CEIL
    port_dir = tmp_path / "port"
    port_dir.mkdir(parents=True, exist_ok=True)
    (port_dir / "calibrate_model.json").write_text(
        json.dumps({"guards": {"error_ceil": 0.125}}))
    assert calibrate_model._committed_error_ceil() == 0.125


def test_a_missed_speed_guard_raises_after_its_evidence_landed(tmp_path):
    import json

    rows = [("serve/x", 0.0, "")]
    guards = [port._guard("speedup", 0.5, 10.0, "floor", "serve: missed"),
              port._guard("slowdown", 1.0, 5.0, "ceiling", "chaos: missed")]
    assert port._finish("lane_x", True, rows, {"a": 1}, guards) == rows
    assert not (tmp_path / "port" / "lane_x.json").exists()  # smoke: no JSON
    with pytest.raises(RuntimeError, match="^serve: missed$"):
        port._finish("lane_x", False, rows, {"a": 1}, guards)
    evidence = json.loads((tmp_path / "port" / "lane_x.json").read_text())
    assert evidence["a"] == 1 and "device" in evidence
    assert [(g["key"], g["met"]) for g in evidence["guards"]] == [
        ("speedup", False), ("slowdown", True)]
    assert evidence["guards"][0]["floor"] == 10.0
    unenforced = [port._guard("speedup", 0.5, 10.0, "floor", "m", enforced=False)]
    assert port._finish("lane_y", False, rows, {}, unenforced) == rows
