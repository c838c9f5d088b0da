"""The port's calibration on the CPU (``repro_torch.core.calibrate``), held
to what ``tests/test_calibrate.py`` asserts of the reference: a pure,
deterministic fit that recovers planted constants, models persisted in
the store keyed by the backend fingerprint, and an engine that resolves
the model fitted for its device.  Cross-package: the same points give the
same model, the same grid prices the same analytic cycles, and a
latency-model file written by the reference's store loads in the port's.
"""
import dataclasses
from dataclasses import replace

import numpy as np
import pytest
import torch

import repro.core.calibrate as ref_cal
import repro.runtime as ref_rt
from repro_torch.core.calibrate import (
    CalibrationPoint,
    backend_fingerprint,
    calibrate,
    fit_latency_model,
    measure_grid,
)
from repro_torch.core.hw import DEFAULT_ACCEL, LatencyModel
from repro_torch.graphs import BucketPolicy, from_edges
from repro_torch.runtime import InferenceEngine, ProgramStore, Request

CAL = LatencyModel(
    overhead_seq=2.0, overhead_sp_generic=1.5, overhead_sp_opt=1.25,
    overhead_pp=3.0, c_setup=100.0, cycle_time_s=1e-9,
    backend="test:unit:torch-0", fit_error_median=0.01,
)


def _planted(point_cls=CalibrationPoint):
    true = {"seq": 3.0, "sp_generic": 1.0, "sp_opt": 1.5}
    ct, setup = 5e-9, 2e-5
    return [
        point_cls(policy=policy, order="AC", v=256 * (i + 1), degree=8,
                  f_in=32, f_out=32, use_pallas=False, cycles=cyc,
                  measured_s=ct * ov * cyc + setup, cycles_by_bw=((1.0, cyc),))
        for policy, ov in true.items()
        for i, cyc in enumerate((1e5, 5e5, 2e6))
    ]


def _noisy(point_cls=CalibrationPoint, seed=0):
    """Measurements with noise and a bandwidth ladder, so the fit searches
    the bandwidth axis and lands off 1.0."""
    rng = np.random.default_rng(seed)
    pts = []
    for policy in ("seq", "sp_generic", "sp_opt"):
        for order in ("AC", "CA"):
            for v in (256, 1024, 2048):
                cyc = float(rng.uniform(1e4, 1e6))
                ladder = tuple((m, cyc * (1.0 + 0.3 / m)) for m in
                               (0.25, 0.5, 1.0, 2.0, 4.0))
                pts.append(point_cls(
                    policy=policy, order=order, v=v, degree=8, f_in=32,
                    f_out=32, use_pallas=False, cycles=cyc,
                    measured_s=float(cyc * 1e-9 * rng.uniform(0.8, 1.5)),
                    cycles_by_bw=ladder,
                ))
    return pts


@pytest.mark.parametrize("points", ["planted", "noisy"])
def test_fit_equals_the_reference(points):
    make = {"planted": _planted, "noisy": _noisy}[points]
    mine = fit_latency_model(make(), hw=DEFAULT_ACCEL, backend="b")
    ref = ref_cal.fit_latency_model(make(ref_cal.CalibrationPoint), backend="b")
    assert dataclasses.asdict(mine.model) == dataclasses.asdict(ref.model)
    assert mine.errors == ref.errors and mine.bw_mult == ref.bw_mult
    assert mine.per_family == ref.per_family
    assert fit_latency_model(make(), backend="b").model == mine.model


def test_fit_recovers_planted_constants():
    r = fit_latency_model(_planted(), hw=DEFAULT_ACCEL, backend="t")
    assert r.error_median < 1e-6 and r.bw_mult == 1.0
    assert r.model.overhead_seq == pytest.approx(3.0, rel=1e-6)
    assert r.model.overhead_sp_opt == pytest.approx(1.5, rel=1e-6)
    assert r.model.overhead_pp == r.model.overhead_sp_generic
    assert r.model.cycle_time_s == pytest.approx(5e-9, rel=1e-6)
    with pytest.raises(ValueError):
        fit_latency_model([])


def test_backend_fingerprint():
    assert backend_fingerprint("cpu") == f"cpu:cpu:torch-{torch.__version__}"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend_fingerprint()


def test_measure_grid_prices_the_reference_cycles():
    sizes, dims = ((64, 4), (128, 4)), (8, 8)
    kw = dict(policies=("seq", "sp_opt"), orders=("AC", "CA"), sizes=sizes,
              dims=dims, bw_mults=(0.5, 1.0), warmup=0, iters=1)
    pts = measure_grid(device="cpu", **kw)
    assert len(pts) == 8 and all(p.measured_s > 0 for p in pts)
    ref = ref_cal.measure_grid(**kw)
    for a, b in zip(pts, ref):
        assert (a.policy, a.order, a.v, a.cycles, a.cycles_by_bw) == (
            b.policy, b.order, b.v, b.cycles, b.cycles_by_bw)


def test_store_roundtrip_keyed_by_backend(tmp_path):
    store = ProgramStore(tmp_path)
    store.save_latency_model(CAL)
    assert store.load_latency_model(CAL.backend) == CAL
    other = replace(CAL, backend="other:backend", overhead_seq=9.0)
    store.save_latency_model(other)
    assert store.load_latency_model(CAL.backend) == CAL
    assert store.load_latency_model("other:backend") == other
    with pytest.raises(ValueError):
        store.save_latency_model(LatencyModel())
    store.latency_path.write_text("{garbage")
    assert store.load_latency_model(CAL.backend) is None and store.corrupt > 0


def test_reference_latency_file_loads_in_the_port(tmp_path):
    from repro.core.hw import LatencyModel as RefModel

    ref_store = ref_rt.ProgramStore(tmp_path)
    ref_store.save_latency_model(RefModel(**dataclasses.asdict(CAL)))
    assert ProgramStore(tmp_path).load_latency_model(CAL.backend) == CAL


def test_calibrate_then_engine_resolves_the_model(tmp_path):
    """``calibrate`` stores the fit under this device's fingerprint; an
    engine on the store picks it up; a measured ``rerank_topk`` then
    leaves the request path build-free."""
    store = ProgramStore(tmp_path)
    rep = calibrate(store=store, fast=True, warmup=0, iters=1, device="cpu")
    assert rep.model.backend == backend_fingerprint("cpu")
    assert rep.n_points == 12 and rep.model.calibrated
    assert store.load_latency_model(backend_fingerprint("cpu")) == rep.model

    dims = [(12, 16), (16, 4)]
    eng = InferenceEngine(dims, store=ProgramStore(tmp_path), device="cpu",
                          policy=BucketPolicy(min_nodes=16, min_degree=4,
                                              max_graphs=4))
    assert eng.hw.latency == rep.model
    eng.init(torch.Generator().manual_seed(0))
    n = 12
    src = np.arange(n)
    g = from_edges(n, np.concatenate([src, (src + 1) % n]),
                   np.concatenate([(src + 1) % n, src]))
    reqs = [Request(graph=g, x=np.random.default_rng(i).normal(
        size=(n, 12)).astype(np.float32), rid=i) for i in range(4)]
    eng.submit(reqs)
    eng.submit(reqs)
    assert eng.profile.observed
    rr = eng.rerank_topk(top_k=2, iters=1, warmup=0)
    assert rr.n_buckets >= 1 and rr.n_candidates >= 1
    import repro_torch

    before = repro_torch.trace_count()
    assert all(r.ok for r in eng.submit(reqs))
    assert repro_torch.trace_count() == before
