"""The port's resilience runtime on the CPU (``repro_torch.runtime``:
``resilience``, ``faults``, ``fault_tolerance``), held to what
``tests/test_resilience.py`` and ``tests/test_fault_tolerance.py`` assert
of the reference: typed statuses at the engine boundary, admission
control, the degradation ladder, solo-retry quarantine with healthy
neighbors bit-identical to a fault-free run, deterministic injection, and
the training-side retry/restore runner.  Cross-package: the same seeded
chaos stream gives the same statuses in both packages."""
import jax
import numpy as np
import pytest
import torch

import repro.runtime as ref_rt
from repro.core.schedule import ModelSchedule as RefSchedule
from repro.graphs import BucketPolicy as RefPolicy
from repro.graphs import from_edges as ref_from_edges
from repro_torch.core.registry import pop_kernel_hook, push_kernel_hook
from repro_torch.core.schedule import ModelSchedule
from repro_torch.gnn import params_from_numpy
from repro_torch.kernels.common import CudaKernelError
from repro_torch.graphs import BucketPolicy, CSRGraph, from_edges
from repro_torch.runtime import (
    COMPILE,
    FaultInjector,
    FaultRule,
    InferenceEngine,
    InvalidRequest,
    KernelFault,
    Request,
    ResilientRunner,
    RetryPolicy,
    StragglerMonitor,
    default_ladder,
    kill_pallas,
    validate_request,
)
from repro_torch.runtime.resilience import run_with_retry
from repro_torch.runtime import fault_tolerance as ft_mod

DIMS = [(12, 16), (16, 4)]
SCHEDULE = ModelSchedule.from_policies("sp_opt", "AC", DIMS)
POL = BucketPolicy(min_nodes=16, min_degree=4, max_graphs=4)
FAST = RetryPolicy(max_retries=0, backoff_s=0.0)


def ring_graph(n: int) -> CSRGraph:
    src = np.arange(n)
    dst = (src + 1) % n
    return from_edges(n, np.concatenate([src, dst]), np.concatenate([dst, src]))


def make_request(n: int, seed: int, rid: int = 0, **kw) -> Request:
    x = np.random.default_rng(seed).normal(size=(n, DIMS[0][0])).astype(np.float32)
    return Request(graph=ring_graph(n), x=x, rid=rid, **kw)


def make_engine(params, **kw) -> InferenceEngine:
    kw.setdefault("policy", POL)
    kw.setdefault("schedule", SCHEDULE)
    kw.setdefault("retry", FAST)
    return InferenceEngine(DIMS, params, device="cpu", **kw)


@pytest.fixture(scope="module")
def params():
    eng = InferenceEngine(DIMS, policy=POL, schedule=SCHEDULE, device="cpu")
    return eng.init(torch.Generator().manual_seed(0))


def test_ladder_keeps_the_reference_tier_names():
    assert [t.name for t in default_ladder(True)] == [
        t.name for t in ref_rt.default_ladder(True)
    ] == ["pallas+searched", "jnp+searched", "jnp+default"]
    assert default_ladder(False) == tuple(
        type(default_ladder(False)[0])(**vars(t))
        for t in ref_rt.default_ladder(False)
    )


def test_build_failure_is_a_kernel_fault():
    """``as_serving_error`` wraps an untyped execution failure, here one
    that names a failed build, as a ``KernelFault``.  The ladders never
    wrap a ``CudaKernelError`` (see
    ``test_kernel_build_failure_is_raised_not_served_degraded``)."""
    from repro_torch.runtime.resilience import as_serving_error

    err = as_serving_error(RuntimeError("nvcc failed on spmm.cu (exit 1)"))
    assert isinstance(err, KernelFault) and err.code == "kernel_fault"
    assert "nvcc failed" in str(err)


def broken_kernel_tier(key, impl):
    """A registry hook: every kernel-tier kernel fails as a CUDA kernel
    does when ``nvcc`` refuses its source."""
    if not key[2]:
        return impl

    def broken(*args, **kwargs):
        raise CudaKernelError("nvcc failed on fused_agg_cmb.cu (exit 1)")

    return broken


def test_kernel_build_failure_is_raised_not_served_degraded(params):
    """A kernel that cannot build, load or launch is no request's fault:
    the ladder re-raises it instead of serving the eager tier in its
    place, so nothing comes back ``degraded``.  An injected kernel fault
    (``kill_pallas``) still degrades."""
    eng = make_engine(params, use_pallas=True)
    push_kernel_hook(broken_kernel_tier)
    try:
        with pytest.raises(CudaKernelError, match="nvcc failed"):
            eng.submit([make_request(16, 0, 0), make_request(16, 1, 1)])
    finally:
        pop_kernel_hook(broken_kernel_tier)
    stats = eng.stats()
    assert stats.n_downgrades == 0 and stats.n_degraded == 0
    assert stats.n_retries == 0
    with kill_pallas():
        (res,) = make_engine(params, use_pallas=True).submit([make_request(16, 2, 2)])
    assert res.status == "degraded" and res.tier == "jnp+searched"


def test_retry_loops_do_not_retry_a_broken_kernel():
    """``run_with_retry`` and :class:`ResilientRunner` pass a
    ``CudaKernelError`` through on its first raise (no retry, no restore);
    any other fault is retried as before."""
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise CudaKernelError("spmm_ell launch failed: CUDA error 98")

    with pytest.raises(CudaKernelError):
        run_with_retry(broken, RetryPolicy(max_retries=3))
    assert calls["n"] == 1
    restores = []
    runner = ResilientRunner(
        step_fn=lambda state, batch: broken(), save_fn=lambda s, st: None,
        restore_fn=lambda: restores.append(1) or (0, state0), max_retries=2)
    state0 = np.ones(4, np.float32)
    with pytest.raises(CudaKernelError):
        runner.run(state0, lambda step: None, 0, 3)
    assert calls["n"] == 2 and restores == []
    flaky = iter([RuntimeError("transient"), None])

    def once():
        err = next(flaky)
        if err is not None:
            raise err
        return "done"

    assert run_with_retry(once, RetryPolicy(max_retries=1)) == ("done", 1)


# ---------------------------------------------------------------------------
# Engine-boundary validation
# ---------------------------------------------------------------------------


def _rejected(params, req):
    (res,) = make_engine(params).submit([req])
    assert res.status == "rejected" and res.error_type == "invalid_request"
    assert res.output is None and f"request {req.rid}" in res.error
    return res


def _bad_requests():
    good = make_request(16, seed=0, rid=7)
    nan = make_request(16, seed=0, rid=7)
    nan.x[3, 2] = np.nan
    ci = np.array(good.graph.col_idx, copy=True)
    ci[0] = good.graph.n_nodes + 5
    g = good.graph
    return {
        "nan": (nan, "non-finite"),
        "float64": (Request(graph=g, x=good.x.astype(np.float64), rid=7), "float32"),
        "shape": (Request(graph=g, x=good.x[:, :-1].copy(), rid=7), "do not match"),
        "col_idx": (
            Request(graph=CSRGraph(g.row_ptr, ci, g.values, g.n_nodes), x=good.x,
                    rid=7),
            "out of range",
        ),
    }


@pytest.mark.parametrize("case", ["nan", "float64", "shape", "col_idx"])
def test_malformed_request_rejected(params, case):
    req, match = _bad_requests()[case]
    assert match in _rejected(params, req).error


def test_csr_invariants_direct():
    good = make_request(16, seed=0, rid=21)
    g = good.graph

    def expect(graph, match):
        with pytest.raises(InvalidRequest, match=match) as e:
            validate_request(Request(graph=graph, x=good.x, rid=21), DIMS[0][0])
        assert "request 21" in str(e.value)

    expect(CSRGraph(g.row_ptr[:-1], g.col_idx, g.values, g.n_nodes),
           "row_ptr has length")
    rp = np.array(g.row_ptr, copy=True)
    rp[3], rp[4] = rp[4], rp[3] + 2
    expect(CSRGraph(rp, g.col_idx, g.values, g.n_nodes), "monoton")
    expect(CSRGraph(g.row_ptr, g.col_idx, g.values[:-1], g.n_nodes), "lengths")
    vals = np.array(g.values, copy=True)
    vals[0] = np.inf
    expect(CSRGraph(g.row_ptr, g.col_idx, vals, g.n_nodes), "non-finite")


def test_healthy_neighbors_unaffected(params):
    reqs = [make_request(16, seed=s, rid=s) for s in range(4)]
    reqs[2].x[0, 0] = np.nan
    results = make_engine(params).submit(reqs)
    assert [r.status for r in results] == ["ok", "ok", "rejected", "ok"]


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------


def test_overload_sheds_with_retry_after(params):
    eng = make_engine(params, max_inflight_graphs=2)
    results = eng.submit([make_request(16, seed=s, rid=s) for s in range(5)])
    shed = [r for r in results if r.status == "rejected"]
    assert sum(r.ok for r in results) == 2 and len(shed) == 3
    assert all(r.error_type == "engine_overloaded" and r.retry_after_s > 0
               for r in shed)
    assert eng.stats().errors == {"engine_overloaded": 3}


def test_oversized_graph_rejected(params):
    eng = make_engine(params, policy=BucketPolicy(
        min_nodes=16, min_degree=4, max_graphs=4, max_nodes=32))
    res_ok, res_big = eng.submit([make_request(16, 0, 0), make_request(40, 1, 1)])
    assert res_ok.ok
    assert res_big.status == "rejected" and res_big.error_type == "oversized_graph"
    assert "max_nodes=32" in res_big.error


def test_deadlines(params):
    eng = make_engine(params)
    res_h, res_e, res_g = eng.submit([
        make_request(16, 0, 0), make_request(16, 1, 1, deadline_s=0.0),
        make_request(16, 2, 2, deadline_s=60.0),
    ])
    assert res_h.ok and res_g.ok
    assert res_e.status == "failed" and res_e.error_type == "deadline_exceeded"
    assert eng.stats().n_failed == 1 and eng.stats().n_ok == 2


# ---------------------------------------------------------------------------
# Fault isolation
# ---------------------------------------------------------------------------


def test_poisoned_request_fails_alone_neighbors_bit_identical(params):
    reqs = [make_request(16, seed=s, rid=s) for s in range(4)]
    clean = make_engine(params).submit(reqs)
    inj = FaultInjector(rules=[FaultRule(kind="exception", rid=2)])
    eng = make_engine(params, fault_injector=inj)
    chaos = eng.submit(reqs)
    assert chaos[2].status == "failed" and chaos[2].error_type == "kernel_fault"
    for i in (0, 1, 3):
        assert chaos[i].status == "ok"
        assert np.array_equal(chaos[i].output, clean[i].output)
    stats = eng.stats()
    assert stats.n_solo_retries == 4 and stats.n_failed == 1 and stats.n_ok == 3


@pytest.mark.parametrize("kind", ["exception", "nan"])
def test_transient_fault_retried_to_ok(params, kind):
    inj = FaultInjector(rules=[FaultRule(kind=kind, rid=0, max_fires=1)])
    eng = make_engine(params, fault_injector=inj, retry=RetryPolicy(max_retries=1))
    (res,) = eng.submit([make_request(16, seed=0, rid=0)])
    assert res.status == "ok" and res.n_retries >= 1
    assert np.isfinite(res.output).all()


def test_persistent_nan_fails_with_numerical_fault(params):
    inj = FaultInjector(rules=[FaultRule(kind="nan", rid=1)])
    res0, res1 = make_engine(params, fault_injector=inj).submit(
        [make_request(16, 0, 0), make_request(16, 1, 1)])
    assert res0.status == "ok"
    assert res1.status == "failed" and res1.error_type == "numerical_fault"


def test_check_numerics_off_returns_nans_silently(params):
    inj = FaultInjector(rules=[FaultRule(kind="nan", rid=0)])
    eng = make_engine(params, fault_injector=inj, check_numerics=False)
    (res,) = eng.submit([make_request(16, seed=0, rid=0)])
    assert res.status == "ok" and np.isnan(res.output).any()


def test_compile_boundary_fault_retried(params):
    inj = FaultInjector(rules=[FaultRule(kind="exception", bucket=(16, 4),
                                         batch_index=COMPILE, max_fires=1)])
    eng = make_engine(params, fault_injector=inj, retry=RetryPolicy(max_retries=1))
    (res,) = eng.submit([make_request(16, seed=0, rid=0)])
    assert res.status == "ok" and res.n_retries >= 1
    assert any(ev.boundary == "compile" for ev in inj.log)


def test_latency_spike_flags_straggler_but_serves(params):
    inj = FaultInjector(rules=[FaultRule(kind="latency", batch_index=10,
                                         latency_s=0.3)])
    eng = make_engine(params, fault_injector=inj)
    results = []
    for i in range(12):
        results += eng.submit([make_request(16, seed=i, rid=i)])
    assert all(r.status == "ok" for r in results)
    assert eng.stats().n_stragglers >= 1


# ---------------------------------------------------------------------------
# Degradation
# ---------------------------------------------------------------------------


def test_kernel_outage_mid_stream(params):
    """Executables built before the kill keep serving on the kernel tier;
    a cold bucket degrades to the eager tier with one recorded
    downgrade."""
    eng = make_engine(params, use_pallas=True)
    warm = eng.submit([make_request(16, 0, 0), make_request(16, 1, 1)])
    assert [r.tier for r in warm] == ["pallas+searched"] * 2
    with kill_pallas():
        still_warm = eng.submit([make_request(16, 2, 2), make_request(16, 3, 3)])
        cold = eng.submit([make_request(32, seed=4, rid=4)])
    assert [r.status for r in still_warm] == ["ok", "ok"]
    assert all(r.tier == "pallas+searched" for r in still_warm)
    assert cold[0].status == "degraded" and cold[0].tier == "jnp+searched"
    stats = eng.stats()
    assert stats.n_downgrades == 1 and stats.n_degraded == 1
    # after the outage the kernel tier builds again for the cold bucket
    (again,) = eng.submit([make_request(32, seed=5, rid=5)])
    assert again.status == "ok" and again.tier == "pallas+searched"


@pytest.mark.parametrize("policy", ["seq", "sp_generic", "sp_opt"])
@pytest.mark.parametrize("order", ["AC", "CA"])
def test_degraded_numerics_match_eager_engine(params, policy, order):
    sched = ModelSchedule.from_policies(policy, order, DIMS)
    reqs = [make_request(16, seed=s, rid=s) for s in range(3)]
    ref = make_engine(params, schedule=sched).submit(reqs)
    eng = make_engine(params, schedule=sched, use_pallas=True)
    with kill_pallas():
        res = eng.submit(reqs)
    for r, rr in zip(res, ref):
        assert r.status == "degraded" and r.tier == "jnp+searched"
        np.testing.assert_allclose(r.output, rr.output, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Injector determinism
# ---------------------------------------------------------------------------


def test_same_seed_same_faults(params):
    reqs = [make_request(16, seed=s, rid=s) for s in range(16)]

    def run(seed):
        inj = FaultInjector(seed, p_exception=0.5)
        results = make_engine(params, fault_injector=inj).submit(reqs)
        return [(r.rid, r.status, r.error_type) for r in results], inj.log

    a, b = run(7), run(7)
    assert a == b and a[1]


def test_rule_max_fires_and_targeting():
    rule = FaultRule(kind="exception", rid=5, max_fires=2)
    inj = FaultInjector(rules=[rule])
    fired = 0
    for _ in range(5):
        try:
            inj.on_run((16, 4), 0, [5], "jnp+searched")
        except KernelFault:
            fired += 1
    assert fired == 2 and rule.fires == 2
    rule = FaultRule(kind="nan", bucket=(32, 8), tier="pallas+searched")
    assert rule.matches((32, 8), 3, [1, 2], "pallas+searched")
    assert not rule.matches((16, 4), 3, [1, 2], "pallas+searched")
    assert not rule.matches((32, 8), 3, [1, 2], "jnp+default")


def test_invalid_config_and_corruption():
    with pytest.raises(ValueError, match="kind"):
        FaultRule(kind="segfault")
    with pytest.raises(ValueError, match="p_exception"):
        FaultInjector(p_exception=1.5)
    with pytest.raises(ValueError, match="sum"):
        FaultInjector(p_exception=0.6, p_nan=0.6)
    out = FaultInjector(nan_fraction=0.25).corrupt_output(np.zeros((8, 8), np.float32))
    assert float(np.isnan(out).mean()) == pytest.approx(0.25)


# ---------------------------------------------------------------------------
# Chaos acceptance (16 requests, 5 poison classes)
# ---------------------------------------------------------------------------


def _chaos_stream(make, csr, from_np):
    """16 requests; every 3rd is poisoned (NaN, float64, broken CSR,
    oversized, sticky kernel fault, in turn).  Returns (reqs, kernel rids)."""
    reqs, kernel_rids = [], []
    for rid in range(16):
        r = make(16, rid, rid)
        if rid % 3 == 0:
            cls = (rid // 3) % 5
            if cls == 0:
                r.x[0, 0] = np.nan
            elif cls == 1:
                r = from_np(r, x=r.x.astype(np.float64))
            elif cls == 2:
                ci = np.array(r.graph.col_idx, copy=True)
                ci[0] = 999
                r = from_np(r, graph=csr(r.graph.row_ptr, ci, r.graph.values,
                                         r.graph.n_nodes))
            elif cls == 3:
                r = make(100, rid, rid)
            else:
                kernel_rids.append(rid)
        reqs.append(r)
    return reqs, kernel_rids


def test_chaos_stream_statuses_and_bit_identity(params):
    from dataclasses import replace

    policy = BucketPolicy(min_nodes=16, min_degree=4, max_graphs=4, max_nodes=64)
    reqs, kernel_rids = _chaos_stream(make_request, CSRGraph, replace)
    inj = FaultInjector(rules=[FaultRule(kind="exception", rid=r) for r in kernel_rids])
    eng = make_engine(params, policy=policy, fault_injector=inj)
    results = eng.submit(reqs)
    assert [r.rid for r in results] == list(range(16))
    for res in results:
        assert (res.output is not None) == res.ok
        assert res.ok or res.error_type is not None
    assert {r.rid for r in results if r.status == "failed"} == set(kernel_rids)
    stats = eng.stats()
    assert (stats.n_ok, stats.n_rejected, stats.n_failed) == (10, 5, 1)
    assert stats.n_solo_retries > 0
    healthy = [r for r in reqs if r.rid % 3 != 0]
    ref = {r.rid: r for r in make_engine(params, policy=policy).submit(healthy)}
    for res in results:
        if res.status == "ok":
            assert np.array_equal(res.output, ref[res.rid].output)


def test_chaos_stream_matches_reference_statuses(params):
    """The same seeded chaos stream through both packages' engines: the
    same statuses, error codes, buckets and counters, outputs within
    2e-4 (weights carried across with params_from_numpy)."""
    from dataclasses import replace

    ref_params = ref_rt.InferenceEngine(
        DIMS, policy=RefPolicy(min_nodes=16, min_degree=4, max_graphs=4),
    ).init(jax.random.PRNGKey(3))
    port_params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")

    def ref_make(n, seed, rid):
        src = np.arange(n)
        dst = (src + 1) % n
        g = ref_from_edges(n, np.concatenate([src, dst]), np.concatenate([dst, src]))
        x = np.random.default_rng(seed).normal(size=(n, DIMS[0][0])).astype(np.float32)
        return ref_rt.Request(graph=g, x=x, rid=rid)

    from repro.graphs import CSRGraph as RefCSR

    ref_reqs, kr = _chaos_stream(ref_make, RefCSR, replace)
    reqs, kernel_rids = _chaos_stream(make_request, CSRGraph, replace)
    assert kr == kernel_rids
    kw = dict(min_nodes=16, min_degree=4, max_graphs=4, max_nodes=64)
    ref_eng = ref_rt.InferenceEngine(
        DIMS, ref_params, policy=RefPolicy(**kw),
        schedule=RefSchedule.from_policies("sp_opt", "AC", DIMS),
        retry=ref_rt.RetryPolicy(max_retries=0),
        fault_injector=ref_rt.FaultInjector(
            rules=[ref_rt.FaultRule(kind="exception", rid=r) for r in kr]),
    )
    eng = make_engine(
        port_params, policy=BucketPolicy(**kw),
        fault_injector=FaultInjector(
            rules=[FaultRule(kind="exception", rid=r) for r in kernel_rids]),
    )
    got, want = eng.submit(reqs), ref_eng.submit(ref_reqs)
    for a, b in zip(got, want):
        assert (a.rid, a.status, a.error_type, a.bucket, a.tier) == (
            b.rid, b.status, b.error_type, b.bucket, b.tier)
        if a.ok:
            np.testing.assert_allclose(a.output, b.output, rtol=2e-4, atol=2e-4)
    s, r = eng.stats(), ref_eng.stats()
    for k in ("n_requests", "n_batches", "n_buckets", "n_ok", "n_rejected",
              "n_failed", "n_degraded", "n_retries", "n_downgrades",
              "n_solo_retries", "errors", "cache_hits", "cache_misses"):
        assert getattr(s, k) == getattr(r, k), k


# ---------------------------------------------------------------------------
# Training-side runner and straggler monitor
# ---------------------------------------------------------------------------


def sgd_step(state, batch):
    return state - 0.1 * (state - batch), {"loss": float(np.sum(state**2))}


def make_batches(seed: int = 0):
    data = np.random.default_rng(seed).normal(size=(64, 4)).astype(np.float32)
    return lambda s: data[s % len(data)]


def run_clean(num_steps: int, checkpoint_every: int = 4):
    runner = ResilientRunner(
        step_fn=sgd_step, save_fn=lambda s, st: None,
        restore_fn=lambda: (_ for _ in ()).throw(AssertionError("no restore")),
        checkpoint_every=checkpoint_every,
    )
    return runner.run(np.ones(4, np.float32), make_batches(), 0, num_steps)


def test_runner_transient_fault_identical():
    clean_state, clean_metrics = run_clean(10)
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("transient node failure")
        return sgd_step(state, batch)

    runner = ResilientRunner(step_fn=flaky, save_fn=lambda s, st: None,
                             restore_fn=lambda: (0, np.ones(4, np.float32)),
                             checkpoint_every=100)
    state, metrics = runner.run(np.ones(4, np.float32), make_batches(), 0, 10)
    assert np.array_equal(state, clean_state) and metrics == clean_metrics


def test_runner_restore_resumes_bit_identical_without_replayed_logs():
    clean_state, clean_metrics = run_clean(12, checkpoint_every=4)
    saved, budget, where = {}, {"n": 4}, {"step": 0}
    batches = make_batches()

    def save(step, st):
        saved["step"], saved["state"] = step, np.array(st, copy=True)

    def step_fn(state, batch):
        if where["step"] == 6 and budget["n"] > 0:
            budget["n"] -= 1
            raise RuntimeError("persistent kernel fault")
        return sgd_step(state, batch)

    def tracking(s):
        where["step"] = s
        return batches(s)

    runner = ResilientRunner(
        step_fn=step_fn, save_fn=save,
        restore_fn=lambda: (saved["step"], np.array(saved["state"], copy=True)),
        checkpoint_every=4, max_retries=2,
    )
    state, metrics = runner.run(np.ones(4, np.float32), tracking, 0, 12)
    assert np.array_equal(state, clean_state) and metrics == clean_metrics
    assert [m["step"] for m in metrics] == list(range(12))


def test_runner_no_backoff_sleep_on_restore(monkeypatch):
    sleeps = []
    monkeypatch.setattr(ft_mod.time, "sleep", lambda s: sleeps.append(s))
    budget = {"n": 1}

    def step_fn(state, batch):
        if budget["n"] > 0:
            budget["n"] -= 1
            raise RuntimeError("fault")
        return sgd_step(state, batch)

    ResilientRunner(step_fn=step_fn, save_fn=lambda s, st: None,
                    restore_fn=lambda: (0, np.ones(4, np.float32)),
                    max_retries=0, backoff_s=5.0,
                    ).run(np.ones(4, np.float32), make_batches(), 0, 3)
    assert sleeps == []


def test_retry_policy_delays_match_reference():
    for kw in (dict(max_retries=3, backoff_s=0.1, multiplier=2.0,
                    max_backoff_s=0.3), dict(max_retries=1)):
        mine, ref = RetryPolicy(**kw), ref_rt.RetryPolicy(**kw)
        assert [mine.delay(i) for i in range(5)] == [ref.delay(i) for i in range(5)]
        assert mine.max_attempts == ref.max_attempts
    with pytest.raises(ValueError, match="max_retries"):
        RetryPolicy(max_retries=-1)


def test_straggler_monitor_flags_and_fires_hook():
    hits = []
    mon = StragglerMonitor(threshold=3.0, on_straggler=lambda *a: hits.append(a))
    for i in range(10):
        assert not mon.record(i, 0.01)
    assert mon.record(10, 0.5)
    assert mon.flagged == [10] and hits and hits[0][0] == 10
