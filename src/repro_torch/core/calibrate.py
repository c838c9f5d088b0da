"""Kernel calibration: fit :class:`LatencyModel` to measured wall-clock.

The port of :mod:`repro.core.calibrate`.  The grid, the fit and the model
file are the reference's; the measurements run the port's kernel tiers on
the card (or the CPU, when asked), timed by
:func:`repro_torch.kernels.common.measure_wall`, and the fitted model is
keyed by :func:`backend_fingerprint` (``cuda:<device name>:torch-<ver>``).

The simulator's closed forms (Sec 5 of the paper) predict *relative* cost
from first principles, but every constant in them is a paper constant that
has never been checked against this backend (ROADMAP open item 2).  The
communication-requirements line of work argues such models must be anchored
to measured constants to be predictive, and the empirical GEMM performance
models show the recipe: microbenchmark a grid, least-squares a handful of
bandwidth/overhead constants, report residual error.

This module is that recipe for the multiphase GNN kernels:

1. :func:`measure_grid` microbenchmarks the registered kernel families
   (``seq`` / ``sp_generic`` / ``sp_opt``, eager twins or CUDA kernels)
   across a policy x phase-order x graph-size grid of synthetic workloads,
   timing each compiled :class:`~repro_torch.api.Program` with
   :func:`~repro_torch.kernels.common.measure_wall` and pricing the same
   schedule with the *identity* (uncalibrated) analytic model.
2. :func:`fit_latency_model` solves a relative-error weighted least
   squares for per-family overheads + per-dispatch setup, grid-searching
   the effective-bandwidth axis, and reports per-point relative error.
   The fit is pure and deterministic: same points in, same model out.
3. :func:`calibrate` composes the two and (optionally) persists the
   fitted model beside a :class:`~repro_torch.runtime.store.ProgramStore`,
   keyed by :func:`backend_fingerprint`, where the serving engine picks it
   up automatically.

The ``pp`` family executes through the ``sp_generic`` band scan on a
single-device host (see :mod:`repro_torch.gnn.pp`), so its overhead is tied to
the ``sp_generic`` fit unless pp observations are supplied.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .cost_model import GNNLayerWorkload
from .hw import AcceleratorConfig, DEFAULT_ACCEL, LatencyModel
from .schedule import ModelSchedule
from .simulator import simulate_model

#: default calibration grid: every single-device-executable policy family
#: x both phase orders x a ladder of synthetic graph sizes (v, avg_degree).
CAL_POLICIES = ("seq", "sp_generic", "sp_opt")
CAL_ORDERS = ("AC", "CA")
CAL_SIZES = ((256, 8), (1024, 8), (2048, 16))
CAL_SIZES_FAST = ((256, 8), (1024, 8))
#: (f_in, f_out) of the single calibration layer.
CAL_DIMS = (32, 32)
#: effective-bandwidth grid (multipliers on the nominal ``gb_bandwidth``)
#: the fit searches over.
CAL_BW_MULTS = (0.25, 0.5, 1.0, 2.0, 4.0)


def backend_fingerprint(device=None) -> str:
    """Identity of the measured backend: fitted models only transfer to
    the platform they were measured on, so stored models are keyed by
    this string: ``cuda:<device name>:torch-<version>`` on the card (the
    CUDA device unless ``device`` names another),
    ``cpu:cpu:torch-<version>`` for ``device="cpu"``."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return f"{dev.type}:{name}:torch-{torch.__version__}"


def _synthetic_graph(v: int, degree: int, seed: int):
    """Deterministic random graph with ~``degree`` average in-degree and
    no isolated nodes (a ring underlay guarantees connectivity)."""
    from ..graphs.csr import from_edges

    rng = np.random.default_rng(seed)
    m = v * degree
    src = rng.integers(0, v, size=m)
    dst = rng.integers(0, v, size=m)
    ring = np.arange(v)
    return from_edges(
        v,
        np.concatenate([src, ring]),
        np.concatenate([dst, (ring + 1) % v]),
    )


@dataclass(frozen=True)
class CalibrationPoint:
    """One (kernel config, workload) microbenchmark observation."""

    policy: str  # fitted family: seq | sp_generic | sp_opt | pp
    order: str  # AC | CA
    v: int
    degree: int
    f_in: int
    f_out: int
    use_pallas: bool
    cycles: float  # analytic cycles under the identity LatencyModel
    measured_s: float  # measured wall seconds (measure_wall median)
    #: analytic cycles re-priced at each effective-bandwidth multiplier,
    #: as (multiplier, cycles) pairs — the fit's bw_eff search axis.
    cycles_by_bw: tuple[tuple[float, float], ...] = ()

    def cycles_at(self, bw_mult: float) -> float:
        for m, c in self.cycles_by_bw:
            if m == bw_mult:
                return c
        if bw_mult == 1.0:
            return self.cycles
        raise KeyError(f"no cycles recorded at bw multiplier {bw_mult}")


@dataclass(frozen=True)
class FitReport:
    """A fitted model plus the evidence behind it."""

    model: LatencyModel
    n_points: int
    error_median: float
    error_max: float
    bw_mult: float  # winning effective-bandwidth multiplier
    #: per-family diagnostics: family -> {n, overhead, error_median}
    per_family: dict
    #: per-point relative errors, in measure_grid order
    errors: tuple[float, ...] = ()

    def to_dict(self) -> dict:
        from dataclasses import asdict

        return {
            "model": asdict(self.model),
            "n_points": self.n_points,
            "error_median": self.error_median,
            "error_max": self.error_max,
            "bw_mult": self.bw_mult,
            "per_family": self.per_family,
            "errors": list(self.errors),
        }


def measure_grid(
    *,
    policies: tuple[str, ...] = CAL_POLICIES,
    orders: tuple[str, ...] = CAL_ORDERS,
    sizes: tuple[tuple[int, int], ...] = CAL_SIZES,
    dims: tuple[int, int] = CAL_DIMS,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    use_pallas: bool = False,
    bw_mults: tuple[float, ...] = CAL_BW_MULTS,
    warmup: int = 1,
    iters: int = 5,
    seed: int = 0,
    device=None,
) -> list[CalibrationPoint]:
    """Microbenchmark the kernel grid; returns one point per cell.

    Every point compiles a homogeneous schedule
    (:meth:`ModelSchedule.from_policies`) for a synthetic workload, runs
    it through the real kernel registry and times it with
    :func:`measure_wall`; the identity-model analytic cycles for the same
    schedule ride along, plus a ladder of re-pricings across ``bw_mults``
    so the fit can search the effective-bandwidth axis without
    re-simulating.  Runs on ``device`` (None: the CUDA device).
    """
    import torch

    from ..api import compile as _compile
    from ..device import resolve_device
    from ..kernels.common import measure_wall

    dev = resolve_device(device)
    f_in, f_out = dims
    identity = LatencyModel()
    hw0 = replace(hw, latency=identity)
    points: list[CalibrationPoint] = []
    for si, (v, degree) in enumerate(sizes):
        g = _synthetic_graph(v, degree, seed + si)
        wl = GNNLayerWorkload(g.nnz, f_in, f_out, name="cal")
        rng = np.random.default_rng(seed + 1000 + si)
        x = torch.as_tensor(
            rng.standard_normal((g.n_nodes, f_in)).astype(np.float32),
            device=dev,
        )
        for policy in policies:
            for order in orders:
                sched = ModelSchedule.from_policies(
                    policy, order, [(f_in, f_out)], v=v
                )
                prog = _compile(
                    [wl],
                    graph=g,
                    hw=hw0,
                    schedule=sched,
                    use_pallas=use_pallas,
                    latency_model=identity,
                    device=dev,
                )
                params = prog.init(torch.Generator().manual_seed(seed))
                measured = measure_wall(
                    lambda: prog.run(params, x), warmup=warmup, iters=iters
                )
                ladder = tuple(
                    (
                        float(m),
                        float(
                            simulate_model(
                                sched.dataflows,
                                [wl],
                                replace(
                                    hw0,
                                    latency=LatencyModel(
                                        bw_eff=float(m) * hw0.gb_bandwidth
                                    ),
                                ),
                            ).cycles
                        ),
                    )
                    for m in bw_mults
                )
                points.append(
                    CalibrationPoint(
                        policy=policy,
                        order=order,
                        v=v,
                        degree=degree,
                        f_in=f_in,
                        f_out=f_out,
                        use_pallas=use_pallas,
                        cycles=float(prog.stats.cycles),
                        measured_s=float(measured),
                        cycles_by_bw=ladder,
                    )
                )
    return points


def _solve(points, families, bw_mult):
    """Relative-error weighted least squares at one bandwidth multiplier.

    Model: measured_i ~ a_{family(i)} * cycles_i + b, rows weighted by
    1/measured_i so the residual is (pred - meas) / meas.  Returns
    (a per family, b, per-point relative errors).
    """
    fam_idx = {f: j for j, f in enumerate(families)}
    n, k = len(points), len(families)
    X = np.zeros((n, k + 1))
    y = np.ones(n)
    cyc = np.array([p.cycles_at(bw_mult) for p in points])
    meas = np.array([p.measured_s for p in points])
    for i, p in enumerate(points):
        X[i, fam_idx[p.policy]] = cyc[i] / meas[i]
        X[i, k] = 1.0 / meas[i]
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    a, b = coef[:k], float(coef[k])
    if b < 0.0:
        # negative setup is unphysical; refit through the origin
        coef, *_ = np.linalg.lstsq(X[:, :k], y, rcond=None)
        a, b = coef, 0.0
    for j, f in enumerate(families):
        if a[j] <= 0.0:
            # degenerate family (e.g. constant cycles across its points):
            # fall back to the robust per-family ratio
            sel = np.array([p.policy == f for p in points])
            a[j] = float(np.median(meas[sel] / cyc[sel]))
    pred = a[[fam_idx[p.policy] for p in points]] * cyc + b
    errors = np.abs(pred - meas) / meas
    return a, b, errors


def fit_latency_model(
    points: list[CalibrationPoint],
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    backend: str = "",
) -> FitReport:
    """Fit a :class:`LatencyModel` to measured points (pure + deterministic).

    Grid-searches the effective-bandwidth multipliers the points carry,
    solving the per-family overhead + setup least squares at each, and
    keeps the multiplier with the lowest median relative error (ties go
    to the multiplier closest to 1.0).  ``cycle_time_s`` is normalized so
    the smallest family overhead is exactly 1.0.
    """
    if not points:
        raise ValueError("cannot fit a LatencyModel to zero points")
    families = sorted({p.policy for p in points})
    mults = sorted(
        {m for p in points for m, _ in p.cycles_by_bw} or {1.0}
    )
    best = None
    for mult in mults:
        a, b, errors = _solve(points, families, mult)
        med = float(np.median(errors))
        key = (med, abs(np.log2(mult)))
        if best is None or key < best[0]:
            best = (key, mult, a, b, errors)
    _, bw_mult, a, b, errors = best

    fam_idx = {f: j for j, f in enumerate(families)}
    cycle_time = float(np.min(a))
    overheads = {f: float(a[fam_idx[f]] / cycle_time) for f in families}
    # families without observations: pp executes the sp_generic fallback
    # on single-device hosts; anything else stays neutral at the mean
    mean_ov = float(np.mean(list(overheads.values())))
    full = {}
    for f in LatencyModel.OVERHEAD_FAMILIES:
        if f in overheads:
            full[f] = overheads[f]
        elif f == "pp" and "sp_generic" in overheads:
            full[f] = overheads["sp_generic"]
        else:
            full[f] = mean_ov
    med = float(np.median(errors))
    model = LatencyModel(
        overhead_seq=full["seq"],
        overhead_sp_generic=full["sp_generic"],
        overhead_sp_opt=full["sp_opt"],
        overhead_pp=full["pp"],
        bw_eff=(
            None
            if bw_mult == 1.0
            else float(bw_mult) * float(hw.gb_bandwidth)
        ),
        c_setup=float(b / cycle_time),
        cycle_time_s=cycle_time,
        backend=backend,
        fit_error_median=med,
    )
    per_family = {
        f: {
            "n": int(sum(p.policy == f for p in points)),
            "overhead": overheads[f],
            "error_median": float(
                np.median([e for p, e in zip(points, errors) if p.policy == f])
            ),
        }
        for f in families
    }
    return FitReport(
        model=model,
        n_points=len(points),
        error_median=med,
        error_max=float(np.max(errors)),
        bw_mult=float(bw_mult),
        per_family=per_family,
        errors=tuple(float(e) for e in errors),
    )


def calibrate(
    *,
    hw: AcceleratorConfig = DEFAULT_ACCEL,
    fast: bool = False,
    use_pallas: bool = False,
    store=None,
    seed: int = 0,
    warmup: int = 1,
    iters: int = 5,
    device=None,
) -> FitReport:
    """Measure the kernel grid, fit the model, optionally persist it.

    ``fast`` shrinks the grid for smoke runs.  With ``store`` (a
    :class:`~repro_torch.runtime.store.ProgramStore`), the fitted model is
    saved beside the program artifacts keyed by
    :func:`backend_fingerprint` of ``device`` (None: the CUDA device),
    where the engine auto-loads it.
    """
    points = measure_grid(
        sizes=CAL_SIZES_FAST if fast else CAL_SIZES,
        hw=hw,
        use_pallas=use_pallas,
        seed=seed,
        warmup=warmup,
        iters=max(1, iters // 2) if fast else iters,
        device=device,
    )
    report = fit_latency_model(
        points, hw=hw, backend=backend_fingerprint(device)
    )
    if store is not None:
        store.save_latency_model(report.model)
    return report
