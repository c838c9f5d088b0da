"""Hardware abstraction for the spatial-accelerator model (paper Sec. 2.2).

A copy of :mod:`repro.core.hw` without the TPU chip constants (the port's
device constants arrive with its roofline analysis).  Carries
:class:`HWGrid` — the broadcastable hardware axis the co-design search
(:func:`repro.core.mapper.search_codesign`) and the batched simulator
(:func:`repro.core.simulator.simulate_batch`) sweep — and
:class:`LatencyModel`, the fittable latency constants the calibration
harness (:mod:`repro.core.calibrate`) anchors to measured wall-clock.
"""
from __future__ import annotations

import itertools
import json
import os
from dataclasses import asdict, dataclass, field, replace
from pathlib import Path

import numpy as np

#: LatencyModel artifact schema version (same bump discipline as
#: ``repro.api.PROGRAM_FORMAT``).
LATENCY_FORMAT = "repro.latency/v1"

#: environment override: path to a fitted :class:`LatencyModel` JSON file
#: that ``repro.compile`` and the serving engine load when no explicit
#: model is passed.
LATENCY_MODEL_ENV = "REPRO_LATENCY_MODEL"


@dataclass(frozen=True)
class LatencyModel:
    """Fittable latency constants over the analytic cycle model.

    The simulator's closed forms predict *relative* cost from first
    principles; this parameter set anchors them to a measured backend the
    way the empirical GEMM performance models do (per-direction effective
    bandwidth, a compute ``overhead_factor``, a per-transfer ``C_setup``):

    ``cycles_calibrated = overhead(family) * cycles_analytic(bw_eff,
    dram_bw) + c_setup``, and ``wall_s = cycle_time_s * cycles_calibrated``.

    The default instance is the **identity**: every multiplier is 1.0 and
    every additive term 0.0, so an uncalibrated
    :class:`AcceleratorConfig` reproduces the paper-constant simulator
    outputs bit-for-bit (pinned by ``tests/test_calibrate.py``).  A fitted
    instance (see :func:`repro.core.calibrate.fit_latency_model`) records
    the backend fingerprint it was measured on plus its residual error.
    """

    #: per-policy-family compute-overhead multipliers on the analytic
    #: cycle count (the GEMM model's ``overhead_factor``, one per
    #: executable kernel family).
    overhead_seq: float = 1.0
    overhead_sp_generic: float = 1.0
    overhead_sp_opt: float = 1.0
    overhead_pp: float = 1.0
    #: measured effective GB<->PE bandwidth in elements/cycle (the GEMM
    #: model's ``BW``).  ``None`` = the nominal ``gb_bandwidth``.  On an
    #: :class:`HWGrid` sweep the ratio ``bw_eff / base.gb_bandwidth``
    #: derates every grid point's bandwidth column.
    bw_eff: float | None = None
    #: per-kernel-dispatch setup overhead in cycles (the GEMM model's
    #: ``C_setup``), charged once per simulated layer.
    c_setup: float = 0.0
    #: DRAM spill bandwidth in elements/cycle: when the staged
    #: intermediate exceeds ``gb_capacity_bytes`` the serialized hand-off
    #: moves at this rate instead of the GB bandwidth.  ``None`` keeps the
    #: pre-calibration behavior (spills change energy only).
    dram_bw: float | None = None
    #: seconds per calibrated cycle.  0.0 = uncalibrated: the model ranks
    #: but cannot predict wall-clock.
    cycle_time_s: float = 0.0
    #: backend fingerprint the fit was measured on ("" = uncalibrated).
    backend: str = ""
    #: median relative wall-clock error of the fit over its grid.
    fit_error_median: float = 0.0

    OVERHEAD_FAMILIES = ("seq", "sp_generic", "sp_opt", "pp")

    @property
    def calibrated(self) -> bool:
        return self.cycle_time_s > 0.0

    def overhead(self, family: str) -> float:
        """Compute-overhead multiplier for one kernel policy family
        (``seq`` / ``sp_generic`` / ``sp_opt`` / ``pp``)."""
        try:
            return float(getattr(self, f"overhead_{family}"))
        except AttributeError:
            raise ValueError(
                f"unknown policy family {family!r}; expected one of "
                f"{self.OVERHEAD_FAMILIES}"
            ) from None

    def effective_bw(self, gb_bandwidth: float) -> float:
        """The GB bandwidth the latency terms should use."""
        return float(gb_bandwidth) if self.bw_eff is None else float(self.bw_eff)

    def calibrate_cycles(self, cycles, family: str):
        """Analytic -> calibrated cycles (scalar or array; identity by
        default)."""
        return cycles * self.overhead(family) + self.c_setup

    def wall_s(self, cycles) -> float:
        """Predicted wall seconds for already-calibrated cycles."""
        if not self.calibrated:
            raise ValueError(
                "LatencyModel is uncalibrated (cycle_time_s == 0); run "
                "repro.core.calibrate.calibrate() or load a fitted model"
            )
        return float(cycles) * self.cycle_time_s

    # -- artifact -------------------------------------------------------------
    def to_json(self) -> str:
        """Canonical (sorted-keys) JSON; byte-stable across round-trips."""
        payload = {"format": LATENCY_FORMAT, **asdict(self)}
        return json.dumps(payload, indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "LatencyModel":
        d = json.loads(text)
        if d.get("format") != LATENCY_FORMAT:
            raise ValueError(
                f"not a {LATENCY_FORMAT} artifact (format={d.get('format')!r})"
            )
        d.pop("format")
        return cls(**d)

    def save(self, path) -> Path:
        """Atomic write (temp file + ``os.replace``), same contract as
        ``Program.save``."""
        p = Path(path)
        tmp = p.with_name(p.name + f".tmp.{os.getpid()}")
        try:
            tmp.write_text(self.to_json())
            os.replace(tmp, p)
        finally:
            tmp.unlink(missing_ok=True)
        return p

    @classmethod
    def load(cls, path) -> "LatencyModel":
        return cls.from_json(Path(path).read_text())

    @classmethod
    def from_env(cls) -> "LatencyModel | None":
        """The model pointed at by ``REPRO_LATENCY_MODEL``, or ``None``
        when the variable is unset (a set-but-unreadable path raises —
        a misconfigured deployment should fail loudly, not silently
        serve uncalibrated)."""
        path = os.environ.get(LATENCY_MODEL_ENV)
        if not path:
            return None
        return cls.load(path)


DEFAULT_LATENCY = LatencyModel()


@dataclass(frozen=True)
class AcceleratorConfig:
    """A templated flexible spatial accelerator (MAERI/SIGMA-like).

    The paper's substrate: a flat array of ``n_pes`` MAC units with private
    RFs, a shared Global Buffer, and configurable distribution/reduction
    networks.  ``gb_bandwidth`` is the number of elements that can be moved
    between the Global Buffer and the PE array per cycle (paper Fig. 13
    sweeps this).
    """

    n_pes: int = 512
    gb_bandwidth: int = 512  # elements / cycle, distribution + reduction
    gb_capacity_bytes: int | None = None  # None = sufficient (paper Sec 5.1.2)
    bytes_per_elem: int = 4
    # Energy constants from Dally et al. (paper Sec 5.2.2)
    gb_energy_pj: float = 1.046  # per access, 1 MB bank
    rf_energy_pj: float = 0.053  # per access, per-PE register file
    gb_bank_bytes: int = 1 << 20  # reference bank size for energy scaling
    # Scaling exponent for access energy vs buffer capacity (CACTI-like
    # sqrt scaling; the paper only states that smaller intermediate buffers
    # cost less per access — we make that concrete and document it).
    buffer_energy_exponent: float = 0.5
    dram_energy_pj: float = 100.0  # only used when gb_capacity is exceeded
    #: fittable latency constants (identity by default — see LatencyModel)
    latency: LatencyModel = DEFAULT_LATENCY

    @classmethod
    def from_dict(cls, d: dict) -> "AcceleratorConfig":
        """Rebuild from an ``asdict()`` payload.

        Tolerates artifacts written before the ``latency`` field existed
        (pre-calibration Programs/schedules keep loading) and converts a
        nested latency mapping back into a :class:`LatencyModel`.
        """
        d = dict(d)
        lat = d.pop("latency", None)
        if lat is None:
            lat = DEFAULT_LATENCY
        elif not isinstance(lat, LatencyModel):
            lat = LatencyModel(**lat)
        return cls(latency=lat, **d)

    def buffer_access_energy(self, capacity_bytes):
        """Energy per access for a buffer of the given capacity (pJ).

        Accepts a scalar or a numpy array of capacities (the batched
        simulator prices whole candidate grids through this one method, so
        the exponent/clamp can never drift between the scalar and
        vectorized paths).  Scalar in, ``float`` out; array in, array out.
        """
        cap = np.asarray(capacity_bytes, dtype=np.float64)
        ratio = np.where(cap > 0, cap / self.gb_bank_bytes, 1.0)
        e = np.minimum(
            np.maximum(
                self.gb_energy_pj * ratio**self.buffer_energy_exponent,
                self.rf_energy_pj,
            ),
            self.dram_energy_pj,
        )
        out = np.where(cap <= 0, self.rf_energy_pj, e)
        return float(out) if np.ndim(capacity_bytes) == 0 else out


DEFAULT_ACCEL = AcceleratorConfig()


def _axis(value, name: str) -> tuple:
    """Coerce a scalar / iterable axis spec to a non-empty tuple."""
    if value is None or isinstance(value, (int, float)):
        return (value,)
    out = tuple(value)
    if not out:
        raise ValueError(f"HWGrid axis {name!r} must not be empty")
    return out


@dataclass(frozen=True)
class HWGrid:
    """A broadcastable grid of accelerator configurations.

    The cartesian product of the three searchable hardware axes the paper's
    case studies sweep — PE count (Fig. 12's allocation study runs on top of
    it), Global-Buffer bandwidth (Fig. 13) and GB capacity — over a shared
    ``base`` config carrying the energy constants.  Points are enumerated in
    C order (``n_pes`` major, ``gb_capacity_bytes`` minor); ``configs()``
    materializes one frozen :class:`AcceleratorConfig` per point and
    ``columns()`` exposes the per-point arrays the batched simulator
    broadcasts against the dataflow axis.
    """

    n_pes: tuple[int, ...] = (DEFAULT_ACCEL.n_pes,)
    gb_bandwidth: tuple[int, ...] = (DEFAULT_ACCEL.gb_bandwidth,)
    gb_capacity_bytes: tuple[int | None, ...] = (None,)
    base: AcceleratorConfig = DEFAULT_ACCEL

    def __post_init__(self):
        # axes are integral (AcceleratorConfig's fields are ints): coercing
        # here keeps columns() and configs() pricing the same values
        def ints(values, name):
            out = []
            for v in _axis(values, name):
                if v != int(v):
                    raise ValueError(f"{name} must be integral, got {v}")
                out.append(int(v))
            return tuple(out)

        object.__setattr__(self, "n_pes", ints(self.n_pes, "n_pes"))
        object.__setattr__(
            self, "gb_bandwidth", ints(self.gb_bandwidth, "gb_bandwidth")
        )
        object.__setattr__(
            self,
            "gb_capacity_bytes",
            tuple(
                None if c is None else int(c)
                for c in _axis(self.gb_capacity_bytes, "gb_capacity_bytes")
            ),
        )
        for p in self.n_pes:
            if p < 1:
                raise ValueError(f"n_pes must be >= 1, got {p}")
        for b in self.gb_bandwidth:
            if b <= 0:
                raise ValueError(f"gb_bandwidth must be > 0, got {b}")

    def __len__(self) -> int:
        return (
            len(self.n_pes) * len(self.gb_bandwidth) * len(self.gb_capacity_bytes)
        )

    def __iter__(self):
        return iter(self.configs())

    def points(self) -> list[tuple[int, int, int | None]]:
        """(n_pes, gb_bandwidth, gb_capacity_bytes) per grid point."""
        return list(
            itertools.product(self.n_pes, self.gb_bandwidth, self.gb_capacity_bytes)
        )

    def configs(self) -> list[AcceleratorConfig]:
        """One frozen :class:`AcceleratorConfig` per grid point."""
        return [
            replace(self.base, n_pes=int(p), gb_bandwidth=int(b), gb_capacity_bytes=c)
            for p, b, c in self.points()
        ]

    def columns(self) -> dict[str, np.ndarray]:
        """Per-point arrays: ``n_pes`` (int64), ``gb_bw`` (float64) and
        ``gb_cap`` (float64, ``inf`` where capacity is unconstrained) — the
        hardware columns :func:`~repro.core.simulator.simulate_batch`
        broadcasts against the candidate axis."""
        pts = self.points()
        return {
            "n_pes": np.array([p for p, _, _ in pts], dtype=np.int64),
            "gb_bw": np.array([float(b) for _, b, _ in pts], dtype=np.float64),
            "gb_cap": np.array(
                [np.inf if c is None else float(c) for _, _, c in pts],
                dtype=np.float64,
            ),
        }

    def hw_cost(self) -> np.ndarray:
        """Provisioning-cost proxy per point: ``n_pes * gb_bandwidth``
        (compute lanes x interconnect wires, the two quantities the paper's
        case studies trade against dataflow choice)."""
        pts = self.points()
        return np.array([float(p) * float(b) for p, b, _ in pts], dtype=np.float64)
