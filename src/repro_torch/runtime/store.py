"""Persistent program store: compiled serving artifacts that survive the
process.

The port of :mod:`repro.runtime.store`.  Keys, digests, artifacts, the
index, the traffic profile and the latency-model file keep the reference's
formats (``asdict(AcceleratorConfig)`` is the same in both packages), so a
store written by ``repro`` revives a ``repro_torch`` engine and the other
way round.

The serving engine's :class:`~repro_torch.runtime.engine.ProgramCache`
amortizes mapper search and executable builds *within* a process; every
restart would pay all of it again.  The paper's premise is that
the expensive part — exploring the sparse/dense dataflow design-space —
is per workload *shape*, not per request, so the searched schedule should
outlive the process.  This module is that persistence layer:

* :class:`ProgramStore` — a directory of :class:`~repro_torch.api.Program`
  JSON artifacts keyed by ``(layer dims, bucket shape, kind, objective,
  tier, hw)``.  ``Program.save``/``load`` is already byte-stable JSON
  with a workload fingerprint, so the store is artifacts plus a versioned
  index.  Loads are **corruption-tolerant by construction**: the artifact
  path is derived from the key digest (the index is informational), and a
  truncated / garbage / wrong-format artifact is a counted cache miss,
  never a crash — the engine just recompiles and :meth:`put` repairs the
  entry atomically.
* :func:`enable_persistent_kernel_cache` — the counterpart of the
  reference's ``enable_persistent_compilation_cache`` (which points XLA's
  cache at a directory): it points the CUDA kernel builds
  (:func:`repro_torch.kernels.common.set_build_dir`) at one, so a revived
  process loads its ``nvcc``-built libraries instead of building them.
  :meth:`InferenceEngine.precompile
  <repro_torch.runtime.engine.InferenceEngine.precompile>` moves the
  executable builds off the request path at startup.
* The recorded :class:`~repro_torch.graphs.batching.TrafficProfile` is
  serialized alongside the artifacts (:meth:`ProgramStore.save_profile`)
  so a revived engine knows which bucket shapes to warm, hottest first.

Store layout::

    <root>/
      index.json              # versioned key -> file listing (informational)
      <digest>.program.json   # one Program artifact per key
      traffic.json            # TrafficProfile (bucket heat across lives)
      kernels/                # CUDA kernel builds (opt-in)
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import asdict
from pathlib import Path
from typing import Iterator

from ..api import Program
from ..graphs.batching import TrafficProfile
from ..kernels.common import BUILD_DIR_ENV, set_build_dir

STORE_FORMAT = "repro.store/v1"

#: environment override of the kernel build directory (see
#: :func:`enable_persistent_kernel_cache`).
KERNEL_CACHE_ENV = BUILD_DIR_ENV

_INDEX = "index.json"
_PROFILE = "traffic.json"
_SUFFIX = ".program.json"
_LATENCY = "latency_model.json"

#: LatencyModel collection file schema version.
LATENCY_STORE_FORMAT = "repro.latency-store/v1"


def store_key(
    dims,
    bucket: tuple[int, int],
    v_total: int,
    *,
    kind: str,
    objective: str,
    use_pallas: bool,
    searched: bool = True,
    hw=None,
) -> dict:
    """The canonical store key for one compiled serving artifact.

    ``dims`` + ``bucket`` are the workload fingerprint at serving
    granularity: every micro-batch of a bucket presents the same padded
    shapes, so one artifact serves them all (``v_total`` distinguishes
    slot-count variants of the bucket — their executables differ).
    ``hw`` is an :class:`~repro_torch.core.hw.AcceleratorConfig` (or ``None``
    for "any").
    """
    return {
        "dims": [[int(fi), int(fo)] for fi, fo in dims],
        "bucket": [int(bucket[0]), int(bucket[1])],
        "v_total": int(v_total),
        "kind": str(kind),
        "objective": str(objective),
        "use_pallas": bool(use_pallas),
        "searched": bool(searched),
        "hw": None if hw is None else {k: v for k, v in sorted(asdict(hw).items())},
    }


def key_digest(key: dict) -> str:
    """Stable content digest of a store key (the artifact's filename)."""
    blob = json.dumps(key, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def _atomic_write_text(path: Path, text: str) -> None:
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    try:
        tmp.write_text(text)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


class ProgramStore:
    """On-disk cache of compiled :class:`~repro_torch.api.Program` artifacts.

    ``get`` returns ``None`` on any miss — absent, truncated, garbage,
    wrong artifact format, or key mismatch — and counts the cause
    (``hits`` / ``misses`` / ``corrupt``); it never raises for a bad
    artifact, because a store must degrade to a recompile, not take the
    serving process down.  ``put`` writes atomically (temp file +
    ``os.replace``) so a crash mid-write can't strand a truncated entry.

    The index file is a versioned, human-readable listing (key -> file);
    it is *not* load-bearing: artifact paths derive from the key digest,
    so a corrupt or missing index only costs :meth:`keys` its listing
    until the next :meth:`put` rewrites it.

    One store instance may back several per-device engines at once (the
    async front-end shares it across workers), so counters, index updates
    and profile writes are serialized by a lock; the artifact files
    themselves were already safe under concurrency (atomic writes, derived
    paths).
    """

    def __init__(self, root, *, kernel_cache: bool = False):
        self.root = Path(root).expanduser()
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.corrupt = 0  # artifacts that existed but failed to load
        self._lock = threading.Lock()
        self._index: dict[str, dict] = self._load_index()
        if kernel_cache:
            # co-locate the kernel builds with the store unless the
            # operator pointed REPRO_TORCH_KERNEL_DIR somewhere else
            enable_persistent_kernel_cache(
                None if os.environ.get(KERNEL_CACHE_ENV)
                else self.root / "kernels"
            )

    # -- index ---------------------------------------------------------------
    def _load_index(self) -> dict[str, dict]:
        path = self.root / _INDEX
        try:
            d = json.loads(path.read_text())
            if d.get("format") != STORE_FORMAT:
                raise ValueError(f"index format {d.get('format')!r}")
            return dict(d["entries"])
        except FileNotFoundError:
            return {}
        except Exception:
            # a bad index is cosmetic: rebuild the listing from the
            # artifacts actually on disk (their keys are in the payloads)
            entries: dict[str, dict] = {}
            for p in sorted(self.root.glob(f"*{_SUFFIX}")):
                entries[p.name[: -len(_SUFFIX)]] = {"file": p.name}
            return entries

    def _save_index(self) -> None:
        payload = {"format": STORE_FORMAT, "entries": self._index}
        _atomic_write_text(
            self.root / _INDEX,
            json.dumps(payload, indent=2, sort_keys=True) + "\n",
        )

    # -- artifacts -----------------------------------------------------------
    def path_for(self, key: dict) -> Path:
        return self.root / f"{key_digest(key)}{_SUFFIX}"

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob(f"*{_SUFFIX}"))

    def __contains__(self, key: dict) -> bool:
        return self.path_for(key).exists()

    def keys(self) -> Iterator[dict]:
        """The indexed keys (informational listing)."""
        for entry in self._index.values():
            if "key" in entry:
                yield entry["key"]

    def get(self, key: dict) -> Program | None:
        """Load the artifact for ``key``, or ``None`` (miss) — never
        raises for a bad artifact."""
        path = self.path_for(key)
        if not path.exists():
            with self._lock:
                self.misses += 1
            return None
        try:
            prog = Program.from_json(path.read_text())
        except Exception:
            # truncated write, garbage bytes, or a PROGRAM_FORMAT bump:
            # all of them degrade to a recompile
            with self._lock:
                self.corrupt += 1
                self.misses += 1
            return None
        with self._lock:
            self.hits += 1
        return prog

    def put(self, key: dict, program: Program) -> Path:
        """Persist ``program`` under ``key`` (atomic), update the index."""
        digest = key_digest(key)
        path = self.root / f"{digest}{_SUFFIX}"
        program.save(path)  # Program.save is atomic
        with self._lock:
            self._index[digest] = {"file": path.name, "key": key}
            self._save_index()
        return path

    # -- traffic profile -----------------------------------------------------
    @property
    def profile_path(self) -> Path:
        return self.root / _PROFILE

    def save_profile(self, profile: TrafficProfile) -> Path:
        with self._lock:
            return profile.save(self.profile_path)

    def load_profile(self) -> TrafficProfile | None:
        """The persisted bucket-heat profile, or ``None`` when absent or
        unreadable (same corruption tolerance as :meth:`get`)."""
        try:
            return TrafficProfile.load(self.profile_path)
        except FileNotFoundError:
            return None
        except Exception:
            with self._lock:
                self.corrupt += 1
            return None

    # -- fitted latency models ----------------------------------------------
    @property
    def latency_path(self) -> Path:
        return self.root / _LATENCY

    def save_latency_model(self, model) -> Path:
        """Persist a fitted :class:`~repro_torch.core.hw.LatencyModel` beside
        the program artifacts, keyed by the backend fingerprint it was
        measured on (one file holds all backends; saving merges)."""
        from ..core.hw import LatencyModel

        if not isinstance(model, LatencyModel):
            raise TypeError(f"expected a LatencyModel, got {type(model).__name__}")
        if not model.backend:
            raise ValueError(
                "refusing to store a LatencyModel with no backend "
                "fingerprint — fit it via repro_torch.core.calibrate"
            )
        with self._lock:
            models = self._load_latency_models()
            entry = json.loads(model.to_json())
            entry.pop("format")
            models[model.backend] = entry
            payload = {"format": LATENCY_STORE_FORMAT, "models": models}
            _atomic_write_text(
                self.latency_path,
                json.dumps(payload, indent=2, sort_keys=True) + "\n",
            )
        return self.latency_path

    def _load_latency_models(self) -> dict:
        try:
            d = json.loads(self.latency_path.read_text())
            if d.get("format") != LATENCY_STORE_FORMAT:
                raise ValueError(f"latency store format {d.get('format')!r}")
            return dict(d["models"])
        except FileNotFoundError:
            return {}
        except Exception:
            self.corrupt += 1
            return {}

    def load_latency_model(self, backend: str):
        """The fitted model for ``backend`` (a
        :func:`~repro_torch.core.calibrate.backend_fingerprint` string), or
        ``None`` when absent/unreadable — same corruption tolerance as
        :meth:`get`."""
        from ..core.hw import LatencyModel

        with self._lock:
            entry = self._load_latency_models().get(backend)
        if entry is None:
            return None
        try:
            return LatencyModel(**entry)
        except Exception:
            with self._lock:
                self.corrupt += 1
            return None

    def stats(self) -> dict:
        return {
            "n_artifacts": len(self),
            "hits": self.hits,
            "misses": self.misses,
            "corrupt": self.corrupt,
        }


def enable_persistent_kernel_cache(cache_dir=None) -> Path:
    """Point the CUDA kernel builds at ``cache_dir`` so the ``nvcc``-built
    libraries behind the kernel tier survive restarts (a library is built
    once per source hash and loaded after that).

    Resolution order: explicit ``cache_dir`` argument, the
    ``REPRO_TORCH_KERNEL_DIR`` environment variable, then the checkout's
    ``build/kernels`` (see :func:`repro_torch.kernels.common.set_build_dir`;
    nothing outside the checkout is written unless asked).  Returns the
    directory.
    """
    return set_build_dir(cache_dir)
