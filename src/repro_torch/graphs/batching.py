"""Bucketized multi-graph batching: many graphs, few compiled shapes.

Real GNN serving traffic is a stream of small graphs (the paper batches
64/32 graphs per inference, Sec. 5.1.2); a JAX/XLA execution path pays a
fresh compile for every distinct input shape.  This module is the bridge
between the two facts:

* :class:`BucketPolicy` — a pow2 padding-bucket router.  Every graph maps
  to a ``(node_bucket, degree_bucket)`` key; graphs sharing a key batch
  together and pad to the *same* device shapes, so a whole request stream
  funnels into a handful of compiled executables.
* :func:`assemble` — block-diagonal micro-batch assembly
  (:func:`repro.graphs.csr.block_diagonal` under the hood) that pads the
  batch with isolated self-loop nodes up to the bucket shape and carries
  per-graph **segment ids**, so node features, labels, and per-graph
  readout survive batching (pad rows get segment id ``n_graphs``, which
  :func:`repro_torch.gnn.layers.segment_readout` masks out as
  out-of-range).

The serving loop on top lives in :mod:`repro_torch.runtime.engine`.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Sequence

import numpy as np

from .csr import CSRGraph, block_diagonal

TRAFFIC_FORMAT = "repro.traffic/v1"


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


@dataclass(frozen=True)
class BucketPolicy:
    """Pow2 padding buckets over (node count, max degree).

    ``min_nodes`` / ``min_degree`` floor the buckets so tiny graphs don't
    fragment the cache into near-empty shapes; ``max_graphs`` caps the
    micro-batch (the paper's 64-graph batches).  Slot counts of partial
    batches round up to a power of two too, so a bucket contributes at
    most ``log2(max_graphs) + 1`` distinct device shapes.

    ``max_nodes`` / ``max_degree`` are the explicit oversized-graph caps:
    a graph beyond either would otherwise silently compile a one-off giant
    bucket (its own mapper search + XLA trace that nothing else ever
    reuses).  With a cap set, :meth:`oversized_reason` names the violated
    limit and the serving engine rejects the request with a typed
    ``OversizedGraph`` error instead.  ``None`` (the default) keeps the
    pre-cap behavior: any size is admitted.
    """

    min_nodes: int = 32
    min_degree: int = 8
    max_graphs: int = 64
    max_nodes: int | None = None
    max_degree: int | None = None

    def oversized_reason(
        self,
        g: CSRGraph,
        *,
        f: int | None = None,
        hw=None,
    ) -> str | None:
        """Why ``g`` exceeds the admission caps, or ``None`` if it fits.

        With ``f`` (the model's widest layer dimension) and ``hw`` (an
        :class:`~repro.core.hw.AcceleratorConfig`), the check also prices
        the bucketed graph's staged V x f intermediate against
        ``gb_capacity_bytes`` — the same footprint the simulator's spill
        model charges DRAM energy for — so admission and the partition
        planner agree on what "oversized" means.
        """
        if self.max_nodes is not None and g.n_nodes > self.max_nodes:
            return (
                f"graph has {g.n_nodes} nodes, over the policy cap "
                f"max_nodes={self.max_nodes}"
            )
        if self.max_degree is not None and g.max_degree > self.max_degree:
            return (
                f"graph has max degree {g.max_degree}, over the policy cap "
                f"max_degree={self.max_degree}"
            )
        if f is not None and hw is not None and hw.gb_capacity_bytes is not None:
            from ..core.simulator import intermediate_footprint_bytes

            fb = intermediate_footprint_bytes(self.node_bucket(g.n_nodes), f, hw)
            if fb > hw.gb_capacity_bytes:
                return (
                    f"staged intermediate is {fb} bytes "
                    f"({self.node_bucket(g.n_nodes)} bucketed nodes x {f} "
                    f"features), over gb_capacity_bytes="
                    f"{hw.gb_capacity_bytes}"
                )
        return None

    def node_bucket(self, n_nodes: int) -> int:
        return max(self.min_nodes, next_pow2(n_nodes))

    def degree_bucket(self, max_degree: int) -> int:
        return max(self.min_degree, next_pow2(max_degree))

    def bucket_of(self, g: CSRGraph) -> tuple[int, int]:
        """The (node_bucket, degree_bucket) routing key for one graph."""
        return self.node_bucket(g.n_nodes), self.degree_bucket(g.max_degree)

    def slot_count(self, n_graphs: int) -> int:
        """Padded graph-slot count of a micro-batch (pow2, <= max_graphs)."""
        if n_graphs > self.max_graphs:
            raise ValueError(
                f"micro-batch of {n_graphs} graphs exceeds max_graphs="
                f"{self.max_graphs}"
            )
        return min(next_pow2(n_graphs), self.max_graphs)


def _pad_graph(n_pad: int) -> CSRGraph:
    """``n_pad`` isolated self-loop rows (weight 0, so they contribute
    nothing even before the segment readout drops them)."""
    return CSRGraph(
        row_ptr=np.arange(n_pad + 1, dtype=np.int64),
        col_idx=np.arange(n_pad, dtype=np.int32),
        values=np.zeros(n_pad, dtype=np.float32),
        n_nodes=n_pad,
    )


@dataclass(frozen=True)
class GraphBatch:
    """One assembled micro-batch: block-diagonal graph + segment ids.

    ``graph`` has exactly ``v_total = node_bucket * slots`` rows (member
    graphs first, then isolated zero-weight pad rows), so every batch from
    the same bucket presents identical device shapes.  ``segment_ids[i]``
    is the member-graph index of row ``i``; pad rows carry ``n_graphs``
    (out of range for ``num_segments=n_graphs``, hence dropped by
    ``jax.ops.segment_sum``/``segment_max``).
    """

    graph: CSRGraph
    segment_ids: np.ndarray  # (v_total,) int32
    sizes: np.ndarray  # (n_graphs,) int64 real node counts
    v_bucket: int  # node bucket each member padded into
    d_bucket: int  # padded-ELL width every member fits in

    @property
    def n_graphs(self) -> int:
        return int(len(self.sizes))

    @property
    def slots(self) -> int:
        """Padded graph-slot count (pow2).  Readout over ``slots`` segments
        keeps the executable shape fixed across batch fill levels; rows
        n_graphs..slots-1 of the result are pad segments to slice off."""
        return self.v_total // self.v_bucket

    @property
    def v_total(self) -> int:
        return self.graph.n_nodes

    @property
    def n_pad(self) -> int:
        return self.v_total - int(self.sizes.sum())

    @property
    def offsets(self) -> np.ndarray:
        """Start row of each member graph in the batched node dimension."""
        return np.concatenate([[0], np.cumsum(self.sizes)[:-1]]).astype(np.int64)

    def batch_features(self, xs: Sequence[np.ndarray]) -> np.ndarray:
        """Stack per-graph node features into the batched (v_total, F)
        array (zeros on pad rows)."""
        if len(xs) != self.n_graphs:
            raise ValueError(
                f"batch holds {self.n_graphs} graphs but got {len(xs)} "
                f"feature arrays"
            )
        for x, n in zip(xs, self.sizes):
            if x.shape[0] != n:
                raise ValueError(
                    f"feature array has {x.shape[0]} rows for a "
                    f"{n}-node graph"
                )
        f = xs[0].shape[1]
        out = np.zeros((self.v_total, f), dtype=np.float32)
        out[: int(self.sizes.sum())] = np.concatenate(xs, axis=0)
        return out

    def split_nodes(self, out: np.ndarray) -> list[np.ndarray]:
        """Slice a batched per-node output back into per-graph arrays
        (pad rows discarded)."""
        out = np.asarray(out)
        return [
            out[o : o + n]
            for o, n in zip(self.offsets, self.sizes)
        ]


def assemble(
    graphs: Sequence[CSRGraph], policy: BucketPolicy = BucketPolicy()
) -> GraphBatch:
    """Block-diagonal micro-batch assembly, padded to the bucket shape.

    All members must route to the same :meth:`BucketPolicy.bucket_of` key
    (that is the router's job); the assembled batch then has exactly
    ``node_bucket * slot_count`` rows and every neighbor list fits in
    ``degree_bucket`` padded-ELL slots.
    """
    if not graphs:
        raise ValueError("assemble() needs at least one graph")
    keys = {policy.bucket_of(g) for g in graphs}
    if len(keys) > 1:
        raise ValueError(
            f"graphs route to different buckets {sorted(keys)}; the router "
            f"must group a micro-batch into one bucket"
        )
    ((v_bucket, d_bucket),) = keys
    slots = policy.slot_count(len(graphs))
    v_total = v_bucket * slots
    sizes = np.array([g.n_nodes for g in graphs], dtype=np.int64)
    n_pad = v_total - int(sizes.sum())
    assert n_pad >= 0, "bucket arithmetic cannot under-allocate"
    members = list(graphs) + ([_pad_graph(n_pad)] if n_pad else [])
    batched = block_diagonal(members)
    segment_ids = np.full(v_total, len(graphs), dtype=np.int32)
    off = 0
    for i, n in enumerate(sizes):
        segment_ids[off : off + n] = i
        off += int(n)
    return GraphBatch(
        graph=batched,
        segment_ids=segment_ids,
        sizes=sizes,
        v_bucket=v_bucket,
        d_bucket=d_bucket,
    )


def micro_batches(
    graphs: Sequence[CSRGraph], policy: BucketPolicy = BucketPolicy()
):
    """The micro-batches a server runs for ``graphs``, in order: each
    bucket's members (in :func:`bucketize` order) in chunks of
    ``policy.max_graphs``, assembled.  Yields (bucket key, member ids,
    batch)."""
    for key, ids in bucketize(graphs, policy).items():
        for s in range(0, len(ids), policy.max_graphs):
            chunk = ids[s : s + policy.max_graphs]
            yield key, chunk, assemble([graphs[i] for i in chunk], policy)


def bucket_ell(
    graphs: Sequence[CSRGraph],
    key: tuple[int, int],
    policy: BucketPolicy = BucketPolicy(),
):
    """The first micro-batch of bucket ``key`` and its padded ELL, at the
    bucket's degree as a served batch binds it: (batch, indices, weights)."""
    batch = next(b for k, _, b in micro_batches(graphs, policy) if k == key)
    idx, wts, _ = batch.graph.to_ell(pad_to=batch.d_bucket)
    return batch, idx, wts


@dataclass
class TrafficProfile:
    """Recorded per-bucket traffic: what a serving process actually saw.

    Two ledgers, both additive counters:

    * ``requests[(v_bucket, d_bucket)]`` — how many requests routed to the
      bucket (its *heat*: the precompile priority order);
    * ``batches[(v_bucket, d_bucket, slots)]`` — how many micro-batches
      ran at each padded slot count.  The executable shape depends on
      ``(v_bucket * slots, d_bucket)``, so these triples are exactly the
      shapes a revived engine must warm to serve its first request
      build-free
      (:meth:`~repro_torch.runtime.engine.InferenceEngine.precompile`).

    The profile is serialized alongside the program store
    (:meth:`repro_torch.runtime.store.ProgramStore.save_profile`) so bucket heat
    survives the process; :meth:`merge` folds one life's traffic into the
    last one's.
    """

    requests: dict[tuple[int, int], int] = field(default_factory=dict)
    batches: dict[tuple[int, int, int], int] = field(default_factory=dict)
    #: measured batch wall-clock per schedule:
    #: ``(v_bucket, d_bucket, slots, schedule_digest) -> (count,
    #: total_wall_s)`` — the execution-feedback ledger the engine's
    #: measured re-ranking (:meth:`InferenceEngine.rerank_topk`) scores
    #: candidate schedules with.
    observed: dict[tuple[int, int, int, str], tuple[int, float]] = field(
        default_factory=dict
    )

    def record_request(self, bucket: tuple[int, int], n: int = 1) -> None:
        key = (int(bucket[0]), int(bucket[1]))
        self.requests[key] = self.requests.get(key, 0) + int(n)

    def record_batch(self, bucket: tuple[int, int], slots: int) -> None:
        key = (int(bucket[0]), int(bucket[1]), int(slots))
        self.batches[key] = self.batches.get(key, 0) + 1

    def record_wall(
        self,
        bucket: tuple[int, int],
        slots: int,
        schedule_digest: str,
        wall_s: float,
    ) -> None:
        """Fold one measured batch wall time into the observation ledger."""
        key = (int(bucket[0]), int(bucket[1]), int(slots), str(schedule_digest))
        n, tot = self.observed.get(key, (0, 0.0))
        self.observed[key] = (n + 1, tot + float(wall_s))

    def mean_wall(
        self, bucket: tuple[int, int], slots: int, schedule_digest: str
    ) -> float | None:
        """Mean observed wall seconds for a (shape, schedule), or ``None``
        when never observed."""
        key = (int(bucket[0]), int(bucket[1]), int(slots), str(schedule_digest))
        entry = self.observed.get(key)
        if entry is None or entry[0] == 0:
            return None
        return entry[1] / entry[0]

    @property
    def n_requests(self) -> int:
        return sum(self.requests.values())

    def merge(self, other: "TrafficProfile") -> "TrafficProfile":
        """A new profile with all ledgers summed (self is unchanged)."""
        out = TrafficProfile(
            dict(self.requests), dict(self.batches), dict(self.observed)
        )
        for k, n in other.requests.items():
            out.requests[k] = out.requests.get(k, 0) + n
        for k, n in other.batches.items():
            out.batches[k] = out.batches.get(k, 0) + n
        for k, (n, tot) in other.observed.items():
            n0, tot0 = out.observed.get(k, (0, 0.0))
            out.observed[k] = (n0 + n, tot0 + tot)
        return out

    def heat(self) -> list[tuple[tuple[int, int], int]]:
        """Buckets with their request counts, hottest first (ties break on
        the smaller bucket, so placement is deterministic).  This is the
        placer's input: the hottest buckets get replicas first."""
        return sorted(self.requests.items(), key=lambda kv: (-kv[1], kv[0]))

    def subset(
        self, buckets: "set[tuple[int, int]] | Sequence[tuple[int, int]]"
    ) -> "TrafficProfile":
        """A new profile restricted to ``buckets`` — what one device of a
        placement should precompile (its assigned buckets only, with their
        recorded slot variants intact)."""
        keep = {(int(v), int(d)) for v, d in buckets}
        return TrafficProfile(
            requests={b: n for b, n in self.requests.items() if b in keep},
            batches={
                k: n for k, n in self.batches.items() if k[:2] in keep
            },
            observed={
                k: v for k, v in self.observed.items() if k[:2] in keep
            },
        )

    def hot_shapes(self) -> list[tuple[tuple[int, int], int]]:
        """Every recorded ``((v_bucket, d_bucket), slots)`` shape, hottest
        first: buckets by request count (descending), slot variants of a
        bucket by batch count (descending); ties break on the smaller
        shape so warmup cost stays deterministic."""
        heat = lambda b: self.requests.get(b, 0)  # noqa: E731
        shapes = sorted(
            self.batches.items(),
            key=lambda kv: (-heat(kv[0][:2]), -kv[1], kv[0]),
        )
        return [((v, d), s) for (v, d, s), _ in shapes]

    # -- artifact ------------------------------------------------------------
    def to_json(self) -> str:
        payload = {
            "format": TRAFFIC_FORMAT,
            "requests": {
                f"{v}x{d}": n for (v, d), n in sorted(self.requests.items())
            },
            "batches": {
                f"{v}x{d}x{s}": n
                for (v, d, s), n in sorted(self.batches.items())
            },
            "observed": {
                f"{v}x{d}x{s}:{dig}": [n, tot]
                for (v, d, s, dig), (n, tot) in sorted(self.observed.items())
            },
        }
        return json.dumps(payload, indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "TrafficProfile":
        d = json.loads(text)
        if d.get("format") != TRAFFIC_FORMAT:
            raise ValueError(
                f"not a {TRAFFIC_FORMAT} artifact (format={d.get('format')!r})"
            )
        parse = lambda k: tuple(int(p) for p in k.split("x"))  # noqa: E731

        def parse_obs(k: str) -> tuple:
            shape, dig = k.rsplit(":", 1)
            return (*parse(shape), dig)

        return cls(
            requests={parse(k): int(n) for k, n in d["requests"].items()},
            batches={parse(k): int(n) for k, n in d["batches"].items()},
            # absent in pre-calibration profiles (back-compat)
            observed={
                parse_obs(k): (int(v[0]), float(v[1]))
                for k, v in d.get("observed", {}).items()
            },
        )

    def save(self, path) -> Path:
        """Atomic write (temp file + ``os.replace``), same contract as
        :meth:`repro.api.Program.save`."""
        p = Path(path)
        tmp = p.with_name(p.name + f".tmp.{os.getpid()}")
        try:
            tmp.write_text(self.to_json())
            os.replace(tmp, p)
        finally:
            tmp.unlink(missing_ok=True)
        return p

    @classmethod
    def load(cls, path) -> "TrafficProfile":
        return cls.from_json(Path(path).read_text())


def bucketize(
    graphs: Sequence[CSRGraph], policy: BucketPolicy = BucketPolicy()
) -> dict[tuple[int, int], list[int]]:
    """Route a stream: bucket key -> indices into ``graphs``, in arrival
    order.  The engine chunks each bucket's list into ``max_graphs``-sized
    micro-batches for :func:`assemble`."""
    routed: dict[tuple[int, int], list[int]] = {}
    for i, g in enumerate(graphs):
        routed.setdefault(policy.bucket_of(g), []).append(i)
    return routed
