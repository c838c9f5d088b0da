"""Per-rank program analysis: collective bytes, local FLOPs and live memory.

The port's counterpart of :mod:`repro.launch.hlo`.  The reference reads the
per-device HLO module that XLA's SPMD partitioner writes; here the per-rank
program is the FX graph that ``make_fx`` (fake tensors) records of a step
run on DTensors: local aten ops on each rank's shards, with DTensor's
redistributions as ``_c10d_functional`` collectives, each carrying its
process group.  :func:`analyze` walks it once and gives

* :class:`CollectiveStats` with the reference's fields (``bytes_by_op``,
  operand bytes; ``link_bytes_by_op``, the reference's ring formulas
  verbatim, :func:`collective_bytes`; ``count_by_op``), keyed by the HLO's
  op names (``all-gather``, ...), plus each op's group sizes and the link
  bytes split by whether a group stays inside one NVLink node;
* local FLOPs, from each op's own formula in ``torch.utils.flop_counter``
  on the local shapes (the flash kernel's custom op registers its own);
* a liveness-based peak of live local bytes, the counterpart of XLA's
  ``memory_analysis``: argument, output, alias and temporary bytes, by
  storage (a view costs nothing; a storage is freed after its last use).
  ``code_bytes`` is 0: an FX graph holds no generated code (the kernels
  are separate libraries).

Python loops are unrolled into the graph, so there are no while loops and
no trip counts to read.  The dry-run records a loop's body once (the
microbatch loop; the time loops, :mod:`repro_torch.models.loops`) and
marks its nodes; :func:`node_weights` turns the marks into how many times
each node runs, and :func:`analyze` counts each node's FLOPs, bytes and
collectives that many times.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.fx.node import map_arg
from torch.utils.flop_counter import flop_registry

#: functional collective -> the HLO op name the reference keys on
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional")


def collective_bytes(op: str, result: int, p: int) -> tuple[int, int]:
    """(operand bytes, link bytes) of one collective whose per-rank result
    is ``result`` bytes over a group of ``p`` ranks: the reference's
    accounting (``repro.launch.hlo.collective_bytes``), verbatim.

      operand bytes:  all-gather = result/P; reduce-scatter = result*P;
                      all-reduce / all-to-all / permute = result.
      link bytes (ring-algorithm wire traffic per device):
                      all-gather & reduce-scatter = operand*(P-1);
                      all-reduce = 2*operand*(P-1)/P;
                      all-to-all = operand*(P-1)/P; permute = operand.
    """
    if op == "all-gather":
        operand = result // max(p, 1)
        link = operand * (p - 1)
    elif op == "reduce-scatter":
        operand = result * p
        link = result * (p - 1)
    elif op == "all-reduce":
        operand = result
        link = int(2 * operand * (p - 1) / max(p, 1))
    elif op == "all-to-all":
        operand = result
        link = int(operand * (p - 1) / max(p, 1))
    else:  # collective-permute
        operand = result
        link = operand
    return operand, link


@dataclass
class CollectiveStats:
    bytes_by_op: dict[str, int] = field(default_factory=dict)  # operand bytes
    link_bytes_by_op: dict[str, int] = field(default_factory=dict)  # wire traffic
    count_by_op: dict[str, int] = field(default_factory=dict)
    #: op -> {group size: count}
    group_sizes_by_op: dict[str, dict[int, int]] = field(default_factory=dict)
    #: link bytes of groups inside one node / spanning nodes
    link_bytes_by_span: dict[str, int] = field(
        default_factory=lambda: {"intra_node": 0, "inter_node": 0})
    #: every collective in program order: (op, group size, operand bytes,
    #: link bytes, spans nodes)
    calls: list[tuple] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_link_bytes(self) -> int:
        return sum(self.link_bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def add(self, op: str, p: int, operand: int, link: int, spans: bool,
            times: int = 1) -> None:
        self.bytes_by_op[op] = self.bytes_by_op.get(op, 0) + operand * times
        self.link_bytes_by_op[op] = self.link_bytes_by_op.get(op, 0) + link * times
        self.count_by_op[op] = self.count_by_op.get(op, 0) + times
        sizes = self.group_sizes_by_op.setdefault(op, {})
        sizes[p] = sizes.get(p, 0) + times
        self.link_bytes_by_span["inter_node" if spans else "intra_node"] += link * times
        self.calls.extend([(op, p, operand, link, spans)] * times)


@dataclass
class ProgramStats:
    """What :func:`analyze` reads from one per-rank program."""

    collectives: CollectiveStats
    flops: int  # local FLOPs, by torch.utils.flop_counter's formulas
    bytes_accessed: int  # operand + result bytes of every non-view op
    argument_bytes: int
    output_bytes: int
    alias_bytes: int  # outputs that live in an argument's storage
    temp_bytes: int | None  # peak of live non-argument storages
    #: calls of the port's own ops (``repro_torch::flash_attend``) by name
    kernel_calls: dict[str, int] = field(default_factory=dict)
    #: local FLOPs by op (``aten.mm``, ...)
    flops_by_op: dict[str, int] = field(default_factory=dict)



def _tensors(x) -> list:
    out = []
    map_arg(x, lambda n: out.append(n.meta.get("val")) or n)
    return [t for t in out if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    from torch.multiprocessing.reductions import StorageWeakRef

    return StorageWeakRef(t.untyped_storage()).cdata


def _group(name) -> list[int]:
    from torch.distributed import distributed_c10d as c10d

    return c10d.get_process_group_ranks(c10d._resolve_process_group(name))


def _collective(node):
    """The HLO op name of a functional-collective node, else None."""
    target = node.target
    if node.op != "call_function" or not isinstance(target, torch._ops.OpOverload):
        return None
    if target.namespace not in _NAMESPACES:
        return None
    return _COLLECTIVES.get(target._opname.rstrip("_"))


def collective_call(node, gpus_per_node: int = 8):
    """``(op, group size, operand bytes, link bytes, spans nodes)`` of a
    functional-collective node (one entry of :attr:`CollectiveStats.calls`),
    else None."""
    op = _collective(node)
    if op is None:
        return None
    ranks = _group(node.args[-1])
    val = node.meta.get("val")
    outs = [t for t in (val if isinstance(val, (list, tuple)) else [val])
            if isinstance(t, torch.Tensor)]
    operand, link = collective_bytes(op, sum(_nbytes(t) for t in outs), len(ranks))
    return op, len(ranks), operand, link, len({r // gpus_per_node for r in ranks}) > 1


def comm_counts(mode) -> dict[str, int]:
    """A ``CommDebugMode``'s collective counts under the HLO op names, as
    ``count_by_op`` keys them."""
    out: dict[str, int] = {}
    for op, n in mode.get_comm_counts().items():
        name = _COLLECTIVES.get(str(op).split(".")[-1].rstrip("_"))
        if name is None:
            raise ValueError(f"comm_counts: no HLO name for {op}")
        out[name] = out.get(name, 0) + n
    return out


def node_weights(marks) -> dict:
    """How many times each marked node runs, from ``marks``: pairs of (a
    set of nodes, a loop body recorded once, and how many more times it
    runs).  A node in several bodies (a time loop's inside a microbatch's)
    runs the product of their counts; a node in none runs once."""
    weights: dict = {}
    for nodes, extra in marks:
        for n in nodes:
            weights[n] = weights.get(n, 1) * (1 + extra)
    return weights


def analyze(gm: torch.fx.GraphModule, gpus_per_node: int = 8,
            weights: dict | None = None) -> ProgramStats:
    """Collectives, local FLOPs and live memory of a ``make_fx`` graph (see
    the module docstring).  A group spans nodes when its global ranks fall
    in more than one block of ``gpus_per_node``.  With ``weights`` (node ->
    runs, :func:`node_weights`), each node's collectives, FLOPs and bytes
    accessed count that many times; memory is the graph's as recorded."""
    weights = weights or {}
    coll = CollectiveStats()
    flops = accessed = 0
    kernels: dict[str, int] = {}
    by_op: dict[str, int] = {}
    nodes = list(gm.graph.nodes)
    # storage -> bytes and the index of the last node that uses it.  An
    # argument counts its own bytes (a rank's shard may be a view into a
    # whole meta tensor's storage); a storage made in the graph its size.
    size, last, args_st = {}, {}, set()
    for i, node in enumerate(nodes):
        val = node.meta.get("val")
        for t in (val if isinstance(val, (list, tuple)) else [val]):
            if isinstance(t, torch.Tensor):
                st = _storage(t)
                if node.op == "placeholder":
                    args_st.add(st)
                    size[st] = size.get(st, 0) + _nbytes(t)
                elif st not in args_st:
                    size[st] = max(size.get(st, 0), t.untyped_storage().nbytes())
                last[st] = i
        for t in _tensors((node.args, node.kwargs)):
            last[_storage(t)] = i
    out_node = nodes[-1]
    out_st = {_storage(t) for t in _tensors(out_node.args)}

    live = peak = 0
    born = set()
    frees: dict[int, list] = {}
    for st, i in last.items():
        frees.setdefault(i, []).append(st)
    for i, node in enumerate(nodes):
        if node.op != "call_function":
            continue
        val = node.meta.get("val")
        outs = [t for t in (val if isinstance(val, (list, tuple)) else [val])
                if isinstance(t, torch.Tensor)]
        packet = getattr(node.target, "_overloadpacket", None)
        w = weights.get(node, 1)
        call = collective_call(node, gpus_per_node)
        if call is not None:
            coll.add(*call, times=w)
        if getattr(node.target, "namespace", None) == "repro_torch":
            kernels[str(packet)] = kernels.get(str(packet), 0) + w
        n_flops = _flops(node, packet, val)
        if n_flops:
            flops += w * n_flops
            by_op[str(packet)] = by_op.get(str(packet), 0) + w * n_flops
        if not getattr(node.target, "is_view", False):
            ins = _tensors((node.args, node.kwargs))
            accessed += w * sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            st = _storage(t)
            if st not in born and st not in args_st:
                born.add(st)
                live += size[st]
        peak = max(peak, live)
        for st in frees.get(i, ()):
            if st in born and st not in out_st:
                live -= size[st]
    return ProgramStats(
        collectives=coll, flops=flops, bytes_accessed=accessed,
        argument_bytes=sum(size[s] for s in args_st),
        output_bytes=sum(size[s] for s in out_st),
        alias_bytes=sum(size[s] for s in out_st & args_st),
        temp_bytes=peak, kernel_calls=kernels, flops_by_op=by_op,
    )


def _flops(node, packet, val) -> int:
    """FLOPs of one node by its op's ``torch.utils.flop_counter`` formula
    (0 for an op without one)."""
    if packet not in flop_registry:
        return 0
    args, kwargs = map_arg((node.args, node.kwargs), lambda n: n.meta.get("val"))
    return int(flop_registry[packet](*args, **kwargs, out_val=val))
