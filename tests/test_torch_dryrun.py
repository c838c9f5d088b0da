"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``, ``.hlo``,
``.roofline``) against the reference's, on the CPU.

- ``collective_bytes``: the port's operand and link bytes equal the
  reference's parse of the equivalent one-line HLO, for every collective at
  group sizes 1, 2, 4 and 16 (exact);
- ``model_flops`` and ``roofline_report`` equal the reference's for every
  arch x shape on one synthetic result, with a chip config carrying TPU
  v5e's numbers (relative 1e-12);
- ``grad_accum_steps`` equals the reference's on both production meshes
  (a stub with ``.devices.size`` and ``.shape``), under both rule sets;
- the flash wrapper on ``meta`` computes nothing and launches nothing, and
  its FLOP formula counts the kernel's 64 x 64 tiles;
- the MoE's expert counts (``torch.bincount`` before) are ``torch.equal``
  to ``bincount`` and run on ``meta``;
- real cells, each in a subprocess (a fake process group of 256 or 512
  ranks is the process's default group), started together: smollm-135m
  ``decode_32k`` on 16 x 16 (and ``long_500k`` skipped), the same on
  2 x 16 x 16, and ``prefill_32k`` on the flash meta route.

``test_torch_dryrun_cells.py`` holds the rest: the MoE ``train_4k`` cell,
the scaled microbatch loop against the unrolled one, the fake trace against
a real ``gloo`` run, and the sharded-attention repair.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core.hw import GPUChipConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.dryrun import grad_accum_steps
from repro_torch.launch.hlo import collective_bytes
from repro_torch.launch.roofline import model_flops, roofline_report
from repro_torch.models import moe
from repro_torch.models.sharding import production_rules, tuned_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all", "collective-permute")


def run_sub(script: str, timeout=600) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)


def finish(proc: subprocess.Popen, timeout=600) -> dict:
    """The JSON line a cell script prints last, or the failure."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# Collective accounting against the reference's HLO parse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [1, 2, 4, 16])
@pytest.mark.parametrize("op", OPS)
def test_collective_bytes_match_the_reference(op, p):
    from repro.launch.hlo import collective_bytes as ref_collective_bytes

    groups = f"replica_groups=[{16 // p},{p}]<=[16]"
    line = f"  %c = f32[8,64]{{1,0}} {op}(%x), {groups}\n"
    ref = ref_collective_bytes(line)
    operand, link = collective_bytes(op, 8 * 64 * 4, p)
    assert ref.bytes_by_op == {op: operand}
    assert ref.link_bytes_by_op == {op: link}
    assert ref.count_by_op == {op: 1}


# ---------------------------------------------------------------------------
# Roofline and microbatching against the reference's
# ---------------------------------------------------------------------------

#: TPU v5e's numbers in the port's chip config: one link rate for both spans
V5E_NUMBERS = GPUChipConfig(name="tpu-v5e-numbers", peak_bf16_flops=197e12,
                            hbm_bandwidth=819e9, nvlink_bandwidth=50e9,
                            network_bandwidth=50e9, gpus_per_node=8, hbm_capacity=16e9)


def _synthetic_result() -> dict:
    link = 3_456_789_012
    return {
        "n_chips": 256,
        "mesh_shape": {"data": 16, "model": 16},
        "cost": {"flops_per_device": 1.234e13, "bytes_per_device": 5.6e11},
        "collectives": {"total_bytes_per_device": 1_234_567_890,
                        "link_bytes_per_device": link,
                        "link_bytes_by_span": {"intra_node": 1_000_000_000,
                                               "inter_node": link - 1_000_000_000}},
        "while_trip_counts": [],
    }


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_roofline_match_the_reference(arch, shape):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_get_config
    from repro.launch.roofline import model_flops as ref_model_flops
    from repro.launch.roofline import roofline_report as ref_roofline_report

    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    result = _synthetic_result()
    assert model_flops(cfg, SHAPES[shape]) == ref_model_flops(ref_cfg, REF_SHAPES[shape])
    want = ref_roofline_report(ref_cfg, REF_SHAPES[shape], result)
    got = roofline_report(cfg, SHAPES[shape], result, chip=V5E_NUMBERS)
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, str):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=1e-12, err_msg=k)


class _StubMesh:
    """What both packages' ``grad_accum_steps`` read of a mesh."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.devices = np.empty(tuple(shape.values()), dtype=object)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grad_accum_steps_matches_the_reference(arch, multi_pod):
    saved = os.environ.get("XLA_FLAGS")
    try:  # the reference's dry-run module sets XLA_FLAGS when imported
        from repro.configs import SHAPES as REF_SHAPES
        from repro.configs import get_config as ref_get_config
        from repro.launch.dryrun import grad_accum_steps as ref_grad_accum_steps
        from repro.models.sharding import production_rules as ref_production_rules
        from repro.models.sharding import tuned_rules as ref_tuned_rules
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    mesh = _StubMesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                     else {"data": 16, "model": 16})
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for shape in SHAPES:
        for rules, ref_rules in ((None, None),
                                 (production_rules(multi_pod), ref_production_rules(multi_pod)),
                                 (tuned_rules(arch, multi_pod), ref_tuned_rules(arch, multi_pod))):
            assert grad_accum_steps(cfg, SHAPES[shape], mesh, rules) == ref_grad_accum_steps(
                ref_cfg, REF_SHAPES[shape], mesh, ref_rules), (shape, rules)


# ---------------------------------------------------------------------------
# The flash wrapper's meta route
# ---------------------------------------------------------------------------


def test_attend_on_meta_computes_nothing_and_launches_nothing(monkeypatch):
    from torch.utils.flop_counter import FlopCounterMode

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on meta")

    monkeypatch.setattr(flash_ops, "attend_chunked", refuse)
    flash_ops.flash_attention.launches = 0
    q = torch.empty(2, 200, 8, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 200, 2, 64, dtype=torch.bfloat16, device="meta")
    pos = torch.arange(200, device="meta")
    with FlopCounterMode(display=False) as fc:
        out = flash_ops.attend(q, k, k, pos, pos, window=0)
    assert out.device.type == "meta" and out.shape == q.shape and out.dtype == q.dtype
    assert flash_ops.flash_attention.launches == 0
    assert fc.get_total_flops() == flash_ops.attend_flops(q.shape, k.shape, 0)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.attend(q.requires_grad_(), k, k, pos, pos)


def _tiles_by_loop(sq, sk, window):
    n = 0
    for q0 in range(0, sq, 64):
        for k0 in range(0, sk, 64):
            qmin, qmax = q0, min(q0 + 64, sq) - 1
            kmin, kmax = k0, min(k0 + 64, sk) - 1
            if kmin > qmax or (window > 0 and kmax <= qmin - window):
                continue
            n += 1
    return n


@pytest.mark.parametrize("sq,window", [(64, 0), (200, 0), (1000, 0), (1000, 100),
                                       (4096, 2048), (130, 7)])
def test_attend_flops_counts_the_kernels_tiles(sq, window):
    """Every (64-query, 64-key) tile with a pair the causal mask (and the
    window) lets through costs 4 * 64 * 64 * D; the rest are skipped."""
    b, hq, d = 2, 3, 64
    got = flash_ops.attend_flops((b, sq, hq, d), (b, sq, 1, d), window)
    assert got == 4 * 64 * 64 * d * b * hq * _tiles_by_loop(sq, sq, window)


# ---------------------------------------------------------------------------
# The MoE's expert counts on any device
# ---------------------------------------------------------------------------


def test_moe_counts_are_bincount_and_run_on_meta():
    g = torch.Generator().manual_seed(0)
    for n in (4, 9, 33):
        ids = torch.randint(0, n, (257, 3), generator=g)
        assert torch.equal(moe._counts(ids, n), torch.bincount(ids.reshape(-1), minlength=n))
    cfg = get_config("granite-moe-1b-a400m").reduced()
    x = torch.randn(37, cfg.d_model, generator=g)
    router = torch.randn(cfg.d_model, cfg.moe.n_experts, generator=g)
    probs, ids, aux = moe._route(cfg, {"router": router}, x)
    gates = torch.softmax(x.float() @ router, dim=-1)
    ce = torch.bincount(ids.reshape(-1), minlength=cfg.moe.n_experts).float() / ids.numel()
    want = cfg.moe.n_experts * torch.sum(gates.mean(0) * ce) * cfg.moe.router_aux_weight
    assert torch.equal(aux, want)
    # both count sites on meta: the router's aux loss and the EP dispatch
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    e, d, ff = cfg.moe.n_experts, cfg.d_model, cfg.d_ff
    out, aux = moe._ep_local(cfg, m(2, 8, d), m(d, e), m(2, d, ff), m(2, d, ff),
                             m(2, ff, d), 2)
    assert out.device.type == "meta" and out.shape == (2, 8, d) and aux.shape == ()


# ---------------------------------------------------------------------------
# Real cells (subprocesses, started together)
# ---------------------------------------------------------------------------

CELLS = {
    "decode": """
        from repro_torch.launch.dryrun import run_cell
        r = run_cell("smollm-135m", "decode_32k", multi_pod=False, save=False)
        r2 = run_cell("smollm-135m", "long_500k", multi_pod=False, save=False)
        r["long_500k"] = r2
        """,
    "multipod": """
        from repro_torch.launch.dryrun import run_cell
        r = run_cell("smollm-135m", "decode_32k", multi_pod=True, save=False)
        """,
    "prefill": """
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.launch.dryrun import run_cell
        r = run_cell("smollm-135m", "prefill_32k", multi_pod=False, save=False)
        r["launches"] = ops.flash_attention.launches
        """,
}


@pytest.fixture(scope="module")
def cells():
    procs = {name: run_sub(textwrap.dedent(body) + "import json; print(json.dumps(r))\n")
             for name, body in CELLS.items()}
    return {name: finish(p) for name, p in procs.items()}


def _held_cell(r, n_chips):
    assert r["n_chips"] == n_chips
    assert r["cost"]["flops_per_device"] > 0
    rf = r["roofline"]
    assert rf["dominant_term"] in ("compute", "memory", "collective")
    assert rf["bound_s"] > 0
    assert r["memory"]["argument_bytes"] > 0 and r["memory"]["code_bytes"] == 0
    assert r["while_trip_counts"] == [] and r["compile_s"] == 0


def test_one_real_dryrun_cell_256_chips(cells):
    """smollm-135m ``decode_32k`` traced on the 16 x 16 mesh of a fake
    256-rank group: the terms on the H100's constants; ``long_500k``
    skipped."""
    r = cells["decode"]
    _held_cell(r, 256)
    assert r["mesh"] == "pod16x16" and r["chip"] == "h100-sxm"
    assert r["long_500k"]["skipped"]
    coll = r["collectives"]
    # every collective of the 16-wide model axis spans two 8-GPU nodes
    assert coll["link_bytes_by_span"]["intra_node"] == 0
    assert coll["link_bytes_by_span"]["inter_node"] == coll["link_bytes_per_device"] > 0
    assert set(coll["group_sizes_by_op"]["all-reduce"]) == {"16"}


def test_multipod_cell_512_chips(cells):
    r = cells["multipod"]
    _held_cell(r, 512)
    assert r["mesh"].startswith("pod2x16x16")
    assert r["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    # the batch splits over 32 data ranks: half of 16 x 16's decode cache
    assert r["memory"]["argument_bytes"] < cells["decode"]["memory"]["argument_bytes"]


def test_prefill_cell_takes_the_flash_meta_route(cells):
    """``prefill_32k`` traces ``forward(..., use_kernels=True)``: 30 flash
    calls (one an attention layer) on the meta route, counted by the
    kernel's own FLOP formula, nothing launched."""
    r = cells["prefill"]
    _held_cell(r, 256)
    assert r["kernel_calls"] == {"repro_torch.flash_attend": 30}
    assert r["launches"] == 0
