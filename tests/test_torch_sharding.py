"""The port's sharding rules and step specs against the reference's, spec
for spec (no processes: a mesh is read only through its axis sizes, so a
stub with a ``.shape`` mapping stands in for 16 or 256 devices).

(a) ``tests/test_sharding.py``'s cases against ``repro.models.sharding``:
the pattern table, the divisibility guard on a stub 16-wide mesh, head
alignment with the TP size read from the current mesh, tuned and
multi-pod rules.  (b) ``launch/specs.py`` against ``repro.launch.specs``:
abstract shapes and dtypes for every arch x ``configs/shapes.py`` shape
(in process: ``jax.eval_shape``), and the param / ZeRO-1 optimizer /
cache / batch shardings on a 4 x 4 mesh, the reference's on 16 JAX host
devices in a subprocess.  All exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.launch import specs as ref_specs
from repro.models import attention as ref_attention
from repro.models import sharding as ref_sharding
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, applicable
from repro_torch.launch import specs
from repro_torch.models import attention
from repro_torch.models import sharding
from repro_torch.tree import leaf_paths

RULES = sharding.production_rules()
REF_RULES = ref_sharding.production_rules()


def stub_mesh(**axes):
    return type("Mesh", (), {"shape": dict(axes)})()


def norm(spec) -> tuple:
    """A spec with each one-axis tuple as its axis: JAX's ``PartitionSpec``
    writes ``("data",)`` as ``"data"``; the port keeps the rules' tuple."""
    return tuple(a[0] if isinstance(a, (tuple, list)) and len(a) == 1 else
                 tuple(a) if isinstance(a, list) else a for a in spec)


def ref_spec(spec) -> tuple:
    return norm(tuple(spec))


# ---------------------------------------------------------------------------
# (a) the rules
# ---------------------------------------------------------------------------

PATHS = [(f"scanned/0/{blk}/{name}", nd)
         for blk, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                           ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"),
                           ("moe", "router"), ("moe", "experts_gate"), ("moe", "experts_up"),
                           ("moe", "experts_down"), ("rg", "rg_in"), ("rg", "rg_gate"),
                           ("rg", "rg_out"), ("rg", "conv_w"), ("mlstm", "lstm_qkv"),
                           ("mlstm", "lstm_out"), ("slstm", "lstm_w"), ("ln1", ""))
         for nd in (1, 2, 3, 4)]
PATHS += [("embeddings/embed", 2), ("embeddings/lm_head", 2), ("final_norm", 1)]


@pytest.mark.parametrize("path,ndim", PATHS, ids=[f"{p}-{n}" for p, n in PATHS])
def test_spec_for_param_matches_the_reference(path, ndim):
    for rules, ref_rules in ((RULES, REF_RULES),
                             (sharding.tuned_rules("granite-8b"),
                              ref_sharding.tuned_rules("granite-8b")),
                             (sharding.production_rules(multi_pod=True),
                              ref_sharding.production_rules(multi_pod=True))):
        assert norm(sharding.spec_for_param(path, ndim, rules)) == ref_spec(
            ref_sharding.spec_for_param(path, ndim, ref_rules))


@pytest.mark.parametrize(
    "path,ndim,expected",
    [
        ("scanned/0/attn/wq", 2, (None, "model")),
        ("scanned/0/attn/wo", 2, ("model", None)),
        ("scanned/0/mlp/w_gate", 2, (None, "model")),
        ("scanned/0/mlp/w_down", 2, ("model", None)),
        ("scanned/0/moe/experts_gate", 3, ("model", None, None)),
        ("embeddings/embed", 2, ("model", None)),
        ("embeddings/lm_head", 2, (None, "model")),
        ("scanned/0/ln1", 1, ()),
        # stacked-layer leading dim stays unsharded
        ("scanned/0/attn/wq", 3, (None, None, "model")),
    ],
)
def test_pattern_matching(path, ndim, expected):
    assert sharding.spec_for_param(path, ndim, RULES) == expected


@pytest.mark.parametrize("spec,shape,axes", [
    (("model", None), (49155, 8), {"model": 16}),
    (("model", None), (49152, 8), {"model": 16}),
    ((("a", "b"), None), (8, 8), {"a": 2, "b": 2}),
    ((("a", "b"), None), (6, 8), {"a": 2, "b": 2}),
    ((None, "model", "data"), (3, 32, 12), {"data": 4, "model": 16}),
])
def test_divisibility_guard_matches_the_reference(spec, shape, axes):
    got = sharding._divisible(spec, shape, stub_mesh(**axes))
    want = ref_sharding._divisible(P(*spec), shape, stub_mesh(**axes))
    assert norm(got) == ref_spec(want)


def test_divisibility_guard_drops_unshardable_dims():
    mesh = stub_mesh(model=16)
    assert sharding._divisible(("model", None), (49155, 8), mesh) == (None, None)
    assert sharding._divisible(("model", None), (49152, 8), mesh) == ("model", None)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("ts", [1, 2, 4, 8, 16])
def test_head_alignment_reads_the_tp_size_from_the_mesh(arch, ts):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    want = ref_attention.head_alignment(ref_cfg, ts)
    with sharding.use_sharding(stub_mesh(data=2, model=ts), RULES):
        assert attention._tp_size() == ts
        assert attention.head_alignment(cfg) == tuple(want)
        assert attention.aligned_kv_heads(cfg) == ref_attention.aligned_kv_heads(ref_cfg, ts)
    with ref_sharding.use_sharding(stub_mesh(data=2, model=ts), REF_RULES):
        assert ref_attention._tp_size() == ts
    assert attention._tp_size() == 1  # no mesh, no padding


def test_smollm_keeps_attention_unsharded():
    """9 heads on 16-way TP would cost 5.3x: alignment declines."""
    rep, _, aligned = attention.head_alignment(get_config("smollm-135m"), 16)
    assert not aligned and rep == 1


def test_tuned_and_multi_pod_rules():
    r = sharding.tuned_rules("granite-8b")
    assert r == sharding.ShardingRules(**vars(ref_sharding.tuned_rules("granite-8b")))
    assert r.sequence == "model" and r.heads == "model"
    assert sharding.production_rules(multi_pod=True).batch == ("pod", "data")
    assert sharding.production_rules().batch == ("data",)
    for mp in (False, True):
        assert vars(sharding.production_rules(mp)) == vars(ref_sharding.production_rules(mp))
    assert norm(RULES.spec("batch", None, "heads")) == ref_spec(REF_RULES.spec("batch", None, "heads"))


def test_shard_is_the_identity_without_a_mesh():
    import torch

    x = torch.ones(2, 3)
    assert sharding.shard(x, "batch", None) is x


# ---------------------------------------------------------------------------
# (b) launch/specs.py: abstract shapes and dtypes
# ---------------------------------------------------------------------------


def _ref_key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)


def _ref_abstract(tree) -> dict:
    return {_ref_key(p): (tuple(l.shape), np.dtype(l.dtype).name)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_abstract(tree) -> dict:
    names = {"float32": "float32", "bfloat16": "bfloat16", "int32": "int32"}
    return {"/".join(map(str, p)): (tuple(l.shape), names[str(l.dtype).split(".")[1]])
            for p, l in leaf_paths(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_and_opt_state_match(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    params = specs.abstract_params(cfg)
    ref_params = ref_specs.abstract_params(ref_cfg)
    assert all(l.device.type == "meta" for _, l in leaf_paths(params))
    assert _port_abstract(params) == _ref_abstract(ref_params)
    assert (_port_abstract(specs.abstract_opt_state(cfg, params))
            == _ref_abstract(ref_specs.abstract_opt_state(ref_cfg, ref_params)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_decode_specs_match_for_every_shape(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert set(SHAPES) == set(REF_SHAPES)
    for name, shape in SHAPES.items():
        if not applicable(cfg, shape):
            continue
        ref_shape = REF_SHAPES[name]
        assert (_port_abstract(specs.batch_specs(cfg, shape))
                == _ref_abstract(ref_specs.batch_specs(ref_cfg, ref_shape)))
        if shape.kind == "decode":
            assert (_port_abstract(specs.decode_specs(cfg, shape))
                    == _ref_abstract(ref_specs.decode_specs(ref_cfg, ref_shape)))


# ---------------------------------------------------------------------------
# (b) launch/specs.py: shardings on 16 devices (4 x 4)
# ---------------------------------------------------------------------------

REF_SHARDINGS = r"""
import json
import jax
from repro.configs import ARCH_IDS, get_config
from repro.configs.shapes import SHAPES
from repro.launch import specs
from repro.launch.mesh import make_mesh_for
from repro.models import param_shardings, production_rules

def key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                    for k in path)

def table(tree):
    return {key(p): [list(a) if isinstance(a, tuple) else a for a in s.spec]
            for p, s in jax.tree_util.tree_flatten_with_path(tree)[0]}

mesh = make_mesh_for(16, 4)
rules = production_rules()
out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    params = specs.abstract_params(cfg)
    opt = specs.abstract_opt_state(cfg, params)
    dec = specs.decode_specs(cfg, SHAPES["decode_32k"])
    out[arch] = {
        "params": table(param_shardings(params, mesh, rules)),
        "opt": table(specs.opt_shardings(cfg, params, opt, mesh, rules)),
        "cache": table(specs.cache_shardings(cfg, dec["cache"], mesh, rules)),
        "batch": table(specs.batch_shardings(cfg, SHAPES["train_4k"], mesh, rules)),
    }
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_shardings():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=16")
    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", REF_SHARDINGS], capture_output=True, text=True,
                       env=env, cwd=root, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _table(tree) -> dict:
    return {"/".join(map(str, p)): norm(s.spec) for p, s in leaf_paths(tree)}


def _ref_table(table: dict) -> dict:
    return {k: norm(v) for k, v in table.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shardings_on_sixteen_devices_match(arch, ref_shardings):
    assert set(REF_ARCH_IDS) == set(ARCH_IDS)
    cfg, mesh = get_config(arch), stub_mesh(data=4, model=4)
    params = specs.abstract_params(cfg)
    opt = specs.abstract_opt_state(cfg, params)
    dec = specs.decode_specs(cfg, SHAPES["decode_32k"])
    want = {k: _ref_table(v) for k, v in ref_shardings[arch].items()}
    assert _table(sharding.param_shardings(params, mesh, RULES)) == want["params"]
    assert _table(specs.opt_shardings(cfg, params, opt, mesh, RULES)) == want["opt"]
    assert _table(specs.cache_shardings(cfg, dec["cache"], mesh, RULES)) == want["cache"]
    assert _table(specs.batch_shardings(cfg, SHAPES["train_4k"], mesh, RULES)) == want["batch"]


def test_zero1_spec_matches_the_reference():
    mesh = stub_mesh(data=4, model=4)
    for spec, shape in (((None, "model"), (64, 128)), (("model", None), (6, 8)),
                        ((), (3,)), ((None, None, "model"), (2, 4, 8))):
        assert norm(specs._zero1_spec(spec, shape, mesh, RULES)) == ref_spec(
            ref_specs._zero1_spec(P(*spec), shape, mesh, REF_RULES))
