"""The harness on the CPU: it finds what ``BENCHMARK.json`` names, picks up
new files without an edit, prints the contract's line, refuses to run
without a card, and neither imports JAX or the JAX package nor reads the
old benchmark folders.

    python -m pytest perfbench/tests
"""
import ast
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path[:0] = [str(BENCH), str(REPO / "src")]

import harness  # noqa: E402
from cell_sizes import TINY  # noqa: E402

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def tiny_run(workload, tmp_path, seed=2**31 + 11, trace=False, seconds=0.2):
    return harness.run_cell(workload, seed, seconds, trace, t0=time.perf_counter(),
                            device="cpu", overrides=TINY[workload],
                            store=str(tmp_path / "store"))


def test_every_name_resolves():
    bench = harness.Benchmark()
    s = spec()
    assert set(TINY) == {w["name"] for w in s["workloads"]}
    for w in s["workloads"]:
        cell = bench.cell(w["name"])
        config = bench.config(cell["config"])
        assert config["name"] == cell["config"]
        assert harness.job_class(bench.traffic(cell["traffic"])["job"]).setup
        assert bench.limits(w["name"])
        for kind in ("end_to_end", "per_layer"):
            assert bench.metrics(kind, w["name"])
    for m in s["per_layer"]:
        assert callable(bench.metric(m["name"]).read)
    for c in s["configs"]:
        assert (REPO / c["file"]).is_file()
        config = json.loads((REPO / c["file"]).read_text())
        assert config["source"] == c["source"]
        assert (BENCH / config["reference"]).is_file()
        assert Path(bench.config(c["name"])["reference"]).is_file()


def test_a_new_configuration_is_picked_up_without_an_edit(tmp_path):
    """A copy of the benchmark with one more configuration file, cell and
    limits file: the harness finds and runs it; no existing file changed."""
    repo = tmp_path / "checkout"
    shutil.copytree(BENCH, repo / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    s = spec()
    cfg = json.loads((BENCH / "configs" / "gcn-cora.json").read_text())
    cfg["name"] = "gcn-citeseer"
    cfg["dataset"].update(avg_nodes=250, avg_edges=700)
    cfg["model"]["f_in"] = 37
    (repo / "perfbench" / "configs" / "gcn-citeseer.json").write_text(json.dumps(cfg))
    s["configs"].append({"name": "gcn-citeseer", "source": cfg["source"],
                         "file": "perfbench/configs/gcn-citeseer.json", "reduced": [],
                         "why": "test"})
    s["workloads"].append({"name": "gcn-citeseer.refresh", "config": "gcn-citeseer",
                           "traffic": "refresh", "chips": 1, "why": "test"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "gcn-cora.refresh" in m.get("workloads", []):
            m["workloads"].append("gcn-citeseer.refresh")
    (repo / "BENCHMARK.json").write_text(json.dumps(s))
    shutil.copy(BENCH / "limits" / "gcn-cora.refresh.json",
                repo / "perfbench" / "limits" / "gcn-citeseer.refresh.json")
    r = harness.run_cell("gcn-citeseer.refresh", 5, 0.1, False, t0=time.perf_counter(),
                         device="cpu", repo=repo, overrides={"traffic": {"snapshots": 2}},
                         store=str(tmp_path / "store"))
    assert r["correct"] and set(r["metrics"]) == {"forward_ms", "setup_s"}


def _files(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _checkout(tmp_path: Path) -> Path:
    """A copy of ``perfbench/`` in a checkout of its own."""
    repo = tmp_path / "checkout"
    shutil.copytree(BENCH, repo / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    return repo


def _add_sage(repo: Path, s: dict, workload: str) -> str:
    """Add to the checkout ``repo`` and its spec ``s`` a GraphSAGE
    configuration, its plain reference (``tests/samples/sage.py``) and its
    cell on ``workload``'s traffic, as new files and entries; returns the
    new cell's name."""
    cell = harness.Benchmark().cell(workload)
    entry = next(c for c in s["configs"] if c["name"] == cell["config"])
    cfg = json.loads((REPO / entry["file"]).read_text())
    name = "sage-" + cell["config"].split("-", 1)[1]
    cfg.update(name=name, reference="references/sage.py")
    cfg["model"]["kind"] = "sage"
    shutil.copy(BENCH / "tests" / "samples" / "sage.py",
                repo / "perfbench" / "references" / "sage.py")
    (repo / "perfbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    new_cell = f"{name}.{cell['traffic']}"
    shutil.copy(BENCH / "limits" / f"{workload}.json",
                repo / "perfbench" / "limits" / f"{new_cell}.json")
    s["configs"].append({**entry, "name": name, "file": f"perfbench/configs/{name}.json"})
    s["workloads"].append({**cell, "name": new_cell, "config": name})
    for m in s["end_to_end"] + s["per_layer"]:
        if workload in m.get("workloads", []):
            m["workloads"].append(new_cell)
    return new_cell


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_second_kind_of_model_runs_by_new_files_alone(workload, trace, tmp_path):
    """A copy of the benchmark with a GraphSAGE configuration, its plain
    reference and its cell added as new files and entries: the harness
    runs the port's SAGE model and holds it against that reference; no
    file of the benchmark changed."""
    repo = _checkout(tmp_path)
    before = _files(repo / "perfbench")
    s = spec()
    new_cell = _add_sage(repo, s, workload)
    (repo / "BENCHMARK.json").write_text(json.dumps(s))
    r = harness.run_cell(new_cell, 2**31 + 5, 0.1, trace, t0=time.perf_counter(),
                         device="cpu", repo=repo, overrides=TINY[workload],
                         store=str(tmp_path / "store"))
    assert r["correct"] is True and r["failed"] == 0, r["compared"]
    after = _files(repo / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


def _add_moe_sample(repo: Path, s: dict) -> str:
    """Add to the checkout ``repo`` and its spec ``s`` a cell of a new kind
    of job, as new files and entries: the bfloat16 MoE layer of
    ``tests/samples/moe_ffn.py`` (not a ``base.Job``), its reference, its
    configuration at Mellum2-12B-A2.5B's MoE widths, its traffic, limits
    and test sizes, reported as ``forward_ms`` and by a new per-layer
    metric; returns the cell's name."""
    bench = repo / "perfbench"
    samples = BENCH / "tests" / "samples"
    shutil.copy(samples / "moe_ffn.py", bench / "jobs" / "moe_ffn.py")
    shutil.copy(samples / "moe_ffn_reference.py", bench / "references" / "moe_ffn.py")
    source = "https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct/blob/main/config.json"
    name, cell = "moe-ffn-sample", "moe-ffn-sample.moe_ffn"
    (bench / "configs" / f"{name}.json").write_text(json.dumps({
        "name": name, "source": source, "reference": "references/moe_ffn.py",
        "model": {"kind": "moe_ffn", "hidden_size": 2304, "expert_width": 896,
                  "n_experts": 64, "top_k": 8, "dtype": "bfloat16"}}))
    (bench / "traffic" / "moe_ffn.json").write_text(json.dumps(
        {"job": "moe_ffn", "batches": 8, "batch": 4, "seq_len": 2048, "trace_calls": 16}))
    # program 4.30e-3..1.15e-2, control (float8 e4m3 operands) 5.06e-2..7.69e-2,
    # over 14 seeds on the CPU at the test sizes below
    (bench / "limits" / f"{cell}.json").write_text(json.dumps(
        {"limits": {"max_rel_err": 0.025}}))
    tiny = {"config": {"model": {"hidden_size": 64, "expert_width": 32, "n_experts": 8,
                                 "top_k": 2}},
            "traffic": {"batches": 3, "batch": 2, "seq_len": 16, "trace_calls": 4}}
    (bench / "tests" / "cells" / f"{cell}.json").write_text(json.dumps(
        {"tiny": tiny, "control": tiny}))
    (bench / "metrics" / "mfu.moe_ffn.py").write_text(
        '"""Model FLOPs of the window\'s forwards over its seconds and the peak of\n'
        'the configuration\'s type, in percent."""\n'
        "from yardstick import mfu_pct as read  # noqa: F401\n")
    s["configs"].append({"name": name, "source": source,
                         "file": f"perfbench/configs/{name}.json", "reduced": ["num_hidden_layers"],
                         "why": "test"})
    s["workloads"].append({"name": cell, "config": name, "traffic": "moe_ffn", "chips": 1,
                           "why": "test"})
    next(m for m in s["end_to_end"] if m["name"] == "forward_ms")["workloads"].append(cell)
    s["per_layer"].append({"name": "mfu.moe_ffn", "unit": "%", "better": "higher",
                           "source": "host_clock", "layer": "Whole step",
                           "moves": "forward_ms", "workloads": [cell]})
    return cell


def test_a_cell_is_added_by_new_files_alone_tests_included(tmp_path):
    """A copy of the benchmark given two cells by new files and entries
    alone, each with its ``tests/cells/<cell>.json``: a GraphSAGE cell on
    an existing job, and a cell of a new kind of job with a new per-layer
    metric.  The copy's own tests, run there, find both cells and pass on
    them, and no file that the copy had changed."""
    repo = _checkout(tmp_path)
    (repo / "src").symlink_to(REPO / "src")
    before = _files(repo / "perfbench")
    s = spec()
    sage = _add_sage(repo, s, "gcn-cora.refresh")
    shutil.copy(BENCH / "tests" / "cells" / "gcn-cora.refresh.json",
                repo / "perfbench" / "tests" / "cells" / f"{sage}.json")
    moe = _add_moe_sample(repo, s)
    (repo / "BENCHMARK.json").write_text(json.dumps(s))
    here, correctness = ("perfbench/tests/test_perfbench_harness.py",
                         "perfbench/tests/test_perfbench_correctness.py")
    whole = ["test_every_name_resolves", "test_no_module_imports_jax_or_the_jax_package",
             "test_the_references_import_nothing_of_the_program"]
    want = {f"{here}::{t}" for t in whole}
    want.add(f"{correctness}::test_every_cell_has_a_control_size")
    for cell in (sage, moe):
        want |= {f"{here}::test_result_line_has_the_contract_keys[{cell}-{trace}]"
                 for trace in (False, True)}
        want.add(f"{correctness}::test_the_control_fails_on_the_cpu[{cell}]")
    select = (" or ".join(whole) + " or test_every_cell_has_a_control_size or "
              "((test_result_line_has_the_contract_keys or test_the_control_fails_on_the_cpu)"
              f" and ({sage} or {moe}))")
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
                          "--rootdir", str(repo), "--basetemp", str(tmp_path / "basetemp"),
                          "-k", select, here, correctness],
                         capture_output=True, text=True, timeout=600, cwd=repo,
                         env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    passed = {line.split()[1] for line in out.stdout.splitlines() if line.startswith("PASSED ")}
    assert passed == want, out.stdout[-4000:]
    after = _files(repo / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_type_the_program_cannot_run_is_refused(tmp_path):
    over = {**TINY["gcn-cora.refresh"]}
    over["config"] = harness.deep_merge(over["config"], {"model": {"dtype": "bfloat16"}})
    with pytest.raises(harness.Refused, match="bfloat16"):
        harness.run_cell("gcn-cora.refresh", 1, 0.1, False, t0=time.perf_counter(),
                         device="cpu", overrides=over, store=str(tmp_path / "store"))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", sorted(TINY))
def test_result_line_has_the_contract_keys(workload, trace, tmp_path):
    r = tiny_run(workload, tmp_path, trace=trace)
    want = CONTRACT_KEYS | {"compared"} | ({"breakdown"} if trace else set())
    assert set(r) == want
    assert list(r)[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert all(set(v) == {"value", "limit"} for v in r["compared"].values())
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.Benchmark().metrics(kind, workload)}
    # on the CPU the readers of the device trace find nothing to read
    assert set(r["metrics"]) <= names
    if not trace:
        assert set(r["metrics"]) == names
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in r["metrics"].values())
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert r["device"]["window_s"] > 0
    json.loads(json.dumps(r))


def test_seed_sets_the_inputs(tmp_path):
    a = tiny_run("gcn-cora.refresh", tmp_path, seed=3)
    b = tiny_run("gcn-cora.refresh", tmp_path, seed=3)
    c = tiny_run("gcn-cora.refresh", tmp_path, seed=4)
    val = lambda r: r["compared"]["max_rel_err"]["value"]  # noqa: E731
    assert val(a) == val(b) != val(c)


def test_without_a_card_it_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "gcn-cora.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=REPO,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                              "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_without_the_program_it_prints_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "gcn-cora.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                              "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert "{" not in out.stdout


def sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``repro_torch`` passes, ``repro``
    and ``jax`` do not."""
    found = []
    for path in sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(path.name, n) for n in names if n.split(".")[0] in harness.FORBIDDEN]
    assert not found


def test_the_references_import_nothing_of_the_program():
    for path in (BENCH / "references").rglob("*.py"):
        tree = ast.parse(path.read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not [m for m in mods if m and m.split(".")[0] in ("repro_torch",) + harness.FORBIDDEN]


def test_the_isolation_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake.sub", object())
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "repro.fake_sub", object())
    assert harness.loaded_forbidden() == ["repro"]


def test_nothing_reads_the_old_benchmark_folders():
    old = ("benchmarks/", "experiments/benchmarks", "benchmarks_torch")
    for path in sources():
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert not [o for o in old if o in text], path
