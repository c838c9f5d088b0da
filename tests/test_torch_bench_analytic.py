"""The port's analytic benchmark lanes (``repro_torch.bench``) against the
reference lanes (the namespace package ``benchmarks`` at the repo root):
every row and every evidence JSON equal, apart from timing fields.  Both
sides write their JSON under ``tmp_path``; the reference's committed
``experiments/benchmarks/`` is checked untouched.  Also: ``roofline``
reads all 64 cells of ``experiments/dryrun_torch/``, and the harness keeps
the reference's lane names and fast lists."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmarks.common as ref_common  # noqa: E402
import repro_torch.bench.common as port_common  # noqa: E402

REF_EVIDENCE = ROOT / "experiments" / "benchmarks"
#: timing fields of the rows' ``derived`` strings and of the JSONs
TIMING_KEYS = {"batch_us", "scalar_us", "speedup", "het_us", "search_us", "us",
               "device"}
#: a lane's wall-clock guards: they raise after the evidence JSON landed
TIMING_GUARDS = (
    re.compile(r"faster than the per-point scalar loop"),
    re.compile(r"search regression: \d+us > \d+us"),
)


def evidence_stamp():
    return {p.name: (p.stat().st_mtime_ns, p.read_bytes())
            for p in sorted(REF_EVIDENCE.iterdir())}


@pytest.fixture
def out_dirs(tmp_path, monkeypatch):
    before = evidence_stamp()
    monkeypatch.setattr(ref_common, "OUT_DIR", tmp_path / "ref")
    monkeypatch.setattr(port_common, "OUT_DIR", tmp_path / "port")
    yield tmp_path / "ref", tmp_path / "port"
    assert evidence_stamp() == before, "a lane rewrote experiments/benchmarks/"


def run_lane(fn, **kw):
    """The lane's rows, or None where only a wall-clock guard raised."""
    try:
        return fn(**kw)
    except RuntimeError as e:
        if any(g.search(str(e)) for g in TIMING_GUARDS):
            return None
        raise


def untimed_rows(rows):
    out = []
    for name, _us, derived in rows:
        if name.endswith("/speedup"):
            continue
        if name.endswith("/budget"):
            derived = re.sub(r";ok=\w+", "", derived)
        out.append((name, derived))
    return out


def untimed(obj):
    if isinstance(obj, dict):
        return {k: untimed(v) for k, v in obj.items() if k not in TIMING_KEYS}
    if isinstance(obj, list):
        return [untimed(v) for v in obj]
    return obj


def same_evidence(ref_dir: Path, port_dir: Path, names) -> None:
    for name in names:
        ref = json.loads((ref_dir / f"{name}.json").read_text())
        port = json.loads((port_dir / f"{name}.json").read_text())
        assert port["device"]["platform"] in ("cpu", "gpu")
        assert untimed(port) == untimed(ref), name


LANES = {
    # lane module: (kwargs, the JSONs it writes)
    "fig9_runtime": ({}, ["fig9_runtime"]),
    "fig10_energy": ({}, ["fig10_energy"]),
    "fig11_gb_breakdown": ({}, ["fig11_gb_breakdown"]),
    "fig13_bandwidth": ({}, ["fig13_bandwidth"]),
    "table3_validation": ({}, []),
    "mapper_search": ({}, ["mapper_search", "search_model"]),
}


@pytest.mark.parametrize("lane", sorted(LANES))
def test_analytic_lane_matches_the_reference(lane, out_dirs):
    import importlib

    kw, jsons = LANES[lane]
    ref = importlib.import_module(f"benchmarks.{lane}")
    port = importlib.import_module(f"repro_torch.bench.{lane}")
    port_kw = dict(kw, device="cpu") if lane == "mapper_search" else kw
    ref_rows = run_lane(ref.run, **kw)
    port_rows = run_lane(port.run, **port_kw)
    if ref_rows is not None and port_rows is not None:
        assert untimed_rows(port_rows) == untimed_rows(ref_rows)
        assert len(port_rows) == len(ref_rows) > 0
    elif lane == "fig13_bandwidth":  # rows from the sweep without the baseline
        assert untimed_rows(port.run(with_baseline=False)) == untimed_rows(
            ref.run(with_baseline=False))
    same_evidence(*out_dirs, jsons)


def test_table3_self_checks_hold(out_dirs):
    from repro_torch.bench import table3_validation

    rows = table3_validation.run()
    assert [r[0] for r in rows] == ["table3/Seq", "table3/SP-Optimized",
                                    "table3/PP-row", "table3/PP-col"]
    assert all(r[2].endswith("ok=True") for r in rows)


def test_roofline_reads_every_dryrun_cell(capsys):
    from repro_torch.bench import roofline

    assert len(roofline.load_results()) == 64
    rows = roofline.run()
    assert len(rows) == 64
    assert all(re.fullmatch(r"bound=(compute|memory|collective);RF=[0-9.]+", d)
               for _, _, d in rows)
    # the xlstm cells with scaled time loops carry temp_bytes null
    nulls = [r for r in roofline.load_results()
             if r["memory"]["temp_bytes"] is None]
    assert len(nulls) == 4
    roofline.main()
    out = capsys.readouterr().out
    assert out.count("roofline/") == 64 and "xlstm-1.3b" in out


def test_harness_keeps_the_reference_lane_names():
    import benchmarks.run as ref_run
    from repro_torch.bench import run as port_run

    assert list(port_run.MODULES) == list(ref_run.MODULES)
    assert port_run.FAST_DATASETS == ref_run.FAST_DATASETS
    assert port_run.FAST_MAPPER_CASES == ref_run.FAST_MAPPER_CASES


def test_evidence_lands_in_the_ports_own_directory():
    assert port_common.OUT_DIR == ROOT / "experiments" / "benchmarks_torch"
    assert port_common.OUT_DIR != ref_common.OUT_DIR


def test_harness_runs_fast_lanes_on_the_cpu(out_dirs, capsys):
    from repro_torch.bench import run as port_run

    assert port_run.main(["--only", "table3,fig11,mapper", "--fast",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert any(line.startswith("mapper/synth-model-3layer,") for line in out)
    assert not (out_dirs[1] / "mapper_search.json").exists()  # fast: no JSON
