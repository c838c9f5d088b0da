"""The port's hardware x dataflow co-design lane against the reference
lane: rows and evidence JSON equal apart from timing fields, each side
writing under ``tmp_path`` (see test_torch_bench_analytic.py)."""
from test_torch_bench_analytic import (  # noqa: F401  (the fixture)
    out_dirs,
    same_evidence,
    untimed_rows,
)

# after the import above, which puts the repo root (the reference
# lanes) on the path
from benchmarks import hw_codesign as ref  # noqa: E402
from repro_torch.bench import hw_codesign as port  # noqa: E402


def test_codesign_lane_matches_the_reference(out_dirs):  # noqa: F811
    ref_rows, port_rows = ref.run(), port.run()
    assert untimed_rows(port_rows) == untimed_rows(ref_rows)
    assert len(port_rows) == 2
    same_evidence(*out_dirs, ["hw_codesign"])
