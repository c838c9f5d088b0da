"""The port's Fig. 12 lane (PE allocation, with its scalar-loop baseline)
against the reference lane: rows and evidence JSON equal apart from timing
fields, each side writing under ``tmp_path`` (see
test_torch_bench_analytic.py)."""
from test_torch_bench_analytic import (  # noqa: F401  (the fixture)
    out_dirs,
    run_lane,
    same_evidence,
    untimed_rows,
)

# after the import above, which puts the repo root (the reference
# lanes) on the path
from benchmarks import fig12_pe_allocation as ref  # noqa: E402
from repro_torch.bench import fig12_pe_allocation as port  # noqa: E402


def test_pe_allocation_lane_matches_the_reference(out_dirs):  # noqa: F811
    ref_rows, port_rows = run_lane(ref.run), run_lane(port.run)
    if ref_rows is not None and port_rows is not None:
        assert untimed_rows(port_rows) == untimed_rows(ref_rows)
        assert len(port_rows) == len(ref_rows) > 0
    else:  # rows from the sweep without the baseline
        assert untimed_rows(port.run(with_baseline=False)) == untimed_rows(
            ref.run(with_baseline=False))
    same_evidence(*out_dirs, ["fig12_pe_allocation"])
