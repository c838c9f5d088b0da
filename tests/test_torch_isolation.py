"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the reference package ``repro`` (not even its
framework-free modules)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys, repro_torch, repro_torch.gnn, repro_torch.graphs, "
        "repro_torch.kernels.spmm, repro_torch.kernels.fused_agg_cmb, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.gemm_dataflow, "
        "repro_torch.models, repro_torch.configs, repro_torch.launch.serve, "
        "repro_torch.runtime, repro_torch.runtime.scheduler, repro_torch.gnn.pp, "
        "repro_torch.graphs.partition, repro_torch.core.calibrate, "
        "repro_torch.launch.train, repro_torch.optim, repro_torch.data, "
        "repro_torch.checkpoint, repro_torch.models.moe, repro_torch.models.rglru, "
        "repro_torch.models.xlstm, repro_torch.launch.analytic, "
        "repro_torch.models.sharding, repro_torch.launch.mesh, "
        "repro_torch.launch.specs, repro_torch.launch.dryrun, "
        "repro_torch.launch.hlo, repro_torch.launch.roofline\n"
        "import repro_torch.configs.gcn_paper\n"
        "from repro_torch.configs import all_configs\n"
        "all_configs()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(','.join(bad))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=SRC, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_module_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"
            )
