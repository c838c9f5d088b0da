"""Each of the port's examples (``repro_torch.examples``) runs to the end
on the CPU: ``main(["--device", "cpu"])`` returns 0.  The GNN training
example runs 2 epochs of 5 steps (its warm epoch still builds nothing);
the LM training example writes its checkpoints under ``tmp_path``."""
import importlib

import pytest

EXAMPLES = {
    "quickstart": [],
    "dataflow_explorer": [],
    "dlrm_multiphase": [],
    "gnn_parallel_pipeline": [],
    "serve_async": [],
    "serve_lm": [],
    "train_gnn_dataflow": ["--epochs", "2", "--steps", "5"],
    "train_lm": None,  # its checkpoint directory is the test's own
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path, capsys):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    extra = EXAMPLES[name]
    if extra is None:
        extra = ["--checkpoint-dir", str(tmp_path / "ckpt")]
    assert mod.main(["--device", "cpu", *extra]) == 0
    out = capsys.readouterr().out
    assert out.strip()
    if name == "quickstart":
        assert "policy sp_opt" in out and "policy seq" in out
    if name == "train_gnn_dataflow":
        assert "epoch 1: 0 new builds" in out
    if name == "train_lm":
        assert out.count("FINAL loss=") == 2
    if name == "gnn_parallel_pipeline":
        assert "one-device fallback: True" in out


def test_train_lm_example_keeps_its_checkpoints_in_the_checkout():
    from pathlib import Path

    from repro_torch.examples import train_lm

    root = Path(__file__).resolve().parents[1]
    assert train_lm.CHECKPOINT_DIR == root / "build" / "train_lm_example"
