"""The port's LM training substrate against the reference's, on the CPU
(the port of tests/test_train_integration.py, apart from its elastic
multi-device restore): the data pipeline bit for bit, checkpoints that
cross between the packages both ways (bf16 leaves included), interrupted
training equal to uninterrupted bit for bit, compressed training that
learns, ``lm_loss`` and its gradients from converted weights, and the
``launch.train`` entry point resuming from its own checkpoint."""
import json
import logging
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.data import LMDataPipeline as RefPipeline
from repro.models import init_params as ref_init_params
from repro.models import lm_loss as ref_lm_loss
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import GraphStream, LMDataPipeline
from repro_torch.launch import train
from repro_torch.models import init_params, lm_loss, params_from_numpy
from repro_torch.optim import (
    adamw,
    compress_grads,
    decompress_grads,
    init_error_feedback,
)
from repro_torch.tree import leaves, tree_map, unflatten

CFG = get_config("smollm-135m").reduced(n_layers=2, d_model=32, d_ff=64, vocab=64)


def tree_equal(a, b):
    fa, fb = leaves(a), leaves(b)
    return len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))


def make_step(cfg=CFG):
    init_opt, update = adamw(lr=1e-3)

    def step(params, opt, batch):
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(), params)
            loss = lm_loss(cfg, p, batch)
            grads = unflatten(params, torch.autograd.grad(loss, leaves(p)))
        with torch.no_grad():
            params, opt = update(grads, opt, params)
        return loss.detach(), params, opt

    return init_opt, step


def _params(seed=0):
    return init_params(CFG, torch.Generator().manual_seed(seed), "cpu")


def _ref_params_both(cfg_name="smollm-135m", **reduce):
    """The reference's init and its conversion to the port."""
    rcfg = ref_get_config(cfg_name).reduced(**reduce)
    pcfg = get_config(cfg_name).reduced(**reduce)
    p_ref = ref_init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, pcfg, p_ref, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p_ref), device="cpu")


class TestDataPipeline:
    @pytest.mark.parametrize("arch", ["smollm-135m", "llava-next-34b"])
    def test_batches_are_the_reference_s_bit_for_bit(self, arch):
        """Token inputs, and embedded inputs (the VLM stub frontend's
        fixed table, in the config's dtype)."""
        rcfg, pcfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
        assert pcfg.embedded_inputs == (arch == "llava-next-34b")
        ref = RefPipeline(rcfg, 2, 48, seed=5)
        port = LMDataPipeline(pcfg, 2, 48, seed=5, device="cpu")
        for step in (0, 1, 7):
            want, got = ref.peek(step), port.peek(step)
            for key in ("inputs", "labels"):
                w = np.asarray(want[key].astype(jnp.float32)
                               if want[key].dtype == jnp.bfloat16 else want[key])
                g = got[key].float() if got[key].dtype == torch.bfloat16 else got[key]
                assert g.device.type == "cpu"
                assert np.array_equal(g.numpy(), w), (step, key)
        assert np.array_equal(next(port)["labels"].numpy(), np.asarray(next(ref)["labels"]))
        assert port.state_dict() == ref.state_dict() == {"seed": 5, "step": 1}

    def test_deterministic_per_step(self):
        d1 = LMDataPipeline(CFG, 2, 16, seed=3, device="cpu")
        d2 = LMDataPipeline(CFG, 2, 16, seed=3, device="cpu")
        for _ in range(3):
            assert torch.equal(next(d1)["inputs"], next(d2)["inputs"])

    def test_resume_replays_stream(self):
        d1 = LMDataPipeline(CFG, 2, 16, seed=3, device="cpu")
        for _ in range(5):
            next(d1)
        d2 = LMDataPipeline(CFG, 2, 16, seed=3, device="cpu")
        d2.load_state_dict(d1.state_dict())
        assert torch.equal(next(d1)["inputs"], next(d2)["inputs"])

    def test_copy_span_is_learnable_signal(self):
        toks = next(LMDataPipeline(CFG, 1, 64, seed=0, device="cpu"))["inputs"][0]
        assert (toks[8:] == toks[:-8]).float().mean() > 0.1

    def test_graph_stream_is_the_reference_s(self):
        from repro.data import GraphStream as RefStream

        ref, port = RefStream("mutag", 12, 3, seed=2), GraphStream("mutag", 12, 3, seed=2,
                                                                   device="cpu")
        for _ in range(2):
            (gr, *want), (gp, *got) = next(ref), next(port)
            assert gp.n_nodes == gr.n_nodes
            for w, g in zip(want, got):
                assert np.array_equal(g.numpy(), np.asarray(w))


class TestCheckpointResume:
    def test_interrupted_equals_uninterrupted(self, tmp_path):
        """3 steps + save + restore + 3 steps == 6 straight steps, bitwise."""
        init_opt, step = make_step()
        data = LMDataPipeline(CFG, 2, 16, seed=1, device="cpu")
        params = _params()
        opt = init_opt(params)

        p1, o1 = params, opt
        for s in range(6):
            _, p1, o1 = step(p1, o1, data.peek(s))

        ck = Checkpointer(tmp_path / "ck")
        p2, o2 = params, opt
        for s in range(3):
            _, p2, o2 = step(p2, o2, data.peek(s))
        ck.save(3, {"params": p2, "opt": o2, "data": {"seed": 1, "step": 3}})
        state = ck.restore({"params": p2, "opt": o2, "data": {"seed": 0, "step": 0}})
        p3, o3 = state["params"], state["opt"]
        start = int(state["data"]["step"])
        assert start == 3
        for s in range(start, 6):
            _, p3, o3 = step(p3, o3, data.peek(s))
        assert tree_equal(p1, p3)
        assert tree_equal(o1, o3)

    def test_atomic_rename_and_keep(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck", keep=2)
        params = _params()
        for s in (10, 20, 30, 40):
            ck.save(s, {"params": params})
        assert ck.all_steps() == [30, 40]
        assert ck.latest_step() == 40
        assert not list((tmp_path / "ck").glob(".tmp*"))

    def test_async_save(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck", async_save=True)
        params = _params()
        ck.save(5, {"params": params})
        ck.wait()
        assert tree_equal(ck.restore({"params": params})["params"], params)

    def test_missing_leaf_raises(self, tmp_path):
        ck = Checkpointer(tmp_path / "ck")
        ck.save(1, {"a": torch.zeros((2,))})
        with pytest.raises(KeyError):
            ck.restore({"a": torch.zeros((2,)), "b": torch.zeros((3,))})


def _state_pair():
    """One training state in both packages: bf16 and f32 parameters, the
    AdamW state (a NamedTuple), an int32 leaf, the data state's ints."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    ids = np.arange(4, dtype=np.int32)
    ref_p = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(b), "ids": jnp.asarray(ids)}
    port_p = {"w": torch.tensor(w).to(torch.bfloat16), "b": torch.tensor(b),
              "ids": torch.tensor(ids)}
    ref_opt = ref_adamw()[0]({"w": ref_p["w"], "b": ref_p["b"]})
    port_opt = adamw()[0]({"w": port_p["w"], "b": port_p["b"]})
    data = {"seed": 4, "step": 11}
    return ({"params": ref_p, "opt": ref_opt, "data": data},
            {"params": port_p, "opt": port_opt, "data": data})


class TestCrossPackageCheckpoints:
    def test_port_writes_the_reference_s_files_byte_for_byte(self, tmp_path):
        ref_state, port_state = _state_pair()
        RefCheckpointer(tmp_path / "ref").save(3, ref_state)
        Checkpointer(tmp_path / "port").save(3, port_state)
        a, b = tmp_path / "ref" / "step_3", tmp_path / "port" / "step_3"
        names = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
        assert names == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
        for name in names:
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
        manifest = json.loads((b / "manifest.json").read_text())
        bf16 = [l for l in manifest["leaves"] if l["dtype"] == "bfloat16"]
        assert [l["key"] for l in bf16] == ["params/w"]
        # the bf16 words, read as the reference's numpy bfloat16
        words = np.load(b / "arrays" / bf16[0]["file"])
        assert np.array_equal(words.view(ml_dtypes.bfloat16).astype(np.float32),
                              port_state["params"]["w"].float().numpy())

    def test_port_restores_a_reference_checkpoint(self, tmp_path):
        ref_state, port_state = _state_pair()
        RefCheckpointer(tmp_path / "ck").save(3, ref_state)
        like = tree_map(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else 0,
                        port_state)
        got = Checkpointer(tmp_path / "ck").restore(like)
        assert got["params"]["w"].dtype == torch.bfloat16
        assert tree_equal(got["params"], port_state["params"])
        assert tree_equal(got["opt"], port_state["opt"])
        assert {k: int(v) for k, v in got["data"].items()} == port_state["data"]

    def test_reference_restores_a_port_checkpoint(self, tmp_path):
        """Every leaf the reference's restore can cast: it raises on its own
        bf16 leaves too (numpy cannot cast ``V2`` to bfloat16), so those are
        held byte for byte above."""
        ref_state, port_state = _state_pair()
        Checkpointer(tmp_path / "ck").save(3, port_state)
        like = {"params": {k: v for k, v in ref_state["params"].items() if k != "w"},
                "opt": ref_state["opt"], "data": {"seed": 0, "step": 0}}
        got = RefCheckpointer(tmp_path / "ck").restore(like)
        for k in ("b", "ids"):
            assert np.array_equal(np.asarray(got["params"][k]),
                                  port_state["params"][k].numpy())
        assert int(got["opt"].step) == 0
        assert {k: int(v) for k, v in got["data"].items()} == port_state["data"]

    def test_model_checkpoint_crosses_both_ways(self, tmp_path):
        rcfg, pcfg, p_ref, p_port = _ref_params_both(n_layers=2, d_model=32, d_ff=64,
                                                     vocab=64)
        RefCheckpointer(tmp_path / "r").save(1, {"params": p_ref})
        Checkpointer(tmp_path / "p").save(1, {"params": p_port})
        zeros = tree_map(torch.zeros_like, p_port)
        assert tree_equal(Checkpointer(tmp_path / "r").restore({"params": zeros})["params"],
                          p_port)
        back = RefCheckpointer(tmp_path / "p").restore({"params": p_ref})["params"]
        assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in
                   zip(jax.tree_util.tree_leaves(back), leaves(p_port)))


class TestLoss:
    def test_lm_loss_matches_reference(self):
        """smollm-135m.reduced() (f32) from converted weights: the loss and
        every gradient leaf."""
        rcfg, pcfg, p_ref, p_port = _ref_params_both()
        batch_r = RefPipeline(rcfg, 2, 64, seed=3).peek(0)
        batch_p = LMDataPipeline(pcfg, 2, 64, seed=3, device="cpu").peek(0)
        loss_r, g_r = jax.value_and_grad(lambda p: ref_lm_loss(rcfg, p, batch_r))(p_ref)
        p = tree_map(lambda t: t.detach().requires_grad_(), p_port)
        loss = lm_loss(pcfg, p, batch_p)
        np.testing.assert_allclose(float(loss.detach()), float(loss_r), rtol=1e-4, atol=1e-4)
        grads = torch.autograd.grad(loss, leaves(p))
        for a, b in zip(jax.tree_util.tree_leaves(g_r), grads):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)

    def test_lm_loss_never_launches_a_kernel(self):
        from repro_torch.kernels.flash_attention import flash_attention

        flash_attention.launches = 0
        batch = LMDataPipeline(CFG, 2, 16, device="cpu").peek(0)
        loss = lm_loss(CFG, tree_map(lambda t: t.requires_grad_(), _params()), batch)
        loss.backward()
        assert flash_attention.launches == 0


def test_compressed_training_still_learns():
    init_opt, update = adamw(lr=2e-3)
    data = LMDataPipeline(CFG, 2, 16, seed=1, device="cpu")
    params = _params()
    opt = init_opt(params)
    ef = init_error_feedback(params)
    losses = []
    for s in range(30):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = lm_loss(CFG, p, data.peek(s))
        grads = unflatten(params, torch.autograd.grad(loss, leaves(p)))
        with torch.no_grad():
            q, ef = compress_grads(grads, ef)
            params, opt = update(decompress_grads(q), opt, params)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0]


def _main(*extra):
    return train.main(["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
                       "--checkpoint-every", "2", *extra])


class TestLaunchTrain:
    def test_main_resumes_from_its_checkpoint(self, tmp_path, capsys, caplog):
        ck = str(tmp_path / "ck")
        assert _main("--steps", "4", "--checkpoint-dir", ck) == 0
        assert "steps=4" in capsys.readouterr().out
        with caplog.at_level(logging.INFO, logger="repro_torch.train"):
            assert _main("--steps", "6", "--checkpoint-dir", ck) == 0
        out = capsys.readouterr().out
        assert "resumed from step 4" in caplog.text
        line = [l for l in out.splitlines() if l.startswith("FINAL")][0]
        assert line.endswith("steps=2")
        assert Checkpointer(ck).all_steps() == [2, 4, 6]

    def test_resumed_run_equals_a_straight_run_bitwise(self, tmp_path, capsys):
        """A 6-step run preempted after its step-4 checkpoint and restarted
        with the same flags == the 6 straight steps, bitwise."""
        a, b = tmp_path / "a", tmp_path / "b"
        _main("--steps", "6", "--checkpoint-dir", str(a))
        shutil.copytree(a, b)
        shutil.rmtree(b / "step_6")
        capsys.readouterr()
        _main("--steps", "6", "--checkpoint-dir", str(b))
        line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("FINAL")]
        assert line[0].endswith("steps=2")
        like = {"params": _params(), "opt": adamw()[0](_params()),
                "data": {"seed": 0, "step": 0}}
        got_a = Checkpointer(a).restore(like, step=6)
        got_b = Checkpointer(b).restore(like, step=6)
        assert tree_equal(got_a["params"], got_b["params"])
        assert tree_equal(got_a["opt"], got_b["opt"])
        assert not tree_equal(got_a["params"], _params())

    def test_compressed_main_runs(self, tmp_path, capsys):
        assert _main("--steps", "3", "--grad-compression", "int8") == 0
        assert "steps=3" in capsys.readouterr().out


def test_trainer_steps_an_arch_with_an_unused_leaf():
    """olmo-1b's non-parametric norms keep a scale leaf the loss never
    reads: its gradient is zero (as ``jax.grad`` gives it), and the step's
    loss and used gradients are the reference's."""
    cfg = get_config("olmo-1b").reduced()
    ref_cfg = ref_get_config("olmo-1b").reduced()
    tree = jax.tree_util.tree_map(np.asarray, ref_init_params(ref_cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32) for k in ("inputs", "labels")}
    ref_loss, ref_grads = jax.value_and_grad(lambda p: ref_lm_loss(ref_cfg, p, batch))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    init_opt, step_fn = train.build_trainer(cfg, lr=1e-3, total_steps=10)
    params = params_from_numpy(tree, "cpu")
    loss, new, _, _ = step_fn(params, init_opt(params), None,
                              {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-4)
    assert all(torch.isfinite(t).all() for t in leaves(new))
    zero = [np.asarray(g) for g in jax.tree_util.tree_leaves(ref_grads) if not np.any(g)]
    assert zero, "the reduced olmo-1b config has no unused leaf"
