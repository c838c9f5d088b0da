"""A sample job of a kind that ``jobs/base.Job`` does not serve, for the
test that such a cell is added by new files alone: one mixture-of-experts
FFN layer of a language model in bfloat16, the port's
``models.moe.moe_ffn`` (the router, the expert-sorted grouped product and
the combine), over batches of prompts as a prefill runs it.

It keeps the job contract (``perfbench/README.md``) without deriving from
``base.Job``, whose programs run float32 alone.  Set-up makes the router
and the experts (the configuration's ``reference`` lays them out as the
port does) and ``batches`` inputs of ``batch`` x ``seq_len`` tokens on the
device from the seed, and runs each batch once.  The window runs one batch
after another; the last answer for each is held against the reference in
float32, the control being that reference with the products' operands
rounded to float8 (e4m3).
"""
from __future__ import annotations

import torch

from harness import Refused

from . import base


class Job:
    span = "forward"
    sources = ("program", "control")
    #: the configuration's stated type -> the precision the control computes in
    CONTROL = {"bfloat16": "float8_e4m3fn"}

    def __init__(self, config: dict, traffic: dict, seed: int, device, store):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.model = config["model"]
        self.dtype_name = self.model["dtype"]
        if self.dtype_name not in self.CONTROL:
            raise Refused(f"the sample MoE job runs {', '.join(self.CONTROL)}; "
                          f"the configuration states {self.dtype_name!r}")
        self.ref = base.reference(config["reference"])

    def setup(self) -> None:
        from repro_torch.models.config import ArchConfig, MoEConfig

        m = self.model
        self.cfg = ArchConfig(name=self.config["name"], family="moe", n_layers=1,
                              d_model=m["hidden_size"], n_heads=1, n_kv_heads=1,
                              d_ff=m["expert_width"], vocab=1,
                              moe=MoEConfig(n_experts=m["n_experts"], top_k=m["top_k"]),
                              dtype=self.dtype_name)
        self.tokens = self.traffic["batch"] * self.traffic["seq_len"]
        self.outputs: dict[int, torch.Tensor] = {}
        self.draw(self.seed)
        self.start()

    def draw(self, seed: int) -> None:
        """The seed's weights and input batches."""
        t = self.traffic
        gen = base.generator(seed, self.device)
        self.params = self.ref.init_params(self.model, gen, self.device)
        self.batches = torch.randn(
            (t["batches"], t["batch"], t["seq_len"], self.model["hidden_size"]),
            generator=gen, device=self.device).to(getattr(torch, self.dtype_name))

    def _run(self, b: int) -> int:
        from repro_torch.models.moe import moe_ffn

        self.outputs[b] = moe_ffn(self.cfg, self.params, self.batches[b])[0]
        return 1

    def start(self) -> None:
        """Every batch once, through the timed call, then wait for them."""
        for b in range(len(self.batches)):
            self._run(b)
        self.sync()

    def reseed(self, seed: int) -> None:
        self.draw(seed)
        self.start()

    def dispatch(self, i: int) -> int:
        return self._run(i % len(self.batches))

    def finish(self) -> None:
        pass

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- what the metrics read ------------------------------------------------
    def end_to_end(self, window) -> dict:
        return {"forward_ms": window.seconds * 1e3 / window.units}

    def model_flops(self, calls: list[int]) -> float:
        return self.ref.flops(self.model, self.tokens) * len(calls)

    # -- correctness ----------------------------------------------------------
    def release(self) -> None:
        self.outputs = {b: o.cpu() for b, o in self.outputs.items()}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, source: str = "program") -> dict:
        """``max_rel_err`` of the program's answers (``source="control"``:
        of the reference one precision below, in their place) against the
        reference in float32, and each answer's error."""
        if source not in self.sources:
            raise ValueError(f"unknown source {source!r}")
        top_k = self.model["top_k"]
        want = [self.ref.forward(self.params, x, top_k) for x in self.batches]
        got = ([self.ref.forward(self.params, x, top_k, self.CONTROL[self.dtype_name])
                for x in self.batches] if source == "control"
               else [self.outputs[b] for b in range(len(self.batches))])
        errs = base.relative_errors(got, want)
        return {"max_rel_err": float(errs.max()), "errors": errs}

    def check(self, limits: dict) -> tuple[dict, int]:
        r = self.readings()
        return {"max_rel_err": r["max_rel_err"]}, int((r["errors"] > limits["max_rel_err"]).sum())
