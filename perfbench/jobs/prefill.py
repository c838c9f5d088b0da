"""Prefill of the port's Mellum2 language model in bfloat16: one prompt
after another through ``models.transformer.forward`` under
``torch.inference_mode()``, the logits at every position, as serving
computes a long context before it answers.

It keeps the job contract (``perfbench/README.md``) without deriving from
``base.Job``, whose programs run float32 alone.  The configuration is the
model's ``config.json`` (read into the port's ``ArchConfig`` by
``repro_torch.configs.mellum2_12b_a2p5b.from_published``); its
``reference`` makes the weights on the card from the seed, in the port's
layout, and ``prompts`` prompts of ``batch`` x ``seq_len`` token ids are
drawn there too.  Set-up runs every prompt once; the window cycles through
them, one call each.  Each call keeps the logits at every
``check_every``-th position and the last; after the window the last
answer for each prompt is held against the reference in float32, row by
row: a row's largest gap over its largest reference logit.  The control is
that reference with both operands of every matrix product rounded through
float8 (e4m3).
"""
from __future__ import annotations

import numpy as np
import torch

from harness import Refused

from . import base


class Job:
    span = "prefill"
    sources = ("program", "control")
    #: the configuration's stated type -> the precision the control computes in
    CONTROL = {"bfloat16": "float8_e4m3fn"}

    def __init__(self, config: dict, traffic: dict, seed: int, device, store):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.dtype_name = config["dtype"]
        if self.dtype_name not in self.CONTROL:
            raise Refused(f"the prefill job runs {', '.join(self.CONTROL)}; "
                          f"the configuration states {self.dtype_name!r}")
        self.ref = base.reference(config["reference"])

    def setup(self) -> None:
        from repro_torch.configs.mellum2_12b_a2p5b import from_published

        t = self.traffic
        self.cfg = from_published(self.config, dtype=self.dtype_name)
        self.batch, self.seq_len = t["batch"], t["seq_len"]
        every = t["check_every"]
        self.rows = sorted(set(range(every - 1, self.seq_len, every)) | {self.seq_len - 1})
        self.draw(self.seed)
        self.start()

    def draw(self, seed: int) -> None:
        """The seed's weights and prompts (the last draw's freed first)."""
        self.params = self.prompts = self._want = None
        self.outputs: dict[int, torch.Tensor] = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        gen = base.generator(seed, self.device)
        self.params = self.ref.init_params(self.config, gen, self.device)
        self.prompts = torch.randint(
            0, self.config["vocab_size"], (self.traffic["prompts"], self.batch, self.seq_len),
            generator=gen, device=self.device)

    def _run(self, p: int) -> int:
        from repro_torch.models.transformer import forward

        with torch.inference_mode():
            logits, _ = forward(self.cfg, self.params, self.prompts[p])
            self.outputs[p] = logits[:, self.rows]
        return 1

    def start(self) -> None:
        """Every prompt once, through the timed call, then wait for them."""
        for p in range(len(self.prompts)):
            self._run(p)
        self.sync()

    def reseed(self, seed: int) -> None:
        self.draw(seed)
        self.start()

    def dispatch(self, i: int) -> int:
        return self._run(i % len(self.prompts))

    def finish(self) -> None:
        pass

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- what the metrics read ------------------------------------------------
    def end_to_end(self, window) -> dict:
        return {"forward_ms": window.seconds * 1e3 / window.units}

    def model_flops(self, calls: list[int]) -> float:
        return self.ref.flops(self.config, self.batch, self.seq_len) * len(calls)

    def kernel_work(self, work, calls: list[int]) -> list[tuple[float, float]]:
        """``work(config, batch, seq_len)``'s bytes and operations of each
        launch of one call, for every call of ``calls``, in order."""
        return [w for _ in calls for w in work(self.config, self.batch, self.seq_len)]

    # -- correctness ----------------------------------------------------------
    def release(self) -> None:
        """Frees the forward's activations; the weights stay for the
        reference, which computes from them."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, prec: str) -> list[torch.Tensor]:
        return [self.ref.forward(self.params, self.config, tokens, self.rows, prec)
                for tokens in self.prompts]

    def readings(self, source: str = "program") -> dict:
        """The program's answers (``source="control"``: the reference one
        precision below, in their place) against the reference in float32,
        each checked row's error (its largest gap over its largest
        reference logit): the worst, ``max_rel_err``, the median,
        ``median_rel_err``, and every row's."""
        if source not in self.sources:
            raise ValueError(f"unknown source {source!r}")
        if self._want is None:
            self._want = self._reference("float32")
        got = (self._reference(self.CONTROL[self.dtype_name]) if source == "control"
               else [self.outputs[p] for p in range(len(self.prompts))])
        errs = row_errors(got, self._want)
        return {"max_rel_err": float(errs.max()), "median_rel_err": float(np.median(errs)),
                "errors": errs}

    def check(self, limits: dict) -> tuple[dict, int]:
        """Each limited number, and the rows over ``max_rel_err``'s limit."""
        r = self.readings()
        return {k: r[k] for k in limits}, int((r["errors"] > limits["max_rel_err"]).sum())


def row_errors(got: list[torch.Tensor], want: list[torch.Tensor]):
    """Each row's largest absolute gap to the reference's row over that
    row's largest reference magnitude; a row that is not finite reads
    infinity."""
    w = torch.cat([t.reshape(-1, t.shape[-1]) for t in want]).double().cpu()
    g = torch.cat([t.reshape(-1, t.shape[-1]).to(w.device) for t in got]).double()
    gap = (g - w).abs().amax(dim=1) / w.abs().amax(dim=1).clamp_min(1e-30)
    return torch.where(torch.isfinite(g).all(dim=1), gap, torch.inf).numpy()
