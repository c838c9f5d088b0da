"""Batched serving entry point: prefill a batch of prompts, decode new tokens.

The port of :mod:`repro.launch.serve`.  On the card (the default device):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
On the CPU, at smoke scale:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --device cpu --batch 4 --prompt-len 32 --new-tokens 16

The prefill ``forward`` runs each layer's attention through the
flash-attention kernel on a CUDA device; decode attention is plain
PyTorch, as in the reference.  On a card the prompt replay and the
per-token steps replay one captured ``decode_step`` (a CUDA graph, for
every arch but a float32 MoE: ``models.transformer.decoder``), as the
reference jits it; the prefill ``forward``, sampling and the argmax run
uncaptured.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..models import forward, init_cache, init_params, make_inputs
from ..models.layers import torch_dtype
from ..models.transformer import decoder


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts, new_tokens: int, greedy: bool = True,
             generator=None, *, use_kernels: bool = True, timings=None,
             decode_table=None):
    """prompts: (B, S) tokens (or (B, S, d) embeddings for stub frontends).
    Returns ((B, new_tokens) token ids, per-step latencies in seconds).

    Step for step as the reference: a prefill ``forward`` for the first
    token's logits, the prompt replayed through ``decode_step`` to build the
    cache, then one ``decode_step`` per new token.  ``generator`` draws the
    samples when not ``greedy``.  ``use_kernels=False`` runs the kernels'
    plain versions.  When ``timings`` is a dict, it receives the wall
    seconds of ``prefill_s``, ``replay_s`` and ``decode_s``.  The
    embedded-input archs decode in embedding space through a fixed
    (64, d_model) table: ``decode_table`` (an array, carried across as
    weights are), or else one drawn from numpy ``default_rng(7)``.
    """
    b, s = prompts.shape[:2]
    dev = prompts.device
    t0 = time.perf_counter()
    logits, _ = forward(cfg, params, prompts, use_kernels=use_kernels)
    next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    _sync(dev)
    t1 = time.perf_counter()
    cache = init_cache(cfg, b, s + new_tokens, dev)
    # replay the prompt through decode steps to build the cache: one
    # captured step on a card (models.transformer.decoder), as the
    # reference jits decode_step
    step = decoder(cfg, params, cache, prompts[:, :1])
    for t in range(s):
        step(prompts[:, t:t + 1], t)
    _sync(dev)
    t2 = time.perf_counter()

    table = None
    if cfg.embedded_inputs:
        # stub frontends decode in embedding space with a fixed table
        if decode_table is None:
            rng = np.random.default_rng(7)
            decode_table = rng.normal(size=(64, cfg.d_model)).astype(np.float32) * 0.05
        table = torch.as_tensor(np.array(decode_table, np.float32),
                                device=dev).to(torch_dtype(cfg))
        if table.shape != (64, cfg.d_model):
            raise ValueError(f"decode_table must be (64, {cfg.d_model}), got "
                             f"{tuple(table.shape)}")
    out_tokens, lat = [], []
    for i in range(new_tokens):
        ts = time.perf_counter()
        tok_in = table[next_tok[:, 0] % 64][:, None] if table is not None else next_tok
        logits = step(tok_in, s + i)
        if greedy:
            next_tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        else:
            probs = torch.softmax(logits[:, -1].float(), dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)
        next_tok = next_tok.to(torch.int32)
        out_tokens.append(next_tok)
        _sync(dev)
        lat.append(time.perf_counter() - ts)
    if timings is not None:
        timings.update(prefill_s=t1 - t0, replay_s=t2 - t1,
                       decode_s=time.perf_counter() - t2)
    return torch.cat(out_tokens, dim=1), lat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_params(cfg, torch.Generator().manual_seed(args.seed), dev)
    prompts = make_inputs(cfg, args.batch, args.prompt_len, seed=args.seed,
                          device=dev)
    toks, lat = generate(cfg, params, prompts, args.new_tokens)
    print(f"generated {tuple(toks.shape)} tokens on {dev}; sample row: "
          f"{toks[0].cpu().numpy()[:12]}")
    print(
        f"decode latency: first={lat[0]*1e3:.1f}ms "
        f"steady={np.median(lat[1:])*1e3 if len(lat) > 1 else 0:.1f}ms"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
