"""How far xlstm-1.3b's two forms and the two packages agree, on the CPU.

The xLSTM family (reference ``repro.models.xlstm`` and its port
``repro_torch.models.xlstm``) is exponentially gated; at random init a
rounding in an early block grows through the later ones.  This script
reads that at d_model 512 x 16 layers (the published width cut to a
quarter, the depth to a third, vocab 512), each number a relative L2
error of logits over 2 x 8 tokens:

1. float32: each package's 8 decode steps against its own forward at the
   same positions, and the port's against the reference's;
2. bfloat16: each block of the port against the reference's on the same
   input (their sum orders differ, nothing else);
3. bfloat16: the reference's forward against itself with one-ulp noise on
   a random third of its embedding entries each way.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/xlstm_conditioning.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.transformer as ref_tf
import repro_torch.models.transformer as tf
from repro.configs import get_config
from repro.models.stubs import make_inputs
from repro_torch.models import params_from_numpy


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def model(dtype):
    cfg = get_config("xlstm-1.3b").with_(d_model=512, n_layers=16, vocab=512, dtype=dtype)
    rp = ref_tf.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, rp, params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), "cpu")


def decode_vs_forward():
    cfg, rp, pt = model("float32")
    toks = np.asarray(make_inputs(cfg, 2, 8, seed=0))
    rf = np.asarray(ref_tf.forward(cfg, rp, jnp.asarray(toks))[0])
    pf = tf.forward(cfg, pt, torch.from_numpy(toks.copy()))[0].numpy()
    rc, pc = ref_tf.init_cache(cfg, 2, 8), tf.init_cache(cfg, 2, 8, device="cpu")
    rows = []
    for i in range(8):
        rl, rc = ref_tf.decode_step(cfg, rp, rc, jnp.asarray(toks[:, i:i + 1]), i)
        pl, pc = tf.decode_step(cfg, pt, pc, torch.from_numpy(toks[:, i:i + 1].copy()), i)
        rl, pl = np.asarray(rl)[:, 0], pl.numpy()[:, 0]
        rows.append({"step": i, "reference": rel(rl, rf[:, i]), "port": rel(pl, pf[:, i]),
                     "port_vs_reference": rel(pl, rl)})
    return {"forward_port_vs_reference": rel(pf, rf), "decode_vs_forward": rows}


def bf16_blocks_and_noise():
    cfg, rp, pt = model("bfloat16")
    npp = jax.tree_util.tree_map(np.asarray, rp)
    x = (np.random.default_rng(0).normal(size=(2, 8, 512)) * 0.3).astype(np.float32)
    xb, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    pos = np.tile(np.arange(8), (2, 1))
    blocks = []
    for i, kind in enumerate(cfg.block_pattern):
        pr = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), npp["scanned"][i])
        r, _ = ref_tf.apply_block(cfg, kind, pr, xb, jnp.asarray(pos))
        o, _ = tf.apply_block(cfg, kind, tf._index(pt["scanned"][i], 0), xt,
                              torch.from_numpy(pos))
        blocks.append({"kind": kind, "port_vs_reference": rel(o.float().numpy(), r)})
    toks = jnp.asarray(make_inputs(cfg, 2, 8, seed=0))
    base = ref_tf.forward(cfg, rp, toks)[0]
    emb = np.asarray(rp["embeddings"]["embed"]).astype(np.float32)
    ulp = np.random.default_rng(1).choice([-1, 0, 1], emb.shape) * np.abs(emb) * 2.0**-8
    noisy = dict(rp, embeddings=dict(rp["embeddings"],
                                     embed=jnp.asarray(emb + ulp).astype(jnp.bfloat16)))
    return {"blocks": blocks,
            "reference_under_one_ulp_embedding_noise": rel(ref_tf.forward(cfg, noisy, toks)[0],
                                                           base)}


if __name__ == "__main__":
    import json

    print(json.dumps({"f32": decode_vs_forward(), "bf16": bf16_blocks_and_noise()}, indent=1))
