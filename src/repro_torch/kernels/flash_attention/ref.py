"""Plain PyTorch versions of the flash-attention kernel.

``attend_chunked`` is the port of ``repro.models.attention._attend_chunked``
(the SP-Optimized chunked online softmax, the schedule the kernel runs):
the model route runs it for a CPU tensor and the chip checks hold the
kernel against it.  ``attention_ref`` is the port of the materialised
oracle ``repro.kernels.flash_attention.ref.attention_ref`` (the paper's
Seq).
"""
import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30  # a finite sentinel: exp(-inf - -inf) would be NaN
INT32_MAX = int(np.iinfo(np.int32).max)


def attend_chunked(q, k, v, q_pos, k_pos, window: int = 0, chunk: int = 512,
                   *, causal: bool = True):
    """Online-softmax attention over KV chunks, walked in increasing order.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) with Hq % Hkv == 0 (query head
    ``h`` reads KV head ``h // (Hq // Hkv)``); q_pos: (Sq,), k_pos: (Sk,)
    integer positions.  With ``causal`` a key is seen when
    ``k_pos <= q_pos`` (and ``k_pos > q_pos - window`` when ``window``);
    without it every real key is seen.  Float32 accumulation, the output
    in q's dtype.
    """
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    chunk = min(chunk, sk)
    n_chunks = -(-sk // chunk)
    pad = n_chunks * chunk - sk
    k = F.pad(k, (0, 0, 0, 0, 0, pad))
    v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kp_all = F.pad(k_pos.long(), (0, pad), value=INT32_MAX)
    real = torch.arange(n_chunks * chunk, device=q.device) < sk
    qp = q_pos.long()[:, None]

    g = h // n_kv
    qg = q.reshape(b, sq, n_kv, g, hd).float() / np.sqrt(hd)
    acc = torch.zeros((b, n_kv, g, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, n_kv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n_kv, g, sq), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        blk = slice(c * chunk, (c + 1) * chunk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, blk].float())
        if causal:
            kp = kp_all[blk][None, :]
            mask = kp <= qp
            if window > 0:
                mask &= kp > qp - window
        else:
            mask = real[blk][None, :].expand(sq, -1)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        upd = torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, blk].float())
        acc = acc * alpha[..., None] + upd
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def flash_attention_ref(q, k, v, causal=False, block_k=128):
    """The reference op's function in its layout, q (B, Hq, Sq, D), k/v
    (B, Hkv, Sk, D), masked on indices: :func:`attend_chunked` with
    positions 0..S-1 and ``block_k``-key chunks."""
    ar_q = torch.arange(q.shape[2], device=q.device)
    ar_k = torch.arange(k.shape[2], device=q.device)
    out = attend_chunked(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                         ar_q, ar_k, chunk=block_k, causal=causal)
    return out.transpose(1, 2)


def attention_ref(q, k, v, sm_scale=None, causal=False):
    """Materialised-score attention: q (BH, Sq, D), k/v (BH, Sk, D)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d**0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        qp = torch.arange(sq, device=q.device)[:, None]
        kp = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(kp <= qp, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
