"""The oracle of the aggregation's backward and the bands it is held
against, shared by the CPU tests (``test_torch_train_capture.py``) and the
card's (``test_torch_cuda.py``).  Imports neither ``jax`` nor ``repro``."""
import numpy as np
import torch


def backward_before(indices, weights, x, g):
    """``_AggregateBand.backward`` as the port computed it before training
    was captured: its segment sum checked its lengths (``unsafe=False``),
    which reads the device on the host, and keyed every slot by its index,
    so all padded slots summed into row 0's segment."""
    b, d = indices.shape
    flat = indices.reshape(-1).long()
    gathered = x.index_select(0, flat).reshape(b, d, -1).to(g.dtype)
    gw = (gathered * g[:, None, :]).sum(-1).to(weights.dtype)
    terms = (weights.to(g.dtype)[:, :, None] * g[:, None, :]).reshape(b * d, -1)
    order = torch.argsort(flat, stable=True)
    rows = torch.zeros(x.shape[0], dtype=torch.int64, device=flat.device)
    rows.scatter_add_(0, flat, torch.ones_like(flat))
    gx = torch.segment_reduce(terms[order], "sum", lengths=rows, axis=0)
    return gw, gx.to(x.dtype)


def band(seed, b, d, v, f):
    """A band of ``b`` rows of ``d`` slots over ``v`` source rows of width
    ``f``: rows of every degree from 0 to ``d`` (padding slots point at row
    0 with weight 0), one hub source row most slots point at, source rows
    no slot points at, and the upstream gradient ``g``."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((b, d), np.int64)
    wts = np.zeros((b, d), np.float32)
    for r in range(b):
        deg = int(rng.integers(0, d + 1))
        hub = rng.random(deg) < 0.5
        idx[r, :deg] = np.where(hub, v - 1, rng.integers(0, max(v // 2, 1), deg))
        wts[r, :deg] = rng.normal(size=deg)
    return _tensors(rng, idx, wts, v, f)


def cora_band(seed, b=128, d=82, v=2816, f=16):
    """One band of the cora training cell's layer 1: ``b`` rows of ``d``
    slots over ``v`` source rows of width ``f``, most slots padding.  Row
    degrees are geometric with mean 5 (cora's), the band's first row is
    full, and a real slot points at row 0 now and then."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((b, d), np.int64)
    wts = np.zeros((b, d), np.float32)
    deg = np.minimum(rng.geometric(0.2, b), d)
    deg[0] = d
    for r in range(b):
        idx[r, :deg[r]] = np.where(rng.random(deg[r]) < 0.05, 0,
                                   rng.integers(0, v, deg[r]))
        wts[r, :deg[r]] = rng.uniform(0.05, 1.0, deg[r])
    return _tensors(rng, idx, wts, v, f)


def _tensors(rng, idx, wts, v, f):
    x = rng.normal(size=(v, f)).astype(np.float32)
    g = rng.normal(size=(idx.shape[0], f)).astype(np.float32)
    return (torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(wts),
            torch.from_numpy(x), torch.from_numpy(g))
