"""Plain PyTorch versions of the attention kernels: the ground truth the
CUDA kernels are held against on the card, and the path a wrapper takes
for tensors on the CPU.

The same functions as ``repro.kernels.ref`` (``repeat_kv``,
``attention_dense``, ``attention_chunked``, ``attention``,
``decode_attention``), with the same shapes: q/k/v are (batch, seq, heads,
head_dim); GQA is n_kv_heads <= n_heads with n_heads % n_kv_heads == 0.
Scores and the softmax are fp32; masked scores are NEG_INF = -1e30.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D)"""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d) \
        .reshape(b, s, h * n_rep, d)


def _visible(rows: torch.Tensor, cols: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    mask = torch.ones(rows.shape[0], cols.shape[1], dtype=torch.bool,
                      device=rows.device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, chunk: int = 2048) -> torch.Tensor:
    """Multi-head attention: the dense version for short keys, the chunked
    online-softmax version (memory O(Sq x chunk)) for long ones."""
    sk = k.shape[1]
    if sk > chunk and sk % chunk == 0:
        return attention_chunked(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, chunk=chunk)
    return attention_dense(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Dense attention.  q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D).  Key j is
    visible from query i iff (not causal or j <= i) and
    i - window < j, with i counted from ``q_offset``."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    k = repeat_kv(k, h // hkv)
    v = repeat_kv(v, h // hkv)
    scale = d ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    rows = torch.arange(sq, device=q.device)[:, None] + q_offset
    cols = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = _visible(rows, cols, causal, window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, chunk: int = 2048) -> torch.Tensor:
    """Online softmax over KV chunks with a running (max, sum, acc) — the
    same result as the dense version."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    k = repeat_kv(k, h // hkv)
    v = repeat_kv(v, h // hkv)
    scale = d ** -0.5
    rows = torch.arange(sq, device=q.device)[:, None] + q_offset
    qf = q.float()
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    lsum = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    for start in range(0, sk, chunk):
        kc = k[:, start:start + chunk]
        vc = v[:, start:start + chunk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.float()) * scale
        cols = start + torch.arange(kc.shape[1], device=q.device)[None, :]
        mask = _visible(rows, cols, causal, window)
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[torch.Tensor, int], *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a KV cache.

    q: (B, H, D) new-token queries; caches: (B, Smax, Hkv, D); cache_len:
    number of valid entries, (B,) or a scalar (the new token is already
    written).  The q heads are grouped by their kv head, so the cache is
    contracted without repeating it."""
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d)
    scale = d ** -0.5
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k_cache.float()) * scale
    cols = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = cols < lens
    if window is not None:
        valid &= cols >= lens - window
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, h, d).to(q.dtype)
