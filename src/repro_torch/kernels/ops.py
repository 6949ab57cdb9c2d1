"""The kernel layer's entry points, as the model calls them.

Each op goes to its wrapper, and the wrapper decides by where the tensors
lie: CPU tensors run the plain PyTorch version, CUDA tensors launch the
hand-written kernel or raise.  There is no switch and no fallback.
"""
from __future__ import annotations

from typing import Optional

from .decode_attention import flash_decode
from .flash_attention import flash_attention


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, chunk: int = 2048):
    """Multi-head (GQA) attention: q (B,Sq,H,D), k/v (B,Sk,Hkv,D).
    ``chunk`` reaches the plain version only (CPU tensors)."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, chunk=chunk)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None):
    """Single-token attention over a KV cache: q (B,H,D)."""
    return flash_decode(q, k_cache, v_cache, cache_len, window=window)
