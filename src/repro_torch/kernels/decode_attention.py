"""Flash decode: the hand-written CUDA kernel (``csrc/flash_decode.cu``)
that replaces the Pallas TPU kernel ``flash_decode`` of
``repro.kernels.decode_attention``, its plain PyTorch version, and the
wrapper that picks between them by where the tensors lie.

``flash_decode(q, k_cache, v_cache, cache_len)``: q (B, H, D), caches
(B, Smax, Hkv, D), cache_len (B,) or a scalar.  For CPU tensors it runs the
plain version; for CUDA tensors it launches the kernel or raises — it
never falls back.  The kernel takes fp32 or bf16, head_dim 64 or 128, and
up to 8 query heads per kv head; it reads ``cache_len`` from device memory,
so a decode step never waits on the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from . import build, ref

#: the plain PyTorch version of the kernel
flash_decode_ref = ref.decode_attention
#: launches of the CUDA kernel
launches = build.LaunchCounter("flash_decode")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 8          # query heads per kv head (csrc/flash_decode.cu)
_INT32_MAX = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_decode").repro_flash_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _lengths(cache_len, b: int, device: torch.device) -> torch.Tensor:
    """cache_len as a contiguous (B,) int32 tensor on ``device`` (no host
    sync: a device tensor stays on the device)."""
    if isinstance(cache_len, torch.Tensor):
        if cache_len.device != device:
            raise ValueError(f"flash_decode: cache_len on {cache_len.device}, "
                             f"caches on {device}")
        lens = cache_len.to(torch.int32).reshape(-1)
        if lens.numel() == 1 and b != 1:
            lens = lens.expand(b)
        return lens.contiguous()
    return torch.full((b,), int(cache_len), dtype=torch.int32, device=device)


def _check(q, k_cache, v_cache, lens, window: Optional[int]) -> None:
    if not (q.is_cuda and k_cache.device == q.device
            and v_cache.device == q.device):
        raise ValueError(f"flash_decode: q and caches must share one CUDA "
                         f"device, got {q.device}, {k_cache.device}, "
                         f"{v_cache.device}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode: q and caches must all be float32 or "
                        f"bfloat16, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"flash_decode: want q (B,H,D) and caches "
                         f"(B,Smax,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % hkv != 0:
        raise ValueError(f"flash_decode: caches {tuple(k_cache.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {d} not in {_HEAD_DIMS}")
    if h // hkv > _MAX_GROUP:
        raise ValueError(f"flash_decode: {h // hkv} query heads per kv head "
                         f"> {_MAX_GROUP}")
    if lens.shape != (b,):
        raise ValueError(f"flash_decode: cache_len of shape "
                         f"{tuple(lens.shape)} for batch {b}")
    for t in (q, k_cache, v_cache):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_decode: q and caches must be contiguous "
                             "and 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window {window} must be >= 1")
    if k_cache.numel() > _INT32_MAX or k_cache.numel() == 0:
        raise ValueError("flash_decode: empty or > 2**31-element cache")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: Union[torch.Tensor, int],
                 *, window: Optional[int] = None) -> torch.Tensor:
    """One-token GQA attention over a KV cache; returns (B, H, D).  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return flash_decode_ref(q, k_cache, v_cache, cache_len,
                                window=window)
    lens = _lengths(cache_len, q.shape[0], q.device)
    _check(q, k_cache, v_cache, lens, window)
    b, h, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       lens.data_ptr(), o.data_ptr(), b, smax, h, hkv, d,
                       _DTYPES[q.dtype], -1 if window is None else window,
                       d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: "
                           f"cudaError {err}")
    launches.add()
    return o
