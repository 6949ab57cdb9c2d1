"""Flash attention forward: the hand-written CUDA kernel
(``csrc/flash_attention.cu``) that replaces the Pallas TPU kernel ``_fwd``
of ``repro.kernels.flash_attention``, its plain PyTorch version, and the
wrapper that picks between them by where the tensors lie.

``flash_attention`` takes ``ref.attention``'s arguments and layout
(q (B, Sq, H, D), k/v (B, Sk, Hkv, D)).  For CPU tensors it runs the plain
version; for CUDA tensors it launches the kernel or raises — it never
falls back.  The kernel takes fp32 or bf16 and head_dim 64 or 128 (GQA by
indexing the kv head, so K/V are never repeated).

The backward is the plain version's, recomputed (the Pallas kernel's
``custom_vjp`` does the same), through a ``torch.autograd.Function``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build, ref

#: the plain PyTorch version of the kernel
flash_attention_ref = ref.attention
#: launches of the CUDA kernel
launches = build.LaunchCounter("flash_attention")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_INT32_MAX = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_attention").repro_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], q_offset: int) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: q, k, v must share one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,Sq,H,D) and k, v "
                         f"(B,Sk,Hkv,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2] != 0:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if q_offset < 0 or (window is not None and window < 1):
        raise ValueError(f"flash_attention: q_offset {q_offset} must be >= 0 "
                         f"and window {window} >= 1")
    if max(q.numel(), k.numel()) > _INT32_MAX or min(q.numel(),
                                                     k.numel()) == 0:
        raise ValueError("flash_attention: empty or > 2**31-element input")


def _launch(q, k, v, causal: bool, window: Optional[int],
            q_offset: int) -> torch.Tensor:
    _check(q, k, v, window, q_offset)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       b, sq, sk, h, hkv, d, _DTYPES[q.dtype], int(causal),
                       -1 if window is None else window, q_offset,
                       d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    launches.add()
    return o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, q_offset)
        return _launch(q, k, v, causal, window, q_offset)

    @staticmethod
    def backward(ctx, grad):
        causal, window, q_offset = ctx.opts
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.attention(*leaves, causal=causal, window=window,
                                q_offset=q_offset)
        dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, chunk: int = 2048) -> torch.Tensor:
    """GQA attention forward, (B, S, H, D) layout.  CPU tensors take the
    plain version; CUDA tensors launch the kernel.  ``chunk`` applies to
    the plain version only (it picks its chunked form, as in
    ``ref.attention``): the kernel tiles the keys itself and ignores it."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, chunk=chunk)
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)
