"""Transformer building blocks of the PyTorch port: the model config, norms,
rotary embeddings, the attention block (prefill and one-token decode over a
ring-buffer KV cache) and the dense MLP.

Plain functions of (config, params, inputs), as in ``repro.models.blocks``.
Parameters are dicts of tensors made by the matching ``init_*`` functions
from an explicit ``torch.Generator``; they live on the generator's device.

Conventions:
  x            : (B, S, d_model) activations, cfg.dtype (bf16 by default)
  params       : weights in cfg.dtype; norm weights in fp32
  head layout  : (B, S, H, head_dim)

The mixture-of-experts, cross-attention, Mamba and RWKV blocks of the
reference are not ported yet; their config fields are kept so that a
config compares field by field with the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops


# --------------------------------------------------------------------------
# config
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str          # "attn" | "cross" | "mamba" | "rwkv"
    moe: bool = False  # FFN of this block is a mixture of experts


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[BlockSpec, ...] = (BlockSpec("attn"),)
    head_dim: Optional[int] = None           # default d_model // n_heads
    norm: str = "rms"                         # "rms" | "nonparam"
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity: float = 1.25
    window: Optional[int] = None              # sliding-window attention
    rope_theta: float = 10_000.0
    cross_source_len: int = 64                # stub frontend tokens (vlm/audio)
    input_mode: str = "tokens"                # "tokens" | "embeddings"
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64
    attn_chunk: int = 2048                    # KV chunk of the plain attention
    mlp_variant: str = "swiglu"               # "swiglu" | "gelu" | "relu2"
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    sharding_profile: str = "tp"              # "tp" | "hybrid"
    fsdp: bool = False                        # ZeRO-3: params over data axes
    grad_accum: int = 1                       # microbatched grad accumulation
    remat: bool = True
    remat_policy: str = "nothing_saveable"    # or "dots_with_no_batch_dims_saveable"
    loss_chunks: int = 8                      # seq-chunked xent (memory)
    moe_seq_chunks: int = 4                   # chunked MoE dispatch (memory)

    def __post_init__(self):
        if self.n_layers % len(self.pattern) != 0:
            raise ValueError("n_layers must be a multiple of the pattern")
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def block_at(self, layer: int) -> BlockSpec:
        return self.pattern[layer % len(self.pattern)]


# --------------------------------------------------------------------------
# norms / rope
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + 1e-6)
    if weight is not None:
        out = out * weight
    return out.to(x.dtype)


def nonparametric_ln(x: torch.Tensor) -> torch.Tensor:
    """OLMo-style LayerNorm without adaptive gain/bias."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def norm(cfg: ModelConfig, w: Optional[torch.Tensor],
         x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "nonparam":
        return nonparametric_ln(x)
    return rms_norm(x, w)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotary embeddings (half-split rotation, fp32 angles).
    q, k: (B, S, H, D); positions: (S,) or (B, S)."""
    half = q.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=q.device) / half)
    pos = positions.float()
    if positions.dim() == 1:
        ang = pos[None, :, None] * freqs[None, None]
    else:
        ang = pos[:, :, None] * freqs[None, None]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]

    def rot(t):
        t1, t2 = t[..., :half], t[..., half:]
        return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin],
                         dim=-1).to(t.dtype)

    return rot(q), rot(k)


# --------------------------------------------------------------------------
# attention blocks
# --------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def _ones(gen: torch.Generator, d: int) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=gen.device)


def init_attention(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    scale = d ** -0.5
    p = {
        "wq": _normal(gen, (d, h * hd), scale, cfg.dtype),
        "wk": _normal(gen, (d, hkv * hd), scale, cfg.dtype),
        "wv": _normal(gen, (d, hkv * hd), scale, cfg.dtype),
        "wo": _normal(gen, (h * hd, d), scale, cfg.dtype),
    }
    if cfg.norm == "rms":
        p["norm_w"] = _ones(gen, d)
    return p


def _split_heads(t: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = t.shape
    return t.reshape(b, s, n, -1)


def attention_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor):
    """Causal self-attention with pre-norm and residual.

    Returns (x_out, (k, v)) — the per-layer post-RoPE keys/values feed
    prefill cache population."""
    h = norm(cfg, p.get("norm_w"), x)
    q = _split_heads(h @ p["wq"], cfg.n_heads)
    k = _split_heads(h @ p["wk"], cfg.n_kv_heads)
    v = _split_heads(h @ p["wv"], cfg.n_kv_heads)
    q, k = rope(q, k, positions, cfg.rope_theta)
    out = ops.attention(q, k, v, causal=True, window=cfg.window,
                        chunk=cfg.attn_chunk)
    b, s = out.shape[:2]
    return x + out.reshape(b, s, -1) @ p["wo"], (k, v)


def attention_block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                           cache: dict, pos: torch.Tensor
                           ) -> Tuple[torch.Tensor, dict]:
    """One-token attention; cache: {k: (B,Smax,Hkv,D), v: ...}, updated in
    place (the caller owns it: ``InferenceEngine.decode_segment`` clones
    the engine's cache into its carry).

    Sliding-window caches are ring buffers of size ``window``: the write
    slot is pos % Smax and, once full, every slot is a valid key (exactly
    the last ``window`` positions)."""
    b = x.shape[0]
    h = norm(cfg, p.get("norm_w"), x)          # (B, 1, d)
    q = _split_heads(h @ p["wq"], cfg.n_heads)  # (B,1,H,D)
    k_new = _split_heads(h @ p["wk"], cfg.n_kv_heads)
    v_new = _split_heads(h @ p["wv"], cfg.n_kv_heads)
    q, k_new = rope(q, k_new, pos.reshape(b, 1), cfg.rope_theta)
    smax = cache["k"].shape[1]
    slot = pos % smax
    cache_len = torch.clamp(pos + 1, max=smax)
    _write_at(cache["k"], k_new, slot)
    _write_at(cache["v"], v_new, slot)
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], cache_len)
    return x + out.reshape(b, 1, -1) @ p["wo"], cache


def _write_at(cache: torch.Tensor, new: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """Write (B,1,H,D) into (B,Smax,H,D) at per-batch position pos, in
    place (the reference's functional scatter, without copying the
    cache)."""
    b = cache.shape[0]
    rows = torch.arange(b, device=cache.device)
    cache[rows, pos.long().expand(b)] = new[:, 0].to(cache.dtype)
    return cache


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, gen: torch.Generator) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    scale = d ** -0.5
    p = {"wi": _normal(gen, (d, f), scale, cfg.dtype)}
    if cfg.mlp_variant == "swiglu":
        p["wg"] = _normal(gen, (d, f), scale, cfg.dtype)
    p["wo"] = _normal(gen, (f, d), f ** -0.5, cfg.dtype)
    if cfg.norm == "rms":
        p["norm_w"] = _ones(gen, d)
    return p


def mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = norm(cfg, p.get("norm_w"), x)
    up = h @ p["wi"]
    if cfg.mlp_variant == "swiglu":
        up = up * F.silu(h @ p["wg"])
    elif cfg.mlp_variant == "relu2":
        up = torch.square(F.relu(up))          # minitron/nemotron
    else:
        up = F.gelu(up, approximate="tanh")    # musicgen (jax.nn.gelu)
    return x + up @ p["wo"]
