"""Decoder model of the PyTorch port, for configs built from dense
attention blocks (smollm-135m).

The reference scans a stack of per-pattern-position parameters with
``jax.lax.scan``; here ``params["layers"]`` holds one dict per layer and
the forward pass is a Python loop over them.  ``repro_torch.bridge``
maps the reference's stacked parameters onto this layout.

Entry points (functions of (cfg, params, ...)):
  init_params    : parameters from a ``torch.Generator``
  forward        : (B, S) tokens -> (B, S, V) logits
  prefill        : forward + populated decode cache           [serve]
  init_cache     : empty decode cache
  decode_step    : one-token step with cache update           [serve]
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import blocks
from .blocks import BlockSpec, ModelConfig


def _check_ported(cfg: ModelConfig) -> None:
    for spec in cfg.pattern:
        if spec.kind != "attn" or spec.moe:
            raise NotImplementedError(
                f"{cfg.name}: block {spec} is not ported yet (dense "
                f"attention blocks only)")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Parameters on ``gen``'s device, with the reference's distributions
    and scales.  params['layers'][i] = {"core": attention, "ffn": mlp}."""
    _check_ported(cfg)
    params: Dict[str, Any] = {
        "embed": blocks._normal(gen, (cfg.vocab_size, cfg.d_model), 0.02,
                                cfg.dtype)}
    if not cfg.tie_embeddings:
        params["unembed"] = blocks._normal(
            gen, (cfg.d_model, cfg.vocab_size), cfg.d_model ** -0.5,
            cfg.dtype)
    if cfg.norm == "rms":
        params["final_norm_w"] = blocks._ones(gen, cfg.d_model)
    params["layers"] = [{"core": blocks.init_attention(cfg, gen),
                         "ffn": blocks.init_mlp(cfg, gen)}
                        for _ in range(cfg.n_layers)]
    return params


# --------------------------------------------------------------------------
# forward — optionally emitting the decode cache (prefill)
# --------------------------------------------------------------------------

def _apply_block(cfg: ModelConfig, spec: BlockSpec, p: Dict,
                 x: torch.Tensor, positions: torch.Tensor):
    """Returns (x_out, state) where state feeds prefill cache population."""
    if spec.kind != "attn":
        raise NotImplementedError(spec.kind)
    x, state = blocks.attention_block(cfg, p["core"], x, positions)
    return blocks.mlp_block(cfg, p["ffn"], x), state


def _state_to_cache(cfg: ModelConfig, spec: BlockSpec, state,
                    max_len: int, positions: torch.Tensor) -> dict:
    """Convert a forward-pass block state into decode-cache format: the
    last min(S, Smax) keys/values at their ring-buffer slots."""
    if spec.kind != "attn":
        raise NotImplementedError(spec.kind)
    k, v = state
    b, s = k.shape[0], k.shape[1]
    smax = max_len if cfg.window is None else min(max_len, cfg.window)
    m = min(s, smax)
    slots = positions[-m:] % smax
    kc = torch.zeros((b, smax) + tuple(k.shape[2:]), dtype=k.dtype,
                     device=k.device)
    vc = torch.zeros_like(kc)
    kc[:, slots] = k[:, -m:]
    vc[:, slots] = v[:, -m:]
    return {"k": kc, "v": vc}


def _unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w


def _forward(cfg: ModelConfig, params: Dict[str, Any], tokens: torch.Tensor,
             with_cache: bool, max_len: int = 0):
    """The normed final hidden states (B, S, d) and, with ``with_cache``,
    one decode cache per layer."""
    x = params["embed"][tokens.long()]
    positions = torch.arange(x.shape[1], device=x.device)
    caches: List[dict] = []
    for layer, p in enumerate(params["layers"]):
        spec = cfg.block_at(layer)
        x, state = _apply_block(cfg, spec, p, x, positions)
        if with_cache:
            caches.append(_state_to_cache(cfg, spec, state, max_len,
                                          positions))
    return blocks.norm(cfg, params.get("final_norm_w"), x), caches


def forward(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> (B, S, V) logits."""
    return _unembed(cfg, params, _forward(cfg, params, tokens, False)[0])


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device) -> List[dict]:
    """Empty decode cache on ``device``: one {"k", "v"} dict per layer."""
    _check_ported(cfg)
    smax = max_len if cfg.window is None else min(max_len, cfg.window)
    shape = (batch, smax, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_len: int):
    """Full-sequence forward that also populates the decode cache.

    Returns (last-token logits (B, V), cache, next positions (B,) int32).
    Only the last position is unembedded: the other logits are unused."""
    b, s = tokens.shape[0], tokens.shape[1]
    x, caches = _forward(cfg, params, tokens, True, max_len)
    logits = _unembed(cfg, params, x[:, -1])
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, caches, pos


def decode_step(cfg: ModelConfig, params: Dict[str, Any], cache: List[dict],
                token: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, List[dict]]:
    """token: (B,) int; pos: (B,) position of the new token.  Returns
    (logits (B, V), cache) — the cache is updated in place."""
    x = params["embed"][token.long()][:, None]
    for layer, p in enumerate(params["layers"]):
        x, cache[layer] = blocks.attention_block_decode(
            cfg, p["core"], x, cache[layer], pos)
        x = blocks.mlp_block(cfg, p["ffn"], x)
    x = blocks.norm(cfg, params.get("final_norm_w"), x[:, 0])
    return _unembed(cfg, params, x), cache
