"""Serving driver of the PyTorch port: batched prefill + sliced decode,
executor-ready.

The engine exposes device work as GPU-access segments (``repro_torch.core.
segments.SlicedOp``): ``decode_segment(n)`` is a sliced, resumable segment
— ``slice_tokens`` decode steps per dispatch, with the KV cache / position
/ emitted tokens threaded as the explicit carry — so the real-time
executor preempts between slices with delay bounded by one slice
(DESIGN.md §6).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --batch 4 --prompt-len 128 --decode 64

The engine runs on the CUDA device unless given ``device="cpu"`` (then
every kernel wrapper takes its plain PyTorch version).  The disaggregated,
daemon and workload-registry modes of ``repro.launch.serve`` are not
ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get
from ..core.segments import SlicedOp, block_until_ready, n_slices_for
from ..models import transformer


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA device when None.  There is no quiet CPU
    fallback: without a card, ask for ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class InferenceEngine:
    def __init__(self, cfg, params=None, max_len: int = 256, seed: int = 0,
                 device=None):
        """``params`` (from ``transformer.init_params`` or
        ``repro_torch.bridge``) must live on ``device``; when omitted they
        are made on it from a generator seeded with ``seed``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = transformer.init_params(cfg, gen)
        self.params = params
        self.max_len = max_len
        self.cache = None
        self.pos = None
        self.last_tok = None

    def prefill_batch(self, tokens) -> torch.Tensor:
        """tokens: (B, S).  Returns last-token logits."""
        tokens = torch.as_tensor(tokens, device=self.device)
        logits, self.cache, self.pos = transformer.prefill(
            self.cfg, self.params, tokens, self.max_len)
        self.last_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits

    # -- GPU-access segments (executor-dispatched) ----------------------
    def prefill_segment(self, tokens) -> SlicedOp:
        """Prefill as a one-slice device segment (its measured duration is
        its own preemption-delay bound)."""
        def step(carry, i):
            return self.prefill_batch(tokens)

        return SlicedOp(1, lambda: None, step, lambda logits: logits,
                        label="prefill")

    def decode_segment(self, n: int, slice_tokens: int = 1) -> SlicedOp:
        """Generate ``n`` tokens as a sliced segment: ``slice_tokens``
        decode steps per dispatch (the preemption grain), carry = {cache,
        pos, tok, out}.  ``init`` clones the engine's cache, because the
        decode steps write the carry's cache in place; the engine state is
        committed at finalize, so a preempted or abandoned carry never
        corrupts the engine.  ``finalize`` returns the (B, n) tokens."""
        b = self.last_tok.shape[0]

        def init():
            return {"cache": [{k: t.clone() for k, t in layer.items()}
                              for layer in self.cache],
                    "pos": self.pos, "tok": self.last_tok,
                    "out": torch.zeros((b, n), dtype=torch.int32,
                                       device=self.device)}

        def step(carry, i):
            cache, pos, tok, out = (carry["cache"], carry["pos"],
                                    carry["tok"], carry["out"])
            for t in range(i * slice_tokens,
                           min((i + 1) * slice_tokens, n)):
                logits, cache = transformer.decode_step(
                    self.cfg, self.params, cache, tok, pos)
                pos = pos + 1
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                out[:, t] = tok
            return {"cache": cache, "pos": pos, "tok": tok, "out": out}

        def finalize(carry):
            self.cache = carry["cache"]
            self.pos = carry["pos"]
            self.last_tok = carry["tok"]
            return carry["out"]

        return SlicedOp(n_slices_for(n, slice_tokens), init, step,
                        finalize, label="decode")

    def decode_chunk(self, n: int) -> torch.Tensor:
        """Generate ``n`` tokens inline (no executor): runs the sliced
        segment to completion.  Returns (B, n) tokens."""
        return self.decode_segment(n).run()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    entry = get(args.arch)
    cfg = entry.reduced() if args.reduced else entry.config()
    eng = InferenceEngine(cfg, max_len=args.prompt_len + args.decode + 8,
                          device=args.device)
    gen = torch.Generator(device=eng.device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen, device=eng.device)
    t0 = time.perf_counter()
    block_until_ready(eng.prefill_batch(toks))
    t1 = time.perf_counter()
    out = block_until_ready(eng.decode_chunk(args.decode))
    t2 = time.perf_counter()
    print(f"prefill {args.batch}x{args.prompt_len}: {(t1 - t0) * 1e3:.1f} ms")
    per_tok = (t2 - t1) * 1e3 / args.decode
    print(f"decode {args.decode} tokens: {per_tok:.2f} ms/tok "
          f"({args.batch * 1e3 / per_tok:.1f} tok/s aggregate)")
    print("sample:", out[0, :16].tolist())


if __name__ == "__main__":
    main()
