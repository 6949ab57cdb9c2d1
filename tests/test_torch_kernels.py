"""The PyTorch port's attention against the JAX reference on the CPU.

The same inputs, made with numpy from a seed, go through
``repro_torch.kernels`` (on CPU tensors the wrappers run their plain
versions) and through ``repro.kernels``: the jnp reference and the Pallas
kernels in interpret mode, as tests/test_kernels.py runs them.
Tolerances are those of tests/test_kernels.py: fp32 2e-5, bf16 2e-2.
The CUDA kernels themselves run only on the card (``-m cuda``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro_torch.kernels import decode_attention, flash_attention, ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

# jit the JAX references: one compile per case instead of one per jnp op
_jref_attention = jax.jit(jref.attention, static_argnames=(
    "causal", "window", "q_offset", "chunk"))
_jref_decode = jax.jit(jref.decode_attention, static_argnames=("window",))

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(JDT[dtype])
    t = torch.from_numpy(a).to(TDT[dtype])
    return j, t


def _close(got_t, want_j, dtype):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# prefill attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # b, sq, sk, h, hkv, d, causal, window, chunk
    (2, 64, 64, 4, 2, 16, True, None, 2048),       # dense, GQA
    (1, 128, 128, 2, 2, 32, True, 48, 2048),       # sliding window
    (2, 32, 128, 4, 4, 16, True, None, 2048),      # q_offset (chunked prefill)
    (1, 64, 64, 2, 1, 16, False, None, 2048),      # non-causal, MQA
    (2, 64, 128, 6, 2, 8, True, 40, 32),           # chunked + window + offset
    (1, 128, 128, 9, 3, 8, True, None, 32),        # chunked, smollm heads
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window,chunk", ATTN_CASES)
def test_attention_matches_jax_reference(b, sq, sk, h, hkv, d, causal,
                                         window, chunk, dtype):
    q, k, v = _arrays(0, (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    qo = sk - sq
    want = _jref_attention(qj, kj, vj, causal=causal, window=window,
                           q_offset=qo, chunk=chunk)
    got = ops.attention(qt, kt, vt, causal=causal, window=window,
                        q_offset=qo, chunk=chunk)
    assert got.dtype == TDT[dtype] and got.shape == (b, sq, h, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 128, 256, 2, 2, 64, True, 96),             # window + q_offset
])
def test_attention_matches_pallas_interpret(b, sq, sk, h, hkv, d, causal,
                                            window, dtype):
    q, k, v = _arrays(1, (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
    qo = sk - sq
    want = pallas_attention(qj, kj, vj, causal=causal, window=window,
                            q_offset=qo, block_q=64, block_k=64,
                            interpret=True)
    got = flash_attention.flash_attention(qt, kt, vt, causal=causal,
                                          window=window, q_offset=qo)
    _close(got, want, dtype)


def test_chunked_equals_dense():
    q, k, v = _arrays(2, (2, 96, 4, 16), (2, 128, 2, 16), (2, 128, 2, 16))
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    want = tref.attention_dense(q, k, v, window=50, q_offset=32)
    got = tref.attention_chunked(q, k, v, window=50, q_offset=32, chunk=32)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_repeat_kv_matches_jax():
    (k,) = _arrays(3, (2, 5, 3, 4))
    want = jax.jit(jref.repeat_kv, static_argnums=1)(jnp.asarray(k), 3)
    got = tref.repeat_kv(torch.from_numpy(k), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_attention_gradients_match_jax():
    """The CPU path is differentiable through the plain version."""
    q, k, v = _arrays(4, (1, 32, 2, 8), (1, 32, 1, 8), (1, 32, 1, 8))
    gj = jax.jit(jax.grad(lambda *a: jref.attention_dense(*a).sum(),
                          argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ops.attention(*ts).sum().backward()
    for a, t in zip(gj, ts):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a),
                                   rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # b, smax, h, hkv, d, lens, window
    (2, 64, 4, 2, 16, (50, 64), None),
    (3, 128, 6, 2, 32, (1, 77, 128), None),        # ragged cache_len
    (2, 64, 4, 1, 16, (64, 30), 24),               # ring-buffer window
    (1, 96, 9, 3, 8, (96,), None),                 # smollm heads
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,smax,h,hkv,d,lens,window", DECODE_CASES)
def test_decode_matches_jax_reference(b, smax, h, hkv, d, lens, window,
                                      dtype):
    q, kc, vc = _arrays(5, (b, h, d), (b, smax, hkv, d), (b, smax, hkv, d))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, kc, vc))
    lens = np.asarray(lens, np.int32)
    want = _jref_decode(qj, kj, vj, jnp.asarray(lens), window=window)
    got = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens),
                               window=window)
    assert got.dtype == TDT[dtype] and got.shape == (b, h, d)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,smax,h,hkv,d,lens,window", [
    (2, 256, 4, 2, 64, (200, 17), None),
    (2, 256, 4, 2, 64, (256, 140), 128),
])
def test_decode_matches_pallas_interpret(b, smax, h, hkv, d, lens, window,
                                         dtype):
    q, kc, vc = _arrays(6, (b, h, d), (b, smax, hkv, d), (b, smax, hkv, d))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, kc, vc))
    lens = np.asarray(lens, np.int32)
    want = pallas_decode(qj, kj, vj, jnp.asarray(lens), window=window,
                         block_k=64, interpret=True)
    got = decode_attention.flash_decode(qt, kt, vt, torch.from_numpy(lens),
                                        window=window)
    _close(got, want, dtype)


def test_decode_scalar_cache_len():
    q, kc, vc = _arrays(7, (2, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16))
    want = _jref_decode(*map(jnp.asarray, (q, kc, vc)), 20)
    got = tref.decode_attention(*map(torch.from_numpy, (q, kc, vc)), 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the wrappers: plain version only for CPU tensors, never a fallback
# ---------------------------------------------------------------------------

def test_cpu_path_does_not_count_launches():
    before = (flash_attention.launches.count, decode_attention.launches.count)
    q, k, v = (torch.zeros(1, 8, 2, 64) for _ in range(3))
    ops.attention(q, k, v)
    ops.decode_attention(q[:, 0], k, v, 4)
    assert (flash_attention.launches.count,
            decode_attention.launches.count) == before


def test_non_cpu_tensor_takes_the_kernel_path():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    refuses what the kernel cannot take (here: not a CUDA tensor) instead
    of quietly running the plain version."""
    q = torch.zeros(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention.flash_decode(q[:, 0], q, q, 4)
