"""The hand-written CUDA kernels on the card, against their plain
versions.  Marked ``cuda``: skipped without a CUDA device; on a machine
with one, run ``python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerances are those of tests/test_kernels.py: fp32 2e-5, bf16 2e-2."""
import pytest
import torch

from repro_torch.kernels import decode_attention, flash_attention, ref

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,window", [
    (2, 128, 128, 9, 3, 64, True, None),
    (1, 100, 300, 4, 2, 128, True, 64),       # ragged, window, q_offset
    (2, 70, 70, 4, 1, 64, False, None),       # non-causal, ragged
])
def test_flash_attention_kernel(gen, b, sq, sk, h, hkv, d, causal, window,
                                dtype):
    q = _randn(gen, (b, sq, h, d), dtype)
    k = _randn(gen, (b, sk, hkv, d), dtype)
    v = _randn(gen, (b, sk, hkv, d), dtype)
    opts = dict(causal=causal, window=window, q_offset=sk - sq)
    before = flash_attention.launches.count
    got = flash_attention.flash_attention(q, k, v, **opts)
    torch.cuda.synchronize()
    assert flash_attention.launches.count == before + 1
    torch.testing.assert_close(got.float(),
                               ref.attention(q, k, v, **opts).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,smax,h,hkv,d,lens,window", [
    (4, 1024, 9, 3, 64, (1, 129, 700, 1024), None),
    (2, 600, 8, 1, 128, (600, 3), 100),
])
def test_flash_decode_kernel(gen, b, smax, h, hkv, d, lens, window, dtype):
    q = _randn(gen, (b, h, d), dtype)
    kc = _randn(gen, (b, smax, hkv, d), dtype)
    vc = _randn(gen, (b, smax, hkv, d), dtype)
    cache_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = decode_attention.launches.count
    got = decode_attention.flash_decode(q, kc, vc, cache_len, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches.count == before + 1
    torch.testing.assert_close(
        got.float(),
        ref.decode_attention(q, kc, vc, cache_len, window=window).float(),
        **TOL[dtype])


def test_kernels_refuse_what_they_do_not_take(gen):
    """A head_dim the kernel lacks raises on the card: no fallback."""
    q = _randn(gen, (1, 16, 2, 8), torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention.flash_decode(q[:, 0], q, q, 4)


def test_flash_attention_backward_recomputes_plain(gen):
    q, k, v = (_randn(gen, (1, 64, 2, 64), torch.float32).requires_grad_()
               for _ in range(3))
    flash_attention.flash_attention(q, k, v).sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    ref.attention(q, k, v).sum().backward()
    for got, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(got, t.grad, rtol=2e-4, atol=2e-4)
