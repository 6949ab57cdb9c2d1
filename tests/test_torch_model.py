"""The PyTorch port's model and serving engine against the JAX reference
on the CPU, at the reduced smollm-135m size.

Both sides use the same weights (the reference's ``init_params``, carried
over by ``repro_torch.bridge``) and, for the end-to-end checks, fp32.
Tolerances: 2e-5 for single blocks, 1e-4 for prefill logits after four
layers (fp32 sums in another order), exact equality for greedy tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.launch.serve import InferenceEngine as JaxEngine
from repro.models import blocks as jblocks
from repro.models import transformer as jtransformer
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get as tget
from repro_torch.core.segments import SlicedOp
from repro_torch.launch.profile_serve import profile_phase
from repro_torch.launch.serve import InferenceEngine
from repro_torch.models import blocks as tblocks
from repro_torch.models import transformer as ttransformer
from repro_torch.sched import DeviceExecutor, RTJob

torch.set_num_threads(1)

BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(dtype="float32"):
    jcfg = jget("smollm-135m").reduced()
    tcfg = tget("smollm-135m").reduced()
    if dtype == "float32":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    return jcfg, tcfg


def _jax_params(cfg, seed):
    return jax.jit(lambda key: jtransformer.init_params(cfg, key))(
        jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def bridged():
    """fp32 reduced smollm: reference params, the port's bridged copy."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, 0)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _prompt(cfg, seed=0, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


# ---------------------------------------------------------------------------
# config and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["config", "reduced"])
def test_config_matches_reference(which):
    jc = getattr(jget("smollm-135m"), which)()
    tc = getattr(tget("smollm-135m"), which)()
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if f.name == "dtype":
            assert str(jnp.dtype(a)) == str(b).replace("torch.", "")
        elif f.name == "pattern":
            assert [(s.kind, s.moe) for s in a] == [(s.kind, s.moe)
                                                    for s in b]
        else:
            assert a == b, f.name


def test_bridge_keeps_values_and_dtypes():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jax.tree.map(np.asarray, _jax_params(jcfg, 3))
    tp = params_from_numpy(jp, tcfg, "cpu")
    assert len(tp["layers"]) == tcfg.n_layers
    for layer in range(tcfg.n_layers):
        for part in ("core", "ffn"):
            for name, leaf in jp["blocks"][0][part].items():
                got = tp["layers"][layer][part][name]
                want = np.asarray(leaf[layer], np.float32)
                assert str(got.dtype) == "torch." + str(leaf.dtype)
                np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(tp["embed"].float().numpy(),
                                  np.asarray(jp["embed"], np.float32))


def test_init_params_shapes_and_scales():
    jcfg, tcfg = _cfgs("bfloat16")
    jp = _jax_params(jcfg, 0)
    tp = ttransformer.init_params(tcfg, torch.Generator().manual_seed(0))
    ref = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    for layer in (0, tcfg.n_layers - 1):
        for part in ("core", "ffn"):
            for name, want in ref["layers"][layer][part].items():
                got = tp["layers"][layer][part][name]
                assert got.shape == want.shape and got.dtype == want.dtype
                # same distribution: std within 10% of the reference's
                ws, gs = want.float().std().item(), got.float().std().item()
                assert abs(gs - ws) <= 0.1 * ws + 1e-6, (name, gs, ws)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 72)).astype(np.float32)
    w = rng.standard_normal((72,)).astype(np.float32)
    want = jax.jit(jblocks.rms_norm)(jnp.asarray(x), jnp.asarray(w))
    got = tblocks.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_nonparametric_ln_matches_reference():
    x = np.random.default_rng(2).standard_normal((3, 40)).astype(np.float32)
    want = jax.jit(jblocks.nonparametric_ln)(jnp.asarray(x))
    got = tblocks.nonparametric_ln(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("per_batch", [False, True])
def test_rope_matches_reference(per_batch):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
    pos = (np.stack([np.arange(6) + 3, np.arange(6) + 90]) if per_batch
           else np.arange(6)).astype(np.int32)
    rope = jax.jit(jblocks.rope, static_argnums=3)
    wq, wk = rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), 1e4)
    gq, gk = tblocks.rope(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), **BLOCK_TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **BLOCK_TOL)


@pytest.mark.parametrize("variant", ["swiglu", "gelu", "relu2"])
def test_mlp_block_matches_reference(variant):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, mlp_variant=variant)
    tcfg = dataclasses.replace(tcfg, mlp_variant=variant)
    jp = jblocks.init_mlp(jcfg, jax.random.PRNGKey(4))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 3, 72)) \
        .astype(np.float32)
    want = jax.jit(lambda p, x: jblocks.mlp_block(jcfg, p, x))(
        jp, jnp.asarray(x))
    got = tblocks.mlp_block(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


# ---------------------------------------------------------------------------
# the whole slice: prefill and greedy decode
# ---------------------------------------------------------------------------

def test_prefill_logits_match_reference(bridged):
    jcfg, tcfg, jp, tp = bridged
    toks = _prompt(jcfg)
    want = jax.jit(lambda p, t: jtransformer.forward(jcfg, p, t))(
        jp, jnp.asarray(toks, jnp.int32))
    got = ttransformer.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_init_cache_matches_reference(window):
    """One zeroed {k, v} per layer, shaped like the reference's stacked
    cache without its leading ``repeats`` axis (the ring of a windowed
    config holds ``window`` slots)."""
    jcfg, tcfg = _cfgs("bfloat16")
    jcfg = dataclasses.replace(jcfg, window=window)
    tcfg = dataclasses.replace(tcfg, window=window)
    want = jtransformer.init_cache(jcfg, 2, 20)
    got = ttransformer.init_cache(tcfg, 2, 20, device="cpu")
    assert len(got) == tcfg.n_layers
    n_pat = len(tcfg.pattern)
    for layer, entry in enumerate(got):
        for name in ("k", "v"):
            ref = np.asarray(want[layer % n_pat][name][layer // n_pat],
                             np.float32)
            assert tuple(entry[name].shape) == ref.shape
            assert entry[name].dtype == tcfg.dtype
            np.testing.assert_array_equal(entry[name].float().numpy(), ref)


def test_engine_greedy_tokens_match_reference(bridged):
    jcfg, tcfg, jp, tp = bridged
    toks = _prompt(jcfg, seed=1)
    je = JaxEngine(jcfg, params=jp, max_len=32)
    te = InferenceEngine(tcfg, params=tp, max_len=32, device="cpu")
    jl = je.prefill_batch(jnp.asarray(toks, jnp.int32))
    tl = te.prefill_batch(toks)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(te.decode_chunk(8).numpy(),
                                  np.asarray(je.decode_chunk(8)))
    assert int(te.pos[0]) == toks.shape[1] + 8


def test_windowed_ring_cache_matches_reference():
    """A sliding-window config wraps its ring-buffer cache while decoding."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, window=8)
    tcfg = dataclasses.replace(tcfg, window=8)
    jp = _jax_params(jcfg, 5)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = _prompt(jcfg, seed=2, shape=(2, 6))
    je = JaxEngine(jcfg, params=jp, max_len=32)
    te = InferenceEngine(tcfg, params=tp, max_len=32, device="cpu")
    je.prefill_batch(jnp.asarray(toks, jnp.int32))
    te.prefill_batch(toks)
    np.testing.assert_array_equal(te.decode_chunk(6).numpy(),
                                  np.asarray(je.decode_chunk(6)))


# ---------------------------------------------------------------------------
# the engine as a sliced segment
# ---------------------------------------------------------------------------

@pytest.fixture()
def engine(bridged):
    _, tcfg, _, tp = bridged
    return InferenceEngine(tcfg, params=tp, max_len=48, device="cpu")


@pytest.mark.parametrize("slice_tokens", [1, 3])
def test_decode_segment_matches_inline_decode(engine, slice_tokens):
    toks = _prompt(engine.cfg)
    engine.prefill_batch(toks)
    want = engine.decode_chunk(6)
    engine.prefill_batch(toks)
    op = engine.decode_segment(6, slice_tokens=slice_tokens)
    assert op.n_slices == -(-6 // slice_tokens)
    torch.testing.assert_close(op.run(), want, rtol=0, atol=0)


def test_run_sliced_decode_equals_decode_chunk(engine):
    toks = _prompt(engine.cfg, seed=3)
    engine.prefill_batch(toks)
    want = engine.decode_chunk(5)
    engine.prefill_batch(toks)
    ex = DeviceExecutor(policy="ioctl", wait_mode="suspend")
    got = []

    def body(job, it):
        with ex.device_segment(job):
            got.append(ex.run_sliced(job, engine.decode_segment(5)))

    job = RTJob("decode", body, period_s=10.0, priority=10)
    job.start(ex)
    job.join(60)
    ex.shutdown()
    assert job.error is None and got, "decode job did not complete"
    torch.testing.assert_close(got[0], want, rtol=0, atol=0)
    # one timing sample per token slice + one for finalize
    assert len(job.stats.slice_times) == 6
    assert job.stats.mort is not None


def test_abandoned_decode_segment_leaves_engine_intact(engine):
    """Decode writes the carry's KV cache in place; an abandoned segment
    must not change what the engine decodes next."""
    toks = _prompt(engine.cfg, seed=4)
    engine.prefill_batch(toks)
    want = engine.decode_chunk(4)
    engine.prefill_batch(toks)
    cache_before = [{k: t.clone() for k, t in layer.items()}
                    for layer in engine.cache]
    op = engine.decode_segment(4)
    carry = op.init()
    carry = op.step(carry, 0)
    carry = op.step(carry, 1)
    del carry                                  # abandoned after 2 slices
    for layer, before in zip(engine.cache, cache_before):
        for name in ("k", "v"):
            torch.testing.assert_close(layer[name], before[name],
                                       rtol=0, atol=0)
    torch.testing.assert_close(engine.decode_chunk(4), want, rtol=0, atol=0)


def test_prefill_segment_is_one_slice(engine):
    op = engine.prefill_segment(_prompt(engine.cfg))
    assert isinstance(op, SlicedOp) and op.n_slices == 1
    logits = op.run()
    assert logits.shape == (2, engine.cfg.vocab_size)
    assert engine.last_tok.dtype == torch.int32


def test_profile_phase_on_cpu_measures_no_device_time(engine):
    """The profile of a CPU run reports wall time and no device time: a
    CPU number is never a device metric."""
    toks = _prompt(engine.cfg)
    rec = profile_phase("prefill", lambda: engine.prefill_batch(toks), 2,
                        torch.device("cpu"))
    assert rec["wall_ms"] > 0 and rec["wall_ms_max"] >= rec["wall_ms"]
    assert rec["device_ms"] is None and rec["idle"] is None
    assert rec["kernel_launches"] == {"flash_attention": 0,
                                      "flash_decode": 0}


def test_engine_without_device_needs_a_card(bridged):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    _, tcfg, _, tp = bridged
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(tcfg, params=tp)
