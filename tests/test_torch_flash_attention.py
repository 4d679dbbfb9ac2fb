"""Port vs JAX package: full-sequence attention (the flash kernel's
function) on the CPU.

* The port's ``attention_ref`` (the plain version its CUDA kernel is
  held against on the card, in the model's (B, S, H, D) layout) against
  the JAX package's Pallas ``flash_attention`` in interpret mode, at
  ``tests/test_kernels.py``'s shapes: GQA, a ragged sequence (the
  padding path) and D = 128.
* The port's ``chunked_attention`` against the JAX package's, with a
  ragged Skv, ``q_offset > 0`` and non-causal.
* The mask itself: keys past the causal horizon, a row that sees no
  key, and the wrapper's shape checks.

Tolerance: rtol/atol 1e-4 in f32, ``tests/test_kernels.py``'s bound for
the blocked online softmax against one dense softmax (the same math in
another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402,E501
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import attention_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(seed, b, sq, skv, h, hkv, d, dv=None):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, sq, h, d) * 0.3).astype(np.float32)
    k = (rng.randn(b, skv, hkv, d) * 0.3).astype(np.float32)
    v = rng.randn(b, skv, hkv, dv or d).astype(np.float32)
    return q, k, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,h,hkv,s,d,causal", [
    (1, 4, 2, 256, 64, True),
    (2, 8, 8, 128, 32, False),
    (1, 2, 1, 300, 64, True),      # non-multiple seq (padding path)
    (1, 6, 2, 128, 128, True),
])
def test_attention_ref_matches_jax_flash(b, h, hkv, s, d, causal):
    q, k, v = _qkv(s + d, b, s, s, h, hkv, d)
    tr = lambda a: jnp.asarray(np.transpose(a, (0, 2, 1, 3)))  # noqa: E731
    want = np.transpose(np.asarray(jax_flash(
        tr(q), tr(k), tr(v), causal=causal, block_q=128, block_k=128,
        interpret=True)), (0, 2, 1, 3))
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The wrapper on a CPU tensor is the plain version.
    np.testing.assert_array_equal(
        flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy(),
        got.numpy())


@pytest.mark.parametrize("sq,skv,q_offset,causal", [
    (256, 256, 0, True),          # test_kernels' chunked-vs-flash shape
    (16, 77, 61, True),           # ragged Skv, a chunk at the end
    (40, 100, 7, True),           # q_offset > 0, keys past the last query
    (33, 70, 0, False),           # non-causal, ragged both ways
])
def test_chunked_attention_matches_jax(sq, skv, q_offset, causal):
    b, h, hkv, d = 2, 4, 2, 32
    q, k, v = _qkv(sq * skv, b, sq, skv, h, hkv, d)
    want = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=d ** -0.5, q_offset=q_offset, kv_chunk=64))
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                  sm_scale=d ** -0.5, q_offset=q_offset)
    assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_separate_value_width_matches_jax():
    """Dv != D (MLA prefill's shape): the JAX chunked attention takes it,
    and so does the port."""
    q, k, v = _qkv(5, 1, 24, 24, 4, 4, 48, dv=32)
    want = np.asarray(jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        sm_scale=0.2, kv_chunk=16))
    got = flash_attention(_t(q), _t(k), _t(v), causal=True, sm_scale=0.2)
    assert got.shape == (1, 24, 4, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_keys_past_the_causal_horizon_do_not_count():
    """Causal with q_offset: keys past the last query's position are
    masked, whatever they hold; the result equals attention over the
    K/V cut at the horizon."""
    q, k, v = _qkv(9, 2, 12, 40, 4, 2, 16)
    k[:, 29:] = 1e4
    v[:, 29:] = -1e4
    got = attention_ref(_t(q), _t(k), _t(v), causal=True, q_offset=17)
    want = attention_ref(_t(q), _t(k[:, :29]), _t(v[:, :29]), causal=True,
                         q_offset=17)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_row_that_sees_no_key_is_zero():
    """q_offset < 0 leaves the first queries without a visible key: their
    rows are 0 (l == 0 reads as 1), the others are attention as usual."""
    q, k, v = _qkv(11, 1, 8, 8, 2, 1, 16)
    got = attention_ref(_t(q), _t(k), _t(v), causal=True, q_offset=-3)
    assert not got[:, :3].any()
    want = attention_ref(_t(q[:, 3:]), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got[:, 3:].numpy(), want.numpy(), **TOL)


def test_bf16_inputs_round_the_f32_result_once():
    q, k, v = _qkv(13, 1, 20, 20, 4, 2, 32)
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    want = attention_ref(qb.float(), kb.float(), vb.float())
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("shapes,match", [
    (((1, 4, 4, 8), (1, 4, 3, 8), (1, 4, 3, 8)), "multiple"),
    (((1, 4, 4, 8), (1, 4, 2, 16), (1, 4, 2, 8)), "k must be"),
    (((1, 4, 4, 8), (1, 5, 2, 8), (1, 4, 2, 8)), "k must be"),
    (((4, 4, 8), (1, 4, 2, 8), (1, 4, 2, 8)), "expected"),
])
def test_wrapper_checks_shapes(shapes, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v)
