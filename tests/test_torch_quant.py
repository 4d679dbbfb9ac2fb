"""Port vs JAX package: quant plane packing and dequantization.

The same fp32 weights (numpy, from a seed) go through
``repro.core.quant.pack.quantize`` and ``repro_torch.core.quant.pack
.quantize``. Every plane must be equal bit for bit — the kernels of both
packages consume identical bytes — and dequantization must agree exactly
(both do the same f32 multiplies).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.quant import dequant as jdequant  # noqa: E402
from repro.core.quant import pack as jpack  # noqa: E402
from repro_torch.core.quant import dequant as tdequant  # noqa: E402
from repro_torch.core.quant import pack as tpack  # noqa: E402

# One XLA compilation per (shape, format) instead of one per eager op.
_jquantize = jax.jit(jpack.quantize, static_argnums=1)

FORMATS = ["fp16", "q8_0", "q6_k", "q3_k"]
# (N, K): K a multiple of 256, K needing zero-padding to 32/256, and a
# wide row.
SHAPES = [(17, 768), (8, 100), (33, 1280)]


def _bits(a: np.ndarray) -> np.ndarray:
    """Compare floats by bit pattern (exact, NaN-safe)."""
    return a.view(np.uint16) if a.dtype == np.float16 else a


def _weights(shape, seed):
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * 0.1).astype(np.float32)
    w[0, :40] = 0.0                    # an all-zero block: scale 0 path
    w[-1, 3] = 5.0                     # an outlier block
    return w


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape", SHAPES)
def test_planes_bit_exact_and_dequant_equal(fmt, shape):
    w = _weights(shape, seed=shape[0] * 7 + len(fmt))
    jp = _jquantize(jnp.asarray(w), fmt)
    tp = tpack.quantize(torch.from_numpy(w), fmt)
    assert sorted(jp) == sorted(tp)
    for name in jp:
        a, b = np.asarray(jp[name]), tp[name].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jdequant.dequantize(jp, fmt)),
                                  tdequant.dequantize(tp, fmt).numpy())


@pytest.mark.parametrize("nbits", [1, 2, 4])
def test_pack_bits_top_field_and_roundtrip(nbits):
    """The top field of a word reaches bit 31 (the int32 sign bit): the
    port must produce the JAX package's (wrapped) words and unpack them
    with a mask after the arithmetic shift."""
    per = 32 // nbits
    rng = np.random.RandomState(nbits)
    vals = rng.randint(0, 2 ** nbits, size=(5, 4 * per)).astype(np.int32)
    vals[0, :] = 2 ** nbits - 1        # all ones: every word negative
    jw = np.asarray(jpack.pack_bits(jnp.asarray(vals), nbits))
    tw = tpack.pack_bits(torch.from_numpy(vals), nbits)
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(jw, tw.numpy())
    assert (tw[0] < 0).all()
    np.testing.assert_array_equal(tpack.unpack_bits(tw, nbits).numpy(), vals)


def test_cvt53_and_byte_counts_match():
    w = _weights((4, 512), seed=3)
    jp = _jquantize(jnp.asarray(w), "q3_k")
    tp = tpack.quantize(torch.from_numpy(w), "q3_k")
    np.testing.assert_array_equal(
        np.asarray(jpack.cvt53_approx_scales(jp["sc"])),
        tpack.cvt53_approx_scales(tp["sc"]).numpy())
    np.testing.assert_array_equal(
        np.asarray(jdequant.dequantize_q3_k(jp, approx_cvt53=True)),
        tdequant.dequantize_q3_k(tp, approx_cvt53=True).numpy())
    assert tpack.planes_nbytes(tp) == jpack.planes_nbytes(jp)
    for fmt in FORMATS:
        assert tpack.logical_nbytes(33, 1000, fmt) == \
            jpack.logical_nbytes(33, 1000, fmt)
