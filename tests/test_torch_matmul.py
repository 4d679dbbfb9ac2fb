"""Port vs JAX package: the quantized matmul.

The port's ``quantized_matmul`` on CPU tensors (the plain version the
CUDA kernel is held against on the card) against the JAX package's
Pallas kernels in interpret mode, at ``tests/test_kernels.py``'s shapes,
with that file's tolerance: rtol/atol 2e-5 (same products, another
summation order). The planes are the JAX package's, carried over through
numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.quant import pack as jpack  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import matmul_ref  # noqa: E402

# One XLA compilation per (shape, format) instead of one per eager op.
_jquantize = jax.jit(jpack.quantize, static_argnums=1)

SHAPES = [(4, 512, 16), (17, 768, 33), (1, 256, 128), (3, 1280, 7)]
TOL = dict(rtol=2e-5, atol=2e-5)


def _case(m, k, n, fmt, seed=0):
    rng = np.random.RandomState(seed + m + n)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(n, k) * 0.1).astype(np.float32)
    jp = _jquantize(jnp.asarray(w), fmt)
    tp = {name: torch.from_numpy(np.array(np.asarray(v)))
          for name, v in jp.items()}
    return x, jp, tp


@pytest.mark.parametrize("fmt", ["fp16", "q8_0", "q6_k", "q3_k"])
@pytest.mark.parametrize("mkn", SHAPES)
def test_plain_matmul_matches_pallas(fmt, mkn):
    m, k, n = mkn
    x, jp, tp = _case(m, k, n, fmt)
    y_j = jops.quantized_matmul(jnp.asarray(x), jp, fmt, impl="pallas",
                                interpret=True)
    y_t = tops.quantized_matmul(torch.from_numpy(x), tp, fmt)
    assert y_t.dtype == torch.float32 and tuple(y_t.shape) == (m, n)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


def test_k_padding_leading_dims_and_out_dtype():
    """K below the packed width is zero-padded (ops.py:35-44), leading
    dims are flattened to M, and ``out_dtype`` casts like
    ``layers.linear_apply`` (bf16 activations in, bf16 out)."""
    rng = np.random.RandomState(5)
    w = (rng.randn(24, 200) * 0.1).astype(np.float32)
    x = rng.randn(2, 3, 200).astype(np.float32)
    jp = _jquantize(jnp.asarray(w), "q6_k")          # K padded to 256
    tp = {n: torch.from_numpy(np.array(np.asarray(v))) for n, v in jp.items()}
    y_j = jops.quantized_matmul(jnp.asarray(x), jp, "q6_k", impl="ref")
    y_t = tops.quantized_matmul(torch.from_numpy(x), tp, "q6_k")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    yb = tops.quantized_matmul(xb, tp, "q6_k", out_dtype=torch.bfloat16)
    assert yb.dtype == torch.bfloat16 and tuple(yb.shape) == (2, 3, 24)


def test_bf16_activations_match_jax_ref():
    """bf16 activations (the serving dtype): both sides upcast x exactly
    to f32, so the repo's 2e-5 tolerance still holds."""
    x, jp, tp = _case(8, 512, 32, "q8_0", seed=9)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    y_j = jops.quantized_matmul(xb, jp, "q8_0", impl="pallas", interpret=True)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    y_t = tops.quantized_matmul(xt, tp, "q8_0")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)


@pytest.mark.parametrize("fmt", ["fp16", "q8_0", "q6_k", "q3_k"])
def test_unported_formats_raise_off_cpu(fmt):
    """Every format's wrapper, reached through ``quantized_matmul``,
    refuses a device that is neither the CPU (plain version) nor CUDA
    (its kernel) instead of dropping to the plain version."""
    _, _, tp = _case(2, 256, 8, fmt)
    x = torch.empty((2, 256), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tops.quantized_matmul(x, {n: v.to("meta") for n, v in tp.items()},
                              fmt)


def _wrapper_checks(fmt):
    """Shape, dtype and device checks of one wrapper; on the CPU it is the
    plain version, its bf16 output is the f32 output rounded once, and no
    launch is counted."""
    wrapper, layout = tops.MATMUL_KERNELS[fmt]
    _, _, tp = _case(2, 256, 8, fmt)
    planes = [tp[n] for n in layout]
    x = torch.zeros((2, 256))
    x[0, :3] = torch.tensor([1.0, -2.0, 0.5])
    with pytest.raises(ValueError):
        wrapper(torch.zeros((2, 96)), *planes)             # K mismatch
    with pytest.raises(TypeError):
        wrapper(x.to(torch.float16), *planes)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(x.to("meta"), *[p.to("meta") for p in planes])
    with pytest.raises(TypeError):
        wrapper(x, *planes, out_dtype=torch.float16)
    before = wrapper.launches
    y = wrapper(x, *planes)                                # CPU: plain version
    y16 = wrapper(x, *planes, out_dtype=torch.bfloat16)
    assert wrapper.launches == before
    assert torch.equal(y, matmul_ref(x, tp, fmt))
    assert torch.equal(y16, y.to(torch.bfloat16))


def test_q8_0_wrapper_checks():
    _wrapper_checks("q8_0")


@pytest.mark.parametrize("fmt", ["fp16", "q6_k", "q3_k"])
def test_wrapper_checks(fmt):
    _wrapper_checks(fmt)
