"""Module-level model flags, copied from ``repro.models.flags``.

``unroll_inner``: in the JAX package, inner scans (the chunked-attention
KV loop, the SSD inter-chunk recurrence) unroll at trace time under it,
so XLA's cost analysis counts every trip. The port's loops are eager
Python loops that every count already sees trip by trip, so
``inner_unroll`` changes no result here; it is kept so that call sites
read as the JAX package's do (``analysis/extrapolate.py`` sets it).

``mixed_intermediates``: the plain attention and SSD paths contract
their inner tensors (scores, probabilities, the SSD decay products) as
bf16 operands with f32 accumulation, as the JAX package does under the
flag. It is read by the plain PyTorch paths only: the card's kernels
(B7 flash attention, B1/B8 paged GQA, B9 paged MLA) fix their own
operand precision and do not read it. Default False (f32), so every
differential test stays tight.
"""
from __future__ import annotations

import contextlib
import contextvars

_UNROLL_INNER = contextvars.ContextVar("unroll_inner", default=False)


def inner_unroll():
    """The JAX package's ``lax.scan(..., unroll=)`` value (True under
    ``unroll_inner_scans``, else 1)."""
    return True if _UNROLL_INNER.get() else 1


@contextlib.contextmanager
def unroll_inner_scans(enabled: bool = True):
    tok = _UNROLL_INNER.set(enabled)
    try:
        yield
    finally:
        _UNROLL_INNER.reset(tok)


_MIXED = contextvars.ContextVar("mixed_intermediates", default=False)


def mixed_intermediates() -> bool:
    """When True, attention/SSD inner tensors are bf16 (f32 accumulation)
    — halves the memory-roofline term of the score/probability traffic.
    Default False (f32)."""
    return _MIXED.get()


@contextlib.contextmanager
def use_mixed_intermediates(enabled: bool = True):
    tok = _MIXED.set(enabled)
    try:
        yield
    finally:
        _MIXED.reset(tok)
