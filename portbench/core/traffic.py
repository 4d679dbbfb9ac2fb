"""The one traffic generator: a mix's parameter file and the cell's rate
make an open-loop request stream from a seed.

A mix (``portbench/traffic/<mix>.json``) gives the prompt and output
length distributions (lognormal: median, sigma, clipped to [min, max]),
an optional shared document that opens every prompt (``doc_tokens``) and
the warm-up requests that set-up serves. The cell
(``portbench/cells/<workload>.json``) gives the arrival rate in
requests/s and the ramp-up before the window.

Every seed gets the same set of lengths and inter-arrival gaps, in its
own order: the lengths are the distribution's quantiles at (i + 0.5)/n,
the gaps the exponential's quantiles at the same points (a Poisson
process of the cell's rate), each list permuted by the seed, and the
ramp-up and the window each have a set of their own. So the work of a
run, and of its window, is fixed by the cell; the seed only orders it
and draws the token ids. The seed may be any non-negative integer.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Spec:
    """One request as the generator makes it."""

    rid: int
    tokens: np.ndarray           # int32 prompt
    max_new_tokens: int
    arrival_s: float


def quantile_lengths(dist: Dict, n: int) -> np.ndarray:
    """The n stratified quantiles of a clipped lognormal, as ints."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    raw = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(raw), dist["min"], dist["max"]).astype(np.int64)


def quantile_gaps(rate: float, n: int) -> np.ndarray:
    """The n stratified quantiles of an exponential of mean 1/rate."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def max_len(mix: Dict) -> int:
    """The longest prompt plus output any request of the mix can have."""
    return mix.get("doc_tokens", 0) + mix["prompt"]["max"] \
        + mix["output"]["max"]


def document(mix: Dict, seed: int, vocab: int) -> Optional[np.ndarray]:
    """The shared document of the mix (None without one)."""
    n = mix.get("doc_tokens", 0)
    if not n:
        return None
    rng = np.random.default_rng([int(seed), 1])
    return rng.integers(0, vocab, n, dtype=np.int64).astype(np.int32)


def _phase(mix: Dict, rate: float, t0: float, span: float,
           rng) -> List[tuple]:
    """(prompt length, output length, arrival) of the requests due in
    [t0, t0 + span): round(rate * span) of them, their lengths the
    stratified quantiles and their gaps the exponential's, each in an
    order drawn from ``rng``, the gaps scaled so that the phase ends with
    its last arrival."""
    n = int(round(rate * span))
    if n <= 0:
        return []
    plen = rng.permutation(quantile_lengths(mix["prompt"], n))
    olen = rng.permutation(quantile_lengths(mix["output"], n))
    gaps = rng.permutation(quantile_gaps(rate, n))
    arrivals = t0 + np.cumsum(gaps) * (span / gaps.sum())
    return list(zip(plen.tolist(), olen.tolist(), arrivals.tolist()))


def stream(mix: Dict, cell: Dict, seed: int, seconds: float,
           vocab: int) -> List[Spec]:
    """The measured stream: the ramp-up's arrivals, then the window's,
    each phase with its own fixed set of lengths and gaps, so that the
    requests due in the window are the same work for every seed."""
    rng = np.random.default_rng([int(seed), 0])
    ramp, rate = float(cell["ramp_s"]), float(cell["rate_rps"])
    plan = _phase(mix, rate, 0.0, ramp, rng) \
        + _phase(mix, rate, ramp, float(seconds), rng)
    doc = document(mix, seed, vocab)
    out = []
    for i, (p, o, t) in enumerate(plan):
        toks = rng.integers(0, vocab, int(p), dtype=np.int64)
        if doc is not None:
            toks = np.concatenate([doc, toks])
        out.append(Spec(i, toks.astype(np.int32), int(o), float(t)))
    return out


def warmup(mix: Dict, seed: int, vocab: int, slots: int,
           chunk: int) -> List[Spec]:
    """Set-up's requests, all due at once: one per slot with a prompt of
    two full chunks and a partial one and a few outputs, so that full
    and partial prefill chunks, decode and mixed steps all run; with a
    document, one more request that opens with it, so that its pages are
    published to the prefix cache before the window."""
    rng = np.random.default_rng([int(seed), 2])
    plen = 2 * chunk + max(1, chunk // 2)
    out = [Spec(-1 - i, rng.integers(0, vocab, plen, dtype=np.int64)
                .astype(np.int32), 4, 0.0) for i in range(slots)]
    doc = document(mix, seed, vocab)
    if doc is not None:
        q = rng.integers(0, vocab, chunk, dtype=np.int64).astype(np.int32)
        out.append(Spec(-1 - slots, np.concatenate([doc, q]), 2, 0.0))
    return out
