"""Whether what the timed path served is right: the reference's verdict
on a sample of the finished requests.

Every request is greedy, so each served token should be the reference's
best token at its position, up to rounding. The reference runs each
sampled prompt with the tokens served after it, whole, in float32 over
weights it quantized itself, and the number compared is the widest gap
by which a served token's reference logit lies below the reference's
best logit there (``logit_gap``).

The reference's control (``control_fmt``, the calibration tool only) is
the reference put in the program's place in the format below the served
one: at each position of the same sequences, the gap of the token that
the control puts first (``control_logit_gap``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Sample:
    rid: int
    prompt: np.ndarray
    served: List[int]


# The sample: at least SAMPLE_LEAST requests, then more until
# SAMPLE_TOKENS served tokens or SAMPLE_MOST requests (some hundreds of
# served tokens, with the reference shorter than the window).
SAMPLE_LEAST, SAMPLE_MOST, SAMPLE_TOKENS = 3, 4, 400


def pick(sequences, window: Tuple[float, float],
         seed: int) -> List[Sample]:
    """The longest finished request, then requests due in the window in
    an order drawn from the seed, as many as ``SAMPLE_*`` say."""
    done = [s for s in sequences if s.t_done is not None]
    if not done:
        return []
    longest = max(done, key=lambda s: (s.req.prompt_len + len(s.generated),
                                       -s.rid))
    pool = [s for s in done if s is not longest
            and window[0] <= s.req.arrival_s < window[1]]
    rng = np.random.default_rng([int(seed), 3])
    order = rng.permutation(len(pool)) if pool else []
    chosen = [longest]
    for i in order:
        if len(chosen) >= SAMPLE_MOST or len(chosen) >= SAMPLE_LEAST \
                and sum(len(s.generated) for s in chosen) >= SAMPLE_TOKENS:
            break
        chosen.append(pool[i])
    return [Sample(s.rid, np.asarray(s.req.tokens), list(s.generated))
            for s in chosen]


def compare(ref_module, hf: Dict, W, samples: List[Sample], device,
            fmt: str = "q8_0",
            control_fmt: Optional[str] = None) -> Dict[str, float]:
    """Run the reference over the samples; return the numbers compared
    (and, with ``control_fmt``, the control's gap)."""
    seqs, rows = [], []
    for s in samples:
        toks = np.concatenate([s.prompt, np.asarray(s.served[:-1],
                                                    np.int64)])
        seqs.append(torch.as_tensor(toks, dtype=torch.long, device=device))
        rows.append(len(s.prompt) - 1)
    served = [torch.as_tensor(s.served, dtype=torch.long, device=device)
              for s in samples]

    control_pick = None
    if control_fmt is not None:
        control_pick = [torch.empty_like(t) for t in served]

        def take(j, r0, lg):
            lo, hi = max(r0, rows[j]), min(r0 + lg.shape[0],
                                           rows[j] + len(served[j]))
            if lo < hi:
                control_pick[j][lo - rows[j]:hi - rows[j]] = \
                    lg[lo - r0:hi - r0].argmax(-1)
        ref_module.forward(hf, W, seqs, control_fmt, take)

    gap = torch.zeros((), dtype=torch.float64)
    cgap = torch.zeros((), dtype=torch.float64)

    def judge(j, r0, lg):
        nonlocal gap, cgap
        lo, hi = max(r0, rows[j]), min(r0 + lg.shape[0],
                                       rows[j] + len(served[j]))
        if lo >= hi:
            return
        block = lg[lo - r0:hi - r0]
        best = block.max(-1).values
        mine = served[j][lo - rows[j]:hi - rows[j]]
        got = block.gather(1, mine[:, None])[:, 0]
        gap = torch.maximum(gap, (best - got).max().double().cpu())
        if control_pick is not None:
            other = control_pick[j][lo - rows[j]:hi - rows[j]]
            c = block.gather(1, other[:, None])[:, 0]
            cgap = torch.maximum(cgap, (best - c).max().double().cpu())
    ref_module.forward(hf, W, seqs, fmt, judge)
    out = {"logit_gap": float(gap)}
    if control_fmt is not None:
        out["control_logit_gap"] = float(cgap)
    return out
