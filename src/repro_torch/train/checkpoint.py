"""Checkpoint save/restore (fault tolerance substrate); ported from
``repro.train.checkpoint``.

One file per step, ``ckpt_{step:08d}.pt``: ``torch.save`` of a dict of
plain values and flat {path: CPU tensor} dicts (``optimizer.flatten``'s
paths), read back with ``torch.load(weights_only=True)``, so no pickle
of arbitrary objects and no ``msgpack`` (the JAX package's container).
Every dtype round-trips bit for bit, bf16 included. Writes go to a
temporary file that ``os.replace`` moves into place (a crashed writer
never corrupts the latest checkpoint); an optional async writer thread,
keep-N pruning, and a ``restore_or_init`` entry the trainer calls on
every start, so a restarted job resumes from the last step. A restore
places each leaf on the device of the tree it is given: the same
artifact restores onto the CPU or the card.
"""
from __future__ import annotations

import os
import pathlib
import threading
import time
from typing import Dict, Optional

import torch

from repro_torch.train import optimizer as opt

_PATTERN = "ckpt_*.pt"


def _flat_host(tree) -> Dict[str, torch.Tensor]:
    """{path: the leaf on the CPU} (a leaf already there is not
    copied)."""
    return {k: v.detach().cpu() for k, v in opt.flatten(tree).items()}


def save(path: str, step: int, params, opt_state,
         extra: Optional[Dict] = None) -> str:
    """Atomic checkpoint write. Returns the final path."""
    ckpt_dir = pathlib.Path(path)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    payload = {
        "step": int(step),
        "params": _flat_host(params),
        "opt": _flat_host(opt_state),
        "extra": dict(extra or {}),
        "time": time.time(),
    }
    final = ckpt_dir / f"ckpt_{step:08d}.pt"
    tmp = ckpt_dir / f".tmp_{step:08d}_{os.getpid()}"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)          # atomic on POSIX
    return str(final)


class AsyncWriter:
    """Fire-and-forget checkpoint writes on a daemon thread; ``wait()``
    joins outstanding writes (the trainer calls it before exit)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self.last_path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def submit(self, path, step, params, opt_state, extra=None):
        # The device-to-host copy happens here, in the caller, so the
        # thread never reads device tensors a later step replaces.
        copy = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
        params = opt.tree_map(copy, params)
        opt_state = opt.tree_map(copy, opt_state)
        self.wait()

        def work():
            try:
                self.last_path = save(path, step, params, opt_state, extra)
            except BaseException as e:     # surfaced on the next wait()
                self.error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err


def latest_checkpoint(path: str) -> Optional[str]:
    d = pathlib.Path(path)
    if not d.exists():
        return None
    cands = sorted(d.glob(_PATTERN))
    return str(cands[-1]) if cands else None


def prune(path: str, keep: int) -> None:
    d = pathlib.Path(path)
    cands = sorted(d.glob(_PATTERN))
    for old in cands[:-keep] if keep > 0 else []:
        old.unlink(missing_ok=True)


def restore(path: str, params_like, opt_like):
    """Restore (step, params, opt_state, extra) from a checkpoint file.
    ``params_like``/``opt_like``: trees defining the structure; each leaf
    goes to the device of its ``*_like`` leaf, with the dtype it was
    saved in."""
    payload = torch.load(path, map_location="cpu", weights_only=True)

    def rebuild(tree, packed):
        flat = opt.flatten(tree)
        missing = sorted(set(flat) - set(packed))
        if missing:
            raise KeyError(f"{path}: no leaves {missing[:4]}")
        out = {}
        for k, leaf in flat.items():
            arr = packed[k]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(arr.shape)} vs {tuple(leaf.shape)}")
            out[k] = arr.to(leaf.device)
        it = iter(out[k] for k in flat)
        return opt.tree_map(lambda _: next(it), tree)

    params = rebuild(params_like, payload["params"])
    opt_state = rebuild(opt_like, payload["opt"])
    return payload["step"], params, opt_state, payload.get("extra", {})


def restore_or_init(path: str, init_fn):
    """Fault-tolerant entry: resume from the newest checkpoint if present,
    otherwise initialize fresh. ``init_fn() -> (step, params,
    opt_state)``; returns (step, params, opt_state, extra)."""
    latest = latest_checkpoint(path)
    if latest is None:
        return init_fn() + ({},)
    step0, params0, opt0 = init_fn()
    return restore(latest, params0, opt0)
