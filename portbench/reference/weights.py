"""Seed-made weights, shared by the program and the reference.

A model's tensors are listed as ``Leaf`` entries, each in a named group.
A group is one ``torch.randn`` call in bf16 on the device, from a
``torch.Generator`` seeded by (run seed, group name); its leaves are
views of that buffer, scaled in place. So the whole model comes from a
few large calls, and any group can be made again on its own, bit for
bit, which lets the reference rebuild the weights a group at a time
after the program's state is freed.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One tensor: ``std`` scales a normal draw; ``norm`` makes a gain of
    1 + std * N(0, 1)."""

    name: str
    shape: Tuple[int, ...]
    group: str
    std: float
    norm: bool = False

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def group_seed(seed: int, group: str) -> int:
    """A 63-bit generator seed for (run seed, group name)."""
    h = hashlib.sha256(f"{int(seed)}:{group}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def groups(leaves: Iterable[Leaf]) -> Dict[str, List[Leaf]]:
    """Leaves by group, in first-seen order."""
    out: Dict[str, List[Leaf]] = {}
    for lf in leaves:
        out.setdefault(lf.group, []).append(lf)
    return out


def make_group(members: List[Leaf], group: str, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """The group's leaves, bf16 views of one buffer drawn in one call."""
    total = sum(lf.numel for lf in members)
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    buf = torch.randn((total,), generator=gen, dtype=torch.bfloat16,
                      device=device)
    out, off = {}, 0
    for lf in members:
        view = buf[off:off + lf.numel].view(lf.shape)
        off += lf.numel
        view.mul_(lf.std)
        if lf.norm:
            view.add_(1.0)
        out[lf.name] = view
    return out


def make_all(leaves: List[Leaf], seed: int,
             device) -> Dict[str, torch.Tensor]:
    """Every leaf, group by group."""
    out: Dict[str, torch.Tensor] = {}
    for g, members in groups(leaves).items():
        out.update(make_group(members, g, seed, device))
    return out


class WeightSource:
    """The reference's access to the seed-made weights: a leaf's group is
    drawn again when first asked for, and only the latest group is kept."""

    def __init__(self, leaves: List[Leaf], seed: int, device):
        self.by_name = {lf.name: lf for lf in leaves}
        self.members = groups(leaves)
        self.seed, self.device = seed, device
        self._group: Optional[str] = None
        self._tensors: Dict[str, torch.Tensor] = {}

    def __call__(self, name: str) -> torch.Tensor:
        g = self.by_name[name].group
        if g != self._group:
            self._tensors = {}
            self._tensors = make_group(self.members[g], g, self.seed,
                                       self.device)
            self._group = g
        return self._tensors[name]

    def release(self) -> None:
        self._tensors, self._group = {}, None
