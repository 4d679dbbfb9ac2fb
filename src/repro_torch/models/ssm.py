"""Mamba2 (SSD, state-space duality) mixer, ported from
``repro.models.ssm``.

Prefill (``ssm_apply``): the chunked SSD algorithm, an intra-chunk
quadratic term plus the inter-chunk state recurrence over chunks, in f32
(the JAX package's default precision; it has no Pallas kernel here, it
leaves the whole mixer to XLA, so the port's is plain PyTorch too).
Decode (``ssm_decode``): the recurrence over the carried (B, H, N, P)
state, one token at a time through a chunk of C tokens.

Per the paper's partitioning the in/out projections are the offloadable
dot products (``layers.linear_apply``, the quantized matmul kernels on
the card); the scan is host-side control flow.

State cache: ``{"conv": (B, K-1, conv_dim), "ssm": (B, H, N, P)}`` —
the conv window in the activation dtype (bf16), the SSM state in f32.
``ssm_decode`` writes both in place, as the attention mixers write their
pages.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import flags, layers
from repro_torch.models.layers import Params
from repro_torch.parallel import sharding


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    return s, d, di, nh, conv_dim


def ssm_init(gen: torch.Generator, cfg: ModelConfig, fmt: str = "none"):
    """Random mixer parameters on ``gen.device``: the JAX package's leaves
    and init scales (A = -exp(A_log) = -1, D = 1, zero dt bias)."""
    s, d, di, nh, conv_dim = _dims(cfg)
    dev = gen.device
    # in_proj emits [z (di), x (di), B (g*n), C (g*n), dt (nh)]
    zxbcdt = 2 * di + 2 * s.n_groups * s.d_state + nh
    return {
        "in_proj": layers.linear_init(gen, d, zxbcdt, fmt),
        "conv_w": torch.randn((s.conv_kernel, conv_dim), generator=gen,
                              device=dev, dtype=torch.float32) * 0.2,
        "conv_b": torch.zeros((conv_dim,), dtype=torch.float32, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm": layers.rmsnorm_init(di, dev),
        "out_proj": layers.linear_init(gen, di, d, fmt),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """(z, x, B, C, dt) along the last axis of the in_proj output."""
    s, d, di, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [di, di, gn, gn, nh], dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (no threshold, unlike ``F.softplus``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _conv_taps(padded: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               length: int, dtype) -> torch.Tensor:
    """silu(sum_i padded[:, i:i+length] * w[i] + b) in f32, summed for
    i = 0..K-1 from zero as the JAX package sums it, cast to ``dtype``."""
    out = torch.zeros((padded.shape[0], length, padded.shape[2]),
                      dtype=torch.float32, device=padded.device)
    for i in range(w.shape[0]):
        out = out + padded[:, i:i + length].to(torch.float32) * w[i]
    return F.silu(out + b).to(dtype)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over (B, L, C); kernel (K, C). Returns
    (out, new_state): the state carries the last K-1 inputs."""
    k = w.shape[0]
    bsz, l, c = xbc.shape
    if state is None:
        state = torch.zeros((bsz, k - 1, c), dtype=xbc.dtype,
                            device=xbc.device)
    dt = torch.promote_types(state.dtype, xbc.dtype)
    padded = torch.cat([state.to(dt), xbc.to(dt)], dim=1)   # (B, K-1+L, C)
    new_state = padded[:, -(k - 1):] if k > 1 else state
    return _conv_taps(padded, w, b, l, xbc.dtype), new_state


def _heads(t: torch.Tensor, groups: int, n: int, rep: int) -> torch.Tensor:
    """(..., G*N) -> (..., H, N): group g serves heads g*rep..(g+1)*rep-1
    (``jnp.repeat`` over the group axis)."""
    t = t.reshape(*t.shape[:-1], groups, n)
    return t.repeat_interleave(rep, dim=-2)


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and held in f32 (an exact bf16 operand)."""
    return t.to(torch.bfloat16).to(t.dtype)


def _ssd_sharded(x, dt, a, bmat, cmat, chunk: int):
    """``ssd_chunked`` on a training mesh (DTensor x): each rank runs its
    own (batch, head) block, B and C first repeated over each group's
    heads so that they cut as x does (the same products)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    x = sharding.evenly(x)
    h, g = x.shape[2], bmat.shape[2]
    bmat, cmat = (m[:, :, :, None].expand(*m.shape[:3], h // g, m.shape[-1])
                  .reshape(*m.shape[:2], h, m.shape[-1])
                  for m in (bmat, cmat))
    xp = list(x.placements)
    heads = [Shard(0) if isinstance(p, Shard) and p.dim == 2 else
             Replicate() for p in xp]
    state = [Shard(1) if isinstance(p, Shard) and p.dim == 2 else p
             for p in xp]
    return local_map(
        lambda x, dt, a, bm, cm: ssd_chunked(x, dt, a, bm, cm, chunk),
        out_placements=(xp, state),
        in_placements=(xp, xp, heads, xp, xp),
        redistribute_inputs=True)(x, dt, a, bmat, cmat)


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int):
    """SSD forward in f32. x: (B, L, H, P); dt: (B, L, H); a: (H,)
    (negative); bmat/cmat: (B, L, G, N) broadcast to heads. Returns
    (y (B, L, H, P) f32, final state (B, H, N, P) f32). Under
    ``flags.mixed_intermediates()`` the products take bf16 operands (f32
    accumulation), as the JAX package's."""
    if sharding.is_dtensor(x):
        return _ssd_sharded(x, dt, a, bmat, cmat, chunk)
    b, l, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    assert h % g == 0
    rep = h // g
    bmat = bmat.repeat_interleave(rep, dim=2)               # (B, L, H, N)
    cmat = cmat.repeat_interleave(rep, dim=2)
    nc = -(-l // chunk)
    pad = nc * chunk - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    f32 = torch.float32
    # flags.mixed_intermediates(): the products' operands rounded to bf16
    # where the JAX package casts them (f32 accumulation either way).
    lo = _bf16_round if flags.mixed_intermediates() else (lambda t: t)
    xc = lo(x.reshape(b, nc, chunk, h, p).to(f32))
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    bc = lo(bmat.reshape(b, nc, chunk, h, n).to(f32))
    cc = lo(cmat.reshape(b, nc, chunk, h, n).to(f32))

    cum = torch.cumsum(dtc * a, dim=2)                      # (B, C, c, H)
    # Intra-chunk quadratic term: decay(i, j) = exp(cum_i - cum_j), i >= j.
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,C,i,j,H)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    decay = lo(torch.where(causal, torch.exp(seg), torch.zeros_like(seg)))
    scores = lo(lo(torch.einsum("bcihn,bcjhn->bcijh", cc, bc)) * decay)
    y = torch.einsum("bcijh,bcjhp->bcihp",
                     scores * lo(dtc)[:, :, None, :, :], xc)

    # Chunk-final states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T.
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)       # (B,C,c,H)
    states = torch.einsum("bcjhn,bcjhp->bchnp",
                          bc * lo(decay_states * dtc)[..., None], xc)

    # Inter-chunk recurrence over chunks: the state entering each chunk.
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (B, C, H)
    s = torch.zeros((b, h, n, p), dtype=f32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                   # (B,C,H,N,P)

    # Contribution of the incoming state to each position.
    y_state = torch.einsum("bcihn,bchnp->bcihp",
                           cc * lo(torch.exp(cum))[..., None], lo(s_prevs))
    y = (y + y_state).reshape(b, nc * chunk, h, p)[:, :l]
    return y, s


def _gated_out(p: Params, cfg: ModelConfig, y: torch.Tensor,
               z: torch.Tensor, fmt: str) -> torch.Tensor:
    """Gated RMSNorm (y * silu(z)) then the out projection."""
    y = layers.rmsnorm_apply(p["norm"], y * F.silu(
        z.to(torch.float32)).to(y.dtype), cfg.norm_eps)
    return layers.linear_apply(p["out_proj"], y, fmt)


def ssm_apply(p: Params, cfg: ModelConfig, u: torch.Tensor, *,
              fmt: str = "none", return_state: bool = False):
    """Full-sequence mamba2 block. u: (B, L, d). With ``return_state``
    returns (out, {"conv", "ssm"}) — the state after the last token."""
    s, d, di, nh, _ = _dims(cfg)
    zxbcdt = layers.linear_apply(p["in_proj"], u, fmt)
    z, x, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([x, bmat, cmat], dim=-1)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    gn = s.n_groups * s.d_state
    x, bmat, cmat = torch.split(xbc, [di, gn, gn], dim=-1)

    bsz, l, _ = u.shape
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xh = x.reshape(bsz, l, nh, s.head_dim)
    bm = bmat.reshape(bsz, l, s.n_groups, s.d_state)
    cm = cmat.reshape(bsz, l, s.n_groups, s.d_state)
    y, state = ssd_chunked(xh, dt, a, bm, cm, s.chunk_size)
    y = y + xh.to(torch.float32) * p["D"][:, None]
    y = y.reshape(bsz, l, di).to(u.dtype)
    out = _gated_out(p, cfg, y, z, fmt)
    if return_state:
        return out, {"conv": conv_state, "ssm": state}
    return out


def ssm_decode(p: Params, cfg: ModelConfig, u: torch.Tensor, cache: Dict, *,
               fmt: str = "none", lengths: Optional[torch.Tensor] = None):
    """Recurrent step over a chunk of C tokens (C == 1: the one-token
    step). u: (B, C, d); cache {"conv", "ssm"}: the slots' state, written
    in place. The in/out projections run over the whole chunk; the
    recurrence is ``_recur``. ``lengths``: (B,) valid entries per row —
    a row's state advances only through its valid prefix, and its tail
    outputs are garbage the engine never reads. Returns (out, cache)."""
    zxbcdt = layers.linear_apply(p["in_proj"], u, fmt)
    z, y = _recur(p, cfg, zxbcdt, cache, lengths)
    return _gated_out(p, cfg, y.to(u.dtype), z, fmt), cache


def _recur(p: Params, cfg: ModelConfig, zxbcdt: torch.Tensor, cache: Dict,
           lengths: Optional[torch.Tensor]):
    """The chunk's recurrence from its in_proj rows (B, C, ...): returns
    (z, y (B, C, di) f32) and leaves the state after each row's last
    valid token in ``cache``. The splits, softplus(dt + dt_bias) and the
    conv taps run over the whole chunk (none reads the carried SSM
    state); the SSM recurrence then steps token by token, in the order of
    the JAX package's ``lax.scan``. Tail padding leaves the conv window
    and the SSM state bit-unchanged."""
    s, d, di, nh, conv_dim = _dims(cfg)
    bsz, cw, _ = zxbcdt.shape
    dev = zxbcdt.device
    f32 = torch.float32
    z, x, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
    xbc_seq = torch.cat([x, bmat, cmat], dim=-1)            # (B, C, conv_dim)
    kconv = p["conv_w"].shape[0]
    # The conv window of token t is [state, xbc_0..xbc_t][t : t + K]: for
    # a valid token (padding is tail-only) that is the JAX carry's window.
    padded = torch.cat([cache["conv"].to(xbc_seq.dtype), xbc_seq], dim=1)
    conv_out = _conv_taps(padded, p["conv_w"], p["conv_b"], cw,
                          xbc_seq.dtype)
    gn = s.n_groups * s.d_state
    x_all, b_all, c_all = torch.split(conv_out, [di, gn, gn], dim=-1)
    dtp_all = _softplus(dt.to(f32) + p["dt_bias"])          # (B, C, H)
    a = -torch.exp(p["A_log"])
    rep = nh // s.n_groups
    xh_all = x_all.reshape(bsz, cw, nh, s.head_dim).to(f32)
    bm_all = _heads(b_all, s.n_groups, s.d_state, rep).to(f32)
    cm_all = _heads(c_all, s.n_groups, s.d_state, rep).to(f32)
    if lengths is None:
        n_ok = torch.full((bsz,), cw, device=dev)
    else:
        n_ok = torch.clamp(lengths.to(dev), max=cw)
    valid = torch.arange(cw, device=dev)[None, :] < n_ok[:, None]

    ssm_st = cache["ssm"].to(f32)
    ys = []
    for t in range(cw):
        dtp, xh = dtp_all[:, t], xh_all[:, t]
        da = torch.exp(dtp * a)                             # (B, H)
        dbx = (bm_all[:, t] * dtp[..., None])[..., None] * xh[..., None, :]
        ssm_new = ssm_st * da[..., None, None] + dbx
        y_t = torch.einsum("bhn,bhnp->bhp", cm_all[:, t], ssm_new) \
            + xh * p["D"][:, None]
        ssm_st = torch.where(valid[:, t, None, None, None], ssm_new, ssm_st)
        ys.append(y_t.reshape(bsz, di))
    # The window after each row's last valid token: entries
    # [len, len + K-1) of the padded sequence (len 0: the old window).
    idx = n_ok[:, None] + torch.arange(kconv - 1, device=dev)[None]
    conv_new = torch.gather(
        padded, 1, idx[..., None].expand(bsz, kconv - 1, conv_dim))
    cache["conv"].copy_(conv_new)
    cache["ssm"].copy_(ssm_st)
    return z, torch.stack(ys, dim=1)


def ssm_cache_shape(cfg: ModelConfig, batch: int):
    s, d, di, nh, conv_dim = _dims(cfg)
    return {"conv": (batch, s.conv_kernel - 1, conv_dim),
            "ssm": (batch, nh, s.d_state, s.head_dim)}
