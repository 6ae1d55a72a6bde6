"""Sequence parallelism: ring attention over an ``sp`` mesh axis (counterpart
of ``ics_tpu/parallel/ring_attention.py``).

The token dimension is split over the ring's positions. Each position keeps
its Q chunk, and the K/V chunks rotate from position to position
(``parallel.mesh.send``: an event on one card, a copy between cards), while
an online-softmax accumulator (the running max and sum of the flash kernel)
folds each arriving chunk in. After ``ring`` hops every Q chunk has attended
to every K/V chunk and the softmax is exact, with O(S / ring) keys held per
position at a time.

The reference writes it in plain ``jnp`` under ``shard_map``; here it is
plain torch ops, differentiable through autograd, no kernel of the port on
its path. One host thread enqueues every position's work, hop by hop, each
on its position's stream; the output is gathered in token order on the
caller's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ics_tpu_torch.ops.attention import NEG_INF  # the kernel's own sentinel
from ics_tpu_torch.parallel.mesh import Mesh, Position, send


def ring_positions(mesh: Mesh, axis: str = "sp") -> list:
    """The positions along ``axis`` (the first along any other axis), in
    ring order."""
    pos = np.moveaxis(mesh.positions, mesh.axis_names.index(axis), 0)
    return list(pos.reshape(pos.shape[0], -1)[:, 0])


def shard_tokens(x: torch.Tensor, positions: list, home: Position) -> list:
    """``x`` [B, H, S, D] split by token into one equal chunk a position, each
    on its position's device and ordered on its stream after ``home``."""
    chunk = x.shape[2] // len(positions)
    return [send(x.narrow(2, i * chunk, chunk), home, pos) for i, pos in enumerate(positions)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis: str = "sp", valid_len: Optional[int] = None) -> torch.Tensor:
    """Exact attention of q, k, v [B, H, S, D] with the tokens split over the
    ``axis`` positions of ``mesh``; [B, H, S, D] on q's device.

    ``valid_len`` masks key positions ``>= valid_len`` (padding:
    ``ring_attention_padded``); output rows past it are finite and must be
    sliced off by the caller. Scaling as ``ops.attention.attention_reference``
    (1/sqrt(D)), with fp32 scores, probabilities and sums."""
    b, h, s, d = q.shape
    ring = int(mesh.shape[axis])
    if s % ring:
        raise ValueError(f"sequência {s} não divide pelos {ring} devices do anel")
    if valid_len is not None and not (0 < valid_len <= s):
        raise ValueError(f"valid_len {valid_len} fora de (0, {s}]")
    chunk = s // ring
    scale = 1.0 / (d ** 0.5)
    masked = valid_len is not None and valid_len < s
    positions = ring_positions(mesh, axis)
    home = Position.current(q.device)
    qs, k_c, v_c = (shard_tokens(t, positions, home) for t in (q, k, v))

    def accumulate(i, hop, q32, k_i, v_i, m, l, acc):
        scores = torch.matmul(q32, k_i.float().transpose(-1, -2))
        if masked:
            # the chunk held at this hop came from position (i - hop): its keys
            # are the global positions [origin * chunk, (origin + 1) * chunk)
            origin = (i - hop) % ring
            keys = origin * chunk + torch.arange(chunk, device=scores.device)
            mask = keys < valid_len
            scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        if masked:
            # an all-masked chunk leaves m_new at NEG_INF, where
            # exp(NEG_INF - NEG_INF) = 1 would count ghost keys
            p = p * mask.to(p.dtype)
        alpha = torch.exp(m - m_new)          # rescale the running state
        acc = acc * alpha[..., None] + torch.matmul(p, v_i.float())
        l = l * alpha + p.sum(dim=-1)
        return m_new, l, acc

    state = []
    for i, pos in enumerate(positions):
        with pos.active():
            q32 = qs[i].float() * scale
            state.append((q32, torch.full(q32.shape[:-1], NEG_INF, device=q32.device),
                          q32.new_zeros(q32.shape[:-1]), torch.zeros_like(q32)))
    for hop in range(ring):
        for i, pos in enumerate(positions):
            with pos.active():
                state[i] = (state[i][0],) + accumulate(i, hop, state[i][0], k_c[i], v_c[i],
                                                       *state[i][1:])
        if hop < ring - 1:
            # position i takes the chunk position i - 1 held; the last chunk
            # is folded in with no rotation after it
            k_c = [send(k_c[i - 1], positions[i - 1], positions[i]) for i in range(ring)]
            v_c = [send(v_c[i - 1], positions[i - 1], positions[i]) for i in range(ring)]
    outs = []
    for (_, _, l, acc), pos in zip(state, positions):
        with pos.active():
            # a padded row with every key masked has l == 0: finite garbage,
            # not NaN that could reach a later sum
            safe_l = torch.where(l == 0.0, 1.0, l)
            outs.append(send((acc / safe_l[..., None]).to(q.dtype), pos, home))
    return torch.cat(outs, dim=2)


def ring_attention_padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                          axis: str = "sp") -> torch.Tensor:
    """``ring_attention`` for a sequence that does not divide the ring (ViT's
    P + 1 tokens): S padded up to the next multiple, the padding masked as
    keys, the real rows sliced back out. [B, H, S, D] in and out."""
    s = q.shape[2]
    ring = int(mesh.shape[axis])
    pad = (-s) % ring
    if pad == 0:
        return ring_attention(q, k, v, mesh, axis=axis)
    q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
    return ring_attention(q, k, v, mesh, axis=axis, valid_len=s)[:, :, :s, :]
