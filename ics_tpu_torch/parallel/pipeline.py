"""Pipeline parallelism (GPipe) for the transformer trunk (counterpart of
``ics_tpu/parallel/pipeline.py``).

Stages are the positions of a ``pp`` mesh axis. The blocks of a homogeneous
trunk are split into equal runs, one a stage, and placed on the stages'
devices once (``stage_block_params``). A batch is cut into microbatches
that flow stage to stage on the classic fill-drain schedule: at tick ``t``
stage ``s`` runs microbatch ``t - s`` on its position's stream, then hands
the result to stage ``s + 1`` (``parallel.mesh.send``: an event on one
device, a copy on the receiver's stream across devices); ``M + S - 1``
ticks move ``M`` microbatches through ``S`` stages, a bubble of
``(S - 1) / (M + S - 1)``. The host enqueues every tick without waiting for
the device, so stages on distinct cards overlap; on one card the stages'
streams share its SMs.

Each stage runs the model's own ``TransformerBlock.forward(x, use_flash)``,
so on the serving path every block's attention is the flash kernel. The
schedule is plain autograd-visible PyTorch: on the CPU, with plain
attention, a gradient through it equals the sequential blocks' (the
flash kernel itself has no backward).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ics_tpu_torch.parallel.mesh import Mesh, Position, send


def _stage_positions(mesh: Mesh, axis: str) -> list[Position]:
    grid = np.moveaxis(mesh.positions, mesh.axis_names.index(axis), 0)
    return list(grid.reshape(grid.shape[0], -1)[:, 0])


def stage_block_params(blocks: Sequence[torch.nn.Module], mesh: Mesh,
                       axis: str = "pp") -> list[list[torch.nn.Module]]:
    """Split ``blocks`` into one equal run a stage of ``mesh``'s ``axis`` and
    move each run to its stage's device (in place: the modules are the
    model's own). Serving engines call this once, at build time, so no call
    copies a parameter."""
    n_stages = int(mesh.shape[axis])
    depth = len(blocks)
    if depth % n_stages:
        raise ValueError(f"profundidade {depth} não divide pelos {n_stages} estágios")
    per = depth // n_stages
    stages = []
    for s, pos in enumerate(_stage_positions(mesh, axis)):
        run = [blk.to(pos.device) for blk in blocks[s * per:(s + 1) * per]]
        stages.append(run)
    for dev in {pos.device for pos in _stage_positions(mesh, axis)}:
        if dev.type == "cuda":   # the stages' streams read what the current stream copied
            torch.cuda.synchronize(dev)
    return stages


def pipeline_blocks(blocks, tokens: torch.Tensor, mesh: Mesh, microbatches: int,
                    axis: str = "pp", use_flash: bool = False,
                    staged: bool = False) -> torch.Tensor:
    """Run a homogeneous block stack over ``tokens`` [B, T, D] with the
    blocks split across the mesh's ``axis`` positions (depth % stages == 0,
    B % microbatches == 0). Returns [B, T, D] on the tokens' device, ordered
    on the caller's current stream there: the sequential blocks' result.

    ``blocks`` is the list of blocks, or with ``staged=True`` the output of
    :func:`stage_block_params` (one list a stage, already placed)."""
    n_stages = int(mesh.shape[axis])
    b = tokens.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} não divide por {microbatches} microbatches")
    if staged:
        if len(blocks) != n_stages:
            raise ValueError(
                f"parâmetros estagiados para {len(blocks)} estágios, mesh tem {n_stages}")
        stages = blocks
    else:
        stages = stage_block_params(blocks, mesh, axis)
    pos = _stage_positions(mesh, axis)
    home = Position.current(tokens.device)
    xs = tokens.chunk(microbatches)
    inbox: list = [None] * n_stages
    outs: list = [None] * microbatches
    for tick in range(microbatches + n_stages - 1):
        nxt: list = [None] * n_stages
        for s in range(n_stages):
            i = tick - s
            if not 0 <= i < microbatches:
                continue
            x = send(xs[i], home, pos[0]) if s == 0 else inbox[s]
            with pos[s].active():
                for blk in stages[s]:
                    x = blk(x, use_flash=use_flash)
            if s == n_stages - 1:
                outs[i] = send(x, pos[s], home)
            else:
                nxt[s + 1] = send(x, pos[s], pos[s + 1])
        inbox = nxt
    return torch.cat(outs)


def pipeline_vit_forward(model, x: torch.Tensor, mesh: Mesh, microbatches: int = 4,
                         axis: str = "pp", use_flash: bool = False,
                         stages=None) -> torch.Tensor:
    """ViT logits with the transformer trunk pipelined over the mesh's
    ``axis``: the patch embed, cls token and pos embed run before the
    pipeline and the final norm and head after it, on the device of ``x``
    (the first stage's). ``stages``: the engine's :func:`stage_block_params`
    output; without it the model's blocks are staged on this call."""
    b = x.shape[0]
    y = model.patch_embed(x).reshape(b, -1, model.dim)
    cls = model.cls_token.to(y.dtype).expand(b, 1, model.dim)
    y = torch.cat([cls, y], dim=1) + model.pos_embed.to(y.dtype)
    if stages is None:
        y = pipeline_blocks(list(model.blocks), y, mesh, microbatches, axis, use_flash)
    else:
        y = pipeline_blocks(stages, y, mesh, microbatches, axis, use_flash, staged=True)
    return model.head(model.ln(y)[:, 0])
