"""Pretrained-weight import (counterpart of ``ics_tpu/train/pretrained.py``):
ecosystem checkpoints into the port's state dicts.

Two on-disk layouts are accepted by :func:`load_pretrained`:

1. **native**: a flat ``.npz`` whose keys are the slash-joined paths of the
   reference's ``variables`` tree (``params/stem/conv/w``,
   ``state/stages/0/1/cbr2/bn/mean``, ...), in the reference's layouts (conv
   HWIO, dense [in, out]). Either package writes it (:func:`save_npz` here,
   from a port state dict) and either loads it. It covers every registered
   model, the ones without public checkpoints too.
2. **torch**: the torchvision/timm state-dict layouts, as a flat ``.npz``
   (name -> array), a ``.safetensors`` file or a ``.pt``/``.pth`` file read
   with ``torch.load(weights_only=True)``: torchvision ``resnet*``,
   ``resnext*``, ``wide_resnet*``, ``densenet*``, ``regnet_y_*``,
   ``mobilenet_v3_small``, ``efficientnet_b*``, ``efficientnet_v2_*``,
   ``convnext_*``; timm ``vit_*_patch16_*`` (a position embedding of another
   grid is resized) and ``swin_*_patch4_window7_224`` (both timm layouts).

Each family's mapper builds the reference's tree from the torch names, as
the reference's mappers do, reading the structure (which blocks have an
expansion, a projection, a squeeze-excitation) from the port's model built
on ``meta``; ``weights.from_jax_variables`` then gives the state dict, so a
file in either layout loads into exactly the state dict that the
reference's tree of the same weights maps to.

Head replacement: ``num_classes`` re-initialises the classifier head with
the port model's own head initialisation from a ``torch.Generator`` seeded
with ``seed`` (fine-tuning onto an ambiente's options) and keeps the
imported backbone.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ics_tpu_torch import weights
from ics_tpu_torch.models.registry import get_model
from ics_tpu_torch.ops.preproc import _triangle_weights

logger = logging.getLogger(__name__)


class PretrainedFormatError(ValueError):
    """Checkpoint file/layout problems — the operator's input, not a bug."""


# --------------------------------------------------------------------------
# native flat layout: variables tree <-> {slash/joined/path: array}
# --------------------------------------------------------------------------

def unflatten_variables(flat: dict[str, np.ndarray]) -> Any:
    """The native flat layout's {slash/joined/path: array} as the nested
    tree it flattens: a level whose keys are all digits becomes a list
    (block stacks), any other a dict."""
    root: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [rebuild(node[k]) for k in sorted(node, key=int)]
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def native_flat(state_dict: dict) -> dict[str, np.ndarray]:
    """A port state dict (unfolded, as ``weights.from_jax_variables`` gives
    it) as the native flat layout: the inverse of ``weights.py``'s mapping.
    A ``weight`` of rank 4 or 2 is a kernel ``w`` (OIHW -> HWIO, [out, in]
    -> [in, out]), of rank 1 a normalisation's ``gamma``, and its ``bias``
    then a ``beta``; running statistics go to ``state/.../mean|var``; any
    other leaf keeps its name and layout."""
    out: dict[str, np.ndarray] = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        arr = tensor.detach().cpu().float().numpy()
        tree = "params"
        if leaf in ("running_mean", "running_var"):
            tree, leaf = "state", leaf[len("running_"):]
        elif leaf == "weight":
            if arr.ndim == 4:
                leaf, arr = "w", arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                leaf, arr = "w", arr.T
            else:
                leaf = "gamma"
        elif leaf == "bias":
            sibling = state_dict.get(".".join(path + ["weight"]))
            leaf = "beta" if sibling is not None and sibling.dim() == 1 else "b"
        out["/".join([tree, *path, leaf])] = np.ascontiguousarray(arr)
    return out


def save_npz(path: str | Path, state_dict: dict) -> None:
    """Write a port state dict as the documented native flat ``.npz``."""
    np.savez(path, **native_flat(state_dict))


_SAFETENSORS_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}


def load_safetensors(path: Path) -> dict[str, np.ndarray]:
    """Minimal safetensors reader (timm/HF's default weight container):
    u64-LE header length + JSON header {name: {dtype, shape,
    data_offsets}} + raw little-endian tensor bytes. BF16 is widened to f32
    (numpy has no bfloat16; the loader casts to f32 anyway)."""
    import json
    import mmap
    import struct

    # mmap: each tensor copies out on its own, so the peak is about one
    # checkpoint, not its raw bytes and every copy
    f = path.open("rb")
    try:
        raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    except ValueError:
        f.close()
        raise PretrainedFormatError(f"safetensors truncado: {path}")
    f.close()
    if len(raw) < 8:
        raise PretrainedFormatError(f"safetensors truncado: {path}")
    (hlen,) = struct.unpack("<Q", raw[:8])
    if 8 + hlen > len(raw):
        raise PretrainedFormatError(f"safetensors com header inválido: {path}")
    try:
        header = json.loads(raw[8:8 + hlen])
    except ValueError as exc:
        raise PretrainedFormatError(f"safetensors com header inválido: {exc}")
    if not isinstance(header, dict):
        raise PretrainedFormatError(
            f"safetensors com header inválido (não é um objeto): {path}"
        )
    data = memoryview(raw)[8 + hlen:]
    out: dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        try:
            start, end = meta["data_offsets"]
            shape = tuple(meta["shape"])
            dt = meta["dtype"]
        except (TypeError, KeyError, ValueError) as exc:
            raise PretrainedFormatError(
                f"safetensors com entrada inválida ({name}): {exc!r}"
            )
        # offsets in range and consistent: a truncated file would otherwise
        # slice short and surface as an opaque frombuffer error
        if not (isinstance(start, int) and isinstance(end, int)
                and 0 <= start <= end <= len(data)):
            raise PretrainedFormatError(
                f"safetensors truncado/corrupto: offsets {start}:{end} "
                f"fora dos {len(data)} bytes de dados ({name})"
            )
        buf = data[start:end]
        try:
            if dt == "BF16":
                u16 = np.frombuffer(buf, "<u2").astype(np.uint32) << 16
                out[name] = u16.view(np.float32).reshape(shape).copy()
                continue
            np_dt = _SAFETENSORS_DTYPES.get(dt)
            if np_dt is None:
                raise PretrainedFormatError(
                    f"safetensors dtype não suportado: {dt} ({name})"
                )
            out[name] = np.frombuffer(
                buf, np.dtype(np_dt).newbyteorder("<")
            ).reshape(shape).astype(np_dt, copy=True)
        except ValueError as exc:  # frombuffer/reshape size mismatch
            raise PretrainedFormatError(f"safetensors corrupto em {name}: {exc}")
    return out


def load_flat(source: str | Path) -> dict[str, np.ndarray]:
    """Read a checkpoint file into a flat name -> array dict: ``.npz`` by
    numpy, ``.safetensors`` by the reader above, ``.pt``/``.pth``/``.bin``
    by ``torch.load`` (CPU, ``weights_only``: no pickled code runs)."""
    path = Path(source)
    if not path.is_file():
        raise PretrainedFormatError(f"arquivo de pesos não encontrado: {path}")
    if path.suffix == ".safetensors":
        return load_safetensors(path)
    if path.suffix in (".pt", ".pth", ".bin"):
        state = torch.load(path, map_location="cpu", weights_only=True)
        # training-checkpoint wrappers: torchvision's 'state_dict', timm's
        # and detectron's 'model' (with scalar metadata such as 'epoch')
        for wrapper in ("state_dict", "model"):
            if (isinstance(state, dict) and wrapper in state
                    and isinstance(state[wrapper], dict)):
                state = state[wrapper]
                break
        if not isinstance(state, dict):
            raise PretrainedFormatError(f"checkpoint torch não é um state_dict: {path}")
        out = {}
        for k, v in state.items():
            if not isinstance(v, torch.Tensor):
                continue  # scalar metadata (epoch/step) beside the weights
            if v.dtype == torch.bfloat16:
                v = v.float()  # numpy has no bfloat16: widen, as for safetensors
            out[k] = v.numpy()
        return out
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


# --------------------------------------------------------------------------
# torch layout helpers
# --------------------------------------------------------------------------

def _need(flat: dict, key: str) -> np.ndarray:
    if key not in flat:
        raise PretrainedFormatError(
            f"peso ausente no checkpoint: {key} (layout torchvision/timm?)"
        )
    return np.asarray(flat[key], np.float32)


def _conv_w(flat, key):
    # torch OIHW (depthwise [C, 1, kh, kw]) -> HWIO ([kh, kw, 1, C])
    return np.transpose(_need(flat, key), (2, 3, 1, 0))


def _linear(flat, prefix):
    return {
        "w": np.ascontiguousarray(_need(flat, f"{prefix}.weight").T),
        "b": _need(flat, f"{prefix}.bias"),
    }


def _ln(flat, prefix):
    return {
        "gamma": _need(flat, f"{prefix}.weight"),
        "beta": _need(flat, f"{prefix}.bias"),
    }


def _convbn(flat, conv_prefix, bn_prefix, bias: bool = False):
    conv = {"w": _conv_w(flat, f"{conv_prefix}.weight")}
    if bias:
        conv["b"] = _need(flat, f"{conv_prefix}.bias")
    bn_params, bn_state = _bn(flat, bn_prefix)
    return {"conv": conv, "bn": bn_params}, {"bn": bn_state}


def _se(flat, fc1, fc2):
    # torchvision's SE uses 1x1 convs ([r, C, 1, 1]); the models' are Dense
    # on the pooled activations: the same products
    def fc(prefix):
        w = _need(flat, f"{prefix}.weight")
        return {
            "w": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))[0, 0]),
            "b": _need(flat, f"{prefix}.bias"),
        }

    return {"fc1": fc(fc1), "fc2": fc(fc2)}


# --------------------------------------------------------------------------
# per-family mappers (torch state dict -> the reference's variables tree)
# --------------------------------------------------------------------------

def _map_resnet(model, flat):
    """torchvision ``resnet*`` (``torchvision/models/resnet.py`` naming)."""
    params: dict = {"stages": []}
    state: dict = {"stages": []}
    params["stem"], state["stem"] = _convbn(flat, "conv1", "bn1")
    for si, blocks in enumerate(model.stages):
        sp, ss = [], []
        for bi, blk in enumerate(blocks):
            pfx = f"layer{si + 1}.{bi}"
            bp, bs = {}, {}
            # bottleneck (50/101/152) has conv1-3, basic (18/34) conv1-2
            convs = (
                ((1, "cbr1"), (2, "cbr2"), (3, "cbr3"))
                if hasattr(blk, "cbr3")
                else ((1, "cbr1"), (2, "cbr2"))
            )
            for j, name in convs:
                bp[name], bs[name] = _convbn(flat, f"{pfx}.conv{j}", f"{pfx}.bn{j}")
            if blk.down is not None:
                bp["down"], bs["down"] = _convbn(
                    flat, f"{pfx}.downsample.0", f"{pfx}.downsample.1"
                )
            sp.append(bp)
            ss.append(bs)
        params["stages"].append(sp)
        state["stages"].append(ss)
    params["head"] = _linear(flat, "fc")
    return {"params": params, "state": state}


def _bn(flat, prefix):
    params = {
        "gamma": _need(flat, f"{prefix}.weight"),
        "beta": _need(flat, f"{prefix}.bias"),
    }
    state = {
        "mean": _need(flat, f"{prefix}.running_mean"),
        "var": _need(flat, f"{prefix}.running_var"),
    }
    return params, state


def _map_regnet(model, flat):
    """torchvision ``regnet_y_*`` (``torchvision/models/regnet.py`` naming:
    stem.0/1, trunk_output.block{i}.block{i}-{j}.proj/.f.{a,b,c} conv-BN
    pairs, .f.se.fc1/fc2 1x1 convs, fc head)."""
    params: dict = {"stages": []}
    state: dict = {"stages": []}
    params["stem"], state["stem"] = _convbn(flat, "stem.0", "stem.1")
    for si, blocks in enumerate(model.stages, start=1):
        sp, ss = [], []
        for bi, blk in enumerate(blocks):
            pfx = f"trunk_output.block{si}.block{si}-{bi}"
            bp, bs = {}, {}
            for name in ("a", "b", "c"):
                bp[name], bs[name] = _convbn(flat, f"{pfx}.f.{name}.0", f"{pfx}.f.{name}.1")
            bp["se"] = _se(flat, f"{pfx}.f.se.fc1", f"{pfx}.f.se.fc2")
            if blk.proj is not None:
                bp["proj"], bs["proj"] = _convbn(flat, f"{pfx}.proj.0", f"{pfx}.proj.1")
            sp.append(bp)
            ss.append(bs)
        params["stages"].append(sp)
        state["stages"].append(ss)
    params["head"] = _linear(flat, "fc")
    return {"params": params, "state": state}


def _map_densenet(model, flat):
    """torchvision ``densenet*`` (``torchvision/models/densenet.py`` naming:
    features.denseblock{i}.denselayer{j}.norm/conv{1,2},
    features.transition{i}, features.norm5, classifier)."""
    params: dict = {"stages": [], "down": []}
    state: dict = {"stages": [], "down": []}
    params["stem"], state["stem"] = _convbn(flat, "features.conv0", "features.norm0")
    for i, layers in enumerate(model.stages, start=1):
        sp, ss = [], []
        for j in range(1, len(layers) + 1):
            pfx = f"features.denseblock{i}.denselayer{j}"
            bn1p, bn1s = _bn(flat, f"{pfx}.norm1")
            bn2p, bn2s = _bn(flat, f"{pfx}.norm2")
            sp.append({
                "bn1": bn1p,
                "conv1": {"w": _conv_w(flat, f"{pfx}.conv1.weight")},
                "bn2": bn2p,
                "conv2": {"w": _conv_w(flat, f"{pfx}.conv2.weight")},
            })
            ss.append({"bn1": bn1s, "bn2": bn2s})
        params["stages"].append(sp)
        state["stages"].append(ss)
    for i in range(1, len(model.down) + 1):
        pfx = f"features.transition{i}"
        bnp, bns = _bn(flat, f"{pfx}.norm")
        params["down"].append({"bn": bnp, "conv": {"w": _conv_w(flat, f"{pfx}.conv.weight")}})
        state["down"].append({"bn": bns})
    params["final_bn"], state["final_bn"] = _bn(flat, "features.norm5")
    params["head"] = _linear(flat, "classifier")
    return {"params": params, "state": state}


def _resize_pos_embed(pos, num_patches: int, dim: int):
    """timm ``pos_embed`` [1, 1 + G^2, D] -> [1, 1 + num_patches, D].

    A checkpoint of another grid (a 224 px, 196-patch one into the 384 px,
    576-patch model) is bridged by a bilinear resize of the patch grid, the
    ViT fine-tuning recipe (Dosovitskiy et al. §3.2). The resize is the
    reference's ``jax.image.resize(..., "bilinear")``, which widens its
    triangle by the factor when it shrinks (antialiasing; ``F.interpolate``
    does not): two products with the triangle weights of ``ops.preproc``."""
    pos = np.asarray(pos, np.float32)
    if pos.shape[1] == num_patches + 1:
        return pos
    cls, grid = pos[:, :1], pos[:, 1:]
    g_old = int(round(grid.shape[1] ** 0.5))
    g_new = int(round(num_patches ** 0.5))
    if g_old * g_old != grid.shape[1] or g_new * g_new != num_patches:
        raise PretrainedFormatError(
            f"pos_embed com {grid.shape[1]} patches não interpola para "
            f"{num_patches}"
        )
    one = lambda v: torch.tensor([float(v)], dtype=torch.float32)  # noqa: E731
    w = _triangle_weights(g_old, g_new, one(g_old), one(g_old) / g_new, one(0))[0]
    grid = torch.from_numpy(np.ascontiguousarray(grid.reshape(g_old, g_old, dim)))
    grid = torch.einsum("oh,hwd,pw->opd", w, grid, w).numpy()
    logger.info("pos_embed interpolado: grade %d -> %d", g_old, g_new)
    return np.concatenate([cls, grid.reshape(1, num_patches, dim)], axis=1)


def _map_vit(model, flat):
    """timm ``vit_*_patch16_*`` naming (``timm/models/vision_transformer``)."""
    params = {
        "patch_embed": {
            "w": _conv_w(flat, "patch_embed.proj.weight"),
            "b": _need(flat, "patch_embed.proj.bias"),
        },
        "cls_token": _need(flat, "cls_token"),
        "pos_embed": _resize_pos_embed(
            _need(flat, "pos_embed"), model.num_patches, model.dim
        ),
        "blocks": [],
        "ln": _ln(flat, "norm"),
        "head": _linear(flat, "head"),
    }
    for i in range(len(model.blocks)):
        pfx = f"blocks.{i}"
        params["blocks"].append(
            {
                "ln1": _ln(flat, f"{pfx}.norm1"),
                "attn": {
                    "qkv": _linear(flat, f"{pfx}.attn.qkv"),
                    "proj": _linear(flat, f"{pfx}.attn.proj"),
                },
                "ln2": _ln(flat, f"{pfx}.norm2"),
                "fc1": _linear(flat, f"{pfx}.mlp.fc1"),
                "fc2": _linear(flat, f"{pfx}.mlp.fc2"),
            }
        )
    return {"params": params, "state": {}}


def _map_mobilenetv3(model, flat):
    """torchvision ``mobilenet_v3_small`` naming: ``features.{i}.block.{j}``
    where j skips absent expand/SE stages; classifier.0/.3 are fc1/head."""
    params: dict = {"blocks": []}
    state: dict = {"blocks": []}
    params["stem"], state["stem"] = _convbn(flat, "features.0.0", "features.0.1")
    for i, blk in enumerate(model.blocks):
        pfx = f"features.{i + 1}.block"
        j = 0
        bp, bs = {}, {}
        if blk.exp is not None:
            bp["exp"], bs["exp"] = _convbn(flat, f"{pfx}.{j}.0", f"{pfx}.{j}.1")
            j += 1
        bp["dw"], bs["dw"] = _convbn(flat, f"{pfx}.{j}.0", f"{pfx}.{j}.1")
        j += 1
        if blk.se is not None:
            bp["se"] = _se(flat, f"{pfx}.{j}.fc1", f"{pfx}.{j}.fc2")
            j += 1
        bp["proj"], bs["proj"] = _convbn(flat, f"{pfx}.{j}.0", f"{pfx}.{j}.1")
        params["blocks"].append(bp)
        state["blocks"].append(bs)
    last = len(model.blocks) + 1
    params["conv_last"], state["conv_last"] = _convbn(
        flat, f"features.{last}.0", f"features.{last}.1"
    )
    params["fc1"] = _linear(flat, "classifier.0")
    params["head"] = _linear(flat, "classifier.3")
    return {"params": params, "state": state}


def _map_efficientnet(model, flat):
    """torchvision ``efficientnet_b*`` naming: stage-grouped
    ``features.{s}.{r}.block.{j}`` onto the flat block list."""
    params: dict = {"blocks": []}
    state: dict = {"blocks": []}
    params["stem"], state["stem"] = _convbn(flat, "features.0.0", "features.0.1")
    flat_idx = 0
    for s, repeats in enumerate(model.stage_repeats, start=1):
        for r in range(repeats):
            blk = model.blocks[flat_idx]
            pfx = f"features.{s}.{r}.block"
            j = 0
            bp, bs = {}, {}
            if blk.exp is not None:
                bp["exp"], bs["exp"] = _convbn(flat, f"{pfx}.{j}.0", f"{pfx}.{j}.1")
                j += 1
            bp["dw"], bs["dw"] = _convbn(flat, f"{pfx}.{j}.0", f"{pfx}.{j}.1")
            j += 1
            bp["se"] = _se(flat, f"{pfx}.{j}.fc1", f"{pfx}.{j}.fc2")
            j += 1
            bp["proj"], bs["proj"] = _convbn(flat, f"{pfx}.{j}.0", f"{pfx}.{j}.1")
            params["blocks"].append(bp)
            state["blocks"].append(bs)
            flat_idx += 1
    if flat_idx != len(model.blocks):
        raise PretrainedFormatError(
            f"estrutura efficientnet não bate: {flat_idx} blocos mapeados, "
            f"modelo tem {len(model.blocks)}"
        )
    last = len(model.stage_repeats) + 1
    params["conv_head"], state["conv_head"] = _convbn(
        flat, f"features.{last}.0", f"features.{last}.1"
    )
    params["head"] = _linear(flat, "classifier.1")
    return {"params": params, "state": state}


def _map_efficientnet_v2(model, flat):
    """torchvision ``efficientnet_v2_*`` naming: features.0 stem, then one
    ``features.{s}`` per stage (fused stages have block.0 [+ block.1
    project]; MBConv stages the v1 0/1/2/3 layout), the head conv after the
    last stage, classifier.1 the Linear."""
    from ics_tpu_torch.models.efficientnet import FusedMBConv

    params: dict = {"blocks": []}
    state: dict = {"blocks": []}
    params["stem"], state["stem"] = _convbn(flat, "features.0.0", "features.0.1")
    flat_idx = 0
    for s, repeats in enumerate(model.stage_repeats, start=1):
        for r in range(repeats):
            blk = model.blocks[flat_idx]
            pfx = f"features.{s}.{r}.block"
            bp, bs = {}, {}
            if isinstance(blk, FusedMBConv):
                if blk.exp is not None:
                    bp["exp"], bs["exp"] = _convbn(flat, f"{pfx}.0.0", f"{pfx}.0.1")
                    bp["proj"], bs["proj"] = _convbn(flat, f"{pfx}.1.0", f"{pfx}.1.1")
                else:
                    bp["proj"], bs["proj"] = _convbn(flat, f"{pfx}.0.0", f"{pfx}.0.1")
            else:
                bp["exp"], bs["exp"] = _convbn(flat, f"{pfx}.0.0", f"{pfx}.0.1")
                bp["dw"], bs["dw"] = _convbn(flat, f"{pfx}.1.0", f"{pfx}.1.1")
                bp["se"] = _se(flat, f"{pfx}.2.fc1", f"{pfx}.2.fc2")
                bp["proj"], bs["proj"] = _convbn(flat, f"{pfx}.3.0", f"{pfx}.3.1")
            params["blocks"].append(bp)
            state["blocks"].append(bs)
            flat_idx += 1
    # the head conv follows the LAST stage: features.8 for the 7-stage V2-M
    head_idx = len(model.stage_repeats) + 1
    params["conv_head"], state["conv_head"] = _convbn(
        flat, f"features.{head_idx}.0", f"features.{head_idx}.1"
    )
    params["head"] = _linear(flat, "classifier.1")
    return {"params": params, "state": state}


def _map_convnext(model, flat):
    """torchvision ``convnext_*`` naming: features.0 stem, odd indices are
    block stages, even are (LN, 2x2 conv) downsamples; classifier.0/.2."""
    params: dict = {
        "stem": {
            "w": _conv_w(flat, "features.0.0.weight"),
            "b": _need(flat, "features.0.0.bias"),
        },
        "stem_ln": _ln(flat, "features.0.1"),
        "down": [],
        "stages": [],
        "final_ln": _ln(flat, "classifier.0"),
        "head": _linear(flat, "classifier.2"),
    }
    for i in range(3):
        pfx = f"features.{2 * (i + 1)}"
        params["down"].append(
            {
                "ln": _ln(flat, f"{pfx}.0"),
                "conv": {
                    "w": _conv_w(flat, f"{pfx}.1.weight"),
                    "b": _need(flat, f"{pfx}.1.bias"),
                },
            }
        )
    for si, blocks in enumerate(model.stages):
        stage = []
        for bi in range(len(blocks)):
            pfx = f"features.{2 * si + 1}.{bi}"
            gamma = _need(flat, f"{pfx}.layer_scale")
            stage.append(
                {
                    "dwconv": {
                        "w": _conv_w(flat, f"{pfx}.block.0.weight"),
                        "b": _need(flat, f"{pfx}.block.0.bias"),
                    },
                    "ln": _ln(flat, f"{pfx}.block.2"),
                    "fc1": _linear(flat, f"{pfx}.block.3"),
                    "fc2": _linear(flat, f"{pfx}.block.5"),
                    "gamma": gamma.reshape(-1),  # torch keeps [C, 1, 1]
                }
            )
        params["stages"].append(stage)
    return {"params": params, "state": {}}


def _map_swin(model, flat):
    """timm ``swin_*_patch4_window7_224`` naming (swin v1,
    ``timm/models/swin_transformer``): ``layers.{s}.blocks.{b}`` and
    ``layers.{s}.downsample``; the relative bias table imports as it is (the
    same (2w-1)^2 x heads layout, its index made the same way)."""
    params: dict = {
        "patch_embed": {
            "w": _conv_w(flat, "patch_embed.proj.weight"),
            "b": _need(flat, "patch_embed.proj.bias"),
        },
        "patch_norm": _ln(flat, "patch_embed.norm"),
        "stages": [],
        "merges": [],
        "ln": _ln(flat, "norm"),
        "head": _linear(flat, "head.fc")
        if "head.fc.weight" in flat else _linear(flat, "head"),
    }
    for si, stage in enumerate(model.stages):
        blocks = []
        for bi in range(len(stage)):
            pfx = f"layers.{si}.blocks.{bi}"
            blocks.append(
                {
                    "ln1": _ln(flat, f"{pfx}.norm1"),
                    "attn": {
                        "qkv": _linear(flat, f"{pfx}.attn.qkv"),
                        "proj": _linear(flat, f"{pfx}.attn.proj"),
                        "rel_bias": _need(
                            flat, f"{pfx}.attn.relative_position_bias_table"
                        ),
                    },
                    "ln2": _ln(flat, f"{pfx}.norm2"),
                    "fc1": _linear(flat, f"{pfx}.mlp.fc1"),
                    "fc2": _linear(flat, f"{pfx}.mlp.fc2"),
                }
            )
        params["stages"].append(blocks)
    # timm <= 0.8 keeps PatchMerging at the END of stage s
    # (layers.{s}.downsample); timm >= 0.9 (which also brought head.fc) at
    # the START of stage s+1 (layers.0.downsample is Identity). The layout
    # is told once, by stage 0: layers.1.downsample exists in both and
    # holds different merges.
    merge_off = 0 if "layers.0.downsample.reduction.weight" in flat else 1
    for si in range(len(model.merges)):
        dpfx = f"layers.{si + merge_off}.downsample"
        params["merges"].append(
            {
                "norm": _ln(flat, f"{dpfx}.norm"),
                "reduction": {
                    # torch Linear [out, in] -> [in, out]
                    "w": np.asarray(_need(flat, f"{dpfx}.reduction.weight"), np.float32).T,
                },
            }
        )
    return {"params": params, "state": {}}


_FAMILIES = (
    ("resnet", _map_resnet, "fc.weight"),
    # the same torchvision key scheme as resnet (layerN.M.convJ/bnJ/fc); the
    # mapper walks the model's own blocks, so grouped and wide inner widths
    # come out of the checkpoint's shapes
    ("resnext", _map_resnet, "fc.weight"),
    ("wide_resnet", _map_resnet, "fc.weight"),
    ("densenet", _map_densenet, "classifier.weight"),
    ("regnet", _map_regnet, "fc.weight"),
    ("vit", _map_vit, "head.weight"),
    ("mobilenetv3", _map_mobilenetv3, "classifier.3.weight"),
    # v2 before the v1 prefix
    ("efficientnet_v2", _map_efficientnet_v2, "classifier.1.weight"),
    ("efficientnet", _map_efficientnet, "classifier.1.weight"),
    ("convnext", _map_convnext, "classifier.2.weight"),
    # newer timm wraps the swin head in ClassifierHead (head.fc.*)
    ("swin", _map_swin, ("head.fc.weight", "head.weight")),
)


def _family(model_name: str):
    for prefix, mapper, head_key in _FAMILIES:
        if model_name.startswith(prefix):
            return mapper, head_key
    raise PretrainedFormatError(
        f"sem mapeador de checkpoint torch para o modelo '{model_name}'"
    )


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------

def load_pretrained(
    model_name: str,
    source: str | Path,
    num_classes: Optional[int] = None,
    seed: int = 0,
):
    """Load a checkpoint into ``(model, state_dict)`` for ``model_name``:
    the port's model on the CPU holding the weights, and its state dict
    (fp32 CPU tensors, the model's own), ready for
    ``InferenceEngine(model_name, state_dict=...)``.

    The layout is told by the keys: ``params/``/``state/`` are the native
    flat layout; anything else goes through the family's torch-layout
    mapper. ``num_classes`` (when it differs from the checkpoint's head)
    re-initialises the head. Every tensor is shape-checked against the
    model built on ``meta`` (no storage, the counterpart of
    ``jax.eval_shape``), so a wrong file fails before any weight is copied.
    """
    spec = get_model(model_name)
    flat = load_flat(source)
    native = any(k.startswith(("params/", "state/")) for k in flat)
    if native:
        variables = unflatten_variables(flat)
        try:
            head_w = variables["params"]["head"]["w"]
        except (KeyError, TypeError):
            raise PretrainedFormatError(
                "layout nativo sem params/head/w — arquivo truncado?"
            )
        ckpt_classes = int(head_w.shape[-1])
        variables.setdefault("state", {})
    else:
        mapper, head_key = _family(model_name)
        candidates = head_key if isinstance(head_key, tuple) else (head_key,)
        head_key = next((k for k in candidates if k in flat), None)
        if head_key is None:
            raise PretrainedFormatError(
                f"checkpoint sem {'/'.join(candidates)} — não parece o "
                f"layout torchvision/timm esperado para {model_name}"
            )
        ckpt_classes = int(np.asarray(flat[head_key]).shape[0])
        variables = mapper(spec.build(num_classes=ckpt_classes, device="meta"), flat)

    try:
        state_dict = weights.from_jax_variables(variables)
    except ValueError as exc:  # a kernel of a rank no layer has
        raise PretrainedFormatError(f"checkpoint incompatível com {model_name}: {exc}")
    classes = ckpt_classes
    if num_classes is not None and num_classes != ckpt_classes:
        classes = num_classes
        # only the head is drawn (every family ends in a Dense ``head``),
        # with the model's own initialisation
        head = spec.build(num_classes=classes, device="meta").head.to_empty(device="cpu")
        head.reset_parameters(torch.Generator().manual_seed(seed))
        state_dict.update({f"head.{k}": v.detach() for k, v in head.state_dict().items()})
        logger.info(
            "cabeça re-inicializada: %d -> %d classes (backbone pré-treinado)",
            ckpt_classes, classes,
        )

    expected = {k: tuple(v.shape) for k, v in
                spec.build(num_classes=classes, device="meta").state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    if expected != got:
        missing = sorted(set(expected) - set(got))[:5]
        extra = sorted(set(got) - set(expected))[:5]
        wrong = sorted(k for k in set(expected) & set(got) if expected[k] != got[k])[:5]
        raise PretrainedFormatError(
            f"checkpoint incompatível com {model_name}: "
            f"faltando={missing} extra={extra} shapes={wrong}"
        )
    # uninitialised storage on the CPU, replaced by the loaded tensors
    model = spec.build(num_classes=classes)
    model.load_state_dict(state_dict, strict=True, assign=True)
    return model, model.state_dict()
