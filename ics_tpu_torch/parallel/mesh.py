"""Device mesh and sharding layer (counterpart of ``ics_tpu/parallel/mesh.py``).

The reference is single-controller: one program over a ``jax.sharding.Mesh``
whose axes are

- ``data``  — the batch split over the positions (data parallelism);
- ``model`` — the classifier head's classes split over the positions
  (the tensor-parallel seam);
- ``pp``    — pipeline stages (``parallel.pipeline``),

with GSPMD placing the collectives. The port's counterpart is one process
that drives several devices. A ``Mesh`` is a numpy array of
``torch.device`` with axis names; a position of the mesh names a device, and
two positions may name the same one (one card then plays several positions).
Each position has a CUDA stream of its own (``Position``), kept per
position, not per device. Collectives within the process are
device-to-device copies on the receiver's stream, ordered by an event
(``send``); across processes they are ``torch.distributed``'s.

``MeshModel`` serves a folded model on a ``("data"[, "model"])`` mesh:

- the model is put once on each ``data`` position's device at build time;
  positions on one device share that device's copy, so one card holds one
  copy of the weights however many positions it plays;
- a batch is split into equal row chunks, chunk *i* copied to data position
  *i* on that position's stream, and what each chunk's step returns is
  gathered in row order on the first position's device, ordered on the
  caller's current stream there;
- with a ``model`` axis that divides the class count, the head's weight
  and bias are split by classes over it (``shard_head_for_tp``). The trunk
  runs once per ``data`` group, on the group's first position, and its
  features are copied to the group's ``model`` positions, each of which
  computes its slice of the logits; the slices are gathered on the group's
  first position before the softmax and top-k. (The reference computes the
  trunk on every position of a ``model`` group; both compute the same
  function.)

Training (``train_mesh_from_settings``, ``TPU_TRAIN_DEVICES``) runs one
model over the ``data`` positions of a mesh: each position holds a copy of
the model and runs its chunk of the batch on a host thread of its own, under
its stream, the threads taking turns (``Rendezvous.run``). The positions meet only in the forward,
where BatchNorm in training mode takes its statistics over the whole batch
(``Rendezvous.gather``, through ``nn.layers.statistics_over``); the
backward is one autograd pass from the caller's thread over the sum of the
positions' losses (``train.finetune``).

``maybe_initialize_distributed`` (``TPU_COORDINATOR_ADDRESS``,
``TPU_NUM_PROCESSES``, ``TPU_PROCESS_ID``) starts ``torch.distributed`` over
TCP. JAX makes ``jax.devices()`` global once its processes are started, and
a mesh then spans them; torch does not, and the port's meshes stay over this
process's own cards (``visible_devices``): a deliberate divergence
(``ROADMAP.md`` §3). Work across processes goes through ``torch.distributed``'s
collectives.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ics_tpu_torch.ops.jpeg_decode import as_device_tensor

logger = logging.getLogger(__name__)


def _indexed(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` is the current one): a tensor's
    device always has one, and ``send`` compares the two."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """Devices laid out on named axes: ``devices`` is a numpy array of
    ``torch.device`` (one per position), ``axis_names`` one name per axis,
    ``shape`` the ordered ``{name: size}`` as JAX's ``Mesh.shape``."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for i, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[i] = _indexed(torch.device(dev))
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of {arr.ndim} axes named {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self._positions: Optional[np.ndarray] = None

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def positions(self) -> np.ndarray:
        """One ``Position`` per device entry, made on first use (so that a
        mesh can be described where no device is visible)."""
        if self._positions is None:
            pos = np.empty(self.devices.shape, dtype=object)
            for i, dev in np.ndenumerate(self.devices):
                pos[i] = Position(dev)
            self._positions = pos
        return self._positions

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


class Position:
    """A position of a mesh: its device and, on CUDA, a stream of its own.
    ``Position.current(device)`` stands for the caller: the device's current
    stream, not a new one."""

    def __init__(self, device: torch.device, stream=None):
        self.device = torch.device(device)
        if stream is None and self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
        self.stream = stream

    @classmethod
    def current(cls, device: torch.device) -> "Position":
        device = torch.device(device)
        return cls(device, torch.cuda.current_stream(device) if device.type == "cuda" else None)

    def active(self):
        """Make this position's stream current for what the block enqueues."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()


def send(x: torch.Tensor, src: Position, dst: Position) -> torch.Tensor:
    """``x``, made on ``src``'s stream, for use on ``dst``'s stream.

    On one device it is the same tensor: ``dst``'s stream waits for an event
    recorded on ``src``'s, and ``record_stream`` keeps the caching allocator
    from handing its memory to another tensor while ``dst``'s stream may
    still read it. Across devices it is a copy made with both positions'
    streams current: PyTorch enqueues it on the source's stream (after ``x``
    was made) and makes the destination's stream wait for it."""
    if src is dst or x.device.type != "cuda":
        return x.to(dst.device)
    if x.device == dst.device:
        event = torch.cuda.Event()
        event.record(src.stream)
        dst.stream.wait_event(event)
        x.record_stream(dst.stream)
        return x
    with torch.cuda.stream(src.stream), torch.cuda.stream(dst.stream):
        return x.to(dst.device, non_blocking=True)


def visible_devices() -> list[torch.device]:
    """``cuda:0`` .. ``cuda:n-1``, each named once; none where CUDA is absent."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axes: Optional[Sequence[str]] = None, devices=None) -> Mesh:
    devices = list(devices) if devices is not None else visible_devices()
    n = len(devices)
    if shape is None:
        # default: 2D (data, model) when there are >=4 devices, else pure DP
        if n >= 4 and n % 2 == 0:
            shape, axes = (n // 2, 2), ("data", "model")
        else:
            shape, axes = (n,), ("data",)
    if axes is None:
        axes = ("data", "model")[: len(shape)]
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr[: int(np.prod(shape))].reshape(tuple(shape)), axes)


_distributed_initialized = False


def maybe_initialize_distributed(settings) -> bool:
    """The multi-process start: ``torch.distributed.init_process_group`` over
    TCP at ``TPU_COORDINATOR_ADDRESS`` ("host:port" of process 0), with
    ``TPU_NUM_PROCESSES`` and this process's ``TPU_PROCESS_ID``, on PyTorch's
    default pair of backends (gloo for CPU tensors, NCCL for CUDA ones).
    A no-op without an address; idempotent across callers (serving and the
    train CLI). Returns whether this process has been started. The meshes
    stay over this process's own cards (the module's docstring)."""
    global _distributed_initialized
    if _distributed_initialized or not settings.TPU_COORDINATOR_ADDRESS:
        return _distributed_initialized
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(init_method=f"tcp://{settings.TPU_COORDINATOR_ADDRESS}",
                                world_size=int(settings.TPU_NUM_PROCESSES),
                                rank=int(settings.TPU_PROCESS_ID))
    _distributed_initialized = True
    return True


def mesh_from_settings(settings, devices=None) -> Optional[Mesh]:
    """The serving mesh from TPU_MESH_SHAPE / TPU_MESH_AXES / TPU_PP_STAGES
    over ``devices`` (default: every visible card, each once).

    - "auto" (default): pure-DP mesh over every visible device; None on a
      single device.
    - explicit "4,2": exactly that shape over TPU_MESH_AXES; raises if the
      host doesn't have enough devices: serving on fewer cards than
      configured would be an invisible capacity loss.
    - TPU_PP_STAGES >= 2: a ("pp",) mesh over the first TPU_PP_STAGES
      devices; with an explicit TPU_MESH_SHAPE it raises.
    """
    maybe_initialize_distributed(settings)
    shape = settings.get_mesh_shape()
    devices = list(devices) if devices is not None else visible_devices()
    pp = int(getattr(settings, "TPU_PP_STAGES", 0) or 0)
    if pp >= 2:
        if shape is not None:
            raise RuntimeError(
                "TPU_PP_STAGES e TPU_MESH_SHAPE explícito são mutuamente "
                "exclusivos — use TPU_SERVING_REPLICAS para compor DP com PP"
            )
        if pp > len(devices):
            raise RuntimeError(
                f"TPU_PP_STAGES={pp} precisa de {pp} devices, "
                f"mas só {len(devices)} visíveis"
            )
        return make_mesh(shape=(pp,), axes=("pp",), devices=devices[:pp])
    if shape is None:
        if len(devices) <= 1:
            return None
        return make_mesh(shape=(len(devices),), axes=("data",), devices=devices)
    need = int(np.prod(shape))
    if need <= 1:
        return None
    if need > len(devices):
        raise RuntimeError(
            f"TPU_MESH_SHAPE={settings.TPU_MESH_SHAPE} needs {need} devices, "
            f"but only {len(devices)} are visible"
        )
    axes = settings.get_mesh_axes()[: len(shape)]
    return make_mesh(shape=shape, axes=axes, devices=devices)


def train_mesh_from_settings(settings, devices=None) -> Optional[Mesh]:
    """The training mesh from ``TPU_TRAIN_DEVICES``, over ``devices`` (default:
    every visible card, each once):

    - ``""`` (default): no mesh; training runs on the job's device;
    - ``"all"``: a ``("data",)`` mesh over every device;
    - ``"a:b"`` (a python slice of ``devices``, e.g. ``"6:8"``): a
      ``("data",)`` mesh over that contiguous slice, so the cards outside it
      never see training work. A one-device slice still builds a mesh: it
      pins training to that card.

    A bare number, a spec that is no slice, a slice out of range and an
    empty selection raise, with the reference's messages. A slice that
    shares devices with the serving mesh (``mesh_from_settings``) is warned
    about: serving and training then contend there. Devices are compared by
    their position in ``devices``, as the reference compares device ids (two
    CPU positions have the same name)."""
    spec = (settings.TPU_TRAIN_DEVICES or "").strip().lower()
    if not spec:
        return None
    devices = list(devices) if devices is not None else visible_devices()
    if spec == "all":
        start, end = 0, len(devices)
    else:
        if ":" not in spec:
            raise ValueError(
                f"TPU_TRAIN_DEVICES={settings.TPU_TRAIN_DEVICES!r}: expected "
                "'', 'all' or a 'start:end' slice (a bare number is "
                "ambiguous — write '6:7' for device 6 only)"
            )
        try:
            start_s, _, end_s = spec.partition(":")
            start = int(start_s) if start_s else 0
            end = int(end_s) if end_s else len(devices)
        except ValueError:
            raise ValueError(
                f"TPU_TRAIN_DEVICES={settings.TPU_TRAIN_DEVICES!r}: expected "
                "'', 'all' or a 'start:end' slice"
            )
        if start < 0 or end > len(devices) or start >= end:
            # loud like mesh_from_settings: silently training on fewer
            # cards than configured is an invisible capacity loss
            raise RuntimeError(
                f"TPU_TRAIN_DEVICES={settings.TPU_TRAIN_DEVICES!r} is out of "
                f"range for {len(devices)} visible device(s)"
            )
    group = devices[start:end]
    if not group:
        raise RuntimeError(
            f"TPU_TRAIN_DEVICES={settings.TPU_TRAIN_DEVICES!r} selects no "
            f"device (have {len(devices)})"
        )
    mesh = make_mesh(shape=(len(group),), axes=("data",), devices=group)
    # isolation holds only where serving does not also cover the slice; with
    # TPU_MESH_SHAPE=auto serving spans every card
    serving = None
    if hasattr(settings, "get_mesh_shape"):
        try:
            serving = mesh_from_settings(settings, devices=devices)
        except Exception:  # a mis-sized explicit shape raises on its own path
            serving = None
    if serving is not None:
        # mesh_from_settings lays its mesh over the first positions of devices
        overlap = set(range(serving.size)) & set(range(start, end))
        if overlap:
            logger.warning(
                "TPU_TRAIN_DEVICES=%s overlaps the serving mesh on device(s) "
                "%s — training WILL contend with serving there. For real "
                "isolation shrink TPU_MESH_SHAPE so serving stays off the "
                "training slice.",
                settings.TPU_TRAIN_DEVICES, sorted(overlap),
            )
    return mesh


def data_positions(mesh: Mesh) -> list:
    """The first position of each ``data`` index (with a ``model`` axis, the
    one at model index 0), in data order: where a data-parallel step runs
    its chunks."""
    axes = mesh.axis_names
    if "data" not in axes:
        raise ValueError(f"a data-parallel mesh has a 'data' axis; got {axes}")
    pos = np.moveaxis(mesh.positions, axes.index("data"), 0)
    return list(pos.reshape(pos.shape[0], -1)[:, 0])


class Rendezvous:
    """The positions of a data-parallel step, each run on a host thread of its
    own (``run``), and where they meet in the forward (``gather``).

    ``gather`` hands back every position's tensor, in position order, for
    use on the caller's position: its own tensor as it is, the others' through
    ``send`` (the same tensor on one device, a copy across devices), so the
    result stays in the autograd graph. The backward then needs no meeting:
    one ``backward()`` from the caller's thread routes each part's gradient
    back to the position that made it. (A collective that blocked inside the
    backward could deadlock: autograd runs every position of one card on
    that card's single worker thread.)

    One thread runs at a time: the threads take turns in position order, a
    thread giving the turn to the next when it reaches a meeting or ends.
    Each position's work still runs on its own stream, so the devices
    overlap; what is serial is the host's enqueueing, which is serial under
    the interpreter lock anyway. Two threads let run at once trade the lock
    at every PyTorch call (each releases it): on an H100 each took 84.9 ms
    to enqueue a ResNet-50 forward, against 56.4 ms for both in turns. The threads are made at the first ``run`` and kept: a fresh
    thread's first CUDA work pays again for what PyTorch keeps per thread
    (cuDNN's plans among it), 112.4 ms of host time for that forward against
    24.7 ms in a kept thread (``tools.profile_dp_step``; ``PERF.md`` §6)."""

    def __init__(self, positions: Sequence[Position]):
        self.positions = list(positions)
        self._turn = threading.Condition()
        self._holder: Optional[int] = None     # the position whose thread may run
        self._done: list = []
        self._failed = False
        self._meetings: list = []              # a counter a position
        self._slots = [[None] * len(self.positions) for _ in range(2)]
        self._pool: Optional[ThreadPoolExecutor] = None

    @property
    def size(self) -> int:
        return len(self.positions)

    def _wait_for_turn(self, index: int) -> None:
        with self._turn:
            while self._holder != index and not self._failed:
                self._turn.wait()
            if self._failed:
                raise threading.BrokenBarrierError("another position failed")

    def _pass_turn(self, index: int, done: bool = False) -> None:
        with self._turn:
            self._done[index] = done
            for k in range(1, self.size + 1):
                nxt = (index + k) % self.size
                if not self._done[nxt]:
                    self._holder = nxt
                    break
            else:
                self._holder = None
            self._turn.notify_all()

    def gather(self, index: int, t: torch.Tensor) -> list:
        """Every position's ``t`` (``index`` is the caller's position), on the
        caller's device and ordered on its stream. Called by every position
        the same number of times, in the same order."""
        m = self._meetings[index]
        self._meetings[index] = m + 1
        # meeting m's parts, kept until every position has read them: a
        # position is at most one meeting ahead of another
        slots = self._slots[m % 2]
        slots[index] = t
        self._pass_turn(index)
        self._wait_for_turn(index)       # the turn went round: every part is in
        dst = self.positions[index]
        return [t if j == index else send(s, self.positions[j], dst)
                for j, s in enumerate(slots)]

    def run(self, fn: Callable[[int], object]) -> list:
        """``fn(i)`` for every position ``i``, each on a thread of its own with
        the position's stream current and BatchNorm's statistics taken over
        the group (``nn.layers.statistics_over``), in turns (the class's
        docstring); the results in position order. Each position's stream
        first waits for the caller's current streams, so it reads what the
        caller enqueued before. An error in one position ends the others' at
        their next meeting, and is raised here once every position has
        ended."""
        from ics_tpu_torch.nn.layers import statistics_over

        first = self.positions[0].device
        for pos in self.positions:
            if pos.stream is not None:
                pos.stream.wait_stream(torch.cuda.current_stream(pos.device))
                if first != pos.device:
                    pos.stream.wait_stream(torch.cuda.current_stream(first))
        self._done = [False] * self.size
        self._meetings = [0] * self.size
        self._failed = False
        self._holder = 0

        def body(i: int):
            try:
                self._wait_for_turn(i)
                with self.positions[i].active(), statistics_over(self, i):
                    out = fn(i)
            except BaseException:
                with self._turn:
                    self._failed = True      # no other position waits for this one
                    self._turn.notify_all()
                raise
            self._pass_turn(i, done=True)
            return out

        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.size,
                                            thread_name_prefix="position")
        futures = [self._pool.submit(body, i) for i in range(self.size)]
        wait(futures)
        errors = [f.exception() for f in futures]
        if any(e is not None for e in errors):
            # the position that failed first, not one that its failure woke
            raise next((e for e in errors if e is not None
                        and not isinstance(e, threading.BrokenBarrierError)),
                       next(e for e in errors if e is not None))
        return [f.result() for f in futures]


# -- how a tensor is laid out over a mesh ------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """A tensor's layout over ``mesh``: ``spec`` names, for each leading
    dimension, the axis it is split over (None: whole); the dimensions past
    ``spec`` and the axes it does not name are replicated, as with JAX's
    ``PartitionSpec``."""

    mesh: Mesh
    spec: tuple = ()

    def shard(self, t: torch.Tensor, index: tuple) -> torch.Tensor:
        """The part of ``t`` that the position at ``index`` holds."""
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = self.mesh.shape[axis]
            if t.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over "
                                 f"{axis}={n}")
            size = t.shape[dim] // n
            t = t.narrow(dim, index[self.mesh.axis_names.index(axis)] * size, size)
        return t


def batch_sharding(mesh: Mesh, ndim: int = 4) -> NamedSharding:
    """The leading (batch) dimension split over 'data'; the rest replicated."""
    return NamedSharding(mesh, ("data",) + (None,) * (ndim - 1))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_head_for_tp(mesh: Mesh, params: dict) -> dict:
    """Layouts for a folded model's parameters (a flat ``name -> tensor``
    dict, as ``state_dict`` gives): the classifier head split by classes
    over 'model' when the mesh has that axis (``head.weight`` [classes,
    features] along dim 0, ``head.bias`` [classes]), everything else
    replicated. A class count the axis does not divide (a trained head has
    as many classes as its ambiente has options) is served replicated."""
    rep = replicated_sharding(mesh)
    shardings = {name: rep for name in params}
    head = [name for name in ("head.weight", "head.bias") if name in params]
    if "model" in mesh.axis_names and head:
        tp = int(mesh.shape["model"])
        classes = int(params[head[0]].shape[0])
        if tp > 1 and classes % tp:
            logger.info(
                "head classes dim (%s) not divisible by model axis (%d): "
                "serving the head replicated instead of TP-sharded",
                classes, tp,
            )
            return shardings
        for name in head:
            shardings[name] = NamedSharding(mesh, ("model",))
    return shardings


def place(t: torch.Tensor, sharding: NamedSharding) -> np.ndarray:
    """``t`` placed over the mesh: an array shaped as the mesh, holding at
    each position its part of ``t`` on that position's device."""
    out = np.empty(sharding.mesh.devices.shape, dtype=object)
    for index, dev in np.ndenumerate(sharding.mesh.devices):
        out[index] = sharding.shard(t, index).contiguous().to(dev, copy=True)
    return out


def apply_shardings(tree: dict, shardings: dict) -> dict:
    return {name: place(t, shardings[name]) for name, t in tree.items()}


# -- a folded model served over a ("data"[, "model"]) mesh --------------------------

def headless(model: torch.nn.Module) -> torch.nn.Module:
    """The folded model with ``head`` replaced by the identity: a shallow
    copy that shares every parameter, buffer and module but the head. Every
    model of the zoo ends its ``apply_folded`` with ``self.head(feats)``, so
    the copy returns the penultimate features."""
    trunk = copy.copy(model)
    trunk._modules = dict(model._modules)
    trunk.head = torch.nn.Identity()
    return trunk


class DataGroup:
    """The positions of one ``data`` index: ``lead`` (its first position,
    where the trunk runs, at mesh index ``index``) holds a copy of the
    model; with a split head, ``head`` lists each ``model`` position with
    its slice of the head's weight and bias."""

    def __init__(self, lead: Position, index: tuple, model: torch.nn.Module, head: list):
        self.lead = lead
        self.index = index
        self.device = lead.device
        self.model = model
        self.trunk = headless(model)
        self.head = head

    def apply_folded(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of ``x`` (on the lead's device, under its stream)."""
        if not self.head:
            return self.model.apply_folded(x)
        feats = self.trunk.apply_folded(x)
        parts = []
        for pos, w, b in self.head:
            f = send(feats, self.lead, pos)
            with pos.active():
                y = F.linear(f, w.to(f.dtype), None if b is None else b.to(f.dtype))
            parts.append(send(y, pos, self.lead))
        return torch.cat(parts, dim=-1)


class MeshModel:
    """A folded model served over a mesh of ``data`` and ``model`` axes (see
    the module's docstring). ``model`` is the folded model on the CPU in
    fp32; it is copied once to each distinct device of the ``data``
    positions and cast to ``dtype`` there. ``groups[0].model`` is the copy
    on the first position's device."""

    def __init__(self, mesh: Mesh, model: torch.nn.Module, dtype: torch.dtype):
        axes = mesh.axis_names
        if "data" not in axes or set(axes) - {"data", "model"}:
            # the reference's sharded step splits the batch over 'data' too
            raise ValueError(f"a serving mesh has a 'data' axis and may have a 'model' "
                             f"one; got {axes}")
        self.mesh = mesh

        def index(d: int, m: int) -> tuple:
            at = {"data": d, "model": m}
            return tuple(at[a] for a in axes)

        n_data, n_model = mesh.shape["data"], mesh.shape.get("model", 1)
        leads = [index(d, 0) for d in range(n_data)]
        devices = list(dict.fromkeys(mesh.devices[i] for i in leads))
        copies = {}
        for i, dev in enumerate(devices):
            src = model if i == len(devices) - 1 else copy.deepcopy(model)
            copies[dev] = src.to(device=dev, dtype=dtype).eval().requires_grad_(False)
        head = copies[devices[0]].head
        params = {"head.weight": head.weight}
        if head.bias is not None:
            params["head.bias"] = head.bias
        shardings = shard_head_for_tp(mesh, params)
        self.head_sharded = bool(shardings["head.weight"].spec) and n_model > 1
        placed = apply_shardings(params, shardings) if self.head_sharded else {}
        self.groups = []
        for d, lead in enumerate(leads):
            parts = [(mesh.positions[index(d, m)], placed["head.weight"][index(d, m)],
                      placed["head.bias"][index(d, m)] if "head.bias" in placed else None)
                     for m in range(n_model)] if self.head_sharded else []
            self.groups.append(DataGroup(mesh.positions[lead], lead,
                                         copies[mesh.devices[lead]], parts))
        # the weights were copied on the devices' current streams; the
        # positions' streams must not read them before the copies are done
        for dev in set(mesh.devices.flat):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def map(self, fn: Callable, *arrays: np.ndarray) -> tuple:
        """Split the rows of ``arrays`` (host arrays of one batch; uint16 as
        ``ops.jpeg_decode.as_device_tensor`` carries them) over the data
        groups (``batch_sharding``); run ``fn(group, *chunk tensors)`` on
        each group's lead, on its stream; gather each output in row order on
        the first position's device, ordered on the caller's current stream.
        Nothing here waits for the device."""
        host = [as_device_tensor(a, "cpu") for a in arrays]
        home = Position.current(self.groups[0].device)
        parts = []
        for group in self.groups:
            with group.lead.active():
                chunk = [batch_sharding(self.mesh, t.dim()).shard(t, group.index)
                         .to(group.device) for t in host]
                outs = fn(group, *chunk)
            parts.append([send(o, group.lead, home) for o in outs])
        if len(parts) == 1:
            return tuple(parts[0])
        return tuple(torch.cat(col) for col in zip(*parts))
