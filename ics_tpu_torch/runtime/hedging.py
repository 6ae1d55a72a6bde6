"""Replica-level serving with request hedging (counterpart of
``ics_tpu/runtime/hedging.py``).

The visible devices are partitioned into ``TPU_SERVING_REPLICAS``
independent replicas, each its own ``InferenceEngine`` and
``InferenceService`` pinned to a disjoint device group by a mesh of its own.
Requests round-robin across the replicas; a request whose replica has not
answered within ``TPU_HEDGE_MS`` is duplicated onto the next replica and the
first result wins (the loser's flush still completes; its result is
discarded). A replica that raises (not merely straggles) is hedged at once;
the request fails only if the hedge fails too. Undecodable bytes
(``ImagemInvalida``) fail the same way on every replica and are not hedged.

Why replicas and not hedging inside one sharded step: a sharded step is one
program across its devices, and if it stalls (a wedged card, a cold first
call on a new shape) every request of the batch stalls with it. Independent
replicas give hedging the isolation it needs.

With ``TPU_PP_STAGES``, each replica group is one pipeline: it must hold
exactly that many devices and gets a ``("pp",)`` mesh, so replicas compose
data parallelism with pipeline parallelism.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ics_tpu_torch.core.config import settings as global_settings
from ics_tpu_torch.runtime.decode import ImagemInvalida
from ics_tpu_torch.runtime.service import latency_summary

logger = logging.getLogger(__name__)


def partition_devices(devices, replicas: int) -> list[list]:
    """Split ``devices`` into ``replicas`` equal contiguous groups. Loud on
    counts that do not divide: unbalanced replicas would skew the hedging
    latency."""
    n = len(devices)
    if replicas < 2:
        raise ValueError("replica partitioning needs TPU_SERVING_REPLICAS >= 2")
    if n < replicas or n % replicas:
        raise RuntimeError(
            f"TPU_SERVING_REPLICAS={replicas} cannot partition {n} visible "
            f"device(s) into equal groups"
        )
    per = n // replicas
    return [list(devices[i * per:(i + 1) * per]) for i in range(replicas)]


class HedgedInferenceService:
    """Drop-in for :class:`InferenceService` over N independent replicas:
    ``classify_bytes`` / ``classify_many`` / ``embed_bytes`` /
    ``explain_bytes`` / ``classify_bytes_tta`` / ``start`` / ``stop`` /
    ``status`` / ``latency_percentiles`` and ``.engine`` (the first
    replica's: the pool shares its mesh)."""

    # deterministic input failures fail identically on every replica:
    # replaying them doubles the work and counts client errors as hedge
    # failures. Narrow on purpose: a bare OSError or ValueError from a
    # failing replica is what hedging must absorb.
    INPUT_ERRORS = (ImagemInvalida,)

    def __init__(self, replicas, hedge_ms: float = 250.0):
        if len(replicas) < 2:
            raise ValueError("HedgedInferenceService needs >= 2 replicas")
        self.replicas = list(replicas)
        self.hedge_s = max(hedge_ms, 1.0) / 1000.0
        self._rr = 0
        self._stats = {"hedges_fired": 0, "hedges_won": 0,
                       "hedge_failures": 0, "input_errors": 0}

    # -- construction -------------------------------------------------------
    @classmethod
    def from_settings(cls, settings=None, devices=None, **engine_overrides):
        """Partition ``devices`` (default: every visible card, each once)
        into TPU_SERVING_REPLICAS groups and build one pinned
        InferenceService per group: a pure-DP mesh over each group, also
        for a one-device group (the mesh pins the replica to its device), or
        a ("pp",) mesh under TPU_PP_STAGES. The multi-process start runs
        first (``maybe_initialize_distributed``), as in the reference; the
        groups stay over this process's cards."""
        from ics_tpu_torch.parallel.mesh import (
            make_mesh,
            maybe_initialize_distributed,
            visible_devices,
        )
        from ics_tpu_torch.runtime.service import InferenceService

        settings = settings or global_settings
        maybe_initialize_distributed(settings)
        devices = list(devices) if devices is not None else visible_devices()
        groups = partition_devices(devices, settings.TPU_SERVING_REPLICAS)
        pp = int(getattr(settings, "TPU_PP_STAGES", 0) or 0)
        if pp >= 2 and len(groups[0]) != pp:
            raise RuntimeError(
                f"TPU_PP_STAGES={pp} com TPU_SERVING_REPLICAS="
                f"{settings.TPU_SERVING_REPLICAS}: cada réplica recebe "
                f"{len(groups[0])} devices, mas um pipeline precisa de "
                f"exatamente {pp} — ajuste réplicas x estágios aos chips"
            )
        replicas = []
        for group in groups:
            if pp >= 2:
                mesh = make_mesh(shape=(pp,), axes=("pp",), devices=group)
            else:
                mesh = make_mesh(shape=(len(group),), axes=("data",), devices=group)
            replicas.append(InferenceService.from_settings(mesh=mesh, **engine_overrides))
        logger.info(
            "hedged serving: %d replicas x %d device(s), hedge after %.0f ms",
            len(groups), len(groups[0]), settings.TPU_HEDGE_MS,
        )
        return cls(replicas, hedge_ms=settings.TPU_HEDGE_MS)

    # -- InferenceService surface -------------------------------------------
    @property
    def engine(self):
        return self.replicas[0].engine

    @property
    def device_decode(self) -> bool:
        return self.replicas[0].device_decode

    async def start(self, warm: bool = False) -> None:
        for r in self.replicas:
            await r.start(warm=warm)

    async def stop(self) -> None:
        for r in self.replicas:
            await r.stop()

    def _next(self) -> int:
        i = self._rr
        self._rr = (self._rr + 1) % len(self.replicas)
        return i

    @staticmethod
    def _discard(task: asyncio.Task) -> None:
        """Detach a losing duplicate: retrieve its eventual result or
        exception so the loop does not log 'exception was never retrieved'."""
        task.add_done_callback(lambda t: t.exception() if not t.cancelled() else None)

    async def classify_bytes(self, data: bytes) -> dict:
        i = self._next()
        primary = asyncio.ensure_future(self.replicas[i].classify_bytes(data))
        try:
            return await asyncio.wait_for(asyncio.shield(primary), self.hedge_s)
        except asyncio.TimeoutError:
            pass  # straggler -> hedge below, primary keeps running
        except self.INPUT_ERRORS:
            self._stats["input_errors"] += 1
            raise  # the client's fault: every replica would fail the same way
        except Exception:
            primary = None  # the replica failed outright -> hedge at once
        self._stats["hedges_fired"] += 1
        backup = asyncio.ensure_future(
            self.replicas[(i + 1) % len(self.replicas)].classify_bytes(data)
        )
        racers = {backup} | ({primary} if primary is not None else set())
        winner_exc: Optional[BaseException] = None
        while racers:
            done, racers = await asyncio.wait(racers, return_when=asyncio.FIRST_COMPLETED)
            # retrieve every finished task's exception first: a success and a
            # failure can land in the same tick
            winner = None
            for task in done:
                if task.exception() is None:
                    winner = task
                else:
                    winner_exc = task.exception()
            if winner is not None:
                for loser in racers:
                    self._discard(loser)
                if winner is backup:
                    self._stats["hedges_won"] += 1
                result = winner.result()
                result["hedged"] = True
                return result
        # a straggling primary can still end in a deterministic input error:
        # keep it out of the infrastructure-failure counter
        if isinstance(winner_exc, self.INPUT_ERRORS):
            self._stats["input_errors"] += 1
        else:
            self._stats["hedge_failures"] += 1
        raise winner_exc  # both replicas failed

    async def classify_many(self, blobs) -> list[dict]:
        return list(await asyncio.gather(*(self.classify_bytes(b) for b in blobs)))

    async def embed_bytes(self, data: bytes):
        """Round-robin over the replicas, not hedged: embeddings are rare,
        deterministic work, and spreading it beats duplicating it."""
        return await self.replicas[self._next()].embed_bytes(data)

    async def explain_bytes(self, data: bytes, class_idx: int = -1,
                            smooth_samples: int = 1) -> dict:
        """Round-robin like ``embed_bytes`` (rare diagnostic traffic)."""
        return await self.replicas[self._next()].explain_bytes(data, class_idx, smooth_samples)

    async def classify_bytes_tta(self, data: bytes) -> dict:
        """Round-robin like ``embed_bytes`` (asked for per request, already
        twice the device work: hedging would make it four times)."""
        return await self.replicas[self._next()].classify_bytes_tta(data)

    def latency_percentiles(self) -> dict:
        return latency_summary([r.latency for r in self.replicas])

    def status(self) -> dict:
        per_replica = [r.status() for r in self.replicas]
        # requests round-robin, so the counters are summed over the replicas
        # (the metrics export reads the top-level keys), the per-lane ones too
        fixed = ("images", "batches", "device_decoded", "host_decoded", "device_errors")
        dynamic = {
            k for s in per_replica for k in s
            if k.startswith("device_decoded_") or k.startswith("host_decoded_")
        }
        summed = {}
        for key in (*fixed, *sorted(dynamic)):
            if any(key in s for s in per_replica):
                summed[key] = sum(s.get(key, 0) for s in per_replica)
        return {
            **per_replica[0],
            **summed,
            "serving_replicas": len(self.replicas),
            "hedging": dict(self._stats),
            "latency": self.latency_percentiles(),
            "replicas": per_replica,
        }
