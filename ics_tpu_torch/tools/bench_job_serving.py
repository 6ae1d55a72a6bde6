"""Classify latency beside a running fine-tune job, on one GPU.

Fresh servers in turns (``chip_smoke.py``'s: ResNet-50, fused chains, bf16,
the pixel lane, bytes from the fake NextCloud over TCP, [9]'s 32 labelled
JPEGs): ``N`` one-JPEG ``POST /inferencia/classificar`` requests with the card
idle, then ``N`` beside a ResNet-50 job of the route's defaults, with the
job's steps a second over them. Two variants: the job on the current CUDA
stream, as ``train/job.py`` runs it, and the job on a stream of its own,
patched into the server through a ``sitecustomize.py`` on its ``PYTHONPATH``.
Prints one line a server, with the card's name and power limit.

    python -m ics_tpu_torch.tools.bench_job_serving [--pairs 3] [--requests 32]

Run from the root of a checkout (it drives ``chip_smoke.py``'s server).
"""

from __future__ import annotations

import argparse
import asyncio
import tempfile
import time
from pathlib import Path

import numpy as np

OWN_STREAM = """\
import torch
import ics_tpu_torch.train.job as job

_launch = job.TrainingJobManager._launch


def _launch_on_a_stream(self, the_job, target, args, name):
    def run(*a):
        with torch.cuda.stream(torch.cuda.Stream()):
            target(*a)

    return _launch(self, the_job, run, args, name)


job.TrainingJobManager._launch = _launch_on_a_stream
"""


async def measure(base: str, admin: tuple, id_amb: str, queries: list, n: int):
    """(idle ms, beside-the-job ms, the job's steps a second meanwhile)."""
    import httpx

    async with httpx.AsyncClient(base_url=base, timeout=600) as c:
        r = await c.post("/auth/login", data={"username": admin[0], "password": admin[1]})
        r.raise_for_status()
        c.cookies.clear()
        h = {"Authorization": f"Bearer {r.json()['access_token']}"}

        async def classify(blob):
            t0 = time.perf_counter()
            r = await c.post("/inferencia/classificar",
                             files=[("files", ("q.jpg", blob, "image/jpeg"))], headers=h)
            r.raise_for_status()
            return (time.perf_counter() - t0) * 1000

        async def job(id_job):
            return (await c.get(f"/treinamento/jobs/{id_job}", headers=h)).json()

        for q in queries:
            await classify(q)
        idle = [await classify(queries[i % len(queries)]) for i in range(n)]
        r = await c.post(f"/treinamento/ambiente/{id_amb}",
                         json={"max_steps": 400, "epochs": 500}, headers=h)
        r.raise_for_status()
        id_job = r.json()["id_job"]
        while (await job(id_job))["passos"] < 2:
            await asyncio.sleep(0.05)
        steps0, t0 = (await job(id_job))["passos"], time.perf_counter()
        busy = [await classify(queries[i % len(queries)]) for i in range(n)]
        after = await job(id_job)
        if after["status"] != "executando":
            raise RuntimeError(f"the job ended ({after['status']}) before the requests did")
        rate = (after["passos"] - steps0) / (time.perf_counter() - t0)
        await c.post(f"/treinamento/jobs/{id_job}/cancelar", headers=h)
        while (await job(id_job))["status"] == "executando":
            await asyncio.sleep(0.1)
        return idle, busy, rate


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--requests", type=int, default=32)
    args = parser.parse_args()
    import chip_smoke as cs
    from ics_tpu_torch.ops import _build

    card = cs.card_line()
    _build.build()
    corpus = cs.finetune_corpus()
    queries = cs._images(cs.JPEG_SIZES[:4], "JPEG", quality=90)
    for mode in ("current stream", "own stream") * args.pairs:
        with tempfile.TemporaryDirectory() as tmp:
            site = Path(tmp) / "site"
            site.mkdir()
            if mode == "own stream":
                (site / "sitecustomize.py").write_text(OWN_STREAM)
            root = Path(tmp) / "nextcloud"
            (root / "ft").mkdir(parents=True)
            for i, (blob, _) in enumerate(corpus):
                (root / "ft" / f"{i}.jpg").write_bytes(blob)
            with cs.fake_nextcloud(tmp, root) as nc_env:
                with cs.serving(tmp, **nc_env, NEXTCLOUD_SYNC_INITIAL_ON_STARTUP="false",
                                TPU_DEVICE_DECODE="false", TPU_WEIGHTS_DIR=f"{tmp}/weights",
                                PYTHONPATH=f"{site}:{cs.ROOT}") as (base, admin, database, _):
                    seeded = cs.seed_job_surface(database, corpus)
                    idle, busy, rate = asyncio.run(
                        measure(base, admin, seeded["a"], queries, args.requests))
        print(f"job on the {mode}: idle p50 {np.percentile(idle, 50):.2f} p99 "
              f"{np.percentile(idle, 99):.2f} ms; beside the job p50 "
              f"{np.percentile(busy, 50):.2f} p99 {np.percentile(busy, 99):.2f} ms; the job "
              f"{rate:.2f} steps/s meanwhile; {card}", flush=True)


if __name__ == "__main__":
    main()
