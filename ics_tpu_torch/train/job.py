"""Background fine-tune jobs: specialist labels -> trained weights ->
model-version registry (counterpart of ``ics_tpu/train/job.py``, the same
names, payload keys, validation order and messages).

A job trains one registry model on one ambiente's labelled examples
(:func:`ics_tpu_torch.train.data.labeled_examples`) with
:class:`~ics_tpu_torch.train.finetune.FineTuner`, checkpoints with the port's
``CheckpointManager`` (``step_<n>.pt``) and registers the result in
``modelos_treinados``, where serving (``InferenceServicePool.get_trained``)
picks it up. Training runs on a worker thread, on the card unless the manager
was given ``device="cpu"``: ``device=None`` means CUDA, and ``start`` raises
``TrainingUnavailable`` before it claims the slot where there is none. It
never trains on the CPU in its place.

A job's thread queues its work on the current CUDA stream, as the serving
threads do: a stream of its own showed no gain past the host's spread for the
classify requests served beside a running job (``PERF.md`` §6,
``tools/bench_job_serving.py``). The kernels' launch counts (``ops.LAUNCHES``) are
the process's: a job's launches show in ``/inferencia/status`` beside the
served ones. With ``TPU_TRAIN_DEVICES`` a job trains data-parallel on the
training mesh (``parallel.mesh.train_mesh_from_settings``; the positions of
the mesh run on streams of their own, ``train.finetune.DataParallel``), the
model living on the mesh's first card; a batch the mesh's device count does
not divide is refused, with the reference's message.
"""

from __future__ import annotations

import asyncio
import logging
import re
import threading
import time
import uuid
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ics_tpu_torch import disable_tf32, get_device
from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.crud import modelo_crud
from ics_tpu_torch.db.engine import Database
from ics_tpu_torch.models.registry import get_model
from ics_tpu_torch.train.data import (
    batch_iterator,
    inverse_map,
    labeled_examples,
    prefetch,
    split_examples,
    suggested_examples,
)
from ics_tpu_torch.train.finetune import (
    FineTuner,
    find_ema_params,
    make_lr_schedule,
    make_optimizer,
    replace_ema_params,
)

logger = logging.getLogger(__name__)

BytesProvider = Callable[[str, str], bytes]


def _dtype(compute_dtype: str) -> torch.dtype:
    return torch.bfloat16 if compute_dtype == "bf16" else torch.float32


def _with_shadow(state_dict: dict, shadow: dict) -> dict:
    """``state_dict`` with its parameters replaced by the EMA shadow's (which
    holds parameters alone): the buffers, BatchNorm statistics among them,
    stay the model's, so the result loads into the model whole."""
    return {k: shadow.get(k, v) for k, v in state_dict.items()}


def _make_periodic_eval(model, spec, dtype, eval_cached, *, multi_label: bool, use_ema: bool):
    """The ``FineTuner.run`` ``eval_fn`` for early stopping, over batches
    decoded once on the host. Returns ``(metric, state_dict)``: accuracy for
    single-label, exact match at the fixed 0.5 threshold for multi-label. With
    EMA on, the shadow weights are evaluated (they are what the job will
    register and serve): copied into the model's parameters for the eval and
    the live ones put back after."""
    from ics_tpu_torch.train.finetune import make_multilabel_eval_step, make_preproc_eval_step

    if multi_label:
        probs_step = make_multilabel_eval_step(model, spec.image_size, spec.resize_short, dtype)
    else:
        acc_step = make_preproc_eval_step(model, spec.image_size, spec.resize_short, dtype)

    def evaluate():
        correct = total = 0
        for canvas_b, sizes_b, labels_b, n_real in eval_cached:
            if multi_label:
                probs = probs_step(canvas_b, sizes_b).cpu().numpy()[:n_real]
                pred = probs >= 0.5
                want = np.asarray(labels_b)[:n_real] > 0.5
                correct += int((pred == want).all(axis=-1).sum())
                total += int(n_real)
            else:
                valid = torch.arange(labels_b.shape[0]) < n_real
                c, t = acc_step(canvas_b, sizes_b, labels_b, valid)
                correct += int(c)
                total += int(t)
        return (correct / total) if total else None

    def eval_fn(model, opt_state, step):
        shadow = find_ema_params(opt_state) if use_ema else None
        state = model.state_dict()
        if not shadow:
            return evaluate(), state
        params = dict(model.named_parameters())
        live = {n: p.detach().clone() for n, p in params.items()}
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(shadow[n])
            try:
                metric = evaluate()
            finally:
                for n, p in params.items():
                    p.copy_(live[n])
        return metric, _with_shadow(state, shadow)

    return eval_fn


class TrainingUnavailable(RuntimeError):
    """No image-byte source configured, or no device to train on: a
    deployment condition (503), not a transient job conflict (409)."""


def nextcloud_bytes_provider(client_factory) -> BytesProvider:
    """Blocking byte fetch for the training thread.

    The sync tier's NextCloud client is async; this provider owns a
    private event loop and drives a private client instance on it (clients
    must not hop threads/loops). The SAME provider instance is shared by
    the training thread AND route executors (``POST /inferencia/indexar``,
    the bulk-suggest route), so entry is serialized with a lock — two OS
    threads inside one ``run_until_complete`` would corrupt the loop.
    Concurrent callers interleave fetch-by-fetch.
    """
    loop = asyncio.new_event_loop()
    lock = threading.Lock()
    client = None

    def fetch(content_hash: str, caminho: str) -> bytes:
        nonlocal client
        with lock:
            if client is None:
                client = client_factory()
            return loop.run_until_complete(client.get_file(caminho))

    return fetch


class TrainingJob:
    def __init__(self, id_amb: str, model_name: str, params: dict):
        self.id_job = uuid.uuid4().hex[:12]
        self.id_amb = str(id_amb)
        self.model_name = model_name
        self.params = params
        # pendente | executando | concluido | cancelado | falhou
        self.status = "pendente"
        self.cancel_event = threading.Event()
        self.error: Optional[str] = None
        self.history: list[dict] = []
        self.id_mod: Optional[str] = None
        self.versao: Optional[int] = None
        self.eval_accuracy: Optional[float] = None
        self.n_examples = 0   # ALL labeled examples at admission
        self.n_train = 0      # train split size (incl. pseudo-labels)
        self.n_sugestoes = 0  # pseudo-labels mixed in (distillation)
        self.ckpt_dir: Optional[str] = None  # set by start (may be resumed)
        self.started_at = tz.utcnow()
        self.finished_at = None

    def to_dict(self) -> dict:
        last = self.history[-1] if self.history else None
        return {
            "id_job": self.id_job,
            "id_amb": self.id_amb,
            "modelo": self.model_name,
            "status": self.status,
            "erro": self.error,
            "exemplos": self.n_examples,
            "exemplos_treino": self.n_train,
            "sugestoes": self.n_sugestoes,
            "passos": len(self.history),
            "ultimo_passo": last,
            "historico": self.history[-20:],
            "id_mod": self.id_mod,
            "versao": self.versao,
            "eval_accuracy": self.eval_accuracy,
            "iniciado_em": self.started_at.isoformat(),
            "finalizado_em": (
                self.finished_at.isoformat() if self.finished_at else None
            ),
            **self.params,
        }


class TrainingJobManager:
    """One training job at a time (the card is shared with serving)."""

    def __init__(self, db: Database, checkpoint_root: str | Path,
                 fetch_bytes: Optional[BytesProvider] = None, device=None):
        self.db = db
        self.checkpoint_root = Path(checkpoint_root)
        self.fetch_bytes = fetch_bytes
        self.device = device
        self.jobs: dict[str, TrainingJob] = {}
        self._lock = threading.Lock()
        self._running: Optional[TrainingJob] = None

    def get(self, id_job: str) -> Optional[TrainingJob]:
        return self.jobs.get(id_job)

    def _device(self) -> torch.device:
        """The device jobs train on; raises ``TrainingUnavailable`` where the
        card was asked for (``device=None``) and none is visible."""
        try:
            return get_device(self.device)
        except RuntimeError as exc:
            raise TrainingUnavailable(f"nenhum dispositivo para treinar: {exc}")

    def gc_checkpoints(self) -> dict:
        """Delete checkpoint dirs not referenced by any registry version
        and not owned by a live job (cancelled/failed/superseded runs
        accumulate one dir each under ``checkpoint_root``).

        Registry rows keep their dirs even when inactive — an old version
        must stay restorable for rollback/export. Returns
        ``{"removidos": [...], "mantidos": n}``."""
        import shutil

        with self.db.session() as s:
            referenced = {
                str(Path(m.dir_checkpoint).resolve())
                for m in modelo_crud.listar_modelos(s)
            }

        def live_dirs() -> set[str]:
            # caller holds self._lock
            live = set()
            for j in self.jobs.values():
                if j.status not in ("pendente", "executando"):
                    continue
                d = j.ckpt_dir or str(
                    self.checkpoint_root / j.id_amb / j.model_name / j.id_job
                )
                live.add(str(Path(d).resolve()))
            return live

        removed: list[str] = []
        tombstones: list[tuple[Path, str]] = []
        kept = 0
        grace_s = 600.0  # writers commit their registry row within this
        now = time.time()
        root = Path(self.checkpoint_root)
        if root.is_dir():
            for d in sorted(root.glob("*/*/*")):
                if not d.is_dir():
                    continue
                if d.name.endswith(".gc-tomb"):
                    # a previous GC renamed it but crashed before the
                    # rmtree: tombstones are never live, sweep them
                    tombstones.append((d, str(d.relative_to(root))))
                    continue
                path = str(d.resolve())
                if path in referenced:
                    kept += 1
                    continue
                try:
                    recent = d.stat().st_mtime > now - grace_s
                except OSError:
                    recent = True
                if recent:
                    # an import/unpack in another request may be writing
                    # here with its registry row not yet committed — never
                    # race a live writer
                    kept += 1
                    continue
                # re-check the live set under the lock, then RENAME to a
                # tombstone (atomic, microseconds) instead of rmtree'ing
                # under the lock: a multi-GB dir takes seconds to delete and
                # start()/cancel()/worker-finally all contend on this lock.
                # A retomar_de job started mid-GC adopts its predecessor's
                # old dir — the rename under the same lock start() takes
                # closes that race.
                with self._lock:
                    if path in live_dirs():
                        kept += 1
                        continue
                    tomb = d.with_name(d.name + ".gc-tomb")
                    try:
                        d.rename(tomb)
                    except OSError:
                        kept += 1
                        logger.warning("checkpoint gc: could not stage %s", d)
                        continue
                tombstones.append((tomb, str(d.relative_to(root))))
        # the slow deletes run OUTSIDE the lock — the control plane
        # (start/cancel/slot release) never blocks on filesystem work
        for tomb, rel in tombstones:
            try:
                shutil.rmtree(tomb)
                removed.append(rel)
            except OSError:
                kept += 1
                logger.warning("checkpoint gc: could not remove %s", tomb)
        logger.info("checkpoint gc: %d removed, %d kept", len(removed), kept)
        return {"removidos": removed, "mantidos": kept}

    def resolve_pretrained(self, name_or_path: str) -> Path:
        """Resolve a ``pesos_iniciais`` argument to an existing file.

        Absolute paths are taken as-is; bare names resolve under
        ``{checkpoint_root}/pretrained/`` (the drop-in spot for downloaded
        checkpoints)."""
        p = Path(name_or_path)
        if not p.is_absolute():
            p = self.checkpoint_root / "pretrained" / name_or_path
        if not p.is_file():
            raise FileNotFoundError(
                f"pesos iniciais não encontrados: {p} (coloque checkpoints "
                f"em {self.checkpoint_root / 'pretrained'} ou passe um "
                f"caminho absoluto)"
            )
        return p

    # -- registry re-evaluation (tipo: avaliacao) -------------------------
    def start_evaluation(
        self,
        id_mod: str,
        fetch_bytes: Optional[BytesProvider] = None,
        batch_size: int = 32,
        canvas: int = 512,
        compute_dtype: str = "bf16",
    ) -> TrainingJob:
        """Re-evaluate a REGISTERED model version against the ambiente's
        CURRENT human labels (labels accumulate after training — fresh
        numbers tell the operator whether the active version still fits,
        or which version to promote). Eval-only: no weights change; the
        result lands in the job AND in the row's
        ``metricas.reavaliacao`` (timestamped, keeps the previous one as
        ``reavaliacao_anterior``). Occupies the single job slot (the card
        is shared with serving — same rule as training)."""
        from ics_tpu_torch.db.models import ModeloTreinado

        with self.db.session() as s:
            row = s.get(ModeloTreinado, str(id_mod))
            if row is None:
                raise KeyError(f"modelo {id_mod} não encontrado")
            snap = {
                "id_mod": str(row.id_mod),
                "id_amb": str(row.id_amb),
                "nome": row.nome_modelo,
                "versao": row.versao,
                "num_classes": int(row.num_classes),
                "class_map": dict(row.class_map or {}),
                "dir_checkpoint": row.dir_checkpoint,
                "metricas": dict(row.metricas or {}),
            }
        fetch = fetch_bytes or self.fetch_bytes
        if fetch is None:
            raise TrainingUnavailable(
                "nenhuma fonte de bytes configurada (NextCloud indisponível)"
            )
        device = self._device()
        job = TrainingJob(
            snap["id_amb"], snap["nome"],
            {"tipo": "avaliacao", "id_mod_avaliado": snap["id_mod"],
             "versao_avaliada": snap["versao"],
             "batch_size": batch_size, "canvas": canvas},
        )
        # the evaluated version's checkpoint dir joins the live set so
        # gc_checkpoints cannot delete it mid-restore
        job.ckpt_dir = snap["dir_checkpoint"]
        self._claim_slot(job)
        self._launch(
            job, self._run_eval,
            (job, device, fetch, snap, batch_size, canvas, compute_dtype),
            f"eval-{job.id_job}",
        )
        return job

    def _run_eval(self, job: TrainingJob, device: torch.device, fetch: BytesProvider,
                  snap: dict, batch_size: int, canvas: int, compute_dtype: str) -> None:
        try:
            job.status = "executando"
            multi_label = bool(snap["metricas"].get("multi_rotulo"))
            job.params["multi_rotulo"] = multi_label
            # index labels with the MODEL's class_map: options created
            # after training are unknown to it and must be excluded, not
            # remapped (train/data.py::labeled_examples)
            examples, class_map = labeled_examples(
                self.db, job.id_amb, multi_label=multi_label,
                class_map=snap["class_map"],
            )
            job.n_examples = len(examples)
            if not examples:
                raise RuntimeError(
                    "nenhum rótulo humano avaliável para o ambiente "
                    "(com as opções do modelo)"
                )
            spec = get_model(job.model_name)
            from ics_tpu_torch.train.checkpoint import CheckpointManager

            # a version the JAX trainer wrote raises UnconvertedCheckpointError
            mgr = CheckpointManager(snap["dir_checkpoint"])
            try:
                restored = mgr.restore()
            finally:
                mgr.close()
            model = spec.build(num_classes=snap["num_classes"])
            model.load_state_dict(restored["state_dict"])
            if device.type == "cuda":
                disable_tf32()
            model = model.to(device)
            dtype = _dtype(compute_dtype)

            def _cancellable(it):
                # cooperative cancellation BETWEEN batches (same contract
                # as training's should_stop): a long re-evaluation must
                # not hold the single job slot against an explicit cancel
                for b in it:
                    if job.cancel_event.is_set():
                        return
                    yield b

            batches = _cancellable(batch_iterator(
                examples, fetch, batch_size=batch_size, canvas=canvas,
                shuffle=False, epochs=1, with_counts=True,
                num_classes=snap["num_classes"],
            ))
            if job.cancel_event.is_set():
                job.status = "cancelado"
                return
            resultado: dict = {
                "avaliado_em": tz.utcnow().isoformat(),
                "exemplos": len(examples),
            }
            if multi_label:
                from ics_tpu_torch.train.finetune import (
                    collect_multilabel_scores,
                    multilabel_metrics,
                    multilabel_per_class_metrics,
                )

                probs, targets = collect_multilabel_scores(
                    model, batches, image_size=spec.image_size,
                    resize_short=spec.resize_short, compute_dtype=dtype,
                )
                if job.cancel_event.is_set():
                    job.status = "cancelado"
                    return
                if probs is None:
                    raise RuntimeError("avaliação vazia (decodificação)")
                limiar = float(snap["metricas"].get("limiar") or 0.5)
                resultado["limiar"] = limiar
                resultado.update(multilabel_metrics(probs, targets, limiar))
                resultado["eval_accuracy"] = resultado["exact_match"]
                por_classe = multilabel_per_class_metrics(probs, targets, limiar)
                resultado["eval_por_classe"] = {"por_classe": por_classe}
            else:
                from ics_tpu_torch.train.finetune import (
                    collect_logits,
                    per_class_metrics,
                )

                logits, labels = collect_logits(
                    model, batches, image_size=spec.image_size,
                    resize_short=spec.resize_short, compute_dtype=dtype,
                )
                if job.cancel_event.is_set():
                    job.status = "cancelado"
                    return
                if logits is None:
                    raise RuntimeError("avaliação vazia (decodificação)")
                resultado["eval_accuracy"] = float(
                    (logits.argmax(-1) == labels).mean()
                )
                resultado["eval_por_classe"] = per_class_metrics(
                    logits, labels, snap["num_classes"]
                )
            inv = inverse_map(class_map)
            for row_pc in resultado["eval_por_classe"]["por_classe"]:
                row_pc["id_opc"] = inv.get(row_pc["classe"])
            job.eval_accuracy = resultado["eval_accuracy"]
            if job.cancel_event.is_set():
                job.status = "cancelado"
                return
            from ics_tpu_torch.db.models import ModeloTreinado

            with self.db.session() as s:
                row = s.get(ModeloTreinado, snap["id_mod"])
                if row is not None:
                    metricas = dict(row.metricas or {})
                    anterior = metricas.pop("reavaliacao", None)
                    if anterior is not None:
                        metricas["reavaliacao_anterior"] = anterior
                    metricas["reavaliacao"] = resultado
                    row.metricas = metricas
                    s.commit()
            job.id_mod = snap["id_mod"]
            job.versao = snap["versao"]
            job.params["resultado"] = resultado
            job.status = "concluido"
            logger.info(
                "avaliação %s concluída: modelo %s v%s — accuracy %.4f "
                "em %d exemplos",
                job.id_job, job.model_name, job.versao,
                resultado["eval_accuracy"], len(examples),
            )
        except Exception as exc:
            job.status = "falhou"
            job.error = str(exc)
            logger.exception("avaliação %s falhou", job.id_job)
        finally:
            job.finished_at = tz.utcnow()
            with self._lock:
                if self._running is job:
                    self._running = None

    def cancel(self, id_job: str) -> TrainingJob:
        """Request cooperative cancellation: the job stops between steps,
        keeps its last checkpoint and registers/promotes NOTHING."""
        job = self.jobs.get(id_job)
        if job is None:
            raise KeyError(id_job)
        if job.status not in ("pendente", "executando"):
            raise RuntimeError(
                f"job {id_job} não está em execução (status={job.status})"
            )
        job.cancel_event.set()
        return job

    def _claim_slot(self, job: TrainingJob) -> None:
        """Atomically claim the SINGLE job slot (the card is shared with
        serving — one training/eval job at a time). One copy of the
        invariant for start() and start_evaluation()."""
        with self._lock:
            if self._running is not None and self._running.status in (
                "pendente", "executando"
            ):
                raise RuntimeError(
                    f"treinamento {self._running.id_job} já em execução"
                )
            self.jobs[job.id_job] = job
            self._running = job

    def _launch(self, job: TrainingJob, target, args, name: str) -> None:
        """Start the worker thread; on failure RELEASE the claimed slot —
        a job stuck in 'pendente' with no thread would otherwise block
        every future training request until process restart."""
        thread = threading.Thread(target=target, args=args, name=name, daemon=True)
        try:
            thread.start()
        except RuntimeError as exc:
            with self._lock:
                job.status = "falhou"
                job.error = f"não foi possível iniciar a thread: {exc}"
                job.finished_at = tz.utcnow()
                if self._running is job:
                    self._running = None
            raise TrainingUnavailable(
                "sem recursos para iniciar a thread do job — tente novamente"
            )
        job.thread = thread

    def list_jobs(self) -> list[dict]:
        # snapshot under the lock: start() inserts concurrently and a
        # dict-view iterator would raise "changed size during iteration"
        with self._lock:
            jobs = list(self.jobs.values())
        return [j.to_dict() for j in jobs]

    def start(
        self,
        id_amb: str,
        model_name: str = "resnet50",
        max_steps: int = 100,
        batch_size: int = 32,
        lr: float = 0.01,
        epochs: int = 10,
        canvas: int = 512,
        compute_dtype: str = "bf16",
        fetch_bytes: Optional[BytesProvider] = None,
        ativar: bool = True,
        seed: int = 0,
        eval_fraction: float = 0.2,
        remat: bool = False,
        usar_sugestoes: bool = False,
        sugestao_min_score: float = 0.9,
        retomar_de: Optional[str] = None,
        pesos_iniciais: Optional[str] = None,
        augmentar: bool = True,
        mixup_alpha: float = 0.0,
        cutmix_alpha: float = 0.0,
        suavizacao_rotulo: float = 0.0,
        agenda_lr: str = "cosseno",
        treinar_apenas_cabeca: bool = False,
        otimizador: str = "sgd",
        ema_decaimento: float = 0.0,
        acumular_gradientes: int = 1,
        paciencia: int = 0,
        avaliar_cada: Optional[int] = None,
        llrd: float = 0.0,
    ) -> TrainingJob:
        """Launch a job thread; raises RuntimeError if one is running."""
        get_model(model_name)  # fail fast on unknown model
        # validate up front (422 at the route, not a failed job); the real
        # optimizer is rebuilt in the worker with the LR schedule
        make_optimizer(lr=lr, kind=otimizador)
        batch_size = int(batch_size)
        if batch_size < 1:
            raise ValueError(f"batch_size deve ser >= 1: {batch_size!r}")
        max_steps = int(max_steps)
        if max_steps < 1:
            raise ValueError(f"max_steps deve ser >= 1: {max_steps!r}")
        if epochs is not None:
            epochs = int(epochs)
            if epochs < 1:
                raise ValueError(f"epochs deve ser >= 1: {epochs!r}")
        eval_fraction = float(eval_fraction)
        if not (0.0 <= eval_fraction < 1.0):
            # 1.0 would silently empty the TRAIN split: zero steps
            raise ValueError(
                f"eval_fraction fora de [0, 1): {eval_fraction!r}"
            )
        if retomar_de is not None:
            retomar_de = str(retomar_de)
            # the id is uuid4().hex[:12]; anything else (separators, '..')
            # would be interpolated into the checkpoint PATH — a traversal
            # could make this job WRITE into another ambiente's registered
            # model dir
            if not re.fullmatch(r"[0-9a-f]{12}", retomar_de):
                raise ValueError(
                    f"retomar_de inválido: {retomar_de!r} (esperado o id "
                    "de um job: 12 dígitos hex)"
                )
        ema_decaimento = float(ema_decaimento)
        if ema_decaimento and not (0.0 < ema_decaimento < 1.0):
            raise ValueError(
                f"ema_decaimento fora de (0, 1): {ema_decaimento!r}"
            )
        acumular_gradientes = int(acumular_gradientes)
        if acumular_gradientes < 1:
            raise ValueError(
                f"acumular_gradientes deve ser >= 1: {acumular_gradientes!r}"
            )
        paciencia = int(paciencia)
        if paciencia < 0:
            raise ValueError(f"paciencia deve ser >= 0: {paciencia!r}")
        llrd = float(llrd)
        if llrd and not (0.0 < llrd < 1.0):
            raise ValueError(
                f"llrd fora de (0, 1): {llrd!r} (0 desliga; valores "
                "típicos 0.6-0.9)"
            )
        if avaliar_cada is not None:
            avaliar_cada = int(avaliar_cada)
            if avaliar_cada < 1:
                raise ValueError(
                    f"avaliar_cada deve ser >= 1: {avaliar_cada!r}"
                )
        if (paciencia or avaliar_cada) and not (0.0 < eval_fraction):
            raise ValueError(
                "paciencia/avaliar_cada requerem eval_fraction > 0 (sem "
                "split de avaliação não há métrica para monitorar)"
            )
        augment = None
        if augmentar:
            # build up front: AugmentConfig validates its ranges, and an
            # invalid mixup/smoothing value should 422 at the route, not
            # fail the job mid-thread
            from ics_tpu_torch.ops.augment import AugmentConfig

            augment = AugmentConfig(
                mixup_alpha=float(mixup_alpha),
                cutmix_alpha=float(cutmix_alpha),
                label_smoothing=float(suavizacao_rotulo),
            )
        elif mixup_alpha or cutmix_alpha or suavizacao_rotulo:
            raise ValueError(
                "mixup_alpha/cutmix_alpha/suavizacao_rotulo requerem "
                "augmentar=true"
            )
        # validate up front (422 at the route, not a failed job): the
        # schedule itself is rebuilt in the worker with the real step count
        make_lr_schedule(lr, max_steps, kind=agenda_lr)
        if pesos_iniciais:
            # resolve + existence-check up front: a missing weights file is
            # the operator's typo and should 422 at the route, not fail the
            # job minutes later mid-thread
            pesos_iniciais = str(self.resolve_pretrained(pesos_iniciais))
        # deployment availability is checked LAST: a malformed request must
        # 422 even when NextCloud is down (validation order = request
        # shape first, environment second); the device after the bytes
        fetch = fetch_bytes or self.fetch_bytes
        if fetch is None:
            raise TrainingUnavailable(
                "nenhuma fonte de bytes configurada (NextCloud indisponível)"
            )
        device = self._device()
        job = TrainingJob(
            id_amb, model_name,
            {"max_steps": max_steps, "batch_size": batch_size, "lr": lr,
             "augmentar": bool(augmentar),
             "mixup_alpha": float(mixup_alpha),
             "cutmix_alpha": float(cutmix_alpha),
             "suavizacao_rotulo": float(suavizacao_rotulo),
             "agenda_lr": agenda_lr,
             "treinar_apenas_cabeca": bool(treinar_apenas_cabeca),
             "otimizador": otimizador,
             "ema_decaimento": ema_decaimento,
             "acumular_gradientes": acumular_gradientes,
             "paciencia": paciencia,
             "avaliar_cada": avaliar_cada,
             "llrd": llrd},
        )
        # resolve the checkpoint dir UP FRONT (a retomar_de job reuses
        # its predecessor's dir) so gc_checkpoints' live-set protects
        # the real dir from the moment the job exists
        job.ckpt_dir = str(
            Path(self.checkpoint_root) / job.id_amb / model_name
            / (retomar_de or job.id_job)
        )
        self._claim_slot(job)
        self._launch(
            job, self._run,
            (job, device, fetch, max_steps, batch_size, lr, epochs, canvas,
             compute_dtype, ativar, seed, eval_fraction, remat,
             usar_sugestoes, sugestao_min_score, retomar_de,
             pesos_iniciais, augment, agenda_lr,
             treinar_apenas_cabeca, otimizador, ema_decaimento,
             acumular_gradientes, paciencia, avaliar_cada, llrd),
            f"train-{job.id_job}",
        )
        return job

    # -- job body (worker thread) -------------------------------------------
    def _run(self, job: TrainingJob, device: torch.device, fetch: BytesProvider,
             max_steps: int,
             batch_size: int, lr: float, epochs: int, canvas: int,
             compute_dtype: str, ativar: bool, seed: int,
             eval_fraction: float = 0.2, remat: bool = False,
             usar_sugestoes: bool = False,
             sugestao_min_score: float = 0.9,
             retomar_de: Optional[str] = None,
             pesos_iniciais: Optional[str] = None,
             augment=None, agenda_lr: str = "cosseno",
             treinar_apenas_cabeca: bool = False,
             otimizador: str = "sgd",
             ema_decaimento: float = 0.0,
             acumular_gradientes: int = 1,
             paciencia: int = 0,
             avaliar_cada: Optional[int] = None,
             llrd: float = 0.0) -> None:
        try:
            job.status = "executando"
            # multipla_escolha ambientes train multi-label automatically:
            # every active option of an image is part of its multi-hot
            # target, the loss is per-class sigmoid BCE and serving applies
            # sigmoid scores (metricas.multi_rotulo -> engine multi_label)
            from ics_tpu_torch.db.models import Ambiente

            with self.db.session() as s:
                ambiente = s.get(Ambiente, str(job.id_amb))
                multi_label = bool(ambiente is not None and ambiente.multipla_escolha)
            job.params["multi_rotulo"] = multi_label
            examples, class_map = labeled_examples(
                self.db, job.id_amb, multi_label=multi_label
            )
            job.n_examples = len(examples)
            if len(examples) < 2 or len(class_map) < 2:
                raise RuntimeError(
                    f"dados insuficientes: {len(examples)} exemplos, "
                    f"{len(class_map)} opções (mínimo 2/2)"
                )
            spec = get_model(job.model_name)
            num_classes = len(class_map)
            if pesos_iniciais:
                # pretrained backbone + head re-initialized to the
                # ambiente's option count (train/pretrained.py) — the
                # fine-tune starts from real features, not noise
                from ics_tpu_torch.train.pretrained import load_pretrained

                model, _ = load_pretrained(
                    job.model_name, pesos_iniciais,
                    num_classes=num_classes, seed=seed,
                )
                job.params["pesos_iniciais"] = pesos_iniciais
            else:
                model = spec.build(num_classes=num_classes)
                model.init_weights(torch.Generator().manual_seed(seed))
            if device.type == "cuda":
                disable_tf32()
            model = model.to(device)
            dtype = _dtype(compute_dtype)
            # retomar_de: reuse a previous job's checkpoint dir (same
            # ambiente+model; dirs are keyed by job id) — FineTuner.run
            # restores its newest step, so a cancelled/crashed job's work
            # is resumable through the product surface (a dir the JAX
            # trainer wrote is refused there, with the conversion tool's
            # name, and a converted one for its missing optimizer state).
            # (Resolved in start(); GC protects it from job creation on.)
            ckpt_dir = Path(job.ckpt_dir)
            if retomar_de and not ckpt_dir.is_dir():
                raise RuntimeError(
                    f"checkpoint de retomada não encontrado: {retomar_de} "
                    f"(modelo {job.model_name}, ambiente {job.id_amb})"
                )
            from ics_tpu_torch.core.config import settings
            from ics_tpu_torch.parallel.mesh import train_mesh_from_settings

            train_mesh = train_mesh_from_settings(settings)
            if train_mesh is not None:
                n_train_dev = int(train_mesh.devices.size)
                if batch_size % n_train_dev:
                    raise RuntimeError(
                        f"batch_size={batch_size} não divide pelos "
                        f"{n_train_dev} devices de treino "
                        f"(TPU_TRAIN_DEVICES={settings.TPU_TRAIN_DEVICES!r})"
                    )
            tuner = FineTuner(
                model,
                optimizer=make_optimizer(
                    # the schedule counter advances once per APPLY step,
                    # so the curve spans the EFFECTIVE step count, not the
                    # micro-step count
                    lr=make_lr_schedule(
                        lr, max(1, -(-max_steps // acumular_gradientes)),
                        kind=agenda_lr,
                    ),
                    kind=otimizador,
                ),
                image_size=spec.image_size,
                resize_short=spec.resize_short,
                compute_dtype=dtype,
                checkpoint_dir=str(ckpt_dir),
                remat=remat,
                augment=augment,
                seed=seed,
                linear_probe=treinar_apenas_cabeca,
                multi_label=multi_label,
                ema_decay=ema_decaimento,
                grad_accum=acumular_gradientes,
                llrd=llrd,
                mesh=train_mesh,
            )
            train_examples, eval_examples = split_examples(
                examples, eval_fraction=eval_fraction, seed=seed
            )
            if usar_sugestoes:
                # distillation: high-confidence model suggestions become
                # pseudo-labels for images the specialists haven't reached
                # — TRAIN only; eval stays purely human-labeled
                pseudo = suggested_examples(
                    self.db, job.id_amb, class_map,
                    min_score=sugestao_min_score,
                    exclude_hashes={e["content_hash"] for e in examples},
                    multi_label=multi_label,
                )
                train_examples = train_examples + pseudo
                job.n_sugestoes = len(pseudo)
            # n_examples keeps its meaning (ALL labeled examples, set when
            # the job was admitted); the train-split size incl. pseudo-
            # labels is its own field
            job.n_train = len(train_examples)
            # periodic eval (paciencia > 0 and/or avaliar_cada): eval on
            # the held-out split every eval_every steps; the BEST snapshot
            # gets registered, and with paciencia > 0 the loop also stops
            # after that many consecutive non-improving evals. The eval
            # split is decoded ONCE, up front, BEFORE the train prefetch
            # starts — the bytes provider is single-threaded (private
            # event loop) and periodic eval must never race the producer.
            eval_fn = None
            eval_every = None
            eval_cached = None
            if (paciencia or avaliar_cada) and eval_examples:
                eval_cached = list(batch_iterator(
                    eval_examples, fetch, batch_size=batch_size,
                    canvas=canvas, shuffle=False, epochs=1,
                    with_counts=True, num_classes=num_classes,
                ))
                eval_every = avaliar_cada or max(1, max_steps // 5)
                eval_fn = _make_periodic_eval(
                    model, spec, dtype, eval_cached,
                    multi_label=multi_label,
                    use_ema=bool(ema_decaimento),
                )
                job.params["avaliar_cada"] = eval_every
            elif paciencia or avaliar_cada:
                # start() validated eval_fraction > 0, but split_examples
                # disables the split below 5 examples — say so instead of
                # silently running without early stopping
                job.params["aviso"] = (
                    "early stopping/avaliação periódica desativados: "
                    f"dataset pequeno demais para um split de avaliação "
                    f"({len(examples)} exemplos, mínimo 5)"
                )
                logger.warning("treinamento %s: %s", job.id_job, job.params["aviso"])
            # prefetch: decode the next batch on host while the device runs
            # the current step (train/data.py::prefetch)
            batches = prefetch(
                batch_iterator(
                    train_examples, fetch, batch_size=batch_size,
                    canvas=canvas, seed=seed, epochs=epochs,
                    num_classes=num_classes,
                )
            )
            try:
                state_dict, opt_state, history = tuner.run(
                    batches, max_steps=max_steps,
                    checkpoint_every=max(max_steps // 2, 1),
                    on_step=job.history.append,  # live progress
                    should_stop=job.cancel_event.is_set,
                    eval_every=eval_every, eval_fn=eval_fn,
                    patience=paciencia,
                )
            finally:
                # stop the producer BEFORE eval: the NextCloud bytes provider
                # is single-threaded (private event loop) — a still-running
                # prefetch thread would race the eval's fetches on the same
                # loop (and waste depth+1 batches of downloads)
                batches.close()
            if job.cancel_event.is_set():
                # operator abort: nothing is registered/promoted; the last
                # checkpoint stays on disk (resumable / inspectable)
                job.status = "cancelado"
                logger.info("treinamento %s cancelado após %d passos", job.id_job, len(history))
                return
            if not history:
                # zero steps executed (every batch's fetch/decode failed —
                # NextCloud down — or the train split came out empty):
                # registering (let alone PROMOTING) a version whose dir has no
                # checkpoint would fail every later inference for the ambiente
                raise RuntimeError(
                    "nenhum passo de treino executado (fetch/decodificação "
                    "falhou para todos os batches, ou o split de treino "
                    "ficou vazio) — nada foi registrado"
                )
            final = history[-1]
            best = tuner.best
            if best is not None:
                # early stopping: register/serve the BEST periodic-eval
                # snapshot, not the last step (with EMA on the snapshot already
                # IS the shadow with the model's buffers — eval_fn evaluated
                # it). Written as the LATEST checkpoint (step+1, the optimizer
                # state unchanged); serving's get_trained restores latest, so
                # the registered version serves the best weights.
                state_dict = best["state_dict"]
                if ema_decaimento:
                    # the final step's EMA shadow tracks the DISCARDED final
                    # weights — re-anchor it on the snapshot's parameters so a
                    # retomar_de resume's shadow corresponds to what it restores
                    opt_state = replace_ema_params(opt_state, state_dict)
                tuner.checkpoint.save(
                    int(final.get("step", 0)) + 1, state_dict, opt_state,
                    {"step": int(final.get("step", 0)),
                     "melhor_passo": int(best["step"]),
                     "melhor_eval": float(best["metric"]),
                     "ema_final": bool(ema_decaimento)},
                )
                model.load_state_dict(state_dict)
                job.params["melhor_passo"] = int(best["step"])
                job.params["melhor_eval"] = float(best["metric"])
                job.params["parou_cedo"] = bool(tuner.stopped_early)
                if ema_decaimento:
                    job.params["ema_final"] = True
            elif ema_decaimento:
                # serve/eval the EMA shadow weights (the standard "EMA as
                # final model" recipe): the shadow's parameters with the
                # model's buffers, written as the LATEST checkpoint (step+1,
                # with the unchanged optimizer state — a resume continues from
                # the EMA point). Serving's get_trained restores latest, so the
                # registered version serves the EMA weights.
                ema = find_ema_params(opt_state)
                if ema is not None:
                    state_dict = _with_shadow(state_dict, ema)
                    tuner.checkpoint.save(
                        int(final.get("step", 0)) + 1, state_dict, opt_state,
                        {"step": int(final.get("step", 0)), "ema_final": True},
                    )
                    model.load_state_dict(state_dict)
                    job.params["ema_final"] = True
            eval_accuracy = None
            eval_metrics = None
            eval_calibrado = None
            limiar = None
            temperatura = None
            eval_calibracao = None
            eval_por_classe = None
            if eval_examples:
                # periodic eval already decoded these exact batches — reuse
                # them instead of re-downloading/re-decoding the whole split
                eval_batches = (
                    iter(eval_cached) if eval_cached is not None
                    else batch_iterator(
                        eval_examples, fetch, batch_size=batch_size,
                        canvas=canvas, shuffle=False, epochs=1,
                        with_counts=True, num_classes=num_classes,
                    )
                )
                if multi_label:
                    from ics_tpu_torch.train.finetune import (
                        calibrate_multilabel_threshold,
                        collect_multilabel_scores,
                        multilabel_metrics,
                        multilabel_per_class_metrics,
                    )

                    probs, targets = collect_multilabel_scores(
                        model, eval_batches, image_size=spec.image_size,
                        resize_short=spec.resize_short, compute_dtype=dtype,
                    )
                    if probs is not None:
                        eval_metrics = multilabel_metrics(probs, targets)
                        # serving threshold calibrated on the eval split
                        # (micro-F1 sweep; stays 0.5 on tiny splits)
                        limiar, eval_calibrado = calibrate_multilabel_threshold(probs, targets)
                        # the comparable scalar for multi-label is exact-match
                        # (strictest) at the SERVING threshold
                        eval_accuracy = eval_calibrado["exact_match"]
                        # per-class view at the SERVING threshold: which
                        # options the model never fires on (micro hides it)
                        eval_por_classe = {
                            "por_classe": multilabel_per_class_metrics(probs, targets, limiar),
                        }
                else:
                    from ics_tpu_torch.train.finetune import (
                        calibrate_temperature,
                        collect_logits,
                        per_class_metrics,
                    )

                    logits, labels = collect_logits(
                        model, eval_batches, image_size=spec.image_size,
                        resize_short=spec.resize_short, compute_dtype=dtype,
                    )
                    if logits is not None:
                        eval_accuracy = float((logits.argmax(-1) == labels).mean())
                        # softmax temperature fitted on the eval split (NLL
                        # golden-section; T=1 on tiny splits) — serving folds
                        # it into the head weights (runtime/service.py
                        # get_trained)
                        temperatura, eval_calibracao = calibrate_temperature(logits, labels)
                        # confusion matrix + per-class P/R/F1: which options
                        # the model confuses (accuracy hides it)
                        eval_por_classe = per_class_metrics(logits, labels, num_classes)
                if eval_por_classe is not None:
                    # label each row with its option id (rows are
                    # index-ordered; data.py::inverse_map)
                    inv = inverse_map(class_map)
                    for row in eval_por_classe["por_classe"]:
                        row["id_opc"] = inv.get(row["classe"])
                job.eval_accuracy = eval_accuracy
            if job.cancel_event.is_set():
                # a 202'd cancel that landed during eval must still win —
                # registering/promoting a cancelled model would contradict
                # the route contract and the audit trail
                job.status = "cancelado"
                logger.info("treinamento %s cancelado durante avaliação", job.id_job)
                return
            with self.db.session() as s:
                row = modelo_crud.registrar_modelo(
                    s,
                    id_amb=job.id_amb,
                    nome_modelo=job.model_name,
                    num_classes=num_classes,
                    class_map=class_map,
                    dir_checkpoint=str(ckpt_dir),
                    passo=int(final.get("step", 0)),
                    metricas={
                        "loss_final": final.get("loss"),
                        "accuracy_final": final.get("accuracy"),
                        "eval_accuracy": eval_accuracy,
                        "exemplos_treino": len(train_examples),
                        "exemplos_eval": len(eval_examples),
                        "historico": history[-20:],
                        "exemplos": len(examples),
                        "otimizador": otimizador,
                        "ema_decaimento": ema_decaimento or None,
                        # early stopping (paciencia>0): which snapshot got
                        # registered and whether the loop cut short
                        "melhor_passo": int(best["step"]) if best is not None else None,
                        "melhor_eval": float(best["metric"]) if best is not None else None,
                        "parou_cedo": bool(tuner.stopped_early),
                        # serving reads these: sigmoid scores + the calibrated
                        # >=limiar suggestion set instead of softmax/top-1
                        # (limiar None -> 0.5 default)
                        "multi_rotulo": multi_label,
                        "eval_multilabel": eval_metrics,
                        "eval_multilabel_calibrado": eval_calibrado,
                        "limiar": limiar,
                        # single-label: softmax temperature fitted on the eval
                        # split; serving folds it into the head so suggestion
                        # scores are calibrated probabilities
                        "temperatura": temperatura,
                        "eval_calibracao": eval_calibracao,
                        # per-class diagnostics on the eval split: single-label
                        # carries matriz_confusao + f1_macro; multi-label the
                        # per-class P/R/F1 at the serving limiar
                        "eval_por_classe": eval_por_classe,
                    },
                    ativar=ativar,
                )
                s.commit()
                job.id_mod = str(row.id_mod)
                job.versao = row.versao
            job.status = "concluido"
            logger.info(
                "treinamento %s concluído: modelo %s v%s (%d passos)",
                job.id_job, job.model_name, job.versao, len(history),
            )
        except Exception as exc:
            job.status = "falhou"
            job.error = str(exc)
            logger.exception("treinamento %s falhou", job.id_job)
        finally:
            job.finished_at = tz.utcnow()
            with self._lock:
                if self._running is job:
                    self._running = None

