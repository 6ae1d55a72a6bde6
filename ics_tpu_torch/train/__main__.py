"""Fine-tune CLI of the port: ``python -m ics_tpu_torch.train --ambiente
<id_amb> [...]``, with the reference CLI's flags and exit codes.

Operator-facing twin of ``POST /treinamento/ambiente/{id}``: trains on the
ambiente's specialist labels on the card, checkpoints under
``TPU_WEIGHTS_DIR`` (``step_<n>.pt``), registers the result in
``modelos_treinados`` and (by default) promotes it to serving. The bytes come
from NextCloud (``NEXTCLOUD_BASE_URL``). Prints each step, then the job's
JSON; exits 0 when the job ends ``concluido``, 1 otherwise, 2 when the
database is unreachable.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ics_tpu_torch.train",
        description="Fine-tune a model on an ambiente's specialist labels.",
    )
    parser.add_argument("--ambiente", required=True, help="id_amb to train on")
    parser.add_argument("--modelo", default="resnet50")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--canvas", type=int, default=512)
    parser.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    parser.add_argument(
        "--no-ativar", action="store_true",
        help="register the version without promoting it to serving",
    )
    parser.add_argument(
        "--retomar-de", default=None, metavar="ID_JOB",
        help="resume from a previous job's checkpoint (same ambiente+model)",
    )
    parser.add_argument(
        "--usar-sugestoes", action="store_true",
        help="distillation: mix in high-confidence model suggestions as "
             "pseudo-labels for images without human labels",
    )
    parser.add_argument(
        "--sugestao-min-score", type=float, default=0.9,
        help="minimum top-1 score for a suggestion to count (default 0.9)",
    )
    parser.add_argument(
        "--pesos-iniciais", default=None, metavar="ARQUIVO",
        help="pretrained starting weights: file name under "
             "{TPU_WEIGHTS_DIR}/pretrained/ or an absolute path "
             "(.npz native/torch layout or torch .pt/.pth)",
    )
    parser.add_argument(
        "--remat", action="store_true",
        help="per-block rematerialization: trade ~1/3 extra forward FLOPs "
             "for much lower activation memory (deep models/large batches)",
    )
    parser.add_argument(
        "--sem-augmentar", action="store_true",
        help="disable the on-device crop/flip augmentation (it is ON by "
             "default; ops/augment.py)",
    )
    parser.add_argument(
        "--mixup-alpha", type=float, default=0.0,
        help="mixup Beta(a, a); 0 disables (0.2 is the standard setting)",
    )
    parser.add_argument(
        "--cutmix-alpha", type=float, default=0.0,
        help="CutMix Beta(a, a); 0 disables (1.0 is the standard "
             "setting; with mixup on too, 50/50 per-batch switch)",
    )
    parser.add_argument(
        "--suavizacao-rotulo", type=float, default=0.0,
        help="label smoothing in [0, 1); 0.1 is the standard setting",
    )
    parser.add_argument(
        "--agenda-lr", default="cosseno", choices=["cosseno", "constante"],
        help="LR schedule: linear warmup + cosine decay to 1%% of peak "
             "(default) or constant",
    )
    parser.add_argument(
        "--otimizador", default="sgd", choices=["sgd", "adamw"],
        help="update rule: momentum SGD (conv default) or AdamW (the "
             "standard recipe for ViT/Swin/ConvNeXt fine-tunes)",
    )
    parser.add_argument(
        "--ema-decaimento", type=float, default=0.0,
        help="EMA of the weights with this decay (e.g. 0.999); the shadow "
             "weights become the registered/served model. 0 disables",
    )
    parser.add_argument(
        "--acumular-gradientes", type=int, default=1,
        help="apply the optimizer once every N micro-batches with the "
             "averaged gradient (effective batch = batch_size x N); for "
             "effective batches larger than device memory allows",
    )
    parser.add_argument(
        "--paciencia", type=int, default=0,
        help="early stopping: stop after N consecutive non-improving "
             "periodic evals; the BEST snapshot is registered. 0 disables",
    )
    parser.add_argument(
        "--avaliar-cada", type=int, default=None, metavar="PASSOS",
        help="periodic-eval cadence in steps (default with --paciencia: "
             "steps/5); also enables best-snapshot registration alone",
    )
    parser.add_argument(
        "--llrd", type=float, default=0.0,
        help="layer-wise LR decay factor in (0, 1): each block toward the "
             "input gets this factor less LR (0.6-0.9 typical; 0 disables)",
    )
    parser.add_argument(
        "--apenas-cabeca", action="store_true",
        help="linear probe: train only the classifier head on frozen "
             "backbone features (eval-mode BN) — the right recipe for "
             "tiny labeled sets with --pesos-iniciais",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ics_tpu_torch.core.config import settings
    from ics_tpu_torch.db.engine import get_database
    from ics_tpu_torch.sync.nextcloud_client import NextCloudClient
    from ics_tpu_torch.train.job import TrainingJobManager, nextcloud_bytes_provider

    db = get_database()
    if not db.wait_until_ready():
        print("database unreachable", file=sys.stderr)
        return 2
    fetch = None
    if settings.NEXTCLOUD_BASE_URL:
        fetch = nextcloud_bytes_provider(NextCloudClient)
    manager = TrainingJobManager(
        db, settings.TPU_WEIGHTS_DIR, fetch_bytes=fetch
    )
    job = manager.start(
        id_amb=args.ambiente,
        model_name=args.modelo,
        max_steps=args.steps,
        batch_size=args.batch_size,
        lr=args.lr,
        epochs=args.epochs,
        canvas=args.canvas,
        compute_dtype=args.precision,
        ativar=not args.no_ativar,
        remat=args.remat,
        usar_sugestoes=args.usar_sugestoes,
        sugestao_min_score=args.sugestao_min_score,
        retomar_de=args.retomar_de,
        pesos_iniciais=args.pesos_iniciais,
        augmentar=not args.sem_augmentar,
        mixup_alpha=args.mixup_alpha,
        cutmix_alpha=args.cutmix_alpha,
        suavizacao_rotulo=args.suavizacao_rotulo,
        agenda_lr=args.agenda_lr,
        treinar_apenas_cabeca=args.apenas_cabeca,
        otimizador=args.otimizador,
        ema_decaimento=args.ema_decaimento,
        acumular_gradientes=args.acumular_gradientes,
        paciencia=args.paciencia,
        avaliar_cada=args.avaliar_cada,
        llrd=args.llrd,
    )
    last_len = 0
    while job.status in ("pendente", "executando"):
        time.sleep(1.0)
        for rec in job.history[last_len:]:
            extra = (f" eval={rec['eval']:.3f}" if "eval" in rec else "")
            print(
                f"step {rec['step']}: loss={rec['loss']:.4f} "
                f"acc={rec['accuracy']:.3f}" + extra
            )
        last_len = len(job.history)
    print(json.dumps(job.to_dict(), ensure_ascii=False, default=str, indent=2))
    return 0 if job.status == "concluido" else 1


if __name__ == "__main__":
    raise SystemExit(main())
