"""Training data source: the NextCloud-synced corpus + human labels
(counterpart of ``ics_tpu/train/data.py``, unchanged in behaviour).

BASELINE config 5 trains on "NextCloud-synced dataset": images live in the
``imagens`` table (bytes fetched by content identity), labels come from the
specialists' classifications (``classificacoes`` x ``opcoes``). Option ids
are mapped to contiguous class indices per ambiente.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from ics_tpu_torch.db.engine import Database
from ics_tpu_torch.runtime.decode import decode_image, stage_batch

logger = logging.getLogger(__name__)

BytesProvider = Callable[[str, str], bytes]  # (content_hash, caminho) -> bytes


def labeled_examples(
    db: Database, id_amb: str, multi_label: bool = False,
    class_map: Optional[dict] = None,
) -> tuple[list[dict], dict[str, int]]:
    """All active (image, option) labels of an ambiente + option->class map.

    Single-label (default): for multi-label images the first option (by
    option text order) wins — the right collapse for
    ``multipla_escolha=False`` ambientes, where multiple active labels can
    only come from different specialists disagreeing.

    ``multi_label=True`` (``multipla_escolha`` ambientes): every active
    option of an image becomes part of its multi-hot target; examples carry
    ``"labels": sorted list of class indices`` instead of ``"label"``.

    ``class_map`` (optional): use a FIXED option->index map instead of the
    ambiente's current option set — re-evaluating a registered model must
    index labels exactly as that model was trained (options added since
    are unknown to it; their labels are excluded, not remapped).
    """
    with db.session() as s:
        fixed_map = class_map is not None
        if class_map is None:
            opcoes = s.fetchall(
                "SELECT id_opc, texto FROM opcoes WHERE id_amb = ? "
                "ORDER BY texto",
                [str(id_amb)],
            )
            class_map = {r["id_opc"]: i for i, r in enumerate(opcoes)}
        else:
            class_map = {str(k): int(v) for k, v in class_map.items()}
        # with a FIXED map, restrict the label rows BEFORE the single-label
        # GROUP-BY collapse: otherwise an image whose min-text option was
        # created after training would be dropped entirely instead of
        # falling back to its other, model-known label
        known_filter = ""
        known_args: list[str] = []
        if fixed_map and class_map:
            known_filter = (
                " AND c.id_opc IN ("
                + ",".join("?" * len(class_map)) + ")"
            )
            known_args = list(class_map)
        if multi_label:
            rows = s.fetchall(
                """
                SELECT DISTINCT c.id_img AS content_hash, i.caminho_img,
                       c.id_opc
                FROM classificacoes c
                JOIN imagens i ON i.content_hash = c.id_img
                JOIN opcoes o ON o.id_opc = c.id_opc
                JOIN ambientes_conjuntos_imagens aci ON aci.id_cnj = i.id_cnj
                WHERE c.ativo = 1 AND aci.id_amb = ? AND o.id_amb = ?
                  AND i.existe_no_nextcloud = 1
                """,
                [str(id_amb), str(id_amb)],
            )
            by_image: dict[str, dict] = {}
            for r in rows:
                if r["id_opc"] not in class_map:
                    continue
                ex = by_image.setdefault(
                    r["content_hash"],
                    {
                        "content_hash": r["content_hash"],
                        "caminho_img": r["caminho_img"],
                        "labels": [],
                    },
                )
                ex["labels"].append(class_map[r["id_opc"]])
            examples = sorted(
                by_image.values(), key=lambda e: e["content_hash"]
            )
            for ex in examples:
                ex["labels"].sort()
            return examples, class_map
        # min-text winner via ROW_NUMBER, not `GROUP BY id_img` with a bare
        # c.id_opc next to MIN(o.texto): that shape leans on SQLite's
        # min/max bare-column special case and is a hard ERROR on postgres
        # ("column must appear in the GROUP BY clause") — same portable
        # window form as suggested_examples (self-review r3)
        rows = s.fetchall(
            """
            SELECT content_hash, caminho_img, id_opc FROM (
                SELECT c.id_img AS content_hash, i.caminho_img, c.id_opc,
                       ROW_NUMBER() OVER (
                           PARTITION BY c.id_img
                           ORDER BY o.texto, c.id_opc
                       ) AS rn
                FROM classificacoes c
                JOIN imagens i ON i.content_hash = c.id_img
                JOIN opcoes o ON o.id_opc = c.id_opc
                JOIN ambientes_conjuntos_imagens aci
                     ON aci.id_cnj = i.id_cnj
                WHERE c.ativo = 1 AND aci.id_amb = ? AND o.id_amb = ?
                  AND i.existe_no_nextcloud = 1
                """ + known_filter + """
            ) t WHERE rn = 1
            """,
            [str(id_amb), str(id_amb)] + known_args,
        )
    examples = [
        {
            "content_hash": r["content_hash"],
            "caminho_img": r["caminho_img"],
            "label": class_map[r["id_opc"]],
        }
        for r in rows
        if r["id_opc"] in class_map
    ]
    return examples, class_map


def inverse_map(class_map: dict) -> dict[int, str]:
    """class index -> id_opc (the inversion eval paths label rows with;
    row-level twin: crud/modelo_crud.py::inverse_class_map)."""
    return {int(v): str(k) for k, v in class_map.items()}


def suggested_examples(
    db: Database,
    id_amb: str,
    class_map: dict[str, int],
    min_score: float = 0.9,
    exclude_hashes: Optional[set] = None,
    multi_label: bool = False,
) -> list[dict]:
    """Model-suggestion pseudo-labels for semi-supervised fine-tuning
    (distillation): high-confidence ``sugestoes_modelo`` rows for images
    the specialists have NOT labeled yet — human labels always win.

    Latest suggestion per image wins (re-classification after a model
    promotion supersedes older suggestions). Portable SQL (window
    function) — runs on both the sqlite and postgres dialects.
    """
    exclude = exclude_hashes or set()
    with db.session() as s:
        # the window runs over ALL suggestions and the threshold applies to
        # the WINNER: a newer low-confidence suggestion supersedes (and
        # disqualifies) an older high-confidence one — stale labels from a
        # demoted model must not survive. Membership join mirrors
        # labeled_examples: images detached from the ambiente don't train.
        rows = s.fetchall(
            """
            SELECT content_hash, caminho_img, id_opc, classes FROM (
                SELECT s.id_img AS content_hash, i.caminho_img, s.id_opc,
                       s.classes, s.score,
                       ROW_NUMBER() OVER (
                           PARTITION BY s.id_img
                           ORDER BY s.data_criado DESC, s.score DESC
                       ) AS rn
                FROM sugestoes_modelo s
                JOIN imagens i ON i.content_hash = s.id_img
                JOIN ambientes_conjuntos_imagens aci ON aci.id_cnj = i.id_cnj
                WHERE s.id_amb = ? AND aci.id_amb = ?
                  AND i.existe_no_nextcloud = 1
            ) t WHERE rn = 1 AND score >= ?
            """,
            [str(id_amb), str(id_amb), float(min_score)],
        )
    if multi_label:
        # pseudo multi-hot: every class the winning suggestion scored at or
        # above the threshold (sigmoid scores are independent, so several
        # can qualify); falls back to the top-1 id_opc for legacy rows
        import json as _json

        out = []
        for r in rows:
            if r["content_hash"] in exclude:
                continue
            classes = r["classes"]
            if isinstance(classes, str):
                try:
                    classes = _json.loads(classes)
                except ValueError:
                    classes = []
            labels = sorted(
                {
                    class_map[c["id_opc"]]
                    for c in (classes or [])
                    if isinstance(c, dict) and c.get("id_opc") in class_map
                    and float(c.get("score") or 0.0) >= min_score
                }
            )
            if not labels and r["id_opc"] in class_map:
                labels = [class_map[r["id_opc"]]]
            if labels:
                out.append(
                    {
                        "content_hash": r["content_hash"],
                        "caminho_img": r["caminho_img"],
                        "labels": labels,
                        "fonte": "sugestao",
                    }
                )
        return out
    return [
        {
            "content_hash": r["content_hash"],
            "caminho_img": r["caminho_img"],
            "label": class_map[r["id_opc"]],
            "fonte": "sugestao",
        }
        for r in rows
        if r["id_opc"] in class_map and r["content_hash"] not in exclude
    ]


def split_examples(
    examples: list[dict], eval_fraction: float = 0.2, seed: int = 0
) -> tuple[list[dict], list[dict]]:
    """Deterministic train/eval split (shuffled by seed, stratification-free
    — ambiente label sets are small). eval_fraction=0 -> everything trains.
    """
    if eval_fraction <= 0 or len(examples) < 5:
        return list(examples), []
    order = np.random.default_rng(seed).permutation(len(examples))
    n_eval = max(1, int(len(examples) * eval_fraction))
    eval_idx = set(order[:n_eval].tolist())
    train = [ex for i, ex in enumerate(examples) if i not in eval_idx]
    held = [ex for i, ex in enumerate(examples) if i in eval_idx]
    return train, held


def batch_iterator(
    examples: list[dict],
    fetch_bytes: BytesProvider,
    batch_size: int = 32,
    canvas: int = 512,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = 1,
    with_counts: bool = False,
    num_classes: Optional[int] = None,
) -> Iterator[tuple]:
    """Yields (canvas_u8 [B,C,C,3], sizes [B,2], labels [B]) batches.

    Incomplete final batches are padded by repeating examples (static
    shapes); decode happens on host, resize/normalize on device inside the
    train step. ``with_counts=True`` appends the count of REAL (non-padded,
    successfully decoded) rows per batch — padding can also come from
    fetch/decode failures, so consumers that score per-example (eval) must
    not infer it from the dataset size.

    Examples with ``"labels"`` (multi-label, ``labeled_examples(...,
    multi_label=True)``) require ``num_classes`` and yield multi-hot
    float32 [B, num_classes] targets instead of int labels.
    """
    if not examples:
        return
    multi = "labels" in examples[0]
    if multi and num_classes is None:
        raise ValueError("exemplos multi-rótulo exigem num_classes")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(examples))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            n_orig = len(idx)  # rows beyond this are repeat-padding
            while len(idx) < batch_size:  # pad to the static batch
                idx = np.concatenate([idx, idx[: batch_size - len(idx)]])
            images, labels = [], []
            n_real = 0
            for pos, i in enumerate(idx):
                ex = examples[int(i)]
                try:
                    data = fetch_bytes(ex["content_hash"], ex["caminho_img"])
                    images.append(decode_image(data))
                    labels.append(ex["labels"] if multi else ex["label"])
                    if pos < n_orig:
                        # repeat-padded rows must NOT count as real: eval
                        # consumers slice [:n_real] and a tail batch of 1
                        # example repeated to the static shape would
                        # otherwise weight that example batch_size times
                        # (and could sneak a tiny split past calibration's
                        # min-examples gate)
                        n_real += 1
                except Exception as exc:
                    logger.warning(
                        "pulando exemplo %s: %s", ex["content_hash"][:8], exc
                    )
            if not images:
                continue
            while len(images) < batch_size:
                images.append(images[-1])
                labels.append(labels[-1])
            canvas_batch, sizes = stage_batch(images, canvas=canvas)
            if multi:
                hot = np.zeros((batch_size, num_classes), np.float32)
                for row, cls in enumerate(labels):
                    hot[row, cls] = 1.0
                out = (canvas_batch, sizes, hot)
            else:
                out = (canvas_batch, sizes, np.asarray(labels, np.int32))
            yield (out + (n_real,)) if with_counts else out
        epoch += 1


def prefetch(batches: Iterable, depth: int = 2) -> Iterator:
    """Overlap host-side batch production with device compute.

    ``batch_iterator`` fetches + decodes synchronously, so without this the
    device idles during every batch's host work and the host idles
    during every device step. A producer thread keeps up to ``depth``
    staged batches ready (decode is PIL/libjpeg C code — it releases the
    GIL, so the producer genuinely runs during the consumer's step).

    Exceptions in the producer propagate to the consumer at the point of
    ``next()``. Closing the iterator (generator ``close`` / early
    ``break``) signals the producer to stop AND joins it — after
    ``close()`` returns, no fetch/decode is in flight (required by
    single-threaded bytes providers like ``nextcloud_bytes_provider``,
    whose private event loop must not be entered from two threads).
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in batches:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as exc:  # re-raised consumer-side
            _put(exc)

    thread = threading.Thread(target=produce, name="train-prefetch",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # bounded: the producer exits at its next _put() (it finishes at
        # most the in-flight batch's fetches first)
        thread.join()
