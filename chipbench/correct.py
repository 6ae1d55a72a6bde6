"""What decides ``correct`` in a classify cell.

Once the window has closed and the program is freed, a sample of
``SAMPLE`` of the window's answered requests, drawn from the seed with the
largest image among them, is run through the plain reference
(``chipbench.reference``) from the same JPEG bytes and the same weights,
and each served answer (the top five classes and their probabilities) is
judged by it:

- ``top1_gap``: how far the reference's logit of the served first class
  lies below the reference's best logit, in units of the standard
  deviation of that image's reference logits; the widest over the sample.
  Two classes a rounding apart may swap; a wrong decode, a wrong image or a
  wrong answer puts a class far below the best;
- ``score_gap``: the widest |log(served probability) - log(reference
  probability)| over the sample's served classes, in nats: how far the
  served scores sit from the reference's;
- ``top1_gap_mean`` and ``score_gap_mean``: the same gaps (the widest of
  each answer's five for the score) averaged over the sample, and
  ``top1_gap_p95``, the 95th percentile of the first. A random network
  amplifies the program's rounding, and the widest gap of a large sample
  then reaches into the control's range where the mean does not.

Each is compared where ``limits/<cell>.json`` gives it a limit, set from
the readings that ``PERF.md`` gives: a number whose control reading is not
three times its sound runs' has no limit in that cell. Exact counts beside
them, limit 0: requests of the window that failed or never came, answers
that did not come from a device-decode lane, and answers that are not five
distinct classes with finite probabilities in descending order.

The control (``control=True``; ``chipbench/readings.py`` and the tests) is
the reference in float8 e4m3 on the same images, put in the program's
place: its answers for the sampled requests are the five classes and
probabilities that float8 puts first, and they are judged by the same
function and the same limits as the program's (``judge``, ``verdict``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from chipbench import load
from chipbench.reference import models, preprocess

SAMPLE = 256
COMPARED = ("top1_gap", "top1_gap_mean", "top1_gap_p95", "score_gap", "score_gap_mean")
BLOCK = 16


def sample(window: load.Window, blobs: list[bytes], seed: int, k: int = SAMPLE) -> list:
    answered = [r for r in window.in_window() if r.ok]
    if not answered:
        return []
    rng = np.random.default_rng([seed, 31])
    picked = [answered[i] for i in sorted(rng.choice(len(answered), min(k, len(answered)),
                                                     replace=False))]
    largest = max(answered, key=lambda r: len(blobs[r.image]))
    if largest not in picked:
        picked.append(largest)
    return picked


def malformed(answer: dict, num_classes: int) -> bool:
    classes, scores = answer.get("top_classes", []), answer.get("scores", [])
    return (len(classes) != 5 or len(set(classes)) != 5 or len(scores) != 5
            or any(not 0 <= c < num_classes for c in classes)
            or any(not math.isfinite(s) or s <= 0 for s in scores)
            or any(a < b for a, b in zip(scores, scores[1:])))


@torch.no_grad()
def reference_logits(cfg: dict, sd: dict, blobs: list[bytes], device, quant=None) -> torch.Tensor:
    """[N, classes] float32 on the host, in blocks of ``BLOCK`` images."""
    out = []
    for i in range(0, len(blobs), BLOCK):
        x = preprocess.preprocess(blobs[i:i + BLOCK], cfg, device)
        out.append(models.logits(cfg, sd, x, quant=quant).float().cpu())
    return torch.cat(out) if out else torch.empty((0, cfg["num_classes"]))


def gaps(z: torch.Tensor, classes: list, scores: list) -> tuple[float, float]:
    """(top1 gap in logit standard deviations, widest log-probability gap)."""
    logp = torch.log_softmax(z.double(), dim=-1)
    top1 = float((z.max() - z[classes[0]]) / z.std())
    score = max(abs(math.log(s) - float(logp[c])) for c, s in zip(classes, scores))
    return top1, score


def summarise(pairs: list) -> dict:
    """The widest, the mean and the 95th percentile of the gaps over the
    sample."""
    if not pairs:
        return {name: 0.0 for name in COMPARED}
    top1, score = zip(*pairs)
    return {"top1_gap": max(top1), "top1_gap_mean": sum(top1) / len(top1),
            "top1_gap_p95": load.percentile(list(top1), 95),
            "score_gap": max(score), "score_gap_mean": sum(score) / len(score)}


def judge(cfg: dict, limits: dict, z: torch.Tensor, answers: list, record: bool) -> dict:
    """The checks of a list of answers, each a (row of ``z``, answer):
    every number that ``limits`` compares beside its limit, the malformed
    answers (limit 0), and where ``record`` every other number (limit None)."""
    ok = [(i, a) for i, a in answers if not malformed(a, cfg["num_classes"])]
    numbers = summarise([gaps(z[i], a["top_classes"], a["scores"]) for i, a in ok])
    checks = {name: {"value": numbers[name], "limit": limits.get(name)}
              for name in COMPARED if record or name in limits}
    checks["malformed"] = {"value": len(answers) - len(ok), "limit": 0}
    checks["unsampled"] = {"value": int(not ok), "limit": 0}
    return checks


def verdict(checks: dict) -> bool:
    """``correct``: every check with a limit within it."""
    return all(c["value"] <= c["limit"] for c in checks.values() if c["limit"] is not None)


def check(cfg: dict, limits: dict, w, blobs: list[bytes], window: load.Window,
          seed: int, device, host_decoded: int, control: bool = False,
          record: bool = False) -> tuple[dict, dict | None]:
    """(the program's checks, the control's or None). ``record`` adds every
    number, compared or not, with limit None."""
    in_window = window.in_window()
    picked = sample(window, blobs, seed)
    images = sorted({r.image for r in picked})
    row = {img: i for i, img in enumerate(images)}
    sd = w.on(device)
    z = reference_logits(cfg, sd, [blobs[i] for i in images], device)
    checks = judge(cfg, limits, z, [(row[r.image], r.answer) for r in picked], record)
    checks["malformed"]["value"] = sum(1 for r in in_window
                                       if r.ok and malformed(r.answer, cfg["num_classes"]))
    checks["failed"] = {"value": sum(1 for r in in_window if not r.ok), "limit": 0}
    checks["host_decoded"] = {"value": host_decoded, "limit": 0}
    control_checks = None
    if control:
        zc = reference_logits(cfg, sd, [blobs[i] for i in images], device, quant=models.fp8_quant)
        answers = []
        for r in picked:
            p5, c5 = torch.topk(torch.softmax(zc[row[r.image]].double(), dim=-1), 5)
            answers.append((row[r.image], {"top_classes": c5.tolist(), "scores": p5.tolist()}))
        control_checks = judge(cfg, limits, z, answers, record)
    del sd
    return checks, control_checks
