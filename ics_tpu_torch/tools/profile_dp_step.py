"""Where a data-parallel training step's time goes on the GPU.

    python -m ics_tpu_torch.tools.profile_dp_step [--model resnet50] [--positions 1 2]
        [--batch 32] [--steps 3]

Builds ``--model`` with random weights from seed 0 (10 classes), bf16 over
fp32 parameters, SGD, and a batch of random 512 px canvases on the card.
Prints the card's name and power limit, then, each the median of
``--steps`` steps after two of warm-up:

- the unsharded step (``train.finetune.make_preproc_train_step``), by the
  host's clock after a synchronize;
- the data-parallel step (``train.finetune.DataParallel``) over a
  ``("data",)`` mesh of each ``--positions`` count (every position on
  ``cuda:0`` where the machine has fewer cards): its forward (the positions'
  threads, ``Rendezvous.run``) and its backward, each as the host's time to
  enqueue it and as the time to its end on the device, and the whole step;
- one bf16 forward and backward of the model (no mesh) whose host time is
  taken in the main thread, in a fresh thread, and in a kept thread;
- two copies' forward and backward on two kept threads, each on a stream of
  its own, run at once and in turns.

The last two are the measurements behind ``parallel.mesh.Rendezvous``'s
design: kept threads, and positions that take turns. One JSON line at the
end carries every number.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ics_tpu_torch import disable_tf32


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, steps: int) -> dict:
    """The median over ``steps`` calls of each time (seconds) ``fn`` returns, in ms."""
    for _ in range(2):
        fn()
    runs = [fn() for _ in range(steps)]
    return {k: round(statistics.median(r[k] for r in runs) * 1e3, 2) for k in runs[0]}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="resnet50")
    parser.add_argument("--positions", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()

    from ics_tpu_torch.models.registry import get_model
    from ics_tpu_torch.ops import _build
    from ics_tpu_torch.ops.preproc import preprocess_batch
    from ics_tpu_torch.parallel.mesh import Position, make_mesh, send
    from ics_tpu_torch.train import finetune as tft

    if not torch.cuda.is_available():
        raise SystemExit("profile_dp_step needs a CUDA device")
    disable_tf32()
    _build.build()
    card = _card()
    print(card, flush=True)
    spec = get_model(args.model)
    size, short = spec.image_size, spec.resize_short
    gen = torch.Generator(device="cuda").manual_seed(0)
    canvas = torch.randint(0, 256, (args.batch, 512, 512, 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    sizes = torch.full((args.batch, 2), 448, dtype=torch.int32, device="cuda")
    labels = torch.arange(args.batch, device="cuda") % 10

    def build():
        model = spec.build(num_classes=10)
        model.init_weights(torch.Generator().manual_seed(0))
        tft.training_kernels(model)
        return model.to("cuda")

    out: dict = {"card": card, "model": args.model, "batch": args.batch}
    model = build()
    single = tft.make_preproc_train_step(
        model, tft.TrainOptimizer(model, tft.make_optimizer(lr=1e-4)), size, short,
        torch.bfloat16)

    def single_step():
        t = time.perf_counter()
        single(canvas, sizes, labels)
        torch.cuda.synchronize()
        return {"step": time.perf_counter() - t}

    out["unsharded"] = _median_ms(single_step, args.steps)
    print(f"unsharded step: {out['unsharded']} ms", flush=True)
    cards = torch.cuda.device_count()
    for n in args.positions:
        model = build()
        opt = tft.TrainOptimizer(model, tft.make_optimizer(lr=1e-4))
        devices = [f"cuda:{i}" for i in range(n)] if cards >= n else ["cuda:0"] * n
        dp = tft.DataParallel(model, make_mesh((n,), ("data",), devices=devices))

        def prepare(i):
            c, s, lab = dp.rows(i, (canvas, sizes, labels))
            return preprocess_batch(c, s, out_size=size, resize_short=short,
                                    dtype=torch.bfloat16), lab

        def dp_step():
            """``DataParallel.step`` with a clock between its parts."""
            from ics_tpu_torch.nn.layers import release_statistics

            t0 = time.perf_counter()

            def run(i):
                m = dp.copies[i]
                m.train()
                images, lab = prepare(i)
                return tft.cross_entropy_loss(m(images), lab) / n

            losses = dp.group.run(run)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            home = Position.current(dp.positions[0].device)
            loss = torch.stack([send(lo, p, home) for lo, p in zip(losses, dp.positions)]).sum()
            loss.backward()
            for m in dp.copies:
                release_statistics(m)
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            for other in dp.copies[1:]:
                for p, q in zip(dp.copies[0].parameters(), other.parameters()):
                    p.grad.add_(q.grad.to(p.device))
                    q.grad = None
            opt.step()
            with torch.no_grad():
                for other in dp.copies[1:]:
                    for p, q in zip(dp.copies[0].parameters(), other.parameters()):
                        q.copy_(p)
            torch.cuda.synchronize()
            return {"forward_host": t1 - t0, "forward": t2 - t0, "backward_host": t3 - t2,
                    "backward": t4 - t2, "step": time.perf_counter() - t0}

        out[f"dp_{n}"] = _median_ms(dp_step, args.steps)
        print(f"data-parallel step over {n} position(s) {devices}: {out[f'dp_{n}']} ms",
              flush=True)
        del dp, model, opt
        torch.cuda.empty_cache()

    model = build()
    x = preprocess_batch(canvas, sizes, out_size=size, resize_short=short, dtype=torch.bfloat16)

    def forward_backward(m, stream=None):
        t = time.perf_counter()
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            loss = tft.cross_entropy_loss(m(x), labels)
            host = time.perf_counter() - t
            loss.backward()
        m.zero_grad(set_to_none=True)
        return host

    def timed(fn):
        t = time.perf_counter()
        host = fn()
        torch.cuda.synchronize()
        return {"forward_host": host, "step": time.perf_counter() - t}

    kept = ThreadPoolExecutor(max_workers=2)

    def fresh_thread():
        box = []
        th = threading.Thread(target=lambda: box.append(forward_backward(model)))
        th.start()
        th.join()
        return box[0]

    for label, fn in (("main thread", lambda: forward_backward(model)),
                      ("fresh thread", fresh_thread),
                      ("kept thread", lambda: kept.submit(forward_backward, model).result())):
        out[label] = _median_ms(lambda: timed(fn), args.steps)
        print(f"forward and backward, {label}: {out[label]} ms", flush=True)
    twin = copy.deepcopy(model)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]

    def at_once():
        t = time.perf_counter()
        futures = [kept.submit(forward_backward, m, s) for m, s in zip((model, twin), streams)]
        host = max(f.result() for f in futures)
        torch.cuda.synchronize()
        return {"forward_host": host, "step": time.perf_counter() - t}

    def in_turns():
        t = time.perf_counter()
        host = 0.0
        for m, s in zip((model, twin), streams):
            host += kept.submit(forward_backward, m, s).result()
        torch.cuda.synchronize()
        return {"forward_host": host, "step": time.perf_counter() - t}

    for label, fn in (("two kept threads at once", at_once),
                      ("two kept threads in turns", in_turns)):
        out[label] = _median_ms(fn, args.steps)
        print(f"two copies' forward and backward, {label}: {out[label]} ms", flush=True)
    kept.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
