"""One fine-tune job run by the reference's manager (``ics_tpu.train.job``)
and by the port's on the CPU, over one database: the same labelled examples,
split, class map and registered ``metricas`` keys, and the first step's loss
within 1e-5 relative.

Both start from one ``pesos_iniciais`` file, written from the JAX model's
init with the head already at the ambiente's option count (no head is drawn
anew), and train ``resnet_tiny`` in fp32 with augment off, SGD on the
warmup-cosine schedule, batch 4 for 4 steps. The first step's loss is the
forward of those weights on the first batch; after it the two trainers apply
updates the same fp32 math sums in another order, and the gap of the later
losses is printed and held to ``LATER_LOSS_TOL``.
"""

import jax
import numpy as np

from ics_tpu.db.engine import Database as JaxDatabase
from ics_tpu.models.registry import get_model as get_jax_model
from ics_tpu.train import pretrained as jax_pretrained
from ics_tpu.train.job import TrainingJobManager as JaxManager
from ics_tpu_torch.train.job import TrainingJobManager
from tests.test_torch_job import seeded_manager, wait

FIRST_LOSS_RTOL = 1e-5
# the later steps' losses, relative: the updates are the same fp32 sums in
# another order, carried through three steps of a randomly initialised ResNet
# (measured on the CPU: 4.0e-6, 6.6e-4, 3.7e-4)
LATER_LOSS_TOL = 5e-3
JOB = dict(max_steps=4, batch_size=4, epochs=50, canvas=64, compute_dtype="fp32",
           augmentar=False, otimizador="sgd", lr=0.01)


def test_one_job_through_both_managers(tmp_path):
    manager, id_amb = seeded_manager(tmp_path)
    blobs = manager.seeded["blobs"]
    variables = get_jax_model("resnet_tiny").build(num_classes=2).init(jax.random.PRNGKey(0))
    weights = tmp_path / "resnet_tiny_init.npz"
    jax_pretrained.save_npz(weights, jax.tree_util.tree_map(np.asarray, variables))

    ref = JaxManager(JaxDatabase(f"sqlite:///{tmp_path}/jobs.db"), tmp_path / "w_ref",
                     fetch_bytes=lambda h, _p: blobs[h])
    port = TrainingJobManager(manager.db, tmp_path / "w_port",
                              fetch_bytes=lambda h, _p: blobs[h], device="cpu")
    jobs = {}
    for name, mgr in (("ref", ref), ("port", port)):
        jobs[name] = job = mgr.start(id_amb, "resnet_tiny", pesos_iniciais=str(weights), **JOB)
        if name == "ref":
            job.thread.join(600)
        wait(job, 600)
        assert job.status == "concluido", (name, job.to_dict())
    got, want = jobs["port"], jobs["ref"]
    assert got.n_examples == want.n_examples == 8
    assert got.n_train == want.n_train and got.n_sugestoes == want.n_sugestoes == 0
    assert len(got.history) == len(want.history) == 4
    assert [h["step"] for h in got.history] == [h["step"] for h in want.history]

    with manager.db.session() as s:
        rows = {str(r["id_mod"]): r for r in s.fetchall(
            "SELECT id_mod, class_map, metricas FROM modelos_treinados")}
    import json

    row_ref, row_port = (rows[jobs[k].id_mod] for k in ("ref", "port"))
    load = (lambda v: json.loads(v) if isinstance(v, str) else v)
    assert load(row_port["class_map"]) == load(row_ref["class_map"])
    met_ref, met_port = load(row_ref["metricas"]), load(row_port["metricas"])
    assert set(met_port) == set(met_ref)
    for key in ("exemplos", "exemplos_treino", "exemplos_eval", "otimizador", "multi_rotulo"):
        assert met_port[key] == met_ref[key], key

    losses = np.array([[h["loss"] for h in j.history] for j in (got, want)])
    np.testing.assert_allclose(losses[0, 0], losses[1, 0], rtol=FIRST_LOSS_RTOL, atol=0)
    later = np.abs(losses[0, 1:] - losses[1, 1:]) / np.abs(losses[1, 1:])
    print(f"first-step loss port {losses[0, 0]!r} ref {losses[1, 0]!r}; "
          f"later steps' relative gaps {later.tolist()}")
    assert np.all(later <= LATER_LOSS_TOL), later
