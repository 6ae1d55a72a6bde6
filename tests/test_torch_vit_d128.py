"""The head_dim-128 ViTs (``vit_b16_h6d128``, ``vit_l16_h8d128``) on the port's
serving and training paths against the JAX package's, on the CPU.

The full-width models are too large for CPU parity runs, so their geometry
is cut to ``vit_d128_micro``: two blocks of two heads of 128 at 64 px, tanh
GELU in every dtype, registered in both registries by
``tests/test_torch_engine_pairs.py::dev_models``. Its weights are the JAX
package's initialisation, randomised by ``engine_pair``; fp32 throughout.

- serving: the engine's top-5 and scores on the resize lane and the
  fixed-size lane, and a two-stage GPipe split, each against the JAX engine
  at atol 2e-4, rtol 1e-4 (the engine parity bar); TTA, explain and the
  embedding have their cases in ``test_torch_tta.py``,
  ``test_torch_explain.py``, ``test_torch_app.py`` and
  ``test_torch_embeddings.py``.
- training: two SGD steps of the micro ViT unsharded, with ``remat``, on a
  ``data`` mesh of 2 and on an ``sp`` mesh of 2 (ring attention at head_dim
  128), each loss against the JAX package's run on an ``sp`` mesh of 2 at
  1e-4; and a ``treinamento`` job on it over HTTP: trained, served,
  exported and imported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ics_tpu_torch import weights
from ics_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_engine_pairs import dev_models, engine_pair, variables_of
from tests.test_torch_treinamento import app  # noqa: F401  (the job surface's app fixture)

ATOL, RTOL = 2e-4, 1e-4
NAME = "vit_d128_micro"


@pytest.fixture(scope="module")
def pair():
    with dev_models():
        return engine_pair(NAME, num_classes=6, buckets=(4,))


@pytest.mark.parametrize("side", [48, 64])     # 64: the fixed-size lane of a 64 px model
def test_predictions_match_the_jax_engine(pair, side):
    jax_engine, engine = pair
    canvas = np.random.default_rng(side).integers(0, 256, (3, 64, 64, 3), np.uint8)
    sizes = np.full((3, 2), side, np.int32)
    ref_idx, ref_scores = jax_engine.predict_staged(canvas, sizes)
    idx, scores = engine.predict_staged(canvas, sizes)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(scores, ref_scores, atol=ATOL, rtol=RTOL)
    assert engine.model.blocks[0].attn.head_dim == 128
    assert engine.status()["kernel_launches"]["flash_attention"] == 0   # the plain version


def test_a_two_stage_pipeline_matches_the_jax_pipeline_and_the_single_engine(pair):
    from ics_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ics_tpu.runtime.engine import InferenceEngine as JaxEngine
    from ics_tpu_torch.runtime.engine import InferenceEngine

    _, single = pair
    kw = dict(num_classes=6, precision="fp32", buckets=(4,), canvas=64, pp_microbatches=2)
    with dev_models():
        variables = variables_of(NAME, 6)
        ref = JaxEngine(NAME, variables=variables,
                        mesh=jax_make_mesh((2,), ("pp",), devices=jax.devices()[:2]), **kw)
        pp = InferenceEngine(NAME, state_dict=weights.from_jax_variables(variables),
                             mesh=make_mesh((2,), ("pp",), devices=["cpu"] * 2), **kw)
    canvas = np.random.default_rng(5).integers(0, 256, (4, 64, 64, 3), np.uint8)
    sizes = np.full((4, 2), 56, np.int32)
    idx, scores = pp.predict_staged(canvas, sizes)
    for want_idx, want_scores in (ref.predict_staged(canvas, sizes),
                                  single.predict_staged(canvas, sizes)):
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_allclose(scores, want_scores, atol=ATOL, rtol=RTOL)


def test_finetune_unsharded_remat_data_and_sp_match_the_jax_sp_run():
    """Two SGD steps from one JAX initialisation: the JAX package's run on an
    ``sp`` mesh of 2 (attention ringed over 66 padded tokens), and the port's
    unsharded, with ``remat``, on a ``data`` mesh of 2 and on ``sp`` 2. The
    flash kernel is off by name in every port run."""
    from ics_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ics_tpu.train import finetune as jft
    from ics_tpu_torch.train import finetune as tft

    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (4, 64, 64, 3), np.uint8), np.full((4, 2), 64, np.int32),
                (np.arange(4) % 6).astype(np.int32)) for _ in range(2)]
    with dev_models():
        import ics_tpu.models.registry as jax_registry
        import ics_tpu_torch.models.registry as torch_registry

        jmodel = jax_registry.get_model(NAME).build(num_classes=6)
        variables = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
        build = torch_registry.get_model(NAME).build
    jtuner = jft.FineTuner(jmodel, optimizer=jft.make_optimizer(lr=0.05), image_size=64,
                           resize_short=64, compute_dtype=jnp.float32,
                           mesh=jax_make_mesh((2,), ("sp",), devices=jax.devices()[:2]))
    _, _, jhist = jtuner.run(jax.tree_util.tree_map(jnp.asarray, variables), iter(batches))
    want = [h["loss"] for h in jhist]
    state = weights.from_jax_variables(variables)
    runs = {"unsharded": {}, "remat": {"remat": True},
            "data 2": {"mesh": make_mesh((2,), ("data",), devices=["cpu"] * 2)},
            "sp 2": {"mesh": make_mesh((2,), ("sp",), devices=["cpu"] * 2)}}
    for label, kw in runs.items():
        model = build(num_classes=6)
        model.load_state_dict(state, strict=True)
        tuner = tft.FineTuner(model, optimizer=tft.make_optimizer(lr=0.05), image_size=64,
                              resize_short=64, compute_dtype=torch.float32, **kw)
        assert not model.use_flash
        if label == "sp 2":
            assert all(blk.attn.ring is not None for blk in model.blocks)
        _, _, hist = tuner.run(iter(batches))
        np.testing.assert_allclose([h["loss"] for h in hist], want, atol=1e-4, rtol=1e-4,
                                   err_msg=label)


@pytest.mark.anyio
async def test_a_treinamento_job_trains_serves_exports_and_imports_the_d128_vit(app):
    from tests.test_torch_job import seed_ambiente
    from tests.test_torch_treinamento import SMALL, _client, _login, _wait

    amb, id_amb = app.state.amb, app.state.amb["id_amb"]
    image = amb["blobs"][amb["unlabeled"][0]]
    with dev_models():
        async with _client(app) as c:
            admin = await _login(c)
            r = await c.post(f"/treinamento/ambiente/{id_amb}",
                             json={**SMALL, "modelo": NAME}, headers=admin)
            assert r.status_code == 202, r.text
            job = await _wait(c, r.json()["id_job"], admin)
            assert job["status"] == "concluido" and job["passos"] == 3, job
            assert all(np.isfinite(h["loss"]) for h in job["historico"])
            esp = await _login(c, "esp@x.com", "SenhaBoa1")
            r = await c.post(f"/classificacoes/ambiente/{id_amb}/classificar-tpu",
                             files={"file": ("x.jpg", image, "image/jpeg")}, headers=esp)
            assert r.status_code == 200, r.text
            served = r.json()
            assert served["model"] == NAME and served["modelo_versao"] == 1
            id_mod = (await c.get(f"/treinamento/modelos?id_amb={id_amb}",
                                  headers=admin)).json()["modelos"][0]["id_mod"]
            r = await c.get(f"/treinamento/modelos/{id_mod}/exportar", headers=admin)
            assert r.status_code == 200
            amb2 = seed_ambiente(app.state.db, tag="d")
            r = await c.post(f"/treinamento/ambiente/{amb2['id_amb']}/importar",
                             files={"file": ("m.tar.gz", r.content, "application/gzip")},
                             headers=admin)
            assert r.status_code == 201, r.text
            r = await c.post(f"/classificacoes/ambiente/{amb2['id_amb']}/classificar-tpu",
                             files={"file": ("x.jpg", image, "image/jpeg")}, headers=esp)
            assert r.status_code == 200, r.text
            assert r.json()["model"] == NAME
            assert [o["texto_opcao"] for o in r.json()["opcoes"]] == \
                [o["texto_opcao"] for o in served["opcoes"]]
            np.testing.assert_array_equal([o["score"] for o in r.json()["opcoes"]],
                                          [o["score"] for o in served["opcoes"]])

