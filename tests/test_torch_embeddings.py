"""The port's embed step, embedding index and ``/images`` routes against the
JAX package's (``tests/test_embeddings.py``).

- ``InferenceEngine.embed_staged``: the same bridged weights and staged
  canvases give the reference's L2-normalized features (fp32,
  ``atol=2e-4, rtol=1e-4``) on ``resnet_tiny`` (with and without the chain
  path), ``vit_tiny`` (the flash kernel's plain version), ``swin_micro``
  (the window kernel's plain version) and ``vit_d128_micro`` (head_dim 128,
  registered by ``tests/test_torch_engine_pairs.py::dev_models``).
- ``EmbeddingIndex.search``: the same stored corpus gives the reference's
  results, hashes in the same order and scores within 1e-6, including a
  corpus of 3 in a 128-row bucket with every cosine negative (what the
  padding mask is for), ``exclude``, ``min_score``, ``k`` past ``K_MAX``,
  equal scores (lower index first, as ``jax.lax.top_k``) and a refresh
  after a write.
- The three ``/images`` routes answer as the reference app's on the same
  database and weights.
"""

import io

import httpx
import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ics_tpu.core import timezone as tz
from ics_tpu.runtime.decode import stage_batch
from ics_tpu_torch import weights
from tests.fake_nextcloud import make_jpeg

ATOL, RTOL = 2e-4, 1e-4


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    sizes = [(64, 64), (120, 90), (40, 200), (70, 70), (33, 47)][:n]
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in sizes]


def _variables(name, seed):
    from ics_tpu.models.registry import get_model

    return jax.tree_util.tree_map(
        np.asarray, get_model(name).build(num_classes=10).init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("name,fused_chains", [
    ("resnet_tiny", False), ("resnet_tiny", True), ("vit_tiny", False), ("swin_micro", False),
    ("vit_d128_micro", False),
])
def test_embed_staged_matches_the_jax_engine(name, fused_chains):
    from ics_tpu.runtime.engine import InferenceEngine as JaxEngine
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from tests.test_torch_engine_pairs import dev_models

    canvas, sizes = stage_batch(_images(3), canvas=None)
    with dev_models():
        variables = _variables(name, 11)
        ref = JaxEngine(name, num_classes=10, precision="fp32", buckets=(4,), canvas=256,
                        variables=variables)
        eng = InferenceEngine(name, num_classes=10, precision="fp32", buckets=(4,),
                              canvas=256, state_dict=weights.from_jax_variables(variables),
                              device="cpu", fused_chains=fused_chains)
    want = ref.embed_staged(canvas, sizes)
    got = eng.embed_staged(canvas, sizes)
    assert eng.embed_dim == ref.embed_dim and got.shape == (3, ref.embed_dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    # padded to the bucket and recorded under the reference's key
    assert ("embed", 4, 256) in eng._compiled_shapes
    assert eng.status()["images"] == 3 and eng.status()["batches"] == 1


@pytest.fixture(scope="module")
def resnet_engine():
    from ics_tpu_torch.runtime.engine import InferenceEngine

    return InferenceEngine("resnet_tiny", num_classes=7, precision="fp32", buckets=(4,),
                           canvas=64, device="cpu")


def test_the_identity_head_gives_the_features_the_logits_come_from(resnet_engine):
    """head(raw features) equals the classify path's logits: skipping the
    head extracts exactly the penultimate features; the head of the model
    that classifies is untouched."""
    from ics_tpu_torch.ops.preproc import preprocess_batch

    eng = resnet_engine
    canvas = np.random.default_rng(1).integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.full((2, 2), 64, np.int32)
    x = preprocess_batch(torch.from_numpy(canvas), torch.from_numpy(sizes), out_size=64,
                         resize_short=64, dtype=torch.float32)
    head = eng.model.head
    assert not isinstance(head, torch.nn.Identity)
    with torch.inference_mode():
        raw = eng._get_embed_model().apply_folded(x)
        logits = eng.model.apply_folded(x)
        torch.testing.assert_close(raw @ head.weight.T + head.bias, logits, atol=1e-5, rtol=1e-5)
    feats = eng.embed_staged(canvas, sizes)
    np.testing.assert_allclose(feats, (raw / raw.norm(dim=-1, keepdim=True)).numpy(),
                               atol=1e-6, rtol=1e-6)
    # the copy shares the model's weights: nothing was duplicated
    assert eng._get_embed_model().stem.conv.weight is eng.model.stem.conv.weight


def test_bf16_features_come_out_in_the_serving_dtype():
    """The reference's identity head is a bf16 matmul by the identity, which
    rounds the features to bf16 and no further; the port's features leave
    the trunk in bf16 and are widened to fp32 only for the norm."""
    from ics_tpu_torch.ops.preproc import preprocess_batch
    from ics_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine("resnet_tiny", num_classes=7, precision="bf16", buckets=(2,),
                          canvas=64, device="cpu")
    canvas = np.random.default_rng(2).integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.full((2, 2), 64, np.int32)
    x = preprocess_batch(torch.from_numpy(canvas), torch.from_numpy(sizes), out_size=64,
                         resize_short=64, dtype=torch.bfloat16)
    with torch.inference_mode():
        raw = eng._get_embed_model().apply_folded(x)
    assert raw.dtype == torch.bfloat16
    raw = raw.float()
    got = eng.embed_staged(canvas, sizes)
    np.testing.assert_allclose(got, (raw / raw.norm(dim=-1, keepdim=True)).numpy(),
                               atol=1e-6, rtol=1e-6)


def test_embedding_and_classify_from_two_threads_keep_exact_counts(resnet_engine):
    """Classify-on-sync drives the engine from two threads at once (the
    batcher's flush and the embed call): the engine's records and the
    kernels' launch counters must not lose an update."""
    import sys
    import threading

    from ics_tpu_torch.ops import LaunchCounter
    from ics_tpu_torch.runtime.engine import InferenceEngine

    eng = InferenceEngine("resnet_tiny", num_classes=7, precision="fp32", buckets=(1, 2),
                          canvas=64, device="cpu", fused_chains=True)
    canvas = np.random.default_rng(3).integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    sizes = np.full((2, 2), 64, np.int32)
    want_feats = eng.embed_staged(canvas, sizes)
    want_idx, _ = eng.predict_staged(canvas, sizes)
    counter = LaunchCounter()
    rounds, errors = 12, []
    results = {"embed": [], "classify": []}

    def work(kind):
        try:
            for _ in range(rounds):
                if kind == "embed":
                    results[kind].append(eng.embed_staged(canvas, sizes))
                else:
                    results[kind].append(eng.predict_staged(canvas, sizes)[0])
                for _ in range(50):
                    counter.add()
        except Exception as exc:  # surfaced below
            errors.append(exc)

    before = eng.status()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(kind,)) for kind in
                   ("embed", "classify", "embed", "classify")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    after = eng.status()
    assert after["batches"] - before["batches"] == 4 * rounds
    assert after["images"] - before["images"] == 4 * rounds * 2
    assert after["compiles"] == before["compiles"]
    assert counter.value == 4 * rounds * 50
    for feats in results["embed"]:
        np.testing.assert_array_equal(feats, want_feats)
    for idx in results["classify"]:
        np.testing.assert_array_equal(idx, want_idx)


# ---- the index ----------------------------------------------------------------

def _corpus_db(top, tmp_path, vecs: dict, modelo="m"):
    import importlib

    Database = importlib.import_module(f"{top}.db.engine").Database
    models = importlib.import_module(f"{top}.db.models")
    crud = importlib.import_module(f"{top}.crud.embedding_crud")
    db = Database(f"sqlite:///{tmp_path}/{top}_emb.db")
    db.create_all()
    now = tz.utcnow()
    with db.session() as s:
        cnj = models.ConjuntoImagens(nome_conj="e", caminho_conj="/e", file_id="5",
                                     imagens_sincronizadas=True, data_proc=now, data_sinc=now)
        s.add(cnj)
        s.flush()
        for h, v in vecs.items():
            s.add(models.Imagem(content_hash=h, nome_img="x.jpg", caminho_img=f"e/{h[:4]}.jpg",
                                data_proc=now, data_sinc=now, id_cnj=cnj.id_cnj))
            crud.upsert_embedding(s, h, modelo, v)
        s.commit()
    return db


def _indexes(tmp_path, vecs):
    from ics_tpu.runtime.embedding_index import EmbeddingIndex as Ref
    from ics_tpu_torch.runtime.embedding_index import EmbeddingIndex

    (tmp_path / "ref").mkdir(exist_ok=True)
    (tmp_path / "port").mkdir(exist_ok=True)
    return (Ref(_corpus_db("ics_tpu", tmp_path / "ref", vecs), "m"),
            EmbeddingIndex(_corpus_db("ics_tpu_torch", tmp_path / "port", vecs), "m",
                           device="cpu"))


def _same_search(ref, port, q, **kwargs):
    want = ref.search(q, **kwargs)
    got = port.search(q, **kwargs)
    assert [g["content_hash"] for g in got] == [w["content_hash"] for w in want]
    np.testing.assert_allclose([g["score"] for g in got], [w["score"] for w in want],
                               atol=1e-6, rtol=0)
    return got


def _unit(rng, d):
    v = rng.normal(size=(d,)).astype(np.float32)
    return v / np.linalg.norm(v)


def test_rows_bucket_powers_of_two():
    from ics_tpu.runtime.embedding_index import _rows_bucket as ref_bucket
    from ics_tpu_torch.runtime.embedding_index import _rows_bucket

    for n in (1, 127, 128, 129, 1000, 5000):
        assert _rows_bucket(n) == ref_bucket(n)
    assert [_rows_bucket(n) for n in (1, 128, 129, 1000)] == [128, 128, 256, 1024]


@pytest.mark.parametrize("n,k", [(20, 5), (300, 64), (300, 100), (3, 10)])
def test_search_matches_the_reference(tmp_path, monkeypatch, n, k):
    """``k`` past ``K_MAX`` gives ``K_MAX`` results in both; a corpus larger
    than a bucket pads to the next one; at 300 rows the scores are taken
    100 rows at a time (the slices a corpus of millions is scored in)."""
    from ics_tpu_torch.runtime import embedding_index

    monkeypatch.setattr(embedding_index, "SCORE_ROWS", 100)
    rng = np.random.default_rng(n)
    vecs = {f"{i:03d}" + "c" * 61: _unit(rng, 32) for i in range(n)}
    ref, port = _indexes(tmp_path, vecs)
    got = _same_search(ref, port, _unit(rng, 32), k=k)
    assert len(got) == min(k, n, port.K_MAX)


def test_negative_cosine_matches_beat_padding(tmp_path):
    """A corpus of 3 in the 128-row bucket, every cosine negative: padding
    rows score 0 unless masked, and would fill the top-k."""
    rng = np.random.default_rng(7)
    q = _unit(rng, 16)
    vecs = {}
    for i in range(3):
        v = _unit(rng, 16)
        vecs[f"{i:02d}" + "n" * 62] = -v if v @ q > 0 else v
    ref, port = _indexes(tmp_path, vecs)
    got = _same_search(ref, port, q, k=3)
    assert len(got) == 3 and all(g["score"] < 0 for g in got)


def test_equal_scores_come_lower_index_first(tmp_path):
    rng = np.random.default_rng(3)
    a, b = _unit(rng, 16), _unit(rng, 16)
    # six copies of two vectors, interleaved: the scores tie in two groups
    vecs = {f"{i:02d}" + "t" * 62: (a if i % 2 else b) for i in range(12)}
    ref, port = _indexes(tmp_path, vecs)
    for q in (a, b, (a + b) / np.linalg.norm(a + b)):
        got = _same_search(ref, port, q, k=12)
        order = [g["content_hash"] for g in got]
        scores = [g["score"] for g in got]
        for i in range(len(got) - 1):
            if scores[i] == scores[i + 1]:
                assert order[i] < order[i + 1]


def test_scores_are_fp32_sums_of_bf16_products(tmp_path):
    """The reference's ``preferred_element_type=f32``: scores that bf16 would
    round together stay apart, and the threshold comparisons see them."""
    rng = np.random.default_rng(5)
    base = _unit(rng, 64)
    vecs = {f"{i:02d}" + "s" * 62: (base + 1e-3 * i * _unit(rng, 64)) for i in range(8)}
    vecs = {h: v / np.linalg.norm(v) for h, v in vecs.items()}
    ref, port = _indexes(tmp_path, vecs)
    got = _same_search(ref, port, base, k=8)
    scores = np.array([g["score"] for g in got], np.float32)
    assert len(set(scores.tolist())) > len(set(
        torch.tensor(scores).to(torch.bfloat16).float().tolist()))
    _same_search(ref, port, base, k=8, min_score=float(scores[3]))


def test_exclude_min_score_and_refresh(tmp_path):
    v = np.zeros(8, np.float32)
    v[0] = 1.0
    u = np.zeros(8, np.float32)
    u[1] = 1.0
    h_v, h_u = "v" * 64, "u" * 64
    ref, port = _indexes(tmp_path, {h_v: v, h_u: u})
    assert [g["content_hash"] for g in _same_search(ref, port, v, k=5, exclude=h_v)] == [h_u]
    assert [g["content_hash"] for g in _same_search(ref, port, v, k=5, min_score=0.5)] == [h_v]
    # a new row is picked up without rebuilding the object (version key)
    import importlib

    w = (v + u) / np.linalg.norm(v + u)
    now = tz.utcnow()
    for index, top in ((ref, "ics_tpu"), (port, "ics_tpu_torch")):
        models = importlib.import_module(f"{top}.db.models")
        crud = importlib.import_module(f"{top}.crud.embedding_crud")
        with index.db.session() as s:
            s.add(models.Imagem(content_hash="w" * 64, nome_img="w.jpg", caminho_img="e/w.jpg",
                                data_proc=now, data_sinc=now,
                                id_cnj=s.query(models.ConjuntoImagens).all()[0].id_cnj))
            crud.upsert_embedding(s, "w" * 64, "m", w)
            s.commit()
    got = _same_search(ref, port, v, k=1, exclude=h_v)
    assert got[0]["content_hash"] == "w" * 64


def test_empty_corpus(tmp_path):
    from ics_tpu_torch.db.engine import Database
    from ics_tpu_torch.runtime.embedding_index import EmbeddingIndex

    db = Database(f"sqlite:///{tmp_path}/empty.db")
    db.create_all()
    assert EmbeddingIndex(db, "m", device="cpu").search(np.zeros(4), k=3) == []


def test_vector_codec_and_queues_match_the_reference(tmp_path):
    """The stored form (base64 of fp16) and the backfill queue are the
    reference's: a vector written by one package reads back in the other."""
    from ics_tpu.crud import embedding_crud as ref
    from ics_tpu_torch.crud import embedding_crud as port

    v = _unit(np.random.default_rng(0), 512)
    assert port.encode_vector(v) == ref.encode_vector(v)
    np.testing.assert_array_equal(port.decode_vector(ref.encode_vector(v), 512),
                                  ref.decode_vector(ref.encode_vector(v), 512))
    with pytest.raises(ValueError):
        port.decode_vector(port.encode_vector(np.zeros(8, np.float32)), 16)


# ---- the /images routes ----------------------------------------------------

ADMIN = {"username": "admin@seudominio.com", "password": "senha_super_secreta"}
SETTINGS = dict(TPU_ENABLE_INFERENCE="true", TPU_MESH_SHAPE="1",
                TPU_DEFAULT_MODEL="resnet_tiny", TPU_NUM_CLASSES="16",
                TPU_PRECISION="fp32", TPU_CANVAS="64", TPU_BATCH_BUCKETS="4",
                TPU_BATCH_DEADLINE_US="20000", TPU_WARMUP_ON_STARTUP="false",
                TPU_DEVICE_DECODE="false")


def _seed(top, db, vectors=None) -> dict:
    """Six synced images; with ``vectors``, each with that stored embedding."""
    import importlib

    models = importlib.import_module(f"{top}.db.models")
    crud = importlib.import_module(f"{top}.crud.embedding_crud")
    sha = importlib.import_module(f"{top}.core.security").sha256_hex
    now = tz.utcnow()
    blobs = {}
    with db.session() as s:
        cnj = models.ConjuntoImagens(nome_conj="sim", caminho_conj="/sim", file_id="8",
                                     imagens_sincronizadas=True, data_proc=now, data_sinc=now)
        s.add(cnj)
        s.flush()
        for i in range(6):
            data = make_jpeg(i, size=(60, 60))
            blobs[sha(data)] = data
            s.add(models.Imagem(content_hash=sha(data), nome_img=f"{i}.jpg",
                                caminho_img=f"sim/{i}.jpg", data_proc=now, data_sinc=now,
                                id_cnj=cnj.id_cnj))
            if vectors is not None:
                crud.upsert_embedding(s, sha(data), "resnet_tiny", vectors[sha(data)])
        s.commit()
    return blobs


async def _drive_images(app) -> list:
    """The three routes, with the answers a client would compare."""
    blobs = app.state.blobs
    query_hash, query_bytes = next(iter(sorted(blobs.items())))
    img = Image.open(io.BytesIO(query_bytes)).convert("RGB")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=35)
    out = []
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t", timeout=120) as c:
        for method, url, files in (
            ("POST", "/images/buscar-similares?limite=3",
             {"file": ("q.jpg", query_bytes, "image/jpeg")}),
            ("POST", "/images/buscar-similares?apenas_duplicatas=true",
             {"file": ("d.jpg", buf.getvalue(), "image/jpeg")}),
            ("POST", "/images/buscar-similares?limite=50",
             {"file": ("d.jpg", buf.getvalue(), "image/jpeg")}),
            ("GET", f"/images/{query_hash}/similares?limite=2", None),
            ("GET", f"/images/{query_hash}/similares", None),
            ("GET", f"/images/{'f' * 64}/similares", None),
            ("GET", f"/images/{query_hash}/similares?limite=x", None),
            ("POST", "/images/buscar-similares", None),
            ("POST", "/images/buscar-por-hash",
             [("files", ("a.jpg", query_bytes, "image/jpeg")),
              ("files", ("b.jpg", buf.getvalue(), "image/jpeg")),
              ("files", ("c.txt", b"text", "text/plain"))]),
        ):
            r = await c.request(method, url, files=files)
            out.append((url, r.status_code, r.json()))
    return out


@pytest.mark.anyio
async def test_images_routes_answer_as_the_reference(tmp_path):
    from ics_tpu.core.config import reload_settings as ref_reload
    from ics_tpu.db.engine import Database as RefDatabase
    from ics_tpu.main import create_app as ref_app
    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.db.engine import Database
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService

    ref_reload(**SETTINGS)
    try:
        app = ref_app(db=RefDatabase(f"sqlite:///{tmp_path}/ref.db"))
        await app.startup()
        try:
            service = app.state.engine
            blobs = _seed("ics_tpu", app.state.db)
            # the stored vectors both apps search: the reference's own
            vectors = {h: await service.embed_bytes(b) for h, b in blobs.items()}
            from ics_tpu.crud.embedding_crud import upsert_embedding

            with app.state.db.session() as s:
                for h, v in vectors.items():
                    upsert_embedding(s, h, "resnet_tiny", v)
                s.commit()
            app.state.blobs = blobs
            want = await _drive_images(app)
            variables = jax.tree_util.tree_map(np.asarray, service.engine.variables)
        finally:
            await app.shutdown()
    finally:
        ref_reload()

    reload_settings(**SETTINGS)
    try:
        engine = InferenceEngine("resnet_tiny", num_classes=16, precision="fp32", buckets=(4,),
                                 canvas=64, device="cpu",
                                 state_dict=weights.from_jax_variables(variables))
        service = InferenceService(engine, deadline_us=20_000, device_decode=False)
        await service.start()
        app = create_app(db=Database(f"sqlite:///{tmp_path}/port.db"))
        app.state.engine = service
        await app.startup()
        try:
            app.state.blobs = _seed("ics_tpu_torch", app.state.db, vectors)
            got = await _drive_images(app)
        finally:
            await app.shutdown()
            await service.stop()
    finally:
        reload_settings()

    assert [(u, s) for u, s, _ in got] == [(u, s) for u, s, _ in want]
    assert [s for _, s, _ in got] == [200, 200, 200, 200, 200, 404, 422, 422, 200]
    for (url, _, g), (_, _, w) in zip(got, want):
        if "similares" in g:
            assert [x["content_hash"] for x in g["similares"]] == \
                [x["content_hash"] for x in w["similares"]], url
            np.testing.assert_allclose([x["score"] for x in g["similares"]],
                                       [x["score"] for x in w["similares"]], atol=ATOL)
            for x in g["similares"] + w["similares"]:
                x.pop("score")
        assert g == w, url
    near_dup = got[1][2]["similares"]
    assert len(near_dup) == 1 and got[2][2]["total"] == 6
