"""kNN label suggestions of the port (``runtime/knn_suggest.py`` over its
embedding index, and ``sugerir-vizinhos``) against the JAX package's
(``tests/test_knn_suggest.py``).

Both packages get the same database contents (each through its own ORM):
an ambiente with options A and B, labelled images clustered on two axes of
the embedding space, an unlabelled query near cluster A and unlabelled
noise. Row ids are UUIDs drawn by each database, so options are compared by
their text. Scores: ``atol=1e-6`` (the same fp32 cosines on the same bf16
matrix).
"""

import importlib

import httpx
import numpy as np
import pytest

PACKAGES = ("ics_tpu", "ics_tpu_torch")


def _unit(*coords):
    v = np.zeros(8, np.float32)
    for i, x in zip((0, 1, 2, 3), coords):
        v[i] = x
    return v / np.linalg.norm(v)


def _fresh_db(top, path):
    mod = lambda name: importlib.import_module(f"{top}.{name}")  # noqa: E731
    mod("db.models")  # fills the table registry create_all reads
    db = mod("db.engine").Database(f"sqlite:///{path}")
    db.create_all()
    mod("db.seed").seed_all(db)
    return db


def _seed(top, db, multi: bool = False, modelo: str = "m") -> dict:
    """The reference test's corpus, through package ``top``'s ORM."""
    m = importlib.import_module(f"{top}.db.models")
    tz = importlib.import_module(f"{top}.core.timezone")
    hash_password = importlib.import_module(f"{top}.core.security").hash_password
    upsert = importlib.import_module(f"{top}.crud.embedding_crud").upsert_embedding
    now = tz.utcnow()
    with db.session() as s:
        esp = m.Usuario(nome_completo="Esp kNN", email="knn@x.com",
                        senha_hash=hash_password("SenhaBoa1"), data_criado=now, id_tipo=1)
        s.add(esp)
        s.flush()
        con = m.UsuarioConvencional(cpf="5" * 11, id_usu=esp.id_usu)
        s.add(con)
        s.flush()
        adm = s.fetchone("SELECT id_adm FROM usuarios_administradores LIMIT 1")
        cnj = m.ConjuntoImagens(nome_conj="knn", caminho_conj="/knn", file_id="11",
                                imagens_sincronizadas=True, data_proc=now, data_sinc=now)
        s.add(cnj)
        s.flush()
        amb = m.Ambiente(titulo_amb="kNN", descricao_questionario="d", data_criado=now,
                         id_adm=adm["id_adm"], multipla_escolha=multi)
        s.add(amb)
        s.flush()
        s.add(m.AmbienteConjuntoImagens(id_amb=amb.id_amb, id_cnj=cnj.id_cnj,
                                        data_associado=now))
        s.add(m.UsuarioAmbiente(id_con=con.id_con, id_amb=amb.id_amb, data_associado=now))
        op_a = m.Opcao(texto="A", id_amb=amb.id_amb)
        op_b = m.Opcao(texto="B", id_amb=amb.id_amb)
        s.add_all([op_a, op_b])
        s.flush()

        def add_img(tag, vec, opcoes=()):
            h = tag * 32
            s.add(m.Imagem(content_hash=h, nome_img=f"{tag}.jpg", caminho_img=f"knn/{tag}.jpg",
                           data_proc=now, data_sinc=now, id_cnj=cnj.id_cnj))
            s.flush()
            upsert(s, h, modelo, vec)
            for opc in opcoes:
                s.add(m.Classificacao(id_con=con.id_con, id_img=h, id_opc=opc.id_opc,
                                      data_criado=now, ativo=True))
            return h

        ctx = {
            "a1": add_img("a1", _unit(1.0, 0.0), [op_a]),
            "a2": add_img("a2", _unit(0.98, 0.2), [op_a]),
            "b1": add_img("b1", _unit(0.0, 1.0), [op_b]),
        }
        if multi:
            ctx["ab"] = add_img("ab", _unit(0.9, 0.45), [op_a, op_b])
        ctx["q"] = add_img("qq", _unit(0.99, 0.1))
        add_img("zz", _unit(0.97, 0.15))
        s.commit()
        ctx.update(id_amb=str(amb.id_amb), texts={str(op_a.id_opc): "A", str(op_b.id_opc): "B"})
        return ctx


def _index(top, db):
    cls = importlib.import_module(f"{top}.runtime.embedding_index").EmbeddingIndex
    return cls(db, "m", device="cpu") if top == "ics_tpu_torch" else cls(db, "m")


def _by_text(result, texts):
    if result is None:
        return None
    return {**result, "opcoes": [(texts.get(o["id_opc"], o["id_opc"]), o["score"])
                                 for o in result["opcoes"]]}


def vote_near_cluster(top, db, ctx, knn):
    with db.session() as s:
        res = knn.knn_sugerir(s, _index(top, db), ctx["id_amb"], ctx["q"], k=3)
    assert res["vizinhos"] == 3 and res["opcoes"][0]["score"] > 0.6
    return res


def vote_unindexed_and_other_ambiente(top, db, ctx, knn):
    index = _index(top, db)
    with db.session() as s:
        missing = knn.knn_sugerir(s, index, ctx["id_amb"], "f" * 64)
        other = knn.knn_sugerir(s, index, "0" * 36, ctx["q"])
    assert missing is None and other == {"vizinhos": 0, "opcoes": []}
    return {"vizinhos": other["vizinhos"], "opcoes": other["opcoes"], "missing": missing}


def labels_scoped_to_ambiente(top, db, ctx, knn):
    with db.session() as s:
        labels = knn.rotulos_por_imagens(s, [ctx["a1"], ctx["b1"], ctx["q"]], ctx["id_amb"])
    assert ctx["q"] not in labels
    return {"opcoes": [(h, o) for h in sorted(labels) for o in sorted(labels[h])]}


def vote_multilabel(top, db, ctx, knn):
    with db.session() as s:
        res = knn.knn_sugerir(s, _index(top, db), ctx["id_amb"], ctx["q"], k=3,
                              multi_label=True)
    return res


@pytest.mark.parametrize("case,multi", [
    (vote_near_cluster, False), (vote_unindexed_and_other_ambiente, False),
    (labels_scoped_to_ambiente, False), (vote_multilabel, True),
], ids=lambda c: getattr(c, "__name__", str(c)))
def test_vote_matches_the_reference(tmp_path, case, multi):
    results = []
    for top in PACKAGES:
        db = _fresh_db(top, tmp_path / f"{top}.db")
        ctx = _seed(top, db, multi=multi)
        knn = importlib.import_module(f"{top}.runtime.knn_suggest")
        res = case(top, db, ctx, knn)
        if case is labels_scoped_to_ambiente:
            res = {"opcoes": [(h, ctx["texts"][o]) for h, o in res["opcoes"]]}
        else:
            res = _by_text(res, ctx["texts"])
        results.append(res)
    want, got = results
    assert [t for t, _ in got["opcoes"]] == [t for t, _ in want["opcoes"]]
    if case is not labels_scoped_to_ambiente:
        np.testing.assert_allclose([sc for _, sc in got["opcoes"]],
                                   [sc for _, sc in want["opcoes"]], atol=1e-6, rtol=0)
        if got["opcoes"] and not multi:
            assert sum(sc for _, sc in got["opcoes"]) == pytest.approx(1.0)
    assert {k: v for k, v in got.items() if k != "opcoes"} == \
        {k: v for k, v in want.items() if k != "opcoes"}


async def _drive(app, ctx) -> dict:
    out = {}
    async with httpx.AsyncClient(transport=httpx.ASGITransport(app=app),
                                 base_url="http://t") as c:
        r = await c.post("/auth/login", data={"username": "knn@x.com", "password": "SenhaBoa1"})
        assert r.status_code == 200
        c.cookies.clear()
        esp = {"Authorization": f"Bearer {r.json()['access_token']}"}
        base = f"/classificacoes/ambiente/{ctx['id_amb']}/sugerir-vizinhos"
        r = await c.get(f"{base}/{ctx['q']}?k=3", headers=esp)
        assert r.status_code == 200, r.text
        body = r.json()
        body["opcoes"] = [(o["texto_opcao"], o["score"]) for o in body["opcoes"]]
        out["vote"] = body
        r = await c.get(f"/classificacoes/ambiente/{ctx['id_amb']}/priorizadas", headers=esp)
        out["priorizadas"] = (r.status_code,
                              sorted(img["content_hash"] for img in r.json()["imagens"]))
        out["edges"] = [
            (await c.get(f"{base}/{'f' * 64}", headers=esp)).status_code,
            (await c.get(f"{base}/{ctx['q']}?k=zz", headers=esp)).status_code,
            (await c.get(f"{base}/{ctx['q']}")).status_code,
        ]
    return out


def _stored(top, db, q, texts):
    m = importlib.import_module(f"{top}.db.models")
    with db.session() as s:
        row = s.query(m.SugestaoModelo).filter(m.SugestaoModelo.id_img == q).first()
        return (row.modelo, [(c["texto_opcao"], c["score"]) for c in row.classes],
                row.score, row.incerteza, texts[str(row.id_opc)])


@pytest.mark.anyio
async def test_sugerir_vizinhos_over_http_matches_the_reference(tmp_path):
    """The route's vote, its stored ``knn:<backbone>`` suggestion (with the
    uncertainty that ranks ``priorizadas``) and its 404/422/401 edges."""
    from ics_tpu.core.config import reload_settings as ref_reload
    from ics_tpu.main import create_app as ref_app
    from ics_tpu_torch.core.config import reload_settings
    from ics_tpu_torch.main import create_app
    from ics_tpu_torch.runtime.engine import InferenceEngine
    from ics_tpu_torch.runtime.service import InferenceService

    settings = dict(TPU_ENABLE_INFERENCE="true", TPU_MESH_SHAPE="1",
                    TPU_DEFAULT_MODEL="resnet_tiny", TPU_NUM_CLASSES="8",
                    TPU_PRECISION="fp32", TPU_CANVAS="64", TPU_BATCH_BUCKETS="2",
                    TPU_BATCH_DEADLINE_US="20000", TPU_WARMUP_ON_STARTUP="false",
                    TPU_DEVICE_DECODE="false", TPU_WEIGHTS_DIR=str(tmp_path / "w"))
    answers = []
    ref_reload(**settings)
    try:
        db = _fresh_db("ics_tpu", tmp_path / "ref.db")
        app = ref_app(db=db)
        await app.startup()
        try:
            ctx = _seed("ics_tpu", db, modelo="resnet_tiny")
            answers.append((await _drive(app, ctx), _stored("ics_tpu", db, ctx["q"], ctx["texts"])))
        finally:
            await app.shutdown()
    finally:
        ref_reload()
    reload_settings(**settings)
    try:
        service = InferenceService(
            InferenceEngine("resnet_tiny", num_classes=8, precision="fp32", buckets=(2,),
                            canvas=64, device="cpu"), device_decode=False)
        await service.start()
        db = _fresh_db("ics_tpu_torch", tmp_path / "port.db")
        app = create_app(db=db)
        app.state.engine = service
        await app.startup()
        try:
            ctx = _seed("ics_tpu_torch", db, modelo="resnet_tiny")
            answers.append((await _drive(app, ctx),
                            _stored("ics_tpu_torch", db, ctx["q"], ctx["texts"])))
        finally:
            await app.shutdown()
            await service.stop()
    finally:
        reload_settings()
    (want, want_row), (got, got_row) = answers
    assert got["vote"]["modelo"] == "knn:resnet_tiny" and got["vote"]["vizinhos"] == 3
    assert [t for t, _ in got["vote"]["opcoes"]] == [t for t, _ in want["vote"]["opcoes"]] \
        == ["A", "B"]
    np.testing.assert_allclose([s for _, s in got["vote"]["opcoes"]],
                               [s for _, s in want["vote"]["opcoes"]], atol=1e-6)
    assert sum(s for _, s in got["vote"]["opcoes"]) == pytest.approx(1.0)
    for key in ("content_hash", "modelo", "vizinhos"):
        assert got["vote"][key] == want["vote"][key]
    assert got["priorizadas"] == want["priorizadas"] and ctx["q"] in got["priorizadas"][1]
    assert got["edges"] == want["edges"] == [404, 422, 401]
    assert got_row[0] == want_row[0] == "knn:resnet_tiny" and got_row[4] == want_row[4] == "A"
    np.testing.assert_allclose([s for _, s in got_row[1]] + [got_row[2], got_row[3]],
                               [s for _, s in want_row[1]] + [want_row[2], want_row[3]],
                               atol=1e-6)
