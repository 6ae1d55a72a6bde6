"""The port's training data source (``ics_tpu_torch/train/data.py``) against the
JAX package's (``ics_tpu/train/data.py``), mirroring the dataset tests of
``tests/test_train.py`` and ``tests/test_distill.py``: one seeded SQLite
database read by both, and every function's output compared as it is
(examples, class maps, splits, and the staged batches array for array)."""

import json

import numpy as np
import pytest

from ics_tpu.train import data as jdata
from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.security import sha256_hex
from ics_tpu_torch.db.engine import Database
from ics_tpu_torch.db.models import (
    Ambiente,
    AmbienteConjuntoImagens,
    Classificacao,
    ConjuntoImagens,
    Imagem,
    Opcao,
    SugestaoModelo,
    TipoUsuario,
    Usuario,
    UsuarioAdministrador,
    UsuarioConvencional,
)
from ics_tpu_torch.train import data as tdata
from tests.fake_nextcloud import make_jpeg


@pytest.fixture()
def labeled_db(tmp_path):
    db = Database(f"sqlite:///{tmp_path}/train.db")
    db.create_all()
    now = tz.utcnow()
    rng = np.random.default_rng(0)
    blobs = {}
    with db.session() as s:
        s.add(TipoUsuario(id_tipo=1, nome="convencional"))
        s.add(TipoUsuario(id_tipo=2, nome="admin"))
        user = Usuario(nome_completo="A B", email="a@b.c", senha_hash="h", data_criado=now,
                       id_tipo=2)
        s.add(user)
        s.flush()
        adm = UsuarioAdministrador(cpf="1" * 11, id_usu=user.id_usu)
        s.add(adm)
        cons = []
        for i, email in enumerate(("c@d.e", "f@g.h")):
            u = Usuario(nome_completo=f"C {i}", email=email, senha_hash="h", data_criado=now,
                        id_tipo=1)
            s.add(u)
            s.flush()
            con = UsuarioConvencional(cpf=str(i + 2) * 11, id_usu=u.id_usu)
            s.add(con)
            cons.append(con)
        cnj = ConjuntoImagens(nome_conj="f", caminho_conj="/f", file_id="1", data_proc=now,
                              data_sinc=now)
        s.add(cnj)
        s.flush()
        amb = Ambiente(titulo_amb="T", descricao_questionario="d", data_criado=now,
                       id_adm=adm.id_adm)
        s.add(amb)
        s.flush()
        s.add(AmbienteConjuntoImagens(id_amb=amb.id_amb, id_cnj=cnj.id_cnj,
                                      data_associado=now))
        opts = [Opcao(texto=t, id_amb=amb.id_amb) for t in ("gato", "cão", "pássaro")]
        s.add_all(opts)
        s.flush()
        for i in range(12):
            data = make_jpeg(i, size=(int(rng.integers(40, 90)), int(rng.integers(40, 90))))
            h = sha256_hex(data)
            blobs[h] = data
            s.add(Imagem(content_hash=h, nome_img=f"{i}.jpg", caminho_img=f"f/{i}.jpg",
                         data_proc=now, data_sinc=now, id_cnj=cnj.id_cnj,
                         existe_no_nextcloud=i != 11))
            if i < 9:
                for k, con in enumerate(cons[: 1 + (i % 3 == 0)]):
                    s.add(Classificacao(id_con=con.id_con, id_img=h,
                                        id_opc=opts[(i + k) % 3].id_opc, data_criado=now,
                                        ativo=True))
            else:
                s.add(SugestaoModelo(id_img=h, id_amb=amb.id_amb, id_opc=opts[i % 3].id_opc,
                                     modelo="resnet50", score=0.5 + 0.05 * i,
                                     classes=json.dumps([{"id_opc": str(opts[i % 3].id_opc),
                                                          "score": 0.5 + 0.05 * i}]),
                                     data_criado=now))
        s.commit()
        amb_id = amb.id_amb
    return db, amb_id, blobs


@pytest.mark.parametrize("multi_label", [False, True])
def test_labeled_and_suggested_examples_match_the_reference(labeled_db, multi_label):
    db, amb_id, _ = labeled_db
    ours, cmap = tdata.labeled_examples(db, amb_id, multi_label=multi_label)
    ref, ref_map = jdata.labeled_examples(db, amb_id, multi_label=multi_label)
    assert ours == ref and cmap == ref_map and len(ours) == 9
    fixed = dict(list(cmap.items())[:2])
    assert tdata.labeled_examples(db, amb_id, multi_label, fixed) == \
        jdata.labeled_examples(db, amb_id, multi_label, fixed)
    assert tdata.inverse_map(cmap) == jdata.inverse_map(cmap)
    for score in (0.9, 0.5):
        sug = tdata.suggested_examples(db, amb_id, cmap, score, multi_label=multi_label)
        assert sug == jdata.suggested_examples(db, amb_id, cmap, score,
                                               multi_label=multi_label)
    assert len(tdata.suggested_examples(db, amb_id, cmap, 0.5)) == 2   # one is detached


def test_split_matches_the_reference(labeled_db):
    db, amb_id, _ = labeled_db
    examples, _ = tdata.labeled_examples(db, amb_id)
    for fraction, seed in ((0.25, 3), (0.5, 0), (0.0, 1)):
        assert tdata.split_examples(examples, fraction, seed) == \
            jdata.split_examples(examples, fraction, seed)


@pytest.mark.parametrize("multi_label", [False, True])
def test_batches_match_the_reference(labeled_db, multi_label):
    db, amb_id, blobs = labeled_db
    examples, cmap = tdata.labeled_examples(db, amb_id, multi_label=multi_label)
    bad = examples[2]["content_hash"]

    def fetch(h, _path):
        if h == bad:
            raise OSError("gone")
        return blobs[h]

    kw = dict(batch_size=4, canvas=128, seed=5, epochs=2, with_counts=True,
              num_classes=len(cmap) if multi_label else None)
    ours = list(tdata.prefetch(tdata.batch_iterator(examples, fetch, **kw)))
    ref = list(jdata.batch_iterator(examples, fetch, **kw))
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours, ref):
        assert len(a) == len(b) == 4
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == y.dtype
        assert a[3] == b[3]
    assert sum(b[3] for b in ours) == 2 * (len(examples) - 1)   # padded and failed rows


def test_prefetch_passes_the_producers_error_on():
    def broken():
        yield 1
        raise RuntimeError("decode failed")

    it = tdata.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
