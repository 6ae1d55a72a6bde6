"""The port's fine-tune job manager (``ics_tpu_torch.train.job``) on the CPU,
mirroring the reference's pins of ``tests/test_cancel_job.py``,
``tests/test_train_serve_e2e.py`` (pretrained backbone, early stopping,
``avaliar_cada`` alone, re-evaluation), ``tests/test_distill.py`` and
``tests/test_multilabel.py``, at ``resnet_tiny``, fp32, canvas 64, batch 4.

The jobs run on worker threads as in the service; each test waits for its
job's terminal status. Only a manager given ``device="cpu"`` trains here: one
with no device named asks for the card and raises where there is none. The
file imports no JAX, so ``tests/test_torch_cuda.py`` seeds its job on the
card with it.
"""

import os
import time

import numpy as np
import pytest
import torch

from ics_tpu_torch.core import timezone as tz
from ics_tpu_torch.core.security import hash_password, sha256_hex
from ics_tpu_torch.db import models as m
from ics_tpu_torch.db import seed
from ics_tpu_torch.db.engine import Database
from ics_tpu_torch.train.checkpoint import CheckpointManager
from ics_tpu_torch.train.job import TrainingJobManager, TrainingUnavailable
from ics_tpu_torch.tools.fake_nextcloud import make_jpeg

ID_JOB_OLD = "0123456789ab"      # a job id (12 hex digits) no job of these tests has
TINY = dict(max_steps=3, batch_size=4, epochs=50, canvas=64, compute_dtype="fp32")


def seed_ambiente(db, labeled: int = 8, unlabeled: int = 2, multi: bool = False,
                  textos=("gato", "cão"), tag: str = "t") -> dict:
    """A specialist (``esp@x.com``) with access to an ambiente of two
    options, ``labeled + unlabeled`` synced JPEGs of 60 px, and one label for
    each of the first ``labeled``: alternating options, or, with ``multi``, a
    ``multipla_escolha`` ambiente whose even images carry both options. The
    images are drawn from ``tag``, so ambientes of other tags share none."""
    now = tz.utcnow()
    out = {"blobs": {}, "unlabeled": []}
    with db.session() as s:
        esp = s.fetchone("SELECT id_usu FROM usuarios WHERE email = ?", ["esp@x.com"])
        if esp is None:
            usuario = m.Usuario(nome_completo="Especialista", email="esp@x.com",
                                senha_hash=hash_password("SenhaBoa1"), data_criado=now,
                                id_tipo=1)
            s.add(usuario)
            s.flush()
            s.add(m.UsuarioConvencional(cpf="2" * 11, id_usu=usuario.id_usu))
            s.flush()
            esp = {"id_usu": usuario.id_usu}
        con = s.fetchone("SELECT id_con FROM usuarios_convencionais WHERE id_usu = ?",
                         [esp["id_usu"]])
        adm = s.fetchone("SELECT id_adm FROM usuarios_administradores LIMIT 1")
        cnj = m.ConjuntoImagens(nome_conj=tag, caminho_conj=f"/{tag}", file_id=tag,
                                imagens_sincronizadas=True, data_proc=now, data_sinc=now)
        s.add(cnj)
        s.flush()
        amb = m.Ambiente(titulo_amb=f"Treino {tag}", descricao_questionario="d",
                         data_criado=now, id_adm=adm["id_adm"], multipla_escolha=multi)
        s.add(amb)
        s.flush()
        s.add(m.AmbienteConjuntoImagens(id_amb=amb.id_amb, id_cnj=cnj.id_cnj,
                                        data_associado=now))
        s.add(m.UsuarioAmbiente(id_con=con["id_con"], id_amb=amb.id_amb, data_associado=now))
        options = [m.Opcao(texto=t, id_amb=amb.id_amb) for t in textos]
        s.add_all(options)
        s.flush()
        for i in range(labeled + unlabeled):
            data = make_jpeg(i + 1000 * ord(tag[0]) + (100 if multi else 0), size=(60, 60))
            h = sha256_hex(data)
            out["blobs"][h] = data
            s.add(m.Imagem(content_hash=h, nome_img=f"{i}.jpg", caminho_img=f"{tag}/{i}.jpg",
                           data_proc=now, data_sinc=now, id_cnj=cnj.id_cnj))
            if i >= labeled:
                out["unlabeled"].append(h)
                continue
            chosen = ([options[1]] + ([options[0]] if i % 2 == 0 else []) if multi
                      else [options[i % 2]])
            for o in chosen:
                s.add(m.Classificacao(id_con=con["id_con"], id_img=h, id_opc=o.id_opc,
                                      data_criado=now, ativo=True))
        s.commit()
        out["id_amb"] = str(amb.id_amb)
        out["opcoes"] = {str(o.id_opc): o.texto for o in options}
    return out


def seeded_manager(tmp_path, **kwargs):
    """(a CPU manager over a fresh database holding one seeded ambiente,
    its ambiente's id); ``kwargs`` go to ``seed_ambiente``."""
    db = Database(f"sqlite:///{tmp_path}/jobs.db")
    db.create_all()
    seed.seed_all(db)
    amb = seed_ambiente(db, **kwargs)
    blobs = amb["blobs"]
    manager = TrainingJobManager(db, tmp_path / "weights", fetch_bytes=lambda h, _p: blobs[h],
                                 device="cpu")
    manager.seeded = amb
    return manager, amb["id_amb"]


def wait(job, timeout: float = 120.0):
    deadline = time.monotonic() + timeout
    while job.status in ("pendente", "executando"):
        assert time.monotonic() < deadline, job.to_dict()
        time.sleep(0.05)
    return job


def _rows(manager, id_amb):
    from ics_tpu_torch.crud import modelo_crud

    with manager.db.session() as s:
        return modelo_crud.listar_modelos(s, id_amb=id_amb)


def test_no_device_named_and_no_card_refuses_to_start(tmp_path, monkeypatch):
    """No fallback: a manager with no device named asks for the card; where
    none is visible ``start`` (and ``start_evaluation``) raise before the
    slot is claimed, and nothing trains on the CPU."""
    manager, id_amb = seeded_manager(tmp_path)
    manager.device = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TrainingUnavailable, match="CUDA"):
        manager.start(id_amb, "resnet_tiny", **TINY)
    assert manager.jobs == {} and manager._running is None
    # the request's shape is still checked first: a malformed one is a
    # ValueError (422 at the route) whatever the device
    with pytest.raises(ValueError):
        manager.start(id_amb, "resnet_tiny", eval_fraction=1.0)
    manager.fetch_bytes = None
    with pytest.raises(TrainingUnavailable, match="fonte de bytes"):
        manager.start(id_amb, "resnet_tiny", **TINY)
    assert not (tmp_path / "weights").exists()


def test_cancel_then_resume_continues_the_count_and_gc_keeps_it(tmp_path):
    manager, id_amb = seeded_manager(tmp_path)
    job = manager.start(id_amb, "resnet_tiny", **{**TINY, "max_steps": 10_000,
                                                  "epochs": 10_000})
    with pytest.raises(RuntimeError, match="já em execução"):
        manager.start(id_amb, "resnet_tiny", **TINY)
    deadline = time.monotonic() + 60
    while len(job.history) < 2:
        assert time.monotonic() < deadline and job.status == "executando", job.to_dict()
        time.sleep(0.02)
    with pytest.raises(KeyError):
        manager.cancel("nope")
    manager.cancel(job.id_job)
    wait(job)
    assert job.status == "cancelado" and job.id_mod is None and _rows(manager, id_amb) == []
    with pytest.raises(RuntimeError, match="não está em execução"):
        manager.cancel(job.id_job)
    cancelled = len(job.history)
    assert CheckpointManager(job.ckpt_dir).latest_step() == cancelled
    job2 = wait(manager.start(id_amb, "resnet_tiny", **{**TINY, "max_steps": 2},
                              retomar_de=job.id_job))
    assert job2.status == "concluido", job2.to_dict()
    assert [h["step"] for h in job2.history] == [cancelled + 1, cancelled + 2]
    assert job2.ckpt_dir == job.ckpt_dir
    rows = _rows(manager, id_amb)
    assert len(rows) == 1 and rows[0].passo == cancelled + 2 and rows[0].ativo
    # GC: the registered dir stays, an old orphan goes, a recent one stays
    root = tmp_path / "weights" / id_amb / "resnet_tiny"
    orphan, fresh = root / "deadbeef0000", root / "deadbeef0001"
    for d in (orphan, fresh):
        d.mkdir(parents=True)
        (d / "marker.txt").write_text("x")
    old = time.time() - 3600
    os.utime(orphan, (old, old))
    gc = manager.gc_checkpoints()
    assert gc["removidos"] == [f"{id_amb}/resnet_tiny/deadbeef0000"]
    assert not orphan.exists() and fresh.exists() and os.path.isdir(job.ckpt_dir)
    assert gc["mantidos"] >= 2


@pytest.mark.parametrize("bad", [
    {"retomar_de": "../../x/y/z"}, {"retomar_de": ".."}, {"retomar_de": "abc/def"},
    {"retomar_de": "ABCDEF123456"}, {"retomar_de": "zz"},
    {"eval_fraction": 1.0}, {"eval_fraction": 1.5}, {"eval_fraction": -0.1},
    {"batch_size": -1}, {"paciencia": -1}, {"paciencia": 2, "eval_fraction": 0.0},
    {"avaliar_cada": 0}, {"avaliar_cada": 2, "eval_fraction": 0.0}, {"llrd": 1.5},
    {"llrd": -0.2}, {"ema_decaimento": 1.5}, {"acumular_gradientes": 0},
    {"otimizador": "lion"}, {"agenda_lr": "degrau"}, {"suavizacao_rotulo": 1.5},
    {"augmentar": False, "mixup_alpha": 0.2}, {"cutmix_alpha": -1.0},
], ids=lambda bad: ",".join(f"{k}={v}" for k, v in bad.items()))
def test_a_malformed_request_starts_no_job(tmp_path, bad):
    manager, id_amb = seeded_manager(tmp_path, labeled=2, unlabeled=0)
    with pytest.raises(ValueError):
        manager.start(id_amb, "resnet_tiny", **{**TINY, **bad})
    assert manager.jobs == {}


def test_a_missing_resume_dir_and_too_few_labels_fail_the_job(tmp_path):
    manager, id_amb = seeded_manager(tmp_path, labeled=1, unlabeled=1)
    job = wait(manager.start(id_amb, "resnet_tiny", **TINY))
    assert job.status == "falhou" and "dados insuficientes" in job.error
    amb = seed_ambiente(manager.db, tag="u")
    manager.fetch_bytes = lambda h, _p: amb["blobs"][h]
    job = wait(manager.start(amb["id_amb"], "resnet_tiny", **TINY, retomar_de=ID_JOB_OLD))
    assert job.status == "falhou" and "checkpoint de retomada não encontrado" in job.error


def test_zero_steps_registers_nothing(tmp_path):
    manager, id_amb = seeded_manager(tmp_path)

    def down(h, p):
        raise IOError("nextcloud fora do ar")

    manager.fetch_bytes = down
    job = wait(manager.start(id_amb, "resnet_tiny", **TINY))
    assert job.status == "falhou" and "nenhum passo" in job.error
    assert job.id_mod is None and _rows(manager, id_amb) == []
    assert manager._running is None


def test_finetune_from_a_pretrained_backbone(tmp_path):
    """``pesos_iniciais``: a 9-class donor's file, the head drawn anew at the
    ambiente's 2 options; at lr 0 the registered backbone is the donor's."""
    from ics_tpu_torch.models.registry import get_model
    from ics_tpu_torch.train.pretrained import save_npz

    manager, id_amb = seeded_manager(tmp_path)
    donor = get_model("resnet_tiny").build(num_classes=9)
    donor.init_weights(torch.Generator().manual_seed(42))
    pre = tmp_path / "weights" / "pretrained"
    pre.mkdir(parents=True)
    save_npz(pre / "tiny_imagenet.npz", donor.state_dict())
    with pytest.raises(FileNotFoundError, match="não encontrados"):
        manager.start(id_amb, "resnet_tiny", pesos_iniciais="nope.npz")
    job = wait(manager.start(id_amb, "resnet_tiny", **{**TINY, "max_steps": 2}, lr=0.0,
                             pesos_iniciais="tiny_imagenet.npz"))
    assert job.status == "concluido", job.to_dict()
    assert job.params["pesos_iniciais"].endswith("tiny_imagenet.npz")
    row = _rows(manager, id_amb)[0]
    assert row.num_classes == 2
    state = CheckpointManager(row.dir_checkpoint).restore()["state_dict"]
    want = donor.state_dict()
    for k, v in state.items():
        if k.startswith("head."):
            assert v.shape[0] == 2
        elif "running_" not in k and "num_batches" not in k:   # BatchNorm statistics move
            torch.testing.assert_close(v, want[k], atol=1e-6, rtol=0)


def test_early_stopping_registers_the_best_snapshot(tmp_path):
    """paciencia 1, avaliar_cada 1 on a one-image eval split: the binary
    metric stops the loop by step 3, and the best snapshot is what the
    newest checkpoint (step + 1) holds and what the row names."""
    manager, id_amb = seeded_manager(tmp_path)
    job = wait(manager.start(id_amb, "resnet_tiny", **{**TINY, "max_steps": 8}, paciencia=1,
                             avaliar_cada=1))
    assert job.status == "concluido", job.to_dict()
    assert len(job.history) <= 3 and job.params["parou_cedo"] is True
    assert job.params["melhor_passo"] >= 1 and job.params["melhor_eval"] in (0.0, 1.0)
    assert all("eval" in h for h in job.history)
    row = _rows(manager, id_amb)[0]
    assert row.metricas["parou_cedo"] is True
    assert row.metricas["melhor_passo"] == job.params["melhor_passo"]
    mgr = CheckpointManager(row.dir_checkpoint)
    newest = mgr.restore()
    assert mgr.latest_step() == len(job.history) + 1
    assert newest["metadata"]["melhor_passo"] == job.params["melhor_passo"]
    assert "opt_state" in newest                                   # resumable


def test_avaliar_cada_without_paciencia_runs_every_step(tmp_path):
    manager, id_amb = seeded_manager(tmp_path)
    job = wait(manager.start(id_amb, "resnet_tiny", **{**TINY, "max_steps": 4},
                             avaliar_cada=1))
    assert job.status == "concluido", job.to_dict()
    assert len(job.history) == 4 and job.params["parou_cedo"] is False
    assert job.params["melhor_passo"] >= 1 and all("eval" in h for h in job.history)


def test_ema_registers_the_shadow_with_the_models_buffers(tmp_path):
    """EMA on: the checkpoint written as step + 1 holds the shadow's
    parameters and the model's buffers (BatchNorm statistics): a full state
    dict, which serving loads; with avaliar_cada the best snapshot is the
    shadow too."""
    manager, id_amb = seeded_manager(tmp_path)
    job = wait(manager.start(id_amb, "resnet_tiny", **TINY, ema_decaimento=0.5))
    assert job.status == "concluido" and job.params["ema_final"] is True, job.to_dict()
    mgr = CheckpointManager(_rows(manager, id_amb)[0].dir_checkpoint)
    last, ema = mgr.restore(3), mgr.restore(4)
    assert ema["metadata"] == {"step": 3, "ema_final": True}
    shadow = ema["opt_state"]["ema"]
    assert set(shadow) < set(ema["state_dict"])                    # parameters alone
    for k, v in ema["state_dict"].items():
        want = shadow[k] if k in shadow else last["state_dict"][k]
        torch.testing.assert_close(v, want.cpu(), atol=0, rtol=0)
    assert any(not torch.equal(ema["state_dict"][k], last["state_dict"][k]) for k in shadow)
    amb = seed_ambiente(manager.db, tag="e")
    manager.fetch_bytes = lambda h, _p: amb["blobs"][h]
    job = wait(manager.start(amb["id_amb"], "resnet_tiny", **TINY, ema_decaimento=0.5,
                             avaliar_cada=1))
    assert job.status == "concluido" and job.params["ema_final"] is True, job.to_dict()
    best = CheckpointManager(job.ckpt_dir).restore()
    assert best["metadata"]["ema_final"] is True and "melhor_passo" in best["metadata"]
    assert set(best["state_dict"]) == set(ema["state_dict"])


def test_reevaluate_on_the_current_labels(tmp_path):
    manager, id_amb = seeded_manager(tmp_path)
    job = wait(manager.start(id_amb, "resnet_tiny", **{**TINY, "max_steps": 2}))
    assert job.status == "concluido", job.to_dict()
    with pytest.raises(KeyError):
        manager.start_evaluation("nao-existe")
    now = tz.utcnow()
    with manager.db.session() as s:
        op = s.fetchone("SELECT id_opc FROM opcoes WHERE id_amb = ? LIMIT 1", [id_amb])
        con = s.fetchone("SELECT id_con FROM usuarios_convencionais LIMIT 1")
        for h in manager.seeded["unlabeled"]:
            s.add(m.Classificacao(id_con=con["id_con"], id_img=h, id_opc=op["id_opc"],
                                  data_criado=now, ativo=True))
        s.commit()
    for round_ in range(2):
        ev = wait(manager.start_evaluation(job.id_mod, batch_size=4, canvas=64,
                                           compute_dtype="fp32"))
        assert ev.status == "concluido", ev.to_dict()
        assert ev.params["tipo"] == "avaliacao" and ev.params["versao_avaliada"] == 1
        res = ev.params["resultado"]
        assert ev.n_examples == res["exemplos"] == 10
        assert np.asarray(res["eval_por_classe"]["matriz_confusao"]).sum() == 10
        assert all("id_opc" in r for r in res["eval_por_classe"]["por_classe"])
        metricas = _rows(manager, id_amb)[0].metricas
        assert metricas["reavaliacao"]["eval_accuracy"] == ev.eval_accuracy
        assert metricas["exemplos"] == 8
        assert ("reavaliacao_anterior" in metricas) == (round_ == 1)


def test_reevaluating_a_version_the_jax_trainer_wrote_fails_with_the_tool(tmp_path):
    from tests.test_torch_resume import _jax_step

    manager, id_amb = seeded_manager(tmp_path)
    directory = tmp_path / "jax_v1"
    _jax_step(directory, model="swin_micro")
    with manager.db.session() as s:
        from ics_tpu_torch.crud import modelo_crud

        opcoes = list(manager.seeded["opcoes"])
        row = modelo_crud.registrar_modelo(
            s, id_amb=id_amb, nome_modelo="swin_micro", num_classes=2,
            class_map={o: i for i, o in enumerate(opcoes)}, dir_checkpoint=str(directory),
            passo=3, metricas={}, ativar=True)
        s.commit()
        id_mod = str(row.id_mod)
    ev = wait(manager.start_evaluation(id_mod, batch_size=4, canvas=64, compute_dtype="fp32"))
    assert ev.status == "falhou" and "convert_checkpoints.py" in ev.error


def test_a_job_mixes_suggestions_as_pseudo_labels(tmp_path):
    from ics_tpu_torch.crud import modelo_crud

    manager, id_amb = seeded_manager(tmp_path)
    first = next(iter(manager.seeded["opcoes"]))
    with manager.db.session() as s:
        for h in manager.seeded["unlabeled"]:
            modelo_crud.registrar_sugestao(s, h, modelo="resnet_tiny", classes=[],
                                           score=0.95, id_amb=id_amb, id_opc=first)
        s.commit()
    job = wait(manager.start(id_amb, "resnet_tiny", **{**TINY, "max_steps": 2},
                             usar_sugestoes=True))
    assert job.status == "concluido", job.to_dict()
    assert job.n_sugestoes == 2 and job.n_examples > job.n_sugestoes
    assert job.n_train == 7 + 2                                   # 8 labels: 7 train, 1 eval


def test_a_multilabel_job_trains_registers_and_calibrates(tmp_path):
    manager, id_amb = seeded_manager(tmp_path, multi=True, unlabeled=0)
    job = wait(manager.start(id_amb, "resnet_tiny", **TINY, avaliar_cada=1))
    assert job.status == "concluido", job.to_dict()
    assert job.params["multi_rotulo"] is True and job.eval_accuracy is not None
    assert all("eval" in h for h in job.history) and job.params["melhor_passo"] >= 1
    metricas = _rows(manager, id_amb)[0].metricas
    assert metricas["multi_rotulo"] is True
    assert {"f1_micro", "exact_match"} <= set(metricas["eval_multilabel"])
    assert 0.05 <= metricas["limiar"] <= 0.95
    assert metricas["temperatura"] is None


def test_an_out_of_memory_error_fails_the_job_and_frees_the_slot(tmp_path, monkeypatch):
    """A CUDA out-of-memory error in a job ends ``falhou`` with its message
    and releases the slot, as every exception does; the next job runs."""
    from ics_tpu_torch.train import finetune as tft

    manager, id_amb = seeded_manager(tmp_path)

    def out_of_memory(self, *args, **kwargs):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    with monkeypatch.context() as patch:
        patch.setattr(tft.FineTuner, "run", out_of_memory)
        job = wait(manager.start(id_amb, "resnet_tiny", **TINY))
    assert job.status == "falhou" and "out of memory" in job.error
    assert manager._running is None and _rows(manager, id_amb) == []
    job = wait(manager.start(id_amb, "resnet_tiny", **{**TINY, "max_steps": 1}))
    assert job.status == "concluido", job.to_dict()
