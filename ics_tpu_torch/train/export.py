"""Trained-model export/import: move a registry version between
deployments (counterpart of ``ics_tpu/train/export.py``, unchanged in
behaviour).

Format: gzip'd tar with ``modelo.json`` (registry metadata; class_map
carries the OPTION TEXTS so the importer can rebind to the target
ambiente's option ids) + the version's checkpoint directory under
``ckpt/``: whatever files it holds. The port's versions hold its
``step_<n>.pt`` files; a package exported by a JAX deployment holds orbax
steps, and is imported and registered all the same. Serving such a version
answers 503 naming ``convert_checkpoints.py`` until that tool has written its
``step_<n>.pt`` files (``runtime.service.InferenceServicePool.get_trained``).
"""

from __future__ import annotations

import io
import json
import tarfile
from pathlib import Path

from ics_tpu_torch.crud import modelo_crud
from ics_tpu_torch.db.models import Opcao

FORMAT_VERSION = 1


def pack_model(db, modelo_row) -> bytes:
    """Registry row -> portable .tar.gz bytes."""
    inv = modelo_crud.inverse_class_map(modelo_row)  # idx -> id_opc
    classes = []
    for idx in sorted(inv):
        opc = db.get(Opcao, inv[idx])
        classes.append({
            "indice": idx,
            "id_opc": inv[idx],
            "texto": opc.texto if opc else None,
        })
    meta = {
        "formato": FORMAT_VERSION,
        "nome_modelo": modelo_row.nome_modelo,
        "versao_origem": modelo_row.versao,
        "num_classes": modelo_row.num_classes,
        "passo": modelo_row.passo,
        "metricas": modelo_row.metricas,
        "classes": classes,
    }
    buf = io.BytesIO()
    ckpt_dir = Path(modelo_row.dir_checkpoint)
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        info = tarfile.TarInfo("modelo.json")
        payload = json.dumps(meta, ensure_ascii=False, default=str).encode()
        info.size = len(payload)
        tar.addfile(info, io.BytesIO(payload))
        for path in sorted(ckpt_dir.rglob("*")):
            if path.is_file():
                tar.add(path, arcname=f"ckpt/{path.relative_to(ckpt_dir)}")
    return buf.getvalue()


class ImportError_(Exception):
    pass


def unpack_model(db, data: bytes, id_amb: str, dest_root: str | Path,
                 ativar: bool = True):
    """Portable tar.gz -> new registry version bound to ``id_amb``.

    Class indices rebind BY OPTION TEXT: the target ambiente must have an
    option with the same text for every exported class (ids differ across
    deployments; texts are the domain identity — ``Opcao.texto`` is
    immutable by design)."""
    try:
        tar = tarfile.open(fileobj=io.BytesIO(data), mode="r:gz")
    except tarfile.TarError as exc:
        raise ImportError_(f"arquivo inválido: {exc}")
    with tar:
        names = tar.getnames()
        if "modelo.json" not in names:
            raise ImportError_("modelo.json ausente no pacote")
        meta = json.loads(tar.extractfile("modelo.json").read())
        if meta.get("formato") != FORMAT_VERSION:
            raise ImportError_(
                f"formato {meta.get('formato')} não suportado"
            )
        # rebind classes by option text
        opcoes = {
            o.texto: str(o.id_opc)
            for o in db.query(Opcao).filter(Opcao.id_amb == str(id_amb)).all()
        }
        class_map = {}
        for cls in meta["classes"]:
            id_opc = opcoes.get(cls["texto"])
            if id_opc is None:
                raise ImportError_(
                    f"ambiente de destino não tem a opção '{cls['texto']}'"
                )
            class_map[id_opc] = int(cls["indice"])
        dest = Path(dest_root) / str(id_amb) / meta["nome_modelo"] / "import"
        n = 0
        while (dest.with_name(f"import_{n}")).exists():
            n += 1
        dest = dest.with_name(f"import_{n}")
        dest.mkdir(parents=True)
        for member in tar.getmembers():
            if not member.name.startswith("ckpt/"):
                continue
            rel = Path(member.name).relative_to("ckpt")
            # refuse path traversal / links
            if member.islnk() or member.issym() or ".." in rel.parts:
                raise ImportError_(f"entrada insegura no pacote: {member.name}")
            target = dest / rel
            if member.isdir():
                target.mkdir(parents=True, exist_ok=True)
            else:
                target.parent.mkdir(parents=True, exist_ok=True)
                with open(target, "wb") as out:
                    out.write(tar.extractfile(member).read())
    row = modelo_crud.registrar_modelo(
        db,
        id_amb=str(id_amb),
        nome_modelo=meta["nome_modelo"],
        num_classes=int(meta["num_classes"]),
        class_map=class_map,
        dir_checkpoint=str(dest),
        passo=int(meta.get("passo") or 0),
        metricas={
            **(meta.get("metricas") or {}),
            "importado": True,
            "versao_origem": meta.get("versao_origem"),
        },
        ativar=ativar,
    )
    return row
