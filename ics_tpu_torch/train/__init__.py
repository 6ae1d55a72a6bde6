"""The trainer of the port (counterpart of ``ics_tpu/train``): the fine-tuner
(``finetune``), its data source (``data``), checkpoints (``checkpoint``), the
pretrained import (``pretrained``), the background jobs behind the
``/treinamento`` routes (``job``), the export and import of a trained version
(``export``) and the CLI (``python -m ics_tpu_torch.train``)."""
