"""The trainer of the port (counterpart of ``ics_tpu/train``): the fine-tuner
(``finetune``), its data source (``data``), checkpoints (``checkpoint``) and
the pretrained import (``pretrained``). The job surface (``job``,
``export``, ``__main__``) is not ported yet."""
