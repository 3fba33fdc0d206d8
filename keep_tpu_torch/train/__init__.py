"""Single-process KEEP training (counterpart of ``keep_tpu/train``):
``python -m keep_tpu_torch.train.main --config cfg.yml``."""
