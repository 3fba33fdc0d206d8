from keep_tpu_torch.models import bert, keep, vit  # noqa: F401
