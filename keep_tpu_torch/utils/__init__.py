"""Host helpers of the training entry point: logging, metric writers and
batch prefetch (counterparts of ``keep_tpu/utils``)."""
