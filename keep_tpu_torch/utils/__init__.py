"""Host helpers: logging, metric writers, batch prefetch, and the card's
round trip and copy rate (counterparts of ``keep_tpu/utils``)."""
