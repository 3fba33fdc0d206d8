"""Host helpers: logging, metric writers, batch prefetch, the card's round
trip and copy rate, profiling, and the kernels' compiler flags and
resources (counterparts of ``keep_tpu/utils``)."""
