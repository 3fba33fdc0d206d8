"""The ``keep`` operator namespace: each hand-written kernel's C entry point
as a PyTorch operator (``torch.ops.keep.*``).

Each operator has a schema, a CUDA implementation (the ctypes launch of the
kernel, which counts its launch), a CPU implementation (the kernel's plain
version) and a fake implementation (the output's shape and dtype, read from
the inputs' metadata alone). The dispatcher picks the implementation from
the tensors' device, so a traced program (``torch.export``) records the
operator itself rather than one device's branch, and an exported graph
launches the same kernels when it is loaded and run. The low-level
``torch.library.Library`` registration is used: it adds less host time to
a call than the ``custom_op`` decorator.

The wrappers' modules (``flash_attention``, ``_kops``, ``ln_matmul``) each
define their operators here at import; ``import keep_tpu_torch.kernels``
registers all of them.

A CUDA implementation launches on the card of its first tensor argument,
whichever card is current in the caller: the kernels' C code reads the
current device (its SM count, its shared-memory opt-in) and launches on
that device's current stream, so ``on_device`` makes the tensor's card
current for the call.
"""

from __future__ import annotations

import functools

import torch

LIB = torch.library.Library("keep", "DEF")


def on_device(cuda):
    """``cuda(x, ...)`` run with ``x``'s card current."""
    @functools.wraps(cuda)
    def run(x, *args, **kwargs):
        with torch.cuda.device(x.device):
            return cuda(x, *args, **kwargs)
    return run


def define(schema: str, cuda, cpu, fake) -> None:
    """Defines ``keep::<schema>`` with its CUDA (on the first tensor's
    card), CPU and fake implementations."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, on_device(cuda), "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"keep::{name}", fake, lib=LIB)
