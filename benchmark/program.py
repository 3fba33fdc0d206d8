"""What the benchmark takes from the program (``keep_tpu_torch``): the model
as a deployment builds it, and the program's own launch counters. Nothing
here computes a reference value."""

from __future__ import annotations

import torch


def keep_config(config: dict):
    """The program's ``KEEPConfig`` of a configuration file's ``model``."""
    from keep_tpu_torch.configs import BertConfig, KEEPConfig, ViTConfig

    m = config["model"]
    return KEEPConfig(vision=ViTConfig(**m["vision"]),
                      text=BertConfig(**m["text"]),
                      projection_dim=m["projection_dim"],
                      max_text_length=m["max_text_length"])


def build_keep(config: dict, state_dict: dict, device):
    """The served model of ``config`` from a released-layout fp32 state
    dict, as ``KEEPModel.from_pretrained`` builds it: bf16 compute with the
    fused attention, and for ``precision: int8`` the W8A8 model that
    ``from_pretrained(quantize=True)`` returns (quantized from the fp32
    values, no calibration)."""
    from keep_tpu_torch.compat.torch_loader import load_keep_state_dict
    from keep_tpu_torch.models.keep import KEEPModel

    cfg = keep_config(config)
    precision = config["precision"]
    if precision not in ("bf16", "int8"):
        raise ValueError(f"unknown precision {precision!r}")
    int8 = precision == "int8"
    model = KEEPModel(cfg, dtype=torch.bfloat16, use_flash=True,
                      device=device,
                      weight_dtype=torch.float32 if int8 else None)
    model.load_state_dict(load_keep_state_dict(state_dict, cfg), strict=True)
    if int8:
        model = model.quantize()
    want_tanh = config["block_gelu"] == "tanh"
    if model.gelu_approx != want_tanh:
        raise ValueError(f"the program runs the blocks' GELU "
                         f"{'tanh' if model.gelu_approx else 'erf'}, the "
                         f"configuration states {config['block_gelu']}")
    return model.eval()


def launches() -> dict[str, int]:
    """The program's launch counters of the kernels a trace is held to."""
    from keep_tpu_torch.kernels import _kops
    from keep_tpu_torch.kernels import flash_attention as fa

    return {"attention": fa.LAUNCHES + fa.HEADS_LAUNCHES,
            "attention_bwd": fa.BWD_LAUNCHES,
            "int8_gemm": _kops.LAUNCHES["int8_gemm"],
            "quant_rows": _kops.LAUNCHES["quant_rows"]}


# device-kernel names (substrings) of each counter in a profiler trace; a
# backward launch runs two kernels, one of them kernel A (``_dq_``)
TRACE_NAMES = {"attention": ("slab_attention_wgmma", "attention_f32"),
               "attention_bwd": ("slab_attention_bwd_wgmma_dq",
                                 "slab_attention_bwd_f32_dq"),
               "int8_gemm": ("int8_gemm_kernel",),
               "quant_rows": ("quant_rows_kernel",)}
