"""LR schedules as step → lr functions (counterpart of
``keep_tpu/train/schedules.py``). The arithmetic runs in numpy float32, as
the JAX functions run it; only the cosine's last bit may differ."""

from __future__ import annotations

import numpy as np

_f32 = np.float32


def _warmup(base_lr, warmup_length, step):
    return _f32(base_lr) * (step + _f32(1)) / _f32(max(warmup_length, 1))


def const_lr(base_lr: float, warmup_length: int):
    def schedule(step: int) -> float:
        step = _f32(step)
        if step < warmup_length:
            return float(_warmup(base_lr, warmup_length, step))
        return float(_f32(base_lr))

    return schedule


def const_lr_cooldown(base_lr: float, warmup_length: int, steps: int,
                      cooldown_steps: int, cooldown_power: float = 1.0,
                      cooldown_end_lr: float = 0.0):
    start_cooldown = steps - cooldown_steps

    def schedule(step: int) -> float:
        step = _f32(step)
        if step < warmup_length:
            return float(_warmup(base_lr, warmup_length, step))
        if step < start_cooldown:
            return float(_f32(base_lr))
        e = step - _f32(start_cooldown)
        es = _f32(steps - start_cooldown)
        decay = (_f32(1) - e / es) ** _f32(cooldown_power)
        return float(decay * (_f32(base_lr) - _f32(cooldown_end_lr))
                     + _f32(cooldown_end_lr))

    return schedule


def cosine_lr(base_lr: float, warmup_length: int, steps: int):
    def schedule(step: int) -> float:
        step = _f32(step)
        if step < warmup_length:
            return float(_warmup(base_lr, warmup_length, step))
        e = step - _f32(warmup_length)
        es = _f32(steps - warmup_length)
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * e / es))
        return float(cos * _f32(base_lr))

    return schedule
