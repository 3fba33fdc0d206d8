"""The plain fp32 reference of KEEP's training step, written from the published
description and nothing of the program.

One step: both towers forward (timm ViT-L/16 with LayerScale and KEEP's
visual head; HF BERT-base with its tanh pooler; both features L2-normed),
HyMetricLoss in its ``lhp-hn`` form (KEEP's training code: DO-related
pairs masked to similarity −1, per-group hard positives as reciprocals of
their exp-mass, the symmetric image→text and text→image halves), the
gradient by autograd, clipping by the global norm (``g · c / ‖g‖`` when
‖g‖ ≥ c), AdamW with optax's conventions (one bias-correction count,
decoupled decay on the matrices and embedding tables, ``p −= lr · u``),
and ``logit_scale`` clamped to [0, ln 100].

GELU is the exact erf form in both towers, as KEEP's trainer runs them.
Each block is recomputed in the backward (``torch.utils.checkpoint``) so
that the reference fits beside nothing else; that changes no value.
Everything runs in fp32 with TF32 off. ``fp8=True`` is the control one
precision below bf16: every linear's operands (x and w forward, dy in the
backward) rounded to float8 (e4m3 forward, e5m2 gradients) at a per-tensor
scale, the products in fp32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LOGIT_SCALE_MAX = math.log(100.0)
MASK_VALUE = -1e9


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp_min(1e-12)
    s = torch.finfo(dtype).max / amax
    return (t * s).to(dtype).float() / s


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dq = _fp8(dy, torch.float8_e5m2)
        dx = dq @ wq
        dw = dq.reshape(-1, dq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        return dx, dw


def make_linear(fp8: bool):
    def lin(x, w, b=None):
        y = _Fp8Linear.apply(x, w) if fp8 else x @ w.t()
        return y if b is None else y + b
    return lin


def _attend(q, k, v, bias=None):
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if bias is not None:
        s = s + bias
    return torch.softmax(s, -1) @ v


def image_tower(P: dict, pixels: torch.Tensor, model: dict, lin) -> torch.Tensor:
    v = model["vision"]
    d, p, h, eps = v["embed_dim"], v["patch_size"], v["num_heads"], \
        v["ln_eps"]
    b = pixels.shape[0]
    x = F.unfold(pixels.permute(0, 3, 1, 2), p, stride=p).transpose(1, 2)
    w = P["visual.patch_embed.proj.weight"]
    x = lin(x, w.reshape(w.shape[0], -1), P["visual.patch_embed.proj.bias"])
    x = torch.cat([P["visual.cls_token"].expand(b, 1, d), x], 1) \
        + P["visual.pos_embed"]
    s = x.shape[1]

    def block(x, i):
        g = lambda n: P[f"visual.blocks.{i}.{n}"]  # noqa: E731
        y = F.layer_norm(x, (d,), g("norm1.weight"), g("norm1.bias"), eps)
        qkv = lin(y, g("attn.qkv.weight"), g("attn.qkv.bias"))
        q, k, vv = qkv.view(b, s, 3, h, -1).permute(2, 0, 3, 1, 4)
        a = _attend(q, k, vv).transpose(1, 2).reshape(b, s, d)
        x = x + g("ls1.gamma") * lin(a, g("attn.proj.weight"),
                                     g("attn.proj.bias"))
        y = F.layer_norm(x, (d,), g("norm2.weight"), g("norm2.bias"), eps)
        y = F.gelu(lin(y, g("mlp.fc1.weight"), g("mlp.fc1.bias")))
        return x + g("ls2.gamma") * lin(y, g("mlp.fc2.weight"),
                                        g("mlp.fc2.bias"))

    for i in range(v["depth"]):
        x = checkpoint(block, x, i, use_reentrant=False)
    cls = F.layer_norm(x, (d,), P["visual.norm.weight"], P["visual.norm.bias"],
                       eps)[:, 0]
    y = F.gelu(lin(cls, P["visual_head.0.weight"], P["visual_head.0.bias"]))
    y = lin(y, P["visual_head.2.weight"], P["visual_head.2.bias"])
    return F.normalize(y, dim=-1)


def text_tower(P: dict, ids: torch.Tensor, mask: torch.Tensor, model: dict,
               lin) -> torch.Tensor:
    t = model["text"]
    d, h, eps = t["hidden_size"], t["num_attention_heads"], t["ln_eps"]
    b, s = ids.shape
    e = "text.embeddings."
    x = (P[e + "word_embeddings.weight"][ids]
         + P[e + "position_embeddings.weight"][:s][None]
         + P[e + "token_type_embeddings.weight"][0])
    x = F.layer_norm(x, (d,), P[e + "LayerNorm.weight"],
                     P[e + "LayerNorm.bias"], eps)
    bias = ((1.0 - mask.float()) * MASK_VALUE)[:, None, None, :]

    def layer(x, i):
        g = lambda n: P[f"text.encoder.layer.{i}.{n}"]  # noqa: E731
        q, k, v = (lin(x, g(f"attention.self.{n}.weight"),
                       g(f"attention.self.{n}.bias")).view(b, s, h, -1)
                   .transpose(1, 2) for n in ("query", "key", "value"))
        a = _attend(q, k, v, bias).transpose(1, 2).reshape(b, s, d)
        x = F.layer_norm(x + lin(a, g("attention.output.dense.weight"),
                                 g("attention.output.dense.bias")), (d,),
                         g("attention.output.LayerNorm.weight"),
                         g("attention.output.LayerNorm.bias"), eps)
        y = F.gelu(lin(x, g("intermediate.dense.weight"),
                       g("intermediate.dense.bias")))
        return F.layer_norm(x + lin(y, g("output.dense.weight"),
                                    g("output.dense.bias")), (d,),
                            g("output.LayerNorm.weight"),
                            g("output.LayerNorm.bias"), eps)

    for i in range(t["num_hidden_layers"]):
        x = checkpoint(layer, x, i, use_reentrant=False)
    pooled = torch.tanh(lin(x[:, 0], P["text.pooler.dense.weight"],
                            P["text.pooler.dense.bias"]))
    return F.normalize(pooled, dim=-1)


def _metric(sim: torch.Tensor, scale: torch.Tensor, n_id: int,
            n_ins: int) -> torch.Tensor:
    """One direction of ``lhp-hn``."""
    dev = sim.device
    eye = torch.eye(n_id, device=dev)
    right = torch.kron(eye, torch.ones(n_ins, 1, device=dev))   # [n, n_id]
    within = torch.kron(eye, torch.ones(n_ins, n_ins, device=dev))
    sign = torch.where(within > 0, -1.0, 1.0)
    e = torch.exp(torch.clamp(sim * scale * sign, max=85.0))
    e = torch.where(e < torch.finfo(e.dtype).tiny, torch.zeros_like(e), e)
    sums = e @ right                                          # [n, n_id]
    safe = torch.where(sums * right == 0, torch.ones_like(sums), sums)
    staged = sums * (1 - right) + right / safe
    gg = right.t() @ staged                                   # [n_id, n_id]
    l1 = gg / gg.abs().sum(1, keepdim=True)
    return -torch.log(torch.diagonal(l1)).mean()


def hy_metric_loss(img, txt, node_connection, scale, caption_num: int):
    n = img.shape[0]
    n_ins = n // caption_num
    sim = img @ txt.t()
    mask = torch.kron(node_connection.float(),
                      torch.ones(n_ins, n_ins, device=sim.device))
    sim = torch.where(mask == -1, torch.full_like(sim, -1.0), sim)
    return (_metric(sim, scale, caption_num, n_ins) / 2
            + _metric(sim.t(), scale, caption_num, n_ins) / 2)


def decayed(key: str, t: torch.Tensor) -> bool:
    """Weight decay on the matrices and the embedding tables (every
    ``*.weight`` of two or more axes); none on biases, LayerNorms, the CLS
    token, the position table of the ViT, LayerScale or ``logit_scale``."""
    return key.endswith(".weight") and t.dim() >= 2


class Trainer:
    """The reference's training state over a released-layout fp32 state
    dict, stepped with ``step(batch)``."""

    def __init__(self, sd: dict, model: dict, opt: dict, caption_num: int,
                 fp8: bool = False):
        self.P = {k: v.detach().clone().float().requires_grad_(True)
                  for k, v in sd.items()}
        self.model, self.opt, self.caption_num = model, opt, caption_num
        self.lin = make_linear(fp8)
        self.mu = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.P.items()}
        self.count = 0

    def loss(self, batch: dict) -> torch.Tensor:
        img = image_tower(self.P, batch["pixels"], self.model, self.lin)
        txt = text_tower(self.P, batch["input_ids"], batch["attention_mask"],
                         self.model, self.lin)
        return hy_metric_loss(img, txt, batch["node_connection"],
                              self.P["logit_scale"].exp(), self.caption_num)

    def step(self, batch: dict) -> tuple[float, dict]:
        """One optimizer step; returns (the loss before it, the clipped
        gradient the optimizer took)."""
        o = self.opt
        loss = self.loss(batch)
        keys = list(self.P)
        grads = dict(zip(keys, torch.autograd.grad(loss, [self.P[k]
                                                          for k in keys])))
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            c = o["grad_clip_norm"]
            if not bool(norm < c):
                grads = {k: g / norm * c for k, g in grads.items()}
            self.count += 1
            bc1 = 1 - o["b1"] ** self.count
            bc2 = 1 - o["b2"] ** self.count
            for k, g in grads.items():
                p = self.P[k]
                self.mu[k].mul_(o["b1"]).add_((1 - o["b1"]) * g)
                self.nu[k].mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
                u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                          + o["eps"])
                if decayed(k, p):
                    u = u + o["weight_decay"] * p
                p.sub_(o["lr"] * u)
            self.P["logit_scale"].clamp_(0.0, LOGIT_SCALE_MAX)
        return float(loss.detach()), grads
