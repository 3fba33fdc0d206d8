"""The plain fp32 reference of KEEP's image path, written from the published
description and nothing of the program.

- Preprocessing (the released transform, ``quick_start/keep_inference.py``):
  torchvision ``Resize(224, bicubic)`` on a PIL image, then
  ``CenterCrop(224)``, ``ToTensor`` and ImageNet's mean and std. PIL's
  8-bit bicubic resampler runs two separable passes, width then height,
  with its windowed cubic kernel (a = -0.5, support 2 widened by the
  downscale ratio), and rounds and clips each pass to 0..255.
- The image tower: timm ViT-L/16 (``vit_large_patch16_224`` with
  LayerScale, as KEEP builds it): a stride-16 patch convolution, the CLS
  token, the learned position table, pre-LN blocks with LayerScale, the
  final LayerNorm, CLS pooling; then KEEP's visual head, Linear → GELU →
  Linear, and the L2 norm.
- GELU: the blocks take the form the configuration names. The program runs
  its bf16 and int8 towers with the tanh GELU, as the JAX package it was
  ported from does, where timm's published ViT uses the exact erf form; the
  configuration file states ``block_gelu: tanh`` and the reference computes
  that same function, so that the comparison judges precision and not a
  choice of formula. The visual head's GELU is the exact erf form in both.
- The text tower: HF BERT-base, post-LN blocks with an additive key mask,
  the tanh pooler over [CLS], the L2 norm; the blocks' GELU as the
  configuration names it (``block_gelu``).
- W8A8 (``quant_bits=8``), SmoothQuant's scheme without calibration:
  LayerScale folded into the projection and fc2 first (exact), then each
  weight coded per output channel, ``s = max|w| / 127``, ``q = round(w /
  s)``; each activation row coded at the input of each quantized linear,
  ``s = max|x| / 127``; the integer product exact (float64), then ``acc ·
  s_x · s_w + b``. Quantized: the patch embedding, qkv, the projection,
  fc1, fc2 and both head linears; in BERT q, k, v, the attention output,
  fc1 and fc2 (the pooler and the embeddings stay fp32). ``quant_bits=4``
  is the same scheme at ±7, the control one precision below.

Everything runs in fp32 with TF32 off, in blocks of rows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """fp32 products at full precision on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- preprocessing -----------------------------------------------------------


def pil_bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of PIL's bicubic resample along one axis."""
    def cubic(x: np.ndarray) -> np.ndarray:
        a = -0.5
        x = np.abs(x)
        near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
        return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))

    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        centre = (i + 0.5) * scale
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), in_size)
        xs = np.arange(lo, hi)
        k = cubic((xs + 0.5 - centre) / fscale)
        m[i, lo:hi] = k / k.sum()
    return m


def preprocess(tiles: torch.Tensor, size: int, mean, std) -> torch.Tensor:
    """uint8 [B, H, W, 3] → normalised fp32 [B, size, size, 3]: the
    shortest side to ``size``, the centre crop, PIL's two rounded passes."""
    _, h, w, _ = tiles.shape
    oh, ow = ((size, int(size * w / h)) if h <= w
              else (int(size * h / w), size))
    top, left = round((oh - size) / 2.0), round((ow - size) / 2.0)
    dev = tiles.device
    mh = torch.from_numpy(pil_bicubic_matrix(h, oh)[top: top + size]).to(
        dev, torch.float32)
    mw = torch.from_numpy(pil_bicubic_matrix(w, ow)[left: left + size]).to(
        dev, torch.float32)
    x = tiles.float()
    x = torch.einsum("ow,bhwc->bhoc", mw, x).round().clamp(0.0, 255.0)
    x = torch.einsum("oh,bhwc->bowc", mh, x).round().clamp(0.0, 255.0)
    x = x / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=dev)
    std = torch.tensor(std, dtype=torch.float32, device=dev)
    return (x - mean) / std


def normalize(tiles: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 tiles already at the model's size → normalised fp32 (the
    resize and the crop are the identity there)."""
    dev = tiles.device
    x = tiles.float() / 255.0
    return ((x - torch.tensor(mean, dtype=torch.float32, device=dev))
            / torch.tensor(std, dtype=torch.float32, device=dev))


# ---- the image tower ---------------------------------------------------------


def _codes(x: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric abs-max codes of x's rows (last axis) and their scales."""
    qmax = float(2 ** (bits - 1) - 1)
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-8) / qmax
    return torch.clamp(torch.round(x / s), -qmax, qmax), s


class _Linear:
    """y = x·wᵀ + b in fp32, or its quantized form at ``bits``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, bits: int | None):
        self.bits = bits
        self.b = b.float()
        if bits is None:
            self.w = w.float()
        else:
            q, s = _codes(w.float(), bits)
            self.w, self.s = q.double(), s.reshape(-1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits is None:
            return x @ self.w.t() + self.b
        q, s = _codes(x, self.bits)
        acc = (q.double() @ self.w.t()).float()  # exact: integers < 2^53
        return acc * s * self.s + self.b


def _gelu(x: torch.Tensor, form: str) -> torch.Tensor:
    if form not in ("tanh", "erf"):
        raise ValueError(f"unknown GELU form {form!r}")
    return F.gelu(x, approximate="tanh" if form == "tanh" else "none")


class ImageTower:
    """The fp32 image tower of a released-layout state dict ``sd``."""

    def __init__(self, sd: dict, model: dict, *, block_gelu: str,
                 head_gelu: str, quant_bits: int | None = None):
        v = model["vision"]
        self.d, self.p, self.heads = (v["embed_dim"], v["patch_size"],
                                      v["num_heads"])
        self.eps = v["ln_eps"]
        self.block_gelu, self.head_gelu = block_gelu, head_gelu
        g = lambda k: sd[k].float()  # noqa: E731
        conv = g("visual.patch_embed.proj.weight")
        self.patch = _Linear(conv.reshape(conv.shape[0], -1),
                             g("visual.patch_embed.proj.bias"), quant_bits)
        self.cls, self.pos = g("visual.cls_token"), g("visual.pos_embed")
        self.blocks = []
        for i in range(v["depth"]):
            b = f"visual.blocks.{i}"
            g1, g2 = g(f"{b}.ls1.gamma"), g(f"{b}.ls2.gamma")
            self.blocks.append(dict(
                n1=(g(f"{b}.norm1.weight"), g(f"{b}.norm1.bias")),
                qkv=_Linear(g(f"{b}.attn.qkv.weight"), g(f"{b}.attn.qkv.bias"),
                            quant_bits),
                # LayerScale folded into the projections: exact in fp32's
                # real numbers, and what a W8A8 deployment quantizes
                proj=_Linear(g1[:, None] * g(f"{b}.attn.proj.weight"),
                             g1 * g(f"{b}.attn.proj.bias"), quant_bits),
                n2=(g(f"{b}.norm2.weight"), g(f"{b}.norm2.bias")),
                fc1=_Linear(g(f"{b}.mlp.fc1.weight"), g(f"{b}.mlp.fc1.bias"),
                            quant_bits),
                fc2=_Linear(g2[:, None] * g(f"{b}.mlp.fc2.weight"),
                            g2 * g(f"{b}.mlp.fc2.bias"), quant_bits)))
        self.norm = (g("visual.norm.weight"), g("visual.norm.bias"))
        self.head1 = _Linear(g("visual_head.0.weight"), g("visual_head.0.bias"),
                             quant_bits)
        self.head2 = _Linear(g("visual_head.2.weight"), g("visual_head.2.bias"),
                             quant_bits)

    def _ln(self, x, wb):
        return F.layer_norm(x, (x.shape[-1],), wb[0], wb[1], self.eps)

    def __call__(self, pixels: torch.Tensor) -> torch.Tensor:
        """Normalised [B, H, W, 3] pixels → [B, projection] unit features."""
        b = pixels.shape[0]
        x = pixels.permute(0, 3, 1, 2)
        patches = F.unfold(x, self.p, stride=self.p).transpose(1, 2)
        x = self.patch(patches)  # [B, N, D], (c, ph, pw) as the conv
        x = torch.cat([self.cls.expand(b, 1, self.d), x], 1) + self.pos
        s, h = x.shape[1], self.heads
        for blk in self.blocks:
            qkv = blk["qkv"](self._ln(x, blk["n1"]))
            q, k, v = qkv.view(b, s, 3, h, -1).permute(2, 0, 3, 1, 4)
            att = torch.softmax(q @ k.transpose(-1, -2)
                                * q.shape[-1] ** -0.5, -1) @ v
            x = x + blk["proj"](att.transpose(1, 2).reshape(b, s, self.d))
            m = _gelu(blk["fc1"](self._ln(x, blk["n2"])), self.block_gelu)
            x = x + blk["fc2"](m)
        cls = self._ln(x, self.norm)[:, 0]
        y = self.head2(_gelu(self.head1(cls), self.head_gelu))
        return F.normalize(y, dim=-1)


class TextTower:
    """The fp32 text tower of a released-layout state dict ``sd``."""

    MASK_VALUE = -1e9

    def __init__(self, sd: dict, model: dict, *, block_gelu: str,
                 quant_bits: int | None = None):
        t = model["text"]
        self.d, self.heads, self.eps = (t["hidden_size"],
                                        t["num_attention_heads"], t["ln_eps"])
        self.block_gelu = block_gelu
        g = lambda k: sd[k].float()  # noqa: E731
        e = "text.embeddings."
        self.word = g(e + "word_embeddings.weight")
        self.pos = g(e + "position_embeddings.weight")
        self.type0 = g(e + "token_type_embeddings.weight")[0]
        self.emb_ln = (g(e + "LayerNorm.weight"), g(e + "LayerNorm.bias"))
        self.layers = []
        for i in range(t["num_hidden_layers"]):
            b = f"text.encoder.layer.{i}."
            lin = lambda n: _Linear(g(b + n + ".weight"),  # noqa: E731
                                    g(b + n + ".bias"), quant_bits)
            self.layers.append(dict(
                q=lin("attention.self.query"), k=lin("attention.self.key"),
                v=lin("attention.self.value"),
                out=lin("attention.output.dense"),
                ln1=(g(b + "attention.output.LayerNorm.weight"),
                     g(b + "attention.output.LayerNorm.bias")),
                fc1=lin("intermediate.dense"), fc2=lin("output.dense"),
                ln2=(g(b + "output.LayerNorm.weight"),
                     g(b + "output.LayerNorm.bias"))))
        self.pooler = _Linear(g("text.pooler.dense.weight"),
                              g("text.pooler.dense.bias"), None)

    def _ln(self, x, wb):
        return F.layer_norm(x, (self.d,), wb[0], wb[1], self.eps)

    def __call__(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Token ids and masks [B, S] → [B, hidden] unit features."""
        b, s = ids.shape
        h = self.heads
        x = self._ln(self.word[ids] + self.pos[:s][None] + self.type0,
                     self.emb_ln)
        bias = ((1.0 - mask.float()) * self.MASK_VALUE)[:, None, None, :]
        for L in self.layers:
            q, k, v = (L[n](x).view(b, s, h, -1).transpose(1, 2)
                       for n in ("q", "k", "v"))
            att = torch.softmax(q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
                                + bias, -1) @ v
            x = self._ln(x + L["out"](att.transpose(1, 2).reshape(b, s,
                                                                  self.d)),
                         L["ln1"])
            x = self._ln(x + L["fc2"](_gelu(L["fc1"](x), self.block_gelu)),
                         L["ln2"])
        return F.normalize(torch.tanh(self.pooler(x[:, 0])), dim=-1)


@torch.no_grad()
def image_features(sd: dict, model: dict, tiles: torch.Tensor, *,
                   preprocess_cfg: dict, block_gelu: str, head_gelu: str,
                   quant_bits: int | None = None,
                   rows_per_block: int = 64) -> torch.Tensor:
    """uint8 tiles [N, H, W, 3] → fp32 unit features [N, projection], from
    the fp32 state dict ``sd``, in blocks of ``rows_per_block`` tiles."""
    tower = ImageTower(sd, model, block_gelu=block_gelu, head_gelu=head_gelu,
                       quant_bits=quant_bits)
    out = []
    for i in range(0, tiles.shape[0], rows_per_block):
        px = preprocess(tiles[i: i + rows_per_block], preprocess_cfg["size"],
                        preprocess_cfg["mean"], preprocess_cfg["std"])
        out.append(tower(px))
    return torch.cat(out)
