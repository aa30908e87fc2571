"""Routing decision at the reference's "PixArt-256" attention shapes, on one
H100: the counterpart of the JAX package's ``scripts/exp_attn_pixart256.py``.

    python -m ecad_tpu_torch.scripts.exp_attn_pixart256 [--reps N] [--device cpu]

The shapes are the reference's as they stand (its T=1024 is a 512²-class
token count; PixArt-α 256² serves 256 image tokens — ROADMAP §3):

* self-attention B64 H16 T1024 D72, no bias (bench batch 32 × CFG);
* cross-attention from those queries to 120 text keys under a key-padding
  bias that keeps 100 (0 / −1e9, fp32, (B, 1, 1, 120));
* FLUX's 768-token joint self-attention (256 packed latent + 512 text) at
  B8 H24, head dim 128 (full width) and 64 (the reference's width-reduced
  dim-1536 model).

Rows, each in the place of the reference's: ``xla`` — one
``scaled_dot_product_attention`` call (a float mask for the bias); ``single_tile``
— the exact single-tile route, K1 (K2 with the bias), forced at every
shape as the reference forces it with ``fused_attention.__wrapped__``
(`single_tile_attention`); ``rowblock`` — the row-block clamp softmax
(`rowblock_attention`), at the self-attention shape only, as in the
reference. Nothing else: the reference times nothing else here.

Each row prints the device ms per call (`utils.timing.device_ms`) and, in
``detail``, the card and the largest error against the plain exact softmax
(`fused_attention_reference`) on a 2-head slice. With ``--device cpu`` the
plain versions run at whatever `SHAPES` holds (tests shrink it); no time is
taken there and ``value`` is null.
"""

from __future__ import annotations

import argparse
import json

import torch
from torch.nn import functional as F

from ecad_tpu_torch import resolve_device
from ecad_tpu_torch.ops import (
    fused_attention_reference,
    rowblock_attention,
    single_tile_attention,
)
from ecad_tpu_torch.utils.timing import card_name, device_ms

SHAPES = {
    "p256_self": dict(b=64, h=16, tq=1024, tk=1024, d=72),
    "p256_cross": dict(b=64, h=16, tq=1024, tk=120, d=72, keep=100),
    "flux256_fullwidth_self": dict(b=8, h=24, tq=768, tk=768, d=128),
    "flux256_dim1536_self": dict(b=8, h=24, tq=768, tk=768, d=64),
}


def xla(q, k, v, bias=None):
    """One library call, (B, T, H, D) in and out; the bias as a float mask."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=None if bias is None else bias.to(q.dtype),
    ).transpose(1, 2)


def rows_of(name: str) -> dict:
    """The rows the reference times at shape `name`, in its order."""
    rows = {"xla": xla, "single_tile": single_tile_attention}
    if name == "p256_self":
        rows["rowblock"] = rowblock_attention
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reps", type=int, default=7)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = card_name() if on_card else "cpu"
    out = []
    for name, s in SHAPES.items():
        b, h, d = s["b"], s["h"], s["d"]
        gen = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn((b, s["tq"], h, d), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, s["tk"], h, d), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        bias = None
        if "keep" in s:
            keep = torch.arange(s["tk"], device=dev) < s["keep"]
            bias = torch.where(keep, 0.0, -1e9)[None, None, None, :].expand(b, 1, 1, -1)
            bias = bias.contiguous()
        sl = (slice(None), slice(None), slice(0, 2))
        want = fused_attention_reference(q[sl], k[sl], v[sl], bias).float()
        for label, fn in rows_of(name).items():
            got = fn(q, k, v, bias)
            err = float((got[sl].float() - want).abs().max())
            del got
            ms = device_ms(lambda: fn(q, k, v, bias), reps=args.reps, inner=10)[0] if on_card else None
            row = {"metric": f"{name}_{label}", "value": ms, "unit": "ms",
                   "detail": {"shape": s, "max_abs_err_vs_plain": err, "card": card}}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
