"""Attention-kernel shoot-out on one H100 at the two headline shapes: the
counterpart of the JAX package's ``scripts/bench_attention_kernels.py``.

    python -m ecad_tpu_torch.scripts.bench_attention_kernels [--turns N] [--device cpu]

Shapes (self-attention, bf16, no bias — what the DiT towers emit), the
reference's:

* ``flux1024``: B2 H24 T4608 D128 (4096 packed latent + 512 text joint)
* ``pixart1024``: B8 H16 T4096 D72 (4096 latent tokens, head dim 72)

Rows, each in the place of the reference's:

* ``sdpa`` — one ``scaled_dot_product_attention`` call (the reference's
  ``xla``, its library path);
* ``flash`` — the streaming exact softmax K6 (`flash_attention`);
* ``rowblock`` — the row-block clamp softmax K5 (`rowblock_attention`).
  The reference sweeps its q-block knob over 128, 256 and 512
  (``rowblock/N``); the port's kernel fixes its own tile (64 query rows a
  consumer warpgroup, keys in 128-key tiles), so it prints one row and
  says so in its ``detail``;
* ``transposed`` — the transposed clamp softmax K4
  (`transposed_attention`), only at the padded head dim (D=72), as in the
  reference;
* ``auto`` — `fused_attention`'s routing, what the models call.

Each row prints the device ms per call (`utils.timing.device_ms`: CUDA
events behind a spin kernel), taken in ``--turns`` turns (the rows in
order, then in reverse, and so on) so the card's clock falls on every row
alike; ``value`` is the median over the turns and ``detail.turns_ms`` each
turn's. ``detail.max_abs_err_vs_fp32`` is the largest error against an
fp32 softmax on a 2-head slice, as the reference's ``fp32_reference``
measures it (heads are independent; the whole (B, H, T, T) fp32 scores at
the PixArt shape would take 8.6 GB). Metric names are the reference's
``attn_{shape}_{label}``.

With ``--device cpu`` the plain versions run at whatever `SHAPES` holds
(tests shrink it); no time is taken there and ``value`` is null.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch
from torch.nn import functional as F

from ecad_tpu_torch import resolve_device
from ecad_tpu_torch.ops import (
    flash_attention,
    fused_attention,
    rowblock_attention,
    transposed_attention,
)
from ecad_tpu_torch.utils.timing import bound_ms, card_name, device_ms

SHAPES = {
    "flux1024": dict(b=2, h=24, t=4608, d=128),
    "pixart1024": dict(b=8, h=16, t=4096, d=72),
}
ROWBLOCK_NOTE = ("one row: the kernel fixes its tile (64 query rows a consumer "
                 "warpgroup, 128-key tiles); the reference's block-q sweep "
                 "(128, 256, 512) has no counterpart")


def sdpa(q, k, v):
    """One library call, (B, T, H, D) in and out."""
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ).transpose(1, 2)


def fp32_reference(q, k, v):
    """fp32 softmax attention on heads 0-1 (the reference's
    ``fp32_reference``)."""
    qf, kf, vf = (x[:, :, :2].float().transpose(1, 2) for x in (q, k, v))
    s = qf @ kf.transpose(-1, -2) / q.shape[-1] ** 0.5
    return (torch.softmax(s, dim=-1) @ vf).transpose(1, 2)


def rows_of(d: int) -> dict:
    """The rows run at head dim `d`, in the reference's order."""
    rows = {"sdpa": sdpa, "flash": flash_attention, "rowblock": rowblock_attention}
    if d % 128:
        rows["transposed"] = transposed_attention
    rows["auto"] = fused_attention
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--reps", type=int, default=7)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = card_name() if on_card else "cpu"
    out = []
    for name, s in SHAPES.items():
        b, h, t, d = s["b"], s["h"], s["t"], s["d"]
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (
            torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(3)
        )
        ref = fp32_reference(q, k, v)
        bound, by = bound_ms(4 * b * t * h * d * q.element_size(), 4 * b * h * t * t * d)
        rows = rows_of(d)
        errs = {}
        for label, fn in rows.items():
            got = fn(q, k, v)
            errs[label] = float((got[:, :, :2].float() - ref).abs().max())
            del got
        turns: dict[str, list] = {label: [] for label in rows}
        if on_card:
            order = list(rows)
            for turn in range(args.turns):
                for label in order if turn % 2 == 0 else order[::-1]:
                    fn = rows[label]
                    turns[label].append(device_ms(lambda: fn(q, k, v), reps=args.reps,
                                                  inner=10)[0])
        for label in rows:
            ms = statistics.median(turns[label]) if turns[label] else None
            detail = {"shape": s, "max_abs_err_vs_fp32": errs[label],
                      "turns_ms": turns[label], "bound_ms": bound, "bound_by": by,
                      "card": card}
            if label == "rowblock":
                detail["block_q"] = ROWBLOCK_NOTE
            row = {"metric": f"attn_{name}_{label}", "value": ms, "unit": "ms",
                   "detail": detail}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
