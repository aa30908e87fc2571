"""Attention-variant experiments on one H100: the counterpart of the JAX
package's research harness ``scripts/exp_attn_variants.py``.

    python -m ecad_tpu_torch.scripts.exp_attn_variants [--shape=NAME] [--device cpu]

At each of the harness's headline shapes (`SHAPES`, bf16, no bias) it runs
the attention body with parts of its work taken out, and prints one JSON
line per (shape, variant) as the reference does:

* ``matmul_only`` — bf16(q·kᵀ)·v with no softmax: the floor of the
  tensor-core body (X1, `matmul_only_attention`);
* ``nomax`` — the exp2 softmax without the max (X2, `nomax_attention`);
* ``rowblock`` and ``chunk2`` — the exp2 softmax with the max (X3,
  `max_exp2_attention`; on the TPU ``chunk2`` splits the keys in two for
  dual issue, which changes only the order of the sums: one kernel here);
* ``transposed`` and ``transposed_subk`` — the clamp softmax (K4,
  `transposed_attention`; the two differ only in TPU layout);
* ``transposed_fd`` and ``transposed_subk_fd`` — the clamp softmax with its
  denominator taken by the p·v product (X4, `clamp_fd_attention`).

The ``transposed*`` rows run only where D % 128 != 0, as in the reference.
A row's ``value`` is the device ms per call (CUDA events behind a spin
kernel, `device_ms`); its ``detail`` holds the largest error against the
plain exact softmax (`fused_attention_reference`) on a 2-head slice, as the
reference measures against XLA's (null for ``matmul_only``, whose output is
not normalised), the bound (4·B·H·T²·D flops on the q, k, v and o bytes,
`bound_ms`), the card, the counter its kernel counts launches in and how
many times the row called it.

Left out on purpose: the reference's positional query-tile sizes (``bq``)
and ``--chunks=`` set TPU tile shapes. The kernels here fix their own: on
the Hopper body (X2, X3, X4 and the ``transposed`` rows' K4 at the
harness's head dims) each consumer warpgroup takes 64 query rows and the
keys stream in 128-key tiles; on the ``mma.sync`` body (X1) a block takes
64 query rows and 64-key tiles. So neither knob exists here, and the metric names
drop the reference's ``_bq…``.

Every row needs Tk % 128 == 0: the reference's ``_prep`` and
``_call_transposed`` count their zero pad keys (see `attn_variants`), so
the harness refuses other key counts, also in the ``transposed`` rows
whose kernel (K4) takes any Tk.

With ``--device cpu`` the plain versions run at whatever `SHAPES` holds
(tests shrink it); no time is taken there and ``value`` is null.
"""

from __future__ import annotations

import argparse
import json

import torch

from ecad_tpu_torch import resolve_device
from ecad_tpu_torch.ops import (
    clamp_fd_attention,
    fused_attention_reference,
    matmul_only_attention,
    max_exp2_attention,
    nomax_attention,
    transposed_attention,
)
from ecad_tpu_torch.utils.timing import bound_ms, card_name, device_ms

SHAPES = {
    "flux1024": dict(b=2, h=24, t=4608, d=128),
    "pixart1024": dict(b=8, h=16, t=4096, d=72),
    # a PixArt-512-class D72 shape (T=1024 tokens; batch 32 × CFG 2)
    "pixart512_class_self": dict(b=64, h=16, t=1024, d=72),
}


def _k4(q, k, v):
    """K4 in the ``transposed`` rows, refused where the reference's
    ``_call_transposed`` would count zero pad keys."""
    if k.shape[1] % 128:
        raise ValueError(
            f"Tk={k.shape[1]} is not a multiple of 128: the reference's "
            "transposed bodies count the zero pad keys there"
        )
    return transposed_attention(q, k, v)


VARIANTS = {
    "matmul_only": matmul_only_attention,
    "nomax": nomax_attention,
    "rowblock": max_exp2_attention,
    "chunk2": max_exp2_attention,
}
TRANSPOSED_V2 = ("transposed_fd", "transposed_subk", "transposed_subk_fd")
TRANSPOSED = {
    "transposed": _k4,
    "transposed_fd": clamp_fd_attention,
    "transposed_subk": _k4,
    "transposed_subk_fd": clamp_fd_attention,
}
# the launch counter (ecad_tpu_torch.ops.launch_counts) of each row's kernel
COUNTER = {
    "matmul_only": "xattn_matmul_only",
    "nomax": "xattn_nomax",
    "rowblock": "xattn_max",
    "chunk2": "xattn_max",
    "transposed": "attention_long",
    "transposed_subk": "attention_long",
    "transposed_fd": "xattn_fd",
    "transposed_subk_fd": "xattn_fd",
}


def rows_of(d: int) -> tuple[str, ...]:
    """The variants run at head dim `d`, in the reference's order."""
    return (*TRANSPOSED_V2, "transposed", *VARIANTS) if d % 128 else tuple(VARIANTS)


def main(argv: list[str] | None = None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", action="append", choices=sorted(SHAPES),
                        help="run only this shape (repeatable)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    card = card_name() if on_card else "cpu"
    out = []
    for name, s in SHAPES.items():
        if args.shape and name not in args.shape:
            continue
        b, h, t, d = s["b"], s["h"], s["t"], s["d"]
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (
            torch.randn((b, t, h, d), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(3)
        )
        # heads are independent: the plain softmax on 2 of them is enough,
        # and its fp32 scores fit beside the benchmark's tensors
        ref = fused_attention_reference(q[:, :, :2], k[:, :, :2], v[:, :, :2]).float()
        bound, _ = bound_ms(4 * b * t * h * d * q.element_size(), 4 * b * h * t * t * d)
        for label in rows_of(d):
            fn = VARIANTS.get(label) or TRANSPOSED[label]
            calls = 0

            def call():
                nonlocal calls
                calls += 1
                return fn(q, k, v)

            got = call()
            err = (None if label == "matmul_only"
                   else float((got[:, :, :2].float() - ref).abs().max()))
            del got
            ms = device_ms(call, reps=9, inner=10)[0] if on_card else None
            row = {
                "metric": f"exp_{name}_{label}",
                "value": ms,
                "unit": "ms",
                "detail": {
                    "max_abs_err_vs_plain_bf16": err,
                    "bound_ms": bound,
                    "card": card,
                    "kernel_counter": COUNTER[label],
                    "calls": calls,
                },
            }
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


if __name__ == "__main__":
    main()
