"""K3, the modulated LayerNorm, on this tree's kernel against an older
tree's, in turns, in one process on one card, at every width a served path
gives it.

    python -m ecad_tpu_torch.scripts.compare_modlnorm_bodies --parent DIR [--out turns.json]

DIR is the root of an older checkout of the port, unpacked for instance
with ``git archive <commit> ecad_tpu_torch | tar -x -C build/parent``. Its
``ecad_tpu_torch/ops`` package is loaded from its files under another
name, so its kernel builds and runs as it would in that tree (before the
Hopper kernel, a Triton body).

Rows (`ROWS`), bf16, with a per-sample scale and shift taken as strided
views of a (B, 6, d) modulation, as the blocks take them: PixArt-256's
(16, 256, 1152), PixArt-1024's (4, 4096, 1152), PixArt-Σ-2048's (2, 16384,
1152), FLUX.1-dev-1024's image, text and joint streams (1, 4096 / 512 /
4608, 3072), and the FLUX-1024 pair — the image and text streams of one
dual-block site, one launch of `modulated_layer_norm_pair` here, and two
launches in a tree that has no pair. Each row checks both trees' outputs
against the plain version (within chip_smoke.py's BF16_TOL), times old,
new, new, old with `sampled_device_ms` (the SM clock, power and
temperature sampled around each timing) three times over, and gives the
byte bound and, on batch-1 rows, one ``F.layer_norm`` call with weight
1 + scale and bias shift built outside the timed window (`layer_norm_call`;
two at the pair).

Prints one JSON line a row and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ecad_tpu_torch.ops import _build
from ecad_tpu_torch.ops import fused as new_fused
from ecad_tpu_torch.utils.timing import bound_ms, card_name, sampled_device_ms

# row → segments, each x's (B, T, d)
ROWS = {
    "modlnorm_pixart256": ((16, 256, 1152),),
    "modlnorm_pixart1024": ((4, 4096, 1152),),
    "modlnorm_pixart2048": ((2, 16384, 1152),),
    "modlnorm_flux1024_img": ((1, 4096, 3072),),
    "modlnorm_flux1024_txt": ((1, 512, 3072),),
    "modlnorm_flux1024_joint": ((1, 4608, 3072),),
    "modlnorm_flux1024_pair": ((1, 4096, 3072), (1, 512, 3072)),
}
ROUNDS = 3
BF16_TOL = (2e-2, 2e-2)  # chip_smoke.py's (atol, rtol)


def load_ops(root: Path, name: str):
    """The ``ecad_tpu_torch/ops`` package of the checkout at `root`, loaded
    from its files as module `name` (its imports are relative, so they
    resolve inside that tree)."""
    init = root / "ecad_tpu_torch" / "ops" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def call_of(ops, segments):
    """One call of a tree's wrapper over `segments`: the pair wrapper where
    the tree has one, else one `modulated_layer_norm` a segment."""
    if len(segments) == 1:
        return lambda: (ops.modulated_layer_norm(*segments[0]),)
    if hasattr(ops, "modulated_layer_norm_pair"):
        return lambda: ops.modulated_layer_norm_pair(*segments)
    return lambda: tuple(ops.modulated_layer_norm(*s) for s in segments)


def layer_norm_call(segments):
    """``F.layer_norm`` over each segment with weight 1 + scale and bias
    shift, made outside the timed call, in x's dtype (PyTorch on the card
    refuses fp32 ones beside bf16 x), as chip_smoke.py's yardstick."""
    args = [(x, (x.shape[-1],), (1.0 + s.float()).reshape(-1).to(x.dtype), h.reshape(-1))
            for x, s, h in segments]
    return lambda: tuple(F.layer_norm(x, shape, w, b, 1e-6) for x, shape, w, b in args)


def worst_err(got, want) -> float:
    atol, rtol = BF16_TOL
    err = 0.0
    for g, w in zip(got, want):
        diff = (g.float() - w.float()).abs()
        if bool((diff > atol + rtol * w.float().abs()).any()):
            raise AssertionError(f"output beyond BF16_TOL (max err {float(diff.max()):.3g})")
        err = max(err, float(diff.max()))
    return err


def row(name: str, shapes, old_ops, gen) -> dict:
    segments = []
    for b, t, d in shapes:
        x = torch.randn((b, t, d), generator=gen, device="cuda").to(torch.bfloat16)
        mods = (torch.randn((b, 6, d), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
        segments.append((x, mods[:, 1:2], mods[:, 0:1]))
    want = [new_fused.modulated_layer_norm_reference(*s) for s in segments]
    old, new = call_of(old_ops, segments), call_of(new_fused, segments)
    out = {"name": name, "segments": [list(s) for s in shapes],
           "old_err": worst_err(old(), want), "new_err": worst_err(new(), want)}
    bytes_ = sum(2 * x.numel() * x.element_size() + s.numel() * s.element_size()
                 + h.numel() * h.element_size() for x, s, h in segments)
    out["bound_ms"], out["bound_by"] = bound_ms(bytes_, 8 * sum(x.numel() for x, _, _ in segments))
    times = {"old": [], "new": []}
    clocks = []
    for _ in range(ROUNDS):
        for tag, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
            ms, _, sample = sampled_device_ms(fn)
            times[tag].append(ms)
            clocks.append(sample)
    out["old_ms"], out["new_ms"] = times["old"], times["new"]
    out["old_over_new"] = statistics.median(times["old"]) / statistics.median(times["new"])
    out["new_share_of_bound"] = out["bound_ms"] / statistics.median(times["new"])
    out["clocks"] = clocks
    if all(x.shape[0] == 1 for x, _, _ in segments):
        lib = layer_norm_call(segments)
        out["layer_norm_err"] = worst_err(lib(), want)
        out["layer_norm_ms"] = sampled_device_ms(lib)[0]
    return out


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="root of the older checkout to compare with")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_modlnorm_bodies: needs a CUDA card")
    card = card_name()
    print(card, flush=True)
    old_ops = load_ops(args.parent.resolve(), "parent_ecad_tpu_torch_ops")
    _build.build_all(["modlnorm_sm90"])
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for name, shapes in ROWS.items():
        r = {"card": card, **row(name, shapes, old_ops, gen)}
        rows.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "clocks"}), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
