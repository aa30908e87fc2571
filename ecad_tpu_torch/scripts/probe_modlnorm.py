"""What sets the pace of K3's Hopper kernel (``csrc/modlnorm_sm90.cu``):
copies of the source, each with one design choice undone or one piece of
work taken out, built beside it and timed against it in turns, in one
process on one card.

    python -m ecad_tpu_torch.scripts.probe_modlnorm [--out probes.json]

Rows, bf16, at the widths the served paths give K3 (`ROWS`): PixArt-256's
(16, 256, 1152), PixArt-1024's (4, 4096, 1152), PixArt-Σ-2048's (2, 16384,
1152), FLUX.1-dev-1024's image and text streams (1, 4096 / 512, 3072) and
their pair in one launch. Variants of the source (`VARIANTS`):

* ``one_row_a_group``: a grid of one row group (the warps of a row) a row
  instead of the persistent grid the occupancy query sizes;
* ``plain_loads``: x read with ``__ldg`` instead of ``__ldcs``
  (evict-first);
* ``streaming_stores``: the output written with ``__stcs`` (evict-first)
  instead of a plain store;
* ``modulation_late``: scale and shift loaded after the reductions, in the
  epilogue, instead of with x;
* ``copy_only``: the output is x (no reductions, no modulation loads: the
  same loads and stores over the same grid, a floor for this kernel's
  access pattern; wrong output);

and the source's kernel under one, two, four and eight warps a row
(`GROUP_VARIANTS`, ``groups_1`` ...; those whose lanes hold the row)
whatever `fused.warps_a_row` picks.
The first four only reschedule the same arithmetic and must give the
source's output bit for bit; the group variants sum in another order and
must stay within chip_smoke.py's BF16_TOL of it; ``copy_only`` is timed
only. Each row also carries one ``Tensor.copy_`` of x into an output of
its shape (the library's copy of x's bytes, without the modulation's),
the registers and spill bytes ``ptxas -v`` reports for each build's
kernel of the row's plan (`plan`: vectors a lane, warps a row), and the
card's SM clock after the row. Each time is the median of spin-kernel
CUDA-event timings (`device_ms`), taken in turns: source, variants,
variants again in reverse, source. Prints one JSON line a row and writes
them to ``--out``. The edits are text replacements;
`tests/test_torch_ops.py` fails on the CPU when one no longer matches the
source.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from ecad_tpu_torch.ops import _build
from ecad_tpu_torch.ops import fused
from ecad_tpu_torch.scripts.probe_attention_body import variant_source
from ecad_tpu_torch.utils.timing import card_name, card_sample, device_ms

ROWS = {
    "pixart256": ((16, 256, 1152),),
    "pixart1024": ((4, 4096, 1152),),
    "pixart2048": ((2, 16384, 1152),),
    "flux1024_img": ((1, 4096, 3072),),
    "flux1024_txt": ((1, 512, 3072),),
    "flux1024_pair": ((1, 4096, 3072), (1, 512, 3072)),
}

_LOADS = """        v[i] = __ldcs(at.x + k);  // x is read once: evict first
        sc[i] = __ldg(at.scale + k);
        sh[i] = __ldg(at.shift + k);"""
_MODULATION = """        const T* se = reinterpret_cast<const T*>(&sc[i]);
        const T* he = reinterpret_cast<const T*>(&sh[i]);"""

VARIANTS = {
    "one_row_a_group": [("const int grid = (int)(need < most ? need : most);",
                         "const int grid = (int)need;")],
    "plain_loads": [("v[i] = __ldcs(at.x + k);", "v[i] = __ldg(at.x + k);")],
    "streaming_stores": [("at.out[k] = o;", "__stcs(at.out + k, o);")],
    "modulation_late": [(_LOADS, "        v[i] = __ldcs(at.x + k);"),
                        (_MODULATION, """        const Raw sck = __ldg(at.scale + k), shk = __ldg(at.shift + k);
        const T* se = reinterpret_cast<const T*>(&sck);
        const T* he = reinterpret_cast<const T*>(&shk);""")],
    "copy_only": [("oe[j] = from_f32<T>(normed * (1.0f + to_f32(se[j])) + to_f32(he[j]));",
                   "oe[j] = e[j];")],
}
EXACT = ("one_row_a_group", "plain_loads", "streaming_stores", "modulation_late")
# the source's kernel under another number of warps a row than
# `fused.warps_a_row` gives (their sums differ in order: timed only)
GROUP_VARIANTS = {f"groups_{g}": g for g in fused.GROUPS}


def registers(log: str) -> dict[str, tuple[int, int]]:
    """(registers, spill-store bytes) that ``ptxas -v`` reports, by mangled
    kernel name."""
    out, name, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
    return out


def build(sources: dict[str, str], out_dir: Path) -> tuple[dict, dict]:
    """One nvcc per source, all started together, as `_build` builds: the
    loaded libraries and each one's `registers`."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        cu.write_text(src)
        cmd = [_build.nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs, regs = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
        regs[name] = registers(log)
    return libs, regs


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_modlnorm: needs a CUDA card")
    card = card_name()
    src = (_build.CSRC_DIR / "modlnorm_sm90.cu").read_text()
    sources = {"source": src, **{n: variant_source(src, e) for n, e in VARIANTS.items()}}
    libs, regs = build(sources, _build.BUILD_DIR / "probe_modlnorm")
    fns = {}
    for name, lib in libs.items():
        fn = lib.ecad_modlnorm_sm90_fwd
        fn.argtypes, fn.restype = fused._kernel().argtypes, ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    warps_a_row = fused.warps_a_row
    rows = []
    try:
        for row, shapes in ROWS.items():
            segs = []
            for b, t, d in shapes:
                x = torch.randn((b, t, d), generator=gen, device="cuda").to(torch.bfloat16)
                m = (torch.randn((b, 6, d), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
                segs.append((x, m[:, 1:2], m[:, 0:1]))

            def call(name, segs=segs):
                lib, group = (name, None) if name in fns else ("source", GROUP_VARIANTS[name])

                def go():
                    fused._FN = fns[lib]
                    if group is not None:
                        fused.warps_a_row = lambda n_vec, n_rows: group
                    try:
                        if len(segs) == 1:
                            return [fused.modulated_layer_norm(*segs[0])]
                        return list(fused.modulated_layer_norm_pair(*segs))
                    finally:
                        fused.warps_a_row = warps_a_row
                return go

            n_vec = shapes[0][2] * 2 // 16
            groups = [n for n, g in GROUP_VARIANTS.items() if n_vec <= fused.MAX_NV * 32 * g]
            names = ["source", *VARIANTS, *groups]
            want = call("source")()
            same = {n: all(torch.equal(g, w) for g, w in zip(call(n)(), want))
                    for n in EXACT}
            atol, rtol = 2e-2, 2e-2  # chip_smoke.py's BF16_TOL
            within = {n: all(bool(((g.float() - w.float()).abs()
                                   <= atol + rtol * w.float().abs()).all())
                             for g, w in zip(call(n)(), want))
                      for n in groups}
            del want
            times = {n: [] for n in names}
            for n in names + names[::-1]:
                times[n].append(device_ms(call(n))[0])
            outs = [torch.empty_like(x) for x, _, _ in segs]
            copy_ms = device_ms(lambda: [o.copy_(x) for o, (x, _, _) in zip(outs, segs)])[0]
            plan = fused.launch_plan(shapes[0][2], 2, [s[:2] for s in shapes])
            symbol = (f"modlnorm_sm90_kernelI13__nv_bfloat16Li16ELi{plan.nv}E"
                      f"Li{plan.group}E")
            built = {n: [v for k, v in regs[n].items() if symbol in k] for n in regs}
            result = {"row": row, "segments": [list(s) for s in shapes], "card": card,
                      "plan": [plan.nv, plan.group], "ms": times, "copy_ms": copy_ms,
                      "bit_identical": same, "within_bf16_tol": within,
                      "registers_and_spill_bytes": built,
                      "sm_clock_mhz_after": card_sample()["sm_clock_mhz"]}
            print(json.dumps(result), flush=True)
            rows.append(result)
            if not all(same.values()) or not all(within.values()):
                raise SystemExit(f"{row}: a variant changed the output: {same}, {within}")
    finally:
        fused._FN = None  # the tree's own library again on the next call
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
