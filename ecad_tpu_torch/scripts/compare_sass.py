"""The machine code (SASS) of this tree's attention kernels against an older
tree's, kernel by kernel, for the kernels both trees build.

    python -m ecad_tpu_torch.scripts.compare_sass --parent DIR [--out sass.json]

DIR is the root of an older checkout of the port, unpacked for instance
with ``git archive <commit> ecad_tpu_torch | tar -x -C build/parent``. Each
tree's ``csrc/attention_sm90.cu`` and ``csrc/attention_f32_sm90.cu`` is
compiled to a cubin with the flags that tree's ``ops/_build.py`` builds
with (one ``nvcc`` per source, all started together) and disassembled with ``cuobjdump -sass``;
a kernel's code is its instructions with the addresses, the comments and
the numbers of branch labels taken out, and its name without the hash of
its file that its anonymous namespace carries, so two builds of the same
code compare equal wherever they sit in the cubin. Prints one JSON line a source: the kernels whose code is
identical, those whose instructions are the same in the same order but
for the registers some of them name (`registers_only`, with how many do),
those that differ otherwise (with each side's instruction count), and
those only one tree has; writes them to ``--out``. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), not a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

from ecad_tpu_torch.ops import _build

SOURCES = ("attention_sm90", "attention_f32_sm90")


def cuobjdump() -> str:
    return str(Path(_build.nvcc()).with_name("cuobjdump"))


def build_flags(root: Path) -> tuple[str, ...]:
    """The code flags the checkout at `root` builds its kernels with: its
    ``ops/_build.py``'s COMPILE_FLAGS, or, in a tree from before that name,
    the flags it spelled out (its ARCH_FLAGS, -std=c++17, -O3)."""
    spec = importlib.util.spec_from_file_location(
        f"build_of_{abs(hash(str(root)))}", root / "ecad_tpu_torch" / "ops" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, "COMPILE_FLAGS", (*mod.ARCH_FLAGS, "-std=c++17", "-O3"))


def compile_cubin(root: Path, name: str, out: Path) -> subprocess.Popen:
    csrc = root / "ecad_tpu_torch" / "csrc"
    cmd = [_build.nvcc(), *build_flags(root), "-cubin", "-I", str(csrc),
           "-o", str(out), str(csrc / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def kernels(cubin: Path) -> dict[str, list[str]]:
    """Each kernel's instructions, by mangled name, without addresses,
    encodings and comments."""
    text = subprocess.run([cuobjdump(), "-sass", str(cubin)], check=True, capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            # the anonymous namespace's name carries a hash of the file
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_ZN(anon)", m.group(1))
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:
            # branch labels are numbered across the file: their numbers go
            out[name].append(re.sub(r"\.L_x_\d+", ".L", re.sub(r"\s+", " ", m.group(1))))
    return out


REGISTER = re.compile(r"\b(U?R\d+|U?P\d+)\b")


def registers_only(old: list[str], new: list[str]) -> int | None:
    """How many of `new`'s instructions name other registers than `old`'s
    where the two are the same instructions in the same order but for the
    registers they name (a register allocation that differs, the code the
    same); None where they differ otherwise."""
    if len(old) != len(new) or any(REGISTER.sub("%", a) != REGISTER.sub("%", b)
                                   for a, b in zip(old, new)):
        return None
    return sum(a != b for a, b in zip(old, new))


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, required=True)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    work = _build.BUILD_DIR / "compare_sass"
    work.mkdir(parents=True, exist_ok=True)
    trees = {"parent": args.parent.resolve(), "tree": _build.PACKAGE_DIR.parent}
    procs = {(t, n): (compile_cubin(root, n, work / f"{t}_{n}.cubin"), work / f"{t}_{n}.cubin")
             for t, root in trees.items() for n in SOURCES}
    for (t, n), (proc, _) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {t} {n}.cu failed:\n{log}")
    rows = []
    for n in SOURCES:
        old, new = (kernels(procs[t, n][1]) for t in ("parent", "tree"))
        both = sorted(set(old) & set(new))
        row = {"source": n,
               "identical": [k for k in both if old[k] == new[k]],
               "registers_only": {k: registers_only(old[k], new[k]) for k in both
                                  if old[k] != new[k] and registers_only(old[k], new[k])},
               "differ": {k: [len(old[k]), len(new[k])] for k in both
                          if old[k] != new[k] and registers_only(old[k], new[k]) is None},
               "parent_only": sorted(set(old) - set(new)),
               "tree_only": sorted(set(new) - set(old))}
        print(json.dumps({"source": n, "identical": len(row["identical"]),
                          "registers_only": len(row["registers_only"]),
                          "differ": row["differ"],
                          "parent_only": row["parent_only"],
                          "tree_only": len(row["tree_only"])}), flush=True)
        rows.append(row)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
