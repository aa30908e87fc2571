"""The two kernel scripts of the port (`ecad_tpu_torch.scripts.
bench_attention_kernels`, `.exp_attn_pixart256`) on the CPU: they raise
without a GPU, their shape tables are the reference scripts' (read from
``scripts/*.py`` with `ast`, which imports no JAX), their rows stand in
the reference's, and with ``--device cpu`` at tiny shapes they run the
plain versions and print their rows (errors against the fp32 / plain
softmax within bf16 rounding)."""

import ast
import json
from pathlib import Path

import pytest
import torch

from ecad_tpu_torch.scripts import bench_attention_kernels as bench
from ecad_tpu_torch.scripts import exp_attn_pixart256 as exp

REPO = Path(__file__).resolve().parent.parent


def _tree(name: str) -> ast.Module:
    return ast.parse((REPO / "scripts" / name).read_text())


def _measure_labels(tree: ast.Module) -> set:
    """The metric labels the reference passes to `measure` (f-strings with
    their one placeholder left as ``{}``)."""
    labels = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "measure":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                labels.add(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                labels.add("".join(v.value if isinstance(v, ast.Constant) else "{}"
                                   for v in arg.values))
    return labels


@pytest.mark.parametrize("module", [bench, exp], ids=["bench_attention_kernels",
                                                       "exp_attn_pixart256"])
def test_scripts_raise_without_a_gpu(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main([])


def test_bench_rows_stand_in_the_references():
    """The reference's rows xla, flash, rowblock/N, transposed (padded D
    only) and auto become sdpa, flash, one rowblock, transposed and auto."""
    assert list(bench.rows_of(128)) == ["sdpa", "flash", "rowblock", "auto"]
    assert list(bench.rows_of(72)) == ["sdpa", "flash", "rowblock", "transposed", "auto"]
    src = (REPO / "scripts/bench_attention_kernels.py").read_text()
    for ref_label in ('rows["xla"]', 'rows["flash"]', 'rows[f"rowblock/{bq}"]',
                      'rows["transposed"]', 'rows["auto"]'):
        assert ref_label in src


def _reference_bench_shapes() -> dict:
    tree = _tree("bench_attention_kernels.py")
    for node in tree.body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "SHAPES":
            return {k.value: {kw.arg: kw.value.value for kw in v.keywords}
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no SHAPES")


def test_bench_shape_table_equals_the_reference():
    assert bench.SHAPES == _reference_bench_shapes() == {
        "flux1024": dict(b=2, h=24, t=4608, d=128), "pixart1024": dict(b=8, h=16, t=4096, d=72)}


def test_exp_shapes_and_rows_are_the_references():
    """The reference's B64 H16 D72 self-attention at 1024 tokens,
    cross-attention to 120 keys keeping 100, and FLUX's 768-token shapes at
    B8 H24 D128 / D64; the port's metric names are the reference's labels,
    no more."""
    tree = _tree("exp_attn_pixart256.py")
    tuples, ints, keeps, loops = {}, [], [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Tuple):
            names = tuple(t.id for t in node.targets[0].elts)
            if isinstance(node.value, ast.Tuple) and all(
                    isinstance(e, ast.Constant) for e in node.value.elts):
                tuples[names] = tuple(e.value for e in node.value.elts)
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "mk":
            ints.append(ast.literal_eval(node.args[1]))
        if (isinstance(node, ast.Compare) and isinstance(node.ops[0], ast.Lt)
                and isinstance(node.comparators[0], ast.Constant)):
            keeps.append(node.comparators[0].value)  # arange(120) < 100
        if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
            loops.append(ast.literal_eval(node.iter))
    b, h, d = tuples[("b", "h", "d")]
    ints = list(dict.fromkeys(ints))  # mk(key, T): the self tokens, then the text keys
    bf, hf, tf = tuples[("bf", "hf", "tf")]
    want = {
        "p256_self": dict(b=b, h=h, tq=ints[0], tk=ints[0], d=d),
        "p256_cross": dict(b=b, h=h, tq=ints[0], tk=ints[1], d=d, keep=keeps[0]),
        **{f"{tag}_self": dict(b=bf, h=hf, tq=tf, tk=tf, d=df) for df, tag in loops[0]},
    }
    assert exp.SHAPES == want
    assert want["p256_cross"] == dict(b=64, h=16, tq=1024, tk=120, d=72, keep=100)
    ours = {f"{name}_{label}" for name in exp.SHAPES for label in exp.rows_of(name)}
    theirs = set()
    for label in _measure_labels(tree):
        theirs |= ({label.format(tag) for _, tag in loops[0]} if "{}" in label else {label})
    assert ours == theirs


def _tiny(module, monkeypatch, shapes):
    monkeypatch.setattr(module, "SHAPES", shapes)


def test_bench_runs_plain_versions_on_the_cpu(monkeypatch, capsys):
    _tiny(bench, monkeypatch, {"flux1024": dict(b=1, h=3, t=160, d=128),
                               "pixart1024": dict(b=2, h=2, t=130, d=72)})
    rows = bench.main(["--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == rows
    assert [r["metric"] for r in rows] == [
        "attn_flux1024_sdpa", "attn_flux1024_flash", "attn_flux1024_rowblock",
        "attn_flux1024_auto", "attn_pixart1024_sdpa", "attn_pixart1024_flash",
        "attn_pixart1024_rowblock", "attn_pixart1024_transposed", "attn_pixart1024_auto"]
    for r in rows:
        assert r["value"] is None and r["detail"]["turns_ms"] == []
        # bf16 outputs of O(0.1): a few bf16 ulps against the fp32 softmax
        assert r["detail"]["max_abs_err_vs_fp32"] < 2e-2
    assert "block_q" in rows[2]["detail"]


def test_exp_runs_plain_versions_on_the_cpu(monkeypatch, capsys):
    _tiny(exp, monkeypatch, {"p256_self": dict(b=2, h=2, tq=64, tk=64, d=72),
                             "p256_cross": dict(b=2, h=2, tq=64, tk=12, d=72, keep=10),
                             "flux256_dim1536_self": dict(b=1, h=2, tq=48, tk=48, d=64)})
    rows = exp.main(["--device", "cpu"])
    assert [json.loads(line) for line in capsys.readouterr().out.splitlines()] == rows
    assert [r["metric"] for r in rows] == [
        "p256_self_xla", "p256_self_single_tile", "p256_self_rowblock", "p256_cross_xla",
        "p256_cross_single_tile", "flux256_dim1536_self_xla",
        "flux256_dim1536_self_single_tile"]
    for r in rows:
        assert r["value"] is None and r["detail"]["max_abs_err_vs_plain"] < 2e-2
