"""The port's DiT topology package (``ecad_tpu_torch.graph``) against the
reference's (``ecad_tpu.graph``): the same generated schedules, JSON and
execution plans, and the same validation errors. Both are plain Python, so
they agree exactly."""

import numpy as np
import pytest

from ecad_tpu import graph as jg
from ecad_tpu.graph import generators as jgen
from ecad_tpu_torch import graph as tg
from ecad_tpu_torch.graph import generators as tgen

BLOCKS, STEPS = 6, 6


def _ops(plan):
    return [tuple(vars(op).values()) for op in plan]


def test_same_generator_names():
    assert sorted(tgen.GEN_FUNCTIONS) == sorted(jgen.GEN_FUNCTIONS)
    assert len(tgen.GEN_FUNCTIONS) == 18


@pytest.mark.parametrize("name", sorted(jgen.GEN_FUNCTIONS))
def test_generator_matches_reference(name):
    """Every generated schedule has the reference's name, JSON and
    per-step execution plans."""
    want = list(jgen.GEN_FUNCTIONS[name](BLOCKS, STEPS))
    got = list(tgen.GEN_FUNCTIONS[name](BLOCKS, STEPS))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.to_dict() == w.to_dict()
        assert g.is_default() == w.is_default()
        for step in range(STEPS):
            assert _ops(g.plan(step)) == _ops(w.plan(step))


def test_json_round_trip_and_dot(tmp_path):
    sched = next(tgen.gen_middle_repeat_progressive(BLOCKS, STEPS))
    sched.to_json(tmp_path / "s.json")
    back = tg.DiTSchedule.from_json(tmp_path / "s.json")
    assert back.to_dict() == sched.to_dict()
    ref = jg.DiTSchedule.from_json(tmp_path / "s.json")
    assert ref.to_dict() == back.to_dict()
    got = [p.read_text() for p in back.visualize(tmp_path / "t")]
    want = [p.read_text() for p in ref.visualize(tmp_path / "j")]
    assert got == want


def test_save_dit_schedules_same_files(tmp_path):
    scheds = lambda gen: list(gen.gen_reverse_all_timesteps(BLOCKS, STEPS))  # noqa: E731
    tp = tgen.save_dit_schedules(scheds(tgen), tmp_path / "t")
    jp = jgen.save_dit_schedules(scheds(jgen), tmp_path / "j")
    assert [p.name for p in tp] == [p.name for p in jp]
    for a, b in zip(tp, jp):
        assert a.read_text() == b.read_text()


BAD_CONFIGS = {
    "missing_output": lambda g: {"input": {"outputs": ["0"]}, "0": {"inputs": ["input"]}},
    "unknown_aggregate": lambda g: {
        **g.parallel(3, 0, 1),
        "dummy_after": {**g.parallel(3, 0, 1)["dummy_after"], "input_type": "max"},
    },
    "multi_input_without_type": lambda g: {
        **g.parallel(3, 0, 1),
        "dummy_after": {
            k: v for k, v in g.parallel(3, 0, 1)["dummy_after"].items()
            if k != "input_type"
        },
    },
    "cycle": lambda g: {
        "input": {"outputs": ["0"]},
        "0": {"inputs": ["input", "1"], "outputs": ["1"], "input_type": "add"},
        "1": {"inputs": ["0"], "outputs": ["0", "output"]},
        "output": {"inputs": ["1"]},
    },
}


@pytest.mark.parametrize("name", sorted(BAD_CONFIGS))
def test_invalid_configs_rejected_like_reference(name):
    for g in (jg, tg):
        with pytest.raises(ValueError):
            g.build_plan(BAD_CONFIGS[name](g))


def test_execute_plan_aggregates_like_reference():
    """execute_plan on numbers, with a block that tags its input, gives the
    same values for add/avg fan-outs and loops."""
    cfg = tg.parallel(4, 1, 2, 2, "avg")
    plan_t, plan_j = tg.build_plan(cfg), jg.build_plan(jg.parallel(4, 1, 2, 2, "avg"))
    apply = lambda i, x: x * 1.5 + i  # noqa: E731
    got = tg.execute_plan(plan_t, np.float64(1.0), apply)
    want = jg.execute_plan(plan_j, np.float64(1.0), apply)
    assert got == want
    assert tg.plan_block_sequence(plan_t) == jg.plan_block_sequence(plan_j)
