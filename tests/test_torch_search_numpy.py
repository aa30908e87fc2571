"""The search loop's numpy layer in the port against the JAX package's, on
the CPU: NSGA-II (sorting, crowding, hypervolume, offspring, checkpoints),
population IO, the problem facts, the analytic MACs and the mock scorer.
All of it is framework-free in both packages, so the results must be equal
bit for bit (byte for byte where files are written)."""

import json
from pathlib import Path

import numpy as np
import pytest

from ecad_tpu import macs as jmacs
from ecad_tpu import scoring as jscoring
from ecad_tpu.genetic import nsga2 as jnsga
from ecad_tpu.genetic import population_io as jpio
from ecad_tpu.genetic import problems as jprob
from ecad_tpu.graph import generators as jdit
from ecad_tpu.schedules import FluxCacheSchedule as JFlux
from ecad_tpu.schedules import PixArtCacheSchedule as JPix
from ecad_tpu_torch import macs as tmacs
from ecad_tpu_torch import scoring as tscoring
from ecad_tpu_torch.genetic import nsga2 as tnsga
from ecad_tpu_torch.genetic import population_io as tpio
from ecad_tpu_torch.genetic import problems as tprob
from ecad_tpu_torch.graph import generators as tdit
from ecad_tpu_torch.schedules import FluxCacheSchedule as TFlux
from ecad_tpu_torch.schedules import PixArtCacheSchedule as TPix

REPO = Path(__file__).resolve().parent.parent
PAPER = REPO / "schedules" / "schedules_in_paper"


def _random_F(seed, n=40, m=2, ties=False):
    rng = np.random.default_rng(seed)
    F = rng.random((n, m))
    if ties:  # repeated values and duplicate rows exercise the tie paths
        F = np.round(F * 4) / 4
    return F


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, False), (3, True)])
def test_sorting_crowding_and_hypervolume_equal(seed, ties):
    F = _random_F(seed, ties=ties)
    jf, tf = jnsga.fast_non_dominated_sort(F), tnsga.fast_non_dominated_sort(F)
    assert len(jf) == len(tf)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            jnsga.crowding_distance(F[a]), tnsga.crowding_distance(F[b])
        )
    ref = np.array([1.1, 1.1])
    assert jnsga.hypervolume_2d(F, ref) == tnsga.hypervolume_2d(F, ref)
    G = np.random.default_rng(seed).normal(size=(len(F), 2))
    np.testing.assert_array_equal(
        jnsga.constraint_violation(G), tnsga.constraint_violation(G)
    )


def _objectives(X, seed):
    """Deterministic objectives and a hamming-style constraint for a
    population: F[:, 0] from a seeded projection, F[:, 1] the share of
    recomputed genes, G = 3 − #genes off."""
    w = np.random.default_rng(seed).random(X.shape[1])
    F = np.stack([X @ w / w.sum(), X.mean(axis=1)], axis=1)
    G = (3 - (~X).sum(axis=1)).reshape(-1, 1).astype(float)
    return F, G


def _algo(mod, **kw):
    return mod.NSGA2(n_var=kw.pop("n_var", 120), pop_size=kw.pop("pop_size", 10), **kw)


@pytest.mark.parametrize("kw", [{}, {"seed": 7, "crossover_points": 2, "mutation_prob": 0.5}])
def test_nsga2_same_seed_same_offspring(kw):
    """Fed the same X/F/G, both packages ask for the same offspring, three
    generations in a row."""
    j, t = _algo(jnsga, **kw), _algo(tnsga, **kw)
    X = j.ask()
    np.testing.assert_array_equal(t.ask(), X)
    for gen in range(3):
        F, G = _objectives(X, gen)
        j.tell(X, F, G)
        t.tell(X, F, G)
        X = j.ask()
        np.testing.assert_array_equal(t.ask(), X)
        np.testing.assert_array_equal(t.X, j.X)
        np.testing.assert_array_equal(t.F, j.F)
        np.testing.assert_array_equal(t.G, j.G)
    for a, b in zip(j.pareto_front(), t.pareto_front()):
        np.testing.assert_array_equal(a, b)


def _state(path):
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint written by either package loads in the other: the same
    arrays and meta, and the same next ask."""
    src, dst = (jnsga, tnsga) if writer == "jax" else (tnsga, jnsga)
    algo = _algo(src)
    X = algo.ask()
    for gen in range(2):
        algo.tell(X, *_objectives(X, gen))
        X = algo.ask()
    path = tmp_path / "checkpoint.npz"
    algo.save(path)
    a, b = src.NSGA2.load(path), dst.NSGA2.load(path)
    for key in ("X", "F", "G", "pending"):
        np.testing.assert_array_equal(getattr(b, key), getattr(a, key))
    assert (b.n_gen, b.n_var, b.pop_size, b.seed) == (a.n_gen, a.n_var, a.pop_size, a.seed)
    assert b.rng.bit_generator.state == a.rng.bit_generator.state
    # the reloaded state written again by the other package: same arrays and meta
    b.save(tmp_path / "again.npz")
    s1, s2 = _state(path), _state(tmp_path / "again.npz")
    assert s1.keys() == s2.keys()
    for k in s1:
        if k == "meta":
            assert json.loads(str(s1[k])) == json.loads(str(s2[k]))
        else:
            np.testing.assert_array_equal(s1[k], s2[k])
    X = algo.pending
    a.tell(X, *_objectives(X, 9))
    b.tell(X, *_objectives(X, 9))
    np.testing.assert_array_equal(b.ask(), a.ask())


@pytest.mark.parametrize("steps", [20, 4])
def test_problem_facts_equal(steps):
    for name in ("pixart_problem", "flux_problem"):
        j, t = getattr(jprob, name)(steps), getattr(tprob, name)(steps)
        assert (t.name, t.n_var, t.n_obj, t.n_ieq_constr) == (
            j.name, j.n_var, j.n_obj, j.n_ieq_constr)


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("family", ["pixart", "flux"])
def test_managers_write_the_same_bytes(tmp_path, family, monkeypatch):
    """For the same X both managers, each run from its own directory with
    the same relative population and benchmark dirs, write byte-identical
    candidate JSONs (MACs included) and manager_config.json, and `ask()`
    returns the same X/F/G from the same scores.json files, also after a
    reload from the config."""
    cls = {"pixart": "PixArtPopulationIOManager", "flux": "FluxPopulationIOManager"}[family]
    X = None
    asked, reloaded, dicts = {}, {}, {}
    for tag, mod in (("jax", jpio), ("torch", tpio)):
        (tmp_path / tag).mkdir()
        monkeypatch.chdir(tmp_path / tag)
        m = getattr(mod, cls)("pop", all_populations_dir="p", all_benchmarks_dir="b",
                              population_size=6, min_diff_from_default=5)
        if X is None:
            X = np.random.default_rng(3).random((6, m.n_var)) < 0.5
            X[0] = True  # the default schedule: hamming 0, a violated constraint
        m.save_population(X)
        m.save_config()
        m.compute_macs_for_generation()
        for i, s in enumerate((0.25, -0.5, 1.0, 0.125, 0.0, 2.0)):
            d = m.score_dir() / f"cand_{i:03d}"
            d.mkdir(parents=True)
            (d / "scores.json").write_text(json.dumps({"total_score": s}))
        assert m.check_offline_eval()
        asked[tag] = m.ask()
        again = getattr(mod, cls).from_json(Path("p/pop/gen_001/manager_config.json"))
        reloaded[tag] = again.ask()
        dicts[tag] = again.to_dict()
    assert _files(tmp_path / "torch") == _files(tmp_path / "jax")
    assert dicts["torch"] == dicts["jax"]
    for a, b in zip(asked["jax"] + reloaded["jax"], asked["torch"] + reloaded["torch"]):
        np.testing.assert_array_equal(b, a)


def _paper_schedules():
    out = []
    for p in sorted(PAPER.rglob("*.json")):
        flux = "num_single_blocks" in json.loads(p.read_text())["cache_schedule"]
        out.append(pytest.param(p, flux, id=str(p.relative_to(PAPER))))
    return out


def _random_schedules(flux, n=3):
    rng = np.random.default_rng(5 if flux else 6)
    out = []
    for i in range(n):
        if flux:
            g = rng.random(20 * 57 * 3) < 0.4
            cfg = {"height": 1024, "width": 1024} if i == 2 else {}
            out.append((JFlux.from_numpy(g, 20, 19, num_single_blocks=38, top_level_config=cfg),
                        TFlux.from_numpy(g, 20, 19, num_single_blocks=38, top_level_config=cfg)))
        else:
            g = rng.random(20 * 28 * 3) < 0.5
            cfg = [{}, {"height": 1024, "width": 1024},
                   {"pipeline": {"name": "tgate", "kwargs": {"gate_step": 8}}}][i]
            out.append((JPix.from_numpy(g, 20, 28, top_level_config=cfg),
                        TPix.from_numpy(g, 20, 28, top_level_config=cfg)))
    return out


def _assert_metrics_equal(j, t):
    assert tmacs.compute_schedule_metrics(t) == jmacs.compute_schedule_metrics(j)
    assert tmacs.hardware_flops_per_image(t) == jmacs.hardware_flops_per_image(j)
    tt, jt = tmacs.table_for_schedule(t), jmacs.table_for_schedule(j)
    assert tt.__dict__ == jt.__dict__
    assert tmacs.attach_metrics(t) == jmacs.attach_metrics(j)
    assert t.to_dict() == j.to_dict()


@pytest.mark.parametrize("path,flux", _paper_schedules())
def test_macs_equal_on_paper_schedules(path, flux):
    j, t = ((JFlux, TFlux) if flux else (JPix, TPix))
    _assert_metrics_equal(j.from_json(path), t.from_json(path))


@pytest.mark.parametrize("flux", [False, True], ids=["pixart", "flux"])
def test_macs_equal_on_random_genomes(flux):
    for j, t in _random_schedules(flux):
        _assert_metrics_equal(j, t)


@pytest.mark.parametrize("kw", [{}, {"height": 1024, "width": 1024, "batch": 1},
                                {"text_tokens": 77, "dim": 1536}])
def test_cost_tables_equal(kw):
    pix = {k: v for k, v in kw.items() if k != "dim"}
    assert tmacs.pixart_cost_table(**pix).__dict__ == jmacs.pixart_cost_table(**pix).__dict__
    assert tmacs.flux_cost_table(**kw).__dict__ == jmacs.flux_cost_table(**kw).__dict__
    for side in (256, 1024, 2048):
        assert tmacs.vae_decoder_flops(side, side) == jmacs.vae_decoder_flops(side, side)


def test_dit_schedule_metrics_equal():
    """compute_dit_schedule_metrics on every DiT topology generator's first
    schedules (skips, repeats, parallel branches)."""
    n = 0
    for name in sorted(jdit.GEN_FUNCTIONS):
        js = list(jdit.GEN_FUNCTIONS[name](28, 20))[:3]
        ts = list(tdit.GEN_FUNCTIONS[name](28, 20))[:3]
        for j, t in zip(js, ts):
            assert tmacs.compute_dit_schedule_metrics(t) == jmacs.compute_dit_schedule_metrics(j)
            n += 1
    assert n > 20


def test_port_has_no_tpu_rates():
    assert not [k for k in vars(tmacs) if k.startswith("V5E")]


def test_mock_scorer_and_merge_equal():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (6, 16, 16, 3), dtype=np.uint8)
    prompts = [f"p{i % 3}" for i in range(6)]
    ids = [str(i % 3) for i in range(6)]
    for kw in ({}, {"prompt_ids": ids}):
        assert tscoring.mock_scorer(imgs, prompts, **kw) == jscoring.mock_scorer(imgs, prompts, **kw)
    chunks_t = [tscoring.mock_scorer(imgs[lo:lo + 2], prompts[lo:lo + 2], ids[lo:lo + 2])
                for lo in range(0, 6, 2)]
    chunks_j = [jscoring.mock_scorer(imgs[lo:lo + 2], prompts[lo:lo + 2], ids[lo:lo + 2])
                for lo in range(0, 6, 2)]
    assert chunks_t == chunks_j
    assert tscoring.merge_scores(chunks_t) == jscoring.merge_scores(chunks_j)
    per = rng.normal(size=6)
    assert tscoring.aggregate_scores(per, prompts, ids) == jscoring.aggregate_scores(per, prompts, ids)
    assert tscoring.get_scorer() is tscoring.mock_scorer
    assert tscoring.get_scorer("mock") is tscoring.mock_scorer


@pytest.mark.parametrize("name", ["image_reward", "clip"])
def test_weight_backed_scorers_name_their_queue_item(name, monkeypatch):
    """The weight-backed scorers resolve (their modules registered on
    demand) and, without their weights, raise the reference's error naming
    the variable that holds them."""
    import importlib

    import torch

    module = importlib.import_module(f"ecad_tpu_torch.scoring.{tscoring.WEIGHT_BACKED[name]}")
    monkeypatch.setattr(module, "_RESIDENT", None)
    envs = ("ECAD_IMAGE_REWARD_CHECKPOINT", "ECAD_IMAGE_REWARD_TOKENIZER",
            "ECAD_CLIP_MODEL_DIR")
    for var in envs:
        monkeypatch.delenv(var, raising=False)
    scorer = tscoring.get_scorer(name)
    assert scorer is tscoring.ScorerRegistry.get(name)
    with pytest.raises(RuntimeError, match=envs[0] if name == "image_reward" else envs[2]):
        scorer(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), ["p"])
