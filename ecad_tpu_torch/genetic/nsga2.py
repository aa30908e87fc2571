"""NSGA-II in pure numpy with portable JSON/NPZ checkpoints (the port's own
copy of ``ecad_tpu/genetic/nsga2.py``: the same seed gives bit-identical
offspring, and a checkpoint written by either package loads in the other).

Replaces the reference's pymoo dependency (ecad/genetic/train_nsga2_base.py:
234-242: NSGA2 with PointCrossover(prob=0.9, n_points=4),
BitflipMutation(prob=0.05), NoTermination, ask/tell driving, seed=0; dill
pickle checkpoints, population_io_manager.py:116-145). Operator semantics
follow pymoo 0.6.1 so search dynamics match:

* binary tournament on (constraint violation, rank, crowding distance)
* k-point crossover applied per pair with probability `crossover_prob`
* bitflip mutation applied per offspring with probability `mutation_prob`,
  flipping each gene with probability min(0.5, 1/n_var)
* (rank, crowding) survival over parents+offspring
* duplicate elimination against the population and within offspring

Checkpointing is explicit state (genomes, objectives, RNG counter) — no
pickled objects, resumable across machines and versions.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np
import numpy.typing as npt


# ---------------------------------------------------------------------------
# Non-dominated sorting and crowding
# ---------------------------------------------------------------------------


def fast_non_dominated_sort(F: np.ndarray) -> list[np.ndarray]:
    """Return fronts (lists of indices) by Pareto dominance (minimization)."""
    n = len(F)
    # dominated[i,j] = i dominates j
    less_eq = (F[:, None, :] <= F[None, :, :]).all(-1)
    less = (F[:, None, :] < F[None, :, :]).any(-1)
    dominates = less_eq & less
    dom_count = dominates.sum(axis=0)  # how many dominate j
    fronts = []
    current = np.where(dom_count == 0)[0]
    assigned = np.zeros(n, dtype=bool)
    while len(current):
        fronts.append(current)
        assigned[current] = True
        # remove current front's domination contributions
        dom_count = dom_count - dominates[current].sum(axis=0)
        current = np.where((dom_count == 0) & ~assigned)[0]
    return fronts


def crowding_distance(F: np.ndarray) -> np.ndarray:
    n, m = F.shape
    if n <= 2:
        return np.full(n, np.inf)
    d = np.zeros(n)
    for j in range(m):
        order = np.argsort(F[:, j], kind="stable")
        fj = F[order, j]
        span = fj[-1] - fj[0]
        d[order[0]] = d[order[-1]] = np.inf
        if span > 0:
            d[order[1:-1]] += (fj[2:] - fj[:-2]) / span
    return d


def hypervolume_2d(F: np.ndarray, ref_point: np.ndarray) -> float:
    """Hypervolume (minimization) of a 2-objective set against `ref_point`:
    the area dominated by F's non-dominated subset inside the box bounded
    by ref_point. Standard sweep: sort the front by the first objective
    and accumulate rectangles. Points not strictly below ref_point in both
    objectives contribute nothing."""
    F = np.asarray(F, dtype=np.float64)
    if F.ndim != 2 or F.shape[1] != 2:
        raise ValueError(f"expected (n, 2) objectives, got {F.shape}")
    ref = np.asarray(ref_point, dtype=np.float64)
    inside = (F < ref).all(axis=1)
    F = F[inside]
    if not len(F):
        return 0.0
    front = fast_non_dominated_sort(F)[0]
    pts = F[front]
    order = np.argsort(pts[:, 0], kind="stable")
    pts = pts[order]
    hv = 0.0
    prev_f1 = ref[1]
    for f0, f1 in pts:
        if f1 < prev_f1:  # non-dominated sweep: f1 strictly decreasing
            hv += (ref[0] - f0) * (prev_f1 - f1)
            prev_f1 = f1
    return float(hv)


def constraint_violation(G: Optional[np.ndarray]) -> np.ndarray:
    """Total violation per individual (0 = feasible). G<=0 is feasible."""
    if G is None:
        return np.zeros(0)
    return np.maximum(G, 0).sum(axis=1)


# ---------------------------------------------------------------------------
# Algorithm
# ---------------------------------------------------------------------------


@dataclass
class NSGA2:
    n_var: int
    pop_size: int
    crossover_prob: float = 0.9
    crossover_points: int = 4
    mutation_prob: float = 0.05
    seed: int = 0
    max_duplicate_retries: int = 100

    X: Optional[np.ndarray] = None  # (pop, n_var) bool — evaluated population
    F: Optional[np.ndarray] = None  # (pop, n_obj)
    G: Optional[np.ndarray] = None  # (pop, n_constr)
    pending: Optional[np.ndarray] = None  # offspring awaiting evaluation
    n_gen: int = 0
    rng: np.random.Generator = field(default=None)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.rng is None:
            self.rng = np.random.default_rng(self.seed)

    # -- ask/tell ----------------------------------------------------------

    def initialize(self, X0: Optional[np.ndarray] = None) -> np.ndarray:
        """Seed generation 0 (random if X0 not given) and return it as the
        first `ask`. Mirrors init_gen_0 (train_nsga2_base.py:184-252)."""
        if X0 is None:
            X0 = self.rng.random((self.pop_size, self.n_var)) < 0.5
        self.pending = np.asarray(X0, dtype=bool)
        return self.pending

    def tell(self, X: np.ndarray, F: np.ndarray, G: Optional[np.ndarray] = None) -> None:
        """Report evaluations. On the first tell this installs the initial
        population; afterwards it merges offspring and survives down to
        pop_size."""
        X = np.asarray(X, dtype=bool)
        F = np.asarray(F, dtype=np.float64)
        if self.X is None:
            self.X, self.F, self.G = X, F, G
        else:
            self.X = np.concatenate([self.X, X])
            self.F = np.concatenate([self.F, F])
            if G is not None and self.G is not None:
                self.G = np.concatenate([self.G, G])
            sel = self._survival(self.X, self.F, self.G, self.pop_size)
            self.X, self.F = self.X[sel], self.F[sel]
            if self.G is not None:
                self.G = self.G[sel]
        self.pending = None
        self.n_gen += 1

    def ask(self) -> np.ndarray:
        """Produce the next offspring population (deduplicated)."""
        if self.X is None:
            return self.initialize()
        offspring: list[np.ndarray] = []
        seen = {x.tobytes() for x in self.X}
        retries = 0
        while len(offspring) < self.pop_size and retries < self.max_duplicate_retries:
            parents = self._tournament(2 * self.pop_size)
            children = self._mate(parents)
            for child in children:
                key = child.tobytes()
                if key in seen:
                    continue
                seen.add(key)
                offspring.append(child)
                if len(offspring) == self.pop_size:
                    break
            retries += 1
        while len(offspring) < self.pop_size:
            # extremely unlikely fill-in: random individuals
            child = self.rng.random(self.n_var) < 0.5
            if child.tobytes() not in seen:
                seen.add(child.tobytes())
                offspring.append(child)
        self.pending = np.array(offspring, dtype=bool)
        return self.pending

    # -- operators ---------------------------------------------------------

    def _rank_and_crowding(
        self, F: np.ndarray, G: Optional[np.ndarray]
    ) -> tuple[np.ndarray, np.ndarray]:
        n = len(F)
        rank = np.zeros(n, dtype=int)
        crowd = np.zeros(n)
        cv = constraint_violation(G) if G is not None else np.zeros(n)
        feasible = np.where(cv <= 0)[0]
        infeasible = np.where(cv > 0)[0]
        next_rank = 0
        if len(feasible):
            for front in fast_non_dominated_sort(F[feasible]):
                idx = feasible[front]
                rank[idx] = next_rank
                crowd[idx] = crowding_distance(F[idx])
                next_rank += 1
        if len(infeasible):
            # infeasible ranked after all feasible, by ascending violation
            order = infeasible[np.argsort(cv[infeasible], kind="stable")]
            rank[order] = next_rank + np.arange(len(order))
            crowd[order] = -cv[order]
        return rank, crowd

    def _survival(
        self, X: np.ndarray, F: np.ndarray, G: Optional[np.ndarray], n: int
    ) -> np.ndarray:
        rank, crowd = self._rank_and_crowding(F, G)
        # sort by (rank asc, crowding desc)
        order = np.lexsort((-crowd, rank))
        return order[:n]

    def _tournament(self, n: int) -> np.ndarray:
        rank, crowd = self._rank_and_crowding(self.F, self.G)
        perm = np.concatenate(
            [self.rng.permutation(len(self.X)) for _ in range((2 * n) // len(self.X) + 1)]
        )[: 2 * n].reshape(n, 2)
        a, b = perm[:, 0], perm[:, 1]
        better_a = (rank[a] < rank[b]) | (
            (rank[a] == rank[b]) & (crowd[a] > crowd[b])
        )
        return np.where(better_a, a, b)

    def _mate(self, parents: np.ndarray) -> np.ndarray:
        pairs = parents.reshape(-1, 2)
        children = []
        for i, j in pairs:
            p1, p2 = self.X[i].copy(), self.X[j].copy()
            if self.rng.random() < self.crossover_prob:
                cuts = np.sort(
                    self.rng.choice(
                        np.arange(1, self.n_var),
                        size=min(self.crossover_points, self.n_var - 1),
                        replace=False,
                    )
                )
                seg = np.zeros(self.n_var, dtype=bool)
                flip = False
                prev = 0
                for cutpoint in list(cuts) + [self.n_var]:
                    if flip:
                        seg[prev:cutpoint] = True
                    flip = not flip
                    prev = cutpoint
                c1 = np.where(seg, p2, p1)
                c2 = np.where(seg, p1, p2)
            else:
                c1, c2 = p1, p2
            children.append(c1)
            children.append(c2)
        children = np.array(children, dtype=bool)
        # bitflip mutation: per-individual gate, per-gene prob (pymoo default)
        gene_prob = min(0.5, 1.0 / self.n_var) if self.n_var else 0.0
        gate = self.rng.random(len(children)) <= self.mutation_prob
        flips = (self.rng.random(children.shape) < gene_prob) & gate[:, None]
        children[flips] = ~children[flips]
        return children

    # -- checkpointing -----------------------------------------------------

    def save(self, path: Path | str) -> None:
        """NPZ + JSON sidecar; no pickled code objects (unlike the
        reference's dill checkpoints)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        state = {
            "n_var": self.n_var,
            "pop_size": self.pop_size,
            "crossover_prob": self.crossover_prob,
            "crossover_points": self.crossover_points,
            "mutation_prob": self.mutation_prob,
            "seed": self.seed,
            "n_gen": self.n_gen,
            "rng_state": json.dumps(self.rng.bit_generator.state),
        }
        arrays = {}
        for key in ("X", "F", "G", "pending"):
            val = getattr(self, key)
            if val is not None:
                arrays[key] = val
        np.savez_compressed(path, meta=json.dumps(state), **arrays)

    @classmethod
    def load(cls, path: Path | str) -> "NSGA2":
        data = np.load(Path(path), allow_pickle=False)
        meta = json.loads(str(data["meta"]))
        rng_state = json.loads(meta.pop("rng_state"))
        n_gen = meta.pop("n_gen")
        algo = cls(**meta)
        algo.rng.bit_generator.state = rng_state
        algo.n_gen = n_gen
        for key in ("X", "F", "G", "pending"):
            if key in data:
                setattr(algo, key, data[key])
        return algo

    # -- results -----------------------------------------------------------

    def pareto_front(self) -> tuple[np.ndarray, np.ndarray]:
        assert self.F is not None and self.X is not None
        front = fast_non_dominated_sort(self.F)[0]
        return self.X[front], self.F[front]
