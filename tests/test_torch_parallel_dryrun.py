"""`ecad_tpu_torch.parallel.dryrun_multichip` on the CPU: it runs on the card
by default and raises, before any rank starts, when no card is visible; it
runs its ranks on the CPU over gloo only when asked with ``device="cpu"``."""

import pytest
import torch

from ecad_tpu_torch.parallel import dryrun


def _cards(monkeypatch, n: int) -> list:
    """`n` visible cards as `dryrun_multichip` sees them, and the spawns it
    asks for (none run)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    spawns = []
    monkeypatch.setattr(dryrun, "spawn", lambda fn, n_ranks, args, **kw: spawns.append(
        (n_ranks, args, kw["backend"], kw["device"])))
    return spawns


def test_dryrun_multichip_raises_without_a_card(monkeypatch):
    spawns = _cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="no card is visible"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        dryrun.dryrun_multichip(2, device="meta")
    assert spawns == []


@pytest.mark.parametrize("cards,n,backend", [(1, 2, "gloo"), (2, 2, "nccl"), (4, 2, "nccl"),
                                             (2, 4, "gloo")])
def test_dryrun_multichip_runs_on_the_cards(monkeypatch, cards, n, backend):
    """n ranks on the card: NCCL where n cards are visible, else gloo ranks
    sharing them."""
    spawns = _cards(monkeypatch, cards)
    dryrun.dryrun_multichip(n)
    assert spawns == [(n, ("cuda",), backend, "cuda")]


def test_dryrun_multichip_runs_on_the_cpu_when_asked(capfd):
    """Two gloo ranks on the CPU, dp=1 × tp=2, one evaluation with a finite
    score (≈ 10 s)."""
    dryrun.dryrun_multichip(2, device="cpu", timeout_s=240.0)
    assert "dryrun_multichip OK: 2 ranks on cpu, mesh dp=1 tp=2" in capfd.readouterr().out
