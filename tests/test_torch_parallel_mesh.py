"""The port's process-group layer (`ecad_tpu_torch.parallel.distributed`,
`.mesh`) against the JAX package's `ecad_tpu.parallel`, on the CPU:
`initialize`'s no-op and its refusals, `host_shard` and `is_coordinator`
against the reference's with ``jax.process_index/count`` monkeypatched (as
tests/test_mesh_eval.py does), `create_mesh`'s rank layout and errors
against the reference's device layout, the tp slices of `shard_params`
against the reference's `shard_params` shards on the 8-device CPU mesh,
and the collectives of a `Mesh` over real gloo ranks (spawned, each spawn
with its own deadline, rendezvous through a file under `tmp_path`).

The rank workers live at module level and import no JAX: the spawned
processes import this module by name."""

import json

import numpy as np
import pytest
import torch

from ecad_tpu_torch.parallel import distributed as tdist
from ecad_tpu_torch.parallel import mesh as tmesh
from ecad_tpu_torch.parallel.launch import spawn

SPAWN_S = 90  # deadline of one spawn: a hung collective fails the test


def _clear_env(monkeypatch, names) -> None:
    """Takes `names` out of os.environ so that teardown puts back what was
    there, set or not: `delenv` of an absent variable records nothing, and
    `_map_reference_env` writes torchrun's variables into os.environ
    directly, so without the `setenv` first they would outlive the test."""
    for var in names:
        monkeypatch.setenv(var, "")
        monkeypatch.delenv(var)


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    _clear_env(monkeypatch, ("WORLD_SIZE", "RANK", "LOCAL_RANK", "JAX_NUM_PROCESSES",
                             "JAX_COORDINATOR_ADDRESS"))
    tdist.initialize()
    monkeypatch.setenv("WORLD_SIZE", "1")
    tdist.initialize(device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    tdist.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert (tdist.process_index(), tdist.process_count()) == (0, 1)
    assert tdist.is_coordinator()
    tdist.barrier("noop")  # one process: returns at once


def test_ranks_sharing_a_card_need_gloo_named(monkeypatch):
    """Two local ranks and one card, no backend given: a ValueError that
    says to pass backend='gloo' — never a quiet choice of gloo; no card at
    all for device='cuda': a RuntimeError."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        tdist.initialize(device="cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no card is visible"):
        tdist.initialize(device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        tdist.initialize("gloo", device="meta")
    assert not torch.distributed.is_initialized()


def test_reference_environment_maps_onto_torchrun(monkeypatch):
    """The reference's JAX_* variables map onto torchrun's, which
    `_map_reference_env` writes into os.environ itself: the test clears
    them through monkeypatch (`_clear_env`), so that teardown takes them
    away again and a later `initialize` in this process sees one process,
    not a 4-rank rendezvous."""
    import os

    torchrun = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
    before = {v: os.environ.get(v) for v in torchrun}
    _clear_env(monkeypatch, torchrun)
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.7:8476")
    tdist._map_reference_env()
    assert [os.environ[v] for v in torchrun] == ["4", "3", "3", "10.0.0.7", "8476"]
    monkeypatch.undo()
    assert {v: os.environ.get(v) for v in torchrun} == before
    assert os.environ.get("WORLD_SIZE") in (None, "1")
    tdist.initialize(device="cpu")
    assert not torch.distributed.is_initialized() and tdist.process_count() == 1


@pytest.mark.parametrize("world", [1, 2, 3])
def test_host_shard_and_coordinator_match_reference(monkeypatch, world):
    import jax

    from ecad_tpu.parallel import distributed as jdist

    items = [f"cand_{i}" for i in range(7)]
    union = []
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda w=world: w)
        monkeypatch.setattr(tdist, "process_index", lambda r=rank: r)
        monkeypatch.setattr(tdist, "process_count", lambda w=world: w)
        assert tdist.host_shard(items) == jdist.host_shard(items) == items[rank::world]
        assert tdist.is_coordinator() == jdist.is_coordinator() == (rank == 0)
        union += tdist.host_shard(items)
    assert sorted(union) == sorted(items)


LAYOUTS = [(8, 1, 1), (4, 2, 1), (2, 4, 1), (1, 8, 1), (2, 2, 2), (1, 2, 4), (4, 1, 2)]


@pytest.mark.parametrize("dp,tp,sp", LAYOUTS)
def test_rank_layout_matches_reference_device_layout(dp, tp, sp):
    """Rank r sits where the reference puts device r: row-major (dp, sp,
    tp), tp minormost; (dp, tp) with the same axis names when sp == 1."""
    import jax

    from ecad_tpu.parallel import create_mesh as jcreate

    jm = jcreate(dp=dp, tp=tp, sp=sp, devices=jax.devices()[: dp * tp * sp])
    want = np.vectorize(lambda d: d.id)(jm.devices)
    got = tmesh.rank_layout(dp, tp, sp, dp * tp * sp)
    np.testing.assert_array_equal(got, want)
    mesh = tmesh.Mesh(got, rank=dp * tp * sp - 1)
    assert mesh.axis_names == tuple(jm.axis_names)
    assert mesh.shape == dict(jm.shape)
    # dp=None takes the rest, as the reference's does
    np.testing.assert_array_equal(tmesh.rank_layout(None, tp, sp, dp * tp * sp), got)


def test_create_mesh_errors_match_reference():
    import jax

    from ecad_tpu.parallel import create_mesh as jcreate

    with pytest.raises(ValueError, match=r"dp\*sp\*tp=6 != 8 devices"):
        jcreate(dp=3, tp=2, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match=r"dp\*sp\*tp=6 != 8 ranks"):
        tmesh.rank_layout(3, 2, 1, 8)
    # one process: any layout but 1×1 is refused by the world size
    with pytest.raises(ValueError, match=r"dp\*sp\*tp=2 != 1 ranks"):
        tmesh.create_mesh(dp=2)
    one = tmesh.create_mesh()
    assert (one.size("dp"), one.size("tp"), one.size("sp"), one.coord("tp")) == (1, 1, 1, 0)
    x = torch.arange(6.0).reshape(2, 3)
    assert tmesh.batch_sharding(one, x) is x
    assert one.all_reduce(x, "tp") is x and one.all_gather(x, "sp", 1) is x


def _reference_shards(params, tp):
    """Each leaf of a Flax param tree as the reference's `shard_params`
    places it on a dp=1 × tp mesh: {tp index: the leaf's shard there}."""
    import jax
    from flax import linen as fnn

    from ecad_tpu.parallel import create_mesh as jcreate
    from ecad_tpu.parallel import shard_params as jshard

    mesh = jcreate(dp=1, tp=tp, devices=jax.devices()[:tp])
    sharded = jshard(params, mesh)
    order = {d.id: i for i, d in enumerate(mesh.devices.reshape(-1))}

    def shard_of(leaf, r):
        for s in leaf.addressable_shards:
            if order[s.device.id] == r:
                return np.asarray(s.data)
        raise AssertionError

    return {r: jax.tree.map(lambda leaf: shard_of(leaf, r), fnn.meta.unbox(sharded))
            for r in range(tp)}


@pytest.mark.parametrize("tp", [2, 4])
def test_pixart_tp_slices_equal_reference_shards(tp):
    """`shard_params` cuts every PixArt tensor as the reference's logical
    axes put it on a tp mesh (HEADS and MLP split, EMBED and KV whole):
    rank r's state dict equals the bridged tree of device r's shards."""
    import jax
    from flax import linen as fnn

    from ecad_tpu.models import pixart as jpx
    from ecad_tpu_torch.models import pixart as tpx
    from ecad_tpu_torch.models.bridge import pixart_state_dict

    _, params = jpx.init_params(jpx.PixArtConfig.tiny(dtype=jax.numpy.float32), 0)
    full = pixart_state_dict(jax.tree.map(np.asarray, fnn.meta.unbox(params)))
    shards = _reference_shards(params, tp)
    cfg = tpx.PixArtConfig.tiny(dtype=torch.float32)
    for r in range(tp):
        mesh = tmesh.Mesh(tmesh.rank_layout(1, tp, 1, tp), rank=r)
        with torch.device("meta"):
            local = tpx.PixArtTransformer(cfg, mesh=mesh)
        got = tmesh.shard_params(full, local, mesh)
        want = pixart_state_dict(shards[r])
        assert got.keys() == want.keys()
        for k in got:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
        # q, k, v (weight, bias) and to_out of both attentions, proj_in (weight,
        # bias) and proj_out: 17 tensors cut in each of the 2 blocks
        assert sum(1 for k in got if got[k].shape != full[k].shape) == 2 * 17


def test_flux_tp_slices_equal_reference_shards():
    """FLUX's kernels as the reference shards them, but the single block's
    ``proj_out``: it reads [attention ‖ MLP], and the port cuts each
    segment alike (the rank's heads, then its MLP columns) where the
    reference's GSPMD splits the 5d rows in two and reshards the input.
    The reference leaves every FLUX bias whole; the port cuts the column
    sites' biases with their outputs."""
    import jax
    from flax import linen as fnn

    from ecad_tpu.models import flux as jfx
    from ecad_tpu_torch.models import flux as tfx
    from ecad_tpu_torch.models.bridge import flux_state_dict

    _, params = jfx.init_flux_params(jfx.FluxConfig.tiny(dtype=jax.numpy.float32), 0)
    full = flux_state_dict(jax.tree.map(np.asarray, fnn.meta.unbox(params)))
    shards = _reference_shards(params, 2)
    cfg = tfx.FluxConfig.tiny(dtype=torch.float32)
    width, hidden = cfg.num_heads * cfg.head_dim, cfg.dim * cfg.mlp_ratio
    for r in range(2):
        mesh = tmesh.Mesh(tmesh.rank_layout(1, 2, 1, 2), rank=r)
        with torch.device("meta"):
            local = tfx.FluxTransformer(cfg, mesh=mesh)
        got = tmesh.shard_params(full, local, mesh)
        want = flux_state_dict(shards[r])
        for k in got:
            if k.startswith("single_blocks.") and k.endswith("proj_out.weight"):
                attn, mlp = full[k].split([width, hidden], dim=1)
                torch.testing.assert_close(got[k], torch.cat(
                    [attn.chunk(2, 1)[r], mlp.chunk(2, 1)[r]], dim=1), rtol=0, atol=0)
            elif k.endswith(".bias") and got[k].shape != full[k].shape:
                torch.testing.assert_close(got[k], full[k].chunk(2)[r], rtol=0, atol=0)
            else:
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def _collectives_rank(rank, world, out):
    """Every layout of 4 ranks: each rank's coordinates and axis groups, and
    the collectives' results over each axis."""
    rows = []
    for dp, tp, sp in ((4, 1, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2), (1, 4, 1)):
        mesh = tmesh.create_mesh(dp=dp, tp=tp, sp=sp)
        row = {"layout": [dp, tp, sp],
               "coord": {a: mesh.coord(a) for a in ("dp", "sp", "tp")},
               "groups": {a: mesh.axis_ranks(a) for a in mesh.axis_names}}
        for a in mesh.axis_names:
            x = torch.full((2, 3), float(rank + 1), dtype=torch.bfloat16)
            row[f"sum_{a}"] = mesh.all_reduce(x.clone(), a).tolist()
            row[f"max_{a}"] = mesh.all_reduce(torch.tensor([rank], dtype=torch.int32), a,
                                              "max").tolist()
            row[f"gather_{a}"] = mesh.all_gather(torch.tensor([[rank]]), a, dim=1).tolist()
            row[f"bcast_{a}"] = mesh.broadcast(torch.tensor([rank]), a, src=0).tolist()
        row["traffic"] = dict(mesh.traffic)
        rows.append(row)
    tdist.barrier("done")
    (out / f"rank{rank}.json").write_text(json.dumps(rows))


def test_mesh_collectives_over_four_gloo_ranks(tmp_path):
    """Over 4 spawned gloo ranks: each layout's coordinates and axis groups
    are the reference layout's rows and columns, and all_reduce (sum of
    bf16, max of int32), all_gather (in axis order) and broadcast give
    their results over exactly those groups; `traffic` counts payload
    bytes."""
    spawn(_collectives_rank, 4, (tmp_path,), timeout_s=SPAWN_S, threads=1,
          init_dir=tmp_path)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(4)]
    for i, (dp, tp, sp) in enumerate(((4, 1, 1), (2, 2, 1), (1, 2, 2), (2, 1, 2), (1, 4, 1))):
        layout = tmesh.rank_layout(dp, tp, sp, 4)
        names = ("dp", "tp") if sp == 1 else ("dp", "sp", "tp")
        for r in range(4):
            row = ranks[r][i]
            where = dict(zip(names, (int(j) for j in np.argwhere(layout == r)[0])))
            assert row["coord"] == {a: where.get(a, 0) for a in ("dp", "sp", "tp")}
            for a in names:
                idx = tuple(where[n] if n != a else slice(None) for n in names)
                group = [int(g) for g in layout[idx]]
                assert row["groups"][a] == group
                assert row[f"sum_{a}"] == [[float(sum(g + 1 for g in group))] * 3] * 2
                assert row[f"max_{a}"] == [max(group)]
                assert row[f"gather_{a}"] == [group]
                assert row[f"bcast_{a}"] == [group[0]]
                if len(group) > 1:
                    assert row["traffic"][f"all_reduce_sum/{a}"] == 12
