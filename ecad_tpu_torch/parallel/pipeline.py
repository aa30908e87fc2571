"""Pipeline parallelism (pp): GPipe-style microbatched block stages over the
ranks of a ("dp", "pp") mesh, in PyTorch.

Counterpart of ``ecad_tpu/parallel/pipeline.py``, for the PixArt tower
(28 homogeneous blocks; FLUX's dual → single heterogeneity is left to tp
and sp, as in the reference). Each pp rank holds one stage: the blocks
[s·nb/pp, (s+1)·nb/pp) and their ECAD caches (`build_pp_forward` drops
the other blocks, so weights and caches divide by pp); the pre- and
post-stage modules (patch, adaLN, caption projection, final projection,
<1 % of the weights) run on every rank.

`build_pp_forward` makes the stage model a `PixArtStage`, whose forward
is the GPipe schedule over T = n_micro + pp − 1 ticks: at tick t stage s
runs microbatch t − s (batch rows m::n_micro, the reference's grouping),
taking it from the patch embedding on the first stage and from stage
s − 1 otherwise, and hands its output on to stage s + 1 — the
reference's ppermute ring, whose wrap-around edge the first stage never
reads and which is therefore not sent. A bubble tick (t − s outside the
microbatches) does nothing here: where the reference computes clamped
garbage and masks its cache and output writes out, eager PyTorch skips
them. The last stage's outputs are broadcast to every stage, which then
all run the final projection.

The forward keeps the model's signature, so the pipelines' own loops
(`PixArtPipeline.denoise`, the TGATE gate) run over the stages
unchanged: their per-block list caches (`init_cache` with the stage's
block count) stand for the reference's stacked cache (``stacked_cache``,
``to/from_stacked_cache`` :78-100), and `PixArtTransformer.encode_text`
on the stage's blocks gives its ``stacked_cross_kv``. The denoisers
below only split the batch over dp and gather the latents.

Point-to-point calls: NCCL, and gloo on CPU tensors, send the tensors as
they are. gloo takes no CUDA tensors for send and recv (on an H100 the
rank's process aborts), so for ranks that share a card over gloo this
module stages every handed-on microbatch through pinned host memory
explicitly (`_send`, `_recv`).

dp: each dp row of the mesh pipelines its own rows of the batch
(`parallel.mesh.batch_sharding`); the denoisers gather the final latents
over dp.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.pixart import COMPONENTS, PixArtTransformer, run_block_stage
from ..pipelines.pixart_pipeline import PopulationDenoiser
from .distributed import process_count
from .mesh import Mesh, mesh_over


def create_pp_mesh(pp: int, dp: int = 1) -> Mesh:
    """("dp", "pp") over the group's ranks, pp minormost so a stage hands
    on to its neighbour rank; each dp row pipelines on its own."""
    world = process_count()
    if dp * pp != world:
        raise ValueError(f"dp*pp={dp * pp} != {world} ranks")
    return mesh_over(np.arange(world).reshape(dp, pp), ("dp", "pp"))


def stage_range(num_blocks: int, mesh: Mesh) -> range:
    """The blocks of this rank's stage."""
    pp = mesh.size("pp")
    if num_blocks % pp:
        raise ValueError(f"num_blocks={num_blocks} not divisible by pp={pp}")
    n = num_blocks // pp
    s = mesh.coord("pp")
    return range(s * n, (s + 1) * n)


def _staged(x: torch.Tensor) -> bool:
    return dist.get_backend() == "gloo" and x.is_cuda


def _send(x: torch.Tensor, dst: int, mesh: Mesh) -> None:
    mesh._note("send", "pp", x)
    x = x.contiguous()
    if _staged(x):
        x = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    dist.send(x, dst)


def _recv(like: torch.Tensor, src: int) -> torch.Tensor:
    if _staged(like):
        host = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        dist.recv(host, src)
        return host.to(like.device)
    buf = torch.empty_like(like)
    dist.recv(buf, src)
    return buf


class PixArtStage(PixArtTransformer):
    """A PixArt model cut to one pp stage by `build_pp_forward`: ``blocks``
    holds the stage's blocks, ``stage`` says which, and the forward is the
    GPipe schedule over ``pp_mesh``'s pp axis in ``n_micro`` microbatches.

    The forward has the whole model's signature and result on this dp
    row's batch: `cache` is the stage's per-block cache {comp: [(B, T, d)]
    × blocks of the stage}, updated in place and returned; `mask` is the
    whole model's step mask (one row a block); `text_precomputed` is
    ``encode_text`` of the stage model. `plan` must be None: the stages
    run the blocks in their order."""

    def forward(self, latents, text_embeds, timestep, cache, mask, text_mask=None,
                resolution=None, aspect_ratio=None, plan=None, text_precomputed=None):
        c, mesh, n_micro = self.config, self.pp_mesh, self.n_micro
        pp, s = mesh.size("pp"), mesh.coord("pp")
        ranks = mesh.axis_ranks("pp")
        b = latents.shape[0]
        gh, gw = latents.shape[1] // c.patch_size, latents.shape[2] // c.patch_size
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro={n_micro}")
        if plan is not None:
            raise NotImplementedError("pp runs the blocks in their order: no DiT plan")
        h, t6, emb_t, enc, kv, enc_bias = self.process_input(
            latents, text_embeds, timestep, text_mask, resolution, aspect_ratio,
            text_precomputed,
        )
        rows_mask = [tuple(bool(v) for v in row) for row in np.asarray(mask, dtype=bool)]
        local_mask = rows_mask[self.stage.start:self.stage.stop]
        out_buf = torch.empty_like(h)
        for t in range(n_micro + pp - 1):
            m = t - s  # this stage's microbatch at tick t
            if not 0 <= m < n_micro:
                continue  # a bubble tick: no work, no cache or output write
            rows = slice(m, None, n_micro)
            inp = h[rows] if s == 0 else _recv(h[rows], ranks[s - 1])
            sub = {k: [v[rows] for v in cache[k]] for k in COMPONENTS}
            out, new = run_block_stage(
                self.blocks, inp, enc[rows], t6[rows],
                None if enc_bias is None else enc_bias[rows], sub, local_mask,
                enc_kv=None if kv is None else tuple((k_[rows], v_[rows]) for k_, v_ in kv),
            )
            for k in COMPONENTS:
                for old, dst, src in zip(sub[k], cache[k], new[k]):
                    if src is not old:  # recomputed: write the microbatch's rows
                        dst[rows] = src
            if s < pp - 1:
                _send(out, ranks[s + 1], mesh)
            else:
                out_buf[rows] = out
        # the last stage's outputs to every stage (the reference's psum)
        mesh.broadcast(out_buf, "pp", pp - 1)
        return self.create_output(out_buf, emb_t, gh, gw), cache


def build_pp_forward(model: PixArtTransformer, mesh: Mesh, n_micro: int) -> PixArtStage:
    """The pipeline-parallel forward over `mesh`'s pp axis (the reference's
    :131, with ``stack_block_params`` :66): `model` cut to this rank's
    stage in place and made a `PixArtStage` — ``blocks`` keeps only the
    stage's blocks (the others are freed) and the forward becomes the
    GPipe schedule over `n_micro` microbatches; call it as the whole model
    is called. A model already staged is returned as it is."""
    if isinstance(model, PixArtStage):
        return model
    stage = stage_range(model.config.num_blocks, mesh)
    if model.config.quant is not None:
        raise NotImplementedError("pp harness supports quant=None only")
    model.blocks = nn.ModuleList(model.blocks[i] for i in stage)
    model.stage, model.pp_mesh, model.n_micro = stage, mesh, n_micro
    model.__class__ = PixArtStage
    return model


class PipelinedPopulationDenoiser:
    """`PopulationDenoiser` with the block stage pipelined over pp (the
    reference's :341): the pipeline's model is cut to this rank's stage
    (`build_pp_forward`) and the pipeline's own denoise loop runs it. On a mesh
    with dp > 1 each dp row denoises its rows of the batch and the latents
    are gathered over dp; a dp row's CFG batch must divide by n_micro."""

    def __init__(self, pipeline, mesh: Mesh, n_micro: int):
        self.pipeline = pipeline
        self.mesh = mesh
        self.n_micro = n_micro
        build_pp_forward(pipeline.model, mesh, n_micro)

    def _rows(self, *arrays):
        return tuple(None if a is None else self.mesh.shard(a, "dp", 0) for a in arrays)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.mesh.size("dp") == 1 else self.mesh.all_gather(x, "dp", dim=0)

    def denoise(self, masks, noise, text, neg, text_mask=None, neg_mask=None) -> torch.Tensor:
        """Same contract as `PopulationDenoiser.denoise`: `masks` a (steps,
        blocks, 3) bool array (step 0 all True)."""
        rows = self._rows(noise, text, neg, text_mask, neg_mask)
        return self._gather(PopulationDenoiser(self.pipeline).denoise(masks, *rows))


class TGATEPipelinedDenoiser(PipelinedPopulationDenoiser):
    """TGATE (`pipelines.tgate`) over the pp stages (the reference's :436):
    the `TGATEPixArtPipeline`'s own gated trajectory on the stage model —
    `gate_step` CFG steps at batch 2B, the gate on the stage's caches, then
    the negative batch B without guidance. Both phases' batches split into
    n_micro microbatches on each dp row: B % (n_micro · dp) == 0."""

    def denoise(self, noise, text, neg, text_mask=None, neg_mask=None) -> torch.Tensor:
        b = noise.shape[0]
        dp = self.mesh.size("dp")
        if b % self.n_micro or (b // self.n_micro) % dp:
            raise ValueError(
                f"TGATE pp phase 2 batch {b} must split into n_micro={self.n_micro} "
                f"microbatches divisible by dp={dp}; need B % n_micro == 0 and "
                "(B//n_micro) % dp == 0"
            )
        rows = self._rows(noise, text, neg, text_mask, neg_mask)
        return self._gather(self.pipeline.denoise(*rows))
