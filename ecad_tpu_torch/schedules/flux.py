"""FLUX cache schedule: 19 full (dual-stream) blocks × {full_attn, full_ff,
full_ff_context} + 38 single-stream blocks × {single_attn, single_proj_mlp,
single_proj_out}.

The port's own copy of ``ecad_tpu/schedules/flux.py`` (reference:
ecad/schedulers/cache_scheduler/flux_cache_schedule.py). Genome flatten
order (to_numpy:62-90): per step, all full-block components first
(block-major), then all single-block components → length
steps·(19·3 + 38·3) = 3420 for 20 steps.
"""

from __future__ import annotations

from typing import Any, Mapping

from .cache_schedule import CacheSchedule

FLUX_FULL_COMPONENTS = ("full_attn", "full_ff", "full_ff_context")
FLUX_SINGLE_COMPONENTS = ("single_attn", "single_proj_mlp", "single_proj_out")
FLUX_NUM_BLOCKS = 19
FLUX_NUM_SINGLE_BLOCKS = 38
FLUX_DEFAULT_STEPS = 20


class FluxCacheSchedule(CacheSchedule):
    # full vocabulary in reference order (flux_cache_schedule.py:51-60 lists
    # single first for `components`, but the flatten order is full-then-single)
    components = FLUX_SINGLE_COMPONENTS + FLUX_FULL_COMPONENTS

    def __init__(self, *args: Any, num_single_blocks: int | None = None, **kwargs: Any):
        if num_single_blocks is None:
            raise ValueError(
                "num_single_blocks must be provided for FluxCacheSchedule"
            )
        self.num_single_blocks = int(num_single_blocks)
        super().__init__(*args, **kwargs)

    def slot_names(self) -> list[tuple[str, str]]:
        full = [
            (str(b), c)
            for b in range(self.num_blocks)
            for c in FLUX_FULL_COMPONENTS
        ]
        single = [
            (f"single_{b}", c)
            for b in range(self.num_single_blocks)
            for c in FLUX_SINGLE_COMPONENTS
        ]
        return full + single

    def to_numpy(self, flatten: bool = True):
        if not flatten:
            raise NotImplementedError(
                "FluxCacheSchedule only supports flatten=True"
            )
        # slot order IS the genome order: full-then-single per step
        return self.mask.flatten().copy()

    @classmethod
    def from_numpy(cls, arr, num_inference_steps, num_blocks, name="", **kw):
        kw.setdefault("num_single_blocks", FLUX_NUM_SINGLE_BLOCKS)
        return super().from_numpy(
            arr, num_inference_steps, num_blocks, name=name, **kw
        )

    def _header(self) -> dict[str, Any]:
        h = super()._header()
        h["num_single_blocks"] = self.num_single_blocks
        return h

    @classmethod
    def _extra_init_kwargs(cls, header: Mapping[str, Any]) -> dict[str, Any]:
        return {"num_single_blocks": int(header["num_single_blocks"])}

    @classmethod
    def default(
        cls,
        num_inference_steps: int = FLUX_DEFAULT_STEPS,
        num_blocks: int = FLUX_NUM_BLOCKS,
        num_single_blocks: int = FLUX_NUM_SINGLE_BLOCKS,
        name: str = "default",
        top_level_config: dict[str, Any] | None = None,
    ) -> "FluxCacheSchedule":
        """All-recompute schedule (the uncached baseline)."""
        return cls(
            num_blocks=num_blocks,
            num_inference_steps=num_inference_steps,
            num_single_blocks=num_single_blocks,
            name=name,
            top_level_config=top_level_config
            or {"height": 256, "width": 256, "guidance_scale": 5},
        )
