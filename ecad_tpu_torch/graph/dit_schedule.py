"""DiT schedule: per-inference-step transformer topologies.

Reference counterpart: ecad/schedulers/dit_scheduler/dit_schedule.py (+
PixArt/Flux subclasses) — a mapping step → graph builder, serialized as

    {"dit_schedule": {num_blocks, num_inference_steps, name, attributes,
                      "schedule": {"000": <BuilderConfig>, …}},
     "config": {…}, "metrics": {…}}

(dit_schedule.py:68-97; the builder serializes to its raw BuilderConfig,
builder.py:104-105). The port's own copy of ``ecad_tpu/graph/dit_schedule.py``:
a schedule carries validated configs and exposes execution plans; there is
no fx graph or weight re-rooting — plans are interpreted against the
model's blocks (``interpreter.execute_plan``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Optional

from .interpreter import BuilderConfig, Plan, build_plan, plan_block_sequence


class DiTSchedule:
    def __init__(
        self,
        num_blocks: int,
        num_inference_steps: int,
        name: str = "",
        schedule: Optional[dict[int, BuilderConfig]] = None,
        top_level_config: Optional[dict[str, Any]] = None,
        attributes: Optional[dict[str, Any]] = None,
        metrics: Optional[dict[str, Any]] = None,
    ) -> None:
        self.num_blocks = int(num_blocks)
        self.num_inference_steps = int(num_inference_steps)
        self.name = name
        if schedule is None:
            schedule = {
                step: default_config(num_blocks)
                for step in range(num_inference_steps)
            }
        self.schedule = {int(k): v for k, v in schedule.items()}
        self.top_level_config = dict(top_level_config or {})
        self.attributes = dict(attributes or {})
        self.metrics = dict(metrics or {})
        self._plans: dict[int, Plan] = {}

    def plan(self, step: int) -> Plan:
        if step not in self._plans:
            self._plans[step] = build_plan(self.schedule[step])
        return self._plans[step]

    def step_plans(self) -> list[Plan]:
        return [self.plan(s) for s in range(self.num_inference_steps)]

    def block_sequence(self, step: int) -> list[int]:
        return plan_block_sequence(self.plan(step))

    def is_default(self) -> bool:
        return all(
            self.block_sequence(s) == list(range(self.num_blocks))
            for s in range(self.num_inference_steps)
        )

    # -- JSON ---------------------------------------------------------------

    def to_dict(self) -> dict[str, Any]:
        return {
            "dit_schedule": {
                "num_blocks": self.num_blocks,
                "num_inference_steps": self.num_inference_steps,
                "name": self.name,
                "attributes": self.attributes,
                "schedule": {
                    f"{step:03}": cfg for step, cfg in self.schedule.items()
                },
            },
            "config": self.top_level_config,
            "metrics": self.metrics,
        }

    def to_json(self, file_path: Path | str) -> None:
        p = Path(file_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("w") as f:
            json.dump(self.to_dict(), f, indent=4, sort_keys=False)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "DiTSchedule":
        header = data["dit_schedule"]
        return cls(
            num_blocks=header["num_blocks"],
            num_inference_steps=header["num_inference_steps"],
            name=header.get("name", ""),
            schedule={
                int(k): v for k, v in header["schedule"].items()
            },
            top_level_config=data.get("config") or {},
            attributes=header.get("attributes") or {},
            metrics=data.get("metrics") or {},
        )

    @classmethod
    def from_json(cls, file_path: Path | str) -> "DiTSchedule":
        with Path(file_path).open() as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def default(
        cls, num_blocks: int, num_inference_steps: int, name: str = "default"
    ) -> "DiTSchedule":
        return cls(num_blocks, num_inference_steps, name=name)

    def visualize(self, output_dir: Path | str) -> list[Path]:
        """Graphviz-style DOT dump per step (the reference renders with
        graphviz, pixart_dit_schedule.py:78-83; we emit .dot text so no
        graphviz binary is required)."""
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        written = []
        for step, cfg in self.schedule.items():
            lines = ["digraph G {"]
            for node, conf in cfg.items():
                attrs = []
                if conf.get("skip"):
                    attrs.append("style=dashed")
                if conf.get("repeat_count"):
                    attrs.append(f'label="{node} x{conf["repeat_count"] + 1}"')
                lines.append(f'  "{node}" [{", ".join(attrs)}];')
                for o in conf.get("outputs", []):
                    lines.append(f'  "{node}" -> "{o}";')
            lines.append("}")
            p = out / f"{self.name}_step_{step:03}.dot"
            p.write_text("\n".join(lines))
            written.append(p)
        return written


def default_config(num_blocks: int) -> BuilderConfig:
    """Sequential chain input → 0 → … → N-1 → output
    (reference dit generators helpers.py:48-59)."""
    config: BuilderConfig = {
        "input": {"outputs": ["0"]},
        "output": {"inputs": [str(num_blocks - 1)]},
    }
    for b in range(num_blocks):
        config[str(b)] = {
            "inputs": [str(b - 1)] if b > 0 else ["input"],
            "outputs": [str(b + 1)] if b < num_blocks - 1 else ["output"],
        }
    return config
