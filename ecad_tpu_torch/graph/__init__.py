from .configs import middle_repeat, middle_skip, parallel, reverse, skip_blocks
from .dit_schedule import DiTSchedule, default_config
from .interpreter import (
    BuilderConfig,
    Plan,
    PlanOp,
    build_plan,
    check_for_cycles,
    execute_plan,
    plan_block_sequence,
    verify_matching_io,
)

__all__ = [
    "BuilderConfig",
    "Plan",
    "PlanOp",
    "build_plan",
    "execute_plan",
    "plan_block_sequence",
    "verify_matching_io",
    "check_for_cycles",
    "DiTSchedule",
    "default_config",
    "skip_blocks",
    "middle_skip",
    "middle_repeat",
    "parallel",
    "reverse",
]
