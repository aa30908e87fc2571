"""Topology config constructors: skip / middle-skip / repeat / parallel /
reverse (reference ecad/schedulers/dit_scheduler/generators/helpers.py:48-190;
the port's own copy of ``ecad_tpu/graph/configs.py``)."""

from __future__ import annotations

from typing import Iterable

from .dit_schedule import default_config
from .interpreter import BuilderConfig


def skip_blocks(num_blocks: int, blocks_to_skip: Iterable[int]) -> BuilderConfig:
    config = default_config(num_blocks)
    for block in blocks_to_skip:
        config[str(block)]["skip"] = True
    return config


def middle_skip(num_blocks: int, num_affected_blocks: int) -> BuilderConfig:
    middle = num_blocks // 2
    start = middle - num_affected_blocks // 2
    end = middle + num_affected_blocks // 2
    if num_affected_blocks % 2 == 0:
        end -= 1
    return skip_blocks(num_blocks, range(start, end + 1))


def middle_repeat(
    num_blocks: int,
    start_skip: int,
    end_skip: int,
    repeat_block: int | None = None,
    repeat_count: int | None = None,
) -> BuilderConfig:
    """Skip [start, end] but loop one block in their place
    (reference helpers.py:96-116)."""
    if repeat_block is None:
        repeat_block = start_skip + (end_skip - start_skip) // 2
    if repeat_count is None:
        repeat_count = end_skip - start_skip
    config = skip_blocks(num_blocks, range(start_skip, end_skip + 1))
    node = config[str(repeat_block)]
    node["skip"] = False
    node["repeat_count"] = repeat_count
    node["repeat_target"] = str(repeat_block)
    return config


def parallel(
    num_blocks: int,
    first_parallel: int,
    last_parallel: int,
    loop_count: int = 0,
    aggregate_func: str = "add",
) -> BuilderConfig:
    """Fan a block range out in parallel between dummy fan-in/out nodes,
    aggregated by add/avg; optional loop over the fan
    (reference helpers.py:119-160)."""
    config = default_config(num_blocks)
    input_node = str(first_parallel - 1) if first_parallel >= 1 else "input"
    output_node = (
        str(last_parallel + 1) if last_parallel + 1 < num_blocks else "output"
    )
    par = [str(i) for i in range(first_parallel, last_parallel + 1)]
    config["dummy_before"] = {"inputs": [input_node], "outputs": list(par)}
    config["dummy_after"] = {
        "inputs": list(par),
        "outputs": [output_node],
        "input_type": aggregate_func,
    }
    config[input_node]["outputs"] = ["dummy_before"]
    config[output_node]["inputs"] = ["dummy_after"]
    for b in par:
        config[b]["inputs"] = ["dummy_before"]
        config[b]["outputs"] = ["dummy_after"]
    if loop_count > 0:
        config["dummy_after"]["repeat_count"] = loop_count
        config["dummy_after"]["repeat_target"] = "dummy_before"
    return config


def reverse(
    num_blocks: int, first_to_reverse: int, last_to_reverse: int
) -> BuilderConfig:
    """Run a block range in reverse order (reference helpers.py:163-190)."""
    config = default_config(num_blocks)
    for i in range(first_to_reverse, last_to_reverse + 1):
        config[str(i)]["inputs"] = [str(i + 1)]
        config[str(i)]["outputs"] = [str(i - 1)]
    input_node = str(first_to_reverse - 1) if first_to_reverse >= 1 else "input"
    output_node = (
        str(last_to_reverse + 1)
        if last_to_reverse + 1 < num_blocks
        else "output"
    )
    config[input_node]["outputs"] = [str(last_to_reverse)]
    config[output_node]["inputs"] = [str(first_to_reverse)]
    config[str(first_to_reverse)]["outputs"] = [output_node]
    config[str(last_to_reverse)]["inputs"] = [input_node]
    return config
