"""DiT topology DSL: skip / repeat / parallel / reverse block graphs (the
port's own copy of ``ecad_tpu/graph/interpreter.py``).

The reference expresses per-step transformer topologies as a JSON
``BuilderConfig`` {node: {inputs, outputs, skip, repeat_count,
repeat_target, input_type}} compiled to a torch.fx graph by BFS with
loop unrolling (ecad/graph/pixart_builder.py:96-238) and aggregate functions
{identity, add, avg} (ecad/graph/func_registry.py:31-36). Here the same
config is interpreted into a linear **execution plan**; the model's block
stage runs the plan directly, eagerly (``models/pixart.py``
`run_block_stage`).

Node-name conventions (ecad/graph/node.py:18-33): "input"/"output" are the
endpoints, digit names are transformer blocks, names containing "dummy" are
always-skip fan-in/out points.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

BuilderConfig = dict[str, dict[str, Any]]

AGG_FUNCS = ("identity", "add", "avg")
DEFAULT_FUNC_NAME = "identity"


@dataclass(frozen=True)
class PlanOp:
    """One step of a plan: aggregate `inputs` from the value environment
    with `agg`, optionally apply transformer block `block`, bind result to
    `out`."""

    out: str
    inputs: tuple[str, ...]
    agg: str = DEFAULT_FUNC_NAME
    block: int | None = None  # None → identity (skip/dummy/output nodes)


Plan = tuple[PlanOp, ...]


# ---------------------------------------------------------------------------
# validation (parity with ecad/graph/builder.py:107-175)
# ---------------------------------------------------------------------------


def verify_matching_io(config: BuilderConfig) -> None:
    for name, node in config.items():
        inputs = node.get("inputs", [])
        if len(inputs) > 1 and "input_type" not in node:
            raise ValueError(
                f"Node {name} has multiple inputs but no input_type defined."
            )
        for inpt in inputs:
            if inpt not in config:
                raise ValueError(
                    f"Node {name} has input {inpt} but is missing from the graph."
                )
            if name not in config[inpt].get("outputs", []):
                raise ValueError(
                    f"Node {name} has input {inpt} but missing from "
                    f"{inpt}.outputs."
                )
        for output in node.get("outputs", []):
            if output not in config:
                raise ValueError(
                    f"Node {name} has output {output} but is missing from the graph."
                )
            if name not in config[output].get("inputs", []):
                raise ValueError(
                    f"Node {name} has output {output} but missing from "
                    f"{output}.inputs."
                )
        it = node.get("input_type", DEFAULT_FUNC_NAME)
        if it not in AGG_FUNCS:
            raise ValueError(f"Node {name} has unknown input_type {it!r}.")
    if "input" not in config or "output" not in config:
        raise ValueError("Graph must contain 'input' and 'output' nodes.")


def check_for_cycles(config: BuilderConfig) -> None:
    visited: set[str] = set()
    stack: set[str] = set()

    def dfs(node: str) -> None:
        if node in stack:
            raise ValueError("Cycle detected in graph configuration.")
        if node not in visited:
            stack.add(node)
            for neighbor in config[node].get("outputs", []):
                dfs(neighbor)
            stack.remove(node)
            visited.add(node)

    for node in config:
        dfs(node)


# ---------------------------------------------------------------------------
# plan construction (BFS with repeat unrolling, pixart_builder.py:126-238)
# ---------------------------------------------------------------------------


def build_plan(config: BuilderConfig) -> Plan:
    verify_matching_io(config)
    check_for_cycles(config)

    # working copies of mutable traversal state (repeat rewiring)
    inputs_map = {k: list(v.get("inputs", [])) for k, v in config.items()}
    agg_map = {
        k: v.get("input_type", DEFAULT_FUNC_NAME) for k, v in config.items()
    }
    repeat_left = {k: int(v.get("repeat_count", 0)) for k, v in config.items()}

    ops: list[PlanOp] = []

    def is_block(name: str) -> bool:
        return name.isdigit()

    def is_skipped(name: str) -> bool:
        node = config[name]
        return bool(node.get("skip", False)) or "dummy" in name

    def bfs(start: str, end: str, suffix: int) -> int:
        queue = [start]
        visited: set[str] = set()
        while queue:
            curr = queue.pop(0)
            if curr in visited:
                continue
            visited.add(curr)

            if curr != "input":
                # aggregate inputs; the start node of a repeat sub-walk reads
                # from the previous suffix (pixas in builder :146-152)
                in_suffix = suffix - int(curr == start)
                in_names = tuple(
                    f"{i}:{in_suffix}" for i in inputs_map[curr]
                )
                block = (
                    int(curr)
                    if is_block(curr) and not is_skipped(curr)
                    else None
                )
                ops.append(
                    PlanOp(
                        out=f"{curr}:{suffix}",
                        inputs=in_names,
                        agg=agg_map[curr],
                        block=block,
                    )
                )

            if (
                curr != "input"
                and curr != "output"
                and repeat_left[curr] >= 1
            ):
                target = config[curr].get("repeat_target")
                assert target is not None, "Repeat target not found."
                repeat_left[curr] -= 1
                saved_inputs = inputs_map[target]
                saved_agg = agg_map[target]
                inputs_map[target] = [curr]
                agg_map[target] = "identity"
                suffix = bfs(target, curr, suffix + 1)
                repeat_left[curr] += 1
                inputs_map[target] = saved_inputs
                agg_map[target] = saved_agg

            if curr == end:
                break
            if curr == "input" or (curr != "output"):
                queue.extend(config[curr].get("outputs", []))
        return suffix

    bfs("input", "output", 0)
    # the last bound "output:<suffix>" is the graph result
    out_names = [op.out for op in ops if op.out.startswith("output:")]
    if not out_names:
        raise ValueError("Plan produced no output node.")
    return tuple(ops)


def execute_plan(plan: Plan, h0, block_apply):
    """Run a plan. ``block_apply(block_idx, hidden)`` applies
    one transformer block (with its own cache handling) and returns the new
    hidden states. Returns the output value."""
    env = {"input:0": h0}
    result = h0
    for op in plan:
        vals = [env[name] for name in op.inputs]
        if op.agg == "identity":
            if len(vals) != 1:
                raise ValueError(
                    f"identity aggregation needs exactly 1 input at {op.out}"
                )
            x = vals[0]
        elif op.agg == "add":
            x = sum(vals[1:], start=vals[0])
        elif op.agg == "avg":
            x = sum(vals[1:], start=vals[0]) / len(vals)
        else:
            raise ValueError(f"unknown aggregate {op.agg!r}")
        if op.block is not None:
            x = block_apply(op.block, x)
        env[op.out] = x
        if op.out.startswith("output:"):
            result = x
    return result


def plan_block_sequence(plan: Plan) -> list[int]:
    """The order in which real blocks execute (for tests/cost accounting)."""
    return [op.block for op in plan if op.block is not None]
