"""Small name→object registries used as the framework's extension mechanism.

The reference uses several ad-hoc registries (compute-fn registries in
ecad/transformer_blocks/custom_attn_ff.py:6-59, pipeline registry in
ecad/pipelines/load_pipeline.py:16-58, aggregate-fn registry in
ecad/graph/func_registry.py:19-39, generator registries built by `inspect`).
We unify them behind one generic class.
"""

from __future__ import annotations

from typing import Callable, Generic, Iterator, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    """A name → object registry with decorator registration and a default."""

    def __init__(self, kind: str, default: str | None = None):
        self.kind = kind
        self._items: dict[str, T] = {}
        self._default_name = default

    def register(self, name_or_obj=None, *, name: str | None = None):
        """Register an object. Usable as ``@reg.register`` or
        ``@reg.register(name="x")`` or ``reg.register(obj, name="x")``."""
        if name_or_obj is None:
            def deco(obj):
                self._items[name or obj.__name__] = obj
                return obj
            return deco
        obj = name_or_obj
        self._items[name or getattr(obj, "__name__", str(obj))] = obj
        return obj

    def get(self, name: str | None = None, strict: bool = True) -> T | None:
        if name is None or name == "":
            name = self._default_name
        if name is None:
            raise KeyError(f"no default registered for {self.kind} registry")
        if name not in self._items:
            if strict:
                raise KeyError(
                    f"unknown {self.kind} {name!r}; known: {sorted(self._items)}"
                )
            return None
        return self._items[name]

    def set_default(self, name: str) -> None:
        self._default_name = name

    @property
    def default(self) -> T:
        return self.get(None)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def names(self) -> list[str]:
        return sorted(self._items)



def build_function_registry(
    module_globals: dict, prefix: str = "gen_"
) -> dict[str, Callable]:
    """Collect all ``gen_*`` functions of a module into a dict, mirroring the
    inspect-based GEN_FUNCTIONS pattern
    (ecad/schedulers/cache_scheduler/generators/pixart_schedule_generators.py:548-557).
    """
    return {
        name: fn
        for name, fn in sorted(module_globals.items())
        if callable(fn) and name.startswith(prefix)
    }
