"""Kernel-family registry: a tuned kernel family is a declarative spec.
Counterpart of `repro.kernels.registry`.

A family is one :class:`KernelSpec` (candidates, cost model, launcher);
the generic engine in ``kernels/autotune.py`` (`tune`, `dispatch`) does
the rest: deterministic ranking, measurement on the card, the
analytic-entry upgrade rule and the versioned JSON cache.  The specs live
next to their kernels (``kernels/<family>/spec.py``) and load on the
first lookup.

Spec contract (``problem`` is the family's dict describing a shape,
``knobs`` the JSON-able chosen configuration):

=========================  ===============================================
field                      signature / meaning
=========================  ===============================================
``name``                   unique family name; the cache-key prefix
``key_fn``                 ``(problem, dtype_name, backend) -> str``
``enumerate_candidates``   ``(problem, dtype_bytes, smem_bytes, top) ->
                           list[core.dse.Candidate]`` scored ascending,
                           never empty
``cost_fn``                ``(problem, knobs, dtype_bytes) -> dict``, the
                           analytic model row
``make_inputs``            ``(problem, dtype, device) -> tuple`` of
                           tensors to time the kernel on
``build_launcher``         ``(problem, knobs) -> fn(*inputs)``
``reference_fn``           the plain PyTorch path `dispatch` takes for
                           CPU tensors
``problem_fn``             ``(*args, **kwargs) -> (problem, dtype)``
``run_fn``                 ``(plan, *args, **kwargs)``: run the kernel
                           with the plan's knobs
``tie_break``              ``(knobs) -> tuple``, deterministic tie-break
``detail_keys``            candidate-detail fields kept in the plan
=========================  ===============================================
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence


@dataclasses.dataclass(frozen=True)
class Plan:
    """A tuned configuration for one (family, problem) point.

    ``source`` is where this plan object came from (``"cache"`` for a
    file hit); ``provenance`` says whether the winner was timed on the
    card or only ranked by the model, and survives the cache.
    """

    family: str
    key: str
    problem: dict
    knobs: dict
    source: str                  # "cache" | "measured" | "model"
    model_time_s: float
    measured_us: float | None = None
    detail: dict = dataclasses.field(default_factory=dict)

    @property
    def model_time_us(self) -> float:
        return self.model_time_s * 1e6

    @property
    def provenance(self) -> str:
        return "measured" if self.measured_us is not None else "analytic"

    def record(self) -> dict:
        """JSON-able log row (the problem is left to the caller: serving
        problems are plain scalars, an SpMV problem holds a matrix)."""
        return {
            "family": self.family,
            "key": self.key,
            "knobs": dict(self.knobs),
            "source": self.source,
            "provenance": self.provenance,
            "model_time_us": self.model_time_us,
            "measured_us": self.measured_us,
            **({"detail": dict(self.detail)} if self.detail else {}),
        }


def _default_tie_break(knobs: dict) -> tuple:
    return tuple(sorted((k, repr(v)) for k, v in knobs.items()))


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Everything the generic engine needs to tune and run one family."""

    name: str
    key_fn: Callable[[dict, str, str], str]
    enumerate_candidates: Callable[..., Sequence[Any]]
    cost_fn: Callable[..., dict]
    make_inputs: Callable[..., tuple]
    build_launcher: Callable[..., Callable]
    reference_fn: Callable[..., Any]
    problem_fn: Callable[..., tuple]
    run_fn: Callable[..., Any]
    tie_break: Callable[[dict], tuple] = _default_tie_break
    detail_keys: tuple = ()


_REGISTRY: dict[str, KernelSpec] = {}

# Built-in families, loaded on the first lookup.
BUILTIN_SPEC_MODULES = (
    "repro_torch.kernels.matmul.spec",
    "repro_torch.kernels.spmv.spec",
    "repro_torch.kernels.attention.spec",
)
# The names those modules register, declared statically so `unregister`
# refuses them without loading anything.
BUILTIN_FAMILIES = ("matmul", "spmv", "attention", "decode", "decode_int8")
_builtins_loaded = False
_loading_builtins = False


def register(spec: KernelSpec) -> KernelSpec:
    """Add a family to the registry; duplicate names are a hard error."""
    if not isinstance(spec, KernelSpec):
        raise TypeError(f"register() takes a KernelSpec, got {type(spec)!r}")
    # Load the built-ins first so a caller cannot shadow a built-in name
    # before the first lookup.  The spec modules' own register() calls
    # re-enter here mid-load; the _loading guard makes that a no-op.
    _load_builtins()
    if spec.name in _REGISTRY:
        raise ValueError(
            f"kernel family {spec.name!r} is already registered; "
            f"unregister() it first or pick a unique name")
    _REGISTRY[spec.name] = spec
    return spec


def unregister(name: str) -> None:
    """Remove a family.  Built-in families are refused: their spec
    modules register at import time and could not be reloaded."""
    if name in BUILTIN_FAMILIES:
        raise ValueError(f"cannot unregister built-in family {name!r}")
    _REGISTRY.pop(name, None)


def _load_builtins() -> None:
    global _builtins_loaded, _loading_builtins
    if _builtins_loaded or _loading_builtins:
        return
    import importlib
    _loading_builtins = True
    try:
        for mod in BUILTIN_SPEC_MODULES:
            # Roll back a module's partial registrations if its import
            # fails, so the next lookup shows the real error again rather
            # than tripping the duplicate-name guard.
            before = set(_REGISTRY)
            try:
                importlib.import_module(mod)
            except Exception:
                for name in set(_REGISTRY) - before:
                    del _REGISTRY[name]
                raise
        _builtins_loaded = True
    finally:
        _loading_builtins = False


def get(name: str) -> KernelSpec:
    """Look up a family, loading the built-in specs on first miss."""
    spec = _REGISTRY.get(name)
    if spec is None:
        _load_builtins()
        spec = _REGISTRY.get(name)
    if spec is None:
        raise KeyError(
            f"unknown kernel family {name!r}; registered: {families()}")
    return spec


def families() -> list[str]:
    """Registered family names (built-ins included), sorted."""
    _load_builtins()
    return sorted(_REGISTRY)
