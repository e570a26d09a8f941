"""Validation/normalization of `@remote(...)` / `.options(...)` arguments.

Reference equivalent: `python/ray/_private/ray_option_utils.py` — one table of
allowed options for tasks vs actors with type checks and defaults.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

_COMMON_OPTIONS = {
    "num_cpus", "num_gpus", "resources", "memory", "accelerator_type",
    "runtime_env", "scheduling_strategy", "_metadata", "name", "namespace",
    "lifetime", "max_concurrency", "num_returns", "max_retries",
    "retry_exceptions", "max_restarts", "max_task_retries",
    "placement_group", "placement_group_bundle_index",
    "placement_group_capture_child_tasks", "max_pending_calls",
    "concurrency_groups", "enable_task_events", "label_selector",
}

TASK_ONLY = {"num_returns", "max_retries", "retry_exceptions"}
ACTOR_ONLY = {"max_restarts", "max_task_retries", "name", "namespace",
              "lifetime", "max_concurrency", "max_pending_calls",
              "concurrency_groups"}


@dataclass
class TaskOptions:
    num_cpus: float = 1.0
    num_gpus: float = 0.0
    resources: Dict[str, float] = field(default_factory=dict)
    memory: Optional[int] = None
    num_returns: Any = 1  # int | "streaming" | "dynamic"
    max_retries: int = 3
    retry_exceptions: Any = False
    runtime_env: Optional[dict] = None
    scheduling_strategy: Any = None
    placement_group: Any = None  # PlacementGroup | pg_id hex | None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False
    enable_task_events: bool = True
    label_selector: Optional[dict] = None
    accelerator_type: Optional[str] = None
    _metadata: Optional[dict] = None


@dataclass
class ActorOptions:
    # None (unlike tasks): an actor with unspecified num_cpus needs 1 CPU to
    # be placed but 0 while running (reference: ray_option_utils actor
    # defaults).
    num_cpus: Optional[float] = None
    num_gpus: float = 0.0
    resources: Dict[str, float] = field(default_factory=dict)
    memory: Optional[int] = None
    name: Optional[str] = None
    namespace: Optional[str] = None
    lifetime: Optional[str] = None  # None | "detached" | "non_detached"
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: Optional[int] = None
    max_pending_calls: int = -1
    concurrency_groups: Optional[dict] = None
    runtime_env: Optional[dict] = None
    scheduling_strategy: Any = None
    placement_group: Any = None  # PlacementGroup | pg_id hex | None
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False
    enable_task_events: bool = True
    label_selector: Optional[dict] = None
    accelerator_type: Optional[str] = None
    _metadata: Optional[dict] = None


def _validate(updates: Dict[str, Any], *, for_actor: bool) -> None:
    for k in updates:
        if k not in _COMMON_OPTIONS:
            raise ValueError(f"Invalid option keyword: '{k}'")
        if for_actor and k in TASK_ONLY:
            raise ValueError(f"Option '{k}' is not valid for actors")
        if not for_actor and k in ACTOR_ONLY:
            raise ValueError(f"Option '{k}' is not valid for tasks")
    nr = updates.get("num_returns")
    if nr is not None and not (
            isinstance(nr, int) and nr >= 0) and nr not in ("streaming", "dynamic"):
        raise ValueError(f"num_returns must be int>=0 or 'streaming'/'dynamic', got {nr!r}")
    groups = updates.get("concurrency_groups")
    if groups:
        if not isinstance(groups, dict) or not all(
                isinstance(k, str) and isinstance(v, int) and v > 0
                for k, v in groups.items()):
            raise ValueError(
                "concurrency_groups must be {group_name: max_concurrency "
                "(int > 0)}")


def task_options(updates: Dict[str, Any],
                 base: Optional[TaskOptions] = None) -> TaskOptions:
    _validate(updates, for_actor=False)
    import dataclasses
    opts = dataclasses.replace(base) if base else TaskOptions()
    for k, v in updates.items():
        setattr(opts, k, v)
    if opts.num_cpus is None:
        opts.num_cpus = 1.0
    return opts


def actor_options(updates: Dict[str, Any],
                  base: Optional[ActorOptions] = None) -> ActorOptions:
    _validate(updates, for_actor=True)
    import dataclasses
    opts = dataclasses.replace(base) if base else ActorOptions()
    for k, v in updates.items():
        setattr(opts, k, v)
    return opts


class OptionsProxy:
    """Returned by `.options(...)`: a rebindable target with overridden opts.

    `submit(args, kwargs, opts)` is supplied by the owner; `bind` builds a DAG
    node when the owner supports it.
    """

    def __init__(self, submit, bind=None):
        self._submit = submit
        self._bind = bind

    def remote(self, *args, **kwargs):
        return self._submit(args, kwargs)

    def bind(self, *args, **kwargs):
        if self._bind is None:
            raise AttributeError("bind() is not supported on this target")
        return self._bind(args, kwargs)


def resource_demand(opts) -> Dict[str, float]:
    """Flatten options into a resource demand map {resource: amount}."""
    demand: Dict[str, float] = {}
    if opts.num_cpus:
        demand["CPU"] = float(opts.num_cpus)
    if opts.num_gpus:
        demand["GPU"] = float(opts.num_gpus)
    if opts.memory:
        demand["memory"] = float(opts.memory)
    for k, v in (opts.resources or {}).items():
        if v:
            demand[k] = float(v)
    return demand
