"""Global name->class registry.

A copy of spider_tpu/common/registry.py, which is framework-free: the port
keeps its own process-global registry so that its classes (the
"spider_decoder" controller, the "sd" pipeline) register without importing
the JAX package. It is the only coupling between config `type` strings and
Python classes. Namespaces: builder, task, model,
processor, lr_scheduler, runner, plus free-form paths/state.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type


class Registry:
    """A process-global registry of named classes and paths."""

    _MAPS = (
        "builder_name_mapping",
        "task_name_mapping",
        "model_name_mapping",
        "processor_name_mapping",
        "lr_scheduler_name_mapping",
        "runner_name_mapping",
        "state",
        "paths",
    )

    def __init__(self) -> None:
        self.mapping: Dict[str, Dict[str, Any]] = {name: {} for name in self._MAPS}

    # -- generic machinery -------------------------------------------------
    def _register(self, kind: str, name: str, force: bool = False) -> Callable:
        mapping = self.mapping[kind]

        def wrap(cls):
            if name in mapping and not force:
                existing = mapping[name]
                if existing is not cls:
                    raise KeyError(
                        f"Name '{name}' already registered for {existing} in {kind}"
                    )
            mapping[name] = cls
            return cls

        return wrap

    # -- decorators ---------------------------------------------------------
    def register_builder(self, name: str, force: bool = False) -> Callable:
        return self._register("builder_name_mapping", name, force)

    def register_task(self, name: str, force: bool = False) -> Callable:
        return self._register("task_name_mapping", name, force)

    def register_model(self, name: str, force: bool = False) -> Callable:
        return self._register("model_name_mapping", name, force)

    def register_processor(self, name: str, force: bool = False) -> Callable:
        return self._register("processor_name_mapping", name, force)

    def register_lr_scheduler(self, name: str, force: bool = False) -> Callable:
        return self._register("lr_scheduler_name_mapping", name, force)

    def register_runner(self, name: str, force: bool = False) -> Callable:
        return self._register("runner_name_mapping", name, force)

    # -- paths / state --------------------------------------------------------
    def register_path(self, name: str, path: str) -> None:
        self.mapping["paths"][name] = path

    def register(self, name: str, obj: Any) -> None:
        self.mapping["state"][name] = obj

    # -- getters ---------------------------------------------------------------
    def get_builder_class(self, name: str) -> Optional[Type]:
        return self.mapping["builder_name_mapping"].get(name)

    def get_task_class(self, name: str) -> Optional[Type]:
        return self.mapping["task_name_mapping"].get(name)

    def get_model_class(self, name: str) -> Optional[Type]:
        return self.mapping["model_name_mapping"].get(name)

    def get_processor_class(self, name: str) -> Optional[Type]:
        return self.mapping["processor_name_mapping"].get(name)

    def get_lr_scheduler_class(self, name: str) -> Optional[Type]:
        return self.mapping["lr_scheduler_name_mapping"].get(name)

    def get_runner_class(self, name: str) -> Optional[Type]:
        return self.mapping["runner_name_mapping"].get(name)

    def get_path(self, name: str) -> Optional[str]:
        return self.mapping["paths"].get(name)

    def get(self, name: str, default: Any = None) -> Any:
        return self.mapping["state"].get(name, default)

    def list_models(self):
        return sorted(self.mapping["model_name_mapping"])

    def list_tasks(self):
        return sorted(self.mapping["task_name_mapping"])

    def list_builders(self):
        return sorted(self.mapping["builder_name_mapping"])

    def unregister(self, kind: str, name: str) -> None:
        self.mapping[f"{kind}_name_mapping"].pop(name, None)


registry = Registry()
