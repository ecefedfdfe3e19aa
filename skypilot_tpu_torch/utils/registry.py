"""Name -> implementation registries of the serving fleet (port of
skypilot_tpu/utils/registry.py): the autoscalers and load-balancing
policies, registered by decorator and looked up case-insensitively.
Only the two registries the fleet reads are kept.
"""
from __future__ import annotations

from typing import Callable, Dict, Generic, List, Optional, Type, TypeVar

T = TypeVar('T')


class Registry(Generic[T]):

    def __init__(self, registry_name: str) -> None:
        self._name = registry_name
        self._registry: Dict[str, T] = {}
        self._aliases: Dict[str, str] = {}
        self._default: Optional[str] = None

    def register(self, name: Optional[str] = None,
                 aliases: Optional[List[str]] = None,
                 default: bool = False) -> Callable[[Type], Type]:

        def decorator(cls: Type) -> Type:
            key = (name or cls.__name__).lower()
            if key in self._registry:
                raise ValueError(
                    f'{self._name} {key!r} is already registered.')
            self._registry[key] = cls
            for alias in aliases or []:
                self._aliases[alias.lower()] = key
            if default:
                self._default = key
            return cls

        return decorator

    def from_str(self, name: Optional[str]) -> Optional[T]:
        if name is None:
            return None
        key = name.lower()
        key = self._aliases.get(key, key)
        if key not in self._registry:
            raise ValueError(
                f'{self._name} {name!r} not found; registered: '
                f'{sorted(self._registry)}')
        return self._registry[key]

    def get(self, name: str) -> Optional[T]:
        key = name.lower()
        key = self._aliases.get(key, key)
        return self._registry.get(key)

    @property
    def default(self) -> Optional[str]:
        return self._default

    def keys(self) -> List[str]:
        return sorted(self._registry)

    def values(self) -> List[T]:
        return [self._registry[k] for k in sorted(self._registry)]


# Filled by the modules that own them (serve/autoscalers.py,
# serve/load_balancing_policies.py):
AUTOSCALER_REGISTRY: 'Registry' = Registry('Autoscaler')
LB_POLICY_REGISTRY: 'Registry' = Registry('LoadBalancingPolicy')
