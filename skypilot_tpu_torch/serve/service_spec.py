"""Service spec of the serving fleet (port of the constructor and the
`autoscaling_enabled` rule of skypilot_tpu/serve/service_spec.py
`SkyServiceSpec`): the replica bounds, delays and targets the
autoscalers read, with the reference's checks and messages. The YAML
round trip of the `service:` section is not on the fleet's path and is
not ported.
"""
from __future__ import annotations

from typing import Any, Optional

from skypilot_tpu_torch.errors import InvalidTaskYAMLError


class SkyServiceSpec:

    def __init__(self,
                 readiness_path: str = '/',
                 initial_delay_seconds: int = 60,
                 readiness_timeout_seconds: int = 15,
                 post_data: Optional[Any] = None,
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 # float (uniform fleet) or {accelerator: qps} dict —
                 # the dict selects the instance-aware autoscaler
                 # (reference: sky/serve/autoscalers.py:605).
                 target_qps_per_replica: Optional[Any] = None,
                 upscale_delay_seconds: int = 60,
                 downscale_delay_seconds: int = 120,
                 port: Optional[int] = None,
                 load_balancing_policy: str = 'round_robin',
                 autoscaler: str = 'request_rate',
                 base_ondemand_fallback_replicas: int = 0,
                 dynamic_ondemand_fallback: bool = False,
                 target_queue_per_replica: float = 4.0) -> None:
        self.autoscaler = autoscaler
        # Spot serving (reference: autoscalers.py:933 fallback logic):
        # keep N always-on-demand replicas, and optionally back-fill
        # preempted spot capacity with on-demand until spot recovers.
        self.base_ondemand_fallback_replicas = base_ondemand_fallback_replicas
        self.dynamic_ondemand_fallback = dynamic_ondemand_fallback
        # queue_length autoscaler target (in-flight requests/replica).
        self.target_queue_per_replica = float(target_queue_per_replica)
        if not readiness_path.startswith('/'):
            raise InvalidTaskYAMLError(
                f'readiness path must start with /: {readiness_path!r}')
        self.readiness_path = readiness_path
        self.initial_delay_seconds = initial_delay_seconds
        self.readiness_timeout_seconds = readiness_timeout_seconds
        self.post_data = post_data
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas if max_replicas is not None else \
            min_replicas
        self.target_qps_per_replica = target_qps_per_replica
        self.upscale_delay_seconds = upscale_delay_seconds
        self.downscale_delay_seconds = downscale_delay_seconds
        self.port = port
        self.load_balancing_policy = load_balancing_policy
        if self.max_replicas < self.min_replicas:
            raise InvalidTaskYAMLError(
                'max_replicas < min_replicas')
        if isinstance(self.target_qps_per_replica, dict):
            if not self.target_qps_per_replica or any(
                    float(v) <= 0
                    for v in self.target_qps_per_replica.values()):
                raise InvalidTaskYAMLError(
                    'target_qps_per_replica accelerator map needs at '
                    'least one entry and all-positive qps values')
        elif (self.target_qps_per_replica is not None and
                self.target_qps_per_replica <= 0):
            raise InvalidTaskYAMLError(
                'target_qps_per_replica must be positive')

    @property
    def autoscaling_enabled(self) -> bool:
        return (self.max_replicas > self.min_replicas and
                self.target_qps_per_replica is not None)
