"""Serving stack of the port: the slot scheduler, SLO policy, health
monitor, fault injection, the image :class:`CnnEngine`, the
:class:`ModelRegistry` fleet of image engines, the :class:`Supervisor` of
worker processes and the token :class:`Engine`."""
from .clock import MONOTONIC, Clock, MonotonicClock, VirtualClock
from .cnn import CnnEngine, CnnServeConfig, ImageRequest
from .engine import Engine, Request, ServeConfig
from .faults import (FAULT_POINTS, EngineCrash, FaultInjector, FaultSpec,
                     TransientLaunchError, derive_seed)
from .health import DEGRADED, HEALTHY, QUARANTINED, HealthMonitor
from .policy import AdmissionController, DynamicBucketPolicy, bucket_sizes
from .registry import ModelRegistry
from .scheduler import DrainTimeout, LatencyTracker, SlotScheduler
from .supervisor import (Supervisor, SupervisorConfig, WorkerDead,
                         WorkerTimeout)
from .worker import WorkerModel, WorkerSpec, worker_main

__all__ = ["MONOTONIC", "Clock", "MonotonicClock", "VirtualClock",
           "CnnEngine", "CnnServeConfig", "ImageRequest", "Engine",
           "Request", "ServeConfig", "FAULT_POINTS",
           "EngineCrash", "FaultInjector", "FaultSpec",
           "TransientLaunchError", "derive_seed", "DEGRADED", "HEALTHY",
           "QUARANTINED", "HealthMonitor", "AdmissionController",
           "DynamicBucketPolicy", "bucket_sizes", "ModelRegistry",
           "DrainTimeout",
           "LatencyTracker", "SlotScheduler", "Supervisor",
           "SupervisorConfig", "WorkerDead", "WorkerTimeout", "WorkerModel",
           "WorkerSpec", "worker_main"]
