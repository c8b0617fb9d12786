"""Image-serving stack of the port: the slot scheduler, SLO policy,
health monitor, fault injection and :class:`CnnEngine`."""
from .clock import MONOTONIC, Clock, MonotonicClock, VirtualClock
from .cnn import CnnEngine, CnnServeConfig, ImageRequest
from .faults import (FAULT_POINTS, EngineCrash, FaultInjector, FaultSpec,
                     TransientLaunchError, derive_seed)
from .health import DEGRADED, HEALTHY, QUARANTINED, HealthMonitor
from .policy import AdmissionController, DynamicBucketPolicy, bucket_sizes
from .scheduler import DrainTimeout, LatencyTracker, SlotScheduler

__all__ = ["MONOTONIC", "Clock", "MonotonicClock", "VirtualClock",
           "CnnEngine", "CnnServeConfig", "ImageRequest", "FAULT_POINTS",
           "EngineCrash", "FaultInjector", "FaultSpec",
           "TransientLaunchError", "derive_seed", "DEGRADED", "HEALTHY",
           "QUARANTINED", "HealthMonitor", "AdmissionController",
           "DynamicBucketPolicy", "bucket_sizes", "DrainTimeout",
           "LatencyTracker", "SlotScheduler"]
