"""Runtime supervision of the port: the training supervisor and the
straggler watchdog (port of ``repro/runtime``)."""
from .supervisor import (StragglerWatchdog, Supervisor, SupervisorConfig,
                         WatchdogEvent)

__all__ = ["StragglerWatchdog", "Supervisor", "SupervisorConfig",
           "WatchdogEvent"]
