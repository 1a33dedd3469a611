"""Runtime supervision of the port."""
from .supervisor import StragglerWatchdog, WatchdogEvent

__all__ = ["StragglerWatchdog", "WatchdogEvent"]
