"""The port's platform events: the ``SpeedChange`` its straggler monitor
emits (``repro/scenario`` holds the rest of the scenario engine)."""
from .events import PlatformEvent, SpeedChange

__all__ = ["PlatformEvent", "SpeedChange"]
