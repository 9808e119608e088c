"""The port's platform model: what its straggler hooks and its H100 fleet
preset need of ``repro/core`` (the scheduler itself stays in ``repro``)."""
from .platform import H100_KINDS, Platform, Processor, ProcPower, h100_fleet, h100_fleet_si

__all__ = ["H100_KINDS", "Platform", "Processor", "ProcPower", "h100_fleet", "h100_fleet_si"]
