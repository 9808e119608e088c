"""Runtime of the port: serving, training and fault tolerance."""
from .fault import (FailureInjector, SimulatedFault, StepTimer, StragglerMonitor,
                    run_with_restarts)
from .serve_loop import Request, ServeLoop
from .train_loop import Trainer, TrainerConfig

__all__ = ["FailureInjector", "Request", "ServeLoop", "SimulatedFault", "StepTimer",
           "StragglerMonitor", "Trainer", "TrainerConfig", "run_with_restarts"]
