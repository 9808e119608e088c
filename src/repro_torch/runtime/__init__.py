"""Runtime of the port: serving, training, GPipe and fault tolerance."""
from .fault import (FailureInjector, SimulatedFault, StepTimer, StragglerMonitor,
                    run_with_restarts)
from .pipeline import pipeline_apply, stack_stage_params
from .serve_loop import Request, ServeLoop
from .train_loop import Trainer, TrainerConfig

__all__ = ["FailureInjector", "Request", "ServeLoop", "SimulatedFault", "StepTimer",
           "StragglerMonitor", "Trainer", "TrainerConfig", "pipeline_apply",
           "run_with_restarts", "stack_stage_params"]
