"""Runtime of the port: serving, training, GPipe, fault tolerance and
elastic rescale."""
from .elastic import RescaleReport, rescale_plan
from .fault import (FailureInjector, SimulatedFault, StepTimer, StragglerMonitor,
                    run_with_restarts)
from .pipeline import pipeline_apply, stack_stage_params
from .serve_loop import Request, ServeLoop
from .train_loop import Trainer, TrainerConfig

__all__ = ["FailureInjector", "RescaleReport", "Request", "ServeLoop", "SimulatedFault",
           "StepTimer", "StragglerMonitor", "Trainer", "TrainerConfig", "pipeline_apply",
           "rescale_plan", "run_with_restarts", "stack_stage_params"]
