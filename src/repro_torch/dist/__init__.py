"""The mesh and its collectives (``api``), the placement plans
(``sharding``), the pipeline schedule (``pipeline``), and fault tolerance:
step deadlines, failure drills, the checkpoint-resume loop."""

from repro_torch.dist.fault import (FailureInjector, InjectedFailure, StepGuard,
                                    StepTimeout, StragglerEvent, run_resilient)

__all__ = ["FailureInjector", "InjectedFailure", "StepGuard", "StepTimeout",
           "StragglerEvent", "run_resilient"]
