"""Elastic Morpheus training: the serving plane's robustness contract
applied to the train loop (see :mod:`repro_torch.training.supervisor`)."""
from .plan import TrainPlan, TrainProfile, plan_hot_experts
from .supervisor import SupervisorConfig, TrainSupervisor

__all__ = ["TrainPlan", "TrainProfile", "plan_hot_experts",
           "SupervisorConfig", "TrainSupervisor"]
