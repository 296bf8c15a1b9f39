from repro_torch.core.coordination import CoordinationStore
from repro_torch.core.elastic_runtime import ElasticTrainer
from repro_torch.core.election import LeaderElection
from repro_torch.core.membership import Membership, StragglerDetector
from repro_torch.core.scaling import Busy, ScalingController, ScalingRecord

__all__ = ["Busy", "CoordinationStore", "ElasticTrainer", "LeaderElection",
           "Membership", "ScalingController", "ScalingRecord",
           "StragglerDetector"]
