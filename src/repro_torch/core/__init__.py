from repro_torch.core.api import EDLJob
from repro_torch.core.compile_service import CompileService, CompileTicket, \
    PRIO_COMMITTED, PRIO_SPECULATIVE
from repro_torch.core.coordination import CoordinationStore
from repro_torch.core.elastic_runtime import ElasticTrainer
from repro_torch.core.election import LeaderElection
from repro_torch.core.membership import Membership, StragglerDetector
from repro_torch.core.scaling import Busy, ScalingController, ScalingRecord
from repro_torch.core.serving import make_decode_fn, serve_batch
from repro_torch.core.stop_resume import checkpoint_save, checkpoint_stop, \
    resume_from_checkpoint, stop_resume_rescale, teardown_trainer

__all__ = ["EDLJob", "CompileService", "CompileTicket", "PRIO_COMMITTED",
           "PRIO_SPECULATIVE", "CoordinationStore", "ElasticTrainer",
           "LeaderElection", "Membership", "StragglerDetector", "Busy",
           "ScalingController", "ScalingRecord", "stop_resume_rescale",
           "checkpoint_save", "checkpoint_stop", "resume_from_checkpoint",
           "teardown_trainer", "make_decode_fn", "serve_batch"]
