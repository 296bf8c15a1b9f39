from repro_torch.cluster.executor import ClusterExecutor, DiskCheckpointer, \
    default_trainer_factory
from repro_torch.cluster.job import ClusterJob, JobSpec, JobState, \
    make_cluster_job
from repro_torch.cluster.policy import Action, ScriptedPolicy, make_policy, \
    plan_actions
from repro_torch.cluster.serving import LiveServingEngine, ServingJob, \
    ServingSpec, SyntheticServingEngine, make_serving_engine

__all__ = ["ClusterExecutor", "DiskCheckpointer", "default_trainer_factory",
           "ClusterJob", "JobSpec", "JobState", "make_cluster_job", "Action",
           "ScriptedPolicy", "make_policy", "plan_actions", "ServingSpec",
           "ServingJob", "SyntheticServingEngine", "LiveServingEngine",
           "make_serving_engine"]
