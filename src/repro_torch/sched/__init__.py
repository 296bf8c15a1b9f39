from repro_torch.sched.base import MaxThroughput, StaticPolicy, alive_jobs, \
    group_size, reserve_serving, serving_demand, throughput_model_of, \
    tier_of
from repro_torch.sched.throughput import AnalyticModel, MeasuredModel, \
    ModelProfile, PROFILES, ThroughputModel, throughput
from repro_torch.sched.serving import CrossTierPolicy, serving_jobs
from repro_torch.sched.simulator import ClusterSimulator, Job
from repro_torch.sched.tiresias import ElasticTiresias, Tiresias
from repro_torch.sched.traffic import diurnal, flat, parse_trace, spike

__all__ = ["StaticPolicy", "alive_jobs", "group_size",
           "throughput_model_of", "tier_of", "serving_demand",
           "reserve_serving", "CrossTierPolicy", "serving_jobs",
           "MaxThroughput", "ModelProfile", "PROFILES", "throughput",
           "ThroughputModel", "AnalyticModel", "MeasuredModel",
           "ClusterSimulator", "Job", "Tiresias", "ElasticTiresias",
           "diurnal", "flat", "parse_trace", "spike"]
