"""The paper's own system configuration: a storage rack with 32 emulated
servers (100K RPS each), Zipf-0.99 over 10M keys, bimodal 64/1024-B values,
cache of 128 entries with queue size 8 (paper §5.1)."""
from repro_torch.kvstore.simulator import RackConfig
from repro_torch.kvstore.workload import WorkloadConfig

RACK = RackConfig(scheme="orbitcache", cache_entries=128, queue_size=8)
WORKLOAD = WorkloadConfig(num_keys=10_000_000, zipf_alpha=0.99,
                          value_sizes=((64, 0.82), (1024, 0.18)))
