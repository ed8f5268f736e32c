"""The rack: workload, clients, storage servers and the simulators (the
names ``repro.kvstore`` exports)."""
from .workload import WorkloadConfig, Workload, WorkloadArrays  # noqa: F401
from .simulator import RackConfig, RackSimulator  # noqa: F401
from .fleet import BatchedRackSimulator, BatchedFabricSimulator  # noqa: F401
from .fabric_sim import FabricConfig, FabricSimulator  # noqa: F401
