"""The rack: workload, clients, storage servers and the simulator."""
