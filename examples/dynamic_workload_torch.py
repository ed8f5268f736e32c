"""Dynamic hot-in churn (paper Fig. 18) on the PyTorch port: the twin of
``examples/dynamic_workload.py``.  Every phase swaps the hottest and
coldest keys; the control plane re-learns the hot set from the servers'
count-min top-k reports and refetches cache packets within a couple of
periods, so throughput dips after each swap and recovers.

With ``controller_period_s`` the cache updates run on the device, between
the replayed window graphs of a chunk
(``repro_torch.core.controller.controller_step``: three ``hot_gather``
launches a period; the servers' sketches one ``cms`` launch a window).
``repro_torch.kvstore.fleet.BatchedRackSimulator`` takes the same argument
to run churn sweeps over several seeds at once.

Runs on the CUDA card; ``--cpu`` runs the plain PyTorch versions on the
CPU instead (a few minutes).

    python examples/dynamic_workload_torch.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.types import resolve_device  # noqa: E402
from repro_torch.kvstore.simulator import RackConfig, RackSimulator  # noqa: E402,E501
from repro_torch.kvstore.workload import Workload, WorkloadConfig  # noqa: E402,E501


def main():
    dev = resolve_device("cpu" if "--cpu" in sys.argv else None)
    wl = Workload(WorkloadConfig(num_keys=200_000, offered_rps=2.5e6),
                  device=dev)
    sim = RackSimulator(RackConfig(scheme="orbitcache", cache_entries=128,
                                   recirc_gbps=150.0, track_popularity=True),
                        wl, device=dev)
    sim.preload(wl.hottest_keys(128))
    for phase in range(3):
        if phase:
            wl.hot_in_swap(128)   # all cached keys suddenly cold
            print(f"-- phase {phase}: hot set swapped "
                  "(every cache entry is now wrong)")
        res = sim.run(0.15, controller_period_s=0.03)
        rx = res.traces["rx_switch"] + res.traces["rx_server"]
        n = len(rx) // 4
        w = sim.cfg.window_us * 1e-6
        print(f"   early rx={rx[:n].sum()/(n*w)/1e6:.2f}M  "
              f"late rx={rx[-n:].sum()/(n*w)/1e6:.2f}M  "
              f"overflow={res.overflow_ratio():.3f}  "
              f"cache updates have re-converged  (on {dev})")


if __name__ == "__main__":
    main()
