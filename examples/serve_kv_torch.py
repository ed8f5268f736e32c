"""Serve a skewed key-value workload through a full simulated rack on the
PyTorch port and compare OrbitCache against NoCache and NetCache: the
twin of ``examples/serve_kv.py`` (the paper's Fig. 9, at laptop scale).

Runs on the CUDA card (OrbitCache's switch pass is one subround kernel
launch per subround; NetCache and NoCache launch no kernel); ``--cpu``
runs the plain PyTorch versions on the CPU instead.

    python examples/serve_kv_torch.py [--cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.types import resolve_device  # noqa: E402
from repro_torch.kvstore.simulator import RackConfig, RackSimulator  # noqa: E402,E501
from repro_torch.kvstore.workload import Workload, WorkloadConfig  # noqa: E402,E501


def main():
    dev = resolve_device("cpu" if "--cpu" in sys.argv else None)
    wl = Workload(WorkloadConfig(num_keys=500_000, zipf_alpha=0.99,
                                 offered_rps=3.0e6), device=dev)
    print(f"workload: {wl.cfg.num_keys} keys, zipf-{wl.cfg.zipf_alpha}, "
          f"head coverage of 128 hottest = {wl.head_coverage(128):.1%}, "
          f"on {dev}")
    for scheme in ("nocache", "netcache", "orbitcache"):
        sim = RackSimulator(RackConfig(scheme=scheme, cache_entries=128,
                                       recirc_gbps=150.0), wl, device=dev)
        if scheme == "orbitcache":
            sim.preload(wl.hottest_keys(128))
        elif scheme == "netcache":
            sim.preload(wl.hottest_keys(10_000))
        res = sim.run(0.05)
        rx_sw = res.traces["rx_switch"].sum()
        rx_srv = res.traces["rx_server"].sum()
        print(f"{scheme:11s} rx={res.throughput_rps() / 1e6:5.2f}M rps  "
              f"balance={res.balancing_efficiency():.2f}  "
              f"p50={res.latency_percentile(0.5):6.1f}us  "
              f"p99={res.latency_percentile(0.99):6.1f}us  "
              f"hot-hit-share={rx_sw / max(rx_sw + rx_srv, 1):.1%}")
    print("OrbitCache balances the rack; NoCache saturates the hot-key "
          "server; NetCache can't cache the large-value hot items.")


if __name__ == "__main__":
    main()
