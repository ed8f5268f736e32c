"""Compared schemes (paper §5.1): NoCache and NetCache [21] (port of
``repro.baselines``).

Both share the rack simulator's clients and servers; only the switch
policy differs.  Neither runs a kernel: their switch passes are a few
element-wise ops per subround.
"""
from .netcache import (  # noqa: F401
    NetCacheState, counted_netcache_step, init_netcache, netcache_install,
    netcache_step,
)
from .nocache import nocache_step  # noqa: F401
