"""Sharding rules for the production mesh (port of ``repro.parallel``)."""
from .sharding import (  # noqa: F401
    AxisRules, ShardingCtx, logical, make_ctx, with_sharding,
)
