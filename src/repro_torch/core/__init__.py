"""Switch data plane: types, hashing, the fused pipeline, the composed
switch step, the controller (the names ``repro.core`` exports)."""
from .types import (  # noqa: F401
    OP_R_REQ, OP_W_REQ, OP_R_REP, OP_W_REP, OP_F_REQ, OP_F_REP, OP_CRN_REQ,
    OP_NONE, ROUTE_DROP, ROUTE_SERVER, ROUTE_CLIENT, HKEY_LANES,
    PacketBatch, LookupTable, StateTable, RequestTable, OrbitBuffer,
    OrbitMeta, Counters, SwitchState, empty_batch, init_switch_state,
    COUNTER_DTYPE, sat_add,
)
from .hashing import (  # noqa: F401
    hash128_u32, hash128_u32_np, hash128_bytes_np, server_of_key,
)
from .pipeline import (  # noqa: F401
    PipelineCarry, SubroundOut, subround_pipeline, switch_pipeline,
    window_pipeline,
)
from .switch import switch_step, StepOutput, StepStats  # noqa: F401
from .controller import (  # noqa: F401
    CacheController, ControllerConfig, TracedUpdate, controller_step,
)
