"""Temporal-parallel filtering and smoothing, banks of filters, and the
particle- and time-sharded verbs on ``torch.distributed``."""

from .sharded import (
    particle_mesh,
    shard_pf_state,
    sharded_update,
    sharded_forward_trajectory,
    sharded_apf_update,
    sharded_ffbs_smooth,
)
from .bank import (bank_mesh, bank_forward_trajectory, bank_loglik,
                   shard_bank, stack_filters)
from .temporal import (
    parallel_forward_trajectory,
    parallel_rts_smooth,
    parallel_iekf_smooth,
    parallel_ukf_smooth,
)
