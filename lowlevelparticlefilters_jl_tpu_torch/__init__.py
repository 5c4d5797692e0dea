"""lowlevelparticlefilters_jl_tpu_torch — the PyTorch/CUDA port.

The JAX package ``lowlevelparticlefilters_jl_tpu`` is the reference; this
package mirrors its layout file for file and is held against it by the
``tests/test_torch_*.py`` parity tests.  This slice covers the Kalman
filter and the bootstrap particle filter's log-likelihood.  On CUDA
tensors ``pf.loglik`` runs the whole recursion as one hand-written
kernel (kernels/pf_scan.py); the CUDA sources in ``csrc/`` are built
with ``nvcc`` at first use.

Quick start::

    import torch
    import lowlevelparticlefilters_jl_tpu_torch as llpt

    kf = llpt.KalmanFilter(A, B, C, 0, R1, R2)
    sol = llpt.forward_trajectory(kf, u, y)
    pf = llpt.ParticleFilter(N=100_000, dynamics=f, measurement=g,
                             dynamics_density=R1, measurement_density=R2,
                             initial_density=R1)
    ll = pf.loglik(u, y, generator=torch.Generator(device="cuda"))
"""

from .ops.logsumexp import (
    logsumexp,
    logsumexp_normalize,
    expnormalize,
    effective_particles,
)
from .ops.linalg import symmetrize
from .ops.mvnormal import MvNormal, as_mvnormal, mvnormal_logpdf
from .ops.matrices import TimeVarying, resolve_mat
from .ops.resample import (
    resample,
    resample_systematic,
    resample_systematic_gather,
    resample_stratified,
    resample_residual,
    resample_multinomial,
)
from .filters.base import (AbstractFilter, AbstractKalmanFilter,
                           AbstractParticleFilter)
from .filters.kalman import KalmanFilter, KFState, KalmanInfo
from .filters.particle import ParticleFilter, PFState
from .trajectory import (
    forward_trajectory,
    loglik,
    simulate,
    weighted_mean,
    weighted_cov,
)
from .utils.solutions import (KalmanFilteringSolution,
                              ParticleFilteringSolution)
from .routing import METHODS, last_route
