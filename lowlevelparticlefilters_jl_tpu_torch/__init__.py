"""lowlevelparticlefilters_jl_tpu_torch — the PyTorch/CUDA port.

The JAX package ``lowlevelparticlefilters_jl_tpu`` is the reference; this
package mirrors its layout file for file and is held against it by the
``tests/test_torch_*.py`` parity tests.  It covers the Kalman filter
(sequential and temporal-parallel), the UKF and EKF (and IEKF), the
measurement models, the shared-Riccati KF bank, the bootstrap particle
filter with the advanced and auxiliary particle filters, the scalar
noise densities, and the smoothers (RTS, MBF, the UKF/EKF backward
passes, the temporal-parallel and iterated parallel smoothers, FFBS).
On CUDA tensors ``pf.loglik``, ``mean_trajectory(pf, ...)`` and
``pf_stats_fused`` run the whole recursion as one hand-written kernel
(kernels/pf_scan.py), the ``exact_resample`` resampling runs kernel E
(kernels/resample_v2.py), a long KF
trajectory runs the associative scan kernel (kernels/assoc_scan.py),
``kf_bank_loglik`` runs the bank kernel (kernels/bank_scan.py), and the
UKF, EKF and ``KalmanFilter.loglik_fused`` run the whole-scan kernels
G, H and I (kernels/ukf_scan.py), with the user callbacks compiled in,
and the FFBS particle smoother's backward pass runs kernel J
(kernels/ffbs.py); the CUDA sources in ``csrc/`` are built with ``nvcc``
at first use.

Quick start::

    import torch
    import lowlevelparticlefilters_jl_tpu_torch as llpt

    kf = llpt.KalmanFilter(A, B, C, 0, R1, R2)
    sol = llpt.forward_trajectory(kf, u, y)
    pf = llpt.ParticleFilter(N=100_000, dynamics=f, measurement=g,
                             dynamics_density=R1, measurement_density=R2,
                             initial_density=R1)
    g = torch.Generator(device="cuda")
    ll = pf.loglik(u, y, generator=g)
    xm = llpt.mean_trajectory(pf, u, y, generator=g)   # [T, nx]
    lls = llpt.kf_bank_loglik(kf, us, ys)        # ys [B, T, ny]
    ssol = llpt.smooth(kf, u, y)                  # ssol.xT, ssol.RT
    xb, ll = pf.smooth(u, y, M=1000, generator=g)  # FFBS, [T, M, nx]
"""

from .ops.logsumexp import (
    logsumexp,
    logsumexp_normalize,
    expnormalize,
    effective_particles,
)
from .ops.linalg import blkdiag, symmetrize
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
from .filters.particle import (
    ParticleFilter,
    AdvancedParticleFilter,
    AuxiliaryParticleFilter,
    PFState,
    PFInfo,
)
from .filters.ukf import UnscentedKalmanFilter, make_ukf
from .filters.ekf import ExtendedKalmanFilter, make_ekf, make_iekf
from .models.measurement_models import (
    AbstractMeasurementModel,
    LinearMeasurementModel,
    EKFMeasurementModel,
    IEKFMeasurementModel,
    UKFMeasurementModel,
    CompositeMeasurementModel,
)
from .models.sigmapoints import (
    UTParams,
    WikiParams,
    MerweParams,
    TrivialParams,
    UKFWeights,
    ukf_weights,
    sigmapoints,
    ut_mean,
    ut_cov,
    ut_cross_cov,
)
from .kernels.pf_scan import (
    pf_loglik_fused, pf_mean_fused, pf_stats_fused, pf_segment_fused,
    pf_scan_supported)
from .kernels.resample_v2 import fused_systematic_gather
from .ops.distributions import (
    Normal,
    Uniform,
    Laplace,
    StudentT,
    Binary,
    MixtureNormal,
    TupleProduct,
)
from .kernels.ukf_scan import (
    ukf_loglik_fused, ekf_loglik_fused,
    ukf_forward_trajectory_fused, ekf_forward_trajectory_fused)
from .trajectory import (
    forward_trajectory,
    loglik,
    simulate,
    weighted_mean,
    weighted_cov,
    weighted_quantile,
    mean_trajectory,
    mode_trajectory,
)
from .utils.solutions import (KalmanFilteringSolution,
                              KalmanSmoothingSolution,
                              ParticleFilteringSolution)
from .routing import METHODS, last_route
from .filters.bank import (KFBankSolution, kf_bank_admissible,
                           kf_bank_forward, kf_bank_loglik)
from .parallel.temporal import (parallel_forward_trajectory,
                                parallel_rts_smooth, parallel_iekf_smooth,
                                parallel_ukf_smooth)
from .smoothing import (smooth, rts_smooth, smooth_mbf, ffbs_smooth,
                        smoothed_mean, smoothed_cov, smoothed_trajs)
from .parallel.bank import bank_forward_trajectory, bank_loglik

# naming aliases for users arriving from the reference package
from .filters.ekf import make_iekf as IteratedExtendedKalmanFilter  # noqa
from .filters.particle import PFState as PFstate  # noqa: N816
