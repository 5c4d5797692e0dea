"""PyTorch port: ``utils/profiling.py`` (its JAX counterpart writes a
TensorBoard trace of XLA execution, not comparable): ``trace`` writes a
Chrome trace into ``logdir`` that holds an ``annotate`` region by name,
and ``step_timer`` returns a positive float of seconds, also for a call
that returns a state dataclass."""
import json
import os

import torch
from _torch_parity import A, B, C, R1, R2

import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch import convert
from lowlevelparticlefilters_jl_tpu_torch.utils import profiling


def _case():
    kf = convert.kalman_filter_from_numpy(A, B, C, 0, R1, R2, device="cpu")
    return (kf, torch.zeros((50, 1), dtype=torch.float64),
            torch.ones((50, 2), dtype=torch.float64))


def test_trace_holds_the_region(tmp_path):
    kf, u, y = _case()
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.annotate("llpt_region"):
            llpt.loglik(kf, u, y)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "llpt_region" in names


def test_step_timer_times_a_call():
    kf, u, y = _case()
    s = profiling.step_timer(llpt.loglik, kf, u, y, repeats=3)
    assert isinstance(s, float) and s > 0
    s = profiling.step_timer(lambda: kf.predict(kf.init(), u[0]))
    assert isinstance(s, float) and s > 0
