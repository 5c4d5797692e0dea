"""PyTorch port: the callback code generator of kernels G and I
(kernels/callback_codegen.py).

The callbacks of the three main paths — the quadtank dynamics, the
nonlinear ``A x + 0.01 sin x``, the CV model with ``B u`` — and the
angle-wrap hooks are lowered to the scalar program the kernels compile;
the program and its value-and-Jacobian program (differentiated at code
generation, the form kernel I compiles), evaluated in Python, must give
the callback's value and its ``torch.func.jacfwd`` Jacobian (float64,
1e-6).  The C++ the program prints is compiled and run only on the card
(tests/test_torch_cuda.py)."""
import math

import pytest
import torch

import lowlevelparticlefilters_jl_tpu_torch as llpt
from lowlevelparticlefilters_jl_tpu_torch.kernels import callback_codegen as cg
from lowlevelparticlefilters_jl_tpu_torch.kernels import ukf_scan

F64 = torch.float64
DT = 0.1
A = torch.tensor([[1, 0, DT, 0], [0, 1, 0, DT], [0, 0, 1, 0], [0, 0, 0, 1]],
                 dtype=F64)
B = torch.tensor([[0, 0], [0, 0], [DT, 0], [0, DT]], dtype=F64)


def _g1(x):
    return torch.sqrt(torch.abs(x) + 0.1)


def _wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


CASES = {
    "quadtank": (lambda x, u, t: x + 0.1 * torch.stack(
        [-_g1(x[0]) + 0.5 * _g1(x[1]), -0.5 * _g1(x[1]) + 0.1]), 2, 0),
    "nonlinear_cv": (lambda x, u, t: A @ x + 0.01 * torch.sin(x), 4, 0),
    "cv_with_input": (lambda x, u, t: A @ x + B @ u, 4, 2),
    "angle_dynamics": (lambda x, u, t: torch.stack(
        [_wrap(x[0] + 0.1 * x[1]), 0.98 * x[1]]), 2, 0),
    "admitted_mix": (lambda x, u, t: torch.atan2(x, x + 3.0)
                     + torch.clamp(x, -0.5, 0.5) * (1 + 0.01 * t)
                     + torch.where(x > 0, x ** 3, torch.exp(x)).sum()
                     + torch.maximum(x, 0.5 * x) / (2 + x.abs()), 3, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_lowered_callback_matches_torch_and_jacfwd(case):
    fn, nx, nu = CASES[case]
    g = torch.Generator().manual_seed(len(case))
    args = (torch.randn(nx, generator=g, dtype=F64),
            0.3 * torch.randn(nu, generator=g, dtype=F64),
            torch.tensor(1.7, dtype=F64))
    prog = cg.lower(fn, args, "Sff", "cb_f")
    val, jac = prog.value_and_jacobian(*args)
    torch.testing.assert_close(val, fn(*args), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        jac, torch.func.jacfwd(fn)(*args), rtol=1e-6, atol=1e-6)
    src = prog.cpp()
    assert src.startswith("__device__ __forceinline__ void cb_f(")
    assert src.count("out[") == nx
    # the value-and-Jacobian program that kernel I compiles: value, then
    # the Jacobian row-major; a sine and a cosine of one operand print as
    # one sincosf
    vj = prog.jacobian(name="cb_fvj")
    flat = vj.evaluate([a.reshape(-1).tolist() for a in args],
                       [v for c in prog.consts
                        for v in c.double().reshape(-1).tolist()])
    torch.testing.assert_close(torch.tensor(flat, dtype=F64), torch.cat(
        [fn(*args), torch.func.jacfwd(fn)(*args).reshape(-1)]),
        rtol=1e-6, atol=1e-6)
    cpp = vj.cpp()
    assert cpp.count("out[") == nx + nx * nx
    if case == "nonlinear_cv":
        assert cpp.count("m_sincos(") == nx
        assert "m_sin(" not in cpp and "m_cos(" not in cpp


AFFINE = {
    "cv_with_input": (True, CASES["cv_with_input"][0]),
    "input_and_time_coefficients": (True, lambda x, u, t: (1 + t) * x
                                    + u.sum() * x / (2 + u[0] ** 2)
                                    - u.sum()),
    "constant_mask": (True, lambda x, u, t: torch.where(u[0] > 0, x, -x)),
    "clamp": (False, lambda x, u, t: torch.clamp(x, -5.0, 5.0)),
    "piecewise": (False, lambda x, u, t: torch.where(x.abs() > 3, 0.5 * x,
                                                     x)),
    "quadratic": (False, lambda x, u, t: x * x[0]),
    "divide_by_x": (False, lambda x, u, t: 1.0 / (x + 3.0)),
    "nonlinear_cv": (False, CASES["nonlinear_cv"][0]),
}


@pytest.mark.parametrize("case", list(AFFINE))
def test_static_affinity_walk(case):
    """``affine_in`` (the JAX package's jaxpr walk) admits callbacks that
    are affine in x whatever u and t, and refuses ones that are affine
    near the probe states only, such as a clamp at 5 or a branch at
    |x| > 3."""
    want, fn = AFFINE[case]
    prog = cg.lower(fn, (torch.zeros(4, dtype=F64), torch.zeros(
        2, dtype=F64), torch.tensor(0.0, dtype=F64)), "Sff", "cb_f")
    assert cg.affine_in(prog) is want


def test_hooks_and_constants():
    """The angle-wrap innovation and a weighted state mean (a tensor
    constant built inside the hook is hoisted into the constants)."""
    inn = cg.lower(lambda y, yh: _wrap(y - yh),
                   (torch.zeros(1, dtype=F64),) * 2, "ff", "cb_inn")
    for y, yh in ((3.0, -3.0), (-3.1, 3.1), (0.2, 0.1)):
        a = torch.tensor([y], dtype=F64)
        b = torch.tensor([yh], dtype=F64)
        v, _ = inn.value_and_jacobian(a, b)
        torch.testing.assert_close(v, _wrap(a - b), rtol=1e-6, atol=1e-6)
    w = torch.tensor([0.2, 0.1, 0.3, 0.25, 0.15], dtype=F64)

    def smean(xs):
        return torch.stack([_wrap((w * xs[:, 0]).sum()),
                            (w * xs[:, 1]).sum()])

    xs = torch.randn(5, 2, generator=torch.Generator().manual_seed(0),
                     dtype=F64)
    prog = cg.lower(smean, (xs,), "S", "cb_smean")
    assert prog.n_consts == 5 and prog.consts[0] is w
    val, jac = prog.value_and_jacobian(xs)
    torch.testing.assert_close(val, smean(xs), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(jac, torch.func.jacfwd(smean)(xs).reshape(
        2, 10), rtol=1e-6, atol=1e-6)
    assert "c[3]" in prog.cpp(const_base=1)


def test_op_outside_the_admitted_list_routes_sequential():
    """A callback with an op the generator does not lower (here a vector
    norm) is not admitted: the fused verbs take the sequential route, as
    the JAX package's ``_supported`` → False does."""
    A32 = A.float()

    def dyn(x, u, p, t):
        return A32 @ x + 0.01 * torch.linalg.vector_norm(x) * x

    ukf = llpt.make_ukf(dyn, lambda x, u, p, t: x[:2], 0.1 * torch.eye(4),
                        torch.eye(2), ny=2, nu=0)
    ys = torch.randn(12, 2, generator=torch.Generator().manual_seed(1))
    assert ukf_scan._ukf_programs(ukf, 0, torch.device("cpu")) is None
    ll = llpt.ukf_loglik_fused(ukf, ys, force_kernel=True)
    assert llpt.last_route() == "sequential"
    torch.testing.assert_close(ll, llpt.loglik(ukf, None, ys,
                                               method="sequential"))
    ekf = llpt.make_ekf(dyn, lambda x, u, p, t: x[:2], 0.1 * torch.eye(4),
                        torch.eye(2), ny=2, nu=0)
    llpt.loglik(ekf, None, ys, method="fused")
    assert llpt.last_route() == "sequential"
    assert "vector_norm" in str(pytest.raises(
        cg.CodegenError, cg.lower, lambda x: torch.linalg.vector_norm(x),
        (torch.zeros(3),), "S", "cb").value)


def test_ekf_source_keeps_constants_out_of_the_step_loop():
    """Kernel I's generated source for the benchmark's EKF (``A x + 0.01
    sin x``, ``C x``): the value-and-Jacobian callbacks read the 24
    constants from the copy the kernel loads into registers before the
    step loop (``LLPF_NC`` <= 64), never from the device pointer ``c``
    inside it; the Jacobian of ``C x`` costs no instruction, and the four
    sine/cosine pairs print as ``sincosf``."""
    import re
    from pathlib import Path

    A32, C32 = A.float(), torch.eye(2, 4)
    ekf = llpt.make_ekf(lambda x, u, p, t: A32 @ x + 0.01 * torch.sin(x),
                        lambda x, u, p, t: C32 @ x, 0.1 * torch.eye(4),
                        torch.eye(2), ny=2, nu=0)
    comp = ukf_scan._ekf_programs(ekf, 0, torch.device("cpu"))
    src = comp.source()
    assert [n for n, _ in comp.progs] == ["cb_fvj", "cb_gvj"]
    assert "#define LLPF_NC 24\n" in src and src.count("m_sincos(") == 4
    g = cg.lower(lambda x, u, t: C32 @ x, (torch.zeros(4), torch.zeros(0),
                                           torch.tensor(0.0)), "Sff", "g")
    assert len(comp.progs[1][1].instrs) == len(g.instrs)
    cuh = (Path(ukf_scan.__file__).parent.parent / "csrc"
           / "ukf_scan.cuh").read_text()
    kernel = cuh[cuh.index("ekf_scan_kernel("):cuh.index("int launch_ekf(")]
    loop = kernel[kernel.index("for (int s = 0; s < tc; ++s)"):]
    assert "cb_gvj(x, u, &tk, cs, gv)" in loop
    assert "cb_fvj(x, u, &tk, cs, fv)" in loop
    assert re.search(r"\bc\[", loop) is None
    assert re.search(r"cs\[k\] = c\[k\]", kernel[:kernel.index(
        "for (int s = 0; s < tc; ++s)")])


def test_user_jacobian_program_concatenates():
    """With the user's Jacobian, kernel I's ``cb_fvj`` is the dynamics and
    the Jacobian callback one after another, their constants offset: its
    outputs are ``[f(x), Ajac(x)]``."""
    A32 = A.float()
    ekf = llpt.make_ekf(
        lambda x, u, p, t: A32 @ x + 0.01 * torch.sin(x),
        lambda x, u, p, t: x[:2], 0.1 * torch.eye(4), torch.eye(2),
        ny=2, nu=0, Ajac=lambda x, u, p, t: A32 + 0.01 * torch.diag(
            torch.cos(x)))
    (_, fvj), _ = ukf_scan._ekf_programs(ekf, 0, torch.device("cpu")).progs
    x = torch.tensor([0.3, -1.2, 2.0, 0.7])
    got = fvj.evaluate([x.tolist(), [], [0.0]], fvj.const_buffer().tolist())
    want = torch.cat([A32 @ x + 0.01 * torch.sin(x),
                      (A32 + 0.01 * torch.diag(torch.cos(x))).reshape(-1)])
    torch.testing.assert_close(torch.tensor(got, dtype=torch.float32), want,
                               rtol=1e-6, atol=1e-6)
    assert fvj.n_consts == 32 and "m_sincos(" in fvj.cpp()
