"""The damped solve factors the symmetrized system, as the JAX package's
does: ``jnp.linalg.cholesky`` symmetrizes its input ((Sd + Sd^T) / 2,
``symmetrize_input``), and the DBA's systems are not quite symmetric
(it sums the blocks (p, q) and (q, p) apart).

On the CPU, f32 on both sides (``tests/conftest.py`` turns on x64: the
JAX inputs are cast):
- (a) systems of ``dba_solve_emul.system`` whose H is perturbed by
  1e-3 of its largest magnitude in every entry (``emul.asymmetric``), at
  P = 4, 16, 32 and 40, full and motion-only: ``solve_plain`` and the
  kernels' emulation against ``pvo_tpu.geom.chol.solve_psd`` fed with
  the JAX DBA's damping, within ``TOL`` = 1e-5 of the largest |dx| (a
  solve of the lower triangle alone misses by 0.5-6%);
- (b) the solve systems of ``dba_probe.stages`` at ``bench_dba``'s and
  the planner's shapes (the probe's default inputs, seed 0):
  ``solve_plain`` against the JAX solve within ``PROBE_TOL``. These
  systems' condition is about 1e5, so two f32 solves of one matrix part
  by some 1e-4 of |dx| by chance; the bounds lie between the gaps of
  the symmetrized solve (2.8e-4 and 8.5e-5) and of the lower triangle
  alone (1.17e-3 and 2.8e-4) on these inputs;
- (c) ``geom.chol.solve_psd``'s gradients on an asymmetric H against
  ``jax.vjp`` of the JAX ``solve_psd`` within 1e-5 (the backward, as
  JAX's custom VJP, does not see the symmetrization).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_dba_solve_sym.py
"""

import numpy as np
import pytest
import torch

from pvo_tpu_torch.geom import chol
from pvo_tpu_torch.scripts import dba_probe
from pvo_tpu_torch.scripts import dba_solve_emul as emul
from pvo_tpu_torch.vo.net import cuda_dba

from test_torch_port_dba_solve import jax_solve, rel, torch_args
from torch_one_thread import one_thread  # noqa: F401

SIZES = [4, 16, 32, 40]
TOL = 1e-5
# (b): solve_plain against the JAX solve at dba_probe's inputs
PROBE_TOL = {"bench_dba": 5e-4, "planner": 1.5e-4}


def asymmetric_case(P, full):
    """``emul.system(P, P)`` with H perturbed (seed 1000 + P)."""
    H, S_sum, v, corr_v = emul.system(P, P)
    H = emul.asymmetric(H, 1000 + P)
    return (H, S_sum, v, corr_v) if full else (H, None, v, None)


def test_the_perturbation_breaks_the_symmetry():
    H, S_sum, v, corr_v = asymmetric_case(16, True)
    Sd = cuda_dba.damped(*torch_args((H, S_sum)), 16).numpy()
    assert np.abs(Sd - Sd.T).max() > 1e-4 * np.abs(Sd).max()
    sym = emul.damped(H, S_sum, 16)
    assert np.array_equal(sym, sym.T)


@pytest.mark.parametrize("solver", ["plain", "emulation"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "motion"])
@pytest.mark.parametrize("P", SIZES)
def test_asymmetric_systems_match_jax(P, full, solver):
    sys_ = asymmetric_case(P, full)
    if solver == "plain":
        dx = cuda_dba.solve_plain(*torch_args(sys_), P).numpy()
    else:
        dx = emul.emulate(*sys_, P)
    assert dx.shape == (P, 6) and np.isfinite(dx).all()
    assert rel(dx, jax_solve(*sys_, P)) <= TOL


@pytest.mark.parametrize("shape", sorted(PROBE_TOL))
def test_probe_systems_match_jax(shape):
    a = dba_probe.shape_inputs(shape, "cpu")
    H, S_sum, v, corr_v, P = dba_probe.stages(a)["solve"]
    Sd = cuda_dba.damped(H, S_sum, P)
    assert float((Sd - Sd.T).abs().max()) > 0  # the DBA's own asymmetry
    dx = cuda_dba.solve_plain(H, S_sum, v, corr_v, P).numpy()
    want = jax_solve(*(t.numpy() for t in (H, S_sum, v, corr_v)), P)
    assert rel(dx, want) <= PROBE_TOL[shape]


@pytest.mark.parametrize("K", [1, 3])
def test_gradient_matches_jax_vjp(K):
    """dH = -x dz^T and db = dz with dz = (L L^T)^-1 g, L the factor of
    the symmetrized H: within 1e-5 of the largest magnitude of each."""
    import jax
    import jax.numpy as jnp
    from pvo_tpu.geom.chol import solve_psd as jax_solve_psd
    P = 8
    H, S_sum, v, corr_v = asymmetric_case(P, True)
    Sd = emul.damped(H, S_sum, P)  # symmetric; perturb it once more
    rng = np.random.RandomState(7)
    Hm = (Sd + 1e-3 * np.abs(Sd).max() *
          rng.uniform(-1, 1, Sd.shape)).astype(np.float32)[None]
    b = rng.standard_normal((1, 6 * P, K)).astype(np.float32)
    g = rng.standard_normal((1, 6 * P, K)).astype(np.float32)

    Ht = torch.from_numpy(Hm).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    x = chol.solve_psd(Ht, bt)
    x.backward(torch.from_numpy(g))

    xj, vjp = jax.vjp(jax_solve_psd, jnp.asarray(Hm, jnp.float32),
                      jnp.asarray(b, jnp.float32))
    dH, db = vjp(jnp.asarray(g, jnp.float32))
    assert rel(x.detach().numpy(), np.asarray(xj, np.float32)) <= TOL
    assert rel(Ht.grad.numpy(), np.asarray(dH, np.float32)) <= TOL
    assert rel(bt.grad.numpy(), np.asarray(db, np.float32)) <= TOL


# ------------------------------------------------------------ the card

@pytest.mark.cuda
def test_the_card_solves_the_dba_systems_as_the_emulation():
    """On the card: the kernel at ``dba_probe``'s planner shape (the
    DBA's own asymmetric system) equals the symmetrized emulation bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    a = dba_probe.shape_inputs("planner", torch.device("cuda"))
    H, S_sum, v, corr_v, P = dba_probe.stages(a)["solve"]
    dx = cuda_dba.solve(H, S_sum, v, corr_v, P).cpu().numpy()
    host = [t.cpu().numpy() for t in (H, S_sum, v, corr_v)]
    assert np.array_equal(dx, emul.emulate(*host, P))
