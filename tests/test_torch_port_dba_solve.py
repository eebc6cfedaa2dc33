"""The DBA's damped solve (``cuda_dba.solve``, kernels ``dba_solve`` and
``dba_solve_grid`` in ``csrc/dba.cu``): from the summed blocks H, S_sum,
v, corr_v to dx.

On the CPU, f32 on both sides (``tests/conftest.py`` turns on x64: the
JAX inputs are cast), on block-structured PSD systems from numpy seeds
(``dba_solve_emul.system``: P poses and a fixed one, random pose and
depth Jacobians, the depth eliminated) at P = 4, 16, 32 and 40, full and
motion-only:
- ``solve_plain`` against ``pvo_tpu.geom.chol.solve_psd`` fed with the
  JAX DBA's damping (``pvo_tpu/vo/dba.py:241-247``) within 1e-5 of the
  largest |dx| (two f32 Cholesky solves of systems whose condition is
  10-100 here differ by a few 1e-7);
- the numpy emulation of the kernel's order of operations
  (``dba_solve_emul.emulate``: its 32-column tiles, the rhs riding along
  as an extra row, its fused multiply-adds rounded once) against the JAX
  solve within 1e-5 and against an f64 solve of the same f32 system: its
  forward error at most twice the plain f32 solve's plus 1e-7 ||x||; on
  a system of ``dba_probe``'s (condition about 1e5) its backward error
  within twice the plain version's plus ``dba_probe.SOLVE_ETA_FLOOR``;
- the failure cases, a negative pivot, a NaN in H and a NaN in v: dx = 0
  from ``solve_plain``, the emulation and the JAX solve;
- the one block's room (``SOLVE_MAX_P``, where the grid kernel takes
  over) and the wrapper's refusals on ``meta`` tensors.
On the card (``cuda`` marker, skipped here): the kernels against
``solve_plain`` and bit-equal to the emulation at P = 1 to 128 (one
block to 48, the grid above), full and motion-only, also on asymmetric
systems, two calls bit-equal, the grid kernel below its range equal to
the one block, the grid capped at 1, 2 and 5 blocks (a block owning
several tiles of a column and of a row) equal to the full grid and the
emulation at P = 49, 64, 99 and 128, the failure cases zeros at P = 16,
49 and 99 (on the full and the capped grid), a CUDA-graph replay of
each kernel equal to its eager call, P = 600 against the plain version,
and the workspace's size as the source computes it. ``tests/test_torch_port_dba_solve_sym.py`` holds the
symmetrization, ``tests/test_torch_port_dba_solve_grid.py`` the P above
48 on the CPU. The JAX tests import JAX inside:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_port_dba_solve.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from pvo_tpu_torch.scripts import dba_probe
from pvo_tpu_torch.scripts import dba_solve_emul as emul
from pvo_tpu_torch.vo import dba as tdba
from pvo_tpu_torch.vo.net import cuda_dba

from torch_one_thread import one_thread  # noqa: F401

SIZES = [4, 16, 32, 40]
# solve_plain and the emulation against the JAX solve, relative to the
# largest |dx|
TOL = 1e-5
# the emulation's forward error against f64: at most FWD_FACTOR times the
# plain f32 solve's plus FWD_FLOOR ||x||
FWD_FACTOR, FWD_FLOOR = 2.0, 1e-7


def case(P, full, seed=None):
    """A system of P poses (numpy f32): (H, S_sum, v, corr_v), the last
    two None for a motion-only iteration."""
    H, S_sum, v, corr_v = emul.system(P, P if seed is None else seed)
    return (H, S_sum, v, corr_v) if full else (H, None, v, None)


def torch_args(sys_, device="cpu"):
    return tuple(None if a is None else torch.from_numpy(a).to(device)
                 for a in sys_)


def jax_solve(H, S_sum, v, corr_v, P, ep=0.1, lm=1e-4):
    """The JAX DBA's damped solve (pvo_tpu/vo/dba.py:241-247) on the same
    f32 blocks."""
    import jax.numpy as jnp
    from pvo_tpu.geom.chol import solve_psd
    S = jnp.asarray(H, jnp.float32)
    if S_sum is not None:
        S = S - jnp.asarray(S_sum, jnp.float32)
    b = jnp.asarray(v, jnp.float32)
    if corr_v is not None:
        b = b - jnp.asarray(corr_v, jnp.float32)
    Sd = jnp.transpose(S.reshape(P, P, 6, 6), (0, 2, 1, 3)).reshape(
        P * 6, P * 6)
    diag = jnp.diagonal(Sd)
    Sd = Sd + jnp.diag(jnp.float32(ep) + jnp.float32(lm) * diag)
    assert Sd.dtype == jnp.float32
    dx = solve_psd(Sd[None], b.reshape(1, P * 6, 1))
    return np.asarray(dx, np.float32).reshape(P, 6)


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() /
                 np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("full", [True, False], ids=["full", "motion"])
@pytest.mark.parametrize("P", SIZES)
def test_plain_matches_jax(P, full):
    sys_ = case(P, full)
    dx = cuda_dba.solve_plain(*torch_args(sys_), P).numpy()
    assert dx.dtype == np.float32 and dx.shape == (P, 6)
    assert rel(dx, jax_solve(*sys_, P)) <= TOL
    # the wrapper on the CPU is the plain version
    assert np.array_equal(cuda_dba.solve(*torch_args(sys_), P).numpy(), dx)


@pytest.mark.parametrize("full", [True, False], ids=["full", "motion"])
@pytest.mark.parametrize("P", SIZES)
def test_emulation_against_jax_and_f64(P, full):
    sys_ = case(P, full)
    emu = emul.emulate(*sys_, P)
    assert emu.dtype == np.float32 and np.isfinite(emu).all()
    assert rel(emu, jax_solve(*sys_, P)) <= TOL
    x64 = emul.solve64(*sys_, P)
    plain = cuda_dba.solve_plain(*torch_args(sys_), P).numpy()
    assert emul.forward_error(emu, x64) <= \
        FWD_FACTOR * emul.forward_error(plain, x64) + FWD_FLOOR


def probe_system(E, K, h, w, seed=0):
    """The summed blocks of one plain DBA iteration on ``dba_probe``'s
    inputs (numpy f32) and P."""
    st = dba_probe.stages(dba_probe.inputs(E, K, h, w, None, "cpu", seed))
    H, S_sum, v, corr_v, P = st["solve"]
    return tuple(t.numpy() for t in (H, S_sum, v, corr_v)), P


@pytest.mark.parametrize("shape", [(48, 16, 6, 10), (144, 32, 6, 10)])
def test_emulation_backward_error_on_a_tracker_system(shape):
    """A real DBA system (condition about 1e5: the forward errors of two
    f32 solves differ there by chance factors of 0.4-3) holds the
    emulation to the plain version's backward error instead."""
    sys_, P = probe_system(*shape)
    emu = emul.emulate(*sys_, P)
    plain = cuda_dba.solve_plain(*torch_args(sys_), P).numpy()
    eta = emul.backward_error(*sys_, P, emu)
    eta_plain = emul.backward_error(*sys_, P, plain)
    assert 0 < eta <= 2 * eta_plain + dba_probe.SOLVE_ETA_FLOOR
    assert rel(emu, plain) <= 1e-2


def test_emulation_on_the_recorded_backend40_call():
    """The backend's recorded call at 40 keyframes (``dba_probe``'s
    ``backend40``, the P that ``chip_smoke.py``'s main path gives the
    solve: 39, M = 234 padded to 256, eight tiles and a partial last one)
    lies on the one block's range, and the emulation of the kernel's order
    holds the plain version's backward error there."""
    a = dba_probe.shape_inputs("backend40", "cpu", hw=(6, 10))
    H, S_sum, v, corr_v, P = dba_probe.stages(a)["solve"]
    assert P == 39 and cuda_dba.solve_kernel(P) == "dba_solve"
    sys_ = tuple(t.numpy() for t in (H, S_sum, v, corr_v))
    emu = emul.emulate(*sys_, P)
    plain = cuda_dba.solve_plain(*torch_args(sys_), P).numpy()
    eta = emul.backward_error(*sys_, P, emu)
    eta_plain = emul.backward_error(*sys_, P, plain)
    assert 0 < eta <= 2 * eta_plain + dba_probe.SOLVE_ETA_FLOOR
    assert rel(emu, plain) <= 1e-2


def broken(kind, P=16):
    """A system whose solve fails: a negative pivot (the first diagonal
    entry of pose 3's block), a NaN in H's lower triangle, a NaN in v."""
    H, S_sum, v, corr_v = (None if a is None else a.copy()
                           for a in case(P, True))
    if kind == "negative_pivot":
        H[3 * P + 3, 0, 0] = -1e6
    elif kind == "nan_H":
        H[5 * P + 2, 4, 1] = np.nan
    else:
        v[7, 2] = np.nan
    return H, S_sum, v, corr_v


@pytest.mark.parametrize("kind", ["negative_pivot", "nan_H", "nan_v"])
def test_failures_give_zeros(kind):
    P = 16
    sys_ = broken(kind, P)
    for dx in (cuda_dba.solve_plain(*torch_args(sys_), P).numpy(),
               emul.emulate(*sys_, P), jax_solve(*sys_, P)):
        assert dx.shape == (P, 6) and not dx.any()


def test_solve_max_p_is_the_largest_that_fits_a_block():
    """The one block's largest P, where the grid kernel takes over:
    192,384 bytes at P = 48 (M = 288: 45 tiles of 32 x 33 floats, b and
    the pivots' reciprocals), 234,880 at 49, against 232,448 a block."""
    def smem(P):
        nb = -(-6 * P // 32)
        return (nb * (nb + 1) // 2 * 32 * 33 + 2 * nb * 32) * 4
    assert smem(cuda_dba.SOLVE_MAX_P) == 192384 <= 232448
    assert smem(cuda_dba.SOLVE_MAX_P + 1) == 234880 > 232448
    assert cuda_dba.SOLVE_MAX_P >= 40


def meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def test_wrapper_refusals_off_the_cpu():
    """On ``meta`` tensors (the checks without a card): grad, a shape that
    is not P's, S_sum without corr_v and P < 1 raise before any launch."""
    P = 4
    blocks, vec = meta(P * P, 6, 6), meta(P, 6)
    before = dict(cuda_dba.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        cuda_dba.solve(blocks.requires_grad_(), None, vec, None, P)
    blocks = blocks.detach()
    with pytest.raises(ValueError):
        cuda_dba.solve(blocks, None, meta(P + 1, 6), None, P)
    with pytest.raises(ValueError):
        cuda_dba.solve(blocks, blocks, vec, None, P)
    with pytest.raises(ValueError):
        cuda_dba.solve(meta(0, 6, 6), None, meta(0, 6), None, 0)
    assert cuda_dba.LAUNCHES == before


# ------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


# the one block's P and the grid kernel's, up to the emulation's reach on
# the card (dba_probe.EMUL_MAX_P)
CARD_SIZES = [1, 4, 16, 32, 40, 48, 49, 64, 99, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("full", [True, False], ids=["full", "motion"])
@pytest.mark.parametrize("P", CARD_SIZES)
def test_kernel_against_plain_and_emulation(dev, P, full):
    sys_ = case(P, full)
    args = torch_args(sys_, dev)
    name = cuda_dba.solve_kernel(P)
    n0 = cuda_dba.LAUNCHES[name]
    dx = cuda_dba.solve(*args, P)
    again = cuda_dba.solve(*args, P)
    assert cuda_dba.LAUNCHES[name] == n0 + 2
    plain = cuda_dba.solve_plain(*args, P)
    assert rel(dx.cpu(), plain.cpu()) <= TOL
    assert torch.equal(dx, again)
    assert np.array_equal(dx.cpu().numpy(), emul.emulate(*sys_, P))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [16, 40, 49, 99])
def test_kernel_symmetrizes_as_the_emulation(dev, P):
    """On a system whose H is not symmetric (``emul.asymmetric``) the
    kernel factors (Sd + Sd^T) / 2 as the emulation does, bit for bit,
    and agrees with the plain version."""
    H, S_sum, v, corr_v = case(P, True)
    sys_ = (emul.asymmetric(H, 1000 + P), S_sum, v, corr_v)
    args = torch_args(sys_, dev)
    dx = cuda_dba.solve(*args, P)
    assert rel(dx.cpu(), cuda_dba.solve_plain(*args, P).cpu()) <= TOL
    assert np.array_equal(dx.cpu().numpy(), emul.emulate(*sys_, P))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 5, 32, 48])
def test_grid_kernel_equals_the_one_block(dev, P):
    """The grid kernel launched below its range gives the one block's dx
    bit for bit: the same operations in the same order."""
    args = torch_args(case(P, True), dev)
    one = cuda_dba._solve_launch(*args, P, 0.1, 1e-4, False)
    grid = cuda_dba._solve_launch(*args, P, 0.1, 1e-4, True)
    assert torch.equal(one, grid)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [16, 49, 99])
@pytest.mark.parametrize("kind", ["negative_pivot", "nan_H", "nan_v"])
def test_kernel_failures_give_zeros(dev, kind, P):
    dx = cuda_dba.solve(*torch_args(broken(kind, P), dev), P)
    assert not dx.cpu().numpy().any()


@pytest.mark.cuda
def test_kernel_beyond_the_default_buffer(dev):
    """P = 600 (a buffer of 601 keyframes, above the default 512) runs on
    the grid kernel, within ``TOL`` of the plain version, twice bit-equal."""
    P = 600
    args = torch_args(case(P, True), dev)
    n0 = cuda_dba.LAUNCHES["dba_solve_grid"]
    dx, again = cuda_dba.solve(*args, P), cuda_dba.solve(*args, P)
    assert cuda_dba.LAUNCHES["dba_solve_grid"] == n0 + 2
    assert rel(dx.cpu(), cuda_dba.solve_plain(*args, P).cpu()) <= TOL
    assert torch.equal(dx, again)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 49, 99, 511])
def test_workspace_size_is_the_sources(dev, P):
    lib = cuda_dba._library()
    assert lib.pvo_dba_solve_workspace(P) == \
        cuda_dba.solve_workspace(P)["total"]


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 2, 5])
@pytest.mark.parametrize("P", [49, 64, 99, 128])
def test_capped_grid_equals_the_full_grid(dev, P, blocks):
    """The grid kernel on ``blocks`` blocks (each owning several tiles
    of a column and of a row) gives the full grid's dx and the
    emulation's bit for bit, on an asymmetric system too."""
    H, S_sum, v, corr_v = case(P, True)
    for sys_ in ((H, S_sum, v, corr_v),
                 (emul.asymmetric(H, 2000 + P), S_sum, v, corr_v)):
        args = torch_args(sys_, dev)
        full = cuda_dba.solve(*args, P)
        capped = cuda_dba._solve_launch(*args, P, 0.1, 1e-4, True, blocks)
        assert torch.equal(capped, full)
        assert np.array_equal(capped.cpu().numpy(), emul.emulate(*sys_, P))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [16, 49, 99])
@pytest.mark.parametrize("kind", ["negative_pivot", "nan_H", "nan_v"])
def test_capped_grid_failures_give_zeros(dev, kind, P):
    args = torch_args(broken(kind, P), dev)
    for blocks in (1, 2):
        dx = cuda_dba._solve_launch(*args, P, 0.1, 1e-4, True, blocks)
        assert not dx.cpu().numpy().any()


@pytest.mark.cuda
@pytest.mark.parametrize("P", [32, 99, 511])
def test_replay_equals_eager(dev, P):
    """A launch captured in a CUDA graph (the flags zeroed in the
    launch) replays to the eager call's dx, twice."""
    args = torch_args(case(P, True), dev)
    eager = cuda_dba.solve(*args, P)
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        cuda_dba.solve(*args, P)
        with torch.cuda.graph(g, stream=s):
            out = cuda_dba.solve(*args, P)
    torch.cuda.current_stream().wait_stream(s)
    for _ in range(2):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
