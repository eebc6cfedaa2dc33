"""The damped solve above ``cuda_dba.SOLVE_MAX_P`` = 48 poses, where the
one block's shared memory no longer holds the system and the grid kernel
``dba_solve_grid`` (``csrc/dba.cu``) takes it: the backend's P is its
keyframes less one, up to the buffer's (511 at the default 512).

On the CPU:
- the kernels' emulation (``dba_solve_emul.emulate``, one order for
  both kernels) against ``pvo_tpu.geom.chol.solve_psd`` within
  ``TOL`` = 1e-5 of the largest |dx| and against the f64 solve of the
  same f32 system (its forward error at most ``FWD_FACTOR`` times the
  plain f32 solve's plus ``FWD_FLOOR``), at P = 49, 64 and 99, full and
  motion-only;
- the emulation's backward error on the backend's recorded call at 100
  keyframes (``dba_probe``'s ``backend``, P = 99) within twice the plain
  version's plus ``dba_probe.SOLVE_ETA_FLOOR``;
- ``dba.dba`` at P > 48 calls the kernels' entry (``cuda_dba.solve``),
  which takes the grid kernel there, and reaches ``solve_plain`` only
  through it (on the CPU the entry's plain version);
- the wrapper's rule of P on ``meta`` tensors (no launch): one block up
  to 48, the grid above it at any P, P < 1 refused;
- the grid's ``blocks`` cap (``cuda_dba._solve_launch``, on ``meta``
  tensors, the launch recorded): 1 to nb blocks reach the launch entry
  that takes the cap, none the one that does not; 0, nb + 1 and a cap on
  the one block are refused before any launch;
- the workspace's layout (``cuda_dba.solve_workspace``: the tiles in
  column-major order, b, the reciprocals, the failure flags, a ready
  flag a tile) at P = 49, 99 and 511 as ``csrc/dba.cu``'s ``sg_layout``
  computes it (the source holds the same totals in a ``static_assert``;
  the card tests compare its exported size).
The emulation takes 3 s at P = 99 here; P = 128 to 600 are held on the
card (``tests/test_torch_port_dba_solve.py``, ``dba_probe``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_port_dba_solve_grid.py
"""

import re

import numpy as np
import pytest
import torch

from pvo_tpu_torch.scripts import dba_probe
from pvo_tpu_torch.scripts import dba_solve_emul as emul
from pvo_tpu_torch.vo import dba as tdba
from pvo_tpu_torch.vo.net import cuda_dba

from test_torch_port_dba_solve import (FWD_FACTOR, FWD_FLOOR, TOL, case,
                                       jax_solve, rel, torch_args)
from torch_one_thread import one_thread  # noqa: F401


@pytest.mark.parametrize("full", [True, False], ids=["full", "motion"])
@pytest.mark.parametrize("P", [49, 64, 99])
def test_emulation_against_jax_and_f64(P, full):
    sys_ = case(P, full)
    emu = emul.emulate(*sys_, P)
    assert emu.dtype == np.float32 and np.isfinite(emu).all()
    assert rel(emu, jax_solve(*sys_, P)) <= TOL
    x64 = emul.solve64(*sys_, P)
    plain = cuda_dba.solve_plain(*torch_args(sys_), P).numpy()
    assert emul.forward_error(emu, x64) <= \
        FWD_FACTOR * emul.forward_error(plain, x64) + FWD_FLOOR


def test_emulation_on_the_recorded_backend_call():
    """The backend's largest call at 100 keyframes (P = 99, M = 594
    padded to 608: 19 tile columns, the last partial) lies on the grid
    kernel, and the emulation holds the plain version's backward error
    there."""
    a = dba_probe.shape_inputs("backend", "cpu", hw=(6, 10))
    H, S_sum, v, corr_v, P = dba_probe.stages(a)["solve"]
    assert P == 99 and cuda_dba.solve_kernel(P) == "dba_solve_grid"
    sys_ = tuple(t.numpy() for t in (H, S_sum, v, corr_v))
    emu = emul.emulate(*sys_, P)
    plain = cuda_dba.solve_plain(*torch_args(sys_), P).numpy()
    eta = emul.backward_error(*sys_, P, emu)
    eta_plain = emul.backward_error(*sys_, P, plain)
    assert 0 < eta <= 2 * eta_plain + dba_probe.SOLVE_ETA_FLOOR
    assert rel(emu, plain) <= 1e-2


def test_dba_calls_the_kernels_entry_above_48(monkeypatch):
    """``dba.dba`` at P = 50 (two iterations) calls ``cuda_dba.solve``
    twice at P = 50, the grid kernel's P, and ``solve_plain`` only from
    inside it; ``vo/dba.py`` names no other solve."""
    E, K = 150, 50
    a = dba_probe.inputs(E, K, 4, 6, None, "cpu")
    assert a["P"] == 50 and cuda_dba.solve_kernel(50) == "dba_solve_grid"
    calls, plain_calls, inside = [], [], [False]
    real_solve, real_plain = cuda_dba.solve, cuda_dba.solve_plain

    def solve(*args, **kw):
        calls.append(args[4])
        inside[0] = True
        try:
            return real_solve(*args, **kw)
        finally:
            inside[0] = False

    def solve_plain(*args, **kw):
        plain_calls.append(inside[0])
        return real_plain(*args, **kw)
    monkeypatch.setattr(cuda_dba, "solve", solve)
    monkeypatch.setattr(cuda_dba, "solve_plain", solve_plain)
    poses, disps = dba_probe.call_dba(a)
    assert calls == [50, 50]
    assert plain_calls == [True, True]
    assert torch.isfinite(poses).all() and torch.isfinite(disps).all()
    import inspect
    src = inspect.getsource(tdba)
    assert "cuda_dba.solve(" in src and not re.search(
        r"solve_plain|solve_library|solve_route", src)


def meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("P", [1, 48, 49, 99, 511, 600])
def test_the_wrapper_picks_the_kernel_by_P(monkeypatch, P):
    """Off the CPU (``meta`` tensors, the launch recorded instead):
    ``dba_solve`` up to ``SOLVE_MAX_P``, ``dba_solve_grid`` above it,
    beyond the default buffer too."""
    seen = []

    def launch(H, S_sum, v, corr_v, P, ep, lm, grid):
        seen.append((P, grid))
        return meta(P, 6)
    monkeypatch.setattr(cuda_dba, "_solve_launch", launch)
    dx = cuda_dba.solve(meta(P * P, 6, 6), None, meta(P, 6), None, P)
    assert tuple(dx.shape) == (P, 6)
    assert seen == [(P, P > 48)]
    assert cuda_dba.solve_kernel(P) == ("dba_solve" if P <= 48 else
                                        "dba_solve_grid")


def test_p_below_one_is_refused():
    with pytest.raises(ValueError):
        cuda_dba.solve_kernel(0)
    with pytest.raises(ValueError):
        cuda_dba._solve_launch(meta(0, 6, 6), None, meta(0, 6), None, 0,
                               0.1, 1e-4, True)
    with pytest.raises(ValueError):
        cuda_dba._solve_launch(meta(49 * 49, 6, 6), None, meta(49, 6),
                               None, 49, 0.1, 1e-4, False)


# P: (tile columns, tiles, workspace floats); the tiles 32 x 32 floats
LAYOUTS = {49: (10, 55, 57088), 99: (19, 190, 196032),
           511: (96, 4656, 4778752)}


@pytest.mark.parametrize("P", sorted(LAYOUTS))
def test_workspace_layout(P):
    """The padded lower triangle's tiles first (column-major), then b
    and the reciprocals (32 nb each), nb failure flags rounded up to 32,
    then a ready flag a tile, x's count and a flag a column, rounded up
    to 32: every offset a multiple of 32 floats. 0.78 MB at P = 99, 19.1
    MB at 511 (both within the 50 MB L2)."""
    nb, tiles, total = LAYOUTS[P]
    w = cuda_dba.solve_workspace(P)
    assert w["nb"] == nb == -(-6 * P // 32) and w["nt"] == tiles
    assert w["tiles"] == 0 and w["b"] == tiles * 1024
    assert w["rd"] == w["b"] + 32 * nb and w["bad"] == w["rd"] + 32 * nb
    assert w["flag"] == w["bad"] + -(-nb // 32) * 32
    assert w["total"] == w["flag"] + -(-(tiles + 1 + nb) // 32) * 32 \
        == total
    assert all(w[k] % 32 == 0 for k in ("b", "rd", "bad", "flag"))
    src = cuda_dba.SOURCE.read_text()
    assert f"sg_layout({P}).total == {total}" in src


class FakeLibrary:
    """The launch entries' stand-ins on ``meta`` tensors: the workspace
    size from the mirror, the entries recorded by ``_launch``."""
    pvo_dba_solve = "pvo_dba_solve"
    pvo_dba_solve_blocks = "pvo_dba_solve_blocks"

    @staticmethod
    def pvo_dba_solve_workspace(P):
        return cuda_dba.solve_workspace(P)["total"]


@pytest.mark.parametrize("P", [49, 99, 128])
def test_the_grid_cap(monkeypatch, P):
    """``_solve_launch``'s ``blocks``: 1 to nb reach the entry that takes
    the cap (its last argument), no cap the uncapped entry; 0, nb + 1,
    -1 and a cap on the one block raise before any launch."""
    nb = -(-6 * P // 32)
    seen = []
    monkeypatch.setattr(cuda_dba, "_library", lambda: FakeLibrary)
    monkeypatch.setattr(cuda_dba, "_launch",
                        lambda name, fn, dev, *a: seen.append((name, fn, a)))
    args = (meta(P * P, 6, 6), meta(P * P, 6, 6), meta(P, 6), meta(P, 6), P,
            0.1, 1e-4)
    for blocks in (1, 2, 5, nb):
        cuda_dba._solve_launch(*args, True, blocks)
        name, fn, a = seen.pop()
        assert (name, fn, a[-1], a[4]) == ("dba_solve_grid",
                                           "pvo_dba_solve_blocks", blocks, P)
    cuda_dba._solve_launch(*args, True)
    name, fn, a = seen.pop()
    assert (name, fn, len(a)) == ("dba_solve_grid", "pvo_dba_solve", 9)
    for blocks in (0, -1, nb + 1):
        with pytest.raises(ValueError, match="blocks"):
            cuda_dba._solve_launch(*args, True, blocks)
    small = (meta(16 * 16, 6, 6), None, meta(16, 6), None, 16, 0.1, 1e-4)
    with pytest.raises(ValueError, match="blocks"):
        cuda_dba._solve_launch(*small, False, 1)
    assert not seen
