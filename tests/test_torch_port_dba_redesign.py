"""The arithmetic of the DBA's redesigned kernels (``csrc/dba.cu``), emulated
in f32 torch on the CPU and held against the plain versions and the JAX
package before the card sees it.

- ``dba_linearize`` keeps 27 sums a pixel (Hjj's upper triangle and vj)
  and forms the rest once an edge from Adj(Gij): Hii = Adj^T Hjj Adj,
  Hij = -Adj^T Hjj, Hji = -Hjj Adj, vi = -Adj^T vj, and a pixel's Ei =
  -Adj^T Ej. :func:`linearize_27` does that arithmetic; it must match
  ``cuda_dba.linearize_plain`` and ``pvo_tpu.geom.ba._edge_blocks``
  within ``dba_probe.TOL`` of each output's largest magnitude, at the
  4x6 and 6x10 scenes and at ``dba_probe.inputs``' planner shape.
- ``dba_schur`` forms one weighted Gram per depth frame: the group of a
  frame is its edges in edge order, the edges some valid slot pairs are
  marked, the rows [self; group] are cut into tiles of ``SC_TB``
  six-row blocks and only the needed blocks are summed; the rows (a),
  (b), their transposes and rc come from the self row of blocks, the
  pair slots from the marked blocks, zeros for an invalid slot or one
  whose edges' frames differ. :func:`gram_emulation` does that walk;
  it must match ``cuda_dba.schur_plain`` (and the JAX contractions)
  including invalid slots, invalid edges, the backend's recorded call
  (``dba_probe.BACKEND_CALL``: K = 100 depth frames) and the ``crowded``
  shape's groups of about 30 edges, which span several row tiles.
- The library yardstick's rows (``dba_probe.gram_operands`` /
  ``gram_rows``, one bmm of every frame's Gram) equal ``schur_plain``'s.
- ``dba_probe``'s ``backend`` and ``backend40`` shapes are the recorded
  calls (at 100 and 40 keyframes): their edges, windows and pair slots
  are those the backend's graph builder and ``FactorGraph._update``
  make.

The kernel builds its groups itself from ``m_c`` in shared memory, so
``vo/dba.py`` builds no new index lists.
"""

import functools
from collections import Counter

import numpy as np
import pytest
import torch

from pvo_tpu_torch.geom import projective
from pvo_tpu_torch.lie import se3
from pvo_tpu_torch.scripts import dba_probe
from pvo_tpu_torch.vo import dba as tdba
from pvo_tpu_torch.vo.net import cuda_dba

from test_torch_port_dba_kernels import SCENES, depth_terms, scene, torch_args
from torch_one_thread import one_thread  # noqa: F401

TOL = dba_probe.TOL
SC_TB = 16  # dba.cu's six-row blocks a row tile


def within(got, want):
    assert got.shape == want.shape
    assert dba_probe.rel_err(got, want) <= TOL, dba_probe.rel_err(got, want)


# ------------------------------------------------------ the linearization

def linearize_27(poses, disps, intr, target, weight, ii, jj, valid):
    """The kernel's arithmetic in f32: Hjj and vj summed over the pixels,
    the rest from Adj(Gij)."""
    F = poses.shape[0]
    E = target.shape[0]
    HW = disps[0].numel()
    _, vis, _, Jj, Jz = projective.projective_jacobian_planes(
        poses[None], disps[None], intr.expand(1, F, 4), ii, jj)
    coords, _ = projective.projective_transform(
        poses[None], disps[None], intr.expand(1, F, 4), ii, jj)
    r = torch.movedim((target - coords[0]).reshape(E, HW, 2), -1, 1)
    w = 0.001 * torch.movedim((vis[0] * weight).reshape(E, HW, 2), -1, 1)
    Jj, Jz = Jj[0], Jz[0]                      # (E,2,6,HW), (E,2,HW)
    wJ = w[:, :, None] * Jj
    Hjj = torch.einsum("edh,ekh->edk", wJ[:, 0], Jj[:, 0]) + \
        torch.einsum("edh,ekh->edk", wJ[:, 1], Jj[:, 1])
    vj = torch.einsum("ecdh,ech->ed", wJ, r)
    Ej = torch.einsum("ecdh,ech->edh", wJ, Jz)
    Gij = se3.mul(poses[jj], se3.inv(poses[ii]))
    Adj = se3.adj_matrix(Gij)                  # (E,6,6), Ji = -Jj Adj
    T = Hjj @ Adj
    AdjT = Adj.transpose(1, 2)
    Hblk = torch.cat([torch.cat([AdjT @ T, -T.transpose(1, 2)], 2),
                      torch.cat([-T, Hjj], 2)], 1)
    vblk = torch.cat([-(AdjT @ vj[..., None])[..., 0], vj], 1)
    Ei = -torch.einsum("ekd,ekh->edh", Adj, Ej)
    Ck = torch.sum(w * Jz * Jz, dim=1)
    wk = torch.sum(w * r * Jz, dim=1)
    m = valid.float()
    return (Hblk * m[:, None, None], vblk * m[:, None],
            Ei * m[:, None, None], Ej * m[:, None, None], Ck * m[:, None],
            wk * m[:, None])


def probe_linearize_args(name):
    return dba_probe.stages(dba_probe.shape_inputs(name, "cpu"))["linearize"]


@pytest.mark.parametrize("hw", SCENES + ["planner", "odd_hw"])
def test_linearize_27_sums_match_the_plain_version(hw):
    if isinstance(hw, str):
        args = probe_linearize_args(hw)
    else:
        T = torch_args(scene(*hw))
        args = (*T[:5], T[6], T[7], T[8])
    got = linearize_27(*args)
    want = cuda_dba.linearize_plain(*args)
    for g, wnt in zip(got, want):
        within(g, wnt)


@pytest.mark.parametrize("hw", SCENES + ["planner"])
def test_linearize_27_sums_match_the_jax_edge_blocks(hw):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from pvo_tpu.geom.ba import _edge_blocks
    if hw == "planner":
        args = probe_linearize_args(hw)
    else:
        T = torch_args(scene(*hw))
        args = (*T[:5], T[6], T[7], T[8])
    poses, disps, intr, target, weight, ii, jj, valid = args
    F = poses.shape[0]
    want = _edge_blocks(
        jnp.asarray(target.numpy())[None], jnp.asarray(weight.numpy())[None],
        jnp.asarray(poses.numpy())[None], jnp.asarray(disps.numpy())[None],
        jnp.broadcast_to(jnp.asarray(intr.numpy()), (1, F, 4)),
        ii.numpy(), jj.numpy())
    vm = valid.numpy().astype(np.float32)
    for g, wnt in zip(linearize_27(*args), want):
        wnt = np.asarray(wnt[0]) * vm.reshape((-1,) + (1,) * (wnt.ndim - 2))
        within(g, torch.from_numpy(wnt))


# ---------------------------------------------------------- the Schur terms

def gram_emulation(Ei_m, Ej, C, eta, w_m, m_c, pairs_a, pairs_b, pairs_valid,
                   tb=SC_TB):
    """dba_schur's walk: per depth frame its group, the marked edges, the
    tile pairs and their needed blocks, the rows written from them.
    Unwritten rows stay NaN."""
    K, _, HW = Ei_m.shape
    E, NP = Ej.shape[0], pairs_a.shape[0]
    m, pa, pb = m_c.numpy(), pairs_a.numpy(), pairs_b.numpy()
    pv = pairs_valid.numpy().astype(bool)
    S = torch.full((K + 2 * E + NP, 6, 6), float("nan"))
    rc = torch.full((K + E, 6), float("nan"))
    Q = 1.0 / (C + eta)
    QW = Q * w_m
    s_all = np.arange(NP)
    ma = np.where(pv, m[pa], -1)
    mb = np.where(pv, m[pb], -1)
    for q in range(K):
        grp = np.flatnonzero(m == q)
        rank = np.full(E, -1)
        rank[grp] = np.arange(len(grp))
        S[K + 2 * E + s_all[~pv & (s_all % K == q)]] = 0.0
        S[K + 2 * E + s_all[pv & (ma == q) & (mb != q)]] = 0.0
        mine = s_all[pv & (ma == q) & (mb == q)]
        paired = np.zeros(len(grp), bool)
        paired[rank[pa[mine]]] = True
        paired[rank[pb[mine]]] = True
        blocks = [Ei_m[q]] + [Ej[e] for e in grp]
        nb = len(blocks)
        units = {}
        for ta in range(0, nb, tb):
            for t_b in range(ta, nb, tb):
                for A in range(ta, min(ta + tb, nb)):
                    for B in range(max(A, t_b), min(t_b + tb, nb)):
                        if A and not (paired[A - 1] and paired[B - 1]):
                            continue
                        units[A, B] = torch.einsum(
                            "dh,h,ch->dc", blocks[A], Q[q], blocks[B])
                        if A:
                            continue
                        r = torch.einsum("ch,h->c", blocks[B], QW[q])
                        if B == 0:
                            S[q], rc[q] = units[A, B], r
                        else:
                            e = grp[B - 1]
                            S[K + e], rc[K + e] = units[A, B], r
                            S[K + E + e] = units[A, B].T
        for s in mine:
            A, B = rank[pa[s]] + 1, rank[pb[s]] + 1
            u = units[min(A, B), max(A, B)]
            S[K + 2 * E + s] = u if A <= B else u.T
    return S, rc


def schur_cases():
    """(name, schur args): the test scenes' depth terms (random Ej, the
    last 3 edges invalid with zero Ej, their slots padded), the planner's,
    the backend's and crowded's stages (the last two at 4x6: their
    groups, not their pixels)."""
    for hw in SCENES:
        d = {k: torch.from_numpy(v) for k, v in depth_terms(*hw).items()}
        K = d["Ei_m"].shape[0]
        yield (f"scene{hw}", (d["Ei_m"], d["Ej"], d["C"], d["eta"], d["w_m"],
                              d["m"].clamp(0, K - 1), d["pa"], d["pb"],
                              d["pv"]))
    yield "planner", dba_probe.stages(
        dba_probe.shape_inputs("planner", "cpu"))["schur"]
    for name in ("backend", "crowded"):
        yield name, dba_probe.stages(
            dba_probe.shape_inputs(name, "cpu", hw=(4, 6)))["schur"]


CASES = dict(schur_cases())


@functools.lru_cache(maxsize=None)
def walked(name, tb=SC_TB):
    return gram_emulation(*CASES[name], tb=tb)


@pytest.mark.parametrize("tb", [SC_TB, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_gram_walk_matches_the_plain_schur_terms(name, tb):
    args = CASES[name]
    rows, rc = walked(name, tb)
    assert not torch.isnan(rows).any() and not torch.isnan(rc).any()
    want_rows, want_rc = cuda_dba.schur_plain(*args)
    within(rows, want_rows)
    within(rc, want_rc)
    pv = args[-1]
    K, E = args[0].shape[0], args[1].shape[0]
    assert not rows[K + 2 * E:][~pv].any()


def test_crowded_groups_span_several_tiles():
    m = CASES["crowded"][5].numpy()
    sizes = np.bincount(m, minlength=32)
    assert 20 <= sizes.mean() <= 40 and (sizes + 1 > SC_TB).all()
    assert ((sizes + 1 + SC_TB - 1) // SC_TB).max() >= 2


def test_gram_walk_zeroes_slots_across_frames_and_keeps_unpaired_edges():
    """A valid slot whose edges' frames differ gets zeros; an edge that no
    slot pairs (here a valid one) still gets its self x edge block."""
    d = {k: torch.from_numpy(v) for k, v in depth_terms(6, 10).items()}
    K = d["Ei_m"].shape[0]
    m = d["m"].clamp(0, K - 1)
    pa, pb, pv = d["pa"].clone(), d["pb"].clone(), d["pv"].clone()
    n = int(pv.sum())
    other = int(torch.nonzero(m != m[pa[0]])[0, 0])
    pb[0] = other                    # a slot across frames
    lone = int(pa[n - 1])
    pv[(pa == lone) | (pb == lone)] = False   # an edge no slot pairs
    args = (d["Ei_m"], d["Ej"], d["C"], d["eta"], d["w_m"], m, pa, pb, pv)
    rows, rc = gram_emulation(*args)
    E = d["Ej"].shape[0]
    assert not rows[K + 2 * E].any()
    want_rows, want_rc = cuda_dba.schur_plain(*args)
    keep = torch.ones(rows.shape[0], dtype=torch.bool)
    keep[K + 2 * E] = False
    within(rows[keep], want_rows[keep])
    within(rc, want_rc)
    within(rows[K + lone], want_rows[K + lone])


@pytest.mark.parametrize("name", list(CASES))
def test_gram_walk_matches_the_jax_contractions(name):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    Ei_m, Ej, C, eta, w_m, m_c, pa, pb, pv = (t.numpy() for t in CASES[name])
    K = Ei_m.shape[0]
    # pvo_tpu/vo/dba.py: Q, the (a)+(b) einsum, the pair einsum, the rhs
    Q = 1.0 / (jnp.asarray(C) + jnp.asarray(eta))
    SS = jnp.einsum("xdh,xh,xeh->xde",
                    jnp.concatenate([Ei_m, Ei_m[m_c]]),
                    jnp.concatenate([Q, Q[m_c]]),
                    jnp.concatenate([Ei_m, Ej]))
    SSc = jnp.einsum("pdh,ph,peh->pde", Ej[pa], Q[m_c][pa], Ej[pb])
    rows = jnp.concatenate([SS[:K], SS[K:], jnp.swapaxes(SS[K:], -1, -2),
                            SSc * pv[:, None, None]])
    rc = jnp.einsum("xdh,xh,xh->xd", jnp.concatenate([Ei_m, Ej]),
                    jnp.concatenate([Q, Q[m_c]]),
                    jnp.concatenate([w_m, w_m[m_c]]))
    got_rows, got_rc = walked(name)
    within(got_rows, torch.from_numpy(np.asarray(rows)))
    within(got_rc, torch.from_numpy(np.asarray(rc)))


@pytest.mark.parametrize("name", list(CASES))
def test_library_yardstick_rows_are_the_schur_rows(name):
    args = CASES[name]
    MQ, M, groups = dba_probe.gram_operands(*args[:6])
    G = torch.bmm(MQ, M.transpose(1, 2))
    rows, rc = dba_probe.gram_rows(G, groups, *args[5:])
    want_rows, want_rc = cuda_dba.schur_plain(*args)
    within(rows, want_rows)
    within(rc, want_rc)


def test_backend_shape_is_the_recorded_backend_call():
    """The ``backend`` shape runs the recorded call: the windows that
    ``FactorGraph.update_lowmem``/``_update`` derive from its edges, the
    edges that ``add_proximity_factors`` makes (both directions of each
    pair, every neighbour within the backend radius), all valid, and
    every pair slot of ``build_edge_pairs`` unpadded."""
    K = check_recorded_call("backend", dba_probe.backend_call())
    assert K > 64


def test_backend40_shape_is_the_recorded_call_at_40_keyframes():
    """The same of ``backend40``, the backend's call at the 40 keyframes
    that ``chip_smoke.py``'s main path tracks: P = 39, on the solve
    kernel's route."""
    call = dba_probe.backend_call(40)
    check_recorded_call("backend40", call)
    assert call["P"] == 39 <= cuda_dba.SOLVE_MAX_P


def test_backend40_wide_shape_is_the_recorded_wide_call():
    """The same of ``backend40_wide``, the backend's call at the 40
    keyframes of a 376x1248 stream that ``chip_smoke.py``'s wide
    terminate tracks: 47x156 features (7332 pixels an edge), P on the
    solve kernel's route."""
    call = dba_probe.backend_call(40, dba_probe.WIDE)
    check_recorded_call("backend40_wide", call)
    assert call["hw"] == [47, 156] and call["P"] <= cuda_dba.SOLVE_MAX_P


def check_recorded_call(name, call):
    """The checks of the recorded-call tests on shape ``name``; returns
    its K."""
    from pvo_tpu_torch.utils.config import VOConfig
    ii, jj = np.asarray(call["ii"]), np.asarray(call["jj"])
    E, K, h, w, n_pairs, motion_only = dba_probe.SHAPES[name]
    assert (E, K, [h, w], n_pairs, motion_only) == (
        len(ii), call["K"], call["hw"], None, False)
    assert call["w0"] == ii.min() and K == ii.max() - ii.min() + 1
    assert call["t0"] == max(1, ii.min() + 1) and call["P"] == \
        call["t1"] - call["t0"]
    assert len(ii) == max(call["backend_edges"])
    # each pair in both directions (a pair both a neighbour and a
    # proximity candidate comes twice, as add_proximity_factors adds it)
    edges = Counter(zip(ii.tolist(), jj.tolist()))
    assert sum(edges.values()) == E and \
        edges == Counter(zip(jj.tolist(), ii.tolist()))
    rad = VOConfig().backend_radius
    assert all((i, j) in edges for i in range(call["t1"])
               for j in range(i + 1, min(i + rad + 1, call["t1"])))
    a = dba_probe.shape_inputs(name, "cpu", hw=(4, 6))
    assert torch.equal(a["ii"], torch.from_numpy(ii)) and \
        torch.equal(a["jj"], torch.from_numpy(jj))
    assert bool(a["valid"].all())
    assert (a["P"], a["K"], int(a["t0"]), int(a["t1"]), int(a["w0"])) == \
        (call["P"], K, call["t0"], call["t1"], call["w0"])
    pa, pb, pv = tdba.build_edge_pairs(ii, np.ones(E, bool))
    assert torch.equal(a["pairs_a"], torch.from_numpy(pa)) and \
        torch.equal(a["pairs_b"], torch.from_numpy(pb)) and bool(pv.all())
    return K
